"""Pipeline parallelism (the "pp" mesh axis): the GPipe schedule over the
ranks of a mesh axis.

Counterpart of ``leetcuda_tpu/parallel/pipeline.py``. Stage weights stack
with a leading stage dim (``stack_stage_params``, ``split_llama_stages``);
``shard_stage_params`` gives each stage's rank its slice, on its device.
``pipeline_apply`` runs JAX's schedule: M + P - 1 ticks, at tick t stage s
runs microbatch t - s, and the stages' outputs move one hop along the ring
(``parallel/mesh.py`` ``ppermute``'s hop, plain torch as JAX's is XLA's).
JAX's bubbles compute garbage that is never collected; here they compute
nothing. ``batch_axis`` splits each microbatch's batch (dim 1) over a
second axis, the pp x dp hybrid: each of its ranks runs the pipeline on
its part, the stage weights held by every one of them.

Parameter trees are the port's: nested dicts, lists and tuples of tensors.
``make_pp_train_step`` waits for ROADMAP item 12b.
"""

from __future__ import annotations

import torch

from leetcuda_tpu_torch.parallel.mesh import Mesh


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def stack_stage_params(per_stage_params):
    """[stage0_tree, stage1_tree, ...] -> one tree with leading stage dim."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def shard_stage_params(stacked, mesh: Mesh, axis: str = "pp") -> list:
    """The stacked tree split on its stage dim over ``axis``: stage s's
    tree on the device of the axis's rank s."""
    return [tree_map(lambda x, s=s: x[s].to(dev), stacked)
            for s, dev in enumerate(mesh.axis_devices(axis))]


def pipeline_apply(stage_fn, stacked_params, microbatches, mesh: Mesh,
                   axis: str = "pp", batch_axis: str | None = None):
    """Run a P-stage pipeline over M microbatches.

    stage_fn(stage_params, x) -> y with y.shape == x.shape;
    stacked_params: a list of P stage trees, each moved to its rank's
    device (``shard_stage_params``'s, or a stage's layers as a list); a
    tree with a leading stage dim is split first; microbatches: (M, ...).
    Returns (M, ...) = stage_{P-1}(... stage_0(mb) ...) per microbatch, on
    the last stage's device. ``batch_axis``: a mesh axis over which each
    microbatch's dim 1 splits (stage_fn must be batch-elementwise)."""
    stages = (stacked_params if isinstance(stacked_params, list)
              else shard_stage_params(stacked_params, mesh, axis))
    M, P = microbatches.shape[0], mesh.shape[axis]
    if len(stages) != P:
        raise ValueError(f"{len(stages)} stages for {axis}={P}")
    n_dp = mesh.shape[batch_axis] if batch_axis else 1
    if microbatches.shape[1] % n_dp:
        raise ValueError(f"microbatch batch {microbatches.shape[1]} does not "
                         f"split over {batch_axis}={n_dp}")
    parts = []
    for d, mbs in enumerate(torch.chunk(microbatches, n_dp, dim=1)):
        devs = mesh.axis_devices(axis, **({batch_axis: d} if batch_axis
                                          else {}))
        params = [tree_map(lambda x, dev=dev: x.to(dev), p)
                  for p, dev in zip(stages, devs)]
        state, outputs = [None] * P, []
        for t in range(M + P - 1):
            outs = [None] * P
            for s in range(P):
                if 0 <= t - s < M:  # stage s holds microbatch t - s
                    inp = mbs[t - s].to(devs[0]) if s == 0 else state[s]
                    outs[s] = stage_fn(params[s], inp)
            if outs[-1] is not None:
                outputs.append(outs[-1])
            # one hop along the ring (the last stage's output is collected)
            state = [None] + [o if o is None else o.to(devs[s + 1])
                              for s, o in enumerate(outs[:-1])]
        parts.append(torch.stack(outputs))
    return torch.cat([p.to(parts[0].device) for p in parts], dim=1)


# --- full-model pipeline (llama stack over pp) ------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def split_llama_stages(params, n_stages: int):
    """Split a llama param tree for the pipeline.

    Returns ``(outer, staged)``: ``outer`` = {embed, norm, lm_head?} (run
    outside the pipeline), ``staged`` = the L layer trees stacked to
    leading dims (P, L/P, ...) for ``shard_stage_params``. Layers must be
    structurally homogeneous (stage boundaries land between layers)."""
    layers = params["layers"]
    L = len(layers)
    if L % n_stages:
        raise ValueError(f"n_layers={L} must divide into {n_stages} stages")
    stacked = tree_map(lambda *xs: torch.stack(xs), *layers)
    staged = tree_map(
        lambda x: x.reshape((n_stages, L // n_stages) + x.shape[1:]),
        stacked)
    outer = {k: v for k, v in params.items() if k != "layers"}
    return outer, staged


def merge_llama_stages(outer, staged):
    """Inverse of split_llama_stages: back to the flat llama tree."""
    flat = tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), staged)
    L = next(_leaves(flat)).shape[0]
    layers = [tree_map(lambda x, i=i: x[i], flat) for i in range(L)]
    return {**outer, "layers": layers}

