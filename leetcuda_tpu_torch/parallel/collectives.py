"""The collective demo suite, over the ranks of a 1-D mesh.

Counterpart of ``leetcuda_tpu/parallel/collectives.py``: one demo per
reference NCCL script, each taking the global array and a mesh with one
axis "x" (default: the visible CUDA devices, ``_mesh1d``), sharding it as
JAX's ``shard_map`` in_specs do, running the collective over the ranks'
values (``parallel/mesh.py``: plain torch, as JAX leaves these to XLA) and
joining the ranks' results as the out_specs do. A mesh over ``["cpu"] * 8``
runs the suite on the CPU; over ``["cuda"] * 8``, 8 ranks on one GPU.
"""

from __future__ import annotations

import torch

from leetcuda_tpu_torch.parallel.mesh import (Mesh, all_gather, all_to_all,
                                              pmax, ppermute, psum, shard,
                                              unshard, visible_devices)

_SHARDED, _WHOLE = ("x",), (None,)


def _mesh1d(devices=None) -> Mesh:
    devices = visible_devices() if devices is None else list(devices)
    return Mesh(devices, ("x",))


def _smap(mesh, fn, x, in_spec, out_spec):
    """shard_map: ``fn`` (the ranks' values -> the ranks' results) between
    ``shard`` by ``in_spec`` and ``unshard`` by ``out_spec``."""
    return unshard(fn(shard(x, mesh, in_spec)), mesh, out_spec)


# --- one demo per reference script -------------------------------------------

def demo_broadcast(x, mesh=None):
    """test_broadcast.py analog: rank 0's shard replaces everyone's."""
    mesh = mesh or _mesh1d()
    return _smap(mesh, lambda xs: [xs[0].to(v.device) for v in xs], x,
                 _SHARDED, _SHARDED)


def demo_all_reduce(x, mesh=None):
    """test_all_reduce.py analog: psum over the axis."""
    mesh = mesh or _mesh1d()
    return _smap(mesh, psum, x, _SHARDED, _SHARDED)


def demo_reduce_max(x, mesh=None):
    """test_reduce.py analog (MAX): pmax, result on every rank."""
    mesh = mesh or _mesh1d()
    return _smap(mesh, pmax, x, _SHARDED, _SHARDED)


def demo_all_gather(x, mesh=None):
    """test_all_gather.py / all_gather_into_tensor analog."""
    mesh = mesh or _mesh1d()
    return _smap(mesh, all_gather, x, _SHARDED, _WHOLE)


def demo_reduce_scatter(x, mesh=None):
    """test_reduce_scatter.py analog: psum_scatter (tiled): rank r holds
    chunk r of the sum of the ranks' whole arrays."""
    mesh = mesh or _mesh1d()

    def f(xs):
        n = len(xs)
        return [torch.chunk(total, n)[r] for r, total in enumerate(psum(xs))]

    return _smap(mesh, f, x, _WHOLE, _SHARDED)


def demo_scatter(x, mesh=None):
    """test_scatter.py analog: rank 0's full tensor distributed in chunks
    (scatter is a resharding from whole to split)."""
    mesh = mesh or _mesh1d()
    return _smap(mesh, lambda xs: [torch.chunk(v, len(xs))[r]
                                   for r, v in enumerate(xs)], x,
                 _WHOLE, _SHARDED)


def demo_gather(x, mesh=None):
    """test_gather.py analog: all ranks' chunks to one place (rank 0 reads
    it); no rooted gather, as in JAX: all_gather."""
    return demo_all_gather(x, mesh)


def demo_all_to_all(x, mesh=None):
    """test_all_to_all_single.py analog."""
    mesh = mesh or _mesh1d()
    return _smap(mesh, lambda xs: all_to_all(xs, 0, 0), x, _SHARDED,
                 _SHARDED)


def demo_p2p(x, mesh=None):
    """test_p2p.py analog: send to the right neighbour (ppermute)."""
    mesh = mesh or _mesh1d()
    return _smap(mesh, ppermute, x, _SHARDED, _SHARDED)


def demo_all_gather_with_log(x, mesh=None, verbose=True):
    """Per-rank logged variant mirroring the reference's README log tables."""
    mesh = mesh or _mesh1d()
    out = demo_all_gather(x, mesh)
    if verbose:
        n = mesh.size
        chunk = x.shape[0] // n
        for r in range(n):
            head = x[r * chunk:(r + 1) * chunk].flatten()[:4].tolist()
            print(f"[rank {r}] had {head} -> has full {tuple(out.shape)}")
    return out


ALL_DEMOS = {
    "broadcast": demo_broadcast,
    "all_reduce": demo_all_reduce,
    "reduce_max": demo_reduce_max,
    "all_gather": demo_all_gather,
    "gather": demo_gather,
    "scatter": demo_scatter,
    "reduce_scatter": demo_reduce_scatter,
    "all_to_all": demo_all_to_all,
    "p2p": demo_p2p,
}


def run_all(devices=None, verbose: bool = True):
    """test_dist_all.py analog: every collective in sequence over a 1-D mesh
    of ``devices`` (default: the visible CUDA devices), per-rank logged.
    Returns {demo: its result on the first rank's device}."""
    mesh = _mesh1d(devices)
    x = torch.arange(mesh.size * 8, dtype=torch.float32,
                     device=mesh.ranks()[0])
    results = {}
    for name, demo in ALL_DEMOS.items():
        out = demo(x, mesh)
        results[name] = out
        if verbose:
            print(f"{name:>16}: in shape {tuple(x.shape)} -> out shape "
                  f"{tuple(out.shape)}, head {out.flatten()[:4].tolist()}")
    return results
