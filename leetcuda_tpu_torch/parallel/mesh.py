"""Mesh and sharding layer of the port: named axes over ranks, and the
collectives that the JAX package leaves to XLA, as plain torch over the
ranks' values.

Counterpart of ``leetcuda_tpu/parallel/mesh.py`` (``MeshConfig``,
``make_mesh``, ``tp_shard_rules``, ``shard``). The port keeps JAX's
single-controller model: one process drives every rank of a mesh, as
``shard_map`` does. A rank is an entry of the mesh's device array, and a
device may repeat: a mesh over ``["cuda"] * 8`` is 8 ranks on one GPU, as
JAX's test mesh is 8 virtual devices on one CPU (NCCL refuses two ranks on
one GPU). A rank's value is a tensor on its device; a sharded array is the
list of its ranks' pieces in mesh order (row-major over the mesh's axes).

A sharding spec is a tuple with one entry a tensor dim: an axis name, or
None for a dim that every rank holds whole (JAX's ``PartitionSpec`` with
single names). Dims past the spec's length are whole.

The collectives JAX's ``shard_map`` code calls (``psum``, ``pmax``,
``all_gather``, ``all_to_all``, ``ppermute``) take and return the list of
the ranks' values, each result on its rank's device. The ring kernels
(rows 36-37 of the port's table) are ``parallel/ring_p2p.py``.

The TP runtime (``param_shardings``, ``shard_llama_params``,
``shard_kv_caches``) waits for ROADMAP item 12b.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1   # data parallel (gradients all-reduced)
    tp: int = 1   # tensor parallel (weights column/row sharded)
    sp: int = 1   # sequence/context parallel (ring attention axis)

    @property
    def size(self):
        return self.dp * self.tp * self.sp


class Mesh:
    """An ndarray of ``torch.device`` under named axes: ``devices`` (any
    nested sequence or array of devices or device strings, one array dim an
    axis), ``axis_names``, ``shape`` {axis: size} and ``size``."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"a device array of shape {arr.shape} for axes "
                             f"{self.axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = torch.device(arr[idx])
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def ranks(self) -> list:
        """Every rank's device, in mesh order."""
        return list(self.devices.flat)

    def axis_devices(self, axis: str, **at) -> list:
        """The devices along ``axis``, the other axes at the indices ``at``
        gives (0 where it gives none): the ranks one collective over
        ``axis`` joins."""
        idx = tuple(slice(None) if name == axis else at.get(name, 0)
                    for name in self.axis_names)
        return list(self.devices[idx])


def visible_devices() -> list:
    """The visible CUDA devices; raises where there is none: the entry
    points run on the card unless the caller passes CPU devices."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass devices (e.g. "
                           "['cpu'] * 8) to run the plain PyTorch path")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(config: MeshConfig | None = None, devices=None) -> Mesh:
    """Build a (dp, sp, tp) mesh. Defaults to the visible CUDA devices, all
    on the tp axis."""
    devices = visible_devices() if devices is None else list(devices)
    n = len(devices)
    if config is None:
        config = MeshConfig(tp=n)
    if config.size != n:
        raise ValueError(f"mesh {config} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(config.dp, config.sp, config.tp),
                ("dp", "sp", "tp"))


def tp_shard_rules():
    """Specs for a Llama-style layer under tensor parallelism (JAX's table,
    specs as tuples of axis names): column-parallel in-projections,
    row-parallel out-projections."""
    return {
        "embedding": ("tp", None),           # vocab-sharded embedding
        "attn_qkv": (None, "tp"),            # column parallel
        "attn_o": ("tp", None),              # row parallel
        "mlp_in": (None, "tp"),              # gate/up column parallel
        "mlp_out": ("tp", None),             # down row parallel
        "norm": (None,),                     # replicated
        "lm_head": (None, "tp"),             # vocab-sharded logits
        # activations
        "tokens": ("dp", "sp"),              # (batch, seq)
        "acts": ("dp", "sp", None),          # (batch, seq, model)
        "kv_cache": ("dp", "tp", None, None),  # (batch, heads, seq, head_dim)
    }


def _spec(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    named = [s for s in spec if s is not None]
    if len(spec) > ndim or len(set(named)) != len(named):
        raise ValueError(f"spec {spec} for a tensor of {ndim} dims")
    return spec


def split(x, devices, dim: int) -> list:
    """``x`` cut into len(devices) equal pieces along ``dim``, piece i
    contiguous on devices[i]."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    return [p.to(d).contiguous()
            for p, d in zip(torch.chunk(x, n, dim), devices)]


def shard(x, mesh: Mesh, spec) -> list:
    """Every rank's piece of ``x`` under ``spec``, in mesh order, each
    contiguous on its rank's device."""
    spec = _spec(spec, x.dim())
    pieces = []
    for idx in np.ndindex(mesh.devices.shape):
        at = dict(zip(mesh.axis_names, idx))
        p = x
        for dim, name in enumerate(spec):
            if name is not None:
                n = mesh.shape[name]
                if p.shape[dim] % n:
                    raise ValueError(f"dim {dim} of {tuple(x.shape)} does "
                                     f"not split over {name}={n}")
                c = p.shape[dim] // n
                p = p.narrow(dim, at[name] * c, c)
        pieces.append(p.to(mesh.devices[idx]).contiguous())
    return pieces


def unshard(pieces, mesh: Mesh, spec):
    """The inverse of ``shard``: the array whose pieces, in mesh order, are
    ``pieces``, on the first rank's device. Ranks that hold the same piece
    (an axis the spec does not name) are read at index 0 of that axis."""
    if len(pieces) != mesh.size:
        raise ValueError(f"{len(pieces)} pieces for a mesh of {mesh.size}")
    spec = _spec(spec, pieces[0].dim())
    named = [s for s in spec if s is not None]
    if not named:
        return pieces[0]
    grid = np.empty(mesh.devices.shape, dtype=object)
    for i, idx in enumerate(np.ndindex(grid.shape)):
        grid[idx] = pieces[i]
    grid = grid[tuple(slice(None) if a in named else 0
                      for a in mesh.axis_names)]
    kept = [a for a in mesh.axis_names if a in named]
    grid = grid.transpose([kept.index(a) for a in named])  # in dim order
    dev = pieces[0].device
    for dim in reversed([d for d, s in enumerate(spec) if s is not None]):
        joined = np.empty(grid.shape[:-1], dtype=object)
        for idx in np.ndindex(joined.shape):
            joined[idx] = torch.cat([t.to(dev) for t in grid[idx]], dim)
        grid = joined
    return grid[()]


# --- the collectives JAX leaves to XLA, over the ranks' values --------------

def psum(xs) -> list:
    """Every rank holds the sum of the ranks' values."""
    total = functools.reduce(torch.add, [x.to(xs[0].device) for x in xs])
    return [total.to(x.device) for x in xs]


def pmax(xs) -> list:
    """Every rank holds the elementwise maximum of the ranks' values."""
    top = functools.reduce(torch.maximum, [x.to(xs[0].device) for x in xs])
    return [top.to(x.device) for x in xs]


def all_gather(xs, dim: int = 0) -> list:
    """Every rank holds the ranks' values joined along ``dim`` (JAX's
    ``all_gather(tiled=True)``)."""
    return [torch.cat([y.to(x.device) for y in xs], dim) for x in xs]


def all_to_all(xs, split_dim: int, concat_dim: int) -> list:
    """Rank r holds piece r of every rank's value split along
    ``split_dim``, joined in rank order along ``concat_dim`` (JAX's
    ``all_to_all(tiled=True)``)."""
    n = len(xs)
    parts = [torch.chunk(x, n, split_dim) for x in xs]
    if any(len(p) != n or p[0].shape != p[-1].shape for p in parts):
        raise ValueError(f"dim {split_dim} of {tuple(xs[0].shape)} does not "
                         f"split over {n} ranks")
    return [torch.cat([parts[j][r].to(x.device) for j in range(n)],
                      concat_dim) for r, x in enumerate(xs)]


def ppermute(xs, shift: int = 1) -> list:
    """Rank (r + shift) mod n holds rank r's value: the ring hop of JAX's
    ``ppermute`` with perm [(i, (i + shift) % n)]."""
    n = len(xs)
    return [xs[(r - shift) % n].to(xs[r].device) for r in range(n)]
