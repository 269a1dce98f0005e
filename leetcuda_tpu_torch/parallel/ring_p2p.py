"""Kernel-level ring collectives over the ranks of a mesh axis: the right
permute and the double-buffered ring all-gather.

Counterpart of ``leetcuda_tpu/parallel/ring_pallas.py`` (``ppermute_pallas``,
``ring_all_gather_pallas``), in JAX's calling form:
``ppermute_p2p(x, mesh, axis)`` and ``ring_all_gather_p2p(x, mesh, axis)``
take the global array sharded on dim 0 over ``axis`` and return what the
Pallas versions return (the shards rotated one rank right; the whole array,
as every rank holds it). The shard-level forms take and return the list of
the ranks' values: ``ring_all_gather_p2p_shards`` returns every rank's own
copy, so that a check can read all of them.

On CUDA tensors the wrappers launch ``csrc/ring_p2p.cu`` (``lc_ppermute``;
``lc_ring_all_gather``, a cooperative launch whose waits are bounded: a
wait that runs out sets an error word, and the wrapper raises
``KernelLaunchError``). The kernels copy bytes, so any dtype goes through
bit for bit. This slice launches over ranks that share one device; a mesh
axis over distinct devices raises (peer access, system-scope flags and one
launch a device wait for ROADMAP item 12). On CPU tensors the wrappers run
the plain versions: a list rotation, and ``torch.cat`` a rank.
"""

from __future__ import annotations

import ctypes

import torch

from leetcuda_tpu_torch.core.runtime import (KernelLaunchError, LaunchCounter,
                                             check_launch, round_up)
from leetcuda_tpu_torch.parallel.mesh import Mesh, split

PPERMUTE = LaunchCounter("ppermute_p2p")
RING_ALL_GATHER = LaunchCounter("ring_all_gather_p2p")
MAX_RANKS = 64  # csrc/ring_p2p.cu kMaxRanks
THREADS = 256  # csrc/ring_p2p.cu kThreads
SPIN_BUDGET = 1 << 22  # polls a ring wait may take (~2-4 s) before it fails
# lc_ppermute(in, out, n, bytes, stream)
_PPERMUTE_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_void_p)
# lc_ring_all_gather(in, out, comm, flags, err, n, chunk, pitch, ctas,
#                    budget, stream)
_RING_ARGS = ((ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_longlong,
                                        ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_void_p))


def ppermute_plain(shards) -> list:
    """Rank (r + 1) mod n holds rank r's shard: a list rotation."""
    n = len(shards)
    return [shards[(r - 1) % n].to(shards[r].device) for r in range(n)]


def ring_all_gather_plain(shards) -> list:
    """Every rank holds the shards joined along dim 0: ``torch.cat`` a
    rank."""
    return [torch.cat([s.to(x.device) for s in shards]) for x in shards]


def _one_device(devices, what: str):
    """The one device ``devices`` share; raises where they differ."""
    distinct = {str(torch.device(d)) for d in devices}
    if len(distinct) > 1:
        raise NotImplementedError(
            f"{what}: the ranks lie on distinct devices {sorted(distinct)}; "
            "the kernel launches over ranks that share one device (peer "
            "access, system-scope flags and one launch a device wait for "
            "ROADMAP item 12)")
    return torch.device(next(iter(devices)))


def _check_shards(shards, what: str):
    if not 1 <= len(shards) <= MAX_RANKS:
        raise ValueError(f"{what}: 1 to {MAX_RANKS} ranks, got {len(shards)}")
    s0 = shards[0]
    if s0.dim() < 1 or any(s.shape != s0.shape or s.dtype != s0.dtype
                           for s in shards):
        raise ValueError(f"{what}: the ranks' shards must share one shape "
                         f"(at least one dim) and dtype")
    return _one_device([s.device for s in shards], what)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _ppermute_into(shards, out):
    """Launch lc_ppermute: ``out[(r + 1) % n]`` gets ``shards[r]`` (all
    contiguous, on one device)."""
    from leetcuda_tpu_torch.build import kernel

    nbytes = shards[0].numel() * shards[0].element_size()
    fn = kernel("ring_p2p", "lc_ppermute", _PPERMUTE_ARGS)
    err = fn(_ptrs(shards), _ptrs(out), len(shards), nbytes,
             torch.cuda.current_stream(shards[0].device).cuda_stream)
    check_launch(err, PPERMUTE.name)
    PPERMUTE.add()
    return out


def resident_ctas(dev) -> int:
    """CTAs of ``THREADS`` threads the device can hold at once, by its
    thread limit (the kernel's occupancy is at most this)."""
    props = torch.cuda.get_device_properties(dev)
    return (props.multi_processor_count
            * (props.max_threads_per_multi_processor // THREADS))


def ring_workspace(shards):
    """The all-gather's buffers for ``shards``: every rank's output, the
    comm slots (n, 2, chunk rounded up to 16 bytes) and the flags (two a
    resident CTA, zero, then the error word)."""
    dev, n = shards[0].device, len(shards)
    chunk = shards[0].numel() * shards[0].element_size()
    out = [torch.empty((n * shards[0].shape[0],) + shards[0].shape[1:],
                       dtype=shards[0].dtype, device=dev) for _ in shards]
    comm = torch.empty(n * 2 * round_up(chunk, 16), dtype=torch.uint8,
                       device=dev)
    flags = torch.zeros(2 * resident_ctas(dev) + 1, dtype=torch.int32,
                        device=dev)
    return out, comm, flags


def _ring_all_gather_into(shards, out, comm, flags, *, ctas: int = 0,
                          budget: int = SPIN_BUDGET):
    """Launch lc_ring_all_gather into ``ring_workspace``'s buffers, whose
    flags (all but the last int) must be zero. Returns the error word
    (``flags[-1:]``), unread: it is sticky, so that a caller may launch
    several times and read it once (``check_ring_error``). ``ctas`` (CTAs
    a rank; 0: the kernel's choice) and ``budget`` (polls a wait may take;
    0 fails the first wait not already met) are checks' hooks."""
    from leetcuda_tpu_torch.build import kernel

    dev, n = shards[0].device, len(shards)
    chunk = shards[0].numel() * shards[0].element_size()
    err = flags[-1:]
    with torch.cuda.device(dev):
        fn = kernel("ring_p2p", "lc_ring_all_gather", _RING_ARGS)
        check_launch(fn(_ptrs(shards), _ptrs(out), comm.data_ptr(),
                        flags.data_ptr(), err.data_ptr(), n, chunk,
                        comm.numel() // (2 * n), ctas, budget,
                        torch.cuda.current_stream(dev).cuda_stream),
                     RING_ALL_GATHER.name)
    RING_ALL_GATHER.add()
    return err


def check_ring_error(err):
    """Raise if the all-gather's error word is set (a wait ran out)."""
    if int(err.item()):
        raise KernelLaunchError(f"{RING_ALL_GATHER.name}: a ring wait ran "
                                "out of its budget (protocol fault)")


def ppermute_p2p_shards(shards) -> list:
    """Rank (r + 1) mod n's result is rank r's shard, on each rank."""
    dev = _check_shards(shards, PPERMUTE.name)
    if dev.type == "cpu":
        return ppermute_plain(shards)
    shards = [s.contiguous() for s in shards]
    return _ppermute_into(shards, [torch.empty_like(s) for s in shards])


def ring_all_gather_p2p_shards(shards) -> list:
    """Every rank's own copy of the shards joined along dim 0."""
    dev = _check_shards(shards, RING_ALL_GATHER.name)
    if dev.type == "cpu":
        return ring_all_gather_plain(shards)
    shards = [s.contiguous() for s in shards]
    out, comm, flags = ring_workspace(shards)
    check_ring_error(_ring_all_gather_into(shards, out, comm, flags))
    return out


def ppermute_p2p(x, mesh: Mesh, axis: str = "x"):
    """Right-rotate the shards of ``x`` (dim 0 over ``axis``) one rank."""
    devs = mesh.axis_devices(axis)
    _one_device(devs, PPERMUTE.name)
    return torch.cat(ppermute_p2p_shards(split(x, devs, 0)))


def ring_all_gather_p2p(x, mesh: Mesh, axis: str = "x"):
    """All-gather the shards of ``x`` (dim 0 over ``axis``) by the ring:
    n - 1 hops, each chunk one rank a step. Returns the whole array (the
    first rank's copy; every rank holds the same)."""
    devs = mesh.axis_devices(axis)
    _one_device(devs, RING_ALL_GATHER.name)
    return ring_all_gather_p2p_shards(split(x, devs, 0))[0]
