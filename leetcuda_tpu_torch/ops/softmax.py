"""Row softmax of (S, K) in f32, the output in x's dtype, in three forms:

1. ``make_softmax`` (naive): exp(x) / sum exp(x) with no max subtracted. It
   overflows where x > 88 (inf / inf = NaN) by design, as the JAX kernel does.
2. ``make_safe_softmax``: the row max subtracted first.
3. ``make_online_softmax``: one pass of running (max, denominator) pairs
   merged by m' = max(m, m_b), d' = d e^(m - m') + d_b e^(m_b - m'), then a
   write pass.

Counterpart of ``leetcuda_tpu/ops/softmax.py`` (factories, registrations,
``softmax``, ``online_softmax``). On CUDA tensors every form launches one
of two routes of ``csrc/row_ops.cu`` with its mode, picked by
``softmax_plan`` from the shape, and returns a new tensor:

- ``cluster`` (``lc_softmax``, counted on ``softmax``): a row is read once
  into the registers of a cluster of C CTAs (1-16; C grows until a CTA's
  slice fits 32 KB, then while the rows' CTAs fall short of the card's SMs
  and each CTA keeps 4 KB), each CTA reduces its slice to (max, sum of
  exp), the CTAs push their pairs to each other through distributed shared
  memory and merge them in rank order, and each writes its slice from its
  registers; a persistent grid of clusters walks the rows, each CTA loading
  its next slice while it reduces and writes the current one; exp(x - m)
  on the SFU (ex2.approx, a few ulp, within every registered tolerance);
- ``stream`` (``lc_softmax_stream``, counted on ``softmax_stream``): the
  earlier kernel, one CTA a row walking it two or three times, for rows
  longer than 16 CTAs hold (above 128K f32 or 256K f16 / bf16 elements).

On CPU tensors every form runs its plain version. A rung's ``vec`` and
``pack`` set the width of the cluster route's loads (``rowwise.load_bytes``),
as the reference's ladder varies them; the stream route walks in ``vec``
steps. ``rows_per_step`` and the online form's ``chunk`` (the TPU kernel's
column chunk) are the TPU's tiling and are accepted and ignored.
"""

from __future__ import annotations

import ctypes

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import (SM_COUNT, LaunchCounter,
                                             cdiv, check_launch)
from leetcuda_tpu_torch.ops import rowwise as rw

SOFTMAX = LaunchCounter("softmax")  # the cluster route
SOFTMAX_STREAM = LaunchCounter("softmax_stream")  # the stream route
NAIVE, SAFE, ONLINE = 0, 1, 2
# The cluster route (csrc/row_ops.cu kSmThreads, kSmMaxCluster and the nb
# that softmax_dispatch instantiates): CTAs of 256 threads, each thread
# holding 16, 32, 64 or 128 bytes of its CTA's slice, up to 16 CTAs a row.
# A cluster grows past what the row needs only while each CTA keeps
# SM_MIN_SLICE bytes. The grid is persistent: as many clusters as the
# device holds at once (cudaOccupancyMaxActiveClusters), at most one a
# row; SM_CTAS_PER_SM CTAs an SM stands for that count where no device is
# asked.
SM_THREADS, SM_MAX_CLUSTER, SM_BYTES = 256, 16, (16, 32, 64, 128)
SM_MIN_SLICE = 4096
SM_CTAS_PER_SM = 4


def default_active(C: int, nb: int) -> int:
    """Clusters of C CTAs held at once where no device is asked."""
    return SM_CTAS_PER_SM * SM_COUNT // C


def softmax_plan(S: int, K: int, itemsize: int, lb: int,
                 max_cluster: int = SM_MAX_CLUSTER,
                 cluster: int | None = None, active=default_active,
                 threads: int = SM_THREADS) -> dict:
    """The route for an (S, K) softmax of ``itemsize``-byte elements read in
    ``lb``-byte words: ``cluster`` with its cluster size (C, the fewest
    power of 2 whose CTAs hold a row, grown while S C falls short of the
    card's SMs and each CTA keeps SM_MIN_SLICE bytes; ``cluster`` forces
    it), the bytes a thread holds (``nb``: the fewest of SM_BYTES that hold
    the rank's words), its ``loads`` (nb / lb), the persistent grid's
    ``clusters`` (min(S, active(C, nb))) and ``grid`` (clusters x C CTAs);
    else ``stream``, where a row's words outgrow ``max_cluster`` CTAs."""
    words = cdiv(K, lb // itemsize)  # at least any row's whole words
    cap = threads * SM_BYTES[-1] // lb  # words a CTA holds
    if cluster is None:
        C = 1
        while cdiv(words, C) > cap:
            C *= 2
            if C > max_cluster:
                return {"route": "stream", "grid": S}
        while (S * C < SM_COUNT and 2 * C <= max_cluster
               and cdiv(words, 2 * C) * lb >= SM_MIN_SLICE):
            C *= 2
    else:
        C = cluster
        if cdiv(words, C) > cap:
            raise ValueError(f"softmax: {C} CTAs cannot hold a row of {K}")
    per = cdiv(words, C)
    nb = next(b for b in SM_BYTES if threads * (b // lb) >= per)
    clusters = min(S, active(C, nb))
    return {"route": "cluster", "cluster": C, "nb": nb, "loads": nb // lb,
            "clusters": clusters, "grid": clusters * C}


def cluster_rows(plan: dict, S: int) -> list[list[int]]:
    """The rows each cluster of the persistent grid takes, in order."""
    return [list(range(g, S, plan["clusters"]))
            for g in range(plan["clusters"])]


def softmax_rank_words(K: int, itemsize: int, lb: int, C: int,
                       offset: int = 0) -> tuple:
    """How the cluster route cuts a row of K elements that starts ``offset``
    elements past an ``lb``-aligned address: (head, [(first word, words)
    of each rank], tail), the head's and tail's elements taken singly by
    ranks 0 and C - 1 (csrc/row_ops.cu softmax_cluster)."""
    E = lb // itemsize
    head = min(K, (E - offset % E) % E)
    nvec = (K - head) // E
    per = cdiv(nvec, C)
    ranks = []
    for r in range(C):
        v0 = min(nvec, r * per)
        ranks.append((v0, min(nvec, v0 + per) - v0))
    return head, ranks, K - head - nvec * E


def naive_softmax_plain(x):
    e = torch.exp(x.float())
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def safe_softmax_plain(x):
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def online_softmax_plain(x):
    """The online form's arithmetic over the whole row: the (m, d) pair,
    then exp(x - m) * (1 / d)."""
    xf = x.float()
    m = xf.amax(dim=-1, keepdim=True)
    d = torch.exp(xf - m).sum(dim=-1, keepdim=True)
    return (torch.exp(xf - m) * (1.0 / d)).to(x.dtype)


PLAIN = {NAIVE: naive_softmax_plain, SAFE: safe_softmax_plain,
         ONLINE: online_softmax_plain}


_ACTIVE: dict = {}  # (device, dtype, lb, nb, C) -> clusters held at once


def _active(x, lb, C, nb) -> int:
    """Clusters of C CTAs of the (dtype, lb, nb) instantiation that x's
    device holds at once (cudaOccupancyMaxActiveClusters), asked once."""
    from leetcuda_tpu_torch.build import kernel

    key = (x.device.index, x.dtype, lb, nb, C)
    if key not in _ACTIVE:
        n = ctypes.c_int(0)
        fn = kernel("row_ops", "lc_softmax_clusters", rw.SOFTMAX_CLUSTERS_ARGS)
        check_launch(fn(rw.DTYPES[x.dtype], lb, nb, C, ctypes.byref(n)),
                     "softmax")
        _ACTIVE[key] = n.value
    return _ACTIVE[key]


_PLANS: dict = {}  # (device, S, K, dtype, lb, forced cluster) -> plan


def device_plan(x, lb, cluster=None) -> dict:
    """``softmax_plan`` for x on its device: the cluster size capped where
    the device cannot schedule it, the grid from the clusters it holds."""
    S, K = x.shape
    key = (x.device.index, S, K, x.dtype, lb, cluster)
    plan = _PLANS.get(key)
    if plan is None:
        cap = SM_MAX_CLUSTER
        while True:
            plan = softmax_plan(S, K, x.element_size(), lb, cap, cluster,
                                lambda C, nb: _active(x, lb, C, nb))
            if plan["route"] == "stream" or plan["clusters"] > 0:
                break
            if cluster is not None:
                raise ValueError(f"softmax: the device holds no cluster of "
                                 f"{cluster} CTAs")
            cap = plan["cluster"] // 2
        _PLANS[key] = plan
    return plan


def _run(x, out, mode, vec, lb, plan, lib="row_ops"):
    """Launch ``plan``'s route into ``out`` (checked, non-empty operands;
    ``lib``: a variant build for the bench) and count it."""
    S, K = x.shape
    if plan["route"] == "cluster":
        rw.launch(SOFTMAX, "lc_softmax", rw.SOFTMAX_ARGS, x.device,
                  x.data_ptr(), out.data_ptr(), S, K, rw.DTYPES[x.dtype], lb,
                  plan["nb"], plan["cluster"], plan["clusters"], mode,
                  source=lib)
    else:
        rw.launch(SOFTMAX_STREAM, "lc_softmax_stream", rw.SOFTMAX_STREAM_ARGS,
                  x.device, x.data_ptr(), out.data_ptr(), S, K,
                  rw.DTYPES[x.dtype], vec, lb, mode, rw.threads_for(K, vec),
                  source=lib)
    return out


def _launch(x, mode, vec, pack):
    rw.check_kernel_operands("softmax", x)
    out = torch.empty_like(x)
    if x.numel():
        lb = rw.load_bytes(vec, pack, x.element_size())
        _run(x, out, mode, vec, lb, device_plan(x, lb))
    return out


def _make_rowwise(mode, *, vec: int = 1, pack: bool = False):
    def fn(x):
        rw.check_rows("softmax", x)
        if x.device.type == "cpu":
            return PLAIN[mode](x)
        return _launch(x, mode, vec, pack)

    fn.mode = mode
    return fn


def make_softmax(*, rows_per_step: int = 8, vec: int = 1, pack: bool = False):
    return _make_rowwise(NAIVE, vec=vec, pack=pack)


def make_safe_softmax(*, rows_per_step: int = 8, vec: int = 1,
                      pack: bool = False):
    return _make_rowwise(SAFE, vec=vec, pack=pack)


def make_online_softmax(*, rows_per_step: int = 8, chunk: int = 128,
                        vec: int = 1, pack: bool = False):
    return _make_rowwise(ONLINE, vec=vec, pack=pack)


def _softmax_ref(x):
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def _softmax_flops(x):
    return float(5 * x.numel())


def _softmax_bytes(x):
    return float(2 * x.numel() * x.element_size())


_COMMON = dict(ref=_softmax_ref, flops=_softmax_flops, bytes=_softmax_bytes,
               family="softmax")

for _suffix in ("f32", "f32x4"):
    register_op(f"softmax_{_suffix}_per_token", atol=1e-4, rtol=1e-4,
                tags=("naive", _suffix), **_COMMON)(
        make_softmax(**rw.rung(_suffix)))
    register_op(f"safe_softmax_{_suffix}_per_token", atol=1e-5, rtol=1e-5,
                tags=("safe", _suffix), **_COMMON)(
        make_safe_softmax(**rw.rung(_suffix)))

for _suffix, _atol in [("f16_f32", 1e-2), ("f16x2_f32", 1e-2),
                       ("f16x8_pack_f32", 1e-2)]:
    register_op(f"safe_softmax_{_suffix}_per_token", atol=_atol, rtol=1e-2,
                tags=("safe", _suffix), **_COMMON)(
        make_safe_softmax(**rw.rung(_suffix)))

register_op("online_safe_softmax_f32", atol=1e-5, rtol=1e-5,
            tags=("online", "f32"), **_COMMON)(make_online_softmax())
register_op("online_safe_softmax_f32x4_pack", atol=1e-5, rtol=1e-5,
            tags=("online", "f32x4"), **_COMMON)(
    make_online_softmax(**rw.rung("f32x4_pack")))

softmax = make_safe_softmax(rows_per_step=256, vec=8, pack=True)
online_softmax = make_online_softmax(rows_per_step=256, vec=8, pack=True)
