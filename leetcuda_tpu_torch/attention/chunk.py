"""Chunk attention: T query tokens per sequence against the KV cache.

Counterpart of ``leetcuda_tpu/attention/chunk.py`` (``make_chunk_attention``
and ``make_paged_chunk_attention``): the attention of speculative verify
(T = k + 1), prefix-cached admission and chunked prefill (T a multiple of the
prefill bucket). q (B, H, T, D); query row t of sequence b sits at position
``base_lengths[b] + t`` and attends cache columns ``< base + t + 1`` (the
whole prefix and causally inside the chunk), with ``window`` also
``>= base + t + 1 - window``. ``base_lengths`` (B,) int32 EXCLUDES the chunk,
whose own K/V must already be in the cache (append, then attend), and lies in
[0, capacity]; ``base + T`` is clamped to the capacity. Positions at or past
``base + T`` may hold anything, NaN included.

Four entry points over two routes of hand-written kernels: a contiguous
cache (B, Hkv, S, D), bf16 or quantized (int8 / float8_e4m3fn with f32
scales (B, Hkv, S); scores are (q . k_raw) * sm_scale * k_scale, and P . V
uses p * v_scale after the denominator has summed p), and page pools
(N, Hkv, page, D) (scale pools (N, Hkv, page)) behind ``page_table``
(B, P_max) int32, as ``attention/paged.py`` lays them out. On CUDA tensors
the wrappers launch the route ``chunk_plan`` names from shapes alone (bf16
q, head dim 64, 128 or 256, any GQA group) and raise on what it does not
take: route A, split-KV (``csrc/chunk_attn.cu``: the rows of a KV head in
blocks of 16, each sequence's band cut into splits of ``SPLIT_KEYS[D]``
keys merged in the same launch), for few rows a KV head (verify); route B,
TMA + wgmma tiles (``csrc/chunk_tma.cu``: 128 rows a CTA, the band's key
tiles through a ring of stages), for many (chunked prefill, admission).
Each launch also counts on its route's counter (``chunk_attention_split``,
``chunk_attention_tma``). ``chunk_split_plain`` is route A's split and
merge in torch ops; ``split_band``, ``chunk_key_range``, ``chunk_tiles``,
``tma_edge`` and ``paged_boxes`` mirror the kernels' walks for the tests. On CPU tensors the
wrappers run the plain PyTorch versions below. The TPU factories'
``block_k`` is DMA tiling and has no counterpart. ``softcap`` caps each
score (after a quantized cache's scale fold) with ``cap * tanh(s / cap)``
before the mask; None or 0 means none. ``with_lse`` also returns each
query row's log-sum-exp (B, H, T) f32 in natural units over the columns it
attends (-1e30 for a row that attends none, whose output is zeros); a
launch with it counts on the entry point's ``..._lse`` counter.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from leetcuda_tpu_torch.attention.decode import _outputs
from leetcuda_tpu_torch.attention.flash import (HEAD_DIMS, SMEM_LIMIT,
                                                attn_options, cap_scores)
from leetcuda_tpu_torch.attention.paged import _gather
from leetcuda_tpu_torch.core.runtime import (LaunchCounter, cdiv,
                                             check_launch)

_NEG_INF = -1e30

CHUNK = LaunchCounter("chunk_attention")
CHUNK_Q = LaunchCounter("chunk_attention_quantized")
PAGED_CHUNK = LaunchCounter("paged_chunk_attention")
PAGED_CHUNK_Q = LaunchCounter("paged_chunk_attention_quantized")
CHUNK_LSE = LaunchCounter("chunk_attention_lse")
CHUNK_Q_LSE = LaunchCounter("chunk_attention_quantized_lse")
PAGED_CHUNK_LSE = LaunchCounter("paged_chunk_attention_lse")
PAGED_CHUNK_Q_LSE = LaunchCounter("paged_chunk_attention_quantized_lse")
# every launch of the eight entry points also counts on its route's
ROUTE_COUNTERS = {"split": LaunchCounter("chunk_attention_split"),
                  "tma": LaunchCounter("chunk_attention_tma")}
ROUTE_SOURCES = {"split": "chunk_attn", "tma": "chunk_tma"}
# lc_chunk_split(q, k, v, k_scale, v_scale, table, base, out, lse, ws,
#                counters, B, H, Hkv, T, S, page, D, cache, split, n_split,
#                scale, window, softcap, stream)
_SPLIT_ARGS = ((ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 10
               + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                  ctypes.c_void_p))
# lc_chunk_tma(q, k, v, k_scale, v_scale, table, base, out, lse, B, H, Hkv,
#              T, S, page, pool_pages, D, cache, scale, window, softcap,
#              stream)
_TMA_ARGS = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 9
             + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p))
_CACHE_CODE = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
# Route A's constants (csrc/chunk_attn.cu, lc_chunk_plan): query rows a
# CTA (the mma's 16), keys a tile, most stages, most splits.
SPLIT_CONSTS = (16, 32, 6, 1024)
# Keys a route-A split by head dim, a multiple of the 32-key tile: fixed, so
# that a row's splits and merge order depend on its own sequence alone.
SPLIT_KEYS = {64: 128, 128: 256, 256: 256}
# Route B's tiles (csrc/chunk_tma.cu tma_plan): keys a stage and stages by
# head dim, 128 query rows a CTA in two warpgroups.
TMA_PLAN = {64: (128, 3), 128: (128, 2), 256: (64, 2)}
TMA_ROWS = 128
# The crossover: route B takes a call from this many query rows a KV head
# (G * T) up, by cache (bf16: False, int8 / e4m3: True), where its feed
# takes the page size (``tma_feeds``). Timed in turn at T = 4..128 and G =
# 2, 4, 8 on an H100 (bench/attn_bench.py --chunk, PERF.md rows 6-7): bf16
# route B won from 64 rows at every G, quantized from 256 (its stages are
# dequantized on the way).
TMA_MIN_ROWS = {False: 64, True: 256}


def chunk_attention_plain(q, k_cache, v_cache, base_lengths, *, sm_scale=None,
                          window=None, k_scale=None, v_scale=None,
                          softcap=None, with_lse=False):
    """Plain PyTorch version of the kernel: f32 scores and P.V, -1e30 mask,
    divide by max(l, 1e-30). K, V and both scales are zeroed wherever no row
    of the chunk looks, and P outside each row's limits, so NaN at or past
    ``base + T`` cannot reach the result. With scales (a quantized cache):
    scores times k_scale, and l sums p before P.V takes p * v_scale.
    ``softcap`` caps the scores after the scale fold, before the mask.
    ``with_lse``: also (B, H, T) f32 m + log(max(l, 1e-30)), m the masked
    maximum (-1e30 for a row that attends nothing)."""
    B, H, T, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    group = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    limit = (base_lengths.to(dev).long()[:, None]
             + torch.arange(T, device=dev)[None, :] + 1)          # (B, T)
    cols = torch.arange(S, device=dev)[None, None, :]
    valid = cols < limit[:, :, None]                              # (B, T, S)
    if window:
        valid &= cols >= limit[:, :, None] - window
    used = valid.any(dim=1)[:, None, :, None]                     # (B,1,S,1)
    # row r = g * T + t of a KV head carries chunk row t's limits
    keep = valid[:, None].expand(B, group, T, S).reshape(B, 1, group * T, S)
    zero = torch.zeros((), device=dev)
    kf = torch.where(used, k_cache.float(), zero)
    vf = torch.where(used, v_cache.float(), zero)
    qg = q.float().reshape(B, Hkv, group * T, D)
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale        # (B,Hkv,G*T,S)
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    s = cap_scores(s, softcap)
    s = torch.where(keep, s, torch.full((), _NEG_INF, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), zero)
    l = p.sum(-1, keepdim=True)
    if v_scale is not None:
        p = torch.where(keep, p * v_scale.float()[:, :, None, :], zero)
    out = torch.matmul(p, vf) / torch.clamp(l, min=1e-30)
    out = out.reshape(B, H, T, D).to(q.dtype)
    if with_lse:  # rows (kv head, g, t): flattened (H, T)
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        return out, lse.reshape(B, H, T)
    return out


def chunk_attention_quantized_plain(q, k_q, v_q, k_scale, v_scale,
                                    base_lengths, *, sm_scale=None,
                                    window=None, softcap=None,
                                    with_lse=False):
    """Plain PyTorch version over a quantized cache (fp8 upcast with
    ``.float()``: CPU torch has no fp8 matmul)."""
    return chunk_attention_plain(q, k_q, v_q, base_lengths, sm_scale=sm_scale,
                                 window=window, k_scale=k_scale,
                                 v_scale=v_scale, softcap=softcap,
                                 with_lse=with_lse)


def paged_chunk_attention_plain(q, k_pages, v_pages, page_table,
                                base_lengths, *, sm_scale=None, window=None,
                                softcap=None, with_lse=False):
    """Plain PyTorch version over page pools: gather each row's pages through
    the table into a contiguous view, then ``chunk_attention_plain``."""
    return chunk_attention_plain(q, _gather(k_pages, page_table),
                                 _gather(v_pages, page_table), base_lengths,
                                 sm_scale=sm_scale, window=window,
                                 softcap=softcap, with_lse=with_lse)


def paged_chunk_attention_quantized_plain(q, k_pages, v_pages, k_scales,
                                          v_scales, page_table, base_lengths,
                                          *, sm_scale=None, window=None,
                                          softcap=None, with_lse=False):
    """Plain PyTorch version over quantized pools and their scale pools."""
    return chunk_attention_plain(
        q, _gather(k_pages, page_table), _gather(v_pages, page_table),
        base_lengths, sm_scale=sm_scale, window=window,
        k_scale=_gather(k_scales, page_table),
        v_scale=_gather(v_scales, page_table), softcap=softcap,
        with_lse=with_lse)


def _check(q, k, v, base_lengths, window, softcap, page_table=None,
           scales=None):
    """The options, shapes and devices every chunk wrapper checks. ``k`` and
    ``v`` are caches (B, Hkv, S, D) or, with ``page_table``, pools
    (N, Hkv, page, D); ``scales`` the pair of scale tensors of a quantized
    cache. Returns ``window`` and ``softcap`` as the kernels take them
    (``attn_options``)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    options = attn_options(window, softcap)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B,H,T,D), caches or pools of 4 dims: got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    if k.shape[3] != D or H % Hkv or T < 1 or (page_table is None
                                               and k.shape[0] != B):
        raise ValueError(f"incompatible q {tuple(q.shape)} / cache "
                         f"{tuple(k.shape)}")
    if base_lengths.shape != (B,):
        raise ValueError(f"base_lengths must be (B,) = ({B},), got "
                         f"{tuple(base_lengths.shape)}")
    on = [q, k, v, base_lengths]
    if page_table is not None:
        if page_table.dim() != 2 or page_table.shape[0] != B:
            raise ValueError(f"page_table must be (B, P_max), got "
                             f"{tuple(page_table.shape)}")
        on.append(page_table)
    if scales is not None:
        if any(s.shape != k.shape[:3] for s in scales):
            raise ValueError(f"scales must be {tuple(k.shape[:3])}, got "
                             f"{[tuple(s.shape) for s in scales]}")
        if k.dtype != v.dtype or k.dtype not in (torch.int8,
                                                 torch.float8_e4m3fn):
            raise ValueError(f"quantized caches must both be int8 or e4m3, "
                             f"got {k.dtype}, {v.dtype}")
        on.extend(scales)
    if any(t.device != q.device for t in on):
        raise ValueError("q, caches, scales, page_table and base_lengths "
                         "must lie on one device")
    return options


class ChunkPlan(NamedTuple):
    """One launch: its ``route`` ("split": route A, "tma": route B) and
    ``grid``. Route A: ``split_keys`` keys a split, ``n_splits`` splits a
    row block in the grid and, with more than one, ``workspace`` f32 of
    partials ((B * H * T, n_splits, D) outputs, then (B * H * T, n_splits,
    2) (m, l) pairs) and ``counters`` int32 arrival counts (0 and 0 with one
    split). Route B: ``keys`` a stage, ``stages`` and ``smem`` bytes."""
    route: str
    grid: tuple
    split_keys: int = 0
    n_splits: int = 0
    workspace: int = 0
    counters: int = 0
    keys: int = 0
    stages: int = 0
    smem: int = 0


def tma_feeds(page: int, D: int) -> bool:
    """Whether route B's feed takes pages of ``page`` (0: a contiguous
    cache): each box of a stage lies in one page and starts on the 128-byte
    swizzle's 8-row atom, so page % 8 == 0 and a stage's keys are whole
    pages (keys % page == 0) or lie inside one (page % keys == 0)."""
    keys = TMA_PLAN[D][0]
    return page == 0 or (page % 8 == 0
                         and (keys % page == 0 or page % keys == 0))


def tma_smem(D: int, quantized: bool) -> int:
    """Route B's shared-memory bytes (csrc/chunk_tma.cu Tile): Q, the
    dequantized tiles (two of K, one of V) and their scales (quantized),
    the stages, the barriers, and 1024 bytes of alignment."""
    keys, stages = TMA_PLAN[D]
    es = 1 if quantized else 2
    bf = 3 * keys * D * 2 if quantized else 0
    scales = 3 * keys * 4 if quantized else 0
    return (1024 + TMA_ROWS * D * 2 + bf + stages * 2 * keys * D * es
            + scales + 8 * (1 + 2 * stages))


def chunk_plan(B: int, H: int, Hkv: int, T: int, D: int, S: int,
               window: int | None = None, page: int = 0,
               quantized: bool = False, route: str | None = None,
               split_keys: int | None = None) -> ChunkPlan:
    """The launch of a call over capacity ``S`` (S_max, or P_max * page),
    from shapes alone (no length is read on the host). Route B where G * T
    >= TMA_MIN_ROWS[quantized] and its feed takes the page size, else route
    A; ``route`` forces one (the bench's A/B), ``split_keys`` route A's
    split. Route A's band is at most min(S, window + T - 1) keys, so its
    grid has ceil(that / split_keys) splits (a row block uses the first
    max(1, ceil((end - lo) / split_keys)) of them, ``split_band``)."""
    R = H // Hkv * T
    if route is None:
        route = ("tma" if R >= TMA_MIN_ROWS[bool(quantized)]
                 and tma_feeds(page, D) else "split")
    if route == "tma":
        keys, stages = TMA_PLAN[D]
        return ChunkPlan("tma", (cdiv(R, TMA_ROWS), B * Hkv), keys=keys,
                         stages=stages, smem=tma_smem(D, quantized))
    split = split_keys or SPLIT_KEYS[D]
    band = min(S, window + T - 1) if window else S
    n = max(1, cdiv(band, split))
    nhb = cdiv(R, SPLIT_CONSTS[0])
    grid = (n, Hkv * nhb, B)
    if n == 1:
        return ChunkPlan("split", grid, split, 1)
    return ChunkPlan("split", grid, split, n, B * H * T * n * (D + 2),
                     B * Hkv * nhb)


def split_band(base: int, T: int, S: int, window: int | None):
    """Route A's band of a sequence: (lo, end), lo = max(base + 1 -
    window, 0) (row 0's window floor; 0 without a window), end = min(base +
    T, S), base clamped to [0, S]. Its splits count from lo."""
    base = min(max(base, 0), S)
    return (max(base + 1 - window, 0) if window else 0), min(base + T, S)


def t_span(r0: int, r1: int, T: int):
    """The chunk positions (t_lo, t_hi) of query rows [r0, r1) (r1 > r0,
    row r = g * T + t): one g's run, or every t where they cross a g."""
    if r0 // T == (r1 - 1) // T:
        return r0 % T, (r1 - 1) % T
    return 0, T - 1


def chunk_key_range(r0, r1, R, T, base, S, window):
    """Keys [lo, hi) that rows [r0, r1) of the R = G * T rows attend ((0, 0):
    none): route B's key tiles (csrc/chunk_tma.cu chunk_keys), common.cuh
    key_range with the base offset."""
    r1 = min(r1, R)
    if r1 <= r0:
        return 0, 0
    t_lo, t_hi = t_span(r0, r1, T)
    lo = max(base + t_lo + 1 - window, 0) if window else 0
    hi = min(base + t_hi + 1, S)
    return (lo, hi) if hi > lo else (0, 0)


def chunk_tiles(r0, r1, R, T, base, S, window, keys):
    """The key tiles (indices of ``keys`` keys) that route B's rows [r0,
    r1) walk, in order: those of ``chunk_key_range`` less the tiles wholly
    between the two bands of a run of rows across one g boundary whose
    positions t_a..T-1 and 0..t_b do not meet (csrc/chunk_tma.cu
    chunk_tiles)."""
    lo, hi = chunk_key_range(r0, r1, R, T, base, S, window)
    if hi <= lo:
        return []
    kt_lo, kt_hi = lo // keys, cdiv(hi, keys)
    r1 = min(r1, R)
    if window and (r1 - 1) // T == r0 // T + 1:
        t_a, t_b = r0 % T, (r1 - 1) % T
        g_hi = min(base + t_b + 1, S)
        g_lo = max(base + t_a + 1 - window, 0)
        a, e = cdiv(g_hi, keys), min(g_lo // keys, kt_hi)
        if t_b + 1 < t_a and e > a:
            return [*range(kt_lo, a), *range(e, kt_hi)]
    return list(range(kt_lo, kt_hi))


def tma_edge(k0, keys, r0, R, T, base, S, window):
    """Whether route B masks key tile [k0, k0 + keys) for the 64 rows from
    r0: where it crosses the smallest limit of the live rows or the largest
    window floor (csrc/chunk_tma.cu)."""
    t_lo, t_hi = t_span(r0, min(r0 + 64, R), T)
    lim_min = min(base + t_lo + 1, S)
    return k0 + keys > lim_min or bool(window
                                       and k0 < base + t_hi + 1 - window)


def paged_boxes(k0: int, keys: int, page: int, end: int):
    """Route B's paged feed of the stage of keys [k0, k0 + keys): boxes
    (stage row, logical page, row in the page, rows) of min(page, keys)
    rows, none of a page at or past ceil(end / page)."""
    box = min(page, keys)
    out = []
    for r in range(0, keys, box):
        lp = (k0 + r) // page
        if lp >= cdiv(end, page):
            break
        out.append((r, lp, k0 + r - lp * page, box))
    return out


def chunk_split_plain(q, k_cache, v_cache, base_lengths, *, sm_scale=None,
                      window=None, k_scale=None, v_scale=None, softcap=None,
                      with_lse=False, split_keys=None):
    """Route A's split and merge in torch ops, f32, beside
    ``chunk_attention_plain`` (same arguments over a contiguous cache;
    ``split_keys`` defaults to SPLIT_KEYS[D]). Sequence b's band [lo, end)
    (``split_band``) is cut into splits of ``split_keys`` keys from lo; in
    each split a row keeps its own columns (below its limit, at or above its
    window floor) and takes its max m_s (-1e30 where it keeps none), sum
    l_s and unnormalized P.V acc_s (P times the v scales); a sequence of one
    split returns acc_0 / max(l_0, 1e-30) and m_0 + log(max(l_0, 1e-30));
    otherwise M = max_s m_s, w_s = exp(m_s - M), L = sum_s w_s l_s, the
    output sum_s w_s acc_s / max(L, 1e-30) and the lse M + log(max(L,
    1e-30)), summed in split order. K and V are zeroed outside the band."""
    window, softcap = attn_options(window, softcap)
    B, H, T, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    group = H // Hkv
    split = split_keys or SPLIT_KEYS[D]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    base = base_lengths.to(dev).long().clamp(0, S)
    limit = base[:, None] + torch.arange(T, device=dev)[None, :] + 1  # (B, T)
    cols = torch.arange(S, device=dev)[None, None, :]
    valid = cols < limit[:, :, None]                               # (B, T, S)
    if window:
        valid &= cols >= limit[:, :, None] - window
    keep = valid[:, None].expand(B, group, T, S).reshape(B, 1, group * T, S)
    lo = (base + 1 - window).clamp(min=0) if window else torch.zeros_like(
        base)
    end = (base + T).clamp(max=S)
    band = (cols[:, 0] >= lo[:, None]) & (cols[:, 0] < end[:, None])  # (B,S)
    zero = torch.zeros((), device=dev)
    vmask = band[:, None, :, None]
    kf = torch.where(vmask, k_cache.float(), zero)
    vf = torch.where(vmask, v_cache.float(), zero)
    qg = q.float().reshape(B, Hkv, group * T, D)
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale           # (B,Hkv,R,S)
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    s = cap_scores(s, softcap)
    band_w = min(S, window + T - 1) if window else S
    n_split = max(1, cdiv(band_w, split))
    n_live = ((end - lo + split - 1) // split).clamp(min=1)        # (B,)
    split_of = torch.div(cols[:, 0] - lo[:, None], split,
                         rounding_mode="floor")                    # (B, S)
    neg = torch.full((), _NEG_INF, device=dev)
    ms, ls, accs = [], [], []
    for i in range(n_split):
        keep_i = keep & (band & (split_of == i))[:, None, None, :]
        si = torch.where(keep_i, s, neg)
        m = si.amax(dim=-1, keepdim=True)
        p = torch.where(keep_i, torch.exp(si - m), zero)
        ls.append(p.sum(-1, keepdim=True))
        if v_scale is not None:
            p = torch.where(keep_i, p * v_scale.float()[:, :, None, :], zero)
        ms.append(m)
        accs.append(torch.matmul(p, vf))
    live = (torch.arange(n_split, device=dev)[None, :]
            < n_live[:, None])[:, None, None, :, None]            # (B,1,1,n,1)
    m_all = torch.where(live, torch.stack(ms, 3), neg)           # (B,Hkv,R,n,1)
    M = m_all.amax(dim=3)
    w = torch.where(live, torch.exp(m_all - M[:, :, :, None]), zero)
    l_all, acc_all = torch.stack(ls, 3), torch.stack(accs, 3)
    L, acc = torch.zeros_like(M), torch.zeros_like(acc_all[:, :, :, 0])
    for i in range(n_split):  # in split order
        L = L + w[:, :, :, i] * l_all[:, :, :, i]
        acc = acc + w[:, :, :, i] * acc_all[:, :, :, i]
    one = (n_live == 1)[:, None, None, None]                       # (B,1,1,1)
    L = torch.where(one, l_all[:, :, :, 0], L)
    acc = torch.where(one, acc_all[:, :, :, 0], acc)
    M = torch.where(one, m_all[:, :, :, 0], M)
    out = (acc * (1.0 / torch.clamp(L, min=1e-30))).reshape(B, H, T, D)
    out = out.to(q.dtype)
    if with_lse:
        lse = M + torch.log(torch.clamp(L, min=1e-30))
        return out, lse.reshape(B, H, T)
    return out


def _check_kernel_args(q, k, v, base_lengths, page_table=None, scales=None):
    """What the CUDA kernels take: bf16 q, contiguous operands that start on
    a 16-byte boundary, int32 ``base_lengths`` and table, head dim
    64/128/256, bf16 caches or f32 scales, and a cache its 32-bit row index
    and position count can address."""
    B, H, T, D = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"chunk kernel takes a bf16 q, got {q.dtype}")
    named = dict(q=q, k=k, v=v, base_lengths=base_lengths)
    if page_table is not None:
        named["page_table"] = page_table
    if scales is not None:
        named.update(k_scale=scales[0], v_scale=scales[1])
        if any(s.dtype != torch.float32 for s in scales):
            raise ValueError("quantized chunk kernel takes f32 scales")
    elif k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError(f"chunk kernel takes bf16 caches, got {k.dtype}, "
                         f"{v.dtype}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"chunk kernel: {name} must be contiguous")
        if name in ("q", "k", "v") and t.data_ptr() % 16:
            raise ValueError(f"chunk kernel: {name} must start on a 16-byte "
                             "boundary (TMA and 16-byte copies)")
    if base_lengths.dtype != torch.int32 or (
            page_table is not None and page_table.dtype != torch.int32):
        raise ValueError("base_lengths and page_table must be int32")
    Hkv = k.shape[1]
    rows = k.shape[0] * Hkv * k.shape[2]
    cap = (k.shape[2] if page_table is None
           else page_table.shape[1] * k.shape[2])
    blocks = Hkv * cdiv(H // Hkv * T, SPLIT_CONSTS[0])
    if (D not in HEAD_DIMS or B > 65535 or B * Hkv > 65535
            or blocks > 65535 or rows >= 2 ** 32 or cap + T >= 2 ** 31
            or H // Hkv * T >= 2 ** 31):
        raise ValueError(
            f"chunk kernel: head dim {D} {HEAD_DIMS}, batch {B} and kv heads "
            f"{Hkv} (B * Hkv and row blocks {blocks} <= 65535), {rows} cache "
            f"rows (< 2^32), capacity {cap} + T {T} (< 2^31)")


_BUILD_CHECKED: set = set()


def check_build(lib, route):
    """Compare the constants ``lib`` (the source of ``route``, or a variant
    build of it) was built with (``lc_chunk_plan`` / ``lc_chunk_tma_plan``)
    with the wrapper's; the package's builds must match. Returns them."""
    from leetcuda_tpu_torch.build import entry

    info = (ctypes.c_int * 5)()
    if route == "split":
        check_launch(entry(lib, "lc_chunk_plan", (ctypes.c_void_p,))(
            ctypes.addressof(info)), "chunk_attention_split")
        got = tuple(info[:4])
        if lib == "chunk_attn" and got != SPLIT_CONSTS:
            raise RuntimeError(f"csrc/chunk_attn.cu was built with {got}; "
                               f"the wrapper plans {SPLIT_CONSTS}")
        return got
    plans = {}
    for D in HEAD_DIMS:
        check_launch(entry(lib, "lc_chunk_tma_plan", (
            ctypes.c_int, ctypes.c_void_p))(D, ctypes.addressof(info)),
            "chunk_attention_tma")
        plans[D] = tuple(info)
        want = (TMA_ROWS, *TMA_PLAN[D], tma_smem(D, False), tma_smem(D, True))
        if lib == "chunk_tma" and plans[D] != want:
            raise RuntimeError(f"csrc/chunk_tma.cu was built with "
                               f"{plans[D]} at D={D}; the wrapper plans "
                               f"{want}")
    return plans


def launch(q, k, v, ks, vs, table, base_lengths, out, lse, *, scale, window,
           softcap, route=None, split_keys=None, lib=None):
    """Launch the route ``chunk_plan`` names (or ``route``) once: k, v (and
    the scales ks, vs, or None for a bf16 cache) are caches (B, Hkv, S, D)
    with ``table`` None, or pools (N, Hkv, page, D) with ``table`` (B,
    P_max). Route A's workspace and counters are the stream's
    (gemm/quant.py ``_split_scratch``). ``lib``: a variant build of the
    route's source (bench). Returns (the plan, the CUDA error code)."""
    from leetcuda_tpu_torch.build import entry
    from leetcuda_tpu_torch.gemm.quant import _split_scratch

    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    page = S if table is not None else 0
    if page:
        S = table.shape[1] * page
    plan = chunk_plan(B, H, Hkv, T, D, S, window, page, ks is not None,
                      route=route, split_keys=split_keys)
    lib = lib or ROUTE_SOURCES[plan.route]
    key = lib if isinstance(lib, str) else id(lib)
    if key not in _BUILD_CHECKED:
        check_build(lib, plan.route)
        _BUILD_CHECKED.add(key)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cache = _CACHE_CODE[k.dtype]
    if plan.route == "split":
        if plan.n_splits > SPLIT_CONSTS[3]:
            raise ValueError(f"chunk kernel: a band of up to {S} keys makes "
                             f"{plan.n_splits} splits of {plan.split_keys} "
                             f"(at most {SPLIT_CONSTS[3]})")
        ws = counters = None
        if plan.n_splits > 1:
            ws, counters = _split_scratch(q.device, stream, plan.workspace,
                                          plan.counters)
        ptr = [None if t is None else t.data_ptr() for t in (
            q, k, v, ks, vs, table, base_lengths, out, lse, ws, counters)]
        fn = entry(lib, "lc_chunk_split", _SPLIT_ARGS)
        return plan, fn(*ptr, B, H, Hkv, T, S, page, D, cache,
                        plan.split_keys, plan.n_splits, float(scale), window,
                        softcap, stream)
    ptr = [None if t is None else t.data_ptr() for t in (
        q, k, v, ks, vs, table, base_lengths, out, lse)]
    fn = entry(lib, "lc_chunk_tma", _TMA_ARGS)
    return plan, fn(*ptr, B, H, Hkv, T, S, page, k.shape[0] if page else 0,
                    D, cache, float(scale), window, softcap, stream)


def _run(counter, lse_counter, q, k, v, ks, vs, table, base_lengths, *,
         scale, window, softcap, with_lse):
    """Launch the planned route into new outputs; count the launch on
    ``lse_counter`` when there is an lse, else on ``counter``, and on its
    route's counter."""
    out, lse = _outputs(q, with_lse)
    counter = lse_counter if with_lse else counter
    plan, err = launch(q, k, v, ks, vs, table, base_lengths, out, lse,
                       scale=scale, window=window, softcap=softcap)
    check_launch(err, f"{counter.name} ({plan.route} route)")
    counter.add()
    ROUTE_COUNTERS[plan.route].add()
    return (out, lse) if with_lse else out


def chunk_attention(q, k_cache, v_cache, base_lengths, *, sm_scale=None,
                    window=None, softcap=None, with_lse=False):
    """chunk_attention(q (B, H, T, D), k_cache, v_cache (B, Hkv, S, D),
    base_lengths (B,) int32) -> (B, H, T, D), or with ``with_lse``
    (out, lse (B, H, T) f32)."""
    window, softcap = _check(q, k_cache, v_cache, base_lengths, window,
                             softcap)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return chunk_attention_plain(q, k_cache, v_cache, base_lengths,
                                     sm_scale=scale, window=window,
                                     softcap=softcap, with_lse=with_lse)
    _check_kernel_args(q, k_cache, v_cache, base_lengths)
    return _run(CHUNK, CHUNK_LSE, q, k_cache, v_cache, None, None, None,
                base_lengths, scale=scale, window=window, softcap=softcap,
                with_lse=with_lse)


def chunk_attention_quantized(q, k_q, v_q, k_scale, v_scale, base_lengths, *,
                              sm_scale=None, window=None, softcap=None,
                              with_lse=False):
    """Chunk attention over an int8 or float8_e4m3fn cache with f32 scales
    (B, Hkv, S) -> (B, H, T, D) in q's dtype, or with ``with_lse`` (out,
    lse (B, H, T) f32)."""
    window, softcap = _check(q, k_q, v_q, base_lengths, window, softcap,
                             scales=(k_scale, v_scale))
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return chunk_attention_quantized_plain(
            q, k_q, v_q, k_scale, v_scale, base_lengths, sm_scale=scale,
            window=window, softcap=softcap, with_lse=with_lse)
    _check_kernel_args(q, k_q, v_q, base_lengths, scales=(k_scale, v_scale))
    return _run(CHUNK_Q, CHUNK_Q_LSE, q, k_q, v_q, k_scale, v_scale, None,
                base_lengths, scale=scale, window=window, softcap=softcap,
                with_lse=with_lse)


def paged_chunk_attention(q, k_pages, v_pages, page_table, base_lengths, *,
                          sm_scale=None, window=None, softcap=None,
                          with_lse=False):
    """paged_chunk_attention(q (B, H, T, D), k_pages, v_pages
    (N, Hkv, page, D), page_table (B, P_max) int32, base_lengths (B,) int32)
    -> (B, H, T, D), or with ``with_lse`` (out, lse (B, H, T) f32). Only
    pages that hold a position below ``base + T`` are looked up: table
    filler and the null page 0 may hold anything."""
    window, softcap = _check(q, k_pages, v_pages, base_lengths, window,
                             softcap, page_table=page_table)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(
            q, k_pages, v_pages, page_table, base_lengths, sm_scale=scale,
            window=window, softcap=softcap, with_lse=with_lse)
    _check_kernel_args(q, k_pages, v_pages, base_lengths,
                       page_table=page_table)
    return _run(PAGED_CHUNK, PAGED_CHUNK_LSE, q, k_pages, v_pages, None,
                None, page_table, base_lengths, scale=scale, window=window,
                softcap=softcap, with_lse=with_lse)


def paged_chunk_attention_quantized(q, k_pages, v_pages, k_scales, v_scales,
                                    page_table, base_lengths, *,
                                    sm_scale=None, window=None, softcap=None,
                                    with_lse=False):
    """Paged chunk attention over int8 or float8_e4m3fn pools with f32 scale
    pools (N, Hkv, page) -> (B, H, T, D) in q's dtype, or with ``with_lse``
    (out, lse (B, H, T) f32)."""
    window, softcap = _check(q, k_pages, v_pages, base_lengths, window,
                             softcap, page_table=page_table,
                             scales=(k_scales, v_scales))
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return paged_chunk_attention_quantized_plain(
            q, k_pages, v_pages, k_scales, v_scales, page_table,
            base_lengths, sm_scale=scale, window=window, softcap=softcap,
            with_lse=with_lse)
    _check_kernel_args(q, k_pages, v_pages, base_lengths,
                       page_table=page_table, scales=(k_scales, v_scales))
    return _run(PAGED_CHUNK_Q, PAGED_CHUNK_Q_LSE, q, k_pages, v_pages,
                k_scales, v_scales, page_table, base_lengths, scale=scale,
                window=window, softcap=softcap, with_lse=with_lse)
