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

Four entry points over one kernel (``csrc/chunk_attn.cu``): a contiguous
cache (B, Hkv, S, D), bf16 or quantized (int8 / float8_e4m3fn with f32 scales
(B, Hkv, S); scores are (q . k_raw) * sm_scale * k_scale, and P . V uses
p * v_scale after the denominator has summed p), and page pools
(N, Hkv, page, D) (scale pools (N, Hkv, page)) behind ``page_table``
(B, P_max) int32, as ``attention/paged.py`` lays them out. On CUDA tensors
the wrappers launch the kernel (bf16 q, head dim 64, 128 or 256, any GQA
group)
and raise on what it does not take; on CPU tensors they run the plain
PyTorch versions below. The TPU factories' ``block_k`` is DMA tiling and has
no counterpart. ``softcap`` caps each score (after a quantized cache's scale
fold) with ``cap * tanh(s / cap)`` before the mask; None or 0 means none.
``with_lse`` also returns each query row's log-sum-exp (B, H, T) f32 in
natural units over the columns it attends (-1e30 for a row that attends
none, whose output is zeros); a launch with it counts on the entry point's
``..._lse`` counter.
"""

from __future__ import annotations

import ctypes
import math

import torch

from leetcuda_tpu_torch.attention.decode import _outputs
from leetcuda_tpu_torch.attention.flash import (HEAD_DIMS, attn_options,
                                                cap_scores)
from leetcuda_tpu_torch.attention.paged import _gather
from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch

_NEG_INF = -1e30

CHUNK = LaunchCounter("chunk_attention")
CHUNK_Q = LaunchCounter("chunk_attention_quantized")
PAGED_CHUNK = LaunchCounter("paged_chunk_attention")
PAGED_CHUNK_Q = LaunchCounter("paged_chunk_attention_quantized")
CHUNK_LSE = LaunchCounter("chunk_attention_lse")
CHUNK_Q_LSE = LaunchCounter("chunk_attention_quantized_lse")
PAGED_CHUNK_LSE = LaunchCounter("paged_chunk_attention_lse")
PAGED_CHUNK_Q_LSE = LaunchCounter("paged_chunk_attention_quantized_lse")
# lc_chunk_attn_bf16(q, k, v, base, out, lse, B, H, Hkv, T, S, D, window,
#                    softcap, scale, stream)
_CHUNK_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7
               + (ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
# lc_chunk_attn_q(q, k, v, k_scale, v_scale, base, out, lse, B, H, Hkv, T, S,
#                 D, fp8, window, softcap, scale, stream)
_CHUNK_Q_ARGS = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8
                 + (ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
# lc_paged_chunk_attn_bf16(q, k_pages, v_pages, page_table, base, out, lse, B,
#                          H, Hkv, T, P_max, page, D, window, softcap, scale,
#                          stream)
_PAGED_CHUNK_ARGS = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 8
                     + (ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
# lc_paged_chunk_attn_q(q, k_pages, v_pages, k_scales, v_scales, page_table,
#                       base, out, lse, B, H, Hkv, T, P_max, page, D, fp8,
#                       window, softcap, scale, stream)
_PAGED_CHUNK_Q_ARGS = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 9
                       + (ctypes.c_float, ctypes.c_float, ctypes.c_void_p))


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


def _check_kernel_args(q, k, v, base_lengths, page_table=None, scales=None):
    """What the CUDA kernel takes: bf16 q, contiguous operands, int32
    ``base_lengths`` and table, head dim 64/128/256, bf16 caches or f32 scales,
    and a cache its 32-bit row index and position count can address."""
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
    if base_lengths.dtype != torch.int32 or (
            page_table is not None and page_table.dtype != torch.int32):
        raise ValueError("base_lengths and page_table must be int32")
    rows = k.shape[0] * k.shape[1] * k.shape[2]
    cap = (k.shape[2] if page_table is None
           else page_table.shape[1] * k.shape[2])
    if (D not in HEAD_DIMS or B > 65535 or k.shape[1] > 65535
            or rows >= 2 ** 32 or cap + T >= 2 ** 31
            or H // k.shape[1] * T >= 2 ** 31):
        raise ValueError(
            f"chunk kernel: head dim {D} {HEAD_DIMS}, batch {B} and kv heads "
            f"{k.shape[1]} (<= 65535), {rows} cache rows (< 2^32), capacity "
            f"{cap} + T {T} (< 2^31)")


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _launch(fn, counter, lse_counter, out, lse, ptrs, rest):
    """Call the C entry point ``fn`` as fn(*ptrs, out, lse or null, *rest)
    and count the launch on ``lse_counter`` when there is an lse, else on
    ``counter``."""
    counter = lse_counter if lse is not None else counter
    err = fn(*ptrs, out.data_ptr(), None if lse is None else lse.data_ptr(),
             *rest)
    check_launch(err, counter.name)
    counter.add()
    return out if lse is None else (out, lse)


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

    from leetcuda_tpu_torch.build import kernel

    _check_kernel_args(q, k_cache, v_cache, base_lengths)
    B, H, T, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    fn = kernel("chunk_attn", "lc_chunk_attn_bf16", _CHUNK_ARGS)
    return _launch(fn, CHUNK, CHUNK_LSE, *_outputs(q, with_lse),
                   (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    base_lengths.data_ptr()),
                   (B, H, Hkv, T, S, D, window, softcap, float(scale),
                    _stream(q)))


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

    from leetcuda_tpu_torch.build import kernel

    _check_kernel_args(q, k_q, v_q, base_lengths, scales=(k_scale, v_scale))
    B, H, T, D = q.shape
    _, Hkv, S, _ = k_q.shape
    fn = kernel("chunk_attn", "lc_chunk_attn_q", _CHUNK_Q_ARGS)
    return _launch(fn, CHUNK_Q, CHUNK_Q_LSE, *_outputs(q, with_lse),
                   (q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(),
                    k_scale.data_ptr(), v_scale.data_ptr(),
                    base_lengths.data_ptr()),
                   (B, H, Hkv, T, S, D, int(k_q.dtype == torch.float8_e4m3fn),
                    window, softcap, float(scale), _stream(q)))


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

    from leetcuda_tpu_torch.build import kernel

    _check_kernel_args(q, k_pages, v_pages, base_lengths,
                       page_table=page_table)
    B, H, T, D = q.shape
    _, Hkv, page, _ = k_pages.shape
    fn = kernel("chunk_attn", "lc_paged_chunk_attn_bf16", _PAGED_CHUNK_ARGS)
    return _launch(fn, PAGED_CHUNK, PAGED_CHUNK_LSE, *_outputs(q, with_lse),
                   (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    page_table.data_ptr(), base_lengths.data_ptr()),
                   (B, H, Hkv, T, page_table.shape[1], page, D, window,
                    softcap, float(scale), _stream(q)))


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

    from leetcuda_tpu_torch.build import kernel

    _check_kernel_args(q, k_pages, v_pages, base_lengths,
                       page_table=page_table, scales=(k_scales, v_scales))
    B, H, T, D = q.shape
    _, Hkv, page, _ = k_pages.shape
    fn = kernel("chunk_attn", "lc_paged_chunk_attn_q", _PAGED_CHUNK_Q_ARGS)
    return _launch(fn, PAGED_CHUNK_Q, PAGED_CHUNK_Q_LSE,
                   *_outputs(q, with_lse),
                   (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    k_scales.data_ptr(), v_scales.data_ptr(),
                    page_table.data_ptr(), base_lengths.data_ptr()),
                   (B, H, Hkv, T, page_table.shape[1], page, D,
                    int(k_pages.dtype == torch.float8_e4m3fn), window,
                    softcap, float(scale), _stream(q)))
