"""Decode (single-token) attention over a contiguous KV cache, with GQA.

Counterpart of ``leetcuda_tpu/attention/decode.py`` (``make_decode_attention``
and ``make_decode_attention_quantized``). q (B, H, D); caches (B, Hkv, S_max,
D); lengths (B,) int32 = valid positions per sequence (the current token's
K/V already appended). Positions at or past a length may hold anything, NaN
included. A quantized cache is int8 or float8_e4m3fn with f32 scales per
(b, kv head, position) in the layout (B, Hkv, S_max); the scales fold past
the dots: scores are (q . k_raw) * sm_scale * k_scale, and P . V uses
p * v_scale after the softmax denominator has summed p. The output has q's
dtype.

``shared_kv`` takes JAX's calling forms: ``decode_attention(q, cache,
lengths)`` and ``decode_attention_quantized(q, cache_q, scale, lengths)``,
one operand (and one scale) read as both K and V: MLA's latent cache
(models/mla.py), (B, 1, S_max, d_c + d_r) with the whole of H in one group.
A shared launch counts on its own counter (``decode_attention_shared``,
``decode_attention_quantized_shared``, with ``_lse`` where the lse is asked
for).

On CUDA tensors the wrappers launch ``csrc/decode_attn.cu``, one split-KV
kernel for every head dim (64, 128, 256, 576), GQA group, q type (bf16, or
f32 as MLA's absorbed query), cache type and layout, once per call, and
raise on what it does not take. Each row's band of keys is cut into splits
of ``SPLIT_KEYS[D]`` keys counted from the band's start (``split_plan``), the
splits run on their own CTAs and the last to finish merges them in split
order in the same launch, through a workspace from torch's allocator and a
counter buffer of the stream (``_stream_counters``). No length is read on
the host, so a launch can be captured in a CUDA graph (launch once on the
stream before capturing: the counter buffer is made outside the capture).
``attend_split_plain`` is the kernel's split and merge in torch ops.
On CPU tensors they run the plain PyTorch versions below, which take the
same forms.

``window`` attends only the last ``window`` positions, ``len - window ..
len - 1`` (the kernel reads nothing before them), and ``softcap`` caps each
score (after the quantized cache's scale fold) with ``cap * tanh(s / cap)``
before the mask; None or 0 means neither. ``with_lse`` also returns each
query row's log-sum-exp (B, H) f32 in natural units, m + log(max(l,
1e-30)), over the positions the row attends (after the cap): -1e30 for a
row of length 0, whose output is zeros. It is what an attention sink needs
(``out * sigmoid(lse - sink)``, models/llama.py). A launch with the lse
counts on its own counter (``decode_attention_lse``,
``decode_attention_quantized_lse``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from leetcuda_tpu_torch.attention.flash import attn_options, cap_scores
from leetcuda_tpu_torch.core.runtime import (LaunchCounter, cdiv,
                                             check_launch)

_NEG_INF = -1e30

DECODE = LaunchCounter("decode_attention")
DECODE_Q = LaunchCounter("decode_attention_quantized")
DECODE_LSE = LaunchCounter("decode_attention_lse")
DECODE_Q_LSE = LaunchCounter("decode_attention_quantized_lse")
DECODE_SHARED = LaunchCounter("decode_attention_shared")
DECODE_Q_SHARED = LaunchCounter("decode_attention_quantized_shared")
DECODE_SHARED_LSE = LaunchCounter("decode_attention_shared_lse")
DECODE_Q_SHARED_LSE = LaunchCounter("decode_attention_quantized_shared_lse")
# lc_decode_attn(q, k, v, k_scale, v_scale, table, lengths, out, lse, ws,
#                counters, B, H, Hkv, S, page, D, cache, q_f32, split,
#                n_split, scale, window, softcap, stream)
_ARGS = ((ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 10
         + (ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p))
HEAD_DIMS = (64, 128, 256, 576)
# Keys a CTA takes (a split) by head dim, a multiple of the kernel's
# 32-key tile (TILE_KEYS): fixed, so that a row's splits and merge order
# depend on its length and window alone; chosen by timing candidates at the
# main paths' shapes on an H100 (PERF.md).
SPLIT_KEYS = {64: 128, 128: 256, 256: 256, 576: 128}
TILE_KEYS = 32
HEAD_BLOCK = 16  # query heads a CTA (the tensor-core tile's 16 rows)
MAX_SPLITS = 1024  # the merge keeps each split's weights in shared memory
_CACHE_CODE = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}

_DECODE_NAMES = ("k_cache", "v_cache", "lengths")
_DECODE_Q_NAMES = ("k_q", "v_q", "k_scale", "v_scale", "lengths")


def _operands(fn: str, args, names, shared_kv: bool):
    """The positional operands after q of a wrapper in JAX's calling form,
    as the unshared list ``names``: with ``shared_kv`` the call leaves out
    every ``v_...`` operand, and its ``k_...`` operand takes its place."""
    want = [n for n in names if not (shared_kv and n.startswith("v_"))]
    if len(args) != len(want):
        raise TypeError(f"{fn}(q, {', '.join(want)})"
                        f"{' with shared_kv' if shared_kv else ''} takes "
                        f"{len(want)} operands after q, got {len(args)}")
    got = dict(zip(want, args))
    return [got["k_" + n[2:]] if shared_kv and n.startswith("v_") else got[n]
            for n in names]


def counter(base: str, shared_kv: bool, with_lse: bool) -> LaunchCounter:
    """The launch counter of the entry point ``base`` in its shared / lse
    form: ``base`` [+ "_shared"] [+ "_lse"]."""
    from leetcuda_tpu_torch.core.runtime import _COUNTERS

    return _COUNTERS[base + ("_shared" if shared_kv else "")
                     + ("_lse" if with_lse else "")]


def attend_plain(q, k_cache, v_cache, lengths, *, sm_scale=None,
                 k_scale=None, v_scale=None, window=None, softcap=None,
                 with_lse=False):
    """Plain PyTorch version of the kernels: f32 scores and P.V, -1e30 mask,
    divide by max(l, 1e-30). The positions attended are ``len - window ..
    len - 1`` with a window, else ``0 .. len - 1``; both P and V are zeroed
    outside them, as the TPU kernel zeroes them past the length, so NaN
    there cannot reach the result. With scales (a quantized cache): scores
    times k_scale, and l sums p before P.V takes p * v_scale. ``softcap``
    caps the scores after the scale fold, before the mask. ``with_lse``:
    also (B, H) f32 m + log(max(l, 1e-30)), m the masked maximum (-1e30
    where nothing is attended). k and v may be one tensor (shared_kv)."""
    window, softcap = attn_options(window, softcap)
    B, H, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    group = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    cols = torch.arange(S, device=q.device)[None, :]
    lens = lengths.to(q.device).long()[:, None]
    valid = cols < lens                                       # (B, S)
    if window:
        valid &= cols >= lens - window
    vmask = valid[:, None, :, None]
    zero = torch.zeros((), device=q.device)
    kf = torch.where(vmask, k_cache.float(), zero)
    vf = kf if v_cache is k_cache else torch.where(vmask, v_cache.float(),
                                                   zero)
    qg = q.float().reshape(B, Hkv, group, D)
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale        # (B, Hkv, G, S)
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    s = cap_scores(s, softcap)
    keep = valid[:, None, None, :]
    s = torch.where(keep, s, torch.full((), _NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), zero)
    l = p.sum(-1, keepdim=True)
    if v_scale is not None:
        p = torch.where(keep, p * v_scale.float()[:, :, None, :], zero)
    out = torch.matmul(p, vf) / torch.clamp(l, min=1e-30)
    out = out.reshape(B, H, D).to(q.dtype)
    if with_lse:
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        return out, lse.reshape(B, H)
    return out


def decode_attention_plain(q, *args, sm_scale=None, window=None,
                           softcap=None, with_lse=False, shared_kv=False):
    """Plain PyTorch version of ``decode_attention``, in its forms:
    (q, k_cache, v_cache, lengths), or with ``shared_kv`` (q, cache,
    lengths)."""
    k, v, lengths = _operands("decode_attention_plain", args, _DECODE_NAMES,
                              shared_kv)
    return attend_plain(q, k, v, lengths, sm_scale=sm_scale, window=window,
                        softcap=softcap, with_lse=with_lse)


def decode_attention_quantized_plain(q, *args, sm_scale=None, window=None,
                                     softcap=None, with_lse=False,
                                     shared_kv=False):
    """Plain PyTorch version of the quantized kernel (fp8 upcast with
    ``.float()``: CPU torch has no fp8 matmul): (q, k_q, v_q, k_scale,
    v_scale, lengths), or with ``shared_kv`` (q, cache_q, scale,
    lengths)."""
    k, v, ks, vs, lengths = _operands("decode_attention_quantized_plain",
                                      args, _DECODE_Q_NAMES, shared_kv)
    return attend_plain(q, k, v, lengths, sm_scale=sm_scale, k_scale=ks,
                        v_scale=vs, window=window, softcap=softcap,
                        with_lse=with_lse)


def _check(q, k_cache, v_cache, lengths):
    """The shapes and devices every decode wrapper checks."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q (B,H,D), caches (B,Hkv,S,D): got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, D = q.shape
    Hkv = k_cache.shape[1]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or H % Hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} / cache "
                         f"{tuple(k_cache.shape)}")
    if not (q.device == k_cache.device == v_cache.device == lengths.device):
        raise ValueError("q, caches and lengths must lie on one device")


def _check_kernel_args(q, lengths, tensors):
    """What the CUDA kernels take: a bf16 or f32 q, contiguous operands,
    (B,) int32 lengths, head dim 64/128/256/576, any GQA group."""
    B, H, D = q.shape
    Hkv = tensors["k_cache"].shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"decode kernel takes a bf16 or f32 q, got "
                         f"{q.dtype}")
    for name, t in dict(q=q, **tensors).items():
        if not t.is_contiguous():
            raise ValueError(f"decode kernel: {name} must be contiguous")
        if (t.dim() == 4 or name == "q") and t.data_ptr() % 16:
            raise ValueError(f"decode kernel: {name} must start on a "
                             "16-byte boundary (16-byte copies)")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (B,) int32 tensor")
    blocks = Hkv * cdiv(H // Hkv, HEAD_BLOCK)
    if D not in HEAD_DIMS or B > 65535 or blocks > 65535:
        raise ValueError(f"decode kernel: head dim {D} (takes "
                         f"{'/'.join(map(str, HEAD_DIMS))}), batch {B} and "
                         f"{blocks} head blocks (<= 65535)")


def _outputs(q, with_lse):
    """A kernel's outputs: out like q and, with the lse, one f32 a query
    row (q's shape without its head dim)."""
    lse = (torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
           if with_lse else None)
    return torch.empty_like(q), lse


class SplitPlan(NamedTuple):
    """How the kernel cuts a call: ``split_keys`` keys a split, ``n_splits``
    split CTAs a (row, KV head, head block) in the grid, ``head_blocks``
    blocks of up to HEAD_BLOCK query heads a KV head; with more than one
    split, ``workspace`` f32 of partials (the outputs' (B * H, n_splits, D)
    then the (m, l) pairs' (B * H, n_splits, 2)) and ``counters`` int32
    arrival counts; 0 and 0 with one split."""
    split_keys: int
    n_splits: int
    head_blocks: int
    workspace: int
    counters: int


def split_plan(B: int, H: int, Hkv: int, D: int, S: int,
               window: int | None = None) -> SplitPlan:
    """The kernel's split plan for a call over capacity ``S`` (S_max, or
    P_max * page): the band a row attends is at most min(S, window) keys,
    so ``n_splits`` = ceil(min(S, window) / SPLIT_KEYS[D]), known on the
    host without reading a length. A row of length n uses the first
    max(1, ceil(band / split_keys)) of them, band = min(n, window)."""
    split = SPLIT_KEYS[D]
    band = min(S, window) if window else S
    n = max(1, cdiv(band, split))
    hb = cdiv(H // Hkv, HEAD_BLOCK)
    if n == 1:
        return SplitPlan(split, 1, hb, 0, 0)
    return SplitPlan(split, n, hb, B * H * n * (D + 2), B * Hkv * hb)


def attend_split_plain(q, k_cache, v_cache, lengths, *, sm_scale=None,
                       k_scale=None, v_scale=None, window=None, softcap=None,
                       with_lse=False, split_keys=None):
    """The kernel's split and merge in torch ops, f32, beside
    ``attend_plain`` (same arguments; ``split_keys`` defaults to
    SPLIT_KEYS[D]). Row b's band [lo, len), lo = max(len - window, 0) or 0,
    is cut into splits of ``split_keys`` keys from lo; each split takes its
    own max m_s, sum l_s and unnormalized P.V acc_s (P times the v scales);
    a row of one split returns acc_0 / max(l_0, 1e-30) and m_0 + log(max(
    l_0, 1e-30)); otherwise M = max_s m_s, w_s = exp(m_s - M), L = sum_s
    w_s l_s and the output sum_s w_s acc_s / max(L, 1e-30), lse M +
    log(max(L, 1e-30)), summed in split order. Positions outside the band
    are zeroed on both sides of P.V, as in ``attend_plain``."""
    window, softcap = attn_options(window, softcap)
    B, H, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    group = H // Hkv
    split = split_keys or SPLIT_KEYS[D]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    cols = torch.arange(S, device=dev)[None, :]
    lens = lengths.to(dev).long().clamp(0, S)[:, None]           # (B, 1)
    lo = (lens - window).clamp(min=0) if window else torch.zeros_like(lens)
    band = (cols >= lo) & (cols < lens)                            # (B, S)
    zero = torch.zeros((), device=dev)
    vmask = band[:, None, :, None]
    kf = torch.where(vmask, k_cache.float(), zero)
    vf = kf if v_cache is k_cache else torch.where(vmask, v_cache.float(),
                                                   zero)
    qg = q.float().reshape(B, Hkv, group, D)
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale           # (B,Hkv,G,S)
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    s = cap_scores(s, softcap)
    n_split = max(1, cdiv(min(S, window) if window else S, split))
    n_live = ((lens - lo + split - 1) // split).clamp(min=1)        # (B, 1)
    split_of = torch.div(cols - lo, split, rounding_mode="floor")   # (B, S)
    neg = torch.full((), _NEG_INF, device=dev)
    ms, ls, accs = [], [], []
    for i in range(n_split):
        keep = (band & (split_of == i))[:, None, None, :]
        si = torch.where(keep, s, neg)
        m = si.amax(dim=-1, keepdim=True)
        p = torch.where(keep, torch.exp(si - m), zero)
        ls.append(p.sum(-1, keepdim=True))
        if v_scale is not None:
            p = torch.where(keep, p * v_scale.float()[:, :, None, :], zero)
        ms.append(m)
        accs.append(torch.matmul(p, vf))
    live = (torch.arange(n_split, device=dev)[None, :]
            < n_live)[:, None, None, :, None]                    # (B,1,1,n,1)
    m_all = torch.where(live, torch.stack(ms, 3), neg)           # (B,Hkv,G,n,1)
    M = m_all.amax(dim=3)
    w = torch.where(live, torch.exp(m_all - M[:, :, :, None]), zero)
    l_all, acc_all = torch.stack(ls, 3), torch.stack(accs, 3)
    L, acc = torch.zeros_like(M), torch.zeros_like(acc_all[:, :, :, 0])
    for i in range(n_split):  # in split order
        L = L + w[:, :, :, i] * l_all[:, :, :, i]
        acc = acc + w[:, :, :, i] * acc_all[:, :, :, i]
    one = (n_live == 1)[:, :, None, None]                           # (B,1,1,1)
    L = torch.where(one, l_all[:, :, :, 0], L)
    acc = torch.where(one, acc_all[:, :, :, 0], acc)
    M = torch.where(one, m_all[:, :, :, 0], M)
    out = (acc * (1.0 / torch.clamp(L, min=1e-30))).reshape(B, H, D)
    out = out.to(q.dtype)
    if with_lse:
        lse = M + torch.log(torch.clamp(L, min=1e-30))
        return out, lse.reshape(B, H)
    return out


# One zeroed int32 counter buffer per (device, stream): the kernel's last
# split of a block zeroes its counter again, so the buffer is zero between
# launches and two streams never share a counter. A buffer that growth
# replaces stays alive in _RETIRED_COUNTERS for the life of the process: a
# CUDA graph captured on the stream before the growth still launches into
# it. Growth at least doubles the buffer, so what is retired holds less
# than the live buffer, and few growths happen.
_STREAM_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}
_RETIRED_COUNTERS: list[torch.Tensor] = []
_MIN_COUNTERS = 4096


def _stream_counters(device, stream: int, n: int) -> torch.Tensor:
    """The counter buffer of ``stream`` on ``device``, at least ``n`` long,
    made (zeroed, on the stream) at its first use and grown by a new buffer
    at least twice as long; the old one is kept, never freed. Inside a
    graph capture it must exist already: launch once on the stream before
    capturing. A graph captured on the stream holds the buffer of its
    capture: its replays must not overlap each other on two streams, since
    the kernel expects its counters at zero between launches."""
    key = (device.index, stream)
    buf = _STREAM_COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode kernel: this stream has no split "
                               "counters of that size yet; launch the call "
                               "once on it before capturing a graph")
        if buf is not None:
            _RETIRED_COUNTERS.append(buf)
        buf = torch.zeros(max(n, _MIN_COUNTERS,
                              0 if buf is None else 2 * buf.numel()),
                          dtype=torch.int32, device=device)
        _STREAM_COUNTERS[key] = buf
    return buf


def launch(q, k, v, ks, vs, table, lengths, out, lse, *, scale, window,
           softcap):
    """Launch ``csrc/decode_attn.cu`` once. k, v (and the scales ks, vs, or
    None for a bf16 cache) are caches (B, Hkv, S, D) with ``table`` None, or
    pools (N, Hkv, page, D) with ``table`` (B, P_max); k is v for the
    shared form. The workspace comes from torch's allocator, the counters
    from the stream's buffer. Returns the CUDA error code."""
    from leetcuda_tpu_torch.build import kernel

    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    page = S if table is not None else 0
    if page:
        S = table.shape[1] * page
    plan = split_plan(B, H, Hkv, D, S, window)
    if plan.n_splits > MAX_SPLITS:
        raise ValueError(f"decode kernel: a band of up to {S} keys makes "
                         f"{plan.n_splits} splits of {plan.split_keys} "
                         f"(at most {MAX_SPLITS})")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = counters = None
    if plan.n_splits > 1:
        ws = torch.empty(plan.workspace, dtype=torch.float32,
                         device=q.device)
        counters = _stream_counters(q.device, stream, plan.counters)
    ptr = [None if t is None else t.data_ptr()
           for t in (q, k, v, ks, vs, table, lengths, out, lse, ws, counters)]
    fn = kernel("decode_attn", "lc_decode_attn", _ARGS)
    return fn(*ptr, B, H, Hkv, S, page, D, _CACHE_CODE[k.dtype],
              int(q.dtype == torch.float32), plan.split_keys, plan.n_splits,
              float(scale), window, softcap, stream)


def decode_attention(q, *args, sm_scale=None, window=None, softcap=None,
                     with_lse=False, shared_kv=False):
    """decode_attention(q, k_cache, v_cache, lengths), or with
    ``shared_kv`` decode_attention(q, cache, lengths) -> (B, H, D), or with
    ``with_lse`` (out, lse (B, H) f32)."""
    k_cache, v_cache, lengths = _operands("decode_attention", args,
                                          _DECODE_NAMES, shared_kv)
    _check(q, k_cache, v_cache, lengths)
    window, softcap = attn_options(window, softcap)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[2])
    if q.device.type == "cpu":
        return attend_plain(q, k_cache, v_cache, lengths, sm_scale=scale,
                            window=window, softcap=softcap,
                            with_lse=with_lse)

    _check_kernel_args(q, lengths, dict(k_cache=k_cache, v_cache=v_cache))
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise ValueError(f"decode kernel takes bf16 caches, got "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    out, lse = _outputs(q, with_lse)
    count = counter("decode_attention", shared_kv, with_lse)
    check_launch(launch(q, k_cache, v_cache, None, None, None, lengths, out,
                        lse, scale=scale, window=window, softcap=softcap),
                 count.name)
    count.add()
    return (out, lse) if with_lse else out


def decode_attention_quantized(q, *args, sm_scale=None, window=None,
                               softcap=None, with_lse=False, shared_kv=False):
    """decode_attention_quantized(q, k_q, v_q, k_scale, v_scale, lengths),
    or with ``shared_kv`` (q, cache_q, scale, lengths): an int8 or
    float8_e4m3fn cache with f32 scales (B, Hkv, S_max) -> (B, H, D) in q's
    dtype (bf16, or f32 as MLA's absorbed query), or with ``with_lse``
    (out, lse (B, H) f32)."""
    k_q, v_q, k_scale, v_scale, lengths = _operands(
        "decode_attention_quantized", args, _DECODE_Q_NAMES, shared_kv)
    _check(q, k_q, v_q, lengths)
    window, softcap = attn_options(window, softcap)
    B, Hkv, S, _ = k_q.shape
    if k_scale.shape != (B, Hkv, S) or v_scale.shape != (B, Hkv, S):
        raise ValueError(f"scales must be (B, Hkv, S) = {(B, Hkv, S)}, got "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")
    if k_q.dtype != v_q.dtype or k_q.dtype not in (torch.int8,
                                                   torch.float8_e4m3fn):
        raise ValueError(f"quantized caches must both be int8 or e4m3, got "
                         f"{k_q.dtype}, {v_q.dtype}")
    if not (k_scale.device == v_scale.device == q.device):
        raise ValueError("scales must lie on q's device")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[2])
    if q.device.type == "cpu":
        return attend_plain(q, k_q, v_q, lengths, sm_scale=scale,
                            k_scale=k_scale, v_scale=v_scale, window=window,
                            softcap=softcap, with_lse=with_lse)

    _check_kernel_args(q, lengths, dict(k_cache=k_q, v_cache=v_q,
                                        k_scale=k_scale, v_scale=v_scale))
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("quantized decode kernel takes f32 scales")
    out, lse = _outputs(q, with_lse)
    count = counter("decode_attention_quantized", shared_kv, with_lse)
    check_launch(launch(q, k_q, v_q, k_scale, v_scale, None, lengths, out,
                        lse, scale=scale, window=window, softcap=softcap),
                 count.name)
    count.add()
    return (out, lse) if with_lse else out
