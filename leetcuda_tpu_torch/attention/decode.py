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

On CUDA tensors the wrappers launch ``csrc/decode_attn.cu`` where it takes
the call (bf16 q, head dim 64 or 128, GQA group 1/2/4/8) and
``csrc/decode_attn_wide.cu`` otherwise (a bf16 or f32 q, head dim 64, 128,
256 or 576, any group: the heads in blocks of 8), and raise on what neither
takes.
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

import torch

from leetcuda_tpu_torch.attention.flash import attn_options, cap_scores
from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch

_NEG_INF = -1e30

DECODE = LaunchCounter("decode_attention")
DECODE_Q = LaunchCounter("decode_attention_quantized")
DECODE_LSE = LaunchCounter("decode_attention_lse")
DECODE_Q_LSE = LaunchCounter("decode_attention_quantized_lse")
DECODE_SHARED = LaunchCounter("decode_attention_shared")
DECODE_Q_SHARED = LaunchCounter("decode_attention_quantized_shared")
DECODE_SHARED_LSE = LaunchCounter("decode_attention_shared_lse")
DECODE_Q_SHARED_LSE = LaunchCounter("decode_attention_quantized_shared_lse")
# lc_decode_attn_bf16(q, k, v, lengths, out, lse, B, H, Hkv, S, D, scale,
#                     window, softcap, stream)
_DECODE_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5
                + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p))
# lc_decode_attn_q(q, k, v, k_scale, v_scale, lengths, out, lse, B, H, Hkv,
#                  S, D, fp8, scale, window, softcap, stream)
_DECODE_Q_ARGS = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6
                  + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                     ctypes.c_void_p))
# lc_paged_attn_bf16(q, k_pages, v_pages, page_table, lengths, out, lse, B, H,
#                    Hkv, P_max, page, D, scale, window, softcap, stream)
_PAGED_ARGS = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6
               + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                  ctypes.c_void_p))
# lc_paged_attn_q(q, k_pages, v_pages, k_scales, v_scales, page_table, lengths,
#                 out, lse, B, H, Hkv, P_max, page, D, fp8, scale, window,
#                 softcap, stream)
_PAGED_Q_ARGS = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7
                 + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p))
# lc_decode_attn_wide(q, k, v, k_scale, v_scale, table, lengths, out, lse, B,
#                     H, Hkv, S, page, D, cache, q_f32, scale, window,
#                     softcap, stream)
_WIDE_ARGS = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 8
              + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                 ctypes.c_void_p))
# What the kernels take: decode_attn.cu (narrow) a bf16 q at these head dims
# and groups; decode_attn_wide.cu a bf16 or f32 q at these head dims, any
# group.
NARROW_HEAD_DIMS, NARROW_GROUPS = (64, 128), (1, 2, 4, 8)
HEAD_DIMS = (64, 128, 256, 576)
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
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (B,) int32 tensor")
    if D not in HEAD_DIMS or B > 65535 or Hkv > 65535:
        raise ValueError(f"decode kernel: head dim {D} (takes "
                         f"{'/'.join(map(str, HEAD_DIMS))}), batch {B} and "
                         f"{Hkv} KV heads (<= 65535)")


def _outputs(q, with_lse):
    """A kernel's outputs: out like q and, with the lse, one f32 a query
    row (q's shape without its head dim)."""
    lse = (torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
           if with_lse else None)
    return torch.empty_like(q), lse


def launch(q, k, v, ks, vs, table, lengths, out, lse, *, scale, window,
           softcap):
    """Launch one decode or paged kernel: the narrow kernel of
    ``csrc/decode_attn.cu`` where it takes the call (bf16 q, head dim 64 or
    128, a group of 1, 2, 4 or 8), else ``csrc/decode_attn_wide.cu``. k, v
    (and the scales ks, vs, or None for a bf16 cache) are caches (B, Hkv,
    S, D) with ``table`` None, or pools (N, Hkv, page, D) with ``table``
    (B, P_max); k is v for the shared form. Returns the CUDA error code."""
    from leetcuda_tpu_torch.build import kernel

    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    paged = table is not None
    page = S if paged else 0
    if paged:
        S = table.shape[1] * page
    cache = _CACHE_CODE[k.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = [None if t is None else t.data_ptr()
           for t in (q, k, v, ks, vs, table, lengths, out, lse)]
    opts = (float(scale), window, softcap, stream)
    if not (q.dtype == torch.bfloat16 and D in NARROW_HEAD_DIMS
            and H // Hkv in NARROW_GROUPS):
        fn = kernel("decode_attn_wide", "lc_decode_attn_wide", _WIDE_ARGS)
        return fn(*ptr, B, H, Hkv, S, page, D, cache,
                  int(q.dtype == torch.float32), *opts)
    qp, kp, vp, ksp, vsp, tp, lp, op, sp = ptr
    fp8 = int(cache == 2)
    if paged and cache:
        return kernel("decode_attn", "lc_paged_attn_q", _PAGED_Q_ARGS)(
            qp, kp, vp, ksp, vsp, tp, lp, op, sp, B, H, Hkv, S // page, page,
            D, fp8, *opts)
    if paged:
        return kernel("decode_attn", "lc_paged_attn_bf16", _PAGED_ARGS)(
            qp, kp, vp, tp, lp, op, sp, B, H, Hkv, S // page, page, D, *opts)
    if cache:
        return kernel("decode_attn", "lc_decode_attn_q", _DECODE_Q_ARGS)(
            qp, kp, vp, ksp, vsp, lp, op, sp, B, H, Hkv, S, D, fp8, *opts)
    return kernel("decode_attn", "lc_decode_attn_bf16", _DECODE_ARGS)(
        qp, kp, vp, lp, op, sp, B, H, Hkv, S, D, *opts)


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
