"""Decode (single-token) attention over a contiguous KV cache, with GQA.

Counterpart of ``leetcuda_tpu/attention/decode.py`` (``make_decode_attention``
and ``make_decode_attention_quantized``). q (B, H, D); caches (B, Hkv, S_max,
D); lengths (B,) int32 = valid positions per sequence (the current token's
K/V already appended). Positions at or past a length may hold anything, NaN
included. A quantized cache is int8 or float8_e4m3fn with f32 scales per
(b, kv head, position) in the layout (B, Hkv, S_max); the scales fold past
the dots: scores are (q . k_raw) * sm_scale * k_scale, and P . V uses
p * v_scale after the softmax denominator has summed p.

On CUDA tensors the wrappers launch ``csrc/decode_attn.cu`` (bf16 q, head
dim 64 or 128, GQA group 1/2/4/8) and raise on what it does not take. On
CPU tensors they run the plain PyTorch versions below.

``window`` attends only the last ``window`` positions, ``len - window ..
len - 1`` (the kernel reads nothing before them), and ``softcap`` caps each
score (after the quantized cache's scale fold) with ``cap * tanh(s / cap)``
before the mask; None or 0 means neither. ``with_lse`` also returns each
query row's log-sum-exp (B, H) f32 in natural units, m + log(max(l,
1e-30)), over the positions the row attends (after the cap): -1e30 for a
row of length 0, whose output is zeros. It is what an attention sink needs
(``out * sigmoid(lse - sink)``, models/llama.py). A launch with the lse
counts on its own counter (``decode_attention_lse``,
``decode_attention_quantized_lse``). ``shared_kv`` is not ported yet and
raises (ROADMAP item 11e).
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


def decode_attention_plain(q, k_cache, v_cache, lengths, *, sm_scale=None,
                           k_scale=None, v_scale=None, window=None,
                           softcap=None, with_lse=False):
    """Plain PyTorch version of the kernels: f32 scores and P.V, -1e30 mask,
    divide by max(l, 1e-30). The positions attended are ``len - window ..
    len - 1`` with a window, else ``0 .. len - 1``; both P and V are zeroed
    outside them, as the TPU kernel zeroes them past the length, so NaN
    there cannot reach the result. With scales (a quantized cache): scores
    times k_scale, and l sums p before P.V takes p * v_scale. ``softcap``
    caps the scores after the scale fold, before the mask. ``with_lse``:
    also (B, H) f32 m + log(max(l, 1e-30)), m the masked maximum (-1e30
    where nothing is attended)."""
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
    vf = torch.where(vmask, v_cache.float(), zero)
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


def decode_attention_quantized_plain(q, k_q, v_q, k_scale, v_scale, lengths,
                                     *, sm_scale=None, window=None,
                                     softcap=None, with_lse=False):
    """Plain PyTorch version of the quantized kernel (fp8 upcast with
    ``.float()``: CPU torch has no fp8 matmul)."""
    return decode_attention_plain(q, k_q, v_q, lengths, sm_scale=sm_scale,
                                  k_scale=k_scale, v_scale=v_scale,
                                  window=window, softcap=softcap,
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
    """What the CUDA kernels take: bf16 q, contiguous operands, (B,) int32
    lengths, head dim 64/128, GQA group 1/2/4/8."""
    B, H, D = q.shape
    Hkv = tensors["k_cache"].shape[1]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"decode kernel takes a bf16 q, got {q.dtype}")
    for name, t in dict(q=q, **tensors).items():
        if not t.is_contiguous():
            raise ValueError(f"decode kernel: {name} must be contiguous")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (B,) int32 tensor")
    if D not in (64, 128) or H // Hkv not in (1, 2, 4, 8) or B > 65535:
        raise ValueError(f"decode kernel: head dim {D} (64/128), GQA group "
                         f"{H // Hkv} (1/2/4/8), batch {B} (<= 65535)")


def _outputs(q, with_lse):
    """A kernel's outputs: out like q and, with the lse, one f32 a query
    row (q's shape without its head dim)."""
    lse = (torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
           if with_lse else None)
    return torch.empty_like(q), lse


def decode_attention(q, k_cache, v_cache, lengths, *, sm_scale=None,
                     window=None, softcap=None, with_lse=False):
    """decode_attention(q, k_cache, v_cache, lengths) -> (B, H, D), or
    with ``with_lse`` (out, lse (B, H) f32)."""
    _check(q, k_cache, v_cache, lengths)
    window, softcap = attn_options(window, softcap)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[2])
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      sm_scale=scale, window=window,
                                      softcap=softcap, with_lse=with_lse)

    from leetcuda_tpu_torch.build import kernel

    _check_kernel_args(q, lengths, dict(k_cache=k_cache, v_cache=v_cache))
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise ValueError(f"decode kernel takes bf16 caches, got "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    B, H, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    out, lse = _outputs(q, with_lse)
    counter = DECODE_LSE if with_lse else DECODE
    fn = kernel("decode_attn", "lc_decode_attn_bf16", _DECODE_ARGS)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(),
             lse.data_ptr() if with_lse else None, B, H, Hkv, S, D,
             float(scale), window, softcap,
             torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, counter.name)
    counter.add()
    return (out, lse) if with_lse else out


def decode_attention_quantized(q, k_q, v_q, k_scale, v_scale, lengths, *,
                               sm_scale=None, window=None, softcap=None,
                               with_lse=False, shared_kv=False):
    """Decode attention over an int8 or float8_e4m3fn cache with f32
    scales (B, Hkv, S_max) -> (B, H, D) in q's dtype, or with ``with_lse``
    (out, lse (B, H) f32)."""
    if shared_kv:
        raise NotImplementedError(
            "quantized decode attention: shared_kv (MLA's latent cache) is "
            "not ported yet (ROADMAP item 11e)")
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
        return decode_attention_quantized_plain(
            q, k_q, v_q, k_scale, v_scale, lengths, sm_scale=scale,
            window=window, softcap=softcap, with_lse=with_lse)

    from leetcuda_tpu_torch.build import kernel

    _check_kernel_args(q, lengths, dict(k_cache=k_q, v_cache=v_q,
                                        k_scale=k_scale, v_scale=v_scale))
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("quantized decode kernel takes f32 scales")
    H, D = q.shape[1], q.shape[2]
    out, lse = _outputs(q, with_lse)
    counter = DECODE_Q_LSE if with_lse else DECODE_Q
    fn = kernel("decode_attn", "lc_decode_attn_q", _DECODE_Q_ARGS)
    err = fn(q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(),
             k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), lse.data_ptr() if with_lse else None, B, H, Hkv,
             S, D, int(k_q.dtype == torch.float8_e4m3fn), float(scale),
             window, softcap,
             torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, counter.name)
    counter.add()
    return (out, lse) if with_lse else out
