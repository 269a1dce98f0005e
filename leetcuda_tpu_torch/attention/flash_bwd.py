"""Flash-attention backward (FA-2) and the differentiable flash attention.

Counterpart of ``leetcuda_tpu/attention/flash_bwd.py``: ``_bwd`` becomes
``flash_attention_bwd`` (dQ and dK/dV kernels in ``csrc/flash_bwd.cu``),
``make_flash_attention_trainable`` a ``torch.autograd.Function`` whose
forward is the flash forward with its log-sum-exp (attention/flash.py,
``with_lse=True``) and whose backward is ``flash_attention_bwd``. Layouts
are the JAX package's: q, out, do (B, H, N, D), k/v (B, Hkv, N, D), lse
(B, H, N) f32.

On CUDA tensors the wrappers launch the kernels (bf16, head dim 64, 128 or
256, contiguous) and raise on what they do not take; on CPU tensors they run the
plain PyTorch versions in this module and attention/flash.py.

``window`` (the causal band, implying causal) and ``softcap`` are the
forward's options: the backward recomputes P from the capped scores under
the band, applies the chain rule through the cap (dS times 1 - (c / cap)^2
of the capped, pre-mask score c) and skips the tiles off the band, as JAX's
``_bwd`` does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from leetcuda_tpu_torch.attention.flash import (HEAD_DIMS, _NEG_INF,
                                                _check_qkv, attn_options,
                                                band_mask, cap_scores,
                                                flash_attention)
from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch

FLASH_BWD_DQ = LaunchCounter("flash_attention_bwd_dq")
FLASH_BWD_DKV = LaunchCounter("flash_attention_bwd_dkv")
# lc_flash_bwd_dq_bf16(q, k, v, do, lse, delta, dq, B, H, Hkv, N, Nk, D,
#                      scale, causal, window, softcap, stream)
_DQ_ARGS = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6
            + (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p))
# lc_flash_bwd_dkv_bf16(q, k, v, do, lse, delta, dk, dv, B, H, Hkv, N, Nk,
#                       D, scale, causal, window, softcap, stream)
_DKV_ARGS = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6
             + (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p))


def _delta(out, do, dlse):
    """rowsum(dO * O) - dlse (B, H, N) f32: the lse cotangent folds into the
    delta operand, d lse_i / d s_ij = p_ij (flash_bwd.py:168-179)."""
    delta = (do.float() * out.float()).sum(-1)
    return delta if dlse is None else delta - dlse.float()


def flash_attention_bwd_plain(q, k, v, out, lse, do, dlse=None, *, causal,
                              sm_scale, window=None, softcap=None):
    """Plain PyTorch version of the two kernels: the FA-2 formulas in f32,
    P = exp(C - lse) under a -1e30 mask, C = S * scale (capped with
    ``softcap``: cap tanh(S * scale / cap)), dP = dO V^T, dS = P (dP -
    delta) (times 1 - (C / cap)^2 with the cap), dQ = scale dS K, dV = P^T
    dO, dK = scale dS^T Q, with P and dS rounded to q's dtype before the
    second products as the kernels round them; the mask is the causal band
    with ``window`` (which implies causal); GQA sums each kv head's group of
    q heads."""
    window, softcap = attn_options(window, softcap)
    causal = causal or bool(window)
    B, H, N, D = q.shape
    Hkv, Nk = k.shape[1], k.shape[2]
    group = H // Hkv
    dt = q.dtype
    kx = k.float().repeat_interleave(group, dim=1)
    vx = v.float().repeat_interleave(group, dim=1)
    qf, dof = q.float(), do.float()
    c = cap_scores(torch.matmul(qf, kx.transpose(-1, -2)) * sm_scale,
                   softcap)
    s = c
    if causal:
        keep = band_mask(N, Nk, q.device, causal, window)
        s = torch.where(keep, c, torch.full((), _NEG_INF, device=q.device))
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(dof, vx.transpose(-1, -2))
    ds = p * (dp - _delta(out, do, dlse)[..., None])
    if softcap:  # the chain rule through cap * tanh(x / cap)
        ds = ds * (1.0 - torch.square(c / softcap))
    p, ds = p.to(dt).float(), ds.to(dt).float()
    dq = torch.matmul(ds, kx) * sm_scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * sm_scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = dk.reshape(B, Hkv, group, Nk, D).sum(2)
    dv = dv.reshape(B, Hkv, group, Nk, D).sum(2)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def _check_launch_args(q, k, v, out, lse, do, dlse):
    """Raise on what the kernels of csrc/flash_bwd.cu do not take."""
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("do", do)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash backward kernels take contiguous bf16 "
                             f"tensors; {name} is {t.dtype}, contiguous="
                             f"{t.is_contiguous()}")
    B, H, N, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash backward kernels: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"flash backward kernels: B*H={B * H} exceeds the "
                         "grid")
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    for name, t in (("lse", lse), ("dlse", dlse)):
        if t is not None and (t.shape != (B, H, N) or t.device != q.device):
            raise ValueError(f"{name} must be (B, H, N) on q's device; got "
                             f"{tuple(t.shape)} on {t.device}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous f32 tensor")


def _launch_dq(q, k, v, do, lse, delta, causal, scale, window=0,
               softcap=0.0):
    """Launch the dQ kernel of csrc/flash_bwd.cu on the current stream
    (arguments checked by the caller; ``delta`` from ``_delta``)."""
    from leetcuda_tpu_torch.build import kernel

    B, H, N, D = q.shape
    dq = torch.empty_like(q)
    fn = kernel("flash_bwd", "lc_flash_bwd_dq_bf16", _DQ_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H,
             k.shape[1], N, k.shape[2], D, float(scale), int(causal),
             int(window), float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, FLASH_BWD_DQ.name)
    FLASH_BWD_DQ.add()
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, scale, window=0,
                softcap=0.0):
    """Launch the dK/dV kernel of csrc/flash_bwd.cu on the current stream."""
    from leetcuda_tpu_torch.build import kernel

    B, H, N, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = kernel("flash_bwd", "lc_flash_bwd_dkv_bf16", _DKV_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             B, H, k.shape[1], N, k.shape[2], D, float(scale), int(causal),
             int(window), float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, FLASH_BWD_DKV.name)
    FLASH_BWD_DKV.add()
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, dlse=None, *, causal=False,
                        sm_scale=None, window=None, softcap=None):
    """Gradients (dq, dk, dv) of flash attention from its forward's ``out``
    and ``lse`` and the cotangents ``do`` (and ``dlse``, the lse's, when the
    caller used it); ``window`` and ``softcap`` must be the forward's."""
    window, softcap = attn_options(window, softcap)
    _check_qkv(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[3])
    causal = causal or bool(window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, dlse,
                                         causal=causal, sm_scale=scale,
                                         window=window, softcap=softcap)
    _check_launch_args(q, k, v, out, lse, do, dlse)
    delta = _delta(out, do, dlse).contiguous()
    dq = _launch_dq(q, k, v, do, lse, delta, causal, scale, window, softcap)
    return (dq, *_launch_dkv(q, k, v, do, lse, delta, causal, scale, window,
                             softcap))


class _FlashAttention(torch.autograd.Function):
    """Forward: flash attention with its lse, saving (q, k, v, out, lse).
    Backward: ``flash_attention_bwd``, the lse cotangent folded into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, with_lse, window, softcap):
        out, lse = flash_attention(q, k, v, causal=causal, sm_scale=scale,
                                   with_lse=True, window=window,
                                   softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.window, ctx.softcap = window, softcap
        ctx.set_materialize_grads(False)
        return (out, lse) if with_lse else out

    @staticmethod
    def backward(ctx, do, dlse=None):
        q, k, v, out, lse = ctx.saved_tensors
        do = torch.zeros_like(out) if do is None else do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, dlse,
                                         causal=ctx.causal,
                                         sm_scale=ctx.scale,
                                         window=ctx.window,
                                         softcap=ctx.softcap)
        return dq, dk, dv, None, None, None, None, None


def make_flash_attention_trainable(*, causal: bool = False, sm_scale=None,
                                   window=None, softcap=None,
                                   with_lse: bool = False):
    """Differentiable flash attention (B, H, N, D) with GQA: fa(q, k, v) ->
    out, or (out, lse (B, H, N)) with ``with_lse``, whose backward consumes
    both cotangents (what trainable attention sinks need). When no input
    requires a gradient it runs the inference forward (no lse is written
    unless ``with_lse`` asks for it), as JAX's primal path does.
    ``window`` (the causal band; implies causal) and ``softcap`` go to the
    forward and to both backward kernels."""
    window, softcap = attn_options(window, softcap)
    causal = causal or bool(window)

    def fa(q, k, v):
        scale = (sm_scale if sm_scale is not None
                 else 1.0 / math.sqrt(q.shape[3]))
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashAttention.apply(q, k, v, causal, scale, with_lse,
                                         window, softcap)
        return flash_attention(q, k, v, causal=causal, sm_scale=scale,
                               with_lse=with_lse, window=window,
                               softcap=softcap)

    return fa
