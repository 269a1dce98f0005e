"""merge_attn_states: the split-KV combine of two normalised partial
attention outputs with their log-sum-exps, exact over the union of their
key ranges:

    m  = max(lse_p, lse_s)
    wp = exp(lse_p - m),  ws = exp(lse_s - m)
    out = (wp * out_p + ws * out_s) / (wp + ws)
    lse = m + log(wp + ws)

A non-finite lse (an empty key range) is weight 0 (taken as -1e30).

Counterpart of ``leetcuda_tpu/ops/merge_attn_states.py``. Layout: out (T, H,
D), any float dtype; lse (T, H), f32 in and out. The output takes the
prefix's dtype. On CUDA tensors ``merge_attn_states`` launches
``csrc/merge_attn.cu`` and returns new tensors (the prefix is never
written); on CPU tensors it runs ``merge_attn_states_plain``.
``tokens_per_step`` is the TPU's tiling and is accepted and ignored.
"""

from __future__ import annotations

import ctypes

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch

_NEG_INF = -1e30
MERGE = LaunchCounter("merge_attn_states")
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# lc_merge_attn_states(po, pl, so, sl, o, ol, T, H, D, dtype, st, sh, lt,
#                      lh, stream)
_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4
         + (ctypes.c_longlong,) * 4 + (ctypes.c_void_p,))


def merge_attn_states_plain(prefix_output, prefix_lse, suffix_output,
                            suffix_lse):
    """(out in the prefix's dtype, lse f32), in f32 as the kernel."""
    neg = torch.full((), _NEG_INF, device=prefix_lse.device)
    lse_p = torch.where(torch.isfinite(prefix_lse), prefix_lse.float(), neg)
    lse_s = torch.where(torch.isfinite(suffix_lse), suffix_lse.float(), neg)
    m = torch.maximum(lse_p, lse_s)
    wp = torch.exp(lse_p - m)
    ws = torch.exp(lse_s - m)
    denom = wp + ws
    out = (prefix_output.float() * (wp / denom)[..., None]
           + suffix_output.float() * (ws / denom)[..., None])
    return out.to(prefix_output.dtype), m + torch.log(denom)


merge_attn_states_ref = merge_attn_states_plain


def _check(po, pl, so, sl):
    if po.dim() != 3 or so.shape != po.shape:
        raise ValueError(f"merge_attn_states: outputs (T, H, D) of one shape, "
                         f"got {tuple(po.shape)}, {tuple(so.shape)}")
    if pl.shape != po.shape[:2] or sl.shape != po.shape[:2]:
        raise ValueError(f"merge_attn_states: lse (T, H) = "
                         f"{tuple(po.shape[:2])}, got {tuple(pl.shape)}, "
                         f"{tuple(sl.shape)}")
    if any(t.device != po.device for t in (pl, so, sl)):
        raise ValueError("merge_attn_states: operands must lie on one device")


def _like(src, *others):
    """A new tensor laid out as ``src`` and the operands to pass with it:
    ``src`` and ``others`` as they are where they share its strides and the
    new tensor takes them, else all contiguous."""
    out = torch.empty_like(src)
    if out.stride() == src.stride() and all(
            o.stride() == src.stride() for o in others):
        return out, (src, *others)
    return (torch.empty(src.shape, dtype=src.dtype, device=src.device),
            tuple(t.contiguous() for t in (src, *others)))


def _launch(po, pl, so, sl):
    """csrc/merge_attn.cu on the current stream. Outputs and lse may be
    strided in t and h (the flash output's token-major view); d is
    contiguous."""
    from leetcuda_tpu_torch.build import kernel

    if po.dtype not in _DTYPES or so.dtype != po.dtype:
        raise ValueError(f"merge_attn_states kernel: outputs of one dtype "
                         f"among f32, f16, bf16; got {po.dtype}, {so.dtype}")
    T, H, D = po.shape
    if po.stride(2) != 1 or so.stride(2) != 1:
        po, so = po.contiguous(), so.contiguous()
    out, (po, so) = _like(po, so)
    lse, (pl, sl) = _like(pl.float(), sl.float())
    if po.numel():
        fn = kernel("merge_attn", "lc_merge_attn_states", _ARGS)
        err = fn(po.data_ptr(), pl.data_ptr(), so.data_ptr(), sl.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), T, H, D, _DTYPES[po.dtype],
                 po.stride(0), po.stride(1), pl.stride(0), pl.stride(1),
                 torch.cuda.current_stream(po.device).cuda_stream)
        check_launch(err, MERGE.name)
        MERGE.add()
    return out, lse


def make_merge_attn_states(*, tokens_per_step: int = 1024):
    """(prefix_output, prefix_lse, suffix_output, suffix_lse) -> (out, lse).

    Shapes: out (T, H, D); lse (T, H), natural log base."""

    def fn(prefix_output, prefix_lse, suffix_output, suffix_lse):
        _check(prefix_output, prefix_lse, suffix_output, suffix_lse)
        if prefix_output.device.type == "cpu":
            return merge_attn_states_plain(prefix_output, prefix_lse,
                                           suffix_output, suffix_lse)
        return _launch(prefix_output, prefix_lse, suffix_output, suffix_lse)

    return fn


def _merge_bytes(po, pl_, so, sl):
    return float(3 * po.numel() * po.element_size())


register_op(
    "merge_attn_states",
    ref=merge_attn_states_ref, bytes=_merge_bytes,
    atol=1e-3, rtol=1e-3, family="attention-utils", tags=("merge",),
)(make_merge_attn_states())

merge_attn_states = make_merge_attn_states()
