"""The fused decode entry block: rms-norm -> QKV projection -> RoPE in one
kernel, and its RoPE-less variant (rms-norm -> matmul).

Counterpart of ``leetcuda_tpu/gemm/fused_decode.py``
(``make_fused_norm_qkv_rope``, ``make_fused_norm_matmul``), as plain
functions rather than ``make_*`` factories. At decode the projection is
(B, D) x (D, X) with a handful of rows: its time is the weight stream, and
the norm and the RoPE ride it instead of costing launches and activation
round trips of their own.

On CUDA tensors the wrappers launch ``csrc/fused_decode.cu`` (bf16
operands, head dim 64, 128 or 256, D % 16 == 0 and D <= 6144) and raise on
what it does not take. On CPU tensors they run the plain versions below: the
unfused composition with the kernel's roundings, which are the model's own
(``models/llama.py`` ``_rms_norm``, the activation-dtype product,
``ops/rope.py`` ``apply_rope_half``): the normalised x is cast to the
activation dtype before the norm weight multiplies it, the product is cast
before the RoPE, the RoPE runs in f32 and is cast again. The JAX package's
``fused_norm_qkv_rope_ref`` rounds the normalised x once instead of twice;
in f32 the two are the same function.

The JAX model gates its fused block on the cache capacity, a TPU
measurement, and on an environment switch; the port has neither
(``models/llama.py`` ``decode_step``).
"""

from __future__ import annotations

import ctypes

import torch

from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch
from leetcuda_tpu_torch.ops.rope import apply_rope_half

FUSED_QKV = LaunchCounter("fused_norm_qkv_rope")
FUSED_NM = LaunchCounter("fused_norm_matmul")
# lc_fused_norm_qkv_rope(x, norm_w, wqkv, positions, out, B, D, n_heads,
#                        n_kv_heads, head_dim, eps, theta, rms_offset, stream)
_QKV_ARGS = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5
             + (ctypes.c_float,) * 2 + (ctypes.c_int, ctypes.c_void_p))
# lc_fused_norm_matmul(x, norm_w, w, out, B, D, X, eps, rms_offset, stream)
_NM_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3
            + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
_MAX_D = 6144  # the kernel keeps 16 normalised rows in shared memory
HEAD_DIMS = (64, 128, 256)  # whole heads in the kernel's column panel


def _norm_plain(x, norm_w, eps, rms_offset):
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    xhat = (xf * torch.rsqrt(ms + eps)).to(x.dtype)
    if rms_offset:
        return xhat * (1.0 + norm_w.float()).to(x.dtype)
    return xhat * norm_w


def fused_norm_matmul_plain(x, norm_w, w, *, eps=1e-5, rms_offset=False):
    """Plain PyTorch version: rms-norm, then the product in x's dtype."""
    return _norm_plain(x, norm_w, eps, rms_offset) @ w


def fused_norm_qkv_rope_plain(x, norm_w, wqkv, positions, *, n_heads,
                              n_kv_heads, head_dim, eps=1e-5, theta=10000.0,
                              rms_offset=False):
    """Plain PyTorch version: rms-norm, the QKV product, half-rotation RoPE
    on the q and k columns."""
    H, Hkv, Dh = n_heads, n_kv_heads, head_dim
    B = x.shape[0]
    out = fused_norm_matmul_plain(x, norm_w, wqkv, eps=eps,
                                  rms_offset=rms_offset)
    qk, v = out[:, :(H + Hkv) * Dh], out[:, (H + Hkv) * Dh:]
    qk = apply_rope_half(qk.reshape(B, 1, H + Hkv, Dh), positions[:, None],
                         theta).reshape(B, (H + Hkv) * Dh)
    return torch.cat([qk, v], dim=-1)


def _check(what, x, norm_w, w):
    """Shapes and devices both wrappers check."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] \
            or norm_w.shape != (x.shape[1],):
        raise ValueError(f"{what}: x (B, D), norm_w (D,), w (D, X): got "
                         f"{tuple(x.shape)}, {tuple(norm_w.shape)}, "
                         f"{tuple(w.shape)}")
    if not (x.device == norm_w.device == w.device):
        raise ValueError(f"{what}: x, norm_w and w must lie on one device")


def _check_kernel_operands(what, x, norm_w, w):
    """What the CUDA kernel takes: bf16, contiguous, 16-byte aligned
    operands (it loads 16 bytes at a time), D % 16 == 0 and D <= 6144,
    X % 8 == 0."""
    D, X = w.shape
    for name, t in dict(x=x, norm_w=norm_w, w=w).items():
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what} kernel takes bf16 operands, got "
                             f"{name} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel: {name} must be contiguous and "
                             "16-byte aligned")
    if x.shape[0] < 1 or D % 16 or D > _MAX_D or X % 8:
        raise ValueError(f"{what} kernel needs B >= 1, D % 16 == 0, D <= "
                         f"{_MAX_D} and X % 8 == 0; got B={x.shape[0]}, "
                         f"D={D}, X={X}")


def _check_qkv_kernel_args(what, x, norm_w, wqkv, positions, head_dim):
    """What the norm->QKV->RoPE kernel takes beyond
    ``_check_kernel_operands``: contiguous int32 positions and a head dim
    of HEAD_DIMS."""
    _check_kernel_operands(what, x, norm_w, wqkv)
    if positions.dtype != torch.int32 or not positions.is_contiguous() \
            or head_dim not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes contiguous int32 positions "
                         f"and a head dim of {HEAD_DIMS}, got "
                         f"{positions.dtype}, {head_dim}")


def fused_norm_qkv_rope(x, norm_w, wqkv, positions, *, n_heads, n_kv_heads,
                        head_dim, eps=1e-5, theta=10000.0, rms_offset=False):
    """rope(rms_norm(x, norm_w) @ wqkv): x (B, D), norm_w (D,), wqkv (D, X)
    with X = (H + 2 Hkv) Dh, positions (B,) int -> (B, X) in x's dtype, RoPE
    applied to the q | k columns (the first (H + Hkv) Dh)."""
    what = "fused_norm_qkv_rope"
    _check(what, x, norm_w, wqkv)
    H, Hkv, Dh = n_heads, n_kv_heads, head_dim
    if wqkv.shape[1] != (H + 2 * Hkv) * Dh or Dh % 2:
        raise ValueError(f"{what}: wqkv has {wqkv.shape[1]} columns, not "
                         f"(H + 2 Hkv) Dh = {(H + 2 * Hkv) * Dh}")
    if positions.shape != (x.shape[0],) or positions.is_floating_point() \
            or positions.device != x.device:
        raise ValueError(f"{what}: positions must be (B,) integers on x's "
                         f"device, got {tuple(positions.shape)} "
                         f"{positions.dtype} on {positions.device}")
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=Dh, eps=eps, theta=theta,
              rms_offset=rms_offset)
    if x.device.type == "cpu":
        return fused_norm_qkv_rope_plain(x, norm_w, wqkv, positions, **kw)

    from leetcuda_tpu_torch.build import kernel

    _check_qkv_kernel_args(what, x, norm_w, wqkv, positions, Dh)
    B, D = x.shape
    out = torch.empty((B, wqkv.shape[1]), dtype=x.dtype, device=x.device)
    fn = kernel("fused_decode", "lc_fused_norm_qkv_rope", _QKV_ARGS)
    err = fn(x.data_ptr(), norm_w.data_ptr(), wqkv.data_ptr(),
             positions.data_ptr(), out.data_ptr(), B, D, H, Hkv, Dh,
             float(eps), float(theta), int(rms_offset),
             torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, FUSED_QKV.name)
    FUSED_QKV.add()
    return out


def fused_norm_matmul(x, norm_w, w, *, eps=1e-5, rms_offset=False):
    """rms_norm(x, norm_w) @ w: x (B, D), norm_w (D,), w (D, X) -> (B, X) in
    x's dtype (the MLP entry: norm -> w_gate_up)."""
    what = "fused_norm_matmul"
    _check(what, x, norm_w, w)
    if x.device.type == "cpu":
        return fused_norm_matmul_plain(x, norm_w, w, eps=eps,
                                       rms_offset=rms_offset)

    from leetcuda_tpu_torch.build import kernel

    _check_kernel_operands(what, x, norm_w, w)
    B, D = x.shape
    X = w.shape[1]
    out = torch.empty((B, X), dtype=x.dtype, device=x.device)
    fn = kernel("fused_decode", "lc_fused_norm_matmul", _NM_ARGS)
    err = fn(x.data_ptr(), norm_w.data_ptr(), w.data_ptr(), out.data_ptr(),
             B, D, X, float(eps), int(rms_offset),
             torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, FUSED_NM.name)
    FUSED_NM.add()
    return out
