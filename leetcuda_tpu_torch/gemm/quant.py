"""Weight-only quantized matmuls (w8a16, w4a16) and the weight quantizers.

Counterpart of ``leetcuda_tpu/gemm/quant.py``, as plain functions rather
than ``make_*`` factories. The quantizers produce the JAX package's packs
byte for byte (``torch.round`` rounds half to even like ``jnp.round``; the
f32 -> e4m3 cast rounds to nearest even in both), so packs move between the
two packages unchanged:

- int8 / e4m3: ``{"q": (K, N) int8 or float8_e4m3fn, "s": (N,) f32}``, one
  symmetric scale per output column;
- int4: ``{"q4": (K/2, N) int8, "s4": (K/group, N) f32}``, SPLIT-HALVES:
  byte i holds row i in the low nibble, biased by +8, and row i + K/2 in
  the high nibble, two's complement.

On CUDA tensors ``matmul_w8a16`` and ``matmul_w4a16`` launch the kernels in
``csrc/wq_matmul.cu`` and ``csrc/w4_matmul.cu`` (bf16 activations) and
raise on what those do not take. On CPU tensors they run the plain versions
below, which follow the kernels' order of rounding: f32 products of the
exact weight values, the scale applied in f32 (once per column for w8a16,
once per group for w4a16), one rounding to the activation dtype.

The JAX package picks f32 or bf16 dots by row count and has an fp8
bit-surgery variant; on bf16 activations these compute one function (the
weights and x convert exactly), so the port has one kernel per pack format,
and the six registered w8a16 / w4a16 rungs go to those two functions.

``make_matmul_i8i8i32`` is the exact int8 x int8 -> int32 matmul
(``csrc/i8_matmul.cu`` on CUDA tensors, registered as ``hgemm_w8a8_i32``).
"""

from __future__ import annotations

import ctypes

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch

W8A16 = LaunchCounter("matmul_w8a16")
W4A16 = LaunchCounter("matmul_w4a16")
I8I8I32 = LaunchCounter("matmul_i8i8i32")
# lc_wq_matmul_bf16(x, w, s, out, M, N, K, fp8, decode_tile, stream)
_W8A16_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
# lc_w4_matmul_bf16(x, packed, scales, out, M, N, K, decode_tile, stream)
_W4A16_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
# lc_i8_matmul(x, w, out, M, N, K, stream)
_I8_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)

# Each kernel has two tilings: a decode tiling (16-row CTA tiles, 128-deep
# k steps: many CTAs for a few rows) and a prefill tiling (64-row tiles,
# 32-deep steps: each staged tile reused over more rows). The wrappers take
# the decode tiling up to this many rows. chip_smoke.py times both at every
# matmul shape of its main paths and at 16-128 rows; on an H100 80GB HBM3
# (700 W) the decode tiling won every shape of both kernels up to 64 rows
# and a layer's matmuls in sum at 128, the prefill tiling a layer's sum
# at 384 rows and every shape at 1024 and 12288 (PERF.md).
DECODE_TILE_MAX_ROWS = 128

_E4M3 = torch.float8_e4m3fn


def quantize_rowwise_int8(w, axis: int = 0):
    """Symmetric per-channel int8 quantization of w (K, N) along ``axis``:
    (w_q int8, scale f32 per output column)."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w_q, scale.reshape(-1)


def quantize_rowwise_fp8(w, axis: int = 0):
    """Per-channel e4m3 quantization, max-scaled to the e4m3 range +-448."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 448.0
    return (wf / scale).to(_E4M3), scale.reshape(-1)


def quantize_groupwise_int4(w, group: int = 128):
    """Symmetric int4 quantization of w (K, N) with per-(K-group, column)
    scales: (packed (K/2, N) int8, scales (K/group, N) f32), split-halves
    packing as the module docstring says."""
    K, N = w.shape
    if K % (2 * group):
        raise ValueError(f"int4 packing needs K % {2 * group} == 0, got K={K}")
    g = w.float().reshape(K // group, group, N)
    amax = g.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(g / scale), -7, 7).to(torch.int8).reshape(K, N)
    lo = (q[:K // 2] + 8) & 0xF
    hi = q[K // 2:] << 4
    return lo | hi, scale[:, 0, :]


def _unpack_int4(packed):
    """(K/2, N) packed bytes -> (low rows, high rows) as int8 values."""
    return (packed & 0xF) - 8, packed >> 4  # >> is arithmetic on int8


def dequantize_int4(packed, scales, group: int = 128):
    """Inverse of ``quantize_groupwise_int4``: (K, N) f32."""
    lo, hi = _unpack_int4(packed)
    q = torch.cat([lo, hi], dim=0).float()
    return q * torch.repeat_interleave(scales.float(), group, dim=0)


# --- plain versions -----------------------------------------------------------

def matmul_w8a16_plain(x, q, s):
    """(x @ q) in f32, times the per-column scale, one rounding to x's
    dtype. fp8 weights upcast with ``.float()`` (exact)."""
    return ((x.float() @ q.float()) * s.float()).to(x.dtype)


def matmul_w4a16_plain(x, packed, scales, group: int = 128):
    """Per group g of packed rows: a = x_lo_g @ lo_g and b = x_hi_g @ hi_g in
    f32, accumulated as a * s[g] + b * s[g + K/(2*group)] (the scale folds
    past each group's dot, as the TPU kernel does); one rounding at the end."""
    M, K = x.shape
    lo, hi = _unpack_int4(packed)
    half_groups = (K // 2) // group
    xf, sf = x.float(), scales.float()
    acc = torch.zeros(M, packed.shape[1], dtype=torch.float32,
                      device=x.device)
    for g in range(half_groups):
        r = slice(g * group, (g + 1) * group)
        a = xf[:, g * group:(g + 1) * group] @ lo[r].float()
        b = xf[:, K // 2 + g * group:K // 2 + (g + 1) * group] @ hi[r].float()
        acc = acc + (a * sf[g] + b * sf[g + half_groups])
    return acc.to(x.dtype)


# --- wrappers -----------------------------------------------------------------

def _check_x(x, K, what):
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"{what}: x must be (M, {K}), got {tuple(x.shape)}")


def _check_kernel_operands(what, x, **tensors):
    """What both kernels take: bf16 activations, and contiguous, 16-byte
    aligned operands (the kernels load 16 bytes at a time)."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what} kernel takes bf16 activations, got {x.dtype}")
    for name, t in dict(x=x, **tensors).items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel: {name} must be contiguous and "
                             "16-byte aligned")


def _launch_w8a16(x, q, s, decode_tile: bool):
    """Launch csrc/wq_matmul.cu on the current stream, in the decode or the
    prefill tiling, on operands the wrapper has checked."""
    from leetcuda_tpu_torch.build import kernel

    M, (K, N) = x.shape[0], q.shape
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = kernel("wq_matmul", "lc_wq_matmul_bf16", _W8A16_ARGS)
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, N,
             K, int(q.dtype == _E4M3), int(decode_tile),
             torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, W8A16.name)
    W8A16.add()
    return out


def _launch_w4a16(x, packed, scales, decode_tile: bool):
    """Launch csrc/w4_matmul.cu on the current stream, in the decode or the
    prefill tiling, on operands the wrapper has checked."""
    from leetcuda_tpu_torch.build import kernel

    M, N = x.shape[0], packed.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = kernel("w4_matmul", "lc_w4_matmul_bf16", _W4A16_ARGS)
    err = fn(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
             out.data_ptr(), M, N, x.shape[1], int(decode_tile),
             torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, W4A16.name)
    W4A16.add()
    return out


def matmul_w8a16(x, q, s):
    """x (M, K) @ dequant(q (K, N) int8 or float8_e4m3fn, s (N,) f32) ->
    (M, N) in x's dtype."""
    if q.dim() != 2 or s.shape != (q.shape[1],):
        raise ValueError(f"w8a16: q (K, N) and s (N,), got {tuple(q.shape)}, "
                         f"{tuple(s.shape)}")
    if q.dtype not in (torch.int8, _E4M3):
        raise ValueError(f"w8a16: weights must be int8 or e4m3, got {q.dtype}")
    K, N = q.shape
    _check_x(x, K, "w8a16")
    if not (x.device == q.device == s.device):
        raise ValueError("w8a16: x, q and s must lie on one device")
    if x.device.type == "cpu":
        return matmul_w8a16_plain(x, q, s)

    if s.dtype != torch.float32:
        raise ValueError(f"w8a16 kernel takes f32 scales, got {s.dtype}")
    if K % 32 or N % 8:
        raise ValueError(f"w8a16 kernel needs K % 32 == 0 and N % 8 == 0, "
                         f"got K={K}, N={N}")
    _check_kernel_operands("w8a16", x, q=q, s=s)
    return _launch_w8a16(x, q, s, x.shape[0] <= DECODE_TILE_MAX_ROWS)


def matmul_w4a16(x, packed, scales, group: int = 128):
    """x (M, K) @ dequant(packed (K/2, N) int8, scales (K/group, N) f32) ->
    (M, N) in x's dtype."""
    if packed.dim() != 2 or packed.dtype != torch.int8:
        raise ValueError(f"w4a16: packed must be (K/2, N) int8, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    Kh, N = packed.shape
    K = 2 * Kh
    _check_x(x, K, "w4a16")
    if K % (2 * group) or scales.shape != (K // group, N):
        raise ValueError(f"w4a16: K={K} must be a multiple of {2 * group} "
                         f"and scales ({K // group}, {N}), got "
                         f"{tuple(scales.shape)}")
    if not (x.device == packed.device == scales.device):
        raise ValueError("w4a16: x, packed and scales must lie on one device")
    if x.device.type == "cpu":
        return matmul_w4a16_plain(x, packed, scales, group)

    if group != 128 or scales.dtype != torch.float32 or N % 8:
        raise ValueError(f"w4a16 kernel takes group 128, f32 scales and "
                         f"N % 8 == 0; got group {group}, {scales.dtype}, "
                         f"N={N}")
    _check_kernel_operands("w4a16", x, packed=packed, scales=scales)
    return _launch_w4a16(x, packed, scales,
                         x.shape[0] <= DECODE_TILE_MAX_ROWS)


# --- int8 x int8 -> int32 -----------------------------------------------------

def matmul_i8i8i32_plain(x, w):
    """The exact int product. On the CPU in int32; on the GPU, where
    ``torch.matmul`` takes no integers, as an f64 product of the int values,
    exact while K * 127^2 < 2^53, rounded to int32."""
    if x.device.type == "cpu":
        return x.int() @ w.int()
    return torch.round(x.double() @ w.double()).to(torch.int32)


def make_matmul_i8i8i32():
    """x (M, K) int8 @ w (K, N) int8 -> (M, N) int32, exact. The kernel
    takes any M, and K and N that are multiples of 16 (16-byte rows). Its
    one tile is 128 x 128 x 64, so the JAX factory's ``block`` (a TPU VMEM
    tile) is not taken."""

    def fn(x, w):
        if (x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]
                or x.dtype != torch.int8 or w.dtype != torch.int8):
            raise ValueError(f"i8 matmul: int8 x (M, K) and w (K, N), got "
                             f"{x.dtype} {tuple(x.shape)}, {w.dtype} "
                             f"{tuple(w.shape)}")
        if x.device != w.device:
            raise ValueError("i8 matmul: x and w must lie on one device")
        (M, K), N = x.shape, w.shape[1]
        if K % 16 or N % 16:
            raise ValueError(f"i8 matmul needs K % 16 == 0 and N % 16 == 0 "
                             f"(16-byte rows), got K={K}, N={N}")
        if x.device.type == "cpu":
            return matmul_i8i8i32_plain(x, w)
        for name, t in (("x", x), ("w", w)):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"i8 matmul kernel: {name} must be "
                                 "contiguous and 16-byte aligned")
        from leetcuda_tpu_torch.build import kernel

        out = torch.empty((M, N), dtype=torch.int32, device=x.device)
        err = kernel("i8_matmul", "lc_i8_matmul", _I8_ARGS)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
            torch.cuda.current_stream(x.device).cuda_stream)
        check_launch(err, I8I8I32.name)
        I8I8I32.add()
        return out

    return fn


matmul_i8i8i32 = make_matmul_i8i8i32()


# --- the registered gemm-quant rungs (the JAX names, tags and tolerances) ----

def _wq_flops(x, w_q, *_):
    return float(2 * x.shape[0] * x.shape[1] * w_q.shape[1])


for _name, _plain, _fn, _tol, _tags in (
        ("hgemm_w8a16_dequant", matmul_w8a16_plain, matmul_w8a16, 5e-2,
         ("int8", "weight-only")),
        ("hgemm_w8a16_dequant_fp8", matmul_w8a16_plain, matmul_w8a16, 8e-2,
         ("fp8", "weight-only")),
        ("hgemm_w8a16_dequant_fp8_bits", matmul_w8a16_plain, matmul_w8a16,
         8e-2, ("fp8", "weight-only", "bits-decode", "f32-dots")),
        ("hgemm_w8a8_i32", matmul_i8i8i32_plain, matmul_i8i8i32, 0,
         ("int8", "a8w8")),
        ("hgemm_w4a16_dequant", matmul_w4a16_plain, matmul_w4a16, 5e-2,
         ("int4", "weight-only")),
        ("hgemm_w4a16_dequant_bits", matmul_w4a16_plain, matmul_w4a16, 5e-2,
         ("int4", "weight-only", "bits-unpack")),
        ("hgemm_w4a16_dequant_floor_f32", matmul_w4a16_plain, matmul_w4a16,
         5e-2, ("int4", "weight-only", "floor-unpack", "f32-dots"))):
    register_op(_name, ref=_plain, flops=_wq_flops, atol=_tol, rtol=_tol,
                family="gemm-quant", tags=_tags)(_fn)
