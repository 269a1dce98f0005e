"""Batch-1 matrix-vector products: gemv and the fused rms-norm gemv.

Counterpart of ``leetcuda_tpu/gemm/gemv.py``. ``make_gemv`` returns a
function of (x (K,) or (1, K), W (K, N)) -> (1, N); ``make_rms_norm_gemv``
one of (x, norm_w (K,), W) -> (1, N) computing rms_norm(x) * norm_w @ W with
the norm in f32 (eps 1e-5). Products and sums in f32; an optional
``epilogue`` (a torch callable) is applied to the f32 sum before the one
rounding to ``out_dtype`` (default x's dtype), as the JAX kernel applies its
jnp callable inside the kernel: the CUDA kernel writes f32 and the wrapper
applies the callable and rounds.

On CUDA tensors both launch ``csrc/gemv.cu``; on CPU tensors they run the
plain versions below. The JAX ladder's rungs (k32, k128, k16: the
reference's K-tiling strategies) become the kernel's threads along K,
``k_lanes`` 32, 128 and 16, under the JAX names, tags and tolerances.
"""

from __future__ import annotations

import ctypes

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, cdiv, check_launch

GEMV = LaunchCounter("gemv")
RMS_NORM_GEMV = LaunchCounter("rms_norm_gemv")
# lc_gemv(x, w, nw, part, out, K, N, dtype, odt, k_lanes, splits, kchunk,
#         eps, stream)
_ARGS = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7
         + (ctypes.c_float, ctypes.c_void_p))
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
K_LANES = (16, 32, 128)
# The threads along K of gemv, hgemv and rms_norm_gemv: in chip_smoke.py
# path (j)'s interleaved A/B on an H100 80GB HBM3 (700 W; PERF.md),
# 32 was fastest or within 2% of the fastest at layer 0's wqkv and w_down
# and at the output projection, and 11% behind 128 at w_gate_up, where its
# wider panels need a second (split-K) pass and 128's do not.
DEFAULT_K_LANES = 32
THREADS = 256
# The wrapper splits K until the grid holds this many CTAs (two per SM of
# the H100's 132), each split at least 4 rows per K lane.
TARGET_CTAS = 2 * 132


def gemv_plain(x, w, epilogue=None, out_dtype=None):
    """(1, K) @ (K, N) in f32, the epilogue on the f32 sum, one rounding."""
    out = x.reshape(1, -1).float() @ w.float()
    if epilogue is not None:
        out = epilogue(out)
    return out.to(out_dtype or x.dtype)


def gemv_ref(x, w):
    return gemv_plain(x, w)


def rms_norm_gemv_plain(x, norm_w, w, eps=1e-5, out_dtype=None):
    """x * rsqrt(mean(x^2) + eps) * norm_w in f32, then as ``gemv_plain``."""
    xf = x.reshape(1, -1).float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xn = xf * inv * norm_w.reshape(1, -1).float()
    return (xn @ w.float()).to(out_dtype or x.dtype)


def splits_for(K: int, N: int, dtype, k_lanes: int) -> tuple[int, int]:
    """(splits, rows per split) of K for an N-column product: enough CTAs
    for ``TARGET_CTAS``, each split a multiple of ``k_lanes`` rows."""
    panel = (THREADS // k_lanes) * (16 // dtype.itemsize)
    want = cdiv(TARGET_CTAS, cdiv(N, panel))
    splits = max(1, min(want, K // (4 * k_lanes)))
    kchunk = cdiv(cdiv(K, splits), k_lanes) * k_lanes
    return cdiv(K, kchunk), kchunk


def _check(what, x, w, *more):
    if w.dim() != 2 or x.numel() != w.shape[0] or x.dim() > 2:
        raise ValueError(f"{what}: x (K,) or (1, K) and W (K, N), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise ValueError(f"{what}: x and W of one dtype among f32, f16, "
                         f"bf16; got {x.dtype}, {w.dtype}")
    if any(t.device != x.device for t in (w, *more)):
        raise ValueError(f"{what}: operands must lie on one device")


def _launch(counter, x, w, nw, k_lanes, eps, odt):
    """Launch csrc/gemv.cu on the current stream, on checked operands:
    (1, N) in ``odt``."""
    from leetcuda_tpu_torch.build import kernel

    K, N = w.shape
    vec = 16 // w.element_size()
    if N % vec:
        raise ValueError(f"{counter.name} kernel needs N % {vec} == 0 "
                         f"(16-byte rows), got N={N}")
    for name, t in (("x", x), ("W", w), ("norm_w", nw)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{counter.name} kernel: {name} must be "
                             "contiguous and 16-byte aligned")
    splits, kchunk = splits_for(K, N, w.dtype, k_lanes)
    out = torch.empty((1, N), dtype=odt, device=x.device)
    part = (torch.empty((splits, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    fn = kernel("gemv", "lc_gemv", _ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), 0 if nw is None else nw.data_ptr(),
             0 if part is None else part.data_ptr(), out.data_ptr(), K, N,
             _DTYPES[w.dtype], _DTYPES[odt], k_lanes, splits, kchunk, eps,
             torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, counter.name)
    counter.add()
    return out


def _k_lanes(k_lanes):
    if k_lanes not in K_LANES:
        raise ValueError(f"k_lanes {k_lanes} is not instantiated by "
                         f"csrc/gemv.cu; choose one of {K_LANES}")
    return k_lanes


def make_gemv(*, k_lanes: int = DEFAULT_K_LANES, epilogue=None,
              out_dtype=None):
    """gemv(x (K,) or (1, K), W (K, N)) -> (1, N)."""
    _k_lanes(k_lanes)

    def fn(x, w):
        _check("gemv", x, w)
        odt = out_dtype or x.dtype
        if x.device.type == "cpu":
            return gemv_plain(x, w, epilogue, odt)
        if epilogue is None:
            return _launch(GEMV, x.reshape(-1), w, None, k_lanes, 0.0, odt)
        out = _launch(GEMV, x.reshape(-1), w, None, k_lanes, 0.0,
                      torch.float32)
        return epilogue(out).to(odt)

    return fn


def make_rms_norm_gemv(*, eps: float = 1e-5, out_dtype=None):
    """Fused rms_norm(x, norm_w) @ W -> (1, N), the decode epilogue block,
    on the default ``k_lanes``."""

    def fn(x, norm_w, w):
        _check("rms_norm_gemv", x, w, norm_w)
        if norm_w.numel() != w.shape[0]:
            raise ValueError(f"rms_norm_gemv: norm_w must have K="
                             f"{w.shape[0]} values, got {norm_w.numel()}")
        odt = out_dtype or x.dtype
        if x.device.type == "cpu":
            return rms_norm_gemv_plain(x, norm_w, w, eps, odt)
        if norm_w.dtype != x.dtype:
            raise ValueError(f"rms_norm_gemv kernel takes norm_w in x's "
                             f"dtype {x.dtype}, got {norm_w.dtype}")
        return _launch(RMS_NORM_GEMV, x.reshape(-1), w, norm_w.reshape(-1),
                       DEFAULT_K_LANES, eps, odt)

    return fn


def _gemv_flops(x, w):
    return float(2 * w.numel())


def _gemv_bytes(x, w):
    return float(w.numel() * w.element_size())


# ladder: threads along K mirroring sgemv k32 / k128 / k16 + hgemv variants
for _name, _kl in [
    ("sgemv_k32_f32", 32),
    ("sgemv_k128_f32x4", 128),
    ("sgemv_k16_f32", 16),
    ("hgemv_k32_f16", 32),
    ("hgemv_k128_f16x4", 128),
    ("hgemv_k16_f16", 16),
]:
    register_op(
        _name, ref=gemv_ref, flops=_gemv_flops, bytes=_gemv_bytes,
        atol=3e-2, rtol=3e-2, family="gemv", tags=(_name.split("_")[1],),
    )(make_gemv(k_lanes=_kl))

gemv = make_gemv()
hgemv = gemv  # one kernel takes every dtype
rms_norm_gemv = make_rms_norm_gemv()
