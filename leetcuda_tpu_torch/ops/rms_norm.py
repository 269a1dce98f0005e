"""RMS norm: ``x * rsqrt(mean(x^2) + 1e-5) * w`` over the rows of (S, K),
statistics in f32, the output in x's dtype.

Counterpart of ``leetcuda_tpu/ops/rms_norm.py`` (factories, registrations,
``_rms_ref``). On CUDA tensors the wrappers launch one of two routes of
``csrc/row_ops.cu`` (``rms_plan``) and return a new tensor (x is never
written): ``rows`` (``lc_rms_norm_rows``: the layer norm's rows route with
one reduction a row, w in registers, the row read once into registers, K
a multiple of 8 up to 4096 and 16-byte aligned rows; counted on
``rms_norm``) or ``block`` (``lc_rms_norm``: every other K or alignment,
a CTA a row; counted on ``rms_norm_block``). On CPU tensors they run
``rms_norm_plain``. A rung's ``vec`` and ``pack`` set the width of the
rows route's loads (``rowwise.load_bytes``); the block route walks in
``vec`` steps (``ops/rowwise.py``). ``rows_per_step`` is the TPU's tiling
and is accepted and ignored.
"""

from __future__ import annotations

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter
from leetcuda_tpu_torch.ops import layer_norm as ln
from leetcuda_tpu_torch.ops import rowwise as rw

EPS = 1e-5
RMS_NORM = LaunchCounter("rms_norm")  # the rows route
RMS_NORM_BLOCK = LaunchCounter("rms_norm_block")  # the block route


def rms_norm_plain(x, weight):
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + EPS) * weight.float()).to(x.dtype)


_rms_ref = rms_norm_plain


def rms_plan(S: int, K: int, itemsize: int = 2,
             aligned: bool = True) -> dict:
    """What csrc/row_ops.cu runs for an (S, K) rms-norm of
    ``itemsize``-byte elements: the layer norm's forward plan
    (``layer_norm.ln_fwd_plan``: the ``rows`` route where K is a multiple
    of 8 up to 4096 and x and the output are 16-byte aligned, the group a
    row, the persistent grid; else ``block``, a CTA a row) with one weight
    vector in a thread's state, so ``fwd_ctas`` gives the layer norm's cap
    of 4 CTAs an SM but for f32 rows past 2048 columns (3).
    bench/gemm_bench.py --rms on an NVIDIA H100 80GB HBM3 (700 W), device
    alone, kept that cap: at (16384, 2048) bf16 4 CTAs an SM took 0.0513
    ms against 0.0535 and 0.0524 at 6 and 8 (variant builds of
    LC_LN_MAX_CTAS), 0.0547 at 3 and 0.0596 at 2; f32 0.1049 against
    0.1279 at 6; at (16384, 4096) bf16 0.0983 against 0.1135. Groups of 4
    warps (2 vectors a thread) tied 8 at 2048 columns (0.0510)."""
    return ln.ln_fwd_plan(S, K, itemsize, aligned, weights=1)


def _launch(x, weight, vec, pack):
    rw.check_kernel_operands("rms_norm", x, weight)
    out = torch.empty_like(x)
    if x.numel():
        aligned = (x.data_ptr() | out.data_ptr()) % 16 == 0
        _run(x, weight, out, vec, pack, rms_plan(
            x.shape[0], x.shape[1], x.element_size(), aligned))
    return out


def _run(x, weight, out, vec, pack, plan, lib="row_ops"):
    """Launch ``plan``'s route into ``out`` (checked, non-empty operands;
    ``lib``: a variant build for the bench) and count it."""
    S, K = x.shape
    ptrs = (x.data_ptr(), weight.data_ptr(), rw.DTYPES[weight.dtype],
            out.data_ptr(), S, K, rw.DTYPES[x.dtype])
    lb = rw.load_bytes(vec, pack, x.element_size())
    if plan["route"] == "rows":
        rw.launch(RMS_NORM, "lc_rms_norm_rows", rw.RMS_ROWS_ARGS, x.device,
                  *ptrs, lb, plan["group"], plan["grid"], EPS, source=lib)
    else:
        rw.launch(RMS_NORM_BLOCK, "lc_rms_norm", rw.RMS_ARGS, x.device,
                  *ptrs, vec, lb, EPS, rw.threads_for(K, vec), source=lib)
    return out


def make_rms_norm(*, rows_per_step: int = 8, vec: int = 8,
                  pack: bool = True):
    """rms_norm(x (S, K), weight (K,)) -> (S, K) in x's dtype."""

    def fn(x, weight):
        rw.check_rows("rms_norm", x, weight)
        if x.device.type == "cpu":
            return rms_norm_plain(x, weight)
        return _launch(x, weight, vec, pack)

    return fn


def rms_norm_scalar_g(x, g: float = 1.0, *, rows_per_step=8):
    """Reference-signature form: one scalar gain."""
    w = torch.full((x.shape[-1],), g, dtype=x.dtype, device=x.device)
    return make_rms_norm(rows_per_step=rows_per_step)(x, w)


def _rms_flops(x, *a):
    return float(4 * x.numel())


def _rms_bytes(x, *a):
    return float(2 * x.numel() * x.element_size())


for _suffix, _atol in [
    ("f32", 1e-5), ("f32x4", 1e-5),
    ("f16_f16", 2e-2), ("f16x2_f16", 2e-2), ("f16x8_f16", 2e-2),
    ("f16x8_f32", 2e-2), ("f16x8_pack_f16", 2e-2),
    ("f16x8_pack_f32", 2e-2), ("f16_f32", 2e-2),
]:
    register_op(
        f"rms_norm_{_suffix}",
        ref=_rms_ref, flops=_rms_flops, bytes=_rms_bytes,
        atol=_atol, rtol=1e-2, family="rms-norm", tags=(_suffix,),
    )(make_rms_norm(**rw.rung(_suffix)))

rms_norm = make_rms_norm(rows_per_step=32)
