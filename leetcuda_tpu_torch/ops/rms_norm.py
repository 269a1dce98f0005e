"""RMS norm: ``x * rsqrt(mean(x^2) + 1e-5) * w`` over the rows of (S, K),
statistics in f32, the output in x's dtype.

Counterpart of ``leetcuda_tpu/ops/rms_norm.py`` (factories, registrations,
``_rms_ref``). On CUDA tensors the wrappers launch ``lc_rms_norm`` of
``csrc/row_ops.cu`` and return a new tensor (x is never written); on CPU
tensors they run ``rms_norm_plain``. The JAX ladder's rungs become the
kernel's elements per thread (``ops/rowwise.py``); ``rows_per_step`` is the
TPU's tiling and is accepted and ignored.
"""

from __future__ import annotations

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter
from leetcuda_tpu_torch.ops import rowwise as rw

EPS = 1e-5
RMS_NORM = LaunchCounter("rms_norm")


def rms_norm_plain(x, weight):
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + EPS) * weight.float()).to(x.dtype)


_rms_ref = rms_norm_plain


def _launch(x, weight, vec, pack):
    rw.check_kernel_operands("rms_norm", x, weight)
    S, K = x.shape
    out = torch.empty_like(x)
    if x.numel():
        rw.launch(RMS_NORM, "lc_rms_norm", rw.RMS_ARGS, x.device,
                  x.data_ptr(), weight.data_ptr(), rw.DTYPES[weight.dtype],
                  out.data_ptr(), S, K, rw.DTYPES[x.dtype], vec,
                  rw.load_bytes(vec, pack, x.element_size()), EPS,
                  rw.threads_for(K, vec))
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
