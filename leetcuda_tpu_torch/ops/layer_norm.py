"""Layer norm: ``(x - mean) * rsqrt(var + 1e-5) * gamma + beta`` over the
rows of (S, K), var = mean((x - mean)^2), statistics in f32; and its
backward.

Counterpart of ``leetcuda_tpu/ops/layer_norm.py`` (factories,
registrations, ``_ln_ref``, ``make_layer_norm_trainable``). On CUDA tensors
the forward launches ``lc_layer_norm_fwd`` and the backward
``lc_layer_norm_bwd`` of ``csrc/row_ops.cu``, returning new tensors; on CPU
tensors they run ``layer_norm_plain`` and ``layer_norm_bwd_plain``. The JAX
``custom_vjp`` becomes a ``torch.autograd.Function`` whose backward is the
kernel: dx from statistics recomputed from x, in x's dtype; dgamma and dbeta
summed in f32 over per-CTA partials in a fixed order (two runs agree bit for
bit), in gamma's dtype. ``rows_per_step`` is the TPU's tiling and is
accepted and ignored.
"""

from __future__ import annotations

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, cdiv
from leetcuda_tpu_torch.ops import rowwise as rw

EPS = 1e-5
LAYER_NORM = LaunchCounter("layer_norm")
LAYER_NORM_BWD = LaunchCounter("layer_norm_bwd")
# The backward's CTAs: four per SM of the H100's 132, each over a block of
# consecutive rows (its dgamma / dbeta partial is one row of nb x K f32).
BWD_CTAS = 4 * 132


def layer_norm_plain(x, gamma, beta):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + EPS)
    return (out * gamma.float() + beta.float()).to(x.dtype)


_ln_ref = layer_norm_plain


def layer_norm_bwd_plain(x, gamma, dy):
    """(dx, dgamma, dbeta) of the kernel's arithmetic: statistics from x,
    dx = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd with
    dxhat = dy * gamma; dx in x's dtype, dgamma and dbeta in gamma's."""
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + EPS)
    xhat = (xf - mean) * rstd
    dxhat = dyf * gamma.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = ((dxhat - m1 - xhat * m2) * rstd).to(x.dtype)
    return (dx, (dyf * xhat).sum(0).to(gamma.dtype),
            dyf.sum(0).to(gamma.dtype))


def _launch(x, gamma, beta, vec, pack):
    rw.check_kernel_operands("layer_norm", x, gamma, beta)
    S, K = x.shape
    out = torch.empty_like(x)
    if x.numel():
        rw.launch(LAYER_NORM, "lc_layer_norm_fwd", rw.LN_FWD_ARGS, x.device,
                  x.data_ptr(), gamma.data_ptr(), rw.DTYPES[gamma.dtype],
                  beta.data_ptr(), rw.DTYPES[beta.dtype], out.data_ptr(), S,
                  K, rw.DTYPES[x.dtype], vec,
                  rw.load_bytes(vec, pack, x.element_size()), EPS,
                  rw.threads_for(K, vec))
    return out


def layer_norm_bwd(x, gamma, dy):
    """(dx, dgamma, dbeta) of layer_norm(x, gamma, beta) for the output's
    cotangent ``dy``: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    rw.check_rows("layer_norm_bwd", x, gamma)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"layer_norm_bwd: dy must be like x "
                         f"{tuple(x.shape)}, got {tuple(dy.shape)}")
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, gamma, dy)
    rw.check_kernel_operands("layer_norm_bwd", x, gamma)
    if dy.dtype != x.dtype:
        raise ValueError(f"layer_norm_bwd kernel: dy in x's dtype {x.dtype}, "
                         f"got {dy.dtype}")
    dy = dy.contiguous()
    S, K = x.shape
    dx = torch.empty_like(x)
    dg = torch.empty_like(gamma)
    db = torch.empty_like(gamma)
    if x.numel():
        rows = cdiv(S, min(S, BWD_CTAS))
        nb = cdiv(S, rows)
        part = torch.empty((2, nb, K), dtype=torch.float32, device=x.device)
        rw.launch(LAYER_NORM_BWD, "lc_layer_norm_bwd", rw.LN_BWD_ARGS,
                  x.device, x.data_ptr(), gamma.data_ptr(),
                  rw.DTYPES[gamma.dtype], dy.data_ptr(), dx.data_ptr(),
                  part[0].data_ptr(), part[1].data_ptr(), dg.data_ptr(),
                  db.data_ptr(), S, K, rw.DTYPES[x.dtype],
                  rw.DTYPES[gamma.dtype], rows, EPS, rw.threads_for(K, 1))
    else:
        dg.zero_()
        db.zero_()
    return dx, dg, db


def make_layer_norm(*, rows_per_step: int = 8, vec: int = 8,
                    pack: bool = True):
    """layer_norm(x (S, K), gamma (K,), beta (K,)) -> (S, K) in x's dtype."""

    def fn(x, gamma, beta):
        rw.check_rows("layer_norm", x, gamma, beta)
        if x.device.type == "cpu":
            return layer_norm_plain(x, gamma, beta)
        return _launch(x, gamma, beta, vec, pack)

    return fn


def layer_norm_scalar_gb(x, g: float = 1.0, b: float = 0.0, *,
                         rows_per_step=8):
    """Reference-signature form: scalar gain and bias."""
    K = x.shape[-1]
    gamma = torch.full((K,), g, dtype=x.dtype, device=x.device)
    beta = torch.full((K,), b, dtype=x.dtype, device=x.device)
    return make_layer_norm(rows_per_step=rows_per_step)(x, gamma, beta)


def _ln_flops(x, *a):
    return float(8 * x.numel())


def _ln_bytes(x, *a):
    return float(2 * x.numel() * x.element_size())


for _suffix, _atol in [
    ("f32", 1e-5), ("f32x4", 1e-5),
    ("f16_f16", 2e-2), ("f16x2_f16", 2e-2), ("f16x8_f16", 2e-2),
    ("f16x8_pack_f16", 2e-2), ("f16x8_pack_f32", 2e-2),
    ("f16_f32", 2e-2),
]:
    register_op(
        f"layer_norm_{_suffix}",
        ref=_ln_ref, flops=_ln_flops, bytes=_ln_bytes,
        atol=_atol, rtol=1e-2, family="layer-norm", tags=(_suffix,),
    )(make_layer_norm(**rw.rung(_suffix)))

layer_norm = make_layer_norm(rows_per_step=32)


class _LayerNorm(torch.autograd.Function):
    """layer_norm with the backward kernel: saves x and gamma, as the JAX
    custom_vjp does, and recomputes the statistics in the backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, fwd):
        ctx.save_for_backward(x, gamma)
        return fwd(x, gamma, beta)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x, gamma, dy)
        return dx, dg, db, None


def make_layer_norm_trainable(*, rows_per_step: int = 32):
    """Differentiable layer_norm(x, gamma, beta) with the backward kernel."""
    fwd = make_layer_norm(rows_per_step=rows_per_step)

    def ln(x, gamma, beta):
        return _LayerNorm.apply(x, gamma, beta, fwd)

    return ln


layer_norm_trainable = make_layer_norm_trainable()
