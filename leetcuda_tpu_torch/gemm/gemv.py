"""Batch-1 matrix-vector products: gemv and the fused rms-norm gemv.

Counterpart of ``leetcuda_tpu/gemm/gemv.py``. ``make_gemv`` returns a
function of (x (K,) or (1, K), W (K, N)) -> (1, N); ``make_rms_norm_gemv``
one of (x, norm_w (K,), W) -> (1, N) computing rms_norm(x) * norm_w @ W with
the norm in f32 (eps 1e-5). Products and sums in f32; an optional
``epilogue`` (a torch callable) is applied to the f32 sum before the one
rounding to ``out_dtype`` (default x's dtype), as the JAX kernel applies its
jnp callable inside the kernel: the CUDA kernel writes f32 and the wrapper
applies the callable and rounds.

On CUDA tensors both make one launch of ``csrc/gemv.cu`` a call, with no
scratch: a cluster of C CTAs shares a column panel, each rank takes K / C
rows, and the ranks add their sums through distributed shared memory in
rank order inside the launch (``gemv_plan``: one CTA a panel where the
panels alone give every SM one, else the most a panel that one wave of the
card holds, as cudaOccupancyMaxActiveClusters counts it). On CPU tensors
they run the plain versions
below. The JAX ladder's rungs (k32, k128, k16: the reference's K-tiling
strategies) keep their names, tags and tolerances and map to the new
kernel's threads along K, ``k_lanes`` 32, 128 and 16 (a CTA of 256 threads
is k_lanes rows by 256 / k_lanes chunks of 16 bytes), all counted on
``gemv``.
"""

from __future__ import annotations

import ctypes

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import (SM_COUNT, LaunchCounter, cdiv,
                                             check_launch, round_up)

GEMV = LaunchCounter("gemv")
RMS_NORM_GEMV = LaunchCounter("rms_norm_gemv")
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# lc_gemv(x, w, nw, out, K, N, dtype, odt, k_lanes, cluster, kc, eps,
#         stream); lc_gemv_clusters(dtype, k_lanes, rms, cluster, kc, out)
_ARGS = (P_,) * 4 + (I_,) * 7 + (F_, P_)
_CLUSTERS_ARGS = (I_,) * 5 + (P_,)
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
K_LANES = (16, 32, 128)
# The threads along K of gemv, hgemv and rms_norm_gemv. In the A/B of
# bench/gemm_bench.py --gemv (NVIDIA H100 80GB HBM3, 700 W; PERF.md row 17)
# 16 and 32 came within 1-5% of each other at path (j)'s four shapes, each
# ahead at two, and 128 trailed by 1-70%.
DEFAULT_K_LANES = 32
# csrc/gemv.cu: kThreads, kMaxCluster, kMaxRows (x's rows a CTA stages) and
# the launch bound's CTAs an SM (the wave where no device is asked)
THREADS, MAX_CLUSTER, MAX_ROWS, CTAS_PER_SM = 256, 8, 40960, 2


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


def default_wave(C: int, kc: int) -> int:
    """CTAs of one wave in clusters of C where no device is asked:
    CTAS_PER_SM an SM, whole clusters."""
    return CTAS_PER_SM * SM_COUNT // C * C


def gemv_plan(K: int, N: int, itemsize: int, k_lanes: int = DEFAULT_K_LANES,
              wave=default_wave, cluster: int | None = None) -> dict:
    """The launch of an (K, N) gemv of ``itemsize``-byte elements: column
    panels of ``panel`` = (256 / k_lanes) (16 / itemsize) columns, each
    owned by a cluster of C CTAs, rank r over rows [r kc, min(K, (r + 1)
    kc)) (kc a multiple of k_lanes, no rank empty). C (``cluster`` forces
    it) is 1 where the panels alone give every SM a CTA, else the largest
    up to 8 whose grid fits one wave, ``wave(C, kc)`` CTAs (the device's
    cudaOccupancyMaxActiveClusters x C), so the grid never spills into a
    ragged second wave. bench/gemm_bench.py --gemv on an NVIDIA H100 80GB
    HBM3 (700 W) set the rule: one CTA a panel won at w_gate_up (176
    panels: 0.0244 ms against 0.0255 at 2 and 0.0308 at 4 a panel) and the
    output projection (500: 0.0534-0.0559 against 0.0603 at 2); at wqkv
    and w_down (48 and 32 panels) 8 a panel won (0.0136 and 0.0182 ms
    against 0.0165 and 0.0332 at 1)."""
    panel = (THREADS // k_lanes) * (16 // itemsize)
    panels = cdiv(N, panel)
    if cluster is not None:
        sizes = [cluster]
    elif panels >= SM_COUNT:
        sizes = [1]
    else:
        sizes = range(MAX_CLUSTER, 0, -1)
    for C in sizes:
        kc = round_up(cdiv(K, C), k_lanes)
        if (C > 1 and (C - 1) * kc >= K) or kc > MAX_ROWS:
            continue
        w = wave(C, kc)
        if w < C or (cluster is None and C > 1 and panels * C > w):
            continue  # no cluster of C fits, or the grid outgrows a wave
        return {"panel": panel, "panels": panels, "cluster": C, "kc": kc,
                "grid": panels * C, "wave": w,
                "waves": cdiv(panels * C, w)}
    raise ValueError(f"gemv: no cluster of up to {MAX_CLUSTER} CTAs takes "
                     f"K={K} (at most {MAX_ROWS} rows a CTA)")


def rank_rows(plan: dict, K: int) -> list[range]:
    """The rows of W each rank of a cluster sums."""
    kc = plan["kc"]
    return [range(min(K, r * kc), min(K, (r + 1) * kc))
            for r in range(plan["cluster"])]


_PLANS: dict = {}  # (device, K, N, dtype, k_lanes, rms) -> plan


def device_plan(K, N, dtype, k_lanes, rms, device) -> dict:
    """``gemv_plan`` with the device's waves (``lc_gemv_clusters``), once
    per device and shape."""
    key = (device.index, K, N, dtype, k_lanes, rms)
    plan = _PLANS.get(key)
    if plan is None:
        from leetcuda_tpu_torch.build import kernel

        fn = kernel("gemv", "lc_gemv_clusters", _CLUSTERS_ARGS)

        def wave(C, kc):
            n = ctypes.c_int(0)
            check_launch(fn(_DTYPES[dtype], k_lanes, int(rms), C, kc,
                            ctypes.byref(n)), "gemv")
            return n.value * C

        plan = _PLANS[key] = gemv_plan(K, N, dtype.itemsize, k_lanes, wave)
    return plan


def _check(what, x, w, *more):
    if w.dim() != 2 or x.numel() != w.shape[0] or x.dim() > 2:
        raise ValueError(f"{what}: x (K,) or (1, K) and W (K, N), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise ValueError(f"{what}: x and W of one dtype among f32, f16, "
                         f"bf16; got {x.dtype}, {w.dtype}")
    if any(t.device != x.device for t in (w, *more)):
        raise ValueError(f"{what}: operands must lie on one device")


def _launch(counter, x, w, nw, k_lanes, eps, odt, plan=None, lib="gemv"):
    """Launch csrc/gemv.cu (or a variant build ``lib``) once on the current
    stream, on checked operands: (1, N) in ``odt``."""
    from leetcuda_tpu_torch.build import entry

    K, N = w.shape
    vec = 16 // w.element_size()
    if N % vec:
        raise ValueError(f"{counter.name} kernel needs N % {vec} == 0 "
                         f"(16-byte rows), got N={N}")
    for name, t in (("x", x), ("W", w), ("norm_w", nw)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{counter.name} kernel: {name} must be "
                             "contiguous and 16-byte aligned")
    if plan is None:
        plan = device_plan(K, N, w.dtype, k_lanes, nw is not None, x.device)
    out = torch.empty((1, N), dtype=odt, device=x.device)
    fn = entry(lib, "lc_gemv", _ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), 0 if nw is None else nw.data_ptr(),
             out.data_ptr(), K, N, _DTYPES[w.dtype], _DTYPES[odt], k_lanes,
             plan["cluster"], plan["kc"], eps,
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
