"""The fused decode entry block: rms-norm -> QKV projection -> RoPE in one
kernel, and its RoPE-less variant (rms-norm -> matmul).

Counterpart of ``leetcuda_tpu/gemm/fused_decode.py``
(``make_fused_norm_qkv_rope``, ``make_fused_norm_matmul``), as plain
functions rather than ``make_*`` factories. At decode the projection is
(B, D) x (D, X) with a handful of rows: its time is the weight stream, and
the norm and the RoPE ride it instead of costing launches and activation
round trips of their own.

On CUDA tensors the wrappers launch ``csrc/fused_decode.cu`` once a call
(bf16 operands, head dim 64, 128 or 256, D % 8 == 0 and D <= 65536, X % 8
== 0) and raise on what it does not take: a cluster of C CTAs owns a panel
of 64 columns (RoPE pairs i and i + Dh/2 of one head), rank r the rows [r
kc, (r + 1) kc) of w, the ranks' f32 sums added in rank order in rank 0's
shared memory (``fused_plan``: the most ranks whose grid fits one wave of
the card, as cudaOccupancyMaxActiveClusters counts it). On CPU tensors they
run the plain versions below: the
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

from leetcuda_tpu_torch.core.runtime import (SM_COUNT, LaunchCounter, cdiv,
                                             check_launch, round_up)
from leetcuda_tpu_torch.ops.rope import apply_rope_half

FUSED_QKV = LaunchCounter("fused_norm_qkv_rope")
FUSED_NM = LaunchCounter("fused_norm_matmul")
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# lc_fused_norm_qkv_rope(x, norm_w, wqkv, positions, out, B, D, n_heads,
#                        n_kv_heads, head_dim, eps, theta, rms_offset,
#                        cluster, kc, stream)
_QKV_ARGS = (P_,) * 5 + (I_,) * 5 + (F_,) * 2 + (I_,) * 3 + (P_,)
# lc_fused_norm_matmul(x, norm_w, w, out, B, D, X, eps, rms_offset, cluster,
#                      kc, stream)
_NM_ARGS = (P_,) * 4 + (I_,) * 3 + (F_,) + (I_,) * 3 + (P_,)
# lc_fused_clusters(rope, cluster, kc, out); lc_fused_info(out)
_CLUSTERS_ARGS = (I_,) * 3 + (P_,)
_INFO_ARGS = (P_,)
# csrc/fused_decode.cu: kRowTile (rows of x a CTA), kMaxCluster, kMaxRows
# (x's rows a rank stages) and the launch bound's CTAs an SM (the wave
# where no device is asked); the package build's LC_FUSED_BOX (a panel is
# two boxes), LC_FUSED_ROWS (k rows a stage) and LC_FUSED_STAGES
ROW_TILE, MAX_CLUSTER, MAX_ROWS, CTAS_PER_SM = 8, 8, 8192, 2
BOX, STAGE_ROWS, STAGES = 32, 128, 2
_MAX_D = MAX_CLUSTER * MAX_ROWS  # the ranks' slices of D in shared memory
HEAD_DIMS = (64, 128, 256)  # the RoPE pairs of a 64-column panel


def default_wave(C: int, kc: int) -> int:
    """CTAs of one wave in clusters of C where no device is asked:
    CTAS_PER_SM an SM, whole clusters."""
    return CTAS_PER_SM * SM_COUNT // C * C


def fused_plan(B: int, D: int, X: int, wave=default_wave,
               cluster: int | None = None, box: int = BOX,
               rows: int = STAGE_ROWS) -> dict:
    """The launch of the fused block over x (B, D) and w (D, X): ``panels``
    of 2 ``box`` columns, ``tiles`` row tiles of ROW_TILE rows, each panel
    and tile owned by a cluster of C CTAs, rank r over rows [r kc, min(D,
    (r + 1) kc)) (kc a multiple of ``rows``, no rank empty, at most
    MAX_ROWS). C (``cluster`` forces it) is the largest up to MAX_CLUSTER
    whose grid fits one wave, ``wave(C, kc)`` CTAs (the device's
    cudaOccupancyMaxActiveClusters x C), so the grid never spills into a
    ragged second wave, as gemv_plan's. The panel (``box``, BOX: 32
    columns a box, pairs of columns i and i + Dh/2 of one head) and the
    stages (``rows``, STAGE_ROWS; STAGES of them) are the build's.
    bench/gemm_bench.py --fused on an NVIDIA H100 80GB HBM3 (700 W),
    device-alone ms, set them: at ModelConfig's wqkv the rule's 6 ranks
    (3 CTAs an SM) 0.0115 against 0.0162, 0.0134, 0.0118 and 0.0149 at 1,
    2, 4 and 8; at Gemma-2-9B's 2 ranks 0.0350 against 0.0393 and 0.0390 at
    1 and 4; at w_gate_up 2 ranks 0.0270, 1 0.0269. Panels of 128 columns
    (whole heads at head dim 128) against 64: 0.0121 / 0.0115, 0.0342 /
    0.0350, 0.0276 / 0.0270: a tie, and 64 takes head dim 64 too."""
    panel = 2 * box
    panels, tiles = cdiv(X, panel), cdiv(B, ROW_TILE)
    sizes = [cluster] if cluster is not None else range(MAX_CLUSTER, 0, -1)
    for C in sizes:
        kc = round_up(cdiv(D, C), rows)
        if (C > 1 and (C - 1) * kc >= D) or kc > MAX_ROWS:
            continue
        w = wave(C, kc)
        grid = panels * C * tiles
        if w < C or (cluster is None and C > 1 and grid > w):
            continue  # no cluster of C fits, or the grid outgrows a wave
        return {"panel": panel, "panels": panels, "tiles": tiles,
                "cluster": C, "kc": kc, "grid": grid, "wave": w,
                "waves": cdiv(grid, w)}
    raise ValueError(f"fused decode block: no cluster of up to "
                     f"{MAX_CLUSTER} CTAs takes D={D} (at most {MAX_ROWS} "
                     f"rows a CTA)")


def rank_rows(plan: dict, D: int) -> list[range]:
    """The rows of w each rank of a cluster sums."""
    kc = plan["kc"]
    return [range(min(D, r * kc), min(D, (r + 1) * kc))
            for r in range(plan["cluster"])]


def panel_columns(p: int, head_dim: int | None, box: int = BOX) -> list[int]:
    """The columns of panel ``p`` in the kernel's order: box 0 (c0 + [0,
    box)), then box 1 (c1 + [0, box)); c1 = c0 + head_dim / 2 with
    c0 = h head_dim + q box for the RoPE form (``head_dim``), c1 = c0 + box
    for the matmul form (None)."""
    Dh = head_dim or 2 * box
    hp = Dh // 2 // box
    c0 = p // hp * Dh + p % hp * box
    c1 = c0 + Dh // 2
    return [c0 + i for i in range(box)] + [c1 + i for i in range(box)]


_PLANS: dict = {}  # (device, lib, tiles, D, X, rope) -> plan
_INFO: dict = {}  # lib -> (box, rows, stages, max rows, max cluster)


def build_info(lib="fused_decode") -> tuple:
    """The build's constants (lc_fused_info): box columns, stage rows,
    stages, rows a rank at most, CTAs a cluster at most. The package build
    must carry BOX, STAGE_ROWS, STAGES, MAX_ROWS and MAX_CLUSTER."""
    key = lib if isinstance(lib, str) else id(lib)
    info = _INFO.get(key)
    if info is None:
        from leetcuda_tpu_torch.build import entry

        out = (ctypes.c_int * 5)()
        check_launch(entry(lib, "lc_fused_info", _INFO_ARGS)(out),
                     "fused_decode")
        info = _INFO[key] = tuple(out)
        want = (BOX, STAGE_ROWS, STAGES, MAX_ROWS, MAX_CLUSTER)
        if lib == "fused_decode" and info != want:
            raise RuntimeError(f"csrc/fused_decode.cu builds {info}, the "
                               f"wrapper plans for {want}")
    return info


def device_plan(B, D, X, rope, device, lib="fused_decode") -> dict:
    """``fused_plan`` with the device's waves (``lc_fused_clusters``) and
    the build's box and stage rows, once per device, build and shape."""
    key = (device.index, lib if isinstance(lib, str) else id(lib),
           cdiv(B, ROW_TILE), D, X, bool(rope))
    plan = _PLANS.get(key)
    if plan is None:
        from leetcuda_tpu_torch.build import entry

        box, rows = build_info(lib)[:2]
        fn = entry(lib, "lc_fused_clusters", _CLUSTERS_ARGS)

        def wave(C, kc):
            n = ctypes.c_int(0)
            check_launch(fn(int(rope), C, kc, ctypes.byref(n)),
                         "fused_decode")
            return n.value * C

        plan = _PLANS[key] = fused_plan(B, D, X, wave, box=box, rows=rows)
    return plan


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
    operands (it loads 16 bytes at a time, w by TMA), D % 8 == 0 and D <=
    _MAX_D (8 ranks of MAX_ROWS rows each), X % 8 == 0."""
    D, X = w.shape
    for name, t in dict(x=x, norm_w=norm_w, w=w).items():
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what} kernel takes bf16 operands, got "
                             f"{name} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel: {name} must be contiguous and "
                             "16-byte aligned")
    if x.shape[0] < 1 or D % 8 or D > _MAX_D or X % 8:
        raise ValueError(f"{what} kernel needs B >= 1, D % 8 == 0, D <= "
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

    _check_qkv_kernel_args(what, x, norm_w, wqkv, positions, Dh)
    return _launch_qkv(x, norm_w, wqkv, positions, H, Hkv, Dh, eps, theta,
                       rms_offset)


def _launch_qkv(x, norm_w, wqkv, positions, H, Hkv, Dh, eps, theta,
                rms_offset, plan=None, lib="fused_decode"):
    """One launch of lc_fused_norm_qkv_rope (``lib``: a variant build for
    the bench, with its ``plan``) on checked operands; counted."""
    from leetcuda_tpu_torch.build import entry

    B, D = x.shape
    X = wqkv.shape[1]
    if plan is None:
        plan = device_plan(B, D, X, True, x.device, lib)
    out = torch.empty((B, X), dtype=x.dtype, device=x.device)
    fn = entry(lib, "lc_fused_norm_qkv_rope", _QKV_ARGS)
    err = fn(x.data_ptr(), norm_w.data_ptr(), wqkv.data_ptr(),
             positions.data_ptr(), out.data_ptr(), B, D, H, Hkv, Dh,
             float(eps), float(theta), int(rms_offset), plan["cluster"],
             plan["kc"], torch.cuda.current_stream(x.device).cuda_stream)
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

    _check_kernel_operands(what, x, norm_w, w)
    return _launch_nm(x, norm_w, w, eps, rms_offset)


def _launch_nm(x, norm_w, w, eps, rms_offset, plan=None, lib="fused_decode"):
    """One launch of lc_fused_norm_matmul (``lib``: a variant build for the
    bench, with its ``plan``) on checked operands; counted."""
    from leetcuda_tpu_torch.build import entry

    B, D = x.shape
    X = w.shape[1]
    if plan is None:
        plan = device_plan(B, D, X, False, x.device, lib)
    out = torch.empty((B, X), dtype=x.dtype, device=x.device)
    fn = entry(lib, "lc_fused_norm_matmul", _NM_ARGS)
    err = fn(x.data_ptr(), norm_w.data_ptr(), w.data_ptr(), out.data_ptr(),
             B, D, X, float(eps), int(rms_offset), plan["cluster"],
             plan["kc"], torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, FUSED_NM.name)
    FUSED_NM.add()
    return out
