"""Dense matmul library: the sgemm / hgemm ladder and ``matmul_auto``.

Counterpart of ``leetcuda_tpu/gemm/matmul.py``. ``make_matmul`` returns a
function of (x, y): layout "nn" computes x (M, K) @ y (K, N), layout "tn"
x (M, K) @ y (N, K)^T, summed in f32 and rounded once to ``out_dtype``
(default x's dtype), for f32, f16 and bf16 and any M, N, K.

On CUDA tensors it launches ``csrc/matmul.cu``; on CPU tensors it runs the
plain version, ``(x.float() @ y.float()).to(out)``. ``block`` selects one of
the instantiations the source compiles (``BLOCKS``): CUDA-core tiles, which
take every dtype, and tensor-core tiles (mma.sync), which take f16 and bf16.
The JAX package's blocks are TPU VMEM tiles (up to 2048 x 2048 x 512) and do
not carry over; each of the 12 registered rungs is an instantiation of the
port's own choosing, under the JAX name, family, tags and tolerance.
``swizzle_group`` walks the output tiles ``group`` tile-columns at a time,
as the JAX ``_swizzled_ij`` does (L2 reuse of the B panels on the GPU).
``vmem_limit_mb`` is TPU-only and not taken.

``make_matmul_resident`` is the chain A <- cast(A @ B), ``reps`` times in
one launch of ``lc_matmul_resident`` (the same source), a CTA owning a
block of ``RESIDENT_ROWS`` rows for every rep; ``block_m`` and
``vmem_limit_mb`` are the TPU's tiling and are accepted and ignored.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, cdiv, check_launch

MATMUL = LaunchCounter("matmul")
MATMUL_RESIDENT = LaunchCounter("matmul_resident")
# lc_matmul(x, y, out, M, N, K, dtype, odt, tn, config, group, stream)
_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# lc_matmul_resident(a, b, out, scratch, M, N, reps, dtype, stream)
_RES_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
RESIDENT_ROWS = 64  # csrc/matmul.cu TcRes::BM, kResRows: rows of a CTA

# (BM, BN, BK) -> (the source's config id, datapath). CUDA cores: one thread
# per output with BK 1 (naive), or shared-memory tiles with a register block
# per thread (32^2 x 32: 2x2; 128^2 x 8: 8x8; 128^2 x 16: 8x8 double-
# buffered). Tensor cores: mma.sync m16n8k16 over 32-deep cp.async stages.
BLOCKS = {
    (16, 16, 1): (0, "cuda-core"),
    (32, 32, 32): (1, "cuda-core"),
    (128, 128, 8): (2, "cuda-core"),
    (128, 128, 16): (3, "cuda-core"),
    (64, 64, 32): (4, "tensor-core"),
    (128, 128, 32): (5, "tensor-core"),
    (128, 256, 32): (6, "tensor-core"),
}
# The fastest f32 and f16 / bf16 instantiations of chip_smoke.py path (j)
# on an H100 80GB HBM3 (700 W; PERF.md): the double-buffered 8x8 tile
# at 2048^3 f32, the 128 x 128 tensor-core tile at every bf16 shape whose
# grid fills the card (see pick_matmul_config).
F32_DEFAULT, HALF_DEFAULT = (128, 128, 16), (128, 128, 32)
# pick_matmul_config walks the 128 x 128 tiles in groups of this many tile
# columns when there are at least GROUP_MIN_COLS of them.
HALF_GROUP, GROUP_MIN_COLS = 8, 128


def matmul_plain(x, y, layout="nn", out_dtype=None):
    """x @ y (nn) or x @ y^T (tn) in f32, one rounding to ``out_dtype``."""
    yf = y.float() if layout == "nn" else y.float().T
    return (x.float() @ yf).to(out_dtype or x.dtype)


def matmul_ref(x, y):
    return matmul_plain(x, y, "nn")


def matmul_tn_ref(x, y):
    return matmul_plain(x, y, "tn")


def _mm_flops(x, y):
    M, K = x.shape
    N = y.shape[0] if y.shape[1] == K else y.shape[1]
    return float(2 * M * N * K)


def _launch(x, y, M, N, K, odt, layout, block, group):
    """Launch csrc/matmul.cu on the current stream, on checked operands."""
    from leetcuda_tpu_torch.build import kernel

    out = torch.empty((M, N), dtype=odt, device=x.device)
    fn = kernel("matmul", "lc_matmul", _ARGS)
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K,
             _DTYPES[x.dtype], _DTYPES[odt], int(layout == "tn"),
             BLOCKS[block][0], group or 0,
             torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, MATMUL.name)
    MATMUL.add()
    return out


def make_matmul(*, block=None, layout: str = "nn", out_dtype=None,
                swizzle_group: int | None = None):
    """A matmul of (x, y) in one instantiation of ``csrc/matmul.cu``.

    ``block`` is a key of ``BLOCKS`` (None: ``HALF_DEFAULT`` on the
    tensor cores for f16 / bf16, ``F32_DEFAULT`` on the CUDA cores for f32);
    ``swizzle_group`` None walks the tiles row-major."""
    if layout not in ("nn", "tn"):
        raise ValueError(f"layout must be 'nn' or 'tn', got {layout!r}")
    if block is not None and tuple(block) not in BLOCKS:
        raise ValueError(f"block {block} is not instantiated by "
                         f"csrc/matmul.cu; choose one of {sorted(BLOCKS)}")
    if swizzle_group is not None and swizzle_group < 1:
        raise ValueError(f"swizzle_group must be >= 1, got {swizzle_group}")
    if out_dtype is not None and out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype must be f32, f16 or bf16, got "
                         f"{out_dtype}")
    fixed = None if block is None else tuple(block)

    def fn(x, y):
        if x.dim() != 2 or y.dim() != 2:
            raise ValueError(f"matmul takes 2-D x and y, got "
                             f"{tuple(x.shape)}, {tuple(y.shape)}")
        M, K = x.shape
        N, K2 = (y.shape[1], y.shape[0]) if layout == "nn" else y.shape
        if K != K2:
            raise ValueError(f"matmul ({layout}): x {tuple(x.shape)} and y "
                             f"{tuple(y.shape)} do not contract")
        if x.dtype != y.dtype or x.dtype not in _DTYPES:
            raise ValueError(f"matmul takes x and y of one dtype among f32, "
                             f"f16, bf16; got {x.dtype}, {y.dtype}")
        if x.device != y.device:
            raise ValueError("matmul: x and y must lie on one device")
        blk = fixed or (F32_DEFAULT if x.dtype == torch.float32
                        else HALF_DEFAULT)
        if BLOCKS[blk][1] == "tensor-core" and x.dtype == torch.float32:
            raise ValueError(f"block {blk} runs on the tensor cores, which "
                             "take f16 / bf16; f32 takes a CUDA-core block")
        odt = out_dtype or x.dtype
        if x.device.type == "cpu":
            return matmul_plain(x, y, layout, odt)
        for name, t in (("x", x), ("y", y)):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"matmul kernel: {name} must be contiguous "
                                 "and 16-byte aligned")
        return _launch(x, y, M, N, K, odt, layout, blk, swizzle_group)

    fn.block, fn.layout, fn.swizzle_group = fixed, layout, swizzle_group
    return fn


# --- the graded ladder (reference naming lineage; blocks are the port's) ---
# naive     one thread per output        (sgemm.cu naive analog)
# sliced_k  shared-memory k slices       (sgemm.cu sliced_k analog)
# t_8x8     8x8 register block a thread, double-buffered for the dbuf rung
# mma       tensor cores, cp.async stages (hgemm_mma_stage analog)
# The block-swizzled rungs carry the JAX package's group (4).
VARIANTS = [
    # (name, block, layout, swizzle_group)
    ("sgemm_naive_f32", (16, 16, 1), "nn", None),
    ("sgemm_sliced_k_f32", (32, 32, 32), "nn", None),
    ("sgemm_t_8x8_sliced_k_f32x4", (128, 128, 8), "nn", None),
    ("sgemm_t_8x8_sliced_k16_f32x4_pack_bcf_dbuf", (128, 128, 16), "nn",
     None),
    ("sgemm_block_swizzle", (128, 128, 8), "nn", 4),
    ("hgemm_naive_f16", (16, 16, 1), "nn", None),
    ("hgemm_sliced_k_f16", (32, 32, 32), "nn", None),
    ("hgemm_t_8x8_sliced_k_f16x8_pack_bcf_dbuf", (64, 64, 32), "nn", None),
    ("hgemm_wmma_mma4x2_warp2x4_stages", (128, 128, 32), "nn", None),
    ("hgemm_mma_stages_block_swizzle", (128, 256, 32), "nn", None),
    ("hgemm_mma_stages_tn", (128, 256, 32), "tn", None),
    ("hgemm_mma_stages_block_swizzle_tn_cute", (128, 256, 32), "tn", 4),
]

for _name, _blk, _layout, _swz in VARIANTS:
    register_op(
        _name,
        ref=matmul_ref if _layout == "nn" else matmul_tn_ref,
        flops=_mm_flops, atol=2e-2, rtol=2e-2, family="gemm",
        tags=(_layout, "swizzle" if _swz else "plain",
              "f16" if "hgemm" in _name else "f32"),
    )(make_matmul(block=_blk, layout=_layout, swizzle_group=_swz))


# production entry points
matmul = make_matmul()
sgemm = make_matmul(block=F32_DEFAULT)
hgemm = make_matmul(block=HALF_DEFAULT)
hgemm_tn = make_matmul(block=HALF_DEFAULT, layout="tn")


# --- the resident chain -------------------------------------------------------

def matmul_chain_plain(a, b, reps: int):
    """``reps`` times a <- matmul_plain(a, b): f32 sums, rounded to a's
    dtype each rep (JAX's ``matmul_chain_ref``)."""
    for _ in range(reps):
        a = matmul_plain(a, b)
    return a


matmul_chain_ref = matmul_chain_plain


def make_matmul_resident(*, reps: int, block_m: int = 1024,
                         vmem_limit_mb: int = 100):
    """chain(a (M, K), b (K, N)) with K == N: a @ b ``reps`` times, rounded
    to a's dtype after each, in one kernel launch."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")

    def fn(a, b):
        if a.dim() != 2 or b.dim() != 2:
            raise ValueError(f"the chain takes 2-D a and b, got "
                             f"{tuple(a.shape)}, {tuple(b.shape)}")
        M, K = a.shape
        K2, N = b.shape
        if not (K == K2 and K == N):
            raise ValueError(f"chained matmul needs square-compatible B: a "
                             f"{tuple(a.shape)}, b {tuple(b.shape)}")
        if a.dtype != b.dtype or a.dtype not in _DTYPES:
            raise ValueError(f"the chain takes a and b of one dtype among "
                             f"f32, f16, bf16; got {a.dtype}, {b.dtype}")
        if a.device != b.device:
            raise ValueError("the chain: a and b must lie on one device")
        if a.device.type == "cpu":
            return matmul_chain_plain(a, b, reps)
        for name, t in (("a", a), ("b", b)):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"resident chain kernel: {name} must be "
                                 "contiguous and 16-byte aligned")
        from leetcuda_tpu_torch.build import kernel

        out = torch.empty_like(a)
        if a.numel() == 0:
            return out
        scratch = torch.empty_like(a) if reps > 1 else out
        err = kernel("matmul", "lc_matmul_resident", _RES_ARGS)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            M, N, reps, _DTYPES[a.dtype],
            torch.cuda.current_stream(a.device).cuda_stream)
        check_launch(err, MATMUL_RESIDENT.name)
        MATMUL_RESIDENT.add()
        return out

    return fn


register_op(
    "hgemm_resident_chain",
    ref=functools.partial(matmul_chain_ref, reps=3),
    flops=lambda a, b: float(2 * 3 * a.shape[0] * a.shape[1] * b.shape[1]),
    atol=2e-2, rtol=2e-2,
    family="gemm-resident", tags=("f16", "resident"),
)(make_matmul_resident(reps=3, block_m=64))


# --- shape-adaptive config selection -----------------------------------------

SM_COUNT = 132  # H100 SXM


def pick_matmul_config(M: int, N: int, K: int, dtype=torch.bfloat16,
                       layout: str = "nn") -> dict:
    """Choose (block, swizzle_group) from the problem shape, among the
    instantiations of ``csrc/matmul.cu``. Rules measured by the tile A/B of
    chip_smoke.py path (j) (``ms_by_config``: every tensor-core tile, with
    and without a group of 8, taken in turn, at the 8192^3 headline,
    training's five projections and the skewed shapes; the GEMM rows of
    PERF.md, a run that a later one repeats but at 8192^3, where the group
    read -1.6%; NVIDIA H100 80GB HBM3, 700 W):

    - f16 / bf16 whose 128 x 128 tiles fill the card's 132 SMs: the
      128 x 128 tile (two CTAs an SM), fastest at all ten such shapes,
      7.6-19.8% ahead of 128 x 256 (one CTA an SM), 28.9-42.1% ahead of
      64 x 64;
    - its tile columns walked ``HALF_GROUP`` at a time only when there are
      ``GROUP_MIN_COLS`` or more: the group took 4.0% off the
      (16384, 32000, 2048) output projection (250 columns) and cost 3.2%
      at N = 11264 (88), 4.0% at N = 14336 (112) and 2.8% at 8192^3 (64);
      at the other shapes it moved by under 0.6%;
    - smaller f16 / bf16 grids: the 64 x 64 tile, row-major, which gives
      more CTAs (at (384, 640, 264): 0.0163 ms against 0.0191);
    - f32: ``F32_DEFAULT``, the fastest f32 rung (0.566 ms at 2048^3,
      against 0.96-3.41 for the others).
    """
    if dtype == torch.float32:
        return {"block": F32_DEFAULT, "layout": layout, "swizzle_group": None}
    if cdiv(M, 128) * cdiv(N, 128) >= SM_COUNT:
        wide = cdiv(N, 128) >= GROUP_MIN_COLS
        return {"block": HALF_DEFAULT, "layout": layout,
                "swizzle_group": HALF_GROUP if wide else None}
    return {"block": (64, 64, 32), "layout": layout, "swizzle_group": None}


@functools.lru_cache(maxsize=64)
def _auto_fn(M, N, K, dtype, layout):
    return make_matmul(**pick_matmul_config(M, N, K, dtype, layout))


def matmul_auto(x, y, *, layout: str = "nn"):
    """Matmul with the shape-adaptive config (functions cached per shape
    and dtype). The entry point for arbitrary shapes."""
    M, K = x.shape
    N = y.shape[1] if layout == "nn" else y.shape[0]
    return _auto_fn(M, N, K, x.dtype, layout)(x, y)
