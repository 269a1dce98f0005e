"""Dense matmul library: the sgemm / hgemm ladder and ``matmul_auto``.

Counterpart of ``leetcuda_tpu/gemm/matmul.py``. ``make_matmul`` returns a
function of (x, y): layout "nn" computes x (M, K) @ y (K, N), layout "tn"
x (M, K) @ y (N, K)^T, summed in f32 and rounded once to ``out_dtype``
(default x's dtype), for f32, f16 and bf16 and any M, N, K.

On CUDA tensors it launches ``csrc/matmul.cu``; on CPU tensors it runs the
plain version, ``(x.float() @ y.float()).to(out)``. ``block`` selects one of
the instantiations the source compiles (``BLOCKS``): CUDA-core tiles, which
take every dtype, and tensor-core tiles, which take f16 and bf16: one
persistent, warp-specialised TMA + wgmma kernel (``csrc/gemm_sm90.cuh``) in
three tiles (``TC_TILES``; ``hgemm_plan`` gives the tile, the zero padding
of K and N to multiples of 8 and the grid of one launch).
The JAX package's blocks are TPU VMEM tiles (up to 2048 x 2048 x 512) and do
not carry over; each of the 12 registered rungs is an instantiation of the
port's own choosing, under the JAX name, family, tags and tolerance.
``swizzle_group`` walks the output tiles ``group`` tile-columns at a time,
as the JAX ``_swizzled_ij`` does (L2 reuse of the B panels on the GPU); the
persistent kernel's CTAs take their tiles in that order (``tile_ij``).
``vmem_limit_mb`` is TPU-only and not taken.

``make_matmul_resident`` is the chain A <- cast(A @ B), ``reps`` times in
one launch of ``csrc/matmul_resident.cu``: for f16 / bf16 one persistent,
warp-specialised TMA + wgmma kernel that walks every rep's output tiles
(``RESIDENT_TILE``; ``resident_plan`` gives the tiles, the grid, the
counters and the padded N), for f32 the CUDA cores, a CTA owning 64 rows
for every rep. ``block_m`` and ``vmem_limit_mb`` are the TPU's tiling and
are accepted and ignored.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import (SM_COUNT, LaunchCounter, cdiv,
                                             check_launch)

MATMUL = LaunchCounter("matmul")
MATMUL_RESIDENT = LaunchCounter("matmul_resident")
# lc_matmul(x, y, out, M, N, K, dtype, odt, tn, config, group, grid,
#           stream); lc_matmul_info(config, int info[6])
_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)
_INFO_ARGS = (ctypes.c_int, ctypes.c_void_p)
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# lc_matmul_resident(a, b, out, scratch, done, M, N, reps, dtype, grid,
#                    stream); lc_matmul_resident_info(int info[6]);
# lc_matmul_resident_f32(a, b, out, scratch, M, N, reps, stream)
_RES_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_RES_INFO_ARGS = (ctypes.c_void_p,)
_RES_F32_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3
                 + (ctypes.c_void_p,))
# The f16 / bf16 chain's build (csrc/matmul_resident.cu's macros, chosen by
# bench/gemm_bench.py --resident): output tiles of block_m x block_n over
# block_k-deep stages, CTAs in clusters of ``cluster``; the wrapper holds the
# library's own report (lc_matmul_resident_info) to it. (f32: a CTA owns 64
# rows for every rep.)
RESIDENT_TILE = {"block_m": 128, "block_n": 256, "block_k": 64, "stages": 3,
                 "cluster": 2}

# (BM, BN, BK) -> (the source's config id, datapath). CUDA cores: one thread
# per output with BK 1 (naive), or shared-memory tiles with a register block
# per thread (32^2 x 32: 2x2; 128^2 x 8: 8x8; 128^2 x 16: 8x8 double-
# buffered). Tensor cores: the keys name the wgmma kernel's three tiles
# (TC_TILES), which all run 64-deep TMA stages.
BLOCKS = {
    (16, 16, 1): (0, "cuda-core"),
    (32, 32, 32): (1, "cuda-core"),
    (128, 128, 8): (2, "cuda-core"),
    (128, 128, 16): (3, "cuda-core"),
    (64, 64, 32): (4, "tensor-core"),
    (128, 128, 32): (5, "tensor-core"),
    (128, 256, 32): (6, "tensor-core"),
}
# The tensor-core keys' tiles in csrc/matmul.cu (Tc64, Tc128, Tc256): output
# tiles of block_m x block_n over 64-deep stages, CTAs in clusters of
# ``cluster`` along M (a pair multicasts its B tile), ``per_sm`` CTAs an SM.
TC_TILES = {
    (64, 64, 32): {"block_m": 64, "block_n": 64, "block_k": 64, "stages": 4,
                   "cluster": 1, "per_sm": 3},
    (128, 128, 32): {"block_m": 128, "block_n": 128, "block_k": 64,
                     "stages": 6, "cluster": 2, "per_sm": 1},
    (128, 256, 32): {"block_m": 128, "block_n": 256, "block_k": 64,
                     "stages": 3, "cluster": 2, "per_sm": 1},
}
# The fastest f32 and f16 / bf16 instantiations (PERF.md rows 15; NVIDIA
# H100 80GB HBM3, 700 W): the double-buffered 8x8 tile at 2048^3 f32
# (chip_smoke.py path (j)), the 128 x 256 tensor-core tile at every bf16
# shape whose grid fills the card (bench/gemm_bench.py --hgemm; see
# pick_matmul_config).
F32_DEFAULT, HALF_DEFAULT = (128, 128, 16), (128, 256, 32)
# pick_matmul_config walks the 128 x 256 tiles in groups of this many tile
# columns when there are at least GROUP_MIN_COLS of them.
HALF_GROUP, GROUP_MIN_COLS = 8, 32


def tile_ij(t: int, ni: int, nj: int, group: int | None):
    """The persistent walk's unit t -> (i, j) on an ni x nj grid: row-major,
    or ``group`` columns at a time (csrc/gemm_sm90.cuh ``tile_ij``, the JAX
    ``_swizzled_ij``)."""
    if not group:
        return t // nj, t % nj
    per = ni * group
    g, r = divmod(t, per)
    cur = min(group, nj - g * group)
    return r // cur, g * group + r % cur


def hgemm_plan(M: int, N: int, K: int, block=HALF_DEFAULT,
               ctas: int | None = None) -> dict:
    """One tensor-core launch of csrc/matmul.cu for (M, K) @ (K, N): K and N
    padded with zeros to ``k_pad`` / ``n_pad`` (multiples of 8: a tensor
    map's rows are multiples of 16 bytes), the tile, the ``units`` (pairs of
    row blocks by column blocks when CTAs pair up) and the ``grid`` (at most
    ``ctas``, the co-resident count: by default ``per_sm`` an SM of the
    H100's 132, in whole clusters, none without a unit)."""
    t = dict(TC_TILES[tuple(block)])
    k_pad, n_pad = cdiv(K, 8) * 8, cdiv(N, 8) * 8
    row_blocks, col_blocks = cdiv(M, t["block_m"]), cdiv(n_pad, t["block_n"])
    units = cdiv(row_blocks, t["cluster"]) * col_blocks
    if ctas is None:
        ctas = t["per_sm"] * SM_COUNT
    return {**t, "k_pad": k_pad, "n_pad": n_pad,
            "pad": (k_pad, n_pad) != (K, N), "row_blocks": row_blocks,
            "col_blocks": col_blocks, "units": units,
            "grid": min(ctas // t["cluster"], units) * t["cluster"]}


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


def pad_operands(x, y, layout, plan):
    """x (M, K) and y ((K, N) for "nn", (N, K) for "tn") with zero columns
    and rows up to ``plan``'s k_pad and n_pad (themselves where no padding
    is due): the extra products are 0 * 0, so the sums are exact."""
    if not plan["pad"]:
        return x, y
    (M, K), N = x.shape, y.shape[1] if layout == "nn" else y.shape[0]
    dk, dn = plan["k_pad"] - K, plan["n_pad"] - N
    pad = torch.nn.functional.pad
    return pad(x, (0, dk)), (pad(y, (0, dn, 0, dk)) if layout == "nn"
                             else pad(y, (0, dk, 0, dn)))


_TC_INFO: dict = {}


def tc_build_info(block, device, lib="matmul"):
    """(tile, co-resident CTAs) of the tensor-core ``block`` in ``lib`` (a
    source name or a variant build) on ``device``, read once from
    csrc/matmul.cu's ``lc_matmul_info``; the package's tile must be
    TC_TILES'."""
    key = (tuple(block), device.index, lib if isinstance(lib, str)
           else id(lib))
    got = _TC_INFO.get(key)
    if got is None:
        from leetcuda_tpu_torch.build import entry

        info = (ctypes.c_int * 6)()
        with torch.cuda.device(device):
            check_launch(entry(lib, "lc_matmul_info", _INFO_ARGS)(
                BLOCKS[tuple(block)][0], ctypes.addressof(info)), MATMUL.name)
        tile = dict(zip(("block_m", "block_n", "block_k", "stages",
                         "cluster"), info[:5]))
        want = {k: v for k, v in TC_TILES[tuple(block)].items()
                if k != "per_sm"}
        if lib == "matmul" and tile != want:
            raise RuntimeError(f"csrc/matmul.cu was built with {tile} for "
                               f"{block}, the wrapper plans {want}")
        got = _TC_INFO[key] = (tile, info[5])
    return got


def _launch(x, y, M, N, K, odt, layout, block, group, lib="matmul"):
    """Launch csrc/matmul.cu (or the variant build ``lib``) on the current
    stream, on checked operands. A tensor-core block pads K and N with zeros
    to multiples of 8 where they are not (exact: the extra products are
    0 * 0) and slices the result."""
    from leetcuda_tpu_torch.build import entry

    grid, n_out = 0, N
    if BLOCKS[block][1] == "tensor-core":
        plan = hgemm_plan(M, N, K, block,
                          tc_build_info(block, x.device, lib)[1])
        grid, K, n_out = plan["grid"], plan["k_pad"], plan["n_pad"]
        x, y = pad_operands(x, y, layout, plan)
    out = torch.empty((M, n_out), dtype=odt, device=x.device)
    fn = entry(lib, "lc_matmul", _ARGS)
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), M, n_out, K,
             _DTYPES[x.dtype], _DTYPES[odt], int(layout == "tn"),
             BLOCKS[block][0], group or 0, grid,
             torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, MATMUL.name)
    MATMUL.add()
    return out if n_out == N else out[:, :N].contiguous()


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
# mma       tensor cores: the TMA + wgmma kernel (hgemm_mma_stage analog)
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


def resident_plan(M: int, N: int, reps: int, ctas: int = 132,
                  tile: dict | None = None) -> dict:
    """What one f16 / bf16 chain launch of (M, N) @ (N, N), ``reps`` times,
    runs: N padded to ``n_pad`` (a multiple of 8, as a tensor map needs),
    output tiles of ``tile`` (default ``RESIDENT_TILE``), ``tiles`` of them
    over the reps, taken by ``grid`` CTAs (at most ``ctas``, the co-resident
    count, in whole clusters, none without a work unit) that walk them, and
    ``counters`` = reps x row blocks."""
    t = dict(RESIDENT_TILE if tile is None else tile)
    n_pad = cdiv(N, 8) * 8
    row_blocks, col_blocks = cdiv(M, t["block_m"]), cdiv(n_pad, t["block_n"])
    units = reps * cdiv(row_blocks, t["cluster"]) * col_blocks
    return {**t, "n_pad": n_pad,
            "row_blocks": row_blocks, "col_blocks": col_blocks,
            "tiles": reps * row_blocks * col_blocks,
            "grid": min(ctas // t["cluster"], units) * t["cluster"],
            "counters": reps * row_blocks}


_RES_INFO: dict = {}


def resident_build_info(device, lib="matmul_resident"):
    """(tile, co-resident CTAs) of the chain's build ``lib`` (a source name,
    or a loaded variant library) on ``device``, read once from the
    library's ``lc_matmul_resident_info``."""
    key = (lib if isinstance(lib, str) else id(lib), device.index)
    got = _RES_INFO.get(key)
    if got is None:
        from leetcuda_tpu_torch.build import entry

        fn = entry(lib, "lc_matmul_resident_info", _RES_INFO_ARGS)
        info = (ctypes.c_int * 6)()
        with torch.cuda.device(device):
            check_launch(fn(ctypes.addressof(info)), MATMUL_RESIDENT.name)
        tile = dict(zip(("block_m", "block_n", "block_k", "stages",
                         "cluster"), info[:5]))
        got = _RES_INFO[key] = (tile, info[5])
    return got


def _launch_resident(a, b, reps, lib="matmul_resident"):
    """The f16 / bf16 chain through ``lib`` on checked CUDA operands: a and
    b zero-padded to ``n_pad`` columns where N is not a multiple of 8 (B's
    extra rows and columns are 0, so A's extra columns stay 0 every rep:
    exact), one launch, the counters zeroed on the stream."""
    from leetcuda_tpu_torch.build import entry

    M, N = a.shape
    tile, ctas = resident_build_info(a.device, lib)
    if lib == "matmul_resident" and tile != RESIDENT_TILE:
        raise RuntimeError(f"csrc/matmul_resident.cu was built with {tile}, "
                           f"the wrapper plans {RESIDENT_TILE}")
    plan = resident_plan(M, N, reps, ctas=ctas, tile=tile)
    n8 = plan["n_pad"]
    if n8 != N:
        a = torch.nn.functional.pad(a, (0, n8 - N))
        b = torch.nn.functional.pad(b, (0, n8 - N, 0, n8 - N))
    out = torch.empty((M, n8), dtype=a.dtype, device=a.device)
    scratch = torch.empty_like(out) if reps > 1 else out
    done = torch.zeros(plan["counters"], dtype=torch.int32, device=a.device)
    err = entry(lib, "lc_matmul_resident", _RES_ARGS)(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        done.data_ptr(), M, n8, reps, _DTYPES[a.dtype], plan["grid"],
        torch.cuda.current_stream(a.device).cuda_stream)
    check_launch(err, MATMUL_RESIDENT.name)
    MATMUL_RESIDENT.add()
    return out if n8 == N else out[:, :N].contiguous()


def _launch_resident_f32(a, b, reps):
    from leetcuda_tpu_torch.build import kernel

    M, N = a.shape
    out = torch.empty_like(a)
    scratch = torch.empty_like(a) if reps > 1 else out
    err = kernel("matmul_resident", "lc_matmul_resident_f32", _RES_F32_ARGS)(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(), M, N,
        reps, torch.cuda.current_stream(a.device).cuda_stream)
    check_launch(err, MATMUL_RESIDENT.name)
    MATMUL_RESIDENT.add()
    return out


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
        if a.numel() == 0:
            return torch.empty_like(a)
        if a.dtype == torch.float32:
            return _launch_resident_f32(a, b, reps)
        return _launch_resident(a, b, reps)

    return fn


register_op(
    "hgemm_resident_chain",
    ref=functools.partial(matmul_chain_ref, reps=3),
    flops=lambda a, b: float(2 * 3 * a.shape[0] * a.shape[1] * b.shape[1]),
    atol=2e-2, rtol=2e-2,
    family="gemm-resident", tags=("f16", "resident"),
)(make_matmul_resident(reps=3, block_m=64))


# --- shape-adaptive config selection -----------------------------------------


def pick_matmul_config(M: int, N: int, K: int, dtype=torch.bfloat16,
                       layout: str = "nn") -> dict:
    """Choose (block, swizzle_group) from the problem shape, among the
    instantiations of ``csrc/matmul.cu``. Rules measured by the tile A/B of
    bench/gemm_bench.py --hgemm (every tensor-core tile of the persistent
    TMA + wgmma kernel, with and without a group of 8, taken in turn, at
    the 8192^3 headline, training's five projections at 16384 rows and the
    skewed shapes; PERF.md row 15, on an NVIDIA H100 80GB HBM3, 700 W),
    which chip_smoke.py path (j)'s ``ms_by_config`` repeats:

    - f16 / bf16 whose 128 x 256 tiles fill the card's 132 SMs: the 128 x
      256 tile, fastest at all ten such shapes, 3-20% ahead of 128 x 128's
      best (whose loads alone took as long as its whole product at 8192^3)
      and 2.2-2.8x ahead of 64 x 64's;
    - its tile columns walked ``HALF_GROUP`` at a time only when there are
      ``GROUP_MIN_COLS`` or more: the group took 19.6% off the (16384,
      32000, 2048) output projection (125 columns), 12.7% off (4096, 14336,
      4096) (56), 6.5% off N = 11264 (44) and 1.0-3.5% at the three shapes
      of 32 columns; below, it cost 0.1-1.0% at the four shapes measured;
    - smaller f16 / bf16 grids: the 64 x 64 tile (three CTAs an SM),
      row-major, which gives more CTAs (at (384, 640, 264): 0.0083 ms
      against 0.0100 at 128 x 128 and 0.0122 at 128 x 256);
    - f32: ``F32_DEFAULT``, the fastest f32 rung (0.566 ms at 2048^3,
      against 0.96-3.41 for the others).
    """
    if dtype == torch.float32:
        return {"block": F32_DEFAULT, "layout": layout, "swizzle_group": None}
    bn = HALF_DEFAULT[1]
    if cdiv(M, 128) * cdiv(N, bn) >= SM_COUNT:
        wide = cdiv(N, bn) >= GROUP_MIN_COLS
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
