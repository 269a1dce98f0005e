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
raise on what those do not take. Both are TMA + wgmma kernels with two
routes by row count (``w8_plan``, ``w4_plan``): decode rows split K over the
card and sum the splits in the same launch; prefill rows take 128-row CTA
tiles (w8a16: the weight converted to bf16 in a pass of its own, then the
dense matmul's persistent kernel). On CPU tensors they run the plain versions
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
import functools

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, cdiv, check_launch
from leetcuda_tpu_torch.gemm.matmul import GROUP_MIN_COLS, HALF_GROUP

W8A16 = LaunchCounter("matmul_w8a16")
W8_TO_BF16 = LaunchCounter("w8_to_bf16")  # the prefill route's first pass
W4A16 = LaunchCounter("matmul_w4a16")
I8I8I32 = LaunchCounter("matmul_i8i8i32")
# lc_wq_matmul_bf16(x, w, s, out, ws, counters, M, N, K, fp8, route, bm,
#                   splits, group, grid, stream); lc_wq_matmul_info(info);
# lc_w8_to_bf16(w, wb, n, fp8, stream)
_W8A16_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)
_W8_INFO_ARGS = (ctypes.c_void_p,)
_W8_CONVERT_ARGS = (ctypes.c_void_p,) * 2 + (ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_void_p)
# lc_w4_matmul_bf16(x, packed, scales, out, ws, counters, M, N, K, bm,
#                   splits, stream); lc_w4_matmul_info(info)
_W4A16_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_W4_INFO_ARGS = (ctypes.c_void_p,)
# lc_i8_matmul(x, w, out, M, N, K, stream)
_I8_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)

# The w8a16 kernel's routes (csrc/wq_matmul.cu): up to W8_DECODE_MAX_ROWS
# rows, CTAs of 128 columns by the fewest rows of (8, 16, 32, 64) that hold
# them, K split into whole 64-row stages until about W8_SPLIT_CTAS CTAs run
# (two an SM of an H100), the splits summed in the launch; above, a pass
# that converts the weight into a bf16 scratch, then the dense matmul's
# persistent kernel (W8_PREFILL_TILE, its tile columns grouped as
# pick_matmul_config groups them) with the scale in its epilogue. The
# threshold is the A/B of both routes in bench/gemm_bench.py --w8 (PERF.md
# row 10; on an NVIDIA H100 80GB HBM3, 700 W): the decode route won at
# paths (a) and (b)'s four weight shapes at every row count to 128, in fp8
# and int8, but one (wo at 64 rows in fp8, by 1.7%), and at 192 and 256
# rows on every one by 2.6-43.6%; at 384 it won w_gate_up and w_down by
# 14-22% and lost wqkv and wo by 3-8% (a layer's four products 0.022-0.031
# ms faster in sum); at 12288 it took 2.4-2.8x the prefill route. No row
# count between 384 and 12288 was timed: the cut lies at or above 384, and
# no path gives rows between 384 and 1024. chip_smoke.py phase 3 times
# both routes at every row count of the paths.
W8_DECODE_MAX_ROWS = 384
W8_SPLIT_CTAS = 264
W8_COLS = 128  # output columns of a decode CTA
# the source's defaults (LC_W8_STAGES, the Prefill tile), checked against
# the library's lc_wq_matmul_info
W8_STAGES = 4
W8_PREFILL_TILE = {"block_m": 128, "block_n": 256, "block_k": 64,
                   "stages": 3, "cluster": 2}

# The w4a16 kernel's routes (csrc/w4_matmul.cu): up to W4_DECODE_MAX_ROWS
# rows, CTAs of the fewest rows of (8, 16, 32, 64) that hold them, K split
# into whole groups until about W4_SPLIT_CTAS CTAs run (two an SM of an
# H100), the splits summed in the launch; above, no split and CTAs of 64
# rows up to W4_PREFILL_SMALL_ROWS rows, of W4_PREFILL_ROWS beyond. On an
# H100 80GB HBM3 (700 W) the decode route won at path (c)'s shapes up to
# 32 rows and lost from 64, and 64-row prefill CTAs beat 128-row ones by
# 14-18% up to 128 rows and lost by 35-53% at 1024 (bench/gemm_bench.py
# --w4; PERF.md row 12). chip_smoke.py times both routes at every matmul
# shape of path (c).
W4_DECODE_MAX_ROWS = 32
W4_PREFILL_SMALL_ROWS = 128
W4_SPLIT_CTAS = 264
# the source's defaults (LC_W4_PREFILL_M, LC_W4_STAGES), checked against
# the library's lc_w4_matmul_info
W4_PREFILL_ROWS = 128
W4_STAGES = 4
W4_COLS = 128  # output columns of a CTA

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


# --- the w8a16 kernel's plan -------------------------------------------------

@functools.lru_cache(maxsize=1024)
def w8_plan(M, N, K, decode=None, stages=W8_STAGES, ctas=None):
    """What csrc/wq_matmul.cu runs for x (M, K) and a (K, N) pack: the
    route (``decode``: None picks it by M); on the decode route the CTA's
    rows ``bm``, the K splits (whole 64-row stages, none empty), the grid,
    shared-memory bytes, and the workspace (f32 partials) and counters the
    split sum needs; on the prefill route the bf16 copy of the weight
    (``wbuf`` elements) that the conversion pass writes, and the persistent
    kernel's tile and grid (at most ``ctas`` CTAs, the co-resident count;
    default one an SM of 132). N is padded to 16 first, as the wrapper pads
    it. Cached: a decode step asks for the same plans every time (read it,
    do not change it)."""
    if decode is None:
        decode = M <= W8_DECODE_MAX_ROWS
    N16, nk = cdiv(N, 16) * 16, cdiv(K, 64)
    if not decode:
        t = W8_PREFILL_TILE
        units = (cdiv(cdiv(M, t["block_m"]), t["cluster"])
                 * cdiv(N16, t["block_n"]))
        ctas = 132 if ctas is None else ctas
        return {"route": "prefill", **t,
                "grid": min(ctas // t["cluster"], units) * t["cluster"],
                "units": units, "threads": 384,
                "group": (HALF_GROUP if cdiv(N16, t["block_n"])
                          >= GROUP_MIN_COLS else 0),
                "smem": 1024 + t["stages"] * (t["block_m"] + t["block_n"])
                * 128 + t["block_m"] * t["block_n"] * 2
                + 8 * (2 * t["stages"] + 2),
                "wbuf": K * N16,
                "splits": 1, "workspace": 0, "counters": 0}
    bm = next(b for b in (8, 16, 32, 64) if b >= min(M, 64))
    n_tiles, m_tiles = cdiv(N16, W8_COLS), cdiv(M, bm)
    want = min(nk, cdiv(W8_SPLIT_CTAS, n_tiles * m_tiles))
    splits = cdiv(nk, cdiv(nk, want))
    sps = cdiv(nk, splits)
    return {"route": "decode", "bm": bm, "splits": splits,
            "split_stages": [(s * sps, min(nk, (s + 1) * sps))
                             for s in range(splits)],
            "grid": (n_tiles, m_tiles, splits), "threads": 256,
            "stages": stages,
            "smem": 1024 + stages * (64 * W8_COLS + bm * 128)
            + 16 * stages + 16,
            "wbuf": 0,
            "workspace": splits * M * N16 if splits > 1 else 0,
            "counters": n_tiles * m_tiles if splits > 1 else 0}


_W8_INFO: dict = {}


def w8_build_info(device, lib="wq_matmul"):
    """(decode stages, co-resident CTAs of the prefill kernel) of ``lib`` (a
    source name or a variant build) on ``device``; the build's prefill tile
    must be W8_PREFILL_TILE, and the package's build must have W8_STAGES."""
    from leetcuda_tpu_torch.build import entry

    key = (lib if isinstance(lib, str) else id(lib), device.index)
    got = _W8_INFO.get(key)
    if got is None:
        info = (ctypes.c_int * 7)()
        with torch.cuda.device(device):
            check_launch(entry(lib, "lc_wq_matmul_info", _W8_INFO_ARGS)(
                ctypes.addressof(info)), W8A16.name)
        tile = dict(zip(("block_m", "block_n", "block_k", "stages",
                         "cluster"), info[1:6]))
        got = _W8_INFO[key] = (info[0], info[6])
        if tile != W8_PREFILL_TILE or (lib == "wq_matmul"
                                       and info[0] != W8_STAGES):
            raise RuntimeError(f"a w8a16 build has {info[0]} decode stages "
                               f"and the prefill tile {tile}; the wrapper "
                               f"plans {W8_STAGES} and {W8_PREFILL_TILE}")
    return got


# --- the w4a16 kernel's plan -----------------------------------------------------

@functools.lru_cache(maxsize=1024)
def w4_plan(M, N, K, decode=None, prefill_rows=W4_PREFILL_ROWS,
            stages=W4_STAGES):
    """What one launch of csrc/w4_matmul.cu runs for x (M, K) and a (K/2, N)
    pack: the route (``decode``: None picks it by M), the CTA's rows
    ``bm``, the K splits (whole groups of 128 packed rows, none empty), the
    grid, shared-memory bytes, and the workspace (f32 partials) and counters
    the split sum needs. N is padded to 16 first, as the wrapper pads it.
    Cached: a decode step asks for the same plans every time (read it,
    do not change it)."""
    if decode is None:
        decode = M <= W4_DECODE_MAX_ROWS
    N16 = -(-N // 16) * 16
    groups = K // 256
    if decode:
        bm = next(b for b in (8, 16, 32, 64) if b >= min(M, 64))
    else:
        bm = 64 if M <= W4_PREFILL_SMALL_ROWS else prefill_rows
    n_tiles, m_tiles = -(-N16 // W4_COLS), -(-M // bm)
    splits = 1
    if decode:
        want = min(groups, -(-W4_SPLIT_CTAS // (n_tiles * m_tiles)))
        splits = -(-groups // -(-groups // want))
    gps = -(-groups // splits)
    return {"route": "decode" if decode else "prefill", "bm": bm,
            "splits": splits,
            "split_groups": [(s * gps, min(groups, (s + 1) * gps))
                             for s in range(splits)],
            "grid": (n_tiles, m_tiles, splits), "threads": 256,
            "stages": stages,
            "smem": 1024 + stages * (64 * W4_COLS + 2 * bm * 128)
            + 16 * stages + 16,
            "workspace": splits * M * N16 if splits > 1 else 0,
            "counters": n_tiles * m_tiles if splits > 1 else 0}


# One (workspace, counters) pair per (device, stream), grown on demand,
# shared by the two split-K routes (w8a16, w4a16): the last CTA of an
# output tile zeroes its counter again, so the counters are zero between
# launches, and two streams never share them. A buffer that growth
# replaces stays alive in _SPLIT_RETIRED for the life of the process: a CUDA
# graph captured on the stream before the growth still launches into it.
# Growth at least doubles a buffer, so what is retired of it holds less than
# the live one, and few growths happen.
_SPLIT_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
_SPLIT_RETIRED: list[torch.Tensor] = []


def _split_scratch(device, stream: int, workspace: int, counters: int):
    """The (workspace, counters) pair of ``stream`` on ``device``, at least
    ``workspace`` floats and ``counters`` ints, made at its first use; a
    buffer too small is replaced (never inside a capture: launch once on
    the stream first) by one at least twice as large, and the old one is
    kept, never freed. A graph captured on the stream holds the buffers of
    its capture: its replays must not overlap each other on two streams,
    since the kernels expect their counters at zero between launches."""
    key = (device.index, stream)
    ws, cnt = _SPLIT_SCRATCH.get(key, (None, None))
    if ws is None or ws.numel() < workspace or cnt.numel() < counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("split-K matmul: this stream has no split "
                               "workspace of that size yet; launch the call "
                               "once on it before capturing a graph")
        if ws is None or ws.numel() < workspace:
            if ws is not None:
                _SPLIT_RETIRED.append(ws)
            ws = torch.empty(max(workspace,
                                 0 if ws is None else 2 * ws.numel()),
                             dtype=torch.float32, device=device)
        if cnt is None or cnt.numel() < counters:
            if cnt is not None:
                _SPLIT_RETIRED.append(cnt)
            cnt = torch.zeros(max(counters, 1024,
                                  0 if cnt is None else 2 * cnt.numel()),
                              dtype=torch.int32, device=device)
        _SPLIT_SCRATCH[key] = (ws, cnt)
    return ws, cnt


_W4_INFO: dict = {}


def w4_build_info(lib="w4_matmul"):
    """(prefill rows, stages) that ``lib`` (a source name or a variant
    build) was compiled with; the package's build must match W4_PREFILL_ROWS
    and W4_STAGES."""
    from leetcuda_tpu_torch.build import entry

    key = lib if isinstance(lib, str) else id(lib)
    got = _W4_INFO.get(key)
    if got is None:
        info = (ctypes.c_int * 2)()
        check_launch(entry(lib, "lc_w4_matmul_info", _W4_INFO_ARGS)(
            ctypes.addressof(info)), W4A16.name)
        got = _W4_INFO[key] = (info[0], info[1])
        if lib == "w4_matmul" and got != (W4_PREFILL_ROWS, W4_STAGES):
            raise RuntimeError(f"csrc/w4_matmul.cu was built with {got}; "
                               f"the wrapper plans {W4_PREFILL_ROWS} rows, "
                               f"{W4_STAGES} stages")
    return got


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


def _launch_w8a16(x, q, s, decode: bool, lib="wq_matmul"):
    """Launch csrc/wq_matmul.cu (or the variant build ``lib``) on the current
    stream, on the decode or the prefill route (``w8_plan``), on operands the
    wrapper has checked. N is padded to a multiple of 16 with zero columns
    where it is not one (TMA reads rows of 16-byte multiples)."""
    from leetcuda_tpu_torch.build import entry

    stages, ctas = w8_build_info(x.device, lib)
    M, (K, N) = x.shape[0], q.shape
    plan = w8_plan(M, N, K, decode, stages, ctas)
    N16 = -(-N // 16) * 16
    qb = q.view(torch.uint8)
    if N16 != N:
        qb = torch.nn.functional.pad(qb, (0, N16 - N))
        s = torch.nn.functional.pad(s, (0, N16 - N))
    out = torch.empty((M, N16), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fp8 = q.dtype == _E4M3
    ws = cnt = None
    if plan["splits"] > 1:
        ws, cnt = _split_scratch(x.device, stream, plan["workspace"],
                                 plan["counters"])
    prefill = plan["route"] == "prefill"
    w = _launch_w8_to_bf16(qb, fp8, lib) if prefill else qb
    fn = entry(lib, "lc_wq_matmul_bf16", _W8A16_ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(),
             None if cnt is None else cnt.data_ptr(), M, N16, K, int(fp8),
             int(prefill), plan.get("bm", 0), plan["splits"],
             plan.get("group", 0), plan["grid"] if prefill else 0, stream)
    check_launch(err, W8A16.name)
    W8A16.add()
    return out if N16 == N else out[:, :N].contiguous()


def _launch_w8_to_bf16(qb, fp8: bool, lib="wq_matmul"):
    """The prefill route's first pass, csrc/wq_matmul.cu w8_to_bf16, on the
    current stream: weight bytes qb (K, N) uint8 (int8, or e4m3 with
    ``fp8``; K * N a multiple of 16) -> (K, N) bf16, exactly."""
    from leetcuda_tpu_torch.build import entry

    out = torch.empty(qb.shape, dtype=torch.bfloat16, device=qb.device)
    err = entry(lib, "lc_w8_to_bf16", _W8_CONVERT_ARGS)(
        qb.data_ptr(), out.data_ptr(), qb.numel(), int(fp8),
        torch.cuda.current_stream(qb.device).cuda_stream)
    check_launch(err, W8_TO_BF16.name)
    W8_TO_BF16.add()
    return out


def _launch_w4a16(x, packed, scales, decode: bool, lib="w4_matmul"):
    """Launch csrc/w4_matmul.cu (or the variant build ``lib``) on the
    current stream, on the decode or the prefill route (``w4_plan``), on
    operands the wrapper has checked. N is padded to a multiple of 16 with
    zero columns where it is not one (TMA reads rows of 16-byte multiples)."""
    from leetcuda_tpu_torch.build import entry

    prefill_rows, stages = w4_build_info(lib)
    (M, K), N = x.shape, packed.shape[1]
    plan = w4_plan(M, N, K, decode, prefill_rows, stages)
    N16 = -(-N // 16) * 16
    if N16 != N:
        packed = torch.nn.functional.pad(packed, (0, N16 - N))
        scales = torch.nn.functional.pad(scales, (0, N16 - N))
    out = torch.empty((M, N16), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = cnt = None
    if plan["splits"] > 1:
        ws, cnt = _split_scratch(x.device, stream, plan["workspace"],
                                 plan["counters"])
    fn = entry(lib, "lc_w4_matmul_bf16", _W4A16_ARGS)
    err = fn(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
             out.data_ptr(), None if ws is None else ws.data_ptr(),
             None if cnt is None else cnt.data_ptr(), M, N16, K, plan["bm"],
             plan["splits"], stream)
    check_launch(err, W4A16.name)
    W4A16.add()
    return out if N16 == N else out[:, :N].contiguous()


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
    if K % 8:
        raise ValueError(f"w8a16 kernel needs K % 8 == 0 (16-byte rows of "
                         f"x), got K={K}")
    _check_kernel_operands("w8a16", x, q=q, s=s)
    return _launch_w8a16(x, q, s, x.shape[0] <= W8_DECODE_MAX_ROWS)


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
    return _launch_w4a16(x, packed, scales, x.shape[0] <= W4_DECODE_MAX_ROWS)


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
