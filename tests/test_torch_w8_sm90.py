"""The Hopper w8a16 kernel's routes, split plan, byte conversion and split
sum, on the CPU.

The kernels of ``csrc/wq_matmul.cu`` (TMA + wgmma: split-K at decode rows;
at prefill rows a pass converting the weight to bf16, then the dense
matmul's persistent kernel) run only on the GPU, where ``chip_smoke.py``
holds them against ``matmul_w8a16_plain``. What surrounds its arithmetic is Python
that these tests reach, and mirrors of its arithmetic:

- ``w8_plan``: the route is the wrapper's threshold on M, the decode
  stages and the prefill tile are the source's defaults (the wrapper also
  compares them with the library's ``lc_wq_matmul_info`` on the card), the shared memory fits, the splits cover K's 64-row stages
  once, in order, none empty, and the grid and workspace follow;
- the byte -> bf16 conversion: ``convert_mirror`` repeats the kernel's
  steps in numpy (int8: the byte with its sign bit flipped under the f32
  pattern 0x4B000000, less 2^23 + 128; e4m3: the hardware's exact decode to
  f16, then f32, then bf16 rounded to nearest even) for all 256 bytes of
  each format, against JAX's casts and the TPU kernel's ``e4m3_bits_to_f32``
  (NaN for 0x7F and 0xFF, and nowhere else), and no value is rounded;
- the split sum: ``split_sum_mirror`` repeats the decode route's order (per
  split an f32 dot over its stages, the partials summed in split order,
  then the scale, then one rounding) and is held against JAX's
  ``make_matmul_w8a16`` in interpret mode at M = 1, 8, 9, 72 and 200 for
  int8 and e4m3, each element within the f32 reordering bound of a K-term
  dot plus half a bf16 ulp of each side's output.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from leetcuda_tpu.core.runtime import e4m3_bits_to_f32
from leetcuda_tpu.gemm import quant as jq
from leetcuda_tpu_torch.gemm import matmul as tmm
from leetcuda_tpu_torch.gemm import quant as gq

SRC = Path(gq.__file__).parent.parent / "csrc" / "wq_matmul.cu"
# paths (a) and (b)'s weight shapes (K, N): wqkv, wo, w_gate_up, w_down;
# and two ragged ones
KN = [(2048, 3072), (2048, 2048), (2048, 11264), (5632, 2048), (264, 520),
      (776, 48)]
ROWS = [1, 8, 9, 16, 32, 33, 64, 72, 128, 384, 1024, 12288]


def test_route_and_build_are_the_sources_defaults():
    src = SRC.read_text()
    macro = {k: int(v) for k, v in
             re.findall(r"#define (LC_W8_\w+) (\d+)", src)}
    assert macro == {"LC_W8_STAGES": gq.W8_STAGES, "LC_W8_PROBE": 0}
    tile = re.findall(
        r"using Prefill = GemmPlan<(\d+), (\d+), (\d+), (\d+)", src)
    t = gq.W8_PREFILL_TILE
    assert [tuple(int(v) for v in m) for m in tile] == [
        (t["block_m"], t["block_n"], t["stages"], t["cluster"])]
    for M in ROWS:
        route = gq.w8_plan(M, 2048, 2048)["route"]
        assert route == ("decode" if M <= gq.W8_DECODE_MAX_ROWS
                         else "prefill"), M


@pytest.mark.parametrize("K,N", KN, ids=[f"{k}x{n}" for k, n in KN])
def test_plan_covers_k_once_and_fits(K, N):
    nk = -(-K // 64)
    n16 = -(-N // 16) * 16
    for M in ROWS:
        for decode in (True, False):
            for ctas in (None, 64, 132):
                p = gq.w8_plan(M, N, K, decode, ctas=ctas)
                assert p["smem"] <= 232448
                if not decode:
                    t = gq.W8_PREFILL_TILE
                    row_pairs = -(-(-(-M // t["block_m"])) // 2)
                    units = row_pairs * -(-n16 // t["block_n"])
                    cap = 132 if ctas is None else ctas
                    assert p["units"] == units
                    assert p["grid"] == min(cap // 2, units) * 2
                    assert p["splits"] == 1 and p["workspace"] == 0
                    assert p["wbuf"] == K * n16
                    # the tile columns grouped as pick_matmul_config groups
                    # the dense kernel's
                    wide = -(-n16 // t["block_n"]) >= tmm.GROUP_MIN_COLS
                    assert p["group"] == (tmm.HALF_GROUP if wide else 0)
                    continue
                spans = p["split_stages"]
                assert len(spans) == p["splits"] == p["grid"][2]
                # whole stages, in order, none empty, covering [0, nk)
                assert spans[0][0] == 0 and spans[-1][1] == nk
                assert all(a < b for a, b in spans)
                assert all(spans[i][1] == spans[i + 1][0]
                           for i in range(len(spans) - 1))
                assert p["bm"] in (8, 16, 32, 64)
                assert p["bm"] >= min(M, 64)
                assert p["grid"][:2] == (-(-n16 // 128), -(-M // p["bm"]))
                tiles = p["grid"][0] * p["grid"][1]
                want = min(nk, -(-gq.W8_SPLIT_CTAS // tiles))
                assert want / 2 <= p["splits"] <= want
                assert p["workspace"] == (p["splits"] * M * n16
                                          if p["splits"] > 1 else 0)
                assert p["counters"] == (tiles if p["splits"] > 1 else 0)


def test_decode_route_fills_the_card_at_every_weight():
    # at a decode step's 8 rows, the narrow projections (N = 2048: 16 column
    # tiles) split K into as many CTAs as the wide w_gate_up gets
    wide = gq.w8_plan(8, 11264, 2048)
    ctas = wide["grid"][0] * wide["grid"][1] * wide["grid"][2]
    for K, N in [(2048, 2048), (5632, 2048), (2048, 3072)]:
        p = gq.w8_plan(8, N, K)
        assert p["grid"][0] * p["grid"][1] * p["grid"][2] >= 0.9 * ctas


def _bf16_bits(f32):
    """f32 -> bf16 bit patterns, round to nearest even (NaN kept NaN)."""
    b = f32.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(f32), np.uint16(0x7FC0), r)


def convert_mirror(fmt):
    """The kernel's conversion of bytes 0..255: (bf16 bits, the f32 before
    the bf16 rounding)."""
    b = np.arange(256, dtype=np.uint32)
    if fmt == "int8":
        f = ((b ^ 0x80) | 0x4B000000).view(np.float32) - np.float32(8388736.0)
    else:  # e4m3 -> f16 (the hardware cvt), exactly, then f32
        s, e, m = b >> 7, (b >> 3) & 0xF, b & 7
        mag = np.where(e == 0, m * 2.0 ** -9,
                       (1 + m / 8.0) * 2.0 ** (e.astype(np.float64) - 7))
        mag = np.where((e == 15) & (m == 7), np.nan, mag)
        f = np.where(s == 1, -mag, mag).astype(np.float16).astype(np.float32)
    return _bf16_bits(f), f.astype(np.float32)


@pytest.mark.parametrize("fmt", ["int8", "e4m3"])
def test_byte_conversion_is_exact(fmt):
    bits, f = convert_mirror(fmt)
    raw = np.arange(256, dtype=np.uint8)
    if fmt == "int8":
        want = np.asarray(jnp.asarray(raw.view(np.int8)).astype(jnp.bfloat16))
        ref = raw.view(np.int8).astype(np.float32)
    else:
        want = np.asarray(jnp.asarray(raw.view(ml_dtypes.float8_e4m3fn))
                          .astype(jnp.bfloat16))
        ref = np.asarray(e4m3_bits_to_f32(
            jnp.asarray(raw.view(np.int8).astype(np.int32))))
    nan = np.isnan(f)
    assert np.array_equal(nan, np.isnan(want.astype(np.float32)))
    assert np.array_equal(nan, np.isnan(ref))
    if fmt == "e4m3":  # 0x7F and 0xFF, and nothing else
        assert list(np.flatnonzero(nan)) == [0x7F, 0xFF]
    else:
        assert not nan.any()
    # every other byte: the same value as JAX's cast and the TPU decode, and
    # nothing rounded on the way to bf16
    ok = ~nan
    assert np.array_equal(bits[ok], want.view(np.uint16)[ok])
    assert np.array_equal(f[ok], ref[ok])
    assert not (f[ok].view(np.uint32) & 0xFFFF).any()


def split_sum_mirror(x, w, s, spans):
    """The decode route's arithmetic in its order, in f32 numpy: per split
    the dot over its 64-row stages, the partials summed in split order, the
    scale, one rounding to bf16 (as bits)."""
    parts = [x[:, a * 64:b * 64] @ w[a * 64:b * 64] for a, b in spans]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return _bf16_bits(acc * s)


@pytest.mark.parametrize("fmt", ["int8", "e4m3"])
@pytest.mark.parametrize("M", [1, 8, 9, 72, 200])
def test_split_sum_mirror_matches_jax(M, fmt):
    rng = np.random.default_rng(M)
    K, N = 1024, 256
    wf = rng.standard_normal((K, N)).astype(np.float32) * 0.02
    quant = (jq.quantize_rowwise_int8 if fmt == "int8"
             else jq.quantize_rowwise_fp8)
    q, s = (np.asarray(a) for a in quant(jnp.asarray(wf)))
    wd = q.astype(np.float32)  # exact: int8 and e4m3 values
    # bf16-representable activations, as the kernel takes them
    x = np.asarray(jnp.asarray(rng.standard_normal((M, K), np.float32))
                   .astype(jnp.bfloat16)).astype(np.float32)
    want = np.asarray(jq.make_matmul_w8a16(block=(256, 256, 256))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(s)))
    assert want.dtype == jnp.bfloat16
    want = want.astype(np.float32)
    exact = (x.astype(np.float64) @ wd.astype(np.float64)) * s
    # f32 reordering of a K-term dot, times the scale, plus the two
    # roundings to bf16 (half an ulp each side: 2^-8 relative each)
    tol = (2 * K * 2.0 ** -24 * (np.abs(x) @ np.abs(wd)) * np.abs(s)
           + 2.0 ** -7 * np.abs(exact) + 1e-30)
    for decode in (True, False):
        plan = gq.w8_plan(M, N, K, decode)
        spans = plan["split_stages"] if decode else [(0, K // 64)]
        if decode:  # the decode route splits K here
            assert plan["splits"] > 1
        got = split_sum_mirror(x, wd, s, spans)
        got = got.view(ml_dtypes.bfloat16).astype(np.float32)
        assert np.all(np.abs(got - want) <= tol), (
            decode, float(np.max(np.abs(got - want) - tol)))
    # the port's plain version (what the wrapper runs on CPU tensors) agrees
    plain = gq.matmul_w8a16(torch.from_numpy(x).to(torch.bfloat16),
                            torch.from_numpy(q.view(np.int8)).view(
                                torch.int8 if fmt == "int8"
                                else torch.float8_e4m3fn),
                            torch.from_numpy(s)).float().numpy()
    assert np.all(np.abs(plain - want) <= tol)
