"""The Hopper int8 matmul's plan, tile walk, transpose pass and order of
sums, on the CPU.

The kernels of ``csrc/i8_matmul.cu`` (``i8_transpose``, then the
persistent TMA + wgmma product ``i8_sm90``) run only on the GPU, where
``chip_smoke.py`` holds them exactly against ``matmul_i8i8i32_plain``.
What surrounds their arithmetic is Python that these tests reach, and a
mirror of it:

- ``i8_plan`` against the source's constants: the 128 x 256 tile over 128
  k a stage, 4 stages, CTA pairs, 384 threads, the shared memory, the
  grid (one CTA an SM in whole pairs, never more than the work units) and
  the column group;
- the persistent walk: every (row block, column block, k stage) of the
  output visited exactly once at ragged M, N and K;
- the transpose pass: the source's byte permutations applied in numpy to
  every 4 x 4 block give w^T, bit for bit;
- the order of sums: ``i8_mirror`` adds the k stages (zero past K, as TMA
  reads them) in int32 and is held bit for bit (tolerance 0: an int32 sum
  is exact while K < 2^17) against JAX's ``make_matmul_i8i8i32`` in
  interpret mode, at K = 48 and 1040 (off the 128-deep stage) and at
  ragged M and N, and with every entry at -128 (the largest sums);
- the w^T scratch (kept per stream, grown, the old buffer kept alive);
- the ``--i8`` bench CLI on the CPU.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from leetcuda_tpu.gemm import quant as jq
from leetcuda_tpu_torch.gemm import matmul as tmm
from leetcuda_tpu_torch.gemm import quant as tq

SRC = Path(tq.__file__).parent.parent / "csrc" / "i8_matmul.cu"
RAGGED = ((1000, 48, 272), (1000, 1040, 2064), (200, 2048, 3072),
          (16, 2048, 2048), (129, 160, 256), (8192, 8192, 8192),
          (16384, 2048, 11264))


def _macro(src, name):
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def test_plan_is_the_sources():
    src = SRC.read_text()
    tile = {"block_m": 128, "block_n": _macro(src, "LC_I8_BN"),
            "block_k": 128, "stages": _macro(src, "LC_I8_STAGES"),
            "cluster": _macro(src, "LC_I8_CLUSTER")}
    assert tile == tq.I8_TILE
    assert "static constexpr int BM = 128, BN = BN_, BK = 128;" in src
    assert "THREADS = 128 * (1 + kCons)" in src and "kCons = 2" in src
    assert "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8" in src
    assert "#define LC_I8_PROBE 0" in src
    p = tq.i8_plan(8192, 8192, 8192)
    assert p["threads"] == 384 and p["k_stages"] == 64
    # the stages (x's 128 x 128 box, w^T's 256 x 128), 1024 bytes of
    # alignment and the ring's barriers: the source's SMEM_BYTES
    assert p["smem"] == 1024 + 4 * (128 * 128 + 256 * 128) + 8 * (2 * 4 + 2)
    assert p["smem"] <= 232448
    assert p["tiles"] == (64, 32) and p["units"] == 32 * 32
    assert p["grid"] == 132 and p["group"] == tmm.HALF_GROUP
    assert p["scratch"] == 8192 * 8192


@pytest.mark.parametrize("M,K,N", RAGGED)
@pytest.mark.parametrize("ctas", [132, 7, 2])
def test_grid_in_whole_pairs(M, K, N, ctas):
    p = tq.i8_plan(M, N, K, ctas)
    assert p["grid"] % p["cluster"] == 0 and 2 <= p["grid"] <= ctas
    assert p["grid"] <= p["units"] * p["cluster"]
    nbn = -(-N // 256)
    assert p["group"] == (tmm.HALF_GROUP if nbn >= tmm.GROUP_MIN_COLS else 0)


def i8_walk(M, N, K, plan):
    """The (row block, column block, k stage) of every stage the kernel's
    CTAs load, in the source's walk: CTA b of pair b // cluster takes units
    b // cluster, + grid / cluster, ...; unit u is tile_ij(u) of the pair
    grid, the CTA's rank its row block within the pair."""
    bm, bn, c = plan["block_m"], plan["block_n"], plan["cluster"]
    nbm, nbn = -(-M // bm), -(-N // bn)
    ni, units = -(-nbm // c), plan["units"]
    seen = []
    for b in range(plan["grid"]):
        for u in range(b // c, units, plan["grid"] // c):
            I, j = tmm.tile_ij(u, ni, nbn, plan["group"] or None)
            i = I * c + b % c
            if i < nbm:  # a pair's row block past M loads zeros, stores none
                seen += [(i, j, k) for k in range(plan["k_stages"])]
    return seen, (nbm, nbn, plan["k_stages"])


@pytest.mark.parametrize("M,K,N", RAGGED[:5])
@pytest.mark.parametrize("ctas", [132, 6])
def test_walk_visits_every_stage_once(M, K, N, ctas):
    plan = tq.i8_plan(M, N, K, ctas)
    seen, dims = i8_walk(M, N, K, plan)
    assert len(seen) == len(set(seen)) == int(np.prod(dims))


def byte_perm(a, b, sel):
    """__byte_perm(a, b, sel): byte i of the result is byte (sel >> 4 i) & 7
    of the 8 bytes {b, a} (a's in the low four)."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [
        (b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def transpose_block(rows):
    """The source's registers: four rows of w (4 columns each, little
    endian words) -> four columns of 4 k each."""
    r = [int.from_bytes(bytes(row), "little") for row in rows]
    t0, t1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[0], r[1], 0x7362)
    u0, u1 = byte_perm(r[2], r[3], 0x5140), byte_perm(r[2], r[3], 0x7362)
    cols = [byte_perm(t0, u0, 0x5410), byte_perm(t0, u0, 0x7632),
            byte_perm(t1, u1, 0x5410), byte_perm(t1, u1, 0x7632)]
    return [list(c.to_bytes(4, "little")) for c in cols]


def test_transpose_pass_permutations():
    src = SRC.read_text()
    for sel in ("0x5140", "0x7362", "0x5410", "0x7632"):
        assert sel in src
    rng = np.random.default_rng(0)
    w = rng.integers(0, 256, (48, 32), dtype=np.uint8)
    wt = np.zeros((32, 48), np.uint8)
    for k in range(0, 48, 4):
        for n in range(0, 32, 4):
            cols = transpose_block(w[k:k + 4, n:n + 4])
            for q in range(4):
                wt[n + q, k:k + 4] = cols[q]
    assert np.array_equal(wt, w.T)


def i8_mirror(x, w, plan):
    """The product's order of sums in numpy: x and w^T padded with zeros to
    whole tiles and k stages (TMA's zero fill), each output tile summed in
    int32 over its k stages, four k32 steps a stage, in order."""
    M, K = x.shape
    N = w.shape[1]
    bm, bn, bk = plan["block_m"], plan["block_n"], plan["block_k"]
    nbm, nbn, nk = -(-M // bm), -(-N // bn), plan["k_stages"]
    xp = np.zeros((nbm * bm, nk * bk), np.int64)
    xp[:M, :K] = x
    wtp = np.zeros((nbn * bn, nk * bk), np.int64)
    wtp[:N, :K] = w.T
    out = np.zeros((nbm * bm, nbn * bn), np.int64)
    seen, _ = i8_walk(M, N, K, plan)
    for i, j, k in seen:
        for kk in range(bk // 32):
            k0 = k * bk + 32 * kk
            a = xp[i * bm:(i + 1) * bm, k0:k0 + 32]
            b = wtp[j * bn:(j + 1) * bn, k0:k0 + 32]
            out[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] += a @ b.T
    # every partial sum fits an int32 (|sum| <= K * 2^14 < 2^31)
    assert np.abs(out).max() < 2 ** 31
    return out[:M, :N].astype(np.int32)


def _jax_i8(x, w):
    import jax.numpy as jnp

    M, K = x.shape
    bk = 16 if K % 128 else 128
    fn = jq.make_matmul_i8i8i32(block=(min(128, M), min(128, w.shape[1]),
                                       bk))
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("M,K,N", [(64, 48, 272), (200, 1040, 144),
                                   (129, 160, 256), (8, 256, 16)])
def test_mirror_is_jax_bit_for_bit(M, K, N):
    rng = np.random.default_rng(M + K + N)
    x = rng.integers(-128, 128, (M, K), dtype=np.int8)
    w = rng.integers(-128, 128, (K, N), dtype=np.int8)
    got = i8_mirror(x, w, tq.i8_plan(M, N, K, 8))
    assert np.array_equal(got, _jax_i8(x, w))
    # the wrapper's plain version on CPU tensors: the same values
    assert np.array_equal(got, tq.matmul_i8i8i32(
        torch.from_numpy(x), torch.from_numpy(w)).numpy())


def test_mirror_at_the_largest_sums():
    M, K, N = 32, 1040, 48
    x = np.full((M, K), -128, np.int8)
    w = np.full((K, N), -128, np.int8)
    got = i8_mirror(x, w, tq.i8_plan(M, N, K))
    assert (got == K * 128 * 128).all()
    assert np.array_equal(got, _jax_i8(x, w))


def test_wrapper_refusals_on_cpu():
    f = tq.matmul_i8i8i32
    with pytest.raises(ValueError):
        f(torch.zeros(4, 24, dtype=torch.int8),
          torch.zeros(24, 16, dtype=torch.int8))
    with pytest.raises(ValueError):
        f(torch.zeros(4, 16, dtype=torch.int8),
          torch.zeros(16, 20, dtype=torch.int8))
    with pytest.raises(ValueError):
        f(torch.zeros(4, 16), torch.zeros(16, 16, dtype=torch.int8))


def test_scratch_grows_and_keeps_the_old_buffer():
    dev, key = torch.device("cpu"), (None, 12345)
    tq._I8_SCRATCH.pop(key, None)
    retired = len(tq._I8_RETIRED)
    a = tq._i8_scratch(dev, 12345, 100)
    assert a.numel() == 100 and a.dtype == torch.int8
    assert tq._i8_scratch(dev, 12345, 64) is a
    b = tq._i8_scratch(dev, 12345, 150)
    assert b.numel() == 200 and tq._I8_RETIRED[-1] is a
    assert len(tq._I8_RETIRED) == retired + 1
    tq._I8_SCRATCH.pop(key)
    del tq._I8_RETIRED[retired:]


def test_i8_bench_cli_on_cpu(tmp_path):
    out = tmp_path / "i8.json"
    root = Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-m",
                        "leetcuda_tpu_torch.bench.gemm_bench", "--i8",
                        "--device", "cpu", "--iters", "2", "--json",
                        str(out)], cwd=root, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    rows = json.loads(out.read_text())["rows"]
    assert rows and rows[0]["max_abs_err"] == 0.0
