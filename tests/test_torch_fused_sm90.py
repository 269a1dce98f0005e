"""The Hopper fused decode entry block's plan, cover, RoPE pairs and order of
sums, on the CPU.

The kernel of ``csrc/fused_decode.cu`` (a cluster of CTAs a panel of 64
columns, each rank over a slice of K, the ranks' sums added in rank 0's
shared memory) runs only on the GPU, where ``chip_smoke.py`` holds it
against ``fused_norm_qkv_rope_plain`` / ``fused_norm_matmul_plain`` and
runs it twice, bit for bit. What surrounds its arithmetic is Python that
these tests reach, and a mirror of it:

- ``fused_plan``: the panel, the row tiles, the cluster size (the most
  ranks whose grid fits one wave) at ModelConfig's ``wqkv``, Gemma-2-9B's
  layer 0 and ``w_gate_up``, with the source's constants read by regex;
- the cover: every (row, column, k) exactly once across row tiles, panels
  and ranks, at B = 1, 4, 8, 16 and 17, head dims 64, 128 and 256 and a
  ragged norm -> matmul;
- the RoPE pairs: columns i and i + Dh/2 of a head share their panel;
- the order of sums: ``fused_mirror`` repeats the kernel's steps in numpy
  (a lane's words of x by fmaf, the warp's xor tree; xhat and the norm
  weight's product in bf16; each k16 step's product added to its k
  group's f32 sum, the groups in order, the ranks in order; the product
  rounded to bf16 before the RoPE in f32, rounded again) and is held
  against JAX's ``make_fused_norm_qkv_rope`` / ``make_fused_norm_matmul``
  in interpret mode at head dims 64, 128 and 256, with and without the
  (1 + w) offset, at tests/test_torch_fused.py's bf16 tolerance (3e-2: one
  bf16 ulp at the outputs' magnitude of 2-4 is 1.6e-2);
- the ``--fused`` bench CLI on the CPU.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from leetcuda_tpu.gemm.fused_decode import (make_fused_norm_matmul,
                                            make_fused_norm_qkv_rope)
from leetcuda_tpu_torch.core.runtime import SM_COUNT
from leetcuda_tpu_torch.gemm import fused_decode as fd

SRC = Path(fd.__file__).parent.parent / "csrc" / "fused_decode.cu"
F32, BF16 = np.float32, ml_dtypes.bfloat16
TOL = dict(atol=3e-2, rtol=3e-2)
# (B, D, X): ModelConfig's wqkv, Gemma-2-9B's layer-0 wqkv, w_gate_up
MODEL = (8, 2048, 3072)
GEMMA = (8, 3584, 8192)
GATE_UP = (8, 2048, 11264)


def test_constants_are_the_sources():
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    def macro(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert const("kRowTile") == fd.ROW_TILE
    assert const("kMaxCluster") == fd.MAX_CLUSTER
    assert const("kMaxRows") == fd.MAX_ROWS
    assert (macro("LC_FUSED_BOX"), macro("LC_FUSED_ROWS"),
            macro("LC_FUSED_STAGES")) == (fd.BOX, fd.STAGE_ROWS, fd.STAGES)
    assert re.search(r"__launch_bounds__\(kThreads, (\d+)\)", src).group(
        1) == str(fd.CTAS_PER_SM)
    assert "head_dim != 64 && head_dim != 128 && head_dim != 256" in src
    assert fd.HEAD_DIMS == (64, 128, 256)
    assert "kRowTile * (kc + 8) * 2" in src  # fused_smem: x's slice
    assert fd._MAX_D == fd.MAX_CLUSTER * fd.MAX_ROWS
    # one design: the cluster split-K (no old panel walk, no switch)
    assert src.count("__global__") == 1
    assert "store_w" not in src and "cudaLaunchKernelEx" in src


def three_an_sm(C, kc):
    return 3 * SM_COUNT // C * C


def test_plans_fill_one_wave():
    # the wave where no device is asked: 2 CTAs an SM, 264
    p = fd.fused_plan(*MODEL)
    assert (p["panels"], p["cluster"], p["kc"], p["grid"]) == (48, 4, 512,
                                                               192)
    p = fd.fused_plan(*GEMMA)
    assert (p["panels"], p["cluster"], p["kc"], p["grid"]) == (128, 2, 1792,
                                                               256)
    p = fd.fused_plan(*GATE_UP)
    assert (p["panels"], p["cluster"], p["grid"]) == (176, 1, 176)
    # a device wave of 3 CTAs an SM takes more ranks
    assert fd.fused_plan(*MODEL, wave=three_an_sm)["cluster"] == 8
    assert fd.fused_plan(*GEMMA, wave=three_an_sm)["cluster"] == 3
    assert fd.fused_plan(*GATE_UP, wave=three_an_sm)["cluster"] == 2
    for B, D, X in (MODEL, GEMMA, GATE_UP):
        for wave in (fd.default_wave, three_an_sm):
            p = fd.fused_plan(B, D, X, wave=wave)
            C = p["cluster"]
            assert p["waves"] == 1 or C == 1
            assert p["kc"] % fd.STAGE_ROWS == 0 and C * p["kc"] >= D
            # more ranks would leave a rank empty or outgrow the wave
            for more in range(C + 1, fd.MAX_CLUSTER + 1):
                try:
                    q = fd.fused_plan(B, D, X, wave=wave, cluster=more)
                except ValueError:
                    continue
                assert q["grid"] > wave(more, q["kc"])
    # rows past a tile of 8 go to further row tiles
    assert fd.fused_plan(17, 2048, 3072)["tiles"] == 3
    # a cluster size the device cannot schedule is skipped
    p = fd.fused_plan(*MODEL, wave=lambda C, kc: 0 if C == 8 else
                      three_an_sm(C, kc))
    assert p["cluster"] == 6
    with pytest.raises(ValueError):
        fd.fused_plan(8, fd.MAX_CLUSTER * fd.MAX_ROWS + 8, 64)


def tile_rows(plan, B):
    return [list(range(t * fd.ROW_TILE, min(B, (t + 1) * fd.ROW_TILE)))
            for t in range(plan["tiles"])]


SHAPES = [(64, 1000, 4, 2), (128, 1000, 4, 2), (256, 520, 2, 1),
          (None, 1000, 1000, 0), (None, 2048, 11264, 0)]


@pytest.mark.parametrize("B", [1, 4, 8, 16, 17])
@pytest.mark.parametrize("Dh,D,H,Hkv", SHAPES,
                         ids=[f"Dh{s[0]}-D{s[1]}" for s in SHAPES])
@pytest.mark.parametrize("cluster", [None, 2, 3])
def test_every_row_column_and_k_once(B, Dh, D, H, Hkv, cluster):
    X = (H + 2 * Hkv) * Dh if Dh else H  # the matmul form's X in H
    plan = fd.fused_plan(B, D, X, cluster=cluster)
    rows = [r for t in tile_rows(plan, B) for r in t]
    assert rows == list(range(B))
    cols = [c for p in range(plan["panels"])
            for c in fd.panel_columns(p, Dh) if c < X]
    assert sorted(cols) == list(range(X)) and len(cols) == len(set(cols))
    ranks = fd.rank_rows(plan, D)
    assert all(len(r) for r in ranks)  # no rank empty
    assert [k for r in ranks for k in r] == list(range(D))
    assert plan["grid"] == plan["panels"] * plan["cluster"] * plan["tiles"]


@pytest.mark.parametrize("Dh", fd.HEAD_DIMS)
def test_rope_partners_share_a_panel(Dh):
    X, half = 6 * Dh, Dh // 2
    for p in range(X // (2 * fd.BOX)):
        cols = fd.panel_columns(p, Dh)
        for i in range(fd.BOX):
            c, partner = cols[i], cols[fd.BOX + i]
            assert partner == c + half and c // Dh == partner // Dh
            assert c % Dh < half
    # the matmul form's panels are 64 contiguous columns
    assert fd.panel_columns(3, None) == list(range(192, 256))


def fma(a, b, c):
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def bf(a):
    return np.asarray(a, F32).astype(BF16).astype(F32)


def warp_tree(parts):
    """(rows, 32) -> (rows,): the xor tree of a warp, lane 0's value."""
    v = parts.astype(F32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[:, np.arange(32) ^ o]).astype(F32)
    return v[:, 0]


def fused_mirror(x, nw, w, pos, plan, Dh=None, rope_end=0, theta=1e4,
                 eps=1e-5, offset=False):
    """The kernel's steps on bf16 values held as f32 arrays: x (B, D), nw
    (D,), w (D, X), pos (B,) -> (B, X) f32 holding bf16 values; the RoPE
    on the heads of ``Dh`` columns below ``rope_end``."""
    B, D = x.shape
    X = w.shape[1]
    lanes = np.zeros((B, 32), F32)
    for lane in range(32):
        for c in range(lane, D // 8, 32):
            for e in range(8):
                v = x[:, 8 * c + e]
                lanes[:, lane] = fma(v, v, lanes[:, lane])
    ss = warp_tree(lanes)
    rstd = (F32(1) / np.sqrt((ss / F32(D) + F32(eps)).astype(F32))
            ).astype(F32)
    wn = bf(F32(1) + nw) if offset else nw
    xn = bf(bf(x * rstd[:, None]) * wn)
    total = np.zeros((B, X), F32)
    for ks in fd.rank_rows(plan, D):
        acc = np.zeros((2, B, X), F32)  # the two k groups of a stage
        for k in range(ks.start, ks.stop, 16):
            j = (k - ks.start) % fd.STAGE_ROWS // 16
            k1 = min(k + 16, ks.stop)
            prod = xn[:, k:k1].astype(np.float64) @ w[k:k1].astype(
                np.float64)
            acc[j % 2] = (acc[j % 2] + prod.astype(F32)).astype(F32)
        total = (total + (acc[0] + acc[1]).astype(F32)).astype(F32)
    out = bf(total)
    if Dh is None:
        return out
    half = Dh // 2
    for h in range(rope_end // Dh):
        i = np.arange(half, dtype=F32)
        inv_freq = np.power(F32(theta), (-i / F32(half)).astype(F32),
                            dtype=F32)
        ang = (pos.astype(F32)[:, None] * inv_freq[None]).astype(F32)
        cs, sn = np.cos(ang).astype(F32), np.sin(ang).astype(F32)
        x1 = out[:, h * Dh:h * Dh + half]
        x2 = out[:, h * Dh + half:(h + 1) * Dh]
        y1 = (x1 * cs - x2 * sn).astype(F32)
        y2 = (x2 * cs + x1 * sn).astype(F32)
        out[:, h * Dh:h * Dh + half] = bf(y1)
        out[:, h * Dh + half:(h + 1) * Dh] = bf(y2)
    return out


def _operands(rng, B, D, X, offset):
    x = bf(rng.standard_normal((B, D)))
    nw = bf(rng.standard_normal(D) * 0.2 + (0.0 if offset else 1.0))
    w = bf(rng.standard_normal((D, X)) / np.sqrt(D))
    return x, nw, w


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("Dh", fd.HEAD_DIMS)
def test_mirror_matches_jax_qkv(Dh, offset):
    B, D, H, Hkv = 5, 640, 4, 2
    X = (H + 2 * Hkv) * Dh
    rng = np.random.default_rng(Dh + offset)
    x, nw, w = _operands(rng, B, D, X, offset)
    pos = np.array([0, 7, 300, 2047, 4999], np.int32)
    plan = fd.fused_plan(B, D, X, cluster=3)
    got = fused_mirror(x, nw, w, pos, plan, Dh=Dh, rope_end=(H + Hkv) * Dh,
                       offset=offset)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=Dh, eps=1e-5, theta=1e4,
              rms_offset=offset)
    want = make_fused_norm_qkv_rope(**kw)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw, jnp.bfloat16),
        jnp.asarray(w, jnp.bfloat16), jnp.asarray(pos))
    np.testing.assert_allclose(got, np.asarray(want, F32), **TOL)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, nw, w)]
    plain = fd.fused_norm_qkv_rope_plain(*t, torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(got, plain.float().numpy(), **TOL)
    # position 0 and the v heads are unrotated
    unroped = fused_mirror(x, nw, w, pos, plan, offset=offset)
    assert np.array_equal(got[0], unroped[0])
    assert np.array_equal(got[:, (H + Hkv) * Dh:],
                          unroped[:, (H + Hkv) * Dh:])


@pytest.mark.parametrize("offset", [False, True])
def test_mirror_matches_jax_norm_matmul(offset):
    B, D, X = 9, 1000, 1000
    rng = np.random.default_rng(11 + offset)
    x, nw, w = _operands(rng, B, D, X, offset)
    plan = fd.fused_plan(B, D, X, cluster=4)
    assert plan["tiles"] == 2 and X % plan["panel"]
    got = fused_mirror(x, nw, w, None, plan, offset=offset)
    want = make_fused_norm_matmul(rms_offset=offset)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw, jnp.bfloat16),
        jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_allclose(got, np.asarray(want, F32), **TOL)
    f64 = (x / np.sqrt((x.astype(np.float64) ** 2).mean(-1, keepdims=True)
                       + 1e-5) * ((1 + nw) if offset else nw)) @ w
    np.testing.assert_allclose(got, f64, **TOL)


def test_kernel_operand_checks():
    ok = torch.zeros((2, 520), dtype=torch.bfloat16)
    fd._check_kernel_operands("fused", ok, torch.zeros(520, dtype=ok.dtype),
                              torch.zeros((520, 64), dtype=ok.dtype))
    for D in (516, fd._MAX_D + 8):
        x = torch.zeros((1, D), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="D % 8"):
            fd._check_kernel_operands(
                "fused", x, torch.zeros(D, dtype=x.dtype),
                torch.zeros((D, 8), dtype=x.dtype))


def test_fused_bench_cli(tmp_path):
    out = tmp_path / "rows.json"
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.gemm_bench",
         "--fused", "--device", "cpu", "--iters", "1", "--json", str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(out.read_text())["rows"]
    assert [row["case"] for row in rows] == [
        "wqkv, ModelConfig", "wqkv, Gemma-2-9B layer 0",
        "w_gate_up, norm -> matmul"]
    assert all(row["variant"] == "plain" and row["max_abs_err"] == 0
               for row in rows)
