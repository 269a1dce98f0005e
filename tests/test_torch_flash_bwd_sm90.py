"""The Hopper backward's plan, band walk and delta fold, on the CPU.

The dQ and dK/dV kernels of ``csrc/flash_bwd.cu`` (TMA + wgmma) run only on
the GPU, where ``chip_smoke.py`` holds them against
``flash_attention_bwd_plain``. What surrounds their arithmetic is Python
that these tests reach:

- ``bwd_plan``: each kernel's tiles, stages, threads, grid and shared
  memory at head dims 64, 128 and 256 (every configuration, the defaults
  and the bench's variants, within the 227 KiB a block may use);
- the band walk: ``key_range`` / ``row_range`` give the tiles a CTA walks,
  a consumer warpgroup skips the tiles outside its own range and masks
  only those ``dq_edge`` / ``dkv_edge`` flag. Walked over ragged Nq and Nk,
  Nq != Nk, causal or not, windows on and off a tile edge, every (row, key)
  pair of the band is visited exactly once by each kernel, no pair outside
  it, and no walked tile lies wholly outside the band;
- the delta fold's plain version ``_delta`` (what the dQ kernel writes for
  the dK/dV launch) against JAX's delta (flash_bwd.py:176-179) in
  jax.numpy, with and without ``dlse``: both f32 sums of bf16 products in
  another order, held at rtol 1e-6 and atol 1e-5 (D = 128 products of unit
  terms: ~1e-6 of roundoff).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu_torch.attention import flash_bwd as fb
from leetcuda_tpu_torch.bench.attn_bench import BWD_VARIANTS, variant_plan


def _band(Nq, Nk, causal, window):
    rows = np.arange(Nq)[:, None]
    cols = np.arange(Nk)[None, :]
    keep = np.ones((Nq, Nk), bool)
    if causal or window:
        keep &= cols <= rows
    if window:
        keep &= rows - cols < window
    return keep


# --- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("D", [64, 128, 256])
def test_plan_fits_and_grids(D):
    p = fb.bwd_plan(D, B=2, H=16, Hkv=4, Nq=1000, Nk=777)
    dq, dkv = p["dq"], p["dkv"]
    assert dq["smem"] <= fb.SMEM_LIMIT and dkv["smem"] <= fb.SMEM_LIMIT
    assert dq["grid"] == (-(-1000 // dq["rows"]), 32)
    assert dkv["grid"] == (-(-777 // dkv["keys"]), 8)
    # the 64-row (dQ) consumer warpgroups alone, at most 8 warps: two a
    # register partition, 255 registers a thread
    assert dq["threads"] == 128 * (dq["rows"] // 64)
    assert dq["threads"] <= 256 and dkv["threads"] <= 256
    assert dq["keys"] % 16 == 0 and dkv["rows"] % 16 == 0
    assert dkv["split"] == (D == 256)
    assert 2 <= dq["stages"] <= 3 and 2 <= dkv["stages"] <= 3


@pytest.mark.parametrize("D", [64, 128, 256])
def test_every_bench_variant_fits(D):
    for v in BWD_VARIANTS:
        dq_plan, dkv_plan = variant_plan(v, D)
        p = fb.bwd_plan(D, dq_plan=dq_plan, dkv_plan=dkv_plan)
        assert p["dq"]["smem"] <= fb.SMEM_LIMIT, (v, D)
        assert p["dkv"]["smem"] <= fb.SMEM_LIMIT, (v, D)


def test_plan_is_the_sources_default():
    """DQ_PLAN / DKV_PLAN are what csrc/flash_bwd.cu builds without macros
    (the wrapper also compares them with the library's lc_flash_bwd_plan on
    the card)."""
    import re
    from pathlib import Path

    src = (Path(fb.__file__).parent.parent / "csrc"
           / "flash_bwd.cu").read_text()
    macro = {k: int(v) for k, v in
             re.findall(r"#define (LC_BWD_\w+) (\d+)", src)}
    assert macro == {"LC_BWD_STAGES": 0, "LC_BWD_DQ_KEYS": 128,
                     "LC_BWD_DKV_ROWS": 0, "LC_BWD_D256_DQ_CONS": 1,
                     "LC_BWD_PROBE": 0}
    assert variant_plan({}, 128) == (fb.DQ_PLAN[128], fb.DKV_PLAN[128])
    for D in (64, 128, 256):
        assert variant_plan({}, D) == (fb.DQ_PLAN[D], fb.DKV_PLAN[D])


# --- the band walk -----------------------------------------------------------

def walk_dq(Nq, Nk, causal, window, rows, keys):
    """Visits of (row, key) by the dQ kernel: CTAs of ``rows`` q rows walk
    the key tiles of key_range over their rows; each 64-row warpgroup
    computes a tile that meets its own range, masked where dq_edge says."""
    seen = np.zeros((Nq, Nk), np.int32)
    wasted = 0
    for q0 in range(0, Nq, rows):
        lo, hi = fb.key_range(q0, q0 + rows, Nq, Nk, causal, window)
        for kt in fb.band_tiles(lo, hi, keys):
            k0 = kt * keys
            for r0 in range(q0, q0 + rows, 64):
                lo_w, hi_w = fb.key_range(r0, r0 + 64, Nq, Nk, causal,
                                          window)
                if not (k0 < hi_w and k0 + keys > lo_w):
                    continue
                r = np.arange(r0, min(r0 + 64, Nq))[:, None]
                c = np.arange(k0, min(k0 + keys, Nk))[None, :]
                band = _band(Nq, Nk, causal, window)[r, c]
                if fb.dq_edge(r0, k0, keys, Nq, Nk, causal, window):
                    hit = band
                else:  # no mask: every pair of the tile must be kept
                    assert band.all(), (r0, k0)
                    hit = np.ones_like(band)
                wasted += not band.any()
                seen[r, c] += hit
    return seen, wasted


def walk_dkv(Nq, Nk, causal, window, keys, rows_q, split, group=2):
    """Visits of (row, key) by the dK/dV kernel over ``group`` q heads (each
    adds one per pair: the dK/dV sums run over the group)."""
    seen = np.zeros((Nq, Nk), np.int32)
    wasted = 0
    for k0 in range(0, Nk, keys):
        lo, hi = fb.row_range(k0, k0 + keys, Nq, Nk, causal, window)
        for _ in range(group):
            for qt in fb.band_tiles(lo, hi, rows_q):
                q0 = qt * rows_q
                for c0 in range(k0, k0 + keys, 64):
                    lo_w, hi_w = fb.row_range(c0, c0 + 64, Nq, Nk, causal,
                                              window)
                    if not split and not (q0 < hi_w and q0 + rows_q > lo_w):
                        continue
                    r = np.arange(q0, min(q0 + rows_q, Nq))[:, None]
                    c = np.arange(c0, min(c0 + 64, Nk))[None, :]
                    band = _band(Nq, Nk, causal, window)[r, c]
                    if fb.dkv_edge(q0, rows_q, c0, Nq, Nk, causal, window):
                        hit = band
                    else:
                        assert band.all(), (q0, c0)
                        hit = np.ones_like(band)
                    wasted += not band.any()
                    seen[r, c] += hit
    return seen // group, wasted


SHAPES = [(300, 300), (300, 200), (200, 333), (1000, 1000), (64, 64),
          (65, 129)]
MASKS = [(False, 0), (True, 0), (True, 64), (True, 100), (True, 4096),
         (True, 1)]


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal,window", MASKS,
                         ids=[f"c{int(c)}w{w}" for c, w in MASKS])
@pytest.mark.parametrize("Nq,Nk", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
def test_band_walk_visits_each_pair_once(Nq, Nk, causal, window, D):
    p = fb.bwd_plan(D)
    want = _band(Nq, Nk, causal, window).astype(np.int32)
    seen, wasted = walk_dq(Nq, Nk, causal, window, p["dq"]["rows"],
                           p["dq"]["keys"])
    np.testing.assert_array_equal(seen, want)
    assert wasted == 0
    seen, wasted = walk_dkv(Nq, Nk, causal, window, p["dkv"]["keys"],
                            p["dkv"]["rows"], p["dkv"]["split"])
    np.testing.assert_array_equal(seen, want)
    assert wasted == 0


def test_walk_without_the_mask_is_caught():
    """The walk's check can fail: a tile flagged maskless on the causal
    diagonal leaks pairs above it."""
    real = fb.dq_edge
    try:
        fb.dq_edge = lambda *a: False
        with pytest.raises(AssertionError):
            walk_dq(300, 300, True, 0, 128, 64)
    finally:
        fb.dq_edge = real


def test_band_tiles_skip_whole_tiles():
    # window 100 at row tile [256, 384): keys from 157, tiles 2.. of 64
    lo, hi = fb.key_range(256, 384, 1000, 1000, True, 100)
    assert (lo, hi) == (157, 384)
    assert list(fb.band_tiles(lo, hi, 64)) == [2, 3, 4, 5]
    # keys [128, 192) under window 100 are kept by rows [128, 291)
    assert fb.row_range(128, 192, 1000, 1000, True, 100) == (128, 291)
    # rows past Nq, keys past Nk: empty ranges
    assert list(fb.band_tiles(*fb.key_range(300, 428, 300, 300, True, 0),
                              64)) == []
    assert list(fb.band_tiles(*fb.row_range(256, 320, 300, 200, True, 0),
                              64)) == []


# --- the delta fold --------------------------------------------------------

@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_delta_matches_jax(D, with_dlse):
    rng = np.random.default_rng(D + with_dlse)
    shape = (2, 3, 37, D)
    out = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        torch.bfloat16)
    dlse = (rng.standard_normal(shape[:3], np.float32) if with_dlse
            else None)
    got = fb._delta(out, do, None if dlse is None else torch.from_numpy(dlse))
    jo = jnp.asarray(out.float().numpy()).astype(jnp.bfloat16)
    jd = jnp.asarray(do.float().numpy()).astype(jnp.bfloat16)
    want = jnp.sum(jd.astype(jnp.float32) * jo.astype(jnp.float32), axis=-1)
    if dlse is not None:
        want = want - jnp.asarray(dlse).astype(jnp.float32)
    assert got.dtype == torch.float32 and got.shape == shape[:3]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def delta_lanes(out, do):
    """rowsum(do * out) in f32 as the dQ kernel sums it: each of a row's
    D / 8 lanes adds its 8 products in order, then a butterfly of
    xor-shuffles (lane 0's value)."""
    x = (out.float() * do.float()).numpy().astype(np.float32)
    L = x.shape[-1] // 8
    lanes = x.reshape(x.shape[:-1] + (L, 8))
    parts = np.zeros(x.shape[:-1] + (L,), np.float32)
    for j in range(8):
        parts += lanes[..., j]
    m = L // 2
    while m:
        parts = parts + parts[..., np.arange(L) ^ m]
        m //= 2
    return torch.from_numpy(parts[..., 0].copy())


def test_delta_in_the_kernels_order():
    """``delta_lanes`` sums as the dQ kernel does (8 products a lane, then
    a butterfly over the D / 8 lanes of a row): within f32 roundoff of
    ``_delta``, so the 1e-5 bar the card holds the kernel's delta to covers
    the order."""
    rng = np.random.default_rng(7)
    for D in (64, 128, 256):
        out = torch.from_numpy(rng.standard_normal((4, 50, D), np.float32)
                               ).to(torch.bfloat16)
        do = torch.from_numpy(rng.standard_normal((4, 50, D), np.float32)
                              ).to(torch.bfloat16)
        want = fb._delta(out, do, None)
        got = delta_lanes(out, do)
        rel = float((got - want).norm() / want.norm())
        assert rel <= 1e-6, (D, rel)


# --- the bench -------------------------------------------------------------

def test_variant_builds_are_libraries_of_their_own():
    from leetcuda_tpu_torch import build

    plain = build._lib_path("flash_bwd")
    paths = [build._lib_path("flash_bwd", tuple(
        f"-D{k}={v}" for k, v in sorted(d.items()))) for d in BWD_VARIANTS]
    assert paths[0] == plain and BWD_VARIANTS[0] == {}  # the package's own
    assert len(set(paths)) == len(BWD_VARIANTS)
    assert all("-variant-" in p.name for p in paths[1:])


def test_attn_bench_cli(tmp_path):
    import json
    import subprocess
    import sys

    out = tmp_path / "rows.json"
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.attn_bench", "--bwd",
         "--device", "cpu", "--shape", "1", "2", "1", "64", "64", "--rounds",
         "1", "--iters", "1", "--json", str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(out.read_text())["rows"]
    # on the CPU only the plain backward runs, once a case, exact
    assert [row["case"] for row in rows] == ["d128", "d256", "cap"]
    assert all(row["variant"] == "plain backward" and row["rel_l2"] == 0.0
               for row in rows)
