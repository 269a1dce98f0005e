"""The Hopper flash forward's plan and band walk, on the CPU.

The forward kernel of ``csrc/flash_fwd.cu`` (TMA + wgmma) runs only on the
GPU, where ``chip_smoke.py`` holds it against ``flash_attention_plain``.
What surrounds its arithmetic is Python that these tests reach:

- ``fwd_plan``: the tiles, stages, threads, grid and shared memory at head
  dims 64, 128 and 256 (the default and every bench variant within the
  227 KiB a block may use), and the plan against the source's macros;
- the band walk: a CTA walks the key tiles of ``key_range`` over its live
  rows (rows below the length) and the keys below the length, each
  64-row warpgroup computes the tiles that meet its own range and masks
  only those ``fwd_edge`` flags. Walked over ragged lengths, Nq != Nk,
  causal or not, windows on and off a tile edge, every (row, key) pair of
  the band is visited exactly once, no pair outside it, and no walked tile
  lies wholly outside the band; without a window the causal q tiles run
  heaviest first; a walk that never masks is caught.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from leetcuda_tpu_torch.attention import flash as fl
from leetcuda_tpu_torch.bench.attn_bench import FWD_VARIANTS, fwd_variant_plan


def _band(Nq, Nk, causal, window, live, kv_len):
    rows = np.arange(Nq)[:, None]
    cols = np.arange(Nk)[None, :]
    keep = (rows < live) & (cols < kv_len)
    if causal or window:
        keep &= cols <= rows
    if window:
        keep &= rows - cols < window
    return keep


# --- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("D", [64, 128, 256])
def test_fwd_plan_fits_and_grids(D):
    p = fl.fwd_plan(D, B=2, H=16, Nq=1000)
    assert p["smem"] <= fl.SMEM_LIMIT
    assert p["grid"] == (-(-1000 // p["rows"]), 32)
    # two 64-row consumer warpgroups and no producer warp: 8 warps, two a
    # register partition, 255 registers a thread
    assert p["threads"] == 128 * (p["rows"] // 64) == 256
    # a key tile is the N of an SS wgmma (S) and the K of the RS one (P V)
    assert p["keys"] in (64, 128)
    # the overlap releases a tile's stage one tile later
    assert p["stages"] >= 2
    for v in FWD_VARIANTS:
        q = fl.fwd_plan(D, plan=fwd_variant_plan(v, D))
        assert q["smem"] <= fl.SMEM_LIMIT and q["stages"] >= 2, (v, D)


def test_fwd_plan_is_the_sources_default():
    """FWD_PLAN is what csrc/flash_fwd.cu builds without macros (the wrapper
    also compares it with the library's lc_flash_fwd_plan on the card)."""
    src = (Path(fl.__file__).parent.parent / "csrc"
           / "flash_fwd.cu").read_text()
    macro = {k: int(v) for k, v in
             re.findall(r"#define (LC_FWD_\w+) (\d+)", src)}
    assert macro == {"LC_FWD_KEYS": 0, "LC_FWD_STAGES": 0,
                     "LC_FWD_OVERLAP": 1, "LC_FWD_PROBE": 0}
    for D in (64, 128, 256):
        assert fwd_variant_plan({}, D) == fl.FWD_PLAN[D]


# --- the band walk -----------------------------------------------------------

def walk_fwd(Nq, Nk, causal, window, lengths, rows, keys):
    """Visits of (b, row, key) by the forward: per batch row b, the CTAs of
    ``rows`` q rows in launch order (heaviest first) walk the key tiles of
    key_range over their live rows; each 64-row warpgroup computes a tile
    that meets its own range, masked where fwd_edge says. Returns the
    visits of live rows, the wasted (warpgroup, tile) pairs and, per batch
    row, the tiles each CTA walks in launch order."""
    B = len(lengths)
    seen = np.zeros((B, Nq, Nk), np.int32)
    wasted, order = 0, []
    for b, n in enumerate(lengths):
        seq_len = Nk if n is None else n
        kv_len = min(seq_len, Nk)
        live = Nq if n is None else min(Nq, seq_len)
        band = _band(Nq, Nk, causal, window, live, kv_len)
        walked = []
        for x in range(-(-Nq // rows)):
            q0 = (-(-Nq // rows) - 1 - x) * rows  # blockIdx.x reversed
            if q0 >= live:  # written as zeros, nothing loaded
                walked.append(0)
                continue
            lo, hi = fl.key_range(q0, q0 + rows, live, kv_len, causal, window)
            tiles = fl.band_tiles(lo, hi, keys)
            walked.append(len(tiles))
            for kt in tiles:
                k0 = kt * keys
                for r0 in range(q0, q0 + rows, 64):
                    lo_w, hi_w = fl.key_range(r0, r0 + 64, live, kv_len,
                                              causal, window)
                    if not (k0 < hi_w and k0 + keys > lo_w):
                        continue
                    r = np.arange(r0, min(r0 + 64, live))[:, None]
                    c = np.arange(k0, min(k0 + keys, Nk))[None, :]
                    tb = band[r, c]
                    if fl.fwd_edge(r0, k0, keys, kv_len, causal, window):
                        hit = tb
                    else:  # no mask: every live pair of the tile is kept
                        assert tb.all(), (b, r0, k0)
                        hit = np.ones_like(tb)
                    wasted += not tb.any()
                    seen[b][r, c] += hit
        order.append(walked)
    return seen, wasted, order


SHAPES = [(300, 300), (300, 200), (200, 333), (1000, 1000), (64, 64),
          (65, 129)]
MASKS = [(False, 0), (True, 0), (True, 64), (True, 100), (True, 4096),
         (True, 1)]


@pytest.mark.parametrize("ragged", [False, True], ids=["plain", "ragged"])
@pytest.mark.parametrize("causal,window", MASKS,
                         ids=[f"c{int(c)}w{w}" for c, w in MASKS])
@pytest.mark.parametrize("Nq,Nk", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
def test_band_walk_visits_each_pair_once(Nq, Nk, causal, window, ragged):
    """At each distinct plan (128-key tiles at head dims 64 and 128, 64-key
    at 256), with ragged lengths of 0, 1, a tile edge, a ragged middle and
    past Nk."""
    lengths = ([0, 1, 64, Nk // 2 + 7, Nk + 5] if ragged else [None])
    for D in (128, 256):
        p = fl.fwd_plan(D)
        seen, wasted, order = walk_fwd(Nq, Nk, causal, window, lengths,
                                       p["rows"], p["keys"])
        for b, n in enumerate(lengths):
            seq_len = Nk if n is None else n
            live = Nq if n is None else min(Nq, seq_len)
            want = _band(Nq, Nk, causal, window, live, min(seq_len, Nk))
            np.testing.assert_array_equal(seen[b], want.astype(np.int32))
        assert wasted == 0
        if causal and not window and not ragged:  # heaviest q tiles first
            assert order[0] == sorted(order[0], reverse=True)


def test_walk_without_the_mask_is_caught():
    """The walk's check can fail: a tile flagged maskless on the causal
    diagonal leaks pairs above it."""
    real = fl.fwd_edge
    try:
        fl.fwd_edge = lambda *a: False
        with pytest.raises(AssertionError):
            walk_fwd(300, 300, True, 0, [None], 128, 128)
    finally:
        fl.fwd_edge = real


def test_window_skips_whole_tiles():
    # window 100 at rows [256, 384): keys from 157, tiles 1-2 of 128
    lo, hi = fl.key_range(256, 384, 1000, 1000, True, 100)
    assert (lo, hi) == (157, 384)
    assert list(fl.band_tiles(lo, hi, 128)) == [1, 2]
    # a CTA past the live rows of a ragged row walks nothing
    assert list(fl.band_tiles(*fl.key_range(128, 256, 100, 100, True, 0),
                              128)) == []
    # rows of a ragged row walk only the keys below the length
    assert fl.key_range(0, 128, 50, 50, True, 0) == (0, 50)


# --- the bench -------------------------------------------------------------

def test_fwd_variant_builds_are_libraries_of_their_own():
    from leetcuda_tpu_torch import build

    plain = build._lib_path("flash_fwd")
    paths = [build._lib_path("flash_fwd", tuple(
        f"-D{k}={v}" for k, v in sorted(d.items()))) for d in FWD_VARIANTS]
    assert paths[0] == plain and FWD_VARIANTS[0] == {}  # the package's own
    assert len(set(paths)) == len(FWD_VARIANTS)


def test_attn_bench_fwd_cli(tmp_path):
    import json
    import subprocess
    import sys

    out = tmp_path / "rows.json"
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.attn_bench", "--fwd",
         "--device", "cpu", "--shape", "1", "2", "1", "64", "64", "--rounds",
         "1", "--iters", "1", "--json", str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(out.read_text())["rows"]
    # on the CPU only the plain forward runs, once a case, exact
    assert [row["case"] for row in rows] == ["d128", "lse", "gemma", "d256"]
    assert all(row["variant"] == "plain forward" and row["max_abs_err"] == 0
               for row in rows)
