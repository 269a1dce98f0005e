"""The Hopper elementwise map's plan, walk and half-type math, on the CPU.

``csrc/elementwise.cu``'s map (the add and the seven activations) runs only
on the GPU, where ``chip_smoke.py`` path (m) holds every rung against the
plain versions (the add bit for bit). What surrounds it is Python that these
tests reach, and a mirror of its math:

- ``map_plan``: the head / body / tail split, the grid (one pass over
  exactly the vectors, a CTA a chunk) and the source's constants;
- ``map_walk``: every element visited once, by one thread, at n below, at
  and above a few chunks, from an aligned base and one element off it, at
  each of the map's rungs of vector and load width;
- the ``--map`` bench CLI on the CPU;
- the SFU forms that f16 and bf16 outputs take (exp as ex2.approx.ftz,
  1 / d as rcp.approx keeping subnormal results, tanh as tanh.approx): a
  numpy mirror of each changed activation, with every approximation
  pushed to its documented error bound both ways, held against JAX's
  activations in Pallas interpret mode and against the port's plain
  versions at the registry's tolerance (atol 2e-2, rtol 1e-2), over a
  dense sweep and the special values.
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

from leetcuda_tpu.ops import activations as jact
from leetcuda_tpu_torch.ops import activations as tact
from leetcuda_tpu_torch.ops import elementwise as tew

SRC = Path(tew.__file__).parent.parent / "csrc" / "elementwise.cu"
F32 = np.float32
HALF = {"f16": (np.float16, jnp.float16, torch.float16),
        "bf16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}
TOL = dict(atol=2e-2, rtol=1e-2)  # the registry's for f16 / bf16 outputs
# documented relative error bounds of the SFU forms (PTX ISA), rounded up:
# ex2.approx.f32 2^-22, rcp.approx.f32 ~1 ulp, tanh.approx.f32 2^-10.987
EX2_ERR, RCP_ERR, TANH_ERR = 2.0 ** -21, 2.0 ** -22, 2.0 ** -10.9
SPECIALS = (np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 0.25,
            3.0, -3.0, 6.0, -6.0, 9.0, -9.0, 88.0, 88.5, -88.0, -88.5, 100.0,
            -100.0, 1e30, -1e30, 1e-30, -1e-30)


def test_plan_is_the_sources():
    src = SRC.read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) \
        == tew.MAP_THREADS
    assert int(re.search(r"#define LC_MAP_LOADS (\d+)", src).group(1)) \
        == tew.MAP_LOADS
    # vectors a step: 4 of one load each; one of several loads (the f32
    # 8-wide rungs', the unpacked ones')
    for (vec, itemsize, lb), u in {(8, 2, 16): 4, (8, 4, 16): 1,
                                   (8, 2, 4): 1, (8, 4, 4): 1, (4, 4, 16): 4,
                                   (1, 2, 2): 4, (2, 4, 8): 4}.items():
        assert tew.map_unroll(vec, itemsize, lb) == u
    assert re.search(r"#define LC_MAP_FAST 1\b", src)
    assert "FAST ? tanh_approx(x) : tanhf(x)" in src
    # (16384, 5632) bf16 in 16-byte vectors: one pass, 4 vectors a thread
    p = tew.map_plan(16384 * 5632, 2, 8, 16)
    assert (p["head"], p["nvec"], p["tail"]) == (0, 16384 * 5632 // 8, 0)
    assert p["grid"] == p["chunks"] == p["nvec"] // (4 * 256) == 11264
    # a chunk short of its vectors, past a head of 7
    p = tew.map_plan(3 * 130, 2, 8, 16, base=2)
    assert (p["grid"], p["head"], p["nvec"], p["tail"]) == (1, 7, 47, 7)
    assert tew.map_plan(10 ** 7, 4, 4, 16)["grid"] == \
        -(-(10 ** 7 // 4) // (4 * 256))
    # no whole vector: one CTA for the head and the tail
    assert tew.map_plan(5, 2, 8, 16)["grid"] == 1
    # the kernel's CTA c takes chunks c, c + grid, ...: one each
    assert "for (; c < chunks; c += gridDim.x)" in src


# the map's rungs (itemsize, elements a vector, bytes a load), as
# ops/flat.py rung_bytes gives them
RUNGS = ((2, 8, 16), (2, 8, 4), (2, 4, 8), (2, 1, 2), (4, 4, 16), (4, 8, 16),
         (4, 8, 4), (4, 2, 8))


def _walk_cases():
    chunk = tew.MAP_THREADS * 4  # vectors a chunk at 4 vectors a step
    for itemsize, vec, lb in RUNGS:
        for n in (1, 13, 1000, 6 * chunk * vec - 3, 6 * chunk * vec,
                  6 * chunk * vec + 5, int(3.5 * 6 * chunk * vec) + 11):
            for off in (0, 1):
                yield itemsize, vec, lb, n, off


@pytest.mark.parametrize("itemsize,vec,lb,n,off", list(_walk_cases()))
def test_walk_visits_every_element_once(itemsize, vec, lb, n, off):
    p = tew.map_plan(n, itemsize, vec, lb, base=4096 + off * itemsize)
    walk = tew.map_walk(p, vec)
    seen = np.zeros(n, np.int64)
    for elems in walk.values():
        seen[elems] += 1
    assert (seen == 1).all()
    E = lb // itemsize
    assert p["head"] == min(n, (E - off % E) % E)
    assert p["head"] + p["nvec"] * vec + p["tail"] == n
    assert 0 <= p["tail"] < vec + E
    # one pass, a CTA a chunk, every CTA's chunk but the last whole, so no
    # sweep trails half empty
    chunk = p["unroll"] * tew.MAP_THREADS
    assert p["chunks"] == -(-p["nvec"] // chunk)
    assert p["grid"] == max(1, p["chunks"])
    body = np.zeros(p["grid"], np.int64)
    for (c, _), elems in walk.items():
        body[c] += sum(p["head"] <= e < p["head"] + p["nvec"] * vec
                       for e in elems)
    assert (body[:-1] == chunk * vec).all()
    # a warp's loads: 32 consecutive vectors
    for (c, t), elems in list(walk.items())[:64]:
        body = [e for e in elems if p["head"] <= e < p["head"] + p["nvec"] * vec]
        if body:
            v = (body[0] - p["head"]) // vec
            assert v % tew.MAP_THREADS == t


# --- the half-type math, mirrored ----------------------------------------


def _f32(a):
    return np.asarray(a, np.float64).astype(F32)


def _clip(x, lo, hi):
    """clip with NaN passed through (both compares false)."""
    return np.where(x < lo, F32(lo), np.where(x > hi, F32(hi), x))


def _ftz(e):
    """ex2.approx.ftz's flush: results below 2^-126 become 0."""
    return np.where(np.abs(e) < np.finfo(F32).tiny, F32(0), e)


def sigmoid_fast(x, d):
    """rcp.approx(1 + ex2.approx.ftz(-clip(x) log2 e)), each approximation
    off by d times its bound."""
    a = _f32(-_clip(x, -88.0, 88.0) * F32(1.4426950408889634))
    e = _ftz(_f32(np.exp2(a.astype(np.float64)) * (1 + d * EX2_ERR)))
    return _f32(1.0 / _f32(F32(1) + e).astype(np.float64)
                * (1 + d * RCP_ERR))


def tanh_fast(v, d):
    """tanh.approx: off by d times its bound, and +-1 exactly where f32's
    tanh is (past |9|; the chip check holds gelu at -1e4 .. -9.5 to -0)."""
    t = _f32(np.tanh(v.astype(np.float64)) * (1 + d * TANH_ERR))
    return np.where(np.abs(v) > 9, np.sign(v).astype(F32), np.clip(t, -1, 1))


def gelu_fast(x, d):
    inner = _f32(F32(0.7978845608028654)
                 * _f32(x + _f32(_f32(_f32(F32(0.044715) * x) * x) * x)))
    return _f32(_f32(F32(0.5) * x) * _f32(F32(1) + tanh_fast(inner, d)))


def swish_fast(x, d):
    return _f32(x * sigmoid_fast(x, d))


def elu_fast(x, d):
    e = _ftz(_f32(np.exp2(_f32(x * F32(1.4426950408889634)).astype(
        np.float64)) * (1 + d * EX2_ERR)))
    return np.where(x > 0, x, _f32(e - F32(1)))


FAST = {"sigmoid": sigmoid_fast, "gelu": gelu_fast, "swish": swish_fast,
        "elu": elu_fast}


def _inputs(ndt):
    """A dense sweep over [-120, 120], the values near each form's knees,
    and the special values, as the dtype's numbers in a (rows, 1024)
    array."""
    sweep = np.concatenate([np.linspace(-120, 120, 40001),
                            np.linspace(-10, 10, 20001), SPECIALS])
    n = -(-sweep.size // 1024) * 1024
    x = np.resize(sweep, n).astype(ndt)
    return x.reshape(-1, 1024)


@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("name", sorted(FAST))
def test_fast_math_within_tolerance(name, dt):
    ndt, jdt, tdt = HALF[dt]
    x = _inputs(ndt)
    xf = x.astype(F32)
    want = np.asarray(getattr(jact, name)(jnp.asarray(x, jdt))).astype(F32)
    plain = tact.activation_plain(tact.ACTIVATIONS[name],
                                  torch.from_numpy(xf).to(tdt)).float().numpy()
    nan = np.isnan(want)
    # JAX's f32 flushes denormals: its swish(-inf) is -inf * 0 = NaN, the
    # port's -inf (tests/test_torch_elementwise.py states it)
    ftz = np.isneginf(xf) if name == "swish" else np.zeros_like(nan)
    for d in (-1, 0, 1):
        with np.errstate(over="ignore", invalid="ignore"):
            got = FAST[name](xf, d).astype(ndt).astype(F32)
        np.testing.assert_array_equal(np.isnan(got), nan & ~ftz)
        assert np.isneginf(got[ftz]).all()
        np.testing.assert_allclose(got[~nan], want[~nan], **TOL)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
        ok = ~np.isnan(plain)
        np.testing.assert_allclose(got[ok], plain[ok], **TOL)


def test_fast_sigmoid_keeps_denormals():
    """At the clamp (-88) the reciprocal, without .ftz, keeps sigmoid's
    6.05e-39, so swish(-inf) stays -inf as in f32 (a flushed reciprocal
    would give -inf * 0 = NaN); the exp's flush changes nothing, since 1 +
    2^-126.96 is 1 in f32."""
    x = np.array([-88.0, -np.inf], F32)
    s = sigmoid_fast(x, 0)
    assert 0 < s[0] < np.finfo(F32).tiny and s[1] == s[0]
    assert np.isneginf(swish_fast(x, 0)[1])
    assert sigmoid_fast(np.array([88.0], F32), 0)[0] == 1
    with np.errstate(invalid="ignore"):
        assert np.isnan(F32(-np.inf) * F32(0))


def test_map_bench_cli(tmp_path):
    out = tmp_path / "rows.json"
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.gemm_bench",
         "--map", "--device", "cpu", "--iters", "1", "--json",
         str(out)], capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(out.read_text())["rows"]
    assert [(row["case"], row["S"], row["K"]) for row in rows] == [
        ("swish", 16, 88), ("gelu", 16, 88), ("add", 16, 32)]
    assert all(row["variant"] == "plain" and row["max_abs_err"] == 0
               for row in rows)
