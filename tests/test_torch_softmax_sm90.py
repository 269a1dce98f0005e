"""The Hopper row softmax's plan, row cut and order of sums, on the CPU.

The cluster route of ``csrc/row_ops.cu`` (``softmax_cluster``) and its
stream route (``softmax_kernel``) run only on the GPU, where
``chip_smoke.py`` holds them against the plain versions and runs each
twice, bit for bit. What surrounds their arithmetic is Python that these
tests reach, and a mirror of it:

- ``softmax_plan``: the route, the cluster size (the fewest CTAs that hold
  the row, grown while a small batch leaves SMs idle), the bytes a thread
  holds and the grid, with the source's constants read by regex;
- the row cut (``softmax_rank_words``): the head, each rank's words and the
  tail cover every element of a row exactly once, at K = 2050, 4001 and
  32000, at every row start off a word boundary and at cluster sizes that
  do not divide the words;
- the order of sums: ``softmax_mirror`` repeats the kernel's f32 steps in
  numpy (a thread's elements in order, head first and tail last, each
  warp's xor tree, the warps in order, then the ranks' (max, sum) pairs
  merged in rank order; numpy's exp where the kernel's is ex2.approx, a
  few ulp apart) and is held against JAX's ``make_safe_softmax``,
  ``make_online_softmax`` and ``make_softmax`` in interpret mode at their
  registry tolerances in f32, f16 and bf16, and against a float64 softmax;
- the naive form's overflow: NaN exactly where JAX's is;
- the ``--softmax`` bench CLI on the CPU.
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

from leetcuda_tpu.ops import softmax as jsm
from leetcuda_tpu_torch.core.runtime import SM_COUNT, cdiv
from leetcuda_tpu_torch.ops import rowwise as rw
from leetcuda_tpu_torch.ops import softmax as tsm

SRC = Path(tsm.__file__).parent.parent / "csrc" / "row_ops.cu"
F32 = np.float32
# dtype: (torch, jax, numpy, itemsize)
DTYPES = {"f32": (torch.float32, jnp.float32, F32, 4),
          "f16": (torch.float16, jnp.float16, np.float16, 2),
          "bf16": (torch.bfloat16, jnp.bfloat16, ml_dtypes.bfloat16, 2)}
# the registry's tolerances (safe f32 1e-5, online f32 1e-5, naive f32
# 1e-4, the f16 rungs 1e-2; bf16 as f16)
TOL = {("safe", "f32"): 1e-5, ("online", "f32"): 1e-5,
       ("naive", "f32"): 1e-4}
JAX = {"safe": jsm.make_safe_softmax, "online": jsm.make_online_softmax,
       "naive": jsm.make_softmax}
MODES = {"safe": tsm.SAFE, "online": tsm.ONLINE, "naive": tsm.NAIVE}



@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # beside JAX's thread pool in a test worker, torch's CPU softmax at 2
    # or 8 threads came off float64 by up to ~1e-5 now and then (the same
    # input again: ~1e-8); one thread did not in 14 runs of the file
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

def test_constants_are_the_sources():
    src = SRC.read_text()
    assert "constexpr int kSmThreads = LC_SOFTMAX_THREADS;" in src
    assert int(re.search(r"#define LC_SOFTMAX_THREADS (\d+)", src)
               .group(1)) == tsm.SM_THREADS
    assert int(re.search(r"constexpr int kSmMaxCluster = (\d+);", src)
               .group(1)) == tsm.SM_MAX_CLUSTER
    nbs = sorted({int(n) for n in re.findall(
        r"if \(nb == (\d+)\) return softmax_call", src)})
    assert tuple(nbs) == tsm.SM_BYTES
    # every (dtype, word) a rung asks for is instantiated
    inst = {(dt, int(lb)) for dt, lb in re.findall(
        r"LC_SM_NB\((float|__half|__nv_bfloat16), (\d+)\)", src)}
    size = {"float": 4, "__half": 2, "__nv_bfloat16": 2}
    for name in ("f32", "f32x4", "f16_f32", "f16x2_f32", "f16x8_pack_f32",
                 "f32x4_pack"):
        r = rw.rung(name)
        for dt in ("float", "__half", "__nv_bfloat16"):
            assert (dt, rw.load_bytes(r["vec"], r["pack"], size[dt])) in inst
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in src


@pytest.mark.parametrize("S,K,itemsize,lb,want", [
    (2048, 32000, 4, 16, (4, 128)),   # the vocabulary's logits
    (8, 32000, 4, 16, (16, 32)),      # a decode step's: 128 CTAs
    (8, 32000, 2, 16, (8, 32)),       # bf16: 16 CTAs would keep < 4 KB
    (16384, 2048, 4, 16, (1, 32)),    # training's rows: one CTA a row
    (16384, 2048, 4, 4, (1, 32)),     # the scalar f32 rung
    (16384, 2048, 2, 2, (1, 16)),     # the scalar f16 rung
    (64, 4001, 4, 16, (2, 32)),       # 64 rows: grown to 128 CTAs
    (64, 256, 4, 16, (1, 16)),        # make_args: 1 KB rows stay whole
    (1, 1, 4, 16, (1, 16)),
])
def test_plan(S, K, itemsize, lb, want):
    p = tsm.softmax_plan(S, K, itemsize, lb)
    assert p["route"] == "cluster"
    assert (p["cluster"], p["nb"]) == want
    assert p["loads"] == p["nb"] // lb
    # the persistent grid: what the device holds at once, one cluster a
    # row at most; every row taken by one cluster, in order
    assert p["clusters"] == min(S, tsm.default_active(p["cluster"],
                                                      p["nb"]))
    assert p["grid"] == p["clusters"] * p["cluster"]
    rows = tsm.cluster_rows(p, S)
    assert sorted(r for rs in rows for r in rs) == list(range(S))
    assert all(rs == sorted(rs) and rs for rs in rows)
    assert max(map(len, rows)) - min(map(len, rows)) <= 1
    words = cdiv(K, lb // itemsize)
    C = p["cluster"]
    # the CTAs hold every word; one CTA fewer (C / 2) would not, unless C
    # grew to fill the card, and then the growth kept 4 KB a CTA
    assert cdiv(words, C) <= tsm.SM_THREADS * p["loads"]
    if C > 1 and cdiv(words, C // 2) <= tsm.SM_THREADS * 128 // lb:
        assert S * C // 2 < SM_COUNT
        assert cdiv(words, C) * lb >= tsm.SM_MIN_SLICE
    # and the fewest bytes a thread that hold the rank's words
    smaller = [b for b in tsm.SM_BYTES if b < p["nb"]]
    assert all(tsm.SM_THREADS * (b // lb) < cdiv(words, C) for b in smaller)


def test_stream_route_past_sixteen_ctas():
    # 16 CTAs x 256 threads x 128 bytes = 512 KB a row
    assert tsm.softmax_plan(4, 131072, 4, 16)["route"] == "cluster"
    assert tsm.softmax_plan(4, 131073, 4, 16) == {"route": "stream",
                                                  "grid": 4}
    # a device that holds 3 clusters of 4 at once: 2048 rows over them
    p = tsm.softmax_plan(2048, 32000, 4, 16, active=lambda C, nb: 3)
    assert (p["cluster"], p["clusters"], p["grid"]) == (4, 3, 12)
    assert tsm.softmax_plan(4, 262144, 2, 16)["route"] == "cluster"
    assert tsm.softmax_plan(4, 262145, 2, 16)["route"] == "stream"
    # a device that schedules clusters of 8 at most
    assert tsm.softmax_plan(4, 65537, 4, 16, max_cluster=8)["route"] == \
        "stream"
    assert tsm.softmax_plan(8, 32000, 4, 16, max_cluster=8)["cluster"] == 8
    with pytest.raises(ValueError):
        tsm.softmax_plan(8, 32000, 4, 16, cluster=2)


def thread_elements(K, itemsize, lb, C, offset):
    """[rank] -> (256, L) int array of the elements each thread holds, in
    the kernel's order (head, words, tail), -1 past a thread's last."""
    E = lb // itemsize
    head, ranks, tail = tsm.softmax_rank_words(K, itemsize, lb, C, offset)
    tail0 = K - tail
    out = []
    for r, (v0, n) in enumerate(ranks):
        nl = cdiv(n, tsm.SM_THREADS)
        idx = np.full((tsm.SM_THREADS, 2 + nl * E), -1, np.int64)
        for t in range(tsm.SM_THREADS):
            if r == 0 and t < head:
                idx[t, 0] = t
            for i in range(nl):
                v = i * tsm.SM_THREADS + t
                if v < n:
                    idx[t, 1 + i * E:1 + (i + 1) * E] = (
                        head + (v0 + v) * E + np.arange(E))
            if r == C - 1 and t < tail:
                idx[t, -1] = tail0 + t
        out.append(idx)
    return out


@pytest.mark.parametrize("K", [1, 3, 7, 2050, 4001, 32000])
@pytest.mark.parametrize("itemsize,lb", [(4, 16), (4, 4), (2, 16), (2, 4)])
@pytest.mark.parametrize("C", [1, 3, 8, 16])
def test_every_element_once(K, itemsize, lb, C):
    E = lb // itemsize
    for offset in range(E):
        head, ranks, tail = tsm.softmax_rank_words(K, itemsize, lb, C,
                                                   offset)
        assert 0 <= head < max(E, 1) and 0 <= tail < E
        assert (offset + head) % E == 0 or head == K  # words start aligned
        per = max(n for _, n in ranks)
        assert all(n <= per for _, n in ranks)
        # ranks' words consecutive from 0 to the last whole word
        assert ranks[0][0] == 0
        assert all(a[0] + a[1] == b[0] for a, b in zip(ranks, ranks[1:]))
        cols = np.concatenate([i[i >= 0] for i in
                               thread_elements(K, itemsize, lb, C, offset)])
        assert sorted(cols.tolist()) == list(range(K))


def fold_sum(parts):
    """(..., 256) f32 -> (...,): each warp's xor tree, then the warps' sums
    in warp order from 0 (row_ops.cu block_sum)."""
    *lead, n = parts.shape
    v = parts.reshape(*lead, n // 32, 32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., np.arange(32) ^ o]).astype(F32)
    t = np.zeros(lead, F32)
    for w in range(n // 32):
        t = (t + v[..., w, 0]).astype(F32)
    return t


def md_merge(m, d, m2, d2):
    """row_ops.cu md_merge in f32 over arrays of rows."""
    mx = np.maximum(m, m2)
    empty = mx == -np.inf
    with np.errstate(invalid="ignore", over="ignore"):
        nd = (d * np.exp((m - mx).astype(F32)) + (d2 * np.exp(
            (m2 - mx).astype(F32))).astype(F32)).astype(F32)
    return np.where(empty, m, mx).astype(F32), np.where(empty, d, nd)


def softmax_mirror(x, mode, itemsize, lb, cluster=None, offset=0):
    """The cluster route's output for x (S, K), f32 values of the dtype, by
    the kernel's f32 steps; row r starts ``offset + r K`` elements past an
    lb-aligned address. Left in f32 (the caller rounds)."""
    S, K = x.shape
    E = lb // itemsize
    C = (cluster or tsm.softmax_plan(S, K, itemsize, lb)["cluster"])
    out = np.empty((S, K), F32)
    with np.errstate(over="ignore", invalid="ignore"):
        for off in range(E):
            rows = np.nonzero((offset + np.arange(S) * K) % E == off)[0]
            if not len(rows):
                continue
            X = x[rows]
            M = np.full(len(rows), -np.inf, F32)
            D = np.zeros(len(rows), F32)
            for idx in thread_elements(K, itemsize, lb, C, off):
                live = idx >= 0
                V = X[:, np.where(live, idx, 0)]  # (rows, 256, L)
                if mode == "naive":
                    m = np.zeros(len(rows), F32)
                else:
                    m = np.where(live, V, -np.inf).max(axis=(1, 2)).astype(
                        F32)
                acc = np.zeros(V.shape[:2], F32)
                for k in range(V.shape[2]):
                    e = np.exp((V[:, :, k] - m[:, None]).astype(F32))
                    acc = np.where(live[:, k], (acc + e).astype(F32), acc)
                M, D = md_merge(M, D, m, fold_sum(acc))
            q = np.exp((X - M[:, None]).astype(F32))
            if mode == "online":
                o = q * (F32(1) / D)[:, None]
            else:
                o = q / D[:, None]
            out[rows] = o.astype(F32)
    return out


def _draw(rng, S, K, ndt, scale=2.0):
    return (rng.standard_normal((S, K)) * scale).astype(ndt).astype(F32)


CASES = [(37, 4001, None), (5, 2050, 3), (8, 3000, 8), (3, 4000, 16),
         (64, 256, None)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("form", list(MODES))
@pytest.mark.parametrize("S,K,C", CASES,
                         ids=[f"S{s}-K{k}-C{c}" for s, k, c in CASES])
def test_mirror_matches_jax(S, K, C, form, dt):
    tdt, jdt, ndt, itemsize = DTYPES[dt]
    tol = TOL.get((form, dt), 1e-2)
    rng = np.random.default_rng(S * K)
    x = _draw(rng, S, K, ndt)
    lb = 16  # the default forms' 16-byte words
    # JAX gets copies (jnp.array): its kernel aliases its input to its
    # output, and jnp.asarray may share x's buffer on the CPU
    for offset in (0, 1):
        got = softmax_mirror(x, form, itemsize, lb, C, offset).astype(ndt)
        want = np.asarray(JAX[form]()(jnp.array(x, jdt)), F32)
        np.testing.assert_allclose(got.astype(F32), want, atol=tol,
                                   rtol=tol)
    # the same function as the port's plain version and as float64
    plain = tsm.PLAIN[MODES[form]](torch.from_numpy(x)).numpy()
    f64 = np.exp(x.astype(np.float64) - (0 if form == "naive" else x.max(
        axis=1, keepdims=True)))
    f64 /= f64.sum(axis=1, keepdims=True)
    got32 = softmax_mirror(x, form, itemsize, lb, C)
    np.testing.assert_allclose(got32, plain, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got32, f64, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", [
    "softmax_f32_per_token", "safe_softmax_f32x4_per_token",
    "safe_softmax_f16_f32_per_token", "safe_softmax_f16x2_f32_per_token",
    "online_safe_softmax_f32"])
def test_rung_words_mirror_matches_jax(name):
    """A rung's narrower words (4 or 8 bytes, 2-byte scalars) cut the row
    otherwise; the sums stay within the rung's tolerance of JAX's."""
    from leetcuda_tpu.core.registry import OPS as JOPS
    from leetcuda_tpu_torch.core.registry import OPS

    spec, jspec = OPS[name], JOPS[name]
    half = "f16" in name
    ndt, jdt, itemsize = ((np.float16, jnp.float16, 2) if half
                          else (F32, jnp.float32, 4))
    r = rw.rung(name.split("_per_token")[0].split("softmax_")[-1])
    lb = rw.load_bytes(r["vec"], r["pack"], itemsize)
    x = _draw(np.random.default_rng(3), 16, 2050, ndt)
    form = "online" if "online" in name else (
        "naive" if name.startswith("softmax") else "safe")
    got = softmax_mirror(x, form, itemsize, lb, None, 1).astype(ndt)
    want = np.asarray(jspec.fn(jnp.array(x, jdt)), F32)
    np.testing.assert_allclose(got.astype(F32), want, atol=spec.atol,
                               rtol=spec.rtol)


def _rn32(x):
    """The f32 nearest to the rational x, ties to even."""
    from fractions import Fraction

    c = np.float32(float(x))
    cands = (c, np.nextafter(c, F32(np.inf)), np.nextafter(c, F32(-np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v, F32).view(np.uint32))
                                     & 1))


def test_safe_division_rounds_as_ieee():
    """row_ops.cu div_by_sum, the safe form's q / d (y = q r with r = 1 / d
    rounded to nearest, then y + r (q - d y), each fma rounded once), in
    exact rational arithmetic equals the IEEE quotient for q = exp(x - m)
    in [e^-80, 1] and d, the row's sum, in [1, 32000]."""
    from fractions import Fraction as Fr

    rng = np.random.default_rng(23)
    q = np.exp(rng.uniform(-80, 0, 3000)).astype(F32)
    d = np.exp(rng.uniform(0, np.log(32000), 3000)).astype(F32)
    q[:4], d[:4] = (1, 1, F32(2) ** -60, 0.5), (1, 3, 7, 1)
    d[3] = np.nextafter(F32(2), F32(0))  # significand all ones
    for qi, di in zip(q, d):
        r = _rn32(1 / Fr(float(di)))
        y = _rn32(Fr(float(qi)) * Fr(float(r)))
        e = _rn32(Fr(float(qi)) - Fr(float(di)) * Fr(float(y)))
        got = _rn32(Fr(float(e)) * Fr(float(r)) + Fr(float(y)))
        assert got == F32(qi) / F32(di), (qi, di)


def test_naive_overflow_nan_where_jax():
    x = _draw(np.random.default_rng(0), 64, 4001, F32)
    x[1, 7], x[2, :3] = 100.0, 95.0
    got = softmax_mirror(x, "naive", 4, 16)
    want = np.asarray(jsm.make_softmax()(jnp.array(x)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).sum() == 1 and np.isnan(got[2]).sum() == 3
    assert (got[1][~np.isnan(got[1])] == 0).all()
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               atol=1e-4, rtol=1e-4)
    for form in ("safe", "online"):
        assert not np.isnan(softmax_mirror(x, form, 4, 16)).any()


def test_softmax_bench_cli(tmp_path):
    out = tmp_path / "rows.json"
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.gemm_bench",
         "--softmax", "--device", "cpu", "--iters", "1", "--json",
         str(out)], capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(out.read_text())["rows"]
    assert [(row["S"], row["K"]) for row in rows] == [(32, 500), (1, 500)]
    assert all(row["variant"] == "plain" and row["max_abs_err"] == 0
               for row in rows)
