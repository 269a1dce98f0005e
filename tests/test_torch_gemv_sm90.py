"""The Hopper gemv's plan, row and column cover and order of sums, on the
CPU.

The kernel of ``csrc/gemv.cu`` (``gemv_cluster``: one launch a call, a
cluster of CTAs a column panel, the ranks' sums added through distributed
shared memory) runs only on the GPU, where ``chip_smoke.py`` holds it
against ``gemv_plain`` and ``rms_norm_gemv_plain`` and runs it twice, bit
for bit. What surrounds its arithmetic is Python that these tests reach,
and a mirror of it:

- ``gemv_plan``: the panel, the cluster size (one CTA a panel where the
  panels alone cover the SMs, else the most that one wave holds), the rows
  a rank and the grid, with the source's constants read by regex;
- the cover: every (k, column) of W is summed exactly once, by one thread
  of one rank, at K and N that the cluster and the panel do not divide;
- the order of sums: ``gemv_mirror`` repeats the kernel's f32 steps in
  numpy (a thread's rows in order by fma, the k_lanes in order, the ranks
  in order; in the fused form the sum of squares of x by thread, each
  warp's xor tree and the warps in order) and is held against JAX's
  ``make_gemv`` and ``make_rms_norm_gemv`` in interpret mode in f32, f16
  and bf16, and against a float64 product;
- the ``--gemv`` bench CLI on the CPU.
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

from leetcuda_tpu.gemm import gemv as jgv
from leetcuda_tpu_torch.core.runtime import SM_COUNT
from leetcuda_tpu_torch.gemm import gemv as tgv

SRC = Path(tgv.__file__).parent.parent / "csrc" / "gemv.cu"
F32 = np.float32
DTYPES = {"f32": (jnp.float32, F32, 4, 1e-3),
          "f16": (jnp.float16, np.float16, 2, 3e-2),
          "bf16": (jnp.bfloat16, ml_dtypes.bfloat16, 2, 3e-2)}
# ModelConfig()'s projections of one decode row and the output projection
MODEL_KN = {"wqkv": (2048, 3072), "wo": (2048, 2048),
            "w_gate_up": (2048, 11264), "w_down": (5632, 2048),
            "lm_out": (2048, 32000)}



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

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert const("kThreads") == tgv.THREADS
    assert const("kMaxCluster") == tgv.MAX_CLUSTER
    assert const("kMaxRows") == tgv.MAX_ROWS
    assert re.search(r"__launch_bounds__\(kThreads, (\d+)\)", src).group(
        1) == str(tgv.CTAS_PER_SM)
    assert sorted(int(k) for k in re.findall(r"case (\d+):", src)) == \
        sorted(tgv.K_LANES)
    assert "gemv_finish" not in src  # one launch a call


@pytest.mark.parametrize("key", list(MODEL_KN))
def test_model_shapes_fill_one_wave(key):
    K, N = MODEL_KN[key]
    p = tgv.gemv_plan(K, N, 2)
    C = p["cluster"]
    assert p["panel"] == (256 // tgv.DEFAULT_K_LANES) * 8
    assert p["panels"] == -(-N // p["panel"])
    assert p["grid"] == p["panels"] * C
    assert p["wave"] == tgv.CTAS_PER_SM * SM_COUNT // C * C
    assert p["waves"] == -(-p["grid"] // p["wave"])
    assert p["kc"] % tgv.DEFAULT_K_LANES == 0 and C * p["kc"] >= K
    if p["panels"] >= SM_COUNT:  # every SM has a panel: K stays whole
        assert C == 1
    else:  # the most CTAs a panel that one wave holds
        assert p["waves"] == 1
        assert C == tgv.MAX_CLUSTER or p["panels"] * (C + 1) > \
            tgv.default_wave(C + 1, 0)


def test_plans_named_in_the_design():
    assert tgv.gemv_plan(2048, 11264, 2)["cluster"] == 1   # 176 panels
    assert tgv.gemv_plan(2048, 32000, 2)["cluster"] == 1   # 500 panels
    assert tgv.gemv_plan(5632, 2048, 2)["cluster"] == 8    # 256 CTAs
    assert tgv.gemv_plan(2048, 3072, 2)["cluster"] == 5    # 240 of 260
    # a device wave of 3 CTAs an SM holds 8 a panel at wqkv
    p = tgv.gemv_plan(2048, 3072, 2,
                      wave=lambda C, kc: 3 * SM_COUNT // C * C)
    assert p["cluster"] == 8 and p["grid"] == 384 <= p["wave"]
    # a cluster size the device cannot schedule is skipped
    p = tgv.gemv_plan(2048, 3072, 2,
                      wave=lambda C, kc: 0 if C == 5 else 264 // C * C)
    assert p["cluster"] == 4
    with pytest.raises(ValueError):
        tgv.gemv_plan(8 * tgv.MAX_ROWS + 1, 64, 2)


def thread_rows(plan, K, k_lanes):
    """{(rank, kl): rows} in the order the thread sums them."""
    out = {}
    for r, rows in enumerate(tgv.rank_rows(plan, K)):
        for kl in range(k_lanes):
            out[(r, kl)] = list(range(rows.start + kl, rows.stop, k_lanes))
    return out


@pytest.mark.parametrize("K,N,itemsize,k_lanes,C", [
    (1000, 200, 2, 32, 3), (2048, 3072, 2, 32, None), (5632, 2048, 2, 16, 8),
    (40, 16, 4, 128, None), (777, 36, 4, 32, 7), (256, 128, 2, 128, None)])
def test_every_k_and_column_once(K, N, itemsize, k_lanes, C):
    p = tgv.gemv_plan(K, N, itemsize, k_lanes, cluster=C)
    ranks = tgv.rank_rows(p, K)
    assert all(len(r) for r in ranks)  # no rank empty
    rows = thread_rows(p, K, k_lanes)
    got = sorted(k for ks in rows.values() for k in ks)
    assert got == list(range(K))
    vec, cc = 16 // itemsize, 256 // k_lanes
    cols = sorted(pan * p["panel"] + c * vec + v
                  for pan in range(p["panels"]) for c in range(cc)
                  for v in range(vec) if pan * p["panel"] + c * vec < N)
    assert cols == list(range(N))
    # rank 0 gathers every rank's panel sums in its shared memory
    assert 1 <= p["cluster"] <= tgv.MAX_CLUSTER


def fma(a, b, c):
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def fold_sum(parts):
    """(256,) f32 -> f32: each warp's xor tree, then the warps in order."""
    v = parts.reshape(8, 32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[:, np.arange(32) ^ o]).astype(F32)
    t = F32(0)
    for w in range(8):
        t = F32(t + v[w, 0])
    return t


def gemv_mirror(x, w, plan, k_lanes, nw=None, eps=1e-5):
    """y (N,) f32 by the kernel's steps: x, w (and nw) f32 arrays holding
    the dtype's values."""
    K, N = w.shape
    xs = x.astype(F32)
    if nw is not None:
        ss = np.zeros(256, F32)
        for t in range(256):
            for k in range(t, K, 256):
                ss[t] = fma(x[k], x[k], ss[t])
        tot = fold_sum(ss)
        inv = F32(1.0 / np.sqrt(np.float64(F32(tot / F32(K) + F32(eps)))))
        xs = ((x * inv).astype(F32) * nw).astype(F32)
    y = np.zeros(N, F32)
    for rows in tgv.rank_rows(plan, K):
        acc = np.zeros((k_lanes, N), F32)
        for kl in range(k_lanes):
            for k in range(rows.start + kl, rows.stop, k_lanes):
                acc[kl] = fma(xs[k], w[k], acc[kl])
        s = np.zeros(N, F32)
        for kl in range(k_lanes):
            s = (s + acc[kl]).astype(F32)
        y = (y + s).astype(F32)
    return y


CASES = [(1024, 200, 32, 3), (512, 384, 16, None), (640, 64, 128, 5),
         (2048, 96, 32, None)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("K,N,k_lanes,C", CASES,
                         ids=[f"K{k}-N{n}-kl{kl}-C{c}"
                              for k, n, kl, c in CASES])
def test_mirror_matches_jax(K, N, k_lanes, C, dt):
    jdt, ndt, itemsize, tol = DTYPES[dt]
    rng = np.random.default_rng(K + N)
    x = rng.standard_normal(K).astype(ndt).astype(F32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(ndt).astype(F32)
    nw = (rng.standard_normal(K) * 0.3 + 1).astype(ndt).astype(F32)
    plan = tgv.gemv_plan(K, N, itemsize, k_lanes, cluster=C)
    got = gemv_mirror(x, w, plan, k_lanes).astype(ndt).astype(F32)
    want = np.asarray(jgv.make_gemv(block=(K, N))(
        jnp.array(x, jdt), jnp.array(w, jdt)), F32).ravel()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    f64 = x.astype(np.float64) @ w.astype(np.float64)
    np.testing.assert_allclose(gemv_mirror(x, w, plan, k_lanes), f64,
                               atol=1e-5, rtol=1e-5)
    # the fused form, on the default k_lanes as the wrapper runs it
    plan = tgv.gemv_plan(K, N, itemsize, cluster=C)
    got = gemv_mirror(x, w, plan, tgv.DEFAULT_K_LANES, nw).astype(ndt)
    want = np.asarray(jgv.make_rms_norm_gemv(block=(K, N))(
        jnp.array(x, jdt), jnp.array(nw, jdt), jnp.array(w, jdt)),
        F32).ravel()
    np.testing.assert_allclose(got.astype(F32), want, atol=tol, rtol=tol)
    xn = x / np.sqrt(np.mean(x.astype(np.float64) ** 2) + 1e-5) * nw
    np.testing.assert_allclose(
        gemv_mirror(x, w, plan, tgv.DEFAULT_K_LANES, nw), xn @ w,
        atol=1e-4, rtol=1e-4)


def test_gemv_bench_cli(tmp_path):
    out = tmp_path / "rows.json"
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.gemm_bench",
         "--gemv", "--device", "cpu", "--iters", "1", "--json", str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(out.read_text())["rows"]
    assert [row["case"] for row in rows] == [
        "gemv wqkv", "gemv w_gate_up", "gemv w_down", "gemv lm_out",
        "rms_norm_gemv wqkv"]
    assert all(row["variant"] == "plain" and row["max_abs_err"] == 0
               for row in rows)
