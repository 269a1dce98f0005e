"""The Hopper rms-norm's routes, row assignment and order of sums, on the
CPU.

The kernels of ``csrc/row_ops.cu`` (the rows route ``ln_fwd_rows`` with
``kRms`` and the block route ``rms_norm_kernel``) run only on the GPU,
where ``chip_smoke.py`` holds them against ``rms_norm_plain`` and runs each
twice, bit for bit. What surrounds their arithmetic is Python that these
tests reach, and a mirror of it:

- ``rms_plan``: the route (rows where K is a multiple of 8 up to 4096 and
  the rows are 16-byte aligned, else block), the group a row, the vectors
  a thread, the CTAs an SM (one weight vector in a thread's state, under
  the layer norm's cap), the persistent grid, and the source's constants;
- the row assignment: every row once, the slots within one row of each
  other, at S below, at and above the grid;
- the order of sums: ``rms_mirror`` repeats the kernels' f32 steps in numpy
  (each thread's columns in order by fmaf, a warp's xor tree, the warps in
  order; y = x rstd w rounded once) and is held against JAX's
  ``make_rms_norm`` in interpret mode at K 7 (the block route), 520, 2048
  and 4096 (the rows route) in f32, f16 and bf16, at
  tests/test_torch_ops.py's tolerances (f32 1e-5, f16 2e-2; bf16 2e-2 as
  f16), and against the port's ``rms_norm_plain`` in f64;
- the ``--rms`` bench CLI on the CPU.
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

from leetcuda_tpu.ops import rms_norm as jrms
from leetcuda_tpu_torch.core.runtime import SM_COUNT
from leetcuda_tpu_torch.ops import layer_norm as tln
from leetcuda_tpu_torch.ops import rms_norm as trms
from leetcuda_tpu_torch.ops import rowwise as rw

SRC = Path(trms.__file__).parent.parent / "csrc" / "row_ops.cu"
F32 = np.float32
DTYPES = {"f32": (jnp.float32, F32, 1e-5),
          "f16": (jnp.float16, np.float16, 2e-2),
          "bf16": (jnp.bfloat16, ml_dtypes.bfloat16, 2e-2)}


def test_plan_is_the_sources():
    src = SRC.read_text()
    # the rms-norm's state of a row: two rows of x as loaded and w as f32,
    # under the layer norm's cap
    assert "(kRms ? 4 : 8)" in src
    assert "__launch_bounds__(kLnCta, ln_fwd_ctas<T, NV, kRms>())" in src
    assert 'extern "C" int lc_rms_norm_rows(' in src
    assert "rows_route<true>(x, w, wdt" in src
    # 4 CTAs an SM but for f32 at two vectors a thread (3)
    assert [tln.fwd_ctas(nv, isz, weights=1)
            for nv in (1, 2) for isz in (2, 4)] == [4, 4, 4, 3]
    for K, group, nv in ((8, 32, 1), (256, 32, 1), (520, 128, 1),
                         (2048, 256, 1), (2056, 256, 2), (4096, 256, 2)):
        for itemsize in (2, 4):
            p = trms.rms_plan(16384, K, itemsize)
            assert (p["route"], p["group"], p["nv"]) == ("rows", group, nv)
            per_sm = 3 if (nv, itemsize) == (2, 4) else 4
            G = tln.FWD_CTA // group
            turns = -(-16384 // (per_sm * SM_COUNT * G))
            assert p["grid"] == -(-(-(-16384 // turns)) // G)
    # 512 CTAs of 32 rows at 2048 columns; f32 at 4096: 391 of 42
    assert trms.rms_plan(16384, 2048, 2)["grid"] == 512
    assert trms.rms_plan(16384, 4096, 2)["grid"] == 512
    assert trms.rms_plan(16384, 4096, 4)["grid"] == 391
    for K in (7, 2050, 4104, 8192):
        assert trms.rms_plan(16384, K)["route"] == "block"
    assert trms.rms_plan(16384, 2048, 2, aligned=False)["route"] == "block"
    # the layer norm keeps its own plan (two weight vectors a thread)
    assert tln.ln_fwd_plan(16384, 4096, 2)["grid"] == 391


@pytest.mark.parametrize("S", [1, 7, 263, 528, 1057, 2113, 16384])
@pytest.mark.parametrize("K,itemsize", [(256, 2), (520, 4), (2048, 2),
                                         (4096, 4)])
def test_rows_cover_every_row_once(S, K, itemsize):
    plan = trms.rms_plan(S, K, itemsize)
    slots = tln.slot_rows(plan, S)
    assert len(slots) == plan["slots"] == plan["groups"] * plan["grid"]
    assert sorted(r for rows in slots for r in rows) == list(range(S))
    sizes = [len(rows) for rows in slots]
    assert max(sizes) - min(sizes) <= 1
    per_sm = tln.fwd_ctas(plan["nv"], itemsize, weights=1)
    assert plan["grid"] <= per_sm * SM_COUNT


def fma(a, b, c):
    """fmaf in f32: the exact product and sum, one rounding."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def group_sum(parts):
    """(..., threads) f32 -> (...,): each warp's xor tree, then the warps'
    sums in warp order."""
    *lead, n = parts.shape
    v = parts.reshape(*lead, n // 32, 32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., np.arange(32) ^ o]).astype(F32)
    t = np.zeros(lead, F32)
    for w in range(n // 32):
        t = (t + v[..., w, 0]).astype(F32)
    return t


def thread_cols(plan, K, vec=8, lb=16, itemsize=2, offset=0):
    """(threads, n): each thread's columns in its order (the rows route's
    group, or the block route's CTA on a row ``offset`` elements past an
    lb-aligned address); -1 past its last."""
    if plan["route"] == "rows":
        T = plan["group"]
        cols = [[(v * T + t) * 8 + e for v in range(plan["nv"])
                 for e in range(8) if (v * T + t) * 8 < K]
                for t in range(T)]
    else:
        T, E = rw.threads_for(K, vec), lb // itemsize
        head = min(K, (E - offset % E) % E)
        nvec = (K - head) // vec
        tail = head + nvec * vec
        cols = [list(range(t, head, T))
                + [head + i * vec + e for i in range(t, nvec, T)
                   for e in range(vec)]
                + list(range(tail + t, K, T)) for t in range(T)]
    n = max(len(c) for c in cols)
    return np.array([c + [-1] * (n - len(c)) for c in cols])


def rms_mirror(x, w, out_dt, plan, vec=8, lb=16):
    """Both routes' f32 steps on x (S, K), w (K,): f32 arrays holding the
    dtype's values; y rounded to ``out_dt``, returned as f32."""
    S, K = x.shape
    itemsize = np.dtype(out_dt).itemsize
    y = np.zeros((S, K), F32)
    E = lb // itemsize
    for mis in sorted({r * K % E for r in range(S)}):
        rows = np.array([r for r in range(S) if r * K % E == mis])
        cols = thread_cols(plan, K, vec, lb, itemsize, mis)
        live = cols >= 0
        X = x[rows][:, np.where(live, cols, 0)]  # (rows, threads, n)
        q = np.zeros(X.shape[:2], F32)
        for k in range(X.shape[2]):
            q = np.where(live[:, k], fma(X[:, :, k], X[:, :, k], q),
                         q).astype(F32)
        ms = (group_sum(q) / F32(K)).astype(F32)
        rstd = (F32(1) / np.sqrt((ms + F32(trms.EPS)).astype(F32))
                ).astype(F32)[:, None]
        y[rows] = ((x[rows] * rstd).astype(F32) * w).astype(F32)
    return y.astype(out_dt).astype(F32)


CASES = [(37, 7), (301, 520), (1100, 2048), (67, 4096)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("S,K", CASES, ids=[f"S{s}-K{k}" for s, k in CASES])
def test_mirror_matches_jax(S, K, dt):
    jdt, ndt, tol = DTYPES[dt]
    rng = np.random.default_rng(S + K)
    x = rng.normal(size=(S, K)).astype(ndt)
    w = (rng.normal(size=(K,)) * 0.3 + 1.0).astype(ndt)
    plan = trms.rms_plan(S, K, np.dtype(ndt).itemsize)
    assert plan["route"] == ("block" if K % 8 else "rows")
    got = rms_mirror(x.astype(F32), w.astype(F32), ndt, plan)
    want = jrms.make_rms_norm(rows_per_step=8)(jnp.asarray(x, jdt),
                                               jnp.asarray(w, jdt))
    np.testing.assert_allclose(got, np.asarray(want).astype(F32), atol=tol,
                               rtol=tol)
    plain = trms.rms_norm_plain(torch.from_numpy(x.astype(np.float64)),
                                torch.from_numpy(w.astype(np.float64)))
    np.testing.assert_allclose(got, plain.numpy(), atol=max(tol, 2e-3),
                               rtol=max(tol, 2e-3))


@pytest.mark.parametrize("name", ["f32", "f32x4", "f16_f16", "f16x2_f16",
                                  "f16x8_f16", "f16x8_f32", "f16x8_pack_f16",
                                  "f16x8_pack_f32", "f16_f32"])
def test_every_rung_takes_the_rows_route(name):
    """Each registered rung keeps its load width on the rows route, one
    that ln_rows_by_lb instantiates for its dtype, and runs there at
    (64, 256) and (16384, 2048)."""
    r = rw.rung(name)
    itemsize = 2 if "f16" in name else 4
    lb = rw.load_bytes(r["vec"], r["pack"], itemsize)
    assert lb in ((2, 4, 8, 16) if itemsize == 2 else (4, 8, 16))
    for S, K in ((64, 256), (16384, 2048)):
        assert trms.rms_plan(S, K, itemsize)["route"] == "rows"


def test_cpu_tensors_take_the_plain_version():
    x, w = torch.randn(5, 64), torch.randn(64)
    before = (trms.RMS_NORM.launches, trms.RMS_NORM_BLOCK.launches)
    assert torch.equal(trms.rms_norm(x, w), trms.rms_norm_plain(x, w))
    assert (trms.RMS_NORM.launches, trms.RMS_NORM_BLOCK.launches) == before


def test_rms_bench_cli(tmp_path):
    out = tmp_path / "rows.json"
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.gemm_bench",
         "--rms", "--device", "cpu", "--iters", "1", "--json", str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(out.read_text())["rows"]
    assert [(row["dtype"], row["S"], row["K"]) for row in rows] == [
        ("bfloat16", 64, 256), ("float32", 64, 256), ("float16", 64, 256)]
    assert all(row["variant"] == "plain" and row["max_abs_err"] == 0
               for row in rows)
