"""The Hopper layer-norm forward's routes, row assignment and order of sums,
on the CPU.

The kernels of ``csrc/row_ops.cu`` (the rows route ``ln_fwd_rows`` and the
block route ``layer_norm_kernel``) run only on the GPU, where
``chip_smoke.py`` holds them against ``layer_norm_plain`` and runs each
twice, bit for bit. What surrounds their arithmetic is Python that these
tests reach, and a mirror of it:

- ``ln_fwd_plan``: the route (rows where K is a multiple of 8 up to 4096
  and the rows are 16-byte aligned, else block), the group a row, the
  vectors a thread, the persistent grid, and the source's constants;
- the row assignment: slot c groups + g (group g of CTA c) takes rows
  slot, slot + slots, ...; every row once, every CTA at least one row and
  the slots within one row of each other, at S below, at and above the
  grid;
- the order of sums: ``ln_fwd_mirror`` repeats the kernels' f32 steps in
  numpy (each thread's columns in order, then a warp's xor tree, then the
  warps in order, for the mean and the two-pass variance; y rounded once)
  and is held against JAX's ``make_layer_norm`` in interpret mode at
  ragged K (7: the block route; 520 and 2048: the rows route) and S that
  the grid does not divide, in f32, f16 and bf16, at
  tests/test_torch_ops.py's tolerances (f32 1e-5, f16 2e-2; bf16 2e-2 as
  f16), and against the port's ``layer_norm_plain`` in f64;
- the ``--ln-fwd`` bench CLI on the CPU.
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

from leetcuda_tpu.ops import layer_norm as jln
from leetcuda_tpu_torch.ops import layer_norm as tln
from leetcuda_tpu_torch.ops import rowwise as rw

SRC = Path(tln.__file__).parent.parent / "csrc" / "row_ops.cu"
F32 = np.float32
DTYPES = {"f32": (jnp.float32, F32, 1e-5),
          "f16": (jnp.float16, np.float16, 2e-2),
          "bf16": (jnp.bfloat16, ml_dtypes.bfloat16, 2e-2)}


def test_plan_is_the_sources():
    src = SRC.read_text()
    assert int(re.search(r"constexpr int kLnCta = (\d+);", src).group(1)) \
        == tln.FWD_CTA
    assert int(re.search(r"#define LC_LN_THREAD_BYTES (\d+)", src).group(1)) \
        == tln.FWD_THREAD_BYTES
    assert int(re.search(r"#define LC_LN_MAX_CTAS (\d+)", src).group(1)) \
        == tln.FWD_MAX_CTAS
    # ln_fwd_ctas: a thread's state of a row, two rows of x as loaded and
    # gamma and beta as f32 (the rms-norm's kRms: w alone)
    assert ("NV * 8 * (2 * static_cast<int>(sizeof(T)) + (kRms ? 4 : 8))"
            in src and "LC_LN_THREAD_BYTES / bytes" in src)
    groups = re.search(r"\(group != 32 && group != 64 && group != 128 && "
                       r"group != 256\)", src)
    assert groups and tln.FWD_GROUPS == (32, 64, 128, 256)
    # at most 2 vectors a thread, the two instantiations launch_ln_rows has
    assert "K > 16 * group" in src
    assert tln.FWD_MAX_K == 8 * 2 * tln.FWD_GROUPS[-1]
    assert re.findall(r"ln_fwd_rows<T, LB, (\d), kRms><<<", src) == \
        ["1", "2"]
    # 4 CTAs an SM at one vector a thread; at two, 3 for a 2-byte type and
    # 2 for f32
    assert [tln.fwd_ctas(nv, isz) for nv in (1, 2) for isz in (2, 4)] == \
        [4, 4, 3, 2]
    for K, group, nv in ((8, 32, 1), (256, 32, 1), (264, 64, 1),
                         (520, 128, 1), (1024, 128, 1), (1032, 256, 1),
                         (2048, 256, 1), (2056, 256, 2), (4096, 256, 2)):
        for itemsize in (2, 4):
            p = tln.ln_fwd_plan(16384, K, itemsize)
            assert (p["route"], p["group"], p["nv"]) == ("rows", group, nv)
            per_sm = min(tln.FWD_MAX_CTAS, tln.FWD_THREAD_BYTES
                         // (nv * 8 * (2 * itemsize + 8)))
            G = tln.FWD_CTA // group
            turns = -(-16384 // (per_sm * tln.SM_COUNT * G))
            assert p["groups"] == G
            assert p["grid"] == -(-(-(-16384 // turns)) // G)
            assert p["grid"] <= per_sm * tln.SM_COUNT
            assert p["slots"] == p["groups"] * p["grid"]
    # the default group at 2048 columns: 8 warps, up to 4 CTAs an SM, 512
    # of them taking 32 rows each (528 would leave 16 slots a 32nd row);
    # past 2048 columns 2 vectors a thread, up to 3 CTAs an SM (f32: 2)
    assert tln.ln_fwd_plan(16384, 2048, 4)["grid"] == 512
    assert tln.ln_fwd_plan(16384, 2048, 2)["grid"] == 512
    assert tln.ln_fwd_plan(16384, 4096, 4)["grid"] == 261  # 63 rows a slot
    assert tln.ln_fwd_plan(16384, 4096, 2)["grid"] == 391  # 42 rows a slot
    # a group given (the bench's A/B): vectors a thread follow
    assert tln.ln_fwd_rows_plan(16384, 2048, 128, 2)["nv"] == 2
    for group in (32, 64, 96):
        with pytest.raises(ValueError, match="no rows route"):
            tln.ln_fwd_rows_plan(16384, 2048, group, 2)
    for K in (7, 2050, 4104, 8192):
        assert tln.ln_fwd_plan(16384, K)["route"] == "block"
    assert tln.ln_fwd_plan(16384, 2048, 2, aligned=False)["route"] == \
        "block"


@pytest.mark.parametrize("S", [1, 2, 7, 263, 264, 265, 1055, 1056, 1057,
                               2112, 2113, 16384])
@pytest.mark.parametrize("K,itemsize", [(256, 2), (520, 4), (2048, 2),
                                         (2048, 4), (4096, 2)])
def test_rows_cover_every_row_once(S, K, itemsize):
    plan = tln.ln_fwd_plan(S, K, itemsize)
    slots = tln.slot_rows(plan, S)
    assert len(slots) == plan["slots"] == plan["groups"] * plan["grid"]
    assert sorted(r for rows in slots for r in rows) == list(range(S))
    G = plan["groups"]
    assert all(any(slots[c * G + g] for g in range(G))
               for c in range(plan["grid"]))
    sizes = [len(rows) for rows in slots]
    assert max(sizes) - min(sizes) <= 1
    # no CTA more than the plan's CTAs an SM, and no more turns than that
    # many CTAs would take
    per_sm = tln.fwd_ctas(plan["nv"], itemsize)
    assert plan["grid"] <= per_sm * tln.SM_COUNT
    assert max(sizes) == -(-S // (per_sm * tln.SM_COUNT * G))
    for slot, rows in enumerate(slots):
        assert rows == sorted(rows) and all(r % plan["slots"] == slot
                                            for r in rows)


def fma(a, b, c):
    """fmaf in f32: the exact product and sum, one rounding (f64 holds the
    product of two f32 exactly)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def group_sum(parts):
    """(..., threads) f32 -> (...,) the group's sum: each warp's xor tree
    (lane l adds lane l ^ o, o = 16 .. 1), then the warps' sums in warp
    order from 0."""
    *lead, n = parts.shape
    v = parts.reshape(*lead, n // 32, 32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., np.arange(32) ^ o]).astype(F32)
    t = np.zeros(lead, F32)
    for w in range(n // 32):
        t = (t + v[..., w, 0]).astype(F32)
    return t


def thread_cols(plan, K, vec=8, lb=16, itemsize=2, offset=0):
    """(threads, n): the columns each thread of the row's group (rows
    route) or CTA (block route, a row starting ``offset`` elements past an
    lb-aligned address) takes, in its order; -1 past its last."""
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


def ln_fwd_mirror(x, g, b, out_dt, plan, vec=8, lb=16):
    """The kernels' f32 steps on x (S, K), g, b (K,): f32 arrays holding
    the dtype's values; y rounded to ``out_dt``, returned as f32. The rows
    of one alignment share their threads' columns."""
    S, K = x.shape
    itemsize = np.dtype(out_dt).itemsize
    fk = F32(K)
    y = np.zeros((S, K), F32)
    E = lb // itemsize
    for mis in sorted({r * K % E for r in range(S)}):
        rows = np.array([r for r in range(S) if r * K % E == mis])
        cols = thread_cols(plan, K, vec, lb, itemsize, mis)
        live = cols >= 0
        X = x[rows][:, np.where(live, cols, 0)]  # (rows, threads, n)
        s = np.zeros(X.shape[:2], F32)
        for k in range(X.shape[2]):
            s = np.where(live[:, k], s + X[:, :, k], s).astype(F32)
        mean = (group_sum(s) / fk).astype(F32)[:, None]
        q = np.zeros(X.shape[:2], F32)
        for k in range(X.shape[2]):
            d = (X[:, :, k] - mean).astype(F32)
            q = np.where(live[:, k], fma(d, d, q), q).astype(F32)
        var = (group_sum(q) / fk).astype(F32)
        rstd = (F32(1) / np.sqrt((var + F32(tln.EPS)).astype(F32))
                ).astype(F32)[:, None]
        xhat = ((x[rows] - mean).astype(F32) * rstd).astype(F32)
        y[rows] = fma(xhat, g, b)
    return y.astype(out_dt).astype(F32)


CASES = [(37, 7), (301, 520), (1100, 2048)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("S,K", CASES, ids=[f"S{s}-K{k}" for s, k in CASES])
def test_mirror_matches_jax(S, K, dt):
    jdt, ndt, tol = DTYPES[dt]
    rng = np.random.default_rng(S + K)
    x = rng.normal(size=(S, K)).astype(ndt)
    g = (rng.normal(size=(K,)) * 0.3 + 1.0).astype(ndt)
    b = (rng.normal(size=(K,)) * 0.3).astype(ndt)
    plan = tln.ln_fwd_plan(S, K, np.dtype(ndt).itemsize)
    assert plan["route"] == ("block" if K % 8 else "rows")
    if plan["route"] == "rows" and S > 1000:
        assert S % plan["slots"] != 0  # some slots take a row more
    got = ln_fwd_mirror(*(a.astype(F32) for a in (x, g, b)), ndt, plan)
    want = jln.make_layer_norm(rows_per_step=8)(
        *(jnp.asarray(a, jdt) for a in (x, g, b)))
    np.testing.assert_allclose(got, np.asarray(want).astype(F32), atol=tol,
                               rtol=tol)
    # the same function as the port's plain version (f64 here: the mirror's
    # f32 steps and y's rounding are its only roundings)
    plain = tln.layer_norm_plain(
        *(torch.from_numpy(a.astype(np.float64)) for a in (x, g, b)))
    np.testing.assert_allclose(got, plain.numpy(), atol=max(tol, 2e-3),
                               rtol=max(tol, 2e-3))


@pytest.mark.parametrize("name", ["f32", "f32x4", "f16x8_f16",
                                  "f16x8_pack_f32"])
def test_every_rung_takes_the_rows_route(name):
    """A rung changes the rows route's load width and nothing of its
    arithmetic: every rung's (elements, load bytes) is one that
    ln_rows_by_lb instantiates for its dtype, and the registered rungs
    run the layer norm through the rows route at (64, 256)."""
    r = rw.rung(name)
    itemsize = 2 if "f16" in name else 4
    lb = rw.load_bytes(r["vec"], r["pack"], itemsize)
    assert lb in ((2, 4, 8, 16) if itemsize == 2 else (4, 8, 16))
    assert tln.ln_fwd_plan(64, 256, itemsize)["route"] == "rows"


def test_mirror_with_large_mean():
    """Rows offset by 1e3 (the chip check's): the two-pass variance from the
    registers stays within 2e-3 of float64, where E[x^2] - mean^2 would
    cancel."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(9, 2048)) + 1e3).astype(F32)
    g = (rng.normal(size=(2048,)) * 0.3 + 1.0).astype(F32)
    b = (rng.normal(size=(2048,)) * 0.3).astype(F32)
    got = ln_fwd_mirror(x, g, b, F32, tln.ln_fwd_plan(9, 2048, 4))
    x64 = x.astype(np.float64)
    mean = x64.mean(-1, keepdims=True)
    want = ((x64 - mean) / np.sqrt(((x64 - mean) ** 2).mean(-1, keepdims=True)
                                   + tln.EPS)) * g + b
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


def test_ln_fwd_bench_cli(tmp_path):
    out = tmp_path / "rows.json"
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.gemm_bench",
         "--ln-fwd", "--device", "cpu", "--iters", "1", "--json",
         str(out)], capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(out.read_text())["rows"]
    assert [(row["dtype"], row["S"], row["K"]) for row in rows] == [
        ("bfloat16", 64, 256), ("float32", 64, 256), ("float16", 64, 256)]
    assert all(row["variant"] == "plain" and row["max_abs_err"] == 0
               for row in rows)
