"""The Hopper layer-norm backward's routes, row assignment and order of
sums, on the CPU.

The kernels of ``csrc/row_ops.cu`` (the rows route ``ln_bwd_rows``, the
block route ``ln_bwd_kernel`` and the finish ``ln_bwd_finish``) run only
on the GPU, where ``chip_smoke.py`` holds them against
``layer_norm_bwd_plain`` and runs each twice, bit for bit. What surrounds
their arithmetic is Python that these tests reach, and a mirror of it:

- ``ln_bwd_plan``: the route (rows where K is a multiple of 8 up to 4096
  and the rows are 16-byte aligned, else block), the persistent grid and
  the source's constants;
- the row assignment: slot 2 b + g (group g of CTA b) takes rows slot,
  slot + 2 grid, ...; every row once, every CTA at least one row and the
  slots within one row of each other, at S below, at and above the grid;
  the block route's CTAs take consecutive blocks;
- the order of sums: ``ln_bwd_mirror`` repeats the kernels' f32 steps in
  numpy (each thread's columns in order, then a warp's xor tree, then the
  warps in order, for the mean, the two-pass variance and m1, m2; dx
  rounded once; each slot's dgamma and dbeta partials over its rows in
  order, a CTA's two groups added, then the finish's eight warps over the
  partial rows and the warps in order) and is held against JAX's
  ``make_layer_norm_trainable`` gradients in interpret mode at ragged K (7:
  the block route; 520 and 2048: the rows route) and S that the grid does
  not divide, in f32, f16 and bf16, at tests/test_torch_ops.py's
  tolerances (f32 1e-4, f16 2e-2; bf16 2e-2 as f16), and against the
  port's ``layer_norm_bwd_plain`` in f64.
"""

import re
from pathlib import Path

import jax
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
DTYPES = {"f32": (torch.float32, jnp.float32, F32, 1e-4),
          "f16": (torch.float16, jnp.float16, np.float16, 2e-2),
          "bf16": (torch.bfloat16, jnp.bfloat16, ml_dtypes.bfloat16, 2e-2)}


def test_plan_is_the_sources():
    src = SRC.read_text()
    assert re.search(r"constexpr int kRowGroup = (\d+);", src).group(1) == \
        str(tln.ROWS_GROUP_THREADS)
    assert int(re.search(r"constexpr int kRowsCta = (\d+);", src).group(1)) \
        == tln.ROWS_GROUPS * tln.ROWS_GROUP_THREADS
    assert "K % 8 || K > 4096" in src and tln.ROWS_MAX_K == 4096
    for K, nv in ((8, 1), (1024, 1), (1032, 2), (2048, 2), (2056, 4),
                  (4096, 4)):
        for itemsize in (2, 4):
            p = tln.ln_bwd_plan(16384, K, itemsize)
            assert (p["route"], p["nv"]) == ("rows", nv)
            two = K <= 2048 and K * itemsize <= tln.ROWS_2CTA_BYTES
            assert p["grid"] == (2 if two else 1) * tln.SM_COUNT
    assert tln.ln_bwd_plan(16384, 2048, 4)["grid"] == tln.SM_COUNT
    assert tln.ln_bwd_plan(16384, 1024, 4)["grid"] == 2 * tln.SM_COUNT
    for K in (7, 2050, 4104):
        assert tln.ln_bwd_plan(16384, K)["route"] == "block"
    assert tln.ln_bwd_plan(16384, 2048, 2, aligned=False)["route"] == \
        "block"


@pytest.mark.parametrize("S", [1, 2, 7, 263, 264, 265, 527, 528, 529, 1100,
                               16384])
@pytest.mark.parametrize("K,itemsize", [(520, 2), (2048, 2), (2048, 4),
                                         (4096, 2)])
def test_rows_cover_every_row_once(S, K, itemsize):
    plan = tln.ln_bwd_plan(S, K, itemsize)
    slots = tln.slot_rows(plan, S)
    assert len(slots) == plan["slots"] == 2 * plan["grid"] == 2 * plan["nb"]
    assert plan["grid"] <= (2 if K <= 2048 else 1) * tln.SM_COUNT
    assert sorted(r for rows in slots for r in rows) == list(range(S))
    assert all(slots[2 * b] or slots[2 * b + 1] for b in range(plan["grid"]))
    sizes = [len(rows) for rows in slots]
    assert max(sizes) - min(sizes) <= 1
    for slot, rows in enumerate(slots):
        assert rows == sorted(rows) and all(r % plan["slots"] == slot
                                            for r in rows)


@pytest.mark.parametrize("S", [1, 37, 528, 529, 16384])
def test_block_route_covers_every_row_once(S):
    plan = tln.ln_bwd_plan(S, 7)
    assert plan["route"] == "block" and plan["nb"] <= tln.BWD_CTAS
    blocks = [range(i * plan["rows"], min(S, (i + 1) * plan["rows"]))
              for i in range(plan["nb"])]
    assert all(len(b) for b in blocks)
    assert [r for b in blocks for r in b] == list(range(S))


def fma(a, b, c):
    """fmaf in f32: the exact product and sum, one rounding (f64 holds the
    product of two f32 exactly)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def block_sum(parts):
    """(..., threads) f32 -> (...,): each warp's xor tree (lane l adds lane
    l ^ o, o = 16 .. 1), then the warps' sums in warp order from 0."""
    *lead, n = parts.shape
    v = parts.reshape(*lead, n // 32, 32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., np.arange(32) ^ o]).astype(F32)
    t = np.zeros(lead, F32)
    for w in range(n // 32):
        t = (t + v[..., w, 0]).astype(F32)
    return t


def thread_cols(plan, K):
    """(threads, n) the columns each thread of a row's CTA or group takes,
    in order; -1 for none."""
    if plan["route"] == "rows":
        T = tln.ROWS_GROUP_THREADS
        cols = np.array([[(v * T + t) * 8 + e for v in range(plan["nv"])
                          for e in range(8)] for t in range(T)])
    else:
        T = rw.threads_for(K, 1)
        n = -(-K // T)
        cols = np.array([[t + T * i for i in range(n)] for t in range(T)])
    return np.where(cols < K, cols, -1)


def ln_bwd_mirror(x, g, dy, out_dt, plan):
    """(dx, dgamma, dbeta) by the kernels' steps in f32: x, g, dy f32
    arrays holding the dtype's values; dx rounded to ``out_dt``, dgamma
    and dbeta left in f32."""
    S, K = x.shape
    cols = thread_cols(plan, K)
    live = cols >= 0
    idx = np.where(live, cols, 0)
    X, DY, G = x[:, idx], dy[:, idx], g[idx]   # (S, T, n), (T, n)
    fk = F32(K)

    def per_thread(step, init=0.0):
        acc = np.full(X.shape[:2], init, F32)
        for k in range(X.shape[2]):
            acc = np.where(live[:, k], step(acc, k), acc).astype(F32)
        return acc

    mean = (block_sum(per_thread(lambda a, k: a + X[:, :, k])) / fk)[:, None]
    q = per_thread(lambda a, k: fma(X[:, :, k] - mean, X[:, :, k] - mean, a))
    rstd = (F32(1) / np.sqrt((block_sum(q) / fk + F32(tln.EPS)).astype(F32))
            ).astype(F32)[:, None]
    XH = ((X - mean[..., None]) * rstd[..., None]).astype(F32)
    DXH = (DY * G).astype(F32)
    m1 = (block_sum(per_thread(lambda a, k: a + DXH[:, :, k])) / fk)
    m2 = (block_sum(per_thread(lambda a, k: fma(DXH[:, :, k], XH[:, :, k],
                                                 a))) / fk)
    m1, m2 = m1.astype(F32)[:, None, None], m2.astype(F32)[:, None, None]
    DX = ((((DXH - m1).astype(F32) - (XH * m2).astype(F32)).astype(F32))
          * rstd[..., None]).astype(F32)
    dx = np.zeros((S, K), F32)
    dx[:, cols[live]] = DX[:, live]
    dx = dx.astype(out_dt).astype(F32)
    xh = np.zeros((S, K), F32)
    xh[:, cols[live]] = XH[:, live]

    # per-CTA partial rows of dgamma and dbeta
    if plan["route"] == "rows":
        slots = tln.slot_rows(plan, S)
        acc_g = np.zeros((len(slots), K), F32)
        acc_b = np.zeros((len(slots), K), F32)
        for s, rows in enumerate(slots):
            for r in rows:
                acc_g[s] = fma(dy[r], xh[r], acc_g[s])
                acc_b[s] = (acc_b[s] + dy[r]).astype(F32)
        pg = (acc_g[0::2] + acc_g[1::2]).astype(F32)  # group 0's + 1's
        pb = (acc_b[0::2] + acc_b[1::2]).astype(F32)
    else:
        pg = np.zeros((plan["nb"], K), F32)
        pb = np.zeros((plan["nb"], K), F32)
        for i in range(plan["nb"]):
            for r in range(i * plan["rows"], min(S, (i + 1) * plan["rows"])):
                pg[i] = (pg[i] + (dy[r] * xh[r]).astype(F32)).astype(F32)
                pb[i] = (pb[i] + dy[r]).astype(F32)

    def finish(p):  # warp w: rows w, w + 8, ... in order; then w in order
        warps = np.zeros((8, K), F32)
        for w in range(8):
            for i in range(w, p.shape[0], 8):
                warps[w] = (warps[w] + p[i]).astype(F32)
        t = np.zeros(K, F32)
        for w in range(8):
            t = (t + warps[w]).astype(F32)
        return t

    return dx, finish(pg), finish(pb)


CASES = [(37, 7), (301, 520), (1100, 2048)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("S,K", CASES, ids=[f"S{s}-K{k}" for s, k in CASES])
def test_mirror_matches_jax(S, K, dt):
    tdt, jdt, ndt, tol = DTYPES[dt]
    rng = np.random.default_rng(S + K)
    x = rng.normal(size=(S, K)).astype(ndt)
    g = (rng.normal(size=(K,)) * 0.3 + 1.0).astype(ndt)
    b = rng.normal(size=(K,)).astype(ndt)
    dy = rng.normal(size=(S, K)).astype(ndt)
    plan = tln.ln_bwd_plan(S, K, np.dtype(ndt).itemsize)
    assert plan["route"] == ("block" if K % 8 else "rows")
    got = ln_bwd_mirror(*(a.astype(F32) for a in (x, g, dy)), ndt, plan)

    def loss(x, g, b):
        return jnp.sum(jln.layer_norm_trainable(x, g, b).astype(jnp.float32)
                       * jnp.asarray(dy, jdt).astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdt) for a in (x, g, b)))
    for name, ours, theirs in zip(("dx", "dgamma", "dbeta"), got, want):
        ours = ours.astype(ndt).astype(F32)  # dgamma, dbeta in g's dtype
        np.testing.assert_allclose(ours, np.asarray(theirs, F32), atol=tol,
                                   rtol=tol, err_msg=name)
    # the same function as the port's plain version (f64 here: the mirror's
    # f32 steps are its only rounding besides dx's)
    plain = tln.layer_norm_bwd_plain(
        *(torch.from_numpy(a.astype(np.float64)) for a in (x, g, dy)))
    for name, ours, p in zip(("dx", "dgamma", "dbeta"), got, plain):
        np.testing.assert_allclose(ours, p.numpy(), atol=max(tol, 2e-3),
                                   rtol=max(tol, 2e-3), err_msg=name)
