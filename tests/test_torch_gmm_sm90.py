"""The Hopper grouped matmul's routes, tiles, walk, panel boxes and order of
sums, on the CPU.

The wgmma route of ``csrc/gmm.cu`` (a persistent TMA + wgmma kernel on
``gemm_sm90.cuh``'s pieces) runs only on the GPU, where ``chip_smoke.py``
holds it against ``gmm_plain``. What surrounds its arithmetic is Python that
these tests reach, and mirrors of its arithmetic:

- the tiles, stages and CTAs an SM of ``GMM_TILES`` are the source's
  ``GemmPlan`` instantiations, macro defaults and tile ids, and their shared
  memory fits, as does that of the bench's variant builds;
- ``gmm_route``: which (dtype, bm, K, N) take the wgmma route, every case of
  ``chip_smoke.check_gmm`` among them;
- the walk: ``walk_mirror`` repeats the kernel's persistent walk (CTA b
  takes units b, b + grid, ...; ``tile_ij``; the expert of row block i is
  that of row tile i BM / bm) and takes every (unit, expert) once at path
  (n)'s decode and prefill buffers for bm 64, 128 and 256, a unit never
  straddles two row tiles, and the producer's stage loads equal the
  consumers' stage reads in every CTA (an out-of-range expert: none);
- the panel boxes: a 64 x 64 box of the 3-D map over rhs (G, K, N) reads
  zeros past K, never the next expert's rows (as a 2-D map over the
  (G K, N) stack would), so the k stages' sum is exact;
- the order of sums: ``gmm_mirror`` repeats the wgmma route's arithmetic
  (each tile's f32 sum over 64-deep k stages of zero-filled boxes, one
  rounding; NaN over an out-of-range expert's tiles) over a tiny
  ``dropless_dispatch`` buffer, held against JAX's ``make_gmm`` in
  interpret mode in bf16 and f16 at the registry's 2e-2.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from leetcuda_tpu.gemm import grouped as jg
from leetcuda_tpu_torch.gemm import grouped as gg
from leetcuda_tpu_torch.gemm.matmul import tile_ij
from leetcuda_tpu_torch.models import moe as tm

SRC = Path(gg.__file__).parent.parent / "csrc" / "gmm.cu"
TOL = dict(atol=2e-2, rtol=2e-2)  # the registry's (gemm/grouped.py)
# Qwen3-30B-A3B's products: gate / up (K 2048, N 768), down (768, 2048)
QWEN_KN = ((2048, 768), (768, 2048))
NP_DT = {torch.bfloat16: ml_dtypes.bfloat16, torch.float16: np.float16}


def smem_fits(bm, bn, stages, per_sm):
    """gemm_sm90.cuh GemmPlan::SMEM_BYTES, within the SM's 228 KB with 1 KB
    reserved a block."""
    smem = (1024 + stages * (bm * 128 + bn * 128) + bm * bn * 2
            + 8 * (2 * stages + 2))
    return smem <= 232448 and per_sm * (smem + 1024) <= 233472


def test_tiles_are_the_sources():
    src = SRC.read_text()
    macros = {k: int(v) for k, v in
              re.findall(r"#define (LC_GMM_\w+) (\d+)", src)}
    assert macros == {"LC_GMM_BN": 256, "LC_GMM_STAGES": 3,
                      "LC_GMM_GROUP": 0}
    plans = {int(m[0]): tuple(macros[v] if v in macros else int(v)
                              for v in m[1:])
             for m in re.findall(r"using Wg(\d+) = GemmPlan<(\w+), (\w+), "
                                 r"(\w+), (\d+), (\d+), kBgkn>;", src)}
    ids = {int(a): int(b) for a, b in re.findall(r"kWg(\d+) = (\d+)", src)}
    assert set(plans) == set(ids) == {k[0] for k in gg.GMM_TILES}
    for key, t in gg.GMM_TILES.items():
        bm, bn, stages, cluster, per_sm = plans[key[0]]
        assert (bm, bn) == key and cluster == 1
        assert (stages, per_sm, ids[bm]) == (t["stages"], t["per_sm"],
                                              t["tile"])
        assert t["block_k"] == 64
        assert smem_fits(bm, bn, stages, per_sm)
    assert gg.gmm_tile_key(128) in gg.GMM_TILES
    assert gg.gmm_tile_key(256) == gg.gmm_tile_key(128)
    assert gg.gmm_tile_key(64) in gg.GMM_TILES
    assert gg.gmm_tile_key(192) == gg.gmm_tile_key(64)


def test_bench_variants_build_and_fit():
    """The --gmm A/B's variant builds change only the source's macros, and
    each variant's 128-row tile fits the shared memory."""
    from leetcuda_tpu_torch.bench import gemm_bench as gb

    macros = set(re.findall(r"#ifndef (LC_GMM_\w+)", SRC.read_text()))
    for v in gb.GMM_VARIANTS:
        assert v and set(v) <= macros
        assert smem_fits(128, v.get("LC_GMM_BN", 256),
                         v.get("LC_GMM_STAGES", 3), 1)


# (dtype, bm, K, N) -> route: every case of chip_smoke.check_gmm, then the
# edges of the rule
ROUTES = [
    (torch.bfloat16, 128, 2048, 768, "wgmma"),   # (n) gate / up
    (torch.bfloat16, 128, 768, 2048, "wgmma"),   # (n) down
    (torch.bfloat16, 128, 2048, 1000, "wgmma"),  # ragged N, a partial tile
    (torch.bfloat16, 128, 768, 203, "tile"),     # N not a multiple of 8
    (torch.float32, 128, 256, 384, "tile"),      # f32
    (torch.float16, 128, 256, 384, "wgmma"),     # f16
    (torch.bfloat16, 64, 256, 256, "wgmma"),     # row tiles of 64
    (torch.bfloat16, 256, 256, 256, "wgmma"),    # row tiles of 256
    (torch.bfloat16, 64, 776, 264, "wgmma"),     # K, N 8 past 64s
    (torch.float32, 64, 776, 264, "tile"),
    (torch.bfloat16, 32, 256, 256, "tile"),      # bm below 64
    (torch.bfloat16, 96, 256, 256, "tile"),      # bm not a multiple of 64
    (torch.bfloat16, 192, 256, 256, "wgmma"),    # 64 x 128 tiles
    (torch.bfloat16, 128, 260, 256, "tile"),     # K not a multiple of 8
]


@pytest.mark.parametrize("dt,bm,K,N,route", ROUTES,
                         ids=[f"{str(r[0])[6:]}-bm{r[1]}-K{r[2]}-N{r[3]}"
                              for r in ROUTES])
def test_route_rule(dt, bm, K, N, route):
    assert gg.gmm_route(dt, bm, K, N) == route
    plan = gg.gmm_plan(4 * bm, K, N, bm, dt)
    assert plan["route"] == route
    if route == "wgmma":
        assert bm % plan["block_m"] == 0
        assert plan["block_m"] == (128 if bm % 128 == 0 else 64)
        assert plan["grid"] == min(plan["units"],
                                   plan["per_sm"] * gg.SM_COUNT)


def dispatch_tiles(rng, tokens, topk, n_experts, bm):
    """Path (n)'s buffer for ``tokens`` tokens routed to ``topk`` of
    ``n_experts`` at random: its rows (models/moe.py dropless_dispatch's
    T_buf) and the expert of each row tile, past the last group E - 1."""
    counts = np.bincount(rng.choice(n_experts, tokens * topk),
                         minlength=n_experts)
    padded = torch.from_numpy(-(-counts // bm) * bm)
    T_buf = -(-tokens * topk // bm) * bm + n_experts * bm
    tiles = gg.tile_groups_from_sizes(padded, bm, T_buf // bm).clamp_(
        max=n_experts - 1)
    return T_buf, tiles.numpy()


def walk_mirror(plan, T, N, K, tile_group, bm, G):
    """csrc/gmm.cu gmm_sm90's walk: per CTA its (unit, i, j, expert or -1)
    in order, and the stages its producer loads and its consumers read."""
    nbm, nbn = T // plan["block_m"], -(-N // plan["block_n"])
    nk = -(-K // 64)
    ctas = []
    for b in range(plan["grid"]):
        units, loads, reads = [], 0, 0
        for u in range(b, nbm * nbn, plan["grid"]):
            i, j = tile_ij(u, nbm, nbn, 0)  # LC_GMM_GROUP
            g = int(tile_group[i * plan["block_m"] // bm])
            g = g if 0 <= g < G else -1
            units.append((u, i, j, g))
            loads += nk if g >= 0 else 0  # the producer's stage loads
            reads += nk if g >= 0 else 0  # the consumers' waits on them
        ctas.append((units, loads, reads))
    return ctas


@pytest.mark.parametrize("bm", [64, 128, 256])
@pytest.mark.parametrize("tokens", [8, 8 * 1024], ids=["decode", "prefill"])
def test_walk_takes_every_unit_once(bm, tokens):
    rng = np.random.default_rng(bm + tokens)
    T, tiles = dispatch_tiles(rng, tokens, 8, 128, bm)
    tiles[3] = 128  # one tile out of range: no loads, NaN
    for K, N in QWEN_KN:
        plan = gg.gmm_plan(T, K, N, bm, torch.bfloat16)
        assert plan["route"] == "wgmma"
        ctas = walk_mirror(plan, T, N, K, tiles, bm, 128)
        seen = [unit for units, _, _ in ctas for unit in units]
        assert sorted(u for u, *_ in seen) == list(range(plan["units"]))
        for u, i, j, g in seen:
            r0, r1 = i * plan["block_m"], (i + 1) * plan["block_m"] - 1
            assert r0 // bm == r1 // bm  # one row tile, one expert
            want = int(tiles[r0 // bm])
            assert g == (want if want < 128 else -1)
            assert 0 <= j < plan["col_blocks"]
        assert sum(g < 0 for *_, g in seen) == (
            plan["col_blocks"] * (bm // plan["block_m"]))
        for _, loads, reads in ctas:
            assert loads == reads
        # N fastest within a row tile: the units in order of u (the order
        # the grid starts them in) take every column of a row block before
        # the next row block
        order = [(i, j) for _, i, j, _ in sorted(seen)]
        assert order == [(i, j) for i in range(plan["row_blocks"])
                         for j in range(plan["col_blocks"])]


def tma_box(t, starts, box):
    """A TMA box of ``t`` at ``starts`` (outer to inner), zero-filled where
    it runs past a dimension of the tensor."""
    out = np.zeros(box, t.dtype)
    src = tuple(slice(s, max(s, min(s + b, n))) for s, b, n in
                zip(starts, box, t.shape))
    out[tuple(slice(0, sl.stop - sl.start) for sl in src)] = t[src]
    return out


@pytest.mark.parametrize("K", [776, 200, 72, 2048])
def test_panel_boxes_stay_in_one_expert(K):
    rng = np.random.default_rng(K)
    G, N = 3, 136
    rhs = rng.standard_normal((G, K, N))
    x = rng.standard_normal((5, K))
    flat = rhs.reshape(G * K, N)
    for g in range(G):
        total = np.zeros((5, N))
        crossed = False
        for kb in range(-(-K // 64)):
            for n0 in range(0, N, 64):
                box = tma_box(rhs, (g, kb * 64, n0), (1, 64, 64))[0]
                rows = min(64, K - kb * 64)
                assert not box[rows:].any()  # zeros past K
                wrong = tma_box(flat, (g * K + kb * 64, n0), (64, 64))
                crossed |= bool((wrong[rows:] != 0).any())
                xb = tma_box(x, (0, kb * 64), (5, 64))
                total[:, n0:n0 + 64] += (xb @ box)[:, :min(64, N - n0)]
        np.testing.assert_allclose(total, x @ rhs[g], rtol=1e-12, atol=1e-9)
        # a 2-D map over the stack would read the next expert's rows
        assert crossed == (K % 64 != 0 and g < G - 1)


def gmm_mirror(lhs, rhs, tile_group, bm, dtype):
    """The wgmma route's arithmetic in numpy: every unit of ``gmm_plan``'s
    walk sums its 64-deep k stages of zero-filled boxes of x and of its
    expert's panel in f32, stage by stage, and rounds once to ``dtype``; an
    out-of-range expert's units are NaN."""
    T, K = lhs.shape
    G, _, N = rhs.shape
    plan = gg.gmm_plan(T, K, N, bm, dtype)
    BM, BN = plan["block_m"], plan["block_n"]
    out = np.full((T, N), np.nan, np.float32)
    for units, _, _ in walk_mirror(plan, T, N, K, tile_group, bm, G):
        for _, i, j, g in units:
            if g < 0:
                continue
            acc = np.zeros((BM, BN), np.float32)
            for kb in range(-(-K // 64)):
                a = tma_box(lhs, (i * BM, kb * 64), (BM, 64))
                b = np.concatenate([tma_box(rhs, (g, kb * 64, j * BN + q),
                                            (1, 64, 64))[0]
                                    for q in range(0, BN, 64)], axis=1)
                acc += (a.astype(np.float64) @ b).astype(np.float32)
            r, c = min(BM, T - i * BM), min(BN, N - j * BN)
            out[i * BM:i * BM + r, j * BN:j * BN + c] = acc[:r, :c]
    return out.astype(NP_DT[dtype]).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("bm", [64, 128])
def test_order_of_sums_matches_jax(dtype, bm):
    """A tiny dropless_dispatch buffer (24 tokens, top-2 of 4 experts, K 200
    and N 136: 8 past 64s) through the mirror and JAX's make_gmm; then one
    row tile's expert out of range: NaN rows in the mirror (JAX, given a
    valid id there, is compared on the other rows)."""
    rng = np.random.default_rng(bm)
    cfg = tm.MoEConfig(n_experts=4, topk=2, dim=200, ffn_dim=136,
                       dtype=torch.float32)
    params = {"router": torch.from_numpy(rng.standard_normal((200, 4))
                                         ).float()}
    x = torch.from_numpy(rng.standard_normal((24, 200))).float()
    buf, tiles, _, _, _ = tm.dropless_dispatch(x, params, cfg, bm)
    rhs = rng.standard_normal((4, 200, 136)) / np.sqrt(200)
    lhs_q = buf.to(dtype).float().numpy()
    rhs_q = torch.from_numpy(rhs).to(dtype).float().numpy()
    tiles = tiles.numpy().copy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    want = np.asarray(jg.make_gmm(block=(bm, 2048, 2048))(
        jnp.asarray(lhs_q, jdt), jnp.asarray(rhs_q, jdt),
        jnp.asarray(tiles)).astype(jnp.float32))
    got = gmm_mirror(lhs_q, rhs_q, tiles, bm, dtype)
    np.testing.assert_allclose(got, want, **TOL)
    bad = tiles.copy()
    bad[1] = 4
    got = gmm_mirror(lhs_q, rhs_q, bad, bm, dtype)
    rows = np.repeat(bad >= 4, bm)
    assert np.isnan(got[rows]).all() and not np.isnan(got[~rows]).any()
    np.testing.assert_allclose(got[~rows], want[~rows], **TOL)
    # the plain version (chip_smoke.py's reference on the card) agrees
    plain = gg.gmm_plain(torch.from_numpy(lhs_q).to(dtype),
                         torch.from_numpy(rhs_q).to(dtype),
                         torch.from_numpy(bad), bm).float().numpy()
    assert np.isnan(plain[rows]).all()
    np.testing.assert_allclose(got[~rows], plain[~rows], **TOL)
