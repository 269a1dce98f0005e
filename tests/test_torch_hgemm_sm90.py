"""The Hopper dense matmul's plan, persistent walk and zero padding, on the
CPU.

The tensor-core route of ``csrc/matmul.cu`` (the TMA + wgmma kernel of
``csrc/gemm_sm90.cuh``) runs only on the GPU, where ``chip_smoke.py`` holds
it against ``matmul_plain``. What surrounds its arithmetic is Python that
these tests reach:

- ``hgemm_plan``: each tensor-core key's tile is the source's instantiation
  (the wrapper also compares it with ``lc_matmul_info`` on the card), the
  stages fit the shared memory ``per_sm`` times, K and N are padded to the
  next multiple of 8 (16-byte rows, a tensor map's rule) and no further, and
  the grid is at most the co-resident CTAs in whole clusters, none idle;
- the walk: the CTAs (or CTA pairs) take units b, b + G, b + 2G, ... and
  unit u is ``tile_ij(u)``; a simulation shows that every output tile is
  taken exactly once, row-major without a group and in JAX's
  ``_swizzled_ij`` order with one;
- the zero padding (``pad_operands``) is exact: at ``RAGGED_MNK`` (200, 130,
  261: K and N padded; 200, 136, 264: no padding due), NN and TN, f16 and
  bf16, the padded product equals the unpadded one bit for bit in f64
  (every product of two 16-bit floats and every sum here is exact there)
  and, rounded once, JAX's ``make_matmul`` in interpret mode (f32 outputs
  too) within the f32 reordering bound.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.gemm.matmul import _swizzled_ij
from leetcuda_tpu.gemm.matmul import make_matmul as j_make_matmul
from leetcuda_tpu_torch.gemm import matmul as tmm

SRC = Path(tmm.__file__).parent.parent / "csrc"
TC_KEYS = [k for k, (_, path) in tmm.BLOCKS.items() if path == "tensor-core"]
RAGGED_MNK = [(200, 130, 261), (200, 136, 264)]


def source_tiles():
    """{config name: (BM, BN, stages, cluster, CTAs an SM)} as csrc/matmul.cu
    instantiates GemmPlan, its macros substituted."""
    src = (SRC / "matmul.cu").read_text()
    macros = dict(re.findall(r"#define (LC_MM_\w+) (\d+)", src))
    tiles = {}
    for name, args in re.findall(
            r"using (Tc\d+) = GemmPlan<([^>]*), kB>;", src):
        vals = [int(macros.get(a.strip(), a.strip())) for a in args.split(",")]
        tiles[name] = tuple(vals)
    return tiles


def test_tiles_are_the_sources():
    tiles = source_tiles()
    names = {(64, 64, 32): "Tc64", (128, 128, 32): "Tc128",
             (128, 256, 32): "Tc256"}
    assert sorted(TC_KEYS) == sorted(names)
    for key, name in names.items():
        t = tmm.TC_TILES[key]
        assert tiles[name] == (t["block_m"], t["block_n"], t["stages"],
                               t["cluster"], t["per_sm"]), key
        assert tmm.BLOCKS[key][0] == {"Tc64": 4, "Tc128": 5, "Tc256": 6}[name]


@pytest.mark.parametrize("key", TC_KEYS, ids=[str(k) for k in TC_KEYS])
def test_plan_fits_and_pads(key):
    t = tmm.TC_TILES[key]
    bm, bn = t["block_m"], t["block_n"]
    # gemm_sm90.cuh GemmPlan::SMEM_BYTES: stages of A and B, the staging tile
    smem = (1024 + t["stages"] * (bm * 128 + bn * 128) + bm * bn * 2
            + 8 * (2 * t["stages"] + 2))
    assert smem <= 232448
    assert t["per_sm"] * (smem + 1024) <= 233472  # the SM's 228 KB
    for M, N, K in [(1, 1, 1), (200, 130, 261), (200, 136, 264),
                    (8192, 8192, 8192), (16384, 32000, 2048), (384, 640, 264),
                    (4097, 3001, 777)]:
        for ctas in (None, 1, 64, 132, 396):
            p = tmm.hgemm_plan(M, N, K, key, ctas)
            assert p["k_pad"] % 8 == 0 and K <= p["k_pad"] < K + 8
            assert p["n_pad"] % 8 == 0 and N <= p["n_pad"] < N + 8
            assert p["pad"] == ((p["k_pad"], p["n_pad"]) != (K, N))
            rb, cb = -(-M // bm), -(-p["n_pad"] // bn)
            assert (p["row_blocks"], p["col_blocks"]) == (rb, cb)
            assert p["units"] == -(-rb // t["cluster"]) * cb
            cap = t["per_sm"] * 132 if ctas is None else ctas
            g = p["grid"]
            assert g % t["cluster"] == 0 and g <= max(cap, 0)
            assert g // t["cluster"] <= p["units"]  # no CTA without a unit
            if cap >= t["cluster"]:
                assert g >= t["cluster"]
                assert g == min(cap // t["cluster"], p["units"]) * t["cluster"]


def walk(rb, cb, cluster, group, grid):
    """The persistent kernel's walk: [(cta, unit, (i, j))] in each CTA's
    order, for row blocks past rb too (those rows are not stored)."""
    ni = -(-rb // cluster)
    units = ni * cb
    taken = []
    for cta in range(grid):
        first, rank = cta // cluster, cta % cluster
        for u in range(first, units, grid // cluster):
            I, j = tmm.tile_ij(u, ni, cb, group)
            taken.append((cta, u, (I * cluster + rank, j)))
    return taken


@pytest.mark.parametrize("rb,cb", [(1, 1), (3, 10), (64, 64), (7, 250),
                                   (2, 3), (8, 5)])
@pytest.mark.parametrize("group", [None, 1, 4, 8, 16])
@pytest.mark.parametrize("cluster", [1, 2])
def test_walk_takes_every_tile_once(rb, cb, group, cluster):
    ni = -(-rb // cluster)
    for grid in (cluster, 2 * cluster, 66 * cluster, 132 * cluster):
        grid = min(grid // cluster, ni * cb) * cluster
        taken = walk(rb, cb, cluster, group, grid)
        tiles = [ij for _, _, ij in taken if ij[0] < rb]
        assert sorted(tiles) == [(i, j) for i in range(rb)
                                 for j in range(cb)], (grid, group)
        # both CTAs of a pair take the same units
        by_cta = {}
        for cta, u, _ in taken:
            by_cta.setdefault(cta, []).append(u)
        for cta in by_cta:
            assert by_cta[cta] == by_cta[cta - cta % cluster]
    # the order of the units: row-major, or JAX's _swizzled_ij
    for u in range(ni * cb):
        want = (_swizzled_ij(u, ni, cb, group) if group
                else (u // cb, u % cb))
        assert tmm.tile_ij(u, ni, cb, group) == tuple(int(v) for v in want)


def _bf16_or_f16(a, dt):
    return torch.from_numpy(a).to(dt)


@pytest.mark.parametrize("M,N,K", RAGGED_MNK,
                         ids=[f"{m}x{n}x{k}" for m, n, k in RAGGED_MNK])
@pytest.mark.parametrize("layout", ["nn", "tn"])
@pytest.mark.parametrize("dt,jdt", [(torch.bfloat16, jnp.bfloat16),
                                    (torch.float16, jnp.float16)],
                         ids=["bf16", "f16"])
def test_zero_padding_is_exact(M, N, K, layout, dt, jdt):
    rng = np.random.default_rng(M + N + K)
    x = _bf16_or_f16(rng.standard_normal((M, K), dtype=np.float32), dt)
    yk = rng.standard_normal((K, N) if layout == "nn" else (N, K),
                             dtype=np.float32)
    y = _bf16_or_f16(yk, dt)
    for key in TC_KEYS:
        plan = tmm.hgemm_plan(M, N, K, key)
        assert plan["pad"] == bool(K % 8 or N % 8)
        xp, yp = tmm.pad_operands(x, y, layout, plan)
        assert xp.shape == (M, plan["k_pad"])
        assert yp.shape == ((plan["k_pad"], plan["n_pad"]) if layout == "nn"
                            else (plan["n_pad"], plan["k_pad"]))
        # the padding is zeros, the operands are unchanged
        assert torch.equal(xp[:, :K], x) and not xp[:, K:].any()
        ypl = yp if layout == "nn" else yp.t()
        yl = y if layout == "nn" else y.t()
        assert torch.equal(ypl[:K, :N], yl) and not ypl[K:].any() \
            and not ypl[:, N:].any()
        full = xp.double() @ ypl.double()
        assert torch.equal(full[:, :N], x.double() @ yl.double())
        assert not full[:, N:].any()
    # rounded once, as the kernel does, against JAX's kernel in interpret
    # mode; each element within the f32 reordering bound of a K-term dot
    want = np.array(j_make_matmul(
        block=(128, 128, 128), layout=layout, out_dtype=jnp.float32)(
        jnp.asarray(x.float().numpy(), jdt), jnp.asarray(y.float().numpy(),
                                                         jdt)))
    got = (x.double() @ yl.double()).float().numpy()
    bound = 2 * K * 2.0 ** -24 * (x.double().abs() @ yl.double().abs())
    assert np.all(np.abs(got - want) <= bound.numpy() + 1e-30)
    for odt in (dt, torch.float32):
        fn = tmm.make_matmul(block=tmm.HALF_DEFAULT, layout=layout,
                             out_dtype=odt)
        out = fn(x, y)  # the CPU tensors take the plain version
        assert out.dtype == odt
        np.testing.assert_allclose(out.float().numpy(),
                                   torch.from_numpy(want).to(odt).float()
                                   .numpy(), atol=2e-2, rtol=2e-2)
