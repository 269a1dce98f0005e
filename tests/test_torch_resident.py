"""The resident matmul chain's launch plan, its persistent walk and its
padding, on the CPU; its f16 results against the JAX package's.

On this CPU ``make_matmul_resident`` runs its plain version; the TMA +
wgmma kernel of ``csrc/matmul_resident.cu`` runs on the GPU, held against
the same plain version by ``chip_smoke.py`` path (l). What the kernel does
around its arithmetic is Python or is modelled here:

- ``resident_plan``: the tiles, the grid, the counters and the padded N the
  wrapper launches with;
- the walk: every CTA (or CTA pair) takes work units b, b + G, ... in
  order, and a unit of rep r > 0 waits until the counter of its row block
  in rep r - 1 has reached the number of column tiles. A simulation runs
  such walks under random interleavings, with the producer up to a few
  units ahead of its consumers, and checks that each finishes and that no
  unit reads rows before their last writer finished or after a later rep
  overwrote them;
- the padding to N8 = ceil(N / 8) * 8: the plain chain over the zero-padded
  operands, sliced back, equals the unpadded chain bit for bit.
The f16 chain is held against JAX's ``make_matmul_resident`` in interpret
mode and ``matmul_chain_ref`` at the registry's 2e-2 (a rounding to f16
each rep on both sides, sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.gemm.matmul import make_matmul_resident as j_resident
from leetcuda_tpu.gemm.matmul import matmul_chain_ref as j_chain_ref
from leetcuda_tpu_torch.core.testing import _from_f64
from leetcuda_tpu_torch.gemm import matmul as tmm

CLUSTER1 = dict(tmm.RESIDENT_TILE, cluster=1)
NARROW = dict(tmm.RESIDENT_TILE, block_n=128)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cdiv(a, b):
    return -(-a // b)


# --- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("reps", [1, 4])
@pytest.mark.parametrize("M,N", [(1, 8), (37, 30), (128, 256), (129, 257),
                                 (1000, 1030), (4097, 2048), (4096, 4096)])
@pytest.mark.parametrize("tile", [None, CLUSTER1, NARROW],
                         ids=["default", "cluster1", "bn128"])
def test_resident_plan(M, N, reps, tile):
    t = tile or tmm.RESIDENT_TILE
    p = tmm.resident_plan(M, N, reps, ctas=132, tile=tile)
    assert p["n_pad"] % 8 == 0 and N <= p["n_pad"] < N + 8
    assert p["row_blocks"] == _cdiv(M, t["block_m"])
    assert p["col_blocks"] == _cdiv(p["n_pad"], t["block_n"])
    assert p["tiles"] == reps * p["row_blocks"] * p["col_blocks"]
    assert p["counters"] == reps * p["row_blocks"]
    units = reps * _cdiv(p["row_blocks"], t["cluster"]) * p["col_blocks"]
    # whole clusters, never more CTAs than work units or co-resident slots
    assert p["grid"] % t["cluster"] == 0
    assert p["grid"] == min(132 // t["cluster"], units) * t["cluster"]
    assert p["grid"] >= t["cluster"]
    assert all(p[k] == t[k] for k in t)


def test_resident_tile_is_the_sources_default():
    """RESIDENT_TILE is what csrc/matmul_resident.cu builds by default (the
    wrapper also compares it with the library's own report on the card)."""
    import re
    from pathlib import Path

    csrc = Path(tmm.__file__).parent.parent / "csrc"
    src = (csrc / "matmul_resident.cu").read_text()
    macro = {k: int(v) for k, v in
             re.findall(r"#define (LC_RES_\w+) (\d+)", src)}
    t = tmm.RESIDENT_TILE
    assert macro == {"LC_RES_BN": t["block_n"], "LC_RES_STAGES": t["stages"],
                     "LC_RES_CLUSTER": t["cluster"], "LC_RES_PROBE": 0}
    # the chain's tile is the dense kernel's plan (gemm_sm90.cuh) at BM 128
    assert ("GemmPlan<128, LC_RES_BN, LC_RES_STAGES, LC_RES_CLUSTER, 1, kBkn>"
            in src)
    plan = (csrc / "gemm_sm90.cuh").read_text()
    assert "BM = BM_, BN = BN_, BK = 64" in plan
    assert (t["block_m"], t["block_k"]) == (128, 64)


def test_resident_plan_co_resident_cap():
    # the grid follows the card's co-resident count, not 132
    assert tmm.resident_plan(4096, 4096, 5, ctas=114)["grid"] == 114
    assert tmm.resident_plan(4096, 4096, 5, ctas=131)["grid"] == 130
    assert tmm.resident_plan(4096, 4096, 5, ctas=131,
                             tile=CLUSTER1)["grid"] == 131
    assert tmm.resident_plan(4096, 4096, 5)["grid"] == 132


# --- the persistent walk -----------------------------------------------------

def simulate_walk(reps, nbm, nbn, n_agents, cluster, ahead, seed, wait=True):
    """One run of the walk: ``n_agents`` CTAs (CTA pairs when ``cluster`` is
    2) take work units (rep, row group, column block) round-robin in the
    kernel's order; a unit is a load of its rows of rep r's source buffer
    (after the wait on done[r - 1][i] for each of its row blocks) and later
    a store of its tile of rep r's destination, then done[r][i] += 1. An
    agent's producer loads at most ``ahead`` units before its consumers
    have stored the first of them; events of the agents interleave at
    random. Returns (finished, violations)."""
    rng = np.random.default_rng(seed)
    groups = _cdiv(nbm, cluster)
    per_rep = groups * nbn
    units = reps * per_rep
    done = np.zeros((reps, nbm), int)
    # buffer 0 is ``a``; rep r writes buffer 1 + ((reps - 1 - r) & 1) and
    # reads what rep r - 1 wrote; version[buf][i] = (rep, tiles written)
    version = {1: {}, 2: {}}
    reads_open = {}  # (buf, row block) -> units that loaded and not stored
    violations = []

    def dst(r):
        return 1 + ((reps - 1 - r) & 1)

    def blocks(u):
        r, rem = divmod(u, per_rep)
        g, j = divmod(rem, nbn)
        return r, j, [g * cluster + c for c in range(cluster)
                      if g * cluster + c < nbm]

    queues = [list(range(a, units, n_agents)) for a in range(n_agents)]
    loaded = [[] for _ in range(n_agents)]  # loaded, not yet stored
    while any(queues) or any(loaded):
        moves = []
        for a in range(n_agents):
            if queues[a] and len(loaded[a]) < ahead:
                r, _, rows = blocks(queues[a][0])
                if not wait or r == 0 or all(done[r - 1, i] == nbn
                                             for i in rows):
                    moves.append(("load", a))
            if loaded[a]:
                moves.append(("store", a))
        if not moves:
            return False, violations  # every unfinished agent waits
        kind, a = moves[rng.integers(len(moves))]
        if kind == "load":
            u = queues[a].pop(0)
            r, _, rows = blocks(u)
            for i in rows:
                if r > 0:
                    src = dst(r - 1)
                    if version[src].get(i) != (r - 1, nbn):
                        violations.append(("read before written", u, i,
                                           version[src].get(i)))
                    reads_open.setdefault((src, i), set()).add(u)
            loaded[a].append(u)
        else:
            u = loaded[a].pop(0)
            r, j, rows = blocks(u)
            for i in rows:
                if r > 0:
                    reads_open[(dst(r - 1), i)].discard(u)
                buf = dst(r)
                if reads_open.get((buf, i)):
                    violations.append(("overwritten while read", u, i,
                                       sorted(reads_open[(buf, i)])))
                rep, n = version[buf].get(i, (r, 0))
                version[buf][i] = (r, n + 1 if rep == r else 1)
                done[r, i] += 1
    complete = all(version[dst(reps - 1)].get(i) == (reps - 1, nbn)
                   for i in range(nbm))
    return complete, violations


@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("n_agents", range(1, 8))
def test_walk_finishes_and_orders_reads(n_agents, cluster):
    for reps in (1, 2, 3):
        for nbm in (1, 2, 3):
            for nbn in (1, 2, 3):
                for ahead in (1, 2, 4):
                    for seed in range(3):
                        ok, bad = simulate_walk(reps, nbm, nbn, n_agents,
                                                cluster, ahead, seed)
                        assert ok, (reps, nbm, nbn, ahead, seed)
                        assert not bad, (reps, nbm, nbn, ahead, seed, bad)


def test_walk_without_the_wait_is_caught():
    """The checker can fail: without the counter wait some interleaving
    reads rows that are not yet written or are being overwritten."""
    caught = 0
    for seed in range(20):
        ok, bad = simulate_walk(3, 2, 2, 4, 1, 2, seed, wait=False)
        caught += bool(bad)
    assert caught > 0


# --- the padding identity ----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,reps", [(37, 30, 1), (37, 30, 3), (100, 130, 1),
                                      (100, 130, 3), (1000, 1030, 1)])
def test_zero_padding_is_exact(M, N, reps, dtype, rng):
    a = _from_f64(rng.standard_normal((M, N)), dtype)
    b = _from_f64(rng.standard_normal((N, N)) / np.sqrt(N), dtype)
    n8 = tmm.resident_plan(M, N, reps)["n_pad"]
    assert n8 == _cdiv(N, 8) * 8 and n8 > N
    ap = torch.nn.functional.pad(a, (0, n8 - N))
    bp = torch.nn.functional.pad(b, (0, n8 - N, 0, n8 - N))
    padded = tmm.matmul_chain_plain(ap, bp, reps)
    assert torch.equal(padded[:, :N], tmm.matmul_chain_plain(a, b, reps))
    assert not padded[:, N:].any()  # A's extra columns stay 0 every rep


# --- f16 against JAX ---------------------------------------------------------

@pytest.mark.parametrize("reps", [1, 4])
@pytest.mark.parametrize("M,N", [(256, 256), (100, 130)])
def test_matmul_resident_chain_f16(M, N, reps, rng):
    a = rng.standard_normal((M, N))  # unit scale; b at N^-0.5: RMS ~1
    b = rng.standard_normal((N, N)) / np.sqrt(N)
    ta, tb = _from_f64(a, torch.float16), _from_f64(b, torch.float16)
    got = tmm.make_matmul_resident(reps=reps)(ta, tb)
    assert got.dtype == torch.float16 and got.shape == (M, N)
    assert torch.equal(ta, _from_f64(a, torch.float16))  # inputs unchanged
    ja, jb = jnp.asarray(a, jnp.float16), jnp.asarray(b, jnp.float16)
    want = j_resident(reps=reps, block_m=128)(ja, jb)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(j_chain_ref(ja, jb, reps),
                                        np.float32), atol=2e-2, rtol=2e-2)


# --- the build A/B -----------------------------------------------------------

def test_variant_builds_are_libraries_of_their_own():
    from leetcuda_tpu_torch import build
    from leetcuda_tpu_torch.bench.gemm_bench import RESIDENT_VARIANTS

    plain = build._lib_path("matmul_resident")
    paths = {build._lib_path("matmul_resident",
                             tuple(f"-D{k}={v}" for k, v in sorted(d.items())))
             for d in RESIDENT_VARIANTS}
    assert plain not in paths and len(paths) == len(RESIDENT_VARIANTS)
    assert all("-variant-" in p.name for p in paths)
    # the package's build is one of the variants the bench compares
    t = tmm.RESIDENT_TILE
    assert {"LC_RES_BN": t["block_n"], "LC_RES_STAGES": t["stages"],
            "LC_RES_CLUSTER": t["cluster"]} in RESIDENT_VARIANTS


def test_resident_bench_cli(tmp_path):
    import json
    import subprocess
    import sys

    out = tmp_path / "rows.json"
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.gemm_bench",
         "--resident", "--device", "cpu", "--mnk", "64", "--reps", "2",
         "--iters", "1", "--json", str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "chain 64^3 x 2" in r.stdout and "plain chain" in r.stdout
    err = {row["variant"]: row["max_abs_err"]
           for row in json.loads(out.read_text())["rows"]}
    assert set(err) == {"plain chain", "2 torch.matmul", "2 hgemm"}
    # hgemm's CPU path is the plain matmul; torch.matmul another library
    assert err["plain chain"] == 0.0 and err["2 hgemm"] == 0.0
    assert err["2 torch.matmul"] <= 2e-2
