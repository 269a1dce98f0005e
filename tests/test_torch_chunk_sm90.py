"""The chunk attention's two Hopper routes, their plan and walks, on the CPU.

``csrc/chunk_attn.cu`` (route A: split-KV, verify) and ``csrc/chunk_tma.cu``
(route B: TMA + wgmma tiles, chunked prefill and admission) run only on the
GPU, where ``chip_smoke.py`` holds both against the plain versions. What
surrounds their arithmetic is Python that these tests reach:

- ``chunk_plan``: the sources' constants against the wrapper's, the route
  of every chip check and of each serving path's chunk shapes, the grid
  sized from the capacity and the window, never from a length;
- route A's split walk (``split_band``): every (row, key) pair of every row
  visited exactly once over base 0, bases whose chunk runs into the
  capacity, windows across a split edge and groups 1, 2, 4 and 8, no table
  entry past ceil(end / page) read;
- route B's band walk (``chunk_key_range``, ``tma_edge``): every pair once,
  no walked tile outside the band, and a walk that never masks is caught;
- the paged feed's boxes (``paged_boxes``) at pages 16, 64, 128 and 256,
  and the page sizes it cannot take going to route A;
- ``chunk_split_plain`` (route A's split and merge order in torch ops)
  against JAX's ``make_chunk_attention`` / ``make_paged_chunk_attention`` in
  Pallas interpret mode with NaN padding, bf16 / int8 / e4m3, windows,
  caps, the lse and head dims 64, 128 and 256 (f32 at atol 1e-5 and bf16
  at the registry's 2e-2, as ``test_torch_chunk.py`` holds the plain
  versions), and batch-invariant bit for bit;
- the split workspace and counters the launch takes from its stream
  (``gemm/quant.py _split_scratch``) surviving their growth.
"""

import ctypes
import gc
import re
import weakref
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.attention.chunk import (make_chunk_attention,
                                          make_paged_chunk_attention)
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.attention import chunk as ck
from leetcuda_tpu_torch.core.runtime import cdiv
from leetcuda_tpu_torch.models.convert import params_from_numpy

CSRC = Path(ck.__file__).parent.parent / "csrc"
SPLIT = 16  # keys a split in the JAX comparisons: rows cross several


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# --- the plan ----------------------------------------------------------------

def test_plan_constants_are_the_sources():
    """SPLIT_CONSTS and TMA_PLAN are what the sources build without macros
    (the wrapper also compares them with lc_chunk_plan and
    lc_chunk_tma_plan on the card, ``check_build``)."""
    a = (CSRC / "chunk_attn.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", a)}
    stages = int(re.search(r"#define LC_CHUNK_SPLIT_STAGES (\d+)", a)[1])
    assert (consts["kHB"], consts["kTK"], stages,
            consts["kMaxSplits"]) == ck.SPLIT_CONSTS
    b = (CSRC / "chunk_tma.cu").read_text()
    macros = {k: int(v) for k, v in re.findall(
        r"#define (LC_CHUNK_\w+) (\d+)", b)}
    assert macros == {"LC_CHUNK_KEYS": 0, "LC_CHUNK_STAGES": 0}
    wide = re.search(r"D > 128 \? TmaPlan\{(\d+), (\d+)\}", b)
    assert ck.TMA_PLAN[256] == (int(wide[1]), int(wide[2]))
    narrow = re.search(r"LC_CHUNK_KEYS : (\d+),\s+LC_CHUNK_STAGES \? "
                       r"LC_CHUNK_STAGES\s+: \(D > 64 \? (\d+) : (\d+)\)", b)
    keys, s128, s64 = map(int, narrow.groups())
    assert ck.TMA_PLAN[128] == (keys, s128) and ck.TMA_PLAN[64] == (keys, s64)
    assert int(re.search(r"kRows = (\d+)", b)[1]) == ck.TMA_ROWS
    for D in (64, 128, 256):
        for quant in (False, True):
            assert ck.tma_smem(D, quant) <= ck.SMEM_LIMIT
    # the decode split keys are the tile's multiples, as decode's
    assert all(s % ck.SPLIT_CONSTS[1] == 0 for s in ck.SPLIT_KEYS.values())


# chip_smoke.py check_chunk / chunk_cases and the paths' chunk calls:
# (label, B, H, Hkv, T, D, S, window, page, quantized, route)
ROUTES = [
    ("verify B=8 T=4", 8, 16, 4, 4, 128, 2048, None, 0, False, "split"),
    ("verify int8", 8, 16, 4, 4, 128, 2048, None, 0, True, "split"),
    ("verify fp8 pages 128", 8, 16, 4, 4, 128, 2048, None, 128, True,
     "split"),
    ("verify pages 16", 8, 16, 4, 4, 128, 2048, None, 16, False, "split"),
    ("verify window 256", 8, 16, 4, 4, 128, 2048, 256, 0, False, "split"),
    ("GPT-OSS verify G=8 D=64 lse", 8, 64, 8, 4, 64, 1024, 128, 0, False,
     "split"),
    ("admit T=256 base 1024 fp8 pages 128", 1, 16, 4, 256, 128, 2048, None,
     128, True, "tma"),
    ("admit T=1024", 1, 16, 4, 1024, 128, 2048, None, 0, False, "tma"),
    ("Gemma-2-27B T=512 W 4096 pages 128", 2, 32, 16, 512, 128, 6144, 4096,
     128, False, "tma"),
    ("Gemma-2-9B D=256 T=512 pages 128", 2, 16, 8, 512, 256, 6144, 4096,
     128, False, "tma"),
    ("GPT-OSS T=512 W 128", 2, 64, 8, 512, 64, 1024, 128, 128, False,
     "tma"),
    # the serving paths
    ("(f) verify, pages 128", 4, 16, 4, 4, 128, 1536, None, 128, False,
     "split"),
    ("(h) verify, int8", 8, 16, 4, 4, 128, 256, None, 0, True, "split"),
    ("(p) speculative verify, G=8", 8, 64, 8, 4, 64, 256, 128, 0, True,
     "split"),
    ("(g) prefill chunk 256, fp8 pages", 4, 16, 4, 256, 128, 1536, None, 128,
     True, "tma"),
    ("(o) prefill chunk 512", 4, 32, 16, 512, 128, 6144, 4096, 128, False,
     "tma"),
    ("(o) last chunk of 300", 4, 32, 16, 300, 128, 6144, None, 128, False,
     "tma"),
    ("(r) prefill chunk 512, D=256", 4, 16, 8, 512, 256, 6144, 4096, 128,
     False, "tma"),
    ("(p) prefill chunk 256, int8 pages", 4, 64, 8, 256, 64, 1024, 128, 128,
     True, "tma"),
    # the crossover: 64 rows a KV head over a bf16 cache, 256 quantized
    ("T=16 G=4 bf16", 8, 16, 4, 16, 128, 2048, None, 0, False, "tma"),
    ("T=8 G=4 bf16", 8, 16, 4, 8, 128, 2048, None, 0, False, "split"),
    ("T=64 G=4 int8", 8, 16, 4, 64, 128, 2048, None, 0, True, "tma"),
    ("T=32 G=4 int8", 8, 16, 4, 32, 128, 2048, None, 0, True, "split"),
    ("(g) a suffix chunk of 16, fp8 pages", 4, 16, 4, 16, 128, 1536, None,
     128, True, "split"),
    # page sizes the TMA feed cannot take: route A at any T
    ("T=512, pages of 24", 2, 32, 16, 512, 128, 6144, None, 24, False,
     "split"),
    ("T=512, pages of 1", 1, 8, 4, 512, 64, 1024, None, 1, True, "split"),
    ("T=512, pages of 4", 1, 8, 4, 512, 64, 1024, None, 4, False, "split"),
]


@pytest.mark.parametrize("case", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_rule(case):
    _, B, H, Hkv, T, D, S, window, page, quant, route = case
    plan = ck.chunk_plan(B, H, Hkv, T, D, S, window, page, quant)
    assert plan.route == route
    R = H // Hkv * T
    if route == "tma":
        assert plan.grid == (cdiv(R, ck.TMA_ROWS), B * Hkv)
        assert (plan.keys, plan.stages) == ck.TMA_PLAN[D]
        assert plan.smem == ck.tma_smem(D, quant) <= ck.SMEM_LIMIT
        return
    band = min(S, window + T - 1) if window else S
    n = max(1, cdiv(band, ck.SPLIT_KEYS[D]))
    assert plan.grid == (n, Hkv * cdiv(R, 16), B)
    assert plan.n_splits == n and plan.split_keys == ck.SPLIT_KEYS[D]
    if n > 1:
        assert plan.workspace == B * H * T * n * (D + 2)
        assert plan.counters == B * Hkv * cdiv(R, 16)
    else:
        assert plan.workspace == plan.counters == 0


def test_plan_forces_and_feeds():
    assert ck.chunk_plan(8, 16, 4, 4, 128, 2048, route="tma").route == "tma"
    assert ck.chunk_plan(1, 16, 4, 1024, 128, 2048,
                         route="split").route == "split"
    assert ck.chunk_plan(8, 16, 4, 4, 128, 2048,
                         split_keys=64).n_splits == 32
    for page in (8, 16, 32, 64, 128, 256, 512):
        assert ck.tma_feeds(page, 128)
    for page in (1, 4, 12, 24, 48, 96, 200):
        assert not ck.tma_feeds(page, 128)
    assert ck.tma_feeds(192, 256) and not ck.tma_feeds(192, 128)


# --- route A's split walk ----------------------------------------------------

def _band(base, T, S, window, G):
    """(R, S) keep mask of the G * T rows of one sequence (row g * T + t)."""
    limit = min(max(base, 0), S) + np.arange(T) + 1
    cols = np.arange(S)[None, :]
    keep = cols < limit[:, None]
    if window:
        keep &= cols >= limit[:, None] - window
    return np.tile(keep, (G, 1))


def walk_split(base, T, S, G, window, split, page=None):
    """Route A's visits of (row, key) for one sequence and KV head: the
    grid's splits from the capacity, a CTA past its band exits, a row block
    of 16 rows walks its split's 32-key tiles, keys at or past the split's
    end are zero-filled and each row keeps keys below its limit (and the
    split's end) and at or above its floor. Returns the visits and the
    logical pages looked up."""
    R = G * T
    plan = ck.chunk_plan(1, G, 1, T, 64, S, window, page or 0, False,
                         route="split", split_keys=split)
    lo, end = ck.split_band(base, T, S, window)
    b = min(max(base, 0), S)
    n_live = max(1, cdiv(end - lo, split))
    assert n_live <= plan.n_splits
    seen = np.zeros((R, S), np.int32)
    pages = set()
    for si in range(plan.n_splits):
        if si >= n_live:
            continue
        jb, je = lo + si * split, min(lo + (si + 1) * split, end)
        for r0 in range(0, R, 16):
            for j0 in range(jb, je, 32):
                for j in range(j0, j0 + 32):
                    if j < je and page:
                        pages.add(j // page)
                    for r in range(r0, min(r0 + 16, R)):
                        t = r % T
                        lim, flo = min(b + t + 1, je), (
                            b + t + 1 - window if window else 0)
                        if j < lim and j >= flo:
                            seen[r, j] += 1
    return seen, pages, end


SPLIT_WALKS = [  # base, T, S, G, window, split
    (0, 4, 200, 4, None, 32), (100, 4, 200, 4, None, 32),
    (197, 4, 200, 4, None, 32), (200, 4, 200, 4, None, 32),
    (190, 5, 200, 2, 40, 32), (63, 4, 200, 8, 33, 32),
    (95, 3, 200, 1, 64, 32), (120, 16, 200, 4, 70, 64),
    (0, 1, 96, 8, None, 32), (50, 7, 130, 2, 1, 32), (130, 7, 130, 2, 2, 32),
]


@pytest.mark.parametrize("base,T,S,G,window,split", SPLIT_WALKS)
def test_split_walk_visits_each_pair_once(base, T, S, G, window, split):
    seen, _, _ = walk_split(base, T, S, G, window, split)
    np.testing.assert_array_equal(seen, _band(base, T, S, window, G))


@pytest.mark.parametrize("page", [1, 16, 24, 128])
def test_split_walk_reads_no_table_entry_past_the_chunk(page):
    for base in (0, 37, 250, 252):
        seen, pages, end = walk_split(base, 4, 256, 4, None, 64, page=page)
        assert pages and max(pages) < cdiv(end, page)


def test_split_walk_catches_a_missing_floor():
    """The walk's check can fail: without the rows' window floors the
    keys left of a row's window are kept."""
    real = ck.split_band
    try:
        ck.split_band = lambda base, T, S, window: real(base, T, S, None)
        with pytest.raises(AssertionError):
            test_split_walk_visits_each_pair_once(190, 5, 200, 2, 40, 32)
    finally:
        ck.split_band = real


# --- route B's band walk -----------------------------------------------------

def walk_tma(base, T, S, G, window, keys):
    """Route B's visits for one sequence and KV head: CTAs of 128 rows,
    heaviest first, walk the key tiles of chunk_tiles over their rows;
    a 64-row warpgroup computes a tile that meets its own range, masked
    where tma_edge says, else every pair of its live rows kept. Returns the
    visits and the walked tiles that hold no pair of the band."""
    R = G * T
    band = _band(base, T, S, window, G)
    b = min(max(base, 0), S)
    seen = np.zeros((R, S), np.int32)
    outside = 0
    n_cta = cdiv(R, 128)
    for x in range(n_cta):
        q0 = (n_cta - 1 - x) * 128
        for kt in ck.chunk_tiles(q0, q0 + 128, R, T, b, S, window, keys):
            k0 = kt * keys
            rows = slice(q0, min(q0 + 128, R))
            outside += not band[rows, k0:k0 + keys].any()
            for r0 in range(q0, q0 + 128, 64):
                lo_w, hi_w = ck.chunk_key_range(r0, r0 + 64, R, T, b, S,
                                                window)
                if not (k0 < hi_w and k0 + keys > lo_w):
                    continue
                r = np.arange(r0, min(r0 + 64, R))[:, None]
                c = np.arange(k0, min(k0 + keys, S))[None, :]
                tb = band[r, c]
                if ck.tma_edge(k0, keys, r0, R, T, b, S, window):
                    hit = tb
                else:  # no mask: every live pair of the tile is kept
                    assert tb.all(), (r0, k0)
                    hit = np.ones_like(tb)
                seen[r, c] += hit
    return seen, outside


TMA_WALKS = [  # base, T, S, G, window
    (0, 256, 512, 4, None), (1024, 256, 2048, 4, None),
    (300, 300, 700, 2, 100), (3700, 512, 6144, 2, 4096),
    (5000, 512, 6144, 2, 4096), (0, 100, 300, 3, 64), (250, 64, 256, 4, 16),
    (256, 40, 256, 8, 300), (10, 200, 1024, 1, 1), (5, 70, 300, 2, None),
    # a CTA across one g boundary with a window shorter than the chunk: the
    # keys between its two bands are skipped
    (500, 300, 2048, 2, 40), (1800, 300, 2048, 2, 20), (0, 200, 256, 2, 8),
]


@pytest.mark.parametrize("keys", [64, 128])
@pytest.mark.parametrize("base,T,S,G,window", TMA_WALKS)
def test_band_walk_visits_each_pair_once(base, T, S, G, window, keys):
    seen, outside = walk_tma(base, T, S, G, window, keys)
    np.testing.assert_array_equal(seen, _band(base, T, S, window, G))
    assert outside == 0


def test_band_walk_without_the_mask_is_caught():
    real = ck.tma_edge
    try:
        ck.tma_edge = lambda *a: False
        with pytest.raises(AssertionError):
            walk_tma(100, 256, 512, 2, None, 128)
    finally:
        ck.tma_edge = real


def test_band_walk_skips_tiles_left_of_the_window():
    # rows t 0..127 of g 0 at base 3700, window 4096: keys from 0; at base
    # 5000 from 905, so tiles 0-6 of 128 are never loaded
    assert ck.chunk_key_range(0, 128, 1024, 512, 5000, 6144, 4096) == (
        905, 5128)
    assert ck.chunk_key_range(0, 128, 1024, 512, 3700, 6144, 4096) == (
        0, 3828)
    # rows across two g's walk the whole chunk's band
    assert ck.chunk_key_range(448, 576, 1024, 512, 0, 6144, None) == (0, 512)
    # a chunk past the capacity with a tiny window keeps nothing
    assert ck.chunk_key_range(0, 8, 8, 4, 256, 256, 1) == (0, 0)


# --- the paged feed ------------------------------------------------------------

@pytest.mark.parametrize("keys", [64, 128])
@pytest.mark.parametrize("page", [16, 64, 128, 256])
def test_paged_boxes_cover_each_key_once(page, keys):
    for end in (1, page - 1, page, 3 * page + 5, 1000):
        covered = np.zeros(cdiv(end, keys) * keys, np.int32)
        for k0 in range(0, end, keys):
            for r, lp, y, rows in ck.paged_boxes(k0, keys, page, end):
                assert lp < cdiv(end, page)       # no table entry past end
                assert y + rows <= page           # inside one page
                assert r % 8 == 0                 # the swizzle's 8-row atom
                assert lp * page + y == k0 + r    # the stage row's key
                covered[k0 + r:k0 + r + rows] += 1
        # every key below end once; past the last page none
        assert (covered[:end] == 1).all()
        assert (covered[cdiv(end, page) * page:] == 0).all()


# --- route A's split and merge against JAX ------------------------------------

_QDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _poison(arrays, dead):
    for a in arrays:
        if a.dtype.name == "float8_e4m3fn":
            a.view(np.uint8)[dead] = 0x7F
        elif a.dtype == np.int8:
            a[dead] = 0
        else:
            a[dead] = np.nan


def _case(seed, T, group, bases, D, S, fmt=None, page=None,
          dtype=np.float32):
    """Seeded q and caches, NaN (e4m3: 0x7F) at or past every base + T, and
    paged: pools of ``page`` behind a shuffled table, NaN wherever no row
    owns a position. Returns (numpy args in JAX's order, tensors)."""
    rng = np.random.default_rng(seed)
    bases = np.asarray(bases, np.int32)
    B, Hkv = len(bases), 2
    q = rng.standard_normal((B, Hkv * group, T, D), dtype=np.float32)
    caches = [rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
              for _ in range(2)]
    if fmt is not None:
        quant = [jl._quantize_token_kv(jnp.asarray(c), _QDT[fmt])
                 for c in caches]
        caches = [np.array(quant[0][0]), np.array(quant[1][0]),
                  np.array(quant[0][1]), np.array(quant[1][1])]
    elif dtype is not np.float32:
        q = np.asarray(jnp.asarray(q, dtype))
        caches = [np.array(jnp.asarray(c, dtype)) for c in caches]
    end = np.minimum(bases + T, S)
    dead = np.arange(S)[None, :] >= end[:, None]
    _poison(caches, np.broadcast_to(dead[:, None, :], (B, Hkv, S)))
    tail = [bases]
    if page:
        P, N = S // page, B * (S // page) + 1
        table = np.zeros((B, P), np.int32)
        phys = rng.permutation(np.arange(1, N))
        pools = [np.empty((N, Hkv, page) + c.shape[3:], c.dtype)
                 for c in caches]
        _poison(pools, np.ones((N, Hkv, page), bool))
        n = 0
        for b in range(B):
            for i in range(-(-int(end[b]) // page)):
                table[b, i] = phys[n]
                for pool, c in zip(pools, caches):
                    pool[phys[n]] = c[b, :, i * page:(i + 1) * page]
                n += 1
        caches, tail = pools, [table, bases]
    args = [q, *caches, *tail]
    return args, params_from_numpy(args, "cpu")


def _split_of(targs, fmt, page, **kw):
    """``chunk_split_plain`` over the port's arguments (pools gathered
    through the table, as route A reads them)."""
    q, *ops, base = targs
    if page:
        table = ops.pop()
        ops = [ck._gather(t, table) for t in ops]
    k, v = ops[:2]
    ks, vs = (ops[2], ops[3]) if fmt else (None, None)
    return ck.chunk_split_plain(q, k, v, base, k_scale=ks, v_scale=vs,
                                split_keys=SPLIT, **kw)


# (group, T, D, S, bases, format, page, window, softcap, lse): bases at 0,
# on and across a split edge of 16 keys, and with base + T at or past the
# capacity; windows across a split edge
SPLIT_CASES = {
    "G1 T4 D64": (1, 4, 64, 80, [0, 13, 78], None, None, None, None, True),
    "G2 T5 D128 window 21": (2, 5, 128, 80, [0, 30, 80], None, None, 21,
                             None, True),
    "G4 T3 D64 int8 cap 30": (4, 3, 64, 64, [16, 29, 62], "int8", None,
                              None, 30.0, True),
    "G8 T4 D64 fp8 window 20": (8, 4, 64, 64, [3, 40, 61], "fp8", None, 20,
                                None, True),
    "G2 T4 D256 cap 50": (2, 4, 256, 48, [0, 17, 44], None, None, None, 50.0,
                          False),
    "G4 T6 D128 paged 16": (4, 6, 128, 64, [0, 31, 60], None, 16, None, None,
                            True),
    "G2 T4 D64 paged 16 int8 window 17": (2, 4, 64, 64, [15, 33, 63], "int8",
                                          16, 17, 0.5, True),
    "G4 T2 D64 paged 16 fp8": (4, 2, 64, 64, [1, 47, 64], "fp8", 16, None,
                               None, False),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_plain_matches_pallas(name):
    G, T, D, S, bases, fmt, page, window, cap, lse = SPLIT_CASES[name]
    jargs, targs = _case(len(name), T, G, bases, D, S, fmt, page)
    make = (make_paged_chunk_attention if page else
            lambda **kw: make_chunk_attention(block_k=16, **kw))
    want = make(window=window, quantized=fmt is not None, softcap=cap,
                with_lse=lse)(*(jnp.asarray(a) for a in jargs))
    got = _split_of(targs, fmt, page, window=window, softcap=cap,
                    with_lse=lse)
    pairs = zip(got, want) if lse else [(got, want)]
    for g, w in pairs:
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=1e-5, rtol=0)


def test_split_plain_bf16_matches_pallas():
    """bf16 q and cache at the registry's tolerance (2e-2)."""
    jargs, targs = _case(9, 4, 4, [0, 20, 60], 128, 64,
                         dtype=jnp.bfloat16)
    want = np.asarray(make_chunk_attention(block_k=16)(
        *(jnp.asarray(a) for a in jargs)), np.float32)
    got = _split_of(targs, None, None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("window", [None, 20])
def test_split_plain_batch_invariant(window):
    """A row alone gives the same bits as its row in the batch: its splits
    and merge order follow its own sequence alone."""
    bases = [61, 0, 17, 15, 33, 64]
    _, targs = _case(11, 4, 4, bases, 64, 64, "int8")
    q, k, v, ks, vs, base = targs
    kw = dict(k_scale=ks, v_scale=vs, window=window, softcap=5.0,
              with_lse=True, split_keys=SPLIT)
    out, lse = ck.chunk_split_plain(q, k, v, base, **kw)
    ref = ck.chunk_attention_plain(q, k, v, base, k_scale=ks, v_scale=vs,
                                   window=window, softcap=5.0, with_lse=True)
    torch.testing.assert_close(out, ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, ref[1], atol=1e-5, rtol=0)
    for b in range(len(bases)):
        sl = slice(b, b + 1)
        o1, l1 = ck.chunk_split_plain(
            q[sl], k[sl], v[sl], base[sl],
            **{**kw, "k_scale": ks[sl], "v_scale": vs[sl]})
        assert torch.equal(o1, out[sl]) and torch.equal(l1, lse[sl])


# --- the launch and its scratch ------------------------------------------------

@pytest.fixture
def fake_launch(monkeypatch):
    """``build.entry`` bound to recorders, a fake stream, no capture, empty
    scratch tables; returns the calls (symbol, args)."""
    import leetcuda_tpu_torch.build as build
    from leetcuda_tpu_torch.gemm import quant as gq

    calls = []

    def fake_entry(lib, symbol, argtypes):
        assert (lib, symbol) in (("chunk_attn", "lc_chunk_split"),
                                 ("chunk_tma", "lc_chunk_tma"))
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
        return proto(lambda *a: calls.append((symbol, a)) or 0)

    class Stream:
        cuda_stream = 4242

    monkeypatch.setattr(build, "entry", fake_entry)
    monkeypatch.setattr(ck, "_BUILD_CHECKED", {"chunk_attn", "chunk_tma"})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(gq, "_SPLIT_SCRATCH", {})
    monkeypatch.setattr(gq, "_SPLIT_RETIRED", [])
    return calls


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_launch_sizes_the_grid_from_the_capacity(fake_launch):
    B, H, Hkv, T, D, S = 3, 16, 4, 4, 128, 1024
    q, k = _bf(B, H, T, D), _bf(B, Hkv, S, D)
    out = torch.empty_like(q)
    for bases in ([0, 0, 0], [S, S, S]):  # the grid never follows them
        base = torch.tensor(bases, dtype=torch.int32)
        plan, err = ck.launch(q, k, k, None, None, None, base, out, None,
                              scale=0.1, window=0, softcap=0.0)
        assert err == 0 and plan.route == "split"
        symbol, a = fake_launch[-1]
        assert symbol == "lc_chunk_split"
        assert a[11:21] == (B, H, Hkv, T, S, 0, D, 0, ck.SPLIT_KEYS[D],
                            S // ck.SPLIT_KEYS[D])
        assert a[9] and a[10]  # the stream's workspace and counters
    # a chunk of 256 rows a KV head over paged fp8 pools: route B, the pool's
    # page count passed for its tensor maps
    pool = torch.zeros(20, Hkv, 128, D, dtype=torch.float8_e4m3fn)
    sc = torch.zeros(20, Hkv, 128)
    table = torch.zeros(B, 8, dtype=torch.int32)
    q2 = _bf(B, H, 64, D)
    plan, _ = ck.launch(q2, pool, pool, sc, sc, table, base, q2.clone(),
                        None, scale=0.1, window=0, softcap=0.0)
    symbol, a = fake_launch[-1]
    assert plan.route == "tma" and symbol == "lc_chunk_tma"
    assert a[9:18] == (B, H, Hkv, 64, 8 * 128, 128, 20, D, 2)


def test_split_scratch_survives_growth(fake_launch):
    """The stream's split workspace and counters, replaced by larger ones
    when a later call needs more, stay alive: a graph captured before the
    growth still launches into them."""
    from leetcuda_tpu_torch.gemm import quant as gq

    H, Hkv, T, D, S = 16, 4, 4, 128, 1024
    k = _bf(1, Hkv, S, D)
    q = _bf(1, H, T, D)
    base = torch.zeros(1, dtype=torch.int32)
    ck.launch(q, k, k, None, None, None, base, torch.empty_like(q), None,
              scale=0.1, window=0, softcap=0.0)
    ws, cnt = gq._SPLIT_SCRATCH[(None, 4242)]
    refs = [weakref.ref(ws), weakref.ref(cnt)]
    assert fake_launch[-1][1][9] == ws.data_ptr()
    del ws, cnt
    B = 300  # more row blocks than the first counters hold
    kb, qb = _bf(B, Hkv, S, D), _bf(B, H, T, D)
    ck.launch(qb, kb, kb, None, None, None, torch.zeros(B, dtype=torch.int32),
              torch.empty_like(qb), None, scale=0.1, window=0, softcap=0.0)
    gc.collect()
    assert all(r() is not None for r in refs)
    assert {id(r()) for r in refs} <= {id(t) for t in gq._SPLIT_RETIRED}
    ws2, cnt2 = gq._SPLIT_SCRATCH[(None, 4242)]
    plan = ck.chunk_plan(B, H, Hkv, T, D, S)
    assert ws2.numel() >= plan.workspace and cnt2.numel() >= plan.counters
    assert not cnt2.any()


# --- the bench -------------------------------------------------------------------

def test_attn_bench_chunk_cli(tmp_path):
    import json
    import subprocess
    import sys

    out = tmp_path / "rows.json"
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.attn_bench",
         "--chunk", "--device", "cpu", "--chunk-t", "4", "16", "--chunk-g",
         "2", "--chunk-s", "128", "--rounds", "1", "--iters", "1", "--json",
         str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no device metric" in r.stdout
    rows = json.loads(out.read_text())["rows"]
    # on the CPU only the plain versions run, once a case, exact
    assert {row["variant"] for row in rows} == {"plain"}
    assert [(row["fmt"], row["T"], row["G"]) for row in rows] == [
        ("bf16", 4, 2), ("bf16", 16, 2), ("int8", 4, 2), ("int8", 16, 2)]
    assert all(row["max_abs_err"] == 0 for row in rows)
