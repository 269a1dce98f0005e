"""The split-KV decode kernel's plan and its split-and-merge, on the CPU.

``csrc/decode_attn.cu`` cuts each row's band of keys into splits of
``SPLIT_KEYS[D]`` keys counted from the band's start and merges the splits in
split order in the same launch; ``attention/decode.py`` keeps that plan
(``split_plan``) and the same split and merge in torch ops
(``attend_split_plain``). The kernel itself runs only on the GPU, where
``chip_smoke.py`` holds it against the plain versions (and a row alone
against its row in the batch, bit for bit). Here the split-and-merge version
is held against the JAX package's ``decode_attention``,
``decode_attention_quantized`` and ``paged_attention`` in Pallas interpret
mode, as their own tests run them, with small splits (16 keys) so that the
rows cross several: lengths 0, 1, split - 1, split, split + 1 and the
capacity, windows whose band ends on a split edge and inside one, softcaps,
the lse, NaN past every length, GQA groups 1, 2, 7, 8 and 16, head dims 64,
128, 256 and MLA's shared 576-lane latent. Everything is f32 and compared at
atol 1e-5 (the same algorithm in the same precision, another summation
order; at D = 576 the scores sum 576 products and read 2e-5).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.attention.decode import (make_decode_attention,
                                           make_decode_attention_quantized)
from leetcuda_tpu.attention.paged import make_paged_attention
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.attention import decode as dec
from leetcuda_tpu_torch.attention import paged as pg
from leetcuda_tpu_torch.core.runtime import as_bytes
from leetcuda_tpu_torch.models.convert import tensor_from_numpy

SPLIT = 16  # keys a split in the JAX comparisons
ATOL = {64: 1e-5, 128: 1e-5, 256: 1e-5, 576: 2e-5}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("D", sorted(dec.SPLIT_KEYS))
def test_split_plan(D):
    """The split length is a multiple of the kernel's tile, fixed by the
    head dim; the grid's splits follow the capacity and the window alone,
    never the batch; one split needs no workspace and no counters."""
    L = dec.SPLIT_KEYS[D]
    assert L % dec.TILE_KEYS == 0 and L >= dec.TILE_KEYS
    for B in (1, 8, 300):
        plan = dec.split_plan(B, 16, 4, D, 4 * L + 1)
        assert plan.split_keys == L and plan.n_splits == 5
        assert plan.head_blocks == 1
        assert plan.workspace == B * 16 * 5 * (D + 2)
        assert plan.counters == B * 4
    assert dec.split_plan(2, 16, 4, D, 4 * L + 1, window=L).n_splits == 1
    assert dec.split_plan(2, 16, 4, D, 4 * L, window=L + 1).n_splits == 2
    assert dec.split_plan(2, 16, 4, D, 4 * L, window=8 * L).n_splits == 4
    one = dec.split_plan(2, 16, 4, D, L)
    assert (one.n_splits, one.workspace, one.counters) == (1, 0, 0)
    assert dec.split_plan(3, 28, 4, D, 1).n_splits == 1
    # head blocks of 16 query heads: MLA's 128 over one latent head in 8
    wide = dec.split_plan(2, 128, 1, D, 3 * L)
    assert wide.head_blocks == 8 and wide.counters == 2 * 8
    assert dec.split_plan(2, 28, 4, D, 3 * L).head_blocks == 1


def _caches(rng, B, H, Hkv, S, D, lengths, fmt, shared=False):
    """q and the caches (B, Hkv, S, D) with NaN past every length (values
    and scales; e4m3: the NaN byte 0x7F; int8: zeros with NaN scales).
    Returns (JAX arguments, the port's arguments): q, k, [v,] [ks, [vs,]]
    lengths, one operand for K and V when ``shared``."""
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    n = 1 if shared else 2
    caches = [rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
              for _ in range(n)]
    if fmt is not None:
        dt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[fmt]
        quant = [jl._quantize_token_kv(jnp.asarray(c), dt) for c in caches]
        caches = ([np.array(x) for x, _ in quant]
                  + [np.array(s) for _, s in quant])
    for b, m in enumerate(lengths):
        for c in caches:
            if c.dtype.name == "float8_e4m3fn":
                c.view(np.uint8)[b, :, m:] = 0x7F
            elif c.dtype == np.int8:
                c[b, :, m:] = 0
            else:
                c[b, :, m:] = np.nan
    args = [q, *caches, np.asarray(lengths, np.int32)]
    return ([jnp.asarray(a) for a in args],
            [tensor_from_numpy(a, "cpu") for a in args])


def _split(targs, fmt, shared, **kw):
    """``attend_split_plain`` over the port's arguments."""
    q, *ops, lengths = targs
    if shared:
        k = v = ops[0]
        ks = vs = ops[1] if fmt else None
    else:
        k, v = ops[:2]
        ks, vs = (ops[2], ops[3]) if fmt else (None, None)
    return dec.attend_split_plain(q, k, v, lengths, k_scale=ks, v_scale=vs,
                                  **kw)


def _hold(got, want, D, with_lse, lengths):
    outs = zip(got, want) if with_lse else [(got, want)]
    for g, w in outs:
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL[D],
                                   rtol=0)
    if with_lse:
        for b, m in enumerate(lengths):
            if m == 0:  # a row of length 0: zeros and an lse of -1e30
                assert np.all(got[0][b].numpy() == 0)
                assert np.all(got[1][b].numpy() == np.float32(-1e30))


# (group, Hkv, head dim, cache, window, softcap, lse, shared): every group
# and head dim the kernel's head blocks and tiles take; windows of 32 (the
# band ends on a split edge), 21 and 40 (inside a split)
CASES = [
    (1, 2, 64, None, None, None, True, False),
    (2, 2, 256, None, 32, 50.0, False, False),
    (7, 2, 128, "int8", 21, None, True, False),
    (8, 1, 64, "fp8", None, 30.0, True, False),
    (16, 1, 128, None, 40, 2.0, True, False),
    (16, 1, 576, None, None, None, True, True),
    (16, 1, 576, "int8", 40, None, False, True),
]


@pytest.mark.parametrize("G,Hkv,D,fmt,window,softcap,with_lse,shared", CASES)
def test_split_plain_matches_pallas_decode(G, Hkv, D, fmt, window, softcap,
                                           with_lse, shared):
    """Contiguous caches: lengths 0, 1, split - 1, split, split + 1 and the
    capacity (53, no multiple of the split), NaN past them."""
    S = 3 * SPLIT + 5
    lengths = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, S]
    jargs, targs = _caches(np.random.default_rng(G + D), len(lengths),
                           G * Hkv, Hkv, S, D, lengths, fmt, shared)
    make = (make_decode_attention if fmt is None
            else make_decode_attention_quantized)
    want = make(block_k=16, window=window, softcap=softcap,
                with_lse=with_lse, shared_kv=shared)(*jargs)
    got = _split(targs, fmt, shared, window=window, softcap=softcap,
                 with_lse=with_lse, split_keys=SPLIT)
    _hold(got, want, D, with_lse, lengths)


def _pools(rng, targs, jargs, lengths, page, n_ops):
    """The first ``n_ops`` cache operands of both argument lists as
    shuffled pools of ``page`` (N, Hkv, page[, D]) behind one table. The
    port's pools keep NaN (e4m3: 0x7F) wherever no row owns a position;
    JAX's keep finite values there (its kernel weighs the tail of a last
    page by zero, and 0 * NaN is NaN)."""
    B, Hkv, S = targs[1].shape[:3]
    P = S // page
    N = B * P + 1
    table = np.zeros((B, P), np.int32)
    phys = iter(rng.permutation(np.arange(1, N)))
    for b, m in enumerate(lengths):
        for i in range(-(-m // page)):
            table[b, i] = next(phys)
    t_table = torch.from_numpy(table)
    tpools, jpools = [], []
    for t in targs[1:1 + n_ops]:
        fill = 0x7F if t.dtype == torch.float8_e4m3fn else (
            0 if t.dtype == torch.int8 else float("nan"))
        chunks = as_bytes(t).reshape(B, Hkv, P, page, *t.shape[3:])
        chunks = chunks.transpose(1, 2)
        pool = torch.full((N, Hkv, page, *t.shape[3:]), fill,
                          dtype=chunks.dtype)
        owned = t_table > 0
        pool[t_table[owned].long()] = chunks[owned]
        pool = pool.view(t.dtype)
        tpools.append(pool)
        clean = pool.float().nan_to_num().to(t.dtype) if t.dtype in (
            torch.float32,) else pool.clone()
        if t.dtype == torch.float8_e4m3fn:
            as_bytes(clean)[torch.isnan(pool.float())] = 0
        arr = clean.numpy() if t.dtype != torch.float8_e4m3fn else (
            as_bytes(clean).numpy().view(jnp.float8_e4m3fn))
        jpools.append(jnp.asarray(arr))
    return tpools, jpools, t_table, jnp.asarray(table)


@pytest.mark.parametrize("G,D,fmt,page,window,softcap,shared", [
    (2, 128, None, 8, 32, None, False),
    (8, 64, "int8", 16, None, 30.0, False),
    (16, 576, "fp8", 16, 40, None, True),
])
def test_split_plain_matches_pallas_paged(G, D, fmt, page, window, softcap,
                                          shared):
    """Paged pools (gathered through the table, as the kernel reads them)
    against JAX's paged kernel, with the lse."""
    S, Hkv = 4 * SPLIT, 1 if shared else 2
    lengths = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, S]
    jargs, targs = _caches(np.random.default_rng(D + page), len(lengths),
                           G * Hkv, Hkv, S, D, lengths, fmt, shared)
    n_ops = len(targs) - 2
    tpools, jpools, t_table, j_table = _pools(np.random.default_rng(3),
                                              targs, jargs, lengths, page,
                                              n_ops)
    want = make_paged_attention(quantized=fmt is not None, shared_kv=shared,
                                window=window, softcap=softcap,
                                with_lse=True)(
        jargs[0], *jpools, j_table, jargs[-1])
    gathered = [pg._gather(p, t_table) for p in tpools]
    got = _split([targs[0], *gathered, targs[-1]], fmt, shared,
                 window=window, softcap=softcap, with_lse=True,
                 split_keys=SPLIT)
    _hold(got, want, D, True, lengths)


def test_split_plain_default_split_matches_pallas():
    """At the kernel's own split length (SPLIT_KEYS[64]): lengths on both
    sides of its first edge and the capacity."""
    L = dec.SPLIT_KEYS[64]
    S = L + 44
    lengths = [0, 1, L - 1, L, L + 1, S]
    jargs, targs = _caches(np.random.default_rng(7), len(lengths), 8, 2, S,
                           64, lengths, None)
    want = make_decode_attention(block_k=64, with_lse=True)(*jargs)
    _hold(_split(targs, None, False, with_lse=True), want, 64, True,
          lengths)


@pytest.mark.parametrize("window", [None, 24])
def test_split_plain_batch_invariant(window):
    """A row alone gives the same bits as its row in the batch (its splits
    and merge order follow its length and window alone), and the split and
    merge agree with the unsplit ``attend_plain``."""
    lengths = [53, 0, 17, 16, 33, 1]
    S = 53
    _, targs = _caches(np.random.default_rng(11), len(lengths), 8, 2, S,
                       64, lengths, "int8")
    q, k, v, ks, vs, lens = targs
    kw = dict(k_scale=ks, v_scale=vs, window=window, softcap=5.0,
              with_lse=True, split_keys=SPLIT)
    out, lse = dec.attend_split_plain(q, k, v, lens, **kw)
    ref = dec.attend_plain(q, k, v, lens, k_scale=ks, v_scale=vs,
                           window=window, softcap=5.0, with_lse=True)
    torch.testing.assert_close(out, ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, ref[1], atol=1e-5, rtol=0)
    for b in range(len(lengths)):
        sl = slice(b, b + 1)
        o1, l1 = dec.attend_split_plain(
            q[sl], k[sl], v[sl], lens[sl],
            **{**kw, "k_scale": ks[sl], "v_scale": vs[sl]})
        assert torch.equal(o1, out[sl]) and torch.equal(l1, lse[sl])


def test_launch_sizes_the_grid_from_the_capacity(monkeypatch):
    """``launch`` binds one entry point and passes the plan: the splits from
    the capacity (S_max or P_max * page) and the window, never a length; a
    workspace only with more than one split; one zeroed counter buffer a
    stream, reused, and none made inside a graph capture."""
    import leetcuda_tpu_torch.build as build

    calls = []

    def fake_kernel(name, symbol, argtypes):
        assert (name, symbol) == ("decode_attn", "lc_decode_attn")
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
        return proto(lambda *a: calls.append(a) or 0)

    class Stream:
        cuda_stream = 4242

    capturing = [False]
    monkeypatch.setattr(build, "kernel", fake_kernel)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(dec, "_STREAM_COUNTERS", {})
    B, H, Hkv, D = 3, 16, 2, 128
    L = dec.SPLIT_KEYS[D]
    q = torch.zeros(B, H, D, dtype=torch.bfloat16)
    out = torch.empty_like(q)
    k = torch.zeros(B, Hkv, 3 * L, D, dtype=torch.bfloat16)
    for lens in ([0, 0, 0], [3 * L] * 3):  # the grid never follows them
        lengths = torch.tensor(lens, dtype=torch.int32)
        assert dec.launch(q, k, k, None, None, None, lengths, out, None,
                          scale=0.1, window=0, softcap=0.0) == 0
        *ptrs, B_, H_, Hkv_, S_, page, D_, cache, qf32, split, n, \
            scale, window, cap, stream = calls[-1]
        assert (B_, H_, Hkv_, S_, page, D_, cache, qf32, split, n) == (
            B, H, Hkv, 3 * L, 0, D, 0, 0, L, 3)
        assert ptrs[9] and ptrs[10] and stream == 4242
    counters = dec._STREAM_COUNTERS[(None, 4242)]
    assert counters.dtype == torch.int32 and not counters.any()
    # paged int8 pools, a window of one split: no workspace, no counters
    table = torch.zeros(B, 6, dtype=torch.int32)
    pool = torch.zeros(20, Hkv, L // 2, D, dtype=torch.int8)
    sc = torch.zeros(20, Hkv, L // 2)
    dec.launch(q.float(), pool, pool, sc, sc, table, lengths, out.float(),
               None, scale=0.1, window=L, softcap=50.0)
    *ptrs, B_, H_, Hkv_, S_, page, D_, cache, qf32, split, n, \
        scale, window, cap, stream = calls[-1]
    assert (S_, page, cache, qf32, n, window) == (3 * L, L // 2, 1, 1, 1, L)
    assert ptrs[9] is None and ptrs[10] is None
    # a table long enough for more splits than the merge holds: refused
    long_table = torch.zeros(B, 2 * dec.MAX_SPLITS + 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="splits"):
        dec.launch(q, pool, pool, sc, sc, long_table, lengths, out, None,
                   scale=0.1, window=0, softcap=0.0)
    # a capture on a stream without counters refuses; one with them reuses
    capturing[0] = True
    Stream.cuda_stream = 77
    with pytest.raises(RuntimeError, match="before capturing"):
        dec.launch(q, k, k, None, None, None, lengths, out, None,
                   scale=0.1, window=0, softcap=0.0)
    Stream.cuda_stream = 4242
    dec.launch(q, k, k, None, None, None, lengths, out, None, scale=0.1,
               window=0, softcap=0.0)
    assert dec._STREAM_COUNTERS[(None, 4242)] is counters


def test_decode_bench_cli_on_cpu(capsys):
    """The split-length benchmark runs end to end on the plain versions
    (a check of the CLI: its times on the host clock are no device
    measurement) and leaves SPLIT_KEYS as it found them."""
    from leetcuda_tpu_torch.bench import decode_bench

    before = dict(dec.SPLIT_KEYS)
    assert decode_bench.main(["--device", "cpu", "--cases", "modelconfig",
                              "mla_shared", "--splits", "64", "128",
                              "--rounds", "1", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "not a device measurement" in out
    assert "modelconfig (D=128" in out and "mla_shared (D=576" in out
    assert "max abs err 0" in out
    assert dec.SPLIT_KEYS == before
