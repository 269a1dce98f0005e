"""The port's paged KV cache against the JAX package's.

``PageManager`` is held against the JAX ``PageManager`` call by call under
seeded random traffic. On this CPU the paged-attention wrappers run their
plain PyTorch versions (gather through the table, then the plain decode
attention; the CUDA kernel is held against these same plain versions by
``chip_smoke.py``) and the JAX kernel runs in Pallas interpret mode, as its
own tests run it. Everything is f32 and compared at atol 1e-4: the same
algorithm in the same precision, differing in summation order (the usual
difference reads 2e-7; one run in ten of the Pallas kernel in interpret
mode read 5e-5 on the same inputs; the JAX package's own paged tests hold
this kernel at 1e-3).

The port's pools hold NaN (NaN scales, and for e4m3 the NaN byte 0x7F) in
every position no row owns: page 0, unowned pages, and the tail of each last
page. The JAX kernel never fetches an unowned page but does multiply the
tail of a last page by a zero weight (0 * NaN), so its copy of the pools
keeps the finite random values there instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.attention.paged import PageManager as JPageManager
from leetcuda_tpu.attention.paged import make_paged_attention
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.attention.paged import (
    PAGED, PAGED_Q, PageManager, paged_append, paged_attention,
    paged_attention_quantized)
from leetcuda_tpu_torch.core.runtime import as_bytes
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import params_from_numpy

ATOL = 1e-4
_QDT = {"int8": (torch.int8, jnp.int8),
        "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _state(pm):
    return dict(table=pm.table.tolist(), used=pm.used, free=pm.free,
                hits=pm.hits, misses=pm.misses, refs=pm.refs,
                trie=pm.trie, reclaimable=list(pm.reclaimable))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_manager_matches_jax_under_random_traffic(seed):
    """One seeded sequence of admissions (match_prefix / adopt / ensure /
    register_prefix), growth (ensure) and releases on both allocators:
    equal return values, tables, page lists, free lists, refcounts, tries
    and hit / miss counts after every call; the pool runs dry on the way."""
    rng = np.random.default_rng(seed)
    args = dict(num_pages=10, page_size=4, max_pages_per_seq=6, n_slots=4,
                prefix_cache=True)
    pm, jpm = PageManager(**args), JPageManager(**args)
    ooms = 0
    for _ in range(300):
        slot = int(rng.integers(0, 4))
        op = rng.integers(0, 3)
        if op == 0 and not pm.used[slot]:  # admission, prompts share heads
            toks = [int(t) for t in rng.integers(0, 2, rng.integers(1, 20))]
            pages, jpages = pm.match_prefix(toks), jpm.match_prefix(toks)
            assert pages == jpages
            pm.adopt(slot, pages)
            jpm.adopt(slot, jpages)
            ok = pm.ensure(slot, len(toks) - 1)
            assert ok == jpm.ensure(slot, len(toks) - 1)
            if ok:
                pm.register_prefix(slot, toks, skip_pages=len(pages))
                jpm.register_prefix(slot, toks, skip_pages=len(pages))
            ooms += not ok
        elif op == 1:
            length = int(rng.integers(0, 24))
            ok = pm.ensure(slot, length)
            assert ok == jpm.ensure(slot, length)
            ooms += not ok
        else:
            pm.release(slot)
            jpm.release(slot)
        assert _state(pm) == _state(jpm)
    assert ooms > 0 and pm.hits > 0 and pm.misses > 0


def test_page_manager_oom_release_and_device_table():
    pm = PageManager(num_pages=4, page_size=8, max_pages_per_seq=4, n_slots=2)
    assert pm.ensure(0, 0) and pm.ensure(0, 15)   # 2 pages
    assert pm.ensure(1, 7)                         # 3rd page
    assert not pm.ensure(1, 8)                     # pool (3 usable) exhausted
    before = pm.device_table("cpu")
    assert before.dtype == torch.int32 and before.shape == (2, 4)
    pm.release(0)
    assert pm.ensure(1, 8)                         # freed pages reusable
    after = pm.device_table("cpu")                 # a fresh copy each call
    assert before[0].tolist() != [0, 0, 0, 0] and after[0].tolist() == [0] * 4
    assert pm.match_prefix([1, 2, 3]) == []        # prefix cache off


def _paged_case(rng, page, fmt):
    """Random caches scattered into shuffled physical pages. Returns the
    JAX arguments (finite pools) and the port's (pools poisoned wherever no
    row owns a position)."""
    B, H, Hkv, D, N = 3, 8, 2, 64, 40
    lengths = np.array([30, 128, 77], np.int32)
    P = -(-int(lengths.max()) // page)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    pools = [rng.standard_normal((N, Hkv, page, D), dtype=np.float32)
             for _ in range(2)]
    table = np.zeros((B, P), np.int32)
    phys = rng.permutation(np.arange(1, N))
    owned = np.zeros((N, page), bool)           # positions some row owns
    n = 0
    for b in range(B):
        for i in range(-(-int(lengths[b]) // page)):
            table[b, i] = phys[n]
            owned[phys[n], :max(0, min(page, lengths[b] - i * page))] = True
            n += 1
    if fmt is not None:
        quant = [jl._quantize_token_kv(jnp.asarray(p), _QDT[fmt][1])
                 for p in pools]
        pools = [np.asarray(quant[0][0]), np.asarray(quant[1][0]),
                 np.asarray(quant[0][1]), np.asarray(quant[1][1])]
    tpools = params_from_numpy(pools, "cpu")
    dead = torch.from_numpy(~owned)[:, None, :].expand(N, Hkv, page)
    for t in tpools:
        as_bytes(t)[dead] = (0x7F if t.dtype == torch.float8_e4m3fn else
                             0 if t.dtype == torch.int8 else float("nan"))
    jargs = (jnp.asarray(q), *(jnp.asarray(p) for p in pools),
             jnp.asarray(table), jnp.asarray(lengths))
    targs = (torch.from_numpy(q), *tpools, torch.from_numpy(table),
             torch.from_numpy(lengths))
    return jargs, targs


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_paged_attention_matches_pallas(page, fmt):
    jargs, targs = _paged_case(np.random.default_rng(page), page, fmt)
    want = np.asarray(make_paged_attention(quantized=fmt is not None)(*jargs))
    fn = paged_attention if fmt is None else paged_attention_quantized
    before = (PAGED.launches, PAGED_Q.launches)
    got = fn(*targs).numpy()
    assert (PAGED.launches, PAGED_Q.launches) == before  # plain path on CPU
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
@pytest.mark.parametrize("window,softcap", [(40, None), (48, 30.0),
                                            (None, 0.5), (100, 0.5)])
def test_paged_attention_window_softcap_matches_pallas(fmt, window, softcap):
    """Pages of 16, lengths 30 / 128 / 77: windows that start inside a page
    (40, 100) and on a page edge (48 from 128), caps that bend every score
    (0.5) or few (30); NaN wherever no row owns a position."""
    jargs, targs = _paged_case(np.random.default_rng(3), 16, fmt)
    want = np.asarray(make_paged_attention(
        quantized=fmt is not None, window=window, softcap=softcap)(*jargs))
    fn = paged_attention if fmt is None else paged_attention_quantized
    got = fn(*targs, window=window, softcap=softcap).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_cache_append_attend_paged_across_page_boundaries(quant):
    """The model's paged ``_cache_append`` + ``_cache_attend`` against
    JAX's over three steps that carry both rows across a page boundary
    (positions 14..16 and 30..32 with pages of 16): equal attention
    outputs, and pools equal after the last append."""
    rng = np.random.default_rng(5)
    jcfg, tcfg = jl.tiny_config(), tl.tiny_config()
    B, page, n_pages = 2, 16, 9
    Hkv, H, D = jcfg.n_kv_heads, jcfg.n_heads, jcfg.head_dim
    jcache = jl.init_paged_kv_caches(jcfg, n_pages, page, quant=quant)[0]
    for key in ("k_pages", "v_pages"):
        x = jnp.asarray(rng.standard_normal(jcache[key].shape,
                                            dtype=np.float32))
        if quant is None:
            jcache[key] = x
        else:
            jcache[key], jcache[key[0] + "_scales"] = jl._quantize_token_kv(
                x, jcache[key].dtype)
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    pm = PageManager(n_pages, page, 4, B)
    for t in range(3):
        pos = np.array([14 + t, 30 + t], np.int32)
        for b in range(B):
            assert pm.ensure(b, int(pos[b]))
        k, v, q = (rng.standard_normal((B, h, D), dtype=np.float32)
                   for h in (Hkv, Hkv, H))
        jcache = jl._cache_append(jcache, jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos),
                                  page_table=jnp.asarray(pm.table))
        want = jl._cache_attend(jnp.asarray(q), jcache, jnp.asarray(pos + 1),
                                page_table=jnp.asarray(pm.table))
        table = pm.device_table("cpu")
        out = tl._cache_append(tcache, torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pos),
                               page_table=table)
        assert out is tcache  # in place
        got = tl._cache_attend(torch.from_numpy(q), tcache,
                               torch.from_numpy(pos + 1), page_table=table)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    assert [len(pm.used[b]) for b in range(B)] == [2, 3]  # both crossed
    for key in tcache:
        np.testing.assert_array_equal(
            tcache[key].float().numpy(), np.asarray(jcache[key], np.float32))


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_init_paged_kv_caches_matches_jax(quant):
    jcfg, tcfg = jl.tiny_config(), tl.tiny_config()
    want = jl.init_paged_kv_caches(jcfg, 7, 16, quant=quant)
    got = tl.init_paged_kv_caches(tcfg, 7, 16, quant=quant, device="cpu")
    assert len(got) == len(want) == tcfg.n_layers
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in g:
            assert tuple(g[key].shape) == w[key].shape
            assert str(g[key].dtype).split(".")[-1] == str(w[key].dtype)
            np.testing.assert_array_equal(g[key].float().numpy(),
                                          np.asarray(w[key], np.float32))
    with pytest.raises(ValueError):
        tl.init_paged_kv_caches(tcfg, 7, 16, quant="int4", device="cpu")


def test_paged_append_writes_in_place_and_null_page_takes_dead_rows():
    """Rows whose table row is all zeros (released slots) write to page 0;
    live rows land in their own page at ``length % page``."""
    kp = torch.zeros(4, 2, 8, 16)
    vp = torch.zeros(4, 2, 8, 16)
    table = torch.tensor([[3, 1], [0, 0], [0, 0]], dtype=torch.int32)
    lengths = torch.tensor([9, 5, 5], dtype=torch.int32)
    k = torch.arange(3 * 2 * 16, dtype=torch.float32).reshape(3, 2, 16) + 1
    out = paged_append(kp, vp, k, -k, table, lengths)
    assert out[0] is kp and out[1] is vp
    assert torch.equal(kp[1, :, 1], k[0]) and torch.equal(vp[1, :, 1], -k[0])
    assert any(torch.equal(kp[0, :, 5], k[b]) for b in (1, 2))
    assert kp[2].abs().sum() == 0 and kp[3].abs().sum() == 0


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_paged_with_lse_matches_pallas(fmt):
    """with_lse (attention sinks): (out, lse (B, H)) against the Pallas
    paged kernel's, NaN wherever no row owns a position; the output is the
    one without the lse."""
    jargs, targs = _paged_case(np.random.default_rng(0), 16, fmt)
    want = make_paged_attention(quantized=fmt is not None,
                                with_lse=True)(*jargs)
    fn = paged_attention if fmt is None else paged_attention_quantized
    got = fn(*targs, with_lse=True)
    assert got[1].shape == targs[0].shape[:2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
    torch.testing.assert_close(fn(*targs), got[0], atol=0, rtol=0)


@pytest.mark.parametrize("opt", [{"shared_kv": True}])
def test_paged_unported_options_raise(opt):
    """shared_kv (MLA's paged latent cache) takes JAX's calling form, (q,
    pages, scales, page_table, lengths): the unshared operands with
    shared_kv raise, naming the form."""
    _, targs = _paged_case(np.random.default_rng(0), 16, "int8")
    with pytest.raises(TypeError, match="shared_kv"):
        paged_attention_quantized(*targs, **opt)
    _, targs = _paged_case(np.random.default_rng(0), 16, None)
    with pytest.raises(TypeError):  # TPU DMA tiling: no counterpart
        paged_attention(*targs[:5], pages_per_step=2)


def test_paged_shape_and_dtype_mismatch_raises():
    _, (q, kp, vp, table, lengths) = _paged_case(np.random.default_rng(0),
                                                 16, None)
    with pytest.raises(ValueError):  # table rows != batch
        paged_attention(q, kp, vp, table[:2], lengths)
    with pytest.raises(ValueError):  # pools of different shapes
        paged_attention(q, kp, vp[:, :1], table, lengths)
    with pytest.raises(ValueError):  # f32 pools are no quantized pools
        paged_attention_quantized(q, kp, vp, kp[..., 0], vp[..., 0], table,
                                  lengths)
    _, qargs = _paged_case(np.random.default_rng(0), 16, "int8")
    with pytest.raises(ValueError):  # scale pools of the wrong shape
        paged_attention_quantized(*qargs[:3], qargs[3][:, :, :8], *qargs[4:])
