"""MLA in the port against the JAX package: the shared-KV kernels' plain
versions and ``leetcuda_tpu_torch/models/mla.py`` (ROADMAP item 11e1).

Kernels. The shared forms of the four decode / paged wrappers (``shared_kv``:
one latent operand, and one scale, read as K and V) against JAX's Pallas
kernels in interpret mode at the registry's shape (core/testing.py: B = 2,
H = 8 over one latent head of D = 576, S = 333, lengths 100 and 333): f32,
bf16, int8 and e4m3 caches (the quantized ones with an f32 query, whose
output is f32, as models/mla.py calls them), contiguous and paged (pages of
16 on a shuffled table), with and without the lse. The port's caches hold
NaN past every length (e4m3: the NaN byte 0x7F; int8: NaN scales) and its
pools NaN wherever no row owns a position; the contiguous Pallas kernel
survives that too and gets the same caches, the paged one (which weighs the
tail of a row's last page by zero) gets finite pools (ROADMAP section 3).
Bars: f32 atol 1e-5 (one algorithm, another summation order), bf16 2e-2 and
the quantized caches 1e-5 (f32 queries and outputs over exactly decoded
values). The kernels' argument checks, which the CUDA path runs, are held
directly on CPU tensors.

Model. ``_quantize_latent`` bit for bit; ``mla_prefill`` (output and both
caches) and ``mla_decode_step`` over contiguous f32, int8 and e4m3 caches
and paged f32 and int8 pools, 4 steps, against JAX's; the MLA model (dense,
DeepSeek MoE with and without ``norm_topk_prob``, tied router scores) and
``mla_generate`` token for token; a paged model stream equal to the slot
stream. All at tiny f32 configs with inputs from numpy seeds, the JAX run
of each test shared among its assertions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.attention.decode import (make_decode_attention,
                                           make_decode_attention_quantized)
from leetcuda_tpu.attention.paged import make_paged_attention
from leetcuda_tpu.models import mla as jm
from leetcuda_tpu_torch.attention import decode as dec
from leetcuda_tpu_torch.attention import paged as pg
from leetcuda_tpu_torch.core.runtime import as_bytes, launch_counts
from leetcuda_tpu_torch.models import mla as tm
from leetcuda_tpu_torch.models.convert import (params_from_numpy,
                                               tensor_from_numpy)

B, H, S, D = 2, 8, 333, 576
LENGTHS = np.array([100, 333], np.int32)
PAGE = 16
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _shared_case(fmt, seed):
    """(JAX arguments, the port's arguments) of a contiguous shared call:
    q (B, H, D) and the latent (B, 1, S, D) (quantized: rows and scales).
    The port's latent holds NaN past every length; JAX gets the same
    values through ``jnp.array`` copies."""
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, 1, S, D), dtype=np.float32) * 0.3
    q = rng.standard_normal((B, H, D), dtype=np.float32) * 0.3
    past = np.arange(S)[None, None, :] >= LENGTHS[:, None, None]  # (B,1,S)
    if fmt in ("f32", "bf16"):
        dt = jnp.float32 if fmt == "f32" else jnp.bfloat16
        lat = np.where(past[..., None], np.nan, lat)
        jargs = [jnp.array(q, dt), jnp.array(lat, dt)]
    else:
        rows, scale = jm._quantize_latent(jnp.asarray(lat), fmt)
        rows, scale = np.array(rows), np.array(scale)
        scale[past] = np.nan
        if fmt == "fp8":
            rows.view(np.uint8)[np.broadcast_to(past[..., None],
                                                rows.shape)] = 0x7F
        jargs = [jnp.array(q), jnp.array(rows), jnp.array(scale)]
    jargs.append(jnp.array(LENGTHS))
    targs = [tensor_from_numpy(np.asarray(a), "cpu") for a in jargs]
    return jargs, targs


def _to_pages(rng, tensors, fills):
    """Scatter contiguous (B, 1, S[, D]) tensors into shuffled pages of
    PAGE: (jax pools finite, the port's pools with ``fills`` wherever no
    row owns a position, the table)."""
    P = -(-S // PAGE)
    N = B * P + 1
    table = np.zeros((B, P), np.int32)
    phys = rng.permutation(np.arange(1, N))
    owned = np.zeros((N, PAGE), bool)
    n = 0
    for b in range(B):
        for i in range(-(-int(LENGTHS[b]) // PAGE)):
            table[b, i] = phys[n]
            owned[phys[n], :max(0, min(PAGE, LENGTHS[b] - i * PAGE))] = True
            n += 1
    jpools, tpools = [], []
    for t, fill in zip(tensors, fills):
        a = np.asarray(t)
        pad = np.zeros((B, 1, P * PAGE, *a.shape[3:]), a.dtype)
        pad[:, :, :S] = a
        pool = np.zeros((N, 1, PAGE, *a.shape[3:]), a.dtype)
        for b in range(B):
            for i in range(P):
                if table[b, i]:
                    pool[table[b, i], 0] = pad[b, 0, i * PAGE:(i + 1) * PAGE]
        clean = pool.copy()
        if clean.dtype.kind == "f" or clean.dtype.name == "bfloat16":
            clean[~np.isfinite(clean.astype(np.float32))] = 0
        elif clean.dtype.name == "float8_e4m3fn":
            clean.view(np.uint8)[np.isnan(clean.astype(np.float32))] = 0
        jpools.append(jnp.array(np.where(owned[:, None, :, None] if
                                         clean.ndim == 4 else owned[:, None],
                                         clean, np.zeros((), clean.dtype))))
        tp = tensor_from_numpy(pool, "cpu")
        dead = torch.from_numpy(~owned)[:, None]
        if tp.dim() == 4:
            dead = dead[..., None].expand(tp.shape)
        as_bytes(tp)[dead] = fill
        tpools.append(tp)
    return jpools, tpools, table


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("fmt", ["f32", "bf16", "int8", "fp8"])
def test_shared_kv_matches_pallas(fmt, paged, with_lse):
    """The shared forms against JAX's ``shared_kv`` factories: (q, cache,
    lengths), (q, cache_q, scale, lengths), (q, pages, page_table,
    lengths), (q, pages, scales, page_table, lengths); NaN past every
    length on the port's side never reaches its output or lse."""
    jargs, targs = _shared_case(fmt, seed=len(fmt) + 10 * paged)
    quant = fmt in ("int8", "fp8")
    opt = dict(with_lse=with_lse) if with_lse else {}
    if paged:
        fills = {"f32": [float("nan")], "bf16": [float("nan")],
                 "int8": [0, float("nan")], "fp8": [0x7F, float("nan")]}
        jp, tp, table = _to_pages(np.random.default_rng(5), jargs[1:-1],
                                  fills[fmt])
        jargs = [jargs[0], *jp, jnp.asarray(table), jargs[-1]]
        targs = [targs[0], *tp, torch.from_numpy(table), targs[-1]]
        want = make_paged_attention(quantized=quant, shared_kv=True,
                                    **opt)(*jargs)
        fn = pg.paged_attention_quantized if quant else pg.paged_attention
        plain = (pg.paged_attention_quantized_plain if quant
                 else pg.paged_attention_plain)
    else:
        make = (make_decode_attention_quantized if quant
                else make_decode_attention)
        want = make(block_k=128, shared_kv=True, **opt)(*jargs)
        fn = (dec.decode_attention_quantized if quant
              else dec.decode_attention)
        plain = (dec.decode_attention_quantized_plain if quant
                 else dec.decode_attention_plain)
    before = launch_counts()
    got = fn(*targs, shared_kv=True, **opt)
    assert launch_counts() == before  # the plain version on the CPU
    same = plain(*targs, shared_kv=True, **opt)
    tol = BF16_TOL if fmt == "bf16" else TOL
    outs = zip(got, want, same) if with_lse else [(got, want, same)]
    for g, w, s in outs:
        assert g.dtype == targs[0].dtype or g.dtype == torch.float32
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(_np(g.float()), _np(w), **tol)
        torch.testing.assert_close(g, s, atol=0, rtol=0)


def test_shared_form_is_the_unshared_call_with_one_operand():
    """A shared call equals the unshared call given the same operand for K
    and V (and the same scale), bit for bit, for every wrapper."""
    jargs, targs = _shared_case("int8", seed=3)
    q, rows, scale, lengths = targs
    torch.testing.assert_close(
        dec.decode_attention_quantized(q, rows, scale, lengths,
                                       shared_kv=True),
        dec.decode_attention_quantized(q, rows, rows, scale, scale, lengths),
        atol=0, rtol=0)
    _, (q, lat, lengths) = _shared_case("f32", seed=4)
    torch.testing.assert_close(
        dec.decode_attention(q, lat, lengths, shared_kv=True),
        dec.decode_attention(q, lat, lat, lengths), atol=0, rtol=0)


def test_shared_counters_and_forms():
    """Each shared entry point counts on its own counter (with ``_lse``
    ones); a call with the wrong number of operands for its form raises,
    naming the form."""
    names = launch_counts()
    for base in ("decode_attention", "decode_attention_quantized",
                 "paged_attention", "paged_attention_quantized"):
        for suffix in ("_shared", "_shared_lse"):
            assert base + suffix in names
            assert dec.counter(base, True, suffix.endswith("lse")).name \
                == base + suffix
    _, (q, lat, lengths) = _shared_case("f32", seed=5)
    with pytest.raises(TypeError, match="shared_kv"):
        dec.decode_attention(q, lat, lat, lengths, shared_kv=True)
    with pytest.raises(TypeError, match="lengths"):
        dec.decode_attention(q, lat, lengths)


@pytest.mark.parametrize("case", ["head dim 96", "f16 q", "int8 q",
                                  "int64 lengths", "strided q", "576 ok",
                                  "group 7 ok", "f32 q ok"])
def test_kernel_argument_checks(case):
    """What the CUDA path checks before a launch (``_check_kernel_args``),
    held on CPU tensors: head dims 64 / 128 / 576, a bf16 or f32 q, any
    GQA group, contiguous operands, (B,) int32 lengths; anything else a
    ValueError that names it."""
    Dh, Hq, Hkv, qdt = 576, 16, 1, torch.bfloat16
    lengths = torch.tensor([3, 4], dtype=torch.int32)
    if case == "head dim 96":
        Dh = 96
    if case == "group 7 ok":
        Dh, Hq, Hkv = 128, 28, 4
    if case in ("f16 q", "int8 q", "f32 q ok"):
        qdt = {"f16 q": torch.float16, "int8 q": torch.int8,
               "f32 q ok": torch.float32}[case]
    if case == "int64 lengths":
        lengths = lengths.long()
    q = torch.zeros((2, Hq, Dh), dtype=qdt)
    if case == "strided q":
        q = torch.zeros((2, Hq, 2 * Dh), dtype=qdt)[..., ::2]
    cache = torch.zeros((2, Hkv, 8, Dh), dtype=torch.bfloat16)
    check = lambda: dec._check_kernel_args(  # noqa: E731
        q, lengths, dict(k_cache=cache, v_cache=cache))
    if case.endswith("ok"):
        check()
        return
    word = {"head dim 96": "head dim 96", "f16 q": "float16",
            "int8 q": "int8", "int64 lengths": "int32",
            "strided q": "contiguous"}[case]
    with pytest.raises(ValueError, match=word):
        check()


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantize_latent_bit_for_bit(quant):
    """``_quantize_latent`` against JAX's: the same bytes and scales."""
    lat = np.random.default_rng(6).standard_normal((3, 1, 40, 80),
                                                   dtype=np.float32)
    lat[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 floor
    rows, scale = jm._quantize_latent(jnp.asarray(lat), quant)
    trows, tscale = tm._quantize_latent(torch.from_numpy(lat), quant)
    np.testing.assert_array_equal(as_bytes(trows).numpy(),
                                  np.asarray(rows).view(np.uint8)
                                  if quant == "fp8" else np.asarray(rows))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))


# --- the MLA layer --------------------------------------------------------------

LAYER = dict(dim=64, n_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16)


def _port_cfg(jcfg, cls):
    jcls = type(jcfg)
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcls) if f.name != "dtype"},
               dtype=torch.float32)


@pytest.fixture(scope="module")
def layer():
    jcfg = jm.MLAConfig(**LAYER, dtype=jnp.float32)
    jp = jm.init_mla_params(jax.random.key(0), jcfg)
    return jcfg, jp, _port_cfg(jcfg, tm.MLAConfig), params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _cache_np(cache):
    if isinstance(cache, tuple):
        return tuple(np.asarray(c) for c in cache)
    return np.asarray(cache)


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_mla_prefill_matches_jax(layer, quant):
    """Output and latent cache (rows and scales) of the expanded prefill."""
    jcfg, jp, tcfg, tp = layer
    x = np.random.default_rng(7).normal(0, 0.5, (2, 12, 64)).astype(
        np.float32)
    y, cache = jm.mla_prefill(jp, jnp.asarray(x), jcfg, max_seq=20,
                              quant=quant)
    ty, tcache = tm.mla_prefill(tp, torch.from_numpy(x), tcfg, max_seq=20,
                                quant=quant)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    if quant is None:
        np.testing.assert_allclose(tcache.numpy(), np.asarray(cache), **TOL)
        return
    rows, scales = cache
    np.testing.assert_allclose(tcache[1].numpy(), np.asarray(scales),
                               rtol=1e-6, atol=0)
    # the codes: equal but where an f32 quotient lies within rounding of a
    # step's edge on one side, and then the neighbouring code
    got = as_bytes(tcache[0]).numpy().astype(np.int16)
    want = np.asarray(rows).view(np.uint8 if quant == "fp8"
                                 else np.int8).astype(np.int16)
    assert np.abs(got - want).max() <= 1
    assert np.mean(got != want) < 1e-3


@pytest.mark.parametrize("kind", ["f32", "int8", "fp8", "paged f32",
                                  "paged int8"])
def test_mla_decode_step_matches_jax(layer, kind):
    """Four absorbed decode steps from the same prefill over each cache,
    each step against JAX's (the port appends in place; both keep their
    own caches). Ragged lengths 9 and 12; pages of 8 on a shuffled table
    for the pools. Bars: f32 1e-5; quantized 2e-3 (a latent element whose
    f32 quotient lies within rounding of a step edge may round the other
    way on one side, moving a step's output by ~1e-4 on int8 and up to an
    e4m3 ulp's share on fp8)."""
    jcfg, jp, tcfg, tp = layer
    rng = np.random.default_rng(8)
    x = rng.normal(0, 0.5, (2, 16, 64)).astype(np.float32)
    quant = None if kind.endswith("f32") else kind.split()[-1]
    paged = kind.startswith("paged")
    _, jc = jm.mla_prefill(jp, jnp.asarray(x[:, :12]), jcfg, max_seq=24,
                           quant=quant)
    lens = np.array([9, 12], np.int32)
    table = None
    if paged:  # the prefix latents into shuffled pages of 8
        page, pmax = 8, 3
        table = rng.permutation(2 * pmax).reshape(2, pmax).astype(np.int32)
        pool = jm.init_paged_latent_cache(jcfg, 2 * pmax + 1, page,
                                          quant=quant)
        parts = pool if quant else (pool,)
        src = jc if quant else (jc,)
        out = []
        for pl_, sc in zip(parts, src):
            for b in range(2):
                for i in range(2):
                    pl_ = pl_.at[table[b, i], :, :].set(
                        sc[b, :, i * page:(i + 1) * page])
            out.append(pl_)
        jc = tuple(out) if quant else out[0]
    tc = params_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    jt = None if table is None else jnp.asarray(table)
    tt = None if table is None else torch.from_numpy(table)
    jl, tl_ = jnp.asarray(lens), torch.from_numpy(lens)
    tol = TOL if quant is None else dict(atol=2e-3, rtol=2e-3)
    for t in range(4):
        xt = x[np.arange(2), lens + t]
        y, jc = jm.mla_decode_step(jp, jnp.asarray(xt), jc, jl, jcfg,
                                   page_table=jt)
        ty, tc2 = tm.mla_decode_step(tp, torch.from_numpy(xt), tc, tl_, tcfg,
                                     page_table=tt)
        assert tc2 is tc  # appended in place
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), **tol,
                                   err_msg=f"{kind} step {t}")
        jl, tl_ = jl + 1, tl_ + 1


def test_mla_decode_step_refuses_a_mesh(layer):
    _, _, tcfg, tp = layer
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        tm.mla_decode_step(tp, torch.zeros(1, 64), torch.zeros(1, 1, 4, 40),
                           torch.zeros(1, dtype=torch.int32), tcfg,
                           mesh=object())
    for fn in (lambda: tm.mla_param_shardings(tcfg),
               lambda: tm.shard_mla_params(tp, tcfg, object())):
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            fn()


def test_kv_bytes_per_token_matches_jax():
    for kw in ({}, {"n_heads": 32}, LAYER):
        j = jm.kv_bytes_per_token(jm.MLAConfig(**kw))
        t = tm.kv_bytes_per_token(tm.MLAConfig(**kw))
        assert t == j
    assert tm.kv_bytes_per_token(tm.MLAConfig(dtype=torch.float32)) == \
        jm.kv_bytes_per_token(jm.MLAConfig(dtype=jnp.float32))


def test_init_paged_latent_cache_shapes():
    cfg = tm.MLAConfig(**LAYER, dtype=torch.float32)
    jcfg = jm.MLAConfig(**LAYER, dtype=jnp.float32)
    for quant in (None, "int8", "fp8"):
        t = tm.init_paged_latent_cache(cfg, 5, 8, quant=quant, device="cpu")
        j = jm.init_paged_latent_cache(jcfg, 5, 8, quant=quant)
        t, j = (t, j) if quant else ((t,), (j,))
        for a, b in zip(t, j):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)


# --- the MLA model --------------------------------------------------------------

MODEL = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             ffn_dim=96)
MOE = dict(n_routed_experts=4, num_experts_per_tok=2, moe_ffn_dim=48,
           n_shared_experts=1, first_k_dense=1)


def _model(kind, seed=0):
    kw = dict(MODEL)
    if kind != "dense":
        kw.update(MOE, norm_topk_prob=kind == "moe renorm",
                  routed_scaling_factor=1.0 if kind == "moe" else 2.5)
    jcfg = jm.MLAModelConfig(**kw, dtype=jnp.float32)
    jp = jm.init_mla_model(jax.random.key(seed), jcfg)
    return (jcfg, jp, _port_cfg(jcfg, tm.MLAModelConfig),
            params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


@pytest.mark.parametrize("kind", ["dense", "moe", "moe renorm"])
def test_mla_model_prefill_and_decode_match_jax(kind):
    """Logits of the prefill (1e-4) and of 4 decode steps over each side's
    own caches (1e-4) against JAX's; the MoE layers with
    ``norm_topk_prob`` off and on (with a routed_scaling_factor)."""
    jcfg, jp, tcfg, tp = _model(kind)
    toks = np.random.default_rng(9).integers(0, 128, (2, 14))
    jl, jc = jm.mla_model_prefill(jp, jnp.asarray(toks[:, :10], jnp.int32),
                                  jcfg, max_seq=16)
    tl_, tc = tm.mla_model_prefill(tp, torch.from_numpy(toks[:, :10]), tcfg,
                                   max_seq=16)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    lengths = np.full((2,), 10, np.int32)
    for t in range(4):
        jlg, jc = jm.mla_model_decode_step(
            jp, jnp.asarray(toks[:, 10 + t], jnp.int32), jc,
            jnp.asarray(lengths + t), jcfg)
        tlg, tc = tm.mla_model_decode_step(
            tp, torch.from_numpy(toks[:, 10 + t]), tc,
            torch.from_numpy(lengths + t), tcfg)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")


def test_deepseek_moe_tied_router_scores():
    """Experts whose router rows are equal score alike: top-k must take the
    lower expert id first, as ``jax.lax.top_k`` does (``_top_k``)."""
    jcfg, jp, tcfg, tp = _model("moe", seed=1)
    moe = jp["layers"][1]["moe"]
    g = np.array(moe["gate_w"])
    g[2] = g[1]
    g[3] = g[0]  # two ties, so top-2 picks by id among equals
    moe = {**moe, "gate_w": jnp.asarray(g)}
    x = np.random.default_rng(10).normal(0, 1.0, (5, 64)).astype(np.float32)
    want = jm._deepseek_moe(jnp.asarray(x), moe, jcfg)
    got = tm._deepseek_moe(torch.from_numpy(x),
                           params_from_numpy(jax.tree.map(np.asarray, moe),
                                             "cpu"), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_mla_generate_token_for_token():
    """``mla_generate`` emits JAX's scan tokens (the prefill's argmax
    first)."""
    jcfg, jp, tcfg, tp = _model("moe", seed=2)
    prompts = np.random.default_rng(11).integers(0, 128, (2, 9))
    want = jm.mla_generate(jp, jcfg, jnp.asarray(prompts, jnp.int32),
                           max_new=6)
    got = tm.mla_generate(tp, tcfg, torch.from_numpy(prompts), max_new=6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_mla_model_paged_decode_matches_slot(quant):
    """Per-layer pools behind one shuffled table give the slot caches'
    greedy stream, which is JAX's (f32; int8: the same quantized latents
    on both sides of the port)."""
    jcfg, jp, tcfg, tp = _model("dense", seed=5)
    Bq, S0, page, pmax = 2, 8, 8, 4
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 128, (Bq, S0)))
    logits, slot = tm.mla_model_prefill(tp, toks, tcfg, max_seq=32)
    if quant:
        slot = [tm._quantize_latent(c, quant) for c in slot]
    table = torch.from_numpy(np.random.default_rng(6).permutation(
        Bq * pmax).reshape(Bq, pmax).astype(np.int32) + 1)
    pools = []
    for c in slot:
        pool = tm.init_paged_latent_cache(tcfg, Bq * pmax + 1, page,
                                          quant=quant, device="cpu")
        for part, src in zip(pool if quant else (pool,),
                             c if quant else (c,)):
            for b in range(Bq):
                for i in range(pmax):
                    as_bytes(part)[table[b, i]] = as_bytes(
                        src[b, :, i * page:(i + 1) * page])
        pools.append(pool)
    cur = logits[:, -1].argmax(-1).to(torch.int32)
    cur_p = cur.clone()
    lengths = torch.full((Bq,), S0, dtype=torch.int32)
    streams = ([], [])
    for _ in range(5):
        lg_s, slot = tm.mla_model_decode_step(tp, cur, slot, lengths, tcfg)
        lg_p, pools = tm.mla_model_decode_step(tp, cur_p, pools, lengths,
                                               tcfg, page_table=table)
        cur, cur_p = (lg.argmax(-1).to(torch.int32) for lg in (lg_s, lg_p))
        streams[0].append(cur.numpy())
        streams[1].append(cur_p.numpy())
        lengths = lengths + 1
    np.testing.assert_array_equal(np.stack(streams[1]), np.stack(streams[0]))
    if quant is None:
        want = jm.mla_generate(jp, jcfg, jnp.asarray(toks.numpy(), jnp.int32),
                               max_new=6)
        np.testing.assert_array_equal(np.stack(streams[0]).T,
                                      np.asarray(want)[:, 1:])
