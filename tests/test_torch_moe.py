"""The port's grouped matmul, MoE FFNs and MoE model against the JAX package.

Inputs come from a numpy seed; weights cross from JAX's random init through
``params_from_numpy``. The JAX side runs ``make_gmm`` as its own tests run
it on the CPU, in Pallas interpret mode; the port's wrappers run their plain
versions on CPU tensors. Tolerances: 1e-4 in f32 (JAX's own bar for the
dropless path: f32 sums in another order), the registry's 2e-2 in bf16.
Integer routing (``pad_group_sizes``, ``tile_groups_from_sizes``) is held
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.core.registry import OPS as JOPS
from leetcuda_tpu.core.testing import make_args as j_make_args
from leetcuda_tpu.gemm import grouped as jg
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu.models import moe as jm
from leetcuda_tpu_torch.core.registry import OPS, load_all
from leetcuda_tpu_torch.core.testing import make_args
from leetcuda_tpu_torch.engine import Engine, EngineConfig
from leetcuda_tpu_torch.gemm import grouped as tg
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models import moe as tm
from leetcuda_tpu_torch.models.convert import params_from_numpy

load_all()
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _pair(x, jdt=jnp.float32, tdt=torch.float32):
    """One float64 numpy array as a JAX array and a tensor, each rounded
    once to its dtype (the same values)."""
    return jnp.asarray(x, jdt), torch.from_numpy(np.asarray(x)).to(tdt)


# --- the grouped matmul ----------------------------------------------------


def _gmm_case(sizes, K, N, G, bm=128, seed=0, jdt=jnp.float32,
              tdt=torch.float32):
    rng = np.random.default_rng(seed)
    T = int(sum(sizes))
    jl_, tl_ = _pair(rng.standard_normal((T, K)), jdt, tdt)
    jr, tr = _pair(rng.standard_normal((G, K, N)), jdt, tdt)
    jsizes = jnp.asarray(sizes, jnp.int32)
    jt = jg.tile_groups_from_sizes(jsizes, bm, T // bm)
    tt = tg.tile_groups_from_sizes(torch.tensor(sizes), bm, T // bm)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt.dtype == torch.int32
    want = jg.make_gmm(block=(bm, 2048, 2048))(jl_, jr, jt)
    got = tg.make_gmm(block=(bm, 2048, 2048))(tl_, tr, tt)
    assert got.dtype == tdt and tuple(got.shape) == (T, N)
    return got, want, (tl_, tr, tt, sizes)


@pytest.mark.parametrize("sizes,K,N,G", [
    ([256, 128, 384], 256, 384, 3),      # JAX's test_gmm_matches_loop
    ([128, 256], 136, 200, 2),           # ragged N and K
    ([0, 256, 0, 128], 64, 96, 4),       # empty experts
    ([0, 0, 512, 0], 128, 130, 4),       # every row to one expert
])
def test_gmm_plain_matches_jax(sizes, K, N, G):
    got, want, (lhs, rhs, _, sizes) = _gmm_case(sizes, K, N, G)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got), _np(tg.gmm_ref(lhs, rhs, sizes)),
                               **TOL)


def test_gmm_plain_matches_jax_bf16():
    got, want, _ = _gmm_case([256, 128], 256, 384, 2, seed=1,
                             jdt=jnp.bfloat16, tdt=torch.bfloat16)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_gmm_jax_block_tiling_is_not_semantic():
    """The JAX kernel's (bn, bk) are TPU tiling: its test's block (128, 128,
    128) computes what the port computes."""
    got, _, (lhs, rhs, tt, _) = _gmm_case([256, 128, 384], 256, 384, 3)
    want = jg.make_gmm(block=(128, 128, 128))(
        jnp.asarray(lhs.numpy()), jnp.asarray(rhs.numpy()),
        jnp.asarray(tt.numpy()))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_gmm_bm_64_and_out_of_range_expert():
    """A row tile of 64 takes its own expert; an expert id outside [0, G)
    gives NaN rows (the TPU kernel would read past rhs)."""
    rng = np.random.default_rng(2)
    lhs = torch.from_numpy(rng.standard_normal((256, 32))).float()
    rhs = torch.from_numpy(rng.standard_normal((3, 32, 16))).float()
    tiles = torch.tensor([2, 0, 3, -1], dtype=torch.int32)
    out = tg.make_gmm(block=(64, 128, 128))(lhs, rhs, tiles)
    for i, g in enumerate([2, 0]):
        np.testing.assert_allclose(out[64 * i:64 * (i + 1)].numpy(),
                                   (lhs[64 * i:64 * (i + 1)] @ rhs[g]).numpy(),
                                   **TOL)
    assert torch.isnan(out[128:]).all()


def test_gmm_refuses_bad_shapes():
    gmm = tg.make_gmm(block=(128, 128, 128))
    lhs, rhs = torch.zeros(256, 8), torch.zeros(2, 8, 8)
    with pytest.raises(ValueError):
        gmm(lhs[:200], rhs, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        gmm(lhs, rhs, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        gmm(lhs, torch.zeros(2, 4, 8), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        gmm(lhs.half(), rhs, torch.zeros(2, dtype=torch.int32))


def test_pad_and_tile_groups_match_jax():
    rng = np.random.default_rng(3)
    for bm in (8, 128):
        sizes = rng.integers(0, 3 * bm, 16).astype(np.int32)
        sizes[[2, 7]] = 0
        jp = jg.pad_group_sizes(jnp.asarray(sizes), bm)
        tp = tg.pad_group_sizes(torch.from_numpy(sizes), bm)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        n_tiles = int(np.asarray(jp).sum()) // bm + 3  # tiles past the end
        jt = jg.tile_groups_from_sizes(jp, bm, n_tiles)
        tt = tg.tile_groups_from_sizes(tp, bm, n_tiles)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_registry_grouped_matches_jax():
    names = sorted(n for n, s in OPS.items() if s.family == "gemm-grouped")
    assert names == sorted(n for n, s in JOPS.items()
                           if s.family == "gemm-grouped")
    assert names == ["grouped_gemm_scalar_prefetch"]
    spec, jspec = OPS[names[0]], JOPS[names[0]]
    assert (spec.family, spec.tags, spec.atol, spec.rtol) == (
        jspec.family, jspec.tags, jspec.atol, jspec.rtol)
    args = make_args(spec, np.random.default_rng(0))
    jargs = j_make_args(jspec, np.random.default_rng(0))
    for t, j in zip(args, jargs, strict=True):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.contiguous().view(torch.uint8).numpy(),
                                      np.asarray(j).view(np.uint8))
    got = spec.fn(*args)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(jspec.fn(*jargs)),
                               atol=spec.atol, rtol=spec.rtol)
    np.testing.assert_allclose(_np(spec.ref(*args)), _np(got), atol=0, rtol=0)
    assert spec.flops(*args) == jspec.flops(*jargs)


# --- the MoE FFNs ------------------------------------------------------------


def _moe(seed=0, **kw):
    base = dict(n_experts=4, topk=2, dim=64, ffn_dim=128,
                capacity_factor=2.0)
    base.update(kw)
    jcfg = jm.MoEConfig(**base)
    tcfg = tm.MoEConfig(**base)
    jparams = jm.init_moe_params(jax.random.key(seed), jcfg)
    return jcfg, jparams, tcfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _x(shape, seed):
    return _pair(np.random.default_rng(seed).standard_normal(shape))


def test_moe_config_capacity_matches_jax():
    for cf, n, k, e in ((1.25, 100, 2, 8), (0.1, 64, 1, 2), (2.0, 3, 8, 128),
                        (4.0, 1000, 2, 4)):
        j = jm.MoEConfig(n_experts=e, topk=k, capacity_factor=cf)
        t = tm.MoEConfig(n_experts=e, topk=k, capacity_factor=cf)
        assert t.capacity(n) == j.capacity(n)
    assert [f.name for f in dataclasses.fields(tm.MoEConfig)] == [
        f.name for f in dataclasses.fields(jm.MoEConfig)]


def test_init_moe_params_shapes_and_router_f32():
    cfg = tm.MoEConfig(n_experts=4, dim=64, ffn_dim=32, dtype=torch.bfloat16)
    p = tm.init_moe_params(torch.Generator().manual_seed(0), cfg, "cpu")
    j = jm.init_moe_params(jax.random.key(0), jm.MoEConfig(
        n_experts=4, dim=64, ffn_dim=32, dtype=jnp.bfloat16))
    assert p.keys() == j.keys()
    for key in p:
        assert tuple(p[key].shape) == j[key].shape
        assert str(p[key].dtype).split(".")[-1] == str(j[key].dtype)
    assert p["router"].dtype == torch.float32


@pytest.mark.parametrize("kw", [
    {},                                        # JAX's dense-oracle case
    {"capacity_factor": 0.1, "topk": 1, "n_experts": 2},  # drops
    {"renorm_topk": True},
    {"capacity_factor": 0.5, "renorm_topk": True},  # drops and renorm
])
def test_moe_ffn_matches_jax(kw):
    jcfg, jp, tcfg, tp = _moe(**kw)
    jx, tx = _x((2, 32, 64), 1)
    got = tm.moe_ffn(tx, tp, tcfg)
    np.testing.assert_allclose(_np(got), _np(jm.moe_ffn(jx, jp, jcfg)), **TOL)
    np.testing.assert_allclose(_np(got), _np(tm.moe_ffn_ref(tx, tp, tcfg)),
                               **TOL)
    if kw.get("capacity_factor") == 0.1:  # 8 slots each -> <= 16 tokens live
        assert int((got != 0).any(dim=-1).sum()) <= 16


@pytest.mark.parametrize("kw", [{}, {"renorm_topk": True},
                                {"topk": 1, "skew": True},
                                {"topk": 3, "n_experts": 8}])
def test_moe_ffn_dropless_matches_jax_and_oracles(kw):
    skew = kw.pop("skew", False)
    jcfg, jp, tcfg, tp = _moe(seed=3, **kw)
    if skew:  # the router leans hard on expert 2: capacity would drop most
        jp = dict(jp, router=jp["router"].at[:, 2].add(100.0))
        tp = dict(tp, router=tp["router"].clone())
        tp["router"][:, 2] += 100.0
    jx, tx = _x((128, 64) if skew else (2, 32, 64), 4)
    got = tm.moe_ffn_dropless(tx, tp, tcfg)
    assert got.shape == tx.shape
    np.testing.assert_allclose(_np(got),
                               _np(jm.moe_ffn_dropless(jx, jp, jcfg)), **TOL)
    np.testing.assert_allclose(
        _np(got), _np(tm.moe_ffn_dropless_ref(tx, tp, tcfg)), **TOL)
    if skew:
        assert bool((got != 0).any(dim=-1).all())  # nobody dropped
    else:  # capacity routing that drops nothing computes the same
        roomy = dataclasses.replace(tcfg, capacity_factor=float(
            tcfg.n_experts) / tcfg.topk)
        np.testing.assert_allclose(_np(got),
                                   _np(tm.moe_ffn_ref(tx, tp, roomy)), **TOL)


def test_moe_dropless_bf16_matches_jax():
    jcfg, jp, tcfg, tp = _moe(seed=5, dtype=jnp.bfloat16, renorm_topk=True)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jx, tx = _pair(np.random.default_rng(6).standard_normal((16, 64)),
                   jnp.bfloat16, torch.bfloat16)
    got = tm.moe_ffn_dropless(tx, tp, tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got),
                               _np(jm.moe_ffn_dropless(jx, jp, jcfg)),
                               **BF16_TOL)


def test_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25] * 4])
    vals, idx = tm._top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_moe_sharding_needs_a_mesh():
    with pytest.raises(NotImplementedError):
        tm.moe_shardings()
    with pytest.raises(NotImplementedError):
        tm.shard_moe_params({}, None)


# --- the MoE model -----------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = jl.tiny_config(n_experts=4, expert_topk=2, capacity_factor=4.0)
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = tl.tiny_config(n_experts=4, expert_topk=2, capacity_factor=4.0)
    return jcfg, jparams, tcfg, tparams


def _configs(model, dropless):
    jcfg, _, tcfg, _ = model
    return (dataclasses.replace(jcfg, moe_dropless=dropless),
            dataclasses.replace(tcfg, moe_dropless=dropless))


def test_moe_model_params_layout(model):
    _, jparams, tcfg, tparams = model
    layer = tparams["layers"][0]
    assert "moe" in layer and "w_gate" not in layer
    assert layer["moe"].keys() == jparams["layers"][0]["moe"].keys()
    drawn = tl.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    for key, t in drawn["layers"][0]["moe"].items():
        assert t.shape == layer["moe"][key].shape
        assert t.dtype == layer["moe"][key].dtype


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_model_forward_ragged_decode(model, dropless):
    """forward (logits and K/V), forward_ragged and one decode step over
    caches holding a random prefix, against JAX's model."""
    _, jparams, _, tparams = model
    jcfg, tcfg = _configs(model, dropless)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    jlog, jkv = jl.forward(jparams, jnp.asarray(toks), jcfg, return_kv=True)
    tlog, tkv = tl.forward(tparams, torch.from_numpy(toks), tcfg,
                           return_kv=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv, strict=True):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)

    lens = np.array([16, 9], np.int32)
    jlog, _ = jl.forward_ragged(jparams, jnp.asarray(toks), jnp.asarray(lens),
                                jcfg)
    tlog, _ = tl.forward_ragged(tparams, torch.from_numpy(toks),
                                torch.from_numpy(lens), tcfg)
    for b, n in enumerate(lens):  # rows past a length are garbage to both
        np.testing.assert_allclose(tlog[b, :n].numpy(),
                                   np.asarray(jlog[b, :n]), **TOL)

    shape = (2, jcfg.n_kv_heads, 32, jcfg.head_dim)
    cache_np = [{"k": rng.standard_normal(shape, dtype=np.float32),
                 "v": rng.standard_normal(shape, dtype=np.float32)}
                for _ in range(jcfg.n_layers)]
    dtoks, dlens = np.array([7, 201], np.int32), np.array([5, 17], np.int32)
    jlog, _ = jl.decode_step_impl(jparams, jnp.asarray(dtoks),
                                  jax.tree.map(jnp.asarray, cache_np),
                                  jnp.asarray(dlens), jcfg)
    tlog, _ = tl.decode_step(tparams, torch.from_numpy(dtoks),
                             params_from_numpy(cache_np, "cpu"),
                             torch.from_numpy(dlens), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


def test_moe_model_loss_and_gradients(model):
    """Capacity MoE trains: loss_fn and every gradient, routers included,
    against jax.grad of JAX's."""
    _, jparams, _, _ = model
    jcfg, tcfg = _configs(model, False)
    toks = np.random.default_rng(8).integers(0, 256, (2, 32)).astype(
        np.int32)
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(jparams, jnp.asarray(toks),
                                                   jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = [p for _, p in tl.named_leaves(tparams)]
    for p in leaves:
        p.requires_grad_(True)
    loss = tl.loss_fn(tparams, torch.from_numpy(toks), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jflat = dict(tl.named_leaves(jax.tree.map(np.asarray, jgrads)))
    for name, p in tl.named_leaves(tparams):
        np.testing.assert_allclose(p.grad.numpy(), jflat[name], atol=1e-4,
                                   rtol=1e-3, err_msg=name)
    router = tparams["layers"][0]["moe"]["router"].grad
    assert float(router.abs().max()) > 0


def test_make_train_step_refuses_dropless(model):
    jcfg, tcfg = _configs(model, True)
    with pytest.raises(AssertionError):
        jl.make_train_step(jcfg)
    with pytest.raises(ValueError, match="moe_dropless"):
        tl.make_train_step(tcfg)
    tl.make_train_step(dataclasses.replace(tcfg, moe_dropless=False))


def test_moe_fuse_params_refuses_like_jax(model):
    """Neither package fuses an MoE layer (it has no w_gate / w_up), so the
    fused entry block never meets one."""
    _, jparams, _, tparams = model
    with pytest.raises(KeyError):
        jl.fuse_params(jparams)
    with pytest.raises(KeyError):
        tl.fuse_params(tparams)


def test_engine_serves_dropless_moe_like_jax_decode_step(model):
    """The port's Engine (a ragged admission of three prompts, then decode)
    serves the dropless model greedily token for token as JAX's
    decode_step does, each prompt alone, token by token."""
    _, jparams, _, tparams = model
    jcfg, tcfg = _configs(model, True)
    rng = np.random.default_rng(9)
    prompts = [list(map(int, rng.integers(0, 256, n))) for n in (5, 17, 9)]
    max_new = 4
    want = []
    for prompt in prompts:
        caches = jl.init_kv_caches(jcfg, 1, 64)
        seq = list(prompt)
        for t in range(len(prompt) + max_new - 1):
            logits, caches = jl.decode_step(
                jparams, jnp.asarray([seq[t]], jnp.int32), caches,
                jnp.asarray([t], jnp.int32), jcfg)
            if t >= len(prompt) - 1:
                seq.append(int(jnp.argmax(logits[0])))
        want.append(seq[len(prompt):])
    eng = Engine(tparams, tcfg, EngineConfig(slots=3, max_seq=64,
                                             prefill_bucket=16),
                 device="cpu")
    got = eng.run(prompts, max_new)
    assert list(got.values()) == want


# The MoE Engine's other set-ups: three prompts behind one shared 16-token
# prefix (one page of 16), 4 new tokens each.
MOE_PREFIX = list(map(int, np.random.default_rng(10).integers(0, 256, 16)))
MOE_PROMPTS = [MOE_PREFIX + list(map(int, np.random.default_rng(11 + i)
                                     .integers(0, 256, n)))
               for i, n in enumerate((2, 7, 12))]
MOE_SETUPS = {
    "paged": dict(paged=True, page_size=16),
    "prefix cache, prefill_chunk": dict(paged=True, page_size=16,
                                        prefix_cache=True, prefill_chunk=16),
    "speculative": dict(spec_k=2),
    "int8 KV": dict(kv_quant="int8"),
}


@pytest.fixture(scope="module")
def moe_reference(model):
    """Each MOE_PROMPTS prompt alone through JAX's decode_step, token by
    token, greedy, on the dropless model."""
    _, jparams, _, _ = model
    jcfg, _ = _configs(model, True)
    want = []
    for prompt in MOE_PROMPTS:
        caches = jl.init_kv_caches(jcfg, 1, 64)
        seq = list(prompt)
        for t in range(len(prompt) + 3):
            logits, caches = jl.decode_step(
                jparams, jnp.asarray([seq[t]], jnp.int32), caches,
                jnp.asarray([t], jnp.int32), jcfg)
            if t >= len(prompt) - 1:
                seq.append(int(jnp.argmax(logits[0])))
        want.append(seq[len(prompt):])
    return want


@pytest.mark.parametrize("setup", list(MOE_SETUPS))
def test_engine_setups_serve_dropless_moe_like_jax_decode_step(
        model, moe_reference, setup):
    """The dropless model through the Engine's paged, prefix-cached with
    chunked prefill (the first prompt, then the other two adopting its
    prefix page), speculative (draft: the dense tiny model of the same
    seed, which agrees on half the proposals, so the ticks accept and
    reject) and int8 KV set-ups: every token equals JAX's decode_step."""
    _, _, _, tparams = model
    _, tcfg = _configs(model, True)
    draft = None
    if setup == "speculative":
        dcfg = jl.tiny_config()
        draft = (params_from_numpy(jax.tree.map(
            np.asarray, jl.init_params(jax.random.key(0), dcfg)), "cpu"),
            tl.tiny_config())
    eng = Engine(tparams, tcfg, EngineConfig(
        slots=3, max_seq=64, prefill_bucket=16, **MOE_SETUPS[setup]),
        draft=draft, device="cpu")
    if setup.startswith("prefix"):
        got = list(eng.run(MOE_PROMPTS[:1], 4).values())
        got += list(eng.run(MOE_PROMPTS[1:], 4).values())
        assert eng.stats()["prefix_pages_hit"] == 2
    else:
        got = list(eng.run(MOE_PROMPTS, 4).values())
    assert got == moe_reference
    if setup == "speculative":
        assert 0 < eng._accepted < eng._proposed
