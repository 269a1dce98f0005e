"""The port's Llama model against the JAX model, on one set of weights.

``tiny_config()`` (f32): the JAX package's random init goes to numpy and
through ``params_from_numpy`` into the port, so both compute with identical
weights. Logits and K/V are compared at atol/rtol 1e-4, the bar
tests/test_engine.py sets for forward-vs-ragged logits (f32 math in a
different order, over two layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.models import llama as jl
from leetcuda_tpu.ops import rope as jrope
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import params_from_numpy
from leetcuda_tpu_torch.ops import rope as trope

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def both():
    jcfg = jl.tiny_config()
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tl.tiny_config(), tparams


def test_model_config_fields_match_jax():
    names = [f.name for f in dataclasses.fields(jl.ModelConfig)]
    assert [f.name for f in dataclasses.fields(tl.ModelConfig)] == names
    jd, td = jl.ModelConfig(), tl.ModelConfig()
    for n in names:
        if n != "dtype":
            assert getattr(td, n) == getattr(jd, n), n
    assert td.dtype == torch.bfloat16 and td.head_dim == jd.head_dim == 128


def test_params_from_numpy_bf16_bit_exact():
    x = jax.random.normal(jax.random.key(1), (5, 7), jnp.bfloat16)
    t = params_from_numpy({"w": [np.asarray(x)]}, "cpu")["w"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_forward_logits_and_kv(both):
    jcfg, jparams, tcfg, tparams = both
    toks = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)
    jlog, jkv = jl.forward(jparams, jnp.asarray(toks), jcfg, return_kv=True)
    tlog, tkv = tl.forward(tparams, torch.from_numpy(toks), tcfg,
                           return_kv=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_forward_ragged(both):
    jcfg, jparams, tcfg, tparams = both
    toks = np.random.default_rng(1).integers(0, 256, (3, 16)).astype(np.int32)
    lens = np.array([16, 9, 3], np.int32)
    jlog, jkv = jl.forward_ragged(jparams, jnp.asarray(toks),
                                  jnp.asarray(lens), jcfg)
    tlog, tkv = tl.forward_ragged(tparams, torch.from_numpy(toks),
                                  torch.from_numpy(lens), tcfg)
    for b, n in enumerate(lens):  # rows past a length are garbage to both
        np.testing.assert_allclose(tlog[b, :n].numpy(),
                                   np.asarray(jlog[b, :n]), **TOL)
        for (jk, jv), (tk, tv) in zip(jkv, tkv):
            np.testing.assert_allclose(tk[b, :, :n].numpy(),
                                       np.asarray(jk[b, :, :n]), **TOL)
            np.testing.assert_allclose(tv[b, :, :n].numpy(),
                                       np.asarray(jv[b, :, :n]), **TOL)


def test_decode_step(both):
    """One decode step over caches holding a random prefix: logits and the
    appended K/V match; the port appended in place."""
    jcfg, jparams, tcfg, tparams = both
    rng = np.random.default_rng(2)
    B, S = 2, 32
    shape = (B, jcfg.n_kv_heads, S, jcfg.head_dim)
    cache_np = [{"k": rng.standard_normal(shape, dtype=np.float32),
                 "v": rng.standard_normal(shape, dtype=np.float32)}
                for _ in range(jcfg.n_layers)]
    toks = np.array([7, 201], np.int32)
    lens = np.array([5, 17], np.int32)
    jlog, jcaches = jl.decode_step(
        jparams, jnp.asarray(toks), jax.tree.map(jnp.asarray, cache_np),
        jnp.asarray(lens), jcfg)
    tcaches = params_from_numpy(cache_np, "cpu")
    tlog, out_caches = tl.decode_step(tparams, torch.from_numpy(toks),
                                      tcaches, torch.from_numpy(lens), tcfg)
    assert out_caches is tcaches
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for jc, tc in zip(jcaches, tcaches):
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)


def test_decode_step_fused_params_same_function(both):
    _, _, tcfg, tparams = both
    toks = torch.tensor([3, 9])
    lens = torch.tensor([0, 0], dtype=torch.int32)
    a, _ = tl.decode_step(tparams, toks, tl.init_kv_caches(tcfg, 2, 16,
                                                           device="cpu"),
                          lens, tcfg)
    b, _ = tl.decode_step(tl.fuse_params(tparams), toks,
                          tl.init_kv_caches(tcfg, 2, 16, device="cpu"),
                          lens, tcfg)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scaling", [
    ("llama3", 8.0, 1.0, 4.0, 32),
    ("yarn", 4.0, 32.0, 1.0, 64, True, None),
    ("linear", 2.0),
])
def test_rope_scaled(scaling):
    jcfg = jl.tiny_config(rope_scaling=scaling)
    tcfg = tl.tiny_config(rope_scaling=scaling)
    np.testing.assert_allclose(tcfg.rope_inv_freq().numpy(),
                               np.asarray(jcfg.rope_inv_freq()),
                               rtol=1e-6, atol=0)
    assert tcfg.rope_mscale() == jcfg.rope_mscale()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 4, 64), dtype=np.float32)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    want = jrope.apply_rope_half(jnp.asarray(x), jnp.asarray(pos),
                                 jcfg.rope_theta,
                                 inv_freq=jcfg.rope_inv_freq(),
                                 mscale=jcfg.rope_mscale())
    got = trope.apply_rope_half(torch.from_numpy(x), torch.from_numpy(pos),
                                tcfg.rope_theta,
                                inv_freq=tcfg.rope_inv_freq(),
                                mscale=tcfg.rope_mscale())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_llama3_scaled_model(both):
    """RoPE with llama3 scaling inside the model (the JAX Llama-3.1 path)."""
    _, jparams, _, tparams = both
    scaling = ("llama3", 8.0, 1.0, 4.0, 8)
    jcfg = jl.tiny_config(rope_scaling=scaling)
    tcfg = tl.tiny_config(rope_scaling=scaling)
    toks = np.random.default_rng(4).integers(0, 256, (1, 32)).astype(np.int32)
    want = jl.forward(jparams, jnp.asarray(toks), jcfg)
    got = tl.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("switch", [
    {"sliding_window": 64}, {"attn_softcap": 50.0}, {"attn_sinks": True},
    {"n_experts": 4}, {"glm_rope_dim": 32}, {"alt_window": True}])
def test_unported_switches_raise(both, switch):
    _, _, _, tparams = both
    cfg = tl.tiny_config(**switch)
    with pytest.raises(NotImplementedError):
        tl.forward(tparams, torch.zeros((1, 8), dtype=torch.int32), cfg)


def test_quantized_packs_raise():
    with pytest.raises(NotImplementedError):
        tl.linear(torch.zeros(2, 4), {"q": torch.zeros(4, 4),
                                      "s": torch.ones(4)})
    with pytest.raises(NotImplementedError):
        tl.init_kv_caches(tl.tiny_config(), 1, 16, quant="int8", device="cpu")
