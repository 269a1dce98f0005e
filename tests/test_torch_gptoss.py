"""GPT-OSS and GLM in the port against the JAX package: the model families
of ROADMAP items 11b2 and 11b3.

GPT-OSS. A tiny ``transformers.GptOssForCausalLM`` built locally (as
tests/test_loader.py builds one: YaRN, a window of 8 on the even layer,
attention sinks, q/k/v/o biases, 4 experts of which 2 are active) goes
through JAX's ``config_from_hf`` and ``params_from_hf_state_dict``, then
numpy, then the port (``params_from_numpy``: the f32 ``sinks`` and the nested
``moe_oss`` cross as they are). forward and 12 decode steps against JAX's at
atol/rtol 1e-4 (f32 in another order, tests/test_torch_model.py's bar) and
against transformers at JAX's own bars (tests/test_loader.py: 3e-3 forward,
6e-3 decode); every gradient, the experts' and the sinks' among them,
against ``jax.grad`` at atol 1e-4 / rtol 1e-3 (tests/test_torch_window.py's
bar); the experts alone with tied router logits, where ``_top_k`` must take
the lower index as ``jax.lax.top_k`` does. ``gpt_oss_20b_config`` against
JAX's ``config_from_hf`` on the published config.

GLM. ``apply_rope_glm`` against JAX's (f32, atol 1e-6: the same formula),
a tiny model with ``glm_rope_dim`` (forward and a decode step) against
JAX's, and ``rope_scaling`` with GLM refused as JAX refuses it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.models import llama as jl
from leetcuda_tpu.models.loader import (config_from_hf,
                                        params_from_hf_state_dict)
from leetcuda_tpu.ops import rope as jrope
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import params_from_numpy
from leetcuda_tpu_torch.ops import rope as trope

transformers = pytest.importorskip("transformers")

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def port_config(jcfg, dtype=torch.float32):
    """The port's ModelConfig with every field of JAX's ``jcfg``."""
    return tl.ModelConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jl.ModelConfig)
                             if f.name != "dtype"}, dtype=dtype)


@pytest.fixture(scope="module")
def gptoss():
    """(HF model, JAX cfg, JAX params, the port's cfg, params)."""
    hf_cfg = transformers.GptOssConfig(
        vocab_size=128, hidden_size=64, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=256, rms_norm_eps=1e-5,
        rope_theta=150000.0, tie_word_embeddings=False,
        num_local_experts=4, num_experts_per_tok=2, sliding_window=8,
        layer_types=["sliding_attention", "full_attention"],
        rope_scaling={"rope_type": "yarn", "factor": 32.0,
                      "beta_fast": 32.0, "beta_slow": 1.0, "truncate": False,
                      "original_max_position_embeddings": 64})
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(7)
    model = transformers.GptOssForCausalLM(hf_cfg).eval()
    with torch.no_grad():  # sinks and biases away from zero, so they bite
        for name, p in model.named_parameters():
            if "sinks" in name or name.endswith("bias"):
                p.normal_(0.0, 0.5)
    jcfg = config_from_hf(hf_cfg, dtype=jnp.float32)
    jparams = params_from_hf_state_dict(model.state_dict(), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return model, jcfg, jparams, port_config(jcfg), tparams


def test_params_cross_as_they_are(gptoss):
    """sinks (f32) and the nested moe_oss cross from JAX's numpy pytree with
    their keys, shapes and dtypes."""
    _, _, jparams, tcfg, tparams = gptoss
    jl0, tl0 = jparams["layers"][0], tparams["layers"][0]
    assert set(tl0) == set(jl0) and "bo" in tl0
    assert tl0["sinks"].dtype == torch.float32
    assert tl0["sinks"].shape == (tcfg.n_heads,)
    assert set(tl0["moe_oss"]) == set(jl0["moe_oss"])
    for k, v in jl0["moe_oss"].items():
        np.testing.assert_array_equal(tl0["moe_oss"][k].numpy(),
                                      np.asarray(v))
    assert tcfg.alt_window and tcfg.attn_sinks and tcfg.n_experts == 0


def test_forward_matches_jax_and_transformers(gptoss):
    """forward against JAX's (1e-4) and transformers (3e-3); without the
    sinks the logits move."""
    model, jcfg, jparams, tcfg, tparams = gptoss
    toks = np.random.default_rng(11).integers(0, 128, (2, 20))
    want = jl.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got = tl.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with torch.no_grad():
        hf = model(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(got.numpy(), hf, atol=3e-3, rtol=3e-3)
    nosink = {**tparams, "layers": [{k: v for k, v in layer.items()
                                     if k != "sinks"}
                                    for layer in tparams["layers"]]}
    alt = tl.forward(nosink, torch.from_numpy(toks), tcfg)
    assert float((alt - got).abs().max()) > 1e-3


def test_ragged_forward_matches_jax(gptoss):
    """forward_ragged: the sinks on the ragged flash forward's lse."""
    _, jcfg, jparams, tcfg, tparams = gptoss
    toks = np.random.default_rng(12).integers(0, 128, (2, 16)).astype(
        np.int32)
    lens = np.array([16, 9], np.int32)
    want, _ = jl.forward_ragged(jparams, jnp.asarray(toks), jnp.asarray(lens),
                                jcfg)
    got, _ = tl.forward_ragged(tparams, torch.from_numpy(toks),
                               torch.from_numpy(lens), tcfg)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(want)[b, :n], **TOL)


def test_decode_matches_jax_and_transformers(gptoss):
    """12 decode steps over a contiguous cache against JAX's decode_step
    (1e-4) and transformers' forward over the same tokens (6e-3)."""
    model, jcfg, jparams, tcfg, tparams = gptoss
    toks = np.random.default_rng(11).integers(0, 128, (2, 12))
    jc = jl.init_kv_caches(jcfg, 2, 32)
    tc = tl.init_kv_caches(tcfg, 2, 32, device="cpu")
    lens = np.zeros((2,), np.int32)
    got = []
    for t in range(12):
        want, jc = jl.decode_step(jparams, jnp.asarray(toks[:, t], jnp.int32),
                                  jc, jnp.asarray(lens), jcfg)
        lg, tc = tl.decode_step(tparams, torch.from_numpy(toks[:, t]), tc,
                                torch.from_numpy(lens), tcfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {t}")
        got.append(lg.numpy())
        lens = lens + 1
    with torch.no_grad():
        hf = model(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(np.stack(got, 1), hf, atol=6e-3, rtol=6e-3)


def test_gradients_match_jax(gptoss):
    """loss_fn and every gradient (moe_oss's router, experts and biases,
    the sinks, the attention biases) against jax.grad."""
    _, jcfg, jparams, tcfg, _ = gptoss
    toks = np.random.default_rng(13).integers(0, 128, (2, 16)).astype(
        np.int32)
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(jparams, jnp.asarray(toks),
                                                   jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    for _, p in tl.named_leaves(tparams):
        p.requires_grad_(True)
    loss = tl.loss_fn(tparams, torch.from_numpy(toks), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jflat = dict(tl.named_leaves(jax.tree.map(np.asarray, jgrads)))
    names = [n for n, _ in tl.named_leaves(tparams)]
    assert "layers.0.moe_oss.w_gate_up" in names and "layers.1.sinks" in names
    for name, p in tl.named_leaves(tparams):
        np.testing.assert_allclose(p.grad.numpy(), jflat[name], **GRAD_TOL,
                                   err_msg=name)


def test_decode_chunk_keeps_the_output_bias(gptoss):
    """decode_chunk (the Engine's chunked prefill, prefix admission and
    speculative verify) over a fresh cache gives the logits of JAX's
    forward on GPT-OSS, whose o_proj has a bias. JAX's own decode_chunk
    drops that bias (engine/speculative.py:253-254 add no ``bo``) and so
    differs from its forward; the port keeps it, as its decode_step and
    forward do."""
    from leetcuda_tpu.engine import speculative as jspec
    from leetcuda_tpu_torch.engine import speculative as tspec

    _, jcfg, jparams, tcfg, tparams = gptoss
    toks = np.random.default_rng(16).integers(0, 128, (2, 12)).astype(
        np.int32)
    lens = np.zeros((2,), np.int32)
    want = np.asarray(jl.forward(jparams, jnp.asarray(toks), jcfg))
    got, _ = tspec.decode_chunk(tparams, torch.from_numpy(toks),
                                tl.init_kv_caches(tcfg, 2, 32, device="cpu"),
                                torch.from_numpy(lens), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jgot, _ = jspec.decode_chunk(jparams, jnp.asarray(toks),
                                 jl.init_kv_caches(jcfg, 2, 32),
                                 jnp.asarray(lens), jcfg)
    assert float(np.abs(np.asarray(jgot) - want).max()) > 1e-2


@pytest.mark.parametrize("k", [1, 2, 4])
def test_experts_with_tied_router_logits(k):
    """_gptoss_moe against JAX's when the router's logits tie (a zero router
    matrix, biases 0.5 / 1 / 1 / 0.2 / 1 / 0.5): the top k take the lower
    indices on both sides (k = 1, 2 and 4 each cut through a tie), and the
    softmax runs over the k selected logits only."""
    rng = np.random.default_rng(14 + k)
    D, F_, E = 32, 16, 6

    def draw(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    moe = {"router_w": np.zeros((D, E), np.float32),
           "router_b": np.array([0.5, 1.0, 1.0, 0.2, 1.0, 0.5], np.float32),
           "w_gate_up": draw((E, D, 2 * F_), D ** -0.5),
           "b_gate_up": draw((E, 2 * F_), 0.1),
           "w_down": draw((E, F_, D), F_ ** -0.5), "b_down": draw((E, D), 0.1)}
    h = draw((3, 5, D), 3.0)  # large enough that the clamps at 7 bite
    jcfg = jl.tiny_config(expert_topk=k)
    want = jl._gptoss_moe(jnp.asarray(h), jax.tree.map(jnp.asarray, moe),
                          jcfg)
    got = tl._gptoss_moe(torch.from_numpy(h), params_from_numpy(moe, "cpu"),
                         tl.tiny_config(expert_topk=k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the experts in reverse order break each tie the other way: another
    # choice among the tied experts, another function
    rev = {name: moe[name][::-1].copy() for name in (
        "router_b", "w_gate_up", "b_gate_up", "w_down", "b_down")}
    rev["router_w"] = moe["router_w"][:, ::-1].copy()
    other = tl._gptoss_moe(torch.from_numpy(h), params_from_numpy(rev, "cpu"),
                           tl.tiny_config(expert_topk=k))
    assert float((other - got).abs().max()) > 1e-3


# openai/gpt-oss-20b's config.json, the fields config_from_hf reads and the
# ones around them.
GPT_OSS_20B_HF = {
    "architectures": ["GptOssForCausalLM"], "attention_bias": True,
    "head_dim": 64, "hidden_act": "silu", "hidden_size": 2880,
    "intermediate_size": 2880, "layer_types": [
        "sliding_attention" if i % 2 == 0 else "full_attention"
        for i in range(24)],
    "max_position_embeddings": 131072, "model_type": "gpt_oss",
    "num_attention_heads": 64, "num_experts_per_tok": 4,
    "num_hidden_layers": 24, "num_key_value_heads": 8,
    "num_local_experts": 32, "rms_norm_eps": 1e-5,
    "rope_scaling": {"beta_fast": 32.0, "beta_slow": 1.0, "factor": 32.0,
                     "original_max_position_embeddings": 4096,
                     "rope_type": "yarn", "truncate": False},
    "rope_theta": 150000.0, "sliding_window": 128,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "vocab_size": 201088,
}


def test_gpt_oss_20b_config_matches_jax_loader():
    """The config chip_smoke.py serves as GPT-OSS-20B is, field for field,
    what JAX's config_from_hf makes of the published config; its parameter
    count, from the shapes JAX's loader lays out, is ~20.9B."""
    want = config_from_hf(GPT_OSS_20B_HF)
    got = tl.gpt_oss_20b_config()
    for f in dataclasses.fields(jl.ModelConfig):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got.head_dim == 64 and got.n_heads // got.n_kv_heads == 8
    assert [got.layer_window(i) for i in range(4)] == [128, None, 128, None]
    D, H, Hkv, Dh, E = 2880, 64, 8, 64, 32
    attn = D * (H + 2 * Hkv) * Dh + (H + 2 * Hkv) * Dh + H * Dh * D + D + H
    experts = (D * E + E + E * D * 2 * 2880 + E * 2 * 2880 + E * 2880 * D
               + E * D)
    embed = 2 * 201088 * D
    total = 24 * (attn + experts + 2 * D) + embed + D
    assert abs(total / 1e9 - 20.9) < 0.05
    assert abs(24 * experts / 1e9 - 19.1) < 0.05
    assert abs(embed / 1e9 - 1.16) < 0.01


# --- GLM-4's partial rotary ------------------------------------------------------

@pytest.mark.parametrize("rotary_dim", [16, 32])
def test_apply_rope_glm_matches_jax(rotary_dim):
    """Interleaved pairs on the first ``rotary_dim`` of 32 lanes, the rest
    untouched, in f32 and in bf16."""
    rng = np.random.default_rng(rotary_dim)
    x = rng.standard_normal((2, 12, 3, 32), dtype=np.float32)
    pos = rng.integers(0, 4000, (2, 12)).astype(np.int32)
    want = jrope.apply_rope_glm(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                                rotary_dim)
    got = trope.apply_rope_glm(torch.from_numpy(x), torch.from_numpy(pos),
                               10000.0, rotary_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(got[..., rotary_dim:], torch.from_numpy(x)[
        ..., rotary_dim:])
    gb = trope.apply_rope_glm(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(pos), 10000.0, rotary_dim)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), np.asarray(want),
                               atol=3e-2, rtol=1e-2)


def test_glm_model_matches_jax():
    """A tiny model with glm_rope_dim 32 of 64 lanes: forward and a decode
    step over a random prefix against JAX's model."""
    jcfg = jl.tiny_config(glm_rope_dim=32)
    jparams = jl.init_params(jax.random.key(3), jcfg)
    tcfg = tl.tiny_config(glm_rope_dim=32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(15)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    want = jl.forward(jparams, jnp.asarray(toks), jcfg)
    got = tl.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    shape = (2, jcfg.n_kv_heads, 32, jcfg.head_dim)
    cache_np = [{"k": rng.standard_normal(shape, dtype=np.float32),
                 "v": rng.standard_normal(shape, dtype=np.float32)}
                for _ in range(jcfg.n_layers)]
    dtoks, dlens = np.array([7, 201], np.int32), np.array([5, 17], np.int32)
    want, _ = jl.decode_step_impl(jparams, jnp.asarray(dtoks),
                                  jax.tree.map(jnp.array, cache_np),
                                  jnp.asarray(dlens), jcfg)
    got, _ = tl.decode_step(tparams, torch.from_numpy(dtoks),
                            params_from_numpy(cache_np, "cpu"),
                            torch.from_numpy(dlens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the plain half rotation is another function
    plain = tl.forward(tparams, torch.from_numpy(toks), tl.tiny_config())
    assert float((plain - tl.forward(tparams, torch.from_numpy(toks),
                                     tcfg)).abs().max()) > 1e-3


def test_glm_with_rope_scaling_raises():
    """GLM's partial rotary with rope_scaling is refused, as in JAX."""
    kw = dict(glm_rope_dim=32, rope_scaling=("linear", 2.0))
    jcfg, tcfg = jl.tiny_config(**kw), tl.tiny_config(**kw)
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(NotImplementedError):
        jl.forward(jparams, jnp.asarray(toks), jcfg)
    with pytest.raises(NotImplementedError, match="GLM"):
        tl.forward(tparams, torch.from_numpy(toks), tcfg)
