"""The DeepSeek-V2 loader of the port (``models/mla.py``) against the JAX
package's and against ``transformers``.

Tiny ``DeepseekV2ForCausalLM`` models built locally (``q_lora_rank=None``;
dense layers only, and a dense layer 0 before a MoE layer with greedy top-2
of 4 routed experts and 2 shared ones), as tests/test_mla.py builds them: the
port's ``load_deepseek_v2`` gives the parameters JAX's loader gives (bit for
bit, f32), its prefill logits match JAX's (1e-4) and transformers' (JAX's
own bar there, 2e-3), and its absorbed decode continues the stream
transformers computed (3e-3, JAX's bar). ``config_from_hf_deepseek`` refuses
what JAX's refuses, each alone: the q-LoRA path, any rope_scaling, attention
biases and a non-greedy top-k. ``deepseek_v2_lite_config`` is JAX's
``config_from_hf_deepseek`` of the published config (rope_scaling dropped),
in bf16.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.models import mla as jm
from leetcuda_tpu_torch.models import mla as tm

transformers = pytest.importorskip("transformers")
from transformers.models.deepseek_v2 import (  # noqa: E402
    DeepseekV2Config, DeepseekV2ForCausalLM)

TINY = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, vocab_size=96,
            q_lora_rank=None, kv_lora_rank=64, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32, attention_bias=False,
            rope_scaling=None, use_cache=False)
MOE = dict(n_routed_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=64, n_shared_experts=2,
           first_k_dense_replace=1, moe_layer_freq=1, topk_method="greedy",
           norm_topk_prob=False, routed_scaling_factor=1.0)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _hf(kind, seed):
    kw = dict(TINY)
    kw.update(MOE if kind == "moe" else dict(first_k_dense_replace=2))
    torch.manual_seed(seed)
    return DeepseekV2ForCausalLM(DeepseekV2Config(**kw)).eval()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_load_deepseek_v2_matches_jax_and_transformers(kind):
    """The loaded parameters equal JAX's; prefill logits against JAX's and
    transformers'; three absorbed decode steps continue transformers'
    stream."""
    hf = _hf(kind, seed=0 if kind == "dense" else 1)
    if kind == "moe":
        assert any("mlp.experts.0" in k for k in hf.state_dict())
    jp, jcfg = jm.load_deepseek_v2(hf)
    tp, tcfg = tm.load_deepseek_v2(hf, device="cpu")
    jl, tl_ = dict(_leaves(jp)), dict(_leaves(tp))
    assert set(jl) == set(tl_)
    for k, v in jl.items():
        np.testing.assert_array_equal(tl_[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert tcfg.is_moe_layer(1) == (kind == "moe") and not tcfg.is_moe_layer(0)
    assert {f.name: getattr(tcfg, f.name)
            for f in dataclasses.fields(tcfg) if f.name != "dtype"} == {
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    assert tcfg.dtype == torch.float32

    Bq, S, T = 2, 10, 3
    toks = np.random.default_rng(8).integers(0, 96, (Bq, S + T))
    with torch.no_grad():
        want = hf(torch.tensor(toks)).logits.float().numpy()
    jlog, _ = jm.mla_model_prefill(jp, jnp.asarray(toks, jnp.int32), jcfg)
    got, _ = tm.mla_model_prefill(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)

    _, caches = tm.mla_model_prefill(tp, torch.from_numpy(toks[:, :S]), tcfg,
                                     max_seq=S + T)
    lengths = torch.full((Bq,), S, dtype=torch.int32)
    for t in range(T):
        lg, caches = tm.mla_model_decode_step(
            tp, torch.from_numpy(toks[:, S + t]), caches, lengths, tcfg)
        np.testing.assert_allclose(lg.numpy(), want[:, S + t], atol=3e-3,
                                   rtol=3e-3, err_msg=f"t={t}")
        lengths = lengths + 1


def test_untied_head_is_loaded():
    """An untied head becomes ``lm_head``, the transformers weight as it
    is."""
    hf = _hf("dense", seed=2)
    assert not hf.config.tie_word_embeddings
    tp, _ = tm.load_deepseek_v2(hf, device="cpu")
    assert "lm_head" in tp
    np.testing.assert_array_equal(
        tp["lm_head"].numpy(), hf.lm_head.weight.detach().float().numpy())


@pytest.mark.parametrize("refusal", [
    dict(q_lora_rank=32),
    dict(rope_scaling={"type": "yarn", "factor": 40.0,
                       "original_max_position_embeddings": 4096,
                       "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                       "mscale_all_dim": 0.707}),
    dict(attention_bias=True),
    dict(topk_method="group_limited_greedy", n_group=2, topk_group=1),
], ids=["q_lora_rank", "rope_scaling", "attention_bias", "topk_method"])
def test_config_refusals_match_jax(refusal):
    """Each convention the JAX package does not reproduce is refused, on
    its own, by both packages (JAX asserts; the port raises ValueError)."""
    kw = {**TINY, **MOE, **refusal}
    hf_cfg = DeepseekV2Config(**kw)
    for k, v in refusal.items():  # the config keeps what it was given
        if k != "rope_scaling":
            assert getattr(hf_cfg, k) == v
    assert getattr(hf_cfg, "rope_scaling", None) is not None \
        or "rope_scaling" not in refusal
    with pytest.raises(AssertionError):
        jm.config_from_hf_deepseek(hf_cfg)
    with pytest.raises(ValueError, match="config_from_hf_deepseek"):
        tm.config_from_hf_deepseek(hf_cfg)
    # without the refusal both map it
    ok = DeepseekV2Config(**{**TINY, **MOE})
    jc, tc = jm.config_from_hf_deepseek(ok), tm.config_from_hf_deepseek(ok)
    assert tc.n_routed_experts == jc.n_routed_experts == 4


def test_deepseek_v2_lite_config_matches_jax():
    """deepseek-ai/DeepSeek-V2-Lite's published config.json, built locally
    with rope_scaling None (the one reduction: JAX refuses YaRN), through
    JAX's ``config_from_hf_deepseek``: every field equals the port's
    ``deepseek_v2_lite_config`` but the dtype, which the port serves in
    bf16."""
    hf_cfg = DeepseekV2Config(
        vocab_size=102400, hidden_size=2048, intermediate_size=10944,
        moe_intermediate_size=1408, num_hidden_layers=27,
        num_attention_heads=16, num_key_value_heads=16, n_shared_experts=2,
        n_routed_experts=64, routed_scaling_factor=1.0, kv_lora_rank=512,
        q_lora_rank=None, qk_rope_head_dim=64, v_head_dim=128,
        qk_nope_head_dim=128, topk_method="greedy", n_group=1, topk_group=1,
        num_experts_per_tok=6, moe_layer_freq=1, first_k_dense_replace=1,
        norm_topk_prob=False, max_position_embeddings=163840,
        rms_norm_eps=1e-6, rope_theta=10000, rope_scaling=None,
        attention_bias=False, tie_word_embeddings=False)
    want = jm.config_from_hf_deepseek(hf_cfg)
    got = tm.deepseek_v2_lite_config()
    assert got.dtype == torch.bfloat16
    assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got)
            if f.name != "dtype"} == {
        f.name: getattr(want, f.name) for f in dataclasses.fields(want)
        if f.name != "dtype"}
    assert (got.latent_dim, got.qk_head_dim) == (576, 192)
    assert [got.is_moe_layer(i) for i in range(3)] == [False, True, True]


def test_deepseek_v2_lite_parameter_count():
    """The parameter count the config implies, from the shapes
    ``init_mla_model`` draws (an untied head): about 15.7B, 14.85B of them
    in the routed and shared experts."""
    cfg = tm.deepseek_v2_lite_config()
    D, H, E = cfg.dim, cfg.n_heads, cfg.n_routed_experts
    attn = (D * H * cfg.qk_head_dim + D * cfg.latent_dim
            + 2 * H * cfg.kv_lora_rank * cfg.qk_nope_head_dim
            + H * cfg.v_head_dim * D + cfg.kv_lora_rank)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    experts = n_moe * (3 * E * D * cfg.moe_ffn_dim
                       + 3 * D * cfg.moe_ffn_dim * cfg.n_shared_experts)
    total = (cfg.n_layers * (attn + 2 * D) + n_moe * E * D + experts
             + 3 * D * cfg.ffn_dim * (cfg.n_layers - n_moe)
             + 2 * cfg.vocab_size * D + D)
    assert abs(experts / 1e9 - 14.85) < 0.01
    assert abs(total / 1e9 - 15.71) < 0.01
    # the shapes init_mla_model draws, at a cut depth
    small = dataclasses.replace(cfg, n_layers=2, vocab_size=8, dim=64,
                                moe_ffn_dim=16, ffn_dim=32)
    p = tm.init_mla_model(torch.Generator().manual_seed(0), small,
                          device="cpu", untied_head=True)
    assert tuple(p["layers"][1]["moe"]["w_gate"].shape) == (64, 64, 16)
    assert tuple(p["layers"][1]["moe"]["shared"]["w_down"].shape) == (32, 64)
    assert tuple(p["layers"][0]["attn"]["w_uk"].shape) == (16, 512, 128)
    assert tuple(p["lm_head"].shape) == (8, 64)
    assert all(t.dtype == torch.bfloat16 for _, t in _leaves(p))
