"""The port's Llama model against the JAX model, on one set of weights.

``tiny_config()`` (f32): the JAX package's random init goes to numpy and
through ``params_from_numpy`` into the port, so both compute with identical
weights. Logits and K/V are compared at atol/rtol 1e-4, the bar
tests/test_engine.py sets for forward-vs-ragged logits (f32 math in a
different order, over two layers).

Quantized weights are JAX's packs (``quantize_params``) converted bit for
bit. JAX's int8 ``linear`` always takes bf16 dots, which round f32
activations to bf16, while its e4m3 and int4 packs take f32 dots on rows
<= 256; on the bf16 activations the port serves with, both are one
function. In f32 the quantized tests pin JAX's int8 ``linear`` to the f32-dot
variant of the same kernel (``make_matmul_w8a16(compute_dtype=f32)``), so
that all three formats are held at 1e-4. They call JAX eagerly, so no jit
cache keeps the pinned variant.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.gemm.quant import make_matmul_w8a16
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


def test_gptoss_expert_layer_matches_jax(both):
    """A GPT-OSS expert layer ("moe_oss", HF's layout: a biased router,
    interleaved gate / up projections with biases) in place of layer 0's
    MLP: forward and loss_fn against JAX's model on the same weights."""
    jcfg, jparams, tcfg, _ = both
    rng = np.random.default_rng(12)
    D, F_, E = jcfg.dim, 64, 4

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    moe = {"router_w": draw((D, E), D ** -0.5), "router_b": draw((E,), 0.1),
           "w_gate_up": draw((E, D, 2 * F_), D ** -0.5),
           "b_gate_up": draw((E, 2 * F_), 0.1),
           "w_down": draw((E, F_, D), F_ ** -0.5), "b_down": draw((E, D), 0.1)}
    wnp = jax.tree.map(np.asarray, jparams)
    layer0 = {k: v for k, v in wnp["layers"][0].items()
              if k not in ("w_gate", "w_up", "w_down")}
    wnp["layers"] = [dict(layer0, moe_oss=moe)] + wnp["layers"][1:]
    jp, tp = jax.tree.map(jnp.asarray, wnp), params_from_numpy(wnp, "cpu")
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    want = jl.forward(jp, jnp.asarray(toks), jcfg)
    got = tl.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        float(tl.loss_fn(tp, torch.from_numpy(toks), tcfg)),
        float(jl.loss_fn(jp, jnp.asarray(toks), jcfg)), rtol=1e-5)


# The switches the port takes, each held against JAX's model (ROADMAP items
# 11a, 11b1, 11b2 and 11b3): (ModelConfig fields, extra parameters). Every norm weight is
# drawn away from one so that a norm applied in the wrong place shows. The
# windows (8) are below the test's 16 tokens and its decode length 17, and
# the attention cap (1.0) bends the tiny model's scores, so both bite.
FAMILY_SWITCHES = {
    "qk_norm": ({"qk_norm": True}, ()),
    "sandwich_norms": ({"sandwich_norms": True}, ()),
    "final_softcap": ({"final_softcap": 2.0}, ()),
    "embed_scale": ({"embed_scale": True}, ()),
    "query_scale": ({"query_scale": 0.05}, ()),
    "rms_offset": ({"rms_offset": True}, ()),
    "gelu_tanh": ({"hidden_act": "gelu_tanh"}, ()),
    "nope_interval": ({"nope_interval": 2}, ()),
    "head_dim_override": ({"head_dim_override": 32}, ()),
    "biases": ({}, ("bq", "bk", "bv", "bo")),
    "untied_lm_head": ({}, ("lm_head",)),
    "sliding_window": ({"sliding_window": 8}, ()),
    "alt_window": ({"sliding_window": 8, "alt_window": True}, ()),
    "attn_softcap": ({"attn_softcap": 1.0}, ()),
    "gemma2": ({"sliding_window": 8, "alt_window": True, "attn_softcap": 1.0,
                "final_softcap": 2.0, "query_scale": 0.1, "rms_offset": True,
                "embed_scale": True, "sandwich_norms": True,
                "hidden_act": "gelu_tanh"}, ()),
    # items 11b2 and 11b3: attention sinks (JAX's init draws them) and GLM's
    # partial rotary on the first 32 of 64 lanes
    "attn_sinks": ({"attn_sinks": True}, ()),
    "glm_rope_dim": ({"glm_rope_dim": 32}, ()),
}


def _switched(name, norm_base=None):
    """JAX's tiny config with one family switch, its random weights as
    numpy (norms drawn about ``norm_base``, by default the identity scale,
    extra parameters added), and the port's config."""
    kw, extra = FAMILY_SWITCHES[name]
    jcfg = jl.tiny_config(**kw)
    wnp = jax.tree.map(np.asarray, jl.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(10)

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    H, Hkv, Dh, D = (jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim, jcfg.dim)
    if norm_base is None:
        norm_base = 0.0 if jcfg.rms_offset else 1.0
    for layer in wnp["layers"]:
        for key in [k for k in layer if k.endswith("norm")]:
            layer[key] = norm_base + draw(layer[key].shape, 0.2)
        for key, n in (("bq", H * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh),
                       ("bo", D)):
            if key in extra:
                layer[key] = draw((n,), 0.1)
    wnp["norm"] = norm_base + draw((D,), 0.2)
    if "lm_head" in extra:
        wnp["lm_head"] = draw((jcfg.vocab_size, D), D ** -0.5)
    return jcfg, wnp, tl.tiny_config(**kw)


@pytest.mark.parametrize("name", sorted(FAMILY_SWITCHES))
def test_family_switch_matches_jax(name):
    """forward, one decode step over a random prefix, and loss_fn with
    one family switch on, against JAX's model on the same weights."""
    _hold_against_jax(*_switched(name))


def test_gemma2_norms_at_one_match_jax():
    """Gemma 2's switches with the (1 + w) norms' w drawn about 1, as
    ``init_params`` draws them (every normalised vector doubled, the scores
    4x as wide), against JAX's model: chip_smoke.py path (o) serves
    Gemma-2-27B at w = 0 and holds w = 1 only at a cut depth."""
    _hold_against_jax(*_switched("gemma2", norm_base=1.0))


def _hold_against_jax(jcfg, wnp, tcfg):
    jparams = jax.tree.map(jnp.asarray, wnp)
    tparams = params_from_numpy(wnp, "cpu")
    rng = np.random.default_rng(11)
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
                                  jax.tree.map(jnp.asarray, cache_np),
                                  jnp.asarray(dlens), jcfg)
    got, _ = tl.decode_step(tparams, torch.from_numpy(dtoks),
                            params_from_numpy(cache_np, "cpu"),
                            torch.from_numpy(dlens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    want = jl.loss_fn(jparams, jnp.asarray(toks), jcfg)
    got = tl.loss_fn(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# Qwen/Qwen3-30B-A3B's config.json, the fields config_from_hf reads and the
# ones around them.
QWEN3_30B_A3B_HF = {
    "architectures": ["Qwen3MoeForCausalLM"], "attention_bias": False,
    "decoder_sparse_step": 1, "head_dim": 128, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 6144,
    "max_position_embeddings": 40960, "max_window_layers": 48,
    "mlp_only_layers": [], "model_type": "qwen3_moe",
    "moe_intermediate_size": 768, "norm_topk_prob": True,
    "num_attention_heads": 32, "num_experts": 128, "num_experts_per_tok": 8,
    "num_hidden_layers": 48, "num_key_value_heads": 4, "rms_norm_eps": 1e-6,
    "rope_scaling": None, "rope_theta": 1000000.0, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_sliding_window": False, "vocab_size": 151936,
}


def test_qwen3_30b_a3b_config_matches_jax_loader():
    """The config chip_smoke.py serves as Qwen3-30B-A3B is, field for
    field, what JAX's config_from_hf makes of the published config."""
    from leetcuda_tpu.models.loader import config_from_hf

    want = config_from_hf(QWEN3_30B_A3B_HF)
    got = tl.qwen3_30b_a3b_config()
    for f in dataclasses.fields(jl.ModelConfig):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert (got.moe_dropless and got.qk_norm and got.moe_renorm
            and got.head_dim == 128 and got.moe.ffn_dim == 768)


# google/gemma-2-27b's config.json, the fields config_from_hf reads and the
# ones around them.
GEMMA2_27B_HF = {
    "architectures": ["Gemma2ForCausalLM"], "attention_bias": False,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "head_dim": 128, "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "hidden_size": 4608,
    "intermediate_size": 36864, "max_position_embeddings": 8192,
    "model_type": "gemma2", "num_attention_heads": 32,
    "num_hidden_layers": 46, "num_key_value_heads": 16,
    "query_pre_attn_scalar": 144, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "sliding_window": 4096, "vocab_size": 256000,
}


def test_gemma2_27b_config_matches_jax_loader():
    """The config chip_smoke.py serves as Gemma-2-27B is, field for field,
    what JAX's config_from_hf makes of the published config: head dim 128
    (not 4608 / 32), a window of 4096 on the even layers, both caps."""
    from leetcuda_tpu.models.loader import config_from_hf

    want = config_from_hf(GEMMA2_27B_HF)
    got = tl.gemma2_27b_config()
    for f in dataclasses.fields(jl.ModelConfig):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got.head_dim == 128 and got.dim // got.n_heads == 144
    assert [got.layer_window(i) for i in range(4)] == [
        want.layer_window(i) for i in range(4)] == [4096, None, 4096, None]
    assert got.layer_window(None) == 4096


def test_quantized_packs_raise():
    """Packs the port does not serve raise: LoRA packs (over a quantized
    base too), unknown weight or KV quantization formats, weight bytes of
    another type."""
    base = {"q": torch.zeros(4, 4, dtype=torch.int8), "s": torch.ones(4)}
    with pytest.raises(NotImplementedError):
        tl.linear(torch.zeros(2, 4), {"w": base, "A": torch.zeros(4, 2),
                                      "B": torch.zeros(2, 4), "scale": 1.0})
    with pytest.raises(ValueError):
        tl.linear(torch.zeros(2, 4), {"q": torch.zeros(4, 4),
                                      "s": torch.ones(4)})
    with pytest.raises(ValueError):
        tl.quantize_params({"layers": []}, "int2")
    with pytest.raises(ValueError):
        tl.init_kv_caches(tl.tiny_config(), 1, 16, quant="int4", device="cpu")


def _pin_jax_int8_to_f32_dots(monkeypatch):
    monkeypatch.setattr(jl, "_w8a16",
                        make_matmul_w8a16(compute_dtype=jnp.float32))


def _quantized(jparams, fmt, fuse):
    jq = jl.quantize_params(jl.fuse_params(jparams) if fuse else jparams, fmt)
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


def _raw(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.mark.parametrize("fmt,fuse", [("int8", True), ("fp8", True),
                                      ("int4", False), ("int4", True)])
def test_quantize_params_packs_equal_jax(both, fmt, fuse):
    """The port's quantize_params(fuse_params(p)) gives JAX's packs byte for
    byte; the embedding and norms stay as they were."""
    _, jparams, _, tparams = both
    _, want = _quantized(jparams, fmt, fuse)
    got = tl.quantize_params(tl.fuse_params(tparams) if fuse else tparams,
                             fmt)
    assert got["embed"] is tparams["embed"]
    for gl, wl in zip(got["layers"], want["layers"]):
        assert gl.keys() == wl.keys()
        for key in gl:
            g, w = gl[key], wl[key]
            if key.startswith("w"):
                assert g.keys() == w.keys() == ({"q4", "s4"} if fmt == "int4"
                                                else {"q", "s"})
                for part in g:
                    assert torch.equal(_raw(g[part]), _raw(w[part])), key
            else:
                assert torch.equal(g, w)


@pytest.mark.parametrize("fmt,fuse", [("int8", True), ("fp8", True),
                                      ("fp8", False), ("int4", False)])
def test_forward_quantized(both, monkeypatch, fmt, fuse):
    jcfg, jparams, tcfg, _ = both
    _pin_jax_int8_to_f32_dots(monkeypatch)
    jq, tq = _quantized(jparams, fmt, fuse)
    toks = np.random.default_rng(5).integers(0, 256, (2, 16)).astype(np.int32)
    jlog, jkv = jl.forward(jq, jnp.asarray(toks), jcfg, return_kv=True)
    tlog, tkv = tl.forward(tq, torch.from_numpy(toks), tcfg, return_kv=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("fmt,kv", [("int8", "int8"), ("fp8", "fp8"),
                                    ("int4", "int8"), ("fp8", None)])
def test_decode_step_quantized(both, monkeypatch, fmt, kv):
    """One decode step with quantized weights over a (quantized) cache that
    holds a JAX-quantized random prefix: logits, the appended values and
    their scales match JAX's; the port appended in place."""
    jcfg, jparams, tcfg, _ = both
    _pin_jax_int8_to_f32_dots(monkeypatch)
    jq, tq = _quantized(jparams, fmt, fuse=True)
    rng = np.random.default_rng(6)
    B, S = 2, 32
    jcaches = jl.init_kv_caches(jcfg, B, S, quant=kv)
    for c in jcaches:
        for key in ("k", "v"):
            x = jnp.asarray(rng.standard_normal(c[key].shape,
                                                dtype=np.float32))
            if kv is None:
                c[key] = x
            else:
                c[key], c[key + "_scale"] = jl._quantize_token_kv(
                    x, c[key].dtype)
    tcaches = params_from_numpy(jax.tree.map(np.asarray, jcaches), "cpu")
    toks = np.array([7, 201], np.int32)
    lens = np.array([5, 17], np.int32)
    jlog, jout = jl.decode_step_impl(jq, jnp.asarray(toks), jcaches,
                                     jnp.asarray(lens), jcfg)
    tlog, tout = tl.decode_step(tq, torch.from_numpy(toks), tcaches,
                                torch.from_numpy(lens), tcfg)
    assert tout is tcaches
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for jc, tc in zip(jout, tcaches):
        assert jc.keys() == tc.keys()
        for key in tc:
            np.testing.assert_allclose(tc[key].float().numpy(),
                                       np.asarray(jc[key], np.float32), **TOL)


@pytest.mark.parametrize("qdt,jdt", [(torch.int8, jnp.int8),
                                     (torch.float8_e4m3fn,
                                      jnp.float8_e4m3fn)])
def test_quantize_token_kv_byte_equal(qdt, jdt):
    x = np.random.default_rng(7).standard_normal((3, 2, 5, 64),
                                                 dtype=np.float32) * 3
    jxq, js = jl._quantize_token_kv(jnp.asarray(x), jdt)
    txq, ts = tl._quantize_token_kv(torch.from_numpy(x), qdt)
    assert txq.dtype == qdt and ts.shape == (3, 2, 5)
    np.testing.assert_array_equal(_raw(txq).numpy().view(np.uint8),
                                  np.asarray(jxq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_init_kv_caches_quantized(quant):
    jcfg, tcfg = jl.tiny_config(), tl.tiny_config()
    want = jl.init_kv_caches(jcfg, 3, 48, quant=quant)
    got = tl.init_kv_caches(tcfg, 3, 48, quant=quant, device="cpu")
    assert len(got) == len(want) == tcfg.n_layers
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            assert tuple(g[key].shape) == w[key].shape
            assert str(g[key].dtype).split(".")[-1] == str(w[key].dtype)
            np.testing.assert_array_equal(g[key].float().numpy(),
                                          np.asarray(w[key], np.float32))
