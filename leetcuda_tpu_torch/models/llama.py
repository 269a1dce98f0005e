"""Llama-style transformer in PyTorch: the port's serving and training model.

Counterpart of ``leetcuda_tpu/models/llama.py`` for dense and weight-only
quantized (int8, e4m3, int4) weights and a contiguous or paged KV cache,
plain or quantized (int8, e4m3). Parameters are a plain dict with the JAX pytree's keys
(HF Llama naming): {"embed", "norm", ["lm_head"], "layers": [{"attn_norm",
"wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down", ...}]}.

Attention runs on the hand-written kernels (attention/flash.py,
attention/decode.py, attention/paged.py), and so do the quantized
projections (gemm/quant.py) and, at decode, the entry block of a layer with
a dense fused ``wqkv`` (gemm/fused_decode.py: norm, QKV projection and RoPE
in one kernel); other
dense projections are ``torch.matmul``, norms, RoPE, the
embedding gather and the MLP activation are plain PyTorch, as the JAX model
left them to XLA. Rounding order follows the JAX model: ``_rms_norm``
normalises in f32, casts, then multiplies by the weight; the MLP activation
runs in f32; logits are the activation-dtype product cast to f32.

A layer with ``n_experts`` holds a routed-expert FFN (models/moe.py) in
``layer["moe"]`` in place of the dense MLP: dropless through the grouped
matmul kernel (gemm/grouped.py) when ``moe_dropless``, as the JAX loader
serves every Mixtral and Qwen3-MoE checkpoint, else capacity routing.

Training is ported too: ``loss_fn`` (next-token cross-entropy) and
``make_train_step`` (AdamW with optax's defaults, per-layer recompute under
``remat``) differentiate attention through the FA-2 backward kernels
(attention/flash_bwd.py) and everything else through PyTorch's autograd.

Sliding windows (``sliding_window``, on every layer or, with
``alt_window``, on the even layers: ``layer_window``) and the attention
softcap (``attn_softcap``) are options of the attention kernels: each layer
passes its window and the cap to the kernel its path runs (flash forward and
backward, ragged flash, decode, paged, chunk).

Attention sinks (``attn_sinks``: a learned f32 logit per head, GPT-OSS)
join each softmax's denominator: every path runs its attention kernel with
the log-sum-exp and rescales the output by ``sigmoid(lse - sink)``, in f32
cast to the output's dtype (``_sink``), as the JAX model does; under
training the lse's cotangent reaches the FA-2 backward, so the sinks get
gradients. A layer with ``moe_oss`` holds GPT-OSS's experts, a dense
combine in plain PyTorch (``_gptoss_moe``, no kernel in the JAX package
either). ``glm_rope_dim`` rotates GLM-4's first lanes in interleaved pairs
(ops/rope.py ``apply_rope_glm``).

``pipeline_forward`` runs the layer stack as a GPipe pipeline over a
mesh's "pp" ranks (parallel/pipeline.py).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): LoRA and multi-LoRA weight packs, training under a mesh or FSDP.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from leetcuda_tpu_torch.attention.decode import (decode_attention,
                                                 decode_attention_quantized)
from leetcuda_tpu_torch.attention.flash import flash_attention_ragged
from leetcuda_tpu_torch.attention.flash_bwd import \
    make_flash_attention_trainable
from leetcuda_tpu_torch.attention.paged import (paged_append,
                                                paged_append_quantized,
                                                paged_attention,
                                                paged_attention_quantized)
from leetcuda_tpu_torch.core.runtime import as_bytes, resolve_device
from leetcuda_tpu_torch.gemm.fused_decode import fused_norm_qkv_rope
from leetcuda_tpu_torch.gemm.quant import (matmul_w4a16, matmul_w8a16,
                                           quantize_groupwise_int4,
                                           quantize_rowwise_fp8,
                                           quantize_rowwise_int8)
from leetcuda_tpu_torch.models.moe import (MoEConfig, _top_k,
                                           init_moe_params, moe_ffn,
                                           moe_ffn_dropless)
from leetcuda_tpu_torch.ops.rope import apply_rope_glm, apply_rope_half


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX ModelConfig's fields, with ``dtype`` a ``torch.dtype``. The
    default is the flagship ~0.8B model."""
    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 4
    ffn_dim: int = 5632
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    n_experts: int = 0
    expert_topk: int = 2
    capacity_factor: float = 2.0
    moe_renorm: bool = False
    moe_ffn_dim: int = 0
    moe_dropless: bool = False
    hidden_act: str = "silu"          # "silu" | "gelu_tanh"
    sliding_window: int | None = None
    rms_offset: bool = False          # normalize * (1 + w) instead of * w
    embed_scale: bool = False         # x = embed[tokens] * sqrt(dim)
    head_dim_override: int | None = None
    qk_norm: bool = False             # per-head RMS norm on q/k before rope
    attn_softcap: float | None = None
    attn_sinks: bool = False
    glm_rope_dim: int = 0
    nope_interval: int = 0            # every Nth layer skips rope
    final_softcap: float | None = None
    query_scale: float | None = None  # attention scale override
    alt_window: bool = False
    sandwich_norms: bool = False      # post-attn / post-mlp output norms
    # ("llama3", factor, low_freq_factor, high_freq_factor, original_max_pos)
    # | ("linear", factor)
    # | ("yarn", factor, beta_fast, beta_slow, original_max_pos, truncate,
    #    attention_factor_or_None)
    rope_scaling: tuple | None = None

    def rope_inv_freq(self):
        """Scaled (head_dim/2,) inverse frequencies, or None (plain theta)."""
        if self.rope_scaling is None:
            return None
        from leetcuda_tpu_torch.ops.rope import (llama3_scaled_inv_freq,
                                                 yarn_scaled_inv_freq)
        kind = self.rope_scaling[0]
        if kind == "llama3":
            _, f, lo, hi, orig = self.rope_scaling
            return llama3_scaled_inv_freq(self.head_dim, self.rope_theta,
                                          f, lo, hi, orig)
        if kind == "linear":
            half = self.head_dim // 2
            base = self.rope_theta ** (
                -torch.arange(half, dtype=torch.float32) / half)
            return base / self.rope_scaling[1]
        if kind == "yarn":
            _, f, bf, bs, orig, trunc, af = self.rope_scaling
            return yarn_scaled_inv_freq(self.head_dim, self.rope_theta, f,
                                        bf, bs, orig, truncate=trunc,
                                        attention_factor=af)[0]
        raise NotImplementedError(f"rope_scaling kind {kind!r}")

    def rope_mscale(self) -> float:
        """YaRN attention factor scaling cos/sin (1.0 otherwise)."""
        if self.rope_scaling is None or self.rope_scaling[0] != "yarn":
            return 1.0
        from leetcuda_tpu_torch.ops.rope import yarn_scaled_inv_freq
        _, f, bf, bs, orig, trunc, af = self.rope_scaling
        return yarn_scaled_inv_freq(self.head_dim, self.rope_theta, f, bf,
                                    bs, orig, truncate=trunc,
                                    attention_factor=af)[1]

    def layer_rope(self, i: int | None = None) -> bool:
        """NoPE: every nope_interval-th layer attends without rotation."""
        if self.nope_interval and i is not None:
            return (i + 1) % self.nope_interval != 0
        return True

    def layer_window(self, i: int | None = None) -> int | None:
        """Layer ``i``'s sliding window: with ``alt_window`` the even layers
        slide and the odd ones attend globally (Gemma 2's layer types);
        None means the global window."""
        if self.alt_window and i is not None and i % 2 != 0:
            return None
        return self.sliding_window

    @property
    def head_dim(self):
        return self.head_dim_override or self.dim // self.n_heads

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(n_experts=self.n_experts, topk=self.expert_topk,
                         capacity_factor=self.capacity_factor, dim=self.dim,
                         ffn_dim=self.moe_ffn_dim or self.ffn_dim,
                         dtype=self.dtype, renorm_topk=self.moe_renorm)


def tiny_config(**kw) -> ModelConfig:
    """Small f32 config for tests."""
    base = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                ffn_dim=512, dtype=torch.float32)
    base.update(kw)
    return ModelConfig(**base)


def qwen3_30b_a3b_config() -> ModelConfig:
    """Qwen/Qwen3-30B-A3B's published config.json (model_type qwen3_moe:
    48 layers, hidden 2048, 32 query and 4 KV heads of 128, 128 experts of
    768 with 8 active and renormalized gates, vocab 151936, rope theta 1e6)
    as the JAX loader's ``config_from_hf`` maps it: per-head q/k norms,
    dropless experts, bf16."""
    return ModelConfig(vocab_size=151936, dim=2048, n_layers=48, n_heads=32,
                       n_kv_heads=4, ffn_dim=6144, rope_theta=1e6,
                       norm_eps=1e-6, dtype=torch.bfloat16, n_experts=128,
                       expert_topk=8, moe_renorm=True, moe_ffn_dim=768,
                       moe_dropless=True, head_dim_override=128,
                       qk_norm=True)


def gemma2_27b_config() -> ModelConfig:
    """google/gemma-2-27b's published config.json (model_type gemma2: 46
    layers, hidden 4608, 32 query and 16 KV heads of 128, intermediate
    36864, vocab 256000, gelu_pytorch_tanh, a 4096-token sliding window on
    alternating layers, attention softcap 50, final softcap 30,
    query_pre_attn_scalar 144) as the JAX loader's ``config_from_hf`` maps
    it: (1 + w) norms, sandwich norms, the embedding scaled by sqrt(hidden)
    and tied, bf16."""
    return ModelConfig(vocab_size=256000, dim=4608, n_layers=46, n_heads=32,
                       n_kv_heads=16, ffn_dim=36864, rope_theta=10000.0,
                       norm_eps=1e-6, dtype=torch.bfloat16,
                       hidden_act="gelu_tanh", sliding_window=4096,
                       rms_offset=True, embed_scale=True,
                       head_dim_override=128, attn_softcap=50.0,
                       final_softcap=30.0, query_scale=144 ** -0.5,
                       alt_window=True, sandwich_norms=True)


def gemma2_9b_config() -> ModelConfig:
    """google/gemma-2-9b's published config.json (model_type gemma2: 42
    layers, hidden 3584, 16 query and 8 KV heads of 256, intermediate
    14336, vocab 256000, gelu_pytorch_tanh, a 4096-token sliding window on
    alternating layers, attention softcap 50, final softcap 30,
    query_pre_attn_scalar 256, rms eps 1e-6, rope theta 10000) as the JAX
    loader's ``config_from_hf`` maps it: (1 + w) norms, sandwich norms, the
    embedding scaled by sqrt(hidden) and tied, bf16. About 9.24B
    parameters."""
    return dataclasses.replace(gemma2_27b_config(), dim=3584, n_layers=42,
                               n_heads=16, n_kv_heads=8, ffn_dim=14336,
                               head_dim_override=256,
                               query_scale=256 ** -0.5)


def gemma2_2b_config() -> ModelConfig:
    """google/gemma-2-2b's published config.json (model_type gemma2: 26
    layers, hidden 2304, 8 query and 4 KV heads of 256, intermediate 9216,
    and otherwise gemma-2-9b's switches) as the JAX loader's
    ``config_from_hf`` maps it. About 2.61B parameters."""
    return dataclasses.replace(gemma2_9b_config(), dim=2304, n_layers=26,
                               n_heads=8, n_kv_heads=4, ffn_dim=9216)


def gpt_oss_20b_config() -> ModelConfig:
    """openai/gpt-oss-20b's published config.json (model_type gpt_oss: 24
    layers, hidden 2880, 64 query and 8 KV heads of 64, 32 experts of 2880
    with 4 active, vocab 201088, untied head, rms eps 1e-5, rope theta
    150000 with YaRN (factor 32, beta_fast 32, beta_slow 1, original 4096,
    no truncation), a 128-token sliding window on alternating layers
    starting with layer 0, attention sinks, q/k/v/o biases) as the JAX
    loader's ``config_from_hf`` maps it: the experts are structure-driven
    (``layer["moe_oss"]``, so ``n_experts`` stays 0), bf16. About 20.9B
    parameters: 19.1B in the experts, 0.64B in attention, 1.16B in the
    embedding and the head."""
    return ModelConfig(vocab_size=201088, dim=2880, n_layers=24, n_heads=64,
                       n_kv_heads=8, ffn_dim=2880, rope_theta=150000.0,
                       norm_eps=1e-5, dtype=torch.bfloat16, expert_topk=4,
                       sliding_window=128, head_dim_override=64,
                       attn_sinks=True, alt_window=True,
                       rope_scaling=("yarn", 32.0, 32.0, 1.0, 4096, False,
                                     None))


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda"):
    """Random-init parameter dict (HF Llama layout), drawn from
    ``generator`` (on the generator's device, then moved to ``device``).
    With ``attn_sinks`` each layer also draws ``sinks`` (H,) f32 at 0.5
    times a standard normal, as JAX's does."""
    dev = resolve_device(device)
    D, H, Hkv, Dh, F_ = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                         cfg.ffn_dim)

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) / math.sqrt(fan_in)
        return w.to(device=dev, dtype=cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(D),
            "wq": dense(D, (D, H * Dh)),
            "wk": dense(D, (D, Hkv * Dh)),
            "wv": dense(D, (D, Hkv * Dh)),
            "wo": dense(H * Dh, (H * Dh, D)),
            "mlp_norm": ones(D),
        }
        if cfg.qk_norm:
            layer["q_norm"] = ones(Dh)
            layer["k_norm"] = ones(Dh)
        if cfg.sandwich_norms:
            layer["post_attn_norm"] = ones(D)
            layer["post_mlp_norm"] = ones(D)
        if cfg.attn_sinks:
            layer["sinks"] = (torch.randn(
                (H,), generator=generator, dtype=torch.float32,
                device=generator.device) * 0.5).to(dev)
        if cfg.n_experts:
            layer["moe"] = init_moe_params(generator, cfg.moe, dev)
        else:
            layer["w_gate"] = dense(D, (D, F_))
            layer["w_up"] = dense(D, (D, F_))
            layer["w_down"] = dense(F_, (F_, D))
        layers.append(layer)
    return {"embed": dense(D, (cfg.vocab_size, D)), "norm": ones(D),
            "layers": layers}


def linear(x, w, adapter_ids=None):
    """x (..., K) @ w. ``w`` is a dense (K, N) tensor or a weight-only pack
    (``quantize_params``): {"q": int8/e4m3 (K, N), "s": (N,)} goes through
    the w8a16 kernel, {"q4": (K/2, N), "s4": (K/128, N)} through the w4a16
    kernel, over the rows ``x.reshape(-1, K)``."""
    if adapter_ids is not None:
        raise NotImplementedError("multi-LoRA adapter routing is not ported")
    if not isinstance(w, dict):
        return x @ w
    if "As" in w or "A" in w:
        raise NotImplementedError(
            f"{'multi-LoRA' if 'As' in w else 'LoRA'} weight packs are not "
            "ported yet (ROADMAP: LoRA with the model families)")
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    if "q4" in w:
        out = matmul_w4a16(xf, w["q4"], w["s4"])
    else:
        out = matmul_w8a16(xf, w["q"], w["s"])
    return out.reshape(*lead, out.shape[-1])


def fuse_params(params):
    """Concatenate wq|wk|wv into wqkv and w_gate|w_up into w_gate_up. A pure
    layout transform: the fused params compute the same function. Every
    other key of a layer is kept (the same tensors), Gemma 2's sandwich
    norms among them; JAX's ``fuse_params`` keeps a fixed list that leaves
    them out, so its fused Gemma 2 computes another function."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for layer in params["layers"]:
        fused = {k: v for k, v in layer.items()
                 if k not in ("wq", "wk", "wv", "w_gate", "w_up")}
        fused["wqkv"] = torch.cat([layer["wq"], layer["wk"], layer["wv"]],
                                  dim=1)
        fused["w_gate_up"] = torch.cat([layer["w_gate"], layer["w_up"]], dim=1)
        out["layers"].append(fused)
    return out


def quantize_params(params, dtype="fp8"):
    """Weight-only quantization of every projection matrix (the layer keys
    starting with "w"); the embedding, the norms and ``lm_head`` keep the
    activation dtype. dtype: "fp8" (e4m3) or "int8", one scale per output
    column, or "int4", group-128 scales, nibble-packed. Composes as
    ``quantize_params(fuse_params(p))``: per-column scales make fusion
    exact."""
    if dtype == "int4":
        def qmat(w):
            packed, scales = quantize_groupwise_int4(w, group=128)
            return {"q4": packed, "s4": scales}
    elif dtype in ("fp8", "int8"):
        quant = quantize_rowwise_fp8 if dtype == "fp8" else quantize_rowwise_int8

        def qmat(w):
            q, s = quant(w, axis=0)
            return {"q": q, "s": s}
    else:
        raise ValueError(f"quantize_params: dtype {dtype!r} not in "
                         "('fp8', 'int8', 'int4')")
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: (qmat(v) if k.startswith("w") else v)
                      for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


def _proj_qkv(h, layer, H, Hkv, Dh):
    """Q/K/V projections, fused or split, with optional biases. Returns flat
    (..., X*Dh) tensors."""
    if "wqkv" in layer:
        qkv = linear(h, layer["wqkv"])
        q, k, v = torch.split(qkv, [H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    else:
        q, k, v = (linear(h, layer["wq"]), linear(h, layer["wk"]),
                   linear(h, layer["wv"]))
    if "bq" in layer:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    return q, k, v


def _gptoss_moe(h, moe, cfg: ModelConfig):
    """GPT-OSS's routed experts (HF GptOssExperts), JAX's
    ``_gptoss_moe`` in the same f32 precision: a biased router whose top-k
    LOGITS (ties to the lower index, ``_top_k``) softmax among themselves;
    every expert reads the interleaved gate / up projection with its
    biases, clamps (gate <= 7, |up| <= 7), gates with gate * sigmoid(1.702
    gate) and combines as (up + 1) * glu through its down projection and
    bias; a dense (tokens, E) weight matrix sums the experts. Each call
    casts one layer's expert weights to f32 (3.2 GB at GPT-OSS-20B's
    width), not the model's."""
    alpha, limit = 1.702, 7.0
    E, k = moe["w_gate_up"].shape[0], cfg.expert_topk
    hf = h.float()
    logits = hf @ moe["router_w"] + moe["router_b"]               # (..., E)
    topv, topi = _top_k(logits, k)
    topw = torch.softmax(topv, dim=-1)                         # over the k
    w_full = (F.one_hot(topi, E).float() * topw[..., None]).sum(-2)
    lead = hf.shape[:-1]
    x = hf.reshape(-1, hf.shape[-1])                              # (N, D)
    # batched over the experts as the weights lie, (E, D, 2F) and (E, F, D):
    # an einsum would first permute each layer's f32 copy of the experts
    gu = (torch.matmul(x, moe["w_gate_up"].float())
          + moe["b_gate_up"].float()[:, None, :])              # (E, N, 2F)
    gate, up = gu[..., ::2], gu[..., 1::2]
    gate = torch.clamp(gate, max=limit)
    up = torch.clamp(up, -limit, limit)
    glu = gate * torch.sigmoid(gate * alpha)
    del gu
    y = (torch.matmul((up + 1.0) * glu, moe["w_down"].float())
         + moe["b_down"].float()[:, None, :])                   # (E, N, D)
    out = torch.einsum("ne,end->nd", w_full.reshape(-1, E), y)
    return out.reshape(*lead, out.shape[-1]).to(h.dtype)


def _proj_mlp(h, layer, cfg: ModelConfig):
    if "moe_oss" in layer:
        return _gptoss_moe(h, layer["moe_oss"], cfg)
    if "moe" in layer:
        if cfg.moe_dropless:
            return moe_ffn_dropless(h, layer["moe"], cfg.moe)
        return moe_ffn(h, layer["moe"], cfg.moe)
    if "w_gate_up" in layer:
        gate, up = torch.chunk(linear(h, layer["w_gate_up"]), 2, dim=-1)
    else:
        gate, up = linear(h, layer["w_gate"]), linear(h, layer["w_up"])
    if cfg.hidden_act == "silu":
        gate = F.silu(gate.float())
    else:
        gate = F.gelu(gate.float(), approximate="tanh")
    return linear((gate * up.float()).to(h.dtype), layer["w_down"])


def _rms_norm(x, w, eps, offset: bool = False):
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    xhat = (xf * torch.rsqrt(ms + eps)).to(x.dtype)
    if offset:
        return xhat * (1.0 + w.float()).to(x.dtype)
    return xhat * w


def _apply_rope(x, positions, cfg: ModelConfig):
    """The family's rotary: GLM's partial interleaved one, else the half
    rotation with the scaled frequencies and YaRN's mscale."""
    if cfg.glm_rope_dim:
        if cfg.rope_scaling is not None:
            raise NotImplementedError(
                "GLM partial rotary with rope_scaling is not implemented "
                "(nor in the JAX package): refusing to ignore the scaling")
        return apply_rope_glm(x, positions, cfg.rope_theta, cfg.glm_rope_dim)
    return apply_rope_half(x, positions, cfg.rope_theta,
                           inv_freq=cfg.rope_inv_freq(),
                           mscale=cfg.rope_mscale())


def _embed(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = (x.float() * math.sqrt(cfg.dim)).to(x.dtype)
    return x


def _attn_in(layer, x, positions, cfg: ModelConfig, layer_idx):
    """Input norm, QKV projection, q/k norms and RoPE of one layer over
    (B, S, D) activations: q (B, S, H, Dh), k and v (B, S, Hkv, Dh)."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = (_rms_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.rms_offset)
         if "attn_norm" in layer else x)
    q, k, v = _proj_qkv(h, layer, H, Hkv, Dh)
    if "q_norm" in layer and layer["q_norm"].shape[-1] == H * Dh:
        # OLMo2: RMS norm over the flat projection, before the reshape
        q = _rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = _rms_norm(k, layer["k_norm"], cfg.norm_eps)
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = _rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = _rms_norm(k, layer["k_norm"], cfg.norm_eps)
    if cfg.layer_rope(layer_idx):
        q = _apply_rope(q, positions, cfg)
        k = _apply_rope(k, positions, cfg)
    return q, k, v


def _attn_out_and_mlp(layer, x, o, cfg: ModelConfig):
    """Output projection, residual, MLP block and residual. o is the
    attention output (..., H*Dh)."""
    attn_out = linear(o, layer["wo"])
    if "bo" in layer:
        attn_out = attn_out + layer["bo"]
    if "post_attn_norm" in layer:
        attn_out = _rms_norm(attn_out, layer["post_attn_norm"], cfg.norm_eps,
                             cfg.rms_offset)
    x = x + attn_out
    h = (_rms_norm(x, layer["mlp_norm"], cfg.norm_eps, cfg.rms_offset)
         if "mlp_norm" in layer else x)
    mlp_out = _proj_mlp(h, layer, cfg)
    if "post_mlp_norm" in layer:
        mlp_out = _rms_norm(mlp_out, layer["post_mlp_norm"], cfg.norm_eps,
                            cfg.rms_offset)
    return x + mlp_out


def _logits(params, x, cfg: ModelConfig):
    x = _rms_norm(x, params["norm"], cfg.norm_eps, cfg.rms_offset)
    w_lm = params.get("lm_head", params["embed"])
    logits = (x @ w_lm.T).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _sink(out, lse, sinks):
    """GPT-OSS attention sinks: a per-head logit joins the softmax's
    denominator, which rescales the output by sigmoid(lse - sink). out
    (B, H, ..., D), lse (B, H, ...) f32, sinks (H,) f32; the factor is
    formed in f32 and cast to out's dtype, as the JAX model casts it. A row
    that attends nothing (lse -1e30) stays zero."""
    shape = (1, -1) + (1,) * (lse.dim() - 2)
    return out * torch.sigmoid(lse - sinks.reshape(shape)).to(
        out.dtype)[..., None]


def apply_layer(layer, x, positions=None, cfg: ModelConfig = None,
                layer_idx: int | None = None):
    """One transformer layer (prefill and training path). x (B, S, D) ->
    (x, (k, v)) with the post-rope K/V (B, Hkv, S, Dh) that the decode path
    would cache. Attention is the trainable flash attention: the inference
    kernel when nothing requires a gradient, else the forward with its lse
    and the FA-2 backward kernels. A layer with ``sinks`` takes the lse in
    both cases and rescales by it (``_sink``; JAX's ``_attention``)."""
    B, S, _ = x.shape
    q, k, v = _attn_in(layer, x, positions, cfg, layer_idx)
    k = k.transpose(1, 2).contiguous()
    v = v.transpose(1, 2).contiguous()
    sinks = layer.get("sinks")
    fa = make_flash_attention_trainable(causal=True, sm_scale=cfg.query_scale,
                                        window=cfg.layer_window(layer_idx),
                                        softcap=cfg.attn_softcap,
                                        with_lse=sinks is not None)
    o = fa(q.transpose(1, 2).contiguous(), k, v)
    if sinks is not None:
        o = _sink(*o, sinks)
    o = o.transpose(1, 2).reshape(B, S, -1)
    return _attn_out_and_mlp(layer, x, o, cfg), (k, v)


def forward(params, tokens, cfg: ModelConfig, positions=None,
            return_kv: bool = False, remat: bool = False):
    """Causal LM forward. tokens (B, S) int -> logits (B, S, V) f32; with
    ``return_kv`` also the per-layer post-rope [(k, v)] of (B, Hkv, S, Dh).
    ``remat=True`` checkpoints each layer (non-reentrant
    ``torch.utils.checkpoint``): its activations are recomputed in the
    backward, so each layer's forward runs twice per training step."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    kvs = []
    for i, layer in enumerate(params["layers"]):
        if remat:
            x, kv = torch.utils.checkpoint.checkpoint(
                apply_layer, layer, x, positions, cfg, i, use_reentrant=False)
        else:
            x, kv = apply_layer(layer, x, positions, cfg, layer_idx=i)
        if return_kv:
            kvs.append(kv)
    logits = _logits(params, x, cfg)
    return (logits, kvs) if return_kv else logits


def pipeline_forward(params, tokens, cfg: ModelConfig, mesh,
                     n_microbatches: int | None = None):
    """Pipeline-parallel forward over the mesh's "pp" axis (GPipe,
    parallel/pipeline.py): the layers split into pp stages, each stage's
    weights on its rank's device; the batch splits into microbatches that
    stream through the stages. Embedding, final norm and the LM head run
    outside the pipeline. Layers run as JAX's stage scan runs them, without
    their index, so per-layer windows (``alt_window``) are refused.

    Requires n_layers % pp == 0 and batch % n_microbatches == 0."""
    from leetcuda_tpu_torch.parallel.pipeline import pipeline_apply

    n_stages = mesh.shape["pp"]
    if cfg.alt_window:
        raise ValueError("alt_window models need per-layer static kernels; "
                         "pipeline paths support uniform-window configs "
                         "only")
    B, S = tokens.shape
    M = n_microbatches or n_stages
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"n_layers={len(layers)} must divide into "
                         f"{n_stages} stages")
    k = len(layers) // n_stages
    stages = [layers[s * k:(s + 1) * k] for s in range(n_stages)]
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device).expand(B // M, S)

    def stage_fn(stage_layers, xmb):
        pos = positions.to(xmb.device)
        for layer in stage_layers:
            xmb, _ = apply_layer(layer, xmb, pos, cfg)
        return xmb

    x = pipeline_apply(stage_fn, stages, x.reshape(M, B // M, S, cfg.dim),
                       mesh)
    return _logits(params, x.reshape(B, S, cfg.dim).to(tokens.device), cfg)


def loss_fn(params, tokens, cfg: ModelConfig, remat: bool = False):
    """Next-token cross-entropy, mean over (B, S - 1) in f32. The model runs
    at the full S and the last position's logits are dropped, rather than
    feeding the kernels an S - 1 sequence."""
    logits = forward(params, tokens, cfg, remat=remat)[:, :-1]
    targets = tokens[:, 1:].long()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def named_leaves(tree, prefix=""):
    """[(name, tensor)] of a parameter tree, depth first in its own order
    (``embed``, ``layers.0.wq``, ...)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def make_train_step(cfg: ModelConfig, learning_rate: float = 3e-4,
                    remat: bool = True, mesh=None, fsdp: bool = False):
    """AdamW train step: returns ``(init_opt, step)`` with the JAX
    signatures. ``init_opt(params)`` marks every parameter as requiring a
    gradient and returns a ``torch.optim.AdamW`` over them with optax's
    ``adamw`` defaults written out (betas (0.9, 0.999), eps 1e-8, weight
    decay 1e-4; moments in the parameters' dtype, as optax keeps them).
    ``step(params, opt_state, tokens)`` -> ``(params, opt_state, loss)``
    updates ``params`` and ``opt_state`` IN PLACE (where JAX donates and
    returns new buffers) and returns them with the 0-d loss tensor; nothing
    in the step waits for the device. ``remat`` (default on) recomputes each
    layer's activations in the backward. ``mesh`` and ``fsdp`` are not
    ported yet. A ``moe_dropless`` config is refused, as in JAX: the grouped
    matmul has no backward (capacity MoE trains through autograd)."""
    if mesh is not None or fsdp:
        raise NotImplementedError(
            "make_train_step: training under a mesh or FSDP is not ported "
            "yet (ROADMAP item 12, the parallel layer)")
    if cfg.moe_dropless:
        raise ValueError(
            "make_train_step: moe_dropless routes the FFN through the "
            "grouped matmul, which has no backward; fine-tune with "
            "dataclasses.replace(cfg, moe_dropless=False, capacity_factor=...)")

    def init_opt(params):
        leaves = [p for _, p in named_leaves(params)]
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)

    def step(params, opt_state, tokens):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg, remat=remat)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_opt, step


def forward_ragged(params, tokens, lengths, cfg: ModelConfig):
    """Batched prefill over prompts of different lengths padded to a common
    S: logits (B, S, V) and per-layer K/V, attention masked to each row's
    valid prefix (the ragged flash kernel). lengths (B,) int32 on the
    tokens' device. Rows past a length are garbage the engine never reads."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    kvs = []
    for li, layer in enumerate(params["layers"]):
        q, k, v = _attn_in(layer, x, positions, cfg, li)
        k = k.transpose(1, 2).contiguous()
        v = v.transpose(1, 2).contiguous()
        kvs.append((k, v))
        sinks = layer.get("sinks")
        o = flash_attention_ragged(q.transpose(1, 2).contiguous(), k, v,
                                   lengths, sm_scale=cfg.query_scale,
                                   window=cfg.layer_window(li),
                                   softcap=cfg.attn_softcap,
                                   with_lse=sinks is not None)
        if sinks is not None:  # rows past a length: lse -1e30, stay zero
            o = _sink(*o, sinks)
        o = o.transpose(1, 2).reshape(B, S, -1)
        x = _attn_out_and_mlp(layer, x, o, cfg)
    return _logits(params, x, cfg), kvs


# --- decode path -------------------------------------------------------------------

_KV_QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _check_kv_quant(quant):
    if quant is not None and quant not in _KV_QUANT:
        raise ValueError(f"KV cache quant {quant!r} not in (None, 'int8', "
                         "'fp8')")


def _init_kv(shape, names, scale_names, n_layers, dtype, quant, dev):
    """Zeroed value tensors ``names`` of ``shape`` per layer; with ``quant``
    stored as int8 / e4m3 beside f32 scales ``scale_names`` of
    ``shape[:3]``, which start at ones."""
    if quant is None:
        return [{n: torch.zeros(shape, dtype=dtype, device=dev)
                 for n in names} for _ in range(n_layers)]
    qdt = _KV_QUANT[quant]
    return [{**{n: torch.zeros(shape, dtype=torch.uint8,
                               device=dev).view(qdt) for n in names},
             **{n: torch.ones(shape[:3], dtype=torch.float32, device=dev)
                for n in scale_names}} for _ in range(n_layers)]


def init_kv_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                   quant: str | None = None, device="cuda"):
    """Contiguous caches [{"k", "v"}] of (batch, Hkv, max_seq, Dh), zeroed.
    With ``quant`` ("int8" | "fp8") the values are stored quantized beside
    f32 scales per (batch, kv head, position), {"k_scale", "v_scale"} of
    (batch, Hkv, max_seq), which start at ones. The decode path updates the
    caches in place."""
    _check_kv_quant(quant)
    return _init_kv((batch, cfg.n_kv_heads, max_seq, cfg.head_dim),
                    ("k", "v"), ("k_scale", "v_scale"), cfg.n_layers,
                    dtype or cfg.dtype, quant, resolve_device(device))


def init_paged_kv_caches(cfg: ModelConfig, num_pages: int, page_size: int,
                         dtype=None, quant: str | None = None,
                         device="cuda"):
    """Paged caches (attention/paged.py): per-layer page pools [{"k_pages",
    "v_pages"}] of (num_pages, Hkv, page_size, Dh), zeroed, sharing one
    block table (kept host-side by ``PageManager``). With ``quant`` ("int8"
    | "fp8") the pools store quantized values beside f32 scale pools
    {"k_scales", "v_scales"} of (num_pages, Hkv, page_size), which start at
    ones. The decode path updates the pools in place."""
    _check_kv_quant(quant)
    return _init_kv((num_pages, cfg.n_kv_heads, page_size, cfg.head_dim),
                    ("k_pages", "v_pages"), ("k_scales", "v_scales"),
                    cfg.n_layers, dtype or cfg.dtype, quant,
                    resolve_device(device))


def _quantize_token_kv(x, qdt):
    """x (..., D) -> (x_q (..., D) of ``qdt``, scale (...) f32): one
    symmetric scale per vector, max-scaled to 127 (int8, rounded half to
    even) or 448 (e4m3)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    qmax = 127.0 if qdt == torch.int8 else 448.0
    scale = torch.clamp(amax, min=1e-8) / qmax
    xq = xf / scale[..., None]
    if qdt == torch.int8:
        xq = torch.round(xq)
    return xq.to(qdt), scale


def _cache_append(cache, k, v, pos, page_table=None):
    """Write this token's k/v (B, Hkv, Dh) at position ``pos`` (B,) of each
    row, IN PLACE (``cache["k"][b, :, pos[b]] = k[b]``; a paged cache
    indexes its pools through ``page_table``), quantizing first (values and
    scales) when the cache is quantized; returns ``cache``. The JAX
    package's dynamic-update-slice chain (a TPU aliasing workaround) has no
    counterpart here."""
    if "k_pages" in cache:
        if "k_scales" in cache:
            k, ks = _quantize_token_kv(k, cache["k_pages"].dtype)
            v, vs = _quantize_token_kv(v, cache["v_pages"].dtype)
            paged_append_quantized(
                cache["k_pages"], cache["v_pages"], cache["k_scales"],
                cache["v_scales"], k, v, ks, vs, page_table, pos)
        else:
            paged_append(cache["k_pages"], cache["v_pages"], k, v,
                         page_table, pos)
        return cache
    bidx = torch.arange(k.shape[0], device=k.device)
    p = pos.long()
    if "k_scale" in cache:
        k, ks = _quantize_token_kv(k, cache["k"].dtype)
        v, vs = _quantize_token_kv(v, cache["v"].dtype)
        cache["k_scale"][bidx, :, p] = ks
        cache["v_scale"][bidx, :, p] = vs
    as_bytes(cache["k"])[bidx, :, p] = as_bytes(k.to(cache["k"].dtype))
    as_bytes(cache["v"])[bidx, :, p] = as_bytes(v.to(cache["v"].dtype))
    return cache


def _cache_attend(q, cache, lengths, sm_scale=None, page_table=None,
                  window=None, softcap=None, sinks=None):
    """Decode attention of q (B, H, Dh) over a contiguous or paged cache,
    plain or quantized, with the layer's window and the softcap. With
    ``sinks`` (H,) the kernel also returns its lse and the output is
    rescaled (``_sink``)."""
    q = q.contiguous()
    kw = dict(sm_scale=sm_scale, window=window, softcap=softcap,
              with_lse=sinks is not None)
    if "k_pages" in cache:
        if "k_scales" in cache:
            o = paged_attention_quantized(
                q, cache["k_pages"], cache["v_pages"], cache["k_scales"],
                cache["v_scales"], page_table, lengths, **kw)
        else:
            o = paged_attention(q, cache["k_pages"], cache["v_pages"],
                                page_table, lengths, **kw)
    elif "k_scale" in cache:
        o = decode_attention_quantized(
            q, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
            lengths, **kw)
    else:
        o = decode_attention(q, cache["k"], cache["v"], lengths, **kw)
    return o if sinks is None else _sink(*o, sinks)


def _takes_fused_qkv(layer, cfg: ModelConfig) -> bool:
    """Whether the fused norm->QKV->RoPE kernel computes this layer's entry
    block: a dense fused ``wqkv`` (a tensor, not a quantized pack) behind an
    ``attn_norm``, no biases, no q/k norms, and the plain rotary on every
    layer. The JAX model also asks for a cache capacity of 2048 (a TPU
    measurement) and has an environment switch; the port has neither."""
    return ("wqkv" in layer and not isinstance(layer["wqkv"], dict)
            and "attn_norm" in layer and "bq" not in layer
            and "q_norm" not in layer and "sinks" not in layer
            and cfg.rope_scaling is None and not cfg.glm_rope_dim
            and not cfg.nope_interval)


def decode_step(params, tokens, caches, lengths, cfg: ModelConfig,
                page_table=None):
    """One decode step for B sequences. tokens (B,) int; lengths (B,) int32
    = context length EXCLUDING this token. Appends this token's K/V to
    ``caches`` IN PLACE and returns (logits (B, V) f32, caches). Paged
    caches (``init_paged_kv_caches``) need ``page_table`` (B, P_max) int32
    with the page of position ``lengths[b]`` already allocated.

    A layer with a dense fused ``wqkv`` (``fuse_params``) takes the fused
    norm->QKV->RoPE kernel (``_takes_fused_qkv``); every other layer the
    unfused norm, projections and RoPE."""
    B = tokens.shape[0]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = _embed(params, tokens, cfg)[:, None]  # (B, 1, D)
    pos = lengths
    attend_len = lengths + 1
    for li, (layer, cache) in enumerate(zip(params["layers"], caches)):
        if _takes_fused_qkv(layer, cfg):
            qkv = fused_norm_qkv_rope(
                x[:, 0], layer["attn_norm"], layer["wqkv"], pos, n_heads=H,
                n_kv_heads=Hkv, head_dim=Dh, eps=cfg.norm_eps,
                theta=cfg.rope_theta, rms_offset=cfg.rms_offset)
            q, k, v = torch.split(qkv, [H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
            q, k, v = (q.reshape(B, H, Dh), k.reshape(B, Hkv, Dh),
                       v.reshape(B, Hkv, Dh))
        else:
            q, k, v = (t[:, 0] for t in
                       _attn_in(layer, x, pos[:, None], cfg, li))
        cache = _cache_append(cache, k, v, pos, page_table=page_table)
        o = _cache_attend(q.to(cfg.dtype), cache, attend_len,
                          sm_scale=cfg.query_scale, page_table=page_table,
                          window=cfg.layer_window(li),
                          softcap=cfg.attn_softcap, sinks=layer.get("sinks"))
        x = _attn_out_and_mlp(layer, x, o.reshape(B, 1, H * Dh).to(x.dtype),
                              cfg)
    return _logits(params, x[:, 0], cfg), caches
