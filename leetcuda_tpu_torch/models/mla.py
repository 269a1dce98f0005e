"""Multi-head Latent Attention (MLA, the DeepSeek-V2/V3 family) in PyTorch.

Counterpart of ``leetcuda_tpu/models/mla.py``, with its names. The KV cache
holds ONE latent row a position: ``c = RMS(x @ W_dkv)[:d_c]`` (kv_lora_rank
lanes) and the RoPE'd key slice k_rope (d_r lanes), instead of per-head K
and V. Decode uses the weight-absorption identity (W_uk folded into the
query in f32, W_uv applied to the attended latent):

    score_h(t) = [q_h W_uk , q_h^rope] . [c_t , k_t^rope]
    out_h      = (sum_t A_h(t) c_t) W_uv_h

so the decode and paged attention kernels run it with ``shared_kv``: the
latent cache is both K and V, one KV head of d_c + d_r = 576 lanes under
the whole of H (attention/decode.py, attention/paged.py; on the card
``csrc/decode_attn.cu``), and lanes [:d_c] of the output are the
attended latent. Prefill runs the expanded multi-head form in f32 einsums
(plain PyTorch, as JAX computes it outside any Pallas kernel) and returns
the latent cache. Four decode caches: contiguous bf16, contiguous int8 /
e4m3 (a (rows, scales) pair, one f32 scale a position shared by c and
k_rope; the kernel then takes the absorbed query in f32 and gives an f32
output, as JAX's), and paged pools of either (``page_table``).

The model around it (``MLAModelConfig``): embed -> L x (MLA + a dense
SwiGLU MLP, or DeepSeek MoE on ``is_moe_layer`` layers, pre-RMSNorm,
residual) -> norm -> head (``lm_head`` when the params hold one, else the
tied embedding). DeepSeek MoE is JAX's dense combine: a greedy softmax
top-k router (ties to the lower expert id, ``models/moe.py`` ``_top_k``),
every expert on every token in f32, one (tokens, E) weight matrix, plus the
shared experts; batched matmuls over the experts' own (E, ., .) layout.

By design, against the JAX package: the decode step appends this token's
latent IN PLACE (JAX returns a new cache through dynamic-update-slice,
which clamps an out-of-range position; here it is a device assert), and
``mla_generate`` is a Python loop over ``mla_model_decode_step``. The TPU
tiling arguments (``block_k``) have no counterpart. Under a mesh
(``mla_decode_step(mesh=)``, ``mla_param_shardings``,
``shard_mla_params``) nothing is ported yet: it needs item 12b's
tensor-parallel runtime (ROADMAP item 12b), nor is training
(``mla_loss_fn``, ``make_mla_train_step``: ROADMAP item 11e3).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from leetcuda_tpu_torch.attention.decode import (decode_attention,
                                                 decode_attention_quantized)
from leetcuda_tpu_torch.attention.paged import (_write_token,
                                                paged_attention,
                                                paged_attention_quantized)
from leetcuda_tpu_torch.core.runtime import as_bytes, resolve_device
from leetcuda_tpu_torch.models.moe import _top_k
from leetcuda_tpu_torch.ops.rope import apply_rope_half, apply_rope_interleaved

_QDT = {"int8": (torch.int8, 127.0), "fp8": (torch.float8_e4m3fn, 448.0)}


def _quantize_latent(latent, quant: str):
    """Per-position symmetric quantization of latent rows (..., d_c + d_r):
    one f32 scale per position, shared by c and k_rope. int8 rounds half to
    even and clips to +-127; fp8 is the e4m3 cast of the scaled row."""
    qdt, qmax = _QDT[quant]
    lf = latent.float()
    s = torch.clamp(lf.abs().amax(dim=-1), min=1e-8) / qmax
    q = lf / s[..., None]
    if quant == "int8":
        q = torch.clamp(torch.round(q), -127, 127)
    return q.to(qdt), s


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """JAX's MLAConfig, with ``dtype`` a ``torch.dtype``."""
    dim: int = 2048
    n_heads: int = 16
    kv_lora_rank: int = 512       # d_c: latent width shared by K-nope and V
    qk_nope_head_dim: int = 128   # d_n: per-head non-rotary key/query lanes
    qk_rope_head_dim: int = 64    # d_r: shared rotary key lanes (1 "head")
    v_head_dim: int = 128         # d_v: per-head value lanes (expanded form)
    rope_theta: float = 10000.0
    # DeepSeek conventions: interleaved-pair RoPE on the rotary lanes,
    # RMSNorm on the latent (the cache stores the normed latent)
    rope_interleaved: bool = True
    latent_norm: bool = True
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def _dense(generator, dev, dtype):
    """A drawer of normals over sqrt(fan-in) from ``generator`` (on its
    device), moved to ``dev`` as ``dtype``."""
    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) / math.sqrt(fan_in)
        return w.to(device=dev, dtype=dtype)
    return dense


def init_mla_params(generator: torch.Generator, cfg: MLAConfig,
                    device="cuda"):
    """One MLA attention layer (HF DeepSeek naming minus the LoRA-q path),
    drawn from ``generator``: w_q (D, H (d_n + d_r)), w_dkv (D, d_c + d_r),
    w_uk (H, d_c, d_n), w_uv (H, d_c, d_v), w_o (H d_v, D), c_norm ones."""
    dev = resolve_device(device)
    D, H = cfg.dim, cfg.n_heads
    dc, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                      cfg.qk_rope_head_dim, cfg.v_head_dim)
    dense = _dense(generator, dev, cfg.dtype)
    p = {
        "w_q": dense(D, (D, H * (dn + dr))),
        "w_dkv": dense(D, (D, dc + dr)),
        "w_uk": dense(dc, (H, dc, dn)),
        "w_uv": dense(dc, (H, dc, dv)),
        "w_o": dense(H * dv, (H * dv, D)),
    }
    if cfg.latent_norm:
        p["c_norm"] = torch.ones(dc, dtype=cfg.dtype, device=dev)
    return p


def mla_param_shardings(cfg: MLAConfig):
    raise NotImplementedError(
        "mla_param_shardings: tensor parallelism needs the tensor-parallel "
        "runtime over a mesh, which the port lacks (ROADMAP item 12b)")


def shard_mla_params(params, cfg: MLAConfig, mesh):
    raise NotImplementedError(
        "shard_mla_params: tensor parallelism needs the tensor-parallel "
        "runtime over a mesh, which the port lacks (ROADMAP item 12b)")


def _mla_rms(x, w, eps):
    """RMS norm in f32, cast back to x's dtype, times the weight."""
    xf = x.float()
    v = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps)).to(x.dtype) * w


def _q_proj(params, x, cfg: MLAConfig):
    """x (..., D) -> (qn (..., H, d_n), qr (..., H, d_r)) pre-RoPE."""
    H, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (x @ params["w_q"]).reshape(*x.shape[:-1], H, dn + dr)
    return q[..., :dn], q[..., dn:]


def _latent_proj(params, x, cfg: MLAConfig):
    """x (..., D) -> (c (..., d_c), kr (..., d_r)); c is RMS-normed when the
    config says so (kv_a_layernorm), so every cache holds the normed
    latent."""
    dc = cfg.kv_lora_rank
    ckr = x @ params["w_dkv"]
    c, kr = ckr[..., :dc], ckr[..., dc:]
    if cfg.latent_norm:
        c = _mla_rms(c, params["c_norm"], cfg.norm_eps)
    return c, kr


def _rope(x, positions, cfg: MLAConfig):
    fn = apply_rope_interleaved if cfg.rope_interleaved else apply_rope_half
    return fn(x, positions, cfg.rope_theta)


def mla_prefill(params, x, cfg: MLAConfig, max_seq: int | None = None,
                quant: str | None = None):
    """Causal MLA over hidden states x (B, S, D).

    Returns (y (B, S, D), latent cache (B, 1, max_seq, d_c + d_r)): rows
    [c, RoPE(k_rope)] at positions < S, zeros after. The expanded form: K
    and V per head from the latent in f32 einsums, f32 scores at
    1 / sqrt(d_n + d_r), a causal mask of -inf, an f32 softmax. ``quant``
    ("int8" | "fp8"): the cache is a (rows, f32 scales (B, 1, max_seq))
    pair, scales 1 past S."""
    B, S, _ = x.shape
    H = cfg.n_heads
    max_seq = max_seq or S
    if max_seq < S:
        raise ValueError(f"max_seq {max_seq} < prompt length {S}")
    positions = torch.arange(S, device=x.device).expand(B, S)

    qn, qr = _q_proj(params, x, cfg)                       # (B,S,H,dn/dr)
    qr = _rope(qr, positions, cfg)
    c, kr = _latent_proj(params, x, cfg)                   # (B,S,dc/dr)
    kr = _rope(kr[:, :, None, :], positions, cfg)[:, :, 0]  # (B,S,dr)

    kn = torch.einsum("bsc,hcn->bshn", c.float(), params["w_uk"].float())
    v = torch.einsum("bsc,hcv->bshv", c.float(), params["w_uv"].float())
    scale = 1.0 / math.sqrt(cfg.qk_head_dim)
    s = (torch.einsum("bthn,bshn->bhts", qn.float(), kn)
         + torch.einsum("bthr,bsr->bhts", qr.float(), kr.float())) * scale
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
    s = s.masked_fill(~mask, float("-inf"))
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshv->bthv", a, v)            # (B,S,H,dv)
    y = out.reshape(B, S, H * cfg.v_head_dim).to(x.dtype) @ params["w_o"]

    latent = torch.cat([c, kr], dim=-1)[:, None]           # (B,1,S,L)
    L = cfg.latent_dim
    if quant is not None:
        lat_q, lat_s = _quantize_latent(latent, quant)
        rows = torch.zeros((B, 1, max_seq, L), dtype=_QDT[quant][0],
                           device=x.device)
        as_bytes(rows)[:, :, :S] = as_bytes(lat_q)
        scales = torch.ones((B, 1, max_seq), dtype=torch.float32,
                            device=x.device)
        scales[:, :, :S] = lat_s
        return y, (rows, scales)
    cache = torch.zeros((B, 1, max_seq, L), dtype=cfg.dtype, device=x.device)
    cache[:, :, :S] = latent.to(cfg.dtype)
    return y, cache


def init_paged_latent_cache(cfg: MLAConfig, num_pages: int, page: int,
                            quant: str | None = None, device="cuda"):
    """Paged latent pool (num_pages, 1, page, d_c + d_r) of zeros; with
    ``quant`` ("int8" | "fp8") a (pool, f32 scale pool (num_pages, 1,
    page)) pair. Pages come from ``attention/paged.PageManager``, as the
    llama engine's."""
    dev = resolve_device(device)
    L = cfg.latent_dim
    if quant is None:
        return torch.zeros((num_pages, 1, page, L), dtype=cfg.dtype,
                           device=dev)
    return (torch.zeros((num_pages, 1, page, L), dtype=_QDT[quant][0],
                        device=dev),
            torch.zeros((num_pages, 1, page), dtype=torch.float32,
                        device=dev))


def _append_token(cache, latent_t, pos):
    """Write latent_t (B, 1, L) (and its scales (B, 1)) at position
    ``pos[b]`` of each row of a contiguous cache, IN PLACE."""
    bidx = torch.arange(latent_t.shape[0], device=latent_t.device)
    p = pos.long()
    if isinstance(cache, tuple):
        rows, scales = cache
        lat_q, lat_s = _quantize_latent(
            latent_t, "int8" if rows.dtype == torch.int8 else "fp8")
        as_bytes(rows)[bidx, :, p] = as_bytes(lat_q)
        scales[bidx, :, p] = lat_s
        return
    as_bytes(cache)[bidx, :, p] = as_bytes(latent_t.to(cache.dtype))


def mla_decode_step(params, x_t, cache, lengths, cfg: MLAConfig, mesh=None,
                    page_table=None):
    """One absorbed decode step. x_t (B, D) hidden states at positions
    ``lengths`` (B,) int32; ``cache`` a latent cache from ``mla_prefill``
    ((B, 1, max_seq, L), or its quantized (rows, scales) pair) or, with
    ``page_table`` (B, P_max) int32, a pool from ``init_paged_latent_cache``
    (the page holding position lengths[b] allocated). Appends this token's
    latent IN PLACE and returns (y (B, D), cache).

    The query absorbs W_uk in f32; it is cast to the cache's dtype for an
    unquantized cache and stays f32 for a quantized one, whose kernel gives
    an f32 output. The shared kernel attends lengths + 1 positions at
    1 / sqrt(d_n + d_r); lanes [:d_c] of its output meet W_uv, lanes [d_c:]
    (sum A k_rope) are dropped."""
    if mesh is not None:
        raise NotImplementedError(
            "mla_decode_step: decoding under a mesh is not ported yet "
            "(ROADMAP item 12b)")
    B, _ = x_t.shape
    H, dc = cfg.n_heads, cfg.kv_lora_rank
    pos = lengths

    qn, qr = _q_proj(params, x_t, cfg)                     # (B,H,dn/dr)
    qr = _rope(qr[:, None], pos[:, None], cfg)[:, 0]       # (B,H,dr)
    # absorb W_uk into the query: q_lat . c == (q W_uk) . c
    q_lat = torch.einsum("bhn,hcn->bhc", qn.float(), params["w_uk"].float())
    q_cat = torch.cat([q_lat, qr.float()], dim=-1)         # (B,H,L) f32
    quantized = isinstance(cache, tuple)

    c_t, kr_t = _latent_proj(params, x_t, cfg)
    kr_t = _rope(kr_t[:, None, None, :], pos[:, None], cfg)[:, 0, 0]
    latent_t = torch.cat([c_t, kr_t], dim=-1)[:, None]     # (B,1,L)
    kw = dict(sm_scale=1.0 / math.sqrt(cfg.qk_head_dim), shared_kv=True)
    attend = lengths + 1

    if page_table is not None:
        if quantized:
            pool, scales = cache
            lat_q, lat_s = _quantize_latent(
                latent_t, "int8" if pool.dtype == torch.int8 else "fp8")
            _write_token(((pool, lat_q), (scales, lat_s)), page_table, pos)
            att = paged_attention_quantized(q_cat, pool, scales, page_table,
                                            attend, **kw)
        else:
            _write_token(((cache, latent_t),), page_table, pos)
            att = paged_attention(q_cat.to(cache.dtype), cache, page_table,
                                  attend, **kw)
    else:
        _append_token(cache, latent_t, pos)
        if quantized:
            att = decode_attention_quantized(q_cat, *cache, attend, **kw)
        else:
            att = decode_attention(q_cat.to(cache.dtype), cache, attend,
                                   **kw)
    out_lat = att[..., :dc].float()                        # (B,H,dc)
    out = torch.einsum("bhc,hcv->bhv", out_lat, params["w_uv"].float())
    y = out.reshape(B, H * cfg.v_head_dim).to(x_t.dtype) @ params["w_o"]
    return y, cache


def kv_bytes_per_token(cfg: MLAConfig) -> tuple[int, int]:
    """(mla_bytes, mha_bytes) per token per layer at cfg.dtype: the latent
    row against an expanded cache's K at d_n + d_r and V at d_v lanes a
    head (8.9x at the defaults, H=16; 17.8x at H=32)."""
    item = torch.empty((), dtype=cfg.dtype).element_size()
    mla = cfg.latent_dim * item
    mha = cfg.n_heads * (cfg.qk_head_dim + cfg.v_head_dim) * item
    return mla, mha


# --- the MLA language model ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAModelConfig(MLAConfig):
    """JAX's MLAModelConfig: the model around MLA, with DeepSeek MoE on the
    layers from ``first_k_dense`` on when ``n_routed_experts``."""
    vocab_size: int = 32000
    n_layers: int = 2
    ffn_dim: int = 4096
    norm_eps: float = 1e-5
    n_routed_experts: int = 0
    num_experts_per_tok: int = 2
    moe_ffn_dim: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False

    def is_moe_layer(self, i: int) -> bool:
        return self.n_routed_experts > 0 and i >= self.first_k_dense


def deepseek_v2_lite_config() -> MLAModelConfig:
    """deepseek-ai/DeepSeek-V2-Lite's published config.json (model_type
    deepseek_v2: 27 layers, hidden 2048, 16 heads, q_lora_rank null,
    kv_lora_rank 512, qk_nope_head_dim 128, qk_rope_head_dim 64,
    v_head_dim 128, intermediate 10944 on the first_k_dense_replace = 1
    dense layer, 64 routed experts of 1408 with 6 active and 2 shared,
    greedy top-k, norm_topk_prob false, routed_scaling_factor 1.0, vocab
    102400, untied head, rms eps 1e-6, rope theta 10000) as
    ``config_from_hf_deepseek`` maps it, bf16, with its YaRN rope_scaling
    (factor 40, mscale 0.707) dropped: the JAX package refuses any
    rope_scaling, so the attention scale is 1 / sqrt(192) and the rotary
    plain. About 15.7B parameters: 14.85B in the experts, 0.37B in
    attention, 0.42B in the embedding and the head, 0.07B in layer 0's
    MLP. Its head is untied: ``init_mla_model(..., untied_head=True)``."""
    return MLAModelConfig(dim=2048, n_heads=16, kv_lora_rank=512,
                          qk_nope_head_dim=128, qk_rope_head_dim=64,
                          v_head_dim=128, rope_theta=10000.0, norm_eps=1e-6,
                          vocab_size=102400, n_layers=27, ffn_dim=10944,
                          n_routed_experts=64, num_experts_per_tok=6,
                          moe_ffn_dim=1408, n_shared_experts=2,
                          first_k_dense=1, routed_scaling_factor=1.0,
                          norm_topk_prob=False, dtype=torch.bfloat16)


def init_mla_model(generator: torch.Generator, cfg: MLAModelConfig,
                   device="cuda", untied_head: bool = False):
    """Random-init model parameters (JAX's tree) drawn from ``generator``
    one layer at a time: ``embed``, ``norm``, ``layers`` [{attn_norm, attn,
    mlp_norm, and w_gate / w_up / w_down or, on ``is_moe_layer`` layers,
    ``moe``: gate_w (E, D), w_gate / w_up (E, D, F), w_down (E, F, D) and,
    with shared experts, ``shared`` (one MLP of n_shared x F)}]; with
    ``untied_head`` also ``lm_head`` (V, D)."""
    dev = resolve_device(device)
    D, F_ = cfg.dim, cfg.ffn_dim
    dense = _dense(generator, dev, cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=dev)

    layers = []
    for i in range(cfg.n_layers):
        layer = {"attn_norm": ones(D),
                 "attn": init_mla_params(generator, cfg, dev),
                 "mlp_norm": ones(D)}
        if cfg.is_moe_layer(i):
            E, Fm = cfg.n_routed_experts, cfg.moe_ffn_dim
            Fs = Fm * max(cfg.n_shared_experts, 1)
            layer["moe"] = {"gate_w": dense(D, (E, D)),
                            "w_gate": dense(D, (E, D, Fm)),
                            "w_up": dense(D, (E, D, Fm)),
                            "w_down": dense(Fm, (E, Fm, D))}
            if cfg.n_shared_experts:
                layer["moe"]["shared"] = {"w_gate": dense(D, (D, Fs)),
                                          "w_up": dense(D, (D, Fs)),
                                          "w_down": dense(Fs, (Fs, D))}
        else:
            layer.update(w_gate=dense(D, (D, F_)), w_up=dense(D, (D, F_)),
                         w_down=dense(F_, (F_, D)))
        layers.append(layer)
    params = {"embed": dense(D, (cfg.vocab_size, D)), "norm": ones(D),
              "layers": layers}
    if untied_head:
        params["lm_head"] = dense(D, (cfg.vocab_size, D))
    return params


def _mla_mlp(x, layer):
    g = F.silu((x @ layer["w_gate"]).float())
    return (g * (x @ layer["w_up"]).float()).to(x.dtype) @ layer["w_down"]


def _deepseek_moe(x, moe, cfg: MLAModelConfig):
    """DeepSeek MoE, JAX's dense combine in f32: softmax router scores,
    greedy top-k (ties to the lower expert id), weights optionally
    renormalised, times routed_scaling_factor, in a dense (tokens, E)
    matrix; every expert on every token, batched over the experts as their
    weights lie ((E, D, F), (E, F, D): an einsum would first permute each
    f32 copy); plus the always-on shared experts."""
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    xf = x.float()
    scores = torch.softmax(xf @ moe["gate_w"].float().T, dim=-1)  # (..., E)
    topw, topi = _top_k(scores, k)
    if cfg.norm_topk_prob:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    topw = topw * cfg.routed_scaling_factor
    w_full = (F.one_hot(topi, E).float() * topw[..., None]).sum(-2)
    lead = xf.shape[:-1]
    xr = xf.reshape(-1, xf.shape[-1])                             # (N, D)
    h = (F.silu(torch.matmul(xr, moe["w_gate"].float()))
         * torch.matmul(xr, moe["w_up"].float()))                 # (E, N, F)
    y = torch.matmul(h, moe["w_down"].float())                    # (E, N, D)
    del h
    out = torch.einsum("ne,end->nd", w_full.reshape(-1, E), y)
    out = out.reshape(*lead, out.shape[-1])
    if "shared" in moe:
        out = out + _mla_mlp(x, moe["shared"]).float()
    return out.to(x.dtype)


def _mla_ffn(x, layer, cfg: MLAModelConfig):
    if "moe" in layer:
        return _deepseek_moe(x, layer["moe"], cfg)
    return _mla_mlp(x, layer)


def _mla_logits(params, x, cfg: MLAModelConfig):
    x = _mla_rms(x, params["norm"], cfg.norm_eps)
    w_lm = params.get("lm_head", params["embed"])
    return (x @ w_lm.T).float()


def mla_model_prefill(params, tokens, cfg: MLAModelConfig,
                      max_seq: int | None = None):
    """tokens (B, S) -> (logits (B, S, V) f32, [per-layer latent cache])."""
    x = params["embed"][tokens.long()]
    caches = []
    for layer in params["layers"]:
        a, cache = mla_prefill(layer["attn"],
                               _mla_rms(x, layer["attn_norm"], cfg.norm_eps),
                               cfg, max_seq=max_seq)
        x = x + a
        x = x + _mla_ffn(_mla_rms(x, layer["mlp_norm"], cfg.norm_eps),
                         layer, cfg)
        caches.append(cache)
    return _mla_logits(params, x, cfg), caches


def mla_model_decode_step(params, tokens, caches, lengths,
                          cfg: MLAModelConfig, page_table=None):
    """tokens (B,) -> (logits (B, V) f32, caches): one absorbed decode step
    over every layer's latent cache, each appended IN PLACE. With
    ``page_table`` the caches are per-layer pools, all behind one table."""
    x = params["embed"][tokens.long()]
    for layer, cache in zip(params["layers"], caches):
        a, _ = mla_decode_step(
            layer["attn"], _mla_rms(x, layer["attn_norm"], cfg.norm_eps),
            cache, lengths, cfg, page_table=page_table)
        x = x + a
        x = x + _mla_ffn(_mla_rms(x, layer["mlp_norm"], cfg.norm_eps),
                         layer, cfg)
    return _mla_logits(params, x, cfg), caches


def mla_generate(params, cfg: MLAModelConfig, prompts, max_new: int,
                 max_seq: int | None = None):
    """Greedy generation: prompts (B, S) -> (B, max_new) int32 tokens, the
    prefill's argmax first, then one ``mla_model_decode_step`` a token (the
    tokens JAX's scan emits; its last step, whose token is never emitted,
    is not run)."""
    B, S = prompts.shape
    max_seq = max_seq or S + max_new
    logits, caches = mla_model_prefill(params, prompts, cfg, max_seq=max_seq)
    tok = logits[:, S - 1].argmax(dim=-1).to(torch.int32)
    lengths = torch.full((B,), S, dtype=torch.int32, device=prompts.device)
    out = [tok]
    for _ in range(max_new - 1):
        lg, caches = mla_model_decode_step(params, tok, caches, lengths, cfg)
        tok = lg.argmax(dim=-1).to(torch.int32)
        lengths = lengths + 1
        out.append(tok)
    return torch.stack(out, dim=1)


# --- the HF DeepSeek loader ---------------------------------------------------


def config_from_hf_deepseek(hf_cfg) -> MLAModelConfig:
    """The MLAModelConfig of a transformers DeepseekV2Config, f32, as JAX's
    maps it. Refused, as JAX refuses them: the q-LoRA path
    (``q_lora_rank``), any ``rope_scaling`` (YaRN with its mscale),
    attention biases, and routing other than greedy top-k."""
    if hf_cfg.q_lora_rank is not None:
        raise ValueError("config_from_hf_deepseek: the q-LoRA path "
                         "(q_lora_rank) is not implemented")
    if getattr(hf_cfg, "rope_scaling", None) is not None:
        raise ValueError("config_from_hf_deepseek: rope_scaling (YaRN, its "
                         "mscale attention scaling included) is not "
                         "implemented; logits would silently diverge")
    if getattr(hf_cfg, "attention_bias", False):
        raise ValueError("config_from_hf_deepseek: attention biases are not "
                         "implemented")
    moe = {}
    n_routed = getattr(hf_cfg, "n_routed_experts", None)
    if n_routed and hf_cfg.num_hidden_layers > hf_cfg.first_k_dense_replace:
        if hf_cfg.topk_method != "greedy":
            raise ValueError(f"config_from_hf_deepseek: topk_method "
                             f"{hf_cfg.topk_method!r}; only greedy top-k "
                             "routing is implemented")
        moe = dict(
            n_routed_experts=n_routed,
            num_experts_per_tok=hf_cfg.num_experts_per_tok,
            moe_ffn_dim=hf_cfg.moe_intermediate_size,
            n_shared_experts=hf_cfg.n_shared_experts or 0,
            first_k_dense=hf_cfg.first_k_dense_replace,
            routed_scaling_factor=hf_cfg.routed_scaling_factor,
            norm_topk_prob=hf_cfg.norm_topk_prob)
    return MLAModelConfig(
        dim=hf_cfg.hidden_size, n_heads=hf_cfg.num_attention_heads,
        kv_lora_rank=hf_cfg.kv_lora_rank,
        qk_nope_head_dim=hf_cfg.qk_nope_head_dim,
        qk_rope_head_dim=hf_cfg.qk_rope_head_dim,
        v_head_dim=hf_cfg.v_head_dim, rope_theta=hf_cfg.rope_theta,
        norm_eps=hf_cfg.rms_norm_eps, vocab_size=hf_cfg.vocab_size,
        n_layers=hf_cfg.num_hidden_layers,
        ffn_dim=hf_cfg.intermediate_size, dtype=torch.float32, **moe)


def load_deepseek_v2(hf_model, device="cuda"):
    """(params, cfg) from a transformers DeepseekV2ForCausalLM, f32 on
    ``device``: dense and MoE layers (greedy routing, shared experts);
    ``kv_b_proj`` (H (d_n + d_v), d_c) splits into w_uk (H, d_c, d_n) and
    w_uv (H, d_c, d_v); an untied head becomes ``lm_head``."""
    dev = resolve_device(device)
    hf_cfg = hf_model.config
    cfg = config_from_hf_deepseek(hf_cfg)
    H, dn, dv, dc = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    sd = {k: v.detach().to("cpu", torch.float32)
          for k, v in hf_model.state_dict().items()}

    def w(name):
        return sd[name].to(dev, cfg.dtype)

    def t(name):  # a torch Linear's (out, in) as (in, out)
        return sd[name].T.contiguous().to(dev, cfg.dtype)

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        kv_b = sd[p + "self_attn.kv_b_proj.weight"].reshape(H, dn + dv, dc)
        layer = {
            "attn_norm": w(p + "input_layernorm.weight"),
            "mlp_norm": w(p + "post_attention_layernorm.weight"),
            "attn": {
                "w_q": t(p + "self_attn.q_proj.weight"),
                "w_dkv": t(p + "self_attn.kv_a_proj_with_mqa.weight"),
                "c_norm": w(p + "self_attn.kv_a_layernorm.weight"),
                "w_uk": kv_b[:, :dn].transpose(1, 2).contiguous().to(
                    dev, cfg.dtype),
                "w_uv": kv_b[:, dn:].transpose(1, 2).contiguous().to(
                    dev, cfg.dtype),
                "w_o": t(p + "self_attn.o_proj.weight"),
            },
        }
        if cfg.is_moe_layer(i):
            E = cfg.n_routed_experts
            layer["moe"] = {
                "gate_w": w(p + "mlp.gate.weight"),
                **{key: torch.stack([t(p + f"mlp.experts.{e}.{proj}.weight")
                                     for e in range(E)])
                   for key, proj in (("w_gate", "gate_proj"),
                                     ("w_up", "up_proj"),
                                     ("w_down", "down_proj"))}}
            if cfg.n_shared_experts:
                layer["moe"]["shared"] = {
                    key: t(p + f"mlp.shared_experts.{proj}.weight")
                    for key, proj in (("w_gate", "gate_proj"),
                                      ("w_up", "up_proj"),
                                      ("w_down", "down_proj"))}
        else:
            layer.update(w_gate=t(p + "mlp.gate_proj.weight"),
                         w_up=t(p + "mlp.up_proj.weight"),
                         w_down=t(p + "mlp.down_proj.weight"))
        layers.append(layer)
    params = {"embed": w("model.embed_tokens.weight"),
              "norm": w("model.norm.weight"), "layers": layers}
    if "lm_head.weight" in sd and not hf_cfg.tie_word_embeddings:
        params["lm_head"] = w("lm_head.weight")
    return params, cfg
