"""Speculative decoding and the T-token decode step behind every chunk path.

Counterpart of ``leetcuda_tpu/engine/speculative.py``. ``decode_chunk``
advances each sequence T positions in one pass: all T K/V are appended to the
cache IN PLACE, then the T rows attend through the chunk kernel
(attention/chunk.py), over a contiguous or paged cache, plain or quantized.
Speculative verify (T = k + 1), prefix-cached admission and bounded chunked
prefill (engine/engine.py) all go through it. Greedy speculative decoding is
exact: the stream equals the target's own greedy decode. Rolling back a
rejected suffix is not advancing ``lengths``: its K/V stay masked and later
appends overwrite them.

Positions at or past the cache capacity are dropped by ``_chunk_append`` and
never read by the kernel (the JAX package's dynamic-update-slice shifts such
a write back over earlier positions instead). A layer with attention
sinks runs the chunk kernels with their lse and rescales the rows by
sigmoid(lse - sink) (models/llama.py ``_sink``). Meshes and multi-LoRA
adapter routing are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from leetcuda_tpu_torch.attention.chunk import (
    chunk_attention, chunk_attention_quantized, paged_chunk_attention,
    paged_chunk_attention_quantized)
from leetcuda_tpu_torch.core.runtime import as_bytes, round_up
from leetcuda_tpu_torch.engine.engine import _insert_kvs, _serving_device
from leetcuda_tpu_torch.engine.sampling import greedy, make_warper
from leetcuda_tpu_torch.models.llama import (
    ModelConfig, _attn_in, _attn_out_and_mlp, _embed, _logits,
    _quantize_token_kv, _sink, decode_step, forward, init_kv_caches)


def _append_index(cache, pos, page_table=None):
    """Where ``_chunk_append`` writes the (b, t) entries at positions ``pos``
    (B, T): (rows, offs, src). Entry (b, t) goes to ``[rows, :, offs]`` of a
    contiguous cache (rows = b, offs = the position) or of a pool (rows = the
    physical page, offs = the offset inside it); ``src`` (contiguous only)
    is the chunk entry whose value it carries. The same for every layer."""
    B, T = pos.shape
    pos = pos.long()
    bidx = torch.arange(B, device=pos.device)[:, None]
    if "k_pages" in cache:
        page = cache["k_pages"].shape[2]
        p_max = page_table.shape[1]
        phys = page_table.long()[bidx, (pos // page).clamp(max=p_max - 1)]
        rows = torch.where(pos < p_max * page, phys, torch.zeros_like(phys))
        return rows, pos % page, None
    cap = cache["k"].shape[2]
    # past the capacity an entry repeats the one that lands on cap - 1
    src = torch.where(pos < cap, torch.arange(T, device=pos.device)[None, :],
                      (cap - 1 - pos[:, :1]).clamp(0, T - 1))
    return bidx, pos.clamp(max=cap - 1), (bidx, src)


def _chunk_append(cache, k, v, pos, page_table=None, page_aligned=False,
                  index=None):
    """Append T tokens' K/V (B, T, Hkv, Dh) at the CONTIGUOUS positions
    ``pos`` (B, T) of each row, IN PLACE, by one indexed write per tensor for
    all (b, t), quantizing first (values and scales) when the cache is
    quantized; returns ``cache``. ``page_aligned`` (admission chunks start on
    a page boundary and span whole pages) needs no second code path here; the
    JAX package's per-page and per-token dynamic-update-slice chains are a
    TPU aliasing workaround. ``index``: ``_append_index`` of these positions,
    when the caller has it already.

    Positions at or past the capacity are dropped. Paged, they and every
    position of a row whose table entry is the null page 0 (released or
    preempted slots) land on page 0, in no defined order: nothing reads page
    0 for a live row. Contiguous, a dropped entry repeats the write of the
    row's entry that lands on the last position (every duplicate carries the
    same value, so the result is defined); a row that lies wholly past the
    capacity leaves its first token there, and is past serving anyway."""
    rows, offs, src = index or _append_index(cache, pos, page_table)
    names = (("k_pages", "v_pages", "k_scales", "v_scales")
             if "k_pages" in cache else ("k", "v", "k_scale", "v_scale"))
    values = [k, v]
    if names[2] in cache:
        kq, ks = _quantize_token_kv(k, cache[names[0]].dtype)
        vq, vs = _quantize_token_kv(v, cache[names[1]].dtype)
        values = [kq, vq, ks, vs]
    for name, x in zip(names, values):
        dst = cache[name]
        xb = as_bytes(x.to(dst.dtype))
        as_bytes(dst)[rows, :, offs] = xb if src is None else xb[src]
    return cache


def _chunk_cache_attend(q, cache, base_lengths, cfg: ModelConfig, mesh=None,
                        page_table=None, window=None, sinks=None):
    """Chunk attention of q (B, T, H, Dh) over any cache layout through the
    attention/chunk.py wrappers -> (B, T, H, Dh) f32. With ``sinks`` (H,)
    the kernel also returns its lse (B, H, T) and the rows are rescaled
    (``_sink``), as JAX's ``_chunk_cache_attend`` does."""
    if mesh is not None:
        raise NotImplementedError(
            "chunk attention under a mesh is not ported yet (ROADMAP item "
            "12, the parallel layer)")
    kw = dict(sm_scale=cfg.query_scale, window=window,
              softcap=cfg.attn_softcap, with_lse=sinks is not None)
    qk = q.transpose(1, 2).to(cfg.dtype).contiguous()  # (B, H, T, Dh)
    if "k_pages" in cache:
        if "k_scales" in cache:
            o = paged_chunk_attention_quantized(
                qk, cache["k_pages"], cache["v_pages"], cache["k_scales"],
                cache["v_scales"], page_table, base_lengths, **kw)
        else:
            o = paged_chunk_attention(qk, cache["k_pages"], cache["v_pages"],
                                      page_table, base_lengths, **kw)
    elif "k_scale" in cache:
        o = chunk_attention_quantized(qk, cache["k"], cache["v"],
                                      cache["k_scale"], cache["v_scale"],
                                      base_lengths, **kw)
    else:
        o = chunk_attention(qk, cache["k"], cache["v"], base_lengths, **kw)
    if sinks is not None:
        o = _sink(*o, sinks)
    return o.transpose(1, 2).float()


def decode_chunk(params, tokens, caches, lengths, cfg: ModelConfig,
                 mesh=None, page_table=None, page_aligned=False,
                 adapter_ids=None):
    """T-token decode step (chunked prefill / speculative verify).

    tokens (B, T) int at positions lengths..lengths+T-1; lengths (B,) int32
    EXCLUDES the chunk. Appends all T K/V to ``caches`` IN PLACE and returns
    (logits (B, T, V) f32, caches). Paged caches need ``page_table``
    (B, P_max) int32 with the pages of positions up to lengths+T-1 allocated
    already. Quantized weight packs go through ``linear`` as they are; the
    fused norm->QKV->RoPE block is a one-token kernel and is not used here,
    as in the JAX package."""
    if mesh is not None or adapter_ids is not None:
        raise NotImplementedError(
            "decode_chunk under a mesh / with multi-LoRA adapter routing is "
            "not ported yet (ROADMAP: parallel layer, model families)")
    B, T = tokens.shape
    x = _embed(params, tokens, cfg)                                # (B, T, D)
    pos = lengths[:, None] + torch.arange(T, device=lengths.device)[None, :]
    index = _append_index(caches[0], pos, page_table)
    for li, (layer, cache) in enumerate(zip(params["layers"], caches)):
        q, k, v = _attn_in(layer, x, pos, cfg, li)
        _chunk_append(cache, k, v, pos, page_table=page_table,
                      page_aligned=page_aligned, index=index)
        o = _chunk_cache_attend(q, cache, lengths, cfg,
                                page_table=page_table,
                                window=cfg.layer_window(li),
                                sinks=layer.get("sinks"))  # (B,T,H,Dh) f32
        x = _attn_out_and_mlp(layer, x, o.reshape(B, T, -1).to(x.dtype), cfg)
    return _logits(params, x, cfg), caches


def _accepted_prefix(match):
    """match (B, k) bool -> (B,) length of each row's all-true prefix."""
    return match.long().cumprod(dim=1).sum(dim=1)


def greedy_verdict(chunk, logits):
    """The greedy accept rule: chunk (B, k+1) = the committed token and k
    proposals, logits (B, k+1, V) the target's verify logits. Returns (n_acc
    (B,) proposals that equal the target's own greedy token, next (B,) int32
    the target's token after the accepted prefix)."""
    target_next = torch.argmax(logits, dim=-1)                   # (B, k+1)
    n_acc = _accepted_prefix(chunk[:, 1:] == target_next[:, :-1])
    nxt = torch.gather(target_next, 1, n_acc[:, None])[:, 0]
    return n_acc, nxt.to(torch.int32)


def _draft_propose(params_draft, cfg_d, caches_d, cur, lengths, k, cap,
                   sample=None):
    """k draft proposals after ``cur`` (B,), the draft cache advancing k + 1
    positions (the last step only appends the k-th proposal's K/V, which the
    next round needs when the whole chunk is accepted). ``sample(logits) ->
    (tokens, probs)`` draws from the warped draft distribution; None takes
    the argmax. Returns (chunk (B, k+1) int32, [probs (B, V)] * k). A
    position at or past ``cap`` (the cache capacity) is held at cap - 1: its
    proposals lie past what a request may grow to and are never served."""
    toks, probs = [cur], []
    tok = cur
    for i in range(k + 1):
        logits, caches_d = decode_step(
            params_draft, tok, caches_d, (lengths + i).clamp(max=cap - 1),
            cfg_d)
        if i == k:
            break
        if sample is None:
            tok = greedy(logits)
        else:
            tok, p_d = sample(logits)
            probs.append(p_d)
        toks.append(tok)
    return torch.stack(toks, dim=1), probs


def _prefill_pair(params_target, cfg_t, params_draft, cfg_d, prompts, max_seq,
                  dev):
    """Prefill target and draft over (B, S) prompts into fresh contiguous
    caches; returns (the target's last-position logits, caches_t,
    caches_d)."""
    B, S = prompts.shape
    caches_t = init_kv_caches(cfg_t, B, max_seq, device=dev)
    caches_d = init_kv_caches(cfg_d, B, max_seq, device=dev)
    logits_t, kvs = forward(params_target, prompts, cfg_t, return_kv=True)
    _insert_kvs(caches_t, kvs, 0)
    _, kvs_d = forward(params_draft, prompts, cfg_d, return_kv=True)
    _insert_kvs(caches_d, kvs_d, 0)
    return logits_t[:, S - 1], caches_t, caches_d


def _speculative_loop(params_target, cfg_t, params_draft, cfg_d, prompts,
                      max_new, k, max_seq, device, first, sample, verdict):
    """The loop both generators share: ``first(logits) -> cur`` picks the
    first token, ``sample`` is ``_draft_propose``'s, ``verdict(chunk, probs,
    logits) -> (n_acc, next)`` the accept rule. One host read per round."""
    dev = _serving_device(params_target, device)
    prompts = torch.as_tensor(prompts, device=dev)
    B, S = prompts.shape
    max_seq = max_seq or round_up(S + max_new + k, 1024)
    last, caches_t, caches_d = _prefill_pair(
        params_target, cfg_t, params_draft, cfg_d, prompts, max_seq, dev)
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    cur = first(last)
    cur_np = cur.cpu().numpy()

    out = np.zeros((B, max_new + k + 1), np.int32)
    n_out = np.zeros((B,), np.int64)
    accepted = proposed = 0
    while int(n_out.min()) < max_new:
        not_done = n_out < max_new
        out[not_done, n_out[not_done]] = cur_np[not_done]  # committed token
        n_out[not_done] += 1

        chunk, probs = _draft_propose(params_draft, cfg_d, caches_d, cur,
                                      lengths, k, max_seq, sample)
        logits, caches_t = decode_chunk(params_target, chunk, caches_t,
                                        lengths, cfg_t)
        n_acc, nxt = verdict(chunk, probs, logits)
        host = torch.cat([n_acc[:, None].to(torch.int32), chunk[:, 1:],
                          nxt[:, None]], dim=1).cpu().numpy()
        n_acc_np, props, nxt_np = host[:, 0], host[:, 1:k + 1], host[:, k + 1]
        accepted += int(n_acc_np[not_done].sum())
        proposed += int(not_done.sum()) * k
        for b in np.nonzero(not_done)[0]:
            n = int(n_acc_np[b])
            room = min(n, max_new + k - int(n_out[b]))
            out[b, n_out[b]:n_out[b] + room] = props[b, :room]
            n_out[b] += n
        # commit: lengths advance past cur and the accepted proposals (the
        # rejected suffix stays masked and is overwritten); finished rows
        # freeze
        live = torch.from_numpy(not_done).to(dev)
        cur = torch.where(live, nxt, cur)
        cur_np = np.where(not_done, nxt_np, cur_np)
        lengths = lengths + torch.where(live, 1 + n_acc, 0).to(torch.int32)
    tokens = torch.from_numpy(out[:, :max_new]).to(dev)
    return tokens, accepted / max(proposed, 1)


def speculative_generate(params_target, cfg_t: ModelConfig, params_draft,
                         cfg_d: ModelConfig, prompts, max_new: int,
                         k: int = 4, max_seq: int | None = None,
                         device="cuda"):
    """Greedy speculative decoding for a (B, S) prompt batch: the draft
    proposes k tokens per round and the target verifies them in one
    (k + 1)-token ``decode_chunk``. Returns (tokens (B, max_new) int32,
    acceptance rate); the tokens equal the target's own greedy decode."""
    return _speculative_loop(
        params_target, cfg_t, params_draft, cfg_d, prompts, max_new, k,
        max_seq, device, first=greedy, sample=None,
        verdict=lambda chunk, probs, logits: greedy_verdict(chunk, logits))


# --- stochastic speculative sampling ------------------------------------------
# Rejection scheme of Leviathan et al. and Chen et al.: accept draft token
# x ~ p_d with probability min(1, p_t(x) / p_d(x)); on rejection emit
# y ~ norm(max(p_t - p_d, 0)). The emitted marginal is exactly p_t per
# position.


def _draw(probs, generator):
    """One categorical draw per row of probs (B, V), as the JAX package
    draws from log(max(p, 1e-30))."""
    return torch.multinomial(torch.clamp(probs, min=1e-30), 1,
                             generator=generator)[:, 0].to(torch.int32)


def rejection_step(generator, x, p_d, p_t):
    """One position of speculative rejection sampling. x (B,) draft tokens
    drawn from p_d (B, V); p_t (B, V) the target's warped distribution at
    the same position. Returns (accept (B,) bool, replacement (B,) int32
    drawn from the normalised residual, meaningful only where ``accept`` is
    False). ``generator`` lies on the tensors' device."""
    idx = x.long()[:, None]
    pt_x = torch.gather(p_t, 1, idx)[:, 0]
    pd_x = torch.gather(p_d, 1, idx)[:, 0]
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                   device=x.device)
    accept = u * pd_x < pt_x          # u < p_t(x) / p_d(x), division-free
    resid = torch.clamp(p_t - p_d, min=0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    # p_t == p_d leaves no residual; any draw is already exact, use p_t
    resid = torch.where(mass > 0, resid / torch.clamp(mass, min=1e-30), p_t)
    return accept, _draw(resid, generator)


def speculative_verdict(generator, chunk, p_d_all, logits, warp):
    """The composite accept / replace rule, shared by the engine's
    speculative tick and the standalone generator. chunk (B, k+1) draft
    tokens (position 0 = the committed token); p_d_all (B, k, V) the draft
    distributions of positions 1..k; logits (B, k+1, V) the target's verify
    logits; ``warp`` the sampler's distribution transform. Returns (n_acc
    (B,) accepted-prefix lengths, next (B,) int32: the residual draw at the
    first rejection, or a bonus draw from p_t[k] on full accept)."""
    k = p_d_all.shape[1]
    p_t = torch.softmax(warp(logits), dim=-1)
    accs, reps = [], []
    for t in range(k):
        a, r = rejection_step(generator, chunk[:, t + 1], p_d_all[:, t],
                              p_t[:, t])
        accs.append(a)
        reps.append(r)
    n_acc = _accepted_prefix(torch.stack(accs, dim=1))
    bonus = _draw(p_t[:, k], generator)
    repl = torch.gather(torch.stack(reps, dim=1), 1,
                        n_acc.clamp(max=k - 1)[:, None])[:, 0]
    return n_acc, torch.where(n_acc == k, bonus, repl)


def draft_sampler(warp, generator):
    """sample(logits) -> (tokens (B,) int32, probs (B, V)): one draw from the
    warped draft distribution, which the rejection rule needs beside it."""
    def sample(logits):
        p_d = torch.softmax(warp(logits), dim=-1)
        return _draw(p_d, generator), p_d
    return sample


def speculative_sample_generate(params_target, cfg_t: ModelConfig,
                                params_draft, cfg_d: ModelConfig, prompts,
                                max_new: int, generator: torch.Generator,
                                k: int = 4, temperature: float = 1.0,
                                top_k: int | None = None,
                                top_p: float | None = None,
                                max_seq: int | None = None, device="cuda"):
    """Sampled speculative decoding for a (B, S) prompt batch. The
    per-position output distribution equals sampling the target directly
    under the same (temperature, top_k, top_p) warp: the draft changes when
    tokens are computed, not what distribution they come from. ``generator``
    (on the params' device) takes the place of the JAX key; the draws differ
    from JAX's, the rule does not. Returns (tokens (B, max_new) int32,
    acceptance rate). ``temperature <= 0`` is the greedy-exact path."""
    if temperature <= 0:
        return speculative_generate(params_target, cfg_t, params_draft, cfg_d,
                                    prompts, max_new, k=k, max_seq=max_seq,
                                    device=device)
    warp = make_warper(temperature, top_k, top_p)
    return _speculative_loop(
        params_target, cfg_t, params_draft, cfg_d, prompts, max_new, k,
        max_seq, device,
        first=lambda logits: _draw(torch.softmax(warp(logits), dim=-1),
                                   generator),
        sample=draft_sampler(warp, generator),
        verdict=lambda chunk, probs, logits: speculative_verdict(
            generator, chunk, torch.stack(probs, dim=1), logits, warp))
