"""Mixture-of-Experts FFN in PyTorch: capacity and dropless top-k routing.

Counterpart of ``leetcuda_tpu/models/moe.py``. Parameters are a dict
{"router" (D, E) f32, "w_gate" (E, D, F), "w_up" (E, D, F), "w_down"
(E, F, D)}, the JAX keys, the experts in the model's dtype.

- ``moe_ffn``: GShard / Switch capacity routing. Every expert takes
  C = ``cfg.capacity(T)`` token slots and overflow tokens drop; dispatch
  and combine are one-hot einsums. It trains through autograd.
- ``moe_ffn_dropless``: every token reaches its top-k experts. Token copies
  are sorted by expert into a zero-padded buffer whose group boundaries are
  aligned to ``block_m``, and the three FFN products run on the grouped
  matmul (gemm/grouped.py, the ``csrc/gmm.cu`` kernel on the card). Every
  shape is static and nothing is read back to the host: the buffer has
  ceil(T k / block_m) block_m + E block_m rows, whatever the routing. The
  gmm has no backward, so this path serves only.

Top-k takes the lower expert id first among equal probabilities, as
``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` promises
no order on CUDA). The dropless combine sums each token's k weighted copies
in f32 in a fixed order (its copies gathered by a stable sort, then one
sum over k), so a call gives the same bits every time; JAX's scatter-add
sums them in another order, so results agree with JAX's to f32 rounding,
not bit for bit.

Expert parallelism (``moe_shardings``, ``shard_moe_params``) needs the
sharded runtime over a mesh (``parallel/mesh.py`` has the mesh), which the
port lacks (ROADMAP item 12b).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from leetcuda_tpu_torch.core.runtime import cdiv, resolve_device
from leetcuda_tpu_torch.gemm.grouped import make_gmm, tile_groups_from_sizes


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    topk: int = 2
    capacity_factor: float = 1.25
    dim: int = 256
    ffn_dim: int = 512
    dtype: torch.dtype = torch.float32
    # Mixtral / Qwen3-MoE: the selected top-k gates renormalize to sum 1
    renorm_topk: bool = False

    def capacity(self, n_tokens: int) -> int:
        """Slots per expert, rounded up to a multiple of 8 as JAX rounds
        them (a TPU sublane habit, kept: it decides which tokens drop)."""
        c = math.ceil(n_tokens * self.topk * self.capacity_factor
                      / self.n_experts)
        return max(8, -(-c // 8) * 8)


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    device="cuda"):
    """Random expert weights drawn from ``generator`` (on its device, then
    moved to ``device``): normals over sqrt(fan-in), the router in f32
    whatever ``cfg.dtype``."""
    dev = resolve_device(device)
    E, D, F_ = cfg.n_experts, cfg.dim, cfg.ffn_dim

    def dense(fan_in, shape, dtype):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) / math.sqrt(fan_in)
        return w.to(device=dev, dtype=dtype)

    return {"router": dense(D, (D, E), torch.float32),
            "w_gate": dense(D, (E, D, F_), cfg.dtype),
            "w_up": dense(D, (E, D, F_), cfg.dtype),
            "w_down": dense(F_, (E, F_, D), cfg.dtype)}


def moe_shardings():
    raise NotImplementedError(
        "moe_shardings: expert parallelism needs the sharded runtime over "
        "a mesh, which the port lacks (ROADMAP item 12b)")


def shard_moe_params(params, mesh):
    raise NotImplementedError(
        "shard_moe_params: expert parallelism needs the sharded runtime "
        "over a mesh, which the port lacks (ROADMAP item 12b)")


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last dim, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_probs(xf, params):
    return torch.softmax(xf.float() @ params["router"], dim=-1)


def _routing(logits, cfg: MoEConfig, capacity: int):
    """Top-k capacity routing. logits (T, E) f32 -> dispatch (T, E, C)
    0 / 1 and combine (T, E, C) gate weights, both f32. Round r's tokens take
    the slots after the earlier rounds', in token order; a token past the
    capacity drops from that expert."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    dispatch = torch.zeros((T, E, capacity), dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    gsum = torch.zeros((T,), dtype=torch.float32, device=logits.device)
    masked = probs
    for _ in range(cfg.topk):
        idx = torch.argmax(masked, dim=-1)                  # (T,)
        gate = probs.gather(-1, idx[:, None])[:, 0]
        onehot = F.one_hot(idx, E).float()                  # (T, E)
        taken = dispatch.sum(dim=(0, 2))                    # (E,) slots used
        rank = torch.cumsum(onehot, dim=0) - onehot         # earlier same-e
        pos = (rank + taken[None, :]) * onehot
        within = (pos < capacity) & (onehot > 0)
        pos_oh = F.one_hot(pos.long().clamp(max=capacity - 1),
                           capacity).float()                # (T, E, C)
        sel = within.float()[..., None] * pos_oh
        dispatch = dispatch + sel
        combine = combine + gate[:, None, None] * sel
        gsum = gsum + gate  # selected gates (capacity drops still count)
        masked = masked * (1.0 - onehot)
    if cfg.renorm_topk:
        combine = combine / gsum[:, None, None]
    return dispatch, combine


def moe_ffn(x, params, cfg: MoEConfig):
    """Capacity MoE SwiGLU FFN. x (..., T, D) -> (..., T, D), the leading
    dims flattened into T; dispatch and combine are one-hot einsums."""
    lead, D = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, D)
    C = cfg.capacity(xf.shape[0])
    logits = xf.float() @ params["router"]
    dispatch, combine = _routing(logits, cfg, C)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xf)
    gate = F.silu(torch.einsum("ecd,edf->ecf", expert_in,
                               params["w_gate"]).float())
    up = torch.einsum("ecd,edf->ecf", expert_in, params["w_up"]).float()
    h = (gate * up).to(x.dtype)
    expert_out = torch.einsum("ecf,efd->ecd", h, params["w_down"])
    out = torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
    return out.reshape(*lead, D)


def dropless_dispatch(xf, params, cfg: MoEConfig, block_m: int = 128):
    """Route the tokens xf (T, D) to their top-k experts and lay out the
    grouped matmul's input: the copies, sorted by expert (stable), land at
    ``pos`` in a zero buffer of T_buf = ceil(T k / block_m) block_m
    + E block_m rows, each expert's group starting on a block_m boundary;
    the tiles past the last group take expert E - 1 and hold zeros.
    Returns (buf (T_buf, D), tile_group (T_buf / block_m,) int32, pos
    (T k,), the token of each sorted copy (T k,), its gate weight (T k,)
    f32)."""
    E, k = cfg.n_experts, cfg.topk
    T, dev = xf.shape[0], xf.device
    gate_w, expert_id = _top_k(_router_probs(xf, params), k)  # (T, k)
    if cfg.renorm_topk:
        gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    e_flat = expert_id.reshape(-1)                             # (T k,)
    token_of_copy = torch.arange(T, device=dev).repeat_interleave(k)

    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    padded = (counts + block_m - 1) // block_m * block_m
    off_pad = torch.cumsum(padded, dim=0) - padded
    off_raw = torch.cumsum(counts, dim=0) - counts

    order = torch.argsort(e_flat, stable=True)      # copies sorted by expert
    e_sorted = e_flat[order]
    pos = off_pad[e_sorted] + (torch.arange(T * k, device=dev)
                               - off_raw[e_sorted])
    src = token_of_copy[order]

    T_buf = cdiv(T * k, block_m) * block_m + E * block_m
    buf = torch.zeros((T_buf, xf.shape[1]), dtype=xf.dtype,
                      device=dev).index_copy_(0, pos, xf[src])
    tile_group = tile_groups_from_sizes(padded, block_m,
                                        T_buf // block_m).clamp_(max=E - 1)
    return buf, tile_group, pos, src, gate_w.reshape(-1)[order].float()


def moe_ffn_dropless(x, params, cfg: MoEConfig, block_m: int = 128):
    """Dropless MoE through the grouped matmul: x (..., T, D) -> (..., T, D).
    gate and up are two gmm calls over ``dropless_dispatch``'s buffer, down
    a third, and each token's k copies, weighted by their gates, sum back
    in f32."""
    lead, D = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, D)
    buf, tile_group, pos, src, w_sorted = dropless_dispatch(
        xf, params, cfg, block_m)
    gmm = make_gmm(block=(block_m, 2048, 2048))
    gate = F.silu(gmm(buf, params["w_gate"], tile_group).float())
    up = gmm(buf, params["w_up"], tile_group).float()
    down = gmm((gate * up).to(x.dtype), params["w_down"], tile_group)
    contrib = down[pos].float() * w_sorted[:, None]
    # every token has k copies: grouped by token (a stable sort keeps them
    # in expert order) and summed over k in a fixed order, where index_add_
    # would sum them with float atomics, in another order on every call
    by_token = torch.argsort(src, stable=True)
    out = contrib[by_token].view(xf.shape[0], cfg.topk, D).sum(dim=1)
    return out.to(x.dtype).reshape(*lead, D)


def moe_ffn_dropless_ref(x, params, cfg: MoEConfig):
    """Dense oracle: every token through every expert, each weighted by its
    gate where the expert is among the token's top k."""
    lead, D = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, D)
    gate_w, topi = _top_k(_router_probs(xf, params), cfg.topk)
    if cfg.renorm_topk:
        gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    out = torch.zeros((xf.shape[0], D), dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        g = F.silu((xf @ params["w_gate"][e]).float())
        u = (xf @ params["w_up"][e]).float()
        y = ((g * u).to(x.dtype) @ params["w_down"][e]).float()
        for r in range(cfg.topk):
            w = torch.where(topi[:, r] == e, gate_w[:, r], 0.0)
            out = out + w[:, None] * y
    return out.to(x.dtype).reshape(*lead, D)


def moe_ffn_ref(x, params, cfg: MoEConfig):
    """Dense oracle of ``moe_ffn``: every token through its top-k experts by
    loop, with the capacity bookkeeping of ``_routing`` (first come, first
    served in each round)."""
    lead, D = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, D)
    probs = _router_probs(xf, params)
    topg, topi = _top_k(probs, cfg.topk)
    if cfg.renorm_topk:
        probs = probs / topg.sum(dim=-1, keepdim=True)

    def expert(e, v):
        g = F.silu((v @ params["w_gate"][e]).float())
        u = (v @ params["w_up"][e]).float()
        return (g * u).to(v.dtype) @ params["w_down"][e]

    out = torch.zeros_like(xf)
    C = cfg.capacity(xf.shape[0])
    for r in range(cfg.topk):
        idx = topi[:, r]
        gate = probs.gather(-1, idx[:, None])[:, 0]
        for e in range(cfg.n_experts):
            mask = idx == e
            prior = sum(int((topi[:, rr] == e).sum()) for rr in range(r))
            rank = torch.cumsum(mask.long(), dim=0) - mask.long()
            keep = mask & (rank + prior < C)
            y = expert(e, xf)
            out = out + torch.where(keep[:, None],
                                    gate[:, None].to(x.dtype) * y, 0)
    return out.reshape(*lead, D)
