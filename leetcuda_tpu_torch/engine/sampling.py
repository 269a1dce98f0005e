"""Token samplers for the engine: greedy, temperature, top-k, top-p.

Counterpart of ``leetcuda_tpu/engine/sampling.py``. Every sampler has the
signature ``sample(logits, generator) -> tokens`` (logits (..., V) f32;
``generator`` a ``torch.Generator`` on the logits' device, ignored by
greedy). The draws differ from JAX's for the same seed; the warped
distributions are the same.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def greedy(logits, generator=None):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_warper(temperature: float = 1.0, top_k: int | None = None,
                top_p: float | None = None):
    """Build warp(logits) -> filtered and scaled logits: the distribution
    transform of make_sampler without the draw."""
    if temperature <= 0:
        raise ValueError("warper is for stochastic sampling (temperature > 0)")

    def warp(logits):
        x = logits.float() / temperature
        neg = torch.full((), _NEG_INF, device=x.device)
        if top_k is not None:
            kth = torch.sort(x, dim=-1).values[..., -top_k][..., None]
            x = torch.where(x < kth, neg, x)
        if top_p is not None:
            sorted_x = torch.sort(x, dim=-1, descending=True).values
            probs = torch.softmax(sorted_x, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            # keep tokens whose exclusive prefix mass is < top_p; the first
            # token always survives
            keep_sorted = (cum - probs) < top_p
            cutoff = torch.where(keep_sorted, sorted_x,
                                 torch.full((), float("inf"), device=x.device)
                                 ).amin(dim=-1, keepdim=True)
            x = torch.where(x < cutoff, neg, x)
        return x

    return warp


def make_sampler(temperature: float = 1.0, top_k: int | None = None,
                 top_p: float | None = None):
    """Build sample(logits, generator). temperature <= 0 is greedy."""
    if temperature <= 0:
        return greedy
    warp = make_warper(temperature, top_k, top_p)

    def sample(logits, generator):
        probs = torch.softmax(warp(logits), dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        tok = torch.multinomial(flat, 1, generator=generator)
        return tok.reshape(probs.shape[:-1]).to(torch.int32)

    sample.warp = warp
    return sample
