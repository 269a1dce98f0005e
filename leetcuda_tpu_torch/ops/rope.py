"""Model-level RoPE in plain PyTorch.

Counterpart of the jnp functions of ``leetcuda_tpu/ops/rope.py``
(``_rope_angles``, ``apply_rope_half``, ``llama3_scaled_inv_freq``,
``yarn_scaled_inv_freq``). The model path never reached the Pallas RoPE
kernels there (``make_rope``, ``make_rope_lane``); those stay in ROADMAP's
kernel queue.
"""

from __future__ import annotations

import math

import torch

DEFAULT_THETA = 10000.0


def _plain_inv_freq(half: int, theta: float, device=None):
    return theta ** (-torch.arange(half, dtype=torch.float32, device=device)
                     / half)


def _rope_angles(positions, D, theta, inv_freq=None):
    """(cos, sin) of pos * theta^(-2i/D), shaped (..., S, 1, half) to
    broadcast over a heads axis. ``inv_freq`` (half,) overrides the plain
    power ladder (rope scaling)."""
    half = D // 2
    if inv_freq is None:
        inv_freq = _plain_inv_freq(half, theta, positions.device)
    ang = positions.float()[..., None] * inv_freq.to(positions.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def llama3_scaled_inv_freq(D: int, theta: float, factor: float,
                           low_freq_factor: float, high_freq_factor: float,
                           original_max_pos: int):
    """Llama-3.1 rope scaling (HF _compute_llama3_parameters semantics):
    long wavelengths divide by ``factor``, short ones stay, the middle band
    interpolates. Returns (D/2,) f32."""
    inv_freq = _plain_inv_freq(D // 2, theta)
    wavelen = 2.0 * math.pi / inv_freq
    low_wl = original_max_pos / low_freq_factor
    high_wl = original_max_pos / high_freq_factor
    smooth = ((original_max_pos / wavelen - low_freq_factor)
              / (high_freq_factor - low_freq_factor))
    mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    return torch.where(wavelen > low_wl, inv_freq / factor,
                       torch.where(wavelen < high_wl, inv_freq, mid))


def yarn_scaled_inv_freq(D: int, theta: float, factor: float,
                         beta_fast: float, beta_slow: float,
                         original_max_pos: int, truncate: bool = True,
                         attention_factor: float | None = None):
    """YaRN (NTK-by-parts) scaling, HF _compute_yarn_parameters semantics.
    Returns ((D/2,) f32 inv_freq, attention_factor)."""
    half = D // 2
    pos_freqs = theta ** (torch.arange(0, D, 2, dtype=torch.float32) / D)
    inv_extra = 1.0 / pos_freqs
    inv_inter = 1.0 / (factor * pos_freqs)

    def corr_dim(n_rot):
        return (D * math.log(original_max_pos / (n_rot * 2 * math.pi))
                / (2 * math.log(theta)))

    low, high = corr_dim(beta_fast), corr_dim(beta_slow)
    if truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, D - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(half, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    extra_w = 1.0 - ramp
    inv_freq = inv_inter * (1.0 - extra_w) + inv_extra * extra_w
    if attention_factor is None:
        attention_factor = 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0
    return inv_freq, float(attention_factor)


def apply_rope_half(x, positions, theta: float = DEFAULT_THETA,
                    inv_freq=None, mscale: float = 1.0):
    """Half-rotation RoPE: x (..., S, H, D), positions (..., S). The first
    D/2 lanes pair with the last D/2 (rotate_half). Computed in f32 and cast
    back to x's dtype."""
    D = x.shape[-1]
    half = D // 2
    c, s = _rope_angles(positions, D, theta, inv_freq)
    if mscale != 1.0:
        c, s = c * mscale, s * mscale
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
