"""RoPE: the op corpus's interleaved-pair kernel and the model-level
rotations.

Counterpart of ``leetcuda_tpu/ops/rope.py``: ``make_rope``,
``make_rope_lane``, ``rope_ref`` and the 3 registrations, and the jnp
functions (``_rope_angles``, ``apply_rope_half``, ``apply_rope_interleaved``,
``apply_rope_glm``, ``llama3_scaled_inv_freq``, ``yarn_scaled_inv_freq``) in
plain PyTorch.

``make_rope`` and ``make_rope_lane`` compute one function, interleaved
pairs on (S, D) with position = row, in f32 and cast to x's dtype. On CUDA
tensors they launch ``lc_rope`` of ``csrc/rope.cu`` out of place; on CPU
tensors they run ``rope_plain``. The kernel reads the (D / 2,) frequency
table that the wrapper builds once per width and device with the plain
version's formula, so that position times frequency is the same f32
product on both sides (the Pallas kernels' exp(i * -ln(theta) / half)
drifts from it by 1e-4 at position 2048). A rung is the pairs a thread
rotates: ``make_rope`` 1 (``f32``) or 2 (``f32_v2``), element by element;
``make_rope_lane`` 2 in one 4-element word (``f32x4_pack``).
``rows_per_step`` is the TPU's tiling and is accepted and ignored. The model path (``apply_rope_half``) stays plain PyTorch, as
the JAX model's does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch

DEFAULT_THETA = 10000.0
ROPE = LaunchCounter("rope")
ROPE_LANE = LaunchCounter("rope_lane")
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# lc_rope(x, inv_freq, out, S, D, dtype, pairs, pack, stream)
_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) + (ctypes.c_int,) * 4 \
    + (ctypes.c_void_p,)


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


def apply_rope_interleaved(x, positions, theta: float = DEFAULT_THETA):
    """Interleaved-pair RoPE for models: x (..., S, H, D), positions
    (..., S). Lane pairs (2i, 2i+1) rotate by pos * theta^(-2i/D) (the
    DeepSeek / complex convention), in f32, cast back to x's dtype."""
    D = x.shape[-1]
    half = D // 2
    c, s = _rope_angles(positions, D, theta)
    xf = x.float().reshape(*x.shape[:-1], half, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_rope_glm(x, positions, theta: float, rotary_dim: int):
    """GLM-4 partial rotary: interleaved pairs (2i, 2i+1) rotate by
    pos * theta^(-2i/rotary_dim) on the first ``rotary_dim`` lanes only, in
    f32 cast back to x's dtype; the other lanes pass through. x (..., S, H,
    D), positions (..., S)."""
    half = rotary_dim // 2
    ang = (positions.float()[..., None]
           * _plain_inv_freq(half, theta, positions.device))
    c, s = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr = x[..., :rotary_dim].float().reshape(*x.shape[:-1], half, 2)
    x1, x2 = xr[..., 0], xr[..., 1]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    out = out.reshape(*x.shape[:-1], rotary_dim).to(x.dtype)
    return torch.cat([out, x[..., rotary_dim:]], dim=-1)


# --- the op corpus's kernel --------------------------------------------------

def rope_plain(x, theta: float = DEFAULT_THETA):
    """Interleaved RoPE of x (S, D), position = row, in f32 (JAX's
    ``rope_ref``)."""
    S, D = x.shape
    half = D // 2
    xf = x.float().reshape(S, half, 2)
    pos = torch.arange(S, dtype=torch.float32, device=x.device)[:, None]
    ang = pos * _plain_inv_freq(half, theta, x.device)
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = xf[..., 0], xf[..., 1]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(S, D).to(x.dtype)


rope_ref = rope_plain


def _make(counter, theta, pairs, pack):
    freqs = {}  # (half, device) -> the (half,) f32 frequency table

    def fn(x):
        if x.dim() != 2 or x.shape[1] % 2:
            raise ValueError(f"rope takes (S, D) with D even, got "
                             f"{tuple(x.shape)}")
        if x.device.type == "cpu":
            return rope_plain(x, theta)
        from leetcuda_tpu_torch.build import kernel

        if x.dtype not in _DTYPES or not x.is_contiguous():
            raise ValueError("rope kernel: x must be contiguous f32, f16 or "
                             "bf16")
        S, D = x.shape
        out = torch.empty_like(x)
        if x.numel() == 0:
            return out
        key = (D // 2, x.device)
        if key not in freqs:
            freqs[key] = _plain_inv_freq(D // 2, theta, x.device)
        err = kernel("rope", "lc_rope", _ARGS)(
            x.data_ptr(), freqs[key].data_ptr(), out.data_ptr(), S, D,
            _DTYPES[x.dtype], pairs, int(pack),
            torch.cuda.current_stream(x.device).cuda_stream)
        check_launch(err, counter.name)
        counter.add()
        return out

    return fn


def make_rope(*, theta: float = DEFAULT_THETA, rows_per_step: int = 8,
              pairs: int = 1):
    """rope(x): x (S, D) with interleaved pairs, position = row index;
    ``pairs`` (1 or 2) a thread rotates."""
    if pairs not in (1, 2):
        raise ValueError(f"pairs must be 1 or 2, got {pairs}")
    return _make(ROPE, theta, pairs, False)


def make_rope_lane(*, theta: float = DEFAULT_THETA,
                   rows_per_step: int = 1024):
    """The same function, JAX's native-lane factory (its top rung)."""
    return _make(ROPE_LANE, theta, 2, True)


def _rope_flops(x):
    return float(6 * x.numel())


def _rope_bytes(x):
    return float(2 * x.numel() * x.element_size())


for _suffix, _rows, _pairs in [("f32", 8, 1), ("f32_v2", 512, 2)]:
    register_op(
        f"rope_{_suffix}",
        ref=rope_ref, flops=_rope_flops, bytes=_rope_bytes,
        atol=1e-4, rtol=1e-4, family="rope", tags=(_suffix,),
    )(make_rope(rows_per_step=_rows, pairs=_pairs))

register_op(
    "rope_f32x4_pack",
    ref=rope_ref, flops=_rope_flops, bytes=_rope_bytes,
    atol=1e-4, rtol=1e-4, family="rope", tags=("f32x4_pack", "lane"),
)(make_rope_lane(rows_per_step=2048))

rope = make_rope_lane(rows_per_step=2048)
