"""Decode (single-token) attention over a contiguous KV cache, with GQA.

Counterpart of ``leetcuda_tpu/attention/decode.py`` (``make_decode_attention``).
q (B, H, D); caches (B, Hkv, S_max, D); lengths (B,) int32 = valid positions
per sequence (the current token's K/V already appended). Positions at or
past a length may hold anything, NaN included.

On CUDA tensors the wrapper launches ``csrc/decode_attn.cu`` (bf16, head dim
64 or 128, GQA group 1/2/4/8) and raises on what it does not take. On CPU
tensors it runs the plain PyTorch version below.

``window``, ``softcap`` and ``with_lse`` are not ported yet and raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch

_NEG_INF = -1e30

DECODE = LaunchCounter("decode_attention")


def decode_attention_plain(q, k_cache, v_cache, lengths, *, sm_scale=None):
    """Plain PyTorch version of the kernel: f32 scores and P.V, -1e30 mask,
    divide by max(l, 1e-30). Both P and V are zeroed past the length, as the
    TPU kernel does, so NaN padding cannot reach the result."""
    B, H, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    group = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])          # (B, S)
    vmask = valid[:, None, :, None]
    zero = torch.zeros((), device=q.device)
    kf = torch.where(vmask, k_cache.float(), zero)
    vf = torch.where(vmask, v_cache.float(), zero)
    qg = q.float().reshape(B, Hkv, group, D)
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale        # (B, Hkv, G, S)
    keep = valid[:, None, None, :]
    s = torch.where(keep, s, torch.full((), _NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), zero)
    out = torch.matmul(p, vf) / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, *, sm_scale=None,
                     window=None, softcap=None, with_lse=False):
    """decode_attention(q, k_cache, v_cache, lengths) -> (B, H, D)."""
    if window is not None or softcap is not None or with_lse:
        raise NotImplementedError(
            "decode attention: window / softcap / with_lse are not ported "
            "yet (ROADMAP: kernel options of decode attention)")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q (B,H,D), caches (B,Hkv,S,D): got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D or H % Hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} / cache "
                         f"{tuple(k_cache.shape)}")
    if not (q.device == k_cache.device == v_cache.device == lengths.device):
        raise ValueError("q, caches and lengths must lie on one device")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      sm_scale=scale)

    from leetcuda_tpu_torch.build import load

    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"decode kernel takes contiguous bf16 tensors; "
                             f"{name} is {t.dtype}, contiguous="
                             f"{t.is_contiguous()}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (B,) int32 tensor")
    if D not in (64, 128) or H // Hkv not in (1, 2, 4, 8) or B > 65535:
        raise ValueError(f"decode kernel: head dim {D} (64/128), GQA group "
                         f"{H // Hkv} (1/2/4/8), batch {B} (<= 65535)")
    out = torch.empty_like(q)
    fn = load("decode_attn").lc_decode_attn_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), B, H, Hkv, S, D,
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, DECODE.name)
    DECODE.add()
    return out
