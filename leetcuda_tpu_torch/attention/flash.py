"""Flash attention forward: plain and ragged (per-sequence lengths), with GQA.

Counterpart of ``leetcuda_tpu/attention/flash.py`` (``make_flash_attention``
and ``make_flash_attention_ragged``). Layouts are the JAX package's:
q (B, H, N, D), k/v (B, Hkv, N, D), lengths (B,) int32.

On CUDA tensors each wrapper launches the hand-written kernel in
``csrc/flash_fwd.cu`` (bf16, head dim 64, 128 or 256; TMA + wgmma, its
tiles and its walk over the band mirrored by ``fwd_plan``, ``key_range``
and ``fwd_edge`` here) and raises on what it does not take. On CPU tensors it runs the plain PyTorch version in this module,
which the tests hold against the JAX kernel and ``chip_smoke.py`` holds the
CUDA kernel against.

``with_lse=True`` also returns each query row's log-sum-exp (B, H, N) f32,
the residual of the backward (attention/flash_bwd.py); its launches count
on their own counter. ``window`` (Mistral's sliding window, Gemma 2's local
layers) keeps the causal band ``rows - cols < window`` and implies causal;
the kernel skips the key tiles left of the band, so its cost is
O(N * window). ``softcap`` (Gemma 2) passes each scaled score through
``cap * tanh(s / cap)`` before the mask. None or 0 means neither, as in the
JAX kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch

_NEG_INF = -1e30  # big-negative instead of -inf, as the TPU kernel masks

FLASH = LaunchCounter("flash_attention")
FLASH_RAGGED = LaunchCounter("flash_attention_ragged")
# either entry point with ``with_lse=True``: the forward of training
FLASH_LSE = LaunchCounter("flash_attention_lse")
# lc_flash_fwd_bf16(q, k, v, lengths, out, lse, B, H, Hkv, N, Nk, D, scale,
#                   causal, window, softcap, stream)
_FLASH_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6
               + (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  ctypes.c_void_p))
_PLAN_ARGS = (ctypes.c_int, ctypes.c_void_p)  # lc_flash_fwd_plan(D, info)
# the head dims csrc/flash_fwd.cu and csrc/flash_bwd.cu instantiate
HEAD_DIMS = (64, 128, 256)
# The forward's tile plan (csrc/flash_fwd.cu fwd_plan, the source's
# defaults): consumer warpgroups (64 q rows each), keys a stage, stages.
FWD_PLAN = {64: (2, 128, 3), 128: (2, 128, 2), 256: (2, 64, 2)}
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100


def cdiv(a, b):
    return -(-a // b)


def fwd_plan(D, B=1, H=1, Nq=1, plan=None):
    """What one forward launch at head dim ``D`` runs: its q rows, keys
    a stage, stages, threads, grid and shared-memory bytes (the byte count
    of csrc/flash_fwd.cu FwdTile). ``plan`` replaces the default (a
    variant build's (warpgroups, keys, stages))."""
    cons, keys, stages = plan or FWD_PLAN[D]
    rows = 64 * cons
    return {"rows": rows, "keys": keys, "stages": stages,
            "threads": 128 * cons, "grid": (cdiv(Nq, rows), B * H),
            "smem": 1024 + rows * D * 2 + stages * 2 * keys * D * 2
            + 8 * (1 + 2 * stages)}


def key_range(r0, r1, Nq, Nk, causal, window):
    """Keys [lo, hi) that q rows [r0, r1) keep ((0, 0): none): the key
    tiles the forward and the dQ kernel walk (csrc/common.cuh key_range).
    The forward passes its live rows as Nq and the keys below the length as
    Nk."""
    r1 = min(r1, Nq)
    if r1 <= r0:
        return 0, 0
    lo = max(r0 - window + 1, 0) if window > 0 else 0
    return lo, (min(Nk, r1) if causal else Nk)


def band_tiles(lo, hi, tile):
    """The tiles of ``tile`` rows or keys that cover [lo, hi)."""
    return range(lo // tile, cdiv(hi, tile) if hi > lo else lo // tile)


def fwd_edge(r0, k0, keys, kv_len, causal, window):
    """Whether the forward masks key tile [k0, k0 + keys) for the 64 q
    rows from r0: only where the tile crosses the keys below the length,
    the causal diagonal or the window's edge (csrc/flash_fwd.cu)."""
    return (k0 + keys > kv_len or (causal and k0 + keys - 1 > r0)
            or (window > 0 and r0 + 63 - k0 >= window))


def _aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (TMA
    needs it; a slice of a larger tensor may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_BUILD_PLANS: dict = {}


def build_plan(D, lib="flash_fwd"):
    """The plan ``lib`` (a source name or a variant build) was built
    with at head dim ``D`` (its ``lc_flash_fwd_plan``), as ``fwd_plan``
    takes it; the package's build must be FWD_PLAN's."""
    from leetcuda_tpu_torch.build import entry

    key = (lib if isinstance(lib, str) else id(lib), D)
    got = _BUILD_PLANS.get(key)
    if got is None:
        info = (ctypes.c_int * 4)()
        check_launch(entry(lib, "lc_flash_fwd_plan", _PLAN_ARGS)(
            D, ctypes.addressof(info)), FLASH.name)
        got = _BUILD_PLANS[key] = (info[0] // 64, info[1], info[2])
        if lib == "flash_fwd" and (got != FWD_PLAN[D] or info[3] != fwd_plan(
                D, plan=got)["smem"]):
            raise RuntimeError(f"csrc/flash_fwd.cu was built with plan "
                               f"{list(info)} at D={D}; the wrapper plans "
                               f"{FWD_PLAN[D]}")
    return got


def attn_options(window, softcap):
    """``window`` and ``softcap`` as the kernels take them: an int and a
    float, 0 for none (None and 0 both mean none, as JAX's ``if window:``
    and ``if softcap:``)."""
    window, softcap = int(window or 0), float(softcap or 0.0)
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must not be "
                         "negative")
    return window, softcap


def cap_scores(s, softcap):
    """``cap * tanh(s / cap)`` on scaled f32 scores (Gemma 2), or ``s``."""
    return softcap * torch.tanh(s / softcap) if softcap else s


def _check_qkv(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B,H,N,D), k/v (B,Hkv,N,D): got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"incompatible q {tuple(q.shape)} / k {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def band_mask(N, Nk, device, causal, window):
    """(N, Nk) keep mask: all, the causal ``rows >= cols``, or with a window
    also ``rows - cols < window``."""
    rows = torch.arange(N, device=device)[:, None]
    cols = torch.arange(Nk, device=device)[None, :]
    if not (causal or window):
        return torch.ones(N, Nk, dtype=torch.bool, device=device)
    keep = rows >= cols
    return keep & (rows - cols < window) if window else keep


def flash_attention_plain(q, k, v, *, causal=False, sm_scale=None,
                          lengths=None, with_lse=False, window=None,
                          softcap=None):
    """Plain PyTorch version of the kernel: f32 scores, capped with
    ``softcap``, -1e30 mask (the causal band with ``window``, which implies
    causal), P cast to v's dtype before P.V, divide by max(l, 1e-30); with
    ``lengths``, keys at or past the length are masked (their V rows
    zeroed, so NaN padding cannot leak) and query rows at or past it are
    zeros. ``with_lse``: also (B, H, N) f32 m + log(max(l, 1e-30)) of the
    capped scores, -1e30 on rows past a length."""
    window, softcap = attn_options(window, softcap)
    B, H, N, D = q.shape
    Hkv, Nk = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, group * N, D).float()
    s = torch.matmul(qg, k.float().transpose(-1, -2)) * scale
    s = cap_scores(s.reshape(B, Hkv, group, N, Nk), softcap)
    rows = torch.arange(N, device=q.device)[:, None]
    cols = torch.arange(Nk, device=q.device)[None, :]
    keep = band_mask(N, Nk, q.device, causal, window).expand(B, 1, 1, N, Nk)
    if lengths is not None:
        lens = lengths.to(q.device).long().view(B, 1, 1, 1, 1)
        keep = keep & (cols < lens)
        v = torch.where(
            torch.arange(Nk, device=q.device)[None, None, :, None]
            < lengths.to(q.device).long().view(B, 1, 1, 1), v,
            torch.zeros((), dtype=v.dtype, device=v.device))
    s = torch.where(keep, s, torch.full((), _NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float().reshape(B, Hkv, group * N, Nk),
                      v.float()).reshape(B, Hkv, group, N, D)
    out = pv / torch.clamp(l, min=1e-30)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    if lengths is not None:
        live = rows < lengths.to(q.device).long().view(B, 1, 1, 1, 1)
        out = torch.where(live, out, torch.zeros((), device=q.device))
        lse = torch.where(live, lse, torch.full((), _NEG_INF,
                                                device=q.device))
    out = out.reshape(B, H, N, D).to(q.dtype)
    if with_lse:
        return out, lse.reshape(B, H, N)
    return out


def _check_kernel_args(q, k, v, lengths=None):
    """Raise on what csrc/flash_fwd.cu does not take: contiguous bf16
    q, k, v, a head dim of HEAD_DIMS, B * H within the grid, and a
    contiguous (B,) int32 ``lengths`` on q's device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash kernel takes contiguous bf16 tensors; "
                             f"{name} is {t.dtype}, contiguous="
                             f"{t.is_contiguous()}")
    B, H, N, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {D} not in {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"flash kernel: B*H={B * H} exceeds the grid")
    if lengths is not None:
        if (lengths.device != q.device or lengths.dtype != torch.int32
                or lengths.shape != (B,) or not lengths.is_contiguous()):
            raise ValueError("lengths must be a contiguous (B,) int32 tensor "
                             "on q's device")


def _launch(q, k, v, lengths, causal, scale, counter, with_lse, window,
            softcap, lib="flash_fwd"):
    """Launch csrc/flash_fwd.cu (or the variant build ``lib``) on the
    current stream; ``with_lse``: also write the (B, H, N) f32 lse and
    count on FLASH_LSE."""
    from leetcuda_tpu_torch.build import entry

    _check_kernel_args(q, k, v, lengths)
    B, H, N, D = q.shape
    Hkv, Nk = k.shape[1], k.shape[2]
    build_plan(D, lib)
    q, k, v = map(_aligned, (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, N), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if with_lse:
        counter = FLASH_LSE
    fn = entry(lib, "lc_flash_fwd_bf16", _FLASH_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if lengths is None else lengths.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             B, H, Hkv, N, Nk, D, float(scale), int(causal), int(window),
             float(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, counter.name)
    counter.add()
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, *, causal=False, sm_scale=None, window=None,
                    softcap=None, with_lse=False):
    """(B, H, N, D) attention with GQA (k/v may have fewer heads);
    ``with_lse``: (out, lse (B, H, N) f32). ``window`` implies causal."""
    window, softcap = attn_options(window, softcap)
    _check_qkv(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[3])
    causal = causal or bool(window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=scale,
                                     with_lse=with_lse, window=window,
                                     softcap=softcap)
    return _launch(q, k, v, None, causal, scale, FLASH, with_lse, window,
                   softcap)


def flash_attention_ragged(q, k, v, lengths, *, sm_scale=None, window=None,
                           softcap=None, with_lse=False):
    """Causal attention with per-sequence valid lengths (B,): keys at or
    past lengths[b] are neither attended nor read, and query rows at or past
    it are written as zeros (their lse, with ``with_lse``, as -1e30). The
    batched-prefill primitive."""
    window, softcap = attn_options(window, softcap)
    _check_qkv(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=True, sm_scale=scale,
                                     lengths=lengths, with_lse=with_lse,
                                     window=window, softcap=softcap)
    return _launch(q, k, v, lengths, True, scale, FLASH_RAGGED, with_lse,
                   window, softcap)
