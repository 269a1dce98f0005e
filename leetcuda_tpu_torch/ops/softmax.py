"""Row softmax of (S, K) in f32, the output in x's dtype, in three forms:

1. ``make_softmax`` (naive): exp(x) / sum exp(x) with no max subtracted. It
   overflows where x > 88 (inf / inf = NaN) by design, as the JAX kernel does.
2. ``make_safe_softmax``: the row max subtracted first.
3. ``make_online_softmax``: one pass of running (max, denominator) pairs
   merged by m' = max(m, m_b), d' = d e^(m - m') + d_b e^(m_b - m'), then a
   write pass.

Counterpart of ``leetcuda_tpu/ops/softmax.py`` (factories, registrations,
``softmax``, ``online_softmax``). On CUDA tensors every form launches
``lc_softmax`` of ``csrc/row_ops.cu`` with its mode and returns a new
tensor; on CPU tensors it runs its plain version. ``rows_per_step`` and the
online form's ``chunk`` (the TPU kernel's column chunk) are the TPU's tiling
and are accepted and ignored.
"""

from __future__ import annotations

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter
from leetcuda_tpu_torch.ops import rowwise as rw

SOFTMAX = LaunchCounter("softmax")
NAIVE, SAFE, ONLINE = 0, 1, 2


def naive_softmax_plain(x):
    e = torch.exp(x.float())
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def safe_softmax_plain(x):
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def online_softmax_plain(x):
    """The online form's arithmetic over the whole row: the (m, d) pair,
    then exp(x - m) * (1 / d)."""
    xf = x.float()
    m = xf.amax(dim=-1, keepdim=True)
    d = torch.exp(xf - m).sum(dim=-1, keepdim=True)
    return (torch.exp(xf - m) * (1.0 / d)).to(x.dtype)


PLAIN = {NAIVE: naive_softmax_plain, SAFE: safe_softmax_plain,
         ONLINE: online_softmax_plain}


def _launch(x, mode, vec, pack):
    rw.check_kernel_operands("softmax", x)
    S, K = x.shape
    out = torch.empty_like(x)
    if x.numel():
        rw.launch(SOFTMAX, "lc_softmax", rw.SOFTMAX_ARGS, x.device,
                  x.data_ptr(), out.data_ptr(), S, K, rw.DTYPES[x.dtype], vec,
                  rw.load_bytes(vec, pack, x.element_size()), mode,
                  rw.threads_for(K, vec))
    return out


def _make_rowwise(mode, *, vec: int = 1, pack: bool = False):
    def fn(x):
        rw.check_rows("softmax", x)
        if x.device.type == "cpu":
            return PLAIN[mode](x)
        return _launch(x, mode, vec, pack)

    fn.mode = mode
    return fn


def make_softmax(*, rows_per_step: int = 8, vec: int = 1, pack: bool = False):
    return _make_rowwise(NAIVE, vec=vec, pack=pack)


def make_safe_softmax(*, rows_per_step: int = 8, vec: int = 1,
                      pack: bool = False):
    return _make_rowwise(SAFE, vec=vec, pack=pack)


def make_online_softmax(*, rows_per_step: int = 8, chunk: int = 128,
                        vec: int = 1, pack: bool = False):
    return _make_rowwise(ONLINE, vec=vec, pack=pack)


def _softmax_ref(x):
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def _softmax_flops(x):
    return float(5 * x.numel())


def _softmax_bytes(x):
    return float(2 * x.numel() * x.element_size())


_COMMON = dict(ref=_softmax_ref, flops=_softmax_flops, bytes=_softmax_bytes,
               family="softmax")

for _suffix in ("f32", "f32x4"):
    register_op(f"softmax_{_suffix}_per_token", atol=1e-4, rtol=1e-4,
                tags=("naive", _suffix), **_COMMON)(
        make_softmax(**rw.rung(_suffix)))
    register_op(f"safe_softmax_{_suffix}_per_token", atol=1e-5, rtol=1e-5,
                tags=("safe", _suffix), **_COMMON)(
        make_safe_softmax(**rw.rung(_suffix)))

for _suffix, _atol in [("f16_f32", 1e-2), ("f16x2_f32", 1e-2),
                       ("f16x8_pack_f32", 1e-2)]:
    register_op(f"safe_softmax_{_suffix}_per_token", atol=_atol, rtol=1e-2,
                tags=("safe", _suffix), **_COMMON)(
        make_safe_softmax(**rw.rung(_suffix)))

register_op("online_safe_softmax_f32", atol=1e-5, rtol=1e-5,
            tags=("online", "f32"), **_COMMON)(make_online_softmax())
register_op("online_safe_softmax_f32x4_pack", atol=1e-5, rtol=1e-5,
            tags=("online", "f32x4"), **_COMMON)(
    make_online_softmax(**rw.rung("f32x4_pack")))

softmax = make_safe_softmax(rows_per_step=256, vec=8, pack=True)
online_softmax = make_online_softmax(rows_per_step=256, vec=8, pack=True)
