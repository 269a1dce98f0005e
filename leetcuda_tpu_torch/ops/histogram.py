"""Histogram: int32 counts of the int32 values of (S, K) over ``num_bins``
bins.

Counterpart of ``leetcuda_tpu/ops/histogram.py`` (``make_histogram``,
``BINS``, the 2 registrations, ``histogram = make_histogram``). On CUDA
tensors the wrappers launch ``lc_histogram`` of ``csrc/histogram.cu``
(which zeroes its output itself); on CPU tensors they run
``histogram_plain``. Values outside [0, num_bins) are dropped, as the
Pallas kernel drops them (its one-hot compare never matches). The registry
oracle is JAX's ``bincount``, here ``torch.bincount``, which agrees only
for values in range (JAX's clamps a negative value into bin 0, and
``torch.bincount`` refuses one).

``block`` is the TPU's tiling and is accepted and ignored; the rung is the
values a thread takes a step: 1 (``i32``) or 4 in one 16-byte load
(``i32x4``).
"""

from __future__ import annotations

import ctypes

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter
from leetcuda_tpu_torch.ops import flat
from leetcuda_tpu_torch.ops import rowwise as rw

HISTOGRAM = LaunchCounter("histogram")
# lc_histogram(x, n, bins, out, vec, stream)
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGS = (_P, ctypes.c_longlong, _I, _P, _I, _P)


def histogram_plain(x, num_bins: int):
    """Counts of x's values in [0, num_bins), int32; the rest dropped."""
    v = x.reshape(-1)
    v = v[(v >= 0) & (v < num_bins)]
    return torch.bincount(v, minlength=num_bins).to(torch.int32)


def make_histogram(num_bins: int, *, block=(8, 128), vec: int = 4):
    """histogram(x): x (S, K) int32 -> (num_bins,) int32 counts."""
    if num_bins <= 0:
        raise ValueError(f"histogram: num_bins must be positive, got "
                         f"{num_bins}")
    if vec not in (1, 4):
        raise ValueError(f"histogram: 1 or 4 values a thread, got {vec}")

    def fn(x):
        flat.check_2d("histogram", x)
        if x.dtype != torch.int32:
            raise ValueError(f"histogram: x must be int32, got {x.dtype}")
        if x.device.type == "cpu":
            return histogram_plain(x, num_bins)
        if not x.is_contiguous():
            raise ValueError("histogram kernel: x must be contiguous")
        out = torch.empty(num_bins, dtype=torch.int32, device=x.device)
        rw.launch(HISTOGRAM, "lc_histogram", ARGS, x.device, x.data_ptr(),
                    x.numel(), num_bins, out.data_ptr(), vec,
                    source="histogram")
        return out

    fn.num_bins, fn.vec = num_bins, vec
    return fn


def _hist_ref_factory(num_bins):
    def ref(x):
        return torch.bincount(x.reshape(-1), minlength=num_bins)[
            :num_bins].to(torch.int32)
    return ref


BINS = 128  # registry instantiation bin count (tests use this)

for _suffix, _blk in [("i32", (8, 128)), ("i32x4", (32, 128))]:
    register_op(
        f"histogram_{_suffix}",
        ref=_hist_ref_factory(BINS),
        atol=0.0, rtol=0.0, family="histogram", tags=(_suffix,),
    )(make_histogram(BINS, block=_blk, vec=rw.rung(_suffix)["vec"]))

histogram = make_histogram
