"""Dot product: the sum of x * y over (S, K), accumulated in f32.

Counterpart of ``leetcuda_tpu/ops/dot_product.py`` (``make_dot_product``,
the 5 registrations, ``_dot_ref``, ``dot_product``). On CUDA tensors the
wrappers launch ``lc_reduce`` of ``csrc/reduce.cu`` with the dot's op
code: the products summed in f32 in two passes with no atomics, so a
result is the same bits on every run; each returns a 0-d f32 tensor on
x's device with no host synchronisation. On CPU tensors they run
``dot_plain``. x and y are f32, f16 or bf16, of one shape and dtype.

``block`` is the TPU's tiling and is accepted and ignored; a rung is the
elements a thread takes (``ops/flat.py``), by default one 16-byte word.
"""

from __future__ import annotations

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter
from leetcuda_tpu_torch.ops import flat
from leetcuda_tpu_torch.ops import rowwise as rw
from leetcuda_tpu_torch.ops.reduce import DOT, launch_reduce

DOT_PRODUCT = LaunchCounter("dot_product")


def dot_plain(x, y):
    return (x.float() * y.float()).sum()


_dot_ref = dot_plain


def make_dot_product(*, block=(512, 2048), vec=None, pack: bool = True):
    """fn(x, y): the sum of x * y over (S, K) operands of one shape, dtype
    and device, as a 0-d f32 tensor."""

    def fn(x, y):
        flat.check_2d("dot_product", x, y)
        if x.device.type == "cpu":
            return dot_plain(x, y)
        return launch_reduce(DOT_PRODUCT, x, y, DOT, torch.float32, vec,
                             pack, flat.FLOATS)

    fn.vec, fn.pack = vec, pack
    return fn


def _dot_flops(x, y):
    return float(2 * x.numel())


def _dot_bytes(x, y):
    return float(2 * x.numel() * x.element_size())


for _suffix, _blk, _atol in [
    ("f32", (256, 1024), 1e-1),
    ("f32x4", (512, 2048), 1e-1),
    ("f16_f32", (256, 1024), 2.0),
    ("f16x2_f32", (512, 2048), 2.0),
    ("f16x8_pack_f32", (1024, 2048), 2.0),
]:
    register_op(
        f"dot_prod_{_suffix}",
        ref=_dot_ref, flops=_dot_flops, bytes=_dot_bytes,
        atol=_atol, rtol=1e-2, family="dot-product", tags=(_suffix,),
    )(make_dot_product(block=_blk, **rw.rung(_suffix)))

dot_product = make_dot_product()
