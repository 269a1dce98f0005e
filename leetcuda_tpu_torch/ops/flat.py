"""What the flat passes of the op corpus (the add, the activations, the
reductions, the dot product, the histogram) share beside ``ops/rowwise.py``
(the rung of a name, the operand checks, the launch): the dtype codes of
``csrc/elementwise.cu``, ``csrc/reduce.cu`` and ``csrc/histogram.cu``, the
shape check and the load width of a rung.

Each kernel walks its (S, K) operands as one flat contiguous array. A rung
of the JAX ladder is a Pallas block shape, the TPU's tiling; in the port it
is what its name says in the reference's CUDA ladder (``ops/rowwise.py``
``rung``): the elements a thread takes a step (the ``x4`` of ``f32x4``, the
``x8`` of ``f16x8``; 1 without one) and whether they come as one 16-byte
load (``pack``).
"""

from __future__ import annotations

import torch

from leetcuda_tpu_torch.ops.rowwise import load_bytes

# dtype codes of the three sources (csrc/dtype.cuh's, then reduce.cu's)
DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
          torch.int8: 3, torch.float8_e4m3fn: 4, torch.float8_e5m2: 5,
          torch.int32: 6}
FLOATS = (torch.float32, torch.float16, torch.bfloat16)


def check_2d(what: str, x, *others):
    """x (S, K), and each of ``others`` of x's shape, dtype and device."""
    if x.dim() != 2:
        raise ValueError(f"{what} operates on (S, K) arrays, got "
                         f"{tuple(x.shape)}")
    for y in others:
        if (y.shape != x.shape or y.dtype != x.dtype
                or y.device != x.device):
            raise ValueError(
                f"{what}: operands must match x's shape, dtype and device: "
                f"{tuple(x.shape)} {x.dtype} {x.device} against "
                f"{tuple(y.shape)} {y.dtype} {y.device}")


def rung_bytes(vec: int | None, pack: bool, itemsize: int):
    """(elements a thread, bytes a load) of a rung; ``vec`` None is one
    16-byte word a step."""
    if vec is None:
        vec, pack = 16 // itemsize, True
    return vec, load_bytes(vec, pack, itemsize)
