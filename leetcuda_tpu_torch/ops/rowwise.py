"""What the row ops (rms-norm, layer-norm, softmax) share: their rungs, the
checks of their operands and the launch of ``csrc/row_ops.cu``.

The JAX rungs differ only in ``rows_per_step``, the TPU's tiling, and every
JAX body computes in f32. In the port a rung is what its name says in the
reference's CUDA ladder: the elements a thread takes a step (``vec``: the
``x4`` of ``f32x4``, the ``x8`` of ``f16x8``; 1 without one), and whether
they come as one 16-byte load (``pack``). Every rung computes in f32, the
``_f16`` accumulator suffixes too, and takes any K and any row alignment.
"""

from __future__ import annotations

import ctypes
import re

import torch

from leetcuda_tpu_torch.core.runtime import check_launch

DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_THREADS = 256


def rung(suffix: str) -> dict:
    """{"vec", "pack"} of a registered rung from its name's suffix."""
    m = re.search(r"x(\d+)", suffix)
    return {"vec": int(m.group(1)) if m else 1, "pack": "pack" in suffix}


def load_bytes(vec: int, pack: bool, itemsize: int) -> int:
    """Bytes a load of the rung takes: the thread's ``vec`` elements in one
    load up to 16 bytes, except the unpacked 8-wide rungs, which load 4 bytes
    at a time (the reference's half2 loads)."""
    if vec == 8 and not pack:
        return max(4, itemsize)
    return min(16, vec * itemsize)


def threads_for(K: int, vec: int) -> int:
    """Threads of the CTA that takes a row: one ``vec`` chunk each up to
    MAX_THREADS, a multiple of 32."""
    n = -(-K // vec)
    return min(MAX_THREADS, max(32, -(-n // 32) * 32))


def check_rows(what: str, x, *vectors):
    """x (S, K) and each of ``vectors`` (K,) on x's device."""
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be (S, K), got {tuple(x.shape)}")
    for v in vectors:
        if v.dim() != 1 or v.shape[0] != x.shape[1]:
            raise ValueError(f"{what}: expected a ({x.shape[1]},) vector, got "
                             f"{tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"{what}: operands must lie on one device")


def check_kernel_operands(what: str, x, *others, dtypes=DTYPES):
    """What the kernels take: x contiguous in one of ``dtypes`` (by default
    f32, f16 or bf16, as csrc/row_ops.cu); the other operands (weight
    vectors, a second input) contiguous in any of the three."""
    if x.dtype not in dtypes:
        raise ValueError(f"{what} kernel: takes x in "
                         f"{[str(d) for d in dtypes]}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel: x must be contiguous")
    for v in others:
        if v.dtype not in DTYPES or not v.is_contiguous():
            raise ValueError(f"{what} kernel: other operands must be "
                             "contiguous f32, f16 or bf16")


def launch(counter, symbol: str, argtypes: tuple, device, *args,
           source: str = "row_ops"):
    """Call ``symbol`` of csrc/<source>.cu with ``args`` and the current
    stream of ``device``, raise on a launch error and count the launch."""
    from leetcuda_tpu_torch.build import kernel

    fn = kernel(source, symbol, argtypes)
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, counter.name)
    counter.add()


# lc_rms_norm / lc_layer_norm_fwd / lc_softmax argtypes, the stream last
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
RMS_ARGS = (P, P, I, P, I, I, I, I, I, F, I, P)
LN_FWD_ARGS = (P, P, I, P, I, P, I, I, I, I, I, F, I, P)
SOFTMAX_ARGS = (P, P, I, I, I, I, I, I, I, P)
LN_BWD_ARGS = (P, P, I, P, P, P, P, P, P, I, I, I, I, I, F, I, P)
LN_BWD_ROWS_ARGS = (P, P, I, P, P, P, P, P, P, I, I, I, I, I, F, P)
