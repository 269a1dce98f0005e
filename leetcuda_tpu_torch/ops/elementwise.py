"""Elementwise binary op (add) over (S, K), in x's dtype.

Counterpart of ``leetcuda_tpu/ops/elementwise.py``
(``make_elementwise_binary``, the 15 ``elementwise_add_*`` registrations,
``_ref_add``, ``elementwise_add_f32`` / ``elementwise_add_bf16``). On CUDA
tensors the wrappers launch ``lc_elementwise`` of ``csrc/elementwise.cu``
and return a new tensor (x is never written: the TPU kernel aliases x to
its output, a TPU workaround); on CPU tensors they run ``op`` as plain
torch. The kernel computes the add in f32 and rounds once, which for f16
and bf16 is the correctly rounded sum, so it equals ``x + y`` bit for bit.

The kernel takes only the add, which is all that JAX registers: a Python
callable cannot reach CUDA, so any other ``op`` raises on a CUDA tensor.
``block`` is the TPU's tiling and is accepted and ignored; a rung is the
elements a thread takes (``ops/flat.py``).
"""

from __future__ import annotations

import ctypes
import operator

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter
from leetcuda_tpu_torch.ops import flat
from leetcuda_tpu_torch.ops import rowwise as rw

ELEMENTWISE_ADD = LaunchCounter("elementwise_add")
ADD = 0  # lc_elementwise's op code of the add (elementwise.cu Op)
# lc_elementwise(x, y, out, n, dtype, op, vec, load_bytes, stream)
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGS = (_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P)

# the graded ladder: the JAX rung suffixes (JAX's block multipliers over
# the TPU's minimum tile; here ``rw.rung`` of the suffix)
_LADDER = ("", "x2", "x4", "x8", "x8_pack")
_DTYPES = {"f32": torch.float32, "f16": torch.float16,
           "bf16": torch.bfloat16}


def add_plain(x, y):
    return x + y


_ref_add = add_plain


def launch_map(counter, x, y, op: int, vec: int, pack: bool):
    """``op`` of csrc/elementwise.cu over x (and y, for the add) on the
    card, into a new tensor of x's shape and dtype."""
    rw.check_kernel_operands(counter.name, x, *(() if y is None else (y,)),
                             dtypes=flat.FLOATS)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    vec, lb = flat.rung_bytes(vec, pack, x.element_size())
    rw.launch(counter, "lc_elementwise", ARGS, x.device, x.data_ptr(),
                (x if y is None else y).data_ptr(), out.data_ptr(), x.numel(),
                flat.DTYPES[x.dtype], op, vec, lb, source="elementwise")
    return out


def make_elementwise_binary(op=operator.add, *, block=None, vec: int = 8,
                            pack: bool = True):
    """fn(x, y): ``op(x, y)`` over (S, K) operands of one shape, dtype and
    device, in x's dtype. ``op`` is ``operator.add`` for the kernel; another
    callable runs only on CPU tensors."""
    is_add = op is operator.add

    def fn(x, y):
        flat.check_2d("elementwise", x, y)
        if x.device.type == "cpu":
            return op(x, y).to(x.dtype)
        if not is_add:
            raise ValueError("elementwise kernel: only the add has a kernel; "
                             f"got {op!r}")
        return launch_map(ELEMENTWISE_ADD, x, y, ADD, vec, pack)

    fn.vec, fn.pack = vec, pack
    return fn


def _add_flops(x, y):
    return float(x.numel())


def _add_bytes(x, y):
    return float(3 * x.numel() * x.element_size())


def _register_ladder(op_name: str, op):
    for dt_name, dt in _DTYPES.items():
        for rung_name in _LADDER:
            suffix = f"{dt_name}{rung_name}"
            register_op(
                f"elementwise_{op_name}_{suffix}",
                ref=_ref_add, flops=_add_flops, bytes=_add_bytes,
                atol=1e-2 if dt != torch.float32 else 1e-5,
                family="elementwise",
                tags=(dt_name, rung_name or "naive"),
            )(make_elementwise_binary(op, block=None, **rw.rung(suffix)))


_register_ladder("add", operator.add)

# top-level entries (the widest rung)
elementwise_add_f32 = make_elementwise_binary(operator.add, block=(512, 2048))
elementwise_add_bf16 = elementwise_add_f32  # dtype follows the inputs
