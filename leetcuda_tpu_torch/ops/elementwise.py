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
elements a thread takes (``ops/flat.py``). ``map_plan`` sizes the map's
grid (the add and the activations alike): one pass over exactly the
vectors in chunks, a CTA a chunk, each thread taking as many vectors as
make ``MAP_LOADS`` loads, in flight together.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, cdiv
from leetcuda_tpu_torch.ops import flat
from leetcuda_tpu_torch.ops import rowwise as rw

ELEMENTWISE_ADD = LaunchCounter("elementwise_add")
ADD = 0  # lc_elementwise's op code of the add (elementwise.cu Op)
# lc_elementwise(x, y, out, n, dtype, op, vec, load_bytes, grid, stream)
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGS = (_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _P)
# The map's CTAs (csrc/elementwise.cu kThreads) and the one-load vectors
# whose loads a thread issues before its math (LC_MAP_LOADS; the A/B of
# bench --map, NVIDIA H100 80GB HBM3, 700 W: 2 and 4 level, 1 and 8
# slower at the model's shapes).
MAP_THREADS, MAP_LOADS = 256, 4

# the graded ladder: the JAX rung suffixes (JAX's block multipliers over
# the TPU's minimum tile; here ``rw.rung`` of the suffix)
_LADDER = ("", "x2", "x4", "x8", "x8_pack")
_DTYPES = {"f32": torch.float32, "f16": torch.float16,
           "bf16": torch.bfloat16}


def add_plain(x, y):
    return x + y


_ref_add = add_plain


def map_unroll(vec: int, itemsize: int, lb: int,
               loads: int = MAP_LOADS) -> int:
    """Vectors a thread of csrc/elementwise.cu takes a step (kMapUnroll):
    ``loads`` where a vector is one load of lb bytes, else one (its own
    loads in flight together)."""
    return loads if vec * itemsize == lb else 1


def map_plan(n: int, itemsize: int, vec: int, lb: int, base: int = 0,
             loads: int = MAP_LOADS) -> dict:
    """How csrc/elementwise.cu walks n elements of ``itemsize`` bytes at
    byte address ``base`` in vectors of ``vec`` elements loaded ``lb`` bytes
    at a time: the ``head`` elements before the first lb-aligned address,
    ``nvec`` whole vectors in ``chunks`` of ``unroll`` x MAP_THREADS
    (``unroll`` = map_unroll, with the build's ``loads``), the ``tail``
    elements after them (head and tail one element a thread); the ``grid``
    of MAP_THREADS-thread CTAs, a chunk each (one where there is no
    chunk)."""
    E = lb // itemsize
    head = min(n, (E - (base // itemsize) % E) % E)
    nvec = (n - head) // vec
    unroll = map_unroll(vec, itemsize, lb, loads)
    chunks = cdiv(nvec, unroll * MAP_THREADS)
    return {"grid": max(1, chunks), "head": head, "nvec": nvec,
            "tail": n - head - nvec * vec, "unroll": unroll,
            "chunks": chunks}


def map_walk(plan: dict, vec: int):
    """The elements each thread of ``plan``'s grid takes, as the kernel
    walks them: {(CTA, thread): [element indices, in order]}."""
    head, nvec, U = plan["head"], plan["nvec"], plan["unroll"]
    out = {}
    for c in range(plan["grid"]):
        for t in range(MAP_THREADS):
            mine = []
            for k in range(U):
                v = c * U * MAP_THREADS + k * MAP_THREADS + t
                if v < nvec:
                    mine.extend(range(head + v * vec, head + (v + 1) * vec))
            tid = c * MAP_THREADS + t
            if tid < head:
                mine.append(tid)
            if tid < plan["tail"]:
                mine.append(head + nvec * vec + tid)
            if mine:
                out[(c, t)] = mine
    return out


def launch_map(counter, x, y, op: int, vec: int, pack: bool, *,
               plan: dict | None = None, lib: str = "elementwise"):
    """``op`` of csrc/elementwise.cu over x (and y, for the add) on the
    card, into a new tensor of x's shape and dtype, on ``map_plan``'s grid
    (the bench gives the ``plan`` and ``lib`` of a variant build)."""
    rw.check_kernel_operands(counter.name, x, *(() if y is None else (y,)),
                             dtypes=flat.FLOATS)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    vec, lb = flat.rung_bytes(vec, pack, x.element_size())
    if plan is None:
        plan = map_plan(x.numel(), x.element_size(), vec, lb, x.data_ptr())
    rw.launch(counter, "lc_elementwise", ARGS, x.device, x.data_ptr(),
              (x if y is None else y).data_ptr(), out.data_ptr(), x.numel(),
              flat.DTYPES[x.dtype], op, vec, lb, plan["grid"], source=lib)
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
