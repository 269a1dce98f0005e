"""Whole-array reductions: the sum of (S, K) in the reference's matrix of
element and accumulator dtypes, and the max.

Counterpart of ``leetcuda_tpu/ops/reduce.py``
(``make_block_all_reduce_sum``, ``make_block_all_reduce_max``, ``_MATRIX``
and its 9 registrations, ``block_all_reduce_sum_f32``,
``block_all_reduce_max_f32``). On CUDA tensors the wrappers launch
``lc_reduce`` of ``csrc/reduce.cu``: one launch (``reduce_plan``), each
CTA's partial in its slot of a per-stream scratch and the last CTA adding
the slots in slot order, no float atomics, so a result is the same bits on
every run. Each returns a 0-d tensor on x's device in the accumulator dtype,
with no host synchronisation and nothing allocated but it. On CPU tensors
they run ``sum_plain`` / ``max_plain``.

Float inputs (f32, f16, bf16, e4m3, e5m2; e4m3's bytes 0x7F and 0xFF are
NaN, as ``upcast_for_vpu`` decodes them) accumulate in f32 and the sum is
rounded once to the accumulator dtype. For the f16 and bf16 accumulator
rungs that is what the TPU computed (JAX's ``_kernel_acc_dtype``: Mosaic
has no f16 arithmetic, so the in-kernel accumulation ran in f32); JAX's CPU
interpret mode accumulates in the narrow type, whence the registry's atol
of 0.5 to 32. int8 sums accumulate in int32 and wrap mod 2^32, as JAX's
int32 sum does. The max propagates NaN and is -inf over no element.

``block`` is the TPU's tiling and is accepted and ignored; a rung is the
elements a thread takes (``ops/flat.py``), by default one 16-byte word.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, cdiv, check_launch
from leetcuda_tpu_torch.ops import flat
from leetcuda_tpu_torch.ops import rowwise as rw

REDUCE_SUM = LaunchCounter("block_all_reduce_sum")
REDUCE_MAX = LaunchCounter("block_all_reduce_max")
SUM, MAX, DOT = 0, 1, 2  # lc_reduce's op codes
# csrc/reduce.cu's constants (checked against the library's lc_reduce_info):
# threads a CTA, CTAs an SM, loads and bytes a thread has in flight, and the
# per-stream scratch: the counter padded to HEADER_INTS, then MAX_SLOTS
# 4-byte slots, one a CTA
THREADS, CTAS_PER_SM, INFLIGHT, MAX_BYTES = 256, 4, 16, 64
HEADER_INTS, MAX_SLOTS = 32, 2048
SCRATCH_INTS = HEADER_INTS + MAX_SLOTS
SUM_INPUTS = flat.FLOATS + (torch.int8, torch.float8_e4m3fn,
                            torch.float8_e5m2)
ACCUMULATORS = flat.FLOATS + (torch.int32,)
# lc_reduce(x, y, n, in_dtype, op, vec, load_bytes, scratch, out,
#           out_dtype, grid, stream); lc_reduce_info(info)
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGS = (_P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P, _P, _I, _I, _P)
INFO_ARGS = (_P,)


def vectors_in_flight(itemsize: int, vec: int, lb: int,
                      inflight: int = INFLIGHT) -> int:
    """Vectors a thread loads before it adds (reduce.cu
    vectors_in_flight): ``inflight`` loads of ``lb`` bytes and MAX_BYTES
    bytes at most, at least one."""
    loads, nbytes = vec * itemsize // lb, vec * itemsize
    return max(1, min(inflight // loads, MAX_BYTES // nbytes))


def split_flat(offset: int, n: int, itemsize: int, vec: int, lb: int):
    """(head, nvec, tail) of csrc/vec_io.cuh split_flat for n elements
    whose first lies ``offset`` bytes past an ``lb``-aligned address: the
    elements before the first aligned one, the whole vectors after them,
    and the index of the first element past the last whole vector."""
    per = lb // itemsize
    mis = (offset // itemsize) % per
    head = min((per - mis) % per, n)
    nvec = (n - head) // vec
    return head, nvec, head + nvec * vec


@functools.lru_cache(maxsize=1024)
def reduce_plan(n: int, itemsize: int, vec: int, lb: int, offset: int = 0,
                sms: int = 132, ctas_per_sm: int = CTAS_PER_SM,
                inflight: int = INFLIGHT) -> dict:
    """What one launch of lc_reduce runs over n elements (``offset`` bytes
    past an lb-aligned address) at a rung: the split, the vectors a thread
    has in flight (``unroll``), and the grid: ``ctas_per_sm`` CTAs an SM of
    ``sms``, fewer where the array gives a thread less than one round of
    ``unroll`` vectors, at least one; each CTA owns the slot of its index.
    Cached (read it, do not change it)."""
    head, nvec, tail = split_flat(offset, n, itemsize, vec, lb)
    unroll = vectors_in_flight(itemsize, vec, lb, inflight)
    grid = max(1, min(ctas_per_sm * sms, cdiv(nvec, THREADS * unroll)))
    if grid > MAX_SLOTS:
        raise ValueError(f"reduce: {grid} CTAs exceed {MAX_SLOTS} slots")
    return {"head": head, "nvec": nvec, "tail": tail, "unroll": unroll,
            "grid": grid, "threads": THREADS, "slots": grid,
            "scratch_ints": SCRATCH_INTS}


_INFO: dict = {}


def build_info(lib="reduce"):
    """{"ctas_per_sm", "inflight", "launches", "probe", "cs"} of ``lib`` (a
    source name or a variant build); every build has THREADS, MAX_BYTES and
    the scratch's layout, and the package's build CTAS_PER_SM, INFLIGHT,
    one launch, no probe and evict-first loads."""
    from leetcuda_tpu_torch.build import entry

    key = lib if isinstance(lib, str) else id(lib)
    got = _INFO.get(key)
    if got is None:
        info = (ctypes.c_int * 9)()
        check_launch(entry(lib, "lc_reduce_info", INFO_ARGS)(
            ctypes.addressof(info)), REDUCE_SUM.name)
        fixed = (info[0], info[3], info[4], info[5])
        got = _INFO[key] = dict(ctas_per_sm=info[1], inflight=info[2],
                                launches=info[6], probe=info[7], cs=info[8])
        if fixed != (THREADS, MAX_BYTES, HEADER_INTS, MAX_SLOTS) or (
                lib == "reduce" and got != dict(
                    ctas_per_sm=CTAS_PER_SM, inflight=INFLIGHT, launches=1,
                    probe=0, cs=1)):
            raise RuntimeError(f"csrc/reduce.cu was built with {list(info)};"
                               f" the wrapper plans {THREADS} threads, "
                               f"{CTAS_PER_SM} CTAs an SM, {INFLIGHT} loads")
    return got


# One scratch per (device, stream): the counter (0 between launches: the
# last CTA of each launch sets it back) and the slots. Made once, never
# replaced, so a CUDA graph captured on the stream launches into it for the
# life of the process; a graph's replays must not overlap launches on its
# capture stream's scratch from another stream.
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}
_SMS: dict[int, int] = {}


def stream_scratch(device, stream: int) -> torch.Tensor:
    """The reduce scratch (SCRATCH_INTS int32, zeros when made) of
    ``stream`` on ``device``; made outside any capture (launch once on the
    stream before capturing a graph)."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("reduce: this stream has no scratch yet; "
                               "launch the call once on it before capturing "
                               "a graph")
        buf = _SCRATCH[key] = torch.zeros(SCRATCH_INTS, dtype=torch.int32,
                                          device=device)
    return buf


def _sms(device) -> int:
    got = _SMS.get(device.index)
    if got is None:
        got = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return got


def sum_plain(x, acc_dtype):
    """The sum of x in ``acc_dtype``: floats accumulated in f32 and rounded
    once; int8 in int32, wrapping mod 2^32."""
    if x.dtype == torch.int8:
        s = x.to(torch.int64).sum()
        return ((s + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
    return x.float().sum().to(acc_dtype)


def max_plain(x, acc_dtype):
    """The max of x in ``acc_dtype`` (NaN if any is NaN), -inf if x is
    empty."""
    if x.numel() == 0:
        return torch.tensor(float("-inf"), dtype=acc_dtype, device=x.device)
    return x.to(acc_dtype).max()


def _check_acc(x, acc_dtype):
    if (x.dtype == torch.int8) != (acc_dtype == torch.int32) or (
            acc_dtype not in ACCUMULATORS):
        raise ValueError(f"block_all_reduce: an int8 x sums in int32 and a "
                         f"float x in f32, f16 or bf16; got {x.dtype} into "
                         f"{acc_dtype}")


def launch_reduce(counter, x, y, op: int, acc_dtype, vec, pack, dtypes,
                  lib="reduce"):
    """``op`` of csrc/reduce.cu (or the variant build ``lib``) over x (and
    y, for the dot) on the card, one launch (two for a variant with
    LC_REDUCE_LAUNCHES 2): a 0-d tensor of ``acc_dtype`` on x's device."""
    rw.check_kernel_operands(counter.name, x, *(() if y is None else (y,)),
                             dtypes=dtypes)
    built = build_info(lib)
    vec, lb = flat.rung_bytes(vec, pack, x.element_size())
    plan = reduce_plan(x.numel(), x.element_size(), vec, lb,
                       x.data_ptr() % lb, _sms(x.device),
                       built["ctas_per_sm"], built["inflight"])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch = stream_scratch(x.device, stream)
    out = torch.empty((), dtype=acc_dtype, device=x.device)
    rw.launch(counter, "lc_reduce", ARGS, x.device, x.data_ptr(),
              (x if y is None else y).data_ptr(), x.numel(),
              flat.DTYPES[x.dtype], op, vec, lb, scratch.data_ptr(),
              out.data_ptr(), flat.DTYPES[acc_dtype], plan["grid"],
              source=lib)
    return out


def make_block_all_reduce_sum(acc_dtype, *, block=(512, 2048), vec=None,
                              pack: bool = True):
    """fn(x): the sum of an (S, K) x as a 0-d tensor of ``acc_dtype``."""

    def fn(x):
        flat.check_2d("block_all_reduce_sum", x)
        _check_acc(x, acc_dtype)
        if x.device.type == "cpu":
            return sum_plain(x, acc_dtype)
        return launch_reduce(REDUCE_SUM, x, None, SUM, acc_dtype, vec, pack,
                             SUM_INPUTS)

    fn.acc_dtype, fn.vec, fn.pack = acc_dtype, vec, pack
    return fn


def make_block_all_reduce_max(acc_dtype, *, block=(512, 2048), vec=None,
                              pack: bool = True):
    """fn(x): the max of an (S, K) float x as a 0-d tensor of
    ``acc_dtype``."""
    if acc_dtype not in flat.FLOATS:
        raise ValueError(f"block_all_reduce_max: a float accumulator, got "
                         f"{acc_dtype}")

    def fn(x):
        flat.check_2d("block_all_reduce_max", x)
        if x.device.type == "cpu":
            return max_plain(x, acc_dtype)
        return launch_reduce(REDUCE_MAX, x, None, MAX, acc_dtype, vec, pack,
                             flat.FLOATS)

    fn.vec, fn.pack = vec, pack
    return fn


def _sum_ref_factory(acc_dtype):
    def ref(x):
        return sum_plain(x, acc_dtype)
    return ref


def _reduce_flops(x):
    return float(x.numel())


def _reduce_bytes(x):
    return float(x.numel() * x.element_size())


# (name suffix, element dtype, accumulator dtype, atol): the reference's
# matrix, as JAX registers it
_MATRIX = [
    ("f32_f32", torch.float32, torch.float32, 1e-3),
    ("f32x4_f32", torch.float32, torch.float32, 1e-3),
    ("f16_f16", torch.float16, torch.float16, 5e-1),
    ("f16_f32", torch.float16, torch.float32, 5e-1),
    ("bf16_bf16", torch.bfloat16, torch.bfloat16, 8.0),
    ("bf16_f32", torch.bfloat16, torch.float32, 4.0),
    ("i8_i32", torch.int8, torch.int32, 0),
    ("fp8_e4m3_f16", torch.float8_e4m3fn, torch.float16, 16.0),
    ("fp8_e5m2_f16", torch.float8_e5m2, torch.float16, 32.0),
]

for _suffix, _edt, _adt, _atol in _MATRIX:
    _blk = (1024, 2048) if "x4" in _suffix else (512, 2048)
    register_op(
        f"block_all_reduce_sum_{_suffix}",
        ref=_sum_ref_factory(_adt), flops=_reduce_flops, bytes=_reduce_bytes,
        atol=float(_atol), rtol=1e-2, family="reduce", tags=(_suffix,),
    )(make_block_all_reduce_sum(_adt, block=_blk, **rw.rung(_suffix)))

block_all_reduce_sum_f32 = make_block_all_reduce_sum(torch.float32)
block_all_reduce_max_f32 = make_block_all_reduce_max(torch.float32)
