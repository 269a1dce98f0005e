"""The Hopper whole-array reductions' plan, walk and order of sums, on the
CPU; and the card harness's device-alone timer on a fake profile.

The kernel of ``csrc/reduce.cu`` (``reduce_flat``: one launch, each CTA's
partial in its slot, the last CTA adding the slots in slot order) runs only
on the GPU, where ``chip_smoke.py`` holds it against ``sum_plain``,
``max_plain`` and the dot's plain version, twice bit for bit and in a
replayed CUDA graph. What surrounds its arithmetic is Python that these
tests reach, and a mirror of it:

- ``reduce_plan`` against the source's constants: threads, CTAs an SM,
  loads and bytes a thread has in flight (``vectors_in_flight`` at every
  rung), the scratch (counter line, slots) and the grid;
- the walk: every element of a ragged, misaligned flat array read exactly
  once (the head and tail by CTA 0, whole vectors grid-stride in rounds of
  ``unroll``);
- the order of sums: ``sum_mirror`` repeats the kernel's f32 adds in
  numpy (a thread's elements in order, the xor tree of a warp, warps in
  order, slots in slot order, one rounding to the accumulator) and is held
  against JAX's ``make_block_all_reduce_sum`` in interpret mode at the
  registry's tolerances (f32 1e-3, f16 0.5, bf16 8 or 4, e4m3 16, e5m2 32,
  rtol 1e-2) and against the f64 sum within the f32 reordering bound
  (n ulp of the largest partial);
- int8: a numpy dp4a (four signed bytes a word into a wrapping uint32) and
  the sum's wrap mod 2^32, exactly; e4m3's bytes 0x7F and 0xFF (and e5m2's
  NaN bytes) decode to NaN two at a time as one at a time, exactly;
- the per-stream scratch and the ``--reduce`` bench CLI on the CPU;
- ``chip_smoke.whole_profile_ms``: a profile whose time a call is below
  the call's bound, or with a partial count, is rejected and printed; a
  whole one is kept.
"""

import json
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from leetcuda_tpu.ops import reduce as jrd
from leetcuda_tpu_torch.ops import flat
from leetcuda_tpu_torch.ops import reduce as rd
from leetcuda_tpu_torch.ops import rowwise as rw

SRC = Path(rd.__file__).parent.parent / "csrc" / "reduce.cu"
# (itemsize, vec, load bytes): every rung the source instantiates
RUNGS = [(s, v, lb) for s in (1, 2, 4) for v, lb in (
    (1, s), (2, min(16, 2 * s)), (4, min(16, 4 * s)), (8, min(16, 8 * s)),
    (8, 4))] + [(1, 16, 16)]


def test_plan_is_the_sources():
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"(?:#define {name}|{name} =) (\d+)",
                             src).group(1))

    assert const("kThreads") == rd.THREADS == 256
    assert const("LC_REDUCE_CTAS_PER_SM") == rd.CTAS_PER_SM
    assert const("LC_REDUCE_INFLIGHT") == rd.INFLIGHT
    assert const("kMaxBytes") == rd.MAX_BYTES
    assert const("kHeaderInts") == rd.HEADER_INTS
    assert const("kMaxSlots") == rd.MAX_SLOTS
    assert const("LC_REDUCE_LAUNCHES") == 1 and const("LC_REDUCE_PROBE") == 0
    assert const("LC_REDUCE_CS") == 1 and "__ldcs(" in src
    assert "void* scratch, void* out, int out_dtype, int grid,\n" in src
    assert "atomicAdd(counter, 1u) == gridDim.x - 1" in src
    assert "*counter = 0u" in src
    # the ladder's loads in flight: 16 loads and 64 bytes a thread at most
    got = {r: rd.vectors_in_flight(*r) for r in RUNGS}
    assert got[(1, 1, 1)] == 16 and got[(4, 1, 4)] == 16
    assert got[(4, 4, 16)] == 4 and got[(1, 16, 16)] == 4
    assert got[(4, 8, 4)] == 2 and got[(2, 8, 4)] == 4
    assert got[(4, 8, 16)] == 2 and got[(1, 8, 4)] == 8
    for (s, v, lb), u in got.items():
        assert u * v * s // lb <= rd.INFLIGHT and u * v * s <= rd.MAX_BYTES


@pytest.mark.parametrize("n", [0, 1, 130, 4000, 700 * 4000, 16384 * 2048])
@pytest.mark.parametrize("rung", RUNGS[::3] + [(1, 16, 16)])
def test_grid(n, rung):
    s, v, lb = rung
    p = rd.reduce_plan(n, s, v, lb)
    assert 1 <= p["grid"] <= rd.CTAS_PER_SM * 132 <= rd.MAX_SLOTS
    assert p["slots"] == p["grid"]
    assert p["scratch_ints"] == rd.HEADER_INTS + rd.MAX_SLOTS
    per_round = rd.THREADS * p["unroll"]
    assert p["grid"] == max(1, min(rd.CTAS_PER_SM * 132,
                                   -(-p["nvec"] // per_round)))
    if n == 16384 * 2048:
        assert p["grid"] == 528


def reduce_walk(n, s, v, lb, offset, grid):
    """[(thread id, element index)] in the order each thread of the kernel
    reads them: its vectors in rounds of ``unroll`` grid-stride, then the
    remainder one vector a step, then (CTA 0) one head and one tail
    element."""
    head, nvec, tail = rd.split_flat(offset, n, s, v, lb)
    U, T = rd.vectors_in_flight(s, v, lb), grid * rd.THREADS
    whole = nvec // (U * T) * (U * T)
    order = {g: [] for g in range(T)}
    for g in range(T):
        for base in range(0, whole, U * T):
            for u in range(U):
                i = base + u * T + g
                order[g] += range(head + i * v, head + (i + 1) * v)
        for i in range(whole + g, nvec, T):
            order[g] += range(head + i * v, head + (i + 1) * v)
        if g < rd.THREADS:
            if g < head:
                order[g].append(g)
            if tail + g < n:
                order[g].append(tail + g)
    return order


@pytest.mark.parametrize("n,offset", [(4000, 0), (4001, 4), (130, 12),
                                      (1, 0), (3, 2), (70000, 8),
                                      (200003, 1)])
@pytest.mark.parametrize("rung", [(4, 1, 4), (4, 4, 16), (4, 8, 4),
                                  (2, 8, 16), (1, 16, 16), (1, 1, 1)])
@pytest.mark.parametrize("grid", [1, 3])
def test_walk_reads_every_element_once(n, offset, rung, grid):
    s, v, lb = rung
    offset -= offset % s
    order = reduce_walk(n, s, v, lb, offset, grid)
    idx = np.concatenate([np.array(o, np.int64) for o in order.values()])
    assert np.array_equal(np.sort(idx), np.arange(n))


def _warp_tree(v):
    """Lane 0 of ``v = v + shfl_xor(v, o)`` for o = 16 .. 1, per warp."""
    v = v.reshape(-1, 32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, np.arange(32) ^ o]
    return v[:, 0]


def _block(v):
    """block_reduce: each warp's tree, then the warps in warp order."""
    w = _warp_tree(v)
    acc = w[0]
    for x in w[1:]:
        acc = acc + x
    return acc


def sum_mirror(values, s, v, lb, offset=0, grid=None):
    """The kernel's f32 sum of ``values`` (the elements decoded to f32) at a
    rung: per thread its elements in reading order, block_reduce per CTA,
    the slots in slot order (thread t: slots t, t + 256, ...), then
    block_reduce again."""
    vals = values.astype(np.float32).ravel()
    n = vals.size
    grid = grid or rd.reduce_plan(n, s, v, lb, offset)["grid"]
    order = reduce_walk(n, s, v, lb, offset, grid)
    acc = np.zeros(grid * rd.THREADS, np.float32)
    for g, idx in order.items():
        a = np.float32(0)
        for i in idx:
            a = np.float32(a + vals[i])
        acc[g] = a
    slots = np.array([_block(acc[b * rd.THREADS:(b + 1) * rd.THREADS])
                      for b in range(grid)], np.float32)
    per_thread = np.zeros(rd.THREADS, np.float32)
    for t in range(rd.THREADS):
        a = np.float32(0)
        for i in range(t, grid, rd.THREADS):
            a = np.float32(a + slots[i])
        per_thread[t] = a
    return _block(per_thread)


@pytest.mark.parametrize("name", [n for n, *_ in rd._MATRIX
                                  if not n.startswith("i8")])
@pytest.mark.parametrize("shape", [(64, 520), (7, 1000)])
def test_sum_mirror_against_jax_and_f64(name, shape):
    import jax.numpy as jnp

    _, edt, adt, atol = next(m for m in rd._MATRIX if m[0] == name)
    rng = np.random.default_rng(len(name) + shape[0])
    x = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(edt)
    vec, lb = flat.rung_bytes(**rw.rung(name), itemsize=x.element_size())
    vals = x.float().numpy()
    got = np.float32(sum_mirror(vals, x.element_size(), vec, lb))
    jdt = {torch.float32: jnp.float32, torch.float16: jnp.float16,
           torch.bfloat16: jnp.bfloat16, torch.float8_e4m3fn:
           jnp.float8_e4m3fn, torch.float8_e5m2: jnp.float8_e5m2}
    xin = jnp.asarray(vals).astype(jdt[edt])  # exact: vals are x's values
    want = float(np.asarray(jrd.make_block_all_reduce_sum(
        jdt[adt], block=(8, 128))(xin), np.float64).reshape(-1)[0])
    rounded = float(torch.tensor(float(got)).to(adt).float())
    assert abs(rounded - want) <= atol + 1e-2 * abs(want)
    exact = float(vals.astype(np.float64).sum())
    bound = vals.size * np.finfo(np.float32).eps * float(np.abs(vals).sum())
    assert abs(float(got) - exact) <= bound
    # the port's plain version on CPU tensors, at the registry's tolerance
    assert abs(rounded - float(rd.sum_plain(x, adt))) <= atol + 1e-2 * abs(
        rounded)


def dp4a(word, acc):
    """__dp4a(word, 0x01010101, acc) on uint32s: the four signed bytes of
    each word added to acc, wrapping mod 2^32."""
    b = word.view(np.uint8).reshape(-1, 4).view(np.int8).astype(np.int64)
    return (acc.astype(np.int64) + b.sum(1)) % 2 ** 32


def test_dp4a_sum_wraps_as_jax_int32():
    rng = np.random.default_rng(1)
    x = rng.integers(-128, 128, 4096 * 16, dtype=np.int8)
    words = x.view(np.uint32)
    acc = np.full(words.size, 2 ** 32 - 5, np.uint32)  # a sum about to wrap
    got = dp4a(words, acc)
    want = (2 ** 32 - 5 + x.reshape(-1, 4).astype(np.int64).sum(1)) % 2 ** 32
    assert np.array_equal(got, want)
    # the whole sum: the order does not matter mod 2^32; 17M bytes of 127
    # wrap past 2^31 as JAX's int32 sum does
    n = 17_000_000
    big = np.full(n, 127, np.int8)
    total = int(dp4a(big.view(np.uint32), np.zeros(n // 4, np.uint32)).sum()
                % 2 ** 32)
    as_i32 = (total + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert as_i32 == (127 * n + 2 ** 31) % 2 ** 32 - 2 ** 31 < 0
    assert as_i32 == int(rd.sum_plain(torch.from_numpy(big).reshape(1000, -1),
                                      torch.int32))


@pytest.mark.parametrize("dt", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_fp8_pairs_decode_as_singles(dt):
    b = torch.arange(256, dtype=torch.uint8)
    single = b.view(dt).float().numpy()
    # a pair word: byte i low, byte (i + 1) % 256 high, as cvt.f16x2 reads it
    lo, hi = b, b.roll(-1)
    pair_lo = lo.view(dt).to(torch.float16).float().numpy()
    pair_hi = hi.view(dt).to(torch.float16).float().numpy()
    assert np.array_equal(pair_lo, single, equal_nan=True)
    assert np.array_equal(pair_hi, np.roll(single, -1), equal_nan=True)
    nan = np.isnan(single)
    if dt == torch.float8_e4m3fn:
        assert list(np.flatnonzero(nan)) == [0x7F, 0xFF]
    x = torch.zeros(4, 64, dtype=torch.uint8)
    x[2, 17] = 0x7F if dt == torch.float8_e4m3fn else 0xFF
    xs = x.view(dt)
    got = sum_mirror(xs.float().numpy(), 1, 16, 16)
    assert np.isnan(got) and torch.isnan(rd.sum_plain(xs, torch.float16))


def test_stream_scratch_made_once_zeroed():
    dev = torch.device("cpu")
    rd._SCRATCH.pop((None, 777), None)
    a = rd.stream_scratch(dev, 777)
    assert a.numel() == rd.SCRATCH_INTS and int(a.abs().sum()) == 0
    assert rd.stream_scratch(dev, 777) is a
    rd._SCRATCH.pop((None, 777))


def test_reduce_bench_cli_on_cpu(tmp_path):
    out = tmp_path / "reduce.json"
    root = Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-m",
                        "leetcuda_tpu_torch.bench.gemm_bench", "--reduce",
                        "--device", "cpu", "--iters", "2", "--json",
                        str(out)], cwd=root, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    rows = json.loads(out.read_text())["rows"]
    assert len(rows) >= 13 and all(r["max_abs_err"] == 0.0 for r in rows)


def _event(key, count, us):
    return SimpleNamespace(key=key, count=count, self_device_time_total=us)


def test_device_alone_rejects_a_reading_below_the_bound(capsys):
    whole = [_event("reduce_flat", 20, 20 * 30.0),
             _event("FillFunctor", 20, 20 * 500.0)]
    # 0.030 ms a call against a bound of 0.010: kept
    assert chip_smoke.whole_profile_ms(whole, 20, 0.010, "sum") == 0.03
    assert capsys.readouterr().out == ""
    # the same profile against a bound of 0.0401: a profile that lost
    # launches, rejected and printed with the case, the reading and the bound
    assert chip_smoke.whole_profile_ms(whole, 20, 0.0401, "rms") is None
    said = capsys.readouterr().out
    assert "rms" in said and "0.0300" in said and "0.0401" in said
    # a partial count: rejected and printed
    partial = [_event("reduce_flat", 13, 13 * 30.0)]
    assert chip_smoke.whole_profile_ms(partial, 20, 0.01, "sum") is None
    assert "partial" in capsys.readouterr().out
    assert chip_smoke.whole_profile_ms([], 20, 0.0, "empty") is None
