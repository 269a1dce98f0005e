"""The port's whole-array reductions, dot product, histogram and NMS against
the JAX package's.

On this CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels ``lc_reduce`` of ``csrc/reduce.cu`` and ``lc_histogram`` of
``csrc/histogram.cu`` run on the GPU, held against these same plain
versions by ``chip_smoke.py`` path (m)); the JAX kernels run in Pallas
interpret mode, as ``tests/test_ops_registry.py`` runs them. Inputs come
from a numpy seed and go to both packages as the same numbers
(``core/testing.make_args`` byte for byte, the fp8 bytes too). Tolerances:
the registry's (``docs/OPS.md``; the f16 / bf16 accumulator rungs' atol of
0.5 to 32 is JAX's interpret mode summing in the narrow type, where the port
sums in f32 and rounds once); sums and dots at the ragged shapes 1e-2 + 1e-4
relative (``tests/test_reduce_boundary.py``'s bar: f32 sums in another
order); the max, int8 sums and histograms exactly; NMS keep masks exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import leetcuda_tpu.ops  # noqa: F401  (registers the JAX corpus)
from leetcuda_tpu.core.registry import OPS as JOPS
from leetcuda_tpu.core.testing import make_args as j_make_args
from leetcuda_tpu.ops import histogram as jhist
from leetcuda_tpu.ops import nms as jnms
from leetcuda_tpu.ops.dot_product import make_dot_product as j_dot
from leetcuda_tpu.ops.reduce import make_block_all_reduce_max as j_max
from leetcuda_tpu.ops.reduce import make_block_all_reduce_sum as j_sum
from leetcuda_tpu_torch.core.registry import OPS, load_all
from leetcuda_tpu_torch.core.runtime import launch_counts
from leetcuda_tpu_torch.core.testing import _from_f64, make_args
from leetcuda_tpu_torch.ops import dot_product as tdot
from leetcuda_tpu_torch.ops import flat
from leetcuda_tpu_torch.ops import histogram as thist
from leetcuda_tpu_torch.ops import nms as tnms
from leetcuda_tpu_torch.ops import reduce as tred

load_all()
FAMILIES = ("reduce", "dot-product", "histogram", "nms")
PORT_NAMES = sorted(n for n, s in OPS.items() if s.family in FAMILIES)
WITH_ORACLE = [n for n in PORT_NAMES if OPS[n].ref is not None]
COUNTERS = ("block_all_reduce_sum", "block_all_reduce_max", "dot_product",
            "histogram")
# ROADMAP's two row-ragged shapes, then tests/test_reduce_boundary.py's four
SHAPES = [(700, 4000), (1300, 2500), (300, 1500), (257, 1025), (100, 4000),
          (512, 1000)]
THRESHOLDS = (0.3, 0.5, 0.7)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bytes(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _np(a):
    """A tensor or JAX array as a float64 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a).astype(np.float64)


def _call_unchanged(fn, *args):
    """fn(*args), asserting that no argument was written (bit for bit)."""
    before = [a.clone() for a in args]
    out = fn(*args)
    for a, b in zip(args, before):
        np.testing.assert_array_equal(_bytes(a), _bytes(b))
    return out


def test_registry_names_match_jax():
    jax_names = sorted(n for n, s in JOPS.items() if s.family in FAMILIES)
    assert PORT_NAMES == jax_names
    assert len(PORT_NAMES) == 17 and len(WITH_ORACLE) == 16
    assert OPS["hard_nms"].ref is None and OPS["hard_nms"].tags == (
        "greedy",)


@pytest.mark.parametrize("name", WITH_ORACLE)
def test_registry_op_matches_jax(name):
    spec, jspec = OPS[name], JOPS[name]
    assert (spec.family, spec.tags, spec.atol, spec.rtol) == (
        jspec.family, jspec.tags, jspec.atol, jspec.rtol)
    args = make_args(spec, np.random.default_rng(0))
    jargs = j_make_args(jspec, np.random.default_rng(0))
    assert len(args) == len(jargs)
    for t, j in zip(args, jargs):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(_bytes(t), _bytes(j))
    got = _call_unchanged(spec.fn, *args)
    want = jspec.fn(*jargs)
    ref = spec.ref(*args)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=spec.atol,
                               rtol=spec.rtol)
    np.testing.assert_allclose(_np(ref), _np(got), atol=spec.atol,
                               rtol=spec.rtol)
    if spec.flops is not None:
        assert spec.flops(*args) == jspec.flops(*jargs)
        assert spec.bytes(*args) == jspec.bytes(*jargs)


def test_rungs():
    """Every registered rung takes its vector width from its name, and its
    (elements, load bytes) is one that its source instantiates."""
    for name in PORT_NAMES:
        spec = OPS[name]
        if spec.family == "nms":
            continue
        if spec.family == "histogram":
            assert spec.fn.vec == {"i32": 1, "i32x4": 4}[spec.tags[0]]
            continue
        size = make_args(spec, np.random.default_rng(0))[0].element_size()
        vec, lb = flat.rung_bytes(spec.fn.vec, spec.fn.pack, size)
        assert (vec, lb) in {(1, size), (2, min(16, 2 * size)),
                             (4, min(16, 4 * size)), (8, min(16, 8 * size)),
                             (8, 4)} | ({(16, 16)} if size == 1 else set())
    assert OPS["block_all_reduce_sum_f32x4_f32"].fn.vec == 4
    assert OPS["dot_prod_f16x8_pack_f32"].fn.pack
    assert OPS["block_all_reduce_sum_fp8_e4m3_f16"].fn.vec == 1
    # the top-level entries take one 16-byte word a step
    assert flat.rung_bytes(tred.block_all_reduce_sum_f32.vec, True, 1) == (
        16, 16)
    assert flat.rung_bytes(tdot.dot_product.vec, True, 2) == (8, 16)


@pytest.mark.parametrize("shape", SHAPES)
def test_sum_ragged(shape, rng):
    a = rng.normal(size=shape)
    x = _from_f64(a, torch.float32)
    got = _call_unchanged(tred.block_all_reduce_sum_f32, x)
    want = j_sum(jnp.float32)(jnp.asarray(a, jnp.float32))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(float(got), a.astype(np.float32).sum(
        dtype=np.float64), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("shape", SHAPES)
def test_max_all_negative_ragged(shape, rng):
    """An all-negative input: zeros from any unmasked padding would win."""
    a = -1.0 - np.abs(rng.normal(size=shape))
    x = _from_f64(a, torch.float32)
    got = _call_unchanged(tred.block_all_reduce_max_f32, x)
    want = j_max(jnp.float32)(jnp.asarray(a, jnp.float32))
    assert float(got) == float(want) == float(np.float32(a).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_dot_ragged(shape, rng):
    a, b = rng.normal(size=shape) * 0.1, rng.normal(size=shape) * 0.1
    x, y = _from_f64(a, torch.float32), _from_f64(b, torch.float32)
    got = _call_unchanged(tdot.dot_product, x, y)
    want = j_dot()(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("dt", ["f32", "f16", "bf16"])
def test_max_nan_and_empty(dt, rng):
    """A NaN anywhere makes the max NaN, as in the Pallas kernel; the max of
    no element is -inf; the accumulator dtype is the output's."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "f16": (torch.float16, jnp.float16),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dt]
    a = rng.normal(size=(300, 1500))
    a[123, 456] = np.nan
    got = tred.make_block_all_reduce_max(tdt)(_from_f64(a, tdt))
    want = j_max(jdt)(jnp.asarray(a, jdt))
    assert got.dtype == tdt and np.isnan(float(got)) and np.isnan(
        float(want))
    empty = tred.make_block_all_reduce_max(tdt)(torch.zeros(0, 4, dtype=tdt))
    assert float(empty) == -np.inf and empty.dtype == tdt


def test_sum_nan_and_e4m3_nan_bytes(rng):
    """NaN in an f32 sum, and e4m3's NaN bytes 0x7F and 0xFF in the e4m3
    sum, give NaN, as the Pallas kernel's sums do."""
    a = rng.normal(size=(64, 256))
    a[3, 7] = np.nan
    assert np.isnan(float(tred.block_all_reduce_sum_f32(
        _from_f64(a, torch.float32))))
    assert np.isnan(float(j_sum(jnp.float32)(jnp.asarray(a, jnp.float32))))
    spec = OPS["block_all_reduce_sum_fp8_e4m3_f16"]
    for byte in (0x7F, 0xFF):
        (x,) = make_args(spec, np.random.default_rng(0))
        x.view(torch.uint8)[10, 20] = byte
        jx = jnp.asarray(x.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
        got, want = spec.fn(x), JOPS[spec.name].fn(jx)
        assert got.dtype == torch.float16
        assert np.isnan(float(got)) and np.isnan(float(want))


def test_int8_sum_wraps():
    """An int8 sum past 2^31 wraps mod 2^32 in int32, as JAX's int32 sum
    does (127 x 8448 x 2048 = 2197815296 > 2^31 - 1)."""
    spec = OPS["block_all_reduce_sum_i8_i32"]
    a = np.full((8448, 2048), 127, np.int8)
    got = _call_unchanged(spec.fn, torch.from_numpy(a))
    want = JOPS[spec.name].fn(jnp.asarray(a))
    wrapped = (127 * a.size + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert got.dtype == torch.int32 and int(got) == int(want) == wrapped < 0


@pytest.mark.parametrize("suffix", ["f16_f16", "bf16_bf16", "fp8_e5m2_f16"])
def test_narrow_accumulators_round_once(suffix, rng):
    """The f16 / bf16 accumulator rungs hold the f32 sum rounded once (what
    the TPU computed, JAX's _kernel_acc_dtype): within one rounding of the
    float64 sum, where JAX's interpret mode (narrow-type accumulation)
    drifts by up to the registry's atol."""
    spec = OPS[f"block_all_reduce_sum_{suffix}"]
    (x,) = make_args(spec, rng)
    got = spec.fn(x)
    exact = x.double().sum()
    assert float((got.double() - exact).abs()) <= float(
        torch.finfo(got.dtype).eps * exact.abs() + 1e-6)


def test_histogram_out_of_range_like_the_pallas_kernel():
    """Values outside [0, bins) are dropped, as the Pallas kernel drops them
    (its one-hot compare never matches). JAX's registry oracle,
    ``jnp.bincount(length=)``, clamps a negative value into bin 0 instead,
    so it is not the bar here."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 128, (9, 130)).astype(np.int32)
    a[0, 0], a[4, 77], a[8, 129], a[2, 5] = -3, 200, 128, -1
    for spec in (OPS["histogram_i32"], OPS["histogram_i32x4"]):
        got = _call_unchanged(spec.fn, torch.from_numpy(a))
        want = np.asarray(JOPS[spec.name].fn(jnp.asarray(a)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == a.size - 4
    oracle = np.asarray(jhist._hist_ref_factory(128)(jnp.asarray(a)))
    assert oracle[0] == want[0] + 2  # the oracle clamps -3 and -1 into bin 0


def test_histogram_vocabulary_bins():
    """32000 bins (the model's vocabulary; 125 KB of shared memory a CTA on
    the card) against the Pallas kernel, values past either end dropped."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 32000, (8, 128)).astype(np.int32)
    a[0, :4] = [-5, 32000, 40000, 31999]
    got = thist.make_histogram(32000)(torch.from_numpy(a))
    want = np.asarray(jhist.make_histogram(32000)(jnp.asarray(a)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == a.size - 3 and got.shape == (32000,)


def _boxes(kind, n, rng):
    """Random boxes (float32), tied scores (a few distinct values),
    degenerate boxes (zero width or height, or x2 < x1) among random ones,
    or a chain: 32-wide boxes 4 apart in a row, scores falling along it
    (IoU 0.78 with the next box, 0.6 with the one after, 0.33 four on), so
    that each box's fate hangs on the boxes before it."""
    if kind == "chain":
        x = 4.0 * np.arange(n)
        b = np.stack([x, np.zeros(n), x + 32, np.full(n, 32.0)], 1)
        return b.astype(np.float32), (1.0 - np.arange(n) / n).astype(
            np.float32)
    c = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    b = np.concatenate([c, c + wh], 1)
    s = rng.uniform(size=n)
    if kind == "tied":
        s = rng.integers(0, 4, n) / 4.0
    if kind == "degenerate":
        b[::5, 2] = b[::5, 0]            # zero width
        b[1::7, 3] = b[1::7, 1] - 3.0    # y2 < y1
        b[2::9] = b[2::9, :1]            # a point
    return b.astype(np.float32), s.astype(np.float32)


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("kind", ["random", "tied", "degenerate",
                                  "chain"])
def test_nms_matches_jax(kind, threshold):
    """The keep mask and the kept indices (score order, -1 padding) equal
    JAX's ``nms`` / ``nms_indices`` and ``nms_ref``; the JAX oracle and the
    port's own ``nms_ref`` agree too."""
    rng = np.random.default_rng(7)
    b, s = _boxes(kind, 300, rng)
    tb, ts = torch.from_numpy(b), torch.from_numpy(s)
    keep = _call_unchanged(lambda b_, s_: tnms.nms(b_, s_, threshold), tb,
                           ts)
    want = np.asarray(jnms.nms(jnp.asarray(b), jnp.asarray(s), threshold))
    assert keep.dtype == torch.bool
    np.testing.assert_array_equal(keep.numpy(), want)
    np.testing.assert_array_equal(tnms.nms_ref(b, s, threshold), want)
    if kind != "tied":  # JAX's nms_ref sorts unstably; ties may reorder
        np.testing.assert_array_equal(jnms.nms_ref(b, s, threshold), want)
    for max_out in (None, 50, 400):
        got = tnms.nms_indices(tb, ts, threshold, max_out=max_out)
        jwant = np.asarray(jnms.nms_indices(jnp.asarray(b), jnp.asarray(s),
                                            threshold, max_out=max_out))
        np.testing.assert_array_equal(got.numpy(), jwant)


def test_nms_registration_and_small_cases():
    assert OPS["hard_nms"].fn is tnms.nms
    empty = tnms.nms(torch.zeros(0, 4), torch.zeros(0))
    assert empty.shape == (0,) and empty.dtype == torch.bool
    one = tnms.nms(torch.tensor([[0.0, 0, 1, 1]]), torch.tensor([0.3]))
    assert one.tolist() == [True]
    # a chain: 0 suppresses 1, so 2 (overlapping only 1) stays
    b = torch.tensor([[0.0, 0, 10, 10], [2, 0, 12, 10], [4, 0, 14, 10]])
    s = torch.tensor([0.9, 0.8, 0.7])
    assert tnms.nms(b, s, 0.5).tolist() == [True, False, True]
    assert tnms.nms_indices(b, s, 0.5).tolist() == [0, 2, -1]


def test_refusals():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="operates on"):
        tred.block_all_reduce_sum_f32(torch.zeros(8))
    with pytest.raises(ValueError, match="int8 x sums in int32"):
        tred.make_block_all_reduce_sum(torch.float32)(
            torch.zeros(4, 8, dtype=torch.int8))
    with pytest.raises(ValueError, match="int8 x sums in int32"):
        tred.make_block_all_reduce_sum(torch.int32)(x)
    with pytest.raises(ValueError, match="float accumulator"):
        tred.make_block_all_reduce_max(torch.int32)
    with pytest.raises(ValueError, match="must match"):
        tdot.dot_product(x, torch.zeros(4, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="int32"):
        thist.make_histogram(16)(torch.zeros(4, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="positive"):
        thist.make_histogram(0)
    # a device that is not the CPU takes the kernel, which refuses what it
    # does not take before any launch (the meta device stands in for CUDA)
    m = torch.empty(4, 8, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="kernel: takes"):
        tdot.dot_product(m, m)
    with pytest.raises(ValueError, match="kernel: takes"):
        tred.block_all_reduce_max_f32(m)


def test_cpu_runs_launch_nothing():
    """On CPU tensors every wrapper runs its plain version: no counter of
    the four kernels moves."""
    before = launch_counts()
    rng = np.random.default_rng(1)
    for name in WITH_ORACLE:
        OPS[name].fn(*make_args(OPS[name], rng))
    tred.block_all_reduce_max_f32(torch.zeros(3, 5))
    after = launch_counts()
    assert set(COUNTERS) <= set(after)
    assert all(after[c] == before[c] for c in COUNTERS)
