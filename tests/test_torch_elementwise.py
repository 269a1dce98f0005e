"""The port's elementwise add and activations against the JAX package's.

On this CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernel ``lc_elementwise`` of ``csrc/elementwise.cu`` runs on the GPU, held
against these same plain versions by ``chip_smoke.py`` path (m)); the JAX
kernels run in Pallas interpret mode, as ``tests/test_ops_registry.py``
runs them. Inputs come from a numpy seed and go to both packages as the
same numbers (``core/testing.make_args`` byte for byte). Tolerances: the
add bit for bit (one correctly rounded f32 sum, rounded once to the storage
type, on both sides); the activations at the registry's (``docs/OPS.md``:
1e-5 in f32, where the two libraries' exp and tanh differ by an ulp or two;
2e-2 / 1e-2 in f16 and bf16, a rounding of the storage type).
"""

import operator

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import leetcuda_tpu.ops  # noqa: F401  (registers the JAX corpus)
from leetcuda_tpu.core.registry import OPS as JOPS
from leetcuda_tpu.core.testing import make_args as j_make_args
from leetcuda_tpu.ops import activations as jact
from leetcuda_tpu.ops import elementwise as jew
from leetcuda_tpu_torch.core.registry import OPS, load_all
from leetcuda_tpu_torch.core.runtime import launch_counts
from leetcuda_tpu_torch.core.testing import _from_f64, make_args
from leetcuda_tpu_torch.ops import activations as tact
from leetcuda_tpu_torch.ops import elementwise as tew
from leetcuda_tpu_torch.ops import flat

load_all()
FAMILIES = ("elementwise", "activation")
PORT_NAMES = sorted(n for n, s in OPS.items() if s.family in FAMILIES)
COUNTERS = ("elementwise_add", "activation")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "f16": (torch.float16, jnp.float16),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# NaN, infinities, signed zeros and the points where an activation changes
# form (the sigmoid clamp at 88, hardswish's knees, hardshrink's lambda)
SPECIALS = (np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 0.25,
            3.0, -3.0, 6.0, -6.0, 88.0, 88.5, -88.0, -88.5, 100.0, -100.0,
            1e30, -1e30, 1e-30, -1e-30)
RAGGED = [(3, 130), (67, 1031), (1, 1)]


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
    """A tensor or JAX array as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _call_unchanged(fn, *args):
    """fn(*args), asserting that no argument was written (bit for bit)."""
    before = [a.clone() for a in args]
    out = fn(*args)
    for a, b in zip(args, before):
        np.testing.assert_array_equal(_bytes(a), _bytes(b))
    return out


def _pair(a, dt):
    """A float64 array as the same numbers in both packages."""
    tdt, jdt = DTYPES[dt]
    t = _from_f64(a, tdt)
    return t, jnp.asarray(a, jdt)


def test_registry_names_match_jax():
    jax_names = sorted(n for n, s in JOPS.items() if s.family in FAMILIES)
    assert PORT_NAMES == jax_names
    assert len(PORT_NAMES) == 120


@pytest.mark.parametrize("name", PORT_NAMES)
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
    assert got.dtype == args[0].dtype == ref.dtype
    assert tuple(got.shape) == want.shape
    if spec.family == "elementwise":
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=spec.atol,
                                   rtol=spec.rtol)
    np.testing.assert_allclose(_np(ref), _np(got), atol=spec.atol,
                               rtol=spec.rtol)
    assert spec.flops(*args) == jspec.flops(*jargs)
    assert spec.bytes(*args) == jspec.bytes(*jargs)


def test_rungs():
    """Every registered rung takes the reference ladder's vector width
    (elements a thread, packed or not) from its name, and its (elements, load
    bytes) is one that csrc/elementwise.cu instantiates for its dtype."""
    for name in PORT_NAMES:
        spec = OPS[name]
        dt, rung = spec.tags[-2], spec.tags[-1]
        want = {"naive": (1, False), "x2": (2, False), "x4": (4, False),
                "x8": (8, False), "x8_pack": (8, True)}[rung]
        assert (spec.fn.vec, spec.fn.pack) == want
        size = DTYPES[dt][0].itemsize
        vec, lb = flat.rung_bytes(spec.fn.vec, spec.fn.pack, size)
        assert (vec, lb) in {(1, size), (2, 2 * size),
                             (4, min(16, 4 * size)), (8, 4), (8, 16)}
        if spec.family == "activation":
            assert spec.fn.activation == spec.tags[0]
    assert flat.rung_bytes(8, False, 2) == (8, 4)  # the reference's half2
    assert flat.rung_bytes(8, True, 2) == (8, 16)
    assert flat.rung_bytes(4, False, 4) == (4, 16)
    assert tact.OP_CODES == {"relu": 1, "sigmoid": 2, "gelu": 3, "swish": 4,
                             "elu": 5, "hardswish": 6, "hardshrink": 7}


@pytest.mark.parametrize("shape", RAGGED)
def test_add_ragged(shape, rng):
    a, b = rng.standard_normal(shape), rng.standard_normal(shape)
    for dt in DTYPES:
        (x, jx), (y, jy) = _pair(a, dt), _pair(b, dt)
        got = _call_unchanged(tew.elementwise_add_f32, x, y)
        np.testing.assert_array_equal(
            _bytes(got), _bytes(jew.elementwise_add_f32(jx, jy)))


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("act", sorted(tact.ACTIVATIONS))
def test_activation_ragged(act, shape, rng):
    a = rng.standard_normal(shape) * 4
    for dt, (tdt, _) in DTYPES.items():
        x, jx = _pair(a, dt)
        got = _call_unchanged(getattr(tact, act), x)
        want = getattr(jact, act)(jx)
        assert got.dtype == tdt and tuple(got.shape) == shape
        tol = (dict(atol=1e-5, rtol=1e-5) if dt == "f32"
               else dict(atol=2e-2, rtol=1e-2))
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def _specials(dt):
    s = np.asarray(SPECIALS)
    return _pair(np.broadcast_to(s[:, None], (len(s), len(s))).copy(), dt), \
        _pair(np.broadcast_to(s[None, :], (len(s), len(s))).copy(), dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_add_specials(dt):
    """NaN, infinities and signed zeros through the add: bit for bit with
    the Pallas kernel, NaN at the same places."""
    (x, jx), (y, jy) = _specials(dt)
    got = tew.elementwise_add_f32(x, y)
    want = jew.elementwise_add_f32(jx, jy)
    nan = np.isnan(_np(want))
    np.testing.assert_array_equal(np.isnan(_np(got)), nan)
    np.testing.assert_array_equal(_np(got)[~nan], _np(want)[~nan])
    np.testing.assert_array_equal(np.signbit(_np(got))[~nan],
                                  np.signbit(_np(want))[~nan])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", sorted(tact.ACTIVATIONS))
def test_activation_specials(act, dt):
    """NaN, infinities and signed zeros through each activation against the
    Pallas kernel: NaN where it gives NaN (relu, sigmoid, elu and hardswish
    pass NaN through; hardshrink maps it to 0), equal elsewhere at the
    registry's tolerance. One difference is the reference's arithmetic, not
    the port's: XLA flushes f32 denormals to zero (on the CPU as on the
    TPU), so JAX's sigmoid below -87.3 is 0 and its swish(-inf) is
    -inf * 0 = NaN; the port keeps IEEE denormals (nvcc's default, as
    torch's own kernels do): sigmoid(-88) = 6.05e-39 and swish(-inf) =
    -inf."""
    (x, jx), _ = _specials(dt)
    got = _call_unchanged(getattr(tact, act), x)
    want = getattr(jact, act)(jx)
    nan = np.isnan(_np(want))
    ftz = np.isneginf(_np(x)) if act == "swish" else np.zeros_like(nan)
    np.testing.assert_array_equal(np.isnan(_np(got)), nan & ~ftz)
    assert np.isneginf(_np(got)[ftz]).all()
    tol = (dict(atol=1e-5, rtol=1e-5) if dt == "f32"
           else dict(atol=2e-2, rtol=1e-2))
    np.testing.assert_allclose(_np(got)[~nan], _np(want)[~nan], **tol)
    row = _np(got)[0]  # the NaN row
    if act == "hardshrink":
        assert (row == 0).all()
    else:
        assert np.isnan(row).all()
    if act in ("sigmoid", "swish") and dt != "f16":
        (i,) = np.nonzero(np.asarray(SPECIALS) == -88.0)
        assert _np(got)[i, 0] != 0 and _np(want)[i, 0] == 0


def test_refusals():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="operates on"):
        tew.elementwise_add_f32(torch.zeros(8), torch.zeros(8))
    with pytest.raises(ValueError, match="operates on"):
        tact.relu(torch.zeros(2, 4, 8))
    with pytest.raises(ValueError, match="must match"):
        tew.elementwise_add_f32(x, torch.zeros(4, 9))
    with pytest.raises(ValueError, match="must match"):
        tew.elementwise_add_f32(x, torch.zeros(4, 8, dtype=torch.float16))
    # a device that is not the CPU takes the kernel: only the add has one
    # (the meta device stands in for a CUDA tensor; nothing is launched)
    m = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="only the add"):
        tew.make_elementwise_binary(operator.mul)(m, m)
    with pytest.raises(ValueError, match="none of"):
        tact.make_activation(torch.tanh)(m)
    with pytest.raises(ValueError, match="kernel: takes"):
        tew.elementwise_add_f32(m.to(torch.float64), m.to(torch.float64))


def test_other_ops_run_plain_on_cpu(rng):
    """An op without a kernel still runs on CPU tensors, as plain torch in
    x's dtype (the JAX factory takes any jnp callable)."""
    x, y = (_from_f64(rng.standard_normal((5, 7)), torch.float16)
            for _ in range(2))
    got = tew.make_elementwise_binary(operator.mul)(x, y)
    assert got.dtype == torch.float16 and torch.equal(got, x * y)
    got = tact.make_activation(torch.tanh)(x)
    assert torch.equal(got, torch.tanh(x.float()).half())


def test_cpu_runs_launch_nothing():
    """On CPU tensors every wrapper runs its plain version: no counter of
    the two kernels moves."""
    before = launch_counts()
    for name in PORT_NAMES:
        OPS[name].fn(*make_args(OPS[name], np.random.default_rng(1)))
    after = launch_counts()
    assert set(COUNTERS) <= set(after)
    assert all(after[c] == before[c] for c in COUNTERS)
