"""The port's op-corpus kernels (transpose, embedding gathers, RoPE, the
resident matmul chain) against the JAX package's.

On this CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels of ``csrc/transpose.cu``, ``csrc/embedding.cu``, ``csrc/rope.cu``
and ``csrc/matmul_resident.cu`` run on the GPU, held
against these same plain versions by ``chip_smoke.py`` path (l)); the JAX
kernels run in Pallas interpret mode, as ``tests/test_ops_registry.py`` runs
them. Inputs come from a numpy seed and go to both packages as the same
numbers (``core/testing.make_args`` byte for byte). Tolerances: the
registry's (``docs/OPS.md``) for the registered ops; transpose and
embedding exact (they move bits); RoPE 1e-4 (the registry's: cos and sin of
the same f32 angles in two libraries); the resident chain 1e-5 in f32
(``tests/test_gemm.py``'s bar, f32 sums in another order) and 2e-2 in bf16
(the registry's: a bf16 rounding each rep on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import leetcuda_tpu.ops  # noqa: F401  (registers the JAX corpus)
from leetcuda_tpu.core.registry import OPS as JOPS
from leetcuda_tpu.core.testing import make_args as j_make_args
from leetcuda_tpu.gemm.matmul import make_matmul_resident as j_resident
from leetcuda_tpu.gemm.matmul import matmul_chain_ref as j_chain_ref
from leetcuda_tpu.ops import embedding as jemb
from leetcuda_tpu.ops import rope as jrope
from leetcuda_tpu.ops import transpose as jtr
from leetcuda_tpu_torch.core.registry import OPS, load_all
from leetcuda_tpu_torch.core.runtime import launch_counts
from leetcuda_tpu_torch.core.testing import _from_f64, make_args
from leetcuda_tpu_torch.gemm import matmul as tmm
from leetcuda_tpu_torch.ops import embedding as temb
from leetcuda_tpu_torch.ops import rope as trope
from leetcuda_tpu_torch.ops import transpose as ttr

load_all()
FAMILIES = ("transpose", "embedding", "rope", "gemm-resident")
PORT_NAMES = sorted(n for n, s in OPS.items() if s.family in FAMILIES)
ORDERS = ("col2row", "row2col", "diagonal")
COUNTERS = ("transpose", "embedding", "embedding_tiled", "rope", "rope_lane",
            "matmul_resident")


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


def test_registry_names_match_jax():
    jax_names = sorted(n for n, s in JOPS.items() if s.family in FAMILIES)
    assert PORT_NAMES == jax_names
    assert len(PORT_NAMES) == 24


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
    assert got.dtype == ref.dtype and tuple(got.shape) == want.shape
    if spec.atol == 0:  # a gather or a transpose moves bits
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=spec.atol,
                                   rtol=spec.rtol)
    np.testing.assert_allclose(_np(ref), _np(got), atol=spec.atol,
                               rtol=spec.rtol)


def test_cpu_runs_launch_nothing():
    """On CPU tensors every wrapper runs its plain version: no counter of
    the six kernels moves."""
    before = launch_counts()
    for name in PORT_NAMES:
        OPS[name].fn(*make_args(OPS[name], np.random.default_rng(1)))
    after = launch_counts()
    assert set(COUNTERS) <= set(after)
    assert all(after[c] == before[c] for c in COUNTERS)


# --- transpose -----------------------------------------------------------------

def test_transpose_rungs():
    """Every registered rung maps to a variant that csrc/transpose.cu
    instantiates, in its registered walk order."""
    for name in PORT_NAMES:
        if OPS[name].family != "transpose":
            continue
        fn = OPS[name].fn
        assert fn.variant in ttr.VARIANTS and fn.order in ttr.ORDERS
        assert fn.order == OPS[name].tags[0]
    assert OPS["mat_transpose_f32_col2row2d"].fn.variant == "scalar"
    assert OPS["mat_transpose_cute_reg"].fn.variant == "reg"
    assert OPS["mat_transpose_cute_smem_swizzled"].fn.variant == "swizzled"
    assert OPS["mat_transpose_f32x4_shared_bcf_row2col2d"].fn.variant == (
        "shared_bcf")


@pytest.mark.parametrize("shape", [(1000, 3001), (3, 5)])
@pytest.mark.parametrize("order", ORDERS)
def test_transpose_ragged_f32(shape, order, rng):
    x = rng.standard_normal(shape)
    xt = _from_f64(x, torch.float32)
    got = _call_unchanged(ttr.make_transpose(order=order), xt)
    want = jtr.make_transpose(order=order)(jnp.asarray(x, jnp.float32))
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


@pytest.mark.parametrize("order", ORDERS)
def test_transpose_bf16(order, rng):
    x = rng.standard_normal((1000, 3001))
    got = _call_unchanged(ttr.make_transpose(order=order, variant="reg"),
                          _from_f64(x, torch.bfloat16))
    want = jtr.make_transpose(order=order)(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


def test_transpose_refusals():
    with pytest.raises(ValueError):
        ttr.make_transpose(order="spiral")
    with pytest.raises(ValueError):
        ttr.make_transpose(variant="tma")
    with pytest.raises(ValueError):
        ttr.mat_transpose(torch.zeros(2, 3, 4))


# --- embedding -----------------------------------------------------------------

@pytest.mark.parametrize("dtype,jdt", [(torch.float32, jnp.float32),
                                       (torch.bfloat16, jnp.bfloat16)])
def test_embedding_clamps_like_the_pallas_kernel(dtype, jdt, rng):
    """Ids below 0 or past V - 1 clamp to the table's ends, as the Pallas
    kernel's jnp.clip does (JAX's oracle, a jnp.take, does not clamp)."""
    V, D = 104, 256
    ids = np.concatenate([rng.integers(0, V, 20), [-1, -7, V, V + 50, 0,
                                                    V - 1]]).astype(np.int32)
    table = rng.standard_normal((V, D))
    tt, it = _from_f64(table, dtype), torch.from_numpy(ids)
    got = _call_unchanged(temb.embedding, it, tt)
    want = jemb.make_embedding()(jnp.asarray(ids), jnp.asarray(table, jdt))
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    np.testing.assert_array_equal(_bytes(got[20]), _bytes(tt[0]))
    np.testing.assert_array_equal(_bytes(got[23]), _bytes(tt[V - 1]))


@pytest.mark.parametrize("dtype,jdt", [(torch.float32, jnp.float32),
                                       (torch.bfloat16, jnp.bfloat16)])
def test_embedding_tiled_view(dtype, jdt, rng):
    """The serving layout is a view of the same bytes; the tiled gather and
    embedding_serving agree with JAX's tiled kernel, out-of-range ids
    included."""
    V, D = 104, 256
    ids = rng.integers(-5, V + 5, 12).astype(np.int32)
    table = rng.standard_normal((V, D))
    tt, it = _from_f64(table, dtype), torch.from_numpy(ids)
    view = temb.to_serving_layout(tt)
    assert view.shape == (V, D // 128, 128)
    assert view.data_ptr() == tt.data_ptr()
    got = _call_unchanged(temb.make_embedding_tiled(), it, view)
    want = jemb.make_embedding_tiled()(
        jnp.asarray(ids), jemb.to_serving_layout(jnp.asarray(table, jdt)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    got2 = _call_unchanged(temb.embedding_serving, it, tt)
    np.testing.assert_array_equal(_bytes(got2).ravel(), _bytes(want).ravel())


def test_embedding_int64_ids_and_nan_rows(rng):
    """int64 ids gather as int32 ids do; a NaN row (f16, any payload)
    arrives bit for bit."""
    V, D = 104, 128
    table = _from_f64(rng.standard_normal((V, D)), torch.float16)
    bits = table.view(torch.int16)
    bits[3, :4] = torch.tensor([0x7E01, 0x7C01, -0x01FF, 0x7FFF],
                               dtype=torch.int16)  # NaNs, distinct payloads
    ids = rng.integers(0, V, 40)
    ids[::5] = 3
    got64 = _call_unchanged(temb.embedding, torch.from_numpy(ids), table)
    got32 = temb.embedding(torch.from_numpy(ids.astype(np.int32)), table)
    np.testing.assert_array_equal(_bytes(got64), _bytes(got32))
    np.testing.assert_array_equal(_bytes(got64[::5]),
                                  _bytes(table[3].expand(8, D)))
    want = jemb.make_embedding()(jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(table.numpy()))
    np.testing.assert_array_equal(_bytes(got64), _bytes(want))


def test_embedding_refusals():
    table = torch.zeros(104, 200)
    with pytest.raises(ValueError):
        temb.to_serving_layout(table)  # D % 128 != 0
    with pytest.raises(ValueError):
        temb.embedding(torch.zeros(4), table)  # float ids
    with pytest.raises(ValueError):
        temb.make_embedding_tiled()(torch.zeros(4, dtype=torch.int32),
                                    torch.zeros(8, 2, 64))  # L != 128


# --- rope ----------------------------------------------------------------------

# Against the Pallas kernels: 1e-4 at 64 rows. Their frequencies,
# exp(i * -ln(theta) / half), differ from the oracle's theta^(-i / half) by
# up to 5.5e-7 relative in f32, and the angle multiplies that by the
# position: at row 999 up to 5.5e-4 rad, times |x| up to ~4 here, so 1000
# rows are held to the kernels at 2.5e-3 and to the oracle (whose
# frequencies the port uses) at 1e-4.
PALLAS_ROPE_TOL = {64: 1e-4, 1000: 2.5e-3}


@pytest.mark.parametrize("S", [64, 1000])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("lane", [False, True])
def test_rope_matches_pallas(S, D, lane, rng):
    x = rng.standard_normal((S, D))
    port, jax_fn = ((trope.make_rope_lane(), jrope.make_rope_lane()) if lane
                    else (trope.make_rope(pairs=2),
                          jrope.make_rope(rows_per_step=200)))
    got = _call_unchanged(port, _from_f64(x, torch.float32))
    want = jax_fn(jnp.asarray(x, jnp.float32))
    tol = PALLAS_ROPE_TOL[S]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(got), _np(jrope.rope_ref(jnp.asarray(x, jnp.float32))),
        atol=1e-4, rtol=1e-4)


def test_rope_bf16(rng):
    """bf16 in, bf16 out, computed in f32: one bf16 rounding off JAX's."""
    x = rng.standard_normal((256, 128))
    got = _call_unchanged(trope.rope, _from_f64(x, torch.bfloat16))
    want = jrope.rope_ref(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype,jdt,tol", [(torch.float32, jnp.float32, 1e-4),
                                           (torch.bfloat16, jnp.bfloat16,
                                            2e-2)])
def test_apply_rope_interleaved(dtype, jdt, tol, rng):
    """(B, S, H, D) with explicit, ragged positions per batch row."""
    B, S, H, D = 2, 48, 3, 64
    x = rng.standard_normal((B, S, H, D))
    pos = rng.integers(0, 5000, (B, S)).astype(np.int32)
    got = _call_unchanged(trope.apply_rope_interleaved,
                          _from_f64(x, dtype), torch.from_numpy(pos))
    want = jrope.apply_rope_interleaved(jnp.asarray(x, jdt), jnp.asarray(pos))
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_rope_refusals():
    with pytest.raises(ValueError):
        trope.rope(torch.zeros(4, 7))  # odd D
    with pytest.raises(ValueError):
        trope.rope(torch.zeros(2, 4, 8))


# --- the resident chain --------------------------------------------------------

@pytest.mark.parametrize("reps", [1, 4])
@pytest.mark.parametrize("dtype,jdt,tol", [(torch.float32, jnp.float32, 1e-5),
                                           (torch.bfloat16, jnp.bfloat16,
                                            2e-2)])
def test_matmul_resident_chain(reps, dtype, jdt, tol, rng):
    M = 256  # a at unit scale, b at M^-0.5: every rep's output has RMS ~1
    a = rng.standard_normal((M, M))
    b = rng.standard_normal((M, M)) / np.sqrt(M)
    got = _call_unchanged(tmm.make_matmul_resident(reps=reps),
                          _from_f64(a, dtype), _from_f64(b, dtype))
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    want = j_resident(reps=reps, block_m=128)(ja, jb)
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(got), _np(j_chain_ref(ja, jb, reps)), atol=tol,
        rtol=tol)


def test_matmul_resident_refuses_non_square_b():
    fn = tmm.make_matmul_resident(reps=2)
    with pytest.raises(ValueError, match="square"):
        fn(torch.zeros(8, 16), torch.zeros(16, 8))
    with pytest.raises(ValueError, match="square"):
        fn(torch.zeros(8, 16), torch.zeros(8, 8))
    with pytest.raises(AssertionError):
        j_resident(reps=2)(jnp.zeros((8, 16)),
                                         jnp.zeros((16, 8)))
    with pytest.raises(ValueError):
        tmm.make_matmul_resident(reps=0)
