"""The port's row ops (rms-norm, layer-norm with its backward, the three
softmax forms), merge_attn_states and split-KV attention against the JAX
package's.

On this CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels of ``csrc/row_ops.cu`` and ``csrc/merge_attn.cu`` run on the GPU,
held against these same plain versions by ``chip_smoke.py`` path (k)); the
JAX kernels run in Pallas interpret mode, as ``tests/test_ops_registry.py``
runs them. Inputs come from a numpy seed and go to both packages as the same
numbers (``core/testing.make_args`` byte for byte). Tolerances are the
registry's (``docs/OPS.md``) for the registered rungs; elsewhere 1e-5 in f32
(f32 statistics summed in another order) and 2e-2 in f16 (one f16 rounding
of outputs of magnitude up to ~4 on each side), and the layer-norm
gradients' 1e-4 of ``tests/test_tooling.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import leetcuda_tpu.ops  # noqa: F401  (registers the JAX corpus)
from leetcuda_tpu.attention.splitkv import (
    flash_attention_splitkv as j_splitkv)
from leetcuda_tpu.core.registry import OPS as JOPS
from leetcuda_tpu.core.testing import make_args as j_make_args
from leetcuda_tpu.ops import layer_norm as jln
from leetcuda_tpu.ops import merge_attn_states as jmerge
from leetcuda_tpu.ops import rms_norm as jrms
from leetcuda_tpu.ops import softmax as jsm
from leetcuda_tpu_torch.attention import flash_attention_splitkv
from leetcuda_tpu_torch.attention.flash import flash_attention_plain
from leetcuda_tpu_torch.core.registry import OPS, load_all
from leetcuda_tpu_torch.core.testing import _from_f64, make_args
from leetcuda_tpu_torch.ops import layer_norm as tln
from leetcuda_tpu_torch.ops import merge_attn_states as tmerge
from leetcuda_tpu_torch.ops import rms_norm as trms
from leetcuda_tpu_torch.ops import rowwise
from leetcuda_tpu_torch.ops import softmax as tsm

load_all()
FAMILIES = ("softmax", "layer-norm", "rms-norm", "attention-utils")
PORT_NAMES = sorted(n for n, s in OPS.items() if s.family in FAMILIES)
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "f16": (torch.float16, jnp.float16, 2e-2)}
SHAPES = [(100, 1000), (64, 4001), (700, 4000)]
# (the port's callable, the JAX callable, number of (K,) weight vectors)
FORMS = {
    "rms_norm": (trms.rms_norm, jrms.rms_norm, 1),
    "layer_norm": (tln.layer_norm, jln.layer_norm, 2),
    "softmax": (tsm.make_softmax(), jsm.make_softmax(), 0),
    "safe_softmax": (tsm.softmax, jsm.softmax, 0),
    "online_softmax": (tsm.online_softmax, jsm.online_softmax, 0),
}


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
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _call_unchanged(fn, *args):
    """fn(*args), asserting that no argument was written."""
    before = [a.clone() for a in args]
    out = fn(*args)
    for a, b in zip(args, before):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    return out


def _pair(a, tdt, jdt):
    """A float64 array as (tensor, JAX array), both rounded once to the
    dtype."""
    return _from_f64(a, tdt), jnp.asarray(a, jdt)


def test_registry_names_match_jax():
    jax_names = sorted(n for n, s in JOPS.items() if s.family in FAMILIES)
    assert PORT_NAMES == jax_names
    assert len(PORT_NAMES) == 27


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
    if not isinstance(got, tuple):
        got, want, ref = (got,), (want,), (ref,)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == r.dtype and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=spec.atol,
                                   rtol=spec.rtol)
        np.testing.assert_allclose(_np(r), _np(g), atol=spec.atol,
                                   rtol=spec.rtol)


def test_rungs():
    """Each registered rung's elements a thread and load width: the vector
    in its name, one 16-byte load for a pack, 4-byte loads for unpacked
    8-wide rungs; every pair one that csrc/row_ops.cu instantiates."""
    assert rowwise.rung("f32") == {"vec": 1, "pack": False}
    assert rowwise.rung("f16x8_pack_f32") == {"vec": 8, "pack": True}
    assert rowwise.rung("f16x2_f16") == {"vec": 2, "pack": False}
    built = {4: {(1, 4), (2, 8), (4, 16), (8, 4), (8, 16)},
             2: {(1, 2), (2, 4), (4, 8), (8, 4), (8, 16)}}
    for name in PORT_NAMES:
        if OPS[name].family == "attention-utils":
            continue
        r = rowwise.rung(name)
        for size, pairs in built.items():
            assert (r["vec"], rowwise.load_bytes(r["vec"], r["pack"],
                                                 size)) in pairs
    assert rowwise.threads_for(2050, 8) == 256
    assert rowwise.threads_for(24, 8) == 32


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("form", list(FORMS))
def test_form_matches_jax(form, shape, dt, rng):
    tdt, jdt, tol = DTYPES[dt]
    tfn, jfn, n_vec = FORMS[form]
    S, K = shape
    arrays = [rng.standard_normal((S, K))]
    arrays += [rng.standard_normal(K) * 0.5 + 1.0 for _ in range(n_vec)]
    pairs = [_pair(a, tdt, jdt) for a in arrays]
    got = _call_unchanged(tfn, *(t for t, _ in pairs))
    want = jfn(*(j for _, j in pairs))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("K", [1024, 1000])
def test_online_softmax_chunked_and_whole_row(K, rng):
    """K a multiple of the JAX kernel's 128-column chunk (it walks chunks)
    and not (it takes the whole row); every port rung agrees."""
    t, j = _pair(rng.standard_normal((64, K)) * 4, torch.float32,
                 jnp.float32)
    want = _np(jsm.make_online_softmax(chunk=128)(j))
    for fn in (tsm.online_softmax, OPS["online_safe_softmax_f32"].fn,
               OPS["online_safe_softmax_f32x4_pack"].fn):
        np.testing.assert_allclose(_np(_call_unchanged(fn, t)), want,
                                   atol=1e-6, rtol=1e-5)


def test_layer_norm_rows_with_large_mean(rng):
    """Rows offset by 1e3: the variance as the mean of squared deviations
    (E[x^2] - mean^2 cancels: ~0.06 of error in a variance of 1 in f32).
    Each package's f32 mean carries ~1e-4 of rounding at 1e3, so both are
    held at 2e-3, to each other and to the float64 result."""
    a = rng.standard_normal((64, 1000)) + 1e3
    g, b = rng.standard_normal(1000) * 0.5 + 1, rng.standard_normal(1000)
    x, jx = _pair(a, torch.float32, jnp.float32)
    (tg, jg), (tb, jb) = _pair(g, torch.float32, jnp.float32), _pair(
        b, torch.float32, jnp.float32)
    got = _np(_call_unchanged(tln.layer_norm, x, tg, tb))
    np.testing.assert_allclose(got, _np(jln.layer_norm(jx, jg, jb)),
                               atol=2e-3, rtol=2e-3)
    xf = np.asarray(x, np.float64)
    exact = ((xf - xf.mean(-1, keepdims=True))
             / np.sqrt(xf.var(-1, keepdims=True) + 1e-5)
             * np.asarray(tg, np.float64) + np.asarray(tb, np.float64))
    np.testing.assert_allclose(got, exact, atol=2e-3, rtol=2e-3)


def test_naive_softmax_overflows_as_jax(rng):
    """The naive form subtracts no max: a row with x > 88 gives NaN where
    exp overflows and 0 elsewhere, in both packages."""
    a = rng.standard_normal((4, 256))
    a[1, 7] = 100.0
    a[2, :3] = 95.0
    t, j = _pair(a, torch.float32, jnp.float32)
    got = _np(_call_unchanged(tsm.make_softmax(), t))
    want = _np(jsm.make_softmax()(j))
    assert np.isnan(got[1, 7]) and np.isnan(got[2, :3]).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5,
                               equal_nan=True)


@pytest.mark.parametrize("dt,tol", [("f32", 1e-4), ("f16", 2e-2)])
def test_layer_norm_trainable_grads_match_jax(dt, tol):
    tdt, jdt, _ = DTYPES[dt]
    rng = np.random.default_rng(0)
    S, K = 64, 256
    arrays = (rng.normal(size=(S, K)), rng.normal(size=(K,)) + 1.0,
              rng.normal(size=(K,)), rng.normal(size=(S, K)))
    (x, jx), (g, jg), (b, jb), (dy, jdy) = (_pair(a, tdt, jdt)
                                            for a in arrays)

    def loss(x, g, b):
        return jnp.sum(jln.layer_norm_trainable(x, g, b).astype(jnp.float32)
                       * jdy.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jx, jg, jb)
    leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
    y = tln.layer_norm_trainable(*leaves)
    y.backward(dy)
    for leaf, src in zip(leaves, (x, g, b)):
        assert torch.equal(leaf.detach(), src)
    for leaf, w, name in zip(leaves, want, "x g b".split()):
        assert leaf.grad.dtype == tdt, name
        np.testing.assert_allclose(_np(leaf.grad), _np(w), atol=tol,
                                   rtol=tol, err_msg=name)
    # the plain backward against autograd through the plain forward
    auto = [t.clone().float().requires_grad_(True) for t in (x, g, b)]
    tln.layer_norm_plain(*auto).backward(dy.float())
    for got, a in zip(tln.layer_norm_bwd_plain(x.float(), g.float(),
                                               dy.float()), auto):
        np.testing.assert_allclose(_np(got), _np(a.grad), atol=1e-4,
                                   rtol=1e-4)


MERGE_CASES = {
    "finite": lambda p, s: (p, s),
    "prefix empty": lambda p, s: (np.full_like(p, -np.inf), s),
    "suffix empty": lambda p, s: (p, np.full_like(s, np.inf)),
    "both empty": lambda p, s: (np.full_like(p, -np.inf),
                                np.full_like(s, -np.inf)),
    "nan": lambda p, s: (np.where(np.arange(p.size).reshape(p.shape) % 3 == 0,
                                  np.nan, p), s),
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_attn_states_matches_jax(case, rng):
    T, H, D = 16, 4, 64
    po, so = rng.standard_normal((T, H, D)), rng.standard_normal((T, H, D))
    pl, sl = MERGE_CASES[case](rng.standard_normal((T, H)),
                               rng.standard_normal((T, H)))
    args = [_pair(a, torch.float32, jnp.float32) for a in (po, pl, so, sl)]
    out, lse = _call_unchanged(tmerge.merge_attn_states,
                               *(t for t, _ in args))
    jout, jlse = jmerge.merge_attn_states(*(j for _, j in args))
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert np.isfinite(_np(out)).all() and np.isfinite(_np(lse)).all()
    np.testing.assert_allclose(_np(out), _np(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=1e-5, rtol=1e-5)
    if case == "both empty":  # the average of the two, lse -1e30 in f32
        np.testing.assert_allclose(_np(out), (po + so) / 2, atol=1e-6)
        assert (_np(lse) == np.float32(-1e30)).all()


def test_merge_attn_states_dtype_and_layout(rng):
    """The output takes the prefix's dtype, the lse is f32; a strided
    token-major view merges as its contiguous copy."""
    T, H, D = 8, 4, 64
    po = torch.from_numpy(rng.standard_normal((H, T, D))).to(
        torch.bfloat16).transpose(0, 1)
    so = torch.from_numpy(rng.standard_normal((T, H, D))).to(torch.bfloat16)
    pl, sl = (torch.from_numpy(rng.standard_normal((T, H))).float()
              for _ in range(2))
    out, lse = _call_unchanged(tmerge.merge_attn_states, po, pl, so, sl)
    want_o, want_l = tmerge.merge_attn_states_plain(po.contiguous(), pl, so,
                                                    sl)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, want_o) and torch.equal(lse, want_l)
    with pytest.raises(ValueError):
        tmerge.merge_attn_states(po, pl[:, :2], so, sl)


@pytest.mark.parametrize("hkv", [2, 1])
@pytest.mark.parametrize("num_splits", [2, 4])
def test_splitkv_matches_jax(num_splits, hkv, rng):
    B, H, N, D = 1, 2, 256, 64
    arrays = (rng.standard_normal((B, H, N, D)),
              rng.standard_normal((B, hkv, N, D)),
              rng.standard_normal((B, hkv, N, D)))
    (q, jq), (k, jk), (v, jv) = (_pair(a, torch.float32, jnp.float32)
                                 for a in arrays)
    got = _call_unchanged(lambda *a: flash_attention_splitkv(
        *a, num_splits=num_splits, block_q=128, block_k=128), q, k, v)
    want = j_splitkv(jq, jk, jv, num_splits=num_splits, block_q=128,
                     block_k=128)
    assert tuple(got.shape) == (B, H, N, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(got), _np(flash_attention_plain(q, k, v)),
                               atol=1e-5, rtol=1e-5)


def test_splitkv_decode_rows_and_refusal(rng):
    """One query row a sequence (decode) over B = 2, and the refusal of a
    split that does not divide the keys (JAX asserts it)."""
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 64))).float()
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 96, 64))).float()
            for _ in range(2))
    got = flash_attention_splitkv(q, k, v, num_splits=3)
    np.testing.assert_allclose(_np(got), _np(flash_attention_plain(q, k, v)),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        flash_attention_splitkv(q, k, v, num_splits=5)
    with pytest.raises(AssertionError):
        j_splitkv(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                  jnp.asarray(v.numpy()), num_splits=5)


def test_refusals():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        trms.rms_norm(x.reshape(-1), torch.ones(8))
    with pytest.raises(ValueError):
        tln.layer_norm(x, torch.ones(7), torch.ones(8))
    with pytest.raises(ValueError):
        tsm.softmax(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        tln.layer_norm_bwd(x, torch.ones(8), torch.zeros(4, 7))
