"""The port's chunk attention against the JAX package's.

On this CPU the wrappers of ``leetcuda_tpu_torch/attention/chunk.py`` run
their plain PyTorch versions (the CUDA kernel is held against these same
plain versions by ``chip_smoke.py``) and the JAX kernels run in Pallas
interpret mode with ``block_k=128``, as the JAX package's own tests and its
registry run them. Inputs come from a numpy seed. f32 cases are held at
atol 1e-5 (the same algorithm in the same precision, differing in summation
order), the bf16 case at the registry's atol/rtol 2e-2
(``leetcuda_tpu/attention/chunk.py:346``).

Both sides get the same poisoned caches: every position at or past
``base + T`` holds NaN values and NaN scales (e4m3: the NaN byte 0x7F) and,
paged, so do page 0, every unowned page and the tail of each last page. The
oracle ``chunk_attention_ref`` masks with -inf and does not survive NaN in
V, so it is compared on finite caches only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.attention.chunk import (chunk_attention_ref,
                                          make_chunk_attention,
                                          make_paged_chunk_attention)
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.attention import chunk as ck
from leetcuda_tpu_torch.attention.decode import (
    decode_attention_plain, decode_attention_quantized_plain)
from leetcuda_tpu_torch.core.runtime import launch_counts
from leetcuda_tpu_torch.models.convert import params_from_numpy

_QDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
S, D, PAGE = 256, 64, 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _poison(arrays, dead):
    """NaN (e4m3: the NaN byte; int8: 0) wherever ``dead`` (leading dims of
    each array) is set, in place, on numpy arrays."""
    for a in arrays:
        if a.dtype.name == "float8_e4m3fn":
            a.view(np.uint8)[dead] = 0x7F
        elif a.dtype == np.int8:
            a[dead] = 0
        else:
            a[dead] = np.nan


def _case(seed, T, group, bases, fmt=None, paged=False, dtype=np.float32,
          poison=True):
    """Seeded q and caches; returns (numpy args in the JAX order, the same as
    tensors). Contiguous: (q, k, v, [ks, vs,] base); paged: (q, k_pages,
    v_pages, [k_scales, v_scales,] page_table, base)."""
    rng = np.random.default_rng(seed)
    bases = np.asarray(bases, np.int32)
    B, Hkv = len(bases), 2
    H = Hkv * group
    q = rng.standard_normal((B, H, T, D), dtype=np.float32)
    caches = [rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
              for _ in range(2)]
    if fmt is not None:
        quant = [jl._quantize_token_kv(jnp.asarray(c), _QDT[fmt])
                 for c in caches]
        caches = [np.array(quant[0][0]), np.array(quant[1][0]),
                  np.array(quant[0][1]), np.array(quant[1][1])]
    elif dtype is not np.float32:
        q = np.asarray(jnp.asarray(q, dtype))
        caches = [np.array(jnp.asarray(c, dtype)) for c in caches]
    end = np.minimum(bases + T, S)
    dead = np.arange(S)[None, :] >= end[:, None]                  # (B, S)
    if poison:
        _poison(caches, np.broadcast_to(dead[:, None, :], (B, Hkv, S)))
    tail = [bases]
    if paged:
        P, N = S // PAGE, B * (S // PAGE) + 1
        table = np.zeros((B, P), np.int32)
        phys = rng.permutation(np.arange(1, N))
        pools = [np.empty((N, Hkv, PAGE) + c.shape[3:], c.dtype)
                 for c in caches]
        if poison:
            _poison(pools, np.ones((N, Hkv, PAGE), bool))
        else:
            for pool in pools:
                pool[...] = 0
        n = 0
        for b in range(B):
            for i in range(-(-int(end[b]) // PAGE)):
                table[b, i] = phys[n]
                for pool, c in zip(pools, caches):
                    pool[phys[n]] = c[b, :, i * PAGE:(i + 1) * PAGE]
                n += 1
        caches, tail = pools, [table, bases]
    args = [q, *caches, *tail]
    return args, params_from_numpy(args, "cpu")


def _jax(fn, args):
    return np.asarray(fn(*(jnp.asarray(a) for a in args)), np.float32)


CASES = {
    "T=1 group 4": dict(T=1, group=4, bases=[0, 77, 255]),
    "T=2 group 1": dict(T=2, group=1, bases=[5, 128, 254]),
    "T=5 group 4": dict(T=5, group=4, bases=[0, 126, 251]),
    "T=128 group 4": dict(T=128, group=4, bases=[0, 100]),
    "T=5 int8": dict(T=5, group=4, bases=[0, 126, 251], fmt="int8"),
    "T=5 fp8": dict(T=5, group=4, bases=[3, 60, 200], fmt="fp8"),
    "T=5 window 32": dict(T=5, group=4, bases=[0, 126, 251], window=32),
    "T=128 window 40": dict(T=128, group=1, bases=[0, 100], window=40),
    "paged T=5": dict(T=5, group=4, bases=[0, 126, 251], paged=True),
    "paged T=2 int8": dict(T=2, group=1, bases=[15, 16, 250], fmt="int8",
                           paged=True),
    "paged T=128 fp8": dict(T=128, group=4, bases=[16, 100], fmt="fp8",
                            paged=True),
    "paged T=5 window 32": dict(T=5, group=4, bases=[0, 126, 251],
                                paged=True, window=32),
    # the softcap, alone and with a window, on every cache layout
    "T=5 cap 0.5": dict(T=5, group=4, bases=[0, 126, 251], softcap=0.5),
    "T=128 cap 30 window 40": dict(T=128, group=1, bases=[0, 100],
                                   window=40, softcap=30.0),
    "T=5 int8 cap 0.5 window 32": dict(T=5, group=4, bases=[0, 126, 251],
                                       fmt="int8", window=32, softcap=0.5),
    "T=5 fp8 cap 30": dict(T=5, group=4, bases=[3, 60, 200], fmt="fp8",
                           softcap=30.0),
    "paged T=5 cap 0.5 window 32": dict(T=5, group=4, bases=[0, 126, 251],
                                        paged=True, window=32, softcap=0.5),
    "paged T=128 fp8 cap 0.5": dict(T=128, group=4, bases=[16, 100],
                                    fmt="fp8", paged=True, softcap=0.5),
    "paged T=2 int8 cap 30 window 16": dict(T=2, group=1,
                                            bases=[15, 16, 250], fmt="int8",
                                            paged=True, window=16,
                                            softcap=30.0),
}


def _wrapper(fmt, paged):
    return {(False, False): ck.chunk_attention,
            (True, False): ck.chunk_attention_quantized,
            (False, True): ck.paged_chunk_attention,
            (True, True): ck.paged_chunk_attention_quantized}[
                (fmt is not None, paged)]


@pytest.mark.parametrize("name", list(CASES))
def test_chunk_attention_matches_pallas(name):
    """f32, NaN wherever no row of the chunk looks: atol 1e-5."""
    case = dict(CASES[name])
    window, softcap = case.pop("window", None), case.pop("softcap", None)
    fmt, paged = case.get("fmt"), case.get("paged", False)
    jargs, targs = _case(len(name), **case)
    make = (make_paged_chunk_attention if paged else
            lambda **kw: make_chunk_attention(block_k=128, **kw))
    want = _jax(make(window=window, quantized=fmt is not None,
                     softcap=softcap), jargs)
    before = launch_counts()
    got = _wrapper(fmt, paged)(*targs, window=window,
                               softcap=softcap).numpy()
    assert launch_counts() == before  # the plain version runs on CPU tensors
    assert np.all(np.isfinite(want)) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_chunk_attention_bf16_matches_pallas():
    """bf16 q and cache at the registry's tolerance (2e-2): the two sides
    round the output to bf16 from sums taken in different orders."""
    jargs, targs = _case(1, T=5, group=4, bases=[0, 126, 251],
                         dtype=jnp.bfloat16)
    want = _jax(make_chunk_attention(block_k=128), jargs)
    got = ck.chunk_attention(*targs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("window", [None, 32])
def test_chunk_attention_matches_ref_oracle(window):
    """Finite caches against ``chunk_attention_ref`` (f32, atol 1e-5)."""
    jargs, targs = _case(2, T=7, group=2, bases=[0, 40, 249], poison=False)
    want = _jax(lambda *a: chunk_attention_ref(*a, window=window), jargs)
    got = ck.chunk_attention(*targs, window=window).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fmt", [None, "int8"])
def test_chunk_t1_is_decode_attention(fmt):
    """T = 1 is decode attention at lengths = base + 1: equal to the port's
    decode plain version (f32, atol 1e-6: one algorithm, two einsum
    shapes)."""
    _, targs = _case(3, T=1, group=4, bases=[0, 77, 255], fmt=fmt)
    q, *caches, base = targs
    got = _wrapper(fmt, False)(*targs)[:, :, 0]
    plain = (decode_attention_plain if fmt is None
             else decode_attention_quantized_plain)
    want = plain(q[:, :, 0], *caches, base + 1)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_chunk_rows_past_the_capacity_are_clamped():
    """base + T past the capacity: rows at or past it see the whole cache
    and nothing else; the result stays finite and rows below are exact."""
    _, (q, k, v, base) = _case(4, T=6, group=2, bases=[252, 10])
    got = ck.chunk_attention(q, k, v, base)
    assert torch.isfinite(got).all()
    want = ck.chunk_attention(q[:, :, :4], k, v, base)
    torch.testing.assert_close(got[:, :, :4], want, atol=1e-6, rtol=0)
    full = torch.tensor([S - 1], dtype=torch.int32)  # T = 1 over all of it
    for t in (4, 5):
        want = ck.chunk_attention(q[:1, :, t:t + 1], k[:1], v[:1], full)
        torch.testing.assert_close(got[:1, :, t:t + 1], want, atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_chunk_attention_with_lse_matches_pallas(name):
    """Every case again with with_lse (attention sinks): (out, lse
    (B, H, T)) against the Pallas chunk kernel's, f32 at atol 1e-5; the
    output is the one without the lse."""
    case = dict(CASES[name])
    window, softcap = case.pop("window", None), case.pop("softcap", None)
    fmt, paged = case.get("fmt"), case.get("paged", False)
    jargs, targs = _case(len(name), **case)
    make = (make_paged_chunk_attention if paged else
            lambda **kw: make_chunk_attention(block_k=128, **kw))
    want = make(window=window, quantized=fmt is not None, softcap=softcap,
                with_lse=True)(*(jnp.asarray(a) for a in jargs))
    got = _wrapper(fmt, paged)(*targs, window=window, softcap=softcap,
                               with_lse=True)
    assert got[1].shape == targs[0].shape[:3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=1e-5, rtol=0)
    torch.testing.assert_close(
        _wrapper(fmt, paged)(*targs, window=window, softcap=softcap), got[0],
        atol=0, rtol=0)


def test_chunk_unported_options_raise():
    """The TPU factories' DMA tiling has no counterpart."""
    _, targs = _case(0, T=2, group=2, bases=[4, 9])
    with pytest.raises(TypeError):  # TPU DMA tiling: no counterpart
        ck.chunk_attention(*targs[:3], targs[-1], block_k=128)


def test_chunk_shape_and_dtype_mismatch_raises():
    _, (q, k, v, base) = _case(0, T=2, group=2, bases=[4, 9])
    with pytest.raises(ValueError):  # q without the T axis
        ck.chunk_attention(q[:, :, 0], k, v, base)
    with pytest.raises(ValueError):  # caches of different shapes
        ck.chunk_attention(q, k, v[:, :1], base)
    with pytest.raises(ValueError):  # one base per row
        ck.chunk_attention(q, k, v, base[:1])
    with pytest.raises(ValueError):
        ck.chunk_attention(q, k, v, base, window=0)
    with pytest.raises(ValueError):  # f32 caches are no quantized caches
        ck.chunk_attention_quantized(q, k, v, k[..., 0], v[..., 0], base)
    _, qargs = _case(0, T=2, group=2, bases=[4, 9], fmt="int8", paged=True)
    with pytest.raises(ValueError):  # scale pools of the wrong shape
        ck.paged_chunk_attention_quantized(*qargs[:3], qargs[3][:, :, :8],
                                           *qargs[4:])
    with pytest.raises(ValueError):  # table rows != batch
        ck.paged_chunk_attention_quantized(*qargs[:5], qargs[5][:1],
                                           qargs[6])


def test_chunk_exports_and_counters():
    import leetcuda_tpu_torch.attention as att
    names = ("chunk_attention", "chunk_attention_quantized",
             "paged_chunk_attention", "paged_chunk_attention_quantized")
    assert all(getattr(att, n) is getattr(ck, n) for n in names)
    assert set(names) <= set(launch_counts())
