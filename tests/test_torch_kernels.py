"""The port's attention kernels against the JAX package's Pallas kernels.

On this CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels run on the GPU, held against these same plain versions by
``chip_smoke.py``); the JAX kernels run in Pallas interpret mode, as their
own tests run them. Inputs come from a numpy seed; everything is f32 and
compared at atol 1e-5: the same algorithm in the same precision, differing
only in summation order. The sliding window and the softcap run with small
JAX blocks (16 rows and keys, 32 decode keys), so that the JAX kernels skip
whole blocks off the band, and with windows that end on a block edge (16)
and inside one (8, 24); a softcap of 0.5 bends every score, 30 few of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.attention.decode import (make_decode_attention,
                                           make_decode_attention_quantized)
from leetcuda_tpu.attention.flash import (make_flash_attention,
                                          make_flash_attention_ragged)
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.attention.decode import (DECODE, decode_attention,
                                                 decode_attention_quantized)
from leetcuda_tpu_torch.attention.flash import (
    FLASH, FLASH_RAGGED, flash_attention, flash_attention_ragged)
from leetcuda_tpu_torch.models.convert import params_from_numpy

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _qkv(rng, B, H, Hkv, N, D):
    q = rng.standard_normal((B, H, N, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, N, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, N, D), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_gqa(causal):
    q, k, v = _qkv(np.random.default_rng(0), 2, 4, 2, 64, 32)
    want = make_flash_attention(causal=causal)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_flash_ragged_matches_pallas_and_zeroes_rows():
    q, k, v = _qkv(np.random.default_rng(1), 3, 4, 2, 64, 32)
    lengths = np.array([64, 23, 1], np.int32)
    want = np.asarray(make_flash_attention_ragged()(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)))
    got = flash_attention_ragged(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for b, n in enumerate(lengths):
        assert np.all(got[b, :, n:] == 0.0)  # rows past the length: zeros
        assert np.all(np.abs(got[b, :, :n]).sum(-1) > 0)


def test_flash_ragged_ignores_nan_past_length():
    """K/V rows past a length never reach the result, NaN or not."""
    q, k, v = _qkv(np.random.default_rng(2), 2, 4, 2, 32, 32)
    lengths = np.array([20, 7], np.int32)
    clean = flash_attention_ragged(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths)).numpy()
    for b, n in enumerate(lengths):
        k[b, :, n:] = np.nan
        v[b, :, n:] = np.nan
    dirty = flash_attention_ragged(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(dirty, clean)


def test_decode_matches_pallas_nan_tail():
    """NaN written past every length, S_max not a multiple of the JAX
    kernel's KV block (partial edge block). JAX's own decode_attention_ref
    does not survive NaN padding, so the oracle is the Pallas kernel."""
    rng = np.random.default_rng(3)
    B, H, Hkv, S, D = 3, 4, 2, 80, 32
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kc = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    vc = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    lengths = np.array([80, 37, 1], np.int32)
    for b, n in enumerate(lengths):
        kc[b, :, n:] = np.nan
        vc[b, :, n:] = np.nan
    want = np.asarray(make_decode_attention(block_k=32)(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths)))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc),
                           torch.from_numpy(lengths)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_cpu_tensors_take_plain_path_uncounted():
    """A CPU tensor runs the plain version; only kernel launches count."""
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(np.random.default_rng(4), 1, 2, 1, 16, 64))
    before = (FLASH.launches, FLASH_RAGGED.launches, DECODE.launches)
    flash_attention(q, k, v, causal=True)
    flash_attention_ragged(q, k, v, torch.tensor([9], dtype=torch.int32))
    decode_attention(q[:, :, 0], k, v, torch.tensor([5], dtype=torch.int32))
    assert (FLASH.launches, FLASH_RAGGED.launches, DECODE.launches) == before


@pytest.mark.parametrize("opt", [{"with_lse": True}])
def test_with_lse_taken_by_flash_and_decode(opt):
    """with_lse is taken by the flash wrappers (the forward of training)
    and by decode (attention sinks): (out, lse), decode's lse (B, H)
    against the Pallas kernel's."""
    qn, kn, vn = _qkv(np.random.default_rng(5), 1, 2, 1, 16, 64)
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    lengths = torch.tensor([9], dtype=torch.int32)
    for call in (lambda: flash_attention(q, k, v, causal=True, **opt),
                 lambda: flash_attention_ragged(q, k, v, lengths, **opt)):
        out, lse = call()
        assert out.shape == q.shape and lse.shape == q.shape[:3]
    out, lse = decode_attention(q[:, :, 0], k, v, lengths, **opt)
    want = make_decode_attention(block_k=8, **opt)(
        jnp.array(qn[:, :, 0]), jnp.array(kn), jnp.array(vn),
        jnp.array(lengths.numpy()))
    assert out.shape == q[:, :, 0].shape and lse.shape == q.shape[:2]
    for g, w in zip((out, lse), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_shape_mismatch_raises():
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(np.random.default_rng(6), 1, 3, 2, 16, 64))
    with pytest.raises(ValueError):  # 3 query heads over 2 kv heads
        flash_attention(q, k, v)
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], k, v, torch.tensor([4], dtype=torch.int32))


# (window, softcap) of the flash cases: windows inside a 16-block (8, 24)
# and on its edge (16), caps that bend every score (0.5) or few (30)
BANDS = [(8, None), (24, None), (16, None), (None, 0.5), (None, 30.0),
         (8, 0.5), (24, 30.0)]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("window,softcap", BANDS)
def test_flash_window_softcap_matches_pallas(window, softcap, with_lse):
    """The causal band and the cap, GQA 4 over 2, against the Pallas kernel
    with 16 x 16 blocks (blocks wholly left of the band skipped there); a
    window implies causal on both sides, asked for or not."""
    q, k, v = _qkv(np.random.default_rng(7), 2, 4, 2, 64, 32)
    want = make_flash_attention(causal=True, window=window, softcap=softcap,
                                with_lse=with_lse, block_q=16, block_k=16)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=window is None,
                          window=window, softcap=softcap, with_lse=with_lse)
    for g, w in zip(got if with_lse else [got], want if with_lse else [want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("window,softcap", BANDS)
def test_flash_ragged_window_softcap_matches_pallas(window, softcap,
                                                    with_lse):
    """The ragged kernel with a band and a cap: lengths past, inside and
    below the window; NaN in K/V past every length never reaches the
    result; rows past a length are zeros (lse -1e30)."""
    q, k, v = _qkv(np.random.default_rng(8), 3, 4, 2, 64, 32)
    lengths = np.array([64, 23, 5], np.int32)
    # JAX gets copies (jnp.array): jnp.asarray may alias these numpy
    # buffers, and the NaN written below would race the asynchronous call
    want = make_flash_attention_ragged(
        window=window, softcap=softcap, with_lse=with_lse, block_q=16,
        block_k=16)(jnp.array(q), jnp.array(k), jnp.array(v),
                    jnp.array(lengths))
    for b, n in enumerate(lengths):
        k[b, :, n:] = np.nan
        v[b, :, n:] = np.nan
    got = flash_attention_ragged(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), window=window, softcap=softcap,
        with_lse=with_lse)
    out = got[0] if with_lse else got
    assert torch.isfinite(out).all()
    for g, w in zip(got if with_lse else [got], want if with_lse else [want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
    if with_lse:
        for b, n in enumerate(lengths):
            assert np.all(got[1][b, :, n:].numpy() == np.float32(-1e30))


def _decode_case(rng, lengths, fmt, S=80):
    """q and caches (B, Hkv=2, S, 32) with NaN past every length (values
    and scales; e4m3: the NaN byte 0x7F). Returns the JAX and the port's
    arguments (q, k, v, [ks, vs,] lengths)."""
    B, H, Hkv, D = len(lengths), 4, 2, 32
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    caches = [rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
              for _ in range(2)]
    if fmt is not None:
        dt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[fmt]
        quant = [jl._quantize_token_kv(jnp.asarray(c), dt) for c in caches]
        caches = [np.array(quant[0][0]), np.array(quant[1][0]),
                  np.array(quant[0][1]), np.array(quant[1][1])]
    for b, n in enumerate(lengths):
        for c in caches:
            if c.dtype.name == "float8_e4m3fn":
                c.view(np.uint8)[b, :, n:] = 0x7F
            elif c.dtype == np.int8:
                c[b, :, n:] = 0
            else:
                c[b, :, n:] = np.nan
    args = [q, *caches, np.asarray(lengths, np.int32)]
    return ([jnp.asarray(a) for a in args], params_from_numpy(args, "cpu"))


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
@pytest.mark.parametrize("window,softcap", [(24, None), (32, 30.0),
                                            (None, 0.5), (17, 0.5)])
def test_decode_window_softcap_matches_pallas(fmt, window, softcap):
    """Decode over a plain, int8 or e4m3 cache with a window (on the JAX
    kernel's 32-key block edge or inside a block) and a cap, NaN past every
    length: lengths below, at and past the window."""
    jargs, targs = _decode_case(np.random.default_rng(9),
                                [80, 37, 1, 24, 33], fmt)
    make = (make_decode_attention if fmt is None
            else make_decode_attention_quantized)
    want = np.asarray(make(block_k=32, window=window, softcap=softcap)(
        *jargs))
    fn = decode_attention if fmt is None else decode_attention_quantized
    got = fn(*targs, window=window, softcap=softcap).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fmt", [None, "int8"])
def test_decode_crosses_the_window_token_by_token(fmt):
    """One sequence decoding across a window of 16, a token at a time
    (lengths 12..21, one row each): every step against the Pallas kernel,
    and the keys before the band never matter (NaN there changes
    nothing)."""
    lengths = list(range(12, 22))
    jargs, targs = _decode_case(np.random.default_rng(10), lengths, fmt,
                                S=32)
    make = (make_decode_attention if fmt is None
            else make_decode_attention_quantized)
    want = np.asarray(make(block_k=8, window=16, softcap=2.0)(*jargs))
    fn = decode_attention if fmt is None else decode_attention_quantized
    got = fn(*targs, window=16, softcap=2.0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    for b, n in enumerate(lengths):  # NaN before the band: no change
        for t in targs[1:-1]:
            if t.dtype.is_floating_point and t.dtype != torch.float8_e4m3fn:
                t[b, :, :max(n - 16, 0)] = float("nan")
    torch.testing.assert_close(fn(*targs, window=16, softcap=2.0), got,
                               atol=0, rtol=0)
