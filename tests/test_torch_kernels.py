"""The port's attention kernels against the JAX package's Pallas kernels.

On this CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels run on the GPU, held against these same plain versions by
``chip_smoke.py``); the JAX kernels run in Pallas interpret mode, as their
own tests run them. Inputs come from a numpy seed; everything is f32 and
compared at atol 1e-5: the same algorithm in the same precision, differing
only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.attention.decode import make_decode_attention
from leetcuda_tpu.attention.flash import (make_flash_attention,
                                          make_flash_attention_ragged)
from leetcuda_tpu_torch.attention.decode import DECODE, decode_attention
from leetcuda_tpu_torch.attention.flash import (
    FLASH, FLASH_RAGGED, flash_attention, flash_attention_ragged)

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


@pytest.mark.parametrize("opt", [{"window": 8}, {"softcap": 30.0},
                                 {"with_lse": True}])
def test_unported_options_raise(opt):
    """window and softcap raise everywhere; with_lse is taken by the flash
    wrappers (the forward of training) and raises in decode."""
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(np.random.default_rng(5), 1, 2, 1, 16, 64))
    lengths = torch.tensor([9], dtype=torch.int32)
    for call in (lambda: flash_attention(q, k, v, causal=True, **opt),
                 lambda: flash_attention_ragged(q, k, v, lengths, **opt)):
        if "with_lse" in opt:
            out, lse = call()
            assert out.shape == q.shape and lse.shape == q.shape[:3]
        else:
            with pytest.raises(NotImplementedError):
                call()
    with pytest.raises(NotImplementedError):
        decode_attention(q[:, :, 0], k, v, lengths, **opt)


def test_shape_mismatch_raises():
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(np.random.default_rng(6), 1, 3, 2, 16, 64))
    with pytest.raises(ValueError):  # 3 query heads over 2 kv heads
        flash_attention(q, k, v)
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], k, v, torch.tensor([4], dtype=torch.int32))
