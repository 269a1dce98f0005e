"""The port's quantizers, quantized matmuls and quantized decode attention
against the JAX package's.

The quantizers must produce the JAX packs byte for byte: that is what lets
the port serve JAX's quantized params and reproduce its tokens. On this CPU
the port's wrappers run their plain PyTorch versions (the CUDA kernels run
on the GPU, held against these same plain versions by ``chip_smoke.py``);
the JAX kernels run in Pallas interpret mode. Inputs come from a numpy seed.
Tolerances: in f32, atol/rtol 1e-5 (the same exact weight values and f32
products, summed in another order); in bf16, the registry bars of the JAX
ops (5e-2 int8 and int4, 8e-2 fp8; ``leetcuda_tpu/gemm/quant.py``), since
the output is rounded to bf16 once on each side.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from leetcuda_tpu.attention.decode import make_decode_attention_quantized
from leetcuda_tpu.gemm import quant as jq
from leetcuda_tpu.models.llama import _quantize_token_kv as j_quantize_kv
from leetcuda_tpu_torch.attention.decode import (DECODE_Q,
                                                 decode_attention_quantized)
from leetcuda_tpu_torch.gemm import quant as tq
from leetcuda_tpu_torch.models.convert import params_from_numpy

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BAR = {"int8": 5e-2, "fp8": 8e-2, "int4": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bytes(a):
    """The raw bytes of a numpy array or a tensor (fp8 and int8 alike)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _to_torch(*arrays):
    return params_from_numpy([np.asarray(a) for a in arrays], "cpu")


@pytest.mark.parametrize("scale", [1.0, 1e-3, 37.0])
@pytest.mark.parametrize("shape", [(512, 384), (256, 64)])
def test_quantizers_byte_equal(shape, scale):
    w = np.random.default_rng(0).standard_normal(shape, dtype=np.float32)
    w *= scale
    wt = torch.from_numpy(w)
    for jfn, tfn in ((jq.quantize_rowwise_int8, tq.quantize_rowwise_int8),
                     (jq.quantize_rowwise_fp8, tq.quantize_rowwise_fp8),
                     (jq.quantize_groupwise_int4, tq.quantize_groupwise_int4)):
        jpack, js = jfn(jnp.asarray(w))
        tpack, ts = tfn(wt)
        np.testing.assert_array_equal(_bytes(tpack), _bytes(jpack))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jp, js = jq.quantize_groupwise_int4(jnp.asarray(w))
    tp, ts = tq.quantize_groupwise_int4(wt)
    np.testing.assert_array_equal(tq.dequantize_int4(tp, ts).numpy(),
                                  np.asarray(jq.dequantize_int4(jp, js)))


def test_quantizers_take_bf16_weights():
    w = jnp.asarray(np.random.default_rng(1).standard_normal(
        (256, 256), dtype=np.float32)).astype(jnp.bfloat16)
    (wt,) = _to_torch(w)
    for jfn, tfn in ((jq.quantize_rowwise_int8, tq.quantize_rowwise_int8),
                     (jq.quantize_rowwise_fp8, tq.quantize_rowwise_fp8),
                     (jq.quantize_groupwise_int4, tq.quantize_groupwise_int4)):
        np.testing.assert_array_equal(_bytes(tfn(wt)[0]), _bytes(jfn(w)[0]))


def test_params_from_numpy_carries_e4m3_bit_for_bit():
    """Every one of the 256 e4m3 bytes, NaN patterns 0x7F and 0xFF
    included, crosses unchanged, nested in a {"q", "s"} pack."""
    raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
    pack = {"q": raw.view(ml_dtypes.float8_e4m3fn),
            "s": np.ones(16, np.float32)}
    got = params_from_numpy({"layers": [{"wq": pack}]}, "cpu")
    q = got["layers"][0]["wq"]["q"]
    assert q.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bytes(q), raw)
    f = q.float().numpy()
    assert np.isnan(f.reshape(-1)[[0x7F, 0xFF]]).all()
    assert np.isfinite(np.delete(f.reshape(-1), [0x7F, 0xFF])).all()
    np.testing.assert_array_equal(
        f, raw.view(ml_dtypes.float8_e4m3fn).astype(np.float32))


def _w8_inputs(rng, fmt, M, K=256, N=384):
    x = rng.standard_normal((M, K), dtype=np.float32)
    w = rng.standard_normal((K, N), dtype=np.float32) / np.sqrt(K)
    quant = jq.quantize_rowwise_int8 if fmt == "int8" else \
        jq.quantize_rowwise_fp8
    q, s = quant(jnp.asarray(w))
    return x, q, s


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("M", [8, 64])
def test_w8a16_f32_matches_f32_dot_kernel(fmt, M):
    """f32 activations against the JAX kernel's f32-dot variant (for e4m3
    the integer bit-surgery decode the JAX model takes on decode rows)."""
    x, q, s = _w8_inputs(np.random.default_rng(2), fmt, M)
    kern = (jq.make_matmul_w8a16(compute_dtype=jnp.float32) if fmt == "int8"
            else jq.make_matmul_w8a16(fp8_bits=True,
                                      compute_dtype=jnp.float32))
    want = np.asarray(kern(jnp.asarray(x), q, s))
    got = tq.matmul_w8a16(*_to_torch(x, q, s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_w8a16_bf16_matches_default_kernel(fmt):
    x, q, s = _w8_inputs(np.random.default_rng(3), fmt, 16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kernels = [jq.make_matmul_w8a16()]
    if fmt == "fp8":
        kernels.append(jq.make_matmul_w8a16(fp8_bits=True))
    got = tq.matmul_w8a16(*_to_torch(xb, q, s))
    assert got.dtype == torch.bfloat16
    for kern in kernels:
        want = np.asarray(kern(xb, q, s).astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=BAR[fmt], rtol=BAR[fmt])


def _w4_inputs(rng, M, K=512, N=256):
    x = rng.standard_normal((M, K), dtype=np.float32)
    w = rng.standard_normal((K, N), dtype=np.float32) / np.sqrt(K)
    packed, scales = jq.quantize_groupwise_int4(jnp.asarray(w))
    return x, packed, scales


@pytest.mark.parametrize("M", [8, 64])
def test_w4a16_matches_kernel(M):
    """f32 activations against the f32-dot (decode) variant at 1e-5; bf16
    activations against the default bf16-dot kernel at the registry bar."""
    x, packed, scales = _w4_inputs(np.random.default_rng(4), M)
    want = np.asarray(jq.make_matmul_w4a16(compute_dtype=jnp.float32)(
        jnp.asarray(x), packed, scales))
    got = tq.matmul_w4a16(*_to_torch(x, packed, scales))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jq.make_matmul_w4a16()(xb, packed, scales).astype(
        jnp.float32))
    got = tq.matmul_w4a16(*_to_torch(xb, packed, scales))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BAR["int4"],
                               rtol=BAR["int4"])


def _quantized_cache(rng, fmt, B, Hkv, S, D, lengths):
    """JAX-quantized K/V caches with NaN scales (and, for e4m3, the NaN
    bytes 0x7F / 0xFF) past every length."""
    qdt = jnp.int8 if fmt == "int8" else jnp.float8_e4m3fn
    out = []
    for nan_byte in (0x7F, 0xFF):
        x = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
        xq, xs = (np.array(a) for a in j_quantize_kv(jnp.asarray(x), qdt))
        for b, n in enumerate(lengths):
            xs[b, :, n:] = np.nan
            if fmt == "fp8":
                xq.view(np.uint8)[b, :, n:] = nan_byte
        out.append((xq, xs))
    (kq, ks), (vq, vs) = out
    return kq, vq, ks, vs


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_decode_quantized_matches_pallas_nan_tail(fmt):
    """GQA, S_max not a multiple of the JAX kernel's KV block (a partial
    edge block), NaN past every length. The oracle is the Pallas kernel:
    JAX's reference does not survive NaN padding."""
    rng = np.random.default_rng(5)
    B, H, Hkv, S, D = 3, 4, 2, 80, 32
    lengths = np.array([80, 37, 1], np.int32)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kq, vq, ks, vs = _quantized_cache(rng, fmt, B, Hkv, S, D, lengths)
    want = np.asarray(make_decode_attention_quantized(block_k=32)(
        *(jnp.asarray(a) for a in (q, kq, vq, ks, vs, lengths))))
    got = decode_attention_quantized(
        *_to_torch(q, kq, vq, ks, vs, lengths)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_cpu_tensors_take_plain_path_uncounted():
    """A CPU tensor runs the plain version; only kernel launches count."""
    rng = np.random.default_rng(6)
    x, q, s = _w8_inputs(rng, "int8", 4)
    xw, packed, scales = _w4_inputs(rng, 4)
    kq, vq, ks, vs = _quantized_cache(rng, "fp8", 1, 1, 16, 64, [5])
    before = (tq.W8A16.launches, tq.W4A16.launches, DECODE_Q.launches)
    tq.matmul_w8a16(*_to_torch(x, q, s))
    tq.matmul_w4a16(*_to_torch(xw, packed, scales))
    decode_attention_quantized(*_to_torch(
        rng.standard_normal((1, 2, 64), dtype=np.float32), kq, vq, ks, vs,
        np.array([5], np.int32)))
    assert (tq.W8A16.launches, tq.W4A16.launches,
            DECODE_Q.launches) == before


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_decode_quantized_with_lse_matches_pallas(fmt):
    """with_lse (attention sinks) over a quantized cache with NaN scales
    (e4m3: NaN bytes) past every length: (out, lse (B, H)) against the
    Pallas kernel's."""
    rng = np.random.default_rng(8)
    B, H, Hkv, S, D = 3, 4, 2, 80, 32
    lengths = np.array([80, 37, 1], np.int32)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kq, vq, ks, vs = _quantized_cache(rng, fmt, B, Hkv, S, D, lengths)
    want = make_decode_attention_quantized(block_k=32, with_lse=True)(
        *(jnp.array(a) for a in (q, kq, vq, ks, vs, lengths)))
    got = decode_attention_quantized(
        *_to_torch(q, kq, vq, ks, vs, lengths), with_lse=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("opt", [{"shared_kv": True}])
def test_decode_quantized_unported_options_raise(opt):
    """shared_kv (MLA's latent cache) takes JAX's calling form, (q,
    cache_q, scale, lengths): the unshared operands with shared_kv raise,
    naming the form."""
    rng = np.random.default_rng(7)
    kq, vq, ks, vs = _quantized_cache(rng, "int8", 1, 1, 16, 64, [5])
    args = _to_torch(rng.standard_normal((1, 2, 64), dtype=np.float32), kq,
                     vq, ks, vs, np.array([5], np.int32))
    with pytest.raises(TypeError, match="shared_kv"):
        decode_attention_quantized(*args, **opt)


def test_bad_packs_raise():
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError):  # scale per column missing
        tq.matmul_w8a16(x, torch.zeros(256, 8, dtype=torch.int8),
                        torch.ones(4))
    with pytest.raises(ValueError):  # weights neither int8 nor e4m3
        tq.matmul_w8a16(x, torch.zeros(256, 8, dtype=torch.float16),
                        torch.ones(8))
    with pytest.raises(ValueError):  # K = 128 is no multiple of 2 * 128
        tq.matmul_w4a16(torch.zeros(2, 128),
                        torch.zeros(64, 8, dtype=torch.int8), torch.ones(1, 8))
    with pytest.raises(ValueError):
        tq.quantize_groupwise_int4(torch.zeros(128, 8))
