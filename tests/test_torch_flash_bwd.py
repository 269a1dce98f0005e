"""The port's flash forward with lse and its FA-2 backward against JAX's.

On this CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels run on the GPU, held against these same plain versions by
``chip_smoke.py``); the JAX kernels run in Pallas interpret mode with blocks
of 128, as tests/test_flash_bwd.py runs them. Inputs come from a numpy seed,
in f32. Forward outputs and the plain backward against JAX's ``_bwd`` are
the same algorithm in the same precision (atol 1e-5); gradients through
autograd are held at tests/test_flash_bwd.py's bar, atol 2e-3 and rtol 1e-2.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.attention.flash import (make_flash_attention,
                                          make_flash_attention_ragged)
from leetcuda_tpu.attention.flash_bwd import _bwd
from leetcuda_tpu.attention.flash_bwd import \
    make_flash_attention_trainable as jax_trainable
from leetcuda_tpu_torch.attention import flash_bwd as fb
from leetcuda_tpu_torch.attention.flash import (FLASH_LSE, flash_attention,
                                                flash_attention_ragged)

ATOL = 1e-5
GRAD_TOL = dict(atol=2e-3, rtol=1e-2)
B, H, N, D = 1, 2, 256, 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, Hkv, b=B, h=H, n=N, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n, d), dtype=np.float32) * 0.5
    k = rng.standard_normal((b, Hkv, n, d), dtype=np.float32) * 0.5
    v = rng.standard_normal((b, Hkv, n, d), dtype=np.float32) * 0.5
    return q, k, v


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_lse_matches_pallas(causal):
    q, k, v = _qkv(0, 1, b=2, h=4)
    jo, jl = make_flash_attention(causal=causal, with_lse=True, block_q=128,
                                  block_k=128)(*map(jnp.asarray, (q, k, v)))
    before = FLASH_LSE.launches
    out, lse = flash_attention(*_t(q, k, v), causal=causal, with_lse=True)
    assert FLASH_LSE.launches == before  # the plain version counts nothing
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)


def test_ragged_forward_lse_matches_pallas():
    q, k, v = _qkv(1, 2, b=3, h=4)
    lengths = np.array([256, 100, 1], np.int32)
    jo, jl = make_flash_attention_ragged(
        with_lse=True, block_q=128, block_k=128)(
            *map(jnp.asarray, (q, k, v, lengths)))
    out, lse = flash_attention_ragged(*_t(q, k, v),
                                      torch.from_numpy(lengths),
                                      with_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    for b, n in enumerate(lengths):  # rows past a length: lse -1e30
        assert np.all(lse[b, :, n:].numpy() == np.float32(-1e30))


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_jax_bwd(causal, with_dlse):
    """flash_attention_bwd_plain against JAX's _bwd kernels (interpret
    mode) on one forward's out and lse, GQA 4 over 2; JAX's kernels take
    k/v repeated to H heads and the group is summed afterwards, as
    make_flash_attention_trainable does."""
    Hq, Hkv = 4, 2
    q, k, v = _qkv(2, Hkv, h=Hq)
    rng = np.random.default_rng(3)
    do = rng.standard_normal(q.shape, dtype=np.float32)
    dlse = (rng.standard_normal(q.shape[:3], dtype=np.float32)
            if with_dlse else None)
    out, lse = flash_attention(*_t(q, k, v), causal=causal, with_lse=True)
    scale = 1.0 / math.sqrt(D)
    g = Hq // Hkv

    def flat(x):
        return jnp.asarray(x).reshape(B * Hq, *x.shape[2:])

    jdq, jdk, jdv = _bwd(
        causal, None, scale, None, 128, 128, flat(q),
        flat(np.repeat(k, g, axis=1)), flat(np.repeat(v, g, axis=1)),
        flat(out.numpy()), flat(lse.numpy()), flat(do),
        dlse=None if dlse is None else flat(dlse))
    jdk = np.asarray(jdk).reshape(B, Hkv, g, N, D).sum(2)
    jdv = np.asarray(jdv).reshape(B, Hkv, g, N, D).sum(2)
    dq, dk, dv = fb.flash_attention_bwd_plain(
        *_t(q, k, v), out, lse, torch.from_numpy(do),
        None if dlse is None else torch.from_numpy(dlse), causal=causal,
        sm_scale=scale)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq).reshape(q.shape),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(dk.numpy(), jdk, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dv.numpy(), jdv, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Hkv", [2, 1])
def test_trainable_grads_match_jax(causal, Hkv):
    q, k, v = _qkv(4, Hkv)
    jfa = jax_trainable(causal=causal, block_q=128, block_k=128)
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(jfa(*a))), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    fa = fb.make_flash_attention_trainable(causal=causal)
    torch.sin(fa(tq, tk, tv)).sum().backward()
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_trainable_with_lse_sink_grads_match_jax():
    """with_lse=True with a sink-style use of the lse, out * sigmoid(lse -
    sink): the lse cotangent folds into delta, and the gradients reach q,
    k, v and the sinks, as in tests/test_flash_bwd.py."""
    q, k, v = _qkv(5, 1)
    sinks = np.random.default_rng(6).standard_normal(H).astype(np.float32)
    sinks *= 0.5
    jfa = jax_trainable(causal=True, with_lse=True, block_q=128, block_k=128)

    def jloss(q, k, v, s):
        out, lse = jfa(q, k, v)
        out = out * jax.nn.sigmoid(lse - s[None, :, None])[..., None]
        return jnp.sum(jnp.sin(out))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, sinks)))
    tq, tk, tv, ts = _t(q, k, v, sinks, grad=True)
    out, lse = fb.make_flash_attention_trainable(causal=True,
                                                 with_lse=True)(tq, tk, tv)
    out = out * torch.sigmoid(lse - ts[None, :, None])[..., None]
    torch.sin(out).sum().backward()
    for got, w, name in zip((tq.grad, tk.grad, tv.grad, ts.grad), want,
                            ("q", "k", "v", "sinks")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


# (window, softcap) of the backward cases: windows on a 64-block edge (64)
# and inside one (100), caps that bend every score (0.5) or few (30)
BWD_BANDS = [(64, None), (100, None), (None, 0.5), (None, 30.0), (100, 0.5),
             (64, 30.0)]


@pytest.mark.parametrize("window,softcap", BWD_BANDS)
def test_bwd_plain_window_softcap_matches_jax_bwd(window, softcap):
    """The plain backward with a band and a cap against JAX's _bwd kernels
    with blocks of 64 (blocks off the band skipped in both of its passes),
    GQA 4 over 2, a random lse cotangent; out and lse from the port's
    forward with the same options."""
    Hq, Hkv = 4, 2
    q, k, v = _qkv(9, Hkv, h=Hq)
    rng = np.random.default_rng(10)
    do = rng.standard_normal(q.shape, dtype=np.float32)
    dlse = rng.standard_normal(q.shape[:3], dtype=np.float32)
    out, lse = flash_attention(*_t(q, k, v), causal=True, window=window,
                               softcap=softcap, with_lse=True)
    scale = 1.0 / math.sqrt(D)
    g = Hq // Hkv

    def flat(x):
        return jnp.asarray(x).reshape(B * Hq, *x.shape[2:])

    jdq, jdk, jdv = _bwd(
        True, window, scale, softcap, 64, 64, flat(q),
        flat(np.repeat(k, g, axis=1)), flat(np.repeat(v, g, axis=1)),
        flat(out.numpy()), flat(lse.numpy()), flat(do), dlse=flat(dlse))
    jdk = np.asarray(jdk).reshape(B, Hkv, g, N, D).sum(2)
    jdv = np.asarray(jdv).reshape(B, Hkv, g, N, D).sum(2)
    dq, dk, dv = fb.flash_attention_bwd_plain(
        *_t(q, k, v), out, lse, torch.from_numpy(do), torch.from_numpy(dlse),
        causal=True, sm_scale=scale, window=window, softcap=softcap)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq).reshape(q.shape),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(dk.numpy(), jdk, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dv.numpy(), jdv, atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("window,softcap", BWD_BANDS)
def test_trainable_window_softcap_grads_match_jax(window, softcap, with_lse):
    """Gradients through the band and the cap (the chain rule through
    cap * tanh(s / cap)) against jax.grad of JAX's trainable attention with
    blocks of 64, GQA 2 over 1; with ``with_lse`` the lse reaches the loss
    too, so its cotangent folds into delta."""
    q, k, v = _qkv(11, 1)
    jfa = jax_trainable(causal=True, window=window, softcap=softcap,
                        with_lse=with_lse, block_q=64, block_k=64)
    fa = fb.make_flash_attention_trainable(causal=True, window=window,
                                           softcap=softcap, with_lse=with_lse)

    def loss(out, sin, cos):
        if with_lse:
            out, lse = out
            return sin(out).sum() + cos(lse).sum()
        return sin(out).sum()

    want = jax.grad(lambda *a: loss(jfa(*a), jnp.sin, jnp.cos),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    loss(fa(tq, tk, tv), torch.sin, torch.cos).backward()
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_inference_forward_without_lse_when_no_grad(monkeypatch):
    """No input requires a gradient: the callable runs the inference
    forward (no lse written), as JAX's primal path does; with a gradient
    required it runs the forward with its lse. A spy on the forward,
    because the launch counters do not move on the CPU."""
    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("with_lse", False))
        return flash_attention(*args, **kw)

    monkeypatch.setattr(fb, "flash_attention", spy)
    q, k, v = _qkv(7, 1, n=32)
    fa = fb.make_flash_attention_trainable(causal=True)
    out = fa(*_t(q, k, v))
    assert calls == [False] and isinstance(out, torch.Tensor)
    tq, tk, tv = _t(q, k, v, grad=True)
    with torch.no_grad():
        fa(tq, tk, tv)
    assert calls == [False, False]
    fa(tq, tk, tv).sum().backward()
    assert calls == [False, False, True]
    out, lse = fb.make_flash_attention_trainable(causal=True,
                                                 with_lse=True)(*_t(q, k, v))
    assert calls[-1] is True and lse.shape == q.shape[:3]


def test_bwd_plain_counts_nothing():
    q, k, v = _qkv(8, 1, n=32)
    out, lse = flash_attention(*_t(q, k, v), causal=True, with_lse=True)
    before = (fb.FLASH_BWD_DQ.launches, fb.FLASH_BWD_DKV.launches)
    dq, dk, dv = fb.flash_attention_bwd(*_t(q, k, v), out, lse,
                                        torch.ones_like(out), causal=True)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert (fb.FLASH_BWD_DQ.launches, fb.FLASH_BWD_DKV.launches) == before


def test_bf16_rounding_of_the_backward_against_f64():
    """In bf16, the plain backward and JAX's _bwd kernels (interpret mode)
    both round P and dS to bf16 before the second products and the
    gradients to bf16 at the end: each is the same distance from the f64
    gradient of the same inputs (``bench/attn_bench.py bwd_f64``), within
    25% in RMS for dq, dk and dv, and the two lie closer to each other than
    either lies to f64, so an elementwise bar between two such versions
    compares two bf16 roundings (PERF.md, the FA-2 backward's dK bar)."""
    from leetcuda_tpu_torch.bench.attn_bench import bwd_f64

    Hq, Hkv, n, d = 4, 2, 256, 64
    q, k, v = (torch.from_numpy(a * 2).to(torch.bfloat16)
               for a in _qkv(7, Hkv, h=Hq, n=n, d=d))
    rng = np.random.default_rng(8)
    do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(
        torch.bfloat16)
    out, lse = flash_attention(q, k, v, causal=True, with_lse=True)
    out = out.to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    g = Hq // Hkv

    def flat(x):
        return jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
        ).reshape(B * Hq, *x.shape[2:])

    jgrads = _bwd(True, None, scale, None, 128, 128, flat(q),
                  flat(k.repeat_interleave(g, 1)),
                  flat(v.repeat_interleave(g, 1)), flat(out), flat(lse),
                  flat(do))
    jdq = np.asarray(jgrads[0], np.float64).reshape(q.shape)
    jdk, jdv = (np.asarray(t, np.float64).reshape(B, Hkv, g, n, d).sum(2)
                for t in jgrads[1:])
    plain = fb.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                         sm_scale=scale)
    exact = bwd_f64(q, k, v, out, lse, do, scale)

    def rms(a, b):
        return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                      - np.asarray(b, np.float64)) ** 2)))

    for p, j, e in zip(plain, (jdq, jdk, jdv), exact):
        p, e = p.double().numpy(), e.numpy()
        to_f64, jax_to_f64 = rms(p, e), rms(j, e)
        assert 0.8 < to_f64 / jax_to_f64 < 1.25
        assert rms(p, j) < max(to_f64, jax_to_f64)
