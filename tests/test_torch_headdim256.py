"""Head dim 256 (Gemma-2-2B and -9B) in the port against the JAX package.

On this CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels at head dim 256 are held against these same plain versions by
``chip_smoke.py`` paths (r) and (s)); the JAX
kernels run in Pallas interpret mode, as their own tests run them, with
blocks of 16 rows and keys (decode: 32 keys) so that the window and the
cap act inside and across blocks. Inputs come from a numpy seed, in f32.

Tolerances are those of the same cases at head dim 64 / 128:
* kernels: atol 1e-5, the same algorithm in the same precision (test_torch_
  kernels.py, test_torch_chunk.py, test_torch_paged.py, test_torch_flash_
  bwd.py); gradients through autograd at atol 2e-3 / rtol 1e-2 (test_torch_
  flash_bwd.py); the fused entry block is parametrised in test_torch_
  fused.py;
* the model: 1e-4 on logits (test_torch_model.py), decode over an int8 KV
  cache 2e-3 (test_torch_sinks.py: e4m3 / int8 rounding of K/V moves the
  scores); greedy tokens equal; the loss at rtol 1e-5 and every gradient at
  atol 1e-4 / rtol 1e-3 (test_torch_window.py).

The tiny model is Gemma 2 at a head dim of 256: 2 layers of 256 wide, 2
query heads and 1 KV head of 256, a window of 16 on the even layer, caps 50
/ 30, query scale 256^-0.5, (1 + w) and sandwich norms (w drawn about 0, the
identity scale), GeGLU, the embedding scaled by sqrt(dim).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.attention.chunk import (make_chunk_attention,
                                          make_paged_chunk_attention)
from leetcuda_tpu.attention.decode import (make_decode_attention,
                                           make_decode_attention_quantized)
from leetcuda_tpu.attention.flash import (make_flash_attention,
                                          make_flash_attention_ragged)
from leetcuda_tpu.attention.flash_bwd import _bwd
from leetcuda_tpu.attention.flash_bwd import \
    make_flash_attention_trainable as jax_trainable
from leetcuda_tpu.attention.paged import make_paged_attention
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.attention import chunk as ck
from leetcuda_tpu_torch.attention import decode as dec
from leetcuda_tpu_torch.attention import flash as fl
from leetcuda_tpu_torch.attention import flash_bwd as fb
from leetcuda_tpu_torch.attention import paged as pg
from leetcuda_tpu_torch.engine import Engine, EngineConfig
from leetcuda_tpu_torch.gemm import fused_decode as fd
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import params_from_numpy

D = 256
ATOL = 1e-5
GRAD_TOL = dict(atol=2e-3, rtol=1e-2)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
INT8_TOL = dict(atol=2e-3, rtol=0)
BLOCK = 16
# (window, softcap): none, a window on a block edge with a cap that bends
# every score, a window inside a block with Gemma 2's cap
BANDS = [(None, None), (16, 0.5), (24, 50.0)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays, grad=False):
    """numpy arrays as CPU tensors (e4m3 bit for bit)."""
    return [t.requires_grad_(grad) if grad else t
            for t in params_from_numpy([np.array(a) for a in arrays], "cpu")]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


# --- kernels ---------------------------------------------------------------


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal,window,softcap",
                         [(False, None, None)] + [(True, w, c)
                                                  for w, c in BANDS])
def test_flash_forward_matches_pallas(causal, window, softcap, with_lse):
    """The flash forward at D=256, GQA 2 over 1, with and without its
    lse, against make_flash_attention in interpret mode."""
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, 1, 2, 64, D), _randn(rng, 1, 1, 64, D),
               _randn(rng, 1, 1, 64, D))
    want = make_flash_attention(causal=causal, window=window,
                                softcap=softcap, with_lse=with_lse,
                                block_q=BLOCK, block_k=BLOCK)(*_j(q, k, v))
    got = fl.flash_attention(*_t(q, k, v), causal=causal, window=window,
                             softcap=softcap, with_lse=with_lse)
    if with_lse:
        _close(got[1].numpy(), want[1])
        got, want = got[0], want[0]
    _close(got.numpy(), want)


@pytest.mark.parametrize("window,softcap", BANDS)
def test_flash_ragged_matches_pallas(window, softcap):
    """The ragged forward at D=256 with lengths 64 / 23 (rows past a length
    zero, their lse -1e30) against make_flash_attention_ragged."""
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, 2, 2, 64, D), _randn(rng, 2, 1, 64, D),
               _randn(rng, 2, 1, 64, D))
    lengths = np.array([64, 23], np.int32)
    jo, jlse = make_flash_attention_ragged(
        window=window, softcap=softcap, with_lse=True, block_q=BLOCK,
        block_k=BLOCK)(*_j(q, k, v, lengths))
    out, lse = fl.flash_attention_ragged(
        *_t(q, k, v, lengths), window=window, softcap=softcap,
        with_lse=True)
    _close(out.numpy(), jo)
    _close(lse.numpy(), jlse)
    assert np.all(out.numpy()[1, :, 23:] == 0)


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("window,softcap", BANDS)
def test_bwd_plain_matches_jax_bwd(window, softcap, with_dlse):
    """flash_attention_bwd_plain at D=256 against JAX's _bwd kernels on one
    forward's out and lse, GQA 2 over 1 (JAX takes k/v repeated to H heads
    and the group is summed afterwards)."""
    rng = np.random.default_rng(2)
    B, H, Hkv, N = 1, 2, 1, 64
    q, k, v = (_randn(rng, B, H, N, D, scale=0.5),
               _randn(rng, B, Hkv, N, D, scale=0.5),
               _randn(rng, B, Hkv, N, D, scale=0.5))
    do = _randn(rng, B, H, N, D)
    dlse = _randn(rng, B, H, N) if with_dlse else None
    opt = dict(window=window, softcap=softcap)
    out, lse = fl.flash_attention(*_t(q, k, v), causal=True, with_lse=True,
                                  **opt)
    scale = 1.0 / math.sqrt(D)
    g = H // Hkv

    def flat(x):
        return jnp.asarray(x).reshape(B * H, *x.shape[2:])

    jdq, jdk, jdv = _bwd(True, window, scale, softcap, BLOCK, BLOCK, flat(q),
                         flat(np.repeat(k, g, axis=1)),
                         flat(np.repeat(v, g, axis=1)), flat(out.numpy()),
                         flat(lse.numpy()), flat(do),
                         dlse=None if dlse is None else flat(dlse))
    dq, dk, dv = fb.flash_attention_bwd_plain(
        *_t(q, k, v), out, lse, torch.from_numpy(do),
        None if dlse is None else torch.from_numpy(dlse), causal=True,
        sm_scale=scale, **opt)
    _close(dq.numpy(), np.asarray(jdq).reshape(q.shape))
    _close(dk.numpy(), np.asarray(jdk).reshape(B, Hkv, g, N, D).sum(2))
    _close(dv.numpy(), np.asarray(jdv).reshape(B, Hkv, g, N, D).sum(2))


@pytest.mark.parametrize("window,softcap", BANDS)
def test_trainable_grads_match_jax(window, softcap):
    """Gradients of make_flash_attention_trainable at D=256 (the forward
    with its lse, then the backward) against jax.grad of JAX's."""
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, 1, 2, 64, D, scale=0.5),
               _randn(rng, 1, 1, 64, D, scale=0.5),
               _randn(rng, 1, 1, 64, D, scale=0.5))
    w = _randn(rng, 1, 2, 64, D)
    jfa = jax_trainable(causal=True, window=window, softcap=softcap,
                        block_q=BLOCK, block_k=BLOCK)
    jgrads = jax.grad(lambda *a: jnp.sum(jfa(*a) * w), argnums=(0, 1, 2))(
        *_j(q, k, v))
    tq, tk, tv = _t(q, k, v, grad=True)
    fa = fb.make_flash_attention_trainable(causal=True, window=window,
                                           softcap=softcap)
    (fa(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def _decode_case(seed, fmt=None, B=3, H=4, Hkv=2, S=80):
    """q (B, H, D) and caches (B, Hkv, S, D), NaN (int8: 0; e4m3: the NaN
    byte) past lengths 80 / 37 / 1, with their scales for ``fmt``."""
    rng = np.random.default_rng(seed)
    q = _randn(rng, B, H, D)
    caches = [_randn(rng, B, Hkv, S, D) for _ in range(2)]
    lengths = np.array([80, 37, 1], np.int32)[:B]
    if fmt is not None:
        qdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[fmt]
        pairs = [jl._quantize_token_kv(jnp.asarray(c), qdt) for c in caches]
        caches = [np.array(pairs[0][0]), np.array(pairs[1][0]),
                  np.array(pairs[0][1]), np.array(pairs[1][1])]
    for b, n in enumerate(lengths):
        for c in caches[:2]:
            if c.dtype == np.int8:
                c[b, :, n:] = 0
            elif c.dtype.name == "float8_e4m3fn":
                c.view(np.uint8)[b, :, n:] = 0x7F
            else:
                c[b, :, n:] = np.nan
    return q, caches, lengths


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
@pytest.mark.parametrize("window,softcap", BANDS)
def test_decode_matches_pallas(window, softcap, fmt, with_lse):
    """Decode at D=256, plain and quantized, GQA 2, NaN past every length,
    against the Pallas decode kernels (blocks of 32 keys)."""
    q, caches, lengths = _decode_case(4, fmt)
    opt = dict(window=window, softcap=softcap, with_lse=with_lse)
    if fmt is None:
        jfn = make_decode_attention(block_k=32, **opt)
        fn = dec.decode_attention
    else:
        jfn = make_decode_attention_quantized(block_k=32, **opt)
        fn = dec.decode_attention_quantized
    want = jfn(*_j(q, *caches, lengths))
    got = fn(*_t(q, *caches, lengths), **opt)
    if with_lse:
        _close(got[1].numpy(), want[1])
        got, want = got[0], want[0]
    assert np.all(np.isfinite(got.numpy()))
    _close(got.numpy(), want)


def _to_pools(rng, caches, lengths, page=16):
    """Scatter contiguous (B, Hkv, S[, D]) caches into shuffled pools of
    ``page``; pages no row owns hold NaN (int8: 0; e4m3: its NaN byte)."""
    B, Hkv, S = caches[0].shape[:3]
    P, N = S // page, B * (S // page) + 1
    table = np.zeros((B, P), np.int32)
    phys = rng.permutation(np.arange(1, N))
    pools = []
    for c in caches:
        pool = np.empty((N, Hkv, page) + c.shape[3:], c.dtype)
        if c.dtype == np.int8:
            pool[...] = 0
        elif c.dtype.name == "float8_e4m3fn":
            pool.view(np.uint8)[...] = 0x7F
        else:
            pool[...] = np.nan
        pools.append(pool)
    n = 0
    for b in range(B):
        for i in range(-(-int(lengths[b]) // page)):
            table[b, i] = phys[n]
            for pool, c in zip(pools, caches):
                pool[phys[n]] = c[b, :, i * page:(i + 1) * page]
            n += 1
    return pools, table


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
@pytest.mark.parametrize("window,softcap", BANDS)
def test_paged_matches_pallas(window, softcap, fmt):
    """Paged attention at D=256 over shuffled pools of 16, with its lse,
    against the Pallas paged kernel (JAX gets finite pools: its kernel does
    not survive NaN in pages no row owns, the port's plain version does)."""
    rng = np.random.default_rng(5)
    q, caches, lengths = _decode_case(6, fmt, S=64)
    pools, table = _to_pools(rng, caches, np.minimum(lengths, 64))
    lengths = np.minimum(lengths, 64)
    opt = dict(window=window, softcap=softcap, with_lse=True)
    clean = [np.nan_to_num(p) if p.dtype == np.float32 else p for p in pools]
    if fmt == "fp8":  # JAX's pools: finite bytes where no row owns a page
        clean = [p.copy() for p in pools]
        for p in clean[:2]:
            p.view(np.uint8)[p.view(np.uint8) == 0x7F] = 0
    jfn = make_paged_attention(quantized=fmt is not None, **opt)
    want = jfn(*_j(q, *clean, table, lengths))
    fn = pg.paged_attention if fmt is None else pg.paged_attention_quantized
    got = fn(*_t(q, *pools, table, lengths), **opt)
    _close(got[1].numpy(), want[1])
    assert np.all(np.isfinite(got[0].numpy()))
    _close(got[0].numpy(), want[0])


CHUNK_CASES = {
    "T=5": dict(T=5, bases=[0, 30, 59]),
    "T=32 window 16 cap 50": dict(T=32, bases=[0, 20], window=16,
                                  softcap=50.0),
    "T=5 int8 window 24 cap 0.5": dict(T=5, bases=[0, 30, 59], fmt="int8",
                                       window=24, softcap=0.5),
    "T=32 fp8": dict(T=32, bases=[3, 30], fmt="fp8"),
    "paged T=5 cap 0.5": dict(T=5, bases=[0, 30, 59], paged=True,
                              softcap=0.5),
    "paged T=32 window 16": dict(T=32, bases=[0, 20], paged=True,
                                 window=16),
    "paged T=5 int8 window 16 cap 50": dict(T=5, bases=[15, 16, 59],
                                           fmt="int8", paged=True,
                                           window=16, softcap=50.0),
    "paged T=32 fp8 cap 0.5": dict(T=32, bases=[16, 30], fmt="fp8",
                                   paged=True, softcap=0.5),
}


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("name", list(CHUNK_CASES))
def test_chunk_matches_pallas(name, with_lse):
    """The four chunk forms at D=256, GQA 2, against the Pallas chunk
    kernels: T rows at base..base + T - 1 over a capacity of 64, finite
    caches and pools (positions past base + T zero)."""
    case = dict(CHUNK_CASES[name])
    T, bases = case.pop("T"), np.array(case.pop("bases"), np.int32)
    fmt, paged = case.pop("fmt", None), case.pop("paged", False)
    rng = np.random.default_rng(7)
    B, H, Hkv, S = len(bases), 4, 2, 64
    q = _randn(rng, B, H, T, D)
    caches = [_randn(rng, B, Hkv, S, D) for _ in range(2)]
    if fmt is not None:
        qdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[fmt]
        pairs = [jl._quantize_token_kv(jnp.asarray(c), qdt) for c in caches]
        caches = [np.array(pairs[0][0]), np.array(pairs[1][0]),
                  np.array(pairs[0][1]), np.array(pairs[1][1])]
    end = np.minimum(bases + T, S)
    for b in range(B):
        for c in caches:
            c.view(np.uint8 if c.dtype.itemsize == 1 else c.dtype)[
                b, :, end[b]:] = 0
    tail = [bases]
    if paged:
        pools, table = _to_pools(rng, caches, end)
        for p in pools:  # finite everywhere (JAX's kernel reads whole pages)
            p.view(np.uint8 if p.dtype.itemsize == 1 else p.dtype)[
                np.isin(np.arange(p.shape[0]), table, invert=True)] = 0
        caches, tail = pools, [table, bases]
    opt = dict(with_lse=with_lse, **case)
    jfn = (make_paged_chunk_attention(quantized=fmt is not None, **opt)
           if paged else make_chunk_attention(block_k=BLOCK,
                                              quantized=fmt is not None,
                                              **opt))
    want = jfn(*_j(q, *caches, *tail))
    fn = {(False, False): ck.chunk_attention,
          (True, False): ck.chunk_attention_quantized,
          (False, True): ck.paged_chunk_attention,
          (True, True): ck.paged_chunk_attention_quantized}[
              (fmt is not None, paged)]
    got = fn(*_t(q, *caches, *tail), **opt)
    if with_lse:
        _close(got[1].numpy(), want[1])
        got, want = got[0], want[0]
    _close(got.numpy(), want)


# --- the launch guards -----------------------------------------------------


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("Dh", [64, 128, 256, 96, 192])
def test_launch_guards_take_256_and_refuse_96_and_192(Dh):
    """What the CUDA kernels take, checked on CPU tensors: every attention
    kernel and the fused entry block accept head dim 256 beside 64 and 128
    and refuse 96 and 192 (the decode kernels also take MLA's 576)."""
    ok = Dh in (64, 128, 256)
    B, H, Hkv, N = 2, 4, 2, 32
    q, k = _bf16(B, H, N, Dh), _bf16(B, Hkv, N, Dh)
    lengths = torch.tensor([32, 5], dtype=torch.int32)
    checks = [
        lambda: fl._check_kernel_args(q, k, k),
        lambda: fl._check_kernel_args(q, k, k, lengths),
        lambda: fb._check_launch_args(q, k, k, q, torch.zeros(B, H, N), q,
                                      None),
        lambda: ck._check_kernel_args(q, k, k, lengths),
        lambda: dec._check_kernel_args(_bf16(B, H, Dh), lengths,
                                       {"k_cache": k, "v_cache": k}),
        lambda: fd._check_qkv_kernel_args(
            "fused_norm_qkv_rope", _bf16(B, 256), _bf16(256),
            _bf16(256, (H + 2 * Hkv) * Dh), lengths, Dh),
    ]
    for check in checks:
        if ok:
            check()
        else:
            with pytest.raises(ValueError, match=str(Dh)):
                check()
    assert (Dh in fl.HEAD_DIMS) == ok and (Dh in fd.HEAD_DIMS) == ok
    assert (Dh in dec.HEAD_DIMS) == ok


# --- the model -------------------------------------------------------------

SWITCHES = dict(sliding_window=16, alt_window=True, attn_softcap=50.0,
                final_softcap=30.0, query_scale=256 ** -0.5,
                rms_offset=True, embed_scale=True, sandwich_norms=True,
                hidden_act="gelu_tanh", n_heads=2, n_kv_heads=1,
                head_dim_override=256)
PROMPTS = [list(map(int, np.random.default_rng(22).integers(0, 256, n)))
           for n in (5, 17, 30)]
MAX_NEW, MAX_SEQ = 8, 64


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, params, the port's cfg, params): the tiny Gemma 2 at head
    dim 256, its norm weights drawn about 0 (the identity scale)."""
    jcfg = jl.tiny_config(**SWITCHES)
    wnp = jax.tree.map(np.asarray, jl.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(20)
    for layer in wnp["layers"]:
        for key in [k for k in layer if k.endswith("norm")]:
            layer[key] = _randn(rng, *layer[key].shape, scale=0.2)
    wnp["norm"] = _randn(rng, jcfg.dim, scale=0.2)
    # the embedding drawn at 1 / sqrt(dim) of JAX's scale, so that after the
    # sqrt(dim) embedding scale the residual stream does not drown the
    # layers' outputs and greedy decoding does more than repeat its input
    wnp["embed"] = (wnp["embed"] / np.sqrt(jcfg.dim)).astype(np.float32)
    tcfg = tl.tiny_config(**SWITCHES)
    assert tcfg.head_dim == jcfg.head_dim == D
    return (jcfg, jax.tree.map(jnp.asarray, wnp), tcfg,
            params_from_numpy(wnp, "cpu"))


def test_forward_and_ragged_forward_match_jax(model):
    """forward over 2 x 32 tokens (past the window of 16) and
    forward_ragged at lengths 32 / 11, logits at 1e-4."""
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(21).integers(0, 256, (2, 32)).astype(
        np.int32)
    want = jl.forward(jparams, jnp.asarray(toks), jcfg)
    got = tl.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    lengths = np.array([32, 11], np.int32)
    jlog, _ = jl.forward_ragged(jparams, jnp.asarray(toks),
                                jnp.asarray(lengths), jcfg)
    tlog, _ = tl.forward_ragged(tparams, torch.from_numpy(toks),
                                torch.from_numpy(lengths), tcfg)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(tlog[b, :n].numpy(),
                                   np.asarray(jlog)[b, :n], **MODEL_TOL)


def _jax_caches(jcfg, kind, B, S, page):
    if kind == "paged":
        return jl.init_paged_kv_caches(jcfg, B * S // page + 1, page)
    return jl.init_kv_caches(jcfg, B, S,
                             quant="int8" if kind == "int8" else None)


@pytest.mark.parametrize("kind", ["contiguous", "paged", "int8", "fused"])
def test_decode_steps_match_jax(model, kind):
    """24 decode steps of two sequences from an empty cache (past the
    window of 16), teacher-forced on seeded tokens: the logits of every
    step against JAX's decode_step over the same kind of cache. The paged
    caches (pages of 16) share one shuffled table on both sides; the int8
    cache is held against JAX's int8 cache; the fused params
    (``fuse_params``: a dense wqkv, so every layer takes the fused
    norm->QKV->RoPE block) against JAX's UNFUSED params, since JAX's
    ``fuse_params`` leaves Gemma 2's sandwich norms out."""
    jcfg, jparams, tcfg, tparams = model
    B, S, page, steps = 2, 32, 16, 24
    rng = np.random.default_rng(23)
    toks = rng.integers(0, 256, (steps, B)).astype(np.int32)
    table = None
    if kind == "paged":
        table = (rng.permutation(np.arange(1, B * S // page + 1))
                 .astype(np.int32).reshape(B, S // page))
    jcaches = _jax_caches(jcfg, kind, B, S, page)
    if kind == "paged":
        tcaches = tl.init_paged_kv_caches(tcfg, B * S // page + 1, page,
                                          device="cpu")
    else:
        tcaches = tl.init_kv_caches(tcfg, B, S, device="cpu",
                                    quant="int8" if kind == "int8" else None)
    params = tl.fuse_params(tparams) if kind == "fused" else tparams
    if kind == "fused":
        assert all(tl._takes_fused_qkv(layer, tcfg)
                   for layer in params["layers"])
        assert "post_attn_norm" in params["layers"][0]
    tol = INT8_TOL if kind == "int8" else MODEL_TOL
    jkw = {} if table is None else {"page_table": jnp.asarray(table)}
    tkw = {} if table is None else {"page_table": torch.from_numpy(table)}
    for t in range(steps):
        lens = np.full(B, t, np.int32)
        jlog, jcaches = jl.decode_step(jparams, jnp.asarray(toks[t]), jcaches,
                                       jnp.asarray(lens), jcfg, **jkw)
        tlog, tcaches = tl.decode_step(params, torch.from_numpy(toks[t]),
                                       tcaches, torch.from_numpy(lens), tcfg,
                                       **tkw)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol,
                                   err_msg=f"step {t}")


def _jax_greedy(jcfg, jparams):
    """Each prompt alone through JAX's decode_step, token by token: the
    MAX_NEW greedy tokens after it."""
    out = []
    for prompt in PROMPTS:
        caches = jl.init_kv_caches(jcfg, 1, MAX_SEQ)
        seq = list(prompt)
        for t in range(len(prompt) + MAX_NEW - 1):
            logits, caches = jl.decode_step(
                jparams, jnp.asarray([seq[t]], jnp.int32), caches,
                jnp.asarray([t], jnp.int32), jcfg)
            if t >= len(prompt) - 1:
                seq.append(int(jnp.argmax(logits[0])))
        out.append(seq[len(prompt):])
    return out


@pytest.fixture(scope="module")
def reference(model):
    jcfg, jparams, _, _ = model
    return _jax_greedy(jcfg, jparams)


SETUPS = {
    "contiguous": {},
    "paged": dict(paged=True, page_size=16),
    "prefill_chunk": dict(paged=True, page_size=16, prefill_chunk=16),
    "speculative": dict(spec_k=2),
    "paged speculative fused": dict(paged=True, page_size=16, spec_k=2),
}


@pytest.mark.parametrize("setup", list(SETUPS))
def test_engine_serves_like_jax_decode_step(model, reference, setup):
    """Three requests (5, 17 and 30 tokens, 8 new each) through the Engine:
    one ragged admission or chunked prefill of 16 tokens a tick, then decode
    or speculative ticks (the draft: the model's first layer, so the ticks
    accept and reject). Every token equals JAX's
    decode_step. The last set-up serves fused params as the target."""
    _, _, tcfg, tparams = model
    params = tl.fuse_params(tparams) if "fused" in setup else tparams
    draft = None
    if "speculative" in setup:
        draft = ({**tparams, "layers": tparams["layers"][:1]},
                 dataclasses.replace(tcfg, n_layers=1))
    eng = Engine(params, tcfg, EngineConfig(
        slots=3, max_seq=MAX_SEQ, prefill_bucket=16, **SETUPS[setup]),
        draft=draft, device="cpu")
    got = eng.run(PROMPTS, MAX_NEW)
    assert list(got.values()) == reference
    if draft is not None:
        assert 0 < eng._accepted < eng._proposed
    assert eng.recoveries == 0 and eng.preemptions == 0


def test_loss_and_gradients_match_jax(model):
    """loss_fn over 2 x 32 tokens and every gradient against jax.grad of
    JAX's: the FA-2 backward at head dim 256 through the band and the
    caps."""
    jcfg, jparams, tcfg, _ = model
    toks = np.random.default_rng(24).integers(0, 256, (2, 32)).astype(
        np.int32)
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(jparams, jnp.asarray(toks),
                                                   jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    for _, p in tl.named_leaves(tparams):
        p.requires_grad_(True)
    loss = tl.loss_fn(tparams, torch.from_numpy(toks), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jflat = dict(tl.named_leaves(jax.tree.map(np.asarray, jgrads)))
    for name, p in tl.named_leaves(tparams):
        np.testing.assert_allclose(p.grad.numpy(), jflat[name], atol=1e-4,
                                   rtol=1e-3, err_msg=name)


# --- the configs -----------------------------------------------------------

# google/gemma-2-9b's and google/gemma-2-2b's config.json, the fields
# config_from_hf reads and the ones around them.
GEMMA2_9B_HF = {
    "architectures": ["Gemma2ForCausalLM"], "attention_bias": False,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "head_dim": 256, "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "hidden_size": 3584,
    "intermediate_size": 14336, "max_position_embeddings": 8192,
    "model_type": "gemma2", "num_attention_heads": 16,
    "num_hidden_layers": 42, "num_key_value_heads": 8,
    "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "sliding_window": 4096, "vocab_size": 256000,
}
GEMMA2_2B_HF = {**GEMMA2_9B_HF, "hidden_size": 2304,
                "intermediate_size": 9216, "num_attention_heads": 8,
                "num_hidden_layers": 26, "num_key_value_heads": 4}


@pytest.mark.parametrize("name,hf,n_params", [
    ("gemma2_9b_config", GEMMA2_9B_HF, 9.24e9),
    ("gemma2_2b_config", GEMMA2_2B_HF, 2.61e9)])
def test_gemma2_config_matches_jax_loader(name, hf, n_params):
    """The configs chip_smoke.py serves as Gemma-2-9B and trains as
    Gemma-2-2B are, field for field, what JAX's config_from_hf makes of the
    published configs: head dim 256 (not hidden / heads), a window of 4096
    on the even layers, both caps, query scale 256^-0.5; and their
    parameter counts (tied embedding) are the published sizes."""
    from leetcuda_tpu.models.loader import config_from_hf

    want = config_from_hf(hf)
    got = getattr(tl, name)()
    for f in dataclasses.fields(jl.ModelConfig):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got.head_dim == 256 != got.dim // got.n_heads
    assert [got.layer_window(i) for i in range(4)] == [4096, None, 4096,
                                                       None]
    D_, H, Hkv, F_ = got.dim, got.n_heads, got.n_kv_heads, got.ffn_dim
    layer = (D_ * (H + 2 * Hkv) * 256 + H * 256 * D_ + 3 * D_ * F_ + 4 * D_)
    total = got.vocab_size * D_ + D_ + got.n_layers * layer
    assert abs(total / n_params - 1) < 5e-3
