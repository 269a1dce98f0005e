"""The port's fused decode entry block against the JAX package's.

On this CPU the wrappers run their plain PyTorch versions (the unfused
composition with the kernel's roundings; the CUDA kernel is held against
these same plain versions by ``chip_smoke.py``) and the JAX kernels run in
Pallas interpret mode, as their own tests run them. Tolerances: 1e-4 in f32
(the bar of tests/test_decode.py for the fused block: f32 sums in another
order) and the op registry's 3e-2 in bf16 (one bf16 ulp at the outputs'
magnitude of 2-4 is 1.6e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.gemm.fused_decode import (make_fused_norm_matmul,
                                            make_fused_norm_qkv_rope)
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.gemm import fused_decode as fd
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import params_from_numpy

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _operands(rng, dtype, B, D, X):
    """x, a norm weight around 1 (around 0 for the (1 + w) offset) and a
    weight scaled for unit outputs, as numpy arrays of ``dtype``."""
    jdt = jnp.dtype(dtype)
    x = np.asarray(jnp.asarray(rng.standard_normal((B, D)), jdt))
    nw = np.asarray(jnp.asarray(rng.standard_normal(D) * 0.2 + 1, jdt))
    w = np.asarray(jnp.asarray(rng.standard_normal((D, X)) / np.sqrt(D), jdt))
    return x, nw, w


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms_offset", [False, True])
@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_fused_norm_qkv_rope_matches_pallas(dtype, rms_offset, Dh):
    rng = np.random.default_rng(Dh + rms_offset)
    B, D, H, Hkv = 4, 256, 4, 2
    x, nw, w = _operands(rng, dtype, B, D, (H + 2 * Hkv) * Dh)
    if rms_offset:
        nw = (nw - 1).astype(nw.dtype)
    pos = np.array([0, 5, 100, 2047], np.int32)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=Dh, eps=1e-5, theta=1e4,
              rms_offset=rms_offset)
    want = make_fused_norm_qkv_rope(**kw)(
        jnp.asarray(x), jnp.asarray(nw), jnp.asarray(w), jnp.asarray(pos))
    tx, tnw, tw = params_from_numpy([x, nw, w], "cpu")
    before = fd.FUSED_QKV.launches
    got = fd.fused_norm_qkv_rope(tx, tnw, tw, torch.from_numpy(pos), **kw)
    assert fd.FUSED_QKV.launches == before  # the plain path on CPU tensors
    assert got.dtype == tx.dtype and got.shape == (B, (H + 2 * Hkv) * Dh)
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **TOL[dtype])
    # position 0 leaves q and k unrotated; v (the last Hkv heads) never is
    plain = fd.fused_norm_matmul(tx, tnw, tw, eps=1e-5,
                                 rms_offset=rms_offset)
    assert torch.equal(got[0], plain[0])
    assert torch.equal(got[:, (H + Hkv) * Dh:], plain[:, (H + Hkv) * Dh:])
    assert not torch.equal(got[1, :Dh], plain[1, :Dh])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms_offset", [False, True])
def test_fused_norm_matmul_matches_pallas(dtype, rms_offset):
    rng = np.random.default_rng(7 + rms_offset)
    x, nw, w = _operands(rng, dtype, 8, 256, 1024)
    want = make_fused_norm_matmul(rms_offset=rms_offset)(
        jnp.asarray(x), jnp.asarray(nw), jnp.asarray(w))
    tx, tnw, tw = params_from_numpy([x, nw, w], "cpu")
    before = fd.FUSED_NM.launches
    got = fd.fused_norm_matmul(tx, tnw, tw, rms_offset=rms_offset)
    assert fd.FUSED_NM.launches == before
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **TOL[dtype])


def test_fused_plain_is_the_models_unfused_path():
    """The plain version IS the model's unfused entry block, bit for bit in
    bf16: ``_attn_in`` over a fused dense layer (norm, product, split,
    RoPE)."""
    rng = np.random.default_rng(3)
    cfg = tl.tiny_config(dtype=torch.bfloat16)
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x, nw, w = params_from_numpy(
        _operands(rng, "bfloat16", 3, cfg.dim, (H + 2 * Hkv) * Dh), "cpu")
    pos = torch.tensor([0, 17, 300], dtype=torch.int32)
    q, k, v = tl._attn_in({"attn_norm": nw, "wqkv": w}, x[:, None],
                          pos[:, None], cfg, 0)
    got = fd.fused_norm_qkv_rope_plain(
        x, nw, w, pos, n_heads=H, n_kv_heads=Hkv, head_dim=Dh,
        eps=cfg.norm_eps, theta=cfg.rope_theta)
    want = torch.cat([t.reshape(3, -1) for t in (q, k, v)], dim=-1)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def both():
    jcfg = jl.tiny_config()
    jparams = jl.init_params(jax.random.key(0), jcfg)
    jfused = jl.fuse_params(jparams)
    return (jcfg, jparams, jfused, tl.tiny_config(),
            params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
            params_from_numpy(jax.tree.map(np.asarray, jfused), "cpu"))


def _spy(monkeypatch):
    """Count the model's calls of the fused wrapper (on CPU tensors the
    wrapper runs its plain version, so its launch counter stays put)."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return fd.fused_norm_qkv_rope(*args, **kw)

    monkeypatch.setattr(tl, "fused_norm_qkv_rope", spy)
    return calls


def test_decode_step_fused_dense_params_matches_jax(both, monkeypatch):
    """A decode step over JAX's ``fuse_params`` output (a dense ``wqkv``,
    carried by ``params_from_numpy``) and a cache of capacity 2048, where
    the JAX model takes its Pallas block: logits and the appended K/V at
    1e-4, against JAX and against the port's own unfused params. The port
    takes the fused wrapper in every layer, at any capacity."""
    jcfg, jparams, jfused, tcfg, tparams, tfused = both
    layer = tfused["layers"][0]
    assert isinstance(layer["wqkv"], torch.Tensor) and "wq" not in layer
    assert torch.equal(layer["wqkv"], torch.cat(
        [tparams["layers"][0][k] for k in ("wq", "wk", "wv")], dim=1))
    calls = _spy(monkeypatch)
    toks = np.array([3, 7], np.int32)
    lens = np.array([0, 11], np.int32)
    jlog, jcaches = jl.decode_step(jfused, jnp.asarray(toks),
                                   jl.init_kv_caches(jcfg, 2, 2048),
                                   jnp.asarray(lens), jcfg)
    caches = tl.init_kv_caches(tcfg, 2, 2048, device="cpu")
    tlog, _ = tl.decode_step(tfused, torch.from_numpy(toks), caches,
                             torch.from_numpy(lens), tcfg)
    assert len(calls) == tcfg.n_layers
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               **TOL["float32"])
    for jc, tc in zip(jcaches, caches):
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key][:, :, :12].numpy(),
                                       np.asarray(jc[key][:, :, :12]),
                                       **TOL["float32"])
    # a small cache takes the fused wrapper too (no capacity gate), and the
    # unfused params compute the same function without it
    del calls[:]
    small, _ = tl.decode_step(tfused, torch.from_numpy(toks),
                              tl.init_kv_caches(tcfg, 2, 16, device="cpu"),
                              torch.from_numpy(lens), tcfg)
    assert len(calls) == tcfg.n_layers
    unfused, _ = tl.decode_step(tparams, torch.from_numpy(toks),
                                tl.init_kv_caches(tcfg, 2, 16, device="cpu"),
                                torch.from_numpy(lens), tcfg)
    assert len(calls) == tcfg.n_layers  # none added
    np.testing.assert_allclose(small.numpy(), tlog.numpy(), **TOL["float32"])
    np.testing.assert_allclose(unfused.numpy(), tlog.numpy(),
                               **TOL["float32"])


@pytest.mark.parametrize("case", ["dense", "pack", "bq", "q_norm",
                                  "rope_scaling", "nope_interval", "split"])
def test_decode_step_takes_fused_block_only_where_it_computes_the_layer(
        both, monkeypatch, case):
    """The fused kernel computes a layer's entry block only for a dense
    fused ``wqkv`` behind an ``attn_norm``, without biases, q/k norms or a
    rotary other than the plain one: everything else runs unfused."""
    _, _, _, tcfg, tparams, tfused = both
    params, cfg, expect = tfused, tcfg, 0
    if case == "dense":
        expect = tcfg.n_layers
    elif case == "pack":
        params = tl.quantize_params(tfused, "int8")
    elif case == "bq":
        H, Hkv, Dh = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim
        params = {**tfused, "layers": [
            {**layer, "bq": torch.zeros(H * Dh), "bk": torch.zeros(Hkv * Dh),
             "bv": torch.zeros(Hkv * Dh)} for layer in tfused["layers"]]}
    elif case == "q_norm":
        cfg = dataclasses.replace(tcfg, qk_norm=True)
        params = {**tfused, "layers": [
            {**layer, "q_norm": torch.ones(tcfg.head_dim),
             "k_norm": torch.ones(tcfg.head_dim)}
            for layer in tfused["layers"]]}
    elif case == "rope_scaling":
        cfg = dataclasses.replace(tcfg, rope_scaling=("linear", 2.0))
    elif case == "nope_interval":
        cfg = dataclasses.replace(tcfg, nope_interval=2)
    elif case == "split":
        params = tparams
    calls = _spy(monkeypatch)
    logits, _ = tl.decode_step(
        params, torch.tensor([5, 9]),
        tl.init_kv_caches(cfg, 2, 16, device="cpu"),
        torch.tensor([0, 3], dtype=torch.int32), cfg)
    assert len(calls) == expect
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()


def test_fused_wrappers_check_their_operands():
    x, nw, w = torch.zeros(2, 64), torch.ones(64), torch.zeros(64, 256)
    pos = torch.zeros(2, dtype=torch.int32)
    kw = dict(n_heads=2, n_kv_heads=1, head_dim=64)
    assert fd.fused_norm_qkv_rope(x, nw, w, pos, **kw).shape == (2, 256)
    with pytest.raises(ValueError):  # X is not (H + 2 Hkv) Dh
        fd.fused_norm_qkv_rope(x, nw, w[:, :192], pos, **kw)
    with pytest.raises(ValueError):  # one position per row
        fd.fused_norm_qkv_rope(x, nw, w, pos[:1], **kw)
    with pytest.raises(ValueError):  # positions are integers
        fd.fused_norm_qkv_rope(x, nw, w, pos.float(), **kw)
    with pytest.raises(ValueError):  # norm weight of the wrong length
        fd.fused_norm_matmul(x, nw[:32], w)
    with pytest.raises(ValueError):  # w rows != x columns
        fd.fused_norm_matmul(x, nw, w[:32])
