"""The port's training path against the JAX package's, on one set of weights.

``tiny_config()`` (f32): the JAX package's random init goes to numpy and
through ``params_from_numpy`` into the port. The JAX side runs its Pallas
kernels in interpret mode, its FA-2 backward included. ``loss_fn`` agrees at
rtol 1e-5. Three AdamW steps (``make_train_step(remat=False)``, lr 1e-3)
agree at rtol 1e-4 on every loss, at atol 1e-4 / rtol 1e-3 on step 1's
gradients, and at atol 2e-4 on the parameters after 3 steps: a fifth of one
AdamW step, whose size is about the learning rate for every weight. That bar
holds where step 1's gradient stands clear of Adam's eps (|g| > 1e-6): at
|g| ~ eps = 1e-8 the first update g / (|g| + eps) turns on f32 rounding in
the backward's sums, so such elements (3 in 10^4 here) are held only to
the 3 lr that three steps can move any weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.attention import flash_bwd as fb
from leetcuda_tpu_torch.attention.flash import flash_attention
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import (params_from_numpy,
                                               params_to_numpy)

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """JAX's tiny config and its random weights as numpy arrays."""
    jcfg = jl.tiny_config()
    return jcfg, jax.tree.map(np.asarray, jl.init_params(jax.random.key(0),
                                                         jcfg))


def _tokens(seed, B=2, S=64):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


def _grads(tparams):
    """Each parameter's gradient as numpy, in jax.tree_util's leaf order
    (dict keys sorted)."""
    return jax.tree_util.tree_leaves(params_to_numpy(
        jax.tree.map(lambda p: p.grad, tparams)))


def test_loss_fn_matches_jax(weights):
    jcfg, wnp = weights
    toks = _tokens(0)
    want = float(jl.loss_fn(jax.tree.map(jnp.asarray, wnp),
                            jnp.asarray(toks), jcfg))
    got = tl.loss_fn(params_from_numpy(wnp, "cpu"), torch.from_numpy(toks),
                     tl.tiny_config())
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_train_steps_match_jax(weights):
    jcfg, wnp = weights
    toks = [_tokens(s) for s in (1, 2, 3)]
    jparams = jax.tree.map(jnp.asarray, wnp)
    jgrads = jax.grad(jl.loss_fn)(jparams, jnp.asarray(toks[0]), jcfg)
    jinit, jstep = jl.make_train_step(jcfg, learning_rate=LR, remat=False)
    jopt = jinit(jparams)
    tparams = params_from_numpy(wnp, "cpu")
    tinit, tstep = tl.make_train_step(tl.tiny_config(), learning_rate=LR,
                                      remat=False)
    topt = tinit(tparams)
    for i, t in enumerate(toks):
        jparams, jopt, jloss = jstep(jparams, jopt, jnp.asarray(t))
        tparams, topt, tloss = tstep(tparams, topt, torch.from_numpy(t))
        assert tloss.dim() == 0 and not tloss.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4,
                                   err_msg=f"loss of step {i + 1}")
        if i == 0:  # the port's grads stay on the params until the next step
            for got, want in zip(_grads(tparams),
                                 jax.tree_util.tree_leaves(jgrads)):
                np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                           rtol=1e-3)
    got = jax.tree_util.tree_leaves(params_to_numpy(tparams))
    clear = [np.abs(np.asarray(g)) > 1e-6
             for g in jax.tree_util.tree_leaves(jgrads)]
    assert sum(c.size - c.sum() for c in clear) < 1e-3 * sum(
        c.size for c in clear)
    for g, w, c in zip(got, jax.tree_util.tree_leaves(jparams), clear):
        np.testing.assert_allclose(g[c], np.asarray(w)[c], atol=2e-4, rtol=0)
        np.testing.assert_allclose(g, np.asarray(w), atol=3 * LR, rtol=0)


def test_remat_gives_the_same_grads(weights):
    _, wnp = weights
    toks = torch.from_numpy(_tokens(4))
    grads = {}
    for remat in (False, True):
        tparams = params_from_numpy(wnp, "cpu")
        for _, p in tl.named_leaves(tparams):
            p.requires_grad_(True)
        tl.loss_fn(tparams, toks, tl.tiny_config(), remat=remat).backward()
        grads[remat] = _grads(tparams)
    for a, b in zip(grads[False], grads[True]):
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)


def test_remat_runs_each_layer_forward_twice(weights, monkeypatch):
    """Under non-reentrant checkpointing a layer's forward (and so its
    flash forward with lse) runs once in the forward and once more in the
    backward."""
    _, wnp = weights
    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("with_lse", False))
        return flash_attention(*args, **kw)

    monkeypatch.setattr(fb, "flash_attention", spy)
    cfg = tl.tiny_config()
    for remat, n in ((False, cfg.n_layers), (True, 2 * cfg.n_layers)):
        tparams = params_from_numpy(wnp, "cpu")
        for _, p in tl.named_leaves(tparams):
            p.requires_grad_(True)
        calls.clear()
        tl.loss_fn(tparams, torch.from_numpy(_tokens(5)), cfg,
                   remat=remat).backward()
        assert calls == [True] * n, (remat, calls)


def test_serving_forward_takes_the_inference_kernel(weights, monkeypatch):
    """A forward whose params require no gradient calls flash_attention
    without with_lse: serving launches what it launched before training
    was ported. A spy, because the launch counters do not move on the
    CPU."""
    _, wnp = weights
    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("with_lse", False))
        return flash_attention(*args, **kw)

    monkeypatch.setattr(fb, "flash_attention", spy)
    cfg = tl.tiny_config()
    tl.forward(params_from_numpy(wnp, "cpu"), torch.from_numpy(_tokens(6)),
               cfg)
    assert calls == [False] * cfg.n_layers


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"fsdp": True}])
def test_train_step_mesh_and_fsdp_raise(kw):
    with pytest.raises(NotImplementedError):
        tl.make_train_step(tl.tiny_config(), **kw)


def test_train_step_with_sinks_matches_jax():
    """Attention sinks train (ROADMAP item 11b2), with a window and the
    softcap: one AdamW step of the tiny sink model against JAX's, the loss
    at rtol 1e-4 and every parameter, the sinks included, within a fifth of
    an AdamW step (atol 2e-4) of JAX's where the gradient stands clear of
    Adam's eps, and within the learning rate elsewhere (the module
    docstring says why); the sinks move."""
    kw = dict(attn_sinks=True, sliding_window=16, attn_softcap=30.0)
    jcfg = jl.tiny_config(**kw)
    wnp = jax.tree.map(np.asarray, jl.init_params(jax.random.key(0), jcfg))
    toks = _tokens(4, S=32)
    jinit, jstep = jl.make_train_step(jcfg, learning_rate=LR, remat=False)
    jparams = jax.tree.map(jnp.asarray, wnp)
    clear = [np.abs(np.asarray(g)) > 1e-6 for g in jax.tree_util.tree_leaves(
        jax.grad(jl.loss_fn)(jparams, jnp.asarray(toks), jcfg))]
    jparams, _, jloss = jstep(jparams, jinit(jparams), jnp.asarray(toks))
    tparams = params_from_numpy(wnp, "cpu")
    tinit, tstep = tl.make_train_step(tl.tiny_config(**kw),
                                      learning_rate=LR, remat=False)
    tparams, _, tloss = tstep(tparams, tinit(tparams), torch.from_numpy(toks))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    for g, w, c in zip(jax.tree_util.tree_leaves(params_to_numpy(tparams)),
                       jax.tree_util.tree_leaves(jparams), clear):
        np.testing.assert_allclose(g[c], np.asarray(w)[c], atol=2e-4, rtol=0)
        np.testing.assert_allclose(g, np.asarray(w), atol=LR, rtol=0)
    moved = tparams["layers"][0]["sinks"].detach().numpy() - wnp[
        "layers"][0]["sinks"]
    assert np.abs(moved).min() > 0.5 * LR


def test_params_to_numpy_round_trip_bit_exact():
    x = jax.random.normal(jax.random.key(1), (5, 7), jnp.bfloat16)
    tree = {"w": [np.asarray(x)], "b": np.arange(3, dtype=np.float32)}
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert back["w"][0].dtype == np.asarray(x).dtype
    np.testing.assert_array_equal(back["w"][0].view(np.int16),
                                  np.asarray(x).view(np.int16))
    np.testing.assert_array_equal(back["b"], tree["b"])
