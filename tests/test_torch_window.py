"""The port's sliding-window, softcapped model against the JAX package's: the
Engine in every set-up, and training.

A tiny f32 model (``tiny_config``: 2 layers, 4 / 2 heads of 64) with Gemma
2's attention switches: a window of 8 on the even layer (``alt_window``; the
odd layer attends globally) and an attention cap of 1.0, which bends the
tiny model's unit-scale scores. Prompts of 5, 17 and 30 tokens and 8 new
tokens each put the band inside and past every prompt, so the window and the
cap act in each kernel a set-up runs: the ragged and the plain flash forward
at admission, decode over a contiguous, int8 or paged cache, the chunk
kernel of chunked prefill and of speculative verify. Weights cross from
JAX's random init through ``params_from_numpy``.

The reference is JAX's ``decode_step``, one prompt at a time, token by
token, greedy (its decode kernel in Pallas interpret mode): the port's
Engine must serve EQUAL tokens. Over an int8 KV cache the reference is JAX's
Engine in the same set-up: there the admission attends the prompt's
unquantized K/V and decode_step the quantized ones, two functions that JAX's
own Engine and decode_step already tell apart on the third prompt (a
near-tie token flips). Training holds ``loss_fn`` at rtol 1e-5 and
every gradient at atol 1e-4 / rtol 1e-3 against ``jax.grad`` (tests/
test_torch_moe.py's bar: f32 sums in another order through two layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.engine import Engine, EngineConfig
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import params_from_numpy

SWITCHES = dict(sliding_window=8, alt_window=True, attn_softcap=1.0)
PROMPTS = [list(map(int, np.random.default_rng(12).integers(0, 256, n)))
           for n in (5, 17, 30)]
MAX_NEW, MAX_SEQ = 8, 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, params, the port's cfg, params) of the windowed, capped
    tiny model."""
    jcfg = jl.tiny_config(**SWITCHES)
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tl.tiny_config(**SWITCHES), tparams


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
}


@pytest.mark.parametrize("setup", list(SETUPS))
def test_engine_serves_like_jax_decode_step(model, reference, setup):
    """Three requests admitted together (one ragged admission; chunked
    prefill: 16 prompt tokens a tick through decode_chunk), then decode or
    speculative ticks: every token equals JAX's decode_step. The
    speculative set-up verifies with decode_chunk, which must pass each
    layer's window to the chunk kernel; its draft is the same weights
    with neither window nor cap, so the ticks accept and reject."""
    _, _, tcfg, tparams = model
    draft = (tparams, tl.tiny_config()) if setup == "speculative" else None
    eng = Engine(tparams, tcfg, EngineConfig(
        slots=3, max_seq=MAX_SEQ, prefill_bucket=16, **SETUPS[setup]),
        draft=draft, device="cpu")
    got = eng.run(PROMPTS, MAX_NEW)
    assert list(got.values()) == reference
    if setup == "speculative":
        assert 0 < eng._accepted < eng._proposed
    assert eng.recoveries == 0 and eng.preemptions == 0


def test_engine_int8_kv_serves_like_jax_engine(model, reference):
    """The same requests over an int8 KV cache (the scales fold before the
    cap on both sides) against JAX's Engine over an int8 cache, token for
    token; the first two prompts' tokens also equal the f32 decode_step's."""
    from leetcuda_tpu.engine import Engine as JEngine
    from leetcuda_tpu.engine import EngineConfig as JEngineConfig

    jcfg, jparams, tcfg, tparams = model
    ecfg = dict(slots=3, max_seq=MAX_SEQ, prefill_bucket=16, kv_quant="int8")
    want = JEngine(jparams, jcfg, JEngineConfig(**ecfg)).run(PROMPTS, MAX_NEW)
    eng = Engine(tparams, tcfg, EngineConfig(**ecfg), device="cpu")
    got = list(eng.run(PROMPTS, MAX_NEW).values())
    assert got == [list(map(int, t)) for t in want.values()]
    assert got[:2] == reference[:2]


def test_decode_chunk_passes_each_layers_window(model):
    """decode_chunk over a prefix past the window against JAX's: logits of
    a 4-token chunk after 20 cached positions (the band of the even layer
    starts at 13..16)."""
    from leetcuda_tpu.engine import speculative as jspec
    from leetcuda_tpu_torch.engine import speculative as tspec

    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(13)
    shape = (2, jcfg.n_kv_heads, 32, jcfg.head_dim)
    cache_np = [{"k": rng.standard_normal(shape, dtype=np.float32),
                 "v": rng.standard_normal(shape, dtype=np.float32)}
                for _ in range(jcfg.n_layers)]
    toks = rng.integers(0, 256, (2, 4)).astype(np.int32)
    lens = np.array([20, 9], np.int32)
    want, _ = jspec.decode_chunk(jparams, jnp.asarray(toks),
                                 jax.tree.map(jnp.asarray, cache_np),
                                 jnp.asarray(lens), jcfg)
    got, _ = tspec.decode_chunk(tparams, torch.from_numpy(toks),
                                params_from_numpy(cache_np, "cpu"),
                                torch.from_numpy(lens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    # without the window on the even layer the logits are another function
    nowin, _ = tspec.decode_chunk(
        tparams, torch.from_numpy(toks), params_from_numpy(cache_np, "cpu"),
        torch.from_numpy(lens),
        dataclasses.replace(tcfg, sliding_window=None))
    assert float((nowin - got).abs().max()) > 1e-2


def test_loss_and_gradients_match_jax(model):
    """loss_fn over 2 x 32 tokens and every gradient against jax.grad of
    JAX's: the FA-2 backward through the band and the cap."""
    jcfg, jparams, tcfg, _ = model
    toks = np.random.default_rng(14).integers(0, 256, (2, 32)).astype(
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
