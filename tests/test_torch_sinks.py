"""Attention sinks in the port against the JAX package: the ``with_lse``
option of the decode, paged and chunk kernels, and a tiny sink model through
every path and the Engine.

Kernels. The eight ``with_lse`` entry points (decode bf16 / int8 / e4m3,
paged bf16 / int8 / e4m3, chunk over the four cache layouts) run their plain
versions on these CPU tensors and are held, output and lse, against the JAX
factories with ``with_lse=True`` in Pallas interpret mode at atol 1e-5 (f32,
the same algorithm summed in another order; the lse of a row that attends
nothing is -1e30 on both sides and compared exactly). GPT-OSS's shape: a
GQA group of 8 at head dim 64. Windows and caps as tests/test_torch_window.py
draws them (window 8, cap 1.0), with decode lengths 0, below, at and past the
window and chunk rows below, at and past it; NaN (e4m3: the NaN byte) past
every length in the port's caches. JAX's paged kernel is handed finite pools
(it reads whole pages), the port's pools hold NaN wherever no row owns a
position. Every numpy array that is poisoned after building JAX's arguments
reaches JAX as a copy (``jnp.array``), so no asynchronous JAX call can see
the poison.

Model. ``tiny_config(attn_sinks=True, sliding_window=8, alt_window=True)``
(f32): JAX's random init, sinks included, crosses through
``params_from_numpy``. forward, forward_ragged and decode over the
contiguous, int8, e4m3, paged and paged int8 caches at atol/rtol 1e-4
(tests/test_torch_model.py's bar); ``loss_fn`` at rtol 1e-5 and every
gradient, the sinks' among them, at atol 1e-4 / rtol 1e-3 against
``jax.grad`` (tests/test_torch_window.py's bar). The Engine serves token for
token as JAX's ``decode_step`` (contiguous, paged, prefix cache with chunked
prefill, speculative) and as JAX's Engine over int8 KV.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.attention.chunk import (make_chunk_attention,
                                          make_paged_chunk_attention)
from leetcuda_tpu.attention.decode import (make_decode_attention,
                                           make_decode_attention_quantized)
from leetcuda_tpu.attention.paged import make_paged_attention
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.attention import chunk as ck
from leetcuda_tpu_torch.attention import decode as dec
from leetcuda_tpu_torch.attention import paged as pg
from leetcuda_tpu_torch.core.runtime import launch_counts
from leetcuda_tpu_torch.engine import Engine, EngineConfig
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import params_from_numpy

ATOL = 1e-5
NEG = np.float32(-1e30)
H, HKV, D = 16, 2, 64              # GPT-OSS's group of 8 at head dim 64
_QDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
# (window, softcap) as tests/test_torch_window.py draws them
OPTS = [(None, None), (8, None), (None, 1.0), (8, 1.0)]
OPT_IDS = ["global", "window 8", "cap 1", "window 8 cap 1"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _poison(a, dead):
    """NaN (e4m3: 0x7F; int8: 0) wherever ``dead``, in place (numpy)."""
    if a.dtype.name == "float8_e4m3fn":
        a.view(np.uint8)[dead] = 0x7F
    elif a.dtype == np.int8:
        a[dead] = 0
    else:
        a[dead] = np.nan


def _caches(rng, shape, fmt):
    """Seeded K and V of ``shape`` (f32), or JAX-quantized (values,
    scales) pairs as numpy copies: [k, v] or [kq, vq, ks, vs]."""
    caches = [rng.standard_normal(shape, dtype=np.float32) for _ in range(2)]
    if fmt is None:
        return caches
    quant = [jl._quantize_token_kv(jnp.array(c), _QDT[fmt]) for c in caches]
    return [np.array(quant[0][0]), np.array(quant[1][0]),
            np.array(quant[0][1]), np.array(quant[1][1])]


def _hold(got, want):
    """(out, lse) of the port against JAX's: atol 1e-5, and rows that
    attend nothing carry -1e30 on both sides."""
    out, lse = got
    wout, wlse = (np.asarray(w, np.float32) for w in want)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), wout, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(lse.numpy() == NEG, wlse == NEG)
    np.testing.assert_allclose(lse.numpy(), wlse, atol=ATOL, rtol=0)


# --- decode and paged ----------------------------------------------------------

DECODE_LENS = [0, 5, 8, 13, 32]    # none, below, at and past the window, all
DECODE_S, PAGE = 32, 8


def _decode_case(seed, fmt):
    """q and caches (5, HKV, 32, D) with NaN past every length: JAX's
    arguments (copies) and the port's tensors."""
    rng = np.random.default_rng(seed)
    B = len(DECODE_LENS)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    caches = _caches(rng, (B, HKV, DECODE_S, D), fmt)
    dead = (np.arange(DECODE_S)[None, :]
            >= np.asarray(DECODE_LENS)[:, None])[:, None, :]
    for c in caches:
        _poison(c, np.broadcast_to(dead, c.shape[:3]))
    args = [q, *caches, np.asarray(DECODE_LENS, np.int32)]
    return [jnp.array(a) for a in args], params_from_numpy(args, "cpu")


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
@pytest.mark.parametrize("window,softcap", OPTS, ids=OPT_IDS)
def test_decode_with_lse_matches_pallas(fmt, window, softcap):
    """decode_attention / decode_attention_quantized with_lse against the
    Pallas kernels (32-key blocks): a row of length 0 gives zeros and lse
    -1e30, a windowed row's lse covers only its window."""
    jargs, targs = _decode_case(20, fmt)
    make = (make_decode_attention if fmt is None
            else make_decode_attention_quantized)
    want = make(block_k=8, window=window, softcap=softcap,
                with_lse=True)(*jargs)
    fn = dec.decode_attention if fmt is None else dec.decode_attention_quantized
    before = launch_counts()
    got = fn(*targs, window=window, softcap=softcap, with_lse=True)
    assert launch_counts() == before  # the plain version runs on the CPU
    assert got[1].shape == (len(DECODE_LENS), H)
    _hold(got, want)
    assert np.all(got[0][0].numpy() == 0) and np.all(got[1][0].numpy() == NEG)
    # the same call without the lse returns the same output alone
    torch.testing.assert_close(fn(*targs, window=window, softcap=softcap),
                               got[0], atol=0, rtol=0)


def _paged_case(seed, fmt):
    """The decode case's caches in shuffled pages of 8: JAX's arguments
    (finite pools) and the port's (NaN wherever no row owns a position)."""
    rng = np.random.default_rng(seed)
    B, P = len(DECODE_LENS), DECODE_S // PAGE
    N = B * P + 1
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    pools = _caches(rng, (N, HKV, PAGE, D), fmt)
    table = np.zeros((B, P), np.int32)
    owned = np.zeros((N, PAGE), bool)
    phys = iter(rng.permutation(np.arange(1, N)))
    for b, n in enumerate(DECODE_LENS):
        for i in range(-(-n // PAGE)):
            table[b, i] = next(phys)
            owned[table[b, i], :min(PAGE, n - i * PAGE)] = True
    jargs = [jnp.array(a) for a in (q, *pools, table, DECODE_LENS)]
    for p in pools:
        _poison(p, np.broadcast_to(~owned[:, None, :], p.shape[:3]))
    targs = params_from_numpy([q, *pools, table,
                               np.asarray(DECODE_LENS, np.int32)], "cpu")
    return jargs, targs


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
@pytest.mark.parametrize("window,softcap", OPTS, ids=OPT_IDS)
def test_paged_with_lse_matches_pallas(fmt, window, softcap):
    """paged_attention / paged_attention_quantized with_lse against the
    Pallas paged kernel; the length-0 row's table is all filler."""
    jargs, targs = _paged_case(21, fmt)
    want = make_paged_attention(quantized=fmt is not None, window=window,
                                softcap=softcap, with_lse=True)(*jargs)
    fn = pg.paged_attention if fmt is None else pg.paged_attention_quantized
    got = fn(*targs, window=window, softcap=softcap, with_lse=True)
    _hold(got, want)


# --- chunk ---------------------------------------------------------------------

CHUNK_S = 64
# (T, bases): the verify shape over bases below, at and past the window of 8,
# and a prefill chunk crossing it; the last base runs rows past the capacity
CHUNK_SHAPES = {"T=4": (4, [0, 4, 9, 30, 61]), "T=16": (16, [0, 3, 40])}


def _chunk_case(seed, T, bases, fmt, paged):
    """q (B, H, T, D) and caches with NaN at or past min(base + T, S);
    paged: shuffled pages of 8, NaN in every page no row owns. Returns JAX's
    arguments (copies) and the port's tensors."""
    rng = np.random.default_rng(seed)
    bases = np.asarray(bases, np.int32)
    B = len(bases)
    q = rng.standard_normal((B, H, T, D), dtype=np.float32)
    caches = _caches(rng, (B, HKV, CHUNK_S, D), fmt)
    end = np.minimum(bases + T, CHUNK_S)
    dead = np.arange(CHUNK_S)[None, :] >= end[:, None]
    for c in caches:
        _poison(c, np.broadcast_to(dead[:, None, :], c.shape[:3]))
    tail = [bases]
    if paged:
        P = CHUNK_S // PAGE
        N = B * P + 1
        table = np.zeros((B, P), np.int32)
        phys = iter(rng.permutation(np.arange(1, N)))
        pools = [np.empty((N, HKV, PAGE) + c.shape[3:], c.dtype)
                 for c in caches]
        for pool in pools:
            _poison(pool, np.ones((N, HKV, PAGE), bool))
        for b in range(B):
            for i in range(-(-int(end[b]) // PAGE)):
                table[b, i] = next(phys)
                for pool, c in zip(pools, caches):
                    pool[table[b, i]] = c[b, :, i * PAGE:(i + 1) * PAGE]
        caches, tail = pools, [table, bases]
    args = [q, *caches, *tail]
    return [jnp.array(a) for a in args], params_from_numpy(args, "cpu")


CHUNK_FNS = {(False, False): ck.chunk_attention,
             (True, False): ck.chunk_attention_quantized,
             (False, True): ck.paged_chunk_attention,
             (True, True): ck.paged_chunk_attention_quantized}


@pytest.mark.parametrize("shape", list(CHUNK_SHAPES))
@pytest.mark.parametrize("fmt,paged", [(None, False), ("int8", False),
                                       (None, True), ("fp8", True)],
                         ids=["contiguous", "int8", "paged", "paged fp8"])
@pytest.mark.parametrize("window,softcap", OPTS, ids=OPT_IDS)
def test_chunk_with_lse_matches_pallas(shape, fmt, paged, window, softcap):
    """The four chunk entry points with_lse against the Pallas chunk
    kernels: lse (B, H, T) over each row's own columns; rows past the
    capacity (base 61, T=4) see the whole cache, or nothing behind a
    window, as the Pallas kernel's rows do."""
    T, bases = CHUNK_SHAPES[shape]
    jargs, targs = _chunk_case(22, T, bases, fmt, paged)
    make = (make_paged_chunk_attention if paged else
            lambda **kw: make_chunk_attention(block_k=16, **kw))
    want = make(window=window, quantized=fmt is not None, softcap=softcap,
                with_lse=True)(*jargs)
    got = CHUNK_FNS[(fmt is not None, paged)](
        *targs, window=window, softcap=softcap, with_lse=True)
    assert got[1].shape == (len(bases), H, T)
    _hold(got, want)


def test_chunk_lse_rows_behind_the_window_past_the_capacity():
    """A row past the capacity whose window lies wholly past it attends
    nothing: zeros and lse -1e30, as the Pallas kernel gives."""
    jargs, targs = _chunk_case(23, 16, [60], None, False)
    want = make_chunk_attention(block_k=16, window=8, with_lse=True)(*jargs)
    got = ck.chunk_attention(*targs, window=8, with_lse=True)
    _hold(got, want)
    # rows t >= 12 sit at positions >= 72 = S + 8: nothing in their window
    assert np.all(got[1][0, :, 12:].numpy() == NEG)
    assert np.all(got[0][0, :, 12:].numpy() == 0)


def test_with_lse_counts_on_its_own_counters():
    """The lse variants count apart from the plain launches: on the CPU
    neither moves, and every ``_lse`` counter exists under its name."""
    names = launch_counts()
    for base in ("decode_attention", "decode_attention_quantized",
                 "paged_attention", "paged_attention_quantized",
                 "chunk_attention", "chunk_attention_quantized",
                 "paged_chunk_attention", "paged_chunk_attention_quantized"):
        assert base in names and base + "_lse" in names


def test_shared_kv_still_raises():
    """shared_kv (MLA's latent cache) takes JAX's calling forms; the
    unshared operands with shared_kv still raise, naming the form."""
    _, targs = _decode_case(24, "int8")
    with pytest.raises(TypeError, match="shared_kv"):
        dec.decode_attention_quantized(*targs, shared_kv=True)
    _, targs = _paged_case(24, "int8")
    with pytest.raises(TypeError, match="shared_kv"):
        pg.paged_attention_quantized(*targs, shared_kv=True)


# --- the tiny sink model -------------------------------------------------------

SWITCHES = dict(attn_sinks=True, sliding_window=8, alt_window=True)
TOL = dict(atol=1e-4, rtol=1e-4)
INT8_TOL = dict(atol=2e-3, rtol=2e-3)  # see test_decode_steps_match_jax
PROMPTS = [list(map(int, np.random.default_rng(25).integers(0, 256, n)))
           for n in (5, 17, 30)]
MAX_NEW, MAX_SEQ = 8, 64


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, params, the port's cfg, params) of the tiny sink model."""
    jcfg = jl.tiny_config(**SWITCHES)
    jparams = jl.init_params(jax.random.key(0), jcfg)
    assert "sinks" in jparams["layers"][0]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tl.tiny_config(**SWITCHES), tparams


def test_init_params_draws_sinks():
    """init_params gives each layer (H,) f32 sinks at 0.5 x normal."""
    cfg = tl.tiny_config(**SWITCHES)
    params = tl.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    sinks = torch.stack([layer["sinks"] for layer in params["layers"]])
    assert sinks.dtype == torch.float32 and sinks.shape == (2, cfg.n_heads)
    assert 0.1 < float(sinks.std()) < 1.5


def test_forward_and_ragged_match_jax(model):
    """forward and forward_ragged (rows past a length: lse -1e30, so the
    sink zeroes nothing it should keep) against JAX's; zeroed sinks move
    the logits."""
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(26).integers(0, 256, (2, 24)).astype(
        np.int32)
    want = jl.forward(jparams, jnp.asarray(toks), jcfg)
    got = tl.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lens = np.array([24, 11], np.int32)
    jlog, jkv = jl.forward_ragged(jparams, jnp.asarray(toks),
                                  jnp.asarray(lens), jcfg)
    tlog, tkv = tl.forward_ragged(tparams, torch.from_numpy(toks),
                                  torch.from_numpy(lens), tcfg)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(tlog[b, :n].numpy(),
                                   np.asarray(jlog)[b, :n], **TOL)
    np.testing.assert_allclose(tkv[1][0].numpy(), np.asarray(jkv[1][0]),
                               **TOL)
    nosink = {**tparams, "layers": [{k: v for k, v in layer.items()
                                     if k != "sinks"}
                                    for layer in tparams["layers"]]}
    alt = tl.forward(nosink, torch.from_numpy(toks), tcfg)
    assert float((alt - got).abs().max()) > 1e-3


CACHES = {"contiguous": dict(), "int8": dict(quant="int8"),
          "fp8": dict(quant="fp8"), "paged": dict(paged=True),
          "paged int8": dict(paged=True, quant="int8")}


@pytest.mark.parametrize("cache", list(CACHES))
def test_decode_steps_match_jax(model, cache):
    """20 decode steps over each cache layout (two rows, pages of 8 in
    shuffled order) against JAX's decode_step: the sink rescales the
    decode kernel's output through its lse, past the window too. Each step
    starts from JAX's cache, so that a K/V value quantized one step apart
    on the two sides (f32 roundoff at a rounding edge) does not carry
    into the later steps. Within a step it still can: over int8 caches one
    appended K value of layer 1 rounds to -30 on one side and -29 on the
    other at step 2 of this seed, which moves the logits by 8.3e-4, so the
    int8 caches are held at atol/rtol 2e-3 (an int8 step is 1/127 of the
    vector's largest value; e4m3's rounding edges are not met here)."""
    jcfg, jparams, tcfg, tparams = model
    kw = CACHES[cache]
    quant, paged = kw.get("quant"), kw.get("paged", False)
    B, steps = 2, 20
    toks = np.random.default_rng(27).integers(0, 256, (B, steps)).astype(
        np.int32)
    table = None
    if paged:
        n_pages = B * (MAX_SEQ // PAGE) + 1
        table = (np.random.default_rng(28).permutation(np.arange(1, n_pages))
                 .reshape(B, -1).astype(np.int32))
        jc = jl.init_paged_kv_caches(jcfg, n_pages, PAGE, quant=quant)
    else:
        jc = jl.init_kv_caches(jcfg, B, MAX_SEQ, quant=quant)
    lens = np.zeros((B,), np.int32)
    for t in range(steps):
        jt = None if table is None else jnp.asarray(table)
        jc_in = jax.tree.map(np.array, jc)
        want, jc = jl.decode_step(jparams, jnp.asarray(toks[:, t]), jc,
                                  jnp.asarray(lens), jcfg, page_table=jt)
        tt = None if table is None else torch.from_numpy(table)
        tc = params_from_numpy(jax.tree.map(np.asarray, jc_in), "cpu")
        got, tc = tl.decode_step(tparams, torch.from_numpy(toks[:, t]), tc,
                                 torch.from_numpy(lens), tcfg, page_table=tt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **(INT8_TOL if quant == "int8" else TOL),
                                   err_msg=f"step {t}")
        lens = lens + 1


def test_loss_and_gradients_match_jax(model):
    """loss_fn over 2 x 32 tokens and every gradient, the sinks' included,
    against jax.grad: the lse cotangent through the FA-2 backward."""
    jcfg, jparams, tcfg, _ = model
    toks = np.random.default_rng(29).integers(0, 256, (2, 32)).astype(
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
    names = [n for n, _ in tl.named_leaves(tparams)]
    assert "layers.0.sinks" in names and "layers.1.sinks" in names
    for name, p in tl.named_leaves(tparams):
        np.testing.assert_allclose(p.grad.numpy(), jflat[name], atol=1e-4,
                                   rtol=1e-3, err_msg=name)
    assert float(tparams["layers"][0]["sinks"].grad.abs().max()) > 0


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
    "prefix_cache": dict(paged=True, page_size=16, prefix_cache=True,
                         prefill_chunk=16),
    "speculative": dict(spec_k=2),
}


@pytest.mark.parametrize("setup", list(SETUPS))
def test_engine_serves_like_jax_decode_step(model, reference, setup):
    """Three requests through the Engine: the ragged admission and decode
    (contiguous, paged), chunked prefill through decode_chunk over a prefix
    cache (the prompts are served twice, so the second wave adopts cached
    pages and prefills only its suffix), and speculative verify (the draft
    is the same weights without sinks, so ticks accept and reject): every
    token equals JAX's decode_step."""
    _, _, tcfg, tparams = model
    draft = None
    if setup == "speculative":
        draft = ({**tparams, "layers": [
            {k: v for k, v in layer.items() if k != "sinks"}
            for layer in tparams["layers"]]}, tl.tiny_config())
    eng = Engine(tparams, tcfg, EngineConfig(
        slots=3, max_seq=MAX_SEQ, prefill_bucket=16, **SETUPS[setup]),
        draft=draft, device="cpu")
    assert list(eng.run(PROMPTS, MAX_NEW).values()) == reference
    if setup == "prefix_cache":
        assert list(eng.run(PROMPTS, MAX_NEW).values()) == reference
        assert eng.pm.hits > 0
    if setup == "speculative":
        assert 0 < eng._accepted < eng._proposed
    assert eng.recoveries == 0 and eng.preemptions == 0


def test_engine_int8_kv_serves_like_jax_engine(model):
    """Over an int8 KV cache, against JAX's Engine in the same set-up,
    token for token (JAX's own Engine and decode_step differ there: its
    admission attends unquantized K/V)."""
    from leetcuda_tpu.engine import Engine as JEngine
    from leetcuda_tpu.engine import EngineConfig as JEngineConfig

    jcfg, jparams, tcfg, tparams = model
    ecfg = dict(slots=3, max_seq=MAX_SEQ, prefill_bucket=16, kv_quant="int8")
    want = JEngine(jparams, jcfg, JEngineConfig(**ecfg)).run(PROMPTS, MAX_NEW)
    eng = Engine(tparams, tcfg, EngineConfig(**ecfg), device="cpu")
    got = list(eng.run(PROMPTS, MAX_NEW).values())
    assert got == [list(map(int, t)) for t in want.values()]


def test_decode_chunk_matches_jax(model):
    """decode_chunk over a prefix past the window against JAX's: the chunk
    kernel's lse through the sink, on every layer kind."""
    from leetcuda_tpu.engine import speculative as jspec
    from leetcuda_tpu_torch.engine import speculative as tspec

    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(30)
    shape = (2, jcfg.n_kv_heads, 32, jcfg.head_dim)
    cache_np = [{"k": rng.standard_normal(shape, dtype=np.float32),
                 "v": rng.standard_normal(shape, dtype=np.float32)}
                for _ in range(jcfg.n_layers)]
    toks = rng.integers(0, 256, (2, 4)).astype(np.int32)
    lens = np.array([20, 9], np.int32)
    want, _ = jspec.decode_chunk(jparams, jnp.asarray(toks),
                                 jax.tree.map(jnp.array, cache_np),
                                 jnp.asarray(lens), jcfg)
    got, _ = tspec.decode_chunk(tparams, torch.from_numpy(toks),
                                params_from_numpy(cache_np, "cpu"),
                                torch.from_numpy(lens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)


def test_sink_rescale_is_sigmoid_of_lse(model):
    """``_sink``: out * sigmoid(lse - sink), formed in f32 and cast to the
    output's dtype; an lse of -1e30 zeroes the row."""
    out = torch.ones(1, 2, 3, 4, dtype=torch.bfloat16)
    lse = torch.tensor([[[0.0, 1.0, -1e30], [2.0, 0.5, 0.0]]])
    sinks = torch.tensor([0.5, -1.0])
    got = tl._sink(out, lse, sinks)
    want = torch.sigmoid(lse - sinks[None, :, None]).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want[..., None].expand(1, 2, 3, 4))
    assert torch.all(got[0, 0, 2] == 0)
