"""The port's chunk decode step and speculative decoding against the JAX
package's.

``tiny_config()`` target and a one-layer draft in f32, built in JAX and
converted (``params_from_numpy``), so both packages hold one set of weights.
On this CPU the port's chunk attention is its plain PyTorch version and the
JAX chunk kernel runs in Pallas interpret mode. Logits are held at atol 2e-4
(f32 on both sides, sums in different orders through two layers) and cache
contents at 1e-5; quantized caches compare their dequantized values at one
quantization step. Token comparisons are exact. The draws of the sampled
paths differ from JAX's (another generator), so their rule is tested on
cases with one possible outcome and by the Monte-Carlo marginal test of
``tests/test_speculative.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.engine import Engine as JEngine
from leetcuda_tpu.engine import EngineConfig as JEngineConfig
from leetcuda_tpu.engine import generate_scan
from leetcuda_tpu.engine import speculative as jspec
from leetcuda_tpu.engine.engine import _insert_kvs as j_insert_kvs
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.attention.paged import PageManager
from leetcuda_tpu_torch.engine import Engine, EngineConfig, generate
from leetcuda_tpu_torch.engine import speculative as tspec
from leetcuda_tpu_torch.engine.engine import _insert_kvs, _insert_kvs_paged
from leetcuda_tpu_torch.engine.sampling import make_sampler, make_warper
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import params_from_numpy

LOGIT_ATOL = 2e-4
DRAFT = dict(n_layers=1, dim=128, n_heads=2, n_kv_heads=1, ffn_dim=256)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, params, draft cfg, draft params) and the same four for the
    port, from one set of weights."""
    jcfg, jdcfg = jl.tiny_config(), jl.tiny_config(**DRAFT)
    jp = jl.init_params(jax.random.key(0), jcfg)
    jd = jl.init_params(jax.random.key(1), jdcfg)
    tp, td = (params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
              for p in (jp, jd))
    return (jcfg, jp, jdcfg, jd), (tl.tiny_config(), tp,
                                   tl.tiny_config(**DRAFT), td)


PROMPTS = np.random.default_rng(2).integers(0, 256, (2, 16)).astype(np.int32)
MAX_NEW = 12


@pytest.fixture(scope="module")
def greedy_stream(models):
    (jcfg, jp, _, _), _ = models
    return np.asarray(generate_scan(jp, jcfg, jnp.asarray(PROMPTS), MAX_NEW))


def _prefilled(models, quant=None, cap=128):
    """Both packages' contiguous caches after the same (2, 16) prefill."""
    (jcfg, jp, _, _), (tcfg, tp, _, _) = models
    _, jkvs = jl.forward(jp, jnp.asarray(PROMPTS), jcfg, return_kv=True)
    jcaches = j_insert_kvs(jl.init_kv_caches(jcfg, 2, cap, quant=quant), jkvs,
                           jnp.int32(0), jnp.int32(16))
    _, tkvs = tl.forward(tp, torch.from_numpy(PROMPTS), tcfg, return_kv=True)
    tcaches = _insert_kvs(
        tl.init_kv_caches(tcfg, 2, cap, quant=quant, device="cpu"), tkvs, 0)
    return jcaches, tcaches


def _dequant(cache, name):
    """A contiguous cache's ``name`` ("k" | "v") as f32 numpy, times its
    scales when quantized; ``cache`` is either package's."""
    def f32(x):
        return x.float().numpy() if torch.is_tensor(x) else np.asarray(
            x, np.float32)
    x = f32(cache[name])
    if name + "_scale" in cache:
        x = x * f32(cache[name + "_scale"])[..., None]
    return x


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_decode_chunk_matches_jax(models, quant):
    """One 5-token chunk at base 16 over a contiguous cache: logits at
    LOGIT_ATOL, every cache position below base + T equal (quantized: the
    dequantized values within one step of the format, 2^-3 relative for
    e4m3)."""
    (jcfg, jp, _, _), (tcfg, tp, _, _) = models
    jcaches, tcaches = _prefilled(models, quant)
    extra = np.random.default_rng(0).integers(0, 256, (2, 5)).astype(np.int32)
    lengths = np.full((2,), 16, np.int32)
    want, jnew = jspec.decode_chunk(jp, jnp.asarray(extra), jcaches,
                                    jnp.asarray(lengths), jcfg)
    got, tnew = tspec.decode_chunk(tp, torch.from_numpy(extra), tcaches,
                                   torch.from_numpy(lengths), tcfg)
    assert tnew is tcaches and got.shape == (2, 5, 256)
    atol = LOGIT_ATOL if quant is None else 5e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)
    step = {None: 1e-5, "int8": 2e-2, "fp8": 0.13}[quant]
    for jc, tc in zip(jnew, tnew):
        for name in ("k", "v"):
            a, b = _dequant(tc, name)[:, :, :21], _dequant(jc, name)[:, :, :21]
            np.testing.assert_allclose(a, b, atol=step * np.abs(b).max(),
                                       rtol=0)


def test_decode_chunk_matches_stepwise(models):
    """A 5-token chunk equals 5 of the port's decode steps: logits at
    LOGIT_ATOL, caches at 1e-5."""
    _, (tcfg, tp, _, _) = models
    _, a = _prefilled(models)
    _, b = _prefilled(models)
    extra = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 5)).astype(np.int32))
    lengths = torch.full((2,), 16, dtype=torch.int32)
    chunk_logits, a = tspec.decode_chunk(tp, extra, a, lengths, tcfg)
    steps = []
    for t in range(5):
        lg, b = tl.decode_step(tp, extra[:, t], b, lengths + t, tcfg)
        steps.append(lg)
    torch.testing.assert_close(chunk_logits, torch.stack(steps, dim=1),
                               atol=LOGIT_ATOL, rtol=0)
    for ca, cb in zip(a, b):
        torch.testing.assert_close(ca["k"], cb["k"], atol=1e-5, rtol=0)
        torch.testing.assert_close(ca["v"], cb["v"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_chunk_paged_matches_contiguous(models, quant):
    """The same chunk over page pools (pages of 16, the chunk crossing from
    page 0 of each row into the next) equals the contiguous run; a row with
    a zero table row writes to the null page only."""
    _, (tcfg, tp, _, _) = models
    _, cont = _prefilled(models, quant)
    _, tkvs = tl.forward(tp, torch.from_numpy(PROMPTS), tcfg, return_kv=True)
    pools = tl.init_paged_kv_caches(tcfg, 12, 16, quant=quant, device="cpu")
    pm = PageManager(12, 16, 8, 3)
    for b in range(2):
        assert pm.ensure(b, 16 + 4)
        _insert_kvs_paged(pools, [(k[b:b + 1], v[b:b + 1]) for k, v in tkvs],
                          torch.tensor(pm.used[b][:1]), 16)
    extra = np.random.default_rng(0).integers(0, 256, (3, 5)).astype(np.int32)
    lengths = torch.tensor([16, 16, 3], dtype=torch.int32)
    want, _ = tspec.decode_chunk(tp, torch.from_numpy(extra[:2]), cont,
                                 lengths[:2], tcfg)
    before = [p["k_pages"][1:].clone() for p in pools]
    got, _ = tspec.decode_chunk(tp, torch.from_numpy(extra), pools, lengths,
                                tcfg, page_table=pm.device_table("cpu"),
                                page_aligned=False)
    torch.testing.assert_close(got[:2], want, atol=LOGIT_ATOL, rtol=0)
    assert torch.isfinite(got[2]).all()   # the dead row: unused, but finite
    owned = sorted(p - 1 for b in range(2) for p in pm.used[b])
    for pool, old in zip(pools, before):  # only owned pages (and page 0) moved
        changed = (pool["k_pages"][1:].float()
                   != old.float()).flatten(1).any(1).nonzero().flatten()
        assert set(changed.tolist()) <= set(owned)


def test_chunk_append_drops_positions_past_the_capacity():
    """Contiguous: entries at or past the capacity do not move any position
    below capacity - 1, and the last position takes the entry that belongs
    there. Paged: they land on the null page."""
    k = torch.arange(2 * 4 * 1 * 2, dtype=torch.float32).reshape(2, 4, 1, 2) + 1
    cache = {"k": torch.zeros(2, 1, 8, 2), "v": torch.zeros(2, 1, 8, 2)}
    pos = torch.tensor([[6, 7, 8, 9], [2, 3, 4, 5]])
    tspec._chunk_append(cache, k, -k, pos)
    assert torch.equal(cache["k"][0, 0, 6:], k[0, :2, 0])
    assert torch.equal(cache["k"][1, 0, 2:6], k[1, :, 0])
    assert cache["k"][0, 0, :6].abs().sum() == 0
    assert torch.equal(cache["v"], -cache["k"])
    pools = {"k_pages": torch.zeros(4, 1, 4, 2),
             "v_pages": torch.zeros(4, 1, 4, 2)}
    table = torch.tensor([[2, 1], [3, 0]], dtype=torch.int32)
    tspec._chunk_append(pools, k, -k, pos, page_table=table)
    assert torch.equal(pools["k_pages"][1, 0, 2:], k[0, :2, 0])   # 6, 7
    assert torch.equal(pools["k_pages"][3, 0, 2:], k[1, :2, 0])   # 2, 3
    assert pools["k_pages"][1, 0, :2].abs().sum() == 0
    assert pools["k_pages"][2].abs().sum() == 0   # row 0's first page intact
    assert pools["k_pages"][0].abs().sum() > 0    # the rest: the null page


@pytest.mark.parametrize("k", [1, 3, 5])
def test_speculative_generate_exact(models, greedy_stream, k):
    """Greedy speculative decoding equals the JAX package's greedy stream and
    the port's own ``generate``."""
    _, (tcfg, tp, tdcfg, td) = models
    got, rate = tspec.speculative_generate(tp, tcfg, td, tdcfg, PROMPTS,
                                           MAX_NEW, k=k, device="cpu")
    assert got.dtype == torch.int32 and 0.0 <= rate <= 1.0
    np.testing.assert_array_equal(got.numpy(), greedy_stream)
    plain = generate(tp, tcfg, torch.from_numpy(PROMPTS), MAX_NEW,
                     device="cpu")
    assert torch.equal(got, plain)


def test_speculative_generate_matches_jax_speculative(models):
    """The same tokens AND the same acceptance rate as JAX's
    ``speculative_generate``: the drafts propose the same tokens round by
    round."""
    (jcfg, jp, jdcfg, jd), (tcfg, tp, tdcfg, td) = models
    want, jrate = jspec.speculative_generate(jp, jcfg, jd, jdcfg,
                                             jnp.asarray(PROMPTS), 8, k=3,
                                             max_seq=128)
    got, rate = tspec.speculative_generate(tp, tcfg, td, tdcfg, PROMPTS, 8,
                                           k=3, max_seq=128, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rate == pytest.approx(jrate)


def test_speculative_self_draft_accepts_everything(models, greedy_stream):
    _, (tcfg, tp, _, _) = models
    got, rate = tspec.speculative_generate(tp, tcfg, tp, tcfg, PROMPTS[:1],
                                           MAX_NEW, k=4, device="cpu")
    np.testing.assert_array_equal(got.numpy(), greedy_stream[:1])
    assert rate == 1.0


def test_rejection_step_deterministic_cases():
    gen = torch.Generator().manual_seed(0)
    x = torch.tensor([1, 2], dtype=torch.int32)
    p = torch.tensor([[0.2, 0.5, 0.3], [0.1, 0.1, 0.8]])
    acc, _ = tspec.rejection_step(gen, x, p, p)      # p_d == p_t: accept
    assert acc.all()
    p_t = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    acc, repl = tspec.rejection_step(gen, x, p, p_t)  # p_t(x) = 0: reject
    assert not acc.any() and repl.tolist() == [0, 1]
    assert repl.dtype == torch.int32


def test_speculative_verdict_deterministic_cases():
    """One-hot targets leave one outcome: full accept draws the bonus token
    from the last position, a first-position reject commits the residual's
    only token, and a reject at position 1 keeps the first proposal."""
    gen = torch.Generator().manual_seed(0)
    V, k = 4, 2

    def onehot(rows):  # logits whose softmax is one-hot
        return torch.log(torch.nn.functional.one_hot(
            torch.tensor(rows), V).float().clamp(min=1e-30))

    warp = make_warper(1.0)
    chunk = torch.tensor([[0, 1, 2], [0, 1, 2], [0, 1, 2]], dtype=torch.int32)
    p_d = torch.full((3, k, V), 0.25)
    logits = torch.stack([onehot([1, 2, 3]),    # accepts 1, 2; bonus 3
                          onehot([3, 2, 0]),    # rejects 1 -> commits 3
                          onehot([1, 0, 3])])   # accepts 1, rejects 2 -> 0
    n_acc, nxt = tspec.speculative_verdict(gen, chunk, p_d, logits, warp)
    assert n_acc.tolist() == [2, 0, 1] and nxt.tolist() == [3, 3, 0]
    g_acc, g_nxt = tspec.greedy_verdict(chunk, logits)
    assert g_acc.tolist() == [2, 0, 1] and g_nxt.tolist() == [3, 3, 0]


def test_rejection_step_marginal_is_target():
    """The Monte-Carlo check of tests/test_speculative.py: over 40000 draws
    on a fixed skewed (p_d, p_t) pair the emitted marginal equals p_t within
    three binomial standard deviations (+ 1e-3) per token."""
    V, N = 8, 40_000
    rng = np.random.default_rng(0)
    p_d, p_t = rng.dirichlet(np.ones(V) * 0.7), rng.dirichlet(np.ones(V) * 0.7)
    p_d_b = torch.from_numpy(np.tile(p_d, (N, 1))).float()
    p_t_b = torch.from_numpy(np.tile(p_t, (N, 1))).float()
    gen = torch.Generator().manual_seed(42)
    x = torch.multinomial(p_d_b, 1, generator=gen)[:, 0].to(torch.int32)
    accept, repl = tspec.rejection_step(gen, x, p_d_b, p_t_b)
    emitted = torch.where(accept, x, repl).numpy()
    emp = np.bincount(emitted, minlength=V) / N
    tol = 3 * np.sqrt(p_t * (1 - p_t) / N) + 1e-3
    assert np.all(np.abs(emp - p_t) < tol), (emp, p_t, tol)
    acc2, _ = tspec.rejection_step(gen, x, p_d_b, p_d_b)
    assert float(acc2.float().mean()) > 0.999


def test_speculative_sampling_runs_and_degenerates(models):
    """Valid tokens and a sane rate; a self-draft at a near-zero temperature
    reproduces the greedy-exact stream; the same seed gives the same
    tokens."""
    _, (tcfg, tp, tdcfg, td) = models
    kw = dict(k=3, temperature=1.0, top_k=16, device="cpu")
    toks, rate = tspec.speculative_sample_generate(
        tp, tcfg, td, tdcfg, PROMPTS[:, :12], 8,
        torch.Generator().manual_seed(0), **kw)
    again, _ = tspec.speculative_sample_generate(
        tp, tcfg, td, tdcfg, PROMPTS[:, :12], 8,
        torch.Generator().manual_seed(0), **kw)
    assert toks.shape == (2, 8) and 0.0 <= rate <= 1.0
    assert bool(((toks >= 0) & (toks < tcfg.vocab_size)).all())
    assert torch.equal(toks, again)
    want, _ = tspec.speculative_generate(tp, tcfg, tp, tcfg, PROMPTS[:, :12],
                                         6, k=3, device="cpu")
    got, rate2 = tspec.speculative_sample_generate(
        tp, tcfg, tp, tcfg, PROMPTS[:, :12], 6,
        torch.Generator().manual_seed(1), k=3, temperature=1e-4, device="cpu")
    assert torch.equal(got, want) and rate2 > 0.99
    zero_t, _ = tspec.speculative_sample_generate(
        tp, tcfg, tp, tcfg, PROMPTS[:, :12], 6, None, k=3, temperature=0.0,
        device="cpu")
    assert torch.equal(zero_t, want)


# --- the speculative Engine ---------------------------------------------------

ENGINE_PROMPTS = [list(np.random.default_rng(5).integers(0, 256, n))
                  for n in (6, 14, 9)]


def _ecfg(cls, **kw):
    return cls(slots=2, max_seq=256, prefill_bucket=16, **kw)


@pytest.mark.parametrize("case", ["contiguous", "paged", "int8 KV"])
def test_speculative_engine_matches_jax_engine(models, case):
    """Three requests on two slots with spec_k = 3: the port's tokens equal
    the JAX speculative engine's (its chunk kernel in interpret mode) and
    the port's plain greedy engine's; so does the acceptance rate."""
    (jcfg, jp, jdcfg, jd), (tcfg, tp, tdcfg, td) = models
    kw = {"contiguous": {}, "paged": dict(paged=True, page_size=16),
          "int8 KV": dict(kv_quant="int8")}[case]
    jeng = JEngine(jp, jcfg, _ecfg(JEngineConfig, spec_k=3, **kw),
                   draft=(jd, jdcfg))
    want = jeng.run(ENGINE_PROMPTS, 10)
    eng = Engine(tp, tcfg, _ecfg(EngineConfig, spec_k=3, **kw),
                 draft=(td, tdcfg), device="cpu")
    got = eng.run(ENGINE_PROMPTS, 10)
    assert list(got.values()) == [list(map(int, t)) for t in want.values()]
    assert eng.acceptance_rate == pytest.approx(jeng.acceptance_rate)
    plain = Engine(tp, tcfg, _ecfg(EngineConfig, **kw), device="cpu").run(
        ENGINE_PROMPTS, 10)
    assert list(got.values()) == list(plain.values())
    rep, jrep = eng.kv_memory_report(), jeng.kv_memory_report()
    assert rep == jrep and rep["draft_bytes"] > 0
    assert eng.stats()["kv_memory"] == rep


def test_speculative_engine_self_draft_and_sampler(models):
    """Draft = target accepts everything; a ``make_sampler`` sampler goes
    through the rejection rule and serves tokens inside the vocabulary,
    dead slots riding along; anything else than greedy or a sampler with
    a ``.warp`` is refused, and so is ``spec_k`` without a draft."""
    _, (tcfg, tp, tdcfg, td) = models
    eng = Engine(tp, tcfg, _ecfg(EngineConfig, spec_k=4), draft=(tp, tcfg),
                 device="cpu")
    got = eng.run(ENGINE_PROMPTS[:1], 9)
    plain = Engine(tp, tcfg, _ecfg(EngineConfig), device="cpu").run(
        ENGINE_PROMPTS[:1], 9)
    assert list(got.values()) == list(plain.values())
    assert eng.acceptance_rate == 1.0
    eng = Engine(tp, tcfg, _ecfg(EngineConfig, spec_k=2, paged=True,
                                 page_size=16),
                 sample_fn=make_sampler(0.8, top_k=20), draft=(td, tdcfg),
                 seed=3, device="cpu")
    out = eng.run(ENGINE_PROMPTS, 7)
    assert all(len(t) == 7 and all(0 <= x < 256 for x in t)
               for t in out.values())
    assert 0.0 <= eng.acceptance_rate <= 1.0
    with pytest.raises(ValueError, match="warp"):
        Engine(tp, tcfg, _ecfg(EngineConfig, spec_k=2),
               sample_fn=lambda logits, gen: logits.argmax(-1),
               draft=(td, tdcfg), device="cpu")
    with pytest.raises(ValueError, match="draft"):
        Engine(tp, tcfg, _ecfg(EngineConfig, spec_k=2), device="cpu")


@pytest.mark.parametrize("paged", [False, True])
def test_speculative_engine_runs_into_max_seq(models, paged):
    """Requests that run to the capacity (max_seq 32) under spec_k = 3: the
    verify chunk reaches past the last position, whose entries are dropped
    (and no page past the table is asked for); the streams equal the plain
    greedy engine's, which stop at the same length."""
    _, (tcfg, tp, tdcfg, td) = models
    kw = dict(paged=True, page_size=16) if paged else {}
    ecfg = dict(slots=2, max_seq=32, prefill_bucket=16, **kw)
    plain = Engine(tp, tcfg, EngineConfig(**ecfg), device="cpu").run(
        ENGINE_PROMPTS, 64)
    eng = Engine(tp, tcfg, EngineConfig(spec_k=3, **ecfg), draft=(td, tdcfg),
                 device="cpu")
    got = eng.run(ENGINE_PROMPTS, 64)
    assert list(got.values()) == list(plain.values())
    assert [len(p) + len(t) for p, t in zip(ENGINE_PROMPTS, got.values())] \
        == [32, 32, 32]
    # the draft is the target here: every proposal inside the capacity is
    # accepted, whatever the dropped tail held
    eng = Engine(tp, tcfg, EngineConfig(spec_k=3, **ecfg), draft=(tp, tcfg),
                 device="cpu")
    assert list(eng.run(ENGINE_PROMPTS, 64).values()) == list(plain.values())


def test_speculative_engine_recover_midflight_exact(models):
    """recover() drops the draft's cache with the target's; the streams stay
    equal to an undisturbed run."""
    _, (tcfg, tp, tdcfg, td) = models
    want = Engine(tp, tcfg, _ecfg(EngineConfig), device="cpu").run(
        ENGINE_PROMPTS, 8)
    eng = Engine(tp, tcfg, _ecfg(EngineConfig, spec_k=3), draft=(td, tdcfg),
                 device="cpu")
    uids = [eng.submit(p, max_new=8) for p in ENGINE_PROMPTS]
    eng.step()
    old = eng.caches_d
    eng.recover()
    assert eng.caches_d is not old and eng.recoveries == 1
    while eng.waiting or eng.active:
        eng.step()
    assert [eng.finished[u].generated for u in uids] == list(want.values())
