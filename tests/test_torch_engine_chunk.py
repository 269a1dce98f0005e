"""The port's prefix cache and bounded chunked prefill against the JAX
engine's, token for token.

Greedy decoding on ``tiny_config()`` (f32) with one set of weights over
paged f32 pools (pages of 16); the JAX engine runs its Pallas chunk kernel in
interpret mode, the port its plain chunk attention. Tokens, prefix-cache hit
and miss counts and the ticks on which a live request decodes beside a
filling one must EQUAL the JAX engine's. Each JAX engine re-jits its steps,
which is most of this file's time; the faster cases of the same paths (the
suffix cap, the stall error, preemption of a filling slot, ``stats()``) are
in test_torch_engine.py.
"""

import jax
import numpy as np
import pytest
import torch

from leetcuda_tpu.engine import Engine as JEngine
from leetcuda_tpu.engine import EngineConfig as JEngineConfig
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.engine import Engine, EngineConfig
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def both():
    jcfg = jl.tiny_config()
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tl.tiny_config(), tparams


def _chunk_ecfg(cls, slots=2, **kw):
    return cls(slots=slots, max_seq=256, prefill_bucket=16, paged=True,
               page_size=16, **kw)


def _tokens(out):
    return [list(map(int, t)) for t in out.values()]


def test_prefix_cache_matches_jax_engine(both):
    """One slot serves, in turn: a prompt, the same prompt again (its three
    full pages adopted, the 2-token tail prefilled through the chunk path),
    a prompt sharing two pages and a long suffix, and an unrelated one.
    Tokens equal the JAX engine's and the port's engine without the cache;
    hits, misses and cached pages equal JAX's."""
    jcfg, jparams, tcfg, tparams = both
    rng = np.random.default_rng(2)
    common = list(rng.integers(0, 256, 50))
    prompts = [common, common, common[:32] + list(rng.integers(0, 256, 40)),
               list(rng.integers(0, 256, 20))]
    jeng = JEngine(jparams, jcfg, _chunk_ecfg(JEngineConfig, 1,
                                              prefix_cache=True))
    want = _tokens(jeng.run(prompts, 5))
    eng = Engine(tparams, tcfg, _chunk_ecfg(EngineConfig, 1,
                                            prefix_cache=True), device="cpu")
    got = _tokens(eng.run(prompts, 5))
    assert got == want and got[0] == got[1]
    plain = Engine(tparams, tcfg, _chunk_ecfg(EngineConfig, 1), device="cpu")
    assert got == _tokens(plain.run(prompts, 5))
    stats, jstats = eng.stats(), jeng.stats()
    for key in ("prefix_pages_hit", "prefix_pages_prefilled",
                "prefix_pages_cached", "pages_used", "pages_free"):
        assert stats[key] == jstats[key], key
    assert stats["prefix_pages_hit"] == 3 + 2


def test_prefix_cache_eviction_under_pressure(both):
    """A pool of 7 usable pages: cached pages of finished requests are
    evicted (least recently used first) to admit new prompts; tokens stay
    equal to the JAX engine's under the same pool and to the uncached
    run's, and a later repeat of the first prompt finds its pages gone."""
    jcfg, jparams, tcfg, tparams = both
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, 256, n)) for n in (40, 45, 50, 36)]
    prompts.append(prompts[0])
    ecfg = dict(prefix_cache=True, num_pages=8)
    jeng = JEngine(jparams, jcfg, _chunk_ecfg(JEngineConfig, 1, **ecfg))
    want = _tokens(jeng.run(prompts, 4))
    eng = Engine(tparams, tcfg, _chunk_ecfg(EngineConfig, 1, **ecfg),
                 device="cpu")
    got = _tokens(eng.run(prompts, 4))
    assert got == want and got[0] == got[4]
    stats, jstats = eng.stats(), jeng.stats()
    assert stats["prefix_pages_hit"] == jstats["prefix_pages_hit"] == 0
    assert stats["prefix_pages_cached"] == jstats["prefix_pages_cached"] < 9
    assert stats["pages_free"] + stats["prefix_pages_cached"] == 7


def test_chunked_prefill_matches_jax_engine(both):
    """prefill_chunk = 16: a 70-token prompt takes five fill ticks while a
    short request, live since the first tick, emits a token on every one of
    them; tokens equal the JAX engine's and the whole-prompt admission's."""
    jcfg, jparams, tcfg, tparams = both
    rng = np.random.default_rng(1)
    short, long_ = (list(rng.integers(0, 256, n)) for n in (5, 70))

    def drive(eng):
        u_short = eng.submit(short, max_new=12)
        eng.step()
        u_long = eng.submit(long_, max_new=4)
        progress = []
        while eng.waiting or eng.active or eng.filling:
            filling = bool(eng.filling) or bool(eng.waiting)
            out = eng.step()
            if filling and eng.filling:
                progress.append(u_short in out)
        return ([list(map(int, eng.finished[u].generated))
                 for u in (u_short, u_long)], progress)

    want, jprogress = drive(JEngine(jparams, jcfg, _chunk_ecfg(
        JEngineConfig, prefill_chunk=16)))
    eng = Engine(tparams, tcfg, _chunk_ecfg(EngineConfig, prefill_chunk=16),
                 device="cpu")
    got, progress = drive(eng)
    assert got == want and progress == jprogress
    assert len(progress) == 4 and all(progress)
    whole = Engine(tparams, tcfg, _chunk_ecfg(EngineConfig), device="cpu")
    assert got == _tokens(whole.run([short, long_], 12))[:1] + _tokens(
        Engine(tparams, tcfg, _chunk_ecfg(EngineConfig),
               device="cpu").run([long_], 4))
    assert eng.stats()["filling"] == {} and eng.stats()["pages_used"] == 0


def test_two_filling_slots_unaligned_budget(both):
    """Two concurrent fills under prefill_chunk = 32 (bucket 16): the first
    prompt's last chunk is 8 tokens and leaves 24 of the budget, of which
    the second takes 16, so every later chunk still starts on a bucket
    boundary, where the JAX engine cuts too. Tokens equal JAX's; with the
    prefix cache on top, a repeat adopts pages and skips fill ticks."""
    jcfg, jparams, tcfg, tparams = both
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, 256, n)) for n in (40, 64)]
    want = _tokens(JEngine(jparams, jcfg, _chunk_ecfg(
        JEngineConfig, prefill_chunk=32)).run(prompts, 6))
    eng = Engine(tparams, tcfg, _chunk_ecfg(EngineConfig, prefill_chunk=32),
                 device="cpu")
    bases = []
    admit = eng._chunk_admit
    eng._chunk_admit = lambda *a: bases.append((a[2], a[1])) or admit(*a)
    assert _tokens(eng.run(prompts, 6)) == want
    assert all(base % 16 == 0 for _, base in bases)
    assert len({slot for slot, _ in bases}) == 2
    cached = Engine(tparams, tcfg, _chunk_ecfg(
        EngineConfig, 1, prefill_chunk=16, prefix_cache=True), device="cpu")
    out = _tokens(cached.run([prompts[1], prompts[1][:48] + [7] * 9], 6))
    assert out[0] == want[1]
    assert cached.stats()["prefix_pages_hit"] == 3
    assert out[1] == _tokens(Engine(
        tparams, tcfg, _chunk_ecfg(EngineConfig, 1), device="cpu").run(
            [prompts[1][:48] + [7] * 9], 6))[0]
