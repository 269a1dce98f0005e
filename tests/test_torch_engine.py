"""The port's Engine, generate and samplers against the JAX package's.

Greedy decoding on ``tiny_config()`` (f32) with one set of weights, dense
or JAX's quantized packs converted bit for bit: the port's tokens must
EQUAL the JAX engine's, over plain and quantized KV caches, contiguous or
paged (the JAX paged engine runs its Pallas paged kernel in interpret mode),
with a preemption among the paged runs, and through the chunk paths: the
prefix cache and bounded chunked prefill (their token-for-token runs against
the JAX engine are in test_torch_engine_chunk.py, the speculative engine's
in test_torch_speculative.py). The isolation tests check that the port
imports nothing of JAX and refuses to run on a missing GPU.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.engine import Engine as JEngine
from leetcuda_tpu.engine import EngineConfig as JEngineConfig
from leetcuda_tpu.engine import generate_scan
from leetcuda_tpu.engine.sampling import make_warper as j_make_warper
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.engine import Engine, EngineConfig, generate
from leetcuda_tpu_torch.engine.sampling import greedy, make_sampler, make_warper
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import params_from_numpy

REPO = Path(__file__).resolve().parent.parent


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


def _ecfg(cls, slots, kv_quant=None):
    return cls(slots=slots, max_seq=256, prefill_bucket=16,
               kv_quant=kv_quant)


def _quantized(both, fmt, fuse=True):
    jcfg, jparams, tcfg, _ = both
    jq = jl.quantize_params(jl.fuse_params(jparams) if fuse else jparams, fmt)
    return jcfg, jq, tcfg, params_from_numpy(jax.tree.map(np.asarray, jq),
                                             "cpu")


def test_batched_admission_matches_jax_engine(both):
    """The three same-tick arrivals of test_batched_admission_matches_solo:
    one ragged prefill batch, then decode — tokens equal JAX's."""
    jcfg, jparams, tcfg, tparams = both
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(0, 256, n)) for n in (5, 17, 9)]
    want = JEngine(jparams, jcfg, _ecfg(JEngineConfig, 3)).run(prompts, 5)
    eng = Engine(tparams, tcfg, _ecfg(EngineConfig, 3), device="cpu")
    got = eng.run(prompts, 5)
    assert list(got.values()) == [list(map(int, t)) for t in want.values()]
    assert eng.recoveries == 0 and eng.stats()["finished"] == 3


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
def test_batched_admission_quantized_matches_jax_engine(both, fmt):
    """The same three arrivals with fused quantized weights over a KV cache
    of the same format: the ragged prefill's K/V are quantized per position
    over the whole padded bucket, as JAX does."""
    jcfg, jparams, tcfg, tparams = _quantized(both, fmt)
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(0, 256, n)) for n in (5, 17, 9)]
    want = JEngine(jparams, jcfg, _ecfg(JEngineConfig, 3, fmt)).run(
        prompts, 5)
    eng = Engine(tparams, tcfg, _ecfg(EngineConfig, 3, fmt), device="cpu")
    got = eng.run(prompts, 5)
    assert list(got.values()) == [list(map(int, t)) for t in want.values()]
    assert eng.recoveries == 0
    assert "k_scale" in eng.caches[0]
    cache_bytes = sum(t.nbytes for c in eng.caches for t in c.values())
    scale_bytes = sum(c[k].nbytes for c in eng.caches
                      for k in ("k_scale", "v_scale"))
    assert eng.kv_memory_report() == {"target_bytes": cache_bytes}
    assert scale_bytes == 2 * tcfg.n_layers * 3 * tcfg.n_kv_heads * 256 * 4


def _staggered_slot_reuse(both, kv_quant):
    """Three requests on two slots, then a mid-flight arrival (which admits
    alone, through forward); returns the JAX and the port's streams."""
    jcfg, jparams, tcfg, tparams = both
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, 256, n)) for n in (4, 4, 7, 3)]

    def drive(eng):
        uids = [eng.submit(p, max_new=3 + i)
                for i, p in enumerate(prompts[:3])]
        for _ in range(2):
            eng.step()
        uids.append(eng.submit(prompts[3], max_new=4))
        while eng.waiting or eng.active:
            eng.step()
        return [list(map(int, eng.finished[u].generated)) for u in uids]

    want = drive(JEngine(jparams, jcfg, _ecfg(JEngineConfig, 2, kv_quant)))
    got = drive(Engine(tparams, tcfg, _ecfg(EngineConfig, 2, kv_quant),
                       device="cpu"))
    return want, got


def test_staggered_slot_reuse_matches_jax_engine(both):
    """More requests than slots plus a mid-flight arrival: slot recycling
    keeps every stream exact."""
    want, got = _staggered_slot_reuse(both, None)
    assert got == want


def test_staggered_slot_reuse_int8_kv_matches_jax_engine(both):
    """The same over an int8 KV cache: a recycled slot's stale values and
    scales past the new length are never read, and dead slots' appends
    write a scale inside the capacity."""
    want, got = _staggered_slot_reuse(both, "int8")
    assert got == want


def test_recover_midflight_exact(both):
    """recover() after a few ticks requeues in-flight requests for
    recompute; the streams stay equal to an undisturbed run."""
    _, _, tcfg, tparams = both
    rng = np.random.default_rng(9)
    prompts = [list(rng.integers(0, 256, n)) for n in (6, 10)]
    want = Engine(tparams, tcfg, _ecfg(EngineConfig, 2),
                  device="cpu").run(prompts, 6)
    eng = Engine(tparams, tcfg, _ecfg(EngineConfig, 2), device="cpu")
    uids = [eng.submit(p, max_new=6) for p in prompts]
    for _ in range(3):
        eng.step()
    eng.recover()
    while eng.waiting or eng.active:
        eng.step()
    assert [eng.finished[u].generated for u in uids] == list(want.values())
    assert eng.recoveries == 1


def test_generate_matches_generate_scan(both):
    jcfg, jparams, tcfg, tparams = both
    prompts = np.random.default_rng(2).integers(0, 256, (2, 16)).astype(
        np.int32)
    want = np.asarray(generate_scan(jparams, jcfg, jnp.asarray(prompts), 5))
    got = generate(tparams, tcfg, torch.from_numpy(prompts), 5, device="cpu")
    assert got.shape == (2, 5) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_int4_int8_kv_matches_generate_scan(both):
    """int4 weights over an int8 KV cache (generate_scan's kv_quant)."""
    jcfg, jparams, tcfg, tparams = _quantized(both, "int4", fuse=False)
    prompts = np.random.default_rng(2).integers(0, 256, (2, 16)).astype(
        np.int32)
    want = np.asarray(generate_scan(jparams, jcfg, jnp.asarray(prompts), 5,
                                    kv_quant="int8"))
    got = generate(tparams, tcfg, torch.from_numpy(prompts), 5,
                   kv_quant="int8", device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [dict(temperature=0.7),
                                dict(temperature=1.3, top_k=5),
                                dict(temperature=0.9, top_p=0.8),
                                dict(temperature=1.0, top_k=20, top_p=0.5)])
def test_make_warper_matches_jax(kw):
    logits = np.random.default_rng(3).standard_normal(
        (3, 64), dtype=np.float32) * 3
    want = np.asarray(j_make_warper(**kw)(jnp.asarray(logits)))
    got = make_warper(**kw)(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_sampler_draws_inside_warped_support():
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 64), dtype=np.float32))
    samp = make_sampler(temperature=1.0, top_k=3)
    a = samp(logits, torch.Generator().manual_seed(0))
    b = samp(logits, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.dtype == torch.int32
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert all(int(a[i]) in top3[i].tolist() for i in range(4))
    assert make_sampler(temperature=0) is greedy


def _paged(cfg, **kw):
    return dataclasses.replace(cfg, paged=True, page_size=16, **kw)


@pytest.mark.parametrize("case", ["f32 pools", "int8 pools", "fp8 pools",
                                  "fused dense params"])
def test_paged_engine_matches_jax_paged_engine(both, case):
    """Three arrivals on two slots through the paged engines (pages of 16,
    the full default pool): one ragged admission, a slot reused by a lone
    arrival, pages released and handed out again. Fused dense params serve
    at max_seq 2048, where the JAX model takes its fused Pallas block (the
    port takes its fused wrapper at any capacity)."""
    jcfg, jparams, tcfg, tparams = both
    kv_quant, max_seq = None, 256
    if case in ("int8 pools", "fp8 pools"):
        kv_quant = case.split()[0]
    elif case == "fused dense params":
        jparams, tparams, max_seq = (jl.fuse_params(jparams),
                                     tl.fuse_params(tparams), 2048)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, 256, n)) for n in (5, 12, 9)]
    ecfg = dict(slots=2, max_seq=max_seq, prefill_bucket=16,
                kv_quant=kv_quant, paged=True, page_size=16)
    want = JEngine(jparams, jcfg, JEngineConfig(**ecfg)).run(prompts, 6)
    eng = Engine(tparams, tcfg, EngineConfig(**ecfg), device="cpu")
    got = eng.run(prompts, 6)
    assert list(got.values()) == [list(map(int, t)) for t in want.values()]
    stats = eng.stats()
    assert stats["preemptions"] == 0 and stats["finished"] == 3
    assert stats["free_pages"] == 2 * max_seq // 16  # every page came back
    assert ("k_scales" in eng.caches[0]) == (kv_quant is not None)
    assert eng.kv_memory_report() == {"target_bytes": sum(
        t.nbytes for c in eng.caches for t in c.values())}


def test_paged_engine_preemption_matches_jax_and_unpaged(both):
    """A pool of 5 usable pages of 16 for two slots of 12 prompt + 24 new
    tokens (3 pages each): the sequences collide mid-flight, the youngest
    is preempted and recomputed, and every stream still equals the JAX
    paged engine's under the same pool and the port's unpaged run."""
    jcfg, jparams, tcfg, tparams = both
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, 256, 12)) for _ in range(3)]
    unpaged = Engine(tparams, tcfg, _ecfg(EngineConfig, 2),
                     device="cpu").run(prompts, 24)
    want = JEngine(jparams, jcfg, _paged(_ecfg(JEngineConfig, 2),
                                         num_pages=6)).run(prompts, 24)
    eng = Engine(tparams, tcfg, _paged(_ecfg(EngineConfig, 2), num_pages=6),
                 device="cpu")
    got = eng.run(prompts, 24)
    assert eng.preemptions >= 1 and eng.stats()["preemptions"] >= 1
    assert list(got.values()) == list(unpaged.values())
    assert list(got.values()) == [list(map(int, t)) for t in want.values()]
    assert eng.stats()["free_pages"] == 5 and eng.recoveries == 0


def test_paged_engine_recover_midflight_exact(both):
    """recover() on a paged engine with a short pool drops the pools and
    the page bookkeeping (a fresh PageManager) and requeues the in-flight
    requests; with the preemptions that follow, the streams still equal the
    unpaged run's."""
    _, _, tcfg, tparams = both
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, 256, 12)) for _ in range(3)]
    want = Engine(tparams, tcfg, _ecfg(EngineConfig, 2),
                  device="cpu").run(prompts, 24)
    eng = Engine(tparams, tcfg, _paged(_ecfg(EngineConfig, 2), num_pages=6),
                 device="cpu")
    uids = [eng.submit(p, max_new=24) for p in prompts]
    for _ in range(4):
        eng.step()
    old_pm = eng.pm
    eng.recover()
    assert eng.pm is not old_pm and len(eng.pm.free) == 5
    while eng.waiting or eng.active:
        eng.step()
    assert [eng.finished[u].generated for u in uids] == list(want.values())
    assert eng.recoveries == 1 and eng.preemptions >= 1


def test_paged_engine_unservable_prompt_raises(both):
    """A prompt that can never fit the pool raises instead of spinning."""
    _, _, tcfg, tparams = both
    eng = Engine(tparams, tcfg, EngineConfig(
        slots=2, max_seq=256, prefill_bucket=64, paged=True, page_size=16,
        num_pages=3), device="cpu")  # 2 usable pages; the prefill needs 4
    with pytest.raises(RuntimeError, match="pages"):
        eng.run([list(range(1, 40))], max_new=4)


def test_engine_unported_options_raise(both):
    """Meshes still raise; the chunk-path options are served, and refuse
    only what their JAX counterparts assert against."""
    _, _, tcfg, tparams = both
    for opt in (dict(paged=True, page_size=16, prefix_cache=True),
                dict(paged=True, page_size=16, prefill_chunk=32)):
        Engine(tparams, tcfg, dataclasses.replace(
            _ecfg(EngineConfig, 2), **opt), device="cpu")
    Engine(tparams, tcfg, dataclasses.replace(_ecfg(EngineConfig, 2),
                                              spec_k=2),
           draft=(tparams, tcfg), device="cpu")
    for opt in (dict(spec_k=2),                       # no draft
                dict(prefix_cache=True),              # needs paged
                dict(prefill_chunk=32),               # needs paged
                dict(paged=True, page_size=16, prefill_chunk=24)):  # bucket
        with pytest.raises(ValueError):
            Engine(tparams, tcfg, dataclasses.replace(
                _ecfg(EngineConfig, 2), **opt), device="cpu")
    with pytest.raises(ValueError):  # a bucket must hold whole pages
        Engine(tparams, tcfg, dataclasses.replace(
            _ecfg(EngineConfig, 2), paged=True, page_size=32), device="cpu")
    with pytest.raises(ValueError):  # int8 and fp8 are the KV formats
        Engine(tparams, tcfg, _ecfg(EngineConfig, 2, "int4"), device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(tparams, tcfg, _ecfg(EngineConfig, 2), mesh=object(),
               device="cpu")


# --- the chunk paths: prefix cache and chunked prefill ------------------------


def _chunk_ecfg(cls, slots=2, **kw):
    return cls(slots=slots, max_seq=256, prefill_bucket=16, paged=True,
               page_size=16, **kw)


def _tokens(out):
    return [list(map(int, t)) for t in out.values()]


def test_suffix_admission_is_bounded(both, monkeypatch):
    """With the per-call cap at one bucket a 100-token suffix takes seven
    chunk calls; the tokens do not depend on the cap."""
    import leetcuda_tpu_torch.engine.engine as eng_mod
    _, _, tcfg, tparams = both
    rng = np.random.default_rng(4)
    common = list(rng.integers(0, 256, 32))
    p1 = common + list(rng.integers(0, 256, 100))

    def serve():
        eng = Engine(tparams, tcfg, _chunk_ecfg(EngineConfig, 1,
                                                prefix_cache=True),
                     device="cpu")
        eng.run([common + [1, 2, 3]], 2)
        calls = []
        admit = eng._chunk_admit
        eng._chunk_admit = lambda *a: calls.append(a[1]) or admit(*a)
        out = _tokens(eng.run([p1], 5))
        assert eng.stats()["prefix_pages_hit"] == 2
        return out, calls

    want, calls = serve()
    assert calls == [32]
    monkeypatch.setattr(eng_mod, "_SUFFIX_T_CAP", 16)
    got, calls = serve()
    assert got == want and calls == list(range(32, 132, 16))


def test_chunked_prefill_stall_and_preemption(both):
    """A pool that can never hold the prompt raises instead of spinning; a
    pool that runs dry mid-decode preempts the youngest sequence, a filling
    one included, and the streams still equal the unpaged run's."""
    _, _, tcfg, tparams = both
    eng = Engine(tparams, tcfg, _chunk_ecfg(EngineConfig, 1, prefill_chunk=16,
                                            num_pages=3), device="cpu")
    with pytest.raises(RuntimeError, match="stall|pages"):
        eng.run([list(range(1, 60))], max_new=4)
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, 256, 12)) for _ in range(3)]
    want = _tokens(Engine(tparams, tcfg, _ecfg(EngineConfig, 2),
                          device="cpu").run(prompts, 24))
    eng = Engine(tparams, tcfg, _chunk_ecfg(EngineConfig, prefill_chunk=16,
                                            num_pages=6), device="cpu")
    assert _tokens(eng.run(prompts, 24)) == want
    assert eng.preemptions >= 1 and eng.stats()["pages_free"] == 5


def test_engine_stats_keys_cover_jax_engine(both):
    """``stats()`` has every key of the JAX engine's, for each engine mode,
    and beside them only ``recoveries``, ``free_pages`` and
    ``preemptions``."""
    jcfg, jparams, tcfg, tparams = both
    modes = (dict(), dict(paged=True, page_size=16),
             dict(paged=True, page_size=16, prefix_cache=True,
                  prefill_chunk=16))
    for mode in modes:
        jstats = JEngine(jparams, jcfg, dataclasses.replace(
            _ecfg(JEngineConfig, 2), **mode)).stats()
        eng = Engine(tparams, tcfg, dataclasses.replace(
            _ecfg(EngineConfig, 2), **mode), device="cpu")
        eng.submit([1, 2, 3], 4)
        if mode.get("prefill_chunk"):
            eng._admit()  # a filling slot shows as "n_filled/prompt length"
            assert list(eng.stats()["filling"].values()) == ["0/3"]
        stats = eng.stats()
        extra = {"recoveries"} | ({"free_pages", "preemptions"}
                                  if mode else set())
        assert set(stats) == set(jstats) | extra
        assert set(stats["kv_memory"]) == set(jstats["kv_memory"])
        if mode:
            assert stats["free_pages"] == stats["pages_free"]
            assert 0.0 <= stats["page_utilization"] <= 1.0


def test_engine_default_device_raises_without_cuda(both):
    """Entry points default to the GPU and refuse to fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for CUDA-less hosts")
    _, _, tcfg, tparams = both
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(tparams, tcfg, _ecfg(EngineConfig, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.init_kv_caches(tcfg, 1, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(tparams, tcfg, torch.zeros((1, 4), dtype=torch.int32), 2)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "leetcuda_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "leetcuda_tpu"), (path, mod)
