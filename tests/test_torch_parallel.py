"""The port's parallel layer against the JAX package's, on 8 ranks.

JAX's side runs on the 8 virtual CPU devices tests/conftest.py sets up, its
Pallas kernels in interpret mode; the port's on meshes of ``["cpu"] * 8``
(8 ranks on one device, the single-controller model the port shares with
JAX), where every kernel wrapper runs its plain version.

- The ring kernels (rows 36-37): ``ppermute_plain`` and
  ``ring_all_gather_plain`` (through the wrappers' global and shard forms)
  against ``ppermute_pallas`` and ``ring_all_gather_pallas`` on JAX's test
  inputs, bit for bit in f32, bf16 and int8; e4m3 NaN bytes through the
  plain versions; a mesh axis over distinct devices makes the wrappers
  raise.
- The mesh: ``make_mesh``, ``tp_shard_rules`` and ``shard`` against JAX's
  (every rank's piece against JAX's addressable shard), ``unshard``.
- The nine demos against ``collectives.ALL_DEMOS`` (exact), ``run_all``.
- ``ring_attention`` (causal and not, GQA 4/2) and ``ulysses_attention``
  against JAX's at (1, 2-8, 256-1024, 64) f32, by max and mean error: 1e-5
  and 1e-6 (one algorithm in f32, summed in another order: they agree to
  ~5e-7), and against the port's single-device flash attention at
  test_parallel.py's bars against its oracle (2e-2 max, 1e-4 mean).
- ``make_decode_attention_cp`` on a dp=2 x sp=4 mesh with JAX's lengths
  [100, 256, 700, 1024] at 1e-3 (tests/test_decode.py's bar), and with
  whole ranks empty against the port's single-device decode.
- ``pipeline_apply`` against JAX's and the sequential oracle (M = 1, 4, 7;
  pp x dp); ``pipeline_forward`` of a tiny 4-layer config at pp=2 and 4
  against JAX's ``pipeline_forward`` and the port's ``forward`` at 1e-4
  (tests/test_torch_model.py's bar); split / merge; the alt_window refusal.
- ``multihost`` in one process, and in 2 gloo processes.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding

from leetcuda_tpu.parallel import collectives as jcoll
from leetcuda_tpu.parallel import mesh as jmesh
from leetcuda_tpu.parallel.cp_decode import \
    make_decode_attention_cp as j_make_cp
from leetcuda_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from leetcuda_tpu.parallel.pipeline import (shard_stage_params as j_shard,
                                            stack_stage_params as j_stack)
from leetcuda_tpu.parallel.ring import (ring_attention as j_ring,
                                        ulysses_attention as j_ulysses)
from leetcuda_tpu.parallel.ring_pallas import (ppermute_pallas,
                                               ring_all_gather_pallas)
from leetcuda_tpu.models import llama as jl
from leetcuda_tpu_torch.attention.decode import decode_attention
from leetcuda_tpu_torch.attention.flash import flash_attention
from leetcuda_tpu_torch.core.runtime import launch_counts, reset_launch_counts
from leetcuda_tpu_torch.models import llama as tl
from leetcuda_tpu_torch.models.convert import params_from_numpy
from leetcuda_tpu_torch.parallel import collectives as tcoll
from leetcuda_tpu_torch.parallel import multihost
from leetcuda_tpu_torch.parallel import ring_p2p as rp
from leetcuda_tpu_torch.parallel.cp_decode import make_decode_attention_cp
from leetcuda_tpu_torch.parallel.mesh import (Mesh, MeshConfig, make_mesh,
                                              shard, tp_shard_rules, unshard)
from leetcuda_tpu_torch.parallel.pipeline import (merge_llama_stages,
                                                  pipeline_apply,
                                                  shard_stage_params,
                                                  split_llama_stages,
                                                  stack_stage_params)
from leetcuda_tpu_torch.parallel.ring import (ring_attention,
                                              ulysses_attention)

ROOT = Path(__file__).resolve().parents[1]
CPU8 = ["cpu"] * 8
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jmesh(shape, names):
    return JMesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), names)


def _bits(a):
    """Array or tensor -> its bytes, as numpy uint8."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().ravel()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).ravel()


# --- rows 36-37: the ring kernels' plain versions against the Pallas kernels

def _ring_input(kind, dt):
    """JAX's test inputs (test_parallel.py:100-114), int8 wrapped."""
    n = 8 * 128 if kind == "ppermute" else 8 * 16 * 128
    a = np.arange(n, dtype=np.int64)
    if dt == "int8":
        a = a % 256 - 128
    return a.reshape(-1, 128)


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kind", ["ppermute", "ring_all_gather"])
def test_ring_kernels_plain_match_pallas(kind, dt):
    a = _ring_input(kind, dt)
    jx = jnp.asarray(a, _JDT[dt])
    tx = torch.from_numpy(a).to(_TDT[dt])
    mesh, jm = Mesh(CPU8, ("x",)), JMesh(np.asarray(jax.devices()), ("x",))
    before = _bits(tx).copy()
    reset_launch_counts()
    if kind == "ppermute":
        want = ppermute_pallas(jx, jm)
        got = rp.ppermute_p2p(tx, mesh)
        shards = list(torch.chunk(tx, 8))
        for r, s in enumerate(rp.ppermute_p2p_shards(shards)):
            np.testing.assert_array_equal(_bits(s), _bits(shards[r - 1]))
    else:
        want = ring_all_gather_pallas(jx, jm)
        got = rp.ring_all_gather_p2p(tx, mesh)
        copies = rp.ring_all_gather_p2p_shards(list(torch.chunk(tx, 8)))
        assert len(copies) == 8
        for c in copies:  # every rank's own copy
            np.testing.assert_array_equal(_bits(c), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(tx), before)  # input unchanged
    # the CPU path runs the plain versions: no launch counts
    assert launch_counts()["ppermute_p2p"] == 0
    assert launch_counts()["ring_all_gather_p2p"] == 0


@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_plain_bytes_any_dtype(n):
    """e4m3 NaN bytes (0x7F / 0xFF) and a chunk of 5 bytes go through the
    plain versions bit for bit, at 2, 3 and 8 ranks."""
    raw = np.random.default_rng(n).integers(0, 256, (n * 5,), np.uint8)
    raw[::7] = 0x7F
    raw[3::7] = 0xFF
    x = torch.from_numpy(raw).view(torch.float8_e4m3fn)
    shards = list(torch.chunk(x, n))
    rot = rp.ppermute_p2p_shards(shards)
    gat = rp.ring_all_gather_p2p_shards(shards)
    for r in range(n):
        np.testing.assert_array_equal(_bits(rot[r]), _bits(shards[r - 1]))
        np.testing.assert_array_equal(_bits(gat[r]), raw)


def test_ring_wrappers_refuse_distinct_devices():
    mesh = Mesh(["cuda:0", "cuda:1"], ("x",))
    x = torch.zeros(4, 8)
    for fn in (rp.ppermute_p2p, rp.ring_all_gather_p2p):
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            fn(x, mesh)
    shards = [torch.zeros(2, 8), torch.zeros(2, 8, device="meta")]
    for fn in (rp.ppermute_p2p_shards, rp.ring_all_gather_p2p_shards):
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            fn(shards)


# --- the mesh --------------------------------------------------------------

def test_make_mesh_and_rules_match_jax():
    for cfg in (None, MeshConfig(dp=2, sp=4), MeshConfig(sp=8),
                MeshConfig(dp=2, tp=2, sp=2)):
        j = jmesh.make_mesh(None if cfg is None else jmesh.MeshConfig(
            dp=cfg.dp, tp=cfg.tp, sp=cfg.sp))
        t = make_mesh(cfg, devices=CPU8)
        assert t.axis_names == tuple(j.axis_names)
        assert t.shape == dict(j.shape)
    rules = jmesh.tp_shard_rules()
    assert {k: tuple(v) for k, v in rules.items()} == tp_shard_rules()
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(dp=3), devices=CPU8)


SPECS = [("dp", None), (None, "sp"), ("sp", "dp"), ("tp",), (None,),
         ("dp", "tp")]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_shard_matches_jax(spec):
    jm = jmesh.make_mesh(jmesh.MeshConfig(dp=2, tp=2, sp=2))
    tm = make_mesh(MeshConfig(dp=2, tp=2, sp=2), devices=CPU8)
    a = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    js = jax.device_put(jnp.asarray(a), NamedSharding(
        jm, jax.sharding.PartitionSpec(*spec)))
    by_dev = {s.device: np.asarray(s.data) for s in js.addressable_shards}
    pieces = shard(torch.from_numpy(a), tm, spec)
    for d, p in zip(jm.devices.flat, pieces):
        np.testing.assert_array_equal(p.numpy(), by_dev[d])
    np.testing.assert_array_equal(unshard(pieces, tm, spec).numpy(), a)


# --- the nine demos ---------------------------------------------------------

@pytest.mark.parametrize("name", list(jcoll.ALL_DEMOS))
def test_demo_matches_jax(name):
    a = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    want = np.asarray(jcoll.ALL_DEMOS[name](jnp.asarray(a)))
    got = tcoll.ALL_DEMOS[name](torch.from_numpy(a),
                                tcoll._mesh1d(CPU8)).numpy()
    np.testing.assert_array_equal(got, want)


def test_run_all_matches_jax(capsys):
    want = jcoll.run_all(verbose=False)
    got = tcoll.run_all(CPU8, verbose=True)
    assert set(got) == set(want) == set(tcoll.ALL_DEMOS)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    x = torch.arange(32, dtype=torch.float32)
    out = tcoll.demo_all_gather_with_log(x, tcoll._mesh1d(CPU8))
    np.testing.assert_array_equal(out.numpy(), x.numpy())
    assert "[rank 7] had" in capsys.readouterr().out


# --- ring and Ulysses attention --------------------------------------------

def _qkv(rng, B, H, Hkv, N, D):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, N, D), (B, Hkv, N, D), (B, Hkv, N, D))]


JAX_TOL = dict(max_tol=1e-5, mean_tol=1e-6)


def _hold(got, want, max_tol=2e-2, mean_tol=1e-4):
    diff = np.abs(got - want)
    assert diff.max() < max_tol and diff.mean() < mean_tol, (
        diff.max(), diff.mean())


RING_CASES = [(False, 2, 2, 1024), (True, 2, 2, 1024), (True, 4, 2, 1024),
              (False, 4, 2, 256)]


@pytest.mark.parametrize("causal,H,Hkv,N", RING_CASES,
                         ids=["full", "causal", "gqa causal", "gqa 256"])
def test_ring_attention_matches_jax(causal, H, Hkv, N):
    q, k, v = _qkv(np.random.default_rng(N + H), 1, H, Hkv, N, 64)
    jm = _jmesh((1, 8, 1), ("dp", "sp", "tp"))
    want = np.asarray(j_ring(*map(jnp.asarray, (q, k, v)), jm, causal=causal,
                             block_q=128, block_k=128))
    tm = make_mesh(MeshConfig(sp=8), devices=CPU8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ring_attention(tq, tk, tv, tm, causal=causal, block_q=128,
                         block_k=128).numpy()
    _hold(got, want, **JAX_TOL)
    _hold(got, flash_attention(tq, tk, tv, causal=causal).numpy())


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax(causal):
    q, k, v = _qkv(np.random.default_rng(7), 1, 8, 8, 1024, 64)
    jm = _jmesh((1, 8, 1), ("dp", "sp", "tp"))
    want = np.asarray(j_ulysses(*map(jnp.asarray, (q, k, v)), jm,
                                causal=causal, block_q=128, block_k=128))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tm = make_mesh(MeshConfig(sp=8), devices=CPU8)
    got = ulysses_attention(tq, tk, tv, tm, causal=causal).numpy()
    _hold(got, want, **JAX_TOL)
    _hold(got, flash_attention(tq, tk, tv, causal=causal).numpy())


def test_ulysses_gqa_and_refusal():
    """Hkv = 4 over sp = 4 (the layout path (t) runs), and a head count
    that does not split over the axis."""
    q, k, v = map(torch.from_numpy, _qkv(np.random.default_rng(8), 1, 8, 4,
                                         512, 64))
    tm = make_mesh(MeshConfig(sp=4, tp=2), devices=CPU8)
    got = ulysses_attention(q, k, v, tm, causal=True).numpy()
    _hold(got, flash_attention(q, k, v, causal=True).numpy())
    with pytest.raises(ValueError):
        ulysses_attention(q, k[:, :2], v[:, :2], tm)


# --- context-parallel decode ------------------------------------------------

def _cp_inputs(rng, B=4, H=8, D=64, S=1024):
    return (rng.standard_normal((B, H, D)).astype(np.float32),
            rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, H, S, D)).astype(np.float32))


def test_cp_decode_matches_jax():
    q, k, v = _cp_inputs(np.random.default_rng(0))
    lengths = np.asarray([100, 256, 700, 1024], np.int32)
    jm = _jmesh((2, 4), ("dp", "sp"))
    want = np.asarray(j_make_cp(jm, block_k=128)(
        *map(jnp.asarray, (q, k, v, lengths))))
    tm = Mesh(np.asarray(CPU8, dtype=object).reshape(2, 4), ("dp", "sp"))
    tq, tk, tv, tl_ = map(torch.from_numpy, (q, k, v, lengths))
    got = make_decode_attention_cp(tm, block_k=128)(tq, tk, tv, tl_).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(
        got, decode_attention(tq, tk, tv, tl_).numpy(), atol=1e-3,
        rtol=1e-3)


def test_cp_decode_empty_ranks():
    """Rows of length 0 and 1 leave whole ranks (and, at 0, every rank)
    empty: their weight is 0 and nothing non-finite reaches the merge."""
    q, k, v = map(torch.from_numpy, _cp_inputs(np.random.default_rng(1),
                                               B=4, H=8, S=1024))
    k[:, :, 900:] = float("nan")  # past every length
    v[:, :, 900:] = float("nan")
    lengths = torch.tensor([0, 1, 255, 900], dtype=torch.int32)
    tm = make_mesh(MeshConfig(sp=8), devices=CPU8)
    got = make_decode_attention_cp(tm)(q, k, v, lengths)
    want = decode_attention(q, k, v, lengths)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got[0].numpy(), 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-3)


# --- pipeline ---------------------------------------------------------------

def _mlp_stage_j(p, x):
    return jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _mlp_stage_t(p, x):
    return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _mlp_stages(rng, n, D=32, H=64):
    return [{"w1": rng.normal(0, 0.3, (D, H)).astype(np.float32),
             "b1": rng.normal(0, 0.1, (H,)).astype(np.float32),
             "w2": rng.normal(0, 0.3, (H, D)).astype(np.float32),
             "b2": rng.normal(0, 0.1, (D,)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("M,dp", [(1, 1), (4, 1), (7, 1), (3, 2)])
def test_pipeline_apply_matches_jax(M, dp):
    rng = np.random.default_rng(M)
    per_stage = _mlp_stages(rng, 4)
    mbs = rng.normal(size=(M, 8, 32)).astype(np.float32)
    names = ("pp", "dp")
    jm = _jmesh((4, dp), names)
    jstacked = j_shard(j_stack([{k: jnp.asarray(a) for k, a in p.items()}
                                for p in per_stage]), jm)
    want = np.asarray(j_pipeline_apply(_mlp_stage_j, jstacked,
                                       jnp.asarray(mbs), jm,
                                       batch_axis="dp" if dp > 1 else None))
    tm = Mesh(np.asarray(["cpu"] * 4 * dp, dtype=object).reshape(4, dp),
              names)
    tstages = [{k: torch.from_numpy(a) for k, a in p.items()}
               for p in per_stage]
    stacked = stack_stage_params(tstages)
    got = pipeline_apply(_mlp_stage_t, shard_stage_params(stacked, tm),
                         torch.from_numpy(mbs), tm,
                         batch_axis="dp" if dp > 1 else None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    seq = torch.from_numpy(mbs)
    for p in tstages:
        seq = _mlp_stage_t(p, seq)
    np.testing.assert_allclose(got, seq.numpy(), atol=1e-5, rtol=1e-5)
    # a tree with a leading stage dim is split by pipeline_apply itself
    again = pipeline_apply(_mlp_stage_t, stacked, torch.from_numpy(mbs), tm,
                           batch_axis="dp" if dp > 1 else None)
    np.testing.assert_array_equal(again.numpy(), got)


@pytest.fixture(scope="module")
def tiny_pair():
    jcfg = jl.tiny_config(n_layers=4)
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             (4, 32)).astype(np.int32)
    return jcfg, jparams, tl.tiny_config(n_layers=4), tparams, toks


@pytest.mark.parametrize("pp", [2, 4])
def test_pipeline_forward_matches_jax(tiny_pair, pp):
    jcfg, jparams, tcfg, tparams, toks = tiny_pair
    jm = _jmesh((pp,), ("pp",))
    want = np.asarray(jl.pipeline_forward(jparams, jnp.asarray(toks), jcfg,
                                          jm, n_microbatches=2))
    tm = Mesh(["cpu"] * pp, ("pp",))
    tt = torch.from_numpy(toks)
    got = tl.pipeline_forward(tparams, tt, tcfg, tm, n_microbatches=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), tl.forward(tparams, tt,
                                                       tcfg).numpy(),
                               atol=1e-4, rtol=1e-4)


def test_split_merge_and_alt_window(tiny_pair):
    _, _, tcfg, tparams, toks = tiny_pair
    outer, staged = split_llama_stages(tparams, 2)
    assert staged["wq"].shape[:2] == (2, 2)
    back = merge_llama_stages(outer, staged)
    assert back.keys() == tparams.keys()
    for a, b in zip(back["layers"], tparams["layers"]):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), key
    with pytest.raises(ValueError):
        split_llama_stages(tparams, 3)
    wcfg = tl.tiny_config(n_layers=4, sliding_window=8, alt_window=True)
    with pytest.raises(ValueError, match="alt_window"):
        tl.pipeline_forward(tparams, torch.from_numpy(toks), wcfg,
                            Mesh(["cpu"] * 2, ("pp",)))


# --- multihost --------------------------------------------------------------

def test_multihost_one_process():
    obj = {"rank": 0, "nested": [1, "two", (3.0,)]}
    assert multihost.broadcast_object(obj) == obj
    assert multihost.all_gather_objects(obj) == [obj]
    assert multihost.demo_all_gather_objects(verbose=False)[0]["devices"] >= 1
    assert multihost.demo_broadcast_object(
        verbose=False)["config"]["steps"] == 1000
    multihost.sync_processes("test")
    tm = make_mesh(MeshConfig(dp=2, sp=4), devices=CPU8)
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    pieces = shard(x, tm, ("dp", "sp"))
    assert torch.equal(multihost.host_local_to_global(pieces, tm,
                                                      ("dp", "sp")), x)


_CHILD = """
import json, sys
import torch.distributed as dist
from leetcuda_tpu_torch.parallel import multihost as mh
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
res = {"gathered": mh.all_gather_objects({"rank": rank}),
       "bcast": mh.broadcast_object({"from": rank}),
       "bcast1": mh.broadcast_object({"from": rank}, is_source=rank == 1),
       "demo": mh.demo_all_gather_objects(verbose=False),
       "count": mh.process_count()}
mh.sync_processes()
dist.destroy_process_group()
print(json.dumps(res))
"""


def test_multihost_two_gloo_processes():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo"}  # loopback: no host name lookup
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(r),
                               str(port)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=25)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    for rank, res in enumerate(outs):
        assert res["gathered"] == [{"rank": 0}, {"rank": 1}]
        assert res["bcast"] == {"from": 0}
        assert res["bcast1"] == {"from": 1}
        assert [d["rank"] for d in res["demo"]] == [0, 1]
        assert res["count"] == 2
