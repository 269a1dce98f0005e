"""The port's GEMM library (registry, matmul ladder, matmul_auto, gemv, the
fused rms-norm gemv, the int8 matmul) against the JAX package's.

On this CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels run on the GPU, held against these same plain versions by
``chip_smoke.py`` path (j)); the JAX kernels run in Pallas interpret mode.
Inputs come from a numpy seed; ``core/testing.make_args`` must give both
packages the same numbers. Tolerances are the JAX tests' and the registry's
(``tests/test_gemm.py``, ``tests/test_decode.py``, ``docs/OPS.md``): f32
products summed in another order, bf16 outputs rounded once on each side;
the int8 matmul is exact.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import leetcuda_tpu.gemm.gemv  # noqa: F401  (registers the JAX ops)
import leetcuda_tpu.gemm.quant as jq
from leetcuda_tpu.core.registry import OPS as JOPS
from leetcuda_tpu.core.testing import make_args as j_make_args
from leetcuda_tpu.gemm.gemv import make_gemv as j_make_gemv
from leetcuda_tpu.gemm.gemv import make_rms_norm_gemv as j_make_rms_norm_gemv
from leetcuda_tpu.gemm.matmul import make_matmul as j_make_matmul
from leetcuda_tpu.gemm.matmul import matmul_auto as j_matmul_auto
from leetcuda_tpu_torch.core.registry import OPS, load_all
from leetcuda_tpu_torch.core.testing import make_args
from leetcuda_tpu_torch.gemm import gemv as tgv
from leetcuda_tpu_torch.gemm import matmul as tmm
from leetcuda_tpu_torch.gemm import quant as tq

load_all()
FAMILIES = ("gemm", "gemv", "gemm-quant")
PORT_NAMES = sorted(n for n, s in OPS.items() if s.family in FAMILIES)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bytes(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _np(a):
    """A tensor or JAX array as a float32 numpy array (ints kept exact)."""
    if isinstance(a, torch.Tensor):
        return (a.numpy() if not a.dtype.is_floating_point
                else a.float().numpy())
    a = np.asarray(a)
    return a if np.issubdtype(a.dtype, np.integer) else a.astype(np.float32)


def _t(a, dtype=None):
    """A numpy float64 array as a tensor rounded once to ``dtype``."""
    return torch.from_numpy(np.asarray(a)).to(dtype or torch.float32)


def test_registry_names_match_jax():
    jax_names = sorted(n for n, s in JOPS.items() if s.family in FAMILIES)
    assert PORT_NAMES == jax_names
    assert len(PORT_NAMES) == 25


@pytest.mark.parametrize("name", PORT_NAMES)
def test_registry_op_matches_jax(name):
    spec, jspec = OPS[name], JOPS[name]
    assert (spec.family, spec.tags, spec.atol, spec.rtol) == (
        jspec.family, jspec.tags, jspec.atol, jspec.rtol)
    args = make_args(spec, np.random.default_rng(0))
    jargs = j_make_args(jspec, np.random.default_rng(0))
    assert len(args) == len(jargs)
    for t, j in zip(args, jargs):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(_bytes(t), _bytes(j))
    got, want = _np(spec.fn(*args)), _np(jspec.fn(*jargs))
    assert got.shape == want.shape
    if spec.atol == 0:
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=spec.atol, rtol=spec.rtol)
    np.testing.assert_allclose(_np(spec.ref(*args)), got, atol=spec.atol,
                               rtol=spec.rtol)


@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (256, 128, 512),
                                   (200, 136, 264)])
@pytest.mark.parametrize("block", [(16, 16, 1), (128, 128, 8)])
def test_sgemm_f32(M, N, K, block, rng):
    x, y = rng.standard_normal((M, K)), rng.standard_normal((K, N))
    got = tmm.make_matmul(block=block)(_t(x), _t(y))
    want = j_make_matmul(block=(128, 128, 128))(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3, rtol=1e-3)


def test_sgemm_1024_parity(rng):
    x = rng.standard_normal((1024, 1024)) * 0.1
    y = rng.standard_normal((1024, 1024)) * 0.1
    got = tmm.sgemm(_t(x), _t(y))
    want = j_make_matmul(block=(512, 512, 512))(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype,jdt,atol,rtol", [
    (torch.bfloat16, jnp.bfloat16, 2e-1, 2e-2),
    (torch.float16, jnp.float16, 2e-2, 2e-2)])
def test_hgemm_half(dtype, jdt, atol, rtol, rng):
    x, y = rng.standard_normal((256, 384)), rng.standard_normal((384, 256))
    tx, ty = make_args_like(x, dtype), make_args_like(y, dtype)
    got = tmm.hgemm(tx, ty)
    assert got.dtype == dtype
    want = j_make_matmul(block=(128, 128, 128))(jnp.asarray(x, jdt),
                                                  jnp.asarray(y, jdt))
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def make_args_like(a, dtype):
    from leetcuda_tpu_torch.core.testing import _from_f64
    return _from_f64(np.asarray(a, np.float64), dtype)


def test_tn_layout(rng):
    x, y = rng.standard_normal((128, 256)), rng.standard_normal((192, 256))
    got = tmm.make_matmul(block=(128, 128, 16), layout="tn")(_t(x), _t(y))
    want = j_make_matmul(block=(128, 128, 128), layout="tn")(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_np(tmm.matmul_tn_ref(_t(x), _t(y))),
                               _np(got), atol=1e-5, rtol=1e-5)


def test_block_swizzle_matches_plain(rng):
    x, y = rng.standard_normal((512, 256)), rng.standard_normal((256, 512))
    got = tmm.make_matmul(block=(128, 128, 8), swizzle_group=2)(_t(x), _t(y))
    want = j_make_matmul(block=(128, 128, 128))(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("M,N,K,blk,g", [
    (512, 256, 2048, (128, 256, 256), 4), (256, 640, 384, (128, 128, 128), 4)])
def test_swizzled_matmul_awkward_shapes(M, N, K, blk, g, rng):
    a = rng.standard_normal((M, K)) * 0.3
    b = rng.standard_normal((K, N)) * 0.3
    got = tmm.make_matmul(block=(128, 128, 8), swizzle_group=g)(_t(a), _t(b))
    want = j_make_matmul(block=blk, swizzle_group=g)(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3, rtol=1e-3)


def test_out_dtype(rng):
    x, y = rng.standard_normal((200, 264)), rng.standard_normal((264, 136))
    tx, ty = _t(x, torch.bfloat16), _t(y, torch.bfloat16)
    got = tmm.make_matmul(out_dtype=torch.float32)(tx, ty)
    want = j_make_matmul(block=(128, 128, 128), out_dtype=jnp.float32)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3, rtol=1e-3)


AUTO_SHAPES = [(1024, 1024, 1024), (8192, 1024, 8192), (1024, 8192, 8192),
               (4096, 14336, 4096), (16384, 16384, 16384), (384, 640, 264),
               (8192, 8192, 1024)]


# pick_matmul_config's rules (its docstring cites the A/B): the 128 x 256
# tile where its tiles fill the card's 132 SMs, walked 8 tile columns at a
# time from 32 columns; the 64 x 64 tile below; f32 on the CUDA cores
AUTO_WANT = {(1024, 1024, 1024): ((64, 64, 32), None),
             (8192, 1024, 8192): ((128, 256, 32), None),
             (1024, 8192, 8192): ((128, 256, 32), 8),
             (4096, 14336, 4096): ((128, 256, 32), 8),
             (16384, 16384, 16384): ((128, 256, 32), 8),
             (384, 640, 264): ((64, 64, 32), None),
             (8192, 8192, 1024): ((128, 256, 32), 8),
             (16384, 3072, 2048): ((128, 256, 32), None),
             (16384, 32000, 2048): ((128, 256, 32), 8),
             (1152, 4096, 64): ((128, 256, 32), None),
             (1024, 4000, 64): ((64, 64, 32), None)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pick_matmul_config(dtype):
    for M, N, K in AUTO_SHAPES:
        cfg = tmm.pick_matmul_config(M, N, K, dtype)
        assert tuple(cfg["block"]) in tmm.BLOCKS, cfg
        path = tmm.BLOCKS[tuple(cfg["block"])][1]
        assert path == ("cuda-core" if dtype == torch.float32
                        else "tensor-core"), cfg
        assert cfg["layout"] == "nn"
        assert cfg["swizzle_group"] is None or cfg["swizzle_group"] >= 1
        tmm.make_matmul(**cfg)  # an instantiated config
    for (M, N, K), (block, group) in AUTO_WANT.items():
        cfg = tmm.pick_matmul_config(M, N, K, dtype)
        if dtype == torch.float32:
            assert (cfg["block"], cfg["swizzle_group"]) == (
                tmm.F32_DEFAULT, None)
        else:
            assert (cfg["block"], cfg["swizzle_group"]) == (block, group), (
                M, N, K)


def test_matmul_auto(rng):
    x, y = rng.standard_normal((384, 264)), rng.standard_normal((264, 640))
    got = tmm.matmul_auto(_t(x), _t(y))
    want = j_matmul_auto(jnp.asarray(x, jnp.float32),
                           jnp.asarray(y, jnp.float32))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)
    tn = tmm.matmul_auto(_t(x), _t(y.T.copy()), layout="tn")
    np.testing.assert_allclose(_np(tn), _np(got), atol=1e-4, rtol=1e-4)


def test_gemv(rng):
    x, w = rng.standard_normal(512), rng.standard_normal((512, 384))
    got = tgv.gemv(_t(x), _t(w))
    want = j_make_gemv(block=(128, 128))(jnp.asarray(x, jnp.float32),
                                         jnp.asarray(w, jnp.float32))
    assert tuple(got.shape) == want.shape == (1, 384)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("k_lanes", tgv.K_LANES)
def test_gemv_bf16(k_lanes, rng):
    x, w = rng.standard_normal(512), rng.standard_normal((512, 256))
    got = tgv.make_gemv(k_lanes=k_lanes)(_t(x, torch.bfloat16),
                                         _t(w, torch.bfloat16))
    want = j_make_gemv(block=(256, 128))(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(w, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-1, rtol=3e-2)
    np.testing.assert_allclose(_np(tgv.hgemv(_t(x, torch.bfloat16),
                                             _t(w, torch.bfloat16))),
                               _np(got), atol=0, rtol=0)


def test_rms_norm_gemv_fused(rng):
    x = rng.standard_normal(512)
    nw = rng.standard_normal(512) * 0.3 + 1.0
    w = rng.standard_normal((512, 256))
    got = tgv.rms_norm_gemv(_t(x), _t(nw), _t(w))
    want = j_make_rms_norm_gemv(block=(128, 128))(
        jnp.asarray(x, jnp.float32), jnp.asarray(nw, jnp.float32),
        jnp.asarray(w, jnp.float32))
    # f32 sums of 512 products of up to ~30 in another order
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    xn = x / np.sqrt((x ** 2).mean() + 1e-5) * nw
    np.testing.assert_allclose(_np(got).ravel(), xn @ w, atol=1e-2,
                               rtol=1e-3)


def test_gemv_epilogue(rng):
    x, w = rng.standard_normal(512) * 0.3, rng.standard_normal((512, 256))
    got = tgv.make_gemv(epilogue=F.silu)(_t(x, torch.bfloat16),
                                         _t(w, torch.bfloat16))
    want = j_make_gemv(block=(128, 128), epilogue=jax.nn.silu)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=3e-2)
    f32 = tgv.make_gemv(epilogue=F.silu)(_t(x), _t(w))
    jf32 = j_make_gemv(block=(128, 128), epilogue=jax.nn.silu)(
        jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32))
    np.testing.assert_allclose(_np(f32), _np(jf32), atol=1e-5, rtol=1e-5)


def test_i8i8i32(rng):
    x = rng.integers(-100, 100, (128, 256)).astype(np.int8)
    w = rng.integers(-100, 100, (256, 128)).astype(np.int8)
    got = tq.make_matmul_i8i8i32()(torch.from_numpy(x), torch.from_numpy(w))
    want = jq.make_matmul_i8i8i32(block=(128, 128, 128))(
        jnp.asarray(x), jnp.asarray(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_i8i8i32_k_off_the_jax_block(rng):
    """K = 272 is a multiple of 16 (the kernel's rows) but not of JAX's
    block: held against JAX's registry oracle and the int64 product."""
    x = rng.integers(-128, 128, (96, 272)).astype(np.int8)
    w = rng.integers(-128, 128, (272, 48)).astype(np.int8)
    got = tq.matmul_i8i8i32(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(JOPS["hgemm_w8a8_i32"].ref(jnp.asarray(x),
                                                 jnp.asarray(w)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.astype(np.int64) @ w.astype(np.int64))


def test_refusals():
    f32 = torch.ones(32, 32)
    with pytest.raises(ValueError, match="not instantiated"):
        tmm.make_matmul(block=(256, 256, 256))
    with pytest.raises(ValueError, match="tensor cores"):
        tmm.make_matmul(block=(128, 256, 32))(f32, f32)
    with pytest.raises(ValueError, match="layout"):
        tmm.make_matmul(layout="nt")
    with pytest.raises(ValueError, match="contract"):
        tmm.matmul(f32, torch.ones(16, 32))
    with pytest.raises(ValueError, match="not instantiated"):
        tgv.make_gemv(k_lanes=64)
    i8 = torch.ones
    with pytest.raises(ValueError, match="K % 16"):
        tq.matmul_i8i8i32(i8(8, 40, dtype=torch.int8),
                          i8(40, 16, dtype=torch.int8))
    with pytest.raises(ValueError, match="N % 16"):
        tq.matmul_i8i8i32(i8(8, 32, dtype=torch.int8),
                          i8(32, 24, dtype=torch.int8))
    with pytest.raises(ValueError, match="int8"):
        tq.matmul_i8i8i32(f32, f32)


def test_gemm_bench_cli(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.gemm_bench",
         "--device", "cpu", "--mnk", "256", "--variants", "sgemm_naive_f32",
         "--dtype", "float32", "--check", "--iters", "2"],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "sgemm_naive_f32 256x256x256" in r.stdout
    assert "torch.matmul 256x256x256" in r.stdout
    assert "max|diff|" in r.stdout
    # the A/Bs of the w8a16 kernel and of the dense tensor-core kernel: on
    # the CPU only the plain versions run, a check of the CLI
    for flags, rows in (
            (["--w8", "--w8-kn", "256", "512", "--m", "1", "40"],
             [(1, "fp8"), (40, "fp8"), (1, "int8"), (40, "int8")]),
            (["--hgemm", "--m", "200", "--n", "130", "--k", "261"],
             [(200, None)])):
        out = tmp_path / "rows.json"
        r = subprocess.run(
            [sys.executable, "-m", "leetcuda_tpu_torch.bench.gemm_bench",
             *flags, "--device", "cpu", "--iters", "1", "--json", str(out)],
            capture_output=True, text=True, timeout=300,
            env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
        assert r.returncode == 0, r.stderr[-2000:]
        got = json.loads(out.read_text())["rows"]
        assert [(row["M"], row.get("fmt")) for row in got] == rows
        assert all(row["variant"] == "plain" and row["max_abs_err"] == 0
                   for row in got)
