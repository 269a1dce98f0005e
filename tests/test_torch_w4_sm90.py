"""The Hopper w4a16 kernel's route, split plan and split sum, on the CPU.

The kernel of ``csrc/w4_matmul.cu`` (TMA + wgmma, split-K at decode rows)
runs only on the GPU, where ``chip_smoke.py`` holds it against
``matmul_w4a16_plain``. What surrounds its arithmetic is Python that these
tests reach:

- ``w4_plan``: the route is the wrapper's threshold on M, the CTA tile and
  stages are the source's defaults (the wrapper also compares them with the
  library's ``lc_w4_matmul_info`` on the card), the shared memory fits, and
  the splits cover K's groups once, in order, none empty and none
  straddling a group of 128 packed rows;
- the split sum: ``split_sum_mirror`` repeats the kernel's order (per
  split, each group's low and high products folded with their scales in
  f32, then the splits' partials summed in split order) and is held against
  JAX's ``matmul_w4a16_ref`` (the dequantized weight, one f32 dot) at M = 1,
  8, 9 and 72 and N = 512. The two round differently: each output is a sum
  of K products, and f32 sums of K terms in two orders differ by at most
  about K * 2^-24 * sum |x_k w_k| each (the standard bound for a dot), so
  every element is held to 2 * K * 2^-24 * (|x| @ |W|);
- the bench CLI (``gemm_bench --w4``) on the CPU.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leetcuda_tpu.gemm.quant import matmul_w4a16_ref
from leetcuda_tpu_torch.bench.gemm_bench import W4_VARIANTS
from leetcuda_tpu_torch.gemm import quant as gq

# path (c)'s weight shapes (K, N) and two ragged ones
KN = [(2048, 5632), (5632, 2048), (2048, 2048), (2048, 512), (256, 520),
      (768, 48)]
ROWS = [1, 8, 9, 16, 32, 33, 64, 72, 128, 1024]


def test_route_and_tile_are_the_sources_defaults():
    src = (Path(gq.__file__).parent.parent / "csrc"
           / "w4_matmul.cu").read_text()
    macro = {k: int(v) for k, v in
             re.findall(r"#define (LC_W4_\w+) (\d+)", src)}
    assert macro == {"LC_W4_PREFILL_M": gq.W4_PREFILL_ROWS,
                     "LC_W4_STAGES": gq.W4_STAGES, "LC_W4_PROBE": 0}
    for M in ROWS:
        route = gq.w4_plan(M, 2048, 2048)["route"]
        assert route == ("decode" if M <= gq.W4_DECODE_MAX_ROWS
                         else "prefill"), M


@pytest.mark.parametrize("K,N", KN, ids=[f"{k}x{n}" for k, n in KN])
def test_splits_cover_k_once(K, N):
    groups = K // 256
    for M in ROWS:
        for decode in (True, False):
            for v in W4_VARIANTS:
                p = gq.w4_plan(M, N, K, decode,
                               v.get("LC_W4_PREFILL_M", gq.W4_PREFILL_ROWS),
                               v.get("LC_W4_STAGES", gq.W4_STAGES))
                assert p["smem"] <= 232448
                spans = p["split_groups"]
                assert len(spans) == p["splits"] == p["grid"][2]
                # whole groups, in order, none empty, covering [0, groups)
                assert spans[0][0] == 0 and spans[-1][1] == groups
                assert all(a < b for a, b in spans)
                assert all(spans[i][1] == spans[i + 1][0]
                           for i in range(len(spans) - 1))
                n16 = -(-N // 16) * 16
                assert p["grid"][:2] == (-(-n16 // 128), -(-M // p["bm"]))
                if decode:
                    assert p["bm"] in (8, 16, 32, 64)
                    assert p["bm"] >= min(M, 64)
                    # split toward W4_SPLIT_CTAS CTAs in splits of equal
                    # group counts: at least half the splits asked for
                    tiles = p["grid"][0] * p["grid"][1]
                    want = min(groups, -(-gq.W4_SPLIT_CTAS // tiles))
                    assert want / 2 <= p["splits"] <= want
                    assert -(-groups // p["splits"]) == -(-groups // want)
                    assert p["workspace"] == (p["splits"] * M * n16
                                              if p["splits"] > 1 else 0)
                else:
                    assert p["splits"] == 1 and p["workspace"] == 0
                    assert p["bm"] == (
                        64 if M <= gq.W4_PREFILL_SMALL_ROWS
                        else v.get("LC_W4_PREFILL_M", gq.W4_PREFILL_ROWS))


def split_sum_mirror(x, packed, scales, plan):
    """The kernel's arithmetic in its order, in f32 numpy: per split, for
    each group in order, a = x_lo_g @ lo_g and b = x_hi_g @ hi_g folded as
    acc + (a * s_lo + b * s_hi); then the partials summed in split order."""
    Kh, N = packed.shape
    groups = Kh // 128
    lo = ((packed & 0xF) - 8).astype(np.float32)
    hi = (packed >> 4).astype(np.float32)
    parts = []
    for g0, g1 in plan["split_groups"]:
        acc = np.zeros((x.shape[0], N), np.float32)
        for g in range(g0, g1):
            r = slice(g * 128, (g + 1) * 128)
            a = x[:, r] @ lo[r]
            b = x[:, Kh + g * 128:Kh + (g + 1) * 128] @ hi[r]
            acc = acc + (a * scales[g] + b * scales[g + groups])
        parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@pytest.mark.parametrize("M", [1, 8, 9, 72])
def test_split_sum_mirror_matches_jax_ref(M):
    rng = np.random.default_rng(M)
    K, N = 2048, 512
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.02
    packed, scales = (t.numpy() for t in gq.quantize_groupwise_int4(
        torch.from_numpy(w)))
    # bf16-representable activations, as the kernel takes them
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    want = np.asarray(matmul_w4a16_ref(jnp.asarray(x), jnp.asarray(packed),
                                       jnp.asarray(scales)))
    wd = gq.dequantize_int4(torch.from_numpy(packed),
                            torch.from_numpy(scales)).numpy()
    tol = 2 * K * 2.0 ** -24 * (np.abs(x) @ np.abs(wd))
    for decode in (True, False):
        plan = gq.w4_plan(M, N, K, decode)
        if decode:  # the decode route splits K here
            assert plan["splits"] > 1
        got = split_sum_mirror(x, packed, scales, plan)
        assert np.all(np.abs(got - want) <= tol), (
            decode, float(np.max(np.abs(got - want) - tol)))
    # the bound is not slack: the split sum is not bit-equal to one dot
    assert not np.array_equal(got, want) or M == 1


def test_w4_bench_cli(tmp_path):
    import json
    import subprocess
    import sys

    out = tmp_path / "rows.json"
    r = subprocess.run(
        [sys.executable, "-m", "leetcuda_tpu_torch.bench.gemm_bench", "--w4",
         "--device", "cpu", "--w4-kn", "512", "256", "--m", "1", "9",
         "--iters", "1", "--json", str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(out.read_text())["rows"]
    # on the CPU only the plain version runs, once a row count, exact
    assert [(row["M"], row["variant"]) for row in rows] == [(1, "plain"),
                                                           (9, "plain")]
    assert all(row["max_abs_err"] == 0 for row in rows)
