"""GEMM benchmark CLI, the port's counterpart of
``leetcuda_tpu/bench/gemm_bench.py``: times registered gemm rungs (or
``auto``, the shape-adaptive ``matmul_auto``) beside ``torch.matmul`` in the
same dtype.

    python -m leetcuda_tpu_torch.bench.gemm_bench --mnk 2048 4096 8192
    python -m leetcuda_tpu_torch.bench.gemm_bench --m 16384 --n 3072 \\
        --k 2048 --variants auto hgemm_mma_stages_block_swizzle
    python -m leetcuda_tpu_torch.bench.gemm_bench --resident \\
        --json resident_bench.json
    python -m leetcuda_tpu_torch.bench.gemm_bench --w4 --json w4_bench.json
    python -m leetcuda_tpu_torch.bench.gemm_bench --w8 --json w8_bench.json
    python -m leetcuda_tpu_torch.bench.gemm_bench --hgemm --repeats 3
    python -m leetcuda_tpu_torch.bench.gemm_bench --gmm --repeats 5
    python -m leetcuda_tpu_torch.bench.gemm_bench --ln-bwd --repeats 5
    python -m leetcuda_tpu_torch.bench.gemm_bench --softmax --repeats 5
    python -m leetcuda_tpu_torch.bench.gemm_bench --gemv --repeats 5
    python -m leetcuda_tpu_torch.bench.gemm_bench --ln-fwd --repeats 5
    python -m leetcuda_tpu_torch.bench.gemm_bench --map --repeats 5
    python -m leetcuda_tpu_torch.bench.gemm_bench --fused --repeats 3
    python -m leetcuda_tpu_torch.bench.gemm_bench --rms --repeats 3
    python -m leetcuda_tpu_torch.bench.gemm_bench --i8 --repeats 3 \
        --before PARENT
    python -m leetcuda_tpu_torch.bench.gemm_bench --reduce --repeats 3 \
        --before PARENT

``--w4`` is the A/B of the w4a16 kernel (``csrc/w4_matmul.cu``): the
package's build and variant builds of its macros (prefill CTAs of 64 rows,
3 and 5 stages) and two probes whose results are wrong (LC_W4_PROBE 1:
the products on fixed fragments, no unpack; 2: no products, the feed
alone), each printing its ptxas registers and spills, time both routes
(decode: split-K; prefill) in turn with ``torch.matmul`` on the weight
dequantized to bf16 beforehand, at path (c)'s weight shapes (``--w4-kn``)
and the rows ``--m`` (default 1, 8, 16, 32, 64, 128, 1024), each route of
each build held against ``matmul_w4a16_plain`` (atol / rtol 1e-2).

``--w8`` is the A/B of the w8a16 kernel (``csrc/wq_matmul.cu``): the
package's build (the prefill route a conversion pass, then the dense
kernel), variant builds of 3 and 6 decode stages and a probe whose results
are wrong (LC_W8_PROBE 1: the decode route without its products, the feed
alone), each printing its ptxas registers and spills, time both routes in
turn with ``torch.matmul`` on the weight dequantized to bf16 beforehand, in
fp8 and int8, at paths (a) and (b)'s weight shapes (``--w8-kn``) and the
rows ``--m`` (default 1, 8, 16, 32, 64, 128, 192, 256, 384, 12288), each
route of each build held against ``matmul_w8a16_plain`` (atol / rtol
1e-2).

``--hgemm`` is the A/B of the dense tensor-core kernel (``csrc/matmul.cu``
on ``gemm_sm90.cuh``): each tensor-core tile with and without a group of 8
(the A/B behind ``pick_matmul_config``), variant builds of the 128 x 128
tile's stage count and a probe without products (LC_GEMM_PROBE 1), beside
``torch.matmul``, taken in turn, at path (j)'s shapes or ``--m`` / ``--n``
/ ``--k``.

``--gmm`` is the A/B of the grouped matmul (``csrc/gmm.cu``): its wgmma
route in the package's build (128 x 256 tiles, the units walked N fastest
within a row tile) and in variant builds of its macros (128 x 128 tiles of
6 stages; one tile column at a time, group 1), each printing its ptxas
registers and spills, the tile route (the earlier mma.sync kernel) and
``torch._grouped_mm``,
taken in turn at path (n)'s four products (Qwen3-30B-A3B: gate K 2048 / N
768 and down K 768 / N 2048 over the dropless buffer of a B=8 decode step,
16512 rows, and of an 8 x 1024 prefill, 81920 rows; 8 of 128 experts a
token, routed at random from ``--seed``), each held against ``gmm_plain``
(atol / rtol 2e-2).

``--ln-bwd`` is the A/B of the layer-norm backward (``csrc/row_ops.cu``):
its rows route at 1 and 2 CTAs an SM (the persistent grid), the block
route (the earlier kernel) and ``F.layer_norm``'s autograd backward, taken
in turn at (16384, 2048) in bf16, f32 and f16, each held against
``layer_norm_bwd_plain`` (atol / rtol 1e-2; f32 1e-3).

``--softmax`` is the A/B of the row softmax (``csrc/row_ops.cu``): the
cluster route at the plan's cluster size and at the others that hold the
row (8 and 16 CTAs a row of 32000 f32), variant builds whose CTAs take
their slice by one bulk copy into shared memory (LC_SOFTMAX_SMEM 1) or are
128 threads (LC_SOFTMAX_THREADS), and two probes whose results are wrong
(LC_SOFTMAX_PROBE 1: no arithmetic, the loads and stores alone; 2: no
cluster exchange), against the package's 256-thread CTAs holding their
slice in registers, the stream route (the earlier kernel) and
``torch.softmax``, taken in turn at (2048, 32000) and (8, 32000) f32 in the
safe form, each held against ``safe_softmax_plain`` (atol / rtol 1e-5).

``--gemv`` is the A/B of the gemv (``csrc/gemv.cu``): the package's build
(unrolled 16-byte loads, 4 a batch, each thread's next batch issued before
it sums the current one) at each ``k_lanes`` and at one CTA a panel,
variant builds of 8 loads a batch and of the TMA ring (2-D boxes of
64 rows into 4 or 8 shared-memory stages, LC_GEMV_TMA 1), and
``torch.matmul``, taken in turn at path (j)'s bf16 shapes of one decode row
(``wqkv``, ``w_gate_up``, ``w_down``, the output projection), each held
against ``gemv_plain`` (atol / rtol 1e-2); then ``rms_norm_gemv`` over
``wqkv`` in both feeds beside the eager pair (the norm, then
``torch.matmul``).

``--ln-fwd`` is the A/B of the layer-norm forward (``csrc/row_ops.cu``):
its rows route at the plan's group (8 warps a row at K = 2048, one vector a
thread; 8 warps in 2 vectors at 4096) and at groups of 4 warps (2 vectors
a thread at 2048), at 2 and 3 CTAs an SM as well as the plan's, variant
builds that allow half and twice the registers a thread
(LC_LN_THREAD_BYTES: 2 CTAs an SM at one vector a thread; 4 at two) and up
to 6 CTAs an SM (LC_LN_MAX_CTAS), each printed with its ptxas registers
and spills beside a build of the package's constants, the block route
(the earlier kernel) and ``F.layer_norm``, taken in turn at (16384, 2048)
and (16384, 4096) in bf16, f32 and f16, each held against
``layer_norm_plain`` (atol / rtol 1e-2; f32 1e-3).

``--map`` is the A/B of the elementwise map (``csrc/elementwise.cu``):
the package's build (4 loads in flight a thread, the SFU math for f16 /
bf16 outputs, one pass over exactly the vectors), variant builds of 1, 2
and 8 loads a step (LC_MAP_LOADS), of IEEE math for every output (LC_MAP_FAST 0) and of
streamed loads and stores (LC_MAP_CS 1), and the
library call (``F.silu``, ``F.gelu(approximate="tanh")``, ``torch.add``),
taken in turn at swish and gelu over (16384, 5632) and the add over
(16384, 2048) in bf16, each held against its plain version (the add bit for
bit, the activations at the registry's atol 2e-2 / rtol 1e-2); then the
SASS of each build's bf16 ``x8_pack`` kernels (``cuobjdump -sass``:
instructions, SFU operations, 16-byte loads and stores).

``--fused`` is the A/B of the fused decode entry block
(``csrc/fused_decode.cu``, the cluster split-K): the package's build at
the plan's cluster size and at 1, 2, 4 and 8 ranks a panel, variant builds
of panels of 128 columns (LC_FUSED_BOX 64: whole heads at head dim 128),
3 stages of 128 rows, 4 of 64 and 8 of 32 (LC_FUSED_STAGES,
LC_FUSED_ROWS) and four probes whose results are wrong (LC_FUSED_PROBE 1:
no pass over x; 2: no products; 3: no exchange between the ranks; 4: no
feed, no TMA and no waits), each at its own plan and printed with its
ptxas registers and spills, and ``torch.matmul`` alone on the same (B, D)
x (D, X), taken in turn at ModelConfig's ``wqkv`` (B = 8, D 2048, 16 / 4
heads of 128), Gemma-2-9B's layer 0 (D 3584, 16 / 8 heads of 256) and the
norm -> matmul form at ``w_gate_up`` (2048 x 11264), each held against its
plain version (atol / rtol 1e-2) but the probes; each candidate reports its
CUDA-event time and its device time alone (torch.profiler's kernel times,
the flush's fill left out).

``--rms`` is the A/B of the rms-norm (``csrc/row_ops.cu``): its rows
route at the plan's group (8 warps a row at K = 2048) and at 4 warps (2
vectors a thread), at 2 and 3 CTAs an SM as well as the plan's 4, variant
builds that raise the rows route's cap to 6 and 8 CTAs an SM
(LC_LN_MAX_CTAS), each printed with its ptxas registers and spills, the
block route (the earlier kernel) and ``F.rms_norm``, taken in turn at
(16384, 2048) and (16384, 4096) in bf16, f32 and f16, each held against
``rms_norm_plain`` (atol / rtol 1e-2; f32 1e-3).

``--i8`` is the A/B of the int8 matmul (``csrc/i8_matmul.cu``): the
package's build (w^T by a transpose pass, then the TMA + wgmma product at
128 x 256 tiles, 4 stages, CTA pairs, the column group of ``i8_plan``)
with its group and without, the transpose pass alone and the product alone
on a w^T made beforehand, variant builds of 128 x 128 tiles with 6 stages,
3 stages, single CTAs (LC_I8_BN, LC_I8_STAGES, LC_I8_CLUSTER) and a probe
whose results are wrong (LC_I8_PROBE 1: no wgmma), each printed with its
ptxas registers and spills, ``torch._int_mm`` on w as given and on w
column-major (``w.t().contiguous().t()``, cuBLASLt's TN layout), and with
``--before DIR`` the kernel of the checkout at DIR (an earlier commit:
its ``csrc/i8_matmul.cu`` built here, ``lc_i8_matmul(x, w, out, M, N, K,
stream)``), taken in turn at 8192^3, at ModelConfig's ``w_gate_up`` pack
(2048 x 11264) at training's 16384 rows, and at 16, 128 and 1000 rows of
2048 x 2048; each held exactly against ``matmul_i8i8i32_plain`` but the
probe.

``--reduce`` is the A/B of the whole-array reductions (``csrc/reduce.cu``):
the package's build (one launch, ``reduce_plan``'s grid of 4 CTAs an SM, 16
loads a thread in flight), variant builds of 2 and 8 CTAs an SM, 1 and 4
loads in flight (LC_REDUCE_CTAS_PER_SM, LC_REDUCE_INFLIGHT), two launches
(LC_REDUCE_LAUNCHES 2), plain loads in place of evict-first ones
(LC_REDUCE_CS 0) and a probe without arithmetic (LC_REDUCE_PROBE 1),
each printed with its ptxas registers and spills, the library call
(``torch.sum``, ``x.to(f16).sum()`` for fp8, ``torch.amax``,
``torch.dot``) and with ``--before DIR`` the earlier commit's
``csrc/reduce.cu`` (two passes, ``lc_reduce(..., partials, out,
out_dtype, stream)``), taken in turn at (16384, 2048) for every registered
sum rung, the default 16-byte rung in f32, int8 and e4m3, the f32 max and
the f32 dot rungs, each held against its plain version (int8 exactly, the
rest at the registry's tolerance) but the probe; then the SASS of the
int8 and e4m3 kernels of both builds (``cuobjdump -sass``: instructions,
loads by width, dp4a, fp8 converts).

``--resident`` is the A/B of the resident chain's build
(``csrc/matmul_resident.cu``): every stage count (3-5) that fits the
shared memory, the 128 x 256 tile against 128 x 128 (two consumer
warpgroups of 64 rows each), and clusters of 1, 2 and 4 CTAs along M, each
a variant build (``build.build_variants``, not kept by the package), and
the package's build with the products, then also the stores, left out (two
probes whose results are wrong: what the feed alone takes), at the chains
``--mnk`` x ``--reps`` (default 4096^3 x 5 and the registry's 128^2 x 3),
beside 5 (reps) ``torch.matmul`` and the port's ``hgemm``; the candidates
of a shape are timed in turn, ``--repeats`` rounds, and each reports its
median over the rounds.

Device-alone times (torch.profiler's kernel times) count only from a
profile whose kernels all ran a whole multiple of ``--iters`` times and
whose time a call is at least the case's bound; other profiles are
printed and dropped.

On a GPU each time is the median over ``--iters`` launches of CUDA-event
times, with the 50 MB L2 flushed by a 256 MB write before each launch (as
``chip_smoke.py`` times its kernels); ``--repeats`` > 1 reports the median,
best and spread of the repeats. ``--device cpu`` runs the plain versions on
the host clock, a check of the CLI and not a device measurement. f32 runs
with TF32 off, so ``torch.matmul`` is the f32 product too.
"""

from __future__ import annotations

import argparse
import itertools
import time

import numpy as np
import torch

from leetcuda_tpu_torch.core.registry import OPS, load_all
from leetcuda_tpu_torch.core.runtime import resolve_device
from leetcuda_tpu_torch.gemm import matmul as mm

DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}


def time_ms(fn, dev, iters, flush=None):
    """Median per-call milliseconds: CUDA events with the L2 flushed
    before each launch on a GPU, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def _rate(flops, ms, dev):
    """TFLOPS on a GPU; nothing for a host-clock time on the CPU."""
    return f" {flops / ms / 1e9:.2f} TFLOPS" if dev.type == "cuda" else ""


def _spread(ms):
    xs = sorted(ms)
    return (f" [repeats: median {xs[len(xs) // 2]:.4f} best {xs[0]:.4f} "
            f"spread {100.0 * (xs[-1] - xs[0]) / xs[-1]:.1f}%]")


def variant_fn(name, M, N, K, dtype):
    """(callable of (x, y), layout, atol, rtol, label) for one variant."""
    if name == "auto":
        cfg = mm.pick_matmul_config(M, N, K, dtype)
        label = (f"auto{cfg['block']}"
                 + (f"/swz{cfg['swizzle_group']}" if cfg["swizzle_group"]
                    else ""))
        return mm.make_matmul(**cfg), "nn", 2e-2, 2e-2, label
    spec = OPS[name]
    return (spec.fn, "tn" if "tn" in spec.tags else "nn", spec.atol,
            spec.rtol, name)


def bench_size(M, N, K, variants, dtype, dev, iters, repeats, check, flush):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    y = torch.randn((K, N), generator=gen, device=dev).to(dtype)
    y_tn = y.t().contiguous()
    flops = 2.0 * M * N * K
    rows = []
    for name in variants:
        fn, layout, atol, rtol, label = variant_fn(name, M, N, K, dtype)
        b = y if layout == "nn" else y_tn
        ms = [time_ms(lambda: fn(x, b), dev, iters, flush)
              for _ in range(repeats)]
        best = min(ms)
        print(f"  {label} {M}x{N}x{K}: {best:.4f} ms"
              + _rate(flops, best, dev)
              + (_spread(ms) if repeats > 1 else ""), flush=True)
        rows.append((label, best))
        if check:
            got = fn(x, b).float()
            want = mm.matmul_plain(x, b, layout).float()
            err = float((got - want).abs().max())
            print(f"  {label}: max|diff| vs plain = {err:.5f} (atol {atol}, "
                  f"rtol {rtol})")
            torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    ms = [time_ms(lambda: torch.matmul(x, y), dev, iters, flush)
          for _ in range(repeats)]
    best = min(ms)
    print(f"  torch.matmul {M}x{N}x{K}: {best:.4f} ms"
          + _rate(flops, best, dev)
          + (_spread(ms) if repeats > 1 else ""), flush=True)
    return rows + [("torch.matmul", best)]


# the variants of --resident: every (BN, stages, cluster) whose stages and
# staged output tile fit the 227 KB of shared memory (gemm_sm90.cuh
# GemmPlan::SMEM_BYTES), clusters at most the B boxes a stage
RESIDENT_VARIANTS = [
    {"LC_RES_BN": bn, "LC_RES_STAGES": st, "LC_RES_CLUSTER": cl}
    for bn in (256, 128) for st in (3, 4, 5) for cl in (1, 2, 4)
    if 1024 + st * (128 * 64 * 2 + 64 * bn * 2) + 128 * bn * 2
    + 8 * (3 * st + 2) <= 232448 and cl <= bn // 64]


# the package's build with parts left out (matmul_resident.cu LC_RES_PROBE):
# what the loads, the walk and the stores take without the products
RESIDENT_PROBES = {1: "probe: no wgmma", 2: "probe: no wgmma, no stores"}


def _variant_label(v):
    if v.get("LC_RES_PROBE"):
        return RESIDENT_PROBES[v["LC_RES_PROBE"]]
    return (f"128x{v['LC_RES_BN']} stages {v['LC_RES_STAGES']} cluster "
            f"{v['LC_RES_CLUSTER']}")


def bench_resident(cases, dev, iters, rounds, flush):
    """The resident chain's variant builds at each (n, reps) of ``cases``,
    in turn with 5 torch.matmul and the port's hgemm. Returns the rows."""
    variants = []
    if dev.type == "cuda":
        from leetcuda_tpu_torch.build import build_variants

        t = mm.RESIDENT_TILE
        builds = RESIDENT_VARIANTS + [
            {"LC_RES_BN": t["block_n"], "LC_RES_STAGES": t["stages"],
             "LC_RES_CLUSTER": t["cluster"], "LC_RES_PROBE": p}
            for p in RESIDENT_PROBES]
        for v, (lib, log) in zip(builds, build_variants("matmul_resident",
                                                        builds)):
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"  built {_variant_label(v)}: {regs[:2]}", flush=True)
            variants.append((_variant_label(v), lib))
    rows = []
    for n, reps in cases:
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
        b = (torch.randn((n, n), generator=gen, device=dev)
             * n ** -0.5).to(torch.bfloat16)
        want = mm.matmul_chain_plain(a, b, reps).float()

        def chained(step):
            def run():
                c = a
                for _ in range(reps):
                    c = step(c, b)
                return c
            return run

        fns = [(label, lambda lib=lib: mm._launch_resident(a, b, reps, lib))
               for label, lib in variants]
        if dev.type != "cuda":  # the plain chain: a check of the CLI
            fns.append(("plain chain", lambda: mm.matmul_chain_plain(
                a, b, reps)))
        fns += [(f"{reps} torch.matmul", chained(torch.matmul)),
                (f"{reps} hgemm", chained(mm.hgemm))]
        errs = {}
        for label, fn in fns:
            got = fn().float()
            errs[label] = float((got - want).abs().max())
            if (label, fn) in fns[:len(variants)] \
                    and not label.startswith("probe"):  # the kernel's builds
                torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
        times = {label: [] for label, _ in fns}
        for _ in range(rounds):
            for label, fn in fns:
                times[label].append(time_ms(fn, dev, iters, flush))
        flops = 2.0 * reps * n ** 3
        print(f"--- chain {n}^3 x {reps} (bound "
              f"{flops / 989e12 * 1e3:.4f} ms at 989 TFLOP/s) ---")
        for label, _ in fns:
            ms = float(np.median(times[label]))
            rows.append({"n": n, "reps": reps, "variant": label, "ms": ms,
                         "rounds": times[label],
                         "max_abs_err": errs[label]})
            rate = ("" if label.startswith("probe")  # not the product
                    else _rate(flops, ms, dev))
            print(f"  {label}: {ms:.4f} ms{rate}"
                  f" (rounds {min(times[label]):.4f}-"
                  f"{max(times[label]):.4f}; max|diff| vs plain "
                  f"{errs[label]:.4g})", flush=True)
    return rows


# the w4a16 kernel's variant builds: the package's, then one change each,
# then the probes
W4_VARIANTS = [{}, {"LC_W4_PREFILL_M": 64}, {"LC_W4_STAGES": 3},
               {"LC_W4_STAGES": 5}, {"LC_W4_PROBE": 1}, {"LC_W4_PROBE": 2}]
# path (c)'s weight shapes (K, N) of ModelConfig(): w_gate / w_up, w_down,
# wq / wo, wk / wv
W4_KN = ((2048, 5632), (5632, 2048), (2048, 2048), (2048, 512))
W4_ROWS = (1, 8, 16, 32, 64, 128, 1024)


def _w4_label(v):
    return "default" if not v else ", ".join(
        f"{k[6:].lower()} {x}" for k, x in sorted(v.items()))


def bench_w4(shapes, rows_m, dev, iters, rounds, flush):
    """Each w4a16 build's two routes at each (K, N) and M, in turn with
    torch.matmul on the weight dequantized beforehand (the plain version on
    the CPU). Returns the rows."""
    from leetcuda_tpu_torch.gemm import quant as gq

    builds = []
    if dev.type == "cuda":
        from leetcuda_tpu_torch.build import build_variants

        from .attn_bench import ptxas_summary

        for v, (lib, log) in zip(W4_VARIANTS,
                                 build_variants("w4_matmul", W4_VARIANTS)):
            print(f"  built {_w4_label(v)}: "
                  f"{ptxas_summary(log) if log else 'cached'}", flush=True)
            builds.append((v, lib))
    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for K, N in shapes:
        w = torch.randn((K, N), generator=gen, device=dev) * 0.02
        packed, scales = gq.quantize_groupwise_int4(w)
        wd = gq.dequantize_int4(packed, scales).to(torch.bfloat16)
        for M in rows_m:
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            want = gq.matmul_w4a16_plain(x, packed, scales)
            fns = []
            for vb, lib in builds:
                for decode in (True, False):
                    def run(lib=lib, decode=decode):
                        return gq._launch_w4a16(x, packed, scales, decode,
                                                lib)
                    err = float((run().float() - want.float()).abs().max())
                    if "LC_W4_PROBE" not in vb and not err <= 1e-2 + 1e-2 * \
                            float(want.float().abs().max()):
                        raise AssertionError(f"w4 {_w4_label(vb)} M={M} "
                                             f"K={K} N={N}: max abs {err}")
                    route = "decode" if decode else "prefill"
                    fns.append((f"{_w4_label(vb)} {route}", err, run, vb,
                                route))
            if dev.type == "cuda":
                fns.append(("torch.matmul, dequantized", 0.0,
                            lambda: torch.matmul(x, wd), None, None))
            else:  # the plain version: a check of the CLI
                fns.append(("plain", 0.0, lambda: gq.matmul_w4a16_plain(
                    x, packed, scales), None, None))
            times = {n: [] for n, *_ in fns}
            for _ in range(rounds):
                for n, _, fn, _, _ in fns:
                    times[n].append(time_ms(fn, dev, iters, flush))
            flops = 2.0 * M * N * K
            nbytes = 2.0 * M * K + K * N / 2 + 4.0 * (K // 128) * N \
                + 2.0 * M * N
            bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
            print(f"--- w4a16 M={M} K={K} N={N} (bound {bound:.4f} ms) ---")
            for n, err, _, vb, route in fns:
                ms = float(np.median(times[n]))
                row = {"M": M, "K": K, "N": N, "variant": n, "macros": vb,
                       "route": route, "max_abs_err": err, "ms": ms,
                       "rounds": times[n], "bound_ms": bound}
                if vb is not None:
                    row["plan"] = gq.w4_plan(
                        M, N, K, route == "decode",
                        vb.get("LC_W4_PREFILL_M", gq.W4_PREFILL_ROWS),
                        vb.get("LC_W4_STAGES", gq.W4_STAGES))
                rows.append(row)
                share = (f" ({bound / ms:.3f} of the bound)"
                         if dev.type == "cuda" else "")
                print(f"  {n}: {ms:.4f} ms{share}; max abs {err:.3g}",
                      flush=True)
    return rows


# the w8a16 kernel's variant builds: the package's, other decode stage
# counts, the decode probe
W8_VARIANTS = [{}, {"LC_W8_STAGES": 3}, {"LC_W8_STAGES": 6},
               {"LC_W8_PROBE": 1}]
# paths (a) and (b)'s weight shapes (K, N) of ModelConfig(): wqkv, wo,
# w_gate_up, w_down
W8_KN = ((2048, 3072), (2048, 2048), (2048, 11264), (5632, 2048))
W8_ROWS = (1, 8, 16, 32, 64, 128, 192, 256, 384, 12288)


def _w8_label(v):
    return "default" if not v else ", ".join(
        f"{k[6:].lower()} {x}" for k, x in sorted(v.items()))


def _builds(name, variants, label):
    """[(variant, loaded library)] of ``csrc/<name>.cu``'s variant builds,
    each printed with its ptxas registers and spills."""
    from leetcuda_tpu_torch.build import build_variants

    from .attn_bench import ptxas_summary

    out = []
    for v, (lib, log) in zip(variants, build_variants(name, variants)):
        print(f"  built {label(v)}: "
              f"{ptxas_summary(log) if log else 'cached'}", flush=True)
        out.append((v, lib))
    return out


def bench_w8(shapes, rows_m, dev, iters, rounds, flush):
    """Each w8a16 build's two routes at each (K, N), format and M, in turn
    with torch.matmul on the weight dequantized beforehand (the plain
    version on the CPU). Returns the rows."""
    from leetcuda_tpu_torch.gemm import quant as gq

    builds = (_builds("wq_matmul", W8_VARIANTS, _w8_label)
              if dev.type == "cuda" else [])
    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for K, N in shapes:
        w = torch.randn((K, N), generator=gen, device=dev) * 0.02
        for fmt, quant in (("fp8", gq.quantize_rowwise_fp8),
                           ("int8", gq.quantize_rowwise_int8)):
            q, s = quant(w)
            wd = (q.float() * s).to(torch.bfloat16)
            for M in rows_m:
                x = torch.randn((M, K), generator=gen, device=dev).to(
                    torch.bfloat16)
                want = gq.matmul_w8a16_plain(x, q, s)
                fns = []
                for vb, lib in builds:
                    for decode in (True, False):
                        if vb and not decode:
                            continue  # the variants change the decode route

                        def run(lib=lib, decode=decode):
                            return gq._launch_w8a16(x, q, s, decode, lib)
                        err = float((run().float() - want.float()).abs()
                                    .max())
                        if "LC_W8_PROBE" not in vb and not err <= 1e-2 + \
                                1e-2 * float(want.float().abs().max()):
                            raise AssertionError(
                                f"w8 {_w8_label(vb)} {fmt} M={M} K={K} "
                                f"N={N}: max abs {err}")
                        route = "decode" if decode else "prefill"
                        fns.append((f"{_w8_label(vb)} {route}", err, run, vb,
                                    route))
                if dev.type == "cuda":
                    fns.append(("torch.matmul, dequantized", 0.0,
                                lambda: torch.matmul(x, wd), None, None))
                else:  # the plain version: a check of the CLI
                    fns.append(("plain", 0.0, lambda: gq.matmul_w8a16_plain(
                        x, q, s), None, None))
                times = {n: [] for n, *_ in fns}
                for _ in range(rounds):
                    for n, _, fn, _, _ in fns:
                        times[n].append(time_ms(fn, dev, iters, flush))
                flops = 2.0 * M * N * K
                nbytes = 2.0 * M * K + K * N + 4.0 * N + 2.0 * M * N
                bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
                print(f"--- w8a16 {fmt} M={M} K={K} N={N} (bound "
                      f"{bound:.4f} ms) ---")
                for n, err, _, vb, route in fns:
                    ms = float(np.median(times[n]))
                    row = {"M": M, "K": K, "N": N, "fmt": fmt, "variant": n,
                           "macros": vb, "route": route, "max_abs_err": err,
                           "ms": ms, "rounds": times[n], "bound_ms": bound}
                    if vb is not None:
                        row["plan"] = gq.w8_plan(
                            M, N, K, route == "decode",
                            vb.get("LC_W8_STAGES", gq.W8_STAGES))
                    rows.append(row)
                    share = (f" ({bound / ms:.3f} of the bound)"
                             if dev.type == "cuda" else "")
                    print(f"  {n}: {ms:.4f} ms{share}; max abs {err:.3g}",
                          flush=True)
    return rows


# the dense kernel's variant builds beside the package's: the 128 x 128
# tile's other stage counts, and the probe without products
HGEMM_VARIANTS = [{"LC_MM_STAGES128": 4}, {"LC_MM_STAGES128": 5},
                  {"LC_GEMM_PROBE": 1}]
# path (j)'s shapes: the headline, training's five projections at B * S =
# 16384 rows (ModelConfig(): wqkv, wo, w_gate_up, w_down, the output
# projection) and the skewed shapes
HGEMM_MNK = ((8192, 8192, 8192), (16384, 3072, 2048), (16384, 2048, 2048),
             (16384, 11264, 2048), (16384, 2048, 5632), (16384, 32000, 2048),
             (8192, 1024, 8192), (1024, 8192, 8192), (4096, 14336, 4096),
             (8192, 8192, 1024), (384, 640, 264))


def _hgemm_label(v):
    if v.get("LC_GEMM_PROBE"):
        return "probe: no wgmma"
    return ", ".join(f"{k[3:].lower()} {x}" for k, x in sorted(v.items()))


def bench_hgemm(shapes, dtype, dev, iters, rounds, flush):
    """Every tensor-core tile of csrc/matmul.cu with and without a group of
    8, the variant builds (on the 128 x 128 tile; the probe on the default
    tile) and torch.matmul, in turn at each (M, N, K). Returns the rows."""
    builds = (_builds("matmul", HGEMM_VARIANTS, _hgemm_label)
              if dev.type == "cuda" else [])
    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for M, N, K in shapes:
        x = (torch.randn((M, K), generator=gen, device=dev) * 0.5).to(dtype)
        y = (torch.randn((K, N), generator=gen, device=dev) * 0.5).to(dtype)
        want = mm.matmul_plain(x, y)
        fns = {}
        if dev.type == "cuda":
            for blk, (_, path) in mm.BLOCKS.items():
                if path != "tensor-core":
                    continue
                for g in (None, 8):
                    f = mm.make_matmul(block=blk, swizzle_group=g)
                    fns[f"{blk}/{g or 'rows'}"] = (lambda f=f: f(x, y), None)
            for v, lib in builds:
                blk = (mm.HALF_DEFAULT if v.get("LC_GEMM_PROBE")
                       else (128, 128, 32))
                fns[f"{blk}/rows {_hgemm_label(v)}"] = (
                    lambda lib=lib, blk=blk: mm._launch(
                        x, y, M, N, K, dtype, "nn", blk, None, lib), v)
            fns["torch.matmul"] = (lambda: torch.matmul(x, y), None)
        else:  # the plain version: a check of the CLI
            fns["plain"] = (lambda: mm.matmul_plain(x, y), None)
        errs = {}
        for n, (fn, v) in fns.items():
            errs[n] = float((fn().float() - want.float()).abs().max())
            if not (v or {}).get("LC_GEMM_PROBE"):
                torch.testing.assert_close(fn().float(), want.float(),
                                           atol=2e-2, rtol=2e-2)
        times = {n: [] for n in fns}
        for _ in range(rounds):
            for n, (fn, _) in fns.items():
                times[n].append(time_ms(fn, dev, iters, flush))
        flops = 2.0 * M * N * K
        bound = flops / 989e12 * 1e3
        print(f"--- hgemm {M}x{N}x{K} (bound {bound:.4f} ms) ---")
        for n, (_, v) in fns.items():
            ms = float(np.median(times[n]))
            rows.append({"M": M, "N": N, "K": K, "variant": n, "macros": v,
                         "ms": ms, "rounds": times[n], "bound_ms": bound,
                         "max_abs_err": errs[n]})
            share = (f" ({bound / ms:.3f} of the bound)"
                     if dev.type == "cuda" and "probe" not in n else "")
            print(f"  {n}: {ms:.4f} ms{share}; max abs {errs[n]:.3g}",
                  flush=True)
    return rows


# path (n)'s products: (label, tokens, K, N), 8 of 128 experts a token
GMM_CASES = (("decode gate", 8, 2048, 768), ("decode down", 8, 768, 2048),
             ("prefill gate", 8192, 2048, 768),
             ("prefill down", 8192, 768, 2048))
GMM_EXPERTS, GMM_TOPK, GMM_BM = 128, 8, 128
# the grouped matmul's variant builds: the 128-row tile 128 wide, the walk
# a tile column at a time
GMM_VARIANTS = [{"LC_GMM_BN": 128, "LC_GMM_STAGES": 6}, {"LC_GMM_GROUP": 1}]


def _gmm_label(v):
    if "LC_GMM_GROUP" in v:
        return f"128 x 256, group {v['LC_GMM_GROUP']}"
    return f"128 x {v['LC_GMM_BN']}, {v['LC_GMM_STAGES']} stages, group 0"


def _in_turn(fns, dev, iters, rounds, flush):
    """{name: [time of each round]}, the functions taken in turn within
    each round, so that a drift of the card's clock falls on all alike."""
    times = {n: [] for n in fns}
    for _ in range(rounds):
        for n, fn in fns.items():
            times[n].append(time_ms(fn, dev, iters, flush))
    return times


def _dropless_tiles(rng, tokens, experts, topk, bm, dev):
    """The expert of each row tile of models/moe.py's dropless buffer for
    ``tokens`` tokens routed at random: each expert's copies padded to bm,
    the tiles past the last group E - 1."""
    from leetcuda_tpu_torch.gemm import grouped as gg

    counts = np.bincount(rng.choice(experts, tokens * topk),
                         minlength=experts)
    padded = torch.from_numpy(-(-counts // bm) * bm).to(dev)
    rows = -(-tokens * topk // bm) * bm + experts * bm
    return rows, gg.tile_groups_from_sizes(padded, bm, rows // bm).clamp_(
        max=experts - 1)


def bench_gmm(dev, iters, rounds, flush, seed=0):
    """The wgmma route of the package's build and of the variant builds, the
    tile route and torch._grouped_mm in turn at path (n)'s four products (on
    the CPU the plain version at a cut size: a check of the CLI). Returns
    the rows."""
    from leetcuda_tpu_torch.gemm import grouped as gg

    builds = (_builds("gmm", GMM_VARIANTS, _gmm_label)
              if dev.type == "cuda" else [])
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cut = dev.type != "cuda"
    experts = 4 if cut else GMM_EXPERTS
    rows_out = []
    for label, tokens, K, N in GMM_CASES:
        if cut:
            tokens, K, N = tokens // 64 or 1, K // 16, N // 16
        T, tiles = _dropless_tiles(rng, tokens, experts, min(GMM_TOPK,
                                                             experts),
                                   GMM_BM, dev)
        lhs = torch.randn((T, K), generator=gen, device=dev).to(
            torch.bfloat16)
        rhs = (torch.randn((experts, K, N), generator=gen, device=dev)
               * K ** -0.5).to(torch.bfloat16)
        want = gg.gmm_plain(lhs, rhs, tiles, GMM_BM)
        fns = {}
        if not cut:
            fns["wgmma 128 x 256, 3 stages, group 0 (package)"] = (
                lambda: gg._launch(lhs, rhs, tiles, GMM_BM, "wgmma"))
            for v, lib in builds:
                fns[f"wgmma {_gmm_label(v)}"] = (
                    lambda lib=lib: gg._launch(lhs, rhs, tiles, GMM_BM,
                                               "wgmma", lib))
            fns["tile route"] = lambda: gg._launch(lhs, rhs, tiles, GMM_BM,
                                                   "tile")
            offs = (torch.cumsum(torch.bincount(tiles.long(),
                                                minlength=experts), 0)
                    * GMM_BM).to(torch.int32)
            if hasattr(torch, "_grouped_mm"):
                fns["torch._grouped_mm"] = lambda: torch._grouped_mm(
                    lhs, rhs, offs=offs)
        else:
            fns["plain"] = lambda: gg.gmm_plain(lhs, rhs, tiles, GMM_BM)
        errs = {}
        for n, fn in list(fns.items()):
            try:
                got = fn()
            except RuntimeError as e:  # torch._grouped_mm may refuse
                print(f"  {label}: {n} refused: {str(e)[:120]}")
                del fns[n]
                continue
            errs[n] = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)
        times = _in_turn(fns, dev, iters, rounds, flush)
        flops = 2.0 * T * K * N
        nbytes = 2.0 * (T * K + T * N + experts * K * N)
        bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        print(f"--- gmm {label}: T={T} K={K} N={N} (all rows' bound "
              f"{bound:.4f} ms) ---")
        for n in fns:
            ms = float(np.median(times[n]))
            rows_out.append({"case": label, "T": T, "K": K, "N": N,
                             "variant": n, "ms": ms, "rounds": times[n],
                             "bound_ms": bound, "max_abs_err": errs[n]})
            print(f"  {n}: {ms:.4f} ms; max abs {errs[n]:.3g}", flush=True)
    return rows_out


def bench_ln_bwd(dev, iters, rounds, flush, S=16384, K=2048):
    """The layer-norm backward's rows route at 1 and 2 CTAs an SM, the
    block route and autograd's backward in turn at (S, K) in bf16, f32 and
    f16 (on the CPU the plain version at a cut size). Returns the rows."""
    import torch.nn.functional as F

    from leetcuda_tpu_torch.ops import layer_norm as ln

    if dev.type != "cuda":
        S, K = 64, 256
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dt in (torch.bfloat16, torch.float32, torch.float16):
        x = torch.randn((S, K), generator=gen, device=dev).to(dt)
        g = (torch.randn(K, generator=gen, device=dev) * 0.3 + 1).to(dt)
        dy = torch.randn((S, K), generator=gen, device=dev).to(dt)
        want = ln.layer_norm_bwd_plain(x, g, dy)
        fns = {}
        if dev.type == "cuda":
            for per_sm in (2, 1):
                plan = ln.ln_bwd_plan(S, K, x.element_size(), per_sm=per_sm)
                fns[f"rows route, {per_sm} CTAs an SM ({plan['grid']})"] = (
                    lambda plan=plan: ln._launch_bwd(
                        x, g, dy, torch.empty_like(x), plan))
            block = ln.ln_bwd_plan(S, K, x.element_size(), aligned=False)
            fns["block route"] = lambda: ln._launch_bwd(
                x, g, dy, torch.empty_like(x), block)
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (x, g, torch.zeros_like(g))]
            y = F.layer_norm(leaves[0], (K,), *leaves[1:], eps=ln.EPS)
            fns["autograd"] = lambda: torch.autograd.grad(
                y, leaves, dy, retain_graph=True)
        else:
            fns["plain"] = lambda: ln.layer_norm_bwd_plain(x, g, dy)
        tol = 1e-3 if dt == torch.float32 else 1e-2
        errs = {}
        for n, fn in fns.items():
            errs[n] = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(fn(), want))
            for a, b in zip(fn(), want):
                torch.testing.assert_close(a.float(), b.float(), atol=tol,
                                           rtol=tol)
        times = _in_turn(fns, dev, iters, rounds, flush)
        bound = 3.0 * S * K * x.element_size() / 3.35e12 * 1e3
        print(f"--- layer_norm_bwd {str(dt)[6:]} ({S}, {K}) (bound "
              f"{bound:.4f} ms) ---")
        for n in fns:
            ms = float(np.median(times[n]))
            rows.append({"dtype": str(dt)[6:], "S": S, "K": K, "variant": n,
                         "ms": ms, "rounds": times[n], "bound_ms": bound,
                         "max_abs_err": errs[n]})
            print(f"  {n}: {ms:.4f} ms; max abs {errs[n]:.3g}", flush=True)
    return rows


SOFTMAX_CASES = ((2048, 32000), (8, 32000))
SOFTMAX_VARIANTS = [{"LC_SOFTMAX_SMEM": 1}, {"LC_SOFTMAX_THREADS": 128},
                    {"LC_SOFTMAX_PROBE": 1}, {"LC_SOFTMAX_PROBE": 2}]


def _softmax_label(v):
    if v.get("LC_SOFTMAX_PROBE"):
        return ("probe: no arithmetic" if v["LC_SOFTMAX_PROBE"] == 1
                else "probe: no cluster exchange")
    if v.get("LC_SOFTMAX_SMEM"):
        return "shared-memory slice"
    return f"CTAs of {v['LC_SOFTMAX_THREADS']} threads"


def bench_softmax(dev, iters, rounds, flush):
    """The safe softmax's cluster route at each cluster size that holds the
    row, its shared-memory-slice build, the stream route and torch.softmax
    in turn at SOFTMAX_CASES f32 (on the CPU the plain version at a cut
    size). Returns the rows."""
    import ctypes

    from leetcuda_tpu_torch.build import entry
    from leetcuda_tpu_torch.ops import rowwise as rw
    from leetcuda_tpu_torch.ops import softmax as sm

    builds = (_builds("row_ops", SOFTMAX_VARIANTS, _softmax_label)
              if dev.type == "cuda" else [])
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for S, K in SOFTMAX_CASES:
        if dev.type != "cuda":
            S, K = S // 64 or 1, K // 64
        x = torch.randn((S, K), generator=gen, device=dev) * 2.0
        want = sm.safe_softmax_plain(x)
        lb = rw.load_bytes(8, True, 4)
        plan = (sm.device_plan(x, lb) if dev.type == "cuda"
                else sm.softmax_plan(S, K, 4, lb))
        fns = {}
        if dev.type == "cuda":
            for C in (4, 8, 16):
                try:
                    p = sm.device_plan(x, lb, cluster=C)
                except ValueError:
                    continue  # C CTAs cannot hold the row
                tag = " (plan)" if C == plan.get("cluster") else ""
                fns[f"cluster {C}, {p['nb']} B a thread ({p['clusters']} "
                    f"clusters){tag}"] = (
                    lambda p=p: sm._run(x, torch.empty_like(x), sm.SAFE, 8,
                                        lb, p))
            for v, lib in builds:
                # the variant's own threads and occupancy set its plan
                def active(C, nb, lib=lib):
                    n = ctypes.c_int(0)
                    entry(lib, "lc_softmax_clusters",
                          rw.SOFTMAX_CLUSTERS_ARGS)(rw.DTYPES[x.dtype], lb,
                                                    nb, C, ctypes.byref(n))
                    return n.value

                vplan = sm.softmax_plan(
                    S, K, 4, lb, active=active,
                    threads=v.get("LC_SOFTMAX_THREADS", sm.SM_THREADS))
                fns[f"cluster {vplan['cluster']}, {_softmax_label(v)}, "
                    f"{vplan['nb']} B a thread ({vplan['clusters']} "
                    f"clusters)"] = (
                    lambda lib=lib, vplan=vplan: sm._run(
                        x, torch.empty_like(x), sm.SAFE, 8, lb, vplan, lib))
            fns["stream route"] = lambda: sm._run(
                x, torch.empty_like(x), sm.SAFE, 8, lb, {"route": "stream"})
            fns["torch.softmax"] = lambda: torch.softmax(x, dim=-1)
        else:
            fns["plain"] = lambda: sm.safe_softmax_plain(x)
        errs = {}
        for n, fn in fns.items():
            got = fn()
            errs[n] = float((got - want).abs().max())
            if "probe" not in n:  # a probe's results are wrong by design
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        times = _in_turn(fns, dev, iters, rounds, flush)
        bound = 2.0 * S * K * 4 / 3.35e12 * 1e3
        print(f"--- safe softmax f32 ({S}, {K}) (bound {bound:.4f} ms; plan "
              f"{plan}) ---")
        for n in fns:
            ms = float(np.median(times[n]))
            rows.append({"S": S, "K": K, "variant": n, "ms": ms,
                         "rounds": times[n], "bound_ms": bound,
                         "max_abs_err": errs[n]})
            print(f"  {n}: {ms:.4f} ms ({bound / ms:.3f} of the bound); max "
                  f"abs {errs[n]:.3g}", flush=True)
    return rows


# the layer-norm forward's variant builds: the package's constants (a
# control, built here to print its ptxas report), and other registers a
# thread's state may take (LC_LN_THREAD_BYTES over its bytes: at one
# vector a thread 2 CTAs an SM at 256, else 4; at two vectors of a 2-byte
# type 2, 3, 4 CTAs at 512, 640, 768 and up; f32 2, 2, 3, 4 at 512, 640,
# 768, 1024) and up to 6 CTAs an SM (LC_LN_MAX_CTAS)
LN_FWD_VARIANTS = [{"LC_LN_THREAD_BYTES": 640}, {"LC_LN_THREAD_BYTES": 256},
                   {"LC_LN_THREAD_BYTES": 512}, {"LC_LN_THREAD_BYTES": 768},
                   {"LC_LN_THREAD_BYTES": 1024},
                   {"LC_LN_THREAD_BYTES": 1024, "LC_LN_MAX_CTAS": 6}]
LN_FWD_K = (2048, 4096)  # the model's width, and the route's widest


def _ln_fwd_label(v):
    from leetcuda_tpu_torch.ops.layer_norm import FWD_THREAD_BYTES

    tb = v["LC_LN_THREAD_BYTES"]
    if "LC_LN_MAX_CTAS" in v:
        return f"{tb} bytes a thread, up to {v['LC_LN_MAX_CTAS']} CTAs an SM"
    return f"{tb} bytes a thread" + (" (the package's)"
                                     if tb == FWD_THREAD_BYTES else "")


def bench_ln_fwd(dev, iters, rounds, flush, S=16384):
    """The layer-norm forward's rows route at each group size and grid, its
    variant builds, the block route and F.layer_norm in turn at (S, K) for
    each K of LN_FWD_K in bf16, f32 and f16 (on the CPU the plain version
    at a cut size). Returns the rows."""
    import torch.nn.functional as F

    from leetcuda_tpu_torch.ops import layer_norm as ln

    builds = (_builds("row_ops", LN_FWD_VARIANTS, _ln_fwd_label)
              if dev.type == "cuda" else [])
    shapes = ([(S, K) for K in LN_FWD_K] if dev.type == "cuda"
              else [(64, 256)])
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for (S, K), dt in itertools.product(
            shapes, (torch.bfloat16, torch.float32, torch.float16)):
        x = torch.randn((S, K), generator=gen, device=dev).to(dt)
        g = (torch.randn(K, generator=gen, device=dev) * 0.3 + 1).to(dt)
        b = (torch.randn(K, generator=gen, device=dev) * 0.3).to(dt)
        want = ln.layer_norm_plain(x, g, b)
        isz = x.element_size()
        plan = ln.ln_fwd_plan(S, K, isz)
        fns = {}
        if dev.type == "cuda":
            def rows_route(p, lib="row_ops"):
                return lambda: ln._run_fwd(x, g, b, torch.empty_like(x), 8,
                                           True, p, lib)

            per_sm = ln.fwd_ctas(plan["nv"], isz)
            cands = [(plan["group"], n)
                     for n in dict.fromkeys((per_sm, 2, 3)) if n <= per_sm]
            cands += [(gr, ln.fwd_ctas(-(-K // (8 * gr)), isz))
                      for gr in ln.FWD_GROUPS
                      if gr != plan["group"] and gr * 16 >= K]
            for gr, n in cands:
                p = ln.ln_fwd_rows_plan(S, K, gr, n)
                tag = " (plan)" if p == plan else ""
                fns[f"rows, group {gr}, {p['nv']} vectors a thread, grid "
                    f"{p['grid']}{tag}"] = rows_route(p)
            for v, lib in builds:
                n = ln.fwd_ctas(plan["nv"], isz, v["LC_LN_THREAD_BYTES"],
                                v.get("LC_LN_MAX_CTAS", ln.FWD_MAX_CTAS))
                p = ln.ln_fwd_rows_plan(S, K, plan["group"], n)
                fns[f"rows, group {p['group']}, grid {p['grid']}, "
                    f"{_ln_fwd_label(v)}"] = rows_route(p, lib)
            fns["block route"] = lambda: ln._run_fwd(
                x, g, b, torch.empty_like(x), 8, True, {"route": "block"})
            fns["F.layer_norm"] = lambda: F.layer_norm(x, (K,), g, b,
                                                       eps=ln.EPS)
        else:
            fns["plain"] = lambda: ln.layer_norm_plain(x, g, b)
        tol = 1e-3 if dt == torch.float32 else 1e-2
        errs = {}
        for n, fn in fns.items():
            got = fn()
            errs[n] = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
        times = _in_turn(fns, dev, iters, rounds, flush)
        bound = 2.0 * S * K * isz / 3.35e12 * 1e3
        print(f"--- layer_norm {str(dt)[6:]} ({S}, {K}) (bound {bound:.4f} "
              f"ms; plan {plan}) ---")
        for n in fns:
            ms = float(np.median(times[n]))
            rows.append({"dtype": str(dt)[6:], "S": S, "K": K, "variant": n,
                         "ms": ms, "rounds": times[n], "bound_ms": bound,
                         "max_abs_err": errs[n]})
            print(f"  {n}: {ms:.4f} ms ({bound / ms:.3f} of the bound); max "
                  f"abs {errs[n]:.3g}", flush=True)
    return rows


# the map's variant builds: vectors a step, IEEE math for half outputs
MAP_VARIANTS = [{"LC_MAP_LOADS": 1}, {"LC_MAP_LOADS": 2},
                {"LC_MAP_LOADS": 8}, {"LC_MAP_FAST": 0}, {"LC_MAP_CS": 1}]
# (what, op code, columns): swish and gelu over the FFN hidden, the add over
# the residual stream, 16384 rows of bf16
MAP_CASES = (("swish", 4, 5632), ("gelu", 3, 5632), ("add", 0, 2048))


def _map_label(v):
    if "LC_MAP_FAST" in v:
        return "IEEE math"
    if "LC_MAP_CS" in v:
        return "streamed words"
    return f"{v['LC_MAP_LOADS']} loads a step"


def map_sass(lib_path, op):
    """Instruction counts of the bf16 x8_pack map kernel of ``op`` in a
    build (cuobjdump -sass): every instruction, the SFU's (MUFU), the
    16-byte loads and stores."""
    import re
    import subprocess
    from collections import Counter
    from pathlib import Path

    from leetcuda_tpu_torch.build import _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    tag = f"map_kernelI13__nv_bfloat16Li{op}ELi8ELi16E"
    part = next(p for p in sass.split("Function : ")[1:]
                if tag in p.split("\n", 1)[0])
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", part)
    c = Counter(o.split(".")[0] for o in ops)
    return {"instructions": len(ops), "MUFU": c["MUFU"],
            "LDG.128": sum(o.startswith("LDG") and ".128" in o for o in ops),
            "STG.128": sum(o.startswith("STG") and ".128" in o for o in ops)}


def map_grid(x, vec, pack, loads=None):
    """``ew.map_plan`` for x with a build's loads a step (``loads``)."""
    from leetcuda_tpu_torch.ops import elementwise as ew
    from leetcuda_tpu_torch.ops import flat

    vec, lb = flat.rung_bytes(vec, pack, x.element_size())
    return ew.map_plan(x.numel(), x.element_size(), vec, lb, x.data_ptr(),
                       loads or ew.MAP_LOADS)


def bench_map(dev, iters, rounds, flush):
    """The map's builds and grids and the library call in turn at
    MAP_CASES, then each build's SASS (on the CPU the plain versions at a
    cut size). Returns the rows."""
    import torch.nn.functional as F

    from leetcuda_tpu_torch.build import _lib_path
    from leetcuda_tpu_torch.ops import activations as act
    from leetcuda_tpu_torch.ops import elementwise as ew

    builds = (_builds("elementwise", MAP_VARIANTS, _map_label)
              if dev.type == "cuda" else [])
    lib_calls = {"swish": F.silu,
                 "gelu": lambda t: F.gelu(t, approximate="tanh")}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for what, op, K in MAP_CASES:
        S = 16384 if dev.type == "cuda" else 16
        if dev.type != "cuda":
            K //= 64
        x = torch.randn((S, K), generator=gen, device=dev).to(torch.bfloat16)
        y = (torch.randn((S, K), generator=gen, device=dev).to(torch.bfloat16)
             if op == ew.ADD else None)
        counter = ew.ELEMENTWISE_ADD if op == ew.ADD else act.ACTIVATION
        if op == ew.ADD:
            want = ew.add_plain(x, y)
        else:
            want = act.activation_plain(act.ACTIVATIONS[what], x)
        fns = {}
        if dev.type == "cuda":
            def run(lib="elementwise", loads=None):
                plan = map_grid(x, 8, True, loads)
                return lambda: ew.launch_map(counter, x, y, op, 8, True,
                                             plan=plan, lib=lib)

            fns[f"{ew.MAP_LOADS} loads a step (package)"] = run()
            for v, lib in builds:
                fns[_map_label(v)] = run(lib, v.get("LC_MAP_LOADS"))
            fns["library"] = ((lambda: torch.add(x, y)) if op == ew.ADD
                              else (lambda: lib_calls[what](x)))
        else:
            fns["plain"] = ((lambda: ew.add_plain(x, y)) if op == ew.ADD
                            else (lambda: act.activation_plain(
                                act.ACTIVATIONS[what], x)))
        errs = {}
        for n, fn in fns.items():
            got = fn()
            errs[n] = float((got.float() - want.float()).abs().max())
            if op == ew.ADD and n != "library":
                assert torch.equal(got, want), f"add {n}: not bit for bit"
            else:
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=2e-2, rtol=1e-2)
        times = _in_turn(fns, dev, iters, rounds, flush)
        nbytes = (3 if op == ew.ADD else 2) * x.numel() * 2
        bound = nbytes / 3.35e12 * 1e3
        print(f"--- {what} bf16 ({S}, {K}) (bound {bound:.4f} ms) ---")
        for n in fns:
            ms = float(np.median(times[n]))
            rows.append({"case": what, "S": S, "K": K, "variant": n,
                         "ms": ms, "rounds": times[n], "bound_ms": bound,
                         "max_abs_err": errs[n]})
            print(f"  {n}: {ms:.4f} ms ({bound / ms:.3f} of the bound); max "
                  f"abs {errs[n]:.3g}", flush=True)
    if dev.type == "cuda":
        from leetcuda_tpu_torch.build import BUILD_DIR

        paths = {"package": _lib_path("elementwise")}
        for v in MAP_VARIANTS:
            paths[_map_label(v)] = _lib_path("elementwise", tuple(
                f"-D{k}={x}" for k, x in sorted(v.items())))
        for label, path in paths.items():
            if path.parent == BUILD_DIR and path.exists():
                for what, op, _ in MAP_CASES:
                    c = map_sass(path, op)
                    rows.append({"sass": label, "case": what, **c})
                    print(f"  SASS {label}, {what} bf16 x8_pack: {c}")
    return rows


# path (j)'s weights of one decode row: ModelConfig()'s layer-0 projections
# and the output projection, (K, N) bf16
GEMV_KN = (("wqkv", 2048, 3072), ("w_gate_up", 2048, 11264),
           ("w_down", 5632, 2048), ("lm_out", 2048, 32000))
GEMV_VARIANTS = [{"LC_GEMV_UNROLL": 8},
                 {"LC_GEMV_TMA": 1, "LC_GEMV_STAGES": 4},
                 {"LC_GEMV_TMA": 1, "LC_GEMV_STAGES": 8}]


def _gemv_label(v):
    if v.get("LC_GEMV_TMA"):
        return f"TMA ring, {v['LC_GEMV_STAGES']} stages of 64 rows"
    return f"unrolled loads, {v['LC_GEMV_UNROLL']} a batch"


def bench_gemv(dev, iters, rounds, flush):
    """The gemv's builds, k_lanes and cluster sizes and torch.matmul in turn
    at GEMV_KN, then rms_norm_gemv over wqkv in both feeds beside the eager
    pair (on the CPU the plain versions at a cut size). Returns the rows."""
    from leetcuda_tpu_torch.gemm import gemv as gv

    cuda = dev.type == "cuda"
    builds = _builds("gemv", GEMV_VARIANTS, _gemv_label) if cuda else []
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    rows = []

    def report(label, K, N, fns, want, nbytes):
        errs = {}
        for n, fn in fns.items():
            got = fn()
            errs[n] = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                                       rtol=1e-2)
        times = _in_turn(fns, dev, iters, rounds, flush)
        bound = nbytes / 3.35e12 * 1e3
        print(f"--- {label} (K={K}, N={N}; bound {bound:.4f} ms) ---")
        for n in fns:
            ms = float(np.median(times[n]))
            rows.append({"case": label, "K": K, "N": N, "variant": n,
                         "ms": ms, "rounds": times[n], "bound_ms": bound,
                         "max_abs_err": errs[n]})
            print(f"  {n}: {ms:.4f} ms ({bound / ms:.3f} of the bound); "
                  f"max abs {errs[n]:.3g}", flush=True)

    for key, K, N in GEMV_KN:
        if not cuda:
            K, N = K // 16, N // 16
        w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(bf)
        x = torch.randn(K, generator=gen, device=dev).to(bf)
        want = gv.gemv_plain(x, w)
        fns = {}
        if cuda:
            for kl in gv.K_LANES:
                plan = gv.device_plan(K, N, bf, kl, False, x.device)
                tag = " (default)" if kl == gv.DEFAULT_K_LANES else ""
                fns[f"loads, 4 a batch, k_lanes {kl}, cluster "
                    f"{plan['cluster']}{tag}"] = (
                    lambda kl=kl, plan=plan: gv._launch(
                        gv.GEMV, x, w, None, kl, 0.0, bf, plan))
            one = gv.gemv_plan(K, N, 2, cluster=1)
            fns["loads, 4 a batch, one CTA a panel"] = lambda: gv._launch(
                gv.GEMV, x, w, None, gv.DEFAULT_K_LANES, 0.0, bf, one)
            plan = gv.device_plan(K, N, bf, gv.DEFAULT_K_LANES, False,
                                  x.device)
            for v, lib in builds:
                fns[_gemv_label(v)] = (
                    lambda lib=lib: gv._launch(gv.GEMV, x, w, None,
                                               gv.DEFAULT_K_LANES, 0.0, bf,
                                               plan, lib))
            fns["torch.matmul"] = lambda: torch.matmul(x.reshape(1, -1), w)
        else:
            fns["plain"] = lambda: gv.gemv_plain(x, w)
        report(f"gemv {key}", K, N, fns, want, 2.0 * (K * N + K + N))

    key, K, N = GEMV_KN[0]
    if not cuda:
        K, N = K // 16, N // 16
    w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(bf)
    x = torch.randn(K, generator=gen, device=dev).to(bf)
    nw = (torch.randn(K, generator=gen, device=dev) * 0.3 + 1).to(bf)
    want = gv.rms_norm_gemv_plain(x, nw, w)
    fns = {}
    if cuda:
        plan = gv.device_plan(K, N, bf, gv.DEFAULT_K_LANES, True, x.device)
        fns["rms_norm_gemv, loads (package)"] = lambda: gv.rms_norm_gemv(
            x, nw, w)
        for v, lib in builds:
            if v.get("LC_GEMV_TMA"):
                fns[f"rms_norm_gemv, {_gemv_label(v)}"] = (
                    lambda lib=lib: gv._launch(gv.RMS_NORM_GEMV, x, w, nw,
                                               gv.DEFAULT_K_LANES, 1e-5, bf,
                                               plan, lib))

        def eager():
            xf = x.float()
            xn = xf * torch.rsqrt(xf.square().mean() + 1e-5) * nw.float()
            return torch.matmul(xn.to(bf).reshape(1, -1), w)

        fns["eager pair (norm, torch.matmul)"] = eager
    else:
        fns["plain"] = lambda: gv.rms_norm_gemv_plain(x, nw, w)
    report(f"rms_norm_gemv {key}", K, N, fns, want, 2.0 * (K * N + 2 * K + N))
    return rows


def _device_alone(fn, iters, flush, bound=0.0):
    """torch.profiler's kernel time of ``fn`` a call (the flush's fill left
    out), or None where a profile came back without whole counts or below
    ``bound`` ms a call (a profile that lost launches; printed)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()

    def t(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in prof.key_averages()
               if "FillFunctor" not in e.key and t(e)]
    if not kernels or any(e.count % iters for e in kernels):
        return None
    ms = sum(t(e) for e in kernels) / iters / 1e3
    if ms < bound:
        print(f"  device alone {ms:.4f} ms below the bound {bound:.4f} ms: "
              f"profile dropped", flush=True)
        return None
    return ms


def _report_turns(rows, label, fns, want, dev, iters, rounds, flush, bound,
                  probes=(), tol=1e-2, **extra):
    """Hold every candidate but ``probes`` against ``want``, time all in
    turn (events, and on a GPU the device alone), print and append rows."""
    errs = {}
    for n, fn in fns.items():
        got = fn()
        errs[n] = float((got.float() - want.float()).abs().max())
        if n in probes:
            continue
        if not got.dtype.is_floating_point:
            if not torch.equal(got, want):
                raise AssertionError(f"{label} {n}: not exact")
        else:
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
    times = _in_turn(fns, dev, iters, rounds, flush)
    alone = {n: [] for n in fns}
    if dev.type == "cuda":
        for _ in range(rounds):
            for n, fn in fns.items():
                alone[n].append(_device_alone(
                    fn, iters, flush, 0.0 if n in probes else bound))
    print(f"--- {label} (bound {bound:.4f} ms) ---")
    for n in fns:
        ms = float(np.median(times[n]))
        dv = [a for a in alone[n] if a is not None]
        da = float(np.median(dv)) if dv else None
        rows.append({"case": label, "variant": n, "ms": ms,
                     "rounds": times[n], "device_alone_ms": da,
                     "device_alone_rounds": alone[n], "bound_ms": bound,
                     "max_abs_err": errs[n], "probe": n in probes, **extra})
        dtxt = f", device alone {da:.4f} ms" if da is not None else ""
        print(f"  {n}: {ms:.4f} ms{dtxt} ({bound / (da or ms):.3f} of the "
              f"bound); max abs {errs[n]:.3g}", flush=True)


# the fused block's variant builds and probes
FUSED_VARIANTS = [{"LC_FUSED_BOX": 64}, {"LC_FUSED_STAGES": 3},
                  {"LC_FUSED_ROWS": 64, "LC_FUSED_STAGES": 4},
                  {"LC_FUSED_ROWS": 32, "LC_FUSED_STAGES": 8},
                  {"LC_FUSED_PROBE": 1}, {"LC_FUSED_PROBE": 2},
                  {"LC_FUSED_PROBE": 3}, {"LC_FUSED_PROBE": 4}]
# (label, B, D, H, Hkv, head dim or None for the norm -> matmul form, X)
FUSED_CASES = (("wqkv, ModelConfig", 8, 2048, 16, 4, 128, None),
               ("wqkv, Gemma-2-9B layer 0", 8, 3584, 16, 8, 256, None),
               ("w_gate_up, norm -> matmul", 8, 2048, 0, 0, None, 11264))


def _fused_label(v):
    from leetcuda_tpu_torch.gemm import fused_decode as fd

    if "LC_FUSED_PROBE" in v:
        return {1: "probe: no pass over x", 2: "probe: no products",
                3: "probe: no exchange",
                4: "probe: no feed"}[v["LC_FUSED_PROBE"]]
    if "LC_FUSED_BOX" in v:
        return f"panels of {2 * v['LC_FUSED_BOX']} columns"
    label = (f"{v.get('LC_FUSED_STAGES', fd.STAGES)} stages of "
             f"{v.get('LC_FUSED_ROWS', fd.STAGE_ROWS)} rows")
    return label


def bench_fused(dev, iters, rounds, flush):
    """The fused block's cluster sizes, variant builds and probes and
    torch.matmul alone in turn at FUSED_CASES (on the CPU the plain
    versions at a cut size). Returns the rows."""
    from leetcuda_tpu_torch.gemm import fused_decode as fd

    cuda = dev.type == "cuda"
    builds = _builds("fused_decode", FUSED_VARIANTS, _fused_label) \
        if cuda else []
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    rows = []
    for label, B, D, H, Hkv, Dh, X in FUSED_CASES:
        if not cuda:
            D, H, Hkv = D // 16, max(1, H // 4), max(1, Hkv // 4)
            X = X // 16 if X else None
        rope = Dh is not None
        X = (H + 2 * Hkv) * Dh if rope else X
        w = (torch.randn((D, X), generator=gen, device=dev)
             * D ** -0.5).to(bf)
        x = torch.randn((B, D), generator=gen, device=dev).to(bf)
        nw = (torch.randn(D, generator=gen, device=dev) * 0.2 + 1).to(bf)
        pos = torch.arange(B, dtype=torch.int32, device=dev) * 257
        kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=Dh)
        if rope:
            want = fd.fused_norm_qkv_rope_plain(x, nw, w, pos, **kw)
        else:
            want = fd.fused_norm_matmul_plain(x, nw, w)

        def launch(plan, lib="fused_decode"):
            if rope:
                return lambda: fd._launch_qkv(x, nw, w, pos, H, Hkv, Dh,
                                              1e-5, 1e4, False, plan, lib)
            return lambda: fd._launch_nm(x, nw, w, 1e-5, False, plan, lib)

        fns, probes = {}, set()
        if cuda:
            plan = fd.device_plan(B, D, X, rope, dev)
            fns[f"cluster {plan['cluster']} (plan: grid {plan['grid']}, "
                f"wave {plan['wave']})"] = launch(plan)
            for C in (1, 2, 4, 8):
                if C == plan["cluster"]:
                    continue
                try:
                    p = fd.fused_plan(B, D, X, cluster=C)
                except ValueError:
                    continue
                fns[f"cluster {C} (grid {p['grid']})"] = launch(p)
            for v, lib in builds:
                box = fd.build_info(lib)[0]
                if rope and Dh % (2 * box):
                    continue
                p = fd.device_plan(B, D, X, rope, dev, lib)
                name = (f"{_fused_label(v)}, cluster {p['cluster']} (grid "
                        f"{p['grid']}, wave {p['wave']})")
                fns[name] = launch(p, lib)
                if "LC_FUSED_PROBE" in v:
                    probes.add(name)
            fns["torch.matmul alone"] = lambda: torch.matmul(x, w)
            probes.add("torch.matmul alone")
        elif rope:
            fns["plain"] = lambda: fd.fused_norm_qkv_rope_plain(
                x, nw, w, pos, **kw)
        else:
            fns["plain"] = lambda: fd.fused_norm_matmul_plain(x, nw, w)
        nbytes = 2.0 * (B * D + D + D * X + B * X) + (4 * B if rope else 0)
        _report_turns(rows, label, fns, want, dev, iters, rounds, flush,
                      nbytes / 3.35e12 * 1e3, probes, B=B, D=D, X=X)
    return rows


RMS_VARIANTS = [{"LC_LN_MAX_CTAS": 6}, {"LC_LN_MAX_CTAS": 8}]


def bench_rms(dev, iters, rounds, flush, S=16384):
    """The rms-norm's rows route at each group and grid, its variant
    builds, the block route and F.rms_norm in turn at (S, K) for each K of
    LN_FWD_K in bf16, f32 and f16 (on the CPU the plain version at a cut
    size). Returns the rows."""
    import torch.nn.functional as F

    from leetcuda_tpu_torch.ops import layer_norm as ln
    from leetcuda_tpu_torch.ops import rms_norm as rms

    cuda = dev.type == "cuda"
    builds = _builds("row_ops", RMS_VARIANTS,
                     lambda v: f"up to {v['LC_LN_MAX_CTAS']} CTAs an SM") \
        if cuda else []
    shapes = [(S, K) for K in LN_FWD_K] if cuda else [(64, 256)]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for (S, K), dt in itertools.product(
            shapes, (torch.bfloat16, torch.float32, torch.float16)):
        x = torch.randn((S, K), generator=gen, device=dev).to(dt)
        w = (torch.randn(K, generator=gen, device=dev) * 0.3 + 1).to(dt)
        want = rms.rms_norm_plain(x, w)
        isz = x.element_size()
        plan = rms.rms_plan(S, K, isz)
        fns = {}
        if cuda:
            def rows_route(p, lib="row_ops"):
                return lambda: rms._run(x, w, torch.empty_like(x), 8, True,
                                        p, lib)

            def ctas(nv, cap=ln.FWD_MAX_CTAS):
                return ln.fwd_ctas(nv, isz, max_ctas=cap, weights=1)

            per_sm = ctas(plan["nv"])
            cands = [(plan["group"], n)
                     for n in dict.fromkeys((per_sm, 2, 3)) if n <= per_sm]
            cands += [(gr, ctas(-(-K // (8 * gr))))
                      for gr in ln.FWD_GROUPS
                      if gr != plan["group"] and gr * 16 >= K]
            for gr, n in cands:
                p = ln.ln_fwd_rows_plan(S, K, gr, n)
                tag = " (plan)" if p == plan else ""
                fns[f"rows, group {gr}, {p['nv']} vectors a thread, grid "
                    f"{p['grid']}{tag}"] = rows_route(p)
            for v, lib in builds:
                n = ctas(plan["nv"], v["LC_LN_MAX_CTAS"])
                p = ln.ln_fwd_rows_plan(S, K, plan["group"], n)
                fns[f"rows, group {p['group']}, grid {p['grid']}, up to "
                    f"{v['LC_LN_MAX_CTAS']} CTAs an SM"] = rows_route(p, lib)
            fns["block route"] = lambda: rms._run(
                x, w, torch.empty_like(x), 8, True, {"route": "block"})
            fns["F.rms_norm"] = lambda: F.rms_norm(x, (K,), w, eps=rms.EPS)
        else:
            fns["plain"] = lambda: rms.rms_norm_plain(x, w)
        tol = 1e-3 if dt == torch.float32 else 1e-2
        _report_turns(rows, f"rms_norm {str(dt)[6:]} ({S}, {K}); plan "
                      f"{plan}", fns, want, dev, iters, rounds, flush,
                      2.0 * S * K * isz / 3.35e12 * 1e3, tol=tol,
                      dtype=str(dt)[6:], S=S, K=K)
    return rows


def before_lib(root, name):
    """``csrc/<name>.cu`` of the checkout at ``root`` (an earlier commit of
    the repository) built with the package's flags and loaded, for the
    "before" of an A/B: (library, ptxas report)."""
    import ctypes
    import hashlib
    import subprocess
    from pathlib import Path

    from leetcuda_tpu_torch.build import BUILD_DIR, NVCC_FLAGS, _nvcc

    src = Path(root) / "leetcuda_tpu_torch" / "csrc" / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"before-{name}-{tag}.so"
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out),
                               str(src)], capture_output=True, text=True)
        log = done.stdout + done.stderr
        if done.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    return ctypes.CDLL(str(out)), log


def sass_counts(lib_path, tags):
    """{tag: instruction counts} of the first kernel of a build whose name
    holds each tag (cuobjdump -sass): every instruction, loads by width,
    dp4a (IDP), fp8 converts (F2FP) and float adds."""
    import re
    import subprocess
    from collections import Counter
    from pathlib import Path

    from leetcuda_tpu_torch.build import _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    parts = sass.split("Function : ")[1:]
    res = {}
    for tag in tags:
        part = next((p for p in parts if tag in p.split("\n", 1)[0]), None)
        if part is None:
            res[tag] = None
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", part)
        c = Counter(o.split(".")[0] for o in ops)
        res[tag] = {"instructions": len(ops),
                    "LDG": {w: sum(o.startswith("LDG") and w in o
                                   for o in ops)
                            for w in (".U8", ".S8", ".U16", ".128", ".64")},
                    "LDG_all": c["LDG"], "IDP": c["IDP"], "F2FP": c["F2FP"],
                    "HADD2": c["HADD2"], "FADD": c["FADD"],
                    "BRA": c["BRA"]}
    return res


# the int8 matmul's variant builds and probe; its cases (label, M, K, N)
I8_VARIANTS = [{"LC_I8_BN": 128, "LC_I8_STAGES": 6}, {"LC_I8_STAGES": 3},
               {"LC_I8_CLUSTER": 1}, {"LC_I8_PROBE": 1}]
I8_CASES = (("8192^3", 8192, 8192, 8192),
            ("w_gate_up pack, 16384 rows", 16384, 2048, 11264),
            ("2048^2, 1000 rows", 1000, 2048, 2048),
            ("2048^2, 128 rows", 128, 2048, 2048),
            ("2048^2, 16 rows", 16, 2048, 2048))


def _i8_label(v):
    return ", ".join(f"{k[6:].lower()} {x}" for k, x in sorted(v.items()))


def bench_i8(dev, iters, rounds, flush, before=None):
    """The int8 matmul's builds, group, passes, the earlier kernel and
    torch._int_mm in turn at I8_CASES (on the CPU the plain version at a
    cut size). Returns the rows."""
    import ctypes

    from leetcuda_tpu_torch.build import kernel
    from leetcuda_tpu_torch.gemm import quant as gq

    cuda = dev.type == "cuda"
    builds = _builds("i8_matmul", I8_VARIANTS, _i8_label) if cuda else []
    old = None
    if cuda and before:
        old, log = before_lib(before, "i8_matmul")
        fn = old.lc_i8_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        print(f"  built before: {log.count('registers')} ptxas entries")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for label, M, K, N in (I8_CASES if cuda else (("cut", 64, 48, 32),)):
        x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        want = gq.matmul_i8i8i32_plain(x, w)
        fns, probes, extra = {}, [], {}
        if cuda:
            plan = gq.i8_plan(M, N, K)
            fns[f"package ({plan['grid']} CTAs, group {plan['group']})"] = (
                lambda: gq.matmul_i8i8i32(x, w))
            fns["package, group 0" if plan["group"] else "package, group 8"] \
                = lambda g=8 - plan["group"]: gq._launch_i8(x, w, group=g)
            wt = w.t().contiguous()
            stream = torch.cuda.current_stream(dev).cuda_stream
            out = torch.empty((M, N), dtype=torch.int32, device=dev)
            tile, ctas = gq.i8_build_info(dev)
            pl = gq.i8_plan(M, N, K, ctas, **tile)
            product = kernel("i8_matmul", "lc_i8_matmul", gq._I8_ARGS)

            def product_alone():
                gq.check_launch(product(
                    x.data_ptr(), wt.data_ptr(), out.data_ptr(), M, N, K,
                    pl["group"], pl["grid"], stream), "product")
                return out
            fns["product alone (w^T made before)"] = product_alone
            for v, lib in builds:
                name = _i8_label(v)
                fns[name] = lambda lib=lib: gq._launch_i8(x, w, lib)
                if v.get("LC_I8_PROBE"):
                    probes.append(name)
            if old is not None:
                def run_old():
                    o = torch.empty((M, N), dtype=torch.int32, device=dev)
                    gq.check_launch(old.lc_i8_matmul(
                        x.data_ptr(), w.data_ptr(), o.data_ptr(), M, N, K,
                        stream), "before")
                    return o
                fns["before (mma.sync, 128 x 128 x 64)"] = run_old
            try:
                torch._int_mm(x, w)
                fns["torch._int_mm"] = lambda: torch._int_mm(x, w)
            except RuntimeError as e:
                extra["int_mm_refused"] = str(e).splitlines()[0]
            wc = w.t().contiguous().t()
            try:
                torch._int_mm(x, wc)
                fns["torch._int_mm, w column-major"] = (
                    lambda: torch._int_mm(x, wc))
            except RuntimeError as e:
                extra["int_mm_cm_refused"] = str(e).splitlines()[0]
            tt = torch.empty(K * N, dtype=torch.int8, device=dev)
            transpose = kernel("i8_matmul", "lc_i8_transpose",
                               gq._I8_T_ARGS)
            extra["transpose_ms"] = float(np.median(_in_turn(
                {"t": lambda: transpose(w.data_ptr(), tt.data_ptr(), K, N,
                                        stream)},
                dev, iters, rounds, flush)["t"]))
            extra["transpose_bound_ms"] = 2.0 * K * N / 3.35e12 * 1e3
            if not torch.equal(tt.view(N, K), wt):
                raise AssertionError(f"{label}: the transpose pass is wrong")
            extra["plan"] = plan
        else:
            fns["plain"] = lambda: gq.matmul_i8i8i32_plain(x, w)
        _report_turns(rows, f"i8 matmul {label} (M {M}, K {K}, N {N})",
                      fns, want, dev, iters, rounds, flush,
                      2.0 * M * N * K / 1979e12 * 1e3, probes=probes,
                      M=M, K=K, N=N, **extra)
        if "transpose_ms" in extra:
            print(f"  transpose pass alone {extra['transpose_ms']:.4f} ms "
                  f"(bound {extra['transpose_bound_ms']:.4f} ms)")
    return rows


# the reductions' variant builds and probe
REDUCE_VARIANTS = [{"LC_REDUCE_CTAS_PER_SM": 2}, {"LC_REDUCE_CTAS_PER_SM": 8},
                   {"LC_REDUCE_INFLIGHT": 1}, {"LC_REDUCE_INFLIGHT": 4},
                   {"LC_REDUCE_LAUNCHES": 2}, {"LC_REDUCE_CS": 0},
                   {"LC_REDUCE_PROBE": 1}]


def _reduce_label(v):
    return ", ".join(f"{k[10:].lower()} {x}" for k, x in sorted(v.items()))


def bench_reduce(dev, iters, rounds, flush, before=None, S=16384, K=2048):
    """The reductions' builds, the earlier kernel and the library call in
    turn at (S, K) for the registered sum rungs, the default rung in f32,
    int8 and e4m3, the f32 max and the f32 dot rungs (on the CPU the plain
    versions at a cut size); then the SASS of the int8 and e4m3 kernels.
    Returns the rows."""
    import ctypes

    from leetcuda_tpu_torch.ops import dot_product as dp
    from leetcuda_tpu_torch.ops import flat
    from leetcuda_tpu_torch.ops import reduce as rd

    cuda = dev.type == "cuda"
    builds = _builds("reduce", REDUCE_VARIANTS, _reduce_label) if cuda \
        else []
    old = None
    if cuda and before:
        old, _ = before_lib(before, "reduce")
        old.lc_reduce.restype = ctypes.c_int
        old.lc_reduce.argtypes = list(rd.ARGS[:10]) + [ctypes.c_void_p]
    if not cuda:
        S, K = 64, 96
    gen = torch.Generator(device=dev).manual_seed(0)
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    cases = []  # (label, op, x dtype, acc dtype, vec, pack, tol)
    for name, spec in OPS.items():
        if spec.family == "reduce":
            edt = spec.fn.acc_dtype
            xdt = {"f32": torch.float32, "f16": torch.float16,
                   "bf16": torch.bfloat16, "i8": torch.int8,
                   "fp8_e4m3": e4, "fp8_e5m2": e5}[
                next(t for t in ("fp8_e4m3", "fp8_e5m2", "bf16", "f16",
                                 "f32", "i8") if spec.tags[0].startswith(t))]
            cases.append((name, rd.SUM, xdt, edt, spec.fn.vec,
                          spec.fn.pack, spec.atol))
        elif (spec.family == "dot-product"
              and name.startswith("dot_prod_f32")):
            cases.append((name, rd.DOT, torch.float32, torch.float32,
                          spec.fn.vec, spec.fn.pack, spec.atol))
    cases += [(f"sum, 16-byte rung, {t}", rd.SUM, d, a, None, True, tol)
              for t, d, a, tol in (("f32", torch.float32, torch.float32, 1e-3),
                                   ("int8", torch.int8, torch.int32, 0),
                                   ("e4m3", e4, torch.float16, 16.0))]
    cases.append(("max f32", rd.MAX, torch.float32, torch.float32, None,
                  True, 0.0))
    rows = []
    for label, op, xdt, adt, vec, pack, tol in cases:
        if xdt == torch.int8:
            x = torch.randint(-128, 128, (S, K), generator=gen, device=dev,
                              dtype=torch.int8)
        else:
            x = torch.randn((S, K), generator=gen, device=dev).to(xdt)
        y = torch.randn((S, K), generator=gen, device=dev) if op == rd.DOT \
            else None
        counter = {rd.SUM: rd.REDUCE_SUM, rd.MAX: rd.REDUCE_MAX,
                   rd.DOT: dp.DOT_PRODUCT}[op]
        dtypes = rd.SUM_INPUTS if op == rd.SUM else flat.FLOATS
        if op == rd.SUM:
            want = rd.sum_plain(x, adt)
        elif op == rd.MAX:
            want = rd.max_plain(x, adt)
        else:
            want = (x.double() * y.double()).sum().float()
        fns, probes = {}, []
        if cuda:
            def call(lib="reduce"):
                return rd.launch_reduce(counter, x, y, op, adt, vec, pack,
                                        dtypes, lib)
            fns["package"] = call
            for v, lib in builds:
                name = _reduce_label(v)
                fns[name] = lambda lib=lib: call(lib)
                if v.get("LC_REDUCE_PROBE"):
                    probes.append(name)
            if old is not None:
                parts = torch.empty(1024, dtype=torch.int32, device=dev)
                v_, lb = flat.rung_bytes(vec, pack, x.element_size())

                def run_old():
                    o = torch.empty((), dtype=adt, device=dev)
                    err = old.lc_reduce(
                        x.data_ptr(), (x if y is None else y).data_ptr(),
                        x.numel(), flat.DTYPES[x.dtype], op, v_, lb,
                        parts.data_ptr(), o.data_ptr(), flat.DTYPES[adt],
                        torch.cuda.current_stream(dev).cuda_stream)
                    if err:
                        raise RuntimeError(f"before: CUDA error {err}")
                    return o
                fns["before (two passes)"] = run_old
            if op == rd.SUM:
                fns["library"] = (
                    (lambda: x.to(torch.float16).sum()) if x.element_size()
                    == 1 and xdt != torch.int8 else
                    (lambda: torch.sum(x, dtype=adt)))
            elif op == rd.MAX:
                fns["library"] = lambda: torch.amax(x)
            else:
                fns["library"] = lambda: torch.dot(x.reshape(-1),
                                                   y.reshape(-1))
        else:
            fns["plain"] = lambda: want
        nbytes = x.numel() * x.element_size() * (2 if y is not None else 1)
        # the library's fp8 sum accumulates in f16: timed, not held
        _report_turns(rows, f"{label} ({S}, {K})", fns, want, dev, iters,
                      rounds, flush, nbytes / 3.35e12 * 1e3,
                      probes=probes + (["library"] if cuda and xdt in (e4, e5)
                                       else []),
                      tol=tol, op=op, S=S, K=K,
                      plan=rd.reduce_plan(x.numel(), x.element_size(),
                                          *flat.rung_bytes(
                                              vec, pack, x.element_size())))
    if cuda:
        from leetcuda_tpu_torch.build import _lib_path
        tags = ("reduce_flatILi3ELi0ELi1ELi1E", "reduce_flatILi3ELi0ELi16E",
                "reduce_flatILi4ELi0ELi1ELi1E", "reduce_flatILi4ELi0ELi16E",
                "reduce_flatILi0ELi0ELi1ELi4E")
        sass = {"package": sass_counts(_lib_path("reduce"), tags)}
        if old is not None:
            sass["before"] = sass_counts(old._name, tuple(
                t.replace("reduce_flat", "pass1") for t in tags))
        for k, v in sass.items():
            for tag, c in v.items():
                print(f"  SASS {k} {tag}: {c}")
        rows.append({"case": "sass", **sass})
    return rows


def _write_rows(path, dev, rows):
    import json
    from pathlib import Path

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(
        {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else str(dev)), "rows": rows}, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mnk", type=int, nargs="*", default=None,
                    help="square sizes (default: 2048 4096 8192)")
    ap.add_argument("--m", type=int, nargs="*", default=None,
                    help="non-square: M values, zipped with --n / --k (a "
                         "single value broadcasts)")
    ap.add_argument("--n", type=int, nargs="*", default=None)
    ap.add_argument("--k", type=int, nargs="*", default=None)
    ap.add_argument("--variants", nargs="*", default=None,
                    help="registered gemm op names, or 'auto' (default: the "
                         "f16 ladder)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--check", action="store_true",
                    help="hold each variant against the plain version")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--resident", action="store_true",
                    help="the A/B of the resident chain's builds at the "
                         "chains --mnk x --reps")
    ap.add_argument("--reps", type=int, nargs="*", default=None,
                    help="--resident: reps of each --mnk chain (default 5 "
                         "and 3 for 4096 and 128)")
    ap.add_argument("--w4", action="store_true",
                    help="the A/B of the w4a16 kernel's builds and routes at "
                         "--w4-kn x --m")
    ap.add_argument("--w4-kn", type=int, nargs=2, action="append",
                    default=None, metavar=("K", "N"),
                    help="--w4: a weight shape (repeatable; default path "
                         "(c)'s four)")
    ap.add_argument("--w8", action="store_true",
                    help="the A/B of the w8a16 kernel's builds and routes at "
                         "--w8-kn x --m, fp8 and int8")
    ap.add_argument("--w8-kn", type=int, nargs=2, action="append",
                    default=None, metavar=("K", "N"),
                    help="--w8: a weight shape (repeatable; default paths "
                         "(a) and (b)'s four)")
    ap.add_argument("--hgemm", action="store_true",
                    help="the A/B of the tensor-core tiles, groups and "
                         "variant builds at path (j)'s shapes (or --m / "
                         "--n / --k)")
    ap.add_argument("--gmm", action="store_true",
                    help="the A/B of the grouped matmul's tiles, walks and "
                         "routes at path (n)'s four products")
    ap.add_argument("--ln-bwd", action="store_true",
                    help="the A/B of the layer-norm backward's grid and "
                         "routes at (16384, 2048)")
    ap.add_argument("--softmax", action="store_true",
                    help="the A/B of the row softmax's cluster sizes, slices "
                         "and routes at (2048, 32000) and (8, 32000) f32")
    ap.add_argument("--ln-fwd", action="store_true",
                    help="the A/B of the layer-norm forward's groups, grid "
                         "and routes at (16384, 2048) and (16384, 4096)")
    ap.add_argument("--map", action="store_true",
                    help="the A/B of the elementwise map's loads a step "
                         "and math at the model's swish, gelu and add")
    ap.add_argument("--gemv", action="store_true",
                    help="the A/B of the gemv's feeds, batches, k_lanes and "
                         "cluster sizes at path (j)'s decode-row shapes")
    ap.add_argument("--fused", action="store_true",
                    help="the A/B of the fused decode block's cluster "
                         "sizes, panels, stages and probes at ModelConfig's "
                         "and Gemma-2-9B's wqkv and at w_gate_up")
    ap.add_argument("--rms", action="store_true",
                    help="the A/B of the rms-norm's groups, grid and routes "
                         "at (16384, 2048) and (16384, 4096)")
    ap.add_argument("--i8", action="store_true",
                    help="the A/B of the int8 matmul's builds, passes and "
                         "group at 8192^3, the w_gate_up pack and small M")
    ap.add_argument("--reduce", action="store_true",
                    help="the A/B of the reductions' builds, grid, loads in "
                         "flight and launches at (16384, 2048)")
    ap.add_argument("--before", default=None, metavar="DIR",
                    help="--i8, --reduce: also time the kernel of the "
                         "checkout at DIR (an earlier commit)")
    ap.add_argument("--json", help="--resident, --w4, --w8, --hgemm, --gmm, "
                                   "--ln-bwd, --ln-fwd, --map, --softmax, "
                                   "--gemv, --fused, --rms, --i8, --reduce: "
                                   "write the rows here")
    args = ap.parse_args(argv)

    load_all()
    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    if args.m or args.n or args.k:
        ms, ns, ks = args.m or [4096], args.n or [4096], args.k or [4096]
        L = max(len(ms), len(ns), len(ks))
        shapes = list(zip(*(v * L if len(v) == 1 else v
                            for v in (ms, ns, ks))))
    else:
        shapes = [(n, n, n) for n in (args.mnk or [2048, 4096, 8192])]
    variants = args.variants or [
        n for n, s in OPS.items() if s.family == "gemm" and "f16" in s.tags]
    flush = None
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)
        print(f"device {torch.cuda.get_device_name(dev)}, {args.dtype}")
    else:
        print(f"device {dev} (host clock: a check of the CLI, no device "
              f"metric), {args.dtype}")
    rows = None
    if args.gmm:
        rows = bench_gmm(dev, args.iters, args.repeats, flush)
    elif args.ln_bwd:
        rows = bench_ln_bwd(dev, args.iters, args.repeats, flush)
    elif args.ln_fwd:
        rows = bench_ln_fwd(dev, args.iters, args.repeats, flush)
    elif args.map:
        rows = bench_map(dev, args.iters, args.repeats, flush)
    elif args.softmax:
        rows = bench_softmax(dev, args.iters, args.repeats, flush)
    elif args.gemv:
        rows = bench_gemv(dev, args.iters, args.repeats, flush)
    elif args.fused:
        rows = bench_fused(dev, args.iters, args.repeats, flush)
    elif args.rms:
        rows = bench_rms(dev, args.iters, args.repeats, flush)
    elif args.i8:
        rows = bench_i8(dev, args.iters, args.repeats, flush, args.before)
    elif args.reduce:
        rows = bench_reduce(dev, args.iters, args.repeats, flush,
                            args.before)
    elif args.w4:
        rows = bench_w4(args.w4_kn or W4_KN, args.m or W4_ROWS, dev,
                        args.iters, args.repeats, flush)
    elif args.w8:
        rows = bench_w8(args.w8_kn or W8_KN, args.m or W8_ROWS, dev,
                        args.iters, args.repeats, flush)
    elif args.hgemm:
        hshapes = (shapes if args.m or args.n or args.k or args.mnk
                   else HGEMM_MNK)
        rows = bench_hgemm(hshapes, dtype, dev, args.iters, args.repeats,
                           flush)
    elif args.resident:
        ns, reps = args.mnk or [4096, 128], args.reps or [5, 3]
        if len(reps) == 1:
            reps = reps * len(ns)
        rows = bench_resident(list(zip(ns, reps)), dev, args.iters,
                              args.repeats, flush)
    if rows is not None:
        if args.json:
            _write_rows(args.json, dev, rows)
        return
    for M, N, K in shapes:
        print(f"--- M={M} N={N} K={K} ---", flush=True)
        bench_size(M, N, K, variants, dtype, dev, args.iters, args.repeats,
                   args.check, flush)


if __name__ == "__main__":
    main()
