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

On a GPU each time is the median over ``--iters`` launches of CUDA-event
times, with the 50 MB L2 flushed by a 256 MB write before each launch (as
``chip_smoke.py`` times its kernels); ``--repeats`` > 1 reports the median,
best and spread of the repeats. ``--device cpu`` runs the plain versions on
the host clock, a check of the CLI and not a device measurement. f32 runs
with TF32 off, so ``torch.matmul`` is the f32 product too.
"""

from __future__ import annotations

import argparse
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
    ap.add_argument("--json", help="--resident, --w4, --w8, --hgemm, --gmm, "
                                   "--ln-bwd: write the rows here")
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
