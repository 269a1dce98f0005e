"""Attention benchmark CLI: the A/B of the flash kernels' builds.

    python -m leetcuda_tpu_torch.bench.attn_bench --bwd --json bwd_bench.json
    python -m leetcuda_tpu_torch.bench.attn_bench --fwd --json fwd_bench.json
    python -m leetcuda_tpu_torch.bench.attn_bench --chunk --json chunk.json
    python -m leetcuda_tpu_torch.bench.attn_bench --bwd-f64 --shared-draw \
        --json bwd_f64.json

``--fwd`` builds ``csrc/flash_fwd.cu`` once per variant of ``FWD_VARIANTS``
(its ``LC_FWD_*`` macros: the next tile's S issued behind P V or not, the
key tile, the stage count; three probes that compute nothing right:
without the exp, without the products, without the products and the
softmax) and times each variant's forward in turn with
SDPA (``is_causal``, no cap) at the cases the variant changes: (1, 16,
2048, 128) with 4 KV heads, causal, the serving shape; (8, 16, 2048, 128)
with its lse, training's; (1, 32, 8192, 128) with 16 KV heads, causal, cap
50 (Gemma-2-27B's); (1, 16, 8192, 256) with 8 KV heads, causal, cap 50
(head dim 256). Each is held against ``flash_attention_plain`` (atol and
rtol 1e-2, q at 10x with the cap, as chip_smoke.py draws it).

``--bwd`` builds ``csrc/flash_bwd.cu`` once per variant of ``BWD_VARIANTS``
(``build.build_variants``: its ``LC_BWD_*`` macros set with -D, each build a
library of its own that the package never loads) and times each variant's
whole backward (the dQ launch, which also forms delta, then the dK/dV
launch), its dQ and its dK/dV launch, in turn with SDPA's backward, at the
cases that the variant changes: (8, 16, 2048, 128) with 4 KV heads,
causal, training's shape, for the stage count and the key and q tiles;
(1, 8, 8192, 256), causal, Gemma-2-2B's, for dQ's warpgroups; every case
(the cap of 50 too) for the default and the probes. The probes
(LC_BWD_PROBE) compute nothing right: 1 leaves out the exp and the cap's
tanh, 2 every product, 3 a tile's first two (S and dP, S^T and dP^T).
Every other variant is held against ``flash_attention_bwd_plain``
(relative L2 <= 1e-2); at the cap case also at cap 2 over unit q, where the
kernel run uncapped or at cap / log2(e) must miss that bar (chip_smoke.py's
BWD_CAP controls).

``--chunk`` times the chunk attention's two routes (attention/chunk.py):
first route A (split-KV, ``csrc/chunk_attn.cu``) and route B (TMA +
wgmma, ``csrc/chunk_tma.cu``) in turn over T in ``--chunk-t`` (4, 8, 16,
32, 64, 128) and G in ``--chunk-g`` (2, 4, 8) at B=8, 4 KV heads of 128
and a cache of ``--chunk-s`` (2048) positions, bf16 and int8
(``--chunk-fmt``), bases spread from 0 to the capacity: the A/B that sets
``TMA_MIN_ROWS``, the crossover in rows a KV head (G * T). Then route A's
split length (64, 128, 256, 512 keys) and its stage bound
(``LC_CHUNK_SPLIT_STAGES`` 2, 3, 4 beside the default build) at verify
(G=4, T=4), and route B's keys and stages
(``LC_CHUNK_KEYS`` 64, ``LC_CHUNK_STAGES`` 3 beside the default) at
Gemma-2-27B's chunk (B=2, 32 heads over 16, T=512, cap 50, window 4096,
bases 3700 / 5000, pages of 128) and at an admission of T=256 (B=1, 16
over 4 heads, base 1024). Each route and build is held against
``chunk_attention_plain`` (KERNEL_TOL, 1e-2). Last, the wrappers at the
main paths' shapes (ModelConfig's verify, GPT-OSS's with the lse, Gemma's
chunk) timed three ways: one call after an L2 flush, as chip_smoke.py
times kernels; 200 calls back to back (the host's enqueue where that is
the longer); and the device alone, 50 calls replayed from one CUDA graph.

``--bwd-f64`` measures how far the backward kernels and
``flash_attention_bwd_plain`` each lie from the exact gradient, at
training's causal shape (8, 16, 2048, 128) with 4 KV heads, over the draws
of ``--seeds`` (numpy generators drawing q, k, v and dO as chip_smoke.py's
Recorder draws them; ``out`` and ``lse`` from the kernel forward, which
both backward versions take). The references, per (b, h): the f64
backward of the same inputs (``bwd_f64``), and the same f64 backward with
P and dS rounded to bf16 before the second products, as both versions
round them (``bwd_f64`` with ``rounded``). For dQ, dK and dV it prints the largest
error of each pair and its ratio to chip_smoke.py's elementwise bar
(KERNEL_TOL: atol + rtol |reference|, both 1e-2; a ratio above 1 fails),
with where the worst one falls. ``--shared-draw`` adds the draw of a
phase 3 in which the fused block's extra cases drew from the shared
generator (chip_smoke.py before FUSED_SEED, where dK once missed the
bar): it replays phase 3's checks up to the backward on the full-width
model with the timings left out.

Each build's ptxas registers and spills are printed. On a GPU each time
is the median over ``--rounds`` rounds of the median of
``--iters`` CUDA-event times with the 50 MB L2 flushed before each launch.
``--device cpu`` runs the plain versions on the host clock, a check of the
CLI and not a device measurement.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from leetcuda_tpu_torch.attention import flash as fl
from leetcuda_tpu_torch.attention import flash_bwd as fb

# The variant builds: the package's default, then one change each.
BWD_VARIANTS = [
    {},
    {"LC_BWD_DQ_KEYS": 64},
    {"LC_BWD_DQ_KEYS": 64, "LC_BWD_STAGES": 3},
    {"LC_BWD_DKV_ROWS": 32},
    {"LC_BWD_D256_DQ_CONS": 2},
    {"LC_BWD_PROBE": 1},
    {"LC_BWD_PROBE": 2},
    {"LC_BWD_PROBE": 3},
]
_D128_KEYS = ("LC_BWD_STAGES", "LC_BWD_DQ_KEYS", "LC_BWD_DKV_ROWS")
_D256_KEYS = ("LC_BWD_D256_DQ_CONS",)

# (label, (B, H, Hkv, N, D), softcap)
CASES = {"d128": ("(8, 16, 2048, 128) causal", (8, 16, 4, 2048, 128), None),
         "d256": ("(1, 8, 8192, 256) causal", (1, 8, 4, 8192, 256), None),
         "cap": ("(8, 16, 2048, 128) causal, cap 50", (8, 16, 4, 2048, 128),
                 50.0)}


# The forward's variant builds: the package's default, then one change each.
FWD_VARIANTS = [
    {},
    {"LC_FWD_OVERLAP": 0},
    {"LC_FWD_KEYS": 64},
    {"LC_FWD_STAGES": 3},
    {"LC_FWD_PROBE": 1},
    {"LC_FWD_PROBE": 2},
    {"LC_FWD_PROBE": 3},
]
_FWD_D128_KEYS = ("LC_FWD_KEYS", "LC_FWD_STAGES")

# --fwd-cases: run only these forward cases (all when empty)
CASE_FILTER: list = []

# (label, (B, H, Hkv, N, D), softcap, with_lse)
FWD_CASES = {
    "d128": ("(1, 16, 2048, 128) causal", (1, 16, 4, 2048, 128), None, False),
    "lse": ("(8, 16, 2048, 128) causal, lse", (8, 16, 4, 2048, 128), None,
            True),
    "gemma": ("(1, 32, 8192, 128) causal, cap 50", (1, 32, 16, 8192, 128),
              50.0, False),
    "d256": ("(1, 16, 8192, 256) causal, cap 50", (1, 16, 8, 8192, 256),
             50.0, False)}


def fwd_variant_plan(v, D):
    """(warpgroups, keys, stages) of the forward's variant build ``v`` at
    head dim ``D`` (csrc/flash_fwd.cu fwd_plan with the macros of ``v``)."""
    if D > 128:
        return (2, 64, 2)
    return (2, v.get("LC_FWD_KEYS") or 128,
            v.get("LC_FWD_STAGES") or (2 if D > 64 else 3))


def fwd_variant_cases(v):
    """The cases where the forward's variant ``v`` differs from the default."""
    if CASE_FILTER:
        return [k for k in CASE_FILTER if k in FWD_CASES]
    if any(k in v for k in _FWD_D128_KEYS):
        return [k for k, c in FWD_CASES.items() if c[1][4] <= 128]
    return list(FWD_CASES)


def _fwd_label(v):
    return "default" if not v else ", ".join(
        f"{k[7:].lower()} {x}" for k, x in sorted(v.items()))


def bench_fwd(dev, iters, rounds, flush):
    """Each forward variant build at each case it changes, in turn with
    SDPA (the plain forward on the CPU). Returns the rows."""
    builds = []
    if dev.type == "cuda":
        from leetcuda_tpu_torch.build import build_variants

        for v, (lib, log) in zip(FWD_VARIANTS,
                                 build_variants("flash_fwd", FWD_VARIANTS)):
            print(f"  built {_fwd_label(v)}: "
                  f"{ptxas_summary(log) if log else 'cached'}", flush=True)
            builds.append((v, lib))
    rows = []
    for key, (label, shape, cap, with_lse) in FWD_CASES.items():
        if CASE_FILTER and key not in CASE_FILTER:
            continue
        B, H, Hkv, N, D = shape
        gen = torch.Generator(device=dev).manual_seed(0)

        def rnd(*s, scale=1.0):
            return (torch.randn(s, generator=gen, device=dev)
                    * scale).to(torch.bfloat16)

        q = rnd(B, H, N, D, scale=10.0 if cap else 1.0)
        k, v = rnd(B, Hkv, N, D), rnd(B, Hkv, N, D)
        scale = D ** -0.5
        want = fl.flash_attention_plain(q, k, v, causal=True, softcap=cap,
                                        with_lse=with_lse)
        want = want[0] if with_lse else want
        fns = []
        for vb, lib in builds:
            if key not in fwd_variant_cases(vb):
                continue

            def run(lib=lib):
                return fl._launch(q, k, v, None, True, scale, fl.FLASH,
                                  with_lse, 0, cap or 0.0, lib)
            got = run()
            got = got[0] if with_lse else got
            err = float((got.float() - want.float()).abs().max())
            if "LC_FWD_PROBE" not in vb and not torch.allclose(
                    got.float(), want.float(), atol=1e-2,
                    rtol=1e-2):  # chip_smoke.py's KERNEL_TOL
                raise AssertionError(f"{_fwd_label(vb)} at {label}: max abs "
                                     f"{err}")
            fns.append((_fwd_label(vb), err, run, vb))
        if dev.type == "cuda":
            fns.append(("SDPA, causal, no cap", 0.0, lambda: sdpa_fwd(
                q, k, v), None))
        else:  # the plain forward: a check of the CLI
            fns.append(("plain forward", 0.0, lambda: fl.flash_attention_plain(
                q, k, v, causal=True, softcap=cap, with_lse=with_lse), None))
        times = {n: [] for n, *_ in fns}
        for _ in range(rounds):
            for n, _, fn, _ in fns:
                times[n].append(time_ms(fn, dev, iters, flush))
        flops = 4.0 * B * H * D * N * (N + 1) / 2  # the causal band, 2 products
        bound = flops / 989e12 * 1e3
        print(f"--- forward {label} (bound {bound:.4f} ms at 989 TFLOP/s) ---")
        for n, err, _, vb in fns:
            ms = float(np.median(times[n]))
            row = {"case": key, "shape": list(shape), "softcap": cap,
                   "with_lse": with_lse, "variant": n, "macros": vb,
                   "max_abs_err": err, "ms": ms, "rounds": times[n]}
            if vb is not None:
                row["plan"] = fl.fwd_plan(D, B, H, N,
                                          fwd_variant_plan(vb, D))
            share = ""
            if dev.type == "cuda" and "PROBE" not in str(vb):
                row["share"] = bound / ms
                share = f" ({bound / ms:.3f} of the bound)"
            rows.append(row)
            print(f"  {n}: {ms:.4f} ms{share}; max abs {err:.3g}", flush=True)
        del q, k, v, want, fns
    return rows


def sdpa_fwd(q, k, v):
    """SDPA's forward, causal, with GQA: the library yardstick."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)


def variant_plan(v, D):
    """(dq plan, dkv plan) of the variant build ``v`` at head dim ``D``, as
    ``flash_bwd.bwd_plan`` takes them (csrc/flash_bwd.cu dq_plan /
    dkv_plan with the macros of ``v``)."""
    if D > 128:
        cons = v.get("LC_BWD_D256_DQ_CONS", 1)
        return (cons, 64 // cons, 2), (2, 64, 2, True)
    stages = v.get("LC_BWD_STAGES") or (2 if D > 64 else 3)
    return ((2, v.get("LC_BWD_DQ_KEYS", 128), stages),
            (2, v.get("LC_BWD_DKV_ROWS") or 64, stages, False))


def variant_label(v):
    if not v:
        return "default"
    return ", ".join(f"{k[7:].lower()} {x}" for k, x in sorted(v.items()))


def variant_cases(v):
    """The cases where variant ``v`` differs from the default build."""
    if not v:
        return list(CASES)
    if any(k in v for k in _D128_KEYS):
        return ["d128"]
    if any(k in v for k in _D256_KEYS):
        return ["d256"]
    return ["d128", "d256"]  # the probes


def ptxas_summary(log):
    """The most registers, spill stores and spill loads of any entry in a
    ``-Xptxas -v`` report."""
    import re

    def most(pattern):
        return max((int(x) for x in re.findall(pattern, log)), default=0)

    return {"registers": most(r"Used (\d+) registers"),
            "spill_stores": most(r"(\d+) bytes spill stores"),
            "spill_loads": most(r"(\d+) bytes spill loads"),
            "wgmma_serialized": len(re.findall(r"serialized", log))}


def time_ms(fn, dev, iters, flush):
    """Median per-call milliseconds: CUDA events with the L2 flushed before
    each launch on a GPU, the host clock on the CPU."""
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


def rel_l2(got, want):
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


def _inputs(shape, cap, dev, q_scale=1.0):
    B, H, Hkv, N, D = shape
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)

    q = (rnd(B, H, N, D).float() * q_scale).to(torch.bfloat16)
    k, v = rnd(B, Hkv, N, D), rnd(B, Hkv, N, D)
    out, lse = fl.flash_attention_plain(q, k, v, causal=True, with_lse=True,
                                        softcap=cap)
    return q, k, v, out.to(torch.bfloat16).contiguous(), lse, rnd(B, H, N, D)


def _whole(lib, q, k, v, out, lse, do, scale, cap):
    dq, rows = fb._launch_dq(q, k, v, out, do, lse, None, True, scale, 0,
                             cap or 0.0, lib)
    return (dq, *fb._launch_dkv(q, k, v, do, rows, True, scale, 0,
                                cap or 0.0, lib))


def cap_controls(lib, dev):
    """The tanh variant at cap 2 over unit q (chip_smoke.py's BWD_CAP case):
    its relative L2 errors, and those of the kernel run uncapped and at cap
    / log2(e), which must miss 1e-2."""
    shape, cap = (2, 8, 4, 1024, 128), 2.0
    q, k, v, out, lse, do = _inputs(shape, cap, dev)
    scale = shape[-1] ** -0.5
    want = fb.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                        sm_scale=scale, softcap=cap)
    res = {}
    for label, c in (("cap 2", cap), ("uncapped", 0.0),
                     ("log2 domain", cap / math.log2(math.e))):
        got = _whole(lib, q, k, v, out, lse, do, scale, c)
        res[label] = max(rel_l2(g, w) for g, w in zip(got, want))
    return res


KERNEL_BAR = dict(atol=1e-2, rtol=1e-2)  # chip_smoke.py's KERNEL_TOL
F64_SHAPE = (8, 16, 4, 2048, 128)  # training's (B, H, Hkv, N, D)


def bwd_f64(q, k, v, out, lse, do, scale, rounded=False):
    """The causal backward in f64 (dq, dk, dv) of the inputs the kernels
    take: P = exp(S scale - lse) under the causal mask with the given lse,
    delta = rowsum(dO * out). With ``rounded``, P and dS are rounded to
    bf16 before the second products, where both backward versions round
    them. One batch row at a time; dk and dv summed over each KV head's
    group."""
    B, H, N, D = q.shape
    group = H // k.shape[1]
    keep = torch.ones(N, N, dtype=torch.bool, device=q.device).tril()
    dq = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float64, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float64, device=q.device)
    for b in range(B):
        qb, dob, ob = q[b].double(), do[b].double(), out[b].double()
        kb = k[b].double().repeat_interleave(group, 0)
        vb = v[b].double().repeat_interleave(group, 0)
        s = qb @ kb.transpose(1, 2) * scale - lse[b].double()[..., None]
        p = torch.exp(s).masked_fill_(~keep, 0.0)
        del s
        delta = (dob * ob).sum(-1, keepdim=True)
        ds = p * (dob @ vb.transpose(1, 2) - delta)
        if rounded:
            p = p.to(torch.bfloat16).double()
            ds = ds.to(torch.bfloat16).double()
        dq[b] = ds @ kb * scale
        dk[b] = (ds.transpose(1, 2) @ qb * scale).view(
            -1, group, N, D).sum(1)
        dv[b] = (p.transpose(1, 2) @ dob).view(-1, group, N, D).sum(1)
        del p, ds
    return dq, dk, dv


def bar_ratio(got, want):
    """The largest |got - want| / (atol + rtol |want|) at KERNEL_BAR (above
    1 fails the elementwise check), the largest |got - want|, and where the
    worst ratio falls (index, |want| there)."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    ratio = err / (KERNEL_BAR["atol"] + KERNEL_BAR["rtol"] * w.abs())
    i = int(ratio.argmax())
    idx = np.unravel_index(i, tuple(w.shape))
    return {"ratio": float(ratio.reshape(-1)[i]),
            "max_abs": float(err.max()),
            "rms": float(err.square().mean().sqrt()),
            "where": [int(x) for x in idx],
            "abs_ref_there": float(w.abs().reshape(-1)[i]),
            "misses": int((ratio > 1).sum())}


def _draw(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        dev, torch.bfloat16)


def shared_draw_rng(dev):
    """chip_smoke.py's phase-3 generator as check_flash_bwd found it in a
    run whose fused cases all drew from it (before FUSED_SEED gave them a
    generator of their own): phase 3's checks before the backward replayed
    on the full-width model with every timing left out."""
    import chip_smoke as cs
    from leetcuda_tpu_torch.models.llama import (ModelConfig, fuse_params,
                                                 init_params,
                                                 quantize_params)

    class Shared(cs.Recorder):  # every Recorder draws from one generator
        _rng = None

        @property
        def rng(self):
            return Shared._rng

        @rng.setter
        def rng(self, g):
            if Shared._rng is None:
                Shared._rng = g

    class Found(Exception):
        pass

    def found(rec, flush):
        raise Found()

    def no_time(*a, **k):
        return 0.0

    saved = {n: getattr(cs, n) for n in (
        "Recorder", "time_ms", "interleaved_ms", "alone_in_turn",
        "device_alone_ms", "resident_sass", "check_flash_bwd")}
    cs.Recorder, cs.time_ms, cs.check_flash_bwd = Shared, no_time, found
    cs.interleaved_ms = lambda fns, *a, **k: {n: 0.0 for n in fns}
    cs.alone_in_turn = lambda fns, *a, **k: {n: None for n in fns}
    cs.device_alone_ms = lambda *a, **k: None
    cs.resident_sass = lambda *a, **k: {}
    try:
        cfg = ModelConfig()
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(gen, cfg, device=dev)
        fparams = fuse_params(params)
        qparams = {name: quantize_params(fparams if fuse else params, w)
                   for name, (w, fuse, _) in cs.QUANT_PATHS.items()}
        sweep = (16, 32, 64, 128)  # main()'s path_rows
        path_rows = {"a": (1, 8, 9, 72, 8 * 1536, 384, *sweep),
                     "b": (8, 1024), "c": (1, 8, 9, 72, 1024, *sweep)}
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)
        try:
            cs.check_kernels(flush, cs.matmul_cases(qparams, path_rows),
                             fparams["layers"][0], cfg)
        except Found:
            pass
        else:
            raise RuntimeError("phase 3 never reached the backward")
        del params, fparams, qparams
    finally:
        for n, f in saved.items():
            setattr(cs, n, f)
    got = Shared._rng
    # check_flash_bwd's draws before its causal case: the lse checks
    B, H, Hkv, N, D = F64_SHAPE
    for shape in ((B, H, N, D), (B, Hkv, N, D), (B, Hkv, N, D),
                  (B, H, 1536, D), (B, Hkv, 1536, D), (B, Hkv, 1536, D)):
        got.standard_normal(shape, dtype=np.float32)
    torch.cuda.empty_cache()
    return got


def bwd_f64_draw(rng, dev):
    """One draw at F64_SHAPE from ``rng``: each version's distance from each
    reference, for dq, dk and dv."""
    B, H, Hkv, N, D = F64_SHAPE
    scale = 1.0 / math.sqrt(D)
    q, k, v = (_draw(rng, s, dev) for s in ((B, H, N, D), (B, Hkv, N, D),
                                            (B, Hkv, N, D)))
    out, lse = fl.flash_attention(q, k, v, causal=True, with_lse=True)
    do = _draw(rng, (B, H, N, D), dev)
    got = fb.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    plain = fb.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                         sm_scale=scale)
    res = {}
    for rounded in (False, True):
        ref = bwd_f64(q, k, v, out, lse, do, scale, rounded)
        tag = "f64_rounded" if rounded else "f64"
        for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
            res.setdefault(name, {})[f"kernel_vs_{tag}"] = bar_ratio(g, r)
            res[name][f"plain_vs_{tag}"] = bar_ratio(p, r)
        del ref
    for name, g, p in zip(("dq", "dk", "dv"), got, plain):
        res[name]["kernel_vs_plain"] = bar_ratio(g, p)
    return res


def bench_bwd_f64(dev, seeds, shared):
    """--bwd-f64: each draw's errors (see bwd_f64_draw), printed."""
    draws = [(f"seed {s}", np.random.default_rng(s)) for s in seeds]
    if shared:
        draws.insert(0, ("shared draw", shared_draw_rng(dev)))
    rows = []
    for label, rng in draws:
        res = bwd_f64_draw(rng, dev)
        rows.append({"draw": label, **res})
        for name in ("dk", "dq", "dv"):
            print(f"{label} {name}: " + "; ".join(
                f"{pair} ratio {r['ratio']:.3f} max {r['max_abs']:.4g} rms "
                f"{r['rms']:.3g} misses {r['misses']} at {r['where']} "
                f"|ref| {r['abs_ref_there']:.4g}"
                for pair, r in res[name].items()), flush=True)
    return rows


def bench_bwd(dev, iters, rounds, flush, cases=None):
    """Each variant build at each case it changes, in turn with SDPA's
    backward. Returns the rows."""
    builds = []
    if dev.type == "cuda":
        from leetcuda_tpu_torch.build import build_variants

        for v, (lib, log) in zip(BWD_VARIANTS,
                                 build_variants("flash_bwd", BWD_VARIANTS)):
            print(f"  built {variant_label(v)}: "
                  f"{ptxas_summary(log) if log else 'cached'}", flush=True)
            builds.append((v, lib))
    rows = []
    for key in cases or list(CASES):
        label, shape, cap = CASES[key]
        B, H, Hkv, N, D = shape
        q, k, v, out, lse, do = _inputs(shape, cap, dev)
        scale = D ** -0.5
        want = fb.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                            causal=True, sm_scale=scale,
                                            softcap=cap)
        fns = []
        for vb, lib in builds:
            if key not in variant_cases(vb):
                continue
            name = variant_label(vb)
            got = _whole(lib, q, k, v, out, lse, do, scale, cap)
            err = max(rel_l2(g, w) for g, w in zip(got, want))
            if "LC_BWD_PROBE" not in vb and err > 1e-2:
                raise AssertionError(f"{name} at {label}: relative L2 {err}")
            del got
            _, rb = fb._launch_dq(q, k, v, out, do, lse, None, True,
                                  scale, 0, cap or 0.0, lib)
            fns.append((name, err, {
                "whole": lambda lib=lib: _whole(lib, q, k, v, out, lse, do,
                                                scale, cap),
                "dq": lambda lib=lib: fb._launch_dq(
                    q, k, v, out, do, lse, None, True, scale, 0, cap or 0.0,
                    lib),
                "dkv": lambda lib=lib, rb=rb: fb._launch_dkv(
                    q, k, v, do, rb, True, scale, 0, cap or 0.0,
                    lib)}, vb))
        if dev.type == "cuda":
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            o = torch.nn.functional.scaled_dot_product_attention(
                qr, kr, vr, is_causal=True, enable_gqa=True)
            fns.append(("SDPA backward", 0.0, {"whole": lambda o=o: (
                torch.autograd.grad(o, (qr, kr, vr), do, retain_graph=True))},
                None))
        else:  # the plain backward: a check of the CLI
            fns.append(("plain backward", 0.0, {
                "whole": lambda: fb.flash_attention_bwd_plain(
                    q, k, v, out, lse, do, causal=True, sm_scale=scale,
                    softcap=cap)}, None))
        times = {(n, part): [] for n, _, parts, _ in fns for part in parts}
        for _ in range(rounds):
            for n, _, parts, _ in fns:
                for part, fn in parts.items():
                    times[(n, part)].append(time_ms(fn, dev, iters, flush))
        prod = 2.0 * B * H * D * N * (N + 1) / 2  # one causal product
        bound = {"whole": 5 * prod, "dq": 3 * prod, "dkv": 4 * prod}
        print(f"--- {label} (bound: whole {bound['whole'] / 989e9:.4f} ms, "
              f"dQ {bound['dq'] / 989e9:.4f}, dK/dV "
              f"{bound['dkv'] / 989e9:.4f} at 989 TFLOP/s) ---")
        for n, err, parts, vb in fns:
            row = {"case": key, "shape": list(shape), "softcap": cap,
                   "variant": n, "macros": vb, "rel_l2": err}
            if vb is not None:
                dq_plan, dkv_plan = variant_plan(vb, D)
                row["plan"] = fb.bwd_plan(D, B, H, Hkv, N, N, dq_plan,
                                          dkv_plan)
            msg = []
            for part in parts:
                ms = float(np.median(times[(n, part)]))
                row[f"{part}_ms"] = ms
                row[f"{part}_rounds"] = times[(n, part)]
                if dev.type == "cuda" and "PROBE" not in str(vb):
                    row[f"{part}_share"] = bound[part] / 989e9 / ms
                    msg.append(f"{part} {ms:.4f} ms "
                               f"({bound[part] / 989e9 / ms:.3f})")
                else:
                    msg.append(f"{part} {ms:.4f} ms")
            if key == "cap" and vb is not None and dev.type == "cuda":
                row["cap_controls"] = cap_controls(
                    next(lib for b, lib in builds if b is vb), dev)
                msg.append(f"cap 2 controls {row['cap_controls']}")
            rows.append(row)
            print(f"  {n}: " + ", ".join(msg) + f"; rel L2 {err:.3g}",
                  flush=True)
    return rows


# --chunk: the crossover A/B and the routes' variant builds
CHUNK_SPLIT_VARIANTS = [{}, {"LC_CHUNK_SPLIT_STAGES": 2},
                        {"LC_CHUNK_SPLIT_STAGES": 3},
                        {"LC_CHUNK_SPLIT_STAGES": 4}]
CHUNK_TMA_VARIANTS = [{}, {"LC_CHUNK_KEYS": 64}, {"LC_CHUNK_STAGES": 3}]
CHUNK_SPLITS = (64, 128, 256, 512)


def _chunk_inputs(dev, B, H, Hkv, T, D, S, bases, page=0, q_scale=1.0,
                  fmt="bf16"):
    """Seeded q (B, H, T, D) and a cache of S positions, bf16 or int8 with
    its f32 scales (pools of ``page`` behind a table in order when
    ``page``), the bases: (q, k, v, k_scale, v_scale, table, base)."""
    from leetcuda_tpu_torch.models.llama import _quantize_token_kv

    gen = torch.Generator(device=dev).manual_seed(22)

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    q = rnd(B, H, T, D, scale=q_scale)
    k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    ks = vs = None
    if fmt == "int8":
        (k, ks), (v, vs) = (_quantize_token_kv(x, torch.int8) for x in (k, v))
    base = torch.tensor(bases, dtype=torch.int32, device=dev)
    if not page:
        return q, k, v, ks, vs, None, base
    P = S // page
    table = torch.arange(1, B * P + 1, dtype=torch.int32,
                         device=dev).reshape(B, P)

    def pool(c):
        tail = c.shape[3:]
        out = torch.zeros((B * P + 1, Hkv, page, *tail), dtype=c.dtype,
                          device=dev)
        out[1:] = c.reshape(B, Hkv, P, page, *tail).transpose(1, 2).reshape(
            B * P, Hkv, page, *tail)
        return out
    return (q, pool(k), pool(v), None if ks is None else pool(ks),
            None if vs is None else pool(vs), table, base)


def _chunk_case(dev, label, inputs, kw, variants, iters, rounds, flush,
                extra):
    """Times each (label, route, lib, split) of ``variants`` in turn over
    ``inputs`` (q, k, v, k_scale, v_scale, table, base), held against the
    plain version. Returns the rows."""
    from leetcuda_tpu_torch.attention import chunk as ck
    from leetcuda_tpu_torch.attention.decode import _outputs

    q, k, v, ks, vs, table, base = inputs
    kg, vg, ksg, vsg = ((ck._gather(t, table) if t is not None else None
                         for t in (k, v, ks, vs)) if table is not None
                        else (k, v, ks, vs))
    kw = dict(kw, k_scale=ksg, v_scale=vsg)
    want = ck.chunk_attention_plain(q, kg, vg, base, **kw)
    scale = q.shape[-1] ** -0.5
    fns = []
    for name, route, lib, split in variants:
        if dev.type != "cuda":
            fns.append((name, lambda: ck.chunk_attention_plain(
                q, kg, vg, base, **kw)))
            continue

        def run(route=route, lib=lib, split=split):
            out, _ = _outputs(q, False)
            _, err = ck.launch(q, k, v, ks, vs, table, base, out, None,
                               scale=scale, window=kw.get("window") or 0,
                               softcap=kw.get("softcap") or 0.0, route=route,
                               split_keys=split, lib=lib)
            if err:
                raise RuntimeError(f"chunk {name}: CUDA error {err}")
            return out
        fns.append((name, run))
    rows = []
    for name, fn in fns:
        got = fn()
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), atol=1e-2,
                              rtol=1e-2):  # chip_smoke.py's KERNEL_TOL
            raise AssertionError(f"chunk {name} at {label}: max abs {err}")
        rows.append({"case": label, **extra, "variant": name,
                     "max_abs_err": err, "rounds": []})
    for _ in range(rounds):
        for row, (_, fn) in zip(rows, fns):
            row["rounds"].append(time_ms(fn, dev, iters, flush))
    print(f"--- chunk {label} ---")
    for row in rows:
        row["ms"] = float(np.median(row["rounds"]))
        print(f"  {row['variant']}: {row['ms']:.4f} ms; max abs "
              f"{row['max_abs_err']:.3g}", flush=True)
    return rows


def bench_chunk(dev, iters, rounds, flush, Ts, Gs, S, fmts):
    """The routes' A/B across T and G over a bf16 and an int8 cache (the
    crossover), then each route's variants (route A's split length and
    stages, route B's keys and stages; on the GPU only). Returns the
    rows."""
    rows = []
    B, Hkv, D = 8, 4, 128
    cuda = dev.type == "cuda"
    routes = ([("route A (split)", "split", None, None),
               ("route B (tma)", "tma", None, None)] if cuda
              else [("plain", None, None, None)])
    for fmt in fmts:
        for G in Gs:
            for T in Ts:
                bases = np.linspace(0, S - T, B).astype(int).tolist()
                inputs = _chunk_inputs(dev, B, G * Hkv, Hkv, T, D, S, bases,
                                       fmt=fmt)
                rows += _chunk_case(
                    dev, f"{fmt} G={G} T={T} (rows {G * T})", inputs, {},
                    routes, iters, rounds, flush,
                    {"T": T, "G": G, "rows": G * T, "fmt": fmt})
    if not cuda:
        return rows
    from leetcuda_tpu_torch.build import build_variants

    split_libs = build_variants("chunk_attn", CHUNK_SPLIT_VARIANTS)
    tma_libs = build_variants("chunk_tma", CHUNK_TMA_VARIANTS)
    for (lib, log), v in zip(split_libs + tma_libs,
                             CHUNK_SPLIT_VARIANTS + CHUNK_TMA_VARIANTS):
        print(f"  built {v or 'default'}: "
              f"{ptxas_summary(log) if log else 'cached'}", flush=True)
    verify = _chunk_inputs(dev, B, 16, Hkv, 4, D, S,
                           np.linspace(0, S - 4, B).astype(int).tolist())
    variants = [(f"split {n} keys", "split", None, n) for n in CHUNK_SPLITS]
    variants += [(f"stages <= {v['LC_CHUNK_SPLIT_STAGES']}", "split", lib,
                  None) for (lib, _), v in zip(split_libs[1:],
                                               CHUNK_SPLIT_VARIANTS[1:])]
    rows += _chunk_case(dev, "route A at verify, G=4 T=4", verify, {},
                        variants, iters, rounds, flush, {"T": 4, "G": 4})
    tma_vars = [(_fwd_label({k.replace("CHUNK_", "FWD_"): x
                             for k, x in v.items()}), "tma", lib, None)
                for (lib, _), v in zip(tma_libs, CHUNK_TMA_VARIANTS)]
    gemma = _chunk_inputs(dev, 2, 32, 16, 512, D, 6144, [3700, 5000],
                          page=128, q_scale=10.0)
    rows += _chunk_case(dev, "route B, Gemma-2-27B T=512, cap 50, W 4096",
                        gemma, {"softcap": 50.0, "window": 4096}, tma_vars,
                        iters, rounds, flush, {"T": 512, "G": 2})
    admit = _chunk_inputs(dev, 1, 16, Hkv, 256, D, S, [1024])
    rows += _chunk_case(dev, "route B, admission T=256 base 1024", admit, {},
                        tma_vars, iters, rounds, flush, {"T": 256, "G": 4})
    return rows + chunk_host_device(dev, iters, flush)


def graph_ms(fn, dev, flush, reps=50, rounds=10):
    """Device ms a call of ``fn``: ``reps`` calls captured in one CUDA graph
    (its scratch made by one call outside the capture), replayed after an L2
    flush (so the first call reads cold, the others warm), the median over
    ``rounds``. The host's enqueue of each call is out of it."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(rounds):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def chunk_host_device(dev, iters, flush):
    """The chunk wrappers at the main paths' shapes three ways: CUDA events
    around one call after an L2 flush (``time_ms``, as chip_smoke.py times
    kernels), the mean of 200 calls back to back (the host's enqueue when it
    is the longer), and the device alone (``graph_ms``). Returns the
    rows."""
    from leetcuda_tpu_torch.attention import chunk as ck

    S, bases4 = 2048, [0, 100, 517, 1024, 1200, 1400, 1950, 2044]
    lse_bases = [0, 100, 124, 125, 517, 1024, 1500, 2044]
    cases = [  # label, inputs, wrapper options
        ("ModelConfig verify bf16", _chunk_inputs(
            dev, 8, 16, 4, 4, 128, S, bases4), {}),
        ("ModelConfig verify int8", _chunk_inputs(
            dev, 8, 16, 4, 4, 128, S, bases4, fmt="int8"), {}),
        ("ModelConfig verify bf16, pages of 128", _chunk_inputs(
            dev, 8, 16, 4, 4, 128, S, bases4, page=128), {}),
        ("GPT-OSS verify, W 128, lse", _chunk_inputs(
            dev, 8, 64, 8, 4, 64, S, lse_bases),
         {"window": 128, "with_lse": True}),
        ("GPT-OSS verify, global, lse", _chunk_inputs(
            dev, 8, 64, 8, 4, 64, S, lse_bases), {"with_lse": True}),
        ("Gemma-2-27B T=512, W 4096, cap 50, pages of 128", _chunk_inputs(
            dev, 2, 32, 16, 512, 128, 6144, [3700, 5000], page=128,
            q_scale=10.0), {"window": 4096, "softcap": 50.0})]
    rows = []
    print("--- chunk wrappers: event time, back to back, device alone ---")
    for label, (q, k, v, ks, vs, table, base), kw in cases:
        if table is not None:
            def fn(q=q, k=k, v=v, table=table, base=base, kw=kw):
                return ck.paged_chunk_attention(q, k, v, table, base, **kw)
        elif ks is not None:
            def fn(q=q, k=k, v=v, ks=ks, vs=vs, base=base, kw=kw):
                return ck.chunk_attention_quantized(q, k, v, ks, vs, base,
                                                    **kw)
        else:
            def fn(q=q, k=k, v=v, base=base, kw=kw):
                return ck.chunk_attention(q, k, v, base, **kw)
        ms = time_ms(fn, dev, iters, flush)
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            fn()
        end.record()
        torch.cuda.synchronize()
        row = {"case": label, "variant": "wrapper", "ms": ms,
               "back_to_back_ms": start.elapsed_time(end) / 200,
               "device_ms": graph_ms(fn, dev, flush)}
        rows.append(row)
        print(f"  {label}: {ms:.4f} ms after a flush; "
              f"{row['back_to_back_ms']:.4f} back to back; device alone "
              f"{row['device_ms']:.4f}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bwd", action="store_true",
                    help="the A/B of the flash backward's builds")
    ap.add_argument("--fwd", action="store_true",
                    help="the A/B of the flash forward's builds")
    ap.add_argument("--chunk", action="store_true",
                    help="the chunk attention's routes and builds")
    ap.add_argument("--bwd-f64", action="store_true",
                    help="the backward's distance from the f64 gradient")
    ap.add_argument("--seeds", type=int, nargs="*", default=list(range(8)),
                    help="--bwd-f64: the numpy seeds of the draws")
    ap.add_argument("--shared-draw", action="store_true",
                    help="--bwd-f64: add the draw of a phase 3 whose fused "
                         "cases drew from the shared generator")
    ap.add_argument("--chunk-t", type=int, nargs="*",
                    default=[4, 8, 16, 32, 64, 128])
    ap.add_argument("--chunk-g", type=int, nargs="*", default=[2, 4, 8])
    ap.add_argument("--chunk-s", type=int, default=2048)
    ap.add_argument("--chunk-fmt", nargs="*", choices=("bf16", "int8"),
                    default=["bf16", "int8"])
    ap.add_argument("--cases", nargs="*", choices=sorted(CASES),
                    default=None, help="--bwd: the cases to run")
    ap.add_argument("--fwd-cases", nargs="*", choices=sorted(FWD_CASES),
                    default=[], help="--fwd: the cases to run (default all)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", type=int, nargs=5, default=None,
                    metavar=("B", "H", "HKV", "N", "D"),
                    help="replace every case's shape (a small one checks the "
                         "CLI on the CPU)")
    ap.add_argument("--json", help="write the rows here")
    args = ap.parse_args(argv)
    if args.bwd + args.fwd + args.chunk + args.bwd_f64 != 1:
        ap.error("pass one of --bwd, --fwd, --chunk and --bwd-f64")
    CASE_FILTER[:] = args.fwd_cases
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the bench measures the card")
    if args.shape:
        for key, (label, _, cap) in list(CASES.items()):
            CASES[key] = (label, tuple(args.shape), cap)
        for key, (label, _, cap, lse) in list(FWD_CASES.items()):
            FWD_CASES[key] = (label, tuple(args.shape), cap, lse)
    flush = None
    if dev.type == "cuda":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)
        print(f"device {torch.cuda.get_device_name(dev)}")
    else:
        print(f"device {dev} (host clock: a check of the CLI, no device "
              f"metric)")
    if args.bwd_f64:
        rows = bench_bwd_f64(dev, args.seeds, args.shared_draw)
    elif args.chunk:
        rows = bench_chunk(dev, args.iters, args.rounds, flush, args.chunk_t,
                           args.chunk_g, args.chunk_s, args.chunk_fmt)
    elif args.bwd:
        rows = bench_bwd(dev, args.iters, args.rounds, flush, args.cases)
    else:
        rows = bench_fwd(dev, args.iters, args.rounds, flush)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"device": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else str(dev)),
             "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
