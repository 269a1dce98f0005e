"""Attention benchmark CLI: the A/B of the flash kernels' builds.

    python -m leetcuda_tpu_torch.bench.attn_bench --bwd --json bwd_bench.json
    python -m leetcuda_tpu_torch.bench.attn_bench --fwd --json fwd_bench.json

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bwd", action="store_true",
                    help="the A/B of the flash backward's builds")
    ap.add_argument("--fwd", action="store_true",
                    help="the A/B of the flash forward's builds")
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
    if args.bwd == args.fwd:
        ap.error("pass one of --bwd and --fwd")
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
    rows = (bench_bwd(dev, args.iters, args.rounds, flush, args.cases)
            if args.bwd else bench_fwd(dev, args.iters, args.rounds, flush))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"device": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else str(dev)),
             "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
