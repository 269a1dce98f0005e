"""GEMM benchmark CLI, the port's counterpart of
``leetcuda_tpu/bench/gemm_bench.py``: times registered gemm rungs (or
``auto``, the shape-adaptive ``matmul_auto``) beside ``torch.matmul`` in the
same dtype.

    python -m leetcuda_tpu_torch.bench.gemm_bench --mnk 2048 4096 8192
    python -m leetcuda_tpu_torch.bench.gemm_bench --m 16384 --n 3072 \\
        --k 2048 --variants auto hgemm_mma_stages_block_swizzle

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
    for M, N, K in shapes:
        print(f"--- M={M} N={N} K={K} ---", flush=True)
        bench_size(M, N, K, variants, dtype, dev, args.iters, args.repeats,
                   args.check, flush)


if __name__ == "__main__":
    main()
