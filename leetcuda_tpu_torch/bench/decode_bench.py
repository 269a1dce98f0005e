"""Decode-attention benchmark CLI: the split-KV kernel of
``csrc/decode_attn.cu`` at the main paths' decode shapes, at each candidate
split length (``attention/decode.py`` ``SPLIT_KEYS``, patched per call),
beside SDPA over the same cache with the band as a mask.

    python -m leetcuda_tpu_torch.bench.decode_bench
    python -m leetcuda_tpu_torch.bench.decode_bench --cases modelconfig \\
        cp_decode --splits 128 256 512 --rounds 5

The candidates of one case are timed in turn, ``--rounds`` times, each time
the median over ``--iters`` launches of CUDA-event times with the 50 MB L2
flushed by a 256 MB write before each launch (as ``chip_smoke.py`` times
its kernels); the report gives each candidate's median over the rounds,
its largest difference from the plain version, and the byte bound (the
attended K / V bytes, q and the output over 3.35 TB/s). ``--device cpu``
runs the plain versions at a tenth of the lengths on the host clock, a
check of the CLI and not a device measurement.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from leetcuda_tpu_torch.attention import decode as dec
from leetcuda_tpu_torch.bench.gemm_bench import time_ms
from leetcuda_tpu_torch.core.runtime import resolve_device

HBM_BYTES_PER_S = 3.35e12
MODEL_LENS = (1, 100, 517, 1024, 1200, 1400, 1950, 2000)
GEMMA_LENS = (6000, 4097, 4096, 1000)
CP_LENS = (1, 100, 4095, 4097, 10000, 20000, 30000, 32768)
# name: (B lengths, H, Hkv, head dim, capacity, options, one shared
# operand); the shapes of chip_smoke.py's phase 3
CASES = {
    "modelconfig": (MODEL_LENS, 16, 4, 128, 2048, {}, False),
    "gemma27b_global": (GEMMA_LENS, 32, 16, 128, 6144,
                        dict(softcap=50.0, sm_scale=144 ** -0.5), False),
    "gemma27b_local": (GEMMA_LENS, 32, 16, 128, 6144,
                       dict(window=4096, softcap=50.0,
                            sm_scale=144 ** -0.5), False),
    "gemma9b_global": (GEMMA_LENS, 16, 8, 256, 6144, dict(softcap=50.0),
                       False),
    "gemma9b_local": (GEMMA_LENS, 16, 8, 256, 6144,
                      dict(window=4096, softcap=50.0), False),
    "gptoss_global": ((0, 100, 128, 129, 517, 1024, 1500, 2000), 64, 8, 64,
                      2048, dict(with_lse=True), False),
    "mla_shared": (MODEL_LENS, 16, 1, 576, 2048,
                   dict(sm_scale=192 ** -0.5), True),
    "cp_decode": (CP_LENS, 32, 4, 128, 32768, dict(with_lse=True), False),
}


def sdpa(q, k, v, mask, scale):
    """SDPA over the cache with its GQA groups, the band as a boolean mask
    (the yardstick; the port never calls it)."""
    import torch.nn.functional as F

    try:
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask, scale=scale,
                                              enable_gqa=True)
    except TypeError:  # older torch: no enable_gqa
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q[:, :, None], k.repeat_interleave(g, 1),
            v.repeat_interleave(g, 1), attn_mask=mask, scale=scale)


def run_case(name, splits, dev, rounds, iters, flush, gen):
    lens, H, Hkv, D, S, opt, shared = CASES[name]
    if dev.type == "cpu":
        lens, S = tuple(max(n // 10, 0) for n in lens), S // 10
    B = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q = randn(B, H, D)
    k = randn(B, Hkv, S, D)
    v = k if shared else randn(B, Hkv, S, D)
    args = (q, k, lengths) if shared else (q, k, v, lengths)
    kw = dict(opt, shared_kv=shared)

    def out(r):
        return r[0] if isinstance(r, tuple) else r
    want = out(dec.decode_attention_plain(*args, **kw)).float()
    cols = torch.arange(S, device=dev)[None, :]
    band = cols < lengths[:, None]
    if opt.get("window"):
        band &= cols >= lengths[:, None] - opt["window"]
    n_att = int(band.sum())
    elt = 2.0 * D * n_att * Hkv * (1 if shared else 2)
    bound_ms = (elt + 4.0 * B * H * D) / HBM_BYTES_PER_S * 1e3
    scale = opt.get("sm_scale") or 1.0 / math.sqrt(D)
    fns, errs = {}, {}
    default = dec.SPLIT_KEYS[D]
    for split in splits:
        def fn(split=split):
            dec.SPLIT_KEYS[D] = split
            return dec.decode_attention(*args, **kw)
        errs[f"split {split}"] = float(
            (out(fn()).float() - want).abs().max())
        fns[f"split {split}"] = fn
    fns["sdpa"] = lambda: sdpa(q, k, v, band[:, None, None, :], scale)
    times = {n: [] for n in fns}
    try:
        for _ in range(rounds):
            for n, fn in fns.items():
                times[n].append(time_ms(fn, dev, iters, flush))
    finally:
        dec.SPLIT_KEYS[D] = default
    return {"case": name, "head_dim": D, "bound_ms": bound_ms,
            "default_split": default,
            "ms": {n: float(np.median(t)) for n, t in times.items()},
            "max_abs_err": errs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=list(CASES))
    ap.add_argument("--splits", nargs="+", type=int,
                    default=[64, 128, 256, 512],
                    help="split lengths to time (multiples of 32)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", help="also write the results here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    flush = (torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
             if dev.type == "cuda" else None)
    gen = torch.Generator(device=dev).manual_seed(0)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}")
    else:
        print("device: cpu (host clock; not a device measurement)")
    res = []
    for name in args.cases:
        r = run_case(name, args.splits, dev, args.rounds, args.iters, flush,
                     gen)
        res.append(r)
        ms = ", ".join(f"{n} {t:.4f}" for n, t in r["ms"].items())
        err = max(r["max_abs_err"].values())
        print(f"{name} (D={r['head_dim']}, split {r['default_split']} in "
              f"use): {ms} ms; bound {r['bound_ms']:.4f} ms; max abs err "
              f"{err:.3g}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
