#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (leetcuda_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles every kernel under leetcuda_tpu_torch/csrc/ (timed).
3. Kernel checks: each hand-written kernel against its plain PyTorch version
   on the card in bf16 at atol/rtol 1e-2, at the shapes of the main path,
   with its time (CUDA events, L2 flushed before each launch), the plain
   version's time, one PyTorch library call's time as a yardstick, and the
   least time the card could take (bound).
4. Main path: the continuous-batching Engine serves the full-width default
   ModelConfig() (bf16, random weights from a seed): 8 requests with prompts
   of 16-1500 tokens admitted in one ragged batch, then one request alone
   (the forward path); then ``generate`` at B=8, S=128, 64 new tokens.
   Launch counts are zeroed just before and read just after.
5. Checks: every request's tokens, teacher-forced against a solo B=1
   decode_step replay: each token must score within LOGIT_TOL of the
   replay's max logit.
6. Profile: one B=8 decode step's wall time and, from torch.profiler, its
   device time by kernel (the device busy share).

Prints the card line, a {"kernels": [...]} line, and last a
{"ok": true, "device": {...}} line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
KERNEL_TOL = dict(atol=1e-2, rtol=1e-2)  # the flash registry bar
# Teacher-forced check: a served token must score within this of the solo
# replay's max logit. The random model's logits have unit scale (unit-rms
# final norm times unit-norm embedding rows); 0.25 is ~16 bf16 ulps at the
# usual max logit of ~4, room for bf16 rounding in differently shaped
# products (ragged B=8 prefill vs B=1 decode) and nowhere near a wrong token
# of a random model (the max stands ~1 above the typical logit).
LOGIT_TOL = 0.25


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, flush, iters=20, warmup=3):
    """Median of per-launch CUDA-event times, L2 flushed before each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()  # a 256 MB write evicts the 50 MB L2
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def bound(flops, nbytes):
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"))


def sdpa(q, k, v, **kw):
    """One PyTorch library call as the yardstick (never used by the port)."""
    import torch.nn.functional as F
    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:  # older torch: no enable_gqa
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), **kw)


def check_kernels(flush):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    from leetcuda_tpu_torch.attention import decode as dec
    from leetcuda_tpu_torch.attention import flash as fl

    dev = "cuda"
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    rows = {}

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, bf)

    def record(name, src, replaces, got, want, ms, plain_ms, lib_ms, flops,
               nbytes):
        torch.testing.assert_close(got.float(), want.float(), **KERNEL_TOL)
        b_s, by = bound(flops, nbytes)
        rows[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_s * 1e3,
            "bound_by": by, "library_ms": lib_ms,
            "flops": flops, "bytes": nbytes}

    # flash causal, (1, 16, 2048, 128), Hkv = 4
    B, H, Hkv, N, D = 1, 16, 4, 2048, 128
    q, k, v = randn(B, H, N, D), randn(B, Hkv, N, D), randn(B, Hkv, N, D)
    got = fl.flash_attention(q, k, v, causal=True)
    want = fl.flash_attention_plain(q, k, v, causal=True)
    pairs = N * (N + 1) // 2  # (row, key) pairs the causal mask keeps
    record("flash_attention", "leetcuda_tpu_torch/csrc/flash_fwd.cu",
           "leetcuda_tpu/attention/flash.py:259", got, want,
           time_ms(lambda: fl.flash_attention(q, k, v, causal=True), flush),
           time_ms(lambda: fl.flash_attention_plain(q, k, v, causal=True),
                   flush, iters=5),
           time_ms(lambda: sdpa(q, k, v, is_causal=True), flush),
           4.0 * B * H * D * pairs,
           2.0 * (2 * B * H * N * D + 2 * B * Hkv * N * D))

    # ragged flash, B = 8, N = 1536, lengths spread over 1..1536
    B, N = 8, 1536
    lens_np = np.linspace(1, N, B).astype(np.int32)
    lengths = torch.from_numpy(lens_np).to(dev)
    q, k, v = randn(B, H, N, D), randn(B, Hkv, N, D), randn(B, Hkv, N, D)
    got = fl.flash_attention_ragged(q, k, v, lengths)
    want = fl.flash_attention_plain(q, k, v, causal=True, lengths=lengths)
    cols = torch.arange(N, device=dev)
    mask = ((cols[None, :] <= cols[:, None])[None]
            & (cols[None, None, :] < lengths[:, None, None]))[:, None]
    n_valid = int(lens_np.sum())
    pairs = int(sum(n * (n + 1) // 2 for n in lens_np))
    record("flash_attention_ragged", "leetcuda_tpu_torch/csrc/flash_fwd.cu",
           "leetcuda_tpu/attention/flash.py:367", got, want,
           time_ms(lambda: fl.flash_attention_ragged(q, k, v, lengths),
                   flush),
           time_ms(lambda: fl.flash_attention_plain(
               q, k, v, causal=True, lengths=lengths), flush, iters=5),
           time_ms(lambda: sdpa(q, k, v, attn_mask=mask), flush),
           4.0 * H * D * pairs,
           2.0 * (H * n_valid * D + 2 * Hkv * n_valid * D + B * H * N * D))

    # decode, B = 8, H = 16, Hkv = 4, S_max = 2048, NaN past every length
    B, S = 8, 2048
    lens_np = np.array([1, 100, 517, 1024, 1200, 1400, 1950, 2000], np.int32)
    lengths = torch.from_numpy(lens_np).to(dev)
    q, kc, vc = randn(B, H, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    for b, n in enumerate(lens_np):
        kc[b, :, n:] = float("nan")
        vc[b, :, n:] = float("nan")
    got = dec.decode_attention(q, kc, vc, lengths)
    if not torch.isfinite(got).all():
        raise AssertionError("decode kernel let NaN padding through")
    want = dec.decode_attention_plain(q, kc, vc, lengths)
    dmask = (torch.arange(S, device=dev)[None, :]
             < lengths[:, None])[:, None, None, :]
    n_valid = int(lens_np.sum())
    record("decode_attention", "leetcuda_tpu_torch/csrc/decode_attn.cu",
           "leetcuda_tpu/attention/decode.py:223", got, want,
           time_ms(lambda: dec.decode_attention(q, kc, vc, lengths), flush),
           time_ms(lambda: dec.decode_attention_plain(q, kc, vc, lengths),
                   flush, iters=5),
           time_ms(lambda: sdpa(q[:, :, None], kc, vc, attn_mask=dmask),
                   flush),
           4.0 * H * D * n_valid,
           2.0 * (2 * Hkv * n_valid * D + 2 * B * H * D) + 4 * B)
    return rows


def teacher_forced_gap(params, cfg, prompt, tokens):
    """Largest (max logit - logit of the served token) over a solo B=1
    decode_step replay of prompt + tokens, on the params' device."""
    from leetcuda_tpu_torch.models.llama import decode_step, init_kv_caches

    dev = params["embed"].device
    seq = list(prompt) + list(tokens)
    caches = init_kv_caches(cfg, 1, len(seq) + (-len(seq) % 128), device=dev)
    lengths = torch.zeros(1, dtype=torch.int32, device=dev)
    toks = torch.tensor(seq, dtype=torch.int32, device=dev)
    tgt = torch.tensor(list(tokens), dtype=torch.long, device=dev)
    gaps = []
    for t in range(len(seq) - 1):
        logits, caches = decode_step(params, toks[t:t + 1], caches, lengths,
                                     cfg)
        lengths += 1
        j = t - (len(prompt) - 1)
        if j >= 0:
            gaps.append(logits[0].max() - logits[0, tgt[j]])
    return float(torch.stack(gaps).max())


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def serve(params, cfg, prompts, lone, gprompts, max_new, g_new, max_seq,
          bucket):
    """Phase 4, the main path: the Engine serves ``prompts`` (one ragged
    admission), then ``lone`` alone (the forward path); then ``generate``
    over ``gprompts``. Launch counts are zeroed just before and read just
    after. Returns timings, the served tokens and the counts."""
    from leetcuda_tpu_torch.core.runtime import (launch_counts,
                                                 reset_launch_counts)
    from leetcuda_tpu_torch.engine import Engine, EngineConfig, generate

    dev = params["embed"].device
    eng = Engine(params, cfg, EngineConfig(slots=len(prompts),
                                           max_seq=max_seq,
                                           prefill_bucket=bucket),
                 device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new) for p in prompts]
    eng.step()  # admits all of them in one ragged batch, one decode step
    sync(dev)
    t_admit = time.perf_counter() - t0
    ticks = 1
    while eng.waiting or eng.active:
        eng.step()
        ticks += 1
    sync(dev)
    t_batch = time.perf_counter() - t0
    t1 = time.perf_counter()
    uids.append(eng.submit(lone, max_new))  # admits alone: forward path
    while eng.waiting or eng.active:
        eng.step()
        ticks += 1
    sync(dev)
    t_lone = time.perf_counter() - t1
    t2 = time.perf_counter()
    gtoks = generate(params, cfg, gprompts, g_new, device=dev)
    sync(dev)
    t_gen = time.perf_counter() - t2
    counts = launch_counts()

    if eng.recoveries:
        raise AssertionError(f"engine recovered {eng.recoveries} times")
    served = [eng.finished[u].generated for u in uids]
    for u, toks in zip(uids, served):
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"request {u} answered {toks}")
    if tuple(gtoks.shape) != (gprompts.shape[0], g_new):
        raise AssertionError(f"generate returned {tuple(gtoks.shape)}")
    return {"engine_batch_s": t_batch, "engine_admit_s": t_admit,
            "engine_ticks": ticks, "lone_request_s": t_lone,
            "generate_s": t_gen, "launches": counts,
            "engine_tok_s": len(prompts) * max_new / t_batch,
            "generate_tok_s": gprompts.shape[0] * g_new / t_gen}, served, gtoks


def check_served(params, cfg, prompts, served, gprompts, gtoks):
    """Phase 5: teacher-forced gaps of every served stream."""
    gaps = {}
    for i, (prompt, toks) in enumerate(zip(prompts, served)):
        gaps[f"engine/{i}"] = teacher_forced_gap(params, cfg, prompt, toks)
    g_np = gtoks.cpu().numpy()
    for b in range(g_np.shape[0]):
        gaps[f"generate/{b}"] = teacher_forced_gap(
            params, cfg, gprompts[b].tolist(), g_np[b].tolist())
    return gaps


def profile_decode(params, cfg, batch, context, steps=8):
    """Phase 6: where a B=``batch`` decode step's time goes. The step's wall
    time (host clock, synchronised) without the profiler, then
    torch.profiler's device time by kernel over the same steps: the device
    busy share is device time over wall time."""
    from torch.profiler import ProfilerActivity, profile

    from leetcuda_tpu_torch.models.llama import decode_step, init_kv_caches

    dev = params["embed"].device
    capacity = context + 2 * steps
    caches = init_kv_caches(cfg, batch, capacity + (-capacity % 1024),
                            device=dev)
    tok = torch.zeros(batch, dtype=torch.int32, device=dev)

    def run():
        lengths = torch.full((batch,), context, dtype=torch.int32,
                             device=dev)
        for _ in range(steps):
            decode_step(params, tok, caches, lengths, cfg)
            lengths += 1
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.device_type.name == "CUDA":
            by_kernel[e.key] = (us / 1e3 / steps, e.count // steps)
    device_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return {"batch": batch, "context": context, "step_ms": step_ms,
            "device_ms_per_step": device_ms,
            "launches_per_step": sum(n for _, n in by_kernel.values()),
            "device_busy_share": device_ms / step_ms if device_ms else None,
            "top_kernels": [{"kernel": k[:90], "ms_per_step": ms,
                             "launches_per_step": n}
                            for k, (ms, n) in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from leetcuda_tpu_torch.build import build_all
    from leetcuda_tpu_torch.engine import generate
    from leetcuda_tpu_torch.models.llama import ModelConfig, init_params

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    reports = build_all()
    print(f"build: {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rows = check_kernels(flush)
    for r in rows.values():
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g} "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
              f"library {r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    del flush

    # 4. the main path at full width
    cfg = ModelConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    weight_bytes = sum(t.nbytes for t in [params["embed"], params["norm"]]
                       + [w for layer in params["layers"]
                          for w in layer.values()])
    rng = np.random.default_rng(1)
    plens = np.linspace(16, 1500, 8).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in plens]
    lone = rng.integers(0, cfg.vocab_size, 300).tolist()
    gprompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (8, 128)).astype(np.int32)).cuda()
    generate(params, cfg, gprompts[:1, :16], 2)  # warm-up: cuBLAS, loads
    torch.cuda.synchronize()
    main_path, served, gtoks = serve(params, cfg, prompts, lone, gprompts,
                                     max_new=32, g_new=64, max_seq=2048,
                                     bucket=128)
    counts = main_path["launches"]
    ceiling = 8 / (weight_bytes / HBM_BYTES_PER_S)  # B=8 tokens per step
    for what in ("engine_tok_s", "generate_tok_s"):
        if main_path[what] > ceiling:
            raise AssertionError(f"{what} {main_path[what]:.0f} exceeds the "
                                 f"weight-bandwidth ceiling {ceiling:.0f}")
    print(f"engine: 8 requests (prompts {plens.tolist()}) x 32 tokens in "
          f"{main_path['engine_batch_s']:.3f} s = "
          f"{main_path['engine_tok_s']:.1f} tok/s (admission "
          f"{main_path['engine_admit_s']:.3f} s); lone request "
          f"{main_path['lone_request_s']:.3f} s; generate B=8 S=128 x 64: "
          f"{main_path['generate_s']:.3f} s = "
          f"{main_path['generate_tok_s']:.1f} tok/s; ceiling {ceiling:.0f} "
          f"tok/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB", flush=True)
    print(f"launches on the main path: {counts}")
    missing = [n for n in rows if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    # 5. teacher-forced checks against solo decode_step replays
    t3 = time.perf_counter()
    gaps = check_served(params, cfg, prompts + [lone], served, gprompts,
                        gtoks)
    worst = max(gaps.values())
    print(f"teacher-forced: worst gap {worst:.4f} (tol {LOGIT_TOL}) over "
          f"{len(gaps)} streams in {time.perf_counter() - t3:.1f} s",
          flush=True)
    if worst > LOGIT_TOL:
        raise AssertionError(f"served tokens off the solo replay: {gaps}")

    # 6. where a decode step's time goes
    prof = profile_decode(params, cfg, batch=8, context=1024)
    busy = prof["device_busy_share"]
    print(f"decode step B=8 at context 1024: {prof['step_ms']:.3f} ms wall, "
          f"{prof['device_ms_per_step']:.3f} ms on the device in "
          f"{prof['launches_per_step']} launches (busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'})")
    for t in prof["top_kernels"]:
        print(f"  {t['ms_per_step']:.4f} ms x{t['launches_per_step']} "
              f"{t['kernel']}")

    for name, r in rows.items():
        r["launches"] = counts[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
