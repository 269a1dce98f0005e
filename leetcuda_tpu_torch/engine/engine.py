"""Continuous-batching decode engine over contiguous or paged KV caches, in
PyTorch.

Counterpart of ``leetcuda_tpu/engine/engine.py`` for dense (fused or not) or
weight-only quantized params (``quantize_params``) and a contiguous or paged
cache, plain or quantized (``kv_quant`` "int8" | "fp8"):

- A fixed pool of ``slots`` sequences shares one stacked KV cache (B =
  slots); per-slot ``lengths`` make decode attention read only each
  sequence's valid prefix.
- ``paged=True`` replaces the per-slot reservation of ``max_seq`` positions
  by a global pool of ``num_pages`` pages of ``page_size`` positions
  (attention/paged.py): a ``PageManager`` hands pages to slots as their
  sequences grow, the block table goes to the device once per step, and the
  pool may hold fewer than ``slots * max_seq`` positions. When it runs dry
  mid-decode the youngest sequence is preempted: its pages are released and
  it is requeued for recompute with its generated tokens folded into the
  prompt.
- Admission prefills every waiting request that finds a free slot. More
  than one fresh request goes through ONE ragged-flash batch
  (``forward_ragged``, prompts padded to a common bucket); a lone arrival
  goes through ``forward``. The returned K/V are copied into the slots in
  place. Steady state is one ``decode_step`` for all slots per tick.
- ``generate`` is the counterpart of ``generate_scan``: prefill, then a
  Python loop over ``decode_step``. Capturing it in a CUDA graph is later
  work.

Not ported yet (raise ``NotImplementedError``): speculative decoding
(``spec_k``, ``draft``), the prefix cache, chunked prefill, meshes and
multi-LoRA serving. ``generate`` stays contiguous, as ``generate_scan`` is.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np
import torch

from leetcuda_tpu_torch.attention.paged import PageManager
from leetcuda_tpu_torch.core.runtime import (KernelLaunchError, as_bytes,
                                             resolve_device, round_up)
from leetcuda_tpu_torch.engine.sampling import greedy
from leetcuda_tpu_torch.models.llama import (
    ModelConfig, _quantize_token_kv, decode_step, forward, forward_ragged,
    init_kv_caches, init_paged_kv_caches)


@dataclasses.dataclass
class EngineConfig:
    """The JAX EngineConfig's fields. ``kv_quant`` is None, "int8" or
    "fp8". ``paged`` serves from a pool of ``num_pages`` pages of
    ``page_size`` positions (default: a full ``slots * max_seq`` pool plus
    the null page; ``prefill_bucket`` must be a multiple of ``page_size``).
    Only the defaults of ``spec_k``, ``prefix_cache`` and ``prefill_chunk``
    are served; the others raise."""
    slots: int = 8
    max_seq: int = 1024
    prefill_bucket: int = 128
    kv_quant: str | None = None      # None | "int8" | "fp8"
    eos_id: int | None = None
    paged: bool = False
    page_size: int = 128
    num_pages: int | None = None
    spec_k: int = 0
    prefix_cache: bool = False
    prefill_chunk: int | None = None


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    orig_prompt_len: int = 0  # fixed at submit; the prompt grows on recovery

    def __post_init__(self):
        if not self.orig_prompt_len:
            self.orig_prompt_len = len(self.prompt)

    @property
    def context_len(self):
        return self.orig_prompt_len + len(self.generated)


def _insert_kvs(caches, kvs, slot: int):
    """Copy prefill K/V ((Bp, Hkv, S_pad, Dh) per layer) into the stacked
    caches at slots [slot, slot + Bp), IN PLACE, quantized per position
    (values and scales) when the cache is. Positions at or past a prompt's
    length hold the padding's K/V; decode attention never reads them
    (lengths mask) and later appends overwrite them in order."""
    for cache, (k, v) in zip(caches, kvs):
        bp, s_pad = k.shape[0], k.shape[2]
        rows = (slice(slot, slot + bp), slice(None), slice(0, s_pad))
        if "k_scale" in cache:
            k, ks = _quantize_token_kv(k, cache["k"].dtype)
            v, vs = _quantize_token_kv(v, cache["v"].dtype)
            cache["k_scale"][rows] = ks
            cache["v_scale"][rows] = vs
        as_bytes(cache["k"])[rows] = as_bytes(k.to(cache["k"].dtype))
        as_bytes(cache["v"])[rows] = as_bytes(v.to(cache["v"].dtype))
    return caches


def _insert_kvs_paged(caches, kvs, phys_pages, page: int):
    """Write one sequence's padded prefill K/V ((1, Hkv, S_pad, Dh) per
    layer, S_pad a multiple of ``page``) into its physical pages
    (``phys_pages`` (S_pad / page,) int64 ids, the same for every layer),
    IN PLACE, quantized per position with their scale chunks when the pools
    are."""
    for cache, (k, v) in zip(caches, kvs):
        _, hkv, s_pad, _ = k.shape
        n = s_pad // page

        def chunks(x):  # (1, Hkv, S_pad[, D]) -> (n, Hkv, page[, D])
            return x[0].reshape(hkv, n, page, *x.shape[3:]).transpose(0, 1)

        if "k_scales" in cache:
            k, ks = _quantize_token_kv(k, cache["k_pages"].dtype)
            v, vs = _quantize_token_kv(v, cache["v_pages"].dtype)
            cache["k_scales"][phys_pages] = chunks(ks)
            cache["v_scales"][phys_pages] = chunks(vs)
        as_bytes(cache["k_pages"])[phys_pages] = as_bytes(
            chunks(k.to(cache["k_pages"].dtype)))
        as_bytes(cache["v_pages"])[phys_pages] = as_bytes(
            chunks(v.to(cache["v_pages"].dtype)))
    return caches


def _serving_device(params, device) -> torch.device:
    """The device the params lie on, which must be the ``device`` asked for
    (asking for CUDA on a host without it raises)."""
    want = resolve_device(device)
    have = params["embed"].device
    if have.type != want.type or (want.index is not None and have != want):
        raise ValueError(f"params lie on {have}, not on {want}")
    return have


class Engine:
    """Host-driven continuous-batching engine over the port's kernels."""

    def __init__(self, params, cfg: ModelConfig, econfig: EngineConfig = None,
                 sample_fn: Callable = greedy, seed: int = 0, mesh=None,
                 draft=None, device="cuda"):
        """``sample_fn(logits, generator) -> tokens`` (engine/sampling.py).
        ``params`` must lie on ``device``."""
        self.device = _serving_device(params, device)
        self.cfg = cfg
        self.ec = ec = econfig or EngineConfig()
        unported = [name for name, on in (
            ("spec_k", ec.spec_k),
            ("prefix_cache", ec.prefix_cache),
            ("prefill_chunk", ec.prefill_chunk is not None),
            ("mesh", mesh is not None),
            ("draft", draft is not None)) if on]
        if any(isinstance(w, dict) and "As" in w
               for w in params["layers"][0].values()):
            unported.append("multi-LoRA")
        if unported:
            raise NotImplementedError(
                f"Engine options {unported} are not ported yet (ROADMAP: "
                "chunk paths, parallel layer)")
        if ec.max_seq % ec.prefill_bucket:
            raise ValueError("max_seq must be a multiple of prefill_bucket")
        if ec.paged and ec.prefill_bucket % ec.page_size:
            raise ValueError("prefill_bucket must be a multiple of page_size")
        self.params = params
        self.sample_fn = sample_fn
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.recoveries = 0
        self.preemptions = 0
        self.free: list[int] = list(range(ec.slots))
        self.active: dict[int, Request] = {}   # slot -> request
        self.waiting: deque[Request] = deque()
        self.finished: dict[int, Request] = {}
        self._uid = 0
        self._reset_device_state()

    def _reset_device_state(self):
        ec = self.ec
        self.pm = None
        if ec.paged:
            num_pages = ec.num_pages or (
                ec.slots * ec.max_seq // ec.page_size + 1)
            self.pm = PageManager(num_pages, ec.page_size,
                                  ec.max_seq // ec.page_size, ec.slots)
            self.caches = init_paged_kv_caches(
                self.cfg, num_pages, ec.page_size, quant=ec.kv_quant,
                device=self.device)
        else:
            self.caches = init_kv_caches(self.cfg, ec.slots, ec.max_seq,
                                         quant=ec.kv_quant,
                                         device=self.device)
        # host-side copy of the live lengths: the page bookkeeping reads it
        # instead of synchronising on the device lengths every step
        self._hlen = np.zeros((ec.slots,), np.int64)
        self.lengths = torch.zeros(ec.slots, dtype=torch.int32,
                                   device=self.device)
        self.last_tokens = torch.zeros(ec.slots, dtype=torch.int32,
                                       device=self.device)

    # --- public API -----------------------------------------------------------

    def submit(self, prompt: list[int], max_new: int = 64) -> int:
        L = len(prompt)
        if not 0 < L < self.ec.max_seq:
            raise ValueError(f"prompt length {L} not in (0, {self.ec.max_seq})")
        self._uid += 1
        self.waiting.append(Request(self._uid, [int(t) for t in prompt],
                                    max_new))
        return self._uid

    def _admit(self):
        """Admit waiting requests into free slots. Several fresh requests
        prefill in ONE ragged-flash batch; a single one takes ``forward``.
        A paged engine first reserves the pages of each request's own padded
        prompt; when the pool cannot give them the request waits for pages
        to be released, or the call raises if no active sequence holds any."""
        ec = self.ec
        batch: list[tuple[int, Request]] = []
        while self.free and self.waiting:
            req = self.waiting.popleft()
            slot = self.free.pop()
            need = round_up(len(req.prompt), ec.prefill_bucket)
            if self.pm is not None and not self.pm.ensure(slot, need - 1):
                self.pm.release(slot)
                self.waiting.appendleft(req)
                self.free.append(slot)
                if not any(self.pm.used[s] for s in self.active):
                    raise RuntimeError(
                        f"prompt needs {need // ec.page_size} pages but "
                        f"only {len(self.pm.free)} are free and no active "
                        "sequence holds any to release; raise num_pages")
                break
            batch.append((slot, req))
        if not batch:
            return
        s_pad = round_up(max(len(r.prompt) for _, r in batch),
                         ec.prefill_bucket)
        toks = np.zeros((len(batch), s_pad), np.int32)
        lens = np.zeros((len(batch),), np.int32)
        for i, (_, req) in enumerate(batch):
            toks[i, :len(req.prompt)] = req.prompt
            lens[i] = len(req.prompt)
        toks_t = torch.from_numpy(toks).to(self.device)
        if len(batch) > 1:
            logits, kvs = forward_ragged(
                self.params, toks_t, torch.from_numpy(lens).to(self.device),
                self.cfg)
        else:
            logits, kvs = forward(self.params, toks_t, self.cfg,
                                  return_kv=True)
        for i, (slot, req) in enumerate(batch):
            L = len(req.prompt)
            kvs_i = [(k[i:i + 1], v[i:i + 1]) for k, v in kvs]
            if self.pm is not None:
                # down to this request's own bucket (the batch-wide pad may
                # be longer): only those pages were reserved
                s_req = round_up(L, ec.prefill_bucket)
                phys = torch.tensor(
                    self.pm.used[slot][:s_req // ec.page_size],
                    dtype=torch.long, device=self.device)
                _insert_kvs_paged(
                    self.caches, [(k[:, :, :s_req], v[:, :, :s_req])
                                  for k, v in kvs_i], phys, ec.page_size)
            else:
                _insert_kvs(self.caches, kvs_i, slot)
            self._finish_admission(slot, req, logits[i, L - 1])

    def _finish_admission(self, slot: int, req: Request, last_logits):
        """Sample the first token and mark the slot live."""
        L = len(req.prompt)
        first = self.sample_fn(last_logits, self._gen)
        self.lengths[slot] = L
        self._hlen[slot] = L
        self.last_tokens[slot] = first
        req.generated.append(int(first))
        self.active[slot] = req
        self._maybe_finish(slot, int(first))

    def _maybe_finish(self, slot, token):
        req = self.active.get(slot)
        if req is None:
            return
        hit_eos = self.ec.eos_id is not None and token == self.ec.eos_id
        if (hit_eos or len(req.generated) >= req.max_new
                or req.context_len >= self.ec.max_seq):
            req.done = True
            self.finished[req.uid] = req
            del self.active[slot]
            self.free.append(slot)
            if self.pm is not None:
                self.pm.release(slot)

    def _preempt_youngest(self):
        """The page pool ran dry mid-decode: evict the most recently
        submitted active sequence. Its pages are released and it is requeued
        for recompute with its generated tokens folded into the prompt; on
        re-admission the prefill rebuilds its cache and sampling continues
        from the next position (``context_len`` counts from the original
        prompt, so its budgets are unaffected)."""
        slot = max(self.active, key=lambda s: self.active[s].uid)
        req = self.active.pop(slot)
        req.prompt = req.prompt + req.generated
        self.pm.release(slot)
        self.free.append(slot)
        self.waiting.appendleft(req)
        self.preemptions += 1

    def step(self) -> dict[int, int]:
        """Admit waiting requests, then advance every live slot one token.
        Returns {uid: new token} for this tick."""
        self._admit()
        if not self.active:
            return {}
        page_table = None
        if self.pm is not None:
            # pages for this step's appends; preempt when the pool is dry
            for slot in sorted(self.active):
                while (slot in self.active
                       and not self.pm.ensure(slot, int(self._hlen[slot]))):
                    self._preempt_youngest()
            if not self.active:
                return {}
            page_table = self.pm.device_table(self.device)
        live = np.zeros((self.ec.slots,), bool)
        live[list(self.active)] = True
        live_t = torch.from_numpy(live).to(self.device)
        logits, self.caches = decode_step(self.params, self.last_tokens,
                                          self.caches, self.lengths, self.cfg,
                                          page_table=page_table)
        nxt = self.sample_fn(logits, self._gen)
        # dead slots keep their length: their append lands on a position the
        # next admission's prefill overwrites (paged: on the null page 0,
        # which a released slot's table row points at)
        self.lengths = torch.where(live_t, self.lengths + 1, self.lengths)
        self._hlen[live] += 1
        self.last_tokens = torch.where(live_t, nxt, self.last_tokens)
        out = {}
        nxt_np = nxt.cpu().numpy()
        for slot, req in list(self.active.items()):
            tok = int(nxt_np[slot])
            req.generated.append(tok)
            out[req.uid] = tok
            self._maybe_finish(slot, tok)
        return out

    def stats(self) -> dict:
        """Queue depths, slot and page use and per-request progress."""
        s = {
            "waiting": len(self.waiting),
            "active": len(self.active),
            "finished": len(self.finished),
            "free_slots": len(self.free),
            "recoveries": self.recoveries,
            "context_lens": {req.uid: req.context_len
                             for req in self.active.values()},
            "kv_memory": self.kv_memory_report(),
        }
        if self.pm is not None:
            s["free_pages"] = len(self.pm.free)
            s["preemptions"] = self.preemptions
        return s

    def kv_memory_report(self) -> dict:
        """Bytes held by the KV cache or page pools, scales included."""
        return {"target_bytes": int(sum(t.nbytes for c in self.caches
                                        for t in c.values()))}

    def recover(self):
        """Drop all device state (pages included) and requeue every
        in-flight request for recompute: generated tokens fold into the
        prompts, so each request still emits exactly its remaining tokens."""
        for req in self.active.values():
            req.prompt = req.prompt + req.generated
            self.waiting.appendleft(req)
        self.active.clear()
        self.free = list(range(self.ec.slots))
        self.recoveries += 1
        self._reset_device_state()

    def run(self, prompts: list[list[int]], max_new: int = 64,
            max_recoveries: int = 2) -> dict[int, list[int]]:
        """Submit all prompts, run to completion, return {uid: generated}.
        A kernel launch that CUDA refused (``KernelLaunchError``) triggers
        recover() up to ``max_recoveries`` times before re-raising."""
        uids = [self.submit(p, max_new) for p in prompts]
        failures = 0
        while self.waiting or self.active:
            try:
                self.step()
            except KernelLaunchError:
                failures += 1
                if failures > max_recoveries:
                    raise
                self.recover()
        return {u: self.finished[u].generated for u in uids}


def generate(params, cfg: ModelConfig, prompts, max_new: int,
             kv_quant: str | None = None, max_seq: int | None = None,
             sample_fn=None, generator: torch.Generator | None = None,
             device="cuda"):
    """Generate ``max_new`` tokens for a (B, S) prompt batch: one prefill,
    then ``max_new - 1`` decode steps (greedy by default, or ``sample_fn``
    with ``generator``), over a cache quantized as ``kv_quant`` says (None,
    "int8" or "fp8"). Returns tokens (B, max_new) int32. The cache capacity
    rounds up to a multiple of 1024, as ``generate_scan`` does."""
    dev = _serving_device(params, device)
    sample_fn = sample_fn or greedy
    prompts = torch.as_tensor(prompts, device=dev)
    B, S = prompts.shape
    max_seq = max_seq or round_up(S + max_new, 1024)
    caches = init_kv_caches(cfg, B, max_seq, quant=kv_quant, device=dev)
    logits, kvs = forward(params, prompts, cfg, return_kv=True)
    _insert_kvs(caches, kvs, 0)
    tok = sample_fn(logits[:, S - 1], generator)
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    out = [tok]
    for _ in range(max_new - 1):
        logits, caches = decode_step(params, tok, caches, lengths, cfg)
        tok = sample_fn(logits, generator)
        lengths = lengths + 1
        out.append(tok)
    return torch.stack(out, dim=1)
