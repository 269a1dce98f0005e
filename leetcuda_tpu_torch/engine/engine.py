"""Continuous-batching decode engine over contiguous or paged KV caches, in
PyTorch, with speculative decoding, a prefix cache and chunked prefill.

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
- ``spec_k`` with ``draft=(params, cfg)``: every tick the draft proposes
  ``spec_k`` tokens per slot (on a plain contiguous cache of its own) and
  the target verifies them in ONE (spec_k + 1)-token ``decode_chunk``
  (engine/speculative.py), over whatever cache the engine serves from. A
  greedy engine emits exactly the target's greedy stream; a
  ``make_sampler`` sampler goes through the rejection rule
  (``speculative_verdict``), which keeps the target's warped distribution.
- ``prefix_cache`` (paged): full prompt pages are published to the
  ``PageManager``'s refcounted trie; a request whose prompt starts with a
  cached page chain adopts those pages and prefills only its suffix, through
  ``decode_chunk`` against them. The least recently used unreferenced pages
  are evicted when the pool runs dry.
- ``prefill_chunk`` (paged): at most this many prompt tokens are prefilled
  per tick, so a long prompt streams in over several ticks (``filling``)
  while the live slots go on decoding.
- ``generate`` is the counterpart of ``generate_scan``: prefill, then a
  Python loop over ``decode_step``. Capturing it in a CUDA graph is later
  work.

Not ported yet (raise ``NotImplementedError``): meshes and multi-LoRA
serving. ``generate`` stays contiguous, as ``generate_scan`` is.
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
    ``spec_k`` > 0 needs ``Engine(draft=(params, cfg))``; ``prefix_cache``
    and ``prefill_chunk`` (a multiple of ``prefill_bucket``) need
    ``paged``."""
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
    n_filled: int = 0         # prompt tokens already in the cache (chunked fill)

    def __post_init__(self):
        if not self.orig_prompt_len:
            self.orig_prompt_len = len(self.prompt)

    @property
    def context_len(self):
        return self.orig_prompt_len + len(self.generated)


# Most suffix tokens per ``decode_chunk`` call during prefix-cached
# admission: the call holds (T, vocab) f32 logits (131 MB at 1024 x 32000)
# and the MLP's (T, 2 * ffn) activations. The result does not depend on it.
_SUFFIX_T_CAP = 1024


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
        ``draft``: (params, cfg) of the draft model, for ``spec_k`` > 0.
        ``params`` (and the draft's) must lie on ``device``."""
        self.device = _serving_device(params, device)
        self.cfg = cfg
        self.ec = ec = econfig or EngineConfig()
        unported = ["mesh"] if mesh is not None else []
        if any(isinstance(w, dict) and "As" in w
               for w in params["layers"][0].values()):
            unported.append("multi-LoRA")
        if unported:
            raise NotImplementedError(
                f"Engine options {unported} are not ported yet (ROADMAP: "
                "parallel layer, model families)")
        if ec.max_seq % ec.prefill_bucket:
            raise ValueError("max_seq must be a multiple of prefill_bucket")
        if ec.paged and ec.prefill_bucket % ec.page_size:
            raise ValueError("prefill_bucket must be a multiple of page_size")
        if ec.prefix_cache and not ec.paged:
            raise ValueError("prefix_cache requires paged=True")
        if ec.prefill_chunk is not None and (
                not ec.paged or ec.prefill_chunk <= 0
                or ec.prefill_chunk % ec.prefill_bucket):
            raise ValueError("prefill_chunk requires paged=True and must be "
                             "a positive multiple of prefill_bucket")
        self.params = params
        self.sample_fn = sample_fn
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.draft = None
        if ec.spec_k:
            # greedy: exact token matching; a make_sampler() sampler carries
            # its .warp, which the rejection rule needs
            self._spec_warp = getattr(sample_fn, "warp", None)
            if draft is None:
                raise ValueError("spec_k requires draft=(params, cfg)")
            if sample_fn is not greedy and self._spec_warp is None:
                raise ValueError(
                    "speculative decoding needs greedy or a make_sampler() "
                    "sampler (which carries its .warp)")
            _serving_device(draft[0], self.device)
            self.draft = draft
            self._accepted = self._proposed = 0
        self.recoveries = 0
        self.preemptions = 0
        self.free: list[int] = list(range(ec.slots))
        self.active: dict[int, Request] = {}   # slot -> request
        self.filling: dict[int, Request] = {}  # slot -> request mid-prefill
        self._fill_cached: dict[int, int] = {}  # slot -> adopted page count
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
                                  ec.max_seq // ec.page_size, ec.slots,
                                  prefix_cache=ec.prefix_cache)
            self.caches = init_paged_kv_caches(
                self.cfg, num_pages, ec.page_size, quant=ec.kv_quant,
                device=self.device)
        else:
            self.caches = init_kv_caches(self.cfg, ec.slots, ec.max_seq,
                                         quant=ec.kv_quant,
                                         device=self.device)
        if self.draft is not None:
            # the draft always runs on a plain contiguous cache: it is small
            # by construction, and paging or quantizing it would cost more
            # in latency than its memory is worth (kv_memory_report)
            self.caches_d = init_kv_caches(self.draft[1], ec.slots,
                                           ec.max_seq, device=self.device)
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

    def _chunk_admit(self, toks_np, base_pos: int, slot: int):
        """One admission chunk (B = 1): ``toks_np`` (1, T) at positions
        base_pos.. of ``slot``, through ``decode_chunk`` against the slot's
        pages. Returns the logits (T, V)."""
        from leetcuda_tpu_torch.engine.speculative import decode_chunk

        logits, self.caches = decode_chunk(
            self.params, torch.from_numpy(toks_np).to(self.device),
            self.caches,
            torch.full((1,), base_pos, dtype=torch.int32, device=self.device),
            self.cfg,
            page_table=torch.tensor(self.pm.table[slot:slot + 1],
                                    dtype=torch.int32, device=self.device),
            page_aligned=True)
        return logits[0]

    def _set_length(self, slot: int, n: int):
        self.lengths[slot] = n
        self._hlen[slot] = n

    def _ensure(self, slot: int, last_pos: int) -> bool:
        """Pages for positions up to ``last_pos`` of ``slot``, never past
        the capacity (a padded chunk's tail may lie past it; its K/V are
        dropped). False when the pool is dry."""
        return self.pm.ensure(slot, min(last_pos, self.ec.max_seq - 1))

    def _unadmit(self, slot: int, req: Request):
        """The pool cannot take ``req`` now: back to the head of the queue
        (releasing also drops any adopted prefix references)."""
        self.pm.release(slot)
        self.waiting.appendleft(req)
        self.free.append(slot)

    def _admit(self):
        """Admit waiting requests into free slots. Several fresh requests
        prefill in ONE ragged-flash batch; a single one takes ``forward``.
        A paged engine first reserves the pages of each request's own padded
        prompt; when the pool cannot give them the request waits for pages
        to be released, or the call raises if no active sequence holds any.
        With the prefix cache, a request that finds a cached page chain
        adopts it and prefills only its suffix, in chunks through
        ``decode_chunk``. With ``prefill_chunk`` nothing is prefilled here:
        the request reserves its first chunk's pages and goes to
        ``filling``."""
        ec = self.ec
        batch: list[tuple[int, Request, int]] = []  # (slot, req, n_cached)
        while self.free and self.waiting:
            req = self.waiting.popleft()
            slot = self.free.pop()
            L = len(req.prompt)
            n_cached = 0
            if self.pm is not None:
                if ec.prefix_cache:
                    pages = self.pm.match_prefix(req.prompt)
                    if pages:
                        self.pm.adopt(slot, pages)
                        n_cached = len(pages) * ec.page_size
                if ec.prefill_chunk is not None:
                    # the request streams in over ticks (_advance_filling).
                    # ``lengths`` tracks n_filled, so a dead-slot append can
                    # never touch an adopted page.
                    first = round_up(min(ec.prefill_chunk, L - n_cached),
                                     ec.prefill_bucket)
                    if not self._ensure(slot, n_cached + first - 1):
                        self._unadmit(slot, req)
                        break
                    req.n_filled = n_cached
                    self._fill_cached[slot] = n_cached // ec.page_size
                    self._set_length(slot, n_cached)
                    self.filling[slot] = req
                    continue
                # room for the padded prompt, or the adopted pages plus the
                # padded suffix
                need = max(round_up(L, ec.prefill_bucket),
                           n_cached + round_up(L - n_cached,
                                               ec.prefill_bucket))
                if not self._ensure(slot, need - 1):
                    self._unadmit(slot, req)
                    if not any(self.pm.used[s] for s in self.active):
                        raise RuntimeError(
                            f"prompt needs {need // ec.page_size} pages but "
                            f"only {len(self.pm.free)} are free and no "
                            "active sequence holds any to release; raise "
                            "num_pages")
                    break
            batch.append((slot, req, n_cached))
        fresh = [(s, r) for s, r, c in batch if c == 0]
        if fresh:
            self._prefill_fresh(fresh)
        for slot, req, n_cached in batch:
            if n_cached == 0:
                continue
            # the adopted pages hold positions [0, n_cached): prefill only
            # the suffix against them, at most _SUFFIX_T_CAP tokens a call
            L = len(req.prompt)
            cap = max(ec.prefill_bucket,
                      _SUFFIX_T_CAP - _SUFFIX_T_CAP % ec.prefill_bucket)
            pos = n_cached
            while pos < L:
                t_real = min(cap, L - pos)
                toks = np.zeros((1, round_up(t_real, ec.prefill_bucket)),
                                np.int32)
                toks[0, :t_real] = req.prompt[pos:pos + t_real]
                logits = self._chunk_admit(toks, pos, slot)
                pos += t_real
            self.pm.register_prefix(slot, req.prompt,
                                    skip_pages=n_cached // ec.page_size)
            self._finish_admission(slot, req, logits[t_real - 1])

    def _prefill_fresh(self, fresh: list[tuple[int, Request]]):
        """Prefill requests with nothing cached: one ragged batch, or
        ``forward`` for a lone one; K/V go into the slots (their pages)."""
        ec = self.ec
        s_pad = round_up(max(len(r.prompt) for _, r in fresh),
                         ec.prefill_bucket)
        toks = np.zeros((len(fresh), s_pad), np.int32)
        lens = np.zeros((len(fresh),), np.int32)
        for i, (_, req) in enumerate(fresh):
            toks[i, :len(req.prompt)] = req.prompt
            lens[i] = len(req.prompt)
        toks_t = torch.from_numpy(toks).to(self.device)
        if len(fresh) > 1:
            logits, kvs = forward_ragged(
                self.params, toks_t, torch.from_numpy(lens).to(self.device),
                self.cfg)
        else:
            logits, kvs = forward(self.params, toks_t, self.cfg,
                                  return_kv=True)
        for i, (slot, req) in enumerate(fresh):
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
                self.pm.register_prefix(slot, req.prompt)
            else:
                _insert_kvs(self.caches, kvs_i, slot)
            self._finish_admission(slot, req, logits[i, L - 1])

    def _finish_admission(self, slot: int, req: Request, last_logits):
        """The draft's prefill (speculative), the first token, and the slot
        goes live."""
        L = len(req.prompt)
        if self.draft is not None:
            d_params, d_cfg = self.draft
            toks = np.zeros((1, round_up(L, self.ec.prefill_bucket)),
                            np.int32)
            toks[0, :L] = req.prompt
            _, dkvs = forward(d_params,
                              torch.from_numpy(toks).to(self.device), d_cfg,
                              return_kv=True)
            _insert_kvs(self.caches_d, dkvs, slot)
        first = self.sample_fn(last_logits, self._gen)
        self._set_length(slot, L)
        self.last_tokens[slot] = first
        req.generated.append(int(first))
        self.active[slot] = req
        self._maybe_finish(slot, int(first))

    def _advance_filling(self):
        """Advance mid-prefill slots by at most ``prefill_chunk`` prompt
        tokens in all this tick, in admission order. A request whose last
        prompt token lands this tick samples its first token and goes
        live."""
        ec = self.ec
        budget = ec.prefill_chunk
        for slot in sorted(self.filling, key=lambda s: self.filling[s].uid):
            if budget <= 0:
                break
            req = self.filling[slot]
            L = len(req.prompt)
            t_real = min(budget, L - req.n_filled)
            if req.n_filled + t_real < L:
                # not the last chunk: keep the next chunk's base on a bucket
                # boundary, as the JAX engine must for its whole-page writes
                # (what a final chunk leaves of the budget is the only way
                # here), so both engines cut a prompt at the same places
                t_real -= t_real % ec.prefill_bucket
                if t_real == 0:
                    continue  # a later slot may still fit a small last chunk
            t_pad = round_up(t_real, ec.prefill_bucket)
            if not self._ensure(slot, req.n_filled + t_pad - 1):
                continue  # pool pressure: this slot stalls a tick
            toks = np.zeros((1, t_pad), np.int32)
            toks[0, :t_real] = req.prompt[req.n_filled:req.n_filled + t_real]
            logits = self._chunk_admit(toks, req.n_filled, slot)
            req.n_filled += t_real
            budget -= t_real
            self._set_length(slot, req.n_filled)
            if req.n_filled == L:
                del self.filling[slot]
                self.pm.register_prefix(
                    slot, req.prompt,
                    skip_pages=self._fill_cached.pop(slot, 0))
                self._finish_admission(slot, req, logits[t_real - 1])

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
        submitted sequence, mid-prefill slots included. Its pages are
        released and it is requeued for recompute with its generated tokens
        folded into the prompt; on re-admission the prefill rebuilds its
        cache and sampling continues from the next position
        (``context_len`` counts from the original prompt, so its budgets are
        unaffected)."""
        pool = {**self.active, **self.filling}
        slot = max(pool, key=lambda s: pool[s].uid)
        if slot in self.filling:
            req = self.filling.pop(slot)
            req.n_filled = 0
            self._fill_cached.pop(slot, None)
        else:
            req = self.active.pop(slot)
            req.prompt = req.prompt + req.generated
        self.pm.release(slot)
        self.free.append(slot)
        self.waiting.appendleft(req)
        self.preemptions += 1

    def _grow_pages(self, ahead: int):
        """Pages for this tick's appends at positions up to hlen + ahead of
        every live slot (never past the capacity); preempt while the pool is
        dry. Returns the block table on the device, or None when nothing is
        left to step."""
        for slot in sorted(self.active):
            while (slot in self.active and not self._ensure(
                    slot, int(self._hlen[slot]) + ahead)):
                self._preempt_youngest()
        if not self.active:
            return None
        return self.pm.device_table(self.device)

    def _live_mask(self):
        live = np.zeros((self.ec.slots,), bool)
        live[list(self.active)] = True
        return live, torch.from_numpy(live).to(self.device)

    def step(self) -> dict[int, int]:
        """Admit waiting requests, advance chunked prefills, then advance
        every live slot one token (or up to 1 + spec_k tokens in speculative
        mode). Returns {uid: last new token} for this tick."""
        self._admit()
        if self.filling:
            self._advance_filling()
        if not self.active:
            return {}
        if self.draft is not None:
            return self._step_speculative()
        page_table = None
        if self.pm is not None:
            page_table = self._grow_pages(0)
            if page_table is None:
                return {}
        live, live_t = self._live_mask()
        logits, self.caches = decode_step(self.params, self.last_tokens,
                                          self.caches, self.lengths, self.cfg,
                                          page_table=page_table)
        nxt = self.sample_fn(logits, self._gen)
        # dead slots keep their length: their append lands on a position the
        # next admission's prefill overwrites (paged: on the null page 0,
        # which a released slot's table row points at, or for a filling slot
        # on the position its next chunk overwrites)
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

    def _step_speculative(self) -> dict[int, int]:
        """One speculative tick: ``spec_k`` draft proposals per slot, one
        (spec_k + 1)-token target verify, 1 + accepted tokens per live slot.
        With the greedy sampler the stream is exactly plain greedy decoding;
        with a ``make_sampler`` sampler the accept / replace rule keeps the
        target's warped distribution per position. Dead slots ride along
        with frozen lengths; their rows are never read. One transfer brings
        the accepted counts, the proposals and the next tokens to the
        host."""
        from leetcuda_tpu_torch.engine.speculative import (
            _draft_propose, decode_chunk, draft_sampler, greedy_verdict,
            speculative_verdict)

        k = self.ec.spec_k
        d_params, d_cfg = self.draft
        page_table = None
        if self.pm is not None:
            page_table = self._grow_pages(k)
            if page_table is None:
                return {}
        live, live_t = self._live_mask()
        warp = self._spec_warp
        chunk, probs = _draft_propose(
            d_params, d_cfg, self.caches_d, self.last_tokens, self.lengths,
            k, self.ec.max_seq,
            None if warp is None else draft_sampler(warp, self._gen))
        logits, self.caches = decode_chunk(self.params, chunk, self.caches,
                                           self.lengths, self.cfg,
                                           page_table=page_table)
        if warp is None:
            n_acc, new_cur = greedy_verdict(chunk, logits)
        else:
            n_acc, new_cur = speculative_verdict(
                self._gen, chunk, torch.stack(probs, dim=1), logits, warp)
        host = torch.cat([n_acc[:, None].to(torch.int32), chunk[:, 1:],
                          new_cur[:, None]], dim=1).cpu().numpy()
        n_acc_np, props_np, cur_np = host[:, 0], host[:, 1:k + 1], host[:, -1]
        self._accepted += int(n_acc_np[live].sum())
        self._proposed += int(live.sum()) * k
        self.lengths = self.lengths + torch.where(
            live_t, 1 + n_acc, 0).to(torch.int32)
        self._hlen[live] += 1 + n_acc_np[live]
        self.last_tokens = torch.where(live_t, new_cur, self.last_tokens)
        out = {}
        for slot, req in list(self.active.items()):
            for tok in (*props_np[slot, :n_acc_np[slot]], cur_np[slot]):
                req.generated.append(int(tok))
                out[req.uid] = int(tok)
                self._maybe_finish(slot, int(tok))
                if slot not in self.active:
                    break
        return out

    @property
    def acceptance_rate(self):
        """Accepted over proposed draft tokens so far (speculative mode)."""
        return self._accepted / max(self._proposed, 1)

    def stats(self) -> dict:
        """Queue depths, slot and page use and per-request progress: the
        JAX engine's keys, and beside them ``recoveries`` and, paged,
        ``free_pages`` and ``preemptions``."""
        s = {
            "waiting": len(self.waiting),
            "active": len(self.active),
            "filling": {s_: f"{r.n_filled}/{len(r.prompt)}"
                        for s_, r in self.filling.items()},
            "finished": len(self.finished),
            "free_slots": len(self.free),
            "recoveries": self.recoveries,
            "context_lens": {req.uid: req.context_len
                             for req in self.active.values()},
            "kv_memory": self.kv_memory_report(),
        }
        if self.pm is not None:
            used = sum(len(v) for v in self.pm.used.values())
            s["pages_used"] = used
            s["pages_free"] = s["free_pages"] = len(self.pm.free)
            s["page_utilization"] = used / max(used + len(self.pm.free), 1)
            s["preemptions"] = self.preemptions
            if self.pm.prefix_cache:
                s["prefix_pages_hit"] = self.pm.hits
                s["prefix_pages_prefilled"] = self.pm.misses
                s["prefix_pages_cached"] = len(self.pm.trie)
        return s

    def kv_memory_report(self) -> dict:
        """Bytes held by the KV cache or page pools, scales included, and in
        speculative mode by the draft's plain cache, also as a fraction of
        the target's: small for a small draft beside a large target, near 1
        or above for models of one size (the trigger to page or quantize
        the draft too)."""
        def nbytes(caches):
            return int(sum(t.nbytes for c in caches for t in c.values()))

        rep = {"target_bytes": nbytes(self.caches)}
        if self.draft is not None:
            rep["draft_bytes"] = nbytes(self.caches_d)
            rep["draft_frac_of_target"] = round(
                rep["draft_bytes"] / max(rep["target_bytes"], 1), 3)
        return rep

    def recover(self):
        """Drop all device state (pages and the draft's cache included) and
        requeue every in-flight request for recompute: generated tokens fold
        into the prompts, so each request still emits exactly its remaining
        tokens."""
        for req in self.active.values():
            req.prompt = req.prompt + req.generated
            self.waiting.appendleft(req)
        for req in self.filling.values():
            req.n_filled = 0
            self.waiting.appendleft(req)
        self.active.clear()
        self.filling.clear()
        self._fill_cached.clear()
        self.free = list(range(self.ec.slots))
        self.recoveries += 1
        self._reset_device_state()

    def run(self, prompts: list[list[int]], max_new: int = 64,
            max_recoveries: int = 2) -> dict[int, list[int]]:
        """Submit all prompts, run to completion, return {uid: generated}.
        A kernel launch that CUDA refused (``KernelLaunchError``) triggers
        recover() up to ``max_recoveries`` times before re-raising. Three
        ticks in a row that decode nothing, fill nothing and admit nothing
        while a prefill is in flight raise: the pool is too small."""
        uids = [self.submit(p, max_new) for p in prompts]
        failures = stalls = 0

        def mark():
            return (len(self.waiting),
                    sum(r.n_filled for r in self.filling.values()),
                    len(self.active))

        while self.waiting or self.active or self.filling:
            before = mark()
            try:
                out = self.step()
            except KernelLaunchError:
                failures += 1
                if failures > max_recoveries:
                    raise
                self.recover()
                continue
            stalls = stalls + 1 if (not out and self.filling
                                    and before == mark()) else 0
            if stalls > 2:
                raise RuntimeError(
                    "chunked prefill stalled: page pool too small for the "
                    "in-flight prefills; raise num_pages")
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
