"""Paged KV-cache decode attention and the host-side page allocator.

Counterpart of ``leetcuda_tpu/attention/paged.py``. K/V live in a global
pool of fixed-size pages, ``k_pages`` / ``v_pages`` (num_pages, Hkv, page,
D), bf16 or quantized (int8 / float8_e4m3fn with f32 scale pools
(num_pages, Hkv, page)). Each sequence owns a row of the block table,
``page_table`` (B, P_max) int32, mapping its logical page i to a physical
page; ``lengths`` (B,) int32 counts its valid positions. Table entries past
a sequence's last page are filler (0, the reserved null page) and, like
positions at or past the length inside the last page, are never read.

``shared_kv`` takes JAX's calling forms: ``paged_attention(q, pages,
page_table, lengths)`` and ``paged_attention_quantized(q, pages, scales,
page_table, lengths)``, one pool (and one scale pool) read as both K and V:
MLA's paged latent cache (models/mla.py ``init_paged_latent_cache``, (N, 1,
page, d_c + d_r)). A shared launch counts on its own counter
(``paged_attention_shared``, ``paged_attention_quantized_shared``, with
``_lse`` where the lse is asked for).

On CUDA tensors ``paged_attention`` and ``paged_attention_quantized``
launch the split-KV kernel of ``csrc/decode_attn.cu`` in its paged
addressing (attention/decode.py ``launch``: every head dim, group and q
type, any page size, one launch a call) and raise on what it does not take.
On CPU tensors they run the plain versions below: gather each row's pages
through the table into a contiguous view, then the plain decode attention.
The TPU kernel's ``pages_per_step`` is DMA tiling and has no counterpart.
``window`` and ``softcap`` are decode attention's (attention/decode.py):
the kernel looks up no page wholly before the window and reads no position
before it, and ``with_lse`` its (B, H) f32 log-sum-exp beside the output
(its own counters, ``paged_attention_lse`` and
``paged_attention_quantized_lse``).

``paged_append`` and ``paged_append_quantized`` write IN PLACE and return
the pools they were given. ``PageManager`` is the JAX package's allocator,
prefix trie included, as it is host code.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from leetcuda_tpu_torch.attention.decode import (_check_kernel_args,
                                                 _operands, _outputs,
                                                 attend_plain, counter,
                                                 launch)
from leetcuda_tpu_torch.attention.flash import attn_options
from leetcuda_tpu_torch.core.runtime import (LaunchCounter, as_bytes,
                                             check_launch)

PAGED = LaunchCounter("paged_attention")
PAGED_Q = LaunchCounter("paged_attention_quantized")
PAGED_LSE = LaunchCounter("paged_attention_lse")
PAGED_Q_LSE = LaunchCounter("paged_attention_quantized_lse")
PAGED_SHARED = LaunchCounter("paged_attention_shared")
PAGED_Q_SHARED = LaunchCounter("paged_attention_quantized_shared")
PAGED_SHARED_LSE = LaunchCounter("paged_attention_shared_lse")
PAGED_Q_SHARED_LSE = LaunchCounter("paged_attention_quantized_shared_lse")

_PAGED_NAMES = ("k_pages", "v_pages", "page_table", "lengths")
_PAGED_Q_NAMES = ("k_pages", "v_pages", "k_scales", "v_scales", "page_table",
                  "lengths")


def _gather(pool, page_table):
    """A pool (N, Hkv, page[, D]) as each row's contiguous cache
    (B, Hkv, P_max * page[, D]), through the table."""
    g = as_bytes(pool)[page_table.long()]        # (B, P_max, Hkv, page[, D])
    g = g.transpose(1, 2)
    g = g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])
    return g.view(pool.dtype)


def _attend_pools(q, k_pages, v_pages, k_scales, v_scales, page_table,
                  lengths, **kw):
    """Gather, then ``attend_plain`` (which masks everything outside the
    attended positions, NaN included); a shared pool is gathered once."""
    k = _gather(k_pages, page_table)
    v = k if v_pages is k_pages else _gather(v_pages, page_table)
    ks = vs = None
    if k_scales is not None:
        ks = _gather(k_scales, page_table)
        vs = ks if v_scales is k_scales else _gather(v_scales, page_table)
    return attend_plain(q, k, v, lengths, k_scale=ks, v_scale=vs, **kw)


def paged_attention_plain(q, *args, sm_scale=None, window=None, softcap=None,
                          with_lse=False, shared_kv=False):
    """Plain PyTorch version of ``paged_attention``: (q, k_pages, v_pages,
    page_table, lengths), or with ``shared_kv`` (q, pages, page_table,
    lengths)."""
    kp, vp, table, lengths = _operands("paged_attention_plain", args,
                                       _PAGED_NAMES, shared_kv)
    return _attend_pools(q, kp, vp, None, None, table, lengths,
                         sm_scale=sm_scale, window=window, softcap=softcap,
                         with_lse=with_lse)


def paged_attention_quantized_plain(q, *args, sm_scale=None, window=None,
                                    softcap=None, with_lse=False,
                                    shared_kv=False):
    """Plain PyTorch version over quantized pools and their scale pools:
    (q, k_pages, v_pages, k_scales, v_scales, page_table, lengths), or with
    ``shared_kv`` (q, pages, scales, page_table, lengths)."""
    kp, vp, ks, vs, table, lengths = _operands(
        "paged_attention_quantized_plain", args, _PAGED_Q_NAMES, shared_kv)
    return _attend_pools(q, kp, vp, ks, vs, table, lengths,
                         sm_scale=sm_scale, window=window, softcap=softcap,
                         with_lse=with_lse)


def _check(q, k_pages, v_pages, page_table, lengths):
    """The shapes and devices both paged wrappers check."""
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"q (B,H,D), pools (N,Hkv,page,D): got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, H, D = q.shape
    Hkv = k_pages.shape[1]
    if k_pages.shape[3] != D or H % Hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} / pools "
                         f"{tuple(k_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"page_table (B, P_max) and lengths (B,): got "
                         f"{tuple(page_table.shape)}, {tuple(lengths.shape)}")
    if not (q.device == k_pages.device == v_pages.device
            == page_table.device == lengths.device):
        raise ValueError("q, pools, page_table and lengths must lie on one "
                         "device")


def _check_paged_kernel_args(q, page_table, lengths, tensors):
    """What the paged kernels take beyond ``_check_kernel_args``: a
    contiguous int32 table and pools the kernel's 32-bit row index and
    position count can address."""
    _check_kernel_args(q, lengths, tensors)
    N, Hkv, page, _ = tensors["k_cache"].shape
    if page_table.dtype != torch.int32 or not page_table.is_contiguous():
        raise ValueError("page_table must be a contiguous int32 tensor")
    if N * Hkv * page >= 2 ** 32 or page_table.shape[1] * page >= 2 ** 31:
        raise ValueError(f"paged kernel: pool of {N * Hkv * page} rows or "
                         f"{page_table.shape[1] * page} positions per "
                         "sequence is too large")


def paged_attention(q, *args, sm_scale=None, window=None, softcap=None,
                    with_lse=False, shared_kv=False):
    """paged_attention(q (B, H, D), k_pages, v_pages (N, Hkv, page, D),
    page_table (B, P_max) int32, lengths (B,) int32), or with ``shared_kv``
    paged_attention(q, pages, page_table, lengths) -> (B, H, D), or with
    ``with_lse`` (out, lse (B, H) f32)."""
    k_pages, v_pages, page_table, lengths = _operands(
        "paged_attention", args, _PAGED_NAMES, shared_kv)
    _check(q, k_pages, v_pages, page_table, lengths)
    window, softcap = attn_options(window, softcap)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[2])
    kw = dict(sm_scale=scale, window=window, softcap=softcap,
              with_lse=with_lse)
    if q.device.type == "cpu":
        return _attend_pools(q, k_pages, v_pages, None, None, page_table,
                             lengths, **kw)

    _check_paged_kernel_args(q, page_table, lengths,
                             dict(k_cache=k_pages, v_cache=v_pages))
    if k_pages.dtype != torch.bfloat16 or v_pages.dtype != torch.bfloat16:
        raise ValueError(f"paged kernel takes bf16 pools, got "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    out, lse = _outputs(q, with_lse)
    count = counter("paged_attention", shared_kv, with_lse)
    check_launch(launch(q, k_pages, v_pages, None, None, page_table, lengths,
                        out, lse, scale=scale, window=window,
                        softcap=softcap), count.name)
    count.add()
    return (out, lse) if with_lse else out


def paged_attention_quantized(q, *args, sm_scale=None, window=None,
                              softcap=None, with_lse=False, shared_kv=False):
    """paged_attention_quantized(q, k_pages, v_pages, k_scales, v_scales,
    page_table, lengths), or with ``shared_kv`` (q, pages, scales,
    page_table, lengths): int8 or float8_e4m3fn pools with f32 scale pools
    (N, Hkv, page) -> (B, H, D) in q's dtype (bf16, or f32 as MLA's
    absorbed query), or with ``with_lse`` (out, lse (B, H) f32)."""
    k_pages, v_pages, k_scales, v_scales, page_table, lengths = _operands(
        "paged_attention_quantized", args, _PAGED_Q_NAMES, shared_kv)
    _check(q, k_pages, v_pages, page_table, lengths)
    window, softcap = attn_options(window, softcap)
    if k_scales.shape != k_pages.shape[:3] \
            or v_scales.shape != k_pages.shape[:3]:
        raise ValueError(f"scale pools must be (N, Hkv, page) = "
                         f"{tuple(k_pages.shape[:3])}, got "
                         f"{tuple(k_scales.shape)}, {tuple(v_scales.shape)}")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in (
            torch.int8, torch.float8_e4m3fn):
        raise ValueError(f"quantized pools must both be int8 or e4m3, got "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    if not (k_scales.device == v_scales.device == q.device):
        raise ValueError("scale pools must lie on q's device")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[2])
    kw = dict(sm_scale=scale, window=window, softcap=softcap,
              with_lse=with_lse)
    if q.device.type == "cpu":
        return _attend_pools(q, k_pages, v_pages, k_scales, v_scales,
                             page_table, lengths, **kw)

    _check_paged_kernel_args(q, page_table, lengths,
                             dict(k_cache=k_pages, v_cache=v_pages,
                                  k_scale=k_scales, v_scale=v_scales))
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise ValueError("quantized paged kernel takes f32 scale pools")
    out, lse = _outputs(q, with_lse)
    count = counter("paged_attention_quantized", shared_kv, with_lse)
    check_launch(launch(q, k_pages, v_pages, k_scales, v_scales, page_table,
                        lengths, out, lse, scale=scale, window=window,
                        softcap=softcap), count.name)
    count.add()
    return (out, lse) if with_lse else out


def _write_token(pools_and_values, page_table, lengths):
    """``pool[phys[b], :, offs[b]] = value[b]`` for each (pool, value)
    pair, where position ``lengths[b]`` of row b lies at offset ``offs[b]``
    of physical page ``phys[b]``."""
    page = pools_and_values[0][0].shape[2]
    pos = lengths.long()
    bidx = torch.arange(pos.shape[0], device=pos.device)
    phys, offs = page_table[bidx, pos // page].long(), pos % page
    for pool, value in pools_and_values:
        as_bytes(pool)[phys, :, offs] = as_bytes(value.to(pool.dtype))


def paged_append(k_pages, v_pages, k, v, page_table, lengths):
    """Append one token's k/v (B, Hkv, D) at each sequence's current
    position, IN PLACE; returns (k_pages, v_pages). The caller must have
    allocated the page that holds position ``lengths[b]`` already
    (``PageManager.ensure``). Rows whose table entry is the null page 0
    (released slots) all write there, in no defined order: nothing reads
    page 0 for a live row."""
    _write_token(((k_pages, k), (v_pages, v)), page_table, lengths)
    return k_pages, v_pages


def paged_append_quantized(k_pages, v_pages, k_scales, v_scales, kq, vq, ks,
                           vs, page_table, lengths):
    """Quantized paged append, IN PLACE: values (B, Hkv, D) already
    quantized, with their scales (B, Hkv). Returns the four pools."""
    _write_token(((k_pages, kq), (v_pages, vq), (k_scales, ks),
                  (v_scales, vs)), page_table, lengths)
    return k_pages, v_pages, k_scales, v_scales


class PageManager:
    """Host-side physical-page allocator for the paged cache.

    Page 0 is reserved as the null page (block-table filler), so fresh table
    entries are always valid physical indices.

    With ``prefix_cache=True`` the manager also keeps a refcounted prefix
    trie: full pages of a finished-prefill prompt are registered keyed by
    (parent page, that page's tokens), so a later request whose prompt starts
    with the same page chain ADOPTS the physical pages (refcount++) and only
    its suffix needs prefilling (valid because the chain always starts at
    position 0, so the cached post-rope K/V has the right absolute
    positions). Pages whose refcount drops to 0 stay in the trie on a
    reclaimable LRU list and are evicted only when the free pool runs dry."""

    def __init__(self, num_pages: int, page_size: int, max_pages_per_seq: int,
                 n_slots: int, prefix_cache: bool = False):
        self.page_size = page_size
        self.free = list(range(num_pages - 1, 0, -1))  # pool; 0 reserved
        self.table = np.zeros((n_slots, max_pages_per_seq), np.int32)
        self.used: dict[int, list[int]] = {i: [] for i in range(n_slots)}
        self.prefix_cache = prefix_cache
        # trie: (parent_uid or -1, tokens tuple) -> page id. Keys chain by
        # UID, not physical id: physical ids are reused after eviction, and a
        # stale child keyed by a reused parent id would match wrong content.
        # A uid is never reused, so orphaned children become unreachable (and
        # their pages drain via the reclaimable LRU). trie_inv: page -> key;
        # page_uid: page -> uid; refs: refcount; reclaimable: LRU of
        # refcount-0 cached pages.
        self.trie: dict[tuple, int] = {}
        self.trie_inv: dict[int, tuple] = {}
        self.page_uid: dict[int, int] = {}
        self._next_uid = 0
        self.refs: dict[int, int] = {}
        self.reclaimable: dict[int, None] = {}  # ordered set (LRU)
        self.hits = self.misses = 0  # pages adopted / prefilled

    def _alloc(self) -> int | None:
        if self.free:
            return self.free.pop()
        if self.reclaimable:  # evict the LRU cached-but-unreferenced page
            p = next(iter(self.reclaimable))
            del self.reclaimable[p]
            key = self.trie_inv.pop(p)
            del self.trie[key]
            self.page_uid.pop(p, None)
            self.refs.pop(p, None)
            return p
        return None

    def ensure(self, slot: int, length: int) -> bool:
        """Make sure pages cover positions [0, length]; returns False when
        the pool is exhausted."""
        need = length // self.page_size + 1
        while len(self.used[slot]) < need:
            p = self._alloc()
            if p is None:
                return False
            self.refs[p] = self.refs.get(p, 0) + 1
            self.table[slot, len(self.used[slot])] = p
            self.used[slot].append(p)
        return True

    def release(self, slot: int):
        for p in reversed(self.used[slot]):
            n = self.refs.get(p, 1) - 1
            if n > 0:
                self.refs[p] = n
            elif p in self.trie_inv:   # cached: keep, reclaimable
                self.refs[p] = 0
                self.reclaimable[p] = None
            else:                      # private page: straight back to pool
                self.refs.pop(p, None)
                self.free.append(p)
        self.used[slot] = []
        self.table[slot] = 0

    # --- prefix caching -------------------------------------------------------

    def match_prefix(self, tokens: list[int], ns: int = 0) -> list[int]:
        """Longest cached chain of FULL pages covering a strict prefix of
        ``tokens`` (at least one token is always left to prefill so admission
        has logits to sample from). Returns the physical page ids.

        ``ns`` namespaces the chain root (multi-LoRA serving: adapted wk/wv
        make KV adapter-specific, so chains must never cross adapters).
        Roots are -1 - ns: negative, so they cannot collide with page uids."""
        if not self.prefix_cache:
            return []
        pages = []
        parent = -1 - ns
        ps = self.page_size
        # strict prefix: the last token never comes from the cache
        max_full = (len(tokens) - 1) // ps
        for i in range(max_full):
            key = (parent, tuple(tokens[i * ps:(i + 1) * ps]))
            p = self.trie.get(key)
            if p is None:
                break
            pages.append(p)
            parent = self.page_uid[p]
        return pages

    def adopt(self, slot: int, pages: list[int]):
        """Attach cached prefix pages to a slot (refcount++)."""
        if self.used[slot]:
            raise ValueError(f"adopt: slot {slot} already holds pages")
        for i, p in enumerate(pages):
            self.refs[p] = self.refs.get(p, 0) + 1
            if self.refs[p] == 1:
                self.reclaimable.pop(p, None)
            self.table[slot, i] = p
            self.used[slot].append(p)
        self.hits += len(pages)

    def register_prefix(self, slot: int, tokens: list[int],
                        skip_pages: int = 0, ns: int = 0):
        """After prefill: publish the slot's full prompt pages into the trie
        (idempotent; pages already cached, e.g. adopted, are skipped via
        ``skip_pages``). ``ns`` must match the match_prefix namespace."""
        if not self.prefix_cache:
            return
        ps = self.page_size
        parent = (self.page_uid[self.used[slot][skip_pages - 1]]
                  if skip_pages else -1 - ns)
        n_full = len(tokens) // ps
        for i in range(skip_pages, n_full):
            p = self.used[slot][i]
            key = (parent, tuple(tokens[i * ps:(i + 1) * ps]))
            if key in self.trie:
                # chain continues through the canonical page for this key
                parent = self.page_uid[self.trie[key]]
            elif p not in self.trie_inv:
                self.trie[key] = p
                self.trie_inv[p] = key
                self.page_uid[p] = self._next_uid
                parent = self._next_uid
                self._next_uid += 1
                self.misses += 1  # a page published fresh: pages that chain
                # through existing canonical entries or hit the break below
                # were never prefilled anew
            else:
                break  # p already cached under another chain; stop publishing

    def device_table(self, device) -> torch.Tensor:
        """The block table as an int32 tensor on ``device``: a fresh copy
        at every call, so it never goes stale after ``ensure`` / ``release``."""
        return torch.tensor(self.table, dtype=torch.int32, device=device)
