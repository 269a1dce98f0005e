"""Embedding gather: ``table[clip(idx, 0, V - 1)]``, idx (S,) int32 or int64.

Counterpart of ``leetcuda_tpu/ops/embedding.py`` (``make_embedding``,
``make_embedding_tiled``, ``to_serving_layout``, ``embedding_serving``,
``embedding_ref`` and the 8 registrations). On CUDA tensors the wrappers
launch ``lc_embedding`` of ``csrc/embedding.cu`` and return a new tensor;
on CPU tensors they run ``embedding_plain``. Ids are clamped to the table,
as the Pallas kernels clamp them; JAX's oracle (a ``jnp.take``) does not,
and agrees with them only for ids in range.

``tokens_per_step`` is the TPU's DMA depth and is accepted and ignored; so
is JAX's ``V % 8`` requirement (HBM tiling). A rung is the width of the
words a thread copies (``WORD``): 4 bytes for ``f32``, 2 for ``f16``, 4 for
the unpacked ``f16x8`` (the reference's half2), 16 for the ``x4`` / ``x8``
pack rungs and the serving-layout rungs. The serving layout (V, D / 128,
128) is a view of the row-major (V, D) table, the same bytes, so the tiled
factory is the same kernel on that view.
"""

from __future__ import annotations

import ctypes
import math

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch

EMBEDDING = LaunchCounter("embedding")
EMBEDDING_TILED = LaunchCounter("embedding_tiled")
LANES = 128  # the serving layout's last dim (JAX's L)
# bytes a thread copies at a time, by registered rung of make_embedding
# (the serving-layout rungs copy 16)
WORD = {"f32": 4, "f32x4": 16, "f32x4_pack": 16, "f16": 2, "f16x8": 4,
        "f16x8_pack": 16}
# lc_embedding(idx, idx64, table, out, S, V, row_bytes, word, stream)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _I, _P, _P, _I, _L, _L, _I, _P)


def embedding_plain(idx, table):
    """The rows of ``table`` (V, ...) at ``idx`` (S,), each id clamped to
    [0, V - 1]: (S, ...)."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


embedding_ref = embedding_plain


def _check_ids(idx, table):
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"embedding: idx must be (S,) int32 or int64, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != table.device:
        raise ValueError("embedding: idx and table must lie on one device")


def _launch(idx, table, word, counter):
    """Gather on the card: every row of ``table`` (V, ...) is one copy of
    its bytes, in words of up to ``word`` bytes."""
    from leetcuda_tpu_torch.build import kernel

    if not (idx.is_contiguous() and table.is_contiguous()):
        raise ValueError("embedding kernel: idx and table must be "
                         "contiguous")
    S, V = idx.shape[0], table.shape[0]
    out = torch.empty((S, *table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    row_bytes = math.prod(table.shape[1:]) * table.element_size()
    if S == 0 or row_bytes == 0:
        return out
    if V == 0:
        raise ValueError("embedding kernel: the table has no rows")
    while word > 1 and (row_bytes % word or table.data_ptr() % word
                        or out.data_ptr() % word):
        word //= 2
    fn = kernel("embedding", "lc_embedding", _ARGS)
    err = fn(idx.data_ptr(), int(idx.dtype == torch.int64), table.data_ptr(),
             out.data_ptr(), S, V, row_bytes, word,
             torch.cuda.current_stream(table.device).cuda_stream)
    check_launch(err, counter.name)
    counter.add()
    return out


def make_embedding(*, tokens_per_step: int = 8, word: int = 16):
    """embedding(idx, table): idx (S,) int32 or int64, table (V, D) ->
    (S, D), rows copied in words of up to ``word`` bytes on the card."""

    def fn(idx, table):
        _check_ids(idx, table)
        if table.dim() != 2:
            raise ValueError(f"embedding: table must be (V, D), got "
                             f"{tuple(table.shape)}")
        if table.device.type == "cpu":
            return embedding_plain(idx, table)
        return _launch(idx, table, word, EMBEDDING)

    return fn


def to_serving_layout(table):
    """(V, D) -> (V, D // 128, 128), JAX's serving layout: a view of the
    same bytes (row-major memory has no tiles to relayout)."""
    V, D = table.shape
    if D % LANES:
        raise ValueError(f"the serving layout needs D % {LANES} == 0, got "
                         f"D = {D}")
    return table.view(V, D // LANES, LANES)


def make_embedding_tiled(*, tokens_per_step: int = 256):
    """embedding(idx, table3d): idx (S,), table3d (V, D / 128, 128) in the
    serving layout (``to_serving_layout``) -> (S, D / 128, 128)."""

    def fn(idx, table):
        _check_ids(idx, table)
        if table.dim() != 3 or table.shape[2] != LANES:
            raise ValueError(f"embedding (tiled): table must be (V, G, "
                             f"{LANES}), got {tuple(table.shape)}")
        if table.device.type == "cpu":
            return embedding_plain(idx, table)
        return _launch(idx, table, 16, EMBEDDING_TILED)

    return fn


_embedding_tiled_default = make_embedding_tiled()


def embedding_serving(idx, table):
    """2-D table in, 2-D rows out, through the serving layout."""
    S, D = idx.shape[0], table.shape[1]
    return _embedding_tiled_default(idx, to_serving_layout(table)).reshape(
        S, D)


def _emb_bytes(idx, table):
    return float(2 * idx.shape[0] * table.shape[1] * table.element_size())


def _emb3_bytes(idx, table):
    return float(2 * idx.shape[0] * table.shape[1] * table.shape[2]
                 * table.element_size())


for _suffix, _tb in [("f32", 8), ("f32x4", 16), ("f32x4_pack", 32),
                     ("f16", 8), ("f16x8", 16), ("f16x8_pack", 32)]:
    register_op(
        f"embedding_{_suffix}",
        ref=embedding_ref, bytes=_emb_bytes,
        atol=0.0, rtol=0.0, family="embedding", tags=(_suffix,),
    )(make_embedding(tokens_per_step=_tb, word=WORD[_suffix]))

for _suffix, _tb in [("f32_tiled", 256), ("bf16_tiled", 256)]:
    register_op(
        f"embedding_{_suffix}",
        ref=embedding_ref, bytes=_emb3_bytes,
        atol=0.0, rtol=0.0, family="embedding", tags=(_suffix, "tiled"),
    )(make_embedding_tiled(tokens_per_step=_tb))

embedding = make_embedding()
