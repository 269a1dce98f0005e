"""Grouped matmul (gmm): variable-size expert GEMMs in one kernel launch.

Counterpart of ``leetcuda_tpu/gemm/grouped.py``. MoE's compute pattern: the
rows of ``lhs`` are grouped by expert, contiguously, each group multiplying
its own ``rhs[g]``. Group boundaries are aligned to the row tile ``bm``, and
``tile_group[i]`` names the expert of row tile i (``tile_groups_from_sizes``
computes it on the device from the padded group sizes), so::

    out[i bm : (i + 1) bm] = lhs[i bm : (i + 1) bm] @ rhs[tile_group[i]]

summed in f32 and rounded once to lhs's dtype. ``make_gmm(block=(bm, bn,
bk))`` takes the JAX signature: ``bm`` is the row tile and is semantic;
``bn`` and ``bk`` are the TPU kernel's VMEM tiling and do not carry over
(the CUDA kernel's tile is its own, ``csrc/gmm.cu``).

On CUDA tensors the function launches ``csrc/gmm.cu``, which reads
``tile_group`` on the device (no host sync); on CPU tensors it runs the
plain version, one ``torch.matmul`` per expert present. An expert id outside
[0, G) gives NaN rows in both, where the TPU kernel would read past rhs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch

GMM = LaunchCounter("gmm")
# lc_gmm(lhs, rhs, tile_group, out, T, K, N, G, bm, dtype, stream)
_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def gmm_plain(lhs, rhs, tile_group, bm: int = 128):
    """Row tile i of lhs @ rhs[tile_group[i]] in f32, one rounding to lhs's
    dtype: one product per expert present, over its tiles' rows. Reads
    ``tile_group`` on the host."""
    T, K = lhs.shape
    G, _, N = rhs.shape
    tiles = tile_group.long()
    rows = tiles.repeat_interleave(bm)  # the expert of every row
    out = torch.full((T, N), float("nan"), dtype=torch.float32,
                     device=lhs.device)
    for g in torch.unique(tiles).tolist():
        if 0 <= g < G:
            idx = (rows == g).nonzero()[:, 0]
            out[idx] = lhs[idx].float() @ rhs[g].float()
    return out.to(lhs.dtype)


gmm_tile_ref = gmm_plain  # the registry's oracle (JAX's name)


def gmm_ref(lhs, rhs, group_sizes):
    """Oracle over host group sizes: group g's rows @ rhs[g], concatenated."""
    out, o = [], 0
    for g, s in enumerate(np.asarray(group_sizes).tolist()):
        out.append((lhs[o:o + s].float() @ rhs[g].float()).to(lhs.dtype))
        o += s
    return torch.cat(out, dim=0)


def pad_group_sizes(group_sizes, bm: int):
    """Each group's row count rounded up to a multiple of ``bm``."""
    return (group_sizes + bm - 1) // bm * bm


def tile_groups_from_sizes(padded_sizes, bm: int, num_tiles: int):
    """(G,) bm-aligned sizes -> (num_tiles,) int32 expert id of each row
    tile, on the sizes' device; tiles past the last group get G."""
    ends = torch.cumsum(padded_sizes // bm, dim=0)
    tiles = torch.arange(num_tiles, device=padded_sizes.device,
                         dtype=ends.dtype)
    return torch.searchsorted(ends, tiles, right=True).to(torch.int32)


def _launch(lhs, rhs, tile_group, bm):
    from leetcuda_tpu_torch.build import kernel

    T, K = lhs.shape
    G, _, N = rhs.shape
    out = torch.empty((T, N), dtype=lhs.dtype, device=lhs.device)
    err = kernel("gmm", "lc_gmm", _ARGS)(
        lhs.data_ptr(), rhs.data_ptr(), tile_group.data_ptr(),
        out.data_ptr(), T, K, N, G, bm, _DTYPES[lhs.dtype],
        torch.cuda.current_stream(lhs.device).cuda_stream)
    check_launch(err, GMM.name)
    GMM.add()
    return out


def make_gmm(*, block: tuple[int, int, int] = (128, 128, 512)):
    """gmm(lhs (T, K), rhs (G, K, N), tile_group (T / bm,)) -> (T, N), with
    ``bm = block[0]``. Every row tile lies inside one group."""
    bm = int(block[0])
    if bm <= 0:
        raise ValueError(f"gmm: the row tile must be positive, got {bm}")

    def fn(lhs, rhs, tile_group):
        if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] != rhs.shape[1]:
            raise ValueError(f"gmm takes lhs (T, K) and rhs (G, K, N), got "
                             f"{tuple(lhs.shape)}, {tuple(rhs.shape)}")
        T = lhs.shape[0]
        if T % bm or tuple(tile_group.shape) != (T // bm,):
            raise ValueError(f"gmm: T = {T} must be a multiple of bm = {bm} "
                             f"and tile_group of shape ({T // bm},), got "
                             f"{tuple(tile_group.shape)}")
        if lhs.dtype != rhs.dtype or lhs.dtype not in _DTYPES:
            raise ValueError(f"gmm takes lhs and rhs of one dtype among f32, "
                             f"f16, bf16; got {lhs.dtype}, {rhs.dtype}")
        if not lhs.device == rhs.device == tile_group.device:
            raise ValueError("gmm: lhs, rhs and tile_group must lie on one "
                             "device")
        if lhs.device.type == "cpu":
            return gmm_plain(lhs, rhs, tile_group, bm)
        if tile_group.dtype != torch.int32:
            raise ValueError(f"gmm kernel: tile_group must be int32, got "
                             f"{tile_group.dtype}")
        for name, t in (("lhs", lhs), ("rhs", rhs), ("tile_group",
                                                     tile_group)):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"gmm kernel: {name} must be contiguous "
                                 "and 16-byte aligned")
        return _launch(lhs, rhs, tile_group, bm)

    return fn


register_op(
    # the MoE dropless workhorse (models/moe.py moe_ffn_dropless): each row
    # tile reads its own expert's panel, its id read on the device
    "grouped_gemm_scalar_prefetch",
    ref=gmm_tile_ref,
    flops=lambda lhs, rhs, tg: float(2 * lhs.shape[0] * lhs.shape[1]
                                     * rhs.shape[2]),
    atol=2e-2, rtol=2e-2,
    family="gemm-grouped", tags=("bf16", "moe"),
)(make_gmm(block=(128, 128, 512)))
