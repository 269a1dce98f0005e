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
(the CUDA kernel's tiles are its own, ``csrc/gmm.cu``).

On CUDA tensors the function launches ``csrc/gmm.cu``, which reads
``tile_group`` on the device (no host sync), by one of two routes that
``gmm_plan`` picks: ``wgmma`` (f16 / bf16, ``bm`` a multiple of 64, K and N
multiples of 8: the persistent TMA + wgmma kernel, counted on ``gmm``) or
``tile`` (every other call: the old mma.sync / CUDA-core tiles, counted on
``gmm_tile``). On CPU tensors it runs the plain version, one
``torch.matmul`` per expert present. An expert id outside [0, G) gives NaN
rows in all three, where the TPU kernel would read past rhs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import (SM_COUNT, LaunchCounter, cdiv,
                                             check_launch)

GMM = LaunchCounter("gmm")  # the wgmma route
GMM_TILE = LaunchCounter("gmm_tile")  # the tile route
# lc_gmm(lhs, rhs, tile_group, out, T, K, N, G, bm, dtype, stream);
# lc_gmm_sm90(lhs, rhs, tile_group, out, T, K, N, G, bm, dtype, tile, grid,
#             stream); lc_gmm_sm90_info(tile, int info[7])
_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_SM90_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8
              + (ctypes.c_void_p,))
_INFO_ARGS = (ctypes.c_int, ctypes.c_void_p)
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# The wgmma route's tiles in csrc/gmm.cu (Wg128, Wg64): (block_m, block_n)
# -> the source's tile id, 64-deep stages, CTAs an SM. A tile's block_m
# divides bm, so a tile lies in one row tile: 128 where bm is a multiple of
# 128, else 64. No CTA pairs: two row tiles may belong to two experts. The
# 128-row tile's width and the walk (N fastest within a row tile, an
# expert's row tiles adjacent) won bench/gemm_bench.py --gmm's A/B at path
# (n)'s four products (NVIDIA H100 80GB HBM3, 700 W; PERF.md row 19): 256
# was 3-9% faster than 128 at three of them and 2% slower at the prefill
# gate; a tile column at a time was 21-51% slower.
GMM_TILES = {
    (128, 256): {"tile": 0, "block_k": 64, "stages": 3, "per_sm": 1},
    (64, 128): {"tile": 1, "block_k": 64, "stages": 3, "per_sm": 2},
}


def gmm_route(dtype, bm: int, K: int, N: int) -> str:
    """"wgmma" where the TMA + wgmma kernel takes the call (f16 / bf16,
    ``bm`` a multiple of 64, K and N multiples of 8: a tensor map's rows
    are multiples of 16 bytes), else "tile"."""
    ok = (dtype in (torch.float16, torch.bfloat16) and bm % 64 == 0
          and K % 8 == 0 and N % 8 == 0)
    return "wgmma" if ok else "tile"


def gmm_tile_key(bm: int):
    """The wgmma route's tile for row tiles of ``bm``: (128, 256) where 128
    divides bm, else (64, 128)."""
    return (128, 256) if bm % 128 == 0 else (64, 128)


def _units_grid(T: int, N: int, block_m: int, block_n: int, ctas: int):
    """(row blocks, column blocks, units, grid) of a wgmma launch: every
    unit computed, at most ``ctas`` CTAs, none without a unit."""
    row_blocks, col_blocks = T // block_m, cdiv(N, block_n)
    units = row_blocks * col_blocks
    return row_blocks, col_blocks, units, min(ctas, units)


def gmm_plan(T: int, K: int, N: int, bm: int, dtype=torch.bfloat16,
             ctas: int | None = None) -> dict:
    """One launch of csrc/gmm.cu for lhs (T, K), rhs (G, K, N) and row
    tiles of ``bm``: the route and, on the wgmma route, the tile
    (``block_m`` x ``block_n``, ``gmm_tile_key``), its ``units`` (row
    blocks by column blocks, every one computed) and the ``grid`` (at most
    ``ctas``, the co-resident count: by default ``per_sm`` an SM of the
    H100's 132, none without a unit)."""
    route = gmm_route(dtype, bm, K, N)
    if route == "tile":
        return {"route": route, "grid": (T // bm) * cdiv(bm, 128)
                * cdiv(N, 128)}
    key = gmm_tile_key(bm)
    t = GMM_TILES[key]
    row_blocks, col_blocks, units, grid = _units_grid(
        T, N, *key, t["per_sm"] * SM_COUNT if ctas is None else ctas)
    return {"route": route, "block_m": key[0], "block_n": key[1], **t,
            "row_blocks": row_blocks, "col_blocks": col_blocks,
            "units": units, "grid": grid}


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


_SM90_INFO: dict = {}


def sm90_build_info(tile_key, device, lib="gmm"):
    """(tile, co-resident CTAs) of the wgmma ``tile_key`` on ``device``,
    read once from ``lib``'s ``lc_gmm_sm90_info`` (``lib`` csrc/gmm.cu's
    name, or a variant build of the bench's A/B); the package's build must
    match GMM_TILES and walk with group 0."""
    key = (tile_key, device.index, lib if isinstance(lib, str) else id(lib))
    got = _SM90_INFO.get(key)
    if got is None:
        from leetcuda_tpu_torch.build import entry

        info = (ctypes.c_int * 7)()
        with torch.cuda.device(device):
            check_launch(entry(lib, "lc_gmm_sm90_info", _INFO_ARGS)(
                GMM_TILES[tile_key]["tile"], ctypes.addressof(info)),
                GMM.name)
        tile = dict(zip(("block_m", "block_n", "block_k", "stages",
                         "cluster"), info[:5]), group=info[6])
        t = GMM_TILES[tile_key]
        want = {"block_m": tile_key[0], "block_n": tile_key[1],
                "block_k": t["block_k"], "stages": t["stages"], "cluster": 1,
                "group": 0}
        if lib == "gmm" and tile != want:
            raise RuntimeError(f"csrc/gmm.cu was built with {tile} for "
                               f"{tile_key}, the wrapper plans {want}")
        got = _SM90_INFO[key] = (tile, info[5])
    return got


def _launch(lhs, rhs, tile_group, bm, route=None, lib="gmm"):
    """Launch csrc/gmm.cu on the current stream by ``route`` (default: the
    one ``gmm_route`` picks; the tile route takes every call), on checked
    operands; the wgmma route from ``lib`` (a variant build: the bench's
    A/B). chip_smoke.py times the two routes in turn."""
    from leetcuda_tpu_torch.build import entry, kernel

    T, K = lhs.shape
    G, _, N = rhs.shape
    out = torch.empty((T, N), dtype=lhs.dtype, device=lhs.device)
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    ptrs = (lhs.data_ptr(), rhs.data_ptr(), tile_group.data_ptr(),
            out.data_ptr())
    if (route or gmm_route(lhs.dtype, bm, K, N)) == "tile":
        err = kernel("gmm", "lc_gmm", _ARGS)(*ptrs, T, K, N, G, bm,
                                             _DTYPES[lhs.dtype], stream)
        check_launch(err, GMM_TILE.name)
        GMM_TILE.add()
        return out
    key = gmm_tile_key(bm)
    tile, ctas = sm90_build_info(key, lhs.device, lib)
    grid = _units_grid(T, N, tile["block_m"], tile["block_n"], ctas)[3]
    err = entry(lib, "lc_gmm_sm90", _SM90_ARGS)(
        *ptrs, T, K, N, G, bm, _DTYPES[lhs.dtype], GMM_TILES[key]["tile"],
        grid, stream)
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
