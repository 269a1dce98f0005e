"""Matrix transpose: (S, K) -> (K, S), any S and K, any dtype of 1, 2 or 4
bytes.

Counterpart of ``leetcuda_tpu/ops/transpose.py`` (``make_transpose``, the
12 registrations, ``_t_ref``). On CUDA tensors the wrappers launch
``lc_transpose`` of ``csrc/transpose.cu`` and return a new tensor; on CPU
tensors they run ``transpose_plain``. ``order`` is the tile walk, as in
JAX: col2row row-major over x's tiles, row2col column-major, diagonal tile
(i, (i + j) mod nj). ``block`` is the TPU's tiling and is accepted and
ignored: the kernel's tile is 64 x 64.

The rung names are the reference's CUDA ladder; each maps to the port's
variant of how a tile crosses the SM (``VARIANTS``, ``RUNG_VARIANT``):
``f32`` an element a thread with no shared memory, ``f32x4`` 4-element
(16-byte in f32) loads and stores through a 4 x 4 register block,
``shared`` a tile staged in shared memory, ``shared_bcf`` the same tile
padded by one element a row (bank-conflict free), ``cute_smem_swizzled`` an
XOR-swizzled tile; ``cute_reg`` takes the register block and ``cute_smem``
the plain staged tile, their nearest variants.
"""

from __future__ import annotations

import ctypes

import torch

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter, check_launch

TRANSPOSE = LaunchCounter("transpose")
ORDERS = {"col2row": 0, "row2col": 1, "diagonal": 2}
VARIANTS = {"scalar": 0, "reg": 1, "shared": 2, "shared_bcf": 3,
            "swizzled": 4}
# lc_transpose(x, out, S, K, elem_bytes, variant, order, stream)
_ARGS = (ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)


def transpose_plain(x):
    """x (S, K) -> (K, S), a new contiguous tensor (JAX's ``_t_ref``)."""
    return x.t().contiguous()


_t_ref = transpose_plain


def _launch(x, variant, order):
    from leetcuda_tpu_torch.build import kernel

    if x.element_size() not in (1, 2, 4):
        raise ValueError(f"transpose kernel: elements of 1, 2 or 4 bytes, "
                         f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("transpose kernel: x must be contiguous")
    S, K = x.shape
    out = torch.empty((K, S), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    fn = kernel("transpose", "lc_transpose", _ARGS)
    err = fn(x.data_ptr(), out.data_ptr(), S, K, x.element_size(),
             VARIANTS[variant], ORDERS[order],
             torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, TRANSPOSE.name)
    TRANSPOSE.add()
    return out


def make_transpose(*, block: tuple[int, int] = (256, 256),
                   order: str = "col2row", variant: str = "shared_bcf"):
    """transpose(x): (S, K) -> (K, S) with a chosen tile walk ``order`` and
    ``variant`` (a key of ``VARIANTS``)."""
    if order not in ORDERS:
        raise ValueError(order)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}, got "
                         f"{variant!r}")

    def fn(x):
        if x.dim() != 2:
            raise ValueError(f"transpose takes (S, K), got {tuple(x.shape)}")
        if x.device.type == "cpu":
            return transpose_plain(x)
        return _launch(x, variant, order)

    fn.order, fn.variant = order, variant
    return fn


def _t_bytes(x):
    return float(2 * x.numel() * x.element_size())


# the ladder's rung (its name less "mat_transpose_" and the order) -> variant
RUNG_VARIANT = {
    "f32": "scalar", "f32x4": "reg", "f32x4_shared": "shared",
    "f32x4_shared_bcf": "shared_bcf", "cute_reg": "reg",
    "cute_smem": "shared", "cute_smem_swizzled": "swizzled",
}

for _name, _order, _blk in [
    ("mat_transpose_f32_col2row2d", "col2row", (256, 256)),
    ("mat_transpose_f32_row2col2d", "row2col", (256, 256)),
    ("mat_transpose_f32_diagonal2d", "diagonal", (256, 256)),
    ("mat_transpose_f32x4_col2row2d", "col2row", (1024, 1024)),
    ("mat_transpose_f32x4_row2col2d", "row2col", (1024, 1024)),
    ("mat_transpose_f32x4_shared_col2row2d", "col2row", (128, 128)),
    ("mat_transpose_f32x4_shared_row2col2d", "row2col", (128, 128)),
    ("mat_transpose_f32x4_shared_bcf_col2row2d", "col2row", (128, 256)),
    ("mat_transpose_f32x4_shared_bcf_row2col2d", "row2col", (256, 128)),
    ("mat_transpose_cute_reg", "col2row", (128, 128)),
    ("mat_transpose_cute_smem", "col2row", (128, 256)),
    ("mat_transpose_cute_smem_swizzled", "diagonal", (128, 128)),
]:
    _rung = _name.removeprefix("mat_transpose_").removesuffix(
        f"_{_order}2d")
    register_op(
        _name,
        ref=_t_ref, bytes=_t_bytes,
        atol=0.0, rtol=0.0, family="transpose", tags=(_order,),
    )(make_transpose(block=_blk, order=_order,
                     variant=RUNG_VARIANT[_rung]))

mat_transpose = make_transpose()
