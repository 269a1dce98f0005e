"""Canonical test inputs per op family, the counterpart of
``leetcuda_tpu/core/testing.py`` for the families the port registers
(``gemm``, ``gemv``, ``gemm-quant``, ``gemm-grouped``, ``gemm-resident``,
``softmax``, ``layer-norm``, ``rms-norm``, ``attention-utils``, ``rope``,
``embedding``, ``transpose``, ``elementwise``, ``activation``, ``reduce``,
``dot-product``, ``histogram``).

``make_args`` takes the same draws from the numpy ``rng``, in the same order,
as the JAX package's ``make_args`` and rounds them as JAX does (float64 ->
the op's dtype in one rounding; for float16 through numpy, since torch's
float64 -> float16 cast rounds through float32; e4m3 and e5m2 as torch
casts them, which gives JAX's bytes), so one seed gives both packages the
same numbers. The weight packs come from the port's quantizers,
which produce the JAX packs byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch


def _from_f64(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A float64 array rounded once to ``dtype``, as ``jnp.asarray`` does."""
    if dtype == torch.float16:
        return torch.from_numpy(a.astype(np.float16))
    return torch.from_numpy(a).to(dtype)


def make_args(spec, rng: np.random.Generator, device="cpu"):
    """Inputs of ``spec`` (an ``OpSpec``) as tensors on ``device``, or None
    for a family the port does not register."""
    from leetcuda_tpu_torch.gemm.quant import (quantize_groupwise_int4,
                                               quantize_rowwise_fp8)
    from leetcuda_tpu_torch.ops.reduce import _MATRIX

    fam, tags = spec.family, set(spec.tags)

    def randn(shape, dtype, scale=1.0):
        return _from_f64(rng.standard_normal(shape) * scale, dtype)

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8))

    rdt = torch.float16 if "f16" in spec.name else torch.float32
    # the corpus's storage dtype by tags, as JAX's make_args picks it
    tdt = (torch.bfloat16 if any(t.startswith("bf16") for t in tags)
           else torch.float16 if any(t.startswith("f16") for t in tags)
           else torch.float32)
    S, K = 64, 256
    if fam == "elementwise":
        args = (randn((S, K), tdt), randn((S, K), tdt))
    elif fam == "activation":
        args = (randn((S, K), tdt),)
    elif fam == "reduce":
        edt = {sfx: e for sfx, e, _, _ in _MATRIX}[spec.tags[0]]
        if edt == torch.int8:
            args = (ints(-8, 8, (S, K)),)
        else:
            args = (_from_f64(rng.standard_normal((S, K)) * 0.1, edt),)
    elif fam == "dot-product":
        args = (randn((S, K), rdt, 0.1), randn((S, K), rdt, 0.1))
    elif fam == "histogram":
        args = (torch.from_numpy(
            rng.integers(0, 128, (S, 128)).astype(np.int32)),)
    elif fam == "softmax":
        args = (randn((S, K), rdt),)
    elif fam == "layer-norm":
        args = (randn((S, K), rdt), randn((K,), rdt, 0.5),
                randn((K,), rdt, 0.5))
    elif fam == "rms-norm":
        args = (randn((S, K), rdt), randn((K,), rdt, 0.5))
    elif fam == "attention-utils":
        T, H, D = 16, 4, 64
        po = randn((T, H, D), torch.float32)
        so = randn((T, H, D), torch.float32)
        plse = randn((T, H), torch.float32)
        slse = randn((T, H), torch.float32)
        args = (po, plse, so, slse)
    elif fam == "gemm":
        d = torch.bfloat16 if "f16" in tags else torch.float32
        a = randn((128, 256), d, 0.3)
        b = randn((128, 256) if "tn" in tags else (256, 128), d, 0.3)
        args = (a, b)
    elif fam == "gemm-quant":
        x = randn((64, 256), torch.bfloat16, 0.3)
        if "int4" in tags:
            args = (x, *quantize_groupwise_int4(
                randn((256, 128), torch.float32, 0.3), group=128))
        elif "a8w8" in tags:
            args = (ints(-8, 8, (64, 256)), ints(-8, 8, (256, 128)))
        elif "fp8" in tags:
            args = (x, *quantize_rowwise_fp8(
                randn((256, 128), torch.float32, 0.3)))
        else:
            wq = ints(-127, 127, (256, 128))
            scale = torch.from_numpy(
                (np.abs(rng.standard_normal((128,))) * 0.01 + 1e-3)
                .astype(np.float32))
            args = (x, wq, scale)
    elif fam == "gemv":
        d = torch.bfloat16 if spec.name.startswith("hgemv") else torch.float32
        args = (randn((256,), d, 0.3), randn((256, 128), d, 0.3))
    elif fam == "gemm-grouped":
        # 2 row tiles of bm = 128, 4 expert panels; the tiles take 0 and 2
        args = (randn((256, 128), torch.bfloat16, 0.3),
                randn((4, 128, 128), torch.bfloat16, 0.3),
                torch.tensor([0, 2], dtype=torch.int32))
    elif fam == "gemm-resident":
        M = 128
        args = (randn((M, M), torch.bfloat16, 1 / np.sqrt(M)),
                randn((M, M), torch.bfloat16, 1 / np.sqrt(M)))
    elif fam == "rope":
        args = (randn((S, 128), torch.float32),)
    elif fam == "embedding":
        d = (torch.bfloat16 if "bf16" in spec.name
             else torch.float16 if "f16" in spec.name else torch.float32)
        idx = torch.from_numpy(rng.integers(0, 104, (32,)).astype(np.int32))
        table = randn((104, 2, 128) if "tiled" in tags else (104, 128), d)
        args = (idx, table)
    elif fam == "transpose":
        args = (randn((S, K), torch.float32),)
    else:
        return None
    return tuple(t.to(device) for t in args)
