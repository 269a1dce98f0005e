"""Uniform op registry: name -> (implementation, plain reference, tolerance,
FLOPs and bytes models).

The counterpart of ``leetcuda_tpu/core/registry.py``: every graded kernel
variant registers itself under the JAX registration's name, family, tags and
atol/rtol, so that one sweep (``core/testing.make_args`` for the inputs)
covers the corpus on either device. ``fn`` is the port's wrapper: it launches
the hand-written kernel on CUDA tensors and runs the plain PyTorch version on
CPU tensors. ``ref`` is the JAX registration's oracle in plain PyTorch:
the plain version itself, except for the naive softmax rungs, whose oracle
is the safe softmax (as in JAX).

The JAX registry wraps every op in ``_f16_compat``, which upcasts f16 to f32
because the TPU has no f16 compute. The port has no such wrapper: its GEMM
library's f16 rungs compute in f16 on Hopper, the row ops' rungs in f32 as
every JAX row-op body does, and all are held at the registry's atol/rtol.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

OPS: dict[str, "OpSpec"] = {}


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One registered kernel variant.

    Attributes:
      name: registry key, the JAX package's name for the same variant.
      fn: the implementation. Positional tensor args only.
      ref: plain PyTorch version with the same signature.
      flops: callable(*args) -> float, FLOPs for one call.
      bytes: callable(*args) -> float, device-memory bytes one call moves.
      atol/rtol: comparison tolerances against ``ref``.
      family: op family (``gemm``, ``gemv``, ``gemm-quant``, ...).
      tags: free-form labels (layout, dtype ladder rung, algorithm, ...).
    """

    name: str
    fn: Callable[..., Any]
    ref: Callable[..., Any] | None = None
    flops: Callable[..., float] | None = None
    bytes: Callable[..., float] | None = None
    atol: float = 1e-5
    rtol: float = 1e-5
    family: str = ""
    tags: tuple[str, ...] = ()


def register_op(
    name: str,
    *,
    ref=None,
    flops=None,
    bytes=None,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    family: str = "",
    tags: tuple[str, ...] = (),
):
    """Decorator registering a kernel variant under ``name``."""

    def deco(fn):
        if name in OPS:
            raise ValueError(f"duplicate op registration: {name}")
        OPS[name] = OpSpec(name=name, fn=fn, ref=ref, flops=flops,
                           bytes=bytes, atol=atol, rtol=rtol, family=family,
                           tags=tags)
        return fn

    return deco


def get_op(name: str) -> OpSpec:
    return OPS[name]


def ops_in_family(family: str) -> list[OpSpec]:
    return [s for s in OPS.values() if s.family == family]


def load_all():
    """Import every module that registers ops, so that ``OPS`` is whole."""
    import leetcuda_tpu_torch.gemm.gemv  # noqa: F401
    import leetcuda_tpu_torch.gemm.grouped  # noqa: F401
    import leetcuda_tpu_torch.gemm.matmul  # noqa: F401
    import leetcuda_tpu_torch.gemm.quant  # noqa: F401
    import leetcuda_tpu_torch.ops.activations  # noqa: F401
    import leetcuda_tpu_torch.ops.dot_product  # noqa: F401
    import leetcuda_tpu_torch.ops.elementwise  # noqa: F401
    import leetcuda_tpu_torch.ops.embedding  # noqa: F401
    import leetcuda_tpu_torch.ops.histogram  # noqa: F401
    import leetcuda_tpu_torch.ops.layer_norm  # noqa: F401
    import leetcuda_tpu_torch.ops.merge_attn_states  # noqa: F401
    import leetcuda_tpu_torch.ops.nms  # noqa: F401
    import leetcuda_tpu_torch.ops.reduce  # noqa: F401
    import leetcuda_tpu_torch.ops.rms_norm  # noqa: F401
    import leetcuda_tpu_torch.ops.rope  # noqa: F401
    import leetcuda_tpu_torch.ops.softmax  # noqa: F401
    import leetcuda_tpu_torch.ops.transpose  # noqa: F401
