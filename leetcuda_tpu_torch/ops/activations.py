"""Activation corpus: relu, sigmoid, gelu (tanh form), swish, elu,
hardswish and hardshrink over (S, K), computed in f32 and cast back to the
storage dtype.

Counterpart of ``leetcuda_tpu/ops/activations.py`` (``ACTIVATIONS``, the
seven math functions, ``make_activation``, ``_ORACLES``, the 105
registrations and the top-level entries). On CUDA tensors the wrappers
launch ``lc_elementwise`` of ``csrc/elementwise.cu`` with the activation's
op code and return a new tensor (x is never written); on CPU tensors they
run the math function in plain torch, as ``_unary_kernel`` does:
``op(x.float()).to(x.dtype)``. The math follows JAX's, operation for
operation: sigmoid clamps its argument to +-88, elu has alpha 1,
hardshrink lambda 0.5, hardswish is x * clip(x + 3, 0, 6) * (1 / 6). max
and the clamps pass NaN through (jnp.maximum, jnp.clip); hardshrink maps
NaN to 0 (``|NaN| > 0.5`` is false). f32 denormals are kept, on the card
as on the CPU, where XLA flushes them to zero: JAX's sigmoid below -87.3
is 0 and its swish(-inf) NaN (-inf * 0), the port's 6.05e-39 and -inf.

``block`` is the TPU's tiling and is accepted and ignored; a rung is the
elements a thread takes (``ops/flat.py``). The kernel gets the activation
as a code (``OP_CODES``); a callable that is none of the seven runs only on
CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from leetcuda_tpu_torch.core.registry import register_op
from leetcuda_tpu_torch.core.runtime import LaunchCounter
from leetcuda_tpu_torch.ops import flat
from leetcuda_tpu_torch.ops import rowwise as rw
from leetcuda_tpu_torch.ops.elementwise import _DTYPES, _LADDER, launch_map

ACTIVATION = LaunchCounter("activation")
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_COEF = 0.044715
_EXP_CLAMP = 88.0  # exp argument clamp, the MIN/MAX_EXP_F32 analog


def _relu(x):
    return torch.maximum(x, torch.zeros_like(x))


def _sigmoid(x):
    x = torch.clamp(x, -_EXP_CLAMP, _EXP_CLAMP)
    return 1.0 / (1.0 + torch.exp(-x))


def _gelu_tanh(x):
    inner = _SQRT_2_OVER_PI * (x + _GELU_COEF * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(inner))


def _swish(x):
    return x * _sigmoid(x)


def _elu(x, alpha=1.0):
    neg = torch.exp(torch.minimum(x, torch.zeros_like(x))) - 1.0
    return torch.where(x > 0, x, alpha * neg)


def _hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)


def _hardshrink(x, lam=0.5):
    return torch.where(torch.abs(x) > lam, x, torch.zeros_like(x))


ACTIVATIONS = {
    "relu": _relu,
    "sigmoid": _sigmoid,
    "gelu": _gelu_tanh,
    "swish": _swish,
    "elu": _elu,
    "hardswish": _hardswish,
    "hardshrink": _hardshrink,
}
# lc_elementwise's op codes (elementwise.cu Op; 0 is the add)
OP_CODES = {name: i + 1 for i, name in enumerate(ACTIVATIONS)}


def activation_plain(op, x):
    """``op`` (a math function) over x in f32, cast to x's dtype."""
    return op(x.float()).to(x.dtype)


def make_activation(op, *, block=None, vec: int = 8, pack: bool = True):
    """fn(x): the activation ``op`` (one of ``ACTIVATIONS``' functions for
    the kernel; another callable runs only on CPU tensors) over an (S, K)
    x, in x's dtype."""
    name = next((n for n, f in ACTIVATIONS.items() if f is op), None)

    def fn(x):
        flat.check_2d("activation", x)
        if x.device.type == "cpu":
            return activation_plain(op, x)
        if name is None:
            raise ValueError(f"activation kernel: {op!r} is none of "
                             f"{sorted(ACTIVATIONS)}")
        return launch_map(ACTIVATION, x, None, OP_CODES[name], vec, pack)

    fn.activation, fn.vec, fn.pack = name, vec, pack
    return fn


def _act_flops(x):
    return float(x.numel())  # order-of-magnitude; transcendental cost folded in


def _act_bytes(x):
    return float(2 * x.numel() * x.element_size())


def _in_f32(f):
    return lambda x: f(x.float()).to(x.dtype)


# the registry's oracles (JAX's ``_ORACLES``): torch's own functions in f32
_ORACLES = {
    "relu": lambda x: torch.maximum(x, torch.zeros_like(x)),
    "sigmoid": _in_f32(torch.sigmoid),
    "gelu": _in_f32(lambda x: F.gelu(x, approximate="tanh")),
    "swish": _in_f32(F.silu),
    "elu": _in_f32(F.elu),
    "hardswish": _in_f32(F.hardswish),
    "hardshrink": lambda x: torch.where(x.abs() > 0.5, x,
                                        torch.zeros_like(x)),
}

for _name in ACTIVATIONS:
    for _dt_name, _dt in _DTYPES.items():
        for _rung in _LADDER:
            register_op(
                f"{_name}_{_dt_name}{_rung}",
                ref=_ORACLES[_name], flops=_act_flops, bytes=_act_bytes,
                atol=2e-2 if _dt != torch.float32 else 1e-5,
                rtol=1e-2 if _dt != torch.float32 else 1e-5,
                family="activation",
                tags=(_name, _dt_name, _rung or "naive"),
            )(make_activation(ACTIVATIONS[_name],
                              **rw.rung(f"{_dt_name}{_rung}")))

# top-level entries (the widest rung)
relu = make_activation(_relu, block=(64, 1024))
sigmoid = make_activation(_sigmoid, block=(64, 1024))
gelu = make_activation(_gelu_tanh, block=(64, 1024))
swish = make_activation(_swish, block=(64, 1024))
elu = make_activation(_elu, block=(64, 1024))
hardswish = make_activation(_hardswish, block=(64, 1024))
hardshrink = make_activation(_hardshrink, block=(64, 1024))
