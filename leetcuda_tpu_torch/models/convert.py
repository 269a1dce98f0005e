"""Parameters from and to numpy: one set of weights for both packages.

The JAX parameter pytree, handed over as numpy arrays (``np.asarray`` of each
leaf), becomes the port's dict of tensors. bf16 arrives as
``ml_dtypes.bfloat16`` and e4m3 (fp8 weight packs and caches) as
``ml_dtypes.float8_e4m3fn``, which ``torch.from_numpy`` refuses; they cross
bit for bit through an int16 and a uint8 view. ``params_to_numpy`` is the
way back (``ml_dtypes``, which JAX installs, is imported only for a bf16 or
e4m3 tensor).
"""

from __future__ import annotations

import numpy as np
import torch

from leetcuda_tpu_torch.core.runtime import resolve_device


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One numpy array (bf16 included) as a tensor on ``device``, copied:
    the tensor never aliases the caller's (possibly read-only) buffer."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device="cuda"):
    """Map a nested dict/list/tuple of numpy arrays onto tensors on
    ``device``, keeping its structure and keys."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return tensor_from_numpy(np.asarray(x), dev)

    return conv(tree)


def tensor_to_numpy(t: torch.Tensor):
    """One tensor as a numpy array on the host, bit for bit: bf16 and e4m3
    through their int16 / uint8 views into ``ml_dtypes``' types."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype == torch.float8_e4m3fn:
        import ml_dtypes

        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return t.numpy()


def params_to_numpy(tree):
    """The inverse of ``params_from_numpy``: a nested dict/list/tuple of
    tensors as numpy arrays, keeping its structure and keys."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tensor_to_numpy(tree)
