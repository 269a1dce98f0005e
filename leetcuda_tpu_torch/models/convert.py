"""Parameters from numpy: the bridge that gives both packages one set of weights.

The JAX parameter pytree, handed over as numpy arrays (``np.asarray`` of each
leaf), becomes the port's dict of tensors. bf16 arrives as
``ml_dtypes.bfloat16`` and e4m3 (fp8 weight packs and caches) as
``ml_dtypes.float8_e4m3fn``, which ``torch.from_numpy`` refuses; they cross
bit for bit through an int16 and a uint8 view.
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
