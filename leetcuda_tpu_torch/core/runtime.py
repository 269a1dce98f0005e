"""Runtime helpers: device resolution, small math utils, kernel launch counts.

The PyTorch counterpart of ``leetcuda_tpu/core/runtime.py``. It keeps its own
copies of ``cdiv`` and ``round_up`` (the port imports nothing of the JAX
package). The TPU tiling helpers there have no meaning on the GPU and are not
carried over.
"""

from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return cdiv(x, m) * m


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. Asking for CUDA on a host without a
    usable GPU raises: entry points never carry on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available on this "
            "host; pass device='cpu' to run the plain PyTorch path")
    return dev


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor as its uint8 view, anything else as it is: indexed
    reads, writes and fills go through the bytes, which every device op
    takes."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


class KernelLaunchError(RuntimeError):
    """A hand-written kernel's launch returned a CUDA error code."""


class LaunchCounter:
    """Counts launches of one CUDA kernel. A wrapper adds one where it
    launches its kernel and nowhere else, so a run can show that its main
    path went through the kernel. Runs on the plain PyTorch version (CPU
    tensors) do not count."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        _COUNTERS[name] = self

    def add(self):
        self.launches += 1

    def __repr__(self):
        return f"LaunchCounter({self.name!r}, launches={self.launches})"


# every kernel's counter, by kernel name (filled as the wrapper modules load)
_COUNTERS: dict[str, LaunchCounter] = {}


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {name: c.launches for name, c in _COUNTERS.items()}


def reset_launch_counts():
    for c in _COUNTERS.values():
        c.launches = 0


def check_launch(err: int, name: str):
    """Raise if a kernel's C entry point returned a non-zero CUDA error."""
    if err != 0:
        raise KernelLaunchError(f"{name}: CUDA error {err} at launch")
