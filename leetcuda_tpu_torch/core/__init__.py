from leetcuda_tpu_torch.core.runtime import (  # noqa: F401
    KernelLaunchError, LaunchCounter, cdiv, launch_counts, reset_launch_counts,
    resolve_device, round_up)
