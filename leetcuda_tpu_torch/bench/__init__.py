"""Benchmark CLIs of the port (``python -m leetcuda_tpu_torch.bench.<name>``)."""
