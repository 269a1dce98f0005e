from leetcuda_tpu_torch.engine.engine import (  # noqa: F401
    Engine, EngineConfig, Request, generate)
