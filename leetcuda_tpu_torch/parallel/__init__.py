from leetcuda_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, tp_shard_rules, MeshConfig)
from leetcuda_tpu_torch.parallel.ring import (  # noqa: F401
    ring_attention, ulysses_attention)
from leetcuda_tpu_torch.parallel import collectives  # noqa: F401
