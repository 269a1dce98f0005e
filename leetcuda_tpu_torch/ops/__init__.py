"""Row ops and attention utilities of the op corpus, the counterpart of
``leetcuda_tpu/ops``. Importing this package registers the ported families
(``rms-norm``, ``layer-norm``, ``softmax``, ``attention-utils``) in the op
registry (``leetcuda_tpu_torch.core.registry.OPS``)."""

from leetcuda_tpu_torch.ops import (  # noqa: F401
    softmax,
    layer_norm,
    rms_norm,
    merge_attn_states,
)
