"""The op corpus, the counterpart of ``leetcuda_tpu/ops``. Importing this
package registers the ported families (``rms-norm``, ``layer-norm``,
``softmax``, ``attention-utils``, ``rope``, ``embedding``, ``transpose``) in
the op registry (``leetcuda_tpu_torch.core.registry.OPS``)."""

from leetcuda_tpu_torch.ops import (  # noqa: F401
    softmax,
    layer_norm,
    rms_norm,
    rope,
    embedding,
    transpose,
    merge_attn_states,
)
# (the functions ``rope``, ``embedding`` and ``transpose`` stay in their
# modules, whose names they share)
from leetcuda_tpu_torch.ops.embedding import (  # noqa: F401
    embedding_serving, make_embedding, make_embedding_tiled,
    to_serving_layout)
from leetcuda_tpu_torch.ops.rope import (  # noqa: F401
    apply_rope_interleaved, make_rope, make_rope_lane)
from leetcuda_tpu_torch.ops.transpose import (  # noqa: F401
    make_transpose, mat_transpose)
