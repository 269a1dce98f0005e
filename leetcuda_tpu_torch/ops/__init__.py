"""The op corpus, the counterpart of ``leetcuda_tpu/ops``. Importing this
package registers the ported families (``rms-norm``, ``layer-norm``,
``softmax``, ``attention-utils``, ``rope``, ``embedding``, ``transpose``,
``elementwise``, ``activation``, ``reduce``, ``dot-product``,
``histogram``, ``nms``) in the op registry
(``leetcuda_tpu_torch.core.registry.OPS``)."""

from leetcuda_tpu_torch.ops import (  # noqa: F401
    softmax,
    layer_norm,
    rms_norm,
    rope,
    embedding,
    transpose,
    merge_attn_states,
    elementwise,
    activations,
    reduce,
    dot_product,
    histogram,
    nms,
)
# (the functions ``rope``, ``embedding``, ``transpose``, ``dot_product``,
# ``histogram`` and ``nms`` stay in their modules, whose names they share)
from leetcuda_tpu_torch.ops.activations import (  # noqa: F401
    ACTIVATIONS, elu, gelu, hardshrink, hardswish, make_activation, relu,
    sigmoid, swish)
from leetcuda_tpu_torch.ops.dot_product import make_dot_product  # noqa: F401
from leetcuda_tpu_torch.ops.elementwise import (  # noqa: F401
    elementwise_add_bf16, elementwise_add_f32, make_elementwise_binary)
from leetcuda_tpu_torch.ops.embedding import (  # noqa: F401
    embedding_serving, make_embedding, make_embedding_tiled,
    to_serving_layout)
from leetcuda_tpu_torch.ops.histogram import make_histogram  # noqa: F401
from leetcuda_tpu_torch.ops.nms import nms_indices, nms_ref  # noqa: F401
from leetcuda_tpu_torch.ops.reduce import (  # noqa: F401
    block_all_reduce_max_f32, block_all_reduce_sum_f32,
    make_block_all_reduce_max, make_block_all_reduce_sum)
from leetcuda_tpu_torch.ops.rope import (  # noqa: F401
    apply_rope_interleaved, make_rope, make_rope_lane)
from leetcuda_tpu_torch.ops.transpose import (  # noqa: F401
    make_transpose, mat_transpose)
