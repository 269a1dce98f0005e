from leetcuda_tpu_torch.attention.decode import (  # noqa: F401
    decode_attention, decode_attention_quantized)
from leetcuda_tpu_torch.attention.flash import (  # noqa: F401
    flash_attention, flash_attention_ragged)
from leetcuda_tpu_torch.attention.flash_bwd import (  # noqa: F401
    flash_attention_bwd, make_flash_attention_trainable)
from leetcuda_tpu_torch.attention.paged import (  # noqa: F401
    PageManager, paged_attention, paged_attention_quantized)
from leetcuda_tpu_torch.attention.chunk import (  # noqa: F401
    chunk_attention, chunk_attention_quantized, paged_chunk_attention,
    paged_chunk_attention_quantized)
from leetcuda_tpu_torch.attention.splitkv import (  # noqa: F401
    flash_attention_splitkv)
