from leetcuda_tpu_torch.attention.decode import decode_attention  # noqa: F401
from leetcuda_tpu_torch.attention.flash import (  # noqa: F401
    flash_attention, flash_attention_ragged)
