from leetcuda_tpu_torch.gemm.fused_decode import (  # noqa: F401
    fused_norm_matmul, fused_norm_qkv_rope)
from leetcuda_tpu_torch.gemm.quant import (  # noqa: F401
    dequantize_int4, matmul_w4a16, matmul_w8a16, quantize_groupwise_int4,
    quantize_rowwise_fp8, quantize_rowwise_int8)
