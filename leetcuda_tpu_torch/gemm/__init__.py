# (the functions ``matmul`` and ``gemv`` stay in their modules, whose names
# they share)
from leetcuda_tpu_torch.gemm.fused_decode import (  # noqa: F401
    fused_norm_matmul, fused_norm_qkv_rope)
from leetcuda_tpu_torch.gemm.gemv import (  # noqa: F401
    hgemv, make_gemv, make_rms_norm_gemv, rms_norm_gemv)
from leetcuda_tpu_torch.gemm.matmul import (  # noqa: F401
    hgemm, hgemm_tn, make_matmul, make_matmul_resident, matmul_auto,
    matmul_chain_plain, pick_matmul_config, sgemm)
from leetcuda_tpu_torch.gemm.quant import (  # noqa: F401
    dequantize_int4, make_matmul_i8i8i32, matmul_i8i8i32, matmul_w4a16,
    matmul_w8a16, quantize_groupwise_int4, quantize_rowwise_fp8,
    quantize_rowwise_int8)
