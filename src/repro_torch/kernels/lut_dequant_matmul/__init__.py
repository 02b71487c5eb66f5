from repro_torch.kernels.lut_dequant_matmul.ops import (  # noqa: F401
    lut_dequant_matmul,
    lut_dequant_matmul_dual,
    lut_dequant_matmul_dual_gated,
    lut_dequant_matmul_gated,
)
