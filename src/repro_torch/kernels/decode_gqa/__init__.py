from repro_torch.kernels.decode_gqa.ops import (  # noqa: F401
    decode_gqa,
    decode_gqa_paged,
    decode_gqa_paged_codes,
)
