from repro_torch.kernels.flash_prefill.ops import (  # noqa: F401
    flash_prefill_paged,
    flash_prefill_paged_codes,
)
