from repro_torch.kernels.flash_prefill.ops import flash_prefill_paged  # noqa: F401
