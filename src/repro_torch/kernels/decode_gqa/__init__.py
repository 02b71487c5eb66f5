from repro_torch.kernels.decode_gqa.ops import decode_gqa_paged  # noqa: F401
