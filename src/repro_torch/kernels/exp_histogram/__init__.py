from repro_torch.kernels.exp_histogram.ops import (  # noqa: F401
    exp_histogram,
    exp_histogram_ref,
    term1_counts,
)
