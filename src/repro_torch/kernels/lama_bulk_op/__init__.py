from repro_torch.kernels.lama_bulk_op.ops import (  # noqa: F401
    lama_bulk_op,
    lama_bulk_op_ref,
    lama_vector_matrix,
)
