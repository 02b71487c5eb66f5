from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: F401
                                       host_batch_slice)
