from repro_torch.checkpoint.manager import (all_steps, latest_step,  # noqa: F401
                                            restore, save)
