from repro_torch.optim import adamw, schedule  # noqa: F401
from repro_torch.optim.adamw import AdamWState  # noqa: F401
