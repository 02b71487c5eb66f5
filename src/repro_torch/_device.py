"""Device resolution shared by the port's entry points.

Entry points (``InferenceServer``, ``Engine``, ``DecoderLM``) run on the
card unless the caller asks for the CPU.  Without a card they raise: the
port never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for (or
    implied) and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' explicitly to run "
            "the plain PyTorch versions on the CPU")
    return dev
