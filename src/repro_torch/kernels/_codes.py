"""Per-head decode for the codes-mode attention (port of the JAX
package's ``kernels/_codes.py``).

KV pages in codes mode hold one uint8 DNA-TEQ code per element, and each
KV head owns its own 256-entry table.  The plain versions of both codes
attention kernels decode through this helper; the CUDA kernels do the
same gather from shared memory.
"""

from __future__ import annotations

import torch


def decode_heads(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``lut`` [n_kv, 256] float32 tables; ``codes`` [..., n_kv, hd]
    uint8.  Returns float32 of ``codes.shape`` with element
    ``[..., n, h] = lut[n, codes[..., n, h]]``."""
    n_kv = codes.shape[-2]
    heads = torch.arange(n_kv, device=codes.device)[:, None]
    return lut.to(torch.float32)[heads, codes.long()]
