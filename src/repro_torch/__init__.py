"""PyTorch/CUDA port of the DNA-TEQ LUT-quantized serving stack.

Mirrors the layout of the JAX package (``configs/``, ``core/``,
``kernels/<name>/{<name>.py, ops.py, ref.py}``, ``models/``,
``runtime/``) so each module has an obvious counterpart there, but
imports only ``torch``, numpy and the standard library.  The kernels on
the serving path are hand-written CUDA for Hopper (``csrc/``), built at
first use by :mod:`repro_torch.kernels._build`.
"""

from repro_torch._device import resolve_device  # noqa: F401
