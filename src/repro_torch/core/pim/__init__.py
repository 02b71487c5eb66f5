"""Command-level PIM instrument: rebuilt in-house simulator of the paper
(HBM2 timing/energy from Table III; Lama, pLUTo, SIMDRAM, CPU/TPU/GPU
models; LamaAccel workload evaluation).

Port of the JAX package's ``core/pim``: the same constants, calibration
and arithmetic in the same order, so every cost, count and table row is
the reference's to the last bit.  Pure Python on the host: the modules
import the standard library and :mod:`repro_torch.core.lut` only, never
``torch``.  Its TPU, GPU and CPU figures are the paper's baselines (an
Edge TPU, an RTX A6000, a Xeon W-2245), not measurements of the card the
port serves on.
"""

from repro_torch.core.pim.hbm import HBM2Config, CommandCounts, CostResult, DEFAULT  # noqa: F401
from repro_torch.core.pim.lama import lama_bulk_cost, lama_command_reduction_vs_pluto  # noqa: F401
from repro_torch.core.pim.pluto import pluto_bulk_cost  # noqa: F401
from repro_torch.core.pim.simdram import simdram_bulk_cost  # noqa: F401
from repro_torch.core.pim.devices import cpu_bulk_cost, EdgeTPUModel, A6000Model  # noqa: F401
from repro_torch.core.pim.area import lama_area_overhead  # noqa: F401
from repro_torch.core.pim.accel import fig12_table, fig13_table, calibrated_models  # noqa: F401
from repro_torch.core.pim.workloads import table_vi_workloads  # noqa: F401
