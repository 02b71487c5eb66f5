"""Non-PuM baseline device models: CPU (Table V), Edge-TPU (Fig 12),
GPU (Fig 13).  Port of the JAX package's ``core/pim/devices.py``.

These are the paper's baselines, as the paper states them: an Edge TPU
and an RTX A6000 (and a Xeon W-2245), not the H100 the port serves on.
No constant here was measured on that card, and none describes it.

* CPU — the paper *measures* an Intel Xeon W-2245 with AVX-512 VNNI for
  bulk INT8 multiplication; we therefore embed the measured constants
  (9760.4 ns / 7900 nJ per 1024 ops) and scale linearly in op count.
* TPU — a ScaleSim-style analytic model of the Google Edge TPU (Coral):
  64x64 systolic array @ 480 MHz, 8 MB on-chip SRAM, LPDDR4 off-chip.
  Per-layer latency = max(compute at mapping utilization, off-chip weight
  streaming); energy = MAC + SRAM + DRAM terms.  All layers int8
  (paper §V-D).
* GPU — NVIDIA RTX A6000 roofline: batch-1 transformer inference is
  HBM-bandwidth-bound; kernel-only time = bytes / (BW x efficiency),
  energy = board power x time (paper measures via nvml).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.pim.hbm import CommandCounts, CostResult

# ---------------------------------------------------------------- CPU --

CPU_INT8_LAT_NS_PER_1024 = 9760.4
CPU_INT8_ENERGY_NJ_PER_1024 = 7900.0


def cpu_bulk_cost(num_ops: int, bits: int = 8, name: str = "CPU") -> CostResult:
    if bits != 8:
        raise ValueError("AVX-512 VNNI baseline measured at INT8 only")
    k = num_ops / 1024.0
    return CostResult(
        name, num_ops, CPU_INT8_LAT_NS_PER_1024 * k,
        CPU_INT8_ENERGY_NJ_PER_1024 * k, CommandCounts(),
    )


# ---------------------------------------------------------------- TPU --

@dataclass(frozen=True)
class EdgeTPUModel:
    rows: int = 64
    cols: int = 64
    freq_hz: float = 480e6
    sram_bytes: int = 8 * 2**20
    dram_gbs: float = 19.2          # LPDDR4x on the Coral SOM
    e_mac_pj: float = 0.45          # int8 MAC incl. local regs
    e_sram_pj_per_byte: float = 2.0
    e_dram_pj_per_byte: float = 40.0
    idle_w: float = 0.5

    @property
    def peak_macs_per_s(self) -> float:
        return self.rows * self.cols * self.freq_hz

    def matmul_cost(self, m: int, k: int, n: int) -> tuple[float, float]:
        """(latency_s, energy_j) for an int8 GEMM [m,k]x[k,n] (weights
        streamed from DRAM, output-stationary systolic mapping)."""
        macs = m * k * n
        # ScaleSim-like utilization: edge effects of folding onto 64x64.
        util_r = k / (math.ceil(k / self.rows) * self.rows)
        util_c = n / (math.ceil(n / self.cols) * self.cols)
        util = max(util_r * util_c, 1e-3)
        t_compute = macs / (self.peak_macs_per_s * util)
        w_bytes = k * n
        io_bytes = m * k + m * n
        t_mem = (w_bytes + io_bytes) / (self.dram_gbs * 1e9)
        t = max(t_compute, t_mem)
        e = (
            macs * self.e_mac_pj
            + (w_bytes + io_bytes) * (self.e_dram_pj_per_byte + self.e_sram_pj_per_byte)
        ) * 1e-12 + self.idle_w * t
        return t, e


# ---------------------------------------------------------------- GPU --

@dataclass(frozen=True)
class A6000Model:
    """Batch-1 transformer inference on an RTX A6000 is launch-latency and
    bandwidth bound, not peak-TOPS bound: measured BERT-base batch-1 runs
    achieve only a few % of the 310 int8 TOPS.  The model reflects that:
    per-GEMM kernel-launch overhead plus a GDDR6 roofline; ``kernel_power``
    is the nvml-sampled draw during kernel-only execution windows (the
    paper excludes data initialization)."""

    hbm_gbs: float = 768.0
    peak_int8_tops: float = 309.7
    mem_efficiency: float = 0.35     # achieved fraction of GDDR6 BW
    compute_efficiency: float = 0.18 # batch-1 tensor-core utilization
    launch_overhead_s: float = 15e-6 # per-kernel dispatch cost at batch 1
    kernel_power_w: float = 24.0     # incremental (above-idle) nvml power
    die_mm2: float = 628.0

    def matmul_cost(self, m: int, k: int, n: int, bytes_per_el: int = 1):
        macs = m * k * n
        move = (m * k + k * n + m * n) * bytes_per_el
        t_mem = move / (self.hbm_gbs * 1e9 * self.mem_efficiency)
        t_cmp = 2 * macs / (self.peak_int8_tops * 1e12 * self.compute_efficiency)
        t = max(t_mem, t_cmp) + self.launch_overhead_s
        return t, self.kernel_power_w * t
