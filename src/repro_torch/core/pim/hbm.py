"""HBM2 organization, timing and energy parameters (paper Table III).
Port of the JAX package's ``core/pim/hbm.py``.

The paper evaluates Lama with an in-house command-level simulator built on
Micron HBM2 pseudo-channel-mode parameters with timing/energy constants
from O'Connor et al. (Fine-Grained DRAM, MICRO'17) [38].  This module is
the rebuilt instrument: command-count models are derived from first
principles (§IV execution flow) and match Table V exactly; latency and
energy use the physical constants below plus a small number of
*documented calibration constants* (see ``CALIBRATION`` notes) because the
paper's simulator source is unavailable.  Tests assert both the exact
command counts and the headline latency/energy ratios.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class HBM2Config:
    """Table III — architectural parameters for Lama."""

    # organization
    channels_per_die: int = 2
    dies: int = 4
    pch_per_channel: int = 2
    banks_per_channel: int = 16           # 8 per pseudo-channel
    banks_per_group: int = 4
    subarrays_per_bank: int = 64
    rows_per_bank: int = 32 * 1024
    row_buffer_bytes: int = 1024          # per pseudo-channel
    mat_rows: int = 512
    mat_cols: int = 512
    mats_per_subarray: int = 16
    dq_bits_per_channel: int = 128
    atom_bytes: int = 32                  # DRAM atom (two ICAs x 16 B)
    ica_bytes: int = 16                   # one internal column access: 16 mats x 8 bit
    pch_bandwidth_gbs: float = 16.0       # 64-bit DDR @ 1 GHz
    host_bandwidth_gbs: float = 256.0     # full stack [38]

    # timing (ns)
    tRC: float = 45.0
    tRCD: float = 16.0
    tRAS: float = 29.0
    tCL: float = 16.0
    tRRD: float = 2.0
    tWR: float = 16.0
    tCCD_S: float = 2.0
    tCCD_L: float = 4.0
    tFAW: float = 12.0
    acts_in_faw: int = 8
    tRP: float = 16.0                     # tRC - tRAS

    # energy (pJ)
    e_act: float = 909.0                  # per row activation
    e_pre_gsa_bit: float = 1.51           # pre-GSA data movement, per bit
    e_post_gsa_bit: float = 1.17          # post-GSA, per bit
    e_io_bit: float = 0.80                # I/O, per bit

    # bank-level Lama logic (Table IV, synthesized @28 nm -> 22 nm)
    clock_mhz: float = 500.0
    n_column_counters: int = 16
    power_col_counter_mw: float = 1.49
    power_mask_mw: float = 1.01
    power_tmp_buffer_mw: float = 3.76
    power_others_mw: float = 0.09

    @property
    def cycle_ns(self) -> float:
        return 1e3 / self.clock_mhz      # 2 ns @ 500 MHz

    @property
    def banks_per_pch(self) -> int:
        return self.banks_per_channel // self.pch_per_channel

    @property
    def read_bit_energy(self) -> float:
        """pJ per bit for a host-visible read (pre+post GSA + I/O)."""
        return self.e_pre_gsa_bit + self.e_post_gsa_bit + self.e_io_bit

    @property
    def lama_logic_power_mw(self) -> float:
        return (
            self.power_col_counter_mw
            + self.power_mask_mw
            + self.power_tmp_buffer_mw
            + self.power_others_mw
        )


DEFAULT = HBM2Config()


@dataclass
class CommandCounts:
    """Command-stream summary for one bulk operation."""

    act: int = 0
    internal_read: int = 0     # source-subarray fetch into temp buffer
    lut_retrieval: int = 0     # compute-subarray column accesses (as commands)
    mask_flush: int = 0        # mask-buffer stages (active only when p < 16)
    write: int = 0
    pre: int = 0
    aap: int = 0               # SIMDRAM ACT-ACT-PRE triplets

    @property
    def total(self) -> int:
        return (
            self.act
            + self.internal_read
            + self.lut_retrieval
            + self.mask_flush
            + self.write
            + self.pre
        )

    def scaled(self, k: int) -> "CommandCounts":
        return CommandCounts(
            **{f.name: getattr(self, f.name) * k for f in dataclasses.fields(self)}
        )


@dataclass
class CostResult:
    """Latency / energy / throughput for one bulk workload."""

    name: str
    num_ops: int
    latency_ns: float
    energy_nj: float
    counts: CommandCounts

    @property
    def gops(self) -> float:
        return self.num_ops / self.latency_ns  # ops/ns == GOPs

    @property
    def energy_pj_per_op(self) -> float:
        return 1e3 * self.energy_nj / self.num_ops

    def row(self) -> dict:
        return {
            "method": self.name,
            "latency_ns": round(self.latency_ns, 1),
            "energy_nj": round(self.energy_nj, 2),
            "gops": round(self.gops, 3),
            "acts": self.counts.act,
            "total_cmds": self.counts.total,
        }


def faw_limited_act_time(cfg: HBM2Config, n_acts: int) -> float:
    """Minimum time to issue n ACTs under tRRD + tFAW constraints."""
    rrd = n_acts * cfg.tRRD
    faw = (n_acts / cfg.acts_in_faw) * cfg.tFAW
    return max(rrd, faw)
