"""Lama command/latency/energy model — case study 1 (paper §IV, Table V).
Port of the JAX package's ``core/pim/lama.py``.

Command counts follow §IV's execution flow *exactly* (no calibration):

per coalesced batch of ``m`` ops at ``bits`` precision in one bank:
  * ACT source-subarray row(s) holding the vector operand b  (1 per row)
  * ACT compute-subarray LUT row indexed by the scalar a     (1)
  * internal reads: ceil(m/32)  (32 B atom = 32 zero-padded b elements)
  * LUT retrievals: ceil(m/p(bits))  (Table II parallelism)
  * mask-buffer flushes when the mask logic is active (bits>5):
    ceil(result_bytes / 64)   (64 B temporary buffer)
  * PRE source + compute                                      (2)

Table V check (1024 ops, 4 scalars -> 4 banks x 256 ops):
  INT4: 4x(2 ACT + 8 rd + 16 ret + 2 PRE)            = 112 cmds, 8 ACT ✓
  INT8: 4x(2 ACT + 8 rd + 128 ret + 8 flush + 2 PRE) = 592 cmds, 8 ACT ✓
  (command-reduction claim vs pLUTo INT4: 2176/112 = 19.4x ✓)

Latency/energy use Table III physics plus three documented calibration
constants (the paper's simulator is unpublished; constants solved from
Table V and reused unchanged for every other workload):

  * ``T_BATCH_SETUP`` = 81.75 ns per batch — ACT/PRE phases + operand
    staging, serialized on the channel command bus
    (= 2*tRCD + tRP + 33.75 ns staging).
  * ICAs serialize channel-wide at ``tCCD_S`` = 2 ns.
  * retrieval ICAs are charged 64 bits at the pre-GSA rate; internal-read
    ICAs 128 bits (both solved from Table V to <0.2%).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.pim.hbm import (
    CommandCounts,
    CostResult,
    HBM2Config,
    DEFAULT,
    faw_limited_act_time,
)
from repro_torch.core.lut import icas_per_retrieval, lama_parallelism, masking_msbs

# --- calibration constants (documented above) --------------------------
T_BATCH_SETUP_NS = 81.75     # per coalesced batch
T_FLUSH_NS = 0.97            # per mask-buffer flush command
READ_ICA_BITS = 128          # internal read: 16 B across 16 mats
RET_ICA_BITS = 64            # LUT retrieval (valid-data-gated in [38])


@dataclass(frozen=True)
class LamaBatch:
    """One operand-coalesced batch: f(a, b_0..b_{m-1}) at ``bits``."""

    m: int
    bits: int

    @property
    def parallelism(self) -> int:
        return lama_parallelism(self.bits)

    def counts(self, cfg: HBM2Config = DEFAULT) -> CommandCounts:
        m, bits = self.m, self.bits
        src_rows = max(1, math.ceil(m / cfg.row_buffer_bytes))  # 8b padded
        reads = math.ceil(m / 32)
        retrievals = math.ceil(m / self.parallelism)
        result_bytes = m * (1 if bits == 4 else 2)  # 16-bit aligned >4b
        flushes = math.ceil(result_bytes / 64) if masking_msbs(bits) else 0
        return CommandCounts(
            act=src_rows + 1,
            internal_read=reads,
            lut_retrieval=retrievals,
            mask_flush=flushes,
            pre=src_rows + 1,
        )

    def icas(self) -> tuple[int, int]:
        """(read ICAs, retrieval ICAs)."""
        c = self.counts()
        return 2 * c.internal_read, icas_per_retrieval(self.bits) * c.lut_retrieval


def lama_bulk_cost(
    num_ops: int,
    bits: int,
    num_scalars: int = 4,
    num_banks: int | None = None,
    cfg: HBM2Config = DEFAULT,
    name: str = "Lama",
) -> CostResult:
    """Cost of ``num_ops`` bulk f(a,b) ops grouped into ``num_scalars``
    coalesced batches, one batch per bank (paper's Table V setup)."""
    num_banks = num_banks or num_scalars
    m = num_ops // num_scalars
    batch = LamaBatch(m, bits)

    counts = batch.counts(cfg).scaled(num_scalars)
    rd_icas, ret_icas = batch.icas()
    rd_icas *= num_scalars
    ret_icas *= num_scalars

    # latency: batch setups serialize on the command bus; column accesses
    # serialize channel-wide at tCCD_S; ACT issue is tFAW/tRRD bounded.
    ica_time = (rd_icas + ret_icas) * cfg.tCCD_S
    setup_time = num_scalars * T_BATCH_SETUP_NS
    flush_time = counts.mask_flush * T_FLUSH_NS
    act_floor = faw_limited_act_time(cfg, counts.act)
    latency = max(setup_time + ica_time + flush_time, act_floor)

    energy = (
        counts.act * cfg.e_act
        + rd_icas * READ_ICA_BITS * cfg.e_pre_gsa_bit
        + ret_icas * RET_ICA_BITS * cfg.e_pre_gsa_bit
        + cfg.lama_logic_power_mw * 1e-3 * num_banks * latency  # mW*ns = pJ
    ) * 1e-3  # pJ -> nJ

    return CostResult(name, num_ops, latency, energy, counts)


def lama_command_reduction_vs_pluto(bits: int = 4, num_ops: int = 1024) -> float:
    """§I claim: 19.4x fewer memory commands than pLUTo for INT4."""
    from repro_torch.core.pim.pluto import pluto_bulk_cost

    lama = lama_bulk_cost(num_ops, bits)
    pluto = pluto_bulk_cost(num_ops, bits)
    return pluto.counts.total / lama.counts.total
