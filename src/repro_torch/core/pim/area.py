"""Area-overhead model (paper §IV-E, Table IV): Lama adds per-bank column
counters, mask logic and a temporary buffer, synthesized at 28 nm, scaled
to 22 nm with a 50% DRAM-process logic penalty; total overhead 2.47% of an
8 GB HBM2 stack (53.15 mm^2).  Port of the JAX package's
``core/pim/area.py``."""

from __future__ import annotations

from dataclasses import dataclass

# Table IV, per-bank (already process-scaled in the paper)
AREA_UM2 = {
    "column_counter_latch": 5002.8,
    "mask_logic": 1628.0,
    "temporary_buffer": 3636.6,
    "others": 19.73,
}
POWER_MW = {
    "column_counter_latch": 1.49,
    "mask_logic": 1.01,
    "temporary_buffer": 3.76,
    "others": 0.09,
}
HBM2_8GB_AREA_MM2 = 53.15
PAPER_OVERHEAD_MM2 = 1.32
PAPER_OVERHEAD_PCT = 2.47
LAMAACCEL_EXTRA_MM2 = 0.01   # §V-D: activation buffer + XNOR/demux


@dataclass(frozen=True)
class AreaReport:
    per_bank_um2: float
    total_banks: int
    total_mm2: float
    overhead_pct: float

    def rows(self) -> list[dict]:
        out = [
            {"unit": k, "area_um2_per_bank": v, "power_mw_per_bank": POWER_MW[k]}
            for k, v in AREA_UM2.items()
        ]
        out.append({
            "unit": "TOTAL", "area_um2_per_bank": self.per_bank_um2,
            "power_mw_per_bank": sum(POWER_MW.values()),
        })
        return out


def lama_area_overhead(
    channels: int = 8, banks_per_channel: int = 16
) -> AreaReport:
    """All banks across the stack's channels are Lama-equipped (§IV-E)."""
    per_bank = sum(AREA_UM2.values())
    banks = channels * banks_per_channel
    total_mm2 = per_bank * banks * 1e-6
    pct = 100.0 * total_mm2 / HBM2_8GB_AREA_MM2
    return AreaReport(per_bank, banks, total_mm2, pct)
