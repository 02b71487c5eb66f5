"""SIMDRAM baseline cost model (Hajinazar et al., ASPLOS'21 [14]).
Port of the JAX package's ``core/pim/simdram.py``.

SIMDRAM executes bit-serial arithmetic with majority/NOT operations built
from triple-row-activation AAP (ACTIVATE-ACTIVATE-PRECHARGE) command
triplets.  n-bit multiplication costs ``11 n^2 - 5 n - 1`` AAPs
(recovered exactly from Table V: n=4 -> 155, n=8 -> 663); each AAP counts
2 ACTs + 1 PRE, matching the reported 310/465 and 1326/1989 command
totals.  Latency/energy per AAP are calibrated from Table V:
t_AAP = 51.38 ns (~= tRC + 2 tRRD + tCCD_S), e_AAP = 975.7 pJ (~= e_ACT
x 1.073, reflecting the paper's 22%-per-extra-row activation premium
amortized over the AAP pair).
"""

from __future__ import annotations

from repro_torch.core.pim.hbm import CommandCounts, CostResult, HBM2Config, DEFAULT

T_AAP_NS = 51.38
E_AAP_PJ = 975.7


def simdram_mul_aaps(bits: int) -> int:
    return 11 * bits * bits - 5 * bits - 1


def simdram_bulk_cost(
    num_ops: int,
    bits: int,
    num_subarrays: int = 4,
    cfg: HBM2Config = DEFAULT,
    name: str = "SIMDRAM",
) -> CostResult:
    """Bit-serial bulk multiplication: each subarray computes its whole
    256-op slice in SIMD fashion across the row width, so the AAP count is
    independent of ops-per-subarray (<= row width) and of the subarray
    count (they proceed in lockstep)."""
    aaps = simdram_mul_aaps(bits)
    counts = CommandCounts(act=2 * aaps, pre=aaps, aap=aaps)
    latency = aaps * T_AAP_NS
    energy = aaps * E_AAP_PJ * 1e-3
    return CostResult(name, num_ops, latency, energy, counts)
