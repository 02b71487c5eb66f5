"""pLUTo baseline cost model (Ferreira et al., MICRO'22 [11]) as evaluated
by the paper (§II-D, Table V).
Port of the JAX package's ``core/pim/pluto.py``.

pLUTo answers a batch of LUT queries by *sweeping* every LUT row with an
ACT and match-copying hits into a flip-flop buffer.  For b-bit x b-bit
multiplication the query is the 2b-bit concatenation [a, b] => the sweep
covers 2**(2b) rows when 2b <= 8.  Above that (e.g. INT8 mults = 16-bit
queries) the operation decomposes into four b/2-precision subproblems plus
an accumulation cascade [48] — the paper charges 4 full sweeps.

Calibration constants (solved from Table V, documented in DESIGN.md):
  * AUX_ACTS = 16 per sweep (query load + output staging rows),
  * sweep ACT energy E_SWEEP_ACT = 204.65 pJ (gated activation, vs 909 pJ
    for a host-visible ACT),
  * per-sweep-stage latency overhead T_STAGE = 64 ns,
  * query/result bits charged at the pre-GSA rate.

Checks: INT4 1088 ACT / 2176 cmds / 2240 ns / 247.4 nJ ✓
        INT8 4352 ACT / 8704 cmds / 8963 ns / 989.7 nJ (±0.1%) ✓
"""

from __future__ import annotations

import math

from repro_torch.core.pim.hbm import CommandCounts, CostResult, HBM2Config, DEFAULT

AUX_ACTS = 16
E_SWEEP_ACT_PJ = 204.65
T_STAGE_NS = 64.0


def pluto_subproblems(bits: int) -> int:
    """Number of 4-bit sweep passes per op batch (max 8-bit LUT query)."""
    if 2 * bits <= 8:
        return 1
    # decompose into 4-bit x 4-bit quadrants (paper: 'an 8-bit
    # multiplication requires splitting into four 4-bit multiplications')
    halves = math.ceil(bits / 4)
    return halves * halves


def pluto_bulk_cost(
    num_ops: int,
    bits: int,
    num_batches: int = 4,
    cfg: HBM2Config = DEFAULT,
    name: str = "pLUTo",
) -> CostResult:
    """Cost of ``num_ops`` b-bit multiplications over ``num_batches``
    pLUTo-enabled subarrays (subarray-level parallelism, as in Table V)."""
    passes = pluto_subproblems(bits)
    sweep_rows = 2 ** min(2 * bits, 8)
    acts = num_batches * passes * (sweep_rows + AUX_ACTS)
    counts = CommandCounts(act=acts, lut_retrieval=acts)  # ACT + match-copy

    latency = acts * cfg.tRRD + passes * T_STAGE_NS

    in_bits = num_ops * 2 * min(bits, 4) * passes   # query vectors per pass
    out_bits = num_ops * 2 * min(bits, 4) * passes  # matched results
    energy = (
        acts * E_SWEEP_ACT_PJ + (in_bits + out_bits) * cfg.e_pre_gsa_bit
    ) * 1e-3

    return CostResult(name, num_ops, latency, energy, counts)
