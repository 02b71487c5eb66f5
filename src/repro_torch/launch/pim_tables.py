"""The paper's PIM tables from the port's cost model (:mod:`repro_torch.core.pim`):
Table IV (Lama's area and power), Table V (bulk 4/8-bit multiplication
on Lama, pLUTo, SIMDRAM and the CPU), Fig 12 (LamaAccel and pLUTo
against the Edge TPU) and Fig 13 (LamaAccel against the RTX A6000).

    PYTHONPATH=src python -m repro_torch.launch.pim_tables

prints Table V beside the paper's figures, the area overhead and the
two figures' rows.  ``table4_rows`` .. ``fig13_rows`` give the rows of
the JAX package's ``benchmarks/table4_area.py`` .. ``fig13_lamaaccel_vs_gpu.py``
(their names and ``derived`` strings).  Everything runs on the host: the
model is pure Python, and its TPU and GPU are the paper's baselines.
"""

from __future__ import annotations

import statistics as st

from repro_torch.core.pim import (
    calibrated_models,
    cpu_bulk_cost,
    fig12_table,
    fig13_table,
    lama_area_overhead,
    lama_bulk_cost,
    lama_command_reduction_vs_pluto,
    pluto_bulk_cost,
    simdram_bulk_cost,
)
from repro_torch.core.pim.workloads import table_vi_workloads

# Table V as the paper reports it: (bits, method) -> (latency ns, energy nJ)
PAPER = {
    (4, "Lama"): (583, 25.8), (4, "pLUTo"): (2240, 247.4),
    (4, "SIMDRAM"): (7964, 151.23),
    (8, "Lama"): (2534, 118.8), (8, "pLUTo"): (8963, 989.7),
    (8, "SIMDRAM"): (34065, 646.9), (8, "CPU"): (9760.4, 7900.0),
}


def table5_costs(bits: int) -> list:
    """Table V's rows at ``bits``: 1024 ops, 4 scalars (the CPU at 8 bits
    only)."""
    costs = [lama_bulk_cost(1024, bits), pluto_bulk_cost(1024, bits),
             simdram_bulk_cost(1024, bits)]
    if bits == 8:
        costs.append(cpu_bulk_cost(1024))
    return costs


def table4_rows() -> list[dict]:
    """Table IV: Lama's area and power overhead."""
    rep = lama_area_overhead()
    out = [{
        "name": "table4/total_overhead",
        "us_per_call": 0.0,
        "derived": (f"{rep.total_mm2:.3f} mm2 = {rep.overhead_pct:.2f}% of "
                    f"8GB HBM2 (paper 1.32 mm2 / 2.47%)"),
    }]
    for r in rep.rows():
        out.append({
            "name": f"table4/{r['unit'].lower()}",
            "us_per_call": 0.0,
            "derived": (f"area={r['area_um2_per_bank']:.1f} um2/bank "
                        f"power={r['power_mw_per_bank']:.2f} mW/bank"),
        })
    return out


def table5_rows() -> list[dict]:
    """Table V: bulk 4/8-bit multiplication, 1024 ops, parallelism 4."""
    out = []
    for bits in (4, 8):
        for c in table5_costs(bits):
            p_lat, p_e = PAPER[(bits, c.name)]
            out.append({
                "name": f"table5/int{bits}/{c.name.lower()}",
                "us_per_call": c.latency_ns / 1e3,
                "derived": (
                    f"energy_nJ={c.energy_nj:.2f} gops={c.gops:.3f} "
                    f"acts={c.counts.act} cmds={c.counts.total} "
                    f"paper_lat={p_lat} paper_e={p_e} "
                    f"lat_err={(c.latency_ns-p_lat)/p_lat*100:+.2f}%"),
            })
    out.append({
        "name": "table5/cmd_reduction_vs_pluto_int4",
        "us_per_call": 0.0,
        "derived": f"{lama_command_reduction_vs_pluto():.2f}x (paper 19.4x)",
    })
    return out


def fig12_rows() -> list[dict]:
    """Fig 12: LamaAccel and pLUTo speedup and energy saving over the
    Edge TPU across the five LLM workloads."""
    lama, _ = calibrated_models()
    table = fig12_table()
    ws = {w.name: w for w in table_vi_workloads()}
    out = []
    for r in table:
        lat_us = lama.cost(ws[r["workload"]]).latency_s * 1e6
        out.append({
            "name": f"fig12/{r['workload']}",
            "us_per_call": lat_us,
            "derived": (
                f"speedup_vs_tpu={r['lama_speedup_vs_tpu']:.2f} "
                f"energy_saving={r['lama_energy_saving_vs_tpu']:.2f} "
                f"pluto_speedup={r['pluto_speedup_vs_tpu']:.2f} "
                f"avg_bits={r['avg_bits']}"),
        })
    out.append({
        "name": "fig12/averages",
        "us_per_call": 0.0,
        "derived": (
            f"speedup={st.mean(x['lama_speedup_vs_tpu'] for x in table):.2f} "
            f"(paper 4.1) energy="
            f"{st.mean(x['lama_energy_saving_vs_tpu'] for x in table):.2f} "
            f"(paper 7.1) vs_pluto="
            f"{st.mean(x['lama_speedup_vs_tpu']/x['pluto_speedup_vs_tpu'] for x in table):.2f} "
            f"(paper 1.7)"),
    })
    return out


def fig13_rows() -> list[dict]:
    """Fig 13: LamaAccel perf-per-area and energy saving against the RTX
    A6000."""
    table = fig13_table()
    out = []
    for r in table:
        out.append({
            "name": f"fig13/{r['workload']}",
            "us_per_call": 0.0,
            "derived": (
                f"perf_per_area={r['perf_per_area_vs_gpu']:.2f} "
                f"energy_saving={r['energy_saving_vs_gpu']:.2f} "
                f"raw_speedup={r['raw_speedup_vs_gpu']:.3f}"),
        })
    out.append({
        "name": "fig13/averages",
        "us_per_call": 0.0,
        "derived": (
            f"perf_per_area="
            f"{st.mean(x['perf_per_area_vs_gpu'] for x in table):.2f} "
            f"(paper 7.2) energy="
            f"{st.mean(x['energy_saving_vs_gpu'] for x in table):.2f} "
            f"(paper 12, range 6.1-19.2)"),
    })
    return out


def main() -> None:
    """Table V beside the paper's numbers, the area overhead, then the
    LamaAccel figures."""
    print(f"{'method':10s} {'bits':>4s} {'lat ns':>9s} {'paper':>8s} "
          f"{'E nJ':>8s} {'paper':>8s} {'ACTs':>6s} {'cmds':>6s}")
    for bits in (4, 8):
        for r in table5_costs(bits):
            pl, pe = PAPER[(bits, r.name)]
            print(f"{r.name:10s} {bits:4d} {r.latency_ns:9.1f} {pl:8.0f} "
                  f"{r.energy_nj:8.2f} {pe:8.2f} {r.counts.act:6d} "
                  f"{r.counts.total:6d}")
    a = lama_area_overhead()
    print(f"\narea overhead: {a.total_mm2:.2f} mm2 = {a.overhead_pct:.2f}% "
          f"(paper: 1.32 mm2 / 2.47%)")

    print("\nLamaAccel vs TPU (fig 12):")
    for r in fig12_table():
        print(f"  {r['workload']:14s} speedup {r['lama_speedup_vs_tpu']:5.2f}x  "
              f"energy {r['lama_energy_saving_vs_tpu']:5.2f}x  "
              f"({r['avg_bits']:.2f} avg bits)")
    print("LamaAccel vs GPU (fig 13):")
    for r in fig13_table():
        print(f"  {r['workload']:14s} perf/area {r['perf_per_area_vs_gpu']:5.2f}x  "
              f"energy {r['energy_saving_vs_gpu']:5.2f}x")


if __name__ == "__main__":
    main()
