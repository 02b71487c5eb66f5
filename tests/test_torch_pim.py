"""The port's PIM cost model (``repro_torch.core.pim``) and its paper
tables (``repro_torch.launch.pim_tables``) against the JAX package's.

Two kinds of check.  First, every test of ``tests/test_pim.py`` on the
port's modules, with the paper's own bounds (Table V, Table IV, Figs
12-13, the §I claims).  Second, parity: the port runs the reference's
float arithmetic in the same order, so every field of every
``CostResult``, ``CommandCounts`` and ``AccelCost``, every table row and
every calibrated constant must be exactly equal (``==``, no tolerance),
also over a hypothesis grid of op counts, widths and scalar counts.  The
reference's benchmark scripts are imported read-only from
``benchmarks/`` with the repo root on ``sys.path``.
"""

import dataclasses
import importlib
import pathlib
import statistics as st
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs

import repro.core.pim as R
import repro.core.pim.accel as R_accel
import repro.core.pim.workloads as R_workloads
import repro_torch.core.pim as P
import repro_torch.core.pim.accel as P_accel
import repro_torch.core.pim.workloads as P_workloads
from repro_torch.core.lut import lama_parallelism
from repro_torch.core.pim import (
    cpu_bulk_cost,
    fig12_table,
    fig13_table,
    lama_area_overhead,
    lama_bulk_cost,
    lama_command_reduction_vs_pluto,
    pluto_bulk_cost,
    simdram_bulk_cost,
)
from repro_torch.core.pim.simdram import simdram_mul_aaps
from repro_torch.launch import pim_tables

ROOT = pathlib.Path(__file__).resolve().parents[1]

TABLE_V = {
    4: {
        "lama": dict(lat=583, e=25.8, act=8, cmd=112),
        "pluto": dict(lat=2240, e=247.4, act=1088, cmd=2176),
        "simdram": dict(lat=7964, e=151.23, act=310, cmd=465),
    },
    8: {
        "lama": dict(lat=2534, e=118.8, act=8, cmd=592),
        "pluto": dict(lat=8963, e=989.7, act=4352, cmd=8704),
        "simdram": dict(lat=34065, e=646.9, act=1326, cmd=1989),
    },
}
COSTS = ((lama_bulk_cost, "lama"), (pluto_bulk_cost, "pluto"),
         (simdram_bulk_cost, "simdram"))


# ------------------------------------------- the paper's own checks --

@pytest.mark.parametrize("bits", [4, 8])
class TestTableV:
    def test_command_counts_exact(self, bits):
        for fn, key in COSTS:
            r = fn(1024, bits)
            assert r.counts.act == TABLE_V[bits][key]["act"], key
            assert r.counts.total == TABLE_V[bits][key]["cmd"], key

    def test_latency_within_half_percent(self, bits):
        for fn, key in COSTS:
            r = fn(1024, bits)
            paper = TABLE_V[bits][key]["lat"]
            assert abs(r.latency_ns - paper) / paper < 0.005, (key, r.latency_ns)

    def test_energy_within_half_percent(self, bits):
        for fn, key in COSTS:
            r = fn(1024, bits)
            paper = TABLE_V[bits][key]["e"]
            assert abs(r.energy_nj - paper) / paper < 0.005, (key, r.energy_nj)


class TestHeadlineClaims:
    def test_act_count_precision_independent(self):
        assert lama_bulk_cost(1024, 4).counts.act == \
            lama_bulk_cost(1024, 8).counts.act == 8

    def test_command_reduction_19_4x(self):
        assert abs(lama_command_reduction_vs_pluto() - 19.4) < 0.1

    def test_speedup_vs_pluto(self):
        s4 = pluto_bulk_cost(1024, 4).latency_ns / lama_bulk_cost(1024, 4).latency_ns
        s8 = pluto_bulk_cost(1024, 8).latency_ns / lama_bulk_cost(1024, 8).latency_ns
        assert abs(s4 - 3.8) < 0.2
        assert abs(s8 - 3.5) < 0.2

    def test_energy_vs_pluto(self):
        e4 = pluto_bulk_cost(1024, 4).energy_nj / lama_bulk_cost(1024, 4).energy_nj
        e8 = pluto_bulk_cost(1024, 8).energy_nj / lama_bulk_cost(1024, 8).energy_nj
        assert abs(e4 - 9.6) < 0.4
        assert abs(e8 - 8.3) < 0.4

    def test_vs_cpu_int8(self):
        cpu = cpu_bulk_cost(1024)
        lama = lama_bulk_cost(1024, 8)
        assert abs(cpu.latency_ns / lama.latency_ns - 3.8) < 0.2
        # the table-derived ratio (the paper's text says 8x, its Table V
        # gives 66.5x), as the reference asserts it
        assert abs(cpu.energy_nj / lama.energy_nj - 66.5) < 2.0

    def test_simdram_ratios(self):
        s = simdram_bulk_cost(1024, 4)
        l = lama_bulk_cost(1024, 4)
        assert abs(s.latency_ns / l.latency_ns - 13.7) < 0.5
        assert abs(s.energy_nj / l.energy_nj - 5.8) < 0.3


class TestStructure:
    def test_simdram_aap_formula(self):
        assert simdram_mul_aaps(4) == 155
        assert simdram_mul_aaps(8) == 663

    def test_parallelism_table(self):
        assert [lama_parallelism(b) for b in (4, 5, 6, 7, 8)] == \
            [16, 16, 8, 4, 2]

    def test_area_overhead(self):
        rep = lama_area_overhead()
        assert abs(rep.total_mm2 - 1.32) < 0.02
        assert abs(rep.overhead_pct - 2.47) < 0.05


class TestLamaAccel:
    def test_fig12_anchors_and_averages(self):
        rows = {r["workload"]: r for r in fig12_table()}
        assert abs(rows["BERT-SQuAD1"]["lama_speedup_vs_tpu"] - 3.4) < 0.05
        assert abs(rows["BERT-SST2"]["lama_speedup_vs_tpu"] - 4.7) < 0.15
        avg_s = st.mean(r["lama_speedup_vs_tpu"] for r in rows.values())
        avg_e = st.mean(r["lama_energy_saving_vs_tpu"] for r in rows.values())
        assert abs(avg_s - 4.1) / 4.1 < 0.15
        assert abs(avg_e - 7.1) / 7.1 < 0.25
        assert abs(rows["BART-CNN-DM"]["lama_speedup_vs_tpu"] - 3.6) < 0.4

    def test_fig12_bits_trend(self):
        rows = sorted(fig12_table(), key=lambda r: r["avg_bits"])
        savings = [r["lama_energy_saving_vs_tpu"] for r in rows]
        assert savings[0] == max(savings)
        assert savings[-1] == min(savings)

    def test_fig12_pluto_deficit(self):
        rows = fig12_table()
        spd = st.mean(r["lama_speedup_vs_tpu"] / r["pluto_speedup_vs_tpu"]
                      for r in rows)
        en = st.mean(r["lama_energy_saving_vs_tpu"] /
                     r["pluto_energy_saving_vs_tpu"] for r in rows)
        assert abs(spd - 1.7) < 0.2
        assert abs(en - 4.0) < 0.6

    def test_fig13_vs_gpu(self):
        rows = fig13_table()
        ppa = st.mean(r["perf_per_area_vs_gpu"] for r in rows)
        en = st.mean(r["energy_saving_vs_gpu"] for r in rows)
        assert abs(ppa - 7.2) / 7.2 < 0.25
        assert 6.0 < en < 20.0
        assert st.mean(r["raw_speedup_vs_gpu"] for r in rows) < 1.0


# ------------------------------------- parity with the reference --

def _fields(cost) -> dict:
    """Every field of a cost record, its derived properties included."""
    out = dataclasses.asdict(cost)
    if hasattr(cost, "counts"):
        out["gops"] = cost.gops
        out["energy_pj_per_op"] = cost.energy_pj_per_op
        out["row"] = cost.row()
        out["total"] = cost.counts.total
    return out


def _outcome(fn, *args, **kw):
    """A call's fields, or its error's type and message (bits the model
    refuses must be refused alike)."""
    try:
        return ("ok", _fields(fn(*args, **kw)))
    except Exception as e:      # noqa: BLE001 -- compared, not hidden
        return ("error", type(e).__name__, str(e))


BULK = (("lama_bulk_cost", "num_scalars"), ("pluto_bulk_cost", "num_batches"),
        ("simdram_bulk_cost", "num_subarrays"))


@pytest.mark.parametrize("fn", [f for f, _ in BULK] + ["cpu_bulk_cost"])
@pytest.mark.parametrize("bits", [4, 5, 6, 7, 8])
@pytest.mark.parametrize("num_ops", [1024, 4096, 96])
def test_bulk_costs_equal_the_reference(fn, bits, num_ops):
    assert _outcome(getattr(P, fn), num_ops, bits) == \
        _outcome(getattr(R, fn), num_ops, bits)


@settings(max_examples=150, deadline=None)
@given(hs.integers(1, 16), hs.integers(1, 512), hs.integers(3, 8),
       hs.sampled_from(BULK))
def test_bulk_costs_equal_the_reference_over_a_grid(num_scalars, per_scalar,
                                                    bits, fn_kw):
    fn, kw = fn_kw
    num_ops = num_scalars * per_scalar
    assert _outcome(getattr(P, fn), num_ops, bits, **{kw: num_scalars}) == \
        _outcome(getattr(R, fn), num_ops, bits, **{kw: num_scalars})


def test_command_counts_and_config_equal_the_reference():
    assert dataclasses.asdict(P.DEFAULT) == dataclasses.asdict(R.DEFAULT)
    for prop in ("cycle_ns", "banks_per_pch", "read_bit_energy",
                 "lama_logic_power_mw"):
        assert getattr(P.DEFAULT, prop) == getattr(R.DEFAULT, prop), prop
    for bits in (4, 5, 6, 7, 8):
        for m in (1, 31, 256, 1025):
            pb = importlib.import_module("repro_torch.core.pim.lama").LamaBatch(m, bits)
            rb = importlib.import_module("repro.core.pim.lama").LamaBatch(m, bits)
            assert dataclasses.asdict(pb.counts()) == dataclasses.asdict(rb.counts())
            assert pb.icas() == rb.icas()
            assert dataclasses.asdict(pb.counts().scaled(3)) == \
                dataclasses.asdict(rb.counts().scaled(3))
    for n in (0, 7, 8, 1088):
        assert P.hbm.faw_limited_act_time(P.DEFAULT, n) == \
            R.hbm.faw_limited_act_time(R.DEFAULT, n)
    for bits in (2, 4, 6, 8):
        assert P.pluto.pluto_subproblems(bits) == R.pluto.pluto_subproblems(bits)
    assert P.lama_command_reduction_vs_pluto(8, 2048) == \
        R.lama_command_reduction_vs_pluto(8, 2048)


def test_workloads_equal_the_reference():
    pw, rw = P_workloads.table_vi_workloads(), R_workloads.table_vi_workloads()
    assert [dataclasses.asdict(w) for w in pw] == [dataclasses.asdict(w) for w in rw]
    assert [w.total_macs for w in pw] == [w.total_macs for w in rw]
    for avg in (3.0, 3.48, 4.88, 6.45, 7.0):
        assert P_workloads._bit_cycle(avg, 24) == R_workloads._bit_cycle(avg, 24)


def test_calibrated_constants_equal_the_reference():
    (pl, pp), (rl, rp) = P.calibrated_models(), R.calibrated_models()
    assert (pl.rate, pl.e_work, pl.gamma_t, pl.gamma_e) == \
        (rl.rate, rl.e_work, rl.gamma_t, rl.gamma_e)
    assert (pp.rate, pp.e_q) == (rp.rate, rp.e_q)


@pytest.mark.parametrize("i", range(5))
def test_accel_costs_equal_the_reference(i):
    (pl, pp), (rl, rp) = P.calibrated_models(), R.calibrated_models()
    pw, rw = (P_workloads.table_vi_workloads()[i],
              R_workloads.table_vi_workloads()[i])
    for p, r in ((pl.cost(pw), rl.cost(rw)), (pp.cost(pw), rp.cost(rw)),
                 (P_accel.tpu_cost(pw), R_accel.tpu_cost(rw)),
                 (P_accel.gpu_cost(pw), R_accel.gpu_cost(rw))):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
    for layer_p, layer_r in zip(pw.layers, rw.layers):
        assert P_accel.icas_per_16_macs(layer_p.bits) == \
            R_accel.icas_per_16_macs(layer_r.bits)


def test_tables_equal_the_reference():
    assert P.fig12_table() == R.fig12_table()
    assert P.fig13_table() == R.fig13_table()
    pa, ra = P.lama_area_overhead(), R.lama_area_overhead()
    assert dataclasses.asdict(pa) == dataclasses.asdict(ra)
    assert pa.rows() == ra.rows()
    assert dataclasses.asdict(P.lama_area_overhead(4, 8)) == \
        dataclasses.asdict(R.lama_area_overhead(4, 8))
    m, k, n = 384, 768, 2304
    assert P.EdgeTPUModel().matmul_cost(m, k, n) == \
        R.EdgeTPUModel().matmul_cost(m, k, n)
    assert P.A6000Model().matmul_cost(m, k, n) == \
        R.A6000Model().matmul_cost(m, k, n)


# ------------------------------------------------ the paper tables --

@pytest.fixture(scope="module")
def reference_scripts():
    sys.path.insert(0, str(ROOT))
    try:
        yield {name: importlib.import_module(f"benchmarks.{mod}")
               for name, mod in (("table4", "table4_area"),
                                 ("table5", "table5_bulk_mult"),
                                 ("fig12", "fig12_lamaaccel_vs_tpu"),
                                 ("fig13", "fig13_lamaaccel_vs_gpu"))}
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.parametrize("name", ["table4", "table5", "fig12", "fig13"])
def test_table_rows_equal_the_reference_script(name, reference_scripts):
    rows = getattr(pim_tables, f"{name}_rows")()
    assert rows == reference_scripts[name].rows()
    assert rows and all(r["name"].startswith(name + "/") for r in rows)


def test_main_prints_the_example(capsys):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        example = importlib.import_module("pim_table5")
    finally:
        sys.path.remove(str(ROOT / "examples"))
    example.main()
    expected = capsys.readouterr().out
    pim_tables.main()
    assert capsys.readouterr().out == expected
    assert "Lama" in expected and "fig 13" in expected
