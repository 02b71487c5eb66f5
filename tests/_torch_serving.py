"""Shared harness of the port's lifecycle, chaos and telemetry parity
tests: the JAX package's serving classes and the port's, side by side,
on the same weights (the reference's, carried across by
``params_from_jax``), at the tiny size of the reference's own tests.

A scenario is a function of a :class:`Side` that drives its engines
with the same calls on either package and returns what it observed.
Codes weights and act-quant tables are fit by the port and handed to
both sides.
``both(scenario)`` runs it on the reference and on the port (CPU) and
requires every observation equal: per tick the requests' statuses and
token counts, the free pages, lengths, quarantined lanes and the pages
under checksum; then completions, counters, ``fault_stats`` and
snapshots (wall times excluded).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import api as jax_api
from repro.runtime import chaos as jchaos
from repro.runtime import engine as jengine
from repro.runtime import fault_tolerance as jft
from repro.runtime import telemetry as jtel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import lama_layers as tll
from repro_torch.core.exponential_quant import QWeight
from repro_torch.models import api as torch_api
from repro_torch.models.transformer import DecoderLM
from repro_torch.runtime import calibration as tcal
from repro_torch.runtime import chaos as tchaos
from repro_torch.runtime import engine as tengine
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import telemetry as ttel

TINY = dict(num_layers=2, d_model=64, d_ff=128, compute_dtype="float32")
# the weight sets: the lifecycle tests' model, the spec tests' (64 ids)
# and the act-quant tests' (7-bit weights, 128 ids, d_ff 192, act-quant
# tables attached)
KINDS = {"float": {}, "spec": dict(vocab_size=64),
         "codes": dict(vocab_size=128, d_ff=192)}
# wall-clock readings: never compared
TIMED = {"slow_ticks", "tick_p50_s", "tick_p99_s", "tick_mean_s"}
COUNTERS = tuple(a for a in jengine._ENGINE_COUNTERS if a not in TIMED)
TICK_CAP = 3000


def cfgs(kind: str = "float", arch: str = "qwen3-1.7b"):
    kw = {**TINY, **KINDS[kind]}
    return (jax_get_config(arch, tiny=True).replace(**kw),
            get_config(arch, tiny=True).replace(**kw))


def jax_tree(node):
    """The reference's params tree holding a port tree's values (a
    ``QWeight`` as its ``{codes, lut, qmeta}`` dict)."""
    if isinstance(node, QWeight):
        return {k: jnp.asarray(getattr(node, k).numpy())
                for k in ("codes", "lut", "qmeta")}
    if isinstance(node, dict):
        return {k: jax_tree(v) for k, v in node.items()}
    return jnp.asarray(node.numpy())


@functools.lru_cache(maxsize=None)
def weights(kind: str = "float", arch: str = "qwen3-1.7b"):
    """(reference params, the port's DecoderLM on the CPU, act-quant
    report or None): the reference's float weights of seed 0 for
    ``arch``; for ``codes`` those quantized to 7 bits with act-quant
    tables (per-head attn_k/attn_v included) fit by the port on 4
    prompts of 32 tokens (seed 0), handed to both sides, and the fit's
    report."""
    jcfg, cfg = cfgs(kind, arch)
    params = jax_api.get_model(jcfg).init(jax.random.PRNGKey(0),
                                          dtype=jnp.float32)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    if kind != "codes":
        return params, model, None
    api = torch_api.get_model(cfg)
    qtree, _ = tll.quantize_tree(model.tree(), 7, axes=api.logical_axes())
    model = DecoderLM(cfg, qtree, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int64)
    with torch.no_grad():
        samples = api.collect_act_calibration(model, torch.from_numpy(prompts),
                                              cfg)
    act_q, report = tcal.fit_sites(samples, 7)
    model = tcal.attach_act_quant(model, act_q)
    return jax_tree(model.tree()), model, report


class Side:
    """One package's serving classes, on the shared weights."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.E = jengine if ref else tengine
        self.chaos = jchaos if ref else tchaos
        self.tel = jtel if ref else ttel
        self.ft = jft if ref else tft
        self.name = "reference" if ref else "port"

    def cfg(self, kind: str = "float", arch: str = "qwen3-1.7b"):
        return cfgs(kind, arch)[0 if self.ref else 1]

    def engine(self, kind: str = "float", *, ec: dict | None = None,
               chaos: dict | None = None, arch: str = "qwen3-1.7b", **kw):
        jp, tp, report = weights(kind, arch)
        if chaos is not None:
            kw["chaos"] = self.chaos.ChaosConfig(**chaos)
        if not self.ref:
            kw["device"] = "cpu"
        eng = self.E.Engine(self.cfg(kind, arch), params=jp if self.ref else tp,
                            engine=self.E.EngineConfig(**(ec or {})), **kw)
        if report is not None:
            eng.act_report = report     # what its calibration reports
        return eng

    def request(self, *a, **kw):
        return self.E.Request(*a, **kw)

    def poke_nan(self, eng, page: int) -> None:
        """NaN into every element of ``page`` (K and V, all layers)."""
        c = eng.cache
        if self.ref:
            c.k_pages = c.k_pages.at[:, page].set(jnp.nan)
            c.v_pages = c.v_pages.at[:, page].set(jnp.nan)
        else:
            c.k_pages[:, page] = float("nan")
            c.v_pages[:, page] = float("nan")


def prompt(vocab: int, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def tick_state(eng) -> tuple:
    """What a tick leaves, wall times excluded."""
    return (eng._tick_no,
            sorted((int(uid), st.status, st.term, len(st.tokens))
                   for uid, st in eng._states.items()),
            eng.cache.allocator.free_blocks,
            [int(x) for x in eng.cache.lengths],
            sorted(eng._quarantined.items()),
            sorted(eng._page_crc))


def ticked(eng, log: list) -> None:
    """One tick, the partition audited, its state logged."""
    eng.step()
    eng.check_partition()
    log.append(tick_state(eng))


def drain(eng, log: list) -> list:
    """Tick until idle (partition after every tick), then collect;
    completions as (uid, status, tokens, decode steps)."""
    n = 0
    while eng.pending:
        ticked(eng, log)
        n += 1
        assert n < TICK_CAP, "drain did not converge"
    done = eng.run()
    eng.check_partition()
    return outs(done)


def outs(done) -> list:
    return [(int(c.uid), c.status, np.asarray(c.tokens).tolist(),
             c.decode_steps) for c in sorted(done, key=lambda c: c.uid)]


def counters(eng) -> dict:
    return {a: getattr(eng, a) for a in COUNTERS}


def faults(eng) -> dict:
    return {k: v for k, v in eng.fault_stats().items() if k not in TIMED}


def snap(eng) -> dict:
    s = eng.snapshot()
    for r in s["requests"]:
        r.pop("submit_t")
    return s


def artifact(art: dict) -> dict:
    """A replay artifact without its wall times: the flight records'
    ``t``/``dt_s`` and the trace's stamp times."""
    a = dict(art)
    a["flight_recorder"] = [{k: v for k, v in r.items()
                             if k not in ("t", "dt_s")}
                            for r in art["flight_recorder"]]
    if art["trace"] is not None:
        a["trace"] = [{k: v for k, v in s.items() if k != "t"}
                      for s in art["trace"]["stamps"]]
    return a


def both(scenario, *args):
    """``scenario(side, log, *args)`` on the reference and on the port:
    the logs and the observations must be equal.  Returns the port's
    observation."""
    seen = []
    for ref in (True, False):
        log: list = []
        seen.append((scenario(Side(ref), log, *args), log))
    (jobs, jlog), (obs, log) = seen
    assert len(log) == len(jlog), (len(log), len(jlog))
    for t, (a, b) in enumerate(zip(jlog, log)):
        assert a == b, f"tick {t}: reference {a} != port {b}"
    assert obs == jobs
    return obs
