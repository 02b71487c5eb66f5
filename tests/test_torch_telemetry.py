"""The port's telemetry against the JAX package's, on the CPU.

- ``tests/test_telemetry.py``'s cases of the metrics registry, the
  latency tracker, the tracer, the Chrome-trace validation, the flight
  recorder and the engine's traces (lines 59-376; the cluster's wait
  for ROADMAP item 12), run on the port's copy of ``runtime/telemetry.py``
  and the port's Engine.
- Parity: on the same weights and requests, the port's engine registers
  the reference's registry keys with the same values (wall-time gauges
  excluded), and every request's trace has the reference's phases.
- The calibration drift guard (``TestDriftGuard`` of
  ``tests/test_spec_decode.py``) on both engines under the same
  act-quant tables and calibration report: the same checks, gauges and
  warnings, each site's serving SQNR within 0.05 dB of the reference's.
"""

import gc
import json
import warnings
import weakref

import numpy as np
import pytest
import torch

from _torch_serving import Side, both, drain, prompt
from repro_torch.configs import get_config
from repro_torch.runtime.chaos import ChaosConfig
from repro_torch.runtime.engine import Engine as _Engine
from repro_torch.runtime.engine import (ST_FAILED, ST_OK, EngineConfig,
                                        Request)
from repro_torch.runtime.fault_tolerance import LatencyTracker
from repro_torch.runtime.telemetry import (REQUESTS_PID, SCHED_TID,
                                           FlightRecorder, MetricsRegistry,
                                           Telemetry, Tracer, lane_tid,
                                           validate_chrome_trace)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def Engine(cfg, **kw):
    """The port's Engine on the CPU."""
    return _Engine(cfg, device="cpu", **kw)


def tiny_cfg(**kw):
    base = dict(num_layers=2, d_model=64, d_ff=128,
                compute_dtype="float32")
    base.update(kw)
    return get_config("qwen3-1.7b", tiny=True).replace(**base)


def ecfg(**kw):
    base = dict(num_slots=4, block_size=8, max_seq_len=96,
                prefill_chunk=16)
    base.update(kw)
    return EngineConfig(**base)


def reqs_for(cfg, n, seed=0, max_new=4):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(1, cfg.vocab_size,
                                    int(rng.integers(8, 20))
                                    ).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


class TestRegistry:
    def test_counter_gauge_histogram_basics(self):
        reg = MetricsRegistry()
        c = reg.counter("engine.prefill.chunks")
        c.inc()
        c.inc(3)
        c.inc(True)                      # bool increments like 1
        assert reg.value("engine.prefill.chunks") == 5

        state = {"depth": 7}
        reg.gauge("engine.queue.depth", fn=lambda: state["depth"])
        assert reg.value("engine.queue.depth") == 7
        state["depth"] = 2               # callback reads live state
        assert reg.value("engine.queue.depth") == 2

        h = reg.histogram("engine.tick.latency")
        for v in [0.1, 0.2, 0.3]:
            h.observe(v)
        assert h.count == 3
        assert reg.value("engine.tick.latency")["p50_s"] == \
            pytest.approx(0.2)

    def test_get_or_create_is_idempotent(self):
        reg = MetricsRegistry()
        assert reg.counter("a.b") is reg.counter("a.b")
        assert reg.gauge("a.g") is reg.gauge("a.g")

    def test_kind_conflict_raises(self):
        reg = MetricsRegistry()
        reg.counter("a.b")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("a.b")

    def test_scope_prefixes_and_identity(self):
        reg = MetricsRegistry()
        s = reg.scope("prefill0")
        s.counter("engine.handoff.exported").inc(2)
        assert "prefill0.engine.handoff.exported" in reg
        assert s.value("engine.handoff.exported") == 2
        ident = reg.scope("")            # standalone engine: no prefix
        ident.counter("engine.ticks").inc()
        assert reg.value("engine.ticks") == 1

    def test_snapshot_render_and_jsonl(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("cluster.handoff.bytes").inc(1024)
        reg.gauge("router.held", fn=lambda: 3)
        snap = reg.snapshot()
        assert snap == {"cluster.handoff.bytes": 1024, "router.held": 3}
        text = reg.render("cluster.")
        assert "cluster.handoff.bytes = 1024" in text
        assert "router.held" not in text
        p = tmp_path / "metrics.jsonl"
        reg.dump_jsonl(str(p), label="t0")
        reg.dump_jsonl(str(p))           # appends
        lines = [json.loads(ln) for ln in p.read_text().splitlines()]
        assert len(lines) == 2
        assert lines[0]["label"] == "t0"
        assert lines[0]["metrics"]["cluster.handoff.bytes"] == 1024
        assert "t_wall_s" in lines[1] and "label" not in lines[1]


# --------------------------------------------------------- latency tracker

class TestLatencyTracker:
    def test_empty_percentiles_are_zero(self):
        t = LatencyTracker()
        assert t.percentile(50) == 0.0
        assert t.percentile(99) == 0.0
        assert t.mean_s == 0.0
        assert t.summary() == {"count": 0, "mean_s": 0.0,
                               "p50_s": 0.0, "p99_s": 0.0}

    def test_single_sample(self):
        t = LatencyTracker()
        t.observe(0.25)
        assert t.percentile(50) == pytest.approx(0.25)
        assert t.percentile(99) == pytest.approx(0.25)
        assert t.summary()["count"] == 1
        assert t.summary()["mean_s"] == pytest.approx(0.25)

    def test_reservoir_is_deterministic(self):
        """Two trackers fed the identical stream retain the identical
        strided subsample — percentiles are a pure function of the
        observation sequence (no rng in the reservoir)."""
        rng = np.random.default_rng(0)
        stream = rng.random(3 * 4096).tolist()
        a, b = LatencyTracker(), LatencyTracker()
        for v in stream:
            a.observe(v)
            b.observe(v)
        assert a.samples == b.samples
        assert len(a.samples) < len(stream)          # it did subsample
        assert a.count == len(stream)                # but counted all
        assert a.percentile(99) == b.percentile(99)

    def test_mean_is_exact_despite_subsampling(self):
        t = LatencyTracker()
        n = 2 * 4096
        for _ in range(n):
            t.observe(0.5)
        assert t.count == n
        assert t.mean_s == pytest.approx(0.5)


# ----------------------------------------------------------------- tracer

class TestTracer:
    def test_disabled_emits_nothing(self):
        tr = Tracer(enabled=False)
        tr.complete(0, 0, "tick", 0.0, 1.0)
        tr.instant(0, 0, "fault")
        tr.counter(0, "queue", depth=3)
        tr.flow_start(0, 0, "h", 1)
        assert tr.events == []

    def test_event_shapes_and_relative_us(self):
        now = [100.0]
        tr = Tracer(clock=lambda: now[0], enabled=True)
        tr.complete(1, lane_tid(0), "decode", 100.001, 100.003, uid=7)
        ev = tr.events[0]
        assert ev["ph"] == "X" and ev["pid"] == 1
        assert ev["ts"] == pytest.approx(1000.0)     # us past t0
        assert ev["dur"] == pytest.approx(2000.0)
        assert ev["args"]["uid"] == 7
        tr.flow_start(1, SCHED_TID, "kv_handoff", 5, 100.004)
        tr.flow_end(2, SCHED_TID, "kv_handoff", 5, 100.005)
        s, f = tr.events[1], tr.events[2]
        assert (s["ph"], f["ph"]) == ("s", "f")
        assert s["id"] == f["id"] == 5 and s["cat"] == "handoff"

    def test_ring_bound_counts_drops(self):
        tr = Tracer(enabled=True, max_events=2)
        for i in range(5):
            tr.instant(0, 0, f"e{i}", t=float(i))
        assert len(tr.events) == 2 and tr.dropped == 3
        assert tr.export()["metadata"]["dropped_events"] == 3

    def test_export_includes_track_names(self, tmp_path):
        tr = Tracer(enabled=True)
        tr.process_name(0, "prefill0")
        tr.thread_name(0, lane_tid(2), "slot2")
        tr.instant(0, SCHED_TID, "tick", t=tr._t0)
        p = tmp_path / "trace.json"
        doc = tr.export(str(p))
        metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
        assert {m["name"] for m in metas} == {"process_name",
                                              "thread_name"}
        assert json.loads(p.read_text()) == doc      # file round-trips
        assert tr.write_jsonl(str(tmp_path / "t.jsonl")) == 1

    def test_flow_ids_are_unique_per_export(self):
        tr = Tracer(enabled=True)
        assert tr.next_flow_id() != tr.next_flow_id()


# ------------------------------------------------------------- validation

def _span(pid, tid, name, ts, dur, **args):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name,
            "ts": ts, "dur": dur, "args": args}


class TestValidateChromeTrace:
    def test_valid_nested_doc_passes(self):
        doc = {"traceEvents": [
            _span(REQUESTS_PID, 1, "request", 0.0, 100.0, uid=1),
            _span(REQUESTS_PID, 1, "queued", 0.0, 10.0, uid=1),
            _span(REQUESTS_PID, 1, "decode", 10.0, 90.0, uid=1),
            _span(0, lane_tid(0), "prefill_chunk", 1.0, 5.0, uid=1),
            _span(1, lane_tid(0), "decode", 20.0, 5.0, uid=1),
            {"ph": "s", "cat": "handoff", "id": 1, "pid": 0, "tid": 0,
             "name": "kv_handoff", "ts": 8.0, "args": {}},
            {"ph": "f", "bp": "e", "cat": "handoff", "id": 1, "pid": 1,
             "tid": 0, "name": "kv_handoff", "ts": 9.0, "args": {}},
        ]}
        st = validate_chrome_trace(doc, require_boundary=True)
        assert st["requests"] == 1 and st["flows"] == 1
        assert st["boundary_requests"] == 1          # pids {0, 1}

    def test_overlapping_spans_raise(self):
        doc = {"traceEvents": [_span(0, 0, "a", 0.0, 10.0),
                               _span(0, 0, "b", 5.0, 10.0)]}
        with pytest.raises(ValueError, match="overlaps"):
            validate_chrome_trace(doc)

    def test_duplicate_request_span_raises(self):
        doc = {"traceEvents": [
            _span(REQUESTS_PID, 1, "request", 0.0, 1.0, uid=1),
            _span(REQUESTS_PID, 1, "request", 5.0, 1.0, uid=1)]}
        with pytest.raises(ValueError, match="multiple terminal"):
            validate_chrome_trace(doc)

    def test_orphan_flow_raises(self):
        doc = {"traceEvents": [
            {"ph": "s", "cat": "handoff", "id": 9, "pid": 0, "tid": 0,
             "name": "kv_handoff", "ts": 0.0, "args": {}}]}
        with pytest.raises(ValueError, match="orphan"):
            validate_chrome_trace(doc)

    def test_negative_ts_and_unknown_phase_raise(self):
        with pytest.raises(ValueError, match="negative ts"):
            validate_chrome_trace(
                {"traceEvents": [_span(0, 0, "a", -1.0, 1.0)]})
        with pytest.raises(ValueError, match="unknown event phase"):
            validate_chrome_trace(
                {"traceEvents": [{"ph": "Z", "ts": 0.0}]})

    def test_require_boundary(self):
        doc = {"traceEvents": [_span(0, 0, "decode", 0.0, 1.0, uid=1)]}
        validate_chrome_trace(doc)                   # fine un-required
        with pytest.raises(ValueError, match="boundary"):
            validate_chrome_trace(doc, require_boundary=True)


# --------------------------------------------------------- flight recorder

class TestFlightRecorder:
    def test_ring_is_bounded(self):
        fr = FlightRecorder(capacity=4)
        for i in range(10):
            fr.record(tick=i)
        assert len(fr) == 4 and fr.recorded == 10
        assert [r["tick"] for r in fr.dump()] == [6, 7, 8, 9]


# ----------------------------------------------------- engine trace facts

class TestEngineTracing:
    def test_every_request_one_terminal_monotonic_trace(self):
        cfg = tiny_cfg()
        tel = Telemetry(tracing=True)
        eng = Engine(cfg, engine=ecfg(), telemetry=tel)
        reqs = reqs_for(cfg, 5)
        out = eng.generate(reqs)
        assert all(c.status == ST_OK for c in out)
        assert sorted(tel.traces) == [r.uid for r in reqs]
        for tr in tel.traces.values():
            tr.assert_monotonic()
            ph = tr.phases()
            assert ph[0] == "submit" and ph[-1] == "terminal"
            assert ph.count("terminal") == 1         # exactly one
            assert tr.status == ST_OK
            assert "admit" in ph and "first_token" in ph
            assert ph.count("prefill_chunk") >= 1
            assert ph.count("decode_tick") >= 1

        doc = tel.tracer.export()
        st = validate_chrome_trace(doc)
        assert st["requests"] == len(reqs)           # one span per uid
        assert st["spans"] > 0 and st["tracks"] > 1

    def test_untraced_engine_archives_nothing(self):
        cfg = tiny_cfg()
        tel = Telemetry(tracing=False)
        eng = Engine(cfg, engine=ecfg(), telemetry=tel)
        eng.generate(reqs_for(cfg, 3))
        assert tel.traces == {}
        assert tel.tracer.events == []

    def test_injected_clock_drives_stamps(self):
        """Satellite (a): ONE injectable monotonic clock.  A fake
        clock handed to Telemetry is what every stamp reads."""
        cfg = tiny_cfg()
        now = [1000.0]
        tel = Telemetry(tracing=True, clock=lambda: now[0])
        eng = Engine(cfg, engine=ecfg(), telemetry=tel)
        eng.submit(reqs_for(cfg, 1)[0])
        now[0] = 1001.0
        while eng.pending:
            eng.step()
            now[0] += 1.0
        (tr,) = tel.traces.values()
        assert tr.submit_t == 1000.0
        assert tr.last_t > 1000.0 and tr.last_t <= now[0]

    def test_fault_stats_shim_shape_and_registry_agree(self):
        cfg = tiny_cfg()
        eng = Engine(cfg, engine=ecfg(),
                     chaos=ChaosConfig(seed=0))
        eng.generate(reqs_for(cfg, 2))
        fs = eng.fault_stats()
        assert set(fs) >= {"ticks", "cancelled", "deadline_expired",
                           "shed", "failed", "starvation_pins",
                           "alloc_faults_absorbed", "nan_rows_detected",
                           "corruptions_detected", "quarantines",
                           "slow_ticks", "tick_p50_s", "tick_p99_s",
                           "tick_mean_s", "chaos_seed"}
        # counter attributes ARE registry views: writes through the
        # legacy attribute land in the store and vice versa
        eng.shed += 2
        assert eng.metrics.value("engine.lifecycle.shed") == 2
        assert eng.fault_stats()["shed"] == 2
        assert eng.metrics.value("engine.ticks") == fs["ticks"]

    def test_failed_request_artifact_carries_flight_and_trace(
            self, tmp_path):
        """Flight recorder + trace ride the chaos replay artifact on
        any ``failed`` terminal — the post-mortem black box."""
        cfg = tiny_cfg()
        tel = Telemetry(tracing=True)
        eng = Engine(cfg, engine=ecfg(num_slots=1, quarantine_ticks=1,
                                      replay_dir=str(tmp_path)),
                     telemetry=tel, chaos=ChaosConfig(seed=2,
                                                      nan_rate=1.0))
        out = eng.generate(reqs_for(cfg, 1))
        assert out[0].status == ST_FAILED
        (art,) = eng.replay_artifacts
        assert art["flight_recorder"], "flight ring missing"
        assert {"tick", "queue_depth", "live_slots",
                "free_pages"} <= set(art["flight_recorder"][-1])
        assert art["trace"]["uid"] == 0
        phases = [s["phase"] for s in art["trace"]["stamps"]]
        assert "fault" in phases
        (tr,) = tel.traces.values()
        assert tr.status == ST_FAILED



# ------------------------------------------------ parity with the reference

# gauges that read wall time
_TIMED_KEYS = ("engine.tick.", "engine.faults.slow_ticks")


def registry_and_traces(side, log, chaos, worker):
    """Six requests through an engine with tracing on; with ``chaos``
    one NaN dispatch in three fails a request (artifact, lane rest).
    ``worker`` names the engine (its key prefix) and numbers its trace
    row."""
    tel = side.tel.Telemetry(tracing=True)
    eng = side.engine(ec=dict(num_slots=4, block_size=8, max_seq_len=96,
                              prefill_chunk=16, quarantine_ticks=2),
                      telemetry=tel, worker_name=worker,
                      worker_id=1 if worker else 0,
                      chaos=dict(seed=4, nan_rate=0.3) if chaos else None)
    v = side.cfg().vocab_size
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(side.request(i, rng.integers(1, v, int(rng.integers(8, 30)))
                                .astype(np.int32), max_new_tokens=6))
    out = drain(eng, log)
    reg = {k: v for k, v in tel.registry.snapshot().items()
           if not k.removeprefix(f"{worker}.").startswith(_TIMED_KEYS)}
    phases = {uid: (tr.status, tr.phases()) for uid, tr in tel.traces.items()}
    doc = tel.tracer.export()
    spans = sorted((e["pid"], e["tid"], e["name"])
                   for e in doc["traceEvents"] if e["ph"] == "X")
    st = validate_chrome_trace(doc)
    return out, reg, phases, spans, st["requests"]


@pytest.mark.parametrize("chaos,worker", [(False, ""), (True, "w0")],
                         ids=["clean", "nan"])
def test_registry_and_trace_phases_equal_reference(chaos, worker):
    """The nan case also names its engine: the keys under its prefix and
    its spans on its own trace row, as the reference's."""
    out, reg, phases, spans, n = both(registry_and_traces, chaos, worker)
    assert n == 6 and len(phases) == 6
    pre = f"{worker}." if worker else ""
    assert f"{pre}engine.lifecycle.failed" in reg
    assert f"{pre}engine.pages.free" in reg
    assert {pid for pid, _, _ in spans} == {1 if worker else 0, REQUESTS_PID}
    assert any(s == "failed" for _, s, _, _ in out) == chaos


# ------------------------------------------------------ engine lifetime

@pytest.mark.parametrize("kind", ["own", "shared-chaos", "spec-drift"])
def test_dropped_engine_is_freed_without_a_cyclic_collection(kind):
    """The registry's gauges hold the engine and its cache weakly, so an
    engine that has served (prefix cache, chaos, spec, drift guard) goes
    with its page pools as soon as its last reference does, with the
    cyclic collector off -- also while a shared telemetry bundle lives
    on, whose gauges of it then read 0."""
    side = Side(False)
    tel = Telemetry(tracing=True) if kind == "shared-chaos" else None
    ec = dict(num_slots=2, block_size=8, max_seq_len=96, prefill_chunk=16)
    if kind == "spec-drift":
        ec.update(spec_k=2, drift_check_every=2)
    weights = "codes" if kind == "spec-drift" else "float"
    eng = side.engine(weights, ec=ec, telemetry=tel,
                      chaos=(dict(seed=3, nan_rate=0.3, corrupt_rate=0.1)
                             if kind == "shared-chaos" else None))
    v = side.cfg(weights).vocab_size
    for i in range(3):
        eng.submit(Request(i, prompt(v, 12 + i, i), max_new_tokens=6))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng.run()
    assert eng.telemetry.registry.snapshot()["engine.ticks"] > 0
    if kind == "spec-drift":
        assert eng.drift_checks > 0 and eng.spec_dispatches > 0
    alive, pool = weakref.ref(eng), weakref.ref(eng.cache.k_pages)
    gc.disable()
    try:
        del eng
        assert alive() is None and pool() is None
    finally:
        gc.enable()
    if tel is not None:
        snap = tel.registry.snapshot()
        assert snap["engine.ticks"] == 0
        assert snap["engine.pages.bytes_in_use"] == 0


# ---------------------------------------------------------- drift guard

DRIFT_SQNR_TOL_DB = 0.05


def drift_run(side, log, threshold):
    eng = side.engine("codes", ec=dict(num_slots=4, block_size=8,
                                       max_seq_len=160, prefill_chunk=16,
                                       drift_check_every=4,
                                       drift_threshold_db=threshold))
    v = side.cfg("codes").vocab_size
    for i in range(4):
        eng.submit(side.request(i, prompt(v, 16, i), max_new_tokens=16))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = drain(eng, log)
    warned = [str(w.message) for w in caught
              if "calibration drift" in str(w.message)]
    keys = sorted(k for k in eng.telemetry.registry.keys()
                  if k.startswith("calib.drift."))
    return (out, eng.drift_checks, eng.drift_warnings, len(warned), keys,
            dict(eng._drift_db), dict(eng._drift_delta_db))


@pytest.mark.parametrize("threshold", [6.0, 0.0], ids=["quiet", "tight"])
def test_drift_guard_equals_reference(threshold):
    """The reference test's runs (4 requests of 16 tokens, 16 new, a
    check every 4 ticks) on both engines: the same checks, gauge keys,
    warnings and streams; each site's serving SQNR and its delta within
    0.05 dB of the reference's (two packages' forwards over the same
    probe).  At 6 dB in-distribution traffic stays quiet; at 0 dB the
    in-sample/live gap warns."""
    got = {}
    for ref in (True, False):
        got[ref] = drift_run(Side(ref), [], threshold)
    (jout, jchecks, jwarn, jn, jkeys, jdb, jdelta) = got[True]
    (out, checks, warn, n, keys, db, delta) = got[False]
    assert (out, checks, keys) == (jout, jchecks, jkeys)
    assert checks > 0 and any(k.endswith("_db") for k in keys)
    assert set(db) == set(jdb) and all(np.isfinite(x) for x in db.values())
    for site in jdb:
        assert abs(db[site] - jdb[site]) <= DRIFT_SQNR_TOL_DB, site
        assert abs(delta[site] - jdelta[site]) <= DRIFT_SQNR_TOL_DB, site
    # a site whose delta sits within the tolerance of the threshold may
    # warn on one side only
    near = sum(abs(d + threshold) <= DRIFT_SQNR_TOL_DB
               for d in jdelta.values()) * checks
    assert abs(warn - jwarn) <= near and warn == n
    if threshold == 6.0:
        assert warn == jwarn == 0
    else:
        assert warn > 0 and jwarn > 0


def test_drift_guard_disabled_by_default():
    eng = Side(False).engine("codes", ec=dict(num_slots=4, block_size=8,
                                              max_seq_len=96))
    eng.generate([Request(0, prompt(128, 16), max_new_tokens=8)])
    assert eng.drift_checks == 0
    assert not [k for k in eng.telemetry.registry.keys()
                if k.startswith("calib.drift.") and k.endswith("_db")]


def test_drift_guard_on_a_calibrating_engine(tmp_path, monkeypatch):
    """An engine that fits its own tables (``act_quant=7``) compares with
    its own calibration report: checks run, gauges appear, and
    in-distribution traffic stays within the default 6 dB."""
    monkeypatch.setenv("REPRO_ACT_CALIB_CACHE", str(tmp_path / "calib.json"))
    cfg = tiny_cfg(vocab_size=128, d_ff=192)
    eng = Engine(cfg, act_quant=7, engine=ecfg(drift_check_every=4,
                                               max_seq_len=160))
    assert eng.act_report is not None
    for i in range(4):
        eng.submit(Request(i, prompt(128, 16, i), max_new_tokens=16))
    eng.run()
    assert eng.drift_checks > 0 and eng.drift_warnings == 0
    assert eng.metrics.value("calib.drift.warnings") == 0
