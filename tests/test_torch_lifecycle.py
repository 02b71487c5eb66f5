"""The port's request lifecycle against the JAX package's, on the CPU.

Each scenario of ``tests/test_lifecycle.py`` (cancel at every stage,
deadlines, backpressure, the starvation guard, ``result``/``stream``,
snapshot/restore, the tick watchdog) and of ``TestLifecycleMidSpec`` in
``tests/test_spec_decode.py`` (cancel, deadline, preemption, a chaos
storm and a snapshot in the middle of speculation) runs on the
reference's Engine and on the port's, on the same weights, with the
reference test's own assertions on both.  Equal, exactly: per tick the
requests' statuses and token counts, free pages, lengths, quarantined
lanes and checksummed pages (``check_partition`` after every tick);
then the completions (status, tokens), the counters, ``fault_stats``
(wall times excluded) and the snapshots (``submit_t`` excluded).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_serving import (both, counters, drain, faults, outs, prompt,
                            snap, ticked)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread: the engines run many small ops a tick, which
    spin-wait across a full thread pool when the suite's workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ec(**kw):
    base = dict(num_slots=2, block_size=8, max_seq_len=96, prefill_chunk=16)
    base.update(kw)
    return base


def _v(side, kind="float"):
    return side.cfg(kind).vocab_size


# ------------------------------------------------------- cancellation --

def cancel_queued(side, log):
    eng = side.engine(ec=_ec(num_slots=1))
    eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=4))
    eng.submit(side.request(1, prompt(_v(side), 8, 1), max_new_tokens=4))
    ticked(eng, log)                    # admits 0; 1 stays queued
    assert eng.cancel(1)
    eng.check_partition()
    out = drain(eng, log)
    by = {u: (s, t) for u, s, t, _ in out}
    assert by[0][0] == "ok" and len(by[0][1]) == 4
    assert by[1] == ("cancelled", [])
    return out, counters(eng), faults(eng)


def cancel_mid_first_prefill_chunk(side, log):
    eng = side.engine(ec=_ec())
    eng.submit(side.request(0, prompt(_v(side), 48), max_new_tokens=4))
    ticked(eng, log)                    # one 16-token chunk of 48
    st = eng._states[0]
    assert not st.prefill_done and st.prefill_pos > 0
    free = eng.cache.allocator.free_blocks
    assert eng.cancel(0)
    eng.check_partition()
    assert eng.cache.allocator.free_blocks > free and not eng.pending
    return eng.result(0).status, counters(eng), faults(eng), snap(eng)


def cancel_between_prefill_chunks(side, log):
    eng = side.engine(ec=_ec())
    eng.submit(side.request(0, prompt(_v(side), 48), max_new_tokens=4))
    ticked(eng, log)
    ticked(eng, log)                    # two chunks in, prompt not done
    assert not eng._states[0].prefill_done
    assert eng.cancel(0)
    eng.check_partition()
    assert not eng.pending
    return outs(eng.collect()), counters(eng)


def cancel_mid_decode_keeps_tokens(side, log):
    eng = side.engine(ec=_ec())
    eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=32))
    for _ in range(4):
        ticked(eng, log)
    got = len(eng._states[0].tokens)
    assert eng._states[0].prefill_done and got >= 2
    assert eng.cancel(0)
    eng.check_partition()
    c = eng.result(0)
    assert c.status == "cancelled" and len(c.tokens) == got
    return c.tokens.tolist(), counters(eng), faults(eng)


def cancel_after_retirement_is_noop(side, log):
    eng = side.engine(ec=_ec())
    eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=2))
    while eng.pending:
        ticked(eng, log)
    assert not eng.cancel(0) and not eng.cancel(99)
    assert eng.result(0).status == "ok" and eng.cancelled == 0
    return eng.result(0).tokens.tolist(), counters(eng)


def cancel_decrements_prefix_pins(side, log):
    eng = side.engine(ec=_ec())
    warm = side.request(0, prompt(_v(side), 32), max_new_tokens=2)
    first = outs(eng.generate([warm]))
    tail = np.concatenate([np.asarray(warm.prompt), prompt(_v(side), 32, 3)])
    eng.submit(side.request(1, tail, max_new_tokens=4))
    ticked(eng, log)                    # admitted, prefix pinned
    pins = eng.prefix.pins()
    assert pins
    assert eng.cancel(1)
    eng.check_partition()
    assert not eng.prefix.pins()
    return first, pins, sorted(eng.prefix.pages()), counters(eng)


# ------------------------------------------------ deadlines & shedding --

def deadline_expires_queued(side, log):
    eng = side.engine(ec=_ec(num_slots=1, max_seq_len=64))
    t0 = eng._clock()
    eng._clock = lambda: t0
    eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=4))
    eng.submit(side.request(1, prompt(_v(side), 8, 1), max_new_tokens=4,
                            deadline_s=5.0))
    ticked(eng, log)                    # 0 admitted, 1 waits
    eng._clock = lambda: t0 + 10.0
    ticked(eng, log)                    # 1's budget blown in the queue
    assert eng.result(1).status == "deadline_exceeded"
    assert eng.deadline_expired == 1
    out = drain(eng, log)
    assert dict((u, s) for u, s, _, _ in out)[0] == "ok"
    return out, counters(eng), faults(eng)


def deadline_expires_mid_decode(side, log):
    eng = side.engine(ec=_ec(num_slots=1))
    t0 = eng._clock()
    eng._clock = lambda: t0
    eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=64,
                            deadline_s=5.0))
    for _ in range(3):
        ticked(eng, log)
    got = len(eng._states[0].tokens)
    assert got >= 1
    eng._clock = lambda: t0 + 6.0
    ticked(eng, log)
    c = eng.result(0)
    assert c.status == "deadline_exceeded" and len(c.tokens) >= got
    assert not eng.pending
    return c.tokens.tolist(), counters(eng), faults(eng)


def backpressure_reject_new(side, log):
    eng = side.engine(ec=_ec(num_slots=1, max_seq_len=64, max_queue=1))
    eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=2))
    eng.submit(side.request(1, prompt(_v(side), 8, 1), max_new_tokens=2))
    assert eng.result(1).status == "rejected" and eng.shed == 1
    out = drain(eng, log)
    assert {u: s for u, s, _, _ in out} == {0: "ok", 1: "rejected"}
    return out, counters(eng), faults(eng)


def backpressure_shed_oldest(side, log):
    eng = side.engine(ec=_ec(num_slots=1, max_seq_len=64, max_queue=1,
                             shed_policy="shed-oldest"))
    eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=2))
    eng.submit(side.request(1, prompt(_v(side), 8, 1), max_new_tokens=2))
    assert eng.result(0).status == "rejected" and eng.result(1) is None
    out = drain(eng, log)
    assert {u: s for u, s, _, _ in out} == {0: "rejected", 1: "ok"}
    return out, counters(eng)


def bad_shed_policy_rejected(side, log):
    with pytest.raises(ValueError, match="shed_policy") as e:
        side.engine(ec=dict(shed_policy="drop-everything"))
    return str(e.value)


def drain_queue_rejects_waiting_only(side, log):
    eng = side.engine(ec=_ec(num_slots=1, max_seq_len=64))
    for i in range(3):
        eng.submit(side.request(i, prompt(_v(side), 8, i), max_new_tokens=4))
    ticked(eng, log)                    # 0 running, 1-2 queued
    assert eng.drain_queue() == 2
    eng.check_partition()
    out = drain(eng, log)
    assert {u: s for u, s, _, _ in out} == {0: "ok", 1: "rejected",
                                            2: "rejected"}
    assert len(out[0][2]) == 4
    return out, counters(eng), faults(eng)


def starvation_guard_pins(side, log):
    rng = np.random.default_rng(6)
    reqs = [side.request(i, rng.integers(0, _v(side), 8).astype(np.int32),
                         max_new_tokens=22) for i in range(2)]
    eng = side.engine(ec=dict(num_slots=2, block_size=4, max_seq_len=32,
                              num_blocks=11, max_preemptions=1))
    for r in reqs:
        eng.submit(r)
    out = drain(eng, log)
    assert eng.preemptions >= 1 and eng.starvation_pins >= 1
    assert eng.fault_stats()["starvation_pins"] == eng.starvation_pins
    roomy = side.engine(ec=dict(num_slots=2, block_size=4, max_seq_len=64,
                                prefix_cache=False))
    ref = outs(roomy.generate([side.request(r.uid, r.prompt, r.max_new_tokens)
                               for r in reqs]))
    assert [t for _, _, t, _ in out] == [t for _, _, t, _ in ref]
    return out, counters(eng), faults(eng)


# --------------------------------------------- result/stream semantics --

def result_none_for_inflight_and_unknown(side, log):
    eng = side.engine(ec=_ec(num_slots=1, max_seq_len=64))
    eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=4))
    assert eng.result(0) is None        # queued
    ticked(eng, log)
    assert eng.result(0) is None and eng.result(7) is None
    return drain(eng, log), eng.queue_depth, eng.live_slots


def stream_terminates_on_cancel(side, log):
    eng = side.engine(ec=_ec(num_slots=1))
    h = eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=32))
    it = eng.stream(h)
    got = [next(it), next(it)]
    eng.cancel(h)
    got += list(it)                     # ends at once
    c = eng.result(h)
    assert c.status == "cancelled" and got == c.tokens.tolist()
    return got, counters(eng)


def stream_of_rejected_request_is_empty(side, log):
    eng = side.engine(ec=_ec(num_slots=1, max_seq_len=64, max_queue=0))
    h = eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=4))
    assert list(eng.stream(h)) == []
    assert eng.result(h).status == "rejected"
    return counters(eng), faults(eng)


# ------------------------------------------------------ crash recovery --

def restore_reproduces_tokens_exactly(side, log):
    ec = _ec()
    reqs = [side.request(i, prompt(_v(side), 8 + 16 * (i % 2), i),
                         max_new_tokens=6) for i in range(4)]
    ref = {u: t for u, _, t, _ in outs(side.engine(ec=ec).generate(
        [side.request(r.uid, r.prompt, r.max_new_tokens) for r in reqs]))}
    eng = side.engine(ec=ec)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):                  # prefilled, decoding and queued
        ticked(eng, log)
    eng.cancel(reqs[3].uid)             # a terminal status rides along
    s = snap(eng)
    raw = eng.snapshot()
    del eng                             # the crash: device KV is gone
    eng2 = side.engine(ec=ec)
    assert eng2.restore(raw) == 3
    out = drain(eng2, log)
    by = {u: (st, t) for u, st, t, _ in out}
    assert by[3][0] == "cancelled"
    for r in reqs[:3]:
        assert by[r.uid] == ("ok", ref[r.uid])
    return s, out, counters(eng2)


def restore_requires_no_live_requests(side, log):
    eng = side.engine(ec=_ec(num_slots=1, max_seq_len=64))
    eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=2))
    with pytest.raises(RuntimeError, match="live requests"):
        eng.restore(eng.snapshot())
    return snap(eng)


def restore_rejects_uid_collision(side, log):
    ec = _ec(num_slots=1, max_seq_len=64)
    eng = side.engine(ec=ec)
    eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=2))
    while eng.pending:
        ticked(eng, log)                # uid 0 terminal, uncollected
    other = side.engine(ec=ec)
    other.submit(side.request(0, prompt(_v(side), 8, 1), max_new_tokens=2))
    raw = other.snapshot()
    with pytest.raises(ValueError, match="collides"):
        eng.restore(raw)
    first = outs(eng.collect())
    assert eng.restore(raw) == 1
    return first, drain(eng, log), counters(eng)


def restore_into_warm_trie_reuses_cached_pages(side, log):
    ec = _ec()
    reqs = [side.request(i, prompt(_v(side), 32, i), max_new_tokens=6)
            for i in range(2)]
    ref = {u: t for u, _, t, _ in outs(side.engine(ec=ec).generate(
        [side.request(r.uid, r.prompt, r.max_new_tokens) for r in reqs]))}
    eng = side.engine(ec=ec)
    eng.generate([side.request(10 + r.uid, r.prompt, r.max_new_tokens)
                  for r in reqs])
    reused0 = eng.prefix_stats.tokens_reused
    for r in reqs:
        eng.submit(r)
    ticked(eng, log)
    raw = eng.snapshot()
    eng.cancel(0)
    eng.cancel(1)
    while eng.pending:
        ticked(eng, log)
    eng.collect()
    assert eng.restore(raw) == 2
    out = drain(eng, log)
    assert {u: t for u, _, t, _ in out} == ref
    assert eng.prefix_stats.tokens_reused > reused0
    return out, eng.prefix_stats.tokens_reused, counters(eng)


def snapshot_restore_with_act_quant_and_prefix_cache(side, log):
    """Codes weights and activations (the reference's act-quant tables
    on both sides) with the prefix cache on."""
    ec = _ec(prefix_cache=True)
    v = _v(side, "codes")
    reqs = [side.request(i, prompt(v, 16 + 8 * (i % 2), i), max_new_tokens=5)
            for i in range(3)]
    base = side.engine("codes", ec=ec)
    ref = {u: t for u, _, t, _ in outs(base.generate(
        [side.request(r.uid, r.prompt, r.max_new_tokens) for r in reqs]))}
    eng = side.engine("codes", ec=ec)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        ticked(eng, log)
    raw = eng.snapshot()
    del eng
    eng2 = side.engine("codes", ec=ec)
    assert eng2.restore(raw) == 3
    out = drain(eng2, log)
    assert {u: (s, t) for u, s, t, _ in out} == {
        u: ("ok", t) for u, t in ref.items()}
    assert eng2.prefix.stats.inserted_pages > 0
    return out, counters(eng2)


def snapshot_is_json_serializable(side, log):
    ec = _ec(num_slots=1, max_seq_len=64)
    eng = side.engine(ec=ec)
    eng.submit(side.request(0, prompt(_v(side), 8), max_new_tokens=8,
                            deadline_s=30.0))
    ticked(eng, log)                    # mid-decode
    raw = json.loads(json.dumps(eng.snapshot()))
    eng2 = side.engine(ec=ec)
    assert eng2.restore(raw) == 1
    assert eng2._states[0].request.deadline_s == 30.0
    return snap(eng), drain(eng2, log)


# ------------------------------------------------- watchdog & latency --

def watchdog_and_latency_wired_into_step(side, log):
    eng = side.engine(ec=_ec(num_slots=2, max_seq_len=64))
    for i in range(4):
        eng.submit(side.request(i, prompt(_v(side), 8, i), max_new_tokens=4))
    out = drain(eng, log)
    assert eng.watchdog.seen == eng._tick_no > 0
    assert eng.tick_latency.count == eng._tick_no
    fs = eng.fault_stats()
    assert fs["ticks"] == eng._tick_no
    assert fs["tick_p99_s"] >= fs["tick_p50_s"] > 0.0
    return out, sorted(fs), faults(eng)


# ------------------------------------- lifecycle mid-speculation --

def _spec_ec(**kw):
    base = dict(num_slots=4, block_size=8, max_seq_len=160, prefill_chunk=16,
                prefix_cache=False)
    base.update(kw)
    return base


def _repetitive(side, n, boot=24, max_new=48):
    """The reference test's prompts: an 8-token seed and the first 24
    tokens of the model's own greedy rollout from it (this side's
    vanilla engine; the two sides' rollouts are equal)."""
    v = _v(side, "spec")
    seeds = [prompt(v, 8, 100 + i) for i in range(n)]
    boots = side.engine("spec", ec=_spec_ec()).generate(
        [side.request(900 + i, s, max_new_tokens=boot + max_new)
         for i, s in enumerate(seeds)])
    return [np.concatenate([s, np.asarray(c.tokens[:boot], np.int32)])
            for s, c in zip(seeds, sorted(boots, key=lambda c: c.uid))]


def _until_spec(eng, log):
    while eng.spec_dispatches == 0 and eng.pending:
        ticked(eng, log)


def cancel_mid_spec(side, log):
    eng = side.engine("spec", ec=_spec_ec(spec_k=6))
    for i, p in enumerate(_repetitive(side, 4)):
        eng.submit(side.request(i, p, max_new_tokens=48))
    _until_spec(eng, log)
    assert eng.cancel(0) and eng.cancel(2)
    eng.check_partition()
    out = drain(eng, log)
    assert [s for _, s, _, _ in out] == ["cancelled", "ok", "cancelled", "ok"]
    return out, counters(eng)


def deadline_mid_spec(side, log):
    eng = side.engine("spec", ec=_spec_ec(spec_k=6))
    t0 = eng._clock()
    eng._clock = lambda: t0
    for i, p in enumerate(_repetitive(side, 2)):
        eng.submit(side.request(i, p, max_new_tokens=64, deadline_s=5.0))
    _until_spec(eng, log)
    eng._clock = lambda: t0 + 6.0
    out = drain(eng, log)
    assert {s for _, s, _, _ in out} == {"deadline_exceeded"}
    return out, counters(eng)


def preemption_under_page_pressure_with_spec(side, log):
    prompts = _repetitive(side, 4, max_new=32)
    base = outs(side.engine("spec", ec=_spec_ec()).generate(
        [side.request(i, p, max_new_tokens=32) for i, p in enumerate(prompts)]))
    eng = side.engine("spec", ec=_spec_ec(spec_k=4, num_blocks=28))
    for i, p in enumerate(prompts):
        eng.submit(side.request(i, p, max_new_tokens=32))
    out = drain(eng, log)
    assert [t for _, _, t, _ in out] == [t for _, _, t, _ in base]
    return out, counters(eng)


def chaos_storm_soak_with_spec(side, log):
    storm = side.chaos.ChaosConfig.storm(13)
    eng = side.engine("spec", ec=_spec_ec(spec_k=4, num_blocks=40),
                      chaos=dataclasses.asdict(storm))
    prompts = _repetitive(side, 12, max_new=24)
    for i, p in enumerate(prompts):
        eng.submit(side.request(i, p, max_new_tokens=24))
    out = drain(eng, log)
    assert len(out) == len(prompts)
    assert any(s == "ok" for _, s, _, _ in out)
    return out, counters(eng), faults(eng), len(eng.replay_artifacts)


def snapshot_restore_mid_spec_run(side, log):
    prompts = _repetitive(side, 4)
    reqs = lambda: [side.request(i, p, max_new_tokens=32)   # noqa: E731
                    for i, p in enumerate(prompts)]
    base = outs(side.engine("spec", ec=_spec_ec()).generate(reqs()))
    eng = side.engine("spec", ec=_spec_ec(spec_k=6))
    for r in reqs():
        eng.submit(r)
    _until_spec(eng, log)
    raw = eng.snapshot()
    eng2 = side.engine("spec", ec=_spec_ec(spec_k=6))
    assert eng2.restore(raw) == len(prompts)
    out = drain(eng2, log)
    assert [t for _, _, t, _ in out] == [t for _, _, t, _ in base]
    return snap(eng), out, counters(eng2)


SCENARIOS = [cancel_queued, cancel_mid_first_prefill_chunk,
             cancel_between_prefill_chunks, cancel_mid_decode_keeps_tokens,
             cancel_after_retirement_is_noop, cancel_decrements_prefix_pins,
             deadline_expires_queued, deadline_expires_mid_decode,
             backpressure_reject_new, backpressure_shed_oldest,
             bad_shed_policy_rejected, drain_queue_rejects_waiting_only,
             starvation_guard_pins, result_none_for_inflight_and_unknown,
             stream_terminates_on_cancel, stream_of_rejected_request_is_empty,
             restore_reproduces_tokens_exactly,
             restore_requires_no_live_requests, restore_rejects_uid_collision,
             restore_into_warm_trie_reuses_cached_pages,
             snapshot_restore_with_act_quant_and_prefix_cache,
             snapshot_is_json_serializable,
             watchdog_and_latency_wired_into_step, cancel_mid_spec,
             deadline_mid_spec, preemption_under_page_pressure_with_spec,
             chaos_storm_soak_with_spec, snapshot_restore_mid_spec_run]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_lifecycle_equals_reference(scenario):
    both(scenario)


def test_terminal_statuses_and_policies_equal_the_reference():
    from repro.runtime import engine as jengine
    from repro_torch.runtime import engine as tengine

    assert tengine.TERMINAL_STATUSES == jengine.TERMINAL_STATUSES
    assert tengine.SHED_POLICIES == jengine.SHED_POLICIES
    assert (dataclasses.asdict(tengine.EngineConfig())
            == dataclasses.asdict(jengine.EngineConfig()))
