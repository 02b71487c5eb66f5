"""The port's chaos harness and failure model against the JAX package's,
on the CPU.

- ``runtime/chaos.py``: the injector's draws at every site equal the
  reference's for a seed (the port's copy draws from the same numpy
  Generator).
- Each fault site of ``tests/test_chaos.py`` runs on the reference's
  Engine and the port's (``_torch_serving.both``): the faults fire on
  the same ticks and leave the same statuses, tokens, counters and
  replay artifacts (wall times excluded); the page partition holds
  after every tick.
- ``page_checksum`` equals the reference's CRC on float32, bfloat16,
  float8_e4m3fn and uint8 pools holding the same bytes, and
  ``corrupt_page`` leaves the same bytes.
- A corrupt trie page drops its subtree through the audit.
- The storm soak is deterministic and equal to the reference's.
- A page freed by a failed request still holds its NaN: what the
  reference does when a later request takes it (its oracles multiply a
  masked position's zero weight by V), the port's CPU path does too.
"""

import dataclasses
import json
import os
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_serving import (artifact, both, counters, drain, faults, outs,
                            prompt, ticked)
from repro.runtime.chaos import ChaosConfig as JaxChaosConfig
from repro.runtime.chaos import ChaosInjector as JaxInjector
from repro.runtime.paged_cache import PagedKVCache as JaxCache
from repro_torch.convert import tensor_from_numpy
from repro_torch.runtime.chaos import ChaosConfig, ChaosInjector
from repro_torch.runtime.paged_cache import PagedKVCache


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed(side, n, seed=0):
    """The reference test's ``mixed_requests``."""
    rng = np.random.default_rng(seed)
    v = side.cfg().vocab_size
    return [side.request(i, rng.integers(0, v, int(rng.integers(6, 25)))
                         .astype(np.int32),
                         max_new_tokens=int(rng.integers(3, 7)))
            for i in range(n)]


def _clone(side, reqs):
    return [side.request(r.uid, r.prompt, r.max_new_tokens, r.stop_token)
            for r in reqs]


def _arts(eng):
    return [artifact(a) for a in eng.replay_artifacts]


# ------------------------------------------------------------ injector --

@pytest.mark.parametrize("seed", [0, 3, 13])
def test_injector_draws_equal_the_reference(seed):
    cfg = dict(seed=seed, alloc_fail_rate=0.3, nan_rate=0.3,
               corrupt_rate=0.3, slow_tick_rate=0.3, migration_fail_rate=0.3)
    a, b = JaxInjector(JaxChaosConfig(**cfg)), ChaosInjector(ChaosConfig(**cfg))

    def draws(inj):
        return [(inj.alloc_fault(), inj.nan_slot([0, 1, 2]),
                 inj.corrupt_page([4, 5, 9]), inj.tick_delay(),
                 inj.migration_fault()) for _ in range(200)]
    assert draws(a) == draws(b)
    assert a.stats() == b.stats()
    assert (dataclasses.asdict(ChaosConfig.storm(seed))
            == dataclasses.asdict(JaxChaosConfig.storm(seed)))


def test_zero_rates_never_fire():
    inj = ChaosInjector(ChaosConfig(seed=0))
    for _ in range(20):
        assert not inj.alloc_fault() and not inj.migration_fault()
        assert inj.nan_slot([0, 1]) is None
        assert inj.corrupt_page([2]) is None
        assert inj.tick_delay() == 0.0
    assert inj.stats()["chaos_alloc_faults"] == 0


# ------------------------------------------------------ page checksums --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn",
                                   "uint8"])
def test_page_checksum_and_corrupt_page_bytes_equal(dtype):
    """Both pools hold the same values: every page's CRC equals the
    reference's; ``corrupt_page`` (twice: 7, then 11) leaves the same
    bytes, and the batched ``page_checksums`` agrees.  The float pools
    hold normal draws (a page's kind of content; JAX's bfloat16 scatter
    rewrites every NaN payload in the pool to 0x7fc0, so random bytes
    would differ there by the reference's own write), plus one NaN at
    the compared element of the f8 pool; uint8 pools random bytes."""
    geo = dict(num_layers=2, num_kv_heads=2, head_dim=8, num_slots=2,
               block_size=4, num_blocks=6, max_blocks_per_seq=3)
    jdt = jnp.dtype(dtype)
    jc = JaxCache(**geo, dtype=jdt)
    tc = PagedKVCache(**geo, dtype=getattr(torch, dtype), device="cpu")
    rng = np.random.default_rng(0)
    shape = tuple(jc.k_pages.shape)
    for name in ("k_pages", "v_pages"):
        if dtype == "uint8":
            arr = rng.integers(0, 256, shape, dtype=np.uint8)
        else:
            arr = (rng.normal(size=shape) * 4).astype(np.dtype(jdt))
        if dtype == "float8_e4m3fn":
            arr[0, 3, 0, 0, 0] = np.nan     # the compare takes else
        setattr(jc, name, jnp.asarray(arr))
        getattr(tc, name).copy_(tensor_from_numpy(arr))
    pages = list(range(1, 6))
    want = [jc.page_checksum(p) for p in pages]
    assert [tc.page_checksum(p) for p in pages] == want
    assert tc.page_checksums(pages[::-1]) == want[::-1]
    for _ in range(2):
        jc.corrupt_page(3)
        tc.corrupt_page(3)
        assert tc.page_checksum(3) == jc.page_checksum(3)
        np.testing.assert_array_equal(
            tc.k_pages.contiguous().view(torch.uint8).numpy().reshape(-1),
            np.asarray(jc.k_pages).view(np.uint8).reshape(-1))
    k = np.asarray(jc.k_pages[:, 2]).tobytes()
    v = np.asarray(jc.v_pages[:, 2]).tobytes()
    assert tc.page_checksum(2) == zlib.crc32(v, zlib.crc32(k))


# ------------------------------------------------------------ per site --

def alloc_faults_cost_latency_not_tokens(side, log):
    ec = dict(num_slots=2, block_size=8, max_seq_len=64, prefill_chunk=16)
    reqs = _mixed(side, 6, seed=1)
    ref = outs(side.engine(ec=ec).generate(_clone(side, reqs)))
    eng = side.engine(ec=ec, chaos=dict(seed=1, alloc_fail_rate=0.5))
    for r in reqs:
        eng.submit(r)
    out = drain(eng, log)
    assert eng.alloc_faults_absorbed >= 1
    assert [(u, s, t) for u, s, t, _ in out] == [
        (u, "ok", t) for u, _, t, _ in ref]
    return out, counters(eng), faults(eng)


def nan_dispatch_fails_request_quarantines_lane(side, log):
    eng = side.engine(ec=dict(num_slots=2, block_size=8, max_seq_len=64,
                              quarantine_ticks=2),
                      chaos=dict(seed=2, nan_rate=1.0))
    reqs = _mixed(side, 3, seed=2)
    for r in reqs:
        eng.submit(r)
    out = drain(eng, log)
    assert all(s == "failed" for _, s, _, _ in out)
    assert eng.nan_rows_detected == eng.quarantines == len(reqs)
    assert [a["kind"] for a in eng.replay_artifacts] == ["nan_logits"] * 3
    return out, counters(eng), faults(eng), _arts(eng)


def corrupt_running_page_fails_owner(side, log, codes):
    kind = "codes" if codes else "float"
    eng = side.engine(kind, kv_codes=codes,
                      ec=dict(num_slots=2, block_size=8, max_seq_len=96,
                              checksum_pages=True))
    v = side.cfg(kind).vocab_size
    eng.submit(side.request(0, prompt(v, 17, 5), max_new_tokens=16))
    for _ in range(3):
        ticked(eng, log)
    page = int(eng.cache.block_tables[0, 0])
    assert page in eng._page_crc
    tokens = list(eng._states[0].tokens)
    eng.cache.corrupt_page(page)
    ticked(eng, log)
    assert eng.corruptions_detected == 1
    c = eng.result(0)
    # caught before the tick's dispatch: no token was added
    assert c.status == "failed" and c.tokens.tolist() == tokens
    assert eng.replay_artifacts[0]["kind"] == "kv_corruption"
    assert not eng.pending
    return counters(eng), faults(eng), _arts(eng)


def corrupt_trie_page_drops_subtree(side, log):
    eng = side.engine(ec=dict(num_slots=2, block_size=8, max_seq_len=64,
                              checksum_pages=True))
    r0 = side.request(0, _mixed(side, 1, seed=4)[0].prompt, max_new_tokens=4)
    (ref,) = outs(eng.generate([r0]))
    assert eng.prefix.num_pages >= 2
    root_child = next(iter(eng.prefix.root.children.values()))
    eng.cache.corrupt_page(root_child.page)
    eng.submit(side.request(1, r0.prompt, max_new_tokens=4))
    out = drain(eng, log)
    assert eng.corruptions_detected == 1
    assert eng.prefix.stats.corrupt_dropped >= 2     # the whole branch
    assert out[0][1] == "ok" and out[0][2] == ref[2]
    return (out, counters(eng), dataclasses.asdict(eng.prefix.stats),
            sorted(eng.prefix.pages()))


def slow_ticks_exercise_watchdog(side, log):
    """The stall draws equal the reference's; whether the watchdog
    flags a tick depends on wall times, so its count is held only to
    be at least one on each side."""
    eng = side.engine(ec=dict(num_slots=1, block_size=8, max_seq_len=64),
                      chaos=dict(seed=5, slow_tick_rate=0.25,
                                 slow_tick_s=0.3))
    inj, eng.chaos = eng.chaos, None
    eng.generate([side.request(99, _mixed(side, 1)[0].prompt,
                               max_new_tokens=2)])
    eng.chaos = inj
    eng.watchdog = side.ft.StragglerWatchdog(threshold=3.0)
    eng.tick_latency = side.ft.LatencyTracker()
    eng.submit(side.request(0, _mixed(side, 1, seed=5)[0].prompt,
                            max_new_tokens=20))
    out = drain(eng, log)
    assert eng.chaos.slow_ticks >= 1 and eng.slow_ticks >= 1
    fs = eng.fault_stats()
    assert fs["chaos_slow_ticks"] == eng.chaos.slow_ticks
    assert fs["tick_p99_s"] >= fs["tick_p50_s"] > 0.0
    return out, counters(eng), faults(eng)


def replay_artifact_written_to_disk(side, log, root):
    d = os.path.join(root, side.name)
    eng = side.engine(ec=dict(num_slots=1, block_size=8, max_seq_len=64,
                              quarantine_ticks=1, replay_dir=d),
                      chaos=dict(seed=6, nan_rate=1.0))
    eng.submit(side.request(0, _mixed(side, 1, seed=6)[0].prompt,
                            max_new_tokens=4))
    out = drain(eng, log)
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        art = json.load(f)
    assert art["kind"] == "nan_logits" and art["uid"] == 0
    return out, name, artifact(art)


def freed_nan_page(side, log):
    """Request 0 decodes past three pages; NaN goes into every element
    of its middle page (in place on the port); it fails alone and its
    pages return to the free list, NaN and all.  Request 1 (11 tokens)
    then takes that page as its second (the allocator is LIFO) and
    fills only positions 8..10 of it: positions 11..15 still hold NaN
    past its length."""
    eng = side.engine(ec=dict(num_slots=2, block_size=8, max_seq_len=64,
                              prefix_cache=False, quarantine_ticks=1))
    v = side.cfg().vocab_size
    eng.submit(side.request(0, prompt(v, 20, 7), max_new_tokens=16))
    eng.submit(side.request(2, prompt(v, 9, 8), max_new_tokens=16))
    for _ in range(2):
        ticked(eng, log)
    page = int(eng.cache.block_tables[0, 1])
    side.poke_nan(eng, page)
    ticked(eng, log)
    assert eng.result(0).status == "failed"
    assert eng.nan_rows_detected == 1 and eng._states[2].status == "running"
    # the two pages the next admission pops
    taken = [int(p) for p in eng.cache.allocator._free[::-1][:2]]
    assert taken[1] == page
    eng.submit(side.request(1, prompt(v, 11, 9), max_new_tokens=4))
    out = drain(eng, log)
    return out, page, taken, counters(eng), _arts(eng)


@pytest.mark.parametrize("codes", [False, True], ids=["float", "codes"])
def test_corrupt_running_page_fails_owner(codes):
    both(corrupt_running_page_fails_owner, codes)


@pytest.mark.parametrize("scenario", [
    alloc_faults_cost_latency_not_tokens,
    nan_dispatch_fails_request_quarantines_lane,
    corrupt_trie_page_drops_subtree, slow_ticks_exercise_watchdog],
    ids=lambda f: f.__name__)
def test_fault_site_equals_reference(scenario):
    both(scenario)


def test_replay_artifact_written_to_disk(tmp_path):
    both(replay_artifact_written_to_disk, str(tmp_path))


def test_freed_nan_page_follows_the_reference():
    """Whatever the reference does with the stale NaN (its oracles give
    NaN logits for a row whose freed page holds NaN past its length, so
    that request fails too), the port's CPU path does the same."""
    out, page, taken, _, arts = both(freed_nan_page)
    print(f"freed NaN page {page} taken again by request 1 "
          f"(pages {taken}): statuses "
          f"{ {u: s for u, s, _, _ in out} }, artifacts "
          f"{[(a['uid'], a['kind']) for a in arts]}")


# ----------------------------------------------------------------- soak --

EC = dict(num_slots=4, block_size=8, max_seq_len=96, prefill_chunk=16,
          quarantine_ticks=4)
STORM = dict(alloc_fail_rate=0.05, nan_rate=0.04, corrupt_rate=0.04,
             slow_tick_rate=0.05, slow_tick_s=0.001)


def storm_soak(side, log, n, seed):
    reqs = _mixed(side, n, seed=seed)
    ref = {u: t for u, _, t, _ in
           outs(side.engine(ec=EC).generate(_clone(side, reqs)))}
    eng = side.engine(ec=EC, chaos=dict(seed=seed, **STORM))
    for r in _clone(side, reqs):
        eng.submit(r)
    out = drain(eng, log)
    assert len(out) == n
    ok = [(u, t) for u, s, t, _ in out if s == "ok"]
    assert ok and all(t == ref[u] for u, t in ok)
    assert eng.failed == len(eng.replay_artifacts) >= 1
    assert not eng.pending and all(s is None for s in eng._slots)
    return out, counters(eng), faults(eng), _arts(eng)


def test_storm_soak_equals_reference():
    """64 requests through a storm at every site (the reference test's):
    every request terminal, the ok ones token-identical to the
    fault-free run, no page leaked, every site fired; equal to the
    reference's run, tick by tick."""
    out, _, fs, _ = both(storm_soak, 64, 7)
    assert all(fs[f"chaos_{k}_faults"] >= 1
               for k in ("alloc", "nan", "corrupt"))
    assert fs["chaos_slow_ticks"] >= 1


def test_storm_soak_is_deterministic():
    from _torch_serving import Side

    side = Side(False)
    runs = [storm_soak(side, [], 16, 11)[0] for _ in range(2)]
    assert runs[0] == runs[1]
