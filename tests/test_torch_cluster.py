"""The port's disaggregated cluster against the JAX package's, on the CPU.

Every case of ``tests/test_cluster.py`` (page migration, the hash ring,
cluster agreement, the sharded prefix cache, migration chaos,
backpressure, config validation, codes pages) runs on the reference's
objects and on the port's with the same seeded inputs and the same
weights (``tests/_torch_serving.py``; the codes weights and their
act-quant tables are fit by the port and handed to both).  A cluster
scenario is driven tick by tick on both packages, and ``both`` requires
equal per-tick states of every worker (statuses, token counts, free
pages, lengths, checksummed pages) and equal streams, ``Cluster.stats()``,
``RouterStats``, per-worker counters and ``fault_stats``.  Added: export
bytes equal to the reference's on float32, bfloat16, float8_e4m3fn and
uint8 pools with a bit-exact round trip; ``HashRing.owner`` equal over
1000 keys; cluster streams equal to the port's unified engine;
speculating decode workers (``tests/test_spec_decode.py``'s
``test_spec_on_cluster_identical_to_unified``); and the cluster tracing
cases of ``tests/test_telemetry.py`` with each request's trace phases
and the registry's key set equal to the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_serving import (TICK_CAP, Side, both, counters, faults, outs,
                            tick_state, weights)
from repro.runtime import cluster as jcluster
from repro.runtime import paged_cache as jpc
from repro_torch.runtime import cluster as tcluster
from repro_torch.runtime import paged_cache as tpc
from repro_torch.runtime.engine import KVHandoff, Request
from repro_torch.runtime.telemetry import validate_chrome_trace


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def C(side):
    """The side's cluster module."""
    return jcluster if side.ref else tcluster


def ecfg(side, **kw):
    base = dict(num_slots=4, block_size=8, max_seq_len=96, prefill_chunk=16)
    base.update(kw)
    return side.E.EngineConfig(**base)


def prompt(vocab, n, seed=0, sys_seed=None, sys_len=12):
    """The reference test's prompts: random tokens, with ``sys_seed`` the
    first ``sys_len`` from a shared system prompt."""
    tail = np.random.default_rng(seed).integers(1, vocab, n).astype(np.int32)
    if sys_seed is None:
        return tail
    head = np.random.default_rng(1000 + sys_seed).integers(
        1, vocab, sys_len).astype(np.int32)
    return np.concatenate([head, tail])


def cluster(side, kind="float", workers=(2, 2), engine=None, chaos=None,
            **kw):
    """A cluster on the shared weights of ``kind``."""
    jp, tp, report = weights(kind)
    if chaos is not None:
        kw["chaos"] = side.chaos.ChaosConfig(**chaos)
    if not side.ref:
        kw["device"] = "cpu"
    m = C(side)
    clu = m.Cluster(side.cfg(kind), params=jp if side.ref else tp,
                    cluster=m.ClusterConfig(*workers),
                    engine=engine or ecfg(side), **kw)
    return clu


def cluster_state(clu) -> tuple:
    return (clu.ticks, len(clu._backlog),
            [tick_state(e) for e in clu.prefill + clu.decode])


def drain_audited(clu, log) -> list:
    """Tick until idle, every worker's partition audited and the tick's
    state logged; completions as ``outs``."""
    done = []
    while clu.pending:
        done += clu.step()
        clu.check_partition()
        log.append(cluster_state(clu))
        assert len(log) < TICK_CAP, "cluster did not drain"
    return outs(done)


def fleet(clu) -> dict:
    """What the cluster counted: its stats, the router's, and each
    worker's counters and fault stats."""
    return {"stats": clu.stats(),
            "router": dataclasses.astuple(clu.router.stats),
            "workers": [(counters(e), faults(e))
                        for e in clu.prefill + clu.decode]}


def toks(obs_out) -> list:
    return [t for _, _, t, _ in obs_out]


# ------------------------------------------------ page migration unit --

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float8_e4m3fn": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
          "uint8": (jnp.uint8, torch.uint8)}


def _caches(dtype):
    jd, td = DTYPES[dtype]
    geo = dict(num_layers=2, num_kv_heads=2, head_dim=4, num_slots=2,
               block_size=4, num_blocks=16, max_blocks_per_seq=6)
    return (jpc.PagedKVCache(**geo, dtype=jd),
            tpc.PagedKVCache(**geo, dtype=td, device="cpu"))


def _page_data(dtype, n, seed=0):
    """numpy K and V pages [2, n, 4, 2, 4] in ``dtype`` (uint8: random
    codes; float: normals rounded through the dtype)."""
    r = np.random.default_rng(seed)
    if dtype == "uint8":
        return tuple(r.integers(0, 256, (2, n, 4, 2, 4), dtype=np.uint8)
                     for _ in range(2))
    jd = DTYPES[dtype][0]
    return tuple(np.asarray(jnp.asarray(r.normal(size=(2, n, 4, 2, 4)), jd))
                 for _ in range(2))


def _torch_of(a, dtype):
    """A numpy array of ``dtype`` as a torch tensor of the same bytes."""
    td = DTYPES[dtype][1]
    if dtype in ("float32", "uint8"):
        return torch.from_numpy(np.array(a))
    raw = np.array(a).view(np.uint8 if dtype == "float8_e4m3fn" else np.int16)
    return torch.from_numpy(raw).view(td)


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


class TestPageMigration:
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_export_import_roundtrip_is_bit_exact(self, dtype):
        """The reference's round trip on each pool dtype, both packages:
        the exported bytes equal the imported ones and the reference's,
        wherever the destination's free list puts the pages."""
        length = 10                     # 3 pages, the last partial
        k, v = _page_data(dtype, 3)
        seen = []
        for ref, cache in zip((True, False), _caches(dtype)):
            src, dst = cache, _caches(dtype)[0 if ref else 1]
            ki, vi = (k, v) if ref else (_torch_of(k, dtype),
                                         _torch_of(v, dtype))
            src.import_slot(0, length, ki, vi)
            ek, ev = src.export_slot(0)
            assert _bytes(ek) == _bytes(k) and _bytes(ev) == _bytes(v)
            dst.allocator.alloc(3, reserved=False)   # skew the free list
            blocks = dst.import_slot(1, length, ek, ev)
            assert dst.lengths[1] == length
            assert list(dst.block_tables[1, :3]) == blocks
            rk, rv = dst.export_slot(1)
            assert _bytes(rk) == _bytes(k) and _bytes(rv) == _bytes(v)
            seen.append((blocks, ek.nbytes + ev.nbytes, _bytes(rk),
                         tuple(ek.shape)))
        assert seen[0] == seen[1]

    def test_import_rejects_mismatched_page_count(self):
        for ref, mk in ((True, lambda: _caches("float32")[0]),
                        (False, lambda: _caches("float32")[1])):
            k = np.random.default_rng(0).normal(
                size=(2, 2, 4, 2, 4)).astype(np.float32)
            k = k if ref else torch.from_numpy(k)
            mk().import_slot(0, 5, k, k)        # 5 tokens, 2 pages: ok
            with pytest.raises(AssertionError):
                mk().import_slot(0, 9, k, k)    # 9 tokens need 3 pages

    def test_handoff_nbytes_counts_both_pools(self):
        k = torch.zeros((2, 1, 4, 2, 4), dtype=torch.float32)
        h = KVHandoff(request=Request(0, np.arange(3, dtype=np.int32)),
                      tokens=[5], length=3, k_pages=k, v_pages=k.clone(),
                      block_size=4)
        assert h.nbytes == 2 * k.nbytes
        jk = np.zeros((2, 1, 4, 2, 4), np.float32)
        jh = jcluster.KVHandoff(request=jcluster.Request(0, np.arange(3)),
                                tokens=[5], length=3, k_pages=jk,
                                v_pages=jk.copy(), block_size=4)
        assert h.nbytes == jh.nbytes


# ------------------------------------------------------ hash ring unit --

def _keys(n):
    return [np.random.default_rng(i).integers(0, 999, 8).astype(np.int32)
            .tobytes() for i in range(n)]


class TestHashRing:
    def test_deterministic_and_covering(self):
        ring = tcluster.HashRing(range(4), points=64)
        owners = [ring.owner(k) for k in _keys(200)]
        assert owners == [tcluster.HashRing(range(4), points=64).owner(k)
                          for k in _keys(200)]
        assert set(owners) == {0, 1, 2, 3}

    def test_adding_a_worker_remaps_a_minority(self):
        keys = _keys(400)
        before = [tcluster.HashRing(range(4)).owner(k) for k in keys]
        after = [tcluster.HashRing(range(5)).owner(k) for k in keys]
        moved = sum(a != b for a, b in zip(before, after))
        assert moved / len(keys) < 0.45
        assert all(b == 4 for a, b in zip(before, after) if a != b)

    def test_shared_first_page_shares_an_owner(self):
        v = Side(False).cfg().vocab_size
        a = prompt(v, 20, seed=1, sys_seed=7, sys_len=8)
        b = prompt(v, 24, seed=2, sys_seed=7, sys_len=8)
        key = tcluster.first_page_key(a, 8)
        assert key == tcluster.first_page_key(b, 8)
        assert key == jcluster.first_page_key(a, 8)
        ring = tcluster.HashRing(range(3))
        assert ring.owner(key) == ring.owner(tcluster.first_page_key(b, 8))

    @pytest.mark.parametrize("workers,points", [(2, 64), (4, 64), (3, 7)])
    def test_owners_equal_the_reference(self, workers, points):
        """1000 keys (first pages of random prompts) have the
        reference's owner: the same zlib CRCs on the same ring."""
        keys = [tcluster.first_page_key(
            np.random.default_rng(i).integers(0, 151936, 16), 16)
            for i in range(1000)]
        ours = tcluster.HashRing(range(workers), points)
        theirs = jcluster.HashRing(range(workers), points)
        assert [ours.owner(k) for k in keys] == [theirs.owner(k)
                                                 for k in keys]


# ------------------------------------------------- cluster end-to-end --

def _agreement(side, log, n, workers):
    """The reference's agreement case: a unified engine's streams, then
    the cluster's on the same weights, tick by tick."""
    v = side.cfg().vocab_size
    reqs = lambda: [side.request(i, prompt(v, 14 + 3 * i, seed=i,    # noqa
                                           sys_seed=i % 2),
                                 max_new_tokens=5) for i in range(n)]
    base = side.engine(ec=dict(num_slots=4, block_size=8, max_seq_len=96,
                               prefill_chunk=16))
    unified = outs(base.generate(reqs()))
    clu = cluster(side, workers=workers)
    for r in reqs():
        clu.submit(r)
    out = drain_audited(clu, log)
    assert toks(out) == toks(unified)
    assert all(s == "ok" for _, s, _, _ in out)
    assert clu.handoffs == n and clu.handoff_bytes > 0
    assert all(e.prefill_tokens_computed == 0 for e in clu.decode)
    assert sum(e.imported_handoffs for e in clu.decode) == n
    return out, unified, fleet(clu)


class TestClusterAgreement:
    @pytest.mark.parametrize("workers", [(2, 2), (1, 3)])
    def test_tokens_identical_to_unified_engine(self, workers):
        """2P/2D (and 1P/3D) against one engine: the same tokens, every
        prompt's pages moved by a handoff and none recomputed on a decode
        worker, the partition whole every tick -- on both packages, with
        equal per-tick states, stats and counters; the cluster's streams
        equal the port's unified engine's."""
        both(_agreement, 6, workers)

    def test_single_token_requests_finish_on_the_prefill_worker(self):
        def scenario(side, log):
            clu = cluster(side, workers=(1, 1))
            clu.submit(side.request(0, prompt(side.cfg().vocab_size, 12),
                                    max_new_tokens=1))
            out = drain_audited(clu, log)
            assert len(out) == 1 and out[0][1] == "ok"
            assert len(out[0][2]) == 1 and clu.handoffs == 0
            return out, fleet(clu)
        both(scenario)

    def test_ttft_spans_the_worker_boundary(self):
        """The completion's stamps survive the migration: TTFT measures
        submit to the first token on the prefill worker, queue wait at
        most TTFT (the port's wall times, not compared)."""
        clu = cluster(Side(False), workers=(1, 1))
        out = clu.generate([Request(0, prompt(Side(False).cfg().vocab_size,
                                              20), max_new_tokens=4)])
        c = out[0]
        assert c.ttft_s > 0 and c.decode_steps > 0
        assert c.queue_wait_s <= c.ttft_s


def _sharded(side, log):
    """Two system prompts owned by different shards; wave 2 routes back
    onto the warm tries."""
    v = side.cfg().vocab_size
    ring = tcluster.HashRing(range(2), points=64)
    bs = 8
    key = lambda s: tcluster.first_page_key(                   # noqa: E731
        prompt(v, 16, sys_seed=s, sys_len=16), bs)
    sys_b = next(s for s in range(1, 50)
                 if ring.owner(key(s)) != ring.owner(key(0)))
    seeds = [0, sys_b]
    reqs = [side.request(i, prompt(v, 16 + 2 * i, seed=i,
                                   sys_seed=seeds[i % 2], sys_len=16),
                         max_new_tokens=4) for i in range(8)]
    clone = lambda rs: [side.request(r.uid, r.prompt, r.max_new_tokens)  # noqa
                        for r in rs]
    base = side.engine(ec=dict(num_slots=4, block_size=8, max_seq_len=96,
                               prefill_chunk=16))
    unified = outs(base.generate(clone(reqs)))
    clu = cluster(side)
    for r in clone(reqs[:2]):
        clu.submit(r)
    out = drain_audited(clu, log)
    for r in clone(reqs[2:]):
        clu.submit(r)
    out = sorted(out + drain_audited(clu, log))
    assert toks(out) == toks(unified)
    st = clu.stats()
    assert st["cross_worker_prefix_hit_rate"] > 0
    assert all(p > 0 for p in st["shard_pages"]), st["shard_pages"]
    assert sum(e.prefix.stats.tokens_reused for e in clu.prefill) > 0
    return out, fleet(clu), [dataclasses.astuple(e.prefix.stats)
                             for e in clu.prefill]


class TestShardedPrefixCache:
    def test_second_wave_hits_the_warmed_shards(self):
        both(_sharded)


def _chaos_drops(side, log):
    v = side.cfg().vocab_size
    reqs = lambda: [side.request(i, prompt(v, 14 + 2 * i, seed=i,   # noqa
                                           sys_seed=0),
                                 max_new_tokens=4) for i in range(5)]
    calm = cluster(side)
    ref = outs(calm.generate(reqs()))
    stormy = cluster(side, chaos=dict(seed=11, migration_fail_rate=0.5))
    for r in reqs():
        stormy.submit(r)
    out = drain_audited(stormy, log)
    assert stormy.migration_faults > 0
    assert all(s == "ok" for _, s, _, _ in out)
    assert toks(out) == toks(ref)
    assert stormy.handoffs == 5
    st = stormy.stats()
    assert st["chaos_migration_faults"] == stormy.migration_faults
    return out, fleet(stormy)


class TestMigrationChaos:
    def test_dropped_handoffs_cost_latency_never_tokens(self):
        """Seeded migration drops re-queue on the source prefill worker
        (a trie hit) and the streams equal the calm cluster's; the drops
        fall on the reference's handoffs."""
        both(_chaos_drops)

    def test_chaos_is_deterministic_per_seed(self):
        def scenario(side, log):
            v = side.cfg().vocab_size
            runs = []
            for _ in range(2):
                clu = cluster(side, workers=(2, 1),
                              chaos=dict(seed=3, migration_fail_rate=0.4))
                for i in range(4):
                    clu.submit(side.request(i, prompt(v, 12 + 2 * i, seed=i),
                                            max_new_tokens=3))
                runs.append((clu.migration_faults, drain_audited(clu, log)))
            assert runs[0] == runs[1]
            return runs[0]
        both(scenario)


class TestClusterBackpressure:
    def test_router_holds_over_bound_work_and_drains_it(self):
        def scenario(side, log):
            clu = cluster(side, workers=(1, 1),
                          engine=ecfg(side, num_slots=2, max_queue=1))
            v = side.cfg().vocab_size
            for i in range(6):
                clu.submit(side.request(i, prompt(v, 12 + 2 * i, seed=i),
                                        max_new_tokens=3))
            out = drain_audited(clu, log)
            assert clu.router.stats.held > 0
            assert len(out) == 6 and all(s == "ok" for _, s, _, _ in out)
            return out, fleet(clu)
        both(scenario)


class TestClusterConfigValidation:
    def test_rejects_empty_roles(self):
        with pytest.raises(ValueError, match="worker"):
            tcluster.ClusterConfig(prefill_workers=0)

    def test_rejects_role_bearing_template(self):
        with pytest.raises(ValueError, match="role"):
            cluster(Side(False), engine=ecfg(Side(False), role="prefill"))

    def test_engine_rejects_unknown_role(self):
        with pytest.raises(ValueError, match="role"):
            Side(False).engine(ec=dict(role="router"))


def _codes_agreement(side, log):
    v = side.cfg("codes").vocab_size
    reqs = lambda: [side.request(i, prompt(v, 14 + 3 * i, seed=i,   # noqa
                                           sys_seed=i % 2),
                                 max_new_tokens=5) for i in range(6)]
    base = side.engine("codes", kv_codes=True,
                       ec=dict(num_slots=4, block_size=8, max_seq_len=96,
                               prefill_chunk=16))
    unified = outs(base.generate(reqs()))
    clu = cluster(side, "codes", kv_codes=True)
    fps = {e._kv_fingerprint for e in clu.prefill + clu.decode}
    assert fps == {base._kv_fingerprint} and None not in fps
    for r in reqs():
        clu.submit(r)
    out = drain_audited(clu, log)
    assert toks(out) == toks(unified)
    assert all(s == "ok" for _, s, _, _ in out)
    assert clu.handoffs == 6
    assert all(e.prefill_tokens_computed == 0 for e in clu.decode)
    return out, unified, fleet(clu)


class TestClusterKVCodes:
    """Codes pages through the cluster: the shared params carry the
    per-head K/V tables to every worker, and the handoffs carry their
    fingerprint."""

    def test_codes_cluster_matches_unified_codes_engine(self):
        both(_codes_agreement)

    def test_handoffs_carry_the_table_fingerprint(self):
        def scenario(side, log):
            clu = cluster(side, "codes", workers=(1, 1), kv_codes=True)
            pw = clu.prefill[0]
            pw.submit(side.request(0, prompt(side.cfg("codes").vocab_size,
                                             20), max_new_tokens=4))
            while not pw.outbox:
                pw.step()
                log.append(tick_state(pw))
            h = pw.take_handoffs()[0]
            assert h.kv_fingerprint == pw._kv_fingerprint is not None
            assert h.k_pages.dtype in (np.uint8, torch.uint8)
            return h.kv_fingerprint, h.nbytes, _bytes(h.k_pages), h.tokens
        both(scenario)

    def test_fingerprint_mismatch_rejected(self):
        """A codes handoff never lands in a float pool: refused before a
        page moves."""
        side = Side(False)
        eng = side.engine(ec=dict(num_slots=4, block_size=8,
                                  max_seq_len=96, prefill_chunk=16))
        cfg = side.cfg()
        k = torch.zeros((cfg.num_layers, 3, 8, cfg.num_kv_heads,
                         cfg.resolved_head_dim), dtype=torch.uint8)
        h = KVHandoff(request=Request(7, prompt(cfg.vocab_size, 20),
                                      max_new_tokens=4),
                      tokens=[5], length=20, k_pages=k, v_pages=k.clone(),
                      block_size=8, kv_fingerprint=0xDEADBEEF)
        with pytest.raises(ValueError, match="fingerprint"):
            eng.inject_prefilled(h)
        eng.check_partition()


# ---------------------------------------------- speculating decode workers

def _spec_cluster(side, log):
    """tests/test_spec_decode.py's case: prompts of a model's own greedy
    rollout, served by a 2P/2D cluster whose decode workers speculate
    (spec_k 4), against the unified engine without speculation."""
    v = side.cfg("spec").vocab_size
    ec = dict(num_slots=4, block_size=8, max_seq_len=160, prefill_chunk=16)
    base = side.engine("spec", ec=ec)
    seeds = [np.random.default_rng(100 + i).integers(0, v, 8)
             .astype(np.int32) for i in range(6)]
    boots = sorted(base.generate([side.request(900 + i, s, max_new_tokens=72)
                                  for i, s in enumerate(seeds)]),
                   key=lambda c: c.uid)
    prompts = [np.concatenate([s, np.asarray(c.tokens[:24], np.int32)])
               for s, c in zip(seeds, boots)]
    reqs = lambda: [side.request(i, p, max_new_tokens=24)       # noqa
                    for i, p in enumerate(prompts)]
    unified = outs(base.generate(reqs()))
    clu = cluster(side, "spec", engine=ecfg(side, max_seq_len=160,
                                            spec_k=4))
    for r in reqs():
        clu.submit(r)
    out = drain_audited(clu, log)
    assert toks(out) == toks(unified)
    assert sum(w.spec_dispatches for w in clu.decode) > 0
    assert all(w.spec_dispatches == 0 for w in clu.prefill)
    return out, fleet(clu)


def test_spec_on_cluster_identical_to_unified():
    both(_spec_cluster)


# ------------------------------------------------------ cluster tracing

_TIMED_KEYS = ("engine.tick.", "engine.faults.slow_ticks")


def _traced(side, log, chaos):
    """Six (five with chaos) requests through a traced 2P/2D cluster:
    every request's status and trace phases, the registry's keys and
    untimed values, the trace's shape, and the dropped flows."""
    tel = side.tel.Telemetry(tracing=True)
    n = 5 if chaos else 6
    clu = cluster(side, telemetry=tel,
                  chaos=dict(seed=11, migration_fail_rate=0.5)
                  if chaos else None)
    rng = np.random.default_rng(0)
    v = side.cfg().vocab_size
    for i in range(n):
        clu.submit(side.request(i, rng.integers(1, v, int(rng.integers(8, 20)))
                                .astype(np.int32), max_new_tokens=4))
    out = drain_audited(clu, log)
    doc = tel.tracer.export()
    st = validate_chrome_trace(doc, require_boundary=True)
    for tr in tel.traces.values():
        tr.assert_monotonic()
    phases = {uid: (tr.status, tr.phases()) for uid, tr in tel.traces.items()}
    reg = {k: val for k, val in tel.registry.snapshot().items()
           if not any(p in k for p in _TIMED_KEYS)}
    dropped = sum(1 for e in doc["traceEvents"]
                  if e["ph"] == "f" and e["args"].get("dropped"))
    assert all(w._clock is tel.clock for w in clu.prefill + clu.decode)
    return out, phases, reg, st, dropped, clu.handoffs, clu.migration_faults


class TestClusterTracing:
    """``tests/test_telemetry.py``'s cluster cases on the port, each
    request's phases and the registry equal to the reference's."""

    def test_cross_boundary_timeline_is_contiguous(self):
        out, phases, reg, st, _, handoffs, _ = both(_traced, False)
        assert all(s == "ok" for _, s, _, _ in out)
        assert st["boundary_requests"] == 6 and st["flows"] == handoffs
        for _, ph in phases.values():
            assert "route" in ph
            assert ph.index("handoff_export") < ph.index("handoff_import")

    def test_dropped_handoffs_leave_no_orphan_flows(self):
        out, phases, _, st, dropped, _, faults_n = both(_traced, True)
        assert faults_n > 0 and dropped == faults_n
        assert all(s == "ok" for _, s, _, _ in out) and st["requests"] == 5
        for _, ph in phases.values():
            assert ph.count("terminal") == 1
            assert ph.count("handoff_export") == (
                ph.count("handoff_dropped") + ph.count("handoff_import"))

    def test_cluster_stats_shim_reads_registry_under_worker_scopes(self):
        """``stats()`` reads the registry; each worker registers under its
        own scope (prefill0.engine.*, decode1.engine.*), the key set the
        reference's."""
        _, _, reg, _, _, _, _ = both(_traced, False)
        for w in ("prefill0", "prefill1", "decode0", "decode1"):
            assert f"{w}.engine.pages.free" in reg
            assert f"{w}.engine.handoff.exported" in reg
        assert reg["cluster.handoff.delivered"] == 6
        assert (reg["prefill0.engine.handoff.exported"]
                + reg["prefill1.engine.handoff.exported"]) == 6
        assert (reg["decode0.engine.handoff.imported"]
                + reg["decode1.engine.handoff.imported"]) == 6
        assert (reg["decode0.engine.handoff.imported_bytes"]
                + reg["decode1.engine.handoff.imported_bytes"]
                == reg["cluster.handoff.bytes"])
