"""The port's prefix cache and admission path against the JAX package's,
on the CPU, at the tiny qwen3-1.7b size of ``tests/test_prefix_cache.py``.

- The trie (``runtime/prefix_cache.py``) and the allocator's refcounts:
  the same operations on both packages' objects give the same pages,
  counts and stats, and the reference's expected values.
- Copy-on-write of a shared page: on float32, bf16, float8_e4m3fn and
  uint8 pools the copy is byte-equal to the page it copies and to the
  reference's copy.
- The tail prefill over cached prefix pages at an offset, against the
  reference's ``prefill_into_cache`` at that offset (logits and tail KV
  within 2e-5, as ``test_torch_engine.py``'s model tests).
- The engine scenarios of ``TestEnginePrefix``, driven tick by tick on
  both engines (the reference's weights converted with
  ``params_from_jax``): after every tick the block tables, the lengths
  and the trie's pages are exactly equal and both page partitions hold;
  at the end the greedy streams, ``PrefixStats``, ``admission_reorders``,
  ``trie_match_reuses``, ``preemptions`` and ``prefill_tokens_computed``
  are exactly equal (allocator and trie state are exact in the
  reference, and greedy streams on float32 KV).
"""

import dataclasses
import functools

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import api as jax_api
from repro.runtime import paged_cache as jpc
from repro.runtime import prefix_cache as jprefix
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import EngineConfig as JaxEngineConfig
from repro.runtime.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api as torch_api
from repro_torch.runtime import paged_cache as tpc
from repro_torch.runtime import prefix_cache as tprefix
from repro_torch.runtime.engine import Engine, EngineConfig, Request

TINY = dict(num_layers=2, d_model=64, d_ff=128, compute_dtype="float32")
LOGITS_TOL = 2e-5
SIDES = {"reference": (jpc, jprefix), "port": (tpc, tprefix)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: its engines run thousands of
    small tensor ops a stream, which spin-wait across a full thread pool
    when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = {**TINY, **kw}
    return (jax_get_config("qwen3-1.7b", tiny=True).replace(**kw),
            get_config("qwen3-1.7b", tiny=True).replace(**kw))


@functools.lru_cache(maxsize=None)
def _params():
    """The reference's weights (seed 0) and the port's conversion."""
    jcfg, cfg = _cfgs()
    jp = jax_api.get_model(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                               device="cpu")


# ---------------------------------------------------------------- trie --

BS = 8


def _trie(side, num_blocks=64):
    pc, pf = SIDES[side]
    a = pc.BlockAllocator(num_blocks)
    return a, pf.PrefixCache(a, BS)


def _pages(nodes):
    return [n.page for n in nodes]


def _roundtrip(side):
    a, p = _trie(side)
    tokens = np.arange(38)              # 4 full pages + a partial (6)
    blocks = a.alloc(5, reserved=False)
    p.insert(tokens, blocks, set())
    full = p.match(tokens)
    split = p.match(tokens[:20])        # 2 whole edges + 4 of the third
    leaf = p.match(np.concatenate([tokens[:32], tokens[32:35], [999]]))
    assert p.num_pages == 5
    assert _pages(full[0]) == blocks and full[1] == 38
    assert _pages(split[0]) == blocks[:3] and split[1] == 20
    assert _pages(leaf[0]) == blocks and leaf[1] == 35
    return [_pages(m[0]) + [m[1]] for m in (full, split, leaf)]


def _divergence(side):
    a, p = _trie(side)
    tokens = np.arange(32)
    p.insert(tokens, a.alloc(4, reserved=False), set())
    other = tokens.copy()
    other[12] = 999                     # diverge inside page 1
    other2 = tokens.copy()
    other2[0] = 999                     # diverge at once
    nodes, used = p.match(other)
    assert len(nodes) == 2 and used == 12
    assert p.match(other2) == ([], 0)
    assert p.match_len(other) == 12
    return _pages(nodes), used


def _dedup(side):
    a, p = _trie(side)
    tokens = np.arange(24)
    first = a.alloc(3, reserved=False)
    p.insert(tokens, first, set())
    free_before = a.free_blocks
    p.insert(tokens, a.alloc(3, reserved=False), set())
    assert p.num_pages == 3 and a.free_blocks == free_before
    assert p.stats.dedup_pages == 3 and _pages(p.match(tokens)[0]) == first
    return a.free_blocks, p.stats.dedup_pages, p.generation


def _branching(side):
    a, p = _trie(side)
    base = np.arange(8)
    left = np.concatenate([base, np.arange(100, 108)])
    right = np.concatenate([base, np.arange(200, 208)])
    bl, br = a.alloc(2, reserved=False), a.alloc(2, reserved=False)
    p.insert(left, bl, set())
    p.insert(right, br, set())
    assert p.num_pages == 3 and a.refcount(bl[0]) == 1
    assert _pages(p.match(right)[0]) == [bl[0], br[1]]
    return sorted(p.pages()), _pages(p.match(left)[0])


def _lru_pins(side):
    a, p = _trie(side)
    chain = np.arange(24)
    blocks = a.alloc(3, reserved=False)
    p.insert(chain, blocks, set())
    pinned, _ = p.match(chain[:8])
    p.pin(pinned)
    seen = [p.evict(1), blocks[2] in a._free, p.evict(5),
            blocks[1] in a._free, p.evict(1), dict(p.pins())]
    p.unpin(pinned)
    seen += [p.evict(1), a.free_blocks, p.num_pages]
    assert seen[:5] == [1, True, 1, True, 0] and seen[-3:] == [1, 63, 0]
    return seen


def _lru_order(side):
    a, p = _trie(side)
    t1, t2 = np.arange(8), np.arange(50, 58)
    b1, b2 = a.alloc(1, reserved=False), a.alloc(1, reserved=False)
    p.insert(t1, b1, set())
    p.insert(t2, b2, set())
    p.pin(p.match(t1)[0])
    p.unpin(p.match(t1)[0])
    assert p.evict(1) == 1 and b2[0] in a._free and b1[0] not in a._free
    return sorted(a._free)[:4], p.stats.evicted_pages


def _drop_subtree(side):
    a, p = _trie(side)
    blocks = a.alloc(3, reserved=False)
    p.insert(np.arange(24), blocks, set())
    freed = p.drop_subtree(blocks[1])
    assert sorted(freed) == sorted(blocks[1:]) and p.num_pages == 1
    return freed, p.stats.corrupt_dropped, p.generation


TRIE_CASES = {f.__name__[1:]: f for f in (_roundtrip, _divergence, _dedup,
                                          _branching, _lru_pins, _lru_order,
                                          _drop_subtree)}


@pytest.mark.parametrize("case", sorted(TRIE_CASES))
def test_trie_equals_reference(case):
    """Each case of ``TestTrie`` on both packages' allocator and trie:
    the reference's expected values, and equal observations."""
    fn = TRIE_CASES[case]
    assert fn("port") == fn("reference")


# ------------------------------------------------------ refcounts/CoW --

def _refcount_cycle(side):
    pc, _ = SIDES[side]
    a = pc.BlockAllocator(8)
    (b,) = a.alloc(1, reserved=False)
    a.incref(b)
    a.decref(b)
    seen = [a.refcount(b), b in a._free]
    a.incref(b)
    with pytest.raises(AssertionError):
        a.free([b])                     # shared: refcount 2
    a.decref(b)
    a.decref(b)
    return seen + [a.refcount(b), b in a._free]


def test_incref_decref_free_cycle_equals_reference():
    assert _refcount_cycle("port") == _refcount_cycle("reference") == [
        1, False, 0, True]


POOL_DTYPES = {"float32": (torch.float32, jnp.float32),
               "bfloat16": (torch.bfloat16, jnp.bfloat16),
               "float8_e4m3fn": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
               "uint8": (torch.uint8, jnp.uint8)}


@pytest.mark.parametrize("dtype", sorted(POOL_DTYPES))
def test_cow_slot_page_bytes_equal_reference(dtype):
    """``cow_slot_page`` on a pool whose every byte is random: the copy
    equals the shared page byte for byte (every layer, K and V), the
    pools equal the reference's after its copy, the table points at the
    copy and the shared page keeps the trie's and the stale pin's
    references."""
    tdt, jdt = POOL_DTYPES[dtype]
    kw = dict(num_layers=2, num_kv_heads=2, head_dim=4, num_slots=1,
              block_size=4, num_blocks=8, max_blocks_per_seq=4)
    jc = jpc.PagedKVCache(**kw, dtype=jdt)
    tc = tpc.PagedKVCache(**kw, dtype=tdt, device="cpu")
    rng = np.random.default_rng(3)
    isz = tc.k_pages.element_size()
    raw = [rng.integers(0, 256, size=tuple(tc.k_pages.shape) + (isz,),
                        dtype=np.uint8) for _ in range(2)]
    np_dt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "float8_e4m3fn": ml_dtypes.float8_e4m3fn, "uint8": np.uint8}[dtype]
    vals = [r.reshape(-1).view(np_dt).reshape(tc.k_pages.shape) for r in raw]
    if dtype != "uint8":            # NaN payloads: JAX may quiet them
        for v in vals:
            v[np.isnan(v.astype(np.float32))] = 0
        raw = [v.view(np.uint8).reshape(r.shape) for v, r in zip(vals, raw)]
    jc.k_pages, jc.v_pages = (jnp.asarray(v) for v in vals)
    for pool, v in zip((tc.k_pages, tc.v_pages), raw):
        pool.view(torch.uint8).copy_(torch.from_numpy(v).view(
            tuple(pool.shape[:-1]) + (pool.shape[-1] * isz,)))
    olds = []
    for c in (jc, tc):
        (shared,) = c.allocator.alloc(1, reserved=False)
        c.allocator.incref(shared)                     # the trie's ref
        c.bind_slot(0, 6, [shared], reserved=False)    # 2 blocks: 1 shared
        old, new = c.cow_slot_page(0, 0)
        assert old == shared and new != shared
        assert c.block_tables[0, 0] == new and shared not in c.slot_shared[0]
        assert c.allocator.refcount(shared) == 2
        olds.append((old, new))
    assert olds[0] == olds[1]
    old, new = olds[1]
    for tpool, jpool in ((tc.k_pages, jc.k_pages), (tc.v_pages, jc.v_pages)):
        tb = tpool.view(torch.uint8).numpy()
        jb = np.asarray(jpool).view(np.uint8)
        assert np.array_equal(tb[:, new], tb[:, old])
        assert np.array_equal(tb.reshape(-1), jb.reshape(-1))


def test_release_frees_only_owned_pages_and_audit_counts_pins():
    """A slot over one shared page and one owned: release frees the
    owned page only; the partition audit counts the slot's pin on the
    trie page, as the reference's does."""
    for pc in (jpc, tpc):
        kw = dict(num_layers=1, num_kv_heads=1, head_dim=4, num_slots=2,
                  block_size=4, num_blocks=6, max_blocks_per_seq=3)
        c = (pc.PagedKVCache(**kw) if pc is jpc
             else pc.PagedKVCache(**kw, device="cpu"))
        (trie,) = c.allocator.alloc(1, reserved=False)
        c.allocator.incref(trie)                        # one pin
        owned = c.bind_slot(0, 7, [trie], reserved=False)
        c.audit_partition({trie}, {trie: 1})
        with pytest.raises(AssertionError):
            c.audit_partition({trie}, {trie: 2})
        assert c.release_slot(0) == 1 and owned[0] in c.allocator._free
        assert c.allocator.refcount(trie) == 2 and trie not in c.allocator._free
        c.allocator.decref(trie)                        # the unpin
        c.audit_partition({trie}, {})
        assert c.clear_slot(1) == []


# ---------------------------------------------- offset prefill (model) --

def test_tail_prefill_at_an_offset_equals_reference():
    """Prefilling only the tail over copied prefix pages: the port's
    logits and tail KV equal the reference's at the same offset (2e-5)
    and the port's own cold prefill of the whole prompt; the tail starts
    mid-page (offset 10 on pages of 4)."""
    jcfg, cfg = _cfgs()
    jp, tp = _params()
    japi, tapi = jax_api.get_model(jcfg), torch_api.get_model(cfg)
    bs, plen, prefix_len = 4, 19, 10
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, plen)
    kw = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, num_slots=1, block_size=bs,
              num_blocks=16, max_blocks_per_seq=8)

    def fresh(jax_side):
        c = (jpc.PagedKVCache(**kw) if jax_side
             else tpc.PagedKVCache(**kw, device="cpu"))
        c.allocator.reserve(8)
        c.bind_slot(0, plen)
        return c

    toks = np.zeros((1, 24), np.int32)
    toks[0, :plen] = prompt
    cold = fresh(False)
    lc, _ = tapi.prefill_into_cache(tp, torch.from_numpy(toks), cold.view(),
                                    cfg)
    # the prefix pages (through the boundary page) copied from the cold run
    jw, tw = fresh(True), fresh(False)
    n_pre = -(-prefix_len // bs)
    src = cold.block_tables[0, :n_pre]
    for c in (jw, tw):
        dst = c.block_tables[0, :n_pre]
        if c is jw:
            jw.k_pages = jw.k_pages.at[:, dst].set(cold.k_pages[:, src].numpy())
            jw.v_pages = jw.v_pages.at[:, dst].set(cold.v_pages[:, src].numpy())
        else:
            tw.k_pages[:, dst] = cold.k_pages[:, src]
            tw.v_pages[:, dst] = cold.v_pages[:, src]
    tail = np.zeros((1, 16), np.int32)
    tail[0, :plen - prefix_len] = prompt[prefix_len:]
    jl, jv = japi.prefill_into_cache(jp, jnp.asarray(tail), jw.view(), jcfg,
                                     jnp.asarray([prefix_len], jnp.int32))
    tl, _ = tapi.prefill_into_cache(tp, torch.from_numpy(tail), tw.view(),
                                    cfg, torch.tensor([prefix_len]))
    scale = max(1.0, float(np.abs(np.asarray(jl)).max()))
    for want in (np.asarray(jl), lc.numpy()):
        np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                                   atol=LOGITS_TOL * scale)
    cols = tw.block_tables[0, :5]
    got = tw.k_pages[:, cols].reshape(cfg.num_layers, 20, cfg.num_kv_heads, -1)
    want = np.asarray(jv.k_pages)[:, cols].reshape(got.shape)
    coldk = cold.k_pages[:, cold.block_tables[0, :5]].reshape(got.shape)
    np.testing.assert_allclose(got[:, :plen].numpy(), want[:, :plen],
                               rtol=0, atol=LOGITS_TOL)
    np.testing.assert_allclose(got[:, :plen].numpy(), coldk[:, :plen].numpy(),
                               rtol=0, atol=LOGITS_TOL)


# ------------------------------------------------------------- engine --

def shared_prefix_requests(vocab, n, sys_len, tail_len, max_new, seed=0,
                           uid0=0):
    """n prompts sharing a sys_len-token system prompt, as (uid, prompt,
    max_new) triples."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, sys_len).astype(np.int32)
    return [(uid0 + i, np.concatenate(
                [sys_p, rng.integers(0, vocab, tail_len).astype(np.int32)]),
             max_new) for i in range(n)]


def _engines(**ec):
    jcfg, cfg = _cfgs()
    jp, tp = _params()
    return (JaxEngine(jcfg, params=jp, engine=JaxEngineConfig(**ec)),
            Engine(cfg, params=tp, device="cpu", engine=EngineConfig(**ec)))


def _state(eng):
    trie = eng.prefix.pages() if eng.prefix is not None else set()
    return (eng.cache.block_tables.tolist(), eng.cache.lengths.tolist(),
            sorted(trie), eng.cache.allocator.free_blocks)


def _lockstep(jeng, eng, reqs):
    """Submit ``reqs`` to both engines and tick them together: after
    every tick both partitions hold and the block tables, lengths, trie
    pages and free counts are equal.  Returns both engines' completions
    and the ticks run."""
    for uid, p, n in reqs:
        jeng.submit(JaxRequest(uid, p, max_new_tokens=n))
        eng.submit(Request(uid, p, max_new_tokens=n))
    ticks = 0
    while jeng.pending or eng.pending:
        assert jeng.pending and eng.pending, ticks
        jeng.step()
        eng.step()
        ticks += 1
        jeng.check_partition()
        eng.check_partition()
        assert _state(eng) == _state(jeng), ticks
    return jeng.collect(), eng.collect(), ticks


COUNTERS = ("admission_reorders", "trie_match_reuses", "preemptions",
            "prefill_tokens_computed", "prefill_batches",
            "total_decode_steps")


def _same_results(jout, out, jeng, eng):
    assert [c.uid for c in out] == [c.uid for c in jout]
    for a, b in zip(jout, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.status == "ok"
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    if jeng.prefix is not None:
        assert (dataclasses.asdict(eng.prefix_stats)
                == dataclasses.asdict(jeng.prefix_stats))


def _vocab():
    return _cfgs()[1].vocab_size


def _warm_hits():
    jeng, eng = _engines(num_slots=3, block_size=8, max_seq_len=96)
    for wave in range(2):
        out = _lockstep(jeng, eng, shared_prefix_requests(
            _vocab(), 4, 32, 9, 6, seed=1, uid0=10 * wave))
        _same_results(*out[:2], jeng, eng)
    ps = eng.prefix_stats
    assert ps.hits > 0 and ps.token_hit_rate > 0
    return jeng, eng


def _cow_aligned():
    """A cached page-aligned 32-token prompt: reuse stops at 31, so the
    last matched page is copied and one token computed."""
    jeng, eng = _engines(num_slots=2, block_size=8, max_seq_len=64)
    prompt = np.random.default_rng(3).integers(0, _vocab(), 32).astype(np.int32)
    for uid in range(2):
        _same_results(*_lockstep(jeng, eng, [(uid, prompt, 5)])[:2], jeng, eng)
    assert eng.prefix_stats.cow_copies == 1
    assert eng.prefix_stats.tokens_reused >= 31
    return jeng, eng


def _cow_partial():
    """A 30-token prompt ends inside a cached partial page: it is pinned
    and copied before the tail's write, three times over."""
    jeng, eng = _engines(num_slots=2, block_size=8, max_seq_len=64)
    prompt = np.random.default_rng(4).integers(0, _vocab(), 30).astype(np.int32)
    for uid in range(3):
        _same_results(*_lockstep(jeng, eng, [(uid, prompt, 1)])[:2], jeng, eng)
    assert eng.prefix_stats.cow_copies >= 1
    return jeng, eng


def _eviction():
    jeng, eng = _engines(num_slots=2, block_size=8, max_seq_len=48,
                         num_blocks=14)
    reqs = [shared_prefix_requests(_vocab(), 2, 16, 9, 5, seed=s,
                                   uid0=2 * s)[i]
            for s in range(3) for i in range(2)]
    _same_results(*_lockstep(jeng, eng, reqs)[:2], jeng, eng)
    assert eng.prefix_stats.evicted_pages > 0
    return jeng, eng


def _preempt():
    jeng, eng = _engines(num_slots=2, block_size=4, max_seq_len=32,
                         num_blocks=11)
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(0, _vocab(), 8).astype(np.int32), 22)
            for i in range(2)]
    _same_results(*_lockstep(jeng, eng, reqs)[:2], jeng, eng)
    assert eng.preemptions >= 1
    return jeng, eng


def _batched_admission():
    jeng, eng = _engines(num_slots=4, block_size=8, max_seq_len=48,
                         prefix_cache=False)
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(0, _vocab(), 9).astype(np.int32), 4)
            for i in range(4)]
    _same_results(*_lockstep(jeng, eng, reqs)[:2], jeng, eng)
    assert eng.prefill_batches == 1
    return jeng, eng


def _mixed_lengths():
    jeng, eng = _engines(num_slots=4, block_size=8, max_seq_len=96,
                         prefix_cache=False)
    rng = np.random.default_rng(8)
    reqs = [(i, rng.integers(0, _vocab(), n).astype(np.int32), 3)
            for i, n in enumerate((9, 9, 40, 40))]
    _same_results(*_lockstep(jeng, eng, reqs)[:2], jeng, eng)
    assert eng.prefill_batches == 1
    return jeng, eng


def _reorder():
    """The queue head needs more pages than eviction can free (the warm
    prefix is pinned by a running request) while a later request hits
    the trie: the hit is admitted past the head (``admission_reorders``)
    and the blocked head's match is kept across ticks."""
    jeng, eng = _engines(num_slots=3, block_size=8, max_seq_len=80,
                         num_blocks=13, max_batched_prefill=1)
    vocab = _vocab()
    rng = np.random.default_rng(11)
    warm = rng.integers(0, vocab, 24).astype(np.int32)
    _same_results(*_lockstep(jeng, eng, [(0, warm, 2)])[:2], jeng, eng)

    def tail(n):
        return rng.integers(0, vocab, n).astype(np.int32)

    reqs = [(1, np.concatenate([warm, tail(16)]), 12), (2, tail(64), 4),
            (3, np.concatenate([warm, tail(3)]), 4)]
    _same_results(*_lockstep(jeng, eng, reqs)[:2], jeng, eng)
    assert eng.admission_reorders > 0 and eng.trie_match_reuses > 0
    return jeng, eng


def _interleaved():
    jeng, eng = _engines(num_slots=3, block_size=8, max_seq_len=64,
                         num_blocks=24)
    uid = 0
    for round_ in range(3):
        reqs = shared_prefix_requests(_vocab(), 3, 24, 8, 4,
                                      seed=round_ % 2, uid0=uid)
        uid += 3
        _same_results(*_lockstep(jeng, eng, reqs)[:2], jeng, eng)
    ps = eng.prefix_stats
    assert ps.queries == 9 and ps.hits > 0 and ps.tokens_reused > 0
    return jeng, eng


ENGINE_CASES = {f.__name__[1:]: f for f in (
    _warm_hits, _cow_aligned, _cow_partial, _eviction, _preempt,
    _batched_admission, _mixed_lengths, _reorder, _interleaved)}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_scenario_equals_reference(case):
    """Each ``TestEnginePrefix`` scenario on both engines in lockstep:
    equal tables, lengths and trie pages every tick; equal streams,
    stats and counters at the end."""
    ENGINE_CASES[case]()


def test_warm_streams_equal_the_cold_engine():
    """The acceptance property on the port's own side: the warm second
    wave equals a cold engine (``prefix_cache=False``) on the same
    weights, with fewer prefill tokens computed."""
    _, eng = _warm_hits()
    _, tp = _params()
    cold = Engine(_cfgs()[1], params=tp, device="cpu", engine=EngineConfig(
        num_slots=4, block_size=8, max_seq_len=96, prefix_cache=False))
    reqs = shared_prefix_requests(_vocab(), 4, 32, 9, 6, seed=1, uid0=10)
    ref = cold.generate([Request(u, p, max_new_tokens=n) for u, p, n in reqs])
    eng2 = Engine(_cfgs()[1], params=tp, device="cpu",
                  engine=EngineConfig(num_slots=3, block_size=8,
                                      max_seq_len=96))
    eng2.generate([Request(u, p, max_new_tokens=n) for u, p, n in
                   shared_prefix_requests(_vocab(), 4, 32, 9, 6, seed=1)])
    before = eng2.prefill_tokens_computed
    out = eng2.generate([Request(u, p, max_new_tokens=n) for u, p, n in reqs])
    assert eng2.prefill_tokens_computed - before < cold.prefill_tokens_computed
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_live_cols_trims_decode_grid():
    _, cfg = _cfgs()
    _, tp = _params()
    eng = Engine(cfg, params=tp, device="cpu", engine=EngineConfig(
        num_slots=2, block_size=8, max_seq_len=256))
    eng.submit(Request(0, np.random.default_rng(9).integers(
        0, cfg.vocab_size, 9).astype(np.int32), max_new_tokens=4))
    eng.step()
    active = [(i, s) for i, s in enumerate(eng._slots) if s is not None]
    assert eng.cache.max_blocks_per_seq == 32
    assert eng._live_cols(active) == 2
    eng.run()
    eng.check_partition()


def test_f8_pages_copy_on_write_in_the_engine():
    """float8_e4m3fn pages: the aligned-prompt hit copies its boundary
    page byte for byte (before the tail's write, which lands past the
    copied positions), and the streams equal the cold f8 engine's."""
    _, cfg = _cfgs()
    _, tp = _params()
    ec = dict(num_slots=2, block_size=8, max_seq_len=64)
    eng = Engine(cfg, params=tp, device="cpu", kv_dtype="float8_e4m3fn",
                 engine=EngineConfig(**ec))
    cold = Engine(cfg, params=tp, device="cpu", kv_dtype="float8_e4m3fn",
                  engine=EngineConfig(**ec, prefix_cache=False))
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                               32).astype(np.int32)
    eng.generate([Request(0, prompt, max_new_tokens=5)])
    copies = []
    cow = eng.cache.cow_slot_page

    def recorded(slot, col):
        old, new = cow(slot, col)
        copies.append([p.view(torch.uint8)[:, [old, new]].clone()
                       for p in (eng.cache.k_pages, eng.cache.v_pages)])
        return old, new

    eng.cache.cow_slot_page = recorded
    out = eng.generate([Request(1, prompt, max_new_tokens=5)])
    ref = cold.generate([Request(1, prompt, max_new_tokens=5)])
    assert len(copies) == 1 and eng.prefix_stats.cow_copies == 1
    for pages in copies[0]:
        assert torch.equal(pages[:, 0], pages[:, 1])
    np.testing.assert_array_equal(out[0].tokens, ref[0].tokens)
    eng.check_partition()
