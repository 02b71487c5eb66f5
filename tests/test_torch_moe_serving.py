"""The port's Engine serving the MoE decoders against the JAX package's, on
the CPU, at the reference's tiny grok-1 and llama4-scout configs,
through ``tests/_torch_serving.py``'s side-by-side harness: both
engines hold the same weights and take the same calls, and every
observation must be equal, exactly -- per tick the requests' statuses
and token counts, the free pages and lengths; then the streams and the
counters.

- Greedy streams on float32 pages, the prefix cache on (the default)
  and off, over prompts that share a prefix.
- Codes mode (``act_quant`` tables fit by the port and handed to both,
  ``kv_codes=True``): the reference's quantized stream.
- ``spec_k=2``: the reference's speculative streams and counters, and
  the port's own vanilla streams.
- ``generate_bucketed`` (the contiguous cache, whose decode steps take
  the flash-decode kernel #9): the reference server's streams.
"""

import numpy as np
import pytest
import torch

from repro.runtime.engine import Request as JaxRequest
from repro.runtime.server import InferenceServer as JaxServer
from repro_torch.runtime.server import InferenceServer, Request

from _torch_serving import both, cfgs, counters, drain, prompt, weights

ARCHS = ("grok-1-314b", "llama4-scout-17b-a16e")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab: int):
    """Five prompts: three share a 13-token prefix (the trie's pages at
    block 4), one repeats an n-gram (something to draft), one stands
    alone."""
    base = prompt(vocab, 13, seed=1)
    tails = [prompt(vocab, n, seed=10 + n) for n in (3, 7, 11)]
    loop = [int(t) for t in prompt(vocab, 5, seed=5)] * 4
    return ([list(base) + list(t) for t in tails]
            + [loop, list(prompt(vocab, 9, seed=2))])


def serve(side, log, arch, kind, ec, kw):
    """The first request alone (it fills the trie), then the rest."""
    eng = side.engine(kind, arch=arch, ec=dict(num_slots=3, block_size=4,
                                               max_seq_len=64,
                                               prefill_chunk=8, **ec), **kw)
    ps = _prompts(side.cfg(kind, arch).vocab_size)
    done = []
    for batch in (ps[:1], ps[1:]):
        for p in batch:
            uid = len(done) + batch.index(p)
            eng.submit(side.request(uid, list(p), max_new_tokens=6))
        done += drain(eng, log)
    hits = eng.prefix_stats.tokens_reused if eng.prefix is not None else 0
    return done, {**counters(eng), "tokens_reused": hits}


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "cold"])
@pytest.mark.parametrize("arch", ARCHS)
def test_float_streams_equal_reference(arch, prefix):
    done, c = both(serve, arch, "float", {"prefix_cache": prefix}, {})
    assert [d[1] for d in done] == ["ok"] * 5
    assert (c["tokens_reused"] > 0) == prefix


@pytest.mark.parametrize("arch", ARCHS)
def test_codes_streams_equal_reference(arch):
    done, _ = both(serve, arch, "codes", {}, {"kv_codes": True})
    assert [d[1] for d in done] == ["ok"] * 5


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_streams_equal_reference_and_vanilla(arch):
    spec, c = both(serve, arch, "spec", {"spec_k": 2}, {})
    vanilla, _ = both(serve, arch, "spec", {}, {})
    assert [d[2] for d in spec] == [d[2] for d in vanilla]
    assert c["spec_dispatches"] > 0 and c["spec_proposed"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_streams_equal_reference(arch):
    jcfg, cfg = cfgs("float", arch)
    jp, tp, _ = weights("float", arch)
    kw = dict(num_slots=3, block_size=4, max_len=48)
    reqs = [(i, p, 6) for i, p in enumerate(_prompts(cfg.vocab_size))]
    ref = JaxServer(jcfg, params=jp, **kw).generate_bucketed(
        [JaxRequest(i, np.asarray(p, np.int32), n) for i, p, n in reqs])
    out = InferenceServer(cfg, params=tp, device="cpu", **kw
                          ).generate_bucketed(
        [Request(i, np.asarray(p, np.int32), n) for i, p, n in reqs])
    assert [c.uid for c in out] == [c.uid for c in ref]
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.status == "ok" and b.decode_steps == a.decode_steps


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tallies_the_routed_dispatch(arch):
    """The engine's capacity tally (the paged cache's device tally, read
    by ``PagedKVCache.moe_capacity``): one routed call a layer a dispatch, k
    slots a token, none dropped under capacities of at least 128 slots;
    the dense mixture routes through no capacity and leaves it at zero;
    the registry keeps the reference's keys only."""
    from repro_torch.runtime.engine import Engine, EngineConfig

    _, cfg = cfgs("float", arch)
    _, tp, _ = weights("float", arch)
    reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=6)
            for i, p in enumerate(_prompts(cfg.vocab_size))]
    for impl in ("routed", "dense_mixture"):
        eng = Engine(cfg.replace(moe_impl=impl), params=tp, device="cpu",
                     engine=EngineConfig(num_slots=3, block_size=4,
                                         max_seq_len=64, prefill_chunk=8))
        assert all(c.status == "ok" for c in eng.generate(reqs))
        assert not any("moe" in key for key in
                       eng.telemetry.registry.snapshot())
        cap = eng.cache.moe_capacity()
        if impl == "dense_mixture":
            assert cap == {"calls": 0, "slots": 0, "dropped": 0}
            continue
        dispatches = eng.prefill_batches + eng.total_decode_steps
        assert cap["calls"] == cfg.num_layers * dispatches > 0
        assert cap["slots"] % (cfg.num_layers * cfg.experts_per_token) == 0
        assert cap["slots"] >= cap["calls"] * cfg.experts_per_token
        assert cap["dropped"] == 0
