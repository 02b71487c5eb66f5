"""The port's speculative decoding against the JAX package's, on the CPU,
at the tiny size of ``tests/test_spec_decode.py`` (qwen3-1.7b tiny, 64
ids).

- ``runtime/drafter.py``: the ``TestPromptLookupDrafter`` cases, and 500
  random contexts, give the reference drafter's proposals.
- Token identity: with k in {1, 4, 8}, cold, over a warm prefix cache
  and with chunked prefill, the port's spec streams equal the
  reference's spec streams and the port's own vanilla streams, and
  ``spec_dispatches``, ``spec_proposed`` and ``spec_accepted`` equal the
  reference's; the page partition holds after every tick.
- A stop token inside the window, ``max_new_tokens`` never exceeded,
  the fallback to the vanilla dispatch on a stream with nothing to
  draft, and speculation over uint8 KV pages (the reference's act-quant
  tables handed to both sides).
Both engines hold the same weights (the reference's, converted with
``params_from_jax``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core import lama_layers as jll
from repro.models import api as jax_api
from repro.runtime import calibration as jcal
from repro.runtime.drafter import PromptLookupDrafter as JaxDrafter
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import EngineConfig as JaxEngineConfig
from repro.runtime.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.runtime.drafter import PromptLookupDrafter
from repro_torch.runtime.engine import Engine, EngineConfig, Request

TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64,
            compute_dtype="float32")
SPEC_COUNTERS = ("spec_dispatches", "spec_proposed", "spec_accepted",
                 "total_decode_steps")


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


def _ecfg(**kw):
    base = dict(num_slots=4, block_size=8, max_seq_len=160, prefill_chunk=16)
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def _params(codes: bool = False):
    """The reference's weights (seed 0) and their conversion.  ``codes``:
    the ``TestCompose`` size (128 ids, d_ff 192), 7-bit weights with the
    reference's act-quant tables (its fit on its default calibration
    prompts), attached as its ``Engine(act_quant=7)`` attaches them."""
    kw = dict(vocab_size=128, d_ff=192) if codes else {}
    jcfg, cfg = _cfgs(**kw)
    api = jax_api.get_model(jcfg)
    params = api.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    if codes:
        prompts = np.random.default_rng(0).integers(
            0, jcfg.vocab_size, (4, 32)).astype(np.int32)
        samples = api.collect_act_calibration(params, jnp.asarray(prompts),
                                              jcfg)
        act_q, _ = jcal.fit_sites(samples, 7)
        qparams, _ = jll.quantize_tree(params, 7, axes=api.logical_axes())
        params = jcal.attach_act_quant(qparams, act_q)
    return params, params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                   cfg, device="cpu")


def _engines(codes=False, **ec):
    """(reference engine, port engine) on the same weights and config."""
    kw = dict(vocab_size=128, d_ff=192) if codes else {}
    jcfg, cfg = _cfgs(**kw)
    jp, tp = _params(codes)
    return (JaxEngine(jcfg, params=jp, kv_codes=codes,
                      engine=JaxEngineConfig(**_ecfg(**ec))),
            Engine(cfg, params=tp, kv_codes=codes, device="cpu",
                   engine=EngineConfig(**_ecfg(**ec))))


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@functools.lru_cache(maxsize=None)
def repetitive_prompts(n=6, boot=24, max_new=48, codes=False):
    """As the reference's: a short seed plus a prefix of the model's own
    greedy rollout from it (the reference engine's), so decoding repeats
    spans the drafter finds in the prompt."""
    jeng, _ = _engines(codes, prefix_cache=False)
    vocab = jeng.cfg.vocab_size
    seeds = [_prompt(vocab, 8, 100 + i) for i in range(n)]
    boots = jeng.generate([JaxRequest(900 + i, s, max_new_tokens=boot + max_new)
                           for i, s in enumerate(seeds)])
    return tuple(np.concatenate([s, np.asarray(c.tokens[:boot], np.int32)])
                 for s, c in zip(seeds, sorted(boots, key=lambda c: c.uid)))


def _drain(eng):
    """Run the port's engine to the end, auditing the page partition
    after every tick; completions sorted by uid."""
    while eng.pending:
        eng.step()
        eng.check_partition()
    eng.check_partition()
    return sorted(eng.collect(), key=lambda c: c.uid)


def _tokens(outs):
    return [np.asarray(c.tokens).tolist() for c in outs]


def _serve(jeng, eng, reqs):
    """(uid, prompt, max_new, stop) requests through both engines:
    (reference tokens, port tokens)."""
    jout = jeng.generate([JaxRequest(u, p, max_new_tokens=n, stop_token=s)
                          for u, p, n, s in reqs])
    for u, p, n, s in reqs:
        eng.submit(Request(u, p, max_new_tokens=n, stop_token=s))
    return _tokens(sorted(jout, key=lambda c: c.uid)), _tokens(_drain(eng))


def _vanilla(reqs, codes=False, **ec):
    """The port's streams without speculation."""
    _, eng = _engines(codes, **{**ec, "spec_k": 0})
    for u, p, n, s in reqs:
        eng.submit(Request(u, p, max_new_tokens=n, stop_token=s))
    return _tokens(_drain(eng))


def _same_counters(jeng, eng):
    for name in SPEC_COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name


# ------------------------------------------------------------ drafter --

DRAFTER_CASES = [
    # (context, k, max_ngram, min_ngram, propose's k)
    ([7, 8, 9, 20, 21, 22, 7, 8, 9, 30, 31, 32, 7, 8, 9], 2, 3, 1, None),
    ([9, 50, 0, 8, 9, 60, 1, 8, 9], 1, 3, 1, None),
    ([1, 2, 3, 4, 5], 4, 3, 1, None),
    ([5, 6, 7, 5, 6], 8, 3, 1, None),
    ([5, 6, 7, 5, 6], 8, 3, 1, 1),
    ([3, 9, 1, 2, 3], 2, 2, 2, None),
    ([3, 9, 1, 2, 3], 2, 2, 1, None),
]


@pytest.mark.parametrize("case", range(len(DRAFTER_CASES)))
def test_drafter_cases_equal_reference(case):
    ctx, k, mx, mn, kk = DRAFTER_CASES[case]
    ctx = np.asarray(ctx, np.int32)
    got = PromptLookupDrafter(k, max_ngram=mx, min_ngram=mn).propose(ctx, k=kk)
    want = JaxDrafter(k, max_ngram=mx, min_ngram=mn).propose(ctx, k=kk)
    assert got.dtype == want.dtype and got.tolist() == want.tolist()


def test_drafter_random_contexts_and_validation_equal_reference():
    rng = np.random.default_rng(7)
    for _ in range(500):
        ctx = rng.integers(0, int(rng.integers(2, 10)),
                           int(rng.integers(1, 40))).astype(np.int32)
        mn = int(rng.integers(1, 4))
        mx = mn + int(rng.integers(0, 3))
        k = int(rng.integers(1, 6))
        assert np.array_equal(
            PromptLookupDrafter(k, max_ngram=mx, min_ngram=mn).propose(ctx),
            JaxDrafter(k, max_ngram=mx, min_ngram=mn).propose(ctx))
    for args, match in (((0,), "k must be"), ((2, 2, 3), "min_ngram"),
                        ((2, 2, 0), "min_ngram")):
        with pytest.raises(ValueError, match=match):
            PromptLookupDrafter(*args)


# ----------------------------------------------------- token identity --

@pytest.mark.parametrize("k", [1, 4, 8])
def test_cold_streams_equal_reference_and_vanilla(k):
    reqs = [(i, p, 48, None) for i, p in enumerate(repetitive_prompts())]
    jeng, eng = _engines(prefix_cache=False, spec_k=k)
    want, got = _serve(jeng, eng, reqs)
    assert got == want == _vanilla(reqs, prefix_cache=False)
    _same_counters(jeng, eng)
    assert eng.spec_dispatches > 0 and eng.spec_accepted > 0


@pytest.mark.parametrize("k", [1, 4, 8])
def test_warm_prefix_streams_equal_reference_and_vanilla(k):
    """A second wave of the same prompts hits the trie (tails prefilled
    from mid-page starts, boundary pages copied), and still decodes the
    reference's tokens."""
    prompts = repetitive_prompts()
    jeng, eng = _engines(spec_k=k)
    for wave in (0, 1):
        reqs = [(10 * wave + i, p, 32, None) for i, p in enumerate(prompts)]
        want, got = _serve(jeng, eng, reqs)
        assert got == want == _vanilla(reqs), wave
    _same_counters(jeng, eng)
    assert eng.prefix_stats.hits > 0 and eng.spec_dispatches > 0


@pytest.mark.parametrize("k", [1, 4, 8])
def test_chunked_prefill_streams_equal_reference_and_vanilla(k):
    vocab = _cfgs()[1].vocab_size
    reqs = [(i, np.concatenate([_prompt(vocab, 12, i)] * 3), 24, None)
            for i in range(5)]
    jeng, eng = _engines(prefill_chunk=8, prefix_cache=False, spec_k=k)
    want, got = _serve(jeng, eng, reqs)
    assert got == want == _vanilla(reqs, prefill_chunk=8, prefix_cache=False)
    _same_counters(jeng, eng)
    assert eng.spec_dispatches > 0


def test_stop_token_inside_the_window():
    """Each request stops at a token vanilla emits mid-stream: the spec
    engine retires it there, as the reference does."""
    prompts = repetitive_prompts(n=4)
    base = _vanilla([(i, p, 48, None) for i, p in enumerate(prompts)],
                    prefix_cache=False)
    stops = [t[len(t) // 2] for t in base]
    reqs = [(i, p, 48, int(s)) for i, (p, s) in enumerate(zip(prompts, stops))]
    jeng, eng = _engines(prefix_cache=False, spec_k=6)
    want, got = _serve(jeng, eng, reqs)
    assert got == want == _vanilla(reqs, prefix_cache=False)
    assert [t[-1] for t in got] == stops
    _same_counters(jeng, eng)


def test_max_new_tokens_never_exceeded():
    reqs = [(i, p, 7, None) for i, p in enumerate(repetitive_prompts())]
    jeng, eng = _engines(prefix_cache=False, spec_k=8)
    want, got = _serve(jeng, eng, reqs)
    assert got == want and all(len(t) == 7 for t in got)
    _same_counters(jeng, eng)


def test_stream_with_nothing_to_draft_falls_back_to_vanilla():
    """All-distinct prompts and short decodes: ticks with no proposal
    run the vanilla step, so fewer spec dispatches than decode steps,
    as in the reference."""
    rng = np.random.default_rng(0)
    vocab = _cfgs()[1].vocab_size
    reqs = [(i, rng.permutation(vocab)[:20].astype(np.int32), 4, None)
            for i in range(4)]
    jeng, eng = _engines(prefix_cache=False, spec_k=4)
    want, got = _serve(jeng, eng, reqs)
    assert got == want
    _same_counters(jeng, eng)
    assert eng.total_decode_steps > eng.spec_dispatches


def test_spec_with_kv_codes_equals_reference_and_vanilla():
    """Speculation over uint8 KV pages: the verify dispatch encodes its
    K/V at the write as a decode step does, so the streams equal the
    port's vanilla codes engine's and the reference's spec codes
    engine's."""
    prompts = repetitive_prompts(n=4, codes=True)
    reqs = [(i, p, 24, None) for i, p in enumerate(prompts)]
    jeng, eng = _engines(True, prefix_cache=False, spec_k=4)
    want, got = _serve(jeng, eng, reqs)
    assert got == want == _vanilla(reqs, True, prefix_cache=False)
    _same_counters(jeng, eng)
    assert eng.spec_dispatches > 0
