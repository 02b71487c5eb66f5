"""The port's serving engine against the JAX package's, on the CPU, at the
tiny qwen3-1.7b size.

Both servers hold the same weights (the reference's params converted
with ``params_from_jax``) and run with ``prefix_cache=False`` (the
prefix cache is held to the reference by
``tests/test_torch_prefix_cache.py``).  Greedy
token streams must be equal on the ``test_engine.py`` scenarios.  So
that equality is not luck, every token the port samples is checked to
win by a top-2 logit gap larger than twice the logits tolerance the
model-level tests hold the two sides to (2e-5): any two sets of logits
within that tolerance pick the same token.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core import lama_layers as jll
from repro.models import api as jax_api
from repro.runtime.engine import Request as JaxRequest
from repro.runtime.server import InferenceServer as JaxServer
from repro_torch.configs import get_config
from repro.runtime.paged_cache import PagedKVCache as JaxCache
from repro_torch.convert import params_from_jax
from repro_torch.models import api as torch_api
from repro_torch.runtime.chaos import ChaosConfig, ChaosInjector
from repro_torch.runtime.engine import Engine, EngineConfig, Request
from repro_torch.runtime.paged_cache import PagedKVCache as TorchCache
from repro_torch.runtime.server import InferenceServer

LOGITS_TOL = 2e-5
TINY = dict(num_layers=2, d_model=64, d_ff=128, compute_dtype="float32")


def _cfgs(**kw):
    kw = {**TINY, **kw}
    return (jax_get_config("qwen3-1.7b", tiny=True).replace(**kw),
            get_config("qwen3-1.7b", tiny=True).replace(**kw))


@functools.lru_cache(maxsize=None)
def _jax_params(quant_bits):
    """The reference's weights (seed 0), quantized once per bit width."""
    jcfg, _ = _cfgs()
    api = jax_api.get_model(jcfg)
    params = api.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant_bits is not None:
        params, _ = jll.quantize_tree(params, quant_bits,
                                      axes=api.logical_axes())
    return params


@functools.lru_cache(maxsize=None)
def _jax_server(quant_bits, num_slots, block_size, max_len):
    jcfg, _ = _cfgs()
    return JaxServer(jcfg, params=_jax_params(quant_bits),
                     num_slots=num_slots, block_size=block_size,
                     max_len=max_len, prefix_cache=False)


def _port_params(jsrv):
    _, cfg = _cfgs()
    tree = jax.tree_util.tree_map(np.asarray, jsrv.params)
    return params_from_jax(tree, cfg, device="cpu")


def _requests(cfg, lens, news, cls):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, int(l)).astype(np.int32),
                max_new_tokens=int(n))
            for i, (l, n) in enumerate(zip(lens, news))]


class _GapRecorder:
    """Wraps the model entry points the Engine calls and records the
    smallest top-2 logit gap among the rows that sample a token."""

    def __init__(self, eng: Engine):
        self.min_gap = float("inf")
        self.sampled = 0
        api = eng.api

        def prefill(params, tokens, view, cfg, start=None):
            logits, view = api.prefill_into_cache(params, tokens, view, cfg,
                                                  start)
            s = tokens.shape[1]
            st = torch.zeros_like(view.lengths) if start is None else start
            rows = (view.lengths - st > 0) & (view.lengths - st <= s)
            self._note(logits, rows)
            return logits, view

        def decode(params, view, tokens, active, cfg):
            logits, view = api.decode_step_paged(params, view, tokens,
                                                 active, cfg)
            self._note(logits, active)
            return logits, view

        eng.api = dataclasses.replace(api, prefill_into_cache=prefill,
                                      decode_step_paged=decode)

    def _note(self, logits, rows):
        top2 = logits[:, -1].topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1])[rows]
        if gaps.numel():
            self.min_gap = min(self.min_gap, float(gaps.min()))
            self.sampled += int(gaps.numel())


def _serve_port(srv, reqs):
    """Drive the engine tick by tick: the page-partition audit must hold
    after every tick."""
    eng = srv.make_engine(reqs)
    rec = _GapRecorder(eng)
    for r in reqs:
        eng.submit(r)
    while eng.pending:
        eng.step()
        eng.check_partition()
    assert eng.cache.allocator.blocks_in_use == 0
    return eng.collect(), rec, eng


SCENARIOS = {
    # name: (lens, news, num_slots, block_size, max_len)
    "mixed_stream": ((8, 32, 128, 8, 32, 17), (6, 4, 8, 3, 12, 5), 3, 8, 140),
    "block_boundary_mid_decode": ((6,), (12,), 1, 8, 32),
    "more_requests_than_slots": ((8,) * 6, (2, 2, 8, 2, 2, 2), 2, 8, 32),
    "max_new_zero": ((8, 9), (0, 3), 1, 8, 32),
}


# 7-bit weights on every scenario but the 12-step single-slot one, whose
# reference side compiles a dozen interpret-mode decode shapes
CASES = [(name, quant) for name in sorted(SCENARIOS) for quant in (None, 7)
         if (name, quant) != ("block_boundary_mid_decode", 7)]


@pytest.mark.parametrize("name,quant", CASES)
def test_token_streams_equal_reference(name, quant):
    lens, news, slots, bs, max_len = SCENARIOS[name]
    jcfg, cfg = _cfgs()
    jsrv = _jax_server(quant, slots, bs, max_len)
    ref = jsrv.generate(_requests(jcfg, lens, news, JaxRequest))
    srv = InferenceServer(cfg, params=_port_params(jsrv), num_slots=slots,
                          block_size=bs, max_len=max_len, prefix_cache=False,
                          device="cpu")
    out, rec, eng = _serve_port(srv, _requests(cfg, lens, news, Request))
    assert [c.uid for c in out] == [c.uid for c in ref]
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.status == "ok" and len(b.tokens) == len(a.tokens)
    assert rec.sampled >= sum(news)
    if rec.sampled:
        assert rec.min_gap > 2 * LOGITS_TOL, rec.min_gap


def test_bf16_kv_pages_token_streams_equal_reference():
    """bfloat16 KV pages: both sides round K/V to bf16 at the write
    (round to nearest even) and upcast after the load, so the mixed
    stream stays token-identical."""
    lens, news, slots, bs, max_len = SCENARIOS["mixed_stream"]
    jcfg, cfg = _cfgs()
    jsrv = JaxServer(jcfg, params=_jax_params(None), num_slots=slots,
                     block_size=bs, max_len=max_len, prefix_cache=False,
                     kv_dtype="bfloat16")
    ref = jsrv.generate(_requests(jcfg, lens, news, JaxRequest))
    srv = InferenceServer(cfg, params=_port_params(jsrv), num_slots=slots,
                          block_size=bs, max_len=max_len, prefix_cache=False,
                          device="cpu", kv_dtype="bfloat16")
    out, rec, eng = _serve_port(srv, _requests(cfg, lens, news, Request))
    assert eng.cache.k_pages.dtype == torch.bfloat16
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    assert rec.min_gap > 2 * LOGITS_TOL, rec.min_gap


def test_block_boundary_grows_one_page_at_a_time():
    jsrv = _jax_server(None, 1, 8, 32)
    _, cfg = _cfgs()
    eng = Engine(cfg, params=_port_params(jsrv), device="cpu",
                 engine=EngineConfig(num_slots=1, block_size=8,
                                     max_seq_len=32))
    eng.submit(_requests(cfg, [6], [12], Request)[0])
    eng.step()
    assert len(eng.cache.slot_blocks[0]) == 1      # 6+1 tokens, 1 page
    grown = []
    while eng.pending:
        eng.step()
        grown.append(len(eng.cache.slot_blocks[0]))
    assert 2 in grown
    assert eng.cache.allocator.peak_in_use == 3     # 17 written slots


def test_stream_yields_the_run_tokens():
    """``stream`` drives the engine and yields one request's tokens as
    they come; ``run`` then collects both requests."""
    jsrv = _jax_server(None, 2, 8, 64)
    _, cfg = _cfgs()
    eng = Engine(cfg, params=_port_params(jsrv), device="cpu",
                 engine=EngineConfig(num_slots=2, block_size=8,
                                     max_seq_len=64))
    reqs = _requests(cfg, [8, 32], [6, 4], Request)
    h0 = eng.submit(reqs[0])
    eng.submit(reqs[1])
    streamed = list(eng.stream(h0))
    done = eng.run()
    assert [c.uid for c in done] == [0, 1]
    np.testing.assert_array_equal(streamed, done[0].tokens)
    assert len(streamed) == 6 and len(done[1].tokens) == 4


def test_chunked_equals_unchunked_prefill():
    """On the port's own side, prompts split across ticks in 8-token
    chunks (interleaved with running decodes) give the same tokens as
    whole-prompt chunks."""
    jsrv = _jax_server(None, 3, 8, 140)
    _, cfg = _cfgs()
    params = _port_params(jsrv)
    lens, news = (8, 32, 128, 17), (6, 4, 8, 5)
    outs = []
    for chunk in (256, 8):
        eng = Engine(cfg, params=params, device="cpu", engine=EngineConfig(
            num_slots=3, block_size=8, max_seq_len=192, prefill_chunk=chunk))
        outs.append(eng.generate(_requests(cfg, lens, news, Request)))
    assert outs[1][0].tokens.size
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_preemption_recompute_is_token_identical():
    """A pool too small for every slot forces preempt-youngest; greedy
    recompute keeps the streams equal to an unconstrained engine."""
    jsrv = _jax_server(None, 3, 8, 140)
    _, cfg = _cfgs()
    params = _port_params(jsrv)
    reqs = lambda: _requests(cfg, (20, 20, 20), (14, 14, 14), Request)
    big = Engine(cfg, params=params, device="cpu", engine=EngineConfig(
        num_slots=3, block_size=8, max_seq_len=48))
    small = Engine(cfg, params=params, device="cpu", engine=EngineConfig(
        num_slots=3, block_size=8, max_seq_len=48, num_blocks=10))
    ref, out = big.generate(reqs()), small.generate(reqs())
    assert small.preemptions > 0
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_bf16_compute_logits_close_to_reference():
    """bfloat16 activations on both sides: the reference and the port
    round to bf16 at different points, so one prefill chunk and one
    decode step are held to 5e-2 of the logits' scale (bf16 has 8
    mantissa bits; two layers compound a few roundings)."""
    jcfg, cfg = _cfgs(compute_dtype="bfloat16")
    japi = jax_api.get_model(jcfg)
    params = japi.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    kw = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, num_slots=1, block_size=8,
              num_blocks=8, max_blocks_per_seq=4)
    jc, tc = JaxCache(**kw), TorchCache(**kw, device="cpu")
    prompt = _requests(cfg, [13], [1], Request)[0].prompt
    for c in (jc, tc):
        c.allocator.reserve(3)
        c.bind_slot(0, len(prompt))
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = prompt
    jl, jv = japi.prefill_into_cache(params, jnp.asarray(toks), jc.view(),
                                     jcfg)
    tl, _ = torch_api.get_model(cfg).prefill_into_cache(
        model, torch.from_numpy(toks), tc.view(), cfg)
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=5e-2 * scale)
    jc.k_pages, jc.v_pages = jv.k_pages, jv.v_pages
    nxt = np.asarray([[int(np.argmax(np.asarray(jl)[0, -1]))]], np.int32)
    jl, _ = japi.decode_step_paged(params, jc.view(), jnp.asarray(nxt),
                                   jnp.asarray([True]), jcfg)
    tl, _ = torch_api.get_model(cfg).decode_step_paged(
        model, tc.view(), torch.from_numpy(nxt), torch.tensor([True]), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=5e-2 * scale)


@pytest.mark.parametrize("kw,item", [
    pytest.param(dict(max_queue=4), None, id="kw0-item 11"),
    pytest.param(dict(role="prefill"), None, id="kw1-item 12"),
    pytest.param(dict(drift_check_every=4), None, id="kw2-item 12"),
])
def test_unported_engine_settings_raise(kw, item):
    """The settings of the items once parked are all served now: the
    bounded queue (item 11), the disaggregation roles (item 12's
    cluster half) and the drift guard (item 12's single-engine half);
    ``item`` names one that would still raise."""
    _, cfg = _cfgs()
    if item is None:
        eng = Engine(cfg, device="cpu", engine=EngineConfig(**kw))
        assert all(getattr(eng.engine_cfg, k) == v for k, v in kw.items())
        return
    with pytest.raises(NotImplementedError, match=item):
        Engine(cfg, device="cpu", engine=EngineConfig(**kw))


def test_negative_spec_k_raises():
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="spec_k"):
        Engine(cfg, device="cpu", engine=EngineConfig(spec_k=-1))


def test_prefix_cache_and_speculation_are_served_by_default_settings():
    """The reference's defaults: the prefix cache on, in the Engine and
    the server; ``spec_k`` builds a drafter instead of raising."""
    _, cfg = _cfgs()
    assert EngineConfig().prefix_cache
    eng = Engine(cfg, device="cpu", engine=EngineConfig(spec_k=2))
    assert eng.prefix is not None and eng.drafter is not None
    srv = InferenceServer(cfg, device="cpu")
    assert srv.prefix_cache and srv.make_engine([]).prefix is not None


@pytest.mark.parametrize("kw,item", [
    pytest.param(dict(chaos=ChaosConfig(seed=0, nan_rate=0.5)), "item 11",
                 id="kw1-item 11")])
def test_unported_serving_options_raise(kw, item):
    """Chaos injection (item 11) is served: the engine takes a
    ``ChaosConfig`` and builds its injector."""
    _, cfg = _cfgs()
    eng = Engine(cfg, device="cpu", **kw)
    assert isinstance(eng.chaos, ChaosInjector)
    assert eng.chaos.cfg == kw["chaos"]


def test_f8_kv_dtype_builds_f8_pools():
    """``kv_dtype="float8_e4m3fn"`` is served: the pools hold 1 B an
    element, a quarter of float32's."""
    _, cfg = _cfgs()
    eng = Engine(cfg, device="cpu", kv_dtype="float8_e4m3fn")
    f32 = Engine(cfg, device="cpu")
    assert eng.cache.k_pages.dtype == eng.cache.v_pages.dtype == torch.float8_e4m3fn
    assert 4 * eng.cache.nbytes == f32.cache.nbytes
