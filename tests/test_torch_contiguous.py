"""The port's contiguous-cache path against the JAX package's, on the CPU,
at the tiny qwen3-1.7b size: the contiguous flash decode
(``decode_gqa``, against the reference's kernel in interpret mode), the
model entry points ``forward``/``prefill``/``decode_step`` (flash and
dense decode branches, and the chunked ``_attend_flash`` with
``FLASH_THRESHOLD`` forced low) and ``InferenceServer.generate_bucketed``
token streams.

Both sides hold the same weights: random ones from the port's seeded
init, quantized by the port where the test asks for codes, and handed
to the reference as its params tree (the conversion the other way is
``params_from_jax``'s).  Tolerances: the decode kernel within 1e-5 (float32
on both sides, only the summation order differs); logits within 1e-5 of
their scale (float32 end to end; the reference's quantized matmuls run
its interpret-mode kernel, the port's its plain version).  Token streams
are equal.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
from repro.configs import get_config as jax_get_config
from repro.core import lama_layers as jll
from repro.kernels.decode_gqa import decode_gqa as jax_decode_gqa
from repro.models import api as jax_api
from repro.runtime.engine import Request as JaxRequest
from repro.runtime.server import InferenceServer as JaxServer
from repro_torch.configs import get_config
from repro_torch.core.exponential_quant import QWeight
from repro_torch.core import lama_layers as ll
from repro_torch.kernels.decode_gqa import decode_gqa
from repro_torch.models import api as torch_api
from repro_torch.models import layers as L
from repro_torch.models.transformer import DecoderLM
from repro_torch.runtime.server import InferenceServer, Request

TINY = dict(num_layers=2, d_model=64, d_ff=128, compute_dtype="float32")
LENS = (8, 32, 128, 8, 32, 17)      # test_engine.py TestEngine scenario
NEWS = (6, 4, 8, 3, 12, 5)
MAX_LEN = 140


def _cfgs():
    return (jax_get_config("qwen3-1.7b", tiny=True).replace(**TINY),
            get_config("qwen3-1.7b", tiny=True).replace(**TINY))


def _jax_tree(node):
    """The reference's params tree holding a port tree's values (qtensor
    leaves as its ``{codes, lut, qmeta}`` dicts)."""
    if isinstance(node, QWeight):
        return {k: jnp.asarray(getattr(node, k).numpy())
                for k in ("codes", "lut", "qmeta")}
    if isinstance(node, dict):
        return {k: _jax_tree(v) for k, v in node.items()}
    return jnp.asarray(node.numpy())


@functools.lru_cache(maxsize=None)
def _setup(quant_bits):
    """Random float weights (seed 0), quantized by the port when
    ``quant_bits`` is given; both sides hold the same bytes."""
    jcfg, cfg = _cfgs()
    tapi = torch_api.get_model(cfg)
    model = tapi.init("cpu", seed=0)
    if quant_bits is not None:
        qtree, _ = ll.quantize_tree(model.tree(), quant_bits,
                                    axes=tapi.logical_axes())
        model = DecoderLM(cfg, qtree, device="cpu")
    return jcfg, cfg, _jax_tree(model.tree()), model


@functools.lru_cache(maxsize=None)
def _japi(jcfg, flash_threshold, flash_decode=True):
    """The reference's contiguous entry points, jitted.  A trace reads
    ``FLASH_THRESHOLD`` and the ``flash_decode`` policy once, so each
    value gets its own (the cache key); call under the same policy."""
    del flash_threshold, flash_decode
    japi = jax_api.get_model(jcfg)

    class API:
        forward = staticmethod(jax.jit(japi.forward, static_argnums=(2,)))
        prefill = staticmethod(jax.jit(
            japi.prefill, static_argnums=(2, 3),
            static_argnames=("cache_dtype",)))
        decode_step = staticmethod(jax.jit(japi.decode_step,
                                           static_argnums=(3,)))

    return API


def _rel_err(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(port.numpy() - ref).max() / max(1.0, np.abs(ref).max()))


# ------------------------------------------------------ decode kernel --

@pytest.mark.parametrize("b,s,nkv,g,hd,lens,dtype", [
    (3, 700, 2, 2, 32, [0, 350, 700], "float32"),      # S not a multiple of 512
    (2, 130, 1, 4, 16, [129, 1], "bfloat16"),
    (4, 513, 2, 1, 64, [513, 0, 17, 512], "float32"),
    (1, 64, 4, 8, 128, [40], "bfloat16"),
])
def test_decode_gqa_matches_reference_kernel(b, s, nkv, g, hd, lens, dtype):
    r = np.random.default_rng(b * s + g)
    q = r.normal(size=(b, nkv, g, hd)).astype(np.float32)
    k = (r.normal(size=(b, s, nkv, hd)) * 0.3).astype(np.float32)
    v = (r.normal(size=(b, s, nkv, hd)) * 0.3).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jax_decode_gqa(jnp.asarray(q), jnp.asarray(k, jdt),
                         jnp.asarray(v, jdt), jnp.asarray(lens, jnp.int32))
    out = decode_gqa(torch.from_numpy(q), torch.from_numpy(k).to(tdt),
                     torch.from_numpy(v).to(tdt),
                     torch.tensor(lens, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.shape == (b, nkv, g, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(out[i] == 0)


def test_decode_gqa_masks_past_lengths_and_clips():
    """Entries at or past ``lengths`` do not reach the output; a scalar
    length broadcasts and a length past S is clipped to S."""
    r = np.random.default_rng(1)
    q = torch.from_numpy(r.normal(size=(2, 2, 2, 32)).astype(np.float32))
    k = torch.from_numpy(r.normal(size=(2, 96, 2, 32)).astype(np.float32))
    v = torch.from_numpy(r.normal(size=(2, 96, 2, 32)).astype(np.float32))
    out = decode_gqa(q, k, v, 50)
    k2, v2 = k.clone(), v.clone()
    k2[:, 50:], v2[:, 50:] = 999.0, -999.0
    assert torch.equal(decode_gqa(q, k2, v2, 50), out)
    assert torch.equal(decode_gqa(q, k, v, 1000), decode_gqa(q, k, v, 96))


# ------------------------------------------------ model entry points --

def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.fixture
def flash_threshold_low(monkeypatch):
    """Both sides' ``mha`` take the chunked online-softmax path
    (``_attend_flash``) for every mask descriptor."""
    monkeypatch.setattr(jax_layers, "FLASH_THRESHOLD", 1)
    monkeypatch.setattr(L, "FLASH_THRESHOLD", 1)


@pytest.mark.parametrize("quant", [None, 7])
@pytest.mark.parametrize("flash", [False, True])
def test_forward_matches_reference(quant, flash, request):
    if flash:
        request.getfixturevalue("flash_threshold_low")
    jcfg, cfg, params, model = _setup(quant)
    japi = _japi(jcfg, jax_layers.FLASH_THRESHOLD)
    toks = _tokens(cfg, 2, 20)
    jl, _ = japi.forward(params, jnp.asarray(toks), jcfg)
    tl, aux = torch_api.get_model(cfg).forward(model, torch.from_numpy(toks),
                                               cfg)
    assert tl.shape == (2, 20, cfg.vocab_size) and float(aux) == 0.0
    assert _rel_err(tl, jl) <= 1e-5


def test_attend_flash_chunks_match_dense():
    """The port's chunked path with several query and KV chunks (and
    ragged last chunks) against its dense path, per mask kind."""
    r = np.random.default_rng(5)
    q = torch.from_numpy(r.normal(size=(2, 21, 2, 2, 16)).astype(np.float32))
    k = torch.from_numpy(r.normal(size=(2, 21, 2, 16)).astype(np.float32))
    v = torch.from_numpy(r.normal(size=(2, 21, 2, 16)).astype(np.float32))
    for kind, arg in (("causal", None), ("local", 5), ("prefix", 7),
                      ("full", None)):
        dense = L._attend_dense(q, k, v, L._materialize_mask(
            kind, arg, 21, 21, 0, "cpu"), torch.float32)
        flash = L._attend_flash(q, k, v, kind, arg, 0, torch.float32,
                                q_chunk=8, k_chunk=8)
        torch.testing.assert_close(flash, dense, rtol=1e-5, atol=1e-5)


def _decode_both(quant, flash_decode, steps=4, plen=9, b=2):
    jcfg, cfg, params, model = _setup(quant)
    japi = _japi(jcfg, jax_layers.FLASH_THRESHOLD, flash_decode)
    tapi = torch_api.get_model(cfg)
    toks = _tokens(cfg, b, plen + steps)
    jl, jcache = japi.prefill(params, jnp.asarray(toks[:, :plen]), jcfg, 32,
                              cache_dtype=jnp.float32)
    tl, tcache = tapi.prefill(model, torch.from_numpy(toks[:, :plen]), cfg,
                              32, cache_dtype=torch.float32)
    errs = [_rel_err(tl, jl)]
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-5, atol=1e-5)
    assert tcache["pos"] == int(jcache["pos"]) == plen
    with jll.policy(flash_decode=flash_decode), \
            ll.policy(flash_decode=flash_decode):
        for t in range(plen, plen + steps):
            tok = toks[:, t:t + 1]
            jl, jcache = japi.decode_step(params, jcache, jnp.asarray(tok), jcfg)
            tl, tcache = tapi.decode_step(model, tcache, torch.from_numpy(tok),
                                          cfg)
            errs.append(_rel_err(tl, jl))
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]),
                               rtol=1e-5, atol=1e-5)
    assert tcache["pos"] == int(jcache["pos"])
    return errs


@pytest.mark.parametrize("quant", [None, 7])
@pytest.mark.parametrize("flash_decode", [True, False])
def test_prefill_and_decode_steps_match_reference(quant, flash_decode):
    errs = _decode_both(quant, flash_decode)
    assert max(errs) <= 1e-5, errs


def test_prefill_and_decode_match_reference_under_flash_attend(
        flash_threshold_low):
    errs = _decode_both(None, False)
    assert max(errs) <= 1e-5, errs


def test_decode_step_launch_paths(monkeypatch):
    """The flash branch calls ``mha_decode`` once per layer and step, the
    dense branch ``mha``; a full cache raises instead of clamping; a
    prefix is taken."""
    _, cfg, _, model = _setup(None)
    tapi = torch_api.get_model(cfg)
    calls = {"mha_decode": 0, "mha": 0}
    for name in calls:
        fn = getattr(L, name)

        def wrap(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(L, name, wrap)
    toks = torch.from_numpy(_tokens(cfg, 1, 6))
    _, cache = tapi.prefill(model, toks[:, :4], cfg, 6,
                            cache_dtype=torch.float32)
    calls.update(mha=0)
    _, cache = tapi.decode_step(model, cache, toks[:, 4:5], cfg)
    assert calls == {"mha_decode": cfg.num_layers, "mha": 0}
    with ll.policy(flash_decode=False):
        _, cache = tapi.decode_step(model, cache, toks[:, 5:6], cfg)
    assert calls == {"mha_decode": cfg.num_layers, "mha": cfg.num_layers}
    with pytest.raises(ValueError, match="cache full"):
        tapi.decode_step(model, cache, toks[:, 5:6], cfg)
    # a prefix goes ahead of the tokens, under the prefix-LM mask
    logits, _ = tapi.forward(model, toks, cfg,
                             prefix_embeds=torch.zeros(1, 2, 64))
    assert logits.shape == (1, 2 + 6, cfg.vocab_size)


# ----------------------------------------------------------- serving --

def _requests(cfg, cls, stop=None):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                max_new_tokens=int(m), stop_token=stop)
            for i, (n, m) in enumerate(zip(LENS, NEWS))]


@functools.lru_cache(maxsize=None)
def _reference_streams(quant):
    jcfg, _, params, _ = _setup(quant)
    srv = JaxServer(jcfg, params=params, num_slots=3, block_size=8,
                    max_len=MAX_LEN, prefix_cache=False)
    return srv.generate_bucketed(_requests(jcfg, JaxRequest))


def _port_server(quant):
    _, cfg, _, model = _setup(quant)
    return InferenceServer(cfg, params=model, num_slots=3, block_size=8,
                           max_len=MAX_LEN, device="cpu")


@pytest.mark.parametrize("quant", [None, 7])
def test_generate_bucketed_matches_reference(quant):
    ref = _reference_streams(quant)
    srv = _port_server(quant)
    out = srv.generate_bucketed(_requests(srv.cfg, Request))
    assert [c.uid for c in out] == [c.uid for c in ref]
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.decode_steps == a.decode_steps and b.status == "ok"
        assert b.prefill_s > 0 and b.decode_s >= 0


def test_generate_bucketed_equals_generate_and_stops():
    """The port's bucketed streams equal its Engine's; a stop token
    trims each stream after its first occurrence, on both paths."""
    srv = _port_server(None)
    ref = srv.generate(_requests(srv.cfg, Request))
    out = srv.generate_bucketed(_requests(srv.cfg, Request))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    stop = int(ref[4].tokens[3])
    ref = srv.generate(_requests(srv.cfg, Request, stop=stop))
    out = srv.generate_bucketed(_requests(srv.cfg, Request, stop=stop))
    assert len(out[4].tokens) == 4 and out[4].tokens[-1] == stop
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
