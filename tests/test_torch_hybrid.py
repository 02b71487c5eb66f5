"""The port's hybrid family (``repro_torch.models.rglru``, recurrentgemma-2b)
against the JAX package's ``models/rglru.py``, on the CPU, at the
reference's tiny size (3 layers: rec, rec, local; d_model 64, window 16)
with float32 compute.

Both sides hold the same weights: the reference's (seed 0), converted
by ``params_from_jax``; with 7-bit codes, the reference's quantized tree
converted.  Tolerances, relative to the largest magnitude of the
reference's result: the RG-LRU gates, the temporal conv, the decode
step of the recurrence and the recurrent block within 1e-6; the scan
within SCAN_TOL (it combines in the reference's tree, but torch's
elementwise products round where XLA may contract to a fused
multiply-add); logits within 1e-5 or, where larger, four times the
port's own spread under a last-bit change of its weights (``_tol``;
phase 3's rule in ``chip_smoke.py``), float32 end to end, the quantized
matmuls through the reference's interpret-mode kernel and the port's
plain version.  That spread is measured, not assumed: the tiny model's
local attention has no qk-norm, its random weights give scores near
200, and float32's rounding alone then moves the logits by ~3e-5 of
their scale (the reference's attention block is itself 5.7e-6 of its
scale off a float64 evaluation, the port's 3.3e-6).  The decode ring is
held across several wraps of the 16-position window.  Token streams
from ``InferenceServer.generate`` (the bucketed fallback on both sides)
are equal, and every sampled token wins by a top-2 gap above twice the
logits tolerance.
"""

import dataclasses
import functools
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
from repro.configs import get_config as jax_get_config
from repro.core import lama_layers as jll
from repro.launch import serve as jserve
from repro.models import api as jax_api
from repro.models import rglru as jr
from repro.runtime.engine import Request as JaxRequest
from repro.runtime.server import InferenceServer as JaxServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import lama_layers as ll
from repro_torch.core.exponential_quant import QWeight
from repro_torch.launch import serve as tserve
from repro_torch.models import api as torch_api
from repro_torch.models import layers as L
from repro_torch.models import rglru as tr
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.server import InferenceServer, Request

ARCH = "recurrentgemma-2b"
OP_TOL = 1e-6
SCAN_TOL = 1e-6
LOGITS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jax_get_config(ARCH, tiny=True).replace(compute_dtype="float32"),
            get_config(ARCH, tiny=True).replace(compute_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _setup(quant):
    """(jcfg, cfg, the reference's params, the port's module holding
    them); ``quant`` bits quantize the reference's tree first."""
    jcfg, cfg = _cfgs()
    japi = jax_api.get_model(jcfg)
    params = japi.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant is not None:
        params, _ = jll.quantize_tree(params, quant, axes=japi.logical_axes())
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, cfg, params, model


@functools.lru_cache(maxsize=None)
def _japi(jcfg, flash_threshold):
    """The reference's entry points, jitted (a trace reads
    ``FLASH_THRESHOLD`` once, so each value gets its own)."""
    del flash_threshold
    japi = jax_api.get_model(jcfg)

    class API:
        forward = staticmethod(jax.jit(japi.forward, static_argnums=(2,)))
        prefill = staticmethod(jax.jit(
            japi.prefill, static_argnums=(2, 3),
            static_argnames=("cache_dtype",)))
        decode_step = staticmethod(jax.jit(japi.decode_step,
                                           static_argnums=(3,)))

    return API


def _rel(port, ref) -> float:
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy()
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(1.0, np.abs(ref).max()))


def _nudged(model, rel: float = 2 ** -22):
    """``model`` with every matmul weight (float, or a code table) scaled
    by ``1 + rel``: a change in the last bits, nothing else changed."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif isinstance(v, QWeight):
                out[k] = QWeight(v.codes, v.lut * (1 + rel), v.qmeta)
            else:
                out[k] = v * (1 + rel) if ll.default_predicate((k,), v) else v
        return out

    return model.with_tree(walk(model.tree()))


def _tol(run, model) -> float:
    """The logits tolerance of ``run(model)`` (a list of logits): 1e-5
    of their scale, or four times the port's own spread under a
    last-bit change of the weights, if larger."""
    spread = max(_rel(b, a.numpy()) for a, b in zip(run(model),
                                                    run(_nudged(model))))
    return max(LOGITS_TOL, 4 * spread)


def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _x(shape, seed=4, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# ------------------------------------------------------- the weights --

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("quant", [None, 7])
def test_params_from_jax_round_trip_exact(quant):
    _, cfg, params, model = _setup(quant)
    assert isinstance(model, tr.HybridLM)
    ref = _flat(params)
    got = {k: v.numpy() for k, v in model.named_buffers()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for name in ("lam", "conv_w", "conv_b", "ba", "bx"):
        assert f"blocks.layer_00.rec.{name}" in got
    lp = model.layer(2)
    assert set(lp) == {"ln1", "ln2", "attn", "mlp"}
    assert set(model.layer(0)) == {"ln1", "ln2", "rec", "mlp"}
    if quant:
        assert isinstance(lp["attn"]["wq"], QWeight)
        assert isinstance(model.layer(0)["rec"]["wa"], QWeight)
        assert not isinstance(model.layer(0)["rec"]["conv_w"], QWeight)


def test_quantize_tree_matches_reference():
    """Per tensor, under the reference's predicate: the same leaves
    quantize (``conv_w``, ``lam``, the biases and norms stay float), and
    codes agree except at rounding boundaries -- at most 1e-4 of all
    codes one step apart."""
    jcfg, cfg, jparams, model = _setup(None)
    japi = jax_api.get_model(jcfg)
    jq, jrep = jll.quantize_tree(jparams, 7, axes=japi.logical_axes())
    tq, trep = ll.quantize_tree(model.tree(), 7,
                                axes=torch_api.get_model(cfg).logical_axes())
    assert set(trep) == set(jrep)
    assert ("blocks", "layer_00", "rec", "wa") in trep
    assert not any(p[-1] in ("conv_w", "lam", "ba", "bx") for p in trep)
    total = differ = 0
    for path in jrep:
        jleaf, tleaf = jq, tq
        for k in path:
            jleaf, tleaf = jleaf[k], tleaf[k]
        jc = np.asarray(jleaf["codes"]).astype(np.int16)
        tc = tleaf.codes.numpy().astype(np.int16)
        assert jc.shape == tc.shape and tleaf.lut.ndim == 1
        np.testing.assert_array_equal(tc >> 7, jc >> 7)
        assert np.abs(tc - jc).max() <= 1
        total += jc.size
        differ += int((tc != jc).sum())
        jl = np.asarray(jleaf["lut"])
        np.testing.assert_allclose(tleaf.lut.numpy(), jl, rtol=0,
                                   atol=1e-4 * np.abs(jl).max())
    assert differ <= 1e-4 * total, (differ, total)
    hybrid = tr.HybridLM(cfg, tq, device="cpu")
    assert ll.quantized_fraction(hybrid.tree()) > 0.9


# ------------------------------------------------ the recurrent block --

def _rec_params(quant):
    _, _, params, model = _setup(quant)
    return params["blocks"]["layer_00"]["rec"], model.layer(0)["rec"]


@pytest.mark.parametrize("quant", [None, 7])
def test_gates_match_reference(quant):
    jp, tp = _rec_params(quant)
    x = _x((2, 9, 64))
    ja, jb = jax.jit(jr._gates)(jp, jnp.asarray(x))
    ta, tb = tr._gates(tp, torch.from_numpy(x))
    assert ta.dtype == tb.dtype == torch.float32
    assert _rel(ta, ja) <= OP_TOL and _rel(tb, jb) <= OP_TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_temporal_conv_matches_reference(with_state):
    jp, tp = _rec_params(None)
    x = _x((2, 7, 64))
    st = _x((2, 3, 64), seed=5) if with_state else None
    jy, jst = jr.temporal_conv(jp, jnp.asarray(x),
                               None if st is None else jnp.asarray(st))
    ty, tst = tr.temporal_conv(tp, torch.from_numpy(x),
                               None if st is None else torch.from_numpy(st))
    assert _rel(ty, jy) <= OP_TOL
    assert _rel(tst, jst) == 0.0


@pytest.mark.parametrize("quant", [None, 7])
@pytest.mark.parametrize("s", [1, 2, 7, 24, 37])
def test_rglru_scan_matches_reference(quant, s):
    """The log-depth scan against ``jax.lax.associative_scan``, odd and
    even lengths (both branches of the recursion)."""
    jp, tp = _rec_params(quant)
    x = _x((2, s, 64))
    jh = jax.jit(jr.rglru_scan)(jp, jnp.asarray(x))
    th = tr.rglru_scan(tp, torch.from_numpy(x))
    assert _rel(th, jh) <= SCAN_TOL


def test_rglru_scan_equals_the_sequential_recurrence():
    """The scan is ``h_t = a_t h_{t-1} + b_t`` from zero."""
    _, tp = _rec_params(None)
    x = torch.from_numpy(_x((2, 19, 64)))
    a, b = tr._gates(tp, x)
    h, hs = torch.zeros(2, 64), []
    for t in range(19):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    torch.testing.assert_close(tr.rglru_scan(tp, x), torch.stack(hs, 1),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quant", [None, 7])
def test_rglru_step_and_rec_block_match_reference(quant):
    jp, tp = _rec_params(quant)
    jcfg, cfg, _, _ = _setup(quant)
    x1 = _x((2, 1, 64))
    h0 = _x((2, 64), seed=6)
    jo, jh = jr.rglru_step(jp, jnp.asarray(x1), jnp.asarray(h0))
    to, th = tr.rglru_step(tp, torch.from_numpy(x1), torch.from_numpy(h0))
    assert _rel(to, jo) <= OP_TOL and _rel(th, jh) <= OP_TOL
    x = _x((2, 11, 64), scale=0.5)
    jy, jst = jax.jit(jr.rec_block, static_argnums=(2,))(jp, jnp.asarray(x),
                                                         jcfg)
    ty, tst = tr.rec_block(tp, torch.from_numpy(x), cfg)
    assert _rel(ty, jy) <= OP_TOL
    assert _rel(tst["conv"], jst["conv"]) <= OP_TOL
    assert _rel(tst["h"], jst["h"]) <= OP_TOL
    state = {"conv": _x((2, 3, 64), seed=7), "h": _x((2, 64), seed=8)}
    jy, jst = jr.rec_block(jp, jnp.asarray(x1), jcfg,
                           {k: jnp.asarray(v) for k, v in state.items()})
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    ty, tst = tr.rec_block(tp, torch.from_numpy(x1), cfg, tstate)
    assert _rel(ty, jy) <= OP_TOL and _rel(tst["h"], jst["h"]) <= OP_TOL
    assert _rel(tst["conv"], jst["conv"]) == 0.0
    assert torch.equal(tstate["h"], torch.from_numpy(state["h"]))


# ---------------------------------------------------- the decode ring --

def test_local_attn_ring_across_wraps_matches_reference():
    """56 decode steps of the local block from an empty ring (40 past
    the 16-position window): outputs, ring slots and ``kpos`` every
    step, against the reference's functional ring (the attention's
softmax within the logits tolerance, the ring's K/V within 1e-6)."""
    jcfg, cfg, params, model = _setup(None)
    jp, tp = params["blocks"]["layer_02"]["attn"], model.layer(2)["attn"]
    jcache = jr.init_window_cache(jcfg, 2, jnp.float32)
    tcache = tr.init_window_cache(cfg, 2, torch.float32, device="cpu")
    step = jax.jit(lambda p, x, pos, c: jr.local_attn_block(
        p, x, jcfg, jnp.broadcast_to(pos, (2, 1)), c, pos))
    xs = _x((56, 2, 1, 64), seed=9)
    for t in range(56):
        jo, jcache = step(jp, jnp.asarray(xs[t]), jnp.int32(t), jcache)
        pos = t if t % 2 else torch.tensor(t)          # int and 0-d tensor
        to, tcache2 = tr.local_attn_block(
            tp, torch.from_numpy(xs[t]), cfg,
            torch.full((2, 1), t), tcache, pos)
        assert tcache2 is tcache                         # in place
        assert _rel(to, jo) <= 1e-5, t
        np.testing.assert_array_equal(tcache["kpos"].numpy(),
                                      np.asarray(jcache["kpos"]))
    assert _rel(tcache["k"], jcache["k"]) <= OP_TOL
    assert _rel(tcache["v"], jcache["v"]) <= OP_TOL
    assert sorted(tcache["kpos"].tolist()) == list(range(40, 56))


# -------------------------------------------------- the model's steps --

def _decode_both(quant, plen, steps, b=2, cache_dtype="float32"):
    """Prefill ``plen`` tokens and decode ``steps`` more on both sides;
    returns the relative logits errors, their tolerance and the two
    final caches."""
    jcfg, cfg, params, model = _setup(quant)
    japi = _japi(jcfg, jax_layers.FLASH_THRESHOLD)
    tapi = torch_api.get_model(cfg)
    toks = _tokens(cfg, b, plen + steps)
    jdt, tdt = jnp.dtype(cache_dtype), getattr(torch, cache_dtype)
    caches = []

    def run(m):
        tl, tc = tapi.prefill(m, torch.from_numpy(toks[:, :plen]), cfg, 64,
                              cache_dtype=tdt)
        assert tl.shape == (b, 1, cfg.vocab_size) and tc["pos"] == plen
        outs = [tl]
        for t in range(plen, plen + steps):
            tl, tc = tapi.decode_step(m, tc, torch.from_numpy(toks[:, t:t + 1]),
                                      cfg)
            outs.append(tl)
        caches.append(tc)
        return outs

    tol = _tol(run, model)
    jl, jc = japi.prefill(params, jnp.asarray(toks[:, :plen]), jcfg, 64,
                          cache_dtype=jdt)
    refs = [jl]
    for t in range(plen, plen + steps):
        jl, jc = japi.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jcfg)
        refs.append(jl)
    errs = [_rel(a, r) for a, r in zip(run(model), refs)]
    tc = caches[-1]
    assert tc["pos"] == int(jc["pos"]) == plen + steps
    return errs, tol, tc, jc


@pytest.mark.parametrize("quant", [None, 7])
@pytest.mark.parametrize("plen", [10, 24])
def test_prefill_and_decode_match_reference(quant, plen):
    """Prompts shorter and longer than the window, then 40 decode steps
    (the ring wraps); logits every step, and the final rings and
    recurrent states."""
    errs, tol, tc, jc = _decode_both(quant, plen, 40)
    assert max(errs) <= tol, (errs, tol)
    for key, kind in enumerate(tr.layer_kinds(_setup(quant)[1])):
        name = f"layer_{key:02d}"
        if kind == "local":
            np.testing.assert_array_equal(tc[name]["kpos"].numpy(),
                                          np.asarray(jc[name]["kpos"]))
            assert _rel(tc[name]["k"], jc[name]["k"]) <= tol
        else:
            assert _rel(tc[name]["h"], jc[name]["h"]) <= tol
            assert _rel(tc[name]["conv"], jc[name]["conv"]) <= tol


def test_bf16_cache_matches_reference():
    """A bfloat16 cache: the prefill rounds the rings and the recurrent
    states through it, as the reference's does."""
    errs, tol, tc, jc = _decode_both(None, 20, 6, cache_dtype="bfloat16")
    assert tc["layer_02"]["k"].dtype == torch.bfloat16
    assert max(errs) <= tol, (errs, tol)


@functools.lru_cache(maxsize=None)
def _forward_tol(quant) -> float:
    """The forward's logits tolerance on 2 x 40 tokens (``_tol``)."""
    _, cfg, _, model = _setup(quant)
    toks = torch.from_numpy(_tokens(cfg, 2, 40))
    fwd = torch_api.get_model(cfg).forward
    return _tol(lambda m: [fwd(m, toks, cfg)[0]], model)


@pytest.mark.parametrize("quant", [None, 7])
def test_forward_matches_reference(quant):
    jcfg, cfg, params, model = _setup(quant)
    toks = _tokens(cfg, 2, 40)
    jl, _ = _japi(jcfg, jax_layers.FLASH_THRESHOLD).forward(
        params, jnp.asarray(toks), jcfg)
    tl, aux = torch_api.get_model(cfg).forward(model, torch.from_numpy(toks),
                                               cfg)
    assert float(aux) == 0.0
    assert _rel(tl, jl) <= _forward_tol(quant)


def test_decode_matches_forward():
    """``tests/test_models.py``'s check on the port alone: prefill 8
    tokens, decode 4, against the full forward (err < 2e-3)."""
    _, cfg, _, model = _setup(None)
    api = torch_api.get_model(cfg)
    toks = torch.from_numpy(_tokens(cfg, 2, 16))
    full, _ = api.forward(model, toks, cfg)
    last, cache = api.prefill(model, toks[:, :8], cfg, 32,
                              cache_dtype=torch.float32)
    outs = [last]
    for t in range(8, 12):
        lg, cache = api.decode_step(model, cache, toks[:, t:t + 1], cfg)
        outs.append(lg)
    dec, ref = torch.cat(outs, 1), full[:, 7:12]
    err = float((dec - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert err < 2e-3, err


def test_flash_equals_dense(monkeypatch):
    """``tests/test_models.py``'s check: the chunked attend under the
    local mask against the dense one (err < 2e-4), and against the
    reference's chunked path."""
    jcfg, cfg, params, model = _setup(None)
    api = torch_api.get_model(cfg)
    toks = _tokens(cfg, 2, 40)
    ref, _ = api.forward(model, torch.from_numpy(toks), cfg)
    monkeypatch.setattr(L, "FLASH_THRESHOLD", 1)
    monkeypatch.setattr(jax_layers, "FLASH_THRESHOLD", 1)
    out, _ = api.forward(model, torch.from_numpy(toks), cfg)
    err = float((out - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert err < 2e-4, err
    jl, _ = _japi(jcfg, 1).forward(params, jnp.asarray(toks), jcfg)
    assert _rel(out, jl) <= _forward_tol(None)


def test_decode_step_takes_one_token_and_prefix_raises():
    _, cfg, _, model = _setup(None)
    api = torch_api.get_model(cfg)
    cache = api.init_cache(cfg, 1, 0, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="one token"):
        api.decode_step(model, cache, torch.zeros(1, 2, dtype=torch.int32),
                        cfg)
    with pytest.raises(NotImplementedError, match="prefix"):
        api.forward(model, torch.zeros(1, 3, dtype=torch.int32), cfg,
                    prefix_embeds=torch.zeros(1, 2, 64))


# ----------------------------------------------------------- serving --

LENS = (5, 12, 12, 30, 20)        # below, at and past the 16-position window
NEWS = (8, 6, 8, 24, 4)


def _requests(cfg, cls, stop=None):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                max_new_tokens=m, stop_token=stop)
            for i, (n, m) in enumerate(zip(LENS, NEWS))]


class _GapRecorder:
    """Wraps the server's contiguous entry points and records the
    smallest top-2 logit gap of the rows that sample a token."""

    def __init__(self, srv):
        self.min_gap, self.sampled = float("inf"), 0
        api = srv.api

        def prefill(*a, **kw):
            logits, cache = api.prefill(*a, **kw)
            self._note(logits)
            return logits, cache

        def decode_step(*a, **kw):
            logits, cache = api.decode_step(*a, **kw)
            self._note(logits)
            return logits, cache

        srv.api = dataclasses.replace(api, prefill=prefill,
                                      decode_step=decode_step)

    def _note(self, logits):
        top2 = logits[:, -1].topk(2, dim=-1).values
        self.min_gap = min(self.min_gap, float((top2[:, 0] - top2[:, 1]).min()))
        self.sampled += logits.shape[0]


@functools.lru_cache(maxsize=None)
def _reference_streams(quant, stop):
    jcfg, _, params, _ = _setup(None)
    srv = JaxServer(jcfg, params=params, quant_bits=quant, max_len=64)
    return srv.generate(_requests(jcfg, JaxRequest, stop))


@pytest.mark.parametrize("quant", [None, 7])
def test_generate_streams_equal_reference(quant):
    """``generate`` falls back to ``generate_bucketed`` on both sides
    (each server quantizing the same float weights when ``quant``)."""
    _, cfg, _, model = _setup(None)
    ref = _reference_streams(quant, None)
    srv = InferenceServer(cfg, params=model, quant_bits=quant, max_len=64,
                          device="cpu")
    rec = _GapRecorder(srv)
    out = srv.generate(_requests(cfg, Request))
    assert srv.last_engine is None                     # no Engine was built
    assert [c.uid for c in out] == [c.uid for c in ref]
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.status == "ok" and b.decode_steps == a.decode_steps
    assert rec.sampled >= sum(NEWS)
    assert rec.min_gap > 2 * _forward_tol(quant), rec.min_gap
    if quant:
        assert ll.quantized_fraction(srv.params.tree()) > 0.9


def test_generate_stop_token_equals_reference():
    _, cfg, _, model = _setup(None)
    plain = _reference_streams(None, None)
    stop = int(plain[3].tokens[5])
    ref = _reference_streams(None, stop)
    srv = InferenceServer(cfg, params=model, max_len=64, device="cpu")
    out = srv.generate(_requests(cfg, Request, stop))
    assert out[3].tokens[-1] == stop and len(out[3].tokens) <= 6
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)


def test_engine_refuses_the_hybrid():
    """The reference's ``test_unsupported_family_raises``: no paged path
    for the hybrid, so ``Engine`` raises ``ValueError`` (before it asks
    for a device)."""
    _, cfg = _cfgs()
    assert not Engine.supports(cfg)
    assert Engine.supports(get_config("qwen3-1.7b", tiny=True))
    with pytest.raises(ValueError, match="hybrid"):
        Engine(cfg)
    with pytest.raises(ValueError, match="hybrid"):
        Engine(cfg, device="cpu")
    api = torch_api.get_model(cfg)
    assert api.prefill_into_cache is None and api.decode_step_paged is None
    assert api.spec_verify_into_cache is None
    assert api.collect_act_calibration is None


def test_hybrid_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, cfg = _cfgs()
    for make in (lambda: tr.HybridLM(cfg), lambda: InferenceServer(cfg),
                 lambda: tr.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_not_ported_lists_the_other_families():
    """Nothing is left out: the port's registry is the reference's, in
    its order, and every architecture's configs equal the reference's."""
    from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
    from repro_torch.configs import ARCH_NAMES

    assert ARCH_NAMES == JAX_ARCH_NAMES and ARCH in ARCH_NAMES
    for name in ARCH_NAMES:
        for tiny in (False, True):
            want = dataclasses.asdict(jax_get_config(name, tiny=tiny))
            assert dataclasses.asdict(get_config(name, tiny=tiny)) == want


def _served(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    main()
    text = capsys.readouterr().out
    m = re.search(r"served (\d+) requests, (\d+) tokens", text)
    assert m, text
    return (int(m.group(1)), int(m.group(2))), text


def test_launcher_serves_the_hybrid(capsys, monkeypatch):
    """``--arch recurrentgemma-2b`` serves through ``generate``'s
    fallback, with the counts of the reference's bucketed launcher."""
    flags = ["--arch", ARCH, "--tiny", "--requests", "3", "--new-tokens",
             "5", "--quant", "7", "--prompt-len", "20"]
    ref, _ = _served(jserve.main, flags + ["--bucketed"], capsys, monkeypatch)
    got, text = _served(tserve.main, flags + ["--device", "cpu"], capsys,
                        monkeypatch)
    assert got == ref == (3, 15)
    assert "bucketed fallback" in text and "device: cpu" in text


@pytest.mark.parametrize("flags", [["--act-quant", "7"],
                                   ["--act-quant", "7", "--kv-codes"],
                                   ["--spec-k", "2"],
                                   ["--prefill-workers", "1",
                                    "--decode-workers", "1"]],
                         ids=["act-quant", "kv-codes", "spec-k", "cluster"])
def test_launcher_refuses_engine_flags_for_the_hybrid(flags, monkeypatch):
    """The Engine's flags raise ``ValueError`` for the hybrid in both
    launchers (the reference's from its Engine)."""
    argv = ["serve", "--arch", ARCH, "--tiny", "--requests", "1",
            "--new-tokens", "2", *flags]
    for main, extra in ((jserve.main, []), (tserve.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", argv + extra)
        with pytest.raises(ValueError):
            main()
