"""The port's encdec family (``repro_torch.models.encdec``,
seamless-m4t-medium) against the JAX package's ``models/encdec.py``, on
the CPU, at the reference's tiny size (2 encoder and 2 decoder layers,
d_model 64, 4 heads of 16, d_ff 128, parametric LayerNorm, gelu, untied)
with float32 compute.

Both sides hold the same weights: the reference's (seed 0), converted by
``params_from_jax``; with 7-bit codes, fit by the port on those weights
and handed to the reference as its ``{codes, lut, qmeta}`` leaves (the
reference's own fit takes ~10 s to compile at this size).  Tolerances,
relative to the larger of 1 and the reference's largest magnitude:
logits, encoder states and the caches' K/V within 1e-4 (float32 end to
end; the reference's quantized matmuls run its interpret-mode kernel,
the port's its plain version; the encoder's LayerNorms over the 0.02-
scale stub frames amplify float32 rounding to ~3e-5), the frames byte
for byte, token streams equal.
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
from repro.models import api as jax_api
from repro.models import encdec as je
from repro.runtime.engine import Request as JaxRequest
from repro.runtime.server import InferenceServer as JaxServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import lama_layers as ll
from repro_torch.core.exponential_quant import QWeight
from repro_torch.models import api as torch_api
from repro_torch.models import encdec as te
from repro_torch.models import layers as L
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.server import InferenceServer, Request
from repro_torch.runtime.step_graph import StepGraph

ARCH = "seamless-m4t-medium"
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jax_get_config(ARCH, tiny=True).replace(compute_dtype="float32"),
            get_config(ARCH, tiny=True).replace(compute_dtype="float32"))


def _jax_tree(node):
    """The reference's params tree holding a port tree's values
    (``QWeight`` leaves as its ``{codes, lut, qmeta}`` dicts)."""
    if isinstance(node, QWeight):
        return {k: jnp.asarray(getattr(node, k).numpy())
                for k in ("codes", "lut", "qmeta")}
    if isinstance(node, dict):
        return {k: _jax_tree(v) for k, v in node.items()}
    return jnp.asarray(node.numpy())


@functools.lru_cache(maxsize=None)
def _setup(quant):
    """(jcfg, cfg, the reference's params, the port's module holding
    them): the reference's weights (seed 0); with ``quant`` bits, their
    codes as the port fits them."""
    jcfg, cfg = _cfgs()
    params = jax_api.get_model(jcfg).init(jax.random.PRNGKey(0),
                                          dtype=jnp.float32)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    if quant is not None:
        qtree, _ = ll.quantize_tree(
            model.tree(), quant, axes=torch_api.get_model(cfg).logical_axes())
        params = _jax_tree(qtree)
        model = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                cfg, device="cpu")
    return jcfg, cfg, params, model


@functools.lru_cache(maxsize=None)
def _japi(jcfg, flash_threshold=None):
    """The reference's entry points, jitted (a trace reads
    ``FLASH_THRESHOLD`` once, so each value gets its own)."""
    del flash_threshold
    japi = jax_api.get_model(jcfg)

    class API:
        encode = staticmethod(jax.jit(je.encode, static_argnums=(2,)))
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


def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _frames(b, s, seed=4):
    return (np.random.default_rng(seed).normal(size=(b, s, 64)) * 0.02
            ).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ------------------------------------------------------- the weights --

@pytest.mark.parametrize("quant", [None, 7])
def test_params_from_jax_round_trip_exact(quant):
    """``enc_in``, the stacked ``enc_blocks`` / ``dec_blocks`` (with
    ``lnx`` / ``xattn``), the LayerNorm biases, ``enc_ln_f``, ``ln_f`` and
    the untied ``unembed.out`` carry byte for byte; with codes every
    projection, ``enc_in`` and ``unembed.out`` are ``QWeight``\\ s."""
    _, cfg, params, model = _setup(quant)
    assert isinstance(model, te.EncDecLM)
    ref = _flat(params)
    got = {k: v.numpy() for k, v in model.named_buffers()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for name in ("enc_ln_f.bias", "ln_f.bias", "enc_blocks.ln1.bias",
                 "dec_blocks.lnx.scale", "dec_blocks.lnx.bias"):
        assert name in got, name
    assert set(model.enc_layer(1)) == {"ln1", "attn", "ln2", "mlp"}
    assert set(model.dec_layer(1)) == {"ln1", "attn", "lnx", "xattn", "ln2",
                                       "mlp"}
    if quant:
        tree = model.tree()
        for w in (tree["enc_in"], tree["unembed"]["out"],
                  model.dec_layer(0)["xattn"]["wq"],
                  model.enc_layer(1)["mlp"]["w_down"]):
            assert isinstance(w, QWeight)
        assert tree["enc_in"].lut.ndim == 1
    else:
        assert "unembed.out" in got and "enc_in" in got


def test_quantize_tree_quantizes_the_reference_leaves():
    """The port's predicate picks the reference's leaves: every ``w*`` of
    both stacks, ``enc_in``, the embedding table and ``unembed.out``; no
    norm."""
    _, cfg, jparams, model = _setup(None)
    _, trep = ll.quantize_tree(model.tree(), 7,
                               axes=torch_api.get_model(cfg).logical_axes())
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jpaths = {tuple(k.key for k in path) for path, leaf in flat
              if jll.default_predicate(tuple(k.key for k in path), leaf)}
    assert set(trep) == jpaths
    for p in (("enc_in",), ("dec_blocks", "xattn", "wk"),
              ("unembed", "out"), ("enc_blocks", "mlp", "w_up")):
        assert p in trep, p
    assert not any("ln" in p[-2] for p in trep if len(p) > 1)


def test_specs_match_reference():
    jcfg, cfg = _cfgs()

    def shapes(specs):
        return {k: (shapes(v) if isinstance(v, dict) else
                    (tuple(v.shape), tuple(v.axes), v.init))
                for k, v in specs.items()}

    assert shapes(te.model_specs(cfg)) == shapes(je.model_specs(jcfg))


# ------------------------------------------------------ the entry points --

@pytest.mark.parametrize("quant", [None, 7])
def test_encode_matches_reference(quant):
    jcfg, cfg, params, model = _setup(quant)
    fr = _frames(2, 11)
    jo = _japi(jcfg).encode(params, jnp.asarray(fr), jcfg)
    to = te.encode(model, torch.from_numpy(fr), cfg)
    assert _rel(to, jo) <= TOL


@pytest.mark.parametrize("quant", [None, 7])
def test_forward_matches_reference(quant):
    """The decoder's logits only: [B, S, V] for S tokens after S_enc
    frames of another length."""
    jcfg, cfg, params, model = _setup(quant)
    toks, fr = _tokens(cfg, 2, 12), _frames(2, 9)
    jl, _ = _japi(jcfg).forward(params, jnp.asarray(toks), jcfg,
                                prefix_embeds=jnp.asarray(fr))
    tl, aux = torch_api.get_model(cfg).forward(
        model, torch.from_numpy(toks), cfg,
        prefix_embeds=torch.from_numpy(fr))
    assert tl.shape == (2, 12, cfg.vocab_size) and float(aux) == 0.0
    assert _rel(tl, jl) <= TOL


def test_forward_needs_frames():
    _, cfg, _, model = _setup(None)
    with pytest.raises(ValueError, match="frame embeddings"):
        te.forward(model, torch.from_numpy(_tokens(cfg, 1, 4)), cfg)


@pytest.mark.parametrize("quant,cache_dtype", [(None, "float32"),
                                               (7, "float32"),
                                               (None, "bfloat16")])
def test_prefill_and_decode_match_reference(quant, cache_dtype):
    """Prefill 10 tokens after 13 frames into a 24-position cache, then 8
    decode steps: logits, the self K/V (the written positions, the rest
    zero) and the cross K/V after the prefill and after the steps."""
    jcfg, cfg, params, model = _setup(quant)
    japi, tapi = _japi(jcfg), torch_api.get_model(cfg)
    toks, fr = _tokens(cfg, 2, 18), _frames(2, 13)
    jdt, tdt = jnp.dtype(cache_dtype), getattr(torch, cache_dtype)
    jl, jc = japi.prefill(params, jnp.asarray(toks[:, :10]), jcfg, 24,
                          prefix_embeds=jnp.asarray(fr), cache_dtype=jdt)
    tl, tc = tapi.prefill(model, torch.from_numpy(toks[:, :10]), cfg, 24,
                          prefix_embeds=torch.from_numpy(fr),
                          cache_dtype=tdt)
    assert tl.shape == (2, 1, cfg.vocab_size) and tc["pos"] == 10
    assert tc["k"].shape == (2, 2, 24, 4, 16)
    assert tc["xk"].shape == (2, 2, 13, 4, 16) and tc["xk"].dtype == tdt
    # bfloat16 caches hold values rounded once: allow one rounding step
    kv_tol = TOL if cache_dtype == "float32" else 2 ** -7
    assert _rel(tl, jl) <= TOL
    for k in ("k", "v", "xk", "xv"):
        assert _rel(tc[k], jc[k]) <= kv_tol, k
    for t in range(10, 18):
        jl, jc = japi.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jcfg)
        tl, tc = tapi.decode_step(model, tc, torch.from_numpy(toks[:, t:t + 1]),
                                  cfg)
        assert _rel(tl, jl) <= (TOL if cache_dtype == "float32" else 1e-2), t
    assert tc["pos"] == int(jc["pos"]) == 18
    for k in ("k", "v", "xk", "xv"):
        assert _rel(tc[k], jc[k]) <= kv_tol, k
    written = tc["k"].float().abs().sum(dim=(0, 1, 3, 4))
    assert bool((written[:18] > 0).all()) and bool((written[18:] == 0).all())


def test_decode_matches_forward():
    """``tests/test_models.py``'s check on the port alone: prefill 8
    tokens, decode 4, against the full forward (err < 2e-3)."""
    _, cfg, _, model = _setup(None)
    api = torch_api.get_model(cfg)
    toks = torch.from_numpy(_tokens(cfg, 2, 16))
    fr = torch.from_numpy(_frames(2, 16))
    full, _ = api.forward(model, toks, cfg, prefix_embeds=fr)
    last, cache = api.prefill(model, toks[:, :8], cfg, 32, prefix_embeds=fr,
                              cache_dtype=torch.float32)
    outs = [last]
    for t in range(8, 12):
        lg, cache = api.decode_step(model, cache, toks[:, t:t + 1], cfg)
        outs.append(lg)
    dec, ref = torch.cat(outs, 1), full[:, 7:12]
    err = float((dec - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert err < 2e-3, err


def test_flash_equals_dense(monkeypatch):
    """The reference's ``test_flash_equals_dense`` on seamless: every
    mask descriptor (the encoder's full, the decoder's causal, the
    cross-attention's full) through the chunked online-softmax attend,
    within 2e-4 of the dense one, and the port's chunked forward against
    the reference's chunked forward within TOL."""
    jcfg, cfg, params, model = _setup(None)
    toks, fr = _tokens(cfg, 2, 16), _frames(2, 16)
    api = torch_api.get_model(cfg)
    dense, _ = api.forward(model, torch.from_numpy(toks), cfg,
                           prefix_embeds=torch.from_numpy(fr))
    monkeypatch.setattr(L, "FLASH_THRESHOLD", 1)
    monkeypatch.setattr(jax_layers, "FLASH_THRESHOLD", 1)
    flash, _ = api.forward(model, torch.from_numpy(toks), cfg,
                           prefix_embeds=torch.from_numpy(fr))
    err = float((flash - dense).abs().max() / (dense.abs().max() + 1e-9))
    assert err < 2e-4, err
    jl, _ = _japi(jcfg, 1).forward(params, jnp.asarray(toks), jcfg,
                                   prefix_embeds=jnp.asarray(fr))
    assert _rel(flash, jl) <= TOL


def test_decode_step_through_a_step_graph_equals_the_int_step():
    """The bucketed server's step: a 0-d tensor ``pos`` advanced on the
    device, the self K/V written in place with ``index_copy_``, run
    through ``StepGraph``; its logits and caches equal those of
    ``decode_step`` with an int ``pos`` on a copy of the same cache, step
    for step (the mask built from the tensor)."""
    _, cfg, _, model = _setup(7)
    api = torch_api.get_model(cfg)
    toks = torch.from_numpy(_tokens(cfg, 2, 14))
    fr = torch.from_numpy(_frames(2, 6))
    _, cache = api.prefill(model, toks[:, :6], cfg, 16, prefix_embeds=fr,
                           cache_dtype=torch.bfloat16)
    plain = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in cache.items()}
    pos = torch.full((), 6, dtype=torch.int64)
    cache["pos"] = pos
    cur = toks[:, 6:7].clone()
    got = []

    def step(_inputs):
        logits, _ = api.decode_step(model, cache, cur, cfg)
        got.append(logits)
        pos.add_(1)

    run = StepGraph({}, "cpu")
    for t in range(6, 14):
        cur.copy_(toks[:, t:t + 1])
        run.step(step)
        want, plain = api.decode_step(model, plain, toks[:, t:t + 1], cfg)
        torch.testing.assert_close(got[-1], want, rtol=0, atol=0)
        for k in ("k", "v", "xk", "xv"):
            assert torch.equal(cache[k], plain[k]), (t, k)
    assert int(pos) == plain["pos"] == 14


def test_int_pos_past_the_cache_raises():
    _, cfg, _, model = _setup(None)
    api = torch_api.get_model(cfg)
    toks = torch.from_numpy(_tokens(cfg, 1, 5))
    _, cache = api.prefill(model, toks[:, :4], cfg, 4,
                           prefix_embeds=torch.from_numpy(_frames(1, 4)))
    with pytest.raises(ValueError, match="cache full"):
        api.decode_step(model, cache, toks[:, 4:5], cfg)


# ----------------------------------------------------------- serving --

LENS = (5, 12, 12, 30, 20)
NEWS = (8, 6, 8, 10, 4)
MAX_LEN = 40


def _requests(cfg, cls, lens=LENS, news=NEWS, stop=None):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                max_new_tokens=m, stop_token=stop)
            for i, (n, m) in enumerate(zip(lens, news))]


def test_frames_for_equals_the_reference_byte_for_byte():
    """``seq`` frames a row (the prompt's length), the reference's bytes."""
    jcfg, cfg, params, model = _setup(None)
    ref = JaxServer(jcfg, params=params, max_len=MAX_LEN)
    srv = InferenceServer(cfg, params=model, max_len=MAX_LEN, device="cpu")
    for b, s in ((1, 5), (3, 17)):
        got = srv._frames_for(b, s)
        want = np.asarray(ref._frames_for(b, s))
        assert got.shape == (b, s, cfg.d_model) and got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()
        assert srv._start(s, got) == s


@pytest.mark.parametrize("quant", [None, 7])
def test_generate_streams_equal_reference(quant):
    """``generate`` falls back to ``generate_bucketed`` on both sides;
    the port's ``generate`` and ``generate_bucketed`` streams equal the
    reference server's, with and without a stop token (one the streams
    hit), and no Engine is built."""
    jcfg, cfg, params, model = _setup(quant)
    srv = InferenceServer(cfg, params=model, max_len=MAX_LEN, device="cpu")
    jsrv = JaxServer(jcfg, params=params, max_len=MAX_LEN)
    ref = jsrv.generate(_requests(jcfg, JaxRequest))
    stop = int(ref[3].tokens[4])
    for s in (None, stop):
        if s is not None:
            ref = jsrv.generate(_requests(jcfg, JaxRequest, stop=s))
            assert len(ref[3].tokens) == 5
        for run in (srv.generate, srv.generate_bucketed):
            out = run(_requests(cfg, Request, stop=s))
            assert [c.uid for c in out] == [c.uid for c in ref]
            for a, b in zip(ref, out):
                np.testing.assert_array_equal(b.tokens, a.tokens)
                assert b.status == "ok" and b.decode_steps == a.decode_steps
    assert srv.last_engine is None


def test_cache_full_counts_the_prompt_not_the_frames():
    """The self-attention cache holds the prompt and the new tokens, not
    the frames: ``plen + new - 1 <= max_len`` serves, one more raises
    before the prefill."""
    _, cfg, _, model = _setup(None)
    srv = InferenceServer(cfg, params=model, max_len=20, device="cpu")
    ok = srv.generate(_requests(cfg, Request, lens=(12,), news=(9,)))
    assert len(ok[0].tokens) == 9
    with pytest.raises(ValueError, match="cache full"):
        srv.generate(_requests(cfg, Request, lens=(12,), news=(10,)))


def test_get_model_takes_encdec_and_the_engine_refuses_it():
    """``family="encdec"`` is taken whatever the frontend, as the
    reference's ``get_model`` takes it; the paged entry points are None
    and the Engine refuses the family."""
    _, cfg = _cfgs()
    for c in (cfg, cfg.replace(frontend=None)):
        api = torch_api.get_model(c)
        assert api.module is te.EncDecLM and api.forward is te.forward
        assert api.prefill_into_cache is None
        assert api.decode_step_paged is None
        assert api.spec_verify_into_cache is None
        assert api.collect_act_calibration is None
    assert not Engine.supports(cfg)
    with pytest.raises(ValueError, match="frontend"):
        Engine(cfg, device="cpu")


def test_encdec_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, cfg = _cfgs()
    for make in (lambda: te.EncDecLM(cfg), lambda: InferenceServer(cfg),
                 lambda: te.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()

