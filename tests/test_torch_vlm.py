"""The port's vlm family (paligemma-3b: the decoder's entry points behind a
stub patch frontend) against the JAX package's, on the CPU, at the
reference's tiny size (2 layers, d_model 64, 2 / 1 heads of 32, 8 patch
positions) with float32 compute.

Both sides hold the same weights: the reference's (seed 0), converted by
``params_from_jax``; with 7-bit codes, fit by the port on those weights
and handed to the reference as its ``{codes, lut, qmeta}`` leaves (the
reference's own fit takes ~10 s to compile at this size;
``tests/test_torch_quant.py`` holds the two fits together).  The patch
embeddings come before the tokens under the prefix-LM mask (full within
the prefix, causal after), at positions ``0 .. P + S - 1``; the cache
holds their K/V and decoding starts at ``pos = P + S``.  Tolerances:
logits within 1e-4 of their scale (float32 end to end; the reference's
quantized matmuls run its interpret-mode kernel, the port's its plain
version), the cache's K/V within 1e-5, the patch frames byte for byte,
token streams equal.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
from repro.configs import get_config as jax_get_config
from repro.models import api as jax_api
from repro.runtime.engine import Request as JaxRequest
from repro.runtime.server import InferenceServer as JaxServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import lama_layers as ll
from repro_torch.core.exponential_quant import QWeight
from repro_torch.models import api as torch_api
from repro_torch.models import layers as L
from repro_torch.models.transformer import DecoderLM
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.server import InferenceServer, Request

ARCH = "paligemma-3b"
LOGITS_TOL = 1e-4
KV_TOL = 1e-5


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


@pytest.fixture
def flash_threshold_low(monkeypatch):
    """Both sides' ``mha`` take the chunked online-softmax path
    (``_attend_flash``) for every mask descriptor."""
    monkeypatch.setattr(jax_layers, "FLASH_THRESHOLD", 1)
    monkeypatch.setattr(L, "FLASH_THRESHOLD", 1)


def _rel(port, ref) -> float:
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy()
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(1.0, np.abs(ref).max()))


def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _frames(cfg, b, seed=0):
    return (np.random.default_rng(seed).normal(
        size=(b, cfg.num_prefix_tokens, cfg.d_model)) * 0.02
    ).astype(np.float32)


# ------------------------------------------------------- the weights --

def test_params_from_jax_carries_the_vlm_tree():
    """The vlm's tree is the decoder's: a ``DecoderLM`` holding every
    leaf byte for byte, the tied table as codes when quantized."""
    _, cfg, params, model = _setup(7)
    assert type(model) is DecoderLM
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    ref = {".".join(k.key for k in path): np.asarray(v) for path, v in flat}
    got = {k: v.numpy() for k, v in model.named_buffers()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert "embed.tokens.codes" in got and "unembed.out" not in got
    assert isinstance(model.layer(1)["mlp"]["w_gate"], QWeight)


# -------------------------------------------------------- the prefix --

def test_prefix_mask_is_full_within_the_prefix_and_causal_after():
    """The mask equals the reference's; a prefix position's output moves
    with a LATER prefix position, and no position moves with a later
    text token."""
    cfg = _cfgs()[1]
    p = cfg.num_prefix_tokens
    qp, kp = np.arange(p + 6), np.arange(p + 6)
    ref = np.asarray(jax_layers._block_mask("prefix", p, jnp.asarray(qp),
                                            jnp.asarray(kp)))
    got = L._block_mask("prefix", p, torch.from_numpy(qp),
                        torch.from_numpy(kp)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, p - 1] and not got[p, p + 1]
    _, cfg, _, model = _setup(None)
    fwd = torch_api.get_model(cfg).forward
    toks = torch.from_numpy(_tokens(cfg, 1, 6))
    pe = torch.from_numpy(_frames(cfg, 1))
    base, _ = fwd(model, toks, cfg, prefix_embeds=pe)
    pe2 = pe.clone()
    pe2[:, p - 1] += 0.5
    moved, _ = fwd(model, toks, cfg, prefix_embeds=pe2)
    assert (moved[0, 0] - base[0, 0]).abs().max() > 1e-3
    toks2 = toks.clone()
    toks2[0, 3] = (toks2[0, 3] + 1) % cfg.vocab_size
    later, _ = fwd(model, toks2, cfg, prefix_embeds=pe)
    torch.testing.assert_close(later[0, :p + 3], base[0, :p + 3], rtol=0,
                               atol=0)
    assert (later[0, p + 3] - base[0, p + 3]).abs().max() > 1e-3


def test_chunked_prefix_attend_equals_dense():
    """The chunked online-softmax attend under the prefix mask, with the
    prefix boundary inside a chunk, against the dense attend."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 21, 1, 2, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 21, 1, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 21, 1, 32)).astype(np.float32))
    dense = L._attend_dense(q, k, v, L._materialize_mask(
        "prefix", 11, 21, 21, 0, "cpu"), torch.float32)
    chunked = L._attend_flash(q, k, v, "prefix", 11, 0, torch.float32,
                              q_chunk=4, k_chunk=8)
    torch.testing.assert_close(chunked, dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", [None, 7])
@pytest.mark.parametrize("flash", [False, True])
def test_forward_with_prefix_matches_reference(quant, flash, request):
    """Logits at all ``P + S`` positions, the dense mask and (under a
    lowered ``FLASH_THRESHOLD``) the chunked attend."""
    if flash:
        request.getfixturevalue("flash_threshold_low")
    jcfg, cfg, params, model = _setup(quant)
    toks, pe = _tokens(cfg, 2, 12), _frames(cfg, 2)
    jl, _ = _japi(jcfg, jax_layers.FLASH_THRESHOLD).forward(
        params, jnp.asarray(toks), jcfg, jnp.asarray(pe))
    tl, aux = torch_api.get_model(cfg).forward(
        model, torch.from_numpy(toks), cfg, prefix_embeds=torch.from_numpy(pe))
    assert tl.shape == (2, cfg.num_prefix_tokens + 12, cfg.vocab_size)
    assert float(aux) == 0.0
    assert _rel(tl, jl) <= LOGITS_TOL


@pytest.mark.parametrize("quant,flash", [(None, False), (7, False),
                                         (None, True)])
def test_prefill_and_decode_match_reference(quant, flash, request):
    """Prefill the patches and 10 tokens, then 8 decode steps through
    #9's plain version: logits every step, the cache's K/V over the
    prefix and the text, ``pos = P + S``."""
    if flash:
        request.getfixturevalue("flash_threshold_low")
    jcfg, cfg, params, model = _setup(quant)
    japi, tapi = _japi(jcfg, jax_layers.FLASH_THRESHOLD), torch_api.get_model(cfg)
    p = cfg.num_prefix_tokens
    toks, pe = _tokens(cfg, 2, 18), _frames(cfg, 2)
    jl, jc = japi.prefill(params, jnp.asarray(toks[:, :10]), jcfg, 40,
                          jnp.asarray(pe), cache_dtype=jnp.float32)
    tl, tc = tapi.prefill(model, torch.from_numpy(toks[:, :10]), cfg, 40,
                          prefix_embeds=torch.from_numpy(pe),
                          cache_dtype=torch.float32)
    assert tc["pos"] == int(jc["pos"]) == p + 10
    assert _rel(tl, jl) <= LOGITS_TOL
    assert _rel(tc["k"], jc["k"]) <= KV_TOL and _rel(tc["v"], jc["v"]) <= KV_TOL
    for t in range(10, 18):
        jl, jc = japi.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jcfg)
        tl, tc = tapi.decode_step(model, tc, torch.from_numpy(toks[:, t:t + 1]),
                                  cfg)
        assert _rel(tl, jl) <= LOGITS_TOL, t
    assert tc["pos"] == int(jc["pos"]) == p + 18
    assert _rel(tc["k"], jc["k"]) <= KV_TOL
    written = tc["k"].abs().sum(dim=(0, 1, 3, 4))
    assert bool((written[:p + 18] > 0).all())
    assert bool((written[p + 18:] == 0).all())


# ----------------------------------------------------------- serving --

LENS = (5, 12, 12, 30, 20)
NEWS = (8, 6, 8, 10, 4)
MAX_LEN = 64


def _requests(cfg, cls, lens=LENS, news=NEWS):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


def test_frames_for_equals_the_reference_byte_for_byte():
    jcfg, cfg, params, model = _setup(None)
    ref = JaxServer(jcfg, params=params, max_len=MAX_LEN)
    srv = InferenceServer(cfg, params=model, max_len=MAX_LEN, device="cpu")
    for b, s in ((1, 5), (3, 17)):
        got = srv._frames_for(b, s)
        want = np.asarray(ref._frames_for(b, s))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert got.numpy().tobytes() == want.tobytes()
    nof = InferenceServer(get_config("qwen3-1.7b", tiny=True), device="cpu")
    assert nof._frames_for(2, 4) is None


class _Prefills:
    """Counts the server's prefill calls and checks each gets the
    patches."""

    def __init__(self, srv):
        self.calls = 0
        api = srv.api

        def prefill(*a, prefix_embeds=None, **kw):
            self.calls += 1
            assert prefix_embeds is not None
            return api.prefill(*a, prefix_embeds=prefix_embeds, **kw)

        srv.api = dataclasses.replace(api, prefill=prefill)


def test_generate_streams_equal_reference():
    """7-bit weights: ``generate`` falls back to ``generate_bucketed`` on
    both sides, and the port's ``generate`` and ``generate_bucketed``
    streams equal the reference server's; one prefill a bucket, each
    with the patches, and no Engine built."""
    jcfg, cfg, params, model = _setup(7)
    ref = JaxServer(jcfg, params=params, max_len=MAX_LEN).generate(
        _requests(jcfg, JaxRequest))
    srv = InferenceServer(cfg, params=model, max_len=MAX_LEN, device="cpu")
    seen = _Prefills(srv)
    for run in (srv.generate, srv.generate_bucketed):
        out = run(_requests(cfg, Request))
        assert [c.uid for c in out] == [c.uid for c in ref]
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(b.tokens, a.tokens)
            assert b.status == "ok" and b.decode_steps == a.decode_steps
    assert srv.last_engine is None
    assert seen.calls == 2 * len(set(LENS))


def test_cache_full_counts_the_prefix():
    """A bucket whose last decode position ``P + plen + new - 1`` passes
    ``max_len`` raises before its prefill; one that just fits serves."""
    _, cfg, _, model = _setup(None)
    p = cfg.num_prefix_tokens
    srv = InferenceServer(cfg, params=model, max_len=p + 20, device="cpu")
    seen = _Prefills(srv)
    ok = srv.generate(_requests(cfg, Request, lens=(12,), news=(9,)))
    assert len(ok[0].tokens) == 9 and seen.calls == 1
    with pytest.raises(ValueError, match="cache full"):
        srv.generate(_requests(cfg, Request, lens=(12,), news=(10,)))
    assert seen.calls == 1


def test_get_model_takes_the_vlm_and_the_engine_refuses_it():
    jcfg, cfg = _cfgs()
    api = torch_api.get_model(cfg)
    assert api.module is DecoderLM and api.forward is torch_api.get_model(
        get_config("qwen3-1.7b", tiny=True)).forward
    assert not Engine.supports(cfg)
    with pytest.raises(ValueError, match="frontend"):
        Engine(cfg, device="cpu")
    for bad in (cfg.replace(frontend="audio"),
                get_config("qwen3-1.7b", tiny=True).replace(frontend="patch")):
        with pytest.raises(NotImplementedError, match="item 13"):
            torch_api.get_model(bad)


def test_vlm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, cfg = _cfgs()
    for make in (lambda: DecoderLM(cfg), lambda: InferenceServer(cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
