"""KV pages as codes: the port against the JAX package on the CPU.

``decode_heads``, ``encode_kv_codes`` and both codes attention ops (the
port's plain versions) against the reference's (its page-scan oracles,
which is what its ops run off-TPU); engines serving uint8 pages with the
reference's calibrated tables (converted by ``params_from_jax``); the
port's own chunk-size invariance and quantize-at-write.

Tolerances as in ``test_torch_act_quant.py``: uint8 code outputs may
differ in at most 1e-3 of the codes, each by one rounding step
(``eq.codes_agree``); logits of a model step within 1e-3 of their
scale.  Streams are held to the reference's codes-mode streams.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core import exponential_quant as jeq
from repro.core import lama_layers as jll
from repro.kernels._codes import decode_heads as jdecode_heads
from repro.kernels.decode_gqa import decode_gqa_paged_codes as jdecode_codes
from repro.kernels.flash_prefill import flash_prefill_paged_codes as jprefill_codes
from repro.models import api as jax_api
from repro.models import layers as JL
from repro.runtime import calibration as jcal
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import EngineConfig as JaxEngineConfig
from repro.runtime.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import exponential_quant as eq
from repro_torch.kernels._codes import decode_heads
from repro_torch.kernels.decode_gqa import decode_gqa_paged_codes
from repro_torch.kernels.flash_prefill import flash_prefill_paged_codes
from repro_torch.models import api as torch_api
from repro_torch.models import layers as L
from repro_torch.runtime.engine import Engine, EngineConfig, Request
from repro_torch.runtime.server import InferenceServer

TINY = dict(num_layers=2, d_model=64, d_ff=128, compute_dtype="float32")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _codes_close(out, ref):
    out, ref = _t(out), _t(ref)
    assert out.dtype == ref.dtype == torch.uint8
    assert out.shape == ref.shape
    assert bool(eq.codes_agree(out, ref).all())
    assert int((out != ref).sum()) <= 1e-3 * ref.numel()


def _head_tables(x):
    """Reference fit per head of ``x`` [..., n_kv, hd]: (qmeta [n_kv, 4],
    lut [n_kv, 256]) as numpy."""
    n_kv = x.shape[-2]
    rows = jnp.moveaxis(jnp.asarray(x), -2, 0).reshape(n_kv, -1)
    metas = jnp.stack([jeq.pack_qmeta(jeq.fit(rows[n], 7))
                       for n in range(n_kv)])
    return np.asarray(metas), np.asarray(jcal._luts_from_qmeta(metas))


def _tensor_table(x):
    qm = jeq.pack_qmeta(jeq.fit(jnp.asarray(x).reshape(-1), 7))
    return np.asarray(qm), np.asarray(jcal.lut_from_qmeta(qm))


# ------------------------------------------------------- per-head ops --

def test_decode_heads_matches_reference():
    rng = np.random.default_rng(0)
    lut = rng.normal(size=(3, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (2, 5, 3, 16)).astype(np.uint8)
    np.testing.assert_array_equal(decode_heads(_t(lut), _t(codes)).numpy(),
                                  np.asarray(jdecode_heads(lut, codes)))


def test_encode_kv_codes_matches_reference():
    """Quantize-at-write under per-head params broadcast as
    ``qmeta[:, None, :]`` against [B, S, n_kv, hd]."""
    rng = np.random.default_rng(1)
    k = (rng.normal(size=(2, 7, 2, 16)) * 0.7).astype(np.float32)
    v = (rng.normal(size=(2, 7, 2, 16)) * 0.3).astype(np.float32)
    (kq, kl), (vq, vl) = _head_tables(k), _head_tables(v)
    sites = {s: {"lut": l, "qmeta": q} for s, q, l in (
        ("attn_k", kq, kl), ("attn_v", vq, vl), ("attn_q", kq[0], kl[0]),
        ("attn_out", vq[0], vl[0]))}
    jk, jv = JL.encode_kv_codes(jnp.asarray(k), jnp.asarray(v),
                                {s: {n: jnp.asarray(a) for n, a in d.items()}
                                 for s, d in sites.items()})
    tk, tv = L.encode_kv_codes(_t(k), _t(v), {s: {n: _t(a) for n, a in d.items()}
                                              for s, d in sites.items()})
    _codes_close(tk, jk)
    _codes_close(tv, jv)
    with pytest.raises(ValueError, match="attn_q"):
        L.encode_kv_codes(_t(k), _t(v), {"attn_k": sites["attn_k"]})


def _paged(rng, g, bs):
    """uint8 pages with per-head tables and a q table, as numpy."""
    b, n_kv, hd, max_blk = 3, 2, 16, 6
    n = 1 + b * max_blk
    kp = (rng.normal(size=(n, bs, n_kv, hd)) * 0.3).astype(np.float32)
    vp = (rng.normal(size=(n, bs, n_kv, hd)) * 0.3).astype(np.float32)
    bt = rng.permutation(np.arange(1, n))[: b * max_blk].reshape(
        b, max_blk).astype(np.int32)
    (kq, kl), (vq, vl) = _head_tables(kp), _head_tables(vp)
    kc = np.asarray(jeq.encode_meta(jnp.asarray(kp), jnp.asarray(kq)[:, None]))
    vc = np.asarray(jeq.encode_meta(jnp.asarray(vp), jnp.asarray(vq)[:, None]))
    out_qm = np.asarray([0.02, 1e-4, 1.04, 7.0], np.float32)
    return b, n_kv, hd, kc, vc, bt, kl, vl, out_qm


@pytest.mark.parametrize("g,bs", [(1, 8), (2, 16)])
def test_prefill_codes_matches_reference(g, bs):
    rng = np.random.default_rng(10 * g + bs)
    b, n_kv, hd, kc, vc, bt, kl, vl, out_qm = _paged(rng, g, bs)
    s = 8
    q = (rng.normal(size=(b, s, n_kv, g, hd))).astype(np.float32)
    qq, ql = _tensor_table(q)
    qc = np.asarray(jeq.encode_meta(jnp.asarray(q), jnp.asarray(qq)))
    q_start = np.asarray([0, 5, 13], np.int32)
    kv_lens = np.asarray([8, 11, 0], np.int32)     # ragged; row 2 empty
    args = (qc, kc, vc, ql, kl, vl, out_qm, bt, q_start, kv_lens)
    ref = jprefill_codes(*map(jnp.asarray, args))
    out = flash_prefill_paged_codes(*map(_t, args))
    _codes_close(out, ref)


@pytest.mark.parametrize("g,bs", [(1, 16), (2, 8)])
def test_decode_codes_matches_reference(g, bs):
    rng = np.random.default_rng(20 * g + bs)
    b, n_kv, hd, kc, vc, bt, kl, vl, out_qm = _paged(rng, g, bs)
    q = (rng.normal(size=(b, n_kv, g, hd))).astype(np.float32)
    qq, ql = _tensor_table(q)
    qc = np.asarray(jeq.encode_meta(jnp.asarray(q), jnp.asarray(qq)))
    lengths = np.asarray([9, 6 * bs - 1, 0], np.int32)
    args = (qc, kc, vc, ql, kl, vl, out_qm, bt, lengths)
    ref = jdecode_codes(*map(jnp.asarray, args))
    out = decode_gqa_paged_codes(*map(_t, args))
    _codes_close(out, ref)


# ------------------------------------------------------------- engines --

def _cfgs():
    return (jax_get_config("qwen3-1.7b", tiny=True).replace(**TINY),
            get_config("qwen3-1.7b", tiny=True).replace(**TINY))


@functools.lru_cache(maxsize=None)
def _jax_act_params():
    """The reference's 7-bit weights with act-quant tables (per-head
    attn_k/attn_v included) from its own fit on its calibration
    samples (its default prompts: 4 x 32 ids from seed 0), attached as
    its ``Engine(act_quant=7)`` attaches them."""
    jcfg, _ = _cfgs()
    api = jax_api.get_model(jcfg)
    params = api.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    samples = api.collect_act_calibration(params, jnp.asarray(prompts), jcfg)
    act_q, _ = jcal.fit_sites(samples, 7)
    qparams, _ = jll.quantize_tree(params, 7, axes=api.logical_axes())
    return jcal.attach_act_quant(qparams, act_q)


def _to_port(jparams):
    _, cfg = _cfgs()
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                           device="cpu")


SCENARIOS = {
    # name: (lens, news, num_slots, block_size, max_len)
    "mixed_stream": ((8, 32, 128, 8, 32, 17), (6, 4, 8, 3, 12, 5), 3, 8, 140),
    "more_requests_than_slots": ((8,) * 6, (2, 2, 8, 2, 2, 2), 2, 8, 32),
}


def _requests(cfg, lens, news, cls):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, int(l)).astype(np.int32),
                max_new_tokens=int(n))
            for i, (l, n) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_kv_codes_streams_equal_reference(name):
    """uint8 KV pages under the reference's per-head tables: the port's
    engine gives the reference engine's streams, and the analytic
    attention counters equal the reference's."""
    lens, news, slots, bs, max_len = SCENARIOS[name]
    jcfg, cfg = _cfgs()
    jeng = JaxEngine(jcfg, params=_jax_act_params(), kv_codes=True,
                     engine=JaxEngineConfig(num_slots=slots, block_size=bs,
                                            max_seq_len=max_len,
                                            prefix_cache=False))
    ref = jeng.generate(_requests(jcfg, lens, news, JaxRequest))
    eng = Engine(cfg, params=_to_port(_jax_act_params()), kv_codes=True,
                 device="cpu", engine=EngineConfig(
                     num_slots=slots, block_size=bs, max_seq_len=max_len))
    assert eng.cache.k_pages.dtype == torch.uint8
    out = eng.generate(_requests(cfg, lens, news, Request))
    assert [c.uid for c in out] == [c.uid for c in ref]
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.status == "ok"
    assert (eng.attn_bytes_read, eng.attn_act_bytes, eng.attn_dequants) == (
        jeng.attn_bytes_read, jeng.attn_act_bytes, jeng.attn_dequants)
    assert eng.attn_dequants > 0


def test_step_logits_close_to_reference():
    """One prefill chunk and one decode step over uint8 pages: logits
    within 1e-3 of their scale (a code flipped at a rounding boundary
    moves one activation or one K/V element by a quantization step), and
    the written pages agree as codes."""
    from repro.runtime.paged_cache import PagedKVCache as JaxCache
    from repro_torch.runtime.paged_cache import PagedKVCache as TorchCache

    jcfg, cfg = _cfgs()
    jparams = _jax_act_params()
    model = _to_port(jparams)
    japi, tapi = jax_api.get_model(jcfg), torch_api.get_model(cfg)
    kw = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, num_slots=2, block_size=8,
              num_blocks=12, max_blocks_per_seq=5)
    jc = JaxCache(**kw, dtype=jnp.uint8)
    tc = TorchCache(**kw, dtype=torch.uint8, device="cpu")
    prompts = [p.prompt for p in _requests(cfg, (13, 21), (1, 1), Request)]
    toks = np.zeros((2, 24), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        for c in (jc, tc):
            c.bind_slot(i, len(p), reserved=False)
    jl, jv = japi.prefill_into_cache(jparams, jnp.asarray(toks), jc.view(),
                                     jcfg)
    tl, tv = tapi.prefill_into_cache(model, torch.from_numpy(toks), tc.view(),
                                     cfg)
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-3 * scale)
    _codes_close(tv.k_pages[:, 1:], np.asarray(jv.k_pages)[:, 1:])
    _codes_close(tv.v_pages[:, 1:], np.asarray(jv.v_pages)[:, 1:])
    jc.k_pages, jc.v_pages = jv.k_pages, jv.v_pages
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for c in (jc, tc):
        for i in range(2):
            c.ensure_capacity(i, reserved=False)
    jl, _ = japi.decode_step_paged(jparams, jc.view(), jnp.asarray(nxt),
                                   jnp.asarray([True, True]), jcfg)
    tl, _ = tapi.decode_step_paged(model, tc.view(), torch.from_numpy(nxt),
                                   torch.tensor([True, True]), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-3 * scale)


def test_chunked_equals_unchunked_in_codes_mode():
    """On the port's own side, 8-token chunks interleaved with running
    decodes give the whole-prompt chunks' tokens over uint8 pages."""
    _, cfg = _cfgs()
    params = _to_port(_jax_act_params())
    lens, news = (8, 32, 128, 17), (6, 4, 8, 5)
    outs = []
    for chunk in (256, 8):
        eng = Engine(cfg, params=params, kv_codes=True, device="cpu",
                     engine=EngineConfig(num_slots=3, block_size=8,
                                         max_seq_len=192, prefill_chunk=chunk))
        outs.append(eng.generate(_requests(cfg, lens, news, Request)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_pages_hold_encoded_kv():
    """Quantize-at-write: a uint8 page holds ``encode_kv_codes`` of the
    K/V written there (layer 0 is a function of the prompt alone), and
    every layer's K decodes close to the float32-KV engine's pages."""
    _, cfg = _cfgs()
    params = _to_port(_jax_act_params())
    ec = EngineConfig(num_slots=2, block_size=8, max_seq_len=64)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               13).astype(np.int32)
    fp = Engine(cfg, params=params, engine=ec, device="cpu")
    codes = Engine(cfg, params=params, kv_codes=True, engine=ec, device="cpu")
    for eng in (fp, codes):           # pages are released at retirement
        eng.submit(Request(0, prompt, max_new_tokens=4))
        eng.step()
    lp = params.layer(0)
    aq = lp["act_q"]
    x = L.embed_tokens(params["embed"], torch.from_numpy(prompt)[None], cfg)
    h = L.apply_norm(lp["ln1"], x, cfg)
    pos = torch.arange(len(prompt))[None]
    k, v = L.self_kv(lp["attn"], h, cfg, pos, act_q=aq)
    kc, vc = L.encode_kv_codes(k, v, aq)
    pages = torch.from_numpy(codes.cache.block_tables[0, :2].astype(np.int64))
    got_k = codes.cache.k_pages[0, pages].reshape(16, *kc.shape[2:])[:13]
    got_v = codes.cache.v_pages[0, pages].reshape(16, *vc.shape[2:])[:13]
    torch.testing.assert_close(got_k, kc[0], rtol=0, atol=0)
    torch.testing.assert_close(got_v, vc[0], rtol=0, atol=0)
    fpages = torch.from_numpy(fp.cache.block_tables[0, :2].astype(np.int64))
    for layer in range(cfg.num_layers):
        q = params.layer(layer)["act_q"]["attn_k"]["qmeta"]
        dec = eq.decode_meta(codes.cache.k_pages[layer, pages], q[:, None, :])
        ref = fp.cache.k_pages[layer, fpages]
        tol = 0.06 * float(ref.abs().max()) + 0.05
        assert float((dec.reshape(16, -1)[:13] - ref.reshape(16, -1)[:13])
                     .abs().max()) < tol
    for eng in (fp, codes):
        eng.run()


def test_server_serves_kv_codes(tmp_path, monkeypatch):
    """Takes the place of the removed ``kv_codes=True`` case of
    ``test_unported_serving_options_raise``: ``InferenceServer(act_quant=7,
    kv_codes=True)`` builds a calibrated codes-mode engine and serves."""
    monkeypatch.setenv("REPRO_ACT_CALIB_CACHE", str(tmp_path / "calib.json"))
    _, cfg = _cfgs()
    srv = InferenceServer(cfg, params=_to_port(_jax_act_params()),
                          act_quant=7, kv_codes=True, max_len=48,
                          num_slots=2, device="cpu")
    out = srv.generate([Request(0, np.arange(12, dtype=np.int32) % 64,
                                max_new_tokens=4)])
    assert out[0].status == "ok" and out[0].tokens.size == 4
    eng = srv.last_engine
    assert eng.kv_codes and eng.cache.k_pages.dtype == torch.uint8
    assert eng.cache.nbytes * 4 == (2 * cfg.num_layers * eng.cache.k_pages[0]
                                    .numel() * 4)
    assert set(eng.act_report) == set(L.ACT_SITES)
    with pytest.raises(ValueError, match="act_quant"):
        InferenceServer(cfg, kv_codes=True, device="cpu")
