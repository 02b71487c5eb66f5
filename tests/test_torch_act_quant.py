"""Activations as codes: the port against the JAX package on the CPU.

The dual and dual-gated matmuls (plain versions here) against the
reference's ops (its Pallas kernels in interpret mode); the ``QTensor``
dispatch of ``lama_layers``; calibration (samples, fits, the shared v2
cache file); and engines serving with the reference's calibrated tables
(converted by ``params_from_jax``), float32 KV pages.

Tolerances, stated once: float outputs within 1e-4 of their largest
magnitude (float32 on both sides; only summation order and the
libraries' exp/log differ).  uint8 code outputs: at most 1e-3 of the
codes may differ, and each differing pair is one rounding step apart
(``eq.codes_agree``: adjacent exponents of one sign, or the smallest
magnitude under both signs) -- the two libraries' ``log`` and the two
summation orders put a value on either side of a rounding boundary now
and then.  Logits of a whole model step are held to 1e-3 of their scale:
such a flip in an activation code moves that activation by one
quantization step.  The streams are held to the reference's quantized
streams, not to an agreement bar with the float path: at this tiny size
the reference itself misses its own 0.95 bar.
"""

import functools
import json
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core import exponential_quant as jeq
from repro.core import lama_layers as jll
from repro.kernels.lut_dequant_matmul import ops as jops
from repro.models import api as jax_api
from repro.runtime import calibration as jcal
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import EngineConfig as JaxEngineConfig
from repro.runtime.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import exponential_quant as eq
from repro_torch.core import lama_layers as ll
from repro_torch.kernels.lut_dequant_matmul import ops as tops
from repro_torch.models import api as torch_api
from repro_torch.models import layers as L
from repro_torch.runtime import calibration as cal
from repro_torch.runtime.engine import Engine, EngineConfig, Request
from repro_torch.runtime.server import InferenceServer

TINY = dict(num_layers=2, d_model=64, d_ff=128, compute_dtype="float32")


def _f32_close(out, ref):
    ref = np.asarray(ref, np.float32)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=tol)


def _codes_close(out, ref):
    out, ref = _t(out), _t(ref)
    assert out.dtype == ref.dtype == torch.uint8
    assert bool(eq.codes_agree(out, ref).all())
    assert int((out != ref).sum()) <= 1e-3 * ref.numel()


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _coded(rng, shape, bits, scale):
    """Codes of a random tensor under its own reference fit, as numpy:
    (codes, lut, qmeta)."""
    x = jnp.asarray(rng.normal(size=shape) * scale, jnp.float32)
    qp = jeq.fit(x, bits)
    return (np.asarray(jeq.encode(x, qp)), np.asarray(jeq.decode_table(qp)),
            np.asarray(jeq.pack_qmeta(qp)))


# ------------------------------------------------------- dual kernels --

DUAL_CASES = [
    # m, k, n, decode_mode, epilogue, bias, out_quant
    (1, 72, 1000, "gather", None, False, True),
    (8, 100, 40, "alu", "silu", True, True),         # K off the 128 grid
    (33, 96, 48, "alu", "gelu", True, False),
    (33, 200, 40, "gather", "relu", False, True),
]


@pytest.mark.parametrize("m,k,n,mode,epi,bias,quant", DUAL_CASES)
def test_dual_matches_reference(m, k, n, mode, epi, bias, quant):
    rng = np.random.default_rng(m * 1000 + k + n)
    xc, lx, qx = _coded(rng, (m, k), 7, 0.3)
    wc, lw, qw = _coded(rng, (k, n), 6, 0.05)
    b = (rng.normal(size=(n,)).astype(np.float32) * 0.1) if bias else None
    ref_f = np.asarray(jops.lut_dequant_matmul_dual(
        xc, wc, lx, lw, qx, qw, epilogue=epi,
        bias=None if b is None else jnp.asarray(b), decode_mode=mode))
    qo = (np.asarray(jeq.pack_qmeta(jeq.fit(jnp.asarray(ref_f).reshape(-1), 7)))
          if quant else None)
    kw = dict(epilogue=epi, decode_mode=mode)
    ref = (np.asarray(jops.lut_dequant_matmul_dual(
        xc, wc, lx, lw, qx, qw, bias=None if b is None else jnp.asarray(b),
        out_qmeta=jnp.asarray(qo), **kw)) if quant else ref_f)
    out = tops.lut_dequant_matmul_dual(
        _t(xc), _t(wc), _t(lx), _t(lw), _t(qx), _t(qw),
        bias=None if b is None else _t(b),
        out_qmeta=None if qo is None else _t(qo), **kw)
    (_codes_close if quant else _f32_close)(out, ref)


GATED_CASES = [
    # m, k, n, decode_mode, activation, out_quant
    (1, 64, 96, "gather", "silu", False),
    (8, 100, 128, "alu", "silu", True),
    (33, 72, 64, "gather", "gelu", True),
]


@pytest.mark.parametrize("m,k,n,mode,act,quant", GATED_CASES)
def test_dual_gated_matches_reference(m, k, n, mode, act, quant):
    rng = np.random.default_rng(m * 7 + k + n)
    xc, lx, qx = _coded(rng, (m, k), 7, 0.3)
    gc, lg, qg = _coded(rng, (k, n), 6, 0.05)
    uc, lu, qu = _coded(rng, (k, n), 7, 0.05)
    args = (xc, gc, uc, lx, lg, lu, qx, qg, qu)
    ref_f = np.asarray(jops.lut_dequant_matmul_dual_gated(
        *args, activation=act, decode_mode=mode))
    qo = (np.asarray(jeq.pack_qmeta(jeq.fit(jnp.asarray(ref_f).reshape(-1), 7)))
          if quant else None)
    ref = (np.asarray(jops.lut_dequant_matmul_dual_gated(
        *args, activation=act, decode_mode=mode, out_qmeta=jnp.asarray(qo)))
        if quant else ref_f)
    out = tops.lut_dequant_matmul_dual_gated(
        *map(_t, args), activation=act, decode_mode=mode,
        out_qmeta=None if qo is None else _t(qo))
    (_codes_close if quant else _f32_close)(out, ref)


def test_k_edge_pad_code_is_masked_after_decode():
    """``k_valid``: positions past it are 0.0 after decode, not code 0
    (which is live: it decodes to +-(alpha*base^e_min + beta))."""
    rng = np.random.default_rng(5)
    xc, lx, qx = _coded(rng, (4, 40), 7, 0.3)
    wc, lw, qw = _coded(rng, (40, 8), 7, 0.05)
    padded = np.zeros((4, 48), np.uint8)
    padded[:, :40] = xc
    wpad = np.zeros((48, 8), np.uint8)
    wpad[:40] = wc
    from repro_torch.kernels.lut_dequant_matmul.ref import (
        lut_dequant_matmul_dual_ref)
    out = lut_dequant_matmul_dual_ref(_t(padded), _t(wpad), _t(lx), _t(lw),
                                      k_valid=40)
    ref = lut_dequant_matmul_dual_ref(_t(xc), _t(wc), _t(lx), _t(lw))
    assert float(lx[0]) != 0.0
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------- QTensor dispatch --

def _site(x):
    qm = eq.pack_qmeta(eq.fit(x.reshape(-1).to(torch.float32), 7))
    return {"lut": cal.lut_from_qmeta(qm), "qmeta": qm}


def _qweight(rng, shape):
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.05)
    codes, p = eq.quantize(w, 7)
    return eq.pack_qtensor(codes, p)


@pytest.mark.parametrize("spec,xshape,wshape", [
    (None, (11, 64), (64, 80)),                   # dense
    ("bsd,dnh->bsnh", (2, 5, 32), (32, 4, 8)),    # batched plan
    ("bsd,vd->bsv", (2, 3, 32), (40, 32)),        # tied unembedding
])
def test_qtensor_dispatch_matches_decoded_float_path(spec, xshape, wshape):
    """A ``QTensor`` activation through dense / dense_general equals the
    float matmul of both decoded operands; the transposed layout (no
    dual variant) decodes the carrier first, as the reference does."""
    rng = np.random.default_rng(len(xshape) + wshape[0])
    x = torch.from_numpy(rng.normal(size=xshape).astype(np.float32))
    wq = _qweight(rng, wshape)
    xq = ll.encode_act(x, _site(x))
    if spec is None:
        out = ll.dense(xq, wq)
        ref = ll.materialize(xq, torch.float32) @ ll.materialize(wq, torch.float32)
    else:
        out = ll.dense_general(xq, wq, spec)
        ref = torch.einsum(spec, ll.materialize(xq, torch.float32),
                           ll.materialize(wq, torch.float32))
    assert out.dtype == torch.float32
    _f32_close(out, ref)


def test_maybe_encode_act_gates():
    x = torch.ones(4, 8)
    aq = {"mlp_in": _site(x)}
    assert ll.maybe_encode_act(x, None, "mlp_in") is x
    assert ll.maybe_encode_act(x, aq, "attn_in") is x
    assert isinstance(ll.maybe_encode_act(x, aq, "mlp_in"), eq.QTensor)
    with ll.policy(act_quant=False):
        assert ll.maybe_encode_act(x, aq, "mlp_in") is x
    xq = ll.encode_act(x, aq["mlp_in"])
    assert eq.is_qtensor(xq) and xq.codes.dtype == torch.uint8
    assert xq.shape == x.shape and xq.dtype == torch.float32


def _mlp(gated):
    rng = np.random.default_rng(13)
    cfg = get_config("qwen3-1.7b", tiny=True).replace(
        d_model=32, d_ff=64, gated_mlp=gated, compute_dtype="float32")
    x = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    p = {name: _qweight(rng, spec.shape)
         for name, spec in L.mlp_specs(cfg).items()}
    _, mid = L.apply_mlp(p, x, cfg, return_mid=True)
    return cfg, p, x, {"mlp_in": _site(x), "mlp_mid": _site(mid)}


@pytest.mark.parametrize("gated", [True, False])
def test_down_projection_receives_a_qtensor(gated):
    """The MLP intermediate reaches w_down as codes (the quantize
    epilogue's output), and the chain stays close to the float MLP."""
    cfg, p, x, act_q = _mlp(gated)
    seen = []
    orig = ll.dense

    def spy(h, w, **kw):
        seen.append(type(h))
        return orig(h, w, **kw)

    with mock.patch.object(ll, "dense", spy):
        out = L.apply_mlp(p, x, cfg, act_q=act_q)
    assert eq.QTensor in seen
    ref = L.apply_mlp(p, x, cfg)
    assert float((out - ref).norm() / ref.norm()) < 0.25


# ---------------------------------------------------------- calibration --

def _cfgs(**kw):
    kw = {**TINY, **kw}
    return (jax_get_config("qwen3-1.7b", tiny=True).replace(**kw),
            get_config("qwen3-1.7b", tiny=True).replace(**kw))


@functools.lru_cache(maxsize=None)
def _jax_fparams():
    jcfg, _ = _cfgs()
    return jax_api.get_model(jcfg).init(jax.random.PRNGKey(0),
                                        dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _jax_qparams():
    jcfg, _ = _cfgs()
    return jll.quantize_tree(_jax_fparams(), 7, axes=jax_api.get_model(
        jcfg).logical_axes())[0]


def _to_port(jparams):
    _, cfg = _cfgs()
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                           device="cpu")


def _calib_prompts(cfg):
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_samples():
    """The reference's calibration samples of the float weights (its
    calibration of the 7-bit weights differs only in running the
    projections through the Pallas kernel, which interpret mode makes
    slow here)."""
    jcfg, cfg = _cfgs()
    api = jax_api.get_model(jcfg)
    samples = api.collect_act_calibration(
        _jax_fparams(), jnp.asarray(_calib_prompts(cfg)), jcfg)
    return {k: np.asarray(v) for k, v in samples.items()}


def test_calibration_samples_match_reference():
    _, cfg = _cfgs()
    ref = _jax_samples()
    got = torch_api.get_model(cfg).collect_act_calibration(
        _to_port(_jax_fparams()), torch.from_numpy(_calib_prompts(cfg)), cfg)
    assert set(got) == set(ref) == set(L.ACT_SITES)
    for site, r in ref.items():
        g = got[site].numpy()
        assert g.shape == r.shape, site
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=site)


@functools.lru_cache(maxsize=None)
def _jax_fit():
    """The reference's ``fit_sites`` on its samples (its default
    calibration prompts: 4 x 32 ids from seed 0)."""
    return jcal.fit_sites({k: jnp.asarray(v)
                           for k, v in _jax_samples().items()}, 7)


def test_fit_sites_matches_reference():
    """Same samples, both fits: the base is exactly the reference's,
    alpha and beta agree to rtol 1e-3, and so do the tables built from
    them, and the round-trip SQNR to 0.05 dB.  Not 1e-4: 20
    alternating-LS iterations over a fine base have not converged, so an
    exponent assignment flipped at a rounding boundary moves the
    trajectory.  Here that happens once: attn_v of layer 1, KV head 1
    (base 2**(1/64)) tracks the reference to 1e-7 for six iterations,
    then one of its 2048 values takes the neighbouring exponent (the two
    libraries' ``log`` differ in the last bit), and alpha drifts to
    3.8e-4 apart by iteration 20 (beta 5.7e-4, SQNR 0.022 dB).  Every
    other site and head agrees to 1e-5."""
    ref_aq, ref_rep = _jax_fit()
    got_aq, report = cal.fit_sites({k: _t(v)
                                    for k, v in _jax_samples().items()}, 7)
    for site, r in ref_aq.items():
        rq, gq = np.asarray(r["qmeta"]), got_aq[site]["qmeta"].numpy()
        assert gq.shape == rq.shape, site
        np.testing.assert_array_equal(gq[..., 2], rq[..., 2], err_msg=site)
        np.testing.assert_array_equal(gq[..., 3], rq[..., 3], err_msg=site)
        np.testing.assert_allclose(gq[..., :2], rq[..., :2], rtol=1e-3,
                                   atol=0, err_msg=site)
        rl = np.asarray(r["lut"])
        np.testing.assert_allclose(got_aq[site]["lut"].numpy(), rl, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(rl).max()))
        np.testing.assert_allclose(np.asarray(report[site]),
                                   np.asarray(ref_rep[site]), rtol=0,
                                   atol=0.05, err_msg=site)
    assert all(s > 10.0 for v in report.values()
               for s in np.asarray(v).ravel())


def test_sqnr_and_kv_fingerprint_match_reference():
    """Under the reference's tables: ``measure_sqnr`` (the serving-time
    round trip) within 0.01 dB per site, ``report_means`` equal to the
    mean of the report, and the KV tables' fingerprint equal to the
    reference's (the same float32 bytes)."""
    ref_aq, ref_rep = _jax_fit()
    aq = {site: {k: _t(v) for k, v in t.items()} for site, t in ref_aq.items()}
    samples = _jax_samples()
    got = cal.measure_sqnr({k: _t(v) for k, v in samples.items()}, aq)
    ref = jcal.measure_sqnr({k: jnp.asarray(v) for k, v in samples.items()},
                            ref_aq)
    assert set(got) == set(ref) == set(L.ACT_SITES)
    for site in ref:
        assert abs(got[site] - ref[site]) <= 0.01, site
    means = cal.report_means(ref_rep)
    for site, v in ref_rep.items():
        assert means[site] == pytest.approx(float(np.mean(v)), abs=1e-9)
    assert cal.kv_tables_fingerprint(aq) == jcal.kv_tables_fingerprint(ref_aq)


def test_cache_file_is_shared_with_the_reference(tmp_path):
    """An entry written by the reference's ``_save_entry`` loads through
    the port's loader under the same key (same metas, tables within
    1e-6 relative), and the port's entry loads into the reference."""
    ref_aq, ref_rep = _jax_fit()
    path, key = str(tmp_path / "calib.json"), "qwen3|L2|shared-key"
    jcal._save_entry(path, key, ref_aq, ref_rep)
    got, rep = cal._act_q_from_entry(cal._load_entry(path, key), "cpu")
    assert set(got) == set(ref_aq) and set(rep) == set(ref_rep)
    for site, r in ref_aq.items():
        np.testing.assert_array_equal(got[site]["qmeta"].numpy(),
                                      np.asarray(r["qmeta"]))
        rl = np.asarray(r["lut"])
        np.testing.assert_allclose(got[site]["lut"].numpy(), rl, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(rl).max()))
    port_path = str(tmp_path / "port.json")
    cal._save_entry(port_path, key, got, rep)
    assert json.load(open(port_path))["version"] == 2
    back, _ = jcal._act_q_from_entry(jcal._load_entry(port_path, key))
    for site in ref_aq:
        np.testing.assert_array_equal(np.asarray(back[site]["qmeta"]),
                                      np.asarray(ref_aq[site]["qmeta"]))


@pytest.fixture
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ACT_CALIB_CACHE", str(tmp_path / "calib.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    return tmp_path


def test_second_engine_reuses_the_calibration(isolated_cache):
    _, cfg = _cfgs()
    ec = EngineConfig(num_slots=2, block_size=8, max_seq_len=32)
    e1 = Engine(cfg, params=_to_port(_jax_qparams()), act_quant=7, engine=ec,
                device="cpu")
    assert set(e1.act_report) == set(L.ACT_SITES)
    blob = json.load(open(isolated_cache / "calib.json"))
    assert blob["version"] == 2 and len(blob["entries"]) == 1
    with mock.patch.object(cal, "fit_sites",
                           side_effect=AssertionError("re-fit")):
        e2 = Engine(cfg, params=e1.params, act_quant=7, engine=ec,
                    device="cpu")
    a1 = e1.params.tree()["blocks"]["act_q"]
    a2 = e2.params.tree()["blocks"]["act_q"]
    for site in L.ACT_SITES:
        torch.testing.assert_close(a1[site]["lut"], a2[site]["lut"],
                                   rtol=0, atol=0)


def test_kv_codes_require_act_quant_tables(isolated_cache):
    """Takes the place of the removed ``act_quant=7`` case of
    ``test_unported_serving_options_raise``: act_quant is served now,
    and kv_codes without tables is refused as the reference refuses it."""
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="act_quant"):
        Engine(cfg, kv_codes=True, device="cpu")
    with pytest.raises(ValueError, match="act_quant"):
        InferenceServer(cfg, kv_codes=True, device="cpu")
    Engine(cfg, act_quant=7, device="cpu",
           engine=EngineConfig(num_slots=1, block_size=8, max_seq_len=32))


# ------------------------------------------------------ serving streams --

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


@functools.lru_cache(maxsize=None)
def _jax_act_params():
    """The reference's 7-bit weights with act-quant tables of its own
    fit, attached as its ``Engine(act_quant=7)`` attaches them."""
    return jcal.attach_act_quant(_jax_qparams(), _jax_fit()[0])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_act_quant_streams_equal_reference(name):
    """Activations as codes, float32 KV: the port's engine with the
    reference's tables gives the reference engine's streams; the
    attention counters agree too."""
    lens, news, slots, bs, max_len = SCENARIOS[name]
    jcfg, cfg = _cfgs()
    jeng = JaxEngine(jcfg, params=_jax_act_params(), engine=JaxEngineConfig(
        num_slots=slots, block_size=bs, max_seq_len=max_len,
        prefix_cache=False))
    ref = jeng.generate(_requests(jcfg, lens, news, JaxRequest))
    eng = Engine(cfg, params=_to_port(_jax_act_params()), device="cpu",
                 engine=EngineConfig(num_slots=slots, block_size=bs,
                                     max_seq_len=max_len))
    out = eng.generate(_requests(cfg, lens, news, Request))
    assert [c.uid for c in out] == [c.uid for c in ref]
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.status == "ok"
    assert (eng.attn_bytes_read, eng.attn_act_bytes, eng.attn_dequants) == (
        jeng.attn_bytes_read, jeng.attn_act_bytes, jeng.attn_dequants)


def test_policy_off_gives_the_float_activation_tokens():
    """``policy(act_quant=False)`` ignores the attached tables: tokens
    equal those of the same weights without tables, exactly."""
    lens, news, slots, bs, max_len = SCENARIOS["more_requests_than_slots"]
    _, cfg = _cfgs()
    ec = EngineConfig(num_slots=slots, block_size=bs, max_seq_len=max_len)
    plain = Engine(cfg, params=_to_port(_jax_qparams()), engine=ec,
                   device="cpu")
    act = Engine(cfg, params=_to_port(_jax_act_params()), engine=ec,
                 device="cpu")
    ref = plain.generate(_requests(cfg, lens, news, Request))
    with ll.policy(act_quant=False):
        out = act.generate(_requests(cfg, lens, news, Request))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_no_carrier_decoded_outside_a_kernel_while_serving():
    """With a guard on ``materialize``, serving with act-quant tables
    never decodes a carrier (weight or activation codes) outside a
    kernel's plain version."""
    _, cfg = _cfgs()
    eng = Engine(cfg, params=_to_port(_jax_act_params()), device="cpu",
                 engine=EngineConfig(num_slots=2, block_size=8,
                                     max_seq_len=48))
    orig = ll.materialize

    def guarded(w, dtype=torch.bfloat16):
        if eq.is_qtensor(w):
            raise AssertionError("materialize() decoded a carrier")
        return orig(w, dtype)

    seen = []
    orig_dense = ll.dense

    def spy(h, w, **kw):
        seen.append(type(h))
        return orig_dense(h, w, **kw)

    with mock.patch.object(ll, "materialize", guarded), \
            mock.patch.object(ll, "dense", spy):
        out = eng.generate(_requests(cfg, (9, 20), (4, 3), Request))
    assert [len(c.tokens) for c in out] == [4, 3]
    assert seen and all(t is eq.QTensor for t in seen)


def test_step_logits_close_to_reference():
    """One prefill chunk and one decode step with act-quant tables:
    logits within 1e-3 of their scale (looser than the float path's
    tolerance: a code flipped at a rounding boundary moves one
    activation by a quantization step)."""
    from repro.runtime.paged_cache import PagedKVCache as JaxCache
    from repro_torch.runtime.paged_cache import PagedKVCache as TorchCache

    jcfg, cfg = _cfgs()
    jparams = _jax_act_params()
    model = _to_port(jparams)
    japi, tapi = jax_api.get_model(jcfg), torch_api.get_model(cfg)
    kw = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, num_slots=2, block_size=8,
              num_blocks=12, max_blocks_per_seq=5)
    jc, tc = JaxCache(**kw), TorchCache(**kw, device="cpu")
    prompts = [p.prompt for p in _requests(cfg, (13, 21), (1, 1), Request)]
    toks = np.zeros((2, 24), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        for c in (jc, tc):
            c.bind_slot(i, len(p), reserved=False)
    jl, jv = japi.prefill_into_cache(jparams, jnp.asarray(toks), jc.view(),
                                     jcfg)
    tl, _ = tapi.prefill_into_cache(model, torch.from_numpy(toks), tc.view(),
                                    cfg)
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-3 * scale)
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
