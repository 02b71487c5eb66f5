"""The port's MoE layers and MoE decoders against the JAX package's, on the
CPU, at the reference's tiny MoE configs (2 layers, d_model 64, 4
experts): grok-1 (top-2, gelu, logit softcap) and llama4-scout (top-1).

- ``apply_moe_routed`` / ``apply_moe_dense`` on float weights, on 7-bit
  weights and on 7-bit weights with the mlp_in site as codes: the expert
  choices exactly equal, outputs within TOL, ``aux`` within rtol 1e-5.
- The capacity-bound case of ``tests/test_models.py`` (capacity factor
  0.001, 4096 tokens): the same tokens dropped, exactly.  Routed equals
  dense mixture with room (capacity factor 8).
- ``params_from_jax`` carries ``blocks.moe.*`` bit-exact; the port's
  ``quantize_tree`` and ``quantize_tree_mixed`` give the reference's
  layout (one table a layer, shared by its experts).
- ``forward``, ``prefill``, ``decode_step``, ``prefill_into_cache`` and
  ``decode_step_paged`` logits within TOL of their scale (``atol`` times
  the largest magnitude when that exceeds 1); no qtensor reaches
  ``materialize`` on the MoE path.  (``ep_a2a`` across ranks:
  ``tests/test_torch_dist.py``.)

Both sides hold the same bytes (the reference's params converted with
``params_from_jax``).  TOL: rtol/atol 2e-5 in float32, the two sides
differing only in summation order (the reference's quantized matmuls
run its interpret-mode kernels, the port's their plain versions).  The
logits are held to TOL scaled by their magnitude because the reference's
init draws the expert stacks with the fan-in of their experts axis (the
``[L, E, d, f]`` spec's axis 1), so the tiny models' hidden states reach
~185 and a last-bit difference there reaches the logits (grok-1's 7-bit
model: 4.3e-5 at a logit scale of 3.8, 1.1e-5 of it).
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core import exponential_quant as jeq
from repro.core import lama_layers as jll
from repro.models import api as jax_api
from repro.models import moe as JM
from repro.models.params import init_params as jax_init_params
from repro.runtime.paged_cache import PagedKVCache as JaxCache
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import exponential_quant as teq
from repro_torch.core import lama_layers as tll
from repro_torch.models import api as torch_api
from repro_torch.models import moe as TM
from repro_torch.runtime import calibration as tcal
from repro_torch.runtime.paged_cache import PagedKVCache as TorchCache

TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("grok-1-314b", "llama4-scout-17b-a16e")
WEIGHTS = ("float", "7bit", "7bit-codes-act")
BS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (jax_get_config(arch, tiny=True).replace(**kw),
            get_config(arch, tiny=True).replace(**kw))


def _port_tree(node):
    """A reference tree (numpy leaves) as the port's nested dict."""
    if isinstance(node, dict):
        if "codes" in node and "lut" in node:
            return teq.QWeight(*(tensor_from_numpy(node[k])
                                 for k in ("codes", "lut", "qmeta")))
        return {k: _port_tree(v) for k, v in node.items()}
    return tensor_from_numpy(node)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ layers --

@functools.lru_cache(maxsize=None)
def _layer(arch, weights):
    """(jcfg, cfg, reference moe params, port params, x [2, 8, d], the
    reference's act_q and the port's, or None): the layer's weights of
    seed 1 (quantized by the reference to 7 bits per tensor), x of seed
    0, and for codes an mlp_in table fit by the port on x."""
    jcfg, cfg = _cfgs(arch)
    p = jax_init_params(jax.random.PRNGKey(1), JM.moe_specs(jcfg), jnp.float32)
    if weights != "float":
        from repro.models.params import logical_axes
        p, _ = jll.quantize_tree(p, 7, axes=logical_axes(JM.moe_specs(jcfg)))
    tp = _port_tree(_np(p))
    x = np.random.default_rng(0).normal(size=(2, 8, cfg.d_model)).astype(
        np.float32)
    jq = tq = None
    if weights == "7bit-codes-act":
        act_q, _ = tcal.fit_sites({"mlp_in": torch.from_numpy(x)[None]}, 7)
        tq = {"mlp_in": {k: v[0] for k, v in act_q["mlp_in"].items()}}
        jq = {"mlp_in": {k: jnp.asarray(v.numpy())
                         for k, v in tq["mlp_in"].items()}}
    return jcfg, cfg, p, tp, x, jq, tq


def _ref_choices(p, x, jcfg):
    _, top_w, top_e, _ = JM._router(p, jnp.asarray(x).reshape(-1, x.shape[-1]),
                                    jcfg)
    return np.asarray(top_e), np.asarray(top_w)


@pytest.mark.parametrize("impl", ["routed", "dense"])
@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(arch, weights, impl):
    jcfg, cfg, p, tp, x, jq, tq = _layer(arch, weights)
    _, tw, te, _ = TM._router(tp, torch.from_numpy(x).reshape(-1, cfg.d_model),
                              cfg)
    je, jw = _ref_choices(p, x, jcfg)
    np.testing.assert_array_equal(te.numpy(), je)
    np.testing.assert_allclose(tw.numpy(), jw, **TOL)
    fn = "apply_moe_routed" if impl == "routed" else "apply_moe_dense"
    jy, jaux = jax.jit(lambda p_, x_, q_: getattr(JM, fn)(p_, x_, jcfg,
                                                           act_q=q_))(
        p, jnp.asarray(x), jq)
    ty, taux = getattr(TM, fn)(tp, torch.from_numpy(x), cfg, act_q=tq)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_capacity_bound_drops_the_reference_tokens():
    """``tests/test_models.py``'s capacity-bound case: 4096 tokens over a
    capacity of 128 an expert.  A dropped token (top-1) comes back as an
    exact zero row on both sides, so the dropped sets are compared
    exactly; the counter sees the same number."""
    jcfg, cfg = _cfgs("llama4-scout-17b-a16e", capacity_factor=0.001)
    p = jax_init_params(jax.random.PRNGKey(1), JM.moe_specs(jcfg), jnp.float32)
    tp = _port_tree(_np(p))
    x = np.random.default_rng(0).normal(size=(4, 1024, cfg.d_model)).astype(
        np.float32)
    jy, _ = JM.apply_moe_routed(p, jnp.asarray(x), jcfg)
    counts = torch.zeros(3, dtype=torch.int64)
    ty, _ = TM.apply_moe_routed(tp, torch.from_numpy(x), cfg, counts=counts)
    jy, ty = np.asarray(jy).reshape(-1, cfg.d_model), ty.numpy().reshape(
        -1, cfg.d_model)
    jdrop, tdrop = ~jy.any(-1), ~ty.any(-1)
    np.testing.assert_array_equal(tdrop, jdrop)
    assert len(tdrop) - 4 * 128 <= tdrop.sum() < len(tdrop)
    assert counts.tolist() == [1, 4096, int(tdrop.sum())]
    np.testing.assert_allclose(ty, jy, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_routed_equals_dense_with_room(arch):
    """``tests/test_models.py``'s routed-vs-dense case on the port: with
    capacity factor 8 nothing is dropped, so the routed dispatch is the
    dense mixture; none dropped by the counter."""
    _, cfg = _cfgs(arch, capacity_factor=8.0)
    _, _, _, tp, x, _, _ = _layer(arch, "float")
    counts = torch.zeros(3, dtype=torch.int64)
    routed, aux_r = TM.apply_moe_routed(tp, torch.from_numpy(x), cfg,
                                        counts=counts)
    dense, aux_d = TM.apply_moe_dense(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(routed.numpy(), dense.numpy(), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(float(aux_r), float(aux_d), rtol=1e-5)
    assert counts.tolist()[2] == 0


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                          [0.5, 0.2, 0.2, 0.1]])
    vals, idx = TM.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# ------------------------------------------------------------ models --

@functools.lru_cache(maxsize=None)
def _model(arch, quant):
    """(jcfg, cfg, reference params, the port's DecoderLM): the
    reference's init of seed 0, quantized by it to 7 bits if asked."""
    jcfg, cfg = _cfgs(arch)
    japi = jax_api.get_model(jcfg)
    params = japi.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant:
        params, _ = jll.quantize_tree(params, 7, axes=japi.logical_axes())
    return jcfg, cfg, params, params_from_jax(_np(params), cfg, device="cpu")


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, node


@pytest.mark.parametrize("quant", [False, True], ids=["float", "7bit"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_the_moe_blocks(arch, quant):
    _, cfg, params, model = _model(arch, quant)
    moe = _np(params)["blocks"]["moe"]
    port = model["blocks"]["moe"]
    assert set(moe) == {"router", "w_gate", "w_up", "w_down"}
    assert isinstance(port["router"], torch.Tensor)   # the router stays float
    for path, leaf in _leaves(moe):
        node = port
        for k in path:
            node = (getattr(node, k) if isinstance(node, teq.QWeight)
                    else node[k])
        np.testing.assert_array_equal(node.numpy(), leaf)
    if quant:
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        assert tuple(port["w_gate"].codes.shape) == (cfg.num_layers, e, d, f)
        assert tuple(port["w_down"].codes.shape) == (cfg.num_layers, e, f, d)
        assert tuple(port["w_up"].lut.shape) == (cfg.num_layers, 256)
        lp = model.layer(1)["moe"]
        assert tuple(lp["w_up"].lut.shape) == (256,)


@pytest.mark.parametrize("fn", ["quantize_tree", "quantize_tree_mixed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_tree_gives_the_reference_layout(arch, fn):
    """One fit a layer over its ``[E, d, f]`` experts, as the reference's
    ``_quantize_stacked``: the same widths and bases, alpha and beta, the codes
    at most one step apart (the math libraries' last bits), the router
    left float.  Tolerances as ``tests/test_torch_quant.py``'s."""
    jcfg, cfg, params, model = _model(arch, False)
    arg = 7 if fn == "quantize_tree" else 28.0
    jq, jrep = getattr(jll, fn)(params, arg,
                                axes=jax_api.get_model(jcfg).logical_axes())
    tq, trep = getattr(tll, fn)(model.tree(), arg,
                                axes=torch_api.get_model(cfg).logical_axes())
    assert set(trep) == set(jrep)
    assert ("blocks", "moe", "router") not in trep
    assert isinstance(tq["blocks"]["moe"]["router"], torch.Tensor)
    total = differ = 0
    for path in jrep:
        assert trep[path][0] == jrep[path][0]
        jleaf, tleaf = jq, tq
        for k in path:
            jleaf, tleaf = jleaf[k], tleaf[k]
        np.testing.assert_array_equal(tleaf.qmeta.numpy()[..., 2:],
                                      np.asarray(jleaf["qmeta"])[..., 2:])
        # alpha and beta within the fit's rtol 1e-4 (tests/test_torch_quant.py)
        tm, jm = tleaf.qmeta.numpy(), np.asarray(jleaf["qmeta"])
        np.testing.assert_allclose(tm[..., 0], jm[..., 0], rtol=1e-4)
        assert np.all(np.abs(tm[..., 1] - jm[..., 1]) <= 1e-4 * jm[..., 0])
        assert tleaf.lut.shape == jleaf["lut"].shape
        jc = np.asarray(jleaf["codes"]).astype(np.int16)
        tc = tleaf.codes.numpy().astype(np.int16)
        np.testing.assert_array_equal(tc >> 7, jc >> 7)
        assert np.abs(tc - jc).max() <= 1
        # under the port's own parameters the reference's encoder gives the
        # port's codes but at rounding boundaries (the two fits' last bits
        # move more codes: 28 of 65536 in grok-1's w_down)
        x = params
        for k in path:
            x = x[k]
        lead = tm.shape[:-1]
        qm = tm.reshape(lead + (1,) * (x.ndim - len(lead)) + (4,))
        rc = np.asarray(jeq.encode_meta(x, jnp.asarray(qm))).astype(np.int16)
        assert np.abs(tc - rc).max() <= 1
        total += rc.size
        differ += int((tc != rc).sum())
    assert differ <= 1e-4 * total, (differ, total)
    gate = tq["blocks"]["moe"]["w_gate"]
    assert tuple(gate.lut.shape) == (cfg.num_layers, 256)


def _pages(cfg, slots, lens):
    kw = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, num_slots=slots, block_size=BS,
              num_blocks=24, max_blocks_per_seq=8)
    jc, tc = JaxCache(**kw), TorchCache(**kw, device="cpu")
    for c in (jc, tc):
        c.allocator.reserve(8)
        for i, n in enumerate(lens):
            c.bind_slot(i, n)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jitted(jcfg):
    japi = jax_api.get_model(jcfg)
    return {"forward": jax.jit(japi.forward, static_argnums=(2,)),
            "prefill": jax.jit(japi.prefill, static_argnums=(2, 3),
                               static_argnames=("cache_dtype",)),
            "decode_step": jax.jit(japi.decode_step, static_argnums=(3,)),
            "prefill_into_cache": jax.jit(japi.prefill_into_cache,
                                          static_argnums=(3,)),
            "decode_step_paged": jax.jit(japi.decode_step_paged,
                                         static_argnums=(4,))}


def _run_entry(entry, side, jcfg, cfg, params, model, toks):
    """Logits of ``entry`` on one side ("ref" or "port") for the 2-row
    prompts ``toks`` (row 1 is 3 tokens shorter, its tail padding); the
    decode entries run 2 steps after their prefill, fed token 5."""
    ref = side == "ref"
    j = _jitted(jcfg)
    tapi = torch_api.get_model(cfg)
    if entry == "forward":
        if ref:
            return [j["forward"](params, jnp.asarray(toks), jcfg)[0]]
        return [tapi.forward(model, torch.from_numpy(toks), cfg)[0]]
    if entry == "prefill" or entry == "decode_step":
        if ref:
            lg, cache = j["prefill"](params, jnp.asarray(toks), jcfg, 16,
                                     cache_dtype=jnp.float32)
        else:
            lg, cache = tapi.prefill(model, torch.from_numpy(toks), cfg, 16,
                                     cache_dtype=torch.float32)
        outs = [lg]
        if entry == "decode_step":
            for _ in range(2):
                nxt = np.full((2, 1), 5, np.int32)
                if ref:
                    lg, cache = j["decode_step"](params, cache,
                                                 jnp.asarray(nxt), jcfg)
                else:
                    lg, cache = tapi.decode_step(model, cache,
                                                 torch.from_numpy(nxt), cfg)
                outs.append(lg)
        return outs
    lens = (toks.shape[1], toks.shape[1] - 3)
    jc, tc = _pages(cfg, 2, lens)
    if ref:
        lg, view = j["prefill_into_cache"](params, jnp.asarray(toks),
                                           jc.view(), jcfg, None)
        jc.k_pages, jc.v_pages = view.k_pages, view.v_pages
    else:
        lg, view = tapi.prefill_into_cache(model, torch.from_numpy(toks),
                                           tc.view(), cfg)
    outs = [lg]
    if entry == "decode_step_paged":
        active = np.asarray([True, True])
        c = jc if ref else tc
        for _ in range(2):
            for i in range(2):
                c.ensure_capacity(i, reserved=False)
            nxt = np.full((2, 1), 5, np.int32)
            if ref:
                lg, view = j["decode_step_paged"](
                    params, jc.view(), jnp.asarray(nxt), jnp.asarray(active),
                    jcfg)
                jc.k_pages, jc.v_pages = view.k_pages, view.v_pages
                jc.lengths[:] = np.asarray(view.lengths)
            else:
                lg, view = tapi.decode_step_paged(
                    model, tc.view(), torch.from_numpy(nxt),
                    torch.from_numpy(active), cfg)
                tc.lengths[:] = view.lengths.numpy()
            outs.append(lg)
    return outs


ENTRIES = ("forward", "prefill", "decode_step", "prefill_into_cache",
           "decode_step_paged")


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("quant", [False, True], ids=["float", "7bit"])
@pytest.mark.parametrize("arch", ARCHS)
def test_entry_point_logits_match_reference(arch, quant, entry):
    jcfg, cfg, params, model = _model(arch, quant)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (2, 11)).astype(np.int32)
    want = _run_entry(entry, "ref", jcfg, cfg, params, model, toks)
    with torch.no_grad():
        got = _run_entry(entry, "port", jcfg, cfg, params, model, toks)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale)


def test_forward_aux_is_the_layers_mean():
    jcfg, cfg, params, model = _model("grok-1-314b", False)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (2, 11)).astype(np.int32)
    _, jaux = _jitted(jcfg)["forward"](params, jnp.asarray(toks), jcfg)
    _, taux = torch_api.get_model(cfg).forward(model, torch.from_numpy(toks),
                                               cfg)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("impl", ["routed", "dense_mixture"])
@pytest.mark.parametrize("arch", ARCHS)
def test_no_qtensor_is_materialized_on_the_moe_path(arch, impl):
    """The twin of ``tests/test_fused_path.py``'s zero-materialization
    test: a quantized MoE model's prefill and decode step, with the
    act-quant tables attached (codes in and out of the expert GEMMs),
    never hand a qtensor to ``materialize``."""
    jcfg, cfg, _, model = _model(arch, True)
    cfg = cfg.replace(moe_impl=impl)
    api = torch_api.get_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    samples = api.collect_act_calibration(model, toks, cfg)
    assert "mlp_mid" not in samples and "mlp_in" in samples
    act_q, _ = tcal.fit_sites(samples, 7)
    for m in (model, tcal.attach_act_quant(model, act_q)):
        orig = tll.materialize

        def guarded(w, dtype=torch.bfloat16):
            if teq.is_qtensor(w):
                raise AssertionError("materialize() decoded a qtensor on "
                                     "the fused path")
            return orig(w, dtype)

        with mock.patch.object(tll, "materialize", guarded):
            logits, cache = api.prefill(m, toks, cfg, 32,
                                        cache_dtype=torch.float32)
            lg, _ = api.decode_step(m, cache, toks[:, :1], cfg)
        assert bool(torch.isfinite(lg).all())
