"""The port's rwkv family (``repro_torch.models.rwkv6``, rwkv6-3b) against
the JAX package's ``models/rwkv6.py``, on the CPU, at the reference's
tiny size (2 layers, d_model 64, two heads of 32) with float32 compute.

Both sides hold the same weights: the reference's (seed 0), converted by
``params_from_jax``; with 7-bit codes, fit by the port on those weights
and handed to the reference as its ``{codes, lut, qmeta}`` leaves, then
converted back (the reference's own fit takes ~10 s to compile at this
size; ``tests/test_torch_quant.py`` holds the two fits together).  Tolerances, relative to the largest magnitude of the
reference's result: the parametric LayerNorm, the token shift and the
DD-lerp within 1e-6; the WKV scan, the time- and channel-mix blocks
and their states within 1e-5 (float32; the scan's ``einsum`` sums
over k in another order than XLA's); logits and the states after
prefill and each decode step within 1e-4 of their scale (the issue's
bar; they land near 1e-6).  Token streams from
``InferenceServer.generate`` (the bucketed fallback on both sides) are
equal.
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
from repro.models import rwkv6 as jr
from repro.runtime.engine import Request as JaxRequest
from repro.runtime.server import InferenceServer as JaxServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import lama_layers as ll
from repro_torch.core.exponential_quant import QWeight
from repro_torch.models import api as torch_api
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as tr
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.server import InferenceServer, Request
from repro_torch.runtime.step_graph import StepGraph

ARCH = "rwkv6-3b"
OP_TOL = 1e-6
MIX_TOL = 1e-5
LOGITS_TOL = 1e-4


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
def _japi(jcfg):
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


def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _x(shape, seed=4, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
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
    """The ``blocks.{ln1,tmix,ln2,cmix}`` tree, ``ln_in`` and ``ln_f``
    with their biases and the untied ``unembed.out`` carry byte for
    byte; with codes, every ``w_*`` is a ``QWeight`` and the LoRA and
    decay matrices stay float."""
    _, cfg, params, model = _setup(quant)
    assert isinstance(model, tr.RwkvLM)
    ref = _flat(params)
    got = {k: v.numpy() for k, v in model.named_buffers()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for name in ("ln_in.bias", "ln_f.bias", "blocks.ln1.bias",
                 "blocks.ln2.scale", "blocks.tmix.bonus_u",
                 "blocks.tmix.lora_b", "blocks.cmix.mu_r"):
        assert name in got, name
    lp = model.layer(1)
    assert set(lp) == {"ln1", "tmix", "ln2", "cmix"}
    if quant:
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            assert isinstance(lp["tmix"][name], QWeight), name
        assert isinstance(lp["cmix"]["w_v"], QWeight)
        assert isinstance(model.tree()["unembed"]["out"], QWeight)
        for name in ("lora_a", "lora_b", "decay_a", "decay_b"):
            assert not isinstance(lp["tmix"][name], QWeight), name
    else:
        assert "unembed.out" in got


def test_quantize_tree_quantizes_the_reference_leaves():
    """The port's predicate picks the reference's leaves: every ``w_*``,
    the embedding table and ``unembed.out``; not the LoRA and decay
    matrices, ``mu`` or ``bonus_u``."""
    _, cfg, jparams, model = _setup(None)
    _, trep = ll.quantize_tree(model.tree(), 7,
                               axes=torch_api.get_model(cfg).logical_axes())
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jpaths = {tuple(k.key for k in path) for path, leaf in flat
              if jll.default_predicate(tuple(k.key for k in path), leaf)}
    assert set(trep) == jpaths
    assert ("blocks", "tmix", "w_g") in trep
    assert ("unembed", "out") in trep
    assert not any(p[-1] in ("lora_a", "lora_b", "decay_a", "decay_b", "mu",
                             "bonus_u") for p in trep)


# ------------------------------------------------------------- norms --

def test_layernorm_specs_and_values_match_reference():
    """``norm_specs``' parametric LayerNorm (``scale`` ones, ``bias``
    zeros) and ``apply_norm(kind="layernorm")`` against the reference's,
    on a random scale and bias, with the config's default norm RMSNorm
    (``kind`` wins) and LayerNorm."""
    jcfg, cfg = _cfgs()
    specs = L.norm_specs(cfg, "layernorm")
    assert set(specs) == {"scale", "bias"}
    assert (specs["scale"].init, specs["bias"].init) == ("ones", "zeros")
    assert L.norm_specs(cfg) == specs                 # cfg.norm is layernorm
    p = {"scale": _x((64,), seed=1), "bias": _x((64,), seed=2)}
    x = _x((2, 5, 64), scale=3.0) + 1.5
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for norm in ("rmsnorm", "layernorm"):
        jc, tc = jcfg.replace(norm=norm), cfg.replace(norm=norm)
        ref = jax_layers.apply_norm(p, jnp.asarray(x), jc, "layernorm")
        out = L.apply_norm(tp, torch.from_numpy(x), tc, "layernorm")
        assert _rel(out, ref) <= OP_TOL
    out = L.apply_norm(tp, torch.from_numpy(x), cfg)
    assert _rel(out, jax_layers.apply_norm(p, jnp.asarray(x), jcfg)) <= OP_TOL
    bf = L.apply_norm(tp, torch.from_numpy(x).bfloat16(), cfg, "layernorm")
    assert bf.dtype == torch.bfloat16


# ------------------------------------------------------------ mixing --

def _tmix(quant):
    _, _, params, model = _setup(quant)
    return params["blocks"], model.layer(0)


def _jlayer(blocks, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], blocks)


def test_shift_and_dd_lerp_match_reference():
    jb, tp = _tmix(None)
    jp = _jlayer(jb)["tmix"]
    x = _x((2, 6, 64))
    last = _x((2, 64), seed=5)
    for lst in (None, last):
        jl = None if lst is None else jnp.asarray(lst)
        tl = None if lst is None else torch.from_numpy(lst)
        js = jr._shift(jnp.asarray(x), jl)
        ts = tr._shift(torch.from_numpy(x), tl)
        assert _rel(ts, js) == 0.0
        jo = jr._dd_lerp(jp, jnp.asarray(x), js)
        to = tr._dd_lerp(tp["tmix"], torch.from_numpy(x), ts)
        assert len(to) == len(jo) == 5
        for a, b in zip(to, jo):
            assert _rel(a, b) <= OP_TOL


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 7])
def test_wkv_scan_matches_reference(with_state, s):
    """The recurrence in time order: y and the final state, from zeros
    and from a given state (which is not written)."""
    shape = (2, s, 2, 32)
    r, k, v = (_x(shape, seed=i) for i in (1, 2, 3))
    w = np.exp(-np.exp(_x(shape, seed=4, scale=0.5)))
    u = _x((2, 32), seed=6, scale=0.5)
    st = _x((2, 2, 32, 32), seed=7) if with_state else None
    jy, js = jr.wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                         None if st is None else jnp.asarray(st))
    tst = None if st is None else torch.from_numpy(st)
    ty, ts = tr.wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                         tst)
    assert ts.dtype == torch.float32 and ty.dtype == torch.float32
    assert _rel(ty, jy) <= MIX_TOL and _rel(ts, js) <= MIX_TOL
    if st is not None:
        assert torch.equal(tst, torch.from_numpy(st))


def test_wkv_scan_is_the_recurrence():
    """One token at a time from the carried state gives the whole
    sequence's outputs and state."""
    shape = (1, 5, 2, 32)
    r, k, v = (torch.from_numpy(_x(shape, seed=i)) for i in (1, 2, 3))
    w = torch.exp(-torch.exp(torch.from_numpy(_x(shape, seed=4))))
    u = torch.from_numpy(_x((2, 32), seed=6))
    y, s = tr.wkv_scan(r, k, v, w, u)
    state, ys = None, []
    for t in range(5):
        yt, state = tr.wkv_scan(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                                w[:, t:t + 1], u, state)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), y, rtol=0, atol=0)
    torch.testing.assert_close(state, s, rtol=0, atol=0)


@pytest.mark.parametrize("quant", [None, 7])
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_reference(quant, with_state):
    jcfg, cfg, params, model = _setup(quant)
    jp = _jlayer(params["blocks"])["tmix"]
    tp = model.layer(0)["tmix"]
    x = _x((2, 6 if not with_state else 1, 64))
    st = ({"tshift": _x((2, 64), seed=8), "wkv": _x((2, 2, 32, 32), seed=9)}
          if with_state else None)
    jst = None if st is None else {k: jnp.asarray(v) for k, v in st.items()}
    tst = None if st is None else {k: torch.from_numpy(v)
                                   for k, v in st.items()}
    jo, jn = jr.time_mix(jp, jnp.asarray(x), jcfg, jst)
    to, tn = tr.time_mix(tp, torch.from_numpy(x), cfg, tst)
    assert _rel(to, jo) <= MIX_TOL
    assert _rel(tn["wkv"], jn["wkv"]) <= MIX_TOL
    assert _rel(tn["tshift"], jn["tshift"]) == 0.0


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_reference(with_state):
    jcfg, cfg, params, model = _setup(7)
    jp = _jlayer(params["blocks"], 1)["cmix"]
    tp = model.layer(1)["cmix"]
    x = _x((2, 5, 64))
    st = {"tshift": _x((2, 64), seed=8)} if with_state else None
    jo, jn = jr.channel_mix(jp, jnp.asarray(x),
                            None if st is None else
                            {"tshift": jnp.asarray(st["tshift"])})
    to, tn = tr.channel_mix(tp, torch.from_numpy(x),
                            None if st is None else
                            {"tshift": torch.from_numpy(st["tshift"])})
    assert _rel(to, jo) <= MIX_TOL and _rel(tn["tshift"], jn["tshift"]) == 0.0


# -------------------------------------------------- the model's steps --

@pytest.mark.parametrize("quant", [None, 7])
def test_forward_matches_reference(quant):
    jcfg, cfg, params, model = _setup(quant)
    toks = _tokens(cfg, 2, 24)
    jl, _ = _japi(jcfg).forward(params, jnp.asarray(toks), jcfg)
    tl, aux = torch_api.get_model(cfg).forward(model, torch.from_numpy(toks),
                                               cfg)
    assert float(aux) == 0.0
    assert _rel(tl, jl) <= LOGITS_TOL


def _states_close(tc, jc) -> bool:
    """The WKV state within LOGITS_TOL of its scale; the token shifts
    too in float32, and in bfloat16 at most one rounding step apart
    element by element (a float32 last-bit difference moves a value
    across a bfloat16 rounding boundary now and then)."""
    if _rel(tc["wkv"], jc["wkv"]) > LOGITS_TOL:
        return False
    for k in ("tshift_t", "tshift_c"):
        if tc[k].dtype != torch.bfloat16:
            if _rel(tc[k], jc[k]) > LOGITS_TOL:
                return False
            continue
        a = tc[k].view(torch.int16).numpy().astype(np.int32)
        b = np.asarray(jc[k]).view(np.int16).astype(np.int32)
        if np.abs(a - b).max() > 1:
            return False
    return True


@pytest.mark.parametrize("quant,cache_dtype", [(None, "float32"),
                                               (7, "float32"),
                                               (None, "bfloat16")])
def test_prefill_and_decode_match_reference(quant, cache_dtype):
    """Prefill 10 tokens, then 12 decode steps: logits and every state
    (token shifts in the cache dtype, the WKV state in float32) after
    the prefill and after each step (``_states_close``)."""
    jcfg, cfg, params, model = _setup(quant)
    japi, tapi = _japi(jcfg), torch_api.get_model(cfg)
    toks = _tokens(cfg, 2, 22)
    jdt, tdt = jnp.dtype(cache_dtype), getattr(torch, cache_dtype)
    jl, jc = japi.prefill(params, jnp.asarray(toks[:, :10]), jcfg, 32,
                          cache_dtype=jdt)
    tl, tc = tapi.prefill(model, torch.from_numpy(toks[:, :10]), cfg, 32,
                          cache_dtype=tdt)
    assert tl.shape == (2, 1, cfg.vocab_size) and tc["pos"] == 10
    assert tc["tshift_t"].dtype == tdt and tc["wkv"].dtype == torch.float32
    assert _rel(tl, jl) <= LOGITS_TOL and _states_close(tc, jc)
    for t in range(10, 22):
        jl, jc = japi.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jcfg)
        tl, tc = tapi.decode_step(model, tc, torch.from_numpy(toks[:, t:t + 1]),
                                  cfg)
        assert _rel(tl, jl) <= LOGITS_TOL, t
        assert _states_close(tc, jc), t
    assert tc["pos"] == int(jc["pos"]) == 22


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


def test_decode_step_through_a_step_graph_equals_the_eager_step():
    """The bucketed server's step: a 0-d tensor ``pos`` advanced on the
    device, the states written in place, run through ``StepGraph``; its
    logits and states equal those of ``decode_step`` called with an int
    ``pos`` on a copy of the same cache, step for step."""
    _, cfg, _, model = _setup(7)
    api = torch_api.get_model(cfg)
    toks = torch.from_numpy(_tokens(cfg, 2, 14))
    _, cache = api.prefill(model, toks[:, :6], cfg, 0,
                           cache_dtype=torch.bfloat16)
    plain = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in cache.items()}
    bufs = {k: cache[k] for k in ("tshift_t", "wkv", "tshift_c")}
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
        run.capture(step)                        # a no-op on the CPU
        want, plain = api.decode_step(model, plain, toks[:, t:t + 1], cfg)
        assert torch.equal(got[-1], want), t
        for k, v in bufs.items():
            assert cache[k] is v and torch.equal(v, plain[k]), (t, k)
    assert int(pos) == plain["pos"] == 14


# ----------------------------------------------------------- serving --

LENS = (5, 12, 12, 30, 20)
NEWS = (8, 6, 8, 12, 4)


def _requests(cfg, cls):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(LENS, NEWS))]


def test_generate_streams_equal_reference():
    """``generate`` falls back to ``generate_bucketed`` on both sides;
    the streams are equal, with no Engine built and no cache bound (a
    ``max_len`` far below the streams' lengths: the state does not
    grow)."""
    jcfg, cfg, params, model = _setup(None)
    ref = JaxServer(jcfg, params=params, max_len=64).generate(
        _requests(jcfg, JaxRequest))
    srv = InferenceServer(cfg, params=model, max_len=8, device="cpu")
    out = srv.generate(_requests(cfg, Request))
    assert srv.last_engine is None
    assert [c.uid for c in out] == [c.uid for c in ref]
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.status == "ok" and b.decode_steps == a.decode_steps


def test_engine_refuses_rwkv_and_prefix_raises():
    """No paged path for rwkv, so ``Engine`` raises ``ValueError``; a
    prefix is refused (the reference's rwkv entry points drop it)."""
    _, cfg, _, model = _setup(None)
    assert not Engine.supports(cfg)
    with pytest.raises(ValueError, match="rwkv"):
        Engine(cfg, device="cpu")
    api = torch_api.get_model(cfg)
    assert api.module is tr.RwkvLM
    assert api.prefill_into_cache is None and api.decode_step_paged is None
    assert api.spec_verify_into_cache is None
    assert api.collect_act_calibration is None
    with pytest.raises(NotImplementedError, match="prefix"):
        api.forward(model, torch.zeros(1, 3, dtype=torch.int32), cfg,
                    prefix_embeds=torch.zeros(1, 2, 64))


def test_rwkv_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, cfg = _cfgs()
    for make in (lambda: tr.RwkvLM(cfg), lambda: InferenceServer(cfg),
                 lambda: tr.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
