"""The port's ``FusedPolicy`` A/B modes against the JAX package's, on the
CPU: ``mode="materialize"`` (decode the weight, then a float32 matmul)
and ``fuse_epilogues=False`` (the kernels run bare, bias, activation and
encode follow outside), held to the reference under the same policy on
the same numpy inputs, from the layer calls up to engine token streams.

Tolerances: float32 x within 1e-5 of the output's scale (both sides
decode the same table and sum float32 products in another order);
bfloat16 x within one bfloat16 rounding of the scale (2^-8: the two
float32 sums may round to neighbouring bfloat16 values; the measured
largest difference is printed); uint8 out codes one rounding step apart
at most (``eq.codes_agree``); token streams equal.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import exponential_quant as jeq
from repro.core import lama_layers as jll
from repro_torch.core import exponential_quant as eq
from repro_torch.core import lama_layers as ll
from repro_torch.kernels.lut_dequant_matmul import ops as tops
from repro_torch.kernels.lut_dequant_matmul.ref import apply_activation
import _torch_serving as ts

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qt(r, shape, bits=6):
    """(the reference's qtensor dict, the port's QWeight) of one random
    tensor quantized by the reference."""
    w = jnp.asarray(r.normal(size=shape) * 0.05, jnp.float32)
    codes, qp = jeq.quantize(w.reshape(shape[0], -1), bits)
    leaf = jeq.pack_qtensor(codes.reshape(shape), qp)
    port = eq.QWeight(*(torch.from_numpy(np.array(leaf[k]))
                        for k in ("codes", "lut", "qmeta")))
    return leaf, port


def _act(r, shape):
    """An activation as codes under its own fit: (the reference's
    QTensor, the port's)."""
    x = jnp.asarray(r.normal(size=shape), jnp.float32)
    p = jeq.fit(x, 7)
    parts = (jeq.encode(x, p), jeq.decode_table(p), jeq.pack_qmeta(p))
    return (jeq.QTensor(*parts),
            eq.QTensor(*(torch.from_numpy(np.array(a)) for a in parts)))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _scaled_err(out, ref) -> float:
    out, ref = _np(out), _np(ref)
    return float(np.abs(out - ref).max() / max(1.0, np.abs(ref).max()))


# every (spec, x shape, w shape) the model zoo runs through dense_general
# (tests/test_fused_path.py's list)
ZOO_SPECS = [
    ("bsd,dnh->bsnh", (2, 5, 64), (64, 4, 16)),     # wq/wk/wv
    ("bsnh,nhd->bsd", (2, 5, 4, 16), (4, 16, 64)),  # wo
    ("ecd,edf->ecf", (3, 7, 32), (3, 32, 48)),      # MoE routed up/gate
    ("ecf,efd->ecd", (3, 7, 48), (3, 48, 32)),      # MoE routed down
    ("td,edf->etf", (9, 32), (3, 32, 48)),          # MoE dense mixture
    ("bsd,vd->bsv", (2, 5, 32), (40, 32)),          # tied unembedding
    ("bsd,df->bsf", (2, 5, 32), (32, 48)),          # plain dense
]


@pytest.mark.parametrize("spec,xs,wsh", ZOO_SPECS, ids=[s[0] for s in ZOO_SPECS])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_materialize_mode_equals_the_reference(spec, xs, wsh, xdt):
    """Every zoo spec in materialize mode, against the reference's
    materialize mode; at float32 also against the port's fused path."""
    r = np.random.default_rng(sum(map(ord, spec)))
    jw, tw = _qt(r, wsh)
    x = r.normal(size=xs).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, xdt))
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    with jll.policy(mode="materialize"):
        ref = jll.dense_general(jx, jw, spec)
    with ll.policy(mode="materialize"):
        out = ll.dense_general(tx, tw, spec)
    assert out.dtype == tx.dtype and tuple(out.shape) == tuple(ref.shape)
    err = _scaled_err(out, ref)
    print(f"{spec} {xdt}: materialize, port vs reference {err:.3e} of scale")
    assert err <= (F32_TOL if xdt == "float32" else BF16_TOL)
    if xdt == "float32":
        assert _scaled_err(ll.dense_general(tx, tw, spec), out) <= F32_TOL


def test_materialize_mode_dense_and_gated_mlp_equal_the_reference():
    """``dense`` (bias, activation, out_quant on codes x) and
    ``gated_mlp`` in materialize mode against the reference's."""
    r = np.random.default_rng(21)
    jw, tw = _qt(r, (64, 48))
    jg, tg = _qt(r, (64, 48))
    x = r.normal(size=(6, 64)).astype(np.float32)
    bias = r.normal(size=(48,)).astype(np.float32)
    jxq, txq = _act(r, (6, 64))
    y = r.normal(size=(6, 48)).astype(np.float32)
    po = jeq.fit(jnp.asarray(y), 7)
    joq = {"lut": jeq.decode_table(po), "qmeta": jeq.pack_qmeta(po)}
    toq = {k: torch.from_numpy(np.array(v)) for k, v in joq.items()}
    with jll.policy(mode="materialize"):
        jd = jll.dense(jnp.asarray(x), jw, epilogue="gelu",
                       bias=jnp.asarray(bias))
        jm = jll.gated_mlp(jnp.asarray(x), jg, jw, "silu")
        jq = jll.dense(jxq, jw, out_quant=joq)
    with ll.policy(mode="materialize"):
        td = ll.dense(torch.from_numpy(x), tw, epilogue="gelu",
                      bias=torch.from_numpy(bias))
        tm = ll.gated_mlp(torch.from_numpy(x), tg, tw, "silu")
        tq = ll.dense(txq, tw, out_quant=toq)
    assert _scaled_err(td, jd) <= F32_TOL
    assert _scaled_err(tm, jm) <= F32_TOL
    assert isinstance(tq, eq.QTensor)
    got, want = tq.codes, torch.from_numpy(np.array(jq.codes))
    assert bool(eq.codes_agree(got, want, toq["qmeta"]).all())
    assert int((got != want).sum()) <= 1e-3 * want.numel()


@pytest.mark.parametrize("ep", ["gelu", "silu", "relu"])
def test_unfused_epilogues_equal_the_reference(ep):
    """``fuse_epilogues=False``: the kernel bare, then bias and the
    activation in torch, against the reference's same mode (its
    interpret-mode kernel bare, then ``_epilogue_jnp``) and the port's
    fused epilogue."""
    r = np.random.default_rng(5)
    jw, tw = _qt(r, (130, 70))
    x = r.normal(size=(33, 130)).astype(np.float32)
    bias = r.normal(size=(70,)).astype(np.float32)
    with jll.policy(fuse_epilogues=False):
        ref = jll.dense(jnp.asarray(x), jw, dtype=jnp.float32, epilogue=ep,
                        bias=jnp.asarray(bias))
    kw = dict(dtype=torch.float32, epilogue=ep, bias=torch.from_numpy(bias))
    with ll.policy(fuse_epilogues=False):
        out = ll.dense(torch.from_numpy(x), tw, **kw)
    assert _scaled_err(out, ref) <= F32_TOL
    assert _scaled_err(ll.dense(torch.from_numpy(x), tw, **kw), out) <= F32_TOL


def test_unfused_quantize_epilogue_equals_the_reference():
    """Codes x with ``out_quant`` and ``fuse_epilogues=False``: the dual
    kernel returns float32, the encode follows outside; the codes equal
    the reference's within one rounding step."""
    r = np.random.default_rng(8)
    jw, tw = _qt(r, (96, 40))
    jxq, txq = _act(r, (12, 96))
    bias = r.normal(size=(40,)).astype(np.float32)
    y = np.asarray(jll.materialize(jxq, jnp.float32)) @ np.asarray(
        jll.materialize(jw, jnp.float32))
    po = jeq.fit(jnp.asarray(y), 7)
    joq = {"lut": jeq.decode_table(po), "qmeta": jeq.pack_qmeta(po)}
    toq = {k: torch.from_numpy(np.array(v)) for k, v in joq.items()}
    with jll.policy(fuse_epilogues=False):
        ref = jll.dense(jxq, jw, epilogue="silu", bias=jnp.asarray(bias),
                        out_quant=joq)
    with ll.policy(fuse_epilogues=False):
        out = ll.dense(txq, tw, epilogue="silu", bias=torch.from_numpy(bias),
                       out_quant=toq)
    fused = ll.dense(txq, tw, epilogue="silu", bias=torch.from_numpy(bias),
                     out_quant=toq)
    want = torch.from_numpy(np.array(ref.codes))
    for got in (out.codes, fused.codes):
        assert bool(eq.codes_agree(got, want, toq["qmeta"]).all())
        assert int((got != want).sum()) <= 1e-3 * want.numel()


def test_gated_mlp_one_call_equals_three_ops():
    """The gated kernel's one call against ``act(x @ Wg) * (x @ Wu)`` in
    three float32 ops, and against the unfused mode's two dense calls."""
    r = np.random.default_rng(6)
    _, tg = _qt(r, (64, 96))
    _, tu = _qt(r, (64, 96))
    x = torch.from_numpy(r.normal(size=(17, 64)).astype(np.float32))
    wg, wu = ll.materialize(tg, torch.float32), ll.materialize(tu, torch.float32)
    for act in ("silu", "gelu"):
        out = ll.gated_mlp(x, tg, tu, act, dtype=torch.float32)
        ref = apply_activation(x @ wg, act) * (x @ wu)
        assert _scaled_err(out, ref) <= F32_TOL
        with ll.policy(fuse_epilogues=False):
            split = ll.gated_mlp(x, tg, tu, act, dtype=torch.float32)
        assert _scaled_err(split, ref) <= F32_TOL


def test_unfused_mode_splits_the_gated_kernel():
    """``fuse_epilogues=False`` never calls the gated wrappers: two plain
    calls, with no epilogue passed to the kernel."""
    r = np.random.default_rng(9)
    _, tg = _qt(r, (32, 48))
    _, tu = _qt(r, (32, 48))
    x = torch.from_numpy(r.normal(size=(5, 32)).astype(np.float32))
    seen = []
    orig = tops.lut_dequant_matmul

    def spy(*a, **k):
        seen.append((k.get("epilogue"), k.get("bias")))
        return orig(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the gated kernel ran with fuse_epilogues=False")

    with mock.patch.object(tops, "lut_dequant_matmul", spy), \
            mock.patch.object(tops, "lut_dequant_matmul_gated", refuse), \
            ll.policy(fuse_epilogues=False):
        ll.gated_mlp(x, tg, tu, "silu")
    assert seen == [(None, None), (None, None)]


def _tiny_model(quant=True):
    from repro_torch.configs import get_config
    from repro_torch.models import api as mapi
    from repro_torch.models.transformer import DecoderLM

    cfg = get_config("qwen3-1.7b", tiny=True).replace(compute_dtype="float32")
    api = mapi.get_model(cfg)
    model = api.init("cpu", seed=0)
    if quant:
        tree, _ = ll.quantize_tree(model.tree(), 7, axes=api.logical_axes())
        model = DecoderLM(cfg, tree, device="cpu")
    return cfg, api, model


def test_fused_mode_never_materializes_a_weight():
    """Prefill and a decode step of a quantized decoder in fused mode:
    ``materialize`` never sees a weight; in materialize mode no LUT GEMM
    wrapper runs and every weight is decoded by ``materialize``."""
    cfg, api, model = _tiny_model()
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    orig = ll.materialize
    decoded = []

    def guarded(w, dtype=torch.bfloat16):
        if isinstance(w, eq.QWeight):
            if ll.get_policy().mode != "materialize":
                raise AssertionError("a weight was decoded on the fused path")
            decoded.append(tuple(w.codes.shape))
        return orig(w, dtype)

    def refuse(*a, **k):
        raise AssertionError("a LUT GEMM ran in materialize mode")

    def run():
        with torch.no_grad():
            logits, cache = api.prefill(model, toks, cfg, 32,
                                        cache_dtype=torch.float32)
            lg, _ = api.decode_step(model, cache, toks[:, :1], cfg)
        return logits, lg

    with mock.patch.object(ll, "materialize", guarded):
        with ll.policy(mode="fused"):
            fused = run()
        assert not decoded
        with ll.policy(mode="materialize"), mock.patch.multiple(
                tops, lut_dequant_matmul=refuse, lut_dequant_matmul_gated=refuse,
                lut_dequant_matmul_dual=refuse,
                lut_dequant_matmul_dual_gated=refuse):
            mat = run()
    assert len(decoded) >= 7 * cfg.num_layers
    for a, b in zip(fused, mat):
        assert _scaled_err(b, a) <= F32_TOL


def test_policy_fields_and_switches():
    assert ll.FusedPolicy() == ll.FusedPolicy(
        mode="auto", decode_mode="gather", fuse_epilogues=True,
        flash_decode=True, autotune=None, act_quant=True)
    for f in ("mode", "decode_mode", "fuse_epilogues", "flash_decode",
              "autotune", "act_quant"):
        assert getattr(ll.FusedPolicy(), f) == getattr(jll.FusedPolicy(), f)
    with pytest.raises(ValueError, match="mode"):
        ll.FusedPolicy(mode="eager")
    with pytest.raises(ValueError, match="mode"):
        with ll.policy(mode="materialise"):
            pass
    prev = ll.get_policy()
    try:
        ll.use_pallas_kernel(False)
        assert ll.get_policy().mode == "materialize"
        assert not ll._fused_enabled()
        ll.use_pallas_kernel(True)
        assert ll.get_policy().mode == "fused" and ll._fused_enabled()
        ll.set_policy(ll.FusedPolicy(fuse_epilogues=False))
        assert not ll.get_policy().fuse_epilogues
    finally:
        ll.set_policy(prev)
    assert ll.get_policy() == prev


def test_policy_passes_autotune_to_the_wrappers():
    """``autotune`` reaches every LUT GEMM call, as the reference passes
    it."""
    r = np.random.default_rng(4)
    _, tw = _qt(r, (32, 48))
    _, tg = _qt(r, (32, 48))
    _, txq = _act(r, (3, 32))
    x = torch.from_numpy(r.normal(size=(3, 32)).astype(np.float32))
    seen = []

    def spy(name):
        orig = getattr(tops, name)

        def call(*a, **k):
            seen.append((name, k.get("autotune")))
            return orig(*a, **k)
        return call

    names = ("lut_dequant_matmul", "lut_dequant_matmul_gated",
             "lut_dequant_matmul_dual", "lut_dequant_matmul_dual_gated")
    with mock.patch.multiple(tops, **{n: spy(n) for n in names}), \
            ll.policy(autotune=False):
        ll.dense(x, tw)
        ll.gated_mlp(x, tg, tw, "silu")
        ll.dense(txq, tw)
        ll.gated_mlp(txq, tg, tw, "silu")
        ll.dense_general(x, tw, "td,df->tf")
    assert sorted(seen) == sorted([(n, False) for n in names]
                                  + [("lut_dequant_matmul", False)])


# ------------------------------------------------------- engine streams --

MIXED = dict(lens=(8, 32, 128, 8, 32, 17), news=(6, 4, 8, 3, 12, 5),
             ec=dict(num_slots=3, block_size=8, max_seq_len=140,
                     prefix_cache=False))


def _streams(side, kind, policy_kw, **engine_kw):
    pol = (jll if side.ref else ll).policy(**policy_kw)
    v = side.cfg(kind).vocab_size
    with pol:
        eng = side.engine(kind, ec=MIXED["ec"], **engine_kw)
        reqs = [side.request(i, ts.prompt(v, n, seed=i), max_new_tokens=m)
                for i, (n, m) in enumerate(zip(MIXED["lens"], MIXED["news"]))]
        done = eng.generate(reqs)
    return ts.outs(done)


@pytest.mark.parametrize("kind,policy_kw,engine_kw", [
    ("float", dict(mode="materialize"), {}),
    ("codes", dict(fuse_epilogues=False), dict(kv_codes=True)),
], ids=["materialize", "unfused_codes"])
def test_engine_streams_equal_the_reference_under_the_policy(kind, policy_kw,
                                                              engine_kw):
    """The reference engine and the port's, each built and run under the
    same policy, on the mixed-lengths stream: equal completions.  The
    codes case serves 7-bit weights with act-quant tables (as
    ``act_quant=7``) and KV pages as codes."""
    ref = _streams(ts.Side(True), kind, policy_kw, **engine_kw)
    out = _streams(ts.Side(False), kind, policy_kw, **engine_kw)
    assert out == ref
    assert all(s == "ok" for _, s, _, _ in out)


def test_a_policy_change_after_an_eager_step_builds_a_new_runner():
    """The step runners are keyed on the whole policy: a step under
    another policy takes a runner of its own (a captured graph bakes its
    policy in), and the first policy's runners stay as they were."""
    side = ts.Side(False)
    eng = side.engine("float", ec=dict(num_slots=2, block_size=8,
                                       max_seq_len=48, prefix_cache=False))
    v = side.cfg().vocab_size

    def serve():
        return ts.outs(eng.generate([side.request(i, ts.prompt(v, 9, seed=i),
                                                  max_new_tokens=3)
                                     for i in range(2)]))

    first = serve()
    runners = {kind: dict(r) for kind, r in eng.step_runners.items()}
    assert runners["decode"] and runners["prefill"]
    assert all(key[-1] == ll.FusedPolicy()
               for r in runners.values() for key in r)
    with ll.policy(mode="materialize") as pol:
        second = serve()
    for kind, r in eng.step_runners.items():
        new = {key: run for key, run in r.items() if key not in runners[kind]}
        assert all(key[-1] == pol for key in new)
        assert all(r[key] is run for key, run in runners[kind].items())
    assert any(key[-1] == pol for key in eng.step_runners["decode"])
    assert [t for _, _, t, _ in second] == [t for _, _, t, _ in first]
