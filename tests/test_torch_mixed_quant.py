"""The port's mixed-precision weights (the paper's Table VI) against the
JAX package's, on the CPU.

- ``fit``/``encode``/``decode_table`` at every width the bit-width
  search tries (3-7 bits): base equal, alpha and beta within rtol 1e-4
  (as ``tests/test_torch_quant.py`` holds the 7- and 4-bit fits), codes
  and tables bit-exact under the same parameters.
- ``search_bitwidth`` on ``tests/test_quantization.py``'s eight
  Gaussian stand-ins and on every eligible tensor of the tiny qwen3-1.7b
  and olmo-1b (layer 0 of a stacked weight, as ``quantize_tree_mixed``
  searches it), at targets of 16-34 dB: each width's round-trip SQNR
  within rtol 1e-4 of the reference's (``SQNR_RTOL``), and the chosen
  widths equal, except where the reference's SQNR lies within that
  tolerance of the target (printed; none at these inputs).
- ``quantize_tree_mixed``: the same report (widths equal, SQNR within
  ``SQNR_RTOL``) and codes equal except at rounding boundaries (at most
  1e-4 of codes one step apart, as ``quantize_tree``'s);
  ``quantized_fraction`` and ``avg_bits`` equal.
- Engine streams from a mixed tree (3-bit, and 6/7-bit mixed) equal the
  reference Engine's on the same tree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core import exponential_quant as jeq
from repro.core import lama_layers as jll
from repro.models import api as jax_api
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import EngineConfig as JaxEngineConfig
from repro.runtime.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import exponential_quant as teq
from repro_torch.core import lama_layers as tll
from repro_torch.models import api as torch_api
from repro_torch.runtime.engine import Engine, EngineConfig, Request

TINY = dict(num_layers=2, d_model=64, d_ff=128, compute_dtype="float32")
BITS = (3, 4, 5, 6, 7)
TARGETS = (16.0, 22.0, 28.0, 31.0, 34.0)
SQNR_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="qwen3-1.7b"):
    return (jax_get_config(arch, tiny=True).replace(**TINY),
            get_config(arch, tiny=True).replace(**TINY))


_PARAMS = {}


def _params(arch):
    """The reference's float weights of seed 0 (tree of numpy arrays)."""
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        _PARAMS[arch] = jax.tree_util.tree_map(
            np.asarray, jax_api.get_model(jcfg).init(jax.random.PRNGKey(0),
                                                     dtype=jnp.float32))
    return _PARAMS[arch]


def _gaussian(s):
    """``tests/test_quantization.py``'s stand-in ``_tensor(10 + s, scale=
    10 ** (-s % 3))``."""
    r = np.random.default_rng(10 + s)
    return (r.normal(size=(2048,)) * 10 ** (-s % 3)).astype(np.float32)


def _x(seed, shape=(96, 80), scale=0.05):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("bits", BITS)
def test_fit_encode_table_at_every_searched_width(bits):
    x = _x(bits)
    jp = jeq.fit(jnp.asarray(x), bits)
    tp = teq.fit(torch.from_numpy(x), bits)
    assert float(tp.base) == float(jp.base)
    np.testing.assert_allclose(float(tp.alpha), float(jp.alpha), rtol=1e-4)
    np.testing.assert_allclose(float(tp.beta), float(jp.beta), rtol=1e-4,
                               atol=1e-4 * abs(float(jp.alpha)))
    same = teq.ExpQuantParams(torch.tensor(np.float32(jp.alpha)),
                              torch.tensor(np.float32(jp.beta)),
                              torch.tensor(np.float32(jp.base)), bits)
    np.testing.assert_array_equal(teq.decode_table(same).numpy(),
                                  np.asarray(jeq.decode_table(jp)))
    np.testing.assert_array_equal(
        teq.encode(torch.from_numpy(x), same).numpy(),
        np.asarray(jeq.encode(jnp.asarray(x), jp)))
    np.testing.assert_allclose(float(teq.sqnr_db(torch.from_numpy(x), tp)),
                               float(jeq.sqnr_db(jnp.asarray(x), jp)),
                               rtol=SQNR_RTOL)


def _sqnrs(x: np.ndarray):
    """Each searched width's round-trip SQNR, reference and port."""
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    return ([float(jeq.sqnr_db(jx, jeq.fit(jx, b))) for b in BITS],
            [float(teq.sqnr_db(tx, teq.fit(tx, b))) for b in BITS])


def _first_at(sqnrs, target):
    return next((b for b, s in zip(BITS, sqnrs) if s >= target), BITS[-1])


def _check_search(label, x, targets=TARGETS) -> list[int]:
    """Equal widths at every target, up to ties with the target."""
    js, ts = _sqnrs(x)
    np.testing.assert_allclose(ts, js, rtol=SQNR_RTOL, err_msg=label)
    widths = []
    for target in targets:
        jb, tb = _first_at(js, target), _first_at(ts, target)
        if jb != tb:
            tie = js[BITS.index(min(jb, tb))]
            assert abs(tie - target) <= SQNR_RTOL * abs(tie), (label, target)
            print(f"{label} at {target} dB: reference {jb} bits, port {tb} "
                  f"(SQNR {tie:.6f} dB at the target)")
        widths.append(jb)
    return widths


@pytest.mark.parametrize("s", range(8))
def test_search_bitwidth_on_gaussian_stand_ins(s):
    x = _gaussian(s)
    widths = _check_search(f"stand-in {s}", x)
    b, qp = teq.search_bitwidth(torch.from_numpy(x), 22.0)
    jb, jp = jeq.search_bitwidth(jnp.asarray(x), 22.0)
    assert (b, qp.bits) == (jb, jp.bits) == (widths[1], widths[1])
    assert float(qp.base) == float(jp.base)


def _eligible(tree, path=()):
    """(path, layer-0 or whole tensor) of every leaf ``quantize_tree``
    would quantize in a reference numpy tree, by the port's predicate."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _eligible(v, path + (k,))
        elif tll.default_predicate(path + (k,), torch.from_numpy(v.copy())):
            yield path + (k,), v


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmo-1b"])
def test_search_bitwidth_on_model_tensors(arch):
    _, cfg = _cfgs(arch)
    axes = torch_api.get_model(cfg).logical_axes()
    seen = set()
    n = 0
    for path, v in _eligible(_params(arch)):
        ax = axes
        for k in path:
            ax = ax.get(k) if isinstance(ax, dict) else None
        x = v[0] if ax and ax[0] == "layers" else v
        seen.update(_check_search(f"{arch} {path}", np.ascontiguousarray(x)))
        n += 1
    assert n >= 8 and len(seen) >= 4, (n, seen)


def _mixed_trees(arch, target):
    jcfg, cfg = _cfgs(arch)
    jparams = jax.tree_util.tree_map(jnp.asarray, _params(arch))
    jq, jrep = jll.quantize_tree_mixed(
        jparams, target, axes=jax_api.get_model(jcfg).logical_axes())
    model = params_from_jax(_params(arch), cfg, device="cpu")
    tq, trep = tll.quantize_tree_mixed(
        model.tree(), target, axes=torch_api.get_model(cfg).logical_axes())
    return jq, jrep, tq, trep


@pytest.mark.parametrize("arch,target", [("qwen3-1.7b", 22.0),
                                         ("qwen3-1.7b", 31.0),
                                         ("olmo-1b", 31.0)])
def test_quantize_tree_mixed_matches_reference(arch, target):
    jq, jrep, tq, trep = _mixed_trees(arch, target)
    assert set(trep) == set(jrep)
    assert {p: b for p, (b, _) in trep.items()} == {
        p: b for p, (b, _) in jrep.items()}
    total = differ = 0
    for path, (bits, sqnr) in jrep.items():
        np.testing.assert_allclose(trep[path][1], sqnr, rtol=SQNR_RTOL)
        jleaf, tleaf = jq, tq
        for k in path:
            jleaf, tleaf = jleaf[k], tleaf[k]
        assert isinstance(tleaf, teq.QWeight)
        np.testing.assert_array_equal(tleaf.qmeta.numpy()[..., 3],
                                      np.asarray(jleaf["qmeta"])[..., 3])
        np.testing.assert_array_equal(tleaf.qmeta.numpy()[..., 2],
                                      np.asarray(jleaf["qmeta"])[..., 2])
        jc = np.asarray(jleaf["codes"]).astype(np.int16)
        tc = tleaf.codes.numpy().astype(np.int16)
        np.testing.assert_array_equal(tc >> 7, jc >> 7)
        assert np.abs(tc - jc).max() <= 1
        total += jc.size
        differ += int((tc != jc).sum())
    assert differ <= 1e-4 * total, (differ, total)
    assert tll.quantized_fraction(tq) == jll.quantized_fraction(jq)
    assert tll.avg_bits(trep) == jll.avg_bits(jrep)
    if target == 31.0:
        assert len({b for b, _ in trep.values()}) > 1   # really mixed


def test_avg_bits_and_fraction_of_edge_cases():
    assert tll.avg_bits({}) == jll.avg_bits({}) == 0.0
    rep = {("a",): (3, 20.0), ("b",): (6, 30.0), ("c",): (7, 1.0)}
    assert tll.avg_bits(rep) == jll.avg_bits(rep) == 16 / 3
    assert tll.quantized_fraction({}) == 0.0
    tree = {"w": torch.zeros(4, 4), "n": {"scale": torch.ones(4)}}
    assert tll.quantized_fraction(tree) == 0.0


@pytest.mark.parametrize("target", [16.0, 31.0], ids=["3-bit", "6-7-bit"])
def test_engine_streams_from_a_mixed_tree_equal_reference(target):
    """The reference's mixed tree, carried across by ``params_from_jax``,
    serves the same streams on both engines (the kernels' plain
    versions take any width: it travels in the tables)."""
    jq, jrep, _, _ = _mixed_trees("qwen3-1.7b", target)
    jcfg, cfg = _cfgs()
    ec = dict(num_slots=4, block_size=8, max_seq_len=96, prefill_chunk=16)
    jeng = JaxEngine(jcfg, params=jq, engine=JaxEngineConfig(**ec))
    eng = Engine(cfg, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jq), cfg, device="cpu"),
        device="cpu", engine=EngineConfig(**ec))
    rng = np.random.default_rng(3)
    reqs = [(i, rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32))
            for i, n in enumerate(rng.integers(5, 40, 6))]
    jout = jeng.generate([JaxRequest(i, p, max_new_tokens=8) for i, p in reqs])
    out = eng.generate([Request(i, p, max_new_tokens=8) for i, p in reqs])
    for a, b in zip(jout, out):
        assert b.status == a.status == "ok"
        np.testing.assert_array_equal(b.tokens, a.tokens)
    assert max(b for b, _ in jrep.values()) < 7 or target == 31.0
