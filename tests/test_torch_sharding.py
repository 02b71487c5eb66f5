"""The port's sharding rules and abstract shape helpers against the JAX
package's, on the CPU, with no process group and nothing compiled.

The port's ``spec_for`` / ``tree_shardings`` return plain tuples, one
entry a dimension (``None`` or the mesh axes); the reference's
``PartitionSpec`` compares ``==`` with such a tuple.  The reference's
``tree_shardings`` wraps each spec in a ``NamedSharding``, which needs a
real mesh: here its ``NamedSharding`` is replaced by a function that
returns the spec, so its rules run on ``FakeMesh`` (the duck-typed mesh
of ``tests/test_sharding.py``) against ``ShapeDtypeStruct`` trees.

Every registered architecture at full size: each parameter leaf, the
7-bit abstract quantized tree, the AdamW state, ``input_specs`` of each
run shape and each family's ``abstract_cache``, on the 16 x 16 and 2 x
16 x 16 meshes, in ``train`` and ``serve`` mode, under the default
switches, ``TRAIN_CP`` on, and ``SERVE_SEQ_SHARD`` / ``SERVE_PARAM_FSDP``
off.  The abstract helpers' shapes and dtypes are equal to the
reference's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES_BY_NAME as JAX_SHAPES
from repro.core import lama_layers as jll
from repro.models import api as jax_api
from repro.models.params import abstract_params as jax_abstract_params
from repro.models.params import logical_axes as jax_logical_axes
from repro.optim import adamw as jadamw
from repro.sharding import rules as JR
from repro_torch import tree as T
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.core import lama_layers as ll
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.sharding import rules as R


class FakeMesh:
    """Duck-typed mesh: rules only need .shape (dict) and sizes."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"single": SINGLE, "multi": MULTI}
SWITCHES = {
    "default": {},
    "train_cp": {"TRAIN_CP": True},
    "serve_seq_off": {"SERVE_SEQ_SHARD": False},
    "serve_param_fsdp_off": {"SERVE_PARAM_FSDP": False},
}


@pytest.fixture
def reference_specs(monkeypatch):
    """The reference's ``tree_shardings`` returning bare specs."""
    monkeypatch.setattr(JR, "NamedSharding", lambda mesh, spec: spec)


def _switch(monkeypatch, name):
    for k, v in SWITCHES[name].items():
        monkeypatch.setattr(JR, k, v)
        monkeypatch.setattr(R, k, v)


def _jleaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))


def _sd(x):
    """(shape, dtype name) of a ShapeDtypeStruct or a tensor."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), np.dtype(x.dtype).name


def _leaves(tree):
    """The port tree's leaves in pytree order, a spec tuple one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if hasattr(tree, "_fields"):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_same(port_tree, ref_tree, what):
    a, b = _leaves(port_tree), _jleaves(ref_tree)
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, (what, i, x, y)


def _assert_sd(port_tree, ref_tree, what):
    """Shapes and dtypes equal, leaf for leaf in pytree order."""
    a = [_sd(x) for x in T.leaves(port_tree)]
    b = [_sd(x) for x in jax.tree_util.tree_leaves(ref_tree)]
    assert a == b, what


def _trees(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    japi, tapi = jax_api.get_model(jcfg), api.get_model(cfg)
    return jcfg, cfg, japi, tapi


def test_arch_registries_equal():
    assert ARCH_NAMES == JAX_ARCH_NAMES
    assert list(SHAPES_BY_NAME) == list(JAX_SHAPES)


# ------------------------------------------ test_sharding.py on the port --

def test_mlp_weight_fsdp_plus_tp():
    spec = R.spec_for((2048, 8192), ("embed", "mlp"), SINGLE, "train")
    assert spec == (("data",), ("model",)) == P(("data",), ("model",))


def test_multi_pod_fsdp_uses_both_axes():
    spec = R.spec_for((2048, 8192), ("embed", "mlp"), MULTI, "train")
    assert spec == P(("pod", "data"), ("model",))


def test_gqa_fallback_to_head_dim():
    spec = R.spec_for((5120, 8, 128), ("embed", "kv_heads", "head"),
                      SINGLE, "train")
    assert spec == P(("data",), None, ("model",))


def test_divisible_heads_take_model():
    spec = R.spec_for((6144, 48, 128), ("embed", "heads", "head"),
                      SINGLE, "train")
    assert spec == P(("data",), ("model",), None)


def test_expert_fallback_to_mlp():
    spec = R.spec_for((8, 6144, 32768), ("experts", "embed", "mlp"),
                      SINGLE, "train")
    assert spec == P(None, ("data",), ("model",))


def test_expert_parallel_when_divisible():
    spec = R.spec_for((16, 5120, 8192), ("experts", "embed", "mlp"),
                      SINGLE, "train")
    assert spec == P(("model",), ("data",), None)


def test_mesh_axis_never_reused_within_tensor():
    spec = R.spec_for((2048, 2048), ("mlp", "mlp2"), SINGLE, "train")
    flat = [a for part in spec if part for a in part]
    assert len(flat) == len(set(flat))


def test_non_divisible_dim_left_unsharded():
    spec = R.spec_for((7, 100), ("batch", "embed"), SINGLE, "train")
    assert spec == P(None, None)


def test_rank1_gated():
    spec = R.spec_for((2048,), ("embed",), SINGLE, "train", min_shard_rank=2)
    assert spec == P() == ()


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kv_cache_axes():
    cache = {"k": _meta((16, 128, 1024, 8, 128), torch.bfloat16),
             "pos": _meta((), torch.int32)}
    axes = R.cache_logical_axes(cache)
    assert axes["k"] == ("layers", "cache_batch", "cache_seq", "kv_heads",
                         "head")
    assert axes["pos"] == ()


def test_rwkv_state_axes():
    axes = R.cache_logical_axes({"wkv": _meta((32, 1, 40, 64, 64),
                                              torch.float32)})
    assert axes["wkv"] == ("layers", "cache_batch", "rwkv_heads", "rwkv_k",
                           None)


def test_batch_axes():
    axes = R.batch_logical_axes({"tokens": _meta((256, 4096), torch.int32)})
    assert axes["tokens"] == ("batch", None)


# ---------------------------------------------- every arch, every leaf --

@pytest.mark.parametrize("switch", list(SWITCHES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_tree_shardings_equal_the_reference(arch, mesh, switch, monkeypatch,
                                            reference_specs):
    """Parameters (float and 7-bit abstract codes), the AdamW state,
    ``input_specs`` of every shape and the family's abstract cache at
    each decode shape: the port's specs ``==`` the reference's, leaf for
    leaf, in ``train`` and ``serve`` mode."""
    _switch(monkeypatch, switch)
    m = MESHES[mesh]
    jcfg, cfg, japi, tapi = _trees(arch)
    jaxes, axes = jax_logical_axes(japi.specs), tapi.logical_axes()
    for mode, jdt, dt in (("train", "float32", torch.float32),
                          ("serve", "bfloat16", torch.bfloat16)):
        jp = jax_abstract_params(japi.specs, jdt)
        tp = tapi.abstract_params(dt)
        _assert_same(R.tree_shardings(tp, axes, m, mode),
                     JR.tree_shardings(jp, jaxes, m, mode), (mode, "params"))
        jq, jqa = jll.abstract_quantize(jp, jaxes, bits=7)
        tq, tqa = ll.abstract_quantize(tp, axes, bits=7)
        _assert_same(R.tree_shardings(tq, tqa, m, mode),
                     JR.tree_shardings(jq, jqa, m, mode), (mode, "quant"))
        jo, to = jadamw.abstract_state(jp), adamw.abstract_state(tp)
        for field in ("mu", "nu"):
            _assert_same(
                R.tree_shardings(getattr(to, field), axes, m, mode),
                JR.tree_shardings(getattr(jo, field), jaxes, m, mode),
                (mode, field))
        assert R.tree_shardings(to.step, (), m, mode) == \
            JR.tree_shardings(jo.step, (), m, mode)
        for name, shape in SHAPES_BY_NAME.items():
            jb = jax_api.input_specs(jcfg, JAX_SHAPES[name])
            tb = api.input_specs(cfg, shape)
            _assert_same(
                R.tree_shardings(tb, R.batch_logical_axes(tb), m, mode,
                                 params_rank_gate=False),
                JR.tree_shardings(jb, JR.batch_logical_axes(jb), m, mode,
                                  params_rank_gate=False), (mode, name))
    for name in ("decode_32k", "long_500k"):
        jc, tc = _caches(jcfg, cfg, japi, tapi, SHAPES_BY_NAME[name])
        _assert_same(
            R.tree_shardings(tc, R.cache_logical_axes(tc), m, "serve",
                             params_rank_gate=False),
            JR.tree_shardings(jc, JR.cache_logical_axes(jc), m, "serve",
                              params_rank_gate=False), ("cache", name))


def _caches(jcfg, cfg, japi, tapi, shape, dtype="bfloat16"):
    b, s = shape.global_batch, shape.seq_len
    kw = {"enc_len": min(s, 4096)} if cfg.family == "encdec" else {}
    jc = japi.abstract_cache(jcfg, b, s, dtype=dtype, **kw)
    tc = tapi.abstract_cache(cfg, b, s, dtype=getattr(torch, dtype), **kw)
    return jc, tc


# ---------------------------------------------------- abstract helpers --

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_helpers_equal_the_reference(arch):
    """Shapes and dtypes: ``abstract_params`` (the config's dtype,
    float32 and bfloat16), ``param_count``, ``abstract_quantize`` (and
    its axes tree), ``adamw.abstract_state``, ``input_specs`` of every
    shape and ``abstract_cache`` in bfloat16 and float8 at each shape's
    batch and length; every leaf on the ``meta`` device."""
    jcfg, cfg, japi, tapi = _trees(arch)
    assert tapi.param_count() == japi.param_count()
    assert tapi.logical_axes() == jax_logical_axes(japi.specs)
    for jdt, dt in ((None, None), ("float32", torch.float32),
                    ("bfloat16", torch.bfloat16)):
        jp, tp = japi.abstract_params(jdt), tapi.abstract_params(dt)
        _assert_sd(tp, jp,
                     ("params", jdt))
        assert all(t.device.type == "meta" for t in T.leaves(tp))
    jaxes = jax_logical_axes(japi.specs)
    jq, jqa = jll.abstract_quantize(jp, jaxes, bits=7)
    tq, tqa = ll.abstract_quantize(tp, tapi.logical_axes(), bits=7)
    _assert_sd(tq, jq,
                 "abstract_quantize")
    assert tqa == jqa
    jo, to = jadamw.abstract_state(jp), adamw.abstract_state(tp)
    _assert_sd(to, jo,
                 "abstract_state")
    for name, shape in SHAPES_BY_NAME.items():
        jb = jax_api.input_specs(jcfg, JAX_SHAPES[name])
        tb = api.input_specs(cfg, shape)
        assert sorted(tb) == sorted(jb)
        _assert_sd(tb, jb,
                     ("inputs", name))
        for dtype in ("bfloat16", "float8_e4m3fn"):
            jc, tc = _caches(jcfg, cfg, japi, tapi, shape, dtype)
            _assert_sd(tc, jc, ("cache", name))


def test_mesh_shapes_and_the_ambient_mesh():
    """The production meshes' shapes and axis names; ``use_mesh`` nests
    and restores; ``make_host_mesh`` asks for a process group."""
    single = tmesh.make_production_mesh(plain=True)
    multi = tmesh.make_production_mesh(multi_pod=True, plain=True)
    assert single.shape == SINGLE.shape and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert tmesh.get_abstract_mesh() is None
    with tmesh.use_mesh(single):
        with tmesh.use_mesh(multi):
            assert tmesh.get_abstract_mesh() is multi
        assert tmesh.get_abstract_mesh() is single
    assert tmesh.get_abstract_mesh() is None
    assert R.spec_for((2048, 8192), ("embed", "mlp"), single) == \
        R.spec_for((2048, 8192), ("embed", "mlp"), SINGLE)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh()
