"""The three other dense decoders the port registers -- olmo-1b
(non-parametric LayerNorm), minicpm-2b (head_dim 64 at full width, an
odd vocabulary) and qwen3-14b (untied unembedding, g 5) -- against the
JAX package, on the CPU, at their tiny sizes.

Both sides hold the same weights (the reference's params converted with
``params_from_jax``).  Tolerances: float32 compute, logits within 2e-5
of their scale (the model tests' bound), the norms within 1e-5; in
bfloat16 one bfloat16 step of the scale, since the two sides sum in
other orders before the one rounding.  Greedy streams through the
Engine (prefix cache off on both sides) must be equal.  minicpm-2b tiny
has head_dim 18, which only the plain versions take: the CPU path runs
them anyway.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core import lama_layers as jll
from repro.models import api as jax_api
from repro.models import layers as jlayers
from repro.runtime.engine import Request as JaxRequest
from repro.runtime.server import InferenceServer as JaxServer
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api as torch_api
from repro_torch.models import layers as tlayers
from repro_torch.runtime.server import InferenceServer, Request

NAMES = ("olmo-1b", "minicpm-2b", "qwen3-14b")
LOGITS_TOL = 2e-5
BF16_STEP = 2.0 ** -8


def _cfgs(name, compute="float32"):
    return (jax_get_config(name, tiny=True).replace(compute_dtype=compute),
            get_config(name, tiny=True).replace(compute_dtype=compute))


@functools.lru_cache(maxsize=None)
def _params(name, quant_bits=None):
    """The reference's weights (seed 0) and the port's copy of them; with
    ``quant_bits`` the untied ``unembed.out`` quantized (the rest stays
    float: the other layers' codes have tests of their own)."""
    jcfg, cfg = _cfgs(name)
    api = jax_api.get_model(jcfg)
    params = api.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant_bits is not None:
        params, _ = jll.quantize_tree(
            params, quant_bits, axes=api.logical_axes(),
            predicate=lambda key, leaf: "unembed" in str(key))
        assert jll.eq.is_qtensor(params["unembed"]["out"])
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    return params, model


def _close(a, ref, tol):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(a, np.float32), ref, rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize("name", NAMES)
def test_configs_are_the_reference_configs(name):
    assert name in ARCH_NAMES
    for tiny in (False, True):
        assert (dataclasses.asdict(get_config(name, tiny=tiny))
                == dataclasses.asdict(jax_get_config(name, tiny=tiny)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nonparam_ln_matches_the_reference(dtype):
    jcfg, cfg = _cfgs("olmo-1b")
    assert tlayers.norm_specs(cfg) == {}
    x = np.random.default_rng(0).normal(size=(2, 5, cfg.d_model)) * 3 + 0.5
    jx = jnp.asarray(x, dtype)
    ref = jlayers.apply_norm({}, jx, jcfg)
    out = tlayers.apply_norm({}, torch.from_numpy(
        np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype)), cfg)
    assert out.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else BF16_STEP
    _close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), tol)


@pytest.mark.parametrize("quant", [None, 7])
def test_untied_logits_round_to_the_compute_dtype(quant):
    """qwen3-14b's ``unembed.out`` in bfloat16 compute: the logits are
    rounded to bfloat16 before float32, as the reference's; a 7-bit
    table runs the plain-layout LUT GEMM."""
    jcfg, cfg = _cfgs("qwen3-14b", compute="bfloat16")
    params, model = _params("qwen3-14b", quant)
    assert "unembed" in params and "out" in params["unembed"]
    x = np.random.default_rng(1).normal(size=(2, 3, cfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jlayers.logits_fn(params, jx, jcfg))
    out = tlayers.logits_fn(model, torch.from_numpy(
        np.array(jx.astype(jnp.float32))).to(torch.bfloat16), cfg)
    assert out.dtype == torch.float32 and out.shape == (2, 3, cfg.vocab_size)
    assert torch.equal(out, out.to(torch.bfloat16).float())
    _close(out.numpy(), ref, BF16_STEP)


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_equal_the_reference(name):
    jcfg, cfg = _cfgs(name)
    params, model = _params(name)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
    toks = toks.astype(np.int32)
    ref, _ = jax_api.get_model(jcfg).forward(params, jnp.asarray(toks), jcfg)
    out, _ = torch_api.get_model(cfg).forward(model, torch.from_numpy(toks),
                                              cfg)
    _close(out.numpy(), ref, LOGITS_TOL)


def _requests(cfg, cls):
    lens, news = (8, 20, 13), (6, 4, 8)
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("name", NAMES)
def test_engine_streams_equal_the_reference(name):
    jcfg, cfg = _cfgs(name)
    params, model = _params(name)
    kw = dict(num_slots=3, block_size=8, max_len=64)
    ref = JaxServer(jcfg, params=params, prefix_cache=False,
                    **kw).generate(_requests(jcfg, JaxRequest))
    out = InferenceServer(cfg, params=model, device="cpu",
                          **kw).generate(_requests(cfg, Request))
    for a, b in zip(ref, out):
        assert b.status == "ok"
        np.testing.assert_array_equal(b.tokens, a.tokens)
