"""The port's DNA-TEQ quantizer against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both implementations.
Exactness: the code format, the decode table (the reference's float32
``pow`` is correctly rounded, and the port reproduces it), ``encode``
and ``encode_meta`` are held to bit equality.  ``decode_meta`` and the
fit go through ``exp``/``log``, which XLA's CPU backend computes with
its own approximations (an ulp off a correctly rounded result in a few
percent of inputs), so they are held to stated tolerances.
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
from repro_torch.configs import get_config
from repro_torch.core import exponential_quant as teq
from repro_torch.core import lama_layers as tll
from repro_torch.models import api as torch_api

TINY = dict(num_layers=2, d_model=64, d_ff=128, compute_dtype="float32")


def _x(seed, shape=(96, 80), scale=0.05, zero=False):
    x = (np.random.default_rng(seed).normal(size=shape) * scale)
    x = x.astype(np.float32)
    if zero:
        x.flat[17] = 0.0
    return x


def _tparams(jp) -> teq.ExpQuantParams:
    return teq.ExpQuantParams(torch.tensor(np.float32(jp.alpha)),
                              torch.tensor(np.float32(jp.beta)),
                              torch.tensor(np.float32(jp.base)), jp.bits)


@pytest.mark.parametrize("seed,bits", [(0, 7), (1, 7), (2, 4)])
def test_code_format_bit_exact(seed, bits):
    """decode_table, encode, pack_qmeta and encode_meta agree bit for
    bit under the same parameters."""
    x = _x(seed)
    jp = jeq.fit(jnp.asarray(x), bits)
    tp = _tparams(jp)
    np.testing.assert_array_equal(np.asarray(jeq.decode_table(jp)),
                                  teq.decode_table(tp).numpy())
    np.testing.assert_array_equal(np.asarray(jeq.encode(jnp.asarray(x), jp)),
                                  teq.encode(torch.from_numpy(x), tp).numpy())
    qm = np.array(jeq.pack_qmeta(jp))
    np.testing.assert_array_equal(teq.pack_qmeta(tp).numpy(), qm)
    np.testing.assert_array_equal(
        np.asarray(jeq.encode_meta(jnp.asarray(x), jnp.asarray(qm))),
        teq.encode_meta(torch.from_numpy(x), torch.from_numpy(qm)).numpy())


def test_encode_meta_per_head_broadcast_bit_exact():
    """A per-head ``[n_kv, 1, 4]`` qmeta broadcasts against
    ``[..., n_kv, hd]`` the same way on both sides."""
    x = _x(3, shape=(5, 2, 16))
    metas = []
    for h in range(2):
        metas.append(np.asarray(jeq.pack_qmeta(
            jeq.fit(jnp.asarray(x[:, h]), 7))))
    qm = np.stack(metas)[:, None, :]
    np.testing.assert_array_equal(
        np.asarray(jeq.encode_meta(jnp.asarray(x), jnp.asarray(qm))),
        teq.encode_meta(torch.from_numpy(x), torch.from_numpy(qm)).numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_meta_within_tolerance(seed):
    """ALU decode ``sign*(alpha*exp(e*log(base))+beta)``: the two
    libraries' log differs by an ulp and ``e`` (|e| <= 64) multiplies
    that before the exp, so each entry is held to 1e-6 of
    ``|alpha*base**e| + |beta|`` (about eight float32 ulps)."""
    jp = jeq.fit(jnp.asarray(_x(seed)), 7)
    qm = np.array(jeq.pack_qmeta(jp))
    codes = np.arange(256, dtype=np.uint8)
    jd = np.asarray(jeq.decode_meta(jnp.asarray(codes), jnp.asarray(qm)))
    td = teq.decode_meta(torch.from_numpy(codes), torch.from_numpy(qm)).numpy()
    e = (codes & 0x7F).astype(np.float64) - 64
    scale = (np.abs(qm[0] * np.float64(qm[2]) ** e) + abs(qm[1]))
    assert np.all(np.abs(jd - td) <= 1e-6 * scale)


@pytest.mark.parametrize("seed,bits,zero", [(0, 7, False), (1, 7, False),
                                            (2, 4, False), (0, 7, True)])
def test_fit_matches_reference(seed, bits, zero):
    """Same base, alpha and beta within rtol 1e-4 (the fit runs exp/log
    in float32 for 6 iterations).  ``zero=True`` puts one exact zero in
    the tensor: the reference's percentile of ``where(mag > 0, mag,
    nan)`` is then NaN and the fit starts from lo=1e-6, hi=1.0 --
    reproduced, not "fixed"."""
    x = _x(seed, zero=zero)
    jp = jeq.fit(jnp.asarray(x), bits)
    tp = teq.fit(torch.from_numpy(x), bits)
    assert float(tp.base) == float(jp.base)
    np.testing.assert_allclose(float(tp.alpha), float(jp.alpha), rtol=1e-4)
    np.testing.assert_allclose(float(tp.beta), float(jp.beta), rtol=1e-4,
                               atol=1e-4 * abs(float(jp.alpha)))
    np.testing.assert_allclose(float(teq.sqnr_db(torch.from_numpy(x), tp)),
                               float(jeq.sqnr_db(jnp.asarray(x), jp)),
                               rtol=1e-4)


def test_percentile_nan_path_changes_the_start():
    """The zero really takes the NaN path: a tensor without the zero
    starts elsewhere (both sides agree on either start)."""
    x = _x(4)
    lo, hi = teq._init_range(torch.from_numpy(np.abs(x)).reshape(1, -1))
    xz = _x(4, zero=True)
    loz, hiz = teq._init_range(torch.from_numpy(np.abs(xz)).reshape(1, -1))
    assert float(loz) == np.float32(1e-6) and float(hiz) == 1.0
    assert float(lo) != float(loz)
    ref = np.percentile(np.abs(x).reshape(-1), [1.0, 99.5])
    np.testing.assert_allclose([float(lo), float(hi)], ref, rtol=1e-5)


def test_quantize_tree_matches_reference():
    """Tiny qwen3 params: the same leaves quantize, per layer for the
    stacked ones, and codes agree except at rounding boundaries -- at
    most 1e-4 of all codes differ, each by one step of the biased
    exponent with the same sign bit."""
    jcfg = jax_get_config("qwen3-1.7b", tiny=True).replace(**TINY)
    cfg = get_config("qwen3-1.7b", tiny=True).replace(**TINY)
    japi = jax_api.get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    jq, jrep = jll.quantize_tree(jparams, 7, axes=japi.logical_axes())

    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node))

    tq, trep = tll.quantize_tree(to_torch(jparams), 7,
                                 axes=torch_api.get_model(cfg).logical_axes())
    assert set(trep) == set(jrep)
    total = differ = 0
    for path in jrep:
        jleaf, tleaf = jq, tq
        for k in path:
            jleaf, tleaf = jleaf[k], tleaf[k]
        assert isinstance(tleaf, teq.QWeight)
        jc = np.asarray(jleaf["codes"]).astype(np.int16)
        tc = tleaf.codes.numpy().astype(np.int16)
        assert jc.shape == tc.shape
        np.testing.assert_array_equal(tc >> 7, jc >> 7)
        assert np.abs(tc - jc).max() <= 1
        total += jc.size
        differ += int((tc != jc).sum())
        np.testing.assert_array_equal(tleaf.qmeta.numpy()[..., 2],
                                      np.asarray(jleaf["qmeta"])[..., 2])
        # alpha and beta agree to rtol 1e-4 (see the fit test), so the
        # tables agree to 1e-4 of their largest entry
        jl = np.asarray(jleaf["lut"])
        np.testing.assert_allclose(tleaf.lut.numpy(), jl, rtol=0,
                                   atol=1e-4 * np.abs(jl).max())
        np.testing.assert_allclose(trep[path][1], jrep[path][1], rtol=1e-4)
    assert differ <= 1e-4 * total, (differ, total)
