"""The port's LUT-dequant matmuls (plain versions, which the CPU path
runs) against the JAX package's Pallas kernels in interpret mode.

Inputs and weights come from numpy seeds; weights are quantized by the
reference (its codes, tables and metas feed both sides).  Tolerance:
float32 rtol/atol 1e-5 -- both sides compute a float32 matmul of the
same decoded values and differ only in summation order (and, for the
ALU decode, in an ulp of exp/log).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import exponential_quant as jeq
from repro.core import lama_layers as jll
from repro.kernels.lut_dequant_matmul import ops as jops
from repro_torch.core import exponential_quant as teq
from repro_torch.core import lama_layers as tll
from repro_torch.kernels import _build
from repro_torch.kernels.lut_dequant_matmul import ops as tops

RTOL = ATOL = 1e-5


def _weight(seed, shape):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    codes, p = jeq.quantize(jnp.asarray(w * 0.05), 7)
    return (np.array(codes), np.array(jeq.decode_table(p)),
            np.array(jeq.pack_qmeta(p)))


def _t(a):
    return torch.from_numpy(np.array(a))


# (m, k, n, transpose_codes, decode_mode, epilogue, bias): plain and
# transposed codes, gather and ALU decode, bias, every epilogue, and
# ragged M/K/N (the reference pads to its tiles; the port must not)
CASES = [
    (8, 128, 128, False, "gather", None, False),
    (5, 40, 24, False, "gather", "gelu", True),
    (5, 40, 24, True, "gather", None, False),
    (17, 130, 70, True, "alu", "silu", True),
    (3, 72, 200, False, "alu", "relu", False),
    (16, 64, 48, False, "gather", "silu", False),
    (9, 96, 33, True, "gather", "relu", True),
]


@pytest.mark.parametrize("m,k,n,trans,mode,epi,has_bias", CASES)
def test_lut_dequant_matmul_matches_kernel(m, k, n, trans, mode, epi,
                                          has_bias):
    rng = np.random.default_rng(m * 1000 + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    codes, lut, qmeta = _weight(n, (n, k) if trans else (k, n))
    bias = rng.normal(size=(n,)).astype(np.float32) if has_bias else None
    ref = jops.lut_dequant_matmul(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(lut),
        jnp.asarray(qmeta), decode_mode=mode, epilogue=epi,
        bias=None if bias is None else jnp.asarray(bias),
        transpose_codes=trans, out_dtype=jnp.float32)
    out = tops.lut_dequant_matmul(
        _t(x), _t(codes), _t(lut), _t(qmeta), decode_mode=mode, epilogue=epi,
        bias=None if bias is None else _t(bias), transpose_codes=trans,
        out_dtype=torch.float32)
    assert out.shape == (m, n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("m,k,n,mode,act", [
    (8, 128, 128, "gather", "silu"),
    (5, 40, 72, "alu", "gelu"),
    (11, 70, 24, "gather", "relu"),
])
def test_lut_dequant_matmul_gated_matches_kernel(m, k, n, mode, act):
    x = np.random.default_rng(m).normal(size=(m, k)).astype(np.float32)
    cg, lg, qg = _weight(1, (k, n))
    cu, lu, qu = _weight(2, (k, n))
    ref = jops.lut_dequant_matmul_gated(
        jnp.asarray(x), jnp.asarray(cg), jnp.asarray(cu), jnp.asarray(lg),
        jnp.asarray(lu), jnp.asarray(qg), jnp.asarray(qu), activation=act,
        decode_mode=mode, out_dtype=jnp.float32)
    out = tops.lut_dequant_matmul_gated(
        _t(x), _t(cg), _t(cu), _t(lg), _t(lu), _t(qg), _t(qu),
        activation=act, decode_mode=mode, out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_out_dtype_follows_x_and_cpu_never_counts_a_launch():
    """bf16 x gives a bf16 result by default (the reference's wrapper
    rule); the CPU path runs the plain version and counts no launch."""
    codes, lut, qmeta = _weight(0, (32, 16))
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    before = _build.launch_counts()
    out = tops.lut_dequant_matmul(x.to(torch.bfloat16), _t(codes), _t(lut))
    assert out.dtype == torch.bfloat16
    assert _build.launch_counts() == before


# the specs the decoder uses: q/k/v projections, the output projection,
# and the tied unembedding (the kernel's transposed-codes layout)
SPECS = {"bsd,dnh->bsnh": ((2, 3, 32), (32, 4, 8)),
         "bsnh,nhd->bsd": ((2, 3, 4, 8), (4, 8, 32)),
         "bsd,vd->bsv": ((2, 1, 32), (50, 32))}


@pytest.mark.parametrize("mode", ["gather", "alu"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_dense_general_dispatch_matches_reference(spec, mode):
    """``dense_general`` canonicalizes the einsum to the fused kernel
    (codes reshaped, or transposed in-kernel) the same way on both
    sides, under either decode mode."""
    xshape, wshape = SPECS[spec]
    x = np.random.default_rng(7).normal(size=xshape).astype(np.float32)
    codes, lut, qmeta = _weight(8, wshape)
    jw = {"codes": jnp.asarray(codes), "lut": jnp.asarray(lut),
          "qmeta": jnp.asarray(qmeta)}
    with jll.policy(decode_mode=mode):
        ref = jll.dense_general(jnp.asarray(x), jw, spec)
    with tll.policy(decode_mode=mode):
        out = tll.dense_general(_t(x), teq.QWeight(_t(codes), _t(lut),
                                                   _t(qmeta)), spec)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_gated_mlp_and_embed_lookup_match_reference():
    x = np.random.default_rng(9).normal(size=(2, 3, 32)).astype(np.float32)
    parts = [_weight(s, (32, 48)) for s in (10, 11)]
    jws = [{"codes": jnp.asarray(c), "lut": jnp.asarray(l),
            "qmeta": jnp.asarray(q)} for c, l, q in parts]
    tws = [teq.QWeight(_t(c), _t(l), _t(q)) for c, l, q in parts]
    ref = jll.gated_mlp(jnp.asarray(x), jws[0], jws[1], "silu")
    out = tll.gated_mlp(_t(x), tws[0], tws[1], "silu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    idx = np.asarray([[0, 5, 31], [7, 7, 2]], np.int32)
    np.testing.assert_array_equal(
        tll.embed_lookup(tws[0], _t(idx), torch.float32).numpy(),
        np.asarray(jll.embed_lookup(jws[0], jnp.asarray(idx), jnp.float32)))
