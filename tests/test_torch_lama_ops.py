"""The port's Lama primitives against the JAX package's, on the CPU: the
bulk LUT operation and the vector-matrix product of Fig. 2
(``lama_bulk_op``, ``lama_vector_matrix``), the signed exponent
histogram and Eq. 1's term-1 counters (``exp_histogram``,
``term1_counts``), the counting oracles of ``core/exponent_dotprod``
and the LUT helpers and plans of ``core/lut``.

Inputs are made with numpy from a seed and handed to both sides; the
reference's kernels run in interpret mode.  Integer results and the
histograms (sums of +-1 in float32, exact) must be equal; the float
dot products within 1e-5 (another summation order).
"""

import itertools

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import jax.numpy as jnp

from repro.core import exponent_dotprod as jed
from repro.core import exponential_quant as jeq
from repro.core import lut as jlut
from repro.kernels.exp_histogram import exp_histogram as jax_exp_histogram
from repro.kernels.exp_histogram import term1_counts as jax_term1_counts
from repro.kernels.lama_bulk_op import lama_bulk_op as jax_lama_bulk_op
from repro.kernels.lama_bulk_op import lama_vector_matrix as jax_vector_matrix
from repro_torch.core import exponent_dotprod as ed
from repro_torch.core import exponential_quant as eq
from repro_torch.core import lut
from repro_torch.kernels.exp_histogram import exp_histogram, term1_counts
from repro_torch.kernels.lama_bulk_op import lama_bulk_op, lama_vector_matrix

T = torch.from_numpy


# ------------------------------------------------------ lama_bulk_op --

@pytest.mark.parametrize("bits,g,m", [(4, 4, 128), (4, 16, 256), (6, 8, 512),
                                      (8, 2, 128), (8, 3, 37)])
def test_lama_bulk_op_matches_reference_kernel(bits, g, m):
    r = np.random.default_rng(g * m)
    a = r.integers(0, 2 ** bits, g).astype(np.int32)
    b = r.integers(0, 2 ** bits, (g, m)).astype(np.int32)
    ref = jax_lama_bulk_op(jnp.asarray(a), jnp.asarray(b),
                           jlut.mul_lut(bits, jnp.int32))
    out = lama_bulk_op(T(a), T(b), lut.mul_lut(bits, torch.int32))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if bits == 8:     # uint8 vector codes, as the kernel reads them
        out8 = lama_bulk_op(T(a), T(b.astype(np.uint8)),
                            lut.mul_lut(bits, torch.int32))
        np.testing.assert_array_equal(out8.numpy(), np.asarray(ref))


def test_lama_bulk_op_arbitrary_function_table():
    """Any two-operand f pre-stored as a table (paper §IV)."""
    r = np.random.default_rng(3)
    a = r.integers(0, 32, 6).astype(np.int32)
    b = r.integers(0, 32, (6, 128)).astype(np.int32)
    jt = jlut.build_lut(lambda x, y: (x + y) ** 2 % 251, 5, 5, jnp.int32)
    tt = lut.build_lut(lambda x, y: (x + y) ** 2 % 251, 5, 5, torch.int32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    ref = jax_lama_bulk_op(jnp.asarray(a), jnp.asarray(b), jt)
    np.testing.assert_array_equal(lama_bulk_op(T(a), T(b), tt).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("a,b", [([0, 16], [[1, 2], [3, 4]]),
                                 ([0, -1], [[1, 2], [3, 4]]),
                                 ([0, 1], [[1, 2], [16, 4]])])
def test_lama_bulk_op_raises_on_codes_outside_the_table(a, b):
    """The reference's gather clips such codes silently; the port
    raises."""
    with pytest.raises(ValueError, match="outside the table"):
        lama_bulk_op(torch.tensor(a, dtype=torch.int32),
                     torch.tensor(b, dtype=torch.int32),
                     lut.mul_lut(4, torch.int32))


@pytest.mark.parametrize("bits,k,n", [(4, 5, 128), (8, 9, 200)])
def test_lama_vector_matrix_matches_reference(bits, k, n):
    r = np.random.default_rng(bits + k)
    v = r.integers(0, 2 ** bits, k).astype(np.int32)
    m = r.integers(0, 2 ** bits, (k, n)).astype(np.int32)
    ref = jax_vector_matrix(jnp.asarray(v), jnp.asarray(m), bits)
    out = lama_vector_matrix(T(v), T(m), bits)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        lut.vector_matrix_via_lut(T(v), T(m), bits).numpy(),
        np.asarray(jlut.vector_matrix_via_lut(jnp.asarray(v), jnp.asarray(m),
                                              bits)))


@settings(deadline=None, max_examples=20)
@given(seed=st.integers(0, 2 ** 16), bits=st.sampled_from([4, 5, 8]))
def test_property_vector_matrix_exact(seed, bits):
    r = np.random.default_rng(seed)
    k, n = int(r.integers(2, 12)), int(r.integers(1, 300))
    v = r.integers(0, 2 ** bits, k).astype(np.int32)
    m = r.integers(0, 2 ** bits, (k, n)).astype(np.int32)
    out = lama_vector_matrix(T(v), T(m), bits)
    np.testing.assert_array_equal(out.numpy(), v @ m)


# ----------------------------------------------------- exp_histogram --

@pytest.mark.parametrize("g,m,bins", [(8, 512, 64), (16, 1024, 128),
                                      (1, 512, 16), (24, 2048, 256),
                                      (5, 37, 255)])
def test_exp_histogram_matches_reference_kernel(g, m, bins):
    r = np.random.default_rng(g + m + bins)
    vals = r.integers(0, bins, (g, m)).astype(np.int32)
    signs = r.choice([-1.0, 1.0], (g, m)).astype(np.float32)
    ref = jax_exp_histogram(jnp.asarray(vals), jnp.asarray(signs), bins)
    out = exp_histogram(T(vals), T(signs), bins)
    assert out.dtype == torch.float32 and out.shape == (g, bins)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@settings(deadline=None, max_examples=20)
@given(seed=st.integers(0, 2 ** 16))
def test_property_total_count_conserved(seed):
    """Sum over bins == signed element count (term 4 of Eq. 1)."""
    r = np.random.default_rng(seed)
    vals = T(r.integers(0, 32, (8, 100)).astype(np.int32))
    signs = T(r.choice([-1.0, 1.0], (8, 100)).astype(np.float32))
    h = exp_histogram(vals, signs, 32)
    assert torch.equal(h.sum(1), signs.sum(1))


def _codes(seed, shape, bits, scale, base=None):
    """Port-quantized codes and params, and the same params for the
    reference; ``base`` shares a quantizer's base (as Eq. 1 needs)."""
    x = T((np.random.default_rng(seed).normal(size=shape) * scale)
          .astype(np.float32))
    p = eq.fit(x, bits)
    if base is not None:
        p = eq.ExpQuantParams(p.alpha, p.beta, base, bits)
    jp = jeq.ExpQuantParams(jnp.float32(p.alpha.item()),
                            jnp.float32(p.beta.item()),
                            jnp.float32(p.base.item()), bits)
    return eq.encode(x, p), p, jp


@pytest.mark.parametrize("bits_a,bits_w", [(7, 7), (5, 4), (8, 8)])
def test_term1_counts_matches_reference_and_eq1(bits_a, bits_w):
    ca, pa, jpa = _codes(0, (6, 96), bits_a, 0.1)
    cw, pw, jpw = _codes(1, (6, 96), bits_w, 0.02, base=pa.base)
    ref = jax_term1_counts(jnp.asarray(ca.numpy()), jpa,
                           jnp.asarray(cw.numpy()), jpw)
    out = term1_counts(ca, pa, cw, pw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # row g is T1's histogram of e_A + e_W (shifted to start at 0)
    sa, ea = eq.split_code(ca, pa)
    sw, ew = eq.split_code(cw, pw)
    for g in range(2):
        hist = ed.signed_histogram(ea[g] + ew[g], (sa[g] * sw[g]).float(),
                                   pa.e_min + pw.e_min, pa.e_max + pw.e_max)
        assert torch.equal(out[g], hist)


# -------------------------------------------------- exponent_dotprod --

@pytest.mark.parametrize("bits_a,bits_w",
                         list(itertools.product([3, 5, 7], [4, 6])))
def test_counting_dot_matches_reference(bits_a, bits_w):
    ca, pa, jpa = _codes(2, (256,), bits_a, 0.1)
    cw, pw, jpw = _codes(3, (256,), bits_w, 0.02, base=pa.base)
    ref = float(jed.counting_dot(jnp.asarray(ca.numpy()), jpa,
                                 jnp.asarray(cw.numpy()), jpw))
    out = float(ed.counting_dot(ca, pa, cw, pw))
    assert abs(out - ref) <= 1e-5 * max(1.0, abs(ref))
    deq = float(ed.dequant_matmul(ca[None], pa, cw[:, None], pw))
    assert abs(out - deq) <= 1e-4 * (abs(deq) + 1.0)


def test_counting_and_dequant_matmul_match_reference():
    ca, pa, jpa = _codes(4, (6, 32), 5, 0.1)
    cw, pw, jpw = _codes(5, (32, 5), 5, 0.05, base=pa.base)
    jargs = (jnp.asarray(ca.numpy()), jpa, jnp.asarray(cw.numpy()), jpw)
    for port_fn, ref_fn in ((ed.counting_matmul, jed.counting_matmul),
                            (ed.dequant_matmul, jed.dequant_matmul)):
        ref = np.asarray(ref_fn(*jargs))
        out = port_fn(ca, pa, cw, pw).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))
    assert ed.unique_exponent_count(pa, pw) == jed.unique_exponent_count(jpa, jpw)


# ---------------------------------------------------------------- lut --

def test_lut_tables_and_plans_match_reference():
    for bits in (4, 5, 6, 7, 8):
        np.testing.assert_array_equal(lut.mul_lut(bits).numpy(),
                                      np.asarray(jlut.mul_lut(bits)))
        np.testing.assert_array_equal(lut.numpy_mul_lut(bits),
                                      jlut.numpy_mul_lut(bits))
        assert lut.lama_parallelism(bits) == jlut.lama_parallelism(bits)
        assert lut.icas_per_retrieval(bits) == jlut.icas_per_retrieval(bits)
        assert lut.masking_msbs(bits) == jlut.masking_msbs(bits)
        for k, n in ((4, 100), (4096, 8192), (7, 1025)):
            assert (tuple(lut.plan_vector_matrix(k, n, bits))
                    == tuple(jlut.plan_vector_matrix(k, n, bits)))
    assert (tuple(lut.plan_vector_matrix(8, 3000, 8, row_elems=512,
                                         parallel_degree=3))
            == tuple(jlut.plan_vector_matrix(8, 3000, 8, row_elems=512,
                                             parallel_degree=3)))
    with pytest.raises(ValueError):
        lut.lama_parallelism(3)
    r = np.random.default_rng(0)
    table = lut.mul_lut(6)
    a, b = r.integers(0, 64, (2, 50)).astype(np.int32)
    np.testing.assert_array_equal(
        lut.lut_apply(table, T(a), T(b)).numpy(),
        np.asarray(jlut.lut_apply(jnp.asarray(table.numpy()), jnp.asarray(a),
                                  jnp.asarray(b))))
    np.testing.assert_array_equal(
        lut.coalesced_apply(table, torch.tensor(5), T(b)).numpy(),
        np.asarray(jlut.coalesced_apply(jnp.asarray(table.numpy()),
                                        jnp.asarray(5), jnp.asarray(b))))
