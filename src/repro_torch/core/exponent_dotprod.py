"""Eq. 1 of the paper: exponent-domain dot products by counting (port of
the JAX package's ``core/exponent_dotprod.py``).

With ``A_i = S_Ai (aA * b**eA_i + bA)``, ``W_i = S_Wi (aW * b**eW_i +
bW)`` and ``s_i = S_Ai * S_Wi`` the dot product is four counting terms:

    T1 = aA*aW * sum_i s_i b**(eA_i + eW_i)
    T2 = aW*bA * sum_i s_i b**(eW_i)
    T3 = aA*bW * sum_i s_i b**(eA_i)
    T4 = bA*bW * sum_i s_i

:func:`counting_dot` / :func:`counting_matmul` are the paper's form
(signed histograms of exponents, then the power tables), and
:func:`dequant_matmul` decodes both operands and multiplies; the two are
algebraically identical.  Plain PyTorch, as the reference is plain jnp:
these are oracles, and the tests hold ``term1_counts`` (kernel #11) to
T1's histogram with them.
"""

from __future__ import annotations

import torch

from repro_torch.core.exponential_quant import ExpQuantParams, decode, split_code

F32 = torch.float32


def _power_table(base: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``[hi-lo+1]`` table of base**k for k in [lo, hi]."""
    ks = torch.arange(lo, hi + 1, dtype=F32, device=base.device)
    return torch.pow(base.to(F32), ks)


def _one_hot(values: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot over the last axis; out-of-range values give a
    zero row (as ``jax.nn.one_hot``)."""
    return (values[..., None] == torch.arange(n, device=values.device)).to(F32)


def signed_histogram(values: torch.Tensor, signs: torch.Tensor, lo: int,
                     hi: int) -> torch.Tensor:
    """``hist[k] = sum_i signs_i * [values_i == lo + k]`` over [lo, hi]:
    the counter subarray's increment/decrement."""
    onehot = _one_hot(values - lo, hi - lo + 1)
    return torch.einsum("...i,...ik->...k", signs.to(F32), onehot)


def counting_dot(codes_a: torch.Tensor, pa: ExpQuantParams,
                 codes_w: torch.Tensor, pw: ExpQuantParams) -> torch.Tensor:
    """Eq. 1 dot product of two 1-D code vectors (the two quantizers
    share a base, as the paper's layer pairs do)."""
    sa, ea = split_code(codes_a, pa)
    sw, ew = split_code(codes_w, pw)
    s = (sa * sw).to(F32)
    lo_a, hi_a = pa.e_min, pa.e_max
    lo_w, hi_w = pw.e_min, pw.e_max
    lo_s, hi_s = lo_a + lo_w, hi_a + hi_w

    hist_sum = signed_histogram(ea + ew, s, lo_s, hi_s)
    hist_w = signed_histogram(ew, s, lo_w, hi_w)
    hist_a = signed_histogram(ea, s, lo_a, hi_a)
    n_signed = s.sum()

    base = pa.base
    t1 = pa.alpha * pw.alpha * torch.dot(hist_sum, _power_table(base, lo_s, hi_s))
    t2 = pw.alpha * pa.beta * torch.dot(hist_w, _power_table(base, lo_w, hi_w))
    t3 = pa.alpha * pw.beta * torch.dot(hist_a, _power_table(base, lo_a, hi_a))
    t4 = pa.beta * pw.beta * n_signed
    return t1 + t2 + t3 + t4


def counting_matmul(codes_a: torch.Tensor, pa: ExpQuantParams,
                    codes_w: torch.Tensor, pw: ExpQuantParams) -> torch.Tensor:
    """``[M, K] x [K, N]`` in the counting form (input-stationary): per
    output neuron the counters accumulate signed occurrences over K, and
    the power tables collapse them.  An oracle: O(M*N*K*E) one-hot work."""
    sa, ea = split_code(codes_a, pa)
    sw, ew = split_code(codes_w, pw)
    lo_a, hi_a = pa.e_min, pa.e_max
    lo_w, hi_w = pw.e_min, pw.e_max
    lo_s, hi_s = lo_a + lo_w, hi_a + hi_w

    s = (sa[:, :, None] * sw[None, :, :]).to(F32)                  # [M,K,N]
    e_sum = ea[:, :, None] + ew[None, :, :]
    hist_sum = torch.einsum("mkn,mkne->mne", s,
                            _one_hot(e_sum - lo_s, hi_s - lo_s + 1))
    hist_w = torch.einsum("mkn,kne->mne", s, _one_hot(ew - lo_w, hi_w - lo_w + 1))
    hist_a = torch.einsum("mkn,mke->mne", s, _one_hot(ea - lo_a, hi_a - lo_a + 1))
    n_signed = s.sum(1)

    base = pa.base
    t1 = pa.alpha * pw.alpha * torch.einsum(
        "mne,e->mn", hist_sum, _power_table(base, lo_s, hi_s))
    t2 = pw.alpha * pa.beta * torch.einsum(
        "mne,e->mn", hist_w, _power_table(base, lo_w, hi_w))
    t3 = pa.alpha * pw.beta * torch.einsum(
        "mne,e->mn", hist_a, _power_table(base, lo_a, hi_a))
    t4 = pa.beta * pw.beta * n_signed
    return t1 + t2 + t3 + t4


def dequant_matmul(codes_a: torch.Tensor, pa: ExpQuantParams,
                   codes_w: torch.Tensor, pw: ExpQuantParams,
                   dtype=F32) -> torch.Tensor:
    """Decode both operands through their tables, one float32 matmul."""
    a = decode(codes_a, pa, dtype)
    w = decode(codes_w, pw, dtype)
    return torch.matmul(a.to(F32), w.to(F32))


def unique_exponent_count(pa: ExpQuantParams, pw: ExpQuantParams) -> int:
    """Distinct counters per output neuron (paper §V)."""
    n_sum = (pa.e_max + pw.e_max) - (pa.e_min + pw.e_min) + 1
    n_a = pa.e_max - pa.e_min + 1
    n_w = pw.e_max - pw.e_min + 1
    return n_sum + n_a + n_w + 1
