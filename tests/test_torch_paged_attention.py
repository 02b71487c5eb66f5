"""The port's paged attention (plain page-scan versions, which the CPU
path runs) against the JAX package's: its CPU oracle (what its wrappers
pick off-TPU) and its Pallas kernels in interpret mode.

Scrambled page tables, a zero-length row, an odd chunk size, offset
``q_start`` and float32 and bfloat16 pages.  Tolerance: float32
rtol/atol 1e-5 -- the same online-softmax recurrence, differing only
in summation order and an ulp of exp (the decode oracle softmaxes in
one shot instead of page by page).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_gqa import ops as jdec
from repro.kernels.flash_prefill import ops as jpre
from repro_torch.kernels.decode_gqa import decode_gqa_paged
from repro_torch.kernels.flash_prefill import flash_prefill_paged

RTOL = ATOL = 1e-5
B, NKV, G, HD, BS, MAX_BLK = 3, 2, 2, 8, 4, 6
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pages(dtype: str, seed=0):
    r = np.random.default_rng(seed)
    n = 1 + B * MAX_BLK
    kp = (r.normal(size=(n, BS, NKV, HD)) * 0.5).astype(np.float32)
    vp = r.normal(size=(n, BS, NKV, HD)).astype(np.float32)
    perm = r.permutation(np.arange(1, n))[: B * MAX_BLK]
    bt = perm.reshape(B, MAX_BLK).astype(np.int32)
    jd, td = DTYPES[dtype]
    # round once through the page dtype so both sides hold the same bytes
    kp = np.array(jnp.asarray(kp).astype(jd).astype(jnp.float32))
    vp = np.array(jnp.asarray(vp).astype(jd).astype(jnp.float32))
    jax_side = (jnp.asarray(kp).astype(jd), jnp.asarray(vp).astype(jd),
                jnp.asarray(bt))
    torch_side = (torch.from_numpy(kp).to(td), torch.from_numpy(vp).to(td),
                  torch.from_numpy(bt))
    return jax_side, torch_side


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,q_start,valid", [
    (5, [0, 7, 3], [5, 3, 0]),      # odd chunk, offset rows, empty row
    (8, [0, 0, 16], [8, 2, 8]),     # two-page chunk, cold rows
])
def test_flash_prefill_paged_matches_reference(dtype, s, q_start, valid):
    (jk, jv, jbt), (tk, tv, tbt) = _pages(dtype)
    q = np.random.default_rng(s).normal(size=(B, s, NKV, G, HD))
    q = q.astype(np.float32)
    qs = np.asarray(q_start, np.int32)
    kv_lens = np.where(np.asarray(valid) > 0, qs + np.asarray(valid), 0)
    kv_lens = kv_lens.astype(np.int32)
    args = (jnp.asarray(q), jk, jv, jbt, jnp.asarray(qs),
            jnp.asarray(kv_lens))
    oracle = np.asarray(jpre.flash_prefill_paged(*args))
    kernel = np.asarray(jpre.flash_prefill_paged(*args, interpret=True))
    out = flash_prefill_paged(torch.from_numpy(q), tk, tv, tbt,
                              torch.from_numpy(qs), torch.from_numpy(kv_lens))
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), kernel, rtol=RTOL, atol=ATOL)
    empty = np.asarray(valid) == 0
    assert np.all(out.numpy()[empty] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_gqa_paged_matches_reference(dtype):
    (jk, jv, jbt), (tk, tv, tbt) = _pages(dtype, seed=1)
    q = np.random.default_rng(2).normal(size=(B, NKV, G, HD)).astype(np.float32)
    lengths = np.asarray([3, 0, 21], np.int32)
    args = (jnp.asarray(q), jk, jv, jbt, jnp.asarray(lengths))
    oracle = np.asarray(jdec.decode_gqa_paged(*args))
    kernel = np.asarray(jdec.decode_gqa_paged(*args, interpret=True))
    out = decode_gqa_paged(torch.from_numpy(q), tk, tv, tbt,
                           torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), kernel, rtol=RTOL, atol=ATOL)
    assert np.all(out.numpy()[1] == 0)


def test_lengths_clip_to_the_table_and_broadcast():
    """Scalar lengths broadcast and lengths past ``max_blk * bs`` clip,
    as in the reference's wrapper."""
    (jk, jv, jbt), (tk, tv, tbt) = _pages("float32", seed=3)
    q = np.random.default_rng(4).normal(size=(B, NKV, G, HD)).astype(np.float32)
    big = BS * MAX_BLK + 9
    ref = np.asarray(jdec.decode_gqa_paged(jnp.asarray(q), jk, jv, jbt, big))
    out = decode_gqa_paged(torch.from_numpy(q), tk, tv, tbt, big)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
