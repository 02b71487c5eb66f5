"""Non-finite KV values in the port's plain attention against the JAX
package's oracles (ROADMAP Queue 3's F4): the semantics the card's
kernels #5-#9 now follow.

The reference folds every position of the block-table columns it is
passed (every position of a contiguous cache), a masked one with weight
0, so 0 x NaN -- or 0 x inf -- makes the lane NaN:
- NaN or +inf in V at or past a row's length (the rest of the last live
  page, or a trash column past the live pages) makes that lane NaN in
  every query row of its KV head; its K does not matter;
- NaN in V at a causally masked position inside ``kv_lens`` reaches the
  earlier query rows of a prefill chunk the same way;
- a NaN score at a valid position: the prefill oracle's running max
  turns NaN and its flush takes the row as unseen (zeros), the decode
  oracle's dense softmax gives the row NaN.
Each case runs on float32, bfloat16 and float8_e4m3fn pages (+inf only
where the dtype has it), and on codes pages whose V table holds NaN at
one code.  Held: the NaN masks equal element for element, the finite
values within 1e-5, the codes equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_gqa import ops as jdec
from repro.kernels.decode_gqa import ref as jdec_ref
from repro.kernels.flash_prefill import ops as jpre
from repro_torch.core import exponential_quant as eq
from repro_torch.kernels.decode_gqa import (decode_gqa, decode_gqa_paged,
                                            decode_gqa_paged_codes)
from repro_torch.kernels.flash_prefill import (flash_prefill_paged,
                                               flash_prefill_paged_codes)

NKV, G, HD, BS, MAX_BLK = 2, 2, 8, 4, 4
F8 = "float8_e4m3fn"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16),
      F8: (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
# row 0: 6 positions over pages 1, 2 (2 stale positions left in page 2),
# then trash page 0 twice; row 1: 9 positions over pages 3, 4, 5, trash
TABLE = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
LENS = np.array([6, 9], np.int32)

# (case, page, slot in the page, K too): where the bad value goes.
# "tail": page 2 slot 3, past row 0's length 6; "trash": page 0, read by
# both rows' trash columns; "masked": page 4 slot 1 = row 1's position 5,
# inside its kv_lens but after the chunk's first queries; "score": K NaN
# at row 0's position 1, valid for every query of the chunk
CASES = [("tail", 2, 3, True), ("trash", 0, 2, False),
         ("masked", 4, 1, False), ("score", 1, 1, True)]


def _pages(dtype, case, bad=float("nan"), seed=0):
    """numpy float32 pages rounded through ``dtype`` with ``bad`` placed
    per ``case`` (in V, and in K where the case says)."""
    r = np.random.default_rng(seed)
    n = 6
    jd = DT[dtype][0]
    k, v = (np.array(jnp.asarray(r.normal(size=(n, BS, NKV, HD)), jd)
                     .astype(jnp.float32)) for _ in range(2))
    _, page, slot, in_k = next(c for c in CASES if c[0] == case)
    if case == "score":
        k[page, slot, 0, :] = bad       # KV head 0's logits: NaN
    else:
        v[page, slot, 1, 3] = bad       # KV head 1, lane 3
        if in_k:
            k[page, slot, 1, :] = bad
    return k, v


def _same(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-5, atol=1e-5)


def _jax_pages(k, v, dtype):
    jd = DT[dtype][0]
    return jnp.asarray(k, jd), jnp.asarray(v, jd)


def _torch_pages(k, v, dtype):
    td = DT[dtype][1]
    return torch.from_numpy(k).to(td), torch.from_numpy(v).to(td)


def _dtypes_for(bad):
    # e4m3fn has no inf
    return ["float32", "bfloat16"] + ([F8] if np.isnan(bad) else [])


PARAMS = [pytest.param(dt, case, bad, id=f"{case}-{name}-{dt}")
          for case, _, _, _ in CASES
          for bad, name in ((float("nan"), "nan"), (float("inf"), "inf"))
          if case != "score" or name == "nan"
          for dt in _dtypes_for(bad)]


@pytest.mark.parametrize("dtype,case,bad", PARAMS)
def test_paged_decode_follows_the_reference(dtype, case, bad):
    k, v = _pages(dtype, case, bad)
    q = np.random.default_rng(1).normal(size=(2, NKV, G, HD)).astype(np.float32)
    jk, jv = _jax_pages(k, v, dtype)
    ref = np.asarray(jdec.decode_gqa_paged(jnp.asarray(q), jk, jv,
                                           jnp.asarray(TABLE),
                                           jnp.asarray(LENS)))
    tk, tv = _torch_pages(k, v, dtype)
    out = decode_gqa_paged(torch.from_numpy(q), tk, tv,
                           torch.from_numpy(TABLE), torch.from_numpy(LENS))
    _same(out.numpy(), ref)
    if case in ("tail", "trash"):
        rows = [0] if case == "tail" else [0, 1]
        assert np.isnan(ref[rows, 1, :, 3]).all()
        assert np.isfinite(np.delete(ref[rows], 3, axis=-1)).all()
    if case == "score":
        assert np.isnan(ref[0, 0]).all() and np.isfinite(ref[1]).all()


@pytest.mark.parametrize("dtype,case,bad", PARAMS)
def test_paged_prefill_follows_the_reference(dtype, case, bad):
    """A 3-query chunk per row ending at its length: row 0 at positions
    3..5, row 1 at 1..3 of 9 (positions 4..8 of row 1 are inside kv_lens
    but past every query: the chunk's causally masked positions)."""
    k, v = _pages(dtype, case, bad)
    s = 3
    q = np.random.default_rng(2).normal(size=(2, s, NKV, G, HD)).astype(np.float32)
    qs = np.array([3, 1], np.int32)
    jk, jv = _jax_pages(k, v, dtype)
    ref = np.asarray(jpre.flash_prefill_paged(
        jnp.asarray(q), jk, jv, jnp.asarray(TABLE), jnp.asarray(qs),
        jnp.asarray(LENS)))
    tk, tv = _torch_pages(k, v, dtype)
    out = flash_prefill_paged(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(TABLE), torch.from_numpy(qs),
                              torch.from_numpy(LENS))
    _same(out.numpy(), ref)
    if case == "masked":
        # row 1's position 5 is past each of its queries: 0 x NaN
        assert np.isnan(ref[1, :, 1, :, 3]).all()
    if case == "score":
        # a NaN score at a valid position: the row is zeros, not NaN
        assert (ref[0, :, 0] == 0).all() and np.isfinite(ref).all()


@pytest.mark.parametrize("dtype,bad", [
    pytest.param(dt, bad, id=f"{name}-{dt}")
    for bad, name in ((float("nan"), "nan"), (float("inf"), "inf"))
    for dt in _dtypes_for(bad)])
def test_contiguous_decode_follows_the_reference(dtype, bad):
    """#9's plain version over a [B, S, n_kv, hd] cache: a bad V at or
    past lengths[b] (up to S) makes its lane NaN (a NaN inside the
    length does as usual); the reference's interpret-mode kernel and its
    oracle agree."""
    r = np.random.default_rng(3)
    s, jd = 13, DT[dtype][0]
    k, v = (np.array(jnp.asarray(r.normal(size=(2, s, NKV, HD)), jd)
                     .astype(jnp.float32)) for _ in range(2))
    v[0, 11, 1, 3] = bad          # past row 0's length 7
    v[1, 4, 0, 5] = np.nan        # inside row 1's length 9: the usual NaN
    q = r.normal(size=(2, NKV, G, HD)).astype(np.float32)
    lens = np.array([7, 9], np.int32)
    args = (jnp.asarray(q), jnp.asarray(k, jd), jnp.asarray(v, jd),
            jnp.asarray(lens))
    ref = np.asarray(jdec_ref.decode_gqa_ref(*args))
    kern = np.asarray(jdec.decode_gqa(*args))     # interpret mode
    td = DT[dtype][1]
    out = decode_gqa(torch.from_numpy(q), torch.from_numpy(k).to(td),
                     torch.from_numpy(v).to(td), torch.from_numpy(lens))
    _same(out.numpy(), ref)
    _same(out.numpy(), kern)
    assert np.isnan(ref[0, 1, :, 3]).all() and np.isnan(ref[1, 0, :, 5]).all()
    assert np.isnan(ref).sum() == 2 * G     # one lane of G rows, each row


def _code_tables(seed=4):
    """A q table, per-head K/V tables and an out table (7-bit fits of
    random data), numpy float32."""
    g = torch.Generator().manual_seed(seed)
    tabs = []
    for stacked in (False, True, True):
        x = torch.randn(NKV if stacked else 1, 512, generator=g)
        fit = eq.fit(x if stacked else x[0], 7, stacked=stacked)
        tabs.append(eq.decode_table(fit).numpy())
    oq = eq.pack_qmeta(eq.fit(torch.randn(4096, generator=g) * 0.5, 7))
    return tabs + [oq.numpy()]


@pytest.mark.parametrize("case", ["tail", "trash", "valid"])
def test_codes_follow_the_reference(case):
    """#6/#8's plain versions: uint8 pages whose V table holds NaN at one
    code (finite tables cannot show the rule).  The code sits past row
    0's length (``tail``), in the trash page (``trash``) or at a valid
    position (``valid``); the NaN context encodes to the same code on
    both sides."""
    ql, kl, vl, oq = _code_tables()
    r = np.random.default_rng(5)
    kc = r.integers(0, 256, size=(6, BS, NKV, HD), dtype=np.uint8)
    vc = r.integers(0, 256, size=(6, BS, NKV, HD), dtype=np.uint8)
    bad = 200
    vl = vl.copy()
    vl[1, bad] = np.nan
    vc[vc == bad] = 201               # the bad code only where placed
    page, slot = {"tail": (2, 3), "trash": (0, 2), "valid": (1, 1)}[case]
    vc[page, slot, 1, 3] = bad
    qc1 = r.integers(0, 256, size=(2, NKV, G, HD), dtype=np.uint8)
    qc = r.integers(0, 256, size=(2, 3, NKV, G, HD), dtype=np.uint8)
    qs = np.array([3, 1], np.int32)
    j = [jnp.asarray(a) for a in (kc, vc, ql, kl, vl, oq)]
    t = [torch.from_numpy(a) for a in (kc, vc, ql, kl, vl, oq)]
    jbt, tbt = jnp.asarray(TABLE), torch.from_numpy(TABLE)
    ref_d = np.asarray(jdec.decode_gqa_paged_codes(
        jnp.asarray(qc1), *j[:2], *j[2:], jbt, jnp.asarray(LENS)))
    out_d = decode_gqa_paged_codes(torch.from_numpy(qc1), *t, tbt,
                                   torch.from_numpy(LENS))
    ref_p = np.asarray(jpre.flash_prefill_paged_codes(
        jnp.asarray(qc), *j, jbt, jnp.asarray(qs), jnp.asarray(LENS)))
    out_p = flash_prefill_paged_codes(torch.from_numpy(qc), *t, tbt,
                                      torch.from_numpy(qs),
                                      torch.from_numpy(LENS))
    nan_code = int(eq.encode_meta(torch.tensor(float("nan")),
                                  torch.from_numpy(oq)))
    for out, ref in ((out_d.numpy(), ref_d), (out_p.numpy(), ref_p)):
        assert out.dtype == ref.dtype == np.uint8
        agree = eq.codes_agree(torch.from_numpy(out), torch.from_numpy(ref.copy()),
                               torch.from_numpy(oq))
        assert bool(agree.all())
        assert (out[..., 1, :, 3] == ref[..., 1, :, 3]).all()
    # the lane the NaN reaches holds the code of NaN on both sides
    rows = [0, 1] if case == "trash" else [0]
    assert (ref_d[rows, 1, :, 3] == nan_code).all()
