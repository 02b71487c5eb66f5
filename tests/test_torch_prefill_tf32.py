"""The split-TF32 arithmetic of the card's flash-prefill kernel
(``csrc/flash_prefill.cu``), emulated on the CPU.

The kernel runs QK^T and PV on TF32 tensor cores, which read an
operand's upper 19 bits (10 mantissa bits).  So the kernel splits each
float32 operand as x = hi + lo, hi = x cut to TF32 and lo = x - hi
(exact in float32, cut to TF32 by the tensor core), and computes hi*hi +
hi*lo + lo*hi, leaving out a pass whose lo part is zero by construction
(bfloat16 and float8_e4m3fn values are exact in TF32;
``flash_prefill.passes``).  The
emulation below does the same cuts and passes, with float32 sums,
folding the online softmax over KV tiles of the kernel's width (32
positions), on the kernel's query rows: blocks of 64 rows, ``64 // g``
positions x g heads, the rows past them padding (zero q, every logit
masked, never stored) where g does not divide 64.  Held against the
plain version (``flash_prefill_paged_ref``) and the JAX package's oracle
on the same inputs within 1e-4, the float kernel's gate on the card, at
head_dim 128, 64 and 256, g 2, 5, 6, 10 and 16, float32, bfloat16 and
float8_e4m3fn pages (the last two with one K/V pass), blocks of 16 and
128 positions, a 64-query chunk over 1000 positions and a cold 64-query
chunk; and single-pass TF32 is shown to miss that bound, which is why
the kernel splits.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_prefill import ops as jpre
from repro_torch.kernels.flash_prefill.flash_prefill import (
    KV_TILE, MAX_GROUP, ROWS_PER_BLOCK, passes)
from repro_torch.kernels.flash_prefill.ref import flash_prefill_paged_ref

F32 = torch.float32
GATE = 1e-4                 # chip_smoke.py's bound for the float kernel
N_KV, G, HD, BS, S, CTX = 2, 2, 128, 16, 64, 1000
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float8_e4m3fn": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
EXACT = (torch.bfloat16, torch.float8_e4m3fn)   # exact in TF32


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: its emulation runs thousands of
    small tensor ops, which spin-wait across a full thread pool when the
    suite's workers share the cores (a quarter of the time under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 cut to TF32 as the tensor core reads it: the low 13 bits
    of the pattern cleared (toward zero, 10 mantissa bits kept)."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return (bits & -0x2000).view(F32)


def split(x: torch.Tensor):
    """The kernel's ``split``: hi = tf32(x), lo = x - hi (exact), which
    reaches the tensor core as tf32(lo)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def tf32_product(a, b, split_a: bool, split_b: bool, eq: str) -> torch.Tensor:
    """einsum ``eq`` of a and b as the kernel computes it: lo*hi when a is
    split, hi*lo when b is, and hi*hi, each product of TF32 values
    summed in float32."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = torch.einsum(eq, ah, bh)
    if split_b:
        out = out + torch.einsum(eq, ah, bl)
    if split_a:
        out = out + torch.einsum(eq, al, bh)
    return out


def block_rows(s: int, g: int):
    """The kernel's query rows: block z holds qpb = 64 // g positions x
    g heads, row r being (position z*qpb + r // g, head r % g); rows
    r >= qpb*g are padding, and rows at positions >= s are past the
    chunk.  Returns (position, head, padding, stored), each [Z, 64]."""
    qpb = ROWS_PER_BLOCK // g
    r = torch.arange(ROWS_PER_BLOCK)
    pos = torch.arange(-(-s // qpb))[:, None] * qpb + r // g
    pad = (r >= qpb * g).expand_as(pos)
    return pos, (r % g).expand_as(pos), pad, ~pad & (pos < s)


def emulate(q, k_pages, v_pages, block_tables, q_start, kv_lens,
            split_q=None, split_k=None, split_v=None, split_p=True,
            kv_tile=KV_TILE) -> torch.Tensor:
    """The kernel's arithmetic on its blocks of query rows
    (:func:`block_rows`): masks, scale and recurrence as the reference,
    products as :func:`tf32_product`, folded per KV tile; a padding row
    has zero q and sees no position, and only the stored rows reach the
    output.  By default q and the pages are split unless bfloat16 or
    float8_e4m3fn (exact in TF32), and P always, as the kernel does."""
    if split_q is None:
        split_q = q.dtype not in EXACT
    if split_k is None:
        split_k = split_v = k_pages.dtype not in EXACT
    b, s, n_kv, g, hd = q.shape
    t_all = block_tables.shape[1] * k_pages.shape[1]
    k = k_pages[block_tables.long()].reshape(b, t_all, n_kv, hd).to(F32)
    v = v_pages[block_tables.long()].reshape(b, t_all, n_kv, hd).to(F32)
    pos, head, pad, stored = block_rows(s, g)
    zero = (pad | (pos >= s))
    # q rows [B, n_kv, Z, 64, hd] (the advanced indices' [Z, 64] come
    # first): zeros for padding and past the chunk
    qf = q.to(F32)[:, pos.clamp(max=s - 1), :, head].permute(2, 3, 0, 1, 4)
    qf = torch.where(zero[None, None, ..., None], torch.zeros(()), qf)
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.where(pad, -1, q_start.long()[:, None, None] + pos)
    m = torch.full(qf.shape[:-1], -1e30)
    l = torch.zeros(qf.shape[:-1])
    acc = torch.zeros(qf.shape)
    for t0 in range(0, t_all, kv_tile):
        kk, vv = k[:, t0:t0 + kv_tile], v[:, t0:t0 + kv_tile]
        logit = tf32_product(qf, kk, split_q, split_k,
                             "bnzrh,btnh->bnzrt") * scale
        kvpos = t0 + torch.arange(kk.shape[1])
        valid = ((kvpos <= qpos[..., None])
                 & (kvpos < kv_lens.long()[:, None, None, None]))
        logit = torch.where(valid[:, None], logit, torch.tensor(-1e30))
        m_new = torch.maximum(m, logit.amax(-1))
        p = torch.exp(logit - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + tf32_product(p, vv, split_p, split_v,
                                                   "bnzrt,btnh->bnzrh")
        m = m_new
    rows = acc / torch.clamp_min(l, 1e-30)[..., None]
    rows = torch.where((m > -5e29)[..., None], rows, torch.zeros(()))
    # the stored rows, each (position, head) once, into [B, S, n_kv, g, hd]
    out = torch.full((b, s, n_kv, g, hd), float("nan"))
    out[:, pos[stored], :, head[stored]] = rows[:, :, stored].permute(2, 0, 1, 3)
    return out


def _inputs(dtype: str, seed: int, g: int = G, hd: int = HD, bs: int = BS):
    """Two rows: row 0 the last 64-query chunk of a 1000-position row,
    row 1 a cold 64-query chunk; bf16 q (the serving path's), pages
    rounded once through ``dtype``.  numpy arrays."""
    r = np.random.default_rng(seed)
    max_blk = -(-CTX // bs)
    n = 1 + 2 * max_blk
    jd, _ = DTYPES[dtype]
    kp = np.array(jnp.asarray(r.normal(size=(n, bs, N_KV, hd)), jd).astype(jnp.float32))
    vp = np.array(jnp.asarray(r.normal(size=(n, bs, N_KV, hd)), jd).astype(jnp.float32))
    q = np.array(jnp.asarray(r.normal(size=(2, S, N_KV, g, hd)), jnp.bfloat16)
                 .astype(jnp.float32))
    bt = r.permutation(np.arange(1, n))[: 2 * max_blk].reshape(2, max_blk)
    return (q, kp, vp, bt.astype(np.int32),
            np.array([CTX - S, 0], np.int32), np.array([CTX, S], np.int32))


def _torch(arrays, dtype: str):
    q, kp, vp, bt, qs, kl = (torch.from_numpy(a) for a in arrays)
    td = DTYPES[dtype][1]
    return q.to(torch.bfloat16), kp.to(td), vp.to(td), bt, qs, kl


def test_tf32_cuts_toward_zero_and_splits_within_2_pow_minus_20():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + 3 * ulp / 4, -(1 + 3 * ulp / 4), 1 + ulp,
                      3.0, 0.0])
    want = torch.tensor([1.0, 1.0, -1.0, 1 + ulp, 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 100
    hi, lo = split(r)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert torch.equal(hi + (r - hi), r)        # the kernel's lo is exact
    rel = ((hi.double() + lo.double() - r.double()).abs() / r.double().abs()).max()
    assert rel <= 2.0 ** -20
    bf = r.to(torch.bfloat16).to(F32)          # bfloat16 is exact in TF32
    assert torch.equal(tf32(bf), bf)


def test_passes_skip_only_the_exact_parts():
    """The pass counts the bound in chip_smoke.py is taken from: one
    hi*hi, one more per split operand."""
    bf, f = torch.bfloat16, torch.float32
    assert passes(bf, f) == (2, 3)               # the serving path
    assert passes(bf, bf) == (1, 2)
    assert passes(f, f) == (3, 3)
    assert passes(torch.uint8, torch.uint8) == (3, 3)   # decoded codes
    f8 = torch.float8_e4m3fn                     # exact in TF32, as bf16
    assert passes(bf, f8) == (1, 2)
    assert passes(f, f8) == (2, 2)
    f8v = torch.randn(4096, generator=torch.Generator().manual_seed(1)).to(f8)
    assert torch.equal(tf32(f8v.to(F32)), f8v.to(F32))


@pytest.mark.parametrize("g", range(1, MAX_GROUP + 1))
@pytest.mark.parametrize("s", [1, 37, 64, 256])
def test_block_rows_store_each_query_once(g, s):
    """Every (position, head) of the chunk is stored by exactly one row;
    a block holds 64 // g positions and 64 % g padding rows."""
    pos, head, pad, stored = block_rows(s, g)
    keys = (pos * g + head)[stored]
    assert torch.equal(keys.sort().values, torch.arange(s * g))
    assert bool((pad.sum(1) == ROWS_PER_BLOCK % g).all())
    assert pos.shape[0] == -(-s // (ROWS_PER_BLOCK // g))


# PR 14/18's layouts at both seeds under their ids, then f8 pages (one
# K/V pass), head_dim 256 at g 10, g 16 on pages of 128
@pytest.mark.parametrize("dtype,seed,g,hd,bs", [
    pytest.param(dt, seed, g, hd, BS, id=f"{g}-{hd}-{seed}-{dt}")
    for g, hd in ((G, HD), (5, 128), (6, 64)) for seed in (0, 1)
    for dt in ("float32", "bfloat16")
] + [pytest.param(*c, id="-".join(map(str, c))) for c in (
    ("float8_e4m3fn", 0, G, HD, BS), ("float8_e4m3fn", 1, 10, 256, BS),
    ("float32", 0, 10, 256, BS), ("bfloat16", 1, 16, 128, 128))])
def test_split_tf32_is_within_the_gate(dtype, seed, g, hd, bs):
    arrays = _inputs(dtype, seed, g, hd, bs)
    args = _torch(arrays, dtype)
    out = emulate(*args)
    ref = flash_prefill_paged_ref(*args)
    err = (out - ref).abs().max().item()
    assert err <= GATE, err
    q, kp, vp, bt, qs, kl = arrays
    jd = DTYPES[dtype][0]
    jref = np.asarray(jpre.flash_prefill_paged(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
        jnp.asarray(bt), jnp.asarray(qs), jnp.asarray(kl)))
    assert np.abs(out.numpy() - jref).max() <= GATE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_pass_tf32_misses_the_gate(dtype):
    args = _torch(_inputs(dtype, 0), dtype)
    ref = flash_prefill_paged_ref(*args)
    one_pass = dict(split_q=False, split_k=False, split_v=False, split_p=False)
    err = (emulate(*args, **one_pass) - ref).abs().max().item()
    assert err > 2 * GATE, err
    if dtype == "float32":
        # splitting only one of the two products still misses it
        for split_qk in (False, True):
            err = (emulate(*args, split_q=False, split_k=split_qk,
                           split_v=not split_qk, split_p=not split_qk)
                   - ref).abs().max().item()
            assert err > 2 * GATE, (split_qk, err)
