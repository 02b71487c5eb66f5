"""The split-KV arithmetic of the card's flash-decode kernels
(``csrc/decode_gqa.cu``: #7 float and #8 codes over pages, #9 over a
contiguous cache), emulated on the CPU.

The kernel cuts each row's positions into partitions of ``split_plan``'s
size (a contiguous row as virtual pages of 64 positions:
``contiguous_plan``), one block each.  Inside a block, warp w folds batches of BATCH
positions (batches w, w + WARPS, ...) into its own online softmax
(m, l, acc); the block merges its warps, writes a partial, and a merge
pass folds the partials of the partitions that start before the row's
length (M = max m_i, l = sum l_i exp(m_i - M), acc likewise) and
flushes: acc / max(l, 1e-30), zeros where M <= -5e29.  Codes are
decoded through the tables before the arithmetic and the context is
encoded once, after the merge.  The emulation below follows that order
in float32 and is held against the port's plain versions and the JAX
package's oracle on the same numpy-seeded inputs: within 1e-4 of the
output's scale for float pages, at most 1e-3 of the codes one step off
for uint8 ones (``chip_smoke.py``'s gates for the kernels), at
head_dim 128, 64 and 256 (BATCH_WIDE positions a warp), g from 1 to 16
(the kernel runs g 5 and 6 on its g = 8 instantiation, and g 10 and 16
as two row groups of one KV head: rows past a block's own take no part,
so the arithmetic of the live rows is the emulation's), float32 and
float8_e4m3fn pages (upcast after the load), and blocks of 16, 48 and
128 positions.
"""

import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_gqa import ops as jdec
from repro_torch.core import exponential_quant as eq
from repro_torch.kernels import _build
from repro_torch.kernels.decode_gqa import decode_gqa
from repro_torch.kernels.decode_gqa.decode_gqa import (VIRTUAL_PAGE,
                                                       contiguous_plan,
                                                       split_plan)
from repro_torch.kernels.decode_gqa.ref import (decode_gqa_paged_codes_ref,
                                                decode_gqa_paged_ref,
                                                decode_gqa_ref)

F32 = torch.float32
NEG = -1e30
GATE = 1e-4                 # the float kernel's bound, of the output scale
N_KV, HD = 2, 128
SMS = 132                   # an H100's SMs, for split_plan
MAX_BLK = 6                 # not a multiple of 4 pages (bs 16) a partition


def _split_constant(name):
    """An integer constant of the kernel's ``namespace split``, read from
    its source so that the emulation follows the kernel as it is built."""
    src = (_build.CSRC / "decode_gqa.cu").read_text()
    body = src[src.index("namespace split {"):]
    return int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))


WARPS = _split_constant("THREADS") // 32    # warps of a split block
BATCH = _split_constant("BATCH")            # positions a warp loads at once
BATCH_WIDE = _split_constant("BATCH_WIDE")  # the same at head_dim 256
F8 = "float8_e4m3fn"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module: its emulation runs thousands of
    small tensor ops, which spin-wait across a full thread pool when the
    suite's workers share the cores (a quarter of the time under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fold(state, logit, v):
    """One batch of the online softmax: logit [..., U] (masked to
    -1e30), v [..., U, hd]."""
    m, l, acc = state
    m_new = torch.maximum(m, logit.amax(-1))
    p = torch.exp(logit - m_new[..., None])
    corr = torch.exp(m - m_new)
    return (m_new, l * corr + p.sum(-1),
            acc * corr[..., None] + torch.einsum("...u,...uh->...h", p, v))


def merge(parts, live=None):
    """Fold partials [(m, l, acc), ...] with M = max m_i; ``live`` [i]
    masks [B] leave a partial out where False."""
    ms = torch.stack([p[0] for p in parts])
    if live is not None:
        ms = torch.where(live[:, :, None, None], ms, torch.tensor(NEG))
    mm = ms.amax(0)
    c = torch.exp(ms - mm)
    if live is not None:
        c = torch.where(live[:, :, None, None], c, torch.zeros(()))
    ll = sum(ci * p[1] for ci, p in zip(c, parts))
    aa = sum(ci[..., None] * p[2] for ci, p in zip(c, parts))
    return mm, ll, aa


def paged_plan(b, max_blk, bs, sms=SMS):
    """(positions a partition, partitions, positions a row) of the paged
    kernels' grid."""
    pages, n_split = split_plan(b, N_KV, max_blk, bs, sms)
    return pages * bs, n_split, max_blk * bs


def emulate(q, k, v, lengths, part, n_split, cap):
    """The kernel's order on float32 q [B, n_kv, g, hd] and the rows' KV
    k/v [B, cap, n_kv, hd] (the gathered pages, or the contiguous
    cache), partitions of ``part`` positions; returns [B, n_kv, g,
    hd]."""
    b, n_kv, g, hd = q.shape
    batch = BATCH_WIDE if hd > 128 else BATCH
    kvl = lengths.long().clamp(0, cap)
    scale = 1.0 / math.sqrt(hd)
    partials = []
    for z in range(n_split):
        t_end = torch.clamp(kvl, max=(z + 1) * part)             # [B]
        warps = []
        for w in range(WARPS):
            st = (torch.full((b, n_kv, g), NEG), torch.zeros((b, n_kv, g)),
                  torch.zeros((b, n_kv, g, hd)))
            for t0 in range(z * part + w * batch, (z + 1) * part,
                            WARPS * batch):
                run = t0 < t_end                                  # [B]
                pos = t0 + torch.arange(batch)
                idx = torch.minimum(pos[None], t_end[:, None] - 1).clamp(min=0)
                kb = k[torch.arange(b)[:, None], idx]             # [B, U, n, hd]
                vb = v[torch.arange(b)[:, None], idx]
                logit = torch.einsum("bngh,bunh->bngu", q, kb) * scale
                live = pos[None] < t_end[:, None]                 # [B, U]
                logit = torch.where(live[:, None, None], logit,
                                    torch.tensor(NEG))
                new = fold(st, logit, vb.permute(0, 2, 1, 3)[:, :, None])
                st = tuple(torch.where(run.view(-1, *[1] * (o.ndim - 1)), n, o)
                           for n, o in zip(new, st))
            warps.append(st)
        partials.append(merge(warps))
    if n_split == 1:
        mm, ll, aa = partials[0]
    else:
        live = torch.stack([z * part < kvl for z in range(n_split)])
        mm, ll, aa = merge(partials, live)
    out = aa / torch.clamp_min(ll, 1e-30)[..., None]
    return torch.where((mm > -5e29)[..., None], out, torch.zeros(()))


def _gather(pages, bt):
    b, max_blk = bt.shape
    return pages[bt.long()].reshape(b, max_blk * pages.shape[1],
                                    *pages.shape[2:]).to(F32)


def _bf16_q(r, b, g, hd):
    """numpy float32 q [B, n_kv, g, hd] rounded through bfloat16 (the
    serving path's)."""
    return np.array(jnp.asarray(r.normal(size=(b, N_KV, g, hd)), jnp.bfloat16)
                    .astype(jnp.float32))


def _inputs(g, bs, lengths, seed, max_blk=MAX_BLK, hd=HD, pdt="float32"):
    """numpy q [B, n_kv, g, hd], pages [N, bs, n_kv, hd] (float32 values
    rounded through bfloat16 for q, through ``pdt`` for the pages), a
    scrambled block table [B, max_blk] and lengths."""
    r = np.random.default_rng(seed)
    b = len(lengths)
    n = 1 + b * max_blk
    q = _bf16_q(r, b, g, hd)
    kp, vp = (np.array(jnp.asarray(r.normal(size=(n, bs, N_KV, hd)),
                                   jnp.dtype(pdt)).astype(jnp.float32))
              for _ in range(2))
    bt = r.permutation(np.arange(1, n))[: b * max_blk].reshape(b, max_blk)
    return q, kp, vp, bt.astype(np.int32), np.asarray(lengths, np.int32)


# a zero-length row, length 1, one ending mid-page, one filling the
# table, and (bs 16) rows whose later partitions lie wholly past them
def _lengths(bs, max_blk=MAX_BLK):
    return [0, 1, bs + 5, max_blk * bs, 2 * bs - 1]


def test_split_plan_reads_static_shapes_only():
    # the serving shape: 16 partitions of 4 pages, 304 working blocks at
    # phase 2's lengths
    pages, n_split = split_plan(8, 8, 64, 16, SMS)
    assert (pages, n_split) == (4, 16)
    lens = [17, 732, 400, 0, 256, 33, 600, 129]
    assert 8 * sum(-(-n // (pages * 16)) for n in lens) == 304
    # a long context is thinned to at most 8 blocks an SM
    pages, n_split = split_plan(8, 8, 256, 16, SMS)
    assert 8 * 8 * n_split <= 8 * SMS and pages * n_split >= 256
    # one partition covers a short table; any bs (past 64: a page a
    # partition)
    assert split_plan(8, 8, 4, 16, SMS) == (4, 1)
    assert split_plan(5, 2, 6, 128, SMS) == (1, 6)
    for bs in (1, 5, 16, 48, 64, 128, 200):
        pages, n_split = split_plan(3, 2, 7, bs, SMS)
        assert 1 <= pages <= 7 and (n_split - 1) * pages < 7 <= n_split * pages
    # a contiguous row: virtual pages of 64 positions; phase 6 (4 rows)
    # and phase 2 (8 rows) at S = 768, 12 partitions of 64; an S off the
    # virtual page ends inside its last partition
    assert contiguous_plan(4, 8, 768, SMS) == (VIRTUAL_PAGE, 12)
    assert contiguous_plan(8, 8, 768, SMS) == (VIRTUAL_PAGE, 12)
    part, n_split = contiguous_plan(5, 2, 200, SMS)
    assert (part, n_split) == (64, 4) and (n_split - 1) * part < 200
    part, n_split = contiguous_plan(8, 36, 4096, SMS)    # thinned
    assert 8 * 36 * n_split <= 8 * SMS and part * n_split >= 4096


def _cases(more, pdt=("float32",)):
    """PR 15's (g, bs, hd) cross product under its own ids (with
    ``pdt``, the float pages' dtype), then the cases ``more``."""
    return ([pytest.param(g, bs, hd, *pdt, id=f"{hd}-{bs}-{g}")
             for hd in (128, 64) for bs in (16, 48) for g in (1, 2, 4, 5, 6, 8)]
            + [pytest.param(*c, id="-".join(map(str, c))) for c in more])


# f8 pages; head_dim 256 (paligemma's g 8, recurrentgemma's g 10); g 16
# (two row groups); blocks of 128 positions
@pytest.mark.parametrize("g,bs,hd,pdt", _cases([
    (2, 16, 128, F8), (8, 16, 256, "float32"), (10, 16, 256, F8),
    (16, 128, 64, F8)]))
def test_split_order_matches_the_plain_version_and_jax(g, bs, hd, pdt):
    q, kp, vp, bt, lengths = _inputs(g, bs, _lengths(bs),
                                     seed=g * 10 + bs + hd, hd=hd, pdt=pdt)
    tq, tk, tv, tbt, tl = (torch.from_numpy(a) for a in (q, kp, vp, bt, lengths))
    part, n_split, cap = paged_plan(len(lengths), MAX_BLK, bs)
    assert n_split > 1 and (bs != 16 or cap % part)
    out = emulate(tq, _gather(tk, tbt), _gather(tv, tbt), tl, part, n_split,
                  cap)
    td = getattr(torch, pdt)
    ref = decode_gqa_paged_ref(tq.to(torch.bfloat16), tk.to(td), tv.to(td),
                               tbt, tl)
    tol = GATE * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= tol
    assert torch.all(out[0] == 0)
    jref = np.asarray(jdec.decode_gqa_paged(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, pdt),
        jnp.asarray(vp, pdt), jnp.asarray(bt), jnp.asarray(lengths)))
    assert np.abs(out.numpy() - jref).max() <= tol


@pytest.mark.parametrize("sms", [1, 4, SMS])
def test_thinned_grids_keep_the_result(sms):
    """Fewer SMs double the partitions (1 and 4: one or two partitions a
    row); the result stays within the gate."""
    bs = 16
    q, kp, vp, bt, lengths = _inputs(2, bs, _lengths(bs), seed=7)
    tq, tk, tv, tbt, tl = (torch.from_numpy(a) for a in (q, kp, vp, bt, lengths))
    out = emulate(tq, _gather(tk, tbt), _gather(tv, tbt), tl,
                  *paged_plan(len(lengths), MAX_BLK, bs, sms))
    ref = decode_gqa_paged_ref(tq, tk, tv, tbt, tl)
    assert (out - ref).abs().max().item() <= GATE * max(1.0, ref.abs().max().item())


def _code_inputs(g, bs, seed, hd=HD):
    """uint8 q and pages with the q table and per-head K/V tables, and
    an out table fitted on the float context: numpy arrays."""
    q, kp, vp, bt, lengths = _inputs(g, bs, _lengths(bs), seed, hd=hd)
    tabs = []
    for x, stacked in ((q, False), (kp, True), (vp, True)):
        xt = torch.from_numpy(x)
        if stacked:
            fit = eq.fit(xt.permute(2, 0, 1, 3).reshape(N_KV, -1), 7,
                         stacked=True)
            codes = eq.encode_meta(xt, eq.pack_qmeta(fit)[:, None, :])
        else:
            fit = eq.fit(xt, 7)
            codes = eq.encode(xt, fit)
        tabs += [codes.numpy(), eq.decode_table(fit).numpy()]
    qc, ql, kc, kl, vc, vl = tabs
    oq = eq.pack_qmeta(eq.fit(torch.randn(4096, generator=torch.Generator()
                                          .manual_seed(seed)) * 0.5, 7)).numpy()
    return qc, kc, vc, ql, kl, vl, oq, bt, lengths


@pytest.mark.parametrize("g,bs,hd", _cases(
    [(10, 16, 256), (16, 128, 128)], pdt=()))
def test_codes_split_order_encodes_once_after_the_merge(g, bs, hd):
    arrays = _code_inputs(g, bs, seed=100 + g * 10 + bs + hd, hd=hd)
    qc, kc, vc, ql, kl, vl, oq, bt, lengths = (torch.from_numpy(a)
                                               for a in arrays)
    heads = torch.arange(N_KV)
    qf = ql[qc.long()]
    kf = _gather(kl[heads[:, None], kc.long()], bt)
    vf = _gather(vl[heads[:, None], vc.long()], bt)
    out = eq.encode_meta(
        emulate(qf, kf, vf, lengths, *paged_plan(len(lengths), MAX_BLK, bs)),
        oq)
    ref = decode_gqa_paged_codes_ref(qc, kc, vc, ql, kl, vl, oq, bt, lengths)
    jref = torch.from_numpy(np.array(jdec.decode_gqa_paged_codes(
        *(jnp.asarray(a) for a in arrays))))
    zero = eq.encode_meta(torch.zeros(()), oq)
    assert torch.all(out[0] == zero) and torch.all(ref[0] == zero)
    for want in (ref, jref):
        assert out.dtype == want.dtype == torch.uint8
        assert bool(eq.codes_agree(out, want).all())
        assert int((out != want).sum()) <= 1e-3 * want.numel()


# a contiguous cache of S positions: S off the virtual page (130, 200,
# 77) and on it (256); g from 1 to 8 at head_dim 128 and 64, float32 and
# bfloat16 caches (PR 18's ids); then f8 caches, g 10 at head_dim 256
# and g 16 at 128
@pytest.mark.parametrize("dtype,g,hd,s", [
    pytest.param(dt, g, hd, s, id=f"{dt}-{g}-{hd}-{s}")
    for dt in ("float32", "bfloat16")
    for g, hd, s in ((1, 128, 200), (2, 128, 256), (5, 128, 130),
                     (8, 128, 77), (3, 64, 200), (6, 64, 130), (7, 64, 256))
] + [pytest.param(*c, id="-".join(map(str, c))) for c in (
    (F8, 2, 128, 256), (F8, 10, 256, 200), ("float32", 16, 128, 77))])
def test_contiguous_split_order_matches_the_plain_version_and_jax(g, hd, s,
                                                                  dtype):
    """#9 on the split-KV body: a [B, S, n_kv, hd] cache is a pool whose
    row b, position t is pool row b*S + t, partitioned by
    ``contiguous_plan``.  Rows: a zero-length one, length 1, one ending
    mid-row, one filling S, and one past S (clipped to S)."""
    r = np.random.default_rng(g * 1000 + hd + s)
    lengths = np.array([0, 1, s // 2 + 3, s, s + 40], np.int32)
    b = len(lengths)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    q = _bf16_q(r, b, g, hd)
    k, v = (np.array(jnp.asarray(r.normal(size=(b, s, N_KV, hd)), jd)
                     .astype(jnp.float32)) for _ in range(2))
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lengths))
    part, n_split = contiguous_plan(b, N_KV, s, SMS)
    assert n_split > 1 and (n_split - 1) * part < s <= n_split * part
    out = emulate(tq, tk, tv, tl, part, n_split, s)
    ref = decode_gqa_ref(tq, tk.to(td), tv.to(td), tl.clamp(0, s))
    tol = GATE * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= tol
    assert torch.all(out[0] == 0)
    # the port's CPU wrapper clips the length past S as the kernel does
    assert torch.equal(decode_gqa(tq, tk.to(td), tv.to(td), tl), ref)
    jref = np.asarray(jdec.decode_gqa(           # interpret-mode kernel
        jnp.asarray(q), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(lengths)))
    assert np.abs(out.numpy() - jref).max() <= tol
