"""The arithmetic of the card's LUT GEMMs (``csrc/lut_dequant_matmul.cu``:
#1 plain and #3 dual on one weight, #2 gated and #4 dual-gated on two),
emulated on the CPU.

Prefill (M > 8, ``mm_tiled``): the products run on tensor cores in split
form.  Float x: TF32, which reads an operand's upper 19 bits; a decoded
weight (and float32 x) is split as (hi, lo) = (v cut to TF32, v - hi),
which for a code is the split of its table entry; bfloat16 x is exact in
TF32.  Per 8-row k step, in k order, the kernel adds x_hi*W_hi,
x_hi*W_lo and, unless x is bfloat16, x_lo*W_hi.  Activation codes
(uint8 x): both decoded operands split into bf16 (hi, lo) = (v rounded to
bf16, v - hi rounded to bf16) and, per 16-row k step, x_hi*W_hi,
x_hi*W_lo, x_lo*W_hi (``lut_dequant_matmul.passes``, ``pass_kind``).  The tied
unembedding at M > 8 (codes [N, K]) runs the same TF32 k steps on its
transposed weight.  Split-K partials are summed in split order.  Decode (M <= 8,
``mm_skinny``): float32 FMA; warp l of a 128-column block sums rows
kb + l + 8 t in order, then the 8 warps are added in order, then the
blocks of a cluster in rank order (``gemm_plan``'s splits), and the
epilogue (bias and activation, or act(g) * u, then the encode) runs once
on the full sum.  The tied unembedding at M <= 8 (``mm_stream_t``, codes
[N, K]): bf16 tensor-core passes W_hi*x, W_lo*x (+ W_hi*x_lo for float32
x), one per 16-k slice of each 64-k step, in k order.

Held within 1e-4 of the largest magnitude (the kernels' gate on the
card) of the plain versions and of the JAX package's kernels in
interpret mode, on seeded numpy inputs; uint8 outputs with at most 1e-3
of the codes one rounding step off.  A single TF32 pass, and the bf16
splits cheaper than the kernel's, are shown to miss the gate at
K = 2048.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import exponential_quant as jeq
from repro.kernels.lut_dequant_matmul import ops as jops
from repro_torch.core import exponential_quant as eq
from repro_torch.kernels.lut_dequant_matmul.lut_dequant_matmul import (
    K_STEP, MAX_CLUSTER, SLAB_COLS, gemm_plan, pass_kind, passes)
from repro_torch.kernels.lut_dequant_matmul.ref import (
    apply_activation, decode_weight, lut_dequant_matmul_dual_gated_ref,
    lut_dequant_matmul_dual_ref, lut_dequant_matmul_gated_ref,
    lut_dequant_matmul_ref)

F32 = torch.float32
GATE = 1e-4          # chip_smoke.py's bound for float outputs
SMS = 132            # an H100's SMs, for the split plans
KLANES = 8           # decode block: one k-lane a warp (128 columns)
ALL_CODES = torch.arange(256, dtype=torch.uint8)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 cut to TF32 as the tensor core reads it: the low 13 bits
    of the pattern cleared."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return (bits & -0x2000).view(F32)


def split(v: torch.Tensor):
    """The kernel's ``tf32_split``: hi = tf32(v), lo = v - hi (exact),
    which reaches the tensor core as tf32(lo)."""
    hi = tf32(v)
    return hi, tf32(v - hi)


def bf16(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bf16 (to nearest even), as float32."""
    return v.to(torch.bfloat16).to(F32)


def bsplit(v: torch.Tensor):
    """The kernel's ``bf16_pair``: hi = bf16(v), lo = bf16(v - hi)."""
    hi = bf16(v)
    return hi, bf16(v - hi)


def table(lut, qmeta, mode) -> torch.Tensor:
    """The 256 values the kernel puts in shared memory (gather or ALU)."""
    return decode_weight(ALL_CODES, lut, qmeta, mode)


# ------------------------------------------------------------- inputs --

def _quant(rng, shape, bits, scale, x_like=False):
    """(codes, lut, qmeta) as numpy, quantized by the JAX package."""
    v = rng.normal(size=shape).astype(np.float32) * scale
    if x_like:
        p = jeq.fit(jnp.asarray(v).reshape(-1), bits)
        c = jeq.encode(jnp.asarray(v), p)
    else:
        c, p = jeq.quantize(jnp.asarray(v), bits)
    return np.array(c), np.array(jeq.decode_table(p)), np.array(jeq.pack_qmeta(p))


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(m, k, n, seed, x_dtype, nw=2, transposed=False):
    """x (numpy float32, rounded through bfloat16 when ``x_dtype`` is
    bfloat16, or uint8 activation codes with their table), ``nw``
    weights as codes ([K, N], or [N, K] when ``transposed``) and a bias
    (one weight only)."""
    rng = np.random.default_rng(seed)
    shape = (n, k) if transposed else (k, n)
    ws = [_quant(rng, shape, bits, 0.05) for bits in (7, 6)[:nw]]
    bias = rng.normal(size=(n,)).astype(np.float32) if nw == 1 else None
    if x_dtype == "codes":
        return _quant(rng, (m, k), 7, 0.5, x_like=True), ws, bias
    x = rng.normal(size=(m, k)).astype(np.float32)
    if x_dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, ws, bias


# ---------------------------------------------------------- emulation --

def emulate_tiled(xv, x_dtype, ws, kps, terms=None):
    """The prefill path on decoded float32 operands xv [M, K] and weights
    ws [K, N]: per split, per k step (8 rows TF32, 16 rows bf16 for codes
    x), the pass products in order; float32 sums; splits added in order.
    ``terms`` overrides the pass set: a subset of "hh", "hl", "lh" (x
    part, weight part).  Returns each weight's sum."""
    m, k = xv.shape
    codes = x_dtype == "codes"
    cut = bsplit if codes else split
    step = 16 if codes else 8
    if terms is None:
        terms = ("hh", "hl") if x_dtype == "bfloat16" else ("hh", "hl", "lh")
    xh, xl = cut(xv)
    if x_dtype == "bfloat16":
        assert torch.equal(xh, xv)
    sums = []
    for w in ws:
        wh, wl = cut(w)
        parts = {"h": (xh, wh), "l": (xl, wl)}
        total = torch.zeros(m, w.shape[1])
        for kb in range(0, k, kps):
            ke = min(k, kb + kps)
            acc = torch.zeros(m, w.shape[1])
            for k0 in range(kb, ke, step):
                s = slice(k0, min(ke, k0 + step))
                for xp, wp in terms:
                    acc = acc + parts[xp][0][:, s] @ parts[wp][1][s]
            total = total + acc
        sums.append(total)
    return sums


def emulate_skinny(xv, ws, kps):
    """The decode path on decoded float32 operands: 8 k-lanes (warps) a
    block, each summing its rows in order (x * w, then +), then added in
    order, then the cluster's blocks in rank order.  Returns each
    weight's sum."""
    m, k = xv.shape
    lanes = torch.arange(KLANES)
    sums = []
    for w in ws:
        total = torch.zeros(m, w.shape[1])
        for kb in range(0, k, kps):
            ke = min(k, kb + kps)
            acc = torch.zeros(KLANES, m, w.shape[1])
            for r0 in range(kb, ke, KLANES):
                rows = r0 + lanes
                live = rows < ke
                rows = torch.where(live, rows, 0)
                xs = torch.where(live[None], xv[:, rows], 0.0)  # [m, lanes]
                acc = acc + xs.t()[:, :, None] * w[rows][:, None, :]
            block = torch.zeros_like(total)
            for q in range(KLANES):
                block = block + acc[q]
            total = total + block
        sums.append(total)
    return sums


def emulate_stream_t(xv, x_dtype, w_nk):
    """The transposed decode path: codes [N, K] decoded to w_nk, split
    bf16 hi + lo; x bf16 (exact) or split.  Lane t of a column reads k
    16 t .. 16 t + 15 of each 64-k step; slice s of the step is k
    {16 t + 4 s + r}: passes W_hi.x_hi, W_lo.x_hi (+ W_hi.x_lo), slices
    in order."""
    m, k = xv.shape
    wh, wl = bsplit(w_nk)
    xh, xl = bsplit(xv)
    if x_dtype == "bfloat16":
        assert torch.equal(xh, xv)
    acc = torch.zeros(w_nk.shape[0], m)
    for k0 in range(0, k, 64):
        for s in range(4):
            idx = torch.tensor([k0 + 16 * t + 4 * s + r for t in range(4)
                                for r in range(4)])
            idx = idx[idx < k]
            acc = acc + wh[:, idx] @ xh[:, idx].t()
            acc = acc + wl[:, idx] @ xh[:, idx].t()
            if x_dtype != "bfloat16":
                acc = acc + wh[:, idx] @ xl[:, idx].t()
    return acc.t()


def _finish(sums, act, bias=None):
    """The epilogue: act(g) * u on two weights, act(y + bias) on one."""
    if len(sums) == 2:
        return apply_activation(sums[0], act) * sums[1]
    y = sums[0] if bias is None else sums[0] + _t(bias)[None, :]
    return apply_activation(y, act)


def _operands(x, ws, x_dtype, mode):
    """Decoded x and weights as float32 (x from its table when codes)."""
    if x_dtype == "codes":
        xc, lx, qx = (_t(a) for a in x)
        xv = table(lx, qx, mode)[xc.long()]
    else:
        xv = _t(x)
    wd = [table(_t(lut), _t(qm), mode)[_t(c).long()] for c, lut, qm in ws]
    return xv, wd


def _references(x, ws, x_dtype, mode, act, bias=None, qo=None,
                transposed=False):
    """The plain version and the JAX kernel (interpret mode) on the same
    inputs; float32 [M, N], or codes under ``qo``."""
    qo_t = None if qo is None else _t(qo)
    qo_j = None if qo is None else jnp.asarray(qo)
    if len(ws) == 2:
        (cg, lg, qg), (cu, lu, qu) = ws
        kw = dict(activation=act, decode_mode=mode)
        if x_dtype == "codes":
            xc, lx, qx = x
            args = (xc, cg, cu, lx, lg, lu, qx, qg, qu)
            ref = lut_dequant_matmul_dual_gated_ref(*map(_t, args),
                                                    out_qmeta=qo_t, **kw)
            jref = jops.lut_dequant_matmul_dual_gated(
                *map(jnp.asarray, args), out_qmeta=qo_j, **kw)
            return ref, torch.from_numpy(np.array(jref))
        xt = _t(x).to(torch.bfloat16 if x_dtype == "bfloat16" else F32)
        jd = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
        ref = lut_dequant_matmul_gated_ref(
            xt, _t(cg), _t(cu), _t(lg), _t(lu), _t(qg), _t(qu), **kw)
        jref = jops.lut_dequant_matmul_gated(
            jnp.asarray(x, jd), jnp.asarray(cg), jnp.asarray(cu),
            jnp.asarray(lg), jnp.asarray(lu), jnp.asarray(qg), jnp.asarray(qu),
            out_dtype=jnp.float32, **kw)
        return ref, torch.from_numpy(np.array(jref))
    (c, lut, qm), = ws
    kw = dict(epilogue=act, decode_mode=mode)
    if x_dtype == "codes":
        xc, lx, qx = x
        args = (xc, c, lx, lut, qx, qm)
        ref = lut_dequant_matmul_dual_ref(*map(_t, args), out_qmeta=qo_t,
                                          bias=_t(bias), **kw)
        jref = jops.lut_dequant_matmul_dual(
            *map(jnp.asarray, args), out_qmeta=qo_j, bias=jnp.asarray(bias),
            **kw)
        return ref, torch.from_numpy(np.array(jref))
    xt = _t(x).to(torch.bfloat16 if x_dtype == "bfloat16" else F32)
    jd = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
    ref = lut_dequant_matmul_ref(xt, _t(c), _t(lut), _t(qm), bias=_t(bias),
                                 transpose_codes=transposed, **kw)
    jref = jops.lut_dequant_matmul(
        jnp.asarray(x, jd), jnp.asarray(c), jnp.asarray(lut), jnp.asarray(qm),
        bias=jnp.asarray(bias), transpose_codes=transposed,
        out_dtype=jnp.float32, **kw)
    return ref, torch.from_numpy(np.array(jref))


def _within_gate(out, ref):
    tol = GATE * max(1.0, ref.abs().max().item())
    err = (out - ref.to(F32)).abs().max().item()
    assert err <= tol, (err, tol)


def _codes_within_gate(out, ref):
    assert out.dtype == ref.dtype == torch.uint8
    assert bool(eq.codes_agree(out, ref).all())
    assert int((out != ref).sum()) <= max(1, 1e-3 * ref.numel())


def _check_against_references(out, x, ws, x_dtype, mode, act, bias, quant):
    """``out`` within the gate of the plain version and the JAX kernel;
    with ``quant``, its encode under a table fitted on the result within
    the codes gate of both (the encode runs once, on the full sum)."""
    ref, jref = _references(x, ws, x_dtype, mode, act, bias)
    _within_gate(out, ref)
    _within_gate(out, jref)
    if quant:
        qo = np.array(jeq.pack_qmeta(jeq.fit(jnp.asarray(ref.numpy()).reshape(-1), 7)))
        ref_c, jref_c = _references(x, ws, x_dtype, mode, act, bias, qo)
        out_c = eq.encode_meta(out, _t(qo))
        _codes_within_gate(out_c, ref_c)
        _codes_within_gate(out_c, jref_c)


# --------------------------------------------------------------- tests --

def test_split_tables_are_exact_tf32_pairs():
    """hi and lo of every table entry (the split of every decoded value)
    are TF32 values and sum back to the entry within 2^-20 of it;
    bfloat16 x needs no split."""
    rng = np.random.default_rng(0)
    _, lut, qmeta = _quant(rng, (64, 64), 7, 0.05)
    for mode in ("gather", "alu"):
        v = table(_t(lut), _t(qmeta), mode)
        hi, lo = split(v)
        assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
        assert torch.equal(hi + (v - hi), v)
        rel = ((hi.double() + lo.double() - v.double()).abs()
               / v.double().abs().clamp_min(1e-30)).max()
        assert rel <= 2.0 ** -20
    bf = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    bf = bf.to(torch.bfloat16).to(F32)
    assert torch.equal(tf32(bf), bf)


def test_bf16_pair_tables_sum_back_within_2_to_the_minus_16():
    """The codes path's tables: hi and lo of every entry (weights and
    activations, gather and ALU) are bf16 values whose sum is within
    2^-16 of the entry; the product of two entries' splits drops lo*lo
    and both remainders, each within 2^-16 of the product."""
    rng = np.random.default_rng(0)
    for shape, x_like in (((64, 64), False), ((8, 256), True)):
        _, lut, qmeta = _quant(rng, shape, 7, 0.5 if x_like else 0.05, x_like)
        for mode in ("gather", "alu"):
            v = table(_t(lut), _t(qmeta), mode)
            hi, lo = bsplit(v)
            assert torch.equal(bf16(hi), hi) and torch.equal(bf16(lo), lo)
            rel = ((hi.double() + lo.double() - v.double()).abs()
                   / v.double().abs().clamp_min(1e-30)).max()
            assert rel <= 2.0 ** -16


def test_passes_skip_only_the_exact_x_lo():
    assert passes(torch.bfloat16) == 2       # the full config's x
    assert passes(torch.float32) == 3
    assert passes(torch.uint8) == 3          # decoded activation codes
    assert pass_kind(torch.uint8) == "bf16"
    assert pass_kind(torch.bfloat16) == pass_kind(torch.float32) == "tf32"


@pytest.mark.parametrize("m,k,n,nw,want", [
    (8, 2048, 6144, 2, (4, 512)),       # the serving decode shape
    (1, 2048, 6144, 2, (4, 512)),
    (8, 600, 70, 2, (2, 320)),
    (3, 100, 130, 2, (1, 128)),         # too short to split
    (8, 4096, 64, 2, (8, 512)),         # one slab: the largest cluster
    (2048, 2048, 6144, 2, (1, 2048)),   # prefill tiles fill the card
    (256, 2048, 6144, 2, (1, 2048)),    # 96 tiles: over half the SMs
    (129, 2048, 200, 2, (4, 512)),      # 4 tiles: split-K, one wave
    # one weight: the plain and dual GEMMs of the serving path
    (8, 2048, 2048, 1, (8, 256)),       # 16 slabs x the largest cluster
    (8, 2048, 1024, 1, (8, 256)),
    (8, 6144, 2048, 1, (8, 768)),
    (8, 600, 70, 1, (2, 320)),
    (2048, 2048, 2048, 1, (1, 2048)),   # 256 tiles fill two an SM
    (2048, 2048, 1024, 1, (1, 2048)),   # 128 tiles: over half the SMs
    (256, 2048, 2048, 1, (8, 256)),     # 32 tiles: 264 blocks at most
    (256, 2048, 1024, 1, (8, 256)),     # 16 tiles: 256 rows a split
    (256, 6144, 2048, 1, (8, 768)),
    (200, 2048, 64, 1, (8, 256)),
])
def test_gated_plan(m, k, n, nw, want):
    splits, kps = gemm_plan(m, k, n, SMS, nw)
    assert (splits, kps) == want
    assert kps % K_STEP == 0 and (splits - 1) * kps < k <= splits * kps
    if m <= 8:
        assert splits <= MAX_CLUSTER
        assert -(-n // SLAB_COLS) * splits <= 2 * SMS or splits == 1


@pytest.mark.parametrize("m,k,n", [(8, 2048, 151936), (1, 520, 77),
                                   (200, 2048, 64)])
def test_transposed_plan(m, k, n):
    """The tied unembedding does not split K at decode (its code rows
    stream over N); at M > 8 it follows the one-weight tile plan."""
    got = gemm_plan(m, k, n, SMS, 1, transposed=True)
    if m <= 8:
        assert got == (1, k)
    else:
        assert got == gemm_plan(m, k, n, SMS, 1)


# tiled: ragged M, K (not a multiple of the 32-row tile) and N (not a
# multiple of 16), gather and ALU, bfloat16, float32 and codes x, float
# and uint8 out, split-K cases; one weight (#1/#3, bias and activation)
# and two (#2/#4, act(g) * u)
TILED = [
    ("bfloat16", "gather", "silu", 40, 600, 72, False, 2),
    ("float32", "alu", "gelu", 17, 100, 130, False, 2),
    ("codes", "gather", "silu", 33, 300, 96, False, 2),
    ("codes", "alu", "silu", 20, 256, 64, True, 2),
    ("bfloat16", "alu", "relu", 129, 2048, 40, False, 2),    # split-K (4)
    ("bfloat16", "gather", None, 40, 600, 72, False, 1),
    ("float32", "alu", "gelu", 17, 100, 130, False, 1),
    ("bfloat16", "gather", "silu", 200, 2048, 64, False, 1),  # split-K (8)
    ("codes", "gather", "relu", 33, 300, 96, True, 1),
    ("codes", "alu", None, 20, 256, 64, True, 1),
    ("codes", "gather", "gelu", 129, 2048, 40, True, 1),     # split-K (8)
]


@pytest.mark.parametrize("x_dtype,mode,act,m,k,n,quant,nw", TILED)
def test_tiled_split_tf32_is_within_the_gate(x_dtype, mode, act, m, k, n,
                                             quant, nw):
    """The prefill k-step order (TF32 for float x, bf16 split for codes
    x), within the gates of the plain version and the JAX kernel."""
    x, ws, bias = _inputs(m, k, n, m + k + n, x_dtype, nw)
    xv, wd = _operands(x, ws, x_dtype, mode)
    _, kps = gemm_plan(m, k, n, SMS, nw)
    out = _finish(emulate_tiled(xv, x_dtype, wd, kps), act, bias)
    _check_against_references(out, x, ws, x_dtype, mode, act, bias, quant)


@pytest.mark.parametrize("x_dtype,mode,act,m,k,n", [
    ("bfloat16", "gather", "silu", 40, 600, 72),
    ("float32", "alu", None, 17, 100, 130),
    ("bfloat16", "gather", "gelu", 200, 2048, 64),    # split-K (8)
])
def test_tiled_transposed_is_within_the_gate(x_dtype, mode, act, m, k, n):
    """The tied unembedding at M > 8 (codes [N, K], staged transposed
    into the one-weight prefill tile): the same TF32 k steps on the
    transposed weight, within the gate of the plain version and the JAX
    kernel (``transpose_codes``)."""
    x, ws, bias = _inputs(m, k, n, m + 2 * k + n, x_dtype, 1, transposed=True)
    xv, (w_nk,) = _operands(x, ws, x_dtype, mode)
    _, kps = gemm_plan(m, k, n, SMS, 1, transposed=True)
    out = _finish(emulate_tiled(xv, x_dtype, [w_nk.t()], kps), act, bias)
    ref, jref = _references(x, ws, x_dtype, mode, act, bias, transposed=True)
    _within_gate(out, ref)
    _within_gate(out, jref)


# skinny: M 1 and 8, K split over a cluster (600: 2 ranks, the last
# partial) or not, N ragged; both x kinds and both decode modes; one
# and two weights
SKINNY = [
    ("bfloat16", "gather", "silu", 8, 600, 70, False, 2),
    ("float32", "alu", "gelu", 1, 2048, 64, False, 2),
    ("codes", "gather", "silu", 8, 600, 130, True, 2),
    ("codes", "alu", "relu", 5, 100, 48, False, 2),
    ("bfloat16", "gather", "gelu", 8, 2048, 200, False, 1),   # a cluster of 8
    ("float32", "alu", None, 1, 600, 70, False, 1),
    ("codes", "gather", "silu", 8, 600, 130, True, 1),
    ("codes", "alu", "relu", 5, 2048, 64, True, 1),
]


@pytest.mark.parametrize("x_dtype,mode,act,m,k,n,quant,nw", SKINNY)
def test_skinny_split_and_reduce_is_within_the_gate(x_dtype, mode, act, m, k,
                                                    n, quant, nw):
    x, ws, bias = _inputs(m, k, n, 7 * m + k + n, x_dtype, nw)
    xv, wd = _operands(x, ws, x_dtype, mode)
    splits, kps = gemm_plan(m, k, n, SMS, nw)
    assert splits > 1 or k < 512
    out = _finish(emulate_skinny(xv, wd, kps), act, bias)
    _check_against_references(out, x, ws, x_dtype, mode, act, bias, quant)


@pytest.mark.parametrize("x_dtype,mode,act,m,k,n", [
    ("bfloat16", "gather", None, 8, 2048, 48),
    ("bfloat16", "alu", "silu", 3, 600, 37),      # K off the 64-k step
    ("float32", "gather", "relu", 8, 100, 20),
])
def test_stream_t_slices_are_within_the_gate(x_dtype, mode, act, m, k, n):
    """The tied unembedding's decode body: codes [N, K], bf16 W hi + lo
    against x on the tensor cores, within the gate of the plain version
    and the JAX kernel (``transpose_codes``)."""
    x, ws, bias = _inputs(m, k, n, 3 * m + k, x_dtype, 1, transposed=True)
    xv, (w_nk,) = _operands(x, ws, x_dtype, mode)
    out = _finish([emulate_stream_t(xv, x_dtype, w_nk)], act, bias)
    ref, jref = _references(x, ws, x_dtype, mode, act, bias, transposed=True)
    _within_gate(out, ref)
    _within_gate(out, jref)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32", "codes"])
def test_single_tf32_pass_misses_the_gate(x_dtype):
    """At K = 2048 one TF32 pass (operands cut, no lo terms) misses 1e-4;
    the kernel's pass set is within it on the same inputs."""
    m, k, n = 16, 2048, 64
    x, ws, _ = _inputs(m, k, n, 3, x_dtype)
    xv, wd = _operands(x, ws, x_dtype, "gather")
    ref, _ = _references(x, ws, x_dtype, "gather", "silu")
    tol = GATE * max(1.0, ref.abs().max().item())
    one = _finish([tf32(xv) @ tf32(w) for w in wd], "silu")
    assert (one - ref).abs().max().item() > 2 * tol
    _within_gate(_finish(emulate_tiled(xv, x_dtype, wd, k), "silu"), ref)


@pytest.mark.parametrize("terms", [("hh",), ("hh", "hl"), ("hh", "lh")])
def test_cheaper_bf16_splits_miss_the_gate(terms):
    """Codes x at K = 2048: bf16 hi*hi alone, or two of the three terms,
    misses 1e-4 of the largest magnitude; the kernel's three are within
    it on the same inputs (one weight, float out)."""
    m, k, n = 16, 2048, 64
    x, ws, bias = _inputs(m, k, n, 5, "codes", 1)
    xv, wd = _operands(x, ws, "codes", "gather")
    ref, _ = _references(x, ws, "codes", "gather", None, bias)
    tol = GATE * max(1.0, ref.abs().max().item())
    cheap = _finish(emulate_tiled(xv, "codes", wd, k, terms), None, bias)
    assert (cheap - ref).abs().max().item() > 2 * tol
    _within_gate(_finish(emulate_tiled(xv, "codes", wd, k), None, bias), ref)
