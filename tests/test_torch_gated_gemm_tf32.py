"""The arithmetic of the card's gated LUT GEMMs (#2 gated, #4 dual-gated
in ``csrc/lut_dequant_matmul.cu``), emulated on the CPU.

Prefill (M > 8, ``gated_tiled``): the products run on TF32 tensor cores,
which read an operand's upper 19 bits.  A decoded weight (and #4's
decoded activation, and float32 x) is split as (hi, lo) = (v cut to
TF32, v - hi), which for a code is the split of its table entry;
bfloat16 x is exact in TF32.  Per 8-row k step, in k-tile order, the
kernel adds x_hi*W_hi, x_hi*W_lo and, unless x is bfloat16, x_lo*W_hi
(``lut_dequant_matmul.passes``); split-K partials are summed in split
order.  Decode (M <= 8, ``gated_skinny``): float32 FMA; warp l of a
128-column block sums rows kb + l + 8 t in order, then the 8 warps are
added in order, then the blocks of a cluster in rank order
(``gated_plan``'s splits), and the epilogue runs once on the full sum.

Held within 1e-4 of the largest magnitude (the kernels' gate on the
card) of the plain versions (``lut_dequant_matmul_gated_ref``,
``..._dual_gated_ref``) and of the JAX package's kernels in interpret
mode, on seeded numpy inputs; uint8 outputs with at most 1e-3 of the
codes one rounding step off.  A single TF32 pass is shown to miss the
gate at K = 2048, which is why the kernel splits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import exponential_quant as jeq
from repro.kernels.lut_dequant_matmul import ops as jops
from repro_torch.core import exponential_quant as eq
from repro_torch.kernels.lut_dequant_matmul.lut_dequant_matmul import (
    GATED_COLS, K_STEP, MAX_CLUSTER, gated_plan, passes)
from repro_torch.kernels.lut_dequant_matmul.ref import (
    apply_activation, decode_weight, lut_dequant_matmul_dual_gated_ref,
    lut_dequant_matmul_gated_ref)

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


def _gated_inputs(m, k, n, seed, x_dtype):
    """x (numpy float32, rounded through bfloat16 when ``x_dtype`` is
    bfloat16, or uint8 activation codes with their table), gate and up
    weights as codes."""
    rng = np.random.default_rng(seed)
    g, u = _quant(rng, (k, n), 7, 0.05), _quant(rng, (k, n), 6, 0.05)
    if x_dtype == "codes":
        return _quant(rng, (m, k), 7, 0.5, x_like=True), g, u
    x = rng.normal(size=(m, k)).astype(np.float32)
    if x_dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, g, u


# ---------------------------------------------------------- emulation --

def emulate_tiled(xv, x_exact, wg, wu, kps, act):
    """The tiled path on decoded float32 operands xv [M, K] and split
    weight pairs wg, wu = (hi, lo) [K, N]: per split, per 32-row k tile,
    per 8-row k step, hi*hi, hi*W_lo, then x_lo*W_hi unless x is exact;
    float32 sums; splits added in order; then act(g) * u."""
    m, k = xv.shape
    xh, xl = split(xv)
    if x_exact:
        assert torch.equal(xh, xv)
    total = None
    for kb in range(0, k, kps):
        ke = min(k, kb + kps)
        accs = []
        for wh, wl in (wg, wu):
            acc = torch.zeros(m, wh.shape[1])
            for t0 in range(kb, ke, K_STEP):
                for k0 in range(t0, min(ke, t0 + K_STEP), 8):
                    s = slice(k0, min(ke, k0 + 8))
                    acc = acc + xh[:, s] @ wh[s]
                    acc = acc + xh[:, s] @ wl[s]
                    if not x_exact:
                        acc = acc + xl[:, s] @ wh[s]
            accs.append(acc)
        total = accs if total is None else [a + b for a, b in zip(total, accs)]
    g, u = total
    return apply_activation(g, act) * u


def emulate_skinny(xv, wg, wu, kps, act):
    """The decode path on decoded float32 operands: 8 k-lanes (warps) a
    block, each summing its rows in order (x * w, then +), then added in
    order, then the cluster's blocks in rank order."""
    m, k = xv.shape
    lanes = torch.arange(KLANES)
    outs = []
    for w in (wg, wu):
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
        outs.append(total)
    return apply_activation(outs[0], act) * outs[1]


def _operands(x, g, u, x_dtype, mode, split_w=True):
    """Decoded x and the weights as the kernel sees them: (hi, lo) pairs
    from the split tables, or plain decoded float32."""
    if x_dtype == "codes":
        # emulate_tiled's split of a decoded activation is its table
        # entry's split
        xc, lx, qx = (_t(a) for a in x)
        xv = table(lx, qx, mode)[xc.long()]
    else:
        xv = _t(x)
    ws = []
    for c, lut, qm in (g, u):
        c, lut, qm = _t(c), _t(lut), _t(qm)
        tab = table(lut, qm, mode)
        if split_w:
            hi, lo = split(tab)
            ws.append((hi[c.long()], lo[c.long()]))
        else:
            ws.append(tab[c.long()])
    return xv, ws


def _references(x, g, u, x_dtype, mode, act, qo=None):
    """The plain version and the JAX kernel (interpret mode) on the same
    inputs; float32 [M, N], or codes under ``qo``."""
    (cg, lg, qg), (cu, lu, qu) = g, u
    if x_dtype == "codes":
        xc, lx, qx = x
        args = (xc, cg, cu, lx, lg, lu, qx, qg, qu)
        kw = dict(activation=act, decode_mode=mode)
        ref = lut_dequant_matmul_dual_gated_ref(
            *map(_t, args), out_qmeta=None if qo is None else _t(qo), **kw)
        jref = jops.lut_dequant_matmul_dual_gated(
            *map(jnp.asarray, args),
            out_qmeta=None if qo is None else jnp.asarray(qo), **kw)
        return ref, torch.from_numpy(np.array(jref))
    xt = _t(x).to(torch.bfloat16 if x_dtype == "bfloat16" else F32)
    jd = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
    ref = lut_dequant_matmul_gated_ref(
        xt, _t(cg), _t(cu), _t(lg), _t(lu), _t(qg), _t(qu), activation=act,
        decode_mode=mode)
    jref = jops.lut_dequant_matmul_gated(
        jnp.asarray(x, jd), jnp.asarray(cg), jnp.asarray(cu), jnp.asarray(lg),
        jnp.asarray(lu), jnp.asarray(qg), jnp.asarray(qu), activation=act,
        decode_mode=mode, out_dtype=jnp.float32)
    return ref, torch.from_numpy(np.array(jref))


def _within_gate(out, ref):
    tol = GATE * max(1.0, ref.abs().max().item())
    err = (out - ref.to(F32)).abs().max().item()
    assert err <= tol, (err, tol)


def _codes_within_gate(out, ref):
    assert out.dtype == ref.dtype == torch.uint8
    assert bool(eq.codes_agree(out, ref).all())
    assert int((out != ref).sum()) <= max(1, 1e-3 * ref.numel())


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


def test_passes_skip_only_the_exact_x_lo():
    assert passes(torch.bfloat16) == 2       # the full config's x
    assert passes(torch.float32) == 3
    assert passes(torch.uint8) == 3          # decoded activation codes


@pytest.mark.parametrize("m,k,n,want", [
    (8, 2048, 6144, (4, 512)),       # the serving decode shape
    (1, 2048, 6144, (4, 512)),
    (8, 600, 70, (2, 320)),
    (3, 100, 130, (1, 128)),         # too short to split
    (8, 4096, 64, (8, 512)),         # one slab: the largest cluster
    (2048, 2048, 6144, (1, 2048)),   # prefill tiles fill the card
    (256, 2048, 6144, (1, 2048)),    # 96 tiles: over half the SMs
    (129, 2048, 200, (4, 512)),      # 4 tiles: split-K, one wave
])
def test_gated_plan(m, k, n, want):
    splits, kps = gated_plan(m, k, n, SMS)
    assert (splits, kps) == want
    assert kps % K_STEP == 0 and (splits - 1) * kps < k <= splits * kps
    if m <= 8:
        assert splits <= MAX_CLUSTER
        assert -(-n // GATED_COLS) * splits <= 2 * SMS or splits == 1


# tiled: ragged M, K (not a multiple of the 32-row tile) and N (not a
# multiple of 16), gather and ALU, bfloat16, float32 and codes x, float
# and uint8 out, and a split-K case
TILED = [
    ("bfloat16", "gather", "silu", 40, 600, 72, False),
    ("float32", "alu", "gelu", 17, 100, 130, False),
    ("codes", "gather", "silu", 33, 300, 96, False),
    ("codes", "alu", "silu", 20, 256, 64, True),
    ("bfloat16", "alu", "relu", 129, 2048, 40, False),    # split-K (4)
]


@pytest.mark.parametrize("x_dtype,mode,act,m,k,n,quant", TILED)
def test_tiled_split_tf32_is_within_the_gate(x_dtype, mode, act, m, k, n,
                                             quant):
    x, g, u = _gated_inputs(m, k, n, m + k + n, x_dtype)
    xv, (wg, wu) = _operands(x, g, u, x_dtype, mode)
    _, kps = gated_plan(m, k, n, SMS)
    out = emulate_tiled(xv, x_dtype == "bfloat16", wg, wu, kps, act)
    ref, jref = _references(x, g, u, x_dtype, mode, act)
    _within_gate(out, ref)
    _within_gate(out, jref)
    if quant:
        qo = np.array(jeq.pack_qmeta(jeq.fit(jnp.asarray(ref.numpy()).reshape(-1), 7)))
        ref_c, jref_c = _references(x, g, u, x_dtype, mode, act, qo)
        out_c = eq.encode_meta(out, _t(qo))
        _codes_within_gate(out_c, ref_c)
        _codes_within_gate(out_c, jref_c)


# skinny: M 1 and 8, K split over a cluster (600: 2 ranks, the last
# partial) or not, N ragged; both x kinds and both decode modes
SKINNY = [
    ("bfloat16", "gather", "silu", 8, 600, 70, False),
    ("float32", "alu", "gelu", 1, 2048, 64, False),
    ("codes", "gather", "silu", 8, 600, 130, True),
    ("codes", "alu", "relu", 5, 100, 48, False),
]


@pytest.mark.parametrize("x_dtype,mode,act,m,k,n,quant", SKINNY)
def test_skinny_split_and_reduce_is_within_the_gate(x_dtype, mode, act, m, k,
                                                    n, quant):
    x, g, u = _gated_inputs(m, k, n, 7 * m + k + n, x_dtype)
    xv, ws = _operands(x, g, u, x_dtype, mode, split_w=False)
    splits, kps = gated_plan(m, k, n, SMS)
    assert splits > 1 or k < 512
    out = emulate_skinny(xv, *ws, kps, act)
    ref, jref = _references(x, g, u, x_dtype, mode, act)
    _within_gate(out, ref)
    _within_gate(out, jref)
    if quant:
        # the encode runs once, on the cluster's full sum
        qo = np.array(jeq.pack_qmeta(jeq.fit(jnp.asarray(ref.numpy()).reshape(-1), 7)))
        ref_c, jref_c = _references(x, g, u, x_dtype, mode, act, qo)
        out_c = eq.encode_meta(out, _t(qo))
        _codes_within_gate(out_c, ref_c)
        _codes_within_gate(out_c, jref_c)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32", "codes"])
def test_single_tf32_pass_misses_the_gate(x_dtype):
    """At K = 2048 one TF32 pass (operands cut, no lo terms) misses 1e-4;
    the kernel's pass set is within it on the same inputs."""
    m, k, n = 16, 2048, 64
    x, g, u = _gated_inputs(m, k, n, 3, x_dtype)
    xv, (wg, wu) = _operands(x, g, u, x_dtype, "gather")
    ref = (lut_dequant_matmul_dual_gated_ref if x_dtype == "codes"
           else lut_dequant_matmul_gated_ref)
    if x_dtype == "codes":
        (cg, lg, qg), (cu, lu, qu) = g, u
        want = ref(*map(_t, (x[0], cg, cu, x[1], lg, lu, x[2], qg, qu)))
    else:
        (cg, lg, _), (cu, lu, _) = g, u
        want = ref(_t(x), _t(cg), _t(cu), _t(lg), _t(lu))
    tol = GATE * max(1.0, want.abs().max().item())
    one = apply_activation(tf32(xv) @ wg[0], "silu") * (tf32(xv) @ wu[0])
    assert (one - want).abs().max().item() > 2 * tol
    _within_gate(emulate_tiled(xv, x_dtype == "bfloat16", wg, wu, k, "silu"),
                 want)
