"""DNA-TEQ adaptive exponential quantization (port of the JAX package's
``core/exponential_quant.py``).

Values are ``S * (alpha * base**e + beta)``; a quantized tensor stores one
uint8 code per element, ``code = S_bit << 7 | (e - e_min)``, and decodes
through a 256-entry table.  Every function here follows the reference's
float32 arithmetic step for step (same operation order, same
round-half-to-even, same clipping), so codes agree with the reference
except where a one-ulp difference between math libraries moves a value
across a rounding boundary.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

F32 = torch.float32


class ExpQuantParams(NamedTuple):
    """Per-tensor parameters; ``alpha``/``beta``/``base`` are float32
    tensors (0-d, or ``[L]`` for a layer-stacked fit)."""

    alpha: torch.Tensor
    beta: torch.Tensor
    base: torch.Tensor
    bits: int

    @property
    def e_min(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def e_max(self) -> int:
        return 2 ** (self.bits - 1) - 1


class QWeight(nn.Module):
    """A quantized weight: ``codes`` (uint8, the logical shape), its
    decode table ``lut`` (``[256]`` float32, ``[L, 256]`` when stacked)
    and packed fit parameters ``qmeta`` (``[4]`` = alpha, beta, base,
    bits; ``[L, 4]`` when stacked).  The counterpart of the reference's
    ``{codes, lut, qmeta}`` leaf dict; registered as buffers so the
    carrier moves with its module."""

    def __init__(self, codes: torch.Tensor, lut: torch.Tensor,
                 qmeta: torch.Tensor):
        super().__init__()
        self.register_buffer("codes", codes)
        self.register_buffer("lut", lut)
        self.register_buffer("qmeta", qmeta)

    def layer(self, i: int) -> "QWeight":
        """Layer ``i`` of a stacked carrier (views, no copies)."""
        return QWeight(self.codes[i], self.lut[i], self.qmeta[i])


class QTensor(NamedTuple):
    """The activation carrier: uint8 ``codes`` (the logical shape), their
    decode table ``lut`` ``[256]`` and packed params ``qmeta`` ``[4]``.
    The counterpart of the reference's ``eq.QTensor``; activations flow
    between quantized matmuls in it, never decoded outside a kernel on
    the fused path.  :func:`is_qtensor` and :func:`qt_parts` treat it and
    :class:`QWeight` alike."""

    codes: torch.Tensor
    lut: torch.Tensor
    qmeta: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.codes.shape

    @property
    def ndim(self) -> int:
        return self.codes.ndim

    @property
    def dtype(self) -> torch.dtype:
        """The carrier's decode dtype (what consumers compute in)."""
        return self.lut.dtype


def _bcast(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``[L]`` parameter against a ``[L, ...]`` tensor."""
    return p.reshape(p.shape + (1,) * (x.ndim - p.ndim)) if p.ndim else p


def _sign_bit(x: torch.Tensor) -> torch.Tensor:
    return (x < 0).to(torch.uint8)


def exponent_of(x: torch.Tensor, params: ExpQuantParams) -> torch.Tensor:
    """Nearest exponent for |x| (int32, clipped to range)."""
    mag = x.abs().to(F32)
    arg = (mag - _bcast(params.beta, mag)) / _bcast(params.alpha, mag)
    arg = torch.clamp_min(arg, 1e-30)
    e = torch.round(torch.log(arg) / torch.log(_bcast(params.base, mag)))
    return e.clamp(params.e_min, params.e_max).to(torch.int32)


def encode(x: torch.Tensor, params: ExpQuantParams) -> torch.Tensor:
    """Quantize to uint8 codes ``S<<7 | biased_exponent``."""
    biased = (exponent_of(x, params) - params.e_min).to(torch.uint8)
    return (_sign_bit(x) << 7) | biased


def split_code(codes: torch.Tensor, params: ExpQuantParams):
    """codes -> (sign in {+1, -1} int8, exponent int32)."""
    sign = torch.where((codes >> 7) > 0, -1, 1).to(torch.int8)
    e = (codes & 0x7F).to(torch.int32) + params.e_min
    return sign, e


def decode_table(params: ExpQuantParams, dtype=F32) -> torch.Tensor:
    """The 256-entry decode table indexed by code (``[..., 256]``)."""
    dev = params.alpha.device
    code = torch.arange(256, dtype=torch.int32, device=dev)
    sign = torch.where((code >> 7) > 0, -1.0, 1.0).to(F32)
    e = (code & 0x7F).to(F32) + params.e_min
    alpha, beta, base = (params.alpha[..., None], params.beta[..., None],
                         params.base[..., None])
    # the reference's float32 pow is correctly rounded: take it in
    # float64 and round, which reproduces it bit for bit
    power = torch.pow(base.double(), e.double()).to(F32)
    mag = alpha * power + beta
    return (sign * mag).to(dtype)


def decode(codes: torch.Tensor, params: ExpQuantParams,
           dtype=F32) -> torch.Tensor:
    """Dequantize codes through the 256-entry table."""
    return decode_table(params, dtype)[codes.long()]


def pack_qmeta(params: ExpQuantParams) -> torch.Tensor:
    """``[..., 4]`` float32 (alpha, beta, base, bits)."""
    bits = torch.full_like(params.alpha, float(params.bits), dtype=F32)
    return torch.stack([params.alpha.to(F32), params.beta.to(F32),
                        params.base.to(F32), bits], dim=-1)


def encode_meta(x: torch.Tensor, qmeta: torch.Tensor) -> torch.Tensor:
    """Encode from a packed ``[..., 4]`` qmeta (bits carried as data);
    leading qmeta dims broadcast against ``x``."""
    alpha, beta, base, bits = qmeta.unbind(-1)
    e_min = -torch.exp2(bits - 1.0)
    e_max = torch.exp2(bits - 1.0) - 1.0
    mag = x.abs().to(F32)
    arg = torch.clamp_min((mag - beta) / alpha, 1e-30)
    e = torch.round(torch.log(arg) / torch.log(base))
    e = torch.minimum(torch.maximum(e, e_min), e_max)
    biased = (e - e_min).to(torch.uint8)
    return (_sign_bit(x) << 7) | biased


def decode_meta(codes: torch.Tensor, qmeta: torch.Tensor,
                dtype=F32) -> torch.Tensor:
    """ALU decode ``sign * (alpha * exp(e * log(base)) + beta)`` from a
    packed ``[..., 4]`` qmeta (no table)."""
    alpha, beta, base, bits = qmeta.unbind(-1)
    e_min = -torch.exp2(bits - 1.0)
    c = codes.to(torch.int32)
    sign = 1.0 - 2.0 * (c >> 7).to(F32)
    e = (c & 0x7F).to(F32) + e_min
    mag = alpha * torch.exp(e * torch.log(base)) + beta
    return (sign * mag).to(dtype)


def code_order(codes: torch.Tensor, qmeta: torch.Tensor) -> torch.Tensor:
    """Each code's place in the order the encoder gives codes along the
    real line under the packed ``qmeta [..., 4]`` (leading dims broadcast
    against the codes as in :func:`encode_meta`): negative inputs by
    falling magnitude, then positive ones by rising.  Zero's code (the
    exponent the encoder gives ``|x| = 0``: exponent 0 when beta >= 0,
    higher when beta < 0) and its negative twin are neighbours; the
    exponents below it, which the encoder never gives, share its
    place."""
    c = codes.to(torch.int32)
    zero = encode_meta(torch.zeros((), device=qmeta.device), qmeta)
    d = torch.clamp_min((c & 0x7F) - (zero & 0x7F).to(torch.int32), 0)
    return torch.where((c >> 7) > 0, -d - 1, d)


def codes_agree(a: torch.Tensor, b: torch.Tensor,
                qmeta: torch.Tensor) -> torch.Tensor:
    """Elementwise: the codes are equal, or one rounding step apart under
    the out table ``qmeta`` -- neighbours in :func:`code_order`.  Two
    encoders of the same value differ by no more than this when their
    float inputs or their ``log`` differ in the last bits: adjacent
    exponents of one sign, or, for a value near zero whose sign the two
    float sums disagree on, zero's two codes (the smallest magnitudes
    when beta >= 0; two codes above exponent 0 when beta < 0)."""
    return (code_order(a, qmeta) - code_order(b, qmeta)).abs() <= 1


# ----------------------------------------------------------------- fit --

def _percentile_linear(sorted_rows: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile(..., method='linear')`` of each (NaN-free) row of
    an ascending-sorted ``[L, n]`` tensor, with the reference's float32
    index arithmetic.  (``torch.quantile`` refuses inputs above 2**24
    elements; the tied embedding table has 311 M.)"""
    n = sorted_rows.shape[-1]
    dev = sorted_rows.device
    q = torch.tensor(pct, dtype=F32) / 100.0
    idx = q * (torch.tensor(float(n), dtype=F32) - 1.0)
    low, high = torch.floor(idx), torch.ceil(idx)
    hw = idx - low
    lw = 1.0 - hw
    li = int(min(max(low.item(), 0.0), n - 1))
    hi = int(min(max(high.item(), 0.0), n - 1))
    return (sorted_rows[:, li] * lw.to(dev)) + (sorted_rows[:, hi] * hw.to(dev))


def _init_range(mag: torch.Tensor):
    """(lo, hi) initial magnitude range per row of ``mag [L, n]``.

    The reference takes ``jnp.percentile`` of ``where(mag > 0, mag,
    nan)``, which is *not* a nan-percentile: a single exact zero (or
    NaN) in a row makes the result NaN, and ``nan_to_num`` then starts
    that row's fit from ``lo=1e-6, hi=1.0``.  Reproduced exactly."""
    has_nan = ~(mag > 0).all(dim=-1)
    srt = torch.sort(mag, dim=-1).values
    lo = _percentile_linear(srt, 1.0)
    hi = _percentile_linear(srt, 99.5)
    del srt
    lo = torch.where(has_nan, torch.tensor(1e-6, dtype=F32, device=mag.device), lo)
    hi = torch.where(has_nan, torch.tensor(1.0, dtype=F32, device=mag.device), hi)
    hi = torch.maximum(hi, lo * (1.0 + 1e-3))
    return lo, hi


def _ls_alpha_beta(powers, mag, weights):
    """Closed-form weighted least squares ``mag ~ alpha*powers + beta``
    per row."""
    w = weights
    sw = w.sum(-1) + 1e-12
    mx = (w * powers).sum(-1) / sw
    my = (w * mag).sum(-1) / sw
    cov = (w * (powers - mx[:, None]) * (mag - my[:, None])).sum(-1)
    var = (w * (powers - mx[:, None]) ** 2).sum(-1) + 1e-12
    alpha = cov / var
    beta = my - alpha * mx
    return alpha, beta


def _fit_one_base(mag, live, lo, hi, base: torch.Tensor, bits: int,
                  iters: int = 6):
    """Alternating (assign, regress) fit of every row of ``mag [L, n]``
    for one candidate base.  Returns (alpha, beta, mse), each ``[L]``."""
    log_b = torch.log(base)
    e_max = 2 ** (bits - 1) - 1
    alpha = torch.clamp_min(hi / torch.exp(e_max * log_b), 1e-30)
    beta = torch.zeros_like(alpha)
    for _ in range(iters):
        p = ExpQuantParams(alpha, beta, base.expand_as(alpha), bits)
        e = exponent_of(mag, p).to(F32)
        powers = torch.exp(e * log_b)
        alpha, beta = _ls_alpha_beta(powers, mag, live)
        alpha = torch.clamp_min(alpha, 1e-30)
    p = ExpQuantParams(alpha, beta, base.expand_as(alpha), bits)
    e = exponent_of(mag, p).to(F32)
    rec = alpha[:, None] * torch.exp(e * log_b) + beta[:, None]
    mse = (live * (rec - mag) ** 2).sum(-1) / (live.sum(-1) + 1e-12)
    return alpha, beta, mse


DEFAULT_BASES: tuple[float, ...] = tuple(
    float(b) for b in (2.0 ** (1.0 / k) for k in (1, 2, 3, 4, 6, 8, 12, 16))
)


def fit(x: torch.Tensor, bits: int, bases: Sequence[float] = DEFAULT_BASES,
        iters: int = 6, stacked: bool = False) -> ExpQuantParams:
    """Search (base, alpha, beta) minimising magnitude-domain MSE.

    ``stacked=True`` fits each slice ``x[l]`` of a layer-stacked tensor
    on its own (the reference's ``vmap`` over layers) and returns
    ``[L]`` parameters; otherwise the parameters are 0-d."""
    rows = x.reshape(x.shape[0], -1) if stacked else x.reshape(1, -1)
    mag = rows.abs().to(F32)
    live = (mag > 0).to(F32)
    lo, hi = _init_range(mag)
    bases_t = torch.tensor(bases, dtype=F32, device=x.device)
    best = None
    for k in range(len(bases)):
        a, b, mse = _fit_one_base(mag, live, lo, hi, bases_t[k], bits, iters)
        if best is None:
            best = [a, b, bases_t[k].expand_as(a).clone(), mse]
            continue
        # argmin keeps the first minimum, as jnp.argmin does
        better = mse < best[3]
        best = [torch.where(better, a, best[0]), torch.where(better, b, best[1]),
                torch.where(better, bases_t[k], best[2]),
                torch.where(better, mse, best[3])]
    alpha, beta, base = best[0], best[1], best[2]
    if not stacked:
        alpha, beta, base = alpha[0], beta[0], base[0]
    return ExpQuantParams(alpha, beta, base, bits)


def quantize(x: torch.Tensor, bits: int, **kw):
    """fit + encode.  Returns (codes, params)."""
    params = fit(x, bits, **kw)
    return encode(x, params), params


def sqnr_db(x: torch.Tensor, params: ExpQuantParams,
            stacked: bool = False) -> torch.Tensor:
    """Round-trip signal-to-quantization-noise ratio in dB (``[L]`` when
    ``stacked``)."""
    xf = x.to(F32)
    codes = encode(xf, params)
    table = decode_table(params, F32)
    if stacked:
        idx = codes.reshape(codes.shape[0], -1).long()
        err = torch.gather(table, 1, idx) - xf.reshape(xf.shape[0], -1)
        num = (xf.reshape(xf.shape[0], -1) ** 2).sum(-1)
        den = (err * err).sum(-1) + 1e-30
    else:
        err = table[codes.long()] - xf
        num = (xf * xf).sum()
        den = (err * err).sum() + 1e-30
    return 10.0 * torch.log10(num / den + 1e-30)


def search_bitwidth(x: torch.Tensor, min_sqnr_db: float = 22.0,
                    bit_range: Sequence[int] = (3, 4, 5, 6, 7)
                    ) -> tuple[int, ExpQuantParams]:
    """Per-tensor bit width (the paper's Table VI "avg bit"): the
    smallest width in ``bit_range`` whose round-trip SQNR reaches
    ``min_sqnr_db``, else the widest, with its fit."""
    chosen = None
    for b in bit_range:
        params = fit(x, b)
        if float(sqnr_db(x, params)) >= min_sqnr_db:
            return b, params
        chosen = params
    return bit_range[-1], chosen


# ------------------------------------------------------------ carriers --

def pack_qtensor(codes: torch.Tensor, params: ExpQuantParams,
                 dtype=F32) -> QWeight:
    return QWeight(codes, decode_table(params, dtype), pack_qmeta(params))


def is_qtensor(leaf) -> bool:
    """True for either carrier: a weight :class:`QWeight` or an
    activation :class:`QTensor`."""
    return isinstance(leaf, (QWeight, QTensor))


def qt_parts(leaf):
    """(codes, lut, qmeta) of either carrier."""
    return leaf.codes, leaf.lut, leaf.qmeta
