"""Quantized dense layers (port of the JAX package's ``core/lama_layers.py``).

Every matmul of the model funnels through :func:`dense` /
:func:`dense_general` / :func:`gated_mlp`.  A weight is either a float
tensor or a :class:`~repro_torch.core.exponential_quant.QWeight` (uint8
codes + a 256-entry table).  A :class:`FusedPolicy` (context-scoped,
:func:`policy`) picks the execution per call:

* ``mode="auto"`` (the default) or ``"fused"``: quantized weights take
  the fused kernel.  Any einsum spec the zoo uses is canonicalized to
  ``[M, K] @ [K, N]`` (codes reshaped as bytes, never decoded outside the
  kernel), and the tied unembedding ``'bsd,vd->bsv'`` runs the kernel's
  transposed-codes layout.  ``fuse_epilogues=False`` launches the plain
  and dual kernels without their bias, activation and quantize
  epilogues, which then run in torch, and splits the gated MLP into two
  dense calls.  ``autotune`` goes to the LUT GEMM wrappers: ``True``
  tunes their plans on the card, ``None`` and ``False`` launch the shape
  plans.
* ``mode="materialize"``: the reference's baseline outside any kernel:
  the weight is decoded to the compute dtype (:func:`materialize`), then
  ``torch.matmul``/``torch.einsum`` in float32, the epilogue in torch.

Float weights go to ``torch.matmul``/``torch.einsum`` in float32, as the
reference leaves them to XLA.

An activation may arrive as a :class:`~repro_torch.core.exponential_quant.QTensor`
(encoded by :func:`encode_act` at a calibrated site, or emitted by a
kernel's quantize epilogue).  Against quantized weights it takes the
dual-LUT kernels, and ``out_quant`` returns the result as codes too, so
consecutive quantized matmuls are code-in/code-out.

The policy's other fields: ``decode_mode`` (``gather``, the default, or
``alu``), ``act_quant`` (the A/B switch for calibrated activation
tables) and ``flash_decode`` (the contiguous decode step through the
flash-decode kernel, or the dense masked attend).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core import exponential_quant as eq
from repro_torch.kernels.lut_dequant_matmul import ops as _ops
from repro_torch.kernels.lut_dequant_matmul.ref import apply_activation

F32 = torch.float32


MODES = ("auto", "fused", "materialize")


@dataclasses.dataclass(frozen=True)
class FusedPolicy:
    """Per-context policy for quantized matmul execution.

    mode:
      * ``"auto"`` -- fused kernel wherever the spec canonicalizes (the
        default).
      * ``"fused"`` -- synonym of auto, for call sites that state intent.
      * ``"materialize"`` -- decode the weight, then a float32 matmul,
        everywhere (the A/B baseline).
    """

    mode: str = "auto"              # auto | fused | materialize
    decode_mode: str = "gather"     # gather | alu
    fuse_epilogues: bool = True     # act/bias/gate/quantize epilogues
                                    # in-kernel
    flash_decode: bool = True       # contiguous decode_step: flash-decode
                                    # kernel (False: dense masked attend)
    autotune: bool | None = None    # LUT GEMM plan autotuner (True: on;
                                    # None, False: the shape plans)
    act_quant: bool = True          # honor act-quant tables when present
                                    # (False A/B-disables encoding without
                                    # re-calibrating)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got "
                             f"{self.mode!r}")


_POLICY = FusedPolicy()


def get_policy() -> FusedPolicy:
    return _POLICY


def set_policy(p: FusedPolicy) -> None:
    global _POLICY
    _POLICY = p


@contextlib.contextmanager
def policy(**overrides):
    """Scoped override: ``with ll.policy(mode="materialize"): ...``"""
    global _POLICY
    prev = _POLICY
    _POLICY = dataclasses.replace(prev, **overrides)
    try:
        yield _POLICY
    finally:
        _POLICY = prev


def use_pallas_kernel(enable: bool = True) -> None:
    """The reference's pre-policy switch, under its name: the fused CUDA
    kernels (``mode="fused"``) or decode-then-matmul
    (``mode="materialize"``)."""
    set_policy(dataclasses.replace(
        _POLICY, mode="fused" if enable else "materialize"))


def _fused_enabled() -> bool:
    return _POLICY.mode in ("auto", "fused")


def materialize(w, dtype=torch.bfloat16) -> torch.Tensor:
    """Decode a quantized carrier (weight or activation) to a dense
    tensor of ``dtype``: the only place codes become floats outside a
    kernel."""
    if eq.is_qtensor(w):
        return w.lut.to(dtype)[w.codes.long()]
    return w.to(dtype)


def encode_act(x: torch.Tensor, aq: dict) -> eq.QTensor:
    """Encode an activation under one calibrated site entry ``{"lut":
    [256], "qmeta": [4]}`` (a layer's slice of ``blocks.act_q``)."""
    return eq.QTensor(eq.encode_meta(x, aq["qmeta"]), aq["lut"], aq["qmeta"])


def maybe_encode_act(x, act_q, site: str):
    """Encode ``x`` when ``act_q`` holds ``site`` and the policy honors
    act-quant tables; pass the float through otherwise."""
    if (act_q is None or not _POLICY.act_quant
            or not isinstance(act_q, dict) or site not in act_q):
        return x
    return encode_act(x, act_q[site])


# ----------------------------------------------------------------------
# Einsum canonicalization: spec -> 2-D (optionally batched) matmul plan
# ----------------------------------------------------------------------

class _EinsumPlan(NamedTuple):
    batch: tuple[str, ...]     # labels shared by x, w and out
    xfree: tuple[str, ...]     # labels of M (x and out only)
    contract: tuple[str, ...]  # labels of K (x and w, not out)
    wfree: tuple[str, ...]     # labels of N (w and out only)
    x_perm: tuple[int, ...]    # x transpose -> (batch, xfree, contract)
    w_perm: tuple[int, ...]    # w transpose -> (batch, contract, wfree)
    out_perm: tuple[int, ...]  # (batch, xfree, wfree) -> out label order


@functools.lru_cache(maxsize=None)
def _einsum_plan(spec: str) -> _EinsumPlan | None:
    """Parse a two-operand einsum spec into a matmul plan, or None when
    the spec is not expressible as (batched) ``x @ w``."""
    try:
        operands, out = spec.replace(" ", "").split("->")
        xs, ws = operands.split(",")
    except ValueError:
        return None
    if "." in spec:
        return None
    if len(set(xs)) != len(xs) or len(set(ws)) != len(ws) \
            or len(set(out)) != len(out):
        return None
    batch = tuple(l for l in xs if l in ws and l in out)
    contract = tuple(l for l in xs if l in ws and l not in out)
    xfree = tuple(l for l in xs if l not in ws)
    wfree = tuple(l for l in ws if l not in xs)
    if set(xfree) - set(out) or set(wfree) - set(out):
        return None
    if set(out) != set(batch) | set(xfree) | set(wfree):
        return None
    canonical = batch + xfree + wfree
    return _EinsumPlan(
        batch=batch, xfree=xfree, contract=contract, wfree=wfree,
        x_perm=tuple(xs.index(l) for l in batch + xfree + contract),
        w_perm=tuple(ws.index(l) for l in batch + contract + wfree),
        out_perm=tuple(canonical.index(l) for l in out),
    )


def _maybe_permute(a: torch.Tensor, perm: tuple[int, ...]) -> torch.Tensor:
    if perm == tuple(range(a.ndim)):
        return a
    return a.permute(perm)


def _fused_einsum(x, w: eq.QWeight, plan: _EinsumPlan, spec: str,
                  cdtype) -> torch.Tensor:
    """Run a canonicalized einsum against codes through the fused
    kernel.  A pure 2-D ``[N, K]`` weight (the tied unembedding) uses the
    kernel's transposed-codes layout; batched specs loop the kernel over
    the batch (the reference vmaps it).  An activation ``QTensor`` ``x``
    takes its transposes and reshapes as bytes and runs the dual kernel,
    except against the transposed layout, which has no dual variant:
    there (only there) the carrier is decoded to float32 first, as in
    the reference."""
    codes = w.codes
    kernel_transpose = (not plan.batch and codes.ndim == 2
                        and plan.w_perm == (1, 0))
    if isinstance(x, eq.QTensor) and kernel_transpose:
        x = materialize(x, F32)
    x_is_q = isinstance(x, eq.QTensor)
    xarr = x.codes if x_is_q else x
    xs, ws = spec.replace(" ", "").split("->")[0].split(",")
    xdims = dict(zip(xs, xarr.shape))
    wdims = dict(zip(ws, codes.shape))
    for l in plan.contract + plan.batch:
        if xdims[l] != wdims[l]:
            raise ValueError(f"dim mismatch for '{l}' in {spec}: "
                             f"{tuple(x.shape)} vs {tuple(codes.shape)}")
    b_shape = tuple(xdims[l] for l in plan.batch)
    m_shape = tuple(xdims[l] for l in plan.xfree)
    k_shape = tuple(wdims[l] for l in plan.contract)
    n_shape = tuple(wdims[l] for l in plan.wfree)
    b, m, k, n = (math.prod(b_shape), math.prod(m_shape),
                  math.prod(k_shape), math.prod(n_shape))
    xt = _maybe_permute(xarr, plan.x_perm)
    ct = codes if kernel_transpose else _maybe_permute(codes, plan.w_perm)
    pol = _POLICY
    if x_is_q:
        call = functools.partial(_ops.lut_dequant_matmul_dual, lut_x=x.lut,
                                 lut_w=w.lut, qmeta_x=x.qmeta, qmeta_w=w.qmeta,
                                 decode_mode=pol.decode_mode,
                                 autotune=pol.autotune)
    else:
        call = functools.partial(_ops.lut_dequant_matmul, lut=w.lut,
                                 qmeta=w.qmeta, decode_mode=pol.decode_mode,
                                 out_dtype=F32, autotune=pol.autotune)
    if plan.batch:
        x3 = xt.reshape(b, m, k)
        c3 = ct.reshape(b, k, n)
        out = torch.stack([call(x3[i].contiguous(), c3[i].contiguous())
                           for i in range(b)])
    elif kernel_transpose:
        out = call(xt.reshape(m, k).contiguous(), ct, transpose_codes=True)
    else:
        out = call(xt.reshape(m, k).contiguous(), ct.reshape(k, n).contiguous())
    out = out.reshape(b_shape + m_shape + n_shape)
    return _maybe_permute(out, plan.out_perm).to(cdtype)


def _finish_out(out: torch.Tensor, out_quant: dict | None):
    """Encode under the requested output site (a ``QTensor`` comes back)
    or pass the float through: the tail of every path whose epilogue did
    not encode in-kernel."""
    if out_quant is not None:
        return encode_act(out, out_quant)
    return out


def _epilogue(out: torch.Tensor, epilogue: str | None, bias) -> torch.Tensor:
    """Bias and activation in torch (the reference's ``_epilogue_jnp``)."""
    if bias is not None:
        out = out + bias.to(out.dtype)
    return apply_activation(out, epilogue)


def _as_float(x, cdtype) -> torch.Tensor:
    return materialize(x, cdtype) if isinstance(x, eq.QTensor) else x.to(cdtype)


def dense(x, w, *, dtype=None, epilogue: str | None = None, bias=None,
          out_quant: dict | None = None):
    """``act(x @ w + bias)``, contracting x's last axis with w's first.

    ``x`` may be an activation ``QTensor``: against 2-D codes both
    operands then cross as codes through the dual kernel, and
    ``out_quant`` (a site entry ``{"lut", "qmeta"}``) re-encodes the
    result in the kernel and returns a ``QTensor``.  With
    ``fuse_epilogues=False`` the kernel runs bare and bias, activation
    and encode follow in torch; in materialize mode the weight is
    decoded and multiplied in float32."""
    x_is_q = isinstance(x, eq.QTensor)
    cdtype = dtype or (F32 if x_is_q else x.dtype)
    if eq.is_qtensor(w) and _fused_enabled() and w.codes.ndim == 2:
        pol = _POLICY
        fuse_ep = pol.fuse_epilogues
        lead = x.shape[:-1]
        n = w.codes.shape[-1]
        if x_is_q:
            out = _ops.lut_dequant_matmul_dual(
                x.codes.reshape(-1, x.shape[-1]).contiguous(), w.codes,
                x.lut, w.lut, x.qmeta, w.qmeta,
                decode_mode=pol.decode_mode,
                epilogue=epilogue if fuse_ep else None,
                bias=bias if fuse_ep else None,
                out_qmeta=(out_quant["qmeta"]
                           if out_quant is not None and fuse_ep else None),
                autotune=pol.autotune)
            if out_quant is not None and fuse_ep:
                return eq.QTensor(out.reshape(lead + (n,)), out_quant["lut"],
                                  out_quant["qmeta"])
        else:
            out = _ops.lut_dequant_matmul(
                x.reshape(-1, x.shape[-1]).contiguous(), w.codes, w.lut,
                w.qmeta, decode_mode=pol.decode_mode,
                epilogue=epilogue if fuse_ep else None,
                bias=bias if fuse_ep else None, out_dtype=F32,
                autotune=pol.autotune)
        out = out.reshape(lead + (n,))
        if not fuse_ep:
            out = _epilogue(out, epilogue, bias)
        return _finish_out(out.to(cdtype), out_quant)
    wf = materialize(w, cdtype)
    out = torch.matmul(_as_float(x, cdtype).to(F32), wf.to(F32))
    return _finish_out(_epilogue(out, epilogue, bias).to(cdtype), out_quant)


def dense_general(x, w, contract_spec: str, *, dtype=None) -> torch.Tensor:
    """Einsum with a possibly quantized weight, e.g. ``'bsd,dnh->bsnh'``;
    ``x`` may be an activation ``QTensor``."""
    cdtype = dtype or (F32 if isinstance(x, eq.QTensor) else x.dtype)
    if eq.is_qtensor(w) and _fused_enabled():
        plan = _einsum_plan(contract_spec)
        wspec = contract_spec.replace(" ", "").split("->")[0].split(",")[1]
        if plan is not None and w.codes.ndim == len(wspec):
            return _fused_einsum(x, w, plan, contract_spec, cdtype)
    wf = materialize(w, cdtype)
    return torch.einsum(contract_spec, _as_float(x, cdtype).to(F32),
                        wf.to(F32)).to(cdtype)


def gated_mlp(x, w_gate, w_up, activation: str, *, dtype=None,
              out_quant: dict | None = None):
    """``act(x @ w_gate) * (x @ w_up)``: one gated kernel when both
    weights are quantized 2-D codes of one shape (fused mode, epilogues
    fused), else two dense calls.  An activation ``QTensor`` ``x`` takes
    the dual-gated kernel, and ``out_quant`` re-encodes the gated result
    in the kernel (a ``QTensor`` comes back) so the down projection
    reads codes."""
    x_is_q = isinstance(x, eq.QTensor)
    cdtype = dtype or (F32 if x_is_q else x.dtype)
    pol = _POLICY
    if (eq.is_qtensor(w_gate) and eq.is_qtensor(w_up)
            and _fused_enabled() and pol.fuse_epilogues
            and w_gate.codes.ndim == 2
            and w_gate.codes.shape == w_up.codes.shape):
        lead = x.shape[:-1]
        n = w_gate.codes.shape[-1]
        if x_is_q:
            out = _ops.lut_dequant_matmul_dual_gated(
                x.codes.reshape(-1, x.shape[-1]).contiguous(), w_gate.codes,
                w_up.codes, x.lut, w_gate.lut, w_up.lut, x.qmeta,
                w_gate.qmeta, w_up.qmeta, activation=activation,
                out_qmeta=None if out_quant is None else out_quant["qmeta"],
                decode_mode=pol.decode_mode, autotune=pol.autotune)
            if out_quant is not None:
                return eq.QTensor(out.reshape(lead + (n,)), out_quant["lut"],
                                  out_quant["qmeta"])
        else:
            out = _ops.lut_dequant_matmul_gated(
                x.reshape(-1, x.shape[-1]).contiguous(), w_gate.codes,
                w_up.codes, w_gate.lut, w_up.lut, w_gate.qmeta, w_up.qmeta,
                activation=activation, decode_mode=pol.decode_mode,
                out_dtype=F32, autotune=pol.autotune)
        return _finish_out(out.reshape(lead + (n,)).to(cdtype), out_quant)
    g = dense(x, w_gate, dtype=cdtype, epilogue=activation)
    out = (g * dense(x, w_up, dtype=cdtype)).to(cdtype)
    return _finish_out(out, out_quant)


def embed_lookup(w, idx: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding row gather that never decodes the full table: gather
    code rows, then map only those through the 256-entry table."""
    if eq.is_qtensor(w):
        rows = w.codes[idx.long()].long()
        return w.lut.to(dtype)[rows]
    return w.to(dtype)[idx.long()]


# ----------------------------------------------------------------------
# Tree-level quantization
# ----------------------------------------------------------------------

_QUANT_NAMES = {"out", "tokens", "enc_in"}
_QUANT_SKIP = {"router", "lora_a", "lora_b", "decay_a", "decay_b", "wkv"}


def default_predicate(path: tuple, leaf) -> bool:
    """Quantize matmul weights only: leaves named ``w*`` or in the known
    projection set, at least 2-D and floating."""
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if not leaf.is_floating_point():
        return False
    name = str(path[-1]).lower()
    if name in _QUANT_SKIP:
        return False
    if name in _QUANT_NAMES:
        return True
    return name.startswith("w") and "conv" not in name


def _quantize_stacked(leaf: torch.Tensor, bits: int, lut_dtype):
    """One DNA-TEQ fit per layer of a stacked ``[L, ...]`` weight."""
    x = leaf.to(F32)
    qp = eq.fit(x, bits, stacked=True)
    codes = eq.encode(x, qp)
    sqnr = eq.sqnr_db(x, qp, stacked=True)
    return (eq.QWeight(codes, eq.decode_table(qp, lut_dtype),
                       eq.pack_qmeta(qp)), float(sqnr.mean()))


def quantize_tree(params: dict, bits: int = 7,
                  predicate: Callable = default_predicate,
                  lut_dtype=F32, axes: dict | None = None):
    """Replace eligible leaves of a nested dict of tensors with
    :class:`QWeight` (fit per tensor; per *layer* where ``axes`` marks a
    leading ``"layers"`` dim).  Returns (new_tree, report{path: (bits,
    sqnr_db)}).  Runs on the leaves' device."""
    report = {}

    def visit(node, ax, path):
        if isinstance(node, dict):
            return {k: visit(v, (ax or {}).get(k), path + (k,))
                    for k, v in node.items()}
        if eq.is_qtensor(node) or not predicate(path, node):
            return node
        if ax and ax[0] == "layers":
            packed, sqnr = _quantize_stacked(node, bits, lut_dtype)
            report[path] = (bits, sqnr)
            return packed
        x = node.to(F32)
        codes, qp = eq.quantize(x, bits)
        report[path] = (bits, float(eq.sqnr_db(x, qp)))
        return eq.pack_qtensor(codes, qp, lut_dtype)

    return visit(params, axes, ()), report


def quantize_tree_mixed(params: dict, min_sqnr_db: float = 22.0,
                        predicate: Callable = default_predicate,
                        lut_dtype=F32, axes: dict | None = None):
    """:func:`quantize_tree` with a bit width searched per tensor
    (:func:`~repro_torch.core.exponential_quant.search_bitwidth`, the
    paper's Table VI).  A layer-stacked weight is searched on layer 0
    and every layer is then fit at that width.  Returns (new_tree,
    report{path: (bits, sqnr_db)})."""
    report = {}

    def visit(node, ax, path):
        if isinstance(node, dict):
            return {k: visit(v, (ax or {}).get(k), path + (k,))
                    for k, v in node.items()}
        if eq.is_qtensor(node) or not predicate(path, node):
            return node
        x = node.to(F32)
        if ax and ax[0] == "layers":
            bits, _ = eq.search_bitwidth(x[0], min_sqnr_db)
            packed, sqnr = _quantize_stacked(node, bits, lut_dtype)
            report[path] = (bits, sqnr)
            return packed
        bits, qp = eq.search_bitwidth(x, min_sqnr_db)
        report[path] = (bits, float(eq.sqnr_db(x, qp)))
        return eq.pack_qtensor(eq.encode(x, qp), qp, lut_dtype)

    return visit(params, axes, ()), report


def quantized_fraction(params) -> float:
    """Fraction of the parameters' elements held as uint8 codes (a tree
    of dicts, a :class:`~repro_torch.models.transformer.DecoderLM`'s
    ``tree()`` included)."""
    q = tot = 0

    def walk(node):
        nonlocal q, tot
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif eq.is_qtensor(node):
            q += node.codes.numel()
            tot += node.codes.numel()
        elif isinstance(node, torch.Tensor):
            tot += node.numel()

    walk(params)
    return q / max(tot, 1)


def avg_bits(report: dict) -> float:
    """Mean searched bit width of a quantization report (Table VI's
    "Avg bit")."""
    if not report:
        return 0.0
    return sum(b for b, _ in report.values()) / len(report)
