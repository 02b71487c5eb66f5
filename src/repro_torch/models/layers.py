"""Decoder building blocks (port of the JAX package's ``models/layers.py``:
norms, RoPE, the contiguous and the paged attends, the MLP, embeddings
and logits).

Every matmul routes through :mod:`repro_torch.core.lama_layers`, so any
weight may be a :class:`~repro_torch.core.exponential_quant.QWeight`.
With a layer's act-quant tables (``act_q``), activations are encoded at
the calibrated sites and the matmuls run on codes; KV pages are float
(float32, bfloat16, float8_e4m3fn: the kernels upcast after the load)
or uint8 codes (codes mode).  The contiguous attends (``mha``: dense or
chunked online-softmax, both plain PyTorch as the reference's are plain
jnp)
serve ``forward``/``prefill`` and the dense decode branch;
``mha_decode`` runs the contiguous flash-decode kernel.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lama_layers as ll
from repro_torch.core.exponential_quant import QTensor, encode_meta, is_qtensor
from repro_torch.kernels.decode_gqa import (decode_gqa, decode_gqa_paged,
                                            decode_gqa_paged_codes)
from repro_torch.kernels.flash_prefill import (flash_prefill_paged,
                                               flash_prefill_paged_codes)
from repro_torch.models.params import ParamSpec

Params = Any
F32 = torch.float32


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ------------------------------------------------------------- norms --

def norm_specs(cfg: ModelConfig, kind: str | None = None) -> dict:
    kind = kind or cfg.norm
    if kind == "rmsnorm":
        return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones")}
    if kind == "layernorm":
        return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones"),
                "bias": ParamSpec((cfg.d_model,), ("embed",), "zeros")}
    if kind == "nonparam_ln":   # OLMo: LayerNorm without scale or bias
        return {}
    raise ValueError(kind)


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig,
               kind: str | None = None, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm ``(x - mean) * rsqrt(var + eps)`` with the
    biased variance, times ``scale`` plus ``bias`` for ``layernorm`` and
    bare for ``nonparam_ln``; ``kind`` defaults to ``cfg.norm``.  In
    float32, back to x's dtype."""
    kind = kind or cfg.norm
    xf = x.to(F32)
    if kind == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].to(F32)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            out = out * p["scale"].to(F32) + p["bias"].to(F32)
    return out.to(x.dtype)


def head_norm_specs(cfg: ModelConfig) -> dict:
    return {"scale": ParamSpec((cfg.resolved_head_dim,), (None,), "ones")}


def apply_head_rms(p: Params, x: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Per-head-dim RMS norm (qk_norm)."""
    xf = x.to(F32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].to(F32)).to(x.dtype)


# ------------------------------------------------------------- remat --

def remat(cfg: ModelConfig, block, *args):
    """``block(*args)``; where ``cfg.remat == "block"`` and autograd is
    recording, under activation checkpointing (the block's activations
    recomputed in the backward pass): the reference's
    ``jax.checkpoint(blk)``."""
    if cfg.remat == "block" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(block, *args,
                                                 use_reentrant=False)
    return block(*args)


# -------------------------------------------------------------- rope --

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x [..., seq, heads, hd]; positions [..., seq]."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.arange(half, dtype=F32, device=x.device) / half
    # theta filled on the device: no host copy, so a capture takes it
    inv = torch.pow(torch.full((), theta, dtype=F32, device=x.device), -freq)
    ang = positions.to(F32)[..., None] * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------- act quantization --
#
# Per-(layer, site) calibrated tables ride the params as
# ``blocks.act_q[site] = {"lut": [L, 256], "qmeta": [L, 4]}`` (per KV
# head for attn_k/attn_v: ``[L, n_kv, 256]`` / ``[L, n_kv, 4]``); a
# layer's slice is its ``act_q``.  A site marks the float tensor feeding
# a quantized matmul (attn_in, attn_out, mlp_in; mlp_mid is produced by
# the gated kernel's quantize epilogue) or the attention boundary of the
# codes-mode KV cache (attn_q: the roped query; attn_k/attn_v: what a
# uint8 page stores).

ACT_SITES = ("attn_in", "attn_out", "mlp_in", "mlp_mid",
             "attn_q", "attn_k", "attn_v")

# The sites codes-mode attention needs beyond the matmul sites.
KV_CODE_SITES = ("attn_q", "attn_k", "attn_v", "attn_out")


def _q(x, act_q, site: str):
    """Encode ``x`` at an act-quant site (no-op without tables)."""
    return ll.maybe_encode_act(x, act_q, site)


def _mid_q(act_q):
    """The mlp_mid site entry when present and the policy honors it:
    the gated kernel's quantize epilogue."""
    if act_q is None or not ll.get_policy().act_quant:
        return None
    return act_q.get("mlp_mid")


def _kv_codes_q(act_q):
    """``act_q`` when it holds every attention boundary site and the
    policy honors it; raises otherwise (uint8 pages cannot be attended
    or written without their tables)."""
    if (act_q is None or not ll.get_policy().act_quant
            or not all(s in act_q for s in KV_CODE_SITES)):
        raise ValueError(
            "uint8 codes-mode KV pages need calibrated attn_q/attn_k/"
            "attn_v/attn_out act-quant sites with the act_quant policy on "
            "(kv_codes engines calibrate them; found none on this attend)")
    return act_q


def encode_kv_codes(k: torch.Tensor, v: torch.Tensor, act_q: dict):
    """Quantize-at-write: fresh K/V ``[B, S, n_kv, hd]`` to uint8 codes
    under this layer's per-head attn_k/attn_v params (``qmeta [n_kv,
    4]``, broadcast per head) -- what a codes-mode page stores."""
    aq = _kv_codes_q(act_q)
    return (encode_meta(k, aq["attn_k"]["qmeta"][:, None, :]),
            encode_meta(v, aq["attn_v"]["qmeta"][:, None, :]))


# --------------------------------------------------------- attention --

def attention_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head"), "scaled"),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head"), "scaled"),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head"), "scaled"),
        "wo": ParamSpec((h, hd, d), ("heads", "head", "embed"), "scaled",
                        fan_in_axis=0),
    }
    if cfg.qk_norm:
        s["q_norm"] = head_norm_specs(cfg)
        s["k_norm"] = head_norm_specs(cfg)
    return s


def roped_q(p: Params, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor, act_q: dict | None = None) -> torch.Tensor:
    """Project + (qk_norm) + rope the query. Returns [B, S, H, hd] float."""
    q = ll.dense_general(_q(x, act_q, "attn_in"), p["wq"], "bsd,dnh->bsnh",
                         dtype=x.dtype)
    if cfg.qk_norm:
        q = apply_head_rms(p["q_norm"], q)
    return rope(q, positions, cfg.rope_theta)


def self_kv(p: Params, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor, act_q: dict | None = None,
            use_rope: bool = True):
    """Project K, V for cache writes (K normed, and roped unless
    ``use_rope`` is False: the encoder-decoder's cross K/V); ``x`` is
    encoded once at attn_in for both."""
    xq = _q(x, act_q, "attn_in")
    k = ll.dense_general(xq, p["wk"], "bsd,dnh->bsnh", dtype=x.dtype)
    v = ll.dense_general(xq, p["wv"], "bsd,dnh->bsnh", dtype=x.dtype)
    if cfg.qk_norm:
        k = apply_head_rms(p["k_norm"], k)
    return (rope(k, positions, cfg.rope_theta) if use_rope else k), v


# Above this many score elements, ``mha`` with a mask descriptor takes
# the chunked online-softmax path, so scores never materialize (the
# reference's values).  The reference's FLASH_UNROLL (Python loops in
# place of ``lax.scan``, for the dry run's cost extraction: XLA's cost
# analysis counts a loop body once) has no counterpart: the chunk loops
# here are Python loops, and the dry run's op counter counts every op
# they run.
FLASH_THRESHOLD = 32 * 1024 * 1024
FLASH_Q_CHUNK = 1024
FLASH_K_CHUNK = 1024

# Context-parallel training: activations shard their *sequence* over the
# model axis (``constrain_act``) and the chunked attend keeps q whole,
# so the scores split along q's sharded sequence; the sharding rules
# drop tensor parallelism for 2-D FSDP (``sharding.rules.TRAIN_CP``).
# Read only where the tensors are DTensors on a mesh.
CONTEXT_PARALLEL = False


def set_context_parallel(enable: bool) -> None:
    global CONTEXT_PARALLEL
    CONTEXT_PARALLEL = enable


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``.  A DTensor whose sharded dimension the new
    shape splits unevenly (16 heads over 16 ranks into 8 KV heads x 2:
    DTensor has no layout for it) is first gathered on every dimension
    but the batch."""
    if type(x).__name__ != "DTensor":
        return x.reshape(*shape)
    try:
        return x.reshape(*shape)
    except RuntimeError:
        from torch.distributed.tensor import Replicate, Shard

        pl = [Replicate() if isinstance(p, Shard) and p.dim else p
              for p in x.placements]
        return x.redistribute(x.device_mesh, pl).reshape(*shape)


def _constrained(x) -> bool:
    from repro_torch.launch.mesh import get_abstract_mesh

    return type(x).__name__ == "DTensor" and get_abstract_mesh() is not None


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """Redistribute a DTensor under the ambient mesh
    (``launch.mesh.use_mesh``) to ``spec`` (one entry a dimension:
    ``"fsdp"`` for the (pod, data) axes present, a mesh axis name, or
    None); an axis the mesh lacks or a dimension its size does not
    divide is left replicated.  A plain tensor, or no ambient mesh,
    comes back as it is, so the one-device paths do not change (the
    reference's ``with_sharding_constraint``)."""
    if not _constrained(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import axis_sizes

    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    fsdp = tuple(a for a in ("pod", "data") if a in sizes)
    want = {}
    for dim, part in enumerate(spec):
        axes = fsdp if part == "fsdp" else (part,) if part else ()
        if (axes and all(a in sizes for a in axes) and x.shape[dim] %
                math.prod(sizes[a] for a in axes) == 0):
            want.update({a: Shard(dim) for a in axes})
    return x.redistribute(mesh, [want.get(a, Replicate())
                                 for a in mesh.mesh_dim_names])


def constrain_act(x: torch.Tensor) -> torch.Tensor:
    """Pin an activation's layout (:func:`constrain`): batch over the
    FSDP axes, feature dims replicated, and under CONTEXT_PARALLEL the
    sequence over "model".  A batch the FSDP axes do not divide leaves
    ``x`` alone, as in the reference."""
    if not _constrained(x) or x.ndim < 2:
        return x
    from repro_torch.launch.mesh import axis_sizes

    sizes = axis_sizes(x.device_mesh)
    fsdp = [sizes[a] for a in ("pod", "data") if a in sizes]
    if not fsdp or x.shape[0] % math.prod(fsdp):
        return x
    seq = "model" if CONTEXT_PARALLEL and x.ndim >= 3 else None
    return constrain(x, "fsdp", seq, *([None] * (x.ndim - 2)))


def _block_mask(kind: str, arg, qp: torch.Tensor,
                kp: torch.Tensor) -> torch.Tensor:
    """[Qc, Kc] bool from absolute positions for one (q, k) chunk."""
    if kind == "full":
        return torch.ones((qp.shape[0], kp.shape[0]), dtype=torch.bool,
                          device=qp.device)
    causal = kp[None, :] <= qp[:, None]
    if kind == "causal":
        return causal
    if kind == "local":
        return causal & (kp[None, :] > qp[:, None] - arg)
    if kind == "prefix":
        return causal | ((qp[:, None] < arg) & (kp[None, :] < arg))
    raise ValueError(kind)


def _materialize_mask(kind: str, arg, q_len: int, kv_len: int, q_offset,
                      device) -> torch.Tensor:
    return _block_mask(kind, arg, torch.arange(q_len, device=device) + q_offset,
                       torch.arange(kv_len, device=device))


def _attend_dense(q, k, v, mask, dt):
    """q [B, S, n_kv, G, hd]; k/v [B, T, n_kv, hd]; mask [S, T] or
    [B, S, T] bool.  float32 logits, a -1e30 bias on masked positions,
    softmax, probabilities in ``dt`` against v."""
    logits = torch.einsum("bsngh,btnh->bnsgt", q.to(F32),
                          k.to(F32)) / math.sqrt(q.shape[-1])
    bias = torch.where(mask, 0.0, -1e30).to(F32)
    bias = bias[None, None, :, None, :] if mask.ndim == 2 else bias[:, None, :, None, :]
    probs = torch.softmax(logits + bias, dim=-1).to(dt)
    rt = torch.promote_types(dt, v.dtype)
    return torch.einsum("bnsgt,btnh->bsngh", probs.to(rt), v.to(rt))


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with ``n`` zero positions after its sequence (dim 1); ``x``
    itself when ``n`` is 0."""
    if not n:
        return x
    return torch.nn.functional.pad(x, (0, 0) * (x.ndim - 2) + (0, n))


def _attend_flash(q, k, v, kind: str, arg, q_offset, dt,
                  q_chunk=FLASH_Q_CHUNK, k_chunk=FLASH_K_CHUNK):
    """Chunked online-softmax attention (the FlashAttention recurrence
    in plain PyTorch, as the reference's is in plain jnp): a loop over
    query chunks, an inner loop over KV chunks with running (max,
    denominator, accumulator).  Never materializes [S, T] scores.
    Operands stay bf16 when ``dt`` is bf16 (float32 otherwise); the
    products accumulate in float32.  Both ends are padded to whole
    chunks and padded keys masked, as in the reference."""
    b, s, n, g, hd = q.shape
    t = k.shape[1]
    if CONTEXT_PARALLEL:
        q_chunk = s     # the scores split along q's sharded sequence
    q_chunk, k_chunk = min(q_chunk, s), min(k_chunk, t)
    nq, nk = -(-s // q_chunk), -(-t // k_chunk)
    op_dt = dt if dt == torch.bfloat16 else F32
    qf = _pad_seq(q.to(op_dt), nq * q_chunk - s)
    kf = _pad_seq(k.to(op_dt), nk * k_chunk - t)
    vf = _pad_seq(v.to(op_dt), nk * k_chunk - t)
    dev = q.device
    neg = torch.tensor(-1e30, dtype=F32, device=dev)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(nq):
        qc = qf[:, qi * q_chunk:(qi + 1) * q_chunk].to(F32)
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, n, q_chunk, g), -1e30, dtype=F32, device=dev)
        l = torch.zeros((b, n, q_chunk, g), dtype=F32, device=dev)
        acc = torch.zeros((b, n, q_chunk, g, hd), dtype=F32, device=dev)
        for kj in range(nk):
            sl = slice(kj * k_chunk, (kj + 1) * k_chunk)
            kpos = torch.arange(sl.start, sl.stop, device=dev)
            logit = torch.einsum("bsngh,btnh->bnsgt", qc,
                                 kf[:, sl].to(F32)) * scale
            mask = _block_mask(kind, arg, qpos, kpos) & (kpos < t)[None, :]
            logit = torch.where(mask[None, None, :, None, :], logit, neg)
            m_new = torch.maximum(m, logit.amax(-1))
            p = torch.exp(logit - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bnsgt,btnh->bnsgh", p.to(op_dt).to(F32), vf[:, sl].to(F32))
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]       # [b,n,qc,g,hd]
        outs.append(out.permute(0, 2, 1, 3, 4))                # [b,qc,n,g,hd]
    return torch.cat(outs, 1)[:, :s].to(dt)


def mha(p: Params, x: torch.Tensor, cfg: ModelConfig, positions, mask,
        kv=None, use_rope: bool = True, q_offset=0,
        act_q: dict | None = None, return_ctx: bool = False):
    """Grouped-query attention over a contiguous sequence; ``kv``
    ([B, T, n_kv, hd] each, already normed and roped) overrides the
    self-derived keys/values (the dense decode branch attends the
    cache this way).  ``mask`` is a bool array ([S, T] or [B, S, T]) or
    a ``(kind, arg)`` descriptor (``full``, ``causal``, ``local``,
    ``prefix``); a descriptor above :data:`FLASH_THRESHOLD` score
    elements takes the chunked path.  ``act_q`` encodes x at attn_in
    (once, for q, k and v) and the context at attn_out; ``return_ctx``
    also returns the context before ``wo`` (the attn_out calibration
    sample)."""
    dt = x.dtype
    xq = _q(x, act_q, "attn_in")
    q = ll.dense_general(xq, p["wq"], "bsd,dnh->bsnh", dtype=dt)
    if kv is None:
        k = ll.dense_general(xq, p["wk"], "bsd,dnh->bsnh", dtype=dt)
        v = ll.dense_general(xq, p["wv"], "bsd,dnh->bsnh", dtype=dt)
    else:
        k, v = kv
    if cfg.qk_norm:
        q = apply_head_rms(p["q_norm"], q)
        if kv is None:
            k = apply_head_rms(p["k_norm"], k)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        if kv is None:
            k = rope(k, positions, cfg.rope_theta)
    b, s, h, hd = q.shape
    t = k.shape[1]
    qg = reshape(q, b, s, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                 hd)
    if isinstance(mask, tuple):
        kind, arg = mask[0], (mask[1] if len(mask) > 1 else None)
        if b * h * s * t > FLASH_THRESHOLD:
            out = _attend_flash(qg, k, v, kind, arg, q_offset, dt)
        else:
            out = _attend_dense(qg, k, v, _materialize_mask(
                kind, arg, s, t, q_offset, x.device), dt)
    else:
        out = _attend_dense(qg, k, v, mask, dt)
    out = reshape(out, b, s, h, hd)
    proj = ll.dense_general(_q(out, act_q, "attn_out"), p["wo"],
                            "bsnh,nhd->bsd", dtype=dt)
    return (proj, out) if return_ctx else proj


def mha_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, positions,
               k_cache, v_cache, lengths, use_rope: bool = True,
               act_q: dict | None = None) -> torch.Tensor:
    """Decode-step GQA over contiguous caches ([B, T, n_kv, hd]) through
    the flash-decode kernel, masked by ``lengths`` [B]; numerically
    :func:`mha` with a causal-by-length mask."""
    dt = x.dtype
    q = ll.dense_general(_q(x, act_q, "attn_in"), p["wq"], "bsd,dnh->bsnh",
                         dtype=dt)
    if cfg.qk_norm:
        q = apply_head_rms(p["q_norm"], q)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
    b, s, h, hd = q.shape
    qg = q[:, 0].reshape(b, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, hd)
    out = decode_gqa(qg, k_cache, v_cache, lengths)
    out = out.reshape(b, 1, h, hd).to(dt)
    return ll.dense_general(_q(out, act_q, "attn_out"), p["wo"],
                            "bsnh,nhd->bsd", dtype=dt)


def _attend_out(p: Params, out: torch.Tensor, k_pages, act_q, dt):
    """The output projection of an attend: a codes-mode context (uint8,
    under attn_out) goes to ``wo`` as a ``QTensor``; a float one is
    encoded at attn_out when that site is calibrated."""
    b, s = out.shape[:2]
    out = out.reshape(b, s, -1, out.shape[-1])
    if k_pages.dtype == torch.uint8:
        aq = act_q["attn_out"]
        ctx = QTensor(out, aq["lut"], aq["qmeta"])
    else:
        ctx = _q(out.to(dt), act_q, "attn_out")
    return ll.dense_general(ctx, p["wo"], "bsnh,nhd->bsd", dtype=dt)


def mha_prefill_paged(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      positions, k_pages, v_pages, block_tables, q_start,
                      kv_lens, act_q: dict | None = None) -> torch.Tensor:
    """Chunked-prefill GQA straight from the paged cache: the chunk's
    roped queries attend every written position ``<=`` their own
    through the flash-prefill kernel.  The caller scatters the chunk's
    own K/V into the pages first.  With uint8 codes pages the chunk runs
    code-in/code-out: queries encoded at attn_q, the codes kernel, and
    the uint8 context fed to ``wo`` as a ``QTensor``."""
    dt = x.dtype
    q = roped_q(p, x, cfg, positions, act_q=act_q)
    b, s, h, hd = q.shape
    groups = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, s, cfg.num_kv_heads, groups, hd)
    if k_pages.dtype == torch.uint8:
        aq = _kv_codes_q(act_q)
        out = flash_prefill_paged_codes(
            encode_meta(qg, aq["attn_q"]["qmeta"]), k_pages, v_pages,
            aq["attn_q"]["lut"], aq["attn_k"]["lut"], aq["attn_v"]["lut"],
            aq["attn_out"]["qmeta"], block_tables, q_start, kv_lens)
    else:
        out = flash_prefill_paged(qg, k_pages, v_pages, block_tables,
                                  q_start, kv_lens)
    return _attend_out(p, out, k_pages, act_q, dt)


def mha_decode_paged(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     positions, k_pages, v_pages, block_tables,
                     lengths, act_q: dict | None = None) -> torch.Tensor:
    """Decode-step GQA over the paged cache through the flash-decode
    kernel (zero-length rows attend nothing and return zeros); codes
    pages as in :func:`mha_prefill_paged`."""
    dt = x.dtype
    q = roped_q(p, x, cfg, positions, act_q=act_q)
    b, s, h, hd = q.shape
    groups = cfg.num_heads // cfg.num_kv_heads
    qg = q[:, 0].reshape(b, cfg.num_kv_heads, groups, hd)
    if k_pages.dtype == torch.uint8:
        aq = _kv_codes_q(act_q)
        out = decode_gqa_paged_codes(
            encode_meta(qg, aq["attn_q"]["qmeta"]), k_pages, v_pages,
            aq["attn_q"]["lut"], aq["attn_k"]["lut"], aq["attn_v"]["lut"],
            aq["attn_out"]["qmeta"], block_tables, lengths)
    else:
        out = decode_gqa_paged(qg, k_pages, v_pages, block_tables, lengths)
    return _attend_out(p, out[:, None], k_pages, act_q, dt)


# --------------------------------------------------------------- mlp --

def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s = {"w_down": ParamSpec((f, d), ("mlp", "embed"), "scaled",
                             fan_in_axis=0)}
    if cfg.gated_mlp:
        s["w_gate"] = ParamSpec((d, f), ("embed", "mlp"), "scaled")
    s["w_up"] = ParamSpec((d, f), ("embed", "mlp"), "scaled")
    return s


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
              act_q: dict | None = None, return_mid: bool = False):
    """Gated MLP: one gated kernel for ``act(x@w_gate) * (x@w_up)``,
    then the down projection.  With ``act_q`` the chain is
    code-in/code-out: x encoded once at mlp_in, the front half's
    quantize epilogue emits the mlp_mid codes, and the down projection
    reads them.  ``return_mid`` also returns the intermediate (the
    mlp_mid calibration sample, a float there)."""
    dt = x.dtype
    xq = _q(x, act_q, "mlp_in")
    if cfg.gated_mlp:
        h = ll.gated_mlp(xq, p["w_gate"], p["w_up"], cfg.activation,
                         dtype=dt, out_quant=_mid_q(act_q))
    else:
        h = ll.dense(xq, p["w_up"], epilogue=cfg.activation, dtype=dt,
                     out_quant=_mid_q(act_q))
    out = ll.dense(h, p["w_down"], dtype=dt)
    return (out, h) if return_mid else out


# -------------------------------------------------------- embeddings --

def embed_specs(cfg: ModelConfig) -> dict:
    return {"tokens": ParamSpec((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"), "embed", scale=0.05)}


def embed_tokens(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return ll.embed_lookup(p["tokens"], tokens, cdtype(cfg))


def unembed_specs(cfg: ModelConfig) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"out": ParamSpec((cfg.d_model, cfg.vocab_size),
                             ("embed", "vocab"), "scaled")}


def logits_fn(params: Params, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Tied unembedding: a quantized table runs the fused kernel's
    transposed-codes layout (``'bsd,vd->bsv'``).  Untied: ``unembed.out``
    [D, V] in the plain layout, the logits rounded to x's dtype before
    float32 as the reference rounds them."""
    if cfg.tie_embeddings:
        w = params["embed"]["tokens"]
        if is_qtensor(w):
            out = ll.dense_general(x, w, "bsd,vd->bsv", dtype=F32)
        else:
            table = ll.materialize(w, cdtype(cfg))
            out = torch.einsum("bsd,vd->bsv", x.to(F32), table.to(F32))
    else:
        out = ll.dense(x, params["unembed"]["out"], dtype=x.dtype).to(F32)
    if cfg.logit_softcap:
        out = cfg.logit_softcap * torch.tanh(out / cfg.logit_softcap)
    return out.to(F32)
