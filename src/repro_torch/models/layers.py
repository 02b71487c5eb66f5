"""Decoder building blocks (port of the JAX package's ``models/layers.py``:
norms, RoPE, the paged attends, the MLP, embeddings and logits).

Every matmul routes through :mod:`repro_torch.core.lama_layers`, so any
weight may be a :class:`~repro_torch.core.exponential_quant.QWeight`.
Only float KV pages are served so far (f8 and code pages are later
ROADMAP items).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lama_layers as ll
from repro_torch.core.exponential_quant import is_qtensor
from repro_torch.kernels.decode_gqa import decode_gqa_paged
from repro_torch.kernels.flash_prefill import flash_prefill_paged
from repro_torch.models.params import ParamSpec

Params = Any
F32 = torch.float32


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ------------------------------------------------------------- norms --

def norm_specs(cfg: ModelConfig, kind: str | None = None) -> dict:
    kind = kind or cfg.norm
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r}: only rmsnorm is ported")
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones")}


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, back to x's dtype."""
    xf = x.to(F32)
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].to(F32)
    return out.to(x.dtype)


def head_norm_specs(cfg: ModelConfig) -> dict:
    return {"scale": ParamSpec((cfg.resolved_head_dim,), (None,), "ones")}


def apply_head_rms(p: Params, x: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Per-head-dim RMS norm (qk_norm)."""
    xf = x.to(F32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].to(F32)).to(x.dtype)


# -------------------------------------------------------------- rope --

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x [..., seq, heads, hd]; positions [..., seq]."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.arange(half, dtype=F32, device=x.device) / half
    inv = torch.pow(torch.tensor(theta, dtype=F32, device=x.device), -freq)
    ang = positions.to(F32)[..., None] * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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
            positions: torch.Tensor) -> torch.Tensor:
    """Project + (qk_norm) + rope the query. Returns [B, S, H, hd]."""
    q = ll.dense_general(x, p["wq"], "bsd,dnh->bsnh", dtype=x.dtype)
    if cfg.qk_norm:
        q = apply_head_rms(p["q_norm"], q)
    return rope(q, positions, cfg.rope_theta)


def self_kv(p: Params, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor):
    """Project K, V for cache writes (K normed and roped)."""
    k = ll.dense_general(x, p["wk"], "bsd,dnh->bsnh", dtype=x.dtype)
    v = ll.dense_general(x, p["wv"], "bsd,dnh->bsnh", dtype=x.dtype)
    if cfg.qk_norm:
        k = apply_head_rms(p["k_norm"], k)
    return rope(k, positions, cfg.rope_theta), v


def mha_prefill_paged(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      positions, k_pages, v_pages, block_tables, q_start,
                      kv_lens) -> torch.Tensor:
    """Chunked-prefill GQA straight from the paged cache: the chunk's
    roped queries attend every written position ``<=`` their own
    through the flash-prefill kernel.  The caller scatters the chunk's
    own K/V into the pages first."""
    dt = x.dtype
    q = roped_q(p, x, cfg, positions)
    b, s, h, hd = q.shape
    groups = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, s, cfg.num_kv_heads, groups, hd)
    out = flash_prefill_paged(qg, k_pages, v_pages, block_tables, q_start,
                              kv_lens)
    out = out.reshape(b, s, h, hd).to(dt)
    return ll.dense_general(out, p["wo"], "bsnh,nhd->bsd", dtype=dt)


def mha_decode_paged(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     positions, k_pages, v_pages, block_tables,
                     lengths) -> torch.Tensor:
    """Decode-step GQA over the paged cache through the flash-decode
    kernel (zero-length rows attend nothing and return zeros)."""
    dt = x.dtype
    q = roped_q(p, x, cfg, positions)
    b, s, h, hd = q.shape
    groups = cfg.num_heads // cfg.num_kv_heads
    qg = q[:, 0].reshape(b, cfg.num_kv_heads, groups, hd)
    out = decode_gqa_paged(qg, k_pages, v_pages, block_tables, lengths)
    out = out.reshape(b, 1, h, hd).to(dt)
    return ll.dense_general(out, p["wo"], "bsnh,nhd->bsd", dtype=dt)


# --------------------------------------------------------------- mlp --

def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s = {"w_down": ParamSpec((f, d), ("mlp", "embed"), "scaled",
                             fan_in_axis=0)}
    if cfg.gated_mlp:
        s["w_gate"] = ParamSpec((d, f), ("embed", "mlp"), "scaled")
    s["w_up"] = ParamSpec((d, f), ("embed", "mlp"), "scaled")
    return s


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated MLP: one gated kernel for ``act(x@w_gate) * (x@w_up)``,
    then the down projection."""
    dt = x.dtype
    if cfg.gated_mlp:
        h = ll.gated_mlp(x, p["w_gate"], p["w_up"], cfg.activation, dtype=dt)
    else:
        h = ll.dense(x, p["w_up"], epilogue=cfg.activation, dtype=dt)
    return ll.dense(h, p["w_down"], dtype=dt)


# -------------------------------------------------------- embeddings --

def embed_specs(cfg: ModelConfig) -> dict:
    return {"tokens": ParamSpec((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"), "embed", scale=0.05)}


def embed_tokens(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return ll.embed_lookup(p["tokens"], tokens, cdtype(cfg))


def logits_fn(params: Params, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Tied unembedding: a quantized table runs the fused kernel's
    transposed-codes layout (``'bsd,vd->bsv'``)."""
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied unembedding is not ported yet")
    w = params["embed"]["tokens"]
    if is_qtensor(w):
        out = ll.dense_general(x, w, "bsd,vd->bsv", dtype=F32)
    else:
        table = ll.materialize(w, cdtype(cfg))
        out = torch.einsum("bsd,vd->bsv", x.to(F32), table.to(F32))
    if cfg.logit_softcap:
        out = cfg.logit_softcap * torch.tanh(out / cfg.logit_softcap)
    return out.to(F32)
