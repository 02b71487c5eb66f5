"""Encoder-decoder backbone of seamless-m4t-medium (port of the JAX
package's ``models/encdec.py``; arXiv:2308.11596).

The audio frontend is a stub: ``prefix_embeds`` carries precomputed
frame embeddings [B, S_enc, D], projected by ``enc_in`` into a
bidirectional encoder.  Each decoder block adds cross-attention over
the encoder's output, its K/V unroped.  Every projection, ``enc_in`` and
the untied unembedding go through :mod:`repro_torch.core.lama_layers`,
so 7-bit codes launch the LUT GEMM (#1); attention is the plain
:func:`~repro_torch.models.layers.mha`, as the reference's is.

``prefill`` computes each decoder layer's self-attention K/V once and
hands them to ``mha`` (the reference's ``mha`` derives them again from
the same inputs: equal values, two launches fewer a layer).
``decode_step`` writes the self-attention cache *in place* at ``pos``
(an int, or a 0-d tensor on the device) and reads the cross K/V as they
stand; its mask is built on the device, so a captured step replays.  The
loop over the layer index takes the place of the reference's
``scan_blocks``.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lama_layers as ll
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec, layer_slice, stack_specs
from repro_torch.models.transformer import DecoderLM, _copy_at, cache_cast

FULL = ("full", None)        # the encoder's and the cross-attention's mask
CAUSAL = ("causal", None)


# --------------------------------------------------------------- specs --

def enc_block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
            "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}


def dec_block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
            "lnx": L.norm_specs(cfg), "xattn": L.attention_specs(cfg),
            "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}


def model_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embed_specs(cfg),
        "enc_in": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed2"),
                            "scaled"),
        "enc_blocks": stack_specs(enc_block_specs(cfg), cfg.enc_layers),
        "enc_ln_f": L.norm_specs(cfg),
        "dec_blocks": stack_specs(dec_block_specs(cfg), cfg.dec_layers),
        "ln_f": L.norm_specs(cfg),
        "unembed": L.unembed_specs(cfg),
    }


class EncDecLM(DecoderLM):
    """The encoder-decoder's parameters as a module: a
    :class:`~repro_torch.models.transformer.DecoderLM` over this family's
    specs.  Buffers follow the reference's params paths
    (``enc_blocks.attn.wq``, ``dec_blocks.xattn.wo.codes`` for a
    quantized cross-attention ``wo``, ``enc_ln_f.bias``,
    ``unembed.out``); each stack's leaves stay stacked ``[L, ...]``."""

    specs = staticmethod(model_specs)

    def _slice_layers(self) -> list[dict]:
        enc, dec = self["enc_blocks"].tree(), self["dec_blocks"].tree()
        return ([layer_slice(enc, j) for j in range(self.cfg.enc_layers)]
                + [layer_slice(dec, j) for j in range(self.cfg.dec_layers)])

    def enc_layer(self, i: int) -> dict:
        return self.layer(i)

    def dec_layer(self, i: int) -> dict:
        return self.layer(self.cfg.enc_layers + i)


# ------------------------------------------------------------- encoder --

def _enc_block(lp: dict, x, cfg: ModelConfig, positions):
    h = L.apply_norm(lp["ln1"], x, cfg)
    x = x + L.mha(lp["attn"], h, cfg, positions, FULL)
    h = L.apply_norm(lp["ln2"], x, cfg)
    return L.constrain_act(x + L.apply_mlp(lp["mlp"], h, cfg))


def encode(params: EncDecLM, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames [B, S_enc, D] (the stub frontend's embeddings) -> the
    encoder's states: ``enc_in``, then bidirectional self-attention
    blocks (RoPE on), then ``enc_ln_f``."""
    x = L.constrain_act(ll.dense(frames.to(L.cdtype(cfg)),
                                 params["enc_in"]))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i in range(cfg.enc_layers):
        x = L.remat(cfg, _enc_block, params.enc_layer(i), x, cfg, positions)
    return L.apply_norm(params["enc_ln_f"], x, cfg)


def _cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """A decoder layer's cross K/V from the encoder's states (no rope)."""
    return L.self_kv(p, enc_out, cfg, None, use_rope=False)


# ------------------------------------------------------------- decoder --

def _dec_block(lp: dict, x, enc_out, cfg: ModelConfig, positions):
    """One decoder block over a whole sequence: (y, the self-attention
    K/V (roped), the cross K/V)."""
    h = L.apply_norm(lp["ln1"], x, cfg)
    kv = L.self_kv(lp["attn"], h, cfg, positions)
    x = x + L.mha(lp["attn"], h, cfg, positions, CAUSAL, kv=kv)
    h = L.apply_norm(lp["lnx"], x, cfg)
    xkv = _cross_kv(lp["xattn"], enc_out, cfg)
    x = x + L.mha(lp["xattn"], h, cfg, positions, FULL, kv=xkv,
                  use_rope=False)
    h = L.apply_norm(lp["ln2"], x, cfg)
    return L.constrain_act(x + L.apply_mlp(lp["mlp"], h, cfg)), kv, xkv


def _decoder(params: EncDecLM, tokens, enc_out, cfg: ModelConfig):
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i in range(cfg.dec_layers):
        x = L.remat(cfg, _dec_block, params.dec_layer(i), x, enc_out, cfg,
                    positions)[0]
    return L.apply_norm(params["ln_f"], x, cfg)


def _frames(prefix_embeds):
    if prefix_embeds is None:
        raise ValueError("the encoder-decoder needs frame embeddings "
                         "(prefix_embeds [B, S_enc, D])")
    return prefix_embeds


def forward(params: EncDecLM, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds=None):
    """``prefix_embeds`` [B, S_enc, D] through the encoder, then
    ``tokens`` [B, S] through the decoder.  Returns (logits [B, S, V],
    the decoder's positions only; 0.0)."""
    enc_out = encode(params, _frames(prefix_embeds), cfg)
    x = _decoder(params, tokens, enc_out, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.logits_fn(params, x, cfg), aux


# ---------------------------------------------------- contiguous cache --

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None, enc_len: int | None = None):
    """A zeroed cache on ``device`` (the card unless ``"cpu"``): the
    self-attention ``k``/``v`` [L_dec, batch, max_len, n_kv, hd], the
    cross ``xk``/``xv`` [L_dec, batch, enc_len (default max_len), n_kv,
    hd], all of ``dtype``, and ``pos`` (an int)."""
    dev = resolve_device(device)
    kv, hd, n = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.dec_layers
    enc_len = enc_len or max_len

    def z(t):
        return torch.zeros((n, batch, t, kv, hd), dtype=dtype, device=dev)

    return {"k": z(max_len), "v": z(max_len), "xk": z(enc_len),
            "xv": z(enc_len), "pos": 0}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   enc_len: int | None = None, dtype=torch.bfloat16) -> dict:
    """:func:`init_cache`'s shapes and dtypes as ``meta`` tensors, ``pos``
    a 0-d int32 (the reference's signature and tree)."""
    kv, hd, n = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.dec_layers

    def meta(t):
        return torch.empty((n, batch, t, kv, hd), dtype=dtype, device="meta")

    return {"k": meta(max_len), "v": meta(max_len),
            "xk": meta(enc_len or max_len), "xv": meta(enc_len or max_len),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def prefill(params: EncDecLM, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, prefix_embeds=None, cache_dtype=torch.bfloat16):
    """Encode the frames and run the decoder over the prompts ``tokens``
    [B, S], building both caches: the self-attention K/V of the S
    positions in a ``max_len``-position cache, the cross K/V of every
    frame.  Returns (logits [B, 1, V] at the last position, the cache
    with ``pos = S``)."""
    frames = _frames(prefix_embeds)
    enc_out = encode(params, frames, cfg)
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds the cache's {max_len}")
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_cache(cfg, b, max_len, cache_dtype, device=x.device,
                       enc_len=frames.shape[1])
    for i in range(cfg.dec_layers):
        x, (k, v), (xk, xv) = _dec_block(params.dec_layer(i), x, enc_out,
                                         cfg, positions)
        cache["k"][i, :, :s] = cache_cast(k, cache_dtype)
        cache["v"][i, :, :s] = cache_cast(v, cache_dtype)
        cache["xk"][i] = cache_cast(xk, cache_dtype)
        cache["xv"][i] = cache_cast(xv, cache_dtype)
    x = L.apply_norm(params["ln_f"], x[:, -1:], cfg)
    cache["pos"] = s
    return L.logits_fn(params, x, cfg), cache


def decode_step(params: EncDecLM, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One step of every row: tokens [B, S] at position ``cache["pos"]``.
    Each decoder layer writes its new self-attention K/V into the cache
    in place, attends the whole cache under ``arange(max_len) <= pos``
    (the reference's mask, built on the device) through the dense
    ``mha``, then cross-attends every frame.  ``pos`` is an int (checked
    against the cache: a write past its end raises, where the
    reference's ``dynamic_update_slice`` clamps) or a 0-d int64 tensor on
    the cache's device, read nowhere on the host, so a captured step
    replays.  Returns (logits [B, S, V], the cache with ``pos`` advanced
    by one)."""
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    b, s, _ = x.shape
    pos = cache["pos"]
    max_len = cache["k"].shape[2]
    dev = x.device
    if isinstance(pos, torch.Tensor):
        positions = pos.expand(b, s)
        at = pos + torch.arange(s, device=dev)
    else:
        pos = int(pos)
        if pos + s > max_len:
            raise ValueError(f"cache full: position {pos} + {s} > {max_len}")
        positions = torch.full((b, s), pos, device=dev)
        at = slice(pos, pos + s)
    mask = (torch.arange(max_len, device=dev)[None, :] <= pos).expand(s,
                                                                      max_len)
    xmask = torch.ones((s, cache["xk"].shape[2]), dtype=torch.bool,
                       device=dev)
    dt = x.dtype
    for i in range(cfg.dec_layers):
        lp = params.dec_layer(i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = L.apply_norm(lp["ln1"], x, cfg)
        k_new, v_new = L.self_kv(lp["attn"], h, cfg, positions)
        k_new, v_new = cache_cast(k_new, kc.dtype), cache_cast(v_new, vc.dtype)
        if isinstance(at, slice):
            kc[:, at] = k_new
            vc[:, at] = v_new
        else:
            _copy_at(kc, at, k_new)
            _copy_at(vc, at, v_new)
        x = x + L.mha(lp["attn"], h, cfg, positions, mask,
                      kv=(kc.to(dt), vc.to(dt)))
        h = L.apply_norm(lp["lnx"], x, cfg)
        x = x + L.mha(lp["xattn"], h, cfg, positions, xmask,
                      kv=(cache["xk"][i].to(dt), cache["xv"][i].to(dt)),
                      use_rope=False)
        h = L.apply_norm(lp["ln2"], x, cfg)
        x = L.constrain_act(x + L.apply_mlp(lp["mlp"], h, cfg))
    x = L.apply_norm(params["ln_f"], x, cfg)
    return L.logits_fn(params, x, cfg), {**cache, "pos": pos + 1}
