"""RecurrentGemma / Griffin hybrid (port of the JAX package's
``models/rglru.py``; arXiv:2402.19427): RG-LRU recurrent blocks and
local multi-query attention, the pattern "rec, rec, local" repeating,
window 2048.

The RG-LRU runs as a log-depth scan over time for ``forward`` and
``prefill`` (:func:`rglru_scan`, the reference's
``jax.lax.associative_scan`` recursion step for step) and carries O(1)
state at decode.  The local attention decodes against a ring of
``window`` positions.  Every projection goes through
:mod:`repro_torch.core.lama_layers`, so 7-bit codes launch the LUT GEMMs
(#1, and #2 for the gated MLP; the tied unembedding #1's transposed
body); the gates, the temporal conv, the scan and the ring are plain
torch, as they are plain jnp in the reference.

Caches are updated *in place* (the reference returns new ones), so a
decode step captured in a CUDA graph replays on its static buffers:
``decode_step`` writes the ring at ``pos % window`` and the recurrent
state with ``copy_``, and takes ``pos`` as an int or a 0-d tensor on the
device.  The recurrent state lives in the dtypes decode writes it in
(the conv tail in the compute dtype, ``h`` in float32); ``prefill``
stores it rounded through the cache dtype, which is what the
reference's first decode step reads.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lama_layers as ll
from repro_torch.kernels.lut_dequant_matmul.ref import apply_activation
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec
from repro_torch.models.transformer import (DecoderLM, _check_prefix,
                                            _copy_at, cache_cast)

C_RGLRU = 8.0
F32 = torch.float32


# --------------------------------------------------------------- specs --

def rglru_specs(cfg: ModelConfig) -> dict:
    d, dr = cfg.d_model, cfg.rnn_width or cfg.d_model
    return {
        "w_in_gate": ParamSpec((d, dr), ("embed", "mlp"), "scaled"),
        "w_in_rec": ParamSpec((d, dr), ("embed", "mlp"), "scaled"),
        "conv_w": ParamSpec((cfg.conv_width, dr), (None, "mlp"), "scaled",
                            fan_in_axis=0),
        "conv_b": ParamSpec((dr,), ("mlp",), "zeros"),
        "wa": ParamSpec((dr, dr), ("mlp", "mlp2"), "scaled"),
        "ba": ParamSpec((dr,), ("mlp",), "zeros"),
        "wx": ParamSpec((dr, dr), ("mlp", "mlp2"), "scaled"),
        "bx": ParamSpec((dr,), ("mlp",), "zeros"),
        "lam": ParamSpec((dr,), ("mlp",), "normal", scale=0.5),
        "w_out": ParamSpec((dr, d), ("mlp", "embed"), "scaled"),
    }


def block_specs(cfg: ModelConfig, kind: str) -> dict:
    s = {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg)}
    if kind == "local":
        s["attn"] = L.attention_specs(cfg)
    else:
        s["rec"] = rglru_specs(cfg)
    s["mlp"] = L.mlp_specs(cfg)
    return s


def layer_kinds(cfg: ModelConfig) -> list[str]:
    pat = cfg.attention_pattern or ("rec", "rec", "local")
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def model_specs(cfg: ModelConfig) -> dict:
    """One ``layer_XX`` subtree a layer (no stacked ``layers`` axis, as
    in the reference), so ``quantize_tree`` fits each tensor on its
    own."""
    blocks = {f"layer_{i:02d}": block_specs(cfg, kind)
              for i, kind in enumerate(layer_kinds(cfg))}
    s = {"embed": L.embed_specs(cfg), "blocks": blocks,
         "ln_f": L.norm_specs(cfg)}
    if not cfg.tie_embeddings:
        s["unembed"] = L.unembed_specs(cfg)
    return s


class HybridLM(DecoderLM):
    """The hybrid's parameters as a module: a
    :class:`~repro_torch.models.transformer.DecoderLM` over this
    family's specs.  Buffers follow the reference's params paths
    (``blocks.layer_00.rec.w_in_gate``, ``blocks.layer_02.attn.wq.codes``
    for a quantized ``wq``); a layer is its own ``layer_XX`` subtree, not
    a slice of stacked leaves."""

    specs = staticmethod(model_specs)

    def _slice_layers(self) -> list[dict]:
        blocks = self["blocks"]
        return [blocks[f"layer_{j:02d}"].tree()
                for j in range(self.cfg.num_layers)]


# --------------------------------------------------------------- rglru --

def _gates(p, x: torch.Tensor):
    """The RG-LRU's decay ``a`` and input ``b`` (float32) for ``x``."""
    r = torch.sigmoid(ll.dense(x, p["wa"]) + p["ba"].to(x.dtype))
    i = torch.sigmoid(ll.dense(x, p["wx"]) + p["bx"].to(x.dtype))
    lam = p["lam"].to(F32)
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -C_RGLRU * softplus * r.to(F32)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * i.to(F32) * x.to(F32)


def _combine(lhs, rhs):
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, b1 * a2 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(elems):
    """Inclusive scan of ``(a, b)`` pairs under :func:`_combine` along
    axis 1, combining in the tree ``jax.lax.associative_scan`` uses:
    adjacent pairs first, the odd positions recursively, the even ones
    from them (log depth; the same products in the same order)."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], 1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def rglru_scan(p, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, Dr] -> the recurrence ``h_t = a_t h_{t-1} + b_t`` from
    ``h_{-1} = 0``, in float32, cast to x's dtype."""
    a, b = _gates(p, x)
    _, h = _associative_scan([a, b])
    return h.to(x.dtype)


def rglru_step(p, x: torch.Tensor, h_prev: torch.Tensor):
    """One decode step.  x: [B, 1, Dr]; h_prev: [B, Dr].  Returns (the
    output [B, 1, Dr] in x's dtype, the new state in float32)."""
    a, b = _gates(p, x)
    h = a[:, 0] * h_prev.to(F32) + b[:, 0]
    return h.to(x.dtype)[:, None, :], h


def temporal_conv(p, x: torch.Tensor, state: torch.Tensor | None = None):
    """Causal depthwise conv over time (width ``cfg.conv_width``).
    x: [B, S, Dr]; ``state``: [B, W-1, Dr], the trailing context
    (decode).  Returns (y, new_state)."""
    w = p["conv_w"].to(x.dtype)              # [W, Dr]
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], 1)              # [B, S+W-1, Dr]
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width)) \
        + p["conv_b"].to(x.dtype)
    return y, xp[:, -(width - 1):]


def rec_block(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """Griffin's recurrent temporal-mixing block: the full sequence from
    a zero state, or one decode step from ``state`` (``{"conv", "h"}``).
    Returns (y, new_state); ``state`` itself is not written."""
    gate = apply_activation(ll.dense(x, p["w_in_gate"]), "gelu")
    u = ll.dense(x, p["w_in_rec"])
    u, conv_state = temporal_conv(p, u, state["conv"] if state else None)
    if state is None:
        h = rglru_scan(p, u)
        new_state = {"conv": conv_state, "h": h[:, -1, :]}
    else:
        h, h_last = rglru_step(p, u, state["h"])
        new_state = {"conv": conv_state, "h": h_last}
    return ll.dense(h * gate, p["w_out"]), new_state


def init_rec_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """A zero recurrent state: the conv tail [B, W-1, Dr] in the compute
    dtype and ``h`` [B, Dr] in float32, the dtypes a decode step writes."""
    dr = cfg.rnn_width or cfg.d_model
    dev = resolve_device(device)
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, dr),
                                dtype=L.cdtype(cfg), device=dev),
            "h": torch.zeros((batch, dr), dtype=F32, device=dev)}


# ------------------------------------------------------- local attention --

def init_window_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                      device=None) -> dict:
    """An empty ring: ``k``/``v`` [B, window, n_kv, hd] of ``dtype`` and
    the position each slot holds, ``kpos`` [window] (-1: none)."""
    kv, hd, w = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.window
    dev = resolve_device(device)
    return {"k": torch.zeros((batch, w, kv, hd), dtype=dtype, device=dev),
            "v": torch.zeros((batch, w, kv, hd), dtype=dtype, device=dev),
            "kpos": torch.full((w,), -1, dtype=torch.int32, device=dev)}


def local_attn_block(p, x: torch.Tensor, cfg: ModelConfig, positions,
                     cache: dict | None, pos):
    """Windowed MQA.  Without ``cache``, the full sequence under a local
    mask.  With it (decode, one token at ``pos``: an int or a 0-d
    tensor), this step's K/V go into the ring at ``pos % window`` in
    place, and the step attends the slots holding positions in ``(pos -
    window, pos]``.  Returns (out, cache)."""
    if cache is None:
        return L.mha(p, x, cfg, positions, ("local", cfg.window)), None
    k_new, v_new = L.self_kv(p, x, cfg, positions)
    pos = torch.as_tensor(pos, device=x.device).reshape(1)
    slot = pos % cfg.window
    _copy_at(cache["k"], slot, cache_cast(k_new, cache["k"].dtype))
    _copy_at(cache["v"], slot, cache_cast(v_new, cache["v"].dtype))
    kpos = cache["kpos"]
    kpos.index_copy_(0, slot, pos.to(torch.int32))
    valid = (kpos >= 0) & (kpos <= pos) & (kpos > pos - cfg.window)
    out = L.mha(p, x, cfg, positions, valid[None, :],
                kv=(cache["k"].to(x.dtype), cache["v"].to(x.dtype)))
    return out, cache


# --------------------------------------------------------------- model --

def _block(p: dict, x, cfg: ModelConfig, positions, kind: str):
    """One layer over a whole sequence from zero states."""
    h = L.apply_norm(p["ln1"], x, cfg)
    if kind == "local":
        y, _ = local_attn_block(p["attn"], h, cfg, positions, None, None)
    else:
        y, _ = rec_block(p["rec"], h, cfg)
    x = x + y
    h = L.apply_norm(p["ln2"], x, cfg)
    return L.constrain_act(x + L.apply_mlp(p["mlp"], h, cfg))


def forward(params: HybridLM, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds=None):
    """Full-sequence forward.  Returns (logits [B, S, V], 0.0)."""
    _check_prefix(prefix_embeds)
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i, kind in enumerate(layer_kinds(cfg)):
        x = L.remat(cfg, _block, params.layer(i), x, cfg, positions, kind)
    x = L.apply_norm(params["ln_f"], x, cfg)
    aux = torch.zeros((), dtype=F32, device=x.device)
    return L.logits_fn(params, x, cfg), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """A zeroed decode cache: a ring of ``dtype`` a local layer, a
    recurrent state a rec layer, and ``pos`` (an int).  Its size does
    not depend on ``max_len`` (the reference's signature)."""
    del max_len
    cache: dict = {"pos": 0}
    for i, kind in enumerate(layer_kinds(cfg)):
        cache[f"layer_{i:02d}"] = (
            init_window_cache(cfg, batch, dtype, device) if kind == "local"
            else init_rec_state(cfg, batch, device))
    return cache


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> dict:
    """The reference's cache shapes and dtypes as ``meta`` tensors: a
    local layer's ring ``k``/``v`` in ``dtype`` and ``kpos`` int32, a
    rec layer's ``conv`` and ``h`` in ``dtype`` (the port's live state
    keeps ``conv`` in the compute dtype and ``h`` in float32, what a
    step writes), ``pos`` a 0-d int32."""
    del max_len
    kv, hd, w = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.window
    dr = cfg.rnn_width or cfg.d_model

    def meta(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    cache: dict = {"pos": meta((), torch.int32)}
    for i, kind in enumerate(layer_kinds(cfg)):
        cache[f"layer_{i:02d}"] = (
            {"k": meta((batch, w, kv, hd)), "v": meta((batch, w, kv, hd)),
             "kpos": meta((w,), torch.int32)} if kind == "local" else
            {"conv": meta((batch, cfg.conv_width - 1, dr)),
             "h": meta((batch, dr))})
    return cache


def decode_step(params: HybridLM, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One step of every row: tokens [B, 1] at position ``cache["pos"]``
    (an int, or a 0-d int64 tensor on the device: nothing here reads it
    on the host, so a captured step replays at whatever position it
    holds).  The rings and recurrent states are written in place.
    Returns (logits [B, 1, V], the cache with ``pos`` advanced by one)."""
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"the hybrid decodes one token a step, got {s}")
    pos = cache["pos"]
    positions = torch.as_tensor(pos, device=x.device).expand(b, s)
    for i, kind in enumerate(layer_kinds(cfg)):
        key = f"layer_{i:02d}"
        p = params.layer(i)
        h = L.apply_norm(p["ln1"], x, cfg)
        if kind == "local":
            y, _ = local_attn_block(p["attn"], h, cfg, positions, cache[key],
                                    pos)
        else:
            st = cache[key]
            y, new = rec_block(p["rec"], h, cfg, state=st)
            st["conv"].copy_(new["conv"])
            st["h"].copy_(new["h"])
        x = x + y
        h = L.apply_norm(p["ln2"], x, cfg)
        x = L.constrain_act(x + L.apply_mlp(p["mlp"], h, cfg))
    x = L.apply_norm(params["ln_f"], x, cfg)
    return L.logits_fn(params, x, cfg), {**cache, "pos": pos + 1}


def prefill(params: HybridLM, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, prefix_embeds=None, cache_dtype=torch.bfloat16):
    """Run the prompts ``tokens`` [B, S] through the full-sequence path
    and build the decode cache: each ring from the trailing ``min(window,
    S)`` positions at ``position % window``, each recurrent state from
    the last conv inputs and the last ``h``, both rounded through
    ``cache_dtype``.  A local layer's attention takes the K/V it writes
    (the reference derives them twice from the same inputs: equal
    values).  Returns (logits [B, 1, V] at the last position, the cache
    with ``pos = S``)."""
    _check_prefix(prefix_embeds)
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    b, s, _ = x.shape
    dev = x.device
    positions = torch.arange(s, device=dev).expand(b, s)
    cache = init_cache(cfg, b, max_len, cache_dtype, device=dev)
    cache["pos"] = s
    w = cfg.window
    take = min(w, s)
    kpos = torch.arange(s - take, s, device=dev)
    slots = kpos % w
    for i, kind in enumerate(layer_kinds(cfg)):
        p = params.layer(i)
        st = cache[f"layer_{i:02d}"]
        h = L.apply_norm(p["ln1"], x, cfg)
        if kind == "local":
            kv = L.self_kv(p["attn"], h, cfg, positions)
            y = L.mha(p["attn"], h, cfg, positions, ("local", w), kv=kv)
            for name, t in zip(("k", "v"), kv):
                _copy_at(st[name], slots, cache_cast(t[:, -take:],
                                                     cache_dtype))
            st["kpos"][slots] = kpos.to(torch.int32)
        else:
            y, new = rec_block(p["rec"], h, cfg)
            for name in ("conv", "h"):
                st[name].copy_(cache_cast(new[name], cache_dtype)
                               .to(st[name].dtype))
        x = x + y
        h = L.apply_norm(p["ln2"], x, cfg)
        x = L.constrain_act(x + L.apply_mlp(p["mlp"], h, cfg))
    x = L.apply_norm(params["ln_f"], x, cfg)
    return L.logits_fn(params, x[:, -1:], cfg), cache
