"""RWKV-6 "Finch" (port of the JAX package's ``models/rwkv6.py``;
arXiv:2404.05892): an attention-free LM with a data-dependent token
shift (DD-lerp through a LoRA) and a data-dependent per-channel decay in
the WKV linear-attention recurrence.

The state at decode is O(1) a layer: the ``[B, H, K, V]`` WKV state and
two token-shift vectors.  Every ``w_*`` projection and the untied
unembedding go through :mod:`repro_torch.core.lama_layers`, so 7-bit
codes launch the LUT GEMM (#1); the LoRA and decay matrices stay float
(``quantize_tree``'s skip list), and the WKV scan, the token shift and
the norms are plain torch, as they are plain jnp in the reference.  The
scan runs in float32 in time order, one step a token, as the
reference's ``lax.scan`` does.

``decode_step`` writes every state *in place* (the reference returns a
new cache), so a step captured in a CUDA graph replays on its static
buffers; it takes ``pos`` as an int or a 0-d tensor on the device.  The
token-shift state is kept in the cache dtype (rounded through it at
prefill and at every step, as the reference's), the WKV state in
float32.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lama_layers as ll
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec, stack_specs
from repro_torch.models.transformer import DecoderLM, _check_prefix, cache_cast

LORA_SHIFT = 32   # DD-lerp LoRA rank
LORA_DECAY = 64   # decay LoRA rank
MIX_NAMES = ("w", "k", "v", "r", "g")
F32 = torch.float32
LN = "layernorm"  # every norm of the family, whatever cfg.norm says


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


# --------------------------------------------------------------- specs --

def time_mix_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    return {
        "mu_base": ParamSpec((d,), ("embed",), "normal", scale=0.1),
        "mu": ParamSpec((5, d), (None, "embed"), "normal", scale=0.1),
        "lora_a": ParamSpec((d, 5 * LORA_SHIFT), ("embed", None), "scaled"),
        "lora_b": ParamSpec((5, LORA_SHIFT, d), (None, None, "embed"),
                            "scaled", fan_in_axis=1),
        "w_r": ParamSpec((d, d), ("embed", "heads_mix"), "scaled"),
        "w_k": ParamSpec((d, d), ("embed", "heads_mix"), "scaled"),
        "w_v": ParamSpec((d, d), ("embed", "heads_mix"), "scaled"),
        "w_g": ParamSpec((d, d), ("embed", "heads_mix"), "scaled"),
        "w_o": ParamSpec((d, d), ("heads_mix", "embed"), "scaled"),
        "decay_base": ParamSpec((d,), ("embed",), "normal", scale=0.5),
        "decay_a": ParamSpec((d, LORA_DECAY), ("embed", None), "scaled"),
        "decay_b": ParamSpec((LORA_DECAY, d), (None, "embed"), "scaled"),
        "bonus_u": ParamSpec((h, hd), ("rwkv_heads", None), "normal",
                             scale=0.5),
        "gn_scale": ParamSpec((d,), ("embed",), "ones"),
    }


def channel_mix_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), ("embed",), "normal", scale=0.1),
        "mu_r": ParamSpec((d,), ("embed",), "normal", scale=0.1),
        "w_k": ParamSpec((d, f), ("embed", "mlp"), "scaled"),
        "w_v": ParamSpec((f, d), ("mlp", "embed"), "scaled", fan_in_axis=0),
        "w_r": ParamSpec((d, d), ("embed", "embed2"), "scaled"),
    }


def block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": L.norm_specs(cfg, LN), "tmix": time_mix_specs(cfg),
            "ln2": L.norm_specs(cfg, LN), "cmix": channel_mix_specs(cfg)}


def model_specs(cfg: ModelConfig) -> dict:
    return {"embed": L.embed_specs(cfg), "ln_in": L.norm_specs(cfg, LN),
            "blocks": stack_specs(block_specs(cfg), cfg.num_layers),
            "ln_f": L.norm_specs(cfg, LN), "unembed": L.unembed_specs(cfg)}


class RwkvLM(DecoderLM):
    """RWKV-6's parameters as a module: a
    :class:`~repro_torch.models.transformer.DecoderLM` over this family's
    specs.  Buffers follow the reference's params paths
    (``blocks.tmix.w_r.codes`` for a quantized ``w_r``, ``ln_in.bias``,
    ``unembed.out``); layer-stacked leaves stay stacked ``[L, ...]``."""

    specs = staticmethod(model_specs)


# -------------------------------------------------------------- mixing --

def _dd_lerp(p, x: torch.Tensor, x_prev: torch.Tensor) -> list:
    """Finch's data-dependent token shift: one lerp a projection, in the
    order w, k, v, r, g."""
    diff = x_prev - x
    z = x + diff * p["mu_base"].to(x.dtype)
    lora = torch.tanh(ll.dense(z, p["lora_a"]))               # [B, S, 5r]
    b, s, _ = lora.shape
    lora = L.reshape(lora, b, s, 5, LORA_SHIFT)
    adj = torch.einsum("bsnr,nrd->nbsd", lora,
                       ll.materialize(p["lora_b"], x.dtype))
    return [x + diff * (p["mu"][i].to(x.dtype) + adj[i])
            for i in range(len(MIX_NAMES))]


def _shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """The sequence x_{t-1}: zero before the first token, or ``last``
    (the carried token at decode)."""
    first = x.new_zeros(x[:, :1].shape) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], 1)


def wkv_scan(r, k, v, w, u, state: torch.Tensor | None = None):
    """The WKV recurrence.  r, k, v, w: [B, S, H, hd]; u: [H, hd];
    ``state``: [B, H, K, V] or None (zeros).

    ``S_t = diag(w_t) S_{t-1} + k_t^T v_t``, ``y_t = r_t (S_{t-1} +
    diag(u) k_t^T v_t)``, in float32 and in time order (the decay depends
    on the data).  Returns (y [B, S, H, hd] in r's dtype, the final state
    in float32); ``state`` itself is not written."""
    b, s, h, hd = r.shape
    S = (torch.zeros((b, h, hd, hd), dtype=F32, device=r.device)
         if state is None else state.to(F32))
    rf, kf, vf, wf = (t.to(F32) for t in (r, k, v, w))
    uu = u[None, :, :, None]
    ys = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # [B, H, K, V]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uu * kv))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, 1).to(r.dtype), S


def time_mix(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None):
    """The time-mixing block over x [B, S, D] from a zero state, or from
    ``state`` (``{"tshift", "wkv"}``).  Returns (out, the new state
    ``{"tshift": x's last token, "wkv": float32}``)."""
    b, s, d = x.shape
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    last = state["tshift"] if state else None
    xw, xk, xv, xr, xg = _dd_lerp(p, x, _shift(x, last))
    r = L.reshape(ll.dense(xr, p["w_r"]), b, s, h, hd)
    k = L.reshape(ll.dense(xk, p["w_k"]), b, s, h, hd)
    v = L.reshape(ll.dense(xv, p["w_v"]), b, s, h, hd)
    g = torch.nn.functional.silu(ll.dense(xg, p["w_g"]))
    dec = p["decay_base"].to(F32) + ll.dense(
        torch.tanh(ll.dense(xw, p["decay_a"])), p["decay_b"]).to(F32)
    w = L.reshape(torch.exp(-torch.exp(dec)), b, s, h, hd)
    y, wkv = wkv_scan(r, k, v, w, p["bonus_u"].to(F32),
                      state["wkv"] if state else None)
    # the per-head group norm, eps 1e-5
    yf = y.to(F32)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    y = L.reshape((yf - mu) * torch.rsqrt(var + 1e-5), b, s, d)
    y = (y * p["gn_scale"].to(F32)).to(x.dtype)
    return ll.dense(y * g, p["w_o"]), {"tshift": x[:, -1, :], "wkv": wkv}


def channel_mix(p, x: torch.Tensor, state: dict | None):
    """The channel-mixing block: ``sigmoid(r) * w_v(relu(w_k(.))^2)``
    on token-shifted inputs.  Returns (out, ``{"tshift": x's last
    token}``)."""
    prev = _shift(x, state["tshift"] if state else None)
    xk = x + (prev - x) * p["mu_k"].to(x.dtype)
    xr = x + (prev - x) * p["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(ll.dense(xk, p["w_k"])))
    rv = torch.sigmoid(ll.dense(xr, p["w_r"])) * ll.dense(k, p["w_v"])
    return rv, {"tshift": x[:, -1, :]}


# --------------------------------------------------------------- model --

def _layer(p: dict, x, cfg: ModelConfig, st_t: dict | None,
           st_c: dict | None):
    """One block: (x after it, the time-mix state, the channel-mix
    state)."""
    y, new_t = time_mix(p["tmix"], L.apply_norm(p["ln1"], x, cfg, LN), cfg,
                        st_t)
    x = x + y
    y, new_c = channel_mix(p["cmix"], L.apply_norm(p["ln2"], x, cfg, LN),
                           st_c)
    return L.constrain_act(x + y), new_t, new_c


def _embed(params: RwkvLM, tokens: torch.Tensor, cfg: ModelConfig):
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    return L.apply_norm(params["ln_in"], x, cfg, LN)


def forward(params: RwkvLM, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds=None):
    """Full-sequence forward from zero states.  Returns (logits [B, S,
    V], 0.0)."""
    _check_prefix(prefix_embeds)
    x = _embed(params, tokens, cfg)
    for i in range(cfg.num_layers):
        x = L.remat(cfg, _layer, params.layer(i), x, cfg, None, None)[0]
    x = L.apply_norm(params["ln_f"], x, cfg, LN)
    aux = torch.zeros((), dtype=F32, device=x.device)
    return L.logits_fn(params, x, cfg), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zero states: the token shifts ``tshift_t`` / ``tshift_c`` [L, B,
    D] in ``dtype``, ``wkv`` [L, B, H, hd, hd] in float32, and ``pos``
    (an int).  Its size does not depend on ``max_len`` (the reference's
    signature)."""
    del max_len
    dev = resolve_device(device)
    h, hd, n, d = _heads(cfg), cfg.rwkv_head_dim, cfg.num_layers, cfg.d_model
    return {"tshift_t": torch.zeros((n, batch, d), dtype=dtype, device=dev),
            "wkv": torch.zeros((n, batch, h, hd, hd), dtype=F32, device=dev),
            "tshift_c": torch.zeros((n, batch, d), dtype=dtype, device=dev),
            "pos": 0}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> dict:
    """:func:`init_cache`'s shapes and dtypes as ``meta`` tensors, ``pos``
    a 0-d int32 (the reference's)."""
    del max_len
    h, hd, n, d = _heads(cfg), cfg.rwkv_head_dim, cfg.num_layers, cfg.d_model

    def meta(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    return {"tshift_t": meta((n, batch, d)),
            "wkv": meta((n, batch, h, hd, hd), F32),
            "tshift_c": meta((n, batch, d)), "pos": meta((), torch.int32)}


def decode_step(params: RwkvLM, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """A step of every row: tokens [B, S] continuing from the cache's
    states, which are written in place (the token shifts rounded through
    their dtype, as the reference's).  ``pos`` (an int, or a 0-d tensor
    on the device) is only advanced: nothing here reads it on the host,
    so a captured step replays.  Returns (logits [B, S, V], the cache
    with ``pos`` advanced by one, as the reference's)."""
    x = _embed(params, tokens, cfg)
    for i in range(cfg.num_layers):
        ts_t, wkv, ts_c = (cache[k][i] for k in ("tshift_t", "wkv",
                                                  "tshift_c"))
        x, new_t, new_c = _layer(
            params.layer(i), x, cfg,
            {"tshift": ts_t.to(x.dtype), "wkv": wkv},
            {"tshift": ts_c.to(x.dtype)})
        ts_t.copy_(cache_cast(new_t["tshift"], ts_t.dtype))
        wkv.copy_(new_t["wkv"])
        ts_c.copy_(cache_cast(new_c["tshift"], ts_c.dtype))
    x = L.apply_norm(params["ln_f"], x, cfg, LN)
    return L.logits_fn(params, x, cfg), {**cache, "pos": cache["pos"] + 1}


def prefill(params: RwkvLM, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, prefix_embeds=None, cache_dtype=torch.bfloat16):
    """Run the prompts ``tokens`` [B, S] from zero states and keep each
    layer's final states: the token shifts rounded through
    ``cache_dtype``, the WKV state in float32.  Returns (logits [B, 1, V]
    at the last position, the cache with ``pos = S``)."""
    _check_prefix(prefix_embeds)
    x = _embed(params, tokens, cfg)
    cache = init_cache(cfg, x.shape[0], max_len, cache_dtype, device=x.device)
    for i in range(cfg.num_layers):
        x, new_t, new_c = _layer(params.layer(i), x, cfg, None, None)
        cache["tshift_t"][i] = cache_cast(new_t["tshift"], cache_dtype)
        cache["wkv"][i] = new_t["wkv"]
        cache["tshift_c"][i] = cache_cast(new_c["tshift"], cache_dtype)
    x = L.apply_norm(params["ln_f"], x[:, -1:], cfg, LN)
    cache["pos"] = tokens.shape[1]
    return L.logits_fn(params, x, cfg), cache
