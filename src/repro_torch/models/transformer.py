"""Decoder-only transformer LM (port of the JAX package's
``models/transformer.py``, the decoder family with dense or MoE blocks):
the contiguous-cache entry points and the paged serving entry points.

``forward``, ``prefill`` and ``decode_step`` are the legacy contiguous
path (``InferenceServer.generate_bucketed``): one ``[L, B, max_len,
n_kv, hd]`` cache per batch, written *in place* at ``pos`` (the
reference returns a new cache from ``dynamic_update_slice``).  The vlm
family (paligemma-3b) runs them too: ``forward`` and ``prefill`` take
``prefix_embeds``, the stub frontend's patch embeddings, ahead of the
tokens under the prefix-LM mask, and the cache holds their K/V.
``prefill_into_cache``, ``spec_verify_into_cache`` and
``decode_step_paged`` take a
:class:`~repro_torch.runtime.paged_cache.PagedView` and update its page
pools in place too (``index_put_``); the reference returns a new view.
The loop over the layer index takes the place of the reference's
``scan_blocks``.  A layer's act-quant tables (``blocks.act_q``, attached
by calibration) switch its activations to codes; uint8 pages store K/V
as codes, encoded at the write; float8_e4m3fn pages and caches store
them cast as the reference casts them (:func:`cache_cast`).
``collect_act_calibration`` is the calibration hook.  An MoE block
(``cfg.is_moe``) holds ``moe`` in place of ``mlp`` and runs
:func:`repro_torch.models.moe.apply_moe` where a dense block runs
:func:`~repro_torch.models.layers.apply_mlp`.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lama_layers as ll
from repro_torch.core.exponential_quant import QWeight
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.params import (ParamTree, init_params, layer_slice,
                                       stack_specs)


# --------------------------------------------------------------- specs --

F8 = torch.float8_e4m3fn
F8_LIMIT = 464.0   # past it e4m3fn's round to nearest even leaves 448


def block_specs(cfg: ModelConfig) -> dict:
    s = {"ln1": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
         "ln2": L.norm_specs(cfg)}
    if cfg.is_moe:
        s["moe"] = M.moe_specs(cfg)
    else:
        s["mlp"] = L.mlp_specs(cfg)
    return s


def model_specs(cfg: ModelConfig) -> dict:
    s = {"embed": L.embed_specs(cfg),
         "blocks": stack_specs(block_specs(cfg), cfg.num_layers),
         "ln_f": L.norm_specs(cfg)}
    if not cfg.tie_embeddings:
        s["unembed"] = L.unembed_specs(cfg)
    return s


class DecoderLM(ParamTree):
    """The decoder's parameters as a module.  Buffers mirror the
    reference's params tree path for path (``embed.tokens``,
    ``blocks.attn.wq``, ``blocks.mlp.w_down.codes``, ``ln_f.scale``);
    layer-stacked leaves stay stacked ``[L, ...]``.

    ``params`` is a nested dict of tensors / ``QWeight`` (e.g. from
    :func:`repro_torch.convert.params_from_jax` or ``quantize_tree``);
    without it the weights are drawn from a ``torch.Generator`` seeded
    with ``seed`` on the device.  The device is the card unless
    ``device="cpu"`` is passed."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 device=None, seed: int = 0, dtype=torch.float32):
        dev = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(self.specs(cfg), gen, dev, dtype)
        super().__init__(params)
        self.cfg = cfg
        self.to(dev)
        self._layers: list[dict] | None = None

    specs = staticmethod(model_specs)

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    def with_tree(self, tree: dict) -> "DecoderLM":
        """A new module of this class over ``tree`` (e.g. this module's
        tree with ``blocks.act_q`` attached or removed), sharing every
        tensor and with its own layer cache; this module is left as it
        is."""
        return type(self)(self.cfg, _rewrap(tree), device=self.device)

    def _slice_layers(self) -> list[dict]:
        blocks = self["blocks"].tree()
        return [layer_slice(blocks, j) for j in range(self.cfg.num_layers)]

    def layer(self, i: int) -> dict:
        """Layer ``i``'s parameters as a nested dict of views (cached:
        serving weights do not change)."""
        if self._layers is None:
            self._layers = self._slice_layers()
        return self._layers[i]

    def _apply(self, fn, *args, **kw):
        self._layers = None
        return super()._apply(fn, *args, **kw)


def _rewrap(tree: dict) -> dict:
    """``tree`` with fresh carrier modules over the same tensors, so two
    modules never share a submodule (moving one must not move the
    other)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _rewrap(v)
        elif isinstance(v, QWeight):
            out[k] = QWeight(v.codes, v.lut, v.qmeta)
        else:
            out[k] = v
    return out


# ---------------------------------------------------- contiguous cache --

def cache_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a cache or page of ``dtype`` stores it: the reference's
    ``astype(cache_dtype)``.  To float8_e4m3fn, torch's cast saturates
    |x| past F8_LIMIT and +-inf to +-448, where the reference's
    (ml_dtypes) gives NaN: those, and NaN, become NaN of x's sign here
    (0x7f / 0xff), and every other value takes torch's cast, which rounds
    as the reference's does.  No host read and no branch on the data, so
    a CUDA graph captures it."""
    if dtype != F8:
        return x.to(dtype)
    xf = x.float()
    nan = torch.signbit(xf).to(torch.uint8) * 128 + 0x7F
    return torch.where(xf.abs() <= F8_LIMIT, xf.to(F8).view(torch.uint8),
                       nan).view(F8)


def _copy_at(cache: torch.Tensor, at: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[:, at] = new`` for a tensor of positions ``at``; float8
    through byte views (``index_copy_`` has no CPU kernel for it)."""
    if cache.dtype == F8:
        cache, new = cache.view(torch.uint8), new.view(torch.uint8)
    cache.index_copy_(1, at, new)


def _check_prefix(prefix_embeds) -> None:
    """Refuse prefix embeddings in a family without a stub frontend (the
    reference's hybrid and rwkv entry points take the argument and drop
    it)."""
    if prefix_embeds is not None:
        raise NotImplementedError("prefix embeddings (the vlm stub "
                                  "frontend) are taken by the decoder and "
                                  "vlm families only")


def _embed_with_prefix(params, tokens, cfg: ModelConfig, prefix_embeds):
    """The token embeddings [B, S, D], after the prefix embeddings [B, P,
    D] cast to their dtype when given, and the attention mask: ``("prefix",
    P)`` (full within the prefix, causal after it), else causal."""
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    if prefix_embeds is None:
        return x, ("causal", None)
    x = torch.cat([prefix_embeds.to(x.dtype), x], 1)
    return L.constrain_act(x), ("prefix", prefix_embeds.shape[1])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """A zeroed contiguous cache: ``k``/``v`` [L, batch, max_len, n_kv,
    hd] of ``dtype`` on ``device`` (the card unless ``"cpu"``) and the
    next write position ``pos`` (an int)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": 0}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> dict:
    """The contiguous cache's shapes and dtypes as ``meta`` tensors, the
    reference's (``pos`` a 0-d int32)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def _ffn(lp: dict, h, cfg: ModelConfig, act_q, moe_counts=None):
    """The block's feed-forward half on the ln2 output: (y, aux), the MoE
    layer's load-balancing loss or None for a dense MLP.  ``moe_counts``:
    the capacity tally a routed dispatch adds to (a paged view's)."""
    if cfg.is_moe:
        return M.apply_moe(lp["moe"], h, cfg, act_q=act_q, counts=moe_counts)
    return L.apply_mlp(lp["mlp"], h, cfg, act_q=act_q), None


def _block(lp: dict, x, cfg: ModelConfig, positions, mask):
    """One block over a contiguous sequence; returns (y, aux, (k, v))
    with this sequence's K (normed, roped) and V for the cache.  The
    attention takes those same K/V (the reference's ``mha`` derives them
    again from the same inputs: equal values)."""
    aq = lp.get("act_q")
    h = L.apply_norm(lp["ln1"], x, cfg)
    kv = L.self_kv(lp["attn"], h, cfg, positions, act_q=aq)
    x = x + L.mha(lp["attn"], h, cfg, positions, mask, kv=kv, act_q=aq)
    h = L.apply_norm(lp["ln2"], x, cfg)
    y, aux = _ffn(lp, h, cfg, aq)
    return L.constrain_act(x + y), aux, kv


def forward(params: DecoderLM, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds=None):
    """Full-sequence forward over ``prefix_embeds`` [B, P, D] (the vlm's
    patch embeddings, attended under the prefix-LM mask) and then
    ``tokens`` [B, S].  Returns (logits [B, P + S, V], the auxiliary
    loss: the MoE layers' load-balancing loss averaged over the layers,
    0.0 for dense blocks)."""
    x, mask = _embed_with_prefix(params, tokens, cfg, prefix_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a, _ = L.remat(cfg, _block, params.layer(i), x, cfg, positions,
                          mask)
        if a is not None:
            aux = aux + a
    x = L.apply_norm(params["ln_f"], x, cfg)
    return L.logits_fn(params, x, cfg), aux / max(cfg.num_layers, 1)


def prefill(params: DecoderLM, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, prefix_embeds=None, cache_dtype=torch.bfloat16):
    """Run ``prefix_embeds`` [B, P, D] (if given) and the prompts
    ``tokens`` [B, S], and build a contiguous cache of ``max_len``
    positions holding the K/V of all ``P + S``.  Returns (logits [B, 1,
    V] at the last position, the cache with ``pos = P + S``)."""
    x, mask = _embed_with_prefix(params, tokens, cfg, prefix_embeds)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds the cache's {max_len}")
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_cache(cfg, b, max_len, cache_dtype, device=x.device)
    for i in range(cfg.num_layers):
        x, _, (k, v) = _block(params.layer(i), x, cfg, positions, mask)
        cache["k"][i, :, :s] = cache_cast(k, cache_dtype)
        cache["v"][i, :, :s] = cache_cast(v, cache_dtype)
    x = L.apply_norm(params["ln_f"], x, cfg)
    cache["pos"] = s
    return L.logits_fn(params, x[:, -1:], cfg), cache


def decode_step(params: DecoderLM, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One step of every row: tokens [B, S] (S = 1 on the serving path)
    at position ``cache["pos"]``, their K/V written into the cache in
    place.  Attention goes through the flash-decode kernel (policy
    ``flash_decode``, S = 1), else the dense masked attend over the
    cache upcast to the compute dtype.  Returns (logits [B, S, V], the
    cache with ``pos`` advanced by one, as the reference's).

    ``pos`` is an int, or a 0-d int64 tensor on the cache's device (the
    reference's traced position): then nothing here reads it on the
    host, so a captured step replays at whatever position the tensor
    holds, and the caller checks that the cache has room."""
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    b, s, _ = x.shape
    pos = cache["pos"]
    max_len = cache["k"].shape[2]
    dev = x.device
    if isinstance(pos, torch.Tensor):
        positions = pos.expand(b, s)
        at = pos + torch.arange(s, device=dev)
        lengths = (pos + 1).to(torch.int32).expand(b)
    else:
        pos = int(pos)
        if pos + s > max_len:
            raise ValueError(f"cache full: position {pos} + {s} > {max_len}")
        positions = torch.full((b, s), pos, device=dev)
        at = slice(pos, pos + s)
        lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
    mask = (torch.arange(max_len, device=dev)[None, :] <= pos).expand(s, max_len)
    flash = ll.get_policy().flash_decode and s == 1
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        aq = lp.get("act_q")
        kc, vc = cache["k"][i], cache["v"][i]
        h = L.apply_norm(lp["ln1"], x, cfg)
        k_new, v_new = L.self_kv(lp["attn"], h, cfg, positions, act_q=aq)
        k_new, v_new = cache_cast(k_new, kc.dtype), cache_cast(v_new, vc.dtype)
        if isinstance(at, slice):
            kc[:, at] = k_new
            vc[:, at] = v_new
        else:
            _copy_at(kc, at, k_new)
            _copy_at(vc, at, v_new)
        if flash:
            attn = L.mha_decode(lp["attn"], h, cfg, positions, kc, vc,
                                lengths, act_q=aq)
        else:
            attn = L.mha(lp["attn"], h, cfg, positions, mask,
                         kv=(kc.to(x.dtype), vc.to(x.dtype)), act_q=aq)
        x = x + attn
        h = L.apply_norm(lp["ln2"], x, cfg)
        x = L.constrain_act(x + _ffn(lp, h, cfg, aq)[0])
    x = L.apply_norm(params["ln_f"], x, cfg)
    return L.logits_fn(params, x, cfg), {**cache, "pos": pos + 1}


# ---------------------------------------------------------------- loss --

def lm_loss(params: DecoderLM, batch: dict, cfg: ModelConfig):
    """Next-token cross-entropy with the z-loss; ``batch``: ``tokens`` /
    ``targets`` [B, S], and optionally ``prefix_embeds`` (whose
    positions' logits are dropped) and a float ``mask`` [B, S].  Returns
    (loss + z-loss + 0.01 aux, ``{"loss", "z_loss", "aux_loss",
    "ppl_proxy"}``)."""
    pe = batch.get("prefix_embeds")
    logits, aux = forward(params, batch["tokens"], cfg, prefix_embeds=pe)
    if pe is not None:
        logits = logits[:, pe.shape[1]:, :]
    logz = torch.logsumexp(logits, -1)
    tgt = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
    nll = logz - tgt
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    loss = torch.sum(nll * mask) / denom
    zl = cfg.z_loss * torch.sum((logz ** 2) * mask) / denom
    total = loss + zl + 0.01 * aux
    return total, {"loss": loss, "z_loss": zl, "aux_loss": aux,
                   "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}


# ------------------------------------------------------- paged serving --

def _paged_block(lp: dict, x, cfg: ModelConfig, positions, k_pages, v_pages,
                 page, off, attend, moe_counts=None):
    """One block: scatter this step's K/V into the pages (encoded to
    codes first when the pages are uint8), then attend through
    ``attend``, then the MLP or MoE layer (its capacity tally
    ``moe_counts``)."""
    aq = lp.get("act_q")
    h = L.apply_norm(lp["ln1"], x, cfg)
    k_new, v_new = L.self_kv(lp["attn"], h, cfg, positions, act_q=aq)
    if k_pages.dtype == torch.uint8:
        # a uint8 page stores codes: a cast would truncate floats to junk
        k_new, v_new = L.encode_kv_codes(k_new, v_new, aq)
    # in place: the page pool is updated where it lives
    k_pages.index_put_((page, off), cache_cast(k_new, k_pages.dtype))
    v_pages.index_put_((page, off), cache_cast(v_new, v_pages.dtype))
    x = x + attend(lp["attn"], h, k_pages, v_pages, aq)
    h = L.apply_norm(lp["ln2"], x, cfg)
    return L.constrain_act(x + _ffn(lp, h, cfg, aq, moe_counts)[0])


def _window_layers(params: DecoderLM, x, view, cfg: ModelConfig, start,
                   valid):
    """Every layer over a window of each row's tokens at ``start``
    (``valid`` of them real): their K/V scattered into the pages first
    (padding and positions past the table to the trash page), then the
    chunked flash attend over the cached prefix and the window's causal
    left (a row with nothing valid attends nothing).  Returns the
    final-normed hidden states."""
    bs = view.block_size
    max_blk = view.block_tables.shape[1]
    kv_lens = torch.where(valid > 0, start + valid, torch.zeros_like(valid))
    ar = torch.arange(x.shape[1], device=x.device)
    positions = start[:, None].long() + ar[None, :]
    tok_ok = (ar[None, :] < valid[:, None]) & (positions // bs < max_blk)
    col = torch.where(tok_ok, positions // bs, 0)
    page = torch.where(tok_ok, torch.gather(view.block_tables.long(), 1, col), 0)
    off = torch.where(tok_ok, positions % bs, 0)

    def attend(p, h, kp, vp, aq):
        return L.mha_prefill_paged(p, h, cfg, positions, kp, vp,
                                   view.block_tables, start, kv_lens,
                                   act_q=aq)

    for i in range(cfg.num_layers):
        x = _paged_block(params.layer(i), x, cfg, positions,
                         view.k_pages[i], view.v_pages[i], page, off, attend,
                         view.moe_counts)
    return L.apply_norm(params["ln_f"], x, cfg)


def prefill_into_cache(params: DecoderLM, tokens: torch.Tensor, view,
                       cfg: ModelConfig, start_pos: torch.Tensor | None = None):
    """Run one chunk of each row's prompt and scatter its KV into the
    paged cache -- the one prefill path (cold, prefix tail and
    mid-prompt chunk differ only in ``start_pos``).

    ``tokens[b]`` covers absolute positions ``[start_pos[b],
    start_pos[b] + S)``; ``view.lengths`` holds the true total prompt
    lengths, so the row's valid count is ``clip(lengths - start, 0,
    S)``.  Padding (and positions past the table) scatter to the trash
    page *before* the attend; a row with nothing to do writes nothing
    and attends nothing.  Returns (logits [B, 1, V] at each row's true
    last token ``lengths - 1 - start``, the view)."""
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    b, s, _ = x.shape
    start = (torch.zeros(b, dtype=torch.int32, device=x.device)
             if start_pos is None else start_pos.to(torch.int32))
    valid = torch.clamp(view.lengths - start, 0, s)
    x = _window_layers(params, x, view, cfg, start, valid)
    idx = torch.clamp(view.lengths - 1 - start, 0, s - 1).long()
    x_last = torch.gather(x, 1, idx[:, None, None].expand(b, 1, x.shape[-1]))
    return L.logits_fn(params, x_last, cfg), view


def spec_verify_into_cache(params: DecoderLM, tokens: torch.Tensor, view,
                           cfg: ModelConfig, start_pos: torch.Tensor,
                           n_tokens: torch.Tensor):
    """Score a speculative window: the engine's verify dispatch.
    ``tokens[b]`` is the row's undecoded next token followed by up to
    ``S-1`` drafted continuations at positions ``start_pos[b] + i``;
    ``n_tokens[b]`` of them are real (0 parks an idle row: its writes go
    to the trash page and it attends nothing; 1 is an ordinary decode
    step riding the dispatch).

    :func:`prefill_into_cache` with the valid count given by the
    caller: every valid position's K/V is written first (encoded to
    codes on uint8 pages, as a decode step writes it), then the chunked
    flash attend scores position ``i`` as if drafts ``< i`` were
    accepted.  Greedy acceptance is computed here, with no host read:
    returns ``greedy [B, S]`` (the argmax at every position), ``accept
    [B]`` (the leading run where the argmax reproduces the drafts, ``0
    <= accept <= n_tokens - 1``), ``ok [B]`` (finite logits at the
    row's valid positions; True for a parked row) and the view, whose
    lengths the engine advances itself."""
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    s = x.shape[1]
    start = start_pos.to(torch.int32)
    valid = torch.clamp(n_tokens.to(torch.int32), 0, s)
    x = _window_layers(params, x, view, cfg, start, valid)
    logits = L.logits_fn(params, x, cfg)                      # [B, S, V]
    greedy = torch.argmax(logits, -1)                         # [B, S]
    ar = torch.arange(s, device=x.device)
    in_window = ar[None, :-1] < (valid - 1)[:, None]
    match = (greedy[:, :-1] == tokens[:, 1:].long()) & in_window
    accept = torch.cumprod(match.to(torch.int32), 1).sum(1)
    finite = torch.isfinite(logits).all(-1)
    ok = torch.where(ar[None, :] < valid[:, None], finite, True).all(1)
    return greedy, accept, ok, view


def decode_step_paged(params: DecoderLM, view, tokens: torch.Tensor,
                      active: torch.Tensor, cfg: ModelConfig):
    """One continuous-batching decode step over the paged cache.

    tokens [B, 1] (last sampled token per slot); active [B] bool.  Each
    active slot's new KV goes to page ``table[len // bs]``, offset
    ``len % bs`` (inactive slots write the trash page), then the
    flash-decode kernel attends with lengths ``len + 1`` (0 for inactive
    slots).  Returns (logits [B, 1, V], the view with active lengths
    advanced by one)."""
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    b, s, _ = x.shape
    assert s == 1, s
    bs = view.block_size
    pos = view.lengths
    positions = pos[:, None].long()
    blk_col = torch.clamp(pos // bs, 0, view.block_tables.shape[1] - 1).long()
    blk = torch.gather(view.block_tables.long(), 1, blk_col[:, None])
    blk = torch.where(active[:, None], blk, 0)                # trash page
    off = torch.where(active, pos % bs, 0).long()[:, None]
    attn_lengths = torch.where(active, pos + 1, 0).to(torch.int32)

    def attend(p, h, kp, vp, aq):
        return L.mha_decode_paged(p, h, cfg, positions, kp, vp,
                                  view.block_tables, attn_lengths, act_q=aq)

    for i in range(cfg.num_layers):
        x = _paged_block(params.layer(i), x, cfg, positions,
                         view.k_pages[i], view.v_pages[i], blk, off, attend,
                         view.moe_counts)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.logits_fn(params, x, cfg)
    new_lengths = torch.where(active, pos + 1, pos).to(torch.int32)
    return logits, view._replace(lengths=new_lengths)


# ----------------------------------------------------- act calibration --

def collect_act_calibration(params: DecoderLM, tokens: torch.Tensor,
                            cfg: ModelConfig) -> dict:
    """One forward over calibration prompts ``tokens`` [B, S], capturing
    per layer the float activation at every site of
    :data:`~repro_torch.models.layers.ACT_SITES`: attn_in (ln1 output),
    attn_out (the attention context before ``wo``), mlp_in (ln2 output),
    mlp_mid (the MLP intermediate; dense blocks only: an MoE expert's
    intermediate stays float, as in the reference), attn_q (the roped
    query), attn_k / attn_v (the roped keys and the values a page
    stores).  Attention is
    causal over the prompt, through the contiguous
    :func:`~repro_torch.models.layers.mha` as in the reference; the
    projections go through the usual dispatch.  No act-quant table is
    consulted.
    Returns ``{site: [L, B, S, ...]}``."""
    x = L.constrain_act(L.embed_tokens(params["embed"], tokens, cfg))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    samples: dict[str, list] = {site: [] for site in L.ACT_SITES
                                if site != "mlp_mid" or not cfg.is_moe}
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        h1 = L.apply_norm(lp["ln1"], x, cfg)
        attn, ctx = L.mha(lp["attn"], h1, cfg, positions, ("causal", None),
                          return_ctx=True)
        x = x + attn
        h2 = L.apply_norm(lp["ln2"], x, cfg)
        k_cal, v_cal = L.self_kv(lp["attn"], h1, cfg, positions)
        sites = {"attn_in": h1, "attn_out": ctx, "mlp_in": h2,
                 "attn_q": L.roped_q(lp["attn"], h1, cfg, positions),
                 "attn_k": k_cal, "attn_v": v_cal}
        if cfg.is_moe:
            y, _ = M.apply_moe(lp["moe"], h2, cfg)
        else:
            y, sites["mlp_mid"] = L.apply_mlp(lp["mlp"], h2, cfg,
                                              return_mid=True)
        for site, t in sites.items():
            samples[site].append(t)
        x = L.constrain_act(x + y)
    return {site: torch.stack(ts) for site, ts in samples.items()}
