"""Decoder-only transformer LM (port of the JAX package's
``models/transformer.py``, dense decoder family): the contiguous-cache
entry points and the paged serving entry points.

``forward``, ``prefill`` and ``decode_step`` are the legacy contiguous
path (``InferenceServer.generate_bucketed``): one ``[L, B, max_len,
n_kv, hd]`` cache per batch, written *in place* at ``pos`` (the
reference returns a new cache from ``dynamic_update_slice``).
``prefill_into_cache`` and ``decode_step_paged`` take a
:class:`~repro_torch.runtime.paged_cache.PagedView` and update its page
pools in place too (``index_put_``); the reference returns a new view.
The loop over the layer index takes the place of the reference's
``scan_blocks``.  A layer's act-quant tables (``blocks.act_q``, attached
by calibration) switch its activations to codes; uint8 pages store K/V
as codes, encoded at the write; float8_e4m3fn pages and caches store
them cast as the reference casts them (:func:`cache_cast`).
``collect_act_calibration`` is the calibration hook.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lama_layers as ll
from repro_torch.core.exponential_quant import QWeight
from repro_torch.models import layers as L
from repro_torch.models.params import (ParamTree, init_params, layer_slice,
                                       stack_specs)


# --------------------------------------------------------------- specs --

F8 = torch.float8_e4m3fn
F8_LIMIT = 464.0   # past it e4m3fn's round to nearest even leaves 448


def block_specs(cfg: ModelConfig) -> dict:
    if cfg.is_moe:
        raise NotImplementedError("MoE blocks are not ported yet "
                                  "(ROADMAP Queue 1 item 13)")
    return {"ln1": L.norm_specs(cfg), "attn": L.attention_specs(cfg),
            "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}


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
            params = init_params(model_specs(cfg), gen, dev, dtype)
        super().__init__(params)
        self.cfg = cfg
        self.to(dev)
        self._layers: list[dict] | None = None

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    def with_tree(self, tree: dict) -> "DecoderLM":
        """A new module over ``tree`` (e.g. this module's tree with
        ``blocks.act_q`` attached or removed), sharing every tensor and
        with its own layer cache; this module is left as it is."""
        return DecoderLM(self.cfg, _rewrap(tree), device=self.device)

    def layer(self, i: int) -> dict:
        """Layer ``i``'s parameters as a nested dict of views (cached:
        serving weights do not change)."""
        if self._layers is None:
            blocks = self["blocks"].tree()
            self._layers = [layer_slice(blocks, j)
                            for j in range(self.cfg.num_layers)]
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


def _check_dense(cfg: ModelConfig, prefix_embeds) -> None:
    if cfg.is_moe:
        raise NotImplementedError("MoE blocks are not ported yet "
                                  "(ROADMAP Queue 1 item 13)")
    if prefix_embeds is not None:
        raise NotImplementedError("prefix embeddings (the vlm stub "
                                  "frontend) are not ported yet (ROADMAP "
                                  "Queue 1 item 13)")


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


def _block(lp: dict, x, cfg: ModelConfig, positions, mask):
    """One block over a contiguous sequence; returns (y, (k, v)) with
    this sequence's K (normed, roped) and V for the cache.  The
    attention takes those same K/V (the reference's ``mha`` derives them
    again from the same inputs: equal values)."""
    aq = lp.get("act_q")
    h = L.apply_norm(lp["ln1"], x, cfg)
    kv = L.self_kv(lp["attn"], h, cfg, positions, act_q=aq)
    x = x + L.mha(lp["attn"], h, cfg, positions, mask, kv=kv, act_q=aq)
    h = L.apply_norm(lp["ln2"], x, cfg)
    return x + L.apply_mlp(lp["mlp"], h, cfg, act_q=aq), kv


def forward(params: DecoderLM, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds=None):
    """Full-sequence causal forward.  Returns (logits [B, S, V], the
    auxiliary loss: 0.0, as for every dense block)."""
    _check_dense(cfg, prefix_embeds)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i in range(cfg.num_layers):
        x, _ = _block(params.layer(i), x, cfg, positions, ("causal", None))
    x = L.apply_norm(params["ln_f"], x, cfg)
    return L.logits_fn(params, x, cfg), torch.zeros((), device=x.device)


def prefill(params: DecoderLM, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, prefix_embeds=None, cache_dtype=torch.bfloat16):
    """Run the prompts ``tokens`` [B, S] and build a contiguous cache of
    ``max_len`` positions holding their K/V.  Returns (logits [B, 1, V]
    at the last position, the cache with ``pos = S``)."""
    _check_dense(cfg, prefix_embeds)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds the cache's {max_len}")
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_cache(cfg, b, max_len, cache_dtype, device=x.device)
    for i in range(cfg.num_layers):
        x, (k, v) = _block(params.layer(i), x, cfg, positions,
                           ("causal", None))
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
    _check_dense(cfg, None)
    x = L.embed_tokens(params["embed"], tokens, cfg)
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
        x = x + L.apply_mlp(lp["mlp"], h, cfg, act_q=aq)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return L.logits_fn(params, x, cfg), {**cache, "pos": pos + 1}


# ------------------------------------------------------- paged serving --

def _paged_block(lp: dict, x, cfg: ModelConfig, positions, k_pages, v_pages,
                 page, off, attend):
    """One block: scatter this step's K/V into the pages (encoded to
    codes first when the pages are uint8), then attend through
    ``attend``, then the MLP."""
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
    return x + L.apply_mlp(lp["mlp"], h, cfg, act_q=aq)


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
    x = L.embed_tokens(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    dev = x.device
    bs = view.block_size
    max_blk = view.block_tables.shape[1]
    start = (torch.zeros(b, dtype=torch.int32, device=dev) if start_pos is None
             else start_pos.to(torch.int32))
    valid = torch.clamp(view.lengths - start, 0, s)
    kv_lens = torch.where(valid > 0, start + valid, torch.zeros_like(valid))
    ar = torch.arange(s, device=dev)
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
                         view.k_pages[i], view.v_pages[i], page, off, attend)
    x = L.apply_norm(params["ln_f"], x, cfg)
    idx = torch.clamp(view.lengths - 1 - start, 0, s - 1).long()
    x_last = torch.gather(x, 1, idx[:, None, None].expand(b, 1, x.shape[-1]))
    return L.logits_fn(params, x_last, cfg), view


def decode_step_paged(params: DecoderLM, view, tokens: torch.Tensor,
                      active: torch.Tensor, cfg: ModelConfig):
    """One continuous-batching decode step over the paged cache.

    tokens [B, 1] (last sampled token per slot); active [B] bool.  Each
    active slot's new KV goes to page ``table[len // bs]``, offset
    ``len % bs`` (inactive slots write the trash page), then the
    flash-decode kernel attends with lengths ``len + 1`` (0 for inactive
    slots).  Returns (logits [B, 1, V], the view with active lengths
    advanced by one)."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
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
                         view.k_pages[i], view.v_pages[i], blk, off, attend)
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
    mlp_mid (the MLP intermediate), attn_q (the roped query), attn_k /
    attn_v (the roped keys and the values a page stores).  Attention is
    causal over the prompt, through the contiguous
    :func:`~repro_torch.models.layers.mha` as in the reference; the
    projections go through the usual dispatch.  No act-quant table is
    consulted.
    Returns ``{site: [L, B, S, ...]}``."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    samples: dict[str, list] = {site: [] for site in L.ACT_SITES}
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        h1 = L.apply_norm(lp["ln1"], x, cfg)
        attn, ctx = L.mha(lp["attn"], h1, cfg, positions, ("causal", None),
                          return_ctx=True)
        x = x + attn
        h2 = L.apply_norm(lp["ln2"], x, cfg)
        k_cal, v_cal = L.self_kv(lp["attn"], h1, cfg, positions)
        y, mid = L.apply_mlp(lp["mlp"], h2, cfg, return_mid=True)
        for site, t in (("attn_in", h1), ("attn_out", ctx), ("mlp_in", h2),
                        ("mlp_mid", mid),
                        ("attn_q", L.roped_q(lp["attn"], h1, cfg, positions)),
                        ("attn_k", k_cal), ("attn_v", v_cal)):
            samples[site].append(t)
        x = x + y
    return {site: torch.stack(ts) for site, ts in samples.items()}
