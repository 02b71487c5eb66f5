"""Plain PyTorch versions of chunked flash prefill over a paged KV cache.

The same page-scan recurrence as the reference oracle and the kernel: a
loop over block-table columns with online-softmax (m, l, acc) carries,
so no ``[S, T]`` score matrix exists; the largest score block is one
page wide.  The codes version runs it over q and pages decoded through
their tables (``kernels/_codes.decode_heads``) and encodes the context.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.exponential_quant import encode_meta
from repro_torch.kernels._codes import decode_heads

F32 = torch.float32


def flash_prefill_paged_ref(q, k_pages, v_pages, block_tables, q_start,
                            kv_lens, out_dtype=F32) -> torch.Tensor:
    """q [B, S, n_kv, g, hd]; pages [N, bs, n_kv, hd]; block_tables
    [B, max_blk]; q_start/kv_lens [B].  Returns [B, S, n_kv, g, hd]."""
    out = _page_scan(q.to(F32), lambda t: k_pages[t].to(F32),
                     lambda t: v_pages[t].to(F32), k_pages.shape[1],
                     block_tables, q_start, kv_lens)
    return out.to(out_dtype)


def flash_prefill_paged_codes_ref(q_codes, k_pages, v_pages, q_lut, k_lut,
                                  v_lut, out_qmeta, block_tables, q_start,
                                  kv_lens) -> torch.Tensor:
    """Codes mode: uint8 q [B, S, n_kv, g, hd] through ``q_lut`` [256],
    uint8 pages through the per-head ``k_lut``/``v_lut`` [n_kv, 256],
    the context encoded under ``out_qmeta`` [4].  Returns uint8 of q's
    shape."""
    qf = q_lut.to(F32).reshape(256)[q_codes.long()]
    out = _page_scan(qf, lambda t: decode_heads(k_lut, k_pages[t]),
                     lambda t: decode_heads(v_lut, v_pages[t]),
                     k_pages.shape[1], block_tables, q_start, kv_lens)
    return encode_meta(out, out_qmeta.to(F32).reshape(4))


def _page_scan(qf, k_page, v_page, bs, block_tables, q_start,
               kv_lens) -> torch.Tensor:
    """The recurrence over float32 q [B, S, n_kv, g, hd]; ``k_page(t)``/
    ``v_page(t)`` give the float32 pages ``t`` [B] as [B, bs, n_kv, hd].
    Returns float32 [B, S, n_kv, g, hd]."""
    b, s, n_kv, g, hd = qf.shape
    max_blk = block_tables.shape[1]
    dev = qf.device
    scale = 1.0 / math.sqrt(hd)
    qpos = q_start.long()[:, None] + torch.arange(s, device=dev)[None, :]
    kv_lens = kv_lens.long()
    m = torch.full((b, n_kv, g, s), -1e30, dtype=F32, device=dev)
    l = torch.zeros((b, n_kv, g, s), dtype=F32, device=dev)
    acc = torch.zeros((b, n_kv, g, s, hd), dtype=F32, device=dev)
    for j in range(max_blk):
        tbl = block_tables[:, j].long()
        k = k_page(tbl)                                         # [B, bs, n, h]
        v = v_page(tbl)
        logit = torch.einsum("bsngh,btnh->bngst", qf, k) * scale
        kvpos = j * bs + torch.arange(bs, device=dev)
        valid = ((kvpos[None, None, :] <= qpos[:, :, None])
                 & (kvpos[None, None, :] < kv_lens[:, None, None]))
        logit = torch.where(valid[:, None, None], logit,
                            torch.tensor(-1e30, dtype=F32, device=dev))
        m_new = torch.maximum(m, logit.amax(-1))
        p = torch.exp(logit - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bngst,btnh->bngsh", p, v)
        m = m_new
    seen = m > -5e29
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = torch.where(seen[..., None], out, torch.zeros((), dtype=F32, device=dev))
    return out.permute(0, 3, 1, 2, 4)
