"""Plain PyTorch version of chunked flash prefill over a paged KV cache.

The same page-scan recurrence as the reference oracle and the kernel: a
loop over block-table columns with online-softmax (m, l, acc) carries,
so no ``[S, T]`` score matrix exists; the largest score block is one
page wide.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def flash_prefill_paged_ref(q, k_pages, v_pages, block_tables, q_start,
                            kv_lens, out_dtype=F32) -> torch.Tensor:
    """q [B, S, n_kv, g, hd]; pages [N, bs, n_kv, hd]; block_tables
    [B, max_blk]; q_start/kv_lens [B].  Returns [B, S, n_kv, g, hd]."""
    b, s, n_kv, g, hd = q.shape
    bs = k_pages.shape[1]
    max_blk = block_tables.shape[1]
    dev = q.device
    qf = q.to(F32)
    scale = 1.0 / math.sqrt(hd)
    qpos = q_start.long()[:, None] + torch.arange(s, device=dev)[None, :]
    kv_lens = kv_lens.long()
    m = torch.full((b, n_kv, g, s), -1e30, dtype=F32, device=dev)
    l = torch.zeros((b, n_kv, g, s), dtype=F32, device=dev)
    acc = torch.zeros((b, n_kv, g, s, hd), dtype=F32, device=dev)
    for j in range(max_blk):
        tbl = block_tables[:, j].long()
        k = k_pages[tbl].to(F32)                                # [B, bs, n, h]
        v = v_pages[tbl].to(F32)
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
    return out.permute(0, 3, 1, 2, 4).to(out_dtype)
