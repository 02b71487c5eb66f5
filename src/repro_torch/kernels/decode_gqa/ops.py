"""Public wrapper of flash decode over a paged KV cache.

A CPU tensor goes to the plain page-scan version, a CUDA tensor to the
kernel (or the call raises)."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_gqa import decode_gqa as _k
from repro_torch.kernels.decode_gqa.ref import decode_gqa_paged_ref
from repro_torch.kernels.flash_prefill.ops import row_ints


def decode_gqa_paged(q, k_pages, v_pages, block_tables, lengths, *,
                     out_dtype=None) -> torch.Tensor:
    """q [B, n_kv, g, hd]; pages [N, bs, n_kv, hd]; block_tables
    [B, max_blk] (entries past a row's length must still be valid page
    ids, e.g. the trash page); lengths [B] or scalar.  Zero-length rows
    return zeros.  Returns [B, n_kv, g, hd]."""
    out_dtype = out_dtype or torch.float32
    b = q.shape[0]
    max_tokens = block_tables.shape[1] * k_pages.shape[1]
    lengths = row_ints(lengths, b, q.device, max_tokens)
    if q.device.type == "cpu":
        return decode_gqa_paged_ref(q, k_pages, v_pages, block_tables,
                                    lengths, out_dtype=out_dtype)
    return _k.launch(q, k_pages, v_pages, block_tables, lengths).to(out_dtype)
