"""Public wrappers of flash decode over a contiguous KV cache and over a
paged one (float pages, and uint8 codes pages).

A CPU tensor goes to the plain page-scan version, a CUDA tensor to the
kernel (or the call raises)."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_gqa import decode_gqa as _k
from repro_torch.kernels.decode_gqa.ref import (decode_gqa_paged_codes_ref,
                                               decode_gqa_paged_ref,
                                               decode_gqa_ref)
from repro_torch.kernels.flash_prefill.ops import row_ints


def decode_gqa(q, k_cache, v_cache, lengths, *, out_dtype=None) -> torch.Tensor:
    """Flash decode over contiguous caches: q [B, n_kv, g, hd]; caches
    [B, S, n_kv, hd] (float32 or bfloat16 on the card); lengths [B] or a
    scalar, broadcast and clipped to [0, S] (the plain version gets them
    clipped here, the kernel clips them on the card itself, so a card
    call launches nothing here for an int32 [B] tensor).  Any S works:
    the kernel masks the tail itself (the reference pads S to its
    block).  Zero-length rows return zeros.  Returns [B, n_kv, g, hd]."""
    out_dtype = out_dtype or torch.float32
    hi = k_cache.shape[1] if q.device.type == "cpu" else None
    lengths = row_ints(lengths, q.shape[0], q.device, hi)
    if q.device.type == "cpu":
        return decode_gqa_ref(q, k_cache, v_cache, lengths,
                              out_dtype=out_dtype)
    return _k.launch_contiguous(q, k_cache, v_cache, lengths).to(out_dtype)


def _lengths(lengths, q, block_tables, k_pages) -> torch.Tensor:
    """The paged kernels' int32 [B] lengths.  The plain versions get
    them clipped to [0, max_blk * bs]; the kernels clip them on the card
    themselves, so a card call launches nothing here for an int32 [B]
    tensor."""
    hi = None
    if q.device.type == "cpu":
        hi = block_tables.shape[1] * k_pages.shape[1]
    return row_ints(lengths, q.shape[0], q.device, hi)


def decode_gqa_paged(q, k_pages, v_pages, block_tables, lengths, *,
                     out_dtype=None) -> torch.Tensor:
    """q [B, n_kv, g, hd]; pages [N, bs, n_kv, hd]; block_tables
    [B, max_blk] (entries past a row's length must still be valid page
    ids, e.g. the trash page); lengths [B] or scalar.  Zero-length rows
    return zeros.  Returns [B, n_kv, g, hd]."""
    out_dtype = out_dtype or torch.float32
    lengths = _lengths(lengths, q, block_tables, k_pages)
    if q.device.type == "cpu":
        return decode_gqa_paged_ref(q, k_pages, v_pages, block_tables,
                                    lengths, out_dtype=out_dtype)
    return _k.launch(q, k_pages, v_pages, block_tables, lengths).to(out_dtype)


def decode_gqa_paged_codes(q_codes, k_pages, v_pages, q_lut, k_lut, v_lut,
                           out_qmeta, block_tables, lengths) -> torch.Tensor:
    """Codes mode, uint8 in and out: ``q_codes`` [B, n_kv, g, hd] under
    ``q_lut`` [256]; uint8 pages under the per-head ``k_lut``/``v_lut``
    [n_kv, 256]; the context encoded under ``out_qmeta`` [4].  Same
    paging and masking contract as :func:`decode_gqa_paged`."""
    lengths = _lengths(lengths, q_codes, block_tables, k_pages)
    if q_codes.device.type == "cpu":
        return decode_gqa_paged_codes_ref(q_codes, k_pages, v_pages, q_lut,
                                          k_lut, v_lut, out_qmeta,
                                          block_tables, lengths)
    return _k.launch_codes(q_codes, k_pages, v_pages, q_lut, k_lut, v_lut,
                           out_qmeta, block_tables, lengths)
