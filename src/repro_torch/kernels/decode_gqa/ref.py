"""Plain PyTorch versions of flash decode over a contiguous and over a
paged KV cache.

Decoding one query at position ``len-1`` against ``len`` cached tokens
is the chunked prefill of a one-token chunk (validity
``kv_pos <= len-1 and kv_pos < len`` is ``kv_pos < len``), so this runs
the same page-scan recurrence as the kernel; zero-length rows return
zeros.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_prefill.ref import (
    flash_prefill_paged_codes_ref, flash_prefill_paged_ref)


def decode_gqa_ref(q, k_cache, v_cache, lengths,
                   out_dtype=torch.float32) -> torch.Tensor:
    """The contiguous oracle, as the reference's: q [B, n_kv, g, hd];
    caches [B, S, n_kv, hd]; lengths [B].  Positions at or past
    ``lengths[b]`` are filled with -1e30 before one softmax.  A
    zero-length row, which that softmax would average over every
    position, gets zeros as the kernels give it (the reference's paged
    wrapper does the same after its oracle)."""
    qf, kf, vf = q.float(), k_cache.float(), v_cache.float()
    logit = torch.einsum("bngh,bsnh->bngs", qf, kf) / math.sqrt(q.shape[-1])
    pos = torch.arange(kf.shape[1], device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]            # [B, S]
    logit = torch.where(valid[:, None, None, :], logit,
                        torch.tensor(-1e30, dtype=torch.float32,
                                     device=q.device))
    out = torch.einsum("bngs,bsnh->bngh", torch.softmax(logit, dim=-1), vf)
    out = torch.where((lengths > 0).to(q.device)[:, None, None, None], out,
                      torch.zeros((), device=q.device))
    return out.to(out_dtype)


def decode_gqa_paged_ref(q, k_pages, v_pages, block_tables, lengths,
                         out_dtype=torch.float32) -> torch.Tensor:
    """q [B, n_kv, g, hd]; pages [N, bs, n_kv, hd]; block_tables
    [B, max_blk]; lengths [B].  Returns [B, n_kv, g, hd].  A NaN score
    gives the row NaN, as the reference's dense softmax does."""
    out = flash_prefill_paged_ref(q[:, None], k_pages, v_pages, block_tables,
                                  lengths - 1, lengths, out_dtype=out_dtype,
                                  keep_nan=True)
    return out[:, 0]


def decode_gqa_paged_codes_ref(q_codes, k_pages, v_pages, q_lut, k_lut, v_lut,
                               out_qmeta, block_tables,
                               lengths) -> torch.Tensor:
    """Codes mode: uint8 q [B, n_kv, g, hd] and pages, tables as
    :func:`flash_prefill_paged_codes_ref`.  Returns uint8 [B, n_kv, g,
    hd]; a zero-length row holds the code of 0.0."""
    out = flash_prefill_paged_codes_ref(
        q_codes[:, None], k_pages, v_pages, q_lut, k_lut, v_lut, out_qmeta,
        block_tables, lengths - 1, lengths)
    return out[:, 0]
