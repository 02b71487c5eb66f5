"""Public wrappers of chunked flash prefill over a paged KV cache (float
pages, and uint8 codes pages).

A CPU tensor goes to the plain page-scan version, a CUDA tensor to the
kernel (or the call raises)."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill import flash_prefill as _k
from repro_torch.kernels.flash_prefill.ref import (
    flash_prefill_paged_codes_ref, flash_prefill_paged_ref)


def row_ints(v, b: int, device, hi: int | None = None) -> torch.Tensor:
    """A per-row int32 [b] tensor from an int or tensor, clipped to
    [0, hi] when ``hi`` is given."""
    t = torch.as_tensor(v, device=device).to(torch.int32).expand(b)
    if hi is not None:
        t = t.clamp(0, hi)
    return t.contiguous()


def flash_prefill_paged(q, k_pages, v_pages, block_tables, q_start, kv_lens,
                        *, out_dtype=None) -> torch.Tensor:
    """q [B, S, n_kv, g, hd], row 0 at absolute position ``q_start[b]``;
    pages [N, bs, n_kv, hd]; ``kv_lens`` caps validity at the positions
    actually written.  Rows with no valid position return zeros.
    Returns [B, S, n_kv, g, hd]."""
    out_dtype = out_dtype or torch.float32
    b = q.shape[0]
    max_tokens = block_tables.shape[1] * k_pages.shape[1]
    q_start = row_ints(q_start, b, q.device)
    kv_lens = row_ints(kv_lens, b, q.device, max_tokens)
    if q.device.type == "cpu":
        return flash_prefill_paged_ref(q, k_pages, v_pages, block_tables,
                                       q_start, kv_lens, out_dtype=out_dtype)
    return _k.launch(q, k_pages, v_pages, block_tables, q_start,
                     kv_lens).to(out_dtype)


def flash_prefill_paged_codes(q_codes, k_pages, v_pages, q_lut, k_lut, v_lut,
                              out_qmeta, block_tables, q_start,
                              kv_lens) -> torch.Tensor:
    """Codes mode, uint8 in and out: ``q_codes`` [B, S, n_kv, g, hd]
    (attn_q codes under ``q_lut`` [256]); pages uint8 codes decoded
    through the per-head ``k_lut``/``v_lut`` [n_kv, 256]; the context is
    encoded under ``out_qmeta`` (the attn_out site) before it leaves.
    Same paging and masking contract as :func:`flash_prefill_paged`."""
    b = q_codes.shape[0]
    max_tokens = block_tables.shape[1] * k_pages.shape[1]
    q_start = row_ints(q_start, b, q_codes.device)
    kv_lens = row_ints(kv_lens, b, q_codes.device, max_tokens)
    if q_codes.device.type == "cpu":
        return flash_prefill_paged_codes_ref(
            q_codes, k_pages, v_pages, q_lut, k_lut, v_lut, out_qmeta,
            block_tables, q_start, kv_lens)
    return _k.launch_codes(q_codes, k_pages, v_pages, q_lut, k_lut, v_lut,
                           out_qmeta, block_tables, q_start, kv_lens)
