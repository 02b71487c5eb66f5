"""The port's paged model entry points against the JAX package's, on the
CPU, at the tiny qwen3-1.7b size.

The JAX params (float, or quantized to 7-bit codes by the reference) are
converted with ``params_from_jax``, so both sides compute with the same
bytes.  ``prefill_into_cache`` and ``decode_step_paged`` must match the
reference in logits and in page contents for cold, offset and odd-size
chunks (the scenarios of ``test_flash_prefill.TestUnifiedPrefill``,
held here against the reference's *outputs*).  Tolerance: rtol/atol
2e-5 in float32 -- the two sides differ only in summation order (and the
reference's quantized matmuls run its interpret-mode kernel).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core import lama_layers as jll
from repro.models import api as jax_api
from repro.runtime.paged_cache import PagedKVCache as JaxCache
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api as torch_api
from repro_torch.runtime.paged_cache import PagedKVCache as TorchCache

TOL = dict(rtol=2e-5, atol=2e-5)
TINY = dict(num_layers=2, d_model=64, d_ff=128, compute_dtype="float32")
BS = 4


@functools.lru_cache(maxsize=None)
def _setup(quant: bool):
    jcfg = jax_get_config("qwen3-1.7b", tiny=True).replace(**TINY)
    cfg = get_config("qwen3-1.7b", tiny=True).replace(**TINY)
    japi = jax_api.get_model(jcfg)
    params = japi.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant:
        params, _ = jll.quantize_tree(params, 7, axes=japi.logical_axes())
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    jprefill = jax.jit(japi.prefill_into_cache, static_argnums=(3,))
    jdecode = jax.jit(japi.decode_step_paged, static_argnums=(4,))
    return jcfg, cfg, japi, params, model, jprefill, jdecode


def _caches(jcfg, cfg, plen):
    kw = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, num_slots=1, block_size=BS,
              num_blocks=16, max_blocks_per_seq=6)
    jc, tc = JaxCache(**kw), TorchCache(**kw, device="cpu")
    for c in (jc, tc):
        c.allocator.reserve(6)
        c.bind_slot(0, plen)
    return jc, tc


def _prompt(cfg, plen):
    return np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             plen).astype(np.int32)


def _compare(jlogits, tlogits, jview, tview):
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    # every page but the trash page, which only padding writes
    np.testing.assert_allclose(tview.k_pages.numpy()[:, 1:],
                               np.asarray(jview.k_pages)[:, 1:], **TOL)
    np.testing.assert_allclose(tview.v_pages.numpy()[:, 1:],
                               np.asarray(jview.v_pages)[:, 1:], **TOL)


def _run_chunks(setup, prompt, chunk, start0, jview, tview):
    jcfg, cfg, _, params, model, jprefill, _ = setup
    tapi = torch_api.get_model(cfg)
    plen = len(prompt)
    for c0 in range(start0, plen, chunk):
        sl = np.zeros((1, chunk), np.int32)
        take = min(chunk, plen - c0)
        sl[0, :take] = prompt[c0:c0 + take]
        start = np.asarray([c0], np.int32)
        jlogits, jview = jprefill(params, jnp.asarray(sl), jview, jcfg,
                                  jnp.asarray(start))
        tlogits, tview = tapi.prefill_into_cache(
            model, torch.from_numpy(sl), tview, cfg, torch.from_numpy(start))
    return jlogits, tlogits, jview, tview


@pytest.mark.parametrize("quant", [False, True])
def test_cold_single_call(quant):
    """The whole prompt in one padded call (padding to the trash page)."""
    setup = _setup(quant)
    jcfg, cfg = setup[:2]
    prompt = _prompt(cfg, 11)
    jc, tc = _caches(jcfg, cfg, len(prompt))
    chunk = -(-len(prompt) // BS) * BS + BS
    _compare(*_run_chunks(setup, prompt, chunk, 0, jc.view(), tc.view()))


@pytest.mark.parametrize("chunk", [4, 8, 5])   # 1 page, 2 pages, odd
def test_cold_chunked(chunk):
    setup = _setup(False)
    jcfg, cfg = setup[:2]
    prompt = _prompt(cfg, 11)
    jc, tc = _caches(jcfg, cfg, len(prompt))
    _compare(*_run_chunks(setup, prompt, chunk, 0, jc.view(), tc.view()))


@pytest.mark.parametrize("chunk", [4, 8, 5])
def test_prefix_offset_chunked(chunk):
    """Tail prefill over pre-populated prefix pages: RoPE offsets and
    attention over the cached prefix straight from the pages."""
    setup = _setup(False)
    jcfg, cfg = setup[:2]
    prompt = _prompt(cfg, 19)
    jc, tc = _caches(jcfg, cfg, len(prompt))
    _, _, jview, tview = _run_chunks(setup, prompt, 24, 0, jc.view(),
                                     tc.view())
    # keep the first two pages (positions 0..7), recompute the rest
    jw, tw = _caches(jcfg, cfg, len(prompt))
    src = np.asarray(jview.block_tables[0, :2])
    dst = jw.block_tables[0, :2]
    jw.k_pages = jw.k_pages.at[:, dst].set(jview.k_pages[:, src])
    jw.v_pages = jw.v_pages.at[:, dst].set(jview.v_pages[:, src])
    tw.k_pages[:, torch.from_numpy(tw.block_tables[0, :2]).long()] = \
        torch.from_numpy(np.array(jview.k_pages[:, src]))
    tw.v_pages[:, torch.from_numpy(tw.block_tables[0, :2]).long()] = \
        torch.from_numpy(np.array(jview.v_pages[:, src]))
    _compare(*_run_chunks(setup, prompt, chunk, 8, jw.view(), tw.view()))


@pytest.mark.parametrize("quant", [False, True])
def test_decode_steps_after_prefill(quant):
    """Three decode steps across a page boundary, fed the reference's
    greedy tokens, plus an inactive row that must write only the trash
    page and leave its length alone."""
    setup = _setup(quant)
    jcfg, cfg, _, params, model, jprefill, jdecode = setup
    tapi = torch_api.get_model(cfg)
    kw = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, num_slots=2, block_size=BS,
              num_blocks=16, max_blocks_per_seq=6)
    jc, tc = JaxCache(**kw), TorchCache(**kw, device="cpu")
    prompt = _prompt(cfg, 10)
    for c in (jc, tc):
        c.allocator.reserve(4)
        c.bind_slot(0, len(prompt))
    toks = np.zeros((2, 12), np.int32)
    toks[0, :10] = prompt
    jlogits, jview = jprefill(params, jnp.asarray(toks), jc.view(), jcfg, None)
    tlogits, tview = tapi.prefill_into_cache(model, torch.from_numpy(toks),
                                             tc.view(), cfg)
    np.testing.assert_allclose(tlogits.numpy()[0], np.asarray(jlogits)[0], **TOL)
    # the reference returns new page arrays; the port wrote in place
    jc.k_pages, jc.v_pages = jview.k_pages, jview.v_pages
    nxt = int(np.argmax(np.asarray(jlogits)[0, -1]))
    active = np.asarray([True, False])
    for _ in range(3):
        for c in (jc, tc):
            c.ensure_capacity(0, reserved=False)
        tokens = np.asarray([[nxt], [0]], np.int32)
        jlogits, jview = jdecode(params, jc.view(), jnp.asarray(tokens),
                                 jnp.asarray(active), jcfg)
        tlogits, tview = tapi.decode_step_paged(
            model, tc.view(), torch.from_numpy(tokens),
            torch.from_numpy(active), cfg)
        jc.k_pages, jc.v_pages = jview.k_pages, jview.v_pages
        jc.lengths[:] = np.asarray(jview.lengths)
        tc.lengths[:] = tview.lengths.numpy()
        np.testing.assert_array_equal(tc.lengths, jc.lengths)
        _compare(jlogits[:1], tlogits[:1], jview, tview)
        nxt = int(np.argmax(np.asarray(jlogits)[0, -1]))
    assert tc.lengths.tolist() == [13, 0]
