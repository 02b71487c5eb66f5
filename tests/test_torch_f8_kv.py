"""float8_e4m3fn KV pages and caches: the port against the JAX package, on
the CPU, at tiny sizes.

- The write cast (``cache_cast``) gives the reference's ``astype``
  bytes, NaN where it gives NaN (torch's own cast saturates there).
- The paged decode and prefill plain versions on f8 pages match the
  reference's oracle and its interpret-mode kernels (float32 rtol/atol
  1e-5, as ``test_torch_paged_attention.py``: the same recurrence on the
  same upcast values).
- The Engine's greedy streams with ``kv_dtype="float8_e4m3fn"`` equal the
  reference Engine's on olmo-1b tiny (the config of the reference's own
  f8 test) and qwen3-1.7b tiny, prefix cache off on both sides, and so
  does its attention bytes counter (a byte an f8 element); on olmo-1b
  the pages after one prefill chunk are byte-equal and its logits within
  2e-5 of their scale.
- The contiguous path (``prefill``/``decode_step``, what
  ``generate_bucketed`` runs) on an f8 cache, olmo-1b: logits within
  2e-5 of the reference's server steps' scale, caches byte-equal, the dense
  decode branch within 2e-5 of the kernel branch, as the reference's.
- The port's own f8 streams do not depend on the prefill chunk size.
Every float computes in float32, so the tolerances are the float paths'.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_gqa import ops as jdec
from repro.kernels.flash_prefill import ops as jpre
from repro.models import api as jax_api
from repro.runtime.engine import Request as JaxRequest
from repro.runtime.paged_cache import PagedKVCache as JaxCache
from repro.runtime.server import InferenceServer as JaxServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import lama_layers as ll
from repro_torch.kernels.decode_gqa import decode_gqa_paged
from repro_torch.kernels.flash_prefill import flash_prefill_paged
from repro_torch.models import api as torch_api
from repro_torch.models.transformer import cache_cast
from repro_torch.runtime.engine import Engine, EngineConfig, Request
from repro_torch.runtime.paged_cache import PagedKVCache as TorchCache
from repro_torch.runtime.server import InferenceServer

F8 = torch.float8_e4m3fn
JF8 = jnp.float8_e4m3fn
RTOL = ATOL = 1e-5
LOGITS_TOL = 2e-5
ARCHS = ("olmo-1b", "qwen3-1.7b")


def _bytes(a) -> np.ndarray:
    """The bytes of an f8 array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


# ------------------------------------------------------- write cast --

def _sweep() -> np.ndarray:
    """Seeded values over e4m3's range and past it, its subnormals, the
    rounding edges at 448 and 464, +-inf and NaN of both signs."""
    r = np.random.default_rng(0)
    edges = np.array([448, 455.9, 456, 463.9, 463.99997, 464, 464.0001, 479,
                      480, 1e6, np.inf, np.nan, 0.0, 2.0 ** -10,
                      3 * 2.0 ** -11, 2.0 ** -6, 240, 232], np.float32)
    return np.concatenate([r.normal(size=50000) * 100,
                           r.normal(size=5000) * 1e-2,
                           r.uniform(400, 520, 5000), edges, -edges,
                           ]).astype(np.float32)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_write_cast_bytes_equal_the_reference(src):
    x = jnp.asarray(_sweep()).astype(src)
    want = _bytes(x.astype(JF8))
    got = _bytes(cache_cast(tensor_from_numpy(np.asarray(x)), F8))
    np.testing.assert_array_equal(got, want)
    # where the two frameworks' own casts part: NaN here, +-448 there
    raw = _bytes(tensor_from_numpy(np.asarray(x)).to(F8))
    assert np.any(raw != want) and np.all((want[raw != want] & 0x7F) == 0x7F)


def test_convert_carries_f8_arrays_byte_for_byte():
    a = jnp.asarray(_sweep()).astype(JF8)
    t = tensor_from_numpy(np.asarray(a))
    assert t.dtype == F8
    np.testing.assert_array_equal(_bytes(t), _bytes(a))


# ------------------------------------------------- plain versions --

B, NKV, G, HD, BS, MAX_BLK = 3, 2, 2, 8, 4, 6


def _f8_pages(seed):
    """f8 pages (N(0, 4) values: coarse steps, some near 448) and a
    scrambled table, the same bytes on both sides."""
    r = np.random.default_rng(seed)
    n = 1 + B * MAX_BLK
    jk, jv = (jnp.asarray(r.normal(size=(n, BS, NKV, HD)) * 4).astype(JF8)
              for _ in range(2))
    bt = r.permutation(np.arange(1, n))[: B * MAX_BLK].reshape(B, MAX_BLK)
    bt = bt.astype(np.int32)
    return ((jk, jv, jnp.asarray(bt)),
            (tensor_from_numpy(np.asarray(jk)),
             tensor_from_numpy(np.asarray(jv)), torch.from_numpy(bt)))


def test_paged_decode_on_f8_pages_matches_the_reference():
    (jk, jv, jbt), (tk, tv, tbt) = _f8_pages(1)
    q = np.random.default_rng(2).normal(size=(B, NKV, G, HD)).astype(np.float32)
    lengths = np.asarray([3, 0, 21], np.int32)
    args = (jnp.asarray(q), jk, jv, jbt, jnp.asarray(lengths))
    oracle = np.asarray(jdec.decode_gqa_paged(*args))
    kernel = np.asarray(jdec.decode_gqa_paged(*args, interpret=True))
    out = decode_gqa_paged(torch.from_numpy(q), tk, tv, tbt,
                           torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), kernel, rtol=RTOL, atol=ATOL)
    assert np.all(out.numpy()[1] == 0)


def test_paged_prefill_on_f8_pages_matches_the_reference():
    (jk, jv, jbt), (tk, tv, tbt) = _f8_pages(3)
    s = 5
    q = np.random.default_rng(s).normal(size=(B, s, NKV, G, HD))
    q = q.astype(np.float32)
    qs = np.asarray([0, 7, 3], np.int32)
    kv_lens = np.asarray([5, 10, 0], np.int32)
    args = (jnp.asarray(q), jk, jv, jbt, jnp.asarray(qs),
            jnp.asarray(kv_lens))
    oracle = np.asarray(jpre.flash_prefill_paged(*args))
    kernel = np.asarray(jpre.flash_prefill_paged(*args, interpret=True))
    out = flash_prefill_paged(torch.from_numpy(q), tk, tv, tbt,
                              torch.from_numpy(qs), torch.from_numpy(kv_lens))
    np.testing.assert_allclose(out.numpy(), oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), kernel, rtol=RTOL, atol=ATOL)
    assert np.all(out.numpy()[2] == 0)


# ------------------------------------------------------------ models --

def _cfgs(name):
    return (jax_get_config(name, tiny=True).replace(compute_dtype="float32"),
            get_config(name, tiny=True).replace(compute_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _params(name):
    """The reference's weights (seed 0) and the port's copy of them."""
    jcfg, cfg = _cfgs(name)
    params = jax_api.get_model(jcfg).init(jax.random.PRNGKey(0),
                                          dtype=jnp.float32)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    return params, model


def _close(a, ref, tol=LOGITS_TOL):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(a), ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("name", ARCHS[:1])
def test_prefill_writes_the_reference_f8_pages(name):
    """One chunk of two prompts (13 and 30 tokens) into f8 pages, then a
    decode step: byte-equal pages after the chunk, logits within 2e-5 of
    their scale at both."""
    jcfg, cfg = _cfgs(name)
    params, model = _params(name)
    japi, tapi = jax_api.get_model(jcfg), torch_api.get_model(cfg)
    kw = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, num_slots=2, block_size=8,
              num_blocks=12, max_blocks_per_seq=5)
    jc, tc = JaxCache(**kw, dtype=JF8), TorchCache(**kw, dtype=F8,
                                                   device="cpu")
    r = np.random.default_rng(4)
    toks = np.zeros((2, 32), np.int32)
    for i, n in enumerate((13, 30)):
        toks[i, :n] = r.integers(0, cfg.vocab_size, n)
        for c in (jc, tc):
            c.allocator.reserve(-(-(n + 1) // 8))
            c.bind_slot(i, n)
    jl, jv = japi.prefill_into_cache(params, jnp.asarray(toks), jc.view(),
                                     jcfg)
    tl, _ = tapi.prefill_into_cache(model, torch.from_numpy(toks), tc.view(),
                                    cfg)
    assert tc.k_pages.dtype == F8
    # every page but the trash page 0, where both sides scatter the
    # chunk's padding, many writes to one place in no set order
    for t, j in ((tc.k_pages, jv.k_pages), (tc.v_pages, jv.v_pages)):
        np.testing.assert_array_equal(_bytes(t)[:, 1:], _bytes(j)[:, 1:])
    _close(tl.numpy(), jl)
    jc.k_pages, jc.v_pages = jv.k_pages, jv.v_pages
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    active = np.array([True, True])
    jl, _ = japi.decode_step_paged(params, jc.view(), jnp.asarray(nxt),
                                   jnp.asarray(active), jcfg)
    tl, _ = tapi.decode_step_paged(model, tc.view(), torch.from_numpy(nxt),
                                   torch.from_numpy(active), cfg)
    _close(tl.numpy(), jl)


def _requests(cfg, cls):
    lens, news = (8, 20, 13, 35), (6, 4, 8, 5)
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("name", ARCHS)
def test_engine_streams_equal_the_reference_f8_streams(name):
    jcfg, cfg = _cfgs(name)
    params, model = _params(name)
    kw = dict(kv_dtype="float8_e4m3fn", num_slots=3, block_size=8,
              max_len=64)
    jsrv = JaxServer(jcfg, params=params, prefix_cache=False, **kw)
    ref = jsrv.generate(_requests(jcfg, JaxRequest))
    srv = InferenceServer(cfg, params=model, device="cpu", **kw)
    out = srv.generate(_requests(cfg, Request))
    assert srv.last_engine.cache.k_pages.dtype == F8
    for a, b in zip(ref, out):
        assert b.status == "ok"
        np.testing.assert_array_equal(b.tokens, a.tokens)
    # the attention traffic counter reads the pages at a byte an element
    assert (srv.last_engine.attn_bytes_read
            == jsrv.last_engine.attn_bytes_read > 0)


def test_f8_streams_do_not_depend_on_the_chunk_size():
    _, cfg = _cfgs("olmo-1b")
    _, model = _params("olmo-1b")
    outs = []
    for chunk in (256, 8, 3):
        eng = Engine(cfg, params=model, device="cpu",
                     kv_dtype="float8_e4m3fn", engine=EngineConfig(
                         num_slots=3, block_size=8, max_seq_len=64,
                         prefill_chunk=chunk))
        outs.append(eng.generate(_requests(cfg, Request)))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("name", ARCHS[:1])
def test_contiguous_f8_cache_matches_the_reference_server(name):
    """The reference's own f8 test, held to its f8 outputs: its server's
    jitted ``_prefill``/``_decode`` on an f8 cache against the port's
    ``prefill``/``decode_step`` (flash and dense branches)."""
    jcfg, cfg = _cfgs(name)
    params, model = _params(name)
    jsrv = JaxServer(jcfg, params=params, max_len=40,
                     kv_dtype="float8_e4m3fn")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8))
    toks = toks.astype(np.int32)
    jl, jc = jsrv._prefill(params, jnp.asarray(toks), None)
    ja, _ = jsrv._decode(params, jc, jnp.asarray(toks[:, :1]))
    api = torch_api.get_model(cfg)
    tl, tc = api.prefill(model, torch.from_numpy(toks), cfg, 40,
                         cache_dtype=F8)
    assert tc["k"].dtype == F8
    np.testing.assert_array_equal(_bytes(tc["k"]), _bytes(jc["k"]))
    np.testing.assert_array_equal(_bytes(tc["v"]), _bytes(jc["v"]))
    _close(tl.numpy(), jl)
    first = torch.from_numpy(toks[:, :1])
    ta, tc2 = api.decode_step(model, dict(tc), first, cfg)
    _close(ta.numpy(), ja)
    assert tc2["k"][:, :, 8].view(torch.uint8).any()    # the step's write
    with ll.policy(flash_decode=False):
        tb, _ = api.decode_step(model, dict(tc), first, cfg)
    _close(tb.numpy(), ta.numpy())
