"""One dispatch a tick, on the CPU: the step runner
(``runtime/step_graph.py``) the engine and the bucketed server run every
step through, at the tiny qwen3-1.7b size.

On the CPU a :class:`StepGraph` runs its step eagerly on the same packed
buffers a capture would read, so these tests cover the packing, the
unpacking and the outputs: the engine's token streams against the JAX
package's engine (float pages, bfloat16 pages, activations and pages as
codes under tables the port fits and hands to both), the contiguous ``decode_step`` with
the position as a 0-d tensor (what the bucketed server's captured step
reads) against the int form and the reference's ``decode_step``, the
launch accounting of captures and replays driven by hand, and the decode
keys an engine makes.  The captured replays themselves run on the card
(``tests/test_torch_cuda.py``).

Tolerances: token streams and the int/tensor forms of the port's own
``decode_step`` are equal; logits within 1e-5 of their scale of the
reference's (float32 on both sides, only the summation order differs).
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
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import EngineConfig as JaxEngineConfig
from repro.runtime.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import lama_layers as ll
from repro_torch.core.exponential_quant import QWeight
from repro_torch.kernels import _build
from repro_torch.models import api as torch_api
from repro_torch.runtime.engine import Engine, EngineConfig, Request
from repro_torch.runtime.server import InferenceServer
from repro_torch.runtime.step_graph import ALIGN, StepGraph

TINY = dict(num_layers=2, d_model=64, d_ff=128, compute_dtype="float32")
# prompts and new tokens crossing several 4-token pages on 2 slots
LENS, NEWS, SLOTS, BS, MAX_LEN = (8, 13, 5), (4, 9, 3), 2, 4, 24


def _cfgs():
    return (jax_get_config("qwen3-1.7b", tiny=True).replace(**TINY),
            get_config("qwen3-1.7b", tiny=True).replace(**TINY))


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The reference's float weights (seed 0)."""
    jcfg, _ = _cfgs()
    return jax_api.get_model(jcfg).init(jax.random.PRNGKey(0),
                                        dtype=jnp.float32)


def _to_port(jparams):
    _, cfg = _cfgs()
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                           device="cpu")


def _jax_tree(node):
    """The reference's params tree holding a port tree's values (qtensor
    leaves as its ``{codes, lut, qmeta}`` dicts)."""
    if isinstance(node, QWeight):
        return {k: jnp.asarray(getattr(node, k).numpy())
                for k in ("codes", "lut", "qmeta")}
    if isinstance(node, dict):
        return {k: _jax_tree(v) for k, v in node.items()}
    return jnp.asarray(node.numpy())


def _params(codes: bool):
    """(reference params, port params) holding the same values: the
    reference's float weights, or with ``codes`` 7-bit weights and
    act-quant tables (per-head attn_k/attn_v included) fit by the port
    on its default calibration prompts."""
    if not codes:
        return _jax_params(), _to_port(_jax_params())
    _, cfg = _cfgs()
    eng = Engine(cfg, quant_bits=7, act_quant=7, device="cpu",
                 engine=EngineConfig(num_slots=SLOTS, block_size=BS,
                                     max_seq_len=MAX_LEN))
    return _jax_tree(eng.params.tree()), eng.params


def _requests(cfg, cls, lens=LENS, news=NEWS):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                max_new_tokens=int(m)) for i, (n, m) in enumerate(zip(lens, news))]


# ------------------------------------------------------------ engine --

@pytest.mark.parametrize("mode", ["float", "bf16_pages", "codes"])
def test_engine_streams_through_the_step_runner_equal_reference(
        mode, tmp_path, monkeypatch):
    """Every tick goes through a step runner's packed buffers (one host
    buffer a tick, unpacked into views on the device side); the token
    streams equal the reference engine's."""
    monkeypatch.setenv("REPRO_ACT_CALIB_CACHE", str(tmp_path / "calib.json"))
    jcfg, cfg = _cfgs()
    codes = mode == "codes"
    kv = "bfloat16" if mode == "bf16_pages" else "float32"
    jparams, params = _params(codes)
    jeng = JaxEngine(jcfg, params=jparams, kv_codes=codes,
                     kv_dtype=kv, engine=JaxEngineConfig(
                         num_slots=SLOTS, block_size=BS, max_seq_len=MAX_LEN,
                         prefix_cache=False))
    ref = jeng.generate(_requests(jcfg, JaxRequest))
    eng = Engine(cfg, params=params, kv_codes=codes,
                 kv_dtype=kv, device="cpu", engine=EngineConfig(
                     num_slots=SLOTS, block_size=BS, max_seq_len=MAX_LEN))
    assert not eng.cuda_graphs                 # no meaning on the CPU
    out = eng.generate(_requests(cfg, Request))
    assert [c.uid for c in out] == [c.uid for c in ref]
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.status == "ok"
    runners = eng.step_runners
    assert runners["decode"] and runners["prefill"]
    assert all(r.graph is None and r.replays == 0
               for d in runners.values() for r in d.values())
    assert eng.graph_captures() == (0, 0.0)


def test_decode_keys_follow_the_live_column_ladder(monkeypatch):
    """Over a run whose lengths cross several block boundaries, the
    decode runners' keys are exactly the pow2 column widths the ticks
    reached, and the prefill keys the (chunk width, columns) pairs."""
    _, cfg = _cfgs()
    eng = Engine(cfg, device="cpu", rng_seed=1, engine=EngineConfig(
        num_slots=2, block_size=4, max_seq_len=48, prefill_chunk=8))
    reached = []
    live_cols = eng._live_cols

    def record(active):
        reached.append(live_cols(active))
        return reached[-1]
    monkeypatch.setattr(eng, "_live_cols", record)
    eng.generate(_requests(cfg, Request, lens=(3, 21), news=(40, 6)))
    assert sorted(set(reached)) == [1, 2, 4, 8, 12]   # 12: max_blocks_per_seq
    assert {k[0] for k in eng.step_runners["decode"]} == set(reached)
    assert all(k[-1] == ll.get_policy() for d in eng.step_runners.values()
               for k in d)
    widths = {k[:2] for k in eng.step_runners["prefill"]}
    assert widths == {(8, 2), (8, 4), (8, 8)}
    with ll.policy(decode_mode="alu"):            # a policy gets its own
        eng.generate(_requests(cfg, Request, lens=(3,), news=(2,)))
    assert {k[-1].decode_mode for k in eng.step_runners["decode"]} == {
        "gather", "alu"}


def test_step_runner_packs_one_host_buffer():
    """Inputs sit in one int32 buffer, each on a 16-byte boundary; a
    step sees the host values through its device views, and ``run``
    returns the output on the host."""
    seen = {}

    def fn(v):
        seen.update({k: t.clone() for k, t in v.items()})
        return torch.stack([v["tokens"][:, 0].long(),
                            (v["mask"] != 0).long()])
    run = StepGraph({"table": (3, 5), "lengths": (3,), "tokens": (3, 1),
                     "mask": (3,)}, "cpu")
    assert run._host.numel() == 16 + 4 + 4 + 4
    offsets = [t.storage_offset() for t in run.inputs.values()]
    assert offsets == [0, 16, 20, 24] and all(o % ALIGN == 0 for o in offsets)
    rng = np.random.default_rng(4)
    for _ in range(2):
        vals = {k: rng.integers(0, 99, a.shape).astype(np.int32)
                for k, a in run.host.items()}
        for k, a in vals.items():
            run.host[k][...] = a
        out = run.run(fn)
        for k, a in vals.items():
            np.testing.assert_array_equal(seen[k].numpy(), a)
        np.testing.assert_array_equal(out, [vals["tokens"][:, 0],
                                            vals["mask"] != 0])
    run.capture(fn)                         # no graph on the CPU
    assert run.graph is None and not run.graphs


# ------------------------------------------------- launch accounting --

class _FakeGraph:
    """Stands in for a captured graph: counts replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_capture_records_and_replays_add_the_record():
    """A capture's wrapper calls go to its record, not the counts; each
    replay adds the record; an eager call counts as before."""
    _build.reset_launch_counts()
    _build.count_launch("decode_gqa_paged")                 # eager
    assert _build.launch_counts() == {"decode_gqa_paged": 1}
    with _build.recording_launches() as rec:                # a capture
        for _ in range(3):
            _build.count_launch("decode_gqa_paged")
        _build.count_launch("lut_dequant_matmul")
    assert _build.launch_counts() == {"decode_gqa_paged": 1}
    assert rec == {"decode_gqa_paged": 3, "lut_dequant_matmul": 1}
    _build.count_launch("decode_gqa_paged")                 # eager again
    for _ in range(2):                                      # two replays
        _build.add_launches(rec)
    assert _build.launch_counts() == {"decode_gqa_paged": 8,
                                      "lut_dequant_matmul": 2}
    _build.reset_launch_counts()


def test_step_runner_replay_adds_its_record():
    """A runner holding a graph replays it (the step function is not
    called) and adds its capture's record per replay."""
    calls = []
    fn = lambda v: calls.append(1) or v["x"] + 1
    run = StepGraph({"x": (2,)}, "cpu")
    run.run(fn)
    assert calls == [1]
    run.graph, run.out = _FakeGraph(), torch.tensor([7, 8])
    run.launches = {"decode_gqa": 28, "lut_dequant_matmul": 141}
    _build.reset_launch_counts()
    for _ in range(3):
        np.testing.assert_array_equal(run.run(fn), [7, 8])
    assert calls == [1] and run.graph.replays == 3 and run.replays == 3
    assert _build.launch_counts() == {"decode_gqa": 84,
                                      "lut_dequant_matmul": 423}
    _build.reset_launch_counts()


# ---------------------------------------- decode_step, tensor position --

@functools.lru_cache(maxsize=None)
def _contiguous_setup():
    jcfg, cfg = _cfgs()
    return jcfg, cfg, _jax_params(), _to_port(_jax_params())


@pytest.mark.parametrize("flash_decode", [True, False])
def test_decode_step_takes_a_tensor_position(flash_decode):
    """The position as a 0-d int64 tensor: the same logits, cache and
    next position as the int form, bit for bit, and the reference's
    logits within 1e-5; the K/V land at the positions stepped."""
    jcfg, cfg, jparams, model = _contiguous_setup()
    japi, tapi = jax_api.get_model(jcfg), torch_api.get_model(cfg)
    plen, steps, max_len = 5, 3, 12
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, plen + steps)).astype(np.int32)
    _, jc = japi.prefill(jparams, jnp.asarray(toks[:, :plen]), jcfg, max_len,
                         cache_dtype=jnp.float32)
    _, c_int = tapi.prefill(model, torch.from_numpy(toks[:, :plen]), cfg,
                            max_len, cache_dtype=torch.float32)
    c_t = {"k": c_int["k"].clone(), "v": c_int["v"].clone(),
           "pos": torch.tensor(plen)}
    with jll.policy(flash_decode=flash_decode), \
            ll.policy(flash_decode=flash_decode):
        for t in range(plen, plen + steps):
            tok = toks[:, t:t + 1]
            jl, jc = japi.decode_step(jparams, jc, jnp.asarray(tok), jcfg)
            l_int, c_int = tapi.decode_step(model, c_int,
                                            torch.from_numpy(tok), cfg)
            l_t, c_t = tapi.decode_step(model, c_t, torch.from_numpy(tok), cfg)
            assert torch.equal(l_t, l_int)
            assert isinstance(c_t["pos"], torch.Tensor)
            assert int(c_t["pos"]) == c_int["pos"] == t + 1
            ref = np.asarray(jl)
            err = np.abs(l_t.numpy() - ref).max() / max(1.0, np.abs(ref).max())
            assert err <= 1e-5
    assert torch.equal(c_t["k"], c_int["k"]) and torch.equal(c_t["v"], c_int["v"])
    written = c_t["k"].abs().sum(dim=(0, 1, 3, 4))
    assert bool((written[:plen + steps] > 0).all())
    assert bool((written[plen + steps:] == 0).all())
    np.testing.assert_allclose(c_t["v"].numpy(), np.asarray(jc["v"]),
                               rtol=1e-5, atol=1e-5)


def test_bucketed_server_checks_the_cache_up_front():
    """The bucketed decode steps read their position on the device, so
    the server refuses a bucket whose steps would run past the cache."""
    _, cfg = _cfgs()
    srv = InferenceServer(cfg, max_len=16, num_slots=2, block_size=4,
                          device="cpu")
    ok = srv.generate_bucketed(_requests(cfg, Request, lens=(10,), news=(7,)))
    assert len(ok[0].tokens) == 7 and ok[0].decode_steps == 6
    assert srv.bucket_graphs == 0
    with pytest.raises(ValueError, match="cache full"):
        srv.generate_bucketed(_requests(cfg, Request, lens=(10,), news=(8,)))
