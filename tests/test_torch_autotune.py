"""The LUT GEMMs' plan autotuner (``kernels/lut_dequant_matmul/ops.py``),
the counterpart of the reference's tile autotuner
(``tests/test_fused_path.py::TestAutotuner``), on the CPU with an
injected bench and comparison: the persistent cache, validation before
anything is kept, the 3% margin, the candidates' legality (never a
chain over ``MAX_K_CHAIN`` rows, never a cluster over ``MAX_CLUSTER``),
peek-only under a CUDA graph capture, off on the CPU, the key's fields
and the cache file of its own.  The card cases are in
``tests/test_torch_cuda.py``.
"""

import importlib
import json
import os
from unittest import mock

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.lut_dequant_matmul import ops as jops
from repro_torch.kernels.lut_dequant_matmul import ops

# the launch module (the package's ``lut_dequant_matmul`` is the wrapper)
lk = importlib.import_module(
    "repro_torch.kernels.lut_dequant_matmul.lut_dequant_matmul")

KEY = "NVIDIA H100 80GB HBM3|132|plain|256|2048|2048|gather|bfloat16|None|0|0"
CANDS = [(8, 256), (1, 2048), (2, 1024), (4, 512)]


def bench_of(times, calls=None):
    """A bench giving each plan its time (seconds) and an output that
    names the plan; a plan absent from ``times`` raises."""
    def bench(plan):
        if calls is not None:
            calls.append(plan)
        if plan not in times:
            raise RuntimeError(f"no launch for {plan}")
        return times[plan], plan
    return bench


def agree_all(out, ref):
    return True


def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "tune.json")
    calls = []
    tuner = ops.Autotuner(path)
    times = {(8, 256): 2.0, (1, 2048): 3.0, (2, 1024): 1.0, (4, 512): 1.5}
    assert tuner.get(KEY, CANDS, bench_of(times, calls), agree_all) == (2, 1024)
    assert calls == CANDS
    blob = json.load(open(path))
    assert blob["version"] == ops.TUNE_VERSION
    assert blob["entries"] == {KEY: {"plan": [2, 1024], "us": 1e6}}
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    # memory: no second tuning
    assert tuner.get(KEY, CANDS, bench_of({}, calls), agree_all) == (2, 1024)
    assert len(calls) == len(CANDS)
    # a second tuner on the same file reads the plan back, timing nothing
    again = ops.Autotuner(path)
    assert again.peek(KEY) == (2, 1024)
    assert again.get(KEY, CANDS, bench_of({}, calls), agree_all) == (2, 1024)
    assert len(calls) == len(CANDS)
    # entries of other keys are kept when one is added
    again.get("other", CANDS, bench_of(times), agree_all)
    assert set(json.load(open(path))["entries"]) == {KEY, "other"}


def test_a_version_mismatch_is_ignored(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({"version": ops.TUNE_VERSION + 1, "entries": {
        KEY: {"plan": [4, 512], "us": 1.0}}}))
    tuner = ops.Autotuner(str(path))
    assert tuner.peek(KEY) is None
    times = {(8, 256): 1.0, (1, 2048): 2.0, (2, 1024): 2.0, (4, 512): 2.0}
    assert tuner.get(KEY, CANDS, bench_of(times), agree_all) == (8, 256)
    assert json.load(open(path)) == {"version": ops.TUNE_VERSION, "entries": {
        KEY: {"plan": [8, 256], "us": 1e6}}}
    path.write_text("{not json")
    assert ops.Autotuner(str(path)).peek(KEY) is None


def test_all_benches_failing_does_not_poison_the_cache(tmp_path, capsys):
    path = str(tmp_path / "tune.json")
    tuner = ops.Autotuner(path)
    assert tuner.get(KEY, CANDS, bench_of({}), agree_all) == CANDS[0]
    assert not os.path.exists(path)
    assert tuner.fallbacks == 1 and tuner.peek(KEY) is None
    assert "no candidate validated" in capsys.readouterr().err
    # a shape plan that fails leaves nothing to hold the others to
    times = {(1, 2048): 1.0, (2, 1024): 1.0, (4, 512): 1.0}
    assert tuner.get(KEY, CANDS, bench_of(times), agree_all) == CANDS[0]
    assert not os.path.exists(path) and tuner.fallbacks == 2
    # a later working bench still tunes: nothing was kept
    times[(8, 256)] = 2.0
    assert tuner.get(KEY, CANDS, bench_of(times), agree_all) == (1, 2048)
    assert os.path.exists(path)


def test_a_candidate_that_misses_validation_is_never_kept(tmp_path):
    """The fastest candidate disagrees with the shape plan's output: it
    is dropped, the next fastest that agrees is kept; a candidate that
    raises is dropped too."""
    path = str(tmp_path / "tune.json")
    tuner = ops.Autotuner(path)
    times = {(8, 256): 2.0, (1, 2048): 0.5, (2, 1024): 1.0}   # (4, 512) raises
    agree = lambda out, ref: out != (1, 2048)       # noqa: E731
    assert tuner.get(KEY, CANDS, bench_of(times), agree) == (2, 1024)
    assert tuner.dropped == 2
    entries = json.load(open(path))["entries"]
    assert [e["plan"] for e in entries.values()] == [[2, 1024]]
    # every candidate disagreeing keeps the shape plan itself
    tuner2 = ops.Autotuner(str(tmp_path / "t2.json"))
    assert tuner2.get(KEY, CANDS, bench_of(times),
                      lambda out, ref: False) == (8, 256)


@pytest.mark.parametrize("t_best,want", [(0.98, (8, 256)), (0.96, (2, 1024))])
def test_a_plan_must_beat_the_shape_plan_by_the_margin(tmp_path, t_best,
                                                       want):
    tuner = ops.Autotuner(str(tmp_path / "tune.json"))
    times = {(8, 256): 1.0, (1, 2048): 1.5, (2, 1024): t_best, (4, 512): 1.2}
    assert tuner.get(KEY, CANDS, bench_of(times), agree_all) == want


def test_the_bench_compares_outputs_with_the_shape_plans():
    """``agree`` gets each candidate's output and candidate 0's."""
    seen = []
    tuner = ops.Autotuner("/nonexistent-dir/never-written.json")
    with mock.patch.object(ops.Autotuner, "_save_disk"):
        tuner.get(KEY, CANDS, bench_of(dict.fromkeys(CANDS, 1.0)),
                  lambda out, ref: seen.append((out, ref)) or True)
    assert seen == [(c, CANDS[0]) for c in CANDS[1:]]


SHAPES = dict(m=st.integers(1, 4096), k=st.integers(1, 40000),
              n=st.integers(1, 160000), sms=st.sampled_from([66, 114, 132]),
              nw=st.sampled_from([1, 2]), transposed=st.booleans())


@settings(max_examples=300, deadline=None)
@given(**SHAPES)
def test_candidates_are_legal_plans(m, k, n, sms, nw, transposed):
    """The shape plan first, no duplicates, and every candidate a plan
    the bodies run for every M of its bucket: whole 32-row stages
    covering K, at most MAX_CLUSTER blocks a cluster at M <= 8, no chain
    over MAX_K_CHAIN rows at M > 8."""
    if transposed:
        nw = 1
    cands = lk.candidate_plans(m, k, n, sms, nw, transposed)
    assert cands[0] == lk.gemm_plan(m, k, n, sms, nw, transposed)
    assert len(set(cands)) == len(cands)
    low, high = (1, 8) if m <= 8 else (9, ops.m_bucket(m))
    for splits, kps in cands:
        for mm in {low, m, high}:
            assert lk.check_plan(mm, k, (splits, kps), transposed) == (
                splits, kps)
        if m <= 8:
            assert splits <= lk.MAX_CLUSTER
            assert not transposed or splits == 1
        else:
            assert kps <= lk.MAX_K_CHAIN and kps % lk.K_STEP == 0
        assert (splits - 1) * kps < k <= splits * kps


@pytest.mark.parametrize("m,k,plan,transposed,match", [
    (8, 4096, (16, 256), False, "cluster"),
    (4, 2048, (2, 1024), True, "unsplit"),
    (4, 2048, (1, 1024), True, "unsplit"),
    (256, 2048, (2, 1000), False, "multiple of 32"),
    (256, 8192, (1, 8192), False, "MAX_K_CHAIN"),
    (9, 32768, (4, 8192), False, "MAX_K_CHAIN"),
    (256, 2048, (1, 1024), False, "cover K"),
    (256, 2048, (4, 1024), False, "cover K"),
    (8, 2048, (0, 2048), False, ">= 1"),
])
def test_check_plan_refuses_what_the_bodies_cannot_run(m, k, plan, transposed,
                                                       match):
    with pytest.raises(ValueError, match=match):
        lk.check_plan(m, k, plan, transposed)


def test_decode_candidates_are_the_cluster_sizes():
    assert lk.candidate_plans(8, 2048, 2048, 132, 1) == [
        (8, 256), (1, 2048), (2, 1024), (4, 512)]
    assert lk.candidate_plans(4, 2048, 151936, 132, 1, transposed=True) == [
        (1, 2048)]
    # M > 8: from ceil(K / MAX_K_CHAIN) splits, doubling within a wave
    assert lk.candidate_plans(256, 2048, 2048, 132, 1) == [
        (8, 256), (1, 2048), (2, 1024), (4, 512)]
    assert lk.candidate_plans(640, 32768, 6144, 132, 1) == [(8, 4096)]


def _plan_for(tuner, x, capturing, run, autotune=True):
    """``ops._plan_for`` on CPU tensors standing for a card's."""
    with mock.patch.object(ops, "_device_name", lambda index: "H100"), \
            mock.patch.object(lk, "num_sms", lambda dev: 132), \
            mock.patch.object(ops, "_TUNER", tuner), \
            mock.patch.object(torch.cuda, "is_current_stream_capturing",
                              lambda: capturing), \
            mock.patch.object(ops, "_bench", lambda run, plan: run(plan)):
        return ops._plan_for("plain", x, x.shape[0], x.shape[1], 2048, 1,
                             False, "gather", "None|0|0", autotune, run,
                             agree_all)


def test_under_a_capture_the_tuner_only_peeks(tmp_path):
    """Under a (mocked) capture: no bench, no write; a miss takes the
    shape plan, a kept plan is returned."""
    path = str(tmp_path / "tune.json")
    tuner = ops.Autotuner(path)
    x = torch.empty(256, 2048)
    calls = []

    def run(plan):
        calls.append(plan)
        return {(8, 256): 2.0, (2, 1024): 1.0}.get(plan, 3.0), plan

    assert _plan_for(tuner, x, True, run) == (8, 256)
    assert not calls and not os.path.exists(path) and tuner.seconds == 0
    # the eager call tunes and keeps; the capture then finds its plan
    assert _plan_for(tuner, x, False, run) == (2, 1024)
    n = len(calls)
    assert n == 4 and os.path.exists(path)
    assert _plan_for(tuner, torch.empty(200, 2048), True, run) == (2, 1024)
    assert len(calls) == n
    # and so does a capture in a fresh process (disk)
    assert _plan_for(ops.Autotuner(path), x, True, run) == (2, 1024)
    assert len(calls) == n


def test_off_on_the_cpu(tmp_path):
    """CPU operands never reach the tuner, whatever ``autotune`` says;
    on the card only ``autotune=True`` tunes: ``None`` (the default) and
    ``False`` launch the shape plan without timing, reading or writing."""
    path = str(tmp_path / "tune.json")
    tuner = ops.Autotuner(path)
    calls = []

    def run(plan):
        calls.append(plan)
        return {(8, 256): 2.0, (2, 1024): 1.0}.get(plan, 3.0), plan

    x = torch.empty(256, 2048)
    for autotune in (None, False):
        assert _plan_for(tuner, x, False, run, autotune) == (8, 256)
    assert not calls and not os.path.exists(path) and tuner.seconds == 0
    assert _plan_for(tuner, x, False, run) == (2, 1024)
    for autotune in (None, False):          # a kept plan does not count
        assert _plan_for(tuner, x, False, run, autotune) == (8, 256)

    def refuse(*a, **k):
        raise AssertionError("the tuner ran on the CPU")

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, generator=g)
    xc = torch.randint(0, 256, (4, 32), dtype=torch.uint8, generator=g)
    c = torch.randint(0, 256, (32, 16), dtype=torch.uint8, generator=g)
    lut = torch.randn(256, generator=g)
    with mock.patch.multiple(ops, _plan_for=refuse, _bench=refuse):
        for autotune in (None, True):
            ops.lut_dequant_matmul(x, c, lut, autotune=autotune)
            ops.lut_dequant_matmul_gated(x, c, c, lut, lut, autotune=autotune)
            ops.lut_dequant_matmul_dual(xc, c, lut, lut, autotune=autotune)
            ops.lut_dequant_matmul_dual_gated(xc, c, c, lut, lut, lut,
                                              autotune=autotune)


def test_keys_name_device_sms_kind_bucket_and_representation():
    base = dict(device="NVIDIA H100 80GB HBM3", sms=132, kind="dual", m=256,
                k=2048, n=2048, decode_mode="gather", rep="u8code",
                extra="None|0|1")
    key = ops.tune_key(**base)
    assert key == ("NVIDIA H100 80GB HBM3|132|dual|256|2048|2048|gather|"
                   "u8code|None|0|1")
    for field, other in (("device", "NVIDIA H100 PCIe"), ("sms", 114),
                         ("kind", "dual_gated"), ("m", 257), ("k", 1024),
                         ("n", 1024), ("decode_mode", "alu"),
                         ("rep", "bfloat16"), ("extra", "None|0|0")):
        assert ops.tune_key(**{**base, field: other}) != key
    assert ops.tune_key(**{**base, "m": 129}) == key        # same bucket
    assert [ops.m_bucket(m) for m in (1, 8, 9, 16, 17, 2048, 2049)] == [
        8, 8, 16, 16, 32, 2048, 4096]
    assert [ops.xrep(d) for d in (torch.float32, torch.bfloat16,
                                  torch.uint8)] == [
        "float32", "bfloat16", ops.ACT_CODE_REP]
    assert ops.ACT_CODE_REP == jops.ACT_CODE_REP
    assert ops.key_extra("plain", transposed=True) != ops.key_extra("plain")
    assert ops.key_extra("dual_gated", out_quant=True) != ops.key_extra(
        "dual_gated")


def test_the_cache_file_is_not_the_references(monkeypatch, tmp_path):
    monkeypatch.delenv(ops.CACHE_ENV, raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    assert ops.CACHE_ENV != "REPRO_AUTOTUNE_CACHE"
    assert ops.Autotuner().path != jops.Autotuner().path
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert ops.Autotuner().path != jops.Autotuner().path
    assert ops.Autotuner().path.endswith(
        os.path.join("repro_torch", "lut_dequant_matmul_tune.json"))
    monkeypatch.setenv(ops.CACHE_ENV, str(tmp_path / "port.json"))
    assert ops.Autotuner().path == str(tmp_path / "port.json")
