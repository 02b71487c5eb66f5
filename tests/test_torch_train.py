"""The port's training stack against the JAX package's, on the CPU: the
LR schedules, AdamW, the int8 gradient codes, the synthetic data
pipeline, the checkpoint manager (each package restoring the other's
checkpoints), the ``Trainer`` and ``launch/train.py``, and the trained
model served.

Tolerances: the schedules within 4 float32 ulps of the reference's
(both compute in float32; ``cos`` and ``pow`` are libm's here and XLA's
there); AdamW's new parameters and moments within 1e-6 of their scale
and the global norm within 1e-6 (float32, the leaves summed in the same
order, each leaf's sum in another); the int8 codes and the data
batches byte for byte.  The ``Trainer``'s losses step by step within
1e-5 of the reference Trainer's at float32 compute (measured ~1e-6 over
12 steps) and within 5e-3 at the tiny config's own bfloat16 (measured
at most 1.3e-3: Adam's normalisation carries bfloat16 rounding
differences into the next steps), from the reference's initial
parameters carried across; at float32 the trained parameters within
the larger of 1e-4 of each leaf's scale and four times the port's own
spread when the initial parameters move by one ulp (phase 18b's rule:
the batches differ from process to process, and on some draws the
12 steps carry a last-bit difference past 1e-4).
"""

import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import manager as jckpt
from repro.configs import get_config as jax_get_config
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import api as jax_api
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jsched
from repro.runtime.trainer import TrainConfig as JaxTrainConfig
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch import tree as T
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM, host_batch_slice
from repro_torch.launch import train as ttrain
from repro_torch.models import api as torch_api
from repro_torch.optim import adamw, compress, schedule
from repro_torch.runtime.server import InferenceServer, Request
from repro_torch.runtime.trainer import TrainConfig, Trainer

ARCH = "olmo-1b"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return (x.detach().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


# ---------------------------------------------------------- schedules --

@pytest.mark.parametrize("name,warmup,total", [
    ("cosine", 10, 100), ("cosine", 0, 37), ("cosine", 5, 5),
    ("wsd", 10, 100), ("wsd", 3, 7), ("wsd", 0, 1000)])
def test_schedules_match_reference(name, warmup, total):
    """Every step of the sweep (and past the end), as an int and as a
    0-d int32 tensor, float32, within 4 ulps."""
    steps = list(range(0, total + 5)) + [total * 3]
    ref = np.array([np.float32(jsched.get_schedule(name)(s, 3e-4, warmup,
                                                         total))
                    for s in steps])
    got = np.array([schedule.get_schedule(name)(s, 3e-4, warmup, total)
                    .item() for s in steps], np.float32)
    via = np.array([schedule.get_schedule(name)(
        torch.tensor(s, dtype=torch.int32), 3e-4, warmup, total).item()
        for s in steps], np.float32)
    assert schedule.get_schedule(name)(3, 3e-4, warmup, total).dtype == \
        torch.float32
    np.testing.assert_array_equal(got, via)
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    assert np.all(np.abs(got - ref) <= 4 * ulp), np.abs(got - ref) / ulp


# -------------------------------------------------------------- adamw --

def _rand_tree(seed):
    r = np.random.default_rng(seed)
    return {"w": r.normal(size=(8, 6)).astype(np.float32),
            "blk": {"b": r.normal(size=(6,)).astype(np.float32),
                    "k": r.normal(size=(2, 3, 4)).astype(np.float32)},
            "a_scale": r.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("gscale,max_norm", [(1e-2, 1.0), (10.0, 1.0),
                                             (3.0, 0.5)],
                         ids=["unclipped", "clipped", "clipped-half"])
def test_adamw_update_matches_reference(gscale, max_norm):
    """Three updates on a random tree (a 1-d leaf exempt from weight
    decay, 2-d and 3-d leaves decayed), with gradients under and over
    the clip: the new parameters, both moments, the step and the grad
    norm."""
    p0 = _rand_tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = T.tree_map(torch.from_numpy, p0)
    jo, to = jadamw.init(jp), adamw.init(tp)
    assert to.step.dtype == torch.int32 and int(to.step) == 0
    for i in range(3):
        g = T.tree_map(lambda a: (a * gscale).astype(np.float32),
                       _rand_tree(10 + i))
        lr = 1e-2 * (i + 1)
        jp, jo, jm = jadamw.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   jo, jp, lr=lr, max_grad_norm=max_norm)
        tp, to, tm = adamw.update(T.tree_map(torch.from_numpy, g), to, tp,
                                  lr=lr, max_grad_norm=max_norm)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        for part in ("params", "mu", "nu"):
            jt = jp if part == "params" else getattr(jo, part)
            tt = tp if part == "params" else getattr(to, part)
            for a, b in zip(T.leaves(tt), jax.tree_util.tree_leaves(jt)):
                b = np.asarray(b)
                assert float(np.abs(a.numpy() - b).max()) <= 1e-6 * max(
                    1.0, float(np.abs(b).max())), (i, part)
        assert int(to.step) == int(jo.step) == i + 1
    clipped = gscale * np.sqrt(sum(np.sum(np.square(x)) for x in
                                   T.leaves(_rand_tree(12)))) > max_norm
    assert clipped == (gscale > 1)


def test_adamw_exempts_vectors_from_weight_decay():
    """A zero gradient moves a matrix by ``lr * wd * p`` and leaves a
    vector where it is."""
    p = {"m": torch.ones(3, 2), "v": torch.ones(4)}
    g = T.tree_map(torch.zeros_like, p)
    new, _, _ = adamw.update(g, adamw.init(p), p, lr=0.5, weight_decay=0.1)
    assert torch.equal(new["v"], p["v"])
    torch.testing.assert_close(new["m"], torch.full((3, 2), 0.95))


def test_global_norm_and_clip_match_reference():
    g = _rand_tree(3)
    jn = jadamw.global_norm(jax.tree_util.tree_map(jnp.asarray, g))
    tn = adamw.global_norm(T.tree_map(torch.from_numpy, g))
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    jc, _ = jadamw.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), 0.3)
    tc, _ = adamw.clip_by_global_norm(T.tree_map(torch.from_numpy, g), 0.3)
    for a, b in zip(T.leaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ------------------------------------------------------- int8 codes --

@pytest.mark.parametrize("shape,scale", [((128,), 1.0), ((7, 33), 1e-3),
                                         ((64,), 0.0)])
def test_int8_codes_match_reference(shape, scale):
    """Codes byte for byte (round half to even) and the scale; the
    decode within half a step of x (``tests/test_runtime.py``'s bound)."""
    x = (np.random.default_rng(0).normal(size=shape) * scale
         ).astype(np.float32)
    x.flat[0] = 0.5 * (np.abs(x).max() / 127.0) if scale else 0.0
    jq, js = jcompress.int8_encode(jnp.asarray(x))
    tq, ts = compress.int8_encode(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert np.float32(ts.item()) == np.float32(js)
    dec = compress.int8_decode(tq, ts)
    np.testing.assert_array_equal(dec.numpy(),
                                  np.asarray(jcompress.int8_decode(jq, js)))
    assert float((dec - torch.from_numpy(x)).abs().max()) <= \
        float(ts) * 0.5 + 1e-7


# --------------------------------------------------------------- data --

def test_batches_equal_the_reference_byte_for_byte():
    """In one process (``hash(what)`` is salted per process), the port's
    stream is the reference's, step by step, whole and sliced."""
    cfg = DataConfig(vocab_size=512, global_batch=4, seq_len=32, seed=3)
    ours, ref = SyntheticLM(cfg), JaxSyntheticLM(cfg)
    assert ours.trans.tobytes() == ref.trans.tobytes()
    for step in (0, 1, 17):
        a, b = ours.batch(step), ref.batch(step)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype == np.int32
            assert a[k].tobytes() == b[k].tobytes(), (step, k)
    sl = host_batch_slice(4, 1, 2)
    assert ours.batch(5, sl)["tokens"].tobytes() == \
        ref.batch(5, sl)["tokens"].tobytes()


def test_data_restart_stable_and_partitioned():
    """``tests/test_runtime.py``'s ``TestData`` cases on the port's copy."""
    cfg = DataConfig(vocab_size=512, global_batch=8, seq_len=16, seed=3)
    p = SyntheticLM(cfg)
    np.testing.assert_array_equal(p.batch(17)["tokens"],
                                  SyntheticLM(cfg).batch(17)["tokens"])
    assert not np.array_equal(p.batch(0)["tokens"], p.batch(1)["tokens"])
    full = p.batch(5)["tokens"]
    parts = [p.batch(5, host_batch_slice(8, r, 4))["tokens"]
             for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)
    b = p.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    it = p.iterate(3)
    np.testing.assert_array_equal(next(it)["tokens"], p.batch(3)["tokens"])


# --------------------------------------------------------- checkpoints --

def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"w": torch.from_numpy(r.normal(size=(8, 4)).astype(np.float32)),
            "b": {"x": torch.arange(5, dtype=torch.int32)}}


def test_save_restore_identity(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 10, t)
    out, meta = ckpt.restore(tmp_path, t)
    assert meta["step"] == 10 and meta["num_leaves"] == 2
    for a, b in zip(T.leaves(t), T.leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_keep_k_retention(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, _tree(), keep=2)
    assert sorted(ckpt.all_steps(tmp_path)) == [4, 5]
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.latest_step(tmp_path / "none") is None


def test_no_partial_checkpoints_visible(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    (tmp_path / "tmp.2.999").mkdir()   # a crashed writer
    assert ckpt.all_steps(tmp_path) == [1]


def test_structure_mismatch_raises(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, {"only": torch.zeros(2)})
    with pytest.raises(ValueError, match="saved"):
        ckpt.restore(tmp_path, {"w": torch.zeros(8, 5),
                                "b": {"x": torch.zeros(5)}})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", _tree())


def test_restore_places_on_the_device_and_dtype_asked(tmp_path):
    """The one-device form of the reference's ``shardings=``: leaves go
    to ``device`` and take the ``like`` leaves' dtypes."""
    t = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    ckpt.save(tmp_path, 3, t)
    out, _ = ckpt.restore(tmp_path, {"w": torch.zeros(4, 4,
                                                      dtype=torch.float64)},
                          device="cpu")
    assert out["w"].dtype == torch.float64 and out["w"].device.type == "cpu"
    np.testing.assert_array_equal(out["w"].numpy(), t["w"].numpy())


def _train_state(seed):
    """A ``{"params", "opt"}`` state on both sides with the same values:
    a random tree and an AdamW state after one update."""
    p = _rand_tree(seed)
    g = _rand_tree(seed + 1)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jp, jo, _ = jadamw.update(jax.tree_util.tree_map(jnp.asarray, g),
                              jadamw.init(jp), jp, lr=1e-2)
    tp = T.tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree_util.tree_map(np.asarray, jp))
    to = adamw.AdamWState(
        torch.tensor(int(jo.step), dtype=torch.int32),
        *(T.tree_map(lambda a: torch.from_numpy(np.array(a)),
                     jax.tree_util.tree_map(np.asarray, m))
          for m in (jo.mu, jo.nu)))
    return {"params": jp, "opt": jo}, {"params": tp, "opt": to}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_the_packages(writer, tmp_path):
    """A ``{"params", "opt": AdamWState}`` checkpoint written by either
    package restores in the other to the same bytes: the leaves are
    numbered in the same flatten order (dict keys sorted, the state's
    fields in order)."""
    jstate, tstate = _train_state(0)
    jzero, tzero = _train_state(7)
    if writer == "port":
        ckpt.save(tmp_path, 4, tstate, metadata={"arch": "x"})
        out, meta = jckpt.restore(tmp_path, jzero)
        got, want = jax.tree_util.tree_leaves(out), T.leaves(tstate)
    else:
        jckpt.save(tmp_path, 4, jstate, metadata={"arch": "x"})
        out, meta = ckpt.restore(tmp_path, tzero)
        got, want = T.leaves(out), jax.tree_util.tree_leaves(jstate)
        assert isinstance(out["opt"], adamw.AdamWState)
    assert meta["step"] == 4 and meta["user"] == {"arch": "x"}
    assert len(got) == len(want) == 1 + 3 * 4
    for a, b in zip(got, want):
        assert _np(a).dtype == _np(b).dtype
        assert _np(a).tobytes() == _np(b).tobytes()
    names = sorted(p.name for p in (tmp_path / "step_0000000004").iterdir())
    assert names == ["leaves.npz", "metadata.json"]


# ------------------------------------------------------------ trainer --

def _tcfg(cls, steps, **kw):
    return cls(**{**dict(steps=steps, global_batch=8, seq_len=64, lr=2e-3,
                         ckpt_every=5, log_every=10 ** 9, seed=1), **kw})


def one_ulp_off(tree, seed: int = 0):
    """``tree`` with every element moved by one float32 ulp (a factor
    ``1 +- 2**-23``, the signs drawn from ``seed``)."""
    gen = torch.Generator().manual_seed(seed)
    return T.tree_map(lambda p: p * (1 + 2.0 ** -23 * (torch.randint(
        0, 2, p.shape, generator=gen) * 2 - 1)), tree)


@functools.lru_cache(maxsize=None)
def _reference_run(dtype, steps):
    jcfg = jax_get_config(ARCH, tiny=True).replace(compute_dtype=dtype)
    out = JaxTrainer(jcfg, _tcfg(JaxTrainConfig, steps)).run()
    init = jax_api.get_model(jcfg).init(jax.random.PRNGKey(1))
    return out, jax.tree_util.tree_map(np.asarray, init)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-3)])
def test_trainer_losses_equal_the_reference_trainer(dtype, tol):
    """12 steps of olmo-1b tiny from the reference Trainer's initial
    parameters (its seed 1), carried across: the port's losses step by
    step, and (float32) the trained parameters, each leaf within the
    larger of 1e-4 of its scale and four times the port's own spread
    when the initial parameters move by one ulp.  The data differ from
    process to process (``SyntheticLM`` seeds a batch with the salted
    ``hash``), and the random init's gradient norms make the clip a sign
    step, so on some draws a last-bit difference grows past 1e-4 over
    the 12 steps; the spread measures that growth on the same draw."""
    jout, init = _reference_run(dtype, 12)
    cfg = get_config(ARCH, tiny=True).replace(compute_dtype=dtype)
    init = T.tree_map(lambda a: torch.from_numpy(a.copy()), init)
    out = Trainer(cfg, _tcfg(TrainConfig, 12), device="cpu",
                  params=init).run()
    got = [h["loss"] for h in out["history"]]
    want = [h["loss"] for h in jout["history"]]
    assert [h["step"] for h in out["history"]] == list(range(12))
    np.testing.assert_allclose(got, want, rtol=tol)
    assert out["stopped_at"] == jout["stopped_at"] == 12
    if dtype == "float32":
        nudged = Trainer(cfg, _tcfg(TrainConfig, 12), device="cpu",
                         params=one_ulp_off(init)).run()
        for a, c, b in zip(T.leaves(out["params"]),
                           T.leaves(nudged["params"]),
                           jax.tree_util.tree_leaves(jout["params"])):
            b = np.asarray(b)
            spread = float((a - c).abs().max())
            assert float(np.abs(a.numpy() - b).max()) <= max(
                1e-4 * max(1.0, float(np.abs(b).max())), 4 * spread)


def test_resume_from_the_reference_trainers_checkpoint(tmp_path):
    """The reference Trainer stops at step 5 (float32); the port's
    resumes from its checkpoint to 10, and its losses from step 5 on
    equal the reference's uninterrupted run's within 1e-5."""
    jcfg = jax_get_config(ARCH, tiny=True).replace(compute_dtype="float32")
    JaxTrainer(jcfg, _tcfg(JaxTrainConfig, 5,
                           ckpt_dir=str(tmp_path))).run()
    full, _ = _reference_run("float32", 12)
    cfg = get_config(ARCH, tiny=True).replace(compute_dtype="float32")
    out = Trainer(cfg, _tcfg(TrainConfig, 10, ckpt_dir=str(tmp_path)),
                  device="cpu").run()
    assert out["history"][0]["step"] == 5 and out["stopped_at"] == 10
    # steps 0..9 are the warmup's, whose lr does not depend on the total
    got = [h["loss"] for h in out["history"]]
    want = [h["loss"] for h in full["history"]][5:10]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_preemption_resume_matches_uninterrupted(tmp_path):
    """``tests/test_runtime.py``'s case on the port: a run stopped at
    step 10 (a checkpoint every 5) and resumed to 20 ends with the
    parameters of a straight run to 20 (rtol 1e-5, atol 1e-6)."""
    cfg = get_config(ARCH, tiny=True)
    ref = Trainer(cfg, _tcfg(TrainConfig, 20, ckpt_dir=str(tmp_path / "a")),
                  device="cpu").run()
    t1 = Trainer(cfg, _tcfg(TrainConfig, 10, ckpt_dir=str(tmp_path / "b")),
                 device="cpu").run()
    assert t1["stopped_at"] == 10
    t2 = Trainer(cfg, _tcfg(TrainConfig, 20, ckpt_dir=str(tmp_path / "b")),
                 device="cpu").run()
    assert t2["history"][0]["step"] == 10
    for a, b in zip(T.leaves(ref["params"]), T.leaves(t2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_preempt_flag_stops_and_checkpoints(tmp_path):
    """The ``PreemptionSignal`` flag file stops the loop before its next
    step; the final checkpoint carries the reference's tag (``step + 1``
    of the loop index it stopped at)."""
    flag = tmp_path / "stop"
    flag.write_text("")
    cfg = get_config(ARCH, tiny=True)
    out = Trainer(cfg, _tcfg(TrainConfig, 4, ckpt_dir=str(tmp_path / "c"),
                             preempt_flag=str(flag)), device="cpu").run()
    assert out["history"] == [] and out["stopped_at"] == 1
    assert ckpt.all_steps(tmp_path / "c") == [1]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``tests/test_system.py``'s run on the port: olmo-1b tiny, 60 steps
    at lr 2e-3 with checkpoints every 30."""
    cfg = get_config(ARCH, tiny=True)
    tcfg = TrainConfig(steps=60, global_batch=8, seq_len=64, lr=2e-3,
                       ckpt_dir=str(tmp_path_factory.mktemp("ck")),
                       ckpt_every=30, log_every=10 ** 9)
    return cfg, Trainer(cfg, tcfg, device="cpu").run()


def test_loss_decreases(trained):
    h = trained[1]["history"]
    first = np.mean([x["loss"] for x in h[:5]])
    last = np.mean([x["loss"] for x in h[-5:]])
    assert last < first - 0.1, (first, last)
    assert all(np.isfinite(x["loss"]) for x in h)


def test_the_trained_model_serves(trained):
    """``tests/test_system.py``'s serving cases: batched requests of two
    prompt lengths through ``generate`` (the Engine), and a 7-bit server
    whose logits track the float server's."""
    cfg, out = trained
    assert not any(t.requires_grad for t in out["params"].buffers())
    server = InferenceServer(cfg, params=out["params"], max_len=64,
                             device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
                    max_new_tokens=6) for i in range(6)]
    reqs.append(Request(6, rng.integers(0, cfg.vocab_size, 8)
                        .astype(np.int32), max_new_tokens=6))
    outs = server.generate(reqs)
    assert [c.uid for c in outs] == list(range(7))
    assert all(len(c.tokens) == 6 for c in outs)
    q = InferenceServer(cfg, params=out["params"], quant_bits=7, max_len=48,
                        device="cpu")
    api = torch_api.get_model(cfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 16)), dtype=torch.int32)
    ref, _ = api.forward(server.params, toks, cfg)
    got, _ = api.forward(q.params, toks, cfg)
    rel = float(torch.sqrt(torch.mean((got - ref) ** 2)) / (ref.std() + 1e-9))
    assert rel < 0.35, rel
    assert float((got.argmax(-1) == ref.argmax(-1)).float().mean()) > 0.5


def test_train_launcher_runs_and_matches_the_reference_flags(tmp_path,
                                                             capsys,
                                                             monkeypatch):
    """``python -m repro_torch.launch.train --device cpu`` with the
    reference's flags trains, checkpoints and prints its summary line;
    minicpm-2b takes the WSD schedule there as here."""
    out = ttrain.main(["--tiny", "--steps", "6", "--batch", "2", "--seq",
                       "16", "--ckpt-dir", str(tmp_path), "--ckpt-every",
                       "3", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "done: steps 0..5 loss" in text
    assert ckpt.all_steps(tmp_path) == [3, 6]
    assert out["stopped_at"] == 6
    seen = []
    monkeypatch.setattr(Trainer, "run", lambda self: seen.append(
        self.tcfg.schedule) or {"history": []})
    for arch in ("minicpm-2b", "qwen3-1.7b"):
        ttrain.main(["--arch", arch, "--tiny", "--device", "cpu"])
    assert seen == ["wsd", "cosine"]
    import repro.launch.train as jtrain
    jseen = []
    monkeypatch.setattr(jtrain.Trainer, "run", lambda self: jseen.append(
        self.tcfg.schedule) or {"history": []})
    monkeypatch.setattr(jtrain.Trainer, "__init__",
                        lambda self, cfg, tcfg, mesh=None:
                        setattr(self, "tcfg", tcfg))
    for arch in ("minicpm-2b", "qwen3-1.7b"):
        monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--tiny"])
        jtrain.main()
    assert jseen == seen
