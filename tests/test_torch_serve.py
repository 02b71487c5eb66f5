"""The port's serving launcher (``repro_torch.launch.serve``) against the
JAX package's (``repro.launch.serve``), on the CPU.

Each case runs both ``main``s with the same flags (the port's with
``--device cpu``) on the engine, ``--bucketed`` and cluster paths, with
``--trace`` and ``--metrics-json`` where the path takes them, and holds
equal: the served request and token counts, the integer values of the
metrics snapshot (wall-time keys left out), and the number of trace
events.  The two packages draw their random weights differently, so no
token is compared here (``tests/test_torch_cluster.py`` and the engine
tests do that on shared weights); what the launcher counts does not
depend on the weights.  The families without an Engine (paligemma-3b,
the vlm; rwkv6-3b; seamless-m4t-medium, the encdec) serve through
``generate``'s bucketed fallback with the counts of the reference's
``--bucketed`` launcher (its Engine refuses them), and both launchers
refuse the Engine's flags for them.
"""

import json
import re
import sys

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TIMED = ("engine.tick.", "engine.faults.slow_ticks")


def _run(main, argv, capsys, monkeypatch):
    """One ``main`` under ``argv``; returns (requests, tokens, integer
    metrics, trace events, printed text)."""
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    main()
    text = capsys.readouterr().out
    m = re.search(r"served (\d+) requests, (\d+) tokens", text)
    assert m, text
    return int(m.group(1)), int(m.group(2)), text


def _metrics(path):
    with open(path) as f:
        rec = json.loads(f.readlines()[-1])["metrics"]
    return {k: v for k, v in rec.items()
            if isinstance(v, int) and not isinstance(v, bool)
            and not any(t in k for t in _TIMED)}


PATHS = {"engine": [],
         "bucketed": ["--bucketed"],
         "cluster": ["--prefill-workers", "2", "--decode-workers", "2",
                     "--shared-prefix", "16"]}


def _both_launchers(flags, path, tmp_path, capsys, monkeypatch):
    """Both ``main``s under ``flags``; returns what each saw."""
    monkeypatch.setenv("REPRO_ACT_CALIB_CACHE", str(tmp_path / "calib.json"))
    seen = []
    for name, main, extra in (("ref", jserve.main, []),
                              ("port", tserve.main, ["--device", "cpu"])):
        trace = tmp_path / f"{name}.trace.json"
        met = tmp_path / f"{name}.metrics.jsonl"
        argv = flags + extra + ["--trace", str(trace),
                                "--metrics-json", str(met)]
        n_req, n_tok, text = _run(main, argv, capsys, monkeypatch)
        traced = path != "bucketed"
        assert trace.exists() == traced and met.exists() == traced
        metrics = _metrics(met) if traced else {}
        events = (len(json.loads(trace.read_text())["traceEvents"])
                  if traced else 0)
        seen.append((n_req, n_tok, metrics, events))
        if name == "port":
            assert "device: cpu" in text
    return seen


@pytest.mark.parametrize("path", list(PATHS))
def test_launcher_counts_equal_the_reference(path, tmp_path, capsys,
                                             monkeypatch):
    flags = ["--tiny", "--requests", "5", "--new-tokens", "6", "--quant", "7",
             "--prompt-len", "20", *PATHS[path]]
    seen = _both_launchers(flags, path, tmp_path, capsys, monkeypatch)
    assert seen[0] == seen[1]
    n_req, n_tok, metrics, _ = seen[1]
    assert (n_req, n_tok) == (5, 30)
    if path == "cluster":
        assert metrics["cluster.handoff.delivered"] == 5
        assert metrics["router.routed"] == 5


@pytest.mark.parametrize("path", ["engine", "cluster"])
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-scout-17b-a16e"])
def test_moe_archs_launch_as_the_reference(arch, path, tmp_path, capsys,
                                           monkeypatch):
    """``--arch`` takes the MoE decoders: the counts the reference's
    launcher gives, with codes activations and KV pages on the engine."""
    extra = (["--act-quant", "7", "--kv-codes"] if path == "engine"
             else PATHS[path])
    flags = ["--arch", arch, "--tiny", "--requests", "4", "--new-tokens", "5",
             "--quant", "7", "--prompt-len", "12", *extra]
    seen = _both_launchers(flags, path, tmp_path, capsys, monkeypatch)
    assert seen[0] == seen[1]
    assert seen[1][:2] == (4, 20)


FALLBACK_ARCHS = ("paligemma-3b", "rwkv6-3b", "seamless-m4t-medium")


@pytest.mark.parametrize("arch", FALLBACK_ARCHS)
def test_fallback_archs_launch_as_the_reference(arch, tmp_path, capsys,
                                                monkeypatch):
    """``--arch`` takes the vlm, rwkv and encdec families: the port's default
    path falls back to the bucketed server and counts what the
    reference's ``--bucketed`` launcher counts, with no trace or
    metrics written on either side (the bucketed path is untraced).
    Float weights: the reference's 7-bit fit alone takes ~10 s to
    compile at the tiny size, and the counts do not depend on them."""
    flags = ["--arch", arch, "--tiny", "--requests", "3", "--new-tokens",
             "5", "--prompt-len", "20"]
    seen = []
    for name, main, extra in (("ref", jserve.main, ["--bucketed"]),
                              ("port", tserve.main, ["--device", "cpu"])):
        trace = tmp_path / f"{name}.trace.json"
        met = tmp_path / f"{name}.metrics.jsonl"
        n_req, n_tok, text = _run(main, flags + extra + [
            "--trace", str(trace), "--metrics-json", str(met)], capsys,
            monkeypatch)
        assert not trace.exists() and not met.exists()
        seen.append((n_req, n_tok))
    assert seen[0] == seen[1] == (3, 15)
    assert "bucketed fallback" in text and "device: cpu" in text


@pytest.mark.parametrize("flags", [["--act-quant", "7"], ["--spec-k", "2"],
                                   ["--prefill-workers", "1",
                                    "--decode-workers", "1"]],
                         ids=["act-quant", "spec-k", "cluster"])
@pytest.mark.parametrize("arch", FALLBACK_ARCHS)
def test_launchers_refuse_engine_flags_for_the_fallback_archs(arch, flags,
                                                             monkeypatch):
    """The Engine's flags raise ``ValueError`` for a family without an
    Engine in both launchers (the reference's from its Engine)."""
    argv = ["serve", "--arch", arch, "--tiny", "--requests", "1",
            "--new-tokens", "2", *flags]
    for main, extra in ((jserve.main, []), (tserve.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", argv + extra)
        with pytest.raises(ValueError):
            main()

