"""Boundaries of the PyTorch port: it imports nothing of JAX or of the
JAX package, and its entry points refuse to fall back to the CPU."""

import ast
import pathlib
import sys

import pytest
import torch

from repro_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = {m for m in _imports(path) if m.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_port_files_found():
    assert len(PORT_FILES) > 20
    for rel in ("runtime/cluster.py", "launch/serve.py", "launch/__init__.py",
                "models/moe.py", "configs/grok_1_314b.py",
                "configs/llama4_scout_17b_a16e.py", "models/rglru.py",
                "configs/recurrentgemma_2b.py", "launch/pim_tables.py",
                "core/pim/__init__.py", "core/pim/accel.py",
                "models/rwkv6.py", "configs/paligemma_3b.py",
                "configs/rwkv6_3b.py", "models/encdec.py",
                "configs/seamless_m4t_medium.py", "tree.py",
                "optim/adamw.py", "optim/schedule.py", "optim/compress.py",
                "data/pipeline.py", "checkpoint/manager.py",
                "runtime/trainer.py", "launch/train.py", "launch/mesh.py",
                "launch/dryrun.py", "sharding/__init__.py",
                "sharding/rules.py", "models/moe_ep.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel


PIM_FILES = sorted((ROOT / "src" / "repro_torch" / "core" / "pim").glob("*.py"))


@pytest.mark.parametrize("path", PIM_FILES,
                         ids=[p.name for p in PIM_FILES])
def test_pim_modules_import_only_the_stdlib_and_lut(path):
    """The cost model is pure Python on the host: the standard library
    and the port's ``core.lut`` (Table II's parallelism), no torch."""
    assert len(PIM_FILES) == 9
    for mod in _imports(path):
        if mod.split(".")[0] == "repro_torch":
            assert mod == "repro_torch.core.lut" or \
                mod.startswith("repro_torch.core.pim"), (path.name, mod)
        else:
            assert mod.split(".")[0] in sys.stdlib_module_names, (path.name,
                                                                  mod)


def _tiny():
    from repro_torch.configs import get_config

    return get_config("qwen3-1.7b", tiny=True)


@pytest.mark.parametrize("entry", ["InferenceServer", "Engine", "DecoderLM",
                                   "Cluster"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device=`` an entry point asks for the card; with no
    card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.runtime.cluster import Cluster
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.server import InferenceServer

    cls = {"InferenceServer": InferenceServer, "Engine": Engine,
           "DecoderLM": DecoderLM, "Cluster": Cluster}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(_tiny())
    cls(_tiny(), device="cpu")     # the explicit CPU request works


def test_trainer_and_train_launcher_default_to_the_card():
    """``Trainer`` without ``device=`` and ``python -m
    repro_torch.launch.train`` without ``--device cpu`` ask for the card;
    with no card they raise instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    cfg = get_config("olmo-1b", tiny=True)
    for make in (lambda: Trainer(cfg, TrainConfig(steps=1)),
                 lambda: train.main(["--tiny", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    Trainer(cfg, TrainConfig(steps=1), device="cpu")


@pytest.mark.parametrize("path", [[], ["--bucketed"],
                                  ["--prefill-workers", "1",
                                   "--decode-workers", "1"]],
                         ids=["engine", "bucketed", "cluster"])
def test_launcher_defaults_to_the_card(path):
    """``python -m repro_torch.launch.serve`` asks for the card unless
    ``--device cpu`` is given, on each of its paths."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--tiny", "--requests", "1", *path])


REPLACED = {
    "lut_dequant_matmul.cu": ("lut_dequant_matmul_kernel",
                              "lut_dequant_matmul_gated_kernel",
                              "lut_dequant_matmul_dual_kernel",
                              "lut_dequant_matmul_dual_gated_kernel"),
    "flash_prefill.cu": ("flash_prefill_paged_kernel",
                         "flash_prefill_paged_codes_kernel"),
    "decode_gqa.cu": ("decode_gqa_paged_kernel",
                      "decode_gqa_paged_codes_kernel", "decode_gqa_kernel"),
    "lama_bulk_op.cu": ("lama_bulk_op_kernel",),
    "exp_histogram.cu": ("exp_histogram_kernel",),
}


def test_kernel_sources_carry_their_notes():
    """Each CUDA source names the TPU kernels it replaces and what bounds
    it on the card."""
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    for name, kernels in REPLACED.items():
        text = (csrc / name).read_text()
        assert "Replaces" in text and "src/repro/kernels/" in text, name
        for k in kernels:
            assert k in text, (name, k)
    text = (csrc / "decode_gqa.cu").read_text()
    assert "Bounds on an H100" in text and "Codes instantiation" in text
    assert "split-KV" in text and "Merge pass" in text
    assert "Contiguous instantiation" in text
    assert sorted(p.stem for p in csrc.glob("*.cu")) == sorted(
        _build.KERNEL_SOURCES)


def test_every_kernel_source_has_a_plain_version_and_a_counter():
    """Each kernel package of the port holds its launch, its plain
    version (``ref.py``) and its public wrapper (``ops.py``)."""
    kernels = ROOT / "src" / "repro_torch" / "kernels"
    for name in ("decode_gqa", "flash_prefill", "lut_dequant_matmul",
                 "lama_bulk_op", "exp_histogram"):
        for part in (f"{name}.py", "ref.py", "ops.py"):
            assert (kernels / name / part).exists(), (name, part)
        assert "count_launch" in (kernels / name / f"{name}.py").read_text()
