"""The port's meta-device dry run (``repro_torch.launch.dryrun``) on the
CPU: its arithmetic on configs against the JAX package's, cell by
cell, and its trace on a small mesh.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host
devices when imported, which would change this worker's JAX for every
later test, so its side runs in one subprocess (``JAX_PLATFORMS=cpu``)
that prints its figures as JSON.  ``analytic_hbm_bytes``,
``model_flops_estimate``, ``cost_pair_cfgs`` and ``wkv_analytic_flops``
are held ``==`` for every architecture and run shape, on both production
meshes' chip counts, float and 7-bit, TP-only serving, bf16 and f8 KV.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import SHAPES_BY_NAME, RunShape
from repro_torch.launch import dryrun as D

VARIANTS = [  # (chips, quant, param_shard_degree, kv dtype)
    (256, None, None, "bf16"), (512, None, None, "bf16"),
    (256, 7, None, "bf16"), (256, None, 16, "f8")]

_REFERENCE = r"""
import json, sys
import jax.numpy as jnp
from repro.configs import ARCH_NAMES, SHAPES_BY_NAME, get_config
from repro.launch import dryrun as D
variants = json.loads(sys.argv[1])
out = {}
for arch in ARCH_NAMES:
    cfg = get_config(arch)
    c1, c2, units = D.cost_pair_cfgs(cfg)
    out[arch] = {"pair": [[c.num_layers, c.enc_layers, c.dec_layers,
                           c.scan_layers] for c in (c1, c2)] + [units]}
    for name, shape in SHAPES_BY_NAME.items():
        cell = {"model_flops": D.model_flops_estimate(cfg, shape),
                "wkv": [D.wkv_analytic_flops(cfg, shape, u)
                        for u in (1.0, 2.0, units)]}
        for chips, quant, psd, kv in variants:
            kvd = jnp.bfloat16 if kv == "bf16" else jnp.float8_e4m3fn
            cell[f"{chips}|{quant}|{psd}|{kv}"] = D.analytic_hbm_bytes(
                cfg, shape, chips, quant=quant, param_shard_degree=psd,
                kv_dtype=kvd)
        out[arch][name] = cell
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE,
                        json.dumps(VARIANTS)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arithmetic_equals_the_reference(arch, reference):
    """Every run shape: ``model_flops_estimate``, ``wkv_analytic_flops``
    (1, 2 and the full units) and ``analytic_hbm_bytes`` in each variant
    ``==`` the reference's; ``cost_pair_cfgs``'s depths and units too."""
    ref = reference[arch]
    cfg = get_config(arch)
    c1, c2, units = D.cost_pair_cfgs(cfg)
    assert [[c.num_layers, c.enc_layers, c.dec_layers, c.scan_layers]
            for c in (c1, c2)] + [units] == ref["pair"]
    for name, shape in SHAPES_BY_NAME.items():
        cell = ref[name]
        assert D.model_flops_estimate(cfg, shape) == cell["model_flops"]
        assert [D.wkv_analytic_flops(cfg, shape, u)
                for u in (1.0, 2.0, units)] == cell["wkv"]
        for chips, quant, psd, kv in VARIANTS:
            got = D.analytic_hbm_bytes(cfg, shape, chips, quant=quant,
                                       param_shard_degree=psd,
                                       kv_dtype=D._DTYPES[kv])
            assert got == cell[f"{chips}|{quant}|{psd}|{kv}"], \
                (name, chips, quant, psd, kv)


def test_extrap_is_the_reference_rule():
    m1, m2 = {"x": 10.0}, {"x": 16.0}
    assert D.extrap(m1, m2, "x", 28.0) == 10.0 + 6.0 * 27.0
    # a negative delta: the 2-unit program's per-unit average
    assert D.extrap({"x": 20.0}, m2, "x", 28.0) == 16.0 * 14.0


def test_op_counter_counts_a_ranks_local_work():
    """On a 2 x 2 fake mesh, x [8, 64] batch-sharded over "data" times w
    [64, 32] sharded over "model" on its columns: one rank multiplies [4,
    64] by [64, 16] (2 * 4 * 64 * 16 FLOPs), and its output's bytes are
    the live peak; nothing moves."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with D.fake_mesh({"data": 2, "model": 2}) as mesh:
        x = DTensor.from_local(torch.empty(4, 64, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=(8, 64), stride=(64, 1))
        w = DTensor.from_local(torch.empty(64, 16, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False,
                               shape=(64, 32), stride=(32, 1))
        with D.OpCounter() as c:
            y = x @ w
        assert tuple(y.to_local().shape) == (4, 16)
        assert c.flops == 2 * 4 * 64 * 16
        assert c.peak == 4 * 16 * 4
        assert sum(v["count"] for v in c.coll.values()) == 0


SMALL = {"train_4k": RunShape("train_4k", 32, 4, "train"),
         "prefill_32k": RunShape("prefill_32k", 32, 4, "prefill"),
         "decode_32k": RunShape("decode_32k", 32, 4, "decode")}


@pytest.mark.parametrize("arch,shape,moe,mesh", [
    ("olmo-1b", "train_4k", None, (2, 1)),
    ("qwen3-1.7b", "prefill_32k", None, (2, 2)),
    ("llama4-scout-17b-a16e", "decode_32k", "ep_a2a", (2, 2))])
def test_a_small_cell_runs(arch, shape, moe, mesh, tmp_path):
    """The tiny config on a 2 x 2 mesh (the train step, autograd and
    AdamW, on 2 x 1: DTensor's redistribution planner takes ~15 s for
    it at 2 x 2): ``ok``, its record in place, the memory, FLOP and
    collective figures present and positive; the EP all-to-alls counted
    from their buffers."""
    rec = D.run_cell(arch, shape, False, tmp_path, force=True, moe_impl=moe,
                     cfg=get_config(arch, tiny=True), shape=SMALL[shape],
                     mesh_shape={"data": mesh[0], "model": mesh[1]})
    assert rec["status"] == "ok", rec.get("traceback")
    path = tmp_path / f"mesh{mesh[0]}x{mesh[1]}" / f"{arch}__{shape}.json"
    assert json.loads(path.read_text())["status"] == "ok"
    mem, roof = rec["memory_analysis"], rec["roofline"]
    assert mem["fits_80gb_hbm"] and mem["param_bytes"] > 0
    assert mem["peak_per_device_bytes"] >= mem["param_bytes"]
    assert roof["traced_flops_per_chip"] > 0
    assert rec["chips"] == mesh[0] * mesh[1]
    assert roof["dominant"] in ("t_compute_s", "t_memory_s",
                                "t_collective_s")
    if shape == "train_4k":
        assert mem["opt_bytes"] == 2 * mem["param_bytes"]
    coll = rec["collectives_unit2"]
    assert (coll["all-to-all (EP buffers)"]["count"] > 0) == bool(moe)


def test_cli_writes_the_reference_file_names(tmp_path, capsys):
    """``main`` with the reference's flags: a cell ``supports_shape``
    refuses gets the reference's skip record under each mesh's folder
    and file name."""
    D.main(["--arch", "qwen3-1.7b", "--shape", "long_500k", "--mesh",
            "both", "--out", str(tmp_path)])
    for mesh in ("pod16x16", "pod2x16x16"):
        rec = json.loads((tmp_path / mesh / "qwen3-1.7b__long_500k.json")
                         .read_text())
        assert rec["status"] == "skip" and "sub-quadratic" in rec["reason"]
    assert capsys.readouterr().out.count(" skip") == 2
