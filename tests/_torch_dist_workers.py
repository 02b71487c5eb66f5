"""Rank bodies of ``tests/test_torch_dist.py``, spawned over ``gloo`` on
the CPU (torch only: the JAX side runs in the parent, which hands its
inputs and outputs over in ``ref.npz`` and reads each rank's results
from ``rank<r>.pt``)."""

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

ARCHS = {"llama4": "llama4-scout-17b-a16e", "grok": "grok-1-314b"}


def run(rank: int, world: int, port: int, out_dir: str) -> None:
    """Every case of ``world`` on this rank; the results (or the error)
    saved to ``rank<r>.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    results = {}
    try:
        ref = dict(np.load(os.path.join(out_dir, "ref.npz")))
        results["psum"] = psum_case(ref, world)
        results.update(CASES[world](rank, world, ref, out_dir))
    except Exception:                                  # noqa: BLE001
        results["error"] = traceback.format_exc()
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def psum_case(ref, world: int) -> dict:
    """``compressed_psum`` of this rank's slice of ``ref["psum_x"]`` [n,
    64] against the exact all-reduce (and, at one rank, the reference's
    bytes)."""
    from repro_torch.optim.compress import (compressed_psum,
                                            compressed_tree_psum)

    x = torch.from_numpy(ref["psum_x"][dist.get_rank()])
    exact = x.clone()
    dist.all_reduce(exact)
    tree = compressed_tree_psum({"a": x.to(torch.bfloat16), "b": [x]})
    return {"comp": compressed_psum(x), "exact": exact, "x": x,
            "tree_b": tree["b"][0], "tree_a_dtype": tree["a"].dtype}


def _mesh(data: int, model: int):
    from repro_torch.launch.mesh import make_host_mesh

    assert data * model == dist.get_world_size()
    return make_host_mesh(model=model, device="cpu")


def _moe_params(cfg, seed: int, bits=None):
    """The layer's float32 weights drawn from ``seed`` (7-bit
    ``QWeight`` per tensor with ``bits``)."""
    from repro_torch.core import lama_layers as ll
    from repro_torch.models import moe as M
    from repro_torch.models.params import init_params

    gen = torch.Generator().manual_seed(seed)
    p = init_params(M.moe_specs(cfg), gen, "cpu", torch.float32)
    if bits:
        p, _ = ll.quantize_tree(p, bits)
    return p


def moe_case(arch: str, model: int, bits=None, **replace) -> dict:
    """``apply_moe`` with ``moe_impl="ep_a2a"`` on a (world // model,
    model) mesh against ``apply_moe_routed`` on the same rows: the tiny
    config at float32 compute and capacity factor 8 (nothing drops),
    this rank's 2 x 16 rows of a seeded x."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.moe_ep import count_all_to_all

    cfg = get_config(ARCHS[arch], tiny=True).replace(
        compute_dtype="float32", capacity_factor=8.0, **replace)
    p = _moe_params(cfg, 1, bits)
    rank = dist.get_rank()
    x = torch.from_numpy(np.random.default_rng(rank).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    routed, raux = M.apply_moe_routed(p, x, cfg)
    mesh = _mesh(dist.get_world_size() // model, model)
    with use_mesh(mesh), count_all_to_all() as a2a:
        ep, eaux = M.apply_moe(p, x, cfg.replace(moe_impl="ep_a2a"))
    return {"ep": ep, "routed": routed, "ep_aux": eaux, "routed_aux": raux,
            "a2a": a2a["count"]}


def one_rank(rank, world, ref, out_dir) -> dict:
    """The reference's EP case (one expert, capacity factor 8, float32)
    at one rank on its parameters; the elastic restore onto a one-device
    mesh."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import moe as M
    from repro_torch.sharding.rules import NamedSharding

    cfg = get_config(ARCHS["llama4"], tiny=True).replace(
        num_experts=1, capacity_factor=8.0, compute_dtype="float32")
    p = {k[len("ep_p_"):]: torch.from_numpy(v) for k, v in ref.items()
         if k.startswith("ep_p_")}
    x = torch.from_numpy(ref["ep_x"])
    mesh = _mesh(1, 1)
    with use_mesh(mesh):
        ep, _ = M.apply_moe(p, x, cfg.replace(moe_impl="ep_a2a"))
    routed, _ = M.apply_moe_routed(p, x, cfg)

    t = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    ck = os.path.join(out_dir, "elastic")
    ckpt.save(ck, 3, t)
    sh = {"w": NamedSharding(mesh, (("data",), None))}
    out, meta = ckpt.restore(ck, t, shardings=sh)
    return {"ep": ep, "routed": routed,
            "elastic": {"placements": tuple(out["w"].placements),
                        "asked": tuple(sh["w"].placements()),
                        "mesh": tuple(out["w"].device_mesh.mesh_dim_names),
                        "full": out["w"].full_tensor(), "step": meta["step"]}}


def _tcfg(steps, **kw):
    from repro_torch.runtime.trainer import TrainConfig

    return TrainConfig(**{**dict(steps=steps, global_batch=8, seq_len=32,
                                 lr=2e-3, ckpt_every=2, log_every=10 ** 9,
                                 seed=1), **kw})


def _leaves(out):
    from repro_torch import tree as T

    return [t.detach().clone() for t in T.leaves(out["params"])]


def one_ulp_off(tree, seed: int = 0):
    """``tree`` with every element moved by one float32 ulp (a factor
    ``1 +- 2**-23``, the signs drawn from ``seed``)."""
    from repro_torch import tree as T

    gen = torch.Generator().manual_seed(seed)
    return T.tree_map(lambda p: p * (1 + 2.0 ** -23 * (torch.randint(
        0, 2, p.shape, generator=gen) * 2 - 1)), tree)


def trainer_case(out_dir: str) -> dict:
    """olmo-1b tiny at float32 compute, 4 steps: the one-device Trainer
    (and again from parameters one ulp off: the spread), then the
    Trainer on the (2, 1) and (1, 2) meshes from the same parameters;
    a (2, 1) run stopped at step 2 resumed on (1, 2) through
    ``restore(shardings=)``."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.runtime.trainer import Trainer

    cfg = get_config("olmo-1b", tiny=True).replace(compute_dtype="float32")
    init = api.get_model(cfg).init("cpu", seed=1).tree()
    out = {}
    if dist.get_rank() == 0:
        for name, p0 in (("single", init), ("nudged", one_ulp_off(init))):
            r = Trainer(cfg, _tcfg(4), device="cpu", params=p0).run()
            out[name] = {"losses": [h["loss"] for h in r["history"]],
                         "params": _leaves(r)}
    for name, shape in (("dp", (2, 1)), ("tp", (1, 2))):
        r = Trainer(cfg, _tcfg(4), device="cpu", params=init,
                    mesh=_mesh(*shape)).run()
        out[name] = {"losses": [h["loss"] for h in r["history"]],
                     "grad_norms": [h["grad_norm"] for h in r["history"]],
                     "params": _leaves(r),
                     "placements": [tuple(p.placements) for p in
                                    r["opt"].mu["blocks"]["mlp"].values()]}
    ck = os.path.join(out_dir, "resume")
    first = Trainer(cfg, _tcfg(2, ckpt_dir=ck), device="cpu", params=init,
                    mesh=_mesh(2, 1)).run()
    resumed = Trainer(cfg, _tcfg(4, ckpt_dir=ck), device="cpu", params=init,
                      mesh=_mesh(1, 2)).run()
    out["resume"] = {"first_stopped": first["stopped_at"],
                     "start": resumed["history"][0]["step"],
                     "losses": [h["loss"] for h in resumed["history"]],
                     "params": _leaves(resumed)}
    return out


def two_ranks(rank, world, ref, out_dir) -> dict:
    return {"llama4_float": moe_case("llama4", 2),
            "llama4_codes": moe_case("llama4", 2, bits=7),
            "train": trainer_case(out_dir)}


def four_ranks(rank, world, ref, out_dir) -> dict:
    return {"llama4_float": moe_case("llama4", 4),
            "llama4_codes": moe_case("llama4", 4, bits=7),
            "grok_float": moe_case("grok", 4),
            "grok_fallback": moe_case("grok", 4, num_experts=6)}


CASES = {1: one_rank, 2: two_ranks, 4: four_ranks}
