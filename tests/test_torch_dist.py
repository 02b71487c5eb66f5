"""The port's multi-rank paths on the CPU over ``gloo``: the int8
all-reduce, the expert-parallel MoE and the Trainer on a mesh, held to
the JAX package and to the port's one-device paths.

One spawn per world size (1, 2, 4 ranks, one torch thread a rank), its
results shared by the tests below; a ``join`` deadline fails a hung
collective instead of eating the suite's clock.  The rank bodies are in
``tests/_torch_dist_workers.py``.

Tolerances: ``compressed_psum`` within ``n * scale`` of the exact sum
(the reference's bound, ``tests/test_runtime.py``) and bit-equal to the
reference's at one rank; ``apply_moe_ep`` within the MoE tests' TOL
(rtol/atol 2e-5, float32 compute) of the routed path, the fallback
bit-equal; the meshed Trainer's losses within rtol 1e-5 of the
one-device Trainer's and its parameters within the larger of 1e-4 of
each leaf's scale and four times the one-device Trainer's own spread
when its initial parameters move by one ulp
(``tests/test_torch_train.py``'s rule).
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_workers as W

JOIN_SECONDS = 150
TOL = dict(rtol=2e-5, atol=2e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference_inputs(world: int) -> dict:
    """The JAX side: the int8 all-reduce's inputs, and at one rank its
    ``compressed_psum`` on a one-device mesh and the reference's EP case
    (``tests/test_models.py``)."""
    rng = np.random.default_rng(world)
    out = {"psum_x": rng.normal(size=(world, 64)).astype(np.float32)}
    if world != 1:
        return out
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.launch.mesh import _make_mesh, make_host_mesh, use_mesh
    from repro.models import moe as M
    from repro.models.params import init_params
    from repro.optim.compress import compressed_psum

    mesh = _make_mesh((1,), ("pod",))
    out["psum_ref"] = np.asarray(shard_map(
        lambda v: compressed_psum(v, "pod"), mesh=mesh,
        in_specs=P("pod", None), out_specs=P("pod", None))(out["psum_x"]))
    cfg = get_config("llama4-scout-17b-a16e", tiny=True).replace(
        num_experts=1, capacity_factor=8.0, compute_dtype="float32")
    params = init_params(jax.random.PRNGKey(1), M.moe_specs(cfg),
                         jnp.float32)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(2, 16, cfg.d_model)), jnp.float32)
    with use_mesh(make_host_mesh(model=1)):
        ep, _ = jax.jit(lambda p, xx: M.apply_moe(
            p, xx, cfg.replace(moe_impl="ep_a2a")))(params, x)
    out["ep_x"] = np.asarray(x)
    out["ep_ref"] = np.asarray(ep)
    out.update({f"ep_p_{k}": np.asarray(v) for k, v in params.items()})
    return out


def _spawn(world: int, tmp) -> list[dict]:
    np.savez(tmp / "ref.npz", **_reference_inputs(world))
    ctx = mp.start_processes(W.run, args=(world, _free_port(), str(tmp)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{JOIN_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    ref = dict(np.load(tmp / "ref.npz"))
    return ranks, ref


_RUNS: dict = {}


def _world(n: int, tmp_path_factory):
    """(the ranks' results, the reference's inputs) of the ``n``-rank
    spawn, run once for the module."""
    if n not in _RUNS:
        _RUNS[n] = _spawn(n, tmp_path_factory.mktemp(f"world{n}"))
    return _RUNS[n]


# ---------------------------------------------------- compressed_psum --

@pytest.mark.parametrize("n", [1, 2, 4])
def test_compressed_psum_within_the_int8_bound(n, tmp_path_factory):
    """Every rank's ``compressed_psum`` within ``n * scale`` of the exact
    all-reduce (``scale = max|x| / 127`` over all ranks), the same on
    every rank; ``compressed_tree_psum`` casts each leaf to float32."""
    ranks, ref = _world(n, tmp_path_factory)
    scale = float(np.abs(ref["psum_x"]).max()) / 127.0
    for r in ranks:
        p = r["psum"]
        np.testing.assert_allclose(p["comp"].numpy(), p["exact"].numpy(),
                                   rtol=0, atol=n * scale + 1e-6)
        assert torch.equal(p["comp"], ranks[0]["psum"]["comp"])
        assert torch.equal(p["tree_b"], p["comp"])
        assert p["tree_a_dtype"] == torch.float32


def test_compressed_psum_one_rank_equals_the_reference(tmp_path_factory):
    """At one rank: the reference's ``compressed_psum`` on a one-device
    mesh, bit for bit, and ``int8_decode(*int8_encode(x))``."""
    from repro_torch.optim.compress import int8_decode, int8_encode

    ranks, ref = _world(1, tmp_path_factory)
    got = ranks[0]["psum"]["comp"]
    assert got.numpy().tobytes() == ref["psum_ref"][0].tobytes()
    x = ranks[0]["psum"]["x"]
    assert torch.equal(got, int8_decode(*int8_encode(x)))


# ------------------------------------------------------------ moe_ep --

def test_ep_one_rank_matches_the_reference_and_routed(tmp_path_factory):
    """``tests/test_models.py``'s ``test_moe_ep_a2a_matches_routed`` on
    the port: one expert, capacity factor 8, the reference's parameters
    and x; the port's EP output within the reference's tolerance of the
    reference's EP output, and within TOL of the port's routed path."""
    ranks, ref = _world(1, tmp_path_factory)
    r = ranks[0]
    np.testing.assert_allclose(r["ep"].numpy(), ref["ep_ref"], rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(r["ep"].numpy(), r["routed"].numpy(), **TOL)


@pytest.mark.parametrize("case,n", [
    ("llama4_float", 2), ("llama4_codes", 2), ("llama4_float", 4),
    ("llama4_codes", 4), ("grok_float", 4)])
def test_ep_equals_routed_across_ranks(case, n, tmp_path_factory):
    """llama4-scout tiny (4 experts, top-1) at model 2 (two experts a
    rank: the one-hot einsums over materialised weights) and model 4
    (one a rank: the fused gated kernel and dense on the codes), float
    and 7-bit weights; grok-1 tiny (4 experts, top-2) at model 4.  Each
    rank's rows equal the routed path's within TOL, the load-balancing
    loss averaged over the ranks."""
    ranks, _ = _world(n, tmp_path_factory)
    aux = np.mean([r[case]["routed_aux"].item() for r in ranks])
    for r in ranks:
        c = r[case]
        assert c["a2a"] == 3
        np.testing.assert_allclose(c["ep"].numpy(), c["routed"].numpy(),
                                   **TOL)
        np.testing.assert_allclose(c["ep_aux"].item(), aux, rtol=1e-5)


def test_ep_falls_back_to_routed(tmp_path_factory):
    """A model axis that does not divide the experts (grok-1's 8 on 16
    ranks in production; here the tiny config with 6 experts on 4)
    takes the routed path: no all-to-all, the routed output exactly."""
    ranks, _ = _world(4, tmp_path_factory)
    for r in ranks:
        c = r["grok_fallback"]
        assert c["a2a"] == 0
        assert torch.equal(c["ep"], c["routed"])


# ------------------------------------------- checkpoints and Trainer --

def test_elastic_restore_onto_a_one_device_mesh(tmp_path_factory):
    """``tests/test_runtime.py``'s elastic case: a checkpoint restored
    with ``shardings=`` lands as a DTensor in the given placement (on a
    one-device mesh every axis replicates), its values the saved
    ones."""
    from torch.distributed.tensor import Replicate

    ranks, _ = _world(1, tmp_path_factory)
    e = ranks[0]["elastic"]
    assert e["mesh"] == ("data", "model") and e["step"] == 3
    assert e["placements"] == e["asked"] == (Replicate(), Replicate())
    assert torch.equal(e["full"],
                       torch.arange(16, dtype=torch.float32).reshape(4, 4))


def _held(got, want, spread_a, spread_b):
    for a, b, c, d in zip(got, want, spread_a, spread_b, strict=True):
        spread = float((c - d).abs().max())
        bound = max(1e-4 * max(1.0, float(b.abs().max())), 4 * spread)
        assert float((a - b).abs().max()) <= bound


@pytest.mark.parametrize("layout", ["dp", "tp"])
def test_trainer_on_a_mesh_equals_the_one_device_trainer(layout,
                                                         tmp_path_factory):
    """4 steps of olmo-1b tiny on the (2, 1) mesh (``dp``: each rank 4
    of the 8 rows, FSDP placements) and the (1, 2) mesh (``tp``: the
    model axis shards the weights): losses within rtol 1e-5 and
    parameters within the one-ulp rule of the one-device Trainer's; the
    moments sharded as the parameters."""
    from torch.distributed.tensor import Shard

    ranks, _ = _world(2, tmp_path_factory)
    one = ranks[0]["train"]
    for r in ranks:
        t = r["train"][layout]
        np.testing.assert_allclose(t["losses"], one["single"]["losses"],
                                   rtol=1e-5)
        _held(t["params"], one["single"]["params"], one["single"]["params"],
              one["nudged"]["params"])
        wide = 0 if layout == "dp" else 1       # the mesh axis of size 2
        assert all(isinstance(p[wide], Shard) for p in t["placements"])


def test_trainer_resumes_across_mesh_layouts(tmp_path_factory):
    """A (2, 1) run stopped at step 2 (its checkpoint's full tensors) is
    resumed on the (1, 2) mesh through ``restore(shardings=)``: steps 2
    and 3 run, and the parameters and losses equal the straight (2, 1)
    run's within the same rule."""
    ranks, _ = _world(2, tmp_path_factory)
    one = ranks[0]["train"]
    for r in ranks:
        res, dp = r["train"]["resume"], r["train"]["dp"]
        assert res["first_stopped"] == 2 and res["start"] == 2
        np.testing.assert_allclose(res["losses"], dp["losses"][2:],
                                   rtol=1e-5)
        _held(res["params"], dp["params"], one["single"]["params"],
              one["nudged"]["params"])
