"""The port's training loss (``models.api.loss_fn``, ``transformer.lm_loss``)
and its gradients against the JAX package's ``loss_fn`` under
``jax.grad``, for every registered architecture at its tiny size, on
the CPU, from the reference's initial parameters (seed 0) and the same
batch (``synth_batch``: the reference's numpy draws, byte for byte).

At ``compute_dtype="float32"`` the losses agree within 1e-6 of their
value and every gradient leaf within 1e-3 of its own largest magnitude
(measured: at most 3.2e-4, for the tiny encdec, whose encoder
LayerNorms over 0.02-scale stub frames amplify float32 rounding; at
most 2e-4 elsewhere).  At the tiny configs' own bfloat16 compute the two
packages round in other places, and bfloat16 gradients of these tiny
random models differ by up to ~75% leaf by leaf between them (the
reference's own bfloat16 gradient lies 0.01 to 3 times the float32
gradient's norm away from it), so they are held to the float32
gradient instead: the port's bfloat16 gradient may be at most twice as
far from the reference's float32 gradient (in the 2-norm over all
leaves) as the reference's own bfloat16 gradient is, plus 1e-3 of its
norm (measured: 0.83 to 1.2 times as far); the bfloat16 losses agree
within 2e-3 of their value (measured: at most 9e-4).  Every family differentiates: dense,
MoE, vlm, hybrid, rwkv and encdec.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs.base import RunShape as JaxRunShape
from repro.models import api as jax_api
from repro.models import transformer as jtr
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import RunShape
from repro_torch.models import api as torch_api
from repro_torch.models import transformer as ttr

SHAPE = (16, 2)            # seq_len, global batch: tests/test_models.py's
LOSS_TOL = 1e-6
GRAD_TOL = 1e-3
BF16_LOSS_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg = jax_get_config(arch, tiny=True)
    return jax_api.get_model(jcfg).init(jax.random.PRNGKey(0),
                                        dtype=jnp.float32)


def _leaf_tensors(params):
    """The reference's params as a port tree of float32 leaves that
    require grad."""
    return T.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True),
        jax.tree_util.tree_map(np.asarray, params))


def _both(arch, dtype):
    """(reference loss, its metrics, its gradient leaves; the port's
    loss, metrics and gradient leaves) at ``dtype`` compute."""
    jcfg = jax_get_config(arch, tiny=True).replace(compute_dtype=dtype)
    cfg = get_config(arch, tiny=True).replace(compute_dtype=dtype)
    japi, tapi = jax_api.get_model(jcfg), torch_api.get_model(cfg)
    params = _params(arch)
    batch = jax_api.synth_batch(jcfg, JaxRunShape("t", *SHAPE, "train"))
    tbatch = torch_api.synth_batch(cfg, RunShape("t", *SHAPE, "train"),
                                   device="cpu")
    for k, v in batch.items():
        t = tbatch[k]
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert np.asarray(v).tobytes() == t.numpy().tobytes(), k
    (jt, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_api.loss_fn(japi, p, batch), has_aux=True))(params)
    tree = _leaf_tensors(params)
    tt, tm = torch_api.loss_fn(tapi, tapi.module(cfg, tree, device="cpu"),
                               tbatch)
    tg = torch.autograd.grad(tt, T.leaves(tree))
    return ((float(jt), jm, [np.asarray(g) for g in
                             jax.tree_util.tree_leaves(jg)]),
            (float(tt.detach()), tm, [g.numpy() for g in tg]))


def _norm(leaves) -> float:
    return float(np.sqrt(sum(np.sum(np.square(x, dtype=np.float64))
                             for x in leaves)))


def _dist(a, b) -> float:
    return _norm([x - y for x, y in zip(a, b)])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_gradients_match_jax_grad(arch):
    """float32: the losses and every gradient leaf (the flatten orders
    equal, so leaf i is the same parameter on both sides); bfloat16: the
    rule of the module docstring."""
    (jl, jm, jg), (tl, tm, tg) = _both(arch, "float32")
    assert len(tg) == len(jg)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl)
    for k in ("loss", "z_loss", "aux_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_TOL * max(
            1.0, abs(float(jm[k]))), k
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape, i
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= GRAD_TOL * scale, (i, scale)
    (jl16, _, jg16), (tl16, _, tg16) = _both(arch, "bfloat16")
    assert abs(tl16 - jl16) <= BF16_LOSS_TOL * abs(jl16)
    ref_off = _dist(jg16, jg)
    port_off = _dist(tg16, jg)
    assert port_off <= 2 * ref_off + 1e-3 * _norm(jg), (port_off, ref_off)


@pytest.mark.parametrize("arch", ["olmo-1b", "paligemma-3b"])
def test_lm_loss_matches_reference(arch):
    """``transformer.lm_loss`` with a mask (the vlm's patch positions
    dropped): the four metrics within LOSS_TOL, float32."""
    jcfg = jax_get_config(arch, tiny=True).replace(compute_dtype="float32")
    cfg = get_config(arch, tiny=True).replace(compute_dtype="float32")
    batch = jax_api.synth_batch(jcfg, JaxRunShape("t", *SHAPE, "train"))
    mask = (np.random.default_rng(5).random(
        (SHAPE[1], SHAPE[0])) < 0.7).astype(np.float32)
    tbatch = {k: torch.from_numpy(np.asarray(v).copy())
              for k, v in batch.items()}
    tbatch["mask"] = torch.from_numpy(mask)
    jt, jm = jtr.lm_loss(_params(arch), {**batch, "mask": jnp.asarray(mask)},
                         jcfg)
    model = torch_api.get_model(cfg).module(
        cfg, _leaf_tensors(_params(arch)), device="cpu")
    tt, tm = ttr.lm_loss(model, tbatch, cfg)
    assert abs(float(tt) - float(jt)) <= LOSS_TOL * abs(float(jt))
    for k in ("loss", "z_loss", "aux_loss", "ppl_proxy"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_TOL * max(
            1.0, abs(float(jm[k]))), k


@pytest.mark.parametrize("arch", ["olmo-1b", "seamless-m4t-medium",
                                  "rwkv6-3b"])
def test_remat_block_gives_the_same_gradients(arch):
    """``remat="block"`` (the full configs' default: each block under
    ``torch.utils.checkpoint``) recomputes the same activations: the
    loss and every gradient equal those without it, bit for bit."""
    cfg = get_config(arch, tiny=True).replace(compute_dtype="float32")
    batch = torch_api.synth_batch(cfg, RunShape("t", *SHAPE, "train"),
                                  device="cpu")
    out = []
    for remat in ("none", "block"):
        c = cfg.replace(remat=remat)
        api = torch_api.get_model(c)
        tree = _leaf_tensors(_params(arch))
        total, _ = torch_api.loss_fn(api, api.module(c, tree, device="cpu"),
                                     batch)
        out.append((total, torch.autograd.grad(total, T.leaves(tree))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
