"""The data axis of the port (toycrystals_torch/parallel) against the JAX
package's (toycrystals_tpu/parallel) and against the port's own one-process
runs, on the CPU.

- (a) `fsdp_sharding` on torch layouts shards the logical axis that JAX's rule
  shards on every leaf of a small CondUNetTiny, CondVAE, DiffusionPriorFiLM
  and MoE-4 prior, and `fsdp_coverage` equals JAX's for N = 2, 4 and 8.
- (b) The refusals of `maybe_initialize` and `setup_mesh` are JAX's.
- (c) One 2-rank gloo job (`parallel.multihost.launch` of
  `parallel.parity.run_cases`, every collective with a timeout) runs 3 SDE
  steps under DDP and under FSDP2, a VAE step, a dense and a MoE-4 prior
  step, a distillation step and `sample_chunked` of 7 images at chunk 3
  (also with the int8 convs), each fed the draws that the JAX package's step
  or sampler makes on a 2-device mesh of the 8-virtual-device CPU
  (tests/conftest.py). Against
  JAX: the tolerances of the single-device tests of each step
  (tests/test_torch_train_step.py, test_torch_vae_train.py,
  test_torch_prior.py, test_torch_distill.py, test_torch_sampler.py).
  Against the same cases in one process with no mesh: losses within 1e-6
  relative; gradients within 1e-5 of each leaf's largest entry, plus 1e-6 of
  the step's largest gradient for leaves at rounding-noise level (the
  embeddings and conv biases ahead of a GroupNorm, ~1e-8 here); images
  within 1e-6; the int8 ones (at the mesh's chunk) bit for bit: the
  activation scale is the max over both ranks' rows, as over the one
  process's batch.
- (d) torch.distributed.checkpoint: a 2-rank FSDP2 save restores bit for
  bit in one process and a one-process save in 2 FSDP2 ranks (same job);
  step retention as tests/test_orbax_io.py; a JAX-written orbax directory
  is refused, naming the difference.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_prior import FILM_KW, T, Z, _jax_sched
from test_torch_vae_train import _injected
from toycrystals_torch.models import diffusion_prior as tp
from toycrystals_torch.models import moe_prior as tmoe
from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.models import vae as tv
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.parallel import fsdp_coverage, fsdp_sharding, launch
from toycrystals_torch.parallel.fsdp import param_layouts
from toycrystals_torch.parallel.multihost import maybe_initialize
from toycrystals_torch.parallel.parity import run_cases
from toycrystals_torch.scripts._common import setup_mesh
from toycrystals_torch.train.state import Optimizer, create_train_state
from toycrystals_torch.utils import orbax_io
from toycrystals_torch.utils.params import (
    flax_from_torch_state_dict,
    flax_prior_from_torch_state_dict,
    flax_vae_from_torch_state_dict,
    torch_state_dict_from_flax,
    torch_state_dict_from_flax_prior,
    torch_state_dict_from_flax_vae,
    train_state_to_checkpoint,
)
from toycrystals_tpu.models import diffusion_prior as jp
from toycrystals_tpu.models import moe_prior as jmoe
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.models import vae as jv
from toycrystals_tpu.parallel import fsdp as jfsdp
from toycrystals_tpu.parallel import make_mesh, replicate, shard_batch
from toycrystals_tpu.parallel import multihost as jmultihost
from toycrystals_tpu.train import distill as jd
from toycrystals_tpu.train.state import create_train_state as jax_create_train_state
from toycrystals_tpu.train.steps import make_prior_train_step as jax_make_prior_train_step
from toycrystals_tpu.train.steps import make_sde_train_step as jax_make_sde_train_step
from toycrystals_tpu.train.steps import make_vae_train_step as jax_make_vae_train_step

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
SIZE, B, VZ = 16, 4, 8
MOE_KW = dict(FILM_KW, n_blocks=2, n_experts=4)
LR, DECAY, CLIP = 1e-3, 0.9, 1.0


UNET_ARGS = (jnp.zeros((2, SIZE, SIZE, 1)), jnp.zeros((2,)), jnp.zeros((2,), jnp.int32),
             jnp.zeros((2, 4)))
VAE_ARGS = (jnp.zeros((2, 64, 64, 1)), jnp.zeros((2,), jnp.int32), jnp.zeros((2, 4)))
PRIOR_ARGS = (jnp.zeros((2, Z)), jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32),
              jnp.zeros((2, 4)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch runs this module's in-process work on one thread, as each
    spawned rank does: beside other pytest-xdist workers, a pool of one
    thread per core runs such small steps tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _unet_params(seed):
    """A flax param tree of CondUNetTiny: the port's flax-default init of the
    seed through the weight bridge (no JAX compile)."""
    model = flax_default_init(tm.CondUNetTiny(**KW), np.random.default_rng(seed))
    return flax_from_torch_state_dict(model.state_dict())


def _vae_params(seed):
    """JAX's own init: tests/test_torch_vae_train.py's parameter tolerance
    assumes its weights."""
    k = jax.random.key(seed)
    return _np(jax.jit(jv.CondVAE(z_dim=VZ, cond_drop=0.5).init)(
        {"params": k, "reparam": k}, *VAE_ARGS)["params"])


def _prior_params(tmodel, seed):
    model = flax_default_init(tmodel, np.random.default_rng(seed))
    return flax_prior_from_torch_state_dict(model.state_dict())


def _flax_shapes(jmodel, *args, rngs=("params",)):
    """The shapes of a flax model's param tree (jax.eval_shape: nothing runs)."""
    k = jax.random.key(0)
    return jax.eval_shape(jmodel.init, {r: k for r in rngs}, *args)["params"]


# ---------------------------------------------------------------------------
# (a) the FSDP placement rule
# ---------------------------------------------------------------------------

MODELS = {
    "unet": (lambda: tm.CondUNetTiny(**KW),
             lambda: _flax_shapes(jm.CondUNetTiny(**KW), *UNET_ARGS), flax_from_torch_state_dict),
    "vae": (lambda: tv.CondVAE(z_dim=VZ, cond_drop=0.5),
            lambda: _flax_shapes(jv.CondVAE(z_dim=VZ, cond_drop=0.5), *VAE_ARGS,
                                 rngs=("params", "reparam")),
            flax_vae_from_torch_state_dict),
    "film": (lambda: tp.DiffusionPriorFiLM(**FILM_KW),
             lambda: _flax_shapes(jp.DiffusionPriorFiLM(**FILM_KW), *PRIOR_ARGS),
             flax_prior_from_torch_state_dict),
    "moe4": (lambda: tmoe.DiffusionPriorMoE(**MOE_KW),
             lambda: _flax_shapes(jmoe.DiffusionPriorMoE(**MOE_KW), *PRIOR_ARGS),
             flax_prior_from_torch_state_dict),
}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _only_path(tree, path=()):
    (k, v), = tree.items()
    return _only_path(v, path + (k,)) if isinstance(v, dict) else (path + (k,), v)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", list(MODELS))
def test_fsdp_rule_shards_the_axis_jax_shards(name, n):
    """Every leaf: the torch dim the port shards is the flax axis JAX's
    `fsdp_sharding` shards (or both keep the leaf whole); the coverage is
    JAX's number."""
    make_torch, make_flax, to_flax = MODELS[name]
    model, params = make_torch(), make_flax()
    mesh = make_mesh(n)
    sharded = 0
    for tname, p, order in param_layouts(model):
        path, value = _only_path(to_flax({tname: p.detach()}))
        assert _leaf(params, path).shape == value.shape, tname
        spec = tuple(jfsdp.fsdp_sharding(mesh, value.shape).spec)
        want = spec.index("data") if "data" in spec else None
        dim = fsdp_sharding(n, tuple(p.shape), order)
        got = None if dim is None else order.index(dim)
        assert got == want, (tname, tuple(p.shape), order, dim, spec)
        sharded += dim is not None
    assert sharded > 0
    assert fsdp_coverage(n, model) == jfsdp.fsdp_coverage(mesh, params)


# ---------------------------------------------------------------------------
# (b) refusals
# ---------------------------------------------------------------------------


def test_maybe_initialize_refuses_and_no_ops_as_jax_does():
    for kw in ({}, {"num_processes": 1}):
        assert maybe_initialize(**kw) is False
        assert jmultihost.maybe_initialize(**kw) is False
    kw = {"coordinator": "auto", "num_processes": 2}
    with pytest.raises(SystemExit) as port:
        maybe_initialize(**kw)
    with pytest.raises(SystemExit) as jax_:
        jmultihost.maybe_initialize(**kw)
    assert str(port.value) == str(jax_.value)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("shard, batch, match", [
    (3, 16, "batch size 16 not divisible by --shard 3"), (-1, 16, "--shard must be >= 0"),
    (16, 16, "--shard 16 but only .* devices visible"), (0, 16, None), (1, 15, None)])
def test_setup_mesh_refuses_as_jax_does(shard, batch, match):
    from scripts._common import setup_mesh as jax_setup_mesh

    if match is None:
        assert setup_mesh(shard, batch, device=torch.device("cpu")) is None
        assert jax_setup_mesh(shard, batch) is None
        return
    for fn in (lambda: setup_mesh(shard, batch, device=torch.device("cpu")),
               lambda: jax_setup_mesh(shard, batch)):
        with pytest.raises(SystemExit, match=match):
            fn()


@pytest.mark.parametrize("flag", ["shard_space", "shard_model"])
def test_setup_mesh_refuses_the_model_axes(flag):
    """--shard-model with --shard-space (JAX's 3-D mesh) runs now; its flags
    refuse as JAX's `setup_mesh` does: too few devices for `setup_mesh`, and
    a batch that does not split over --shard in `spawn_shards` before any
    rank starts."""
    import argparse

    from scripts._common import setup_mesh as jax_setup_mesh

    from toycrystals_torch.scripts._common import spawn_shards

    if flag == "shard_space":
        match = "--shard 4 x --shard-space 2 x --shard-model 2 needs 16 devices, have"
        calls = (lambda: setup_mesh(4, 16, device=torch.device("cpu"), shard_space=2,
                                    shard_model=2),
                 lambda: jax_setup_mesh(4, 16, shard_space=2, shard_model=2))
    else:
        match = "batch size 15 not divisible by --shard 2"
        calls = (lambda: spawn_shards(argparse.Namespace(shard=2, shard_space=2, shard_model=2,
                                                         device="cpu"), None, [], (15,)),
                 lambda: jax_setup_mesh(2, 15, shard_space=2, shard_model=2))
    for fn in calls:
        with pytest.raises(SystemExit, match=match):
            fn()


def test_a_mesh_with_a_model_axis_raises():
    """JAX's CLIs build no ("data", "space", "pipe") mesh: `place_state`
    refuses it (the 3-D ("data", "space", "model") mesh places)."""
    from toycrystals_torch.parallel import place_state

    model = tm.CondUNetTiny(**KW)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "space", "pipe"))
    with pytest.raises(NotImplementedError, match="JAX's CLIs offer no such mesh"):
        place_state(mesh, model, create_train_state(model, Optimizer(1e-3)))


# ---------------------------------------------------------------------------
# (c) the 2-rank job, fed JAX's draws on a 2-device mesh
# ---------------------------------------------------------------------------


def _batch(seed, b=B):
    r = np.random.default_rng(seed)
    return (r.uniform(size=(b, SIZE, SIZE, 1)).astype(np.float32),
            r.integers(0, 4, size=(b,)).astype(np.int32),
            r.normal(size=(b, 4)).astype(np.float32))


def _jax_sde(params):
    """3 JAX steps on a 2-device mesh (p_uncond 0.5), with the draws each
    step's key makes, for the port to inject. The port's DDP and FSDP2 runs
    are both held to it: JAX's FSDP placement changes no number at these
    tolerances (tests/test_fsdp.py holds it to the single-device step)."""
    mesh = make_mesh(2)
    jmodel = jm.CondUNetTiny(**KW)
    jtx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(LR))
    state = jax_create_train_state(jax.tree.map(jnp.asarray, params), jtx, ema=True)
    state = replicate(mesh, state)
    step = jax_make_sde_train_step(jmodel, jtx, jm.VPSDE(0.1, 30.0), 4, 0.5, 1.0, DECAY)
    draws = {k: [] for k in ("x0", "y_cat", "y_cont", "t", "eps")}
    losses = []
    for i in range(3):
        x0, y_cat, y_cont = _batch(20 + i)
        key = jax.random.key(30 + i)
        t, eps, yc, yv = jm.draw_diffusion_loss_noise(
            jnp.asarray(x0), jnp.asarray(y_cat), jnp.asarray(y_cont), key, 4, 0.5)
        for k, v in zip(draws, (x0, yc, yv, t, eps)):
            draws[k].append(np.asarray(v))
        state, loss = step(state, *shard_batch(mesh, (jnp.asarray(x0), jnp.asarray(y_cat),
                                                     jnp.asarray(y_cont))), key)
        losses.append(float(loss))
    adam = state.opt_state[1][0]
    return {k: np.stack(v) for k, v in draws.items()}, {
        "losses": losses, "params": torch_state_dict_from_flax(_np(state.params)),
        "ema": torch_state_dict_from_flax(_np(state.ema_params)),
        "mu": torch_state_dict_from_flax(_np(adam.mu)),
        "nu": torch_state_dict_from_flax(_np(adam.nu))}


def _jax_vae(params):
    """One JAX CondVAE step on a 2-device mesh with injected (eps, keep)."""
    r = np.random.default_rng(3)
    x = r.uniform(size=(B, 64, 64, 1)).astype(np.float32)
    y_cat = (np.arange(B) % 4).astype(np.int32)
    y_cont = r.normal(size=(B, 4)).astype(np.float32)
    eps = r.normal(size=(B, VZ)).astype(np.float32)
    keep = np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)
    mesh = make_mesh(2)
    jmodel = _injected(jv.CondVAE, jnp.asarray(eps), jnp.asarray(keep))(z_dim=VZ,
                                                                          cond_drop=0.5)
    tx = optax.adam(2e-3)
    state = replicate(mesh, jax_create_train_state(jax.tree.map(jnp.asarray, params), tx))
    step = jax_make_vae_train_step(jmodel, tx, 0.05)
    state, m = step(state, *shard_batch(mesh, (jnp.asarray(x), jnp.asarray(y_cat),
                                               jnp.asarray(y_cont))),
                    jnp.float32(1.2e-4), jax.random.key(0))
    case = dict(kind="vae", model=dict(z_dim=VZ, cond_drop=0.5),
                state_dict=torch_state_dict_from_flax_vae(params), opt={"lr": 2e-3}, x=x,
                y_cat=y_cat, y_cont=y_cont, eps=eps, keep=keep, beta_eff=1.2e-4,
                free_bits=0.05)
    return case, {"metrics": {k: float(v) for k, v in m.items()},
                  "params": torch_state_dict_from_flax_vae(_np(state.params))}


def _jax_prior(jmodel, tmodel, kw, aux_weight, seed):
    """One JAX prior step on a 2-device mesh (GSPMD forms the MoE's route
    statistics over the global batch); its gradients through an optimizer
    whose state is the gradient."""
    js, ts = _jax_sched()
    params = _prior_params(tmodel, seed)
    r = np.random.default_rng(seed + 1)
    b = 8
    z0n = r.normal(size=(b, Z)).astype(np.float32)
    yc = r.integers(0, 4, b).astype(np.int32)
    yv = r.uniform(0, 1, (b, 4)).astype(np.float32)
    key = jax.random.key(seed + 2)
    mesh = make_mesh(2)
    step = jax_make_prior_train_step(jmodel, _capture_grads(), T, aux_weight=aux_weight)
    state = replicate(mesh, jax_create_train_state(jax.tree.map(jnp.asarray, params),
                                                   _capture_grads()))
    state, m = step(state, js, *shard_batch(mesh, (jnp.asarray(z0n), jnp.asarray(yc),
                                                   jnp.asarray(yv))), key)
    k_t, k_eps = jax.random.split(key)
    u = jax.random.uniform(k_t, (b,))
    t = np.asarray(jnp.clip((u**2 * T).astype(jnp.int32), 0, T - 1))
    eps = np.asarray(jax.random.normal(k_eps, (b, Z), jnp.float32))
    case = dict(kind="prior", model=kw, state_dict=torch_state_dict_from_flax_prior(params),
                opt={"lr": 1e-3}, betas=ts.betas.numpy(), alpha_bars=ts.alpha_bars.numpy(),
                z0n=z0n, y_cat=yc, y_cont=yv, t=t, eps=eps, aux_weight=aux_weight)
    return case, {"metrics": {k: np.asarray(v) for k, v in m.items()},
                  "grads": torch_state_dict_from_flax_prior(_np(state.opt_state))}


def _capture_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_distill(tparams, sparams):
    """One JAX distillation step (eps teacher, CFG 1.5) on a 2-device mesh;
    its gradients through an optimizer whose state is the gradient."""
    b, n = B, 4
    x0, y_cat, y_cont = _batch(5)
    key = jax.random.key(17)
    mesh = make_mesh(2)
    jmodel = jm.CondUNetTiny(**KW)
    apply_fn = lambda prm, x, t, yc, yv: jmodel.apply({"params": prm}, x, t, yc, yv)  # noqa: E731
    step = jd.make_distill_train_step(jmodel, apply_fn, jax.tree.map(jnp.asarray, tparams),
                                      _capture_grads(), jm.VPSDE(0.1, 30.0), n, n_types=4,
                                      guidance_scale=1.5, teacher_prediction="eps",
                                      t_end=0.005)
    state = replicate(mesh, jax_create_train_state(jax.tree.map(jnp.asarray, sparams),
                                                   _capture_grads()))
    state, loss = step(state, *shard_batch(mesh, (jnp.asarray(x0), jnp.asarray(y_cat),
                                                  jnp.asarray(y_cont))), key)
    k_i, k_eps = jax.random.split(key)
    i = np.asarray(jax.random.randint(k_i, (b,), 0, n))
    eps = np.asarray(jax.random.normal(k_eps, x0.shape, jnp.float32))
    case = dict(kind="distill", model=KW, teacher=torch_state_dict_from_flax(tparams),
                state_dict=torch_state_dict_from_flax(sparams), opt={"lr": 1e-3}, x0=x0,
                y_cat=y_cat, y_cont=y_cont, i=i.astype(np.int64), eps=eps, n=n, cfg=1.5,
                teacher_prediction="eps", t_end=0.005)
    return case, {"loss": float(loss),
                  "grads": torch_state_dict_from_flax(_np(state.opt_state))}


def _jax_sample(params):
    """JAX's sample_chunked of 7 images at chunk 3 on a 2-device mesh (the
    chunk becomes 4), and each row's draws (x_init, z) from the chunk keys."""
    n, steps, chunk = 7, 2, 4
    yc, yv = (np.asarray(a) for a in jm.sample_grid_conditions(n, 4, 4))
    jmodel = jm.CondUNetTiny(**KW)
    japply = jax.jit(lambda p, xt, t, c, v: jmodel.apply({"params": p}, xt, t, c, v))
    key = jax.random.key(11)
    out = jm.sample_chunked(jm.sample_reverse_sde_euler_maruyama, japply,
                            jax.tree.map(jnp.asarray, params), jm.VPSDE(0.1, 30.0),
                            jnp.asarray(yc), jnp.asarray(yv), (n, SIZE, SIZE, 1), key,
                            chunk=3, mesh=make_mesh(2), n_steps=steps, guidance_scale=1.5,
                            n_types=4)
    x_init, z = [], []
    for i0 in range(0, n, chunk):
        k_init, k_noise = jax.random.split(jax.random.fold_in(key, i0))
        shape = (chunk, SIZE, SIZE, 1)
        x_init.append(np.asarray(jax.random.normal(k_init, shape, jnp.float32)))
        z.append(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k_noise, i),
                                                        shape, jnp.float32))
                           for i in range(steps)], axis=1))
    case = dict(kind="sample", model=KW, state_dict=torch_state_dict_from_flax(params),
                y_cat=yc, y_cont=yv, shape=(n, SIZE, SIZE, 1), seed=11, chunk=3,
                n_steps=steps, cfg=1.5, x_init=np.concatenate(x_init)[:n],
                z=np.concatenate(z)[:n])
    return case, np.asarray(out)


@pytest.fixture(scope="module")
def jax_suite(tmp_path_factory):
    """The spec of the 2-rank job (JAX's inputs and draws) and JAX's results."""
    unet = _unet_params(11)
    sde_draws, jax_sde = _jax_sde(unet)
    sde = dict(kind="sde", model=KW, state_dict=torch_state_dict_from_flax(unet),
               opt={"lr": LR, "clip": CLIP, "ema": DECAY}, **sde_draws)
    vae, jax_vae = _jax_vae(_vae_params(1))
    dense, jax_dense = _jax_prior(jp.DiffusionPriorFiLM(**FILM_KW),
                                  tp.DiffusionPriorFiLM(**FILM_KW), FILM_KW, 0.0, 3)
    moe, jax_moe = _jax_prior(jmoe.DiffusionPriorMoE(**MOE_KW),
                              tmoe.DiffusionPriorMoE(**MOE_KW), MOE_KW, 0.01, 4)
    distill, jax_distill = _jax_distill(_unet_params(3), _unet_params(4))
    sample, jax_sample = _jax_sample(unet)
    d = tmp_path_factory.mktemp("dcp")
    one_saved = _one_process_dcp_save(d / "one")
    dcp = dict(kind="dcp_save", model=KW, state_dict=torch_state_dict_from_flax(unet),
               fsdp=True, seed=8, path=str(d / "two"))
    load = dict(kind="dcp_load", model=KW, state_dict=torch_state_dict_from_flax(unet),
                fsdp=True, path=str(d / "one"))
    # at the mesh's chunk of 4: an int8 scale spans the chunk's rows
    sample_int8 = dict(sample, model=dict(KW, conv_impl="int8"), chunk=4)
    cases = {"sde": sde, "sde_fsdp": dict(sde, fsdp=True), "vae": vae, "dense": dense,
             "moe": moe, "distill": distill, "sample": sample, "sample_int8": sample_int8,
             "dcp_save": dcp, "dcp_load": load}
    return {"cases": cases, "one_saved": one_saved,
            "jax": {"sde": jax_sde, "sde_fsdp": jax_sde, "vae": jax_vae,
                    "dense": jax_dense, "moe": jax_moe, "distill": jax_distill,
                    "sample": jax_sample}}


def _one_process_dcp_save(path) -> dict:
    """A one-process DCP save of a state with values of its own everywhere."""
    from toycrystals_torch.parallel.parity import _fill, _state_np

    model = tm.CondUNetTiny(**KW)
    tx = Optimizer(1e-3)
    state = create_train_state(model, tx, ema=True)
    _fill(state, 9)
    with orbax_io.ShardedCheckpointManager(path) as mgr:
        mgr.save(1, state, tx, {"epoch_next": 1, "loss_hist": [], "config": {}})
    return _state_np(state)


@pytest.fixture(scope="module")
def two_ranks(jax_suite):
    """Every case in one 2-rank gloo job (one spawn)."""
    names = list(jax_suite["cases"])
    out = launch(run_cases, 2, ({"device": "cpu", "cases": list(jax_suite["cases"].values())},),
                 timeout=300)
    return [dict(zip(names, rank)) for rank in out]


@pytest.fixture(scope="module")
def one_process(jax_suite):
    cases = {k: v for k, v in jax_suite["cases"].items() if not k.startswith("dcp")}
    return dict(zip(cases, run_cases({"device": "cpu", "cases": list(cases.values())})))


def _hold_grads(got: dict, want: dict, leaf: float, floor: float, what: str) -> None:
    top = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        lim = leaf * float(np.abs(w).max()) + floor * top + 1e-12
        np.testing.assert_allclose(got[k], w, rtol=0, atol=lim, err_msg=f"{what} {k}")


def test_both_ranks_hold_the_same_results(two_ranks):
    r0, r1 = two_ranks
    for name in r0:
        for k in ("losses", "loss", "metrics", "injected", "drawn"):
            if k in r0[name]:
                np.testing.assert_equal(r0[name][k], r1[name][k], err_msg=f"{name} {k}")
        for part in ("params", "grads", "mu"):
            for leaf, v in (r0[name].get(part) or {}).items():
                np.testing.assert_array_equal(v, r1[name][part][leaf], err_msg=f"{name} {leaf}")


@pytest.mark.parametrize("name", ["sde", "sde_fsdp"])
def test_sde_steps_match_jax_on_a_2_device_mesh(jax_suite, two_ranks, name):
    """3 steps, clip 1.0, EMA 0.9: tests/test_torch_train_step.py's limits."""
    got, want = two_ranks[0][name], jax_suite["jax"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["step"] == got["count"] == 3
    for part, atol in (("mu", 1e-5), ("nu", 1e-7)):
        for k, w in want[part].items():
            scale = max(float(np.abs(w).max()), 1e-3)
            np.testing.assert_allclose(got[part][k], w, atol=atol + 2e-3 * scale, rtol=0,
                                       err_msg=f"{part} {k}")
    compared = 0
    for part in ("params", "ema"):
        for k, mu in want["mu"].items():
            mask = np.abs(mu) >= max(0.1 * float(np.abs(mu).max()), 1e-5)
            compared += int(mask.sum())
            np.testing.assert_allclose(got[part][k][mask], want[part][k][mask], atol=LR / 10,
                                       rtol=0, err_msg=f"{part} {k}")
    assert compared > 1000


@pytest.mark.parametrize("name", ["sde", "sde_fsdp", "vae", "dense", "moe", "distill"])
def test_two_ranks_match_one_process(two_ranks, one_process, name):
    got, want = two_ranks[0][name], one_process[name]
    if "losses" in want:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    if "loss" in want:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    for k, v in (want.get("metrics") or {}).items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    _hold_grads(got["grads"], want["grads"], 1e-5, 1e-6, name)
    if want.get("route_fraction") is not None:
        for g, w in zip(got["route_fraction"], want["route_fraction"]):
            np.testing.assert_array_equal(g, w)


def test_vae_step_matches_jax_on_a_2_device_mesh(jax_suite, two_ranks):
    """tests/test_torch_vae_train.py's limits: metrics 1e-5 relative, every
    parameter within a thousandth of the first Adam step."""
    got, want = two_ranks[0]["vae"], jax_suite["jax"]["vae"]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=2e-3 * 1e-3, err_msg=k)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_prior_step_matches_jax_on_a_2_device_mesh(jax_suite, two_ranks, name):
    """tests/test_torch_prior.py's limits; the MoE's load-balancing term is
    formed from the global batch's route statistics on both sides."""
    got, want = two_ranks[0][name], jax_suite["jax"][name]
    for k in ("loss", "aux"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["metrics"]["bucket_n"], want["metrics"]["bucket_n"])
    np.testing.assert_allclose(got["metrics"]["bucket_sum"], want["metrics"]["bucket_sum"],
                               rtol=1e-5)
    assert int(got["metrics"]["bucket_n"].sum()) == 8
    if name == "moe":
        assert float(got["metrics"]["aux"]) > 0.0
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-7, err_msg=k)


def test_moe_route_statistics_are_the_global_batch(jax_suite, two_ranks, one_process):
    """Each rank's route fractions are the whole batch's (they sum to 1 and
    equal the one-process values), not its own rows'."""
    for g, w in zip(two_ranks[1]["moe"]["route_fraction"],
                    one_process["moe"]["route_fraction"]):
        np.testing.assert_array_equal(g, w)
        assert abs(float(g.sum()) - 1.0) < 1e-6


def test_distill_step_matches_jax_on_a_2_device_mesh(jax_suite, two_ranks):
    """tests/test_torch_distill.py's limits (eps teacher, CFG 1.5)."""
    got, want = two_ranks[0]["distill"], jax_suite["jax"]["distill"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
    floor = 1e-6 * max(float(np.abs(w).max()) for w in want["grads"].values())
    for k, w in want["grads"].items():
        lim = 1e-5 + 2e-3 * max(float(np.abs(w).max()), 1e-3) + floor
        np.testing.assert_allclose(got["grads"][k], w, atol=lim, rtol=0, err_msg=k)


def test_sample_chunked_matches_jax_and_one_process(jax_suite, two_ranks, one_process):
    """7 images at chunk 3 on 2 ranks (chunks of 4): JAX's mesh sampler on
    its own draws within 2e-4 (tests/test_torch_sampler.py), the port's one
    process on the same per-row draws within 1e-6; drawn from the port's
    chunk generators, the one-process run at the mesh's chunk of 4."""
    got = two_ranks[0]["sample"]
    assert got["injected"].shape == (7, SIZE, SIZE, 1)
    np.testing.assert_allclose(got["injected"], jax_suite["jax"]["sample"], atol=2e-4, rtol=0)
    np.testing.assert_allclose(got["injected"], one_process["sample"]["injected"], atol=1e-6,
                               rtol=0)
    case = dict(jax_suite["cases"]["sample"], chunk=4)
    ref = run_cases({"device": "cpu", "cases": [case]})[0]["drawn"]
    np.testing.assert_allclose(got["drawn"], ref, atol=1e-6, rtol=0)


def test_int8_sample_chunked_matches_one_process(two_ranks, one_process):
    """The int8 convs on 2 ranks: each conv's activation scale is the max over
    the whole batch, both ranks' rows, so the grid is the one-process grid bit
    for bit on the CPU (a scale from each rank's own rows gave other images:
    5% of the pixels, by up to 1.0)."""
    for kind in ("injected", "drawn"):
        got, want = two_ranks[0]["sample_int8"][kind], one_process["sample_int8"][kind]
        assert got.shape == (7, SIZE, SIZE, 1)
        np.testing.assert_array_equal(got, want, err_msg=kind)


# ---------------------------------------------------------------------------
# (d) torch.distributed.checkpoint
# ---------------------------------------------------------------------------


def _assert_state_equal(got, want):
    for part in ("params", "mu", "nu", "ema"):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=f"{part} {k}")
    assert (got["step"], got["count"]) == (want["step"], want["count"]) == (7, 5)


def test_dcp_two_rank_fsdp_save_restores_in_one_process(jax_suite, two_ranks):
    saved = two_ranks[0]["dcp_save"]
    model = tm.CondUNetTiny(**KW)
    tx = Optimizer(1e-3)
    state = create_train_state(model, tx, ema=True)
    with orbax_io.ShardedCheckpointManager(jax_suite["cases"]["dcp_save"]["path"]) as mgr:
        state, meta = mgr.restore_onto(state)
    from toycrystals_torch.parallel.parity import _state_np

    _assert_state_equal(_state_np(state), saved)
    assert meta["epoch_next"] == 1 and meta["opt_layout"]["clip"] is False


def test_dcp_one_process_save_restores_in_two_fsdp_ranks(jax_suite, two_ranks):
    for rank in two_ranks:
        _assert_state_equal(rank["dcp_load"], jax_suite["one_saved"])


def test_dcp_retention_meta_and_payload(tmp_path):
    """As tests/test_orbax_io.py: the newest max_to_keep steps stay, the meta
    peek, and the target-free payload is the msgpack payload of the state."""
    model = tm.CondUNetTiny(**KW)
    tx = Optimizer(1e-3, clip_grad_norm=1.0)
    state = create_train_state(model, tx, ema=True)
    p = tmp_path / "ckpt.orbax"
    with orbax_io.ShardedCheckpointManager(p, max_to_keep=2) as mgr:
        for step in (1, 2, 3):
            state.step = step
            mgr.save(step, state, tx, {"epoch_next": step, "loss_hist": [1.0] * step,
                                       "config": {"base_ch": 8}})
        assert mgr.latest_step() == 2  # step 3 commits at wait(), the durability barrier
        mgr.wait()
        assert mgr.latest_step() == 3
    assert orbax_io.is_orbax_checkpoint(p)
    assert sorted(c.name for c in p.iterdir()) == ["2", "3"]
    assert orbax_io.load_orbax_meta(p)["epoch_next"] == 3
    assert orbax_io.load_orbax_meta(p, step=2)["loss_hist"] == [1.0, 1.0]
    payload = orbax_io.load_orbax_payload(p)
    want = train_state_to_checkpoint(state, tx)
    assert payload["config"] == {"base_ch": 8} and payload["epoch_next"] == 3
    assert set(payload["state"]["opt_state"]) == {"0", "1"}  # the clipped chain's layout
    for a, b in zip(jax.tree.leaves(payload["state"]), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not orbax_io.is_orbax_checkpoint(tmp_path / "missing")


def test_a_jax_orbax_directory_is_refused_naming_the_difference(tmp_path):
    from toycrystals_tpu.utils import ShardedCheckpointManager as JaxManager

    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, _unet_params(0)),
                                    optax.adam(1e-3), ema=True)
    with JaxManager(tmp_path / "j.orbax") as mgr:
        mgr.save(1, jstate, {"epoch_next": 1, "loss_hist": [], "config": {}})
    for fn in (orbax_io.load_orbax_payload, orbax_io.load_orbax_meta):
        with pytest.raises(NotImplementedError, match="JAX package.*deliberate difference"):
            fn(tmp_path / "j.orbax")
