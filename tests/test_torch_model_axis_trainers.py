"""The "model" axis in the VAE and prior trainers, and 2-D weight sharding
(FSDP2 on a ("data", "model") mesh) in all three trainers, against the JAX
package on the CPU and against the port's own one-process runs.

Small sizes: CondVAE at 64x64 (the architecture fixes it), batch 8, z 8; the
FiLM prior at width 32 with 2 blocks and the MoE prior with 4 experts, batch
8, T 50; CondUNetTiny at base_ch 16, 16x16, batch 4. The flax trees come
through the weight bridge (utils/params.py), not a jitted `init`.

- In process: the model rule (`tp_sharding`, `tp_coverage`) and the 2-D rule
  (`fsdp_sharding` with the "model" dim excluded, `fsdp_coverage`) on the four
  models, leaf by leaf against JAX's `tp_sharding` and `fsdp_sharding` on
  `make_mesh_tp(2, 2)`.
- One 4-rank gloo job (`parallel.multihost.launch` of
  `parallel.parity.run_cases`) on ("data", "model") meshes of (1, 4) and (2, 2),
  and (2, 2) under FSDP2 (the 2-D placement): one step of the VAE, the FiLM
  prior and the MoE prior on injected draws, with global-norm clipping
  (each leaf's square summed over the axes that hold its pieces), against
  JAX's one-device step (optax's clip_by_global_norm and Adam) and against
  one process: the loss to 1e-5 relative; every gradient and Adam's first
  moment to rtol 1e-4, atol 1e-6; the parameters after Adam to rtol 1e-4,
  atol 1e-6 wherever the first moment is at least 1e-3 of its leaf's largest
  entry (Adam's first step moves every other entry by lr times the sign of a
  gradient that rounding may flip: 2 lr apart); the MoE route fractions to
  1e-6. The one-process runs are held at tests/test_torch_tensor_parallel.py's
  limits. The SDE step under FSDP2 on (2, 2) against one process, JAX's
  one-device step and JAX's `shard_params_fsdp(make_mesh_tp(2, 2), ...)` step
  (its loss and its gradients: on this mesh JAX's 2-D step agrees with its
  one-device step, unlike its FSDP step on a ("data", "space") mesh, F6).
  The 2-D shards, the `Block` tags through FSDP2's swaps of the parameters,
  msgpack bytes (one process's, byte for byte) and DCP (a 2-D save restored
  on (2, 2), on (1, 4) and in one process).
- The CLIs on the CPU in spawned ranks: `train_vae --shard-model 2`,
  `train_vae --shard 2 --shard-model 2 --fsdp` then `--resume`,
  `train_diffusion_prior --shard-model 2` (FiLM and MoE) and `--shard 2
  --shard-model 2 --fsdp`, `train_sde_score_model --shard 2 --shard-model 2
  --fsdp`, each against one process, their checkpoints read by the JAX
  package's loader; JAX's exclusions of the prior's ways to split.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_prior import _jax_sched
from test_torch_vae_train import _injected

from toycrystals_torch.models import diffusion_prior as tdp
from toycrystals_torch.models import moe_prior as tmoe
from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.models import vae as tv
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.parallel import launch
from toycrystals_torch.parallel import tensor as ttp
from toycrystals_torch.parallel.fsdp import fsdp_coverage, fsdp_sharding, param_layouts
from toycrystals_torch.parallel.parity import cli_state, run_cases
from toycrystals_torch.utils import params as tpar
from toycrystals_tpu.models import diffusion_prior as jdp
from toycrystals_tpu.models import moe_prior as jmoe
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.models import vae as jv
from toycrystals_tpu.parallel import data_sharding, make_mesh_tp, shard_params_fsdp
from toycrystals_tpu.parallel import fsdp as jfsdp
from toycrystals_tpu.parallel import tensor as jtp
from toycrystals_tpu.train.state import create_train_state as jax_create_train_state
from toycrystals_tpu.train.steps import make_prior_train_step as jax_make_prior_train_step
from toycrystals_tpu.train.steps import make_sde_train_step as jax_make_sde_train_step
from toycrystals_tpu.train.steps import make_vae_train_step as jax_make_vae_train_step

B, Z, T = 8, 8, 50
VAE_KW = dict(z_dim=Z, cond_drop=0.5)
FILM_KW = dict(z_dim=Z, n_types=4, y_cont_dim=4, t_emb_dim=16, width=32, n_blocks=2,
               y_cat_emb_dim=8)
MOE_KW = dict(FILM_KW, n_experts=4)
UNET_KW = dict(n_types=4, y_cont_dim=4, base_ch=16, emb_dim=16)
SIZE, SB = 16, 4
LR, CLIP, AUX, DECAY = 1e-3, 0.05, 0.5, 0.9
MESHES = {"1x4": dict(mesh=[1, 4, "model"]), "2x2": dict(mesh=[2, 2, "model"]),
          "2x2_fsdp": dict(mesh=[2, 2, "model"], fsdp=True)}
NETS = ("vae", "film", "moe")
LOSS_RTOL, LEAF, FLOOR = 1e-6, 1e-5, 1e-6
JAX_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in-process, as each spawned rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_model(net):
    return {"vae": lambda: tv.CondVAE(**VAE_KW),
            "film": lambda: tdp.DiffusionPriorFiLM(**FILM_KW),
            "moe": lambda: tmoe.DiffusionPriorMoE(**MOE_KW),
            "unet": lambda: tm.CondUNetTiny(**UNET_KW)}[net]()


BRIDGE = {"vae": tpar.VAE, "film": tpar.PRIOR, "moe": tpar.PRIOR, "unet": tpar.UNET}


def _state_dict(net, seed):
    model = flax_default_init(_torch_model(net), np.random.default_rng(seed))
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _keep_grads():
    """An optax stage whose state is the gradient it passes on."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def _jtx(clip):
    return optax.chain(_keep_grads(), *([optax.clip_by_global_norm(clip)] if clip else []),
                       optax.adam(LR))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_out(net, jstate, loss):
    """The JAX step's loss, gradients, first moment and parameters, in torch
    state_dict keys."""
    to_torch = BRIDGE[net][0]
    adam = jstate.opt_state[-1][0]
    return {"loss": float(loss), "grads": to_torch(_np(jstate.opt_state[0])),
            "mu": to_torch(_np(adam.mu)), "params": to_torch(_np(jstate.params))}


# ---------------------------------------------------------------------------
# the cases and JAX's one-device steps
# ---------------------------------------------------------------------------


def _vae_case(seed):
    sd = _state_dict("vae", seed)
    r = np.random.default_rng(seed + 1)
    x = r.uniform(size=(B, 64, 64, 1)).astype(np.float32)
    yc, yv = r.integers(0, 4, B).astype(np.int32), r.normal(size=(B, 4)).astype(np.float32)
    eps = r.normal(size=(B, Z)).astype(np.float32)
    keep = (r.uniform(size=(B, 1)) > 0.5).astype(np.float32)
    beta, fb = 3e-4 * 2 / 5, 0.05
    case = dict(kind="vae", model=VAE_KW, state_dict=sd, x=x, y_cat=yc, y_cont=yv, eps=eps,
                keep=keep, beta_eff=beta, free_bits=fb, opt={"lr": LR, "clip": CLIP})
    tx = _jtx(CLIP)
    jmodel = _injected(jv.CondVAE, jnp.asarray(eps), jnp.asarray(keep))(**VAE_KW)
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, tpar.VAE[1](sd)), tx)
    jstate, m = jax_make_vae_train_step(jmodel, tx, fb)(
        jstate, jnp.asarray(x), jnp.asarray(yc), jnp.asarray(yv), jnp.float32(beta),
        jax.random.key(0))
    return case, _jax_out("vae", jstate, m["loss"])


def _prior_case(net, seed):
    sd = _state_dict(net, seed)
    js, _ = _jax_sched()
    r = np.random.default_rng(seed + 1)
    z0n = r.normal(size=(B, Z)).astype(np.float32)
    yc, yv = r.integers(0, 4, B).astype(np.int32), r.uniform(0, 1, (B, 4)).astype(np.float32)
    aux = AUX if net == "moe" else 0.0
    key = jax.random.key(seed + 2)
    k_t, k_eps = jax.random.split(key)
    u = jax.random.uniform(k_t, (B,))
    t = np.asarray(jnp.clip((u**2 * T).astype(jnp.int32), 0, T - 1))
    eps = np.asarray(jax.random.normal(k_eps, (B, Z), jnp.float32))
    case = dict(kind="prior", model=MOE_KW if net == "moe" else FILM_KW, state_dict=sd,
                betas=np.asarray(js.betas), alpha_bars=np.asarray(js.alpha_bars), z0n=z0n,
                y_cat=yc, y_cont=yv, t=t, eps=eps, aux_weight=aux,
                opt={"lr": LR, "clip": CLIP})
    tx = _jtx(CLIP)
    jnet = jmoe.DiffusionPriorMoE(**MOE_KW) if net == "moe" else jdp.DiffusionPriorFiLM(**FILM_KW)
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, tpar.PRIOR[1](sd)), tx)
    jstate, m = jax_make_prior_train_step(jnet, tx, T, aux_weight=aux)(
        jstate, js, jnp.asarray(z0n), jnp.asarray(yc), jnp.asarray(yv), key)
    out = _jax_out(net, jstate, m["loss"])
    if net == "moe":  # the route fractions of the updated prior at the step's z_t
        z_t = js.q_sample(jnp.asarray(z0n), jnp.asarray(t), jnp.asarray(eps))
        _, cols = jnet.apply({"params": jstate.params}, z_t, jnp.asarray(t), jnp.asarray(yc),
                             jnp.asarray(yv), mutable=["intermediates"])
        out["route_fraction"] = [np.asarray(cols["intermediates"][f"block_{i}"]
                                            ["route_fraction"][0])
                                 for i in range(MOE_KW["n_blocks"])]
    return case, out


def _sde_case(seed):
    """One SDE step on JAX's draws (p_uncond 0.5, EMA 0.9): JAX's one-device
    step and its 2-D FSDP step on make_mesh_tp(2, 2), the gradients kept."""
    sd = _state_dict("unet", seed)
    r = np.random.default_rng(seed + 1)
    x0 = r.uniform(size=(SB, SIZE, SIZE, 1)).astype(np.float32)
    y_cat, y_cont = r.integers(0, 4, SB).astype(np.int32), r.normal(size=(SB, 4)).astype(np.float32)
    key = jax.random.key(seed + 2)
    t, eps, yc, yv = jm.draw_diffusion_loss_noise(jnp.asarray(x0), jnp.asarray(y_cat),
                                                  jnp.asarray(y_cont), key, 4, 0.5)
    case = dict(kind="sde", model=UNET_KW, state_dict=sd, opt={"lr": LR, "ema": DECAY},
                x0=x0[None], y_cat=np.array(yc)[None], y_cont=np.array(yv)[None],
                t=np.array(t)[None], eps=np.array(eps)[None])
    out = {}
    for name, mesh in (("one", None), ("fsdp_2x2", make_mesh_tp(2, 2))):
        tx = _jtx(0.0)
        state = jax_create_train_state(jax.tree.map(jnp.asarray, tpar.UNET[1](sd)), tx, ema=True)
        args = (x0, y_cat, y_cont)
        if mesh is not None:
            state = shard_params_fsdp(mesh, state)
            args = tuple(jax.device_put(a, data_sharding(mesh, a.ndim)) for a in args)
        step = jax_make_sde_train_step(jm.CondUNetTiny(**UNET_KW), tx, jm.VPSDE(0.1, 30.0), 4,
                                       0.5, 1.0, DECAY)
        state, loss = step(state, *args, key)
        out[name] = _jax_out("unet", state, loss)
    return case, out


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    cases, jax_out = {}, {}
    base = {"vae": _vae_case(1)}
    for i, net in enumerate(("film", "moe")):
        base[net] = _prior_case(net, 10 + 10 * i)
    for net, (case, want) in base.items():
        jax_out[net] = want
        for name, placement in MESHES.items():
            cases[f"{net}_{name}"] = dict(case, **placement)
    # the non-finite check's collectives over both axes of the 2-D placement
    cases["vae_2x2_fsdp"]["opt"] = dict(cases["vae_2x2_fsdp"]["opt"], skip=1)
    sde, jax_out["sde"] = _sde_case(31)
    # the clip norm over every kind of leaf (whole, "data", "model", both)
    cases["sde_2x2_fsdp"] = dict(sde, opt=dict(sde["opt"], clip=CLIP), **MESHES["2x2_fsdp"])
    for net, seed in (("vae", 41), ("prior", 42), ("moe", 43), ("unet", 44)):
        kw = {"vae": VAE_KW, "prior": FILM_KW, "moe": MOE_KW, "unet": UNET_KW}[net]
        case = dict(kind="msgpack", net="prior" if net == "moe" else net, model=kw,
                    state_dict=_state_dict("film" if net == "prior" else net, seed), seed=seed,
                    opt={"lr": LR})
        cases[f"msgpack_{net}"] = dict(case, **MESHES["2x2_fsdp"])
    cases["msgpack_unet_1x4"] = dict(cases["msgpack_unet"], **MESHES["1x4"])
    d = tmp_path_factory.mktemp("dcp")
    for net in ("unet", "vae"):
        kw = {"model": UNET_KW if net == "unet" else VAE_KW, "net": net,
              "state_dict": _state_dict(net, 45), "path": str(d / net), "fsdp": True}
        cases[f"dcp_save_{net}"] = dict(kw, kind="dcp_save", seed=9, mesh=[2, 2, "model"])
        cases[f"dcp_load_{net}"] = dict(kw, kind="dcp_load", mesh=[2, 2, "model"])
    cases["dcp_load_unet_1x4"] = dict(cases["dcp_load_unet"], fsdp=False, **MESHES["1x4"])
    return {"cases": cases, "jax": jax_out}


@pytest.fixture(scope="module")
def four_ranks(suite):
    names = list(suite["cases"])
    out = launch(run_cases, 4, ({"device": "cpu", "cases": list(suite["cases"].values())},),
                 timeout=600)
    return [dict(zip(names, rank)) for rank in out]


@pytest.fixture(scope="module")
def one_process(suite):
    c = suite["cases"]
    cases = {net: c[f"{net}_2x2"] for net in NETS}
    cases.update(sde=c["sde_2x2_fsdp"], dcp_load_unet=c["dcp_load_unet"],
                 dcp_load_vae=c["dcp_load_vae"],
                 **{k: c[k] for k in c if k.startswith("msgpack_") and not k.endswith("1x4")})
    cases = {k: dict(v, mesh=None, fsdp=False) for k, v in cases.items()}
    return dict(zip(cases, run_cases({"device": "cpu", "cases": list(cases.values())})))


def _loss(res):
    return float(np.asarray(res["metrics"]["loss"])) if "metrics" in res else res["losses"][0]


def _hold_grads(got, want, what):
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        lim = LEAF * float(np.abs(w).max()) + FLOOR * top + 1e-12
        np.testing.assert_allclose(got[k], w, rtol=0, atol=lim, err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# (a) the rules, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", ["vae", "film", "moe", "unet"])
def test_model_rule_and_2d_rule_are_jax_leaf_by_leaf(net):
    """Each leaf, on its flax shape: the port shards along "model" where JAX's
    `tp_sharding` does, and along "data" (the model dim excluded) where JAX's
    `fsdp_sharding` on make_mesh_tp(2, 2) does; both coverages are JAX's."""
    model = _torch_model(net)
    mesh = make_mesh_tp(2, 2)
    for key, p, order in param_layouts(model):
        shape = tuple(int(p.shape[d]) for d in order)  # the flax layout
        spec = tuple(jfsdp.fsdp_sharding(mesh, shape).spec)
        spec += (None,) * (len(shape) - len(spec))
        want_tp = not jtp.tp_sharding(mesh, shape).is_fully_replicated
        dim = ttp.tp_sharding(2, tuple(p.shape), order)
        assert (dim is not None) == want_tp == ("model" in spec), key
        want_data = [order[i] for i, s in enumerate(spec) if s == "data"]
        got_data = fsdp_sharding(2, tuple(p.shape), order, model=2)
        assert ([] if got_data is None else [got_data]) == want_data, key
    flax = BRIDGE[net][1]({k: v.detach().numpy() for k, v in model.state_dict().items()})
    assert ttp.tp_coverage(2, model) == jtp.tp_coverage(mesh, flax)
    assert fsdp_coverage(2, model, 2) == jfsdp.fsdp_coverage(mesh, flax)


# ---------------------------------------------------------------------------
# (b), (c) the steps
# ---------------------------------------------------------------------------


def _hold_jax(got, want, what):
    np.testing.assert_allclose(_loss(got), want["loss"], rtol=1e-5, err_msg=what)
    for part in ("grads", "mu"):
        assert set(got[part]) == set(want[part])
        for k, w in want[part].items():
            np.testing.assert_allclose(got[part][k], w, **JAX_TOL, err_msg=f"{what} {part} {k}")
    for k, w in want["params"].items():
        mu = np.abs(want["mu"][k])
        keep = mu >= 1e-3 * max(float(mu.max()), 1e-30)
        np.testing.assert_allclose(got["params"][k][keep], w[keep], **JAX_TOL,
                                   err_msg=f"{what} params {k}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("net", NETS)
def test_step_matches_jax_one_device(suite, four_ranks, net, mesh):
    _hold_jax(four_ranks[0][f"{net}_{mesh}"], suite["jax"][net], f"{net} {mesh}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("net", NETS)
def test_step_matches_one_process(four_ranks, one_process, net, mesh):
    got, want = four_ranks[0][f"{net}_{mesh}"], one_process[net]
    np.testing.assert_allclose(_loss(got), _loss(want), rtol=LOSS_RTOL)
    for part in ("grads", "mu"):
        _hold_grads(got[part], want[part], f"{net} {mesh} {part}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_route_fractions_are_the_global_batch_s(suite, four_ranks, one_process, mesh):
    for rank in four_ranks:
        got = rank[f"moe_{mesh}"]["route_fraction"]
        for g, o, w in zip(got, one_process["moe"]["route_fraction"],
                           suite["jax"]["moe"]["route_fraction"]):
            np.testing.assert_allclose(g, o, rtol=0, atol=1e-6)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_every_model_rank_holds_the_same_whole_state(four_ranks):
    for name in [n for n in four_ranks[0] if n.split("_")[0] in (*NETS, "sde")]:
        for other in four_ranks[1:]:
            for part in ("params", "grads", "mu", "nu"):
                for k, v in other[name][part].items():
                    np.testing.assert_array_equal(v, four_ranks[0][name][part][k],
                                                  err_msg=f"{name} {part} {k}")


def test_sde_2d_step_matches_one_process_and_jax(suite, four_ranks, one_process):
    """Under FSDP2 on (2, 2), with clipping: one process leaf by leaf
    (gradients and the clipped first moment); JAX's one-device step's and
    JAX's own 2-D step's loss and gradients (each leaf 1e-5 + 2e-3 of its
    largest entry, tests/test_torch_tensor_parallel.py's JAX limit)."""
    got, want = four_ranks[0]["sde_2x2_fsdp"], one_process["sde"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    _hold_grads(got["grads"], want["grads"], "sde 2-D")
    _hold_grads(got["mu"], want["mu"], "sde 2-D first moment")
    for name in ("one", "fsdp_2x2"):
        jax_want = suite["jax"]["sde"][name]
        np.testing.assert_allclose(got["losses"][0], jax_want["loss"], rtol=1e-5)
        for k, w in jax_want["grads"].items():
            lim = 1e-5 + 2e-3 * max(float(np.abs(w).max()), 1e-3)
            np.testing.assert_allclose(got["grads"][k], w, rtol=0, atol=lim,
                                       err_msg=f"{name} {k}")


def test_each_rank_holds_its_2d_shard(four_ranks):
    """Rank d 2 + m holds, of every leaf, block m of the model rule and, of
    that, piece d of the 2-D rule's "data" dim."""
    model = _torch_model("unet")
    for rank, res in enumerate(four_ranks):
        got = res["sde_2x2_fsdp"]
        d, m = divmod(rank, 2)
        for k, p, order in param_layouts(model):
            whole = torch.from_numpy(got["params"][k])
            dim = ttp.tp_sharding(2, tuple(p.shape), order)
            block = whole if dim is None else ttp.take_block(
                whole, ttp.Block(None, 2, m, dim, 3 if k.startswith("attn.qkv") else 1))
            cut = fsdp_sharding(2, tuple(p.shape), order, model=2)
            want = block if cut is None else block.chunk(2, dim=cut)[d]
            np.testing.assert_array_equal(got["shards"][k], want.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# (d) the Block tags through FSDP2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["vae_2x2_fsdp", "film_2x2_fsdp", "moe_2x2_fsdp",
                                  "sde_2x2_fsdp", "vae_2x2"])
def test_block_tags_survive_fsdp2(four_ranks, name):
    """Every leaf the rule shards: the state's parameter, moments and EMA carry
    its Block, and in the forward the ops found the module's Block beside a
    plain (gathered over "data") parameter of the block's shape."""
    net = {"vae": "vae", "film": "film", "moe": "moe", "sde": "unet"}[name.split("_")[0]]
    model = _torch_model(net)
    for rank, res in enumerate(four_ranks):
        tags = res[name]["tags"]
        for k, p, order in param_layouts(model):
            dim = ttp.tp_sharding(2, tuple(p.shape), order)
            want = None if dim is None else [dim, 3 if k.startswith("attn.qkv") else 1, 2,
                                             rank % 2]
            for part in ("params", "mu", "nu"):
                assert tags[part][k] == want, (part, k)
            if net == "unet":
                assert tags["ema"][k] == want, k
            if want is not None:
                live = tags["live"][k]
                shape = list(p.shape)
                shape[dim] //= 2
                assert live == {"shape": shape, "dtensor": False, "block": want}, k
        assert set(tags["live"]) == {k for k, p, o in param_layouts(model)
                                     if ttp.tp_sharding(2, tuple(p.shape), o) is not None}


# ---------------------------------------------------------------------------
# (e) msgpack and DCP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", ["vae", "prior", "moe", "unet", "unet_1x4"])
def test_msgpack_is_one_process_bytes(four_ranks, one_process, net):
    """The JAX checkpoint's `state` of a placed state (its moments and EMA
    filled with values of their own), gathered over "data" and "model": the
    bytes one process writes for the same state."""
    want = one_process[f"msgpack_{net.removesuffix('_1x4')}"]["bytes"]
    for rank in four_ranks:
        assert rank[f"msgpack_{net}"]["bytes"] == want


def _state_equal(got, want, what):
    for part in ("params", "mu", "nu", "ema"):
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=f"{what} {part} {k}")
    assert (got["step"], got["count"]) == (want["step"], want["count"]) == (7, 5)


@pytest.mark.parametrize("net", ["unet", "vae"])
def test_dcp_2d_save_restores_on_the_mesh_and_in_one_process(four_ranks, one_process, net):
    saved = four_ranks[0][f"dcp_save_{net}"]
    for rank in four_ranks:
        _state_equal(rank[f"dcp_load_{net}"], saved, f"{net} on (2, 2)")
        if net == "unet":
            _state_equal(rank["dcp_load_unet_1x4"], saved, "on (1, 4), model axis alone")
    _state_equal(one_process[f"dcp_load_{net}"], saved, f"{net} in one process")


def test_the_cpu_runs_launched_no_kernel(four_ranks):
    for name, res in four_ranks[0].items():
        assert not any(res["launches"].values()), (name, res["launches"])


# ---------------------------------------------------------------------------
# (f) the CLIs
# ---------------------------------------------------------------------------

VAE_CLI = ["--device", "cpu", "--procedural", "--n-samples", "16", "--batch-size", "8",
           "--z-dim", "8", "--lr", "5e-4", "--clip-grad-norm", "1.0"]
PRIOR_CLI = ["--device", "cpu", "--procedural", "--max-items", "32", "--z-dim", "8",
             "--width", "32", "--T", "50", "--batch-size", "8", "--epochs", "1",
             "--ddim-steps", "2", "--sample-every", "0"]
SDE_CLI = ["--device", "cpu", "--procedural", "--img-size", "16", "--base-ch", "8",
           "--emb-dim", "16", "--n-samples", "16", "--batch-size", "8", "--sample-every", "0",
           "--ema-decay", "0.9", "--p-uncond", "0.5", "--clip-grad-norm", "0.5"]


def _vae_losses(run_dir):
    from toycrystals_torch.utils.checkpoint import load_checkpoint

    raw = load_checkpoint(str(run_dir / "checkpoints" / "vae_last.msgpack"))
    return [raw["hists"]["loss"][str(i)] for i in range(len(raw["hists"]["loss"]))]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One process and the meshes, each CLI: the VAE for 2 epochs (one
    process), 1 epoch under --shard-model 2, 1 epoch under --shard 2
    --shard-model 2 --fsdp then --resume to 2; the priors (FiLM and MoE) for
    one epoch on the one-process VAE's latents, in this process and in the
    mesh's ranks (`cli_state`: each rank's losses and its state after, whole);
    the SDE trainer for one epoch."""
    from toycrystals_torch.scripts import train_diffusion_prior as prior_cli
    from toycrystals_torch.scripts import train_sde_score_model as sde_cli
    from toycrystals_torch.scripts import train_vae as vae_cli

    base = tmp_path_factory.mktemp("model_axis_cli")
    runs = {"vae_one": vae_cli.train(VAE_CLI + ["--epochs", "2", "--out-dir",
                                                str(base / "vae_one")]).hists["loss"]}
    assert vae_cli.main(VAE_CLI + ["--epochs", "1", "--shard-model", "2",
                                   "--out-dir", str(base / "vae_tp")]) == 0
    two_d = ["--shard", "2", "--shard-model", "2", "--fsdp", "--out-dir", str(base / "vae_2d")]
    assert vae_cli.main(VAE_CLI + two_d + ["--epochs", "1"]) == 0
    assert vae_cli.main(VAE_CLI + two_d + ["--epochs", "2", "--resume"]) == 0
    prior = PRIOR_CLI + ["--vae-ckpt", str(base / "vae_one" / "checkpoints" / "vae_last.msgpack"),
                         "--latent-cache", str(base / "latents.npz")]
    for kind, extra in (("film", []), ("moe", ["--moe-experts", "4"])):
        runs[f"{kind}_one"] = cli_state(prior_cli.train,
                                        prior + extra + ["--out-dir", str(base / f"{kind}_one")])
        runs[f"{kind}_tp"] = launch(cli_state, 2, (prior_cli.train, prior + extra + [
            "--shard-model", "2", "--out-dir", str(base / f"{kind}_tp")]), timeout=600)
    runs["film_2d"] = launch(cli_state, 4, (prior_cli.train, prior + [
        "--shard", "2", "--shard-model", "2", "--fsdp", "--out-dir", str(base / "film_2d")]),
        timeout=600)
    runs["sde_one"] = sde_cli.train(SDE_CLI + ["--epochs", "1", "--out-dir",
                                               str(base / "sde_one")]).loss_hist
    assert sde_cli.main(SDE_CLI + ["--epochs", "1", "--shard", "2", "--shard-model", "2",
                                   "--fsdp", "--out-dir", str(base / "sde_2d")]) == 0
    return base, runs


def test_vae_cli_with_shard_model_trains_the_one_process_epoch(cli_runs):
    base, runs = cli_runs
    np.testing.assert_allclose(_vae_losses(base / "vae_tp"), runs["vae_one"][:1], rtol=1e-5)


def test_vae_cli_2d_resumes_and_trains_the_one_process_epochs(cli_runs):
    base, runs = cli_runs
    np.testing.assert_allclose(_vae_losses(base / "vae_2d"), runs["vae_one"], rtol=1e-5)
    assert sorted(p.name for p in (base / "vae_2d" / "results").iterdir()) == [
        "vae_recon.png", "vae_samples_mop.png", "vae_samples_prior.png"]


def _prior_ckpt(run_dir):
    """The prior CLI keeps no loss on disk: its checkpoint (read by the JAX
    package's loader) stands for the epoch."""
    from toycrystals_tpu.utils.checkpoint import load_checkpoint as jax_load

    return jax_load(str(run_dir / "checkpoints" / "diffusion_prior_last.msgpack"))


PRIOR_CLI_STEPS, PRIOR_CLI_LR = 4, 1e-4  # 32 items at batch 8; the CLI's default lr


@pytest.mark.parametrize("run", ["film_tp", "moe_tp", "film_2d"])
def test_prior_cli_on_a_model_mesh_writes_the_one_process_weights(cli_runs, run):
    """One epoch (4 Adam steps at lr 1e-4, no clipping) on every rank of the
    mesh against one process: the epoch's loss to LOSS_RTOL; Adam's first
    moment leaf by leaf at `_hold_grads`' limits; the parameters to JAX_TOL
    wherever the one-process first moment is at least 1e-3 of its leaf's
    largest entry, and elsewhere to 2 lr a step (Adam moves an entry whose
    gradient is near zero by lr times a sign that rounding may flip). Each
    checkpoint, read by the JAX package's loader, holds its run's parameters
    bit for bit."""
    base, runs = cli_runs
    kind = run.split("_")[0]
    want = runs[f"{kind}_one"]
    for rank, got in enumerate(runs[run]):
        what = f"{run} rank {rank}"
        assert len(got["losses"]) == 1, what
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL, err_msg=what)
        _hold_grads(got["mu"], want["mu"], f"{what} first moment")
        assert set(got["params"]) == set(want["params"]), what
        for k, w in want["params"].items():
            mu = np.abs(want["mu"][k])
            keep = mu >= 1e-3 * max(float(mu.max()), 1e-30)
            np.testing.assert_allclose(got["params"][k][keep], w[keep], **JAX_TOL,
                                       err_msg=f"{what} params {k}")
            np.testing.assert_allclose(got["params"][k], w, rtol=0,
                                       atol=2 * PRIOR_CLI_LR * PRIOR_CLI_STEPS,
                                       err_msg=f"{what} params {k}")
    for name, res in ((run, runs[run][0]), (f"{kind}_one", want)):
        ckpt = _prior_ckpt(base / name)
        assert ckpt["config"] == _prior_ckpt(base / f"{kind}_one")["config"]
        for k, v in tpar.PRIOR[0](jax.tree.map(np.asarray, ckpt["params"])).items():
            np.testing.assert_array_equal(v, res["params"][k], err_msg=f"{name} checkpoint {k}")


def test_sde_cli_2d_trains_the_one_process_epoch(cli_runs):
    base, runs = cli_runs
    rows = [json.loads(line) for line in (base / "sde_2d" / "metrics.jsonl").read_text()
            .splitlines()]
    np.testing.assert_allclose([r["loss"] for r in rows], runs["sde_one"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("run", ["vae_tp", "vae_2d", "sde_2d"])
def test_cli_checkpoints_are_read_by_the_jax_loader(cli_runs, run):
    """The msgpack a mesh run writes: the JAX package's loader reads the
    state one process writes (keys, shapes, dtypes of the parameters and the
    optimizer's state; the histories differ in length where the epochs do)."""
    from toycrystals_tpu.utils.checkpoint import load_checkpoint as jax_load

    base, _ = cli_runs
    name = "vae_last.msgpack" if run.startswith("vae") else "sde_score_model_last.msgpack"
    got = jax_load(str(base / run / "checkpoints" / name))
    want = jax_load(str(base / f"{run.split('_')[0]}_one" / "checkpoints" / name))
    assert got["config"] == want["config"]
    keys = ("params", "opt_state") if run.startswith("vae") else ("state",)
    g, w = (jax.tree_util.tree_leaves_with_path({k: tree[k] for k in keys})
            for tree in (got, want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert np.shape(a) == np.shape(b) and np.asarray(a).dtype == np.asarray(b).dtype, path


@pytest.mark.parametrize("flags, message", [
    (["--shard-expert", "2", "--shard-model", "2"], "--shard-expert and --shard-model"),
    (["--shard-pipe", "2", "--shard-model", "2"], "--shard-pipe and --shard-model"),
    (["--shard-expert", "2", "--shard-pipe", "2"], "--shard-expert and --shard-pipe"),
])
def test_prior_exclusions_are_jax_s(tmp_path, flags, message):
    from toycrystals_torch.scripts import train_diffusion_prior as prior_cli

    with pytest.raises(SystemExit, match=f"{message} are mutually exclusive"):
        prior_cli.train(["--device", "cpu", "--out-dir", str(tmp_path), *flags])


def test_the_2d_placement_is_printed_as_jax_prints_it(monkeypatch, capsys):
    """The trainers' `place_state` on (2, 2) under --fsdp for the prior:
    JAX's fsdp line with the 2-D rule's coverage, then its tensor-parallel
    line (no warning naming --width: 100% sharded)."""
    import toycrystals_torch.parallel as par
    from toycrystals_torch.scripts._common import place_state

    class Mesh:  # what the printing reads of a ("data", "model") mesh of 2 x 2
        mesh_dim_names, ndim = ("data", "model"), 2

        def size(self, dim=None):
            return 4 if dim is None else 2

    calls = []
    monkeypatch.setattr(par, "place_state", lambda *a: calls.append(a) or (a[1], a[2]))
    model = _torch_model("film")
    place_state(Mesh(), model, None, fsdp=True, what="--width")
    assert capsys.readouterr().out.splitlines() == [
        f"fsdp: {fsdp_coverage(2, model, 2):.0%} of param elements sharded over 'data'",
        "tensor parallelism: 100% of param elements sharded"]
    assert calls[0][3] is True
