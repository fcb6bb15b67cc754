"""The prior's pipeline axis (--shard-pipe / --pipe-micro) and expert axis
(--shard-expert), against the JAX package on the CPU and against the port's
own one-process runs; the mirror of tests/test_pipeline.py and
tests/test_expert_parallel.py.

Small sizes: the FiLM prior at width 32 with 8 blocks (S = 4 splits them 2 a
stage), the MoE prior with 4 experts and 2 blocks, batch 16, z 8, T 8. The
flax trees come through the weight bridge (utils/params.py), not a jitted
`init`.

- In process: JAX's stacking of the blocks [S, L / S, ...] and back, and its
  refusal to split 8 blocks 3 ways; the expert rule and its coverage, leaf by
  leaf against JAX's `expert_sharding` / `ep_coverage` on make_mesh_ep(2, 2)
  at n_types 4, y_cont_dim 4 and E 4 (the embedding, Dense_2's kernel and the
  router biases shard too) and at E 6 on make_mesh_ep(2, 4) (nothing shards).
- One 4-rank gloo job (`parallel.multihost.launch` of
  `parallel.parity.run_cases`) on ("data", "pipe") meshes (1, 4) and (2, 2)
  at 1, 2 and 4 microbatches and ("data", "expert") meshes (1, 4) and (2, 2):
  the forward, DDIM, and one Adam step with clipping on injected draws. They
  are held to JAX's one-device step at JAX's own limits (forward rtol 1e-4 /
  atol 1e-5; gradients, first moment and DDIM rtol 1e-3 / atol 1e-4; the
  parameters after Adam at the same limits where the first moment is at least
  1e-3 of its leaf's largest entry; loss 1e-5 relative), to JAX's own
  results on the 8 virtual devices at the same limits (`pipeline_apply` on
  make_mesh_pp(2, 2) at 2 microbatches; forward, DDIM and step under
  `place_expert_state` on make_mesh_ep(2, 2)), and to the
  port's one process at tests/test_torch_model_axis_trainers.py's limits
  (loss 1e-5 relative; gradients and the first moment rtol 1e-4 / atol 1e-6;
  the parameters after Adam at rtol 1e-4 / atol 1e-6 where the first moment is
  at least 1e-3 of its leaf's largest entry; route fractions 1e-6). Each stage
  holds only its blocks and their moments, each expert rank only its experts
  and the leaves JAX shards, and the msgpack a placed state writes is one
  process's bytes.
- The CLIs in spawned ranks: `--shard-pipe 2 --pipe-micro 4` and
  `--moe-experts 4 --shard-expert 2`, each with `--resume`, against one
  process; the JAX package's loader reads their checkpoints; JAX's refusals
  with its words.
- In process: `parity.in_turn` and `keep_copy`, which chip_smoke.py's phase
  19 spawns, and a prior drawn on its device from "init_seed".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model_axis_trainers import _jax_out, _jtx
from test_torch_prior import _jax_sched

from toycrystals_torch.models import diffusion_prior as tdp
from toycrystals_torch.models import moe_prior as tmoe
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.parallel import expert as texp
from toycrystals_torch.parallel import launch
from toycrystals_torch.parallel import pipeline as tpp
from toycrystals_torch.parallel.fsdp import param_layouts
from toycrystals_torch.parallel.parity import cli_state, cli_states, run_cases
from toycrystals_torch.utils import params as tpar
from toycrystals_tpu.models import diffusion_prior as jdp
from toycrystals_tpu.models import moe_prior as jmoe
from toycrystals_tpu.parallel import data_sharding, make_mesh_ep, make_mesh_pp
from toycrystals_tpu.parallel import expert as jexp
from toycrystals_tpu.parallel import pipeline as jpp
from toycrystals_tpu.train.state import create_train_state as jax_create_train_state
from toycrystals_tpu.train.steps import make_prior_train_step as jax_make_prior_train_step

B, Z, T, E = 16, 8, 8, 4
FILM_KW = dict(z_dim=Z, n_types=4, y_cont_dim=4, width=32, n_blocks=8)
MOE_KW = dict(FILM_KW, n_blocks=2, n_experts=E)
LR, CLIP, AUX, DDIM_STEPS = 1e-3, 0.05, 0.5, 4
MICROS = (1, 2, 4)
PIPE_MESHES = {"1x4": [1, 4, "pipe"], "2x2": [2, 2, "pipe"]}
EXPERT_MESHES = {"1x4": [1, 4, "expert"], "2x2": [2, 2, "expert"]}
PIPES = [f"{m}_m{k}" for m in PIPE_MESHES for k in MICROS]
LOSS_RTOL = 1e-5
JAX_FWD = dict(rtol=1e-4, atol=1e-5)
JAX_TOL = dict(rtol=1e-3, atol=1e-4)   # JAX's own limits: gradients, DDIM
ONE_TOL = dict(rtol=1e-4, atol=1e-6)   # tests/test_torch_model_axis_trainers.py's


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in-process, as each spawned rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_model(net):
    return tmoe.DiffusionPriorMoE(**MOE_KW) if net == "moe" else tdp.DiffusionPriorFiLM(**FILM_KW)


def _state_dict(net, seed):
    model = flax_default_init(_torch_model(net), np.random.default_rng(seed))
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _flax(sd):
    return jax.tree.map(jnp.asarray, tpar.PRIOR[1](sd))


def _jnet(net):
    return jmoe.DiffusionPriorMoE(**MOE_KW) if net == "moe" else jdp.DiffusionPriorFiLM(**FILM_KW)


# ---------------------------------------------------------------------------
# the cases, JAX's one-device results and JAX's own meshes
# ---------------------------------------------------------------------------


def _net_cases(net, seed):
    """The step (JAX's draws, injected), the forward / DDIM and the msgpack
    cases of one prior, and the inputs of JAX's results (`_jax_results`)."""
    sd = _state_dict(net, seed)
    js, _ = _jax_sched(T, 1.0)
    sched = dict(betas=np.asarray(js.betas), alpha_bars=np.asarray(js.alpha_bars))
    kw = MOE_KW if net == "moe" else FILM_KW
    r = np.random.default_rng(seed + 1)
    z0n = r.normal(size=(B, Z)).astype(np.float32)
    yc, yv = r.integers(0, 4, B).astype(np.int32), r.uniform(0, 1, (B, 4)).astype(np.float32)
    aux = AUX if net == "moe" else 0.0
    key = jax.random.key(seed + 2)
    k_t, k_eps = jax.random.split(key)
    t = np.asarray(jnp.clip((jax.random.uniform(k_t, (B,)) ** 2 * T).astype(jnp.int32), 0, T - 1))
    eps = np.asarray(jax.random.normal(k_eps, (B, Z), jnp.float32))
    step = dict(kind="prior", model=kw, state_dict=sd, z0n=z0n, y_cat=yc, y_cont=yv, t=t,
                eps=eps, aux_weight=aux, opt={"lr": LR, "clip": CLIP}, **sched)
    z_t = np.asarray(js.q_sample(jnp.asarray(z0n), jnp.asarray(t), jnp.asarray(eps)))
    k_ddim = jax.random.key(seed + 3)
    z = np.asarray(jax.random.normal(k_ddim, (B, Z), jnp.float32))  # JAX's DDIM start noise
    apply = dict(kind="prior_apply", model=kw, state_dict=sd, z_t=z_t, t=t, y_cat=yc,
                 y_cont=yv, z=z, ddim_steps=DDIM_STEPS, **sched)
    msgpack = dict(kind="msgpack", net="prior", model=kw, state_dict=sd, seed=seed + 4,
                   opt={"lr": LR})
    return {"step": step, "apply": apply, "msgpack": msgpack}, dict(
        net=net, sd=sd, js=js, args=(z_t, t, yc, yv), z0n=z0n, key=key, k_ddim=k_ddim, aux=aux)


def _jax_results(net, sd, js, args, z0n, key, k_ddim, aux):
    """JAX's one-device forward, DDIM and step (with the updated prior's route
    fractions for MoE) on `_net_cases`' inputs, and JAX's own results on its
    2 x 2 mesh: the pipelined forward at 2 microbatches (each use of JAX's
    pipeline is a compile of 10-15 s here, so the port's pipelined DDIM and
    step are held to JAX's one-device ones); the expert-parallel forward,
    DDIM and step."""
    jnet, params, tx = _jnet(net), _flax(sd), _jtx(CLIP)
    args = tuple(jnp.asarray(a) for a in args)
    z0n = jnp.asarray(z0n)

    def fwd(p, *a):
        return jnet.apply({"params": p}, *a)

    one = {"forward": np.asarray(fwd(params, *args)),
           "ddim": np.asarray(jdp.ddim_sample(fwd, params, js, args[2], args[3], DDIM_STEPS, Z,
                                              k_ddim))}
    jstate, m = jax_make_prior_train_step(jnet, tx, T, aux_weight=aux)(
        jax_create_train_state(_flax(sd), tx), js, z0n, args[2], args[3], key)
    one["step"] = _jax_out(net, jstate, m["loss"])
    if net == "moe":  # the route fractions of the updated prior at the step's z_t
        _, cols = jnet.apply({"params": jstate.params}, *args, mutable=["intermediates"])
        one["step"]["route_fraction"] = [
            np.asarray(cols["intermediates"][f"block_{i}"]["route_fraction"][0])
            for i in range(MOE_KW["n_blocks"])]
    mesh_out = {}
    if net == "film":
        mesh = make_mesh_pp(2, 2)
        stp = jpp.place_pipeline_state(mesh, jpp.stack_pipeline_params(params, 2))
        mesh_out["forward"] = np.asarray(jpp.pipeline_apply(mesh, stp, *args, n_micro=2))
        return one, mesh_out
    mesh = make_mesh_ep(2, 2)
    put = [jax.device_put(a, data_sharding(mesh, a.ndim)) for a in args]
    placed = jexp.place_expert_state(mesh, params, E)
    mesh_out["forward"] = np.asarray(fwd(placed, *put))
    mesh_out["ddim"] = np.asarray(jdp.ddim_sample(fwd, placed, js, put[2], put[3], DDIM_STEPS, Z,
                                                  k_ddim))
    state = jexp.place_expert_state(mesh, jax_create_train_state(_flax(sd), tx), E)
    assert state.params["block_0"]["w1"].addressable_shards[0].data.shape[0] == E // 2
    state, m = jax_make_prior_train_step(jnet, tx, T, aux_weight=aux)(
        state, js, *(jax.device_put(a, data_sharding(mesh, a.ndim))
                     for a in (z0n, args[2], args[3])), key)
    mesh_out["loss"], mesh_out["grads"] = float(m["loss"]), tpar.PRIOR[0](
        jax.tree.map(np.asarray, state.opt_state[0]))
    return one, mesh_out


@pytest.fixture(scope="module")
def suite():
    """Every case, then the 4-rank job started in a thread, then JAX's results
    while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    cases, inputs = {}, {}
    for net, seed in (("film", 10), ("moe", 20)):
        base, inputs[net] = _net_cases(net, seed)
        if net == "film":
            for name, mesh in PIPE_MESHES.items():
                for m in MICROS:
                    for kind in ("step", "apply"):
                        cases[f"pipe_{kind}_{name}_m{m}"] = dict(base[kind], mesh=mesh, micro=m)
                cases[f"pipe_msgpack_{name}"] = dict(base["msgpack"], mesh=mesh, micro=2)
        else:
            for name, mesh in EXPERT_MESHES.items():
                for kind in ("step", "apply", "msgpack"):
                    cases[f"expert_{kind}_{name}"] = dict(base[kind], mesh=mesh)
        for kind in ("step", "apply", "msgpack"):
            cases[f"one_{net}_{kind}"] = base[kind]
    names = [n for n in cases if not n.startswith("one_")]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, run_cases, 4,
                            ({"device": "cpu", "cases": [cases[n] for n in names]},), timeout=600)
        jax_one, jax_mesh = {}, {}
        for net in inputs:
            jax_one[net], jax_mesh[net] = _jax_results(**inputs[net])
        four = [dict(zip(names, rank)) for rank in ranks.result()]
    return {"cases": cases, "jax": jax_one, "jax_mesh": jax_mesh, "four": four}


@pytest.fixture(scope="module")
def four_ranks(suite):
    return suite["four"]


@pytest.fixture(scope="module")
def one_process(suite):
    names = [n for n in suite["cases"] if n.startswith("one_")]
    return dict(zip(names, run_cases({"device": "cpu",
                                      "cases": [suite["cases"][n] for n in names]})))


def _loss(res):
    return float(np.asarray(res["metrics"]["loss"]))


def _hold_step(got, want, tol, what):
    """Loss, gradients, first moment, and the parameters where the first
    moment is at least 1e-3 of its leaf's largest entry (Adam's first step
    moves every other entry by lr times the sign of a gradient that rounding
    may flip)."""
    np.testing.assert_allclose(_loss(got), want["loss"] if "metrics" not in want
                               else _loss(want), rtol=LOSS_RTOL, err_msg=what)
    for part in ("grads", "mu"):
        assert set(got[part]) == set(want[part]), what
        for k, w in want[part].items():
            np.testing.assert_allclose(got[part][k], w, **tol, err_msg=f"{what} {part} {k}")
    for k, w in want["params"].items():
        mu = np.abs(want["mu"][k])
        keep = mu >= 1e-3 * max(float(mu.max()), 1e-30)
        np.testing.assert_allclose(got["params"][k][keep], w[keep], **tol,
                                   err_msg=f"{what} params {k}")


# ---------------------------------------------------------------------------
# (a) the layouts and the rule, in process
# ---------------------------------------------------------------------------


def test_stack_round_trip_and_the_refusal_to_split_8_blocks_3_ways():
    flax = tpar.PRIOR[1](_state_dict("film", 1))
    got = tpar.PRIOR[0](tpp.unstack_pipeline_params(tpp.stack_pipeline_params(flax, 4)))
    want = jpp.stack_pipeline_params(_flax(_state_dict("film", 1)), 4)
    stacked = tpp.stack_pipeline_params(flax, 4)
    assert jax.tree.structure(stacked) == jax.tree.structure(jax.tree.map(np.asarray, want))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)), stacked, want)
    assert np.shape(stacked["blocks"]["fc1"]["kernel"])[:2] == (4, 2)
    for k, v in _state_dict("film", 1).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for stack in (tpp.stack_pipeline_params, jpp.stack_pipeline_params):
        with pytest.raises(ValueError, match="8 blocks not divisible into 3 stages"):
            stack(flax, 3)


@pytest.mark.parametrize("n_experts, shape", [(4, (2, 2)), (6, (2, 4))])
def test_expert_rule_and_coverage_are_jax_leaf_by_leaf(n_experts, shape):
    """Each leaf, on its flax shape, shards where JAX's `expert_sharding`
    does; at E 4 that is every expert stack and the embedding, Dense_2's
    kernel and each router bias; at E 6 over 4 ranks nothing. The coverage is
    JAX's."""
    model = tmoe.DiffusionPriorMoE(**dict(MOE_KW, n_experts=n_experts))
    mesh, n = make_mesh_ep(*shape), shape[1]
    sharded = set()
    for key, p, order in param_layouts(model):
        flax_shape = tuple(int(p.shape[d]) for d in order)
        want = not jexp.expert_sharding(mesh, flax_shape, n_experts).is_fully_replicated
        dim = texp.expert_dim(n, tuple(p.shape), order, n_experts)
        assert (dim is not None) == want, key
        if want:
            assert dim == order[0], key
            sharded.add(key)
    flax = tpar.PRIOR[1]({k: v.detach().numpy() for k, v in model.state_dict().items()})
    assert texp.ep_coverage(n, model, n_experts) == jexp.ep_coverage(mesh, flax, n_experts)
    if n_experts == 4:
        stacks = {f"blocks.{i}.{w}" for i in range(2) for w in texp.EXPERT_LEAVES}
        extra = {"y_cat_emb.weight", "y_cont_mlp.0.weight", "blocks.0.router.bias",
                 "blocks.1.router.bias"}
        assert sharded == stacks | extra
    else:
        assert not sharded and texp.ep_coverage(n, model, n_experts) == 0.0


# ---------------------------------------------------------------------------
# (b) the pipeline axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PIPES)
def test_pipe_step_matches_jax_one_device(suite, four_ranks, name):
    mesh, micro = name.split("_")
    for rank in four_ranks:
        _hold_step(rank[f"pipe_step_{mesh}_{micro}"], suite["jax"]["film"]["step"], JAX_TOL,
                   name)


@pytest.mark.parametrize("name", PIPES)
def test_pipe_step_matches_one_process(four_ranks, one_process, name):
    mesh, micro = name.split("_")
    for rank in four_ranks:
        _hold_step(rank[f"pipe_step_{mesh}_{micro}"], one_process["one_film_step"], ONE_TOL,
                   name)


@pytest.mark.parametrize("name", PIPES)
def test_pipe_forward_and_ddim_match_jax_and_one_process(suite, four_ranks, one_process, name):
    mesh, micro = name.split("_")
    want, one = suite["jax"]["film"], one_process["one_film_apply"]
    for rank in four_ranks:
        got = rank[f"pipe_apply_{mesh}_{micro}"]
        np.testing.assert_allclose(got["forward"], want["forward"], **JAX_FWD)
        np.testing.assert_allclose(got["ddim"], want["ddim"], **JAX_TOL)
        np.testing.assert_allclose(got["forward"], one["forward"], **ONE_TOL)
        np.testing.assert_allclose(got["ddim"], one["ddim"], **ONE_TOL)


def test_pipe_2x2_matches_jax_s_own_pipeline(suite, four_ranks):
    """JAX's `pipeline_apply` on make_mesh_pp(2, 2) at 2 microbatches."""
    jm = suite["jax_mesh"]["film"]
    for rank in four_ranks:
        np.testing.assert_allclose(rank["pipe_apply_2x2_m2"]["forward"], jm["forward"], **JAX_FWD)


def test_each_stage_holds_only_its_blocks_and_their_moments(four_ranks):
    """Rank d S + s holds the stem, the head and blocks [s L / S, (s + 1) L /
    S), each at its whole shape, and their first moments; nothing else."""
    model = _torch_model("film")
    whole = {k: list(p.shape) for k, p in model.named_parameters()}
    for name, mesh in PIPE_MESHES.items():
        n_pipe = mesh[1]
        per = FILM_KW["n_blocks"] // n_pipe
        for rank, res in enumerate(four_ranks):
            s = rank % n_pipe
            mine = {f"blocks.{i}." for i in range(s * per, (s + 1) * per)}
            want = {k: v for k, v in whole.items()
                    if not k.startswith("blocks.") or k[:len("blocks.0.")] in mine}
            for m in MICROS:
                held = res[f"pipe_step_{name}_m{m}"]["held"]
                assert held["params"] == want == held["mu"], (name, rank, m)


def test_every_pipe_rank_runs_every_tick(four_ranks):
    """M + S - 1 hops forward and as many back on every stage, bubbles
    included."""
    for name, mesh in PIPE_MESHES.items():
        for m in MICROS:
            for res in four_ranks:
                assert res[f"pipe_step_{name}_m{m}"]["hops"] == 2 * (m + mesh[1] - 1)


# ---------------------------------------------------------------------------
# (c) the expert axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(EXPERT_MESHES))
def test_expert_step_matches_jax_one_device(suite, four_ranks, name):
    for rank in four_ranks:
        _hold_step(rank[f"expert_step_{name}"], suite["jax"]["moe"]["step"], JAX_TOL, name)


@pytest.mark.parametrize("name", list(EXPERT_MESHES))
def test_expert_step_matches_one_process(four_ranks, one_process, name):
    for rank in four_ranks:
        _hold_step(rank[f"expert_step_{name}"], one_process["one_moe_step"], ONE_TOL, name)


@pytest.mark.parametrize("name", list(EXPERT_MESHES))
def test_expert_forward_and_ddim_match_jax_and_one_process(suite, four_ranks, one_process, name):
    want, one = suite["jax"]["moe"], one_process["one_moe_apply"]
    for rank in four_ranks:
        got = rank[f"expert_apply_{name}"]
        np.testing.assert_allclose(got["forward"], want["forward"], **JAX_FWD)
        np.testing.assert_allclose(got["ddim"], want["ddim"], **JAX_TOL)
        np.testing.assert_allclose(got["forward"], one["forward"], **ONE_TOL)
        np.testing.assert_allclose(got["ddim"], one["ddim"], **ONE_TOL)


@pytest.mark.parametrize("name", list(EXPERT_MESHES))
def test_expert_route_fractions_are_the_global_batch_s(suite, four_ranks, one_process, name):
    for rank in four_ranks:
        got = rank[f"expert_step_{name}"]["route_fraction"]
        for g, o, w in zip(got, one_process["one_moe_step"]["route_fraction"],
                           suite["jax"]["moe"]["step"]["route_fraction"]):
            np.testing.assert_allclose(g, o, rtol=0, atol=1e-6)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_expert_2x2_matches_jax_s_own_placement(suite, four_ranks):
    """JAX's `place_expert_state` on make_mesh_ep(2, 2): its forward, DDIM,
    and its step's loss and gradients."""
    jm = suite["jax_mesh"]["moe"]
    for rank in four_ranks:
        got, step = rank["expert_apply_2x2"], rank["expert_step_2x2"]
        np.testing.assert_allclose(got["forward"], jm["forward"], **JAX_FWD)
        np.testing.assert_allclose(got["ddim"], jm["ddim"], **JAX_TOL)
        np.testing.assert_allclose(_loss(step), jm["loss"], rtol=LOSS_RTOL)
        for k, w in jm["grads"].items():
            np.testing.assert_allclose(step["grads"][k], w, **JAX_TOL, err_msg=k)


def test_each_expert_rank_holds_its_experts_and_the_leaves_jax_shards(four_ranks):
    """Every leaf the rule shards is held as its rank's block of E / N along
    the leaf's flax dim 0, with its first moment and its Block (axis
    "expert"); every other leaf whole."""
    model = _torch_model("moe")
    for name, mesh in EXPERT_MESHES.items():
        n = mesh[1]
        for rank, res in enumerate(four_ranks):
            got = res[f"expert_step_{name}"]
            for k, p, order in param_layouts(model):
                dim = texp.expert_dim(n, tuple(p.shape), order, E)
                shape = list(p.shape)
                if dim is not None:
                    shape[dim] //= n
                assert got["held"]["params"][k] == shape == got["held"]["mu"][k], (name, k)
                want = None if dim is None else [dim, 1, n, rank % n]
                assert got["tags"]["params"][k] == want == got["tags"]["mu"][k], (name, k)


# ---------------------------------------------------------------------------
# (d) both
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pipe_msgpack_1x4", "pipe_msgpack_2x2", "expert_msgpack_1x4",
                                  "expert_msgpack_2x2"])
def test_msgpack_is_one_process_bytes(four_ranks, one_process, name):
    """The JAX checkpoint's `state` of a placed state (its moments and EMA
    filled with values of their own, then placed), gathered from every stage
    or expert rank: the bytes one process writes for the same state."""
    want = one_process["one_film_msgpack" if name.startswith("pipe") else "one_moe_msgpack"]
    for rank in four_ranks:
        assert rank[name]["bytes"] == want["bytes"]


def test_every_rank_ends_with_the_same_whole_state(four_ranks):
    for name in [n for n in four_ranks[0] if "_step_" in n]:
        for other in four_ranks[1:]:
            for part in ("params", "grads", "mu", "nu"):
                for k, v in other[name][part].items():
                    np.testing.assert_array_equal(v, four_ranks[0][name][part][k],
                                                  err_msg=f"{name} {part} {k}")


def test_the_cpu_runs_launched_no_kernel(four_ranks):
    for name, res in four_ranks[0].items():
        assert not any(res["launches"].values()), (name, res["launches"])


# ---------------------------------------------------------------------------
# (e) the CLI
# ---------------------------------------------------------------------------

PRIOR_CLI = ["--device", "cpu", "--procedural", "--max-items", "32", "--z-dim", "8",
             "--width", "32", "--T", "8", "--beta-end", "0.05", "--batch-size", "16",
             "--ddim-steps", "2",
             "--clip-grad-norm", "1.0"]
CLI_LR, CLI_STEPS = 1e-4, 4  # the CLI's default lr; 2 epochs of 32 items at batch 16
CLI_RUNS = {"pipe": ["--shard-pipe", "2", "--pipe-micro", "4"],
            "expert": ["--moe-experts", "4", "--shard-expert", "2"]}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each CLI for one epoch (with its DDIM grid), then --resume for one
    more, in 2 spawned ranks (`cli_states`: each rank's losses, its state,
    whole, its grid and what it printed), both meshes' ranks at once and
    beside this process's one-process runs."""
    from concurrent.futures import ThreadPoolExecutor

    from toycrystals_torch.models.vae import CondVAE
    from toycrystals_torch.scripts import train_diffusion_prior as prior_cli
    from toycrystals_torch.utils.checkpoint import save_checkpoint

    base = tmp_path_factory.mktemp("pipe_expert_cli")
    vae = flax_default_init(CondVAE(z_dim=Z, cond_drop=0.0), np.random.default_rng(0))
    save_checkpoint(base / "vae.msgpack", {"params": tpar.flax_vae_from_torch_state_dict(
        vae.state_dict())})
    common = PRIOR_CLI + ["--vae-ckpt", str(base / "vae.msgpack")]
    prior_cli.train(common + ["--epochs", "0", "--latent-cache", str(base / "latents.npz"),
                              "--out-dir", str(base / "cache")])  # the shared latent cache
    common += ["--latent-cache", str(base / "latents.npz")]
    resume = (["--epochs", "1"], ["--epochs", "1", "--resume"])
    runs = {}
    with ThreadPoolExecutor(2) as pool:
        meshes = {kind: pool.submit(launch, cli_states, 2, (prior_cli.train, [
            common + flags + more + ["--out-dir", str(base / kind)] for more in resume]),
            timeout=300) for kind, flags in CLI_RUNS.items()}
        for kind, flags in CLI_RUNS.items():
            extra = flags[:2] if kind == "expert" else []  # the one process's MoE prior
            for epochs, more in zip(("1", "2"), resume):
                one = common + extra + more + ["--out-dir", str(base / f"{kind}_one")]
                runs[f"{kind}_one_{epochs}"] = cli_state(prior_cli.train, one)
        for kind, job in meshes.items():
            ranks = job.result()
            runs[f"{kind}_1"], runs[f"{kind}_2"] = ([r[i] for r in ranks] for i in (0, 1))
    return base, runs


@pytest.mark.parametrize("kind", list(CLI_RUNS))
def test_cli_trains_resumes_and_samples_as_one_process(cli_runs, kind):
    """Each epoch on every rank against one process: the loss to LOSS_RTOL,
    the first moment and the parameters (where the first moment is at least
    1e-3 of its leaf's largest entry) to ONE_TOL, elsewhere within 2 lr a
    step (Adam moves an entry whose gradient is near zero by lr times a sign
    that rounding may flip); the DDIM grid's images to JAX's DDIM limit."""
    _, runs = cli_runs
    for epochs in ("1", "2"):
        want = runs[f"{kind}_one_{epochs}"]
        for rank, got in enumerate(runs[f"{kind}_{epochs}"]):
            what = f"{kind} epoch {epochs} rank {rank}"
            np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL,
                                       err_msg=what)
            assert list(got["params"]) == list(want["params"]), what
            for k, w in want["params"].items():
                mu = np.abs(want["mu"][k])
                np.testing.assert_allclose(got["mu"][k], want["mu"][k], **ONE_TOL,
                                           err_msg=f"{what} mu {k}")
                keep = mu >= 1e-3 * max(float(mu.max()), 1e-30)
                np.testing.assert_allclose(got["params"][k][keep], w[keep], **ONE_TOL,
                                           err_msg=f"{what} params {k}")
                np.testing.assert_allclose(got["params"][k], w, rtol=0, atol=2 * CLI_LR * CLI_STEPS,
                                           err_msg=f"{what} params {k}")
            np.testing.assert_allclose(got["samples"], want["samples"], **JAX_TOL, err_msg=what)


@pytest.mark.parametrize("kind", list(CLI_RUNS))
def test_cli_checkpoint_is_read_by_the_jax_loader(cli_runs, kind):
    """The msgpack rank 0 wrote after the resumed epoch: JAX's loader reads
    the run's parameters bit for bit, under the one-process config."""
    from toycrystals_tpu.utils.checkpoint import load_checkpoint as jax_load

    base, runs = cli_runs
    got = jax_load(str(base / kind / "checkpoints" / "diffusion_prior_last.msgpack"))
    want = jax_load(str(base / f"{kind}_one" / "checkpoints" / "diffusion_prior_last.msgpack"))
    assert got["config"] == want["config"]
    assert jax.tree.structure(got["params"]) == jax.tree.structure(want["params"])
    for k, v in tpar.PRIOR[0](jax.tree.map(np.asarray, got["params"])).items():
        np.testing.assert_array_equal(v, runs[f"{kind}_2"][0]["params"][k], err_msg=k)


def test_cli_prints_jax_s_mesh_and_coverage_lines(cli_runs):
    _, runs = cli_runs
    pipe, ep = runs["pipe_1"][0]["stdout"], runs["expert_1"][0]["stdout"]
    assert "2-D mesh: 1 data x 2 pipe stages" in pipe.splitlines()
    assert "2-D mesh: 1 data x 2 expert devices" in ep.splitlines()
    assert any(line.startswith("expert parallelism: ") and line.endswith(
        "of param elements sharded over 'expert'") for line in ep.splitlines()), ep
    assert not runs["pipe_1"][1]["stdout"] and not runs["expert_1"][1]["stdout"]


@pytest.mark.parametrize("flags, message", [
    (["--shard-expert", "2", "--shard-pipe", "2"], "--shard-expert and --shard-pipe are mutually "
                                                   "exclusive"),
    (["--shard-expert", "2", "--shard-model", "2"], "--shard-expert and --shard-model are mutually "
                                                    "exclusive"),
    (["--moe-experts", "6", "--shard-expert", "4"], r"--shard-expert 4 requires --moe-experts "
                                                    r"divisible by it \(got 6\)"),
    (["--moe-experts", "4", "--shard-pipe", "2"], r"--moe-experts does not support --shard-pipe "
                                                  r"\(the pipelined forward is the dense FiLM"),
    (["--shard-pipe", "2", "--shard-model", "2"], "--shard-pipe and --shard-model are mutually "
                                                  "exclusive"),
    (["--shard-pipe", "3"], "--shard-pipe 3 must divide the prior's 8 blocks"),
    (["--shard", "2", "--shard-pipe", "2", "--pipe-micro", "3"],
     "batch size 16 must divide by --shard 2 x --pipe-micro 3"),
    (["--shard", "3", "--moe-experts", "4", "--shard-expert", "2"],
     "batch size 16 not divisible by --shard 3"),
])
def test_jax_s_refusals(tmp_path, flags, message):
    """Before any rank starts (`main`) and in `train`."""
    from toycrystals_torch.scripts import train_diffusion_prior as prior_cli

    for entry in (prior_cli.main, prior_cli.train):
        with pytest.raises(SystemExit, match=message):
            entry(PRIOR_CLI + flags + ["--out-dir", str(tmp_path)])


@pytest.mark.parametrize("flags", [["--shard-pipe", "2"], ["--moe-experts", "4",
                                                           "--shard-expert", "2"]])
def test_multi_host_refusal_covers_the_pipe_and_expert_axes(tmp_path, monkeypatch, flags):
    from toycrystals_torch.scripts import train_diffusion_prior as prior_cli

    monkeypatch.setattr(prior_cli, "init_distributed", lambda *a: True)
    with pytest.raises(SystemExit, match="multi-host --fsdp/--shard-model/--shard-pipe/"
                                         "--shard-expert is unsupported"):
        prior_cli.train(PRIOR_CLI + flags + ["--out-dir", str(tmp_path)])


def test_pipe_micro_without_shard_pipe_is_ignored(tmp_path):
    """JAX accepts --pipe-micro alone and ignores it: the refusals pass it."""
    from toycrystals_torch.scripts import train_diffusion_prior as prior_cli

    assert prior_cli._refuse(prior_cli.build_parser().parse_args(
        PRIOR_CLI + ["--pipe-micro", "3"])) == (0, 0)


def test_in_turn_and_keep_copy_in_one_process(tmp_path):
    """The entries that let one spawn run a CLI, keep its checkpoint and run
    cases after it (chip_smoke.py phase 19), in a process with no group:
    `in_turn` returns each call's result and seconds and `keep_copy` copies;
    a prior drawn on its device from "init_seed" repeats for the same seed."""
    from toycrystals_torch.parallel.parity import in_turn, keep_copy

    cases, _ = _net_cases("moe", 41)
    apply = {k: v for k, v in cases["apply"].items() if k != "state_dict"}
    spec = {"device": "cpu", "cases": [dict(apply, init_seed=42)]}
    src, dst = str(tmp_path / "src.bin"), str(tmp_path / "dst.bin")
    with open(src, "wb") as f:
        f.write(b"\x01\x02\x03")
    out = in_turn([(keep_copy, (src, dst)), (run_cases, (spec,)), (run_cases, (spec,))])
    assert out[0][0] is None and all(s >= 0.0 for _, s in out)
    with open(dst, "rb") as f:
        assert f.read() == b"\x01\x02\x03"
    (first,), (again,) = out[1][0], out[2][0]
    for key in ("forward", "ddim"):
        assert np.isfinite(first[key]).all()
        np.testing.assert_array_equal(first[key], again[key])
