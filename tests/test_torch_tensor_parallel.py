"""The "model" axis of the port (toycrystals_torch/parallel/tensor.py and the
model branches of ops/ and the U-Net) and HSDP (parallel/fsdp.py on a
("data", "space") mesh), against the JAX package's GSPMD runs on the
8-virtual-device CPU (tests/conftest.py) and against the port's own
one-process runs, on the CPU.

- In process: `tp_sharding` shards the leaves JAX's `tp_sharding` shards, on
  both stems at M = 2, 4 and 8, with `tp_coverage` equal to JAX's; the
  blocks of `shard_params` put back together (`assemble_blocks`, what
  `full_params` gathers) are the flax tree bit for bit, the qkv placed by head.
- One 4-rank gloo job (`parallel.multihost.launch` of
  `parallel.parity.run_cases`, one torch thread per rank) on ("data",
  "model") meshes of (2, 2) and (1, 4), and a ("data", "space") mesh of
  (2, 2) under FSDP2 (HSDP):
  - the forward of both stems against JAX's `model.apply` with `shard_params`
    on `make_mesh_tp(2, 2)` and `make_mesh_tp(1, 4)` at JAX's own tolerance
    (rtol 1e-4, atol 1e-5: tests/test_tensor_parallel.py);
  - the int8 forward bit for bit against one process (model axis of 2);
  - `sample_chunked` and inpainting on injected draws of JAX's keys, and on
    their own chunk generators, against one process;
  - one f32 SDE step of stems `none` and `s2dr` (the s2dr stem's `out` feeds
    the sharded `refine1` and the whole final add: the gather's adjoint with
    mixed consumers; s2dr under global-norm clipping, whose norm sums the
    blocks over "model") against one process, leaf by leaf (the gradients and
    Adam's first moment), and against JAX's
    step on `make_mesh_tp(2, 2)` (tests/test_tensor_parallel.py's
    `test_tp_train_step` with JAX's draws injected);
  - an attention block of 2 heads at M = 4 (the heads do not split: the
    gathered-whole path) and a GroupNorm+SiLU of 2 groups at M = 4 (the groups
    do not split), forward and backward, against one process;
  - DCP under "model": a (2, 2) save restores on (1, 4) and in one process;
  - HSDP: every rank's shard is the fsdp rule's slice over "data", one f32
    step equals one process and JAX's step on `make_mesh_2d(2, 2)` (the loss
    that of JAX's `shard_params_fsdp` step too; the gradients those of JAX's
    replicated step, as its FSDP step's gradients are wrong on the CPU
    backend), and a DCP save on (2, 2) restores on (2, 2) and in one process.
  Tolerances against one process are tests/test_torch_spatial_train.py's
  (losses 1e-6 relative; each gradient leaf 1e-5 of its largest entry plus
  1e-6 of the step's largest gradient), against JAX its (each leaf 1e-5 +
  2e-3 of its largest entry: the port's one-process step is as far from
  JAX's). Gradients are compared, not post-Adam weights: Adam turns rounding
  noise in a near-zero gradient into 2 lr.
- JAX's 3-D ("data", "space", "model") mesh at (1, 2, 2), in the same job:
  the forward of both stems against JAX's on `make_mesh_3d(1, 2, 2)`, the
  f32 step of both stems against one process and against JAX's one-device
  step and its own step on that mesh (which agrees with its one-device
  step), 3-step SDE sampling and inpainting of a v model against JAX's
  samplers on that mesh (its tensor-parallel tolerance, rtol 1e-2, atol 1e-3)
  and against one process, GroupNorm+SiLU on a channel block (whole groups)
  and on the gathered whole (no whole group), and an attention block, each
  on a rank's rows, against one process, int8 sampling against one process
  (the first activation scale bit for bit), `full_params` bit for bit, and a
  DCP save restored on the mesh and in one process.
- The CLIs: the trainer with --shard-model 2 against one process (its
  msgpack checkpoint read by the JAX package's sample CLI), the sample,
  inpaint and serve CLIs with --shard-model 2 against one process, and the
  trainer with --shard 2 --shard-space 2 --fsdp, then --resume.
  (tests/test_torch_mesh_3d.py runs the CLIs on the 3-D mesh.)
"""

import io
import json
import os
import re
import runpy
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.parallel import launch
from toycrystals_torch.parallel import tensor as ttp
from toycrystals_torch.parallel.fsdp import fsdp_sharding, param_layouts
from toycrystals_torch.parallel.parity import run_cases
from toycrystals_torch.utils.params import (
    flax_from_torch_state_dict,
    load_flax_params,
    torch_state_dict_from_flax,
)
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.parallel import data_sharding, make_mesh_3d, make_mesh_tp, shard_params_fsdp
from toycrystals_tpu.parallel import spatial as jspatial
from toycrystals_tpu.parallel import tensor as jtp
from toycrystals_tpu.train.state import create_train_state as jax_create_train_state
from toycrystals_tpu.train.steps import make_sde_train_step as jax_make_sde_train_step

ROOT = Path(__file__).resolve().parent.parent
KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
SIZE, B = 16, 4
LR, DECAY, P_UNCOND, CLIP = 1e-3, 0.9, 0.5, 0.05
LOSS_RTOL, LEAF, FLOOR = 1e-6, 1e-5, 1e-6
TP = {"2x2": [2, 2, "model"], "1x4": [1, 4, "model"], "1x2x2": [1, 2, 2, "3d"]}
MESH3 = TP["1x2x2"]  # JAX's make_mesh_3d(1, 2, 2): rank 2 s + m
HSDP = [2, 2]
SAMPLE_STEPS, SAMPLE_N, SAMPLE_CHUNK = 3, 6, 4
# images in [0, 1] after 3 SDE steps against one process: JAX's own atol for its
# tensor-parallel sampler against one device (tests/test_tensor_parallel.py)
SAMPLE_TOL = 1e-3
# the 3-D samplers against JAX's on make_mesh_3d: its tensor-parallel tolerance
# (tests/test_tensor_parallel.py's 3-D sampler against one device)
JAX_SAMPLE_RTOL, JAX_SAMPLE_ATOL = 1e-2, 1e-3
# the port's loss against JAX's one-device loss (tests/test_torch_loss.py's)
JAX_LOSS_RTOL = 2e-5
# the forward against JAX's: JAX's own tolerance (tests/test_tensor_parallel.py, which
# holds stem none); the s2dr stem at tests/test_torch_unet.py's whole-U-Net limit: JAX's
# own s2dr forward on make_mesh_tp(2, 2) is 2.9x its tolerance from its one-device forward
FWD_TOL = {"none": dict(rtol=1e-4, atol=1e-5), "s2dr": dict(rtol=0, atol=2e-4)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in-process, as each spawned rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_dict(seed, **kw):
    model = flax_default_init(tm.CondUNetTiny(**KW, **kw), np.random.default_rng(seed))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _keep_grads():
    """An optax stage whose state is the gradient it passes on."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def _batch(seed):
    r = np.random.default_rng(seed)
    return (r.uniform(size=(B, SIZE, SIZE, 1)).astype(np.float32),
            r.integers(0, 4, size=(B,)).astype(np.int32),
            r.normal(size=(B, 4)).astype(np.float32))


# ---------------------------------------------------------------------------
# in process: the rule, the coverage and the blocks
# ---------------------------------------------------------------------------


class _RankMesh:
    """What `shard_params` reads of a ("data", "model") mesh, for model rank
    `rank` of `m` in this process (no process group: nothing is gathered)."""

    mesh_dim_names, ndim = ("data", "model"), 2

    def __init__(self, m, rank):
        self.m, self.rank = m, rank

    def size(self, dim=None):
        return self.m if dim in (None, 1) else 1

    def get_local_rank(self, axis):
        return self.rank if axis == "model" else 0

    def get_group(self, axis=None):
        return None


def _flax_leaf(tree, key):
    """The flax leaf of a torch state_dict key."""
    *mods, name = key.split(".")
    for m in mods:
        tree = tree[m]
    names = ("kernel", "scale", "embedding") if name == "weight" else ("bias",)
    (leaf,) = [v for k, v in tree.items() if k in names]
    return leaf


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("stem", ["none", "s2dr"])
def test_tp_rule_and_coverage_are_jax(stem, m):
    """Every leaf: the port shards a leaf exactly where JAX's trailing-dim rule
    does, along the torch dim of the flax layout's last dim."""
    model = tm.CondUNetTiny(**KW, stem=stem)
    flax = flax_from_torch_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    mesh = make_mesh_tp(1, m)
    for key, p, order in param_layouts(model):
        want = not jtp.tp_sharding(mesh, np.shape(_flax_leaf(flax, key))).is_fully_replicated
        dim = ttp.tp_sharding(m, tuple(p.shape), order)
        assert (dim is not None) == want, key
        if dim is not None:
            assert dim == order[-1], key
    assert ttp.tp_coverage(m, model) == jtp.tp_coverage(mesh, flax)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("stem", ["none", "s2dr"])
def test_blocks_assemble_to_the_flax_tree_bit_for_bit(stem, m):
    sd = _state_dict(5, stem=stem)
    flax = flax_from_torch_state_dict(sd)
    ranks = []
    for r in range(m):
        model = tm.CondUNetTiny(**KW, stem=stem)
        load_flax_params(model, flax)
        ranks.append(dict(ttp.shard_params(model, _RankMesh(m, r)).named_parameters()))
    whole = {}
    for k in sd:
        blk = ttp.block_of(ranks[0][k])
        whole[k] = (ranks[0][k].detach() if blk is None else
                    ttp.assemble_blocks([rk[k].detach() for rk in ranks], blk)).numpy()
    back = flax_from_torch_state_dict(whole)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(flax)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # the qkv by head: rank r's rows are the q, k and v rows of its heads
    c, heads = 2 * KW["base_ch"], 4
    qkv = sd["attn.qkv.weight"].reshape(3, heads, c // heads, c)
    for r in range(m):
        got = ranks[r]["attn.qkv.weight"].detach().numpy()
        want = qkv[:, r * heads // m:(r + 1) * heads // m].reshape(-1, c)
        np.testing.assert_array_equal(got, want)
        assert ttp.block_of(ranks[r]["attn.qkv.weight"]).parts == 3
        # 1 output channel (stem none) stays whole; the s2d stems' 4 split
        assert (ttp.block_of(ranks[r]["out.weight"]) is None) == (stem == "none")


# ---------------------------------------------------------------------------
# the 4-rank job and its counterparts
# ---------------------------------------------------------------------------


def _forward_case(stem, seed, **model_kw):
    r = np.random.default_rng(seed)
    return dict(kind="forward", model=dict(KW, stem=stem, **model_kw),
                state_dict=_state_dict(seed, stem=stem),
                x=r.uniform(size=(B, SIZE, SIZE, 1)).astype(np.float32),
                t=r.uniform(0.05, 0.95, B).astype(np.float32),
                y_cat=r.integers(0, 5, B).astype(np.int32),
                y_cont=r.normal(size=(B, 4)).astype(np.float32))


def _jax_mesh(shape):
    """JAX's mesh of a port mesh spec: make_mesh_tp(D, M) or make_mesh_3d(D, S, M)."""
    return make_mesh_3d(*shape[:3]) if shape[-1] == "3d" else make_mesh_tp(*shape[:2])


def _images(mesh):
    """Images over JAX's mesh: by (data, space) where it has a space axis."""
    return (jspatial.image_sharding(mesh) if "space" in mesh.axis_names
            else data_sharding(mesh, 4))


def _jax_forward(case, shape):
    """JAX's forward with channel-sharded weights on the mesh of `shape`."""
    mesh = _jax_mesh(shape)
    jmodel = jm.CondUNetTiny(**case["model"])
    params = jtp.shard_params(mesh, jax.tree.map(jnp.asarray,
                                                 flax_from_torch_state_dict(case["state_dict"])))
    out = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))(
        params, jax.device_put(case["x"], _images(mesh)),
        jax.device_put(case["t"], data_sharding(mesh, 1)),
        jax.device_put(case["y_cat"], data_sharding(mesh, 1)),
        jax.device_put(case["y_cont"], data_sharding(mesh, 2)))
    return np.asarray(out)


def _jax_sde_case(stem, seed, mesh, fsdp=False, image=False):
    """One JAX step with the state placed on `mesh` by JAX's tensor-parallel
    (or, `fsdp`, its FSDP) rule (mesh None: one device), its gradients kept
    by the optimizer, and the draws its key makes (p_uncond 0.5, EMA 0.9);
    x0 by (data, space) under `fsdp` or `image`."""
    sd = _state_dict(seed, stem=stem)
    jtx = optax.chain(_keep_grads(), optax.adam(LR))
    state = jax_create_train_state(jax.tree.map(jnp.asarray, flax_from_torch_state_dict(sd)),
                                   jtx, ema=True)
    if mesh is not None:
        state = shard_params_fsdp(mesh, state) if fsdp else jtp.shard_params(mesh, state)
    step = jax_make_sde_train_step(jm.CondUNetTiny(**KW, stem=stem), jtx, jm.VPSDE(0.1, 30.0),
                                   4, P_UNCOND, 1.0, DECAY)
    x0, y_cat, y_cont = _batch(seed + 1)
    key = jax.random.key(seed + 2)
    t, eps, yc, yv = jm.draw_diffusion_loss_noise(jnp.asarray(x0), jnp.asarray(y_cat),
                                                  jnp.asarray(y_cont), key, 4, P_UNCOND)
    if mesh is None:
        state, loss = step(state, jnp.asarray(x0), jnp.asarray(y_cat), jnp.asarray(y_cont), key)
    else:
        xs = jspatial.image_sharding(mesh) if fsdp or image else data_sharding(mesh, 4)
        state, loss = step(state, jax.device_put(x0, xs),
                           jax.device_put(y_cat, data_sharding(mesh, 1)),
                           jax.device_put(y_cont, data_sharding(mesh, 2)), key)
    case = dict(kind="sde", model=dict(KW, stem=stem), state_dict=sd,
                opt={"lr": LR, "ema": DECAY}, x0=x0[None], y_cat=np.array(yc)[None],
                y_cont=np.array(yv)[None], t=np.array(t)[None], eps=np.array(eps)[None])
    want = {"losses": [float(loss)],
            "grads": torch_state_dict_from_flax(_np(state.opt_state[0]))}
    return case, want


def _sample_cases(seed):
    """sample_chunked (SDE, CFG 1.5) and inpainting on the draws of JAX keys
    (x_init, then one draw per step; the inpainting's three per step)."""
    sd = _state_dict(seed)
    key = jax.random.key(seed)
    k0, k1, k2 = jax.random.split(key, 3)
    shape = (SAMPLE_N, SIZE, SIZE, 1)
    yc, yv = (np.asarray(a) for a in jm.sample_grid_conditions(SAMPLE_N, 4, 4))
    x_init = np.asarray(jax.random.normal(k0, shape))
    z = np.asarray(jax.random.normal(k1, (SAMPLE_N, SAMPLE_STEPS, SIZE, SIZE, 1)))
    sample = dict(kind="sample", model=KW, state_dict=sd, y_cat=yc, y_cont=yv, shape=shape,
                  seed=seed, chunk=SAMPLE_CHUNK, n_steps=SAMPLE_STEPS, cfg=1.5, x_init=x_init,
                  z=z)
    mask = np.zeros(shape, np.float32)
    mask[:, :, : SIZE // 2] = 1.0
    r = np.random.default_rng(seed)
    inpaint = dict(kind="inpaint", model=KW, state_dict=sd, y_cat=yc, y_cont=yv, shape=shape,
                   n_steps=SAMPLE_STEPS, cfg=1.5, resample=2, x_init=x_init,
                   draws=np.asarray(jax.random.normal(k2, (SAMPLE_N, SAMPLE_STEPS, 2, 3, SIZE,
                                                           SIZE, 1))),
                   x_known=r.uniform(size=shape).astype(np.float32), mask=mask)
    return sample, inpaint


def _jax_3d_sampler_cases(seed):
    """3 SDE steps and 2 inpainting steps (resample 2) of a v model (an eps
    model's few steps from noise clip nearly every pixel) on JAX's
    make_mesh_3d(1, 2, 2) with its weights placed by `shard_params`, and the
    draws its keys make (tests/test_torch_spatial.py's cases)."""
    sd = _state_dict(seed)
    mesh = make_mesh_3d(*MESH3[:3])
    jmodel = jm.CondUNetTiny(**KW)
    sde = jm.VPSDE(0.1, 30.0)
    apply = jm.eps_apply_from_v(sde, jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a)))
    params = jtp.shard_params(mesh, jax.tree.map(jnp.asarray, flax_from_torch_state_dict(sd)))
    yc, yv = (np.asarray(a) for a in jm.sample_grid_conditions(B, 4, 4))
    shape, img = (B, SIZE, SIZE, 1), jspatial.image_sharding(mesh)
    conds = (jax.device_put(yc, data_sharding(mesh, 1)), jax.device_put(yv, data_sharding(mesh, 2)))
    key = jax.random.key(seed + 1)
    want = jm.sample_reverse_sde_euler_maruyama(apply, params, sde, *conds, shape, key,
                                                n_steps=SAMPLE_STEPS, guidance_scale=1.5,
                                                n_types=4, sharding=img)
    k_init, k_noise = jax.random.split(key)
    sample = dict(kind="sample", param="v", model=KW, state_dict=sd, y_cat=yc, y_cont=yv,
                  shape=shape, seed=seed, chunk=B, n_steps=SAMPLE_STEPS, cfg=1.5,
                  x_init=np.array(jax.random.normal(k_init, shape, jnp.float32)),
                  z=np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k_noise, i), shape,
                                                           jnp.float32))
                              for i in range(SAMPLE_STEPS)], axis=1), mesh=MESH3)
    r = np.random.default_rng(seed)
    x_known = r.uniform(-0.1, 1.1, size=shape).astype(np.float32)
    mask = np.ones(shape, np.float32)
    mask[:, 4:12, 3:11] = 0.0
    n_steps, resample, key = 2, 2, jax.random.key(seed + 2)
    want_inpaint = jm.sample_inpaint_reverse_sde(
        apply, params, sde, *conds, shape, key, n_steps, 1.5, 1e-3, 4, resample,
        x_known=jax.device_put(x_known, img), mask=jax.device_put(mask, img), sharding=img)
    k_init, k_noise = jax.random.split(key)
    draws = np.zeros((B, n_steps, resample, 3, SIZE, SIZE, 1), np.float32)
    for i in range(n_steps):
        for j in range(resample):
            kr = jax.random.fold_in(jax.random.fold_in(k_noise, i), j)
            for k in range(3):
                draws[:, i, j, k] = np.asarray(jax.random.normal(jax.random.fold_in(kr, k),
                                                                 shape, jnp.float32))
    inpaint = dict(kind="inpaint", param="v", model=KW, state_dict=sd, y_cat=yc, y_cont=yv,
                   shape=shape, n_steps=n_steps, resample=resample, cfg=1.5,
                   x_init=np.array(jax.random.normal(k_init, shape, jnp.float32)), draws=draws,
                   x_known=x_known, mask=mask, mesh=MESH3)
    return {"sample_v_3d": (sample, np.asarray(want)),
            "inpaint_v_3d": (inpaint, np.asarray(want_inpaint))}


def _layer_case(kind, model, seed, mesh=TP["1x4"]):
    """A layer's weights, input and upstream gradient, from a numpy seed."""
    from toycrystals_torch.ops.attention import SelfAttention2d
    from toycrystals_torch.ops.groupnorm import GroupNormSiLU

    layer = SelfAttention2d(**model) if kind == "attention" else GroupNormSiLU(**model)
    r = np.random.default_rng(seed)
    sd = {k: (r.normal(size=tuple(v.shape)) * 0.3 + (k.endswith("weight") and v.dim() == 1))
          .astype(np.float32) for k, v in layer.state_dict().items()}
    ch = model.get("ch", model.get("channels"))
    pad = 2 if model.get("pad") else 0
    return dict(kind=kind, mesh=mesh, model=model, state_dict=sd,
                x=r.normal(size=(2, ch, SIZE, SIZE)).astype(np.float32) * 2 + 0.5,
                cot=r.normal(size=(2, ch, SIZE + pad, SIZE + pad)).astype(np.float32))


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    cases, jax_out = {}, {}
    for stem in ("none", "s2dr"):
        f = _forward_case(stem, 3 if stem == "none" else 4)
        for name, shape in TP.items():
            cases[f"fwd_{stem}_{name}"] = dict(f, mesh=shape)
            jax_out[f"fwd_{stem}_{name}"] = _jax_forward(f, shape)
    cases["fwd_int8"] = dict(_forward_case("s2dr", 6, conv_impl="int8"), mesh=TP["2x2"])
    for i, stem in enumerate(("none", "s2dr")):
        case, jax_out[f"sde_{stem}"] = _jax_sde_case(stem, 10 * i + 11, make_mesh_tp(2, 2))
        # the same draws on JAX's 3-D mesh and on one device
        jax_out[f"sde_{stem}_3d"] = _jax_sde_case(stem, 10 * i + 11, _jax_mesh(MESH3),
                                                  image=True)[1]
        jax_out[f"sde_{stem}_one_device"] = _jax_sde_case(stem, 10 * i + 11, None)[1]
        if stem == "s2dr":  # the clip norm sums the blocks over "model", the rest once
            case = dict(case, opt=dict(case["opt"], clip=CLIP))
        for name, shape in TP.items():
            cases[f"sde_{stem}_{name}"] = dict(case, mesh=shape)
    sample, inpaint = _sample_cases(31)
    for name, shape in TP.items():
        cases[f"sample_{name}"] = dict(sample, mesh=shape)
        cases[f"inpaint_{name}"] = dict(inpaint, mesh=shape)
    for name, (case, want) in _jax_3d_sampler_cases(32).items():
        cases[name], jax_out[name] = case, want
    # the int8 convs on the 3-D mesh (the v model's draws), the first scale
    # recorded (F4)
    cases["sample_int8_3d"] = dict(cases["sample_v_3d"], model=dict(KW, conv_impl="int8"),
                                   record_scale=True)
    cases["attention"] = _layer_case("attention", dict(ch=8, num_heads=2), 41)
    cases["groupnorm"] = _layer_case("groupnorm", dict(channels=8, groups=2, pad=True), 42)
    # on the 3-D mesh: 2 of the 4 heads a rank, 2 of the 4 groups a rank (a
    # channel block of whole groups) and 1 group (the gathered whole), each
    # on a rank's rows
    cases["attention_3d"] = _layer_case("attention", dict(ch=16, num_heads=4), 45, MESH3)
    for name, groups in (("block", 4), ("whole", 1)):
        cases[f"groupnorm_3d_{name}"] = _layer_case(
            "groupnorm", dict(channels=8, groups=groups, pad=True), 46 + groups, MESH3)
    cases["full_params"] = dict(kind="full_params", mesh=TP["1x4"], model=dict(KW, stem="s2dr"),
                                state_dict=_state_dict(43, stem="s2dr"))
    cases["full_params_3d"] = dict(cases["full_params"], mesh=MESH3)
    d = tmp_path_factory.mktemp("dcp")
    sd = _state_dict(44)
    for name, mesh, fsdp in (("tp", TP["2x2"], False), ("hsdp", HSDP, True),
                             ("3d", MESH3, False)):
        path = str(d / name)
        cases[f"dcp_save_{name}"] = dict(kind="dcp_save", model=KW, state_dict=sd, fsdp=fsdp,
                                         seed=8, path=path, mesh=mesh)
        cases[f"dcp_load_{name}"] = dict(kind="dcp_load", model=KW, state_dict=sd, fsdp=fsdp,
                                         path=path, mesh=mesh)
    cases["dcp_load_tp_1x4"] = dict(cases["dcp_load_tp"], mesh=TP["1x4"])
    case, jax_out["sde_hsdp"] = _jax_sde_case("none", 51, jspatial.make_mesh_2d(*HSDP),
                                              fsdp=True)
    # the tensor-parallel rule on a mesh with no "model" axis: JAX's replicated step
    _, jax_out["sde_hsdp_replicated"] = _jax_sde_case("none", 51, jspatial.make_mesh_2d(*HSDP))
    cases["sde_hsdp"] = dict(case, mesh=HSDP, fsdp=True)
    return {"cases": cases, "jax": jax_out}


@pytest.fixture(scope="module")
def four_ranks(suite):
    names = list(suite["cases"])
    out = launch(run_cases, 4, ({"device": "cpu", "cases": list(suite["cases"].values())},),
                 timeout=600)
    return [dict(zip(names, rank)) for rank in out]


@pytest.fixture(scope="module")
def one_process(suite):
    """The cases with no mesh (a case the meshes share, once)."""
    c = suite["cases"]
    cases = {"fwd_none": c["fwd_none_2x2"], "fwd_s2dr": c["fwd_s2dr_2x2"],
             "fwd_int8": c["fwd_int8"], "sde_none": c["sde_none_2x2"],
             "sde_s2dr": c["sde_s2dr_2x2"], "sde_hsdp": c["sde_hsdp"],
             "sample": c["sample_2x2"], "inpaint": c["inpaint_2x2"],
             "attention": c["attention"], "groupnorm": c["groupnorm"],
             "dcp_load_tp": c["dcp_load_tp"], "dcp_load_hsdp": c["dcp_load_hsdp"],
             "dcp_load_3d": c["dcp_load_3d"], "sample_v_3d": c["sample_v_3d"],
             "inpaint_v_3d": c["inpaint_v_3d"], "sample_int8_3d": c["sample_int8_3d"],
             "attention_3d": c["attention_3d"]}
    for name in ("groupnorm_3d_block", "groupnorm_3d_whole"):
        # each space rank's padded rows read the plane's rows at its place, so
        # the one-process block gets the sum of the space ranks' windows
        cot = c[name]["cot"]
        total = np.zeros_like(cot)
        for win in _windows(cot.shape[2] - 2):
            total[:, :, win] += cot[:, :, win]
        cases[name] = dict(c[name], cot=total)
    cases = {k: dict(v, mesh=None, fsdp=False) for k, v in cases.items()}
    return dict(zip(cases, run_cases({"device": "cpu", "cases": list(cases.values())})))


def _windows(h):
    """Rows [s h / S, (s + 1) h / S + 2) of a plane of h rows padded by one
    row a side: space rank s's padded rows on the 3-D mesh."""
    n = MESH3[1]
    return [slice(s * (h // n), (s + 1) * (h // n) + 2) for s in range(n)]


def _space_ranks(four_ranks, m):
    """The results of the space ranks s = 0 .. S - 1 of model rank m on the
    3-D mesh (data rank 0; rank s M + m)."""
    return [four_ranks[s * MESH3[2] + m] for s in range(MESH3[1])]


def _hold_grads(got, want, what):
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        lim = LEAF * float(np.abs(w).max()) + FLOOR * top + 1e-12
        np.testing.assert_allclose(got[k], w, rtol=0, atol=lim, err_msg=f"{what} {k}")


@pytest.mark.parametrize("mesh", list(TP))
@pytest.mark.parametrize("stem", ["none", "s2dr"])
def test_forward_matches_jax_on_its_tp_mesh(suite, four_ranks, stem, mesh):
    name = f"fwd_{stem}_{mesh}"
    for rank in four_ranks:
        np.testing.assert_allclose(rank[name]["out"], suite["jax"][name], **FWD_TOL[stem])


@pytest.mark.parametrize("mesh", list(TP))
@pytest.mark.parametrize("stem", ["none", "s2dr"])
def test_forward_matches_one_process(four_ranks, one_process, stem, mesh):
    np.testing.assert_allclose(four_ranks[0][f"fwd_{stem}_{mesh}"]["out"],
                               one_process[f"fwd_{stem}"]["out"], **FWD_TOL[stem])


def test_int8_forward_is_one_process_bit_for_bit(four_ranks, one_process):
    for rank in four_ranks:
        np.testing.assert_array_equal(rank["fwd_int8"]["out"], one_process["fwd_int8"]["out"])


@pytest.mark.parametrize("mesh", list(TP))
@pytest.mark.parametrize("kind", ["sample", "inpaint"])
def test_sampling_matches_one_process(four_ranks, one_process, kind, mesh):
    got, want = four_ranks[0][f"{kind}_{mesh}"], one_process[kind]
    for key in want:
        if key != "launches":
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=SAMPLE_TOL, err_msg=key)
    for rank in four_ranks[1:]:
        for key in want:
            if key != "launches":
                np.testing.assert_array_equal(rank[f"{kind}_{mesh}"][key], got[key])


@pytest.mark.parametrize("mesh", list(TP))
@pytest.mark.parametrize("stem", ["none", "s2dr"])
def test_sde_step_matches_one_process(four_ranks, one_process, stem, mesh):
    got, want = four_ranks[0][f"sde_{stem}_{mesh}"], one_process[f"sde_{stem}"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    _hold_grads(got["grads"], want["grads"], f"{stem} {mesh}")
    # Adam's first moment: (1 - b1) x the gradient, clipped to norm CLIP for s2dr
    _hold_grads(got["mu"], want["mu"], f"{stem} {mesh} first moment")


@pytest.mark.parametrize("stem", ["none", "s2dr"])
def test_sde_step_matches_jax_on_make_mesh_tp_2_2(suite, four_ranks, stem):
    got, want = four_ranks[0][f"sde_{stem}_2x2"], suite["jax"][f"sde_{stem}"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        lim = 1e-5 + 2e-3 * max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(got["grads"][k], w, rtol=0, atol=lim, err_msg=f"{stem} {k}")


@pytest.mark.parametrize("stem", ["none", "s2dr"])
def test_jax_3d_step_agrees_with_its_one_device_step(suite, stem):
    """JAX's step on make_mesh_3d(1, 2, 2) against JAX's one-device step on
    the same draws: the loss at JAX's own tolerance for its 3-D step
    (tests/test_tensor_parallel.py, rtol 1e-5), the gradients leaf by leaf;
    the 3-D step is a reference (no F6 here)."""
    got, want = suite["jax"][f"sde_{stem}_3d"], suite["jax"][f"sde_{stem}_one_device"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k, w in want["grads"].items():
        lim = 1e-5 + 2e-3 * max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(got["grads"][k], w, rtol=0, atol=lim, err_msg=f"{stem} {k}")


@pytest.mark.parametrize("ref", ["3d", "one_device"])
@pytest.mark.parametrize("stem", ["none", "s2dr"])
def test_sde_step_on_the_3d_mesh_matches_jax(suite, four_ranks, stem, ref):
    """The port's f32 step on the (1, 2, 2) mesh against JAX's step on
    make_mesh_3d(1, 2, 2) and against JAX's one-device step: the loss
    (tests/test_torch_loss.py's rtol 2e-5 against JAX), and each gradient leaf
    within 1e-5 + 2e-3 of its largest entry."""
    got, want = four_ranks[0][f"sde_{stem}_1x2x2"], suite["jax"][f"sde_{stem}_{ref}"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=JAX_LOSS_RTOL)
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        lim = 1e-5 + 2e-3 * max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(got["grads"][k], w, rtol=0, atol=lim, err_msg=f"{stem} {k}")


@pytest.mark.parametrize("kind", ["sample_v_3d", "inpaint_v_3d"])
def test_3d_samplers_match_jax_on_make_mesh_3d_and_one_process(suite, four_ranks, one_process,
                                                                 kind):
    """3 SDE steps, and 2 inpainting steps at resample 2, on JAX's draws: every
    rank returns the same whole images, within JAX's tensor-parallel
    tolerance of JAX's samplers on make_mesh_3d(1, 2, 2) and within SAMPLE_TOL
    of one process."""
    got = four_ranks[0][kind]["injected"]
    np.testing.assert_allclose(got, suite["jax"][kind], rtol=JAX_SAMPLE_RTOL,
                               atol=JAX_SAMPLE_ATOL)
    np.testing.assert_allclose(got, one_process[kind]["injected"], rtol=0, atol=SAMPLE_TOL)
    if kind == "sample_v_3d":
        np.testing.assert_allclose(four_ranks[0][kind]["drawn"], one_process[kind]["drawn"],
                                   rtol=0, atol=SAMPLE_TOL)
    for rank in four_ranks[1:]:
        np.testing.assert_array_equal(rank[kind]["injected"], got)


def test_3d_int8_sampling_takes_the_mesh_wide_scale_and_matches_one_process(four_ranks,
                                                                           one_process):
    """The int8 convs on the 3-D mesh: the first activation scale is one
    process's bit for bit, though some rank's own rows have a smaller max
    (the max spans every rank: F4); the images are within SAMPLE_TOL of one
    process's. Not bit for bit: the space axis sums each group's statistics
    by rows, then over "space", and an f32 rounding apart moves an int8
    rounding now and then, as on a ("data", "space") mesh."""
    want = one_process["sample_int8_3d"]
    own = [rank["sample_int8_3d"]["int8_scale"][0] for rank in four_ranks]
    for rank in four_ranks:
        got = rank["sample_int8_3d"]
        assert got["int8_scale"][1] == want["int8_scale"][1]
        for key in ("injected", "drawn"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=SAMPLE_TOL, err_msg=key)
            np.testing.assert_array_equal(got[key], four_ranks[0]["sample_int8_3d"][key])
    assert min(own) < max(own) == want["int8_scale"][0]


@pytest.mark.parametrize("kind", ["attention_3d", "groupnorm_3d_block", "groupnorm_3d_whole"])
def test_3d_layers_on_a_ranks_rows_and_channels_match_one_process(four_ranks, one_process, kind):
    """On the (1, 2, 2) mesh each rank runs its rows of its channel block:
    attention with 2 of the 4 heads against K and V gathered over "space";
    GroupNorm+SiLU (pad on) with 2 of the 4 groups (the block holds whole
    groups) and with 1 group (gathered over "model", the block kept), its
    statistics over every space rank's rows and its halo rows the
    neighbours'. Each rank's output rows (padded: its window of the plane),
    dx over the space ranks, and the parameters' gradients summed over them
    are one process's."""
    want = one_process[kind]
    pad = want["out"].shape[2] != want["dx"].shape[2]
    h = want["dx"].shape[2]
    wins = _windows(h) if pad else [slice(w.start, w.stop - 2) for w in _windows(h)]
    for m in range(MESH3[2]):
        ranks = _space_ranks(four_ranks, m)
        for rank, win in zip(ranks, wins):
            np.testing.assert_allclose(rank[kind]["out"], want["out"][:, :, win], rtol=0,
                                       atol=1e-5)
        dx = np.concatenate([rank[kind]["dx"] for rank in ranks], axis=2)
        np.testing.assert_allclose(dx, want["dx"], rtol=0,
                                   atol=LEAF * float(np.abs(want["dx"]).max()) + 1e-12)
        _hold_grads({k: sum(rank[kind]["grads"][k] for rank in ranks) for k in want["grads"]},
                    want["grads"], kind)


def test_full_params_on_the_3d_mesh_is_the_flax_tree_bit_for_bit(suite, four_ranks):
    want = flax_from_torch_state_dict(suite["cases"]["full_params_3d"]["state_dict"])
    for rank in four_ranks:
        got = rank["full_params_3d"]["flax"]
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                     jax.tree_util.tree_leaves_with_path(want)):
            np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_every_model_rank_holds_the_same_whole_state(four_ranks):
    for name in [n for n in four_ranks[0] if n.startswith("sde_")]:
        for other in four_ranks[1:]:
            for part in ("params", "grads", "mu", "ema"):
                for k, v in other[name][part].items():
                    np.testing.assert_array_equal(v, four_ranks[0][name][part][k],
                                                  err_msg=f"{name} {part} {k}")


def test_each_rank_holds_its_block_of_the_sharded_leaves(four_ranks):
    """(2, 2): rank d 2 + m holds block m of every leaf the rule shards."""
    model = tm.CondUNetTiny(**KW)
    for rank, res in enumerate(four_ranks):
        got = res["sde_none_2x2"]
        for k, p, order in param_layouts(model):
            dim = ttp.tp_sharding(2, tuple(p.shape), order)
            whole = torch.from_numpy(got["params"][k])
            want = whole if dim is None else ttp.take_block(
                whole, ttp.Block(None, 2, rank % 2, dim, 3 if k.startswith("attn.qkv") else 1))
            np.testing.assert_array_equal(got["shards"][k], want.numpy(), err_msg=k)


@pytest.mark.parametrize("kind", ["attention", "groupnorm"])
def test_layers_that_do_not_split_run_whole_and_match_one_process(four_ranks, one_process,
                                                                   kind):
    """2 heads, and 2 groups, at M = 4: the gathered-whole path."""
    want = one_process[kind]
    for rank in four_ranks:
        got = rank[kind]
        np.testing.assert_allclose(got["out"], want["out"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["dx"], want["dx"], rtol=0,
                                   atol=LEAF * float(np.abs(want["dx"]).max()) + 1e-12)
        _hold_grads(got["grads"], want["grads"], kind)


def test_full_params_is_the_flax_tree_bit_for_bit(suite, four_ranks):
    want = flax_from_torch_state_dict(suite["cases"]["full_params"]["state_dict"])
    for rank in four_ranks:
        got = rank["full_params"]["flax"]
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                     jax.tree_util.tree_leaves_with_path(want)):
            np.testing.assert_array_equal(a, b, err_msg=str(path))


def _state_equal(got, want, what):
    for part in ("params", "mu", "nu", "ema"):
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=f"{what} {part} {k}")
    assert (got["step"], got["count"]) == (want["step"], want["count"]) == (7, 5)


@pytest.mark.parametrize("name", ["tp", "hsdp", "3d"])
def test_dcp_saves_restore_on_the_mesh_and_in_one_process(four_ranks, one_process, name):
    saved = four_ranks[0][f"dcp_save_{name}"]
    for rank in four_ranks:
        _state_equal(rank[f"dcp_load_{name}"], saved, f"{name} on the mesh")
        if name == "tp":
            _state_equal(rank["dcp_load_tp_1x4"], saved, "tp on (1, 4)")
    _state_equal(one_process[f"dcp_load_{name}"], saved, f"{name} in one process")


def test_hsdp_shards_are_the_rule_over_data_and_the_step_is_one_process(four_ranks,
                                                                         one_process):
    model = tm.CondUNetTiny(**KW)
    want = one_process["sde_hsdp"]
    for rank, res in enumerate(four_ranks):
        got = res["sde_hsdp"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        _hold_grads(got["grads"], want["grads"], "hsdp")
        d = rank // HSDP[1]  # rank d S + s: its data coordinate
        for k, p, order in param_layouts(model):
            dim = fsdp_sharding(HSDP[0], tuple(p.shape), order)
            whole = got["params"][k]
            block = whole if dim is None else np.split(whole, HSDP[0], axis=dim)[d]
            np.testing.assert_array_equal(got["shards"][k], block, err_msg=k)


def test_hsdp_step_matches_jax_on_make_mesh_2d(suite, four_ranks):
    """The loss against JAX's step with `shard_params_fsdp` on make_mesh_2d(2, 2)
    and against JAX's replicated step on the same mesh; the gradients leaf by
    leaf against the replicated step. JAX's FSDP step on this mesh gives the
    same loss but gradients that the CPU backend's partitioner gets wrong:
    46 of 71 leaves differ from its own replicated step, the trunk's convs
    by more than their largest entry (ROADMAP.md section 3)."""
    got, fsdp, repl = (four_ranks[0]["sde_hsdp"], suite["jax"]["sde_hsdp"],
                       suite["jax"]["sde_hsdp_replicated"])
    for w in (fsdp, repl):
        np.testing.assert_allclose(got["losses"], w["losses"], rtol=LOSS_RTOL)
    for k, v in repl["grads"].items():
        lim = 1e-5 + 2e-3 * max(float(np.abs(v).max()), 1e-3)
        np.testing.assert_allclose(got["grads"][k], v, rtol=0, atol=lim, err_msg=k)


def test_the_cpu_runs_launched_no_kernel(four_ranks):
    for name, res in four_ranks[0].items():
        assert not any(res["launches"].values()), (name, res["launches"])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--procedural", "--img-size", "16", "--base-ch", "8",
        "--emb-dim", "16", "--n-samples", "16", "--batch-size", "8", "--sample-every", "0",
        "--ema-decay", "0.9", "--p-uncond", "0.5", "--stem", "s2dr"]


def _losses(run_dir):
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return [r["loss"] for r in rows]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One process and --shard-model 2 for one epoch; --shard 2 --shard-space 2
    --fsdp into DCP for one epoch, then --resume to two, beside one process's
    two epochs."""
    from toycrystals_torch.scripts import train_sde_score_model as train_cli

    base = tmp_path_factory.mktemp("tp_cli")
    one = train_cli.train(TINY + ["--epochs", "2", "--out-dir", str(base / "one")])
    assert train_cli.main(TINY + ["--epochs", "1", "--shard-model", "2",
                                  "--out-dir", str(base / "tp")]) == 0
    hsdp = ["--shard", "2", "--shard-space", "2", "--fsdp", "--ckpt-format", "orbax",
            "--out-dir", str(base / "hsdp")]
    assert train_cli.main(TINY + hsdp + ["--epochs", "1"]) == 0
    assert train_cli.main(TINY + hsdp + ["--epochs", "2", "--resume"]) == 0
    return base, one


def test_train_cli_with_shard_model_trains_the_one_process_epoch(cli_runs):
    base, one = cli_runs
    np.testing.assert_allclose(_losses(base / "tp"), one.loss_hist[:1], rtol=LOSS_RTOL)


def test_train_cli_hsdp_resumes_and_trains_the_one_process_epochs(cli_runs):
    base, one = cli_runs
    np.testing.assert_allclose(_losses(base / "hsdp"), one.loss_hist, rtol=LOSS_RTOL)
    assert sorted(p.name for p in (base / "hsdp" / "checkpoints").iterdir()) == [
        "sde_score_model_last.orbax"]


def test_shard_model_msgpack_is_read_by_the_jax_sample_cli(cli_runs, monkeypatch):
    from toycrystals_tpu.utils import checkpoint as jck

    base, _ = cli_runs
    ckpt = base / "tp" / "checkpoints" / "sde_score_model_last.msgpack"
    raw = jck.load_checkpoint(str(ckpt))
    assert int(raw["state"]["step"]) == 2 and raw["config"]["stem"] == "s2dr"
    monkeypatch.chdir(base)
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    monkeypatch.setattr(sys, "argv", [
        "sample_sde_score_model.py", "--device", "cpu", "--out-dir", str(base / "tp"),
        "--ckpt", str(ckpt), "--steps", "2", "--n", "4", "--sampler", "sde"])
    try:
        runpy.run_path(str(ROOT / "scripts" / "sample_sde_score_model.py"), run_name="__main__")
    except SystemExit as e:
        assert (e.code or 0) == 0
    assert list((base / "tp" / "results").glob("samples_ckpt-*.png"))


@pytest.mark.parametrize("cli", ["sample", "inpaint"])
def test_sample_and_inpaint_clis_with_shard_model_match_one_process(cli_runs, tmp_path, cli):
    """The CLI's entry in 2 spawned ranks of a (1, 2) model mesh (each returns
    its run) against the same entry in this process."""
    from toycrystals_torch.parallel.parity import cli_images
    from toycrystals_torch.scripts import inpaint_sde_score_model as inpaint_cli
    from toycrystals_torch.scripts import sample_sde_score_model as sample_cli

    base, _ = cli_runs
    argv = ["--device", "cpu", "--out-dir", str(base / "tp"), "--steps", "2", "--n", "4",
            "--out-path", str(tmp_path / f"{cli}.png")]
    fn = sample_cli.sample if cli == "sample" else inpaint_cli.inpaint
    if cli == "inpaint":
        argv += ["--resample", "2"]
    one = fn(argv)
    ranks = launch(cli_images, 2, (fn, argv + ["--shard-model", "2"]), timeout=300)
    for run in ranks:
        np.testing.assert_allclose(run["x"], one.x, rtol=0, atol=SAMPLE_TOL)
    np.testing.assert_array_equal(ranks[1]["x"], ranks[0]["x"])
    if cli == "inpaint":
        np.testing.assert_allclose(ranks[0]["line"]["region_mse"], one.line["region_mse"],
                                   rtol=1e-3)


def test_serve_cli_with_shard_model_answers_as_one_process(cli_runs, tmp_path):
    from toycrystals_torch import serve

    base, _ = cli_runs
    ckpt = base / "tp" / "checkpoints" / "sde_score_model_last.msgpack"
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "toycrystals_torch.scripts.serve_sde_score_model",
         str(ckpt), "--device", "cpu", "--port", "0", "--steps", "2", "--buckets", "2",
         "--shard-model", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT)))
    text, url, deadline = "", None, time.time() + 300
    try:
        while url is None and time.time() < deadline and proc.poll() is None:
            text += proc.stdout.readline()
            found = re.search(r"listening on (http://[0-9.]+:[0-9]+)", text)
            url = found and found.group(1)
        assert url, text
        assert "2 model ranks" in text
        req = urllib.request.Request(url + "/sample", data=json.dumps(
            {"types": [1, 2], "thetas": [0.2, 0.5], "seed": 9, "format": "npy"}).encode())
        body = urllib.request.urlopen(req, timeout=300).read()
        stats = json.loads(urllib.request.urlopen(url + "/stats", timeout=60).read())
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    got = np.load(io.BytesIO(body))
    # one process's dispatch as the mesh runs it (tests/test_torch_http.py)
    svc = serve.ScoreModelService.from_checkpoint(str(ckpt), device="cpu", steps=2,
                                                  buckets=(2,))
    yc, yv = (torch.from_numpy(a) for a in svc.conditions([1, 2], [0.2, 0.5]))
    with torch.inference_mode():
        want = tm.sample_chunked(svc._dispatch, svc._apply_fn, svc.sde, yc, yv,
                                 (2, 16, 16, 1), 9, chunk=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_TOL)
    assert stats["service"]["mesh"] == [1, 1, 2]
    assert proc.returncode == 0
