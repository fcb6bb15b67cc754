"""Weight bridge between the flax `CondUNetTiny` param tree and the port.

The port's submodules carry the flax names (`Dense_0`, `down1.conv0`,
`attn.GroupNorm_0`, `ConditionEmbedding_0.cat_emb`, ...), so a flax leaf at
path (m1, ..., mk, leaf) becomes the state_dict key "m1. ... .mk.<name>":

| flax leaf                 | torch key | layout                                |
|---------------------------|-----------|---------------------------------------|
| Conv `kernel` (4-D)       | `weight`  | [kh, kw, in, out] -> [out, in, kh, kw] |
| Dense `kernel` (2-D)      | `weight`  | [in, out] -> [out, in]                |
| Embed `embedding`         | `weight`  | unchanged                             |
| GroupNorm `scale`         | `weight`  | unchanged                             |
| any `bias`                | `bias`    | unchanged                             |

This covers all three stems ("none", "s2d", "s2dr"). Values are numpy in and
out; `flax_from_torch_state_dict` is the exact inverse.
`torch_state_dict_from_flax_vae` / `flax_vae_from_torch_state_dict` are the
same pair for the VAEs of models/vae.py (`VAE` and `CondVAE`: CondVAE's
encoder `Dense_0` has the cond vector's y_dim input columns after the 4,096
HWC ones, its decoder `Dense_0` y_dim input rows after z's, in both layouts).
A sharded state (a mesh axis's blocks, a pipeline stage's blocks:
toycrystals_torch/parallel/) is gathered to the flax tree for a save, and each
rank takes its pieces of a whole tree on a load.
Gradient and Adam moment trees have the parameters' structure, so the same
functions carry them; `train_state_to_flax` / `load_train_state_from_flax` do
so for a whole `TrainState` of toycrystals_torch/train/state.py, and
`train_state_to_checkpoint` / `load_train_state_from_checkpoint` map it onto
the JAX checkpoint's `state`: the optax `opt_state` layout that the
trainer's flags give. Each takes `bridge`: `UNET` (the default), `VAE` or
`PRIOR`.
`torch_state_dict_from_flax_prior` / `flax_prior_from_torch_state_dict`
map the latent priors of models/diffusion_prior.py and models/moe_prior.py,
whose torch names are the original implementation's (`t_mlp.0`, `y_cat_emb`,
`blocks.i.norm`, ...; flax `Dense_0`, `Embed_0`, `block_i/LayerNorm_0`, ...):
Dense kernels transpose, the MoE blocks' stacked `w1`, `b1`, `w2`, `b2` keep
the flax layout and names.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _walk(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Flax CondUNetTiny param tree (nested dict of arrays) -> the port's
    state_dict with numpy values (wrap with torch.from_numpy to load)."""
    sd: dict[str, np.ndarray] = {}
    for path, leaf in _walk(params):
        *mods, name = path
        a = np.asarray(leaf)
        if name == "kernel" and a.ndim == 4:
            a, name = a.transpose(3, 2, 0, 1), "weight"
        elif name == "kernel" and a.ndim == 2:
            a, name = a.T, "weight"
        elif name in ("embedding", "scale"):
            name = "weight"
        elif name != "bias":
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        sd[".".join([*mods, name])] = np.ascontiguousarray(a)
    return sd


def flax_from_torch_state_dict(sd: Mapping[str, Any]) -> dict:
    """The port's state_dict (numpy or torch values) -> flax param tree."""
    params: dict = {}
    for key, value in sd.items():
        # a copy: the train state's tensors change in place after a save
        a = np.asarray(value.detach().to("cpu", copy=True).numpy() if hasattr(value, "detach")
                       else value)
        *mods, name = key.split(".")
        if name == "weight":
            if a.ndim == 4:
                a, name = a.transpose(2, 3, 1, 0), "kernel"
            elif mods[-1] == "cat_emb":
                name = "embedding"
            elif a.ndim == 2:
                a, name = a.T, "kernel"
            else:
                name = "scale"
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return params


def torch_state_dict_from_flax_vae(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Flax VAE or CondVAE param tree -> the state_dict of models/vae.py's
    module (numpy). Dense kernels transpose whole, cond columns included."""
    sd: dict[str, np.ndarray] = {}
    for path, leaf in _walk(params):
        *mods, name = path
        a = np.asarray(leaf)
        if name == "kernel" and mods[-1].startswith("ConvTranspose"):
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        elif name == "kernel" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif name == "kernel" and a.ndim == 2:
            a = a.T
        elif name != "bias":
            raise KeyError(f"unexpected flax VAE leaf {'/'.join(path)}")
        sd[".".join([*mods, "weight" if name == "kernel" else name])] = np.ascontiguousarray(a)
    return sd


def flax_vae_from_torch_state_dict(sd: Mapping[str, Any]) -> dict:
    """The inverse of `torch_state_dict_from_flax_vae` (numpy or torch values)."""
    params: dict = {}
    for key, value in sd.items():
        a = np.asarray(value.detach().to("cpu", copy=True).numpy() if hasattr(value, "detach")
                       else value)
        *mods, name = key.split(".")
        if name == "weight":
            if mods[-1].startswith("ConvTranspose"):
                a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            else:
                a = a.T
            name = "kernel"
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return params


# the FiLM and MoE priors' stem: flax module -> torch module
_PRIOR_STEM = {"Dense_0": "t_mlp.0", "Dense_1": "t_mlp.2", "Embed_0": "y_cat_emb",
               "Dense_2": "y_cont_mlp.0", "Dense_3": "y_cont_mlp.2", "Dense_4": "y_fuse.0",
               "Dense_5": "y_fuse.2"}
_PRIOR_STEM_INV = {v: k for k, v in _PRIOR_STEM.items()}
_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def torch_state_dict_from_flax_prior(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Flax DiffusionPriorFiLM, DiffusionPriorMoE or (no `in_proj`) plain
    DiffusionPrior param tree -> the port's state_dict (numpy)."""
    film = "in_proj" in params
    sd: dict[str, np.ndarray] = {}
    for path, leaf in _walk(params):
        *mods, name = path
        a = np.asarray(leaf)
        head = mods[0] if mods else ""
        if film and head in _PRIOR_STEM:
            mods = [_PRIOR_STEM[head]]
        elif not film and head.startswith("Dense_"):
            mods = ["net", str(2 * int(head.split("_")[1]))]
        elif head.startswith("block_"):
            mods = ["blocks", head.split("_")[1]] + ["norm" if m == "LayerNorm_0" else m
                                                     for m in mods[1:]]
        if name in _EXPERT_LEAVES:
            pass
        elif name == "kernel" and a.ndim == 2:
            a, name = a.T, "weight"
        elif name in ("embedding", "scale"):
            name = "weight"
        elif name != "bias":
            raise KeyError(f"unexpected flax prior leaf {'/'.join(path)}")
        sd[".".join([*mods, name])] = np.ascontiguousarray(a)
    return sd


def flax_prior_from_torch_state_dict(sd: Mapping[str, Any]) -> dict:
    """The inverse of `torch_state_dict_from_flax_prior` (numpy or torch
    values); the reference's DiffusionPriorFiLM state_dict reads the same."""
    params: dict = {}
    for key, value in sd.items():
        a = np.asarray(value.detach().to("cpu", copy=True).numpy() if hasattr(value, "detach")
                       else value)
        *mods, name = key.split(".")
        prefix = ".".join(mods)
        if prefix in _PRIOR_STEM_INV:
            mods = [_PRIOR_STEM_INV[prefix]]
        elif mods[0] == "net":
            mods = [f"Dense_{int(mods[1]) // 2}"]
        elif mods[0] == "blocks":
            mods = [f"block_{mods[1]}"] + ["LayerNorm_0" if m == "norm" else m
                                           for m in mods[2:]]
        if name == "weight":
            if mods[-1] == "Embed_0":
                name = "embedding"
            elif a.ndim == 2:
                a, name = a.T, "kernel"
            else:
                name = "scale"
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return params


# (flax tree -> state_dict, state_dict -> flax tree) of each model family
UNET = (torch_state_dict_from_flax, flax_from_torch_state_dict)
VAE = (torch_state_dict_from_flax_vae, flax_vae_from_torch_state_dict)
PRIOR = (torch_state_dict_from_flax_prior, flax_prior_from_torch_state_dict)


def load_flax_params(model, params: Mapping[str, Any]) -> None:
    """Copy a flax param tree into `model` (strict: every key must match)."""
    sd = {k: torch.tensor(np.asarray(v, np.float32))
          for k, v in torch_state_dict_from_flax(params).items()}
    model.load_state_dict(sd, strict=True)


def train_state_to_flax(state, bridge=UNET) -> dict:
    """A `TrainState` of the port as flax-layout numpy trees: `params`,
    `ema_params` (None when the EMA is off), Adam's `mu` and `nu`, and the
    integers `step` (steps taken) and `count` (optimizer updates applied).
    Sharded tensors (FSDP2's, a model or expert axis's blocks, a pipeline
    stage's blocks) are gathered whole, a collective that every rank of the
    mesh must call."""
    from toycrystals_torch.parallel.fsdp import full_tensors

    def to_flax(tensors: Mapping[str, torch.Tensor]) -> dict:
        return bridge[1](full_tensors(tensors))

    names = list(state.params)
    opt = state.opt_state
    return {
        "step": int(state.step),
        "count": int(opt.count),
        "params": to_flax(state.params),
        "ema_params": None if state.ema_params is None else to_flax(state.ema_params),
        "mu": to_flax(dict(zip(names, opt.mu))),
        "nu": to_flax(dict(zip(names, opt.nu))),
    }


def load_train_state_from_flax(state, trees: Mapping[str, Any], bridge=UNET) -> None:
    """Read what `train_state_to_flax` wrote back into `state`, in place
    (strict: every parameter must be present with its shape); a sharded
    tensor takes its rank's shard or block, and a pipeline stage's state
    (parallel/pipeline.py) its stage's blocks of the whole tree."""
    from toycrystals_torch.parallel.fsdp import copy_full_
    from toycrystals_torch.parallel.pipeline import stage_of

    def copy_into(targets: Mapping[str, torch.Tensor], tree) -> None:
        sd = bridge[0](tree)
        if any(stage_of(t) is not None for t in targets.values()):
            sd = {k: v for k, v in sd.items() if k in targets}  # the other stages' blocks
        if set(sd) != set(targets):
            raise KeyError(f"tree does not match the parameters: "
                           f"{sorted(set(sd) ^ set(targets))}")
        for k, t in targets.items():
            copy_full_(t, torch.tensor(np.asarray(sd[k], np.float32)).reshape(t.shape))

    names = list(state.params)
    copy_into(state.params, trees["params"])
    copy_into(dict(zip(names, state.opt_state.mu)), trees["mu"])
    copy_into(dict(zip(names, state.opt_state.nu)), trees["nu"])
    if (trees.get("ema_params") is None) != (state.ema_params is None):
        raise ValueError("the state and the trees disagree on whether there is an EMA")
    if state.ema_params is not None:
        copy_into(state.ema_params, trees["ema_params"])
    state.step = int(trees["step"])
    state.opt_state.count = int(trees["count"])


_GUARD_KEYS = {"notfinite_count", "last_finite", "total_notfinite", "inner_state"}


def train_state_to_checkpoint(state, tx, bridge=UNET) -> dict:
    """`TrainState` and `Optimizer` (train/state.py) as the JAX trainer's
    `to_state_dict(TrainState)`: `{"step", "params", "opt_state",
    "ema_params"}`, with step and counts as 0-d int32 arrays and `opt_state`
    in the layout of the optax chain that the flags build:

    - `optax.adam(lr)`: `{"0": {"count", "mu", "nu"}, "1": {}}`, or
      `"1": {"count"}` when lr is a schedule (--lr-schedule cosine,
      --warmup-steps);
    - --clip-grad-norm wraps that as `{"0": {}, "1": <adam>}`;
    - --skip-nonfinite (`optax.apply_if_finite`) wraps the whole as
      `{"notfinite_count", "last_finite", "total_notfinite", "inner_state"}`;
      `last_finite` is whether no step has been skipped since the last one
      applied.
    """
    trees = train_state_to_flax(state, bridge)
    count = np.asarray(trees["count"], np.int32)
    opt: dict = {"0": {"count": count, "mu": trees["mu"], "nu": trees["nu"]},
                 "1": {"count": count.copy()} if callable(tx.lr) else {}}
    if tx.clip_grad_norm > 0.0:
        opt = {"0": {}, "1": opt}
    if tx.skip_nonfinite > 0:
        o = state.opt_state
        opt = {"notfinite_count": np.asarray(o.notfinite_count, np.int32),
               "last_finite": np.asarray(o.notfinite_count == 0),
               "total_notfinite": np.asarray(o.total_notfinite, np.int32),
               "inner_state": opt}
    return {"step": np.asarray(trees["step"], np.int32), "params": trees["params"],
            "opt_state": opt, "ema_params": trees["ema_params"]}


def load_train_state_from_checkpoint(state, tx, raw: Mapping[str, Any], bridge=UNET) -> None:
    """Read a checkpoint's `state` (of the JAX trainer or of
    `train_state_to_checkpoint`) into `state`, in place. Strict: an
    `opt_state` whose layout is not the one `tx`'s flags give raises
    ValueError naming the flag, as does an EMA present on one side only."""
    opt = raw["opt_state"]
    guarded = isinstance(opt, Mapping) and set(opt) == _GUARD_KEYS
    if guarded != (tx.skip_nonfinite > 0):
        raise ValueError(f"the checkpoint was written {'with' if guarded else 'without'} "
                         "--skip-nonfinite: pass the value it was trained with")
    guard = opt if guarded else None
    if guarded:
        opt = opt["inner_state"]
    clipped = set(opt) == {"0", "1"} and opt["0"] == {}
    if clipped != (tx.clip_grad_norm > 0.0):
        raise ValueError(f"the checkpoint was written {'with' if clipped else 'without'} "
                         "--clip-grad-norm: pass the value it was trained with")
    if clipped:
        opt = opt["1"]
    if set(opt) != {"0", "1"} or set(opt["0"]) != {"count", "mu", "nu"}:
        raise ValueError(f"opt_state is not optax.adam's layout: keys {sorted(opt)}")
    scheduled = opt["1"] != {}
    if scheduled != callable(tx.lr):
        raise ValueError(f"the checkpoint was written {'with' if scheduled else 'without'} a "
                         "learning-rate schedule (--lr-schedule cosine or --warmup-steps): "
                         "pass the flags it was trained with")
    adam = opt["0"]
    count = int(adam["count"])
    if scheduled and int(opt["1"]["count"]) != count:
        raise ValueError(f"the schedule's count {int(opt['1']['count'])} differs from "
                         f"Adam's {count}")
    has_ema = raw.get("ema_params") is not None
    if has_ema != (state.ema_params is not None):
        raise ValueError(f"the checkpoint was written {'with' if has_ema else 'without'} an EMA "
                         "(--ema-decay): pass the value it was trained with")
    load_train_state_from_flax(state, {"step": int(raw["step"]), "count": count,
                                       "params": raw["params"],
                                       "ema_params": raw.get("ema_params"),
                                       "mu": adam["mu"], "nu": adam["nu"]}, bridge)
    if guard is not None:
        state.opt_state.notfinite_count = int(guard["notfinite_count"])
        state.opt_state.total_notfinite = int(guard["total_notfinite"])
