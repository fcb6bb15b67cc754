"""Sharded runs and their one-process counterparts, case by case.

`run_cases(spec)` runs a list of cases in every rank of a process group, or
alone in a process with none, and returns what each produced as numpy
(whole tensors: sharded ones are gathered). Held against each other, a
2-rank result and the 1-process result of the same spec show that the data
mesh keeps the single-device numbers; the CPU tests also hold them to the
JAX package on a 2-device mesh (tests/test_torch_parallel.py), and
chip_smoke.py's phase 15 runs the same cases on the card. It is the rank
entry of those 2-rank jobs (`parallel.multihost.launch(run_cases, 2,
(spec,))`), so it imports neither JAX nor a test.

`spec` = {"device": "cpu" | "cuda", "tf32": bool (default False; None keeps
torch's defaults, as a CLI's process has them), "one_process": bool (no
mesh even in a process group: a one-process reference in a spawned rank),
"mesh": [D, S] (optional:
a ("data", "space") mesh; [D, M, "model"] a ("data", "model") mesh, [D, S,
"pipe"] a ("data", "pipe") mesh, [D, N, "expert"] a ("data", "expert")
one and [D, S, M, "3d"] JAX's 3-D ("data", "space", "model") mesh; default
a ("data",) mesh of every rank), "cases": [...]}; every
case is a dict with "kind" and numpy inputs for the GLOBAL batch (injected
draws included), of which each rank takes its rows (and, on a mesh with a
space axis, its rows of the height of every 4-D [B, H, W, C] input); a case's
own "mesh" runs it on that mesh instead. On a model axis every model is
placed by parallel/tensor.py (`place_state`, or `shard_params` for the
sampling cases), and the parameters, moments, EMA and gradients come back
whole:

- "sde": `make_sde_train_step` on CondUNetTiny(**model) from `state_dict`
  (or "init_seed"), under DDP or FSDP2 ("fsdp"), with (x0, y_cat, y_cont,
  t, eps) per step; returns the first step's gradients, the losses, and the
  parameters, Adam moments and EMA after the last step (whole), and this
  rank's own shard or block of each parameter ("shards");
- "epoch": `make_sde_train_epoch` on CondUNetTiny(**model) over images
  rendered from `lattice` (a LatticeConfig's fields) with the epoch's own
  draws from `seed`; returns the mean loss, the epoch's ms, every step's
  gradients and the parameters after;
- "space_grads": the gradients, on this rank, of the space axis's
  differentiable collectives (parallel/spatial.py) and of GroupNorm+SiLU
  under space (ops/groupnorm.py), each for the upstream gradient of this
  space rank given in the case (see `_space_grads`);
- "attention" / "groupnorm": one SelfAttention2d(**model) or
  GroupNormSiLU(**model) on x [B, C, H, W]: the output, and the gradients
  for the upstream gradient `cot`, of this rank's rows (a padded output's
  with its two halo rows, whose `cot` rows are the padded plane's at the
  same place; on a model axis, x enters as the rank's channel block, as in
  the U-Net, and the output, dx and the gradients come back whole);
- "full_params": the flax tree that parallel/tensor.py's `full_params`
  gathers from the rank's blocks of CondUNetTiny(**model);
- "vae": one `make_vae_train_step` on CondVAE with injected (eps, keep),
  under DDP or FSDP2 ("fsdp");
- "vae_epoch": `make_vae_train_epoch` on CondVAE over images rendered from
  `lattice` (each rank its rows: one rasterizer launch per step per rank)
  with the epoch's own draws from `seed`; returns the mean metrics, every
  step's gradients and the state after;
- "prior": one `make_prior_train_step` ("n_experts" in the model: the MoE
  prior, with its global route statistics) on injected (t, eps), under DDP
  or FSDP2 ("fsdp"), or on a pipe mesh as a pipeline of "micro"
  microbatches, or on an expert mesh; "steps": n repeats it on the same
  inputs (the first step's gradients, the last one's metrics), and a
  "ddim" dict of prior_apply's inputs runs that after the steps. It also
  returns what the rank holds ("held": the shape of each of its parameters
  and first moments), and of the last step its ms, on a CUDA device the
  bytes of the rank's parameters and moments ("state_bytes"), all it had
  allocated before the step ("allocated_bytes") and the step's peak
  ("step_peak_bytes"), and on a pipe mesh its hops and their seconds per
  hop ("hops", "hop_s_per_tick");
- "prior_apply": the prior's forward on (z_t, t, y_cat, y_cont) and DDIM
  ("ddim_steps") from the injected start noise z, each on this rank's rows,
  placed as "prior" is, gathered over "data";
- "distill": one `make_distill_train_step` on injected (i, eps), teacher
  whole on every rank, student under DDP;
- "sample": `sample_chunked` of a sampler ("sampler": sde, ode, dpm, ddim or rf;
  default sde; "param" v wraps the model by `eps_apply_from_v`), once on
  per-row injected noise and once on its own chunk generators ("drawn",
  unless "drawn" is False); "record_scale" also returns the first int8
  activation scale of the injected run with this rank's own max;
- "forward": one forward of CondUNetTiny(**model) on (x, t, y_cat, y_cont);
- "inpaint": `sample_chunked` of `sample_inpaint_reverse_sde` on injected
  draws, with x_known and mask ("param" as for "sample");
- "service": `ScoreModelService(config, params, mesh=...)` answering its
  "requests", (y_cat, y_cont, seed) each, in order (SPMD: every rank calls
  `sample` with the same arguments), each timed;
- "halo": this rank's rows of x [B, C, H, W] with the halo exchange's rows
  on each side, wrapped and clamped (parallel/spatial.py `pad_rows`);
- "dcp_save" / "dcp_load": a state written to / read from a
  `ShardedCheckpointManager` directory under FSDP2 (default; "fsdp" False:
  the model axis's blocks alone), of CondUNetTiny or of the "net" "vae";
- "msgpack": the bytes of the JAX checkpoint's `state` that a trainer writes
  (`train_state_to_checkpoint`, gathered whole) of a placed state whose
  moments and EMA hold values of their own (net "unet", "vae" or "prior").

A case with "thin": n returns each gradient leaf as every k-th entry of
its flattened values (at most n of them) and no state: a large model's
tensors need not travel back from the ranks.

The "sde", "vae" and "prior" cases on a model axis also return "tags": the
`Block` (dim, parts, size, rank) of each parameter, moment and EMA tensor
of the state, and of each parameter as the ops saw it at the first forward
(`param_block`, beside its live shape and whether it was a DTensor), so
that FSDP2's swaps of the parameters show whether the blocks survive.
"""

from __future__ import annotations

import contextlib
import gc
import shutil
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)


def _np(tensors: dict, tags: dict | None = None) -> dict[str, np.ndarray]:
    """Each tensor whole (`fsdp.full_tensors`: a pipeline's blocks from every
    stage too), as numpy."""
    from toycrystals_torch.parallel.fsdp import full_tensors

    return {k: v.detach().cpu().numpy().copy() for k, v in full_tensors(tensors, tags).items()}


def _state_np(state) -> dict:
    names = list(state.params)
    return {"params": _np(state.params), "mu": _np(dict(zip(names, state.opt_state.mu))),
            "nu": _np(dict(zip(names, state.opt_state.nu))),
            "ema": None if state.ema_params is None else _np(state.ema_params),
            "step": state.step, "count": state.opt_state.count}


def _grads_np(model, grads) -> dict[str, np.ndarray]:
    """Gradients by name, whole: an FSDP2 shard's gathered over "data", a
    model or expert block's by its parameter's `Block`, a pipeline stage's
    blocks from every stage."""
    params = dict(_params(model))
    return _np(dict(zip(params, grads)), params)


def _params(model):
    """(name, parameter) of the model inside its placement."""
    from toycrystals_torch.parallel.expert import ExpertPlaced

    inner = _inner(model)
    return (inner.module if isinstance(inner, ExpertPlaced) else inner).named_parameters()


def _thinned(case: dict, out: dict) -> dict:
    """`out` as a "thin" case returns it (module docstring)."""
    n = case.get("thin")
    if not n:
        return out

    def thin(g):
        return g.reshape(-1)[::max(1, g.size // n)].copy()

    out = {k: v for k, v in out.items() if k not in ("params", "mu", "nu", "ema", "tags")}
    out["grads"] = ([{k: thin(v) for k, v in g.items()} for g in out["grads"]]
                    if isinstance(out["grads"], list) else
                    {k: thin(v) for k, v in out["grads"].items()})
    return out


def _blk(b) -> list[int] | None:
    return None if b is None else [b.dim, b.parts, b.size, b.rank]


def _tags(state, live: dict) -> dict:
    """What the "tags" of a model-axis case hold (module docstring)."""
    from toycrystals_torch.parallel.tensor import block_of

    names = list(state.params)
    parts = {"params": state.params, "mu": dict(zip(names, state.opt_state.mu)),
             "nu": dict(zip(names, state.opt_state.nu)), "ema": state.ema_params or {}}
    return {"live": live, **{part: {k: _blk(block_of(v)) for k, v in tensors.items()}
                             for part, tensors in parts.items()}}


def _watch_blocks(model, live: dict):
    """A forward pre-hook on the model (inside DDP, or the FSDP2 module,
    whose own hook gathers the parameters first) that records, at the first
    forward, every sharded parameter as the ops see it; returns its
    handle."""
    from toycrystals_torch.parallel.fsdp import is_sharded
    from toycrystals_torch.parallel.tensor import param_block

    net = _inner(model)

    def hook(*_):
        for name, module in net.named_modules():
            for pname in getattr(module, "tp_blocks", {}):
                key = f"{name}.{pname}" if name else pname
                p = getattr(module, pname)
                live.setdefault(key, {"shape": list(p.shape), "dtensor": is_sharded(p),
                                      "block": _blk(param_block(module, pname))})

    return net.register_forward_pre_hook(hook)


def _model_axis(mesh) -> bool:
    from toycrystals_torch.parallel.mesh import MODEL, mesh_axes

    return mesh is not None and MODEL in mesh_axes(mesh)


def _inner(model):
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) else model


def _load(model, state_dict: dict, device) -> Any:
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()},
                          strict=True)
    return model.to(device)


def _place(mesh, model, tx, fsdp: bool, ema: bool = False, n_micro: int = 1, fill=None):
    from toycrystals_torch.parallel import place_state
    from toycrystals_torch.train.state import create_train_state

    state = create_train_state(model, tx, ema=ema)
    if fill is not None:
        _fill(state, fill)
    return place_state(mesh, model, state, fsdp, n_micro=n_micro)


def _axis(mesh, axis: str) -> bool:
    from toycrystals_torch.parallel.mesh import axis_size

    return mesh is not None and axis_size(mesh, axis) > 1


def _gather_rows(mesh, x: torch.Tensor) -> np.ndarray:
    """The global batch's rows of x from every data rank's."""
    from toycrystals_torch.parallel.mesh import AXIS, axis_group, axis_size

    if mesh is not None and axis_size(mesh, AXIS) > 1:
        parts = [torch.empty_like(x) for _ in range(axis_size(mesh, AXIS))]
        dist.all_gather(parts, x.contiguous(), group=axis_group(mesh, AXIS))
        x = torch.cat(parts)
    return x.cpu().numpy()


def _net(case: dict, device, mesh=None):
    """The case's model ("net": "unet" (default), "vae" or "prior"; the MoE
    prior where the model has "n_experts") from its state_dict, or drawn by
    flax's initializers from "init_seed" (a large model need not travel to
    the ranks; on a mesh rank 0 alone draws it, since the placement gives
    every rank rank 0's weights) from a torch.Generator on the case's device
    (a full-width prior in milliseconds, where numpy takes seconds), and its
    flax bridge (utils/params.py)."""
    from toycrystals_torch.models.diffusion_prior import DiffusionPriorFiLM
    from toycrystals_torch.models.moe_prior import DiffusionPriorMoE
    from toycrystals_torch.models.sde_score_model import CondUNetTiny
    from toycrystals_torch.models.vae import CondVAE
    from toycrystals_torch.utils import params

    kw, net = case["model"], case.get("net", "unet")
    if net == "prior":
        model, bridge = (DiffusionPriorMoE(**kw) if "n_experts" in kw
                         else DiffusionPriorFiLM(**kw)), params.PRIOR
    else:
        model, bridge = ((CondVAE(**kw), params.VAE) if net == "vae"
                         else (CondUNetTiny(**kw), params.UNET))
    if "state_dict" not in case:
        from toycrystals_torch.models.torch_init import flax_default_init

        model.to(device)
        if mesh is None or dist.get_rank() == 0:
            flax_default_init(model, torch.Generator(device).manual_seed(case["init_seed"]))
        return model, bridge
    return _load(model, case["state_dict"], device), bridge


def _rows(mesh, case: dict, keys, device) -> list[torch.Tensor]:
    """This rank's rows of each input, and of the height of 4-D ones."""
    from toycrystals_torch.parallel.mesh import SPACE, axis_size, shard_batch
    from toycrystals_torch.parallel.spatial import space_rows

    out = [shard_batch(mesh, _t(case[k], device)) for k in keys]
    if mesh is None or axis_size(mesh, SPACE) == 1:
        return out
    return [t[:, space_rows(mesh, t.shape[1])] if t.dim() == 4 else t for t in out]


def _opt(case: dict):
    """Adam as the case asks ("opt": lr, clip, skip), keeping every update's
    gradients in `seen`."""
    from toycrystals_torch.train.state import Optimizer

    class Recorded(Optimizer):
        def update(self, params, grads, state):
            seen.append(list(grads))
            return super().update(params, grads, state)

    seen: list = []
    o = case.get("opt", {})
    tx = Recorded(o.get("lr", 1e-3), clip_grad_norm=o.get("clip", 0.0),
                  skip_nonfinite=o.get("skip", 0))
    object.__setattr__(tx, "seen", seen)
    return tx


def _sde(mesh, case: dict, device) -> dict:
    from toycrystals_torch.models.sde_score_model import VPSDE
    from toycrystals_torch.parallel.fsdp import local
    from toycrystals_torch.train.steps import make_sde_train_step

    model, _ = _net(case, device, mesh)
    tx = _opt(case)
    decay = case.get("opt", {}).get("ema", 0.0)
    module, state = _place(mesh, model, tx, case.get("fsdp", False), ema=decay > 0.0)
    sde = VPSDE(**case.get("sde", {"beta_min": 0.1, "beta_max": 30.0}))
    step = make_sde_train_step(module, tx, sde, case["model"]["n_types"], 0.0, 1.0, decay,
                               case.get("param", "eps"), case.get("grad_accum", 1),
                               mesh=mesh)
    keys = ("x0", "y_cat", "y_cont", "t", "eps")
    out: dict[str, Any] = {"losses": [], "step_ms": []}
    live: dict = {}
    watch = _watch_blocks(module, live)
    for i in range(len(case["x0"])):
        x0, yc, yv, t, eps = _rows(mesh, {k: case[k][i] for k in keys}, keys, device)
        _sync(device)
        t0 = time.perf_counter()
        state, loss = step(state, x0, yc, yv, noise=(t, eps))
        out["losses"].append(float(loss))
        _sync(device)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    watch.remove()
    out["grads"] = _grads_np(module, tx.seen[0])
    out.update(_state_np(state))
    out["shards"] = {k: local(p).detach().cpu().numpy().copy() for k, p in state.params.items()}
    out["tags"] = _tags(state, live)
    return out


def _epoch(mesh, case: dict, device) -> dict:
    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.models.sde_score_model import VPSDE, CondUNetTiny
    from toycrystals_torch.train.steps import make_sde_train_epoch

    model = _load(CondUNetTiny(**case["model"]), case["state_dict"], device)
    tx = _opt(case)
    module, state = _place(mesh, model, tx, False)
    epoch = make_sde_train_epoch(module, tx, VPSDE(0.1, 30.0), case["model"]["n_types"],
                                 case.get("p_uncond", 0.1), 1.0, 0.0, case["batch"],
                                 case["items"], lattice_cfg=LatticeConfig(**case["lattice"]),
                                 dataset_seed=case["seed"], mesh=mesh,
                                 parameterization=case.get("param", "eps"))
    gen = torch.Generator(device=device).manual_seed(case["seed"])
    _sync(device)
    t0 = time.perf_counter()
    state, loss = epoch(state, gen)
    loss = float(loss)
    epoch_ms = (time.perf_counter() - t0) * 1e3
    return {"loss": loss, "epoch_ms": epoch_ms,
            "grads": [_grads_np(module, g) for g in tx.seen], "params": _np(state.params)}


def _space_grads(mesh, case: dict, device) -> dict:
    """On this rank of a mesh with a space axis: x [B, C, H, W] (its rows of
    H), v [S, ...] (its entry) and t [B, N, heads, d] (its share of the N
    tokens); for each op, the gradient of sum(op(input) * cot[s]) with the
    case's upstream gradient cot of this space rank s: the halo exchange
    wrapped and clamped (`pad_rows`), the sum over "space"
    (`all_reduce_space_sum`), the gather of tokens (`gather_space`), and
    GroupNorm+SiLU under space with pad off and on (`gn_silu_space`: dx,
    dscale and dbias, this rank's own sums)."""
    from toycrystals_torch.ops.groupnorm import gn_silu_space
    from toycrystals_torch.parallel import spatial
    from toycrystals_torch.parallel.mesh import SPACE, axis_rank, axis_size

    s, n = axis_rank(mesh, SPACE), axis_size(mesh, SPACE)
    x = _t(case["x"], device)
    x = x[:, :, spatial.space_rows(mesh, x.shape[2])]
    t = _t(case["t"], device)
    t = t.chunk(n, dim=1)[s]
    v = _t(case["v"], device)[s]
    scale, bias = _t(case["scale"], device), _t(case["bias"], device)
    out = {}

    def grads(fn, *inputs, cot):
        leaves = [a.detach().clone().requires_grad_(True) for a in inputs]
        (fn(*leaves) * _t(cot, device)[s]).sum().backward()
        return [a.grad.cpu().numpy() for a in leaves]

    with spatial.dispatch_scope(mesh) as shard:
        for name, circular in (("wrap", True), ("clamp", False)):
            out[f"halo_{name}"], = grads(lambda a: spatial.pad_rows(a, shard, circular), x,
                                         cot=case[f"cot_halo_{name}"])
        out["space_sum"], = grads(lambda a: spatial.all_reduce_space_sum(a, shard), v,
                                  cot=case["cot_sum"])
        out["gather"], = grads(lambda a: spatial.gather_space(a, shard, 1), t,
                               cot=case["cot_gather"])
        for pad in (False, True):
            out[f"gn_pad{int(pad)}"] = grads(
                lambda a, sc, bi: gn_silu_space(a, sc, bi, case["groups"], 1e-6, pad, shard),
                x, scale, bias, cot=case[f"cot_gn_pad{int(pad)}"])
    return out


def _block(mesh, case: dict, device) -> dict:
    """One layer ("attention": SelfAttention2d, "groupnorm": GroupNormSiLU)
    on this rank's part of x, forward and backward."""
    from toycrystals_torch.ops.attention import SelfAttention2d
    from toycrystals_torch.ops.groupnorm import GroupNormSiLU
    from toycrystals_torch.parallel import spatial
    from toycrystals_torch.parallel import tensor as tp

    from toycrystals_torch.parallel.mesh import SPACE, axis_size

    cls = SelfAttention2d if case["kind"] == "attention" else GroupNormSiLU
    block = _load(cls(**case["model"]), case["state_dict"], device)
    x = _t(case["x"], device)
    hs = slice(None) if mesh is None or axis_size(mesh, SPACE) == 1 \
        else spatial.space_rows(mesh, x.shape[2])
    cs = slice(None)
    if _model_axis(mesh):
        tp.shard_params(block, mesh)
        blk = tp.block_of(block.weight if cls is GroupNormSiLU else block.proj.weight)
        cs = slice(None) if blk is None else tp.take_block(torch.arange(x.shape[1]), blk)
    cot = _t(case["cot"], device)
    # a padded output's rows: this rank's and the halo row on each side
    ys = hs if cot.shape[2] == x.shape[2] or hs.start is None else \
        slice(hs.start, hs.stop + cot.shape[2] - x.shape[2])
    x = x[:, cs][:, :, hs].clone().requires_grad_(True)
    with spatial.dispatch_scope(mesh):
        y = block(x)
        (y * cot[:, cs][:, :, ys]).sum().backward()
        out, dx = (tp.whole(t, case["x"].shape[1]) for t in (y.detach(), x.grad))
    return {"out": out.cpu().numpy(), "dx": dx.cpu().numpy(),
            "grads": _grads_np(block, [p.grad for p in block.parameters()])}


def _full_params(mesh, case: dict, device) -> dict:
    """The flax tree that `full_params` gathers from this rank's blocks."""
    from toycrystals_torch.parallel.tensor import full_params

    return {"flax": full_params(_score_model(case, device, mesh))}


def _vae(mesh, case: dict, device) -> dict:
    from toycrystals_torch.train.steps import make_vae_train_step

    model, _ = _net(dict(case, net="vae"), device, mesh)
    tx = _opt(case)
    module, state = _place(mesh, model, tx, case.get("fsdp", False))
    x, yc, yv, eps, keep = _rows(mesh, case, ("x", "y_cat", "y_cont", "eps", "keep"), device)
    beta, fb = case["beta_eff"], case["free_bits"]
    live: dict = {}
    watch = _watch_blocks(module, live)
    _sync(device)
    t0 = time.perf_counter()
    state, m = make_vae_train_step(module, tx, fb, mesh=mesh)(state, x, yc, yv, beta,
                                                              noise=(eps, keep))
    metrics = {k: float(v) for k, v in m.items()}
    step_ms = (time.perf_counter() - t0) * 1e3
    watch.remove()
    return {"metrics": metrics, "step_ms": step_ms, "grads": _grads_np(module, tx.seen[0]),
            "tags": _tags(state, live), **_state_np(state)}


def _vae_epoch(mesh, case: dict, device) -> dict:
    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.train.steps import make_vae_train_epoch

    model, _ = _net(dict(case, net="vae"), device, mesh)
    tx = _opt(case)
    module, state = _place(mesh, model, tx, case.get("fsdp", False))
    epoch = make_vae_train_epoch(module, tx, case["free_bits"], case["batch"], case["items"],
                                 lattice_cfg=LatticeConfig(**case["lattice"]),
                                 dataset_seed=case["seed"], mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(case["seed"])
    _sync(device)
    t0 = time.perf_counter()
    state, m = epoch(state, case["beta_eff"], gen)
    metrics = {k: float(v) for k, v in m.items()}
    epoch_ms = (time.perf_counter() - t0) * 1e3
    return {"metrics": metrics, "epoch_ms": epoch_ms,
            "grads": [_grads_np(module, g) for g in tx.seen],
            **({} if case.get("thin") else _state_np(state))}


def _prior(mesh, case: dict, device) -> dict:
    from toycrystals_torch.models.diffusion_prior import DiffusionSchedule
    from toycrystals_torch.parallel import spatial
    from toycrystals_torch.train.steps import make_prior_train_step

    from toycrystals_torch.parallel.mesh import PIPE

    model, _ = _net(dict(case, net="prior"), device, mesh)
    tx = _opt(case)
    module, state = _place(mesh, model, tx, case.get("fsdp", False),
                           n_micro=case.get("micro", 1))
    del model
    sched = DiffusionSchedule.from_arrays(case["betas"], case["alpha_bars"], device)
    z0n, yc, yv, t, eps = _rows(mesh, case, ("z0n", "y_cat", "y_cont", "t", "eps"), device)
    aux = case.get("aux_weight", 0.0)
    step = make_prior_train_step(module, tx, sched.T, aux, mesh)
    live: dict = {}
    watch = _watch_blocks(module, live)
    held = {"params": {k: list(v.shape) for k, v in state.params.items()},
            "mu": {k: list(v.shape) for k, v in zip(state.params, state.opt_state.mu)}}
    extra, steps_ms = {}, []
    if device.type == "cuda":
        held_tensors = [*state.params.values(), *state.opt_state.mu, *state.opt_state.nu]
        extra["state_bytes"] = sum(t_.numel() * t_.element_size() for t_ in held_tensors)
    for i in range(case.get("steps", 1)):  # the last step's time, peak and hops are kept
        if i == case.get("steps", 1) - 1:
            if device.type == "cuda":
                extra["allocated_bytes"] = int(torch.cuda.memory_allocated())
                torch.cuda.reset_peak_memory_stats()
            if _axis(mesh, PIPE):
                module.hop_seconds, module.hops = 0.0, 0
        _sync(device)
        t0 = time.perf_counter()
        state, m = step(state, sched, z0n, yc, yv, noise=(t, eps))
        metrics = {k: v.cpu().numpy() for k, v in m.items()}
        steps_ms.append((time.perf_counter() - t0) * 1e3)
    watch.remove()
    if device.type == "cuda":
        extra["step_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    if _axis(mesh, PIPE):
        extra["hop_s_per_tick"] = module.hop_seconds / max(module.hops, 1)
        extra["hops"] = module.hops
    out = {"metrics": metrics, "step_ms": steps_ms[-1], "steps_ms": steps_ms,
           "route_fraction": None, "held": held,
           "grads": _grads_np(module, tx.seen[0]), **extra}
    if not case.get("thin"):
        out.update(tags=_tags(state, live), **_state_np(state))
    if aux:  # last: a forward without backward leaves FSDP2's parameters gathered
        with torch.no_grad(), spatial.dispatch_scope(mesh):
            _, stats = _inner(module)(sched.q_sample(z0n, t, eps), t, yc, yv,
                                      return_stats=True, mesh=mesh)
        out["route_fraction"] = [f.cpu().numpy() for f in stats["route_fraction"]]
    if "ddim" in case:  # the updated prior's forward and DDIM (`_forward_ddim`)
        out.update(_forward_ddim(mesh, module, sched, case["ddim"], device))
    return out


def _forward_ddim(mesh, module, sched, case: dict, device) -> dict:
    """The placed prior's forward on (z_t, t, y_cat, y_cont) and DDIM
    ("ddim_steps") from the injected start noise z, each on this rank's rows,
    gathered over "data"; with DDIM's seconds."""
    from toycrystals_torch.models.diffusion_prior import ddim_sample
    from toycrystals_torch.parallel import spatial

    z_t, t, yc, yv, z = _rows(mesh, case, ("z_t", "t", "y_cat", "y_cont", "z"), device)
    with torch.no_grad(), spatial.dispatch_scope(mesh):
        eps = module(z_t, t, yc, yv)
    _sync(device)
    t0 = time.perf_counter()
    z0 = ddim_sample(module, sched, yc, yv, case["ddim_steps"], z.shape[1], z=z)
    _sync(device)
    return {"forward": _gather_rows(mesh, eps), "ddim": _gather_rows(mesh, z0),
            "ddim_s": time.perf_counter() - t0}


def _prior_apply(mesh, case: dict, device) -> dict:
    from toycrystals_torch.models.diffusion_prior import DiffusionSchedule

    model, _ = _net(dict(case, net="prior"), device, mesh)
    module, _ = _place(mesh, model, _opt(case), False, n_micro=case.get("micro", 1))
    del model
    sched = DiffusionSchedule.from_arrays(case["betas"], case["alpha_bars"], device)
    return _forward_ddim(mesh, module, sched, case, device)


def _distill(mesh, case: dict, device) -> dict:
    from toycrystals_torch.models.sde_score_model import VPSDE, CondUNetTiny
    from toycrystals_torch.train.distill import make_distill_train_step

    teacher = _load(CondUNetTiny(**case["model"]), case["teacher"], device)
    teacher.eval().requires_grad_(False)
    student = _load(CondUNetTiny(**case["model"]), case["state_dict"], device)
    tx = _opt(case)
    module, state = _place(mesh, student, tx, case.get("fsdp", False))
    x0, yc, yv, i, eps = _rows(mesh, case, ("x0", "y_cat", "y_cont", "i", "eps"), device)
    step = make_distill_train_step(module, teacher, tx, VPSDE(0.1, 30.0), case["n"],
                                   n_types=case["model"]["n_types"],
                                   guidance_scale=case["cfg"],
                                   teacher_prediction=case["teacher_prediction"],
                                   t_end=case["t_end"], mesh=mesh)
    state, loss = step(state, x0, yc, yv, noise=(i, eps))
    return {"loss": float(loss), "grads": _grads_np(module, tx.seen[0]), **_state_np(state)}


def _score_model(case: dict, device, mesh=None):
    from toycrystals_torch.models.sde_score_model import CondUNetTiny
    from toycrystals_torch.parallel.tensor import shard_params

    model = _load(CondUNetTiny(**case["model"]), case["state_dict"], device)
    if _model_axis(mesh):
        shard_params(model, mesh)
    return model.eval().requires_grad_(False)


def _apply_fn(case: dict, sde, device, mesh=None):
    from toycrystals_torch.models.sde_score_model import eps_apply_from_v

    model = _score_model(case, device, mesh)
    return eps_apply_from_v(sde, model) if case.get("param") == "v" else model


@contextlib.contextmanager
def _first_int8_scale(out: dict | None):
    """With `out`, record the first int8 activation scale of the block as
    out["int8_scale"] = (this rank's own max|x|, the scale used): the first
    conv's input is the injected noise and its maps, the same bits on a mesh
    and in one process, so its scale shows whether the max spans the mesh."""
    if out is None:
        yield
        return
    from toycrystals_torch.ops import conv

    real = conv.quantize_int8

    def recording(x, dims=None, shard=None):
        q, scale = real(x, dims, shard)
        if dims is None and "int8_scale" not in out:
            out["int8_scale"] = (float(x.abs().amax().float()), float(scale))
        return q, scale

    conv.quantize_int8 = recording
    try:
        yield
    finally:
        conv.quantize_int8 = real


def _sample(mesh, case: dict, device) -> dict:
    from toycrystals_torch.models import sde_score_model as sm
    from toycrystals_torch.models.flow_matching import sample_rectified_flow

    samplers = {"sde": sm.sample_reverse_sde_euler_maruyama,
                "ode": sm.sample_probability_flow_ode, "dpm": sm.sample_dpmpp_2m,
                "ddim": sm.sample_ddim, "rf": sample_rectified_flow}
    sampler = samplers[case.get("sampler", "sde")]
    sde = sm.VPSDE(0.1, 30.0)
    model = _apply_fn(case, sde, device, mesh)
    yc, yv = _t(case["y_cat"], device), _t(case["y_cont"], device)
    kw = dict(n_steps=case["n_steps"], guidance_scale=case["cfg"], n_types=4)

    def injected(apply_fn, sde, y_cat, y_cont, shape, gen, *, x_init, z=None, **kw):
        noise = x_init if z is None else (x_init, z.transpose(0, 1))
        return sampler(apply_fn, sde, y_cat, y_cont, shape, noise=noise, **kw)

    shape = tuple(case["shape"])
    bkw = {k: _t(case[k], device) for k in ("x_init", "z") if k in case}
    out = {}
    with torch.inference_mode(), _first_int8_scale(out if case.get("record_scale") else None):
        out["injected"] = sm.sample_chunked(injected, model, sde, yc, yv, shape, case["seed"],
                                            chunk=case["chunk"], mesh=mesh, batch_kw=bkw, **kw)
    with torch.inference_mode():
        if case.get("drawn", True):
            out["drawn"] = sm.sample_chunked(sampler, model, sde, yc, yv, shape, case["seed"],
                                             chunk=case["chunk"], mesh=mesh, **kw)
    return out


def _forward(mesh, case: dict, device) -> dict:
    from toycrystals_torch.parallel import spatial
    from toycrystals_torch.parallel.mesh import data_sharding

    model = _score_model(case, device, mesh)
    x, t, yc, yv = (_t(case[k], device) for k in ("x", "t", "y_cat", "y_cont"))
    rows = data_sharding(mesh, x.shape[0])
    hs = spatial.space_rows(mesh, x.shape[1]) if mesh is not None else slice(None)
    with torch.inference_mode(), spatial.dispatch_scope(mesh):
        out = model(x[rows][:, hs], t[rows], yc[rows], yv[rows])
    return {"out": spatial.gather_image(mesh, out).cpu().numpy()}


def _inpaint(mesh, case: dict, device) -> dict:
    from toycrystals_torch.models import sde_score_model as sm

    sde = sm.VPSDE(0.1, 30.0)
    model = _apply_fn(case, sde, device, mesh)
    yc, yv = _t(case["y_cat"], device), _t(case["y_cont"], device)

    def injected(apply_fn, sde, y_cat, y_cont, shape, gen, *, x_init, draws, **kw):
        # draws arrive [B, n_steps, resample, 3, H, W, 1], the batch first
        return sm.sample_inpaint_reverse_sde(apply_fn, sde, y_cat, y_cont, shape,
                                             noise=(x_init, draws.permute(1, 2, 3, 0, 4, 5, 6)),
                                             **kw)

    bkw = {k: _t(case[k], device) for k in ("x_init", "draws", "x_known", "mask")}
    with torch.inference_mode():
        x = sm.sample_chunked(injected, model, sde, yc, yv,
                              tuple(case["shape"]), 0, chunk=case["shape"][0], mesh=mesh,
                              batch_kw=bkw, n_steps=case["n_steps"], guidance_scale=case["cfg"],
                              n_types=4, resample=case["resample"])
    return {"injected": x}


def _halo(mesh, case: dict, device) -> dict:
    from toycrystals_torch.parallel import spatial
    from toycrystals_torch.parallel.mesh import data_sharding

    x = _t(case["x"], device)
    x = x[data_sharding(mesh, x.shape[0])][:, :, spatial.space_rows(mesh, x.shape[2])]
    with spatial.dispatch_scope(mesh) as shard:
        return {k: spatial.pad_rows(x, shard, circular=k == "wrap").cpu().numpy()
                for k in ("wrap", "clamp")}


def _service(mesh, case: dict, device) -> dict:
    from toycrystals_torch.serve import ScoreModelService

    svc = ScoreModelService(case["config"], case["params"], device=device, mesh=mesh,
                            buckets=case["buckets"], **case.get("settings", {}))
    xs, seconds = [], []
    for y_cat, y_cont, seed in case["requests"]:
        _sync(device)
        t0 = time.perf_counter()
        xs.append(svc.sample(y_cat, y_cont, seed=seed))
        _sync(device)
        seconds.append(time.perf_counter() - t0)
    return {"x": xs, "buckets": list(svc.buckets), "seconds": seconds}


def _dcp(mesh, case: dict, device) -> dict:
    from toycrystals_torch.utils.orbax_io import ShardedCheckpointManager

    model, _ = _net(case, device, mesh)
    tx = _opt(case)
    _, state = _place(mesh, model, tx, case.get("fsdp", True), ema=True)
    with ShardedCheckpointManager(case["path"], max_to_keep=case.get("keep", 1)) as mgr:
        _sync(device)
        t0 = time.perf_counter()
        if case["kind"] == "dcp_save":
            _fill(state, case["seed"])
            t0 = time.perf_counter()
            mgr.save(case.get("step", 1), state, tx, {"epoch_next": 1, "loss_hist": [],
                                                      "config": {}})
            mgr.wait()
        else:
            state, _ = mgr.restore_onto(state)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
    return {"ms": ms, **_state_np(state)}


def _msgpack(mesh, case: dict, device) -> dict:
    from toycrystals_torch.utils.checkpoint import _to_plain
    from toycrystals_torch.utils.msgpack_codec import packb
    from toycrystals_torch.utils.params import train_state_to_checkpoint

    from toycrystals_torch.parallel.mesh import EXPERT, PIPE

    model, bridge = _net(case, device, mesh)
    tx = _opt(case)
    if _axis(mesh, PIPE) or _axis(mesh, EXPERT):
        # the whole state filled, then placed: each rank takes its pieces
        _, state = _place(mesh, model, tx, False, ema=True, n_micro=case.get("micro", 1),
                          fill=case["seed"])
    else:
        _, state = _place(mesh, model, tx, case.get("fsdp", False), ema=True)
        _fill(state, case["seed"])
    return {"bytes": packb(_to_plain(train_state_to_checkpoint(state, tx, bridge)))}


def _fill(state, seed: int) -> None:
    """Give the moments, the EMA and the counters values of their own, the
    same on every rank (each writes its shard of them)."""
    from toycrystals_torch.parallel.fsdp import copy_full_, full

    g = torch.Generator().manual_seed(seed)
    tensors = [*state.opt_state.mu, *state.opt_state.nu, *state.ema_params.values()]
    for t in tensors:
        copy_full_(t, torch.randn(tuple(full(t).shape), generator=g))
    state.step, state.opt_state.count = 7, 5


CASES = {"sde": _sde, "epoch": _epoch, "vae": _vae, "vae_epoch": _vae_epoch, "prior": _prior,
         "prior_apply": _prior_apply,
         "distill": _distill, "sample": _sample, "forward": _forward, "inpaint": _inpaint,
         "service": _service,
         "halo": _halo, "space_grads": _space_grads, "attention": _block, "groupnorm": _block,
         "full_params": _full_params, "dcp_save": _dcp, "dcp_load": _dcp, "msgpack": _msgpack}


def cli_state(fn, argv, state: bool = True) -> dict:
    """A rank's entry for a train CLI's `fn(argv)` (train_diffusion_prior's
    `train`): its per-epoch losses, with `state` the state it ends with,
    whole (a collective over the mesh), and the last grid's images
    ("samples", where it keeps them), what the rank printed ("stdout") and
    the launches of the port's kernels in the run ("launches", from 0)."""
    import io

    buf = io.StringIO()
    _zero_launches()
    with contextlib.redirect_stdout(buf):
        run = fn(argv)
    out = {"losses": list(run.loss_hist), "samples": getattr(run, "samples", None),
           "stdout": buf.getvalue(), "launches": _launches()}
    return {**out, **_state_np(run.state)} if state else out


def cli_states(fn, argvs, state: bool = True) -> list[dict]:
    """`cli_state` of each argv in turn in the same ranks (an epoch, then its
    --resume): one spawn for both."""
    return [cli_state(fn, argv, state) for argv in argvs]


def in_turn(calls) -> list:
    """A rank's entry that makes each (fn, args) of `calls` in turn in the
    same ranks (one spawn for them all) and returns (result, seconds) of
    each; garbage is collected between calls, so what one call left behind
    does not count in the next one's device memory."""
    out = []
    for fn, args in calls:
        t0 = time.perf_counter()
        out.append((fn(*args), time.perf_counter() - t0))
        gc.collect()
    return out


def keep_copy(src: str, dst: str) -> None:
    """Rank 0 copies file `src` to `dst` (a checkpoint that the next run in
    the same ranks overwrites); the other ranks go on."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        shutil.copyfile(src, dst)


def cli_images(fn, argv) -> dict:
    """A rank's entry for a sampling CLI's `fn(argv)` (sample_sde_score_model's
    `sample`, inpaint_sde_score_model's `inpaint`): the images it returned
    and, where it prints one, its JSON line."""
    run = fn(argv)
    return {"x": run.x, "line": getattr(run, "line", None)}


def setup_mesh_probe(calls) -> list:
    """A rank's entry: the CLIs' `setup_mesh(shard, **kw)` for each (shard,
    kw) of `calls` in turn (on the CPU), and of the mesh it builds the axis
    names, this rank's coordinate on each, and the global ranks of its
    `replica_group` in group order; or the message it exits with."""
    from toycrystals_torch.parallel.mesh import axis_rank, mesh_axes, replica_group
    from toycrystals_torch.scripts._common import setup_mesh

    out = []
    for shard, kw in calls:
        try:
            mesh = setup_mesh(shard, device=torch.device("cpu"), **kw)
        except SystemExit as e:
            out.append({"exit": str(e)})
            continue
        axes = mesh_axes(mesh)
        out.append({"axes": list(axes), "coords": [axis_rank(mesh, a) for a in axes],
                    "replicas": dist.get_process_group_ranks(replica_group(mesh)[0])})
    return out


def halo_probe(device_type: str) -> tuple[float, float, float, float]:
    """One rank of a (1, world) mesh: x [1, 1, 2, 3] filled with the rank;
    returns the (top, bottom) halo rows of the wrapped and of the clamped
    exchange (parallel/spatial.py), each as the one value it holds."""
    from toycrystals_torch.parallel import spatial
    from toycrystals_torch.parallel.mesh import make_mesh_2d

    device = torch.device("cpu") if device_type == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh_2d(1, dist.get_world_size(), device_type=device.type)
    x = torch.full((1, 1, 2, 3), float(dist.get_rank()), device=device)
    with spatial.dispatch_scope(mesh) as shard:
        rows = [*spatial.halo_rows(x, shard, True), *spatial.halo_rows(x, shard, False)]
    out = []
    for r in rows:
        assert r.shape == (1, 1, 1, 3) and bool((r == r.flatten()[0]).all())
        out.append(float(r.flatten()[0]))
    return tuple(out)


def _counters():
    from toycrystals_torch.data import rasterize as rz
    from toycrystals_torch.ops import attention as at
    from toycrystals_torch.ops import groupnorm as gn

    return {"gn_silu": (gn.gn_silu, "launches"),
            "gn_silu_backward": (gn.gn_silu, "backward_launches"),
            "gn_silu_sums": (gn.gn_silu, "sums_launches"),
            "gn_silu_apply": (gn.gn_silu, "apply_launches"),
            "gn_silu_backward_sums": (gn.gn_silu, "backward_sums_launches"),
            "gn_silu_backward_apply": (gn.gn_silu, "backward_apply_launches"),
            "rasterize": (rz.rasterize, "launches"),
            "flash_attn": (at.flash_sdpa, "launches"),
            "flash_attn_backward": (at.flash_sdpa, "backward_launches")}


def _zero_launches() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _launches() -> dict[str, int]:
    return {k: int(getattr(fn, attr)) for k, (fn, attr) in _counters().items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cases(spec: dict) -> list[dict]:
    """Every case of `spec` on this rank's rows (see the module docstring);
    the mesh spans the process group when there is one. Each result holds
    the launches of the port's kernels in the case ("launches", counted from
    0 by each wrapper), and on a CUDA device the case's peak device memory
    of this process ("peak_bytes")."""
    from toycrystals_torch.parallel.mesh import (
        make_mesh,
        make_mesh_2d,
        make_mesh_3d,
        make_mesh_ep,
        make_mesh_pp,
        make_mesh_tp,
    )

    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        if spec.get("tf32", False) is not None:
            torch.backends.cuda.matmul.allow_tf32 = bool(spec.get("tf32", False))
            torch.backends.cudnn.allow_tf32 = bool(spec.get("tf32", False))
    meshes: dict = {}

    def mesh_of(shape):
        if not dist.is_initialized() or spec.get("one_process"):
            return None
        if shape not in meshes:  # every rank builds the same meshes in the same order
            if not shape:
                meshes[shape] = make_mesh(device_type=device.type)
            elif shape[3:] == ("3d",):
                meshes[shape] = make_mesh_3d(*shape[:3], device_type=device.type)
            elif shape[2:]:
                make = {"model": make_mesh_tp, "pipe": make_mesh_pp,
                        "expert": make_mesh_ep}[shape[2]]
                meshes[shape] = make(*shape[:2], device_type=device.type)
            else:
                meshes[shape] = make_mesh_2d(*shape, device_type=device.type)
        return meshes[shape]

    out = []
    for case in spec["cases"]:
        mesh = mesh_of(tuple(case.get("mesh") or spec.get("mesh") or ()))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        res = _thinned(case, CASES[case["kind"]](mesh, case, device))
        res["launches"] = _launches()
        if device.type == "cuda":
            res["peak_bytes"] = int(torch.cuda.max_memory_allocated())
        out.append(res)
    return out
