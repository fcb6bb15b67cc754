"""The reference's torch `.pt` checkpoints: the score model, the VAE and the
latent prior.

Counterpart of toycrystals_tpu/utils/torch_interop.py. The original torch implementation
checkpoints `CondUNetTiny` as `{"epoch_next", "model": state_dict, "opt",
"loss_hist", "config", ["ema"]}`; scripts/export_torch_checkpoint.py (and the
port's toycrystals_torch/scripts/export_torch_checkpoint.py) write the same
layout from a msgpack checkpoint. This module maps those state_dict names
onto the flax param tree that the port's weight bridge (utils/params.py) and
the JAX package share, and back (`torch_state_dict_from_flax_params`):

- Conv2d  [out, in, kh, kw] -> kernel [kh, kw, in, out]
- Linear  [out, in]         -> kernel [in, out]
- 1x1 Conv2d of the attention's qkv and proj -> Dense kernel [in, out]
- GroupNorm weight/bias     -> scale/bias
- Embedding weight          -> embedding

The optimiser state does not convert (its layout differs); sampling and
warm starts need the weights only. Files are read with
`torch.load(weights_only=True)`: tensors and plain containers, nothing that
unpickling would have to run.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from toycrystals_torch.utils.params import flax_prior_from_torch_state_dict

# (reference module prefix, flax block name) for the five double-conv blocks
_BLOCKS = [("down1", "down1"), ("down2", "down2"), ("mid", "mid"),
           ("up2", "up2"), ("up1", "up1")]
# reference Sequential index -> (flax sublayer, kind)
_BLOCK_LAYERS = [("0", "conv0", "conv"), ("1", "gn0", "gn"),
                 ("3", "conv1", "conv"), ("4", "gn1", "gn")]
_CONVS = ["ds1", "ds2", "us2_conv", "us1_conv", "out"]
# reference linear prefix -> flax path
_LINEARS = [
    ("time_mlp.0", ("Dense_0",)),
    ("time_mlp.2", ("Dense_1",)),
    ("cond_emb.cont_mlp.0", ("ConditionEmbedding_0", "Dense_0")),
    ("cond_emb.cont_mlp.2", ("ConditionEmbedding_0", "Dense_1")),
    ("cond_emb.out.1", ("ConditionEmbedding_0", "out")),
    ("to_time_map", ("to_time_map",)),
    ("to_cond_map", ("to_cond_map",)),
]


def _spec() -> list[tuple[str, tuple[str, ...], str]]:
    """(reference prefix, flax path, kind) for every parameterised layer."""
    spec: list[tuple[str, tuple[str, ...], str]] = []
    for tname, fname in _BLOCKS:
        for tidx, fsub, kind in _BLOCK_LAYERS:
            spec.append((f"{tname}.net.{tidx}", (fname, fsub), kind))
    spec += [(name, (name,), "conv") for name in _CONVS]
    spec += [(tname, fpath, "linear") for tname, fpath in _LINEARS]
    spec += [("attn.norm", ("attn", "GroupNorm_0"), "gn"),
             ("attn.qkv", ("attn", "qkv"), "conv1x1"),
             ("attn.proj", ("attn", "proj"), "conv1x1"),
             ("cond_emb.cat_emb", ("ConditionEmbedding_0", "cat_emb"), "embed")]
    return spec


def _arr(t: Any) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t, dtype=np.float32)


def flax_params_from_torch_state_dict(sd: Mapping[str, Any]) -> dict:
    """Reference CondUNetTiny state_dict -> flax param tree (numpy leaves).
    Raises KeyError naming the missing key for any other state_dict."""
    params: dict = {}
    for tprefix, fpath, kind in _spec():
        node = params
        for k in fpath:
            node = node.setdefault(k, {})
        if kind == "embed":
            node["embedding"] = _arr(sd[f"{tprefix}.weight"])
            continue
        w, b = _arr(sd[f"{tprefix}.weight"]), _arr(sd[f"{tprefix}.bias"])
        if kind == "conv":
            node["kernel"] = w.transpose(2, 3, 1, 0)
        elif kind == "conv1x1":
            node["kernel"] = w[:, :, 0, 0].T
        elif kind == "linear":
            node["kernel"] = w.T
        else:  # gn
            node["scale"] = w
        node["bias"] = b
    return params


def torch_state_dict_from_flax_params(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Flax CondUNetTiny param tree -> the reference's state_dict (numpy f32,
    contiguous); the exact inverse of `flax_params_from_torch_state_dict`."""

    def get(path: tuple[str, ...], leaf: str) -> np.ndarray:
        node: Any = params
        for k in path:
            node = node[k]
        return np.asarray(node[leaf], dtype=np.float32)

    sd: dict[str, np.ndarray] = {}
    for tprefix, fpath, kind in _spec():
        if kind == "embed":
            sd[f"{tprefix}.weight"] = get(fpath, "embedding")
            continue
        w = get(fpath, "scale" if kind == "gn" else "kernel")
        if kind == "conv":
            w = w.transpose(3, 2, 0, 1)
        elif kind == "conv1x1":
            w = w.T[:, :, None, None]
        elif kind == "linear":
            w = w.T
        sd[f"{tprefix}.weight"] = np.ascontiguousarray(w)
        sd[f"{tprefix}.bias"] = get(fpath, "bias")
    return sd


def load_torch_score_checkpoint(path: str) -> dict:
    """A reference `.pt` score-model checkpoint as the msgpack payload
    schema `{"epoch_next", "state": {"params", "ema_params"}, "loss_hist",
    "config"}`; the weights and the config convert, the Adam state does not."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict) or "model" not in obj:
        raise ValueError(f"{path} is not a reference score-model checkpoint (expected a dict "
                         "with a 'model' state_dict)")
    params = flax_params_from_torch_state_dict(obj["model"])
    ema = flax_params_from_torch_state_dict(obj["ema"]) if "ema" in obj else None
    return {
        "epoch_next": int(obj.get("epoch_next", 0)),
        "state": {"params": params, "ema_params": ema},
        "loss_hist": [float(v) for v in obj.get("loss_hist", [])],
        "config": dict(obj.get("config", {})),
    }


# The reference VAE (`CondVAE` / `VAE`) ends its encoder at a 4x4x256 map
# (64x64 input); the flatten-order permutations below are specific to that.
_VAE_C, _VAE_HW = 256, 4


def flax_vae_params_from_torch_state_dict(sd: Mapping[str, Any]) -> dict:
    """Reference CondVAE / VAE state_dict -> flax param tree (numpy leaves).

    Beyond the per-layer transposes:
    - the reference flattens the encoder's map channel-major (C, H, W) before
      `enc_fc`, the flax encoder (H, W, C): the first 4,096 input columns of
      `enc_fc` permute, and any cond-vector columns after them pass through;
    - `dec_fc`'s output is viewed as [256, 4, 4] there and reshaped as
      [4, 4, 256] in flax: its output rows and bias permute;
    - ConvTranspose2d(k4, s2, p1) weights [in, out, kh, kw] become the flax
      "SAME" kernel by transpose(2, 3, 0, 1) and a flip of both spatial axes.
    """
    c, hw = _VAE_C, _VAE_HW
    flat = c * hw * hw
    enc: dict = {}
    dec: dict = {}
    for i, t_idx in enumerate((0, 2, 4, 6)):
        enc[f"Conv_{i}"] = {"kernel": _arr(sd[f"enc.{t_idx}.weight"]).transpose(2, 3, 1, 0),
                            "bias": _arr(sd[f"enc.{t_idx}.bias"])}
    w = _arr(sd["enc_fc.weight"])  # [256, flat + y_dim]
    wf = w[:, :flat].reshape(-1, c, hw, hw).transpose(0, 2, 3, 1).reshape(-1, flat)
    enc["Dense_0"] = {"kernel": np.concatenate([wf, w[:, flat:]], axis=1).T,
                      "bias": _arr(sd["enc_fc.bias"])}
    for name in ("mu", "logvar"):
        enc[name] = {"kernel": _arr(sd[f"{name}.weight"]).T, "bias": _arr(sd[f"{name}.bias"])}
    w = _arr(sd["dec_fc.weight"]).reshape(c, hw, hw, -1).transpose(1, 2, 0, 3).reshape(flat, -1)
    b = _arr(sd["dec_fc.bias"]).reshape(c, hw, hw).transpose(1, 2, 0).reshape(flat)
    dec["Dense_0"] = {"kernel": w.T, "bias": b}
    for i, t_idx in enumerate((0, 2, 4, 6)):
        dec[f"ConvTranspose_{i}"] = {
            "kernel": np.ascontiguousarray(
                _arr(sd[f"dec.{t_idx}.weight"]).transpose(2, 3, 0, 1)[::-1, ::-1]),
            "bias": _arr(sd[f"dec.{t_idx}.bias"])}
    return {"encoder": enc, "decoder": dec}


def load_torch_vae_checkpoint(path: str) -> dict:
    """A reference `vae_last.pt` (a raw state_dict, or one under "model") ->
    `{"params": tree}`, the payload the latent prior's trainer reads for its
    frozen VAE."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    if not isinstance(sd, Mapping) or "enc.0.weight" not in sd:
        raise ValueError(f"{path} is not a reference VAE checkpoint (expected a raw CondVAE / "
                         "VAE state_dict)")
    return {"params": flax_vae_params_from_torch_state_dict(sd)}


def flax_prior_params_from_torch_state_dict(sd: Mapping[str, Any]) -> dict:
    """Reference DiffusionPriorFiLM state_dict -> flax param tree (numpy
    leaves); the block count follows the keys. The port's prior carries the
    reference's names, so this is utils/params.py's prior bridge."""
    return flax_prior_from_torch_state_dict({k: _arr(v) for k, v in sd.items()})


def load_torch_prior_checkpoint(path: str) -> dict:
    """A reference `diffusion_prior_last.pt` (a raw state_dict, or one under
    "model") -> `{"params": tree}`, for the prior trainer's --resume and
    --sample-only."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    if not isinstance(sd, Mapping) or "in_proj.weight" not in sd:
        raise ValueError(f"{path} is not a reference FiLM-prior checkpoint (expected a raw "
                         "DiffusionPriorFiLM state_dict)")
    return {"params": flax_prior_params_from_torch_state_dict(sd)}
