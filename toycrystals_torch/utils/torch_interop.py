"""Reading the reference's torch `.pt` score-model checkpoints.

Counterpart of the score-model half of toycrystals_tpu/utils/torch_interop.py.
The original torch implementation checkpoints `CondUNetTiny` as
`{"epoch_next", "model": state_dict, "opt", "loss_hist", "config", ["ema"]}`;
scripts/export_torch_checkpoint.py writes the same layout from a JAX
checkpoint. This module maps those state_dict names onto the flax param tree
that the port's weight bridge (utils/params.py) and the JAX package share:

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
