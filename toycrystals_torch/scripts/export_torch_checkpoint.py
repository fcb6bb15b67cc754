#!/usr/bin/env python3
"""Write a score-model msgpack checkpoint in the reference's torch `.pt` layout.

    python -m toycrystals_torch.scripts.export_torch_checkpoint --ckpt <ckpt> --out sde_ref.pt

Counterpart of scripts/export_torch_checkpoint.py: `{"epoch_next", "model":
state_dict, "opt": {}, "loss_hist", "config", ["ema"]}` with the reference's
state_dict names (`utils/torch_interop.py:torch_state_dict_from_flax_params`),
which `load_torch_score_checkpoint` and the reference's sampler read. The
optimizer state does not convert. An s2d / s2dr checkpoint has no reference
layout and is refused.

One difference: `loss_hist` holds the checkpoint's losses. The JAX script
iterates the restored history, which msgpack keeps as a dict keyed "0",
"1", ..., and so writes the floats of those keys.
"""

from __future__ import annotations

import argparse

import torch

from toycrystals_torch.utils.checkpoint import float_list, load_checkpoint
from toycrystals_torch.utils.torch_interop import torch_state_dict_from_flax_params


def export(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns the object it saved."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="path to a .msgpack score-model checkpoint")
    p.add_argument("--out", required=True, help="output .pt path")
    args = p.parse_args(argv)

    payload = load_checkpoint(args.ckpt)
    if str(payload.get("config", {}).get("stem", "none")) != "none":
        raise SystemExit("this checkpoint was trained with an s2d stem; the reference "
                         "architecture has none, so there is no torch layout to export to")
    state = payload["state"]

    def sd(tree):
        return {k: torch.tensor(v) for k, v in torch_state_dict_from_flax_params(tree).items()}

    obj = {
        "epoch_next": int(payload.get("epoch_next", 0)),
        "model": sd(state["params"]),
        "opt": {},
        "loss_hist": float_list(payload.get("loss_hist", [])),
        "config": dict(payload.get("config", {})),
    }
    if state.get("ema_params") is not None:
        obj["ema"] = sd(state["ema_params"])
    torch.save(obj, args.out)
    print(f"exported {args.ckpt} -> {args.out} ({'with' if 'ema' in obj else 'no'} EMA)")
    return obj


def main(argv: list[str] | None = None) -> int:
    export(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
