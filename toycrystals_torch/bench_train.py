"""Steady training rate of the score model on one CUDA card, of this tree or
of several trees in turns.

    python -m toycrystals_torch.bench_train [--stem s2dr] [--dtype bfloat16]
        [--size 64] [--epochs 6] [--steps 5] [--root DIR [--root DIR ...]]

Full width (base_ch 96, emb_dim 128, lr 1e-4, EMA 0.999, rot_only data
rendered on the card) through `make_sde_train_epoch`, as chip_smoke.py trains
it: at 64x64 batch 128 with eps prediction; at `--size 256` the 256x256
recipe, batch 32, v prediction on the schedule shifted by -2.77. Prints one
JSON line per run with the steps/s of every epoch after the first, which
warms the libraries up.

With `--root`, each DIR is a checkout that holds a `toycrystals_torch`
package (this one, an earlier commit unpacked beside it). Every root runs in
a process of its own, in the order given and then in reverse (A B B A), so
that a drift of the host or of the card's clocks falls on both alike. The
launch-bound s2dr bf16 step follows the host more than the card, so compare
two trees only within one such call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


# image size -> (batch, parameterization, logsnr shift)
RECIPES = {64: (128, "eps", 0.0), 256: (32, "v", -2.77)}


def run(stem: str, dtype: str, epochs: int, steps: int, size: int = 64) -> dict:
    import numpy as np
    import torch

    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.models.sde_score_model import VPSDE, CondUNetTiny
    from toycrystals_torch.models.torch_init import flax_default_init
    from toycrystals_torch.train.state import Optimizer, create_train_state
    from toycrystals_torch.train.steps import make_sde_train_epoch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_train needs a CUDA card")
    batch, param, shift = RECIPES[size]
    model = CondUNetTiny(4, 4, base_ch=96, emb_dim=128, cond_ch=8, time_ch=8, stem=stem,
                         dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    model = flax_default_init(model, np.random.default_rng(0)).to("cuda")
    tx = Optimizer(1e-4)
    state = create_train_state(model, tx, ema=True)
    epoch = make_sde_train_epoch(model, tx, VPSDE(0.1, 30.0, shift), batch_size=batch,
                                 n_items=steps * batch,
                                 lattice_cfg=LatticeConfig(img_size=size, rot_only=True),
                                 dataset_seed=0, fresh_data=True, parameterization=param,
                                 n_types=4, p_uncond=0.1, t_power=1.0, ema_decay=0.999)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rates, loss = [], float("nan")
    for e in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = epoch(state, gen, e * steps * batch)
        torch.cuda.synchronize()
        rates.append(steps / (time.perf_counter() - t0))
    return dict(root=os.getcwd(), stem=stem, dtype=dtype, size=size, batch=batch,
                steps_per_epoch=steps,
                steps_per_s=rates[1:], last_loss=float(loss),
                card=torch.cuda.get_device_name(0))


def run_in_turns(cmd: list[str], roots: list[str]) -> int:
    """Run `cmd` once per root and then once per root in reverse (A B B A),
    each in a process of its own with the root's `toycrystals_torch` package
    (PYTHONPATH finds it there). Returns the first non-zero exit code, else 0."""
    for root in roots + roots[::-1]:
        env = dict(os.environ, PYTHONPATH=root)
        rc = subprocess.run(cmd, cwd=root, env=env).returncode
        if rc != 0:
            return rc
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stem", default="s2dr", choices=("none", "s2dr"))
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--size", type=int, default=64, choices=sorted(RECIPES))
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout to measure in a process of its own; repeatable")
    args = ap.parse_args()
    if not args.root:
        print(json.dumps(run(args.stem, args.dtype, args.epochs, args.steps, args.size)),
              flush=True)
        return 0
    roots = [os.path.abspath(r) for r in args.root]
    cmd = [sys.executable, os.path.abspath(__file__), "--stem", args.stem, "--dtype", args.dtype,
           "--size", str(args.size), "--epochs", str(args.epochs), "--steps", str(args.steps)]
    return run_in_turns(cmd, roots)


if __name__ == "__main__":
    sys.exit(main())
