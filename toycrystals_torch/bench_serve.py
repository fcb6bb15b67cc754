"""Serving rate of the score model on one CUDA card, of this tree or of
several trees in turns.

    python -m toycrystals_torch.bench_serve [--stem none s2dr] [--images 256]
        [--steps 300] [--repeats 1] [--root DIR [--root DIR ...]]

Full width (base_ch 96, emb_dim 128, 64x64, bf16, flax's default init from
seed 0) through `ScoreModelService` at the reference settings (reverse SDE,
CFG 1.5, t_end 0.005) with one bucket of --images, as chip_smoke.py phase 6
times it: a 10-step request of the same shape warms the libraries up, then
--repeats requests of --images at --steps are timed on the host's clock.
Prints one JSON line per run with img/s per request and the card's name.

With `--root`, each DIR is a checkout that holds a `toycrystals_torch`
package (this one, an earlier commit unpacked beside it). Every root runs in
a process of its own, in the order given and then in reverse (A B B A), so
that a drift of the host or of the card's clocks falls on both alike.
Compare two trees only within one such call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from toycrystals_torch.bench_train import run_in_turns


def run(stems: list[str], images: int, steps: int, repeats: int) -> dict:
    import numpy as np
    import torch

    from toycrystals_torch.models.sde_score_model import CondUNetTiny
    from toycrystals_torch.models.torch_init import flax_default_init
    from toycrystals_torch.serve import ScoreModelService
    from toycrystals_torch.utils.params import flax_from_torch_state_dict

    if not torch.cuda.is_available():
        raise RuntimeError("bench_serve needs a CUDA card")
    out = dict(root=os.getcwd(), images=images, steps=steps,
               card=torch.cuda.get_device_name(0), img_per_s={})
    types, thetas = np.arange(images) % 4, np.linspace(0.0, 1.0, images)
    for stem in stems:
        net = flax_default_init(CondUNetTiny(4, 4, base_ch=96, emb_dim=128, stem=stem),
                                np.random.default_rng(0))
        cfg = dict(n_types=4, y_cont_dim=4, base_ch=96, emb_dim=128, cond_ch=8, time_ch=8,
                   img_size=64, stem=stem, dtype="bfloat16")
        params = flax_from_torch_state_dict(net.state_dict())
        warm = ScoreModelService(cfg, params, steps=10, buckets=(images,))
        warm.sample_conditions(types, thetas, seed=0)
        del warm
        svc = ScoreModelService(cfg, params, steps=steps, buckets=(images,))
        rates = []
        for r in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.sample_conditions(types, thetas, seed=r)
            rates.append(images / (time.perf_counter() - t0))
        out["img_per_s"][stem] = rates
        del svc
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stem", nargs="+", default=["none", "s2dr"], choices=("none", "s2dr"))
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout to measure in a process of its own; repeatable")
    args = ap.parse_args()
    if not args.root:
        print(json.dumps(run(args.stem, args.images, args.steps, args.repeats)), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in args.root]
    cmd = [sys.executable, os.path.abspath(__file__), "--stem", *args.stem,
           "--images", str(args.images), "--steps", str(args.steps),
           "--repeats", str(args.repeats)]
    return run_in_turns(cmd, roots)


if __name__ == "__main__":
    sys.exit(main())
