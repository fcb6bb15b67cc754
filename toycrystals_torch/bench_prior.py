"""Training and sampling rate of the latent diffusion prior on one CUDA card,
of this tree or of several trees in turns.

    python -m toycrystals_torch.bench_prior [--moe-experts 0] [--epochs 4]
        [--items 12800] [--profile-steps 5] [--root DIR [--root DIR ...]]

The README's recipe for the prior (T 1000, beta_end 0.05, width 1024, 8
blocks, batch 256, lr 1e-4; f32 with TF32 off, as the trainer runs it) on
random standardised latents (z 32) resident on the card, through
`make_prior_train_epoch`. Prints one JSON line per run: z/s of every epoch
after the first (which warms the libraries up), DDIM-50 seconds for 36 rows
(the median of 3), and for --profile-steps steps the wall ms per step (host
clock, outside the profiler), the device ms per step and the 8 kernels with
the most device time (torch.profiler), and the idle share 1 - device / wall.

With `--root`, each DIR is a checkout that holds a `toycrystals_torch`
package; every root runs in a process of its own, A B B A
(`bench_train.run_in_turns`).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

Z, BATCH = 32, 256


def run(moe_experts: int, epochs: int, items: int, profile_steps: int) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from toycrystals_torch.models.diffusion_prior import (
        DiffusionPriorFiLM,
        DiffusionSchedule,
        ddim_sample,
    )
    from toycrystals_torch.models.moe_prior import DiffusionPriorMoE
    from toycrystals_torch.models.sde_score_model import sample_grid_conditions
    from toycrystals_torch.models.torch_init import flax_default_init
    from toycrystals_torch.train.state import Optimizer, create_train_state
    from toycrystals_torch.train.steps import make_prior_train_epoch, make_prior_train_step

    if not torch.cuda.is_available():
        raise RuntimeError("bench_prior needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kw = dict(z_dim=Z, n_types=4, y_cont_dim=4, t_emb_dim=64, width=1024, n_blocks=8,
              y_cat_emb_dim=64)
    model = DiffusionPriorMoE(n_experts=moe_experts, **kw) if moe_experts else \
        DiffusionPriorFiLM(**kw)
    model = flax_default_init(model, np.random.default_rng(0)).to(dev)
    sched = DiffusionSchedule.linear(1000, 1e-4, 0.05, device=dev)
    aux = 0.01 if moe_experts else 0.0
    gen = torch.Generator(device=dev).manual_seed(0)
    lat = (torch.randn((items, Z), generator=gen, device=dev),
           torch.randint(0, 4, (items,), generator=gen, device=dev, dtype=torch.int32),
           torch.rand((items, 4), generator=gen, device=dev))
    tx = Optimizer(1e-4)
    state = create_train_state(model, tx)
    epoch = make_prior_train_epoch(model, tx, 1000, BATCH, lat, aux_weight=aux)
    rates = []
    for _ in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, em = epoch(state, sched, gen)
        float(em["loss"])
        rates.append((items // BATCH) * BATCH / (time.perf_counter() - t0))

    y_cat, y_cont = sample_grid_conditions(36, 4, 4, device=dev)
    ddim = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ddim_sample(model, sched, y_cat, y_cont, 50, Z, generator=gen)
        torch.cuda.synchronize()
        ddim.append(time.perf_counter() - t0)

    step = make_prior_train_step(model, tx, 1000, aux)
    batch = [a[:BATCH] for a in lat]
    step(state, sched, *batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(profile_steps):
        step(state, sched, *batch, gen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / profile_steps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(profile_steps):
            step(state, sched, *batch, gen)
        torch.cuda.synchronize()
    kernels: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key[:80]] = kernels.get(e.key[:80], 0.0) + \
                e.self_device_time_total / 1e3 / profile_steps
    device_ms = sum(kernels.values())
    return dict(root=os.getcwd(), moe_experts=moe_experts, batch=BATCH, items=items,
                z_per_s=rates[1:], ddim50_36_seconds=statistics.median(ddim),
                step_wall_ms=wall, step_device_ms=device_ms, idle_share=1.0 - device_ms / wall,
                top_kernels_ms=sorted(kernels.items(), key=lambda kv: -kv[1])[:8],
                card=torch.cuda.get_device_name(0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--moe-experts", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--items", type=int, default=12800)
    ap.add_argument("--profile-steps", type=int, default=5)
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout to measure in a process of its own; repeatable")
    args = ap.parse_args()
    if not args.root:
        print(json.dumps(run(args.moe_experts, args.epochs, args.items, args.profile_steps)),
              flush=True)
        return 0
    from toycrystals_torch.bench_train import run_in_turns

    cmd = [sys.executable, os.path.abspath(__file__), "--moe-experts", str(args.moe_experts),
           "--epochs", str(args.epochs), "--items", str(args.items), "--profile-steps",
           str(args.profile_steps)]
    return run_in_turns(cmd, [os.path.abspath(r) for r in args.root])


if __name__ == "__main__":
    sys.exit(main())
