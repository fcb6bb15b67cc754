"""Device time of the Gaussian-atom rasterizer kernel on one CUDA card, of
this tree or of several trees in turns.

    python -m toycrystals_torch.bench_raster [--iters 50] [--root DIR [--root DIR ...]]

Cases, on atoms from the port's own `generate_item` (seed 0, idx 0..B-1):
"train 64" (rot_only budget, 128 images of 64x64: the 64x64 training batch),
"full 64 B4096" (the full-config budget at 4,096 images, as a dataset build
renders it) and "train 256" (rot_only at 256x256, 32 images, the 9,728-point
budget: the 256x256 training batch); then smaller calls: the full config at
32 images of 64x64 and at 128 of 32x32, and 8, 2 or 1 images. Times: CUDA
events over `--iters` calls after a warm-up (`ms`; at the small calls the
wrapper's host cost), and the device time of the kernels whose name holds
"rasterize" from `torch.profiler` over as many calls (`kernel_ms`). Where
the tree has `kernel_plan`, each case also prints its plan. Beside them the
bytes bound: the inputs read once and the images written once at 3.35 TB/s.
Prints one JSON line per run, with the card's name and power limit as
`nvidia-smi` gives them.

With `--root`, each DIR is a checkout that holds a `toycrystals_torch`
package (this one, an earlier commit unpacked beside it). Every root runs in
a process of its own, in the order given and then in reverse (A B B A), so
that a drift of the card's clocks falls on both alike. Compare two trees only
within one such call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
CASES = (("train 64", dict(rot_only=True), 128), ("full 64 B4096", dict(), 4096),
         ("train 256", dict(img_size=256, rot_only=True), 32),
         ("full 64 B32", dict(), 32), ("full 32 B128", dict(img_size=32), 128),
         ("train 64 B8", dict(rot_only=True), 8), ("train 64 B1", dict(rot_only=True), 1),
         ("train 256 B2", dict(img_size=256, rot_only=True), 2),
         ("train 256 B1", dict(img_size=256, rot_only=True), 1))


def run(iters: int) -> dict:
    import torch

    from toycrystals_torch.bench_flash import cuda_ms, kernel_ms, nvidia_smi
    from toycrystals_torch.data import rasterize as rz
    from toycrystals_torch.data.lattice import LatticeConfig, generate_item, static_point_budget

    if not torch.cuda.is_available():
        raise RuntimeError("bench_raster needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for label, kw, b in CASES:
        cfg = LatticeConfig(**kw)
        pts, wts, sigma, *_ = generate_item(cfg, static_point_budget(cfg), 0, torch.arange(b),
                                            "cuda")
        h = w = cfg.img_size
        p = pts.shape[1]

        def call():
            return rz.rasterize(pts, wts, sigma, h, w)

        row = dict(case=label, b=b, p=p, h=h, w=w, active_atoms=int((wts != 0).sum()),
                   ms=cuda_ms(call, iters),
                   kernel_ms=kernel_ms(call, iters, ("rasterize",))["rasterize"],
                   bound_ms=b * (3 * p + h * w + 1) * 4 / HBM_BYTES_PER_S * 1e3)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        if hasattr(rz, "kernel_plan"):
            row["plan"] = rz.kernel_plan(b, p, h, w)
        rows.append(row)
        del pts, wts, sigma
        torch.cuda.empty_cache()
    return dict(root=os.getcwd(), card=nvidia_smi("name,power.limit"), iters=iters, rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout to measure in a process of its own; repeatable")
    args = ap.parse_args()
    if not args.root:
        print(json.dumps(run(args.iters)), flush=True)
        return 0
    # this tree's runner; each run imports its root's package
    from toycrystals_torch.bench_train import run_in_turns

    roots = [os.path.abspath(r) for r in args.root]
    cmd = [sys.executable, os.path.abspath(__file__), "--iters", str(args.iters)]
    return run_in_turns(cmd, roots)


if __name__ == "__main__":
    sys.exit(main())
