"""Device time of the flash-attention kernels on one CUDA card, of this tree
or of several trees in turns.

    python -m toycrystals_torch.bench_flash [--shape 24,4096,4,48 ...]
        [--iters 50] [--root DIR [--root DIR ...]]

At each shape [B, N, heads, d] (default: the 256x256 model's serving and
training calls, [24|32, 4096, 4, 48]) q, k and v are bf16 views of one
[B, N, 3, heads, d] projection, as `SelfAttention2d` hands them over. Times,
with CUDA events over `--iters` launches after a warm-up: the forward
`flash_sdpa` (no autograd), its backward pass (delta, dK/dV, dQ kernels), and
`F.scaled_dot_product_attention` forward and backward on the same values as
the yardstick. Prints one JSON line per run, with the card's name, power limit
and top SM clock as `nvidia-smi` gives them.

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
import subprocess
import sys

DEFAULT_SHAPES = ("24,4096,4,48", "32,4096,4,48")


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(shapes: list[tuple[int, int, int, int]], iters: int) -> dict:
    import torch
    import torch.nn.functional as F

    from toycrystals_torch.ops import attention as at

    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash needs a CUDA card")
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, n, h, d in shapes:
        qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        up = torch.randn((b, n, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        leaves = [qkv[:, :, i].detach().requires_grad_(True) for i in range(3)]
        with torch.no_grad():
            fwd = cuda_ms(lambda: at.flash_sdpa(*leaves), iters)
            lib_leaves = [t.detach().transpose(1, 2) for t in leaves]
            lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(*lib_leaves), iters)
        out = at.flash_sdpa(*leaves)
        bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, up, retain_graph=True), iters)
        lib_leaves = [t.detach().transpose(1, 2).requires_grad_(True) for t in leaves]
        lib = F.scaled_dot_product_attention(*lib_leaves)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib, lib_leaves, up.transpose(1, 2),
                                                      retain_graph=True), iters)
        flop = 4 * b * h * n * n * d
        rows.append(dict(shape=[b, n, h, d], forward_ms=fwd, forward_tflops=flop / fwd / 1e9,
                         library_forward_ms=lib_fwd, backward_ms=bwd,
                         backward_tflops=2.5 * flop / bwd / 1e9, library_backward_ms=lib_bwd))
        del qkv, up, leaves, out, lib, lib_leaves
        torch.cuda.empty_cache()
    return dict(root=os.getcwd(), card=nvidia_smi("name,power.limit"),
                sm_clock_max=nvidia_smi("clocks.max.sm"), iters=iters, rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", action="append", default=[],
                    help="B,N,heads,d; repeatable (default: the 256x256 model's two calls)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout to measure in a process of its own; repeatable")
    args = ap.parse_args()
    specs = args.shape or list(DEFAULT_SHAPES)
    if not args.root:
        shapes = [tuple(int(x) for x in s.split(",")) for s in specs]
        print(json.dumps(run(shapes, args.iters)), flush=True)
        return 0
    # this tree's runner; each run imports its root's package (an older root may lack it)
    from toycrystals_torch.bench_train import run_in_turns

    roots = [os.path.abspath(r) for r in args.root]
    cmd = [sys.executable, os.path.abspath(__file__), "--iters", str(args.iters)]
    for s in specs:
        cmd += ["--shape", s]
    return run_in_turns(cmd, roots)


if __name__ == "__main__":
    sys.exit(main())
