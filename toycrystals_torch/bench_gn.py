"""Device time of the GroupNorm+SiLU(+halo) kernels on one CUDA card, of this
tree or of several trees in turns.

    python -m toycrystals_torch.bench_gn [--shape 512,96,64,64 ... | --space]
        [--iters 50] [--root DIR [--root DIR ...]]

At each shape [B, C, H, W] (default: "s" [512, 96, 64, 64], the 64x64
serving call; "t" [128, 96, 64, 64], the 64x64 training call; "h"
[24, 96, 256, 256] and [32, 96, 256, 256], the 256x256 serving and training
calls; and the four activations of a 2-row 256x256 forward, one image under
CFG) x is bf16 in 8 groups with the halo (pad=True), as the U-Net's first
GroupNorm of a block gives it. Times, with CUDA events over `--iters` calls
after a warm-up: the forward `gn_silu` (no autograd), its backward
(`torch.autograd.grad` through a forward that needs gradients: the backward
kernel, or whatever backward the tree has), and as the yardstick
F.group_norm + F.silu + F.pad(circular) forward and backward on the same
values. The device time of the kernels whose names hold "gn_silu", from
`torch.profiler` over `--iters` calls, comes beside each pass's time
(`forward_kernel_ms`, `backward_kernel_ms`: 0 where the tree's backward has
no such kernel), since a small call's CUDA-event time follows the host.
Beside them the bytes bounds at 3.35 TB/s: forward x read and the
output written once; backward x and the upstream gradient read and dx
written once. Prints one JSON line per run, with the card's name and power
limit as `nvidia-smi` gives them, and each shape's launch plan where the tree
has `kernel_plan`.

With `--space`, the space axis's pair instead: the sums kernel (`gn_sums`)
and the apply kernel (`gn_silu_apply`) at one rank's rows of the 256x256
path at S = 2 (`SPACE_SHAPES`, as `chip_smoke.py`'s `SPACE_GN_SHAPES`), bf16
and f32, pad off and on, with the statistics of two ranks' sums. Per case:
CUDA-event ms of each call (`sums_ms`, `apply_ms`), the profiler's device ms
of the kernel (`sums_kernel_ms`, `apply_kernel_ms`) and of every kernel the
call launches (`sums_device_ms`, `apply_device_ms`), the bytes bounds at
3.35 TB/s (sums: x read once; apply: x read and the output written once) and
each kernel's share of its bound, the largest error against the plain
version, and the launch plan where the tree has `space_kernel_plan`.

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

DEFAULT_SHAPES = ("512,96,64,64", "128,96,64,64", "24,96,256,256", "32,96,256,256",
                  "2,96,256,256", "2,192,128,128", "2,192,64,64", "2,96,128,128")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
GROUPS = 8
# one rank's rows of the 256x256 path's GroupNorm calls at S = 2 (24 rows: 12
# images under CFG)
SPACE_SHAPES = [("256 down1/up1", (24, 96, 128, 256)), ("256 down2", (24, 192, 64, 128)),
                ("256 up2", (24, 96, 64, 128)), ("256 mid", (24, 192, 32, 64))]


def run(shapes: list[tuple[int, int, int, int]], iters: int) -> dict:
    import torch
    import torch.nn.functional as F

    from toycrystals_torch.bench_flash import cuda_ms, kernel_ms, nvidia_smi
    from toycrystals_torch.ops import groupnorm as gn

    if not torch.cuda.is_available():
        raise RuntimeError("bench_gn needs a CUDA card")
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, c, h, w in shapes:
        x = (torch.randn((b, c, h, w), generator=gen, device="cuda") * 2.0 + 0.5).to(
            torch.bfloat16)
        scale = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1.0
        bias = torch.randn(c, generator=gen, device="cuda") * 0.1
        up = torch.randn((b, c, h + 2, w + 2), generator=gen, device="cuda").to(torch.bfloat16)
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, scale, bias)]

        def forward():
            with torch.no_grad():
                return gn.gn_silu(x, scale, bias, GROUPS, 1e-6, True)

        fwd = cuda_ms(forward, iters)
        fwd_kernel = kernel_ms(forward, iters, ("gn_silu",))["gn_silu"]
        y = gn.gn_silu(*leaves, GROUPS, 1e-6, True)

        def backward():
            return torch.autograd.grad(y, leaves, up, retain_graph=True)

        bwd = cuda_ms(backward, iters)
        bwd_kernel = kernel_ms(backward, iters, ("gn_silu",))["gn_silu"]
        del y

        def library():
            out = F.silu(F.group_norm(leaves[0], GROUPS, leaves[1].to(torch.bfloat16),
                                      leaves[2].to(torch.bfloat16), eps=1e-6))
            return F.pad(out, (1, 1, 1, 1), mode="circular")

        with torch.no_grad():
            lib_fwd = cuda_ms(library, iters)
        lib_y = library()
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_y, leaves, up, retain_graph=True),
                          iters)
        del lib_y
        n_in, n_out = b * c * h * w, b * c * (h + 2) * (w + 2)
        row = dict(shape=[b, c, h, w], forward_ms=fwd, forward_kernel_ms=fwd_kernel,
                   backward_ms=bwd, backward_kernel_ms=bwd_kernel,
                   library_forward_ms=lib_fwd, library_backward_ms=lib_bwd,
                   forward_bound_ms=(n_in + n_out) * 2 / HBM_BYTES_PER_S * 1e3,
                   backward_bound_ms=(2 * n_in + n_out) * 2 / HBM_BYTES_PER_S * 1e3)
        row["forward_bound_share"] = row["forward_bound_ms"] / fwd_kernel
        row["backward_bound_share"] = (row["backward_bound_ms"] / bwd_kernel if bwd_kernel
                                       else None)
        if hasattr(gn, "kernel_plan"):
            row["plan"] = gn.kernel_plan((b, c, h, w), GROUPS, torch.bfloat16, True)
            row["backward_plan"] = gn.kernel_plan((b, c, h, w), GROUPS, torch.bfloat16, True,
                                                  backward=True)
        rows.append(row)
        del x, up, leaves
        torch.cuda.empty_cache()
    return dict(root=os.getcwd(), card=nvidia_smi("name,power.limit"), iters=iters, rows=rows)


def run_space(iters: int) -> dict:
    import torch

    from toycrystals_torch.bench_flash import cuda_ms, kernel_ms, nvidia_smi
    from toycrystals_torch.ops import groupnorm as gn

    if not torch.cuda.is_available():
        raise RuntimeError("bench_gn needs a CUDA card")
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (b, c, h, w) in SPACE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, other = ((torch.randn((b, c, h, w), generator=gen, device="cuda") * 2 + 0.5).to(
                dtype) for _ in range(2))
            scale = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1.0
            bias = torch.randn(c, generator=gen, device="cuda") * 0.1
            sums = gn.gn_sums(x, GROUPS) + gn.gn_sums(other, GROUPS)
            count = c // GROUPS * h * w * 2
            elem = x.element_size()
            for pad in (False, True):
                row = dict(shape=label, dims=[b, c, h, w], dtype=str(dtype).replace("torch.", ""),
                           pad=pad)

                def sums_call():
                    return gn.gn_sums(x, GROUPS)

                def apply_call():
                    return gn.gn_silu_apply(x, sums, count, scale, bias, GROUPS, pad=pad)

                for name, fn, kernel in (("sums", sums_call, "gn_silu_sums"),
                                         ("apply", apply_call, "gn_silu_apply")):
                    row[f"{name}_ms"] = cuda_ms(fn, iters)
                    # the kernel, and every other kernel of the call ("" matches any)
                    dev = kernel_ms(fn, iters, (kernel, ""))
                    row[f"{name}_kernel_ms"] = dev[kernel]
                    row[f"{name}_device_ms"] = dev[kernel] + dev[""]
                p = 1 if pad else 0
                n_in, n_out = b * c * h * w, b * c * (h + 2 * p) * (w + 2 * p)
                row["sums_bound_ms"] = (n_in * elem + b * GROUPS * 8) / HBM_BYTES_PER_S * 1e3
                row["apply_bound_ms"] = (((n_in + n_out) * elem + 2 * c * 4) / HBM_BYTES_PER_S
                                         * 1e3)
                for name in ("sums", "apply"):
                    row[f"{name}_bound_share"] = (row[f"{name}_bound_ms"]
                                                  / row[f"{name}_kernel_ms"])
                want = gn.gn_sums_reference(x, GROUPS)
                row["sums_max_rel_err"] = float(((sums_call() - want).abs()
                                                 / want.abs().clamp(min=1.0)).max())
                want = gn.gn_silu_apply_reference(x, sums, count, scale, bias, GROUPS, pad=pad)
                row["apply_max_abs_err"] = float((apply_call().float() - want.float()).abs()
                                                 .max())
                del want
                if hasattr(gn, "space_kernel_plan"):
                    row["plan"] = gn.space_kernel_plan((b, c, h, w), GROUPS, dtype, pad)
                rows.append(row)
            del x, other
            torch.cuda.empty_cache()
    return dict(root=os.getcwd(), card=nvidia_smi("name,power.limit"), iters=iters, rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", action="append", default=[],
                    help="B,C,H,W; repeatable (default: the main paths' bf16 calls)")
    ap.add_argument("--space", action="store_true",
                    help="time the space axis's sums and apply kernels instead")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout to measure in a process of its own; repeatable")
    args = ap.parse_args()
    specs = args.shape or list(DEFAULT_SHAPES)
    if not args.root:
        if args.space:
            print(json.dumps(run_space(args.iters)), flush=True)
            return 0
        shapes = [tuple(int(v) for v in s.split(",")) for s in specs]
        print(json.dumps(run(shapes, args.iters)), flush=True)
        return 0
    # this tree's runner; each run imports its root's package
    from toycrystals_torch.bench_train import run_in_turns

    roots = [os.path.abspath(r) for r in args.root]
    cmd = [sys.executable, os.path.abspath(__file__), "--iters", str(args.iters)]
    if args.space:
        cmd.append("--space")
    for s in args.shape:
        cmd += ["--shape", s]
    return run_in_turns(cmd, roots)


if __name__ == "__main__":
    sys.exit(main())
