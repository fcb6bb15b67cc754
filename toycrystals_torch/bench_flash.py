"""Device time of the flash-attention kernels on one CUDA card, of this tree
or of several trees in turns.

    python -m toycrystals_torch.bench_flash [--dtype bfloat16|float32]
        [--shape 24,4096,4,48[,Nk] ...] [--iters 50] [--root DIR [--root DIR ...]]

At each shape [B, N, heads, d] q, k and v are views of one [B, N, 3, heads,
d] projection, as `SelfAttention2d` hands them over; with a fifth number Nk,
q is [B, N, heads, d] against k and v, views of one [B, Nk, 2, heads, d]
tensor (a rank's queries against the keys gathered over a space axis).
Defaults: the 256x256 model's serving and training calls, [24|32, 4096, 4,
48], and in float32 also a rank's calls at S = 2, [24|32, 2048, 4, 48]
against 4,096 keys. Times, with CUDA events over `--iters` launches after a
warm-up: the forward `flash_sdpa` (no autograd), its backward pass (delta,
dK/dV, dQ kernels), and `F.scaled_dot_product_attention` forward and
backward on the same values as the yardstick, and the plain version,
`sdpa_reference` (3 launches). Each backward kernel's own time comes from
`torch.profiler` device times over `--iters` passes (`backward_kernel_ms`).
Beside the times, the bounds at the tensor cores' peak: the forward's 2
products (`forward_bound_ms`), the backward's 5 (`backward_bound_ms`) and the
7 that the kernels do, S and exp(S - L) being formed in both dK/dV and dQ
(`backward_floor_ms`); bf16 products at the bf16 rate, f32 ones as three
TF32 products each (hi hi + hi lo + lo hi) at the TF32 rate. Prints one JSON
line per run, with the card's name, power limit and top SM clock as
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
import subprocess
import sys

DEFAULT_SHAPES = {"bfloat16": ("24,4096,4,48", "32,4096,4,48"),
                  "float32": ("24,4096,4,48", "32,4096,4,48", "24,2048,4,48,4096",
                              "32,2048,4,48,4096")}
# H100 SXM dense tensor-core peaks (NVIDIA data sheet); an f32-accurate product
# is three TF32 products
OPS_PER_S = {"bfloat16": 989e12, "float32": 495e12 / 3}
BACKWARD_KERNELS = ("flash_delta", "flash_dkv", "flash_dq")
# torch.profiler can lose kernel records: a window may keep fewer kernels
# than were launched in it, or none (`window_probe`). `kernel_ms` takes the
# first of up to PROFILE_TRIES windows in which every kernel launch has its
# record; `window_probe` opens PROBE_WINDOWS windows of each kind.
PROFILE_TRIES = 5
PROBE_WINDOWS = 10


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


def _profiled(fn, iters: int, cpu: bool = False):
    """`torch.profiler` over `iters` calls of `fn` (after one warm-up); with
    `cpu`, the host's runtime calls too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof


def _records(prof, names=("",)) -> tuple[list, set]:
    """(the window's kernel records whose names hold one of `names`, the
    correlation ids of its kernel launch calls that have no kernel record)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA]
    launched = {e.correlation_id() for e in events
                if e.device_type() != DeviceType.CUDA and "LaunchKernel" in e.name()}
    return ([k for k in kernels if any(n in k.name() for n in names)],
            launched - {k.correlation_id() for k in kernels})


def kernel_ms(fn, iters: int, names=BACKWARD_KERNELS) -> dict[str, float]:
    """Device ms per call of `fn` of each kernel whose name holds one of
    `names`, from `torch.profiler` (CPU and CUDA activities) over `iters`
    calls after one warm-up: from the first of up to PROFILE_TRIES windows
    in which every kernel launch of the host has its kernel's record
    (RuntimeError where none had)."""
    from torch.autograd import DeviceType

    for _ in range(PROFILE_TRIES):
        prof = _profiled(fn, iters, cpu=True)
        if not _records(prof)[1]:
            break
    else:
        raise RuntimeError(f"torch.profiler lost kernel records in each of {PROFILE_TRIES} "
                           f"windows")
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        hit = [n for n in names if n in e.key]
        if e.device_type == DeviceType.CUDA and hit:
            out[hit[0]] += e.self_device_time_total / 1e3 / iters
    return out


def window_probe(fn, iters: int, name: str) -> dict:
    """What torch.profiler keeps in this process: PROBE_WINDOWS windows of
    `iters` calls of `fn` with CUDA activity alone and as many with CPU and
    CUDA activities, each kind counted empty where a window kept no kernel
    `name`, with the fewest of the `iters` kernels any of its windows kept;
    and, in the CPU and CUDA windows, the kernel launches left without a
    record, and the lag, in ms, of each kernel's start after its launch
    call's start (the same correlation id; positive and a few microseconds
    where the two clocks agree)."""
    import statistics

    from torch.autograd import DeviceType

    out = {"iters": iters, "windows": PROBE_WINDOWS}
    lost, lags = 0, []
    for label, cpu in (("cuda", False), ("cpu_cuda", True)):
        counts = []
        for _ in range(PROBE_WINDOWS):
            prof = _profiled(fn, iters, cpu)
            if cpu:
                kernels, missing = _records(prof, (name,))
                counts.append(len(kernels))
                lost += len(missing)
                events = prof.profiler.kineto_results.events()
                launch = {e.correlation_id(): e.start_ns() for e in events
                          if e.device_type() != DeviceType.CUDA and "LaunchKernel" in e.name()}
                lags += [(k.start_ns() - launch[k.correlation_id()]) / 1e6 for k in kernels
                         if k.correlation_id() in launch]
            else:
                counts.append(sum(e.count for e in prof.key_averages()
                                  if e.device_type == DeviceType.CUDA and name in e.key))
        out[f"empty_{label}"] = sum(c == 0 for c in counts)
        out[f"fewest_kept_{label}"] = min(counts)
    out.update(launches_without_record=lost,
               launch_lag_ms=[min(lags), statistics.median(lags), max(lags)] if lags else None)
    return out


def run(shapes: list[tuple[int, ...]], iters: int, dtype: str = "bfloat16") -> dict:
    import torch
    import torch.nn.functional as F

    from toycrystals_torch.ops import attention as at

    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash needs a CUDA card")
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    tdtype = getattr(torch, dtype)
    for shape in shapes:
        b, n, h, d = shape[:4]
        nk = shape[4] if len(shape) > 4 else n
        if nk == n:
            qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(tdtype)
            leaves = [qkv[:, :, i].detach().requires_grad_(True) for i in range(3)]
        else:
            q = torch.randn((b, n, h, d), generator=gen, device="cuda").to(tdtype)
            kv = torch.randn((b, nk, 2, h, d), generator=gen, device="cuda").to(tdtype)
            leaves = [t.detach().requires_grad_(True) for t in (q, kv[:, :, 0], kv[:, :, 1])]
        up = torch.randn((b, n, h, d), generator=gen, device="cuda").to(tdtype)
        row = dict(shape=[b, n, h, d], nk=nk, dtype=dtype)
        with torch.no_grad():
            row["forward_ms"] = cuda_ms(lambda: at.flash_sdpa(*leaves), iters)
            lib_leaves = [t.detach().transpose(1, 2) for t in leaves]
            row["library_forward_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(*lib_leaves), iters)
            row["plain_forward_ms"] = cuda_ms(lambda: at.sdpa_reference(*leaves), 3, 1)
        out = at.flash_sdpa(*leaves)

        def backward():
            return torch.autograd.grad(out, leaves, up, retain_graph=True)

        row["backward_ms"] = cuda_ms(backward, iters)
        row["backward_kernel_ms"] = kernel_ms(backward, iters)
        lib_leaves = [t.detach().transpose(1, 2).requires_grad_(True) for t in leaves]
        lib = F.scaled_dot_product_attention(*lib_leaves)
        row["library_backward_ms"] = cuda_ms(
            lambda: torch.autograd.grad(lib, lib_leaves, up.transpose(1, 2), retain_graph=True),
            iters)
        del lib, lib_leaves
        ref = at.sdpa_reference(*leaves)
        row["plain_backward_ms"] = cuda_ms(
            lambda: torch.autograd.grad(ref, leaves, up, retain_graph=True), 3, 1)
        del ref
        flop, rate = 4 * b * h * n * nk * d, OPS_PER_S[dtype]
        row.update(forward_tflops=flop / row["forward_ms"] / 1e9,
                   forward_bound_ms=flop / rate * 1e3,
                   backward_tflops=2.5 * flop / row["backward_ms"] / 1e9,
                   backward_bound_ms=2.5 * flop / rate * 1e3,
                   backward_floor_ms=3.5 * flop / rate * 1e3)
        rows.append(row)
        del leaves, up, out
        torch.cuda.empty_cache()
    return dict(root=os.getcwd(), card=nvidia_smi("name,power.limit"),
                sm_clock_max=nvidia_smi("clocks.max.sm"), iters=iters, rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(OPS_PER_S))
    ap.add_argument("--shape", action="append", default=[],
                    help="B,N,heads,d[,Nk]; repeatable (default: the 256x256 model's calls)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout to measure in a process of its own; repeatable")
    args = ap.parse_args()
    specs = args.shape or list(DEFAULT_SHAPES[args.dtype])
    if not args.root:
        shapes = [tuple(int(x) for x in s.split(",")) for s in specs]
        print(json.dumps(run(shapes, args.iters, args.dtype)), flush=True)
        return 0
    # this tree's runner; each run imports its root's package (an older root may lack it)
    from toycrystals_torch.bench_train import run_in_turns

    roots = [os.path.abspath(r) for r in args.root]
    cmd = [sys.executable, os.path.abspath(__file__), "--iters", str(args.iters),
           "--dtype", args.dtype]
    for s in specs:
        cmd += ["--shape", s]
    return run_in_turns(cmd, roots)


if __name__ == "__main__":
    sys.exit(main())
