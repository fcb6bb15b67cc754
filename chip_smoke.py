#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (toycrystals_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--json-out PATH]

Phases, each printing its own lines; any failure exits non-zero with no
result line:

1. Environment: torch version, the card's name and power limit, and the
   seconds to build every CUDA kernel of the port from toycrystals_torch/csrc
   (one nvcc per library, all at once; the flash-attention source is built
   once per head dim).
2. GroupNorm+SiLU(+halo) forward kernel parity and timing against its plain
   PyTorch version on the card at every shape the served U-Net gives it
   (parity and s2dr stems, batch 512 = 256 images under CFG, and the 256x256
   model at 24 and at 2 rows), pad on and off, f32 and bf16, plus odd shapes,
   each with the cluster size its launch takes. Times of the kernel, the
   plain version, the library yardstick (F.group_norm + F.silu + F.pad) and
   the bound (bytes at 3.35 TB/s). Then the forward and backward kernels under
   autograd at every shape the training U-Net gives it (batch 128, both stems,
   and batch 32 at 256x256; f32 and bf16, pad on and off): output, and the
   gradients of x, scale and bias against the closed-form plain backward
   `gn_silu_backward_reference` and against autograd through the plain
   version on the same leaves; the times of the kernel forward and backward,
   the plain forward and backward, the library yardstick's forward and
   backward, and both bounds.
3. Rasterizer kernel parity and timing against its plain version on the card:
   the training batch (128 images, rot_only budget), the full-config budget at
   128 and 4096 images, the 32x32 budget, the 256x256 training batch (32
   images, 9,728-point budget) and odd cases (all weights 0, one atom,
   H != W, all 9,728 atoms inside one 32-px tile, atoms just inside and just
   outside the cull's radius at sigma 1.2, 0.72 and 1.68). Each case logs its
   launch plan and the mean and largest count of atoms kept per tile; the
   training batches and the last two cases are rerun bit for bit, and render
   the same bits with the cull switched off. Times of the kernel (its device
   time from torch.profiler) and of the wrapper's calls (CUDA events), of the
   plain version with TF32 off and on, and the bound (bytes, against the f32
   operations of the (row, column) pairs whose factors are non-zero).
4. Flash-attention kernels (forward; delta, dK/dV and dQ backward) against
   the plain version `sdpa_reference` run in f32 on the same values: output
   and the gradients of q, k and v, bf16 and f32, at the flagship shapes
   [24, 4096, 4, 48] (serving) and [32, 4096, 4, 48] (training) and at other
   head dims, one of them zero-padded. Times of the forward and backward
   kernels, of the plain version, of the library yardstick
   F.scaled_dot_product_attention (timed only) and the bound (the largest of
   the tensor operations at the bf16 rate, or the f32 rate for f32 inputs,
   one exp2 per logit at 16 per clock per SM at the top SM clock, and bytes).
5. Data on the card against the CPU: generate_batch for the same (seed, idx),
   at 64x64 and for the 256x256 training batch.
6. Serving at full width (base_ch 96, emb_dim 128, 64x64, bf16, reference
   settings: reverse SDE, 300 steps, CFG 1.5, t_end 0.005) through
   ScoreModelService for the "none" and "s2dr" stems: first a 3-step f32
   run on injected noise, card against CPU; then requests of 1, 4 and 16
   images and one uint8 request, checked for shape, range, finiteness,
   determinism and exactly 10 x 301 GroupNorm launches each; then one timed
   300-step request of 256 images per stem.
7. Training at full width (batch 128, lr 1e-4, beta 0.1-30, p_uncond 0.1, EMA
   0.999, procedural rot_only data rendered on the card) through
   make_sde_train_epoch: first 2 f32 steps on injected (x0, t, eps), card
   against CPU (losses, and the gradients leaf by leaf); then 4 epochs of 5
   steps for each stem in f32 and bf16, checked for finite losses, a falling
   loss, exactly 10 GroupNorm forward, 10 GroupNorm backward and 1 rasterizer
   launches per step, and a finite EMA that left the parameters.
   Prints steps/s, img/s and peak memory.
8. Serving at 256x256, full width (stem "none": 4,096 bottleneck tokens, so
   attn_impl="auto" runs the flash kernel; param v, logsnr_shift -2.77,
   buckets 1, 4, 12): 2 f32 SDE steps on injected noise, card against CPU;
   a 1-image request twice (determinism), one timed 12-image SDE-300 request
   (24 rows: exactly 301 flash and 3,010 GroupNorm launches), one 12-image
   DPM-50 request (51 flash launches) and a 14-image DPM-50 request, which
   runs as two 12-image dispatches.
9. Training at 256x256, full width (batch 32, parameterization v, rot_only
   data rendered on the card at a 9,728-point budget): 1 f32 step on 2
   injected items, card against CPU (loss, gradients leaf by leaf); then 2
   epochs of 4 bf16 steps: finite, falling loss, exactly 1 flash forward, 1
   flash backward, 10 GroupNorm forward, 10 GroupNorm backward and 1
   rasterizer launches per step.
10. The CLIs at full width, through their `train` / `sample` functions (what
   `main(argv)` runs), into runs/chip_smoke_cli/: train_sde_score_model at
   64x64 (base_ch 96, stem none, bf16, procedural, batch 128, 1,280 items, EMA
   0.999) for 2 epochs, a --resume at --epochs 2 that trains nothing (its
   state must equal the saved one bit for bit: params, both moments, EMA,
   step and count), then --resume to 3 epochs: metrics.jsonl holds epochs 1-3
   with finite losses, the checkpoint epoch_next 3, and every step launched
   exactly 10 GroupNorm forward, 10 GroupNorm backward and 1 rasterizer
   kernels; steps/s per epoch after the first. sample_sde_score_model from
   that checkpoint (SDE-300, CFG 1.5, t_end 0.005, EMA, 36 images): exactly
   3,010 GroupNorm launches per dispatch, the PNG (read back here) holds 36
   tiles equal to the 8-bit quantisation of sample_chunked run on the model
   rebuilt from the checkpoint with the same seed and chunk; img/s.
   ScoreModelService.from_checkpoint serves a 16-image request (finite, in
   [0, 1]). The 256x256 recipe (param v, logsnr_shift -2.77, batch 32, 64
   items, 1 epoch: 1 flash forward and 1 backward per step), then DPM-50 on
   4 images: exactly 51 flash forwards per dispatch. Last, save_checkpoint,
   load_score_payload and the synchronous part of AsyncCheckpointer.save of
   the full-width train state, timed on the host's clock, with the file's
   bytes.
11. The quality instruments and the few-step path, at full width on phase
   10's 64x64 checkpoint: the fidelity template bank (610 templates, one
   rasterizer launch) on the card against the CPU (spectra within 1e-5 of
   the largest entry); the eval CLI's --grid --fid-vae on four committed
   grids against the JAX CLI's values (fractions to 3 decimals, FIDs to 2,
   theta within 0.1 deg), with scoring and FID ms for 36 images; --ckpt on
   phase 10's checkpoint (SDE-300, CFG 1.5, 36 images: 3,010 GroupNorm
   launches, finite scores). Rectified flow: the train CLI with --param fm
   for 10 steps (10 + 10 GroupNorm and 1 rasterizer launches per step), the
   sample CLI's rf sampler (euler 50 steps: 510 GroupNorm launches per
   dispatch; heun 8: 170), the service at rf-50, and 2 f32 rf steps card
   against CPU (1e-3). Distillation: 1 f32 step card against CPU on
   injected (x0, i, eps) (loss 1e-3 relative, gradients leaf by leaf), then
   the distill CLI 8 -> 4 steps, one epoch of 10 steps each (30 GroupNorm
   forward, 10 backward and 1 rasterizer launches per step, plus each
   phase's DDIM grid), its two checkpoints' config and distill_summary.jsonl;
   steps/s per phase. The 4-step student through ScoreModelService (DDIM-4,
   guidance 0) at 1, 64 and 1,024 images: 40 GroupNorm launches per
   dispatch, output finite in [0, 1], img/s.

--profile adds device ms by kernel class of U-Net forwards and train steps,
those at 256x256 included.

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}; the line before them lists every kernel.
Needs one CUDA card; exits non-zero without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 on the tensor cores, dense
SMS = 132                     # H100 SXM streaming multiprocessors
SFU_EXP2_PER_CLOCK_PER_SM = 16  # ex2 throughput, compute capability 9.0
H100_SM_CLOCK_MAX_HZ = 1.98e9   # H100 SXM top SM clock
DEVICE = "cuda"
BATCH = 256                   # images per throughput request; 512 rows under CFG
SLICE_CFG = dict(n_types=4, y_cont_dim=4, base_ch=96, emb_dim=128, cond_ch=8, time_ch=8,
                 img_size=64, dtype="bfloat16")
TOL = {"float32": (1e-4, 0.0), "bfloat16": (3e-2, 1.6e-2)}  # (atol, rtol)
# GroupNorm gradients, as a share of each gradient's largest entry. f32: sums in
# another order. bf16: dx rounds to bf16 (2^-8 relative) on both sides, and
# autograd through the plain version folds the halo in bf16 where the kernel and
# the closed-form plain backward fold it in f32.
GRAD_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
LEAF_GRAD_TOL = (1e-4, 1e-7)  # (share of the leaf's largest entry, absolute)
RASTER_TOL = (1e-5, 1e-5)     # (atol, rtol): f32 sums over the atoms in another order
TRAIN_BATCH, TRAIN_LR, TRAIN_EPOCHS, TRAIN_STEPS = 128, 1e-4, 4, 5
TRAIN_KW = dict(n_types=4, p_uncond=0.1, t_power=1.0, ema_decay=0.999)
# The 256x256 model: stem "none" puts 64x64 = 4,096 tokens of 4 heads x 48 at the
# bottleneck; v-prediction on the shifted schedule; 12 images (24 rows under CFG)
# per serving dispatch and batch 32 in training, the JAX package's call shapes.
HI_SIZE = 256
HI_CFG = dict(SLICE_CFG, img_size=HI_SIZE, stem="none", param="v", logsnr_shift=-2.77)
HI_BATCH, HI_BUCKETS, HI_DPM_STEPS = 12, (1, 4, 12), 50
HI_TRAIN_BATCH, HI_TRAIN_EPOCHS, HI_TRAIN_STEPS = 32, 2, 4
# Flash kernels against the plain version in f32: share of the reference's largest
# entry. f32: sums in another order. bf16: the kernel rounds P and dS to bf16 before
# the second products and its outputs to bf16 (2^-8 relative each); the f32 plain
# version rounds nothing.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# (label, [B, N, heads, d], timing iterations; 0 = parity only)
FLASH_SHAPES = [("serve 12 img", (2 * HI_BATCH, 4096, 4, 48), 10),
                ("train batch 32", (HI_TRAIN_BATCH, 4096, 4, 48), 10),
                ("2048 tokens", (2, 2048, 4, 48), 0), ("d 64", (2, 4096, 4, 64), 0),
                ("d 16", (3, 256, 4, 16), 0), ("d 128", (2, 128, 1, 128), 0),
                ("d 24 zero-padded to 32", (2, 256, 2, 24), 0)]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gn_bound(shape, pad: bool, elem_bytes: int) -> tuple[float, str]:
    """Least time for one call: bytes (x read once, output written once,
    scale/bias read once) over HBM rate vs ~8 f32 ops per element."""
    b, c, h, w = shape
    n_in, n_out = b * c * h * w, b * c * (h + 2 * pad) * (w + 2 * pad)
    t_bytes = ((n_in + n_out) * elem_bytes + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * n_in + 6 * n_out) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gn_backward_bound(shape, pad: bool, elem_bytes: int) -> float:
    """Least time for one backward call, bytes: x and the upstream gradient
    read once, dx written once, scale and bias read and the per-channel sums
    written once, over the HBM rate."""
    b, c, h, w = shape
    n_in, n_out = b * c * h * w, b * c * (h + 2 * pad) * (w + 2 * pad)
    return ((2 * n_in + n_out) * elem_bytes + 4 * c * 4) / HBM_BYTES_PER_S * 1e3


def kernel_shapes():
    """(label, [B, C, H, W], groups) for every conv-block activation of the
    served U-Net at 64x64, base_ch 96, batch 512, of the 256x256 U-Net at 24
    rows and at 2 rows (one image under CFG), and a few odd shapes."""
    b, bc, hb = 2 * BATCH, 96, 2 * HI_BATCH
    main = [("none/down1,up1", (b, bc, 64, 64)), ("none/down2", (b, 2 * bc, 32, 32)),
            ("none/mid", (b, 2 * bc, 16, 16)), ("none/up2", (b, bc, 32, 32)),
            ("s2dr/down1,up1", (b, bc, 32, 32)), ("s2dr/down2", (b, 2 * bc, 16, 16)),
            ("s2dr/mid", (b, 2 * bc, 8, 8)), ("s2dr/up2", (b, bc, 16, 16)),
            ("256/down1,up1", (hb, bc, HI_SIZE, HI_SIZE)),
            ("256/down2", (hb, 2 * bc, HI_SIZE // 2, HI_SIZE // 2)),
            ("256/mid", (hb, 2 * bc, HI_SIZE // 4, HI_SIZE // 4)),
            ("256/up2", (hb, bc, HI_SIZE // 2, HI_SIZE // 2)),
            ("256 2-row/down1,up1", (2, bc, HI_SIZE, HI_SIZE)),
            ("256 2-row/down2", (2, 2 * bc, HI_SIZE // 2, HI_SIZE // 2)),
            ("256 2-row/mid", (2, 2 * bc, HI_SIZE // 4, HI_SIZE // 4)),
            ("256 2-row/up2", (2, bc, HI_SIZE // 2, HI_SIZE // 2))]
    seen, out = set(), []
    for label, shape in main:
        if shape not in seen:  # none/up2 and s2dr/down1 share a shape
            seen.add(shape)
            out.append((label, shape, 8))
    out += [("odd C12 G4", (3, 12, 8, 8), 4), ("odd C6 G2", (2, 6, 7, 7), 2),
            ("odd H!=W", (2, 16, 5, 9), 8)]
    return out


def phase_kernel(gn) -> tuple[list[dict], dict]:
    rows, headline = [], None
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for label, shape, groups in kernel_shapes():
        c = shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=gen, device=DEVICE) * 2.0 + 0.5).to(dtype)
            scale = torch.randn(c, generator=gen, device=DEVICE) * 0.1 + 1.0
            bias = torch.randn(c, generator=gen, device=DEVICE) * 0.1
            for pad in (True, False):
                got = gn.gn_silu(x, scale, bias, groups, 1e-6, pad)
                torch.cuda.synchronize()
                want = gn.gn_silu_reference(x, scale, bias, groups, 1e-6, pad)
                name = str(dtype).replace("torch.", "")
                atol, rtol = TOL[name]
                err = (got.float() - want.float()).abs()
                max_err = float(err.max())
                bad = int((err > atol + rtol * want.float().abs()).sum())
                row = dict(shape=label, dims=list(shape), groups=groups, dtype=name,
                           pad=pad, max_abs_err=max_err, atol=atol, rtol=rtol,
                           mismatches=bad, plan=gn.kernel_plan(shape, groups, dtype, pad))
                if not label.startswith("odd"):
                    p = 1 if pad else 0

                    def yardstick():
                        y = F.silu(F.group_norm(x, groups, scale.to(dtype), bias.to(dtype),
                                                eps=1e-6))
                        return F.pad(y, (p, p, p, p), mode="circular") if pad else y

                    row["ms"] = cuda_time_ms(
                        lambda: gn.gn_silu(x, scale, bias, groups, 1e-6, pad))
                    row["plain_ms"] = cuda_time_ms(
                        lambda: gn.gn_silu_reference(x, scale, bias, groups, 1e-6, pad))
                    row["library_ms"] = cuda_time_ms(yardstick)
                    row["bound_ms"], row["bound_by"] = gn_bound(shape, pad, x.element_size())
                    row["bound_share"] = row["bound_ms"] / row["ms"]
                    if label == "none/down1,up1" and dtype == torch.bfloat16 and pad:
                        headline = row
                rows.append(row)
                log("kernel gn_silu " + json.dumps(row))
                if bad:
                    raise AssertionError(f"gn_silu disagrees with its plain version at "
                                         f"{label} {name} pad={pad}: {bad} elements, "
                                         f"max abs err {max_err}")
            del x
    return rows, headline


def make_model(stem: str, dtype: str = "float32"):
    from toycrystals_torch.models.sde_score_model import CondUNetTiny

    c = SLICE_CFG
    return CondUNetTiny(c["n_types"], c["y_cont_dim"], base_ch=c["base_ch"],
                        emb_dim=c["emb_dim"], cond_ch=c["cond_ch"], time_ch=c["time_ch"],
                        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
                        stem=stem)


def random_flax_params(stem: str, seed: int) -> dict:
    """A flax-layout CondUNetTiny param tree from a numpy seed, with the
    flax defaults the trainer starts from (models/torch_init.py)."""
    from toycrystals_torch.models.torch_init import flax_default_init
    from toycrystals_torch.utils.params import flax_from_torch_state_dict

    model = flax_default_init(make_model(stem), np.random.default_rng(seed))
    return flax_from_torch_state_dict(model.state_dict())


def phase_card_vs_cpu(stem: str, params: dict, n: int = 3, size: int = 64,
                      logsnr_shift: float = 0.0, v_param: bool = False) -> float:
    """n SDE steps + projection in f32 on injected noise: the card (CUDA
    kernels) against the CPU (plain versions). Returns the max abs difference."""
    from toycrystals_torch.models.sde_score_model import (
        VPSDE, eps_apply_from_v, sample_grid_conditions, sample_reverse_sde_euler_maruyama)
    from toycrystals_torch.utils.params import load_flax_params

    c, shape = SLICE_CFG, (2, size, size, 1)
    sde = VPSDE(0.1, 30.0, logsnr_shift)
    rng = np.random.default_rng(1)
    noise = (rng.normal(size=shape).astype(np.float32),
             rng.normal(size=(n, *shape)).astype(np.float32))
    outs = []
    for dev in (DEVICE, "cpu"):
        model = make_model(stem)
        load_flax_params(model, params)
        model = model.to(dev).eval()
        yc, yv = sample_grid_conditions(2, c["n_types"], c["y_cont_dim"], device=dev)
        with torch.inference_mode():
            x = sample_reverse_sde_euler_maruyama(
                eps_apply_from_v(sde, model) if v_param else model, sde, yc, yv, shape,
                n_steps=n, guidance_scale=1.5, t_end=0.005, n_types=c["n_types"], noise=noise)
        outs.append(x.cpu())
    return float((outs[0] - outs[1]).abs().max())


def kernel_category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("gn_silu kernel", ("gn_silu",)), ("rasterize kernel", ("rasterize",)),
                      ("flash_attn kernels", ("flash_fwd", "flash_dkv", "flash_dq",
                                              "flash_delta")),
                      ("conv (cuDNN)", ("conv", "implicit", "cudnn", "wgrad", "dgrad", "fprop",
                                        "nhwc", "nchw", "fft", "pointwise_mult_and_sum",
                                        "region_transform")),
                      ("matmul", ("gemm", "cutlass", "nvjet")),
                      ("conv (cuDNN)", ("xmma", "sm90_")), ("softmax", ("softmax",)),
                      ("bilinear upsample", ("upsample",)), ("concat", ("cat",)),
                      ("optimizer (foreach)", ("multi_tensor_apply",)),
                      ("device copies", ("memcpy", "memset")),
                      ("reduction", ("reduce",)),
                      ("elementwise", ("elementwise", "vectorized", "unrolled", "copy"))):
        if any(k in n for k in keys):
            return cat
    return "other"


def device_ms_by_category(prof, runs: int) -> tuple[dict[str, float], float]:
    """Device ms per run by kernel category, largest first, and their sum,
    over the profile's device events (kernels and device copies; host-side
    events repeat their children's device time and are left out). Logs the
    largest kernels that fell into no category."""
    from torch.autograd import DeviceType

    by_cat: dict[str, float] = {}
    other: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        cat = kernel_category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e3 / runs
        if cat == "other":
            other[e.key[:90]] = other.get(e.key[:90], 0.0) + us / 1e3 / runs
    if not by_cat:
        raise RuntimeError("the profiler recorded no device event")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
    if top:
        log("profile uncategorised kernels, ms per run: " + json.dumps(top))
    return dict(sorted(by_cat.items(), key=lambda kv: -kv[1])), sum(by_cat.values())


def profile_forward(model, rows: int, size: int = 64) -> dict:
    """Device time by kernel category over 3 U-Net forwards at `rows` rows of
    size x size (one CFG sampler step of rows/2 images each), and the device's
    busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    args = (torch.randn(rows, size, size, 1, device=DEVICE),
            torch.full((rows,), 0.5, device=DEVICE),
            torch.zeros(rows, dtype=torch.int32, device=DEVICE),
            torch.zeros(rows, 4, device=DEVICE))
    with torch.inference_mode():
        model(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                model(*args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat, busy = device_ms_by_category(prof, 3)
    return {"rows": rows, "size": size, "wall_ms_per_forward": wall_ms / 3,
            "device_ms_per_forward": busy,
            "idle_share": 1.0 - busy / (wall_ms / 3),
            "ms_by_category": by_cat}


def profile_stem(stem: str, params: dict) -> list[dict]:
    from toycrystals_torch.serve import ScoreModelService

    svc = ScoreModelService(dict(SLICE_CFG, stem=stem), params, device=DEVICE)
    out = []
    for rows in (2 * BATCH, 2):
        out.append(profile_forward(svc.model, rows))
        log(f"profile {stem} " + json.dumps(out[-1]))
    return out


def phase_slice(gn, stem: str, params: dict) -> dict:
    from toycrystals_torch.serve import ScoreModelService

    svc = ScoreModelService(dict(SLICE_CFG, stem=stem), params, device=DEVICE,
                            buckets=(1, 4, 16, BATCH))
    u8 = ScoreModelService(dict(SLICE_CFG, stem=stem), params, device=DEVICE,
                           buckets=(1, 4, 16), out_dtype="uint8")
    assert (svc.sampler_name, svc.steps, svc.guidance_scale, svc.t_end) == \
        ("sde", 300, 1.5, 0.005), svc.stats
    per_request = 10 * (svc.steps + 1)
    result = {"stem": stem, "requests": []}

    def request(service, n, seed):
        before = gn.gn_silu.launches
        t0 = time.perf_counter()
        x = service.sample_conditions(np.arange(n) % 4, np.linspace(0, 1, n), seed=seed)
        dt = time.perf_counter() - t0
        launches = gn.gn_silu.launches - before
        if launches != per_request:
            raise AssertionError(f"{stem}: {launches} gn_silu launches for one request, "
                                 f"expected {per_request}")
        if x.shape != (n, 64, 64, 1):
            raise AssertionError(f"{stem}: output shape {x.shape}")
        xf = x.astype(np.float32)
        if not np.isfinite(xf).all() or xf.min() < 0 or xf.max() > (255 if x.dtype == np.uint8
                                                                    else 1):
            raise AssertionError(f"{stem}: output out of range or not finite")
        rec = dict(images=n, dtype=str(x.dtype), seconds=dt, launches=launches,
                   mean=float(xf.mean()), std=float(xf.std()))
        result["requests"].append(rec)
        log(f"slice {stem} request " + json.dumps(rec))
        return x

    outs = {n: request(svc, n, seed=n) for n in (1, 4, 16)}
    again = request(svc, 4, seed=4)
    if not np.array_equal(outs[4], again):
        raise AssertionError(f"{stem}: same seed gave different images")
    result["deterministic"] = True
    xu = request(u8, 4, seed=4)
    qf = np.clip(again * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    result["uint8_max_diff"] = int(np.abs(xu.astype(np.int16) - qf.astype(np.int16)).max())
    if result["uint8_max_diff"] > 1:
        raise AssertionError(f"{stem}: uint8 output differs from the quantised f32 one")

    # Throughput: warm the batch-512 shapes with two forwards, then one request.
    with torch.inference_mode():
        xw = torch.randn(2 * BATCH, 64, 64, 1, device=DEVICE)
        tw = torch.full((2 * BATCH,), 0.5, device=DEVICE)
        yw = torch.zeros(2 * BATCH, dtype=torch.int32, device=DEVICE)
        vw = torch.zeros(2 * BATCH, 4, device=DEVICE)
        for _ in range(2):
            svc.model(xw, tw, yw, vw)
    torch.cuda.synchronize()
    x = request(svc, BATCH, seed=7)
    sec = result["requests"][-1]["seconds"]
    result["img_per_s"] = BATCH / sec
    result["throughput_seconds"] = sec
    del x
    log(f"throughput {stem}: {BATCH / sec:.3f} img/s ({BATCH} images, 300-step SDE, "
        f"CFG 1.5, bf16, {sec:.3f} s)")
    return result


def gn_training_rows(gn) -> list[dict]:
    """The forward and backward kernels under autograd at the training shapes
    (batch 128 at 64x64, batch 32 at 256x256): the output within TOL of the
    plain version, and the gradients of x, scale and bias from
    torch.autograd.grad (the backward kernel) within GRAD_TOL of each
    gradient's largest entry, held against the closed-form plain backward
    `gn_silu_backward_reference` and against autograd through the plain
    version on the same leaves. Then the times of the kernel forward and
    backward, the plain forward and backward (autograd through the plain
    version), the library yardstick's forward and backward, and both bounds."""
    b, bc, hb = TRAIN_BATCH, 96, HI_TRAIN_BATCH
    shapes = [("none/down1,up1", (b, bc, 64, 64), 2), ("none/down2", (b, 2 * bc, 32, 32), 1),
              ("none/mid", (b, 2 * bc, 16, 16), 1), ("none/up2", (b, bc, 32, 32), 1),
              ("s2dr/down1,up1", (b, bc, 32, 32), 2), ("s2dr/down2", (b, 2 * bc, 16, 16), 1),
              ("s2dr/mid", (b, 2 * bc, 8, 8), 1), ("s2dr/up2", (b, bc, 16, 16), 1),
              ("256/down1,up1", (hb, bc, HI_SIZE, HI_SIZE), 2),
              ("256/down2", (hb, 2 * bc, HI_SIZE // 2, HI_SIZE // 2), 1),
              ("256/mid", (hb, 2 * bc, HI_SIZE // 4, HI_SIZE // 4), 1),
              ("256/up2", (hb, bc, HI_SIZE // 2, HI_SIZE // 2), 1)]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows = []
    for label, shape, blocks in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for pad in (True, False):
                c = shape[1]
                name = str(dtype).replace("torch.", "")
                leaves = [(torch.randn(shape, generator=gen, device=DEVICE) * 2.0 + 0.5)
                          .to(dtype).requires_grad_(True),
                          (torch.randn(c, generator=gen, device=DEVICE) * 0.1 + 1.0)
                          .requires_grad_(True),
                          (torch.randn(c, generator=gen, device=DEVICE) * 0.1)
                          .requires_grad_(True)]
                before = gn.gn_silu.launches
                y = gn.gn_silu(*leaves, 8, 1e-6, pad)
                if gn.gn_silu.launches != before + 1 or not y.requires_grad:
                    raise AssertionError(f"gn_silu did not launch its kernel under autograd "
                                         f"at {label} {name} pad={pad}")
                want = gn.gn_silu_reference(*leaves, 8, 1e-6, pad)
                g = torch.randn(y.shape, generator=gen, device=DEVICE).to(dtype)
                atol, rtol = TOL[name]
                err = (y.detach().float() - want.detach().float()).abs()
                bad = int((err > atol + rtol * want.detach().float().abs()).sum())
                row = dict(shape=label, dims=list(shape), pad=pad, blocks_per_step=blocks,
                           dtype=name, max_abs_err=float(err.max()), atol=atol, rtol=rtol,
                           mismatches=bad, grad_tol=GRAD_TOL[name],
                           plan=gn.kernel_plan(shape, 8, dtype, pad),
                           backward_plan=gn.kernel_plan(shape, 8, dtype, pad, backward=True))
                del err
                before = gn.gn_silu.backward_launches
                got_g = torch.autograd.grad(y, leaves, g, retain_graph=True)
                if gn.gn_silu.backward_launches != before + 1:
                    raise AssertionError(f"gn_silu's backward did not launch its kernel at "
                                         f"{label} {name} pad={pad}")
                want_g = torch.autograd.grad(want, leaves, g, retain_graph=True)
                closed_g = gn.gn_silu_backward_reference(*(t.detach() for t in leaves), g, 8,
                                                         1e-6, pad)
                for leaf, a, w, w2 in zip(("x", "scale", "bias"), got_g, want_g, closed_g):
                    for tag, ref in (("", w), ("closed_form_", w2)):
                        e = float((a.float() - ref.float()).abs().max())
                        m = float(ref.float().abs().max())
                        row[f"grad_{leaf}_{tag}max_abs_err"] = e
                        row[f"grad_{leaf}_{tag}max_abs"] = m
                        if not e <= GRAD_TOL[name] * m:
                            bad += 1
                del got_g, want_g, closed_g
                row["forward_ms"] = cuda_time_ms(
                    lambda: gn.gn_silu(*leaves, 8, 1e-6, pad), iters=10)
                with torch.no_grad():
                    row["plain_ms"] = cuda_time_ms(
                        lambda: gn.gn_silu_reference(*leaves, 8, 1e-6, pad), iters=10)
                row["backward_ms"] = cuda_time_ms(
                    lambda: torch.autograd.grad(y, leaves, g, retain_graph=True), iters=10)
                row["backward_plain_ms"] = cuda_time_ms(
                    lambda: torch.autograd.grad(want, leaves, g, retain_graph=True), iters=10)
                del want

                def yardstick():
                    x, scale, bias = leaves
                    lib = F.silu(F.group_norm(x, 8, scale.to(dtype), bias.to(dtype), eps=1e-6))
                    return F.pad(lib, (1, 1, 1, 1), mode="circular") if pad else lib

                with torch.no_grad():
                    row["library_ms"] = cuda_time_ms(yardstick, iters=10)
                lib_y = yardstick()
                row["library_backward_ms"] = cuda_time_ms(
                    lambda: torch.autograd.grad(lib_y, leaves, g, retain_graph=True), iters=10)
                del lib_y
                row["bound_ms"], row["bound_by"] = gn_bound(shape, pad, leaves[0].element_size())
                row["backward_bound_ms"] = gn_backward_bound(shape, pad,
                                                             leaves[0].element_size())
                row["backward_bound_share"] = row["backward_bound_ms"] / row["backward_ms"]
                rows.append(row)
                log("kernel gn_silu training " + json.dumps(row))
                if bad:
                    raise AssertionError(f"gn_silu under autograd disagrees with its plain "
                                         f"version at {label} {name} pad={pad}: {row}")
                del leaves, y, g
    return rows


def raster_bound(points: torch.Tensor, weights: torch.Tensor, sigma: torch.Tensor, h: int,
                 w: int) -> dict:
    """Least time for one call: every input read and the images written once
    over the HBM rate, against the f32 operations that this data needs: for
    each atom with weight != 0, 2 per (row, column) pair whose factors are
    both non-zero (the plain version's `torch.exp`) plus one exponential per
    such row and column. Also the operations bounds if every atom of weight
    != 0 (`bound_active_atoms_ms`) or every atom of the budget
    (`bound_all_atoms_ms`) counted at every pixel."""
    b, p = weights.shape
    inv = 1.0 / (2.0 * sigma * sigma)
    ops = 0
    for i in range(0, b, 256):  # [<=256, P, H] factors at a time
        c = inv[i:i + 256, None, None]
        nz = weights[i:i + 256] != 0

        def reach(coord, n):  # rows (columns) where an atom's factor is non-zero
            d = torch.arange(n, dtype=torch.float32, device=coord.device) - coord[..., None]
            return (torch.exp(-(d * d) * c) != 0).sum(dim=-1).double() * nz

        nr, nc = reach(points[i:i + 256, :, 1], h), reach(points[i:i + 256, :, 0], w)
        ops += float((2 * nr * nc + nr + nc).sum())
    active = int((weights != 0).sum())
    t_bytes = (b * (3 * p + h * w + 1) * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes_ms=t_bytes, bound_operations_ms=t_ops, nonzero_pair_ops=ops,
                bound_active_atoms_ms=(2 * h * w + h + w) * active / F32_OPS_PER_S * 1e3,
                bound_all_atoms_ms=(2 * h * w + h + w) * b * p / F32_OPS_PER_S * 1e3)


def survivors_per_tile(rz, points, weights, sigma, h: int, w: int, tile: int) -> dict:
    """Mean and largest number of atoms that the kernel's cull keeps per tile
    (its plain counterpart `tile_keep_mask`, 256 images at a time)."""
    counts = torch.cat([rz.tile_keep_mask(points[i:i + 256], weights[i:i + 256],
                                          sigma[i:i + 256], h, w, tile).sum(dim=-1).flatten()
                        for i in range(0, points.shape[0], 256)])
    return dict(survivors_per_tile_mean=float(counts.double().mean()),
                survivors_per_tile_max=int(counts.max()))


def phase_raster(rz) -> tuple[list[dict], dict]:
    from toycrystals_torch.bench_flash import kernel_ms
    from toycrystals_torch.data.lattice import LatticeConfig, generate_item, static_point_budget

    def geometry(cfg, b):
        budget = static_point_budget(cfg)
        pts, wts, sigma, *_ = generate_item(cfg, budget, 0, torch.arange(b), DEVICE)
        return pts, wts, sigma, cfg.img_size, cfg.img_size

    gen = torch.Generator(device=DEVICE).manual_seed(2)

    def random_atoms(b, p, h, w):
        pts = torch.rand((b, p, 2), generator=gen, device=DEVICE) * (max(h, w) + 10.0) - 5.0
        wts = (torch.rand((b, p), generator=gen, device=DEVICE) < 0.7).float()
        return pts, wts, torch.rand((b,), generator=gen, device=DEVICE) * 1.4 + 0.6, h, w

    def crowded(b=2, p=9728):
        """Every atom of the 256x256 budget, weight 1, inside one 32-px tile."""
        pts = torch.rand((b, p, 2), generator=gen, device=DEVICE) * 31.999 + 96.0
        return pts, torch.ones((b, p), device=DEVICE), torch.full((b,), 1.2, device=DEVICE), \
            HI_SIZE, HI_SIZE

    def near_radius(sigmas=(1.2, 0.72, 1.68), p=2048):
        """Atoms 17.0-17.6 px (at sigma 1.2; sigma * sqrt(208) -+ 0.3 px at the
        full config's extreme sigmas) outside the tile edges at 64, 128 and
        192, which are edges of tiles and of warp sub-tiles."""
        b = len(sigmas)
        s = torch.tensor(sigmas, device=DEVICE)[:, None]
        d = s * 208.0 ** 0.5 + (torch.rand((b, p), generator=gen, device=DEVICE) - 0.5) * 0.6
        edge = 64.0 * torch.randint(1, 4, (b, p), generator=gen, device=DEVICE).float()
        below = torch.rand((b, p), generator=gen, device=DEVICE) < 0.5
        across = torch.where(below, edge - d, edge - 1.0 + d)
        along = torch.rand((b, p), generator=gen, device=DEVICE) * (HI_SIZE - 1)
        on_x = torch.rand((b, p), generator=gen, device=DEVICE) < 0.5
        pts = torch.stack([torch.where(on_x, across, along), torch.where(on_x, along, across)],
                          -1).contiguous()
        return pts, torch.ones((b, p), device=DEVICE), s[:, 0].contiguous(), HI_SIZE, HI_SIZE

    # (label, timed, checks: "rerun" bit-equal rerun, "cull" bit-equal without the cull)
    cases = [("train rot_only 64x64", True, ("rerun", "cull"),
              geometry(LatticeConfig(rot_only=True), TRAIN_BATCH)),
             ("full 64x64", True, (), geometry(LatticeConfig(), TRAIN_BATCH)),
             ("full 64x64 B4096", True, (), geometry(LatticeConfig(), 4096)),
             ("full 32x32", True, (), geometry(LatticeConfig(img_size=32), TRAIN_BATCH)),
             ("train rot_only 256x256", True, ("rerun", "cull"),
              geometry(LatticeConfig(img_size=HI_SIZE, rot_only=True), HI_TRAIN_BATCH))]
    zero = random_atoms(2, 256, 64, 64)
    one = random_atoms(1, 128, 64, 64)
    one[1].zero_()
    one[1][0, 5] = 1.0
    cases += [("odd all weights 0", False, (), (zero[0], torch.zeros_like(zero[1]), *zero[2:])),
              ("odd one atom", False, (), one),
              ("odd H!=W 40x100", False, (), random_atoms(3, 384, 40, 100)),
              ("crowded 9728 atoms in one 32-px tile", False, ("rerun", "cull"), crowded()),
              ("near the cut radius, sigma 1.2 / 0.72 / 1.68", False, ("rerun", "cull"),
               near_radius())]
    rows, headline = [], None
    atol, rtol = RASTER_TOL
    for label, timed, checks, (pts, wts, sigma, h, w) in cases:
        got = rz.rasterize(pts, wts, sigma, h, w)
        torch.cuda.synchronize()
        want = rz.rasterize_separable(pts, wts, sigma, h, w)
        err = (got - want).abs()
        bad = int((err > atol + rtol * want.abs()).sum())
        plan = rz.kernel_plan(pts.shape[0], pts.shape[1], h, w)
        row = dict(shape=label, b=pts.shape[0], p=pts.shape[1], h=h, w=w,
                   active_atoms=int((wts != 0).sum()), max_abs_err=float(err.max()),
                   peak=float(want.max()), atol=atol, rtol=rtol, mismatches=bad, plan=plan,
                   **survivors_per_tile(rz, pts, wts, sigma, h, w, plan["tile"]))
        if label == "odd all weights 0" and float(got.abs().max()) != 0.0:
            raise AssertionError("rasterize: atoms of weight 0 contributed to the image")
        del want, err
        if "rerun" in checks:
            row["rerun_bit_equal"] = bool(torch.equal(got, rz.rasterize(pts, wts, sigma, h, w)))
        if "cull" in checks:
            row["cull_off_bit_equal"] = bool(torch.equal(
                got, rz._rasterize_cuda(pts, wts, sigma, h, w, cull=False)))
        if timed:
            # the kernel's device time; at these shapes CUDA events around the
            # calls time the wrapper's host cost, kept as wrapper_ms
            row["ms"] = kernel_ms(lambda: rz.rasterize(pts, wts, sigma, h, w), 20,
                                  ("rasterize",))["rasterize"]
            if not row["ms"] > 0.0:
                raise AssertionError(f"rasterize at {label}: torch.profiler saw no device time")
            row["wrapper_ms"] = cuda_time_ms(lambda: rz.rasterize(pts, wts, sigma, h, w),
                                             iters=10)
            row["plain_ms"] = cuda_time_ms(
                lambda: rz.rasterize_separable(pts, wts, sigma, h, w), iters=5, warmup=2)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                row["plain_tf32_ms"] = cuda_time_ms(
                    lambda: rz.rasterize_separable(pts, wts, sigma, h, w), iters=5, warmup=2)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            row.update(raster_bound(pts, wts, sigma, h, w))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            if headline is None:
                headline = row
        rows.append(row)
        log("kernel rasterize " + json.dumps(row))
        if bad:
            raise AssertionError(f"rasterize disagrees with its plain version at {label}: "
                                 f"{bad} pixels, max abs err {row['max_abs_err']}")
        if row.get("rerun_bit_equal") is False or row.get("cull_off_bit_equal") is False:
            raise AssertionError(f"rasterize at {label}: a rerun or a render without the cull "
                                 f"changed bits: {row}")
    return rows, headline


def sm_clock_max_hz() -> float:
    """The card's top SM clock, as `nvidia-smi --query-gpu=clocks.max.sm` gives it
    ("1980 MHz"); the H100 SXM's 1,980 MHz if it gives none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return float(out.stdout.split()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return H100_SM_CLOCK_MAX_HZ


def flash_bound(shape, elem_bytes: int, backward: bool,
                clock_hz: float = H100_SM_CLOCK_MAX_HZ) -> tuple[float, str, str]:
    """Least time for one call: the largest of three. Tensor operations: the
    forward's 2 products of 2 B H N^2 d operations, the backward's 5 (S, dP,
    dV, dK, dQ), at the tensor cores' bf16 rate, or at the f32 rate for f32
    inputs, which run on no tensor core. Exponentials: one exp2 per logit,
    B H N^2 (the backward's least work too), at 16 per clock per SM on 132 SMs
    at the top SM clock. Bytes: q, k, v read and O and the f32 row log-sum-exp
    written once (backward: q, k, v, O, dO and L read, dq, dk, dv written).
    Returns (ms, "operations" or "bytes", which operations or "bytes")."""
    b, n, h, d = shape
    ops = (10 if backward else 4) * b * h * n * n * d
    elems = (8 if backward else 4) * b * n * h * d
    terms = {
        "tensor operations" if elem_bytes == 2 else "f32 operations":
            ops / (BF16_OPS_PER_S if elem_bytes == 2 else F32_OPS_PER_S) * 1e3,
        "exponentials": b * h * n * n / (SFU_EXP2_PER_CLOCK_PER_SM * SMS * clock_hz) * 1e3,
        "bytes": (elems * elem_bytes + b * h * n * 4) / HBM_BYTES_PER_S * 1e3,
    }
    what = max(terms, key=terms.get)
    return terms[what], ("bytes" if what == "bytes" else "operations"), what


def phase_flash(at) -> tuple[list[dict], dict]:
    """The flash kernels against `sdpa_reference` in f32 on the same values
    (bf16 inputs upcast; 8 items at a time, since the plain version holds the
    [B, heads, N, N] logits): output and the gradients of q, k, v under a
    random cotangent, each within FLASH_TOL of the reference's largest entry."""
    rows, headline = [], {}
    clock_hz = sm_clock_max_hz()
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    for label, shape, iters in FLASH_SHAPES:
        b, n, h, d = shape
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            qkv = torch.randn((b, n, 3, h, d), generator=gen, device=DEVICE).to(dtype)
            up = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
            leaves = [qkv[:, :, i].detach().requires_grad_(True) for i in range(3)]
            before = (at.flash_sdpa.launches, at.flash_sdpa.backward_launches)
            out = at.flash_sdpa(*leaves)
            grads = torch.autograd.grad(out, leaves, up, retain_graph=True)
            torch.cuda.synchronize()
            if (at.flash_sdpa.launches, at.flash_sdpa.backward_launches) != \
                    (before[0] + 1, before[1] + 1):
                raise AssertionError(f"flash_sdpa did not launch its kernels at {label} {name}")
            row = dict(shape=label, dims=list(shape), dtype=name, tol_share=FLASH_TOL[name])
            errs = {k: 0.0 for k in ("out", "dq", "dk", "dv")}
            maxs = dict(errs)
            for i0 in range(0, b, 8):
                sl = slice(i0, i0 + 8)
                ref = [t[sl].detach().float().requires_grad_(True) for t in leaves]
                want = at.sdpa_reference(*ref)
                want_g = torch.autograd.grad(want, ref, up[sl].float())
                for k, got, w in zip(errs, (out.detach(), *grads), (want.detach(), *want_g)):
                    errs[k] = max(errs[k], float((got[sl].float() - w).abs().max()))
                    maxs[k] = max(maxs[k], float(w.abs().max()))
                del ref, want, want_g
            bad = []
            for k in errs:
                row[f"{k}_max_abs_err"], row[f"{k}_max_abs"] = errs[k], maxs[k]
                if not errs[k] <= FLASH_TOL[name] * maxs[k]:
                    bad.append(k)
            if iters:
                it = iters if dtype == torch.bfloat16 else 3
                qh, kh, vh = (t.detach().transpose(1, 2) for t in leaves)
                with torch.no_grad():
                    row["ms"] = cuda_time_ms(lambda: at.flash_sdpa(*leaves), iters=it)
                    row["plain_ms"] = cuda_time_ms(lambda: at.sdpa_reference(*leaves), iters=3,
                                                   warmup=1)
                    row["library_ms"] = cuda_time_ms(
                        lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=it)
                row["backward_ms"] = cuda_time_ms(
                    lambda: torch.autograd.grad(out, leaves, up, retain_graph=True), iters=it)
                plain = at.sdpa_reference(*leaves)
                row["plain_backward_ms"] = cuda_time_ms(
                    lambda: torch.autograd.grad(plain, leaves, up, retain_graph=True), iters=3,
                    warmup=1)
                del plain
                lib_leaves = [t.detach().transpose(1, 2).requires_grad_(True) for t in leaves]
                lib = F.scaled_dot_product_attention(*lib_leaves)
                row["library_backward_ms"] = cuda_time_ms(
                    lambda: torch.autograd.grad(lib, lib_leaves, up.transpose(1, 2),
                                                retain_graph=True), iters=it)
                del lib, lib_leaves
                row["bound_ms"], row["bound_by"], row["bound_operations"] = flash_bound(
                    shape, qkv.element_size(), False, clock_hz)
                row["backward_bound_ms"], _, row["backward_bound_operations"] = flash_bound(
                    shape, qkv.element_size(), True, clock_hz)
                row["tflops"] = 4 * b * h * n * n * d / row["ms"] / 1e9
                row["backward_tflops"] = 10 * b * h * n * n * d / row["backward_ms"] / 1e9
                if dtype == torch.bfloat16:
                    headline[label] = row
            rows.append(row)
            log("kernel flash_attn " + json.dumps(row))
            if bad:
                raise AssertionError(f"flash_attn disagrees with its plain version at {label} "
                                     f"{name} in {bad}: {row}")
            del qkv, up, leaves, out, grads
            torch.cuda.empty_cache()
    return rows, headline


def phase_slice_hi(gn, at, params: dict) -> dict:
    """Serving at 256x256 through ScoreModelService: SDE-300 and DPM-50."""
    from toycrystals_torch.models.sde_score_model import auto_chunk
    from toycrystals_torch.serve import ScoreModelService

    svc = ScoreModelService(HI_CFG, params, device=DEVICE, buckets=HI_BUCKETS)
    if (auto_chunk(HI_SIZE, svc.steps), HI_BUCKETS[-1]) != (HI_BATCH, HI_BATCH):
        raise AssertionError(f"the timed 256x256 dispatch ({HI_BATCH} images) is not the "
                             f"reference's auto_chunk({HI_SIZE}, {svc.steps}) = "
                             f"{auto_chunk(HI_SIZE, svc.steps)} or not the top bucket")
    dpm = ScoreModelService(HI_CFG, params, device=DEVICE, buckets=HI_BUCKETS, sampler="dpm",
                            steps=HI_DPM_STEPS)
    if (svc.sampler_name, svc.steps, svc.guidance_scale, svc.t_end, svc.buckets) != \
            ("sde", 300, 1.5, 0.005, HI_BUCKETS) or svc._apply_fn is svc.model \
            or svc.sde.logsnr_shift != HI_CFG["logsnr_shift"]:
        raise AssertionError(f"256x256 service did not resolve the reference settings with "
                             f"v wrapped to eps: {svc.stats}")
    result = {"size": HI_SIZE, "requests": []}

    def request(service, n, seed, dispatches=1):
        evals = (service.steps + 1) * dispatches
        g0, f0, d0 = gn.gn_silu.launches, at.flash_sdpa.launches, service.stats["dispatches"]
        t0 = time.perf_counter()
        x = service.sample_conditions(np.arange(n) % 4, np.linspace(0, 1, n), seed=seed)
        dt = time.perf_counter() - t0
        got = (gn.gn_silu.launches - g0, at.flash_sdpa.launches - f0,
               service.stats["dispatches"] - d0)
        if got != (10 * evals, evals, dispatches):
            raise AssertionError(f"256x256 {service.sampler_name}: (gn_silu, flash, dispatches) "
                                 f"= {got} for {n} images, expected "
                                 f"{(10 * evals, evals, dispatches)}")
        if x.shape != (n, HI_SIZE, HI_SIZE, 1) or x.dtype != np.float32:
            raise AssertionError(f"256x256: output {x.shape} {x.dtype}")
        if not np.isfinite(x).all() or x.min() < 0 or x.max() > 1:
            raise AssertionError("256x256: output out of range or not finite")
        rec = dict(sampler=service.sampler_name, steps=service.steps, images=n, seconds=dt,
                   dispatches=dispatches, gn_silu_launches=got[0], flash_launches=got[1],
                   mean=float(x.mean()), std=float(x.std()))
        result["requests"].append(rec)
        log("slice 256x256 request " + json.dumps(rec))
        return x

    with torch.inference_mode():  # warm the 24-row shapes with two forwards
        rows = 2 * HI_BATCH
        for _ in range(2):
            svc.model(torch.randn(rows, HI_SIZE, HI_SIZE, 1, device=DEVICE),
                      torch.full((rows,), 0.5, device=DEVICE),
                      torch.zeros(rows, dtype=torch.int32, device=DEVICE),
                      torch.zeros(rows, 4, device=DEVICE))
    torch.cuda.synchronize()
    gn.gn_silu.launches = at.flash_sdpa.launches = 0  # the 256x256 serving path starts here
    one = request(svc, 1, seed=1)
    if not np.array_equal(one, request(svc, 1, seed=1)):
        raise AssertionError("256x256: same seed gave different images")
    result["deterministic"] = True
    request(svc, HI_BATCH, seed=7)
    sec = result["requests"][-1]["seconds"]
    result["img_per_s"], result["throughput_seconds"] = HI_BATCH / sec, sec
    log(f"throughput 256x256: {HI_BATCH / sec:.4f} img/s ({HI_BATCH} images, 300-step SDE, "
        f"CFG 1.5, bf16, {sec:.3f} s)")
    request(dpm, HI_BATCH, seed=8)
    result["dpm_img_per_s"] = HI_BATCH / result["requests"][-1]["seconds"]
    request(dpm, HI_BATCH + 2, seed=9, dispatches=2)
    return result


def phase_data_card_vs_cpu() -> dict:
    """generate_batch for the same (seed, idx) on the card and on the CPU:
    labels equal, images within 1e-4 (the integer draws are the same on
    both; exp, log, cos and sin may differ in the last bit, and the card
    sums the atoms in another order)."""
    from toycrystals_torch.data.datasets import generate_batch
    from toycrystals_torch.data.lattice import LatticeConfig

    out = {}
    for name, cfg, n in (("rot_only", LatticeConfig(rot_only=True), TRAIN_BATCH),
                         ("full", LatticeConfig(), 32),
                         ("rot_only 256x256", LatticeConfig(img_size=HI_SIZE, rot_only=True),
                          HI_TRAIN_BATCH)):
        idx = np.arange(1000, 1000 + n)
        xg, cg, vg = generate_batch(cfg, 0, idx, device=DEVICE)
        xc, cc, vc = generate_batch(cfg, 0, idx, device="cpu")
        d = float((xg.cpu() - xc).abs().max())
        out[name] = d
        log(f"data {name}: card vs CPU on {n} items: images max abs diff {d:.3e} "
            f"(tolerance 1e-4), labels equal: "
            f"{torch.equal(cg.cpu(), cc) and torch.equal(vg.cpu(), vc)}")
        if xg.shape != (n, cfg.img_size, cfg.img_size, 1) or not torch.equal(cg.cpu(), cc) \
                or not torch.equal(vg.cpu(), vc) or not d <= 1e-4:
            raise AssertionError(f"data {name}: the card and the CPU render different items")
        if float(xg.min()) < 0.0 or float(xg.max()) > 1.0 or \
                not bool((xg.amax(dim=(1, 2, 3)) > 0.99).all()):
            raise AssertionError(f"data {name}: images are not normalised to [0, 1]")
    return out


def train_pieces(stem: str, dtype: str, device: str, logsnr_shift: float = 0.0):
    from toycrystals_torch.models.sde_score_model import VPSDE
    from toycrystals_torch.models.torch_init import flax_default_init
    from toycrystals_torch.train.state import Optimizer, create_train_state

    model = flax_default_init(make_model(stem, dtype), np.random.default_rng(0)).to(device)
    tx = Optimizer(TRAIN_LR)
    return (model, tx, VPSDE(0.1, 30.0, logsnr_shift),
            create_train_state(model, tx, ema=True))


def phase_train_card_vs_cpu(stem: str, n: int = 8, size: int = 64, steps: int = 2,
                            logsnr_shift: float = 0.0, parameterization: str = "eps") -> dict:
    """`steps` f32 train steps at full width on n injected items and (t, eps):
    the card (GroupNorm and, at 256x256, flash kernels both ways) against the
    CPU (plain versions both ways).
    Tolerances: each loss within 1e-3 relative; step-1 gradients leaf by
    leaf, max |diff| <= LEAF_GRAD_TOL[0] * max |g_leaf| + LEAF_GRAD_TOL[1]."""
    from toycrystals_torch.data.datasets import generate_batch
    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.train.steps import make_sde_train_step, sde_loss_and_grads

    x0, y_cat, y_cont = generate_batch(LatticeConfig(img_size=size, rot_only=True), 0,
                                       np.arange(n), device="cpu")
    rng = np.random.default_rng(3)
    noise = [(torch.tensor(rng.uniform(0.02, 1.0, size=n).astype(np.float32)),
              torch.tensor(rng.normal(size=(n, size, size, 1)).astype(np.float32)))
             for _ in range(steps)]
    losses, grads = {}, {}
    for dev in (DEVICE, "cpu"):
        model, tx, sde, state = train_pieces(stem, "float32", dev, logsnr_shift)
        step = make_sde_train_step(model, tx, sde, **TRAIN_KW,
                                   parameterization=parameterization)
        batch = [a.to(dev) for a in (x0, y_cat, y_cont)]
        _, g = sde_loss_and_grads(model, sde, *batch, *(a.to(dev) for a in noise[0]),
                                  parameterization=parameterization)
        grads[dev] = [a.cpu() for a in g]
        losses[dev] = []
        for t, eps in noise:
            state, loss = step(state, *batch, noise=(t.to(dev), eps.to(dev)))
            losses[dev].append(float(loss))
    names = [k for k, _ in model.named_parameters()]
    leaves = []
    for k, a, b in zip(names, grads[DEVICE], grads["cpu"]):
        d, m = float((a - b).abs().max()), float(b.abs().max())
        leaves.append(dict(leaf=k, max_abs_diff=d, max_abs=m,
                           share_of_limit=d / (LEAF_GRAD_TOL[0] * m + LEAF_GRAD_TOL[1])))
    ranked = sorted(leaves, key=lambda r: -r["share_of_limit"])
    worst = ranked[0]
    l_diff = max(abs(a - b) / abs(b) for a, b in zip(losses[DEVICE], losses["cpu"]))
    out = dict(stem=stem, size=size, items=n, losses_card=losses[DEVICE],
               losses_cpu=losses["cpu"],
               loss_rel_diff=l_diff, grad_leaves=len(leaves), grad_worst_leaves=ranked[:3],
               grad_max_abs_diff=max(r["max_abs_diff"] for r in leaves),
               grad_max_abs=max(r["max_abs"] for r in leaves))
    log("train card vs CPU " + json.dumps(out))
    out["grad_by_leaf"] = leaves
    if not (l_diff <= 1e-3 and worst["share_of_limit"] <= 1.0):
        raise AssertionError(f"{stem} {size}x{size}: card and CPU train steps disagree: loss rel. "
                             f"difference {l_diff}, worst gradient leaf {worst}")
    return out


def phase_train(gn, rz, at, stem: str, dtype: str, size: int = 64, batch: int = TRAIN_BATCH,
                epochs: int = TRAIN_EPOCHS, steps: int = TRAIN_STEPS,
                logsnr_shift: float = 0.0, parameterization: str = "eps",
                flash_per_step: int = 0) -> dict:
    """`epochs` epochs of `steps` steps through make_sde_train_epoch, every
    epoch on fresh procedural items rendered on the card. Each step must
    launch 10 GroupNorm forward and 10 GroupNorm backward kernels, 1
    rasterizer and `flash_per_step` flash forwards and as many flash backward
    passes."""
    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.train.steps import make_sde_train_epoch

    model, tx, sde, state = train_pieces(stem, dtype, DEVICE, logsnr_shift)
    n_items = steps * batch
    epoch = make_sde_train_epoch(model, tx, sde, batch_size=batch, n_items=n_items,
                                 lattice_cfg=LatticeConfig(img_size=size, rot_only=True),
                                 dataset_seed=0, fresh_data=True,
                                 parameterization=parameterization, **TRAIN_KW)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds = [], []
    for e in range(epochs):
        before = (gn.gn_silu.launches, gn.gn_silu.backward_launches, rz.rasterize.launches,
                  at.flash_sdpa.launches, at.flash_sdpa.backward_launches)
        t0 = time.perf_counter()
        state, loss = epoch(state, gen, e * n_items)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
        after = (gn.gn_silu.launches, gn.gn_silu.backward_launches, rz.rasterize.launches,
                 at.flash_sdpa.launches, at.flash_sdpa.backward_launches)
        got = tuple(a - b for a, b in zip(after, before))
        want = (10 * steps, 10 * steps, steps, flash_per_step * steps,
                flash_per_step * steps)
        if got != want:
            raise AssertionError(f"{stem} {dtype} {size}x{size}: (gn_silu forward, gn_silu "
                                 f"backward, rasterize, flash forward, flash backward) "
                                 f"launches in {steps} steps were {got}, expected {want}")
    steady = sum(seconds[1:]) / ((epochs - 1) * steps)  # epoch 1 warms cuDNN up
    ema_gap = max(float((state.ema_params[k] - p.detach()).abs().max())
                  for k, p in state.params.items())
    finite = all(bool(torch.isfinite(v).all()) for v in state.ema_params.values()) and \
        all(bool(torch.isfinite(p).all()) for p in state.params.values())
    out = dict(stem=stem, dtype=dtype, size=size, batch=batch, steps=state.step,
               epoch_mean_losses=losses,
               epoch_seconds=seconds, steps_per_s=1.0 / steady, img_per_s=batch / steady,
               peak_memory_bytes=torch.cuda.max_memory_allocated(), ema_max_gap=ema_gap)
    log("train " + json.dumps(out))
    if not (all(math.isfinite(v) for v in losses) and finite):
        raise AssertionError(f"{stem} {dtype}: non-finite loss, parameters or EMA")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{stem} {dtype}: the loss did not fall: the mean of steps "
                             f"1-{steps} is {losses[0]}, of the last {steps} "
                             f"{losses[-1]}")
    if not ema_gap > 0.0 or state.step != epochs * steps:
        raise AssertionError(f"{stem} {dtype}: EMA equals the parameters or steps are missing")
    return out


def profile_train(stem: str, dtype: str, size: int = 64, batch: int = TRAIN_BATCH,
                  logsnr_shift: float = 0.0, parameterization: str = "eps") -> dict:
    """Device time by kernel category over 3 train steps (data included)."""
    from torch.profiler import ProfilerActivity, profile

    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.train.steps import make_sde_train_epoch

    model, tx, sde, state = train_pieces(stem, dtype, DEVICE, logsnr_shift)
    epoch = make_sde_train_epoch(model, tx, sde, batch_size=batch, n_items=3 * batch,
                                 lattice_cfg=LatticeConfig(img_size=size, rot_only=True),
                                 parameterization=parameterization, **TRAIN_KW)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    epoch(state, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch(state, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    by_cat, busy = device_ms_by_category(prof, 3)
    out = {"stem": stem, "dtype": dtype, "size": size, "batch": batch,
           "wall_ms_per_step": wall_ms,
           "device_ms_per_step": busy, "idle_share": 1.0 - busy / wall_ms,
           "ms_by_category": by_cat}
    log("profile train " + json.dumps(out))
    return out


CLI_DIR = os.path.join(ROOT, "runs", "chip_smoke_cli")  # runs/ is git-ignored
# Phase 10, the CLIs: full width; 10 steps per 64x64 epoch, 2 at 256x256.
CLI_MODEL = ["--base-ch", "96", "--stem", "none", "--dtype", "bfloat16"]
CLI_SIZE, CLI_BATCH, CLI_ITEMS, CLI_SDE_STEPS, CLI_IMAGES = 64, 128, 1280, 300, 36
CLI_HI_BATCH, CLI_HI_ITEMS, CLI_HI_DPM_STEPS, CLI_HI_IMAGES = 32, 64, 50, 4


def read_png_gray(path: str) -> np.ndarray:
    """An 8-bit grayscale PNG (what utils/figures.py writes) as a [H, W]
    uint8 array, decoded by utils/figures.py:read_png (every chunk's CRC
    checked); any other colour type raises."""
    from toycrystals_torch.utils.figures import read_png

    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: not a grayscale PNG (shape {img.shape})")
    return np.rint(img * 255.0).astype(np.uint8)


def grid_tiles(img: np.ndarray, n: int, tile: int, pad: int = 2) -> np.ndarray:
    """The n tiles of a square grid with `pad`-px white gaps; the gaps must be
    white."""
    side = int(math.ceil(math.sqrt(n)))
    if img.shape != (side * (tile + pad) + pad,) * 2:
        raise AssertionError(f"grid of shape {img.shape} for {n} tiles of {tile} px")
    gaps = np.ones(img.shape, bool)
    tiles = []
    for i in range(n):
        r, c = divmod(i, side)
        y0, x0 = pad + r * (tile + pad), pad + c * (tile + pad)
        tiles.append(img[y0:y0 + tile, x0:x0 + tile])
        gaps[y0:y0 + tile, x0:x0 + tile] = False
    if not (img[gaps] == 255).all():
        raise AssertionError("the gaps of the grid are not white")
    return np.stack(tiles)


def phase_cli(gn, rz, at, set_counts_to_zero, counts, card: str) -> dict:
    """The two score-model CLIs at full width: 64x64 train -> resume ->
    sample, the 256x256 recipe, and checkpoint timing (module docstring, phase 10)."""
    from toycrystals_torch.models.sde_score_model import (
        VPSDE, CondUNetTiny, sample_chunked, sample_grid_conditions,
        sample_reverse_sde_euler_maruyama)
    from toycrystals_torch.scripts import sample_sde_score_model as sample_cli
    from toycrystals_torch.scripts import train_sde_score_model as train_cli
    from toycrystals_torch.serve import ScoreModelService
    from toycrystals_torch.utils import checkpoint as ck
    from toycrystals_torch.utils.figures import quantize_u8
    from toycrystals_torch.utils.params import load_flax_params, train_state_to_checkpoint

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    run64, run256 = os.path.join(CLI_DIR, "64"), os.path.join(CLI_DIR, "256")
    ckpt64 = os.path.join(run64, "checkpoints", "sde_score_model_last.msgpack")
    per_epoch = CLI_ITEMS // CLI_BATCH
    flags64 = ["--procedural", *CLI_MODEL, "--img-size", str(CLI_SIZE), "--n-samples",
               str(CLI_ITEMS), "--batch-size", str(CLI_BATCH), "--ema-decay", "0.999",
               "--ckpt-every", "1", "--sample-every", "0", "--out-dir", run64]
    out: dict = {"card": card}

    def tensors(state):
        named = {f"params/{k}": v for k, v in state.params.items()}
        named.update({f"ema/{k}": v for k, v in state.ema_params.items()})
        named.update({f"mu/{i}": t for i, t in enumerate(state.opt_state.mu)})
        named.update({f"nu/{i}": t for i, t in enumerate(state.opt_state.nu)})
        return named

    def check_train_launches(label, got, steps, flash):
        want = {"gn_silu": 10 * steps, "gn_silu_backward": 10 * steps, "rasterize": steps,
                "flash_attn": flash * steps, "flash_attn_backward": flash * steps}
        if got != want:
            raise AssertionError(f"CLI {label}: launches {got} in {steps} steps, expected {want}")

    # -- 64x64: train 2 epochs, reload, resume to 3
    set_counts_to_zero()  # the CLI training path starts here
    first = train_cli.train(flags64 + ["--epochs", "2"])
    train64 = counts()
    check_train_launches("train 64x64", train64, first.state.step, 0)
    loaded = train_cli.train(flags64 + ["--epochs", "2", "--resume"])
    saved, back = tensors(first.state), tensors(loaded.state)
    unequal = [k for k in saved if not torch.equal(saved[k], back[k])]
    if unequal or set(saved) != set(back) or (loaded.state.step, loaded.state.opt_state.count) \
            != (first.state.step, first.state.opt_state.count) or loaded.epoch_seconds:
        raise AssertionError(f"--resume did not restore the saved state bit for bit: "
                             f"{len(unequal)} tensors differ ({unequal[:4]}), step "
                             f"{loaded.state.step} vs {first.state.step}")
    out["resume_bit_equal_tensors"] = len(saved)
    epoch_seconds = list(first.epoch_seconds)
    del first, loaded, saved, back
    set_counts_to_zero()
    third = train_cli.train(flags64 + ["--epochs", "3", "--resume"])
    resumed = counts()
    check_train_launches("train 64x64 after --resume", resumed, per_epoch, 0)
    with open(os.path.join(run64, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    raw = ck.load_checkpoint(ckpt64)
    if [r["epoch"] for r in rows] != [1, 2, 3] or not all(math.isfinite(r["loss"])
                                                         for r in rows) \
            or raw["epoch_next"] != 3 or third.state.step != 3 * per_epoch:
        raise AssertionError(f"CLI 64x64: metrics {rows}, epoch_next {raw['epoch_next']}, "
                             f"step {third.state.step}")
    # epoch 1 warms cuDNN up; epoch 3 runs in the resumed run
    epoch_seconds += third.epoch_seconds
    out["train_64"] = dict(losses=[r["loss"] for r in rows], steps=third.state.step,
                           steps_per_epoch=per_epoch, epoch_seconds=epoch_seconds,
                           steps_per_s={f"epoch {e + 1}": per_epoch / epoch_seconds[e]
                                        for e in (1, 2)},
                           launches_first_run=train64, launches_resumed_run=resumed)
    log("cli train 64x64 " + json.dumps(out["train_64"]))
    log(f"cli train 64x64 ({card}): " + ", ".join(
        f"{k} {v:.3f} steps/s" for k, v in out["train_64"]["steps_per_s"].items()))

    # -- 64x64: the sample CLI from that checkpoint
    set_counts_to_zero()  # the CLI sampling path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sample_cli.sample(["--out-dir", run64, "--sampler", "sde", "--steps",
                             str(CLI_SDE_STEPS), "--cfg", "1.5", "--t-end", "0.005",
                             "--use-ema", "1", "--n", str(CLI_IMAGES)])
    cli_s = time.perf_counter() - t0
    sample64 = counts()
    dispatches = -(-CLI_IMAGES // res.chunk)
    per_dispatch = 10 * (CLI_SDE_STEPS + 1)
    if sample64["gn_silu"] != per_dispatch * dispatches or sample64["rasterize"] \
            or sample64["flash_attn"]:
        raise AssertionError(f"CLI sample 64x64: launches {sample64} in {dispatches} "
                             f"dispatch(es), expected {per_dispatch} gn_silu each")
    tiles = grid_tiles(read_png_gray(res.out_path), CLI_IMAGES, CLI_SIZE)
    payload = ck.load_score_payload(ckpt64)
    cfg = payload["config"]
    model = CondUNetTiny(int(cfg["n_types"]), int(cfg["y_cont_dim"]), base_ch=int(cfg["base_ch"]),
                         emb_dim=int(cfg["emb_dim"]), cond_ch=int(cfg["cond_ch"]),
                         time_ch=int(cfg["time_ch"]), dtype=torch.bfloat16, stem=cfg["stem"])
    load_flax_params(model, payload["state"]["ema_params"])
    model = model.to(DEVICE).eval().requires_grad_(False)
    sde = VPSDE(float(cfg["beta_min"]), float(cfg["beta_max"]), float(cfg["logsnr_shift"]))
    yc, yv = sample_grid_conditions(CLI_IMAGES, 4, 4, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        direct = sample_chunked(sample_reverse_sde_euler_maruyama, model, sde, yc, yv,
                                (CLI_IMAGES, CLI_SIZE, CLI_SIZE, 1), 0, chunk=res.chunk,
                                n_steps=CLI_SDE_STEPS,
                                guidance_scale=1.5, t_end=0.005, n_types=4)
    direct_s = time.perf_counter() - t0
    want = quantize_u8(direct[..., 0])
    differ = int((tiles != want).sum())
    out["sample_64"] = dict(images=CLI_IMAGES, chunk=res.chunk, dispatches=dispatches,
                            launches=sample64, cli_seconds=cli_s,
                            cli_img_per_s=CLI_IMAGES / cli_s, sample_chunked_seconds=direct_s,
                            sample_chunked_img_per_s=CLI_IMAGES / direct_s,
                            tiles_differing_pixels=differ,
                            tile_mean=float(tiles.mean()), tile_std=float(tiles.std()))
    log("cli sample 64x64 " + json.dumps(out["sample_64"]))
    log(f"cli sample 64x64 ({card}): {CLI_IMAGES / cli_s:.3f} img/s through the CLI "
        f"(checkpoint read, model build, PNG write included), {CLI_IMAGES / direct_s:.3f} "
        f"img/s in sample_chunked")
    if differ or not np.isfinite(res.x).all():
        raise AssertionError(f"CLI sample 64x64: {differ} pixels of the PNG differ from the "
                             f"quantised sample_chunked output on the checkpoint's weights")
    del model, direct
    svc = ScoreModelService.from_checkpoint(ckpt64, device=DEVICE)
    x = svc.sample_conditions(np.arange(16) % 4, np.linspace(0, 1, 16), seed=3)
    if x.shape != (16, CLI_SIZE, CLI_SIZE, 1) or not np.isfinite(x).all() or x.min() < 0 \
            or x.max() > 1:
        raise AssertionError(f"ScoreModelService.from_checkpoint: output {x.shape}, range "
                             f"[{x.min()}, {x.max()}]")
    out["service_16"] = dict(mean=float(x.mean()), std=float(x.std()))
    del svc

    # -- checkpoint timing at full width (the resumed run's state)
    payload_of = lambda: {"epoch_next": 3, "loss_hist": third.loss_hist,  # noqa: E731
                          "config": third.config,
                          "state": train_state_to_checkpoint(third.state, third.tx)}
    path = os.path.join(CLI_DIR, "timing.msgpack")
    times: dict[str, list[float]] = {"save_ms": [], "load_ms": [], "async_return_ms": [],
                                     "async_total_ms": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save_checkpoint(path, payload_of())
        times["save_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        ck.load_score_payload(path)
        times["load_ms"].append((time.perf_counter() - t0) * 1e3)
        ckptr = ck.AsyncCheckpointer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckptr.save(path, payload_of())
        times["async_return_ms"].append((time.perf_counter() - t0) * 1e3)
        ckptr.wait()
        times["async_total_ms"].append((time.perf_counter() - t0) * 1e3)
    out["checkpoint"] = {k: sorted(v)[1] for k, v in times.items()}
    out["checkpoint"].update(bytes=os.path.getsize(path), runs=3, statistic="median",
                             card=card, params=sum(p.numel() for p in third.state.params.values()))
    log(f"cli checkpoint timing ({card}): " + json.dumps(out["checkpoint"]))
    del third

    # -- 256x256: the recipe, briefly
    set_counts_to_zero()  # the CLI 256x256 training path starts here
    hi = train_cli.train(["--procedural", *CLI_MODEL, "--img-size", str(HI_SIZE), "--param",
                          "v", "--logsnr-shift", "-2.77", "--batch-size", str(CLI_HI_BATCH),
                          "--n-samples", str(CLI_HI_ITEMS), "--epochs", "1",
                          "--sample-every", "0", "--out-dir", run256])
    train256 = counts()
    check_train_launches("train 256x256", train256, hi.state.step, 1)
    if hi.state.step != CLI_HI_ITEMS // CLI_HI_BATCH \
            or not all(math.isfinite(v) for v in hi.loss_hist):
        raise AssertionError(f"CLI 256x256: step {hi.state.step}, losses {hi.loss_hist}")
    del hi
    set_counts_to_zero()  # the CLI 256x256 sampling path starts here
    t0 = time.perf_counter()
    res = sample_cli.sample(["--out-dir", run256, "--sampler", "dpm", "--steps",
                             str(CLI_HI_DPM_STEPS), "--n", str(CLI_HI_IMAGES)])
    hi_s = time.perf_counter() - t0
    sample256 = counts()
    dispatches = -(-CLI_HI_IMAGES // res.chunk)
    evals = CLI_HI_DPM_STEPS + 1
    if (sample256["flash_attn"], sample256["gn_silu"]) != (evals * dispatches,
                                                           10 * evals * dispatches):
        raise AssertionError(f"CLI sample 256x256: launches {sample256} in {dispatches} "
                             f"dispatch(es), expected {evals} flash and {10 * evals} gn_silu "
                             f"each")
    hi_tiles = grid_tiles(read_png_gray(res.out_path), CLI_HI_IMAGES, HI_SIZE)
    if not np.array_equal(hi_tiles, quantize_u8(res.x[..., 0])):
        raise AssertionError("CLI sample 256x256: the PNG's tiles are not the samples")
    out["256"] = dict(train_launches=train256, sample_launches=sample256,
                      sample_dispatches=dispatches, sample_cli_seconds=hi_s,
                      tile_mean=float(hi_tiles.mean()))
    log("cli 256x256 " + json.dumps(out["256"]))
    out["launches"] = {"cli_train_64": {k: train64[k] + resumed[k] for k in train64},
                       "cli_sample_64": sample64, "cli_train_256": train256,
                       "cli_sample_256": sample256}
    return out


# Phase 11, the quality instruments and the few-step path, on phase 10's 64x64
# checkpoint. The four committed grids and the JAX CLI's JSON values for each
# (scripts/eval_sde_score_model.py --device cpu --grid <png> --fid-vae
# assets/eval/feature_vae_z16.msgpack): type_acc, type_acc_merged01,
# theta_mae_deg, cond_fidelity, fid, fid_floor.
Q_EXTRACTOR = os.path.join("assets", "eval", "feature_vae_z16.msgpack")
Q_GRIDS = {
    "score_based_diffusion_samples": (0.9444444444444444, 1.0, 1.373015770480742,
                                      0.8909534811973572, 2.526961591332995,
                                      0.8044657404264406),
    "distill_16step": (1.0, 1.0, 0.6309522960235132, 0.9508679509162903, 1.6528338421136883,
                       0.8044657404264406),
    "distill_4step": (0.9444444444444444, 1.0, 0.7380955288268644, 0.914840817451477,
                      1.864640224106342, 0.8044657404264406),
    "fm64_rf50_samples": (0.9444444444444444, 1.0, 0.7896824890979919, 0.9222322106361389,
                          2.2264259119654835, 0.8044657404264406),
}
Q_SCALARS = ("type_acc", "type_acc_merged01", "theta_mae_deg", "cond_fidelity", "fid",
             "fid_floor")
# on the card: the three fractions to 3 decimals, the FIDs to 2, theta within 0.1 deg
# (assets/FIGURES.md:33-35, the metric's backend sensitivity)
Q_GRID_TOL = dict(type_acc=5e-4, type_acc_merged01=5e-4, cond_fidelity=5e-4, fid=5e-3,
                  fid_floor=5e-3, theta_mae_deg=0.1)
Q_RF_STEPS, Q_HEUN_STEPS, Q_FROM_STEPS, Q_TO_STEPS = 50, 8, 8, 4
Q_STUDENT_REQUESTS = (1, 64, 1024)
STUDENT_KEYS = ("param", "distilled", "distill_cfg", "distill_t_end", "distill_teacher",
                "distill_steps")


def _median_ms(fn, runs: int = 3) -> float:
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[runs // 2]


def _f32_model(cfg: dict, params, device):
    from toycrystals_torch.models.sde_score_model import CondUNetTiny
    from toycrystals_torch.utils.params import load_flax_params

    model = CondUNetTiny(int(cfg["n_types"]), int(cfg["y_cont_dim"]), base_ch=int(cfg["base_ch"]),
                         emb_dim=int(cfg["emb_dim"]), cond_ch=int(cfg["cond_ch"]),
                         time_ch=int(cfg["time_ch"]), stem=cfg["stem"])
    load_flax_params(model, params)
    return model.to(device)


def phase_quality(set_counts_to_zero, counts, card: str) -> dict:
    """The eval CLI, rectified flow and progressive distillation at full width
    (module docstring, phase 11)."""
    from toycrystals_torch.data.datasets import generate_batch
    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.models.flow_matching import sample_rectified_flow
    from toycrystals_torch.models.sde_score_model import VPSDE
    from toycrystals_torch.scripts import distill_sde_score_model as distill_cli
    from toycrystals_torch.scripts import eval_sde_score_model as eval_cli
    from toycrystals_torch.scripts import sample_sde_score_model as sample_cli
    from toycrystals_torch.scripts import train_sde_score_model as train_cli
    from toycrystals_torch.serve import ScoreModelService
    from toycrystals_torch.train import distill as td
    from toycrystals_torch.train.state import Optimizer, create_train_state
    from toycrystals_torch.utils import checkpoint as ck
    from toycrystals_torch.utils import fid as qf
    from toycrystals_torch.utils import fidelity as fq

    ckpt64 = os.path.join(CLI_DIR, "64", "checkpoints", "sde_score_model_last.msgpack")
    extractor = os.path.join(ROOT, Q_EXTRACTOR)
    out: dict = {"card": card}
    launches: dict = {}

    # -- a. the template bank: the rasterizer kernel against the plain version
    fq._template_bank.cache_clear()
    set_counts_to_zero()  # the bank's path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec, _, _ = fq.template_bank(CLI_SIZE, device=DEVICE)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches["quality_bank"] = counts()
    if launches["quality_bank"]["rasterize"] != 1 or launches["quality_bank"]["gn_silu"]:
        raise AssertionError(f"template bank: launches {launches['quality_bank']}, expected one "
                             f"rasterizer launch")

    def rebuild():
        fq._template_bank.cache_clear()
        fq.template_bank(CLI_SIZE, device=DEVICE)

    warm_ms = _median_ms(rebuild)
    cpu_spec, _, _ = fq.template_bank(CLI_SIZE, device="cpu")
    d, m = float((spec.cpu() - cpu_spec).abs().max()), float(cpu_spec.abs().max())
    out["bank"] = dict(templates=int(spec.shape[0]), max_abs_diff=d, max_abs=m, tolerance=1e-5 * m,
                       build_ms_first=cold_ms, build_ms=warm_ms, runs=3, statistic="median")
    log("quality template bank " + json.dumps(out["bank"]))
    if not d <= 1e-5 * m:
        raise AssertionError(f"template bank: card and CPU spectra differ by {d} (max {m})")
    fq.template_bank(CLI_SIZE, device=DEVICE)  # cached for the steps below

    # -- b. the committed grids through the eval CLI
    out["grids"] = {}
    for name, want in Q_GRIDS.items():
        path = os.path.join(ROOT, "assets", "score_based_diffusion", f"{name}.png")
        t0 = time.perf_counter()
        line = eval_cli.evaluate(["--grid", path, "--fid-vae", extractor]).line
        got = {k: line[k] for k in Q_SCALARS}
        out["grids"][name] = dict(got, seconds=time.perf_counter() - t0,
                                  jax=dict(zip(Q_SCALARS, want)))
        bad = [k for k, w in zip(Q_SCALARS, want) if not abs(got[k] - w) <= Q_GRID_TOL[k]]
        log(f"quality grid {name}: " + json.dumps(out["grids"][name]))
        if bad:
            raise AssertionError(f"{name}: {bad} differ from the JAX CLI beyond {Q_GRID_TOL}: "
                                 f"{got} vs {dict(zip(Q_SCALARS, want))}")
    tiles = fq.extract_grid_tiles(os.path.join(ROOT, "assets", "score_based_diffusion",
                                               "score_based_diffusion_samples.png"))
    y_cat = np.arange(36) % 4
    theta = np.linspace(0.0, math.pi / 3, 36).astype(np.float32)
    t0 = time.perf_counter()
    fmodel, _ = qf.load_feature_extractor(extractor, device=DEVICE)
    load_ms = (time.perf_counter() - t0) * 1e3
    ref = qf.reference_stats(fmodel)
    out["timing"] = dict(
        score_36_ms=_median_ms(lambda: fq.score_lattice_fidelity(tiles, y_cat, theta,
                                                                 device=DEVICE)),
        fid_36_ms=_median_ms(lambda: qf.compute_fid(tiles[..., None], fmodel, ref_stats=ref)),
        extractor_load_ms=load_ms, runs=3, statistic="median", card=card)
    log("quality instruments " + json.dumps(out["timing"]))

    # -- c. --ckpt on phase 10's checkpoint (SDE-300, CFG 1.5, 36 images)
    set_counts_to_zero()  # the eval CLI's sampling path starts here
    t0 = time.perf_counter()
    res = eval_cli.evaluate(["--ckpt", ckpt64, "--sampler", "sde", "--steps", str(CLI_SDE_STEPS),
                             "--cfg", "1.5", "--t-end", "0.005", "--fid-vae", extractor])
    eval_s = time.perf_counter() - t0
    launches["quality_eval_ckpt"] = c = counts()
    line = res.line
    if c["gn_silu"] != 10 * (CLI_SDE_STEPS + 1) or c["flash_attn"] \
            or (line["sampler"], line["steps"], line["n"]) != ("sde", CLI_SDE_STEPS, CLI_IMAGES) \
            or not all(math.isfinite(line[k]) for k in Q_SCALARS):
        raise AssertionError(f"eval --ckpt: launches {c}, line {line}")
    out["eval_ckpt"] = dict({k: line[k] for k in Q_SCALARS}, seconds=eval_s, launches=c)
    log(f"quality eval --ckpt (phase 10's weights, 3 epochs; {card}): " + json.dumps(
        out["eval_ckpt"]))

    # -- d. rectified flow: train --param fm, sample rf (euler 50, heun 8)
    runfm = os.path.join(CLI_DIR, "fm")
    set_counts_to_zero()  # the fm training path starts here
    fm = train_cli.train(["--procedural", *CLI_MODEL, "--img-size", str(CLI_SIZE), "--param",
                          "fm", "--n-samples", str(CLI_ITEMS), "--batch-size", str(CLI_BATCH),
                          "--epochs", "1", "--sample-every", "0", "--out-dir", runfm])
    launches["quality_train_fm"] = c = counts()
    steps = fm.state.step
    if (c["gn_silu"], c["gn_silu_backward"], c["rasterize"], c["flash_attn"]) != \
            (10 * steps, 10 * steps, steps, 0) or steps != CLI_ITEMS // CLI_BATCH \
            or not all(math.isfinite(v) for v in fm.loss_hist) or fm.config["param"] != "fm":
        raise AssertionError(f"fm training: launches {c} in {steps} steps, losses {fm.loss_hist}")
    out["train_fm"] = dict(steps=steps, loss=fm.loss_hist, launches=c)
    del fm
    out["sample_rf"] = {}
    launches["quality_sample_rf"] = {k: 0 for k in counts()}
    for solver, n_steps, evals in (("euler", Q_RF_STEPS, Q_RF_STEPS + 1),
                                   ("heun", Q_HEUN_STEPS, 2 * Q_HEUN_STEPS + 1)):
        set_counts_to_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sample_cli.sample(["--out-dir", runfm, "--sampler", "rf", "--rf-solver", solver,
                                 "--steps", str(n_steps), "--n", str(CLI_IMAGES)])
        dt = time.perf_counter() - t0
        c = counts()
        dispatches = -(-CLI_IMAGES // res.chunk)
        if c["gn_silu"] != 10 * evals * dispatches or res.sampler != "rf" \
                or not np.isfinite(res.x).all():
            raise AssertionError(f"rf {solver} {n_steps}: launches {c} in {dispatches} "
                                 f"dispatch(es), expected {10 * evals} gn_silu each")
        for k in c:
            launches["quality_sample_rf"][k] += c[k]
        out["sample_rf"][f"{solver}_{n_steps}"] = dict(
            seconds=dt, img_per_s=CLI_IMAGES / dt, dispatches=dispatches,
            gn_silu_per_dispatch=c["gn_silu"] // dispatches)
    fm_ckpt = os.path.join(runfm, "checkpoints", "sde_score_model_last.msgpack")
    svc = ScoreModelService.from_checkpoint(fm_ckpt, device=DEVICE, buckets=(CLI_IMAGES,))
    conds = (np.arange(CLI_IMAGES) % 4, np.linspace(0.0, math.pi / 3, CLI_IMAGES))
    svc.sample_conditions(*conds, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.sample_conditions(*conds, seed=2)
    dt = time.perf_counter() - t0
    out["sample_rf"]["service_rf50_cfg1.5"] = dict(seconds=dt, img_per_s=CLI_IMAGES / dt,
                                                   sampler=svc.sampler_name, steps=svc.steps)
    del svc
    log(f"quality rf ({card}): " + json.dumps(out["sample_rf"]))
    payload = ck.load_score_payload(fm_ckpt)
    rng = np.random.default_rng(11)
    noise = rng.normal(size=(4, CLI_SIZE, CLI_SIZE, 1)).astype(np.float32)
    rf = {}
    for dev in (DEVICE, "cpu"):
        model = _f32_model(payload["config"], payload["state"]["params"], dev).eval()
        with torch.inference_mode():
            rf[dev] = sample_rectified_flow(
                model.requires_grad_(False), None, torch.tensor([0, 1, 2, 3], device=dev),
                torch.zeros(4, 4, device=dev), (4, CLI_SIZE, CLI_SIZE, 1), noise=noise,
                n_steps=2, guidance_scale=1.5, t_end=0.005).cpu()
    d = float((rf[DEVICE] - rf["cpu"]).abs().max())
    out["rf_card_vs_cpu"] = d
    log(f"quality rf: card vs CPU, 2 f32 rf steps (CFG 1.5) on injected noise: max abs diff "
        f"{d:.3e} (tolerance 1e-3)")
    if not d <= 1e-3:
        raise AssertionError(f"rf: card and CPU disagree by {d}")

    # -- e. progressive distillation: 1 f32 step card vs CPU, then the CLI 8 -> 4
    payload = ck.load_score_payload(ckpt64)
    tcfg, tparams = payload["config"], payload["state"]["ema_params"]
    n = 8
    x0, y_cat_t, y_cont_t = generate_batch(LatticeConfig(img_size=CLI_SIZE, rot_only=True), 0,
                                           np.arange(n), device="cpu")
    i_draw = torch.tensor(rng.integers(0, Q_FROM_STEPS, size=n))
    eps = torch.tensor(rng.normal(size=(n, CLI_SIZE, CLI_SIZE, 1)).astype(np.float32))

    @dataclasses.dataclass(frozen=True)
    class KeepGrads(Optimizer):
        seen: list = dataclasses.field(default_factory=list)

        def update(self, params, grads, state):
            self.seen.append([g.detach().cpu() for g in grads])
            return super().update(params, grads, state)

    losses, grads = {}, {}
    for dev in (DEVICE, "cpu"):
        teacher = _f32_model(tcfg, tparams, dev).eval().requires_grad_(False)
        student = _f32_model(tcfg, tparams, dev)
        tx = KeepGrads(TRAIN_LR)
        state = create_train_state(student, tx)
        step = td.make_distill_train_step(student, teacher, tx, VPSDE(0.1, 30.0), Q_FROM_STEPS,
                                          n_types=4, guidance_scale=1.5, t_end=0.005)
        _, loss = step(state, *(a.to(dev) for a in (x0, y_cat_t, y_cont_t)),
                       noise=(i_draw.to(dev), eps.to(dev)))
        losses[dev], grads[dev] = float(loss), tx.seen[0]
        names = list(state.params)
        del teacher, student, state
    leaves = []
    for k, a, b in zip(names, grads[DEVICE], grads["cpu"]):
        dd, mm = float((a - b).abs().max()), float(b.abs().max())
        leaves.append(dict(leaf=k, max_abs_diff=dd, max_abs=mm,
                           share_of_limit=dd / (LEAF_GRAD_TOL[0] * mm + LEAF_GRAD_TOL[1])))
    worst = sorted(leaves, key=lambda r: -r["share_of_limit"])
    l_diff = abs(losses[DEVICE] - losses["cpu"]) / abs(losses["cpu"])
    out["distill_card_vs_cpu"] = dict(items=n, i=i_draw.tolist(), loss_card=losses[DEVICE],
                                      loss_cpu=losses["cpu"], loss_rel_diff=l_diff,
                                      grad_leaves=len(leaves), grad_worst_leaves=worst[:3])
    log("quality distill step card vs CPU " + json.dumps(out["distill_card_vs_cpu"]))
    if not (l_diff <= 1e-3 and worst[0]["share_of_limit"] <= 1.0):
        raise AssertionError(f"distill step: card and CPU disagree: loss rel. difference "
                             f"{l_diff}, worst gradient leaf {worst[0]}")

    rund = os.path.join(CLI_DIR, "distill")
    shutil.rmtree(rund, ignore_errors=True)
    set_counts_to_zero()  # the distillation path starts here
    run = distill_cli.distill(["--teacher", ckpt64, "--from-steps", str(Q_FROM_STEPS),
                               "--to-steps", str(Q_TO_STEPS), "--epochs", "1", "--n-samples",
                               str(CLI_ITEMS), "--batch-size", str(CLI_BATCH), "--cfg", "1.5",
                               "--out-dir", rund])
    launches["quality_distill"] = c = counts()
    steps = sum(len(s) for s in run.epoch_seconds) * (CLI_ITEMS // CLI_BATCH)
    grid_evals = sum(run.schedule)  # one DDIM grid per phase, guidance 0: 1 forward per step
    want = (30 * steps + 10 * grid_evals, 10 * steps, steps, 0)
    if (c["gn_silu"], c["gn_silu_backward"], c["rasterize"], c["flash_attn"]) != want:
        raise AssertionError(f"distillation: launches {c} in {steps} steps and {grid_evals} grid "
                             f"evaluations, expected (gn_silu, backward, rasterize, flash) {want}")
    ckpts = [ck.load_checkpoint(p)["config"] for p in run.checkpoints]
    if run.schedule != [Q_FROM_STEPS, Q_TO_STEPS] or len(ckpts) != 2 or run.preempted \
            or any(cfg.get(k) is None for cfg in ckpts for k in STUDENT_KEYS) \
            or [cfg["distill_steps"] for cfg in ckpts] != run.schedule \
            or any((cfg["param"], cfg["distilled"]) != ("v", True) for cfg in ckpts):
        raise AssertionError(f"distillation: schedule {run.schedule}, configs "
                             f"{[{k: cfg.get(k) for k in STUDENT_KEYS} for cfg in ckpts]}")
    with open(os.path.join(rund, "distill_summary.jsonl")) as f:
        summary = [json.loads(line) for line in f if line.strip()]
    if len(summary) != 2 or not all(math.isfinite(v) for s in summary for v in s.values()):
        raise AssertionError(f"distill_summary.jsonl: {summary}")
    per_phase = CLI_ITEMS // CLI_BATCH
    out["distill"] = dict(
        schedule=run.schedule, losses=run.losses, epoch_seconds=run.epoch_seconds,
        steps_per_s={f"{n_s}-step phase": per_phase / s[0]
                     for n_s, s in zip(run.schedule, run.epoch_seconds)},
        launches=c, gn_silu_per_step=30, gn_silu_backward_per_step=10, rasterize_per_step=1,
        summary=summary, configs=[{k: cfg[k] for k in STUDENT_KEYS} for cfg in ckpts])
    log("quality distill " + json.dumps(out["distill"]))
    log(f"quality distill ({card}): " + ", ".join(
        f"{k} {v:.3f} steps/s" for k, v in out["distill"]["steps_per_s"].items()))

    # -- f. the 4-step student through the service
    svc = ScoreModelService.from_checkpoint(run.checkpoints[-1], device=DEVICE,
                                            buckets=Q_STUDENT_REQUESTS)
    if (svc.sampler_name, svc.steps, svc.guidance_scale) != ("ddim", Q_TO_STEPS, 0.0):
        raise AssertionError(f"student: sampler {svc.sampler_name}, steps {svc.steps}, "
                             f"guidance {svc.guidance_scale}")
    svc.warmup()
    out["student"] = {}
    launches["quality_student"] = {k: 0 for k in counts()}
    for req in Q_STUDENT_REQUESTS:
        set_counts_to_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = svc.sample_conditions(np.arange(req) % 4, np.linspace(0.0, math.pi / 3, req), seed=5)
        dt = time.perf_counter() - t0
        c = counts()
        if c["gn_silu"] != 10 * Q_TO_STEPS or x.shape != (req, CLI_SIZE, CLI_SIZE, 1) \
                or not np.isfinite(x).all() or x.min() < 0 or x.max() > 1:
            raise AssertionError(f"student request of {req}: launches {c}, shape {x.shape}, "
                                 f"range [{x.min()}, {x.max()}]")
        for k in c:
            launches["quality_student"][k] += c[k]
        out["student"][str(req)] = dict(seconds=dt, img_per_s=req / dt, dispatches=1,
                                        gn_silu=c["gn_silu"])
    del svc
    log(f"quality student DDIM-{Q_TO_STEPS} ({card}): " + ", ".join(
        f"{k} images {v['img_per_s']:.1f} img/s" for k, v in out["student"].items()))
    out["launches"] = launches
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json-out", default=None,
                    help="also write every measured number to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="after the main paths, profile U-Net forwards and train steps by "
                         "kernel category")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from toycrystals_torch.data import rasterize as rz
        from toycrystals_torch.ops import attention as at
        from toycrystals_torch.ops import groupnorm as gn
        from toycrystals_torch.utils import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the toycrystals_torch package is missing beside this "
              f"script: {e}", file=sys.stderr)
        return 3

    # f32 parity needs full-f32 convs and matmuls; TF32 is PyTorch's conv default.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi()
    report: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        log(f"env torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        log(f"env nvidia-smi: {card}")
        t0 = time.perf_counter()
        # every source of csrc/; flash_attn once per head dim that phase 4 and the
        # main paths give it
        head_dims = sorted({at._kernel_head_dim(shape[3]) for _, shape, _ in FLASH_SHAPES})
        defines = {"flash_attn": [(f"FLASH_HEAD_DIM={d}",) for d in head_dims]}
        names = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC) if f.endswith(".cu"))
        targets = [(name, d) for name in names for d in defines.get(name, [()])]
        libs = cuda_build.build_all(targets)
        report["build_seconds"] = time.perf_counter() - t0
        log(f"env built {targets} in {report['build_seconds']:.2f} s")
        for lib in libs:
            log(f"env ptxas {lib.name}: " + " | ".join(
                line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
                if "registers" in line or "spill" in line))

        rows, headline = phase_kernel(gn)
        report["kernel_rows"] = rows
        log(f"kernel gn_silu parity passed on {len(rows)} cases")
        report["gn_training_rows"] = gn_training_rows(gn)
        log(f"kernel gn_silu under autograd: output and gradients equal the plain version's "
            f"on {len(report['gn_training_rows'])} training cases")
        raster_rows, raster_headline = phase_raster(rz)
        report["raster_rows"] = raster_rows
        log(f"kernel rasterize parity passed on {len(raster_rows)} cases")
        raster_hi = next(r for r in raster_rows if r["shape"] == "train rot_only 256x256")
        flash_rows, flash_headline = phase_flash(at)
        report["flash_rows"] = flash_rows
        log(f"kernel flash_attn parity passed on {len(flash_rows)} cases, forward and "
            f"gradients")
        report["data_card_vs_cpu"] = phase_data_card_vs_cpu()

        params = {stem: random_flax_params(stem, seed=0) for stem in ("none", "s2dr")}
        for stem in ("none", "s2dr"):
            d = phase_card_vs_cpu(stem, params[stem])
            report[f"card_vs_cpu_{stem}"] = d
            log(f"slice {stem}: card vs CPU, 3 f32 SDE steps on injected noise: "
                f"max abs diff {d:.3e} (tolerance 1e-3)")
            if not d <= 1e-3:
                raise AssertionError(f"{stem}: card and CPU disagree by {d}")

        def set_counts_to_zero():
            gn.gn_silu.launches = gn.gn_silu.backward_launches = rz.rasterize.launches = 0
            at.flash_sdpa.launches = at.flash_sdpa.backward_launches = 0

        def counts():
            return {"gn_silu": gn.gn_silu.launches,
                    "gn_silu_backward": gn.gn_silu.backward_launches,
                    "rasterize": rz.rasterize.launches,
                    "flash_attn": at.flash_sdpa.launches,
                    "flash_attn_backward": at.flash_sdpa.backward_launches}

        set_counts_to_zero()  # the serving path starts here
        report["slices"] = []
        for stem in ("none", "s2dr"):
            report["slices"].append(phase_slice(gn, stem, params[stem]))
        served = counts()

        report["train_card_vs_cpu"] = [phase_train_card_vs_cpu(stem)
                                       for stem in ("none", "s2dr")]
        set_counts_to_zero()  # the training path starts here
        report["train"] = [phase_train(gn, rz, at, stem, dtype) for stem in ("none", "s2dr")
                           for dtype in ("float32", "bfloat16")]
        trained = counts()

        d = phase_card_vs_cpu("none", params["none"], n=2, size=HI_SIZE,
                              logsnr_shift=HI_CFG["logsnr_shift"], v_param=True)
        report["card_vs_cpu_256"] = d
        log(f"slice 256x256: card vs CPU, 2 f32 SDE steps on injected noise (v wrapped to "
            f"eps, flash kernel against the plain version): max abs diff {d:.3e} "
            f"(tolerance 1e-3)")
        if not d <= 1e-3:
            raise AssertionError(f"256x256: card and CPU disagree by {d}")
        set_counts_to_zero()  # phase_slice_hi sets them to 0 again after its warm-up
        report["slice_256"] = phase_slice_hi(gn, at, params["none"])
        served_hi = counts()

        report["train_card_vs_cpu_256"] = phase_train_card_vs_cpu(
            "none", n=2, size=HI_SIZE, steps=1, logsnr_shift=HI_CFG["logsnr_shift"],
            parameterization="v")
        set_counts_to_zero()  # the 256x256 training path starts here
        report["train_256"] = phase_train(
            gn, rz, at, "none", "bfloat16", size=HI_SIZE, batch=HI_TRAIN_BATCH,
            epochs=HI_TRAIN_EPOCHS, steps=HI_TRAIN_STEPS, logsnr_shift=HI_CFG["logsnr_shift"],
            parameterization="v", flash_per_step=1)
        trained_hi = counts()
        report["cli"] = phase_cli(gn, rz, at, set_counts_to_zero, counts, card)
        t0 = time.perf_counter()
        report["quality"] = phase_quality(set_counts_to_zero, counts, card)
        report["quality"]["seconds"] = time.perf_counter() - t0
        log(f"phase 11 took {report['quality']['seconds']:.1f} s")
        report["launches"] = {"serving": served, "training": trained,
                              "serving_256": served_hi, "training_256": trained_hi,
                              **report["cli"]["launches"], **report["quality"]["launches"]}
        log("launches " + json.dumps(report["launches"]))
        for tr in report["train"] + [report["train_256"]]:
            # share of the GroupNorm kernels, forward and backward, in a step
            prefix = "256" if tr["size"] == HI_SIZE else tr["stem"]
            mine = [r for r in report["gn_training_rows"]
                    if r["shape"].startswith(prefix) and r["dtype"] == tr["dtype"]]
            for key in ("forward_ms", "backward_ms", "backward_plain_ms"):
                tr[f"gn_{key}_per_step"] = sum(r[key] * r["blocks_per_step"] for r in mine)
            per_step = tr["gn_forward_ms_per_step"] + tr["gn_backward_ms_per_step"]
            tr["gn_share"] = per_step * tr["steps_per_s"] / 1e3
            log(f"train {tr['stem']} {tr['dtype']} {tr['size']}x{tr['size']}: GroupNorm kernels "
                f"{tr['gn_forward_ms_per_step']:.3f} ms forward + "
                f"{tr['gn_backward_ms_per_step']:.3f} ms backward (plain backward "
                f"{tr['gn_backward_plain_ms_per_step']:.3f}) of {1e3 / tr['steps_per_s']:.3f} ms "
                f"per step ({tr['gn_share']:.3f})")
        flash_train, flash_serve = flash_headline["train batch 32"], flash_headline["serve 12 img"]
        tr, sl = report["train_256"], report["slice_256"]
        tr["flash_ms_per_step"] = flash_train["ms"] + flash_train["backward_ms"]
        tr["flash_share"] = tr["flash_ms_per_step"] * tr["steps_per_s"] / 1e3
        sl["flash_share"] = flash_serve["ms"] * 301 / (sl["throughput_seconds"] * 1e3)
        log(f"flash kernels: {tr['flash_ms_per_step']:.3f} ms of "
            f"{1e3 / tr['steps_per_s']:.3f} ms per 256x256 train step ({tr['flash_share']:.4f}); "
            f"301 x {flash_serve['ms']:.3f} ms of the {sl['throughput_seconds']:.3f} s "
            f"12-image request ({sl['flash_share']:.4f})")
        train_headline = next(r for r in report["gn_training_rows"]
                              if r["shape"] == "none/down1,up1" and r["dtype"] == "bfloat16"
                              and r["pad"])
        if args.profile:
            for stem, sl in zip(("none", "s2dr"), report["slices"]):
                sl["profile"] = profile_stem(stem, params[stem])
            report["train_profile"] = [profile_train(stem, dtype) for stem in ("none", "s2dr")
                                       for dtype in ("float32", "bfloat16")]
            from toycrystals_torch.serve import ScoreModelService

            svc = ScoreModelService(HI_CFG, params["none"], device=DEVICE, buckets=HI_BUCKETS)
            report["slice_256"]["profile"] = [profile_forward(svc.model, rows, HI_SIZE)
                                              for rows in (2 * HI_BATCH, 2)]
            for prof in report["slice_256"]["profile"]:
                log("profile 256x256 " + json.dumps(prof))
            del svc
            report["train_profile"].append(profile_train(
                "none", "bfloat16", size=HI_SIZE, batch=HI_TRAIN_BATCH,
                logsnr_shift=HI_CFG["logsnr_shift"], parameterization="v"))
        paths = report["launches"]
        missing = [f"{path}: {k}" for path, ks in (
            ("serving", ("gn_silu",)), ("training", ("gn_silu", "gn_silu_backward", "rasterize")),
            ("serving_256", ("gn_silu", "flash_attn")),
            ("training_256", ("gn_silu", "gn_silu_backward", "rasterize", "flash_attn",
                              "flash_attn_backward")),
            ("cli_train_64", ("gn_silu", "gn_silu_backward", "rasterize")),
            ("cli_sample_64", ("gn_silu",)),
            ("cli_train_256", ("gn_silu", "gn_silu_backward", "rasterize", "flash_attn",
                               "flash_attn_backward")),
            ("cli_sample_256", ("gn_silu", "flash_attn")), ("quality_bank", ("rasterize",)),
            ("quality_eval_ckpt", ("gn_silu",)),
            ("quality_train_fm", ("gn_silu", "gn_silu_backward", "rasterize")),
            ("quality_sample_rf", ("gn_silu",)),
            ("quality_distill", ("gn_silu", "gn_silu_backward", "rasterize")),
            ("quality_student", ("gn_silu",)))
            for k in ks if paths[path][k] == 0]
        if missing:
            raise AssertionError(f"a main path never launched one of its kernels: {missing}; "
                                 f"{paths}")
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        log("chip_smoke: FAILED")
        return 1
    finally:
        if args.json_out:
            os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
            with open(args.json_out, "w") as f:
                json.dump(report, f, indent=1)

    kernels = [{
        "name": "gn_silu", "route": "cuda", "source": "toycrystals_torch/csrc/gn_silu.cu",
        "replaces": "toycrystals_tpu/ops/groupnorm.py:53",
        "launches": sum(path["gn_silu"] for path in paths.values()),
        "launches_serving": served["gn_silu"], "launches_training": trained["gn_silu"],
        "launches_serving_256": served_hi["gn_silu"],
        "launches_training_256": trained_hi["gn_silu"],
        "launches_cli": {k: paths[k]["gn_silu"] for k in report["cli"]["launches"]},
        "launches_quality": {k: paths[k]["gn_silu"] for k in report["quality"]["launches"]},
        "cluster": headline["plan"]["cluster"],
        "max_abs_err": headline["max_abs_err"],
        "ms": headline["ms"], "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
        "library_call": "F.group_norm + F.silu + F.pad(circular)",
        "at": f"{headline['shape']} {headline['dims']} bf16 pad=True",
        "training_at": {
            "at": f"{train_headline['shape']} {train_headline['dims']} bf16 pad=True, "
                  f"under autograd",
            "max_abs_err": train_headline["max_abs_err"], "ms": train_headline["forward_ms"],
            "plain_ms": train_headline["plain_ms"], "bound_ms": train_headline["bound_ms"],
            "bound_by": train_headline["bound_by"],
            "library_ms": train_headline["library_ms"],
            "backward_ms": train_headline["backward_ms"],
            "backward_bound_ms": train_headline["backward_bound_ms"],
            "backward_bound_by": "bytes",
            "backward_plain_ms": train_headline["backward_plain_ms"],
            "backward_library_ms": train_headline["library_backward_ms"],
            "backward_cluster": train_headline["backward_plan"]["cluster"],
            "grad_max_abs_err": {k: train_headline[f"grad_{k}_closed_form_max_abs_err"]
                                 for k in ("x", "scale", "bias")},
            "grad_x_max_abs_err": train_headline["grad_x_max_abs_err"]},
    }, {
        "name": "gn_silu_backward", "route": "cuda",
        "source": "toycrystals_torch/csrc/gn_silu.cu",
        "replaces": "toycrystals_tpu/ops/groupnorm.py:155 (the custom VJP's backward)",
        "launches": sum(path["gn_silu_backward"] for path in paths.values()),
        "launches_training": trained["gn_silu_backward"],
        "launches_training_256": trained_hi["gn_silu_backward"],
        "launches_cli": {k: paths[k]["gn_silu_backward"] for k in report["cli"]["launches"]},
        "launches_quality": {k: paths[k]["gn_silu_backward"]
                             for k in report["quality"]["launches"]},
        "max_abs_err": train_headline["grad_x_closed_form_max_abs_err"],
        "ms": train_headline["backward_ms"], "plain_ms": train_headline["backward_plain_ms"],
        "bound_ms": train_headline["backward_bound_ms"], "bound_by": "bytes",
        "library_ms": train_headline["library_backward_ms"],
        "library_call": "autograd through F.group_norm + F.silu + F.pad(circular)",
        "cluster": train_headline["backward_plan"]["cluster"],
        "at": f"{train_headline['shape']} {train_headline['dims']} bf16 pad=True, dx, dscale "
              f"and dbias",
    }, {
        "name": "rasterize", "route": "cuda", "source": "toycrystals_torch/csrc/rasterize.cu",
        "replaces": "toycrystals_tpu/data/rasterize.py:72",
        "launches": sum(path["rasterize"] for path in paths.values()),
        "launches_serving": served["rasterize"], "launches_training": trained["rasterize"],
        "launches_training_256": trained_hi["rasterize"],
        "launches_cli": {k: paths[k]["rasterize"] for k in report["cli"]["launches"]},
        "launches_quality": {k: paths[k]["rasterize"] for k in report["quality"]["launches"]},
        "max_abs_err": raster_headline["max_abs_err"], "ms": raster_headline["ms"],
        "ms_is": "the kernel's device time (torch.profiler); wrapper_ms: CUDA events "
                 "around the wrapper's calls",
        "wrapper_ms": raster_headline["wrapper_ms"],
        "plain_ms": raster_headline["plain_ms"], "bound_ms": raster_headline["bound_ms"],
        "bound_by": raster_headline["bound_by"],
        "bound_counts": "bytes (inputs read once, images written once) against the (row, "
                        "column) pairs whose factors are non-zero in this run's data; "
                        "bound_active_atoms_ms counts every atom of weight 1 at every pixel, "
                        "bound_all_atoms_ms every atom of the budget",
        "bound_operations_ms": raster_headline["bound_operations_ms"],
        "bound_active_atoms_ms": raster_headline["bound_active_atoms_ms"],
        "bound_all_atoms_ms": raster_headline["bound_all_atoms_ms"],
        "plan": raster_headline["plan"],
        "survivors_per_tile_mean": raster_headline["survivors_per_tile_mean"],
        "library_ms": raster_headline["plain_tf32_ms"],
        "library_call": "torch.exp factors + one torch.bmm with TF32 allowed",
        "at": f"{raster_headline['shape']} B={raster_headline['b']} P={raster_headline['p']} "
              f"f32, {raster_headline['active_atoms']} atoms of weight 1",
        "training_256_at": {
            "at": f"{raster_hi['shape']} B={raster_hi['b']} P={raster_hi['p']} f32, "
                  f"{raster_hi['active_atoms']} atoms of weight 1",
            "max_abs_err": raster_hi["max_abs_err"], "ms": raster_hi["ms"],
            "wrapper_ms": raster_hi["wrapper_ms"],
            "plain_ms": raster_hi["plain_ms"], "bound_ms": raster_hi["bound_ms"],
            "bound_by": raster_hi["bound_by"],
            "bound_operations_ms": raster_hi["bound_operations_ms"],
            "bound_active_atoms_ms": raster_hi["bound_active_atoms_ms"],
            "bound_all_atoms_ms": raster_hi["bound_all_atoms_ms"],
            "plan": raster_hi["plan"],
            "survivors_per_tile_mean": raster_hi["survivors_per_tile_mean"],
            "library_ms": raster_hi["plain_tf32_ms"]},
    }, {
        "name": "flash_attn", "route": "cuda",
        "source": "toycrystals_torch/csrc/flash_attn.cu",
        "replaces": "toycrystals_tpu/ops/attention.py:74",
        "launches": sum(path["flash_attn"] for path in paths.values()),
        "launches_serving_256": served_hi["flash_attn"],
        "launches_training_256": trained_hi["flash_attn"],
        "backward_passes_training_256": trained_hi["flash_attn_backward"],
        "launches_cli": {k: paths[k]["flash_attn"] for k in report["cli"]["launches"]},
        "backward_passes_cli_train_256": paths["cli_train_256"]["flash_attn_backward"],
        "backward_pass": "three kernels: delta (one thread per row), then dK/dV and dQ "
                         "(bf16: wgmma, TMA rings, 128-row blocks of 3 warpgroups)",
        "max_abs_err": flash_serve["out_max_abs_err"], "ms": flash_serve["ms"],
        "plain_ms": flash_serve["plain_ms"], "bound_ms": flash_serve["bound_ms"],
        "bound_by": flash_serve["bound_by"], "bound_operations": flash_serve["bound_operations"],
        "library_ms": flash_serve["library_ms"],
        "library_call": "F.scaled_dot_product_attention",
        "at": f"forward, {flash_serve['dims']} bf16 (12 images under CFG at 256x256)",
        "training_at": {
            "at": f"forward and backward (delta, dK/dV, dQ), {flash_train['dims']} bf16",
            "max_abs_err": flash_train["out_max_abs_err"], "ms": flash_train["ms"],
            "plain_ms": flash_train["plain_ms"], "bound_ms": flash_train["bound_ms"],
            "bound_operations": flash_train["bound_operations"],
            "library_ms": flash_train["library_ms"],
            "backward_ms": flash_train["backward_ms"],
            "backward_plain_ms": flash_train["plain_backward_ms"],
            "backward_bound_ms": flash_train["backward_bound_ms"],
            "backward_library_ms": flash_train["library_backward_ms"],
            "grad_max_abs_err": {k: flash_train[f"{k}_max_abs_err"]
                                 for k in ("dq", "dk", "dv")}},
    }]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
