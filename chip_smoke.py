#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (toycrystals_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json-out PATH]

Phases, each printing its own lines; any failure exits non-zero with no
result line:

1. Environment: torch version, the card's name and power limit, and the
   seconds to build every CUDA kernel of the port from toycrystals_torch/csrc.
2. Kernel parity and timing: the fused GroupNorm+SiLU(+halo) kernel against
   its plain PyTorch version on the card at every shape the served U-Net
   gives it (parity and s2dr stems, batch 512 = 256 images under CFG), pad
   on and off, f32 and bf16, plus odd shapes. Times of the kernel, the plain
   version, the library yardstick (F.group_norm + F.silu + F.pad) and the
   bound (bytes moved at 3.35 TB/s).
3. The slice at full width (base_ch 96, emb_dim 128, 64x64, bf16, reference
   settings: reverse SDE, 300 steps, CFG 1.5, t_end 0.005) through
   ScoreModelService for the "none" and "s2dr" stems: first a 3-step f32
   run on injected noise, card against CPU; then requests of 1, 4 and 16
   images and one uint8 request, checked for shape, range, finiteness,
   determinism and exactly 10 x 301 kernel launches each.
4. Throughput: one timed 300-step request of 256 images per stem.

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}; the line before them lists every kernel.
Needs one CUDA card; exits non-zero without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
DEVICE = "cuda"
BATCH = 256                   # images per throughput request; 512 rows under CFG
SLICE_CFG = dict(n_types=4, y_cont_dim=4, base_ch=96, emb_dim=128, cond_ch=8, time_ch=8,
                 img_size=64, dtype="bfloat16")
TOL = {"float32": (1e-4, 0.0), "bfloat16": (3e-2, 1.6e-2)}  # (atol, rtol)


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


def kernel_shapes():
    """(label, [B, C, H, W], groups) for every conv-block activation of the
    served U-Net at 64x64, base_ch 96, batch 512, and a few odd shapes."""
    b, bc = 2 * BATCH, 96
    main = [("none/down1,up1", (b, bc, 64, 64)), ("none/down2", (b, 2 * bc, 32, 32)),
            ("none/mid", (b, 2 * bc, 16, 16)), ("none/up2", (b, bc, 32, 32)),
            ("s2dr/down1,up1", (b, bc, 32, 32)), ("s2dr/down2", (b, 2 * bc, 16, 16)),
            ("s2dr/mid", (b, 2 * bc, 8, 8)), ("s2dr/up2", (b, bc, 16, 16))]
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
                           mismatches=bad)
                if label.startswith(("none", "s2dr")):
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


def random_flax_params(stem: str, seed: int) -> dict:
    """A flax-layout CondUNetTiny param tree from a numpy seed: lecun-normal
    weights, zero biases, unit GroupNorm scales, N(0, 1) embeddings."""
    from toycrystals_torch.models.sde_score_model import CondUNetTiny
    from toycrystals_torch.utils.params import flax_from_torch_state_dict

    c = SLICE_CFG
    model = CondUNetTiny(c["n_types"], c["y_cont_dim"], base_ch=c["base_ch"],
                         emb_dim=c["emb_dim"], cond_ch=c["cond_ch"], time_ch=c["time_ch"],
                         stem=stem)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("cat_emb.weight"):
            a = rng.normal(size=shape)
        elif k.endswith("weight") and len(shape) >= 2:
            a = rng.normal(size=shape) / math.sqrt(math.prod(shape[1:]))
        elif k.endswith("weight"):
            a = np.ones(shape)
        else:
            a = np.zeros(shape)
        sd[k] = a.astype(np.float32)
    return flax_from_torch_state_dict(sd)


def phase_card_vs_cpu(stem: str, params: dict) -> float:
    """3 SDE steps + projection in f32 on injected noise: the card (CUDA
    kernel) against the CPU (plain version). Returns the max abs difference."""
    from toycrystals_torch.models.sde_score_model import (
        VPSDE, CondUNetTiny, sample_grid_conditions, sample_reverse_sde_euler_maruyama)
    from toycrystals_torch.utils.params import load_flax_params

    c, n, shape = SLICE_CFG, 3, (2, 64, 64, 1)
    rng = np.random.default_rng(1)
    noise = (rng.normal(size=shape).astype(np.float32),
             rng.normal(size=(n, *shape)).astype(np.float32))
    outs = []
    for dev in (DEVICE, "cpu"):
        model = CondUNetTiny(c["n_types"], c["y_cont_dim"], base_ch=c["base_ch"],
                             emb_dim=c["emb_dim"], cond_ch=c["cond_ch"],
                             time_ch=c["time_ch"], stem=stem)
        load_flax_params(model, params)
        model = model.to(dev).eval()
        yc, yv = sample_grid_conditions(2, c["n_types"], c["y_cont_dim"], device=dev)
        with torch.inference_mode():
            x = sample_reverse_sde_euler_maruyama(
                model, VPSDE(0.1, 30.0), yc, yv, shape, n_steps=n, guidance_scale=1.5,
                t_end=0.005, n_types=c["n_types"], noise=noise)
        outs.append(x.cpu())
    return float((outs[0] - outs[1]).abs().max())


def kernel_category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("gn_silu kernel", ("gn_silu",)),
                      ("conv (cuDNN)", ("conv", "xmma", "implicit", "cudnn", "sm90_")),
                      ("matmul", ("gemm", "cutlass")), ("softmax", ("softmax",)),
                      ("bilinear upsample", ("upsample",)), ("concat", ("cat",)),
                      ("reduction", ("reduce",)),
                      ("elementwise", ("elementwise", "vectorized", "unrolled", "copy"))):
        if any(k in n for k in keys):
            return cat
    return "other"


def profile_forward(model, rows: int) -> dict:
    """Device time by kernel category over 3 U-Net forwards at `rows` rows
    (one CFG sampler step of rows/2 images each), and the device's busy share
    of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    args = (torch.randn(rows, 64, 64, 1, device=DEVICE), torch.full((rows,), 0.5, device=DEVICE),
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
    by_cat: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and not e.key.startswith("aten::"):
            cat = kernel_category(e.key)
            by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e3 / 3
    busy = sum(by_cat.values())
    return {"rows": rows, "wall_ms_per_forward": wall_ms / 3, "device_ms_per_forward": busy,
            "idle_share": 1.0 - busy / (wall_ms / 3),
            "ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1]))}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json-out", default=None,
                    help="also write every measured number to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile U-Net forwards by kernel category")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
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
        names = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC) if f.endswith(".cu"))
        libs = cuda_build.build_all(names)
        report["build_seconds"] = time.perf_counter() - t0
        log(f"env built {names} in {report['build_seconds']:.2f} s")
        for lib in libs:
            log(f"env ptxas {lib.name}: " + " | ".join(
                line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
                if "registers" in line or "spill" in line))

        rows, headline = phase_kernel(gn)
        report["kernel_rows"] = rows
        log(f"kernel parity passed on {len(rows)} cases")

        params = {stem: random_flax_params(stem, seed=0) for stem in ("none", "s2dr")}
        for stem in ("none", "s2dr"):
            d = phase_card_vs_cpu(stem, params[stem])
            report[f"card_vs_cpu_{stem}"] = d
            log(f"slice {stem}: card vs CPU, 3 f32 SDE steps on injected noise: "
                f"max abs diff {d:.3e} (tolerance 1e-3)")
            if not d <= 1e-3:
                raise AssertionError(f"{stem}: card and CPU disagree by {d}")

        gn.gn_silu.launches = 0  # the main path starts here
        report["slices"] = []
        for stem in ("none", "s2dr"):
            report["slices"].append(phase_slice(gn, stem, params[stem]))
        main_launches = gn.gn_silu.launches
        if args.profile:
            for stem, sl in zip(("none", "s2dr"), report["slices"]):
                sl["profile"] = profile_stem(stem, params[stem])
        if main_launches == 0:
            raise AssertionError("the main path never launched the gn_silu kernel")
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
        "launches": main_launches, "max_abs_err": headline["max_abs_err"],
        "ms": headline["ms"], "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
        "library_call": "F.group_norm + F.silu + F.pad(circular)",
        "at": f"{headline['shape']} {headline['dims']} bf16 pad=True",
    }]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
