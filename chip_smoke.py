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
   time from torch.profiler, from the first of up to 5 windows in which
   every kernel launch has its record: a window can lose kernel records)
   and of the wrapper's calls (CUDA events), of the
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

12. The rest of serving, at full width. int8: every distinct conv shape of
   both stems in a 32-row int8 U-Net forward (16 images under CFG), its
   torch._int_mm accumulators and dequantised output bit-equal to the plain
   version (the same im2col as an exact f64 product) on the card, with the
   int8 and the bf16 conv's ms; the f32 int8 s2dr U-Net card against CPU;
   ScoreModelService(quantize="int8") at SDE-300, CFG 1.5, 16 images for both
   stems beside the same request in bf16 (img/s; 3,010 GroupNorm launches and
   301 _int_mm calls per conv per dispatch). border: the f32 U-Net with
   conv_impl "border" against "pad" on the card (1e-4), both timed.
   Inpainting: the inpaint CLI on phase 10's checkpoint, 12 images, center
   mask, 200 steps, --resample 1 and 2 (10 x (steps x resample + 1)
   GroupNorm launches per dispatch, 1 rasterizer launch for the sources; the
   known region equals the source), region_rel_mse and seconds. HTTP:
   make_server on 127.0.0.1 serving phase 11's 4-step student after warmup:
   /healthz, /stats, /sample in every format, 32 concurrent unseeded
   one-image requests (fewer dispatches than requests; p50 / p95 latency,
   img/s), a seeded npy request bit-equal to service.sample, exactly 40
   GroupNorm launches per dispatch; then a server process of phase 10's
   checkpoint stopped by SIGTERM while it samples: the request in flight
   answers 200 and the process exits 0.
13. Export and the VAE trainer, at full width. Export: phase 10's checkpoint
   at the served SDE-300 (CFG 1.5, t_end 0.005; first the service's dispatch
   against the sampler on its own generator, bit-equal), phase 11's 4-step
   student and a 256x256 service at DPM-50 (4,096 tokens: the flash op inside
   the graph), each at one small batch, exported by
   toycrystals_torch/export.py (the step loop one scan), saved, reloaded and
   run: bit-equal to its live service at the same seed, exactly 10 gn_silu
   launches per U-Net forward through the artefact (3,010 at SDE-300; 510
   and 51 flash launches at DPM-50), with the export, save, load and call
   seconds, the nodes of the graph and its step and the file's bytes; an
   SDE-2 export of the same service, traced and saved only, has as many
   nodes as SDE-300's; then the export CLI's --selftest on the student
   (bit-equal). The
   VAE: 2 f32 CondVAE steps card against CPU on one rendered batch
   and injected draws (losses within 1e-5 relative, step-1 gradients leaf by
   leaf as phase 7; the parameters after Adam logged),
   then train_vae --procedural at z 32, batch 128 for 2 epochs of 12,800 items
   and a --resume epoch: 1 rasterizer launch per step plus 2 for the
   diagnostics, img/s per epoch, the three PNGs, and vae_samples_mop.png
   scored by the eval CLI's --grid (fidelity and latent FID).
14. The latent prior and the rest of the data path, at full width.
   build_dataset writes 12,800 rot-only 64x64 items as .npz and as .pt (7
   rasterizer launches each at 2,048 per batch), both read back equal to
   generate_batch quantised on the card; preview_data's grid (1 launch).
   The SDE trainer (base_ch 96, bf16, batch 128) on that archive for 1
   epoch (cut from 2 for time), streamed (--stream 2) and resident (--fused-epoch 0), both under
   torch's deterministic algorithms: the losses and parameters equal bit for
   bit, 10 + 10 gn_silu launches per step, steps/s; a --profile-dir run on
   the first 1,280 items (the trace's bytes and top kernel classes). The
   dense prior at the README's recipe (T 1000, beta_end 0.05, width 1024, 8
   blocks, batch 256, lr 1e-4, mu, DDIM-50) on phase 13's VAE and the
   archive's latents: 2 epochs, --resume 1, --sample-only (z/s, cache and
   DDIM seconds, bucket losses), its grid scored by the eval CLI beside
   phase 13's MoP grid; MoE-4 for 1 epoch (cut from 2) and moe_route_stats on it
   (fractions summing to 1 per block); a procedural cache build (25
   rasterizer launches); no gn_silu or flash launch on the prior's path.
   Card against CPU, TF32 off: 2 f32 prior steps dense and MoE-4 on
   injected (t, eps) (losses 1e-5 relative, step-1 gradients leaf by leaf as
   phase 7) and DDIM-50 on an injected z (1e-3 of the largest |z0|).

15. The data axis (parallel/), at full width (base_ch 96, stem none, 64x64,
   f32, TF32 off). World 1, in this process over NCCL: 2 epochs of 5 steps
   at batch 128 through make_sde_train_epoch with no mesh, under
   DistributedDataParallel and under FSDP2 (place_state on a 1-rank data
   mesh), each from the same initial state under torch's deterministic
   algorithms: DDP's losses and parameters equal the no-mesh run's bit for
   bit, FSDP2's are held to 1e-5 (and logged as bit-equal or not); exactly
   10 gn_silu forward, 10 backward and 1 rasterizer launches per step; step
   ms of each. World 2, two spawned processes on cuda:0 over gloo
   (parallel/parity.py `run_cases` through parallel.multihost.launch): 2 f32
   SDE steps at batch 128 under DDP and under FSDP2, held to the same cases
   run in this process with no mesh (losses 1e-5 relative, step-1 gradients
   and the last moments leaf by leaf as phase 7 plus 1e-6 of the largest
   gradient, parameters within two Adam updates), each rank's peak memory;
   the FSDP2 state written by ShardedCheckpointManager (DCP) reloads in this
   process bit for bit (save and load ms, bytes); sample_chunked of 8 images
   at chunk 4 (10 SDE steps, CFG 1.5) on injected and on drawn noise held to
   the one-process chunks (1e-3, as phase 6: each call has half the rows),
   with each rank's kernel launches equal to the one-process run's.
16. The space axis and serving on a mesh (parallel/spatial.py), on one card:
   two ranks share cuda:0 over gloo, so nothing here times NCCL or a
   collective across cards. The kernels of the space axis against their
   plain versions: the GroupNorm sums and apply kernels at the 256x256
   path's sharded shapes ([24, 96, 128, 256] and the lower levels; bf16 and
   f32, pad on and off; the ranks' sums added in-process; with --profile each
   kernel's device time from torch.profiler in a `bench_gn --space` process,
   cut from the default run for phase 18's time), and the flash
   forward of Nq 2,048 and 1,024 queries against 4,096 gathered keys ([24,
   ., 4, 48], bf16 and f32), each timed beside its plain version (and
   F.scaled_dot_product_attention at the same shapes). A (1, 1) mesh at
   world 1 over NCCL: the service bit-equal to no mesh. F4: int8
   sample_chunked at world 2 (base_ch 96, 64x64, both stems, bf16, SDE-10, 8
   images) against one process: each rank's first int8 activation scale
   equal to the one-process scale (the max over both ranks' rows); the grids'
   gap printed (int8 rounding amplifies the last bits in which the other
   ops' half-batch calls differ). A (data 1, space 2) mesh: a 12-image 256x256 request through
   ScoreModelService(mesh=) at SDE-10 (cut from 300, then 20, for time; stem
   none, param v, logsnr_shift -2.77), f32 against the one-process service's
   dispatch (1e-3), then bf16, timed, each rank's peak memory beside one
   process's, and exactly 11 flash forwards and 110 sums and 110 apply
   launches (no one-launch gn_silu) per rank per dispatch; 64x64 at SDE-10,
   both stems, f32, against one process. Last, the serve CLI with --shard 2
   --dist-backend gloo on phase 10's checkpoint (f32, SDE-4): 8 concurrent
   seeded one-image requests, each bit-equal to the same dispatch of a 2-rank
   mesh launched here with the CLI's settings (its f32 convs run TF32, as
   torch leaves them) and beside the one-process service's dispatch of the
   same layout (the gap printed, beside what TF32 alone moves in one
   process), then SIGTERM: every rank exits 0 within 60 s.
17. Training under the space axis, on one card: two ranks share cuda:0 over
   gloo, so nothing here times NCCL or a collective across cards. The
   GroupNorm backward pair of the space axis (backward sums and backward
   apply kernels) at one rank's rows of the 256x256 step ([32, 96, 128, 256]
   bf16, pad on and off) and the flash backward of Nq 2,048 queries against
   4,096 gathered keys ([32, ., 4, 48], bf16 and f32), each against its plain
   version and timed beside it (and beside autograd of
   F.scaled_dot_product_attention); the GroupNorm pair has no single library
   call. A (1, 1) mesh at world 1 over NCCL: one f32 step bit-equal to no
   mesh. The 256x256 model at full width (base_ch 96, stem none, param v,
   logsnr_shift -2.77) on a (data 1, space 2) mesh: one f32 step at batch 2
   against one process (the loss within 1e-5 relative, every gradient leaf
   within phase 7's limits, the parameters within lr/10 and the EMA within
   (1 - decay) lr/10 plus 4 f32 ulps, where the first moment is at least a
   tenth of its leaf's largest and at least 1e-5), then 2 bf16 steps
   at batch 32, timed, each rank's peak memory beside one process's, with
   exactly 10 sums, 10 apply, 10 backward sums and 10 backward apply
   launches, 1 flash forward and 1 flash backward per rank per step. Its
   64x64 train CLI with --shard-space 2 --dist-backend gloo on the s2dr stem
   (the stem the 256x256 step does not run; cut from both stems at once for
   time), 1 epoch into a DCP checkpoint and --resume to 2, ending in a grid
   sampled on the mesh, runs beside phase 18's train CLIs (cut from its own
   launches for time).
18. The "model" axis and HSDP (parallel/tensor.py, parallel/fsdp.py), on
   one card: the ranks share cuda:0 over gloo, so every time here is host
   copies and time-slicing, not NVLink. The 256x256 model at full width
   (base_ch 96, stem none, param v, logsnr_shift -2.77) on a (data 1, model 2)
   mesh, each rank holding its block of every weight: a 2-image SDE-2 request
   (cut from 20 for time) in f32 through ScoreModelService(mesh=) against the
   one-process service's dispatch (1e-3, phase 16's tolerance), with exactly
   30 gn_silu forwards (on the rank's channel blocks) and 3 flash forwards (on
   its 2 of the 4 heads) per rank per dispatch; one f32 step at batch 2 against one process
   (phase 17's limits), then 2 bf16 steps at batch 8, timed, each with
   exactly 10 + 10 gn_silu and 1 + 1 flash launches per rank per step; each
   rank's seconds and peak memory beside one process's. On the same mesh the
   VAE and the priors at the README's widths, one f32 step each against one
   process (the loss within 1e-5 relative, the gradients within phase 7's
   limits, the MoE route fractions within 1e-6): the VAE (z 32, batch 128)
   on images each rank renders, with exactly 1 rasterizer launch and no
   other per rank per step; the FiLM prior (width 1024, 8 blocks, batch 256)
   and the MoE-4 prior, with none. A (data 2, model 2) job of four ranks
   under FSDP2 (2-D weight sharding): one 64x64 f32 SDE step (base_ch 96,
   clipped, exactly 10 + 10 gn_silu launches per rank on its channel blocks)
   and the VAE's step, each against one process. Last, side by side with
   phase 17's, the 64x64 train CLI with --shard-model 2 (s2dr, 2 ranks), with
   --shard 2 --shard-space 2 --fsdp (HSDP into DCP, stem none, 4 ranks) and
   phase 20's with --shard-space 2 --shard-model 2 (JAX's 3-D mesh into DCP,
   stem none, 4 ranks, at 32x32), 1 epoch and --resume to 2 (ending in a
   grid sampled on each mesh),
   the VAE trainer with --shard 2 --shard-model 2 --fsdp (4 ranks, 1,280
   items, 1 epoch and --resume to 2, its three grids from the gathered
   state), the prior trainer at the README's recipe with --shard-model 2 (1
   epoch on a cache of 2,560 procedural items that its ranks encode with
   phase 13's VAE, a DDIM-10 grid through the placed model), and beside the
   resumes the sample CLI with --shard-model 2 on the first run's epoch-1
   msgpack checkpoint and phase 20's with --shard-space 2 --shard-model 2 on
   a copy of the 3-D run's epoch-1 DCP checkpoint.
19. The prior's pipeline and expert axes (parallel/pipeline.py,
   parallel/expert.py), beside phase 18, in four jobs side by side with one
   spawn each: per axis, one on its (data 1, 2) mesh and its one-process
   reference in a process of its own, so every time is contended. Each job
   runs the prior CLI, with --shard-pipe 2 --pipe-micro 4 or with
   --moe-experts 4 --shard-expert 2 (the reference: the same flags but the
   mesh's), at phase 18's recipe (a 2,560-item procedural cache, 1 epoch,
   DDIM-10), then --resume, then the README's prior (width 1024, 8 blocks,
   batch 256, f32; FiLM at 4 microbatches, MoE-4) for two steps on injected
   draws and DDIM-50 of the 36 grid conditions from injected noise. Held
   against one process: the second step's loss (which follows the first
   step's update) within 1e-5 relative, the first step's gradients within
   phase 7's limits, the MoE route fractions within 1e-6 (the second step
   timed, each rank's state, allocation and peak beside one process's, the
   pipe's 10 hops a step and their seconds a tick); DDIM-50 to 1e-3 of the
   largest |z0| and of each entry's size or 1, with no kernel launch; each
   CLI run's loss, the same on every rank, within 1e-5 relative, its
   checkpoint's parameters within 2e-4 (two Adam steps of the recipe's lr),
   exactly 5 rasterizer launches (the cache build) and no other kernel per
   rank a run, the mesh lines JAX prints, and the grid written.
20. JAX's 3-D ("data", "space", "model") mesh (parallel/mesh.py
   `make_mesh_3d`), on one card: four ranks on a (data 1, space 2, model 2)
   mesh share cuda:0 over gloo. Its mesh job runs beside phase 18 after
   phase 19 and its CLIs in phase 18's CLI stages, so their times are
   contended; the rest runs after phase 18. The 256x256 model at full width (base_ch
   96, stem none, param v, logsnr_shift -2.77), each rank holding its rows
   of the height and its block of every weight: a 2-image SDE-2 request in
   f32 through ScoreModelService(mesh=) against the one-process service's
   dispatch (phase 16's tolerance), with exactly 30 + 30 space-pair launches
   (on the rank's channel blocks, 4 groups) and 3 flash forwards (its 2 of
   the 4 heads against the gathered keys) per rank; one f32 step at batch 2
   against one process (phase 17's limits) and an epoch of 2 bf16 steps at
   batch 8 on images each rank renders, each step with exactly 10 + 10
   space-pair, 10 + 10 backward-pair, 1 + 1 flash launches per rank (and 1
   rasterizer launch in the epoch); each rank's state, seconds and peak
   memory beside one process's. Its CLIs (phase 18's stages) each print
   JAX's "3-D mesh" line. The space pair and its
   backward pair at a rank's channel block ([8, 48, 128, 256] and [8, 96,
   64, 128], 4 groups, pad on and off, bf16 and f32) and the flash forward
   and backward at its 2 heads ([8, 2048, 2, 48] against 4,096 keys) against
   their plain versions, timed beside them (and beside SDPA).

--profile adds device ms by kernel class of U-Net forwards and train steps,
those at 256x256 included, phase 16's space pair's kernel ms by
torch.profiler in a `bench_gn --space` process, and a probe of what
torch.profiler's windows keep before phase 3 and after phase 19 (how many
windows of each kind kept no kernel, the launches left without a kernel
record, the lag of the kernels' timestamps after their launch calls).

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}; the line before them lists every kernel.
Needs one CUDA card; exits non-zero without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 on the tensor cores, dense
TF32_OPS_PER_S = 495e12       # H100 SXM TF32 on the tensor cores, dense
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
# Phase 15: the data axis at world 1 (2 epochs of 5 steps at batch 128) and world 2
PAR_BATCH, PAR_STEPS, PAR_EPOCHS, PAR_W2_STEPS = 128, 5, 2, 2
PAR_SAMPLE = dict(n=8, chunk=4, n_steps=10, cfg=1.5)
# sample_chunked on 2 ranks against one process: each call has half the rows, and
# cuDNN picks its f32 conv algorithms by batch size; phase 6's tolerance for f32
# sampling card against CPU
PAR_SAMPLE_TOL = 1e-3
PAR_DIR = os.path.join(ROOT, "runs", "chip_smoke_parallel")
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


def make_model(stem: str, dtype: str = "float32", conv_impl: str = "pad"):
    from toycrystals_torch.models.sde_score_model import CondUNetTiny

    c = SLICE_CFG
    return CondUNetTiny(c["n_types"], c["y_cont_dim"], base_ch=c["base_ch"],
                        emb_dim=c["emb_dim"], cond_ch=c["cond_ch"], time_ch=c["time_ch"],
                        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
                        stem=stem, conv_impl=conv_impl)


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


def profiler_window_probe(rz, when: str) -> dict:
    """`bench_flash.window_probe` on phase 3's shortest timed calls (the
    rasterizer at the full 32x32 budget, batch TRAIN_BATCH): profiled windows
    of 20 calls, each counted empty where it kept no device time, the
    launches left without a kernel record, and the lag of each kernel's
    timestamp after its launch call's, in this process at `when`."""
    from toycrystals_torch.bench_flash import window_probe
    from toycrystals_torch.data.lattice import LatticeConfig, generate_item, static_point_budget

    cfg = LatticeConfig(img_size=32)
    pts, wts, sigma, *_ = generate_item(cfg, static_point_budget(cfg), 0,
                                        torch.arange(TRAIN_BATCH), DEVICE)
    probe = dict(when=when, **window_probe(lambda: rz.rasterize(pts, wts, sigma, 32, 32), 20,
                                           "rasterize"))
    log("profiler window probe " + json.dumps(probe))
    return probe


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
            # the kernel's device time (torch.profiler, from a window that kept
            # every kernel's record: bench_flash.kernel_ms); at these shapes CUDA
            # events around the calls time the wrapper's host cost, kept as wrapper_ms
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
                clock_hz: float = H100_SM_CLOCK_MAX_HZ, nk: int | None = None
                ) -> tuple[float, str, str]:
    """Least time for one call of q [B, N, H, d] against Nk keys (default N):
    the largest of three. Tensor operations: the forward's 2 products of
    2 B H N Nk d operations, the backward's 5 (S, dP, dV, dK, dQ), at the
    tensor cores' bf16 rate; for f32 inputs three TF32 products each (hi hi,
    hi lo, lo hi: f32 accuracy from TF32 halves) at the TF32 rate.
    Exponentials: one exp2 per logit, B H N Nk (the
    backward's least work too), at 16 per clock per SM on 132 SMs at the top
    SM clock. Bytes: q, k, v read and O and the f32 row log-sum-exp written
    once (backward: q, k, v, O, dO and L read, dq, dk, dv written).
    Returns (ms, "operations" or "bytes", which operations or "bytes")."""
    b, n, h, d = shape
    nk = n if nk is None else nk
    ops = (10 if backward else 4) * b * h * n * nk * d
    elems = ((4 * n + 4 * nk) if backward else (2 * n + 2 * nk)) * b * h * d
    terms = {
        "tensor operations" if elem_bytes == 2 else "TF32 operations, 3 per product":
            (ops / BF16_OPS_PER_S if elem_bytes == 2 else 3 * ops / TF32_OPS_PER_S) * 1e3,
        "exponentials": b * h * n * nk / (SFU_EXP2_PER_CLOCK_PER_SM * SMS * clock_hz) * 1e3,
        "bytes": (elems * elem_bytes + b * h * n * 4) / HBM_BYTES_PER_S * 1e3,
    }
    what = max(terms, key=terms.get)
    return terms[what], ("bytes" if what == "bytes" else "operations"), what


# what the kernels line keeps of each f32 flash row
F32_FLASH_KEYS = ("dims", "nk", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                  "bound_operations", "backward_ms", "plain_backward_ms", "library_backward_ms",
                  "backward_bound_ms", "backward_bound_operations", "out_max_abs_err",
                  "max_abs_err", "dq_max_abs_err", "dk_max_abs_err", "dv_max_abs_err",
                  "rerun_bit_equal")


def phase_flash(at) -> tuple[list[dict], dict]:
    """The flash kernels against `sdpa_reference` in f32 on the same values
    (bf16 inputs upcast; 8 items at a time, since the plain version holds the
    [B, heads, N, N] logits): output and the gradients of q, k, v under a
    random cotangent, each within FLASH_TOL of the reference's largest entry.
    Timed f32 rows also rerun forward and backward and must repeat their bits
    (no atomics). `headline` keys: the label, and the label + " f32"."""
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
            if iters and dtype == torch.float32:
                again = at.flash_sdpa(*leaves)
                row["rerun_bit_equal"] = bool(torch.equal(again, out)) and all(
                    torch.equal(a, g) for a, g in
                    zip(torch.autograd.grad(again, leaves, up), grads))
                del again
                if not row["rerun_bit_equal"]:
                    bad.append("rerun bits")
            if iters:
                it = iters
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
                headline[label if dtype == torch.bfloat16 else label + " f32"] = row
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
    out["student_ckpt"] = run.checkpoints[-1]
    log(f"quality student DDIM-{Q_TO_STEPS} ({card}): " + ", ".join(
        f"{k} images {v['img_per_s']:.1f} img/s" for k, v in out["student"].items()))
    out["launches"] = launches
    return out


# Phase 12, the rest of serving: int8 and border convs, inpainting and the HTTP
# front end, at full width on the random weights of phase 6 and the checkpoints of
# phases 10 and 11.
S12_IMAGES = 16                     # the int8 request: 32 rows under CFG
S12_INPAINT_IMAGES, S12_INPAINT_STEPS = 12, 200
S12_CONCURRENT = 32                 # unseeded one-image HTTP requests at once
# The int8 U-Net, card against CPU, f32. Each conv is held bit for bit, on the
# card's own input, to the CPU's conv. The whole forward cannot be: the GroupNorm
# kernel and the plain version differ by ~1e-7, which moves an activation across a
# rounding boundary of its int8 grid, and a flipped quantum changes the next convs'
# inputs enough to flip more (the forward's change when its input is scaled by
# 1 + 1e-7 is logged beside). So each side's int8 forward is held to its own float
# forward: the card's mean quantisation error within this factor of the CPU's.
INT8_ERROR_RATIO = 1.5


def _post(url: str, obj, timeout: float = 300.0):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _get(url: str, timeout: float = 60.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _conv_calls(model, args) -> list:
    """(name, module, input, output) of every conv of one forward of `model`
    on the tensors `args`."""
    from toycrystals_torch.ops.conv import Conv2d

    names = {m: n for n, m in model.named_modules() if isinstance(m, Conv2d)}
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, o: seen.append((names[mod], mod, inp[0].clone(), o.clone())))
        for m in names]
    try:
        with torch.inference_mode():
            model(*args)
    finally:
        for h in hooks:
            h.remove()
    return seen


def phase_serving_rest(set_counts_to_zero, counts, card: str, params: dict,
                       student_ckpt: str) -> dict:
    """int8 and border convs, inpainting and the HTTP front end at full width
    (module docstring, phase 12)."""
    import io
    import signal
    import threading

    from toycrystals_torch.ops import conv as tc
    from toycrystals_torch.ops.conv import CircularConv
    from toycrystals_torch.scripts import inpaint_sde_score_model as inpaint_cli
    from toycrystals_torch.scripts import serve_sde_score_model as serve_cli
    from toycrystals_torch.serve import ScoreModelService, npy_bytes
    from toycrystals_torch.utils.params import load_flax_params

    out: dict = {"card": card}
    launches: dict = {}
    conds = (np.arange(S12_IMAGES) % 4, np.linspace(0.0, 1.0, S12_IMAGES))

    # -- a. int8: every conv shape of both stems, the U-Net card vs CPU, the service
    out["int8_shapes"], out["int8_service"] = [], {}
    launches["int8_serving"] = {k: 0 for k in counts()}
    for stem in ("none", "s2dr"):
        svc8 = ScoreModelService(dict(SLICE_CFG, stem=stem), params[stem], device=DEVICE,
                                 quantize="int8", buckets=(S12_IMAGES,))
        svcb = ScoreModelService(dict(SLICE_CFG, stem=stem), params[stem], device=DEVICE,
                                 buckets=(S12_IMAGES,))
        n_convs = sum(isinstance(m, tc.Conv2d) for m in svc8.model.modules())
        rows, keys = 2 * S12_IMAGES, set()
        calls = _conv_calls(svc8.model, (
            torch.randn(rows, 64, 64, 1, device=DEVICE), torch.rand(rows, device=DEVICE),
            torch.arange(rows, device=DEVICE) % 5, torch.randn(rows, 4, device=DEVICE)))
        for _, mod, x, _ in calls:
            wrap = isinstance(mod, CircularConv)
            key = (tuple(x.shape), tuple(mod.weight.shape), mod.stride, wrap)
            if key in keys:  # one check per distinct conv shape
                continue
            keys.add(key)
            with torch.inference_mode():
                xq, sx = tc.quantize_int8(x)
                wq, sw = tc.quantize_int8(mod.weight, dims=(1, 2, 3))
                xp = tc.wrap_pad(xq) if wrap else xq
                acc = tc.int8_conv_acc(xp, wq, mod.stride)
                ref = tc.int8_conv_acc_reference(xp, wq, mod.stride)
                y, y_ref = mod(x), tc.dequantize(ref, sx, sw, mod.bias, mod.dtype)
                wb, bb = mod.weight.to(torch.bfloat16), mod.bias.to(torch.bfloat16)
                xb = tc.wrap_pad(x) if wrap else x
                rec = dict(stem=stem, input=list(x.shape), weight=list(mod.weight.shape),
                           stride=mod.stride, wrap=wrap,
                           acc_equal=bool(torch.equal(acc, ref)),
                           output_equal=bool(torch.equal(y, y_ref)),
                           int8_ms=cuda_time_ms(lambda: mod(x), iters=10),
                           bf16_conv_ms=cuda_time_ms(
                               lambda: F.conv2d(xb, wb, bb, stride=mod.stride), iters=10))
            out["int8_shapes"].append(rec)
            if not (rec["acc_equal"] and rec["output_equal"]):
                raise AssertionError(f"int8 conv on the card differs from its plain version: "
                                     f"{rec}")
        with torch.inference_mode():  # warm the bf16 service's shapes
            svcb.model(torch.randn(2 * S12_IMAGES, 64, 64, 1, device=DEVICE),
                       torch.rand(2 * S12_IMAGES, device=DEVICE),
                       torch.zeros(2 * S12_IMAGES, dtype=torch.int32, device=DEVICE),
                       torch.zeros(2 * S12_IMAGES, 4, device=DEVICE))
        res = {}
        for name, svc in (("int8", svc8), ("bf16", svcb)):
            set_counts_to_zero()
            mm0 = tc.int8_conv_acc.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = svc.sample_conditions(*conds, seed=S12_IMAGES)
            dt = time.perf_counter() - t0
            c, mm = counts(), tc.int8_conv_acc.launches - mm0
            want_mm = n_convs * (svc.steps + 1) if name == "int8" else 0
            if c["gn_silu"] != 10 * (svc.steps + 1) or mm != want_mm \
                    or x.shape != (S12_IMAGES, 64, 64, 1) or not np.isfinite(x).all() \
                    or x.min() < 0 or x.max() > 1:
                raise AssertionError(f"{stem} {name} request: launches {c}, int_mm calls {mm} "
                                     f"(expected {want_mm}), shape {x.shape}")
            if name == "int8":
                for k in c:
                    launches["int8_serving"][k] += c[k]
                if svc.stats["quantize"] != "int8":
                    raise AssertionError(f"int8 service stats: {svc.stats}")
            res[name] = dict(seconds=dt, img_per_s=S12_IMAGES / dt, gn_silu=c["gn_silu"],
                             int_mm_calls=mm, x=x)
        out["int8_service"][stem] = dict(
            {k: {kk: v for kk, v in r.items() if kk != "x"} for k, r in res.items()},
            convs_per_forward=n_convs, int8_over_bf16_seconds=res["int8"]["seconds"]
            / res["bf16"]["seconds"],
            mean_abs_diff_int8_bf16=float(np.abs(res["int8"]["x"] - res["bf16"]["x"]).mean()))
        log(f"int8 service {stem} ({card}): " + json.dumps(out["int8_service"][stem]))
        del svc8, svcb, res
    shapes = out["int8_shapes"]
    log(f"int8 conv: _int_mm accumulators and dequantised outputs bit-equal to the plain "
        f"version at {len(shapes)} conv shapes (both stems, {2 * S12_IMAGES} rows): " +
        json.dumps(shapes))

    rng = np.random.default_rng(12)
    args = (rng.normal(size=(2, 64, 64, 1)).astype(np.float32), np.array([0.3, 0.8], np.float32),
            np.array([1, 4], np.int32), rng.normal(size=(2, 4)).astype(np.float32))
    models, got = {}, {}
    for dev in (DEVICE, "cpu"):
        for impl in ("int8", "pad"):
            model = make_model("s2dr", "float32", impl)
            load_flax_params(model, params["s2dr"])
            models[dev, impl] = model.to(dev).eval()
            with torch.inference_mode():
                got[dev, impl] = model(*(torch.from_numpy(a).to(dev) for a in args)).cpu()
    # every conv of the card's forward, on the card's own input, against the CPU's conv
    cpu_mods = dict(models["cpu", "int8"].named_modules())
    convs = _conv_calls(models[DEVICE, "int8"],
                        tuple(torch.from_numpy(a).to(DEVICE) for a in args))
    with torch.inference_mode():
        unequal = [name for name, _, x, y in convs
                   if not torch.equal(y.cpu(), cpu_mods[name](x.cpu()))]
        perturbed = models[DEVICE, "int8"](
            torch.from_numpy(args[0] * np.float32(1 + 1e-7)).to(DEVICE),
            *(torch.from_numpy(a).to(DEVICE) for a in args[1:])).cpu()
    diff = (got[DEVICE, "int8"] - got["cpu", "int8"]).abs()
    self_diff = (got[DEVICE, "int8"] - perturbed).abs()
    err = {dev: (got[dev, "int8"] - got[dev, "pad"]).abs() for dev in (DEVICE, "cpu")}
    ratio = float(err[DEVICE].mean() / err["cpu"].mean())
    out["int8_card_vs_cpu"] = dict(
        stem="s2dr", rows=2, dtype="float32", convs=len(convs), convs_unequal=unequal,
        max_abs_diff=float(diff.max()), mean_abs_diff=float(diff.mean()),
        perturbed_1e7_max_abs_diff=float(self_diff.max()),
        perturbed_1e7_mean_abs_diff=float(self_diff.mean()),
        int8_error_card=dict(max=float(err[DEVICE].max()), mean=float(err[DEVICE].mean())),
        int8_error_cpu=dict(max=float(err["cpu"].max()), mean=float(err["cpu"].mean())),
        int8_error_ratio=ratio, ratio_limit=INT8_ERROR_RATIO,
        float_card_vs_cpu_max_abs_diff=float((got[DEVICE, "pad"] - got["cpu", "pad"]).abs().max()))
    del models
    log("int8 U-Net forward card vs CPU " + json.dumps(out["int8_card_vs_cpu"]))
    if unequal or not 1.0 / INT8_ERROR_RATIO <= ratio <= INT8_ERROR_RATIO:
        raise AssertionError(f"int8 U-Net: card and CPU disagree: {out['int8_card_vs_cpu']}")

    # -- b. border against pad on the card, f32
    models = {}
    for impl in ("pad", "border"):
        model = make_model("none", "float32", impl)
        load_flax_params(model, params["none"])
        models[impl] = model.to(DEVICE).eval()
    xb = tuple(torch.from_numpy(np.repeat(a, S12_IMAGES, axis=0)).to(DEVICE) for a in args)
    with torch.inference_mode():
        yb = {impl: m(*xb) for impl, m in models.items()}
        d = float((yb["border"] - yb["pad"]).abs().max())
        out["border"] = dict(rows=2 * S12_IMAGES, dtype="float32", max_abs_diff=d,
                             tolerance=TOL["float32"][0], **{
                                 f"{impl}_forward_ms": cuda_time_ms(lambda m=m: m(*xb), iters=5)
                                 for impl, m in models.items()})
    del models, yb
    log(f"border conv U-Net forward ({card}): " + json.dumps(out["border"]))
    if not d <= TOL["float32"][0]:
        raise AssertionError(f"border and pad U-Nets differ by {d}")

    # -- c. inpainting through its CLI on phase 10's checkpoint
    run64 = os.path.join(CLI_DIR, "64")
    out["inpaint"] = {}
    launches["inpaint"] = {k: 0 for k in counts()}
    for r in (1, 2):
        set_counts_to_zero()  # the inpainting path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inpaint_cli.inpaint(["--out-dir", run64, "--n", str(S12_INPAINT_IMAGES),
                                   "--mask", "center", "--steps", str(S12_INPAINT_STEPS),
                                   "--resample", str(r)])
        dt = time.perf_counter() - t0
        c = counts()
        dispatches = -(-S12_INPAINT_IMAGES // res.chunk)
        keep = res.mask == 1.0
        if c["gn_silu"] != 10 * (S12_INPAINT_STEPS * r + 1) * dispatches or c["rasterize"] != 1 \
                or c["flash_attn"] or not np.isfinite(res.x).all() \
                or not np.array_equal(res.x[keep], res.x_src[keep]):
            raise AssertionError(f"inpaint resample {r}: launches {c} in {dispatches} "
                                 f"dispatch(es), line {res.line}")
        for k in c:
            launches["inpaint"][k] += c[k]
        out["inpaint"][f"resample_{r}"] = dict(res.line, seconds=dt, dispatches=dispatches,
                                               launches=c)
        log(f"inpaint ({card}): " + json.dumps(out["inpaint"][f"resample_{r}"]))

    # -- d. the HTTP front end: the 4-step student in process, then a SIGTERM drain
    svc = ScoreModelService.from_checkpoint(student_ckpt, device=DEVICE)
    svc.warmup()
    srv = serve_cli.make_server(svc, "127.0.0.1", 0, window_ms=5.0)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    http: dict = {}
    try:
        code, _, body = _get(url + "/healthz")
        health = json.loads(body)
        code2, _, body = _get(url + "/stats")
        stats = json.loads(body)
        if (code, code2) != (200, 200) or not health["ok"] or set(stats) != {"service", "batcher"}:
            raise AssertionError(f"/healthz {code} {health}, /stats {code2} {stats}")
        set_counts_to_zero()  # the HTTP path starts here
        d0, b0 = svc.stats["dispatches"], dict(srv.batcher.stats)
        formats = {}
        for fmt, ctype in (("json", "application/json"), ("png", "image/png"),
                           ("png_raw", "image/png"), ("npy", "application/octet-stream")):
            t0 = time.perf_counter()
            code, got_ctype, body = _post(url + "/sample", {"types": [0, 1, 2, 3],
                                                            "format": fmt})
            formats[fmt] = dict(seconds=time.perf_counter() - t0, bytes=len(body))
            ok = code == 200 and got_ctype == ctype and (
                json.loads(body)["shape"] == [4, 64, 64, 1] if fmt == "json" else
                np.load(io.BytesIO(body)).shape == (4, 64, 64, 1) if fmt == "npy" else
                body[:8] == b"\x89PNG\r\n\x1a\n")
            if not ok:
                raise AssertionError(f"/sample format {fmt}: {code} {got_ctype}")
        http["formats"] = formats
        go = threading.Barrier(S12_CONCURRENT)
        lat = [None] * S12_CONCURRENT

        def one(i):
            go.wait(timeout=60)
            t0 = time.perf_counter()
            code, _, body = _post(url + "/sample", {"types": [i % 4], "thetas": [0.03 * i],
                                                    "format": "npy"})
            x = np.load(io.BytesIO(body))
            lat[i] = (time.perf_counter() - t0, code == 200 and x.shape == (1, 64, 64, 1)
                      and bool(np.isfinite(x).all()))

        b1 = dict(srv.batcher.stats)
        threads = [threading.Thread(target=one, args=(i,)) for i in range(S12_CONCURRENT)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        b2 = srv.batcher.stats
        batched = b2["batched_dispatches"] - b1["batched_dispatches"]
        ms = np.array([v[0] for v in lat if v]) * 1e3
        http["concurrent"] = dict(
            requests=S12_CONCURRENT, dispatches=batched,
            coalesced=b2["coalesced_requests"] - b1["coalesced_requests"], seconds=wall,
            img_per_s=S12_CONCURRENT / wall, p50_ms=float(np.percentile(ms, 50)),
            p95_ms=float(np.percentile(ms, 95)), max_ms=float(ms.max()))
        if any(t.is_alive() for t in threads) or not all(v and v[1] for v in lat) \
                or not batched < S12_CONCURRENT:
            raise AssertionError(f"concurrent requests: {http['concurrent']}, {lat}")
        seeded = {"types": [0, 1, 2, 3], "thetas": [0.0, 0.2, 0.4, 0.6], "format": "npy",
                  "seed": 123}
        code, _, body = _post(url + "/sample", seeded)
        want = npy_bytes(svc.sample_conditions(seeded["types"], seeded["thetas"], seed=123))
        http["seeded_npy_bit_equal"] = code == 200 and body == want
        if not http["seeded_npy_bit_equal"]:
            raise AssertionError("a seeded npy request differs from service.sample")
        c = counts()
        dispatches = svc.stats["dispatches"] - d0
        http["launches"], http["dispatches"] = c, dispatches
        http["batcher_dispatches"] = srv.batcher.stats["batched_dispatches"] \
            - b0["batched_dispatches"]
        if c["gn_silu"] != 10 * svc.steps * dispatches:
            raise AssertionError(f"HTTP: launches {c} in {dispatches} dispatches, expected "
                                 f"{10 * svc.steps} gn_silu each")
        launches["http_student"] = c
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        server_thread.join(timeout=60)
    log(f"HTTP front end, DDIM-{svc.steps} student ({card}): " + json.dumps(http))
    del svc

    # a server process of phase 10's checkpoint (SDE-300), stopped by SIGTERM mid-request
    ckpt64 = os.path.join(run64, "checkpoints", "sde_score_model_last.msgpack")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "toycrystals_torch.scripts.serve_sde_score_model", ckpt64,
         "--port", "0", "--buckets", str(S12_IMAGES)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        purl, deadline = None, time.time() + 300
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("listening on "):
                purl = line.split()[2]
                break
            if proc.poll() is not None:
                raise AssertionError(f"the server process died early:\n{proc.stdout.read()}")
        if purl is None:
            raise AssertionError("the server process never reported its address")
        got_resp: dict = {}

        def request():
            t0 = time.perf_counter()
            got_resp["resp"] = _post(purl + "/sample", {"types": list(range(4)) * 4,
                                                        "format": "npy"})
            got_resp["seconds"] = time.perf_counter() - t0

        t = threading.Thread(target=request)
        t.start()
        # SIGTERM once the batcher's dispatch has begun (301 forwards take seconds)
        while time.time() < deadline and json.loads(
                _get(purl + "/stats")[2])["batcher"]["coalesced_requests"] == 0:
            time.sleep(0.01)
        in_flight = json.loads(_get(purl + "/stats")[2])["service"]["requests"] == 0
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=300)
        log_out, _ = proc.communicate(timeout=300)
        drain_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    code, _, body = got_resp.get("resp", (None, None, b""))
    http["sigterm"] = dict(returncode=proc.returncode, request_code=code,
                           in_flight_at_signal=in_flight,
                           request_seconds=got_resp.get("seconds"), seconds_to_exit=drain_s)
    log(f"HTTP SIGTERM drain ({card}): " + json.dumps(http["sigterm"]))
    if proc.returncode != 0 or code != 200 or not in_flight or "draining" not in log_out \
            or "serving stopped" not in log_out \
            or np.load(io.BytesIO(body)).shape != (S12_IMAGES, 64, 64, 1):
        raise AssertionError(f"SIGTERM drain: {http['sigterm']}\n{log_out}")
    out["http"] = http
    out["launches"] = launches
    return out


# Phase 13, export and the VAE trainer: the exported sampler of phase 10's
# checkpoint, of phase 11's student and of a 256x256 service, each bit-equal to
# its live service; then train_vae at full width.
EXPORT_BATCH = 4                    # images per exported dispatch
EXPORT_SDE_STEPS = 300              # the served setting: SDE-300 at CFG 1.5, t_end 0.005
EXPORT_TRACE_STEPS = 2              # an SDE-2 export of the same service, traced and saved
                                    # only: its graph has as many nodes as SDE-300's
EXPORT_HI_STEPS = 50                # DPM steps of the 256x256 export (flash inside)
VAE_DIR = os.path.join(ROOT, "runs", "chip_smoke_vae")
VAE_ITEMS, VAE_BATCH, VAE_Z = 12800, 128, 32  # the CLI's defaults but for the item count
VAE_REL = 1e-5                      # VAE steps card vs CPU: each loss, relative


def _export_round_trip(name: str, svc, path: str, set_counts_to_zero, counts) -> dict:
    """Export `svc` at its one bucket, save, load, run the artefact once (its
    launches counted) and hold it to svc.sample at the same seed, bit for bit."""
    from toycrystals_torch import export as ex

    b = svc.buckets[0]
    t0 = time.perf_counter()
    ep = ex.export_service(svc, b)
    export_s = time.perf_counter() - t0
    nodes, ops = ex.graph_nodes(ep), ex.custom_ops(ep)
    t0 = time.perf_counter()
    ex.save_exported(path, ep, ex.export_meta(svc, b, ep))
    save_s = time.perf_counter() - t0
    del ep
    t0 = time.perf_counter()
    fn, meta = ex.load_exported(path)
    load_s = time.perf_counter() - t0
    y_cat = (np.arange(b) % svc.n_types).astype(np.int32)
    y_cont = np.zeros((b, svc.y_cont_dim), np.float32)
    y_cont[:, 1] = np.linspace(0.0, math.pi / 3, b)
    fn(y_cat, y_cont, 11)  # the first call builds the graph's kernels' libraries
    torch.cuda.synchronize()
    set_counts_to_zero()  # the artefact's path starts here
    t0 = time.perf_counter()
    got = fn(y_cat, y_cont, 11).cpu().numpy()
    call_s = time.perf_counter() - t0
    c = counts()
    t0 = time.perf_counter()
    want = svc.sample(y_cat, y_cont, seed=11)
    live_s = time.perf_counter() - t0
    diff = float(np.abs(got - want).max())
    rec = dict(batch=b, sampler=meta["sampler"], steps=meta["steps"], graph_nodes=nodes,
               custom_ops=ops, export_seconds=export_s, save_seconds=save_s,
               bytes=os.path.getsize(path), load_seconds=load_s, call_seconds=call_s,
               service_seconds=live_s, max_abs_diff=diff, bit_equal=bool(np.array_equal(got, want)),
               launches=c)
    log(f"export {name}: " + json.dumps(rec))
    if not rec["bit_equal"] or not np.isfinite(got).all():
        raise AssertionError(f"export {name}: the artefact differs from the live service by "
                             f"{diff}")
    return rec


def _vae_steps_card_vs_cpu(card: str) -> dict:
    """2 f32 CondVAE steps at full width on one rendered batch and injected
    draws, card against CPU: each loss within VAE_REL relative, and the
    step-1 gradients leaf by leaf within LEAF_GRAD_TOL (as phase 7). The
    parameters after Adam are logged, not held: Adam's first updates are
    lr * g / (|g| + 1e-8), so a gradient that cancels to near 0 and rounds
    to the other sign on one side moves its entry by up to 2 lr."""
    from toycrystals_torch.data.datasets import generate_batch
    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.models.torch_init import flax_default_init
    from toycrystals_torch.models.vae import CondVAE
    from toycrystals_torch.train.state import Optimizer, create_train_state
    from toycrystals_torch.train.steps import make_vae_train_step, vae_loss_and_grads

    cfg = LatticeConfig(img_size=64, n_types=4, rot_only=True)
    x, y_cat, y_cont = generate_batch(cfg, 5, torch.arange(VAE_BATCH), device="cpu")
    g = torch.Generator().manual_seed(6)
    draws = [(torch.randn((VAE_BATCH, VAE_Z), generator=g),
              (torch.rand((VAE_BATCH, 1), generator=g) >= 0.1).float()) for _ in range(2)]
    beta_eff = 3e-4 / 5
    runs = {}
    for dev in ("cpu", DEVICE):
        model = flax_default_init(CondVAE(z_dim=VAE_Z, cond_drop=0.1),
                                  np.random.default_rng(7)).to(dev)
        tx = Optimizer(2e-3)
        state = create_train_state(model, tx)
        step = make_vae_train_step(model, tx, 0.05)
        batch = [a.to(dev) for a in (x, y_cat, y_cont)]
        _, grads = vae_loss_and_grads(model, *batch, beta_eff, 0.05,
                                      noise=tuple(a.to(dev) for a in draws[0]))
        losses = []
        for eps, keep in draws:
            state, m = step(state, *batch, beta_eff, noise=(eps.to(dev), keep.to(dev)))
            losses.append(float(m["loss"]))
        runs[dev] = (losses, [a.cpu() for a in grads],
                     {k: v.detach().cpu() for k, v in state.params.items()})
    (lc, gc, pc), (lg, gg, pg) = runs["cpu"], runs[DEVICE]
    leaves = []
    for k, a, b in zip(pc, gg, gc):
        d, m = float((a - b).abs().max()), float(b.abs().max())
        leaves.append(dict(leaf=k, max_abs_diff=d, max_abs=m,
                           share_of_limit=d / (LEAF_GRAD_TOL[0] * m + LEAF_GRAD_TOL[1])))
    worst = max(leaves, key=lambda r: r["share_of_limit"])
    diff = math.sqrt(sum(float(((pg[k] - pc[k]) ** 2).sum()) for k in pc))
    norm = math.sqrt(sum(float((pc[k] ** 2).sum()) for k in pc))
    # the entries that moved apart by more than lr / 10, and their step-1 gradients
    apart = [(pg[k] - pc[k]).abs() > 2e-4 for k in pc]
    out = dict(losses_cpu=lc, losses_card=lg,
               loss_rel=max(abs(a - b) / abs(b) for a, b in zip(lg, lc)), loss_tolerance=VAE_REL,
               grad_worst_leaf=worst, params_after_2_steps_rel_l2=diff / norm,
               params_after_2_steps_max_abs_diff=max(float((pg[k] - pc[k]).abs().max())
                                                     for k in pc),
               entries_apart=int(sum(int(m.sum()) for m in apart)),
               entries_apart_max_abs_step1_grad=max(
                   [float(gr[m].abs().max()) for gr, m in zip(gc, apart) if m.any()] or [0.0]),
               card=card)
    log("vae 2 f32 steps card vs CPU: " + json.dumps(out))
    if not (out["loss_rel"] <= VAE_REL and worst["share_of_limit"] <= 1.0):
        raise AssertionError(f"VAE steps: card and CPU differ: {out}")
    return out


def phase_export_vae(set_counts_to_zero, counts, card: str, params: dict,
                     student_ckpt: str) -> dict:
    """Export and the VAE trainer (module docstring, phase 13)."""
    from toycrystals_torch import export as ex
    from toycrystals_torch.models.sde_score_model import sample_reverse_sde_euler_maruyama
    from toycrystals_torch.scripts import export_sde_score_model as export_cli
    from toycrystals_torch.serve import ScoreModelService

    ckpt64 = os.path.join(CLI_DIR, "64", "checkpoints", "sde_score_model_last.msgpack")
    os.makedirs(VAE_DIR, exist_ok=True)
    out: dict = {"card": card}
    launches: dict = {}

    # -- a. phase 10's checkpoint, reverse SDE at CFG 1.5: the served SDE-300
    svc = ScoreModelService.from_checkpoint(ckpt64, device=DEVICE, sampler="sde",
                                            steps=EXPORT_SDE_STEPS, guidance_scale=1.5,
                                            t_end=0.005, buckets=(EXPORT_BATCH,))
    # the service's draws (x_init, then one Philox call per step as the sampler
    # reads it) are the sampler's own, so a dispatch equals the sampler on a generator
    y_cat, y_cont = svc.conditions(np.arange(EXPORT_BATCH) % 4, np.linspace(0, 1, EXPORT_BATCH))
    with torch.inference_mode():
        direct = sample_reverse_sde_euler_maruyama(
            svc._apply_fn, svc.sde, torch.from_numpy(y_cat).to(DEVICE),
            torch.from_numpy(y_cont).to(DEVICE), (EXPORT_BATCH, CLI_SIZE, CLI_SIZE, 1),
            torch.Generator(device=DEVICE).manual_seed(3), n_steps=svc.steps,
            guidance_scale=1.5, t_end=0.005, n_types=4).cpu().numpy()
    if not np.array_equal(direct, svc.sample(y_cat, y_cont, seed=3)):
        raise AssertionError("the service's dispatch differs from the sampler on its generator")
    out["sde_64"] = rec = _export_round_trip("sde 64x64", svc, os.path.join(VAE_DIR, "sde.tcx"),
                                             set_counts_to_zero, counts)
    launches["export_sde_64"] = rec["launches"]
    if rec["launches"]["gn_silu"] != 10 * (EXPORT_SDE_STEPS + 1) or rec["launches"]["flash_attn"] \
            or rec["custom_ops"] != ["toycrystals.gn_silu.default"]:
        raise AssertionError(f"export sde 64x64: {rec}")
    del svc
    # the same service at SDE-2, traced and saved: the step loop is one scan,
    # so the graph does not grow with the steps
    svc = ScoreModelService.from_checkpoint(ckpt64, device=DEVICE, sampler="sde",
                                            steps=EXPORT_TRACE_STEPS, guidance_scale=1.5,
                                            t_end=0.005, buckets=(EXPORT_BATCH,))
    t0 = time.perf_counter()
    ep = ex.export_service(svc, EXPORT_BATCH)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex.save_exported(os.path.join(VAE_DIR, "sde2.tcx"), ep, ex.export_meta(svc, EXPORT_BATCH, ep))
    out["sde_64_trace"] = rec = dict(
        steps=EXPORT_TRACE_STEPS, graph_nodes=ex.graph_nodes(ep), export_seconds=export_s,
        save_seconds=time.perf_counter() - t0,
        bytes=os.path.getsize(os.path.join(VAE_DIR, "sde2.tcx")))
    log(f"export sde 64x64 at SDE-{EXPORT_TRACE_STEPS}, traced: " + json.dumps(rec))
    if rec["graph_nodes"] != out["sde_64"]["graph_nodes"]:
        raise AssertionError(f"SDE-{EXPORT_TRACE_STEPS} and SDE-{EXPORT_SDE_STEPS} graphs differ "
                             f"in nodes: {rec['graph_nodes']} and {out['sde_64']['graph_nodes']}")
    del svc, ep

    # -- b. phase 11's 4-step student (DDIM, guidance 0)
    svc = ScoreModelService.from_checkpoint(student_ckpt, device=DEVICE, buckets=(EXPORT_BATCH,))
    out["student"] = rec = _export_round_trip("student", svc,
                                              os.path.join(VAE_DIR, "student.tcx"),
                                              set_counts_to_zero, counts)
    launches["export_student"] = rec["launches"]
    if rec["launches"]["gn_silu"] != 10 * Q_TO_STEPS or rec["sampler"] != "ddim":
        raise AssertionError(f"export student: {rec}")
    del svc
    # the export CLI's --selftest on the same checkpoint (atol 1e-4 inside; bit-equal here)
    line = export_cli.export(["--ckpt", student_ckpt, "--out", os.path.join(VAE_DIR, "cli.tcx"),
                              "--batch", str(EXPORT_BATCH), "--selftest", "--seed", "5"])
    out["cli_selftest_max_abs_diff"] = line["selftest_max_abs_diff"]
    if line["selftest_max_abs_diff"] != 0.0:
        raise AssertionError(f"export CLI --selftest: {line}")

    # -- c. 256x256 (4,096 bottleneck tokens): the graph holds the flash op
    svc = ScoreModelService(HI_CFG, params["none"], device=DEVICE, sampler="dpm",
                            steps=EXPORT_HI_STEPS, buckets=(1,))
    out["dpm_256"] = rec = _export_round_trip("dpm 256x256", svc,
                                              os.path.join(VAE_DIR, "hi.tcx"),
                                              set_counts_to_zero, counts)
    launches["export_256"] = rec["launches"]
    evals = EXPORT_HI_STEPS + 1  # the solver's steps and the x0 projection
    if rec["launches"]["flash_attn"] != evals or rec["launches"]["gn_silu"] != 10 * evals \
            or "toycrystals.flash_sdpa_fwd.default" not in rec["custom_ops"]:
        raise AssertionError(f"export dpm 256x256: {rec}")
    del svc
    for f in ("sde.tcx", "sde2.tcx", "student.tcx", "hi.tcx", "cli.tcx"):
        os.remove(os.path.join(VAE_DIR, f))
    out.update(phase_vae(set_counts_to_zero, counts, card, launches))
    out["launches"] = launches
    return out


def phase_vae(set_counts_to_zero, counts, card: str, launches: dict) -> dict:
    """Phase 13's VAE: 2 f32 steps card vs CPU, then train_vae at full width
    (2 epochs, a --resume epoch) and its MoP grid scored. Adds the trainer's
    launches to `launches`."""
    from toycrystals_torch.scripts import eval_sde_score_model as eval_cli
    from toycrystals_torch.scripts import train_vae as vae_cli

    os.makedirs(VAE_DIR, exist_ok=True)
    out: dict = {"vae_card_vs_cpu": _vae_steps_card_vs_cpu(card)}
    argv = ["--procedural", "--n-samples", str(VAE_ITEMS), "--batch-size", str(VAE_BATCH),
            "--z-dim", str(VAE_Z), "--out-dir", VAE_DIR]
    shutil.rmtree(os.path.join(VAE_DIR, "checkpoints"), ignore_errors=True)
    steps = VAE_ITEMS // VAE_BATCH
    runs = {}
    for name, extra, epochs in (("vae_train", ["--epochs", "2"], 2),
                                ("vae_resume", ["--epochs", "3", "--resume"], 1)):
        set_counts_to_zero()  # the trainer's path starts here
        t0 = time.perf_counter()
        runs[name] = run = vae_cli.train(argv + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = c = counts()
        # one render per step, plus the recon batch and the MoP pool
        if c["rasterize"] != steps * epochs + 2 or c["gn_silu"] or c["flash_attn"] \
                or not all(math.isfinite(v) for v in run.hists["loss"]):
            raise AssertionError(f"{name}: launches {c}, hists {run.hists}")
        out[name] = dict(epochs=len(run.epoch_seconds), seconds=seconds,
                         epoch_seconds=run.epoch_seconds, img_per_s=run.images_per_second,
                         loss=run.hists["loss"], recon=run.hists["recon"], kl=run.hists["kl"],
                         launches=c)
        log(f"{name} ({card}): " + json.dumps(out[name]))
    r = runs["vae_resume"]
    if r.hists["loss"][:2] != runs["vae_train"].hists["loss"] \
            or r.state.opt_state.count != 3 * steps:
        raise AssertionError(f"--resume: {r.hists}, count {r.state.opt_state.count}")
    for key, (rows, cols) in (("recon", (4, 8)), ("samples_prior", (6, 6)),
                              ("samples_mop", (6, 6))):
        img = read_png_gray(r.figures[key])
        if img.shape != (rows * 66 + 2, cols * 66 + 2):
            raise AssertionError(f"{r.figures[key]}: shape {img.shape}")
    line = eval_cli.evaluate(["--grid", r.figures["samples_mop"],
                              "--fid-vae", os.path.join(ROOT, Q_EXTRACTOR)]).line
    out["mop_scores"] = {k: line[k] for k in Q_SCALARS}
    log(f"vae_samples_mop.png ({card}): " + json.dumps(out["mop_scores"]))
    if not all(math.isfinite(v) for v in out["mop_scores"].values()):
        raise AssertionError(f"MoP scores: {out['mop_scores']}")
    return out


# Phase 14, the latent prior (dense and MoE), its route stats and the rest of the
# data path, at full width: build_dataset and preview_data, --stream against the
# resident per-batch path, --profile-dir; the frozen VAE is phase 13's.
DATA_DIR = os.path.join(ROOT, "runs", "chip_smoke_data")
PRIOR_DIR = os.path.join(ROOT, "runs", "chip_smoke_prior")
DATA_ITEMS, DATA_BUILD_BATCH = 12800, 2048   # build_dataset: 50,000 items cut to 12,800
STREAM_BATCH = 128
# --stream against the resident path: 2 epochs (the reshuffle and the stream's second
# pass) on the first PROFILE_ITEMS items, cut from 2 epochs on all 12,800 for card time
STREAM_EPOCHS = 2
STREAM_ARGS = ["--epochs", str(STREAM_EPOCHS), "--dtype", "bfloat16", "--base-ch", "96",
               "--stem", "none", "--sample-every", "0", "--ckpt-every", "0"]
PROFILE_ITEMS = 1280               # the stream's and --profile-dir's archive: 10 steps/epoch
# the README's recipe for the prior (README.md, Quickstart step 3) at DDIM-50
PRIOR_RECIPE = ["--T", "1000", "--beta-end", "0.05", "--width", "1024", "--batch-size", "256",
                "--lr", "1e-4", "--z-target", "mu", "--ddim-steps", "50", "--z-dim", str(VAE_Z)]
PRIOR_KW = dict(z_dim=VAE_Z, n_types=4, y_cont_dim=4, t_emb_dim=64, width=1024, n_blocks=8,
                y_cat_emb_dim=64)
PRIOR_REL = 1e-5        # prior steps card vs CPU: each loss, relative
PRIOR_CPU_BATCH = 64    # rows of the card-vs-CPU prior steps
DDIM_TOL = 1e-3         # DDIM-50 card vs CPU: share of the largest |z0|


def _trace_top_kernels(path: str, top: int = 5) -> list:
    """Device ms by kernel class (`kernel_category`) in a Chrome trace of
    torch.profiler, largest first."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_cat: dict[str, float] = {}
    for e in events:
        if e.get("cat") == "kernel":
            cat = kernel_category(e.get("name", ""))
            by_cat[cat] = by_cat.get(cat, 0.0) + float(e.get("dur", 0.0)) / 1e3
    if not by_cat:
        raise AssertionError(f"{path}: the trace holds no kernel event")
    return sorted(by_cat.items(), key=lambda kv: -kv[1])[:top]


def _phase14_data(set_counts_to_zero, counts, card: str, launches: dict) -> tuple[dict, str]:
    """a. build_dataset (npz and pt) read back against generate_batch on the
    card, and preview_data; returns the record and the npz archive's path."""
    from toycrystals_torch.data.datasets import generate_batch, load_archive
    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.scripts import build_dataset, preview_data

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    os.makedirs(DATA_DIR)
    out: dict = {}
    paths = {fmt: os.path.join(DATA_DIR, f"train.{fmt}") for fmt in ("npz", "pt")}
    builds = -(-DATA_ITEMS // DATA_BUILD_BATCH)
    for fmt, path in paths.items():
        set_counts_to_zero()  # the build's path starts here
        rec = build_dataset.build(["--n-samples", str(DATA_ITEMS), "--out", path])
        torch.cuda.synchronize()
        launches[f"build_dataset_{fmt}"] = c = counts()
        if c["rasterize"] != builds or c["gn_silu"] or c["flash_attn"]:
            raise AssertionError(f"build_dataset {fmt}: launches {c}, want {builds} rasterize")
        out[f"build_{fmt}"] = dict(seconds=rec["seconds"], items_per_s=rec["items_per_s"],
                                   bytes=os.path.getsize(path), launches=c)
        log(f"phase 14 build_dataset {fmt} ({card}): " + json.dumps(out[f"build_{fmt}"]))
    x, y_cat, y_cont = generate_batch(LatticeConfig(img_size=64, n_types=4, rot_only=True), 0,
                                      torch.arange(DATA_ITEMS, device=DEVICE), device=DEVICE)
    want = (torch.clip(x * 255.0, 0, 255).to(torch.uint8).cpu().numpy(), y_cat.cpu().numpy(),
            y_cont.cpu().numpy())
    del x
    for fmt, path in paths.items():
        got = load_archive(path)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{path} differs from generate_batch quantised on the card")
    np.savez(os.path.join(DATA_DIR, "small.npz"), x_u8=want[0][:PROFILE_ITEMS],
             y_cat=want[1][:PROFILE_ITEMS], y_cont=want[2][:PROFILE_ITEMS])
    set_counts_to_zero()
    png, images = preview_data.preview(["--out", os.path.join(DATA_DIR, "preview.png")])
    torch.cuda.synchronize()
    launches["preview_data"] = c = counts()
    img = read_png_gray(png)
    if c["rasterize"] != 1 or img.shape != (6 * 66 + 2,) * 2 or not np.isfinite(images).all():
        raise AssertionError(f"preview_data: launches {c}, PNG {img.shape}")
    out["archive_items"] = DATA_ITEMS
    return out, paths["npz"]


def _phase14_stream(set_counts_to_zero, counts, card: str, launches: dict) -> dict:
    """b. The SDE trainer on the first PROFILE_ITEMS items of the archive,
    STREAM_EPOCHS epochs streamed (--stream 2) and resident (--fused-epoch 0)
    under torch's deterministic algorithms (bilinear upsample's backward and
    cuDNN's are atomic otherwise): equal losses and parameters bit for bit,
    10 + 10 gn_silu launches per step; then a one-epoch --profile-dir run."""
    from toycrystals_torch.scripts import train_sde_score_model as train_cli

    small = os.path.join(DATA_DIR, "small.npz")
    steps = STREAM_EPOCHS * (PROFILE_ITEMS // STREAM_BATCH)
    argv = [*STREAM_ARGS, "--batch-size", str(STREAM_BATCH)]
    runs, out = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, extra in (("train_resident", ["--fused-epoch", "0"]),
                            ("train_stream", ["--stream", "2"])):
            set_counts_to_zero()  # the trainer's path starts here
            t0 = time.perf_counter()
            runs[name] = run = train_cli.train(["--data-path", small, *argv, *extra,
                                                "--out-dir", os.path.join(DATA_DIR, name)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[name] = c = counts()
            if c["gn_silu"] != 10 * steps or c["gn_silu_backward"] != 10 * steps \
                    or c["rasterize"] or c["flash_attn"]:
                raise AssertionError(f"{name}: launches {c} for {steps} steps")
            out[name] = dict(seconds=seconds, loss=run.loss_hist,
                             steps_per_s=[PROFILE_ITEMS // STREAM_BATCH / s
                                          for s in run.epoch_seconds],
                             launches=c)
            log(f"phase 14 {name} ({card}, deterministic algorithms): " + json.dumps(out[name]))
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = runs["train_resident"], runs["train_stream"]
    if a.loss_hist != b.loss_hist or not all(torch.equal(v, b.state.params[k])
                                             for k, v in a.state.params.items()):
        raise AssertionError(f"--stream differs from the resident path: {a.loss_hist} against "
                             f"{b.loss_hist}")
    set_counts_to_zero()
    run = train_cli.train(["--data-path", small, *argv, "--epochs", "1",
                           "--stream", "2", "--profile-dir", os.path.join(DATA_DIR, "trace"),
                           "--out-dir", os.path.join(DATA_DIR, "train_profile")])
    launches["train_profile"] = counts()
    out["profile"] = dict(trace=os.path.relpath(run.trace_path, ROOT),
                          bytes=os.path.getsize(run.trace_path),
                          top_kernel_classes_ms=_trace_top_kernels(run.trace_path),
                          steps=PROFILE_ITEMS // STREAM_BATCH)
    log(f"phase 14 --profile-dir ({card}): " + json.dumps(out["profile"]))
    return out


def _prior_card_vs_cpu(card: str, trained: dict) -> dict:
    """e. 2 f32 prior steps on injected (t, eps), dense and MoE-4, at full
    width (README schedule, TF32 off): each loss within PRIOR_REL relative,
    step-1 gradients leaf by leaf within LEAF_GRAD_TOL (as phase 7); then
    DDIM-50 on an injected z with the `trained` dense prior's state_dict,
    within DDIM_TOL of the largest |z0|."""
    from toycrystals_torch.models.diffusion_prior import (
        DiffusionPriorFiLM,
        DiffusionSchedule,
        ddim_sample,
    )
    from toycrystals_torch.models.moe_prior import DiffusionPriorMoE
    from toycrystals_torch.models.sde_score_model import sample_grid_conditions
    from toycrystals_torch.models.torch_init import flax_default_init
    from toycrystals_torch.train.state import Optimizer, create_train_state
    from toycrystals_torch.train.steps import make_prior_train_step, prior_loss_and_grads

    sched = DiffusionSchedule.linear(1000, 1e-4, 0.05)  # the CPU's arrays on both sides
    rng = np.random.default_rng(31)
    b, t_max = PRIOR_CPU_BATCH, 1000
    z0n = torch.from_numpy(rng.normal(size=(b, VAE_Z)).astype(np.float32))
    y_cat = torch.from_numpy(rng.integers(0, 4, b).astype(np.int32))
    y_cont = torch.from_numpy(rng.uniform(0, 1, (b, 4)).astype(np.float32))
    noise = [(torch.from_numpy(np.clip((rng.uniform(size=b) ** 2 * t_max).astype(np.int32), 0,
                                       t_max - 1)),
              torch.from_numpy(rng.normal(size=(b, VAE_Z)).astype(np.float32))) for _ in range(2)]
    out: dict = {"card": card}
    for kind, cls, kw, aux in (("dense", DiffusionPriorFiLM, {}, 0.0),
                               ("moe4", DiffusionPriorMoE, {"n_experts": 4}, 0.01)):
        runs = {}
        for dev in ("cpu", DEVICE):
            model = flax_default_init(cls(**PRIOR_KW, **kw), np.random.default_rng(32)).to(dev)
            s = DiffusionSchedule.from_arrays(sched.betas, sched.alpha_bars, dev)
            args = [a.to(dev) for a in (z0n, y_cat, y_cont)]
            _, grads = prior_loss_and_grads(model, s, *args, *(a.to(dev) for a in noise[0]),
                                            aux_weight=aux)
            tx = Optimizer(1e-4)
            state, step = create_train_state(model, tx), make_prior_train_step(model, tx,
                                                                               t_max, aux)
            losses = [float(step(state, s, *args, noise=(t.to(dev), e.to(dev)))[1]["loss"])
                      for t, e in noise]
            runs[dev] = (losses, [g.cpu() for g in grads], [k for k, _ in model.named_parameters()])
            del model, state, grads
        (lc, gc, names), (lg, gg, _) = runs["cpu"], runs[DEVICE]
        leaves = [dict(leaf=k, max_abs_diff=float((a - c).abs().max()),
                       share_of_limit=float((a - c).abs().max())
                       / (LEAF_GRAD_TOL[0] * float(c.abs().max()) + LEAF_GRAD_TOL[1]))
                  for k, a, c in zip(names, gg, gc)]
        worst = max(leaves, key=lambda r: r["share_of_limit"])
        rel = max(abs(a - c) / abs(c) for a, c in zip(lg, lc))
        out[kind] = dict(losses_cpu=lc, losses_card=lg, loss_rel=rel, grad_worst_leaf=worst,
                         leaves=len(leaves))
        log(f"phase 14 prior {kind} 2 f32 steps card vs CPU: " + json.dumps(out[kind]))
        if not (rel <= PRIOR_REL and worst["share_of_limit"] <= 1.0):
            raise AssertionError(f"prior {kind} steps: card and CPU differ: {out[kind]}")
    yg_cat, yg_cont = sample_grid_conditions(36, 4, 4)
    z = torch.from_numpy(rng.normal(size=(36, VAE_Z)).astype(np.float32))
    zs = {}
    for dev in ("cpu", DEVICE):
        model = DiffusionPriorFiLM(**PRIOR_KW)
        model.load_state_dict(trained)
        model.to(dev)
        s = DiffusionSchedule.from_arrays(sched.betas, sched.alpha_bars, dev)
        zs[dev] = ddim_sample(model, s, yg_cat.to(dev), yg_cont.to(dev), 50, VAE_Z,
                              z=z.to(dev)).cpu()
    diff, scale = float((zs[DEVICE] - zs["cpu"]).abs().max()), float(zs["cpu"].abs().max())
    out["ddim50"] = dict(max_abs_diff=diff, max_abs=scale, tolerance=DDIM_TOL * scale)
    log("phase 14 prior DDIM-50 card vs CPU: " + json.dumps(out["ddim50"]))
    if not (np.isfinite(zs[DEVICE].numpy()).all() and diff <= DDIM_TOL * scale):
        raise AssertionError(f"DDIM-50 card vs CPU: {out['ddim50']}")
    return out


def _phase14_prior(set_counts_to_zero, counts, card: str, launches: dict, archive: str,
                   mop_scores: dict) -> tuple[dict, dict]:
    """c, d, f. The dense prior at the README recipe on phase 13's VAE (2
    epochs, --resume 1, --sample-only), its grid scored beside phase 13's
    MoP grid; MoE-4 for 2 epochs and its route stats; a procedural cache
    build; no kernel of the port on the prior's path. Returns the record and
    the trained dense prior's state_dict (on the host)."""
    from toycrystals_torch.scripts import eval_sde_score_model as eval_cli
    from toycrystals_torch.scripts import moe_route_stats
    from toycrystals_torch.scripts import train_diffusion_prior as prior_cli

    vae_ckpt = os.path.join(VAE_DIR, "checkpoints", "vae_last.msgpack")
    base = ["--data-path", archive, "--vae-ckpt", vae_ckpt, *PRIOR_RECIPE, "--out-dir", PRIOR_DIR]
    shutil.rmtree(PRIOR_DIR, ignore_errors=True)
    out: dict = {}
    runs = {}
    steps = DATA_ITEMS // 256
    for name, extra in (("prior_train", ["--epochs", "2", "--rebuild-latents"]),
                        ("prior_resume", ["--epochs", "1", "--resume"]),
                        ("prior_sample", ["--sample-only"]),
                        ("prior_moe4", ["--epochs", "1", "--moe-experts", "4", "--sample-every",
                                        "0", "--ckpt-every", "0", "--prior-ckpt",
                                        "checkpoints/moe4.msgpack"]),
                        ("prior_cache_procedural", ["--procedural", "--max-items",
                                                    str(DATA_ITEMS), "--rebuild-latents",
                                                    "--epochs", "0", "--latent-cache",
                                                    "data/procedural.npz"])):
        set_counts_to_zero()  # the prior's path starts here
        t0 = time.perf_counter()
        runs[name] = run = prior_cli.train(base + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = c = counts()
        want_raster = -(-DATA_ITEMS // 512) if name == "prior_cache_procedural" else 0
        if c["gn_silu"] or c["gn_silu_backward"] or c["flash_attn"] \
                or c["rasterize"] != want_raster or not all(map(math.isfinite, run.loss_hist)):
            raise AssertionError(f"{name}: launches {c}, losses {run.loss_hist}")
        out[name] = dict(seconds=seconds, loss=run.loss_hist, buckets=run.bucket_hist,
                         z_per_s=run.z_per_second, epoch_seconds=run.epoch_seconds,
                         cache_seconds=run.cache_seconds, ddim50_36_seconds=run.sample_seconds,
                         launches=c)
        log(f"phase 14 {name} ({card}): " + json.dumps(out[name]))
    if runs["prior_train"].state.opt_state.count != 2 * steps \
            or runs["prior_resume"].state.opt_state.count != steps:
        raise AssertionError("prior: steps per epoch")
    sampled, resumed = runs["prior_sample"].model.state_dict(), runs["prior_resume"].model
    if not all(torch.equal(sampled[k], v) for k, v in resumed.state_dict().items()):
        raise AssertionError("--sample-only did not load the resumed checkpoint")
    figure = runs["prior_sample"].figure
    if read_png_gray(figure).shape != (6 * 66 + 2,) * 2:
        raise AssertionError(f"{figure}: not a 6x6 grid")
    line = eval_cli.evaluate(["--grid", figure, "--fid-vae", os.path.join(ROOT, Q_EXTRACTOR)]).line
    out["prior_scores"] = {k: line[k] for k in Q_SCALARS}
    out["mop_scores_phase13"] = mop_scores
    log(f"phase 14 prior DDIM-50 grid after 3 epochs ({card}): " + json.dumps(out["prior_scores"])
        + " beside phase 13's MoP grid " + json.dumps(mop_scores))
    if not all(math.isfinite(v) for v in out["prior_scores"].values()):
        raise AssertionError(f"prior grid scores: {out['prior_scores']}")
    set_counts_to_zero()
    stats = moe_route_stats.route_stats(["--ckpt", os.path.join(PRIOR_DIR, "checkpoints",
                                                                 "moe4.msgpack")])
    launches["moe_route_stats"] = counts()
    blocks = stats["blocks"]
    if len(blocks) != 8 or any(abs(sum(b["fractions"]) - 1.0) > 1e-3 for b in blocks.values()):
        raise AssertionError(f"route stats: {stats}")
    out["moe_routes"] = dict(conditions=stats["conditions"],
                             entropy_norm=[b["entropy_norm"] for b in blocks.values()],
                             max_share=[b["max_share"] for b in blocks.values()])
    log(f"phase 14 moe_route_stats ({card}): " + json.dumps(out["moe_routes"]))
    return out, {k: v.cpu() for k, v in sampled.items()}


def phase_prior_data(set_counts_to_zero, counts, card: str, mop_scores: dict) -> dict:
    """The latent prior and the rest of the data path (module docstring, phase 14)."""
    launches: dict = {}
    out, archive = _phase14_data(set_counts_to_zero, counts, card, launches)
    out["stream"] = _phase14_stream(set_counts_to_zero, counts, card, launches)
    prior, trained = _phase14_prior(set_counts_to_zero, counts, card, launches, archive,
                                    mop_scores)
    out.update(prior)
    out["prior_card_vs_cpu"] = _prior_card_vs_cpu(card, trained)
    out["launches"] = launches
    return out


def _par_world1(set_counts_to_zero, counts) -> dict:
    """World 1, in this process: the SDE epoch with no mesh, under DDP and
    under FSDP2 on a 1-rank mesh (NCCL on the card), from one initial state."""
    import torch.distributed as dist

    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.parallel import make_mesh, place_state
    from toycrystals_torch.parallel.fsdp import full
    from toycrystals_torch.train.steps import make_sde_train_epoch

    dev_type = torch.device(DEVICE).type
    if dev_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            init_method=f"file://{os.path.join(PAR_DIR, 'world1')}",
                            rank=0, world_size=1, timeout=timedelta(seconds=300))
    runs, launches = {}, {}
    n_items = PAR_STEPS * PAR_BATCH
    try:
        mesh = make_mesh(1, dev_type)
        torch.use_deterministic_algorithms(True, warn_only=True)
        for name in ("no_mesh", "ddp", "fsdp"):
            model, tx, sde, state = train_pieces("none", "float32", DEVICE)
            module, state = ((model, state) if name == "no_mesh" else
                             place_state(mesh, model, state, fsdp=name == "fsdp"))
            epoch = make_sde_train_epoch(
                module, tx, sde, batch_size=PAR_BATCH, n_items=n_items,
                lattice_cfg=LatticeConfig(img_size=64, rot_only=True), dataset_seed=0,
                fresh_data=True, mesh=None if name == "no_mesh" else mesh, **TRAIN_KW)
            gen = torch.Generator(device=DEVICE).manual_seed(0)
            losses, seconds = [], []
            set_counts_to_zero()  # the path of this run starts here
            for e in range(PAR_EPOCHS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = epoch(state, gen, e * n_items)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                losses.append(float(loss))
            launches[f"data_w1_{name}"] = got = counts()
            steps = PAR_STEPS * PAR_EPOCHS
            want = {"gn_silu": 10 * steps, "gn_silu_backward": 10 * steps,
                    "rasterize": steps, "flash_attn": 0, "flash_attn_backward": 0}
            if got != want:
                raise AssertionError(f"world 1 {name}: launches {got}, expected {want}")
            runs[name] = {"losses": losses, "step_ms": seconds[-1] / PAR_STEPS * 1e3,
                          "params": {k: full(v).detach().clone()
                                     for k, v in state.params.items()}}
            del model, module, state, epoch
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    ref = runs["no_mesh"]
    out = {"step_ms": {k: r["step_ms"] for k, r in runs.items()}, "launches": launches,
           "losses": {k: r["losses"] for k, r in runs.items()}}
    for name in ("ddp", "fsdp"):
        r = runs[name]
        equal = r["losses"] == ref["losses"] and all(
            torch.equal(r["params"][k], ref["params"][k]) for k in ref["params"])
        loss_diff = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref["losses"]))
        param_diff = max(float((r["params"][k] - ref["params"][k]).abs().max())
                         for k in ref["params"])
        out[name] = {"bit_equal": equal, "loss_rel_diff": loss_diff,
                     "param_max_abs_diff": param_diff}
        log(f"parallel world 1 {name}: bit-equal to no mesh {equal} (losses {loss_diff:.3e} "
            f"relative, parameters {param_diff:.3e}); step {r['step_ms']:.2f} ms against "
            f"{ref['step_ms']:.2f} ms with no mesh")
    if not out["ddp"]["bit_equal"]:
        raise AssertionError(f"world 1 DDP differs from the no-mesh run: {out['ddp']}")
    if not (out["fsdp"]["loss_rel_diff"] <= 1e-5 and out["fsdp"]["param_max_abs_diff"] <= 1e-5):
        raise AssertionError(f"world 1 FSDP2 differs from the no-mesh run: {out['fsdp']}")
    return out


def _par_spec() -> dict:
    """The world-2 cases at full width: global batches and injected draws."""
    from toycrystals_torch.data.datasets import generate_batch
    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.models.torch_init import flax_default_init

    kw = {k: SLICE_CFG[k] for k in ("n_types", "y_cont_dim", "base_ch", "emb_dim", "cond_ch",
                                    "time_ch")}
    model = flax_default_init(make_model("none", "float32"), np.random.default_rng(5))
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    r = np.random.default_rng(6)
    b, st = PAR_BATCH, PAR_W2_STEPS
    x0 = np.stack([generate_batch(LatticeConfig(img_size=64, rot_only=True), 0,
                                  np.arange(i * b, (i + 1) * b), device="cpu")[0].numpy()
                   for i in range(st)])
    sde = dict(kind="sde", model=kw, state_dict=sd, opt={"lr": TRAIN_LR, "ema": 0.999},
               x0=x0, y_cat=r.integers(0, 5, (st, b)).astype(np.int32),
               y_cont=r.normal(size=(st, b, 4)).astype(np.float32),
               t=r.uniform(0.02, 1.0, (st, b)).astype(np.float32),
               eps=r.normal(size=x0.shape).astype(np.float32))
    n, steps = PAR_SAMPLE["n"], PAR_SAMPLE["n_steps"]
    sample = dict(kind="sample", model=kw, state_dict=sd, shape=(n, 64, 64, 1), seed=7,
                  chunk=PAR_SAMPLE["chunk"], n_steps=steps, cfg=PAR_SAMPLE["cfg"],
                  y_cat=(np.arange(n) % 4).astype(np.int32),
                  y_cont=r.normal(size=(n, 4)).astype(np.float32),
                  x_init=r.normal(size=(n, 64, 64, 1)).astype(np.float32),
                  z=r.normal(size=(n, steps, 64, 64, 1)).astype(np.float32))
    dcp = dict(kind="dcp_save", model=kw, state_dict=sd, fsdp=True, seed=8,
               path=os.path.join(PAR_DIR, "dcp"))
    return {"device": torch.device(DEVICE).type, "tf32": False,
            "cases": [sde, dict(sde, fsdp=True), dcp, sample]}


def _leafwise(got: dict, want: dict, what: str) -> float:
    """Leaf by leaf as phase 7 (LEAF_GRAD_TOL), plus 1e-6 of the largest entry
    of the whole tree for leaves whose values are at rounding-noise level;
    returns the largest share of its limit a leaf used."""
    top = max(float(np.abs(v).max()) for v in want.values())
    worst = 0.0
    for k, w in want.items():
        lim = LEAF_GRAD_TOL[0] * float(np.abs(w).max()) + LEAF_GRAD_TOL[1] + 1e-6 * top
        d = float(np.abs(got[k] - w).max())
        worst = max(worst, d / lim)
        if d > lim:
            raise AssertionError(f"{what} {k}: max abs diff {d:.3e} > {lim:.3e}")
    return worst


def _par_world2() -> dict:
    """World 2: two processes on cuda:0 over gloo, against the same cases in
    this process with no mesh; the DCP directory reloaded here."""
    from toycrystals_torch.models.sde_score_model import CondUNetTiny
    from toycrystals_torch.parallel.multihost import launch
    from toycrystals_torch.parallel.parity import run_cases
    from toycrystals_torch.train.state import Optimizer, create_train_state
    from toycrystals_torch.utils.orbax_io import ShardedCheckpointManager

    spec = _par_spec()
    dev_type = spec["device"]
    # the two ranks share the card with this process: hand its cached blocks back
    gc.collect()
    torch.cuda.empty_cache()
    log(f"parallel world 2: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        f"of device memory before the ranks start")
    t0 = time.perf_counter()
    two = launch(run_cases, 2, (spec,), device_type=dev_type, backend="gloo",
                 device_ids=[0, 0], timeout=600)
    w2_seconds = time.perf_counter() - t0
    one = run_cases({**spec, "cases": [c for c in spec["cases"] if c["kind"] != "dcp_save"]})
    ref = {"sde": one[0], "sde_fsdp": one[1], "sample": one[2]}
    out = {"seconds": w2_seconds, "launches": {}}
    steps = PAR_W2_STEPS
    for i, name in ((0, "sde"), (1, "sde_fsdp")):
        r0, r1, want = two[0][i], two[1][i], ref[name]
        loss_diff = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want["losses"]))
        if not (r0["losses"] == r1["losses"] and loss_diff <= 1e-5):
            raise AssertionError(f"world 2 {name}: losses {r0['losses']} / {r1['losses']} "
                                 f"against {want['losses']}")
        g = _leafwise(r0["grads"], want["grads"], f"world 2 {name} step-1 gradient")
        m = _leafwise(r0["mu"], want["mu"], f"world 2 {name} first moment")
        p_diff = max(float(np.abs(r0["params"][k] - want["params"][k]).max())
                     for k in want["params"])
        if not p_diff <= 2 * TRAIN_LR * steps:
            raise AssertionError(f"world 2 {name}: parameters {p_diff:.3e} apart")
        for rank, res in enumerate((r0, r1)):
            out["launches"][f"data_w2_{name}_rank{rank}"] = res["launches"]
            wl = {"gn_silu": 10 * steps, "gn_silu_backward": 10 * steps, "gn_silu_sums": 0,
                  "gn_silu_apply": 0, "gn_silu_backward_sums": 0, "gn_silu_backward_apply": 0,
                  "rasterize": 0, "flash_attn": 0, "flash_attn_backward": 0}
            if res["launches"] != wl:
                raise AssertionError(f"world 2 {name} rank {rank}: launches "
                                     f"{res['launches']}, expected {wl}")
        out[name] = {"loss_rel_diff": loss_diff, "grad_worst_share": g, "mu_worst_share": m,
                     "param_max_abs_diff": p_diff,
                     "step_ms_rank0": r0["step_ms"], "step_ms_one_process": want["step_ms"],
                     "peak_bytes": [r0.get("peak_bytes", 0), r1.get("peak_bytes", 0)],
                     "peak_bytes_one_process": want.get("peak_bytes", 0)}
        log(f"parallel world 2 {name}: losses {loss_diff:.3e} relative to one process, "
            f"gradients {g:.3f} and moments {m:.3f} of their limits, parameters "
            f"{p_diff:.3e}; peak memory per rank "
            f"{out[name]['peak_bytes'][0] / 2**30:.2f} / "
            f"{out[name]['peak_bytes'][1] / 2**30:.2f} GiB (one process "
            f"{out[name]['peak_bytes_one_process'] / 2**30:.2f}); step "
            f"{r0['step_ms'][-1]:.1f} ms (rank 0, step {steps})")
    # DCP: the 2-rank FSDP2 state reloads in one process, bit for bit
    saved = two[0][2]
    case = spec["cases"][2]
    model = make_model("none", "float32").to(DEVICE)
    tx = Optimizer(1e-3)
    state = create_train_state(model, tx, ema=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ShardedCheckpointManager(case["path"]) as mgr:
        state, _ = mgr.restore_onto(state)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    names = list(state.params)
    loaded = {"params": state.params, "mu": dict(zip(names, state.opt_state.mu)),
              "nu": dict(zip(names, state.opt_state.nu)), "ema": state.ema_params}
    for part, tensors in loaded.items():
        for k, v in tensors.items():
            if not np.array_equal(v.detach().cpu().numpy(), saved[part][k]):
                raise AssertionError(f"DCP: {part}.{k} did not reload bit for bit")
    if (state.step, state.opt_state.count) != (saved["step"], saved["count"]):
        raise AssertionError("DCP: the counters did not reload")
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(case["path"])
                 for f in files)
    out["dcp"] = {"save_ms": [two[0][2]["ms"], two[1][2]["ms"]], "load_ms": load_ms,
                  "bytes": nbytes}
    out["launches"]["dcp_save_rank0"] = two[0][2]["launches"]
    log(f"parallel DCP: FSDP2 state of 2 ranks saved in {two[0][2]['ms']:.1f} / "
        f"{two[1][2]['ms']:.1f} ms, {nbytes} bytes, reloaded in one process bit for bit in "
        f"{load_ms:.1f} ms")
    # sample_chunked on the 2-rank mesh against the one-process chunks
    for key in ("injected", "drawn"):
        d = float(np.abs(two[0][3][key] - ref["sample"][key]).max())
        if not (np.array_equal(two[0][3][key], two[1][3][key]) and d <= PAR_SAMPLE_TOL):
            raise AssertionError(f"world 2 sample_chunked ({key}): {d:.3e} from one process")
        out[f"sample_{key}_max_abs_diff"] = d
    for rank in (0, 1):
        got = two[rank][3]["launches"]
        out["launches"][f"data_w2_sample_rank{rank}"] = got
        if got != ref["sample"]["launches"] or got["gn_silu"] == 0:
            raise AssertionError(f"world 2 sample rank {rank}: launches {got}, one process "
                                 f"{ref['sample']['launches']}")
    log(f"parallel world 2 sample_chunked: {out['sample_injected_max_abs_diff']:.3e} "
        f"(injected) and {out['sample_drawn_max_abs_diff']:.3e} (drawn) from one process; "
        f"{two[0][3]['launches']['gn_silu']} gn_silu launches per rank; the world-2 job took "
        f"{w2_seconds:.1f} s")
    return out


def phase_parallel(set_counts_to_zero, counts, card: str) -> dict:
    """Phase 15: the data axis (module docstring)."""
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    os.makedirs(PAR_DIR)
    t0 = time.perf_counter()
    out = {"world1": _par_world1(set_counts_to_zero, counts), "world2": _par_world2()}
    out["launches"] = {**out["world1"]["launches"], **out["world2"]["launches"]}
    out["seconds"] = time.perf_counter() - t0
    log(f"parallel on {card}: world 1 step ms {json.dumps(out['world1']['step_ms'])}")
    return out


# Phase 16: the space axis and serving on a mesh, on one card: two ranks share
# cuda:0 over gloo, so nothing here times NCCL or a collective across cards
SPACE_DIR = os.path.join(ROOT, "runs", "chip_smoke_space")
SPACE_HI_STEPS = 10          # SDE steps of the 256x256 request (cut from 300, then 20)
SPACE_HI_IMAGES = 12         # one 12-image dispatch, 24 rows under CFG
SPACE_64_STEPS, SPACE_64_IMAGES = 10, 8
SPACE_F4 = dict(n=8, n_steps=10, cfg=1.5)  # int8 sample_chunked, bf16, chunk 8
SPACE_SERVE_STEPS, SPACE_SERVE_REQUESTS = 4, 8  # requests cut from 16 for time
# against one process: phase 15's tolerance (each rank's calls have other shapes,
# and cuDNN picks its f32 algorithms by shape)
SPACE_TOL = PAR_SAMPLE_TOL
# the sharded shapes of the 256x256 path at S = 2 (24 rows: 12 images under CFG)
SPACE_GN_SHAPES = [("256 down1/up1", (24, 96, 128, 256)), ("256 down2", (24, 192, 64, 128)),
                   ("256 up2", (24, 96, 64, 128)), ("256 mid", (24, 192, 32, 64))]
# (label, q [B, Nq, heads, d], Nk): a rank's queries against the gathered keys
SPACE_FLASH_SHAPES = [("S=2", (24, 2048, 4, 48), 4096), ("S=4", (24, 1024, 4, 48), 4096)]


def _space_kernel_ms() -> dict:
    """Each SPACE_GN_SHAPES case's sums and apply kernel device ms, from
    torch.profiler in a process of its own (`bench_gn --space`, the same
    shapes): in this process, after the earlier phases, the profiler recorded
    no device time for them."""
    proc = subprocess.run([sys.executable, "-m", "toycrystals_torch.bench_gn", "--space",
                           "--iters", "10"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"bench_gn --space failed:\n{proc.stdout}\n{proc.stderr}")
    rows = json.loads(proc.stdout.strip().splitlines()[-1])["rows"]
    return {(r["shape"], r["dtype"], r["pad"]): (r["sums_kernel_ms"], r["apply_kernel_ms"])
            for r in rows}


def _space_gn_rows(gn, profile: bool = False) -> tuple[list[dict], dict]:
    """The sums and apply kernels at the 256x256 path's sharded shapes, one
    rank's rows against their plain versions, the all-reduce done here (the
    other rank's sums added); timed against the plain versions, each call by
    CUDA events and, with `profile` (--profile), each kernel's device time by
    torch.profiler in a `bench_gn --space` process."""
    kernel_ms = _space_kernel_ms() if profile else None
    rows, headline = [], {}
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    for label, shape in SPACE_GN_SHAPES:
        b, c, h, w = shape
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            x, other = ((torch.randn(shape, generator=gen, device=DEVICE) * 2 + 0.5).to(dtype)
                        for _ in range(2))
            scale = torch.randn(c, generator=gen, device=DEVICE) * 0.1 + 1.0
            bias = torch.randn(c, generator=gen, device=DEVICE) * 0.1
            sums = gn.gn_sums(x, 8) + gn.gn_sums(other, 8)
            want_sums = gn.gn_sums_reference(x, 8) + gn.gn_sums_reference(other, 8)
            count = c // 8 * h * w * 2
            sums_err = float(((sums - want_sums).abs() / want_sums.abs().clamp(min=1.0)).max())
            for pad in (False, True):
                got = gn.gn_silu_apply(x, sums, count, scale, bias, 8, pad=pad)
                want = gn.gn_silu_apply_reference(x, sums, count, scale, bias, 8, pad=pad)
                err = float((got.float() - want.float()).abs().max())
                atol, rtol = TOL[name]
                torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
                row = dict(shape=label, dims=list(shape), dtype=name, pad=pad,
                           sums_max_rel_err=sums_err, max_abs_err=err)
                if not sums_err <= 1e-5:
                    raise AssertionError(f"gn sums kernel at {label} {name}: {sums_err}")
                elem = x.element_size()
                row["sums_ms"] = cuda_time_ms(lambda: gn.gn_sums(x, 8))
                row["sums_plain_ms"] = cuda_time_ms(lambda: gn.gn_sums_reference(x, 8), iters=5)
                row["sums_bound_ms"] = (b * c * h * w * elem + b * 8 * 8) / HBM_BYTES_PER_S * 1e3
                row["apply_ms"] = cuda_time_ms(
                    lambda: gn.gn_silu_apply(x, sums, count, scale, bias, 8, pad=pad))
                row["apply_plain_ms"] = cuda_time_ms(
                    lambda: gn.gn_silu_apply_reference(x, sums, count, scale, bias, 8, pad=pad),
                    iters=5)
                row["apply_bound_ms"], row["apply_bound_by"] = gn_bound(shape, pad, elem)
                if kernel_ms is not None:
                    row["sums_kernel_ms"], row["apply_kernel_ms"] = kernel_ms[(label, name, pad)]
                    if not (row["sums_kernel_ms"] > 0.0 and row["apply_kernel_ms"] > 0.0):
                        raise AssertionError(f"gn space kernels at {label} {name}: "
                                             f"torch.profiler saw no device time")
                # the one-launch kernel on the whole image's rows, for scale
                whole = torch.cat([x, other], dim=2)
                row["one_launch_whole_image_ms"] = cuda_time_ms(
                    lambda: gn.gn_silu(whole, scale, bias, 8, pad=pad))
                rows.append(row)
                log("kernel gn_silu space modes " + json.dumps(row))
                if label == "256 down1/up1" and name == "bfloat16" and pad:
                    headline = row
            del x, other, whole
    torch.cuda.empty_cache()
    return rows, headline


def _space_flash_rows(at) -> tuple[list[dict], dict]:
    """The flash forward of a rank's Nq queries against Nk gathered keys,
    against `sdpa_reference` in f32 (8 items at a time), timed beside
    F.scaled_dot_product_attention at the same shapes."""
    rows, headline = [], {}
    clock_hz = sm_clock_max_hz()
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    for label, shape, nk in SPACE_FLASH_SHAPES:
        b, n, h, d = shape
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            q = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
            kv = torch.randn((b, nk, 2, h, d), generator=gen, device=DEVICE).to(dtype)
            k, v = kv[:, :, 0], kv[:, :, 1]
            before = at.flash_sdpa.launches
            with torch.no_grad():
                out = at.flash_sdpa(q, k, v)
            torch.cuda.synchronize()
            if at.flash_sdpa.launches != before + 1:
                raise AssertionError(f"flash_sdpa did not launch at {label} {name}")
            err = big = 0.0
            for i0 in range(0, b, 8):
                sl = slice(i0, i0 + 8)
                want = at.sdpa_reference(q[sl].float(), k[sl].float(), v[sl].float())
                err = max(err, float((out[sl].float() - want).abs().max()))
                big = max(big, float(want.abs().max()))
                del want
            row = dict(shape=label, dims=list(shape), nk=nk, dtype=name, max_abs_err=err,
                       max_abs=big, tol_share=FLASH_TOL[name])
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            with torch.no_grad():
                row["ms"] = cuda_time_ms(lambda: at.flash_sdpa(q, k, v), iters=10)
                row["plain_ms"] = cuda_time_ms(lambda: at.sdpa_reference(q, k, v), iters=3,
                                               warmup=1)
                row["library_ms"] = cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=10)
            row["bound_ms"], row["bound_by"], row["bound_operations"] = flash_bound(
                shape, q.element_size(), False, clock_hz, nk=nk)
            rows.append(row)
            log("kernel flash_attn Nq != Nk " + json.dumps(row))
            if not err <= FLASH_TOL[name] * big:
                raise AssertionError(f"flash forward at Nq {n} / Nk {nk} {name}: {row}")
            if label == "S=2" and dtype == torch.bfloat16:
                headline.update(row)
            elif label == "S=2":
                headline["f32"] = row
            del q, kv, k, v, out
    torch.cuda.empty_cache()
    return rows, headline


def _one_process_dispatch(svc, y_cat, y_cont, seed: int, rows: int) -> np.ndarray:
    """The one-process service's dispatch of a request padded to `rows`, the
    layout a mesh gives it (its bucket, rounded to the data axis)."""
    from toycrystals_torch.models.sde_score_model import sample_chunked

    n = len(y_cat)
    yc, yv = (np.concatenate([a, np.repeat(a[-1:], rows - n, axis=0)]) for a in (y_cat, y_cont))
    with torch.inference_mode():
        return sample_chunked(svc._dispatch, svc._apply_fn, svc.sde,
                              torch.from_numpy(yc).to(DEVICE), torch.from_numpy(yv).to(DEVICE),
                              (rows, svc.img_size, svc.img_size, 1), seed, chunk=rows)[:n]


def _space_cases(params: dict) -> dict:
    """The mesh cases: int8 sampling at world 2 (F4), and the services on the
    (data 1, space 2) mesh."""
    from toycrystals_torch.models.sde_score_model import sample_grid_conditions
    from toycrystals_torch.models.torch_init import flax_default_init

    kw = {k: SLICE_CFG[k] for k in ("n_types", "y_cont_dim", "base_ch", "emb_dim", "cond_ch",
                                    "time_ch")}
    f4 = []
    for stem in ("none", "s2dr"):
        model = flax_default_init(make_model(stem, "float32"), np.random.default_rng(12))
        sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
        n = SPACE_F4["n"]
        yc, yv = (a.numpy() for a in sample_grid_conditions(n, 4, 4))
        r = np.random.default_rng(13)
        f4.append(dict(kind="sample", record_scale=True, drawn=False,
                       model=dict(kw, stem=stem, conv_impl="int8", dtype=torch.bfloat16),
                       state_dict=sd, y_cat=yc, y_cont=yv, shape=(n, 64, 64, 1), seed=14,
                       chunk=n, n_steps=SPACE_F4["n_steps"], cfg=SPACE_F4["cfg"],
                       x_init=r.normal(size=(n, 64, 64, 1)).astype(np.float32),
                       z=r.normal(size=(n, SPACE_F4["n_steps"], 64, 64, 1)).astype(np.float32)))
    yc, yv = (a.numpy() for a in sample_grid_conditions(SPACE_HI_IMAGES, 4, 4))
    hi = dict(kind="service", config=dict(HI_CFG, dtype="float32"), params=params["none"],
              buckets=(SPACE_HI_IMAGES,), settings=dict(steps=SPACE_HI_STEPS),
              requests=[(yc, yv, 15)])
    hi_bf16 = dict(hi, config=HI_CFG)
    yc, yv = (a.numpy() for a in sample_grid_conditions(SPACE_64_IMAGES, 4, 4))
    small = [dict(kind="service", config=dict(SLICE_CFG, dtype="float32", stem=stem),
                  params=params[stem], buckets=(SPACE_64_IMAGES,),
                  settings=dict(steps=SPACE_64_STEPS), requests=[(yc, yv, 16)])
             for stem in ("none", "s2dr")]
    return {"f4": f4, "space": [hi, hi_bf16, *small]}


def _space_world1(svc_cls, params: dict) -> dict:
    """A (1, 1) mesh at world 1 in this process over NCCL: the service's
    result bit-equal to the same dispatch with no mesh."""
    import torch.distributed as dist

    from toycrystals_torch.parallel.mesh import make_mesh_2d

    dev_type = torch.device(DEVICE).type
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            init_method=f"file://{os.path.join(SPACE_DIR, 'world1')}",
                            rank=0, world_size=1, timeout=timedelta(seconds=300))
    try:
        cfg = dict(SLICE_CFG, dtype="float32")
        mesh = make_mesh_2d(1, 1, dev_type)
        svc = svc_cls(cfg, params["none"], device=DEVICE, steps=SPACE_64_STEPS, buckets=(4,),
                      mesh=mesh)
        y_cat, y_cont = svc.conditions([0, 1, 2], [0.1, 0.2, 0.3])
        got = svc.sample(y_cat, y_cont, seed=17)
    finally:
        dist.destroy_process_group()
    ref = svc_cls(cfg, params["none"], device=DEVICE, steps=SPACE_64_STEPS, buckets=(4,))
    want = _one_process_dispatch(ref, y_cat, y_cont, 17, 3)
    if not np.array_equal(got, want):
        raise AssertionError(f"(1, 1) mesh at world 1: {np.abs(got - want).max():.3e} from no "
                             f"mesh")
    log("space (1, 1) mesh at world 1 over NCCL: bit-equal to no mesh")
    return {"bit_equal": True}


def _space_serve_cli(card: str) -> dict:
    """The serve CLI with --shard 2 on one card over gloo (phase 10's
    checkpoint, f32): a burst of seeded one-image requests, each answer
    bit-equal to the same dispatch of a 2-rank mesh launched here beside the
    server with the CLI's settings (TF32 as torch leaves it), and beside the
    one-process service's dispatch of the same layout; then SIGTERM."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from toycrystals_torch.parallel.multihost import launch
    from toycrystals_torch.parallel.parity import run_cases
    from toycrystals_torch.serve import ScoreModelService
    from toycrystals_torch.utils.checkpoint import load_score_payload

    ckpt64 = os.path.join(CLI_DIR, "64", "checkpoints", "sde_score_model_last.msgpack")
    argv = [sys.executable, "-u", "-m", "toycrystals_torch.scripts.serve_sde_score_model",
            ckpt64, "--port", "0", "--steps", str(SPACE_SERVE_STEPS), "--dtype", "float32",
            "--buckets", "1,4", "--shard", "2", "--dist-backend", "gloo"]
    if DEVICE == "cpu":
        argv += ["--device", "cpu"]
    conds = [([i % 4], [0.05 * i], 200 + i) for i in range(SPACE_SERVE_REQUESTS)]
    # the same dispatches on a 2-rank mesh launched here, with the CLI's settings,
    # beside the server (their processes' start is most of their time)
    svc = ScoreModelService.from_checkpoint(ckpt64, device=DEVICE, steps=SPACE_SERVE_STEPS,
                                            dtype="float32", buckets=(2,))
    payload = load_score_payload(ckpt64)
    requests = [(*svc.conditions(types, thetas), seed) for types, thetas, seed in conds]
    case = dict(kind="service", config=payload["config"],
                params=payload["state"].get("ema_params") or payload["state"]["params"],
                buckets=(1, 4), settings=dict(steps=SPACE_SERVE_STEPS, dtype="float32"),
                requests=requests)
    dev_type = torch.device(DEVICE).type
    gc.collect()
    torch.cuda.empty_cache()
    pool = ThreadPoolExecutor(1)
    mesh_run = pool.submit(launch, run_cases, 2,
                           ({"device": dev_type, "tf32": None, "cases": [case]},),
                           device_type=dev_type, backend="gloo", device_ids=[0, 0], timeout=600)
    pool.shutdown(wait=False)
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    text, url = "", None
    try:
        while url is None and time.perf_counter() - t0 < 300:
            text += proc.stdout.readline()
            found = re.search(r"listening on (http://[0-9.]+:[0-9]+)", text)
            url = found and found.group(1)
            if proc.poll() is not None:
                raise AssertionError(f"the sharded server died:\n{text}{proc.stdout.read()}")
        if url is None:
            raise AssertionError(f"the sharded server never listened:\n{text}")
        ready_s = time.perf_counter() - t0
        got, lat = {}, {}

        def go(i):
            types, thetas, seed = conds[i]
            s0 = time.perf_counter()
            got[i] = _post(url + "/sample", {"types": types, "thetas": thetas, "seed": seed,
                                             "format": "npy"})
            lat[i] = time.perf_counter() - s0

        threads = [threading.Thread(target=go, args=(i,)) for i in range(SPACE_SERVE_REQUESTS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        burst_s = time.perf_counter() - t1
        stats = json.loads(_get(url + "/stats")[2])
        t2 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        stop_s = time.perf_counter() - t2
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or "serving stopped" not in out:
        raise AssertionError(f"the sharded server exited {proc.returncode}:\n{text}{out}")
    answers = []
    for i in range(SPACE_SERVE_REQUESTS):
        code, _, body = got[i]
        if code != 200:
            raise AssertionError(f"sharded server request {i}: {code}")
        answers.append(np.load(io.BytesIO(body)))
    two = mesh_run.result()
    for i, x in enumerate(answers):
        if not np.array_equal(x, two[0][0]["x"][i]):
            raise AssertionError(f"sharded server request {i}: "
                                 f"{float(np.abs(x - two[0][0]['x'][i]).max()):.3e} from the "
                                 f"mesh's own dispatch")
    # beside the one-process service (its convs' TF32 as the CLI's: torch's
    # default), and what TF32 alone moves in one process
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = [_one_process_dispatch(svc, yc, yv, seed, 2) for yc, yv, seed in requests]
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    gap = max(float(np.abs(x - w).max()) for x, w in zip(answers, tf32))
    tf32_alone = max(float(np.abs(w - _one_process_dispatch(svc, yc, yv, seed, 2)).max())
                     for w, (yc, yv, seed) in zip(tf32, requests))
    out_d = {"ready_s": ready_s, "burst_s": burst_s, "p50_s": float(np.median(list(lat.values()))),
             "max_s": max(lat.values()), "sigterm_exit_s": stop_s,
             "one_process_max_abs_diff": gap, "tf32_alone_max_abs_diff": tf32_alone,
             "dispatches": stats["service"]["dispatches"],
             "buckets": stats["service"]["buckets"], "mesh": stats["service"]["mesh"]}
    log(f"space serve CLI --shard 2 (two ranks on one card over gloo, {card}): ready in "
        f"{ready_s:.1f} s; {SPACE_SERVE_REQUESTS} seeded one-image requests in {burst_s:.2f} s "
        f"(p50 {out_d['p50_s']:.3f} s), each bit-equal to the 2-rank mesh's own dispatch, "
        f"{gap:.3e} from the one-process service (TF32 convs, half the rows per call; TF32 "
        f"on against off moves one process by {tf32_alone:.3e}); "
        f"SIGTERM: every rank exited 0 in {stop_s:.2f} s")
    if not stop_s <= 60.0:
        raise AssertionError(f"the sharded server took {stop_s:.1f} s to stop")
    return out_d


def phase_space(set_counts_to_zero, counts, card: str, params: dict,
                profile: bool = False) -> dict:
    """Phase 16: the space axis and serving on a mesh (module docstring)."""
    from toycrystals_torch.ops import attention as at
    from toycrystals_torch.ops import groupnorm as gn
    from toycrystals_torch.parallel.multihost import launch
    from toycrystals_torch.parallel.parity import run_cases
    from toycrystals_torch.serve import ScoreModelService

    shutil.rmtree(SPACE_DIR, ignore_errors=True)
    os.makedirs(SPACE_DIR)
    t0 = time.perf_counter()
    out: dict = {"card": card, "launches": {}}
    out["gn_rows"], out["gn_headline"] = _space_gn_rows(gn, profile)
    out["flash_rows"], out["flash_headline"] = _space_flash_rows(at)
    out["world1"] = _space_world1(ScoreModelService, params)
    cases = _space_cases(params)
    gc.collect()
    torch.cuda.empty_cache()
    dev_type = torch.device(DEVICE).type
    # (a) F4: int8 sample_chunked at world 2 against one process
    t1 = time.perf_counter()
    two = launch(run_cases, 2, ({"device": dev_type, "cases": cases["f4"]},),
                 device_type=dev_type, backend="gloo", device_ids=[0, 0], timeout=600)
    one = run_cases({"device": dev_type, "cases": cases["f4"]})
    out["f4"] = {}
    for i, stem in enumerate(("none", "s2dr")):
        # the first conv's input is the same bits on both sides: its scale must be
        # the one-process scale, the max over both ranks' rows
        (own0, s0), (own1, s1), (whole, s) = (r[i]["int8_scale"] for r in (two[0], two[1], one))
        if not (s0 == s1 == s and max(own0, own1) == whole):
            raise AssertionError(f"F4 int8 {stem}: first scales {s0} / {s1} against {s} in one "
                                 f"process (own maxima {own0} / {own1}, whole {whole})")
        rec = {"first_scale_equal": True, "rows_decide_the_max": min(own0, own1) < whole}
        for key in ("injected",):
            a, b = two[0][i][key], one[i][key]
            rec[f"{key}_max_abs_diff"] = float(np.abs(a - b).max())
            rec[f"{key}_mean_abs_diff"] = float(np.abs(a - b).mean())
            rec[f"{key}_bit_equal"] = bool(np.array_equal(a, b))
            if not (np.array_equal(a, two[1][i][key]) and np.isfinite(a).all()
                    and 0.0 <= a.min() and a.max() <= 1.0):
                raise AssertionError(f"F4 int8 {stem} ({key}): ranks disagree or out of range")
        out["f4"][stem] = rec
        out["launches"][f"space_int8_{stem}_rank0"] = two[0][i]["launches"]
    log(f"space F4: int8 sample_chunked at world 2 (bf16, SDE-{SPACE_F4['n_steps']}, "
        f"{SPACE_F4['n']} images) against one process; each rank's first int8 scale is the "
        f"one-process scale (the max over both ranks' rows); the grids, where every call "
        f"of the other ops has half the rows (algorithms and gn_silu's cluster plan by "
        f"shape) and int8 rounding amplifies their last bits: {json.dumps(out['f4'])}; "
        f"{time.perf_counter() - t1:.1f} s")
    # (c) the (data 1, space 2) mesh: the services at 256x256 and 64x64
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    two = launch(run_cases, 2, ({"device": dev_type, "mesh": [1, 2], "cases": cases["space"]},),
                 device_type=dev_type, backend="gloo", device_ids=[0, 0], timeout=900)
    out["space_job_s"] = time.perf_counter() - t1
    names = ("hi_f32", "hi_bf16", "none_64", "s2dr_64")
    for rank in (0, 1):
        for name, res in zip(names, two[rank]):
            out["launches"][f"space_{name}_rank{rank}"] = res["launches"]
    evals = SPACE_HI_STEPS + 1
    for rank in (0, 1):
        for name in ("hi_f32", "hi_bf16"):
            got = two[rank][names.index(name)]["launches"]
            want = {"gn_silu": 0, "gn_silu_backward": 0, "gn_silu_sums": 10 * evals,
                    "gn_silu_apply": 10 * evals, "gn_silu_backward_sums": 0,
                    "gn_silu_backward_apply": 0, "rasterize": 0, "flash_attn": evals,
                    "flash_attn_backward": 0}
            if got != want:
                raise AssertionError(f"space {name} rank {rank}: launches {got}, expected {want}")
    result = {}
    for i, (name, case) in enumerate(zip(names, cases["space"])):
        svc = ScoreModelService(case["config"], case["params"], device=DEVICE,
                                buckets=case["buckets"], **case["settings"])
        (y_cat, y_cont, seed), = case["requests"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        want = _one_process_dispatch(svc, y_cat, y_cont, seed, len(y_cat))
        torch.cuda.synchronize()
        got = two[0][i]["x"][0]
        d = float(np.abs(got - want).max())
        result[name] = {"max_abs_diff": d, "seconds": [two[0][i]["seconds"][0],
                                                       two[1][i]["seconds"][0]],
                        "seconds_one_process": time.perf_counter() - s0,
                        "peak_bytes": [two[0][i].get("peak_bytes", 0),
                                       two[1][i].get("peak_bytes", 0)],
                        "peak_bytes_one_process": int(torch.cuda.max_memory_allocated())}
        if not (np.array_equal(got, two[1][i]["x"][0]) and got.shape == want.shape
                and (name == "hi_bf16" or d <= SPACE_TOL)):
            raise AssertionError(f"space {name}: {d:.3e} from one process")
        del svc
    out["space"] = result
    hi, hb = result["hi_f32"], result["hi_bf16"]
    gib = 2.0**30
    log(f"space 256x256 12 images SDE-{SPACE_HI_STEPS} on a (1, 2) mesh (two ranks on one "
        f"card over gloo, {card}): f32 {hi['max_abs_diff']:.3e} from one process (tolerance "
        f"{SPACE_TOL}), {hi['seconds'][0]:.2f} / {hi['seconds'][1]:.2f} s per rank against "
        f"{hi['seconds_one_process']:.2f} s in one process, peak "
        f"{hi['peak_bytes'][0] / gib:.2f} / {hi['peak_bytes'][1] / gib:.2f} GiB against "
        f"{hi['peak_bytes_one_process'] / gib:.2f}; bf16 {hb['max_abs_diff']:.3e} from one "
        f"process (not held), {hb['seconds'][0]:.2f} / {hb['seconds'][1]:.2f} s against "
        f"{hb['seconds_one_process']:.2f} s, peak {hb['peak_bytes'][0] / gib:.2f} / "
        f"{hb['peak_bytes'][1] / gib:.2f} GiB against {hb['peak_bytes_one_process'] / gib:.2f}; "
        f"launches per rank per dispatch {json.dumps(two[0][1]['launches'])}")
    log(f"space 64x64 SDE-{SPACE_64_STEPS} on the (1, 2) mesh: stem none "
        f"{result['none_64']['max_abs_diff']:.3e}, s2dr {result['s2dr_64']['max_abs_diff']:.3e} "
        f"from one process")
    # (d) the serve CLI on a 2-rank mesh
    gc.collect()
    torch.cuda.empty_cache()
    out["serve_cli"] = _space_serve_cli(card)
    out["seconds"] = time.perf_counter() - t0
    return out



# Phase 17: training under the space axis, on one card: two ranks share cuda:0
# over gloo, so nothing here times NCCL or a collective across cards
SPACE_TRAIN_DIR = os.path.join(ROOT, "runs", "chip_smoke_space_train")
ST_GN_SHAPE = (32, 96, 128, 256)    # one rank's rows of down1/up1 at 256x256, batch 32, S = 2
ST_FLASH = ((32, 2048, 4, 48), 4096)  # a rank's queries against the gathered keys, S = 2
ST_F32_BATCH, ST_BF16_BATCH, ST_BF16_STEPS = 2, 32, 2
ST_CLI = ["--procedural", "--img-size", "64", "--base-ch", "96", "--dtype", "bfloat16",
          "--n-samples", "64", "--batch-size", "32", "--sample-steps", "4",
          "--shard-space", "2", "--dist-backend", "gloo", "--ckpt-format", "orbax"]
# the stem the 256x256 step does not run (cut from both stems at once for time); its
# train CLI runs in phase 18's side-by-side CLI stage (`_train_clis`)
ST_CLI_STEMS = ("s2dr",)


def _st_gn_rows(gn) -> tuple[list[dict], dict]:
    """The space axis's GroupNorm backward pair at one rank's rows of the
    256x256 path (bf16, pad on and off) against its plain versions; the other
    rank's share of the group's sums added in-process. Timed beside the
    plain versions; bound: bytes (sums: x and the gradient read once; apply:
    those and dx written once)."""
    rows, headline = [], {}
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    b, c, h, w = ST_GN_SHAPE
    x = (torch.randn(ST_GN_SHAPE, generator=gen, device=DEVICE) * 2 + 0.5).to(torch.bfloat16)
    scale = torch.randn(c, generator=gen, device=DEVICE) * 0.1 + 1.0
    bias = torch.randn(c, generator=gen, device=DEVICE) * 0.1
    sums = gn.gn_sums_reference(x, 8) * 2.0
    count = c // 8 * h * w * 2
    for pad in (False, True):
        p = 1 if pad else 0
        g = torch.randn((b, c, h + 2 * p, w + 2 * p), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        edge = torch.randn((b, c, 2, w + 2), generator=gen,
                           device=DEVICE).to(torch.bfloat16) if pad else None
        args = (x, g, edge, sums, count, scale, bias, 8)
        chan = gn.gn_silu_backward_sums(*args, pad=pad)
        want = gn.gn_silu_backward_sums_reference(*args, pad=pad)
        sums_err = float((chan - want).abs().max()) / float(want.abs().max())
        dsums = (want * scale.reshape(1, -1, 1)).reshape(b, 8, -1, 2).sum(2) * 2.0
        dx = gn.gn_silu_backward_apply(x, g, edge, sums, dsums, count, scale, bias, 8, pad=pad)
        want_dx = gn.gn_silu_backward_apply_reference(x, g, edge, sums, dsums, count, scale,
                                                      bias, 8, pad=pad)
        torch.cuda.synchronize()
        err = float((dx.float() - want_dx.float()).abs().max())
        big = float(want_dx.float().abs().max())
        row = dict(shape="256 down1/up1 rank rows, S = 2", dims=list(ST_GN_SHAPE),
                   dtype="bfloat16", pad=pad, sums_max_err_share=sums_err, max_abs_err=err,
                   max_abs=big, grad_tol=GRAD_TOL["bfloat16"])
        if not (sums_err <= GRAD_TOL["float32"] and err <= GRAD_TOL["bfloat16"] * big):
            raise AssertionError(f"gn_silu space backward pair disagrees: {row}")
        del want_dx, dx, chan
        row["sums_ms"] = cuda_time_ms(lambda: gn.gn_silu_backward_sums(*args, pad=pad))
        row["sums_plain_ms"] = cuda_time_ms(
            lambda: gn.gn_silu_backward_sums_reference(*args, pad=pad), iters=3, warmup=1)
        row["apply_ms"] = cuda_time_ms(lambda: gn.gn_silu_backward_apply(
            x, g, edge, sums, dsums, count, scale, bias, 8, pad=pad))
        row["apply_plain_ms"] = cuda_time_ms(lambda: gn.gn_silu_backward_apply_reference(
            x, g, edge, sums, dsums, count, scale, bias, 8, pad=pad), iters=3, warmup=1)
        read = (x.numel() + g.numel() + (0 if edge is None else edge.numel())) * 2
        row["sums_bound_ms"] = (read + b * c * 2 * 4) / HBM_BYTES_PER_S * 1e3
        row["apply_bound_ms"] = (read + x.numel() * 2) / HBM_BYTES_PER_S * 1e3
        rows.append(row)
        log("kernel gn_silu space backward " + json.dumps(row))
        if pad:
            headline = row
        del g, edge
    del x
    torch.cuda.empty_cache()
    return rows, headline


def _st_flash_rows(at) -> tuple[list[dict], dict]:
    """The flash backward of a rank's Nq queries against Nk gathered keys
    (bf16: wgmma; f32: TF32 mma, three products each) against autograd of
    `sdpa_reference` in f32 (8 items at a time), timed beside it and beside
    autograd of F.scaled_dot_product_attention at the same shapes; the f32
    backward rerun must repeat its bits."""
    rows, headline = [], {}
    clock_hz = sm_clock_max_hz()
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    shape, nk = ST_FLASH
    b, n, h, d = shape
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        kv = torch.randn((b, nk, 2, h, d), generator=gen, device=DEVICE).to(dtype)
        up = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        leaves = [t.detach().requires_grad_(True) for t in (q, kv[:, :, 0], kv[:, :, 1])]
        before = (at.flash_sdpa.launches, at.flash_sdpa.backward_launches)
        out = at.flash_sdpa(*leaves)
        grads = torch.autograd.grad(out, leaves, up, retain_graph=True)
        torch.cuda.synchronize()
        if (at.flash_sdpa.launches, at.flash_sdpa.backward_launches) != \
                (before[0] + 1, before[1] + 1):
            raise AssertionError(f"flash_sdpa did not launch its kernels at Nq {n} / Nk {nk}")
        errs = {k: 0.0 for k in ("dq", "dk", "dv")}
        maxs = dict(errs)
        for i0 in range(0, b, 8):
            sl = slice(i0, i0 + 8)
            ref = [t[sl].detach().float().requires_grad_(True) for t in leaves]
            want_g = torch.autograd.grad(at.sdpa_reference(*ref), ref, up[sl].float())
            for k, got, w in zip(errs, grads, want_g):
                errs[k] = max(errs[k], float((got[sl].float() - w).abs().max()))
                maxs[k] = max(maxs[k], float(w.abs().max()))
            del ref, want_g
        row = dict(shape="S=2", dims=list(shape), nk=nk, dtype=name, tol_share=FLASH_TOL[name])
        bad = []
        for k in errs:
            row[f"{k}_max_abs_err"], row[f"{k}_max_abs"] = errs[k], maxs[k]
            if not errs[k] <= FLASH_TOL[name] * maxs[k]:
                bad.append(k)
        if dtype == torch.float32:
            again = torch.autograd.grad(out, leaves, up, retain_graph=True)
            row["rerun_bit_equal"] = all(torch.equal(a, g) for a, g in zip(again, grads))
            del again
            if not row["rerun_bit_equal"]:
                bad.append("rerun bits")
        it, warm = 10, 3
        row["backward_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(out, leaves, up, retain_graph=True), iters=it,
            warmup=warm)
        plain = at.sdpa_reference(*leaves)
        row["plain_backward_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(plain, leaves, up, retain_graph=True), iters=min(it, 3),
            warmup=1)
        del plain
        lib_leaves = [t.detach().transpose(1, 2).requires_grad_(True) for t in leaves]
        lib = F.scaled_dot_product_attention(*lib_leaves)
        row["library_backward_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(lib, lib_leaves, up.transpose(1, 2), retain_graph=True),
            iters=it, warmup=warm)
        del lib, lib_leaves
        row["backward_bound_ms"], row["bound_by"], row["backward_bound_operations"] = \
            flash_bound(shape, q.element_size(), True, clock_hz, nk=nk)
        rows.append(row)
        log("kernel flash_attn backward Nq != Nk " + json.dumps(row))
        if bad:
            raise AssertionError(f"flash backward at Nq {n} / Nk {nk} {name} disagrees in {bad}: "
                                 f"{row}")
        if dtype == torch.bfloat16:
            headline.update(row)
        else:
            headline["f32"] = row
        del q, kv, up, leaves, out, grads
        torch.cuda.empty_cache()
    return rows, headline


def _st_cases() -> dict:
    """The 256x256 model (base_ch 96, stem none, param v, logsnr_shift -2.77)
    at full width: one f32 step at batch ST_F32_BATCH, and ST_BF16_STEPS bf16
    steps at batch ST_BF16_BATCH, each on rendered images and injected (t, eps)."""
    from toycrystals_torch.data.datasets import generate_batch
    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.models.torch_init import flax_default_init

    kw = {k: SLICE_CFG[k] for k in ("n_types", "y_cont_dim", "base_ch", "emb_dim", "cond_ch",
                                    "time_ch")}
    model = flax_default_init(make_model("none", "float32"), np.random.default_rng(23))
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    r = np.random.default_rng(24)
    cases = []
    for dtype, b, steps in ((torch.float32, ST_F32_BATCH, 1),
                            (torch.bfloat16, ST_BF16_BATCH, ST_BF16_STEPS)):
        x0 = np.stack([generate_batch(LatticeConfig(img_size=HI_SIZE, rot_only=True), 0,
                                      np.arange(i * b, (i + 1) * b), device="cpu")[0].numpy()
                       for i in range(steps)])
        cases.append(dict(kind="sde", model=dict(kw, stem="none", dtype=dtype), state_dict=sd,
                          param="v", sde=dict(beta_min=0.1, beta_max=30.0,
                                              logsnr_shift=HI_CFG["logsnr_shift"]),
                          opt={"lr": TRAIN_LR, "ema": 0.999}, x0=x0,
                          y_cat=r.integers(0, 5, (steps, b)).astype(np.int32),
                          y_cont=r.normal(size=(steps, b, 4)).astype(np.float32),
                          t=r.uniform(0.02, 1.0, (steps, b)).astype(np.float32),
                          eps=r.normal(size=x0.shape).astype(np.float32)))
    return {"device": torch.device(DEVICE).type, "tf32": False, "cases": cases}


def _st_hold_updated(got: dict, want: dict, lr: float, decay: float) -> tuple[float, float, int]:
    """After one Adam step, where the one-process first moment is at least a
    tenth of its leaf's largest entry and at least 1e-5 (a gradient at
    rounding-noise level may take either sign elsewhere, and Adam's first
    step moves every entry by about lr either way): the parameters within
    lr/10 and the EMA within (1 - decay) lr/10 plus 4 f32 ulps of its value.
    Returns the largest share of its limit each used and the entries held."""
    worst_p = worst_e = 0.0
    held = 0
    for k, m in want["mu"].items():
        mask = np.abs(m) >= max(0.1 * float(np.abs(m).max()), 1e-5)
        held += int(mask.sum())
        if not mask.any():
            continue
        dp = np.abs(got["params"][k] - want["params"][k])[mask]
        worst_p = max(worst_p, float(dp.max()) / (lr / 10))
        ew = want["ema"][k][mask]
        lim = (1.0 - decay) * lr / 10 + 4 * np.finfo(np.float32).eps * np.abs(ew)
        worst_e = max(worst_e, float((np.abs(got["ema"][k][mask] - ew) / lim).max()))
    if not (held > 1000 and worst_p <= 1.0 and worst_e <= 1.0):
        raise AssertionError(f"space training f32 against one process: parameters at "
                             f"{worst_p:.3f} and EMA at {worst_e:.3f} of their limits on "
                             f"{held} entries")
    return worst_p, worst_e, held


def _st_world1() -> dict:
    """A (1, 1) mesh at world 1 in this process over NCCL: one f32 SDE step
    at 64x64 under DDP bit-equal to the same step with no mesh (both under
    deterministic algorithms, as phase 15's: the bilinear upsample's and
    cuDNN's backward are atomic otherwise)."""
    import torch.distributed as dist

    from toycrystals_torch.parallel import place_state
    from toycrystals_torch.parallel.mesh import make_mesh_2d
    from toycrystals_torch.train.steps import make_sde_train_step

    x0, y_cat, y_cont = (torch.from_numpy(a).to(DEVICE) for a in (
        np.random.default_rng(25).uniform(size=(8, 64, 64, 1)).astype(np.float32),
        np.arange(8, dtype=np.int32) % 4, np.zeros((8, 4), np.float32)))
    r = np.random.default_rng(26)
    noise = (torch.from_numpy(r.uniform(0.02, 1.0, 8).astype(np.float32)).to(DEVICE),
             torch.from_numpy(r.normal(size=(8, 64, 64, 1)).astype(np.float32)).to(DEVICE))
    params = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for with_mesh in (True, False):
            model, tx, sde, state = train_pieces("none", "float32", DEVICE)
            mesh = None
            if with_mesh:
                dist.init_process_group(
                    "nccl" if torch.device(DEVICE).type == "cuda" else "gloo",
                    init_method=f"file://{os.path.join(SPACE_TRAIN_DIR, 'world1')}", rank=0,
                    world_size=1, timeout=timedelta(seconds=300))
                mesh = make_mesh_2d(1, 1, torch.device(DEVICE).type)
            try:
                module, state = place_state(mesh, model, state)
                step = make_sde_train_step(module, tx, sde, **TRAIN_KW, mesh=mesh)
                state, _ = step(state, x0, y_cat, y_cont, noise=noise)
                params.append({k: v.detach().cpu().numpy() for k, v in state.params.items()})
            finally:
                if with_mesh:
                    dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    for k, v in params[1].items():
        if not np.array_equal(params[0][k], v):
            raise AssertionError(f"(1, 1) mesh at world 1: parameter {k} differs from no mesh")
    log("space training (1, 1) mesh at world 1 over NCCL: one f32 step bit-equal to no mesh")
    return {"bit_equal": True}


def phase_space_train(card: str) -> dict:
    """Phase 17: training under the space axis (module docstring)."""
    from toycrystals_torch.ops import attention as at
    from toycrystals_torch.ops import groupnorm as gn
    from toycrystals_torch.parallel.multihost import launch
    from toycrystals_torch.parallel.parity import run_cases

    shutil.rmtree(SPACE_TRAIN_DIR, ignore_errors=True)
    os.makedirs(SPACE_TRAIN_DIR)
    t0 = time.perf_counter()
    out: dict = {"card": card, "launches": {}}
    out["gn_rows"], out["gn_headline"] = _st_gn_rows(gn)
    out["flash_rows"], out["flash_headline"] = _st_flash_rows(at)
    out["world1"] = _st_world1()
    spec = _st_cases()
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    two = launch(run_cases, 2, ({**spec, "mesh": [1, 2]},), device_type=spec["device"],
                 backend="gloo", device_ids=[0, 0], timeout=600)
    out["mesh_job_s"] = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    one = run_cases(spec)
    for i, (name, steps) in enumerate((("f32", 1), ("bf16", ST_BF16_STEPS))):
        per_step = {"gn_silu": 0, "gn_silu_backward": 0, "gn_silu_sums": 10, "gn_silu_apply": 10,
                    "gn_silu_backward_sums": 10, "gn_silu_backward_apply": 10, "rasterize": 0,
                    "flash_attn": 1, "flash_attn_backward": 1}
        want_launches = {k: v * steps for k, v in per_step.items()}
        for rank in (0, 1):
            got = two[rank][i]["launches"]
            out["launches"][f"space_train_{name}_rank{rank}"] = got
            if got != want_launches:
                raise AssertionError(f"space training {name} rank {rank}: launches {got}, "
                                     f"expected {want_launches}")
        r0, r1, want = two[0][i], two[1][i], one[i]
        if r0["losses"] != r1["losses"]:
            raise AssertionError(f"space training {name}: the ranks' losses differ")
        rec = {"losses": r0["losses"], "losses_one_process": want["losses"],
               "step_ms_rank0": r0["step_ms"], "step_ms_rank1": r1["step_ms"],
               "step_ms_one_process": want["step_ms"],
               "peak_bytes": [r0.get("peak_bytes", 0), r1.get("peak_bytes", 0)],
               "peak_bytes_one_process": want.get("peak_bytes", 0),
               "launches_per_rank_per_step": per_step}
        rec["loss_rel_diff"] = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                                      want["losses"]))
        if name == "f32":
            rec["grad_worst_share"] = _leafwise(r0["grads"], want["grads"],
                                                "space training f32 gradient")
            rec["param_max_abs_diff"] = max(float(np.abs(r0["params"][k] - want["params"][k])
                                                  .max()) for k in want["params"])
            rec["param_worst_share"], rec["ema_worst_share"], rec["entries_held"] = \
                _st_hold_updated(r0, want, TRAIN_LR, 0.999)
            if not rec["loss_rel_diff"] <= 1e-5:
                raise AssertionError(f"space training f32 against one process: {rec}")
        elif not np.isfinite(r0["losses"]).all():
            raise AssertionError(f"space training bf16: losses {r0['losses']}")
        out[name] = rec
        gib = 2.0**30
        log(f"space training 256x256 {name} on a (1, 2) mesh (two ranks on one card over gloo, "
            f"{card}): losses {r0['losses']} against {want['losses']} in one process "
            f"({rec['loss_rel_diff']:.3e} relative"
            + (f"; gradients {rec['grad_worst_share']:.3f} of phase 7's limits, parameters "
               f"{rec['param_worst_share']:.3f} and EMA {rec['ema_worst_share']:.3f} of theirs "
               f"on {rec['entries_held']} entries, parameters {rec['param_max_abs_diff']:.3e} "
               f"apart in all" if name == "f32" else "")
            + f"); step ms per rank {r0['step_ms']} / {r1['step_ms']} against "
            f"{want['step_ms']}; peak {rec['peak_bytes'][0] / gib:.2f} / "
            f"{rec['peak_bytes'][1] / gib:.2f} GiB against "
            f"{rec['peak_bytes_one_process'] / gib:.2f}; launches per rank per step "
            f"{json.dumps(per_step)}")
    del two, one
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


# Phase 18: the "model" axis and HSDP, on one card: ranks share cuda:0 over gloo
TENSOR_DIR = os.path.join(ROOT, "runs", "chip_smoke_tensor")
# one 2-image SDE-2 request (4 rows under CFG; 4 images at SDE-20 took 72 s per rank over
# gloo, 2 images 38 s, at SDE-10 29 s; cut to SDE-6 for the VAE's and the priors' cases,
# then to SDE-2 for phase 20's)
TP_HI_STEPS, TP_HI_IMAGES = 2, 2
TP_F32_BATCH, TP_BF16_BATCH, TP_BF16_STEPS = 2, 8, 2
TP_CLI = ["--procedural", "--img-size", "64", "--base-ch", "96", "--dtype", "bfloat16",
          "--n-samples", "64", "--batch-size", "32", "--sample-steps", "4",
          "--dist-backend", "gloo"]
# the VAE and the priors at the README's widths: one f32 step each on the (1, 2) mesh, the
# VAE's on images rendered by each rank (one rasterizer launch per rank per step)
TP_VAE = dict(z_dim=VAE_Z, n_types=4, y_cont_dim=4, cond_drop=0.1)
TP_PRIOR_BATCH, TP_THIN = 256, 1 << 16  # gradient entries kept per leaf from the ranks
# the (data 2, model 2) job under FSDP2: one 64x64 f32 SDE step and one VAE step
TP2D_SDE_BATCH = 8
# the VAE and prior train CLIs beside phase 17's and 18's score-model CLIs
# Phase 18 runs its (data 1, model 2) job, its (data 2, model 2) job and the train CLIs
# on the card at once, and its one-process references while the CLIs still run: every
# time it reports carries this note
TP_CONTENDED = ("contended: phase 18's two mesh jobs and its train CLIs shared the card, so "
                "these times are not comparable with a phase run alone")
TP_VAE_CLI = ["--procedural", "--n-samples", "1280", "--batch-size", str(VAE_BATCH),
              "--z-dim", str(VAE_Z), "--dist-backend", "gloo"]
# the prior CLI: the README's recipe on a cache of its own, 2,560 procedural items (10
# steps), and a DDIM-10 grid (cut from 50 for time)
TP_PRIOR_CLI = [*PRIOR_RECIPE, "--ddim-steps", "10", "--procedural", "--max-items", "2560",
                "--rebuild-latents", "--dist-backend", "gloo"]


def _train_cli_runs() -> dict:
    """name -> (run directory, the train CLI's flags, its stem): phase 17's
    space run, then phase 18's model-axis and HSDP runs (`_train_clis`)."""
    return {
        **{f"space_{stem}": (os.path.join(SPACE_TRAIN_DIR, f"cli_{stem}"), ST_CLI, stem)
           for stem in ST_CLI_STEMS},
        "tp": (os.path.join(TENSOR_DIR, "cli_tp"), TP_CLI + ["--shard-model", "2"], "s2dr"),
        "hsdp": (os.path.join(TENSOR_DIR, "cli_hsdp"),
                 TP_CLI + ["--shard", "2", "--shard-space", "2", "--fsdp", "--ckpt-format",
                           "orbax"], "none"),
        # phase 20's: JAX's 3-D mesh, four ranks, at 32x32 (cut from 64x64 for time)
        "mesh_3d": (os.path.join(TENSOR_DIR, "cli_3d"),
                    TP_CLI + ["--img-size", "32", "--shard-space", "2", "--shard-model", "2",
                              "--ckpt-format", "orbax"], "none")}


def _tp_cases() -> dict:
    """The 256x256 model (base_ch 96, stem none, param v, logsnr_shift -2.77)
    at full width: a TP_HI_IMAGES-image SDE-TP_HI_STEPS request in f32 through
    ScoreModelService, one f32 step at batch TP_F32_BATCH and TP_BF16_STEPS
    bf16 steps at batch TP_BF16_BATCH on rendered images and injected (t, eps)."""
    from toycrystals_torch.data.datasets import generate_batch
    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.models.sde_score_model import sample_grid_conditions
    from toycrystals_torch.models.torch_init import flax_default_init
    from toycrystals_torch.utils.params import flax_from_torch_state_dict

    kw = {k: SLICE_CFG[k] for k in ("n_types", "y_cont_dim", "base_ch", "emb_dim", "cond_ch",
                                    "time_ch")}
    model = flax_default_init(make_model("none", "float32"), np.random.default_rng(27))
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    yc, yv = (a.numpy() for a in sample_grid_conditions(TP_HI_IMAGES, 4, 4))
    cases = [dict(kind="service", config=dict(HI_CFG, dtype="float32"),
                  params=flax_from_torch_state_dict(sd), buckets=(TP_HI_IMAGES,),
                  settings=dict(steps=TP_HI_STEPS), requests=[(yc, yv, 18)])]
    r = np.random.default_rng(28)
    for dtype, b, steps in ((torch.float32, TP_F32_BATCH, 1),
                            (torch.bfloat16, TP_BF16_BATCH, TP_BF16_STEPS)):
        x0 = np.stack([generate_batch(LatticeConfig(img_size=HI_SIZE, rot_only=True), 0,
                                      np.arange(i * b, (i + 1) * b), device="cpu")[0].numpy()
                       for i in range(steps)])
        cases.append(dict(kind="sde", model=dict(kw, stem="none", dtype=dtype), state_dict=sd,
                          param="v", sde=dict(beta_min=0.1, beta_max=30.0,
                                              logsnr_shift=HI_CFG["logsnr_shift"]),
                          opt={"lr": TRAIN_LR, "ema": 0.999}, x0=x0,
                          y_cat=r.integers(0, 5, (steps, b)).astype(np.int32),
                          y_cont=r.normal(size=(steps, b, 4)).astype(np.float32),
                          t=r.uniform(0.02, 1.0, (steps, b)).astype(np.float32),
                          eps=r.normal(size=x0.shape).astype(np.float32)))
    cases += _tp_trainer_cases()
    return {"device": torch.device(DEVICE).type, "tf32": False, "cases": cases}


def _tp_trainer_cases() -> list:
    """The VAE (z 32, batch 128, its epoch on images each rank renders) and
    the FiLM and MoE-4 priors (width 1024, 8 blocks, batch 256, the README's
    schedule) at full width, one f32 step each, the weights drawn on every
    rank from a seed."""
    from toycrystals_torch.models.diffusion_prior import DiffusionSchedule

    r = np.random.default_rng(29)
    b, z = TP_PRIOR_BATCH, PRIOR_KW["z_dim"]
    sched = DiffusionSchedule.linear(1000, 1e-4, 0.05)
    cases = [dict(kind="vae_epoch", model=TP_VAE, init_seed=30, batch=VAE_BATCH,
                  items=VAE_BATCH, lattice=dict(img_size=64, n_types=4, rot_only=True),
                  seed=31, beta_eff=3e-4 / 5, free_bits=0.05, opt={"lr": 2e-3})]
    for i, extra in enumerate(({}, {"n_experts": 4})):
        cases.append(dict(kind="prior", model=dict(PRIOR_KW, **extra), init_seed=32 + i,
                          betas=sched.betas.numpy(), alpha_bars=sched.alpha_bars.numpy(),
                          z0n=r.normal(size=(b, z)).astype(np.float32),
                          y_cat=r.integers(0, 4, b).astype(np.int32),
                          y_cont=r.uniform(0, 1, (b, 4)).astype(np.float32),
                          t=r.integers(0, 1000, b).astype(np.int32),
                          eps=r.normal(size=(b, z)).astype(np.float32),
                          aux_weight=0.01 if extra else 0.0, opt={"lr": 1e-4}, thin=TP_THIN))
    return cases


def _tp2d_cases() -> dict:
    """The (data 2, model 2) job under FSDP2: one 64x64 f32 SDE step of the
    full-width stem-none model on rendered images and injected (t, eps), and
    the VAE's epoch of `_tp_trainer_cases`."""
    from toycrystals_torch.data.datasets import generate_batch
    from toycrystals_torch.data.lattice import LatticeConfig

    kw = {k: SLICE_CFG[k] for k in ("n_types", "y_cont_dim", "base_ch", "emb_dim", "cond_ch",
                                    "time_ch")}
    r, b = np.random.default_rng(34), TP2D_SDE_BATCH
    x0 = generate_batch(LatticeConfig(img_size=64, rot_only=True), 1, np.arange(b),
                        device="cpu")[0].numpy()[None]
    sde = dict(kind="sde", model=dict(kw, stem="none"), init_seed=35,
               opt={"lr": TRAIN_LR, "ema": 0.999, "clip": 1.0}, x0=x0,
               y_cat=r.integers(0, 5, (1, b)).astype(np.int32),
               y_cont=r.normal(size=(1, b, 4)).astype(np.float32),
               t=r.uniform(0.02, 1.0, (1, b)).astype(np.float32),
               eps=r.normal(size=x0.shape).astype(np.float32))
    vae = _tp_trainer_cases()[0]
    return {"device": torch.device(DEVICE).type, "tf32": False,
            "cases": [dict(c, fsdp=True) for c in (sde, vae)]}


def _run_side_by_side(argvs: dict) -> dict:
    """Each argv (`python -m` and its module and flags) in a process of its own,
    all at once; their outputs once every one exited 0."""
    procs = {}
    for name, argv in argvs.items():
        argv = [sys.executable, "-u", "-m", *argv] + (["--device", "cpu"]
                                                      if DEVICE == "cpu" else [])
        procs[name] = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    texts = {}
    for name, proc in procs.items():
        try:
            texts[name], _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"{name} exited {proc.returncode}:\n{texts[name][-4000:]}")
    return texts


def _train_clis(card: str) -> dict:
    """The 64x64 train CLI on each mesh of `_train_cli_runs`, side by side on
    cuda:0 over gloo: phase 17's --shard-space 2 (DDP over both ranks, into
    DCP), --shard-model 2 (2 ranks) and --shard 2 --shard-space 2 --fsdp
    (HSDP into DCP, 4 ranks), and phase 20's --shard-space 2 --shard-model 2
    (JAX's 3-D mesh into DCP, 4 ranks). 1 epoch, then --resume to 2, which
    ends in a grid sampled on each run's mesh; beside the resumes, the sample
    CLI on the 3-D mesh on a copy of that run's first checkpoint, and the sample CLI with
    --shard-model 2 on the model-axis run's first msgpack checkpoint. Beside
    them, the VAE trainer with --shard 2 --shard-model 2 --fsdp (4 ranks, 1
    epoch, then --resume to 2) and, beside the first epochs, the prior
    trainer at the README's recipe with --shard-model 2 (2 ranks, 1 epoch on
    the latents of phase 13's VAE, DDIM-10)."""
    from toycrystals_torch.utils.checkpoint import load_checkpoint
    from toycrystals_torch.utils.orbax_io import load_orbax_meta

    out, train, runs = {}, "toycrystals_torch.scripts.train_sde_score_model", _train_cli_runs()
    first = os.path.join(TENSOR_DIR, "tp_epoch_1.msgpack")
    png = os.path.join(TENSOR_DIR, "tp_sample.png")
    first_3d = os.path.join(TENSOR_DIR, "mesh_3d_epoch_1.orbax")
    png_3d = os.path.join(TENSOR_DIR, "mesh_3d_sample.png")
    vae_dir, prior_dir = os.path.join(TENSOR_DIR, "cli_vae_2d"), os.path.join(TENSOR_DIR,
                                                                              "cli_prior_tp")
    vae = ["toycrystals_torch.scripts.train_vae", *TP_VAE_CLI, "--shard", "2", "--shard-model",
           "2", "--fsdp", "--out-dir", vae_dir]
    for epochs, more in ((1, ["--sample-every", "0"]), (2, ["--resume", "--sample-every", "1"])):
        t0 = time.perf_counter()
        argvs = {name: [train, *flags, "--stem", stem, "--epochs", str(epochs), *more,
                        "--out-dir", run] for name, (run, flags, stem) in runs.items()}
        argvs["vae_2d"] = vae + ["--epochs", str(epochs)] + (["--resume"] if epochs == 2 else [])
        if epochs == 1:
            argvs["prior_tp"] = ["toycrystals_torch.scripts.train_diffusion_prior",
                                 *TP_PRIOR_CLI, "--shard-model", "2", "--epochs", "1",
                                 "--vae-ckpt", os.path.join(VAE_DIR, "checkpoints",
                                                            "vae_last.msgpack"),
                                 "--out-dir", prior_dir]
        if epochs == 2:  # the sample CLI beside the resumes, on the first epoch's checkpoint
            argvs["sample"] = ["toycrystals_torch.scripts.sample_sde_score_model", "--out-dir",
                               TENSOR_DIR, "--ckpt", first, "--steps", "4", "--n", "4",
                               "--shard-model", "2", "--dist-backend", "gloo",
                               "--out-path", png]
            argvs["sample_3d"] = ["toycrystals_torch.scripts.sample_sde_score_model",
                                  "--out-dir", TENSOR_DIR, "--ckpt", first_3d, "--steps", "4",
                                  "--n", "4", "--shard-space", "2", "--shard-model", "2",
                                  "--dist-backend", "gloo", "--out-path", png_3d]
        texts = _run_side_by_side(argvs)
        out[f"train_epochs_{epochs}_seconds"] = time.perf_counter() - t0
        for name in [*runs, "vae_2d"] + (["prior_tp"] if epochs == 1 else []):
            out.setdefault(name, {})["coverage"] = re.findall(
                r"(?:tensor parallelism|fsdp): .*", texts[name])
        if epochs == 1:
            losses = [float(v) for v in re.findall(r"diffusion_loss=(\S+)", texts["prior_tp"])]
            ckpt = os.path.join(prior_dir, "checkpoints", "diffusion_prior_last.msgpack")
            grid = os.path.join(prior_dir, "results", "diffusion_samples.png")
            if not (len(losses) == 1 and np.isfinite(losses).all() and os.path.exists(ckpt)
                    and read_png_gray(grid).size and len(out["prior_tp"]["coverage"]) == 1):
                raise AssertionError(f"prior CLI --shard-model 2: losses {losses}, "
                                     f"{texts['prior_tp'][-2000:]}")
            out["prior_tp"]["losses"] = losses
        if epochs == 1:
            shutil.copy(os.path.join(runs["tp"][0], "checkpoints", "sde_score_model_last.msgpack"),
                        first)
            shutil.copytree(os.path.join(runs["mesh_3d"][0], "checkpoints",
                                         "sde_score_model_last.orbax"), first_3d)
        # JAX's line for the 3-D mesh, printed by rank 0 of each run on it
        out.setdefault("mesh_3d", {}).setdefault("mesh_lines", []).extend(
            line for name in ("mesh_3d", "sample_3d") if name in texts
            for line in texts[name].splitlines()
            if line.startswith("3-D mesh: ") and line.endswith(" devices"))
    for name, (run, flags, _) in runs.items():
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        orbax = "orbax" in flags
        ckpt = os.path.join(run, "checkpoints", "sde_score_model_last" +
                            (".orbax" if orbax else ".msgpack"))
        meta = load_orbax_meta(ckpt) if orbax else load_checkpoint(ckpt)
        grids = sorted(os.listdir(os.path.join(run, "results")))
        losses = [r["loss"] for r in rows]
        covered = bool(out[name]["coverage"]) or name.startswith("space")
        if not ([r["epoch"] for r in rows] == [1, 2] and np.isfinite(losses).all()
                and int(meta["epoch_next"]) == 2 and grids == ["sde_samples_epoch_002.png"]
                and covered):
            raise AssertionError(f"train CLI {name}: metrics {rows}, epoch_next "
                                 f"{meta.get('epoch_next')}, grids {grids}, "
                                 f"coverage {out[name]['coverage']}")
        out[name].update(losses=losses, grids=grids)
    for path, what in ((png, "--shard-model 2"), (png_3d, "--shard-space 2 --shard-model 2")):
        img = read_png_gray(path)
        if not (img.size and np.isfinite(img).all()):
            raise AssertionError(f"sample CLI {what} wrote no grid at {path}")
    if out["mesh_3d"]["mesh_lines"] != ["3-D mesh: 1 data x 2 space x 2 model devices"] * 3:
        raise AssertionError(f"3-D CLIs: JAX's mesh lines {out['mesh_3d']['mesh_lines']}")
    raw = load_checkpoint(os.path.join(vae_dir, "checkpoints", "vae_last.msgpack"))
    hist = [float(raw["hists"]["loss"][str(i)]) for i in range(len(raw["hists"]["loss"]))]
    grids = sorted(os.listdir(os.path.join(vae_dir, "results")))
    if not (int(raw["epoch_next"]) == 2 and len(hist) == 2 and np.isfinite(hist).all()
            and grids == ["vae_recon.png", "vae_samples_mop.png", "vae_samples_prior.png"]
            and len(out["vae_2d"]["coverage"]) == 2):
        raise AssertionError(f"VAE CLI --shard 2 --shard-model 2 --fsdp: epoch_next "
                             f"{raw['epoch_next']}, losses {hist}, grids {grids}, coverage "
                             f"{out['vae_2d']['coverage']}")
    out["vae_2d"].update(losses=hist, grids=grids)
    log(f"train CLIs side by side (64x64, base_ch 96, bf16, ranks on one card over gloo, "
        f"{card}; the times are the ranks' host copies and time-slicing, not NVLink; "
        f"{TP_CONTENDED}): {json.dumps(out)}")
    return out


def phase_tensor(card: str) -> dict:
    """Phase 18: the "model" axis and HSDP (module docstring)."""
    from concurrent.futures import ThreadPoolExecutor

    from toycrystals_torch.parallel.parity import run_cases
    from toycrystals_torch.serve import ScoreModelService

    shutil.rmtree(TENSOR_DIR, ignore_errors=True)
    os.makedirs(TENSOR_DIR)
    t0 = time.perf_counter()
    out: dict = {"card": card, "launches": {}, "times": TP_CONTENDED}
    spec = _tp_cases()
    gc.collect()
    torch.cuda.empty_cache()
    pool = ThreadPoolExecutor(2)
    # the train CLIs and the (data 2, model 2) job beside the (data 1, model 2)
    # job: most of their time is their processes' start and gloo's host copies
    clis = pool.submit(_train_clis, card)
    job_2d = pool.submit(_launch_timed, _tp2d_cases(), [2, 2, "model"], 4)
    try:
        two, out["mesh_job_s"] = _launch_timed(spec, [1, 2, "model"], 2)
    finally:
        four, job_2d_s = job_2d.result()
    gc.collect()
    torch.cuda.empty_cache()
    one = run_cases({**spec, "cases": spec["cases"][1:]})
    gib = 2.0**30
    zero = {"gn_silu": 0, "gn_silu_backward": 0, "gn_silu_sums": 0, "gn_silu_apply": 0,
            "gn_silu_backward_sums": 0, "gn_silu_backward_apply": 0, "rasterize": 0,
            "flash_attn": 0, "flash_attn_backward": 0}
    # (a) the request against the one-process service's dispatch
    evals = TP_HI_STEPS + 1
    per_dispatch = dict(zero, gn_silu=10 * evals, flash_attn=evals)
    case = spec["cases"][0]
    for rank in (0, 1):
        got = two[rank][0]["launches"]
        out["launches"][f"tensor_hi_rank{rank}"] = got
        if got != per_dispatch:
            raise AssertionError(f"tensor request rank {rank}: launches {got}, expected "
                                 f"{per_dispatch}")
    svc = ScoreModelService(case["config"], case["params"], device=DEVICE,
                            buckets=case["buckets"], **case["settings"])
    (y_cat, y_cont, seed), = case["requests"]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    want = _one_process_dispatch(svc, y_cat, y_cont, seed, len(y_cat))
    torch.cuda.synchronize()
    got = two[0][0]["x"][0]
    d = float(np.abs(got - want).max())
    req = {"max_abs_diff": d, "seconds": [two[0][0]["seconds"][0], two[1][0]["seconds"][0]],
           "seconds_one_process": time.perf_counter() - s0,
           "peak_bytes": [two[0][0].get("peak_bytes", 0), two[1][0].get("peak_bytes", 0)],
           "peak_bytes_one_process": int(torch.cuda.max_memory_allocated()),
           "launches_per_rank_per_dispatch": per_dispatch}
    if not (np.array_equal(got, two[1][0]["x"][0]) and got.shape == want.shape
            and d <= SPACE_TOL):
        raise AssertionError(f"tensor request: {d:.3e} from one process")
    out["request"] = req
    del svc
    log(f"tensor 256x256 {TP_HI_IMAGES} images SDE-{TP_HI_STEPS} f32 on a (data 1, model 2) "
        f"mesh (two ranks on one card over gloo, {card}; the times are the ranks' host "
        f"copies and time-slicing, not NVLink; {TP_CONTENDED}): {d:.3e} from the "
        f"one-process dispatch "
        f"(tolerance {SPACE_TOL}); {req['seconds'][0]:.2f} / {req['seconds'][1]:.2f} s per "
        f"rank against {req['seconds_one_process']:.2f} s in one process; peak "
        f"{req['peak_bytes'][0] / gib:.2f} / {req['peak_bytes'][1] / gib:.2f} GiB against "
        f"{req['peak_bytes_one_process'] / gib:.2f}; launches per rank per dispatch "
        f"{json.dumps(per_dispatch)} (gn_silu on each rank's [{2 * TP_HI_IMAGES}, 48|96, H, W] "
        f"channel blocks of 4 groups, flash on its 2 of the 4 heads, "
        f"[{2 * TP_HI_IMAGES}, 4096, 2, 48])")
    # (b) the train steps against one process
    for i, (name, steps) in enumerate((("f32", 1), ("bf16", TP_BF16_STEPS)), start=1):
        per_step = dict(zero, gn_silu=10, gn_silu_backward=10, flash_attn=1,
                        flash_attn_backward=1)
        want_launches = {k: v * steps for k, v in per_step.items()}
        for rank in (0, 1):
            got = two[rank][i]["launches"]
            out["launches"][f"tensor_train_{name}_rank{rank}"] = got
            if got != want_launches:
                raise AssertionError(f"tensor training {name} rank {rank}: launches {got}, "
                                     f"expected {want_launches}")
        r0, r1, want = two[0][i], two[1][i], one[i - 1]
        if r0["losses"] != r1["losses"]:
            raise AssertionError(f"tensor training {name}: the ranks' losses differ")
        rec = {"losses": r0["losses"], "losses_one_process": want["losses"],
               "step_ms_rank0": r0["step_ms"], "step_ms_rank1": r1["step_ms"],
               "step_ms_one_process": want["step_ms"],
               "peak_bytes": [r0.get("peak_bytes", 0), r1.get("peak_bytes", 0)],
               "peak_bytes_one_process": want.get("peak_bytes", 0),
               "launches_per_rank_per_step": per_step}
        rec["loss_rel_diff"] = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                                      want["losses"]))
        if name == "f32":
            rec["grad_worst_share"] = _leafwise(r0["grads"], want["grads"],
                                                "tensor training f32 gradient")
            rec["param_worst_share"], rec["ema_worst_share"], rec["entries_held"] = \
                _st_hold_updated(r0, want, TRAIN_LR, 0.999)
            if not rec["loss_rel_diff"] <= 1e-5:
                raise AssertionError(f"tensor training f32 against one process: {rec}")
        elif not np.isfinite(r0["losses"]).all():
            raise AssertionError(f"tensor training bf16: losses {r0['losses']}")
        out[name] = rec
        log(f"tensor training 256x256 {name} batch {len(spec['cases'][i]['y_cat'][0])} on a "
            f"(data 1, model 2) mesh (two ranks on one card over gloo, {card}; host copies and "
            f"time-slicing, not NVLink; {TP_CONTENDED}): losses {r0['losses']} against "
            f"{want['losses']} in one "
            f"process ({rec['loss_rel_diff']:.3e} relative"
            + (f"; gradients {rec['grad_worst_share']:.3f} of phase 7's limits, parameters "
               f"{rec['param_worst_share']:.3f} and EMA {rec['ema_worst_share']:.3f} of theirs "
               f"on {rec['entries_held']} entries" if name == "f32" else "")
            + f"); step ms per rank {r0['step_ms']} / {r1['step_ms']} against "
            f"{want['step_ms']}; peak {rec['peak_bytes'][0] / gib:.2f} / "
            f"{rec['peak_bytes'][1] / gib:.2f} GiB against "
            f"{rec['peak_bytes_one_process'] / gib:.2f}; launches per rank per step "
            f"{json.dumps(per_step)}")
    # (c) the VAE's and the priors' steps at full width against one process
    for i, name in enumerate(("vae", "film", "moe4"), start=3):
        out[name] = _tp_hold_trainer_step(name, [res[i] for res in two], one[i - 1], zero,
                                          out["launches"], card)
    del two, one
    gc.collect()
    torch.cuda.empty_cache()
    out["mesh_2d"] = _tp2d_hold(four, zero, out["launches"], card)
    out["mesh_2d"]["job_s"] = job_2d_s
    out["cli"] = clis.result()
    pool.shutdown()
    out["seconds"] = time.perf_counter() - t0
    return out


def _tp_hold_trainer_step(name: str, ranks: list, want: dict, zero: dict, launches: dict,
                          card: str) -> dict:
    """One step of `_tp_trainer_cases` (or `_tp2d_cases`) on the ranks of a
    model mesh against one process: exact launches per rank (the VAE 1
    rasterizer launch and nothing else, the priors none, the SDE step 10 +
    10 gn_silu), the same loss on every rank and within 1e-5 relative of one
    process, the gradients within phase 7's limits (`_leafwise`), and the MoE
    route fractions within 1e-6."""
    sde = name.endswith("sde")
    per_step = dict(zero, gn_silu=10, gn_silu_backward=10) if sde else \
        dict(zero, rasterize=1 if name.endswith("vae") else 0)
    for rank, res in enumerate(ranks):
        launches[f"tensor_{name}_rank{rank}"] = res["launches"]
        if res["launches"] != per_step:
            raise AssertionError(f"tensor {name} rank {rank}: launches {res['launches']}, "
                                 f"expected {per_step}")

    def loss(res):
        return res["losses"][0] if sde else float(np.asarray(res["metrics"]["loss"]))

    if len({loss(res) for res in ranks}) != 1:
        raise AssertionError(f"tensor {name}: the ranks' losses differ: "
                             f"{[loss(res) for res in ranks]}")
    r0 = ranks[0]
    grads = [r["grads"][0] if isinstance(r["grads"], list) else r["grads"] for r in (r0, want)]
    ms = "epoch_ms" if "epoch_ms" in want else "step_ms"
    rec = {"loss": loss(r0), "loss_one_process": loss(want),
           "loss_rel_diff": abs(loss(r0) - loss(want)) / abs(loss(want)),
           "grad_worst_share": _leafwise(*grads, f"tensor {name} gradient"),
           "ms_per_rank": [res[ms] if not sde else res[ms][0] for res in ranks],
           "ms_one_process": want[ms] if not sde else want[ms][0],
           "peak_bytes": [res.get("peak_bytes", 0) for res in ranks],
           "peak_bytes_one_process": want.get("peak_bytes", 0),
           "launches_per_rank_per_step": per_step}
    if r0.get("route_fraction") is not None:
        rec["route_max_abs_diff"] = max(float(np.abs(a - b).max()) for a, b in zip(
            r0["route_fraction"], want["route_fraction"]))
        if not rec["route_max_abs_diff"] <= 1e-6:
            raise AssertionError(f"tensor {name}: route fractions {rec['route_max_abs_diff']}")
    if not rec["loss_rel_diff"] <= 1e-5:
        raise AssertionError(f"tensor {name} against one process: {rec}")
    gib = 2.0**30
    log(f"tensor training {name} on {len(ranks)} ranks of a model mesh (one card over gloo, "
        f"{card}; host copies and time-slicing, not NVLink; {TP_CONTENDED}): loss "
        f"{rec['loss']} against "
        f"{rec['loss_one_process']} in one process ({rec['loss_rel_diff']:.3e} relative), "
        f"gradients {rec['grad_worst_share']:.3f} of phase 7's limits"
        + (f", route fractions {rec['route_max_abs_diff']:.1e} apart" if "route_max_abs_diff"
           in rec else "")
        + f"; ms per rank {[round(v, 1) for v in rec['ms_per_rank']]} against "
        f"{rec['ms_one_process']:.1f}; peak "
        f"{' / '.join(f'{v / gib:.2f}' for v in rec['peak_bytes'])} GiB against "
        f"{rec['peak_bytes_one_process'] / gib:.2f}; launches per rank per step "
        f"{json.dumps(per_step)}")
    return rec


def _launch_timed(spec: dict, mesh: list, n: int) -> tuple[list, float]:
    """`run_cases` of `spec` on `mesh` in n ranks on cuda:0 over gloo, and the
    job's seconds."""
    from toycrystals_torch.parallel.multihost import launch
    from toycrystals_torch.parallel.parity import run_cases

    t0 = time.perf_counter()
    out = launch(run_cases, n, ({**spec, "mesh": mesh},), device_type=spec["device"],
                 backend="gloo", device_ids=[0] * n, timeout=600)
    return out, time.perf_counter() - t0


def _tp2d_hold(four: list, zero: dict, launches: dict, card: str) -> dict:
    """The (data 2, model 2) job under FSDP2 (`_tp2d_cases`, four ranks)
    against the same cases in this process."""
    from toycrystals_torch.parallel.parity import run_cases

    one = run_cases(_tp2d_cases())
    return {name: _tp_hold_trainer_step(name, [res[i] for res in four], one[i], zero, launches,
                                        card)
            for i, name in enumerate(("2d_sde", "2d_vae"))}


# Phase 19: the prior's pipeline and expert axes, on one card: ranks share cuda:0
# over gloo, so every time here is host copies and time-slicing, not NVLink. It
# runs beside phase 18 (its jobs and its train CLIs), so every time is contended.
PE_DIR = os.path.join(ROOT, "runs", "chip_smoke_pipe_expert")
PE_MICRO = 4                 # --pipe-micro: 64-row microbatches of the 256-row step
PE_DDIM_STEPS = 50
PE_CONTENDED = ("contended: phase 19 ran beside phase 18's mesh jobs and train CLIs, and its "
                "own jobs beside each other, so these times are not comparable with a phase "
                "run alone")
# each CLI checkpoint's parameters against one process's: two Adam steps of the
# recipe's lr (1e-4). A rank that skipped its updates would stand up to 10 steps (an
# epoch of 2,560 items at batch 256), 1e-3, away; the card's readings were at most 2.4e-5
PE_CLI_PARAM_TOL = 2e-4
PE_CACHE_LAUNCHES = 5               # the 2,560-item cache, 512 items a rasterizer launch
PE_MESHES = {"pipe": [1, 2, "pipe"], "expert": [1, 2, "expert"]}
PE_CLI_FLAGS = {"pipe": ["--shard-pipe", "2", "--pipe-micro", str(PE_MICRO)],
                "expert": ["--moe-experts", "4", "--shard-expert", "2"]}


def _pe_cases() -> list:
    """Per axis, one case: two f32 steps of the README's prior (width 1024, 8
    blocks, batch 256; FiLM on the pipe mesh with PE_MICRO microbatches,
    MoE-4 on the expert mesh) on injected draws (the first one's gradients
    are compared, the second one, warm, is timed), then DDIM-50 of the 36
    grid conditions from injected start noise and the forward on the same
    rows, the weights drawn from a seed on the card."""
    from toycrystals_torch.models.diffusion_prior import DiffusionSchedule
    from toycrystals_torch.models.sde_score_model import sample_grid_conditions

    r = np.random.default_rng(36)
    b, z = TP_PRIOR_BATCH, PRIOR_KW["z_dim"]
    sched = DiffusionSchedule.linear(1000, 1e-4, 0.05)
    s = dict(betas=sched.betas.numpy(), alpha_bars=sched.alpha_bars.numpy())
    yg_cat, yg_cont = (a.numpy() for a in sample_grid_conditions(36, 4, 4))
    cases = []
    for i, (axis, mesh) in enumerate(PE_MESHES.items()):
        model = dict(PRIOR_KW, **({"n_experts": 4} if axis == "expert" else {}))
        ddim = dict(z_t=r.normal(size=(36, z)).astype(np.float32),
                    t=r.integers(0, 1000, 36).astype(np.int32), y_cat=yg_cat, y_cont=yg_cont,
                    z=r.normal(size=(36, z)).astype(np.float32), ddim_steps=PE_DDIM_STEPS)
        cases.append(dict(kind="prior", model=model, init_seed=37 + i, mesh=mesh, micro=PE_MICRO,
                          z0n=r.normal(size=(b, z)).astype(np.float32),
                          y_cat=r.integers(0, 4, b).astype(np.int32),
                          y_cont=r.uniform(0, 1, (b, 4)).astype(np.float32),
                          t=r.integers(0, 1000, b).astype(np.int32),
                          eps=r.normal(size=(b, z)).astype(np.float32),
                          aux_weight=0.01 if axis == "expert" else 0.0, opt={"lr": 1e-4},
                          thin=TP_THIN, steps=2, ddim=ddim, **s))
    return cases


def _pe_cli(axis: str, mesh: bool, resume: bool) -> list:
    """The argv of the prior trainer at the README's recipe on its own
    2,560-item procedural cache (phase 18's recipe, DDIM-10), 1 epoch, on the
    axis's (1, 2) mesh or in one process with the same model."""
    flags = PE_CLI_FLAGS[axis] if mesh else PE_CLI_FLAGS[axis][:2] * (axis == "expert")
    run = os.path.join(PE_DIR, f"cli_{axis}" + ("" if mesh else "_one"))
    return [*TP_PRIOR_CLI, *flags, "--epochs", "1",
            *(["--device", "cpu"] if DEVICE == "cpu" else []),
            "--vae-ckpt", os.path.join(VAE_DIR, "checkpoints", "vae_last.msgpack"),
            *(["--resume"] if resume else []), "--out-dir", run]


def _pe_run(axis: str, mesh: bool, cases: list, ref=None) -> tuple[list, float, list]:
    """One of phase 19's four jobs, one spawn (`parity.in_turn`): the
    axis's CLI, 1 epoch (its checkpoint kept aside), then --resume, then
    `cases` (the pipe jobs take both axes' step and DDIM cases, so that the
    expert jobs, the longest, run the CLIs alone), on the axis's (1, 2) mesh
    or in one process. The CLIs run first, so they run with the torch
    defaults a CLI's process has; the cases then set TF32 off. Returns each
    rank's [(result, seconds)] of the calls, the job's seconds, and per
    checkpoint (its state_dict, its config), read here while other jobs
    still run; with `ref`, the future of the one-process job of the same
    axis, per checkpoint (the largest parameter difference from the
    reference's, whether the two hold the same leaves and config) instead."""
    from toycrystals_torch.parallel.parity import cli_state, in_turn, keep_copy, run_cases
    from toycrystals_torch.scripts import train_diffusion_prior as prior_cli
    from toycrystals_torch.utils.checkpoint import load_checkpoint
    from toycrystals_torch.utils.params import torch_state_dict_from_flax_prior

    first, resumed = (_pe_cli(axis, mesh, r) for r in (False, True))
    last = os.path.join(first[-1], "checkpoints", "diffusion_prior_last.msgpack")
    kept = os.path.join(first[-1], "epoch_1.msgpack")
    calls = [(cli_state, (prior_cli.train, first, False)), (keep_copy, (last, kept)),
             (cli_state, (prior_cli.train, resumed, False))]
    if cases:
        calls.append((run_cases, ({"device": torch.device(DEVICE).type, "tf32": False,
                                   "one_process": not mesh,
                                   "cases": [c if mesh else dict(c, mesh=None)
                                             for c in cases]},)))
    ranks, seconds = _pe_launch(in_turn, 2 if mesh else 1, (calls,))
    ckpts = [load_checkpoint(path) for path in (kept, last)]
    ckpts = [(torch_state_dict_from_flax_prior(c["params"]), c["config"]) for c in ckpts]
    if ref is None:
        return ranks, seconds, ckpts
    held = []
    for (g, got), (w, want) in zip(ckpts, ref.result()[2]):
        same = set(g) == set(w) and got == want
        held.append((max(float(np.abs(np.asarray(g[k]) - np.asarray(v)).max())
                         for k, v in w.items()) if same else float("inf"), same))
    return ranks, seconds, held


def _pe_launch(fn, n: int, args: tuple) -> tuple[list, float]:
    """`fn(*args)` in n ranks on cuda:0 over gloo (n = 1: a one-process
    reference in a process of its own, with the ranks' torch defaults), and
    the seconds."""
    from toycrystals_torch.parallel.multihost import launch

    t0 = time.perf_counter()
    cuda = torch.device(DEVICE).type == "cuda"
    out = launch(fn, n, args, device_type=torch.device(DEVICE).type, backend="gloo",
                 device_ids=[0] * n if cuda else None, timeout=600)
    return out, time.perf_counter() - t0


def phase_pipe_expert(card: str) -> dict:
    """Phase 19: the FiLM prior's pipeline (--shard-pipe 2, --pipe-micro 4)
    and the MoE-4 prior's experts over ranks (--shard-expert 2), each on a
    (1, 2) mesh of two ranks on cuda:0 over gloo (module docstring). Four
    jobs side by side, one spawn each (`_pe_run`): per axis the mesh's and
    the one-process reference's, so this phase may run beside phase 18: it
    uses no CUDA memory of this process."""
    from concurrent.futures import ThreadPoolExecutor

    shutil.rmtree(PE_DIR, ignore_errors=True)
    os.makedirs(PE_DIR)
    t0 = time.perf_counter()
    gib = 2.0**30
    out: dict = {"card": card, "launches": {}, "times": PE_CONTENDED}
    zero = {"gn_silu": 0, "gn_silu_backward": 0, "gn_silu_sums": 0, "gn_silu_apply": 0,
            "gn_silu_backward_sums": 0, "gn_silu_backward_apply": 0, "rasterize": 0,
            "flash_attn": 0, "flash_attn_backward": 0}
    cases = _pe_cases()
    with ThreadPoolExecutor(4) as pool:
        futures = {}
        for axis in PE_MESHES:
            mine = cases if axis == "pipe" else []
            futures[axis, False] = pool.submit(_pe_run, axis, False, mine)
            futures[axis, True] = pool.submit(_pe_run, axis, True, mine, futures[axis, False])
        done = {k: f.result() for k, f in futures.items()}
    out["job_s"] = {f"{axis}_{'mesh' if mesh else 'one_process'}": s
                    for (axis, mesh), (_, s, _) in done.items()}
    # each rank's [(epoch-1 run, s), (keep_copy, s), (resumed run, s), ([pipe case,
    # expert case], s) in the pipe jobs]
    step_ranks, (step_one,) = done["pipe", True][0], done["pipe", False][0]
    for i, axis in enumerate(PE_MESHES):
        # (a) the steps and DDIM-50 against one process
        step = ddim = [r[3][0][i] for r in step_ranks]
        want = want_ddim = step_one[3][0][i]
        for rank, res in enumerate(step):
            out["launches"][f"pipe_expert_{axis}_rank{rank}"] = res["launches"]
            if res["launches"] != zero:
                raise AssertionError(f"{axis} step and DDIM rank {rank}: launches "
                                     f"{res['launches']}, expected none")
        # the last (second) step's loss: it follows the first step's update
        losses = [float(np.asarray(r["metrics"]["loss"])) for r in step]
        loss_one = float(np.asarray(want["metrics"]["loss"]))
        rec = {"loss": losses, "loss_one_process": loss_one,
               "loss_rel_diff": abs(losses[0] - loss_one) / abs(loss_one),
               "grad_worst_share": _leafwise(step[0]["grads"], want["grads"],
                                             f"{axis} step gradient"),
               "step_ms": [r["step_ms"] for r in step], "step_ms_one_process": want["step_ms"],
               **{f"{k}_gib": [r.get(f"{k}_bytes", 0) / gib for r in step]
                  for k in ("state", "allocated", "step_peak", "peak")},
               **{f"{k}_gib_one_process": want.get(f"{k}_bytes", 0) / gib
                  for k in ("state", "allocated", "step_peak", "peak")}}
        if len(set(losses)) != 1 or not rec["loss_rel_diff"] <= 1e-5:
            raise AssertionError(f"{axis} step against one process: {rec}")
        if axis == "pipe":
            rec["hop_s_per_tick"] = [r["hop_s_per_tick"] for r in step]
            rec["hops"] = [r["hops"] for r in step]
            if rec["hops"] != [2 * (PE_MICRO + 2 - 1)] * 2:
                raise AssertionError(f"pipe step: hops {rec['hops']}, expected "
                                     f"{2 * (PE_MICRO + 1)} per rank")
        else:
            rec["route_max_abs_diff"] = max(
                float(np.abs(a - b).max()) for r in step
                for a, b in zip(r["route_fraction"], want["route_fraction"]))
            if not rec["route_max_abs_diff"] <= 1e-6:
                raise AssertionError(f"expert route fractions: {rec['route_max_abs_diff']}")
        z0, z0_one = ddim[0]["ddim"], want_ddim["ddim"]
        scale = float(np.abs(z0_one).max())
        # random weights put the last step's z0 at up to 1e6 (1 / sqrt(abar) at t
        # 999), so each entry is held as well: to DDIM_TOL of its size, or of 1
        rel = float((np.abs(z0 - z0_one) / (np.abs(z0_one) + 1.0)).max())
        rec["ddim50"] = dict(max_abs_diff=float(np.abs(z0 - z0_one).max()), max_abs=scale,
                             tolerance=DDIM_TOL * scale, max_entry_rel_diff=rel,
                             seconds=[r["ddim_s"] for r in ddim],
                             seconds_one_process=want_ddim["ddim_s"],
                             forward_max_abs_diff=float(np.abs(
                                 ddim[0]["forward"] - want_ddim["forward"]).max()))
        if not (np.array_equal(z0, ddim[1]["ddim"]) and np.isfinite(z0).all()
                and rec["ddim50"]["max_abs_diff"] <= DDIM_TOL * scale and rel <= DDIM_TOL):
            raise AssertionError(f"{axis} DDIM-50 against one process: {rec['ddim50']}")
        out[axis] = rec
        log(f"pipe/expert {axis} on a (data 1, {axis} 2) mesh (two ranks on one card over gloo, "
            f"{card}; host copies and time-slicing, not NVLink; {PE_CONTENDED}): "
            + json.dumps(rec))
        # (b) the train CLI, 1 epoch then --resume, against one process
        rec = {}
        (ranks, _, held), ((one,), _, _) = done[axis, True], done[axis, False]
        for (call, label), (diff, same) in zip(((0, "epoch_1"), (2, "resumed")), held):
            runs = [r[call][0] for r in ranks]
            ref = one[call][0]
            for rank, res in enumerate(runs):
                out["launches"][f"pipe_expert_cli_{axis}_{label}_rank{rank}"] = res["launches"]
                if res["launches"] != dict(zero, rasterize=PE_CACHE_LAUNCHES):
                    raise AssertionError(f"prior CLI {axis} {label} rank {rank}: launches "
                                         f"{res['launches']}, expected {PE_CACHE_LAUNCHES} "
                                         f"rasterizer launches")
            losses = [r["losses"][0] for r in runs]
            rec[label] = {"losses": losses, "loss_one_process": ref["losses"][0],
                          "loss_rel_diff": abs(losses[0] - ref["losses"][0]) / ref["losses"][0],
                          "param_max_abs_diff": diff, "param_limit": PE_CLI_PARAM_TOL,
                          "seconds": ranks[0][call][1], "seconds_one_process": one[call][1]}
            grid = os.path.join(_pe_cli(axis, True, False)[-1], "results",
                                "diffusion_samples.png")
            lines = runs[0]["stdout"].splitlines()
            what = "pipe stages" if axis == "pipe" else "expert devices"
            mesh_line = f"2-D mesh: 1 data x 2 {what}"
            if not (same and len(set(losses)) == 1 and rec[label]["loss_rel_diff"] <= 1e-5
                    and diff <= PE_CLI_PARAM_TOL and read_png_gray(grid).size
                    and mesh_line in lines and (axis == "pipe" or any(
                        line.startswith("expert parallelism: ") for line in lines))):
                raise AssertionError(f"prior CLI {axis} {label} against one process: "
                                     f"{rec[label]}; {runs[0]['stdout'][-2000:]}")
        out[f"cli_{axis}"] = rec
        log(f"prior CLI {' '.join(PE_CLI_FLAGS[axis])} (README recipe, 2,560-item cache, "
            f"DDIM-10; two ranks on one card over gloo, {card}; {PE_CONTENDED}): "
            + json.dumps(rec))
    out["seconds"] = time.perf_counter() - t0
    return out


# Phase 20: JAX's 3-D ("data", "space", "model") mesh, on one card: four ranks share
# cuda:0 over gloo, so every time here is host copies and time-slicing, not NVLink.
# Its mesh job runs beside phase 18 after phase 19 (`_m3_jobs`, in processes of its
# own: by then phase 19's processes have freed the card's memory; beside phase 19
# they ran it out), and its train and sample CLIs in phase 18's CLI stages
# (`_train_clis`), so their times are contended; the kernels, the one-process
# references and the holds run here once phase 18 is done (`phase_mesh_3d`).
M3_MESH = [1, 2, 2, "3d"]
M3_HI_STEPS, M3_HI_IMAGES = 2, 2     # one 2-image SDE-2 request: 3 evaluations, 4 rows
M3_F32_BATCH, M3_BF16_BATCH, M3_BF16_STEPS = 2, 8, 2
# a rank's rows of its channel block at 256x256, S = 2, M = 2 (4 of the 8 groups), at
# the bf16 steps' batch
M3_GN_SHAPES = [("256 down1/up1 block", (M3_BF16_BATCH, 48, 128, 256)),
                ("256 down2 block", (M3_BF16_BATCH, 96, 64, 128))]
M3_FLASH = ((M3_BF16_BATCH, 2048, 2, 48), 4096)  # 2 of the 4 heads against the gathered keys
M3_CONTENDED = ("contended: phase 20's mesh job ran beside phase 18's jobs and CLIs, so these "
                "times are not comparable with a phase run alone")


def _m3_cases() -> dict:
    """The 256x256 model (base_ch 96, stem none, param v, logsnr_shift -2.77)
    at full width: a M3_HI_IMAGES-image SDE-M3_HI_STEPS request in f32
    through ScoreModelService, one f32 step at batch M3_F32_BATCH on
    rendered images and injected (t, eps), and an epoch of M3_BF16_STEPS
    bf16 steps at batch M3_BF16_BATCH on images each rank renders."""
    from toycrystals_torch.data.datasets import generate_batch
    from toycrystals_torch.data.lattice import LatticeConfig
    from toycrystals_torch.models.sde_score_model import sample_grid_conditions
    from toycrystals_torch.models.torch_init import flax_default_init
    from toycrystals_torch.utils.params import flax_from_torch_state_dict

    kw = {k: SLICE_CFG[k] for k in ("n_types", "y_cont_dim", "base_ch", "emb_dim", "cond_ch",
                                    "time_ch")}
    model = flax_default_init(make_model("none", "float32"), np.random.default_rng(40))
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    yc, yv = (a.numpy() for a in sample_grid_conditions(M3_HI_IMAGES, 4, 4))
    r, b = np.random.default_rng(41), M3_F32_BATCH
    x0 = generate_batch(LatticeConfig(img_size=HI_SIZE, rot_only=True), 2, np.arange(b),
                        device="cpu")[0].numpy()[None]
    cases = [dict(kind="service", config=dict(HI_CFG, dtype="float32"),
                  params=flax_from_torch_state_dict(sd), buckets=(M3_HI_IMAGES,),
                  settings=dict(steps=M3_HI_STEPS), requests=[(yc, yv, 42)]),
             dict(kind="sde", model=dict(kw, stem="none"), state_dict=sd, param="v",
                  sde=dict(beta_min=0.1, beta_max=30.0, logsnr_shift=HI_CFG["logsnr_shift"]),
                  opt={"lr": TRAIN_LR, "ema": 0.999}, x0=x0,
                  y_cat=r.integers(0, 5, (1, b)).astype(np.int32),
                  y_cont=r.normal(size=(1, b, 4)).astype(np.float32),
                  t=r.uniform(0.02, 1.0, (1, b)).astype(np.float32),
                  eps=r.normal(size=x0.shape).astype(np.float32)),
             dict(kind="epoch", model=dict(kw, stem="none", dtype=torch.bfloat16),
                  state_dict=sd, param="v", opt={"lr": TRAIN_LR}, batch=M3_BF16_BATCH,
                  items=M3_BF16_BATCH * M3_BF16_STEPS,
                  lattice=dict(img_size=HI_SIZE, rot_only=True), seed=43)]
    return {"device": torch.device(DEVICE).type, "tf32": False, "cases": cases}


def _m3_jobs() -> dict:
    """Phase 20's mesh job (`_m3_cases` on the (1, 2, 2) mesh, four ranks on
    cuda:0 over gloo); uses no CUDA memory of this process."""
    four, job_s = _launch_timed(_m3_cases(), M3_MESH, 4)
    return {"four": four, "job_s": job_s}


def _m3_gn_rows(gn) -> tuple[list[dict], dict]:
    """The space pair and its backward pair at a rank's rows of its channel
    block on the 3-D mesh (M3_GN_SHAPES, 4 groups; bf16 and f32, pad off and
    on) against their plain versions, the other space rank's sums added
    here; timed beside the plain versions by CUDA events; bounds: bytes."""
    rows, headline = [], {}
    gen = torch.Generator(device=DEVICE).manual_seed(44)
    g = 4
    for label, shape in M3_GN_SHAPES:
        b, c, h, w = shape
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            elem = 2 if dtype == torch.bfloat16 else 4
            x, other = ((torch.randn(shape, generator=gen, device=DEVICE) * 2 + 0.5).to(dtype)
                        for _ in range(2))
            scale = torch.randn(c, generator=gen, device=DEVICE) * 0.1 + 1.0
            bias = torch.randn(c, generator=gen, device=DEVICE) * 0.1
            sums = gn.gn_sums(x, g) + gn.gn_sums(other, g)
            want_sums = gn.gn_sums_reference(x, g) + gn.gn_sums_reference(other, g)
            count = c // g * h * w * 2
            sums_err = float(((sums - want_sums).abs() / want_sums.abs().clamp(min=1.0)).max())
            for pad in (False, True):
                p = 1 if pad else 0
                row = dict(shape=label, dims=list(shape), groups=g, dtype=name, pad=pad,
                           sums_max_rel_err=sums_err)
                got = gn.gn_silu_apply(x, sums, count, scale, bias, g, pad=pad)
                want = gn.gn_silu_apply_reference(x, sums, count, scale, bias, g, pad=pad)
                row["max_abs_err"] = float((got.float() - want.float()).abs().max())
                atol, rtol = TOL[name]
                torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
                del got, want
                up = torch.randn((b, c, h + 2 * p, w + 2 * p), generator=gen,
                                 device=DEVICE).to(dtype)
                edge = torch.randn((b, c, 2, w + 2), generator=gen,
                                   device=DEVICE).to(dtype) if pad else None
                args = (x, up, edge, sums, count, scale, bias, g)
                chan = gn.gn_silu_backward_sums(*args, pad=pad)
                want_chan = gn.gn_silu_backward_sums_reference(*args, pad=pad)
                row["backward_sums_max_err_share"] = float(
                    (chan - want_chan).abs().max()) / float(want_chan.abs().max())
                dsums = (want_chan * scale.reshape(1, -1, 1)).reshape(b, g, -1, 2).sum(2) * 2.0
                dx = gn.gn_silu_backward_apply(x, up, edge, sums, dsums, count, scale, bias, g,
                                               pad=pad)
                want_dx = gn.gn_silu_backward_apply_reference(x, up, edge, sums, dsums, count,
                                                              scale, bias, g, pad=pad)
                row["backward_max_abs_err"] = float((dx.float() - want_dx.float()).abs().max())
                row["backward_max_abs"] = float(want_dx.float().abs().max())
                del chan, want_chan, dx, want_dx
                if not (sums_err <= 1e-5 and row["backward_sums_max_err_share"] <= GRAD_TOL[
                        "float32"] and row["backward_max_abs_err"] <= GRAD_TOL[name]
                        * row["backward_max_abs"]):
                    raise AssertionError(f"gn_silu space pairs at the 3-D block: {row}")
                read = (x.numel() + up.numel() + (0 if edge is None else edge.numel())) * elem
                row.update(
                    sums_ms=cuda_time_ms(lambda: gn.gn_sums(x, g)),
                    sums_plain_ms=cuda_time_ms(lambda: gn.gn_sums_reference(x, g), iters=5),
                    sums_bound_ms=(x.numel() * elem + b * g * 8) / HBM_BYTES_PER_S * 1e3,
                    apply_ms=cuda_time_ms(
                        lambda: gn.gn_silu_apply(x, sums, count, scale, bias, g, pad=pad)),
                    apply_plain_ms=cuda_time_ms(lambda: gn.gn_silu_apply_reference(
                        x, sums, count, scale, bias, g, pad=pad), iters=5),
                    backward_sums_ms=cuda_time_ms(lambda: gn.gn_silu_backward_sums(*args,
                                                                                  pad=pad)),
                    backward_sums_plain_ms=cuda_time_ms(
                        lambda: gn.gn_silu_backward_sums_reference(*args, pad=pad), iters=3,
                        warmup=1),
                    backward_sums_bound_ms=(read + b * c * 8) / HBM_BYTES_PER_S * 1e3,
                    backward_apply_ms=cuda_time_ms(lambda: gn.gn_silu_backward_apply(
                        x, up, edge, sums, dsums, count, scale, bias, g, pad=pad)),
                    backward_apply_plain_ms=cuda_time_ms(
                        lambda: gn.gn_silu_backward_apply_reference(
                            x, up, edge, sums, dsums, count, scale, bias, g, pad=pad), iters=3,
                        warmup=1),
                    backward_apply_bound_ms=(read + x.numel() * elem) / HBM_BYTES_PER_S * 1e3)
                row["apply_bound_ms"], row["apply_bound_by"] = gn_bound(shape, pad, elem)
                rows.append(row)
                log("kernel gn_silu space pairs at a 3-D rank's block " + json.dumps(row))
                if label == M3_GN_SHAPES[0][0] and name == "bfloat16" and pad:
                    headline = row
                del up, edge
            del x, other
    torch.cuda.empty_cache()
    return rows, headline


def _m3_flash_rows(at) -> tuple[list[dict], dict]:
    """The flash forward and backward of a rank's 2 of the 4 heads at its
    2,048 queries against the 4,096 gathered keys (M3_FLASH; bf16: wgmma,
    f32: TF32 mma, three products each) against `sdpa_reference` in f32 and
    autograd of it, timed beside them and beside
    F.scaled_dot_product_attention and its autograd."""
    rows, headline = [], {}
    clock_hz = sm_clock_max_hz()
    gen = torch.Generator(device=DEVICE).manual_seed(45)
    shape, nk = M3_FLASH
    b, n, h, d = shape
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        kv = torch.randn((b, nk, 2, h, d), generator=gen, device=DEVICE).to(dtype)
        up = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        leaves = [t.detach().requires_grad_(True) for t in (q, kv[:, :, 0], kv[:, :, 1])]
        before = (at.flash_sdpa.launches, at.flash_sdpa.backward_launches)
        out = at.flash_sdpa(*leaves)
        grads = torch.autograd.grad(out, leaves, up, retain_graph=True)
        torch.cuda.synchronize()
        if (at.flash_sdpa.launches, at.flash_sdpa.backward_launches) != \
                (before[0] + 1, before[1] + 1):
            raise AssertionError(f"flash_sdpa did not launch its kernels at {shape} / Nk {nk}")
        ref = [t.detach().float().requires_grad_(True) for t in leaves]
        want = at.sdpa_reference(*ref)
        want_g = torch.autograd.grad(want, ref, up.float())
        row = dict(dims=list(shape), nk=nk, dtype=name, tol_share=FLASH_TOL[name],
                   max_abs_err=float((out.detach().float() - want.detach()).abs().max()),
                   max_abs=float(want.detach().abs().max()))
        bad = [] if row["max_abs_err"] <= FLASH_TOL[name] * row["max_abs"] else ["out"]
        for k, got, w in zip(("dq", "dk", "dv"), grads, want_g):
            row[f"{k}_max_abs_err"] = float((got.float() - w).abs().max())
            row[f"{k}_max_abs"] = float(w.abs().max())
            if not row[f"{k}_max_abs_err"] <= FLASH_TOL[name] * row[f"{k}_max_abs"]:
                bad.append(k)
        del ref, want, want_g
        with torch.no_grad():
            row["ms"] = cuda_time_ms(lambda: at.flash_sdpa(*leaves), iters=10)
            row["plain_ms"] = cuda_time_ms(lambda: at.sdpa_reference(*leaves), iters=3,
                                           warmup=1)
            lib_leaves = [t.detach().transpose(1, 2) for t in leaves]
            row["library_ms"] = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(*lib_leaves), iters=10)
        row["backward_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(out, leaves, up, retain_graph=True), iters=10)
        plain = at.sdpa_reference(*leaves)
        row["plain_backward_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(plain, leaves, up, retain_graph=True), iters=3, warmup=1)
        del plain
        lib_leaves = [t.detach().transpose(1, 2).requires_grad_(True) for t in leaves]
        lib = F.scaled_dot_product_attention(*lib_leaves)
        row["library_backward_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(lib, lib_leaves, up.transpose(1, 2), retain_graph=True),
            iters=10)
        del lib, lib_leaves
        row["bound_ms"], row["bound_by"], row["bound_operations"] = flash_bound(
            shape, q.element_size(), False, clock_hz, nk=nk)
        row["backward_bound_ms"], row["backward_bound_by"], \
            row["backward_bound_operations"] = flash_bound(shape, q.element_size(), True,
                                                           clock_hz, nk=nk)
        rows.append(row)
        log("kernel flash_attn at a 3-D rank's heads " + json.dumps(row))
        if bad:
            raise AssertionError(f"flash at {shape} / Nk {nk} {name} disagrees in {bad}: {row}")
        if dtype == torch.bfloat16:
            headline.update(row)
        else:
            headline["f32"] = row
        del q, kv, up, leaves, out, grads
        torch.cuda.empty_cache()
    return rows, headline


def phase_mesh_3d(card: str, jobs: dict, cli: dict) -> dict:
    """Phase 20: JAX's 3-D mesh (module docstring). `jobs` is what
    `_m3_jobs` brought back from beside phase 18, `cli` what phase 18's CLI
    stages recorded of the 3-D train and sample CLIs."""
    from toycrystals_torch.ops import attention as at
    from toycrystals_torch.ops import groupnorm as gn
    from toycrystals_torch.parallel.parity import run_cases
    from toycrystals_torch.serve import ScoreModelService

    t0 = time.perf_counter()
    gib = 2.0**30
    out: dict = {"card": card, "launches": {}, "times": M3_CONTENDED, "job_s": jobs["job_s"],
                 "cli": cli}
    out["gn_rows"], out["gn_headline"] = _m3_gn_rows(gn)
    out["flash_rows"], out["flash_headline"] = _m3_flash_rows(at)
    four, spec = jobs["four"], _m3_cases()
    gc.collect()
    torch.cuda.empty_cache()
    one = run_cases({**spec, "cases": spec["cases"][1:]})
    zero = {"gn_silu": 0, "gn_silu_backward": 0, "gn_silu_sums": 0, "gn_silu_apply": 0,
            "gn_silu_backward_sums": 0, "gn_silu_backward_apply": 0, "rasterize": 0,
            "flash_attn": 0, "flash_attn_backward": 0}
    # (a) the request against the one-process service's dispatch
    evals = M3_HI_STEPS + 1
    per_dispatch = dict(zero, gn_silu_sums=10 * evals, gn_silu_apply=10 * evals,
                        flash_attn=evals)
    for rank, res in enumerate(four):
        out["launches"][f"mesh_3d_hi_rank{rank}"] = res[0]["launches"]
        if res[0]["launches"] != per_dispatch:
            raise AssertionError(f"3-D request rank {rank}: launches {res[0]['launches']}, "
                                 f"expected {per_dispatch}")
    case = spec["cases"][0]
    svc = ScoreModelService(case["config"], case["params"], device=DEVICE,
                            buckets=case["buckets"], **case["settings"])
    (y_cat, y_cont, seed), = case["requests"]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    want = _one_process_dispatch(svc, y_cat, y_cont, seed, len(y_cat))
    torch.cuda.synchronize()
    got = four[0][0]["x"][0]
    d = float(np.abs(got - want).max())
    req = {"max_abs_diff": d, "seconds": [res[0]["seconds"][0] for res in four],
           "seconds_one_process": time.perf_counter() - s0,
           "peak_bytes": [res[0].get("peak_bytes", 0) for res in four],
           "peak_bytes_one_process": int(torch.cuda.max_memory_allocated()),
           "launches_per_rank_per_dispatch": per_dispatch}
    del svc
    if not (all(np.array_equal(got, res[0]["x"][0]) for res in four)
            and got.shape == want.shape and d <= SPACE_TOL):
        raise AssertionError(f"3-D request: {d:.3e} from one process")
    out["request"] = req
    log(f"3-D 256x256 {M3_HI_IMAGES} images SDE-{M3_HI_STEPS} f32 on a (data 1, space 2, "
        f"model 2) mesh (four ranks on one card over gloo, {card}; host copies and "
        f"time-slicing, not NVLink; {M3_CONTENDED}): {d:.3e} from the one-process dispatch "
        f"(tolerance {SPACE_TOL}); seconds per rank {[round(s, 2) for s in req['seconds']]} "
        f"against {req['seconds_one_process']:.2f} in one process; peak "
        f"{' / '.join(f'{v / gib:.3f}' for v in req['peak_bytes'])} GiB against "
        f"{req['peak_bytes_one_process'] / gib:.3f}; launches per rank per dispatch "
        f"{json.dumps(per_dispatch)} (the space pair on each rank's [{2 * M3_HI_IMAGES}, 48|96, "
        f"H/2, W] channel blocks of 4 groups, flash on its 2 of the 4 heads against the "
        f"gathered keys)")
    # (b) the f32 step against one process, (c) the bf16 epoch's steps on rendered data
    for i, (name, steps) in enumerate((("f32", 1), ("bf16", M3_BF16_STEPS)), start=1):
        per_step = dict(zero, gn_silu_sums=10, gn_silu_apply=10, gn_silu_backward_sums=10,
                        gn_silu_backward_apply=10, flash_attn=1, flash_attn_backward=1,
                        rasterize=int(name == "bf16"))
        want_launches = {k: v * steps for k, v in per_step.items()}
        for rank, res in enumerate(four):
            out["launches"][f"mesh_3d_train_{name}_rank{rank}"] = res[i]["launches"]
            if res[i]["launches"] != want_launches:
                raise AssertionError(f"3-D training {name} rank {rank}: launches "
                                     f"{res[i]['launches']}, expected {want_launches}")
        r0, want = four[0][i], one[i - 1]
        rec = {"peak_bytes": [res[i].get("peak_bytes", 0) for res in four],
               "peak_bytes_one_process": want.get("peak_bytes", 0),
               "launches_per_rank_per_step": per_step}
        if name == "f32":
            if any(res[i]["losses"] != r0["losses"] for res in four):
                raise AssertionError("3-D training f32: the ranks' losses differ")
            rec.update(losses=r0["losses"], losses_one_process=want["losses"],
                       step_ms=[res[i]["step_ms"][0] for res in four],
                       step_ms_one_process=want["step_ms"][0],
                       # the parameters, both moments and the EMA, each laid out as the
                       # parameter: this rank's blocks against the whole
                       state_bytes=[4 * sum(v.nbytes for v in res[i]["shards"].values())
                                    for res in four],
                       state_bytes_one_process=4 * sum(v.nbytes
                                                       for v in want["params"].values()))
            rec["loss_rel_diff"] = abs(r0["losses"][0] - want["losses"][0]) / abs(
                want["losses"][0])
            rec["grad_worst_share"] = _leafwise(r0["grads"], want["grads"],
                                                "3-D training f32 gradient")
            rec["param_worst_share"], rec["ema_worst_share"], rec["entries_held"] = \
                _st_hold_updated(r0, want, TRAIN_LR, 0.999)
            if not rec["loss_rel_diff"] <= 1e-5:
                raise AssertionError(f"3-D training f32 against one process: {rec}")
        else:
            if len({res[i]["loss"] for res in four}) != 1 or not np.isfinite(r0["loss"]):
                raise AssertionError(f"3-D training bf16: losses {[r[i]['loss'] for r in four]}")
            rec.update(loss=r0["loss"], loss_one_process=want["loss"],
                       epoch_ms=[res[i]["epoch_ms"] for res in four],
                       epoch_ms_one_process=want["epoch_ms"])
        out[name] = rec
        log(f"3-D training 256x256 {name} at batch "
            f"{M3_F32_BATCH if name == 'f32' else M3_BF16_BATCH} on a (data 1, space 2, model 2) "
            f"mesh (four ranks on one card over gloo, {card}; host copies and time-slicing, not "
            f"NVLink; {M3_CONTENDED}): " + json.dumps(rec))
    del four, one
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json-out", default=None,
                    help="also write every measured number to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="after the main paths, profile U-Net forwards and train steps by "
                         "kernel category; phase 16 also times the space pair's kernels "
                         "by torch.profiler in a bench_gn --space process; a probe of what "
                         "torch.profiler's windows keep runs before phase 3 and after "
                         "phase 19")
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
        if args.profile:  # what the process's first profiled windows keep
            report["profiler_probe_start"] = profiler_window_probe(rz, "before phase 3")
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
            gn.gn_silu.sums_launches = gn.gn_silu.apply_launches = 0
            gn.gn_silu.backward_sums_launches = gn.gn_silu.backward_apply_launches = 0
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
        t0 = time.perf_counter()
        report["serving_rest"] = phase_serving_rest(set_counts_to_zero, counts, card, params,
                                                    report["quality"]["student_ckpt"])
        report["serving_rest"]["seconds"] = time.perf_counter() - t0
        log(f"phase 12 took {report['serving_rest']['seconds']:.1f} s")
        t0 = time.perf_counter()
        report["export_vae"] = phase_export_vae(set_counts_to_zero, counts, card, params,
                                                report["quality"]["student_ckpt"])
        report["export_vae"]["seconds"] = time.perf_counter() - t0
        log(f"phase 13 took {report['export_vae']['seconds']:.1f} s")
        t0 = time.perf_counter()
        report["prior_data"] = phase_prior_data(set_counts_to_zero, counts, card,
                                                report["export_vae"]["mop_scores"])
        report["prior_data"]["seconds"] = time.perf_counter() - t0
        log(f"phase 14 took {report['prior_data']['seconds']:.1f} s")
        report["parallel"] = phase_parallel(set_counts_to_zero, counts, card)
        log(f"phase 15 took {report['parallel']['seconds']:.1f} s")
        report["space"] = phase_space(set_counts_to_zero, counts, card, params, args.profile)
        log(f"phase 16 took {report['space']['seconds']:.1f} s")
        report["space_train"] = phase_space_train(card)
        log(f"phase 17 took {report['space_train']['seconds']:.1f} s")
        # phase 19, then phase 20's mesh job, beside phase 18: they run in processes
        # of their own, so this process's CUDA memory and counters stay phase 18's
        from concurrent.futures import ThreadPoolExecutor

        def beside_phase_18():
            return phase_pipe_expert(card), _m3_jobs()

        with ThreadPoolExecutor(1) as beside:
            side = beside.submit(beside_phase_18)
            try:
                report["tensor"] = phase_tensor(card)
                log(f"phase 18 took {report['tensor']['seconds']:.1f} s")
            finally:
                report["pipe_expert"], m3_jobs = side.result()
        log(f"phase 19 took {report['pipe_expert']['seconds']:.1f} s (beside phase 18)")
        report["mesh_3d"] = phase_mesh_3d(card, m3_jobs, report["tensor"]["cli"]["mesh_3d"])
        log(f"phase 20 took {report['mesh_3d']['seconds']:.1f} s after phase 18, its mesh job "
            f"{m3_jobs['job_s']:.1f} s beside it")
        if args.profile:  # and its last ones
            report["profiler_probe_end"] = profiler_window_probe(rz, "after phase 19")
        report["launches"] = {"serving": served, "training": trained,
                              "serving_256": served_hi, "training_256": trained_hi,
                              **report["cli"]["launches"], **report["quality"]["launches"],
                              **report["serving_rest"]["launches"],
                              **report["export_vae"]["launches"],
                              **report["prior_data"]["launches"],
                              **report["parallel"]["launches"], **report["space"]["launches"],
                              **report["space_train"]["launches"],
                              **report["tensor"]["launches"],
                              **report["pipe_expert"]["launches"],
                              **report["mesh_3d"]["launches"]}
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
        gn_space, flash_space = report["space"]["gn_headline"], report["space"]["flash_headline"]
        gn_bwd_space = report["space_train"]["gn_headline"]
        flash_bwd_space = report["space_train"]["flash_headline"]
        gn_m3, flash_m3 = report["mesh_3d"]["gn_headline"], report["mesh_3d"]["flash_headline"]
        m3_paths = report["mesh_3d"]["launches"]
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
            ("quality_student", ("gn_silu",)), ("int8_serving", ("gn_silu",)),
            ("inpaint", ("gn_silu", "rasterize")), ("http_student", ("gn_silu",)),
            ("export_sde_64", ("gn_silu",)), ("export_student", ("gn_silu",)),
            ("export_256", ("gn_silu", "flash_attn")), ("vae_train", ("rasterize",)),
            ("vae_resume", ("rasterize",)), ("build_dataset_npz", ("rasterize",)),
            ("build_dataset_pt", ("rasterize",)), ("preview_data", ("rasterize",)),
            ("train_resident", ("gn_silu", "gn_silu_backward")),
            ("train_stream", ("gn_silu", "gn_silu_backward")),
            ("train_profile", ("gn_silu", "gn_silu_backward")),
            ("prior_cache_procedural", ("rasterize",)),
            ("data_w1_ddp", ("gn_silu", "gn_silu_backward", "rasterize")),
            ("data_w1_fsdp", ("gn_silu", "gn_silu_backward", "rasterize")),
            ("data_w2_sde_rank0", ("gn_silu", "gn_silu_backward")),
            ("data_w2_sde_rank1", ("gn_silu", "gn_silu_backward")),
            ("data_w2_sde_fsdp_rank0", ("gn_silu", "gn_silu_backward")),
            ("data_w2_sde_fsdp_rank1", ("gn_silu", "gn_silu_backward")),
            ("data_w2_sample_rank0", ("gn_silu",)), ("data_w2_sample_rank1", ("gn_silu",)),
            ("space_int8_none_rank0", ("gn_silu",)), ("space_int8_s2dr_rank0", ("gn_silu",)),
            *((f"space_{name}_rank{r}", ("gn_silu_sums", "gn_silu_apply", "flash_attn"))
              for name in ("hi_f32", "hi_bf16") for r in (0, 1)),
            *((f"space_train_{name}_rank{r}", ("gn_silu_sums", "gn_silu_apply",
                                               "gn_silu_backward_sums", "gn_silu_backward_apply",
                                               "flash_attn", "flash_attn_backward"))
              for name in ("f32", "bf16") for r in (0, 1)),
            *((f"tensor_hi_rank{r}", ("gn_silu", "flash_attn")) for r in (0, 1)),
            *((f"tensor_train_{name}_rank{r}", ("gn_silu", "gn_silu_backward", "flash_attn",
                                                "flash_attn_backward"))
              for name in ("f32", "bf16") for r in (0, 1)),
            *((f"tensor_vae_rank{r}", ("rasterize",)) for r in (0, 1)),
            *((f"tensor_2d_sde_rank{r}", ("gn_silu", "gn_silu_backward")) for r in range(4)),
            *((f"tensor_2d_vae_rank{r}", ("rasterize",)) for r in range(4)),
            *((f"pipe_expert_cli_{axis}_{label}_rank{r}", ("rasterize",))
              for axis in PE_MESHES for label in ("epoch_1", "resumed") for r in (0, 1)),
            *((f"mesh_3d_hi_rank{r}", ("gn_silu_sums", "gn_silu_apply", "flash_attn"))
              for r in range(4)),
            *((f"mesh_3d_train_{name}_rank{r}", ("gn_silu_sums", "gn_silu_apply",
                                                 "gn_silu_backward_sums",
                                                 "gn_silu_backward_apply", "flash_attn",
                                                 "flash_attn_backward")
               + (("rasterize",) if name == "bf16" else ()))
              for name in ("f32", "bf16") for r in range(4)))
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
        "launches_serving_rest": {k: paths[k]["gn_silu"]
                                  for k in report["serving_rest"]["launches"]},
        "launches_export_vae": {k: paths[k]["gn_silu"] for k in report["export_vae"]["launches"]},
        "launches_prior_data": {k: paths[k]["gn_silu"] for k in report["prior_data"]["launches"]},
        "launches_parallel": {k: paths[k]["gn_silu"] for k in report["parallel"]["launches"]},
        "launches_space": {k: paths[k]["gn_silu"] for k in report["space"]["launches"]},
        "launches_tensor": {k: paths[k]["gn_silu"] for k in report["tensor"]["launches"]},
        "launches_pipe_expert": {k: paths[k]["gn_silu"]
                                 for k in report["pipe_expert"]["launches"]},
        "torch_op": "toycrystals::gn_silu (no-grad forward, eager and exported)",
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
        "launches_prior_data": {k: paths[k]["gn_silu_backward"]
                                for k in report["prior_data"]["launches"]},
        "launches_tensor": {k: paths[k]["gn_silu_backward"] for k in report["tensor"]["launches"]},
        "launches_parallel": {k: paths[k]["gn_silu_backward"]
                              for k in report["parallel"]["launches"]},
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
        "launches_serving_rest": {k: paths[k]["rasterize"]
                                  for k in report["serving_rest"]["launches"]},
        "launches_export_vae": {k: paths[k]["rasterize"]
                                for k in report["export_vae"]["launches"]},
        "launches_prior_data": {k: paths[k]["rasterize"]
                                for k in report["prior_data"]["launches"]},
        "launches_parallel": {k: paths[k]["rasterize"] for k in report["parallel"]["launches"]},
        "launches_tensor": {k: paths[k]["rasterize"] for k in report["tensor"]["launches"]},
        "launches_pipe_expert": {k: paths[k]["rasterize"]
                                 for k in report["pipe_expert"]["launches"]},
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
        "launches_export_256": paths["export_256"]["flash_attn"],
        "launches_prior_data": {k: paths[k]["flash_attn"]
                                for k in report["prior_data"]["launches"]},
        "launches_parallel": {k: paths[k]["flash_attn"] for k in report["parallel"]["launches"]},
        "launches_space": {k: paths[k]["flash_attn"] for k in report["space"]["launches"]},
        "launches_tensor": {k: paths[k]["flash_attn"] for k in report["tensor"]["launches"]},
        "launches_pipe_expert": {k: paths[k]["flash_attn"]
                                 for k in report["pipe_expert"]["launches"]},
        "launches_tensor_backward": {k: paths[k]["flash_attn_backward"]
                                     for k in report["tensor"]["launches"]},
        "torch_op": "toycrystals::flash_sdpa_fwd (no-grad forward, eager and exported)",
        "backward_pass": "three kernels: delta (one thread per row), then dK/dV and dQ "
                         "(bf16: wgmma, TMA rings, 128-row blocks of 3 warpgroups; f32: "
                         "TF32 mma.sync, three products each)",
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
        "space_at": {
            "at": f"forward, q {flash_space['dims']} against K and V of {flash_space['nk']} "
                  f"gathered keys, bf16 (a rank of the 256x256 path at S = 2)",
            "launches_per_rank_per_dispatch": SPACE_HI_STEPS + 1,
            "max_abs_err": flash_space["max_abs_err"], "ms": flash_space["ms"],
            "plain_ms": flash_space["plain_ms"], "bound_ms": flash_space["bound_ms"],
            "bound_by": flash_space["bound_by"],
            "bound_operations": flash_space["bound_operations"],
            "library_ms": flash_space["library_ms"]},
        "space_backward_at": {
            "at": f"backward (delta, dK/dV, dQ), q {flash_bwd_space['dims']} against K and V "
                  f"of {flash_bwd_space['nk']} gathered keys, bf16 (a rank of the 256x256 "
                  f"training step at S = 2)",
            "launches_space_train": {k: paths[k]["flash_attn_backward"]
                                     for k in report["space_train"]["launches"]},
            "max_abs_err": max(flash_bwd_space[f"{k}_max_abs_err"] for k in ("dq", "dk", "dv")),
            "ms": flash_bwd_space["backward_ms"], "plain_ms": flash_bwd_space["plain_backward_ms"],
            "bound_ms": flash_bwd_space["backward_bound_ms"],
            "bound_by": flash_bwd_space["bound_by"],
            "bound_operations": flash_bwd_space["backward_bound_operations"],
            "library_ms": flash_bwd_space["library_backward_ms"],
            "library_call": "autograd of F.scaled_dot_product_attention"},
        "mesh_3d_at": {
            "at": f"forward and backward, q {flash_m3['dims']} (a rank's 2 of the 4 heads at "
                  f"M = 2) against K and V of {flash_m3['nk']} gathered keys (S = 2), bf16",
            "launches_mesh_3d": {k: paths[k]["flash_attn"] for k in m3_paths},
            "launches_mesh_3d_backward": {k: paths[k]["flash_attn_backward"] for k in m3_paths},
            **{k: flash_m3[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_operations",
                "library_ms", "backward_ms", "plain_backward_ms", "backward_bound_ms",
                "backward_bound_operations", "library_backward_ms", "dq_max_abs_err",
                "dk_max_abs_err", "dv_max_abs_err")},
            "f32": {k: flash_m3["f32"][k] for k in F32_FLASH_KEYS if k in flash_m3["f32"]}},
        "f32_at": {
            "kernels": "flash_fwd_tf32, flash_dkv_tf32, flash_dq_tf32: mma.sync TF32, each "
                       "product as hi lo + lo hi + hi hi of split operands",
            **{short: {k: row[k] for k in F32_FLASH_KEYS if k in row}
               for short, row in (("s", flash_headline["serve 12 img f32"]),
                                  ("t", flash_headline["train batch 32 f32"]),
                                  ("sq", flash_space["f32"]),
                                  ("sqb", flash_bwd_space["f32"]))}},
    }, {
        "name": "gn_silu_sums", "route": "cuda", "source": "toycrystals_torch/csrc/gn_silu.cu",
        "replaces": "toycrystals_tpu/ops/groupnorm.py:53 (the statistics, under a space axis)",
        "launches": sum(path.get("gn_silu_sums", 0) for path in paths.values()),
        "launches_space": {k: paths[k]["gn_silu_sums"] for k in report["space"]["launches"]},
        "max_abs_err": gn_space["sums_max_rel_err"], "max_err_is": "relative, of each sum",
        "ms": gn_space.get("sums_kernel_ms", gn_space["sums_ms"]),
        "ms_is": "torch.profiler's kernel time under --profile, else the call's CUDA events",
        "wrapper_ms": gn_space["sums_ms"], "plain_ms": gn_space["sums_plain_ms"],
        "bound_ms": gn_space["sums_bound_ms"], "bound_by": "bytes", "library_ms": None,
        "at": f"{gn_space['shape']} {gn_space['dims']} bf16, one rank's rows at S = 2",
        "mesh_3d_at": {
            "at": f"{gn_m3['shape']} {gn_m3['dims']} bf16, {gn_m3['groups']} groups: a "
                  f"rank's rows of its channel block at S = 2, M = 2",
            "launches_mesh_3d": {k: paths[k]["gn_silu_sums"] for k in m3_paths},
            "max_abs_err": gn_m3["sums_max_rel_err"], "ms": gn_m3["sums_ms"],
            "plain_ms": gn_m3["sums_plain_ms"], "bound_ms": gn_m3["sums_bound_ms"],
            "bound_by": "bytes", "library_ms": None},
    }, {
        "name": "gn_silu_apply", "route": "cuda", "source": "toycrystals_torch/csrc/gn_silu.cu",
        "replaces": "toycrystals_tpu/ops/groupnorm.py:53 (normalise, SiLU and halo, under a "
                    "space axis)",
        "launches": sum(path.get("gn_silu_apply", 0) for path in paths.values()),
        "launches_space": {k: paths[k]["gn_silu_apply"] for k in report["space"]["launches"]},
        "max_abs_err": gn_space["max_abs_err"],
        "ms": gn_space.get("apply_kernel_ms", gn_space["apply_ms"]),
        "ms_is": "torch.profiler's kernel time under --profile, else the call's CUDA events",
        "wrapper_ms": gn_space["apply_ms"], "plain_ms": gn_space["apply_plain_ms"],
        "bound_ms": gn_space["apply_bound_ms"], "bound_by": gn_space["apply_bound_by"],
        "library_ms": None,
        "at": f"{gn_space['shape']} {gn_space['dims']} bf16 pad=True, one rank's rows at S = 2",
        "mesh_3d_at": {
            "at": f"{gn_m3['shape']} {gn_m3['dims']} bf16 pad=True, {gn_m3['groups']} groups: a "
                  f"rank's rows of its channel block at S = 2, M = 2",
            "launches_mesh_3d": {k: paths[k]["gn_silu_apply"] for k in m3_paths},
            "max_abs_err": gn_m3["max_abs_err"], "ms": gn_m3["apply_ms"],
            "plain_ms": gn_m3["apply_plain_ms"], "bound_ms": gn_m3["apply_bound_ms"],
            "bound_by": gn_m3["apply_bound_by"], "library_ms": None},
    }, {
        "name": "gn_silu_backward_sums", "route": "cuda",
        "source": "toycrystals_torch/csrc/gn_silu.cu",
        "replaces": "toycrystals_tpu/ops/groupnorm.py:155 (the custom VJP's backward: its sums, "
                    "under a space axis)",
        "launches": sum(path.get("gn_silu_backward_sums", 0) for path in paths.values()),
        "launches_space_train": {k: paths[k]["gn_silu_backward_sums"]
                                 for k in report["space_train"]["launches"]},
        "max_abs_err": gn_bwd_space["sums_max_err_share"],
        "max_err_is": "of the largest per-(item, channel) sum",
        "ms": gn_bwd_space["sums_ms"], "plain_ms": gn_bwd_space["sums_plain_ms"],
        "bound_ms": gn_bwd_space["sums_bound_ms"], "bound_by": "bytes", "library_ms": None,
        "at": f"{gn_bwd_space['shape']} {gn_bwd_space['dims']} bf16 pad=True",
        "mesh_3d_at": {
            "at": f"{gn_m3['shape']} {gn_m3['dims']} bf16 pad=True, {gn_m3['groups']} groups: a "
                  f"rank's rows of its channel block at S = 2, M = 2",
            "launches_mesh_3d": {k: paths[k]["gn_silu_backward_sums"] for k in m3_paths},
            "max_abs_err": gn_m3["backward_sums_max_err_share"], "ms": gn_m3["backward_sums_ms"],
            "plain_ms": gn_m3["backward_sums_plain_ms"],
            "bound_ms": gn_m3["backward_sums_bound_ms"], "bound_by": "bytes", "library_ms": None},
    }, {
        "name": "gn_silu_backward_apply", "route": "cuda",
        "source": "toycrystals_torch/csrc/gn_silu.cu",
        "replaces": "toycrystals_tpu/ops/groupnorm.py:155 (the custom VJP's backward: dx, under "
                    "a space axis)",
        "launches": sum(path.get("gn_silu_backward_apply", 0) for path in paths.values()),
        "launches_space_train": {k: paths[k]["gn_silu_backward_apply"]
                                 for k in report["space_train"]["launches"]},
        "max_abs_err": gn_bwd_space["max_abs_err"], "ms": gn_bwd_space["apply_ms"],
        "plain_ms": gn_bwd_space["apply_plain_ms"], "bound_ms": gn_bwd_space["apply_bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "at": f"{gn_bwd_space['shape']} {gn_bwd_space['dims']} bf16 pad=True",
        "mesh_3d_at": {
            "at": f"{gn_m3['shape']} {gn_m3['dims']} bf16 pad=True, {gn_m3['groups']} groups: a "
                  f"rank's rows of its channel block at S = 2, M = 2",
            "launches_mesh_3d": {k: paths[k]["gn_silu_backward_apply"] for k in m3_paths},
            "max_abs_err": gn_m3["backward_max_abs_err"], "ms": gn_m3["backward_apply_ms"],
            "plain_ms": gn_m3["backward_apply_plain_ms"],
            "bound_ms": gn_m3["backward_apply_bound_ms"], "bound_by": "bytes", "library_ms": None},
    }]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
