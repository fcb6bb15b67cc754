"""VP-SDE score model: conditional tiny U-Net and its samplers, in PyTorch.

Counterpart of toycrystals_tpu/models/sde_score_model.py for serving and training:

- `timestep_embedding_continuous`, `ConditionEmbedding` and `CondUNetTiny`
  (stems "none", "s2d" and "s2dr"). Public tensors keep the JAX layout (images
  [B, H, W, 1]); the network runs NCHW inside. Every conv block runs the fused
  GroupNorm+SiLU(+halo) op of ops/groupnorm.py, as the JAX `_ConvBlock` does
  with gn_impl="pallas"; `conv_impl` picks the convs (ops/conv.py).
  Submodules carry the flax names, so the weight bridge (utils/params.py) is
  a rename and a transpose per leaf.
- `draw_diffusion_loss_noise`, `diffusion_loss_eps_given` and
  `diffusion_loss_eps`: the denoising loss (eps, v and fm targets, min-SNR
  weights, CFG conditioning dropout) that the trainer differentiates.
- `VPSDE`, `eps_apply_from_v`, `predict_eps_cfg` and the samplers
  `sample_reverse_sde_euler_maruyama`, `sample_probability_flow_ode`,
  `sample_dpmpp_2m`, `sample_ddim` and the inpainting sampler
  `sample_inpaint_reverse_sde`. Each sampler but inpainting is a prologue
  (grid, initial x), one step function and an epilogue (the x0 projection);
  `run_steps` drives the step as a Python loop, or as one `scan` while
  torch.export traces it (export.py). Inpainting, which no export takes,
  keeps its Python loop. Each sampler draws its noise from the
  `torch.Generator` it is given, or takes it from `noise=`.
- `auto_chunk` and `sample_chunked`: one big sampling batch as fixed-size
  calls of a sampler, pulled to the host as they finish; on a ("data",) or
  ("data", "space") mesh each rank samples its rows of the batch and of the
  image height (parallel/spatial.py), and the ops of `CondUNetTiny` exchange
  what crosses the ranks. On a ("data", "model") mesh each rank runs its
  rows with its block of the weights (parallel/tensor.py `shard_params`),
  and every concat of the U-Net gathers its operands' channels first, so the
  channels keep the order that JAX's weights expect. On JAX's 3-D ("data",
  "space", "model") mesh a rank runs its rows of the batch and of the height
  with its block of the weights; the two kinds of exchange compose (a conv
  gathers its input over "model", then exchanges rows over "space").
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._higher_order_ops import scan

from toycrystals_torch.ops.attention import SelfAttention2d, gn_groups, linear
from toycrystals_torch.ops.conv import CircularConv, Conv2d
from toycrystals_torch.ops.groupnorm import GroupNormSiLU
from toycrystals_torch.parallel import spatial
from toycrystals_torch.parallel.mesh import AXIS, SPACE, axis_rank, axis_size, check_data_mesh
from toycrystals_torch.parallel.tensor import whole
from toycrystals_torch.utils.rng import RowGenerator, rand, randn

ApplyFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def timestep_embedding_continuous(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[cos, sin] sinusoidal embedding of t in [0, 1]: [B] -> [B, dim] f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / max(half - 1, 1))
    args = (2.0 * math.pi) * t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class ConditionEmbedding(nn.Module):
    """(y_cat, y_cont) -> conditioning vector; index n_types is the CFG null
    token, and theta (y_cont[:, 1]) becomes (sin, cos) at indices 1, 2."""

    def __init__(self, n_types: int, y_cont_dim: int, emb_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if y_cont_dim < 3:
            raise ValueError("theta_sincos requires y_cont_dim >= 3 (needs indices 1 and 2).")
        self.n_types, self.dtype = n_types, dtype
        self.cat_emb = nn.Embedding(n_types + 1, emb_dim)
        self.Dense_0 = nn.Linear(y_cont_dim, emb_dim)
        self.Dense_1 = nn.Linear(emb_dim, emb_dim)
        self.out = nn.Linear(2 * emb_dim, emb_dim)

    def forward(self, y_cat: torch.Tensor, y_cont: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y_cat = y_cat.clamp(0, self.n_types).long()
        y = y_cont.float().clone()
        theta = y[:, 1].clone()
        y[:, 1] = torch.sin(theta)
        y[:, 2] = torch.cos(theta)
        e_cat = self.cat_emb.weight.to(dt)[y_cat]
        h = linear(y, self.Dense_0, dt)
        e_cont = linear(F.silu(h), self.Dense_1, dt)
        emb = self.cat_emb.embedding_dim
        fused = F.silu(torch.cat([whole(e_cat, emb, -1), whole(e_cont, emb, -1)], dim=1))
        return linear(fused, self.out, dt)


class _ConvBlock(nn.Module):
    """conv0 (circular) -> gn0 with halo -> conv1 (VALID) -> gn1: the fused
    layout of the JAX `_ConvBlock(gn_impl="pallas")`.

    conv_impl goes to conv0; conv1 reads the halo and stays VALID, which is
    the circular conv itself, so "border" changes nothing there. Under "int8"
    conv1 quantises too, as both convs of the JAX int8 block do (JAX serves
    int8 with gn_impl "xla", where conv1 is an int8 CircularConv): the halo
    copies values, so the scale and the int8 values are the same."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32,
                 conv_impl: str = "pad"):
        super().__init__()
        g = gn_groups(out_ch)
        self.conv0 = CircularConv(in_ch, out_ch, 3, 1, dtype, impl=conv_impl)
        self.gn0 = GroupNormSiLU(out_ch, g, pad=True)
        self.conv1 = Conv2d(out_ch, out_ch, 3, 1, dtype, int8=conv_impl == "int8")
        self.gn1 = GroupNormSiLU(out_ch, g, pad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn1(self.conv1(self.gn0(self.conv0(x))))


def _space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, 4C, H/2, W/2], channels packed (dy, dx, c) as in
    JAX (F.pixel_unshuffle packs (c, dy, dx), which is not the same)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def _depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of _space_to_depth2: [B, 4C, H, W] -> [B, C, 2H, 2W]."""
    b, c4, h, w = x.shape
    c = c4 // 4
    x = x.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c, 2 * h, 2 * w)


def _bilinear_up2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample with half-pixel centres (jax.image.resize). Not
    circular, unlike every conv: edge-clamped. Under a space axis the rank's
    rows get one exchanged row on each side (the image's edge row repeated
    at its top and bottom), and the interior of the upsampled rows is kept."""
    space = spatial.current_space()
    if space is None:
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    h = x.shape[2]
    y = F.interpolate(spatial.pad_rows(x, space, circular=False), scale_factor=2,
                      mode="bilinear", align_corners=False)
    return y[:, :, 2:2 * h + 2]


class CondUNetTiny(nn.Module):
    """Tiny conditional U-Net, eps_hat = eps_theta(x_t, t, c).

    forward(x_t [B, H, W, 1], t [B], y_cat [B], y_cont [B, D]) -> [B, H, W, 1] f32.
    Parameters stay f32; `dtype` is the compute type each layer casts to.
    `conv_impl` ("pad", "border" or "int8", ops/conv.py) goes to every conv.
    """

    def __init__(self, n_types: int, y_cont_dim: int, base_ch: int = 32, emb_dim: int = 128,
                 cond_ch: int = 8, time_ch: int = 8, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", stem: str = "none", conv_impl: str = "pad"):
        super().__init__()
        if stem not in ("none", "s2d", "s2dr"):
            raise ValueError(f"stem must be none|s2d|s2dr, got {stem!r}")
        self.emb_dim, self.dtype, self.stem = emb_dim, dtype, stem
        bc = base_ch
        in_ch = 1 + time_ch + cond_ch
        trunk_in = 4 * in_ch if stem != "none" else in_ch
        self.Dense_0 = nn.Linear(emb_dim, emb_dim)
        self.Dense_1 = nn.Linear(emb_dim, emb_dim)
        self.ConditionEmbedding_0 = ConditionEmbedding(n_types, y_cont_dim, emb_dim, dtype)
        self.to_time_map = nn.Linear(emb_dim, time_ch)
        self.to_cond_map = nn.Linear(emb_dim, cond_ch)
        ci = conv_impl
        self.down1 = _ConvBlock(trunk_in, bc, dtype, ci)
        self.ds1 = CircularConv(bc, bc, 4, 2, dtype, ci)
        self.down2 = _ConvBlock(bc, 2 * bc, dtype, ci)
        self.ds2 = CircularConv(2 * bc, 2 * bc, 4, 2, dtype, ci)
        self.mid = _ConvBlock(2 * bc, 2 * bc, dtype, ci)
        self.attn = SelfAttention2d(2 * bc, num_heads=4, dtype=dtype, attn_impl=attn_impl)
        self.us2_conv = CircularConv(2 * bc, 2 * bc, 3, 1, dtype, ci)
        self.up2 = _ConvBlock(4 * bc, bc, dtype, ci)
        self.us1_conv = CircularConv(bc, bc, 3, 1, dtype, ci)
        self.up1 = _ConvBlock(2 * bc, bc, dtype, ci)
        self.out = CircularConv(bc, 4 if stem != "none" else 1, 3, 1, dtype, ci)
        if stem == "s2dr":
            self.refine1 = CircularConv(1 + in_ch, bc // 2, 3, 1, dtype, ci)
            self.refine2 = CircularConv(bc // 2, 1, 3, 1, dtype, ci)

    def forward(self, x_t: torch.Tensor, t: torch.Tensor, y_cat: torch.Tensor,
                y_cont: torch.Tensor) -> torch.Tensor:
        """Under a space axis x_t holds this rank's rows of the image height
        and so does the output."""
        b, h, w, _ = x_t.shape
        dt = self.dtype
        space = spatial.current_space()
        if space is not None:
            spatial.check_stem_divisibility(h * space.space, space.space, self.stem)
        t_emb = timestep_embedding_continuous(t, self.emb_dim).to(dt)
        t_emb = linear(t_emb, self.Dense_0, dt)
        t_emb = linear(F.silu(t_emb), self.Dense_1, dt)
        c_emb = self.ConditionEmbedding_0(y_cat, y_cont)
        maps = torch.cat([whole(linear(t_emb, self.to_time_map, dt), self.to_time_map.out_features,
                                -1),
                          whole(linear(c_emb, self.to_cond_map, dt), self.to_cond_map.out_features,
                                -1)], dim=-1)
        maps = maps[:, :, None, None].expand(b, maps.shape[1], h, w)
        x = torch.cat([x_t.to(dt).permute(0, 3, 1, 2), maps], dim=1)
        x_full = x
        if self.stem != "none":
            x = _space_to_depth2(x)

        h1 = self.down1(x)
        h2 = self.down2(self.ds1(h1))
        hh = self.attn(self.mid(self.ds2(h2)))
        c1, c2 = self.us1_conv.out_ch, self.us2_conv.out_ch
        hh = self.up2(torch.cat([whole(self.us2_conv(_bilinear_up2(hh)), c2), whole(h2, c2)],
                                dim=1))
        hh = self.up1(torch.cat([whole(self.us1_conv(_bilinear_up2(hh)), c1), whole(h1, c1)],
                                dim=1))

        out = whole(self.out(hh), self.out.out_ch)
        if self.stem != "none":
            out = _depth_to_space2(out)
            if self.stem == "s2dr":
                r = self.refine1(torch.cat([out.to(dt), x_full], dim=1))
                out = out + whole(self.refine2(F.silu(r)), 1)
        return out.float().permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# SDE
# ---------------------------------------------------------------------------


class VPSDE:
    """VP SDE with linear beta on [0, 1] and an optional log-SNR shift
    (see the JAX `VPSDE` for the shifted-schedule identities)."""

    def __init__(self, beta_min: float = 0.1, beta_max: float = 20.0,
                 logsnr_shift: float = 0.0):
        self.beta_min, self.beta_max, self.logsnr_shift = beta_min, beta_max, logsnr_shift

    def _base_beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def int_beta(self, t):
        return self.beta_min * t + 0.5 * (self.beta_max - self.beta_min) * t**2

    def _d(self, t):
        neg_i = -self.int_beta(t)
        return torch.exp(neg_i + self.logsnr_shift) - torch.expm1(neg_i)

    def beta(self, t):
        return self._base_beta(t) / self._d(t)

    def alpha(self, t):
        return torch.sqrt(torch.exp(-self.int_beta(t) + self.logsnr_shift) / self._d(t))

    def sigma(self, t):
        s2 = -torch.expm1(-self.int_beta(t)) / self._d(t)
        return torch.sqrt(s2.clamp(min=1e-8))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def draw_diffusion_loss_noise(x0: torch.Tensor, y_cat: torch.Tensor, y_cont: torch.Tensor,
                              generator: torch.Generator | None, n_types: int,
                              p_uncond: float = 0.1, t_power: float = 1.0,
                              t_shift: float = 1.0):
    """The randomness half of `diffusion_loss_eps`, for the whole batch:
    (t [B], eps like x0, y_cat, y_cont) with t = u ** t_power (t_power > 1
    biases towards small t), then `shift_t` when t_shift != 1, and the
    conditioning dropped with probability p_uncond (null token `n_types`,
    zeroed y_cont). Draws come from `generator`, which lies on x0's device;
    a `utils.rng.RowGenerator` draws the global batch and keeps its rows."""
    b, dev = x0.shape[0], x0.device
    t = rand((b,), generator, dev) ** float(t_power)
    if float(t_shift) != 1.0:
        from toycrystals_torch.models.flow_matching import shift_t

        t = shift_t(t, t_shift)
    eps = randn(x0.shape, generator, dev, x0.dtype)
    if p_uncond > 0.0:
        drop = rand((b,), generator, dev) < p_uncond
        y_cat = torch.where(drop, torch.full_like(y_cat, n_types), y_cat)
        y_cont = torch.where(drop[:, None], torch.zeros_like(y_cont), y_cont)
    return t, eps, y_cat, y_cont


def diffusion_loss_eps_given(apply_fn: ApplyFn, sde: VPSDE, x0: torch.Tensor,
                             y_cat: torch.Tensor, y_cont: torch.Tensor, t: torch.Tensor,
                             eps: torch.Tensor, parameterization: str = "eps",
                             min_snr_gamma: float = 0.0) -> torch.Tensor:
    """The deterministic half: perturb with the given (t, eps) and return the
    f32 MSE. x0 arrives in [0, 1] and is mapped to [-1, 1] here; the
    conditioning is already dropped.

    parameterization "eps": MSE(net, eps). "v": target alpha eps - sigma x0.
    "fm": the straight-line path x_t = (1 - t) x0 + t eps with velocity
    target eps - x0. min_snr_gamma > 0 scales each sample's squared error by
    min(SNR, gamma) / SNR for "eps" and min(SNR, gamma) / (SNR + 1) for "v",
    SNR = alpha^2 / sigma^2; it is not defined for "fm"."""
    if parameterization not in ("eps", "v", "fm"):
        raise ValueError(f"parameterization must be eps|v|fm, got {parameterization}")
    b = x0.shape[0]
    x0 = x0 * 2.0 - 1.0
    if parameterization == "fm":
        if min_snr_gamma > 0.0:
            raise ValueError("min-SNR weighting targets the VP objectives (eps|v); "
                             "rectified flow (fm) weights timesteps via t_shift instead")
        tb = t.reshape(b, 1, 1, 1)
        pred = apply_fn((1.0 - tb) * x0 + tb * eps, t, y_cat, y_cont)
        return ((pred.float() - (eps - x0)) ** 2).mean()
    a = sde.alpha(t).reshape(b, 1, 1, 1)
    s = sde.sigma(t).reshape(b, 1, 1, 1)
    pred = apply_fn(a * x0 + s * eps, t, y_cat, y_cont)
    target = eps if parameterization == "eps" else a * eps - s * x0
    se = (pred.float() - target) ** 2
    if min_snr_gamma > 0.0:
        snr = (a / s) ** 2
        se = se * (snr.clamp(max=min_snr_gamma) / (snr if parameterization == "eps"
                                                   else snr + 1.0))
    return se.mean()


def diffusion_loss_eps(apply_fn: ApplyFn, sde: VPSDE, x0: torch.Tensor, y_cat: torch.Tensor,
                       y_cont: torch.Tensor, generator: torch.Generator | None, n_types: int,
                       p_uncond: float = 0.1, t_power: float = 1.0,
                       parameterization: str = "eps", t_shift: float = 1.0,
                       min_snr_gamma: float = 0.0) -> torch.Tensor:
    """Denoising MSE with CFG conditioning dropout: `draw_diffusion_loss_noise`
    then `diffusion_loss_eps_given`. x0 in [0, 1], [B, H, W, 1]."""
    t, eps, y_cat, y_cont = draw_diffusion_loss_noise(
        x0, y_cat, y_cont, generator, n_types, p_uncond, t_power, t_shift)
    return diffusion_loss_eps_given(apply_fn, sde, x0, y_cat, y_cont, t, eps,
                                    parameterization, min_snr_gamma)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------


def eps_apply_from_v(sde: VPSDE, apply_fn: ApplyFn) -> ApplyFn:
    """Wrap a v-prediction model as eps: eps = sigma * x_t + alpha * v."""

    def eps_apply(x_t, t, y_cat, y_cont):
        v = apply_fn(x_t, t, y_cat, y_cont)
        return sde.sigma(t).reshape(-1, 1, 1, 1) * x_t + sde.alpha(t).reshape(-1, 1, 1, 1) * v

    return eps_apply


def predict_eps_cfg(apply_fn: ApplyFn, x_t, t, y_cat, y_cont, guidance_scale: float,
                    n_types: int) -> torch.Tensor:
    """eps_u + s (eps_c - eps_u) from one doubled batch in [uncond; cond]
    order (uncond: null token, zero y_cont); cfg <= 0 is one conditional pass."""
    if guidance_scale <= 0.0:
        return apply_fn(x_t, t, y_cat, y_cont)
    b = x_t.shape[0]
    eps2 = apply_fn(torch.cat([x_t, x_t]), torch.cat([t, t]),
                    torch.cat([torch.full_like(y_cat, n_types), y_cat]),
                    torch.cat([torch.zeros_like(y_cont), y_cont]))
    eps_u, eps_c = eps2[:b], eps2[b:]
    return eps_u + guidance_scale * (eps_c - eps_u)


def _quadratic_grid(n_steps: int, t_end: float, device=None) -> torch.Tensor:
    """ts[0] = 1 .. ts[-1] = t_end, concentrated near t_end (f32)."""
    u = torch.linspace(0.0, 1.0, n_steps + 1, dtype=torch.float32, device=device)
    return t_end + (1.0 - t_end) * (1.0 - u) ** 2


def _check_t_end(t_end: float) -> float:
    t_end = float(t_end)
    if not 0.0 < t_end < 1.0:
        raise ValueError(f"t_end must be in (0,1), got {t_end}")
    return t_end


def _x0_projection(apply_fn, sde, x, t_final, y_cat, y_cont, gs, n_types):
    """Final x0 projection, mapped to [0, 1]."""
    tb = t_final.expand(x.shape[0])
    a = sde.alpha(tb).reshape(-1, 1, 1, 1)
    s = sde.sigma(tb).reshape(-1, 1, 1, 1)
    eps_hat = predict_eps_cfg(apply_fn, x, tb, y_cat, y_cont, gs, n_types)
    x0_hat = (x - s * eps_hat) / a.clamp(min=1e-6)
    return ((x0_hat + 1.0) * 0.5).clamp(0.0, 1.0)


def _maybe_clip_eps(eps_hat, x, a, s, clip_x0: bool):
    """Static x0 thresholding: clip the implied x0 to [-1, 1], re-derive eps."""
    if not clip_x0:
        return eps_hat
    x0 = ((x - s * eps_hat) / a.clamp(min=1e-6)).clamp(-1.0, 1.0)
    return (x - a * x0) / s


def _shape(img_shape) -> tuple[int, int, int, int]:
    b, h, w, c = (int(v) for v in img_shape)
    if c != 1:
        raise ValueError(f"img_shape must be NHWC with C == 1, got {tuple(img_shape)}")
    return b, h, w, c


def _noise_tensor(noise, device) -> torch.Tensor:
    """Injected draws as an f32 tensor on `device`: a tensor that is already
    one passes as it is (an exported graph traces it), numpy is copied, and
    `StepDraws` pass through to be drawn as they are read."""
    if isinstance(noise, torch.Tensor):
        return noise.to(device=device, dtype=torch.float32)
    if isinstance(noise, StepDraws):
        return noise
    return torch.tensor(np.asarray(noise, np.float32), device=device)


def _initial_x(noise, shape, generator, device) -> torch.Tensor:
    if noise is not None:
        x = _noise_tensor(noise, device)
        if tuple(x.shape) != shape:
            raise ValueError(f"injected x has shape {tuple(x.shape)}, expected {shape}")
        return x
    return randn(shape, generator, device)


class StepDraws:
    """The per-step draws z [n, B, H, W, 1] of a sampler, taken from
    `generator` when the sampler reads them: z[i] is a fresh randn, so the
    reads must come in order 0, 1, ... (each raises otherwise). Drawing all
    n first, into one tensor or into n, made a 256-image s2dr request
    slower on the card (PERF.md); drawn at use, the kernels run in the order
    they run without injected noise."""

    def __init__(self, n: int, img_shape, generator: torch.Generator | None, device=None):
        self.shape = (int(n), *_shape(img_shape))
        self._generator, self._device, self._next = generator, device, 0

    def __getitem__(self, i: int) -> torch.Tensor:
        if i != self._next:
            raise IndexError(f"step draws are read in order: expected {self._next}, got {i}")
        self._next += 1
        return randn(self.shape[1:], self._generator, self._device)


def draw_sampler_noise(img_shape, n_z: int, generator: torch.Generator | None, device=None,
                       lazy: bool = False):
    """(x_init [B, H, W, 1], z [n_z, B, H, W, 1]) drawn from `generator` as
    a sampler draws them: x_init first, then one call per step. The per-step
    calls matter: a CUDA generator's Philox offset advances per call, so one
    draw of the whole z would give other values. n_z is the step count for
    the reverse SDE and 0 for the samplers that draw x_init alone. `lazy`
    returns z as `StepDraws`, drawn when the sampler reads each step's."""
    shape = _shape(img_shape)
    x = randn(shape, generator, device)
    if lazy:
        return x, StepDraws(n_z, shape, generator, device)
    z = torch.empty((int(n_z), *shape), device=device, dtype=torch.float32)
    for i in range(int(n_z)):
        z[i].normal_(generator=generator)  # randn's own fill, into its slot
    return x, z


def run_steps(step: Callable, carry, xs: tuple):
    """Drive a sampler's `step(carry, inputs) -> carry` over its steps: xs
    holds each step's inputs along a leading dim (the grid's (t, t_next)
    pairs, coefficients, the reverse SDE's z, which may be `StepDraws`).
    Run eagerly it is a Python loop; while torch.export traces it, it is one
    `scan`, so the exported graph holds the step once, as JAX's `lax.scan`
    does. A loop of no steps (DDIM at one step) runs nothing."""
    n = xs[0].shape[0]
    if n == 0:
        return carry
    if torch.compiler.is_exporting():
        carry, _ = scan(lambda c, inputs: (step(c, inputs), ()), carry, xs)
        return carry
    for i in range(n):
        carry = step(carry, tuple(x[i] for x in xs))
    return carry


def sample_reverse_sde_euler_maruyama(
    apply_fn: ApplyFn, sde: VPSDE, y_cat: torch.Tensor, y_cont: torch.Tensor, img_shape,
    generator: torch.Generator | None = None, n_steps: int = 200,
    guidance_scale: float = 0.0, t_end: float = 1e-3, n_types: int = 4,
    clip_x0: bool = False, noise=None,
) -> torch.Tensor:
    """Reverse-time SDE by Euler-Maruyama, t: 1 -> t_end, then the x0
    projection; returns [B, H, W, 1] in [0, 1].

    noise: optional (x_init [B, H, W, 1], z [n_steps, B, H, W, 1]) replacing
    the generator's draws (tests inject JAX's); z may be `StepDraws`."""
    t_end = _check_t_end(t_end)
    shape = _shape(img_shape)
    dev = y_cat.device
    gs = float(guidance_scale)
    ts = _quadratic_grid(n_steps, t_end, dev)
    x = _initial_x(None if noise is None else noise[0], shape, generator, dev)
    if noise is None:
        z_all = StepDraws(n_steps, shape, generator, dev)
    else:
        z_all = _noise_tensor(noise[1], dev)
        if tuple(z_all.shape) != (n_steps, *shape):
            raise ValueError(f"injected z has shape {tuple(z_all.shape)}, "
                             f"expected {(n_steps, *shape)}")
    b = shape[0]

    def step(x, inputs):
        t, t_next, z = inputs
        dt = t_next - t  # < 0
        tb = t.expand(b)
        beta_t = sde.beta(tb).reshape(b, 1, 1, 1)
        sigma_t = sde.sigma(tb).reshape(b, 1, 1, 1)
        alpha_t = sde.alpha(tb).reshape(b, 1, 1, 1)
        g = torch.sqrt(beta_t)
        eps_hat = predict_eps_cfg(apply_fn, x, tb, y_cat, y_cont, gs, n_types)
        eps_hat = _maybe_clip_eps(eps_hat, x, alpha_t, sigma_t, clip_x0)
        score = -eps_hat / sigma_t
        drift = (-0.5 * beta_t * x) - (beta_t * score)
        return x + drift * dt + g * torch.sqrt(torch.abs(dt)) * z

    x = run_steps(step, x, (ts[:-1], ts[1:], z_all))
    return _x0_projection(apply_fn, sde, x, ts[-1], y_cat, y_cont, gs, n_types)


def sample_probability_flow_ode(
    apply_fn: ApplyFn, sde: VPSDE, y_cat: torch.Tensor, y_cont: torch.Tensor, img_shape,
    generator: torch.Generator | None = None, n_steps: int = 200,
    guidance_scale: float = 0.0, t_end: float = 1e-3, n_types: int = 4,
    clip_x0: bool = False, noise=None,
) -> torch.Tensor:
    """Probability-flow ODE with Heun steps, then the x0 projection.
    noise: optional initial x [B, H, W, 1]."""
    t_end = _check_t_end(t_end)
    shape = _shape(img_shape)
    dev = y_cat.device
    b = shape[0]
    gs = float(guidance_scale)
    ts = _quadratic_grid(n_steps, t_end, dev)
    x = _initial_x(noise, shape, generator, dev)

    def drift(x, tb):
        beta_t = sde.beta(tb).reshape(b, 1, 1, 1)
        sigma_t = sde.sigma(tb).reshape(b, 1, 1, 1)
        alpha_t = sde.alpha(tb).reshape(b, 1, 1, 1)
        eps_hat = predict_eps_cfg(apply_fn, x, tb, y_cat, y_cont, gs, n_types)
        eps_hat = _maybe_clip_eps(eps_hat, x, alpha_t, sigma_t, clip_x0)
        score = -eps_hat / sigma_t
        return -0.5 * beta_t * x - 0.5 * beta_t * score

    def step(x, inputs):
        t, t_next = inputs
        dt = t_next - t
        d1 = drift(x, t.expand(b))
        d2 = drift(x + d1 * dt, t_next.expand(b))
        return x + 0.5 * (d1 + d2) * dt

    x = run_steps(step, x, (ts[:-1], ts[1:]))
    return _x0_projection(apply_fn, sde, x, ts[-1], y_cat, y_cont, gs, n_types)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """numpy's `interp` for ascending xp: piecewise linear, clamped at the ends."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    dx = xp[i] - xp[i - 1]
    flat = dx.abs() <= torch.finfo(xp.dtype).tiny
    f = fp[i - 1] + ((x - xp[i - 1]) / torch.where(flat, torch.ones_like(dx), dx)) \
        * (fp[i] - fp[i - 1])
    f = torch.where(flat, fp[i - 1], f)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _log_snr_half(sde: VPSDE, t: torch.Tensor) -> torch.Tensor:
    """lambda(t) = log(alpha / sigma), the DPM-Solver time."""
    a, s = sde.alpha(t), sde.sigma(t)
    return 0.5 * (torch.log((a * a).clamp(min=1e-20)) - torch.log(s * s))


def _uniform_lambda_grid(sde: VPSDE, n_steps: int, t_end: float, device=None):
    """(ts, lam_grid), each [n_steps + 1] f32: lambda uniform from t = 1 to
    t_end, and the times it is reached at, inverted numerically from the
    schedule over 4,097 points (so logsnr_shift flows through unchanged)."""
    ts_dense = torch.linspace(t_end, 1.0, 4097, dtype=torch.float32, device=device)
    lam_dense = _log_snr_half(sde, ts_dense)  # descending in t: ascending when reversed
    ends = _log_snr_half(sde, torch.tensor([1.0, t_end], dtype=torch.float32, device=device))
    lam_grid = torch.linspace(0.0, 1.0, n_steps + 1, dtype=torch.float32, device=device) \
        * (ends[1] - ends[0]) + ends[0]
    ts = _interp(lam_grid, lam_dense.flip(0), ts_dense.flip(0))
    ts[0], ts[-1] = 1.0, t_end
    return ts, lam_grid


def sample_dpmpp_2m(
    apply_fn: ApplyFn, sde: VPSDE, y_cat: torch.Tensor, y_cont: torch.Tensor, img_shape,
    generator: torch.Generator | None = None, n_steps: int = 50,
    guidance_scale: float = 0.0, t_end: float = 1e-3, n_types: int = 4,
    clip_x0: bool = False, noise=None,
) -> torch.Tensor:
    """DPM-Solver++(2M): second-order multistep ODE solver in log-SNR time
    with data (x0) prediction, on a uniform-lambda grid from t = 1 to t_end,
    then the x0 projection. Deterministic given the initial x.

        h_i = lam_i - lam_{i-1},  r_i = h_{i-1} / h_i
        D_i = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}      (first step: x0_i)
        x_i = (sigma_i / sigma_{i-1}) x_{i-1} - alpha_i expm1(-h_i) D_i

    `clip_x0` clips the predicted x0 directly (the solver works in x0 form).
    noise: optional initial x [B, H, W, 1]."""
    t_end = _check_t_end(t_end)
    shape = _shape(img_shape)
    dev = y_cat.device
    b = shape[0]
    gs = float(guidance_scale)
    ts, lam_grid = _uniform_lambda_grid(sde, n_steps, t_end, dev)
    x = _initial_x(noise, shape, generator, dev)

    def x0_pred(x, t):
        tb = t.expand(b)
        a = sde.alpha(tb).reshape(b, 1, 1, 1)
        s = sde.sigma(tb).reshape(b, 1, 1, 1)
        eps = predict_eps_cfg(apply_fn, x, tb, y_cat, y_cont, gs, n_types)
        x0 = (x - s * eps) / a.clamp(min=1e-6)
        return x0.clamp(-1.0, 1.0) if clip_x0 else x0

    h = lam_grid[1:] - lam_grid[:-1]
    # D_i = c_m m_i - c_prev m_{i-1}: (1, 0) at the first step, which has no
    # m_{i-1} (its m_prev is zeros, so D is m_0 bit for bit)
    inv_2r = 1.0 / (2.0 * (h[:-1] / h[1:]))
    c_m, c_prev = torch.cat([h.new_ones(1), 1.0 + inv_2r]), torch.cat([h.new_zeros(1), inv_2r])

    def step(carry, inputs):
        x, m_prev = carry
        t_cur, t_next, h_step, cm, cp = inputs
        m = x0_pred(x, t_cur)
        d = cm * m - cp * m_prev
        x = (sde.sigma(t_next) / sde.sigma(t_cur)) * x \
            - sde.alpha(t_next) * torch.expm1(-h_step) * d
        return x, m

    x, _ = run_steps(step, (x, torch.zeros_like(x)), (ts[:-1], ts[1:], h, c_m, c_prev))
    return _x0_projection(apply_fn, sde, x, ts[-1], y_cat, y_cont, gs, n_types)


def sample_ddim(
    apply_fn: ApplyFn, sde: VPSDE, y_cat: torch.Tensor, y_cont: torch.Tensor, img_shape,
    generator: torch.Generator | None = None, n_steps: int = 4,
    guidance_scale: float = 0.0, t_end: float = 1e-3, n_types: int = 4,
    clip_x0: bool = False, prediction: str = "eps", noise=None,
) -> torch.Tensor:
    """Deterministic DDIM on the quadratic grid, exactly `n_steps` model
    evaluations; the last one returns x0_hat directly (the few-step sampler
    of distilled students). noise: optional initial x [B, H, W, 1]."""
    t_end = _check_t_end(t_end)
    if prediction not in ("eps", "v"):
        raise ValueError(f"prediction must be eps|v, got {prediction}")
    shape = _shape(img_shape)
    dev = y_cat.device
    b = shape[0]
    gs = float(guidance_scale)
    ts = _quadratic_grid(n_steps, t_end, dev)
    x = _initial_x(noise, shape, generator, dev)

    def x0_eps(x, tb):
        a = sde.alpha(tb).reshape(b, 1, 1, 1)
        s = sde.sigma(tb).reshape(b, 1, 1, 1)
        raw = predict_eps_cfg(apply_fn, x, tb, y_cat, y_cont, gs, n_types)
        if prediction == "v":
            x0, eps = a * x - s * raw, s * x + a * raw
        else:
            eps = raw
            x0 = (x - s * eps) / a.clamp(min=1e-6)
        if clip_x0:
            x0 = x0.clamp(-1.0, 1.0)
            eps = (x - a * x0) / s
        return x0, eps

    def step(x, inputs):
        t, t_next = inputs
        tb, tn = t.expand(b), t_next.expand(b)
        x0, eps = x0_eps(x, tb)
        a_n = sde.alpha(tn).reshape(b, 1, 1, 1)
        s_n = sde.sigma(tn).reshape(b, 1, 1, 1)
        if prediction == "v" or clip_x0:
            x = a_n * x0 + s_n * eps
        else:
            # alpha-ratio form: no ill-conditioned x0 division at large t
            a_t = sde.alpha(tb).reshape(b, 1, 1, 1)
            s_t = sde.sigma(tb).reshape(b, 1, 1, 1)
            x = (a_n / a_t.clamp(min=1e-6)) * (x - s_t * eps) + s_n * eps
        return x

    # the last evaluation returns x0 itself; at one step there is no loop
    x = run_steps(step, x, (ts[:-2], ts[1:-1]))
    x0, _ = x0_eps(x, ts[-2].expand(b))
    return ((x0 + 1.0) * 0.5).clamp(0.0, 1.0)


def sample_inpaint_reverse_sde(
    apply_fn: ApplyFn, sde: VPSDE, y_cat: torch.Tensor, y_cont: torch.Tensor, img_shape,
    generator: torch.Generator | None = None, n_steps: int = 300,
    guidance_scale: float = 0.0, t_end: float = 1e-3, n_types: int = 4, resample: int = 1,
    clip_x0: bool = False, noise=None, *, x_known, mask,
) -> torch.Tensor:
    """Inpainting by the reverse SDE: the Euler-Maruyama step of
    `sample_reverse_sde_euler_maruyama`, after which the known region is
    replaced by an exact forward-marginal sample of x_known at t_next. With
    `resample` > 1, every repeat of a step but the last diffuses the merged
    image back to t by the exact VP bridge q(x_t | x_t_next) (RePaint) and the
    step runs again. Then the x0 projection.

    x_known [B, H, W, 1] in data space [0, 1] (clipped there, mapped to
    [-1, 1] inside); mask [B, H, W, 1], 1 = keep from x_known, 0 = generate.
    The result equals clip(x_known) exactly where mask is 1.
    noise: optional (x_init [B, H, W, 1], draws [n_steps, resample, 3, B, H,
    W, 1]) replacing the generator's draws; draws[i, r] holds the step's z,
    the known region's zk and the bridge's z2 (tests inject JAX's
    fold_in(fold_in(fold_in(k_noise, i), r), 0|1|2) draws)."""
    t_end = _check_t_end(t_end)
    if resample < 1:
        raise ValueError(f"resample must be >= 1, got {resample}")
    shape = _shape(img_shape)
    dev = y_cat.device
    b = shape[0]
    gs = float(guidance_scale)
    x_known = torch.as_tensor(x_known, dtype=torch.float32, device=dev).clamp(0.0, 1.0)
    x0k = x_known * 2.0 - 1.0
    mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    ts = _quadratic_grid(n_steps, t_end, dev)
    x = _initial_x(None if noise is None else noise[0], shape, generator, dev)
    draws = None
    if noise is not None:
        draws = _noise_tensor(noise[1], dev)
        if tuple(draws.shape) != (n_steps, resample, 3, *shape):
            raise ValueError(f"injected draws have shape {tuple(draws.shape)}, expected "
                             f"{(n_steps, resample, 3, *shape)}")

    def draw(i: int, r: int, k: int) -> torch.Tensor:
        if draws is not None:
            return draws[i, r, k]
        return randn(shape, generator, dev)

    for i in range(n_steps):
        t, t_next = ts[i], ts[i + 1]
        dt = t_next - t  # < 0
        tb, tn = t.expand(b), t_next.expand(b)
        beta_t = sde.beta(tb).reshape(b, 1, 1, 1)
        a_t = sde.alpha(tb).reshape(b, 1, 1, 1)
        s_t = sde.sigma(tb).reshape(b, 1, 1, 1)
        a_n = sde.alpha(tn).reshape(b, 1, 1, 1)
        s_n = sde.sigma(tn).reshape(b, 1, 1, 1)
        for r in range(resample):
            eps_hat = predict_eps_cfg(apply_fn, x, tb, y_cat, y_cont, gs, n_types)
            eps_hat = _maybe_clip_eps(eps_hat, x, a_t, s_t, clip_x0)
            score = -eps_hat / s_t
            drift = (-0.5 * beta_t * x) - (beta_t * score)
            x = x + drift * dt + torch.sqrt(beta_t) * torch.sqrt(torch.abs(dt)) * draw(i, r, 0)
            # the known region: the exact forward marginal of x_known at t_next
            x = mask * (a_n * x0k + s_n * draw(i, r, 1)) + (1.0 - mask) * x
            if r < resample - 1:
                ratio = a_t / a_n.clamp(min=1e-6)
                sig = torch.sqrt((s_t**2 - ratio**2 * s_n**2).clamp(min=0.0))
                x = ratio * x + sig * draw(i, r, 2)
    x0 = _x0_projection(apply_fn, sde, x, ts[-1], y_cat, y_cont, gs, n_types)
    return mask * x_known + (1.0 - mask) * x0


def auto_chunk(img_size: int, n_steps: int, sampler: str = "sde") -> int:
    """The per-call sample batch the JAX package uses to keep one compiled
    sampling scan under its backend's per-dispatch duration cap: 12 images at
    256x256 and 300 steps, scaled by model evaluations times pixels. Heun
    ("ode") runs 2 model evaluations per step, the other samplers 1. The card
    has no such cap; callers here use it to run the reference's call shapes."""
    evals = n_steps * (2 if sampler == "ode" else 1)
    budget = 12 * 300 * (256 // 64) ** 2  # images * evals * (px/64)^2
    scale = max(1, (img_size + 63) // 64) ** 2
    return max(1, budget // max(1, evals * scale))


def chunk_seed(seed: int, start: int) -> int:
    """Generator seed of the chunk that starts at condition row `start` of a
    request with `seed`: seed * 2**32 + start, one distinct 63-bit value per
    (seed < 2**31, start < 2**32). Takes the place of folding the start index
    into a JAX key."""
    seed, start = int(seed), int(start)
    if not (0 <= seed < 2**31 and 0 <= start < 2**32):
        raise ValueError(f"need 0 <= seed < 2**31 and 0 <= start < 2**32, got {seed}, {start}")
    return (seed << 32) + start


def sample_chunked(sampler_fn: Callable[..., torch.Tensor], apply_fn: ApplyFn, sde: VPSDE,
                   y_cat: torch.Tensor, y_cont: torch.Tensor, img_shape, seed: int, *,
                   chunk: int, mesh=None, batch_kw: dict[str, torch.Tensor] | None = None,
                   **kw) -> np.ndarray:
    """Split one big sampling batch into calls of exactly `chunk` images.

    The last, short chunk is padded by repeating its last condition row and
    trimmed after. Each chunk draws from a fresh `torch.Generator` on the
    conditions' device, seeded with `chunk_seed(seed, start)` (results are
    statistically identical to, but differ from, one unchunked call). Chunks
    are pulled to the host as they finish; returns an np.ndarray.

    batch_kw: extra per-item tensors (leading dim == n) passed to sampler_fn
    by keyword, sliced and padded per chunk like the condition rows.

    On a `mesh` (parallel/) the chunk is first rounded up to a multiple of
    the data axis (the space axis splits the height, not the batch, as in
    JAX); every rank draws each chunk's noise for the whole chunk and keeps
    its rows of the batch and, on a ("data", "space") mesh, of the image
    height (`RowGenerator`), as do the images of `batch_kw` (tensors whose
    shape ends in (H, W, C): x_known and mask, or injected draws). The
    sampler runs in the mesh's dispatch scope (parallel/spatial.py), and the
    parts are gathered back to every rank, so each rank returns the whole,
    unsharded result. `apply_fn` is each rank's whole model, or on a mesh
    with a "model" axis ("data", "model", or JAX's 3-D ("data", "space",
    "model")) its model placed by parallel/tensor.py `shard_params`: the
    model ranks of a (data, space) coordinate then sample the same rows with
    the same draws, and the gather runs over the D S ranks of the rank's
    model coordinate."""
    n, h, w, c = _shape(img_shape)
    chunk = max(1, min(int(chunk), n))
    rows, hs = slice(0, h), None
    if mesh is not None:
        check_data_mesh(mesh, space=True, model=True)
        m = axis_size(mesh, AXIS)
        chunk = -(-chunk // m) * m
        lo = axis_rank(mesh, AXIS) * (chunk // m)
        mine = slice(lo, lo + chunk // m)
        if axis_size(mesh, SPACE) > 1:
            rows = hs = spatial.space_rows(mesh, h)
    else:
        mine = slice(0, chunk)
    dev = y_cat.device

    def pad(a, k):
        return a if k == 0 else torch.cat([a, a[-1:].repeat_interleave(k, dim=0)], dim=0)

    def local(a):  # this rank's rows; and of H, for images [.., H, W, C]
        a = a[mine]
        if hs is None or tuple(a.shape[-3:]) != (h, w, c):
            return a
        return a[(slice(None),) * (a.dim() - 3) + (rows,)]

    outs = []
    for i0 in range(0, n, chunk):
        take = min(chunk, n - i0)
        bkw = {k: local(pad(v[i0:i0 + take], chunk - take)) for k, v in (batch_kw or {}).items()}
        gen = torch.Generator(device=dev).manual_seed(chunk_seed(seed, i0))
        if mesh is not None:
            gen = RowGenerator(gen, mine.start, mine.stop, chunk,
                               *((hs.start, hs.stop, h) if hs is not None else ()))
        with spatial.dispatch_scope(mesh):
            x = sampler_fn(apply_fn, sde, pad(y_cat[i0:i0 + take], chunk - take)[mine],
                           pad(y_cont[i0:i0 + take], chunk - take)[mine],
                           (mine.stop - mine.start, rows.stop - rows.start, w, c), gen,
                           **kw, **bkw)
        outs.append(spatial.gather_image(mesh, x)[:take].cpu().numpy())
    return np.concatenate(outs, axis=0)


def sample_grid_conditions(n: int, n_types: int, y_cont_dim: int,
                           theta_max: float = math.pi / 3.0, device=None):
    """The 6x6 figure-grid convention: cycle lattice types, sweep theta."""
    y_cat = torch.arange(n, dtype=torch.int32, device=device) % n_types
    y_cont = torch.zeros((n, y_cont_dim), dtype=torch.float32, device=device)
    y_cont[:, 1] = torch.linspace(0.0, theta_max, n, device=device)
    return y_cat, y_cont
