"""The conditional and unconditional convolutional VAEs, in PyTorch.

Counterpart of toycrystals_tpu/models/vae.py. `VAE` is also the feature
extractor of the latent FID (utils/fid.py); `CondVAE` is the first stage of
the VAE pipeline (scripts/train_vae.py):

- encoder: 4x Conv(k4, s2, zero pad 1) + ReLU, 1 -> 32 -> 64 -> 128 -> 256
  channels, 64x64 -> 4x4; flatten, (CondVAE: concat the cond vector), Dense
  256 + ReLU, then Dense to mu and to logvar;
- decoder: (CondVAE: z ++ cond vector) Dense -> 4x4x256, 4x ConvTranspose(k4,
  s2, pad 1) + ReLU, sigmoid last: 256 -> 128 -> 64 -> 32 -> 1;
- the cond vector is one_hot(y_cat, n_types) ++ y_cont; `cond_drop` is a
  per-sample Bernoulli mask zeroing the whole vector in decode only, in
  training only;
- `kl_stats`: the batch-averaged KL with free bits (nats per latent dim).

Public tensors keep the JAX layout (images [B, H, W, 1]); the network runs
NCHW inside. The flax model flattens its NHWC [B, 4, 4, 256] map in HWC
order and reshapes the decoder's Dense output as NHWC, so this module
permutes the activations at those two places and the weights carry over
with the plain per-leaf transposes of utils/params.py
(`torch_state_dict_from_flax_vae`); the cond vector's columns follow the
4,096 HWC ones, as in flax. Submodules carry the flax names. The draws
(the reparameterisation's eps, then the cond-drop mask) come from an
explicit `torch.Generator`, or are injected (`noise=`, `keep=`). The math is
f32: the JAX module's `dtype` knob is not ported.

Under a "model" axis (parallel/tensor.py; the train step's dispatch scope)
each conv, transposed conv and dense layer whose weight the trailing-dim rule
shards computes the rank's block of its output channels or features from
the whole input, and the next layer gathers them. Three consumers gather
first: the encoder's HWC flatten (a channel block is no block of the
flattened features), the decoder's reshape of its dense output (a contiguous
block of its 4,096 HWC columns is a band of rows, not of channels), and the
reparameterisation and the KL (mu and logvar whole). The last transposed
conv (1 channel) stays whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from toycrystals_torch.parallel import tensor as tp
from toycrystals_torch.utils.rng import rand, randn

_ENC_CH = (32, 64, 128, 256)
_DEC_CH = (128, 64, 32, 1)
_HW, _C = 4, 256  # the encoder's last map, and the decoder's first


class _Encoder(nn.Module):
    def __init__(self, z_dim: int, y_dim: int = 0):
        super().__init__()
        chans = (1, *_ENC_CH)
        for i in range(4):
            self.add_module(f"Conv_{i}", nn.Conv2d(chans[i], chans[i + 1], 4, 2, 1))
        self.Dense_0 = nn.Linear(_HW * _HW * _C + y_dim, 256)
        self.mu = nn.Linear(256, z_dim)
        self.logvar = nn.Linear(256, z_dim)

    def forward(self, x: torch.Tensor,
                y: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        h = x.float().permute(0, 3, 1, 2)
        for i in range(4):
            conv = getattr(self, f"Conv_{i}")
            h = F.relu(tp.apply(conv, h, conv.in_channels))
        h = tp.whole(h, _C)  # every channel before the flatten
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flax's HWC flatten order
        if y is not None:
            h = torch.cat([h, y], dim=1)
        h = F.relu(tp.dense(self.Dense_0, h))
        return tp.dense(self.mu, h), tp.dense(self.logvar, h)


class _Decoder(nn.Module):
    def __init__(self, z_dim: int, y_dim: int = 0):
        super().__init__()
        self.Dense_0 = nn.Linear(z_dim + y_dim, _HW * _HW * _C)
        chans = (_C, *_DEC_CH)
        for i in range(4):
            # flax ConvTranspose(k4, s2, "SAME") doubles the size as this does
            self.add_module(f"ConvTranspose_{i}",
                            nn.ConvTranspose2d(chans[i], chans[i + 1], 4, 2, 1))

    def forward(self, z: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
        h = z.float() if y is None else torch.cat([z.float(), y], dim=1)
        h = tp.dense(self.Dense_0, h)  # every column before the reshape
        h = h.reshape(-1, _HW, _HW, _C).permute(0, 3, 1, 2)  # flax's NHWC reshape
        for i in range(4):
            conv = getattr(self, f"ConvTranspose_{i}")
            h = tp.apply(conv, h, conv.in_channels)
            h = F.relu(h) if i < 3 else torch.sigmoid(h)
        return h.permute(0, 2, 3, 1)


def _reparameterise(mu: torch.Tensor, logvar: torch.Tensor,
                    generator: torch.Generator | None = None,
                    noise: torch.Tensor | None = None) -> torch.Tensor:
    """mu + exp(logvar / 2) * eps, eps from `generator` (on mu's device)
    unless given as `noise`."""
    std = torch.exp(0.5 * logvar)
    eps = noise if noise is not None else randn(std.shape, generator, std.device, std.dtype)
    return mu + std * eps


def _y_vec(y_cat: torch.Tensor, y_cont: torch.Tensor, n_types: int) -> torch.Tensor:
    """The cond vector one_hot(y_cat, n_types) ++ y_cont, f32 [B, n_types + D]."""
    y_oh = F.one_hot(y_cat.long(), n_types).float()
    return torch.cat([y_oh, y_cont.float()], dim=1)


class CondVAE(nn.Module):
    """Conditional VAE in f32. encode(x [B, 64, 64, 1], y_cat, y_cont) ->
    (mu, logvar) [B, z_dim]; decode(z, y_cat, y_cont) -> [B, 64, 64, 1] in
    (0, 1); forward -> (x_hat, mu, logvar)."""

    def __init__(self, z_dim: int = 16, n_types: int = 4, y_cont_dim: int = 4,
                 cond_drop: float = 0.1):
        super().__init__()
        self.z_dim, self.n_types, self.y_cont_dim = z_dim, n_types, y_cont_dim
        self.cond_drop = float(cond_drop)
        self.encoder = _Encoder(z_dim, self.y_dim)
        self.decoder = _Decoder(z_dim, self.y_dim)

    @property
    def y_dim(self) -> int:
        return self.n_types + self.y_cont_dim

    def encode(self, x, y_cat, y_cont) -> tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(x, _y_vec(y_cat, y_cont, self.n_types))

    reparameterise = staticmethod(_reparameterise)

    def decode(self, z, y_cat, y_cont, train: bool = False,
               generator: torch.Generator | None = None,
               keep: torch.Tensor | None = None) -> torch.Tensor:
        """With `train` and cond_drop > 0, each row's cond vector is kept
        where a uniform draw from `generator` is >= cond_drop (or where the
        injected `keep` [B, 1] is 1) and zeroed elsewhere."""
        y = _y_vec(y_cat, y_cont, self.n_types)
        if train and self.cond_drop > 0.0:
            if keep is None:
                keep = rand((y.shape[0], 1), generator, y.device) >= self.cond_drop
            y = y * keep.to(y.dtype)
        return self.decoder(z, y)

    def forward(self, x, y_cat, y_cont, train: bool = False,
                generator: torch.Generator | None = None, noise: torch.Tensor | None = None,
                keep: torch.Tensor | None = None):
        """Draws eps, then (training) the cond-drop mask, from `generator`."""
        mu, logvar = self.encode(x, y_cat, y_cont)
        z = self.reparameterise(mu, logvar, generator, noise)
        x_hat = self.decode(z, y_cat, y_cont, train=train, generator=generator, keep=keep)
        return x_hat, mu, logvar


class VAE(nn.Module):
    """Unconditional VAE in f32: encode(x [B, 64, 64, 1]) -> (mu, logvar)
    [B, z_dim]; decode(z) -> [B, 64, 64, 1] in (0, 1)."""

    def __init__(self, z_dim: int = 16):
        super().__init__()
        self.z_dim = z_dim
        self.encoder = _Encoder(z_dim)
        self.decoder = _Decoder(z_dim)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(x)

    reparameterise = staticmethod(_reparameterise)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None):
        mu, logvar = self.encode(x)
        z = self.reparameterise(mu, logvar, generator, noise)
        return self.decode(z), mu, logvar


def kl_stats(mu: torch.Tensor, logvar: torch.Tensor,
             free_bits: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(kl used in the loss, raw kl), each the batch mean of the per-sample
    sum over latent dims of 0.5 (mu^2 + exp(logvar) - 1 - logvar); with
    free_bits > 0 each dim's term is floored at free_bits nats first."""
    kl_dim = 0.5 * (mu ** 2 + torch.exp(logvar) - 1.0 - logvar)
    kl_raw = kl_dim.sum(dim=1).mean()
    if free_bits > 0.0:
        return kl_dim.clamp(min=free_bits).sum(dim=1).mean(), kl_raw
    return kl_raw, kl_raw
