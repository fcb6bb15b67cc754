"""The unconditional convolutional VAE, in PyTorch.

Counterpart of toycrystals_tpu/models/vae.py:VAE, the feature extractor of
the latent FID (utils/fid.py):

- encoder: 4x Conv(k4, s2, zero pad 1) + ReLU, 1 -> 32 -> 64 -> 128 -> 256
  channels, 64x64 -> 4x4; flatten, Dense 256 + ReLU, then Dense to mu and to
  logvar;
- decoder: Dense z -> 4x4x256, 4x ConvTranspose(k4, s2, pad 1) + ReLU,
  sigmoid last: 256 -> 128 -> 64 -> 32 -> 1.

Public tensors keep the JAX layout (images [B, H, W, 1]); the network runs
NCHW inside. The flax model flattens its NHWC [B, 4, 4, 256] map in HWC
order and reshapes the decoder's Dense output as NHWC, so this module
permutes the activations at those two places and the weights carry over
with the plain per-leaf transposes of utils/params.py
(`torch_state_dict_from_flax_vae`). Submodules carry the flax names.

The conditional `CondVAE` and `kl_stats` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_ENC_CH = (32, 64, 128, 256)
_DEC_CH = (128, 64, 32, 1)
_HW, _C = 4, 256  # the encoder's last map, and the decoder's first


class _Encoder(nn.Module):
    def __init__(self, z_dim: int):
        super().__init__()
        chans = (1, *_ENC_CH)
        for i in range(4):
            self.add_module(f"Conv_{i}", nn.Conv2d(chans[i], chans[i + 1], 4, 2, 1))
        self.Dense_0 = nn.Linear(_HW * _HW * _C, 256)
        self.mu = nn.Linear(256, z_dim)
        self.logvar = nn.Linear(256, z_dim)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = x.float().permute(0, 3, 1, 2)
        for i in range(4):
            h = F.relu(getattr(self, f"Conv_{i}")(h))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flax's HWC flatten order
        h = F.relu(self.Dense_0(h))
        return self.mu(h), self.logvar(h)


class _Decoder(nn.Module):
    def __init__(self, z_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(z_dim, _HW * _HW * _C)
        chans = (_C, *_DEC_CH)
        for i in range(4):
            # flax ConvTranspose(k4, s2, "SAME") doubles the size as this does
            self.add_module(f"ConvTranspose_{i}",
                            nn.ConvTranspose2d(chans[i], chans[i + 1], 4, 2, 1))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.Dense_0(z.float())
        h = h.reshape(-1, _HW, _HW, _C).permute(0, 3, 1, 2)  # flax's NHWC reshape
        for i in range(4):
            h = getattr(self, f"ConvTranspose_{i}")(h)
            h = F.relu(h) if i < 3 else torch.sigmoid(h)
        return h.permute(0, 2, 3, 1)


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

    @staticmethod
    def reparameterise(mu: torch.Tensor, logvar: torch.Tensor,
                       generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
        """mu + exp(logvar / 2) * eps, eps from `generator` (on mu's device)
        unless given as `noise`."""
        std = torch.exp(0.5 * logvar)
        eps = noise if noise is not None else torch.randn(
            std.shape, generator=generator, device=std.device, dtype=std.dtype)
        return mu + std * eps

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None):
        mu, logvar = self.encode(x)
        z = self.reparameterise(mu, logvar, generator, noise)
        return self.decode(z), mu, logvar
