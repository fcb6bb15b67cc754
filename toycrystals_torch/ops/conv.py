"""Circular (periodic) convolution, NCHW.

Counterpart of toycrystals_tpu/ops/conv.py:CircularConv with `impl="pad"`:
wrap-pad one pixel on each side, then a VALID conv. It covers the two
geometries of the score U-Net, (k3, s1) and (k4, s2). Weights are kept in
f32 and cast to the compute dtype per call, as the JAX module does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def conv_valid(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               stride: int = 1, dtype: torch.dtype | None = None) -> torch.Tensor:
    """VALID conv in `dtype` (default x.dtype), weights cast per call."""
    dt = dtype or x.dtype
    return F.conv2d(x.to(dt), weight.to(dt), bias.to(dt), stride=stride)


class Conv2d(nn.Module):
    """VALID conv with flax-shaped parameters: `weight` [out, in, kh, kw]
    and `bias` [out] (bias starts at zero, as flax's does)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(in_ch * kernel_size * kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_valid(x, self.weight, self.bias, self.stride, self.dtype)


class CircularConv(Conv2d):
    """Conv with circular padding of 1 on each spatial side: F.pad(circular)
    plus a VALID conv. Only `impl="pad"` exists in the port so far."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32, impl: str = "pad"):
        if kernel_size - stride != 2:
            raise ValueError(f"CircularConv supports pad-1 geometries (k - s == 2), "
                             f"got kernel {kernel_size} stride {stride}")
        if impl != "pad":
            raise NotImplementedError(
                f"CircularConv impl={impl!r} is not ported yet (ROADMAP.md, "
                "'Deferred from the serving slice'); only 'pad' exists")
        super().__init__(in_ch, out_ch, kernel_size, stride, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xp = F.pad(x.to(self.dtype), (1, 1, 1, 1), mode="circular")
        return conv_valid(xp, self.weight, self.bias, self.stride, self.dtype)
