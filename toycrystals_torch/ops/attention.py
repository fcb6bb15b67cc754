"""Spatial self-attention over NCHW feature maps.

Counterpart of toycrystals_tpu/ops/attention.py on its XLA path: GroupNorm
(plain, no SiLU, eps 1e-6) -> qkv Linear split (3, heads, head_dim) on the
channel axis -> softmax(Q K^T / sqrt(d)) V -> proj Linear -> residual. Tokens
run row-major over (H, W). At the 64x64 bottleneck there are 256 tokens.
The flash path that JAX picks at >= 2048 tokens is not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from toycrystals_torch.ops.groupnorm import group_norm_f32

_FLASH_TOKENS = 2048


def gn_groups(ch: int) -> int:
    """First of 8/4/2 dividing ch, else 1."""
    for g in (8, 4, 2):
        if ch % g == 0:
            return g
    return 1


class GroupNorm(nn.Module):
    """flax GroupNorm (eps 1e-6, no SiLU), output in x.dtype."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_f32(x, self.weight, self.bias, self.groups, self.eps).to(x.dtype)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=...): input and weights cast to `dtype` per call."""
    return torch.nn.functional.linear(x.to(dtype), layer.weight.to(dtype),
                                      layer.bias.to(dtype))


class SelfAttention2d(nn.Module):
    """Multi-head self-attention over the H*W tokens of [B, C, H, W]."""

    def __init__(self, ch: int, num_heads: int = 4, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto"):
        super().__init__()
        if ch % num_heads != 0:
            raise ValueError(f"ch ({ch}) must be divisible by num_heads ({num_heads})")
        if attn_impl not in ("auto", "xla", "flash"):
            raise ValueError(f"attn_impl must be auto|xla|flash, got {attn_impl!r}")
        self.num_heads, self.dtype, self.attn_impl = num_heads, dtype, attn_impl
        self.GroupNorm_0 = GroupNorm(ch, gn_groups(ch))
        self.qkv = nn.Linear(ch, 3 * ch)
        self.proj = nn.Linear(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        if self.attn_impl == "flash" or n >= _FLASH_TOKENS:
            raise NotImplementedError(
                f"flash attention ({n} tokens, attn_impl={self.attn_impl!r}) is not "
                "ported yet: ROADMAP.md, TPU kernel 3 (flash attention at 256x256)")
        hd = c // self.num_heads
        y = self.GroupNorm_0(x).reshape(b, c, n).transpose(1, 2)        # [B, N, C]
        qkv = linear(y, self.qkv, self.dtype).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))       # [B, heads, N, hd]
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(hd))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, c)
        o = linear(o, self.proj, self.dtype)
        return x + o.transpose(1, 2).reshape(b, c, h, w)
