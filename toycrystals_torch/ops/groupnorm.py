"""Fused GroupNorm + SiLU (+ 1-pixel circular halo) over NCHW activations.

Counterpart of toycrystals_tpu/ops/groupnorm.py. Every conv block of the
score U-Net ends its convs in this op; with `pad=True` it writes the
[H+2, W+2] circular-padded plane so the following conv runs VALID with no
separate wrap-pad copy.

- `gn_silu_reference` is the plain PyTorch version of the JAX formula: f32
  statistics, fast variance E[x^2] - E[x]^2 clipped at 0, eps 1e-6 (torch's
  `F.group_norm` uses eps 1e-5 and a two-pass variance, so it is not used).
- `gn_silu` launches the hand-written CUDA kernel (csrc/gn_silu.cu) on a CUDA
  tensor and runs the plain version on a CPU tensor. There is no other
  branch: a failed build or launch raises. `gn_silu.launches` counts kernel
  launches.

Under autograd the forward on a CUDA tensor still launches the kernel, inside
a `torch.autograd.Function` that saves (x, scale, bias); its backward
differentiates the plain version (circular pad included, so the halo's
gradient folds back onto the opposite edge), as the JAX op's custom VJP
differentiates its jnp reference. There is no backward kernel yet. On the CPU
the plain version runs under ordinary autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch import nn

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def group_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """flax GroupNorm over [B, C, ...] in f32: f32 statistics, fast variance
    E[x^2] - E[x]^2 clipped at 0, then the per-channel affine."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    var = ((xf * xf).mean(dim=2, keepdim=True) - mean * mean).clamp(min=0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * scale.float().reshape(shape) + bias.float().reshape(shape)


def gn_silu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      groups: int, eps: float = 1e-6, pad: bool = False) -> torch.Tensor:
    """Plain version. x: [B, C, H, W]; scale/bias: [C]. Returns x.dtype,
    [B, C, H+2, W+2] with the circular halo when `pad`."""
    y = F.silu(group_norm_f32(x, scale, bias, groups, eps)).to(x.dtype)
    return F.pad(y, (1, 1, 1, 1), mode="circular") if pad else y


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (first use builds)."""
    from toycrystals_torch.utils.cuda_build import load

    lib = load("gn_silu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gn_silu_launch.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, p]
    lib.gn_silu_launch.restype = i
    lib.gn_silu_error_string.argtypes = [i]
    lib.gn_silu_error_string.restype = ctypes.c_char_p
    return lib


def _gn_silu_cuda(x, scale, bias, groups: int, eps: float, pad: bool) -> torch.Tensor:
    if x.dim() != 4:
        raise ValueError(f"gn_silu expects [B, C, H, W], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"gn_silu kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gn_silu kernel needs a contiguous NCHW tensor")
    b, c, h, w = x.shape
    if groups <= 0 or c % groups:
        raise ValueError(f"channels ({c}) must divide into groups ({groups})")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must be [{c}], got {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu kernel needs a CUDA tensor, got {x.device}")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    p = 1 if pad else 0
    out = torch.empty((b, c, h + 2 * p, w + 2 * p), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gn_silu_launch(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), b, c, h, w, groups, float(eps), p,
                                 _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"gn_silu kernel launch failed: "
                           f"{lib.gn_silu_error_string(err).decode()} ({err})")
    gn_silu.launches += 1
    return out


class _GnSiluKernel(torch.autograd.Function):
    """Kernel forward; backward = gradient of the plain version at the saved
    inputs (one recomputed plain forward per backward)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, pad):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, pad)
        return _gn_silu_cuda(x, scale, bias, groups, eps, pad)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            y = gn_silu_reference(*leaves, *ctx.args)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(y, wanted, grad_out))
        return (*(next(grads) if n else None for n in need), None, None, None)


def gn_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
            eps: float = 1e-6, pad: bool = False) -> torch.Tensor:
    """Fused GroupNorm+SiLU over [B, C, H, W]; `pad=True` returns the
    circular-padded [B, C, H+2, W+2] output. CUDA tensors run the kernel
    (differentiable: see `_GnSiluKernel`), CPU tensors the plain version."""
    if x.device.type == "cpu":
        return gn_silu_reference(x, scale, bias, groups, eps, pad)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GnSiluKernel.apply(x, scale, bias, groups, eps, pad)
    return _gn_silu_cuda(x, scale, bias, groups, eps, pad)


gn_silu.launches = 0


class GroupNormSiLU(nn.Module):
    """`weight`/`bias` of shape [C] (flax's `scale`/`bias`), eps 1e-6."""

    def __init__(self, channels: int, groups: int, pad: bool = False, eps: float = 1e-6):
        super().__init__()
        self.groups, self.pad, self.eps = groups, pad, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gn_silu(x, self.weight, self.bias, self.groups, self.eps, self.pad)
