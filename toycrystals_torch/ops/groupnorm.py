"""Fused GroupNorm + SiLU (+ 1-pixel circular halo) over NCHW activations.

Counterpart of toycrystals_tpu/ops/groupnorm.py. Every conv block of the
score U-Net ends its convs in this op; with `pad=True` it writes the
[H+2, W+2] circular-padded plane so the following conv runs VALID with no
separate wrap-pad copy.

- `gn_silu_reference` is the plain PyTorch version of the JAX formula: f32
  statistics, fast variance E[x^2] - E[x]^2 clipped at 0, eps 1e-6 (torch's
  `F.group_norm` uses eps 1e-5 and a two-pass variance, so it is not used).
- `gn_silu_backward_reference` is the plain version of its gradient in closed
  form (the halo folded back onto the opposite edge, then the GroupNorm and
  SiLU chain), f32 inside: what `jax.vjp` of the JAX op's `_ref_full` gives.
- `gn_silu` launches the hand-written CUDA kernels (csrc/gn_silu.cu) on a CUDA
  tensor and runs the plain version on a CPU tensor. There is no other
  branch: a failed build or launch raises. `gn_silu.launches` counts forward
  kernel launches, `gn_silu.backward_launches` backward kernel launches.

Under autograd the forward on a CUDA tensor launches the forward kernel inside
a `torch.autograd.Function` that also has it write the per-(item, group)
statistics, and whose backward launches the backward kernel on the saved
inputs and statistics, as the JAX op's custom VJP differentiates its jnp
reference. On the CPU the plain version runs under ordinary autograd.
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


def _fold_halo(g: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, C, H+2, W+2] -> [B, C, H, W]: each padded position adds onto the
    interior pixel it copies (the opposite edge for the halo)."""
    gc = g[..., 1:w + 1].clone()
    gc[..., w - 1] += g[..., 0]
    gc[..., 0] += g[..., w + 1]
    gi = gc[:, :, 1:h + 1].clone()
    gi[:, :, h - 1] += gc[:, :, 0]
    gi[:, :, 0] += gc[:, :, h + 1]
    return gi


def gn_silu_backward_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                               grad_out: torch.Tensor, groups: int, eps: float = 1e-6,
                               pad: bool = False):
    """Plain version of the gradient, in closed form and f32 inside. Returns
    (dx in x.dtype, dscale, dbias in scale's and bias's dtypes) for the
    upstream gradient `grad_out` of `gn_silu_reference(x, scale, bias, groups,
    eps, pad)`. Where the variance was clipped at 0 it carries no gradient."""
    b, c, h, w = x.shape
    g = grad_out.float()
    gi = _fold_halo(g, h, w) if pad else g
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    var = (xf * xf).mean(dim=2, keepdim=True) - mean * mean
    inv = torch.rsqrt(var.clamp(min=0.0) + eps)
    xhat = ((xf - mean) * inv).reshape(x.shape)
    sc = scale.float().reshape(1, c, 1, 1)
    z = xhat * sc + bias.float().reshape(1, c, 1, 1)
    s = torch.sigmoid(z)
    dz = gi * s * (1.0 + z * (1.0 - s))
    dxhat = (dz * sc).reshape(b, groups, -1)
    xh = xhat.reshape(b, groups, -1)
    m1 = dxhat.mean(dim=2, keepdim=True)
    m2 = torch.where(var < 0, 0.0, (dxhat * xh).mean(dim=2, keepdim=True))
    dx = (inv * (dxhat - m1 - xh * m2)).reshape(x.shape)
    return (dx.to(x.dtype), (dz * xhat).sum(dim=(0, 2, 3)).to(scale.dtype),
            dz.sum(dim=(0, 2, 3)).to(bias.dtype))


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (first use builds)."""
    from toycrystals_torch.utils.cuda_build import load

    lib = load("gn_silu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gn_silu_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, p]
    lib.gn_silu_launch.restype = i
    lib.gn_silu_backward_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                            ctypes.c_float, i, i, p]
    lib.gn_silu_backward_launch.restype = i
    lib.gn_silu_plan.argtypes = [i, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.gn_silu_plan.restype = i
    lib.gn_silu_error_string.argtypes = [i]
    lib.gn_silu_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, scale, bias, groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"gn_silu expects [B, C, H, W], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"gn_silu kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gn_silu kernel needs a contiguous NCHW tensor")
    c = x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"channels ({c}) must divide into groups ({groups})")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must be [{c}], got {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu kernel needs a CUDA tensor, got {x.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {_lib().gn_silu_error_string(err).decode()} ({err})")


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.float32).contiguous()


def _gn_silu_cuda(x, scale, bias, groups: int, eps: float, pad: bool,
                  stats: torch.Tensor | None = None) -> torch.Tensor:
    """The forward kernel. `stats`, if given ([B * groups * 3] f32), receives
    (mean, inv, clipped) per (item, group) for the backward kernel."""
    _check(x, scale, bias, groups)
    b, c, h, w = x.shape
    scale, bias = _f32(scale, x.device), _f32(bias, x.device)
    p = 1 if pad else 0
    out = torch.empty((b, c, h + 2 * p, w + 2 * p), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().gn_silu_launch(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                    out.data_ptr(), None if stats is None else stats.data_ptr(),
                                    b, c, h, w, groups, float(eps), p, _DTYPE_CODE[x.dtype],
                                    stream)
    _raise_on(err, "gn_silu kernel launch")
    gn_silu.launches += 1
    return out


def _gn_silu_backward_cuda(x, scale, bias, grad_out, stats, groups: int, eps: float,
                           pad: bool):
    """The backward kernel: (dx, dscale, dbias) from the saved inputs and the
    forward's statistics. dscale and dbias are the kernel's per-(item, channel)
    sums added over the batch in a fixed order."""
    _check(x, scale, bias, groups)
    b, c, h, w = x.shape
    p = 1 if pad else 0
    if grad_out.shape != (b, c, h + 2 * p, w + 2 * p):
        raise ValueError(f"grad_out must be {(b, c, h + 2 * p, w + 2 * p)}, got "
                         f"{tuple(grad_out.shape)}")
    g = grad_out.to(x.dtype).contiguous()
    sc, bi = _f32(scale, x.device), _f32(bias, x.device)
    dx = torch.empty_like(x)
    chan = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().gn_silu_backward_launch(
            x.data_ptr(), g.data_ptr(), sc.data_ptr(), bi.data_ptr(), stats.data_ptr(),
            dx.data_ptr(), chan.data_ptr(), b, c, h, w, groups, float(eps), p,
            _DTYPE_CODE[x.dtype], stream)
    _raise_on(err, "gn_silu backward kernel launch")
    gn_silu.backward_launches += 1
    sums = chan.sum(dim=0)
    return dx, sums[:, 1].to(scale.dtype), sums[:, 0].to(bias.dtype)


def kernel_plan(shape, groups: int, dtype: torch.dtype, pad: bool,
                backward: bool = False) -> dict:
    """The launch a call of this shape gets on the current card: CTAs per
    (item, group) (the cluster), threads per CTA, whether a CTA keeps its rows
    in shared memory, and its dynamic shared memory in bytes."""
    b, c, h, w = shape
    out = (ctypes.c_int * 4)()
    _raise_on(_lib().gn_silu_plan(b, c, h, w, groups, 1 if pad else 0,
                                  _DTYPE_CODE[dtype], 1 if backward else 0, out),
              "gn_silu launch plan")
    return dict(cluster=out[0], threads=out[1], rows_in_shared_memory=bool(out[2]),
                shared_memory_bytes=out[3])


class _GnSiluKernel(torch.autograd.Function):
    """Forward kernel (writing the statistics); backward kernel on the saved
    inputs and statistics."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, pad):
        stats = None
        if x.device.type == "cuda":
            stats = torch.empty(x.shape[0] * groups * 3, dtype=torch.float32, device=x.device)
        out = _gn_silu_cuda(x, scale, bias, groups, eps, pad, stats=stats)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.args = (groups, eps, pad)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, scale, bias, stats = ctx.saved_tensors
        grads = _gn_silu_backward_cuda(x, scale, bias, grad_out, stats, *ctx.args)
        return (*(gr if n else None for gr, n in zip(grads, ctx.needs_input_grad[:3])),
                None, None, None)


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
gn_silu.backward_launches = 0


class GroupNormSiLU(nn.Module):
    """`weight`/`bias` of shape [C] (flax's `scale`/`bias`), eps 1e-6."""

    def __init__(self, channels: int, groups: int, pad: bool = False, eps: float = 1e-6):
        super().__init__()
        self.groups, self.pad, self.eps = groups, pad, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gn_silu(x, self.weight, self.bias, self.groups, self.eps, self.pad)
