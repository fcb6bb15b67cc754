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

Without autograd, a CUDA tensor goes through the custom op
`torch.ops.toycrystals.gn_silu` (registered when this module is imported;
nothing is built until its first CUDA call). Its CUDA kernel is the forward
kernel, its CPU kernel the plain version, and its fake function gives the
output's shape and type, so `torch.export` records the op in a graph, and
eager serving and an exported graph launch the same kernel.

Under a space axis (the dispatch scope of parallel/spatial.py: each rank holds
rows of the image height) a group's statistics span the ranks. The op then
runs in two launches with an all-reduce between (`gn_silu_space`): the sums
kernel writes each (item, group)'s partial sums of x and x^2 over the rank's
rows (f32), the sums are added over the space group, and the apply kernel
normalises with those statistics, mean = S1 / n and the fast variance
S2 / n - mean^2 clipped at 0, as the one-launch kernel and the plain version
form them, then applies scale, bias and SiLU. With `pad` it writes the W halo
and a local H wrap whose rows the exchange then replaces with the
neighbours'. `gn_silu.sums_launches` and `gn_silu.apply_launches` count
them; the plain versions are `gn_sums_reference` and
`gn_silu_apply_reference`.

Its gradient (`_GnSiluSpace`) is cut at the same place: the padded gradient's
two H halo rows go back to the ranks that own them (parallel/spatial.py
`return_halo_rows`; they arrive as `edge` rows), the backward sums kernel
writes each (item, channel)'s sums of dz and dz * xhat over the rank's rows
(the W halo folded as it reads), the group's sums of dxhat = dz * scale_c and
dxhat * xhat are added over the space group, and the backward apply kernel
writes dx = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) with the means
over the whole group, as `gn_silu_backward_reference` forms them on the whole
image. dscale and dbias stay each rank's own sums: the data-parallel gradient
average adds them over every rank. `gn_silu.backward_sums_launches` and
`gn_silu.backward_apply_launches` count the launches; the plain versions are
`gn_silu_backward_sums_reference` and `gn_silu_backward_apply_reference`.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from toycrystals_torch.parallel import spatial

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def group_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """flax GroupNorm over [B, C, ...] in f32: f32 statistics, fast variance
    E[x^2] - E[x]^2 clipped at 0, then the per-channel affine. In a dispatch
    under a space axis x [B, C, h, W] is this rank's rows, and the group sums
    are added over the axis first (differentiably: parallel/spatial.py
    `all_reduce_space_sum`)."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    space = spatial.current_space()
    if space is not None:
        sums = spatial.all_reduce_space_sum(
            torch.stack([xf.sum(dim=2), (xf * xf).sum(dim=2)], dim=-1), space)
        n = xf.shape[2] * space.space
        mean = (sums[..., 0] / n)[..., None]
        var = ((sums[..., 1] / n)[..., None] - mean * mean).clamp(min=0.0)
    else:
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


def gn_sums_reference(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain version of the sums kernel: [B, groups, 2] f32, the sum of x and
    of x^2 over each (item, group) of x [B, C, h, W]."""
    xf = x.float().reshape(x.shape[0], groups, -1)
    return torch.stack([xf.sum(dim=2), (xf * xf).sum(dim=2)], dim=-1)


def gn_silu_apply_reference(x: torch.Tensor, sums: torch.Tensor, count: int,
                            scale: torch.Tensor, bias: torch.Tensor, groups: int,
                            eps: float = 1e-6, pad: bool = False) -> torch.Tensor:
    """Plain version of the apply kernel: GroupNorm+SiLU of x [B, C, h, W]
    with the statistics of `sums` ([B, groups, 2]: sums of x and x^2 over
    `count` elements per group), mean = S1 / count and the fast variance
    S2 / count - mean^2 clipped at 0; `pad` wraps one pixel on each side of
    x's own rows and columns. Returns x.dtype."""
    b, c = x.shape[:2]
    mean = (sums[..., 0] / count)[..., None]
    var = ((sums[..., 1] / count)[..., None] - mean * mean).clamp(min=0.0)
    y = ((x.float().reshape(b, groups, -1) - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * scale.float().reshape(1, c, 1, 1) + bias.float().reshape(1, c, 1, 1)
    y = F.silu(y).to(x.dtype)
    return F.pad(y, (1, 1, 1, 1), mode="circular") if pad else y


def _fold_w(g: torch.Tensor, w: int) -> torch.Tensor:
    """[..., W+2] -> [..., W]: the W halo added onto the columns it copies."""
    gc = g[..., 1:w + 1].clone()
    gc[..., w - 1] += g[..., 0]
    gc[..., 0] += g[..., w + 1]
    return gc


def _rank_grad(grad_out: torch.Tensor, edge: torch.Tensor | None, pad: bool) -> torch.Tensor:
    """This rank's rows' share of the upstream gradient, f32 [B, C, h, W]: the
    padded gradient's interior rows plus, with `pad`, the edge rows [B, C, 2,
    W+2] that the neighbours return onto the first and last rows, the W halo
    folded."""
    g = grad_out.float()
    if not pad:
        return g
    gi = g[:, :, 1:-1].clone()
    gi[:, :, :1] += edge[:, :, :1].float()
    gi[:, :, -1:] += edge[:, :, 1:].float()
    return _fold_w(gi, gi.shape[3] - 2)


def _space_terms(x, grad_out, edge, sums, count: int, scale, bias, groups: int, eps: float,
                 pad: bool):
    """(xhat, dz, inv, clipped) of this rank's rows with the whole group's
    statistics `sums`, f32."""
    b, c = x.shape[:2]
    mean = (sums[..., 0] / count)[..., None]
    var = (sums[..., 1] / count)[..., None] - mean * mean
    inv = torch.rsqrt(var.clamp(min=0.0) + eps)
    xhat = ((x.float().reshape(b, groups, -1) - mean) * inv).reshape(x.shape)
    z = xhat * scale.float().reshape(1, c, 1, 1) + bias.float().reshape(1, c, 1, 1)
    s = torch.sigmoid(z)
    dz = _rank_grad(grad_out, edge, pad) * s * (1.0 + z * (1.0 - s))
    return xhat, dz, inv, var < 0


def gn_silu_backward_sums_reference(x, grad_out, edge, sums, count: int, scale, bias,
                                    groups: int, eps: float = 1e-6,
                                    pad: bool = False) -> torch.Tensor:
    """Plain version of the backward sums kernel: [B, C, 2] f32, per (item,
    channel) the sums of dz and dz * xhat over this rank's rows x [B, C, h, W],
    with the statistics of the forward's `sums` ([B, groups, 2] over `count`
    elements per group) and the upstream gradient of `gn_silu_apply_reference`'s
    output (with `pad`, plus the neighbours' `edge` rows [B, C, 2, W+2])."""
    xhat, dz, _, _ = _space_terms(x, grad_out, edge, sums, count, scale, bias, groups, eps, pad)
    return torch.stack([dz.sum(dim=(2, 3)), (dz * xhat).sum(dim=(2, 3))], dim=-1)


def gn_silu_backward_apply_reference(x, grad_out, edge, sums, dsums, count: int, scale, bias,
                                     groups: int, eps: float = 1e-6,
                                     pad: bool = False) -> torch.Tensor:
    """Plain version of the backward apply kernel: dx of this rank's rows in
    x.dtype, dx = inv (dz scale_c - m1 - xhat m2) with m1, m2 = `dsums`
    ([B, groups, 2]: the sums of dxhat and dxhat * xhat over the whole group)
    over `count`, and m2 = 0 where the variance was clipped."""
    b, c = x.shape[:2]
    xhat, dz, inv, clipped = _space_terms(x, grad_out, edge, sums, count, scale, bias, groups,
                                          eps, pad)
    m1 = (dsums[..., 0] / count)[..., None]
    m2 = torch.where(clipped, 0.0, (dsums[..., 1] / count)[..., None])
    dxhat = (dz * scale.float().reshape(1, c, 1, 1)).reshape(b, groups, -1)
    dx = inv * (dxhat - m1 - xhat.reshape(b, groups, -1) * m2)
    return dx.reshape(x.shape).to(x.dtype)


def _fold_halo(g: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, C, H+2, W+2] -> [B, C, H, W]: each padded position adds onto the
    interior pixel it copies (the opposite edge for the halo)."""
    gc = _fold_w(g, w)
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
    lib.gn_silu_sums_launch.argtypes = [p, p, i, i, i, i, i, i, p]
    lib.gn_silu_sums_launch.restype = i
    lib.gn_silu_apply_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                                         ctypes.c_float, i, i, p]
    lib.gn_silu_apply_launch.restype = i
    lib.gn_silu_backward_sums_launch.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float] * 2 \
        + [i] * 3 + [p]
    lib.gn_silu_backward_sums_launch.restype = i
    lib.gn_silu_backward_apply_launch.argtypes = [p] * 8 + [i] * 5 + [ctypes.c_float] * 2 \
        + [i] * 3 + [p]
    lib.gn_silu_backward_apply_launch.restype = i
    lib.gn_silu_space_plan.argtypes = [i] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.gn_silu_space_plan.restype = i
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


def _gn_sums_cuda(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The sums kernel: [B, groups, 2] f32 (S1, S2) of this rank's rows, in
    one launch (each (item, group)'s partials are added inside it)."""
    _check(x, torch.empty(x.shape[1]), torch.empty(x.shape[1]), groups)
    b, c, h, w = x.shape
    sums = torch.empty((b, groups, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().gn_silu_sums_launch(x.data_ptr(), sums.data_ptr(), b, c, h, w, groups,
                                         _DTYPE_CODE[x.dtype], stream)
    _raise_on(err, "gn_silu sums kernel launch")
    gn_silu.sums_launches += 1
    return sums


def _gn_silu_apply_cuda(x, sums, count: int, scale, bias, groups: int, eps: float,
                        pad: bool) -> torch.Tensor:
    """The apply kernel: GroupNorm+SiLU of x with the statistics of `sums`
    ([B, groups, 2] f32 over `count` elements per group), as
    `gn_silu_apply_reference`."""
    _check(x, scale, bias, groups)
    b, c, h, w = x.shape
    scale, bias = _f32(scale, x.device), _f32(bias, x.device)
    sums = _f32(sums, x.device)
    p = 1 if pad else 0
    out = torch.empty((b, c, h + 2 * p, w + 2 * p), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().gn_silu_apply_launch(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                          sums.data_ptr(), out.data_ptr(), b, c, h, w, groups,
                                          float(count), float(eps), p, _DTYPE_CODE[x.dtype],
                                          stream)
    _raise_on(err, "gn_silu apply kernel launch")
    gn_silu.apply_launches += 1
    return out


def gn_sums(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-(item, group) [S1, S2] f32 of x: the sums kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    return gn_sums_reference(x, groups) if x.device.type == "cpu" else _gn_sums_cuda(x, groups)


def gn_silu_apply(x, sums, count: int, scale, bias, groups: int, eps: float = 1e-6,
                  pad: bool = False) -> torch.Tensor:
    """GroupNorm+SiLU with given statistics: the apply kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return gn_silu_apply_reference(x, sums, count, scale, bias, groups, eps, pad)
    return _gn_silu_apply_cuda(x, sums, count, scale, bias, groups, eps, pad)


def _bwd_blocks(b: int, c: int, h: int, device) -> int:
    """Blocks per (item, channel) of the space backward kernels: enough for
    four per SM in all, at most 16, and at most one per row."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(16, -(-4 * sms // (b * c)), h))


def _space_bwd_args(x, grad_out, edge, sums, scale, bias, groups: int, pad: bool):
    _check(x, scale, bias, groups)
    b, c, h, w = x.shape
    p = 1 if pad else 0
    if grad_out.shape != (b, c, h + 2 * p, w + 2 * p):
        raise ValueError(f"grad_out must be {(b, c, h + 2 * p, w + 2 * p)}, got "
                         f"{tuple(grad_out.shape)}")
    if pad and (edge is None or edge.shape != (b, c, 2, w + 2)):
        raise ValueError(f"pad needs edge rows [{b}, {c}, 2, {w + 2}], got "
                         f"{None if edge is None else tuple(edge.shape)}")
    g = grad_out.to(x.dtype).contiguous()
    e = edge.to(x.dtype).contiguous() if pad else None
    return (g, e, _f32(sums, x.device), _f32(scale, x.device), _f32(bias, x.device),
            _bwd_blocks(b, c, h, x.device))


def _gn_bwd_sums_cuda(x, grad_out, edge, sums, count: int, scale, bias, groups: int,
                      eps: float, pad: bool) -> torch.Tensor:
    """The backward sums kernel: [B, C, 2] f32, as
    `gn_silu_backward_sums_reference`; each (item, channel)'s k partials are
    added here in block order."""
    g, e, st, sc, bi, k = _space_bwd_args(x, grad_out, edge, sums, scale, bias, groups, pad)
    b, c, h, w = x.shape
    part = torch.empty((b * c, k, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().gn_silu_backward_sums_launch(
            x.data_ptr(), g.data_ptr(), None if e is None else e.data_ptr(), sc.data_ptr(),
            bi.data_ptr(), st.data_ptr(), part.data_ptr(), b, c, h, w, groups, float(count),
            float(eps), 1 if pad else 0, k, _DTYPE_CODE[x.dtype], stream)
    _raise_on(err, "gn_silu backward sums kernel launch")
    gn_silu.backward_sums_launches += 1
    return part.sum(dim=1).reshape(b, c, 2)


def _gn_bwd_apply_cuda(x, grad_out, edge, sums, dsums, count: int, scale, bias, groups: int,
                       eps: float, pad: bool) -> torch.Tensor:
    """The backward apply kernel: dx in x.dtype, as
    `gn_silu_backward_apply_reference`."""
    g, e, st, sc, bi, k = _space_bwd_args(x, grad_out, edge, sums, scale, bias, groups, pad)
    b, c, h, w = x.shape
    ds = _f32(dsums, x.device)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().gn_silu_backward_apply_launch(
            x.data_ptr(), g.data_ptr(), None if e is None else e.data_ptr(), sc.data_ptr(),
            bi.data_ptr(), st.data_ptr(), ds.data_ptr(), dx.data_ptr(), b, c, h, w, groups,
            float(count), float(eps), 1 if pad else 0, k, _DTYPE_CODE[x.dtype], stream)
    _raise_on(err, "gn_silu backward apply kernel launch")
    gn_silu.backward_apply_launches += 1
    return dx


def gn_silu_backward_sums(x, grad_out, edge, sums, count: int, scale, bias, groups: int,
                          eps: float = 1e-6, pad: bool = False) -> torch.Tensor:
    """Per-(item, channel) [sum dz, sum dz xhat] f32 of this rank's rows: the
    backward sums kernel on a CUDA tensor, the plain version on a CPU tensor."""
    fn = gn_silu_backward_sums_reference if x.device.type == "cpu" else _gn_bwd_sums_cuda
    return fn(x, grad_out, edge, sums, count, scale, bias, groups, eps, pad)


def gn_silu_backward_apply(x, grad_out, edge, sums, dsums, count: int, scale, bias,
                           groups: int, eps: float = 1e-6, pad: bool = False) -> torch.Tensor:
    """dx of this rank's rows: the backward apply kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    fn = gn_silu_backward_apply_reference if x.device.type == "cpu" else _gn_bwd_apply_cuda
    return fn(x, grad_out, edge, sums, dsums, count, scale, bias, groups, eps, pad)


class _GnSiluSpace(torch.autograd.Function):
    """GroupNorm+SiLU of this rank's rows of an image split by height over
    `shard`'s space axis (module docstring). The backward reads the shard kept
    here, never the dispatch scope."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, pad, shard):
        x = x.contiguous()
        sums = spatial.all_reduce_space_sum(gn_sums(x, groups), shard)
        count = x.shape[1] // groups * x.shape[2] * x.shape[3] * shard.space
        y = gn_silu_apply(x, sums, count, scale, bias, groups, eps, pad)
        if pad:
            spatial.fill_halo_rows(y, shard)
        ctx.save_for_backward(x, scale, bias, sums)
        ctx.args = (groups, eps, pad, shard, count)
        return y

    @staticmethod
    def backward(ctx, grad_out):
        x, scale, bias, sums = ctx.saved_tensors
        groups, eps, pad, shard, count = ctx.args
        edge = None
        if pad:
            first, last = spatial.return_halo_rows(grad_out[:, :, :1], grad_out[:, :, -1:],
                                                   shard, circular=True)
            edge = torch.cat([first, last], dim=2)
        b, c = x.shape[:2]
        chan = gn_silu_backward_sums(x, grad_out, edge, sums, count, scale, bias, groups, eps,
                                     pad)
        dsums = (chan * scale.float().reshape(1, c, 1)).reshape(b, groups, -1, 2).sum(dim=2)
        dist.all_reduce(dsums, op=dist.ReduceOp.SUM, group=shard.space_group)
        dx = gn_silu_backward_apply(x, grad_out, edge, sums, dsums, count, scale, bias, groups,
                                    eps, pad)
        sums_c = chan.sum(dim=0)
        return (dx, sums_c[:, 1].to(scale.dtype), sums_c[:, 0].to(bias.dtype), None, None,
                None, None)


def gn_silu_space(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                  eps: float, pad: bool, space: spatial.Shard) -> torch.Tensor:
    """GroupNorm+SiLU of this rank's rows x [B, C, h, W] of an image split by
    height over `space`: the sums of every rank's rows, then the apply kernel;
    with `pad`, the H halo rows are the neighbours' (the image's wrap).
    Differentiable (`_GnSiluSpace`)."""
    return _GnSiluSpace.apply(x, scale, bias, groups, eps, pad, space)


@torch.library.custom_op("toycrystals::gn_silu", mutates_args=(), device_types="cuda")
def gn_silu_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float, pad: bool) -> torch.Tensor:
    """The forward kernel as a torch op (no statistics, no autograd)."""
    return _gn_silu_cuda(x, scale, bias, groups, eps, pad)


gn_silu_op.register_kernel("cpu")(gn_silu_reference)


@gn_silu_op.register_fake
def _gn_silu_op_fake(x, scale, bias, groups, eps, pad):
    b, c, h, w = x.shape
    p = 2 if pad else 0
    return x.new_empty((b, c, h + p, w + p))


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


def space_kernel_plan(shape, groups: int, dtype: torch.dtype, pad: bool) -> dict:
    """The launches a call of the space pair at this shape gets on the current
    card (x 16-byte aligned): the sums kernel's cluster size and CTAs, and the
    apply kernel's CTAs, elements per vector and lanes per output row."""
    b, c, h, w = shape
    out = (ctypes.c_int * 5)()
    _raise_on(_lib().gn_silu_space_plan(b, c, h, w, groups, 1 if pad else 0,
                                        _DTYPE_CODE[dtype], out), "gn_silu space plan")
    return dict(sums_cluster=out[0], sums_ctas=out[1], apply_ctas=out[2],
                apply_vector=out[3], apply_lanes_per_row=out[4])


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
    return gn_silu_op(x, scale, bias, groups, eps, pad)


gn_silu.launches = 0
gn_silu.backward_launches = 0
gn_silu.sums_launches = 0   # the sums kernel (space axis)
gn_silu.apply_launches = 0  # the apply kernel (space axis)
gn_silu.backward_sums_launches = 0   # the backward sums kernel (space axis)
gn_silu.backward_apply_launches = 0  # the backward apply kernel (space axis)


class GroupNormSiLU(nn.Module):
    """`weight`/`bias` of shape [C] (flax's `scale`/`bias`), eps 1e-6."""

    def __init__(self, channels: int, groups: int, pad: bool = False, eps: float = 1e-6):
        super().__init__()
        self.groups, self.pad, self.eps = groups, pad, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        space = spatial.current_space()
        if space is not None:
            return gn_silu_space(x, self.weight, self.bias, self.groups, self.eps, self.pad,
                                 space)
        return gn_silu(x, self.weight, self.bias, self.groups, self.eps, self.pad)
