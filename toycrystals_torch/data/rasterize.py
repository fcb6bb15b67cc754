"""Gaussian-atom rasterization: images as sums of separable Gaussians.

Counterpart of toycrystals_tpu/data/rasterize.py. An isotropic Gaussian
factors, exp(-(dx^2 + dy^2) c) = exp(-dy^2 c) * exp(-dx^2 c), so an image is
one product over atoms, img = Ey @ Ex with Ey = w_p exp(-(h - y_p)^2 c) [H, P]
and Ex = exp(-(w - x_p)^2 c) [P, W], c = 1 / (2 sigma^2) per image. Atoms with
weight 0 (padding, vacancies, cropped points) contribute nothing.

- `rasterize_reference`: direct [P, H, W] broadcast of one image, for parity
  tests at small sizes.
- `rasterize_separable`: the plain version, batched: `torch.exp` factors and
  one `torch.bmm`.
- `rasterize`: the hand-written CUDA kernel (csrc/rasterize.cu) on CUDA
  tensors, which builds both factors in shared memory and contracts them in
  its own body, and the plain version on CPU tensors. There is no other
  branch: a failed build or launch raises. `rasterize.launches` counts
  kernel launches. The op needs no gradient and gives none.
- `rasterize_batch`: render, then normalise each image by its own peak.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def rasterize_reference(points: torch.Tensor, weights: torch.Tensor, sigma, h: int,
                        w: int) -> torch.Tensor:
    """One image by direct broadcast. points [P, 2] as (x, y), weights [P],
    sigma a scalar -> [H, W] f32."""
    dev = points.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    dx = xx[None] - points[:, 0][:, None, None]
    dy = yy[None] - points[:, 1][:, None, None]
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    return (g * weights[:, None, None]).sum(dim=0)


def _check(points: torch.Tensor, weights: torch.Tensor, sigma: torch.Tensor) -> tuple[int, int]:
    if points.dim() != 3 or points.shape[-1] != 2:
        raise ValueError(f"points must be [B, P, 2], got {tuple(points.shape)}")
    b, p, _ = points.shape
    if tuple(weights.shape) != (b, p) or tuple(sigma.shape) != (b,):
        raise ValueError(f"weights must be [{b}, {p}] and sigma [{b}], got "
                         f"{tuple(weights.shape)} and {tuple(sigma.shape)}")
    return b, p


def rasterize_separable(points: torch.Tensor, weights: torch.Tensor, sigma: torch.Tensor,
                        h: int, w: int) -> torch.Tensor:
    """Plain version. points [B, P, 2], weights [B, P], sigma [B] -> [B, H, W]
    f32: Ey [B, H, P] and Ex [B, P, W] from `torch.exp`, then one `torch.bmm`
    (full f32 unless the caller has allowed TF32 matmuls)."""
    _check(points, weights, sigma)
    dev = points.device
    inv = (1.0 / (2.0 * sigma * sigma))[:, None, None]
    rows = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    dy = rows - points[:, None, :, 1]
    dx = cols - points[:, :, None, 0]
    ey = torch.exp(-(dy * dy) * inv) * weights[:, None, :]
    ex = torch.exp(-(dx * dx) * inv)
    return torch.bmm(ey, ex)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (first use builds)."""
    from toycrystals_torch.utils.cuda_build import load

    lib = load("rasterize")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rasterize_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.rasterize_launch.restype = i
    lib.rasterize_error_string.argtypes = [i]
    lib.rasterize_error_string.restype = ctypes.c_char_p
    return lib


def _rasterize_cuda(points: torch.Tensor, weights: torch.Tensor, sigma: torch.Tensor,
                    h: int, w: int) -> torch.Tensor:
    b, p = _check(points, weights, sigma)
    for name, t in (("points", points), ("weights", weights), ("sigma", sigma)):
        if t.dtype != torch.float32:
            raise TypeError(f"rasterize kernel takes float32, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rasterize kernel needs contiguous tensors; {name} is strided")
        if t.device != points.device:
            raise ValueError(f"{name} lies on {t.device}, points on {points.device}")
    if points.device.type != "cuda":
        raise ValueError(f"rasterize kernel needs CUDA tensors, got {points.device}")
    if p % 128:
        raise ValueError(f"the point count must be a multiple of 128, got {p}")
    if h <= 0 or w <= 0:
        raise ValueError(f"image size must be positive, got {h}x{w}")
    if points.data_ptr() % 8:
        raise ValueError("rasterize kernel needs points aligned to 8 bytes")
    inv = 1.0 / (2.0 * sigma * sigma)
    out = torch.empty((b, h, w), dtype=torch.float32, device=points.device)
    lib = _lib()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.rasterize_launch(points.data_ptr(), weights.data_ptr(), inv.data_ptr(),
                                   out.data_ptr(), b, p, h, w, stream)
    if err != 0:
        raise RuntimeError(f"rasterize kernel launch failed: "
                           f"{lib.rasterize_error_string(err).decode()} ({err})")
    rasterize.launches += 1
    return out


def rasterize(points: torch.Tensor, weights: torch.Tensor, sigma: torch.Tensor, h: int,
              w: int) -> torch.Tensor:
    """Batched render. points [B, P, 2] f32 as (x, y), weights [B, P], sigma
    [B] -> [B, H, W] f32. CUDA tensors run the kernel (P a multiple of 128),
    CPU tensors the plain version."""
    if points.device.type == "cpu":
        return rasterize_separable(points, weights, sigma, h, w)
    return _rasterize_cuda(points, weights, sigma, h, w)


rasterize.launches = 0


def rasterize_batch(points: torch.Tensor, weights: torch.Tensor, sigma: torch.Tensor, h: int,
                    w: int) -> torch.Tensor:
    """Render a batch and normalise each image to [0, 1] by its own peak."""
    img = rasterize(points, weights, sigma, h, w)
    peak = img.amax(dim=(1, 2), keepdim=True)
    return (img / (peak + 1e-8)).clamp(0.0, 1.0)
