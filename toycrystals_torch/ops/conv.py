"""Circular (periodic) convolution, NCHW, and its int8 form.

Counterpart of toycrystals_tpu/ops/conv.py:CircularConv. It covers the two
geometries of the score U-Net, (k3, s1) and (k4, s2), each with a 1-pixel
wrap on every side. Weights are kept in f32 and cast to the compute dtype
per call, as the JAX module does. Three implementations, as in JAX:

- `impl="pad"`: wrap-pad one pixel on each side, then a VALID conv.
- `impl="border"`: a zero-padded conv, then the first and last output rows
  and columns recomputed from thin wrap strips. The same numbers as "pad"; the
  JAX package measured it slower, and it is here for parity only.
- `impl="int8"`: dynamic symmetric quantisation, for inference. One f32 scale
  per tensor for the activation, sx = max(max|x|, 1e-12) / 127, and one per
  output channel for the weight, sw_c = max(max|W_c|, 1e-12) / 127; values
  round half to even, clip to +-127 and become int8; the wrap-padded int8
  input is convolved VALID with the int8 weight, accumulated exactly in int32
  (`int8_conv_acc`); then y = acc * (sx * sw_c) + bias in f32, cast to the
  compute dtype. The JAX package computes this conv through XLA, not a Pallas
  kernel; here a CUDA tensor's product is `torch._int_mm` over an im2col, and
  a CPU tensor's the same im2col in f64, which is exact for these sums.

On a mesh (the dispatch scope of parallel/spatial.py) the activation scale is
the max over every rank that holds part of the tensor, as GSPMD's max over
the global batch is, so a sharded int8 run quantises as one device does.
Under a space axis every conv kind is the halo exchange (`pad_rows`: the
neighbours' rows, wrapped between the last and the first rank) plus a VALID
conv; "border" then computes what "pad" does.

Under a model axis (parallel/tensor.py) a conv whose weight is a block of its
output channels computes that block from the whole input, gathered over
"model" where it arrives as a block; a conv whose weight the rule keeps whole
computes every channel. The int8 weight scale is per output channel, so a
block quantises alone; the activation scale stays the max over the whole mesh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from toycrystals_torch.parallel import spatial
from toycrystals_torch.parallel.tensor import param_block, sharded_input

IMPLS = ("pad", "border", "int8")
# im2col bytes per chunk of the int8 product (whole batch items per chunk)
_IM2COL_BYTES = 256 << 20


def conv_valid(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               stride: int = 1, dtype: torch.dtype | None = None) -> torch.Tensor:
    """VALID conv in `dtype` (default x.dtype), weights cast per call."""
    dt = dtype or x.dtype
    return F.conv2d(x.to(dt), weight.to(dt), bias.to(dt), stride=stride)


def wrap_pad(x: torch.Tensor) -> torch.Tensor:
    """One-pixel circular pad of [B, C, H, W] for any dtype (int8 included)."""
    x = torch.cat([x[:, :, -1:], x, x[:, :, :1]], dim=2)
    return torch.cat([x[..., -1:], x, x[..., :1]], dim=3)


def quantize_int8(x: torch.Tensor, dims=None,
                  shard: spatial.Shard | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale): scale = max(max|x|, 1e-12) / 127 over `dims`
    (all of x when None; else one scale per remaining index), then
    clip(round(x / scale), -127, 127) with round half to even (jnp.round).
    With `shard`, x is this rank's part of a tensor and the max is taken
    over every rank of its mesh."""
    amax = x.abs().amax() if dims is None else x.abs().amax(dim=dims, keepdim=True)
    amax = spatial.all_reduce_max(amax, shard)
    # a tensor divisor: CUDA computes division by a Python number as a multiply by
    # its reciprocal, which can miss JAX's (and the CPU's) quotient by one ulp
    scale = amax.float().clamp(min=1e-12) / torch.full((), 127.0, device=x.device)
    q = torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _int8_patches(xq: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """im2col of a [b, C, H, W] int8 tensor: [b * Ho * Wo, C * k * k], rows in
    (item, row, column) order, columns in the weight's (C, kh, kw) order."""
    p = xq.unfold(2, k, stride).unfold(3, k, stride)  # [b, C, Ho, Wo, k, k]
    b, c, ho, wo = p.shape[:4]
    return p.permute(0, 2, 3, 1, 4, 5).reshape(b * ho * wo, c * k * k)


def _int_mm_padded(a: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ w_t [K, N] int8 -> [M, N] int32 by `torch._int_mm`.
    Zero rows and columns pad M past 16 and K and N to multiples of 8 (exact:
    a zero adds nothing to an integer sum); whatever it refuses still raises."""
    m, k = a.shape
    n = w_t.shape[1]
    mp, kp, np_ = max(m, 32), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    # column-major B, the layout cuBLASLt's int8 product takes
    b = F.pad(w_t, (0, np_ - n, 0, kp - k)).t().contiguous().t()
    return torch._int_mm(a, b)[:m, :n]


def _acc(xq: torch.Tensor, wq: torch.Tensor, stride: int, product) -> torch.Tensor:
    """[B, O, Ho, Wo] int32 accumulators of a VALID conv, `product(a, w_t)`
    of each chunk's im2col a [M, K] with w_t [K, N] (int8 both)."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"the int8 conv takes int8 tensors, got {xq.dtype} and {wq.dtype}")
    b, c, h, w = xq.shape
    o, _, k, _ = wq.shape
    ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    w_t = wq.reshape(o, c * k * k).t()
    per = max(1, _IM2COL_BYTES // (ho * wo * c * k * k))
    out = torch.empty((b, o, ho, wo), dtype=torch.int32, device=xq.device)
    for i0 in range(0, b, per):
        acc = product(_int8_patches(xq[i0:i0 + per], k, stride), w_t)
        out[i0:i0 + per] = acc.reshape(-1, ho, wo, o).permute(0, 3, 1, 2)
    return out


def int8_conv_acc_reference(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain version of `int8_conv_acc`, on any device: the im2col product in
    f64, exact in any order (each sum is an integer below 127^2 * K < 2^53)."""
    return _acc(xq, wq, stride, lambda a, w_t: (a.double() @ w_t.double()).to(torch.int32))


def int8_conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Exact int32 accumulators of a VALID conv of int8 xq [B, C, H, W] with
    int8 wq [O, C, k, k]: [B, O, Ho, Wo]. A CUDA tensor runs `torch._int_mm`
    over an im2col, built a few batch items at a time (`_IM2COL_BYTES`); a
    CPU tensor runs the plain version."""
    if xq.device.type == "cpu":
        return int8_conv_acc_reference(xq, wq, stride)
    int8_conv_acc.launches += 1
    return _acc(xq, wq, stride, _int_mm_padded)


int8_conv_acc.launches = 0  # calls that ran torch._int_mm (CUDA tensors)


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """acc [B, O, Ho, Wo] int32 -> acc * (sx * sw_c) + bias in f32, cast to
    `dtype` (the product of the scales formed first, as JAX does)."""
    scale = (sx * sw.reshape(-1)).reshape(1, -1, 1, 1)
    return (acc.float() * scale + bias.float().reshape(1, -1, 1, 1)).to(dtype)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int,
              dtype: torch.dtype, wrap: bool) -> torch.Tensor:
    """The int8 conv of the module docstring; `wrap` wrap-pads the quantised
    input first (CircularConv), else the conv is VALID (a Conv2d over a
    halo'd input: the halo copies values, so max|halo(x)| = max|x| and
    quantise(pad(x)) == pad(quantise(x))). In a dispatch on a mesh the scale
    is the whole mesh's; under a space axis the rows come from the exchange
    before the quantisation (the same identity) and only W wraps here."""
    shard = spatial.current()
    space = spatial.current_space()
    if wrap and space is not None:
        x = spatial.pad_rows(x, space)
    xq, sx = quantize_int8(x, shard=shard)
    wq, sw = quantize_int8(weight, dims=(1, 2, 3))
    if wrap:
        xq = wrap_pad(xq) if space is None else torch.cat([xq[..., -1:], xq, xq[..., :1]], 3)
    return dequantize(int8_conv_acc(xq, wq, stride), sx, sw, bias, dtype)


def border_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int,
                dtype: torch.dtype) -> torch.Tensor:
    """The circular conv as a zero-padded conv whose border outputs (first and
    last row and column) are recomputed from wrap strips (JAX `impl="border"`)."""
    x, wt = x.to(dtype), weight.to(dtype)
    h, w = x.shape[2:]
    k = wt.shape[2]
    y = F.conv2d(x, wt, stride=stride, padding=1)
    ho, wo = y.shape[2:]

    def rows(start: int) -> torch.Tensor:  # the one output row fed by rows start.. (wrapped)
        strip = x[:, :, [(start + r) % h for r in range(k)]]
        strip = torch.cat([strip[..., -1:], strip, strip[..., :1]], dim=3)
        return F.conv2d(strip, wt, stride=(1, stride))[:, :, 0]

    def cols(start: int) -> torch.Tensor:
        strip = x[..., [(start + r) % w for r in range(k)]]
        strip = torch.cat([strip[:, :, -1:], strip, strip[:, :, :1]], dim=2)
        return F.conv2d(strip, wt, stride=(stride, 1))[..., 0]

    y[:, :, 0] = rows(-1)
    y[:, :, ho - 1] = rows((ho - 1) * stride - 1)
    y[..., 0] = cols(-1)
    y[..., wo - 1] = cols((wo - 1) * stride - 1)
    return y + bias.to(dtype).reshape(1, -1, 1, 1)


class Conv2d(nn.Module):
    """VALID conv with flax-shaped parameters: `weight` [out, in, kh, kw]
    and `bias` [out] (bias starts at zero, as flax's does). `int8=True` runs
    the int8 conv of the module docstring with no wrap (the fused block's
    conv1 over gn0's halo)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32, int8: bool = False):
        super().__init__()
        self.stride, self.dtype, self.int8 = stride, dtype, int8
        self.in_ch, self.out_ch = in_ch, out_ch
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(in_ch * kernel_size * kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = sharded_input(x, param_block(self, "weight"), self.in_ch)
        if self.int8:
            return int8_conv(x, self.weight, self.bias, self.stride, self.dtype, wrap=False)
        return conv_valid(x, self.weight, self.bias, self.stride, self.dtype)


class CircularConv(Conv2d):
    """Conv with circular padding of 1 on each spatial side, by `impl`
    "pad", "border" or "int8" (module docstring)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32, impl: str = "pad"):
        if kernel_size - stride != 2:
            raise ValueError(f"CircularConv supports pad-1 geometries (k - s == 2), "
                             f"got kernel {kernel_size} stride {stride}")
        if impl not in IMPLS:
            raise ValueError(f"CircularConv impl must be one of {IMPLS}, got {impl!r}")
        super().__init__(in_ch, out_ch, kernel_size, stride, dtype, int8=impl == "int8")
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = sharded_input(x, param_block(self, "weight"), self.in_ch)
        if self.impl == "int8":
            return int8_conv(x, self.weight, self.bias, self.stride, self.dtype, wrap=True)
        space = spatial.current_space()
        if space is not None:
            xp = F.pad(spatial.pad_rows(x.to(self.dtype), space), (1, 1, 0, 0), mode="circular")
            return conv_valid(xp, self.weight, self.bias, self.stride, self.dtype)
        if self.impl == "border":
            return border_conv(x, self.weight, self.bias, self.stride, self.dtype)
        xp = F.pad(x.to(self.dtype), (1, 1, 1, 1), mode="circular")
        return conv_valid(xp, self.weight, self.bias, self.stride, self.dtype)
