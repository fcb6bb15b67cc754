"""Spatial self-attention over NCHW feature maps.

Counterpart of toycrystals_tpu/ops/attention.py: GroupNorm (plain, no SiLU,
eps 1e-6) -> qkv Linear split (3, heads, head_dim) on the channel axis ->
softmax(Q K^T / sqrt(d)) V -> proj Linear -> residual. Tokens run row-major
over (H, W): 256 at the 64x64 bottleneck, 4,096 at 256x256.

Two SDPA backends on [B, N, heads, d] tensors (JAX's layout), picked by
`attn_impl` as `select_attn_impl` says:

- `sdpa_reference` ("xla"): the plain version, `torch.matmul` + softmax with
  the logits in f32. It materialises the [B, heads, N, N] logits.
- `flash_sdpa` ("flash"): the hand-written CUDA kernels of csrc/flash_attn.cu
  on a CUDA tensor (forward, and under autograd the delta, dK/dV and dQ
  backward kernels behind a `torch.autograd.Function`); the plain version on
  a CPU tensor. There is no other branch: a failed build or launch raises.
  `flash_sdpa.launches` counts forward launches and
  `flash_sdpa.backward_launches` backward passes (three kernels each).
  Without autograd the forward kernel runs as the custom op
  `torch.ops.toycrystals.flash_sdpa_fwd` (registered at import, built at its
  first CUDA call; CPU kernel: the plain version; a fake function for
  `torch.export`), so an exported graph launches it as eager serving does.

Under a space axis (the dispatch scope of parallel/spatial.py) each rank holds
rows of the image height, so its tokens are a contiguous share of the
row-major sequence: Q stays on the rank's Nq tokens and K and V are gathered
from every rank over the space group (Nk = Nq S), in rank order, which is the
sequence's order. The GroupNorm adds its sums over the axis, and the backend
is chosen on the whole image's token count, as an unsharded run chooses it
(`attn_backend`); where auto picks flash but the rank's own Nq is no
multiple of 128, which the kernel needs, the plain version runs against the
gathered K and V (the same math), and a forced "flash" is refused there. The flash kernels take Nq != Nk forward and backward: the backward
gives dK and dV of every gathered key, this rank's queries' share, and the
gather's backward (parallel/spatial.py `gather_space`) sums them onto the
ranks that own the keys.

Under a model axis (parallel/tensor.py) the GroupNorm runs on the rank's
channel block, `qkv` reads the gathered channels and gives the rank's heads
(its weight placed by head), the backend runs on those heads ([B, N, heads /
M, d]), `proj` reads the gathered heads and gives the rank's block of output
channels, and the residual adds the block to the rank's block of x. Where
the heads do not divide by M, `qkv` holds JAX's contiguous block of its
columns, the columns are gathered and every rank runs all heads.
`linear` is the flax Dense under either layout.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from toycrystals_torch.ops.groupnorm import group_norm_f32, model_groupwise
from toycrystals_torch.parallel import spatial
from toycrystals_torch.parallel import tensor as tp

_FLASH_TOKENS = 2048        # auto: flash from this many tokens on
_FLASH_MAX_HEAD_DIM = 128
_FLASH_SEQ_MULTIPLE = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
        self.channels, self.groups, self.eps = channels, groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def norm(a, sc, bi, g):
            return group_norm_f32(a, sc, bi, g, self.eps).to(a.dtype)

        if spatial.current_model() is not None:
            return model_groupwise(norm, x, self.weight, self.bias, self.channels, self.groups,
                                   tp.param_block(self, "weight"))
        return norm(x, self.weight, self.bias, self.groups)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=...): input and weights cast to `dtype` per call.
    Under a model axis the input is gathered whole, and a layer whose weight
    is a block gives the rank's block of output features."""
    x = tp.sharded_input(x, tp.param_block(layer, "weight"), layer.in_features, dim=-1)
    return torch.nn.functional.linear(x.to(dtype), layer.weight.to(dtype),
                                      layer.bias.to(dtype))


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float | None = None) -> torch.Tensor:
    """Plain version: softmax(Q K^T * scale) V on [B, N, heads, d] (scale
    1 / sqrt(d) unless given), logits and softmax in f32, probabilities cast
    to v.dtype for the second product.
    q and k are upcast before the first product, so bf16 logits are never
    rounded to bf16 (exact: a bf16 product fits in f32), as JAX's
    `dot_product_attention` forms them (BF16_BF16_F32)."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))                # [B, heads, N, d]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)


def select_attn_impl(attn_impl: str, n: int, head_dim: int, device_type: str) -> str:
    """"flash" or "xla" for `n` tokens of `head_dim` on a device of
    `device_type`. auto picks flash where the logits buffer starts to matter
    (n >= 2048), the kernel's constraints hold (n % 128 == 0, head_dim <= 128)
    and the tensor is on a CUDA device (JAX: on a TPU); 56x56 = 3,136 tokens
    stay on the matmul path. "xla" and "flash" are taken as given."""
    if attn_impl != "auto":
        return attn_impl
    flash = (n >= _FLASH_TOKENS and n % _FLASH_SEQ_MULTIPLE == 0
             and head_dim <= _FLASH_MAX_HEAD_DIM and device_type == "cuda")
    return "flash" if flash else "xla"


def attn_backend(attn_impl: str, n_image: int, n_rank: int, head_dim: int,
                 device_type: str) -> str:
    """The backend of a rank's `n_rank` queries against the `n_image` tokens
    of the whole image: `select_attn_impl` on the whole image, as an
    unsharded run (and JAX's GSPMD) chooses, except that where auto picks
    flash and the rank's own query count is no multiple of 128, which the
    kernel needs, the plain version ("xla") runs against the gathered keys,
    the same math. A forced "flash" stays flash (`flash_sdpa` refuses what
    the kernel cannot take)."""
    impl = select_attn_impl(attn_impl, n_image, head_dim, device_type)
    if attn_impl == "auto" and impl == "flash" and n_rank % _FLASH_SEQ_MULTIPLE:
        return "xla"
    return impl


def _kernel_head_dim(d: int) -> int:
    """The head dim the kernel is built for: the next multiple of 16."""
    return -(-d // 16) * 16


@functools.cache
def _lib(head_dim: int) -> ctypes.CDLL:
    """The kernel library built for `head_dim`, with its C signatures
    declared (first use builds)."""
    from toycrystals_torch.utils.cuda_build import load

    lib = load("flash_attn", (f"FLASH_HEAD_DIM={head_dim}",))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_attn_head_dim.argtypes = []
    lib.flash_attn_head_dim.restype = i
    lib.flash_attn_forward.argtypes = [p] * 5 + [i] * 4 + [ll] * 9 + [f, i, p]
    lib.flash_attn_forward.restype = i
    lib.flash_attn_backward.argtypes = [p] * 10 + [i] * 4 + [ll] * 15 + [f, i, p]
    lib.flash_attn_backward.restype = i
    lib.flash_attn_error_string.argtypes = [i]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    if lib.flash_attn_head_dim() != head_dim:
        raise RuntimeError(f"flash_attn library was built for head dim "
                           f"{lib.flash_attn_head_dim()}, not {head_dim}")
    return lib


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q [B, Nq, heads, d] against k and v [B, Nk, heads, d]."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"flash_sdpa expects k and v of one shape [B, Nk, heads, d] and q "
                         f"[B, Nq, heads, d], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_sdpa takes float32 or bfloat16 (one type for q, k, v), got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    n, nk, d = q.shape[1], k.shape[1], q.shape[3]
    if d > _FLASH_MAX_HEAD_DIM:
        raise ValueError(f"flash path supports head_dim <= 128, got {d}; use xla")
    if n % _FLASH_SEQ_MULTIPLE or nk % _FLASH_SEQ_MULTIPLE:
        raise ValueError(f"flash path needs seq_len % 128 == 0, got {n} queries and {nk} "
                         f"keys; use xla")


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when the kernel can read it in place (last dim contiguous,
    rows 16-byte aligned), else a contiguous copy."""
    per16 = 16 // t.element_size()
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(t.stride(i) % per16 == 0 for i in range(3)))
    return t if ok else t.contiguous()


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)      # batch, row, head


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attn {what} launch failed: "
                           f"{lib.flash_attn_error_string(err).decode()} ({err})")


def _flash_forward_cuda(q, k, v, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel. q: [B, N, heads, d], k, v: [B, Nk, heads,
    d] CUDA tensors with d a multiple of 16. Returns O (contiguous, q.dtype,
    q's shape) and the row log-sum-exp L (f32 [B, heads, N])."""
    _check_qkv(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attn kernel needs CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    b, n, h, d = q.shape
    if d % 16:
        raise ValueError(f"flash_attn kernel takes head dims that are multiples of 16, "
                         f"got {d}")
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lib = _lib(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     lse.data_ptr(), b, n, k.shape[1], h, *_strides(q),
                                     *_strides(k),
                                     *_strides(v), float(scale), _DTYPE_CODE[q.dtype], stream)
    _raise_on(err, lib, "forward")
    flash_sdpa.launches += 1
    return out, lse


def _flash_backward_cuda(q, k, v, out, lse, grad_out, scale: float):
    """Launch the backward kernels (delta, dK/dV, dQ) at the forward's
    saved tensors, q [B, N, heads, d] against k and v [B, Nk, heads, d].
    Returns (dq, dk, dv). At Nk = N they are views of one [B, N, 3, heads, d]
    buffer, the layout of the qkv projection they flow back into; at Nk != N
    (a rank's queries against gathered keys) dq is [B, N, heads, d] and dk,
    dv views of one [B, Nk, 2, heads, d] buffer: this rank's queries' share of
    every key's gradient."""
    b, n, h, d = q.shape
    nk = k.shape[1]
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    grad_out = grad_out.contiguous()
    if nk == n:
        grads = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
        dq, dk, dv = grads[:, :, 0], grads[:, :, 1], grads[:, :, 2]
    else:
        dq = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
        dkv = torch.empty((b, nk, 2, h, d), dtype=q.dtype, device=q.device)
        dk, dv = dkv[:, :, 0], dkv[:, :, 1]
    delta = torch.empty_like(lse)
    lib = _lib(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, n, nk, h, *_strides(q), *_strides(k), *_strides(v), *_strides(dq),
            *_strides(dk), float(scale), _DTYPE_CODE[q.dtype], stream)
    _raise_on(err, lib, "backward")
    flash_sdpa.backward_launches += 1
    return dq, dk, dv


@torch.library.custom_op("toycrystals::flash_sdpa_fwd", mutates_args=(), device_types="cuda")
def flash_forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """The forward kernel as a torch op: O only (no log-sum-exp, no autograd).
    The head dim must be a multiple of 16, as for `_flash_forward_cuda`."""
    return _flash_forward_cuda(q, k, v, scale)[0]


@flash_forward_op.register_kernel("cpu")
def _flash_forward_op_cpu(q, k, v, scale):
    return sdpa_reference(q, k, v, scale).contiguous()


@flash_forward_op.register_fake
def _flash_forward_op_fake(q, k, v, scale):
    return q.new_empty(q.shape)


class _FlashKernel(torch.autograd.Function):
    """Kernel forward saving (q, k, v, O, L); backward kernels at those."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _flash_forward_cuda(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_backward_cuda(q, k, v, out, lse, grad_out, ctx.scale), None)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Blockwise (flash) SDPA of q [B, Nq, heads, d] against k, v [B, Nk,
    heads, d], exact math: the counterpart of JAX's `_flash_sdpa`. CUDA tensors run the kernels
    (differentiable: see `_FlashKernel`), CPU tensors the plain version.
    Nq or Nk % 128 != 0 or d > 128 raises ValueError. A head dim that is no multiple
    of 16 is zero-padded to the next one for the kernel, which is exact: zero
    columns add nothing to Q K^T and give zero output columns, which are cut."""
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return sdpa_reference(q, k, v)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    pad = _kernel_head_dim(d) - d
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = _FlashKernel.apply(q, k, v, scale)
    else:
        out = flash_forward_op(q, k, v, scale)
    return out[..., :d] if pad else out


flash_sdpa.launches = 0
flash_sdpa.backward_launches = 0


class SelfAttention2d(nn.Module):
    """Multi-head self-attention over the H*W tokens of [B, C, H, W]."""

    def __init__(self, ch: int, num_heads: int = 4, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto"):
        super().__init__()
        if ch % num_heads != 0:
            raise ValueError(f"ch ({ch}) must be divisible by num_heads ({num_heads})")
        if attn_impl not in ("auto", "xla", "flash"):
            raise ValueError(f"attn_impl must be auto|xla|flash, got {attn_impl!r}")
        self.ch, self.num_heads, self.dtype, self.attn_impl = ch, num_heads, dtype, attn_impl
        self.GroupNorm_0 = GroupNorm(ch, gn_groups(ch))
        self.qkv = nn.Linear(ch, 3 * ch)
        self.proj = nn.Linear(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        c, n = self.ch, h * w
        hd = c // self.num_heads
        y = tp.whole(self.GroupNorm_0(x), c).reshape(b, c, n).transpose(1, 2)   # [B, N, C]
        qkv = linear(y, self.qkv, self.dtype)
        blk = tp.param_block(self.qkv, "weight")
        if blk is not None and blk.parts == 1:  # heads that do not split: all of them here
            qkv = tp.whole(qkv, 3 * c, dim=-1)
        heads = self.num_heads // blk.size if blk is not None and blk.parts == 3 \
            else self.num_heads
        qkv = qkv.reshape(b, n, 3, heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]               # [B, N, heads, hd]
        space = spatial.current_space()
        if space is not None:  # every rank's tokens, in the whole image's row-major order
            k, v = (spatial.gather_space(t, space, dim=1) for t in (k, v))
        impl = attn_backend(self.attn_impl, k.shape[1], n, hd, x.device.type)
        o = flash_sdpa(q, k, v) if impl == "flash" else sdpa_reference(q, k, v)
        o = linear(o.reshape(b, n, heads * hd), self.proj, self.dtype)
        return x + o.transpose(1, 2).reshape(b, -1, h, w)
