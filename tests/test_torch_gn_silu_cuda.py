"""The CUDA GroupNorm+SiLU(+halo) kernel (toycrystals_torch/csrc/gn_silu.cu)
against its plain PyTorch version, on the card.

Every test here is marked `cuda` and skips without a card. On a machine with
one NVIDIA GPU and nvcc, run them without tests/conftest.py, which imports
JAX (the port does not need it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gn_silu_cuda.py -q
"""

import pytest
import torch

from toycrystals_torch.ops import groupnorm as gn

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (3e-2, 1.6e-2)}  # (atol, rtol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _inputs(device, shape, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g, device=device) * 2.0 + 0.5).to(dtype)
    scale = torch.randn(c, generator=g, device=device) * 0.1 + 1.0
    bias = torch.randn(c, generator=g, device=device) * 0.1
    return x, scale, bias


def _check(x, scale, bias, groups, pad):
    before = gn.gn_silu.launches
    got = gn.gn_silu(x, scale, bias, groups, pad=pad)
    torch.cuda.synchronize()
    assert gn.gn_silu.launches == before + 1
    want = gn.gn_silu_reference(x, scale, bias, groups, pad=pad)
    assert got.dtype == x.dtype and got.shape == want.shape
    atol, rtol = TOL[x.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,groups", [
    ((4, 96, 64, 64), 8), ((4, 192, 16, 16), 8),   # U-Net blocks, few rows
    ((3, 12, 8, 8), 4), ((2, 6, 7, 7), 2), ((2, 16, 5, 9), 8),
])
def test_kernel_matches_plain_version(cuda, shape, groups, dtype, pad):
    _check(*_inputs(cuda, shape, dtype), groups, pad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_on_unaligned_storage(cuda, dtype):
    """A contiguous view that starts off a 16-byte boundary takes the scalar loads."""
    shape = (2, 16, 8, 8)
    x, scale, bias = _inputs(cuda, shape, dtype, seed=1)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    xu = flat[1:].view(shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    _check(xu, scale, bias, 8, True)


@pytest.mark.parametrize("case", ["strided", "half"])
def test_kernel_wrapper_raises_on_cuda(cuda, case):
    x, scale, bias = _inputs(cuda, (2, 8, 4, 4), torch.float32)
    err = ValueError
    if case == "strided":
        x = x.transpose(2, 3)
    else:
        x, err = x.half(), TypeError
    before = gn.gn_silu.launches
    with pytest.raises(err):
        gn.gn_silu(x, scale, bias, 4)
    assert gn.gn_silu.launches == before


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_forward_under_autograd_gives_plain_gradients(cuda, dtype, pad):
    """A call that needs gradients launches the kernel forward and returns
    the plain version's gradients (the same plain backward on both sides, so
    they agree to rounding of the upstream gradient only)."""
    x, scale, bias = _inputs(cuda, (3, 16, 6, 10), dtype, seed=2)
    g = torch.Generator(device=cuda).manual_seed(3)
    p = 2 if pad else 0
    upstream = torch.randn((3, 16, 6 + p, 10 + p), generator=g, device=cuda).to(dtype)
    grads = []
    for fn in (gn.gn_silu, gn.gn_silu_reference):
        leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
        before = gn.gn_silu.launches
        y = fn(*leaves, 8, 1e-6, pad)
        assert gn.gn_silu.launches == before + (fn is gn.gn_silu)
        grads.append(torch.autograd.grad(y, leaves, upstream))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=0)
