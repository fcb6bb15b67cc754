"""The CUDA GroupNorm+SiLU(+halo) kernels (toycrystals_torch/csrc/gn_silu.cu),
forward and backward, against their plain PyTorch versions, on the card.

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
# Gradients, as a share of each gradient's largest entry: f32 sums in another
# order; bf16 dx is rounded to bf16 (2^-8 relative) on both sides, and autograd
# of the plain version folds the halo in bf16.
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


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
    """A call that needs gradients launches the forward kernel, and its
    backward the backward kernel; the gradients agree with autograd through
    the plain version within GRAD_TOL of each gradient's largest entry."""
    x, scale, bias = _inputs(cuda, (3, 16, 6, 10), dtype, seed=2)
    g = torch.Generator(device=cuda).manual_seed(3)
    p = 2 if pad else 0
    upstream = torch.randn((3, 16, 6 + p, 10 + p), generator=g, device=cuda).to(dtype)
    grads = []
    for fn in (gn.gn_silu, gn.gn_silu_reference):
        leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
        before = (gn.gn_silu.launches, gn.gn_silu.backward_launches)
        y = fn(*leaves, 8, 1e-6, pad)
        grads.append(torch.autograd.grad(y, leaves, upstream))
        kernel = int(fn is gn.gn_silu)
        assert (gn.gn_silu.launches, gn.gn_silu.backward_launches) == \
            (before[0] + kernel, before[1] + kernel)
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
        err = float((got.float() - want.float()).abs().max())
        assert err <= GRAD_TOL[dtype] * float(want.float().abs().max())


def _backward(x, scale, bias, groups, pad, seed=4):
    """The backward kernel's (dx, dscale, dbias) under a random upstream
    gradient, and the closed-form plain backward's on the same values."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    b, c, h, w = x.shape
    p = 2 if pad else 0
    up = torch.randn((b, c, h + p, w + p), generator=g, device=x.device).to(x.dtype)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, scale, bias)]
    before = gn.gn_silu.backward_launches
    y = gn.gn_silu(*leaves, groups, 1e-6, pad)
    got = torch.autograd.grad(y, leaves, up)
    torch.cuda.synchronize()
    assert gn.gn_silu.backward_launches == before + 1
    want = gn.gn_silu_backward_reference(x, scale, bias, up, groups, 1e-6, pad)
    return got, want


def _check_backward(x, scale, bias, groups, pad):
    got, want = _backward(x, scale, bias, groups, pad)
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        err = float((a.float() - w.float()).abs().max())
        assert err <= GRAD_TOL[x.dtype] * float(w.float().abs().max()), (name, err)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,groups", [
    ((4, 96, 64, 64), 8), ((4, 192, 16, 16), 8), ((2, 96, 256, 256), 8),
    ((3, 12, 8, 8), 4), ((2, 6, 7, 7), 2), ((2, 16, 5, 9), 8),
    ((2, 8, 1, 2), 4), ((2, 8, 2, 1), 4), ((1, 4, 1, 1), 1),
])
def test_backward_kernel_matches_plain_backward(cuda, shape, groups, dtype, pad):
    _check_backward(*_inputs(cuda, shape, dtype, seed=5), groups, pad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernel_on_unaligned_storage(cuda, dtype):
    """x and the upstream gradient at addresses off a 16-byte boundary: the
    rows reach shared memory through a scalar head and tail."""
    shape = (2, 16, 8, 8)
    x, scale, bias = _inputs(cuda, shape, dtype, seed=6)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    xu = flat[1:].view(shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    _check_backward(xu, scale, bias, 8, True)


# (shape, groups, CTAs per (item, group) on a 132-SM card: at least 2 * 132 CTAs
# in all, at most 16, more where the rows overflow shared memory; 0 = the mode
# that reads its rows twice because 16 CTAs' shared memory cannot hold them)
CLUSTER_CASES = [((33, 64, 8, 8), 8, 1), ((17, 64, 8, 8), 8, 2), ((11, 64, 8, 8), 8, 3),
                 ((9, 64, 8, 8), 8, 4), ((33, 8, 8, 8), 1, 8), ((1, 8, 64, 64), 8, 16),
                 ((1, 8, 512, 512), 1, 0)]


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("shape,groups,cluster", CLUSTER_CASES)
def test_kernel_at_each_cluster_size(cuda, shape, groups, cluster, backward):
    """f32, pad on: one shape per cluster size, and one slab past 16 CTAs'
    shared memory (f32 [1, 8, 512, 512] in one group, 8 MB)."""
    plan = gn.kernel_plan(shape, groups, torch.float32, True, backward=backward)
    if torch.cuda.get_device_properties(cuda).multi_processor_count == 132:
        if cluster:
            assert plan["rows_in_shared_memory"] and plan["cluster"] == cluster, plan
        else:
            assert not plan["rows_in_shared_memory"], plan
    x, scale, bias = _inputs(cuda, shape, torch.float32, seed=7)
    if backward:
        _check_backward(x, scale, bias, groups, True)
    else:
        _check(x, scale, bias, groups, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 96, 64, 64), (2, 96, 256, 256)])
def test_kernels_repeat_bit_for_bit(cuda, shape, dtype):
    """No atomics: two runs give the same output and gradients, bit for bit."""
    x, scale, bias = _inputs(cuda, shape, dtype, seed=8)
    first, _ = _backward(x, scale, bias, 8, True)
    again, _ = _backward(x, scale, bias, 8, True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert torch.equal(gn.gn_silu(x, scale, bias, 8, pad=True),
                       gn.gn_silu(x, scale, bias, 8, pad=True))
