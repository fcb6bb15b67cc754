"""The space axis's kernels on the card: the GroupNorm sums and apply kernels
(toycrystals_torch/csrc/gn_silu.cu) against their plain versions, the flash
forward and backward of Nq queries against Nk gathered keys
(csrc/flash_attn.cu) against the plain SDPA and its autograd, and the halo
exchange of parallel/spatial.py between two ranks that share the card over
gloo (torch documents gloo's send and recv as CPU-only; the exchange is an
all_gather, which gloo runs on CUDA tensors).

Every test here is marked `cuda` and skips without a card. On a machine with
one NVIDIA GPU and nvcc, run them without tests/conftest.py, which imports
JAX (the port does not need it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spatial_cuda.py -q
"""

import pytest
import torch

from toycrystals_torch.ops import attention as at
from toycrystals_torch.ops import groupnorm as gn
from toycrystals_torch.parallel import launch
from toycrystals_torch.parallel.parity import halo_probe

pytestmark = pytest.mark.cuda

# as tests/test_torch_gn_silu_cuda.py and test_torch_flash_attention_cuda.py
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (3e-2, 1.6e-2)}
SHARE = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


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


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,groups", [
    ((24, 96, 128, 256), 8), ((4, 96, 32, 64), 8), ((2, 192, 8, 16), 8), ((3, 12, 5, 7), 4)])
def test_sums_and_apply_kernels_match_plain_versions(cuda, shape, groups, dtype, pad):
    """One rank's rows of a 2-rank image: the sums of its rows, the global
    statistics from both halves' sums (added in-process), the apply pass."""
    x, scale, bias = _inputs(cuda, shape, dtype)
    other = _inputs(cuda, shape, dtype, seed=1)[0]
    s0, a0 = gn.gn_silu.sums_launches, gn.gn_silu.apply_launches
    sums = gn.gn_sums(x, groups)
    torch.cuda.synchronize()
    assert gn.gn_silu.sums_launches == s0 + 1
    want_sums = gn.gn_sums_reference(x, groups)
    torch.testing.assert_close(sums, want_sums, atol=1e-3, rtol=1e-5)
    total = sums + gn.gn_sums(other, groups)
    count = shape[1] // groups * shape[2] * shape[3] * 2
    got = gn.gn_silu_apply(x, total, count, scale, bias, groups, pad=pad)
    torch.cuda.synchronize()
    assert gn.gn_silu.apply_launches == a0 + 1
    want = gn.gn_silu_apply_reference(x, total, count, scale, bias, groups, pad=pad)
    atol, rtol = TOL[dtype]
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # the two halves' statistics are the whole image's: the one-launch kernel's
    whole = gn.gn_silu(torch.cat([x, other], dim=2), scale, bias, groups)
    torch.testing.assert_close(gn.gn_silu_apply(x, total, count, scale, bias, groups).float(),
                               whole[:, :, :shape[2]].float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,nk", [((24, 2048, 4, 48), 4096), ((24, 1024, 4, 48), 4096),
                                      ((2, 128, 4, 48), 384), ((2, 256, 2, 64), 128)])
def test_flash_forward_of_fewer_queries_than_keys(cuda, shape, nk, dtype):
    b, n, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(shape, generator=g, device=cuda).to(dtype)
    kv = torch.randn((b, nk, 2, h, d), generator=g, device=cuda).to(dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]
    before = at.flash_sdpa.launches
    with torch.no_grad():
        got = at.flash_sdpa(q, k, v)
    torch.cuda.synchronize()
    assert at.flash_sdpa.launches == before + 1 and got.shape == q.shape
    want = at.sdpa_reference(q.float(), k.float(), v.float())
    err = float((got.float() - want).abs().max())
    assert err <= SHARE[dtype] * float(want.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,nk", [((2, 2048, 4, 48), 4096), ((2, 1024, 4, 48), 4096),
                                      ((2, 128, 2, 24), 384)])
def test_flash_backward_of_fewer_queries_than_keys(cuda, shape, nk, dtype):
    """dq [B, Nq, heads, d], and dk, dv [B, Nk, heads, d] (this rank's queries'
    share of every gathered key's gradient) against autograd of the plain
    version, within the share of each largest entry of
    tests/test_torch_flash_attention_cuda.py."""
    b, n, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(shape, generator=g, device=cuda).to(dtype)
    kv = torch.randn((b, nk, 2, h, d), generator=g, device=cuda).to(dtype)
    upstream = torch.randn(shape, generator=g, device=cuda).to(dtype)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, kv[:, :, 0], kv[:, :, 1])]
    fwd, bwd = at.flash_sdpa.launches, at.flash_sdpa.backward_launches
    got = torch.autograd.grad(at.flash_sdpa(*leaves), leaves, upstream)
    torch.cuda.synchronize()
    assert (at.flash_sdpa.launches, at.flash_sdpa.backward_launches) == (fwd + 1, bwd + 1)
    ref = [t.detach().float().requires_grad_(True) for t in leaves]
    want = torch.autograd.grad(at.sdpa_reference(*ref), ref, upstream.float())
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        err = float((a.float() - w).abs().max())
        assert err <= SHARE[dtype] * float(w.abs().max()), (name, err)


def test_halo_exchange_over_gloo_between_two_ranks_on_one_card(cuda):
    """Two ranks on cuda:0 over gloo: each one's halo rows are its
    neighbours', wrapped and clamped, on CUDA tensors."""
    got = launch(halo_probe, 2, ("cuda",), device_type="cuda", backend="gloo",
                 device_ids=[0, 0], timeout=120)
    for rank, (top, bottom, top_c, bottom_c) in enumerate(got):
        assert top == bottom == 1 - rank  # wrapped: the other rank on both sides
        assert (top_c, bottom_c) == (0, 1)  # clamped: rank 0's top, rank 1's bottom
