"""Training under the space axis on the card: the GroupNorm+SiLU backward pair
(toycrystals_torch/csrc/gn_silu.cu, `gn_silu_bwd_sums_kernel` and
`gn_silu_bwd_apply_kernel`) against their plain versions, and the pair, with
the group's sums added in-process, against the closed-form backward of the
whole image.

Every test here is marked `cuda` and skips without a card. On a machine with
one NVIDIA GPU and nvcc, run them without tests/conftest.py, which imports
JAX (the port does not need it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spatial_train_cuda.py -q

The flash backward at Nq != Nk is held in tests/test_torch_spatial_cuda.py.
"""

import pytest
import torch

from toycrystals_torch.ops import groupnorm as gn

pytestmark = pytest.mark.cuda

# share of each result's largest entry, as tests/test_torch_gn_silu_cuda.py's GRAD_TOL
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
SHAPES = [((32, 96, 128, 256), 8), ((4, 96, 32, 64), 8), ((2, 192, 8, 16), 8),
          ((3, 12, 5, 7), 4), ((2, 8, 1, 12), 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _rank(device, shape, dtype, pad, seed=0):
    """One rank's rows x of a 2-rank image, the forward's sums over both
    ranks' rows, its padded upstream gradient and its neighbours' edge rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, c, h, w = shape
    x, other = ((torch.randn(shape, generator=g, device=device) * 2.0 + 0.5).to(dtype)
                for _ in range(2))
    scale = torch.randn(c, generator=g, device=device) * 0.1 + 1.0
    bias = torch.randn(c, generator=g, device=device) * 0.1
    p = 1 if pad else 0
    grad = torch.randn((b, c, h + 2 * p, w + 2 * p), generator=g, device=device).to(dtype)
    edge = torch.randn((b, c, 2, w + 2), generator=g, device=device).to(dtype) if pad else None
    groups = next(gr for (s, gr) in SHAPES if s == shape)
    sums = gn.gn_sums_reference(x, groups) + gn.gn_sums_reference(other, groups)
    count = c // groups * h * w * 2
    return x, scale, bias, grad, edge, sums, count, groups


def _close(got, want, dtype, what):
    err = float((got.float() - want.float()).abs().max())
    assert err <= GRAD_TOL[dtype] * float(want.float().abs().max()) + 1e-30, (what, err)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [s for s, _ in SHAPES])
def test_backward_pair_matches_plain_versions(cuda, shape, dtype, pad):
    x, scale, bias, grad, edge, sums, count, groups = _rank(cuda, shape, dtype, pad)
    s0, a0 = gn.gn_silu.backward_sums_launches, gn.gn_silu.backward_apply_launches
    chan = gn.gn_silu_backward_sums(x, grad, edge, sums, count, scale, bias, groups, pad=pad)
    torch.cuda.synchronize()
    assert gn.gn_silu.backward_sums_launches == s0 + 1 and chan.shape == (*shape[:2], 2)
    want = gn.gn_silu_backward_sums_reference(x, grad, edge, sums, count, scale, bias, groups,
                                              pad=pad)
    _close(chan, want, torch.float32, "sums")
    # the other rank's share of the group's sums, as the all-reduce adds it
    dsums = (want * scale.reshape(1, -1, 1)).reshape(shape[0], groups, -1, 2).sum(2) * 2.0
    dx = gn.gn_silu_backward_apply(x, grad, edge, sums, dsums, count, scale, bias, groups,
                                   pad=pad)
    torch.cuda.synchronize()
    assert gn.gn_silu.backward_apply_launches == a0 + 1
    assert dx.dtype == dtype and dx.shape == x.shape
    want_dx = gn.gn_silu_backward_apply_reference(x, grad, edge, sums, dsums, count, scale, bias,
                                                  groups, pad=pad)
    _close(dx, want_dx, dtype, "dx")


@pytest.mark.parametrize("pad", [False, True])
def test_backward_pair_on_one_rank_is_the_closed_form(cuda, pad):
    """With the group's sums over one rank's rows and its own wrap returned as
    the edge rows, the pair gives `gn_silu_backward_reference`."""
    g = torch.Generator(device=cuda).manual_seed(5)
    shape, groups = (4, 96, 32, 64), 8
    x = (torch.randn(shape, generator=g, device=cuda) * 2.0 + 0.5)
    scale = torch.randn(96, generator=g, device=cuda) * 0.1 + 1.0
    bias = torch.randn(96, generator=g, device=cuda) * 0.1
    p = 1 if pad else 0
    grad = torch.randn((4, 96, 32 + 2 * p, 64 + 2 * p), generator=g, device=cuda)
    edge = torch.cat([grad[:, :, -1:], grad[:, :, :1]], dim=2) if pad else None
    sums = gn.gn_sums(x, groups)
    count = 96 // groups * 32 * 64
    chan = gn.gn_silu_backward_sums(x, grad, edge, sums, count, scale, bias, groups, pad=pad)
    dsums = (chan * scale.reshape(1, -1, 1)).reshape(4, groups, -1, 2).sum(2)
    dx = gn.gn_silu_backward_apply(x, grad, edge, sums, dsums, count, scale, bias, groups,
                                   pad=pad)
    wx, ws, wb = gn.gn_silu_backward_reference(x, scale, bias, grad, groups, pad=pad)
    _close(dx, wx, torch.float32, "dx")
    _close(chan.sum(0)[:, 1], ws, torch.float32, "dscale")
    _close(chan.sum(0)[:, 0], wb, torch.float32, "dbias")


def test_backward_wrappers_raise_on_cuda(cuda):
    x = torch.randn((2, 8, 4, 6), device=cuda)
    sc, bi = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    sums = gn.gn_sums(x, 2)
    with pytest.raises(ValueError, match="grad_out"):
        gn.gn_silu_backward_sums(x, torch.zeros((2, 8, 4, 6), device=cuda), None, sums, 96, sc,
                                 bi, 2, pad=True)
    with pytest.raises(ValueError, match="edge rows"):
        gn.gn_silu_backward_sums(x, torch.zeros((2, 8, 6, 8), device=cuda), None, sums, 96, sc,
                                 bi, 2, pad=True)
