"""The CUDA Gaussian-atom rasterizer (toycrystals_torch/csrc/rasterize.cu)
against its plain PyTorch version, on the card.

Every test here is marked `cuda` and skips without a card. On a machine with
one NVIDIA GPU and nvcc, run them without tests/conftest.py, which imports
JAX (the port does not need it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rasterize_cuda.py -q

Tolerance: atol 1e-5 + rtol 1e-5 in f32 (the kernel and `torch.bmm` sum the
atoms in different orders; both run full f32 with TF32 off).
"""

import pytest
import torch

from toycrystals_torch.data import rasterize as rz

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _atoms(device, b, p, h, w, seed=0, keep=0.7):
    g = torch.Generator(device=device).manual_seed(seed)
    lo, span = -5.0, max(h, w) + 10.0
    pts = torch.rand((b, p, 2), generator=g, device=device) * span + lo
    wts = (torch.rand((b, p), generator=g, device=device) < keep).float()
    sigma = torch.rand((b,), generator=g, device=device) * 1.4 + 0.6
    return pts, wts, sigma


def _check(pts, wts, sigma, h, w):
    before = rz.rasterize.launches
    got = rz.rasterize(pts, wts, sigma, h, w)
    torch.cuda.synchronize()
    assert rz.rasterize.launches == before + 1
    want = rz.rasterize_separable(pts, wts, sigma, h, w)
    assert got.shape == want.shape == (pts.shape[0], h, w) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    return got


@pytest.mark.parametrize("b,p,h,w", [
    (8, 2432, 64, 64),     # the training batch's budget
    (3, 768, 32, 32),
    (2, 9728, 256, 256),   # 4 x 4 tiles per image
    (2, 256, 40, 100),     # H != W, ragged tiles
    (1, 128, 7, 5),
])
def test_kernel_matches_plain_version(cuda, b, p, h, w):
    _check(*_atoms(cuda, b, p, h, w), h, w)


def test_zero_weights_give_exactly_zero(cuda):
    pts, wts, sigma = _atoms(cuda, 2, 256, 64, 64)
    got = _check(pts, torch.zeros_like(wts), sigma, 64, 64)
    assert float(got.abs().max()) == 0.0


def test_one_atom_peaks_at_its_pixel(cuda):
    pts, wts, sigma = _atoms(cuda, 1, 128, 64, 64)
    wts.zero_()
    wts[0, 5] = 1.0
    pts[0, 5] = torch.tensor([20.0, 41.0], device=cuda)  # (x, y)
    got = _check(pts, wts, sigma, 64, 64)
    assert int(got[0].argmax()) == 41 * 64 + 20
    assert abs(float(got[0, 41, 20]) - 1.0) < 1e-6


def test_batch_render_is_normalised(cuda):
    pts, wts, sigma = _atoms(cuda, 4, 256, 64, 64)
    x = rz.rasterize_batch(pts, wts, sigma, 64, 64)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert bool((x.amax(dim=(1, 2)) > 0.99).all())


@pytest.mark.parametrize("case", ["p", "dtype", "strided", "shape", "mixed"])
def test_kernel_wrapper_raises_on_cuda(cuda, case):
    pts, wts, sigma = _atoms(cuda, 2, 256, 16, 16)
    err = ValueError
    if case == "p":
        pts, wts = pts[:, :192].contiguous(), wts[:, :192].contiguous()
    elif case == "dtype":
        wts, err = wts.double(), TypeError
    elif case == "strided":
        wts = wts.t().contiguous().t()
    elif case == "shape":
        sigma = sigma[:1]
    else:
        sigma = sigma.cpu()
    before = rz.rasterize.launches
    with pytest.raises(err):
        rz.rasterize(pts, wts, sigma, 16, 16)
    assert rz.rasterize.launches == before
