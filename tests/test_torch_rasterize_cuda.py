"""The CUDA Gaussian-atom rasterizer (toycrystals_torch/csrc/rasterize.cu)
against its plain PyTorch version, on the card.

Every test here is marked `cuda` and skips without a card. On a machine with
one NVIDIA GPU and nvcc, run them without tests/conftest.py, which imports
JAX (the port does not need it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rasterize_cuda.py -q

Tolerance: atol 1e-5 + rtol 1e-5 in f32 (the kernel and `torch.bmm` sum the
atoms in different orders; both run full f32 with TF32 off). The kernel's
cull is exact: with it and without it (`cull=False`, every atom at every
pixel) the kernel gives the same bits, and so does a rerun.
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


@pytest.mark.parametrize("case", ["p", "dtype", "strided", "shape", "mixed", "misaligned"])
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
    elif case == "mixed":
        sigma = sigma.cpu()
    else:  # 8 bytes off the 16 that the bulk copies need
        pts = torch.cat([torch.zeros(2, device=cuda), pts.flatten()])[2:].view(pts.shape)
    before = rz.rasterize.launches
    with pytest.raises(err):
        rz.rasterize(pts, wts, sigma, 16, 16)
    assert rz.rasterize.launches == before


def _crowded(device, b=1, p=9728, lo=96.0):
    """Every atom of the 256x256 budget, weight 1, inside one 32-px tile."""
    g = torch.Generator(device=device).manual_seed(3)
    pts = torch.rand((b, p, 2), generator=g, device=device) * 31.999 + lo
    return pts, torch.ones((b, p), device=device), torch.full((b,), 1.2, device=device)


def _near_radius(device, sigmas=(1.2, 0.72, 1.68), p=1024, size=256):
    """Atoms 0.3 px either side of the cut's radius sigma * sqrt(208) outside
    the edges at 64, 128 and 192 (edges of tiles and of warp sub-tiles)."""
    g = torch.Generator(device=device).manual_seed(4)
    b = len(sigmas)
    s = torch.tensor(sigmas, device=device)[:, None]
    d = s * 208.0 ** 0.5 + (torch.rand((b, p), generator=g, device=device) - 0.5) * 0.6
    edge = 64.0 * torch.randint(1, 4, (b, p), generator=g, device=device).float()
    below = torch.rand((b, p), generator=g, device=device) < 0.5
    across = torch.where(below, edge - d, edge - 1.0 + d)
    along = torch.rand((b, p), generator=g, device=device) * (size - 1)
    on_x = torch.rand((b, p), generator=g, device=device) < 0.5
    pts = torch.stack([torch.where(on_x, across, along), torch.where(on_x, along, across)], -1)
    return pts.contiguous(), torch.ones((b, p), device=device), s[:, 0].contiguous()


def _exact(pts, wts, sigma, h, w, **plan):
    """Kernel against the plain version; the cull changes no bit; a rerun repeats."""
    got = rz._rasterize_cuda(pts, wts, sigma, h, w, **plan)
    torch.cuda.synchronize()
    want = rz.rasterize_separable(pts, wts, sigma, h, w)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, rz._rasterize_cuda(pts, wts, sigma, h, w, **plan))
    assert torch.equal(got, rz._rasterize_cuda(pts, wts, sigma, h, w, cull=False, **plan))
    return got


# (CTAs; 0 = the plan's): a grid smaller than the items makes each CTA stream
# the atoms of several items through its ring.
@pytest.mark.parametrize("ctas", [0, 1, 5])
def test_crowded_tile_renders_every_atom(cuda, ctas):
    pts, wts, sigma = _crowded(cuda)
    got = _exact(pts, wts, sigma, 256, 256, ctas=ctas)
    assert float(got[0, :64, :64].abs().max()) == 0.0  # 32 px beyond the cut's radius
    assert float(got[0, 96:128, 96:128].min()) > 0.0


@pytest.mark.parametrize("ctas", [0, 1, 5])
def test_atoms_near_the_cut_radius(cuda, ctas):
    pts, wts, sigma = _near_radius(cuda)
    _exact(pts, wts, sigma, 256, 256, ctas=ctas)


# 256x256: 16 tiles per image; 40x100: 2
@pytest.mark.parametrize("h,w,ctas", [(256, 256, 0), (256, 256, 1), (256, 256, 5),
                                      (256, 256, 7), (40, 100, 0), (40, 100, 1), (40, 100, 3)])
def test_every_grid(cuda, h, w, ctas):
    plan = rz.kernel_plan(2, 1024, h, w, ctas=ctas)
    assert plan["tile"] == 64
    assert plan["ctas"] == (ctas or plan["items"])  # 2 images: fewer items than the card holds
    _exact(*_atoms(cuda, 2, 1024, h, w, seed=h + ctas), h, w, ctas=ctas)


@pytest.mark.parametrize("h,w", [(5, 100), (100, 7), (7, 5), (16, 17), (65, 63)])
@pytest.mark.parametrize("ctas", [0, 1])
def test_small_and_ragged_images(cuda, h, w, ctas):
    _exact(*_atoms(cuda, 3, 256, h, w, seed=h * w), h, w, ctas=ctas)


@pytest.mark.parametrize("b,p,size", [(128, 1408, 64), (4096, 2432, 64), (32, 9728, 256),
                                      (128, 2432, 32), (1, 128, 64)])
def test_plan_covers_every_tile(cuda, b, p, size):
    """One item per 64-px tile of every image; the grid is one CTA per item,
    or as many as the card holds at once (at least one per SM)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = rz.kernel_plan(b, p, size, size)
    assert plan["items"] == b * (-(-size // 64)) ** 2
    assert plan["ctas"] == plan["items"] or sms <= plan["ctas"] < plan["items"]


def test_training_batches_rerun_bit_equal(cuda):
    from toycrystals_torch.data.lattice import LatticeConfig, generate_item, static_point_budget

    for cfg, b in ((LatticeConfig(rot_only=True), 128), (LatticeConfig(), 128),
                   (LatticeConfig(img_size=256, rot_only=True), 32)):
        pts, wts, sigma, *_ = generate_item(cfg, static_point_budget(cfg), 0, torch.arange(b),
                                            cuda)
        _exact(pts, wts, sigma, cfg.img_size, cfg.img_size)
