"""Port of the rasterizer (toycrystals_torch/data/rasterize.py) against
toycrystals_tpu/data/rasterize.py on the same atoms, on the CPU.

The JAX Pallas kernel runs in interpret mode, as tests/test_rasterize.py runs
it. On the CPU the port's `rasterize` runs its plain version; the CUDA kernel
is held against that plain version on the card (tests/test_torch_rasterize_cuda.py,
chip_smoke.py). Tolerance rtol 1e-5 + atol 1e-5 (that of tests/test_rasterize.py):
f32 exponentials and sums over the atoms in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycrystals_torch.data import rasterize as tr
from toycrystals_tpu.data import rasterize as jr

TOL = dict(rtol=1e-5, atol=1e-5)


def _atoms(seed, b=3, p=256, h=32, w=32):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5.0, max(h, w) + 5.0, size=(b, p, 2)).astype(np.float32)
    wts = (rng.uniform(size=(b, p)) > 0.3).astype(np.float32)
    sigma = rng.uniform(0.6, 2.0, size=(b,)).astype(np.float32)
    return pts, wts, sigma


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("h,w", [(32, 32), (16, 24)])
def test_reference_matches_jax_reference(h, w):
    pts, wts, sigma = _atoms(0, h=h, w=w)
    for i in range(3):
        want = np.asarray(jr.rasterize_reference(jnp.asarray(pts[i]), jnp.asarray(wts[i]),
                                                 jnp.float32(sigma[i]), h, w))
        p, ws, s = _t(pts[i], wts[i], sigma[i:i + 1])
        got = tr.rasterize_reference(p, ws, s[0], h, w)
        assert got.shape == (h, w)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("h,w", [(32, 32), (16, 24)])
def test_separable_matches_jax_separable_and_own_reference(h, w):
    pts, wts, sigma = _atoms(1, h=h, w=w)
    want = np.asarray(jax.vmap(lambda a, b, c: jr.rasterize_separable(a, b, c, h, w))(
        jnp.asarray(pts), jnp.asarray(wts), jnp.asarray(sigma)))
    p, ws, s = _t(pts, wts, sigma)
    got = tr.rasterize_separable(p, ws, s, h, w)
    assert got.shape == (3, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = torch.stack([tr.rasterize_reference(p[i], ws[i], s[i], h, w) for i in range(3)])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_rasterize_matches_jax_pallas_kernel_in_interpret_mode():
    h = w = 32
    pts, wts, sigma = _atoms(2)
    want = np.asarray(jr.rasterize_pallas(jnp.asarray(pts), jnp.asarray(wts),
                                          jnp.asarray(sigma), h, w, True))
    before = tr.rasterize.launches
    got = tr.rasterize(*_t(pts, wts, sigma), h, w)
    assert tr.rasterize.launches == before  # the counter counts kernel launches only
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_rasterize_batch_matches_jax(backend):
    h = w = 32
    pts, wts, sigma = _atoms(3)
    if backend == "pallas":  # rasterize_batch has no interpret switch: normalise by hand
        img = jr.rasterize_pallas(jnp.asarray(pts), jnp.asarray(wts), jnp.asarray(sigma),
                                  h, w, True)
        want = jnp.clip(img / (jnp.max(img, axis=(1, 2), keepdims=True) + 1e-8), 0.0, 1.0)
    else:
        want = jr.rasterize_batch(jnp.asarray(pts), jnp.asarray(wts), jnp.asarray(sigma),
                                  h, w, "xla")
    got = tr.rasterize_batch(*_t(pts, wts, sigma), h, w).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert np.all(got.max(axis=(1, 2)) > 0.99)  # per-image peak 1


def test_zero_weights_give_zero_image():
    pts = torch.full((2, 128, 2), 8.0)
    wts = torch.zeros(2, 128)
    img = tr.rasterize(pts, wts, torch.ones(2), 16, 16)
    assert float(img.abs().max()) == 0.0
    out = tr.rasterize_batch(pts, wts, torch.ones(2), 16, 16)
    assert torch.isfinite(out).all() and float(out.abs().max()) == 0.0


def test_one_atom_peaks_at_its_pixel():
    pts = torch.zeros(1, 128, 2)
    wts = torch.zeros(1, 128)
    pts[0, 3] = torch.tensor([5.0, 11.0])  # (x, y)
    wts[0, 3] = 1.0
    img = tr.rasterize(pts, wts, torch.tensor([1.5]), 16, 16)[0]
    assert int(img.argmax()) == 11 * 16 + 5
    assert abs(float(img[11, 5]) - 1.0) < 1e-6
    assert abs(float(img[11, 6]) - float(np.exp(-1.0 / 4.5))) < 1e-6


@pytest.mark.parametrize("case", ["rank", "weights", "sigma", "p", "dtype", "strided",
                                  "device"])
def test_wrappers_reject_bad_input(case):
    pts, wts, sigma = _t(*_atoms(4, b=2, p=256))
    fn, err = tr._rasterize_cuda, ValueError
    if case == "rank":
        pts, fn = pts[0], tr.rasterize_separable
    elif case == "weights":
        wts, fn = wts[:, :128], tr.rasterize_separable
    elif case == "sigma":
        sigma = sigma[:1]
    elif case == "p":
        pts, wts = pts[:, :192].contiguous(), wts[:, :192].contiguous()
    elif case == "dtype":
        pts, err = pts.double(), TypeError
    elif case == "strided":
        wts = wts.t().contiguous().t()
    # "device": everything is well-formed but lies on the CPU
    with pytest.raises(err):
        fn(pts, wts, sigma, 16, 16)


# --- the kernel's cull, by its plain counterpart `tile_survivors` -----------------

GEOMETRIES = {  # label: (LatticeConfig kwargs, items)
    "64 rot_only": (dict(rot_only=True), 3),
    "64 full": (dict(), 3),
    "256 rot_only": (dict(img_size=256, rot_only=True), 2),
}


def _geometry(label):
    from toycrystals_torch.data.lattice import LatticeConfig, generate_item, static_point_budget

    kw, n = GEOMETRIES[label]
    cfg = LatticeConfig(**kw)
    pts, wts, sigma, *_ = generate_item(cfg, static_point_budget(cfg), 0, np.arange(n),
                                        device="cpu")
    return pts, wts, sigma, cfg.img_size, cfg.img_size


def _near_radius(sigmas=(1.2, 0.72, 1.68), p=384, size=128, seed=5):
    """Atoms at 0.3 px either side of the cut's radius sigma * sqrt(208) from
    the edges of 64-px tiles (the edges of 16- and 32-px tiles too), outside
    them: on every side of the interior edges at 64 and at size - 64."""
    rng = np.random.default_rng(seed)
    b = len(sigmas)
    pts = np.empty((b, p, 2), np.float32)
    for i, s in enumerate(sigmas):
        d = s * np.sqrt(208.0) + rng.uniform(-0.3, 0.3, size=p)
        edge = rng.choice([64.0, size - 64.0], size=p)
        side = rng.choice([-1.0, 1.0], size=p)  # below the edge's first row, or past its last
        across = np.where(side < 0, edge - d, edge - 1.0 + d)
        along = rng.uniform(0.0, size - 1.0, size=p)
        on_x = rng.uniform(size=p) < 0.5
        pts[i, :, 0] = np.where(on_x, across, along)
        pts[i, :, 1] = np.where(on_x, along, across)
    wts = np.ones((b, p), np.float32)
    return (*_t(pts, wts, np.asarray(sigmas, np.float32)), size, size)


def _render_tiles_from_survivors(pts, wts, sigma, h, w, tile):
    """Each tile rendered from its survivors alone, with the plain version's
    arithmetic."""
    lists = tr.tile_survivors(pts, wts, sigma, h, w, tile)
    tiles_x = -(-w // tile)
    out = torch.zeros(pts.shape[0], h, w)
    for b, per_tile in enumerate(lists):
        c = 1.0 / (2.0 * sigma[b] * sigma[b])
        for t, idx in enumerate(per_tile):
            r0, c0 = (t // tiles_x) * tile, (t % tiles_x) * tile
            rows = torch.arange(r0, min(r0 + tile, h), dtype=torch.float32)
            cols = torch.arange(c0, min(c0 + tile, w), dtype=torch.float32)
            dy = rows[:, None] - pts[b, idx, 1][None, :]
            dx = cols[None, :] - pts[b, idx, 0][:, None]
            ey = torch.exp(-(dy * dy) * c) * wts[b, idx][None, :]
            ex = torch.exp(-(dx * dx) * c)
            out[b, r0:r0 + len(rows), c0:c0 + len(cols)] = ey @ ex
    return out, lists


@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("label", [*GEOMETRIES, "near radius"])
def test_tiles_rendered_from_survivors_equal_the_plain_version(label, tile):
    pts, wts, sigma, h, w = _near_radius() if label == "near radius" else _geometry(label)
    got, lists = _render_tiles_from_survivors(pts, wts, sigma, h, w, tile)
    want = tr.rasterize_separable(pts, wts, sigma, h, w)
    peak = want.amax(dim=(1, 2), keepdim=True)
    assert float(((got - want).abs() / peak).max()) <= 1e-6
    # the cull drops most weighted atoms of a tile: far fewer survivors than atoms
    weighted = int((wts != 0).sum(dim=1).max())
    assert max(len(i) for per in lists for i in per) < weighted


@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("label", [*GEOMETRIES, "near radius"])
def test_culled_atoms_have_exactly_zero_factors_on_the_tile(label, tile):
    """For every (weighted atom, tile) pair the cull drops, torch.exp in f32
    gives exactly 0.0 at every row of the tile or at every column."""
    pts, wts, sigma, h, w = _near_radius() if label == "near radius" else _geometry(label)
    keep = tr.tile_keep_mask(pts, wts, sigma, h, w, tile)
    c = (1.0 / (2.0 * sigma * sigma))[:, None, None, None]

    def all_zero(coord, n):  # [B, P] -> [B, tiles, P]: the factor is 0 on the whole band
        idx = torch.arange(n, dtype=torch.float32)
        pad = -(-n // tile) * tile - n  # rows past the image repeat its last row
        idx = torch.cat([idx, idx[-1:].expand(pad)]).reshape(-1, tile)
        d = idx[None, :, :, None] - coord[:, None, None, :]
        return (torch.exp(-(d * d) * c) == 0.0).all(dim=2)

    rows_zero = all_zero(pts[..., 1], h)[:, :, None, :]
    cols_zero = all_zero(pts[..., 0], w)[:, None, :, :]
    dropped = ~keep & (wts != 0)[:, None, None, :]
    assert int(dropped.sum()) > 0
    assert bool((rows_zero | cols_zero)[dropped].all())


def test_survivor_lists_keep_index_order_and_a_crowded_tile_keeps_every_atom():
    pts, wts, sigma, h, w = _geometry("64 rot_only")
    for b, per_tile in enumerate(tr.tile_survivors(pts, wts, sigma, h, w, 32)):
        for idx in per_tile:
            assert bool((idx[1:] > idx[:-1]).all())
            assert bool((wts[b, idx] != 0).all())
    # every atom of the 256x256 budget, weight 1, inside one 32-px tile
    rng = np.random.default_rng(7)
    p = 9728
    crowd = rng.uniform(96.0, 127.999, size=(1, p, 2)).astype(np.float32)
    pts, wts, sigma = _t(crowd, np.ones((1, p), np.float32), np.array([1.2], np.float32))
    lists = tr.tile_survivors(pts, wts, sigma, 256, 256, 32)[0]
    assert torch.equal(lists[3 * 8 + 3], torch.arange(p))
    far = lists[0]  # tile (0, 0) lies 64 px away
    assert len(far) == 0


@pytest.mark.parametrize("name", ["points", "weights"])
def test_kernel_wrapper_rejects_inputs_not_aligned_to_16_bytes(name):
    pts, wts, sigma = _t(*_atoms(4, b=2, p=256))
    pts, wts = pts.clone(), wts.clone()  # fresh storage, aligned
    base = torch.zeros(pts.numel() + 2 if name == "points" else wts.numel() + 2)
    view = base[2:] if base.data_ptr() % 16 == 0 else base[1:]  # 8 or 4 bytes off
    assert view.data_ptr() % 16 != 0
    if name == "points":
        view = view[:pts.numel()].view(pts.shape)
        view.copy_(pts)
        pts = view
    else:
        view = view[:wts.numel()].view(wts.shape)
        view.copy_(wts)
        wts = view
    with pytest.raises(ValueError, match="16 bytes"):
        tr._rasterize_cuda(pts, wts, sigma, 16, 16)
    # aligned, the same inputs pass every check but the device's
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tr._rasterize_cuda(pts.clone(), wts.clone(), sigma, 16, 16)
