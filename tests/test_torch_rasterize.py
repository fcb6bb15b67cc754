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
