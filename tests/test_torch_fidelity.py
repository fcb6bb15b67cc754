"""The port's lattice-fidelity instrument (toycrystals_torch/utils/fidelity.py)
and PNG reader (utils/figures.py:read_png) against the JAX package on the CPU.

Tolerances: read_png equals plt.imread exactly; spectra, template-bank
spectra, correlations and resized tiles within 1e-5 absolute (f32 FFTs and
sums in another order); pred_type and type_correct exactly; theta_hat
exactly (both pick the same bank entry); the scalar scores of the committed
grids within 1e-5.
"""

import math
import struct
import zlib

import jax
import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from toycrystals_torch.utils import fidelity as tf
from toycrystals_torch.utils.figures import read_png, save_image_grid
from toycrystals_tpu.data.lattice import LatticeConfig as JLatticeConfig
from toycrystals_tpu.data.datasets import generate_batch as jax_generate_batch
from toycrystals_tpu.utils import fidelity as jf

GRIDS = ["score_based_diffusion_samples", "distill_16step", "distill_4step",
         "fm64_rf50_samples"]


def _grid(name):
    return f"assets/score_based_diffusion/{name}.png"


@pytest.mark.parametrize("name", GRIDS)
def test_read_png_equals_plt_imread_on_the_committed_grids(name):
    got, want = read_png(_grid(name)), plt.imread(_grid(name))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (1200, 1200, 4)
    np.testing.assert_array_equal(got, want)


def _png(rows: np.ndarray, colour: int, depth: int = 8, interlace: int = 0,
         filters=None) -> bytes:
    """A PNG of [H, W*C] uint8 scanlines, each filtered with `filters[y]`."""
    h = rows.shape[0]
    c = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    w = max(rows.shape[1] // c, 1)
    filters = np.zeros(h, int) if filters is None else filters
    out = []
    prior = np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        cur = rows[y].astype(np.int32)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        p = left + prior - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        pred = [0, left, prior, (left + prior) >> 1, paeth][filters[y]]
        out.append(bytes([filters[y]]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour", [0, 2, 6])
def test_read_png_undoes_every_filter_type_in_every_colour_type(tmp_path, colour):
    c = {0: 1, 2: 3, 6: 4}[colour]
    rng = np.random.default_rng(colour)
    rows = rng.integers(0, 256, size=(10, 7 * c), dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(_png(rows, colour, filters=np.arange(10) % 5))
    got = read_png(path)
    want = rows.reshape(10, 7, c).astype(np.float32) / 255.0
    np.testing.assert_array_equal(got, want[..., 0] if c == 1 else want)
    np.testing.assert_array_equal(got, plt.imread(path))


def test_read_png_reads_the_ports_own_grids_and_refuses_what_it_does_not_decode(tmp_path):
    x = np.random.default_rng(0).uniform(size=(4, 8, 8, 1))
    save_image_grid(x, tmp_path / "g.png", nrows=2, ncols=2)
    np.testing.assert_array_equal(read_png(tmp_path / "g.png"), plt.imread(tmp_path / "g.png"))
    rows = np.zeros((2, 2), np.uint8)
    for kw, match in (({"depth": 16}, "bit depth"), ({"interlace": 1}, "interlace"),
                      ({"colour": 4}, "colour type 4")):
        (tmp_path / "bad.png").write_bytes(_png(rows, **{"colour": 0, **kw}))
        with pytest.raises(ValueError, match=match):
            read_png(tmp_path / "bad.png")
    data = bytearray(_png(rows, 0))
    data[-20] ^= 1  # a byte of the IDAT chunk
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(tmp_path / "bad.png")


def _lattices(n=12, seed=3, size=64):
    """Real JAX-rendered rot_only lattices and their conditioning."""
    x, y_cat, y_cont = jax_generate_batch(JLatticeConfig(img_size=size, rot_only=True), seed,
                                          jnp.arange(n))
    return np.asarray(x), np.asarray(y_cat), np.asarray(y_cont)[:, 1]


def test_spectrum_matches_jax():
    x, _, _ = _lattices()
    noise = np.random.default_rng(1).uniform(size=(5, 64, 48)).astype(np.float32)
    for imgs in (x[..., 0], noise):
        got = tf.spectrum(torch.tensor(imgs)).numpy()
        want = np.asarray(jf.spectrum(jnp.asarray(imgs)))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(got, axis=(-2, -1)), 1.0, rtol=1e-5)


def test_template_bank_matches_jax():
    spec, types, thetas = tf.template_bank(64, device="cpu")
    jspec, jtypes, jthetas = jf.template_bank(64)
    assert spec.shape == (610, 64, 64)
    np.testing.assert_array_equal(types, jtypes)
    np.testing.assert_array_equal(thetas, jthetas)
    np.testing.assert_allclose(spec.numpy(), np.asarray(jspec), atol=1e-5, rtol=0)
    assert tf.template_bank(64, device="cpu")[0] is spec  # cached per (size, device)


def _assert_scores_match(got, want):
    for k in ("pred_type", "type_correct", "theta_hat"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["cond_corr"], want["cond_corr"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["theta_err_deg"], want["theta_err_deg"], atol=1e-4, rtol=0)
    for k in ("type_acc", "type_acc_merged01", "theta_mae_deg", "cond_fidelity"):
        assert isinstance(got[k], float)
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("kind", ["lattices", "uniform_noise"])
def test_score_lattice_fidelity_matches_jax(kind):
    x, y_cat, theta = _lattices()
    if kind == "uniform_noise":
        x = np.random.default_rng(2).uniform(size=x.shape).astype(np.float32)
    got = tf.score_lattice_fidelity(x, y_cat, theta, device="cpu")
    want = jf.score_lattice_fidelity(x, y_cat, theta)
    _assert_scores_match(got, want)
    if kind == "lattices":
        # clean lattices score near-perfectly against their own templates
        assert got["cond_fidelity"] > 0.9 and got["type_acc_merged01"] == 1.0


@pytest.mark.parametrize("shape, out", [((181, 179), (64, 64)), ((64, 100), (64, 64)),
                                        ((30, 20), (64, 48)), ((7, 9), (3, 4))])
def test_resize_bilinear_matches_jax_image_resize(shape, out):
    img = np.random.default_rng(4).uniform(size=shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), out, "bilinear"))
    np.testing.assert_allclose(tf.resize_bilinear(img, *out), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", GRIDS)
def test_extract_grid_tiles_and_score_grid_png_match_jax(name):
    got = tf.extract_grid_tiles(_grid(name))
    want = jf.extract_grid_tiles(_grid(name))
    assert got.shape == want.shape == (36, 64, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    _assert_scores_match(tf.score_grid_png(_grid(name), device="cpu"),
                         jf.score_grid_png(_grid(name)))


def test_theta_err_is_symmetry_aware():
    got = tf._theta_err(np.array([0.0, math.pi / 2 - 0.01, 0.05, 1.0]),
                        np.array([math.pi / 2, 0.0, math.pi / 3, 1.0 + math.pi / 3]),
                        np.array([0, 0, 2, 3]))
    np.testing.assert_allclose(got, [0.0, 0.01, 0.05, 0.0], atol=1e-12)
    np.testing.assert_allclose(got, jf._theta_err(
        np.array([0.0, math.pi / 2 - 0.01, 0.05, 1.0]),
        np.array([math.pi / 2, 0.0, math.pi / 3, 1.0 + math.pi / 3]), np.array([0, 0, 2, 3])))
