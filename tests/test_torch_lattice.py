"""Port of the lattice geometry (toycrystals_torch/data/lattice.py) against
toycrystals_tpu/data/lattice.py.

The two frameworks cannot share random streams, so the geometry is compared
on JAX's own draws, injected into the port (points atol 1e-4 px: f32 sums in
a different order; weights exactly). The port's own counter-based draws are
held to the determinism and statistical contracts of tests/test_data.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycrystals_torch.data import lattice as tl
from toycrystals_torch.data.datasets import generate_batch
from toycrystals_tpu.data import lattice as jl

CONFIGS = {
    "simple": dict(simple=True),
    "rot_only": dict(rot_only=True),
    "full": dict(),
}


@pytest.mark.parametrize("img_size", [32, 64])
@pytest.mark.parametrize("mode", list(CONFIGS))
def test_budget_and_index_grid_equal_jax(mode, img_size):
    tc = tl.LatticeConfig(img_size=img_size, **CONFIGS[mode])
    jc = jl.LatticeConfig(img_size=img_size, **CONFIGS[mode])
    tb, jb = tl.static_point_budget(tc), jl.static_point_budget(jc)
    assert (tb.n1s, tb.n2s, tb.k_max, tb.p) == (jb.n1s, jb.n2s, jb.k_max, jb.p)
    assert tb.p % 128 == 0
    for a, b in zip(tl._index_grid(tb), jl._index_grid(jb)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_budget_at_64_is_the_training_budget():
    b = tl.static_point_budget(tl.LatticeConfig(rot_only=True))
    assert (b.n1s, b.n2s, b.k_max, b.p) == (11, 14, 2, 1408)
    b = tl.static_point_budget(tl.LatticeConfig())
    assert (b.n1s, b.n2s, b.k_max, b.p) == (15, 19, 2, 2432)


def _jax_items(jc, jb, n, seed=0):
    """JAX's items 0..n-1 with the draws they were made from."""
    out = {k: [] for k in ("lattice_type", "a", "theta", "vacancy", "jitter", "aspect",
                           "vac_u", "jit_n", "points", "weights", "sigma", "y_cat", "y_cont")}
    for i in range(n):
        key = jl.item_key(seed, jnp.int32(i))
        k_params, k_points = jax.random.split(key)
        k_type, k_a, k_th, k_vac, k_jit, k_asp = jax.random.split(k_params, 6)
        out["lattice_type"].append(jax.random.randint(k_type, (), 0, jc.n_types, jnp.int32))
        out["a"].append(jax.random.uniform(k_a, (), minval=jc.a_min, maxval=jc.a_max))
        out["theta"].append(jax.random.uniform(k_th, (), minval=0.0, maxval=jc.theta_max))
        out["vacancy"].append(jax.random.uniform(k_vac, (), minval=0.0,
                                                 maxval=jc.vacancy_max))
        out["jitter"].append(jax.random.uniform(k_jit, (), minval=0.0, maxval=jc.jitter_max))
        out["aspect"].append(jax.random.uniform(k_asp, (), minval=jc.aspect_min,
                                                maxval=jc.aspect_max))
        kv, kj = jax.random.split(k_points)
        out["vac_u"].append(jax.random.uniform(kv, (jb.p,)))
        out["jit_n"].append(jax.random.normal(kj, (jb.p, 2)))
        pts, wts, sigma, y_cat, y_cont, _ = jl.generate_item(jc, jb, key)
        for k, v in zip(("points", "weights", "sigma", "y_cat", "y_cont"),
                        (pts, wts, sigma, y_cat, y_cont)):
            out[k].append(v)
    return {k: np.stack([np.asarray(v) for v in vs]) for k, vs in out.items()}


@pytest.mark.parametrize("mode", list(CONFIGS))
def test_points_weights_and_labels_match_jax_on_injected_draws(mode):
    tc = tl.LatticeConfig(img_size=32, **CONFIGS[mode])
    jc = jl.LatticeConfig(img_size=32, **CONFIGS[mode])
    tb, jb = tl.static_point_budget(tc), jl.static_point_budget(jc)
    j = _jax_items(jc, jb, 32)
    assert set(j["y_cat"].tolist()) == {0, 1, 2, 3}  # all four lattice types
    params = tl.sample_params(tc, 0, None, draws=j, device="cpu")
    points, weights = tl.make_points(tc, tb, params, draws=(j["vac_u"], j["jit_n"]))
    y_cat, y_cont = tl.item_labels(tc, params)
    assert points.shape == (32, tb.p, 2) and points.dtype == torch.float32
    np.testing.assert_allclose(points.numpy(), j["points"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(weights.numpy(), j["weights"])
    assert weights.sum() > 0
    np.testing.assert_array_equal(y_cat.numpy(), j["y_cat"])
    assert y_cat.dtype == torch.int32
    np.testing.assert_allclose(y_cont.numpy(), j["y_cont"], atol=1e-7, rtol=0)
    sigma = (0.12 * params["a"]).clamp(min=0.6)
    np.testing.assert_allclose(sigma.numpy(), j["sigma"], atol=1e-7, rtol=0)


def test_lattice_vectors_match_jax():
    a = np.array([6.0, 10.0, 13.5, 8.25], np.float32)
    asp = np.array([0.75, 1.0, 1.35, 1.1], np.float32)
    t = np.array([0, 1, 2, 3], np.int32)
    got = tl._lattice_vectors(torch.from_numpy(t), torch.from_numpy(a), torch.from_numpy(asp))
    for i in range(4):
        want = jl._lattice_vectors(jnp.int32(t[i]), jnp.float32(a[i]), jnp.float32(asp[i]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), atol=1e-6)


def test_items_are_deterministic_per_seed_and_idx_across_batches():
    cfg = tl.LatticeConfig(img_size=32)
    x, c, v = generate_batch(cfg, 3, np.arange(12), device="cpu")
    x2, c2, v2 = generate_batch(cfg, 3, [7, 0, 11], device="cpu")
    for k, i in enumerate([7, 0, 11]):
        np.testing.assert_array_equal(x2[k].numpy(), x[i].numpy())
        assert int(c2[k]) == int(c[i])
        np.testing.assert_array_equal(v2[k].numpy(), v[i].numpy())
    x3, _, _ = generate_batch(cfg, 4, np.arange(12), device="cpu")
    assert not np.allclose(x.numpy(), x3.numpy())
    # neighbouring indices are different items
    assert not np.allclose(x[0].numpy(), x[1].numpy())


def test_hash_draws_are_32_bit_and_uniform():
    item = tl._item_hash(0, torch.arange(64))
    bits = tl._bits(item, tl._S_VACANCY, 4096)
    assert bits.dtype == torch.int64 and int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    u = tl._uniform(bits)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 5e-3 and abs(float(u.std()) - 12 ** -0.5) < 5e-3
    # items and streams decorrelate
    assert abs(float(torch.corrcoef(torch.stack([u[0], u[1]]))[0, 1])) < 0.06
    other = tl._uniform(tl._bits(item, tl._S_JITTER_R, 4096))
    assert abs(float(torch.corrcoef(torch.stack([u[0], other[0]]))[0, 1])) < 0.06
    # large indices stay in range
    big = tl._item_hash(5, torch.tensor([2 ** 31 - 1, 2 ** 31 - 2]))
    assert int(big.min()) >= 0 and int(big.max()) < 2 ** 32 and int(big[0]) != int(big[1])


def test_jitter_draws_are_standard_normal():
    cfg = tl.LatticeConfig(img_size=32)
    budget = tl.static_point_budget(cfg)
    idx = torch.arange(64)
    params = tl.sample_params(cfg, 0, idx, device="cpu")
    base = dict(params, jitter=torch.zeros(64), vacancy=torch.zeros(64))
    p0, _ = tl.make_points(cfg, budget, base, 0, idx)
    p1, _ = tl.make_points(cfg, budget, dict(base, jitter=torch.ones(64)), 0, idx)
    z = (p1 - p0).reshape(-1)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    assert abs(float((z.abs() < 1.0).float().mean()) - 0.6827) < 0.01


def test_rot_only_label_contract():
    _, _, y_cont = generate_batch(tl.LatticeConfig(img_size=16, rot_only=True), 0,
                                  np.arange(64), device="cpu")
    v = y_cont.numpy()
    assert np.all(v[:, 0] == 0) and np.all(v[:, 2] == 0) and np.all(v[:, 3] == 0)
    assert np.all(v[:, 1] >= 0) and np.all(v[:, 1] <= math.pi / 3 + 1e-6)
    assert v[:, 1].std() > 0.1


def test_simple_label_contract():
    _, _, y_cont = generate_batch(tl.LatticeConfig(img_size=16, simple=True), 0,
                                  np.arange(16), device="cpu")
    assert np.all(y_cont.numpy() == 0)


def test_full_mode_label_ranges():
    _, y_cat, y_cont = generate_batch(tl.LatticeConfig(img_size=16), 0, np.arange(128),
                                      device="cpu")
    v = y_cont.numpy()
    assert np.all((v[:, 0] >= 6.0) & (v[:, 0] <= 14.0))
    assert np.all((v[:, 1] >= 0.0) & (v[:, 1] <= math.pi / 3 + 1e-6))
    assert np.all((v[:, 2] >= 0.0) & (v[:, 2] <= 0.25))
    assert np.all((v[:, 3] >= 0.0) & (v[:, 3] <= 0.6))
    assert set(np.unique(y_cat.numpy())) == {0, 1, 2, 3}


def test_type_distribution_uniform():
    cfg = tl.LatticeConfig(img_size=16, rot_only=True)
    p = tl.sample_params(cfg, 0, np.arange(2048), device="cpu")
    counts = np.bincount(p["lattice_type"].numpy(), minlength=4)
    assert counts.min() > 2048 / 4 * 0.8


def test_honeycomb_denser_than_square():
    cfg = tl.LatticeConfig(rot_only=True)
    budget = tl.static_point_budget(cfg)
    _, w, _, y_cat, _, _ = tl.generate_item(cfg, budget, 0, np.arange(128), device="cpu")
    n = w.sum(dim=1)
    assert (y_cat == 3).sum() >= 10 and (y_cat == 0).sum() >= 10
    assert float(n[y_cat == 3].mean()) > 1.5 * float(n[y_cat == 0].mean())


def test_vacancy_lowers_the_atom_count_and_sigma_follows_spacing():
    cfg = tl.LatticeConfig()
    budget = tl.static_point_budget(cfg)
    idx = torch.arange(32)
    params = tl.sample_params(cfg, 0, idx, device="cpu")
    _, w_none = tl.make_points(cfg, budget, dict(params, vacancy=torch.zeros(32)), 0, idx)
    _, w_quarter = tl.make_points(cfg, budget, dict(params, vacancy=torch.full((32,), 0.25)),
                                  0, idx)
    ratio = float(w_quarter.sum() / w_none.sum())
    assert 0.70 < ratio < 0.80
    assert bool((w_quarter <= w_none).all())
    _, w, sigma, _, y_cont, _ = tl.generate_item(cfg, budget, 0, idx, device="cpu")
    assert float(w.sum(dim=1).min()) > 0
    want = np.maximum(0.6, 0.12 * y_cont[:, 0].numpy())
    np.testing.assert_allclose(sigma.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("img_size", [32, 64])
def test_periodicity_visible(img_size):
    """A simple square lattice at a = 10, theta = 0 repeats every 10 px."""
    cfg = tl.LatticeConfig(img_size=img_size, simple=True)
    x, y_cat, _ = generate_batch(cfg, 0, np.arange(32), device="cpu")
    i = int(np.flatnonzero(y_cat.numpy() == 0)[0])
    row = x[i, :, :, 0].numpy().sum(axis=0)
    r = row - row.mean()
    ac = np.correlate(r, r, mode="full")[len(r) - 1:]
    assert ac[10] > ac[5]
