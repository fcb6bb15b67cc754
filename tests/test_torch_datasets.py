"""Port of the dataset sources (toycrystals_torch/data/datasets.py) against
toycrystals_tpu/data/datasets.py: the batch contract, the archive readers on
the same files, and the index iterator on the same numpy generator."""

import numpy as np
import pytest
import torch

from toycrystals_torch.data import datasets as td
from toycrystals_torch.data.lattice import LatticeConfig
from toycrystals_tpu.data import datasets as jd


def test_generate_batch_contract():
    cfg = LatticeConfig(img_size=32, rot_only=True)
    x, y_cat, y_cont = td.generate_batch(cfg, 0, np.arange(6), device="cpu")
    assert x.shape == (6, 32, 32, 1) and x.dtype == torch.float32
    assert y_cat.shape == (6,) and y_cat.dtype == torch.int32
    assert y_cont.shape == (6, 4) and y_cont.dtype == torch.float32
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert bool((x.amax(dim=(1, 2, 3)) > 0.99).all())  # normalised by its own peak
    # idx may be a tensor, a list or an array
    x2, _, _ = td.generate_batch(cfg, 0, torch.tensor([2, 5]), device="cpu")
    assert torch.equal(x2, x[[2, 5]])


def test_indexable_dataset_matches_its_batches():
    ds = td.ToyCrystalsDataset(n_samples=10, img_size=32, seed=3, rot_only=True, device="cpu")
    assert len(ds) == 10 and ds.budget.p % 128 == 0
    x, y_cat, y_cont = ds[4]
    assert x.shape == (32, 32, 1) and 0 <= int(y_cat) < 4 and y_cont.shape == (4,)
    xb, cb, vb = ds.batch([1, 4])
    assert torch.equal(xb[1], x) and int(cb[1]) == int(y_cat) and torch.equal(vb[1], y_cont)
    same = td.generate_batch(ds.cfg, 3, [4], device="cpu")[0][0]
    assert torch.equal(same, x)


def _archive(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(12, 16, 16, 1), dtype=np.uint8)
    y_cat = rng.integers(0, 4, size=(12,))
    y_cont = rng.normal(size=(12, 4)).astype(np.float32)
    pt, npz = tmp_path / "crystals.pt", tmp_path / "crystals.npz"
    torch.save({"x_u8": torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()),
                "y_cat": torch.from_numpy(y_cat.astype(np.int64)),
                "y_cont": torch.from_numpy(y_cont)}, pt)
    np.savez(npz, x_u8=x, y_cat=y_cat.astype(np.int32), y_cont=y_cont)
    return pt, npz, x, y_cat, y_cont


@pytest.mark.parametrize("kind", ["pt", "npz"])
def test_load_archive_equals_jax_reader(tmp_path, kind):
    pt, npz, x, y_cat, y_cont = _archive(tmp_path)
    path = pt if kind == "pt" else npz
    got, want = td.load_archive(path), jd.load_archive(path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], x)
    assert got[0].dtype == np.uint8 and got[1].dtype == np.int32 and got[2].dtype == np.float32


def test_disk_dataset_and_bad_archives(tmp_path):
    pt, _, x, y_cat, _ = _archive(tmp_path)
    ds, ref = td.ToyCrystalsDiskDataset(pt), jd.ToyCrystalsDiskDataset(pt)
    assert len(ds) == len(ref) == 12
    x5, c5, v5 = ds[5]
    np.testing.assert_array_equal(x5, np.asarray(ref[5][0]))
    assert int(c5) == int(y_cat[5]) and v5.shape == (4,)
    for g, w in zip(ds.as_arrays(), ref.as_arrays()):
        np.testing.assert_array_equal(g, w)
    bad = tmp_path / "bad.pt"
    torch.save({"weights": torch.zeros(3)}, bad)
    with pytest.raises(ValueError, match="not a dataset archive"):
        td.load_archive(bad)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False), (True, False)])
def test_batch_iterator_equals_jax(shuffle, drop_last):
    got = list(td.batch_iterator(23, 5, rng=np.random.default_rng(1), shuffle=shuffle,
                                 drop_last=drop_last))
    want = list(jd.batch_iterator(23, 5, rng=np.random.default_rng(1), shuffle=shuffle,
                                  drop_last=drop_last))
    assert len(got) == len(want) == (4 if drop_last else 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_iterator_needs_a_generator_to_shuffle():
    # The port draws from explicit generators only: no unseeded fallback.
    with pytest.raises(ValueError, match="explicit rng"):
        next(td.batch_iterator(23, 5))
    got = list(td.batch_iterator(23, 5, shuffle=False))
    np.testing.assert_array_equal(np.concatenate(got), np.arange(20))
