"""The rest of the port's data path on the CPU, at a small size: build_dataset
and preview_data (toycrystals_torch/scripts/), data/stream.py (take_rows,
prefetch_to_device, StreamingDiskDataset) and the SDE trainer's --stream and
--profile-dir. Everything here is exact: archives against the JAX package's
`load_archive` and against `generate_batch` quantised, the gather against
indexing, and a streamed epoch's losses against the resident per-batch path's,
bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from toycrystals_torch.data import stream
from toycrystals_torch.data.datasets import generate_batch
from toycrystals_torch.data.datasets import load_archive as t_load_archive
from toycrystals_torch.data.lattice import LatticeConfig
from toycrystals_torch.scripts import build_dataset, preview_data
from toycrystals_torch.scripts import train_sde_score_model as train_cli
from toycrystals_torch.utils.figures import quantize_u8, read_png
from toycrystals_tpu.data.datasets import load_archive as j_load_archive

N = 12


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    d = tmp_path_factory.mktemp("data_tools")
    out = {}
    for fmt in ("npz", "pt"):
        out[fmt] = build_dataset.build(["--device", "cpu", "--n-samples", str(N), "--batch-size",
                                        "5", "--img-size", "16", "--seed", "3", "--out",
                                        str(d / f"a.{fmt}")])
    return d, out


def test_build_dataset_schemas_read_by_both_packages(archives):
    d, out = archives
    x, y_cat, y_cont = generate_batch(LatticeConfig(img_size=16, rot_only=True), 3,
                                      torch.arange(N), device="cpu")
    want = (torch.clip(x * 255.0, 0, 255).to(torch.uint8).numpy(), y_cat.numpy(), y_cont.numpy())
    with np.load(out["npz"]["path"]) as z:
        assert sorted(z.files) == ["x_u8", "y_cat", "y_cont"]
        assert (z["x_u8"].dtype, z["x_u8"].shape) == (np.uint8, (N, 16, 16, 1))
        assert z["y_cat"].dtype == np.int32 and z["y_cont"].dtype == np.float32
    pt = torch.load(out["pt"]["path"], weights_only=True)
    assert pt["x_u8"].dtype == torch.uint8 and tuple(pt["x_u8"].shape) == (N, 1, 16, 16)
    assert pt["y_cat"].dtype == torch.int64 and pt["y_cont"].dtype == torch.float32
    for fmt in ("npz", "pt"):
        assert out[fmt]["n"] == N
        for load in (t_load_archive, j_load_archive):
            for a, w in zip(load(out[fmt]["path"]), want):
                np.testing.assert_array_equal(a, w)


def test_preview_data_writes_the_6x6_full_variability_grid(tmp_path):
    path, images = preview_data.preview(["--device", "cpu", "--img-size", "16", "--out",
                                         str(tmp_path / "p.png")])
    x, _, _ = generate_batch(LatticeConfig(img_size=16, n_types=4), 0, torch.arange(36),
                             device="cpu")
    np.testing.assert_array_equal(images, x.numpy())
    img = np.round(read_png(path) * 255).astype(np.uint8)
    assert img.shape == (6 * 18 + 2, 6 * 18 + 2)
    for i in range(36):
        r, c = divmod(i, 6)
        np.testing.assert_array_equal(img[2 + 18 * r:18 + 18 * r, 2 + 18 * c:18 + 18 * c],
                                      quantize_u8(images[i, ..., 0]))


def test_take_rows_equals_indexing():
    src = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (50, 8, 8, 1), np.uint8))
    for idx in (np.array([3, 1, 49, 3, 0]), torch.tensor([7]), list(range(50))[::-1]):
        np.testing.assert_array_equal(stream.take_rows(src, idx).numpy(),
                                      src.numpy()[np.asarray(idx)])
    out = torch.empty((2, 8, 8, 1), dtype=torch.uint8)
    assert stream.take_rows(src, [4, 5], out=out) is out
    assert torch.equal(out, src[4:6])
    with pytest.raises(IndexError):
        stream.take_rows(src, [50])


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_yields_in_order_depth_ahead(depth):
    placed = []

    def place(batch):
        placed.append(int(batch[0]))
        return stream.CopyToDevice("cpu")(batch)

    got = []
    for (b,) in stream.prefetch_to_device(((torch.tensor(i),) for i in range(6)), depth, place):
        # when batch k reaches the consumer, `depth` more have been placed
        assert len(placed) == min(int(b) + depth + 1, 6)
        got.append(int(b))
    assert got == placed == list(range(6))
    with pytest.raises(ValueError):
        next(stream.prefetch_to_device(iter([]), 0))


def test_streaming_dataset_gives_the_resident_batches(archives):
    _, out = archives
    sds = stream.StreamingDiskDataset(out["npz"]["path"], device="cpu")
    x_u8, y_cat, y_cont = (torch.from_numpy(a) for a in t_load_archive(out["npz"]["path"]))
    idx = [np.array([5, 0, 11]), np.array([2, 2, 7])]
    for i, (x, yc, yv) in zip(idx, sds.device_batches(idx, 2)):
        assert torch.equal(x, x_u8[i].to(torch.float32) / 255.0)
        assert torch.equal(yc, y_cat[i]) and torch.equal(yv, y_cont[i])
    assert len(sds) == N


def test_stream_epochs_equal_the_resident_path_bit_for_bit(archives, tmp_path):
    _, out = archives
    common = ["--device", "cpu", "--data-path", out["npz"]["path"], "--base-ch", "8",
              "--emb-dim", "16", "--batch-size", "4", "--epochs", "2", "--sample-every", "0"]
    resident = train_cli.train(common + ["--fused-epoch", "0", "--out-dir", str(tmp_path / "r")])
    streamed = train_cli.train(common + ["--stream", "2", "--out-dir", str(tmp_path / "s"),
                                         "--profile-dir", str(tmp_path / "trace")])
    assert len(resident.loss_hist) == 2 and resident.loss_hist == streamed.loss_hist
    for k, v in resident.state.params.items():
        assert torch.equal(v, streamed.state.params[k]), k
    # --profile-dir: a Chrome trace of the second epoch
    assert streamed.trace_path == str(tmp_path / "trace" / "epoch_002.trace.json")
    with open(streamed.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    with pytest.raises(SystemExit, match="--stream needs --data-path"):
        train_cli.train(common + ["--stream", "--procedural", "--out-dir", str(tmp_path / "p")])


def test_without_device_flag_the_data_clis_refuse_to_run_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_dataset.build(["--out", str(tmp_path / "a.npz")])
    with pytest.raises(RuntimeError, match="cuda"):
        preview_data.preview(["--out", str(tmp_path / "p.png")])
    assert not any(tmp_path.iterdir())
