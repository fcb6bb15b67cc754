"""The port's VAE trainer CLI (toycrystals_torch/scripts/train_vae.py) on the
CPU at a small size (64x64, the VAE's fixed size; batch 8, z_dim 8,
--procedural): 2 epochs then --resume to 3, the checkpoint against the JAX
package's `save_checkpoint` of the same state (byte for byte) and its flax
restore as the JAX CLIs read it, the three PNGs and their tiles, the
unconditional branch, and the refusals. Tolerances: the JAX encoder on the
port-written params against the port's, f32 atol 1e-5; everything else exact.
"""

import flax.serialization as ser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toycrystals_torch.scripts import train_vae as vae_cli
from toycrystals_torch.utils.figures import quantize_u8, read_png
from toycrystals_tpu.models import vae as jv
from toycrystals_tpu.utils import checkpoint as jck

TINY = ["--device", "cpu", "--procedural", "--n-samples", "32", "--batch-size", "8",
        "--z-dim", "8", "--cond-drop", "0.25"]


def _tiles(img: np.ndarray, rows: int, cols: int, tile: int = 64, pad: int = 2) -> np.ndarray:
    assert img.shape == (rows * (tile + pad) + pad, cols * (tile + pad) + pad)
    return np.stack([img[pad + r * (tile + pad):pad + r * (tile + pad) + tile,
                         pad + c * (tile + pad):pad + c * (tile + pad) + tile]
                     for r in range(rows) for c in range(cols)])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("vae_cli")
    first = vae_cli.train(TINY + ["--epochs", "2", "--out-dir", str(out)])
    resumed = vae_cli.train(TINY + ["--epochs", "3", "--resume", "--out-dir", str(out)])
    return out, first, resumed


def test_train_then_resume(run):
    out, first, resumed = run
    assert len(first.epoch_seconds) == 2 and len(resumed.epoch_seconds) == 1
    assert all(v > 0 for v in first.images_per_second + resumed.images_per_second)
    raw = jck.load_checkpoint(out / "checkpoints" / "vae_last.msgpack")
    assert int(raw["epoch_next"]) == 3
    hists = {k: [float(v) for v in raw["hists"][k].values()] for k in vae_cli.HISTS}
    assert hists == resumed.hists
    # the resumed run kept epochs 1-2 of the first and appended the third
    assert all(hists[k][:2] == first.hists[k] for k in vae_cli.HISTS)
    assert all(np.isfinite(v).all() and len(v) == 3 for v in hists.values())
    # 4 steps per epoch: Adam's count continues across the resume
    assert resumed.state.opt_state.count == 12 and resumed.state.step == 12
    assert raw["config"] == {"z_dim": 8, "n_types": 4, "y_cont_dim": 4, "cond_drop": 0.25,
                             "uncond": False, "img_size": 64}


def test_checkpoint_is_the_jax_save_of_the_same_state(run, tmp_path):
    """The JAX CLI's resume path (flax from_state_dict onto its own init and
    optax.adam state) reads the port's file, and the JAX `save_checkpoint` of
    what it read, in the JAX CLI's dict, is the port's bytes. The JAX encoder
    on those params gives the port's."""
    out, _, resumed = run
    path = out / "checkpoints" / "vae_last.msgpack"
    raw = jck.load_checkpoint(path)
    jmodel = jv.CondVAE(z_dim=8, n_types=4, y_cont_dim=4, cond_drop=0.25)
    k = jax.random.key(0)
    init = jmodel.init({"params": k, "reparam": k}, jnp.zeros((2, 64, 64, 1)),
                       jnp.zeros((2,), jnp.int32), jnp.zeros((2, 4)))["params"]
    params = ser.from_state_dict(init, raw["params"])
    opt_state = ser.from_state_dict(optax.adam(2e-3).init(init), raw["opt_state"])
    assert int(opt_state[0].count) == 12
    mine = tmp_path / "jax.msgpack"
    jck.save_checkpoint(mine, {"params": params, "config": resumed.config,
                               "opt_state": opt_state, "epoch_next": 3,
                               "hists": {k: resumed.hists[k] for k in vae_cli.HISTS}})
    assert mine.read_bytes() == path.read_bytes()

    x = np.random.default_rng(0).uniform(size=(2, 64, 64, 1)).astype(np.float32)
    yc, yv = np.array([0, 3], np.int32), np.zeros((2, 4), np.float32)
    mu, _ = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(yc), jnp.asarray(yv),
                         method="encode")
    with torch.no_grad():
        tmu, _ = resumed.model.encode(torch.tensor(x), torch.tensor(yc), torch.tensor(yv))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=0, atol=1e-5)


def test_three_grids_hold_the_images(run):
    out, _, resumed = run
    assert set(resumed.figures) == {"recon", "samples_prior", "samples_mop"}
    recon = _tiles(np.round(read_png(out / "results" / "vae_recon.png") * 255), 4, 8)
    pairs = np.stack([resumed.images["recon_x"], resumed.images["recon_x_hat"]], axis=1)
    n = 2 * resumed.images["recon_x"].shape[0]  # 8 pairs from a batch of 8, then white
    assert n == 16
    np.testing.assert_array_equal(recon[:n], quantize_u8(pairs.reshape(n, 64, 64)))
    assert (recon[n:] == 255).all()
    for name in ("samples_prior", "samples_mop"):
        tiles = _tiles(np.round(read_png(out / "results" / f"vae_{name}.png") * 255), 6, 6)
        assert resumed.images[name].shape == (36, 64, 64, 1)
        np.testing.assert_array_equal(tiles, quantize_u8(resumed.images[name][..., 0]))


def test_uncond_per_batch_trains_and_draws(tmp_path):
    """--uncond with --fused-epoch 0: the host-index step loop."""
    r = vae_cli.train(TINY + ["--epochs", "1", "--uncond", "--n-samples", "16",
                              "--fused-epoch", "0", "--out-dir", str(tmp_path)])
    assert type(r.model).__name__ == "VAE" and r.config["uncond"] is True
    assert r.images["samples_mop"].shape == (36, 64, 64, 1)
    assert np.isfinite(r.hists["loss"]).all()


def test_refusals(tmp_path, monkeypatch):
    with monkeypatch.context() as m:  # ranks joined by the cluster flags: JAX's refusal
        m.setattr(vae_cli, "init_distributed", lambda *a: True)
        for flag in (["--shard-model", "2"], ["--fsdp"]):
            with pytest.raises(SystemExit, match="multi-host --fsdp/--shard-model"):
                vae_cli.train(TINY + flag + ["--out-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="--coordinator auto detects"):
        vae_cli.train(TINY + ["--coordinator", "auto", "--num-processes", "2",
                              "--out-dir", str(tmp_path)])
    with pytest.raises(SystemExit):  # the VAE trainer's JAX CLI has no --shard-space
        vae_cli.train(TINY + ["--shard-space", "2", "--out-dir", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        vae_cli.train(["--procedural", "--out-dir", str(tmp_path)])
