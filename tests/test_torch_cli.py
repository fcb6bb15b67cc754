"""The port's score-model CLIs (toycrystals_torch/scripts/) on the CPU at a
tiny size (base_ch 8, 16x16, --device cpu): train, resume, sample, the files
they write in the JAX CLIs' layout, and their interplay with the JAX package.

Tolerances: the JAX forward against the port's on the same checkpoint, f32
atol 1e-5; PNG tiles against the images, 1/255 through the JAX package's tile
extractor and exact through a PNG decoder. Everything else is exact.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from toycrystals_torch.data.datasets import generate_batch
from toycrystals_torch.data.lattice import LatticeConfig
from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.scripts import sample_sde_score_model as sample_cli
from toycrystals_torch.scripts import train_sde_score_model as train_cli
from toycrystals_torch.serve import ScoreModelService
from toycrystals_torch.utils import checkpoint as tck
from toycrystals_torch.utils.figures import quantize_u8, save_image_grid
from toycrystals_torch.utils.params import load_flax_params
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.train.state import create_train_state as jax_create_train_state
from toycrystals_tpu.utils import checkpoint as jck
from toycrystals_tpu.utils.fidelity import extract_grid_tiles

TINY = ["--device", "cpu", "--img-size", "16", "--base-ch", "8", "--emb-dim", "16",
        "--batch-size", "16", "--sample-every", "0"]
PROC = TINY + ["--procedural", "--n-samples", "32"]


def _train(out_dir, *flags):
    return train_cli.train(PROC + ["--out-dir", str(out_dir), *flags])


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _state_tensors(state):
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"mu/{i}": t for i, t in enumerate(state.opt_state.mu)})
    out.update({f"nu/{i}": t for i, t in enumerate(state.opt_state.nu)})
    if state.ema_params is not None:
        out.update({f"ema/{k}": v for k, v in state.ema_params.items()})
    return out


def _assert_states_equal(a, b):
    assert (a.step, a.opt_state.count, a.opt_state.notfinite_count,
            a.opt_state.total_notfinite) == (b.step, b.opt_state.count,
                                             b.opt_state.notfinite_count,
                                             b.opt_state.total_notfinite)
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_train_resume_and_sample(tmp_path):
    """2 epochs, then --resume to 3: the files and metrics rows of the JAX
    CLI; --resume restores the saved state bit for bit (a resume at
    --epochs 2 trains nothing and returns what it loaded); the resumed run
    repeats an uninterrupted one's losses exactly; JAX reads the checkpoint
    and its forward matches the port's; the sample CLI and the service read
    it."""
    run = tmp_path / "run"
    first = _train(run, "--epochs", "2", "--ema-decay", "0.9")
    ckpt = run / "checkpoints" / "sde_score_model_last.msgpack"
    assert ckpt.exists() and (run / "results").is_dir()
    assert [r["epoch"] for r in _metrics(run)] == [1, 2]
    loaded = _train(run, "--epochs", "2", "--ema-decay", "0.9", "--resume")
    assert loaded.epoch_seconds == [] and loaded.state.step == 4
    _assert_states_equal(loaded.state, first.state)
    third = _train(run, "--epochs", "3", "--ema-decay", "0.9", "--resume")
    rows = _metrics(run)
    assert [r["epoch"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in rows)
    raw = tck.load_checkpoint(ckpt)
    assert raw["epoch_next"] == 3 and raw["config"]["img_size"] == 16
    assert list(raw["loss_hist"].values()) == [r["loss"] for r in rows] == third.loss_hist
    straight = _train(tmp_path / "straight", "--epochs", "3", "--ema-decay", "0.9")
    assert straight.loss_hist == third.loss_hist
    _assert_states_equal(straight.state, third.state)

    # the JAX package reads the port's file; forward on its params, f32 atol 1e-5
    jraw = jck.load_checkpoint(ckpt)
    r = np.random.default_rng(0)
    args = (r.normal(size=(3, 16, 16, 1)).astype(np.float32),
            r.uniform(0.05, 1.0, size=3).astype(np.float32),
            np.array([0, 3, 4], np.int32), r.normal(size=(3, 4)).astype(np.float32))
    want = jm.CondUNetTiny(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16).apply(
        {"params": jraw["state"]["params"]}, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = third.model.eval()(*(torch.tensor(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)

    res = sample_cli.sample(["--device", "cpu", "--out-dir", str(run), "--steps", "3",
                             "--n", "5", "--use-ema", "1", "--sampler", "sde", "--cfg", "1.5"])
    assert res.out_path == str(run / "results" / "samples_ckpt-sde_score_model_last_steps3"
                               "_cfg1.50_tend0.001_samplersde_ema1.png")
    assert res.x.shape == (5, 16, 16, 1) and np.isfinite(res.x).all()
    assert 0.0 <= res.x.min() and res.x.max() <= 1.0
    png = np.asarray(Image.open(res.out_path))
    assert png.shape == (3 * 18 + 2, 3 * 18 + 2)
    np.testing.assert_array_equal(png[2:18, 20:36], quantize_u8(res.x[1, ..., 0]))
    svc = ScoreModelService.from_checkpoint(str(ckpt), device="cpu", steps=2, buckets=(4,))
    for k, v in third.state.ema_params.items():
        assert torch.equal(svc.model.state_dict()[k], v), k
    x = svc.sample_conditions([0, 1, 2], seed=1)
    assert x.shape == (3, 16, 16, 1) and np.isfinite(x).all()


def test_resume_drops_metrics_rows_past_the_checkpoint(tmp_path):
    """--ckpt-every 2 can leave metrics.jsonl ahead of the checkpoint (a run
    killed after epoch 3's row, before epoch 4's save): --resume truncates
    the rows past the restored epoch, so no epoch appears twice."""
    run = tmp_path / "run"
    _train(run, "--epochs", "2", "--ckpt-every", "2", "--async-ckpt", "0")
    with open(run / "metrics.jsonl", "a") as f:
        f.write(json.dumps({"epoch": 3, "loss": 123.0}) + "\n")
    _train(run, "--epochs", "3", "--ckpt-every", "2", "--resume")
    rows = _metrics(run)
    assert [r["epoch"] for r in rows] == [1, 2, 3] and rows[2]["loss"] != 123.0


def test_save_best(tmp_path):
    run = tmp_path / "run"
    res = _train(run, "--epochs", "3", "--save-best", "1")
    best = tck.load_checkpoint(run / "checkpoints" / "sde_score_model_best.msgpack")
    hist = list(best["loss_hist"].values())
    assert hist == res.loss_hist[:best["epoch_next"]]
    assert hist[-1] == min(res.loss_hist)


def test_divergence_guard_keeps_the_last_good_checkpoint(tmp_path):
    """One step per epoch at lr 1e30: epoch 1 is finite, epoch 2's loss is
    not; the run exits before writing, so the checkpoint of epoch 1 stays."""
    run = tmp_path / "run"
    with pytest.raises(SystemExit, match="diverged"):
        train_cli.train(TINY + ["--procedural", "--n-samples", "16", "--epochs", "3",
                                "--lr", "1e30", "--out-dir", str(run)])
    raw = tck.load_checkpoint(run / "checkpoints" / "sde_score_model_last.msgpack")
    assert raw["epoch_next"] == 1 and np.isfinite(raw["loss_hist"]["0"])
    assert [r["epoch"] for r in _metrics(run)] == [1]


def test_preemption_saves_and_exits_cleanly(tmp_path, monkeypatch):
    """A SIGTERM during epoch 1 (delivered to the handler that
    GracefulShutdown installs): the epoch completes, the checkpoint is
    written whatever --ckpt-every says, the run returns; --resume goes on."""
    real, shutdowns = train_cli.make_sde_train_epoch, []

    class Recorded(train_cli.GracefulShutdown):
        def __enter__(self):
            shutdowns.append(self)
            return super().__enter__()

    def make(*a, **k):
        epoch_fn = real(*a, **k)

        def signalled(*args):
            shutdowns[-1]._handler(signal.SIGTERM, None)
            return epoch_fn(*args)

        return signalled

    monkeypatch.setattr(train_cli, "GracefulShutdown", Recorded)
    monkeypatch.setattr(train_cli, "make_sde_train_epoch", make)
    run = tmp_path / "run"
    res = _train(run, "--epochs", "3", "--ckpt-every", "0")
    assert len(res.loss_hist) == 1
    assert tck.load_checkpoint(run / "checkpoints" / "sde_score_model_last.msgpack")[
        "epoch_next"] == 1
    monkeypatch.setattr(train_cli, "make_sde_train_epoch", real)
    assert len(_train(run, "--epochs", "3", "--resume").loss_hist) == 3


@pytest.mark.parametrize("fused", ["1", "0"])
def test_disk_archive_both_epoch_paths(tmp_path, fused):
    """A dataset archive resident on the device, through make_sde_train_epoch
    (--fused-epoch 1) and through per-step dispatch (--fused-epoch 0)."""
    x, y_cat, y_cont = generate_batch(LatticeConfig(img_size=16, rot_only=True), 0,
                                      np.arange(40), device="cpu")
    np.savez(tmp_path / "d.npz", x_u8=quantize_u8(x.numpy()), y_cat=y_cat.numpy(),
             y_cont=y_cont.numpy())
    res = train_cli.train(TINY + ["--data-path", str(tmp_path / "d.npz"), "--epochs", "2",
                                  "--fused-epoch", fused, "--out-dir", str(tmp_path / "run")])
    assert res.state.step == 4 and res.config["img_size"] == 16
    assert all(np.isfinite(res.loss_hist))


def test_optimizer_flags_survive_resume_and_are_checked(tmp_path):
    """--clip-grad-norm (restored from the config), --skip-nonfinite,
    --lr-schedule cosine with warmup and --grad-accum 2, per-step dispatch
    and fresh data: the resume restores the state; resuming without a flag
    that shapes the optimizer state exits naming it."""
    run = tmp_path / "run"
    flags = ["--skip-nonfinite", "2", "--lr-schedule", "cosine", "--warmup-steps", "2",
             "--grad-accum", "2", "--fused-epoch", "0", "--fresh-data", "--init", "torch"]
    first = _train(run, "--epochs", "2", "--clip-grad-norm", "1.0", *flags)
    assert first.config["clip_grad_norm"] == 1.0 and first.config["fresh_data"] is True
    loaded = _train(run, "--epochs", "2", "--resume", *flags)
    assert loaded.tx.clip_grad_norm == 1.0
    _assert_states_equal(loaded.state, first.state)
    with pytest.raises(SystemExit, match="--skip-nonfinite"):
        _train(run, "--epochs", "3", "--resume", *flags[2:])
    with pytest.raises(SystemExit, match="--lr-schedule"):
        _train(run, "--epochs", "3", "--resume", *flags[:2], *flags[6:])


def test_in_training_grid_is_a_png_of_36_tiles(tmp_path):
    run = tmp_path / "run"
    _train(run, "--epochs", "1", "--sample-every", "1", "--sample-steps", "2",
           "--param", "v", "--ema-decay", "0.9")
    png = np.asarray(Image.open(run / "results" / "sde_samples_epoch_001.png"))
    assert png.shape == (6 * 18 + 2, 6 * 18 + 2) and png[0].min() == 255


def test_sample_cli_reads_a_jax_checkpoint(tmp_path):
    """A checkpoint that the JAX package wrote (create_train_state +
    save_checkpoint, v-prediction): the sample CLI's images are those of the
    port's sample_chunked on the same weights, seed and chunk."""
    model = jm.CondUNetTiny(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
    params = model.init(jax.random.key(3), jnp.zeros((2, 16, 16, 1)), jnp.zeros((2,)),
                        jnp.zeros((2,), jnp.int32), jnp.zeros((2, 4)))["params"]
    config = dict(img_ch=1, img_size=16, n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16,
                  cond_ch=8, time_ch=8, beta_min=0.1, beta_max=30.0, logsnr_shift=-1.0,
                  dtype="float32", param="v", stem="none")
    jck.save_checkpoint(tmp_path / "checkpoints" / "sde_score_model_last.msgpack",
                        {"epoch_next": 1, "loss_hist": [1.0], "config": config,
                         "state": jax_create_train_state(params, optax.adam(1e-3))})
    res = sample_cli.sample(["--device", "cpu", "--out-dir", str(tmp_path), "--sampler", "dpm",
                             "--steps", "4", "--n", "6", "--chunk", "4", "--seed", "3"])
    net = tm.CondUNetTiny(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
    load_flax_params(net, jax.tree.map(np.asarray, params))
    sde = tm.VPSDE(0.1, 30.0, -1.0)
    y_cat, y_cont = tm.sample_grid_conditions(6, 4, 4)
    with torch.inference_mode():
        want = tm.sample_chunked(tm.sample_dpmpp_2m, tm.eps_apply_from_v(sde, net.eval()), sde,
                                 y_cat, y_cont, (6, 16, 16, 1), 3, chunk=4, n_steps=4,
                                 guidance_scale=0.0, t_end=1e-3, n_types=4)
    np.testing.assert_array_equal(res.x, want)
    assert (res.sampler, res.steps, res.chunk) == ("dpm", 4, 4)


def test_grid_png_tiles_are_recovered_by_the_jax_extractor(tmp_path):
    """A 6x6 grid of real 64x64 lattice images through the port's PNG writer:
    toycrystals_tpu/utils/fidelity.py:extract_grid_tiles gives the tiles back
    within 1/255, and a PNG decoder gives their 8-bit quantisation exactly."""
    x, _, _ = generate_batch(LatticeConfig(), 0, np.arange(36), device="cpu")
    x = x.numpy()
    path = tmp_path / "grid.png"
    save_image_grid(x, path)
    tiles = extract_grid_tiles(str(path), 6, 6, 64)
    assert tiles.shape == (36, 64, 64)
    assert float(np.abs(tiles - x[..., 0]).max()) <= 1.0 / 255.0
    png = np.asarray(Image.open(path))
    for i in range(36):
        r, c = divmod(i, 6)
        np.testing.assert_array_equal(png[2 + 66 * r:66 + 66 * r, 2 + 66 * c:66 + 66 * c],
                                      quantize_u8(x[i, ..., 0]))


def test_without_device_flag_both_clis_refuse_to_run_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.train(["--procedural", "--out-dir", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="cuda"):
        sample_cli.sample(["--out-dir", str(tmp_path / "run"), "--device", "auto"])
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("cli, flags, item", [
    ("train", ["--shard", "2"], "module 5"), ("train", ["--shard-space", "2"], "module 5"),
    ("train", ["--shard-model", "2"], "module 5"), ("train", ["--fsdp"], "module 5"),
    ("train", ["--coordinator", "localhost:1"], "module 5"),
    ("train", ["--num-processes", "2"], "module 5"), ("train", ["--process-id", "1"], "module 5"),
    ("train", ["--ckpt-format", "orbax"], "module 5"), ("train", ["--stream"], "module 2"),
    ("train", ["--profile-dir", "trace"], "module 2"),
    ("sample", ["--quantize", "int8"], "module 3"), ("sample", ["--shard", "2"], "module 5"),
    ("sample", ["--coordinator", "localhost:1"], "module 5"),
])
def test_deferred_flags_exit_naming_their_roadmap_item(tmp_path, cli, flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md queue 1, {item}"):
        if cli == "train":
            _train(tmp_path / "run", "--epochs", "1", *flags)
        else:
            sample_cli.sample(["--device", "cpu", "--out-dir", str(tmp_path), *flags])
