"""The port's latent-prior trainer CLI (toycrystals_torch/scripts/train_diffusion_prior.py)
against the JAX CLI (scripts/train_diffusion_prior.py) on the CPU, at a small
size: a shared 40-item 64x64 archive, a CondVAE at z 8, width 32 (8 blocks,
as the trainer fixes), T 50, batch 8, DDIM-3.

The JAX CLI runs once, in-process (runpy, as tests/test_torch_interop.py
drives it): --sample-only on the port's checkpoint, rebuilding its own latent
cache from the shared archive. Tolerances: the two caches' z0 within 1e-5,
z_mean and z_std within 1e-6, labels exact; checkpoints byte for byte.
"""

import os
import runpy
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_prior import _reference_state_dict

from toycrystals_torch.models import diffusion_prior as tp
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.models.vae import CondVAE
from toycrystals_torch.scripts import build_dataset
from toycrystals_torch.scripts import moe_route_stats
from toycrystals_torch.scripts import train_diffusion_prior as prior_cli
from toycrystals_torch.utils.checkpoint import save_checkpoint
from toycrystals_torch.utils.figures import read_png
from toycrystals_torch.utils.params import (
    flax_prior_from_torch_state_dict,
    flax_vae_from_torch_state_dict,
)
from toycrystals_tpu.models import diffusion_prior as jp
from toycrystals_tpu.utils import checkpoint as jck

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
Z, W, T, N = 8, 32, 50, 40
SIZES = ["--z-dim", str(Z), "--width", str(W), "--T", str(T), "--batch-size", "8",
         "--ddim-steps", "3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("prior_cli")
    archive = str(d / "archive.npz")
    build_dataset.build(["--device", "cpu", "--n-samples", str(N), "--out", archive])
    vae = flax_default_init(CondVAE(z_dim=Z, cond_drop=0.0), np.random.default_rng(0))
    save_checkpoint(d / "vae.msgpack", {"params": flax_vae_from_torch_state_dict(
        vae.state_dict())})
    common = ["--device", "cpu", "--data-path", archive, "--vae-ckpt", str(d / "vae.msgpack"),
              *SIZES, "--out-dir", str(d / "port")]
    first = prior_cli.train(common + ["--epochs", "2"])
    resumed = prior_cli.train(common + ["--epochs", "1", "--resume"])
    port_ckpt = d / "port" / "checkpoints" / "diffusion_prior_last.msgpack"
    shutil.copy(port_ckpt, d / "for_jax.msgpack")
    # the JAX CLI, once: its own cache from the shared archive, the port's checkpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        mp.syspath_prepend(str(SCRIPTS))
        mp.setattr(sys, "argv", [
            "train_diffusion_prior.py", "--device", "cpu", "--data-path", archive,
            "--vae-ckpt", str(d / "vae.msgpack"), *SIZES, "--latent-cache", "jax_cache.npz",
            "--rebuild-latents", "--sample-only", "--prior-ckpt", str(d / "for_jax.msgpack")])
        try:
            runpy.run_path(str(SCRIPTS / "train_diffusion_prior.py"), run_name="__main__")
        except SystemExit as e:
            assert (e.code or 0) == 0
    return d, common, first, resumed


def test_train_resume_and_sample_only(runs):
    d, common, first, resumed = runs
    assert len(first.loss_hist) == 2 and len(resumed.loss_hist) == 1
    assert first.cache_seconds is not None and resumed.cache_seconds is None  # built, then read
    assert all(np.isfinite(first.loss_hist + resumed.loss_hist))
    assert all(len(b) == 4 for b in first.bucket_hist) and len(first.sample_seconds) == 2
    # 40 latents, batch 8: 5 steps per epoch; --resume is weights only (a fresh Adam)
    assert resumed.state.opt_state.count == 5
    raw = jck.load_checkpoint(d / "port" / "checkpoints" / "diffusion_prior_last.msgpack")
    assert raw["config"] == {"z_dim": Z, "n_types": 4, "y_cont_dim": 4, "t_emb_dim": 64,
                             "width": W, "n_blocks": 8, "y_cat_emb_dim": 64, "T": T,
                             "beta_start": 1e-4, "beta_end": 1.0, "n_experts": 0}
    only = prior_cli.train(common + ["--sample-only"])
    assert only.state is None and only.loss_hist == []
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(only.model.state_dict()[k], v), k
    img = read_png(only.figure)
    assert img.shape == (6 * 66 + 2, 6 * 66 + 2) and only.samples.shape == (36, 64, 64, 1)


def test_checkpoint_is_the_jax_save_of_the_same_state(runs, tmp_path):
    """JAX's `save_checkpoint` of the params the JAX CLI restores from the
    port's file, in the JAX CLI's dict, is the port's bytes."""
    d, _, _, resumed = runs
    path = d / "port" / "checkpoints" / "diffusion_prior_last.msgpack"
    raw = jck.load_checkpoint(path)
    jprior = jp.DiffusionPriorFiLM(z_dim=Z, n_types=4, y_cont_dim=4, t_emb_dim=64, width=W,
                                   n_blocks=8, y_cat_emb_dim=64)
    import flax.serialization as ser

    # the JAX CLI restores onto its init's tree; the same structure as the file's
    params = ser.from_state_dict(jax.tree.map(jnp.zeros_like, raw["params"]), raw["params"])
    mine = tmp_path / "jax.msgpack"
    jck.save_checkpoint(mine, {"params": params, "config": resumed.config})
    assert mine.read_bytes() == path.read_bytes()
    # the JAX forward on those params is the port model's
    rng = np.random.default_rng(1)
    z, t = rng.normal(size=(4, Z)).astype(np.float32), np.array([0, 7, 30, 49], np.int32)
    yc, yv = np.arange(4, dtype=np.int32), rng.uniform(size=(4, 4)).astype(np.float32)
    want = np.asarray(jax.jit(jprior.apply)({"params": params}, z, t, yc, yv))
    got = resumed.model(*map(torch.from_numpy, (z, t, yc, yv))).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_latent_caches_match_and_cross(runs):
    d, common, first, _ = runs
    port = np.load(d / "port" / "data" / "latents_rotonly_mu.npz")
    jax_cache = np.load(d / "jax_cache.npz")
    # the JAX CLI reads a cache with np.load by these keys: the same dtypes and shapes
    assert sorted(port.files) == sorted(jax_cache.files) == ["y_cat", "y_cont", "z0", "z_mean",
                                                             "z_std"]
    for k in port.files:
        assert port[k].dtype == jax_cache[k].dtype and port[k].shape == jax_cache[k].shape, k
    assert port["z0"].shape == (N, Z)
    np.testing.assert_allclose(port["z0"], jax_cache["z0"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(port["z_mean"], jax_cache["z_mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(port["z_std"], jax_cache["z_std"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port["y_cat"], jax_cache["y_cat"])
    np.testing.assert_array_equal(port["y_cont"], jax_cache["y_cont"])
    # the port reads JAX's cache as it is
    run = prior_cli.train(common + ["--sample-only", "--latent-cache",
                                    str(d / "jax_cache.npz")])
    np.testing.assert_array_equal(run.z_mean.numpy(), jax_cache["z_mean"])
    np.testing.assert_array_equal(run.z_std.numpy(), jax_cache["z_std"])
    # and the JAX CLI took the port's checkpoint with --sample-only
    assert (d / "results" / "diffusion_samples.png").exists()


def test_sample_only_reads_jax_and_reference_checkpoints(runs, tmp_path):
    d, common, _, _ = runs
    # a flax tree (t_emb_dim 16) written by JAX's save_checkpoint
    kw = dict(z_dim=Z, n_types=4, y_cont_dim=4, t_emb_dim=16, width=W, n_blocks=8,
              y_cat_emb_dim=64)
    params = flax_prior_from_torch_state_dict(flax_default_init(
        tp.DiffusionPriorFiLM(**kw), np.random.default_rng(2)).state_dict())
    jck.save_checkpoint(tmp_path / "jax_prior.msgpack", {"params": params, "config": {}})
    flags = common + ["--sample-only", "--t-emb-dim", "16", "--out-dir", str(tmp_path),
                      "--latent-cache", str(d / "jax_cache.npz")]
    run = prior_cli.train(flags + ["--prior-ckpt", str(tmp_path / "jax_prior.msgpack")])
    np.testing.assert_array_equal(run.model.out_proj.weight.detach().numpy(),
                                  params["out_proj"]["kernel"].T)
    torch.save(_reference_state_dict(np.random.default_rng(3), n_blocks=8, yce=64),
               tmp_path / "diffusion_prior_last.pt")
    run = prior_cli.train(flags + ["--prior-ckpt", str(tmp_path / "diffusion_prior_last.pt")])
    assert np.isfinite(run.samples).all() and os.path.exists(run.figure)


def test_moe_prior_trains_and_reports_routes(runs, capsys):
    d, common, _, _ = runs
    run = prior_cli.train(common + ["--epochs", "1", "--moe-experts", "4", "--sample-every", "0",
                                    "--prior-ckpt", "checkpoints/moe.msgpack"])
    assert np.isfinite(run.loss_hist).all() and run.config["n_experts"] == 4
    out = moe_route_stats.route_stats(["--device", "cpu", "--t-points", "4", "--ckpt",
                                       str(d / "port" / "checkpoints" / "moe.msgpack")])
    assert out["conditions"] == 144 and len(out["blocks"]) == 8
    for blk in out["blocks"].values():
        assert abs(sum(blk["fractions"]) - 1.0) < 1e-3
    with pytest.raises(SystemExit, match="not a routed MoE prior"):
        moe_route_stats.route_stats(["--device", "cpu", "--ckpt", str(
            d / "port" / "checkpoints" / "diffusion_prior_last.msgpack")])


@pytest.mark.parametrize("flags, message", [
    (["--shard-pipe", "3"], "--shard-pipe 3 must divide the prior's 8 blocks"),
    (["--shard-expert", "2"], r"--shard-expert 2 requires --moe-experts divisible by it"),
    (["--shard-model", "2", "--shard-pipe", "2", "--pipe-micro", "2"],
     "--shard-pipe and --shard-model are mutually exclusive"),
    (["--shard-pipe", "2", "--pipe-micro", "3"], "must divide by --shard 1 x --pipe-micro 3"),
])
def test_deferred_flags_exit_naming_module_5(runs, flags, message):
    """The pipeline and expert axes run now (ROADMAP.md queue 1, module 5);
    what they cannot run refuses with JAX's words, before any rank starts."""
    _, common, _, _ = runs
    with pytest.raises(SystemExit, match=message):
        prior_cli.train(common + flags)
    with pytest.raises(SystemExit, match=message):
        prior_cli.main(common + flags)


def test_without_device_flag_the_clis_refuse_to_run_on_the_cpu(runs, monkeypatch):
    d, _, _, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        prior_cli.train(["--vae-ckpt", str(d / "vae.msgpack")])
    with pytest.raises(RuntimeError, match="cuda"):
        moe_route_stats.route_stats(["--ckpt", "x.msgpack", "--device", "auto"])
