"""The port's inpainting (toycrystals_torch/models/sde_score_model.py:
sample_inpaint_reverse_sde and scripts/inpaint_sde_score_model.py) against
the JAX package's, on the CPU.

The sampler runs on JAX's own draws (the initial x, and z, zk, z2 of every
step and repeat from fold_in(fold_in(fold_in(k_noise, i), r), 0|1|2)),
injected into the port. Both sides run the same small U-Net (base_ch 8,
emb_dim 16, 16x16, batch 2) from the same flax params in f32. Tolerance 2e-4
on the [0, 1] images, as tests/test_torch_sampler.py; the known region is
equal exactly. The CLI's sources and masks are held to the JAX CLI's
functions, and its JSON line to the JAX CLI's keys.
"""

import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.scripts import inpaint_sde_score_model as inpaint_cli
from toycrystals_torch.utils.checkpoint import save_checkpoint
from toycrystals_torch.utils.figures import quantize_u8, read_png
from toycrystals_torch.utils.params import flax_from_torch_state_dict
from toycrystals_tpu.models import sde_score_model as jm

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
SHAPE = (2, 16, 16, 1)
ATOL = 2e-4
CFG = dict(KW, cond_ch=8, time_ch=8, img_size=16, beta_min=0.1, beta_max=30.0,
           dtype="float32", param="eps")


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    tmodel = tm.CondUNetTiny(**KW).requires_grad_(False)
    params = flax_from_torch_state_dict({k: v.numpy() for k, v in tmodel.state_dict().items()})
    jmodel = jm.CondUNetTiny(**KW)

    @jax.jit
    def japply(prm, xt, t, yc, yv):
        return jmodel.apply({"params": prm}, xt, t, yc, yv)

    return japply, params, tmodel


def _jax_draws(key, n_steps, resample):
    """JAX's draws of sample_inpaint_reverse_sde for `key`: (x_init, [n_steps,
    resample, 3, *SHAPE]); z2 of the last repeat is drawn but never used."""
    k_init, k_noise = jax.random.split(key)
    x = np.asarray(jax.random.normal(k_init, SHAPE, jnp.float32))
    draws = np.zeros((n_steps, resample, 3, *SHAPE), np.float32)
    for i in range(n_steps):
        ki = jax.random.fold_in(k_noise, i)
        for r in range(resample):
            kr = jax.random.fold_in(ki, r)
            for j in range(3 if resample > 1 else 2):
                draws[i, r, j] = np.asarray(jax.random.normal(jax.random.fold_in(kr, j), SHAPE,
                                                              jnp.float32))
    return x, draws


def _known(seed):
    rng = np.random.default_rng(seed)
    x_known = rng.uniform(-0.1, 1.1, size=SHAPE).astype(np.float32)  # clipped inside
    mask = np.ones(SHAPE, np.float32)
    mask[:, 4:12, 4:12] = 0.0
    mask[1, :, :3] = 0.0
    return x_known, mask


@pytest.mark.parametrize("resample", [1, 2])
def test_inpaint_sampler_matches_jax_on_injected_draws(models, resample):
    japply, params, tmodel = models
    y_cat, y_cont = jm.sample_grid_conditions(2, 4, 4)
    x_known, mask = _known(resample)
    key, n = jax.random.key(5 + resample), 3
    js, ts = jm.VPSDE(0.1, 30.0), tm.VPSDE(0.1, 30.0)
    want = np.asarray(jm.sample_inpaint_reverse_sde(
        japply, params, js, y_cat, y_cont, SHAPE, key, n, 1.5, 0.005, 4, resample,
        x_known=jnp.asarray(x_known), mask=jnp.asarray(mask)))
    got = tm.sample_inpaint_reverse_sde(
        tmodel, ts, torch.from_numpy(np.array(y_cat)), torch.from_numpy(np.array(y_cont)),
        SHAPE, None, n, 1.5, 0.005, 4, resample, noise=_jax_draws(key, n, resample),
        x_known=torch.from_numpy(x_known), mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    keep = mask == 1.0
    np.testing.assert_array_equal(got[keep], np.clip(x_known, 0.0, 1.0)[keep])
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_inpaint_sampler_draws_from_the_generator(models):
    _, _, tmodel = models
    yc, yv = tm.sample_grid_conditions(2, 4, 4)
    x_known, mask = _known(0)
    kw = dict(n_steps=2, guidance_scale=0.0, resample=2, x_known=torch.from_numpy(x_known),
              mask=torch.from_numpy(mask))
    a = tm.sample_inpaint_reverse_sde(tmodel, tm.VPSDE(0.1, 30.0), yc, yv, SHAPE,
                                      torch.Generator().manual_seed(1), **kw)
    b = tm.sample_inpaint_reverse_sde(tmodel, tm.VPSDE(0.1, 30.0), yc, yv, SHAPE,
                                      torch.Generator().manual_seed(1), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.equal(a[torch.from_numpy(mask) == 1], torch.from_numpy(x_known)[mask == 1]
                       .clamp(0.0, 1.0))


def test_resample_below_one_and_bad_draws_raise(models):
    _, _, tmodel = models
    yc, yv = tm.sample_grid_conditions(2, 4, 4)
    x_known, mask = _known(0)
    with pytest.raises(ValueError, match="resample"):
        tm.sample_inpaint_reverse_sde(tmodel, tm.VPSDE(), yc, yv, SHAPE, n_steps=2, resample=0,
                                      x_known=x_known, mask=mask)
    with pytest.raises(ValueError, match="draws"):
        tm.sample_inpaint_reverse_sde(tmodel, tm.VPSDE(), yc, yv, SHAPE, n_steps=2,
                                      noise=(np.zeros(SHAPE), np.zeros((2, 1, 2, *SHAPE))),
                                      x_known=x_known, mask=mask)


@pytest.fixture(scope="module")
def jax_cli():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    try:
        return importlib.import_module("inpaint_sde_score_model")
    finally:
        sys.path.pop(0)


@pytest.mark.parametrize("kind", ["center", "left", "bands"])
def test_mask_batch_matches_the_jax_cli(jax_cli, kind):
    for frac in (0.5, 0.2):
        np.testing.assert_array_equal(inpaint_cli._mask_batch(kind, frac, 3, 16),
                                      jax_cli._mask_batch(kind, frac, 3, 16))
    with pytest.raises(ValueError, match="mask"):
        inpaint_cli._mask_batch("ring", 0.5, 1, 16)


def test_sources_match_the_jax_cli(jax_cli):
    """Clean lattices at the grid conditions: the port's renderer against the
    JAX CLI's (f32 sums in another order)."""
    x, y_cat, y_cont = inpaint_cli._render_sources(6, 32, 4, 4, np.pi / 3, torch.device("cpu"))
    jx, jc, jv = jax_cli._render_sources(6, 32, 4, np.pi / 3)
    np.testing.assert_array_equal(y_cat.numpy(), np.asarray(jc))
    np.testing.assert_allclose(y_cont.numpy(), np.asarray(jv), atol=1e-7)
    assert x.shape == (6, 32, 32, 1)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, models):
    _, params, _ = models
    path = tmp_path_factory.mktemp("inpaint") / "tiny.msgpack"
    save_checkpoint(path, {"epoch_next": 1, "config": CFG,
                           "state": {"params": params, "ema_params": params}})
    return str(path)


def test_cli_writes_the_grid_and_the_jax_line(ckpt, tmp_path, capsys):
    out_png = tmp_path / "g.png"
    run = inpaint_cli.inpaint(["--device", "cpu", "--out-dir", str(tmp_path), "--ckpt", ckpt,
                               "--n", "3", "--steps", "2", "--resample", "2", "--cfg", "1.5",
                               "--out-path", str(out_png)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == run.line
    assert list(line) == ["mask", "mask_frac", "n", "steps", "resample", "cfg", "region_mse",
                          "region_var", "region_rel_mse"]
    assert (line["mask"], line["n"], line["steps"], line["resample"]) == ("center", 3, 2, 2)
    assert all(np.isfinite(line[k]) for k in ("region_mse", "region_var", "region_rel_mse"))
    keep = run.mask == 1.0
    np.testing.assert_array_equal(run.x[keep], run.x_src[keep])
    # n rows of (original | masked | inpainted), 2-px white gaps
    img = np.rint(read_png(out_png) * 255.0).astype(np.uint8)
    assert img.shape == (3 * 18 + 2, 3 * 18 + 2)
    for i in range(3):
        y0 = 2 + 18 * i
        np.testing.assert_array_equal(img[y0:y0 + 16, 2:18], quantize_u8(run.x_src[i, ..., 0]))
        np.testing.assert_array_equal(img[y0:y0 + 16, 38:54], quantize_u8(run.x[i, ..., 0]))


def test_cli_refusals(ckpt, tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="--shard 0 x --shard-space 2 x --shard-model 2 "
                                         "needs 4 devices, have 1"):  # JAX's device count
        inpaint_cli.inpaint(["--device", "cpu", "--out-dir", str(tmp_path), "--ckpt", ckpt,
                             "--shard-model", "2", "--shard-space", "2"])
    fm = tmp_path / "fm.msgpack"
    raw = {"epoch_next": 1, "config": dict(CFG, param="fm"),
           "state": {"params": {}, "ema_params": {}}}
    save_checkpoint(fm, raw)
    with pytest.raises(SystemExit, match="fm"):
        inpaint_cli.inpaint(["--device", "cpu", "--out-dir", str(tmp_path), "--ckpt", str(fm)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        inpaint_cli.inpaint(["--out-dir", str(tmp_path), "--ckpt", ckpt])
