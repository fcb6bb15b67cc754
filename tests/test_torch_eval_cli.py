"""The port's eval CLI (toycrystals_torch/scripts/eval_sde_score_model.py)
on the CPU: --grid on the four committed grids against the JAX CLI's
arithmetic (utils/fidelity.py, utils/fid.py of the JAX package), --ckpt on
a tiny checkpoint, the JSON line's keys and the refusals.

Tolerances: type_acc, type_acc_merged01 and cond_fidelity within 1e-5; FID
and its floor within 1e-4; theta_mae_deg within 1e-4 (the JAX CLI's limit for
a backend change is 0.1 deg). The committed grids' JAX scores, printed by
`scripts/eval_sde_score_model.py --device cpu --grid <png> --fid-vae
assets/eval/feature_vae_z16.msgpack`, are checked to their 4 printed
decimals as well.
"""

import json

import numpy as np
import pytest
import torch

from toycrystals_torch.scripts import eval_sde_score_model as eval_cli
from toycrystals_torch.scripts import train_sde_score_model as train_cli
from toycrystals_tpu.data.lattice import LatticeConfig as JLatticeConfig
from toycrystals_tpu.utils import fid as jfid
from toycrystals_tpu.utils import fidelity as jf

EXTRACTOR = "assets/eval/feature_vae_z16.msgpack"
# (type_acc, type_acc_merged01, theta_mae_deg, cond_fidelity, fid, fid_floor) of the JAX CLI
JAX_CLI = {
    "score_based_diffusion_samples": (0.9444, 1.000, 1.3730, 0.89095, 2.5270, 0.8045),
    "distill_16step": (1.0000, 1.000, 0.6310, 0.95087, 1.6528, 0.8045),
    "distill_4step": (0.9444, 1.000, 0.7381, 0.91484, 1.8646, 0.8045),
    "fm64_rf50_samples": (0.9444, 1.000, 0.7897, 0.92223, 2.2264, 0.8045),
}
SCALARS = ["type_acc", "type_acc_merged01", "theta_mae_deg", "cond_fidelity", "fid",
           "fid_floor"]


@pytest.fixture(scope="module")
def jax_fid():
    model, params, cfg = jfid.load_feature_extractor(EXTRACTOR)
    lat = JLatticeConfig(img_size=int(cfg.get("img_size", 64)), rot_only=True)
    return model, params, lat, jfid.reference_stats(model, params, cfg=lat, n=4096)


@pytest.mark.parametrize("name", list(JAX_CLI))
def test_grid_mode_reproduces_the_jax_cli(name, jax_fid, capsys):
    path = f"assets/score_based_diffusion/{name}.png"
    line = eval_cli.evaluate(["--device", "cpu", "--grid", path, "--fid-vae", EXTRACTOR]).line
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    # the JAX CLI's keys, in its order
    assert list(line) == ["grid", "fid_vae", "fid_ref_n", *SCALARS]
    assert (line["grid"], line["fid_vae"], line["fid_ref_n"]) == (path, EXTRACTOR, 4096)

    # what the JAX CLI computes for --grid --fid-vae
    res = jf.score_grid_png(path)
    model, params, lat, ref = jax_fid
    tiles = jf.extract_grid_tiles(path, 6, 6, 64)[..., None]
    want = {k: v for k, v in res.items() if isinstance(v, float)}
    want["fid"] = jfid.compute_fid(tiles, model, params, ref_stats=ref)
    want["fid_floor"] = jfid.fid_floor(model, params, 36, ref, cfg=lat)
    for k, tol in (("type_acc", 1e-5), ("type_acc_merged01", 1e-5), ("cond_fidelity", 1e-5),
                   ("theta_mae_deg", 1e-4), ("fid", 1e-4), ("fid_floor", 1e-4)):
        np.testing.assert_allclose(line[k], want[k], atol=tol, rtol=0, err_msg=k)
    for k, printed_value in zip(SCALARS, JAX_CLI[name]):
        decimals = 5 if k == "cond_fidelity" else 4
        assert round(line[k], decimals) == pytest.approx(printed_value, abs=1e-9), k


def test_ckpt_mode_samples_through_the_service_and_writes_its_files(tmp_path, capsys):
    run = tmp_path / "run"
    train_cli.train(["--device", "cpu", "--procedural", "--img-size", "64", "--base-ch", "8",
                     "--emb-dim", "16", "--n-samples", "16", "--batch-size", "16",
                     "--epochs", "1", "--sample-every", "0", "--ema-decay", "0.9",
                     "--out-dir", str(run)])
    ckpt = str(run / "checkpoints" / "sde_score_model_last.msgpack")
    capsys.readouterr()
    out = eval_cli.evaluate(["--device", "cpu", "--ckpt", ckpt, "--n", "4", "--steps", "2",
                             "--fid-vae", EXTRACTOR, "--save-grid", str(tmp_path / "g.png"),
                             "--json-out", str(tmp_path / "r.json")])
    line = out.line
    assert list(line) == ["ckpt", "sampler", "steps", "cfg", "t_end", "use_ema", "quantize",
                          "seed", "n", "fid_vae", "fid_ref_n", *SCALARS]
    assert (line["sampler"], line["steps"], line["cfg"], line["t_end"], line["n"]) == \
        ("sde", 2, 1.5, 0.005, 4)
    assert all(np.isfinite(line[k]) for k in SCALARS) and line["fid_floor"] > 0
    assert out.x.shape == (4, 64, 64, 1) and 0.0 <= out.x.min() and out.x.max() <= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    full = json.loads((tmp_path / "r.json").read_text())
    assert {k: full[k] for k in line} == line
    assert len(full["pred_type"]) == len(full["cond_corr"]) == 4
    assert (tmp_path / "g.png").exists()
    # the same seed gives the same samples
    again = eval_cli.evaluate(["--device", "cpu", "--ckpt", ckpt, "--n", "4", "--steps", "2"])
    np.testing.assert_array_equal(again.x, out.x)


def test_refusals(tmp_path, monkeypatch):
    path = "assets/score_based_diffusion/distill_4step.png"
    with pytest.raises(SystemExit, match="ROADMAP.md queue 1, module 3"):
        eval_cli.evaluate(["--device", "cpu", "--grid", path, "--quantize", "int8"])
    with pytest.raises(SystemExit):  # --ckpt and --grid exclude each other
        eval_cli.evaluate(["--device", "cpu", "--grid", path, "--ckpt", "x.msgpack"])
    with pytest.raises(FileNotFoundError):
        eval_cli.evaluate(["--device", "cpu", "--grid", str(tmp_path / "missing.png")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        eval_cli.evaluate(["--grid", path])
