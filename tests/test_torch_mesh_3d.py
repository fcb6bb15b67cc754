"""The score model's CLIs on JAX's 3-D ("data", "space", "model") mesh at
(2, 2, 2), as the JAX package's `test_cli_shard_3d` runs them (--shard 2
--shard-space 2 --shard-model 2), on the CPU.

One 8-rank gloo job (`parallel.multihost.launch` of `parallel.parity.in_turn`,
one spawn for every call, one torch thread per rank):

- `setup_mesh` for the 3-D flags: the axes and each rank's place in JAX's
  order ("model" fastest, then "space"), the D S ranks of each model
  coordinate, and JAX's refusals (`check_spatial_divisibility`);
- the SDE trainer for one epoch (msgpack), and with --fsdp (HSDP on each
  rank's blocks: sharded over "data", replicated over "space") into DCP for
  one epoch, then --resume to two (`parity.cli_state`: each rank's losses and
  its whole state);
- the sample CLI on the first run's checkpoint (`parity.cli_images`).

Held against the same CLIs in this process: the losses at 1e-6 relative,
Adam's first moment leaf by leaf, and the parameters as
tests/test_torch_model_axis_trainers.py holds the prior CLI's on a model
mesh; the DCP checkpoint is also resumed here, in one process, for a third
epoch. The msgpack checkpoint is read by the JAX package's sample CLI. JAX's
device-count refusal of the 3-D flags is the port's (one rank here).
"""

import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from toycrystals_torch.parallel import launch
from toycrystals_torch.parallel.parity import cli_images, cli_state, in_turn, setup_mesh_probe
from toycrystals_torch.scripts import sample_sde_score_model as sample_cli
from toycrystals_torch.scripts import train_sde_score_model as train_cli
from toycrystals_torch.scripts._common import setup_mesh
from toycrystals_tpu.parallel import make_mesh_3d

ROOT = Path(__file__).resolve().parent.parent
MESH = ["--shard", "2", "--shard-space", "2", "--shard-model", "2"]
D, S, M = 2, 2, 2
LR, STEPS = 1e-4, 2  # the CLI's default lr; 16 items at batch 8
LOSS_RTOL, LEAF, FLOOR = 1e-6, 1e-5, 1e-6
TINY = ["--device", "cpu", "--procedural", "--img-size", "16", "--base-ch", "8",
        "--emb-dim", "16", "--n-samples", "16", "--batch-size", "8", "--sample-every", "0",
        "--ema-decay", "0.9", "--p-uncond", "0.5", "--clip-grad-norm", "0.5"]
SAMPLE = ["--device", "cpu", "--steps", "2", "--n", "4", "--chunk", "4"]
SAMPLE_TOL = 1e-3  # tests/test_torch_tensor_parallel.py's, against one process


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_3d")
    dirs = {k: str(base / k) for k in ("one", "mesh", "hsdp")}
    hsdp = TINY + MESH + ["--fsdp", "--ckpt-format", "orbax", "--out-dir", dirs["hsdp"]]
    probe = [(2, dict(shard_space=2, shard_model=2, img_size=16)),
             (2, dict(shard_space=2, shard_model=2, img_size=20))]
    calls = [(setup_mesh_probe, (probe,)),
             (cli_state, (train_cli.train, TINY + MESH + ["--epochs", "1", "--out-dir",
                                                          dirs["mesh"]])),
             (cli_state, (train_cli.train, hsdp + ["--epochs", "1"])),
             (cli_state, (train_cli.train, hsdp + ["--epochs", "2", "--resume"])),
             (cli_images, (sample_cli.sample, SAMPLE + MESH + [
                 "--out-dir", dirs["mesh"], "--out-path", str(base / "mesh.png")]))]
    ranks = [[res for res, _ in rank] for rank in
             launch(in_turn, D * S * M, (calls,), timeout=600)]
    one = [cli_state(train_cli.train, TINY + ["--epochs", n, "--out-dir", dirs["one"]]
                     + (["--resume"] if n == "2" else [])) for n in ("1", "2")]
    # the DCP checkpoint of the 3-D run resumed in one process for a third epoch
    one.append(cli_state(train_cli.train, TINY + ["--epochs", "3", "--out-dir", dirs["one"],
                                                  "--resume"]))
    hsdp_one = cli_state(train_cli.train, TINY + ["--epochs", "3", "--resume", "--ckpt-format",
                                                  "orbax", "--out-dir", dirs["hsdp"]])
    sampled = sample_cli.sample(SAMPLE + ["--out-dir", dirs["one"], "--ckpt", str(
        Path(dirs["mesh"]) / "checkpoints" / "sde_score_model_last.msgpack"),
        "--out-path", str(base / "one.png")])
    return {"base": base, "dirs": dirs, "ranks": ranks, "one": one, "hsdp_one": hsdp_one,
            "sampled": sampled}


def _hold_grads(got, want, what):
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        lim = LEAF * float(np.abs(w).max()) + FLOOR * top + 1e-12
        np.testing.assert_allclose(got[k], w, rtol=0, atol=lim, err_msg=f"{what} {k}")


def _hold_state(got, want, what, steps):
    """Adam's first moment at `_hold_grads`' limits; the parameters within
    lr/10 a step where the one-process first moment is at least a tenth of
    its leaf's largest entry and at least 1e-5 (chip_smoke.py's hold of a
    step's parameters), and elsewhere within 2 lr a step (Adam moves an
    entry whose gradient is at rounding-noise level by lr times a sign that
    rounding may flip)."""
    _hold_grads(got["mu"], want["mu"], f"{what} first moment")
    assert set(got["params"]) == set(want["params"]), what
    held = 0
    for k, w in want["params"].items():
        mu = np.abs(want["mu"][k])
        keep = mu >= max(0.1 * float(mu.max()), 1e-5)
        held += int(keep.sum())
        np.testing.assert_allclose(got["params"][k][keep], w[keep], rtol=0,
                                   atol=LR / 10 * steps, err_msg=f"{what} params {k}")
        np.testing.assert_allclose(got["params"][k], w, rtol=0, atol=2 * LR * steps,
                                   err_msg=f"{what} params {k}")
    assert held > 1000, (what, held)


def test_setup_mesh_builds_the_3d_mesh_as_jax_does(runs):
    """Each rank's coordinates on ("data", "space", "model") are its place in
    JAX's make_mesh_3d(2, 2, 2) (device id (d S + s) M + m), the D S ranks
    that share its blocks are those of its model coordinate in (data,
    space) order, and an image height whose H/4 does not divide by "space"
    exits with JAX's message; with one rank, the 3-D flags exit with JAX's
    device count."""
    ids = np.vectorize(lambda d: d.id)(make_mesh_3d(D, S, M).devices)
    for rank, res in enumerate(runs["ranks"]):
        built, refused = res[0]
        assert built["axes"] == ["data", "space", "model"]
        d, s, m = built["coords"]
        assert ids[d, s, m] == rank
        assert built["replicas"] == [int(i) for i in ids[:, :, m].reshape(-1)]
        assert refused["exit"] == ("img_size 20 not spatially shardable over 2 devices: "
                                   "H/4 = 5 must divide by the 'space' axis")
    with pytest.raises(SystemExit, match="--shard 2 x --shard-space 2 x --shard-model 2 needs "
                                         "8 devices, have 1"):
        setup_mesh(2, 16, device=torch.device("cpu"), shard_space=2, shard_model=2)


@pytest.mark.parametrize("run", ["mesh", "hsdp_epoch_1", "hsdp_resumed"])
def test_train_cli_on_the_3d_mesh_trains_the_one_process_epochs(runs, run):
    """One epoch on every rank (msgpack; --fsdp into DCP), and the --fsdp
    run's --resume to two epochs, against one process: the losses, Adam's
    first moment and the parameters."""
    call = {"mesh": 1, "hsdp_epoch_1": 2, "hsdp_resumed": 3}[run]
    want = runs["one"][1 if run == "hsdp_resumed" else 0]
    for rank, res in enumerate(runs["ranks"]):
        got, what = res[call], f"{run} rank {rank}"
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL, err_msg=what)
        _hold_state(got, want, what, STEPS * len(want["losses"]))
    if run != "mesh":
        assert sorted(p.name for p in (Path(runs["dirs"]["hsdp"]) / "checkpoints").iterdir()) \
            == ["sde_score_model_last.orbax"]


def test_3d_dcp_checkpoint_resumes_in_one_process(runs):
    """The --fsdp run's DCP checkpoint (HSDP blocks over a 3-D mesh) resumed
    by one process for a third epoch: the one-process run's third epoch."""
    got, want = runs["hsdp_one"], runs["one"][2]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    _hold_state(got, want, "resumed in one process", STEPS * 3)


def test_3d_msgpack_is_read_by_the_jax_sample_cli(runs, monkeypatch):
    from toycrystals_tpu.utils import checkpoint as jck

    run_dir = Path(runs["dirs"]["mesh"])
    ckpt = run_dir / "checkpoints" / "sde_score_model_last.msgpack"
    raw = jck.load_checkpoint(str(ckpt))
    assert int(raw["state"]["step"]) == STEPS
    params = runs["ranks"][0][1]["params"]
    from toycrystals_torch.utils.params import torch_state_dict_from_flax

    for k, v in torch_state_dict_from_flax(jax.tree.map(np.asarray,
                                                        raw["state"]["params"])).items():
        np.testing.assert_array_equal(v, params[k], err_msg=k)
    monkeypatch.chdir(run_dir)
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    monkeypatch.setattr(sys, "argv", [
        "sample_sde_score_model.py", "--device", "cpu", "--out-dir", str(run_dir),
        "--ckpt", str(ckpt), "--steps", "2", "--n", "4", "--sampler", "sde"])
    try:
        runpy.run_path(str(ROOT / "scripts" / "sample_sde_score_model.py"), run_name="__main__")
    except SystemExit as e:
        assert (e.code or 0) == 0
    assert list((run_dir / "results").glob("samples_ckpt-*.png"))


def test_sample_cli_on_the_3d_mesh_matches_one_process(runs):
    """Every rank returns the whole grid, the one-process CLI's at the same
    chunk."""
    want = runs["sampled"].x
    got = [res[4]["x"] for res in runs["ranks"]]
    for x in got:
        np.testing.assert_allclose(x, want, rtol=0, atol=SAMPLE_TOL)
        np.testing.assert_array_equal(x, got[0])
