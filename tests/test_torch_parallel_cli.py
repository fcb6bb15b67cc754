"""The port's CLIs on a data mesh, on the CPU: `--shard 2` spawns two gloo
ranks (parallel/multihost.py `launch`), the numbers are the one-process
run's, rank 0 alone writes, and the checkpoints pass to one process and to
the JAX package.

Three 2-rank runs in all (module fixtures): train_sde_score_model --shard 2
(DDP), --shard 2 --fsdp --ckpt-format orbax, and sample_sde_score_model
--shard 2 on the first run's checkpoint; then the sample and inpaint CLIs
with --shard-space 2 (and sample on a 2 x 2 mesh) on that checkpoint. The tolerances: a 2-rank epoch's
loss within 1e-6 relative of the one-process epoch's (the same global
batches and draws, other reduction order); Adam's moments in the saved
state, leaf by leaf, within 1e-5 of the leaf's largest entry plus 1e-6 of
the state's largest (tests/test_torch_parallel.py's limits on gradients:
the moments are sums of the two steps' gradients and their squares); the
parameters where the first moment is at least a tenth of its leaf's
largest and 1e-4 of the state's largest, within a tenth of the learning
rate (elsewhere a gradient at rounding-noise level, ~1e-8 of the largest
on the conditioning path here, may take either sign); the 8-bit sample grid within
one level of the one-process grid at the mesh's chunk.
"""

import json
import queue

import numpy as np
import pytest
import torch
from PIL import Image

from toycrystals_torch.parallel import multihost
from toycrystals_torch.scripts import sample_sde_score_model as sample_cli
from toycrystals_torch.scripts import train_diffusion_prior as prior_cli
from toycrystals_torch.scripts import train_sde_score_model as train_cli
from toycrystals_torch.utils import orbax_io
from toycrystals_torch.utils.checkpoint import load_score_payload
from toycrystals_tpu.utils import checkpoint as jck

TINY = ["--device", "cpu", "--procedural", "--img-size", "16", "--base-ch", "8",
        "--emb-dim", "16", "--n-samples", "32", "--batch-size", "16", "--sample-every", "1",
        "--sample-steps", "2", "--ema-decay", "0.9"]
LR = 1e-4  # the train CLI's default
SAMPLE = ["--device", "cpu", "--steps", "3", "--n", "7", "--chunk", "3", "--sampler", "sde"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch runs this module's in-process work on one thread, as each
    spawned rank does: beside other pytest-xdist workers, a pool of one
    thread per core runs such small steps tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metrics(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process, then 2 ranks under DDP, then 2 ranks under FSDP2 with
    DCP checkpoints: 1 epoch each on the same flags."""
    base = tmp_path_factory.mktemp("par")
    one = train_cli.train(TINY + ["--epochs", "1", "--out-dir", str(base / "one")])
    assert train_cli.main(TINY + ["--epochs", "1", "--shard", "2",
                                  "--out-dir", str(base / "ddp")]) == 0
    assert train_cli.main(TINY + ["--epochs", "1", "--shard", "2", "--fsdp", "--ckpt-format",
                                  "orbax", "--out-dir", str(base / "fsdp")]) == 0
    return base, one


def test_two_ranks_train_the_one_process_epoch_and_rank_0_alone_writes(runs):
    base, one = runs
    for name in ("ddp", "fsdp"):
        rows = _metrics(base / name)
        assert [r["epoch"] for r in rows] == [1]
        np.testing.assert_allclose(rows[0]["loss"], one.loss_hist[0], rtol=1e-6)
        assert sorted(p.name for p in (base / name / "results").iterdir()) == [
            "sde_samples_epoch_001.png"]
    assert sorted(p.name for p in (base / "ddp" / "checkpoints").iterdir()) == [
        "sde_score_model_last.msgpack"]
    assert sorted(p.name for p in (base / "fsdp" / "checkpoints").iterdir()) == [
        "sde_score_model_last.orbax"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def _hold_state(got: dict, want: dict, what: str) -> None:
    """`got`'s trained state held to the one-process run's `want` (module
    docstring); 2 Adam steps in both."""
    assert int(got["step"]) == int(want["step"]) == 2
    adam_g, adam_w = got["opt_state"]["0"], want["opt_state"]["0"]
    assert int(adam_g["count"]) == int(adam_w["count"]) == 2
    for part in ("mu", "nu"):
        g, w = _flat(adam_g[part]), _flat(adam_w[part])
        assert g.keys() == w.keys()
        top = max(float(np.abs(v).max()) for v in w.values())
        for k, v in w.items():
            lim = 1e-5 * float(np.abs(v).max()) + 1e-6 * top
            np.testing.assert_allclose(g[k], v, rtol=0, atol=lim, err_msg=f"{what} {part} {k}")
    mu, g, w = _flat(adam_w["mu"]), _flat(got["params"]), _flat(want["params"])
    top = max(float(np.abs(m).max()) for m in mu.values())
    compared = 0
    for k, m in mu.items():
        mask = np.abs(m) >= max(0.1 * float(np.abs(m).max()), 1e-4 * top)
        compared += int(mask.sum())
        np.testing.assert_allclose(g[k][mask], w[k][mask], rtol=0, atol=LR / 10,
                                   err_msg=f"{what} params {k}")
    assert compared > 1000


def test_the_ddp_checkpoint_is_the_jax_packages_msgpack(runs):
    base, one = runs
    raw = jck.load_checkpoint(str(base / "ddp" / "checkpoints" /
                                  "sde_score_model_last.msgpack"))
    assert raw["epoch_next"] == 1 and raw["config"]["base_ch"] == 8
    assert raw["state"]["ema_params"] is not None
    ours = load_score_payload(base / "one" / "checkpoints" / "sde_score_model_last.msgpack")
    _hold_state(raw["state"], ours["state"], "ddp")


def test_the_fsdp_dcp_checkpoint_reads_in_one_process(runs):
    base, _ = runs
    path = base / "fsdp" / "checkpoints" / "sde_score_model_last.orbax"
    assert orbax_io.is_orbax_checkpoint(path)
    payload = load_score_payload(path)
    one = jck.load_checkpoint(str(base / "one" / "checkpoints" / "sde_score_model_last.msgpack"))
    assert payload["epoch_next"] == 1 and payload["config"] == one["config"]
    got = _flat(payload["state"])
    assert {k: v.shape for k, v in got.items()} == {k: v.shape
                                                     for k, v in _flat(one["state"]).items()}
    _hold_state(payload["state"], one["state"], "fsdp")


@pytest.mark.parametrize("name, fmt", [("ddp", "msgpack"), ("fsdp", "orbax")])
def test_resume_in_one_process(runs, name, fmt):
    base, one = runs
    run = train_cli.train(TINY + ["--epochs", "2", "--resume", "--ckpt-format", fmt,
                                  "--out-dir", str(base / name)])
    assert run.state.step == 4 and len(run.loss_hist) == 2
    assert [r["epoch"] for r in _metrics(base / name)] == [1, 2]
    assert np.isfinite(run.loss_hist).all()


def test_sample_on_two_ranks_is_the_one_process_grid(runs):
    base, _ = runs
    ckpt = str(base / "one" / "checkpoints" / "sde_score_model_last.msgpack")
    common = SAMPLE + ["--ckpt", ckpt, "--out-dir", str(base)]
    assert sample_cli.main(common + ["--shard", "2", "--out-path", str(base / "two.png")]) == 0
    ref = sample_cli.sample(common + ["--chunk", "4", "--out-path", str(base / "ref.png")])
    assert ref.x.shape == (7, 16, 16, 1)
    got = np.asarray(Image.open(base / "two.png"), np.int16)
    want = np.asarray(Image.open(base / "ref.png"), np.int16)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1


@pytest.mark.parametrize("cli, mesh", [("sample", ["--shard-space", "2"]),
                                       ("sample", ["--shard", "2", "--shard-space", "2"]),
                                       ("inpaint", ["--shard-space", "2"])])
def test_shard_space_gives_the_one_process_grid(runs, cli, mesh):
    """--shard-space 2 (and a 2 x 2 mesh) splits every image's rows over the
    ranks: the grid is the one-process grid at the mesh's chunk, within one
    8-bit level."""
    from toycrystals_torch.scripts import inpaint_sde_score_model as inpaint_cli

    base, _ = runs
    ckpt = str(base / "one" / "checkpoints" / "sde_score_model_last.msgpack")
    name = "_".join([cli, *mesh[::2]]).replace("-", "")
    if cli == "sample":
        module, common = sample_cli, SAMPLE + ["--ckpt", ckpt, "--out-dir", str(base)]
    else:
        module = inpaint_cli
        common = ["--device", "cpu", "--ckpt", ckpt, "--out-dir", str(base), "--n", "3",
                  "--steps", "2", "--resample", "2", "--cfg", "1.5"]
    assert module.main(common + mesh + ["--out-path", str(base / f"{name}.png")]) == 0
    chunk = ["--chunk", "4"] if "--shard" in mesh else []
    module.main(common + chunk + ["--out-path", str(base / f"{name}_ref.png")])
    got = np.asarray(Image.open(base / f"{name}.png"), np.int16)
    want = np.asarray(Image.open(base / f"{name}_ref.png"), np.int16)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1


def test_shard_needs_as_many_devices_as_jax(monkeypatch, tmp_path):
    """--shard 2 on the card with one device exits as JAX does, before any
    rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--shard 2 but only 1 devices visible"):
        train_cli.main(["--procedural", "--shard", "2", "--out-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="batch size 16 not divisible by --shard 3"):
        train_cli.main(TINY + ["--shard", "3", "--out-dir", str(tmp_path)])


@pytest.mark.parametrize("cli", ["sde", "prior"])
def test_multi_host_fsdp_refusals_carry_over(monkeypatch, tmp_path, cli):
    """Ranks joined by the cluster flags cannot gather an FSDP state into one
    msgpack: the JAX trainers' refusals."""
    if cli == "sde":
        monkeypatch.setattr(train_cli, "init_distributed", lambda *a: True)
        with pytest.raises(SystemExit, match="needs --ckpt-format orbax"):
            train_cli.train(TINY + ["--fsdp", "--out-dir", str(tmp_path)])
    else:
        monkeypatch.setattr(prior_cli, "init_distributed", lambda *a: True)
        with pytest.raises(SystemExit, match="multi-host --fsdp"):
            prior_cli.train(["--device", "cpu", "--fsdp", "--out-dir", str(tmp_path)])


class _Proc:
    def __init__(self, exitcode=None):
        self.exitcode, self.killed = exitcode, False

    def is_alive(self):
        return self.exitcode is None and not self.killed

    def kill(self):
        self.killed = True


@pytest.mark.parametrize("event", ["error", "death", "deadline"])
def test_the_launcher_kills_every_rank_when_one_fails(event):
    """A rank's exception, a rank's death or the deadline: every rank is
    killed and the caller gets an error instead of a hang."""
    results: queue.Queue = queue.Queue()
    procs = [_Proc(), _Proc()]
    results.put((1, True, "done"))
    if event == "error":
        results.put((0, False, "Traceback: boom"))
    elif event == "death":
        procs[0].exitcode = -11
    want = {"error": (RuntimeError, "rank 0 failed"), "death": (RuntimeError, "exit code -11"),
            "deadline": (TimeoutError, "did not finish")}[event]
    with pytest.raises(want[0], match=want[1]):
        multihost._collect(procs, results, 0.0 if event == "deadline" else 1e18)
    assert procs[1].killed or procs[1].exitcode is not None
