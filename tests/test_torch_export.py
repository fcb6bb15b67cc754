"""The port's export (toycrystals_torch/export.py and its two CLIs) on the CPU,
mirroring tests/test_export.py at a tiny size (base_ch 8, 16x16):

- the round trip through the file equals `service.sample` at the same seed
  and batch (the JAX contract is atol 1e-4; a CPU export runs the same aten
  kernels as eager, so this holds it bit for bit);
- the artefact runs from its bytes with no checkpoint and, for a CPU export,
  with torch alone;
- a distilled student freezes ddim, its steps and guidance 0;
- a bad magic line raises, and so does more than one platform;
- the export CLI with --selftest;
- the `.pt` export equals the JAX script's (weights, EMA, config) and loads
  through the port's `load_torch_score_checkpoint`;
- the custom ops' fake functions give the eager shapes (`torch.library.opcheck`
  on the CPU, and on fake CUDA tensors); the noise draws are the sampler's.
"""

import json
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from toycrystals_torch import export as tex
from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.ops import attention as at
from toycrystals_torch.ops import groupnorm as gn
from toycrystals_torch.scripts import export_sde_score_model as export_cli
from toycrystals_torch.scripts import export_torch_checkpoint as pt_cli
from toycrystals_torch.serve import ScoreModelService
from toycrystals_torch.utils.params import flax_from_torch_state_dict
from toycrystals_torch.utils.torch_interop import load_torch_score_checkpoint
from toycrystals_tpu.utils import load_checkpoint, save_checkpoint

ROOT = Path(__file__).resolve().parent.parent
CFG = {
    "img_ch": 1, "img_size": 16, "n_types": 4, "y_cont_dim": 4,
    "base_ch": 8, "emb_dim": 16, "cond_ch": 8, "time_ch": 8,
    "beta_min": 0.1, "beta_max": 30.0, "logsnr_shift": 0.0,
    "t_power": 1.0, "p_uncond": 0.1, "dtype": "float32", "param": "eps",
}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint written by the JAX `save_checkpoint`, with flax-default
    weights and an EMA that differs from them (the services read only
    these two trees)."""
    d = tmp_path_factory.mktemp("torch_export_ckpts")
    net = tm.CondUNetTiny(4, 4, base_ch=8, emb_dim=16)
    params = flax_from_torch_state_dict(
        flax_default_init(net, np.random.default_rng(0)).state_dict())
    ema = jax.tree.map(lambda p: (p * 0.9).astype(np.float32), params)
    path = d / "m.msgpack"
    save_checkpoint(path, {"epoch_next": 2,
                           "state": {"step": np.int32(4), "params": params, "ema_params": ema},
                           "loss_hist": [0.5, 0.25], "config": CFG})
    return str(path)


def _conditions(b):
    yc = (np.arange(b) % 4).astype(np.int32)
    yv = np.zeros((b, 4), np.float32)
    yv[:, 1] = np.linspace(0.0, 1.0, b)
    return yc, yv


def test_export_round_trip_matches_service(ckpt, tmp_path):
    svc = ScoreModelService.from_checkpoint(ckpt, device="cpu", steps=3, buckets=(4,))
    assert svc.ckpt_path == ckpt
    exported = tex.export_service(svc, 4)
    meta = tex.export_meta(svc, 4, exported)
    assert meta["ckpt"] == ckpt and meta["platforms"] == ["cpu"]
    assert (meta["sampler"], meta["steps"], meta["noise_steps"]) == ("sde", 3, 3)
    assert meta["custom_ops"] == []  # a CPU trace runs the plain versions
    out = tmp_path / "m.tcx"
    tex.save_exported(out, exported, meta)

    fn, meta2 = tex.load_exported(out)
    assert meta2 == meta
    yc, yv = _conditions(4)
    got = fn(yc, yv, 7).numpy()
    want = svc.sample(yc, yv, seed=7)
    assert got.shape == (4, 16, 16, 1) and (got >= 0).all() and (got <= 1).all()
    np.testing.assert_array_equal(got, want)
    # the seed matters, and the graph is the service's dispatch on given noise
    assert np.abs(fn(yc, yv, 8).numpy() - got).max() > 0
    gen = torch.Generator().manual_seed(7)
    x_init, z = svc.draw_noise(4, gen)
    with torch.no_grad():
        direct = fn.graph_module(torch.from_numpy(yc), torch.from_numpy(yv), x_init, z)
    np.testing.assert_array_equal(direct.numpy(), got)


def test_draw_sampler_noise_is_the_samplers_own_draws():
    """x_init, then z[i] per step: the reverse SDE run on a generator equals
    it run on these draws, bit for bit."""
    x_init, z = tm.draw_sampler_noise((2, 8, 8, 1), 3, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    want = [torch.randn((2, 8, 8, 1), generator=gen) for _ in range(4)]
    torch.testing.assert_close(x_init, want[0], rtol=0, atol=0)
    torch.testing.assert_close(z, torch.stack(want[1:]), rtol=0, atol=0)
    assert tm.draw_sampler_noise((2, 8, 8, 1), 0, None)[1].shape == (0, 2, 8, 8, 1)
    # drawn as read: the same values, in order only
    x_lazy, lazy = tm.draw_sampler_noise((2, 8, 8, 1), 3, torch.Generator().manual_seed(3),
                                         lazy=True)
    assert isinstance(lazy, tm.StepDraws) and lazy.shape == (3, 2, 8, 8, 1)
    torch.testing.assert_close(x_lazy, want[0], rtol=0, atol=0)
    torch.testing.assert_close(lazy[0], want[1], rtol=0, atol=0)
    with pytest.raises(IndexError, match="in order"):
        lazy[2]


def test_service_dispatch_equals_the_sampler_on_either_noise():
    """The service's dispatch (z drawn as read) equals the reverse SDE on the
    generator and on the materialized draws, bit for bit."""
    net = tm.CondUNetTiny(4, 4, base_ch=8, emb_dim=16)
    params = flax_from_torch_state_dict(
        flax_default_init(net, np.random.default_rng(1)).state_dict())
    svc = ScoreModelService(CFG, params, device="cpu", steps=3, buckets=(2,))
    yc, yv = _conditions(2)
    got = svc.sample(yc, yv, seed=9)
    args = (svc._apply_fn, svc.sde, torch.from_numpy(yc), torch.from_numpy(yv), (2, 16, 16, 1))
    kw = dict(n_steps=3, guidance_scale=1.5, t_end=0.005, n_types=4)
    with torch.no_grad():
        direct = tm.sample_reverse_sde_euler_maruyama(
            *args, torch.Generator().manual_seed(9), **kw)
        drawn = tm.sample_reverse_sde_euler_maruyama(
            *args, noise=svc.draw_noise(2, torch.Generator().manual_seed(9)), **kw)
    np.testing.assert_array_equal(got, direct.numpy())
    np.testing.assert_array_equal(got, drawn.numpy())


def test_exported_is_self_contained(ckpt, tmp_path):
    """The artefact runs from its bytes with the checkpoint gone, in a process
    that imports torch alone (a CPU export calls no custom op)."""
    src = tmp_path / "gone.msgpack"
    src.write_bytes(Path(ckpt).read_bytes())
    out = tmp_path / "m.tcx"
    meta = tex.export_checkpoint(str(src), out, batch=2, steps=2, platforms=["cpu"])
    assert (meta["steps"], meta["batch"]) == (2, 2)
    src.unlink()
    fn, _ = tex.load_exported(out)
    yc, yv = _conditions(2)
    np.save(tmp_path / "yc.npy", yc)
    np.save(tmp_path / "yv.npy", yv)
    want = fn(yc, yv, 5).numpy()
    code = f"""
import io, json, struct, sys
import numpy as np, torch
raw = open({str(out)!r}, "rb").read()
off = raw.index(b"\\n") + 1
(hlen,) = struct.unpack(">Q", raw[off:off + 8])
meta = json.loads(raw[off + 8:off + 8 + hlen])
module = torch.export.load(io.BytesIO(raw[off + 8 + hlen:])).module()
b, s = meta["batch"], meta["img_size"]
gen = torch.Generator().manual_seed(5)
x_init = torch.randn((b, s, s, 1), generator=gen)
z = torch.stack([torch.randn((b, s, s, 1), generator=gen) for _ in range(meta["noise_steps"])])
with torch.no_grad():
    x = module(torch.from_numpy(np.load("yc.npy")), torch.from_numpy(np.load("yv.npy")), x_init, z)
np.save("x.npy", x.numpy())
assert not any(m.startswith("toycrystals") for m in sys.modules)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    np.testing.assert_array_equal(np.load(tmp_path / "x.npy"), want)


def test_distilled_settings_freeze(ckpt, tmp_path):
    payload = load_checkpoint(ckpt)
    payload["config"] = dict(CFG, param="v", distilled=True, distill_steps=2,
                             distill_t_end=0.005, distill_cfg=1.5)
    dist = tmp_path / "dist.msgpack"
    save_checkpoint(dist, payload)
    meta = tex.export_checkpoint(str(dist), tmp_path / "d.tcx", batch=2, device="cpu")
    assert (meta["sampler"], meta["steps"], meta["guidance_scale"]) == ("ddim", 2, 0.0)
    assert meta["distilled"] is True and meta["noise_steps"] == 0
    fn, _ = tex.load_exported(tmp_path / "d.tcx")
    yc, yv = _conditions(2)
    got = fn(yc, yv, 1).numpy()
    svc = ScoreModelService.from_checkpoint(str(dist), device="cpu", buckets=(2,))
    np.testing.assert_array_equal(got, svc.sample(yc, yv, seed=1))


def test_bad_container_rejected(tmp_path):
    p = tmp_path / "junk.tcx"
    p.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="bad magic"):
        tex.load_exported(p)
    # the JAX package's magic line is not the port's
    p.write_bytes(b"TOYCRYSTALS-TPU-EXPORT-V1\n" + b"\0" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        tex.load_exported(p)


def test_one_platform_per_artefact(ckpt):
    svc = ScoreModelService.from_checkpoint(ckpt, device="cpu", steps=1, buckets=(2,))
    assert tex.export_service(svc, 2, platforms=["cpu"]) is not None
    with pytest.raises(ValueError, match="one device"):
        tex.export_service(svc, 2, platforms=["cuda", "cpu"])
    with pytest.raises(ValueError, match="runs on cpu"):
        tex.export_service(svc, 2, platforms=["cuda"])
    with pytest.raises(SystemExit, match="one device"):
        export_cli.export(["--device", "cpu", "--ckpt", ckpt, "--out", "x.tcx",
                           "--platform", "cpu", "--platform", "cuda"])


def test_cli_export_selftest(ckpt, tmp_path, capsys):
    out = tmp_path / "cli.tcx"
    rec = export_cli.export(["--device", "cpu", "--ckpt", ckpt, "--out", str(out),
                             "--batch", "2", "--steps", "2", "--selftest"])
    captured = capsys.readouterr()
    assert "selftest: artefact == live service" in captured.err
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(rec))
    assert (line["batch"], line["steps"], line["sampler"]) == (2, 2, "sde")
    assert line["selftest_max_abs_diff"] == 0.0  # atol 1e-4 is the contract; CPU is exact
    assert out.exists() and out.stat().st_size > 1000


def test_cli_refuses_without_gpu(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        export_cli.export(["--ckpt", ckpt, "--out", "x.tcx"])


def test_torch_checkpoint_export_matches_jax_script(ckpt, tmp_path, monkeypatch):
    """The port's .pt equals the JAX script's in weights, EMA, config and
    epoch; its loss_hist holds the losses (the JAX script writes the floats of
    the restored dict's keys); it loads back through the port's reader."""
    port_pt, jax_pt = tmp_path / "port.pt", tmp_path / "jax.pt"
    obj = pt_cli.export(["--ckpt", ckpt, "--out", str(port_pt)])
    monkeypatch.setattr(sys, "argv", ["export_torch_checkpoint.py", "--ckpt", ckpt,
                                      "--out", str(jax_pt)])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(ROOT / "scripts" / "export_torch_checkpoint.py"),
                       run_name="__main__")
    assert done.value.code == 0
    mine = torch.load(port_pt, weights_only=True)
    theirs = torch.load(jax_pt, weights_only=True)
    assert set(mine) == set(theirs) == {"epoch_next", "model", "opt", "loss_hist", "config",
                                        "ema"}
    for key in ("model", "ema"):
        assert list(mine[key]) == list(theirs[key])
        for k in mine[key]:
            torch.testing.assert_close(mine[key][k], theirs[key][k], rtol=0, atol=0)
    assert mine["config"] == theirs["config"] and mine["epoch_next"] == theirs["epoch_next"] == 2
    assert mine["loss_hist"] == obj["loss_hist"] == [0.5, 0.25]
    assert theirs["loss_hist"] == [0.0, 1.0]

    payload = load_torch_score_checkpoint(str(port_pt))
    want = load_checkpoint(ckpt)["state"]
    for tree in ("params", "ema_params"):
        got_leaves = jax.tree.leaves(payload["state"][tree])
        want_leaves = jax.tree.leaves(jax.tree.map(np.asarray, want[tree]))
        assert len(got_leaves) == len(want_leaves)
        for a, b in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(a, b)
    save_checkpoint(tmp_path / "s2d.msgpack", {"epoch_next": 1,
                                               "state": load_checkpoint(ckpt)["state"],
                                               "loss_hist": [], "config": dict(CFG, stem="s2dr")})
    with pytest.raises(SystemExit, match="s2d stem"):
        pt_cli.export(["--ckpt", str(tmp_path / "s2d.msgpack"), "--out", str(tmp_path / "x.pt")])


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_silu_op_fake_gives_the_eager_shape(pad, dtype):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(2, 8, 6, 5)), dtype=dtype)
    scale, bias = (torch.tensor(rng.normal(size=8), dtype=torch.float32) for _ in range(2))
    torch.library.opcheck(gn.gn_silu_op, (x, scale, bias, 4, 1e-6, pad))
    eager = gn.gn_silu_op(x, scale, bias, 4, 1e-6, pad)
    torch.testing.assert_close(eager, gn.gn_silu_reference(x, scale, bias, 4, 1e-6, pad),
                               rtol=0, atol=0)
    with FakeTensorMode():
        fx = torch.empty(x.shape, dtype=dtype, device="cuda")
        fs = torch.empty(8, device="cuda")
        fake = torch.ops.toycrystals.gn_silu(fx, fs, fs, 4, 1e-6, pad)
    assert (fake.shape, fake.dtype, fake.device.type) == (eager.shape, dtype, "cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_fake_gives_the_eager_shape(dtype):
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.normal(size=(2, 128, 2, 16)), dtype=dtype) for _ in range(3))
    torch.library.opcheck(at.flash_forward_op, (q, k, v, 0.25))
    eager = at.flash_forward_op(q, k, v, 0.25)
    torch.testing.assert_close(eager, at.sdpa_reference(q, k, v), rtol=0, atol=0)
    with FakeTensorMode():
        fq = torch.empty((24, 4096, 4, 48), dtype=dtype, device="cuda")
        fake = torch.ops.toycrystals.flash_sdpa_fwd(fq, fq, fq, 48 ** -0.5)
    assert (tuple(fake.shape), fake.dtype, fake.device.type) == ((24, 4096, 4, 48), dtype, "cuda")


def test_ops_register_at_import_without_building():
    """The ops package registers both ops; importing it built nothing."""
    import toycrystals_torch.ops  # noqa: F401
    from toycrystals_torch.utils import cuda_build

    assert hasattr(torch.ops.toycrystals, "gn_silu")
    assert hasattr(torch.ops.toycrystals, "flash_sdpa_fwd")
    assert cuda_build._libs == {}
