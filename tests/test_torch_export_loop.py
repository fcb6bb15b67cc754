"""The exported step loop (toycrystals_torch/export.py, models/sde_score_model.py
`run_steps`) on the CPU at a tiny size (base_ch 8, 16x16, batch 2).

Each sampler the service offers (sde, ode, dpm, ddim as a distilled student,
rf) exports its steps as one `scan`:

- the artefact, saved and loaded, equals `service.sample` at the same seed
  and batch bit for bit (a CPU graph runs the eager aten kernels), and runs
  its step exactly once per step of the loop;
- its graph, run on JAX's own draws for the seed, agrees with JAX's exported
  artefact (`toycrystals_tpu.export`) within tests/test_torch_sampler.py's
  tolerances: 2e-4 on the [0, 1] images, 1e-4 for dpm.

Also: the SDE graph has as many nodes at 30 steps as at 3 and its file the
same bytes within 1%, with no example inputs in it; DDIM at one step runs no
loop; an export on a mesh raises.
"""

import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from toycrystals_torch import export as tex
from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.parallel import spatial
from toycrystals_torch.parallel.mesh import make_mesh
from toycrystals_torch.serve import ScoreModelService
from toycrystals_torch.utils.params import flax_from_torch_state_dict
from toycrystals_tpu import export as jex
from toycrystals_tpu.serve import ScoreModelService as JaxService
from toycrystals_tpu.utils import save_checkpoint

B, SEED = 2, 7
CFG = {
    "img_ch": 1, "img_size": 16, "n_types": 4, "y_cont_dim": 4,
    "base_ch": 8, "emb_dim": 16, "cond_ch": 8, "time_ch": 8,
    "beta_min": 0.1, "beta_max": 30.0, "logsnr_shift": 0.0,
    "t_power": 1.0, "p_uncond": 0.1, "dtype": "float32", "param": "eps",
}
# sampler -> (checkpoint config, service settings, atol against JAX, steps in the scan)
CASES = {
    "sde": ({}, dict(sampler="sde", steps=3), 2e-4, 3),  # 3 steps: also the flat test's
    "ode": ({}, dict(sampler="ode", steps=2), 2e-4, 2),
    "dpm": ({"param": "v", "logsnr_shift": -2.77}, dict(sampler="dpm", steps=3), 1e-4, 3),
    # DDIM's last evaluation is its epilogue, so a 2-step student scans 1 step
    "ddim": ({"param": "v", "distilled": True, "distill_steps": 2, "distill_t_end": 0.005,
              "distill_cfg": 1.5}, {}, 2e-4, 1),
    "rf": ({"param": "fm", "fm_shift": 2.0}, dict(sampler="rf", steps=3), 2e-4, 3),
}


@pytest.fixture(scope="module")
def params():
    net = tm.CondUNetTiny(4, 4, base_ch=8, emb_dim=16)
    return flax_from_torch_state_dict(
        flax_default_init(net, np.random.default_rng(0)).state_dict())


def _ckpt(path, params, **cfg):
    save_checkpoint(path, {"epoch_next": 1, "state": {"step": np.int32(1), "params": params},
                           "loss_hist": [], "config": dict(CFG, **cfg)})
    return str(path)


def _conditions():
    yc = (np.arange(B) % 4).astype(np.int32)
    yv = np.zeros((B, 4), np.float32)
    yv[:, 1] = np.linspace(0.0, 1.0, B)
    return yc, yv


def _scans(ep) -> int:
    return sum(n.target is torch.ops.higher_order.scan for n in ep.graph.nodes)


def _round_trip(svc, path):
    """Export, save, load: (exported program, fn, meta)."""
    ep = tex.export_service(svc, B)
    tex.save_exported(path, ep, tex.export_meta(svc, B, ep))
    fn, meta = tex.load_exported(path)
    return ep, fn, meta


@pytest.fixture(scope="module")
def artefact(params, tmp_path_factory):
    """artefact(sampler, steps=None): the case's checkpoint, service and
    round trip, each made once (a CPU export takes about 20 s)."""
    made = {}

    def get(sampler, steps=None):
        cfg, kw = CASES[sampler][:2]
        kw = dict(kw) if steps is None else dict(kw, steps=steps)
        key = (sampler, kw.get("steps"))
        if key not in made:
            d = tmp_path_factory.mktemp(f"export_loop_{sampler}")
            ckpt = _ckpt(d / "m.msgpack", params, **cfg)
            svc = ScoreModelService.from_checkpoint(ckpt, device="cpu", buckets=(B,), **kw)
            path = d / "m.tcx"
            made[key] = (ckpt, kw, svc, path, *_round_trip(svc, path))
        return made[key]

    return get


def _jax_draws(sampler: str, noise_steps: int):
    """The draws JAX's dispatch takes from jax.random.key(SEED): x_init, and
    for the reverse SDE z[i] from fold_in(k_noise, i)."""
    shape = (B, 16, 16, 1)
    key = jax.random.key(SEED)
    if sampler != "sde":
        return np.asarray(jax.random.normal(key, shape, jnp.float32)), \
            np.zeros((0, *shape), np.float32)
    k_init, k_noise = jax.random.split(key)
    z = [np.asarray(jax.random.normal(jax.random.fold_in(k_noise, i), shape, jnp.float32))
         for i in range(noise_steps)]
    return np.asarray(jax.random.normal(k_init, shape, jnp.float32)), np.stack(z)


@pytest.mark.parametrize("sampler", sorted(CASES))
def test_loop_export_matches_service_and_jax(sampler, artefact):
    ckpt, kw, svc, _, ep, fn, meta = artefact(sampler)
    assert svc.sampler_name == sampler
    assert _scans(ep) == 1
    assert (meta["loop"], meta["version"]) == ("scan", 2)
    assert meta["graph_nodes"] == tex.graph_nodes(ep)
    yc, yv = _conditions()
    # the loaded graph runs its step once per step (torch's own eager scan may
    # run it once more first, to learn its outputs' shapes)
    step, runs = fn.graph_module.scan_combine_graph_0, []
    step.forward = lambda *a, _f=step.forward: runs.append(1) or _f(*a)
    np.testing.assert_array_equal(fn(yc, yv, SEED).numpy(), svc.sample(yc, yv, seed=SEED))
    assert len(runs) == CASES[sampler][3]

    jsvc = JaxService(ckpt, buckets=(B,), **kw)
    assert (jsvc.sampler_name, jsvc.steps) == (sampler, svc.steps)
    want = np.asarray(jex.export_service(jsvc, B, platforms=["cpu"]).call(yc, yv,
                                                                         np.int32(SEED)))
    x_init, z = _jax_draws(sampler, svc.noise_steps)
    with torch.no_grad():
        got = fn.graph_module(*(torch.tensor(a) for a in (yc, yv, x_init, z))).numpy()
    assert got.shape == want.shape == (B, 16, 16, 1)
    np.testing.assert_allclose(got, want, atol=CASES[sampler][2])


def test_sde_graph_and_file_are_flat_in_the_steps(artefact):
    nodes, sizes = [], []
    for steps in (3, 30):
        _, _, svc, path, ep, _, meta = artefact("sde", steps)
        assert meta["noise_steps"] == steps
        nodes.append(tex.graph_nodes(ep))
        sizes.append(path.stat().st_size)
        _, blob = tex.read_container(path.read_bytes())
        archive = zipfile.ZipFile(io.BytesIO(blob))
        assert not [i.filename for i in archive.infolist()
                    if "sample_inputs" in i.filename and i.file_size]
    assert nodes[0] == nodes[1]
    assert abs(sizes[1] - sizes[0]) <= 0.01 * sizes[0], sizes


def test_ddim_at_one_step_runs_no_loop(params, tmp_path):
    ckpt = _ckpt(tmp_path / "m.msgpack", params, param="v")
    svc = ScoreModelService.from_checkpoint(ckpt, device="cpu", sampler="ddim", steps=1,
                                            buckets=(B,))
    ep, fn, meta = _round_trip(svc, tmp_path / "d.tcx")
    assert _scans(ep) == 0 and meta["steps"] == 1
    yc, yv = _conditions()
    np.testing.assert_array_equal(fn(yc, yv, SEED).numpy(), svc.sample(yc, yv, seed=SEED))


def test_export_on_a_mesh_raises(params, tmp_path):
    """Inside a mesh's dispatch scope, and of a service on a mesh: the
    artefact is the one-device dispatch, and a mesh is never dropped."""
    svc = ScoreModelService(CFG, params, device="cpu", steps=2, buckets=(B,))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(1, "cpu")
        with spatial.dispatch_scope(mesh), pytest.raises(ValueError, match="mesh"):
            tex.export_service(svc, B)
        meshed = ScoreModelService(CFG, params, device="cpu", steps=2, buckets=(B,), mesh=mesh)
        with pytest.raises(ValueError, match="mesh"):
            tex.export_service(meshed, B)
    finally:
        dist.destroy_process_group()
    assert spatial.current() is None
