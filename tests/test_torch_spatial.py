"""The space axis of the port (toycrystals_torch/parallel/spatial.py and the
ops that read it) against the JAX package's GSPMD spatial partitioning on
`make_mesh_2d(2, 2)` of the 8-virtual-device CPU (tests/conftest.py), and
against the port's own one-process runs, on the CPU.

- One 4-rank gloo job (`parallel.multihost.launch` of
  `parallel.parity.run_cases` on a (data 2, space 2) mesh, one torch thread
  per rank) runs, at base_ch 8 and 16x16: the forward (stem none, s2dr and
  the int8 convs), 3 SDE, ODE, DPM, DDIM and rf steps and 2 inpainting steps
  (resample 2) on injected draws, a 6-image `ScoreModelService(mesh=)`
  dispatch, and the halo exchange alone.
- Against JAX on make_mesh_2d(2, 2) with the same draws (all but DDIM and rf):
  tests/test_spatial.py's own tolerance (rtol 1e-2, atol 1e-3).
- Against the same cases in one process with no mesh: 1e-5 for an f32
  forward, 1e-4 after the sampler steps; the halo rows are torch.roll's
  (wrapped) and edge replication's (clamped) exactly.
- JAX's refusals (`check_spatial_divisibility`, too few devices), and the
  port's own for the s2d stems' H/8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.parallel import launch, spatial
from toycrystals_torch.parallel.mesh import make_mesh_2d
from toycrystals_torch.parallel.parity import run_cases
from toycrystals_torch.scripts._common import setup_mesh
from toycrystals_torch.utils.params import flax_from_torch_state_dict
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.parallel import data_sharding, replicate
from toycrystals_tpu.parallel import spatial as jspatial

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
SIZE, N, STEPS, CFG_SCALE = 16, 4, 3, 1.5
MESH = (2, 2)
RTOL, ATOL = 1e-2, 1e-3          # tests/test_spatial.py:80-83
FORWARD_TOL, STEPS_TOL = 1e-5, 1e-4
SERVE_CFG = dict(KW, cond_ch=8, time_ch=8, img_size=SIZE, beta_min=0.1, beta_max=30.0,
                 dtype="float32", param="eps")
FORWARDS = {"none": dict(stem="none"), "s2dr": dict(stem="s2dr"),
            "int8": dict(conv_impl="int8")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in-process, as each spawned rank runs (beside other
    pytest-xdist workers a pool of threads runs these small steps slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_dict(seed, **kw):
    model = flax_default_init(tm.CondUNetTiny(**KW, **kw), np.random.default_rng(seed))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_mesh_apply(param="eps", **kw):
    """make_mesh_2d(2, 2) and JAX's CondUNetTiny (as eps: a v model wrapped by
    `eps_apply_from_v`), whose inputs the callers place on the mesh: images by
    (data, space), conditions by data, params replicated.

    The samplers run a v model: an untrained eps model's few steps from noise
    clip nearly every pixel to 0 or 1, which would hold nothing to JAX, and
    one that predicts v = 0 keeps them in range."""
    mesh = jspatial.make_mesh_2d(*MESH)
    jmodel = jm.CondUNetTiny(**KW, **kw)
    apply = jax.jit(lambda p, x, t, c, v: jmodel.apply({"params": p}, x, t, c, v))
    return mesh, jm.eps_apply_from_v(jm.VPSDE(0.1, 30.0), apply) if param == "v" else apply


def _conds(n=N):
    yc, yv = jm.sample_grid_conditions(n, 4, 4)
    return np.array(yc), np.array(yv)


def _forward_case(name):
    kw = FORWARDS[name]
    sd = _state_dict(3, **kw)
    r = np.random.default_rng(5)
    x = r.normal(size=(N, SIZE, SIZE, 1)).astype(np.float32)
    t = r.uniform(0.05, 0.95, N).astype(np.float32)
    yc, yv = _conds()
    mesh, apply = _jax_mesh_apply(**kw)
    params = replicate(mesh, flax_from_torch_state_dict(sd))
    want = apply(params, jax.device_put(x, jspatial.image_sharding(mesh)),
                 jax.device_put(t, data_sharding(mesh, 1)),
                 jax.device_put(yc, data_sharding(mesh, 1)),
                 jax.device_put(yv, data_sharding(mesh, 2)))
    case = dict(kind="forward", model=dict(KW, **kw), state_dict=sd, x=x, t=t, y_cat=yc,
                y_cont=yv)
    return case, np.asarray(want)


def _sampler_case(name, sd):
    """JAX's sampler on the 2x2 mesh and the draws its key makes."""
    mesh, apply = _jax_mesh_apply("v")
    params = replicate(mesh, flax_from_torch_state_dict(sd))
    yc, yv = _conds()
    shape = (N, SIZE, SIZE, 1)
    key = jax.random.key({"sde": 21, "ode": 22, "dpm": 23}[name])
    fn = {"sde": jm.sample_reverse_sde_euler_maruyama, "ode": jm.sample_probability_flow_ode,
          "dpm": jm.sample_dpmpp_2m}[name]
    want = fn(apply, params, jm.VPSDE(0.1, 30.0), jax.device_put(yc, data_sharding(mesh, 1)),
              jax.device_put(yv, data_sharding(mesh, 2)), shape, key, n_steps=STEPS,
              guidance_scale=CFG_SCALE, n_types=4, sharding=jspatial.image_sharding(mesh))
    case = dict(kind="sample", sampler=name, param="v", model=KW, state_dict=sd, y_cat=yc,
                y_cont=yv, shape=shape, seed=0, chunk=N, n_steps=STEPS, cfg=CFG_SCALE,
                drawn=False)
    if name == "sde":
        k_init, k_noise = jax.random.split(key)
        case["x_init"] = np.array(jax.random.normal(k_init, shape, jnp.float32))
        case["z"] = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k_noise, i),
                                                           shape, jnp.float32))
                              for i in range(STEPS)], axis=1)
    else:
        case["x_init"] = np.array(jax.random.normal(key, shape, jnp.float32))
    return case, np.asarray(want)


def _inpaint_case(sd, n_steps=2, resample=2):
    mesh, apply = _jax_mesh_apply("v")
    params = replicate(mesh, flax_from_torch_state_dict(sd))
    yc, yv = _conds()
    shape = (N, SIZE, SIZE, 1)
    r = np.random.default_rng(7)
    x_known = r.uniform(-0.1, 1.1, size=shape).astype(np.float32)
    mask = np.ones(shape, np.float32)
    mask[:, 4:12, 3:11] = 0.0
    mask[1, :, :3] = 0.0
    key = jax.random.key(24)
    img = jspatial.image_sharding(mesh)
    want = jm.sample_inpaint_reverse_sde(
        apply, params, jm.VPSDE(0.1, 30.0), jax.device_put(yc, data_sharding(mesh, 1)),
        jax.device_put(yv, data_sharding(mesh, 2)), shape, key, n_steps, CFG_SCALE, 1e-3, 4,
        resample, x_known=jax.device_put(x_known, img), mask=jax.device_put(mask, img),
        sharding=img)
    k_init, k_noise = jax.random.split(key)
    draws = np.zeros((N, n_steps, resample, 3, SIZE, SIZE, 1), np.float32)
    for i in range(n_steps):
        for j in range(resample):
            kr = jax.random.fold_in(jax.random.fold_in(k_noise, i), j)
            for k in range(3):
                draws[:, i, j, k] = np.asarray(jax.random.normal(jax.random.fold_in(kr, k),
                                                                 shape, jnp.float32))
    case = dict(kind="inpaint", param="v", model=KW, state_dict=sd, y_cat=yc, y_cont=yv,
                shape=shape, n_steps=n_steps, resample=resample, cfg=CFG_SCALE,
                x_init=np.array(jax.random.normal(k_init, shape, jnp.float32)), draws=draws,
                x_known=x_known, mask=mask)
    return case, np.asarray(want)


def _service_case(sd):
    yc, yv = _conds(6)
    params = flax_from_torch_state_dict(sd)
    return dict(kind="service", config=SERVE_CFG, params=params, buckets=(1, 3, 8),
                settings=dict(steps=STEPS), requests=[(yc, yv, 9)])


@pytest.fixture(scope="module")
def suite():
    sd = _state_dict(11)
    cases, jax_out = {}, {}
    for name in FORWARDS:
        cases[f"forward_{name}"], jax_out[f"forward_{name}"] = _forward_case(name)
    for name in ("sde", "ode", "dpm"):
        cases[name], jax_out[name] = _sampler_case(name, sd)
    cases["inpaint"], jax_out["inpaint"] = _inpaint_case(sd)
    for name, param in (("ddim", "v"), ("rf", "eps")):  # held to one process only
        x_init = np.random.default_rng(25).normal(size=(N, SIZE, SIZE, 1)).astype(np.float32)
        cases[name] = dict(cases["ode"], sampler=name, param=param, x_init=x_init)
    cases["service"] = _service_case(sd)
    x = np.random.default_rng(8).normal(size=(N, 3, SIZE, 5)).astype(np.float32)
    cases["halo"] = dict(kind="halo", x=x)
    return {"cases": cases, "jax": jax_out}


@pytest.fixture(scope="module")
def four_ranks(suite):
    """Every case in one 4-rank gloo job on a (data 2, space 2) mesh."""
    names = list(suite["cases"])
    out = launch(run_cases, 4, ({"device": "cpu", "mesh": list(MESH),
                                 "cases": list(suite["cases"].values())},), timeout=300)
    return [dict(zip(names, rank)) for rank in out]


@pytest.fixture(scope="module")
def one_process(suite):
    cases = {k: v for k, v in suite["cases"].items() if k not in ("halo", "service")}
    return dict(zip(cases, run_cases({"device": "cpu", "cases": list(cases.values())})))


def _out(res):
    return res.get("out", res.get("injected"))


@pytest.mark.parametrize("name", [*(f"forward_{k}" for k in FORWARDS), "sde", "ode", "dpm",
                                  "inpaint"])
def test_2x2_mesh_matches_jax_on_its_2x2_mesh(suite, four_ranks, name):
    got = _out(four_ranks[0][name])
    want = suite["jax"][name]
    assert got.shape == want.shape and np.isfinite(got).all()
    if not name.startswith("forward"):
        assert float(((want > 0.01) & (want < 0.99)).mean()) > 0.05  # not all clipped
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", [*(f"forward_{k}" for k in FORWARDS), "sde", "ode", "dpm",
                                  "ddim", "rf", "inpaint"])
def test_2x2_mesh_matches_one_process(four_ranks, one_process, name):
    tol = FORWARD_TOL if name.startswith("forward") else STEPS_TOL
    np.testing.assert_allclose(_out(four_ranks[0][name]), _out(one_process[name]), rtol=0,
                               atol=tol)


def test_every_rank_returns_the_whole_result(four_ranks):
    for name, res in four_ranks[0].items():
        if name == "halo":
            continue
        for k, v in res.items():
            if k not in ("launches", "seconds", "peak_bytes"):
                for other in four_ranks[1:]:
                    np.testing.assert_array_equal(other[name][k], v, err_msg=f"{name} {k}")


def test_inpainting_keeps_the_known_region(suite, four_ranks):
    got, case = four_ranks[0]["inpaint"]["injected"], suite["cases"]["inpaint"]
    keep = case["mask"] == 1.0
    np.testing.assert_array_equal(got[keep], np.clip(case["x_known"], 0.0, 1.0)[keep])


def test_service_on_the_mesh_is_the_one_process_dispatch(suite, four_ranks):
    """6 images: buckets (1, 3, 8) round up to the data axis (2, 4, 8); the
    request runs through sample_chunked at its bucket, and matches the
    one-process service's dispatch of the same rows and seed."""
    from toycrystals_torch.serve import ScoreModelService

    case = suite["cases"]["service"]
    (y_cat, y_cont, seed), = case["requests"]
    got = four_ranks[0]["service"]
    assert got["buckets"] == [2, 4, 8]
    svc = ScoreModelService(case["config"], case["params"], device="cpu", buckets=(8,),
                            **case["settings"])
    with torch.inference_mode():
        want = tm.sample_chunked(svc._dispatch, svc._apply_fn, svc.sde,
                                 torch.from_numpy(y_cat), torch.from_numpy(y_cont),
                                 (6, SIZE, SIZE, 1), seed, chunk=8)
    assert got["x"][0].shape == (6, SIZE, SIZE, 1)
    np.testing.assert_allclose(got["x"][0], want, rtol=0, atol=STEPS_TOL)


@pytest.mark.parametrize("rank", range(4))
def test_halo_rows_are_rolls_and_edge_copies(suite, four_ranks, rank):
    x = torch.from_numpy(suite["cases"]["halo"]["x"])
    d, s = divmod(rank, MESH[1])
    b, h = N // MESH[0], SIZE // MESH[1]
    rows, hs = slice(d * b, (d + 1) * b), slice(s * h, (s + 1) * h)
    got = four_ranks[rank]["halo"]
    wrap = torch.cat([torch.roll(x, 1, dims=2)[:, :, hs.start:hs.start + 1], x[:, :, hs],
                      torch.roll(x, -1, dims=2)[:, :, hs.stop - 1:hs.stop]], dim=2)[rows]
    clamp = F.pad(x, (0, 0, 1, 1), mode="replicate")[rows][:, :, hs.start:hs.stop + 2]
    np.testing.assert_array_equal(got["wrap"], wrap.numpy())
    np.testing.assert_array_equal(got["clamp"], clamp.numpy())


@pytest.mark.parametrize("img_size, n_space", [(64, 8), (16, 8), (16, 3), (256, 2), (16, 4)])
def test_spatial_divisibility_refuses_as_jax_does(img_size, n_space):
    try:
        jspatial.check_spatial_divisibility(img_size, n_space)
    except ValueError as e:
        with pytest.raises(ValueError) as port:
            spatial.check_spatial_divisibility(img_size, n_space)
        assert str(port.value) == str(e)
    else:
        spatial.check_spatial_divisibility(img_size, n_space)


@pytest.mark.parametrize("stem, img_size, n_space, ok", [
    ("none", 16, 4, True), ("s2dr", 16, 2, True), ("s2dr", 16, 4, False),
    ("s2d", 64, 16, False), ("s2d", 64, 8, True), ("s2dr", 16, 3, False)])
def test_the_s2d_stems_refuse_uneven_bottleneck_shards(stem, img_size, n_space, ok):
    """GSPMD pads a height that does not split; the port refuses it (the s2d
    stems reach H/8), naming the difference (ROADMAP.md section 3)."""
    if ok:
        spatial.check_stem_divisibility(img_size, n_space, stem)
        return
    with pytest.raises(ValueError, match="H/4|GSPMD pads"):
        spatial.check_stem_divisibility(img_size, n_space, stem)


def test_too_few_devices_refuse_as_jax_does():
    from scripts._common import setup_mesh as jax_setup_mesh

    msg = r"--shard 2 x --shard-space 8 needs 16 devices, have \d+"
    with pytest.raises(SystemExit, match=msg):
        jax_setup_mesh(2, shard_space=8)
    with pytest.raises(SystemExit, match=msg):
        setup_mesh(2, device=torch.device("cpu"), shard_space=8)
    with pytest.raises(ValueError, match="asked for 16 devices, have"):
        jspatial.make_mesh_2d(4, 4)
    with pytest.raises(ValueError, match="asked for 16 devices, have"):
        make_mesh_2d(4, 4, device_type="cpu")
