"""The port's ScoreModelService (toycrystals_torch/serve.py) on the CPU:
settings resolution, bucket pad and trim, chunked requests beyond the top
bucket, the dpm sampler, describe() and warmup(), the uint8 output, the seed
range, int8 serving, and the parts not ported yet raising NotImplementedError
(the batcher and the HTTP front end: tests/test_torch_http.py).
"""

import types

import numpy as np
import pytest
import torch

from toycrystals_torch import serve
from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.ops.conv import Conv2d
from toycrystals_torch.utils.params import flax_from_torch_state_dict, load_flax_params

CFG = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16, cond_ch=8, time_ch=8,
           img_size=16, stem="s2dr")


def _params(seed, stem="s2dr"):
    rng = np.random.default_rng(seed)
    model = tm.CondUNetTiny(4, 4, base_ch=8, emb_dim=16, stem=stem)
    sd = {k: (rng.normal(size=tuple(v.shape)) * 0.1).astype(np.float32)
          for k, v in model.state_dict().items()}
    return flax_from_torch_state_dict(sd)


@pytest.fixture(scope="module")
def params():
    return _params(0)


def _svc(params, **kw):
    kw.setdefault("steps", 2)
    return serve.ScoreModelService(CFG, params, device="cpu", **kw)


def test_reference_defaults_resolve(params):
    s = serve.ScoreModelService(CFG, params, device="cpu")
    assert (s.sampler_name, s.steps, s.guidance_scale, s.t_end) == ("sde", 300, 1.5, 0.005)
    assert s.sde.beta_max == 30.0 and s.model.dtype == torch.float32
    assert s.buckets == serve.DEFAULT_BUCKETS
    assert s.stats["device"] == "cpu"


def test_distilled_checkpoint_serves_ddim(params):
    cfg = dict(CFG, distilled=True, distill_steps=2, distill_t_end=0.01, param="v")
    s = serve.ScoreModelService(cfg, params, device="cpu")
    assert (s.sampler_name, s.steps, s.guidance_scale, s.t_end) == ("ddim", 2, 0.0, 0.01)
    assert s._extra_kw == {"prediction": "v"}
    x = s.sample_conditions([0, 1], seed=1)
    assert x.shape == (2, 16, 16, 1) and np.isfinite(x).all()


def test_v_param_wraps_model_to_eps(params):
    s = _svc(params)
    sv = serve.ScoreModelService(dict(CFG, param="v"), params, device="cpu", steps=2)
    assert s._apply_fn is s.model and sv._apply_fn is not sv.model
    x, t = torch.zeros(1, 16, 16, 1), torch.full((1,), 0.5)
    yc, yv = torch.zeros(1, dtype=torch.int32), torch.zeros(1, 4)
    with torch.no_grad():
        want = tm.eps_apply_from_v(sv.sde, sv.model)(x, t, yc, yv)
        torch.testing.assert_close(sv._apply_fn(x, t, yc, yv), want)


def test_use_ema_picks_the_ema_tree(params):
    ema = _params(1)
    a = _svc(params, ema_params=ema)
    b = _svc(params, ema_params=ema, use_ema=False)
    c = _svc(ema)
    torch.testing.assert_close(a.model.out.weight, c.model.out.weight)
    assert not torch.equal(a.model.out.weight, b.model.out.weight)


def test_bucket_pad_and_trim(params):
    s = _svc(params, buckets=(1, 4))
    y_cat, y_cont = s.conditions([0, 1, 2], [0.0, 0.3, 0.6])
    x3 = s.sample(y_cat, y_cont, seed=5)
    assert x3.shape == (3, 16, 16, 1) and x3.dtype == np.float32
    assert 0.0 <= x3.min() and x3.max() <= 1.0
    # the 3-row request ran in the 4-bucket with its last row repeated
    y4 = (np.concatenate([y_cat, y_cat[-1:]]), np.concatenate([y_cont, y_cont[-1:]]))
    x4 = s.sample(*y4, seed=5)
    np.testing.assert_array_equal(x3, x4[:3])
    assert s.stats["requests"] == 2 and s.stats["images"] == 7


def test_uint8_output_is_quantised_f32(params):
    f = _svc(params, buckets=(2,))
    u = _svc(params, buckets=(2,), out_dtype="uint8")
    xf = f.sample_conditions([1, 3], seed=2)
    xu = u.sample_conditions([1, 3], seed=2)
    assert xu.dtype == np.uint8
    np.testing.assert_array_equal(
        xu, np.clip(xf * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8))


def test_seed_and_condition_checks(params):
    s = _svc(params)
    for seed in (-1, 2**31):
        with pytest.raises(ValueError, match="seed"):
            s.sample_conditions([0], seed=seed)
    with pytest.raises(ValueError, match="out of range"):
        s.conditions([4])
    with pytest.raises(ValueError, match="broadcast"):
        s.conditions([0, 1], [0.1, 0.2, 0.3])
    y_cat, y_cont = s.conditions(2, [0.5, 0.7])
    assert y_cat.tolist() == [2, 2] and y_cont[:, 1].tolist() == pytest.approx([0.5, 0.7])


@pytest.mark.parametrize("case", ["mesh", "checkpoint"])
def test_unported_parts_raise(params, case, tmp_path):
    if case == "checkpoint":  # the port's own sharded directories are read; JAX's orbax not
        import jax.numpy as jnp

        from toycrystals_tpu.utils import ShardedCheckpointManager

        with ShardedCheckpointManager(tmp_path / "j.orbax") as mgr:
            mgr.save(1, {"w": jnp.zeros(2)}, {"epoch_next": 1})
    match = "JAX's CLIs offer no such mesh" if case == "mesh" else "ROADMAP"
    with pytest.raises(NotImplementedError, match=match):
        if case == "mesh":  # the data, space and model axes serve, and the 3-D mesh
            _svc(params, mesh=types.SimpleNamespace(mesh_dim_names=("data", "expert")))
        else:
            serve.load_score_payload(str(tmp_path / "j.orbax"))


def test_int8_service_builds_every_conv_int8_and_reports_it(params):
    s = _svc(params, quantize="int8")
    convs = [m for m in s.model.modules() if isinstance(m, Conv2d)]
    assert len(convs) == 17 and all(m.int8 for m in convs)  # conv1 of all 5 blocks too
    assert s.stats["quantize"] == "int8" and _svc(params).stats["quantize"] == "none"
    with pytest.raises(ValueError, match="quantize"):
        _svc(params, quantize="fp8")


@pytest.mark.parametrize("out_dtype", ["float32", "uint8"])
def test_int8_service_samples_with_the_int8_model(params, out_dtype):
    """The int8 service's request is the sampler on the int8 U-Net with the
    request's generator, and differs from the float service's."""
    s = _svc(params, quantize="int8", buckets=(2,), out_dtype=out_dtype)
    x = s.sample_conditions([0, 3], [0.1, 0.4], seed=3)
    assert x.shape == (2, 16, 16, 1) and x.dtype == np.dtype(out_dtype)
    model = tm.CondUNetTiny(4, 4, base_ch=8, emb_dim=16, stem="s2dr", conv_impl="int8")
    load_flax_params(model, params)
    y_cat, y_cont = s.conditions([0, 3], [0.1, 0.4])
    with torch.no_grad():
        want = tm.sample_reverse_sde_euler_maruyama(
            model.requires_grad_(False), s.sde, torch.from_numpy(y_cat),
            torch.from_numpy(y_cont), (2, 16, 16, 1), torch.Generator().manual_seed(3),
            n_steps=2, guidance_scale=1.5, t_end=0.005, n_types=4).numpy()
    if out_dtype == "uint8":
        want = np.clip(want * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    np.testing.assert_array_equal(x, want)
    xf = _svc(params, buckets=(2,), out_dtype=out_dtype).sample_conditions([0, 3], [0.1, 0.4],
                                                                           seed=3)
    assert not np.array_equal(x, xf)


@pytest.mark.parametrize("param", ["eps", "v"])
def test_dpm_sampler_serves(params, param):
    s = serve.ScoreModelService(dict(CFG, param=param, logsnr_shift=-2.77), params,
                                device="cpu", sampler="dpm", steps=3, buckets=(2,))
    assert s.sampler_name == "dpm" and s._sampler_fn is tm.sample_dpmpp_2m
    assert (s._apply_fn is s.model) == (param == "eps")
    x = s.sample_conditions([0, 3], [0.1, 0.4], seed=3)
    assert x.shape == (2, 16, 16, 1) and np.isfinite(x).all()
    assert 0.0 <= x.min() and x.max() <= 1.0
    np.testing.assert_array_equal(x, s.sample_conditions([0, 3], [0.1, 0.4], seed=3))
    # the service's call is the sampler's own, on the request's generator
    y_cat, y_cont = s.conditions([0, 3], [0.1, 0.4])
    with torch.no_grad():
        want = tm.sample_dpmpp_2m(s._apply_fn, s.sde, torch.from_numpy(y_cat),
                                  torch.from_numpy(y_cont), (2, 16, 16, 1),
                                  torch.Generator().manual_seed(3), n_steps=3,
                                  guidance_scale=1.5, t_end=0.005, n_types=4)
    np.testing.assert_array_equal(x, want.numpy())


@pytest.mark.parametrize("out_dtype", ["float32", "uint8"])
def test_request_beyond_top_bucket_runs_in_chunks(params, out_dtype):
    """3 images with buckets (1, 2): two dispatches of the 2-bucket, the
    second padded with its last row; each chunk has its own generator."""
    s = _svc(params, buckets=(1, 2), out_dtype=out_dtype)
    y_cat, y_cont = s.conditions([0, 1, 2], [0.0, 0.3, 0.6])
    x = s.sample(y_cat, y_cont, seed=5)
    assert x.shape == (3, 16, 16, 1) and x.dtype == np.dtype(out_dtype)
    st = s.stats
    assert (st["requests"], st["images"], st["dispatches"]) == (1, 3, 2)
    with torch.no_grad():
        want = tm.sample_chunked(s._sampler_fn, s._apply_fn, s.sde, torch.from_numpy(y_cat),
                                 torch.from_numpy(y_cont), (3, 16, 16, 1), 5, chunk=2,
                                 n_steps=2, guidance_scale=1.5, t_end=0.005, n_types=4,
                                 clip_x0=False)
    np.testing.assert_array_equal(x, want)
    np.testing.assert_array_equal(x, s.sample(y_cat, y_cont, seed=5))
    # a request that fits the top bucket still takes one dispatch
    s.sample(y_cat[:2], y_cont[:2], seed=5)
    assert s.stats["dispatches"] == 2 + 2 + 1


def test_buckets_are_kept_as_given(params):
    """Unlike the JAX service, no auto_chunk cap on the ladder: 300 steps at
    img_size 256 would cap JAX's buckets at 12."""
    s = serve.ScoreModelService(dict(CFG, img_size=256), params, device="cpu",
                                buckets=(4, 1, 64, 4))
    assert s.buckets == (1, 4, 64) and tm.auto_chunk(256, s.steps, s.sampler_name) == 12


def test_describe_has_the_jax_services_keys(params):
    from toycrystals_tpu.serve import ScoreModelService as JaxService

    cfg = dict(CFG, param="v", dtype="float32", distilled=False, beta_max=30.0)
    want = JaxService.describe(types.SimpleNamespace(config=cfg))
    got = serve.ScoreModelService(cfg, params, device="cpu").describe()
    assert got == want
    assert set(got) == {"n_types", "y_cont_dim", "base_ch", "emb_dim", "param", "dtype",
                        "img_size", "distilled"}


def test_warmup_runs_every_bucket(params):
    s = _svc(params, buckets=(1, 2, 3))
    seen = []
    inner = s._sampler_fn

    def spy(apply_fn, sde, y_cat, y_cont, shape, gen, **kw):
        seen.append(int(shape[0]))
        return inner(apply_fn, sde, y_cat, y_cont, shape, gen, **kw)

    s._sampler_fn = spy
    s.warmup()
    assert seen == [1, 2, 3]
    st = s.stats
    assert (st["requests"], st["images"], st["dispatches"]) == (3, 6, 3)


def test_flash_impl_serves_on_the_cpu_through_the_plain_version():
    """attn_impl="flash" at a 256-token bottleneck: the CPU runs the plain
    version and equals the matmul path bit for bit."""
    cfg = dict(CFG, stem="none", img_size=64)            # 16x16 = 256 tokens
    prm = _params(2, stem="none")
    a = serve.ScoreModelService(cfg, prm, device="cpu", steps=1, attn_impl="flash")
    b = serve.ScoreModelService(cfg, prm, device="cpu", steps=1, attn_impl="xla")
    np.testing.assert_array_equal(a.sample_conditions([1], seed=4),
                                  b.sample_conditions([1], seed=4))


def test_default_device_without_gpu_raises(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.ScoreModelService(CFG, params)
