"""The port's MoE latent prior (toycrystals_torch/models/moe_prior.py), its
aux-weighted train step and scripts/moe_route_stats.py against the JAX package
on the CPU, at a small size: width 32, 2 blocks, E 4, z 8, T 50, batches of 8.

Tolerances: the forward on bridged weights atol 1e-5 x max|out|, each
block's moe_aux 1e-6 relative and route_fraction exact (against flax's sown
`losses` / `intermediates`); the aux-weighted step as tests/test_torch_prior.py
holds the dense one (router gradients included); init statistics: each leaf's
std within 6 / sqrt(2 n) relative of flax's `prior.init` (n entries; zero and
one leaves exact); route stats: the router logits at the swept conditions
within 1e-5, then the JSON line equal to the JAX script's.
"""

import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_prior import FILM_KW, _close, _init, _inputs, _load, check_step_against_jax

from toycrystals_torch.models import moe_prior as tm_
from toycrystals_torch.models.sde_score_model import sample_grid_conditions
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.scripts import moe_route_stats
from toycrystals_torch.utils.params import flax_prior_from_torch_state_dict
from toycrystals_tpu.models import moe_prior as jm_
from toycrystals_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint

MOE_KW = dict(FILM_KW, n_blocks=2, n_experts=4)
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def test_forward_and_stats_match_flax_collections():
    jm, tm = jm_.DiffusionPriorMoE(**MOE_KW), tm_.DiffusionPriorMoE(**MOE_KW)
    params = _init(jm, 20)
    _load(tm, params)
    z, t, yc, yv = _inputs(21)
    want, cols = jm.apply({"params": params}, z, t, yc, yv,
                          mutable=["losses", "intermediates"])
    got, stats = tm(*map(torch.from_numpy, (z, t, yc, yv)), return_stats=True)
    _close(got.detach().numpy(), want)
    assert len(stats["moe_aux"]) == len(stats["route_fraction"]) == MOE_KW["n_blocks"]
    for i in range(MOE_KW["n_blocks"]):
        (aux,) = cols["losses"][f"block_{i}"]["moe_aux"]
        (frac,) = cols["intermediates"][f"block_{i}"]["route_fraction"]
        np.testing.assert_allclose(float(stats["moe_aux"][i]), float(aux), rtol=1e-6)
        np.testing.assert_array_equal(stats["route_fraction"][i].numpy(), np.asarray(frac))
    # without return_stats: the eps alone, and no state kept between calls
    again = tm(*map(torch.from_numpy, (z, t, yc, yv)))
    assert torch.equal(again, got)


def test_aux_weighted_step_matches_jax_grad():
    check_step_against_jax(jm_.DiffusionPriorMoE(**MOE_KW), tm_.DiffusionPriorMoE(**MOE_KW),
                           0.5, 22)


def test_init_statistics_match_flax_per_leaf():
    _check_init_statistics(np.random.default_rng(24))


def test_init_statistics_match_flax_per_leaf_from_a_torch_generator():
    _check_init_statistics(torch.Generator().manual_seed(24))


def _check_init_statistics(rng):
    kw = dict(MOE_KW, width=128, n_blocks=1)
    want = jax.tree.map(np.asarray, _init(jm_.DiffusionPriorMoE(**kw), 23))
    got = flax_prior_from_torch_state_dict(
        flax_default_init(tm_.DiffusionPriorMoE(**kw), rng).state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree.leaves(got))
    for path, w in leaves:
        g = got
        for k in path:
            g = g[k.key]
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        if np.all(w == w.flat[0]):  # zeros and ones
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert abs(g.std() / w.std() - 1.0) < 6.0 / np.sqrt(2 * w.size), (name, g.std(),
                                                                            w.std())


def test_route_stats_json_equals_the_jax_script(tmp_path, monkeypatch, capsys):
    jm, tm = jm_.DiffusionPriorMoE(**MOE_KW), tm_.DiffusionPriorMoE(**MOE_KW)
    params = _init(jm, 25)
    _load(tm, params)
    t_max, t_points = 50, 8
    ckpt = str(tmp_path / "moe.msgpack")
    config = {"z_dim": MOE_KW["z_dim"], "n_types": 4, "y_cont_dim": 4,
              "t_emb_dim": MOE_KW["t_emb_dim"], "width": MOE_KW["width"],
              "n_blocks": MOE_KW["n_blocks"], "y_cat_emb_dim": MOE_KW["y_cat_emb_dim"],
              "T": t_max, "beta_start": 1e-4, "beta_end": 1.0, "n_experts": 4}
    j_save_checkpoint(ckpt, {"params": params, "config": config})

    # the swept conditions and the router logits agree before argmax decides
    y_cat, y_cont = sample_grid_conditions(36, 4, 4)
    ts = np.repeat(np.linspace(0, t_max - 1, t_points).astype(np.float32).astype(np.int32), 36)
    np.testing.assert_array_equal(
        ts, np.repeat(np.asarray(jnp.linspace(0, t_max - 1, t_points).astype(jnp.int32)), 36))
    yc, yv = y_cat.repeat(t_points), y_cont.repeat(t_points, 1)
    with torch.no_grad():
        cond = tm.cond(torch.from_numpy(ts), yc, yv)
        got_logits = [b.router(cond) for b in tm.blocks]
    jcond = _flax_cond(params, jnp.asarray(ts), yc.numpy(), yv.numpy())
    for i, g in enumerate(got_logits):
        r = params[f"block_{i}"]["router"]
        _close(g.numpy(), jcond @ r["kernel"] + r["bias"])

    got = moe_route_stats.route_stats(["--device", "cpu", "--ckpt", ckpt,
                                       "--t-points", str(t_points)])
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["moe_route_stats.py", "--device", "cpu", "--ckpt", ckpt,
                                      "--t-points", str(t_points), "--json-out", str(out)])
    try:
        runpy.run_path(str(SCRIPTS / "moe_route_stats.py"), run_name="__main__")
    except SystemExit as e:
        assert (e.code or 0) == 0
    want = json.loads(out.read_text())
    assert got == want
    assert capsys.readouterr().out.strip().splitlines()[-1] == json.dumps(want)
    for blk in got["blocks"].values():
        assert abs(sum(blk["fractions"]) - 1.0) < 1e-3


def _flax_cond(p, t, y_cat, y_cont):
    """The flax prior's FiLM cond vector (DiffusionPriorMoE.__call__ up to
    `cond`) from its param tree."""
    import flax.linen as nn

    from toycrystals_tpu.models.diffusion_prior import timestep_embedding_discrete

    def dense(name, x):
        return x @ p[name]["kernel"] + p[name]["bias"]

    t_feat = dense("Dense_1", nn.silu(dense("Dense_0", timestep_embedding_discrete(
        t, MOE_KW["t_emb_dim"]))))
    y_cont_feat = dense("Dense_3", nn.silu(dense("Dense_2", y_cont)))
    y_feat = jnp.concatenate([p["Embed_0"]["embedding"][y_cat], y_cont_feat], axis=-1)
    y_feat = dense("Dense_5", nn.silu(dense("Dense_4", y_feat)))
    return jnp.concatenate([t_feat, y_feat], axis=-1)
