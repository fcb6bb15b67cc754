"""The port's CondVAE, kl_stats and VAE train step (toycrystals_torch/models/vae.py,
train/steps.py) against the JAX package on the CPU, and the VAE weight
bridges (utils/params.py, utils/torch_interop.py).

64x64 images (the VAE's fixed 4x4 bottleneck), batch 4, z_dim 8. The draws
are injected on both sides: the port takes eps and the cond-drop mask as
arguments, the JAX side runs its own `make_vae_train_step` on a CondVAE whose
reparameterisation and mask read the same arrays. Tolerances: forward f32
atol 1e-5; kl_stats 1e-6 relative; one train step's loss and metrics 1e-5
relative, the updated parameter tree 1e-5 relative in L2 and each entry
within 2e-6 (a thousandth of the lr); weight bridges exact; the
reference-layout forward atol 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from toycrystals_torch.data.lattice import LatticeConfig
from toycrystals_torch.models import vae as tv
from toycrystals_torch.train.state import Optimizer, create_train_state
from toycrystals_torch.train.steps import make_vae_train_epoch, make_vae_train_step
from toycrystals_torch.utils import params as tp
from toycrystals_torch.utils import torch_interop as pti
from toycrystals_tpu.models import vae as jv
from toycrystals_tpu.train import create_train_state as jax_create_train_state
from toycrystals_tpu.train.steps import make_vae_train_step as jax_make_vae_train_step
from toycrystals_tpu.utils import torch_interop as jti

Z, B = 8, 4


def _inputs(seed=0, b=B):
    r = np.random.default_rng(seed)
    x = r.uniform(size=(b, 64, 64, 1)).astype(np.float32)
    y_cat = (np.arange(b) % 4).astype(np.int32)
    y_cont = r.normal(size=(b, 4)).astype(np.float32)
    eps = r.normal(size=(b, Z)).astype(np.float32)
    keep = np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)[:b]
    return x, y_cat, y_cont, eps, keep


def _jax_params(model, cond: bool, seed=1):
    k = jax.random.key(seed)
    args = (jnp.zeros((2, 64, 64, 1)),) + (
        (jnp.zeros((2,), jnp.int32), jnp.zeros((2, 4))) if cond else ())
    return jax.tree.map(np.asarray, model.init({"params": k, "reparam": k}, *args)["params"])


def _port(model, params):
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           tp.torch_state_dict_from_flax_vae(params).items()}, strict=True)
    return model


def _injected(cls, eps, keep):
    """A JAX VAE class whose draws are `eps` and the mask `keep`."""

    class Injected(cls):
        def reparameterise(self, mu, logvar):
            return mu + jnp.exp(0.5 * logvar) * eps

        if cls is jv.CondVAE:
            def decode(self, z, y_cat, y_cont, train: bool = False):
                y = jv._y_vec(y_cat, y_cont, self.n_types)
                if train and self.cond_drop > 0.0:
                    y = y * keep
                return self.decoder(z, y)

    return Injected


def test_cond_vae_matches_flax_with_injected_draws():
    x, y_cat, y_cont, eps, keep = _inputs()
    jm = jv.CondVAE(z_dim=Z, cond_drop=0.5)
    params = _jax_params(jm, cond=True)
    tm = _port(tv.CondVAE(z_dim=Z, cond_drop=0.5), params)
    # flax -> torch -> flax is the identity, leaf for leaf
    back = tp.flax_vae_from_torch_state_dict(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)

    jx, jyc, jyv = jnp.asarray(x), jnp.asarray(y_cat), jnp.asarray(y_cont)
    mu, logvar = jm.apply({"params": params}, jx, jyc, jyv, method="encode")
    dec = jm.apply({"params": params}, jnp.asarray(eps), jyc, jyv, method="decode")
    ji = _injected(jv.CondVAE, jnp.asarray(eps), jnp.asarray(keep))(z_dim=Z, cond_drop=0.5)
    want_train = ji.apply({"params": params}, jx, jyc, jyv, train=True)
    want_eval = ji.apply({"params": params}, jx, jyc, jyv, train=False)
    tx, tyc, tyv = torch.tensor(x), torch.tensor(y_cat), torch.tensor(y_cont)
    with torch.no_grad():
        tmu, tlv = tm.encode(tx, tyc, tyv)
        tdec = tm.decode(torch.tensor(eps), tyc, tyv)
        got_train = tm(tx, tyc, tyv, train=True, noise=torch.tensor(eps),
                       keep=torch.tensor(keep))
        got_eval = tm(tx, tyc, tyv, noise=torch.tensor(eps))
    for got, want in ((tmu, mu), (tlv, logvar), (tdec, dec), *zip(got_train, want_train),
                      *zip(got_eval, want_eval)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # the mask changes the training decode; eval ignores it
    assert np.abs(got_train[0].numpy() - got_eval[0].numpy()).max() > 1e-4


def test_cond_vae_draws_eps_then_the_mask_from_its_generator():
    x, y_cat, y_cont, _, _ = _inputs()
    tm = tv.CondVAE(z_dim=Z, cond_drop=0.5)
    args = (torch.tensor(x), torch.tensor(y_cat), torch.tensor(y_cont))
    with torch.no_grad():
        got = tm(*args, train=True, generator=torch.Generator().manual_seed(4))
        gen = torch.Generator().manual_seed(4)
        eps = torch.randn((B, Z), generator=gen)
        keep = torch.rand((B, 1), generator=gen) >= 0.5
        want = tm(*args, train=True, noise=eps, keep=keep)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("free_bits", [0.0, 0.05, 2.0])
def test_kl_stats_matches_jax(free_bits):
    r = np.random.default_rng(2)
    mu = r.normal(size=(6, Z)).astype(np.float32)
    logvar = r.normal(size=(6, Z)).astype(np.float32)
    want = jv.kl_stats(jnp.asarray(mu), jnp.asarray(logvar), free_bits)
    got = tv.kl_stats(torch.tensor(mu), torch.tensor(logvar), free_bits)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    if free_bits == 0.0:
        assert got[0] is got[1]
    else:
        assert float(got[0]) > float(got[1]) or free_bits < 0.1


@pytest.mark.parametrize("uncond", [False, True])
def test_vae_train_step_matches_jax(uncond):
    """One step at lr 2e-3, beta_eff 3e-4 * 2/5, free bits 0.05, cond_drop
    0.5 with an injected mask: loss, metrics and the parameters after Adam."""
    x, y_cat, y_cont, eps, keep = _inputs(3)
    beta_eff, free_bits = 3e-4 * 2 / 5, 0.05
    jcls = jv.VAE if uncond else jv.CondVAE
    jkw = {} if uncond else {"cond_drop": 0.5}
    params = _jax_params(jcls(z_dim=Z, **jkw), cond=not uncond)
    jmodel = _injected(jcls, jnp.asarray(eps), jnp.asarray(keep))(z_dim=Z, **jkw)
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, params), optax.adam(2e-3))
    jstep = jax_make_vae_train_step(jmodel, optax.adam(2e-3), free_bits, uncond=uncond)
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y_cat), jnp.asarray(y_cont),
                       jnp.float32(beta_eff), jax.random.key(0))

    tmodel = _port(tv.VAE(Z) if uncond else tv.CondVAE(z_dim=Z, cond_drop=0.5), params)
    tx = Optimizer(2e-3)
    state = create_train_state(tmodel, tx)
    step = make_vae_train_step(tmodel, tx, free_bits, uncond=uncond)
    state, m = step(state, torch.tensor(x), torch.tensor(y_cat), torch.tensor(y_cont),
                    beta_eff, noise=(torch.tensor(eps), torch.tensor(keep)))
    assert set(m) == set(jm) == {"loss", "recon", "kl", "kl_raw"} and state.step == 1
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    got = tp.flax_vae_from_torch_state_dict(state.params)
    want = jax.tree.map(np.asarray, jstate.params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    # the tree within 1e-5 relative in L2, and no entry off by more than a
    # thousandth of the first Adam step (lr): lr * g / (|g| + 1e-8) magnifies
    # the last bits of gradients near 1e-8, which the two conv stacks round apart
    diff = np.sqrt(sum(float(np.sum((a - b) ** 2))
                       for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want))))
    norm = np.sqrt(sum(float(np.sum(b ** 2)) for b in jax.tree.leaves(want)))
    assert diff <= 1e-5 * norm, (diff, norm)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 * 1e-3)
    # the moments went through the VAE bridge too
    ck = tp.train_state_to_checkpoint(state, tx, bridge=tp.VAE)
    for a, b in zip(jax.tree.leaves(ck["opt_state"]["0"]["mu"]),
                    jax.tree.leaves(jstate.opt_state[0].mu)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1e-5 * float(np.abs(np.asarray(b)).max()) + 1e-12)


def test_vae_step_needs_a_generator_or_draws():
    tmodel = tv.CondVAE(z_dim=Z)
    tx = Optimizer(1e-3)
    x, y_cat, y_cont, _, _ = _inputs()
    with pytest.raises(ValueError, match="Generator"):
        make_vae_train_step(tmodel, tx, 0.05)(create_train_state(tmodel, tx), torch.tensor(x),
                                              torch.tensor(y_cat), torch.tensor(y_cont), 1e-4)


def test_vae_epoch_is_the_shuffle_then_the_steps():
    """make_vae_train_epoch on rendered rot-only data equals the shuffle and
    the steps run by hand on the same generator, and its metrics are the
    steps' means."""
    from toycrystals_torch.data.datasets import generate_batch

    cfg = LatticeConfig(img_size=64, n_types=4, rot_only=True)

    def fresh():
        m = tv.CondVAE(z_dim=Z, cond_drop=0.25)
        torch.manual_seed(0)
        for p in m.parameters():
            torch.nn.init.normal_(p, std=0.02)
        tx = Optimizer(1e-3)
        return m, tx, create_train_state(m, tx)

    m1, tx1, s1 = fresh()
    epoch = make_vae_train_epoch(m1, tx1, 0.05, batch_size=4, n_items=10, lattice_cfg=cfg,
                                 dataset_seed=3)
    s1, metrics = epoch(s1, 1e-4, torch.Generator().manual_seed(9))
    assert s1.step == 2 and set(metrics) == {"loss", "recon", "kl", "kl_raw"}

    m2, tx2, s2 = fresh()
    step = make_vae_train_step(m2, tx2, 0.05)
    gen = torch.Generator().manual_seed(9)
    order = torch.randperm(10, generator=gen)[:8].reshape(2, 4)
    ms = []
    for idx in order:
        x, yc, yv = generate_batch(cfg, 3, idx, device="cpu")
        s2, m = step(s2, x, yc, yv, 1e-4, gen)
        ms.append(m)
    for k in metrics:
        torch.testing.assert_close(metrics[k], torch.stack([m[k] for m in ms]).mean(),
                                   rtol=0, atol=0)
    for (k, a), b in zip(s1.params.items(), s2.params.values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    with pytest.raises(NotImplementedError, match="JAX's CLIs offer no such mesh"):  # 3-D
        make_vae_train_epoch(m1, tx1, 0.05, 4, 10, lattice_cfg=cfg,
                             mesh=types.SimpleNamespace(mesh_dim_names=("data", "space",
                                                                        "model")))


def _reference_state_dict(z_dim, y_dim, seed=0):
    """A random state_dict in the reference CondVAE's layout."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return (rng.normal(size=shape) * 0.05).astype(np.float32)

    sd = {}
    for i, (ci, co) in zip((0, 2, 4, 6), [(1, 32), (32, 64), (64, 128), (128, 256)]):
        sd[f"enc.{i}.weight"], sd[f"enc.{i}.bias"] = t(co, ci, 4, 4), t(co)
    sd["enc_fc.weight"], sd["enc_fc.bias"] = t(256, 4096 + y_dim), t(256)
    sd["mu.weight"], sd["mu.bias"] = t(z_dim, 256), t(z_dim)
    sd["logvar.weight"], sd["logvar.bias"] = t(z_dim, 256), t(z_dim)
    sd["dec_fc.weight"], sd["dec_fc.bias"] = t(4096, z_dim + y_dim), t(4096)
    for i, (ci, co) in zip((0, 2, 4, 6), [(256, 128), (128, 64), (64, 32), (32, 1)]):
        sd[f"dec.{i}.weight"], sd[f"dec.{i}.bias"] = t(ci, co, 4, 4), t(co)
    return sd


@pytest.mark.parametrize("cond", [True, False])
def test_reference_pt_bridge_round_trip(cond, tmp_path):
    """A reference-layout .pt: the port's converter equals JAX's leaf for
    leaf, loads into the port's module (through the flax tree) and gives the
    reference's functional forward; flax -> torch -> flax is the identity."""
    y_dim = 8 if cond else 0
    sd = _reference_state_dict(Z, y_dim)
    got = pti.flax_vae_params_from_torch_state_dict(sd)
    want = jti.flax_vae_params_from_torch_state_dict(sd)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    pt = tmp_path / "vae_last.pt"
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, pt)
    loaded = pti.load_torch_vae_checkpoint(str(pt))["params"]
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)

    model = _port(tv.CondVAE(z_dim=Z, cond_drop=0.0) if cond else tv.VAE(Z), got)
    back = tp.flax_vae_from_torch_state_dict(model.state_dict())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)

    x, y_cat, y_cont, eps, _ = _inputs(5, b=3)
    T = torch.tensor
    y = torch.cat([F.one_hot(T(y_cat).long(), 4).float(), T(y_cont)], dim=1)
    h = T(x).permute(0, 3, 1, 2)
    for i in (0, 2, 4, 6):
        h = F.relu(F.conv2d(h, T(sd[f"enc.{i}.weight"]), T(sd[f"enc.{i}.bias"]), stride=2,
                            padding=1))
    h = h.flatten(1)  # the reference's channel-major flatten
    h = F.relu(F.linear(torch.cat([h, y], 1) if cond else h, T(sd["enc_fc.weight"]),
                        T(sd["enc_fc.bias"])))
    mu_ref = F.linear(h, T(sd["mu.weight"]), T(sd["mu.bias"]))
    d = F.linear(torch.cat([T(eps), y], 1) if cond else T(eps), T(sd["dec_fc.weight"]),
                 T(sd["dec_fc.bias"])).view(-1, 256, 4, 4)
    for i in (0, 2, 4, 6):
        d = F.conv_transpose2d(d, T(sd[f"dec.{i}.weight"]), T(sd[f"dec.{i}.bias"]), stride=2,
                               padding=1)
        d = torch.sigmoid(d) if i == 6 else F.relu(d)
    with torch.no_grad():
        args = (T(x), T(y_cat), T(y_cont)) if cond else (T(x),)
        mu = model.encode(*args)[0]
        dec = model.decode(T(eps), T(y_cat), T(y_cont)) if cond else model.decode(T(eps))
    torch.testing.assert_close(mu, mu_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(dec, d.permute(0, 2, 3, 1), rtol=0, atol=1e-5)

    torch.save({"model": {"in_proj.weight": torch.zeros(1)}}, tmp_path / "prior.pt")
    with pytest.raises(ValueError, match="not a reference VAE"):
        pti.load_torch_vae_checkpoint(str(tmp_path / "prior.pt"))
