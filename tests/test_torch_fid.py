"""The port's latent FID (toycrystals_torch/utils/fid.py) and unconditional
VAE (models/vae.py) against the JAX package on the CPU.

Tolerances: VAE encoder means, log-variances and decoder outputs within 1e-5
(f32 convs summed in another order); the weight bridge exactly;
frechet_distance and gaussian_stats within 1e-6 (both float64 numpy); the
committed reference file (assets/eval/feature_vae_z16_fid_ref.npz) against
the JAX functions recomputed here within 1e-6; FIDs on the same features
within 1e-4.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycrystals_torch.data.lattice import LatticeConfig
from toycrystals_torch.models.vae import VAE as TVAE
from toycrystals_torch.utils import fid as tfid
from toycrystals_torch.utils.checkpoint import save_checkpoint
from toycrystals_torch.utils.params import (
    flax_vae_from_torch_state_dict,
    torch_state_dict_from_flax_vae,
)
from toycrystals_tpu.data.datasets import generate_batch as jax_generate_batch
from toycrystals_tpu.data.lattice import LatticeConfig as JLatticeConfig
from toycrystals_tpu.models.vae import VAE as JVAE
from toycrystals_tpu.utils import fid as jfid

EXTRACTOR = "assets/eval/feature_vae_z16.msgpack"


@pytest.fixture(scope="module")
def extractors():
    """(JAX model, JAX params, port model) of the committed extractor."""
    jmodel, jparams, _ = jfid.load_feature_extractor(EXTRACTOR)
    tmodel, cfg = tfid.load_feature_extractor(EXTRACTOR, device="cpu")
    assert cfg["uncond"] and int(cfg["z_dim"]) == 16
    return jmodel, jparams, tmodel


def _port_vae(params, z_dim):
    m = TVAE(z_dim)
    m.load_state_dict({k: torch.tensor(v) for k, v in
                       torch_state_dict_from_flax_vae(params).items()}, strict=True)
    return m.eval()


@pytest.mark.parametrize("which", ["random_z4", "committed_extractor"])
def test_vae_encode_decode_and_weight_bridge_match_jax(which):
    jmodel = JVAE(z_dim=4 if which == "random_z4" else 16)
    if which == "random_z4":
        params = jax.tree.map(np.asarray, jmodel.init(
            {"params": jax.random.key(5), "reparam": jax.random.key(6)},
            jnp.zeros((1, 64, 64, 1)))["params"])
    else:
        from toycrystals_tpu.utils.checkpoint import load_checkpoint

        params = jax.tree.map(np.asarray, load_checkpoint(EXTRACTOR)["params"])
    tmodel = _port_vae(params, jmodel.z_dim)
    # flax -> torch -> flax is the identity, leaf for leaf
    back = flax_vae_from_torch_state_dict(tmodel.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)

    r = np.random.default_rng(7)
    x = r.uniform(size=(3, 64, 64, 1)).astype(np.float32)
    z = r.normal(size=(3, jmodel.z_dim)).astype(np.float32)
    eps = r.normal(size=(3, jmodel.z_dim)).astype(np.float32)
    mu, logvar = jmodel.apply({"params": params}, jnp.asarray(x), method="encode")
    dec = jmodel.apply({"params": params}, jnp.asarray(z), method="decode")
    with torch.no_grad():
        tmu, tlv = tmodel.encode(torch.tensor(x))
        tdec = tmodel.decode(torch.tensor(z))
        recon, fmu, _ = tmodel(torch.tensor(x), noise=torch.tensor(eps))
    for got, want in ((tmu, mu), (tlv, logvar), (tdec, dec)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want_recon = jmodel.apply({"params": params}, mu + jnp.exp(0.5 * logvar) * eps,
                              method="decode")
    np.testing.assert_allclose(recon.numpy(), np.asarray(want_recon), atol=1e-5, rtol=0)
    assert torch.equal(fmu, tmu)


def test_gaussian_stats_and_frechet_distance_match_jax():
    r = np.random.default_rng(0)
    a = r.normal(size=(200, 6))
    b = r.normal(loc=0.3, scale=1.4, size=(150, 6)) @ r.normal(size=(6, 6))
    ga, gb = tfid.gaussian_stats(a), tfid.gaussian_stats(b)
    for got, want in zip(ga + gb, jfid.gaussian_stats(a) + jfid.gaussian_stats(b)):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    got = tfid.frechet_distance(*ga, *gb)
    np.testing.assert_allclose(got, jfid.frechet_distance(*ga, *gb), atol=1e-6, rtol=0)
    assert got > 1.0 and tfid.frechet_distance(*ga, *ga) == pytest.approx(0.0, abs=1e-9)
    with pytest.raises(ValueError, match="N>=2"):
        tfid.gaussian_stats(np.zeros((1, 3)))


def test_committed_reference_file_equals_the_jax_functions(extractors):
    """The file holds JAX's reference_stats at seed 1234, n 4096 and the
    features of fid_floor's 36-image draw at seed 97531, recomputed here."""
    jmodel, jparams, _ = extractors
    with np.load(tfid.CACHED_REFERENCE) as z:
        cached = {k: z[k] for k in z.files}
    assert (int(cached["ref_n"]), int(cached["ref_seed"]), int(cached["floor_n"]),
            int(cached["floor_seed"])) == (4096, 1234, 36, 97531)
    with open(EXTRACTOR, "rb") as f:
        assert str(cached["extractor_sha256"]) == hashlib.sha256(f.read()).hexdigest()
    mu, cov = jfid.reference_stats(jmodel, jparams, n=4096, seed=1234)
    np.testing.assert_allclose(cached["mu"], mu, atol=1e-6, rtol=0)
    np.testing.assert_allclose(cached["cov"], cov, atol=1e-6, rtol=0)
    x, _, _ = jax_generate_batch(JLatticeConfig(img_size=64, rot_only=True), 97531,
                                 jnp.arange(36))
    np.testing.assert_allclose(cached["floor_features"],
                               jfid.encode_features(jmodel, jparams, x), atol=1e-6, rtol=0)


def test_encode_compute_fid_and_floor_match_jax(extractors):
    jmodel, jparams, tmodel = extractors
    x, _, _ = jax_generate_batch(JLatticeConfig(img_size=64, rot_only=True), 11,
                                 jnp.arange(40))
    x = np.asarray(x)
    gen = np.clip(x + np.random.default_rng(1).normal(0, 0.1, size=x.shape), 0, 1)
    feats = tfid.encode_features(tmodel, gen, batch_size=16)
    np.testing.assert_allclose(feats, jfid.encode_features(jmodel, jparams, gen), atol=1e-5,
                               rtol=0)
    # at the committed arguments the port returns the JAX functions' values
    ref = tfid.reference_stats(tmodel)
    with np.load(tfid.CACHED_REFERENCE) as z:
        assert np.array_equal(ref[0], z["mu"]) and np.array_equal(ref[1], z["cov"])
    want_fid = jfid.compute_fid(gen, jmodel, jparams, ref_stats=ref)
    np.testing.assert_allclose(tfid.compute_fid(gen, tmodel, ref_stats=ref), want_fid,
                               atol=1e-4, rtol=0)
    jref = jfid.reference_stats(jmodel, jparams)
    np.testing.assert_allclose(tfid.fid_floor(tmodel, 36, ref),
                               jfid.fid_floor(jmodel, jparams, 36, jref), atol=1e-4, rtol=0)


def test_other_arguments_and_other_extractors_draw_their_own(extractors):
    _, _, tmodel = extractors
    with np.load(tfid.CACHED_REFERENCE) as z:
        cached_mu = z["mu"]
    mu, cov = tfid.reference_stats(tmodel, n=64, batch_size=32)
    assert mu.shape == (16,) and cov.shape == (16, 16) and np.isfinite(cov).all()
    assert not np.allclose(mu, cached_mu, atol=1e-3)
    # a model without the committed file's hash draws its own lattices at the
    # committed seed (counter hashes, not threefry): other items from the same
    # distribution, so its stats sit at draw-noise distance from JAX's
    # (FID ~0.006 here; two of the port's own seeds differ by ~0.009)
    other = TVAE(16).eval()
    other.load_state_dict(tmodel.state_dict())
    own = tfid.reference_stats(other)
    assert not np.array_equal(own[0], cached_mu)
    assert tfid.frechet_distance(*own, *tfid.reference_stats(tmodel)) < 0.05
    floor = tfid.fid_floor(other, 36, own)
    assert np.isfinite(floor) and floor > 0.0
    assert tfid.fid_floor(tmodel, 20, tfid.reference_stats(tmodel)) > 0.0


def test_load_feature_extractor_refuses_conditional_and_collapsed(tmp_path):
    from toycrystals_torch.utils.checkpoint import load_checkpoint

    raw = load_checkpoint(EXTRACTOR)
    save_checkpoint(tmp_path / "cond.msgpack", {"params": raw["params"],
                                                 "config": dict(raw["config"], uncond=False)})
    with pytest.raises(ValueError, match="UNCONDITIONAL"):
        tfid.load_feature_extractor(tmp_path / "cond.msgpack", device="cpu")
    collapsed = jax.tree.map(np.asarray, raw["params"])
    collapsed["encoder"]["mu"]["kernel"] = np.zeros_like(collapsed["encoder"]["mu"]["kernel"])
    save_checkpoint(tmp_path / "dead.msgpack", {"params": collapsed, "config": raw["config"]})
    with pytest.raises(ValueError, match="collapsed"):
        tfid.load_feature_extractor(tmp_path / "dead.msgpack", device="cpu")
    model, _ = tfid.load_feature_extractor(tmp_path / "dead.msgpack", check=False, device="cpu")
    assert model.source_sha256 != hashlib.sha256(open(EXTRACTOR, "rb").read()).hexdigest()


def test_load_feature_extractor_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tfid.load_feature_extractor(EXTRACTOR)
    assert LatticeConfig(img_size=64, rot_only=True) == tfid._DEFAULT_CFG
