"""Latent-space Fréchet distance (crystal FID), in PyTorch.

Counterpart of toycrystals_tpu/utils/fid.py. Features are the encoder means
of an unconditional VAE trained on the procedural distribution (the
committed extractor assets/eval/feature_vae_z16.msgpack); the real
statistics come from a deterministic procedural draw; FID = ||mu1 - mu2||^2
+ tr(C1 + C2 - 2 (C1^1/2 C2 C1^1/2)^1/2) in float64 numpy with
eigendecomposition square roots, eigenvalues clipped at 0. `fid_floor` is
FID(real draw of the same n, real stats): every score ships with its noise
floor.

One deliberate difference: the port's `generate_batch` draws each item from
counter hashes, not JAX's threefry, so its real draws at a seed are other
lattices than the JAX package's, and an FID against them would drift from
the JAX score by the noise of the draw. So the JAX functions' outputs at the
eval CLI's defaults are committed beside the extractor
(assets/eval/feature_vae_z16_fid_ref.npz: `reference_stats` at seed 1234 and
n 4,096, and the features of `fid_floor`'s 36-image draw at seed 97531).
`reference_stats` and `fid_floor` return those at exactly those arguments
with the committed extractor (checked by the file's SHA-256) on the default
64x64 rot_only config, and draw their own otherwise.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from toycrystals_torch.data.datasets import generate_batch
from toycrystals_torch.data.lattice import LatticeConfig
from toycrystals_torch.models.vae import VAE

__all__ = [
    "gaussian_stats",
    "frechet_distance",
    "load_feature_extractor",
    "encode_features",
    "reference_stats",
    "compute_fid",
    "fid_floor",
]

CACHED_REFERENCE = Path(__file__).resolve().parents[2] / "assets" / "eval" / \
    "feature_vae_z16_fid_ref.npz"
_DEFAULT_CFG = LatticeConfig(img_size=64, rot_only=True)


def gaussian_stats(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[N, D] features -> (mean [D], covariance [D, D]) in float64."""
    f = np.asarray(feats, dtype=np.float64)
    if f.ndim != 2 or f.shape[0] < 2:
        raise ValueError(f"need [N>=2, D] features, got shape {f.shape}")
    return f.mean(axis=0), np.atleast_2d(np.cov(f, rowvar=False))


def _psd_sqrt(mat: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigendecomposition (f64, clipped)."""
    w, v = np.linalg.eigh((mat + mat.T) / 2.0)
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray,
                     cov2: np.ndarray) -> float:
    """Fréchet distance between two Gaussians, >= 0, 0 iff identical."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1 = np.atleast_2d(np.asarray(cov1, np.float64))
    cov2 = np.atleast_2d(np.asarray(cov2, np.float64))
    diff = mu1 - mu2
    s1 = _psd_sqrt(cov1)
    inner = _psd_sqrt(s1 @ cov2 @ s1)
    fid = float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(inner))
    # round-off can leave a tiny negative residue when the gap is ~0
    return max(fid, 0.0)


def load_feature_extractor(path: str | Path, check: bool = True, device="cuda"):
    """An UNCONDITIONAL VAE checkpoint (`{"params", "config"}`, the layout of
    scripts/train_vae.py --uncond) as (model on `device`, config). A
    conditional checkpoint raises: conditioning in the features would hide
    conditioning errors from the metric. With `check`, a 16-image
    procedural probe must give features whose per-dim std is not ~0: a
    posterior-collapsed encoder scores every FID ~0. `model.source_sha256`
    is the file's SHA-256."""
    from toycrystals_torch.serve import resolve_device
    from toycrystals_torch.utils.checkpoint import load_checkpoint
    from toycrystals_torch.utils.params import torch_state_dict_from_flax_vae

    dev = resolve_device(device)
    data = Path(path).read_bytes()
    raw = load_checkpoint(path)
    cfg = raw.get("config", {})
    if not cfg.get("uncond", False):
        raise ValueError(f"{path}: FID feature extractor must be an UNCONDITIONAL VAE "
                         "(train one with scripts/train_vae.py --uncond); this checkpoint is "
                         "conditional.")
    img_size = int(cfg.get("img_size", 64))
    model = VAE(z_dim=int(cfg.get("z_dim", 16)))
    sd = torch_state_dict_from_flax_vae(raw["params"])
    model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()},
                          strict=True)
    model = model.to(dev).eval().requires_grad_(False)
    model.source_sha256 = hashlib.sha256(data).hexdigest()
    if check:
        probe, _, _ = generate_batch(LatticeConfig(img_size=img_size, rot_only=True), 7,
                                     torch.arange(16), device=dev)
        f = encode_features(model, probe, batch_size=16)
        if float(np.std(f, axis=0).mean()) < 1e-3:
            raise ValueError(f"{path}: feature extractor is posterior-collapsed: encoder means "
                             "are (near-)constant across a 16-image probe batch, so every FID "
                             "would score ~0. Retrain the unconditional VAE until encoder "
                             "features vary with the input.")
    return model, cfg


def encode_features(model: VAE, images, batch_size: int = 512) -> np.ndarray:
    """[N, H, W, 1] (or [N, H, W]) images in [0, 1] -> encoder-mean features
    [N, z_dim] (numpy f32), on the model's device, in batches."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(images.cpu() if torch.is_tensor(images) else np.asarray(images),
                        dtype=torch.float32)
    if x.ndim == 3:
        x = x[..., None]
    out = []
    with torch.inference_mode():
        for i in range(0, x.shape[0], batch_size):
            mu, _ = model.encode(x[i:i + batch_size].to(dev))
            out.append(mu.cpu().numpy())
    return np.concatenate(out, axis=0)


def _cached(model: VAE) -> dict | None:
    """The committed JAX outputs when `model` is the committed extractor."""
    if not CACHED_REFERENCE.exists():
        return None
    with np.load(CACHED_REFERENCE) as z:
        cached = {k: z[k] for k in z.files}
    if getattr(model, "source_sha256", None) != str(cached["extractor_sha256"]):
        return None
    return cached


def reference_stats(model: VAE, cfg: LatticeConfig | None = None, n: int = 4096,
                    seed: int = 1234, batch_size: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """Real-distribution Gaussian stats from a deterministic procedural draw
    of items [0, n) at `seed` (the committed JAX stats at the defaults with
    the committed extractor; module docstring)."""
    cfg = cfg or _DEFAULT_CFG
    cached = _cached(model)
    if cached is not None and cfg == _DEFAULT_CFG and (n, seed) == (int(cached["ref_n"]),
                                                                    int(cached["ref_seed"])):
        return cached["mu"], cached["cov"]
    dev = next(model.parameters()).device
    feats = []
    for i in range(0, n, batch_size):
        x, _, _ = generate_batch(cfg, seed, torch.arange(i, min(i + batch_size, n)), device=dev)
        feats.append(encode_features(model, x, batch_size=batch_size))
    return gaussian_stats(np.concatenate(feats, axis=0))


def compute_fid(gen_images, model: VAE, ref_stats: tuple[np.ndarray, np.ndarray] | None = None,
                cfg: LatticeConfig | None = None, n_ref: int = 4096, seed: int = 1234) -> float:
    """FID between generated images and the procedural real distribution."""
    if ref_stats is None:
        ref_stats = reference_stats(model, cfg=cfg, n=n_ref, seed=seed)
    return frechet_distance(*gaussian_stats(encode_features(model, gen_images)), *ref_stats)


def fid_floor(model: VAE, n: int, ref_stats: tuple[np.ndarray, np.ndarray],
              cfg: LatticeConfig | None = None, seed: int = 97531) -> float:
    """FID(real draw of size n, real stats): the small-n noise floor. The
    seed is disjoint from `reference_stats`'s, so the two draws are
    independent (the committed JAX features at n 36 and the default seed
    with the committed extractor; module docstring)."""
    cfg = cfg or _DEFAULT_CFG
    cached = _cached(model)
    if cached is not None and cfg == _DEFAULT_CFG and (n, seed) == (int(cached["floor_n"]),
                                                                    int(cached["floor_seed"])):
        feats = cached["floor_features"]
    else:
        dev = next(model.parameters()).device
        x, _, _ = generate_batch(cfg, seed, torch.arange(n), device=dev)
        feats = encode_features(model, x)
    return frechet_distance(*gaussian_stats(feats), *ref_stats)
