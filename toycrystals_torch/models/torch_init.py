"""Parameter initialisation of the port's modules.

Counterpart of toycrystals_tpu/models/torch_init.py, plus the flax defaults
the JAX trainer starts from:

- `flax_default_init`: kernels normal with std 1/sqrt(fan_in) (flax's
  lecun-normal, without its truncation at two standard deviations; a
  ConvTranspose2d's fan-in is in x kh x kw, and a MoE block's stacked expert
  kernel `w1` [E, d, f] / `w2` [E, f, d] counts E x d / E x f, as flax
  counts them), biases zero, norm scales one, the U-Net's class embedding
  N(0, 1) and the prior's `y_cat_emb` N(0, 1/features) (flax's Embed
  default); from a numpy generator, so a seed gives the same weights on
  every machine, or from a `torch.Generator`, which draws the same
  statistics on its own device (other values; a model of 10^8 parameters in
  milliseconds on a GPU, where numpy takes seconds).
- `torch_like_init`: torch's own layer defaults, which the original torch
  implementation trained from: conv and linear kernels and their biases
  U(+-1/sqrt(fan_in)), embeddings N(0, 1), norm scales and biases untouched;
  from a `torch.Generator`.

Both write into the module in place and return it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from toycrystals_torch.ops.conv import Conv2d


def _flax_leaf(k: str, shape: tuple) -> tuple[str, float]:
    """How flax draws the leaf `k` of `shape`: ("normal", the divisor of
    N(0, 1)), ("ones", 1) or ("zeros", 1)."""
    if k.endswith("y_cat_emb.weight"):
        return "normal", math.sqrt(shape[1])
    if k.endswith("cat_emb.weight"):
        return "normal", 1.0
    if k.endswith((".w1", ".w2")):  # [E, fan_in, fan_out], the flax layout
        return "normal", math.sqrt(math.prod(shape[:-1]))
    if k.endswith("weight") and "ConvTranspose" in k:  # [in, out, kh, kw]
        return "normal", math.sqrt(shape[0] * math.prod(shape[2:]))
    if k.endswith("weight") and len(shape) >= 2:
        return "normal", math.sqrt(math.prod(shape[1:]))
    return ("ones", 1.0) if k.endswith("weight") else ("zeros", 1.0)


def flax_default_init(model: nn.Module,
                      rng: np.random.Generator | torch.Generator) -> nn.Module:
    """Re-draw every parameter of `model` with flax's default statistics,
    walking `state_dict()` in order (one draw per kernel), from a numpy
    generator or, on its device, a `torch.Generator`."""
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        kind, d = _flax_leaf(k, shape)
        if isinstance(rng, torch.Generator):
            fill = {"ones": torch.ones, "zeros": torch.zeros}.get(kind)
            sd[k] = (torch.randn(shape, generator=rng, device=rng.device) / d if fill is None
                     else fill(shape, device=rng.device))
            continue
        if kind == "normal":
            a = rng.normal(size=shape) / d
        else:
            a = np.ones(shape) if kind == "ones" else np.zeros(shape)
        sd[k] = torch.tensor(a.astype(np.float32))
    model.load_state_dict(sd, strict=True)
    return model


def torch_like_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every conv, linear and embedding parameter of `model` with
    torch's default statistics; GroupNorm scales and biases keep their 1/0.
    `generator` lies on the CPU; the values are copied to the parameters'
    device."""

    def uniform_(p: torch.Tensor, bound: float) -> None:
        u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
        p.copy_((2.0 * u - 1.0) * bound)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(math.prod(m.weight.shape[1:]))
                uniform_(m.weight, bound)
                uniform_(m.bias, bound)
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
    return model
