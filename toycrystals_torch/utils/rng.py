"""Random draws of a global batch of which the caller keeps some rows.

A rank of a data mesh (parallel/mesh.py) holds rows [lo, hi) of a global
batch of n. Drawing from a `RowGenerator` draws the whole batch from the
shared generator and keeps those rows, so each row gets the value it gets
in the unsharded run, as JAX's sharded draws do. A rank of a (data, space)
mesh also keeps rows [h_lo, h_hi) of the image height: an image draw (4-D,
NHWC) is drawn whole and cut on both axes. `randn`, `rand` and `randint`
take either a `torch.Generator` (or None) or a `RowGenerator`.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RowGenerator:
    """`generator`'s draws for a batch of n rows, of which the caller keeps
    rows [lo, hi). Every rank holds the same generator state, draws the
    whole batch and keeps its own rows, so each row gets the value it gets
    in the unsharded run. Pass it where a sampler or a step takes a
    generator. With `h_n` set, 4-D draws [b, h, W, C] are images of height
    h_n of which the caller keeps rows [h_lo, h_hi) of H too."""

    generator: torch.Generator
    lo: int
    hi: int
    n: int
    h_lo: int = 0
    h_hi: int | None = None
    h_n: int | None = None


def _draw(fn, shape, generator, **kw) -> torch.Tensor:
    if not isinstance(generator, RowGenerator):
        return fn(tuple(shape), generator=generator, **kw)
    g = generator
    if shape[0] != g.hi - g.lo:
        raise ValueError(f"a draw of {shape[0]} rows from a generator of rows "
                         f"[{g.lo}, {g.hi})")
    if g.h_n is None or len(shape) != 4:
        return fn((g.n, *shape[1:]), generator=g.generator, **kw)[g.lo:g.hi]
    if shape[1] != g.h_hi - g.h_lo:
        raise ValueError(f"an image draw of height {shape[1]} from a generator of rows "
                         f"[{g.h_lo}, {g.h_hi}) of H")
    return fn((g.n, g.h_n, *shape[2:]), generator=g.generator, **kw)[g.lo:g.hi, g.h_lo:g.h_hi]


def randn(shape, generator, device=None, dtype=torch.float32) -> torch.Tensor:
    """torch.randn for a generator that may be a `RowGenerator`."""
    return _draw(torch.randn, shape, generator, device=device, dtype=dtype)


def rand(shape, generator, device=None, dtype=torch.float32) -> torch.Tensor:
    """torch.rand for a generator that may be a `RowGenerator`."""
    return _draw(torch.rand, shape, generator, device=device, dtype=dtype)


def randint(high: int, shape, generator, device=None) -> torch.Tensor:
    """torch.randint(0, high) for a generator that may be a `RowGenerator`."""
    return _draw(lambda s, **kw: torch.randint(0, high, s, **kw), shape, generator,
                 device=device)
