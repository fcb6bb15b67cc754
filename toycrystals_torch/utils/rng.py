"""Random draws of a global batch of which the caller keeps some rows.

A rank of a data mesh (parallel/mesh.py) holds rows [lo, hi) of a global
batch of n. Drawing from a `RowGenerator` draws the whole batch from the
shared generator and keeps those rows, so each row gets the value it gets
in the unsharded run, as JAX's sharded draws do. `randn`, `rand` and
`randint` take either a `torch.Generator` (or None) or a `RowGenerator`.
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
    generator."""

    generator: torch.Generator
    lo: int
    hi: int
    n: int


def _draw(fn, shape, generator, **kw) -> torch.Tensor:
    if not isinstance(generator, RowGenerator):
        return fn(tuple(shape), generator=generator, **kw)
    g = generator
    if shape[0] != g.hi - g.lo:
        raise ValueError(f"a draw of {shape[0]} rows from a generator of rows "
                         f"[{g.lo}, {g.hi})")
    return fn((g.n, *shape[1:]), generator=g.generator, **kw)[g.lo:g.hi]


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
