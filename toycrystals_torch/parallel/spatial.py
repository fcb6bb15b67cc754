"""The space axis: images sharded by height over the ranks of a mesh.

Counterpart of toycrystals_tpu/parallel/spatial.py. JAX lays NHWC images
over a 2-D ("data", "space") mesh and GSPMD inserts the boundary traffic; here
every rank runs its own rows and the ops of the U-Net do that traffic
themselves, reading the mesh from the dispatch scope that `sample_chunked`
sets (`dispatch_scope`):

- every conv (3x3/s1 and 4x4/s2; k - s = 2, so one row a side is enough):
  `pad_rows` exchanges a rank's first and last rows with its H-neighbours,
  wrapping between the last and the first rank (the circular pad), then the
  conv runs VALID on the rank's rows;
- GroupNorm: per-(item, group) sums on each rank, added over "space"
  (ops/groupnorm.py);
- the mid-block attention: Q on the rank's tokens against K and V gathered
  over "space" (ops/attention.py);
- the bilinear upsample: the same exchange, clamped at the image's top and
  bottom rows instead of wrapped;
- the int8 conv's activation scale: a max over every rank of the mesh.

The exchange is an `all_gather` of each rank's two edge rows over the space
group, from which each rank takes its neighbours' rows: one collective that
gloo (two ranks on one card) and NCCL both run on CUDA tensors, where gloo's
point-to-point send and recv take CPU tensors only.

Training differentiates through every exchange: each collective here is a
`torch.autograd.Function` whose backward is the adjoint collective. The halo
rows' gradients go back to the ranks that own the rows (`return_halo_rows`,
an `all_gather` of each rank's two halo-row gradients), a sum over "space"
gets the same sum of its gradients, and a gather over "space" (attention's K
and V, ops/attention.py) gets the sum of each part's gradients on the rank
that owns it. A backward never reads the dispatch scope: on CUDA autograd runs
it on a thread of its own, where the scope is not set, so each Function keeps
the `Shard` of its forward.

One deliberate difference: GSPMD pads a height that does not split evenly,
and the port cannot. JAX checks H/4 against the space axis
(`check_spatial_divisibility`); the s2d stems' trunk runs at H/2 and reaches
H/8, which the port checks too (`check_stem_divisibility`) and refuses.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

from toycrystals_torch.parallel.mesh import (
    MODEL,
    SPACE,
    axis_rank,
    axis_size,
    mesh_group,
    replica_group,
)


@dataclasses.dataclass(frozen=True)
class Shard:
    """What the ops of one dispatch need of its mesh: the group of every
    rank (the int8 scale's max), the space axis's group, size and this
    rank's place on it (size 1: no height sharding), and the same of the
    model axis (size 1: whole weights; parallel/tensor.py)."""

    group: object
    space_group: object
    space: int
    space_rank: int
    model_group: object = None
    model: int = 1
    model_rank: int = 0


_SCOPE: contextvars.ContextVar[Shard | None] = contextvars.ContextVar("toycrystals_shard",
                                                                     default=None)


def current() -> Shard | None:
    """The mesh of the dispatch running in this thread, or None."""
    return _SCOPE.get()


def current_space() -> Shard | None:
    """The dispatch's mesh when it shards the image height, else None."""
    s = _SCOPE.get()
    return s if s is not None and s.space > 1 else None


def current_model() -> Shard | None:
    """The dispatch's mesh when it shards the weights' channels, else None."""
    s = _SCOPE.get()
    return s if s is not None and s.model > 1 else None


@contextlib.contextmanager
def dispatch_scope(mesh):
    """Run the block's ops on this rank's part of `mesh` (None: no mesh).
    The scope belongs to the calling thread and ends with the block."""
    shard = None
    if mesh is not None:
        space, model = axis_size(mesh, SPACE), axis_size(mesh, MODEL)
        shard = Shard(mesh_group(mesh), mesh.get_group(SPACE) if space > 1 else None,
                      space, axis_rank(mesh, SPACE),
                      mesh.get_group(MODEL) if model > 1 else None, model,
                      axis_rank(mesh, MODEL))
    token = _SCOPE.set(shard)
    try:
        yield shard
    finally:
        _SCOPE.reset(token)


def check_spatial_divisibility(img_size: int, n_space: int) -> None:
    """JAX's check: H must split evenly across "space" at every U-Net
    resolution (H, H/2, H/4)."""
    if (img_size // 4) % n_space:
        raise ValueError(
            f"img_size {img_size} not spatially shardable over {n_space} "
            f"devices: H/4 = {img_size // 4} must divide by the 'space' axis"
        )


def check_stem_divisibility(img_size: int, n_space: int, stem: str) -> None:
    """JAX's check, and the port's own for the s2d stems, whose trunk runs at
    H/2 down to H/8: GSPMD pads uneven shards, the port refuses them."""
    check_spatial_divisibility(img_size, n_space)
    if stem != "none" and (img_size // 8) % n_space:
        raise ValueError(
            f"stem {stem} at img_size {img_size} reaches H/8 = {img_size // 8} rows, which "
            f"do not divide by the 'space' axis of {n_space}: GSPMD pads such shards, the "
            f"port does not (ROADMAP.md section 3)")


def space_rows(mesh, h: int) -> slice:
    """The rows [s H / S, (s + 1) H / S) of an image height H on this rank."""
    n, s = axis_size(mesh, SPACE), axis_rank(mesh, SPACE)
    if h % n:
        raise ValueError(f"image height {h} not divisible by the 'space' axis of {n}")
    return slice(s * (h // n), (s + 1) * (h // n))


def _halo_rows(x: torch.Tensor, shard: Shard, circular: bool):
    edges = torch.cat([x[:, :, :1], x[:, :, -1:]], dim=2).contiguous()
    parts = [torch.empty_like(edges) for _ in range(shard.space)]
    dist.all_gather(parts, edges, group=shard.space_group)
    s, n = shard.space_rank, shard.space
    top = parts[(s - 1) % n][:, :, 1:2] if circular or s > 0 else x[:, :, :1]
    bottom = parts[(s + 1) % n][:, :, 0:1] if circular or s < n - 1 else x[:, :, -1:]
    return top, bottom


def return_halo_rows(g_top: torch.Tensor, g_bottom: torch.Tensor, shard: Shard,
                     circular: bool):
    """The adjoint of `halo_rows`: from the gradients of this rank's (top,
    bottom) halo rows [B, C, 1, W], the gradients that land on its (first,
    last) rows, each the halo gradient of the rank that read the row (this
    rank's own, at a clamped image edge)."""
    edges = torch.cat([g_top, g_bottom], dim=2).contiguous()
    parts = [torch.empty_like(edges) for _ in range(shard.space)]
    dist.all_gather(parts, edges, group=shard.space_group)
    s, n = shard.space_rank, shard.space
    first = parts[(s - 1) % n][:, :, 1:2] if circular or s > 0 else g_top
    last = parts[(s + 1) % n][:, :, 0:1] if circular or s < n - 1 else g_bottom
    return first, last


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, circular):
        ctx.shard, ctx.circular, ctx.h = shard, circular, x.shape[2]
        return tuple(t.clone() for t in _halo_rows(x, shard, circular))

    @staticmethod
    def backward(ctx, g_top, g_bottom):
        first, last = return_halo_rows(g_top, g_bottom, ctx.shard, ctx.circular)
        shape = (*first.shape[:2], ctx.h, first.shape[3])
        dx = first.new_zeros(shape)
        dx[:, :, :1] += first
        dx[:, :, -1:] += last
        return dx, None, None


def halo_rows(x: torch.Tensor, shard: Shard, circular: bool):
    """(top, bottom) rows [B, C, 1, W] beside this rank's rows of x [B, C, h, W]:
    the last row of the rank above and the first of the rank below, wrapped
    between the last and the first rank when `circular`, else the image's
    own edge row repeated at its top and bottom. Differentiable: the rows'
    gradients return to their owners (`return_halo_rows`)."""
    return _HaloRows.apply(x, shard, circular)


def pad_rows(x: torch.Tensor, shard: Shard, circular: bool = True) -> torch.Tensor:
    """x [B, C, h, W] with one exchanged row on each side: [B, C, h + 2, W]."""
    top, bottom = halo_rows(x, shard, circular)
    return torch.cat([top, x, bottom], dim=2)


def fill_halo_rows(y: torch.Tensor, shard: Shard) -> torch.Tensor:
    """A circular-padded [B, C, h + 2, W + 2] plane whose rows 0 and h + 1
    hold this rank's own wrap: overwrite them, in place, with the
    neighbours' rows (the image's wrap). Returns y. Not differentiable:
    `ops/groupnorm.py`'s space Function returns the rows' gradients itself."""
    top, bottom = _halo_rows(y[:, :, 1:-1], shard, circular=True)
    y[:, :, :1] = top
    y[:, :, -1:] = bottom
    return y


def all_reduce_max(x: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """The max of f32 x over every rank of the dispatch's mesh (a new
    tensor); no mesh returns x."""
    if shard is None:
        return x
    x = x.float().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=shard.group)
    return x


class _SpaceSum(torch.autograd.Function):
    """x summed over the space axis; every rank reads the sum, so the
    gradient of each rank's x is the sum of every rank's gradient."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=shard.space_group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.shard.space_group)
        return g, None


def all_reduce_space_sum(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """x summed over the space axis (a new tensor; differentiable)."""
    return _SpaceSum.apply(x, shard)


class _GatherSpace(torch.autograd.Function):
    """Every rank's x along `dim`, in space-rank order. The backward sums each
    part's gradient over the ranks onto the rank that owns the part, as an
    all-reduce and this rank's slice: gloo has no reduce-scatter for CUDA
    tensors, and a reduce-scatter on NCCL (half the bytes) waits for a
    multi-card cell that can time it against this."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(shard.space)]
        dist.all_gather(parts, x.contiguous(), group=shard.space_group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        shard, dim = ctx.shard, ctx.dim
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=shard.space_group)
        return g.chunk(shard.space, dim=dim)[shard.space_rank].contiguous(), None, None


def gather_space(x: torch.Tensor, shard: Shard, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in space-rank order (each rank
    holds a contiguous share of the whole); differentiable."""
    return _GatherSpace.apply(x, shard, dim)


def gather_image(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's part of a [b, h, W, ...] batch of images back to the
    whole [b D, h S, W, ...] on every rank: the batch in data-rank order,
    the height in space-rank order. The model ranks of a (data, space)
    coordinate hold the same part, so on a mesh with a "model" axis the
    gather runs over the D S ranks of the rank's model coordinate
    (`replica_group`: "data" on a ("data", "model") mesh). mesh=None
    returns x."""
    if mesh is None:
        return x
    group, n = replica_group(mesh)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    s = axis_size(mesh, SPACE)
    rows = [torch.cat(parts[d * s:(d + 1) * s], dim=1) for d in range(n // s)]
    return torch.cat(rows, dim=0)

