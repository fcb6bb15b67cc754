"""The space axis's GroupNorm pair (toycrystals_torch/ops/groupnorm.py: the sums
and apply kernels' plain versions) against the JAX op on the whole image, and
the apply kernel's addressing written out in Python.

An image split into S row bands, as S ranks hold it: `gn_sums_reference` of
every band added, then `gn_silu_apply_reference` on each band with its H halo
rows taken from the neighbouring bands, gives JAX's
`toycrystals_tpu.ops.groupnorm.gn_silu` of the whole image (its Pallas kernel
in interpret mode on the CPU; NHWC there, NCHW here).

The apply kernel (csrc/gn_silu.cu, `gn_silu_apply_kernel`) writes each output
row as 16-byte vectors at the output's 16-byte boundaries, each a window of x's
row read circularly, and the row's few columns outside them one element a lane.
`_kernel_row_map` follows its index arithmetic step by step (lane groups, the
neighbouring lane's vector by a shuffle, the reload at a group's end) and
`_kernel_map` its row arithmetic; both are held against `F.pad(mode="circular")`
at ragged widths and at every alignment a row can start at. The kernel itself
runs on the card only (tests/test_torch_spatial_cuda.py, chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from toycrystals_torch.ops import groupnorm as tgn
from toycrystals_tpu.ops.groupnorm import gn_silu as jax_gn_silu

torch.set_num_threads(1)

SHAPE, GROUPS = (2, 8, 8, 6), 4  # [B, C, H, W]: H splits into 1, 2 and 4 bands
# f32: the band sums add in another order than JAX's mean. bf16: one rounding
# step of the output apart at most (bf16 spacing is at most 2^-7 of a value).
TOL = {torch.float32: dict(atol=2e-6, rtol=1e-5), torch.bfloat16: dict(atol=1e-6, rtol=2**-7)}


@functools.cache
def _case(dtype: torch.dtype, pad: bool):
    """x, scale, bias in the port's layout, and JAX's output on the whole image."""
    rng = np.random.default_rng(5)
    b, c, h, w = SHAPE
    x = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32) * 2.0 + 0.5).to(dtype)
    scale = torch.from_numpy((rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=(c,)) * 0.1).astype(np.float32))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x.float().numpy().transpose(0, 2, 3, 1)).astype(jdtype)
    want = jax_gn_silu(xj, jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()), GROUPS, 1e-6,
                       pad)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2).copy())
    return x, scale, bias, want


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bands", [1, 2, 4])
def test_bands_reproduce_jax_on_the_whole_image(bands, dtype, pad):
    x, scale, bias, want = _case(dtype, pad)
    b, c, h, w = SHAPE
    hb = h // bands
    parts = list(torch.split(x, hb, dim=2))
    sums = sum(tgn.gn_sums_reference(p, GROUPS) for p in parts)
    count = c // GROUPS * h * w
    outs = [tgn.gn_silu_apply_reference(p, sums, count, scale, bias, GROUPS, pad=pad)
            for p in parts]
    if pad:  # the H halo rows are the neighbouring bands' edge rows, wrapped
        outs = [torch.cat([outs[k - 1][:, :, hb:hb + 1], o[:, :, 1:hb + 1],
                           outs[(k + 1) % bands][:, :, 1:2]], dim=2)
                for k, o in enumerate(outs)]
    for k, o in enumerate(outs):
        assert o.dtype == dtype
        torch.testing.assert_close(o.float(), want[:, :, k * hb:k * hb + hb + 2 * pad],
                                   **TOL[dtype])


def _kernel_row_map(w: int, pad: bool, elem: int, vector: bool, row_offset: int) -> list[int]:
    """The x column that each column of one output row gets, as the apply
    kernel computes it. `row_offset`: the row's byte address modulo 16;
    `vector`: the 16-byte layout (V = 16 / elem; x's rows whole vectors),
    else one element a lane (V = 1)."""
    p = 1 if pad else 0
    wo = w + 2 * p
    v = 16 // elem if vector else 1
    nvec = w // v
    umax = wo if v == 1 else nvec
    gw = 1
    while gw < 32 and gw < umax:
        gw *= 2
    j0 = min(wo, (16 - row_offset) % 16 // elem) if v > 1 else 0
    nv = (wo - j0) // v
    s = (j0 - p + v) % v
    q = nvec - 1 if j0 - p < 0 else 0
    got: list[int | None] = [None] * wo

    def x_vector(i):
        return list(range(i * v, i * v + v))

    for u0 in range(0, umax, gw):
        own = {}
        for sub in range(gw):
            u = u0 + sub
            qv = q + u
            if qv >= nvec:
                qv -= nvec
            if v == 1 and qv >= nvec:
                qv -= nvec
            own[sub] = (u < nv, qv, x_vector(qv) if u < nv else None)
        for sub in range(gw):
            act, qv, mine = own[sub]
            if not act:
                continue
            window = mine
            if v > 1 and s != 0:
                nxt = own[sub + 1][2] if sub + 1 < gw else mine  # the shuffle
                if sub == gw - 1 or u0 + sub + 1 >= nv:
                    nxt = x_vector(0 if qv + 1 == nvec else qv + 1)
                window = (mine + nxt)[s:s + v]
            for e, xc in enumerate(window):
                col = j0 + (u0 + sub) * v + e
                assert got[col] is None, col
                got[col] = xc
    if v > 1:
        for t in range(wo - nv * v):  # the columns before j0 and after the vectors
            col = t if t < j0 else j0 + nv * v + (t - j0)
            xc = col - p
            xc = xc + w if xc < 0 else xc - w if xc >= w else xc
            assert got[col] is None, col
            got[col] = xc
    assert None not in got
    return got


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("w", [1, 3, 4, 7, 8, 12, 16, 24, 40, 64, 72, 256])
def test_apply_kernel_row_map_is_the_circular_pad(w, pad, elem):
    """Every column of a row, at every alignment its start can have, in the
    16-byte layout (where W is whole vectors) and one element a lane."""
    want = F.pad(torch.arange(w, dtype=torch.float32).reshape(1, 1, 1, w),
                 (1, 1, 0, 0) if pad else (0, 0, 0, 0), mode="circular").flatten().tolist()
    layouts = [False] + ([True] if w % (16 // elem) == 0 else [])
    for vector in layouts:
        for row_offset in range(0, 16, elem):
            assert _kernel_row_map(w, pad, elem, vector, row_offset) == want, (vector,
                                                                             row_offset)


class _FastDiv:
    """n // d by a multiply-high and a shift, as csrc/gn_silu.cu's make_div."""

    def __init__(self, d: int):
        self.d, self.mul, self.shr = d, 0, 0
        if d > 1:
            lg = (d - 1).bit_length()
            self.mul = ((1 << (31 + lg)) + d - 1) // d
            self.shr = lg - 1

    def __call__(self, n: int) -> int:
        return n if self.d == 1 else (n * self.mul >> 32) >> self.shr


def _kernel_map(shape, groups: int, pad: bool, elem: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat source element of x, group) of every output element, from the
    apply kernel's row arithmetic and `_kernel_row_map`, with the output
    starting 16-byte aligned."""
    b, c, h, w = shape
    p = 1 if pad else 0
    ho, wo = h + 2 * p, w + 2 * p
    d_ho, d_c, d_cg = _FastDiv(ho), _FastDiv(c), _FastDiv(c // groups)
    vector = w % (16 // elem) == 0
    src = torch.empty((b, c, ho, wo), dtype=torch.int64)
    grp = torch.empty((b, c, ho, wo), dtype=torch.int64)
    for r in range(b * c * ho):
        bc = d_ho(r)
        i = r - bc * ho
        ch = bc - d_c(bc) * c
        assert ch == bc % c
        si = i - p
        si = si + h if si < 0 else si - h if si >= h else si
        cols = _kernel_row_map(w, pad, elem, vector, r * wo * elem % 16)
        src.view(-1, wo)[r] = torch.tensor(cols) + (bc * h + si) * w
        grp.view(-1, wo)[r] = d_cg(bc)
    return src, grp


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("shape,groups", [((2, 12, 5, 7), 4), ((2, 8, 3, 16), 8),
                                          ((1, 6, 1, 24), 2), ((3, 4, 2, 72), 1)])
def test_apply_kernel_index_map_is_the_circular_pad(shape, groups, pad, elem):
    """Output element -> x's channel, row and column, and the group whose sums
    it takes, against F.pad(circular) of x's own indices, at ragged shapes."""
    b, c, h, w = shape
    idx = torch.arange(b * c * h * w, dtype=torch.float64).reshape(shape)
    want = F.pad(idx, (1, 1, 1, 1), mode="circular") if pad else idx
    src, grp = _kernel_map(shape, groups, pad, elem)
    assert torch.equal(src, want.long())
    want_grp = (torch.arange(b).reshape(b, 1) * groups
                + torch.arange(c).reshape(1, c) // (c // groups))
    assert torch.equal(grp, want_grp.reshape(b, c, 1, 1).expand_as(grp))
