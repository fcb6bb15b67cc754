"""The CUDA flash-attention kernels (toycrystals_torch/csrc/flash_attn.cu)
against the plain PyTorch version, on the card: forward and the gradients of
q, k and v, in f32 and bf16, and the bf16 forward and backward (wgmma, TMA rings)
and the f32 ones (TF32 mma, three products each) at every head dim that
chip_smoke.py builds, their O and row log-sum-exp, at Nq != Nk, and bit for bit
from run to run.

Every test here is marked `cuda` and skips without a card. On a machine with
one NVIDIA GPU and nvcc, run them without tests/conftest.py, which imports
JAX (the port does not need it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_flash_attention_cuda.py -q

The plain version runs in f32 on the same values (bf16 inputs upcast), and
an error is held to a share of the reference's largest entry: 2e-5 in f32
(sums taken in another order), 1e-2 in bf16 (the kernel rounds P, dS and
its outputs to bf16, 2^-8 relative each, and the plain version rounds none).
"""

import pytest
import torch

from toycrystals_torch.ops import attention as at

pytestmark = pytest.mark.cuda

SHARE = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _qkv(device, shape, dtype, seed=0):
    """q, k, v as the U-Net hands them over: views of one [B, N, 3, heads, d]
    projection."""
    b, n, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, d), generator=g, device=device).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _close(got, want, share):
    err = float((got.float() - want).abs().max())
    assert err <= share * float(want.abs().max()), (err, float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 2048, 4, 48), (2, 256, 4, 64), (3, 256, 4, 16),
                                   (2, 128, 1, 128), (2, 128, 2, 24), (1, 384, 3, 80)])
def test_forward_matches_plain_version(cuda, shape, dtype):
    q, k, v = _qkv(cuda, shape, dtype)
    before = at.flash_sdpa.launches
    got = at.flash_sdpa(q, k, v)
    torch.cuda.synchronize()
    assert at.flash_sdpa.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    _close(got, at.sdpa_reference(q.float(), k.float(), v.float()), SHARE[dtype])


@pytest.mark.parametrize("layout", ["qkv_views", "contiguous"])
@pytest.mark.parametrize("n", [128, 2048, 4096])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 128])
def test_bf16_forward_at_every_built_head_dim(cuda, d, n, layout):
    """The wgmma forward: one key tile and one block per head (N 128), and a
    K/V ring that wraps many times (N 2,048 and 4,096), on the strided views
    of the qkv projection and on contiguous tensors; O and the row
    log-sum-exp L that the backward reads."""
    b, h = (2, 3) if n == 128 else (1, 2)
    q, k, v = _qkv(cuda, (b, n, h, d), torch.bfloat16, seed=d + n)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = at.flash_sdpa.launches
    out, lse = at._flash_forward_cuda(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert at.flash_sdpa.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and out.is_contiguous()
    qf, kf, vf = (t.float() for t in (q, k, v))
    _close(out, at.sdpa_reference(qf, kf, vf), SHARE[torch.bfloat16])
    logits = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * d ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), atol=2e-3, rtol=0)


@pytest.mark.parametrize("layout", ["qkv_views", "contiguous"])
@pytest.mark.parametrize("n", [128, 2048, 4096])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 128])
def test_bf16_gradients_at_every_built_head_dim(cuda, d, n, layout):
    """The wgmma backward (dK/dV: K/V resident, a ring of Q/dO tiles with
    their L and delta; dQ: Q/dO resident, a K/V ring): one tile and one block
    per head (N 128) and rings that wrap many times (N 2,048 and 4,096), on
    the strided views of the qkv projection and on contiguous tensors; q, k
    and v gradients against the f32 plain version."""
    b, h = (2, 3) if n == 128 else (1, 2)
    q, k, v = _qkv(cuda, (b, n, h, d), torch.bfloat16, seed=d + n)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    g = torch.Generator(device=cuda).manual_seed(d * n)
    upstream = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = at.flash_sdpa.backward_launches
    got = torch.autograd.grad(at.flash_sdpa(*leaves), leaves, upstream)
    torch.cuda.synchronize()
    assert at.flash_sdpa.backward_launches == before + 1
    ref = [t.detach().float().requires_grad_(True) for t in leaves]
    want = torch.autograd.grad(at.sdpa_reference(*ref), ref, upstream.float())
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        _close(a, w, SHARE[torch.bfloat16])


@pytest.mark.parametrize("layout", ["qkv_views", "contiguous"])
@pytest.mark.parametrize("n", [128, 2048, 4096])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 128])
def test_f32_forward_at_every_built_head_dim(cuda, d, n, layout):
    """The TF32 forward: one key tile per block and many (N 128 to 4,096), a
    block of 64 queries at d 128 and of 128 below, on the strided views of the
    qkv projection and on contiguous tensors; O within 2e-5 of the largest
    entry and L within 3e-5 of the log-sum-exp (about 8 here; f32 sums of up
    to 4,096 exponentials in another order)."""
    b, h = (2, 3) if n == 128 else (1, 2)
    q, k, v = _qkv(cuda, (b, n, h, d), torch.float32, seed=d + n)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = at.flash_sdpa.launches
    out, lse = at._flash_forward_cuda(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert at.flash_sdpa.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.float32 and out.is_contiguous()
    _close(out, at.sdpa_reference(q, k, v), SHARE[torch.float32])
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * d ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), atol=3e-5, rtol=0)


@pytest.mark.parametrize("layout", ["qkv_views", "contiguous"])
@pytest.mark.parametrize("n", [128, 2048, 4096])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 128])
def test_f32_gradients_at_every_built_head_dim(cuda, d, n, layout):
    """The TF32 backward (dK/dV: K and V packed once, tiles of 64, 32 or 16
    queries; dQ: Q and dO packed once, tiles of keys): q, k and v gradients
    against autograd of the plain version within 2e-5 of each largest entry."""
    b, h = (2, 3) if n == 128 else (1, 2)
    q, k, v = _qkv(cuda, (b, n, h, d), torch.float32, seed=d + n)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    g = torch.Generator(device=cuda).manual_seed(d * n)
    upstream = torch.randn(q.shape, generator=g, device=cuda)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = at.flash_sdpa.backward_launches
    got = torch.autograd.grad(at.flash_sdpa(*leaves), leaves, upstream)
    torch.cuda.synchronize()
    assert at.flash_sdpa.backward_launches == before + 1
    ref = [t.detach().requires_grad_(True) for t in leaves]
    want = torch.autograd.grad(at.sdpa_reference(*ref), ref, upstream)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        _close(a, w, SHARE[torch.float32])


@pytest.mark.parametrize("d", [16, 48, 128])
@pytest.mark.parametrize("n,nk", [(256, 1024), (512, 128)])
def test_f32_fewer_or_more_queries_than_keys(cuda, d, n, nk):
    """Nq != Nk in all three TF32 kernels: O and the three gradients of q
    [B, Nq, heads, d] against k, v [B, Nk, heads, d], views of one tensor."""
    b, h = 2, 2
    g = torch.Generator(device=cuda).manual_seed(n + nk + d)
    q = torch.randn((b, n, h, d), generator=g, device=cuda)
    kv = torch.randn((b, nk, 2, h, d), generator=g, device=cuda)
    upstream = torch.randn((b, n, h, d), generator=g, device=cuda)
    leaves = [t.detach().requires_grad_(True) for t in (q, kv[:, :, 0], kv[:, :, 1])]
    out = at.flash_sdpa(*leaves)
    got = torch.autograd.grad(out, leaves, upstream)
    ref = [t.detach().requires_grad_(True) for t in leaves]
    want_out = at.sdpa_reference(*ref)
    want = torch.autograd.grad(want_out, ref, upstream)
    for a, w in zip((out.detach(), *got), (want_out.detach(), *want)):
        assert a.shape == w.shape
        _close(a, w, SHARE[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 1024, 4, 48), (2, 256, 4, 64), (3, 256, 4, 16),
                                   (2, 128, 1, 128), (2, 128, 2, 24)])
def test_gradients_match_plain_version(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    upstream = torch.randn(shape, generator=g, device=cuda).to(dtype)
    leaves = [t.detach().clone().requires_grad_(True) for t in _qkv(cuda, shape, dtype)]
    fwd, bwd = at.flash_sdpa.launches, at.flash_sdpa.backward_launches
    got = torch.autograd.grad(at.flash_sdpa(*leaves), leaves, upstream)
    torch.cuda.synchronize()
    assert (at.flash_sdpa.launches, at.flash_sdpa.backward_launches) == (fwd + 1, bwd + 1)
    ref = [t.detach().float().requires_grad_(True) for t in leaves]
    want = torch.autograd.grad(at.sdpa_reference(*ref), ref, upstream.float())
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        _close(a, w, SHARE[dtype])


def test_results_repeat_bit_for_bit(cuda):
    """No atomics: two runs give the same bits, forward and backward."""
    shape = (2, 512, 4, 48)
    upstream = torch.ones(shape, device=cuda, dtype=torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in _qkv(cuda, shape, torch.bfloat16)]
        out = at.flash_sdpa(*leaves)
        runs.append((out.detach(), *torch.autograd.grad(out, leaves, upstream)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nk", [None, 1024])
def test_f32_results_repeat_bit_for_bit(cuda, nk):
    """The TF32 kernels have no atomics either: two runs of the forward and
    the backward give the same bits, at Nq = Nk and against more keys."""
    b, n, h, d = 2, 512, 4, 48
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((b, n, h, d), generator=g, device=cuda)
    kv = torch.randn((b, nk or n, 2, h, d), generator=g, device=cuda)
    upstream = torch.randn((b, n, h, d), generator=g, device=cuda)
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, kv[:, :, 0], kv[:, :, 1])]
        out = at.flash_sdpa(*leaves)
        runs.append((out.detach(), *torch.autograd.grad(out, leaves, upstream)))
    for a, b2 in zip(*runs):
        assert torch.equal(a, b2)


def test_module_auto_launches_the_kernel_at_4096_tokens(cuda):
    m = at.SelfAttention2d(64, num_heads=4, dtype=torch.bfloat16).to(cuda)
    x = torch.randn(1, 64, 64, 64, device=cuda)
    before = at.flash_sdpa.launches
    with torch.no_grad():
        y = m(x.to(torch.bfloat16))
        assert at.flash_sdpa.launches == before + 1
        m.attn_impl = "xla"
        want = m(x.to(torch.bfloat16))
    assert at.flash_sdpa.launches == before + 1
    torch.testing.assert_close(y.float(), want.float(), atol=3e-2, rtol=1.6e-2)


def test_c_entry_refuses_rows_off_16_bytes(cuda):
    """The kernels load 16 bytes at a time; the C entry itself, not only the
    Python wrapper, refuses a row stride that breaks the alignment."""
    b, n, h, d = 1, 128, 1, 16
    q, k, v = (t.contiguous() for t in _qkv(cuda, (b, n, h, d), torch.float32))
    out, lse = torch.empty_like(q), torch.empty((b, h, n), device=cuda)
    lib = at._lib(d)
    stream = torch.cuda.current_stream().cuda_stream

    def call(q_row_stride):
        return lib.flash_attn_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, n, n,
            h, n * h * d, q_row_stride, d, *at._strides(k), *at._strides(v), 0.25, 0, stream)

    assert call(h * d) == 0
    torch.cuda.synchronize()
    assert call(h * d + 1) != 0       # 17 floats: rows no longer 16-byte aligned


@pytest.mark.parametrize("case", ["head_dim", "seq_len", "half", "cpu_to_kernel"])
def test_wrapper_raises_on_cuda(cuda, case):
    shape = {"head_dim": (1, 128, 1, 144), "seq_len": (1, 192, 2, 16)}.get(case, (1, 128, 2, 16))
    q, k, v = _qkv(cuda, shape, torch.float32)
    before = at.flash_sdpa.launches
    if case == "half":
        with pytest.raises(TypeError):
            at.flash_sdpa(q.half(), k.half(), v.half())
    elif case == "cpu_to_kernel":
        with pytest.raises(ValueError, match="CUDA"):
            at._flash_forward_cuda(q.cpu(), k.cpu(), v.cpu(), 0.25)
    else:
        with pytest.raises(ValueError, match="xla"):
            at.flash_sdpa(q, k, v)
    assert at.flash_sdpa.launches == before
