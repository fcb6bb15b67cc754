"""The port's flash-attention wrapper and plain version
(toycrystals_torch/ops/attention.py) against the JAX package's Pallas TPU
kernel, on the CPU.

The JAX side is `_flash_sdpa` itself, run under
`pltpu.force_tpu_interpret_mode()`, which interprets the Pallas kernel (and
the backward kernels of its custom VJP) without a TPU. The port's side is
`flash_sdpa` on CPU tensors, which runs the plain version `sdpa_reference`;
the CUDA kernels are held against that same plain version on the card
(tests/test_torch_flash_attention_cuda.py). Inputs come from a numpy seed;
everything is f32. Tolerance 1e-5 absolute: both sides are exact attention,
so only the order of the f32 sums differs (observed below 1e-6).
"""

import flax.linen as nn  # noqa: F401  (flax registers its pytrees before the JAX module loads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from toycrystals_torch.ops import attention as at
from toycrystals_tpu.ops import attention as jat

ATOL = 1e-5


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _jax_flash(q, k, v):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jat._flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("d", [16, 48, 64])
def test_flash_sdpa_forward_matches_pallas_kernel(d, n):
    q, k, v = _qkv((2, n, 2, d), seed=d + n)
    want = _jax_flash(q, k, v)
    got = at.flash_sdpa(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (2, n, 2, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("d,n", [(16, 128), (48, 128), (64, 128), (48, 256)])
def test_flash_sdpa_gradients_match_pallas_kernel(d, n):
    shape = (1, n, 2, d)
    q, k, v = _qkv(shape, seed=7 + d)
    cot = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jat._flash_sdpa, *(jnp.asarray(a) for a in (q, k, v)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(at.flash_sdpa(*leaves), leaves, torch.from_numpy(cot))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("shape", [(2, 64, 4, 8), (1, 200, 2, 24), (2, 128, 1, 128)])
def test_sdpa_reference_matches_jax_dot_product_attention(shape):
    q, k, v = _qkv(shape, seed=3)
    want = np.asarray(jax.nn.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v))))
    got = at.sdpa_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("sigma", [1.0, 3.0, 6.0])
def test_bf16_sdpa_reference_matches_jax_dot_product_attention(sigma):
    """bf16 q, k, v: JAX forms the logits in f32 (BF16_BF16_F32) and so must
    the plain version, or its error grows with the logits' scale (3e-2 of the
    largest entry at sigma 3 with the logits rounded to bf16). Held to 5e-3 of
    JAX's largest entry: both round the probabilities and the output to bf16."""
    rng = np.random.default_rng(11)
    shape = (2, 256, 4, 48)
    q, k = (rng.normal(scale=sigma, size=shape).astype(np.float32) for _ in range(2))
    v = rng.normal(size=shape).astype(np.float32)
    want = jax.nn.dot_product_attention(*(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)))
    want = np.asarray(want.astype(jnp.float32))
    got = at.sdpa_reference(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16 and got.shape == shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 5e-3 * np.abs(want).max(), err


def _module_pair(ch, impl, x, seed, dtype=jnp.float32):
    """The JAX and the port's SelfAttention2d on the same (perturbed) params."""
    jmod = jat.SelfAttention2d(num_heads=4, dtype=dtype, attn_impl=impl)
    # every impl shares one param tree; init through xla runs no Pallas kernel
    v = jat.SelfAttention2d(num_heads=4, attn_impl="xla").init(jax.random.key(seed),
                                                               jnp.asarray(x))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.1,
        v["params"])
    from toycrystals_torch.utils.params import torch_state_dict_from_flax

    tmod = at.SelfAttention2d(ch, num_heads=4, attn_impl=impl,
                              dtype=getattr(torch, jnp.dtype(dtype).name))
    tmod.load_state_dict({k: torch.tensor(a)
                          for k, a in torch_state_dict_from_flax(params).items()}, strict=True)
    return jmod, params, tmod


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_module_flash_forward_and_gradients_match_jax():
    """SelfAttention2d(attn_impl="flash") at 16x16 tokens of 64 channels:
    output and the gradient of every parameter under a fixed cotangent."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 16, 64)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jmod, params, tmod = _module_pair(64, "flash", x, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda p: jmod.apply({"params": p}, jnp.asarray(x)), params)
        want_g, = vjp(jnp.asarray(cot))
    got = tmod(_nchw(x))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               atol=ATOL)
    got.backward(_nchw(cot))
    from toycrystals_torch.utils.params import flax_from_torch_state_dict

    got_g = flax_from_torch_state_dict({k: p.grad for k, p in tmod.named_parameters()})
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_g))
    flat_got = jax.tree_util.tree_leaves_with_path(got_g)
    assert len(flat_got) == len(flat_want) == 6
    for path, g in flat_got:
        w = np.asarray(flat_want[path])
        # 1e-5 of the leaf's largest entry: the gradients sum over 512 tokens
        np.testing.assert_allclose(np.asarray(g), w, atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("gain", [2.0, 4.0])
def test_module_bf16_matches_jax(gain):
    """SelfAttention2d in bf16 at 16x16 tokens (the xla path), with the qkv
    kernel scaled by `gain` for logits of trained size. The attention branch
    (output minus input) is held to 1e-2 of JAX's largest entry: both round
    the qkv and proj products to bf16 (2^-8 relative), at other points. With
    the logits rounded to bf16 before the softmax the error is 1.3e-2 at gain
    2 and 5.7e-2 at gain 4."""
    x = np.random.default_rng(8).normal(size=(2, 16, 16, 64)).astype(np.float32)
    jmod, params, tmod = _module_pair(64, "xla", x, seed=4, dtype=jnp.bfloat16)
    params["qkv"]["kernel"] = params["qkv"]["kernel"] * gain
    from toycrystals_torch.utils.params import torch_state_dict_from_flax

    tmod.load_state_dict({k: torch.tensor(a)
                          for k, a in torch_state_dict_from_flax(params).items()}, strict=True)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x))).astype(np.float32) - x
    with torch.no_grad():
        got = tmod(_nchw(x))
    assert got.dtype == torch.float32
    got = got.numpy().transpose(0, 2, 3, 1) - x
    err = np.abs(got - want).max()
    assert err <= 1e-2 * np.abs(want).max(), err


def test_module_auto_on_cpu_runs_matmul_path_at_2304_tokens():
    """48x48 = 2,304 tokens: JAX's auto on the CPU runs its XLA path, and so
    does the port's on a CPU tensor, without raising and without the kernel."""
    x = np.random.default_rng(6).normal(size=(1, 48, 48, 8)).astype(np.float32)
    jmod, params, tmod = _module_pair(8, "auto", x, seed=3)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    before = at.flash_sdpa.launches
    with torch.no_grad():
        got = tmod(_nchw(x))
    assert at.flash_sdpa.launches == before
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=ATOL)


@pytest.mark.parametrize("impl,n,head_dim,device,want", [
    ("auto", 4096, 48, "cuda", "flash"),
    ("auto", 2048, 128, "cuda", "flash"),
    ("auto", 4096, 48, "cpu", "xla"),      # JAX: not on a TPU
    ("auto", 1024, 48, "cuda", "xla"),     # below 2,048 tokens
    ("auto", 3136, 48, "cuda", "xla"),     # 56x56: not a multiple of 128
    ("auto", 2304, 2, "cpu", "xla"),
    ("auto", 4096, 144, "cuda", "xla"),    # head_dim above 128
    ("xla", 4096, 48, "cuda", "xla"),
    ("flash", 256, 16, "cpu", "flash"),
    ("flash", 256, 16, "cuda", "flash"),
])
def test_select_attn_impl(impl, n, head_dim, device, want):
    assert at.select_attn_impl(impl, n, head_dim, device) == want


@pytest.mark.parametrize("case", ["head_dim", "seq_len", "rank", "shape", "dtype", "mixed",
                                  "cpu_to_kernel"])
def test_flash_sdpa_refusals(case):
    def t(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    before = at.flash_sdpa.launches
    if case == "head_dim":
        with pytest.raises(ValueError, match="xla"):
            at.flash_sdpa(*(t((1, 128, 1, 144)) for _ in range(3)))
    elif case == "seq_len":
        with pytest.raises(ValueError, match="xla"):
            at.flash_sdpa(*(t((1, 192, 2, 16)) for _ in range(3)))
    elif case == "rank":
        with pytest.raises(ValueError, match="heads"):
            at.flash_sdpa(*(t((128, 2, 16)) for _ in range(3)))
    elif case == "shape":
        with pytest.raises(ValueError, match="one shape"):
            at.flash_sdpa(t((1, 128, 2, 16)), t((1, 256, 2, 16)), t((1, 128, 2, 16)))
    elif case == "dtype":
        with pytest.raises(TypeError):
            at.flash_sdpa(*(t((1, 128, 2, 16), torch.float16) for _ in range(3)))
    elif case == "mixed":
        with pytest.raises(TypeError):
            at.flash_sdpa(t((1, 128, 2, 16)), t((1, 128, 2, 16), torch.bfloat16),
                          t((1, 128, 2, 16)))
    else:
        with pytest.raises(ValueError, match="CUDA"):
            at._flash_forward_cuda(*(t((1, 128, 2, 16)) for _ in range(3)), 0.25)
    assert at.flash_sdpa.launches == before


def test_kernel_head_dim_is_the_next_multiple_of_16():
    assert [at._kernel_head_dim(d) for d in (1, 16, 24, 48, 49, 100, 128)] == \
        [16, 16, 32, 48, 64, 112, 128]


def test_module_rejects_unknown_impl_and_bf16_flash_runs_on_cpu():
    with pytest.raises(ValueError, match="attn_impl"):
        at.SelfAttention2d(8, attn_impl="pallas")
    m = at.SelfAttention2d(16, num_heads=4, dtype=torch.bfloat16, attn_impl="flash")
    with torch.no_grad():
        y = m(torch.zeros(1, 16, 16, 8, dtype=torch.bfloat16))
    assert y.shape == (1, 16, 16, 8) and torch.isfinite(y.float()).all()
