"""Training under the space axis of the port (toycrystals_torch/parallel/spatial.py,
ops/groupnorm.py, ops/attention.py, train/steps.py and the train CLI's
--shard-space) against the JAX package's GSPMD training on `make_mesh_2d(2, 2)`
of the 8-virtual-device CPU (tests/conftest.py), against `jax.vjp` of the JAX
ops on the whole image, and against the port's own one-process runs, on the CPU.

- One 4-rank gloo job (`parallel.multihost.launch` of `parallel.parity.run_cases`,
  one torch thread per rank) runs on a (data 2, space 2) mesh: one SDE step at
  64x64 for both stems (`none`, `s2dr`) fed JAX's draws, a 256-token v step
  with attention forced to "flash" (on the CPU its plain version at Nq 128
  against Nk 256), a 2-step epoch on rendered 16x16 data, and the gradients of
  the differentiable collectives and of GroupNorm+SiLU under space (pad off and
  on); then the same gradients on a (1, 4) mesh, and one attention block at a
  48x48 bottleneck on that mesh (576 queries per rank: F5).
- The SDE step against JAX's `make_sde_train_step` on its 2x2 mesh: the loss
  within 1e-6 relative; each gradient leaf within 1e-5 + 2e-3 of its largest
  entry (tests/test_torch_train_step.py's limit for the port against JAX: the
  port's one-process step is as far from JAX's, up to 3e-5 of a conv weight's
  largest entry, by XLA's and torch's conv sums); the parameters and the EMA
  after the Adam step within a tenth of the learning rate where the first
  moment is at least a tenth of its leaf's largest (elsewhere a gradient at
  rounding-noise level may take either sign). The steps, the epoch and the
  attention block against one process with no mesh: the loss within 1e-6
  relative, each gradient leaf within 1e-5 of its largest entry plus 1e-6 of
  the step's largest gradient (tests/test_torch_parallel.py's limits: leaves
  whose true gradient is 0, the biases ahead of a GroupNorm and the
  conditioning path, hold rounding noise of 1e-7 to 3e-7 that the ranks' sums
  over half images order otherwise).
- Each collective's gradient against the one-process autograd gradient of the
  unsharded op (a wrapped or edge-replicated pad, a sum, a concatenation) and
  against `jax.vjp` of the same op in jnp, exactly up to f32 sums; GroupNorm+SiLU
  against `jax.vjp` of JAX's `gn_silu` (its Pallas kernel in interpret mode, its
  custom VJP) and against `gn_silu_backward_reference` on the whole image, at
  f32 atol 2e-5 (tests/test_torch_gn_silu.py).
- The attention rule (F5): auto picks the backend on the whole image's tokens
  and runs the plain version where the rank's own queries are no multiple of 128.
- The train CLI with --shard-space 2 on the CPU: two epochs whose losses equal
  one process's, a DCP resume that continues bit for bit, and a msgpack
  checkpoint that the JAX package reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.ops import attention as at
from toycrystals_torch.ops import groupnorm as tgn
from toycrystals_torch.parallel import launch
from toycrystals_torch.parallel.parity import run_cases
from toycrystals_torch.utils.params import flax_from_torch_state_dict, torch_state_dict_from_flax
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.ops.groupnorm import gn_silu as jax_gn_silu
from toycrystals_tpu.parallel import data_sharding, replicate
from toycrystals_tpu.parallel import spatial as jspatial
from toycrystals_tpu.train.state import create_train_state as jax_create_train_state
from toycrystals_tpu.train.steps import make_sde_train_step as jax_make_sde_train_step

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
SIZE, B = 64, 4
LR, DECAY, P_UNCOND = 1e-3, 0.9, 0.5
LOSS_RTOL, LEAF, FLOOR = 1e-6, 1e-5, 1e-6   # FLOOR: a share of the step's largest gradient
GN_ATOL = 2e-5                   # tests/test_torch_gn_silu.py
MESH = (2, 2)
# the collectives' and GroupNorm's inputs: x [GB, GC, GH, GW], tokens [GB, GN, 2, 4]
GB, GC, GH, GW, GROUPS, GN = 2, 8, 16, 6, 4, 32
ATTN_CH, ATTN_SIDE = 8, 48


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in-process, as each spawned rank runs (beside other
    pytest-xdist workers a pool of threads runs these small steps slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_dict(seed, **kw):
    model = flax_default_init(tm.CondUNetTiny(**KW, **kw), np.random.default_rng(seed))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _keep_grads():
    """An optax stage whose state is the gradient it passes on."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def _batch(seed):
    r = np.random.default_rng(seed)
    return (r.uniform(size=(B, SIZE, SIZE, 1)).astype(np.float32),
            r.integers(0, 4, size=(B,)).astype(np.int32),
            r.normal(size=(B, 4)).astype(np.float32))


def _jax_sde_case(stem, seed):
    """One JAX step on make_mesh_2d(2, 2) (images by data and space,
    conditions by data, the state replicated; p_uncond 0.5, EMA 0.9), its
    gradients kept by the optimizer, and the draws its key makes."""
    sd = _state_dict(seed, stem=stem)
    mesh = jspatial.make_mesh_2d(*MESH)
    jtx = optax.chain(_keep_grads(), optax.adam(LR))
    state = jax_create_train_state(jax.tree.map(jnp.asarray, flax_from_torch_state_dict(sd)),
                                   jtx, ema=True)
    state = replicate(mesh, state)
    step = jax_make_sde_train_step(jm.CondUNetTiny(**KW, stem=stem), jtx, jm.VPSDE(0.1, 30.0),
                                   4, P_UNCOND, 1.0, DECAY)
    x0, y_cat, y_cont = _batch(seed + 1)
    key = jax.random.key(seed + 2)
    t, eps, yc, yv = jm.draw_diffusion_loss_noise(jnp.asarray(x0), jnp.asarray(y_cat),
                                                  jnp.asarray(y_cont), key, 4, P_UNCOND)
    state, loss = step(state, jax.device_put(x0, jspatial.image_sharding(mesh)),
                       jax.device_put(y_cat, data_sharding(mesh, 1)),
                       jax.device_put(y_cont, data_sharding(mesh, 2)), key)
    case = dict(kind="sde", model=dict(KW, stem=stem), state_dict=sd,
                opt={"lr": LR, "ema": DECAY}, x0=x0[None], y_cat=np.array(yc)[None],
                y_cont=np.array(yv)[None], t=np.array(t)[None], eps=np.array(eps)[None])
    want = {"losses": [float(loss)],
            "grads": torch_state_dict_from_flax(_np(state.opt_state[0])),
            "params": torch_state_dict_from_flax(_np(state.params)),
            "ema": torch_state_dict_from_flax(_np(state.ema_params)),
            "mu": torch_state_dict_from_flax(_np(state.opt_state[1][0].mu))}
    return case, want


def _flash_case():
    """A v step at 64x64 (256 bottleneck tokens) with attention forced to flash."""
    x0, y_cat, y_cont = _batch(31)
    r = np.random.default_rng(32)
    return dict(kind="sde", model=dict(KW, attn_impl="flash"), param="v",
                state_dict=_state_dict(33), opt={"lr": LR}, x0=x0[None], y_cat=y_cat[None],
                y_cont=y_cont[None], t=r.uniform(0.05, 0.95, (1, B)).astype(np.float32),
                eps=r.normal(size=(1, B, SIZE, SIZE, 1)).astype(np.float32))


def _grads_case(n_space, seed):
    """Inputs and per-space-rank upstream gradients of the collectives' case."""
    r = np.random.default_rng(seed)
    h = GH // n_space

    def f(*shape):
        return r.normal(size=shape).astype(np.float32)

    return dict(kind="space_grads", mesh=[4 // n_space, n_space], groups=GROUPS,
                x=f(GB, GC, GH, GW) * 2.0 + 0.5, scale=f(GC) * 0.1 + 1.0, bias=f(GC) * 0.1,
                v=f(n_space, 3, 4, 2), t=f(GB, GN, 2, 4),
                cot_halo_wrap=f(n_space, GB, GC, h + 2, GW),
                cot_halo_clamp=f(n_space, GB, GC, h + 2, GW), cot_sum=f(n_space, 3, 4, 2),
                cot_gather=f(n_space, GB, GN, 2, 4), cot_gn_pad0=f(n_space, GB, GC, h, GW),
                cot_gn_pad1=f(n_space, GB, GC, h + 2, GW + 2))


def _attention_case():
    block = at.SelfAttention2d(ATTN_CH, num_heads=4, attn_impl="auto")
    r = np.random.default_rng(41)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy(r.normal(size=tuple(p.shape)).astype(np.float32) * 0.3))
    return dict(kind="attention", mesh=[1, 4],
                model=dict(ch=ATTN_CH, num_heads=4, attn_impl="auto"),
                state_dict={k: v.numpy() for k, v in block.state_dict().items()},
                x=r.normal(size=(1, ATTN_CH, ATTN_SIDE, ATTN_SIDE)).astype(np.float32),
                cot=r.normal(size=(1, ATTN_CH, ATTN_SIDE, ATTN_SIDE)).astype(np.float32))


@pytest.fixture(scope="module")
def suite():
    cases, jax_out = {}, {}
    for i, stem in enumerate(("none", "s2dr")):
        cases[f"sde_{stem}"], jax_out[f"sde_{stem}"] = _jax_sde_case(stem, 10 * i + 1)
    cases["sde_flash_v"] = _flash_case()
    cases["epoch"] = dict(kind="epoch", model=KW, state_dict=_state_dict(51), opt={"lr": LR},
                          lattice=dict(img_size=16, n_types=4, rot_only=True), seed=52,
                          batch=B, items=2 * B)
    cases["grads_s2"] = _grads_case(2, 61)
    cases["grads_s4"] = _grads_case(4, 62)
    cases["attention"] = _attention_case()
    return {"cases": cases, "jax": jax_out}


@pytest.fixture(scope="module")
def four_ranks(suite):
    """Every case in one 4-rank gloo job: a (data 2, space 2) mesh unless the
    case names its own."""
    names = list(suite["cases"])
    out = launch(run_cases, 4, ({"device": "cpu", "mesh": list(MESH),
                                 "cases": list(suite["cases"].values())},), timeout=300)
    return [dict(zip(names, rank)) for rank in out]


@pytest.fixture(scope="module")
def one_process(suite):
    cases = {k: v for k, v in suite["cases"].items() if not k.startswith("grads")}
    return dict(zip(cases, run_cases({"device": "cpu", "cases": list(cases.values())})))


def _hold_grads(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        lim = LEAF * float(np.abs(w).max()) + FLOOR * top + 1e-12
        np.testing.assert_allclose(got[k], w, rtol=0, atol=lim, err_msg=f"{what} {k}")


def _hold_params(got: dict, want: dict, mu: dict, what: str) -> None:
    compared = 0
    for k, m in mu.items():
        mask = np.abs(m) >= max(0.1 * float(np.abs(m).max()), 1e-5)
        compared += int(mask.sum())
        np.testing.assert_allclose(got[k][mask], want[k][mask], atol=LR / 10, rtol=0,
                                   err_msg=f"{what} {k}")
    assert compared > 1000


@pytest.mark.parametrize("stem", ["none", "s2dr"])
def test_sde_step_on_2x2_matches_jax_on_its_2x2_mesh(suite, four_ranks, stem):
    got, want = four_ranks[0][f"sde_{stem}"], suite["jax"][f"sde_{stem}"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        lim = 1e-5 + 2e-3 * max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(got["grads"][k], w, rtol=0, atol=lim, err_msg=f"{stem} {k}")
    _hold_params(got["params"], want["params"], want["mu"], f"{stem} params")
    _hold_params(got["ema"], want["ema"], want["mu"], f"{stem} ema")


@pytest.mark.parametrize("name", ["sde_none", "sde_s2dr", "sde_flash_v", "epoch"])
def test_2x2_training_matches_one_process(four_ranks, one_process, name):
    got, want = four_ranks[0][name], one_process[name]
    if name == "epoch":
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        assert len(got["grads"]) == len(want["grads"]) == 2
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            _hold_grads(g, w, f"epoch step {i}")
        return
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    _hold_grads(got["grads"], want["grads"], name)
    _hold_params(got["params"], want["params"], want["mu"], f"{name} params")


def test_every_rank_holds_the_same_state(four_ranks):
    for name in ("sde_none", "sde_s2dr", "sde_flash_v", "epoch"):
        for other in four_ranks[1:]:
            for part in ("params", "grads"):
                got = other[name][part]
                for i, tree in enumerate(got if isinstance(got, list) else [got]):
                    want = four_ranks[0][name][part]
                    want = want[i] if isinstance(want, list) else want
                    for k, v in tree.items():
                        np.testing.assert_array_equal(v, want[k], err_msg=f"{name} {part} {k}")


def test_the_space_path_ran_the_plain_kernels_here(four_ranks):
    """On the CPU the wrappers run their plain versions and count nothing."""
    for name, res in four_ranks[0].items():
        assert not any(res["launches"].values()), (name, res["launches"])


# ---------------------------------------------------------------------------
# the collectives and GroupNorm+SiLU, against the whole image
# ---------------------------------------------------------------------------


def _ranks_of(suite, four_ranks, case):
    """The results of the space ranks s = 0 .. S - 1 of data rank 0 (global
    ranks 0 .. S - 1: "space" varies fastest)."""
    return [four_ranks[s][case] for s in range(suite["cases"][case]["mesh"][1])]


def _windows(n_space):
    """Rows [s h, s h + h + 2) of a plane padded by one row: rank s's padded rows."""
    h = GH // n_space
    return [slice(s * h, s * h + h + 2) for s in range(n_space)]


def _torch_whole(case, op):
    """The one-process gradient of sum_s <cot_s, rank s's output> for `op`."""
    n = case["v"].shape[0]
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    if op in ("halo_wrap", "halo_clamp"):
        above, below = (x[:, :, -1:], x[:, :, :1]) if op == "halo_wrap" else \
            (x[:, :, :1], x[:, :, -1:])
        padded = torch.cat([above, x, below], dim=2)
        loss = sum((padded[:, :, w] * torch.from_numpy(case[f"cot_{op}"][s])).sum()
                   for s, w in enumerate(_windows(n)))
        loss.backward()
        return x.grad.numpy()
    if op == "space_sum":
        v = torch.from_numpy(case["v"]).requires_grad_(True)
        (v.sum(0)[None] * torch.from_numpy(case["cot_sum"])).sum().backward()
        return v.grad.numpy()
    t = torch.from_numpy(case["t"]).requires_grad_(True)
    (t[None] * torch.from_numpy(case["cot_gather"])).sum().backward()
    return t.grad.numpy()


def _jax_whole(case, op):
    """The same gradient by `jax.vjp` of the op written in jnp."""
    n = case["v"].shape[0]
    if op in ("halo_wrap", "halo_clamp"):
        mode = "wrap" if op == "halo_wrap" else "edge"

        def fn(x):
            padded = jnp.pad(x, ((0, 0), (0, 0), (1, 1), (0, 0)), mode=mode)
            return jnp.stack([padded[:, :, w] for w in _windows(n)])

        _, vjp = jax.vjp(fn, jnp.asarray(case["x"]))
        return np.asarray(vjp(jnp.asarray(case[f"cot_{op}"]))[0])
    if op == "space_sum":
        _, vjp = jax.vjp(lambda v: jnp.broadcast_to(v.sum(0), v.shape), jnp.asarray(case["v"]))
        return np.asarray(vjp(jnp.asarray(case["cot_sum"]))[0])
    _, vjp = jax.vjp(lambda t: jnp.broadcast_to(t, (n, *t.shape)), jnp.asarray(case["t"]))
    return np.asarray(vjp(jnp.asarray(case["cot_gather"]))[0])


def _mesh_whole(ranks, op, n):
    """The mesh's gradient of the whole input: x by rows, tokens by share, and
    a per-rank input stacked."""
    parts = [r[op] for r in ranks]
    if op.startswith("halo"):
        return np.concatenate(parts, axis=2)
    if op == "gather":
        return np.concatenate(parts, axis=1)
    return np.stack(parts)


@pytest.mark.parametrize("op", ["halo_wrap", "halo_clamp", "space_sum", "gather"])
@pytest.mark.parametrize("case", ["grads_s2", "grads_s4"])
def test_collective_backwards_are_the_whole_image_gradients(suite, four_ranks, case, op):
    spec = suite["cases"][case]
    ranks = _ranks_of(suite, four_ranks, case)
    got = _mesh_whole(ranks, op, len(ranks))
    name = "gather" if op == "gather" else op
    np.testing.assert_allclose(got, _torch_whole(spec, name), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, _jax_whole(spec, name), rtol=0, atol=1e-6)


def _gn_whole_cot(spec, pad):
    """The whole padded plane's upstream gradient: each rank's added at its rows."""
    n = spec["v"].shape[0]
    h = GH // n
    cot = spec[f"cot_gn_pad{int(pad)}"]
    if not pad:
        return np.concatenate(list(cot), axis=2)
    whole = np.zeros((GB, GC, GH + 2, GW + 2), np.float32)
    for s in range(n):
        whole[:, :, s * h:s * h + h + 2] += cot[s]
    return whole


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("case", ["grads_s2", "grads_s4"])
def test_gn_silu_space_backward_is_jax_vjp_on_the_whole_image(suite, four_ranks, case, pad):
    spec = suite["cases"][case]
    ranks = _ranks_of(suite, four_ranks, case)
    key = f"gn_pad{int(pad)}"
    dx = np.concatenate([r[key][0] for r in ranks], axis=2)
    dscale = sum(r[key][1] for r in ranks)
    dbias = sum(r[key][2] for r in ranks)
    cot = _gn_whole_cot(spec, pad)
    x_nhwc = jnp.asarray(spec["x"].transpose(0, 2, 3, 1))
    _, vjp = jax.vjp(lambda x, s, b: jax_gn_silu(x, s, b, GROUPS, 1e-6, pad), x_nhwc,
                     jnp.asarray(spec["scale"]), jnp.asarray(spec["bias"]))
    jdx, jds, jdb = (np.asarray(a) for a in vjp(jnp.asarray(cot.transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(dx, jdx.transpose(0, 3, 1, 2), rtol=0, atol=GN_ATOL)
    np.testing.assert_allclose(dscale, jds, rtol=0, atol=GN_ATOL)
    np.testing.assert_allclose(dbias, jdb, rtol=0, atol=GN_ATOL)
    wx, ws, wb = tgn.gn_silu_backward_reference(
        torch.from_numpy(spec["x"]), torch.from_numpy(spec["scale"]),
        torch.from_numpy(spec["bias"]), torch.from_numpy(cot), GROUPS, pad=pad)
    np.testing.assert_allclose(dx, wx.numpy(), rtol=0, atol=GN_ATOL)
    np.testing.assert_allclose(dscale, ws.numpy(), rtol=0, atol=GN_ATOL)
    np.testing.assert_allclose(dbias, wb.numpy(), rtol=0, atol=GN_ATOL)


def test_gn_silu_backward_pair_is_the_closed_form_in_one_process():
    """The plain versions of the two backward kernels, with no mesh (the
    group's sums added in this process), give `gn_silu_backward_reference`."""
    r = np.random.default_rng(71)
    for pad in (False, True):
        x = torch.from_numpy(r.normal(size=(2, 8, 5, 7)).astype(np.float32) * 2 + 0.5)
        sc, bi = (torch.from_numpy(r.normal(size=8).astype(np.float32)) for _ in range(2))
        g = torch.from_numpy(r.normal(size=(2, 8, 5 + 2 * pad, 7 + 2 * pad)).astype(np.float32))
        sums = tgn.gn_sums_reference(x, 4)
        count = 2 * 5 * 7
        edge = None
        if pad:  # one rank: its own wrap returns the halo rows' gradients
            edge = torch.cat([g[:, :, -1:], g[:, :, :1]], dim=2)
        chan = tgn.gn_silu_backward_sums_reference(x, g, edge, sums, count, sc, bi, 4, pad=pad)
        dsums = (chan * sc.reshape(1, -1, 1)).reshape(2, 4, 2, 2).sum(dim=2)
        dx = tgn.gn_silu_backward_apply_reference(x, g, edge, sums, dsums, count, sc, bi, 4,
                                                  pad=pad)
        wx, ws, wb = tgn.gn_silu_backward_reference(x, sc, bi, g, 4, pad=pad)
        torch.testing.assert_close(dx, wx, atol=1e-5, rtol=0)
        torch.testing.assert_close(chan.sum(0)[:, 1], ws, atol=1e-5, rtol=0)
        torch.testing.assert_close(chan.sum(0)[:, 0], wb, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# attention under space: the rule (F5) and a block at 576 queries per rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side, n_space, want", [
    (48, 4, "xla"), (48, 8, "xla"), (64, 64, "xla"), (64, 2, "flash"), (64, 1, "flash"),
    (56, 1, "xla")])
def test_attention_backend_follows_the_whole_image(side, n_space, want):
    """192x192 at S = 4 and 8, 256x256 at S = 64 (bottlenecks 48x48 and 64x64):
    the rank's queries are no multiple of 128, so auto runs the plain version;
    256x256 at S = 2 and unsharded take the kernel; 224x224 (3,136 tokens) stays
    plain. A forced backend is taken as given: forced flash goes to `flash_sdpa`,
    which refuses a count the kernel cannot take."""
    n = side * side
    assert at.attn_backend("auto", n, n // n_space, 24, "cuda") == want
    assert at.attn_backend("flash", n, n // n_space, 24, "cuda") == "flash"
    assert at.attn_backend("xla", n, n // n_space, 24, "cuda") == "xla"
    assert at.attn_backend("auto", n, n // n_space, 24, "cpu") == "xla"


def test_attention_block_at_576_queries_per_rank_matches_one_process(suite, four_ranks,
                                                                     one_process):
    """attn_impl "auto" at a 48x48 bottleneck on a (1, 4) mesh: each rank's
    576 queries run the plain version against the 2,304 gathered keys (the
    kernel takes no such count; on the card auto picks the plain version by
    the rule above, here by the device), and the output and every gradient
    are the one-process block's."""
    ranks = _ranks_of(suite, four_ranks, "attention")
    want = one_process["attention"]
    out = np.concatenate([r["out"] for r in ranks], axis=2)
    dx = np.concatenate([r["dx"] for r in ranks], axis=2)
    np.testing.assert_allclose(out, want["out"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(dx, want["dx"], rtol=0,
                               atol=LEAF * float(np.abs(want["dx"]).max()) + 1e-12)
    _hold_grads({k: sum(r["grads"][k] for r in ranks) for k in want["grads"]},
                want["grads"], "attention")


# ---------------------------------------------------------------------------
# the train CLI with --shard-space 2
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--procedural", "--img-size", "16", "--base-ch", "8",
        "--emb-dim", "16", "--n-samples", "16", "--batch-size", "8", "--sample-every", "2",
        "--sample-steps", "2", "--ema-decay", "0.9", "--p-uncond", "0.5"]


def _losses(run_dir):
    import json

    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return [r["epoch"] for r in rows], [r["loss"] for r in rows]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One process for 2 epochs; --shard-space 2 for 2 epochs (msgpack); and
    --shard-space 2 with DCP checkpoints for 1 epoch, then --resume to 2."""
    from toycrystals_torch.scripts import train_sde_score_model as train_cli

    base = tmp_path_factory.mktemp("space_cli")
    one = train_cli.train(TINY + ["--epochs", "2", "--out-dir", str(base / "one")])
    space = ["--shard-space", "2"]
    assert train_cli.main(TINY + space + ["--epochs", "2", "--out-dir", str(base / "two")]) == 0
    dcp = space + ["--ckpt-format", "orbax", "--out-dir", str(base / "dcp")]
    assert train_cli.main(TINY + dcp + ["--epochs", "1"]) == 0
    assert train_cli.main(TINY + dcp + ["--epochs", "2", "--resume"]) == 0
    return base, one


def test_train_cli_on_two_space_ranks_trains_the_one_process_epochs(cli_runs):
    base, one = cli_runs
    epochs, losses = _losses(base / "two")
    assert epochs == [1, 2]
    np.testing.assert_allclose(losses, one.loss_hist, rtol=LOSS_RTOL)
    assert sorted(p.name for p in (base / "two" / "results").iterdir()) == [
        "sde_samples_epoch_002.png"]


def test_train_cli_resumes_on_two_space_ranks_through_dcp_bit_for_bit(cli_runs):
    base, _ = cli_runs
    assert _losses(base / "dcp") == _losses(base / "two")
    assert sorted(p.name for p in (base / "dcp" / "checkpoints").iterdir()) == [
        "sde_score_model_last.orbax"]


def test_the_space_runs_msgpack_is_read_by_the_jax_package(cli_runs):
    from toycrystals_tpu.utils import checkpoint as jck

    base, one = cli_runs
    raw = jck.load_checkpoint(str(base / "two" / "checkpoints" / "sde_score_model_last.msgpack"))
    assert raw["epoch_next"] == 2 and raw["config"] == one.config
    ref = jck.load_checkpoint(str(base / "one" / "checkpoints" / "sde_score_model_last.msgpack"))
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(raw["state"])] == [p for p, _ in flat(ref["state"])]
    assert int(raw["state"]["step"]) == 4
    hist = [raw["loss_hist"][k] for k in sorted(raw["loss_hist"], key=int)]  # msgpack's dict
    np.testing.assert_allclose(hist, one.loss_hist, rtol=LOSS_RTOL)
