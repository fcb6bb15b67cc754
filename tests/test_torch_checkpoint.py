"""The port's checkpoint I/O (toycrystals_torch/utils/msgpack_codec.py,
checkpoint.py, torch_interop.py and the optax layouts of utils/params.py)
against flax.serialization and the JAX package's checkpoints, on the CPU.

Codec and layouts are held bit for bit: the same bytes as
`flax.serialization.msgpack_serialize`, every leaf equal in value, dtype and
shape. The one comparison with a tolerance is the train step after a resume,
which uses the tolerances of tests/test_torch_train_step.py.
"""

import importlib.util
import sys
from pathlib import Path

import flax.serialization as ser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.serve import ScoreModelService
from toycrystals_torch.train import state as ts
from toycrystals_torch.train.steps import make_sde_train_step
from toycrystals_torch.utils import checkpoint as tck
from toycrystals_torch.utils import msgpack_codec as mc
from toycrystals_torch.utils.params import (
    load_flax_params,
    load_train_state_from_checkpoint,
    torch_state_dict_from_flax,
    train_state_to_checkpoint,
)
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.train.state import create_train_state as jax_create_train_state
from toycrystals_tpu.train.steps import make_sde_train_step as jax_make_sde_train_step
from toycrystals_tpu.utils import checkpoint as jck
from toycrystals_tpu.utils.torch_interop import load_torch_score_checkpoint as jax_load_pt

ROOT = Path(__file__).resolve().parent.parent
KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
SIZE = 16
CONFIG = dict(img_ch=1, img_size=SIZE, n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16,
              cond_ch=8, time_ch=8, beta_min=0.1, beta_max=30.0, logsnr_shift=0.0,
              dtype="float32", param="eps", stem="none")


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: x is None)


def _assert_trees_bit_equal(got, want):
    """Same paths; every leaf of the same type, and arrays equal in dtype,
    shape and every bit."""
    lg, lw = _leaves(got), _leaves(want)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (path, a), (_, b) in zip(lg, lw):
        where = jax.tree_util.keystr(path)
        if isinstance(b, (np.ndarray, np.generic)):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == np.shape(b), where
            assert a.tobytes() == np.asarray(b).tobytes(), where
        else:
            assert type(a) is type(b) and a == b, where


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


def test_decoder_matches_msgpack_restore_on_a_jax_written_file():
    """assets/eval/feature_vae_z16.msgpack (10 MB, written by the JAX
    package): every leaf bit-equal to flax's restore, and re-encoding gives
    the file's bytes back."""
    data = (ROOT / "assets/eval/feature_vae_z16.msgpack").read_bytes()
    got, want = mc.unpackb(data), ser.msgpack_restore(data)
    _assert_trees_bit_equal(got, want)
    assert len(_leaves(got)) > 20
    assert mc.packb(got) == data


def _bf16(values):
    a = np.asarray(jnp.asarray(values, jnp.bfloat16))
    return a, mc.Bfloat16Array(a.view(np.uint16))


_r = np.random.default_rng(0)
TREES = {
    "f32": {"w": _r.normal(size=(3, 5)).astype(np.float32)},
    "i32_and_bool": {"i": np.arange(-3, 4, dtype=np.int32), "m": _r.random(7) < 0.5},
    "0-d arrays": {"step": np.asarray(7, np.int32), "flag": np.asarray(True),
                   "x": np.asarray(2.5, np.float32)},
    "bfloat16": "bf16",
    "empty dicts and None": {"0": {}, "1": {"a": {}}, "ema": None},
    "str float int": {"s": "eps", "long": "x" * 40, "wide": "é" * 200, "f": 1.25,
                      "neg": -2.0e-300, "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32,
                                                 2**63, -1, -32, -33, -128, -129, -32768,
                                                 -32769, -2**31, -2**31 - 1, -2**63]},
    "nested and unsorted keys": {"b": {"z": 1, "a": {"y": [1, {"q": 2, "p": 3}]}}, "a": 0},
    "numpy scalars (ext 3)": {"f32": np.float32(1.5), "f64": np.float64(2.0),
                              "i64": np.int64(-5), "b": np.bool_(False)},
    "16 and more entries": {"m": {str(i): i for i in range(20)}, "l": list(range(300)),
                            "bytes": b"\x01" * 300, "big": np.zeros((70, 1000), np.float32)},
    "high rank": {"a": np.zeros((1,) * 17, np.float32), "u8": np.arange(5, dtype=np.uint8)},
}


@pytest.mark.parametrize("name", list(TREES))
def test_encoder_writes_the_bytes_of_msgpack_serialize(name):
    tree = TREES[name]
    if tree == "bf16":
        jax_arr, port_arr = _bf16(_r.normal(size=(4, 3)))
        tree, port_tree = {"p": jax_arr, "n": 3}, {"p": port_arr, "n": 3}
    else:
        port_tree = tree
    want = ser.msgpack_serialize(tree)
    assert mc.packb(port_tree) == want
    back = mc.unpackb(want)
    if name == "bfloat16":
        assert back["p"].bits.tobytes() == port_arr.bits.tobytes()
        np.testing.assert_array_equal(np.asarray(back["p"]), np.asarray(tree["p"], np.float32))
    else:
        _assert_trees_bit_equal(back, ser.msgpack_restore(want))


def test_encoder_rejects_what_strict_types_rejects():
    with pytest.raises(TypeError):
        ser.msgpack_serialize({"t": (1, 2)})
    with pytest.raises(TypeError):
        mc.packb({"t": (1, 2)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_arrays_match_flax(monkeypatch, dtype):
    """Arrays past MAX_CHUNK_SIZE bytes (here made 64) go to flax's
    `__msgpack_chunked_array__` form, with the same bytes, and decode whole."""
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(mc, "MAX_CHUNK_SIZE", 64)
    values = _r.normal(size=(5, 13))
    if dtype == "bfloat16":
        jax_arr, port_arr = _bf16(values)
    else:
        jax_arr = port_arr = values.astype(np.float32)
    want = ser.msgpack_serialize({"w": jax_arr, "small": np.ones(3, np.float32)})
    assert mc.packb({"w": port_arr, "small": np.ones(3, np.float32)}) == want
    assert b"__msgpack_chunked_array__" in want
    back = mc.unpackb(want)
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  np.asarray(ser.msgpack_restore(want)["w"], np.float32))


# ---------------------------------------------------------------------------
# The train state in each optax layout, both ways
# ---------------------------------------------------------------------------

LAYOUTS = ["constant", "warmup", "cosine", "clip", "skip_nonfinite", "clip_cosine_skip"]


def _txs(layout):
    """(optax chain as the JAX CLI builds it, the port's Optimizer) for a
    layout's flags."""
    jlr, plr = 1e-3, 1e-3
    if layout == "warmup":
        jlr, plr = optax.linear_schedule(0.0, 1e-3, 3), ts.linear_schedule(0.0, 1e-3, 3)
    elif "cosine" in layout:
        jlr = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10, 1e-5)
        plr = ts.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10, 1e-5)
    clip = 1.0 if "clip" in layout else 0.0
    skip = 2 if "skip" in layout else 0
    jtx = optax.adam(jlr)
    if clip:
        jtx = optax.chain(optax.clip_by_global_norm(clip), jtx)
    if skip:
        jtx = optax.apply_if_finite(jtx, max_consecutive_errors=skip)
    return jtx, ts.Optimizer(plr, clip_grad_norm=clip, skip_nonfinite=skip)


def _jax_params(seed=0):
    model = jm.CondUNetTiny(**KW)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((2, SIZE, SIZE, 1)),
                            jnp.zeros((2,)), jnp.zeros((2,), jnp.int32), jnp.zeros((2, 4)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                        shapes["params"])


def _random_jax_state(layout, ema, seed=0):
    """A JAX TrainState of the layout with every float leaf random, step and
    counts 7, and one skip in a row of 3 in all."""
    state = jax_create_train_state(_jax_params(seed), _txs(layout)[0], ema=ema)
    rng = np.random.default_rng(seed + 1)

    def fill(path, x):
        x = np.asarray(x)
        if x.dtype == np.float32:
            return rng.normal(size=x.shape).astype(np.float32)
        if x.dtype == np.bool_:
            return np.asarray(False)
        last = path[-1].key
        return np.asarray({"notfinite_count": 1, "total_notfinite": 3}.get(last, 7), x.dtype)

    sd = jax.tree_util.tree_map_with_path(fill, ser.to_state_dict(state))
    return ser.from_state_dict(state, sd)


def _port_state(tx, ema):
    model = tm.CondUNetTiny(**KW)
    return model, ts.create_train_state(model, tx, ema=ema)


def _payload(state):
    return {"epoch_next": 3, "loss_hist": [1.5, 1.25, 1.0], "config": CONFIG, "state": state}


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no_ema"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_jax_checkpoint_loads_into_the_port_bit_for_bit(tmp_path, layout, ema):
    jstate = _random_jax_state(layout, ema)
    path = tmp_path / "jax.msgpack"
    jck.save_checkpoint(path, _payload(jstate))
    raw = tck.load_checkpoint(path)
    assert raw["epoch_next"] == 3 and raw["config"] == CONFIG
    assert list(raw["loss_hist"].values()) == [1.5, 1.25, 1.0]
    tx = _txs(layout)[1]
    _, pstate = _port_state(tx, ema)
    load_train_state_from_checkpoint(pstate, tx, raw["state"])
    assert pstate.step == 7 and pstate.opt_state.count == 7
    if "skip" in layout:
        assert (pstate.opt_state.notfinite_count, pstate.opt_state.total_notfinite) == (1, 3)
    # every tensor of the port against the JAX leaf, through the name map
    opt = jstate.opt_state.inner_state if "skip" in layout else jstate.opt_state
    adam = (opt[1] if "clip" in layout else opt)[0]
    names = list(pstate.params)
    want = {"params": jstate.params, "mu": adam.mu, "nu": adam.nu, "ema": jstate.ema_params}
    got = {"params": pstate.params, "mu": dict(zip(names, pstate.opt_state.mu)),
           "nu": dict(zip(names, pstate.opt_state.nu)), "ema": pstate.ema_params}
    assert (got["ema"] is None) == (not ema)
    for k in (("params", "mu", "nu", "ema") if ema else ("params", "mu", "nu")):
        sd = torch_state_dict_from_flax(want[k])
        assert set(sd) == set(got[k])
        for name, t in got[k].items():
            assert t.dtype == torch.float32
            want_bytes = np.ascontiguousarray(sd[name]).tobytes()
            assert t.detach().numpy().tobytes() == want_bytes, (k, name)
    # and written back by the port, the file is the JAX package's, byte for byte
    tck.save_checkpoint(tmp_path / "port.msgpack",
                        _payload(train_state_to_checkpoint(pstate, tx)))
    assert (tmp_path / "port.msgpack").read_bytes() == path.read_bytes()


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no_ema"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_checkpoint_loads_into_jax_bit_for_bit(tmp_path, layout, ema):
    jtx, tx = _txs(layout)
    _, pstate = _port_state(tx, ema)
    gen = torch.Generator().manual_seed(5)
    tensors = list(pstate.params.values()) + pstate.opt_state.mu + pstate.opt_state.nu + \
        (list(pstate.ema_params.values()) if ema else [])
    with torch.no_grad():
        for t in tensors:
            t.copy_(torch.randn(t.shape, generator=gen))
    pstate.step, pstate.opt_state.count = 9, 9
    pstate.opt_state.notfinite_count, pstate.opt_state.total_notfinite = 2, 4
    path = tmp_path / "port.msgpack"
    ckptr = tck.AsyncCheckpointer()
    with ckptr:
        ckptr.save(path, _payload(train_state_to_checkpoint(pstate, tx)))
    raw = jck.load_checkpoint(path)
    template = jax_create_train_state(_jax_params(), jtx, ema=ema)
    jstate = ser.from_state_dict(template, raw["state"])
    _assert_trees_bit_equal(ser.to_state_dict(jstate), raw["state"])
    assert int(jstate.step) == 9 and jstate.step.dtype == np.int32
    opt = jstate.opt_state
    if "skip" in layout:
        assert (int(opt.notfinite_count), bool(opt.last_finite), int(opt.total_notfinite)) \
            == (2, False, 4)
        assert opt.notfinite_count.dtype == np.int32 and opt.last_finite.dtype == np.bool_
        opt = opt.inner_state
    if "clip" in layout:
        assert ser.to_state_dict(opt[0]) == {}
        opt = opt[1]
    adam, sched = opt
    assert int(adam.count) == 9 and adam.count.dtype == np.int32
    scheduled = layout in ("warmup", "cosine", "clip_cosine_skip")
    assert ser.to_state_dict(sched) == ({"count": np.asarray(9, np.int32)} if scheduled else {})
    names = list(pstate.params)
    trees = {"params": jstate.params, "mu": adam.mu, "nu": adam.nu}
    port = {"params": pstate.params, "mu": dict(zip(names, pstate.opt_state.mu)),
            "nu": dict(zip(names, pstate.opt_state.nu))}
    if ema:
        trees["ema"], port["ema"] = jstate.ema_params, pstate.ema_params
    else:
        assert jstate.ema_params is None
    for k, tree in trees.items():
        sd = torch_state_dict_from_flax(tree)
        assert set(sd) == set(port[k])
        for name, t in port[k].items():
            want_bytes = np.ascontiguousarray(sd[name]).tobytes()
            assert t.detach().numpy().tobytes() == want_bytes, (k, name)


@pytest.mark.parametrize("saved, loaded, flag", [
    ("skip_nonfinite", "constant", "--skip-nonfinite"),
    ("constant", "skip_nonfinite", "--skip-nonfinite"),
    ("clip", "constant", "--clip-grad-norm"),
    ("constant", "clip", "--clip-grad-norm"),
    ("cosine", "constant", "--lr-schedule"),
    ("constant", "warmup", "--warmup-steps"),
])
def test_a_layout_the_flags_do_not_give_raises_naming_the_flag(tmp_path, saved, loaded, flag):
    jck.save_checkpoint(tmp_path / "c.msgpack", _payload(_random_jax_state(saved, True)))
    tx = _txs(loaded)[1]
    _, pstate = _port_state(tx, True)
    with pytest.raises(ValueError, match=flag):
        load_train_state_from_checkpoint(pstate, tx, tck.load_checkpoint(tmp_path / "c.msgpack")
                                         ["state"])


@pytest.mark.parametrize("saved_ema", [True, False])
def test_an_ema_on_one_side_only_raises(tmp_path, saved_ema):
    jck.save_checkpoint(tmp_path / "c.msgpack", _payload(_random_jax_state("constant",
                                                                           saved_ema)))
    tx = _txs("constant")[1]
    _, pstate = _port_state(tx, not saved_ema)
    with pytest.raises(ValueError, match="--ema-decay"):
        load_train_state_from_checkpoint(pstate, tx, tck.load_checkpoint(tmp_path / "c.msgpack")
                                         ["state"])


def test_one_step_after_resuming_a_jax_checkpoint_matches_jax(tmp_path):
    """JAX trains one step and saves; the port resumes from the file; both
    take one more step on JAX's draws. Tolerances of
    tests/test_torch_train_step.py::test_three_train_steps_match_jax: the
    loss 1e-4 relative, the moments (mu 1e-5, nu 1e-7) + 2e-3 of each leaf's
    largest entry, parameters and EMA within lr / 10 where the gradient is
    above noise level."""
    lr, decay, clip = 1e-3, 0.9, 1.0
    r = np.random.default_rng(20)
    batches = [(r.uniform(size=(4, SIZE, SIZE, 1)).astype(np.float32),
                r.integers(0, 4, size=(4,)).astype(np.int32),
                r.normal(size=(4, 4)).astype(np.float32)) for _ in range(2)]
    jmodel = jm.CondUNetTiny(**KW)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(11), jnp.zeros((2, SIZE, SIZE, 1)), jnp.zeros((2,)),
        jnp.zeros((2,), jnp.int32), jnp.zeros((2, 4)))["params"])
    jtx = optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr))
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, params), jtx, ema=True)
    jstep = jax_make_sde_train_step(jmodel, jtx, jm.VPSDE(0.1, 30.0), 4, 0.5, 1.0, decay)
    jstate, _ = jstep(jstate, *(jnp.asarray(a) for a in batches[0]), jax.random.key(30))
    jck.save_checkpoint(tmp_path / "c.msgpack", _payload(jstate))

    tx = ts.Optimizer(lr, clip_grad_norm=clip)
    tmodel, tstate = _port_state(tx, True)
    load_train_state_from_checkpoint(tstate, tx, tck.load_checkpoint(tmp_path / "c.msgpack")
                                     ["state"])
    tstep = make_sde_train_step(tmodel, tx, tm.VPSDE(0.1, 30.0), 4, 0.5, 1.0, decay)
    x0, y_cat, y_cont = batches[1]
    key = jax.random.key(31)
    t, eps, yc, yv = jm.draw_diffusion_loss_noise(jnp.asarray(x0), jnp.asarray(y_cat),
                                                  jnp.asarray(y_cont), key, 4, 0.5)
    jstate, jloss = jstep(jstate, jnp.asarray(x0), jnp.asarray(y_cat), jnp.asarray(y_cont), key)
    tstate, tloss = tstep(tstate, torch.tensor(x0), torch.tensor(np.asarray(yc)),
                          torch.tensor(np.asarray(yv)),
                          noise=(torch.tensor(np.asarray(t)), torch.tensor(np.asarray(eps))))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert tstate.step == int(jstate.step) == 2 and tstate.opt_state.count == 2
    adam = jstate.opt_state[1][0]
    names = list(tstate.params)
    want = {k: torch_state_dict_from_flax(jax.tree.map(np.asarray, v)) for k, v in
            (("mu", adam.mu), ("nu", adam.nu), ("params", jstate.params),
             ("ema", jstate.ema_params))}
    got = {"mu": dict(zip(names, tstate.opt_state.mu)), "nu": dict(zip(names, tstate.opt_state.nu)),
           "params": tstate.params, "ema": tstate.ema_params}
    for k, atol in (("mu", 1e-5), ("nu", 1e-7)):
        for name, w in want[k].items():
            scale = max(float(np.abs(w).max()), 1e-3)
            np.testing.assert_allclose(got[k][name].detach().numpy(), w,
                                       atol=atol + 2e-3 * scale, rtol=0, err_msg=f"{k} {name}")
    compared = 0
    for k in ("params", "ema"):
        for name, mu in want["mu"].items():
            mask = np.abs(mu) >= max(0.1 * float(np.abs(mu).max()), 1e-5)
            compared += int(mask.sum())
            np.testing.assert_allclose(got[k][name].detach().numpy()[mask], want[k][name][mask],
                                       atol=lr / 10, rtol=0, err_msg=f"{k} {name}")
    assert compared > 1000


# ---------------------------------------------------------------------------
# .pt, the async writer, and the consumers' loader
# ---------------------------------------------------------------------------


def test_pt_from_the_export_script_reads_like_jax(tmp_path, monkeypatch):
    """A .pt that scripts/export_torch_checkpoint.py writes from a JAX
    checkpoint: the port's load_score_payload gives the param trees (and
    config, history) of JAX's load_torch_score_checkpoint, bit for bit."""
    jstate = _random_jax_state("constant", True)
    jck.save_checkpoint(tmp_path / "c.msgpack", _payload(jstate))
    spec = importlib.util.spec_from_file_location("export_torch_checkpoint",
                                                  ROOT / "scripts/export_torch_checkpoint.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    monkeypatch.setattr(sys, "argv", ["export", "--ckpt", str(tmp_path / "c.msgpack"),
                                      "--out", str(tmp_path / "c.pt")])
    assert export.main() == 0
    got = tck.load_score_payload(str(tmp_path / "c.pt"))
    want = jax_load_pt(str(tmp_path / "c.pt"))
    _assert_trees_bit_equal(got, want)
    _assert_trees_bit_equal(got["state"]["params"], jax.tree.map(np.asarray, jstate.params))
    assert got["epoch_next"] == 3 and got["config"]["base_ch"] == 8


def test_async_save_copies_the_state_before_it_returns(tmp_path, monkeypatch):
    """The writer thread encodes a host copy: changing the tensors right
    after save() returns does not reach the file."""
    import threading

    t = torch.arange(6, dtype=torch.float32)
    gate = threading.Event()
    real = tck.packb
    monkeypatch.setattr(tck, "packb", lambda tree: (gate.wait(10), real(tree))[1])
    ckptr = tck.AsyncCheckpointer()
    ckptr.save(tmp_path / "a.msgpack", {"t": t, "bf": t.to(torch.bfloat16)})
    t.add_(100.0)
    gate.set()
    ckptr.wait()
    raw = tck.load_checkpoint(tmp_path / "a.msgpack")
    np.testing.assert_array_equal(raw["t"], np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(raw["bf"]), np.arange(6, dtype=np.float32))


def test_a_failed_write_reraises_and_keeps_the_old_file(tmp_path, monkeypatch):
    path = tmp_path / "c.msgpack"
    tck.save_checkpoint(path, {"v": 1})
    ckptr = tck.AsyncCheckpointer()

    def broken(tree):
        raise OSError("disk full")

    monkeypatch.setattr(tck, "packb", broken)
    ckptr.save(path, {"v": 2})
    with pytest.raises(OSError, match="disk full"):
        ckptr.wait()
    ckptr.wait()  # the error is reported once
    assert tck.load_checkpoint(path) == {"v": 1}
    with pytest.raises(OSError, match="disk full"):
        tck.save_checkpoint(path, {"v": 3})
    assert tck.load_checkpoint(path) == {"v": 1}


def test_load_score_payload_refuses_an_orbax_directory(tmp_path):
    """A directory holds the port's DCP checkpoints: an empty one has no
    step, and one that the JAX package's orbax wrote is refused, naming
    msgpack."""
    from toycrystals_tpu.utils import ShardedCheckpointManager

    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        tck.load_score_payload(tmp_path)
    jstate = jax_create_train_state(_jax_params(), optax.adam(1e-3), ema=True)
    with ShardedCheckpointManager(tmp_path / "j.orbax") as mgr:
        mgr.save(1, jstate, {"epoch_next": 1, "loss_hist": [], "config": {}})
    with pytest.raises(NotImplementedError, match="JAX package.*msgpack"):
        tck.load_score_payload(tmp_path / "j.orbax")


def test_service_from_checkpoint(tmp_path):
    """from_checkpoint builds the service of a JAX-written checkpoint with its
    EMA weights; a checkpoint without a config raises, as in JAX."""
    jstate = jax_create_train_state(_jax_params(), optax.adam(1e-3), ema=True)
    jck.save_checkpoint(tmp_path / "c.msgpack", _payload(jstate))
    svc = ScoreModelService.from_checkpoint(str(tmp_path / "c.msgpack"), device="cpu",
                                            steps=2, buckets=(2,))
    model = tm.CondUNetTiny(**KW)
    load_flax_params(model, jax.tree.map(np.asarray, jstate.ema_params))
    for k, v in model.state_dict().items():
        assert torch.equal(svc.model.state_dict()[k], v), k
    x = svc.sample_conditions([0, 1], seed=0)
    assert x.shape == (2, SIZE, SIZE, 1) and np.isfinite(x).all()
    jck.save_checkpoint(tmp_path / "bare.msgpack", {"state": {"params": jstate.params}})
    with pytest.raises(ValueError, match="no embedded config"):
        ScoreModelService.from_checkpoint(str(tmp_path / "bare.msgpack"), device="cpu")
