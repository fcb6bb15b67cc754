"""The flax <-> port weight bridge (toycrystals_torch/utils/params.py), and the
rule that the port imports no JAX and nothing of the JAX package."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.utils import params as bridge
from toycrystals_tpu.models.sde_score_model import CondUNetTiny as JaxUNet

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
ROOT = Path(__file__).resolve().parent.parent


def _flax_params(stem, seed=0):
    """The flax param tree of the JAX U-Net (shapes from eval_shape), filled
    with numpy draws."""
    model = JaxUNet(**KW, stem=stem)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((2, 16, 16, 1)),
                            jnp.zeros((2,)), jnp.zeros((2,), jnp.int32), jnp.zeros((2, 4)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                        shapes["params"])


@pytest.mark.parametrize("stem", ["none", "s2d", "s2dr"])
def test_round_trip_is_bit_exact(stem):
    params = _flax_params(stem)
    sd = bridge.torch_state_dict_from_flax(params)
    back = bridge.flax_from_torch_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # through a torch module and back, too
    model = tm.CondUNetTiny(**KW, stem=stem)
    bridge.load_flax_params(model, params)
    again = bridge.flax_from_torch_state_dict(model.state_dict())
    for path, a in flat_a:
        np.testing.assert_array_equal(a, dict(jax.tree_util.tree_leaves_with_path(again))[path])


def test_layouts_and_names():
    params = _flax_params("s2dr")
    sd = bridge.torch_state_dict_from_flax(params)
    np.testing.assert_array_equal(sd["down1.conv0.weight"],
                                  params["down1"]["conv0"]["kernel"].transpose(3, 2, 0, 1))
    assert sd["down1.conv0.weight"].shape == (8, 68, 3, 3)  # s2d trunk: 4 x 17 channels
    np.testing.assert_array_equal(sd["attn.qkv.weight"], params["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(sd["up1.gn1.weight"], params["up1"]["gn1"]["scale"])
    np.testing.assert_array_equal(sd["ConditionEmbedding_0.cat_emb.weight"],
                                  params["ConditionEmbedding_0"]["cat_emb"]["embedding"])
    assert sd["out.weight"].shape == (4, 8, 3, 3)
    assert sd["refine1.weight"].shape == (4, 18, 3, 3) and sd["refine2.weight"].shape[0] == 1
    with pytest.raises(KeyError):
        bridge.torch_state_dict_from_flax({"x": {"mystery": np.zeros(2)}})


def test_strict_load_rejects_another_stem():
    with pytest.raises(RuntimeError):
        bridge.load_flax_params(tm.CondUNetTiny(**KW, stem="none"), _flax_params("s2dr"))


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "for banned in ('jax', 'flax', 'optax', 'msgpack', 'matplotlib', 'toycrystals_tpu'):\n"
        "    sys.modules[banned] = None\n"
        "import toycrystals_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(toycrystals_torch.__path__,\n"
        "                                               'toycrystals_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for must in ('serve', 'data.lattice', 'data.rasterize', 'data.datasets',\n"
        "             'models.flow_matching', 'models.torch_init', 'train.state',\n"
        "             'train.steps', 'utils.params', 'utils.cuda_build',\n"
        "             'ops.attention', 'ops.groupnorm', 'ops.conv',\n"
        "             'models.sde_score_model', 'utils.msgpack_codec',\n"
        "             'utils.checkpoint', 'utils.torch_interop', 'utils.metrics',\n"
        "             'utils.preempt', 'utils.figures', 'scripts._common',\n"
        "             'scripts.train_sde_score_model', 'scripts.sample_sde_score_model'):\n"
        "    assert 'toycrystals_torch.' + must in names, (must, names)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 19


def test_state_dict_values_load_as_f32_tensors():
    sd = bridge.torch_state_dict_from_flax(_flax_params("none"))
    t = torch.from_numpy(sd["Dense_0.weight"])
    assert t.dtype == torch.float32 and t.shape == (16, 16)


def test_no_port_source_names_a_jax_package():
    """Every module of the port and chip_smoke.py: no import of jax, flax,
    optax, msgpack, matplotlib or the JAX package, not even inside a function."""
    import re

    banned = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|msgpack|matplotlib|toycrystals_tpu)\b", re.M)
    files = sorted((ROOT / "toycrystals_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for f in files:
        assert not banned.search(f.read_text()), f
