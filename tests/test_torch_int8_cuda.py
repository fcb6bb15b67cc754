"""The int8 conv on the card (toycrystals_torch/ops/conv.py): `torch._int_mm`
over an im2col against the plain version (the same im2col as an exact f64
product), bit for bit.

Every test here is marked `cuda` and skips without a card. On a machine with
one NVIDIA GPU, run them without tests/conftest.py, which imports JAX (the
port does not need it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_int8_cuda.py -q
"""

import pytest
import torch

from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.ops import conv as tc

pytestmark = pytest.mark.cuda

# (batch, in channels, H, W, out channels, kernel, stride): the score U-Net's
# conv shapes at base_ch 96 and 64x64 (stems none and s2dr), at 4 rows, and
# small shapes that need padding of M (<= 16), K and N (not multiples of 8)
SHAPES = [(4, 17, 64, 64, 96, 3, 1), (4, 96, 64, 64, 96, 4, 2), (4, 384, 32, 32, 96, 3, 1),
          (4, 96, 64, 64, 1, 3, 1), (4, 68, 32, 32, 96, 3, 1), (4, 96, 32, 32, 4, 3, 1),
          (4, 48, 64, 64, 1, 3, 1), (1, 5, 2, 2, 3, 3, 1), (2, 7, 6, 4, 13, 4, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_on_the_card_equals_its_plain_version(cuda, shape, dtype):
    b, c, h, w, o, k, s = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = (torch.randn((b, c, h, w), generator=g, device=cuda) * 2.0).to(dtype)
    conv = tc.CircularConv(c, o, k, s, dtype=dtype, impl="int8").to(cuda)
    with torch.no_grad():
        conv.bias.normal_(generator=g)
        xq, sx = tc.quantize_int8(x)
        wq, sw = tc.quantize_int8(conv.weight, dims=(1, 2, 3))
        xp = tc.wrap_pad(xq)
        before = tc.int8_conv_acc.launches
        acc = tc.int8_conv_acc(xp, wq, s)
        assert tc.int8_conv_acc.launches == before + 1
        ref = tc.int8_conv_acc_reference(xp, wq, s)
        assert acc.dtype == ref.dtype == torch.int32
        assert torch.equal(acc, ref)
        assert torch.equal(acc.cpu(), tc.int8_conv_acc_reference(xp.cpu(), wq.cpu(), s))
        y = conv(x)
        assert y.dtype == dtype
        assert torch.equal(y, tc.dequantize(ref, sx, sw, conv.bias, dtype))
        # the same quantisation and output as the CPU's
        xq_cpu, sx_cpu = tc.quantize_int8(x.cpu())
        assert torch.equal(xq.cpu(), xq_cpu) and torch.equal(sx.cpu(), sx_cpu)
        assert torch.equal(sw.cpu(), tc.quantize_int8(conv.weight.cpu(), dims=(1, 2, 3))[1])
        assert torch.equal(y.cpu(), conv.cpu()(x.cpu()))


def test_int8_unet_forward_on_the_card_runs_the_int_mm_path(cuda):
    torch.manual_seed(0)
    model = tm.CondUNetTiny(4, 4, base_ch=96, emb_dim=128, stem="s2dr", conv_impl="int8",
                            dtype=torch.bfloat16).to(cuda).eval()
    before = tc.int8_conv_acc.launches
    with torch.no_grad():
        y = model(torch.randn(2, 64, 64, 1, device=cuda), torch.full((2,), 0.5, device=cuda),
                  torch.tensor([0, 4], device=cuda), torch.zeros(2, 4, device=cuda))
    assert tc.int8_conv_acc.launches - before == 17  # every conv of the s2dr U-Net
    assert y.shape == (2, 64, 64, 1) and torch.isfinite(y).all()
