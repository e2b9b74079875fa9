"""Tests of the port that need the CUDA card (marker `gpu`; they skip without
one). This file imports neither jax nor datr_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q --noconftest
"""

import pytest
import torch

from datr_torch.models.dino import DINO
from datr_torch.ops import _build, msda

pytestmark = pytest.mark.gpu

SHAPES = ((20, 34), (10, 17), (5, 9), (3, 5))
S = sum(h * w for h, w in SHAPES)
L = len(SHAPES)


@pytest.fixture
def cuda():
    """Decided when the test runs, never at import (xdist workers must all
    collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(lq, h, d, p, dtype, case, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    value = torch.randn(2, S, h, d, device="cuda", generator=g).to(dtype)
    attn = torch.rand(2, lq, h, L, p, device="cuda", generator=g)
    attn = (attn / attn.sum((-1, -2), keepdim=True)).contiguous()
    loc = torch.rand(2, lq, h, L, p, 2, device="cuda", generator=g)
    if case == "outside":
        loc = loc * 1.6 - 0.3
    elif case == "integer":
        wh = torch.tensor([(w, hh) for hh, w in SHAPES], device="cuda")
        ij = (loc * (wh + 2)[:, None, :]).floor() - 1
        loc = (ij + 0.5) / wh[:, None, :]
    return value, loc.contiguous(), attn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "integer", "outside"])
@pytest.mark.parametrize("d", [32, 8, 48])
def test_kernel_matches_plain(cuda, dtype, case, d):
    value, loc, attn = _inputs(37, 4, d, 3, dtype, case)
    got = msda.msda_fwd(value, SHAPES, loc, attn)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, 37, 4 * d)
    want = msda.ms_deform_attn_plain(value.float(), SHAPES, loc, attn)
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2.0 ** -8, atol=1e-5))  # one bf16 rounding
    torch.testing.assert_close(got.float(), want, **tol)


def test_dispatcher_launches_kernel_on_cuda(cuda):
    value, loc, attn = _inputs(5, 2, 32, 2, torch.float32, "random")
    before = msda.msda_fwd.launches
    out = msda.ms_deform_attn(value, SHAPES, loc, attn)
    assert out.is_cuda and msda.msda_fwd.launches == before + 1


def test_wrapper_rejects_bad_inputs(cuda):
    value, loc, attn = _inputs(5, 2, 32, 2, torch.float32, "random")
    with pytest.raises(ValueError, match="contiguous"):
        msda.msda_fwd(value.transpose(1, 2).contiguous().transpose(1, 2),
                      SHAPES, loc, attn)
    with pytest.raises(ValueError, match="float32"):
        msda.msda_fwd(value, SHAPES, loc.double(), attn)
    with pytest.raises(ValueError, match="spatial_shapes"):
        msda.msda_fwd(value, SHAPES[:-1] + ((3, 6),), loc, attn)


def test_broken_source_raises(cuda, tmp_path):
    """A kernel that does not compile raises; nothing falls back."""
    bad = tmp_path / "broken.cu"
    bad.write_text("__global__ void k( { }\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build([bad], out_dir=tmp_path / "out")


def test_tiny_dino_cuda_matches_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = DINO(num_classes=4, num_queries=12, hidden_dim=32, nheads=2,
                 enc_layers=1, dec_layers=2, dim_feedforward=64)
    model.init_params(torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    img = torch.randn(2, 96, 128, 3, generator=g)
    pad = torch.zeros(2, 96, 128, dtype=torch.bool)
    pad[0, 70:] = True
    with torch.no_grad():
        want = model(img, pad)
        before = msda.msda_fwd.launches
        got = model.to(cuda)(img.to(cuda), pad.to(cuda))
    assert msda.msda_fwd.launches == before + 3  # 1 encoder + 2 decoder
    assert torch.equal(got["topk_idx"].cpu(), want["topk_idx"])
    torch.testing.assert_close(got["pred_logits"].cpu(), want["pred_logits"],
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(got["pred_boxes"].cpu(), want["pred_boxes"],
                               rtol=0, atol=1e-5)
