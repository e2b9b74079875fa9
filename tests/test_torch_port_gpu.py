"""Tests of the port that need the CUDA card (marker `gpu`; they skip without
one). This file imports neither jax nor datr_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q --noconftest
"""

import pytest
import torch

from datr_torch.models.dino import DINO
from datr_torch.ops import _build, gather, msda

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


# ---------------- MSDA backward ----------------


@pytest.mark.parametrize("case", ["random", "integer", "outside"])
@pytest.mark.parametrize("d", [32, 8, 48])
def test_msda_bwd_matches_plain(cuda, case, d):
    value, loc, attn = _inputs(37, 4, d, 3, torch.float32, case)
    g = torch.randn(2, 37, 4 * d, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    before = msda.msda_bwd.launches
    got = msda.msda_bwd(value, SHAPES, loc, attn, g)
    torch.cuda.synchronize()
    assert msda.msda_bwd.launches == before + 1
    want = msda.ms_deform_attn_plain_bwd(value, SHAPES, loc, attn, g)
    for name, a, b in zip(("value", "loc", "attn"), got, want):
        assert a.shape == b.shape
        # f32; grad_value sums atomic adds in run-dependent order
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"grad_{name}: {m}")


def test_dispatcher_on_cuda_keeps_the_gradient(cuda):
    """ms_deform_attn on CUDA tensors that require grad returns an output
    with a grad_fn, and its gradients (through msda_bwd) equal the plain
    version's."""
    value, loc, attn = _inputs(11, 2, 32, 2, torch.float32, "integer")
    leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
    fwd0, bwd0 = msda.msda_fwd.launches, msda.msda_bwd.launches
    out = msda.ms_deform_attn(*leaves[:1], SHAPES, *leaves[1:])
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    out.backward(g)
    assert (msda.msda_fwd.launches, msda.msda_bwd.launches) == (fwd0 + 1,
                                                                bwd0 + 1)
    want = msda.ms_deform_attn_plain_bwd(value, SHAPES, loc, attn, g)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=1e-4, atol=1e-5)


def test_msda_bwd_refuses_bf16(cuda):
    value, loc, attn = _inputs(5, 2, 32, 2, torch.bfloat16, "random")
    g = torch.zeros(2, 5, 64, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        msda.msda_bwd(value, SHAPES, loc, attn, g)


# ---------------- gathers ----------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_row_gather_matches_plain(cuda, dtype, offset):
    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn(300, 128, device="cuda", generator=g).to(dtype)
    idx = torch.randint(0, 299, (1000,), device="cuda", generator=g,
                        dtype=torch.int32)
    before = gather.row_gather.launches
    got = gather.row_gather(table, idx, offset)
    assert gather.row_gather.launches == before + 1
    assert torch.equal(got, gather.row_gather_plain(table, idx, offset))


def test_gather_fma_matches_plain(cuda):
    g = torch.Generator(device="cuda").manual_seed(1)
    table = torch.randn(300, 128, device="cuda", generator=g).to(
        torch.bfloat16)
    idx = torch.randint(0, 300, (1024,), device="cuda", generator=g,
                        dtype=torch.int32)
    w = torch.randn(1024, 1, device="cuda", generator=g)
    before = gather.gather_fma.launches
    got = gather.gather_fma(table, idx, w)
    assert gather.gather_fma.launches == before + 1
    want = gather.gather_fma_plain(table.float(), idx, w)
    # one bf16 rounding of the f32 sum
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -8, atol=1e-5)


def test_gather_fma_refuses_f32(cuda):
    table = torch.zeros(300, 128, device="cuda")
    idx = torch.zeros(16, dtype=torch.int32, device="cuda")
    w = torch.zeros(16, 1, device="cuda")
    before = gather.gather_fma.launches
    with pytest.raises(ValueError, match="bf16"):
        gather.gather_fma(table, idx, w)
    assert gather.gather_fma.launches == before


# ---------------- a training step ----------------


def test_tiny_train_step_cuda_matches_cpu(cuda):
    """One burn-in forward + backward on the card (through msda_fwd and
    msda_bwd) against the same on the CPU (plain versions), with the same
    weights, batch and CDN noise, f32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from datr_torch.models.cdn import cdn_layout, draw_cdn_noise
    from datr_torch.train.criterion import CriterionCfg, build_weight_dict
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state
    from datr_torch.train.steps import loss_and_grads

    kw = dict(num_classes=4, num_queries=12, hidden_dim=32, nheads=2,
              enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=4,
              dn_single_pad=2)
    gen = torch.Generator().manual_seed(2)
    img = torch.randn(4, 64, 96, 3, generator=gen)
    pad = torch.zeros(4, 64, 96, dtype=torch.bool)
    pad[1, 50:] = True
    pad[3, :, 80:] = True
    batch = dict(images=img, pad_mask=pad,
                 boxes=torch.rand(2, 3, 4, generator=gen) * 0.3 + 0.3,
                 labels=torch.randint(0, 4, (2, 3), generator=gen),
                 valid=torch.tensor([[True, True, False], [True] * 3]))
    groups, _ = cdn_layout(4, 2)
    draws = draw_cdn_noise(torch.Generator().manual_seed(3), 2, groups, 2, 4,
                           "cpu")
    ccfg = CriterionCfg(num_classes=4, dn_single_pad=2, dn_groups=groups)
    wd = build_weight_dict(dec_layers=2)
    results = {}
    for dev in ("cpu", "cuda"):
        model = DINO(**kw, use_remat=(dev == "cuda"))
        model.init_params(torch.Generator().manual_seed(0)).to(dev)
        state = create_train_state(model, Optimizer(model))
        b = {k: v.to(dev) for k, v in batch.items()}
        d = type(draws)(*(t.to(dev) for t in draws))
        bwd0 = msda.msda_bwd.launches
        total, losses, _ = loss_and_grads(state, b, ccfg, wd, dn_draws=d)
        if dev == "cuda":  # 2 passes x (1 encoder + 2 decoder) layers
            assert msda.msda_bwd.launches == bwd0 + 6
        results[dev] = (total.item(),
                        {k: v.item() for k, v in losses.items()},
                        {n: p.grad.cpu() for n, p in model.named_parameters()
                         if p.grad is not None})
    (t_c, l_c, g_c), (t_g, l_g, g_g) = results["cpu"], results["cuda"]
    assert l_c.keys() == l_g.keys() and g_c.keys() == g_g.keys()
    assert abs(t_c - t_g) <= 1e-4 * abs(t_c)
    for k in l_c:
        assert abs(l_c[k] - l_g[k]) <= 1e-4 * abs(l_c[k]) + 1e-5, k
    # relative norm, 1e-3 (atomics reorder grad_value's sums); a gradient
    # that is zero in exact arithmetic (a conv bias in front of a GroupNorm
    # of one-channel groups, here over as few as 2 pixels) is rounding noise
    # on both devices and is held to 1e-6 of the whole gradient's norm
    total = torch.stack([g.norm() for g in g_c.values()]).norm().item()
    for n in g_c:
        err = (g_c[n] - g_g[n]).norm().item()
        assert err <= 1e-3 * max(g_c[n].norm().item(), 1e-3 * total), (n, err)
