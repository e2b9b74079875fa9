"""Tests of the port that need the CUDA card (marker `gpu`; they skip without
one). This file imports neither jax nor datr_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q --noconftest
"""

import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

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


def _inputs(lq, h, d, p, dtype, case, seed=0, shapes=SHAPES):
    g = torch.Generator(device="cuda").manual_seed(seed)
    s_tok, n_l = sum(hh * w for hh, w in shapes), len(shapes)
    value = torch.randn(2, s_tok, h, d, device="cuda", generator=g).to(dtype)
    attn = torch.rand(2, lq, h, n_l, p, device="cuda", generator=g)
    attn = (attn / attn.sum((-1, -2), keepdim=True)).contiguous()
    loc = torch.rand(2, lq, h, n_l, p, 2, device="cuda", generator=g)
    if case == "outside":
        loc = loc * 1.6 - 0.3
    elif case == "all_outside":  # no corner of any sample inside a level
        loc = loc + 2.0
    elif case == "integer":  # exactly on pixel centres, borders included
        wh = torch.tensor([(w, hh) for hh, w in shapes], device="cuda")
        ij = (loc * (wh + 2)[:, None, :]).floor() - 1
        loc = (ij + 0.5) / wh[:, None, :]
    return value, loc.contiguous(), attn


# D of every vector width the kernels pick: multiples of 4 (16-byte f32
# loads; of 8 for bf16), of 2 only, odd; 48 and 64 need more lanes per row
DS = [32, 8, 48, 4, 6, 5, 16, 64]
# A launch long enough that each warp serves several queries: 2 x 8,461 x 8
# (b, q, h) is twice what it takes on a card of 132 SMs, with a ragged last
# run (8,461 = 5 mod 8, 13 mod 32). The heads, not the queries, make it long:
# a row of the small image then takes no more atomic adds than its sum's
# rounding can bear within the tolerance
LONG_LQ, LONG_H = 8461, 8
# (Lq, H, P): one query; one head; L*P = 36 (a second chunk of samples); the
# long launch at both sample counts
GEOMETRIES = [(1, 4, 3), (37, 1, 3), (37, 4, 9), (LONG_LQ, LONG_H, 3),
              (LONG_LQ, LONG_H, 9)]


def _fwd_tol(dtype):
    return (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
            else dict(rtol=2.0 ** -8, atol=1e-5))  # one bf16 rounding


def _misaligned(t):
    """A contiguous copy of t whose data_ptr() is one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == t.element_size()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "integer", "outside"])
@pytest.mark.parametrize("d", DS)
def test_kernel_matches_plain(cuda, dtype, case, d):
    value, loc, attn = _inputs(37, 4, d, 3, dtype, case)
    got = msda.msda_fwd(value, SHAPES, loc, attn)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, 37, 4 * d)
    want = msda.ms_deform_attn_plain(value.float(), SHAPES, loc, attn)
    torch.testing.assert_close(got.float(), want, **_fwd_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,h,p", GEOMETRIES)
def test_kernel_matches_plain_geometries(cuda, dtype, lq, h, p):
    value, loc, attn = _inputs(lq, h, 32, p, dtype, "outside")
    got = msda.msda_fwd(value, SHAPES, loc, attn)
    torch.cuda.synchronize()
    want = msda.ms_deform_attn_plain(value.float(), SHAPES, loc, attn)
    torch.testing.assert_close(got.float(), want, **_fwd_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 6])
def test_kernel_takes_misaligned_value(cuda, dtype, d):
    """A value tensor off the 16-byte grid goes through narrower loads; it
    is not refused."""
    value, loc, attn = _inputs(37, 4, d, 3, dtype, "random")
    got = msda.msda_fwd(_misaligned(value), SHAPES, loc, attn)
    torch.cuda.synchronize()
    want = msda.ms_deform_attn_plain(value.float(), SHAPES, loc, attn)
    torch.testing.assert_close(got.float(), want, **_fwd_tol(dtype))


def test_all_outside_locations_give_exact_zeros(cuda):
    value, loc, attn = _inputs(37, 4, 32, 3, torch.float32, "all_outside")
    out = msda.msda_fwd(value, SHAPES, loc, attn)
    g = torch.ones_like(out)
    grads = msda.msda_bwd(value, SHAPES, loc, attn, g)
    torch.cuda.synchronize()
    for t in (out, *grads):
        assert torch.equal(t, torch.zeros_like(t))


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


def _grad_out(lq, h, d):
    return torch.randn(2, lq, h * d, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(3))


def _assert_bwd_close(got, want):
    for name, a, b in zip(("value", "loc", "attn"), got, want):
        assert a.shape == b.shape
        # f32; grad_value sums atomic adds in run-dependent order
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"grad_{name}: {m}")


@pytest.mark.parametrize("case", ["random", "integer", "outside"])
@pytest.mark.parametrize("d", DS)
def test_msda_bwd_matches_plain(cuda, case, d):
    value, loc, attn = _inputs(37, 4, d, 3, torch.float32, case)
    g = _grad_out(37, 4, d)
    before = msda.msda_bwd.launches
    got = msda.msda_bwd(value, SHAPES, loc, attn, g)
    torch.cuda.synchronize()
    assert msda.msda_bwd.launches == before + 1
    want = msda.ms_deform_attn_plain_bwd(value, SHAPES, loc, attn, g)
    _assert_bwd_close(got, want)


@pytest.mark.parametrize("lq,h,p", GEOMETRIES)
def test_msda_bwd_matches_plain_geometries(cuda, lq, h, p):
    value, loc, attn = _inputs(lq, h, 32, p, torch.float32, "outside")
    g = _grad_out(lq, h, 32)
    got = msda.msda_bwd(value, SHAPES, loc, attn, g)
    torch.cuda.synchronize()
    _assert_bwd_close(got, msda.ms_deform_attn_plain_bwd(value, SHAPES, loc,
                                                         attn, g))


@pytest.mark.parametrize("d", [32, 6])
def test_msda_bwd_takes_misaligned_value(cuda, d):
    value, loc, attn = _inputs(37, 4, d, 3, torch.float32, "random")
    g = _grad_out(37, 4, d)
    got = msda.msda_bwd(_misaligned(value), SHAPES, loc, attn, g)
    torch.cuda.synchronize()
    _assert_bwd_close(got, msda.ms_deform_attn_plain_bwd(value, SHAPES, loc,
                                                         attn, g))


def test_msda_bwd_runs_agree(cuda):
    """Two runs on the same inputs: grad_loc and grad_attn are sums in a
    fixed order and agree exactly; grad_value sums atomic adds in an order
    that varies from run to run, so it agrees within rtol 1e-4 / atol 1e-5.
    Many queries on one small image, so that every row takes hundreds of
    adds; grad_out is non-negative, so the addends of a row do not cancel
    and the order's rounding stays relative to the sum."""
    value, loc, attn = _inputs(LONG_LQ, LONG_H, 32, 3, torch.float32,
                               "random")
    g = _grad_out(LONG_LQ, LONG_H, 32).abs()
    first = msda.msda_bwd(value, SHAPES, loc, attn, g)
    second = msda.msda_bwd(value, SHAPES, loc, attn, g)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    torch.testing.assert_close(first[0], second[0], rtol=1e-4, atol=1e-5)


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
    """bf16 value takes a bf16 grad_out: an f32 one with it raises, and so
    do the dtypes the kernel has no path for (f16)."""
    value, loc, attn = _inputs(5, 2, 32, 2, torch.bfloat16, "random")
    g = torch.zeros(2, 5, 64, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        msda.msda_bwd(value, SHAPES, loc, attn, g)
    with pytest.raises(ValueError, match="float16"):
        msda.msda_bwd(value.half(), SHAPES, loc, attn, g.half())


# ---------------- MSDA backward in bf16 ----------------

SHAPES5 = SHAPES + ((2, 3),)  # five levels, as DINO_5scale has


def _assert_bwd_bf16_close(got, value, shapes, loc, attn, g):
    """grad_value (bf16) within one bf16 rounding of the plain version's f32
    sum on the same bf16 values (rtol 2^-8, plus the f32 tolerances for the
    sum's order); grad_loc / grad_attn (f32) at the f32 tolerances of
    chip_smoke.py's check_bwd: rtol 1e-4 / atol 1e-5, grad_loc's atol times
    the largest level side (it is the bilinear slope times the side, a sum
    over the channels and corners whose order differs from the plain
    version's)."""
    want = msda.ms_deform_attn_plain_bwd(value.float(), shapes, loc, attn,
                                         g.float())
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    max_side = max(max(hw) for hw in shapes)
    for name, a, b in zip(("value", "loc", "attn"), got, want):
        assert a.shape == b.shape
        rtol = 2.0 ** -8 + 1e-4 if name == "value" else 1e-4
        atol = 1e-5 * (max_side if name == "loc" else 1)
        torch.testing.assert_close(a.float(), b, rtol=rtol, atol=atol,
                                   msg=lambda m: f"grad_{name}: {m}")


def _bf16_case(lq, h, d, p, case, shapes=SHAPES):
    value, loc, attn = _inputs(lq, h, d, p, torch.bfloat16, case,
                               shapes=shapes)
    return value, loc, attn, _grad_out(lq, h, d).to(torch.bfloat16)


@pytest.mark.parametrize("case", ["random", "integer", "outside"])
@pytest.mark.parametrize("d", [32, 64, 16, 5])
def test_msda_bwd_bf16_matches_plain(cuda, case, d):
    value, loc, attn, g = _bf16_case(37, 4, d, 3, case)
    before = msda.msda_bwd.launches
    got = msda.msda_bwd(value, SHAPES, loc, attn, g)
    torch.cuda.synchronize()
    assert msda.msda_bwd.launches == before + 1
    _assert_bwd_bf16_close(got, value, SHAPES, loc, attn, g)


@pytest.mark.parametrize("lq,h,p,shapes", [
    (LONG_LQ, LONG_H, 3, SHAPES),  # the run kernel: 8 lanes x 4 bf16 a row
    (LONG_LQ, LONG_H, 2, SHAPES),  # P = 2, as DINO_4scale_fast has
    (37, 4, 2, SHAPES),
    (37, 4, 4, SHAPES5),  # L = 5, as DINO_5scale has
    (LONG_LQ, LONG_H, 4, SHAPES5),
])
def test_msda_bwd_bf16_geometries(cuda, lq, h, p, shapes):
    value, loc, attn, g = _bf16_case(lq, h, 32, p, "outside", shapes)
    got = msda.msda_bwd(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    _assert_bwd_bf16_close(got, value, shapes, loc, attn, g)


@pytest.mark.parametrize("d", [32, 6])
def test_msda_bwd_bf16_takes_misaligned_value(cuda, d):
    value, loc, attn, g = _bf16_case(37, 4, d, 3, "random")
    got = msda.msda_bwd(_misaligned(value), SHAPES, loc, attn,
                        _misaligned(g))
    torch.cuda.synchronize()
    _assert_bwd_bf16_close(got, value, SHAPES, loc, attn, g)


# The bf16 backward at encoder-like sizes: every token of a 4-level image a
# query (or a sequence-parallel rank's half of them), long enough that the
# split kernel takes the launch (D = 32, 16-byte aligned rows, runs of
# queries a warp: B * Lq * H / 16 is at least twice the blocks 132 SMs hold
# at 8 heads and at 4).
ENC_SHAPES = ((96, 160), (48, 80), (24, 40), (12, 20))
ENC_S = sum(hh * w for hh, w in ENC_SHAPES)  # 20,400 tokens


def _encoder_loc(tokens, h, p, shapes, seed):
    """[2, len(tokens), h, L, p, 2] locations as an encoder's queries take
    them: token t (levels in order) samples each level at its own pixel's
    centre plus (point + 1) pixels along its head's direction (DINO's
    initial offsets), moved by up to 0.3 of a pixel, so consecutive
    queries share cells on the coarser levels."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    sizes = torch.tensor([hh * w for hh, w in shapes], device=dev)
    starts = torch.cumsum(sizes, 0) - sizes
    lvl = (torch.searchsorted(torch.cumsum(sizes, 0), tokens, right=True))
    ws = torch.tensor([w for _, w in shapes], device=dev)
    hs = torch.tensor([hh for hh, _ in shapes], device=dev)
    i = tokens - starts[lvl]
    ref = torch.stack([(i % ws[lvl] + 0.5) / ws[lvl],
                       (i // ws[lvl] + 0.5) / hs[lvl]], -1).float()
    theta = torch.arange(h, device=dev) * (2 * torch.pi / h)
    d = torch.stack([theta.cos(), theta.sin()], -1)
    d = d / d.abs().max(-1, keepdim=True).values  # [h, 2]
    steps = torch.arange(1, p + 1, device=dev, dtype=torch.float32)
    wh = torch.stack([ws, hs], -1).float()  # [L, 2]
    off = d[:, None, None, :] * steps[None, None, :, None] / wh[None, :, None]
    jitter = (torch.rand(2, len(tokens), h, len(shapes), p, 2, device=dev,
                         generator=g) - 0.5) * 0.6 / wh[None, None, None, :,
                                                        None]
    loc = ref[None, :, None, None, None, :] + off[None, None] + jitter
    return loc.contiguous()


@pytest.mark.parametrize("case,h,lq", [
    ("local", 8, ENC_S),  # merged runs: consecutive queries share rows
    ("spread", 8, ENC_S),  # uniform-random: every corner its own row
    ("borders", 8, ENC_S),  # outside corners, level borders
    ("local", 4, ENC_S),  # a tensor-parallel rank's 4 heads
    ("offset_half", 8, ENC_S // 2),  # a sequence-parallel rank's queries
    ("local", 8, ENC_S - 13),  # a ragged last run
])
def test_msda_bwd_bf16_encoder_sizes(cuda, case, h, lq):
    """The split kernel's launches against the plain version at one bf16
    rounding (and check_bwd's f32 tolerances for grad_loc / grad_attn)."""
    value = torch.randn(2, ENC_S, h, 32, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            4)).to(torch.bfloat16)
    first = ENC_S - lq if case == "offset_half" else 0
    tokens = torch.arange(first, first + lq, device="cuda")
    n_l = len(ENC_SHAPES)
    if case in ("spread", "borders"):
        loc = torch.rand(2, lq, h, n_l, 4, 2, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(
                             5))
        loc = (loc * 1.6 - 0.3) if case == "borders" else loc
    else:
        loc = _encoder_loc(tokens, h, 4, ENC_SHAPES, seed=5)
    attn = torch.rand(2, lq, h, n_l, 4, device="cuda")
    attn = (attn / attn.sum((-1, -2), keepdim=True)).contiguous()
    g = _grad_out(lq, h, 32).to(torch.bfloat16)
    before = msda.msda_bwd.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = msda.msda_bwd(value, ENC_SHAPES, loc.contiguous(), attn, g)
        torch.cuda.synchronize()
    assert msda.msda_bwd.launches == before + 1
    ran = [e.key for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("msda_bwd_bf16_split_kernel" in k for k in ran), ran
    _assert_bwd_bf16_close(got, value, ENC_SHAPES, loc, attn, g)


def test_msda_bwd_bf16_no_queries(cuda):
    """Lq = 0: grad_value comes back all zeros in bf16 (the entry point
    still zeroes and rounds its workspace), grad_loc / grad_attn empty."""
    value, loc, attn, g = _bf16_case(0, 4, 32, 2, "random")
    value.fill_(1.0)
    got = msda.msda_bwd(value, SHAPES, loc, attn, g)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16 and got[0].shape == value.shape
    assert torch.count_nonzero(got[0]) == 0
    assert got[1].numel() == got[2].numel() == 0


def test_dispatcher_on_cuda_keeps_the_bf16_gradient(cuda):
    """ms_deform_attn on bf16 CUDA values: the gradients through msda_bwd
    come back in the leaves' dtypes (value bf16, loc / attn f32)."""
    value, loc, attn, _ = _bf16_case(11, 2, 32, 2, "integer")
    leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
    out = msda.ms_deform_attn(leaves[0], SHAPES, leaves[1], leaves[2])
    assert out.dtype == torch.bfloat16
    g = torch.randn_like(out)
    out.backward(g)
    _assert_bwd_bf16_close([x.grad for x in leaves], value, SHAPES, loc,
                           attn, g)


# ---------------- the forward's run routes (bf16, f64) ----------------

FWD_RUN = "msda_fwd_bf16_run_kernel"
FWD_F64_RUN = "msda_fwd_run_kernel f64"
# the flagship's serving levels (800x1344) and the C2F training levels
# (1216x2048), every token a query: the encoder's launches
SERVE_SHAPES = ((100, 168), (50, 84), (25, 42), (13, 21))
TRAIN_SHAPES = ((152, 256), (76, 128), (38, 64), (19, 32))
ENC_SHAPES5 = ENC_SHAPES + ((6, 10),)  # 5 levels: L x P = 20


def _fwd_routed(value, shapes, loc, attn, route):
    """msda_fwd once, counted: its one launch went through `route` (one of
    msda.FWD_ROUTES, by the C launcher's counts); returns its output."""
    before, routes0 = msda.msda_fwd.launches, msda.msda_fwd_routes()
    got = msda.msda_fwd(value, shapes, loc, attn)
    torch.cuda.synchronize()
    routes = msda.msda_fwd_routes()
    assert msda.msda_fwd.launches == before + 1
    ran = {r: n - routes0[r] for r, n in routes.items() if n > routes0[r]}
    assert ran == {route: 1}, (route, ran)
    return got


def _encoder_case(shapes, lq, h, p, case, first=0, seed=7,
                  dtype=torch.bfloat16):
    """value [2, S, h, 32] (bf16, or f64 with f64 loc / attn), loc / attn
    of `lq` queries (tokens first.. first + lq - 1 of the image): at an
    encoder's own locations ("local"), uniform-random, spilling over the
    levels ("outside", loc x 1.6 - 0.3) or on pixel centres with the
    borders ("integer")."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    s_tok, n_l = sum(hh * w for hh, w in shapes), len(shapes)
    value = torch.randn(2, s_tok, h, 32, device="cuda",
                        generator=gen).to(dtype)
    if case == "local":
        loc = _encoder_loc(torch.arange(first, first + lq, device="cuda"), h,
                           p, shapes, seed)
    else:
        loc = torch.rand(2, lq, h, n_l, p, 2, device="cuda", generator=gen)
        if case == "outside":
            loc = loc * 1.6 - 0.3
        elif case == "integer":
            wh = torch.tensor([(w, hh) for hh, w in shapes], device="cuda")
            ij = (loc * (wh + 2)[:, None, :]).floor() - 1
            loc = (ij + 0.5) / wh[:, None, :]
    attn = torch.rand(2, lq, h, n_l, p, device="cuda", generator=gen)
    attn = (attn / attn.sum((-1, -2), keepdim=True)).contiguous()
    if dtype == torch.float64:
        loc, attn = loc.double(), attn.double()
    return value, loc.contiguous(), attn


# the encoder's launches the run routes take: (shapes, lq, h, p, case,
# first)
RUN_FWD_CASES = [
    (SERVE_SHAPES, 22323, 8, 4, "local", 0),  # the serving encoder
    (SERVE_SHAPES, 22323, 8, 4, "random", 0),
    (TRAIN_SHAPES, 51680, 8, 4, "local", 0),  # the training encoder
    (TRAIN_SHAPES, 51680, 8, 4, "random", 0),
    (ENC_SHAPES, ENC_S - 13, 8, 4, "local", 0),  # Lq not a multiple of 32
    (ENC_SHAPES, ENC_S, 4, 4, "local", 0),  # a tensor-parallel rank's heads
    (ENC_SHAPES, ENC_S // 2, 8, 4, "local", ENC_S - ENC_S // 2),  # sp rank
    (ENC_SHAPES, ENC_S, 8, 2, "local", 0),  # L x P = 8
    (ENC_SHAPES5, sum(hh * w for hh, w in ENC_SHAPES5), 8, 4, "local",
     0),  # L x P = 20
    (ENC_SHAPES, ENC_S, 8, 4, "outside", 0),  # corners off the levels
    (ENC_SHAPES, ENC_S, 8, 4, "integer", 0),  # on pixel centres, borders
]
RUN_FWD_IDS = ["serve_local", "serve_random", "train_local", "train_random",
               "ragged", "tp_h4", "sp_half", "lp8", "lp20", "outside",
               "borders"]


@pytest.mark.parametrize("shapes,lq,h,p,case,first", RUN_FWD_CASES,
                         ids=RUN_FWD_IDS)
def test_msda_fwd_bf16_run_route(cuda, shapes, lq, h, p, case, first):
    """The encoder's bf16 launches through msda_fwd_bf16_run_kernel, against
    the plain version's f32 sum on the same values within one bf16
    rounding (_fwd_tol)."""
    value, loc, attn = _encoder_case(shapes, lq, h, p, case, first)
    got = _fwd_routed(value, shapes, loc, attn, FWD_RUN)
    assert got.dtype == torch.bfloat16 and got.shape == (2, lq, h * 32)
    want = msda.ms_deform_attn_plain(value.float(), shapes, loc, attn)
    torch.testing.assert_close(got.float(), want, **_fwd_tol(torch.bfloat16))


def test_msda_fwd_bf16_run_route_all_outside_gives_exact_zeros(cuda):
    """No corner of any sample inside its level: every output exactly 0
    (the corners' clamped rows carry weight 0)."""
    value, loc, attn = _encoder_case(ENC_SHAPES, ENC_S, 8, 4, "random")
    got = _fwd_routed(value, ENC_SHAPES, loc + 2.0, attn, FWD_RUN)
    assert torch.count_nonzero(got) == 0


def test_msda_fwd_bf16_run_route_same_bits(cuda):
    """Two launches on the same inputs give the same bits (no atomics, one
    order of the sums)."""
    value, loc, attn = _encoder_case(TRAIN_SHAPES, 51680, 8, 4, "local")
    a = _fwd_routed(value, TRAIN_SHAPES, loc, attn, FWD_RUN)
    b = _fwd_routed(value, TRAIN_SHAPES, loc, attn, FWD_RUN)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("shapes,lq,h,p,case,first", RUN_FWD_CASES,
                         ids=RUN_FWD_IDS)
def test_msda_fwd_f64_run_route(cuda, shapes, lq, h, p, case, first):
    """The encoder's f64 launches through msda_fwd_run_kernel f64, against
    the plain f64 version at F64_TOL (chip_smoke.py phase 15f's)."""
    value, loc, attn = _encoder_case(shapes, lq, h, p, case, first,
                                     dtype=torch.float64)
    got = _fwd_routed(value, shapes, loc, attn, FWD_F64_RUN)
    assert got.dtype == torch.float64 and got.shape == (2, lq, h * 32)
    want = msda.ms_deform_attn_plain(value, shapes, loc, attn)
    torch.testing.assert_close(got, want, **F64_TOL)


def test_msda_fwd_f64_run_route_all_outside_gives_exact_zeros(cuda):
    """No corner of any sample inside its level: every f64 output exactly
    0 (the corners' clamped rows carry weight 0)."""
    value, loc, attn = _encoder_case(ENC_SHAPES, ENC_S, 8, 4, "random",
                                     dtype=torch.float64)
    got = _fwd_routed(value, ENC_SHAPES, loc + 2.0, attn, FWD_F64_RUN)
    assert torch.count_nonzero(got) == 0


def test_msda_fwd_f64_run_route_same_bits(cuda):
    """Two f64 launches on the same inputs give the same bits (no atomics,
    one order of the sums)."""
    value, loc, attn = _encoder_case(SERVE_SHAPES, 22323, 8, 4, "local",
                                     dtype=torch.float64)
    a = _fwd_routed(value, SERVE_SHAPES, loc, attn, FWD_F64_RUN)
    b = _fwd_routed(value, SERVE_SHAPES, loc, attn, FWD_F64_RUN)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("dtype,d,lq,aligned,route", [
    (torch.bfloat16, 32, LONG_LQ, True, FWD_RUN),  # long, D = 32, aligned
    (torch.bfloat16, 32, 37, True, "msda_fwd_kernel bf16"),  # short
    (torch.bfloat16, 32, LONG_LQ, False, "msda_fwd_kernel bf16"),
    (torch.bfloat16, 64, LONG_LQ, True, "msda_fwd_kernel bf16"),  # D != 32
    (torch.bfloat16, 16, LONG_LQ, True, "msda_fwd_kernel bf16"),
    (torch.float32, 32, LONG_LQ, True, "msda_fwd_kernel f32"),
    (torch.float64, 32, LONG_LQ, True, FWD_F64_RUN),  # long, D = 32
    (torch.float64, 32, 37, True, "msda_fwd_kernel f64"),  # short
    (torch.float64, 32, LONG_LQ, False, "msda_fwd_kernel f64"),
    (torch.float64, 64, LONG_LQ, True, "msda_fwd_kernel f64"),  # D != 32
], ids=["bf16_long", "bf16_short", "bf16_misaligned", "bf16_d64",
        "bf16_d16", "f32_long", "f64_long", "f64_short", "f64_misaligned",
        "f64_d64"])
def test_msda_fwd_routes_by_geometry(cuda, dtype, d, lq, aligned, route):
    """Which launches take a run route (bf16, f64) and which keep
    msda_fwd_kernel, each against the plain version."""
    value, loc, attn = _inputs(lq, LONG_H, d, 4, dtype, "outside")
    if dtype == torch.float64:
        loc, attn = loc.double(), attn.double()
    if not aligned:
        value = _misaligned(value)
    got = _fwd_routed(value, SHAPES, loc, attn, route)
    if dtype == torch.float64:
        want = msda.ms_deform_attn_plain(value, SHAPES, loc, attn)
        torch.testing.assert_close(got, want, **F64_TOL)
    else:
        want = msda.ms_deform_attn_plain(value.float(), SHAPES, loc, attn)
        torch.testing.assert_close(got.float(), want, **_fwd_tol(dtype))


def test_bf16_cuda_never_reaches_the_plain_version(cuda):
    """An encoder-length bf16 launch through the dispatcher goes to the run
    kernel, never to the plain version."""
    value, loc, attn = _encoder_case(ENC_SHAPES, ENC_S, 8, 4, "local")
    routes0 = msda.msda_fwd_routes()
    with mock_plain_raises():
        out = msda.ms_deform_attn(value, ENC_SHAPES, loc, attn)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert msda.msda_fwd_routes()[FWD_RUN] == routes0[FWD_RUN] + 1


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


def _fma_inputs(k, n_out, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randn(300, 128, device="cuda", generator=g).to(
        torch.bfloat16)
    idx = torch.randint(0, 300, (n_out * k,), device="cuda", generator=g,
                        dtype=torch.int32)
    w = torch.randn(n_out * k, 1, device="cuda", generator=g)
    return table, idx, w


def _assert_fma_close(got, want):
    # one bf16 rounding of the f32 sum
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -8, atol=1e-5)


# K = 16: the unrolled instantiation; 1, 3, 36: chunks of 8. n_out 1 and 37
# fill no whole block.
@pytest.mark.parametrize("k", [1, 3, 16, 36])
@pytest.mark.parametrize("n_out", [1, 37, 2048])
def test_gather_fma_matches_plain(cuda, k, n_out):
    table, idx, w = _fma_inputs(k, n_out, seed=1)
    before = gather.gather_fma.launches
    got = gather.gather_fma(table, idx, w, k)
    assert gather.gather_fma.launches == before + 1
    _assert_fma_close(got, gather.gather_fma_plain(table.float(), idx, w, k))


@pytest.mark.parametrize("k", [1, 3, 16, 36])
def test_gather_fma_outside_rows_read_as_zero(cuda, k):
    """Indices outside the table (-1, T, T + 7) add nothing, whatever their
    weight: the plain sum over the inside ones."""
    table, idx, w = _fma_inputs(k, 37, seed=2)
    t = table.shape[0]
    idx[0::5], idx[2::5], idx[4::5] = -1, t, t + 7
    w[0::5] = float("inf")
    inside = (idx >= 0) & (idx < t)
    got = gather.gather_fma(table, idx, w, k)
    want = gather.gather_fma_plain(table.float(), idx.clamp(0, t - 1),
                                   torch.where(inside[:, None], w, 0.0), k)
    _assert_fma_close(got, want)


def test_gather_fma_all_outside_gives_exact_zeros(cuda):
    table, idx, w = _fma_inputs(16, 37, seed=3)
    got = gather.gather_fma(table, idx - 300, w, 16)
    assert torch.equal(got, torch.zeros_like(got))


def test_gather_fma_takes_misaligned_indices(cuda):
    """K = 16 with idx and w 4 bytes past a 16-byte boundary: the chunked
    instantiation (the unrolled one reads them as 16-byte vectors)."""
    table, idx, w = _fma_inputs(16, 37, seed=4)
    idx_m = torch.empty(idx.numel() + 1, dtype=torch.int32, device="cuda")[1:]
    w_m = torch.empty(idx.numel() + 1, device="cuda")[1:]
    idx_m.copy_(idx)
    w_m.copy_(w.view(-1))
    assert idx_m.data_ptr() % 16 and w_m.data_ptr() % 16
    got = gather.gather_fma(table, idx_m, w_m.view(-1, 1), 16)
    _assert_fma_close(got, gather.gather_fma_plain(table.float(), idx, w, 16))


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


def test_tiny_masks_train_step_keeps_mask_and_msda_gradients(cuda):
    """One train_step_plain forward + backward of a tiny model with masks
    (hidden 128, 8 heads: GroupNorm(8) of the mask head) on a batch with
    mask targets, on the card through msda_fwd / msda_bwd with the mask
    head chunked and rematerialized, against the CPU's plain run with the
    same weights, batch and CDN noise: no gradient dropped (the mask head,
    bbox_attention and every MSDeformAttn projection get one, as PR 2's
    dropped-gradient fault did not), losses within 1e-4, gradients within
    1e-3 by norm (as the burn-in step above)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from datr_torch.models.cdn import cdn_layout, draw_cdn_noise
    from datr_torch.train.criterion import CriterionCfg, build_weight_dict
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state
    from datr_torch.train.steps import plain_loss_and_grads

    kw = dict(num_classes=4, num_queries=12, hidden_dim=128, nheads=8,
              enc_layers=1, dec_layers=2, dim_feedforward=128, dn_number=2,
              dn_single_pad=2, with_masks=True)
    gen = torch.Generator().manual_seed(4)
    img = torch.randn(2, 64, 96, 3, generator=gen)
    pad = torch.zeros(2, 64, 96, dtype=torch.bool)
    pad[1, :, 70:] = True
    batch = dict(images=img, pad_mask=pad,
                 boxes=torch.rand(2, 3, 4, generator=gen) * 0.3 + 0.3,
                 labels=torch.randint(0, 4, (2, 3), generator=gen),
                 valid=torch.tensor([[True, True, False], [True] * 3]),
                 masks=(torch.rand(2, 3, 16, 24, generator=gen) > 0.5).half())
    groups, _ = cdn_layout(2, 2)
    draws = draw_cdn_noise(torch.Generator().manual_seed(3), 2, groups, 2, 4,
                           "cpu")
    ccfg = CriterionCfg(num_classes=4, dn_single_pad=2, dn_groups=groups)
    wd = build_weight_dict(dec_layers=2, masks=True)
    results = {}
    for dev in ("cpu", "cuda"):
        on = dev == "cuda"
        model = DINO(**kw, use_remat=on, mask_query_chunk=5 if on else 0)
        model.init_params(torch.Generator().manual_seed(0)).to(dev)
        state = create_train_state(model, Optimizer(model))
        b = {k: v.to(dev) for k, v in batch.items()}
        d = type(draws)(*(t.to(dev) for t in draws))
        fwd0, bwd0 = msda.msda_fwd.launches, msda.msda_bwd.launches
        total, losses, _ = plain_loss_and_grads(state, b, ccfg, wd, d)
        if on:  # one pass of 3 layers, recomputed once by remat
            assert msda.msda_fwd.launches == fwd0 + 6
            assert msda.msda_bwd.launches == bwd0 + 3
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.requires_grad}
        assert all(g is not None for n, g in grads.items()
                   if not n.startswith(("d_img", "proto_d"))), [
            n for n, g in grads.items() if g is None]
        results[dev] = (total.item(),
                        {k: v.item() for k, v in losses.items()},
                        {n: g.cpu() for n, g in grads.items()
                         if g is not None})
    (t_c, l_c, g_c), (t_g, l_g, g_g) = results["cpu"], results["cuda"]
    assert {"loss_mask", "loss_dice"} <= l_c.keys() == l_g.keys()
    assert abs(t_c - t_g) <= 1e-4 * abs(t_c)
    for k in l_c:
        assert abs(l_c[k] - l_g[k]) <= 1e-4 * abs(l_c[k]) + 1e-5, k
    watched = [n for n in g_g if n.startswith(("mask_head", "bbox_attention"))
               or "sampling_offsets" in n or "attention_weights" in n
               or "value_proj" in n]
    assert len(watched) > 32 and all(g_g[n].norm() > 0 for n in watched)
    total = torch.stack([g.norm() for g in g_c.values()]).norm().item()
    for n in g_c:
        err = (g_c[n] - g_g[n]).norm().item()
        assert err <= 1e-3 * max(g_c[n].norm().item(), 1e-3 * total), (n, err)


def test_batched_nms_cuda_equals_cpu(cuda):
    """The suppression matrix computed on the card and walked on the host
    keeps exactly what the CPU path keeps (ties, duplicates, three
    classes, candidates marked -1)."""
    from datr_torch.models.postprocess import batched_nms

    g = torch.Generator().manual_seed(4)
    xy = torch.rand(2, 300, 2, generator=g) * 600
    boxes = torch.cat([xy, xy + torch.rand(2, 300, 2, generator=g) * 200 + 8],
                      -1)
    boxes[:, 100:150] = boxes[:, :50] + 0.5
    scores = (torch.rand(2, 300, generator=g) * 20).round() / 20
    scores[:, 250:] = -1.0
    labels = torch.randint(0, 3, (2, 300), generator=g)
    want = batched_nms(boxes, scores, labels, 0.7, 300)
    got = batched_nms(boxes.cuda(), scores.cuda(), labels.cuda(), 0.7, 300)
    assert got[0].is_cuda and got[1].is_cuda
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert 0 < want[1].sum() < 600


def test_tiny_self_training_step_cuda_matches_cpu(cuda):
    """One self-training step's teacher pseudo-labels, losses and
    gradients on the card (msda_fwd / msda_bwd) against the same on the
    CPU (plain versions): same weights, batch, CDN noise and thresholds, f32
    with TF32 off. num_pseudo equal, losses 1e-4 relative, gradients 1e-3
    by relative norm as in the burn-in test above."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from datr_torch.models.cdn import cdn_layout, draw_cdn_noise
    from datr_torch.train.criterion import CriterionCfg, build_weight_dict
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state
    from datr_torch.train.steps import (
        self_training_loss_and_grads,
        teacher_pseudo_labels,
    )

    kw = dict(num_classes=4, num_queries=12, hidden_dim=32, nheads=2,
              enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=4,
              dn_single_pad=2)
    gen = torch.Generator().manual_seed(2)
    img = torch.randn(4, 64, 96, 3, generator=gen)
    pad = torch.zeros(4, 64, 96, dtype=torch.bool)
    pad[1, 50:] = True
    pad[3, :, 80:] = True
    batch = dict(images=img, images_strong=img * 1.2 + 0.1, pad_mask=pad,
                 boxes=torch.rand(2, 3, 4, generator=gen) * 0.3 + 0.3,
                 labels=torch.randint(0, 4, (2, 3), generator=gen),
                 valid=torch.tensor([[True, True, False], [True] * 3]))
    groups, _ = cdn_layout(4, 2)
    draws = draw_cdn_noise(torch.Generator().manual_seed(3), 2, groups, 2, 4,
                           "cpu")
    ccfg = CriterionCfg(num_classes=4, dn_single_pad=2, dn_groups=groups)
    wd = build_weight_dict(dec_layers=2)
    results, thr = {}, None
    for dev in ("cpu", "cuda"):
        model = DINO(**kw, use_remat=(dev == "cuda"))
        model.init_params(torch.Generator().manual_seed(0))
        with torch.no_grad():  # box heads off their zero init
            for head in (model.bbox_head, model.enc_out_bbox_head):
                head.layer2.weight.normal_(0, 0.05, generator=torch.Generator(
                ).manual_seed(5))
        model.to(dev)
        state = create_train_state(model, Optimizer(model))
        b = {k: v.to(dev) for k, v in batch.items()}
        if thr is None:  # in the widest gap of the teacher's top scores
            with torch.no_grad():
                s = state.ema_teacher(b["images"][2:], b["pad_mask"][2:])[
                    "pred_logits"].sigmoid().flatten().sort(
                        descending=True).values
            k = int((s[2:16] - s[3:17]).argmax()) + 3
            thr = torch.full((4,), float(s[k - 1] + s[k]) / 2)
        d = type(draws)(*(t.to(dev) for t in draws))
        pseudo = teacher_pseudo_labels(state, b, thr.to(dev), (64, 96))
        total, src, tgt, _ = self_training_loss_and_grads(
            state, b, ccfg, wd, pseudo, dn_draws=d)
        losses = {**src, **{f"{k}_target": v for k, v in tgt.items()}}
        results[dev] = (int(pseudo[2].sum()), total.item(),
                        {k: v.item() for k, v in losses.items()},
                        {n: p.grad.cpu() for n, p in model.named_parameters()
                         if p.grad is not None})
    (n_c, t_c, l_c, g_c), (n_g, t_g, l_g, g_g) = results["cpu"], \
        results["cuda"]
    assert n_c == n_g > 0
    assert l_c.keys() == l_g.keys() and g_c.keys() == g_g.keys()
    assert abs(t_c - t_g) <= 1e-4 * abs(t_c)
    for k in l_c:
        assert abs(l_c[k] - l_g[k]) <= 1e-4 * abs(l_c[k]) + 1e-5, k
    total = torch.stack([g.norm() for g in g_c.values()]).norm().item()
    for n in g_c:
        err = (g_c[n] - g_g[n]).norm().item()
        assert err <= 1e-3 * max(g_c[n].norm().item(), 1e-3 * total), (n, err)


# ---------------- the serving surface ----------------


def test_wire_decode_yuv420_on_cuda_matches_cpu(cuda):
    """The yuv420 device decode on the card against the same plain ops on
    the CPU, f32 atol 1e-5; the pad mask exactly; the u8 wire too."""
    from datr_torch.serve import wire_decode

    g = torch.Generator().manual_seed(3)
    canvas = (96, 128)
    sizes = torch.tensor([[70, 101], [96, 77]], dtype=torch.int32)
    for fmt, shape in (("yuv420", (2, 96 * 128 * 3 // 2)),
                       ("u8", (2, 96, 128, 3))):
        wire = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
        want_x, want_m = wire_decode(wire, sizes, canvas, fmt)
        got_x, got_m = wire_decode(wire.to(cuda), sizes.to(cuda), canvas, fmt)
        assert torch.equal(got_m.cpu(), want_m)
        torch.testing.assert_close(got_x.cpu(), want_x, rtol=0, atol=1e-5)


def test_http_round_trip_on_card(cuda):
    """A tiny DINO served on the card: one PNG POST (the port's encoder
    and decoder, no PIL) equal to detect on the decoded image, through
    msda_fwd (3 launches per batch)."""
    import json
    import threading
    import urllib.request

    import numpy as np

    from datr_torch.data import png
    from datr_torch.serve import InferenceServer, serve_http

    model = DINO(num_classes=4, num_queries=12, hidden_dim=32, nheads=2,
                 enc_layers=1, dec_layers=2, dim_feedforward=64)
    model.init_params(torch.Generator().manual_seed(0))
    img = np.random.default_rng(4).integers(0, 256, (60, 90, 3), np.uint8)
    with InferenceServer(model, canvas_hw=(96, 128), batch_size=2,
                         num_select=8, score_threshold=0.0, resize_short=64,
                         resize_max=128, wire_format="yuv420",
                         device="cuda") as srv:
        srv.warmup()
        httpd = serve_http(srv, "127.0.0.1", 0, start=False)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            before = msda.msda_fwd.launches
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/detect",
                data=png.encode_png(img), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.load(r)
            assert msda.msda_fwd.launches == before + 3
            want = srv.detect(img)
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert out["labels"] == want["labels"].tolist()
    np.testing.assert_allclose(out["scores"], want["scores"], atol=1e-6)
    np.testing.assert_allclose(out["boxes"], want["boxes"], atol=1e-3)


def test_shared_heads_forward_through_kernels(cuda):
    """A tiny model with shared two-stage heads (its encoder's proposal
    heads are the decoder's): the eval forward on the card, through
    msda_fwd (3 launches: 1 encoder + 2 decoder layers), against the same
    model's plain forward on the CPU, with TF32 off: the two-stage
    selection equal, logits atol 1e-3, boxes 1e-4 (chip_smoke.py phase
    3's tolerances)."""
    kw = dict(num_classes=4, num_queries=12, hidden_dim=32, nheads=2,
              enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=4,
              dn_single_pad=2, two_stage_share_heads=True)
    model = DINO(**kw)
    model.init_params(torch.Generator().manual_seed(0))
    assert model.enc_out_bbox_head is model.bbox_head
    assert not any(k.startswith("enc_out_") for k in model.state_dict())
    model.eval()
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(2, 64, 96, 3, generator=gen)
    pad = torch.zeros(2, 64, 96, dtype=torch.bool)
    pad[1, :, 80:] = True
    with torch.no_grad():
        want = model(img, pad)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model.to(cuda)
        msda.msda_fwd.launches = 0
        with torch.no_grad():
            got = model(img.to(cuda), pad.to(cuda))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    assert msda.msda_fwd.launches == 3
    assert torch.equal(got["topk_idx"].cpu(), want["topk_idx"])
    for key, w in want.items():
        if key.endswith("logits"):
            torch.testing.assert_close(got[key].cpu(), w, rtol=0, atol=1e-3)
        elif key.endswith("boxes"):
            torch.testing.assert_close(got[key].cpu(), w, rtol=0, atol=1e-4)


def test_two_ranks_ddp_step_on_the_card(cuda, tmp_path, monkeypatch):
    """Two ranks on the one card over gloo (CUDA tensors), the student in
    DDP, each on its share of a global batch of 2 + 2 images: every loss
    and grad_norm of the burn-in and self-training steps within rtol 1e-4
    of the one-process step on the whole batch (this process, same card),
    each gradient within 1e-3 of its norm (+ 1e-7 of the whole
    gradient's), the ranks' parameters and prototype state bitwise equal,
    and the MSDA kernels launched on each rank."""
    import os
    import sys

    import numpy as np

    from datr_torch.models import cdn as tcdn
    from datr_torch.models import dino as tdino
    from datr_torch.train.criterion import build_weight_dict

    sys.path.insert(0, os.path.dirname(__file__))
    import torch_port_dist_worker as worker

    _build.build()  # once, before the ranks load the library
    stages = (1, 1, 1, 1)
    monkeypatch.setitem(tdino.RESNET_STAGES, "resnet50", stages)
    kw = dict(num_classes=4, num_queries=12, hidden_dim=32, nheads=4,
              enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=4,
              dn_single_pad=2, dn_labelbook_size=4)
    model = DINO(**kw)
    model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    images = rng.standard_normal((4, 64, 96, 3)).astype(np.float32)
    pad = np.zeros((4, 64, 96), bool)
    pad[:, 56:] = True
    pad[1, :, 48:] = True
    images[pad] = 0.0
    boxes = np.concatenate([rng.random((2, 3, 2)) * 0.5 + 0.25,
                            rng.random((2, 3, 2)) * 0.3 + 0.1], -1)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in dict(
        images=images, images_strong=images, pad_mask=pad,
        boxes=boxes.astype(np.float32),
        labels=rng.integers(0, 4, (2, 3)).astype(np.int32),
        valid=np.ones((2, 3), bool)).items()}
    groups, _ = tcdn.cdn_layout(4, 2)
    draws = tcdn.draw_cdn_noise(torch.Generator().manual_seed(1), 2, groups,
                                2, 4, "cpu")
    common = dict(stages=stages, kw=kw, sd=model.state_dict(), batch=batch,
                  ccfg=dict(num_classes=4, dn_single_pad=2, dn_groups=2),
                  wd=build_weight_dict(dec_layers=2), burnin_draws=draws,
                  st_draws=draws, thr=torch.full((4,), 0.1),
                  canvas=(64, 96), lr=1e-4, lr_backbone=1e-5, device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = worker.spawn([("steps", common)], 2, tmp_path)
    try:
        one = worker.steps(0, 1, **common)
    finally:
        worker.join(ctx)
    r0, r1 = worker.results(tmp_path, "steps", 2)
    for name in ("burnin", "self_training"):
        a, b, want = r0[name], r1[name], one[name]
        assert a["metrics"] == b["metrics"]
        for k, v in want["metrics"].items():
            if not k.startswith(("class_error", "cardinality_error")):
                assert abs(a["metrics"][k] - v) <= 1e-4 * abs(v) + 1e-5, k
        total = torch.stack([g.norm() for g in want["grads"].values()]).norm()
        for n, g in a["grads"].items():
            err = (g - want["grads"][n]).norm()
            assert err <= 1e-3 * want["grads"][n].norm() + 1e-7 * total, n
        for k, v in a["after"]["model"].items():
            assert torch.equal(v, b["after"]["model"][k]), k
        assert torch.equal(a["after"]["global_proto"],
                           b["after"]["global_proto"])
        assert a["launches"][0] > 0 and a["launches"][0] == b["launches"][0]


# ---------------- the model axes' shapes ----------------

# a tensor-parallel rank's encoder call (4 of 8 heads, Lq = S) and a
# sequence-parallel rank's share of the queries against the whole value
# table (8 heads, Lq = ceil(S / 2)), P = 4 as the models have
AXES_GEOMETRIES = [(S, 4), (-(-S // 2), 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,h", AXES_GEOMETRIES, ids=["tp_h4", "sp_half"])
def test_kernels_match_plain_at_model_axes_shapes(cuda, dtype, lq, h):
    """msda_fwd and msda_bwd at the shapes tensor and sequence parallelism
    give them, against their plain versions on the same inputs."""
    value, loc, attn = _inputs(lq, h, 32, 4, dtype, "outside")
    got = msda.msda_fwd(value, SHAPES, loc, attn)
    torch.cuda.synchronize()
    assert got.shape == (2, lq, h * 32)
    want = msda.ms_deform_attn_plain(value.float(), SHAPES, loc, attn)
    torch.testing.assert_close(got.float(), want, **_fwd_tol(dtype))
    g = _grad_out(lq, h, 32).to(dtype)
    got_b = msda.msda_bwd(value, SHAPES, loc, attn, g)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        _assert_bwd_close(got_b, msda.ms_deform_attn_plain_bwd(
            value, SHAPES, loc, attn, g))
    else:
        _assert_bwd_bf16_close(got_b, value, SHAPES, loc, attn, g)


# ---------------- the registered op, float64, export ----------------

F64_TOL = dict(rtol=1e-9, atol=1e-12)  # chip_smoke.py phase 15f's


def _f64_inputs(lq, h, d, p, case, seed=0):
    value, loc, attn = _inputs(lq, h, d, p, torch.float64, case, seed)
    return value, loc.double(), attn.double()


def test_registered_op_keeps_the_gradient_on_cuda(cuda):
    """torch.library.opcheck on CUDA tensors (schema, fake tensors, the
    autograd registration, a traced backward), then the gradient through
    `datr_torch::ms_deform_attn` reaches msda_bwd and equals the plain
    version's."""
    value, loc, attn = _inputs(11, 2, 32, 2, torch.float32, "random")
    flat = [v for hw in SHAPES for v in hw]
    torch.library.opcheck(msda._msda_op, (value, flat,
                                          loc.requires_grad_(), attn))
    leaves = [t.detach().clone().requires_grad_() for t in (value, loc, attn)]
    bwd0 = msda.msda_bwd.launches
    out = torch.ops.datr_torch.ms_deform_attn(leaves[0], flat, leaves[1],
                                              leaves[2])
    g = torch.randn_like(out)
    out.backward(g)
    assert msda.msda_bwd.launches == bwd0 + 1
    want = msda.ms_deform_attn_plain_bwd(value, SHAPES, loc.detach(), attn,
                                         g)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["random", "integer", "outside"])
@pytest.mark.parametrize("d", [32, 8, 5])
def test_f64_kernels_match_plain(cuda, case, d):
    """The f64 instantiations of msda_fwd / msda_bwd against the plain f64
    versions: rtol 1e-9 / atol 1e-12 (grad_loc's atol times the largest
    level side), the sums' order and the atomics' the only difference."""
    value, loc, attn = _f64_inputs(37, 4, d, 3, case)
    g = torch.randn(2, 37, 4 * d, device="cuda", dtype=torch.float64)
    got = msda.msda_fwd(value, SHAPES, loc, attn)
    got_b = msda.msda_bwd(value, SHAPES, loc, attn, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, msda.ms_deform_attn_plain(value, SHAPES, loc, attn), **F64_TOL)
    side = max(max(hw) for hw in SHAPES)
    want = msda.ms_deform_attn_plain_bwd(value, SHAPES, loc, attn, g)
    for part, a, b in zip(("value", "loc", "attn"), got_b, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(
            a, b, rtol=F64_TOL["rtol"],
            atol=F64_TOL["atol"] * (side if part == "loc" else 1))


@pytest.mark.parametrize("lq,h,p", GEOMETRIES)
def test_f64_kernels_match_plain_geometries(cuda, lq, h, p):
    value, loc, attn = _f64_inputs(lq, h, 32, p, "outside")
    g = torch.randn(2, lq, h * 32, device="cuda", dtype=torch.float64)
    torch.testing.assert_close(msda.msda_fwd(value, SHAPES, loc, attn),
                               msda.ms_deform_attn_plain(value, SHAPES, loc,
                                                         attn), **F64_TOL)
    side = max(max(hw) for hw in SHAPES)
    for part, a, b in zip(("value", "loc", "attn"),
                          msda.msda_bwd(value, SHAPES, loc, attn, g),
                          msda.ms_deform_attn_plain_bwd(value, SHAPES, loc,
                                                        attn, g)):
        torch.testing.assert_close(
            a, b, rtol=F64_TOL["rtol"],
            atol=F64_TOL["atol"] * (side if part == "loc" else 1))


def _assert_f64_bwd_close(got, value, shapes, loc, attn, g):
    side = max(max(hw) for hw in shapes)
    want = msda.ms_deform_attn_plain_bwd(value, shapes, loc, attn, g)
    for part, a, b in zip(("value", "loc", "attn"), got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(
            a, b, rtol=F64_TOL["rtol"],
            atol=F64_TOL["atol"] * (side if part == "loc" else 1),
            msg=lambda m: f"grad_{part}: {m}")


def _bwd_routed(value, shapes, loc, attn, g, route):
    """msda_bwd once, counted: its one launch went through `route` (one of
    msda.BWD_ROUTES, by the C launcher's counts); returns its
    gradients."""
    before, routes0 = msda.msda_bwd.launches, msda.msda_bwd_routes()
    got = msda.msda_bwd(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    routes = msda.msda_bwd_routes()
    assert msda.msda_bwd.launches == before + 1
    ran = {r: n - routes0[r] for r, n in routes.items() if n > routes0[r]}
    assert ran == {route: 1}, (route, ran)
    return got


F64_RUN = "msda_bwd_run_kernel f64"
F64_SHORT = "msda_bwd_kernel f64"


def _run_route_inputs(case, h, lq, p, dtype):
    """value, loc, attn, grad_out at ENC_SHAPES for the run route's cases
    (test_msda_bwd_f64_run_route's), all of `dtype`."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    value = torch.randn(2, ENC_S, h, 32, device="cuda", generator=gen,
                        dtype=dtype)
    n_l = len(ENC_SHAPES)
    if case in ("random", "outside"):
        loc = torch.rand(2, lq, h, n_l, p, 2, device="cuda", generator=gen,
                         dtype=dtype)
        loc = loc * 1.6 - 0.3 if case == "outside" else loc
    elif case == "one_cell":
        cell = torch.rand(1, 1, h, n_l, p, 2, device="cuda", generator=gen,
                          dtype=dtype)
        loc = cell.expand(2, lq, h, n_l, p, 2)
    else:
        loc = _encoder_loc(torch.arange(lq, device="cuda"), h, p,
                           ENC_SHAPES, seed=5).to(dtype)
        if case.startswith("moved"):
            wh = torch.tensor([(w, hh) for hh, w in ENC_SHAPES],
                              device="cuda", dtype=dtype)
            loc = loc + int(case[5:]) / wh[:, None, :] * torch.randn(
                loc.shape, device="cuda", generator=gen, dtype=dtype)
    loc = loc.contiguous()
    attn = torch.rand(2, lq, h, n_l, p, device="cuda", generator=gen,
                      dtype=dtype)
    attn = (attn / attn.sum((-1, -2), keepdim=True)).contiguous()
    g = torch.randn(2, lq, h * 32, device="cuda", generator=gen,
                    dtype=dtype)
    return value, loc, attn, g


# The run route: the long launches at D = 32 with 16-byte aligned rows. At
# ENC_SHAPES' 20,400 queries and 8 or 4 heads, B * Lq * H / 16 is at least
# twice the blocks 132 SMs hold (the length the route needs).
RUN_CASES = [
    ("local", 8, ENC_S, 4),  # merged runs: consecutive queries share rows
    ("random", 8, ENC_S, 4),  # every corner its own row
    ("outside", 8, ENC_S, 4),  # corners outside the level, level borders
    ("moved1", 8, ENC_S, 4),  # the local locations moved by 1 / 4 / 16 px
    ("moved4", 8, ENC_S, 4),
    ("moved16", 8, ENC_S, 4),
    ("local", 4, ENC_S, 4),  # a tensor-parallel rank's 4 heads
    ("local", 8, ENC_S - 13, 4),  # Lq not a multiple of 8
    ("local", 8, ENC_S, 2),  # P = 2
]


@pytest.mark.parametrize("case,h,lq,p", RUN_CASES[:3] + [
    ("one_cell", 8, ENC_S, 4)] + RUN_CASES[3:])  # every sample in one cell
def test_msda_bwd_f64_run_route(cuda, case, h, lq, p):
    """The encoder's f64 launches through msda_bwd_run_kernel<double>,
    against the plain f64 backward at F64_TOL (chip_smoke.py phase 15f's)."""
    value, loc, attn, g = _run_route_inputs(case, h, lq, p, torch.float64)
    got = _bwd_routed(value, ENC_SHAPES, loc, attn, g, F64_RUN)
    _assert_f64_bwd_close(got, value, ENC_SHAPES, loc, attn, g)


@pytest.mark.parametrize("case,h,lq,p", RUN_CASES)
def test_msda_bwd_f32_run_route(cuda, case, h, lq, p):
    """The same launches in f32 through msda_bwd_run_kernel<float>, the one
    body both types share, against the plain backward at chip_smoke.py's
    f32 tolerances (rtol 1e-4, atol 1e-5; grad_loc's atol times the
    largest level side). Not one_cell: 40,800 addends of one row in f32
    differ by their order beyond those."""
    value, loc, attn, g = _run_route_inputs(case, h, lq, p, torch.float32)
    got = _bwd_routed(value, ENC_SHAPES, loc, attn, g,
                      "msda_bwd_run_kernel f32")
    side = max(max(hw) for hw in ENC_SHAPES)
    want = msda.ms_deform_attn_plain_bwd(value, ENC_SHAPES, loc, attn, g)
    for part, a, b in zip(("value", "loc", "attn"), got, want):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-5 * (side if part == "loc" else 1),
            msg=lambda m: f"grad_{part}: {m}")


@pytest.mark.parametrize("d,lq,aligned,route", [
    (32, 37, True, F64_SHORT),  # a short launch: 16 lanes x 2 doubles a row
    (32, LONG_LQ, True, F64_RUN),  # long: the run kernel
    (64, LONG_LQ, True, F64_SHORT),  # D = 64: channel chunks
    (32, LONG_LQ, False, F64_SHORT),  # rows off 16 bytes: scalar loads
    (32, 37, False, F64_SHORT),
])
def test_msda_bwd_f64_routes_by_geometry(cuda, d, lq, aligned, route):
    """Which f64 launches take the run route and which keep
    msda_bwd_kernel, each against the plain f64 backward."""
    value, loc, attn = _f64_inputs(lq, LONG_H, d, 4, "outside")
    g = torch.randn(2, lq, LONG_H * d, device="cuda", dtype=torch.float64,
                    generator=torch.Generator(device="cuda").manual_seed(6))
    if not aligned:
        value, g = _misaligned(value), _misaligned(g)
    got = _bwd_routed(value, SHAPES, loc, attn, g, route)
    _assert_f64_bwd_close(got, value, SHAPES, loc, attn, g)


def test_f64_cuda_never_reaches_the_plain_version(cuda):
    """f64 CUDA tensors go to the f64 kernels through the dispatcher, and
    an f64 value with f32 locations is refused, not computed otherwise."""
    value, loc, attn = _f64_inputs(5, 2, 32, 2, "random")
    before = msda.msda_fwd.launches
    with mock_plain_raises():
        out = msda.ms_deform_attn(value, SHAPES, loc, attn)
    assert out.dtype == torch.float64
    assert msda.msda_fwd.launches == before + 1
    with pytest.raises(ValueError, match="float64"):
        msda.msda_fwd(value, SHAPES, loc.float(), attn.float())


def mock_plain_raises():
    from unittest import mock

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    return mock.patch.object(msda, "ms_deform_attn_plain", refuse)


def test_export_round_trip_on_the_card(cuda, tmp_path):
    """A tiny DINO's eval forward exported on the card, saved, loaded by
    tools/export_model.load_exported and run: equal to eager bit for bit,
    one msda_fwd launch per MSDeformAttn."""
    from datr_torch.tools import export_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = DINO(num_classes=4, num_queries=12, hidden_dim=32, nheads=2,
                 enc_layers=1, dec_layers=2, dim_feedforward=64)
    model = model.init_params(torch.Generator().manual_seed(0)).to(cuda)
    ep = export_model.build_exported(model, 1, (96, 128))
    assert export_model.msda_nodes(ep) == 3
    path = tmp_path / "tiny.pt2"
    torch.export.save(ep, str(path))
    loaded = export_model.load_exported(str(path))
    g = torch.Generator().manual_seed(1)
    img = torch.randn(1, 96, 128, 3, generator=g).to(cuda)
    pad = torch.zeros(1, 96, 128, dtype=torch.bool, device=cuda)
    pad[0, 70:] = True
    with torch.no_grad():
        want = export_model.EvalForward(model.eval())(img, pad)
        before = msda.msda_fwd.launches
        got = loaded(img, pad)
        torch.cuda.synchronize()
    assert msda.msda_fwd.launches == before + 3
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
