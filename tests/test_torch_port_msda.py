"""The port's plain MSDA (datr_torch/ops/msda.py) against datr_tpu's three
formulations on the CPU: the Pallas kernel in interpret mode, the per-corner
XLA oracle and the quad-packed XLA op. Tolerance rtol 1e-4 / atol 1e-5, as
datr_tpu's own MSDA tests (tests/test_msda_pallas.py:39). The last section
covers the regimes the CUDA kernels have separate paths for (L*P above 32,
D of each vector width, model-like locations): the plain versions are what
those kernels are held against on the card."""

import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from jax.experimental.pallas import tpu as pltpu

from datr_torch.models.layers import directional_offset_bias
from datr_torch.ops import _build, msda
from datr_tpu.ops import msda_pallas
from datr_tpu.ops.msda import ms_deform_attn_quad, ms_deform_attn_xla

# power-of-two sides keep (i + 0.5) / W * W - 0.5 == i exact in f32
SHAPES = ((8, 4), (4, 2), (2, 8))
S = sum(h * w for h, w in SHAPES)
B, LQ, H, D, P = 2, 7, 2, 32, 2
L = len(SHAPES)


def _inputs(case):
    rng = np.random.default_rng({"random": 0, "integer": 1, "outside": 2}[case])
    value = rng.standard_normal((B, S, H, D)).astype(np.float32)
    attn = rng.random((B, LQ, H, L, P)).astype(np.float32)
    attn /= attn.sum(axis=(-1, -2), keepdims=True)
    if case == "random":
        loc = rng.random((B, LQ, H, L, P, 2))
    elif case == "integer":
        # sample exactly on pixel centres, including the -1 and W borders
        wh = np.array([(w, h) for h, w in SHAPES], np.float64)
        ij = rng.integers(-1, wh[:, None, :] + 1, (B, LQ, H, L, P, 2))
        loc = (ij + 0.5) / wh[:, None, :]
    else:
        loc = rng.random((B, LQ, H, L, P, 2)) * 1.6 - 0.3
    return value, loc.astype(np.float32), attn


def _plain(value, loc, attn):
    return msda.ms_deform_attn(torch.from_numpy(value), SHAPES,
                               torch.from_numpy(loc),
                               torch.from_numpy(attn)).numpy()


CASES = ["random", "integer", "outside"]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret(case):
    value, loc, attn = _inputs(case)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(msda_pallas.ms_deform_attn_pallas_fwd(
            value, SHAPES, loc, attn))
    np.testing.assert_allclose(_plain(value, loc, attn), want,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_xla(case):
    value, loc, attn = _inputs(case)
    want = np.asarray(ms_deform_attn_xla(value, SHAPES, loc, attn))
    np.testing.assert_allclose(_plain(value, loc, attn), want,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_quad(case):
    value, loc, attn = _inputs(case)
    want = np.asarray(ms_deform_attn_quad(value, SHAPES, loc, attn))
    np.testing.assert_allclose(_plain(value, loc, attn), want,
                               rtol=1e-4, atol=1e-5)


def test_integer_case_hits_pixel_centres():
    """The edge set really lands on exact integer pixel coordinates."""
    _, loc, _ = _inputs("integer")
    for lvl, (h, w) in enumerate(SHAPES):
        x = loc[..., lvl, :, 0] * np.float32(w) - np.float32(0.5)
        assert np.array_equal(x, np.round(x))


def test_cpu_dispatch_never_counts_launches():
    value, loc, attn = _inputs("random")
    before = msda.msda_fwd.launches
    _plain(value, loc, attn)
    assert msda.msda_fwd.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel wrapper never runs the plain version."""
    value, loc, attn = (torch.from_numpy(a) for a in _inputs("random"))
    before = msda.msda_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        msda.msda_fwd(value, SHAPES, loc, attn)
    assert msda.msda_fwd.launches == before


def test_dispatcher_rejects_other_devices():
    value, loc, attn = (torch.from_numpy(a).to("meta")
                        for a in _inputs("random"))
    with pytest.raises(ValueError, match="unsupported device"):
        msda.ms_deform_attn(value, SHAPES, loc, attn)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(out_dir=tmp_path / "out")


# ---------------- gradients ----------------


def _inputs_d(case, d):
    value, loc, attn = _inputs(case)
    value = np.random.default_rng(d).standard_normal(
        (B, S, H, d)).astype(np.float32)
    g = np.random.default_rng(d + 1).standard_normal(
        (B, LQ, H * d)).astype(np.float32)
    return value, loc, attn, g


def _port_grads(value, loc, attn, g):
    v, l, a, gg = (torch.from_numpy(x) for x in (value, loc, attn, g))
    return [x.numpy() for x in msda.ms_deform_attn_plain_bwd(v, SHAPES, l, a,
                                                              gg)]


def _assert_grads(got, want):
    for name, a, b in zip(("value", "loc", "attn"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=f"grad_{name}")


@pytest.mark.parametrize("case,d", [(c, 32) for c in CASES]
                         + [("random", 8), ("integer", 8)])
def test_plain_grads_match_jax_autodiff(case, d):
    """The port's plain VJP against jax.grad of datr_tpu's default
    ms_deform_attn(impl="xla"): the quad formulation at D=32 (4*D = 128),
    the per-corner one at D=8. Integer locations sit where the bilinear
    slope is one-sided, so the corner choice decides grad_loc."""
    import jax

    from datr_tpu.ops.msda import ms_deform_attn as jax_msda

    value, loc, attn, g = _inputs_d(case, d)
    _, vjp = jax.vjp(lambda v, l, a: jax_msda(v, SHAPES, l, a, impl="xla"),
                     value, loc, attn)
    _assert_grads(_port_grads(value, loc, attn, g), vjp(g))


@pytest.mark.parametrize("case", ["random", "integer"])
def test_plain_grads_match_pallas_custom_vjp(case):
    """Against ms_deform_attn_pallas's custom VJP with its forward in
    interpret mode, as tests/test_msda_pallas.py runs it."""
    import jax

    value, loc, attn, g = _inputs_d(case, 8)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda v, l, a: msda_pallas.ms_deform_attn_pallas(
            v, SHAPES, l, a), value, loc, attn)
        want = vjp(g)
    _assert_grads(_port_grads(value, loc, attn, g), want)


def test_cpu_dispatch_is_differentiable():
    """On the CPU the dispatcher returns the plain version, which autograd
    differentiates: the same gradients as ms_deform_attn_plain_bwd, and no
    kernel launch counted."""
    value, loc, attn, g = (torch.from_numpy(a) for a in _inputs_d("random", 8))
    leaves = [x.clone().requires_grad_() for x in (value, loc, attn)]
    before = (msda.msda_fwd.launches, msda.msda_bwd.launches)
    out = msda.ms_deform_attn(leaves[0], SHAPES, leaves[1], leaves[2])
    out.backward(g)
    assert (msda.msda_fwd.launches, msda.msda_bwd.launches) == before
    want = msda.ms_deform_attn_plain_bwd(value, SHAPES, loc, attn, g)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)


def test_bwd_wrapper_refuses_cpu_tensors():
    value, loc, attn, g = (torch.from_numpy(a) for a in _inputs_d("random", 8))
    before = msda.msda_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        msda.msda_bwd(value, SHAPES, loc, attn, g)
    assert msda.msda_bwd.launches == before


# ---------------- the regimes the redesigned kernels have paths for ----------

# (shapes, H, D, P): L*P > 32 takes a second chunk of samples (L 4, P 9);
# D 8 is a multiple of 4 (16-byte f32 vectors), 6 of 2 only, 5 odd
REGIMES = {
    "LP36": (((8, 4), (4, 2), (2, 8), (4, 4)), 2, 8, 9),
    "D8": (SHAPES, 2, 8, 2),
    "D6": (SHAPES, 2, 6, 2),
    "D5": (SHAPES, 1, 5, 2),
}


def _regime_inputs(regime, case):
    """numpy-seeded inputs; `case` "random" or "model": every query a pixel of
    a level (its centre the reference point on all levels), offsets the
    directional bias of a freshly initialised MSDeformAttn, which land on
    pixel centres of the query's own level and on and beyond the borders."""
    shapes, h, d, p = REGIMES[regime]
    lv = len(shapes)
    s = sum(a * b for a, b in shapes)
    rng = np.random.default_rng(sum(map(ord, regime + case)))
    value = rng.standard_normal((B, s, h, d)).astype(np.float32)
    if case == "random":
        lq = LQ
        loc = rng.random((B, lq, h, lv, p, 2)).astype(np.float32)
    else:
        ref = np.concatenate([
            np.stack(np.meshgrid((np.arange(w) + 0.5) / w,
                                 (np.arange(hh) + 0.5) / hh), -1).reshape(-1, 2)
            for hh, w in shapes]).astype(np.float32)  # [S, 2] (x, y)
        lq = s
        off = directional_offset_bias(h, lv, p).numpy().reshape(h, lv, p, 2)
        wh = np.array([(w, hh) for hh, w in shapes], np.float32)
        loc = (ref[None, :, None, None, None, :]
               + off[None, None] / wh[None, None, None, :, None, :])
        loc = np.broadcast_to(loc, (B, lq, h, lv, p, 2)).astype(np.float32)
    attn = rng.random((B, lq, h, lv, p)).astype(np.float32)
    attn /= attn.sum(axis=(-1, -2), keepdims=True)
    g = rng.standard_normal((B, lq, h * d)).astype(np.float32)
    return shapes, value, np.ascontiguousarray(loc), attn, g


REGIME_CASES = [(r, c) for r in REGIMES for c in ("random", "model")]


@pytest.mark.parametrize("regime,case", REGIME_CASES)
def test_plain_matches_xla_in_kernel_regimes(regime, case):
    """ms_deform_attn_plain against ms_deform_attn_xla, rtol 1e-4 / atol 1e-5
    (f32, the sums in another order)."""
    shapes, value, loc, attn, _ = _regime_inputs(regime, case)
    got = msda.ms_deform_attn_plain(torch.from_numpy(value), shapes,
                                    torch.from_numpy(loc),
                                    torch.from_numpy(attn)).numpy()
    want = np.asarray(ms_deform_attn_xla(value, shapes, loc, attn))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("regime,case", REGIME_CASES)
def test_plain_grads_match_xla_in_kernel_regimes(regime, case):
    """ms_deform_attn_plain_bwd against jax.vjp of ms_deform_attn_xla, rtol
    1e-4 / atol 1e-5. At the model-like locations the samples of a query's own
    level sit on pixel centres, where the corner choice decides grad_loc."""
    import jax

    shapes, value, loc, attn, g = _regime_inputs(regime, case)
    _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_xla(v, shapes, l, a),
                     value, loc, attn)
    v, l, a, gg = (torch.from_numpy(x) for x in (value, loc, attn, g))
    got = [x.numpy() for x in msda.ms_deform_attn_plain_bwd(v, shapes, l, a,
                                                             gg)]
    _assert_grads(got, vjp(g))


@pytest.mark.parametrize("regime", ["D8", "D5"])
def test_plain_matches_pallas_interpret_in_kernel_regimes(regime):
    """The same against the Pallas kernel in interpret mode, at the
    model-like locations."""
    shapes, value, loc, attn, _ = _regime_inputs(regime, "model")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(msda_pallas.ms_deform_attn_pallas_fwd(
            value, shapes, loc, attn))
    got = msda.ms_deform_attn_plain(torch.from_numpy(value), shapes,
                                    torch.from_numpy(loc),
                                    torch.from_numpy(attn)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_model_like_locations_hit_centres_and_borders():
    """The model-like set really has samples on exact pixel centres of the
    query's own level, and samples outside the level."""
    shapes, _, loc, _, _ = _regime_inputs("D8", "model")
    h0, w0 = shapes[0]
    x = loc[0, :h0 * w0, :, 0, :, 0] * np.float32(w0) - np.float32(0.5)
    assert np.array_equal(x, np.round(x))
    assert (loc < 0).any() and (loc > 1).any()
