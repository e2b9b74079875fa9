"""The port's plain MSDA (datr_torch/ops/msda.py) against datr_tpu's three
formulations on the CPU: the Pallas kernel in interpret mode, the per-corner
XLA oracle and the quad-packed XLA op. Tolerance rtol 1e-4 / atol 1e-5, as
datr_tpu's own MSDA tests (tests/test_msda_pallas.py:39)."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

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
