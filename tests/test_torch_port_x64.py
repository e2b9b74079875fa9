"""amp_dtype="float64" (datr_tpu's x64 debugging mode, datr_tpu/models/
dino.py:637-642) on the CPU, against datr_tpu evaluated under
`jax.enable_x64(True)` (a context, never a global jax.config update, which
would leak into the other files of an xdist worker).

- The plain MSDA takes f64 value, locations and weights and computes in
  f64: held to an f64 MSDA assembled from datr_tpu's own corner function
  (`_corner_gather_indices`, dtype-generic) at 1e-12, its VJP likewise;
  and equal to datr_tpu's `ms_deform_attn_xla` in x64 on inputs its f32
  roundings keep exact (that op rounds the locations to f32 and sums in
  f32 even in x64 mode, datr_tpu/ops/msda.py:337-362).
- A small f64 model against datr_tpu's x64 model on the same parameters:
  the two-stage top-k equal, logits within 1e-5 and boxes within 1e-6.
  datr_tpu's x64 mode keeps f32 islands the port's float64 mode does not:
  its frozen BN computes its scale from the f32 parameters and returns f32
  (resnet.py:34-35), MSDA's locations and sums are f32 (layers.py:131-133,
  above), and its f32 constants (the sine embeddings' powers) are XLA's f32
  roundings; measured on this model they move logits by up to 1.7e-6 and
  boxes by 1.9e-7, so the 1e-9 an all-f64 pair would allow is not
  reachable here, and the limits are set above the measurement.
- The CLI trains and evaluates with `--options amp_dtype=float64`."""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.config import apply_overrides, load_config
from datr_torch.convert import load_flax_params
from datr_torch.models.dino import build_dino_from_config
from datr_torch.ops import msda
from datr_tpu import config as jconfig
from datr_tpu.models.dino import build_dino_from_config as jax_build
from datr_tpu.ops.msda import _corner_gather_indices, ms_deform_attn_xla

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_bf16 import seeded_params  # noqa: E402
from test_torch_port_configs import TINY  # noqa: E402

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
# power-of-two sides keep loc * W exact in f32
SHAPES = ((8, 4), (4, 2), (2, 8))
S = sum(h * w for h, w in SHAPES)
B, LQ, H, D, P = 2, 7, 2, 32, 2
L = len(SHAPES)
F64 = dict(rtol=1e-12, atol=1e-12)


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((B, S, H, D))
    attn = rng.random((B, LQ, H, L, P))
    attn /= attn.sum(axis=(-1, -2), keepdims=True)
    wh = np.array([(w, h) for h, w in SHAPES], np.float64)
    if case == "random":
        loc = rng.random((B, LQ, H, L, P, 2))
    elif case == "integer":  # pixel centres, the -1 and W borders included
        loc = (rng.integers(-1, wh[:, None, :] + 1, (B, LQ, H, L, P, 2))
               + 0.5) / wh[:, None, :]
    else:
        loc = rng.random((B, LQ, H, L, P, 2)) * 1.6 - 0.3
    return value, loc, attn


def msda_f64(value, spatial_shapes, loc, attn):
    """MSDA in f64 from datr_tpu's corner function (its ms_deform_attn_xla
    with the f32 casts taken out): f64 locations, weights and sums."""
    Bv, Sv, Hv, Dv = value.shape
    _, Lq, _, Lv, Pv, _ = loc.shape
    idx, cw = _corner_gather_indices(loc, spatial_shapes)
    rows = jnp.swapaxes(value, 1, 2).reshape(Bv * Hv * Sv, Dv)
    off = jnp.arange(Bv * Hv).reshape(Bv, Hv, 1) * Sv
    at = jnp.transpose(attn, (0, 2, 1, 3, 4))
    out = jnp.zeros((Bv, Hv, Lq, Dv), value.dtype)
    for i, w in zip(idx, cw):
        ib = jnp.transpose(i, (0, 2, 1, 3, 4))
        wa = jnp.transpose(w, (0, 2, 1, 3, 4)) * at
        for lvl in range(Lv):
            g = jnp.take(rows, (ib[:, :, :, lvl].reshape(Bv, Hv, Lq * Pv)
                                + off).reshape(-1), axis=0)
            out = out + jnp.einsum("bhqpd,bhqp->bhqd",
                                   g.reshape(Bv, Hv, Lq, Pv, Dv),
                                   wa[:, :, :, lvl])
    return jnp.transpose(out, (0, 2, 1, 3)).reshape(Bv, Lq, Hv * Dv)


@pytest.mark.parametrize("case", ["random", "integer", "outside"])
def test_plain_f64_msda_and_vjp(case):
    value, loc, attn = _inputs(case)
    g = np.random.default_rng(9).standard_normal((B, LQ, H * D))
    t = [torch.from_numpy(x) for x in (value, loc, attn)]
    got = msda.ms_deform_attn(t[0], SHAPES, t[1], t[2])
    got_b = msda.ms_deform_attn_plain_bwd(*t[:1], SHAPES, *t[1:],
                                          torch.from_numpy(g))
    assert got.dtype == torch.float64
    assert all(x.dtype == torch.float64 for x in got_b)
    with jax.enable_x64(True):
        want, vjp = jax.vjp(lambda v, lc, a: msda_f64(v, SHAPES, lc, a),
                            jnp.asarray(value), jnp.asarray(loc),
                            jnp.asarray(attn))
        want_b = jax.device_get(vjp(jnp.asarray(g)))
        want = jax.device_get(want)
    np.testing.assert_allclose(got.numpy(), want, **F64)
    side = max(max(hw) for hw in SHAPES)
    for part, a, b in zip(("value", "loc", "attn"), got_b, want_b):
        np.testing.assert_allclose(
            a.numpy(), b, rtol=F64["rtol"],
            atol=F64["atol"] * (side if part == "loc" else 1), err_msg=part)


def test_plain_f64_msda_equals_datr_tpu_where_f32_is_exact():
    """Dyadic inputs of few bits (locations on quarter pixels of the
    power-of-two levels, values k/8, weights k/16): datr_tpu's x64
    ms_deform_attn_xla, which rounds the locations to f32 and sums in f32,
    loses nothing on them, and the port's f64 plain version equals it."""
    rng = np.random.default_rng(4)
    wh = np.array([(w, h) for h, w in SHAPES], np.float64)
    q = rng.integers(-4, 4 * (wh[:, None, :] + 1), (B, LQ, H, L, P, 2))
    loc = (q / 4.0 + 0.5) / wh[:, None, :]
    value = rng.integers(-32, 33, (B, S, H, D)) / 8.0
    attn = rng.integers(0, 17, (B, LQ, H, L, P)) / 16.0
    got = msda.ms_deform_attn(*(torch.from_numpy(x) for x in (value,)),
                              SHAPES, torch.from_numpy(loc),
                              torch.from_numpy(attn))
    with jax.enable_x64(True):
        want = jax.device_get(ms_deform_attn_xla(
            jnp.asarray(value), SHAPES, jnp.asarray(loc),
            jnp.asarray(attn)))
    assert want.dtype == np.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_f64_model_matches_datr_tpu_x64():
    path = "configs/DINO/DINO_4scale.py"
    opts = TINY + ["amp_dtype=float64"]
    canvas = (64, 96)
    tm = build_dino_from_config(apply_overrides(load_config(path), opts),
                                device="cpu").eval()
    assert tm.dtype == torch.float64
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, *canvas, 3)).astype(np.float32)
    pm = np.zeros((2, *canvas), bool)
    pm[0, 52:] = True
    pm[1, :, 75:] = True
    img[pm] = 0.0
    seen = {}
    top_k = jax.lax.top_k

    def spy(x, k):  # the first top_k of the forward is the two-stage one
        v, i = top_k(x, k)
        seen.setdefault("idx", i)
        return v, i

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        jm = jax_build(jconfig.apply_overrides(jconfig.load_config(path),
                                               opts))
        shapes = jax.eval_shape(lambda k: jm.init(
            k, jnp.zeros((1, *canvas, 3)), jnp.zeros((1, *canvas), bool),
            train=False), jax.random.PRNGKey(0))
        params = {"params": seeded_params(shapes["params"])}
        mp.setattr(jax.lax, "top_k", spy)
        want, want_idx = jax.device_get(jax.jit(
            lambda p, a, b: (jm.apply(p, a, b, train=False), seen["idx"]),
            compiler_options=FAST)(params, img, pm))
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(pm))
    np.testing.assert_array_equal(got["topk_idx"].numpy(), want_idx)
    for key, w in want.items():
        assert got[key].dtype == torch.float64 or key == "init_box_proposal"
        atol = 1e-5 if "logits" in key else 1e-6
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=atol,
                                   err_msg=key)


def test_cli_runs_float64(tmp_path):
    """`python -m datr_torch.main --options amp_dtype=float64`: one tiny
    burn-in epoch and its evaluations, finite losses in the log."""
    import json

    from datr_torch.main import get_args_parser, main

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_port_cli import _cfg

    out = tmp_path / "out"
    main(get_args_parser().parse_args([
        "-c", _cfg(tmp_path), "--output_dir", str(out), "--synthetic",
        "--device", "cpu", "--num_workers",
        str(torch_port_threads.loader_threads(2)),
        "--options", "amp_dtype=float64"]))
    lines = [json.loads(ln) for ln in (out / "log.txt").read_text()
             .splitlines() if ln.startswith("{")]
    assert lines and np.isfinite(lines[-1]["train_loss"])
    assert "ap50_student" in lines[-1]
    shutil.rmtree(out)  # ~1 GB of checkpoints: the suite shares one disk
