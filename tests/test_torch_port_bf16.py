"""The port's bfloat16 model against datr_tpu's on the CPU: the norms (plain
and fast), the MSDA forward and VJP, one encoder and one decoder layer
rounding by rounding, and the eval forward with fast_norm off and on (one
bf16 training step: tests/test_torch_port_bf16_train.py; bf16 through the
port's entry points: tests/test_torch_port_bf16_entry.py).

datr_tpu runs in bf16 on JAX-CPU at a tiny width (hidden 64, 2 heads, so
D = 32 and its default quad MSDA path; 1 encoder and 2 decoder layers; a
64x96 canvas), each reference jitted once. Its parameters are seeded numpy
draws of the shapes `jax.eval_shape` gives (no init is compiled), carried
into the port by `load_flax_params`. The port rounds where datr_tpu's ops
round, but for one documented difference: its MSDA sums in f32 and rounds
once, where datr_tpu's quad path rounds its corner weights to bf16. By
default XLA:CPU also keeps f32 inside a fusion, so over a whole model the
two part at the first differing rounding and the tolerances are bf16
envelopes, stated per test; the layer test compiles datr_tpu to round every
op and holds the port to it bit for bit. The discrete choices (the
two-stage top-k) are replayed from datr_tpu's run, and the count of
positions where the port's own choice differs is printed."""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from flax import linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from datr_torch.convert import load_flax_params, state_dict_from_flax
from datr_torch.models import dino as tdino
from datr_torch.models import norms as tnorms
from datr_torch.models import transformer as ttrans
from datr_torch.ops import msda as tmsda
from datr_tpu.models import layers as jlayers
from datr_tpu.models import norms as jnorms
from datr_tpu.models import transformer as jtrans
from datr_tpu.ops import msda as jmsda
from datr_tpu.models.dino import DINO as JaxDINO
from datr_tpu.ops.msda import ms_deform_attn as jax_msda

CANVAS = (64, 96)
K = 4
KW = dict(num_classes=K, num_queries=12, hidden_dim=64, nheads=2,
          enc_layers=1, dec_layers=2, dim_feedforward=64)
BF16 = torch.bfloat16


def seeded_params(shapes, seed=0):
    """Seeded numpy values for a flax parameter tree of these shapes:
    kernels N(0, 1/fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2),
    frozen-BN variances in [1, 1.2), embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in flatten_dict(shapes).items():
        shape, name = leaf.shape, path[-1]
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "running_var":
            v = 1.0 + 0.2 * rng.random(shape)
        elif name in ("scale", "weight"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "running_mean"):
            v = 0.1 * rng.standard_normal(shape)
        else:  # level_embed, tgt_embed, label_enc
            v = rng.standard_normal(shape)
        flat[path] = v.astype(np.float32)
    return unflatten_dict(flat)


def rel(a, b) -> float:
    """|a - b| / |b| of two gradients, torch or numpy."""
    a, b = to_np(a), to_np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def to_np(x) -> np.ndarray:
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


# ---------------- the norms ----------------


@pytest.mark.parametrize("kind", ["layer", "group"])
@pytest.mark.parametrize("fast", [False, True])
def test_norm_matches_datr_tpu(kind, fast):
    """The port's bf16 norm (its factory's pick) against datr_tpu's on the
    same bf16 input and parameters, within tests/test_fast_norm.py:25's
    envelope: atol 0.03 / rtol 0.02, mean |diff| < 5e-3."""
    rng = np.random.default_rng(1 if kind == "group" else 0)
    C = 64
    if kind == "layer":
        x = (rng.standard_normal((4, 37, C)) * 3 + 1.5)
        jm = (jnorms.FastLayerNorm(dtype=jnp.bfloat16) if fast
              else fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16))
        tm = tnorms.layer_norm(C, BF16, fast)
    else:
        x = rng.standard_normal((2, 13, 17, C)) * 2 - 0.5
        jm = (jnorms.FastGroupNorm(dtype=jnp.bfloat16) if fast
              else fnn.GroupNorm(num_groups=32, epsilon=1e-5,
                                 dtype=jnp.bfloat16))
        tm = tnorms.group_norm(C, BF16, fast)
    assert isinstance(tm, (tnorms.FastLayerNorm, tnorms.FastGroupNorm)) \
        == fast
    xb = jnp.asarray(x, jnp.bfloat16)
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    want = jax.jit(jm.apply)({"params": {"scale": scale, "bias": bias}}, xb)
    assert want.dtype == jnp.bfloat16
    tm.weight.data = torch.from_numpy(scale)
    tm.bias.data = torch.from_numpy(bias)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(BF16)
    if kind == "group":  # NHWC in datr_tpu, NCHW in the port
        got = tm(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    else:
        got = tm(xt)
    assert got.dtype == BF16
    a, b = to_np(got.detach()), to_np(want)
    np.testing.assert_allclose(a, b, atol=0.03, rtol=0.02)
    assert np.abs(a - b).mean() < 5e-3


# ---------------- MSDA ----------------

MSDA_SHAPES = ((8, 12), (4, 6), (2, 3), (1, 2))


@pytest.mark.parametrize("lq", [137, 30])  # every token a query; decoder-like
def test_msda_bf16_forward_and_vjp(lq):
    """The plain bf16 MSDA (value bf16, loc / attn f32) against datr_tpu's
    ms_deform_attn in bf16 (D = 32: its quad path): the forward within 2
    bf16 ulps of the output's largest magnitude; its VJP (grad_value bf16,
    grad_loc / grad_attn f32, as the kernel returns them) within 2e-2 of
    each gradient's norm. datr_tpu rounds its corner weights and their
    products to bf16; the port keeps them in f32 and rounds the sum once."""
    rng = np.random.default_rng(lq)
    B, H, D, L, P = 2, 2, 32, len(MSDA_SHAPES), 4
    S = sum(h * w for h, w in MSDA_SHAPES)
    value = jnp.asarray(rng.standard_normal((B, S, H, D)), jnp.bfloat16)
    loc = rng.random((B, lq, H, L, P, 2)).astype(np.float32) * 1.2 - 0.1
    attn = rng.random((B, lq, H, L, P)).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)
    g = jnp.asarray(rng.standard_normal((B, lq, H * D)), jnp.bfloat16)

    want, vjp = jax.vjp(
        lambda v, lo, a: jax_msda(v, MSDA_SHAPES, lo, a), value, loc, attn)
    want_grads = jax.jit(vjp)(g)
    tv = torch.from_numpy(np.array(value.astype(jnp.float32))).to(BF16)
    tg = torch.from_numpy(np.array(g.astype(jnp.float32))).to(BF16)
    got = tmsda.ms_deform_attn(tv, MSDA_SHAPES, torch.from_numpy(loc),
                               torch.from_numpy(attn))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    w = to_np(want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    np.testing.assert_allclose(to_np(got), w, rtol=0, atol=2 * ulp)

    got_grads = tmsda.ms_deform_attn_plain_bwd(
        tv, MSDA_SHAPES, torch.from_numpy(loc), torch.from_numpy(attn), tg)
    assert [t.dtype for t in got_grads] == [BF16, torch.float32,
                                            torch.float32]
    for name, a, b in zip(("value", "loc", "attn"), got_grads, want_grads):
        a, b = to_np(a), to_np(b)
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err <= 2e-2, (name, err)


# ---------------- one layer, rounding by rounding ----------------

# XLA rounds each op to its bf16 result (no f32 kept inside a fusion), as
# eager PyTorch does; the two LLVM options halve the compile's time and
# leave the function as it is
COMPILE = {"xla_allow_excess_precision": False,
           "xla_backend_optimization_level": 0,
           "xla_llvm_disable_expensive_passes": True}


def f32_msda(value, spatial_shapes, loc, attn, **_):
    """MSDA as the port computes it: the bf16 value read in f32, f32 sums,
    the result rounded once to the value's dtype."""
    f32 = jnp.float32
    return jmsda.ms_deform_attn_xla.__wrapped__(
        value.astype(f32), tuple(map(tuple, spatial_shapes)),
        loc.astype(f32), attn.astype(f32)).astype(value.dtype)


def port_differences():
    """datr_tpu with the port's documented difference of bf16 rounding in
    its place: MSDA summed in f32."""
    return [mock.patch.object(jlayers, "ms_deform_attn", f32_msda)]


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layer_rounds_as_datr_tpu(kind):
    """One deformable layer in bf16 (hidden 64, 2 heads, 4 levels, 4
    points, FFN 64; the decoder's self-attention too), forward and VJP,
    against datr_tpu's layer with the port's documented MSDA difference in
    its place (see `port_differences`), compiled to round every op: each
    Linear, softmax, norm and residual rounds where datr_tpu rounds, so the
    outputs agree bit for bit but where a sum's order differs. The control,
    the port's layer in f32 with its output rounded to bf16 once, agrees at
    a third of them. Measured: output equal at 0.999 (encoder) / 1.000
    (decoder), the control at 0.334 / 0.296; every gradient (parameters and
    inputs) within 1.4e-2 of its norm, median 6.4e-3, the control's median
    2.9e-2 / 2.0e-2."""
    rng = np.random.default_rng(7)
    C, NQ, L = 64, 12, len(MSDA_SHAPES)
    S = sum(h * w for h, w in MSDA_SHAPES)
    bf = jnp.bfloat16
    bf_input = lambda *shape: jnp.asarray(rng.standard_normal(shape), bf)
    mask = np.zeros((2, S), bool)
    mask[1, -3:] = True
    if kind == "encoder":
        jm = jtrans.DeformableEncoderLayer(C, 64, L, 2, 4, dtype=bf)
        ref = rng.random((2, S, L, 2)).astype(np.float32)
        args = [bf_input(2, S, C), bf_input(2, S, C)]
        rest = (ref, MSDA_SHAPES, mask)
        tm = ttrans.DeformableEncoderLayer
    else:
        jm = jtrans.DeformableDecoderLayer(C, 64, L, 2, 4, dtype=bf)
        ref = rng.random((2, NQ, L, 4)).astype(np.float32) * 0.6 + 0.2
        args = [bf_input(2, NQ, C), bf_input(2, NQ, C), bf_input(2, S, C)]
        rest = (ref, MSDA_SHAPES, mask)
        tm = ttrans.DeformableDecoderLayer
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                            *rest))
    params = {"params": seeded_params(shapes["params"], 3)}
    g = bf_input(*args[0].shape)

    def fwd_vjp(p, *a):
        out, vjp = jax.vjp(lambda p, *a: jm.apply(p, *a, *rest), p, *a)
        return out, vjp(g)

    with contextlib.ExitStack() as stack:
        for patch in port_differences():
            stack.enter_context(patch)
        want, (want_gp, *want_ga) = jax.device_get(jax.jit(
            fwd_vjp, compiler_options=COMPILE)(params, *args))
    want_gp = state_dict_from_flax(want_gp)

    def port(dtype):
        m = tm(C, 64, L, 2, 4, dtype=dtype)
        m.load_state_dict(state_dict_from_flax(params), strict=True)
        xs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            dtype).requires_grad_() for a in args]
        out = m(*xs, torch.from_numpy(ref), MSDA_SHAPES,
                torch.from_numpy(mask))
        out.backward(torch.from_numpy(np.array(g.astype(jnp.float32))).to(
            out.dtype))
        equal = float((to_np(out.detach().to(BF16)) == to_np(want)).mean())
        errs = [rel(p.grad, want_gp[n]) for n, p in m.named_parameters()]
        errs += [rel(x.grad, w) for x, w in zip(xs, want_ga)]
        return out.dtype, equal, errs

    dtype, equal, errs = port(BF16)
    _, f32_equal, f32_errs = port(torch.float32)
    print(f"{kind} layer in bf16 against datr_tpu's: output equal at "
          f"{equal:.3f} (f32 control {f32_equal:.3f}); gradients largest "
          f"{max(errs):.3g} median {np.median(errs):.3g} (f32 control "
          f"median {np.median(f32_errs):.3g})")
    assert dtype == BF16
    assert equal >= 0.99 and f32_equal < 0.5
    assert max(errs) <= 2e-2 and np.median(errs) <= 1e-2
    assert np.median(f32_errs) > 1e-2


# ---------------- the eval forward ----------------


@pytest.fixture(scope="module")
def eval_case():
    """A padded batch and seeded parameters for the tiny bf16 model."""
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, *CANVAS, 3)).astype(np.float32)
    pm = np.zeros((2, *CANVAS), bool)
    pm[0, 50:] = True
    pm[1, :, 70:] = True
    img[pm] = 0.0
    jm = JaxDINO(**KW, dn_number=2, dn_single_pad=2, dn_labelbook_size=K,
                 use_remat=False, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, *CANVAS, 3)), jnp.zeros((1, *CANVAS), bool),
        train=False), jax.random.PRNGKey(0))
    return img, pm, {"params": seeded_params(shapes["params"])}


@pytest.mark.parametrize("fast_norm", [False, True])
def test_eval_forward_bf16(eval_case, fast_norm, monkeypatch):
    """The whole bf16 eval forward with the two-stage top-k replayed from
    datr_tpu's run: every output in datr_tpu's dtype (logits bf16, boxes
    f32); boxes within atol 0.02 and logits within 0.25, the bf16 envelope
    of tests/test_fast_norm.py:63-66. Measured here: logits <= 0.0625,
    boxes <= 0.008."""
    img, pm, params = eval_case
    jm = JaxDINO(**KW, dn_number=2, dn_single_pad=2, dn_labelbook_size=K,
                 use_remat=False, dtype=jnp.bfloat16, fast_norm=fast_norm)
    seen = {}
    top_k = jax.lax.top_k

    def spy(x, k):  # the first top_k of the forward is the two-stage one
        v, i = top_k(x, k)
        seen.setdefault("idx", i)
        return v, i

    monkeypatch.setattr(jax.lax, "top_k", spy)
    want, want_idx = jax.device_get(jax.jit(
        lambda p, a, b: (jm.apply(p, a, b, train=False), seen["idx"]))(
            params, img, pm))
    tm = tdino.DINO(**KW, dtype=BF16, fast_norm=fast_norm)
    load_flax_params(tm, params)
    tm.eval()
    x, m = torch.from_numpy(img), torch.from_numpy(pm)
    held = torch.tensor(np.array(want_idx), dtype=torch.long)
    with torch.no_grad():
        own = tm(x, m)["topk_idx"]
        with mock.patch.object(tdino, "_stable_topk_indices",
                               lambda s, k: held):
            got = tm(x, m)
    print(f"fast_norm={fast_norm}: {(own.numpy() != want_idx).sum()} of "
          f"{own.numel()} top-k positions differ without replay; largest "
          f"differences", {k: float(np.abs(to_np(got[k]) - to_np(w)).max())
                           for k, w in want.items()})
    for key, w in want.items():
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
        atol = 0.25 if "logits" in key else 0.02
        np.testing.assert_allclose(to_np(got[key]), to_np(w), rtol=0,
                                   atol=atol, err_msg=key)
