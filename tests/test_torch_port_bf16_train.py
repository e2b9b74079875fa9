"""One bfloat16 burn-in training step of the port against datr_tpu's on the
CPU, at tests/test_torch_port_bf16.py's tiny width (hidden 64, 2 heads, 1
encoder and 2 decoder layers, 4 images at 64x96) with a ResNet of one
bottleneck block per stage on both sides (RESNET_STAGES, so that datr_tpu's
backward through the backbone compiles in seconds), seeded parameters: the
train forward's losses and every gradient, backbone included, and one
train_step_burnin keeping the parameters, AdamW's moments, the EMA track and
the prototype state in f32.

What is held to what:
- datr_tpu's bf16 step is compiled with xla_allow_excess_precision off, so
  XLA rounds every op to its bf16 result as eager PyTorch does (by default
  XLA:CPU keeps f32 between the ops of a fusion).
- The port's documented difference of bf16 rounding is put in datr_tpu's
  place, so that what remains is the rest of the model's casts: MSDA
  reads the bf16 value and sums in f32, as the port's kernel does
  (datr_tpu's quad path rounds its corner weights and products to bf16;
  tests/test_torch_port_bf16.py holds the port's MSDA VJP to that path).
  One layer at a time, the port then rounds where datr_tpu rounds, bit for
  bit (tests/test_torch_port_bf16.py::test_layer_rounds_as_datr_tpu); over
  the whole model the sums' order differs and the differences grow.
- Every discrete choice is replayed from datr_tpu's run, and the positions
  where the port's own choice differs are printed: the two-stage top-k of
  both passes, the matcher's assignments of every prediction set
  (SimpleMinsumMatcher on both sides: the Hungarian solver's compile would
  add ~7 s and the assignments are replayed either way), the prototypes'
  class of each query, the sign under every ReLU of the transformer and its
  heads, and the bilinear cell (floor) of every MSDA sample. A 1-ulp
  difference of a bf16 input flips such a choice now and then, and each
  flip moves a gradient by tens of percent: a decoder sample that changes
  cell changes its grad_loc outright. The backbone's ReLUs run as they
  fall (one unit's sign there moves no gradient by much).
- The control: the port's f32 step with the same weights and choices. The
  bounds are set between the two readings, and the test asserts that the
  control fails them: a port that computed its convolutions in f32 where
  datr_tpu takes bf16 fails them (checked by mutation); a Linear, norm or
  softmax rounded elsewhere moves the whole step's gradients too little to
  see, and the layer test above catches it.

The convolutions' biases are held looser: a bias gradient is a sum over
every position, and XLA:CPU sums a bf16 cotangent in bf16 there (3x3 conv,
4x32x48 positions: bias gradient -30.25 against the exact -40.34), where
PyTorch sums in f32.

The tiny shapes are not well conditioned everywhere: the stride-64 level is
1x2, so each of input_proj3's 32 GroupNorm groups normalizes 4 values, and
its gradient scales a rounding of its input by 1/std. With other seeded
parameters this can move the backbone's bf16 gradient by 15-30% in either
framework. The readings below are for this seed.
"""

import contextlib
import os
import sys
import types
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.convert import load_flax_params, state_dict_from_flax
from datr_torch.models import cdn as tcdn
from datr_torch.models import dino as tdino
from datr_torch.models import layers as tlayers
from datr_torch.models import resnet as tresnet
from datr_torch.models import transformer as ttransformer
from datr_torch.ops import msda as tmsda
from datr_torch.train import criterion as tcrit
from datr_torch.train.optim import Optimizer
from datr_torch.train.state import EMA_TRACKS, create_train_state
from datr_torch.train.steps import loss_and_grads, train_step_burnin
from datr_tpu.models import dino as jdino_mod
from datr_tpu.models.dino import DINO as JaxDINO
from datr_tpu.ops import matcher as jmatcher
from datr_tpu.ops import msda as jmsda
from datr_tpu.train import criterion as jcrit

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_bf16 import (  # noqa: E402
    COMPILE, port_differences, seeded_params)
from test_torch_port_train import (  # noqa: E402
    _jax_cdn_draws, _tiny_batch, t)

K, HD = 4, 64
MATCHER = "SimpleMinsumMatcher"
KW = dict(num_classes=K, num_queries=12, hidden_dim=HD, nheads=2,
          enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=4,
          dn_single_pad=2)
STAGES = (1, 1, 1, 1)
BF16 = torch.bfloat16


def _rel(a, b) -> float:
    return (a - b).norm().item() / max(b.norm().item(), 1e-12)


@pytest.fixture(scope="module")
def step():
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino_mod.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    try:
        yield _run_step()
    finally:
        mp.undo()


def _run_step():
    jm = JaxDINO(**KW, dn_labelbook_size=K, use_remat=False,
                 dtype=jnp.bfloat16)
    batch = {k: jnp.asarray(v) for k, v in _tiny_batch().items()}
    targets = {k: batch[k] for k in ("boxes", "labels", "valid")}
    gp, am = jnp.zeros((K, HD)), jnp.zeros((K,))
    dn_rng = jax.random.PRNGKey(2)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, batch["images"], batch["pad_mask"], targets=targets,
        dn_rng=dn_rng, train=True, global_proto=gp, amount=am),
        jax.random.PRNGKey(1))
    params = {"params": seeded_params(shapes["params"])}
    ccfg = jcrit.CriterionCfg(num_classes=K, dn_single_pad=2, dn_groups=2,
                              matcher_type=MATCHER)
    wd = jcrit.build_weight_dict(dec_layers=2)

    seen = {"topk": [], "cls": [], "relu": [], "floor": []}
    top_k, protos = jax.lax.top_k, jdino_mod.class_prototypes
    relu, floor = jax.nn.relu, jnp.floor

    def spy_topk(x, k):  # the source pass's, then the target pass's
        v, i = top_k(x, k)
        seen["topk"].append(i)
        return v, i

    def spy_protos(queries, logits, *a):
        seen["cls"].append(jnp.argmax(jax.nn.sigmoid(logits), -1))
        return protos(queries, logits, *a)

    def spy_relu(x):  # the backbone's first, in the order they run
        seen["relu"].append(x > 0)
        return relu(x)

    def spy_floor(x):  # each MSDA call's x0, then its y0
        seen["floor"].append(floor(x))
        return seen["floor"][-1]

    def loss_fn(p):  # datr_tpu/train/steps.py:54-76
        out = jm.apply(p, batch["images"], batch["pad_mask"],
                       targets=targets, dn_rng=dn_rng, train=True,
                       global_proto=gp, amount=am)
        losses = jcrit.criterion(out, batch["labels"], batch["boxes"],
                                 batch["valid"], ccfg)
        return jcrit.weighted_total(losses, wd), (losses, out, dict(seen))

    jnp_floor = types.SimpleNamespace(**{**vars(jnp), "floor": spy_floor})
    with contextlib.ExitStack() as stack:
        for patch in [mock.patch.object(jax.lax, "top_k", spy_topk),
                      mock.patch.object(jdino_mod, "class_prototypes",
                                        spy_protos),
                      mock.patch.object(fnn, "relu", spy_relu),
                      mock.patch.object(jmsda, "jnp", jnp_floor),
                      *port_differences()]:
            stack.enter_context(patch)
        (total, (losses, out, held)), grads = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True),
            compiler_options=COMPILE)(params))
    held["topk"], held["cls"] = held["topk"][:2], held["cls"][:2]
    # the assignments datr_tpu's criterion made: its matcher on the same
    # f32-upcast predictions, in the port's order (final, aux, interm)
    preds = ([(out["pred_logits"], out["pred_boxes"])]
             + [(out["aux_logits"][i], out["aux_boxes"][i])
                for i in range(KW["dec_layers"] - 1)]
             + [(out["interm_logits"], out["interm_boxes"])])
    match = jax.jit(jax.vmap(lambda *a: jmatcher.minsum_match(
        jmatcher.detr_matching_cost(*a))))
    held["assign"] = [np.asarray(match(
        jnp.asarray(lg, jnp.float32), jnp.asarray(bx, jnp.float32),
        batch["labels"], batch["boxes"], batch["valid"])) for lg, bx in preds]

    groups, _ = tcdn.cdn_layout(KW["dn_number"], KW["dn_single_pad"])
    draws = _jax_cdn_draws(dn_rng, 2, groups, KW["dn_single_pad"], K)
    tbatch = {k: t(v) for k, v in _tiny_batch().items()}
    tccfg = tcrit.CriterionCfg(num_classes=K, dn_single_pad=2, dn_groups=2,
                               matcher_type=MATCHER)
    twd = tcrit.build_weight_dict(dec_layers=2)

    def port_state(dtype=BF16):
        tm = tdino.DINO(**KW, dn_labelbook_size=K, dtype=dtype)
        assert load_flax_params(tm, params) == []
        return create_train_state(tm, Optimizer(tm, lr=1e-4,
                                                lr_backbone=1e-5))

    def port_run(dtype):
        """The port's forward, losses and backward, each choice replaced by
        datr_tpu's and the positions where its own differs counted."""
        flips = dict.fromkeys(("topk", "assign", "proto_cls", "relu",
                               "cell"), 0)
        it = {k: iter(v) for k, v in held.items()}
        p_topk, p_match = tdino._stable_topk_indices, tcrit.minsum_match
        p_protos = tdino.class_prototypes

        def replay_topk(x, k):
            h = t(next(it["topk"])).long()
            flips["topk"] += int((p_topk(x, k) != h).sum())
            return h

        def replay_match(cost):
            h = t(next(it["assign"])).long()
            flips["assign"] += int(((p_match(cost) != h)
                                    & tbatch["valid"]).sum())
            return h

        def replay_protos(queries, logits, *a):
            h = t(next(it["cls"])).long()
            flips["proto_cls"] += int(
                (torch.sigmoid(logits).argmax(-1) != h).sum())
            return p_protos(queries, torch.nn.functional.one_hot(
                h, logits.shape[-1]).to(logits.dtype), *a)

        def backbone_relu(x):  # run, not replayed: NHWC there, NCHW here
            assert t(next(it["relu"])).shape == x.permute(0, 2, 3, 1).shape
            return torch.nn.functional.relu(x)

        def replay_relu(x):
            h = t(next(it["relu"]))
            assert h.shape == x.shape
            flips["relu"] += int(((x > 0) != h).sum())
            return torch.where(h, x, torch.zeros_like(x))

        cells = {}  # each replayed floor by its input

        def replay_floor(x):
            key = x.detach().numpy().tobytes()
            h = next(it["floor"], None)
            if h is None:  # the plain backward takes the forward's cells
                return cells[key]
            h = t(h).to(x.dtype)
            flips["cell"] += int((torch.floor(x) != h).sum())
            cells[key] = h
            return h

        def with_(module, **kw):
            return types.SimpleNamespace(**{**vars(module), **kw})

        state = port_state(dtype)
        with mock.patch.object(tdino, "_stable_topk_indices", replay_topk), \
                mock.patch.object(tcrit, "minsum_match", replay_match), \
                mock.patch.object(tdino, "class_prototypes", replay_protos), \
                mock.patch.object(tresnet, "F", with_(
                    torch.nn.functional, relu=backbone_relu)), \
                mock.patch.object(tlayers, "F", with_(
                    torch.nn.functional, relu=replay_relu)), \
                mock.patch.object(ttransformer, "F", with_(
                    torch.nn.functional, relu=replay_relu)), \
                mock.patch.object(tmsda, "torch", with_(
                    torch, floor=replay_floor)):
            total, losses, out = loss_and_grads(state, tbatch, tccfg, twd,
                                                dn_draws=draws)
        assert all(next(i, None) is None for i in it.values())
        print(f"{dtype} step: positions where the port's own choice "
              f"differs from datr_tpu's: {flips}")
        grads = {n: p.grad.clone() for n, p in
                 state.model.named_parameters() if p.grad is not None}
        return dict(total=total, losses=losses, out=out, grads=grads)

    return dict(jax=dict(total=total, losses=losses, out=out, grads=grads),
                port=port_run(BF16), port_f32=port_run(torch.float32),
                port_state=port_state, batch=tbatch, draws=draws,
                ccfg=tccfg, wd=twd)


def test_train_step_losses_bf16(step):
    """Every weighted loss term and the total within 2e-2 relative (the
    logging-only counts, class and cardinality errors, read bf16 argmaxes
    and are left out); the train outputs in datr_tpu's dtypes."""
    want, got = step["jax"]["losses"], step["port"]["losses"]
    assert set(got) == set(want)
    for k in step["wd"]:
        w, g = float(want[k]), got[k].item()
        assert abs(g - w) <= 2e-2 * abs(w), (k, g, w)
    w, g = float(step["jax"]["total"]), step["port"]["total"].item()
    assert abs(g - w) <= 2e-2 * abs(w), (g, w)
    for key, v in step["jax"]["out"].items():
        assert str(step["port"]["out"][key].dtype).split(".")[-1] == \
            str(np.asarray(v).dtype), key


# each tensor's gradient error relative to its norm, against datr_tpu's
EACH, CONV_BIAS = 5e-2, 0.1  # every tensor; the convolutions' biases
MEDIAN, BACKBONE = 2e-2, 5e-2  # the median tensor; the backbone's median


def _is_conv_bias(name):
    return name.endswith(".bias") and ("_conv." in name or "d_img." in name)


def test_train_step_gradients_bf16(step):
    """Every gradient arrives in f32 (the parameters' dtype) and is held to
    datr_tpu's bf16 gradient: each tensor within 5e-2 of its norm (the
    convolutions' biases 0.1, see the module docstring), the median tensor
    within 2e-2 and the backbone's median within 5e-2. This seed: median
    0.0064, backbone 0.026, largest 0.035 (proto_d.layer2.weight; the
    sampling offsets 0.032), the convolutions' biases 0.053
    (input_proj0_conv.bias). The port's f32 gradient, the control, fails
    the median and the backbone bounds (this seed: 0.044 and 0.088)."""
    want = state_dict_from_flax(step["jax"]["grads"])
    got, f32 = step["port"]["grads"], step["port_f32"]["grads"]
    # datr_tpu's tree also holds the frozen stem, layer1 and BN statistics
    assert set(got) == set(f32) and set(got) < set(want)
    assert all(g.dtype == torch.float32 for g in got.values())
    bb = [n for n in got if n.startswith("backbone.")]
    assert len(bb) > 10

    def readings(grads):
        err = {n: _rel(g, want[n]) for n, g in grads.items()}
        return (err, float(np.median(list(err.values()))),
                float(np.median([err[n] for n in bb])))

    err, median, backbone = readings(got)
    f32_err, f32_median, f32_backbone = readings(f32)
    largest = {}
    for n, e in err.items():
        kind = "conv bias" if _is_conv_bias(n) else "rest"
        largest[kind] = max(largest.get(kind, (0, "")), (e, n))
    print(f"bf16 step gradients against datr_tpu's: the port's bf16 median "
          f"{median:.3g}, backbone {backbone:.3g}, largest {largest}; the "
          f"f32 control median {f32_median:.3g}, backbone "
          f"{f32_backbone:.3g}")
    bad = {n: e for n, e in err.items()
           if e > (CONV_BIAS if _is_conv_bias(n) else EACH)}
    assert not bad, bad
    assert median <= MEDIAN and backbone <= BACKBONE, (median, backbone)
    assert f32_median > MEDIAN and f32_backbone > BACKBONE, \
        (f32_median, f32_backbone)


def test_train_step_keeps_the_state_f32(step):
    """train_step_burnin of the bf16 model with a per-step EMA: finite
    metrics; the parameters, AdamW's moments, the EMA tracks and the
    prototype state all f32 afterwards."""
    state = step["port_state"]()
    metrics = train_step_burnin(state, step["batch"], step["ccfg"],
                                step["wd"], ema_decay=0.5,
                                dn_draws=step["draws"])
    assert all(torch.isfinite(v).all() for v in metrics.values())
    f32 = {torch.float32}
    assert {p.dtype for p in state.model.parameters()} == f32
    for name in EMA_TRACKS:
        assert {p.dtype for p in getattr(state, name).parameters()} == f32
    moments = [v for ps in state.optimizer.opt.state.values()
               for k, v in ps.items() if k.startswith("exp_avg")]
    assert moments and {v.dtype for v in moments} == f32
    assert state.global_proto.dtype == state.amount.dtype == torch.float32
    assert state.amount.sum().item() > 0
