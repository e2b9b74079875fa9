"""The port's model registry and shared two-stage heads against datr_tpu
on the CPU.

- The (CriterionCfg, weight_dict) of every shipped config, and of C2F with
  self_training_loss_coef 0.25, equal to what `datr_tpu.models.build_model`
  gives (which builds no parameters); the port's side is
  `criterion_from_config` over datr_tpu's unbound module, so no Swin-L /
  ConvNeXt-XL weights are built. The registry's "dino" entry at a tiny
  width; KeyError on an unknown `modelname`.
- `two_stage_bbox_embed_share=True`: the encoder's proposal heads are the
  decoder's (datr_tpu/models/dino.py:194-196). A converted tree's eval
  forward (logits atol 2e-3, boxes 1e-4, tests/test_torch_parity.py's), one
  train_step_plain against the loss and gradients of datr_tpu's
  train_step_plain body (losses rtol 1e-4 / atol 1e-5 as
  test_torch_port_train.py's step; every gradient within 1e-3 of
  datr_tpu's by norm, as test_torch_port_masks.py's), the shared head's
  gradient the sum of its two uses', one state-dict key per tensor and no
  enc_out_* entry (datr_tpu's tree has none), the EMA tracks and the
  optimizer's groups over one copy, a checkpoint round trip bitwise.

datr_tpu runs in f32 on JAX-CPU at hidden 64, 1 encoder and 2 decoder
layers, a ResNet of one bottleneck block per stage (RESNET_STAGES patched
on both sides) at 64x96, its parameters seeded numpy draws over
`jax.eval_shape`'s tree, each reference jitted once at XLA's lowest
backend optimization level."""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch import models as tmodels
from datr_torch.config import apply_overrides, load_config
from datr_torch.convert import load_flax_params, state_dict_from_flax
from datr_torch.models import cdn as tcdn
from datr_torch.models import dino as tdino
from datr_torch.train import checkpoint as tckpt
from datr_torch.train import criterion as tcrit
from datr_torch.train.optim import Optimizer, param_group
from datr_torch.train.state import EMA_TRACKS, create_train_state
from datr_torch.train.steps import plain_loss_and_grads, train_step_plain
from datr_tpu import config as jconfig
from datr_tpu import models as jmodels
from datr_tpu.models import dino as jdino
from datr_tpu.train import criterion as jcrit

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_bf16 import seeded_params  # noqa: E402
from test_torch_port_train import _jax_cdn_draws  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "configs").rglob("*.py"))
C2F = "configs/DA/Cityscapes2FoggyCityscapes/DINO_4scale_C2F.py"
CANVAS = (64, 96)
K, C = 4, 64  # GroupNorm(32) of 2 channels per group: a conv bias before
# it has a gradient (with one channel per group it is rounding noise)
KW = dict(num_classes=K, num_queries=12, hidden_dim=C, nheads=2,
          enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=2,
          dn_single_pad=2, dn_labelbook_size=K)
STAGES = (1, 1, 1, 1)  # one bottleneck block per ResNet stage, both sides
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
LOGIT_ATOL, BOX_ATOL = 2e-3, 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", autouse=True)
def small_backbone():
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    yield
    mp.undo()


# ---------------- the weight dict and the registry ----------------


def test_every_shipped_config_is_a_case():
    assert len(CONFIGS) == 11 and C2F in CONFIGS


@pytest.mark.parametrize("path,overrides", [
    *[(p, []) for p in CONFIGS],
    (C2F, ["self_training_loss_coef=0.25"]),
])
def test_criterion_and_weight_dict_equal_datr_tpu(path, overrides):
    cfg = apply_overrides(load_config(path), overrides)
    jcfg = jconfig.apply_overrides(jconfig.load_config(path), overrides)
    assert dict(cfg) == dict(jcfg)
    jm, jccfg, jwd = jmodels.build_model(jcfg)
    ccfg, wd = tcrit.criterion_from_config(cfg, jm)
    assert ccfg._asdict() == jccfg._asdict()
    assert wd == jwd
    assert wd["loss_self_training"] == jcfg.get("self_training_loss_coef",
                                                1.0)


def test_registry_builds_dino_and_refuses_unknown_names():
    cfg = apply_overrides(load_config("configs/DINO/DINO_4scale.py"),
                          [f"{k}={v}" for k, v in KW.items()]
                          + ["backbone=resnet50", "use_remat=False"])
    assert cfg["modelname"] == "dino"
    assert set(tmodels.MODEL_REGISTRY) == set(jmodels.MODEL_REGISTRY)
    model, ccfg, wd = tmodels.build_model(cfg, device="cpu", seed=3)
    assert isinstance(model, tdino.DINO) and not model.training
    want = tcrit.criterion_from_config(cfg, model)
    assert (ccfg, wd) == want
    for a, b in zip(model.state_dict().values(),
                    tdino.build_dino_from_config(cfg, "cpu", seed=3)
                    .state_dict().values()):
        # the entry's model is build_dino_from_config's
        assert torch.equal(a, b)
    with pytest.raises(KeyError, match="'dino'"):
        tmodels.build_model(dict(cfg, modelname="deformable_detr"),
                            device="cpu")
    with pytest.raises(KeyError, match="already registered"):
        tmodels.register_model("dino")(lambda cfg: None)


# ---------------- shared two-stage heads ----------------


@pytest.fixture(scope="module")
def shared():
    """datr_tpu's tiny DINO with shared heads (train-mode tree: the DA
    heads and the CDN label embedding too), seeded."""
    jm = jdino.DINO(**KW, two_stage_share_heads=True, use_remat=False)
    img, pm = _images(np.random.default_rng(0))
    tgt = {"boxes": jnp.full((2, 3, 4), 0.3), "labels": jnp.zeros(
        (2, 3), jnp.int32), "valid": jnp.ones((2, 3), bool)}
    shapes = jax.eval_shape(lambda k: jm.init(
        k, img, pm, targets=tgt, dn_rng=jax.random.PRNGKey(1), train=True,
        global_proto=jnp.zeros((K, C)), amount=jnp.zeros((K,)),
        domain_adapt=False), jax.random.PRNGKey(0))
    return jm, {"params": seeded_params(shapes["params"], seed=4)}


def _images(rng, b=2):
    img = rng.standard_normal((b, *CANVAS, 3)).astype(np.float32)
    pm = np.zeros((b, *CANVAS), bool)
    pm[0, 52:] = True
    pm[1, :, 70:] = True
    img[pm] = 0.0
    return img, pm


def _port(params):
    """The port's shared-head model from the tree; only the DA heads,
    which a single-domain init does not create, keep the port's init."""
    tm = tdino.DINO(**KW, two_stage_share_heads=True)
    left = load_flax_params(tm, params)
    assert {n.split(".")[0] for n in left} == {"d_img", "proto_d"}
    return tm


def test_shared_heads_have_one_key_per_tensor(shared):
    """The state dict holds datr_tpu's tree's entries (no enc_out_*), the
    encoder's heads are the decoder's modules, and build_dino_from_config reads
    two_stage_bbox_embed_share."""
    _, params = shared
    tm = _port(params)
    sd = tm.state_dict()
    assert not any(k.startswith("enc_out_") for k in sd)
    assert set(state_dict_from_flax(params)) == set(sd) - {
        k for k in sd if k.startswith(("d_img.", "proto_d."))}
    assert tm.enc_out_class_head is tm.class_head
    assert tm.enc_out_bbox_head is tm.bbox_head
    names = [n for n, _ in tm.named_parameters()]
    assert len(names) == len(set(names)) == len(list(tm.parameters()))
    unshared = tdino.DINO(**KW)
    extra = {k for k in unshared.state_dict() if k.startswith("enc_out_")}
    assert extra and set(unshared.state_dict()) - extra == set(sd)
    built = tdino.build_dino_from_config(
        dict(KW, two_stage_bbox_embed_share=True), device="cpu")
    assert built.two_stage_share_heads
    assert built.enc_out_class_head is built.class_head


def test_shared_heads_eval_forward_matches_datr_tpu(shared):
    jm, params = shared
    img, pm = _images(np.random.default_rng(5))
    want = jax.device_get(jax.jit(lambda p: jm.apply(p, img, pm),
                                  compiler_options=FAST)(params))
    tm = _port(params).eval()
    with torch.no_grad():
        got = tm(t(img), t(pm))
    assert "interm_logits" in want
    for key, w in want.items():
        atol = LOGIT_ATOL if "logits" in key else BOX_ATOL
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=atol,
                                   err_msg=key)


def _batch():
    """2 supervised images at 64x96 with 3 targets each (one padding)."""
    rng = np.random.default_rng(11)
    img, pm = _images(rng)
    c = rng.random((2, 3, 2)) * 0.5 + 0.25
    boxes = np.concatenate([c, rng.random((2, 3, 2)) * 0.3 + 0.1],
                           -1).astype(np.float32)
    valid = np.ones((2, 3), bool)
    valid[1, 2] = False
    return dict(images=img, pad_mask=pm, boxes=boxes,
                labels=rng.integers(0, K, (2, 3)).astype(np.int32),
                valid=valid)


def test_shared_heads_train_step_plain_matches_datr_tpu(shared, tmp_path):
    """One train_step_plain against datr_tpu's train_step_plain body
    (datr_tpu/train/steps.py:103-125: the single-domain forward, the
    criterion, value_and_grad) with the same CDN draws. Then the shared
    head's gradient is the sum of the two uses' in an unshared model of
    the same weights; the EMA tracks and the optimizer's groups hold one
    copy; the state after the step comes back from a checkpoint
    bitwise."""
    jm, params = shared
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    groups, _ = tcdn.cdn_layout(KW["dn_number"], KW["dn_single_pad"])
    jccfg = jcrit.CriterionCfg(num_classes=K, dn_single_pad=2,
                               dn_groups=groups)
    jwd = jcrit.build_weight_dict(dec_layers=2)
    dn_rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        out = jm.apply(p, jb["images"], jb["pad_mask"],
                       targets={k: jb[k] for k in ("boxes", "labels",
                                                   "valid")},
                       dn_rng=dn_rng, train=True, domain_adapt=False)
        losses = jcrit.criterion(out, jb["labels"], jb["boxes"],
                                 jb["valid"], jccfg)
        return jcrit.weighted_total(losses, jwd), losses

    (total, want), grads = jax.device_get(jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True),
        compiler_options=FAST)(params))
    assert not any(k.startswith("enc_out_") for k in grads["params"])

    tb = {k: t(v) for k, v in batch.items()}
    ccfg = tcrit.CriterionCfg(num_classes=K, dn_single_pad=2,
                              dn_groups=groups)
    wd = tcrit.build_weight_dict(dec_layers=2)
    draws = _jax_cdn_draws(dn_rng, 2, groups, 2, K)
    tm = _port(params)
    state = create_train_state(tm, Optimizer(tm, lr=1e-4, lr_backbone=1e-5))
    p_total, got, _ = plain_loss_and_grads(state, tb, ccfg, wd, draws)
    assert set(got) == set(want) and "loss_ce_interm" in got
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(p_total.item(), total, rtol=1e-4)
    ref = state_dict_from_flax(grads)
    shared_grads = {}
    for n, p in state.model.named_parameters():
        if p.grad is None:
            continue
        err = (p.grad - ref[n]).norm().item()
        assert err <= 1e-3 * ref[n].norm().item() + 1e-6, (n, err)
        if n.startswith(("class_head.", "bbox_head.")):
            shared_grads[n] = p.grad.clone()
    assert len(shared_grads) == 2 + 6

    # the unshared model of the same weights: decoder heads + enc_out heads
    un = tdino.DINO(**KW)
    sd = dict(tm.state_dict())
    sd.update({f"enc_out_{k}": v for k, v in sd.items()
               if k.startswith(("class_head.", "bbox_head."))})
    un.load_state_dict(sd)
    ustate = create_train_state(un, Optimizer(un, lr=1e-4, lr_backbone=1e-5))
    plain_loss_and_grads(ustate, tb, ccfg, wd, draws)
    ug = {n: p.grad for n, p in un.named_parameters() if p.grad is not None}
    for n, g in shared_grads.items():
        both = ug[n] + ug[f"enc_out_{n}"]
        torch.testing.assert_close(g, both, rtol=1e-5, atol=1e-7, msg=n)
        assert ug[f"enc_out_{n}"].norm() > 0 and ug[n].norm() > 0, n

    n_params = len(list(tm.parameters()))
    for name in EMA_TRACKS:
        track = getattr(state, name)
        assert track.enc_out_class_head is track.class_head
        assert len(list(track.parameters())) == n_params
    opt_params = [p for g in state.optimizer.opt.param_groups
                  for p in g["params"]]
    assert len(opt_params) == len({id(p) for p in opt_params})
    assert sum(p is tm.class_head.weight for p in opt_params) == 1
    assert param_group("class_head.weight") == "main"

    metrics = train_step_plain(state, tb, ccfg, wd, dn_draws=draws)
    for k in want:
        np.testing.assert_allclose(metrics[k].item(), want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert state.step == 1
    tckpt.save_checkpoint(str(tmp_path / "ckpt"), state, 0)
    fresh = _port(params)
    back = create_train_state(fresh, Optimizer(fresh, lr=1e-4,
                                               lr_backbone=1e-5))
    back, _ = tckpt.load_checkpoint(str(tmp_path / "ckpt"), back)
    for name in ("model", *EMA_TRACKS):
        a, b = getattr(state, name).state_dict(), getattr(
            back, name).state_dict()
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a), name
