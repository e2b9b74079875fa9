"""The port's Swin Transformer and ConvNeXt backbones against datr_tpu's on
the CPU: each stage's output in f32 (a tiny Swin at windows 4 and 12, a
tiny ConvNeXt; an even canvas and one whose stages have odd sizes), each
block in bf16 rounding by rounding, the whole DINO_4scale_swin /
DINO_4scale_convnext eval forward at a tiny width, the converted parameter
tree, one train_step_plain with the tiny Swin backbone, and the parameter
groups.

datr_tpu's parameters are seeded numpy draws of the shapes
`jax.eval_shape` gives (no init is compiled), with `gamma` and
`relative_position_bias_table` drawn here at scales of their own (their
inits, 1e-6 and 0.02, would hide the blocks' residual branch and the bias).
The whole-model tests register a tiny entry in both packages'
SWIN_CONFIGS / CONVNEXT_CONFIGS (monkeypatch.setitem: no datr_tpu file
changes) and point `backbone` at it. Each datr_tpu reference is jitted
once, at XLA's lowest backend optimization (it changes no f32 result and
halves the compile)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from flax.traverse_util import flatten_dict, unflatten_dict

from datr_torch.config import apply_overrides, load_config
from datr_torch.convert import (
    DA_HEADS,
    load_flax_params,
    state_dict_from_flax,
)
from datr_torch.models import convnext as tconvnext
from datr_torch.models import swin as tswin
from datr_torch.models.dino import build_dino_from_config, make_backbone
from datr_torch.train.optim import param_group
from datr_tpu import config as jconfig
from datr_tpu.models import convnext as jconvnext
from datr_tpu.models import swin as jswin
from datr_tpu.models.dino import build_dino_from_config as jax_build
from datr_tpu.train.optim import param_labels

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_bf16 import COMPILE, seeded_params, to_np  # noqa: E402
from test_torch_port_configs import TINY  # noqa: E402

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
TINY_SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
TINY_CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
# 64x96: stages 16x24 ... 2x3; 72x104: 18x26 -> 9x13 -> 5x7 -> 3x4, odd
# sizes through "SAME" padding and PatchMerging's pad
CANVASES = ((64, 96), (72, 104))
ALL_STAGES = (0, 1, 2, 3)


def backbone_params(shapes, seed=0):
    """`seeded_params`, with gamma ~ 0.3 N(0, 1) and the relative position
    bias ~ 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed + 100)
    flat = flatten_dict(seeded_params(shapes, seed))
    for path, v in flat.items():
        if path[-1] == "gamma":
            flat[path] = (0.3 * rng.standard_normal(v.shape)).astype(
                np.float32)
        elif path[-1] == "relative_position_bias_table":
            flat[path] = (0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return unflatten_dict(flat)


def modules(kind, ws=7):
    """(datr_tpu's backbone, the port's) of the tiny configuration, f32,
    every stage returned."""
    if kind == "swin":
        kw = dict(TINY_SWIN, window_size=ws, return_stages=ALL_STAGES)
        return jswin.SwinTransformer(**kw), tswin.SwinTransformer(**kw)
    kw = dict(TINY_CONVNEXT, return_stages=ALL_STAGES)
    return jconvnext.ConvNeXt(**kw), tconvnext.ConvNeXt(**kw)


# ---------------- each stage, f32 ----------------


@pytest.mark.parametrize("canvas", CANVASES)
@pytest.mark.parametrize("kind,ws", [("swin", 4), ("swin", 12),
                                     ("convnext", 0)])
def test_backbone_stages_match_datr_tpu(kind, ws, canvas):
    """Every stage's output (0-3, stride 4-32) in f32 within atol 1e-5 of
    datr_tpu's, on a batch of 2. At window 12 each stage of these canvases
    is smaller than the window, so every block pads; the 72x104 canvas
    gives odd stage sizes (the convolutions' "SAME" padding, PatchMerging's
    odd pad)."""
    jm, tm = modules(kind, ws)
    x = np.random.default_rng(1).standard_normal((2, *canvas, 3)).astype(
        np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    params = {"params": backbone_params(shapes["params"])}
    want = jax.device_get(jax.jit(jm.apply, compiler_options=FAST_COMPILE)(
        params, x))
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for s, (g, w) in enumerate(zip(got, want)):
        w = np.transpose(w, (0, 3, 1, 2))  # NHWC -> the port's NCHW
        assert g.shape == w.shape, (s, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5,
                                   err_msg=f"stage {s}")


def test_depthwise_kernel_converts_to_oihw():
    """The depthwise kernel HWIO [7, 7, 1, C] becomes OIHW [C, 1, 7, 7]
    through the generic conv transpose: element (i, j, 0, c) lands at
    (c, 0, i, j). PatchMerging's reduction has no bias."""
    k = np.arange(7 * 7 * 1 * 16, dtype=np.float32).reshape(7, 7, 1, 16)
    sd = state_dict_from_flax({"blk": {"dwconv": {"kernel": k}}})
    w = sd["blk.dwconv.weight"].numpy()
    assert w.shape == (16, 1, 7, 7)
    assert w[5, 0, 2, 3] == k[2, 3, 0, 5]
    merge = tswin.PatchMerging(8)
    assert merge.reduction.bias is None
    assert set(merge.state_dict()) == {"norm.weight", "norm.bias",
                                       "reduction.weight"}


# ---------------- each block, bf16 ----------------


def _bf16_block(kind, shift):
    """(datr_tpu's block, the port's class and kwargs, input shape)."""
    if kind == "swin":
        kw = dict(dim=32, num_heads=2, window_size=4, shift=shift)
        return (jswin.SwinBlock(**kw, dtype=jnp.bfloat16),
                tswin.SwinBlock, kw, (2, 10, 12, 32))
    return (jconvnext.ConvNeXtBlock(32, dtype=jnp.bfloat16),
            tconvnext.ConvNeXtBlock, dict(dim=32), (2, 9, 13, 32))


@pytest.mark.parametrize("kind,shift", [("swin", 0), ("swin", 2),
                                        ("convnext", 0)])
def test_block_rounds_as_datr_tpu(kind, shift):
    """One block in bf16 (a Swin block unshifted and shifted, window 4 on a
    10x12 map: the pad and the mask; a ConvNeXt block on 9x13) against
    datr_tpu's, compiled to round every op (tests/test_torch_port_bf16.py's
    COMPILE): the outputs agree bit for bit but where an f32 sum's order
    (the GEMMs, the convolution, the softmax) or the tanh differ by an f32
    rounding that straddles a bf16 one. The control, the port's block in
    f32 with its output rounded to bf16 once, agrees far less often.
    Measured: equal at 1.000 (Swin unshifted and shifted, ConvNeXt), the
    control at 0.354 / 0.340 (Swin) and 0.0001 (ConvNeXt, whose output is
    f32: gamma is an f32 parameter, so the residual add promotes and the
    control's output is never rounded to bf16); limits 0.99 and 0.5."""
    jm, tcls, kw, shape = _bf16_block(kind, shift)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    params = {"params": backbone_params(shapes["params"], 5)}
    want = jax.device_get(jax.jit(jm.apply, compiler_options=COMPILE)(
        params, x))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32)))

    def port(dtype):
        m = tcls(**kw, dtype=dtype)
        m.load_state_dict(state_dict_from_flax(params), strict=True)
        with torch.no_grad():
            return m(xt.to(torch.bfloat16))

    got, control = port(torch.bfloat16), port(torch.float32)
    want_dtype = jnp.float32 if kind == "convnext" else jnp.bfloat16
    assert want.dtype == want_dtype
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    w = to_np(want)
    equal = float((to_np(got) == w).mean())
    c_equal = float((to_np(control.to(got.dtype)) == w).mean())
    print(f"{kind} block (shift {shift}) in bf16: equal at {equal:.4f}, "
          f"f32 control {c_equal:.4f}; largest difference "
          f"{np.abs(to_np(got) - w).max():.3g}")
    assert equal >= 0.99 and c_equal < 0.5


# ---------------- the whole model ----------------

TINY_ENTRIES = {"swin": ("swin_tiny_test", dict(TINY_SWIN, window_size=12)),
                "convnext": ("convnext_tiny_test", TINY_CONVNEXT)}
CONFIGS = {"swin": "configs/DINO/DINO_4scale_swin.py",
           "convnext": "configs/DINO/DINO_4scale_convnext.py"}


def register_tiny(monkeypatch, kind):
    """The tiny backbone entry in both packages' tables; its name."""
    name, entry = TINY_ENTRIES[kind]
    tables = ((jswin.SWIN_CONFIGS, tswin.SWIN_CONFIGS) if kind == "swin"
              else (jconvnext.CONVNEXT_CONFIGS, tconvnext.CONVNEXT_CONFIGS))
    for table in tables:
        monkeypatch.setitem(table, name, entry)
    return name


def train_tree_shapes(jm, canvas=(64, 96)):
    """datr_tpu's whole parameter tree (a train-mode init: DN and DA
    heads), by jax.eval_shape."""
    K, C = jm.num_classes, jm.hidden_dim
    return jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((2, *canvas, 3)), jnp.zeros((2, *canvas), bool),
        targets=dict(boxes=jnp.full((1, 1, 4), 0.5),
                     labels=jnp.zeros((1, 1), jnp.int32),
                     valid=jnp.ones((1, 1), bool)),
        dn_rng=jax.random.PRNGKey(1), train=True,
        global_proto=jnp.zeros((K, C)), amount=jnp.zeros((K,))),
        jax.random.PRNGKey(0))["params"]


@pytest.fixture(scope="module", params=["swin", "convnext"])
def tiny(request):
    """Both packages' models of CONFIGS[kind] at the TINY width of
    tests/test_torch_port_configs.py with the tiny backbone, from the
    config files through their own build functions, and datr_tpu's whole
    parameter tree's shapes. The tiny entries stay registered while the
    module's tests of this kind run."""
    kind = request.param
    mp = pytest.MonkeyPatch()
    name = register_tiny(mp, kind)
    opts = TINY + [f"backbone={name}"]
    cfg = apply_overrides(load_config(CONFIGS[kind]), opts)
    jcfg = jconfig.apply_overrides(jconfig.load_config(CONFIGS[kind]), opts)
    assert dict(cfg) == dict(jcfg) and cfg.backbone.startswith(kind)
    jm = jax_build(jcfg)
    yield dict(kind=kind, jm=jm, tm=build_dino_from_config(cfg, "cpu"),
               cfg=cfg, shapes=train_tree_shapes(jm))
    mp.undo()


def test_config_eval_forward_matches_datr_tpu(tiny, monkeypatch):
    """DINO_4scale_swin.py and DINO_4scale_convnext.py at the TINY width
    with the tiny backbone: the converted tree's keys and shapes are the
    port's state_dict exactly (the train-only heads included), and the
    eval forward on a padded batch matches: the two-stage top-k equal,
    logits within atol 2e-3, boxes within 1e-4 (the tolerances of
    tests/test_torch_port_configs.py)."""
    from test_torch_port_configs import BOX_ATOL, LOGIT_ATOL

    jm, tm = tiny["jm"], tiny["tm"]
    params = {"params": backbone_params(tiny["shapes"])}
    want_sd = state_dict_from_flax(params)
    got_sd = tm.state_dict()
    assert set(want_sd) == set(got_sd)
    assert all(tuple(want_sd[k].shape) == tuple(got_sd[k].shape)
               for k in got_sd)
    assert load_flax_params(tm, params) == []

    canvas = (64, 96)
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

    monkeypatch.setattr(jax.lax, "top_k", spy)
    want, want_idx = jax.device_get(jax.jit(
        lambda p, a, b: (jm.apply(p, a, b, train=False), seen["idx"]),
        compiler_options=FAST_COMPILE)(params, img, pm))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(img), torch.from_numpy(pm))
    np.testing.assert_array_equal(got["topk_idx"].numpy(), want_idx)
    for key, w in want.items():
        atol = LOGIT_ATOL if "logits" in key else BOX_ATOL
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=atol,
                                   err_msg=key)


def test_param_groups_match_param_labels(tiny):
    """Every entry of the port's state_dict gets datr_tpu's
    `_label_for_path` label of the matching flax path: the whole backbone
    `backbone` (lr_backbone), no frozen stage, everything else `main`."""
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        tiny["shapes"])
    code = {"main": 0, "backbone": 1, "frozen": 2}
    labels = flatten_dict(param_labels(tree))
    want = state_dict_from_flax(unflatten_dict({
        k: np.full(v.shape, code[labels[k]], np.float32)
        for k, v in flatten_dict(tree).items()}))
    assert set(want) == set(tiny["tm"].state_dict())
    for n, v in want.items():
        assert (v == code[param_group(n)]).all(), n
    assert {param_group(n) for n in want if n.startswith("backbone.")} == {
        "backbone"}


def test_unknown_backbone_names_the_supported_ones():
    with pytest.raises(ValueError, match="swin_L_384_22k.*convnext_xlarge"):
        make_backbone("vgg16")


@pytest.mark.parametrize("tiny", ["swin"], indirect=True)
def test_train_step_plain_with_swin_matches_datr_tpu(tiny):
    """One single-domain step of the tiny model (DINO_4scale_swin.py at
    the TINY width) from the same weights and CDN draws as datr_tpu's
    train_step_plain (its optimizer behind a transformation that keeps the
    step's gradients), with the tolerances of
    tests/test_torch_port_train.py: every loss rtol 1e-4 / atol 1e-5, every
    parameter within 2 lr of datr_tpu's after the AdamW step, the
    prototype state untouched; every trainable gradient by relative norm,
    rtol 1e-3, the backbone 1e-2 (test_train_step_gradients' bounds: at
    this width the gradient reaches the backbone through GroupNorms of
    one-channel groups, which magnify f32 rounding), atol 1e-7 of the whole
    gradient's norm; the input projections' conv biases, whose gradient is
    zero in exact arithmetic (each sits in front of a GroupNorm of
    one-channel groups), within 1e-6 of the whole gradient's norm of 0 on
    both sides (measured: at most 1.4e-5 against 9.0e-5). Two bounds
    differ from the ResNet model's, where the Swin model's f32
    conditioning is worse. The test reads it: the port's gradients again
    with its weights perturbed by one f32 ulp (relative 6e-8), printed
    beside the differences from datr_tpu. The last level's projection,
    whose GroupNorm groups span its 1x2 map: 1e-2 (measured: the
    perturbation moves its gradient by 1.4e-3, datr_tpu's and the port's
    differ by 3.5e-3). grad_norm: 1e-3, most of it the backbone's gradient
    (about 90 against the main group's 30; the perturbation moves it by
    4.7e-5 and the backbone's gradients by a median 3.5e-4; datr_tpu's and
    the port's differ by 1.6e-4 and 8.0e-4)."""
    import optax

    from datr_torch.models import cdn as tcdn
    from datr_torch.train import criterion as tcrit
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state
    from datr_torch.train.steps import plain_loss_and_grads, train_step_plain
    from datr_tpu.train import criterion as jcrit
    from datr_tpu.train.optim import make_optimizer
    from datr_tpu.train.state import create_train_state as jax_train_state
    from datr_tpu.train.steps import train_step_plain as jax_train_step_plain
    from test_torch_port_train import LR, LR_BACKBONE, _jax_cdn_draws, \
        _tiny_batch, t

    jm, tm, cfg = tiny["jm"], tiny["tm"], tiny["cfg"]
    K, HD = cfg.num_classes, cfg.hidden_dim
    params = {"params": backbone_params(tiny["shapes"], 2)}
    batch = {k: v[:2] for k, v in _tiny_batch().items()}
    stash = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    tx = optax.chain(stash, make_optimizer(params, lr=LR,
                                           lr_backbone=LR_BACKBONE))
    jstate = jax.jit(lambda p: jax_train_state(
        p, tx, K, HD, jax.random.PRNGKey(5)))(params)
    groups, _ = tcdn.cdn_layout(cfg.dn_number, cfg.dn_single_pad)
    ccfg = dict(num_classes=K, dn_single_pad=cfg.dn_single_pad,
                dn_groups=groups)
    _, dn_rng = jax.random.split(jstate.rng)  # datr_tpu/train/steps.py:31-33
    step = jax.jit(jax_train_step_plain.__wrapped__,
                   static_argnames=("model", "tx", "ccfg", "ema_decay"),
                   compiler_options=FAST_COMPILE)
    new_state, want = jax.device_get(step(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jm, tx,
        jcrit.CriterionCfg(**ccfg),
        jcrit.build_weight_dict(dec_layers=cfg.dec_layers)))
    want_grads = state_dict_from_flax(new_state.opt_state[0])

    draws = _jax_cdn_draws(dn_rng, 2, groups, cfg.dn_single_pad, K)
    tbatch = {k: t(v) for k, v in batch.items()}
    wd = tcrit.build_weight_dict(dec_layers=cfg.dec_layers)
    # the floor: the port's gradients with its weights one ulp away
    load_flax_params(tm, params)
    with torch.no_grad():
        noise = torch.Generator().manual_seed(9)
        for p in tm.parameters():
            p.mul_(1 + 6e-8 * torch.randn(p.shape, generator=noise))
    fstate = create_train_state(tm, Optimizer(tm))
    plain_loss_and_grads(fstate, tbatch, tcrit.CriterionCfg(**ccfg), wd,
                         draws)
    floor = {n: p.grad.clone() for n, p in tm.named_parameters()
             if p.grad is not None}
    del fstate

    load_flax_params(tm, params)
    pstate = create_train_state(tm, Optimizer(tm, lr=LR,
                                              lr_backbone=LR_BACKBONE))
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.clone()))
        for n, p in tm.named_parameters() if p.requires_grad]
    got = train_step_plain(pstate, tbatch, tcrit.CriterionCfg(**ccfg), wd,
                           dn_draws=draws)
    for h in hooks:
        h.remove()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def total(g):
        return torch.stack([v.norm() for v in g.values()]).norm()

    last_proj = f"input_proj{cfg.num_feature_levels - 1}_conv."
    last = last_proj + "weight"
    bb = [n for n in floor if n.startswith("backbone.")]
    print(f"one-ulp floor / against datr_tpu: last projection "
          f"{rel(floor[last], grads[last]):.3g} / "
          f"{rel(grads[last], want_grads[last]):.3g}; backbone median "
          f"{np.median([rel(floor[n], grads[n]) for n in bb]):.3g} / "
          f"{np.median([rel(grads[n], want_grads[n]) for n in bb]):.3g}; "
          f"grad_norm {abs(1 - total(floor) / total(grads)):.3g} / "
          f"{abs(1 - float(got['grad_norm']) / want['grad_norm']):.3g}")
    assert set(got) == set(want)
    for k in want:
        rtol = 1e-3 if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=rtol,
                                   atol=1e-5, err_msg=k)
    # the plain step has no DA branch: its heads take no gradient
    assert set(grads) == {n for n, p in tm.named_parameters()
                          if p.requires_grad
                          and n.split(".")[0] not in DA_HEADS}
    atol = 1e-7 * torch.stack([want_grads[n].norm() for n in grads]).norm()
    for n, g in grads.items():
        if n.startswith("input_proj") and n.endswith("_conv.bias"):
            assert max(g.norm(), want_grads[n].norm()) <= 10 * atol, n
            continue
        rtol = 1e-2 if (param_group(n) == "backbone"
                        or n.startswith(last_proj)) else 1e-3
        err = (g - want_grads[n]).norm().item()
        assert err <= rtol * want_grads[n].norm().item() + atol, (n, err)
    new = state_dict_from_flax(new_state.params)
    for n, p in pstate.model.state_dict().items():
        lr = LR if param_group(n) == "main" else LR_BACKBONE
        assert (p - new[n]).abs().max().item() <= 2 * lr + 1e-6, n
    assert pstate.step == 1 and pstate.amount.sum().item() == 0
