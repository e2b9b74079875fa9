"""Each module of the port against its flax counterpart in datr_tpu on the
CPU, with weights carried across by datr_torch.convert.state_dict_from_flax.
Inputs come from numpy seeds; atol 1e-5 unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
import torch.nn.functional as F
from flax.traverse_util import flatten_dict, unflatten_dict

from datr_torch.config import apply_overrides, load_config
from datr_torch.convert import load_flax_params, state_dict_from_flax
from datr_torch.data import transforms as ttransforms
from datr_torch.models import dino as tdino
from datr_torch.models import layers as tlayers
from datr_torch.models import resnet as tresnet
from datr_torch.models import transformer as ttrans
from datr_torch.models.position_encoding import position_embedding_sine_hw
from datr_torch.utils import boxes as tboxes
from datr_torch.utils import misc as tmisc
from datr_tpu import config as jconfig
from datr_tpu.data import transforms as jtransforms
from datr_tpu.models import dino as jdino
from datr_tpu.models import layers as jlayers
from datr_tpu.models import resnet as jresnet
from datr_tpu.models import transformer as jtrans
from datr_tpu.models.position_encoding import (
    position_embedding_sine_hw as jax_position_embedding,
)
from datr_tpu.utils import boxes as jboxes
from datr_tpu.utils import misc as jmisc

SHAPES = ((6, 8), (3, 4), (2, 2))
S = sum(h * w for h, w in SHAPES)


def perturb(params, seed=0):
    """Give every constant-initialized leaf (zero kernels, unit norms,
    identity frozen BN) seeded noise so no code path sees a trivial value."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(params)
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        if np.all(v == v.flat[0]):
            if k[-1] == "running_var":
                v = v + 0.2 * rng.random(v.shape).astype(np.float32)
            else:
                v = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
        flat[k] = v
    return unflatten_dict(flat)


def load(module, params):
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module.eval()


def t(x):
    return torch.from_numpy(np.array(x))


def pad_mask_flat(rng, b):
    masks = []
    for h, w in SHAPES:
        m = np.zeros((b, h, w), bool)
        m[0, h - 1:, :] = True
        m[-1, :, w - 1:] = True
        masks.append(m.reshape(b, -1))
    return np.concatenate(masks, 1)


# ---------------- helpers ----------------


def test_position_embedding_sine_hw():
    mask = np.zeros((2, 7, 9), bool)
    mask[0, 5:] = True
    mask[1, :, 6:] = True
    want = jax_position_embedding(jnp.asarray(mask), 16, 20.0, 20.0)
    got = position_embedding_sine_hw(t(mask), 16, 20.0, 20.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dims", [2, 4])
def test_sine_embed_for_position(dims):
    pos = np.random.default_rng(dims).random((2, 5, dims)).astype(np.float32)
    np.testing.assert_allclose(
        tmisc.sine_embed_for_position(t(pos), 16).numpy(),
        jmisc.sine_embed_for_position(jnp.asarray(pos), 16),
        rtol=0, atol=1e-5)


def test_inverse_sigmoid():
    x = np.concatenate([np.linspace(-0.2, 1.2, 57),
                        [0.0, 1e-4, 1.0]]).astype(np.float32)
    np.testing.assert_allclose(tmisc.inverse_sigmoid(t(x)).numpy(),
                               jmisc.inverse_sigmoid(jnp.asarray(x)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("fn", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh"])
def test_box_conversions(fn):
    b = np.random.default_rng(5).random((2, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(getattr(tboxes, fn)(t(b)).numpy(),
                               getattr(jboxes, fn)(jnp.asarray(b)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("src_hw,out_hw", [((100, 168), (50, 84)),
                                           ((50, 84), (13, 21)),
                                           ((25, 42), (13, 21)),
                                           ((96, 128), (3, 4))])
def test_pad_mask_downsample_matches_jax_nearest(src_hw, out_hw):
    """The port downsamples the pad mask with nearest-exact, the index rule
    of jax.image.resize(..., 'nearest'); plain 'nearest' differs."""
    rng = np.random.default_rng(sum(src_hw))
    mask = rng.random((2, *src_hw)) < 0.5
    want = np.asarray(jax.image.resize(
        jnp.asarray(mask, jnp.float32), (2, *out_hw), method="nearest"))
    x = t(mask.astype(np.float32))[:, None]
    got = F.interpolate(x, size=out_hw, mode="nearest-exact")[:, 0].numpy()
    np.testing.assert_array_equal(got, want)
    if out_hw[0] < src_hw[0] // 2:  # odd ratios: plain 'nearest' differs
        plain = F.interpolate(x, size=out_hw, mode="nearest")[:, 0].numpy()
        assert not np.array_equal(plain, want)


# ---------------- layers ----------------


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeformattn(ref_dim):
    C, NH, P, LQ = 32, 2, 3, 5
    rng = np.random.default_rng(ref_dim)
    query = rng.standard_normal((2, LQ, C)).astype(np.float32)
    value = rng.standard_normal((2, S, C)).astype(np.float32)
    ref = rng.random((2, LQ, len(SHAPES), ref_dim)).astype(np.float32)
    if ref_dim == 4:
        ref[..., 2:] *= 0.5
    mask = pad_mask_flat(rng, 2)
    jm = jlayers.MSDeformAttn(C, len(SHAPES), NH, P)
    params = perturb(jm.init(jax.random.PRNGKey(0), query, ref, value,
                             SHAPES, mask))
    want = jm.apply(params, query, ref, value, SHAPES, mask)
    tm = load(tlayers.MSDeformAttn(C, len(SHAPES), NH, P), params)
    with torch.no_grad():
        got = tm(t(query), t(ref), t(value), SHAPES, t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_resnet_trunk():
    """Full ResNet-50 depth at a 64x96 image; stage features NCHW in the
    port, NHWC in datr_tpu. atol 1e-4: 53 convolutions of accumulation
    order differences on activations of magnitude ~10."""
    img = np.random.default_rng(0).standard_normal(
        (1, 64, 96, 3)).astype(np.float32)
    jm = jresnet.ResNet()
    params = perturb(jm.init(jax.random.PRNGKey(0), img))
    want = jm.apply(params, img)
    tm = load(tresnet.ResNet(), params)
    with torch.no_grad():
        got = tm(t(img))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=0, atol=1e-4 * max(1, np.abs(w).max()))


def test_encoder_layer():
    C, NH, P = 32, 2, 2
    rng = np.random.default_rng(3)
    src = rng.standard_normal((2, S, C)).astype(np.float32)
    pos = rng.standard_normal((2, S, C)).astype(np.float32)
    mask = pad_mask_flat(rng, 2)
    vr = np.full((2, len(SHAPES), 2), 1.0, np.float32)
    vr[0, :, 1] = 0.8
    ref = np.asarray(jtrans.encoder_reference_points(SHAPES, jnp.asarray(vr)))
    np.testing.assert_allclose(
        ttrans.encoder_reference_points(SHAPES, t(vr)).numpy(), ref,
        rtol=0, atol=1e-6)
    jm = jtrans.DeformableEncoderLayer(C, 64, len(SHAPES), NH, P)
    params = perturb(jm.init(jax.random.PRNGKey(0), src, pos, ref, SHAPES,
                             mask))
    want = jm.apply(params, src, pos, ref, SHAPES, mask)
    tm = load(ttrans.DeformableEncoderLayer(C, 64, len(SHAPES), NH, P),
              params)
    with torch.no_grad():
        got = tm(t(src), t(pos), t(ref), SHAPES, t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_valid_ratios_from_mask():
    masks = [np.zeros((2, h, w), bool) for h, w in SHAPES]
    masks[0][0, 4:] = True
    masks[1][1, :, 1:] = True
    want = jtrans.valid_ratios_from_mask([jnp.asarray(m) for m in masks])
    got = ttrans.valid_ratios_from_mask([t(m) for m in masks])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)


def test_decoder_layer():
    C, NH, P, NQ = 32, 2, 2, 6
    rng = np.random.default_rng(4)
    tgt = rng.standard_normal((2, NQ, C)).astype(np.float32)
    qpos = rng.standard_normal((2, NQ, C)).astype(np.float32)
    memory = rng.standard_normal((2, S, C)).astype(np.float32)
    ref = rng.random((2, NQ, len(SHAPES), 4)).astype(np.float32) * 0.6 + 0.2
    mask = pad_mask_flat(rng, 2)
    jm = jtrans.DeformableDecoderLayer(C, 64, len(SHAPES), NH, P)
    params = perturb(jm.init(jax.random.PRNGKey(0), tgt, qpos, memory, ref,
                             SHAPES, mask))
    want = jm.apply(params, tgt, qpos, memory, ref, SHAPES, mask)
    tm = load(ttrans.DeformableDecoderLayer(C, 64, len(SHAPES), NH, P),
              params)
    with torch.no_grad():
        got = tm(t(tgt), t(qpos), t(memory), t(ref), SHAPES, t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---------------- weights and the flagship tree ----------------


def _abstract_train_params(model, hw):
    """Parameter shapes of a train-mode init (it creates the train-only
    d_img / proto_d too), without computing anything."""
    k = model.num_classes
    images = jnp.zeros((2, *hw, 3))
    pad_mask = jnp.zeros((2, *hw), bool)
    targets = dict(boxes=jnp.full((1, 2, 4), 0.3), labels=jnp.ones((1, 2),
                   jnp.int32), valid=jnp.ones((1, 2), bool))
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), images, pad_mask, targets=targets,
        dn_rng=jax.random.PRNGKey(1), train=True,
        global_proto=jnp.zeros((k, model.hidden_dim)),
        amount=jnp.zeros((k,))))


def test_convert_covers_every_parameter():
    """Every flax parameter of a train-mode init, the train-only d_img,
    proto_d and label_enc included, lands on exactly one port parameter of
    the right shape."""
    kw = dict(num_classes=4, num_queries=12, hidden_dim=32, nheads=2,
              enc_layers=1, dec_layers=2, dim_feedforward=64)
    jm = jdino.DINO(**kw, dn_number=2, dn_single_pad=2, dn_labelbook_size=4,
                    use_remat=False)
    shapes = _abstract_train_params(jm, (64, 64))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = state_dict_from_flax(params)
    assert {"d_img", "label_enc", "proto_d"} <= {k.split(".")[0] for k in sd}
    n_leaves = sum(
        1 for k in flatten_dict(params["params"])
        if not (k[-2:-1] and k[-2] in ("query", "key", "value", "out")))
    tm = tdino.DINO(**kw, dn_number=2, dn_single_pad=2)
    port = tm.state_dict()
    assert set(sd) == set(port)
    for k, v in sd.items():
        assert v.shape == port[k].shape, k
    # every non-attention flax leaf maps to its own entry; each decoder
    # self-attention's 8 leaves fold into 4 entries
    assert len(sd) == n_leaves + 4 * kw["dec_layers"]
    assert load_flax_params(tm, params) == []


def test_config_loader_matches_datr_tpu():
    """The port's own config copy reads configs/ as datr_tpu does: `_base_`
    merging, and key=value overrides literal-evaluated into nested dicts."""
    path = "configs/DA/Cityscapes2FoggyCityscapes/DINO_4scale_C2F.py"
    overrides = ["num_classes=9", "lr=2e-4", "amp_dtype=bfloat16",
                 "use_dn=false", "new_group.depth=3", "pseudo=None"]
    got = load_config(path)
    want = jconfig.load_config(path)
    assert dict(got) == dict(want)
    assert got.num_classes == want.num_classes
    assert dict(apply_overrides(got, overrides)) == dict(
        jconfig.apply_overrides(want, overrides))


@pytest.mark.parametrize("wh", [(2048, 1024), (640, 480), (600, 900),
                                (1242, 375), (800, 800), (1333, 800)])
def test_get_size_with_aspect_ratio(wh):
    assert (ttransforms.get_size_with_aspect_ratio(wh, 800, 1333)
            == jtransforms.get_size_with_aspect_ratio(wh, 800, 1333))


@pytest.mark.parametrize("flag", [dict(amp_dtype="fp32"),
                                  dict(amp_dtype="float16")])
def test_build_refuses_what_the_port_lacks(flag):
    """bfloat16 and fast_norm build (tests/test_torch_port_bf16.py), and
    float64, datr_tpu's x64 debugging mode (tests/test_torch_port_x64.py);
    the other dtype names do not: datr_tpu reads them as float32. Shared
    two-stage heads build (tests/test_torch_port_registry.py)."""
    with pytest.raises(NotImplementedError, match=next(iter(flag))):
        tdino.build_dino_from_config(dict(num_classes=4, **flag),
                                     device="cpu")


def test_build_with_masks():
    """masks=True builds the mask head (tests/test_torch_port_masks.py
    holds it against datr_tpu): the backbone returns stages 0..3, the
    chunk reaches the model, and the head's widths follow hidden_dim."""
    m = tdino.build_dino_from_config(
        dict(num_classes=4, hidden_dim=128, nheads=8, enc_layers=1,
             dec_layers=1, num_queries=8, masks=True, mask_query_chunk=7),
        device="cpu")
    assert m.with_masks and m.mask_query_chunk == 7
    assert m.backbone_stages == (0, 1, 2, 3)
    assert m.mask_head.lay1.weight.shape == (136, 136, 3, 3)
    assert m.mask_head.adapter3.weight.shape == (16, 256, 1, 1)
    assert not hasattr(tdino.build_dino_from_config(
        dict(num_classes=4), device="cpu"), "mask_head")


def test_flagship_config_tree_matches_flax():
    """configs/DINO/DINO_4scale.py with num_classes=9, read by the port's own
    loader, builds the flagship port model whose state_dict has the flax
    flagship's shapes (train-only parameters aside)."""
    cfg = load_config("configs/DINO/DINO_4scale.py")
    cfg["num_classes"] = 9
    tm = tdino.build_dino_from_config(cfg, device="cpu")
    cfg_j = dict(cfg, use_remat=False)
    jm = jdino.build_dino_from_config(cfg_j)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)),
        jnp.zeros((1, 256, 256), bool), train=False))  # >= 900 tokens
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    shapes)
    sd = state_dict_from_flax(params)
    port = tm.state_dict()
    # an eval-mode flax init has no DA heads; everything else matches
    da = {k for k in port if k.split(".")[0] in ("d_img", "proto_d")}
    assert da and set(sd) == set(port) - da
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in port.items() if k not in da}
    n_params = sum(p.numel() for p in tm.parameters())
    assert 4.0e7 < n_params < 5.0e7, n_params  # DINO-R50 4-scale, 9 classes,
    # with the DA heads
