"""datr_torch/tools/convert_checkpoint.py (a reference DATR/DINO `.pth`
straight into the port's state dict, no JAX) against the JAX tool,
tools/convert_checkpoint.py, followed by the port's
`convert.state_dict_from_flax`: for reference-layout state dicts with an
R50, a Swin and a ConvNeXt backbone at small widths, the two state dicts
are equal key for key and bit for bit. The converted small R50 model's
eval forward is held against datr_tpu's forward on the JAX tool's tree at
the full-model tolerances of tests/test_torch_parity.py:82-109 (logits atol
2e-3, boxes 1e-4), its two-stage selection equal. A `.pth` holding the
reference's `args` Namespace loads with torch.load(weights_only=True); the
CLI writes the port's checkpoint format, which the port's loaders read."""

import argparse
import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.config import apply_overrides, load_config
from datr_torch.convert import DA_HEADS, state_dict_from_flax
from datr_torch.models.convnext import ConvNeXt
from datr_torch.models.dino import build_dino_from_config
from datr_torch.models.swin import SwinTransformer
from datr_torch.tools import convert_checkpoint as conv
from datr_tpu import config as jconfig
from datr_tpu.models.dino import build_dino_from_config as jax_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_tools_convert_checkpoint",
    os.path.join(ROOT, "tools", "convert_checkpoint.py"))
jconv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jconv)

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
CANVAS = (64, 96)
TINY = ["num_classes=4", "hidden_dim=32", "nheads=2", "enc_layers=1",
        "dec_layers=2", "dim_feedforward=64", "num_queries=12",
        "dn_number=2", "dn_single_pad=2", "dn_labelbook_size=4",
        "use_remat=False"]
DIMS = dict(enc=1, dec=2, d=32, heads=2, K=4, ffn=64, labelbook=4, nq=12)
TINY_SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
TINY_CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))

# the port's backbone names -> the reference's (the inverse of the tool's
# mapping, written out independently of it)
SWIN_NAMES = [(r"^patch_embed\.", "patch_embed.proj."),
              (r"^patch_norm\.", "patch_embed.norm."),
              (r"^stage(\d+)_block(\d+)\.mlp_fc(\d)\.",
               r"layers.\1.blocks.\2.mlp.fc\3."),
              (r"^stage(\d+)_block(\d+)\.", r"layers.\1.blocks.\2."),
              (r"^merge(\d+)\.", r"layers.\1.downsample."),
              (r"^out_norm(\d)\.", r"norm\1.")]
CONVNEXT_NAMES = [(r"^stem_conv\.", "downsample_layers.0.0."),
                  (r"^stem_norm\.", "downsample_layers.0.1."),
                  (r"^down(\d)_norm\.", r"downsample_layers.\1.0."),
                  (r"^down(\d)_conv\.", r"downsample_layers.\1.1."),
                  (r"^stage(\d+)_block(\d+)\.", r"stages.\1.\2."),
                  (r"^out_norm(\d)\.", r"norm\1.")]


def _reference_names(port_sd, rules):
    out = {}
    for k, v in port_sd.items():
        for pat, rep in rules:
            if re.match(pat, k):
                k = re.sub(pat, rep, k, count=1)
                break
        out["backbone.0." + k] = v
    return out


def _realistic(sd, seed=0):
    """The same keys and shapes with seeded values of a trained model's
    scale (kernels N(0, 1/fan_in), biases and means 0.1 N, norm weights
    1 + 0.1 N, variances in [0.5, 1.5), embeddings N(0, 1)), so that the
    forward below carries signal; float32 numpy, as a .pth's tensors."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        shape = np.shape(v)
        if k.endswith("running_var"):
            x = 0.5 + rng.random(shape)
        elif len(shape) >= 2 and "embed" not in k and "label_enc" not in k:
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif len(shape) >= 2:
            x = rng.standard_normal(shape)
        elif k.endswith("weight") and "norm" in k or "bn" in k and \
                k.endswith("weight"):
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            x = 0.1 * rng.standard_normal(shape)
        out[k] = x.astype(np.float32)
    return out


def _backbone_sd(kind):
    """A reference-layout state dict with `kind`'s backbone: the fake R50
    dict of the JAX tool, its backbone swapped for a tiny Swin's or
    ConvNeXt's (names from the port's module, values seeded)."""
    sd = jconv.fake_reference_state_dict(**DIMS)
    if kind == "r50":
        return sd, None
    module = (SwinTransformer(**TINY_SWIN) if kind == "swin"
              else ConvNeXt(**TINY_CONVNEXT))
    rules = SWIN_NAMES if kind == "swin" else CONVNEXT_NAMES
    sd = {k: v for k, v in sd.items() if not k.startswith("backbone.")}
    sd.update(_reference_names(
        {k: v.numpy() for k, v in module.state_dict().items()}, rules))
    return _realistic(sd, 1), module


@pytest.mark.parametrize("kind", ["r50", "swin", "convnext"])
def test_state_dict_equals_the_jax_route(kind):
    """The port's converter == state_dict_from_flax(JAX tool's tree): the
    same keys, every tensor bitwise; a Swin / ConvNeXt backbone's part
    loads strictly into the port's own module."""
    sd, module = _backbone_sd(kind)
    got = conv.convert_checkpoint(sd, enc_layers=1, dec_layers=2, n_heads=2,
                                  d_model=32)
    want = state_dict_from_flax(jconv.convert_checkpoint(
        sd, enc_layers=1, dec_layers=2, n_heads=2, d_model=32))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        assert torch.equal(got[k], v), k
    if module is not None:
        module.load_state_dict({k[len("backbone."):]: v for k, v in
                                got.items() if k.startswith("backbone.")})


def test_converted_model_matches_datr_tpu(tmp_path):
    """The small R50 model loaded from a .pth by load_reference_checkpoint
    against datr_tpu's model on the JAX tool's tree: logits atol 2e-3,
    boxes 1e-4, the two-stage top-k equal; only the train-only DA heads
    keep their init."""
    sd = _realistic(jconv.fake_reference_state_dict(**DIMS))
    pth = tmp_path / "ref.pth"
    torch.save({"model": {f"module.{k}": torch.from_numpy(v)
                          for k, v in sd.items()},
                "args": argparse.Namespace(lr=1e-4, backbone="resnet50")},
               pth)
    path = "configs/DINO/DINO_4scale.py"
    cfg = apply_overrides(load_config(path), TINY)
    model = build_dino_from_config(cfg, device="cpu").eval()
    kept = conv.load_reference_checkpoint(model, str(pth))
    assert kept and all(k.split(".")[0] in DA_HEADS for k in kept)

    jm = jax_build(jconfig.apply_overrides(jconfig.load_config(path), TINY))
    tree = jconv.convert_checkpoint(sd, enc_layers=1, dec_layers=2,
                                    n_heads=2, d_model=32)
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, *CANVAS, 3)).astype(np.float32)
    pm = np.zeros((2, *CANVAS), bool)
    pm[0, 52:] = True
    pm[1, :, 75:] = True
    img[pm] = 0.0
    seen = {}
    top_k = jax.lax.top_k

    def spy(x, k):  # the first top_k of the forward is the two-stage one
        v, i = top_k(x, k)
        seen.setdefault("idx", i)
        return v, i

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", spy)
        want, want_idx = jax.device_get(jax.jit(
            lambda p, a, b: (jm.apply(p, a, b, train=False), seen["idx"]),
            compiler_options=FAST)(tree, jnp.asarray(img), jnp.asarray(pm)))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(pm))
    np.testing.assert_array_equal(got["topk_idx"].numpy(), want_idx)
    assert np.abs(want["pred_logits"]).max() > 0.5  # the forward has signal
    for key, w in want.items():
        atol = 2e-3 if "logits" in key else 1e-4
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=atol,
                                   err_msg=key)
    pth.unlink()  # the suite shares one disk


def test_pth_with_args_loads_weights_only(tmp_path):
    """The reference's checkpoints hold an argparse.Namespace under
    `args`: read_reference_state_dict lets that one class through
    torch.load(weights_only=True) and strips `module.`; `--key` picks the
    track."""
    sd = {"a.weight": torch.ones(2, 2), "b.bias": torch.zeros(2)}
    pth = tmp_path / "ref.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                "ema_model": {k: v + 1 for k, v in sd.items()},
                "args": argparse.Namespace(epochs=50), "epoch": 3}, pth)
    got = conv.read_reference_state_dict(str(pth))
    assert sorted(got) == sorted(sd)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    ema = conv.read_reference_state_dict(str(pth), key="ema_model")
    assert torch.equal(ema["a.weight"], sd["a.weight"] + 1)


def test_cli_writes_the_port_checkpoint(tmp_path, capsys):
    """`main --config` writes a params-only checkpoint in the port's format
    with the DA heads filled from the config's seeded model: the port's
    loaders (load_pretrain_params, inference.load_eval_params strictly)
    read it, and its tensors are the converter's."""
    from datr_torch.inference import load_eval_params
    from datr_torch.train.checkpoint import load_pretrain_params

    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text(f'_base_ = ["{os.path.abspath("configs/DINO/DINO_4scale.py")}"]\n'
                        + "\n".join(TINY) + "\n")
    sd = jconv.fake_reference_state_dict(**DIMS)
    pth = tmp_path / "ref.pth"
    torch.save({"ema_model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": argparse.Namespace()}, pth)
    out = tmp_path / "converted.pth"
    conv.main(["--torch_ckpt", str(pth), "--out", str(out), "--key",
               "ema_model", "--config", str(cfg_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["seeded_da_heads"] > 0
    model = build_dino_from_config(load_config(str(cfg_path)), device="cpu")
    model.load_state_dict(load_eval_params(str(out)))
    params = load_pretrain_params(str(out), model)
    want = conv.convert_checkpoint(sd, enc_layers=1, dec_layers=2,
                                   n_heads=2, d_model=32)
    assert all(torch.equal(params[k], v) for k, v in want.items())
    meta = json.loads((tmp_path / "converted.pth.meta.json").read_text())
    assert meta["key"] == "ema_model"
    pth.unlink()  # the suite shares one disk
    out.unlink()
