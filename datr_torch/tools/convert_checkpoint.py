"""A reference DATR/DINO PyTorch checkpoint (`.pth`) straight into the
port's state dict (port of tools/convert_checkpoint.py, with no flax tree in
between and no JAX).

The reference's module tree (models/dino/dino.py, deformable_transformer.py,
torchvision's ResNet, swin_transformer.py, convnext.py) maps onto the
port's, whose attribute names mirror datr_tpu's flax tree: the result is
the composition of tools/convert_checkpoint.py's mapping with
`datr_torch.convert.state_dict_from_flax`, written directly. The layouts
agree (conv OIHW, Linear [out, in], nn.MultiheadAttention's fused
`in_proj_weight`), so every tensor is taken as it is, cast to float32:
no transpose goes out and back. `module.` prefixes are stripped.

The output is the port's own checkpoint format (a params-only checkpoint,
`train/checkpoint.py:save_checkpoint`), which `python -m datr_torch.main
--resume` / `--pretrain_model_path`, `InferenceServer` and `inference.py`
read. `load_reference_checkpoint` loads a `.pth` into a model in place.
The file is read with `torch.load(weights_only=True)`; the reference's own
checkpoints also hold an `argparse.Namespace` under `args`, the one class
let through.

Usage:
  python -m datr_torch.tools.convert_checkpoint --torch_ckpt checkpoint.pth \\
      --config configs/DA/Cityscapes2FoggyCityscapes/DINO_4scale_C2F.py \\
      --out converted.pth  [--key model|ema_model] [--options k=v ...]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Mapping

import numpy as np
import torch

from ..convert import DA_HEADS

Tensors = Dict[str, torch.Tensor]


def fake_reference_state_dict(enc=1, dec=1, d=64, heads=4, K=3, ffn=128,
                       labelbook=3, nq=8):
    """Random-weight state dict in the reference's exact key layout
    (dino.py / deformable_transformer.py modules, 4 levels x 4 points,
    shared heads) — used by conversion tests and the repro kit's
    offline dry run (tools/repro_c2f.py)."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    sd = {}
    # torchvision resnet50 (stem + all blocks)
    pre = "backbone.0.body."
    sd[pre + "conv1.weight"] = t(64, 3, 7, 7)
    for s in ("weight", "bias", "running_mean", "running_var"):
        sd[pre + f"bn1.{s}"] = t(64)
    layers = {1: (3, 64, 256), 2: (4, 128, 512), 3: (6, 256, 1024),
              4: (3, 512, 2048)}
    in_ch = 64
    for li, (blocks, width, out_ch) in layers.items():
        for b in range(blocks):
            p = f"{pre}layer{li}.{b}"
            cin = in_ch if b == 0 else out_ch
            sd[p + ".conv1.weight"] = t(width, cin, 1, 1)
            sd[p + ".conv2.weight"] = t(width, width, 3, 3)
            sd[p + ".conv3.weight"] = t(out_ch, width, 1, 1)
            for ci, c in ((1, width), (2, width), (3, out_ch)):
                for s in ("weight", "bias", "running_mean", "running_var"):
                    sd[p + f".bn{ci}.{s}"] = t(c)
            if b == 0:
                sd[p + ".downsample.0.weight"] = t(out_ch, cin, 1, 1)
                for s in ("weight", "bias", "running_mean", "running_var"):
                    sd[p + f".downsample.1.{s}"] = t(out_ch)
        in_ch = out_ch

    for i, cin in enumerate((512, 1024, 2048, 2048)):
        sd[f"input_proj.{i}.0.weight"] = t(d, cin, 3 if i == 3 else 1,
                                           3 if i == 3 else 1)
        sd[f"input_proj.{i}.0.bias"] = t(d)
        sd[f"input_proj.{i}.1.weight"] = t(d)
        sd[f"input_proj.{i}.1.bias"] = t(d)

    sd["transformer.level_embed"] = t(4, d)
    sd["transformer.tgt_embed.weight"] = t(nq, d)
    sd["label_enc.weight"] = t(labelbook + 1, d)

    def msda(p):
        sd[p + ".sampling_offsets.weight"] = t(heads * 4 * 4 * 2, d)
        sd[p + ".sampling_offsets.bias"] = t(heads * 4 * 4 * 2)
        sd[p + ".attention_weights.weight"] = t(heads * 4 * 4, d)
        sd[p + ".attention_weights.bias"] = t(heads * 4 * 4)
        for m in ("value_proj", "output_proj"):
            sd[p + f".{m}.weight"] = t(d, d)
            sd[p + f".{m}.bias"] = t(d)

    def ln(p, dim=d):
        sd[p + ".weight"] = t(dim)
        sd[p + ".bias"] = t(dim)

    for l in range(enc):
        p = f"transformer.encoder.layers.{l}"
        msda(p + ".self_attn")
        ln(p + ".norm1")
        sd[p + ".linear1.weight"] = t(ffn, d)
        sd[p + ".linear1.bias"] = t(ffn)
        sd[p + ".linear2.weight"] = t(d, ffn)
        sd[p + ".linear2.bias"] = t(d)
        ln(p + ".norm2")
    for l in range(dec):
        p = f"transformer.decoder.layers.{l}"
        msda(p + ".cross_attn")
        ln(p + ".norm1")
        sd[p + ".self_attn.in_proj_weight"] = t(3 * d, d)
        sd[p + ".self_attn.in_proj_bias"] = t(3 * d)
        sd[p + ".self_attn.out_proj.weight"] = t(d, d)
        sd[p + ".self_attn.out_proj.bias"] = t(d)
        ln(p + ".norm2")
        sd[p + ".linear1.weight"] = t(ffn, d)
        sd[p + ".linear1.bias"] = t(ffn)
        sd[p + ".linear2.weight"] = t(d, ffn)
        sd[p + ".linear2.bias"] = t(d)
        ln(p + ".norm3")
    ln("transformer.decoder.norm")
    # running_var must be positive (FrozenBN takes sqrt)
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    for i in range(2):
        sd[f"transformer.decoder.ref_point_head.layers.{i}.weight"] = (
            t(d, 2 * d if i == 0 else d)
        )
        sd[f"transformer.decoder.ref_point_head.layers.{i}.bias"] = t(d)
    sd["class_embed.0.weight"] = t(K, d)
    sd["class_embed.0.bias"] = t(K)
    for i in range(3):
        out = 4 if i == 2 else d
        sd[f"bbox_embed.0.layers.{i}.weight"] = t(out, d)
        sd[f"bbox_embed.0.layers.{i}.bias"] = t(out)
    sd["transformer.enc_output.weight"] = t(d, d)
    sd["transformer.enc_output.bias"] = t(d)
    ln("transformer.enc_output_norm")
    sd["transformer.enc_out_class_embed.weight"] = t(K, d)
    sd["transformer.enc_out_class_embed.bias"] = t(K)
    for i in range(3):
        out = 4 if i == 2 else d
        sd[f"transformer.enc_out_bbox_embed.layers.{i}.weight"] = t(out, d)
        sd[f"transformer.enc_out_bbox_embed.layers.{i}.bias"] = t(out)
    return sd


def build_reference_state_dict(config, options=()):
    """Reference-layout random state dict sized for `config` (the port's
    config loader) — the stand-in for a published .pth in offline dry
    runs."""
    from ..config import apply_overrides, load_config

    cfg = apply_overrides(load_config(config), list(options))
    return fake_reference_state_dict(
        enc=cfg.enc_layers, dec=cfg.dec_layers, d=cfg.hidden_dim,
        heads=cfg.nheads, K=cfg.num_classes, ffn=cfg.dim_feedforward,
        labelbook=cfg.dn_labelbook_size, nq=cfg.num_queries)


def _f32(v) -> torch.Tensor:
    """A tensor of the state dict as a contiguous float32 torch tensor."""
    t = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
    return t.detach().to("cpu", torch.float32).contiguous()


def _copy(sd, src: str, dst: str, out: Tensors,
          names=("weight", "bias")):
    for n in names:
        out[f"{dst}.{n}"] = _f32(sd[f"{src}.{n}"])


def convert_ln(sd, src: str, dst: str) -> Tensors:
    """A LayerNorm (or GroupNorm): weight and bias, as they are."""
    out: Tensors = {}
    _copy(sd, src, dst, out)
    return out


def _bn(sd, src, dst, out):
    _copy(sd, src, dst, out, ("weight", "bias", "running_mean",
                              "running_var"))


def convert_resnet(sd: Mapping, prefix="backbone.0.body.") -> Tensors:
    """torchvision ResNet -> the port's ResNet (`models/resnet.py`), keys
    relative to the backbone."""
    out: Tensors = {"conv1.weight": _f32(sd[prefix + "conv1.weight"])}
    _bn(sd, prefix + "bn1", "bn1", out)
    for layer in range(1, 5):
        b = 0
        while f"{prefix}layer{layer}.{b}.conv1.weight" in sd:
            src, dst = f"{prefix}layer{layer}.{b}", f"layer{layer}_block{b}"
            for ci in (1, 2, 3):
                out[f"{dst}.conv{ci}.weight"] = _f32(
                    sd[f"{src}.conv{ci}.weight"])
                _bn(sd, f"{src}.bn{ci}", f"{dst}.bn{ci}", out)
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.downsample_conv.weight"] = _f32(
                    sd[f"{src}.downsample.0.weight"])
                _bn(sd, f"{src}.downsample.1", f"{dst}.downsample_bn", out)
            b += 1
    return out


def convert_swin(sd: Mapping, prefix="backbone.0.") -> Tensors:
    """Reference swin_transformer.py -> the port's `models/swin.py`: patch
    embed, per-block norms / attention (fused qkv, the relative-position
    bias table) / MLP, the patch-merging downsamples and the out_indices
    norms (norm{i} -> out_norm{i}); the relative_position_index buffers are
    recomputed, not copied."""
    out: Tensors = {}
    _copy(sd, prefix + "patch_embed.proj", "patch_embed", out)
    _copy(sd, prefix + "patch_embed.norm", "patch_norm", out)
    stage = 0
    while f"{prefix}layers.{stage}.blocks.0.norm1.weight" in sd:
        b = 0
        while f"{prefix}layers.{stage}.blocks.{b}.norm1.weight" in sd:
            src, dst = (f"{prefix}layers.{stage}.blocks.{b}",
                        f"stage{stage}_block{b}")
            for a, z in (("norm1", "norm1"), ("norm2", "norm2"),
                         ("attn.qkv", "attn.qkv"), ("attn.proj", "attn.proj"),
                         ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
                _copy(sd, f"{src}.{a}", f"{dst}.{z}", out)
            out[f"{dst}.attn.relative_position_bias_table"] = _f32(
                sd[f"{src}.attn.relative_position_bias_table"])
            b += 1
        down = f"{prefix}layers.{stage}.downsample"
        if f"{down}.reduction.weight" in sd:
            _copy(sd, f"{down}.norm", f"merge{stage}.norm", out)
            out[f"merge{stage}.reduction.weight"] = _f32(
                sd[f"{down}.reduction.weight"])
        stage += 1
    for i in range(4):
        if f"{prefix}norm{i}.weight" in sd:
            _copy(sd, f"{prefix}norm{i}", f"out_norm{i}", out)
    return out


def convert_convnext(sd: Mapping, prefix="backbone.0.",
                     out_indices=(1, 2, 3)) -> Tensors:
    """Reference models/dino/convnext.py -> the port's `models/convnext.py`:
    stem conv + LN, the LN + conv downsamples, per block dwconv / norm /
    pwconv1 / pwconv2 / gamma, the out norms norm{i} -> out_norm{i} of the
    returned stages (the reference registers one for every stage)."""
    out: Tensors = {}
    _copy(sd, prefix + "downsample_layers.0.0", "stem_conv", out)
    _copy(sd, prefix + "downsample_layers.0.1", "stem_norm", out)
    stage = 0
    while f"{prefix}stages.{stage}.0.dwconv.weight" in sd:
        if stage > 0:
            down = f"{prefix}downsample_layers.{stage}"
            _copy(sd, f"{down}.0", f"down{stage}_norm", out)
            _copy(sd, f"{down}.1", f"down{stage}_conv", out)
        b = 0
        while f"{prefix}stages.{stage}.{b}.dwconv.weight" in sd:
            src, dst = f"{prefix}stages.{stage}.{b}", f"stage{stage}_block{b}"
            for n in ("dwconv", "norm", "pwconv1", "pwconv2"):
                _copy(sd, f"{src}.{n}", f"{dst}.{n}", out)
            out[f"{dst}.gamma"] = _f32(sd[f"{src}.gamma"])
            b += 1
        stage += 1
    for i in out_indices:
        if f"{prefix}norm{i}.weight" in sd:
            _copy(sd, f"{prefix}norm{i}", f"out_norm{i}", out)
    return out


def convert_msda(sd: Mapping, src: str, dst: str) -> Tensors:
    """MSDeformAttn: its four projections, as they are."""
    out: Tensors = {}
    for m in ("sampling_offsets", "attention_weights", "value_proj",
              "output_proj"):
        _copy(sd, f"{src}.{m}", f"{dst}.{m}", out)
    return out


def convert_mlp(sd: Mapping, src: str, n_layers: int, dst: str
                ) -> Tensors:
    """The reference MLP's `layers.{i}` -> the port's `layer{i}`."""
    out: Tensors = {}
    for i in range(n_layers):
        _copy(sd, f"{src}.layers.{i}", f"{dst}.layer{i}", out)
    return out


def convert_mha(sd: Mapping, src: str, n_heads: int, d_model: int,
                dst: str) -> Tensors:
    """nn.MultiheadAttention: the port's MultiheadAttention keeps its
    layout (fused [3d, d] in_proj, out_proj), so the tensors pass as they
    are; `n_heads` and `d_model` are checked against them."""
    w = _f32(sd[f"{src}.in_proj_weight"])
    if tuple(w.shape) != (3 * d_model, d_model) or d_model % n_heads:
        raise ValueError(f"{src}: in_proj_weight {tuple(w.shape)} does not "
                         f"fit d_model {d_model} with {n_heads} heads")
    out: Tensors = {f"{dst}.in_proj_weight": w,
                    f"{dst}.in_proj_bias": _f32(sd[f"{src}.in_proj_bias"])}
    _copy(sd, f"{src}.out_proj", f"{dst}.out_proj", out)
    return out


def convert_checkpoint(sd: Mapping, enc_layers=6, dec_layers=6, n_heads=8,
                       d_model=256) -> Tensors:
    """A reference state dict (tensors or numpy arrays, `module.` already
    stripped) -> the port's DINO state dict: the keys and float32 values
    of `state_dict_from_flax(tools.convert_checkpoint.convert_checkpoint(
    sd))`."""
    if "backbone.0.patch_embed.proj.weight" in sd:
        backbone = convert_swin(sd)
    elif "backbone.0.downsample_layers.0.0.weight" in sd:
        backbone = convert_convnext(sd)
    else:
        backbone = convert_resnet(sd)
    p: Tensors = {f"backbone.{k}": v for k, v in backbone.items()}

    # input projections (dino.py:111-133: Sequential(conv, GroupNorm))
    i = 0
    while f"input_proj.{i}.0.weight" in sd:
        _copy(sd, f"input_proj.{i}.0", f"input_proj{i}_conv", p)
        _copy(sd, f"input_proj.{i}.1", f"input_proj{i}_norm", p)
        i += 1
    p["level_embed"] = _f32(sd["transformer.level_embed"])
    p["tgt_embed"] = _f32(sd["transformer.tgt_embed.weight"])
    p["label_enc"] = _f32(sd["label_enc.weight"])

    for n in range(enc_layers):
        src, dst = f"transformer.encoder.layers.{n}", f"enc_layer{n}"
        p.update(convert_msda(sd, f"{src}.self_attn", f"{dst}.self_attn"))
        p.update(convert_ln(sd, f"{src}.norm1", f"{dst}.norm1"))
        _copy(sd, f"{src}.linear1", f"{dst}.ffn.linear1", p)
        _copy(sd, f"{src}.linear2", f"{dst}.ffn.linear2", p)
        p.update(convert_ln(sd, f"{src}.norm2", f"{dst}.ffn.norm"))
    for n in range(dec_layers):
        src, dst = f"transformer.decoder.layers.{n}", f"dec_layer{n}"
        p.update(convert_msda(sd, f"{src}.cross_attn", f"{dst}.cross_attn"))
        p.update(convert_ln(sd, f"{src}.norm1", f"{dst}.norm1"))
        p.update(convert_mha(sd, f"{src}.self_attn", n_heads, d_model,
                             f"{dst}.self_attn"))
        p.update(convert_ln(sd, f"{src}.norm2", f"{dst}.norm2"))
        _copy(sd, f"{src}.linear1", f"{dst}.ffn.linear1", p)
        _copy(sd, f"{src}.linear2", f"{dst}.ffn.linear2", p)
        p.update(convert_ln(sd, f"{src}.norm3", f"{dst}.ffn.norm"))
    p.update(convert_ln(sd, "transformer.decoder.norm", "decoder_norm"))
    p.update(convert_mlp(sd, "transformer.decoder.ref_point_head", 2,
                         "ref_point_head"))
    # shared heads (bbox_embed.0 == every layer's when share=True)
    _copy(sd, "class_embed.0", "class_head", p)
    p.update(convert_mlp(sd, "bbox_embed.0", 3, "bbox_head"))
    _copy(sd, "transformer.enc_output", "enc_output", p)
    p.update(convert_ln(sd, "transformer.enc_output_norm", "enc_output_norm"))
    _copy(sd, "transformer.enc_out_class_embed", "enc_out_class_head", p)
    p.update(convert_mlp(sd, "transformer.enc_out_bbox_embed", 3,
                         "enc_out_bbox_head"))
    # DA heads (train-time only in the reference; may be absent)
    if "D_img.conv1.weight" in sd:
        for n in ("conv1", "conv2", "conv3", "classifier"):
            _copy(sd, f"D_img.{n}", f"d_img.{n}", p)
    if "Proto_D.layers.0.weight" in sd:
        p.update(convert_mlp(sd, "Proto_D", 3, "proto_d"))
    return p


def read_reference_state_dict(path: str, key: str = "model") -> Dict:
    """The state dict under `key` ('model' or 'ema_model') of a reference
    `.pth` (or the file's own dict where it holds no such key), `module.`
    prefixes stripped. Read with weights_only=True; an argparse.Namespace
    (the reference's `args`) is the one class allowed through."""
    torch.serialization.add_safe_globals([argparse.Namespace])
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get(key, ckpt) if isinstance(ckpt, Mapping) else ckpt
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: no state dict under {key!r}")
    return {k.replace("module.", ""): v for k, v in sd.items()
            if torch.is_tensor(v) or isinstance(v, np.ndarray)}


def _model_dims(model) -> dict:
    layer = model.dec_layer0.self_attn if model.dec_layers else None
    return dict(enc_layers=model.enc_layers, dec_layers=model.dec_layers,
                n_heads=layer.n_heads if layer is not None else 8,
                d_model=model.hidden_dim)


def load_reference_checkpoint(model, path: str, key: str = "model"):
    """Load a reference `.pth` into the port's `model` in place (its dims
    from the model). Every parameter and buffer must come from the file,
    except the train-only DA heads, which a published eval checkpoint may
    lack and which then keep the model's own init; no key may be left
    over. Returns the names so kept."""
    sd = convert_checkpoint(read_reference_state_dict(path, key),
                            **_model_dims(model))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    bad = [k for k in missing if k.split(".")[0] not in DA_HEADS]
    if bad or unexpected:
        raise KeyError(f"{path} does not fit the model: missing {bad}, "
                       f"unexpected {unexpected}")
    return missing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--torch_ckpt", required=True)
    ap.add_argument("--out", required=True,
                    help="the port's params-only checkpoint to write")
    ap.add_argument("--key", default="model",
                    help="'model' or 'ema_model' inside the .pth")
    ap.add_argument("--config", default="",
                    help="config: derives enc/dec layer counts, heads and "
                         "width for the module mapping")
    ap.add_argument("--options", nargs="+", default=[])
    args = ap.parse_args(argv)

    from ..train.checkpoint import save_checkpoint

    dims, cfg = {}, None
    if args.config:
        from ..config import apply_overrides, load_config

        cfg = apply_overrides(load_config(args.config), args.options)
        dims = dict(enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
                    n_heads=cfg.nheads, d_model=cfg.hidden_dim)
    sd = convert_checkpoint(read_reference_state_dict(args.torch_ckpt,
                                                      args.key), **dims)
    seeded = []
    if cfg is not None:
        # the train-only DA heads a published eval .pth lacks come from
        # the config's seeded model (seed 0), so the checkpoint loads
        # whole wherever the port reads one; every other key must match
        from ..models import build_model

        model, _, _ = build_model(cfg, "cpu")
        want = model.state_dict()
        seeded = sorted(k for k in want if k not in sd
                        and k.split(".")[0] in DA_HEADS)
        sd.update({k: want[k] for k in seeded})
        bad = sorted(set(want) ^ set(sd))
        if bad:
            raise KeyError(f"{args.torch_ckpt} does not fit {args.config}: "
                           f"{bad}")
    save_checkpoint(args.out, sd, epoch=-1,
                    extra={"converted_from": args.torch_ckpt,
                           "key": args.key, "seeded_da_heads": seeded})
    n = sum(v.numel() for v in sd.values())
    print(json.dumps({"converted": args.torch_ckpt, "key": args.key,
                      "out": args.out, "tensors": len(sd),
                      "params_M": round(n / 1e6, 2),
                      "seeded_da_heads": len(seeded)}))
    return args.out


if __name__ == "__main__":
    main()
