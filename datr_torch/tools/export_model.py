"""Export the eval forward (backbone -> ... -> the postprocess inputs) with
`torch.export` (port of tools/export_model.py, whose artifact is a
serialized StableHLO module).

The forward is traced once at a fixed batch and canvas into an
ExportedProgram and saved with `torch.export.save`: the graph of aten ops
and the weights, loadable without the model code. MSDA enters the graph as
the registered op `datr_torch::ms_deform_attn` (ops/msda.py), so an
artifact needs `import datr_torch.ops` and nothing else of the port:
`load_exported` does that and returns the loaded module, which takes
(images [B, H, W, 3] f32 normalized, pad_mask [B, H, W] bool, True = pad)
and returns (pred_logits [B, Q, K], pred_boxes [B, Q, 4] cxcywh in [0, 1]).
On a card, the exported forward launches `msda_fwd` once per encoder and
decoder layer, as the eager one does.

Usage:
  python -m datr_torch.tools.export_model -c configs/DA/.../DINO_4scale_C2F.py \\
      (--ckpt runs/c2f/checkpoint_best_regular | --torch_ckpt published.pth
       [--key model|ema_model]) --out model.pt2 \\
      [--batch 1 --canvas 800 1344] [--device cpu] [--options k=v ...] \\
      [--print_graph graph.txt]

`--print_graph` writes the exported graph's text, then the copy, cast and
layout ops of the graph ranked by the bytes they write, with their shapes
(tools/dump_hlo.py's question asked of the port). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import torch
from torch import nn

# aten ops that write a copy of their input, converted or rearranged,
# without computing on it (views, which write nothing, are left out)
COPY_OPS = ("copy", "_to_copy", "to", "clone", "contiguous", "repeat", "cat",
            "stack", "index_select", "gather")


class EvalForward(nn.Module):
    """The model's eval forward cut to the postprocess inputs."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images, pad_mask):
        out = self.model(images, pad_mask)
        return out["pred_logits"], out["pred_boxes"]


def build_exported(model: nn.Module, batch: int = 1, canvas=(800, 1344)):
    """The ExportedProgram of `model`'s eval forward at [batch, *canvas],
    traced on the model's device."""
    dev = next(model.parameters()).device
    h, w = canvas
    args = (torch.zeros((batch, h, w, 3), device=dev),
            torch.zeros((batch, h, w), dtype=torch.bool, device=dev))
    with torch.no_grad():
        return torch.export.export(EvalForward(model.eval()), args)


def load_exported(path: str) -> nn.Module:
    """The module of an artifact `build_exported` saved, with the port's
    op registered first."""
    import datr_torch.ops  # noqa: F401  (datr_torch::ms_deform_attn)

    return torch.export.load(path).module()


def msda_nodes(ep) -> int:
    return sum(1 for n in ep.graph.nodes
               if "datr_torch.ms_deform_attn" in str(n.target))


def _bytes(val) -> int:
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    if isinstance(val, (list, tuple)):
        return sum(_bytes(v) for v in val)
    return 0


def rank_copies(ep, top: int = 30) -> list:
    """The graph's copy / cast / layout ops (`COPY_OPS`; a `to` or
    `contiguous` that returns its input is left out) grouped by (op, output
    shape, dtype), largest total bytes written first."""
    groups = defaultdict(lambda: [0, 0])
    for n in ep.graph.nodes:
        if n.op != "call_function":
            continue
        name = str(n.target).split(".")
        op = name[1] if len(name) > 2 and name[0] == "aten" else name[0]
        if op not in COPY_OPS:
            continue
        val = n.meta.get("val")
        src = n.args[0].meta.get("val") if n.args and isinstance(
            n.args[0], torch.fx.Node) else None
        if isinstance(val, torch.Tensor) and isinstance(src, torch.Tensor) \
                and (op == "to" and (val.dtype, val.device) == (
                    src.dtype, src.device)
                     or op == "contiguous" and src.is_contiguous()):
            continue  # returns its input: writes nothing
        shape = tuple(val.shape) if isinstance(val, torch.Tensor) else None
        dtype = str(val.dtype) if isinstance(val, torch.Tensor) else None
        g = groups[(op, shape, dtype)]
        g[0] += 1
        g[1] += _bytes(val)
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]
    return [{"op": op, "shape": list(shape) if shape else None,
             "dtype": dtype, "count": c, "bytes": b}
            for (op, shape, dtype), (c, b) in ranked]


def load_weights(model: nn.Module, args):
    """The weights `--ckpt` (a port checkpoint) or `--torch_ckpt` (a
    reference .pth, through tools/convert_checkpoint.py) name."""
    if args.torch_ckpt:
        from .convert_checkpoint import load_reference_checkpoint

        load_reference_checkpoint(model, args.torch_ckpt, args.key)
    else:
        from ..inference import load_eval_params

        model.load_state_dict(load_eval_params(args.ckpt))


def get_args_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--options", nargs="+", default=[])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", default="", help="a port checkpoint")
    src.add_argument("--torch_ckpt", default="",
                     help="a reference .pth (converted on the way in)")
    ap.add_argument("--key", default="model",
                    help="--torch_ckpt: 'model' or 'ema_model'")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--canvas", type=int, nargs=2, default=[800, 1344])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--print_graph", default="",
                    help="write the graph's text and its copy ops here")
    return ap


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)
    from ..config import apply_overrides, load_config
    from ..models import build_model

    cfg = apply_overrides(load_config(args.config_file), args.options)
    model, _, _ = build_model(cfg, args.device)
    load_weights(model, args)
    t0 = time.perf_counter()
    ep = build_exported(model, args.batch, tuple(args.canvas))
    export_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.export.save(ep, args.out)
    result = {"exported": args.out, "bytes": os.path.getsize(args.out),
              "export_s": round(export_s, 3), "msda_nodes": msda_nodes(ep),
              "batch": args.batch, "canvas": list(args.canvas),
              "device": str(next(model.parameters()).device)}
    if args.print_graph:
        copies = rank_copies(ep)
        with open(args.print_graph, "w") as f:
            f.write(str(ep.graph))
            f.write("\n# copy / cast / layout ops by bytes written\n")
            for c in copies:
                f.write(json.dumps(c) + "\n")
        result["graph"] = args.print_graph
        result["copy_bytes_top"] = copies[:5]
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
