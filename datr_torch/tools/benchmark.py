"""Model benchmark: parameters, FLOPs, latency and FPS of the eval forward
(port of tools/benchmark.py).

    python -m datr_torch.tools.benchmark -c configs/DINO/DINO_4scale.py \\
        [--options num_classes=9] [--batch 1] [--n1 2] [--n2 10] \\
        [--hw 800 1344] [--peak_tflops T] [--out flops/log.txt] \\
        [--device cpu]

Builds the config's model through the registry (`models.build_model`,
seeded weights), on the CUDA card unless `--device cpu`, and times its eval
forward (`model(images, pad_mask)`, seeded uniform images, no padding) by
`utils/profiling.measure_throughput`: the difference of runs of n1 and n2
back-to-back forwards, by CUDA events on the card (host clock on the CPU).
On the card TF32 is off, as the server runs an f32 model. Prints one JSON
line and appends it to `--out`:
  nparam_M          parameters and buffers of the eval model, in millions:
                    the state dict less the train-only DA heads (d_img,
                    proto_d), which is datr_tpu's eval-init tree;
  gflops_per_image  what `torch.utils.flop_counter.FlopCounterMode` counts
                    in one forward (2 per multiply-add of every matmul,
                    convolution and attention product; no elementwise work,
                    norms or softmax), plus MSDA's multiply-adds by formula,
                    which it cannot see (the kernel is called through
                    ctypes): 2 x B x Lq x H x L x P x 4 corners x D per
                    call. datr_tpu's number is XLA's cost analysis, which
                    counts elementwise work too: the two are not equal;
  latency_ms, fps   per forward of `--batch` images;
  tflops_per_s, mfu_pct  gflops_per_image x fps, and its share of
                    `--peak_tflops` (default: NVIDIA's H100 SXM data sheet
                    peak for the model's amp_dtype, dense: float32 67
                    TFLOP/s outside the tensor cores, bfloat16 989);
  batch, hw, device.
On the CPU the numbers are the CPU's, not a device metric.
"""

from __future__ import annotations

import argparse
import json
import os
from unittest import mock

import torch

from ..convert import DA_HEADS

# NVIDIA H100 SXM data sheet, dense, TFLOP/s, by amp_dtype
PEAK_TFLOPS = {"float32": 67.0, "bfloat16": 989.0}


def eval_parameters(model) -> int:
    """Elements of the model's state dict, the train-only DA heads
    excepted."""
    return sum(v.numel() for k, v in model.state_dict().items()
               if k.split(".")[0] not in DA_HEADS)


def forward_flops(model, images, pad_mask) -> float:
    """FLOPs of one eval forward: FlopCounterMode's count plus MSDA's
    2 x B x Lq x H x L x P x 4 x D per call (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import msda

    msda_flops = []
    call = msda.ms_deform_attn

    def counted(value, shapes, loc, attn):
        B, Lq, H, L, P, _ = loc.shape
        msda_flops.append(2 * B * Lq * H * L * P * 4 * value.shape[-1])
        return call(value, shapes, loc, attn)

    counter = FlopCounterMode(display=False)
    # the counter's module tracker hooks the gradient of every input that
    # requires one, which a forward without autograd has not: the
    # parameters stop requiring it for the count
    grads = [p.requires_grad for p in model.parameters()]
    model.requires_grad_(False)
    try:
        with mock.patch.object(msda, "ms_deform_attn", counted), counter, \
                torch.inference_mode():
            model(images, pad_mask)
    finally:
        for p, g in zip(model.parameters(), grads):
            p.requires_grad_(g)
    return float(counter.get_total_flops() + sum(msda_flops))


def run(args) -> dict:
    from ..config import apply_overrides, load_config
    from ..models import build_model
    from ..utils.profiling import measure_throughput

    cfg = apply_overrides(load_config(args.config_file), args.options)
    model, _, _ = build_model(cfg, args.device)
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    H, W = args.hw
    gen = torch.Generator().manual_seed(0)
    images = torch.rand((args.batch, H, W, 3), generator=gen).to(dev)
    pad_mask = torch.zeros((args.batch, H, W), dtype=torch.bool, device=dev)

    flops = forward_flops(model, images, pad_mask)

    def fwd(images, pad_mask):
        with torch.inference_mode():
            return model(images, pad_mask)

    dt = measure_throughput(fwd, (images, pad_mask), batch=args.batch,
                            n1=args.n1, n2=args.n2)
    peak = args.peak_tflops or PEAK_TFLOPS[cfg.get("amp_dtype", "float32")]
    gflops_img = flops / 1e9 / args.batch
    fps = args.batch / dt
    return {
        "nparam_M": round(eval_parameters(model) / 1e6, 2),
        "gflops_per_image": round(gflops_img, 2),
        "latency_ms": round(dt * 1e3, 2),
        "fps": round(fps, 2),
        "tflops_per_s": round(gflops_img * fps / 1e3, 2),
        "mfu_pct": round(100.0 * gflops_img * fps / 1e3 / peak, 2),
        "batch": args.batch,
        "hw": [H, W],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def get_args_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--options", nargs="+", default=[])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--n1", type=int, default=2,
                    help="short run of the two-point measurement")
    ap.add_argument("--n2", type=int, default=10,
                    help="long run of the two-point measurement")
    ap.add_argument("--hw", type=int, nargs=2, default=[800, 1344])
    ap.add_argument("--peak_tflops", type=float, default=None,
                    help="peak for the MFU (default: the H100 SXM data "
                         "sheet's for the model's amp_dtype: float32 67, "
                         "bfloat16 989)")
    ap.add_argument("--out", default="flops/log.txt")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    result = run(args)
    print(json.dumps(result))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
