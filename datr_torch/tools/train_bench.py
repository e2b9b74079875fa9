"""Training-step time: the C2F burn-in (or self-training) step in s/step
(port of tools/train_bench.py).

    python -m datr_torch.tools.train_bench [--self-training] [--no-remat] \\
        [--batch 2] [--points N] [--amp] [--steps 3] [--device cpu] [--tiny]

The C2F configuration (configs/DA/Cityscapes2FoggyCityscapes/
DINO_4scale_C2F.py) with seeded weights, on the CUDA card unless `--device
cpu`, in f32 with TF32 off or, with `--amp`, in bf16; datr_tpu's batch:
uniform images at 800x1344, half source (32 boxes each) and half target.
`train.steps.train_step_burnin` (or `train_step_self_training`, per-class
pseudo-label thresholds 0.3) runs one warm-up step, then `--steps` steps
timed by CUDA events on the card (the host clock on the CPU: not a device
time). `--points` overrides enc/dec_n_points (configs/DINO/
DINO_4scale_fast.py's variant); `--tiny` is a narrow model at 64x96 for
the CPU tests. Prints one JSON line {"metric", "value", "unit", ...} with
the MSDA kernel launches of the timed steps.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

C2F = "configs/DA/Cityscapes2FoggyCityscapes/DINO_4scale_C2F.py"
TINY = dict(num_classes=4, num_queries=12, hidden_dim=32, nheads=2,
            enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=2,
            dn_single_pad=2, dn_labelbook_size=4)
MAX_BOXES = 32


def c2f_config(args):
    from ..config import load_config

    cfg = load_config(C2F)
    if args.tiny:
        cfg.update(TINY)
    if args.amp:
        cfg["amp_dtype"] = "bfloat16"
    if args.no_remat:
        cfg["use_remat"] = False
    if args.points:
        cfg["enc_n_points"] = cfg["dec_n_points"] = args.points
    return cfg


def bench_batch(batch: int, canvas, device, self_training: bool) -> dict:
    """datr_tpu's bench batch: seeded uniform images without padding, the
    source half's targets 32 boxes (0.5, 0.5, 0.2, 0.2) of class 0; for
    self-training the strong views (the images again) and the target
    half's real sizes."""
    h, w = canvas
    half = batch // 2
    gen = torch.Generator().manual_seed(0)
    out = dict(
        images=torch.rand((batch, h, w, 3), generator=gen),
        pad_mask=torch.zeros((batch, h, w), dtype=torch.bool),
        boxes=torch.tensor([0.5, 0.5, 0.2, 0.2]).repeat(half, MAX_BOXES, 1),
        labels=torch.zeros((half, MAX_BOXES), dtype=torch.int64),
        valid=torch.ones((half, MAX_BOXES), dtype=torch.bool))
    if self_training:
        out["images_strong"] = out["images"].clone()
        out["real_sizes"] = torch.tensor([[float(h), float(w)]]).repeat(
            half, 1)
    return {k: v.to(device) for k, v in out.items()}


def build_step(args):
    """(one_step(), device) for the flags."""
    from ..models import build_model
    from ..train.optim import Optimizer
    from ..train.state import create_train_state
    from ..train.steps import train_step_burnin, train_step_self_training

    cfg = c2f_config(args)
    model, ccfg, wd = build_model(cfg, args.device, seed=0)
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    opt = Optimizer(model, lr=cfg.lr, lr_backbone=cfg.lr_backbone,
                    weight_decay=cfg.weight_decay,
                    clip_max_norm=cfg.clip_max_norm)
    state = create_train_state(model, opt, seed=0)
    canvas = (64, 96) if args.tiny else (800, 1344)
    batch = bench_batch(args.batch, canvas, dev, args.self_training)
    if args.self_training:
        thr = torch.full((cfg.num_classes,), 0.3, device=dev)
        return (lambda: train_step_self_training(
            state, batch, ccfg, wd, thr, canvas_hw=canvas)), dev, canvas
    return (lambda: train_step_burnin(state, batch, ccfg, wd)), dev, canvas


def seconds_per_step(step, n: int, device) -> float:
    """s per call of `step` over `n` calls after one untimed call: CUDA
    events on the card's current stream, else the host clock."""
    step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            step()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    return (time.perf_counter() - t0) / n


def get_args_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--self-training", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--points", type=int, default=0,
                    help="override enc/dec_n_points (the opt-in fast "
                         "variant, configs/DINO/DINO_4scale_fast.py)")
    ap.add_argument("--amp", action="store_true", help="bfloat16")
    ap.add_argument("--steps", type=int, default=3,
                    help="timed steps after the warm-up step")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true",
                    help="a narrow model at 64x96 (CPU tests)")
    return ap


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)
    from ..ops import msda

    step, dev, canvas = build_step(args)
    before = (msda.msda_fwd.launches, msda.msda_bwd.launches)
    s = seconds_per_step(step, args.steps, dev)
    result = {
        "metric": ("self_training_s_per_step" if args.self_training
                   else "burnin_s_per_step"),
        "value": s, "unit": "s/step", "batch": args.batch,
        "canvas": list(canvas), "remat": not args.no_remat,
        "amp": bool(args.amp), "steps": args.steps,
        "clock": "cuda_events" if dev.type == "cuda" else "host",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "msda_fwd_launches": msda.msda_fwd.launches - before[0],
        "msda_bwd_launches": msda.msda_bwd.launches - before[1]}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
