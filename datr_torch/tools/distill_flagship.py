"""Flagship-width distillation accuracy retention by epochs (port of
tools/distill_flagship.py).

The recipe of tests/test_e2e_distill.py at flagship width (hidden 256, 8
heads, ffn 2048, 6 + 6 layers, ResNet-50, bf16 + remat: the compute shape
of the C2F parity configuration) on a C2F-shaped synthetic domain pair (8
foreground classes, a fogged target domain), three runs of an equal
per-run epoch budget:
  teacher   the parity architecture (P = 4) trained with labels on the fog
            domain: the stand-in for a parity checkpoint the user has;
  distill   the fast architecture (P = 2): burn-in on clear-domain labels
            for half the budget, then the teacher's pseudo-labels on fog
            for the rest (the reference's burn_epochs schedule);
  scratch   the fast architecture on clear-domain labels only, the whole
            budget: what a user without distillation gets.
Each is evaluated on a held-out fog val set (engine.evaluate). Prints one
JSON line per stage (datr_tpu's keys, and each epoch's MSDA kernel
launches) and a final {"stage": "result", "retention": ...} line. On the
CUDA card unless `--device cpu`; `--tiny` is a hidden-32 model for the
CPU.

Reduced from the full C2F configuration, as the JAX tool is: 300 queries
(not 900), dn_number 20 (not 100), a 320x640 canvas (not 800x1344).

Usage (the card): python -m datr_torch.tools.distill_flagship
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .distill_retention import BURNIN_KEYS, FLAGSHIP, TINY, PhaseClock

K = 9  # 8 foreground classes + background slot, C2F-shaped
MAX_BOXES = 12
DN_PAD = 10


def _log(stage, **kw):
    rounded = {k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in kw.items()}
    print(json.dumps({"stage": stage, **rounded}), flush=True)


def get_args_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=20,
                    help="per-run epoch budget (teacher; students get the "
                         "same total, distill split half burn-in/half "
                         "self-training)")
    ap.add_argument("--teacher_epochs", type=int, default=0,
                    help="teacher epoch budget (0 = same as --epochs): it "
                         "stands in for a finished parity checkpoint, whose "
                         "training is not part of the migration measured")
    ap.add_argument("--n_train", type=int, default=96)
    ap.add_argument("--n_val", type=int, default=48)
    ap.add_argument("--batch", type=int, default=4,
                    help="images per domain per step")
    ap.add_argument("--canvas", type=int, nargs=2, default=(320, 640))
    ap.add_argument("--img_hw", type=int, nargs=2, default=(288, 576))
    ap.add_argument("--lr", type=float, default=1e-4,
                    help="the reference C2F lr (DINO_4scale_C2F.py)")
    ap.add_argument("--fog", type=float, default=0.55)
    ap.add_argument("--thr", type=float, default=0.45,
                    help="pseudo-label score threshold (reference default "
                         "0.3; tests/test_e2e_distill.py's rationale)")
    ap.add_argument("--probe", action="store_true",
                    help="a short run (2 epochs, 16 images) to time the "
                         "steps before the full budget")
    ap.add_argument("--skip_scratch", action="store_true")
    ap.add_argument("--teacher_only", action="store_true",
                    help="stop after the teacher eval (lr/budget probing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true",
                    help="hidden-32 architecture for CPU runs")
    return ap


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)
    if args.probe:
        args.epochs, args.n_train, args.n_val = 2, 16, 8

    from .. import resolve_device
    from ..data.coco import DAPairedDataset
    from ..data.loader import make_da_loader, make_eval_loader, to_device
    from ..data.synthetic import SyntheticDetectionDataset
    from ..data.transforms import DATrainTransform, EvalTransform
    from ..engine import evaluate
    from ..models.dino import DINO
    from ..train.criterion import CriterionCfg, build_weight_dict
    from ..train.optim import Optimizer
    from ..train.state import create_train_state
    from ..train.steps import train_step_burnin, train_step_self_training

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    arch = dict(TINY if args.tiny else FLAGSHIP, dn_number=20,
                dn_single_pad=DN_PAD)
    canvas = tuple(args.canvas)

    def flagship(points, seed):
        """The C2F parity compute shape (DINO_4scale_C2F.py) but for the
        reductions in the module docstring."""
        model = DINO(num_classes=K, dn_labelbook_size=K, enc_n_points=points,
                     dec_n_points=points, **arch)
        model.init_params(torch.Generator().manual_seed(seed))
        return model.to(dev)

    _log("setup", devices=[str(dev)], epochs=args.epochs,
         n_train=args.n_train, canvas=list(canvas))
    hw = tuple(args.img_hw)
    clear = SyntheticDetectionDataset(args.n_train, hw=hw, num_classes=K - 1,
                                      max_objects=6, seed=args.seed)
    fog = SyntheticDetectionDataset(args.n_train, hw=hw, num_classes=K - 1,
                                    max_objects=6, seed=args.seed + 1,
                                    fog=args.fog)
    val = SyntheticDetectionDataset(args.n_val, hw=hw, num_classes=K - 1,
                                    max_objects=6, seed=args.seed + 11,
                                    fog=args.fog)
    # aug scales bracket the native height so the resize and crop branches
    # are both live, as in the reference C2F transform
    short = hw[0]
    tf = DATrainTransform(
        scales=[int(short * 0.9), short, int(short * 1.1)],
        max_size=canvas[1],
        scales2_resize=[int(short * 0.8), short],
        scales2_crop=[int(short * 0.6), short],
    )
    ev_loader = make_eval_loader(val, 2, canvas,
                                 EvalTransform(short, canvas[1]),
                                 max_boxes=MAX_BOXES)
    ccfg = CriterionCfg(num_classes=K, dn_single_pad=DN_PAD, dn_groups=1)
    wd = build_weight_dict(dec_layers=arch["dec_layers"])

    def loader_for(ds):
        def go(epoch, seed):
            return make_da_loader(ds, args.batch, canvas, tf,
                                  max_boxes=MAX_BOXES, seed=seed,
                                  epoch=epoch, num_threads=4)
        return go

    def init_state(model, seed):
        opt = Optimizer(model, lr=args.lr, lr_backbone=args.lr / 10)
        return create_train_state(model, opt, seed=seed + 2)

    def run_burnin(state, loader, epochs, tag, ep0=0, seed=0):
        for ep in range(ep0, ep0 + epochs):
            clock, n, last = PhaseClock(dev), 0, None
            for batch in loader(ep, seed):
                last = train_step_burnin(state, to_device(batch, dev,
                                                          BURNIN_KEYS),
                                         ccfg, wd)
                n += 1
                clock.stepped(n)
            nan, rec = torch.tensor(float("nan")), clock.record(n)
            _log(tag, epoch=ep, steps=n, loss=float(last["loss"]),
                 ce=float(last.get("loss_ce", nan)),
                 cls_err=float(last.get("class_error", nan)),
                 giou=float(last.get("loss_giou", nan)), sec=rec["train_s"],
                 **{k: v for k, v in rec.items() if k.startswith("msda")})
        return state

    def eval_line(model, name):
        stats = evaluate(model.eval(), ev_loader, val.categories)
        _log("eval", arch=name, ap50=float(stats["ap50"]),
             ap=float(stats["coco_eval_bbox"][0]))
        return stats

    # ---- 1. parity-architecture teacher, fog-supervised ----
    t_loader = loader_for(DAPairedDataset(fog, fog, strong_aug=True))
    t0 = time.time()
    teacher = flagship(4, seed=args.seed)
    t_state = init_state(teacher, args.seed)
    _log("init", arch="teacher_p4", sec=round(time.time() - t0, 1),
         params=sum(p.numel() for p in teacher.parameters()))
    t_state = run_burnin(t_state, t_loader,
                         args.teacher_epochs or args.epochs, "teacher")
    ap_teacher = eval_line(teacher, "teacher_p4")
    if args.teacher_only:
        return {"teacher_ap50": float(ap_teacher["ap50"])}

    # ---- 2. the distilled fast-architecture student ----
    da_loader = loader_for(DAPairedDataset(clear, fog, strong_aug=True))
    d_state = run_burnin(init_state(flagship(2, args.seed + 10),
                                    args.seed + 10), da_loader,
                         args.epochs // 2, "distill_burnin", seed=1)
    thr = torch.full((K,), args.thr, dtype=torch.float32, device=dev)
    teacher.eval()
    pseudo_total = 0
    for ep in range(args.epochs // 2, args.epochs):
        clock, n, last = PhaseClock(dev), 0, None
        for batch in da_loader(ep, 1):
            last = train_step_self_training(
                d_state, to_device(batch, dev), ccfg, wd, thr,
                canvas_hw=canvas, num_select=100, max_pseudo=MAX_BOXES,
                teacher=teacher)
            n += 1
            clock.stepped(n)
        pseudo = int(last["num_pseudo"])
        pseudo_total += pseudo
        rec = clock.record(n)
        _log("distill_selftrain", epoch=ep, steps=n,
             loss=float(last["loss"]), last_step_pseudo=pseudo,
             sec=rec["train_s"],
             **{k: v for k, v in rec.items() if k.startswith("msda")})
    ap_distill = eval_line(d_state.model, "distilled_p2")

    # ---- 3. the equal-budget from-scratch fast-architecture baseline ----
    ap_scratch = {"ap50": float("nan")}
    if not args.skip_scratch:
        s_state = run_burnin(init_state(flagship(2, args.seed + 10),
                                        args.seed + 10), da_loader,
                             args.epochs, "scratch", seed=1)
        ap_scratch = eval_line(s_state.model, "scratch_p2")

    teacher_ap50 = float(ap_teacher["ap50"])
    out = dict(teacher_ap50=teacher_ap50,
               distilled_ap50=float(ap_distill["ap50"]),
               scratch_ap50=float(ap_scratch["ap50"]),
               retention=(float(ap_distill["ap50"]) / teacher_ap50
                          if teacher_ap50 > 0 else float("nan")),
               pseudo_last_steps=pseudo_total,
               width=("32/2h/64ffn/1+2/r50" if args.tiny else
                      "256/8h/2048ffn/6+6/r50-bf16-remat"),
               probe=bool(args.probe))
    _log("result", **out)
    return out


if __name__ == "__main__":
    main()
