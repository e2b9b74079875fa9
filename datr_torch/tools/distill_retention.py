"""Flagship-width distillation accuracy retention (port of tools/
distill_retention.py).

The opt-in fast configuration (configs/DINO/DINO_4scale_fast.py: 2
sampling points a level instead of 4) is not checkpoint-compatible with the
parity architecture; its migration path is distillation, an external
4-point teacher labelling the target domain while the 2-point student
trains (`train.steps.train_step_self_training(teacher=...)`). This tool
measures the AP50 the student keeps at flagship width (hidden 256, 8
heads, 6 + 6 layers, ResNet-50, bf16 + remat) on a C2F-shaped synthetic
domain pair (8 foreground classes, a fogged target domain).

Phases, in one process, on the CUDA card unless `--device cpu`:
  1. teacher: the parity architecture (P = 4), supervised on the fog
     domain (the stand-in for a finished parity checkpoint), then its
     fog-val AP50;
  2. student: the fast architecture (P = 2), burn-in on clear labels for
     half the steps, then the teacher's pseudo-labels on fog for the rest
     (the reference's burn_epochs schedule), then its fog-val AP50;
  3. (--scratch) the fast architecture from scratch on clear labels for
     the whole budget.

Prints one JSON line per phase (datr_tpu's keys, and each training phase's
MSDA kernel launches and s/step by the device's clock) and a final
{"retention": ap_student / ap_teacher, ...} line. The criterion's DN
groups are the JAX tool's (5 at flagship width, 1 with --tiny).

Usage (the card): python -m datr_torch.tools.distill_retention --steps 1500
CPU smoke:        python -m datr_torch.tools.distill_retention --device cpu \\
                      --tiny --steps 40
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import torch

# the flagship DINO-R50 4-scale architecture (configs/DINO/DINO_4scale.py),
# bf16 + remat as it trains on the card; --tiny: hidden 32 for the CPU
FLAGSHIP = dict(num_queries=300, hidden_dim=256, nheads=8, enc_layers=6,
                dec_layers=6, dim_feedforward=2048, dn_number=100,
                dn_single_pad=10, use_remat=True, dtype=torch.bfloat16)
TINY = dict(num_queries=16, hidden_dim=32, nheads=2, enc_layers=1,
            dec_layers=2, dim_feedforward=64, dn_number=4, dn_single_pad=4,
            use_remat=False)
# the keys a burn-in step reads (the strong views are self-training's)
BURNIN_KEYS = ("images", "pad_mask", "boxes", "labels", "valid")


def log(**kw):
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in kw.items()}), flush=True)


def get_args_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1500,
                    help="teacher train steps; the student gets the same "
                         "total budget (half burn-in, half self-training)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--canvas", type=int, nargs=2, default=(320, 640))
    ap.add_argument("--hw", type=int, nargs=2, default=(256, 512),
                    help="synthetic source-image size")
    ap.add_argument("--classes", type=int, default=8,
                    help="foreground classes (9-class C2F shape with bg)")
    ap.add_argument("--images", type=int, default=64,
                    help="per-domain train images")
    ap.add_argument("--val_images", type=int, default=32)
    ap.add_argument("--fog", type=float, default=0.55)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--threshold", type=float, default=0.45,
                    help="pseudo-label score threshold (reference default "
                         "0.3; tests/test_e2e_distill.py's rationale)")
    ap.add_argument("--max_objects", type=int, default=6)
    ap.add_argument("--scratch", action="store_true",
                    help="also run the from-scratch fast baseline")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true",
                    help="hidden-32 architecture for CPU smoke runs")
    return ap


class PhaseClock:
    """Wall time of a training phase and its MSDA kernel launches; the
    steps after the first timed by CUDA events on the card (the host's
    clock elsewhere)."""

    def __init__(self, device: torch.device):
        from ..ops import msda

        self.msda, self.cuda = msda, device.type == "cuda"
        self.t0 = time.perf_counter()
        self.launches0 = (msda.msda_fwd.launches, msda.msda_bwd.launches)
        self.first_s, self.start, self.host0 = None, None, None

    def stepped(self, done: int):
        if done == 1:  # the first step compiles and allocates
            if self.cuda:
                torch.cuda.synchronize()
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record()
            self.host0 = time.perf_counter()
            self.first_s = self.host0 - self.t0

    def record(self, done: int) -> dict:
        if done == 0:
            rest = 0.0
        elif self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            rest = self.start.elapsed_time(end) / 1e3
        else:
            rest = time.perf_counter() - self.host0
        m = self.msda
        return dict(train_s=round(time.perf_counter() - self.t0, 1),
                    first_step_s=self.first_s,
                    step_s=rest / (done - 1) if done > 1 else None,
                    clock="cuda_events" if self.cuda else "host",
                    msda_fwd_launches=m.msda_fwd.launches - self.launches0[0],
                    msda_bwd_launches=m.msda_bwd.launches - self.launches0[1])


def setup(args, device: torch.device) -> SimpleNamespace:
    """What the phases share, from the flags: `make_model(points, seed)`,
    `init_state(model, seed)`, `loader(dataset, epoch, seed)` (paired
    batches on the host), the datasets (`clear`, `fog`, `val`), the
    eval loader, the criterion's config and weights."""
    from ..data.loader import make_da_loader, make_eval_loader
    from ..data.synthetic import SyntheticDetectionDataset
    from ..data.transforms import DATrainTransform, EvalTransform
    from ..models.dino import DINO
    from ..train.criterion import CriterionCfg, build_weight_dict
    from ..train.optim import Optimizer
    from ..train.state import create_train_state

    K = args.classes + 1
    canvas, hw = tuple(args.canvas), tuple(args.hw)
    arch = TINY if args.tiny else FLAGSHIP

    def make_model(points, seed):
        model = DINO(num_classes=K, dn_labelbook_size=K, enc_n_points=points,
                     dec_n_points=points, **arch)
        model.init_params(torch.Generator().manual_seed(seed))
        return model.to(device)

    def init_state(model, seed):
        opt = Optimizer(model, lr=args.lr, lr_backbone=args.lr / 10)
        return create_train_state(model, opt, seed=seed + 2)

    max_boxes = max(args.max_objects + 2, 8)
    data = {name: SyntheticDetectionDataset(
        n, hw=hw, num_classes=args.classes, max_objects=args.max_objects,
        seed=seed, fog=fog) for name, n, seed, fog in (
            ("clear", args.images, 0, 0.0), ("fog", args.images, 1, args.fog),
            ("val", args.val_images, 11, args.fog))}
    short = int(min(hw) * 0.9)
    tf = DATrainTransform(
        scales=[int(short * 0.85), short], max_size=max(canvas),
        scales2_resize=[int(short * 0.7), int(short * 0.85)],
        scales2_crop=[int(short * 0.6), int(short * 0.9)],
    )

    def loader(ds, epoch, seed):
        return make_da_loader(ds, args.batch, canvas, tf,
                              max_boxes=max_boxes, seed=seed, epoch=epoch,
                              num_threads=4)

    return SimpleNamespace(
        K=K, canvas=canvas, max_boxes=max_boxes, make_model=make_model,
        init_state=init_state, loader=loader, **data,
        ev_loader=make_eval_loader(data["val"], args.batch, canvas,
                                   EvalTransform(short, max(canvas)),
                                   max_boxes=max_boxes),
        ccfg=CriterionCfg(num_classes=K, dn_single_pad=arch["dn_single_pad"],
                          dn_groups=1 if args.tiny else 5),
        wd=build_weight_dict(dec_layers=arch["dec_layers"]))


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)

    from .. import resolve_device
    from ..data.coco import DAPairedDataset
    from ..data.loader import to_device
    from ..engine import evaluate
    from ..ops import msda
    from ..train.steps import train_step_burnin, train_step_self_training

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ns = setup(args, dev)
    K, canvas, max_boxes, ccfg, wd = (ns.K, ns.canvas, ns.max_boxes, ns.ccfg,
                                      ns.wd)
    loader, make_model, init_state = ns.loader, ns.make_model, ns.init_state

    def ap50(model) -> dict:
        """AP50 on the fog val set and the forward's kernel launches."""
        before = msda.msda_fwd.launches
        stats = evaluate(model.eval(), ns.ev_loader, ns.val.categories)
        return dict(ap50=float(stats["ap50"]),
                    msda_fwd_launches=msda.msda_fwd.launches - before)

    def run_burnin(state, ds, steps, seed, tag):
        clock, done, epoch, m = PhaseClock(dev), 0, 0, None
        t0 = time.time()
        while done < steps:
            for batch in loader(ds, epoch, seed):
                m = train_step_burnin(state, to_device(batch, dev,
                                                       BURNIN_KEYS),
                                      ccfg, wd)
                done += 1
                clock.stepped(done)
                if done % 100 == 0:
                    log(phase=tag, step=done, loss=float(m["loss"]),
                        sec_per_step=(time.time() - t0) / done)
                if done >= steps:
                    break
            epoch += 1
        log(phase=tag, steps=done, loss=float(m["loss"]) if m else None,
            **clock.record(done))
        return state

    # ---- 1. teacher: parity architecture, fog-supervised ----
    fogfog = DAPairedDataset(ns.fog, ns.fog, strong_aug=True)
    teacher = make_model(4, seed=0)
    run_burnin(init_state(teacher, seed=0), fogfog, args.steps, 0, "teacher")
    ev = ap50(teacher)
    ap_teacher = ev["ap50"]
    log(phase="teacher_eval", **ev)

    # ---- 2. student: fast architecture, burn-in on clear, then distilled
    # on fog ----
    da = DAPairedDataset(ns.clear, ns.fog, strong_aug=True)
    d_state = run_burnin(init_state(make_model(2, seed=10), seed=10), da,
                         args.steps // 2, 1, "student_burnin")
    thr = torch.full((K,), args.threshold, dtype=torch.float32, device=dev)
    teacher.eval()
    clock, done, epoch, n_pseudo, m = PhaseClock(dev), 0, 0, 0, None
    t0 = time.time()
    budget = args.steps - args.steps // 2
    while done < budget:
        for batch in loader(da, 1000 + epoch, 1):
            m = train_step_self_training(
                d_state, to_device(batch, dev), ccfg, wd, thr,
                canvas_hw=canvas, num_select=100, max_pseudo=max_boxes,
                teacher=teacher)
            done += 1
            clock.stepped(done)
            n_pseudo += int(m["num_pseudo"])
            if done % 100 == 0:
                log(phase="student_distill", step=done,
                    loss=float(m["loss"]), pseudo=n_pseudo,
                    sec_per_step=(time.time() - t0) / done)
            if done >= budget:
                break
        epoch += 1
    log(phase="student_distill", steps=done, pseudo=n_pseudo,
        loss=float(m["loss"]) if m else None, **clock.record(done))
    ev = ap50(d_state.model)
    ap_student = ev["ap50"]
    log(phase="student_eval", **ev)

    ap_scratch = None
    if args.scratch:
        s_state = run_burnin(init_state(make_model(2, seed=10), seed=10), da,
                             args.steps, 1, "scratch")
        ev = ap50(s_state.model)
        ap_scratch = ev["ap50"]
        log(phase="scratch_eval", **ev)

    out = {
        "retention": ap_student / max(1e-9, ap_teacher),
        "ap50_teacher": ap_teacher,
        "ap50_student": ap_student,
        "steps": args.steps, "canvas": list(canvas),
        "classes": args.classes, "fog": args.fog,
        "arch": "tiny" if args.tiny else "flagship-256/8h/6+6/R50",
        "pseudo_total": n_pseudo,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }
    if ap_scratch is not None:
        out["ap50_scratch"] = ap_scratch
    log(**out)
    return out


if __name__ == "__main__":
    main()
