"""The training CLI (port of datr_tpu/main.py).

Config load + CLI overrides, model / criterion build, datasets, the burn-in
-> self-training epoch schedule, per-epoch evaluation of the student, the
EMA teacher and (after burn-in) the best-EMA model, the best-checkpoint
families keyed on AP50, auto-resume, and one JSON line per epoch in
`<output_dir>/log.txt`. It runs on the CUDA card unless `--device cpu` is
passed.

Across processes, as the reference's DDP runs: started by torchrun, each
process joins the process group from torchrun's environment
(`parallel/dist.py`: NCCL on `cuda:LOCAL_RANK`, gloo with `--device cpu`),
loads its shard of every epoch's batches and of the evaluation images,
and trains the student wrapped in DistributedDataParallel; `batch_size` is
per process. The evaluations merge every process's detections, so each
computes the global stats. Rank 0 alone writes checkpoints, the best
families, `log.txt`'s epoch lines and TensorBoard; rank i > 0 logs to
`log.txt.rank{i}`. `--resume` and auto-resume read a checkpoint of either
kind (`train/checkpoint.py`: one file, or a sharded directory).

Usage:
  python -m datr_torch.main -c configs/DA/Cityscapes2FoggyCityscapes/\\
DINO_4scale_C2F.py --data_root /data --output_dir runs/c2f \\
      [--options lr=2e-4 ...] [--eval [--ema]] [--test] [--resume path] \\
      [--synthetic] [--device cpu] [--amp] \\
      [--distill_teacher_ckpt ckpt [--distill_teacher_config cfg]]
  torchrun --nproc_per_node N -m datr_torch.main -c ... (one process per
      card; with --device cpu, N processes on gloo)

`--amp` (or `--options amp_dtype=bfloat16`) runs the model in bfloat16 with
f32 parameters, optimizer moments and EMA tracks, as datr_tpu's does;
`--options fast_norm=True` adds its fast bf16 norms. `--options masks=True
[mask_query_chunk=N]` trains the instance-mask head on a single-domain
layout (or `coco` / `coco_panoptic`) and adds mask AP to every evaluation.
`--distill_teacher_ckpt` (a port checkpoint) makes the self-training
epochs' pseudo-labels with that model, built from
`--distill_teacher_config` (any backbone, the student's classes), in place
of the EMA teacher. The model comes from the registry by the config's
`modelname` (`models.build_model`); `--options use_tensorboard=True`
mirrors each epoch's log.txt scalars to `<output_dir>/tb`.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import time

import numpy as np

from .config import apply_overrides, load_config
from .data.coco import DAPairedDataset, build_dataset
from .data.loader import make_da_loader, make_eval_loader, make_single_loader
from .data.synthetic import SyntheticDetectionDataset, synthetic_da_pair
from .data.transforms import (
    DATrainTransform,
    EvalTransform,
    SingleDomainTrainTransform,
)
from .engine import (
    evaluate,
    test,
    train_one_epoch,
    train_one_epoch_plain,
    train_one_epoch_self_training,
    update_emas_per_epoch,
)
from .models import build_model
from .parallel import dist as pdist
from .parallel.mesh import shard_train_state
from .train.checkpoint import (
    BestTracker,
    load_pretrain_params,
    load_resume,
    maybe_auto_resume,
    save_checkpoint,
    update_checkpoint_meta,
)
from .train.optim import Optimizer
from .train.state import EMA_TRACKS, create_train_state
from .utils.logger import setup_logger
from .utils.tb import ScalarWriter


def get_args_parser():
    p = argparse.ArgumentParser("DATR-torch trainer", add_help=False)
    p.add_argument("--config_file", "-c", required=True)
    p.add_argument("--options", nargs="+", default=[])
    p.add_argument("--data_root", default="data")
    p.add_argument("--output_dir", default="runs/exp")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--ema", action="store_true",
                   help="with --eval / --test: the use_ema ModelEma track "
                        "instead of the student")
    p.add_argument("--resume", default="")
    p.add_argument("--pretrain_model_path", default="")
    p.add_argument("--finetune_ignore", nargs="+", default=[],
                   help="parameter-name keywords NOT loaded from the "
                        "pretrain checkpoint")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (smoke runs)")
    p.add_argument("--save_results", action="store_true",
                   help="with --eval: dump each image's detections and GT "
                        "to <output_dir>/results.npz")
    p.add_argument("--debug", action="store_true",
                   help="stop each training epoch after 4 steps")
    p.add_argument("--dataset_file", default="",
                   help="override the config's dataset_file")
    p.add_argument("--note", default="",
                   help="free-text note recorded in config_args_all.json")
    p.add_argument("--num_workers", type=int, default=4,
                   help="host loader threads")
    p.add_argument("--start_epoch", type=int, default=0,
                   help="force the starting epoch")
    p.add_argument("--test", action="store_true",
                   help="dump COCO-format detections to results0.json")
    p.add_argument("--amp", action="store_true",
                   help="shorthand for amp_dtype='bfloat16'")
    # cross-architecture distillation: an external teacher in place of
    # the EMA teacher in self-training epochs
    p.add_argument("--distill_teacher_ckpt", default="",
                   help="checkpoint (whole state or a best family) whose "
                        "weights make the pseudo-labels in self-training "
                        "epochs")
    p.add_argument("--distill_teacher_config", default="",
                   help="the teacher's config (default: the training "
                        "config); set when its architecture differs")
    return p


def _refuse_unported(cfg):
    """The config keys whose parts are not ported raise here, before
    anything is built."""
    amp_dtype = cfg.get("amp_dtype", "float32")
    if amp_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"datr_torch does not port amp_dtype={amp_dtype!r} yet (float32 "
            "and bfloat16 are ported; float64: ROADMAP §A, "
            "amp_dtype=\"float64\")")


def _load_into_all(state, params):
    """The weights into the student and every EMA track (the tracks start
    from the loaded weights, reference main.py:292)."""
    for m in (state.model, *(getattr(state, n) for n in EMA_TRACKS)):
        m.load_state_dict(params)


def main(args):
    """The CLI's run. Under torchrun it starts the process group from the
    environment and ends it on the way out."""
    started = not pdist.is_initialized()
    dev = pdist.init_from_env(args.device)
    if dev is not None:
        args.device = str(dev)
    try:
        return _run(args)
    finally:
        if started:
            pdist.destroy()


def _run(args):
    rank, world = pdist.process_index(), pdist.process_count()
    is_main = rank == 0
    cfg = load_config(args.config_file)
    cfg = apply_overrides(cfg, args.options)
    if args.dataset_file:
        cfg["dataset_file"] = args.dataset_file
    if args.amp:
        cfg["amp_dtype"] = "bfloat16"
    _refuse_unported(cfg)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger(args.output_dir, process_index=rank)
    try:  # git sha for reproducibility
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ).stdout.strip()
        logger.info(f"git sha: {sha}")
    except Exception:
        pass
    logger.info(f"config: {json.dumps(dict(cfg), default=str)}")
    if world > 1:
        logger.info(f"process {rank} of {world} on {args.device}")
    if is_main:
        with open(os.path.join(args.output_dir, "config_args_all.json"),
                  "w") as f:
            json.dump({**dict(cfg), **vars(args)}, f, default=str, indent=1)

    model, ccfg, weight_dict = build_model(cfg, args.device, seed=args.seed)
    canvas_hw = (cfg.get("canvas_h", 800), cfg.get("canvas_w", 1344))
    max_boxes = cfg.get("max_boxes", 100)

    # --- the optional external distillation teacher (datr_tpu/main.py:
    # 149-185): its config is loaded verbatim, since --options target the
    # student's; its weights through the port's checkpoint format ---
    teacher = None
    if args.distill_teacher_ckpt:
        t_cfg = (load_config(args.distill_teacher_config)
                 if args.distill_teacher_config else cfg)
        teacher, _, _ = build_model(t_cfg, args.device, seed=args.seed)
        teacher.load_state_dict(load_pretrain_params(
            args.distill_teacher_ckpt, teacher))
        teacher.requires_grad_(False)
        logger.info(
            f"distillation teacher: {args.distill_teacher_ckpt} "
            f"({args.distill_teacher_config or 'training config'})")

    # --- datasets ---
    if args.synthetic:
        train_ds = synthetic_da_pair(
            n_images=cfg.get("synthetic_images", 16),
            num_classes=cfg.num_classes - 1,
        )
        val_ds = SyntheticDetectionDataset(
            8, num_classes=cfg.num_classes - 1, seed=1, fog=0.35)
        categories = val_ds.categories
    else:
        train_ds = build_dataset("train", cfg.dataset_file, args.data_root,
                                 cfg.get("strong_aug", True),
                                 return_masks=cfg.get("masks", False))
        # the val set decodes no masks per image: the segm evaluation reads
        # GT RLEs from eval_annotations(with_masks=True)
        val_ds = build_dataset("val", cfg.dataset_file, args.data_root)
        categories = val_ds.category_ids() or list(range(1, cfg.num_classes))

    single_domain = not isinstance(train_ds, DAPairedDataset) and not (
        args.synthetic)
    if single_domain:
        train_tf = SingleDomainTrainTransform(
            cfg.data_aug_scales, cfg.data_aug_max_size,
            cfg.data_aug_scales2_resize, cfg.data_aug_scales2_crop,
            strong_aug=cfg.get("strong_aug", False),
        )
    else:
        train_tf = DATrainTransform(
            cfg.data_aug_scales, cfg.data_aug_max_size,
            cfg.data_aug_scales2_resize, cfg.data_aug_scales2_crop,
        )
    eval_tf = EvalTransform(max(cfg.data_aug_scales), cfg.data_aug_max_size)

    # --- state ---
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"params: {n_params / 1e6:.2f}M")
    # optimizer updates per epoch: each process takes every world-th batch
    steps_per_epoch = max(len(train_ds) // cfg.batch_size // world, 1)
    lr_drop_step = (int(cfg.lr_drop) * steps_per_epoch
                    if cfg.get("lr_drop") else None)
    schedule_type = "step"
    if cfg.get("onecyclelr"):
        schedule_type = "onecycle"
    elif cfg.get("multi_step_lr"):
        schedule_type = "multistep"
    optimizer = Optimizer(
        model, lr=cfg.lr, lr_backbone=cfg.lr_backbone,
        weight_decay=cfg.weight_decay, clip_max_norm=cfg.clip_max_norm,
        lr_drop_step=lr_drop_step, schedule_type=schedule_type,
        lr_drop_steps=[e * steps_per_epoch
                       for e in cfg.get("lr_drop_list", [])],
        total_steps=cfg.epochs * steps_per_epoch,
    )
    # each data shard draws its own CDN noise: seed + its data coordinate
    # (the reference's seed + rank; ranks of one data shard draw alike)
    state = create_train_state(model, optimizer,
                               seed=args.seed + pdist.process_index())

    if args.pretrain_model_path:
        loaded = load_pretrain_params(args.pretrain_model_path, state.model)
        if args.finetune_ignore:
            old = state.model.state_dict()
            loaded = {k: old[k] if any(kw in k for kw in args.finetune_ignore)
                      else v for k, v in loaded.items()}
        _load_into_all(state, loaded)
        logger.info(f"loaded pretrain weights: {args.pretrain_model_path}")
    if args.resume:
        # an explicit --resume wins over auto-resume (reference
        # main.py:226-245)
        state, start_epoch, resume_meta = load_resume(args.resume, state)
        logger.info(f"resumed from {args.resume} (epoch {start_epoch})")
    else:
        state, start_epoch, resume_meta = maybe_auto_resume(
            args.output_dir, state)
    if args.start_epoch:
        start_epoch = args.start_epoch
    if world > 1 and state.step:
        # a restored state holds rank 0's CDN stream (rank 0 alone writes
        # it): each rank draws its own again, seeded by (seed + rank, step)
        state.dn_generator.manual_seed(int(np.random.SeedSequence(
            [args.seed + rank, state.step]).generate_state(1)[0]))
    if pdist.is_initialized():  # under torchrun: DDP, after every load
        shard_train_state(state)

    val_loader = make_eval_loader(val_ds, cfg.batch_size, canvas_hw, eval_tf,
                                  max_boxes, num_threads=args.num_workers,
                                  process_index=rank, process_count=world)
    nms_thr = float(cfg.get("nms_iou_threshold") or -1.0)
    # masks add the segm-AP evaluation; the synthetic sets carry no masks
    segm_eval = bool(cfg.get("masks")) and not args.synthetic

    if args.test:
        test(state.model_ema if args.ema else state.model, val_loader,
             args.output_dir, cfg.num_select, nms_iou_threshold=nms_thr,
             logger=logger)
        return
    if args.eval:
        stats = evaluate(
            state.model_ema if args.ema else state.model, val_loader,
            categories, cfg.num_select, nms_iou_threshold=nms_thr,
            logger=logger, segm=segm_eval,
            # each process dumps the images it evaluated
            save_results_path=os.path.join(
                args.output_dir,
                "results.npz" if is_main else f"results.rank{rank}.npz")
            if args.save_results else None)
        logger.info(json.dumps(stats))
        return stats

    best = BestTracker(args.output_dir, initial_best=resume_meta.get("best"),
                       write_enabled=is_main)
    burn_epochs = cfg.get("burn_epochs", cfg.epochs)
    thresholds = np.full((cfg.num_classes,),
                         cfg.get("pseudo_label_threshold", 0.3), np.float32)

    def eval_stats(m):
        return evaluate(m, val_loader, categories, cfg.num_select,
                        nms_iou_threshold=nms_thr, logger=logger,
                        segm=segm_eval)

    # the log.txt scalars mirrored to <output_dir>/tb (datr_tpu/main.py:
    # 350-355); a no-op where use_tensorboard is off or no backend imports
    tb = ScalarWriter(os.path.join(args.output_dir, "tb"),
                      enabled=is_main and bool(cfg.get("use_tensorboard")))
    shard = dict(process_index=rank, process_count=world)
    try:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            # at the lr drop, restart the student from the best EMA teacher
            # (reference main.py:321-327)
            if epoch == cfg.get("lr_drop") and epoch > start_epoch:
                best_teacher = os.path.join(args.output_dir,
                                            "best_ema_teacher")
                if os.path.exists(best_teacher):
                    state.model.load_state_dict(
                        load_pretrain_params(best_teacher, state.model))
                    logger.info("reloaded best_ema_teacher weights at lr_drop")
            if single_domain:
                loader = make_single_loader(
                    train_ds, cfg.batch_size, canvas_hw, train_tf, max_boxes,
                    seed=args.seed, epoch=epoch, num_threads=args.num_workers,
                    **shard)
            else:
                loader = make_da_loader(
                    train_ds, cfg.batch_size, canvas_hw, train_tf, max_boxes,
                    seed=args.seed, epoch=epoch, num_threads=args.num_workers,
                    # burn-in steps never read the strong views
                    compute_strong=(epoch >= burn_epochs), **shard)
            if world > 1:  # equal step counts: the ranks step together
                loader = itertools.islice(loader, steps_per_epoch)
            if args.debug:
                loader = itertools.islice(loader, 4)
            # the use_ema per-step ModelEma, from ema_epoch on
            ema_decay = float(cfg.get("ema_decay", 0.9997)) if (
                cfg.get("use_ema") and epoch >= int(cfg.get("ema_epoch", 0))
            ) else 0.0
            kw = dict(ema_decay=ema_decay, logger=logger, epoch=epoch)
            if single_domain:
                train_stats = train_one_epoch_plain(state, loader, ccfg,
                                                    weight_dict, **kw)
            elif epoch < burn_epochs:
                train_stats = train_one_epoch(state, loader, ccfg, weight_dict,
                                              **kw)
            else:
                train_stats = train_one_epoch_self_training(
                    state, loader, ccfg, weight_dict, thresholds, canvas_hw,
                    teacher=teacher, **kw)
            update_emas_per_epoch(state, epoch, cfg)

            if is_main:
                save_checkpoint(os.path.join(args.output_dir, "checkpoint"),
                                state, epoch, extra={"best": best.best})
            if is_main and cfg.get("save_checkpoint_interval", 1) and (
                    (epoch + 1) % cfg.save_checkpoint_interval == 0):
                save_checkpoint(
                    os.path.join(args.output_dir, f"checkpoint{epoch:04d}"),
                    state, epoch)

            # --- per-epoch eval: student + EMA teacher (+ best-EMA after
            # burn-in), best families keyed on AP50 (main.py:416-515) ---
            stats = eval_stats(state.model)
            best.update("checkpoint_best_regular", stats["ap50"], state.model,
                        epoch)
            t_stats = eval_stats(state.ema_teacher)
            best.update("best_ema_teacher", t_stats["ap50"], state.ema_teacher,
                        epoch)
            if cfg.get("use_ema"):
                # the fourth family: the use_ema ModelEma track
                e_stats = eval_stats(state.model_ema)
                best.update("checkpoint_best_ema", e_stats["ap50"],
                            state.model_ema, epoch)
            log_line = {
                "epoch": epoch,
                "lr": state.optimizer.lr_at(state.step),
                **{f"train_{k}": v for k, v in train_stats.items()},
                "ap50_student": stats["ap50"],
                "ap50_teacher": t_stats["ap50"],
                **({"ap50_ema": e_stats["ap50"]} if cfg.get("use_ema")
                   else {}),
                "time": time.time() - t0,
            }
            if epoch >= burn_epochs:
                b_stats = eval_stats(state.best_ema)
                best.update("best_ema_model", b_stats["ap50"], state.best_ema,
                            epoch)
                log_line["ap50_best_ema"] = b_stats["ap50"]
            if is_main:
                # the best families as they stand after this epoch's
                # evaluations, in the resumable checkpoint
                update_checkpoint_meta(
                    os.path.join(args.output_dir, "checkpoint"),
                    {"best": best.best})
                with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
                    f.write(json.dumps(log_line) + "\n")
                tb.write(epoch, log_line)
            logger.info(json.dumps(log_line))
    finally:
        tb.close()


def cli():
    """Console entry point, the same surface as `python -m
    datr_torch.main`."""
    parser = argparse.ArgumentParser("DATR-torch", parents=[get_args_parser()])
    main(parser.parse_args())


if __name__ == "__main__":
    cli()
