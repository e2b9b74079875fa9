"""The ranks of the port's multi-process tests (tests/test_torch_port_dist*
.py, test_torch_port_gpu.py).

`spawn(tasks, world, tmp)` starts `world` processes by the spawn method;
each joins a gloo process group through a FileStore in `tmp` (no port to
pick), runs every task of `tasks` in order and saves each one's result to
`tmp/<task>.rank<r>.pt`. A task is (name, kwargs); "fn:case" runs TASKS
["fn"] and names its results "fn:case". A rank that raises fails the
spawn's `join`. This module and everything a rank imports are torch and
datr_torch only: no rank imports JAX.
"""

from __future__ import annotations

import contextlib
import os
import sys
from pathlib import Path

import numpy as np
import torch


def spawn(tasks, world: int, tmp):
    """Start the ranks; returns the ProcessContext (call `.join()`, which
    raises a rank's exception, until it returns True)."""
    import torch.multiprocessing as mp

    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "store").unlink(missing_ok=True)  # a FileStore starts empty
    return mp.start_processes(_entry, args=(world, str(tmp), tasks),
                              nprocs=world, join=False,
                              start_method="spawn")


def join(ctx):
    while not ctx.join():
        pass


def _file(tmp, task: str, rank: int) -> Path:
    return Path(tmp) / f"{task.replace(':', '_')}.rank{rank}.pt"


def results(tmp, task: str, world: int):
    return [torch.load(_file(tmp, task, r), weights_only=False)
            for r in range(world)]


def _threads(world: int):
    """A share of the xdist worker's cores (tests/torch_port_threads.py)."""
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_port_threads

    n = torch_port_threads.THREADS or max(1, (os.cpu_count() or 2) // 2)
    torch.set_num_threads(max(1, n // world))


def _entry(rank: int, world: int, tmp: str, tasks):
    import torch.distributed as dist

    from datr_torch.parallel import dist as pdist

    _threads(world)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    # the package's start-up path; gloo, which also carries the CUDA
    # tensors of ranks that share one card (NCCL refuses them)
    pdist.init_from_env("cpu", store=dist.FileStore(
        os.path.join(tmp, "store"), world))
    try:
        for name, kwargs in tasks:
            out = TASKS[name.split(":")[0]](rank, world, **kwargs)
            torch.save(out, _file(tmp, name, rank))
            dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- tasks


def _patch_stages(stages):
    from datr_torch.models import dino as tdino

    if stages is not None:
        tdino.RESNET_STAGES["resnet50"] = tuple(stages)


def _state(kw, sd, lr, lr_backbone, device="cpu"):
    from datr_torch.models.dino import DINO
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state

    model = DINO(**kw)
    model.load_state_dict(sd)
    model.to(device)
    return create_train_state(model, Optimizer(model, lr=lr,
                                               lr_backbone=lr_backbone))


def _full(t: torch.Tensor, name=None, module=None) -> torch.Tensor:
    """The whole tensor (gathered if sharded by FSDP, and over 'model' if
    `module` splits `name` by tensor parallelism), on the CPU."""
    t = (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()
    split = getattr(module, "tp_plan", {}).get(name)
    if split is not None:
        from datr_torch.parallel.mesh import whole_tensor

        t = whole_tensor(t, split, module.tp.axis)
    return t.cpu().clone()


def _grab_grads(state):
    """Wrap the optimizer's step to keep the gradients it is given (the
    ranks' mean, pre-clip)."""
    seen = {}
    step = state.optimizer.step
    names = {id(p): n for n, p in state.model.named_parameters()}

    def grab(i):
        seen.update({names[id(p)]: _full(p.grad, names[id(p)], state.model)
                     for p in state.optimizer.params if p.grad is not None})
        return step(i)

    state.optimizer.step = grab
    return seen


def _snapshot(state):
    from datr_torch.train.state import EMA_TRACKS

    def whole(m):
        return {k: _full(v, k, m) for k, v in m.state_dict().items()}

    return {"model": whole(state.model),
            **{n: whole(getattr(state, n)) for n in EMA_TRACKS},
            "global_proto": state.global_proto.cpu().clone(),
            "amount": state.amount.cpu().clone()}


@contextlib.contextmanager
def _record_matches():
    """Record the matcher's assignments of every call in the block."""
    from datr_torch.train import criterion as crit

    seen, match = [], crit.match_many

    def rec(*a, **kw):
        out = match(*a, **kw)
        seen.append([o.detach().cpu().clone() for o in out])
        return out

    crit.match_many = rec
    try:
        yield seen
    finally:
        crit.match_many = match


def _draws(draws, rank, world, device="cpu"):
    from datr_torch.models.cdn import CdnDraws
    from datr_torch.parallel.dist import rank_slice

    lo, hi = rank_slice(len(draws[0]), rank, world)
    return CdnDraws(*(d[lo:hi].to(device) for d in draws))


def steps(rank, world, stages, kw, sd, batch, ccfg, wd, burnin_draws,
          st_draws, thr, canvas, lr, lr_backbone, fsdp=False, device="cpu",
          tp=1, sp=1):
    """A burn-in and a self-training step, each from the given weights, on
    this rank's data share of the global batch, the student in DDP (or
    sharded by FSDP), on a mesh of `tp` x `sp` model ranks when either is
    above 1 (the model's `sp_axis` then 'seq'): the metrics, the whole
    gradients the optimizer was given, the whole state after each step,
    the matcher's assignments, the MSDA kernels' launches (forward,
    backward; 0 on the CPU), and for FSDP the bytes each rank holds."""
    from datr_torch.parallel import dist as pdist
    from datr_torch.parallel.mesh import (
        local_bytes,
        make_mesh,
        optimizer_local_bytes,
        shard_batch,
        shard_train_state,
    )
    from datr_torch.ops import msda
    from datr_torch.train.criterion import CriterionCfg
    from datr_torch.train.steps import (
        train_step_burnin,
        train_step_self_training,
    )

    _patch_stages(stages)
    if torch.device(device).type == "cuda":  # f32, as the one process's
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if tp * sp > 1:
        make_mesh(torch.device(device).type, tp=tp, sp=sp)
        kw = dict(kw, sp_axis="seq" if sp > 1 else "")
    d_rank, d_world = pdist.process_index(), pdist.process_count()
    ccfg = CriterionCfg(**ccfg)
    mine = {k: v.to(device) for k, v in shard_batch(batch, d_rank,
                                                    d_world).items()}
    out = {}
    runs = [("burnin", lambda s: train_step_burnin(
        s, mine, ccfg, wd,
        dn_draws=_draws(burnin_draws, d_rank, d_world, device)))]
    if st_draws is not None:
        runs.append(("self_training", lambda s: train_step_self_training(
            s, mine, ccfg, wd, thr.to(device), canvas,
            dn_draws=_draws(st_draws, d_rank, d_world, device))))
    for name, run in runs:
        state = _state(kw, sd, lr, lr_backbone, device)
        if world > 1:
            shard_train_state(state, fsdp=fsdp)
        grads = _grab_grads(state)
        msda.msda_fwd.launches = msda.msda_bwd.launches = 0
        with _record_matches() as matches:
            metrics = {k: v.item() for k, v in run(state).items()}
        out[name] = dict(metrics=metrics, grads=grads, matches=matches,
                         after=_snapshot(state),
                         launches=(msda.msda_fwd.launches,
                                   msda.msda_bwd.launches))
        if fsdp:
            out[name]["bytes"] = dict(
                model=local_bytes(state.model),
                ema_teacher=local_bytes(state.ema_teacher),
                moments=optimizer_local_bytes(state.optimizer),
                leaves={n: (p.to_local().numel(), p.numel())
                        for n, p in state.model.named_parameters()})
    return out


def eval_dataset(spec):
    """("coco", root, dataset_file) -> the val split of a COCO tree (raw
    GT annotations); ("synthetic", kwargs) -> a SyntheticDetectionDataset
    (GT only in the batches)."""
    if spec[0] == "coco":
        from datr_torch.data.coco import build_dataset

        ds = build_dataset("val", spec[2], spec[1])
        return ds, ds.category_ids()
    from datr_torch.data.synthetic import SyntheticDetectionDataset

    ds = SyntheticDetectionDataset(**spec[1])
    return ds, ds.categories


def evaluate(rank, world, stages, kw, sd, dataset, batch_size, canvas,
             eval_max, max_boxes, num_select, segm, nms, tp=1):
    """engine.evaluate on this rank's data shard of the val set (the model
    split over `tp` ranks when tp > 1)."""
    from datr_torch.data.loader import make_eval_loader
    from datr_torch.data.transforms import EvalTransform
    from datr_torch.engine import evaluate as run
    from datr_torch.models.dino import DINO
    from datr_torch.parallel import dist as pdist
    from datr_torch.parallel.mesh import apply_tp, make_mesh

    _patch_stages(stages)
    model = DINO(**kw).eval()
    model.load_state_dict(sd)
    if tp > 1:
        make_mesh("cpu", tp=tp)
        apply_tp(model, pdist.AxisComm("model"))
    ds, cats = eval_dataset(dataset)
    loader = make_eval_loader(ds, batch_size, canvas,
                              EvalTransform(*eval_max), max_boxes,
                              num_threads=1,
                              process_index=pdist.process_index(),
                              process_count=pdist.process_count())
    stats = run(model, loader, cats, num_select, nms_iou_threshold=nms,
                segm=segm)
    return {k: np.asarray(v) for k, v in stats.items()}


def dcp(rank, world, stages, kw, sd, lr, lr_backbone, load_from, save_to,
        batch, ccfg, wd, draws):
    """Shard a state whose optimizer holds moments (whether they follow
    their parameters' shards), load a sharded checkpoint written by one
    process into it (the state as loaded, gathered), take one step, save
    the sharded state for one process to load (the state as saved), and
    load that into fresh DDP ranks (the state as loaded there)."""
    from datr_torch.parallel.mesh import shard_batch, shard_train_state
    from datr_torch.train.checkpoint import (
        load_checkpoint_sharded,
        save_checkpoint_sharded,
    )
    from datr_torch.train.criterion import CriterionCfg
    from datr_torch.train.steps import train_step_burnin

    _patch_stages(stages)
    # moments taken before sharding follow their parameters' shards
    state = _state(kw, sd, lr, lr_backbone)
    g = torch.Generator().manual_seed(11)
    before = {}
    for n, p in state.model.named_parameters():
        if p.requires_grad:
            st = {"step": torch.tensor(3.0),
                  "exp_avg": torch.randn(p.shape, generator=g),
                  "exp_avg_sq": torch.rand(p.shape, generator=g)}
            state.optimizer.opt.state[p] = st
            before[n] = st
    shard_train_state(state, fsdp=True)
    after = _opt_snapshot(state)["moments"]
    rebound = all(torch.equal(after[n][k], before[n][k]) for n in before
                  for k in ("exp_avg", "exp_avg_sq")) and after.keys() == \
        before.keys()
    state, meta = load_checkpoint_sharded(load_from, state)
    loaded = _opt_snapshot(state)
    loaded.update(_snapshot(state), step=state.step, meta=meta)
    train_step_burnin(state, shard_batch(batch, rank, world),
                      CriterionCfg(**ccfg), wd,
                      dn_draws=_draws(draws, rank, world))
    save_checkpoint_sharded(save_to, state, 5, extra={"ranks": world})
    saved = _opt_snapshot(state)
    saved.update(_snapshot(state), step=state.step)
    ddp = shard_train_state(_state(kw, sd, lr, lr_backbone))
    ddp, _ = load_checkpoint_sharded(save_to, ddp)
    ddp_loaded = _opt_snapshot(ddp)
    ddp_loaded.update(_snapshot(ddp), step=ddp.step)
    return dict(loaded=loaded, saved=saved, ddp_loaded=ddp_loaded,
                rebound=rebound)


def _opt_snapshot(state):
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {"moments": {names[id(p)]: {
        k: _full(v, names[id(p)], state.model) for k, v in st.items()
        if torch.is_tensor(v) and v.dim()}
        for p, st in state.optimizer.opt.state.items()}}


def tp_ckpt(rank, world, stages, kw, sd, lr, lr_backbone, batch, ccfg, wd,
            draws, save_to):
    """On dp 2 x tp 2: one burn-in step, its sharded save and its whole
    save (the state as saved, gathered); then on dp 1 x tp 4, a fresh
    state loading the sharded save (the state as loaded, gathered)."""
    from datr_torch.parallel import dist as pdist
    from datr_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_train_state,
    )
    from datr_torch.train.checkpoint import (
        load_checkpoint_sharded,
        save_checkpoint,
        save_checkpoint_sharded,
    )
    from datr_torch.train.criterion import CriterionCfg
    from datr_torch.train.steps import train_step_burnin

    _patch_stages(stages)
    make_mesh("cpu", tp=2)
    state = shard_train_state(_state(kw, sd, lr, lr_backbone))
    d, n = pdist.process_index(), pdist.process_count()
    train_step_burnin(state, shard_batch(batch, d, n), CriterionCfg(**ccfg),
                      wd, dn_draws=_draws(draws, d, n))
    save_checkpoint_sharded(save_to, state, 5, extra={"mesh": "dp2xtp2"})
    save_checkpoint(save_to + ".pt", state, 5)
    saved = _opt_snapshot(state)
    saved.update(_snapshot(state), step=state.step)
    make_mesh("cpu", tp=4)
    fresh = shard_train_state(_state(kw, sd, lr, lr_backbone))
    fresh, meta = load_checkpoint_sharded(save_to, fresh)
    loaded = _opt_snapshot(fresh)
    loaded.update(_snapshot(fresh), step=fresh.step, meta=meta)
    return dict(saved=saved, loaded=loaded)


def tp_fsdp_ckpt(rank, world, stages, kw, sd, lr, lr_backbone, batch, ccfg,
                 wd, draws, save_to, tp_ddp):
    """Sharded checkpoints across the layouts of 4 ranks, each of a state
    after one burn-in step (the state as saved, gathered): dp 2 x tp 2
    with FSDP ("tp_fsdp"), and dp 4 with FSDP and no TP ("fsdp": the
    global batch's 2 source images do not split over 4 data ranks, so it
    is the dp 2 x tp 2 DDP checkpoint `tp_ddp` of `tp_ckpt`, loaded).
    Then "tp_fsdp" loaded on dp 1 x tp 4, and each of the three loaded on
    dp 2 x tp 2 with FSDP (the states as loaded). Last, a fresh dp 4 FSDP
    state saved before any step, resumed on dp 2 x tp 2 with FSDP and
    stepped: its metrics, gradients (rank 0) and state after the step.
    The states are returned as `_digest`s."""
    from datr_torch.parallel import dist as pdist
    from datr_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_train_state,
    )
    from datr_torch.train.checkpoint import (
        load_checkpoint_sharded,
        load_resume,
        save_checkpoint_sharded,
    )
    from datr_torch.train.criterion import CriterionCfg
    from datr_torch.train.steps import train_step_burnin

    _patch_stages(stages)

    def fresh(fsdp):
        return shard_train_state(_state(kw, sd, lr, lr_backbone), fsdp=fsdp)

    def step(state):
        d, n = pdist.process_index(), pdist.process_count()
        return train_step_burnin(state, shard_batch(batch, d, n),
                                 CriterionCfg(**ccfg), wd,
                                 dn_draws=_draws(draws, d, n))

    def snap(state, **extra):
        out = _opt_snapshot(state)
        out.update(_snapshot(state), step=state.step, **extra)
        return _digest(out)

    saved, loaded = {}, {}
    paths = {"tp_fsdp": f"{save_to}/tp_fsdp", "tp_ddp": tp_ddp,
             "fsdp": f"{save_to}/fsdp"}
    make_mesh("cpu", tp=2)
    state = fresh(True)
    step(state)
    save_checkpoint_sharded(paths["tp_fsdp"], state, 5,
                            extra={"kind": "tp_fsdp"})
    saved["tp_fsdp"] = snap(state)
    make_mesh("cpu")
    state, _ = load_checkpoint_sharded(tp_ddp, fresh(True))
    save_checkpoint_sharded(paths["fsdp"], state, 5, extra={"kind": "fsdp"})
    saved["fsdp"] = snap(state)
    save_checkpoint_sharded(f"{save_to}/fresh", fresh(True), 0)
    make_mesh("cpu", tp=4)
    state, meta = load_checkpoint_sharded(paths["tp_fsdp"], fresh(False))
    loaded["tp_fsdp->tp4"] = snap(state, meta=meta)
    make_mesh("cpu", tp=2)
    for name, path in paths.items():
        state, meta = load_checkpoint_sharded(path, fresh(True))
        loaded[f"{name}->tp_fsdp"] = snap(state, meta=meta)
    state, epoch, _ = load_resume(f"{save_to}/fresh", fresh(True))
    grads = _grab_grads(state)
    metrics = {k: v.item() for k, v in step(state).items()}
    return dict(saved=saved, loaded=loaded, resumed=dict(
        epoch=epoch, metrics=metrics, grads=grads if rank == 0 else None,
        after=_digest(_snapshot(state))))


def _digest(tree):
    """`tree` with each tensor replaced by (dtype, shape, SHA-256 of its
    bytes): bitwise comparisons of whole states without writing them."""
    import hashlib

    if isinstance(tree, dict):
        return {k: _digest(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        t = tree.detach().cpu().contiguous()
        return (str(t.dtype), tuple(t.shape), hashlib.sha256(
            t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        ).hexdigest())
    return tree


def _toy_stage(p, shared, x, aux):
    # datr_tpu's tests/test_pipeline.py toy layer
    return x + torch.tanh(x @ p["w"] + p["b"]) + aux


def gpipe_cases(rank, world, cases, stacked, x, aux):
    """`gpipe` of the toy stage for each (stages, n_micro, dp) on a mesh
    ('data', 'pipe') of world // stages x stages: with dp the data rows
    take their share of x (dp_axis 'data'), else each row all of it. The
    output and the gradients of sum(out^2) for the stacked w, b (summed
    over 'data', as a data-parallel step sums them) and for this rank's
    x."""
    from datr_torch.parallel import dist as pdist
    from datr_torch.parallel.pipeline import gpipe, make_pipe_mesh

    out = {}
    for stages, n_micro, dp in cases:
        mesh = make_pipe_mesh("cpu", stages)
        d, n = pdist.process_index(), pdist.process_count()
        lo, hi = pdist.rank_slice(len(x), d, n) if dp else (0, len(x))
        p = {k: v.clone().requires_grad_() for k, v in stacked.items()}
        xl = x[lo:hi].clone().requires_grad_()
        y = gpipe(_toy_stage, p, (), xl, aux[lo:hi], mesh=mesh,
                  n_micro=n_micro, dp_axis="data")
        gw, gb, gx = torch.autograd.grad((y ** 2).sum(), [p["w"], p["b"],
                                                          xl])
        if dp:
            gw, gb = (pdist.all_reduce_sum(g) for g in (gw, gb))
        out[(stages, n_micro, dp)] = dict(out=y.detach(), rows=(lo, hi),
                                          grads=(gw, gb, gx))
    return out


def pp_model(rank, world, stages, kw, sd, batch, ccfg, wd, draws, lr,
             lr_backbone):
    """The pipelined encoder (2 stages, 2 microbatches) on a mesh ('data',
    'pipe') of 2 x 2: the eval forward of the whole batch's images and
    the gradients of sum(pred_logits^2) by parameter name (each data row
    all the images), and the same through the sequential encoder; then one burn-in step on this data row's share
    (`pp_dp_axis` 'data', DDP over 'data'): metrics and gradients."""
    from datr_torch.models.dino import DINO
    from datr_torch.parallel import dist as pdist
    from datr_torch.parallel.mesh import shard_batch, shard_train_state
    from datr_torch.parallel.pipeline import (
        make_pipe_mesh,
        make_pp_encoder_fn,
    )
    from datr_torch.train.criterion import CriterionCfg
    from datr_torch.train.steps import train_step_burnin

    _patch_stages(stages)
    mesh = make_pipe_mesh("cpu", 2)
    model = DINO(**kw).eval()
    model.load_state_dict(sd)
    enc = make_pp_encoder_fn(model, mesh=mesh, n_micro=2, dp_axis="data")

    def logits2(fn):
        model.zero_grad()
        out = model(batch["images"], batch["pad_mask"], encoder_fn=fn)
        (out["pred_logits"] ** 2).sum().backward()
        return ({k: out[k].detach() for k in ("pred_logits", "pred_boxes",
                                              "topk_idx")},
                {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None})

    seq_fwd, seq_grads = logits2(None)
    fwd, grads_fwd = logits2(enc)
    refused = None
    enc_drop = make_pp_encoder_fn(model, mesh=mesh, n_micro=2,
                                  dp_axis="data", dropout=0.1)
    try:
        enc_drop(None, None, None, None, None, deterministic=False)
    except NotImplementedError as e:
        refused = str(e)
    d, n = pdist.process_index(), pdist.process_count()
    steps = {}
    for name, pp in (("sequential", {}), ("pipelined", dict(
            pp_mesh=mesh, pp_n_micro=2, pp_dp_axis="data"))):
        state = shard_train_state(_state(kw, sd, lr, lr_backbone))
        grads = _grab_grads(state)
        metrics = train_step_burnin(
            state, shard_batch(batch, d, n), CriterionCfg(**ccfg), wd,
            dn_draws=_draws(draws, d, n), **pp)
        steps[name] = dict(metrics={k: v.item() for k, v in metrics.items()},
                           grads=grads, after=_snapshot(state))
    return dict(forward=fwd, grads=grads_fwd, refused=refused,
                seq_fwd=seq_fwd, seq_grads=seq_grads, steps=steps)


def sp_forward(rank, world, stages, kw, sd, images, pad_mask):
    """The eval forward with sp_axis 'seq' over `world` ranks."""
    from datr_torch.models.dino import DINO
    from datr_torch.parallel.mesh import make_mesh

    _patch_stages(stages)
    make_mesh("cpu", sp=world)
    model = DINO(**kw, sp_axis="seq").eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model(images, pad_mask)
    return {k: out[k] for k in ("pred_logits", "pred_boxes",
                                "interm_logits", "topk_idx")}


def cli(rank, world, stages, argv):
    """datr_torch.main.main under this process group. Returns the state of
    the CDN generator as the training starts (after any resume)."""
    from unittest import mock

    from datr_torch import main as tmain

    _patch_stages(stages)
    seen, shard = {}, tmain.shard_train_state

    def record(state, *a, **kw):
        seen["dn_generator"] = state.dn_generator.get_state().clone()
        return shard(state, *a, **kw)

    with mock.patch.object(tmain, "shard_train_state", record):
        tmain.main(tmain.get_args_parser().parse_args(argv))
    return seen


TASKS = {"steps": steps, "evaluate": evaluate, "dcp": dcp, "cli": cli,
         "tp_ckpt": tp_ckpt, "tp_fsdp_ckpt": tp_fsdp_ckpt,
         "gpipe_cases": gpipe_cases,
         "pp_model": pp_model, "sp_forward": sp_forward}
