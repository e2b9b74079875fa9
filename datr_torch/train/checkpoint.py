"""Checkpoints in the port's own format, with the best-model families (port
of datr_tpu/train/checkpoint.py; reference main.py:395-412 per-epoch saves,
:425-515 the best families checkpoint_best_regular, checkpoint_best_ema,
best_ema_teacher, best_ema_model, auto-resume :226-245).

A checkpoint is one `torch.save` file plus `<path>.meta.json` (the epoch
and whatever the caller adds). The file holds either a whole TrainState
(model, optimizer, the three EMA tracks, prototype state, counters, the CDN
generator) or one model's state_dict (a best family). datr_tpu's orbax
checkpoints are not read here (the card's machine has no orbax):
`tools/orbax_to_torch.py`, run where JAX is installed, writes them in this
format. The file is written under a temporary name and renamed, then the
meta: a crash leaves either the old pair or the new checkpoint beside the
old meta. Across processes only rank 0 writes such a file.

A sharded checkpoint (`save_checkpoint_sharded`, datr_tpu/train/
checkpoint.py:87-115) is a torch.distributed.checkpoint directory: every
rank writes only its own shards of the student, the optimizer and the EMA
tracks (FSDP), rank 0 the whole tensors and the meta. It loads into any
layout (FSDP on other ranks, DDP, one process) and back, as datr_tpu's
restores across mesh layouts. `load_resume` and `maybe_auto_resume` read
both kinds.

Tensor parallelism (parallel/mesh.py `apply_tp`): a sharded checkpoint
gives torch.distributed.checkpoint each split tensor (parameter, AdamW
moment, EMA track) as a DTensor over the 'model' sub-mesh, its shard at
its place in the whole tensor, so the planner reshards on load: a
checkpoint saved on dp 2 x tp 2 restores on dp 1 x tp 4 or into one
process, as datr_tpu's "save on dp4xtp2, restore on dp2xtp4". The MHA's
[q; k; v] rows, split per chunk, are stored as [3, d, d] (and [3, d]) in
every sharded checkpoint. `save_checkpoint` of a split state gathers the
whole tensors over 'model' (every rank calls it) and rank 0 writes them;
`load_checkpoint` / `load_resume` cut whole tensors to a split state's
shards. A state both split and sharded by FSDP has no sharded checkpoint
here (NotImplementedError).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..convert import DA_HEADS
from ..parallel import dist as pdist
from ..parallel.mesh import chunk_view, shard_tensor, tp_plan, whole_tensor
from .state import EMA_TRACKS, TrainState


def _tp(module: nn.Module):
    """(plan, axis) of a module split over processes, else (None, None)."""
    plan, tp = getattr(module, "tp_plan", None), getattr(module, "tp", None)
    if plan and getattr(tp, "axis", None) and tp.size > 1:
        return plan, tp.axis
    return None, None


def _map_tp(sd: dict, plan, fn) -> dict:
    return {k: fn(v, plan[k]) if k in plan else v for k, v in sd.items()}


def _map_tp_opt(osd: dict, names, plan, fn) -> dict:
    """`fn` over the moments of the split parameters of an optimizer's
    state_dict (keyed by index)."""
    state = {i: {k: fn(v, plan[names[i]]) if names[i] in plan
                 and torch.is_tensor(v) and v.dim() else v
                 for k, v in st.items()} for i, st in osd["state"].items()}
    return {**osd, "state": state}


def _whole_sd(module: nn.Module, sd: dict) -> dict:
    plan, axis = _tp(module)
    if plan is None:
        return sd
    return _map_tp(sd, plan, lambda v, s: whole_tensor(v, s, axis))


def _local_sd(module: nn.Module, sd: dict) -> dict:
    """Whole tensors cut to `module`'s shards (a split module)."""
    plan, axis = _tp(module)
    if plan is None:
        return sd
    r, n = pdist.process_index(axis), pdist.process_count(axis)
    return _map_tp(sd, plan, lambda v, s: shard_tensor(v, s, r, n))


def _payload(obj: Union[TrainState, nn.Module, Dict[str, torch.Tensor]]):
    if isinstance(obj, TrainState):
        osd = obj.optimizer.opt.state_dict()
        plan, axis = _tp(obj.model)
        if plan is not None:
            osd = _map_tp_opt(osd, obj.optimizer.names, plan,
                              lambda v, s: whole_tensor(v, s, axis))
        return {
            "model": _whole_sd(obj.model, obj.model.state_dict()),
            "optimizer": osd,
            **{name: _whole_sd(getattr(obj, name),
                               getattr(obj, name).state_dict())
               for name in EMA_TRACKS},
            "global_proto": obj.global_proto,
            "amount": obj.amount,
            "step": obj.step,
            "ema_updates": obj.ema_updates,
            "dn_generator": obj.dn_generator.get_state(),
        }
    if isinstance(obj, nn.Module):
        return _whole_sd(obj, obj.state_dict())
    return dict(obj)


def _split(obj) -> bool:
    model = obj.model if isinstance(obj, TrainState) else obj
    return isinstance(model, nn.Module) and _tp(model)[0] is not None


def _is_state(payload) -> bool:
    return {"model", "optimizer"} <= set(payload)


def _read_meta(path: str) -> dict:
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            return json.load(f)
    return {}


def save_checkpoint(path: str, obj, epoch: int,
                    extra: Optional[dict] = None):
    """Save a TrainState, a module (its state_dict) or a state_dict at
    `path`, and `{"epoch": epoch, **extra}` at `path + '.meta.json'`. A
    tensor-parallel state or module is gathered whole over 'model' (every
    rank calls this) and rank 0 writes it."""
    path = os.path.abspath(path)
    payload = _payload(obj)
    if _split(obj) and not pdist.is_main():
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump({"epoch": epoch, **(extra or {})}, f)


def update_checkpoint_meta(path: str, extra: dict):
    """Merge `extra` into the meta of the checkpoint at `path` (main records
    the BestTracker's `best` there after the epoch's evaluations, so a
    resumed run keeps its best families; datr_tpu/train/checkpoint.py:
    123-138)."""
    path = os.path.abspath(path)
    meta = _read_meta(path)
    meta.update(extra)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def _stored(t: torch.Tensor, split, axis: Optional[str]):
    """A planned tensor as a sharded checkpoint stores it: chunked
    [chunks, n, ...] for the MHA's rows, and, for a split state, a DTensor
    of this rank's shard over the 'model' sub-mesh (sharing `t`'s
    storage: a load fills `t`)."""
    v = chunk_view(t, split) if split.chunks > 1 else t
    if axis is None:
        return v
    from torch.distributed.tensor import DTensor, Shard

    dim = split.dim + (split.chunks > 1)
    shape = list(v.shape)
    shape[dim] *= pdist.process_count(axis)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(v, pdist.current_mesh()[axis], [Shard(dim)],
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _unstored(v, like: torch.Tensor) -> torch.Tensor:
    v = v.to_local() if hasattr(v, "to_local") else v
    return v.reshape(like.shape)


def _dcp_payload(state: TrainState, chunked: bool):
    """The state as torch.distributed.checkpoint's state_dict functions
    lay it out: the student and its optimizer by parameter name, each EMA
    track, the prototype state and the counters; a split state's planned
    tensors, and with `chunked` the MHA's rows of any state, as `_stored`
    gives them. Returns (payload, the names so stored)."""
    from torch.distributed.checkpoint.state_dict import (
        get_model_state_dict,
        get_state_dict,
    )

    plan, axis = _tp(state.model)
    if plan is not None and (state.optimizer._sharded or not chunked):
        raise NotImplementedError(
            "sharded checkpoints of a tensor-parallel state sharded by "
            "FSDP, or saved without tensor parallelism into one")
    if plan is None:
        plan = {k: s for k, s in tp_plan(state.model, 1).items()
                if s.chunks > 1} if chunked else {}
        if plan and state.optimizer._sharded:
            raise NotImplementedError(
                "a tensor-parallel sharded checkpoint into an FSDP state")

    def stored(sd):
        return _map_tp(sd, plan, lambda v, s: _stored(v, s, axis))

    model_sd, optim_sd = get_state_dict(state.model, state.optimizer.opt)
    optim_sd = {**optim_sd, "state": {
        k: {n: _stored(v, plan[k], axis) if k in plan and torch.is_tensor(v)
            and v.dim() else v for n, v in st.items()}
        for k, st in optim_sd["state"].items()}}
    return {"model": stored(model_sd), "optimizer": optim_sd,
            **{n: stored(get_model_state_dict(getattr(state, n)))
               for n in EMA_TRACKS},
            "global_proto": state.global_proto, "amount": state.amount,
            "counters": torch.tensor([state.step, state.ema_updates]),
            "dn_generator": state.dn_generator.get_state()}, plan


def save_checkpoint_sharded(path: str, state: TrainState, epoch: int,
                            extra: Optional[dict] = None):
    """Save a state, sharded or whole, as a torch.distributed.checkpoint
    directory at `path` without gathering it: each rank writes its own
    shards (every rank calls this). Rank 0 writes `path + '.meta.json'`."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    dcp.save(_dcp_payload(state, _tp(state.model)[0] is not None)[0],
             checkpoint_id=path)
    if pdist.is_main():
        with open(path + ".meta.json", "w") as f:
            json.dump({"epoch": epoch, **(extra or {})}, f)
    pdist.barrier()


def load_checkpoint_sharded(path: str, state: TrainState
                            ) -> Tuple[TrainState, dict]:
    """Restore a sharded checkpoint into `state` in place, laid out as
    `state` is (its shards, or whole tensors in one process). Returns
    (state, meta)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import (
        set_model_state_dict,
        set_state_dict,
    )

    path = os.path.abspath(path)
    # a tensor-parallel run stored the MHA's rows chunked ([3, d, d])
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    chunked = any(k.startswith("model.") and k.endswith("in_proj_weight")
                  and len(getattr(v, "size", ())) == 3
                  for k, v in meta.items())
    payload, plan = _dcp_payload(state, chunked)
    dcp.load(payload, checkpoint_id=path)
    params = dict(state.model.named_parameters())

    def plain(sd):
        return {k: _unstored(v, params[k]) if k in plan else v
                for k, v in sd.items()}

    osd = payload["optimizer"]
    osd = {**osd, "state": {k: {n: _unstored(v, params[k]) if k in plan
                                and torch.is_tensor(v) and v.dim() else v
                                for n, v in st.items()}
                            for k, st in osd["state"].items()}}
    set_state_dict(state.model, state.optimizer.opt,
                   model_state_dict=plain(payload["model"]),
                   optim_state_dict=osd)
    for n in EMA_TRACKS:
        set_model_state_dict(getattr(state, n), plain(payload[n]))
    state.global_proto = payload["global_proto"]
    state.amount = payload["amount"]
    state.step, state.ema_updates = (int(v) for v in payload["counters"])
    state.dn_generator.set_state(payload["dn_generator"])
    return state, _read_meta(path)


def _restore_state(state: TrainState, payload) -> TrainState:
    state.model.load_state_dict(_local_sd(state.model, payload["model"]))
    osd = payload["optimizer"]
    plan, axis = _tp(state.model)
    if plan is not None:
        r, n = pdist.process_index(axis), pdist.process_count(axis)
        osd = _map_tp_opt(osd, state.optimizer.names, plan,
                          lambda v, s: shard_tensor(v, s, r, n))
    state.optimizer.opt.load_state_dict(osd)
    for name in EMA_TRACKS:
        m = getattr(state, name)
        m.load_state_dict(_local_sd(m, payload[name]))
    dev = state.global_proto.device
    state.global_proto = payload["global_proto"].to(dev)
    state.amount = payload["amount"].to(dev)
    state.step = int(payload["step"])
    state.ema_updates = int(payload["ema_updates"])
    state.dn_generator.set_state(payload["dn_generator"])
    return state


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, dict]:
    """Restore a whole-state checkpoint into `state` in place. Returns
    (state, meta)."""
    path = os.path.abspath(path)
    payload = _load(path)
    if not _is_state(payload):
        raise ValueError(f"{path} holds no training state (a best family?)")
    return _restore_state(state, payload), _read_meta(path)


def _pretrain_params(path: str, payload, model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    if _is_state(payload):
        payload = payload["model"]
    want = model.state_dict()
    plan, axis = _tp(model)
    if plan is not None:  # a split model: its tensors' whole shapes
        n = pdist.process_count(axis)
        for k, sp in plan.items():
            shape = list(want[k].shape)
            shape[sp.dim] *= n
            want[k] = want[k].new_empty(shape)
    # published eval checkpoints may lack the train-only DA heads (the
    # reference creates them only when training, dino.py:102-108): exactly
    # these come from the model's own init, everything else is checked
    missing = [k for k in want if k not in payload]
    filled = {k: want[k] for k in missing if k.split(".")[0] in DA_HEADS}
    unexpected = [k for k in payload if k not in want]
    if len(filled) != len(missing) or unexpected:
        raise ValueError(
            f"pretrain checkpoint at {path} does not fit the model: missing "
            f"{sorted(set(missing) - set(filled))}, unexpected {unexpected}")
    out = {}
    for k, t in want.items():
        r = filled[k] if k in filled else payload[k]
        # an exact shape: a transposed kernel of the right size must fail
        if tuple(r.shape) != tuple(t.shape):
            raise ValueError(
                f"pretrain checkpoint at {path}: {k} has shape "
                f"{tuple(r.shape)}, the model expects {tuple(t.shape)}")
        out[k] = r.to(t.dtype)
    return out


def load_pretrain_params(path: str, model: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """The state_dict of a pretrain checkpoint, whole-state or one model's
    (a best family), for `model` (datr_tpu/train/checkpoint.py:152-203):
    DA heads it lacks filled from `model`, every shape checked exactly.
    The caller loads it (`model.load_state_dict`)."""
    path = os.path.abspath(path)
    return _pretrain_params(path, _load(path), model)


def maybe_auto_resume(output_dir: str, state: TrainState
                      ) -> Tuple[TrainState, int, dict]:
    """Resume from `<output_dir>/checkpoint` if it exists (main.py:226-245).
    Returns (state, start_epoch, meta); meta carries the BestTracker's
    `best` so a resumed run keeps its best families."""
    path = os.path.join(output_dir, "checkpoint")
    if os.path.exists(path):
        load = (load_checkpoint_sharded if os.path.isdir(path)
                else load_checkpoint)
        state, meta = load(path, state)
        return state, int(meta.get("epoch", -1)) + 1, meta
    return state, 0, {}


def load_resume(path: str, state: TrainState
                ) -> Tuple[TrainState, int, dict]:
    """Explicit resume (main.py:226-245 args.resume). A whole-state
    checkpoint resumes training where it stopped. A params-only one (a best
    family, e.g. best_ema_teacher for --eval --ema) loads its weights into
    the model and every EMA track and does not advance the epoch: the
    reference sets start_epoch only when optimizer, schedule and epoch are
    all in the checkpoint (main.py:239-245); so does a sharded one (a
    directory). Returns (state, start_epoch, meta)."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        state, meta = load_checkpoint_sharded(path, state)
        return state, int(meta.get("epoch", -1)) + 1, meta
    meta = _read_meta(path)
    payload = _load(path)
    if _is_state(payload):
        return _restore_state(state, payload), int(
            meta.get("epoch", -1)) + 1, meta
    params = _pretrain_params(path, payload, state.model)
    for m in (state.model, *(getattr(state, n) for n in EMA_TRACKS)):
        m.load_state_dict(_local_sd(m, params))
    return state, 0, meta


class BestTracker:
    """The best AP50 of each family, saved on improvement (util/utils.py
    BestMetricHolder :398-470 + main.py's best families). `best` persists
    across restarts through the main checkpoint's meta (pass the resumed
    dict as `initial_best`). With `write_enabled=False` (a rank other than
    0) it tracks, so every rank agrees on what is best, and writes no
    file."""

    def __init__(self, output_dir: str, initial_best: Optional[dict] = None,
                 write_enabled: bool = True):
        self.output_dir = output_dir
        self.best: dict = dict(initial_best or {})
        self.write_enabled = write_enabled

    def update(self, family: str, ap50: float, tree, epoch: int) -> bool:
        """Save `tree` (a module or a state_dict) as `family` and log it to
        log_best.txt when `ap50` beats the family's best. Returns whether
        it did."""
        if not ap50 > self.best.get(family, -1.0):  # a NaN never improves
            return False
        self.best[family] = float(ap50)
        if not self.write_enabled:
            return True
        save_checkpoint(os.path.join(self.output_dir, family), tree, epoch,
                        {"ap50": float(ap50)})
        with open(os.path.join(self.output_dir, "log_best.txt"), "a") as f:
            f.write(json.dumps({"family": family, "epoch": epoch,
                                "ap50": float(ap50)}) + "\n")
        return True
