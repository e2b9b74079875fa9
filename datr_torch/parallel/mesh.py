"""datr_tpu's device mesh (port of datr_tpu/parallel/mesh.py: `make_mesh`
:27, `_TP_RULES` :42, `param_sharding_tree` :103, `shard_train_state`
:126, `shard_batch` :169) over torch.distributed.

- `make_mesh(device_type, tp, sp)`: a DeviceMesh ('data', 'seq', 'model')
  laid out as datr_tpu's `reshape(n // (tp*sp), sp, tp)`: rank =
  d*sp*tp + s*tp + m (one axis, ('data',), with tp = sp = 1). It
  registers itself with parallel/dist.py, whose reductions of counts,
  sums and metrics then run over 'data' only.
- `tp_plan` / `_TP_RULES`: datr_tpu's Megatron rules over the port's
  parameter names (they mirror the flax tree): the FFNs' `linear1` and
  MSDA's `value_proj`, `sampling_offsets`, `attention_weights` split by
  output features (head-major: a contiguous split is a head split), the
  FFNs' `linear2` and MSDA's `output_proj` by input features, the decoder
  MHA's q / k / v per chunk of `in_proj_weight` and its `out_proj` by
  input features. The row-split layers' biases stay whole, added once
  after the reduction. A dim that tp does not divide stays whole
  (datr_tpu's guard, :113-118; the MHA's by its heads).
- `apply_tp`: the plan applied to a module: each split parameter replaced
  by this rank's shard, each TP layer given the axis's collectives
  (`dist.AxisComm`, or `LocalTP` for the replicas of one process).
- `shard_batch`: this rank's share of a global batch on the leading axis,
  by its data coordinate, in datr_tpu's order: data shard r holds
  datr_tpu's shard r. A paired DA batch ([source ; target]) is split per
  half, so each rank holds a paired batch.
- `shard_train_state`: the student and the three EMA tracks split by the
  plan over 'model'; then over 'data' DistributedDataParallel (gradients
  averaged over the data axis's ranks) or, with `fsdp`, `fully_shard` over
  the 'data' sub-mesh (ZeRO-3 of the local TP shards: parameters, their
  AdamW moments and the EMA tracks live sharded over 'data').

Sequence parallelism ('seq', models/dino.py `sp_axis`) and the pipeline
('pipe', parallel/pipeline.py) keep every parameter whole.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.layers import MSDeformAttn
from ..models.transformer import FFN, MultiheadAttention
from ..train.state import EMA_TRACKS, TrainState
from . import dist as pdist

# the keys of a paired batch whose leading axis holds [source ; target]
PAIRED_KEYS = ("images", "images_strong", "pad_mask")
MODEL_AXES = ("seq", "model", "pipe")


def make_mesh(device_type: str, tp: int = 1, sp: int = 1):
    """DeviceMesh ('data', 'seq', 'model') over every rank of the process
    group (('data',) when tp = sp = 1), of `device_type` ('cuda' or
    'cpu': where the model lives, whatever the backend; ranks sharing a
    card run gloo over CUDA tensors); registered as the ranks' mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    n = pdist.world_size()
    if n % (tp * sp):
        raise ValueError(f"{n} ranks not divisible by tp*sp={tp * sp}")
    if tp == sp == 1:
        mesh = init_device_mesh(device_type, (n,), mesh_dim_names=("data",))
    else:
        mesh = init_device_mesh(device_type, (n // (tp * sp), sp, tp),
                                mesh_dim_names=("data", "seq", "model"))
    pdist.set_mesh(mesh)
    return mesh


# --------------------------------------------------------- the TP plan


@dataclass(frozen=True)
class TPSplit:
    """A parameter split over 'model' along `dim`; with `chunks` > 1 each
    of that many equal blocks along `dim` is split alike (the MHA's
    [q; k; v] rows)."""
    dim: int
    chunks: int = 1


# (name pattern, TPSplit, by heads): a by-heads split stays whole unless
# tp divides its MHA's heads (datr_tpu splits their [in, heads, hd]
# kernels on the heads axis), the others unless tp divides the dim
_TP_RULES = [
    (re.compile(r"ffn\.linear1\.(weight|bias)$"), TPSplit(0), False),
    (re.compile(r"ffn\.linear2\.weight$"), TPSplit(1), False),
    (re.compile(r"attn\.(value_proj|sampling_offsets|attention_weights)"
                r"\.(weight|bias)$"), TPSplit(0), False),
    (re.compile(r"attn\.output_proj\.weight$"), TPSplit(1), False),
    (re.compile(r"(self_attn)\.in_proj_(weight|bias)$"), TPSplit(0, 3),
     True),
    (re.compile(r"(self_attn)\.out_proj\.weight$"), TPSplit(1), True),
]


def tp_plan(model: nn.Module, tp: int) -> Dict[str, TPSplit]:
    """The parameters of `model` that `tp` ranks split, by name (whole
    ones are absent). Read before `apply_tp` (it reads the whole
    shapes)."""
    plan = {}
    for name, p in model.named_parameters():
        for rx, split, by_heads in _TP_RULES:
            m = rx.search(name)
            if m is None or p.dim() != (2 if name.endswith("weight")
                                        else 1):
                continue
            if by_heads:
                owner = name[:m.start(1)] + m.group(1)
                n = model.get_submodule(owner).n_heads
            else:
                n = p.shape[split.dim] // split.chunks
            if n % tp == 0:
                plan[name] = split
            break
    return plan


def chunk_view(t: torch.Tensor, s: TPSplit) -> torch.Tensor:
    """`t` viewed with its `s.chunks` blocks along `s.dim` as an axis of
    their own (the MHA's [q; k; v] rows as [3, d, ...])."""
    d = s.dim
    return t.reshape(*t.shape[:d], s.chunks, t.shape[d] // s.chunks,
                     *t.shape[d + 1:])


def shard_tensor(t: torch.Tensor, s: TPSplit, rank: int, size: int
                 ) -> torch.Tensor:
    """Rank `rank`'s shard of the whole tensor `t` under split `s`."""
    c = chunk_view(t, s)
    n = c.shape[s.dim + 1] // size
    part = c.narrow(s.dim + 1, rank * n, n)
    return part.reshape(*t.shape[:s.dim], -1,
                        *t.shape[s.dim + 1:]).contiguous()


def unshard_tensor(parts: Sequence[torch.Tensor], s: TPSplit
                   ) -> torch.Tensor:
    """The whole tensor from its shards in rank order."""
    c = torch.cat([chunk_view(p, s) for p in parts], s.dim + 1)
    shape = list(parts[0].shape)
    shape[s.dim] *= len(parts)
    return c.reshape(shape)


def whole_tensor(t: torch.Tensor, s: TPSplit, axis: str = "model"
                 ) -> torch.Tensor:
    """The whole tensor of this rank's shard `t`, gathered over `axis`
    (every rank of it calls this)."""
    parts = [torch.empty_like(t) for _ in range(pdist.process_count(axis))]
    torch.distributed.all_gather(parts, t.contiguous(),
                                 group=pdist.axis_group(axis))
    return unshard_tensor(parts, s)


# the TP layers' parameters, each all split or all whole: a layer runs
# sharded only in full
_TP_LAYERS = {
    FFN: ("linear1.weight", "linear1.bias", "linear2.weight"),
    MSDeformAttn: tuple(f"{n}.{w}" for n in (
        "value_proj", "sampling_offsets", "attention_weights")
        for w in ("weight", "bias")) + ("output_proj.weight",),
    MultiheadAttention: ("in_proj_weight", "in_proj_bias",
                         "out_proj.weight"),
}


def apply_tp(model: nn.Module, comm, plan: Optional[Dict[str, TPSplit]]
             = None) -> nn.Module:
    """Split `model` by `plan` (default `tp_plan(model, comm.size)`) in
    place for rank `comm.rank` of `comm.size`: each split parameter's
    data becomes its shard (the Parameter objects stay), each TP layer
    computes its share and calls `comm` (`copy` at a column-split entry,
    `reduce` after a row-split exit). Records the plan as
    `model.tp_plan` and `comm` as `model.tp`. A layer whose parameters
    the plan splits only in part, or whose heads `comm.size` does not
    divide, raises ValueError."""
    if plan is None:
        plan = tp_plan(model, comm.size)
    for mname, mod in model.named_modules():
        names = _TP_LAYERS.get(type(mod))
        if names is None:
            continue
        full = [f"{mname}.{n}" if mname else n for n in names]
        split = [n in plan for n in full]
        if not any(split):
            continue
        heads = getattr(mod, "n_heads", comm.size)
        if not all(split) or heads % comm.size:
            raise ValueError(
                f"{mname}: tensor parallelism over {comm.size} ranks "
                f"splits {sum(split)} of its {len(split)} TP parameters "
                f"({heads} heads)")
        if hasattr(mod, "tp_size"):
            mod.tp_size = comm.size
        for n in names:
            if n.endswith(".weight") and "." in n:
                lin = mod.get_submodule(n.rsplit(".", 1)[0])
                lin.tp = comm
                lin.tp_mode = ("column" if plan[f"{mname}.{n}"].dim == 0
                               else "row")
        if isinstance(mod, MultiheadAttention):
            mod.tp = comm
    with torch.no_grad():
        for name, split in plan.items():
            p = model.get_parameter(name)
            p.data = shard_tensor(p.data, split, comm.rank, comm.size)
    model.tp_plan = dict(plan)
    model.tp = comm
    return model


class LocalTP:
    """Tensor parallelism among the `size` shards of one model in one
    process (a serving replica over several entries of `devices`): each
    shard runs in its own thread (`run_shards`), and `reduce` brings the
    shards' partial sums to the first shard's device, adds them there in
    rank order and hands each shard the sum on its own device. Inference
    only: `copy` is the identity."""

    _local = threading.local()

    def __init__(self, rank: int, size: int):
        self.rank, self.size = rank, size

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        hub = LocalTP._local.hub
        hub.parts[self.rank] = x
        hub.barrier.wait()
        if self.rank == 0:
            first = x.device
            total = hub.parts[0]
            for part in hub.parts[1:]:
                total = total + part.to(first)
            hub.total = total
        hub.barrier.wait()
        # the next reduce's first wait comes after every shard's read
        return hub.total.to(x.device)

    def __deepcopy__(self, memo):
        return self

    @staticmethod
    def run_shards(fns: Sequence) -> List:
        """Call `fns[r]()` for each shard r in a thread of its own, with
        one hub among them; returns their results in order. A shard that
        raises breaks the others' waits; its exception is raised here."""
        n = len(fns)
        hub = _Hub(n)
        results, errors = [None] * n, [None] * n

        def run(r):
            LocalTP._local.hub = hub
            try:
                results[r] = fns[r]()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[r] = e
                hub.barrier.abort()
            finally:
                LocalTP._local.hub = None

        threads = [threading.Thread(target=run, args=(r,),
                                    name=f"tp-shard-{r}")
                   for r in range(1, n)]
        for t in threads:
            t.start()
        run(0)
        for t in threads:
            t.join()
        first = next((e for e in errors
                      if not isinstance(e, threading.BrokenBarrierError)),
                     None) or next((e for e in errors if e), None)
        if first is not None:
            raise first
        return results


class _Hub:
    def __init__(self, n: int):
        self.parts = [None] * n
        self.total = None
        self.barrier = threading.Barrier(n)


def local_tp_shards(model: nn.Module, devices: Sequence) -> List[nn.Module]:
    """`model` split by the plan over len(devices) shards of one process,
    shard r a copy on devices[r] (entries may repeat one card)."""
    import copy

    size = len(devices)
    plan = tp_plan(model, size)
    shards = []
    for r, d in enumerate(devices):
        m = copy.deepcopy(model)
        apply_tp(m, LocalTP(r, size), plan)
        shards.append(m.to(d).eval())
    return shards


def shard_batch(batch: Dict, rank: Optional[int] = None,
                world: Optional[int] = None) -> Dict:
    """Rank `rank`'s contiguous share (by default this rank's data
    coordinate of the data axis's ranks) of every array (numpy or tensor)
    of a global batch, on the leading axis. A paired batch (images twice as
    many as the GT rows) is split per half: rank r holds
    [source share r ; target share r] and the GT of its source share."""
    rank = pdist.process_index() if rank is None else rank
    world = pdist.process_count() if world is None else world
    n_img = len(batch["images"])
    paired = "boxes" in batch and n_img == 2 * len(batch["boxes"])
    out = {}
    for k, v in batch.items():
        if k in PAIRED_KEYS and paired:
            half = n_img // 2
            lo, hi = pdist.rank_slice(half, rank, world)
            parts = (v[lo:hi], v[half + lo:half + hi])
            out[k] = (torch.cat(parts) if torch.is_tensor(v)
                      else np.concatenate(parts))
        elif hasattr(v, "shape") and len(v.shape) > 0:
            lo, hi = pdist.rank_slice(len(v), rank, world)
            out[k] = v[lo:hi]
        else:
            out[k] = v
    return out


def _has_model_axes() -> bool:
    return any(pdist.process_count(a) > 1 for a in MODEL_AXES)


def _shard_moments(optimizer, model: nn.Module, plan, comm):
    """AdamW moments taken before `apply_tp` cut to their parameters'
    shards."""
    names = {id(p): n for n, p in model.named_parameters()}
    for p, st in optimizer.opt.state.items():
        split = plan.get(names.get(id(p)))
        if split is None:
            continue
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() and v.shape != p.shape:
                st[k] = shard_tensor(v, split, comm.rank, comm.size)


def shard_train_state(state: TrainState, fsdp: bool = False) -> TrainState:
    """Place a TrainState on the registered mesh (`make_mesh`; without one
    the data axis is the world), in place; returns it.

    With a 'model' axis of more than one rank, the student and the EMA
    tracks are split by the plan (`apply_tp`), and any AdamW moments with
    them. Then, over 'data':
    - without `fsdp`: the student is wrapped in DistributedDataParallel on
      the data axis's group (`state.wrapped`), which the training steps
      call; parameters that get no gradient in a step (the DA heads of a
      single-domain step) are found each step. A mesh with model axes and
      one data rank has nothing to average and wraps nothing;
    - with `fsdp`: `fully_shard` over the student and each EMA track on
      the 'data' sub-mesh (the local TP shards sharded over 'data' only),
      the optimizer rebound to the sharded parameters, its moments (if
      any) sharded the same way.
    The prototype state stays whole on every rank."""
    mesh = pdist.current_mesh()
    tracks = (state.model, *(getattr(state, n) for n in EMA_TRACKS))
    if pdist.process_count("model") > 1:
        comm = pdist.AxisComm("model")
        plan = tp_plan(state.model, comm.size)
        for m in tracks:
            apply_tp(m, comm, plan)
        _shard_moments(state.optimizer, state.model, plan, comm)
        state.optimizer.rebind(state.model)
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        if mesh is None:
            mesh = make_mesh(state.global_proto.device.type)
        data = mesh["data"] if mesh.ndim > 1 else mesh
        for m in tracks:
            fully_shard(m, mesh=data)
        state.optimizer.rebind(state.model)
        state.wrapped = None
        return state
    if _has_model_axes() and pdist.process_count() == 1:
        state.wrapped = None
        return state
    from torch.nn.parallel import DistributedDataParallel

    state.wrapped = DistributedDataParallel(
        state.model, process_group=pdist.axis_group("data"),
        find_unused_parameters=True)
    return state


def local_bytes(module: torch.nn.Module) -> int:
    """Bytes of `module`'s parameters and buffers this rank holds (the
    local shard of a sharded one)."""
    n = 0
    for t in (*module.parameters(), *module.buffers()):
        t = t.to_local() if hasattr(t, "to_local") else t
        n += t.numel() * t.element_size()
    return n


def optimizer_local_bytes(optimizer) -> int:
    """Bytes of the AdamW moments this rank holds."""
    n = 0
    for st in optimizer.opt.state.values():
        for v in st.values():
            if torch.is_tensor(v) and v.dim() > 0:
                v = v.to_local() if hasattr(v, "to_local") else v
                n += v.numel() * v.element_size()
    return n
