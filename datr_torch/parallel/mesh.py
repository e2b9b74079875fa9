"""The data axis of datr_tpu's device mesh (port of datr_tpu/parallel/
mesh.py: `make_mesh` :27, `shard_train_state` :126, `shard_batch` :169)
over torch.distributed.

- `make_mesh`: a one-dimensional DeviceMesh ('data',) over the ranks of
  the process group.
- `shard_batch`: this rank's share of a global batch on the leading axis,
  in datr_tpu's order: rank r holds datr_tpu's shard r. A paired DA batch
  ([source ; target]) is split per half, so each rank holds a paired batch.
- `shard_train_state`: without `fsdp` the student is wrapped in
  DistributedDataParallel (the reference's main.py path; gradients averaged
  over the ranks, every rank holds every tensor). With `fsdp` the student
  and the three EMA tracks are sharded by `fully_shard` (ZeRO-3: parameters,
  their AdamW moments and the EMA tracks live sharded over 'data'; the
  forward all-gathers, the backward reduce-scatters).

datr_tpu's 'seq' and 'model' axes (tensor and sequence parallelism,
`_TP_RULES`, `param_sharding_tree`'s TP specs) are not in this module.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..train.state import EMA_TRACKS, TrainState
from . import dist as pdist

# the keys of a paired batch whose leading axis holds [source ; target]
PAIRED_KEYS = ("images", "images_strong", "pad_mask")


def make_mesh(device_type: str):
    """DeviceMesh('data',) over every rank of the process group, of
    `device_type` ('cuda' or 'cpu': where the model lives, whatever the
    backend; two ranks sharing a card run gloo over CUDA tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (pdist.process_count(),),
                            mesh_dim_names=("data",))


def shard_batch(batch: Dict, rank: Optional[int] = None,
                world: Optional[int] = None) -> Dict:
    """Rank `rank`'s contiguous share of every array (numpy or tensor) of
    a global batch, on the leading axis. A paired batch (images twice as
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


def shard_train_state(state: TrainState, fsdp: bool = False) -> TrainState:
    """Place a TrainState on the data axis, in place; returns it.

    Without `fsdp`: the student is wrapped in DistributedDataParallel
    (`state.wrapped`), which the training steps call. Parameters that get
    no gradient in a step (the DA heads of a single-domain step) are found
    each step (`find_unused_parameters`).

    With `fsdp`: `fully_shard` over the student and each EMA track on
    the data axis of the model's device type, and the optimizer rebound
    to the sharded parameters, its moments (if any) sharded the same way.
    The prototype state stays whole on every rank."""
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        mesh = make_mesh(state.global_proto.device.type)
        for m in (state.model, *(getattr(state, n) for n in EMA_TRACKS)):
            fully_shard(m, mesh=mesh)
        state.optimizer.rebind(state.model)
        state.wrapped = None
        return state
    from torch.nn.parallel import DistributedDataParallel

    state.wrapped = DistributedDataParallel(state.model,
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
