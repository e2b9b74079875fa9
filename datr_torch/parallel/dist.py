"""The process group of data-parallel runs (port of datr_tpu's
`jax.distributed.initialize`, datr_tpu/main.py:108-116, `jax.process_index`
/ `process_count` and `multihost_utils.process_allgather`,
datr_tpu/engine.py:383, 448; reference util/misc.py init_distributed_mode).

`init_from_env` reads torchrun's variables (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and starts the default process
group: NCCL on CUDA, gloo on the CPU, or the backend the caller names (two
ranks sharing one card run gloo over CUDA tensors). A rank's device is
`cuda:LOCAL_RANK`. Without `WORLD_SIZE` in the environment nothing starts:
one process, no group, and every helper here answers as for one process.

A failed collective raises; nothing here carries on with one process.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    return process_index() == 0


def data_parallel() -> bool:
    """True inside a process group of more than one rank: the criterion's
    box count, the class prototypes, the clip's norm and the logged
    metrics are then reduced across ranks."""
    return process_count() > 1


def init_from_env(device=None, backend: Optional[str] = None,
                  store: Optional[dist.Store] = None
                  ) -> Optional[torch.device]:
    """Start the default process group from torchrun's environment. Returns
    this rank's device (`cuda:LOCAL_RANK` for `device=None` or a CUDA
    device, else `device`), or None without `WORLD_SIZE` (one process; the
    caller keeps its own device). The backend is NCCL for CUDA and gloo for
    the CPU unless `backend` names one. The ranks meet at `MASTER_ADDR:
    MASTER_PORT`, or in `store` where the caller gives one (a FileStore:
    no port to pick)."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not is_initialized():
        if store is None:
            addr = os.environ.get("MASTER_ADDR", "localhost")
            port = os.environ.get("MASTER_PORT", "29500")
            meet = dict(init_method=f"tcp://{addr}:{port}")
        else:
            meet = dict(store=store)
        dist.init_process_group(backend, rank=rank, world_size=world,
                                device_id=dev if backend == "nccl" else None,
                                **meet)
    return dev


def destroy():
    if is_initialized():
        dist.destroy_process_group()


def barrier():
    if is_initialized():
        dist.barrier()


def _collective_device() -> torch.device:
    """Where a collective's buffers live: the current card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_numpy(arrays):
    """`process_allgather` of fixed-shape arrays: each array (or each of a
    tuple of them) stacked over the ranks, [P, ...], rank order. One
    process: each gains a leading axis of 1. The shapes must agree across
    ranks."""
    single = not isinstance(arrays, (tuple, list))
    items = (arrays,) if single else tuple(arrays)
    out = []
    for a in items:
        a = np.asarray(a)
        if not is_initialized():
            out.append(a[None].copy())
            continue
        wire = a.view(np.uint8) if a.dtype == bool else a
        t = torch.from_numpy(np.ascontiguousarray(wire)).to(
            _collective_device())
        parts = [torch.empty_like(t) for _ in range(process_count())]
        dist.all_gather(parts, t)
        g = torch.stack(parts).cpu().numpy()
        out.append(g.view(bool) if a.dtype == bool else g)
    return out[0] if single else tuple(out)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `t` (a new tensor; `t` itself with one
    process). No gradient flows through it."""
    if not data_parallel():
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t


def all_reduce_sum_autograd(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks, differentiable: its backward sums each
    rank's incoming gradient (torch.distributed.nn's all_reduce)."""
    if not data_parallel():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def reduce_metrics(metrics: dict, sums: Sequence[str] = ("num_pseudo",)
                   ) -> dict:
    """A step's 0-d metric tensors as global values (the reference's
    reduce_dict): the mean over the ranks, the sum for `sums` (counts).
    One all-reduce for the whole dict."""
    if not data_parallel():
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float32).reshape(())
                        for k in keys])
    dist.all_reduce(flat)
    n = process_count()
    return {k: flat[i] if k in sums else flat[i] / n
            for i, k in enumerate(keys)}


def rank_slice(n: int, rank: Optional[int] = None,
               world: Optional[int] = None) -> Tuple[int, int]:
    """[lo, hi) of rank's contiguous share of `n` rows (n % world == 0)."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    per = n // world
    return rank * per, (rank + 1) * per
