"""The process group and the mesh axes (port of datr_tpu's
`jax.distributed.initialize`, datr_tpu/main.py:108-116, `jax.process_index`
/ `process_count` and `multihost_utils.process_allgather`,
datr_tpu/engine.py:383, 448, and of the collectives XLA places for
datr_tpu's mesh axes; reference util/misc.py init_distributed_mode).

`init_from_env` reads torchrun's variables (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and starts the default process
group: NCCL on CUDA, gloo on the CPU, or the backend the caller names (two
ranks sharing one card run gloo over CUDA tensors). A rank's device is
`cuda:LOCAL_RANK`. Without `WORLD_SIZE` in the environment nothing starts:
one process, no group, and every helper here answers as for one process.

A mesh (parallel/mesh.py `make_mesh`, parallel/pipeline.py
`make_pipe_mesh`) registers its axes here (`set_mesh`). 'data' holds ranks
with different data; 'model', 'seq' and 'pipe' hold ranks with the same
data. `process_index` / `process_count` and the reductions of counts,
sums and metrics take an axis, by default 'data': without a mesh the data
axis is the world and every other axis has one rank: a run without a
mesh is plain data parallelism over every rank.

The model axes' collectives are autograd Functions in conjugate pairs, as
Megatron writes them: `copy_to` (identity; all-reduce of the gradient) and
`reduce_from` (all-reduce; identity backward) for tensor parallelism,
`split` (this rank's rows; all-gather of the gradient), `gather_sum`
(all-gather; all-reduce of the gradient and this rank's rows) and
`gather_replicated` (all-gather; this rank's rows of the gradient) for
sequence parallelism, `ring_permute` (from the previous rank; the
gradient to it) for the pipeline. Every rank downstream of a
`reduce_from` / `gather_replicated` holds the same gradient, so neither
reduces it again. Every collective is one that gloo has for CUDA tensors:
all_reduce and all_gather (`ring_permute` is an all-gather and a pick;
`gather_sum`'s backward an all-reduce and a slice).

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


_MESH = None  # the DeviceMesh whose axes name the groups, or None


def set_mesh(mesh):
    """Register `mesh` (a DeviceMesh with named axes, or None) as the one
    whose axes the helpers below read."""
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


def _has_axis(axis: str) -> bool:
    return _MESH is not None and axis in (_MESH.mesh_dim_names or ())


def axis_group(axis: str = "data"):
    """The process group of mesh axis `axis` for this rank: the mesh's,
    the world for 'data' without a mesh, else None (an axis of one
    rank)."""
    if _has_axis(axis):
        return _MESH.get_group(axis)
    if axis == "data" and is_initialized():
        return dist.group.WORLD
    return None


def global_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index(axis: str = "data") -> int:
    """This rank's coordinate along `axis` (the data axis: the process
    index of datr_tpu's data shards)."""
    if _has_axis(axis):
        return _MESH.get_local_rank(axis)
    return global_rank() if axis == "data" else 0


def process_count(axis: str = "data") -> int:
    """The ranks along `axis`."""
    if _has_axis(axis):
        return _MESH.size(_MESH.mesh_dim_names.index(axis))
    return world_size() if axis == "data" else 1


def is_main() -> bool:
    """Rank 0 of the whole group (it writes the files)."""
    return global_rank() == 0


def data_parallel() -> bool:
    """True with more than one rank on the data axis: the criterion's box
    count, the class prototypes, the clip's norm and the logged metrics
    are then reduced across its ranks."""
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


def all_gather_numpy(arrays, axis: str = "data"):
    """`process_allgather` of fixed-shape arrays over the ranks of `axis`:
    each array (or each of a tuple of them) stacked over them, [P, ...],
    in their order. One rank: each gains a leading axis of 1. The shapes
    must agree across ranks."""
    single = not isinstance(arrays, (tuple, list))
    items = (arrays,) if single else tuple(arrays)
    out = []
    for a in items:
        a = np.asarray(a)
        if process_count(axis) == 1:
            out.append(a[None].copy())
            continue
        wire = a.view(np.uint8) if a.dtype == bool else a
        t = torch.from_numpy(np.ascontiguousarray(wire)).to(
            _collective_device())
        parts = [torch.empty_like(t) for _ in range(process_count(axis))]
        dist.all_gather(parts, t, group=axis_group(axis))
        g = torch.stack(parts).cpu().numpy()
        out.append(g.view(bool) if a.dtype == bool else g)
    return out[0] if single else tuple(out)


def all_reduce_sum(t: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The sum over the ranks of `axis` of `t` (a new tensor; `t` itself
    with one rank). No gradient flows through it."""
    if process_count(axis) == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, group=axis_group(axis))
    return t


def all_reduce_sum_autograd(t: torch.Tensor, axis: str = "data"
                            ) -> torch.Tensor:
    """The sum over the ranks of `axis`, differentiable: its backward sums
    each rank's incoming gradient (torch.distributed.nn's all_reduce)."""
    if process_count(axis) == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=axis_group(axis))


def reduce_metrics(metrics: dict, sums: Sequence[str] = ("num_pseudo",),
                   axis: str = "data") -> dict:
    """A step's 0-d metric tensors as global values (the reference's
    reduce_dict): the mean over the ranks of `axis`, the sum for `sums`
    (counts). One all-reduce for the whole dict."""
    if process_count(axis) == 1:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float32).reshape(())
                        for k in keys])
    dist.all_reduce(flat, group=axis_group(axis))
    n = process_count(axis)
    return {k: flat[i] if k in sums else flat[i] / n
            for i, k in enumerate(keys)}


def rank_slice(n: int, rank: Optional[int] = None,
               world: Optional[int] = None) -> Tuple[int, int]:
    """[lo, hi) of rank's contiguous share of `n` rows (n % world == 0);
    by default this rank's data coordinate among the data axis's ranks."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    per = n // world
    return rank * per, (rank + 1) * per


# ------------------------------------------------ the model axes' collectives


def _all_gather_cat(x: torch.Tensor, dim: int, sizes: Sequence[int],
                    group) -> torch.Tensor:
    """The ranks' `x` (rank i's of length sizes[i] along `dim`)
    concatenated along `dim`: all_gather needs equal sizes, so each part is
    padded to the largest and trimmed after."""
    n = max(sizes)
    if x.shape[dim] < n:
        pad = list(x.shape)
        pad[dim] = n - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(parts, x, group=group)
    return torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, sizes)],
                     dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes, rank, group):
        ctx.args = (dim, sizes, group)
        return x.narrow(dim, sum(sizes[:rank]), sizes[rank]).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, sizes, group = ctx.args
        return _all_gather_cat(g, dim, sizes, group), None, None, None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes, rank, group):
        ctx.args = (dim, sizes, rank, group)
        return _all_gather_cat(x, dim, sizes, group)

    @staticmethod
    def backward(ctx, g):
        dim, sizes, rank, group = ctx.args
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return (g.narrow(dim, sum(sizes[:rank]), sizes[rank]).contiguous(),
                None, None, None, None)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes, rank, group):
        ctx.args = (dim, sizes, rank)
        return _all_gather_cat(x, dim, sizes, group)

    @staticmethod
    def backward(ctx, g):
        dim, sizes, rank = ctx.args
        return (g.narrow(dim, sum(sizes[:rank]), sizes[rank]).contiguous(),
                None, None, None, None)


def _pick(x: torch.Tensor, src: int, size: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return parts[src]


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank, size, group):
        ctx.args = (rank, size, group)
        return _pick(x, (rank - 1) % size, size, group)

    @staticmethod
    def backward(ctx, g):
        rank, size, group = ctx.args
        return _pick(g, (rank + 1) % size, size, group), None, None, None


def copy_to(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Identity; the gradient all-reduced over `axis` (the entry of a
    tensor-parallel region, whose ranks each add a part of the input's
    gradient)."""
    if process_count(axis) == 1 or not x.requires_grad:
        return x
    return _CopyTo.apply(x, axis_group(axis))


def reduce_from(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum over `axis`; the gradient passes as it is (every rank
    downstream holds the same one)."""
    if process_count(axis) == 1:
        return x
    return _ReduceFrom.apply(x, axis_group(axis))


def shard_sizes(n: int, parts: int) -> Tuple[int, ...]:
    """Rows of each of `parts` contiguous shards of `n`: ceil(n / parts)
    each, the last ones shorter (n need not divide)."""
    per = -(-n // parts)
    return tuple(max(0, min(per, n - i * per)) for i in range(parts))


def split(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """This rank's shard (`shard_sizes`) of `x` along `dim`; the gradient
    all-gathered over `axis`."""
    n = process_count(axis)
    if n == 1:
        return x
    return _Split.apply(x, dim, shard_sizes(x.shape[dim], n),
                        process_index(axis), axis_group(axis))


def gather_sum(x: torch.Tensor, dim: int, total: int, axis: str
               ) -> torch.Tensor:
    """The ranks' shards of a length-`total` tensor along `dim`, whole on
    every rank; the gradient is summed over `axis`, this rank's rows kept
    (each rank's consumer adds a part of it)."""
    n = process_count(axis)
    if n == 1:
        return x
    return _GatherSum.apply(x, dim, shard_sizes(total, n),
                            process_index(axis), axis_group(axis))


def gather_replicated(x: torch.Tensor, dim: int, total: int, axis: str
                      ) -> torch.Tensor:
    """As `gather_sum`, for a consumer that every rank of `axis` runs
    alike: the gradient is this rank's rows of its own, not reduced."""
    n = process_count(axis)
    if n == 1:
        return x
    return _GatherReplicated.apply(x, dim, shard_sizes(total, n),
                                   process_index(axis), axis_group(axis))


def ring_permute(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The previous rank's `x` along `axis` (rank 0 takes the last's);
    the gradient goes the other way."""
    n = process_count(axis)
    if n == 1:
        return x
    return _RingPermute.apply(x, process_index(axis), n, axis_group(axis))


class AxisComm:
    """The tensor-parallel collectives of one mesh axis across processes,
    as the models' TP layers call them (`copy`, `reduce`); parallel/
    mesh.py's LocalTP answers the same calls for the replicas of one
    process."""

    def __init__(self, axis: str = "model"):
        self.axis = axis
        self.size = process_count(axis)
        self.rank = process_index(axis)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.axis)

    def __deepcopy__(self, memo):  # a module copy keeps its group
        return self
