"""Pipeline parallelism: GPipe microbatch scheduling over a 'pipe' mesh axis
(port of datr_tpu/parallel/pipeline.py:51-246).

Stage s of S holds layers [s*L/S, (s+1)*L/S) of a stack of identical
layers; microbatches stream through the stages. The schedule is
datr_tpu's: T = M + S - 1 ticks; at tick t stage s applies its layers to
microbatch t - s (clamped: warm-up and overrun ticks compute on a clamped
microbatch and their results are overwritten or never read), then one ring
permute hands every stage's output to the next stage. Stage 0 takes the
fresh microbatch, every other stage what it received, selected as
datr_tpu's `where(stage == 0, fresh, received)` by arithmetic, so every
rank runs the same graph (and the same collectives in its backward). The
last stage's buffer holds the stack's output; a sum over 'pipe' of
`out * is_last` gives it to every rank.

The backward is the reverse pipeline, by autograd: the ring permute's
backward permutes the other way (parallel/dist.py `ring_permute`). The
stacked layer parameters, the input and the per-sample side inputs enter
the 'pipe' region (`dist.copy_to`): each rank's part of their gradient
(its stage's layers; stage 0's input) is summed over the axis, so the
gradients land on the canonical `enc_layer{i}` parameters, equal on every
rank. The final replication's backward passes the gradient as it is: every
rank downstream holds the same one.

`dp_axis` composes PP x DP: the mesh ('data', 'pipe') holds a pipeline
per data coordinate, `x` is this rank's data share, and the data axis's
gradient mean is the data-parallel step's (parallel/mesh.py
`shard_train_state`), as for every other parameter.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from . import dist as pdist


def make_pipe_mesh(device_type: str, stages: int):
    """DeviceMesh ('data', 'pipe') over every rank, `stages` ranks per
    pipeline (rank = d * stages + s, as datr_tpu's tests lay out
    `devices.reshape(dp, s)`); registered as the ranks' mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    n = pdist.world_size()
    if n % stages:
        raise ValueError(f"{n} ranks not divisible by {stages} stages")
    mesh = init_device_mesh(device_type, (n // stages, stages),
                            mesh_dim_names=("data", "pipe"))
    pdist.set_mesh(mesh)
    return mesh


def stack_layer_params(params: Dict[str, torch.Tensor], name_fmt: str,
                       n_layers: int) -> Dict[str, torch.Tensor]:
    """The per-layer parameters `name_fmt.format(i) + '.' + name` of a
    flat name -> tensor dict (`named_parameters`), stacked on a new leading
    layer axis: name -> [n_layers, ...]. Differentiable: the stack's
    gradient reaches each layer's tensor."""
    prefix0 = name_fmt.format(0) + "."
    names = [k[len(prefix0):] for k in params if k.startswith(prefix0)]
    return {n: torch.stack([params[f"{name_fmt.format(i)}.{n}"]
                            for i in range(n_layers)]) for n in names}


def _microbatch(tree: Any, n_micro: int) -> list:
    """[B, ...] leaves -> a list of n_micro trees of [B / n_micro, ...]."""
    leaves, spec = tree_flatten(tree)
    for v in leaves:
        if v.shape[0] % n_micro:
            raise ValueError(f"batch {v.shape[0]} not divisible by "
                             f"n_micro {n_micro}")
    parts = [v.chunk(n_micro) for v in leaves]
    return [tree_unflatten([p[m] for p in parts], spec)
            for m in range(n_micro)]


def _select(a: Any, b: Any, take_a: float) -> Any:
    """`a` where take_a is 1, else `b` (both in every rank's graph)."""
    return tree_map(lambda x, y: x * take_a + y * (1.0 - take_a)
                    if x.is_floating_point() else (x if take_a else y),
                    a, b)


def gpipe(
    stage_apply: Callable[[Dict[str, torch.Tensor], Any, Any, Any], Any],
    stacked_params: Dict[str, torch.Tensor],
    shared: Any,
    x: Any,
    aux: Any,
    *,
    mesh,
    n_micro: int,
    axis: str = "pipe",
    dp_axis: Optional[str] = None,
) -> Any:
    """Run `x` through a pipelined layer stack.

    stage_apply(layer_params, shared, x_mb, aux_mb) -> y_mb applies ONE
    layer (`layer_params`: name -> that layer's tensor) to one microbatch;
    a stage applies its L/S layers in turn. `stacked_params` holds every
    layer's tensors, [L, ...] (`stack_layer_params`); `shared` is any
    stage-invariant value; `x` the [B, ...] activation (a tensor or a
    tuple / dict of them) and `aux` a pytree of [B, ...] per-sample side
    inputs that every stage reads. `mesh` has the axis `axis` (and, with
    `dp_axis`, that data axis: `x` is then this rank's share along it).
    Returns the stack's output on every rank of the axis."""
    names = mesh.mesh_dim_names
    others = [a for a in names if a not in (axis, dp_axis)
              and mesh.size(names.index(a)) > 1]
    if others:
        raise ValueError(f"gpipe: mesh axes {others} are neither the "
                         f"pipe axis {axis!r} nor dp_axis {dp_axis!r}")
    S = pdist.process_count(axis)
    stage = pdist.process_index(axis)
    n_layers = next(iter(stacked_params.values())).shape[0]
    if n_layers % S:
        raise ValueError(f"{n_layers} layers not divisible by {S} "
                         "pipeline stages")
    per_stage = n_layers // S

    def enter(v):
        return pdist.copy_to(v, axis) if v.is_floating_point() else v

    mine = {k: enter(v)[stage * per_stage:(stage + 1) * per_stage]
            for k, v in stacked_params.items()}
    x_mb = _microbatch(tree_map(enter, x), n_micro)
    aux_mb = _microbatch(tree_map(enter, aux), n_micro)
    M, T = n_micro, n_micro + S - 1
    first, last = float(stage == 0), float(stage == S - 1)
    recv = tree_map(torch.zeros_like, x_mb[0])
    out_buf = [None] * M
    for t in range(T):
        m = min(max(t - stage, 0), M - 1)
        y = _select(x_mb[m], recv, first)
        for i in range(per_stage):
            y = stage_apply({k: v[i] for k, v in mine.items()}, shared, y,
                            aux_mb[m])
        out_buf[min(max(t - (S - 1), 0), M - 1)] = y
        if t < T - 1:  # the last tick's send is never read
            recv = tree_map(lambda v: pdist.ring_permute(v, axis), y)
    out = tree_map(lambda *vs: torch.cat(vs), *out_buf)
    return tree_map(lambda v: pdist.reduce_from(v * last, axis), out)


PP_DROPOUT_MESSAGE = ("pipeline-parallel encoder does not support active "
                      "dropout (dropout={}) — set dropout=0.0 or disable "
                      "pp_n_micro")


def make_pp_encoder_fn(model, *, mesh, n_micro: int, axis: str = "pipe",
                       dp_axis: Optional[str] = None,
                       dropout: Optional[float] = None) -> Callable:
    """An `encoder_fn` for DINO.forward / `_transformer_pass` that runs the
    encoder's identical deformable layers as a GPipe pipeline over `axis`.

    The stacked per-layer copies are made from the model's `enc_layer{i}`
    parameters at each call (a relayout, cheap next to the layers), so
    gradients reach the canonical parameters and checkpoints keep the
    sequential layout; build it inside the loss (train/steps.py). Each
    layer runs as `enc_layer0` with the layer's tensors swapped in
    (torch.func.functional_call), recomputed in the backward with
    `use_remat`. `dropout` (default: the model's, 0.0 in the port) with an
    active `deterministic=False` call raises NotImplementedError, as
    datr_tpu's does."""
    from torch.func import functional_call
    from torch.utils.checkpoint import checkpoint

    template = model.enc_layer0
    rate = getattr(model, "dropout", 0.0) if dropout is None else dropout

    def encoder_fn(src, pos, ref, mask, spatial_shapes, deterministic=True):
        if not deterministic and rate > 0.0:
            raise NotImplementedError(PP_DROPOUT_MESSAGE.format(rate))
        params = dict(model.named_parameters())
        stacked = stack_layer_params(params, "enc_layer{}",
                                     model.enc_layers)

        def layer(p, y, pos_t, ref_t, mask_t):
            return functional_call(template, p, (y, pos_t, ref_t,
                                                 spatial_shapes, mask_t))

        def stage_apply(p, shared, y, aux_t):
            pos_t, ref_t, mask_t = aux_t
            if model.use_remat and torch.is_grad_enabled():
                return checkpoint(layer, p, y, pos_t, ref_t, mask_t,
                                  use_reentrant=False)
            return layer(p, y, pos_t, ref_t, mask_t)

        return gpipe(stage_apply, stacked, (), src, (pos, ref, mask),
                     mesh=mesh, n_micro=n_micro, axis=axis, dp_axis=dp_axis)

    return encoder_fn
