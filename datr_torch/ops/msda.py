"""Multi-scale deformable attention (MSDA), forward and backward.

Contract (datr_tpu/ops/msda.py):
  value:              [B, S, H, D]   S = sum_l(H_l * W_l)
  spatial_shapes:     tuple ((H_0, W_0), ...) of Python ints
  sampling_locations: [B, Lq, H, L, P, 2]  (x, y) normalized to [0, 1]
  attention_weights:  [B, Lq, H, L, P]
  output:             [B, Lq, H * D] in value's dtype

Bilinear sampling as grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=False), with the FMA-proof corner choice of
datr_tpu/ops/msda.py:68-84.

The functions:
- `ms_deform_attn_plain`: plain PyTorch, the per-corner x per-level gather of
  `ms_deform_attn_xla` (datr_tpu/ops/msda.py:322-366). It is the CPU path,
  differentiable by autograd, and the reference the forward kernel is held
  against; `ms_deform_attn_plain_bwd` is its autograd VJP, the reference of
  the backward kernel.
- `msda_fwd` / `msda_bwd`: the wrappers of the hand-written CUDA kernels
  (csrc/msda_fwd.cu, csrc/msda_bwd.cu). Each counts its launches in
  `.launches`. The kernels share one sample set-up (csrc/msda_common.cuh): a
  warp computes each sample's corners once, gathers rows in 16-byte vectors
  (narrower where D or a pointer's alignment asks for it: every D and any
  contiguous tensor is taken), blocks serve runs of consecutive queries of
  one (batch, head), and the backward scatters with 16-byte vector
  reductions into the zeroed grad_value (on long launches at D = 32 it first
  merges, in registers, the reductions of consecutive queries onto one row).
- `MSDeformAttnFunction`: the autograd Function built from the two kernels.
- `ms_deform_attn`: the dispatcher. CPU tensors go to the plain version, CUDA
  tensors through `MSDeformAttnFunction`, anything else raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch

from . import _build

Shapes = Sequence[Tuple[int, int]]


def _corners(loc: torch.Tensor, spatial_shapes: Shapes):
    """Per corner (dy, dx) = (0,0), (0,1), (1,0), (1,1): the flat token index
    (clamped into the level), whether the corner lies inside the level, and
    the bilinear weight, each a list of 4 tensors [B, Lq, H, L, P]
    (int64 / bool / float32)."""
    dev = loc.device
    ws = torch.tensor([w for _, w in spatial_shapes], dtype=torch.float32,
                      device=dev)
    hs = torch.tensor([h for h, _ in spatial_shapes], dtype=torch.float32,
                      device=dev)
    starts_list = [0]
    for h, w in spatial_shapes[:-1]:
        starts_list.append(starts_list[-1] + h * w)
    starts = torch.tensor(starts_list, dtype=torch.int64, device=dev)

    x = loc[..., 0] * ws[:, None] - 0.5  # [B, Lq, H, L, P]
    y = loc[..., 1] * hs[:, None] - 0.5
    # the floor threshold is nudged by more than any 1-ulp divergence between
    # two roundings of x (an FMA in the kernel, say), so every copy picks the
    # same corner; at exact integers it takes the (lower corner, frac ~ 1)
    # decomposition, which is bilinearly identical
    eps_x = 1e-4 + ws[:, None] * 2.0 ** -20
    eps_y = 1e-4 + hs[:, None] * 2.0 ** -20
    x0 = torch.floor(x - eps_x)
    y0 = torch.floor(y - eps_y)
    fx = x - x0
    fy = y - y0

    wi = ws.to(torch.int64)[:, None]
    hi = hs.to(torch.int64)[:, None]
    # clamped so the int conversion is defined; no corner changes sides
    x0i = torch.nan_to_num(x0, nan=-2.0).clamp(-2, None)
    x0i = torch.minimum(x0i, ws[:, None] + 1).to(torch.int64)
    y0i = torch.nan_to_num(y0, nan=-2.0).clamp(-2, None)
    y0i = torch.minimum(y0i, hs[:, None] + 1).to(torch.int64)

    indices, valids, weights = [], [], []
    for dy, dx, w_corner in (
        (0, 0, (1 - fx) * (1 - fy)),
        (0, 1, fx * (1 - fy)),
        (1, 0, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        cx = x0i + dx
        cy = y0i + dy
        valid = (cx >= 0) & (cx < wi) & (cy >= 0) & (cy < hi)
        cx_c = torch.minimum(cx.clamp(min=0), wi - 1)
        cy_c = torch.minimum(cy.clamp(min=0), hi - 1)
        indices.append(starts[:, None] + cy_c * wi + cx_c)
        valids.append(valid)
        weights.append(w_corner)
    return indices, valids, weights


def _corner_gather_indices(loc: torch.Tensor, spatial_shapes: Shapes):
    """Per-corner flat token indices and bilinear weights, each a list of 4
    tensors [B, Lq, H, L, P] (int64 / float32). Invalid corners get index 0
    and weight 0 (datr_tpu/ops/msda.py:43-108)."""
    indices, valids, weights = _corners(loc, spatial_shapes)
    return ([torch.where(v, i, 0) for i, v in zip(indices, valids)],
            [torch.where(v, w, 0.0) for w, v in zip(weights, valids)])


def ms_deform_attn_plain(value: torch.Tensor, spatial_shapes: Shapes,
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch MSDA. Like the TPU kernel it replaces, it reads value in
    f32, keeps every weight in f32 and accumulates per (corner, level) in f32;
    the result is cast to value's dtype."""
    B, S, H, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    assert L == len(spatial_shapes), (L, spatial_shapes)
    indices, corner_w = _corner_gather_indices(
        sampling_locations.to(torch.float32), spatial_shapes)

    # [B, S, H, D] -> flat rows [(b, h, s), D]
    value_flat = value.to(torch.float32).transpose(1, 2).reshape(B * H * S, D)
    bh_off = (torch.arange(B * H, device=value.device).reshape(B, H, 1) * S)
    attn = attention_weights.to(torch.float32).permute(0, 2, 1, 3, 4)

    out = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=value.device)
    for idx, w in zip(indices, corner_w):
        idx_bh = idx.permute(0, 2, 1, 3, 4)  # [B, H, Lq, L, P]
        w_attn = w.permute(0, 2, 1, 3, 4) * attn
        for lvl in range(L):
            flat_idx = (idx_bh[:, :, :, lvl].reshape(B, H, Lq * P)
                        + bh_off).reshape(-1)
            g = value_flat[flat_idx].reshape(B, H, Lq, P, D)
            out += (g * w_attn[:, :, :, lvl, :, None]).sum(3)
    return out.permute(0, 2, 1, 3).reshape(B, Lq, H * D).to(value.dtype)


_launch_lock = threading.Lock()


def _check_msda_inputs(name, value, spatial_shapes, loc, attn, *more):
    """Shapes, devices, types and contiguity the kernels take; raises on
    anything else. Returns (B, S, Lq, H, D, L, P)."""
    B, S, H, D = value.shape
    if loc.dim() != 6 or attn.dim() != 5:
        raise ValueError("expected loc [B,Lq,H,L,P,2] and attn [B,Lq,H,L,P]")
    _, Lq, _, L, P, _ = loc.shape
    if loc.shape != (B, Lq, H, L, P, 2) or attn.shape != (B, Lq, H, L, P):
        raise ValueError(
            f"shape mismatch: value {tuple(value.shape)}, loc "
            f"{tuple(loc.shape)}, attn {tuple(attn.shape)}")
    if len(spatial_shapes) != L or sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match "
                         f"L={L}, S={S}")
    tensors = (value, loc, attn, *more)
    if not all(t.is_cuda and t.device == value.device for t in tensors):
        raise ValueError(f"{name} needs all inputs on one CUDA device")
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise ValueError("loc and attn must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    return B, S, Lq, H, D, L, P


def _shapes_arg(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(
        *[v for hw in spatial_shapes for v in hw])


def msda_fwd(value: torch.Tensor, spatial_shapes: Shapes,
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (csrc/msda_fwd.cu) on the current stream.

    value f32 or bf16, loc and attn f32, all contiguous on one CUDA device.
    Raises on anything else, and when the kernel fails to build or launch."""
    B, S, Lq, H, D, L, P = _check_msda_inputs(
        "msda_fwd", value, spatial_shapes, sampling_locations,
        attention_weights)
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"value dtype {value.dtype} is not f32 or bf16")

    lib = _build.load_library()
    out = torch.empty((B, Lq, H * D), dtype=value.dtype, device=value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    rc = lib.msda_fwd(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        B, S, Lq, H, D, L, P, _shapes_arg(spatial_shapes),
        int(value.dtype == torch.bfloat16), value.device.index, stream)
    _build.check(lib, rc, "msda_fwd launch")
    with _launch_lock:
        msda_fwd.launches += 1
    return out


msda_fwd.launches = 0


def msda_bwd(value: torch.Tensor, spatial_shapes: Shapes,
             sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
             grad_out: torch.Tensor):
    """Launch the CUDA kernel (csrc/msda_bwd.cu) on the current stream.

    All inputs f32, contiguous, on one CUDA device; grad_out [B, Lq, H*D].
    Returns (grad_value, grad_loc, grad_attn), shaped as value, loc, attn.
    grad_value is a sum of atomic adds, so its last bits vary from run to
    run. Raises on other inputs, and when the kernel fails to build or
    launch."""
    B, S, Lq, H, D, L, P = _check_msda_inputs(
        "msda_bwd", value, spatial_shapes, sampling_locations,
        attention_weights, grad_out)
    if value.dtype != torch.float32 or grad_out.dtype != torch.float32:
        raise ValueError("msda_bwd needs float32 value and grad_out")
    if grad_out.shape != (B, Lq, H * D):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} is not "
                         f"{(B, Lq, H * D)}")

    lib = _build.load_library()
    grad_value = torch.zeros_like(value)
    grad_loc = torch.empty_like(sampling_locations)
    grad_attn = torch.empty_like(attention_weights)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    rc = lib.msda_bwd(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), grad_out.data_ptr(),
        grad_value.data_ptr(), grad_loc.data_ptr(), grad_attn.data_ptr(),
        B, S, Lq, H, D, L, P, _shapes_arg(spatial_shapes),
        value.device.index, stream)
    _build.check(lib, rc, "msda_bwd launch")
    with _launch_lock:
        msda_bwd.launches += 1
    return grad_value, grad_loc, grad_attn


msda_bwd.launches = 0


def ms_deform_attn_plain_bwd(value: torch.Tensor, spatial_shapes: Shapes,
                             sampling_locations: torch.Tensor,
                             attention_weights: torch.Tensor,
                             grad_out: torch.Tensor):
    """(grad_value, grad_loc, grad_attn): the VJP of `ms_deform_attn_plain`
    by autograd, the plain version of `msda_bwd`."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in
                  (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_plain(inputs[0], spatial_shapes, inputs[1],
                                   inputs[2])
        return torch.autograd.grad(out, inputs, grad_out)


class MSDeformAttnFunction(torch.autograd.Function):
    """MSDA on the card: forward by `msda_fwd`, backward by `msda_bwd`."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations,
                attention_weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return msda_fwd(value, spatial_shapes, sampling_locations,
                        attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        g_value, g_loc, g_attn = msda_bwd(value, ctx.spatial_shapes, loc,
                                          attn, grad_out.contiguous())
        return g_value, None, g_loc, g_attn


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Shapes,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """CPU tensors -> plain version (autograd differentiates it); CUDA
    tensors -> the kernels through `MSDeformAttnFunction`; else raise."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.is_cuda:
        return MSDeformAttnFunction.apply(value, shapes, sampling_locations,
                                          attention_weights)
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, shapes, sampling_locations,
                                    attention_weights)
    raise ValueError(f"ms_deform_attn: unsupported device {value.device}")
