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
  `ms_deform_attn_xla` (datr_tpu/ops/msda.py:322-366). It is the CPU
  kernel of the registered op and the reference the forward kernel is held
  against; `ms_deform_attn_plain_bwd`, its VJP written out, is the CPU
  kernel of the backward op and the reference of the backward kernel.
- `msda_fwd` / `msda_bwd`: the wrappers of the hand-written CUDA kernels
  (csrc/msda_fwd.cu, csrc/msda_bwd.cu). Each counts its launches in
  `.launches`. The kernels share one sample set-up (csrc/msda_common.cuh): a
  warp computes each sample's corners once, gathers rows in 16-byte vectors
  (narrower where D or a pointer's alignment asks for it: every D and any
  contiguous tensor is taken), blocks serve runs of consecutive queries of
  one (batch, head), and the backward scatters with 16-byte vector
  reductions into a zeroed f32 sum (on long launches it first merges, in
  registers, the reductions of consecutive queries onto one row). bf16
  reads rows in 8-byte loads, and on the encoder's long launches takes a
  kernel of its own (each sample's dot products in one lane over whole
  rows before the merged scatter); the one C call zeroes its f32
  workspace, scatters and rounds. The bf16 and f64 forwards' long launches
  at D = 32 (the encoder's) take a kernel of their own too: a warp serves
  several queries at once (bf16 8 at 4 lanes a query, f64 2 at 16 lanes),
  so no lane's sum needs another's. `msda_fwd_routes()` /
  `msda_bwd_routes()` count each kernel's launches.
  Both take value in f32 or bf16 with f32 loc / attn, or everything in
  f64 (`amp_dtype="float64"`, datr_tpu's x64 debugging mode: its own
  instantiations, f64 arithmetic throughout, 16-byte loads of 2 doubles,
  f64 atomics straight into grad_value); in bf16 the backward reads value
  and grad_out as bf16, writes grad_loc / grad_attn in f32 and rounds
  grad_value's f32 sum once to bf16, as the plain version's VJP does
  (datr_tpu's bf16 VJP scatter-adds in bf16: less exact, a documented
  difference).
- `datr_torch::ms_deform_attn` / `datr_torch::ms_deform_attn_backward`: the
  registered ops (torch.library) every path reaches MSDA through, so that
  `torch.export` can trace it (a ctypes launch has no fake-tensor form):
  spatial shapes as a flat `int[]` (h0, w0, h1, w1, ...), a fake kernel
  giving [B, Lq, H*D] in value's dtype, the backward registered as
  autograd's. The CPU kernels are the plain versions, the CUDA kernels
  `msda_fwd` / `msda_bwd`. An exported artifact needs `import
  datr_torch.ops.msda` (which `import datr_torch.ops` does) and nothing
  else of the model code.
- `ms_deform_attn`: the dispatcher. CPU and CUDA tensors go through the
  registered op, anything else raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

import torch

from . import _build

Shapes = Sequence[Tuple[int, int]]


def compute_dtype(value: torch.Tensor) -> torch.dtype:
    """The type MSDA computes in: f64 for f64 value, else f32 (bf16 value
    is widened, as the TPU kernel reads it)."""
    return torch.float64 if value.dtype == torch.float64 else torch.float32


def _corners(loc: torch.Tensor, spatial_shapes: Shapes):
    """Per corner (dy, dx) = (0,0), (0,1), (1,0), (1,1): the flat token index
    (clamped into the level), whether the corner lies inside the level, and
    the bilinear weight, each a list of 4 tensors [B, Lq, H, L, P]
    (int64 / bool / loc's float type); and the fractional offsets fx, fy
    from the lower corner."""
    dev = loc.device
    ws = torch.tensor([w for _, w in spatial_shapes], dtype=loc.dtype,
                      device=dev)
    hs = torch.tensor([h for h, _ in spatial_shapes], dtype=loc.dtype,
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
    return indices, valids, weights, (fx, fy)


def _corner_gather_indices(loc: torch.Tensor, spatial_shapes: Shapes):
    """Per-corner flat token indices and bilinear weights, each a list of 4
    tensors [B, Lq, H, L, P] (int64 / loc's float type). Invalid corners get
    index 0 and weight 0 (datr_tpu/ops/msda.py:43-108)."""
    indices, valids, weights, _ = _corners(loc, spatial_shapes)
    return ([torch.where(v, i, 0) for i, v in zip(indices, valids)],
            [torch.where(v, w, 0.0) for w, v in zip(weights, valids)])


def ms_deform_attn_plain(value: torch.Tensor, spatial_shapes: Shapes,
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch MSDA. Like the TPU kernel it replaces, it reads value in
    f32, keeps every weight in f32 and accumulates per (corner, level) in f32;
    the result is cast to value's dtype. f64 value computes in f64
    throughout: locations, weights and sums."""
    B, S, H, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    assert L == len(spatial_shapes), (L, spatial_shapes)
    cd = compute_dtype(value)
    indices, corner_w = _corner_gather_indices(
        sampling_locations.to(cd), spatial_shapes)

    # [B, S, H, D] -> flat rows [(b, h, s), D]
    value_flat = value.to(cd).transpose(1, 2).reshape(B * H * S, D)
    bh_off = (torch.arange(B * H, device=value.device).reshape(B, H, 1) * S)
    attn = attention_weights.to(cd).permute(0, 2, 1, 3, 4)

    out = torch.zeros((B, H, Lq, D), dtype=cd, device=value.device)
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
# the kernels' dtype enum (csrc/msda_common.cuh: MSDA_F32 / _BF16 / _F64)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


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
    want = compute_dtype(value)
    if value.dtype not in DTYPE_CODE:
        raise ValueError(f"value dtype {value.dtype} is not f32, bf16 or f64")
    if loc.dtype != want or attn.dtype != want:
        raise ValueError(f"loc and attn must be {want} for {value.dtype} "
                         f"value, got {loc.dtype} and {attn.dtype}")
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

    value f32 or bf16 with loc and attn f32, or all three f64; all
    contiguous on one CUDA device. Raises on anything else, and when the
    kernel fails to build or launch."""
    B, S, Lq, H, D, L, P = _check_msda_inputs(
        "msda_fwd", value, spatial_shapes, sampling_locations,
        attention_weights)

    lib = _build.load_library()
    out = torch.empty((B, Lq, H * D), dtype=value.dtype, device=value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    rc = lib.msda_fwd(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        B, S, Lq, H, D, L, P, _shapes_arg(spatial_shapes),
        DTYPE_CODE[value.dtype], value.device.index, stream)
    _build.check(lib, rc, "msda_fwd launch")
    with _launch_lock:
        msda_fwd.launches += 1
    return out


msda_fwd.launches = 0


def msda_bwd(value: torch.Tensor, spatial_shapes: Shapes,
             sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
             grad_out: torch.Tensor):
    """Launch the CUDA kernel (csrc/msda_bwd.cu) on the current stream.

    value and grad_out [B, Lq, H*D] both f32 or both bf16 with loc and attn
    f32, or all f64; all contiguous on one CUDA device. Returns (grad_value,
    grad_loc, grad_attn), shaped as value, loc, attn; grad_value in value's
    dtype (bf16: the f32 sum in a workspace of value's shape, zeroed and
    rounded once by the same C call), grad_loc and grad_attn in loc's.
    grad_value is a sum of atomic adds, so its last bits vary from run to
    run. Raises on other inputs, and when the kernel fails to build or
    launch."""
    B, S, Lq, H, D, L, P = _check_msda_inputs(
        "msda_bwd", value, spatial_shapes, sampling_locations,
        attention_weights, grad_out)
    if grad_out.dtype != value.dtype:
        raise ValueError(f"msda_bwd needs value and grad_out of one dtype, "
                         f"got {value.dtype} and {grad_out.dtype}")
    if grad_out.shape != (B, Lq, H * D):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} is not "
                         f"{(B, Lq, H * D)}")

    lib = _build.load_library()
    grad_loc = torch.empty_like(sampling_locations)
    grad_attn = torch.empty_like(attention_weights)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    if value.dtype == torch.bfloat16:
        # the f32 sum, zeroed and rounded into grad_value by the C call
        work = torch.empty(value.shape, dtype=torch.float32,
                           device=value.device)
        grad_value = torch.empty_like(value)
    else:
        # f32 / f64: the atomics sum straight into grad_value
        work = grad_value = torch.zeros_like(value)
    rc = lib.msda_bwd(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), grad_out.data_ptr(), work.data_ptr(),
        grad_value.data_ptr(), grad_loc.data_ptr(), grad_attn.data_ptr(),
        B, S, Lq, H, D, L, P, _shapes_arg(spatial_shapes),
        DTYPE_CODE[value.dtype], value.device.index, stream)
    _build.check(lib, rc, "msda_bwd launch")
    with _launch_lock:
        msda_bwd.launches += 1
    return grad_value, grad_loc, grad_attn


msda_bwd.launches = 0

# msda_fwd's kernels, in the order of csrc/msda_fwd.cu's MsdaFwdRoute
FWD_ROUTES = ("msda_fwd_kernel f32", "msda_fwd_kernel bf16",
              "msda_fwd_kernel f64", "msda_fwd_bf16_run_kernel",
              "msda_fwd_run_kernel f64")


def msda_fwd_routes() -> dict:
    """{route: its launches since the kernel library was loaded} for each
    of msda_fwd's kernels (FWD_ROUTES), counted where the C launcher
    enqueues each one: the difference over a call says which kernel it
    went through."""
    lib = _build.load_library()
    out = (ctypes.c_longlong * len(FWD_ROUTES))()
    lib.datr_msda_fwd_routes(out)
    return dict(zip(FWD_ROUTES, out))


# msda_bwd's kernels, in the order of csrc/msda_bwd.cu's MsdaBwdRoute
BWD_ROUTES = ("msda_bwd_kernel f32", "msda_bwd_kernel bf16",
              "msda_bwd_kernel f64", "msda_bwd_run_kernel f32",
              "msda_bwd_run_kernel f64", "msda_bwd_bf16_split_kernel")


def msda_bwd_routes() -> dict:
    """{route: its launches since the kernel library was loaded} for each
    of msda_bwd's kernels (BWD_ROUTES), counted where the C launcher
    enqueues each one: the difference over a call says which kernels it
    went through."""
    lib = _build.load_library()
    out = (ctypes.c_longlong * len(BWD_ROUTES))()
    lib.datr_msda_bwd_routes(out)
    return dict(zip(BWD_ROUTES, out))


# d(corner weight)/d(fx, fy) of corner c = 2*dy + dx, from (fx, fy)
_DW = (lambda fx, fy: (fy - 1, fx - 1), lambda fx, fy: (1 - fy, -fx),
       lambda fx, fy: (-fy, 1 - fx), lambda fx, fy: (fy, fx))


def ms_deform_attn_plain_bwd(value: torch.Tensor, spatial_shapes: Shapes,
                             sampling_locations: torch.Tensor,
                             attention_weights: torch.Tensor,
                             grad_out: torch.Tensor):
    """(grad_value, grad_loc, grad_attn): the VJP of `ms_deform_attn_plain`,
    written out (the plain version of `msda_bwd`), in its compute dtype:
    for each corner the forward used, grad_value scatter-adds
    attn * w_c * grad_out (index_add_), grad_attn sums w_c * <grad_out, v_c>
    and grad_loc attn * <grad_out, v_c> * dw_c/d(fx, fy) * (W_l, H_l);
    corners outside the level carry nothing. For bf16 value and grad_out,
    grad_value is the f32 sum rounded once to bf16, grad_loc and grad_attn
    f32. Equal to autograd's VJP of the plain version but for the order of
    its sums."""
    B, S, H, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    cd = compute_dtype(value)
    loc = sampling_locations.to(cd)
    attn = attention_weights.to(cd)
    indices, valids, weights, (fx, fy) = _corners(loc, spatial_shapes)
    dev = value.device
    value_rows = value.to(cd).reshape(B * S * H, D)
    g = grad_out.to(cd).reshape(B, Lq, H, 1, D)
    # row of token s of (b, h) in value_rows: (b * S + s) * H + h
    b_off = (torch.arange(B, device=dev) * S).reshape(B, 1, 1, 1)
    h_idx = torch.arange(H, device=dev).reshape(1, 1, H, 1)
    grad_rows = torch.zeros_like(value_rows)
    grad_attn = torch.zeros_like(attn)
    grad_fx = torch.zeros_like(attn)
    grad_fy = torch.zeros_like(attn)
    for c, (idx, valid, w) in enumerate(zip(indices, valids, weights)):
        dwx, dwy = _DW[c](fx, fy)
        for lvl in range(L):
            rows = ((b_off + idx[:, :, :, lvl]) * H + h_idx).reshape(-1)
            v = valid[:, :, :, lvl]
            a = attn[:, :, :, lvl]
            dot = (value_rows[rows].reshape(B, Lq, H, P, D) * g).sum(-1)
            w_m = torch.where(v, w[:, :, :, lvl], 0.0)
            grad_rows.index_add_(0, rows, (g * (w_m * a)[..., None])
                                 .reshape(-1, D))
            grad_attn[:, :, :, lvl] += dot * w_m
            dw = torch.where(v, dot * a, 0.0)
            grad_fx[:, :, :, lvl] += dw * dwx[:, :, :, lvl]
            grad_fy[:, :, :, lvl] += dw * dwy[:, :, :, lvl]
    whs = torch.tensor([(w, h) for h, w in spatial_shapes], dtype=cd,
                       device=dev)
    grad_loc = torch.stack([grad_fx, grad_fy], -1) * whs[:, None, :]
    return (grad_rows.reshape(value.shape).to(value.dtype),
            grad_loc.to(sampling_locations.dtype),
            grad_attn.to(attention_weights.dtype))


def _pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(flat[i]), int(flat[i + 1]))
                 for i in range(0, len(flat), 2))


@torch.library.custom_op("datr_torch::ms_deform_attn", mutates_args=())
def _msda_op(value: torch.Tensor, spatial_shapes: List[int],
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA with `spatial_shapes` flat (h0, w0, h1, w1, ...); registered
    kernels below."""
    raise ValueError(f"ms_deform_attn: unsupported device {value.device}")


@_msda_op.register_kernel("cpu")
def _msda_op_cpu(value, spatial_shapes, sampling_locations,
                 attention_weights):
    return ms_deform_attn_plain(value, _pairs(spatial_shapes),
                                sampling_locations, attention_weights)


@_msda_op.register_kernel("cuda")
def _msda_op_cuda(value, spatial_shapes, sampling_locations,
                  attention_weights):
    return msda_fwd(value, _pairs(spatial_shapes), sampling_locations,
                    attention_weights)


@_msda_op.register_fake
def _msda_op_fake(value, spatial_shapes, sampling_locations,
                  attention_weights):
    B, _, H, D = value.shape
    return value.new_empty((B, sampling_locations.shape[1], H * D))


@torch.library.custom_op("datr_torch::ms_deform_attn_backward",
                         mutates_args=())
def _msda_bwd_op(value: torch.Tensor, spatial_shapes: List[int],
                 sampling_locations: torch.Tensor,
                 attention_weights: torch.Tensor, grad_out: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad_value, grad_loc, grad_attn) of `datr_torch::ms_deform_attn`."""
    raise ValueError(f"ms_deform_attn: unsupported device {value.device}")


@_msda_bwd_op.register_kernel("cpu")
def _msda_bwd_op_cpu(value, spatial_shapes, sampling_locations,
                     attention_weights, grad_out):
    return ms_deform_attn_plain_bwd(value, _pairs(spatial_shapes),
                                    sampling_locations, attention_weights,
                                    grad_out)


@_msda_bwd_op.register_kernel("cuda")
def _msda_bwd_op_cuda(value, spatial_shapes, sampling_locations,
                      attention_weights, grad_out):
    return msda_bwd(value, _pairs(spatial_shapes), sampling_locations,
                    attention_weights, grad_out.contiguous())


@_msda_bwd_op.register_fake
def _msda_bwd_op_fake(value, spatial_shapes, sampling_locations,
                      attention_weights, grad_out):
    return (torch.empty_like(value), torch.empty_like(sampling_locations),
            torch.empty_like(attention_weights))


def _msda_setup_context(ctx, inputs, output):
    value, spatial_shapes, loc, attn = inputs
    ctx.spatial_shapes = spatial_shapes
    ctx.save_for_backward(value, loc, attn)


def _msda_backward(ctx, grad_out):
    value, loc, attn = ctx.saved_tensors
    g_value, g_loc, g_attn = _msda_bwd_op(value, ctx.spatial_shapes, loc,
                                          attn, grad_out)
    return g_value, None, g_loc, g_attn


_msda_op.register_autograd(_msda_backward, setup_context=_msda_setup_context)


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Shapes,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA through the registered op `datr_torch::ms_deform_attn`: CPU
    tensors -> the plain versions, CUDA tensors -> `msda_fwd`, and in the
    backward `msda_bwd`; any other device raises."""
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn: unsupported device {value.device}")
    flat = [int(v) for hw in spatial_shapes for v in hw]
    return _msda_op(value, flat, sampling_locations, attention_weights)
