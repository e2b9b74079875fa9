#!/usr/bin/env python3
"""Smoke test of the datr_torch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. environment: card name and power limit, torch/CUDA versions, and a fresh
     build of every CUDA kernel from datr_torch/csrc (one nvcc per source,
     all at once; build time printed);
  2. msda_fwd against its plain PyTorch version at the serving shapes, in
     f32 and bf16, plus an edge set; kernel, plain-version and bound times at
     uniform-random locations, beside the bytes the kernel requests from the
     caches (rows gathered x row bytes) and the rate they came at;
  2b. the training slice's kernels against their plain versions:
     msda_fwd/msda_bwd at the C2F training shapes (encoder Lq 51,680,
     decoder 1,100 / 900; random, integer and outside locations, D=8);
     kernel, plain-version and bound times at random locations, as in 2;
  3. the serving slice at full width: the flagship DINO-R50 4-scale model
     (configs/DINO/DINO_4scale.py, 9 classes, seeded random weights) behind
     InferenceServer at 800x1344, batch 2, answering uint8 requests of
     several sizes; the kernel launch counts of that run; msda_fwd checked
     and timed as in 2 at the locations this model produces (one encoder and
     one decoder call captured from a forward; keys `..._model`); one batch's
     forward through the kernels against the forward through the plain
     versions;
  4. the gather bench entry point (datr_torch.tools.msda_gather_bench),
     which holds row_gather (K2 shapes, K4/K5/K6 patterns; exact) and
     gather_fma (K3 shapes; one bf16 rounding) against their plain versions
     and times each beside its plain version, its PyTorch yardstick and the
     launch floor (row_gather and index_select on one row); its launch
     counts, by case, and each case's bound; then, outside the counted
     run, gather_fma's every instantiation against its plain version: K =
     1, 3, 16, 36, n_out 2,048 / 37 / 1 (37 and 1 not a multiple of the
     block), with and without indices outside the table, and K = 16 from
     idx / w that are not 16-byte aligned;
  5. the training slice at full width: the Cityscapes->Foggy burn-in config
     (configs/DA/Cityscapes2FoggyCityscapes/DINO_4scale_C2F.py, seeded
     random weights) trained by engine.train_one_epoch on synthetic paired
     batches at 1216x2048, 4 images per step: msda_fwd/msda_bwd checked and
     timed as in 2b at the locations the seeded model produces (its encoder
     and both decoder calls captured from one forward); a warm-up step, then
     3 timed steps (launch counts of those, s/step, peak memory); one step's
     losses and gradients through the kernels against the same step through
     the plain versions (discrete choices held fixed: top-k, assignments,
     prototype classes, the sign under each transformer ReLU); a profile
     of one step. This phase runs last, after phase 6: the profile's trace
     overflows the profiler's buffers, after which the profiler records no
     device time in this process;
  6. the self-training slice at full width: the Cityscapes->Foggy
     self-training config (DINO_4scale_C2F_self_training.py, seeded random
     weights, the EMA teacher a copy of the student) trained by
     engine.train_one_epoch_self_training on synthetic paired batches with
     a photometric strong view at 1216x2048: a pseudo-label threshold set
     for the run below the seeded teacher's top scores, a warm-up step,
     then 3 timed steps (launch counts, s/step, peak memory, num_pseudo per
     step); the device time of the teacher forward, the pseudo-labels (NMS
     included) and the student's forward and backward; one step through
     the kernels against the plain versions with the pseudo-labels made
     once and the discrete choices held; update_emas_per_epoch;
     engine.evaluate of the EMA teacher on 8 target images, batch 2
     (launches, img/s, the 12 COCO stats) and one batch's detections
     against the plain forward's; checkpoint and BestTracker round trips,
     bitwise; its state freed before phase 5 starts, so that each
     phase's peak memory is its own;
  7. the training CLI at full width: datr_torch.main.main(args) in this
     process on the C2F self-training config with --synthetic (one burn-in
     and one self-training epoch of 2 steps, 2 + 2 images at 1216x2048,
     fed by the augmenting host loader), in a temporary directory: its
     log.txt lines hold datr_tpu's keys, the checkpoint and the best
     families are written, the msda_fwd / msda_bwd launches equal the count
     derived from the steps and eval batches it made; each epoch's parts
     (train loop, evaluations, checkpoint saves, EMA update); then the host
     loader's img/s at Cityscapes size (make_da_loader with the strong
     view, 4 threads, 1024x2048 frames, C2F transforms). Runs after phase
     6 and before phase 5, its state freed first;
  8. bfloat16 (runs after 7, before 5): msda_fwd / msda_bwd with bf16
     value against their plain versions at the serving and training shapes,
     and at DINO_5scale's five levels and DINO_4scale_fast's two points per
     level in f32 and bf16; msda_bwd in bf16 timed beside f32 at the
     training shapes; the flagship server in bf16 at bench.py's settings
     (800x1344, batch 2, use_remat off) with fast_norm off and on: requests,
     12 launches per batch, step by CUDA events, profile, msda_fwd at the
     bf16 model's own locations, the forward through the kernels against
     the plain bf16 forward (top-k held; memory and boxes atol 1e-2, logits
     5e-2); one batch each of DINO_5scale and DINO_4scale_fast in bf16; C2F
     burn-in in bf16 (the kernels at the model's locations, warm-up + 3
     timed steps, launches 48 / 24 per step, peak memory, parameters /
     moments / EMA tracks f32, one step against the plain bf16 step within
     5e-3 (losses) / 2e-2 (gradients by norm) with the choices held, one
     profiled step naming the image discriminator's convolutions); C2F
     self-training in bf16 (warm-up + 3 timed steps, launches 60 / 24, one
     step against the plain bf16 step, evaluate of the EMA teacher on 8
     images); phase 7's CLI run again with `--amp` (launches as derived,
     f32 parameters); each part's state freed before the next;
  9. the result: the wall time of each phase, a {"kernels": [...]} line,
     the card line, and as the last line {"ok": true, "device": {...}}.
Imports nothing of JAX or datr_tpu. Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time
import types
from unittest import mock

import numpy as np
import torch

# the card's published peaks (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

SHAPES = ((100, 168), (50, 84), (25, 42), (13, 21))  # 800x1344, strides 8-64
S = sum(h * w for h, w in SHAPES)  # 22,323 tokens
B, H, D, L, P = 2, 8, 32, 4, 4
N_QUERIES = 900
C2F = "configs/DA/Cityscapes2FoggyCityscapes/DINO_4scale_C2F.py"
TRAIN_CANVAS = (1216, 2048)
TRAIN_SHAPES = ((152, 256), (76, 128), (38, 64), (19, 32))  # 1216x2048
TRAIN_S = sum(h * w for h, w in TRAIN_SHAPES)  # 51,680 tokens
# decoder queries: 900 + 200 DN in the source pass, 900 in the target pass
TRAIN_DEC_LQ = (1100, 900)
TOL = {"f32": dict(rtol=1e-4, atol=1e-5),
       # bf16 output: one rounding of the f32 sum, at most half a bf16 ulp
       "bf16": dict(rtol=2.0 ** -8, atol=1e-5)}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 2


def msda_inputs(gen, lq, dtype=torch.float32, d=D, case="random",
                shapes=SHAPES, p=P):
    dev = gen.device
    s_tok, n_l = sum(h * w for h, w in shapes), len(shapes)
    value = torch.randn(B, s_tok, H, d, device=dev, generator=gen).to(dtype)
    attn = torch.rand(B, lq, H, n_l, p, device=dev, generator=gen)
    attn = (attn / attn.sum((-1, -2), keepdim=True)).contiguous()
    if case == "random":
        loc = torch.rand(B, lq, H, n_l, p, 2, device=dev, generator=gen)
    elif case == "outside":
        loc = torch.rand(B, lq, H, n_l, p, 2, device=dev, generator=gen)
        loc = loc * 1.6 - 0.3
    else:  # "integer": on pixel centres, as DINO's initial offsets put them
        wh = torch.tensor([(w, h) for h, w in shapes], dtype=torch.float32,
                          device=dev)
        hi = (wh + 2).to(torch.int64)[:, None, :].expand(n_l, p, 2)
        ij = (torch.rand(B, lq, H, n_l, p, 2, device=dev, generator=gen)
              * hi).floor() - 1  # -1 .. W (H): the borders included
        loc = (ij + 0.5) / wh[:, None, :]
    return value, loc.contiguous(), attn


def value_rows_touched(msda, loc, shapes=SHAPES) -> int:
    """Distinct (b, h, token) rows of value that carry a nonzero bilinear
    weight for these sampling locations: the rows the function must read."""
    s_tok = sum(h * w for h, w in shapes)
    indices, weights = msda._corner_gather_indices(loc, shapes)
    bh = (torch.arange(B, device=loc.device)[:, None, None, None, None] * H
          + torch.arange(H, device=loc.device)[None, None, :, None, None]
          ) * s_tok
    touched = torch.zeros(B * H * s_tok, dtype=torch.bool, device=loc.device)
    for idx, w in zip(indices, weights):
        touched[(bh + idx)[w != 0]] = True
    return int(touched.sum().item())


def cache_traffic(msda, loc, shapes, d=D, elt=4) -> dict:
    """Bytes the kernels request from the caches on these locations (what
    the device-memory bound does not see): the forward gathers one row of d
    elements of `elt` bytes per corner inside its level; the backward
    gathers the same rows and sends at most one reduction of d f32 per
    inside corner whose bilinear weight is not zero (fewer where it merges
    the reductions of consecutive queries on one row, so its rate reads
    high there)."""
    _, valids, weights = msda._corners(loc, shapes)
    inside = sum(int(v.sum()) for v in valids)
    reduced = sum(int((v & (w != 0)).sum()) for v, w in zip(valids, weights))
    return dict(fwd=inside * d * elt, bwd=inside * d * elt + reduced * d * 4)


def roofline(n_bytes, flops):
    """(bound ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def msda_bound(msda, loc, elt=4, d=D, shapes=SHAPES):
    """(bound ms, bound_by, value rows read) for one forward launch on these
    inputs: the value rows they touch, loc and attn each read once and the
    output written once, against the f32 operations (a multiply-add per
    gathered element)."""
    lq, n_l, n_p = loc.shape[1], loc.shape[3], loc.shape[4]
    rows = value_rows_touched(msda, loc, shapes)
    n_samples = B * lq * H * n_l * n_p
    n_bytes = (rows * d * elt + n_samples * 2 * 4 + n_samples * 4
               + B * lq * H * d * elt)
    flops = n_samples * 4 * d * 2
    return (*roofline(n_bytes, flops), rows)


def msda_bwd_bound(msda, loc, d=D, shapes=SHAPES, elt=4):
    """(bound ms, bound_by, value rows) for one backward launch: what the
    function must move, not what the atomic design moves — the value rows
    touched read once, grad_value (every row) written once, grad_out read
    once, each of `elt` bytes (4 in f32, 2 in bf16; the bf16 kernel's f32
    workspace is a cost of its design, not counted); loc / attn read and
    grad_loc / grad_attn written in f32; 4 f32 operations per gathered
    element (the dot product's multiply-add and the scattered
    multiply-add)."""
    lq, n_l, n_p = loc.shape[1], loc.shape[3], loc.shape[4]
    s_tok = sum(h * w for h, w in shapes)
    rows = value_rows_touched(msda, loc, shapes)
    n_samples = B * lq * H * n_l * n_p
    n_bytes = ((rows + B * s_tok * H + B * lq * H) * d * elt
               + n_samples * 2 * 4 * 2 + n_samples * 4 * 2)
    flops = n_samples * 4 * d * 4
    return (*roofline(n_bytes, flops), rows)


def time_fwd(msda, value, shapes, loc, attn, iters, p_iters) -> dict:
    """msda_fwd per launch on these inputs beside its plain version, its
    device-memory bound, and the bytes it requests from the caches with the
    rate at which they were delivered."""
    d, elt = value.shape[-1], value.element_size()
    ms = cuda_ms(lambda: msda.msda_fwd(value, shapes, loc, attn), iters)
    plain_ms = cuda_ms(lambda: msda.ms_deform_attn_plain(
        value, shapes, loc, attn), p_iters, warmup=1)
    bound_ms, bound_by, rows = msda_bound(msda, loc, elt, d, shapes)
    req = cache_traffic(msda, loc, shapes, d, elt)["fwd"]
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, value_rows_read=rows, cache_bytes=req,
                cache_tb_s=req / ms / 1e9)


def time_bwd(msda, value, shapes, loc, attn, g, iters, p_iters) -> dict:
    """The same for msda_bwd (its zero-fill of grad_value included)."""
    d, elt = value.shape[-1], value.element_size()
    ms = cuda_ms(lambda: msda.msda_bwd(value, shapes, loc, attn, g), iters)
    plain_ms = cuda_ms(lambda: msda.ms_deform_attn_plain_bwd(
        value, shapes, loc, attn, g), p_iters, warmup=1)
    bound_ms, bound_by, _ = msda_bwd_bound(msda, loc, d, shapes, elt)
    req = cache_traffic(msda, loc, shapes, d, elt)["bwd"]
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, cache_bytes=req,
                cache_tb_s=req / ms / 1e9)


def dtype_name(t) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def check_fwd(msda, name, value, shapes, loc, attn) -> float:
    """msda_fwd against its plain version in f32 on the same values
    (TOL by value's dtype: a bf16 output is one rounding of the f32 sum).
    Returns the max abs error."""
    got = msda.msda_fwd(value, shapes, loc, attn)
    torch.cuda.synchronize()
    want = msda.ms_deform_attn_plain(value.float(), shapes, loc, attn)
    err = (got.float() - want).abs().max().item()
    torch.testing.assert_close(got.float(), want, **TOL[dtype_name(value)],
                               msg=lambda m: f"msda_fwd {name}: {m}")
    return err


def check_bwd(msda, name, value, shapes, loc, attn, g) -> dict:
    """msda_bwd against its plain version: grad_loc and grad_attn (f32)
    at rtol 1e-4 / atol 1e-5 (grad_loc's atol times the largest level side:
    it is the bilinear slope times the side); grad_value at rtol 1e-4 /
    atol 1e-5 in f32 (atomic adds in a run-dependent order) and, for bf16
    value and grad_out, against the plain version's f32 sum on the same
    bf16 values within one bf16 rounding (rtol 2^-8 on top). Returns the
    max abs error of each."""
    got = msda.msda_bwd(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    want = msda.ms_deform_attn_plain_bwd(value.float(), shapes, loc, attn,
                                         g.float())
    max_side = max(max(hw) for hw in shapes)
    bf16 = value.dtype == torch.bfloat16
    assert got[0].dtype == value.dtype and got[1].dtype == torch.float32
    errs = {}
    for part, a, b in zip(("value", "loc", "attn"), got, want):
        errs[f"grad_{part}"] = (a.float() - b).abs().max().item()
        rtol = 1e-4 + (2.0 ** -8 if bf16 and part == "value" else 0.0)
        atol = 1e-5 * (max_side if part == "loc" else 1)
        torch.testing.assert_close(
            a.float(), b, rtol=rtol, atol=atol,
            msg=lambda m: f"msda_bwd {name} grad_{part}: {m}")
    return errs


def describe(t) -> str:
    return (f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}, device memory); "
            f"{t['cache_bytes'] / 1e9:.3f} GB requested from the caches = "
            f"{t['cache_tb_s']:.2f} TB/s")


def capture_msda_calls(msda, fn) -> dict:
    """The inputs (value, shapes, loc, attn) of the first ms_deform_attn call
    of each query count Lq while fn() runs without autograd: the locations
    the model itself produces."""
    calls = {}
    real = msda.ms_deform_attn

    def record(value, shapes, loc, attn):
        calls.setdefault(loc.shape[1], (
            value.detach().clone(), tuple(tuple(hw) for hw in shapes),
            loc.detach().clone(), attn.detach().clone()))
        return real(value, shapes, loc, attn)

    with mock.patch.object(msda, "ms_deform_attn", record), torch.no_grad():
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return calls


def check_model_locations(msda, calls, parts, shapes, backward) -> dict:
    """The kernels against their plain versions, and their times, on inputs
    captured from the model (`calls`, by Lq; value f32 or bf16 as the model
    computes); `parts` names the query counts. Same tolerances as at the
    random locations."""
    timing = {}
    for part, lq in parts.items():
        value, sh, loc, attn = calls[lq]
        gen = torch.Generator(device=value.device).manual_seed(2)
        dt = dtype_name(value)
        assert sh == tuple(shapes), (sh, lq)
        assert value.shape == (B, sum(h * w for h, w in sh), H, D)
        err = {"fwd": check_fwd(msda, f"{part} at the model's locations",
                                value, sh, loc, attn)}
        # an encoder launch (every token a query) is timed over fewer calls
        iters, p_iters = (10, 2) if lq == value.shape[1] else (50, 5)
        t = dict(lq=lq, dtype=dt)
        f = time_fwd(msda, value, sh, loc, attn, iters, p_iters)
        if not backward:
            t.update(f, max_abs_err=err["fwd"])
            log(f"  msda_fwd {part} Lq={lq} {dt}, the model's locations: "
                f"max_abs_err {err['fwd']:.3g}; {describe(f)}")
        else:
            g = torch.randn(B, lq, H * D, device=value.device,
                            generator=gen).to(value.dtype)
            err.update(check_bwd(msda, f"{part} at the model's locations",
                                 value, sh, loc, attn, g))
            bw = time_bwd(msda, value, sh, loc, attn, g, iters, p_iters)
            t["value_rows_read"] = f.pop("value_rows_read")
            t.update({f"fwd_{k}": v for k, v in f.items()})
            t.update({f"bwd_{k}": v for k, v in bw.items()})
            t["max_abs_err"] = err
            log(f"  train {part} Lq={lq} {dt}, the model's locations: "
                f"max_abs_err {err}")
            log(f"    fwd {describe(f)}")
            log(f"    bwd {describe(bw)}")
        timing[part] = t
    return timing


def check_msda(msda) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    cases = [(lq, dt, "random", D) for lq in (N_QUERIES, S)
             for dt in ("f32", "bf16")]
    cases += [(N_QUERIES, "f32", "integer", D), (S, "f32", "integer", D),
              (N_QUERIES, "f32", "outside", D), (N_QUERIES, "f32", "random", 8),
              (N_QUERIES, "bf16", "random", 64)]
    for lq, dt, case, d in cases:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        value, loc, attn = msda_inputs(gen, lq, dtype, d, case)
        name = f"Lq={lq} {dt} {case} D={d}"
        errs[name] = check_fwd(msda, name, value, SHAPES, loc, attn)
        log(f"  msda_fwd {name}: max_abs_err {errs[name]:.3g}")

    timing = {}
    for part, lq in (("encoder", S), ("decoder", N_QUERIES)):
        value, loc, attn = msda_inputs(gen, lq)
        t = time_fwd(msda, value, SHAPES, loc, attn, 50, 5)
        timing[part] = dict(lq=lq, **t, value_rows=B * H * S)
        log(f"  msda_fwd {part} Lq={lq} f32, random locations: "
            f"{describe(t)}; {t['value_rows_read']} of {B * H * S} value "
            f"rows read")
    return dict(errs=errs, timing=timing)


# ---------------------------------------------------------------- phase 3


def request_images():
    """Seeded uint8 images of several sizes and aspect ratios, so the pad
    masks on the 800x1344 canvas differ from slot to slot."""
    rng = np.random.default_rng(0)
    sizes = [(1024, 2048), (480, 640), (720, 1280), (900, 600), (375, 1242),
             (800, 800)]
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


def plain_points_rotated(msda):
    """The plain MSDA with its points taken in another order (rotated by
    one; a reversed order of 4 sums pairwise to the same f32 value): the
    same function, another order of f32 sums before the one rounding to the
    value's dtype, as the kernels' order differs from the plain one."""
    def run(value, shapes, loc, attn):
        return msda.ms_deform_attn_plain(value, shapes, loc.roll(1, -2),
                                         attn.roll(1, -1))
    return run


@contextlib.contextmanager
def computed_in_f32(model):
    """The bf16 model computing in f32 (its parameters are f32; only each
    module's compute dtype changes) for as long as the block runs."""
    flipped = [m for m in model.modules()
               if getattr(m, "dtype", None) == torch.bfloat16]
    for m in flipped:
        m.dtype = torch.float32
    try:
        yield
    finally:
        for m in flipped:
            m.dtype = torch.bfloat16


def check_forward_against_plain(model, batch, sizes, msda, dino_mod,
                                tol=None, control_above=None):
    """One full batch through the kernels and through the plain versions
    (TF32 off), the two-stage selection held fixed. `tol`: the largest
    |kernel - plain| allowed by output (and by `memory_mean_abs`, the
    mean one), default the f32 model's. With `control_above` (bf16) it also
    reads the same differences of two plain runs: the floor, the plain MSDA
    with its points summed in another order (the same sums, as the kernels'
    order differs); the control, the model computing in f32. The limits of
    the outputs named in `control_above` must lie below the control's
    reading."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from datr_torch.serve import wire_decode

    images = torch.from_numpy(batch).cuda()
    sizes = torch.from_numpy(sizes).cuda()
    memories = []
    hook = getattr(model, f"enc_layer{model.enc_layers - 1}") \
        .register_forward_hook(lambda m, i, o: memories.append(o))
    scores = {}
    topk = dino_mod._stable_topk_indices
    try:
        with torch.inference_mode():
            x, pad = wire_decode(images, sizes)
            out_k = model(x, pad)
            kernel_idx = out_k["topk_idx"]

            def fixed_topk(s, k):  # record the plain run's own choice
                scores["plain"] = s
                scores["plain_idx"] = topk(s, k)
                return kernel_idx

            def plain(ms_fn, topk_fn=lambda s, k: kernel_idx):
                with mock.patch.object(msda, "ms_deform_attn", ms_fn), \
                        mock.patch.object(dino_mod, "_stable_topk_indices",
                                          topk_fn):
                    return model(x, pad)

            out_p = plain(msda.ms_deform_attn_plain, fixed_topk)
            if control_above is not None:
                out_r = plain(plain_points_rotated(msda))
                with computed_in_f32(model):
                    out_f = plain(msda.ms_deform_attn_plain)
    finally:
        hook.remove()
    torch.cuda.synchronize()

    def diff(a, b):
        return (a.float() - b.float()).abs()

    def diffs_of(out, memory):
        return {
            "memory": diff(memory, memories[1]).max().item(),
            "memory_mean_abs": diff(memory, memories[1]).mean().item(),
            "pred_logits": diff(out["pred_logits"], out_p["pred_logits"])
            .max().item(),
            "pred_boxes": diff(out["pred_boxes"], out_p["pred_boxes"]).max()
            .item(),
        }

    diffs = diffs_of(out_k, memories[0])
    diffs["memory_largest_abs"] = memories[1].float().abs().max().item()
    # the kernel run's selection is a top-k of the plain run's scores up to
    # near-ties: sorted scores agree even where tied indices swap
    sel = torch.gather(scores["plain"], 1, kernel_idx).sort(-1).values
    own = torch.gather(scores["plain"], 1, scores["plain_idx"]).sort(-1).values
    diffs["topk_scores"] = (sel - own).float().abs().max().item()
    diffs["topk_idx_mismatch"] = int(
        (kernel_idx != scores["plain_idx"]).sum().item())
    tol = tol or {"memory": 1e-4, "pred_logits": 1e-3, "pred_boxes": 1e-4,
                  "topk_scores": 1e-4}
    if control_above is not None:
        diffs["floor"] = diffs_of(out_r, memories[2])
        diffs["control"] = diffs_of(out_f, memories[3])
    log(f"  kernel vs plain forward (tolerance atol {tol}): {diffs}")
    for k, t in tol.items():
        assert diffs[k] <= t, f"forward through the kernels: {k} {diffs[k]}"
    for k in control_above or ():
        assert diffs["control"][k] > tol[k], f"limit above the control: {k}"
    return diffs


def flagship_server(config="configs/DINO/DINO_4scale.py", **overrides):
    """The flagship DINO-R50 4-scale model (or `config`, with `overrides`),
    seeded random weights, behind InferenceServer at 800x1344, batch 2."""
    from datr_torch.config import load_config
    from datr_torch.models import dino as dino_mod
    from datr_torch.serve import InferenceServer

    cfg = load_config(config)
    cfg["num_classes"] = 9
    cfg.update(overrides)
    model = dino_mod.build_dino_from_config(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {config} {overrides or ''}: {n_params} parameters, on "
        f"{next(model.parameters()).device}, {model.dtype}, fast_norm "
        f"{model.fast_norm}")
    # threshold 0 keeps all 300 detections of the random-weight model; the
    # long batch timeout fills each batch although submit() resizes on the
    # host first (so the smoke times no latency)
    return InferenceServer(model, canvas_hw=(800, 1344), batch_size=2,
                           score_threshold=0.0, batch_timeout_s=1.0)


def serving_batch(srv, imgs):
    """One full batch (canvases, real sizes) as the server's step takes it."""
    canv = [srv._preprocess(im) for im in imgs[:2]]
    return (np.stack([c for c, _ in canv]),
            np.array([hw for _, hw in canv], np.int32))


def run_slice(msda, card) -> dict:
    from datr_torch.models import dino as dino_mod

    imgs = request_images()
    srv = flagship_server()
    try:
        srv.warmup()
        torch.cuda.synchronize()
        # ---- the main path: counts from 0, requests, counts read ----
        served = serve_requests(srv, msda, imgs)
        launches, n_fwd = served["launches"], served["batches"]
        log(f"  served {served['requests']} requests in {n_fwd} batches; "
            f"msda_fwd launches {launches}")

        # ---- device time of one full batch through the step ----
        batch, sizes = serving_batch(srv, imgs)

        # ---- msda_fwd at the locations this model produces ----
        calls = capture_msda_calls(msda, lambda: srv._step(batch, sizes))
        at_model = check_model_locations(
            msda, calls, {"encoder": S, "decoder": N_QUERIES}, SHAPES,
            backward=False)
        del calls
        # the server runs f32 with TF32 off, the precision checked below
        assert not (torch.backends.cudnn.allow_tf32
                    or torch.backends.cuda.matmul.allow_tf32)
        fwd_ms = cuda_ms(lambda: srv._step(batch, sizes), 10, warmup=2)
        log(f"  step (upload + forward + postprocess), batch 2, f32 with "
            f"TF32 off: {fwd_ms:.2f} ms = {2e3 / fwd_ms:.2f} img/s on {card}")
        prof = profile_step(lambda: srv._step(batch, sizes).cpu())

        diffs = check_forward_against_plain(srv.model, batch, sizes, msda,
                                            dino_mod)
    finally:
        srv.close()
    return dict(launches=launches, batches=n_fwd, requests=served["requests"],
                step_ms=fwd_ms, step_img_s=2e3 / fwd_ms, forward_diffs=diffs,
                profile=prof, model_locations=at_model)


def _union_ms(spans) -> float:
    """Length of the union of (start, end) intervals in us, in ms."""
    total, cur = 0.0, None
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e3


def profile_step(fn, kernels=("msda_fwd",), top=12, find=None) -> dict:
    """Device time by kernel and by ATen op (with input shapes) over one
    call of fn, and the device's busy share of its wall time. Busy time is
    the union of the kernels' intervals; the sum of their times exceeds it
    where kernels overlap. `kernels`: names whose device time is summed as
    the MSDA share. `find`: {label: substring}: the device time of every
    ATen op whose name with its input shapes holds the substring, summed
    (in `found`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def self_dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    rows = sorted(((e.key, self_dev_ms(e), e.count)
                   for e in prof.key_averages()
                   if e.device_type == cuda and self_dev_ms(e) > 0),
                  key=lambda r: -r[1])
    # the ATen op that launched each kernel, by input shapes
    ops = sorted(((e.key, str(e.input_shapes)[:100], self_dev_ms(e), e.count)
                  for e in prof.key_averages(group_by_input_shape=True)
                  if e.device_type != cuda and self_dev_ms(e) > 0
                  # the profiler's own buffer events carry no op's time
                  and not e.key.startswith(("Activity Buffer",
                                            "Buffer Flush"))),
                 key=lambda r: -r[2])
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == cuda]
    kernel_sum_ms = sum(r[1] for r in rows)
    busy_ms = _union_ms(spans) if spans else None
    msda_ms = sum(r[1] for r in rows if any(k in r[0] for k in kernels))
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               kernel_sum_ms=kernel_sum_ms,
               device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
               msda_ms=msda_ms,
               msda_share=(msda_ms / kernel_sum_ms) if kernel_sum_ms else None,
               top=[dict(kernel=k[:90], ms=round(ms, 4), count=n)
                    for k, ms, n in rows[:top]],
               top_ops=[dict(op=k, shapes=sh, ms=round(ms, 4), count=n)
                        for k, sh, ms, n in ops[:top]])
    if find:
        every = [(f"{e.key} {e.input_shapes}", self_dev_ms(e), e.count)
                 for e in prof.key_averages(group_by_input_shape=True)
                 if e.device_type != cuda and self_dev_ms(e) > 0]
        out["found"] = {label: dict(
            ms=sum(ms for k, ms, _ in every if sub in k),
            ops=sum(n for k, _, n in every if sub in k))
            for label, sub in find.items()}
    if not rows:
        log("  profile: the profiler recorded no device time (not measured)")
    else:
        log(f"  profile of one step: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms} ms (union of kernel intervals), kernel time summed "
            f"{kernel_sum_ms:.2f} ms, {'+'.join(kernels)} {msda_ms:.2f} ms")
        for r in out["top"]:
            log(f"    {r['ms']:9.3f} ms  x{r['count']:<5} {r['kernel']}")
        log("  device time by the ATen op that launched it:")
        for r in out["top_ops"]:
            log(f"    {r['ms']:9.3f} ms  x{r['count']:<5} {r['op']} "
                f"{r['shapes']}")
        for label, r in out.get("found", {}).items():
            log(f"  {label}: {r['ms']:.3f} ms device time in {r['ops']} ops")
    return out


# ---------------------------------------------------------------- phase 2b


def check_train_msda(msda) -> dict:
    """msda_fwd and msda_bwd against their plain versions at the training
    shapes, and their times per launch and per step."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    enc, (dec_src, dec_tgt) = TRAIN_S, TRAIN_DEC_LQ
    sh = TRAIN_SHAPES
    errs = {}
    cases = [(enc, "random", D), (dec_src, "random", D), (enc, "integer", D),
             (dec_src, "integer", D), (dec_src, "outside", D),
             (dec_src, "random", 8)]
    for lq, case, d in cases:
        value, loc, attn = msda_inputs(gen, lq, d=d, case=case, shapes=sh)
        g = torch.randn(B, lq, H * d, device="cuda", generator=gen)
        name = f"Lq={lq} f32 {case} D={d}"
        errs[f"msda_fwd {name}"] = check_fwd(msda, name, value, sh, loc,
                                             attn)
        for k, v in check_bwd(msda, name, value, sh, loc, attn, g).items():
            errs[f"msda_bwd {name} {k}"] = v
        log(f"  msda_fwd/bwd {name}: max_abs_err fwd "
            f"{errs[f'msda_fwd {name}']:.3g}, grad value/loc/attn "
            + "/".join(f"{errs[f'msda_bwd {name} grad_{p}']:.3g}"
                       for p in ("value", "loc", "attn")))
        del value, loc, attn, g

    timing = {}
    for part, lq in (("encoder", enc), ("decoder_src", dec_src),
                     ("decoder_tgt", dec_tgt)):
        value, loc, attn = msda_inputs(gen, lq, shapes=sh)
        g = torch.randn(B, lq, H * D, device="cuda", generator=gen)
        iters = 10 if lq == enc else 50
        p_iters = 2 if lq == enc else 5
        f = time_fwd(msda, value, sh, loc, attn, iters, p_iters)
        bw = time_bwd(msda, value, sh, loc, attn, g, iters, p_iters)
        rows = f.pop("value_rows_read")
        timing[part] = dict(lq=lq, **{f"fwd_{k}": v for k, v in f.items()},
                            **{f"bwd_{k}": v for k, v in bw.items()},
                            value_rows_read=rows, value_rows=B * H * TRAIN_S)
        log(f"  train {part} Lq={lq} f32, random locations: {rows} of "
            f"{B * H * TRAIN_S} value rows")
        log(f"    fwd {describe(f)}")
        log(f"    bwd {describe(bw)}")
        del value, loc, attn, g
    torch.cuda.empty_cache()
    return dict(errs=errs, timing=timing)


def per_train_step(timing, key, n_enc, n_dec):
    """A per-launch time summed over one training step's launches: n_enc
    per encoder launch shape and n_dec per decoder pass (source, target)."""
    return (n_enc * timing["encoder"][key]
            + n_dec * (timing["decoder_src"][key]
                       + timing["decoder_tgt"][key]))


# ---------------------------------------------------------------- phase 5


def paired_batches(n, device, seed, strong=False):
    """n paired batches at 1216x2048: 2 source images (dataset seed
    `seed`), 2 fogged target images (seed + 1), Cityscapes-sized
    (1024x2048) frames of 8 classes; with `strong`, the target's
    photometric strong view too. One thread per batch: numpy's array work
    releases the GIL."""
    from concurrent.futures import ThreadPoolExecutor

    from datr_torch.data.synthetic import (
        SyntheticDetectionDataset,
        synthetic_da_batch,
    )

    src = SyntheticDetectionDataset(2 * n, (1024, 2048), 8, max_objects=16,
                                    seed=seed)
    tgt = SyntheticDetectionDataset(2 * n, (1024, 2048), 8, max_objects=16,
                                    seed=seed + 1, fog=0.35)
    with ThreadPoolExecutor(n) as pool:
        return list(pool.map(lambda i: synthetic_da_batch(
            src, tgt, [2 * i, 2 * i + 1], TRAIN_CANVAS, max_boxes=100,
            device=device, strong=strong), range(n)))


def check_step_against_plain(state, run, msda, loss_tol=1e-3,
                             grad_tol=1e-3, median_grad_tol=None,
                             losses_only=False,
                             floor_and_control=False) -> dict:
    """One step's losses and gradients through the kernels against the
    same step through the plain versions (`run(dn_draws)` does forward,
    losses and backward and returns (total, losses)), f32 with TF32 off,
    with the CDN
    noise, the two-stage top-k of both passes, the matcher's assignments,
    the prototypes' class of each query, the sign under every ReLU of the
    transformer and its heads and the bilinear cell of every MSDA sample
    held to the kernel run's (each a discrete
    choice that a near-tie can flip: the box head over the encoder's
    proposals takes its gradient from the few matched rows, and one unit of
    its hidden layers on the other side of 0 moves that tensor's gradient by
    several 1e-3 of its norm). `median_grad_tol` also holds the median
    tensor's relative gradient error; `losses_only` leaves the logging-only
    counts (class and cardinality errors, argmaxes of the logits) out of
    the loss comparison. `floor_and_control` (bf16) also reads two more
    plain steps against the plain one, with the same choices: the floor,
    the plain MSDA with its points summed in another order; the control,
    the model computing in f32. The median limit must lie below the
    control's median."""
    from datr_torch.models import cdn as cdn_mod
    from datr_torch.models import dino as dino_mod
    from datr_torch.models import layers as layers_mod
    from datr_torch.models import transformer as transformer_mod
    from datr_torch.train import criterion as crit_mod

    model = state.model
    groups, _ = cdn_mod.cdn_layout(model.dn_number, model.dn_single_pad)
    draws = cdn_mod.draw_cdn_noise(torch.Generator().manual_seed(7), 2,
                                   groups, model.dn_single_pad,
                                   model.num_classes, state.amount.device)
    topk, match = dino_mod._stable_topk_indices, crit_mod.match_many
    protos = dino_mod.class_prototypes
    seen_topk, seen_assign, seen_cls, seen_relu = [], [], [], []
    cls_flips, relu_flips = [], []

    def rec_topk(x, k):
        seen_topk.append(topk(x, k))
        return seen_topk[-1]

    def rec_match(*a, **kw):
        seen_assign.append(match(*a, **kw))
        return seen_assign[-1]

    def rec_protos(queries, logits, *a):
        seen_cls.append(torch.sigmoid(logits).argmax(-1))
        return protos(queries, logits, *a)

    def replay_protos(queries, logits, *a):
        # the prototypes read the logits only through this argmax
        cls = next(replay_cls)
        cls_flips.append(int((torch.sigmoid(logits).argmax(-1) != cls).sum()))
        return protos(queries, torch.nn.functional.one_hot(
            cls, logits.shape[-1]).to(logits.dtype), *a)

    def rec_relu(x):
        # also called when a checkpointed layer is recomputed in the
        # backward; both runs make the same calls in the same order
        seen_relu.append(x > 0)
        return torch.nn.functional.relu(x)

    def replay_relu(x):
        held = next(replay_masks)
        relu_flips.append(((x > 0) != held).sum())
        return torch.where(held, x, torch.zeros_like(x))

    def relu_held(relu):
        """torch.nn.functional as the two modules see it, with this relu."""
        return types.SimpleNamespace(**{**vars(torch.nn.functional),
                                        "relu": relu})

    seen_cells, cell_flips = [], []  # each MSDA call's x0, then its y0
    kernel_msda = msda.ms_deform_attn

    def with_floor(floor):
        """torch as the plain MSDA sees it, with this floor."""
        return types.SimpleNamespace(**{**vars(torch), "floor": floor})

    def rec_cells(value, shapes, loc, attn):
        # the kernels take each sample's cell as the plain version does
        # (the same nudged floor of the same f32 location): record it
        def rec(x):
            seen_cells.append(torch.floor(x))
            return seen_cells[-1]

        with torch.no_grad(), \
                mock.patch.object(msda, "torch", with_floor(rec)):
            msda._corners(loc.to(torch.float32), shapes)
        return kernel_msda(value, shapes, loc, attn)

    with mock.patch.object(dino_mod, "_stable_topk_indices", rec_topk), \
            mock.patch.object(crit_mod, "match_many", rec_match), \
            mock.patch.object(dino_mod, "class_prototypes", rec_protos), \
            mock.patch.object(layers_mod, "F", relu_held(rec_relu)), \
            mock.patch.object(transformer_mod, "F", relu_held(rec_relu)), \
            mock.patch.object(msda, "ms_deform_attn", rec_cells):
        total_k, losses_k = run(draws)
    grads_k = {n: p.grad.clone() for n, p in model.named_parameters()
               if p.grad is not None}

    def plain_run(ms_fn, points_rotated=False):
        """The step through `ms_fn`, every choice held to the kernel
        run's: (total, losses, grads)."""
        nonlocal replay_cls, replay_masks
        replay_topk, replay_assign = iter(seen_topk), iter(seen_assign)
        replay_cls, replay_masks = iter(seen_cls), iter(seen_relu)
        replay_cells = iter(seen_cells)

        def replay_floor(x):
            held = next(replay_cells)
            held = held.roll(1, -1) if points_rotated else held
            cell_flips.append((torch.floor(x) != held).sum())
            return held

        state.optimizer.zero_grad()
        with mock.patch.object(msda, "ms_deform_attn", ms_fn), \
                mock.patch.object(msda, "torch", with_floor(replay_floor)), \
                mock.patch.object(dino_mod, "_stable_topk_indices",
                                  lambda x, k: next(replay_topk)), \
                mock.patch.object(crit_mod, "match_many",
                                  lambda *a, **kw: next(replay_assign)), \
                mock.patch.object(dino_mod, "class_prototypes",
                                  replay_protos), \
                mock.patch.object(layers_mod, "F", relu_held(replay_relu)), \
                mock.patch.object(transformer_mod, "F",
                                  relu_held(replay_relu)):
            total, losses = run(draws)
        assert next(replay_masks, None) is None, "the runs made other calls"
        assert next(replay_cells, None) is None, "the runs made other calls"
        return total, losses, {n: p.grad.clone() for n, p in
                               model.named_parameters() if p.grad is not None}

    replay_cls = replay_masks = None
    t0 = time.perf_counter()
    total_p, losses_p, grads_p = plain_run(msda.ms_deform_attn_plain)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    assert grads_k.keys() == grads_p.keys()
    g_norm = torch.stack([g.norm() for g in grads_p.values()]).norm().item()

    def against_plain(losses, grads):
        """The largest loss error (relative) and each tensor's gradient
        error relative to its norm; a tensor whose gradient is zero in
        exact arithmetic (a conv bias in front of a GroupNorm) is held
        against 1e-4 of the whole gradient's norm instead."""
        loss_rel = {k: abs(losses[k].item() - losses_p[k].item())
                    / max(abs(losses_p[k].item()), 1e-6) for k in losses_p
                    if not losses_only or k.startswith("loss")}
        grad_rel = {n: ((grads[n] - grads_p[n]).norm()
                        / max(grads_p[n].norm().item(), 1e-4 * g_norm)).item()
                    for n in grads_p}
        return loss_rel, grad_rel

    def summary(loss_rel, grad_rel):
        return dict(max_loss_rel=max(loss_rel.values()),
                    max_grad_rel=max(grad_rel.values()),
                    median_grad_rel=float(np.median(list(grad_rel.values()))),
                    worst_grad=max(grad_rel.items(), key=lambda kv: kv[1]))

    loss_rel, grad_rel = against_plain(losses_k, grads_k)
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:5]
    res = dict(total_kernel=total_k.item(), total_plain=total_p.item(),
               max_loss_rel=max(loss_rel.values()),
               worst_losses=sorted(loss_rel.items(),
                                   key=lambda kv: -kv[1])[:3],
               max_grad_rel=max(grad_rel.values()),
               median_grad_rel=float(np.median(list(grad_rel.values()))),
               worst_grads=worst,
               n_grads=len(grad_rel), plain_step_s=plain_s,
               topk_calls=len(seen_topk), match_calls=len(seen_assign),
               prototype_class_flips=list(cls_flips),
               relu_calls=len(seen_relu),
               relu_sign_flips=int(torch.stack(relu_flips).sum()),
               msda_calls=len(seen_cells) // 2,
               cell_flips=int(torch.stack(cell_flips).sum()))
    if floor_and_control:
        _, losses_r, grads_r = plain_run(plain_points_rotated(msda),
                                         points_rotated=True)
        res["floor"] = summary(*against_plain(losses_r, grads_r))
        with computed_in_f32(model):
            _, losses_f, grads_f = plain_run(msda.ms_deform_attn_plain)
        res["control"] = summary(*against_plain(losses_f, grads_f))
    state.optimizer.zero_grad()
    log(f"  step through kernels vs plain (tolerance {loss_tol} relative "
        f"for the losses, {grad_tol} for the gradients): {res}")
    assert res["max_loss_rel"] <= loss_tol, res
    assert res["max_grad_rel"] <= grad_tol, res
    if median_grad_tol is not None:
        assert res["median_grad_rel"] <= median_grad_tol, res
    if floor_and_control:
        assert res["control"]["median_grad_rel"] > median_grad_tol, res
    return res


def c2f_train_state(n_batches, config=C2F, seed=0, device=None, **overrides):
    """(state, criterion config, weight dict, config) of a C2F
    configuration (with `overrides`, e.g. amp_dtype) with seeded random
    weights on `device` (default: the card), TF32 off."""
    from datr_torch.config import load_config
    from datr_torch.models import dino as dino_mod
    from datr_torch.train.criterion import criterion_from_config
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(config)
    cfg.update(overrides)
    model = dino_mod.build_dino_from_config(cfg, device, seed=seed)
    ccfg, wd = criterion_from_config(cfg, model)
    opt = Optimizer(model, lr=cfg.lr, lr_backbone=cfg.lr_backbone,
                    weight_decay=cfg.weight_decay,
                    clip_max_norm=cfg.clip_max_norm,
                    lr_drop_step=cfg.lr_drop * n_batches)
    return create_train_state(model, opt, seed=seed), ccfg, wd, cfg


def training_msda_calls(msda, state, batch) -> dict:
    """The MSDA inputs of one training forward (source and target pass) of
    the model as it stands, by Lq."""
    from datr_torch.models import cdn as cdn_mod

    model = state.model
    groups, _ = cdn_mod.cdn_layout(model.dn_number, model.dn_single_pad)
    draws = cdn_mod.draw_cdn_noise(torch.Generator().manual_seed(7), 2,
                                   groups, model.dn_single_pad,
                                   model.num_classes, batch["images"].device)
    return capture_msda_calls(msda, lambda: model.train()(
        batch["images"], batch["pad_mask"],
        targets={k: batch[k] for k in ("boxes", "labels", "valid")},
        train=True, global_proto=state.global_proto, amount=state.amount,
        dn_draws=draws))


def run_training(msda, card):
    """The burn-in training slice at full width through engine's
    train_one_epoch, ending with the profile of one step (the caller runs
    this phase last: the profile's trace overflows the profiler's buffers,
    and later profiles in the process see no device time)."""
    from datr_torch.engine import train_one_epoch
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.train.steps import loss_and_grads, train_step_burnin

    n_batches = 4  # one warm-up step, then the timed ones
    base_gb = torch.cuda.memory_allocated() / 1e9
    state, ccfg, wd, _ = c2f_train_state(n_batches)
    model = state.model
    trainable = {n: p.detach().clone() for n, p in model.named_parameters()
                 if p.requires_grad}
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in trainable.values())
    log(f"  C2F burn-in: {n_params} parameters ({n_train} trainable), "
        f"use_remat {model.use_remat}, canvas {TRAIN_CANVAS}, 4 images per "
        f"step")
    t0 = time.perf_counter()
    batches = paired_batches(n_batches, "cuda", seed=0)
    log(f"  synthetic batches built in {time.perf_counter() - t0:.2f} s")

    # launches per step, from the model: every MSDeformAttn runs once per
    # pass (source and target), once more in the backward's recompute
    # under use_remat, and its backward once per pass
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    want_fwd = 2 * n_msda * (2 if model.use_remat else 1)
    want_bwd = 2 * n_msda

    # ---- msda_fwd / msda_bwd at the locations this model produces ----
    calls = training_msda_calls(msda, state, batches[0])
    at_model = check_model_locations(
        msda, calls, dict(encoder=TRAIN_S, decoder_src=TRAIN_DEC_LQ[0],
                          decoder_tgt=TRAIN_DEC_LQ[1]), TRAIN_SHAPES,
        backward=True)
    del calls
    torch.cuda.empty_cache()

    warm = train_one_epoch(state, batches[:1], ccfg, wd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = batches[1:]
    # ---- the main path: counts from 0, steps, counts read ----
    r = timed_epoch(msda, lambda: train_one_epoch(state, steps, ccfg, wd),
                    len(steps))
    metrics, launches = r["metrics"], r["launches"]
    step_s, peak_gb = r["step_s"], r["peak_memory_gb"]
    log(f"  {len(steps)} steps: {step_s:.3f} s/step by CUDA events "
        f"({r['host_step_s']:.3f} s/step host), "
        f"{4 / step_s:.3f} img/s, peak memory {peak_gb:.2f} GB ("
        f"{base_gb:.2f} GB allocated before the phase) on {card}")
    log(f"  launches {launches}; per step expected msda_fwd {want_fwd}, "
        f"msda_bwd {want_bwd} ({n_msda} MSDeformAttn x 2 passes)")
    log(f"  mean metrics: loss {metrics['loss']:.4f}, grad_norm "
        f"{metrics['grad_norm']:.4f} (warm-up loss {warm['loss']:.4f})")
    assert launches == dict(msda_fwd=want_fwd * len(steps),
                            msda_bwd=want_bwd * len(steps)), launches
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    # the weighted loss terms are exactly build_weight_dict's keys; the
    # criterion's other keys are logging-only (loss_xy / loss_hw, errors)
    weighted = {k for k in metrics if k.startswith("loss_")
                and not k.startswith(("loss_xy", "loss_hw"))}
    assert weighted == set(wd), weighted ^ set(wd)
    unchanged = [n for n, p in model.named_parameters() if p.requires_grad
                 and torch.equal(p.detach(), trainable[n])]
    assert not unchanged, f"trainable parameters unchanged: {unchanged}"
    assert state.step == n_batches and state.amount.sum().item() > 0

    check = check_step_against_plain(
        state, lambda d: loss_and_grads(state, batches[0], ccfg, wd, d)[:2],
        msda)

    log("  profile of one burn-in step")
    profile = profile_step(lambda: train_step_burnin(
        state, batches[1], ccfg, wd)["loss"].item(),
        kernels=("msda_fwd", "msda_bwd"), top=15)
    return dict(launches=launches, steps=len(steps),
                launches_per_step=dict(msda_fwd=want_fwd, msda_bwd=want_bwd),
                step_s=step_s, img_s=4 / step_s,
                host_step_s=r["host_step_s"], peak_memory_gb=peak_gb,
                allocated_before_gb=base_gb, loss=metrics["loss"],
                against_plain=check, model_locations=at_model,
                profile=profile)


# ---------------------------------------------------------------- phase 6

C2F_ST = ("configs/DA/Cityscapes2FoggyCityscapes/"
          "DINO_4scale_C2F_self_training.py")


def pseudo_threshold(state, batches, k=30) -> float:
    """A score threshold under which each target image of `batches` keeps
    at least its k best (query, class) candidates before NMS: the seeded
    teacher scores about 0.01 everywhere (the class bias prior), so the
    configured 0.3 would keep nothing and the target loss would be 0."""
    kth = []
    with torch.no_grad():
        for b in batches:
            out = state.ema_teacher(b["images"][2:], b["pad_mask"][2:])
            s = out["pred_logits"].sigmoid().flatten(1)
            kth.append(s.sort(-1, descending=True).values[:, k - 1])
    return float(torch.cat(kth).min())


def check_eval_against_plain(model, batch, msda) -> dict:
    """One eval batch's detections (eval_step: forward + top-300) through
    the kernels against the plain forward's, with the two-stage top-k and
    the detections' top-k held to the kernel run's: boxes (normalized by
    the image size) atol 1e-4, scores atol 1e-3."""
    from datr_torch.models import dino as dino_mod
    from datr_torch.models import postprocess as pp_mod
    from datr_torch.train.steps import eval_step

    seen = {"dino": [], "pp": []}

    def rec(key, fn):
        def f(x, k):
            seen[key].append(fn(x, k))
            return seen[key][-1]
        return f

    with mock.patch.object(dino_mod, "_stable_topk_indices",
                           rec("dino", dino_mod._stable_topk_indices)), \
            mock.patch.object(pp_mod, "_stable_topk_indices",
                              rec("pp", pp_mod._stable_topk_indices)):
        got = eval_step(model, batch)
    replay = {k: iter(v) for k, v in seen.items()}
    with mock.patch.object(msda, "ms_deform_attn",
                           msda.ms_deform_attn_plain), \
            mock.patch.object(dino_mod, "_stable_topk_indices",
                              lambda x, k: next(replay["dino"])), \
            mock.patch.object(pp_mod, "_stable_topk_indices",
                              lambda x, k: next(replay["pp"])):
        want = eval_step(model, batch)
    torch.cuda.synchronize()
    hw = batch["orig_sizes"].flip(-1).repeat(1, 2)[:, None, :]
    diffs = dict(boxes=((got["boxes"] - want["boxes"]) / hw).abs().max()
                 .item(),
                 scores=(got["scores"] - want["scores"]).abs().max().item())
    tol = dict(boxes=1e-4, scores=1e-3)
    log(f"  eval detections through the kernels vs the plain forward "
        f"(tolerance atol {tol}): {diffs}")
    for k, t in tol.items():
        assert diffs[k] <= t, f"eval detections: {k} {diffs[k]}"
    return diffs


def cuda_timed(fn):
    """(fn(), device ms between events recorded before and after fn on the
    current stream: the work fn queues, plus any wait of the stream on the
    host inside fn)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def check_checkpoints(state, cfg, ap50) -> dict:
    """save_checkpoint / load_checkpoint of the whole state into a fresh
    one, and a BestTracker family reloaded by load_resume into all four
    module copies, in a temporary directory: every tensor back bitwise."""
    import tempfile

    from datr_torch.models import dino as dino_mod
    from datr_torch.train import checkpoint as ckpt
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import EMA_TRACKS, create_train_state

    def tensors(st):
        out = {f"model.{k}": v for k, v in st.model.state_dict().items()}
        for n in EMA_TRACKS:
            out.update({f"{n}.{k}": v
                        for k, v in getattr(st, n).state_dict().items()})
        for i, ps in st.optimizer.opt.state_dict()["state"].items():
            out.update({f"opt.{i}.{k}": v for k, v in ps.items()})
        out.update(global_proto=st.global_proto, amount=st.amount,
                   generator=st.dn_generator.get_state())
        return out

    fresh_model = dino_mod.build_dino_from_config(cfg, seed=9)
    fresh = create_train_state(fresh_model, Optimizer(fresh_model), seed=9)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save_checkpoint(f"{d}/checkpoint", state, 0, {"best": {}})
        save_s = time.perf_counter() - t0
        size_gb = sum(os.path.getsize(f"{d}/{f}") for f in os.listdir(d)) \
            / 1e9
        t0 = time.perf_counter()
        fresh, start, meta = ckpt.maybe_auto_resume(d, fresh)
        load_s = time.perf_counter() - t0
        want, got = tensors(state), tensors(fresh)
        assert want.keys() == got.keys() and start == 1, (start, meta)
        bad = [k for k in want if not torch.equal(want[k], got[k])]
        assert not bad, f"not bitwise after the round trip: {bad[:5]}"
        assert (fresh.step, fresh.ema_updates) == (state.step,
                                                   state.ema_updates)
        tracker = ckpt.BestTracker(d)
        assert tracker.update("best_ema_teacher", ap50, state.ema_teacher, 0)
        fresh, start, meta = ckpt.load_resume(f"{d}/best_ema_teacher", fresh)
        teacher = state.ema_teacher.state_dict()
        for m in (fresh.model, *(getattr(fresh, n) for n in EMA_TRACKS)):
            bad = [k for k, v in m.state_dict().items()
                   if not torch.equal(v, teacher[k])]
            assert not bad, f"best family not bitwise: {bad[:5]}"
        assert start == 0 and meta["ap50"] == ap50
        log_best = open(f"{d}/log_best.txt").read().strip()
    res = dict(tensors=len(want), size_gb=size_gb, save_s=save_s,
               load_s=load_s, log_best=log_best)
    log(f"  checkpoint round trips bitwise: {res}")
    del fresh, fresh_model
    return res


def run_self_training(msda, card) -> dict:
    """The self-training slice at full width: the C2F self-training
    configuration, teacher = a copy of the seeded student, through engine's
    train_one_epoch_self_training, update_emas_per_epoch, evaluate with the
    EMA teacher, and the checkpoints."""
    from datr_torch import engine
    from datr_torch.data.synthetic import (
        SyntheticDetectionDataset,
        synthetic_eval_batches,
    )
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.train.ema import ema_update, ramped_decay
    from datr_torch.train.pseudo import pseudo_labels_from_outputs
    from datr_torch.train.steps import eval_step, self_training_loss_and_grads

    n_batches = 4  # one warm-up step, then the timed ones
    base_gb = torch.cuda.memory_allocated() / 1e9
    state, ccfg, wd, cfg = c2f_train_state(n_batches, C2F_ST, seed=1)
    model = state.model
    log(f"  C2F self-training: epochs {cfg.epochs}, burn_epochs "
        f"{cfg.burn_epochs}, use_remat {model.use_remat}, canvas "
        f"{TRAIN_CANVAS}, 2 + 2 images per step, 4 copies of the model "
        f"(student, ema_teacher, best_ema, model_ema)")
    t0 = time.perf_counter()
    batches = paired_batches(n_batches, "cuda", seed=2, strong=True)
    log(f"  synthetic batches (with the strong view) built in "
        f"{time.perf_counter() - t0:.2f} s")
    thr = pseudo_threshold(state, batches)
    thresholds = np.full((model.num_classes,), thr, np.float32)
    log(f"  pseudo-label threshold for this run {thr:.6f} (configured "
        f"{cfg.pseudo_label_threshold}; the seeded teacher's scores sit "
        f"near 0.01)")

    # per step: the teacher's eval forward (one pass), the student's two
    # passes (again in remat's recompute) and their backward
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    want_fwd = n_msda + 2 * n_msda * (2 if model.use_remat else 1)
    want_bwd = 2 * n_msda

    warm = engine.train_one_epoch_self_training(
        state, batches[:1], ccfg, wd, thresholds, TRAIN_CANVAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = batches[1:]
    num_pseudo = []
    real_step = engine.train_step_self_training

    def recorded(*a, **kw):  # the metrics stay on the device
        m = real_step(*a, **kw)
        num_pseudo.append(m["num_pseudo"])
        return m

    # ---- the main path: counts from 0, steps, counts read ----
    with mock.patch.object(engine, "train_step_self_training", recorded):
        r = timed_epoch(msda, lambda: engine.train_one_epoch_self_training(
            state, steps, ccfg, wd, thresholds, TRAIN_CANVAS), len(steps))
    metrics, launches = r["metrics"], r["launches"]
    step_s, peak_gb = r["step_s"], r["peak_memory_gb"]
    num_pseudo = [int(n) for n in num_pseudo]
    log(f"  {len(steps)} steps: {step_s:.3f} s/step by CUDA events "
        f"({r['host_step_s']:.3f} s/step host), {4 / step_s:.3f} img/s "
        f"(2 + 2 images; the teacher's 2 more), peak memory {peak_gb:.2f} "
        f"GB ({base_gb:.2f} GB allocated before the phase) on {card}")
    log(f"  num_pseudo per step {num_pseudo} (warm-up "
        f"{warm['num_pseudo']:.0f}); launches {launches}; per step expected "
        f"msda_fwd {want_fwd}, msda_bwd {want_bwd} ({n_msda} MSDeformAttn: "
        f"teacher 1 pass, student 2 passes)")
    log(f"  mean metrics: loss {metrics['loss']:.4f}, loss_ce_target "
        f"{metrics['loss_ce_target']:.4f}, loss_bbox_target "
        f"{metrics['loss_bbox_target']:.4f}, grad_norm "
        f"{metrics['grad_norm']:.4f}")
    assert launches == dict(msda_fwd=want_fwd * len(steps),
                            msda_bwd=want_bwd * len(steps)), launches
    assert len(num_pseudo) == len(steps) and min(num_pseudo) > 0, num_pseudo
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    weighted = {k for k in metrics if k.startswith("loss_")
                and not k.startswith(("loss_xy", "loss_hw"))}
    assert weighted == set(wd) | {f"{k}_target" for k in wd if "_dn" not in
                                  k and not k.endswith("_DA")}, weighted
    assert metrics["loss_ce_target"] > 0 and metrics["loss_bbox_target"] > 0
    assert state.step == n_batches

    # ---- device time of the parts of one step, by CUDA events ----
    b = batches[1]
    thr_t = torch.as_tensor(thresholds, device=state.amount.device)
    with torch.no_grad():
        out, teacher_ms = cuda_timed(lambda: state.ema_teacher(
            b["images"][2:], b["pad_mask"][2:]))
    pseudo, pseudo_ms = cuda_timed(lambda: pseudo_labels_from_outputs(
        out["pred_logits"], out["pred_boxes"], TRAIN_CANVAS, thr_t))
    _, student_ms = cuda_timed(lambda: self_training_loss_and_grads(
        state, b, ccfg, wd, pseudo))
    state.optimizer.zero_grad()
    parts = dict(teacher_forward_ms=teacher_ms, pseudo_labels_ms=pseudo_ms,
                 student_forward_losses_backward_ms=student_ms)
    log(f"  one step's parts by CUDA events: {parts}")

    # ---- one step through the kernels against the plain versions, the
    # pseudo-labels made once (through the kernels) and fed to both ----
    def run(draws):
        total, src, tgt, _ = self_training_loss_and_grads(
            state, b, ccfg, wd, pseudo, draws)
        return total, {**src, **{f"{k}_target": v for k, v in tgt.items()}}

    check = check_step_against_plain(state, run, msda)
    del out

    # ---- the per-epoch EMA update (its kernels loaded first, on a small
    # module: the first launch of each loads it) ----
    small = torch.nn.Linear(4, 4).cuda()
    ema_update(small, small, ramped_decay(0.9, 1))
    teacher_w = state.ema_teacher.class_head.weight.clone()
    _, ema_ms = cuda_timed(lambda: engine.update_emas_per_epoch(
        state, cfg.burn_epochs, cfg))
    assert state.ema_updates == 1
    assert not torch.equal(teacher_w, state.ema_teacher.class_head.weight)
    log(f"  update_emas_per_epoch: {ema_ms:.3f} ms by CUDA events")

    # ---- evaluate with the EMA teacher: 8 target images, batch 2 ----
    ev_ds = SyntheticDetectionDataset(8, (1024, 2048), 8, max_objects=16,
                                      seed=4, fog=0.35)
    ev = synthetic_eval_batches(ev_ds, 2, TRAIN_CANVAS, max_boxes=100,
                                device="cuda")
    msda.msda_fwd.launches = 0
    t0 = time.perf_counter()
    stats = engine.evaluate(state.ema_teacher, ev, range(cfg.num_classes))
    eval_wall_s = time.perf_counter() - t0
    eval_launches = msda.msda_fwd.launches
    n_img = len(ev_ds)
    # the eval steps alone (forward + top-300), back to back on the card
    _, eval_ms = cuda_timed(lambda: [eval_step(state.ema_teacher, x)
                                     for x in ev])
    log(f"  evaluate (EMA teacher), {n_img} images at {TRAIN_CANVAS}, batch "
        f"2: {n_img / eval_wall_s:.3f} img/s wall (COCO stats included); "
        f"its eval steps back to back {n_img * 1e3 / eval_ms:.3f} img/s by "
        f"CUDA events; msda_fwd launches {eval_launches} "
        f"({eval_launches / len(ev)} per forward)")
    log(f"  COCO stats {stats['coco_eval_bbox']}")
    assert eval_launches == n_msda * len(ev), eval_launches
    assert len(stats["coco_eval_bbox"]) == 12
    assert all(np.isfinite(stats["coco_eval_bbox"]))
    eval_check = check_eval_against_plain(state.ema_teacher, ev[0], msda)

    ckpt_res = check_checkpoints(state, cfg, max(stats["ap50"], 0.0) + 0.5)
    return dict(launches=launches, steps=len(steps),
                launches_per_step=dict(msda_fwd=want_fwd, msda_bwd=want_bwd),
                step_s=step_s, img_s=4 / step_s,
                host_step_s=r["host_step_s"], peak_memory_gb=peak_gb,
                allocated_before_gb=base_gb, threshold=thr, num_pseudo=num_pseudo, loss=metrics["loss"],
                parts=parts, against_plain=check, ema_update_ms=ema_ms,
                eval=dict(images=n_img, batches=len(ev),
                          eval_steps_device_ms=eval_ms,
                          img_s=n_img * 1e3 / eval_ms,
                          wall_img_s=n_img / eval_wall_s,
                          launches=eval_launches,
                          coco_eval_bbox=stats["coco_eval_bbox"],
                          against_plain=eval_check),
                checkpoints=ckpt_res)


def run_gather_bench(gather, bench) -> dict:
    """The gather bench entry point on the card, counts from 0. The bench
    holds each kernel against its plain version on the card (row_gather
    exact, gather_fma within one bf16 rounding) and times the kernel, the
    plain version and the yardstick by the profiler's device time, beside
    the launch floor; the bound is the bytes it reports over the memory
    rate (the 5.8 MB table is L2-resident, so this HBM bound is loose)."""
    gather.row_gather.launches = gather.gather_fma.launches = 0
    results = bench.run("cuda")
    launches = dict(row_gather=gather.row_gather.launches,
                    gather_fma=gather.gather_fma.launches)
    floor = results[0]["floor"]
    cases = {}
    for r in results:
        bound_ms, bound_by = roofline(r["bytes"], r["flops"])
        cases[r["case"]] = dict(
            kernel=r["kernel"], rows=r["rows"], ok=r["ok"],
            max_abs_err=r["max_abs_err"], ms=r["device_ms"],
            plain_ms=r["plain_device_ms"], library_ms=r["library_device_ms"],
            event_ms=r["ms"], bound_ms=bound_ms, bound_by=bound_by,
            floor_ms=r["floor_ms"], launches=r["launches"],
            table_rows_read=r["table_rows_read"])
        lib = (f"{r['library_device_ms']:.5f} ms = "
               f"{r['library_rows_per_s'] / 1e9:.3f} Grows/s"
               if r["library_device_ms"] else "refused bf16")
        log(f"  {r['case']}: {r['kernel']} ok {r['ok']} (max_abs_err "
            f"{r['max_abs_err']:.3g}); device {r['device_ms']:.5f} ms = "
            f"{r['rows_per_s'] / 1e9:.3f} Grows/s ({r['ms']:.5f} ms per "
            f"call by events); plain {r['plain_device_ms']:.5f} ms; "
            f"{r['library']} {lib}; bound {bound_ms:.5f} ms ({bound_by}); "
            f"launch floor {r['floor_ms']:.5f} ms "
            f"({r['device_ms'] / r['floor_ms']:.2f}x); {r['launches']} "
            f"launches")
    log(f"  launch floor: row_gather on one row {floor['row_gather_ms']:.5f}"
        f" ms, index_select on one row {floor['index_select_ms']:.5f} ms "
        f"(kernels per call {floor['row_gather_kernels']}, "
        f"{floor['index_select_kernels']}; {floor['launches']} launches); "
        f"launches {launches}")
    assert all(r["ok"] for r in results), results
    assert launches["row_gather"] > 0 and launches["gather_fma"] > 0
    assert launches["row_gather"] == floor["launches"] + sum(
        r["launches"] for r in results if r["kernel"] == "row_gather")
    return dict(cases=cases, launches=launches, floor=floor)


def check_gather_fma(gather, bench) -> dict:
    """gather_fma at each of its instantiations against its plain version's
    f32 sum, within one bf16 rounding (TOL["bf16"]): K = 16 (one unrolled
    chunk, 16-byte index loads) and K = 1, 3, 36 (chunks of 8), each at
    n_out 2,048, 37 and 1 (37 x 16 and 16 threads fill no whole block),
    with and without indices outside the table (-1, T, T + 7: they
    read as zero rows; the plain version takes their weight as 0); and K =
    16 from idx / w one element past a 16-byte boundary (chunks of 8).
    Returns the max abs error by case."""
    errs = {}

    def check(name, table, idx, w, k, want):
        got = gather.gather_fma(table, idx, w, k)
        torch.cuda.synchronize()
        errs[name] = (got.float() - want).abs().max().item()
        torch.testing.assert_close(got.float(), want, **TOL["bf16"],
                                   msg=lambda m: f"gather_fma {name}: {m}")

    for k in (1, 3, 16, 36):
        for n_out in (2048, 37, 1):
            table, idx, w = bench.bench_inputs("cuda", seed=k, k=k,
                                               n_out=n_out)
            t = table.shape[0]
            check(f"K={k} n_out={n_out}", table, idx, w, k,
                  gather.gather_fma_plain(table.float(), idx, w, k))
            bad = idx.clone()
            bad[0::9], bad[3::9], bad[6::9] = -1, t, t + 7
            inside = (bad >= 0) & (bad < t)
            check(f"K={k} n_out={n_out} outside", table, bad, w, k,
                  gather.gather_fma_plain(table.float(), bad.clamp(0, t - 1),
                                          w * inside[:, None], k))
            if k == 16:
                idx_m = torch.empty(idx.numel() + 1, dtype=torch.int32,
                                    device="cuda")[1:]
                w_m = torch.empty(idx.numel() + 1, device="cuda")[1:]
                idx_m.copy_(idx)
                w_m.copy_(w.view(-1))
                check(f"K={k} n_out={n_out} misaligned", table, idx_m,
                      w_m.view(-1, 1), k,
                      gather.gather_fma_plain(table.float(), idx, w, k))
    log(f"  gather_fma instantiations against the plain version, max_abs_"
        f"err: {errs}")
    return errs


# ---------------------------------------------------------------- phase 7

LOG_KEYS = {"epoch", "lr", "ap50_student", "ap50_teacher", "time"}


def loader_rate(threads=4, n_batches=8) -> dict:
    """img/s of the host loader at Cityscapes size: make_da_loader over
    synthetic 1024x2048 frames with the C2F transforms, the strong view
    computed (a self-training epoch's batches), `threads` threads, 2 + 2
    images per batch onto the 1216x2048 canvas. The first batch's wait is
    reported apart (each thread starts on its first batch at once)."""
    from datr_torch.config import load_config
    from datr_torch.data.loader import make_da_loader
    from datr_torch.data.synthetic import synthetic_da_pair
    from datr_torch.data.transforms import DATrainTransform

    cfg = load_config(C2F_ST)
    ds = synthetic_da_pair(n_images=2 * n_batches, hw=(1024, 2048),
                           num_classes=8)
    tf = DATrainTransform(cfg.data_aug_scales, cfg.data_aug_max_size,
                          cfg.data_aug_scales2_resize,
                          cfg.data_aug_scales2_crop)
    t0 = time.perf_counter()
    n_img, first_s = 0, None
    for b in make_da_loader(ds, 2, TRAIN_CANVAS, tf, 100, seed=0,
                            num_threads=threads, compute_strong=True):
        assert b["images"].shape == (4, *TRAIN_CANVAS, 3)
        assert b["images_strong"].shape == b["images"].shape
        n_img += b["images"].shape[0]
        first_s = first_s or time.perf_counter() - t0
    wall_s = time.perf_counter() - t0
    res = dict(threads=threads, batches=n_batches, images=n_img,
               wall_s=wall_s, img_s=n_img / wall_s, first_batch_s=first_s,
               cpus=os.cpu_count())
    log(f"  host loader (make_da_loader, compute_strong, {threads} threads, "
        f"1024x2048 synthetic frames, C2F transforms): {n_img} images "
        f"(+ {n_img // 2} strong views) in {wall_s:.2f} s = "
        f"{res['img_s']:.3f} img/s; first batch after {first_s:.2f} s; "
        f"{os.cpu_count()} CPUs")
    return res


def run_cli(msda, card, flags=()) -> dict:
    """`datr_torch.main.main(args)` in this process on the C2F
    self-training config, --synthetic, synthetic_images=4 epochs=2
    burn_epochs=1 (one burn-in and one self-training epoch of 2 steps,
    2 + 2 images per step at 1216x2048), with `flags` (e.g. `--amp`), in a
    temporary output directory.
    Holds the log.txt lines to datr_tpu's keys, checks the checkpoint and
    the families, and the msda_fwd / msda_bwd launches against the count
    derived from the steps and eval batches this run made. Times each
    epoch's parts (the train loop, evaluations, checkpoint saves, the EMA
    update) by wrapping main's calls, each synchronized at its end."""
    import tempfile

    from datr_torch import engine
    from datr_torch import main as main_mod
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.train import checkpoint as ckpt

    base_gb = torch.cuda.memory_allocated() / 1e9
    events, seen = [], {}
    calls = {"burnin": 0, "self_training": 0, "eval": 0}

    def timed(name, fn):
        def f(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            events.append((name, time.perf_counter() - t0))
            return out
        return f

    def counted(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f

    def keep_state(fn):
        def f(*a, **kw):
            seen["state"] = fn(*a, **kw)
            return seen["state"]
        return f

    patches = [
        mock.patch.object(main_mod, name, timed(name, getattr(main_mod,
                                                              name)))
        for name in ("train_one_epoch", "train_one_epoch_self_training",
                     "evaluate", "update_emas_per_epoch")]
    save = timed("save_checkpoint", ckpt.save_checkpoint)
    patches += [
        mock.patch.object(main_mod, "save_checkpoint", save),
        mock.patch.object(ckpt, "save_checkpoint", save),
        mock.patch.object(main_mod, "create_train_state",
                          keep_state(main_mod.create_train_state)),
        mock.patch.object(engine, "train_step_burnin",
                          counted("burnin", engine.train_step_burnin)),
        mock.patch.object(engine, "train_step_self_training",
                          counted("self_training",
                                  engine.train_step_self_training)),
        mock.patch.object(engine, "eval_step",
                          counted("eval", engine.eval_step)),
    ]
    with tempfile.TemporaryDirectory() as out_dir:
        args = main_mod.get_args_parser().parse_args([
            "-c", C2F_ST, "--synthetic", "--output_dir", out_dir, *flags,
            "--options", "synthetic_images=4", "epochs=2", "burn_epochs=1"])
        torch.cuda.reset_peak_memory_stats()
        for pt in patches:
            pt.start()
        # ---- the main path: counts from 0, the CLI, counts read ----
        msda.msda_fwd.launches = msda.msda_bwd.launches = 0
        t0 = time.perf_counter()
        try:
            main_mod.main(args)
            torch.cuda.synchronize()
        finally:
            for pt in patches:
                pt.stop()
        wall_s = time.perf_counter() - t0
        launches = dict(msda_fwd=msda.msda_fwd.launches,
                        msda_bwd=msda.msda_bwd.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lines = [json.loads(ln) for ln in open(f"{out_dir}/log.txt")
                 if ln.startswith("{")]
        files = sorted(os.listdir(out_dir))
        sizes = {f: os.path.getsize(f"{out_dir}/{f}") / 1e9 for f in files
                 if not f.endswith((".json", ".txt"))}
    state = seen.pop("state")
    model = state.model
    dtype = str(model.dtype).split(".")[-1]
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    remat = 2 if model.use_remat else 1
    # burn-in step: 2 passes, recomputed under remat, 2 backward; a
    # self-training step adds the teacher's one pass; eval: one pass
    want = dict(
        msda_fwd=(calls["burnin"] * 2 * n_msda * remat
                  + calls["self_training"] * (n_msda + 2 * n_msda * remat)
                  + calls["eval"] * n_msda),
        msda_bwd=(calls["burnin"] + calls["self_training"]) * 2 * n_msda)
    del state, model
    # the parts of each epoch: events between one train loop and the next
    epochs, cur = [], None
    for name, sec in events:
        if name.startswith("train_one_epoch"):
            cur = {"train_s": sec}
            epochs.append(cur)
        else:
            key = {"evaluate": "eval_s", "save_checkpoint": "save_s",
                   "update_emas_per_epoch": "ema_s"}[name]
            cur[key] = cur.get(key, 0.0) + sec
            cur[f"n_{key[:-2]}"] = cur.get(f"n_{key[:-2]}", 0) + 1
    for ep, ln in zip(epochs, lines):
        ep["log_time_s"] = ln["time"]
    res = dict(dtype=dtype, wall_s=wall_s, epochs=epochs, calls=calls,
               launches=launches,
               launches_derived=want, n_msda=n_msda, peak_memory_gb=peak_gb,
               allocated_before_gb=base_gb, files=files, sizes_gb=sizes,
               log_lines=[{k: v for k, v in ln.items()
                           if not k.startswith("train_") or k in (
                               "train_loss", "train_num_pseudo")}
                          for ln in lines])
    log(f"  CLI (python -m datr_torch.main -c {C2F_ST} --synthetic "
        f"{' '.join(flags)} --options synthetic_images=4 epochs=2 "
        f"burn_epochs=1), model {dtype}: {wall_s:.2f} s in main, peak "
        f"{peak_gb:.2f} GB ({base_gb:.2f} GB before) on {card}")
    for i, ep in enumerate(epochs):
        log(f"  epoch {i}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in ep.items()))
    log(f"  steps and eval batches {calls}; launches {launches}, derived "
        f"{want} ({n_msda} MSDeformAttn, remat x{remat})")
    log(f"  log.txt lines {res['log_lines']}; files {files}")
    assert len(lines) == 2, lines
    for i, ln in enumerate(lines):
        extra = {"ap50_best_ema"} if i == 1 else set()
        assert {k for k in ln if not k.startswith("train_")} == \
            LOG_KEYS | extra, ln.keys()
        assert ln["epoch"] == i and np.isfinite(ln["train_loss"]), ln
    assert "train_num_pseudo" in lines[1]
    for name in ("checkpoint", "checkpoint0000", "checkpoint0001",
                 "checkpoint_best_regular", "best_ema_teacher",
                 "best_ema_model", "config_args_all.json", "log_best.txt"):
        assert name in files, (name, files)
    assert calls["burnin"] == calls["self_training"] == 2, calls
    assert launches == want, (launches, want)
    return res


# ---------------------------------------------------------------- phase 8

# DINO_5scale's levels on the 800x1344 canvas (strides 4-64)
SHAPES5 = ((200, 336), (100, 168), (50, 84), (25, 42), (13, 21))
S5 = sum(h * w for h, w in SHAPES5)  # 89,523 tokens
# the bf16 model against its plain bf16 version: the forward's outputs
# (atol), one training step's losses and gradients (relative). The kernel
# and plain runs first differ by one bf16 rounding in a few MSDA outputs
# (their f32 sums differ in order), and bf16 arithmetic compounds that
# through the model. Each check also reads a floor, the plain run against
# itself with its MSDA's points summed in another order (the same
# compounding, no kernel), and a control, the model computing in f32. On an
# NVIDIA H100 80GB HBM3 at 700 W (kernel / floor / control):
# - serving forward: memory 0.0625 / 0.0625-0.078 / 0.066-0.068 at most and
#   5.0e-3 / 4.9-5.0e-3 / 7.7e-3 on average; logits 0.03125 (one ulp at
#   |x| in [4, 8)) / 0.03125 / 0.044-0.045; boxes 0 (the box head's last
#   layer starts at zero, so the random-weight boxes are the held
#   proposals'). The largest differences do not separate bf16 from f32, so
#   memory is held at 2^-3 and boxes at 1e-2 (a limit of 1e-2 on memory
#   would lie below the floor); the mean memory (6.5e-3) and the logits
#   (0.04) lie between floor and control, and the control must exceed
#   them.
# - training step (burn-in; self-training), with the MSDA cells held too,
#   over three runs: losses 1.0-1.3e-3 / 0.7-1.2e-3 / 1.8-3.4e-3;
#   2.0-2.1e-3 / 1.1-1.9e-3 / 4.7-6.9e-3; median gradient 3.4-3.7e-3 /
#   3.2-3.7e-3 / 1.4e-2; 2.7-2.8e-3 / 2.7-3.0e-3 / 1.9-2.3e-2; largest
#   gradient 6.4-7.7e-2 / 6.6-7.5e-2 / 7.5-9.8e-2; 8.1e-2-0.107 /
#   7.6e-2-0.111 / 6.5-8.5e-2, the decoder's sampling offsets, whose
#   gradient is bilinear slopes times differences of bf16 values (without
#   the cells held: 0.233 / 0.243 / 0.266). Neither the losses nor the
#   largest gradient separate bf16 from f32: held at 5e-3 and 0.15 per
#   tensor, above the floors (2e-2 per tensor would lie below them); the
#   median gradient at 6e-3, between floor and control, which must exceed
#   it. The class and cardinality errors (argmax counts over bf16 logits
#   with ties) are left out.
BF16_FWD_TOL = {"memory": 2.0 ** -3, "memory_mean_abs": 6.5e-3,
                "pred_logits": 0.04, "pred_boxes": 1e-2, "topk_scores": 5e-2}
BF16_FWD_SEPARATES = ("memory_mean_abs", "pred_logits")
BF16_STEP_TOL = dict(loss_tol=5e-3, grad_tol=0.15, median_grad_tol=6e-3,
                     losses_only=True, floor_and_control=True)
BF16 = dict(amp_dtype="bfloat16")


def check_msda_bf16(msda) -> dict:
    """msda_fwd and msda_bwd with bf16 value against their plain versions:
    the serving shapes (forward), the training shapes (forward and
    backward), DINO_5scale's five levels (S = 89,523) and
    DINO_4scale_fast's two points per level in f32 and bf16; then msda_bwd
    in bf16 beside f32 at the training shapes, random locations, timed in
    this call (and msda_fwd in bf16 there)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    dec_src, dec_tgt = TRAIN_DEC_LQ
    # (name, shapes, Lq, dtype, P, backward)
    cases = [("serve enc", SHAPES, S, bf, P, False),
             ("serve dec", SHAPES, N_QUERIES, bf, P, False),
             ("train enc", TRAIN_SHAPES, TRAIN_S, bf, P, True),
             ("train dec src", TRAIN_SHAPES, dec_src, bf, P, True),
             ("train dec tgt", TRAIN_SHAPES, dec_tgt, bf, P, True),
             ("5-scale enc", SHAPES5, S5, f32, P, False),
             ("5-scale enc", SHAPES5, S5, bf, P, True),
             ("5-scale dec", SHAPES5, N_QUERIES, f32, P, True),
             ("5-scale dec", SHAPES5, N_QUERIES, bf, P, True),
             ("P=2 enc", SHAPES, S, f32, 2, True),
             ("P=2 enc", SHAPES, S, bf, 2, True),
             ("P=2 dec", SHAPES, N_QUERIES, f32, 2, True),
             ("P=2 dec", SHAPES, N_QUERIES, bf, 2, True)]
    errs = {}
    for name, sh, lq, dtype, p, backward in cases:
        value, loc, attn = msda_inputs(gen, lq, dtype, shapes=sh, p=p)
        name = f"{name} Lq={lq} {dtype_name(value)} L={len(sh)} P={p}"
        errs[f"msda_fwd {name}"] = check_fwd(msda, name, value, sh, loc,
                                             attn)
        if backward:
            g = torch.randn(B, lq, H * D, device="cuda",
                            generator=gen).to(dtype)
            for k, v in check_bwd(msda, name, value, sh, loc, attn,
                                  g).items():
                errs[f"msda_bwd {name} {k}"] = v
            del g
        log(f"  {name}: max_abs_err " + ", ".join(
            f"{k.split(name)[-1] or 'fwd'} {v:.3g}" for k, v in errs.items()
            if name in k))
        del value, loc, attn
        torch.cuda.empty_cache()

    timing = {}
    for part, lq in (("encoder", TRAIN_S), ("decoder_src", dec_src),
                     ("decoder_tgt", dec_tgt)):
        value, loc, attn = msda_inputs(gen, lq, shapes=TRAIN_SHAPES)
        g = torch.randn(B, lq, H * D, device="cuda", generator=gen)
        iters, p_iters = (10, 2) if lq == TRAIN_S else (50, 5)
        t = dict(lq=lq)
        for dt, dtype in (("f32", f32), ("bf16", bf)):
            v, gd = value.to(dtype), g.to(dtype)
            f = time_fwd(msda, v, TRAIN_SHAPES, loc, attn, iters, p_iters)
            bw = time_bwd(msda, v, TRAIN_SHAPES, loc, attn, gd, iters,
                          p_iters)
            f.pop("value_rows_read")
            t.update({f"fwd_{k}_{dt}": x for k, x in f.items()})
            t.update({f"bwd_{k}_{dt}": x for k, x in bw.items()})
            log(f"  train {part} Lq={lq} {dt}, random locations:")
            log(f"    fwd {describe(f)}")
            log(f"    bwd {describe(bw)}")
        timing[part] = t
        del value, loc, attn, g
    torch.cuda.empty_cache()
    return dict(errs=errs, timing=timing)


def serve_requests(srv, msda, imgs) -> dict:
    """The main path of a server: counts from 0, the requests, counts read;
    one msda_fwd launch per MSDeformAttn per batch (12 at full depth), every
    answer finite and inside its image."""
    from datr_torch.models.layers import MSDeformAttn

    n_msda = sum(isinstance(m, MSDeformAttn) for m in srv.model.modules())
    msda.msda_fwd.launches = 0
    results = [f.result(timeout=600) for f in [srv.submit(im) for im in imgs]]
    launches = msda.msda_fwd.launches
    st = srv.stats()
    assert st["requests"] == len(imgs)
    assert launches == n_msda * st["batches"], (launches, st["batches"])
    for im, r in zip(imgs, results):
        assert r["boxes"].shape == (300, 4) and r["scores"].shape == (300,)
        assert r["boxes"].dtype == np.float32
        assert np.isfinite(r["boxes"]).all() and np.isfinite(
            r["scores"]).all(), f"non-finite answer for {im.shape}"
        assert (r["boxes"][:, 2] <= im.shape[1]).all()
        assert (r["boxes"][:, 3] <= im.shape[0]).all()
    return dict(requests=len(results), batches=st["batches"],
                launches=launches)


def run_bf16_serving(msda, card) -> dict:
    """The flagship server in bf16 at bench.py's settings (800x1344, batch
    2, use_remat off), fast_norm off and on: requests, launches, the step
    by CUDA events, its profile, msda_fwd in bf16 at the model's own
    locations (fast_norm off), and the forward through the kernels against
    the plain bf16 forward with the top-k held. Then one batch of
    DINO_5scale and of DINO_4scale_fast in bf16 with its launches."""
    from datr_torch.models import dino as dino_mod

    imgs = request_images()
    out = {}
    for fast in (False, True):
        srv = flagship_server(**BF16, fast_norm=fast, use_remat=False)
        try:
            srv.warmup()
            torch.cuda.synchronize()
            res = serve_requests(srv, msda, imgs)
            batch, sizes = serving_batch(srv, imgs)
            if not fast:
                calls = capture_msda_calls(msda,
                                           lambda: srv._step(batch, sizes))
                res["model_locations"] = check_model_locations(
                    msda, calls, {"encoder": S, "decoder": N_QUERIES}, SHAPES,
                    backward=False)
                del calls
            res["step_ms"] = cuda_ms(lambda: srv._step(batch, sizes), 10,
                                     warmup=2)
            res["step_img_s"] = 2e3 / res["step_ms"]
            log(f"  bf16 server, fast_norm {fast}: {res['requests']} "
                f"requests in {res['batches']} batches, msda_fwd launches "
                f"{res['launches']}; step {res['step_ms']:.2f} ms = "
                f"{res['step_img_s']:.2f} img/s on {card}")
            res["profile"] = profile_step(lambda: srv._step(batch, sizes)
                                          .cpu())
            res["forward_diffs"] = check_forward_against_plain(
                srv.model, batch, sizes, msda, dino_mod, tol=BF16_FWD_TOL,
                control_above=BF16_FWD_SEPARATES)
        finally:
            srv.close()
        out["fast_norm" if fast else "plain_norm"] = res
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    for name, path in (("5scale", "configs/DINO/DINO_5scale.py"),
                       ("4scale_fast", "configs/DINO/DINO_4scale_fast.py")):
        srv = flagship_server(path, **BF16, use_remat=False)
        try:
            srv.warmup()
            torch.cuda.synchronize()
            res = serve_requests(srv, msda, imgs[:2])
            batch, sizes = serving_batch(srv, imgs)
            res["step_ms"] = cuda_ms(lambda: srv._step(batch, sizes), 5,
                                     warmup=1)
            log(f"  {path} bf16: {res['requests']} requests in "
                f"{res['batches']} batch(es), msda_fwd launches "
                f"{res['launches']}; step {res['step_ms']:.2f} ms on {card}")
        finally:
            srv.close()
        out[name] = res
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    return out


def assert_state_f32(state):
    """Parameters, AdamW's moments, the EMA tracks and the prototype state
    stay f32 under a bf16 model."""
    from datr_torch.train.state import EMA_TRACKS

    f32 = {torch.float32}
    assert {p.dtype for p in state.model.parameters()} == f32
    for name in EMA_TRACKS:
        assert {p.dtype for p in getattr(state, name).parameters()} == f32
    moments = [v for ps in state.optimizer.opt.state.values()
               for k, v in ps.items() if k.startswith("exp_avg")]
    assert moments and {v.dtype for v in moments} == f32
    assert state.global_proto.dtype == state.amount.dtype == torch.float32


def timed_epoch(msda, fn, n_steps) -> dict:
    """The main path of a training run: counts from 0, fn() (an epoch of
    n_steps), counts read; s/step by CUDA events, peak memory."""
    msda.msda_fwd.launches = msda.msda_bwd.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = fn()
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    step_s = start.elapsed_time(end) / 1e3 / n_steps
    return dict(metrics=metrics, step_s=step_s, img_s=4 / step_s,
                host_step_s=wall_s / n_steps,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=dict(msda_fwd=msda.msda_fwd.launches,
                              msda_bwd=msda.msda_bwd.launches))


def run_bf16_training(msda, card) -> dict:
    """C2F burn-in in bf16 at 1216x2048 through engine.train_one_epoch:
    msda_fwd / msda_bwd in bf16 at the seeded model's own locations, a
    warm-up step and 3 timed ones (launches 48 / 24 per step, peak memory),
    one step through the kernels against the plain bf16 step with the
    choices held, and one profiled step with the image discriminator's
    convolutions named."""
    from datr_torch.engine import train_one_epoch
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.train.steps import loss_and_grads, train_step_burnin

    n_batches = 4
    base_gb = torch.cuda.memory_allocated() / 1e9
    state, ccfg, wd, _ = c2f_train_state(n_batches, **BF16)
    model = state.model
    assert model.dtype == torch.bfloat16
    batches = paired_batches(n_batches, "cuda", seed=0)
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    want_fwd = 2 * n_msda * (2 if model.use_remat else 1)
    want_bwd = 2 * n_msda
    calls = training_msda_calls(msda, state, batches[0])
    at_model = check_model_locations(
        msda, calls, dict(encoder=TRAIN_S, decoder_src=TRAIN_DEC_LQ[0],
                          decoder_tgt=TRAIN_DEC_LQ[1]), TRAIN_SHAPES,
        backward=True)
    del calls
    torch.cuda.empty_cache()

    warm = train_one_epoch(state, batches[:1], ccfg, wd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = batches[1:]
    r = timed_epoch(msda, lambda: train_one_epoch(state, steps, ccfg, wd),
                    len(steps))
    metrics = r.pop("metrics")
    log(f"  bf16 burn-in, {len(steps)} steps: {r['step_s']:.3f} s/step by "
        f"CUDA events ({r['host_step_s']:.3f} s/step host), "
        f"{r['img_s']:.3f} img/s, peak memory {r['peak_memory_gb']:.2f} GB "
        f"({base_gb:.2f} GB allocated before) on {card}; launches "
        f"{r['launches']} (per step expected {want_fwd} / {want_bwd}); loss "
        f"{metrics['loss']:.4f} (warm-up {warm['loss']:.4f})")
    assert r["launches"] == dict(msda_fwd=want_fwd * len(steps),
                                 msda_bwd=want_bwd * len(steps)), r
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert_state_f32(state)

    check = check_step_against_plain(
        state, lambda d: loss_and_grads(state, batches[0], ccfg, wd, d)[:2],
        msda, **BF16_STEP_TOL)
    log("  profile of one bf16 burn-in step")
    # the image discriminator's 3x3 convolutions, forward and backward,
    # over every level; its level-1 conv2 by its input's shape
    profile = profile_step(lambda: train_step_burnin(
        state, batches[1], ccfg, wd)["loss"].item(),
        kernels=("msda_fwd", "msda_bwd"), top=15,
        find={"d_img conv1 (256->256), all levels": "[256, 256, 3, 3]",
              "d_img conv2 (256->128), all levels": "[128, 256, 3, 3]",
              "d_img conv2 level 1 forward": "aten::cudnn_convolution "
              "[[4, 256, 76, 128], [128, 256, 3, 3]"})
    return dict(r, launches_per_step=dict(msda_fwd=want_fwd,
                                          msda_bwd=want_bwd),
                steps=len(steps), allocated_before_gb=base_gb,
                loss=metrics["loss"], against_plain=check,
                model_locations=at_model, profile=profile)


def run_bf16_self_training(msda, card) -> dict:
    """C2F self-training in bf16 at 1216x2048 through
    engine.train_one_epoch_self_training: a warm-up step and 3 timed ones
    (launches 60 / 24 per step, num_pseudo > 0), one step through the
    kernels against the plain bf16 step (pseudo-labels made once, choices
    held), then engine.evaluate of the EMA teacher on 8 images."""
    from datr_torch import engine
    from datr_torch.data.synthetic import (
        SyntheticDetectionDataset,
        synthetic_eval_batches,
    )
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.train.steps import (
        self_training_loss_and_grads,
        teacher_pseudo_labels,
    )

    n_batches = 4
    base_gb = torch.cuda.memory_allocated() / 1e9
    state, ccfg, wd, cfg = c2f_train_state(n_batches, C2F_ST, seed=1, **BF16)
    model = state.model
    batches = paired_batches(n_batches, "cuda", seed=2, strong=True)
    thr = pseudo_threshold(state, batches)
    thresholds = np.full((model.num_classes,), thr, np.float32)
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    want_fwd = n_msda + 2 * n_msda * (2 if model.use_remat else 1)
    want_bwd = 2 * n_msda

    warm = engine.train_one_epoch_self_training(
        state, batches[:1], ccfg, wd, thresholds, TRAIN_CANVAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = batches[1:]
    r = timed_epoch(msda, lambda: engine.train_one_epoch_self_training(
        state, steps, ccfg, wd, thresholds, TRAIN_CANVAS), len(steps))
    metrics = r.pop("metrics")
    log(f"  bf16 self-training, {len(steps)} steps: {r['step_s']:.3f} "
        f"s/step by CUDA events ({r['host_step_s']:.3f} s/step host), peak "
        f"memory {r['peak_memory_gb']:.2f} GB ({base_gb:.2f} GB before) on "
        f"{card}; launches {r['launches']} (per step expected {want_fwd} / "
        f"{want_bwd}); threshold {thr:.6f}, mean num_pseudo "
        f"{metrics['num_pseudo']:.1f} (warm-up {warm['num_pseudo']:.0f}); "
        f"loss {metrics['loss']:.4f}")
    assert r["launches"] == dict(msda_fwd=want_fwd * len(steps),
                                 msda_bwd=want_bwd * len(steps)), r
    assert metrics["num_pseudo"] > 0 and metrics["loss_ce_target"] > 0
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert_state_f32(state)

    b = batches[1]
    thr_t = torch.as_tensor(thresholds, device=state.amount.device)
    pseudo = teacher_pseudo_labels(state, b, thr_t, TRAIN_CANVAS)

    def run(draws):
        total, src, tgt, _ = self_training_loss_and_grads(
            state, b, ccfg, wd, pseudo, draws)
        return total, {**src, **{f"{k}_target": v for k, v in tgt.items()}}

    check = check_step_against_plain(state, run, msda, **BF16_STEP_TOL)
    del pseudo

    ev_ds = SyntheticDetectionDataset(8, (1024, 2048), 8, max_objects=16,
                                      seed=4, fog=0.35)
    ev = synthetic_eval_batches(ev_ds, 2, TRAIN_CANVAS, max_boxes=100,
                                device="cuda")
    msda.msda_fwd.launches = 0
    t0 = time.perf_counter()
    stats = engine.evaluate(state.ema_teacher, ev, range(cfg.num_classes))
    eval_wall_s = time.perf_counter() - t0
    eval_launches = msda.msda_fwd.launches
    log(f"  bf16 evaluate (EMA teacher), {len(ev_ds)} images: "
        f"{len(ev_ds) / eval_wall_s:.3f} img/s wall; msda_fwd launches "
        f"{eval_launches}; COCO stats {stats['coco_eval_bbox']}")
    assert eval_launches == n_msda * len(ev), eval_launches
    assert len(stats["coco_eval_bbox"]) == 12
    assert all(np.isfinite(stats["coco_eval_bbox"]))
    return dict(r, launches_per_step=dict(msda_fwd=want_fwd,
                                          msda_bwd=want_bwd),
                steps=len(steps), allocated_before_gb=base_gb,
                threshold=thr, num_pseudo=metrics["num_pseudo"],
                loss=metrics["loss"], against_plain=check,
                eval=dict(images=len(ev_ds), launches=eval_launches,
                          wall_img_s=len(ev_ds) / eval_wall_s,
                          coco_eval_bbox=stats["coco_eval_bbox"]))


def run_bf16(msda, card) -> dict:
    """Phase 8: bfloat16 through the kernels and the main paths (phase 7's
    CLI run with `--amp` last), each part's state freed before the next."""
    out = {"kernels": check_msda_bf16(msda)}
    for name, fn in (("serving", run_bf16_serving),
                     ("training", run_bf16_training),
                     ("self_training", run_bf16_self_training),
                     ("cli", lambda m, c: run_cli(m, c, flags=("--amp",)))):
        out[name] = fn(msda, card)
        gc.collect()
        torch.cuda.empty_cache()
    assert out["cli"]["dtype"] == "bfloat16", out["cli"]["dtype"]
    return out


# ---------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    from datr_torch.ops import _build, msda

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase_s, t_phase = {}, [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _, build_log = _build.build()
    build_s = time.perf_counter() - t0
    _build.load_library()
    log(f"  built {[s.name for s in _build.sources()]} in {build_s:.2f} s")
    log("\n".join("  " + ln.strip()[:150] for ln in build_log.splitlines()
                  if any(w in ln for w in ("Compiling entry", "registers",
                                           "spill"))))

    phase_done("1")
    log("phase 2: msda_fwd against its plain version, serving shapes")
    k = check_msda(msda)
    phase_done("2")

    log("phase 2b: the training kernels against their plain versions")
    kt = check_train_msda(msda)
    phase_done("2b")

    log("phase 3: serving slice at full width")
    s = run_slice(msda, card)
    log("slice " + json.dumps(dict(s, card=card)))
    phase_done("3")

    log("phase 4: gather bench entry point, its kernels against their "
        "plain versions")
    from datr_torch.ops import gather
    from datr_torch.tools import msda_gather_bench as bench

    gb = run_gather_bench(gather, bench)
    kg = gb["cases"]
    fma_errs = check_gather_fma(gather, bench)
    phase_done("4")

    # phases 6, 7 and 8 run before phase 5, whose profile must be the last
    # work of the process; each phase's state is gone before the next one
    # starts
    log("phase 6: self-training slice at full width (C2F self-training, "
        "evaluation, checkpoints)")
    st = run_self_training(msda, card)
    log("self_training " + json.dumps(dict(st, card=card)))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("6")

    log("phase 7: the training CLI at full width (python -m datr_torch.main, "
        "C2F self-training, --synthetic), then the host loader at "
        "Cityscapes size")
    cl = run_cli(msda, card)
    cl["loader"] = loader_rate()
    log("cli " + json.dumps(dict(cl, card=card)))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("7")

    log("phase 8: bfloat16: the kernels in bf16 against their plain "
        "versions (5 levels and P = 2 in both dtypes), the flagship server "
        "(fast_norm off, on), DINO_5scale and DINO_4scale_fast, C2F burn-in, "
        "self-training and evaluate")
    bf = run_bf16(msda, card)
    log("bf16 " + json.dumps(dict(bf, card=card)))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("8")

    log("phase 5: training slice at full width (C2F burn-in), its profile "
        "last")
    tr = run_training(msda, card)
    log("training " + json.dumps(dict(tr, card=card)))
    phase_done("5")

    enc, dec = k["timing"]["encoder"], k["timing"]["decoder"]
    per_fwd = {key: 6 * enc[key] + 6 * dec[key]
               for key in ("ms", "plain_ms", "bound_ms")}
    tt = kt["timing"]
    remat = tr["launches_per_step"]["msda_fwd"] // tr["launches_per_step"][
        "msda_bwd"]
    # per training step: 12 encoder launches (2 passes x 6 layers, Lq
    # 51,680) and 6 decoder launches per pass (Lq 1,100 / 900); the forward
    # runs again in remat's recompute
    fwd_step = {k2: remat * per_train_step(tt, key, 12, 6) for k2, key in (
        ("ms", "fwd_ms"), ("plain_ms", "fwd_plain_ms"),
        ("bound_ms", "fwd_bound_ms"))}
    bwd_step = {k2: per_train_step(tt, key, 12, 6) for k2, key in (
        ("ms", "bwd_ms"), ("plain_ms", "bwd_plain_ms"),
        ("bound_ms", "bwd_bound_ms"))}
    # the same sums over the launches at the model's own locations
    tm = tr["model_locations"]
    fwd_step_model = {k2: remat * per_train_step(tm, key, 12, 6)
                      for k2, key in (("ms", "fwd_ms"),
                                      ("bound_ms", "fwd_bound_ms"))}
    bwd_step_model = {k2: per_train_step(tm, key, 12, 6)
                      for k2, key in (("ms", "bwd_ms"),
                                      ("bound_ms", "bwd_bound_ms"))}
    sm = s["model_locations"]
    bwd_errs = {n: v for n, v in kt["errs"].items() if "msda_bwd" in n}
    # bf16: per serving forward at the bf16 model's locations; msda_bwd per
    # training step (12 encoder + 6 + 6 decoder launches) at random
    # locations, beside f32 in the same call
    bt = bf["kernels"]["timing"]
    bsm = bf["serving"]["plain_norm"]["model_locations"]
    btm = bf["training"]["model_locations"]
    bf_errs = bf["kernels"]["errs"]
    bwd_step_bf16 = {k2: per_train_step(bt, key, 12, 6) for k2, key in (
        ("ms", "bwd_ms_bf16"), ("plain_ms", "bwd_plain_ms_bf16"),
        ("bound_ms", "bwd_bound_ms_bf16"), ("ms_f32", "bwd_ms_f32"))}
    bf_launches = {
        "serving": bf["serving"]["plain_norm"]["launches"]
        + bf["serving"]["fast_norm"]["launches"]
        + bf["serving"]["5scale"]["launches"]
        + bf["serving"]["4scale_fast"]["launches"],
        "training": bf["training"]["launches"],
        "self_training": bf["self_training"]["launches"],
        "eval": bf["self_training"]["eval"]["launches"],
        "cli": bf["cli"]["launches"]}
    k2, k3 = kg["copy"], kg["fma"]
    kernels = [{
        "name": "msda_fwd",
        "route": "cuda",
        "source": "datr_torch/csrc/msda_fwd.cu",
        "replaces": "datr_tpu/ops/msda_pallas.py:45",
        "launches": (s["launches"] + tr["launches"]["msda_fwd"]
                     + st["launches"]["msda_fwd"] + st["eval"]["launches"]
                     + cl["launches"]["msda_fwd"]),
        "launches_by_path": {"serving": s["launches"],
                             "training": tr["launches"]["msda_fwd"],
                             "self_training": st["launches"]["msda_fwd"],
                             "eval": st["eval"]["launches"],
                             "cli": cl["launches"]["msda_fwd"]},
        "launches_per_forward": s["launches"] // s["batches"],
        "launches_per_train_step": tr["launches_per_step"]["msda_fwd"],
        "launches_per_self_training_step": st["launches_per_step"][
            "msda_fwd"],
        "max_abs_err": max(v for n, v in [*k["errs"].items(),
                                          *kt["errs"].items()]
                           if "f32" in n and "msda_bwd" not in n),
        "max_abs_err_bf16": max(v for n, v in k["errs"].items()
                                if "bf16" in n),
        # per serving forward: 6 encoder launches (Lq=22,323) + 6 decoder
        # (Lq=900)
        "ms": per_fwd["ms"],
        "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"],
        "bound_by": enc["bound_by"],
        "library_ms": None,  # no single PyTorch call computes MSDA
        "floor_ms": gb["floor"]["floor_ms"],
        "per_launch": {"encoder": enc, "decoder": dec},
        "per_train_step": dict(fwd_step, bound_by=tt["encoder"][
            "fwd_bound_by"]),
        "per_launch_train": tt,
        # the same at the locations the seeded models produce
        "ms_model": 6 * sm["encoder"]["ms"] + 6 * sm["decoder"]["ms"],
        "bound_ms_model": (6 * sm["encoder"]["bound_ms"]
                           + 6 * sm["decoder"]["bound_ms"]),
        "per_launch_model": sm,
        "per_train_step_model": fwd_step_model,
        "per_launch_train_model": tm,
        # bf16 (phase 8): launches on its paths, times at the bf16 models'
        # own locations and at random training shapes
        "launches_bf16": bf_launches["serving"]
        + bf_launches["training"]["msda_fwd"]
        + bf_launches["self_training"]["msda_fwd"] + bf_launches["eval"]
        + bf_launches["cli"]["msda_fwd"],
        "max_abs_err_bf16_phase8": max(v for n, v in bf_errs.items()
                                       if "msda_fwd" in n),
        "ms_bf16_model": 6 * bsm["encoder"]["ms"] + 6 * bsm["decoder"]["ms"],
        "bound_ms_bf16_model": (6 * bsm["encoder"]["bound_ms"]
                                + 6 * bsm["decoder"]["bound_ms"]),
        "per_launch_bf16_model": bsm,
        "per_launch_train_bf16_model": btm,
        "per_launch_train_bf16": bt,
    }, {
        "name": "msda_bwd",
        "route": "cuda",
        "source": "datr_torch/csrc/msda_bwd.cu",
        "replaces": "datr_tpu/ops/msda_pallas.py:154",
        "launches": (tr["launches"]["msda_bwd"] + st["launches"]["msda_bwd"]
                     + cl["launches"]["msda_bwd"]),
        "launches_by_path": {"training": tr["launches"]["msda_bwd"],
                             "self_training": st["launches"]["msda_bwd"],
                             "cli": cl["launches"]["msda_bwd"]},
        "launches_per_train_step": tr["launches_per_step"]["msda_bwd"],
        "launches_per_self_training_step": st["launches_per_step"][
            "msda_bwd"],
        "max_abs_err": max(v for n, v in bwd_errs.items()
                           if "grad_loc" not in n),
        "max_abs_err_grad_loc": max(v for n, v in bwd_errs.items()
                                    if "grad_loc" in n),
        # per training step: 12 encoder + 6 + 6 decoder launches
        **bwd_step,
        "bound_by": tt["encoder"]["bwd_bound_by"],
        "library_ms": None,  # no PyTorch call computes MSDA's backward
        "floor_ms": gb["floor"]["floor_ms"],
        "per_launch_train": tt,
        "per_train_step_model": bwd_step_model,
        "per_launch_train_model": tm,
    }, {
        # the bf16 instantiation (phase 8): bf16 value / grad_out / grad_value
        # through an f32 workspace, f32 grad_loc / grad_attn
        "name": "msda_bwd_bf16",
        "route": "cuda",
        "source": "datr_torch/csrc/msda_bwd.cu",
        "replaces": "datr_tpu/ops/msda_pallas.py:154",
        "launches": (bf_launches["training"]["msda_bwd"]
                     + bf_launches["self_training"]["msda_bwd"]
                     + bf_launches["cli"]["msda_bwd"]),
        "launches_by_path": {
            "training": bf_launches["training"]["msda_bwd"],
            "self_training": bf_launches["self_training"]["msda_bwd"],
            "cli": bf_launches["cli"]["msda_bwd"]},
        "launches_per_train_step": bf["training"]["launches_per_step"][
            "msda_bwd"],
        "max_abs_err": max(v for n, v in bf_errs.items()
                           if "msda_bwd" in n and "bf16" in n
                           and "grad_loc" not in n),
        "max_abs_err_grad_loc": max(v for n, v in bf_errs.items()
                                    if "msda_bwd" in n and "bf16" in n
                                    and "grad_loc" in n),
        # per training step, random locations; ms_f32: the f32 kernel on
        # the same inputs in this call
        **bwd_step_bf16,
        "bound_by": bt["encoder"]["bwd_bound_by_bf16"],
        "library_ms": None,  # no PyTorch call computes MSDA's backward
        "per_launch_train": bt,
        "per_train_step_model": {k2: per_train_step(btm, key, 12, 6)
                                 for k2, key in (("ms", "bwd_ms"),
                                                 ("bound_ms",
                                                  "bwd_bound_ms"))},
        "per_launch_train_model": btm,
    }, {
        "name": "row_gather",
        "route": "cuda",
        "source": "datr_torch/csrc/gather.cu",
        "replaces": "tools/msda_pallas_bench.py:57",
        "also_replaces": ["tools/mosaic_probe.py:55 (K4)",
                          "tools/mosaic_probe.py:71 (K5)",
                          "tools/mosaic_probe.py:96 (K6)"],
        "launches": gb["launches"]["row_gather"],
        "max_abs_err": max(v["max_abs_err"] for v in kg.values()
                           if v["kernel"] == "row_gather"),
        # K2's shapes: table [22528, 128] bf16, 32,768 random indices
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],  # torch.index_select
        "floor_ms": k2["floor_ms"],
        # K2 copy; K4/K5/K6: the three probes, by name
        "cases": {n: v for n, v in kg.items() if v["kernel"] == "row_gather"},
        "launches_by_case": {
            **{n: v["launches"] for n, v in kg.items()
               if v["kernel"] == "row_gather"},
            "launch_floor": gb["floor"]["launches"]},
    }, {
        "name": "gather_fma",
        "route": "cuda",
        "source": "datr_torch/csrc/gather.cu",
        "replaces": "tools/msda_pallas_bench.py:79",
        "launches": gb["launches"]["gather_fma"],
        "max_abs_err": max(k3["max_abs_err"], *fma_errs.values()),
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],  # F.embedding_bag, per-sample weights
        "floor_ms": k3["floor_ms"],
        "max_abs_err_by_instantiation": fma_errs,
    }]
    log("gather bench " + json.dumps(kg))
    log("phase wall times, s: " + json.dumps(phase_s))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
