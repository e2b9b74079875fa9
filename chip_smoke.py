#!/usr/bin/env python3
"""Smoke test of the datr_torch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. environment: card name and power limit, torch/CUDA versions, and a fresh
     build of every CUDA kernel from datr_torch/csrc (one nvcc per source,
     all at once; build time printed), then of the host image ops
     (csrc/image_ops.cpp, g++ with native.IMAGE_OPS_FLAGS; time and flags
     printed);
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
     families are written, with use_tensorboard the event file in tb/ holds
     each log.txt line's scalars (where no TensorBoard backend imports, a
     line says the writer was inactive), the msda_fwd / msda_bwd launches
     equal the count
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
  9. the serving surface (runs after 4, before 6): the flagship behind
     serve_http on a local port, in f32 (TF32 off) and in bf16, with the
     u8 and the yuv420 wire: /healthz and /stats, 8 POSTs of PNG bodies
     (8 seeded 1024x2048 frames, the five PNG filters cycled over the rows,
     decoded on the host by data/png.py) from 8 client threads, msda_fwd
     at 12 launches per batch, every answer held to the server's own
     detections of the same decoded image (boxes atol 1e-4 x 2048, scores
     1e-3); with yuv420 the decode on the card held to its plain CPU run
     (atol 1e-5) and the answers to a forward on the RGB the wire
     reconstructs; each wire's decode launches per batch; 8 JPEG bodies
     in f32 where libjpeg was found (else a line says why not); then
     datr_torch.tools.serve_bench through submit (4 clients, 12 images,
     in-flight 2; f32 and bf16, u8 and yuv420): img/s, p50 / p95 latency,
     occupancy; then a burst of 16 POSTs against max_queue 2 and 4
     concurrent requests: at least one 503 overloaded, close() returns;
  10. the other backbones (runs after 9, before 6): DINO_4scale_swin.py
     (Swin-L 384-22k, window 12) and DINO_4scale_convnext.py (ConvNeXt-XL
     22k), 9 classes, seeded weights, behind InferenceServer at 800x1344,
     batch 2, in f32 with TF32 off and in bf16 (use_remat off): requests
     with 12 msda_fwd launches per batch, the step by CUDA events, peak
     memory, profile, the backbone's parameter count, the forward through
     the kernels against the plain forward (bf16: phase 8's floor and
     control); one train_step_plain of each at the config's own canvas and
     batch (800x1344, 2 images, f32, use_remat on) through
     engine.train_one_epoch_plain fed by make_single_loader (warm-up + 1
     timed step, launches, peak memory, one step against the plain step);
     then C2F self-training at 1216x2048 with an external teacher: the R50
     student, the teacher the same config with the Swin-L backbone, seeded,
     through save_checkpoint / load_pretrain_params, labelling through
     engine.train_one_epoch_self_training(teacher=...) (a per-run
     threshold, warm-up + 1 timed step, 60 / 24 launches per step, the
     teacher and EMA teacher unchanged, the parts by CUDA events, one step
     against the plain step with the pseudo-labels made once);
  11. instance masks (runs after 10, before 6): a single-domain COCO tree
     with instance masks written to a temporary directory (8 seeded
     1024x2048 PNG frames, polygon, compressed-RLE and uncompressed-RLE
     segmentations); the flagship with masks=True and mask_query_chunk 100
     behind InferenceServer(mask_top_k=50) at 800x1344, batch 2, f32 with
     TF32 off: 4 of the frames as requests (12 msda_fwd launches per batch,
     every answer's 50 masks at the frame's size), the step by CUDA events,
     peak memory, profile, the forward through the kernels against the
     plain forward (memory / logits / boxes as phase 3; pred_masks atol
     1e-3; each of a batch's top-50 masks finished on the host, IoU >= 0.99
     with the plain run's), 4 PNG POSTs through serve_http whose mask RLEs
     equal detect's; one batch in bf16; engine.evaluate(segm=True) over 2
     frames of the tree (batch 2, 25 detections per image: the 12 bbox and
     12 segm stats, img/s, the host finish's time); train_one_epoch_plain
     on the tree through make_single_loader with return_masks (800x1344,
     batch 2, use_remat: the mask head's chunks recomputed in the
     backward; warm-up + 1 timed step, 24 / 12 launches per step, s/step,
     peak memory, loss_mask / loss_dice finite), one step through the
     kernels against the plain step (phase 5's check: losses 1e-3
     relative, every gradient, the mask head's too, 1e-3 by norm);
  12. the model registry and the host ops (runs after 11, before 6): the
     flagship with two_stage_bbox_embed_share=True built through
     models.build_model (its encoder's proposal heads are the decoder's,
     no enc_out_* entry), served at 800x1344, batch 2, f32 with TF32 off
     (12 msda_fwd launches per batch, the step by CUDA events, the forward
     against the plain forward at phase 3's tolerances) and trained as
     phase 10 trains the backbones (train_step_plain through
     make_single_loader: warm-up + 1 timed step at 24 / 12 launches, the
     step against the plain step); the C++ host image ops against their
     plain versions on seeded 1024x2048 frames at the serving and the
     loader's sizes (resize_normalize_pad and rgb_to_yuv420 bitwise,
     resize_pad_u8 within one count, the share that differs printed),
     each timed beside its plain version on one thread, and beside the
     same source built with -fopenmp, alone and from 4 threads at once;
     the loader's img/s (3 batches) and serve_bench through submit (u8,
     f32, 4 clients, 24 images) through the C++ ops, the plain versions
     patched in, and the OpenMP build; `python -m
     datr_torch.tools.benchmark` on the flagship at 800x1344, batch 1;
  13. data parallelism across processes on the one card (runs after 7,
     before 8): a. the C2F burn-in config at full width (depth 2 + 2,
     `DIST_DEPTH`, in d's checkpoint too) on 2 spawned ranks
     over gloo with CUDA tensors (NCCL refuses two ranks on one device),
     1 + 1 images per rank; the DDP step against the one-process step on
     the whole 2 + 2 batch (each rank runs that in turn with the package's
     collectives off; its top-k, assignments, prototype classes and ReLU
     signs held, each rank taking its share; losses and gradients 1e-3 as
     phase 5's check), then a warm-up, 1 timed burn-in and 1 self-training
     DDP step (s/step, launches per step, peak per rank; the ranks'
     parameters and prototype state compared after every step); b. one
     FSDP burn-in step from the same weights, batch and CDN draws, its
     parameters within 2 lr of DDP's, the bytes each rank holds beside
     DDP's; c. engine.evaluate(segm=True) of phase 11's masks model on 4
     fogged frames, 10 detections an image (`DIST_EVAL_SELECT`), over the
     2 ranks (equal stats on both, within 1e-3 of
     the one-process evaluate's, detections within phase 6's tolerances);
     d. the FSDP state saved sharded (torch.distributed.checkpoint) and
     loaded into one process by load_resume, its forward bitwise the
     ranks'; e. phase 7's CLI under torchrun's environment, NCCL, world 1
     (DDP on one card), its step time beside phase 7's; f. the flagship
     served on devices=[cuda:0, cuda:0], answers as one device's;
  14. the model axes on the one card (runs after 13, before 8): tensor
     parallelism (tp = 2), encoder sequence parallelism (sp = 2), the GPipe
     encoder (2 stages), data x tensor parallelism with FSDP on 4 ranks, a
     tensor-parallel sharded checkpoint loaded into one process (the C2F
     model at full width, depth cut to 2 + 2 layers: gloo's host-staged
     collectives of each layer's activations set these steps' time),
     serving with tp = 2 (the flagship, full depth) (`run_model_axes`);
     14d's state after its step saved sharded, loaded on the same 4 ranks
     as dp 1 x tp 4 and into one process: the whole state (parameters,
     AdamW moments, EMA tracks, prototype state) bitwise by its bits, the
     one process's forward bitwise that of the whole student the ranks
     gathered;
  15. the tools and the float64 mode (runs after 14, before 8): a. a
     reference-layout .pth of the flagship (full width, random, `module.`
     prefixes and an `args` Namespace) through
     datr_torch/tools/convert_checkpoint.py into the flagship: every eval
     tensor the converter's, none at init, none left over; served and its
     forward against the plain forward at phase 3's tolerances; b. its eval
     forward exported with torch.export at 1 x 800x1344 in f32, saved,
     loaded (`load_exported`) and run: 12 msda_fwd launches, within phase
     3's tolerances of eager (bitwise expected), export / load seconds and
     ms beside eager's; the registered op's host cost per call beside the
     wrapper's, f32 and bf16; c. `datr_torch.tools.train_bench.main` (f32
     burn-in, warm-up + 3 steps, 192 / 96 launches); d. `python -m
     datr_torch.tools.profile_model` on the bf16 eval forward (`--copies`)
     and burn-in step (`--train`), each in a process of its own (its
     profiler apart from the smoke's): the categories cover at
     least 95% of the kernel time, msda_fwd / msda_bwd by name, the idle
     share; e. `datr_torch.tools.repro_c2f.main(["--dry_run"])` on the
     card, every stage ok; f. the f64 instantiations of msda_fwd / msda_bwd against
     their plain versions (rtol 1e-9 / atol 1e-12) at random, outside and
     the f64 flagship's own locations, timed beside their f64 bounds; the
     f64 flagship's serving forward at batch 1 through the kernels against
     the plain f64 forward (phase 3's tolerances times 2^-29, f64's epsilon
     over f32's), its ms, and the f32 forward's distance from it (a
     finding); one f64 C2F burn-in step at 800x1344 (48 / 24 launches);
  16. distillation and every PNG kind (runs after 15, before 8): `python
     -m datr_torch.tools.distill_retention` in a process of its own at
     flagship width (hidden 256, 6 + 6 layers, R50, bf16 + remat, 320x640,
     2 + 2 images a step): a 4-point teacher's 4 burn-in steps, a 2-point
     student's 2 burn-in and 2 distillation steps labelled by that
     teacher, each evaluated; every phase's launches against the count
     derived from the model (48 / 24 per burn-in step, 60 / 24 per
     distillation step, 12 per evaluation batch), its step times, AP50 in
     [0, 1]; in this process msda_fwd / msda_bwd at the 2-point student's
     own bf16 training locations against their plain versions, timed
     beside their bounds; one bf16 step of that student through the
     kernels against the plain step (phase 8's floor and control), one
     step of it computing in f32 (phase 5's 1e-3); a seeded 1024x2048
     frame as 8-bit, 16-bit and Adam7 PNGs decoded on the host bitwise to
     PIL, each timed, and all 30 PNG kinds (colour type x bit depth x
     interlace) at 37x53;
  the result: the wall time of each phase, a {"kernels": [...]} line,
     the card line, and as the last line {"ok": true, "device": {...}}.
Each seeded model is drawn on the host once per architecture and seed in a
process: a later build copies the drawn tensors (`memoize_seeded_inits`;
bitwise the same weights; the smoke builds the flagship some 40 times).
Imports nothing of JAX or datr_tpu. Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import contextlib
import gc
import io
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


# the seeded inits the smoke drew, by architecture and seed (LRU)
_SEEDED_INITS: "dict" = {}
SEEDED_INIT_ENTRIES = 12


def _init_key(model, generator):
    """What DINO.init_params' draws depend on: the generator's seed and the
    module tree (each module's type, its scalar settings but its compute
    dtype and remat, its parameters' and buffers' names and shapes); None
    if the generator has drawn already."""
    fresh = torch.Generator().manual_seed(generator.initial_seed())
    if not torch.equal(generator.get_state(), fresh.get_state()):
        return None
    mods = tuple((name, type(m).__name__, tuple(sorted(
        (k, v) for k, v in vars(m).items()
        if not k.startswith("_")
        and k not in ("dtype", "training", "use_remat", "fast_norm")
        and isinstance(v, (bool, int, float, str, tuple)))))
        for name, m in model.named_modules())
    tensors = tuple((n, tuple(t.shape)) for n, t in (
        *model.named_parameters(), *model.named_buffers()))
    return generator.initial_seed(), mods, tensors


def memoize_seeded_inits():
    """DINO.init_params, memoized for this process: a model whose
    architecture and seed were drawn before gets a copy of those tensors
    (init_params is deterministic in them: bitwise the same model) instead
    of drawing them again on the host, which takes seconds a model; the
    smoke builds the flagship some 40 times."""
    from datr_torch.models import dino as dino_mod

    draw = dino_mod.DINO.init_params
    if getattr(draw, "memoized", False):
        return

    @torch.no_grad()
    def init_params(self, generator):
        key = _init_key(self, generator)
        hit = _SEEDED_INITS.pop(key, None) if key is not None else None
        if hit is None:
            draw(self, generator)
            if key is None:
                return self
            hit = {n: t.detach().clone() for n, t in (
                *self.named_parameters(), *self.named_buffers())}
        else:
            for n, t in (*self.named_parameters(), *self.named_buffers()):
                t.copy_(hit[n])
        _SEEDED_INITS[key] = hit  # the most recent last
        while len(_SEEDED_INITS) > SEEDED_INIT_ENTRIES:
            _SEEDED_INITS.pop(next(iter(_SEEDED_INITS)))
        return self

    init_params.memoized = True
    dino_mod.DINO.init_params = init_params


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
                shapes=SHAPES, p=P, heads=H):
    dev = gen.device
    s_tok, n_l = sum(h * w for h, w in shapes), len(shapes)
    value = torch.randn(B, s_tok, heads, d, device=dev,
                        generator=gen).to(dtype)
    attn = torch.rand(B, lq, heads, n_l, p, device=dev, generator=gen)
    attn = (attn / attn.sum((-1, -2), keepdim=True)).contiguous()
    if case == "random":
        loc = torch.rand(B, lq, heads, n_l, p, 2, device=dev, generator=gen)
    elif case == "outside":
        loc = torch.rand(B, lq, heads, n_l, p, 2, device=dev, generator=gen)
        loc = loc * 1.6 - 0.3
    else:  # "integer": on pixel centres, as DINO's initial offsets put them
        wh = torch.tensor([(w, h) for h, w in shapes], dtype=torch.float32,
                          device=dev)
        hi = (wh + 2).to(torch.int64)[:, None, :].expand(n_l, p, 2)
        ij = (torch.rand(B, lq, heads, n_l, p, 2, device=dev, generator=gen)
              * hi).floor() - 1  # -1 .. W (H): the borders included
        loc = (ij + 0.5) / wh[:, None, :]
    return value, loc.contiguous(), attn


def value_rows_touched(msda, loc, shapes=SHAPES) -> int:
    """Distinct (b, h, token) rows of value that carry a nonzero bilinear
    weight for these sampling locations: the rows the function must read."""
    s_tok, heads = sum(h * w for h, w in shapes), loc.shape[2]
    indices, weights = msda._corner_gather_indices(loc, shapes)
    bh = (torch.arange(B, device=loc.device)[:, None, None, None, None]
          * heads
          + torch.arange(heads, device=loc.device)[None, None, :, None, None]
          ) * s_tok
    touched = torch.zeros(B * heads * s_tok, dtype=torch.bool,
                          device=loc.device)
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
    _, valids, weights, _ = msda._corners(loc, shapes)
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
    lq, heads, n_l, n_p = loc.shape[1:5]  # heads: H, or a TP rank's share
    rows = value_rows_touched(msda, loc, shapes)
    n_samples = B * lq * heads * n_l * n_p
    n_bytes = (rows * d * elt + n_samples * 2 * 4 + n_samples * 4
               + B * lq * heads * d * elt)
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
    lq, heads, n_l, n_p = loc.shape[1:5]
    s_tok = sum(h * w for h, w in shapes)
    rows = value_rows_touched(msda, loc, shapes)
    n_samples = B * lq * heads * n_l * n_p
    n_bytes = ((rows + B * s_tok * heads + B * lq * heads) * d * elt
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
        # H heads, or a tensor-parallel rank's share of them
        heads = value.shape[2]
        assert value.shape == (B, sum(h * w for h, w in sh), heads, D)
        err = {"fwd": check_fwd(msda, f"{part} at the model's locations",
                                value, sh, loc, attn)}
        # an encoder launch (every token a query) is timed over fewer calls
        iters, p_iters = (10, 2) if lq == value.shape[1] else (50, 5)
        t = dict(lq=lq, dtype=dt, heads=heads)
        f = time_fwd(msda, value, sh, loc, attn, iters, p_iters)
        if not backward:
            t.update(f, max_abs_err=err["fwd"])
            log(f"  msda_fwd {part} Lq={lq} {dt}, the model's locations: "
                f"max_abs_err {err['fwd']:.3g}; {describe(f)}")
        else:
            g = torch.randn(B, lq, heads * D, device=value.device,
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
            x, pad = wire_decode(images, sizes, tuple(images.shape[1:3]),
                                 "u8")
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


def flagship_model(config="configs/DINO/DINO_4scale.py", **overrides):
    """The flagship DINO-R50 4-scale model (or `config`, with `overrides`),
    seeded random weights, on the card."""
    from datr_torch.config import load_config
    from datr_torch.models import build_model

    cfg = load_config(config)
    cfg["num_classes"] = 9
    cfg.update(overrides)
    model, _, _ = build_model(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {config} {overrides or ''}: {n_params} parameters, on "
        f"{next(model.parameters()).device}, {model.dtype}, fast_norm "
        f"{model.fast_norm}")
    return model


def flagship_server(config="configs/DINO/DINO_4scale.py", **overrides):
    """`flagship_model` behind InferenceServer at 800x1344, batch 2."""
    from datr_torch.serve import InferenceServer

    # threshold 0 keeps all 300 detections of the random-weight model; the
    # long batch timeout fills each batch although submit() resizes on the
    # host first (so the smoke times no latency)
    return InferenceServer(flagship_model(config, **overrides),
                           canvas_hw=(800, 1344), batch_size=2,
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


def _share(held, like, rank, world, inner=None):
    """Rank's share of a choice `held` from the whole batch's run, for a
    rank-local tensor of shape `like`: on each axis where they differ
    (whole size = ranks x local) the rank's slice, by `inner` = (a model
    axis's coordinate, its size, the axis it splits: tensor parallelism's
    features -1, sequence parallelism's tokens 1) on that axis and by
    (rank, world) on any other (the batch); `held` itself when the shapes
    agree (a choice without a batch axis)."""
    like = tuple(like)
    if tuple(held.shape) == like:
        return held
    out = held
    split = inner[2] % len(like) if inner else None
    for d, (g, n) in enumerate(zip(held.shape, like)):
        if g == n:
            continue
        r, w = inner[:2] if d == split else (rank, world)
        # sequence parallelism's last shard may be shorter
        assert g == w * n or (d == split and -(-g // w) * r + n == g), (
            tuple(held.shape), like)
        out = out.narrow(d, r * -(-g // w), n)
    return out


@contextlib.contextmanager
def held_choices(rank=0, world=1, held=None, inner=None, relu=True):
    """Record (held=None) or replay the discrete choices of a training
    step, as check_step_against_plain holds them: the two-stage top-k of
    both passes, the matcher's assignments, the prototypes' class of each
    query and the sign under every ReLU of the transformer and its heads.
    A replay takes rank's share of each choice of the whole batch's run
    (all of it for one process; `inner`: a model axis's coordinate, size
    and split axis, `_share`); `relu=False` replays the others and leaves the ReLUs
    alone (a pipeline calls them in another order). Yields the record
    (dict of lists), or a dict that holds, after the block, the replay's
    flips per call (`cls_flips`, `relu_flips`) and `relu_calls`."""
    import torch.nn.functional as F

    from datr_torch.models import dino as dino_mod
    from datr_torch.models import layers as layers_mod
    from datr_torch.models import transformer as transformer_mod
    from datr_torch.train import criterion as crit_mod

    topk, match = dino_mod._stable_topk_indices, crit_mod.match_many
    protos = dino_mod.class_prototypes
    if held is None:
        out = dict(topk=[], match=[], cls=[], relu=[])

        def f_topk(x, k):
            out["topk"].append(topk(x, k))
            return out["topk"][-1]

        def f_match(*a, **kw):
            out["match"].append(match(*a, **kw))
            return out["match"][-1]

        def f_protos(q, logits, *a):
            out["cls"].append(torch.sigmoid(logits).argmax(-1))
            return protos(q, logits, *a)

        def f_relu(x):
            out["relu"].append(x > 0)
            return F.relu(x)
    else:
        it = {k: iter(v) for k, v in held.items() if relu or k != "relu"}
        flips = dict(cls=[], relu=[])  # device counts: no sync per call
        out = {}

        def f_topk(x, k):
            h = next(it["topk"])
            return _share(h, (x.shape[0], *h.shape[1:]), rank, world)

        def f_match(preds, labels, *a, **kw):
            return [_share(h, labels.shape, rank, world)
                    for h in next(it["match"])]

        def f_protos(q, logits, *a):
            cls = _share(next(it["cls"]), q.shape[:2], rank, world, inner)
            flips["cls"].append((torch.sigmoid(logits).argmax(-1)
                                 != cls).sum())
            return protos(q, F.one_hot(cls, logits.shape[-1]).to(
                logits.dtype), *a)

        def f_relu(x):
            h = _share(next(it["relu"]), x.shape, rank, world, inner)
            flips["relu"].append(((x > 0) != h).sum())
            return torch.where(h, x, torch.zeros_like(x))

    fns = types.SimpleNamespace(**{**vars(F), "relu": f_relu if relu
                                   else F.relu})
    with mock.patch.object(dino_mod, "_stable_topk_indices", f_topk), \
            mock.patch.object(crit_mod, "match_many", f_match), \
            mock.patch.object(dino_mod, "class_prototypes", f_protos), \
            mock.patch.object(layers_mod, "F", fns), \
            mock.patch.object(transformer_mod, "F", fns):
        yield out
    if held is not None:
        assert all(next(v, None) is None for v in it.values()), \
            "the runs made other calls"
        out.update({f"{k}_flips": [int(n) for n in v]
                    for k, v in flips.items()},
                   relu_calls=len(flips["relu"]))


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
    control's median, and each loss and each tensor's gradient is held to
    `loss_tol` / `grad_tol` or, where larger, FLOOR_MARGIN times the
    floor's error of that loss or tensor: the floor, which runs no kernel,
    alone exceeds 0.15 on a decoder's sampling offsets in some bf16
    training states."""
    from datr_torch.models import cdn as cdn_mod

    model = state.model
    groups, _ = cdn_mod.cdn_layout(model.dn_number, model.dn_single_pad)
    draws = cdn_mod.draw_cdn_noise(torch.Generator().manual_seed(7), 2,
                                   groups, model.dn_single_pad,
                                   model.num_classes, state.amount.device)
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

    with held_choices() as seen, \
            mock.patch.object(msda, "ms_deform_attn", rec_cells):
        total_k, losses_k = run(draws)
    grads_k = {n: p.grad.clone() for n, p in model.named_parameters()
               if p.grad is not None}
    flips = []

    def plain_run(ms_fn, points_rotated=False):
        """The step through `ms_fn`, every choice held to the kernel
        run's: (total, losses, grads)."""
        replay_cells = iter(seen_cells)

        def replay_floor(x):
            held = next(replay_cells)
            held = held.roll(1, -1) if points_rotated else held
            cell_flips.append((torch.floor(x) != held).sum())
            return held

        state.optimizer.zero_grad()
        with mock.patch.object(msda, "ms_deform_attn", ms_fn), \
                mock.patch.object(msda, "torch", with_floor(replay_floor)), \
                held_choices(held=seen) as replayed:
            total, losses = run(draws)
        assert next(replay_cells, None) is None, "the runs made other calls"
        flips.append(replayed)
        return total, losses, {n: p.grad.clone() for n, p in
                               model.named_parameters() if p.grad is not None}

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
    res = dict(total_kernel=total_k.item(), total_plain=total_p.item(),
               max_loss_rel=max(loss_rel.values()),
               worst_losses=sorted(loss_rel.items(),
                                   key=lambda kv: -kv[1])[:3],
               max_grad_rel=max(grad_rel.values()),
               median_grad_rel=float(np.median(list(grad_rel.values()))),
               n_grads=len(grad_rel), plain_step_s=plain_s,
               topk_calls=len(seen["topk"]),
               match_calls=len(seen["match"]),
               prototype_class_flips=flips[0]["cls_flips"],
               relu_calls=len(seen["relu"]),
               relu_sign_flips=sum(flips[0]["relu_flips"]),
               msda_calls=len(seen_cells) // 2,
               cell_flips=int(torch.stack(cell_flips).sum()))
    limit, floor_grad = dict.fromkeys(grad_rel, grad_tol), {}
    loss_limit = dict.fromkeys(loss_rel, loss_tol)
    if floor_and_control:
        _, losses_r, grads_r = plain_run(plain_points_rotated(msda),
                                         points_rotated=True)
        floor_loss, floor_grad = against_plain(losses_r, grads_r)
        res["floor"] = summary(floor_loss, floor_grad)
        limit = {n: max(grad_tol, FLOOR_MARGIN * floor_grad[n])
                 for n in grad_rel}
        loss_limit = {k: max(loss_tol, FLOOR_MARGIN * floor_loss[k])
                      for k in loss_rel}
        # how far the kernel run's error exceeds the floor's on the 20
        # tensors where the floor is largest
        res["kernel_over_floor"] = max(
            grad_rel[n] / max(floor_grad[n], 1e-12) for n in sorted(
                floor_grad, key=lambda n: -floor_grad[n])[:20])
        with computed_in_f32(model):
            _, losses_f, grads_f = plain_run(msda.ms_deform_attn_plain)
        res["control"] = summary(*against_plain(losses_f, grads_f))
    state.optimizer.zero_grad()
    # the five largest errors: (tensor, error, the floor's, the limit)
    res["worst_grads"] = [(n, e, floor_grad.get(n), limit[n]) for n, e in
                          sorted(grad_rel.items(), key=lambda kv: -kv[1])[:5]]
    res["limits_above_grad_tol"] = sum(v > grad_tol for v in limit.values())
    res["max_grad_over_limit"] = max(grad_rel[n] / limit[n]
                                     for n in grad_rel)
    res["max_loss_over_limit"] = max(loss_rel[k] / loss_limit[k]
                                     for k in loss_rel)
    log(f"  step through kernels vs plain (tolerance {loss_tol} relative "
        f"for the losses, {grad_tol} for the gradients"
        + (f" or {FLOOR_MARGIN} x the floor's" if floor_and_control else "")
        + f"): {res}")
    assert res["max_loss_over_limit"] <= 1.0, res
    assert res["max_grad_over_limit"] <= 1.0, res
    if median_grad_tol is not None:
        assert res["median_grad_rel"] <= median_grad_tol, res
    if floor_and_control:
        assert res["control"]["median_grad_rel"] > median_grad_tol, res
    return res


def loss_terms(wd) -> set:
    """The loss terms a weight dict weights: its keys but
    loss_self_training, the coefficient of a self-training step's whole
    target-domain loss (datr_tpu/models/dino.py:718)."""
    return set(wd) - {"loss_self_training"}


def c2f_train_state(n_batches, config=C2F, seed=0, device=None, **overrides):
    """(state, criterion config, weight dict, config) of a C2F
    configuration (with `overrides`, e.g. amp_dtype) with seeded random
    weights on `device` (default: the card), TF32 off."""
    from datr_torch.config import load_config
    from datr_torch.models import build_model
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(config)
    cfg.update(overrides)
    model, ccfg, wd = build_model(cfg, device, seed=seed)
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
    assert weighted == loss_terms(wd), weighted ^ loss_terms(wd)
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


def pseudo_threshold(state, batches, k=30, teacher=None) -> float:
    """A score threshold under which each target image of `batches` keeps
    at least its k best (query, class) candidates before NMS: the seeded
    teacher (the EMA teacher, or `teacher`) scores about 0.01 everywhere
    (the class bias prior), so the configured 0.3 would keep nothing and
    the target loss would be 0."""
    kth = []
    teacher = state.ema_teacher if teacher is None else teacher
    with torch.no_grad():
        for b in batches:
            out = teacher(b["images"][2:], b["pad_mask"][2:])
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
    terms = loss_terms(wd)
    assert weighted == terms | {f"{k}_target" for k in terms if "_dn" not in
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


def tb_scalars(tb_dir) -> dict:
    """{tag: [(step, value)]} of the TensorBoard event files in `tb_dir`,
    read record by record (length, its CRC, an Event protobuf, its CRC)
    with the Event message of tensorboard or, failing that, tensorboardX."""
    import struct

    try:
        from tensorboard.compat.proto.event_pb2 import Event
    except ImportError:
        from tensorboardX.proto.event_pb2 import Event
    out = {}
    for name in sorted(os.listdir(tb_dir)):
        with open(os.path.join(tb_dir, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            ev = Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in ev.summary.value:
                out.setdefault(v.tag, []).append((ev.step, v.simple_value))
    return out


def check_tensorboard(out_dir, lines) -> dict:
    """The run's `<out_dir>/tb` against its log.txt lines: every numeric
    key an f32 scalar of its epoch. Where no TensorBoard backend imports,
    the writer is inactive (datr_tpu's behaviour) and there is no file."""
    from datr_torch.utils.tb import ScalarWriter

    tb_dir = os.path.join(out_dir, "tb")
    probe = ScalarWriter(os.path.join(out_dir, "tb_probe"))
    active = probe.active
    probe.close()
    if not active:
        assert not os.path.exists(tb_dir) or not os.listdir(tb_dir)
        log("  tensorboard: no backend imports here (torch.utils."
            "tensorboard, tensorboardX): the writer was inactive")
        return dict(active=False)
    got = tb_scalars(tb_dir)
    want = {}
    for ln in lines:
        for k, v in ln.items():
            want.setdefault(k, []).append((ln["epoch"], np.float32(v)))
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        assert [(st, np.float32(v)) for st, v in got[k]] == w, (k, got[k], w)
    log(f"  tensorboard: {len(got)} scalars x {len(lines)} epochs in tb/ "
        "equal to the log.txt lines")
    return dict(active=True, tags=len(got))


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

    step_s = {"burnin": [], "self_training": []}

    def counted(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            if name not in step_s:
                return fn(*a, **kw)
            torch.cuda.synchronize()  # each step's time, synchronized
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            step_s[name].append(time.perf_counter() - t0)
            return out
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
            "--options", "synthetic_images=4", "epochs=2", "burn_epochs=1",
            "use_tensorboard=True"])
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
        tb = check_tensorboard(out_dir, lines)
        files = sorted(f for f in os.listdir(out_dir)
                       if not f.startswith("tb"))
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
               step_s=step_s, launches=launches, tensorboard=tb,
               launches_derived=want, n_msda=n_msda, peak_memory_gb=peak_gb,
               allocated_before_gb=base_gb, files=files, sizes_gb=sizes,
               log_lines=[{k: v for k, v in ln.items()
                           if not k.startswith("train_") or k in (
                               "train_loss", "train_num_pseudo")}
                          for ln in lines])
    log(f"  CLI (python -m datr_torch.main -c {C2F_ST} --synthetic "
        f"{' '.join(flags)} --options synthetic_images=4 epochs=2 "
        f"burn_epochs=1 use_tensorboard=True), model {dtype}: {wall_s:.2f} s in main, peak "
        f"{peak_gb:.2f} GB ({base_gb:.2f} GB before) on {card}")
    for i, ep in enumerate(epochs):
        log(f"  epoch {i}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in ep.items()))
    log(f"  s per step by kind (each synchronized) {step_s}")
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
#   with ties) are left out. Over more training states
#   (step_check_states.py) the floor alone exceeds 0.15 in some, on the
#   same tensor as the kernel run and by as much, so each loss and tensor
#   is held to 5e-3 / 0.15 or FLOOR_MARGIN times the floor's reading of
#   it, whichever is larger: on the floor's 20 largest tensors the kernel
#   run's error stays within 1.3x of the floor's.
BF16_FWD_TOL = {"memory": 2.0 ** -3, "memory_mean_abs": 6.5e-3,
                "pred_logits": 0.04, "pred_boxes": 1e-2, "topk_scores": 5e-2}
BF16_FWD_SEPARATES = ("memory_mean_abs", "pred_logits")
FLOOR_MARGIN = 1.5
BF16_STEP_TOL = dict(loss_tol=5e-3, grad_tol=0.15, median_grad_tol=6e-3,
                     losses_only=True, floor_and_control=True)
BF16 = dict(amp_dtype="bfloat16")


def check_msda_bf16(msda) -> dict:
    """msda_fwd and msda_bwd with bf16 value against their plain versions:
    the serving shapes (forward), the training shapes (forward and
    backward; the backward also with corners outside and on the levels'
    borders, at 4 heads and at half the encoder's queries), DINO_5scale's
    five levels (S = 89,523) and DINO_4scale_fast's two points per level in
    f32 and bf16; then msda_bwd in bf16 beside f32 at the training shapes,
    random locations, timed in this call (and msda_fwd in bf16 there)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    dec_src, dec_tgt = TRAIN_DEC_LQ
    half = -(-TRAIN_S // 2)
    # (name, shapes, Lq, dtype, P, backward, locations, heads); the bf16
    # backward also where corners spill off their levels' borders (outside,
    # integer), at a tensor-parallel rank's 4 heads and at a
    # sequence-parallel rank's half of the encoder's queries
    cases = [("serve enc", SHAPES, S, bf, P, False, "random", H),
             ("serve dec", SHAPES, N_QUERIES, bf, P, False, "random", H),
             ("train enc", TRAIN_SHAPES, TRAIN_S, bf, P, True, "random", H),
             ("train dec src", TRAIN_SHAPES, dec_src, bf, P, True, "random",
              H),
             ("train dec tgt", TRAIN_SHAPES, dec_tgt, bf, P, True, "random",
              H),
             ("train enc spill", TRAIN_SHAPES, TRAIN_S, bf, P, True,
              "outside", H),
             ("train enc borders", TRAIN_SHAPES, TRAIN_S, bf, P, True,
              "integer", H),
             ("train dec spill", TRAIN_SHAPES, dec_src, bf, P, True,
              "outside", H),
             ("tp enc", TRAIN_SHAPES, TRAIN_S, bf, P, True, "random", 4),
             ("tp dec", TRAIN_SHAPES, dec_src, bf, P, True, "outside", 4),
             ("sp enc half", TRAIN_SHAPES, half, bf, P, True, "random", H),
             ("5-scale enc", SHAPES5, S5, f32, P, False, "random", H),
             ("5-scale enc", SHAPES5, S5, bf, P, True, "random", H),
             ("5-scale dec", SHAPES5, N_QUERIES, f32, P, True, "random", H),
             ("5-scale dec", SHAPES5, N_QUERIES, bf, P, True, "random", H),
             ("P=2 enc", SHAPES, S, f32, 2, True, "random", H),
             ("P=2 enc", SHAPES, S, bf, 2, True, "random", H),
             ("P=2 dec", SHAPES, N_QUERIES, f32, 2, True, "random", H),
             ("P=2 dec", SHAPES, N_QUERIES, bf, 2, True, "random", H)]
    errs = {}
    for name, sh, lq, dtype, p, backward, where, heads in cases:
        value, loc, attn = msda_inputs(gen, lq, dtype, case=where, shapes=sh,
                                       p=p, heads=heads)
        name = (f"{name} Lq={lq} {dtype_name(value)} L={len(sh)} P={p}"
                + (f" {where}" if where != "random" else "")
                + (f" H={heads}" if heads != H else ""))
        errs[f"msda_fwd {name}"] = check_fwd(msda, name, value, sh, loc,
                                             attn)
        if backward:
            g = torch.randn(B, lq, heads * D, device="cuda",
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


# ---------------------------------------------------------------- phase 9

CANVAS = (800, 1344)  # the flagship's serving canvas
FRAME_HW = (1024, 2048)  # Cityscapes-sized requests
HTTP_CLIENTS, HTTP_REQUESTS, JPEG_REQUESTS = 8, 8, 8
NUM_SELECT = 300  # the server's default: detections per answer
MSDA_PER_FORWARD = 12  # 6 encoder + 6 decoder layers
# HTTP answers against detect on the same decoded image (PERF.md §2's
# eval tolerance): boxes atol 1e-4 x the image's longer side, scores 1e-3
DETECT_TOL = dict(boxes=1e-4 * max(FRAME_HW), scores=1e-3)


def http_post(url, body, timeout=600.0):
    """(status, JSON answer) of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def http_front_end(srv, **kw):
    """serve_http over `srv` on a free local port, served from a thread;
    yields its URL, shut down and joined after."""
    import threading

    from datr_torch.serve import serve_http

    httpd = serve_http(srv, "127.0.0.1", 0, start=False, **kw)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
        assert not t.is_alive(), "the HTTP server thread did not stop"


def http_get(url) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def post_traffic(msda, srv, url, bodies, n, clients) -> dict:
    """`n` POSTs of `bodies` (cycled) from `clients` threads: the main path
    of this part (msda_fwd counted from 0, stats reset just before), every
    answer 200; img/s by wall clock, the clients' p50 / p95, the server's
    stats, launches against MSDA_PER_FORWARD per batch."""
    import threading

    answers, lats, errors = {}, [], []

    def client(idxs):
        try:
            for i in idxs:
                t = time.perf_counter()
                code, out = http_post(url + "/detect", bodies[i % len(bodies)])
                assert code == 200, (code, out)
                lats.append(time.perf_counter() - t)
                answers[i] = out
        except Exception as e:  # re-raised in the calling thread
            errors.append(e)

    threads = [threading.Thread(target=client,
                                args=(range(c, n, clients),))
               for c in range(clients)]
    srv.reset_stats()
    msda.msda_fwd.launches = 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    launches = msda.msda_fwd.launches
    if errors:
        raise errors[0]
    st = srv.stats()
    assert len(answers) == n == st["requests"], (len(answers), st)
    assert launches == MSDA_PER_FORWARD * st["batches"], (launches,
                                                          st["batches"])
    lats.sort()
    return dict(answers=answers, img_s=n / wall, wall_s=wall,
                http_p50_latency_s=lats[len(lats) // 2],
                http_p95_latency_s=lats[min(len(lats) - 1,
                                            int(len(lats) * 0.95))],
                p50_latency_s=st["p50_latency_s"],
                p95_latency_s=st["p95_latency_s"],
                mean_batch_occupancy=st["mean_batch_occupancy"],
                batches=st["batches"], launches=launches)


def detections_diff(got, want) -> dict:
    """Largest differences of one answer (lists or arrays) from another."""
    gb, wb = np.asarray(got["boxes"], np.float32), np.asarray(want["boxes"])
    gs, ws = np.asarray(got["scores"], np.float32), np.asarray(want["scores"])
    assert gb.shape == wb.shape == (NUM_SELECT, 4), (gb.shape, wb.shape)
    assert np.isfinite(gb).all() and np.isfinite(gs).all()
    return dict(boxes=float(np.abs(gb - wb).max()),
                scores=float(np.abs(gs - ws).max()))


def hold_answers(answers, want) -> dict:
    """Each HTTP answer i against want[i % len(want)]: the largest
    differences, held to DETECT_TOL."""
    worst = {"boxes": 0.0, "scores": 0.0}
    for i, out in answers.items():
        d = detections_diff(out, want[i % len(want)])
        worst = {k: max(worst[k], d[k]) for k in worst}
    for k, tol in DETECT_TOL.items():
        assert worst[k] <= tol, f"HTTP answer against detect: {k} {worst}"
    return worst


def wire_decode_launches(wire, sizes, fmt, reps=20) -> dict:
    """The launches of one batch's wire decode on the card: `ops`, the ATen
    ops it dispatches there that are not views (each one kernel or one
    copy), counted by a dispatch mode; and the profiler's device events
    over `reps` decodes, divided by `reps` (`kernels`, `copies`: short
    sessions of the profiler can lose events, so these may read below
    `ops`)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from datr_torch.serve import wire_decode

    dev = wire.cuda().device

    class CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and any(
                    isinstance(t, torch.Tensor) and t.device == dev
                    for t in tree_leaves(out)):
                CountOps.n += 1
            return out

    cuda = torch.autograd.DeviceType.CUDA
    wire, sizes = wire.cuda(), sizes.cuda()
    wire_decode(wire, sizes, CANVAS, fmt)
    with CountOps():
        wire_decode(wire, sizes, CANVAS, fmt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            wire_decode(wire, sizes, CANVAS, fmt)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == cuda]
    copies = sum(n.startswith(("Memcpy", "Memset")) for n in names)
    return dict(ops=CountOps.n, kernels=(len(names) - copies) / reps,
                copies=copies / reps)


def check_wire_decode(srv_y, frames) -> dict:
    """The yuv420 decode of one batch on the card against the same plain
    ops on the CPU (f32 atol 1e-5, the pad mask exactly), and the launches
    of a batch's decode in both wires."""
    from datr_torch import native
    from datr_torch.serve import wire_decode

    packed = [srv_y._preprocess(f) for f in frames[:2]]
    wire = torch.from_numpy(np.stack([w for w, _ in packed]))
    sizes = torch.tensor([hw for _, hw in packed], dtype=torch.int32)
    want_x, want_m = wire_decode(wire, sizes, CANVAS, "yuv420")
    with torch.inference_mode():
        got_x, got_m = wire_decode(wire.cuda(), sizes.cuda(), CANVAS,
                                   "yuv420")
    err = (got_x.cpu() - want_x).abs().max().item()
    assert torch.equal(got_m.cpu(), want_m), "yuv420 pad mask"
    assert err <= 1e-5, f"yuv420 wire decode on the card: {err}"
    u8 = torch.from_numpy(np.stack([native.resize_pad_u8(f, hw, CANVAS)
                                    for f, (_, hw) in zip(frames, packed)]))
    return dict(max_abs_err=err,
                launches_per_batch={"yuv420": wire_decode_launches(
                    wire, sizes, "yuv420"), "u8": wire_decode_launches(
                    u8, sizes, "u8")})


def reconstructed_detections(srv_y, frames) -> list:
    """Each frame's detections by the model's forward on the RGB that the
    yuv420 wire reconstructs (the host packing, the decode on the card),
    outside the server's queue and threads: what the u8 path computes on
    that RGB."""
    from datr_torch.models.postprocess import postprocess
    from datr_torch.serve import wire_decode

    out = []
    for f in frames:
        wire, (oh, ow) = srv_y._preprocess(f)
        # batch of 2 as the server runs it: the second slot empty (padded)
        wire = torch.from_numpy(np.stack([wire, np.zeros_like(wire)])).cuda()
        sizes = torch.tensor([[oh, ow], [0, 0]], dtype=torch.int32).cuda()
        with torch.inference_mode():
            x, pad = wire_decode(wire, sizes, CANVAS, "yuv420")
            out_d = srv_y.model(x, pad)
            res = postprocess(out_d["pred_logits"], out_d["pred_boxes"],
                              torch.ones((2, 2), device=x.device),
                              num_select=NUM_SELECT)
        h0, w0 = f.shape[:2]
        b = res["boxes"][0].float().cpu().numpy() * np.array(
            [w0, h0, w0, h0], np.float32)
        b[:, 0::2] = np.clip(b[:, 0::2], 0, w0)
        b[:, 1::2] = np.clip(b[:, 1::2], 0, h0)
        out.append(dict(boxes=b, scores=res["scores"][0].float().cpu()
                        .numpy()))
    return out


def serving_surface_dtype(msda, card, name, overrides, frames, bodies,
                          jpeg) -> dict:
    """Step 1-3 of phase 9 for one dtype: the u8 server over HTTP (PNG
    bodies, then JPEG ones), then the yuv420 server."""
    from datr_torch import native
    from datr_torch.serve import InferenceServer

    model = flagship_model(**overrides)
    out = {}
    for wire in ("u8", "yuv420"):
        srv = InferenceServer(model, canvas_hw=CANVAS, batch_size=2,
                              num_select=NUM_SELECT, score_threshold=0.0,
                              wire_format=wire)
        try:
            srv.warmup()
            with http_front_end(srv) as url:
                assert http_get(url + "/healthz") == {"ok": True}
                res = post_traffic(msda, srv, url, bodies, HTTP_REQUESTS,
                                   HTTP_CLIENTS)
                st = http_get(url + "/stats")
                assert st["requests"] == HTTP_REQUESTS, st
                if wire == "u8":
                    want = [f.result(timeout=600)
                            for f in [srv.submit(f) for f in frames]]
                    res["held"] = hold_answers(res["answers"], want)
                    if jpeg["driven"] and name == "f32":
                        decoded = [native.decode_jpeg_rgb(b)
                                   for b in jpeg["bodies"]]
                        jp = post_traffic(msda, srv, url, jpeg["bodies"],
                                          JPEG_REQUESTS, HTTP_CLIENTS)
                        want = [f.result(timeout=600)
                                for f in [srv.submit(d) for d in decoded]]
                        jp["held"] = hold_answers(jp.pop("answers"), want)
                        res["jpeg"] = jp
                else:
                    res["wire_decode"] = check_wire_decode(srv, frames)
                    res["held"] = hold_answers(
                        res["answers"],
                        reconstructed_detections(srv, frames))
            del res["answers"]
        finally:
            srv.close()
        log(f"  {name} {wire} over HTTP: {HTTP_REQUESTS} PNG requests from "
            f"{HTTP_CLIENTS} clients, {res['img_s']:.2f} img/s, p50 / p95 "
            f"{res['http_p50_latency_s']:.3f} / "
            f"{res['http_p95_latency_s']:.3f} s (server "
            f"{res['p50_latency_s']:.3f} / {res['p95_latency_s']:.3f}), "
            f"occupancy {res['mean_batch_occupancy']:.2f}, msda_fwd "
            f"{res['launches']} in {res['batches']} batches; against detect "
            f"{res['held']} on {card}")
        out[wire] = res
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def overload(msda) -> dict:
    """A burst of 16 POSTs at a server that takes 2 queued requests and an
    HTTP front end that takes 4 at once: at least one 503 overloaded, every
    request answered, and close() returns with every thread stopped."""
    import threading

    from datr_torch.data import png
    from datr_torch.serve import InferenceServer
    from datr_torch.tools.serve_bench import synthetic_frames

    # a small body: the front end sheds before reading it, and a client
    # still sending a large one would see the connection reset
    body = png.encode_png(synthetic_frames(1, (64, 128), seed=5)[0])
    srv = InferenceServer(flagship_model(), canvas_hw=CANVAS, batch_size=2,
                          num_select=NUM_SELECT, score_threshold=0.0,
                          max_queue=2)
    codes = []
    try:
        srv.warmup()
        with http_front_end(srv, max_concurrent=4,
                            submit_timeout_s=0.05) as url:
            def hit():
                codes.append(http_post(url + "/detect", body))

            threads = [threading.Thread(target=hit) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
    finally:
        t0 = time.perf_counter()
        srv.close()
        close_s = time.perf_counter() - t0
    alive = [t.name for t in (srv._batcher, *srv._dispatchers,
                              *srv._collectors) if t.is_alive()]
    n503 = sum(c == 503 and o == {"error": "overloaded"} for c, o in codes)
    n200 = sum(c == 200 for c, _ in codes)
    log(f"  overload: 16 requests -> {n200} x 200, {n503} x 503 overloaded, "
        f"{len(codes) - n200 - n503} other; close() {close_s:.2f} s, threads "
        f"left {alive}")
    assert len(codes) == 16 and n503 >= 1 and n200 + n503 == 16, codes
    assert not alive, alive
    return dict(ok=n200, overloaded=n503, close_s=close_s)


def run_serving_surface(msda, card) -> dict:
    """Phase 9: the serving surface on the card. The flagship over HTTP in
    f32 (TF32 off) and bf16, u8 and yuv420 wires, PNG bodies of 1024x2048
    frames (JPEG ones where libjpeg was found), each answer held to the
    server's own; the bench's traffic through `submit`; the overload
    path."""
    from datr_torch import native
    from datr_torch.data import png
    from datr_torch.tools import serve_bench

    frames = serve_bench.synthetic_frames(8, FRAME_HW, seed=0)
    t0 = time.perf_counter()
    bodies = [png.encode_png(f) for f in frames]
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b, f in zip(bodies, frames):  # lossless: the frames come back
        assert np.array_equal(png.decode_png_rgb(b), f)
    dec_s = (time.perf_counter() - t0) / len(frames)
    log(f"  {len(frames)} PNG bodies, {sum(map(len, bodies)) / 8e6:.2f} MB "
        f"each on average, encoded in {enc_s:.2f} s; decode {dec_s * 1e3:.1f}"
        " ms per body (host, one thread)")
    jpeg = {"bodies": [], "driven": False}
    try:
        jpeg["bodies"] = [native.encode_jpeg_rgb(f, 90) for f in frames]
        jpeg["driven"] = True
    except RuntimeError as e:
        jpeg.update(driven=False, why=str(e)[:300])
        log(json.dumps({"jpeg": "not driven", "why": jpeg["why"]}))
    out = {"png_decode_ms": dec_s * 1e3,
           "png_mb": sum(map(len, bodies)) / 8e6}
    for name, overrides in (("f32", {}),
                            ("bf16", dict(BF16, use_remat=False))):
        out[name] = serving_surface_dtype(msda, card, name, overrides, frames,
                                          bodies, jpeg)
    out["jpeg"] = {k: v for k, v in jpeg.items() if k != "bodies"}
    bench = {}
    for amp in (False, True):
        for wire in ("u8", "yuv420"):
            argv = ["--clients", "4", "--images", "12", "--in_flight", "2",
                    "--wire", wire] + (["--amp"] if amp else [])
            r = serve_bench.run(serve_bench.get_args_parser().parse_args(argv))
            assert r["msda_fwd_launches"] == MSDA_PER_FORWARD * r[
                "batches"], r
            log(f"  serve_bench {' '.join(argv)}: {r['img_s']:.2f} img/s, "
                f"p50 / p95 {r['p50_latency_s']:.3f} / "
                f"{r['p95_latency_s']:.3f} s, occupancy "
                f"{r['mean_batch_occupancy']:.2f} on {card}")
            bench[f"{r['dtype']}_{wire}"] = r
            gc.collect()
            torch.cuda.empty_cache()
    out["bench"] = bench
    out["overload"] = overload(msda)
    out["launches"] = (sum(out[d][w]["launches"] + out[d][w].get(
        "jpeg", {}).get("launches", 0) for d in ("f32", "bf16")
        for w in ("u8", "yuv420"))
        + sum(r["msda_fwd_launches"] for r in bench.values()))
    return out


# ---------------------------------------------------------------- phase 10

BACKBONE_CONFIGS = (("swin_L", "configs/DINO/DINO_4scale_swin.py"),
                    ("convnext_XL", "configs/DINO/DINO_4scale_convnext.py"))
TEACHER_BACKBONE = "swin_L_384_22k"
# the bf16 forward of these models against its plain bf16 version, read as
# phase 8 reads the R50's. On an NVIDIA H100 80GB HBM3 at 700 W (kernel /
# floor / control): memory 0.0625 / 0.0625 / 0.082 (Swin-L), 0.0625 /
# 0.078 / 0.065 (ConvNeXt-XL) at most, and 4.75e-3 / 4.65e-3 / 7.95e-3,
# 5.22e-3 / 5.12e-3 / 7.09e-3 on average; logits 0.0625 (two ulps at |x|
# in [4, 8)) / 0.03125 / 0.053, 0.0625 / 0.03125 / 0.048. (Seeded on the
# card instead, the same models read 5.08e-3 / 4.94e-3 / 7.76e-3 and
# 4.90e-3 / 4.79e-3 / 6.46e-3 on average.) The largest logit difference
# does not separate bf16 from f32 (the kernel runs exceed their
# controls): held at 2^-3, as the largest memory difference is. The mean
# memory lies between floor and control in every reading: held at
# 5.75e-3 (phase 8's 6.5e-3 lay above a ConvNeXt-XL control), and the
# control must exceed it.
BF16_BACKBONE_FWD_TOL = dict(BF16_FWD_TOL, pred_logits=2.0 ** -3,
                             memory_mean_abs=5.75e-3)
BF16_BACKBONE_SEPARATES = ("memory_mean_abs",)


def backbone_parameters(model) -> int:
    return sum(p.numel() for p in model.backbone.parameters())


def run_backbone_serving(msda, card, config) -> dict:
    """The server of `config` (9 classes, seeded weights) at 800x1344,
    batch 2, in f32 with TF32 off and in bf16 (use_remat off, as phase 8):
    requests with 12 msda_fwd launches per batch, the step by CUDA events,
    its peak memory and profile (device busy / idle, top operations), the
    forward through the kernels against the plain forward (f32: the serving
    tolerances; bf16: phase 8's floor and control check, at
    BF16_BACKBONE_FWD_TOL)."""
    from datr_torch.models import dino as dino_mod

    imgs = request_images()
    out = {}
    for mode, overrides in (("f32", {}),
                            ("bf16", dict(BF16, use_remat=False))):
        base_gb = torch.cuda.memory_allocated() / 1e9
        srv = flagship_server(config, **overrides)
        try:
            srv.warmup()
            torch.cuda.synchronize()
            res = serve_requests(srv, msda, imgs)
            batch, sizes = serving_batch(srv, imgs)
            torch.cuda.reset_peak_memory_stats()
            res["step_ms"] = cuda_ms(lambda: srv._step(batch, sizes), 5,
                                     warmup=1)
            res["step_img_s"] = 2e3 / res["step_ms"]
            res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            res["allocated_before_gb"] = base_gb
            res["backbone_parameters"] = backbone_parameters(srv.model)
            log(f"  {config} {mode}: backbone {res['backbone_parameters']} "
                f"parameters; {res['requests']} requests in "
                f"{res['batches']} batches, msda_fwd launches "
                f"{res['launches']}; step {res['step_ms']:.2f} ms = "
                f"{res['step_img_s']:.2f} img/s, peak memory "
                f"{res['peak_memory_gb']:.2f} GB ({base_gb:.2f} GB before) "
                f"on {card}")
            res["profile"] = profile_step(
                lambda: srv._step(batch, sizes).cpu(), top=10)
            kw = {} if mode == "f32" else dict(
                tol=BF16_BACKBONE_FWD_TOL,
                control_above=BF16_BACKBONE_SEPARATES)
            res["forward_diffs"] = check_forward_against_plain(
                srv.model, batch, sizes, msda, dino_mod, **kw)
        finally:
            srv.close()
        out[mode] = res
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_backbone_training(msda, card, config, **overrides) -> dict:
    """train_one_epoch_plain on `config` (with `overrides`) at its own
    canvas and batch (800x1344, 2 images, f32 with TF32 off, the config's
    use_remat), fed by
    make_single_loader with the config's SingleDomainTrainTransform over
    synthetic Cityscapes-sized frames: a warm-up step, then 1 timed step
    (launches, s/step, peak memory), and one step through the kernels
    against the plain versions with the choices held."""
    from datr_torch.data.loader import make_single_loader, to_device
    from datr_torch.data.synthetic import SyntheticDetectionDataset
    from datr_torch.data.transforms import SingleDomainTrainTransform
    from datr_torch.engine import train_one_epoch_plain
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.train.steps import plain_loss_and_grads

    n_batches = 2
    base_gb = torch.cuda.memory_allocated() / 1e9
    state, ccfg, wd, cfg = c2f_train_state(n_batches, config, **overrides)
    model = state.model
    if hasattr(model.backbone, "patch_embed"):
        # seeded as flax seeds it, Swin's biases are all 0: a token of a
        # zero-padded area is then 0 through every block, each LayerNorm
        # of it multiplies its gradient by 1 / sqrt(eps), and Swin-L's 48
        # overflow f32 (datr_tpu's init does the same). A pretrained patch
        # embedding has a bias; this seeded one stands in for it.
        with torch.no_grad():
            model.backbone.patch_embed.bias.normal_(
                0.0, 0.02, generator=torch.Generator(
                    model.level_embed.device).manual_seed(11))
    canvas = (cfg.canvas_h, cfg.canvas_w)
    ds = SyntheticDetectionDataset(cfg.batch_size * n_batches, (1024, 2048),
                                   8, max_objects=16, seed=6)
    tf = SingleDomainTrainTransform(
        cfg.data_aug_scales, cfg.data_aug_max_size,
        cfg.data_aug_scales2_resize, cfg.data_aug_scales2_crop)
    batches = list(make_single_loader(ds, cfg.batch_size, canvas, tf, 100,
                                      num_threads=4))
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    want_fwd = n_msda * (2 if model.use_remat else 1)  # one pass
    want_bwd = n_msda
    warm = train_one_epoch_plain(state, batches[:1], ccfg, wd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = batches[1:2]
    r = timed_epoch(msda, lambda: train_one_epoch_plain(state, steps, ccfg,
                                                        wd), len(steps))
    metrics = r.pop("metrics")
    r["img_s"] = cfg.batch_size / r["step_s"]
    log(f"  {config} train_step_plain, canvas {canvas}, batch "
        f"{cfg.batch_size}, use_remat {model.use_remat}: {len(steps)} steps "
        f"{r['step_s']:.3f} s/step by CUDA events ({r['host_step_s']:.3f} "
        f"s/step host), {r['img_s']:.3f} img/s, peak memory "
        f"{r['peak_memory_gb']:.2f} GB ({base_gb:.2f} GB before) on {card}; "
        f"launches {r['launches']} (per step expected {want_fwd} / "
        f"{want_bwd}); loss {metrics['loss']:.4f} (warm-up "
        f"{warm['loss']:.4f})")
    assert r["launches"] == dict(msda_fwd=want_fwd * len(steps),
                                 msda_bwd=want_bwd * len(steps)), r
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert not any("_DA" in k or "target" in k for k in metrics), metrics
    assert state.step == n_batches and state.amount.sum().item() == 0
    b0 = to_device(batches[0], state.amount.device)
    check = check_step_against_plain(
        state, lambda d: plain_loss_and_grads(state, b0, ccfg, wd, d)[:2],
        msda)
    return dict(r, launches_per_step=dict(msda_fwd=want_fwd,
                                          msda_bwd=want_bwd),
                steps=len(steps), allocated_before_gb=base_gb,
                backbone_parameters=backbone_parameters(model),
                loss=metrics["loss"], against_plain=check)


def run_distillation(msda, card) -> dict:
    """C2F self-training at 1216x2048 (2 + 2 images, f32) with an external
    teacher: the R50 student of the C2F self-training config, the teacher
    that config with the Swin-L backbone, seeded, written by
    save_checkpoint and read back by load_pretrain_params into a model of
    another seed (bitwise); a per-run threshold from the teacher's scores;
    a warm-up step and 1 timed step through
    engine.train_one_epoch_self_training(teacher=...): launches, s/step,
    peak memory, num_pseudo; the teacher and the EMA teacher unchanged; the
    device time of the teacher forward, the pseudo-labels and the student;
    one step through the kernels against the plain versions with the
    pseudo-labels made once."""
    import tempfile

    from datr_torch import engine
    from datr_torch.config import load_config
    from datr_torch.models import dino as dino_mod
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.train.checkpoint import (
        load_pretrain_params,
        save_checkpoint,
    )
    from datr_torch.train.pseudo import pseudo_labels_from_outputs
    from datr_torch.train.steps import self_training_loss_and_grads

    n_batches = 2
    base_gb = torch.cuda.memory_allocated() / 1e9
    state, ccfg, wd, cfg = c2f_train_state(n_batches, C2F_ST, seed=1)
    t_cfg = load_config(C2F_ST)
    t_cfg["backbone"] = TEACHER_BACKBONE
    seeded = dino_mod.build_dino_from_config(t_cfg, seed=3)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_checkpoint(f"{d}/teacher", seeded, 0)
        save_s = time.perf_counter() - t0
        teacher = dino_mod.build_dino_from_config(t_cfg, seed=4)
        t0 = time.perf_counter()
        teacher.load_state_dict(load_pretrain_params(f"{d}/teacher",
                                                     teacher))
        load_s = time.perf_counter() - t0
    want = seeded.state_dict()
    bad = [k for k, v in teacher.state_dict().items()
           if not torch.equal(v, want[k])]
    assert not bad, f"teacher not bitwise after its checkpoint: {bad[:5]}"
    del seeded, want
    teacher.requires_grad_(False)
    assert not teacher.training
    model = state.model
    log(f"  student {cfg.backbone} ({backbone_parameters(model)} backbone "
        f"parameters), teacher {TEACHER_BACKBONE} "
        f"({backbone_parameters(teacher)}; checkpoint saved in {save_s:.2f} "
        f"s, read back in {load_s:.2f} s, bitwise)")
    batches = paired_batches(n_batches, "cuda", seed=7, strong=True)
    thr = pseudo_threshold(state, batches, teacher=teacher)
    thresholds = np.full((model.num_classes,), thr, np.float32)
    n_s = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    n_t = sum(isinstance(m, MSDeformAttn) for m in teacher.modules())
    want_fwd = n_t + 2 * n_s * (2 if model.use_remat else 1)
    want_bwd = 2 * n_s
    held = {n: {k: v.clone() for k, v in m.state_dict().items()}
            for n, m in (("teacher", teacher),
                         ("ema_teacher", state.ema_teacher))}

    def epoch(bs):
        return engine.train_one_epoch_self_training(
            state, bs, ccfg, wd, thresholds, TRAIN_CANVAS, teacher=teacher)

    warm = epoch(batches[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = batches[1:]
    num_pseudo = []
    real_step = engine.train_step_self_training

    def recorded(*a, **kw):  # the metrics stay on the device
        m = real_step(*a, **kw)
        num_pseudo.append(m["num_pseudo"])
        return m

    with mock.patch.object(engine, "train_step_self_training", recorded):
        r = timed_epoch(msda, lambda: epoch(steps), len(steps))
    metrics = r.pop("metrics")
    num_pseudo = [int(n) for n in num_pseudo]
    log(f"  distillation, {len(steps)} steps: {r['step_s']:.3f} s/step by "
        f"CUDA events ({r['host_step_s']:.3f} s/step host), "
        f"{r['img_s']:.3f} img/s (2 + 2 images; the teacher's 2 more), peak "
        f"memory {r['peak_memory_gb']:.2f} GB ({base_gb:.2f} GB before) on "
        f"{card}; threshold {thr:.6f}, num_pseudo {num_pseudo} (warm-up "
        f"{warm['num_pseudo']:.0f}); launches {r['launches']} (per step "
        f"expected {want_fwd} / {want_bwd}: teacher {n_t}, student {n_s} x "
        f"2 passes)")
    assert r["launches"] == dict(msda_fwd=want_fwd * len(steps),
                                 msda_bwd=want_bwd * len(steps)), r
    assert len(num_pseudo) == len(steps) and min(num_pseudo) > 0, num_pseudo
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert metrics["loss_ce_target"] > 0 and metrics["loss_bbox_target"] > 0
    for name, m in (("teacher", teacher), ("ema_teacher", state.ema_teacher)):
        bad = [k for k, v in m.state_dict().items()
               if not torch.equal(v, held[name][k])]
        assert not bad, f"{name} changed by the steps: {bad[:5]}"
    del held

    b = batches[1]
    thr_t = torch.as_tensor(thresholds, device=state.amount.device)
    with torch.no_grad():
        out, teacher_ms = cuda_timed(lambda: teacher(b["images"][2:],
                                                     b["pad_mask"][2:]))
    pseudo, pseudo_ms = cuda_timed(lambda: pseudo_labels_from_outputs(
        out["pred_logits"], out["pred_boxes"], TRAIN_CANVAS, thr_t))
    _, student_ms = cuda_timed(lambda: self_training_loss_and_grads(
        state, b, ccfg, wd, pseudo))
    state.optimizer.zero_grad()
    parts = dict(teacher_forward_ms=teacher_ms, pseudo_labels_ms=pseudo_ms,
                 student_forward_losses_backward_ms=student_ms)
    log(f"  one step's parts by CUDA events: {parts}")

    def run(draws):
        total, src, tgt, _ = self_training_loss_and_grads(
            state, b, ccfg, wd, pseudo, draws)
        return total, {**src, **{f"{k}_target": v for k, v in tgt.items()}}

    check = check_step_against_plain(state, run, msda)
    return dict(r, launches_per_step=dict(msda_fwd=want_fwd,
                                          msda_bwd=want_bwd),
                steps=len(steps), allocated_before_gb=base_gb,
                threshold=thr, num_pseudo=num_pseudo, loss=metrics["loss"],
                parts=parts, against_plain=check,
                teacher_checkpoint=dict(save_s=save_s, load_s=load_s))


def run_backbones(msda, card) -> dict:
    """Phase 10: the Swin-L and ConvNeXt-XL configurations served (f32,
    bf16) and trained one step each, then the Swin-L-teacher distillation
    step; each part's state freed before the next."""
    out = {}
    for name, config in BACKBONE_CONFIGS:
        for part, fn in (("serving", run_backbone_serving),
                         ("training", run_backbone_training)):
            log(f"  --- {name}: {part}")
            out[f"{name}_{part}"] = fn(msda, card, config)
            gc.collect()
            torch.cuda.empty_cache()
    log("  --- distillation: the Swin-L teacher labels for the R50 student")
    out["distillation"] = run_distillation(msda, card)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 11

MASK_CHUNK = 100  # (image, query) pairs per pass of the mask head
# f32 requests to the masks server, and HTTP POSTs (each answer's host
# finish, ~2 s of 50 masks, sets the phase's time)
MASK_SERVE_REQUESTS = 4
MASK_TOP_K = 50  # the server's default: masks answered per request
MASK_ATOL, MASK_IOU_MIN = 1e-3, 0.99
MASK_EVAL_IMAGES, MASK_EVAL_SELECT = 2, 25  # the host finish sets the time


def _ellipse(h, w, box):
    """A binary ellipse inscribed in the xyxy box, [h, w] uint8."""
    x0, y0, x1, y1 = box
    yy, xx = np.ogrid[:h, :w]
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    rx, ry = max((x1 - x0) / 2, 1.0), max((y1 - y0) / 2, 1.0)
    return (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1).astype(
        np.uint8)


def write_mask_tree(root, n=8, hw=FRAME_HW, seed=5, fog=0.0,
                    n_val=MASK_EVAL_IMAGES):
    """<root>/masks/{train,val}/{images, annotations.json}, the
    single-domain layout: n seeded synthetic frames as PNG (fogged by
    `fog`; val: the first n_val, the same files), each object's
    segmentation an ellipse in its box as a 24-gon, a compressed RLE or an
    uncompressed RLE in turn. Returns the decoded frames and the PNG
    bodies."""
    from datr_torch.data import png
    from datr_torch.data.synthetic import SyntheticDetectionDataset
    from datr_torch.utils.rle import encode_mask, string_from_counts

    ds = SyntheticDetectionDataset(n, hw, 8, max_objects=8, seed=seed,
                                   fog=fog)
    base = root / "masks"
    (base / "train" / "images").mkdir(parents=True)
    (base / "val").mkdir()
    os.symlink(base / "train" / "images", base / "val" / "images")
    frames, bodies, images, anns = [], [], [], []
    ang = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    for i in range(n):
        img, tgt = ds.load(i)
        body = png.encode_png(img)
        (base / "train" / "images" / f"{i}.png").write_bytes(body)
        frames.append(img)
        bodies.append(body)
        h, w = img.shape[:2]
        images.append({"id": i + 1, "file_name": f"{i}.png", "height": h,
                       "width": w})
        for box, lab in zip(tgt["boxes"].tolist(), tgt["labels"].tolist()):
            x0, y0, x1, y1 = box
            k = len(anns) % 3
            if k == 0:
                cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
                seg = [np.stack([cx + (x1 - x0) / 2 * np.cos(ang),
                                 cy + (y1 - y0) / 2 * np.sin(ang)],
                                1).reshape(-1).tolist()]
                area = np.pi * (x1 - x0) * (y1 - y0) / 4
            else:
                m = _ellipse(h, w, box)
                c = encode_mask(m)
                seg = {"size": [h, w], "counts": (
                    string_from_counts(c) if k == 1 else c.tolist())}
                area = float(m.sum())
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "bbox": [x0, y0, x1 - x0, y1 - y0], "area": area,
                         "category_id": int(lab), "iscrowd": 0,
                         "segmentation": seg})
    cats = [{"id": c, "name": str(c)} for c in range(1, 9)]
    (base / "train" / "annotations.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": cats}))
    keep = {im["id"] for im in images[:n_val]}
    (base / "val" / "annotations.json").write_text(json.dumps({
        "images": images[:n_val],
        "annotations": [a for a in anns if a["image_id"] in keep],
        "categories": cats}))
    return frames, bodies


def check_masks_against_plain(model, batch, sizes, orig_hw, msda,
                              dino_mod) -> dict:
    """One batch's pred_masks through the kernels and through the plain
    MSDA (TF32 off, the two-stage selection held): the largest |kernel -
    plain| (atol MASK_ATOL), and each image's top MASK_TOP_K masks (the
    kernel run's detections) finished on the host from both runs: every
    IoU >= MASK_IOU_MIN (two empty masks count 1)."""
    from datr_torch.models.postprocess import postprocess
    from datr_torch.models.segmentation import det_mask_rles
    from datr_torch.serve import wire_decode
    from datr_torch.train.steps import gather_masks
    from datr_torch.utils.rle import area_of_counts, mask_iou

    images = torch.from_numpy(batch).cuda()
    real = torch.from_numpy(sizes).cuda()
    with torch.inference_mode():
        x, pad = wire_decode(images, real, CANVAS, "u8")
        out_k = model(x, pad)
        idx = out_k["topk_idx"]
        with mock.patch.object(msda, "ms_deform_attn",
                               msda.ms_deform_attn_plain), \
                mock.patch.object(dino_mod, "_stable_topk_indices",
                                  lambda s, k: idx):
            out_p = model(x, pad)
        res = postprocess(out_k["pred_logits"], out_k["pred_boxes"],
                          torch.ones((x.shape[0], 2), device=x.device))
        q = res["queries"][:, :MASK_TOP_K]
        m_k = gather_masks(out_k["pred_masks"], q).float().cpu().numpy()
        m_p = gather_masks(out_p["pred_masks"], q).float().cpu().numpy()
        max_abs = (out_k["pred_masks"] - out_p["pred_masks"]).abs().max()
    ious, areas = [], []
    for i, (h, w) in enumerate(orig_hw):
        for a, b in zip(*(det_mask_rles(m[i], CANVAS, tuple(sizes[i]),
                                        (h, w)) for m in (m_k, m_p))):
            areas.append(area_of_counts(a))
            both_empty = areas[-1] == 0 and area_of_counts(b) == 0
            ious.append(1.0 if both_empty else float(
                mask_iou([a], [b], np.zeros(1, bool), h, w)[0, 0]))
    out = dict(pred_masks_max_abs=max_abs.item(), min_iou=min(ious),
               mean_iou=float(np.mean(ious)), masks=len(ious),
               empty_masks=int(sum(a == 0 for a in areas)),
               mean_area_share=float(np.mean(areas)) / float(
                   np.mean([h * w for h, w in orig_hw])))
    log(f"  masks through the kernels vs plain (atol {MASK_ATOL}, IoU >= "
        f"{MASK_IOU_MIN}): {out}")
    assert out["pred_masks_max_abs"] <= MASK_ATOL, out
    assert out["min_iou"] >= MASK_IOU_MIN, out
    return out


def _check_mask_answer(img, r):
    """An answer of the masks server: 300 detections, the top MASK_TOP_K
    with RLE counts covering the frame, the rest None."""
    h, w = img.shape[:2]
    assert r["boxes"].shape == (NUM_SELECT, 4)
    assert np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()
    assert len(r["masks"]) == NUM_SELECT
    for k, c in enumerate(r["masks"]):
        if k < MASK_TOP_K:
            assert c is not None and int(np.sum(c)) == h * w, k
        else:
            assert c is None, k


def run_masks_serving(msda, card, frames, bodies) -> dict:
    """The masks server in f32 (TF32 off): requests, step, memory,
    profile, the checks against the plain forward, HTTP; then one batch
    in bf16."""
    from datr_torch.models import dino as dino_mod
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.serve import InferenceServer

    out = {}
    for mode, overrides in (("f32", {}), ("bf16", dict(BF16,
                                                        use_remat=False))):
        base_gb = torch.cuda.memory_allocated() / 1e9
        model = flagship_model(masks=True, mask_query_chunk=MASK_CHUNK,
                               **overrides)
        n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
        srv = InferenceServer(model, canvas_hw=CANVAS, batch_size=2,
                              score_threshold=0.0, batch_timeout_s=1.0,
                              mask_top_k=MASK_TOP_K)
        reqs = frames[:MASK_SERVE_REQUESTS] if mode == "f32" else frames[:2]
        try:
            srv.warmup()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # ---- the main path: counts from 0, requests, counts read ----
            msda.msda_fwd.launches = 0
            t0 = time.perf_counter()
            answers = [f.result(timeout=600)
                       for f in [srv.submit(im) for im in reqs]]
            wall_s = time.perf_counter() - t0
            launches = msda.msda_fwd.launches
            st = srv.stats()
            assert st["requests"] == len(reqs)
            assert launches == n_msda * st["batches"], (launches, st)
            for im, r in zip(reqs, answers):
                _check_mask_answer(im, r)
            r = dict(requests=len(reqs), batches=st["batches"],
                     launches=launches, wall_img_s=len(reqs) / wall_s,
                     serving_peak_memory_gb=torch.cuda.max_memory_allocated()
                     / 1e9, allocated_before_gb=base_gb)
            batch, sizes = serving_batch(srv, reqs)
            r["step_ms"] = cuda_ms(lambda: srv._step(batch, sizes), 5,
                                   warmup=1)
            r["step_img_s"] = 2e3 / r["step_ms"]
            log(f"  masks server {mode}: {r['requests']} requests in "
                f"{r['batches']} batches ({r['wall_img_s']:.2f} img/s by "
                f"wall clock with the host finish), msda_fwd launches "
                f"{launches}; step {r['step_ms']:.2f} ms = "
                f"{r['step_img_s']:.2f} img/s, peak memory "
                f"{r['serving_peak_memory_gb']:.2f} GB ({base_gb:.2f} GB "
                f"before) on {card}")
            if mode == "f32":
                r["profile"] = profile_step(
                    lambda: [t.cpu() for t in srv._step(batch, sizes)],
                    top=10)
                r["forward_diffs"] = check_forward_against_plain(
                    srv.model, batch, sizes, msda, dino_mod)
                r["masks_against_plain"] = check_masks_against_plain(
                    srv.model, batch, sizes,
                    [im.shape[:2] for im in reqs[:2]], msda, dino_mod)
                # HTTP: one request at a time, each answer's masks equal to
                # detect's of the same decoded frame
                srv.batch_timeout_s = 0.02
                msda.msda_fwd.launches = 0
                with http_front_end(srv) as url:
                    posted = [http_post(url + "/detect", b)
                              for b in bodies[:MASK_SERVE_REQUESTS]]
                r["http_launches"] = msda.msda_fwd.launches
                for (code, ans), im in zip(posted, frames):
                    assert code == 200, (code, ans)
                    want = srv.detect(im)
                    assert len(ans["masks"]) == NUM_SELECT
                    for k, (m, wm) in enumerate(zip(ans["masks"],
                                                    want["masks"])):
                        if wm is None:
                            assert m is None, k
                        else:
                            assert m["size"] == list(im.shape[:2]), k
                            assert m["counts"] == wm.tolist(), k
                r["http_posts"] = len(posted)
                log(f"  {len(posted)} HTTP POSTs: every answer's mask RLEs "
                    f"equal detect's; msda_fwd launches "
                    f"{r['http_launches']}")
        finally:
            srv.close()
        out[mode] = r
        del srv, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_masks_eval(msda, card, root) -> dict:
    """engine.evaluate(segm=True) of the seeded masks model over the val
    split (batch 2), the host finish timed by wrapping det_mask_rles."""
    from datr_torch import engine
    from datr_torch.data.coco import build_dataset
    from datr_torch.data.loader import make_eval_loader
    from datr_torch.data.transforms import EvalTransform
    from datr_torch.models.layers import MSDeformAttn

    model = flagship_model(masks=True, mask_query_chunk=MASK_CHUNK)
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    ds = build_dataset("val", "masks", str(root))
    loader = make_eval_loader(ds, 2, CANVAS, EvalTransform(800, 1333), 100)
    finish_s, n_dets = [0.0], [0]
    det_mask_rles = engine.det_mask_rles

    def timed_finish(logits, *a, **kw):
        t0 = time.perf_counter()
        rles = det_mask_rles(logits, *a, **kw)
        finish_s[0] += time.perf_counter() - t0
        n_dets[0] += len(rles)
        return rles

    msda.msda_fwd.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(engine, "det_mask_rles", timed_finish):
        stats = engine.evaluate(model, loader, range(1, 9),
                                num_select=MASK_EVAL_SELECT, segm=True)
    wall_s = time.perf_counter() - t0
    launches = msda.msda_fwd.launches
    n_img = len(ds)
    assert launches == n_msda * loader.n_batches, launches
    for key in ("coco_eval_bbox", "coco_eval_masks"):
        v = np.asarray(stats[key])
        assert v.shape == (12,) and np.isfinite(v).all(), (key, v)
        assert ((v >= -1) & (v <= 1)).all(), (key, v)
    out = dict(images=n_img, launches=launches,
               img_s=n_img / wall_s, wall_s=wall_s,
               host_finish_s=finish_s[0], detections=n_dets[0],
               host_finish_share=finish_s[0] / wall_s,
               host_finish_ms_per_detection=1e3 * finish_s[0] / n_dets[0],
               coco_eval_bbox=[float(x) for x in stats["coco_eval_bbox"]],
               coco_eval_masks=[float(x) for x in stats["coco_eval_masks"]])
    log(f"  evaluate(segm=True): {n_img} images in {wall_s:.2f} s "
        f"({out['img_s']:.3f} img/s by wall clock), the host finish "
        f"{finish_s[0]:.2f} s for {n_dets[0]} detections "
        f"({out['host_finish_share']:.1%}); msda_fwd launches {launches}; "
        f"bbox {out['coco_eval_bbox']}, segm {out['coco_eval_masks']} on "
        f"{card}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_masks_training(msda, card, root) -> dict:
    """train_one_epoch_plain of the flagship with masks (800x1344, batch
    2, use_remat) over the tree's train split through make_single_loader
    with return_masks: a warm-up step and 1 timed step, then one step
    against the plain step."""
    from datr_torch.data.coco import build_dataset
    from datr_torch.data.loader import make_single_loader, to_device
    from datr_torch.data.transforms import SingleDomainTrainTransform
    from datr_torch.engine import train_one_epoch_plain
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.train.steps import plain_loss_and_grads

    n_batches = 4
    base_gb = torch.cuda.memory_allocated() / 1e9
    state, ccfg, wd, cfg = c2f_train_state(
        n_batches, "configs/DINO/DINO_4scale.py", num_classes=9, masks=True,
        mask_query_chunk=MASK_CHUNK)
    model = state.model
    assert model.with_masks and model.use_remat
    assert {"loss_mask", "loss_dice"} <= set(wd)
    ds = build_dataset("train", "masks", str(root), return_masks=True)
    tf = SingleDomainTrainTransform(
        cfg.data_aug_scales, cfg.data_aug_max_size,
        cfg.data_aug_scales2_resize, cfg.data_aug_scales2_crop)
    canvas = (cfg.canvas_h, cfg.canvas_w)
    batches = list(make_single_loader(ds, cfg.batch_size, canvas, tf, 100,
                                      num_threads=4))
    assert len(batches) == n_batches and batches[0]["masks"].shape == (
        cfg.batch_size, 100, canvas[0] // 4, canvas[1] // 4)
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    want_fwd, want_bwd = 2 * n_msda, n_msda  # one pass, remat's recompute
    warm = train_one_epoch_plain(state, batches[:1], ccfg, wd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = batches[1:2]
    r = timed_epoch(msda, lambda: train_one_epoch_plain(state, steps, ccfg,
                                                        wd), len(steps))
    metrics = r.pop("metrics")
    r["img_s"] = cfg.batch_size / r["step_s"]
    log(f"  train_step_plain with masks, canvas {canvas}, batch "
        f"{cfg.batch_size}, mask_query_chunk {MASK_CHUNK}: {len(steps)} "
        f"steps {r['step_s']:.3f} s/step by CUDA events "
        f"({r['host_step_s']:.3f} s/step host), {r['img_s']:.3f} img/s, "
        f"peak memory {r['peak_memory_gb']:.2f} GB ({base_gb:.2f} GB "
        f"before) on {card}; launches {r['launches']} (per step expected "
        f"{want_fwd} / {want_bwd}); loss {metrics['loss']:.4f}, loss_mask "
        f"{metrics['loss_mask']:.4f}, loss_dice {metrics['loss_dice']:.4f} "
        f"(warm-up loss {warm['loss']:.4f})")
    assert r["launches"] == dict(msda_fwd=want_fwd * len(steps),
                                 msda_bwd=want_bwd * len(steps)), r
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert metrics["loss_mask"] > 0 and metrics["loss_dice"] > 0, metrics
    b0 = to_device(batches[0], state.amount.device)
    check = check_step_against_plain(
        state, lambda d: plain_loss_and_grads(state, b0, ccfg, wd, d)[:2],
        msda)
    out = dict(r, launches_per_step=dict(msda_fwd=want_fwd,
                                         msda_bwd=want_bwd),
               steps=len(steps), allocated_before_gb=base_gb,
               loss=metrics["loss"], loss_mask=metrics["loss_mask"],
               loss_dice=metrics["loss_dice"], against_plain=check)
    del state, batches, b0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_masks(msda, card) -> dict:
    """Phase 11: the instance-mask path on its COCO tree: serving, the
    segm evaluation, training; each part's state freed before the next."""
    import pathlib
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        frames, bodies = write_mask_tree(root)
        out["tree_s"] = time.perf_counter() - t0
        log(f"  wrote {len(frames)} frames with instance masks "
            f"({sum(map(len, bodies)) / 1e6:.2f} MB of PNG) in "
            f"{out['tree_s']:.2f} s")
        for part, fn in (
                ("serving", lambda: run_masks_serving(msda, card, frames,
                                                      bodies)),
                ("eval", lambda: run_masks_eval(msda, card, root)),
                ("training", lambda: run_masks_training(msda, card, root))):
            log(f"  --- masks: {part}")
            out[part] = fn()
    return out


# ---------------------------------------------------------------- phase 12

FLAGSHIP = "configs/DINO/DINO_4scale.py"
SHARED = dict(two_stage_bbox_embed_share=True)
HOST_OPS = ("resize_pad_u8", "resize_normalize_pad", "rgb_to_yuv420")


def run_shared_heads(msda, card) -> dict:
    """The flagship with shared two-stage heads, built through the
    registry: served at 800x1344, batch 2, f32 with TF32 off (requests at
    12 msda_fwd launches per batch, the step by CUDA events, the forward
    through the kernels against the plain forward at phase 3's
    tolerances), then one train_step_plain as phase 10 trains the other
    backbones (warm-up + 1 timed step at 24 / 12 launches, the step
    against the plain step)."""
    from datr_torch.models import dino as dino_mod

    imgs = request_images()
    srv = flagship_server(FLAGSHIP, **SHARED)
    try:
        model = srv.model
        assert model.two_stage_share_heads
        assert model.enc_out_class_head is model.class_head
        assert not any(k.startswith("enc_out_") for k in model.state_dict())
        srv.warmup()
        torch.cuda.synchronize()
        res = serve_requests(srv, msda, imgs)
        batch, sizes = serving_batch(srv, imgs)
        res["step_ms"] = cuda_ms(lambda: srv._step(batch, sizes), 10,
                                 warmup=2)
        res["step_img_s"] = 2e3 / res["step_ms"]
        log(f"  shared heads, served: {res['requests']} requests in "
            f"{res['batches']} batches, msda_fwd launches "
            f"{res['launches']}; step {res['step_ms']:.2f} ms = "
            f"{res['step_img_s']:.2f} img/s (f32, TF32 off) on {card}")
        res["forward_diffs"] = check_forward_against_plain(
            model, batch, sizes, msda, dino_mod)
    finally:
        srv.close()
    del srv, model
    gc.collect()
    torch.cuda.empty_cache()
    train = run_backbone_training(msda, card, FLAGSHIP, num_classes=9,
                                  **SHARED)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(serving=res, training=train)


def host_ms(fn, reps) -> float:
    """Median host milliseconds of `reps` calls of fn()."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def calls_per_s(fn, threads=4, per_thread=6) -> float:
    """fn() from `threads` threads at once, `per_thread` calls each: calls
    per second by wall clock (the loader's and submit's parallelism)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as pool:
        t0 = time.perf_counter()
        for f in [pool.submit(fn) for _ in range(threads * per_thread)]:
            f.result()
        return threads * per_thread / (time.perf_counter() - t0)


def openmp_image_ops():
    """csrc/image_ops.cpp built as datr_tpu builds its copy, with -fopenmp
    (the package builds it without), into a temporary directory, its entry
    points declared: the measured alternative. Returns (library, build s)
    or (None, why) where the machine cannot build it."""
    import ctypes
    import tempfile

    from datr_torch import native

    with tempfile.TemporaryDirectory() as tmp:  # loaded, then unlinked
        so = os.path.join(tmp, "libimage_ops_omp.so")
        cmd = ["g++", *native.IMAGE_OPS_FLAGS, "-fopenmp", "-shared",
               "-fPIC", "-std=c++17", str(native.CSRC_DIR / "image_ops.cpp"),
               "-o", so]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            return None, proc.stderr[-500:]
        lib = ctypes.CDLL(so)
    for name, (argtypes, restype) in native.IMAGE_OPS_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib, time.perf_counter() - t0


def run_host_ops(card, build, omp) -> dict:
    """The C++ host ops against their plain versions on seeded 1024x2048
    frames at the serving and the loader's sizes (resize_normalize_pad and
    rgb_to_yuv420 bitwise, resize_pad_u8 within one count, with the share
    that differs); each timed beside its plain version on one thread, and
    the same source built with OpenMP (`omp`: the library, or None; the
    default thread count) timed beside the package's build, alone and from
    4 threads at once."""
    from datr_torch import native
    from datr_torch.data.transforms import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        get_size_with_aspect_ratio,
    )

    frames = [np.random.default_rng(s).integers(0, 256, (*FRAME_HW, 3),
                                                dtype=np.uint8)
              for s in range(2)]
    oh, ow = get_size_with_aspect_ratio(FRAME_HW[::-1], 800, 1333)
    serving_canvas = native.resize_pad_u8(frames[0], (oh, ow), CANVAS)
    norm = (IMAGENET_MEAN, IMAGENET_STD)
    # name -> (C++ call, plain call); the loader's canvas step at a scaled
    # (1.5x scales capped by the canvas) and an unscaled extent
    cases = {
        "resize_pad_u8": lambda f, op: op(f, (oh, ow), CANVAS),
        "rgb_to_yuv420": lambda f, op: op(serving_canvas, (oh, ow)),
        "resize_normalize_pad_scaled": lambda f, op: op(
            f, (922, 1843), TRAIN_CANVAS, *norm),
        "resize_normalize_pad_unscaled": lambda f, op: op(
            f, FRAME_HW, TRAIN_CANVAS, *norm),
    }
    out = {"build": build, "cpus": os.cpu_count(), "cases": {}}
    for name, call in cases.items():
        base = name if name in HOST_OPS else "resize_normalize_pad"
        cpp = getattr(native, base)
        plain = getattr(native, base + "_plain")
        got, want = call(frames[1], cpp), call(frames[1], plain)
        d = np.abs(got.astype(np.int32) - want.astype(np.int32)) \
            if got.dtype == np.uint8 else np.abs(got - want)
        r = dict(max_abs_diff=float(d.max()),
                 differing_share=float((got != want).mean()),
                 ms=host_ms(lambda: call(frames[1], cpp), 7),
                 plain_ms=host_ms(lambda: call(frames[1], plain), 2),
                 calls_per_s_4_threads=calls_per_s(
                     lambda: call(frames[1], cpp)))
        if base == "resize_pad_u8":
            assert r["max_abs_diff"] <= 1, (name, r)
        else:
            assert r["max_abs_diff"] == 0, (name, r)
        if omp is not None:
            with mock.patch.dict(native._host_libs, {"image_ops": omp}):
                assert np.array_equal(call(frames[1], cpp), got), name
                r["openmp_ms"] = host_ms(lambda: call(frames[1], cpp), 7)
                r["openmp_calls_per_s_4_threads"] = calls_per_s(
                    lambda: call(frames[1], cpp))
        out["cases"][name] = r
        log(f"  {name}: C++ {r['ms']:.2f} ms, plain {r['plain_ms']:.2f} ms "
            f"(one thread); C++ from 4 threads "
            f"{r['calls_per_s_4_threads']:.1f} calls/s; OpenMP build "
            f"{r.get('openmp_ms', float('nan')):.2f} ms alone, "
            f"{r.get('openmp_calls_per_s_4_threads', float('nan')):.1f} "
            f"calls/s from 4 threads; max |C++ - plain| "
            f"{r['max_abs_diff']}, differing share {r['differing_share']:.6f}"
            f" ({os.cpu_count()} CPUs)")
    return out


@contextlib.contextmanager
def plain_host_ops():
    """The package's three host ops replaced by their plain numpy
    versions while the block runs (a measurement's control; the package
    has no such switch)."""
    from datr_torch import native

    with contextlib.ExitStack() as stack:
        for name in HOST_OPS:
            stack.enter_context(mock.patch.object(
                native, name, getattr(native, name + "_plain")))
        yield


def run_host_traffic(msda, card, omp) -> dict:
    """The loader's img/s (phase 7's loader_rate: 4 threads, 1024x2048, 3
    batches) and serve_bench through submit (u8, f32, 4 clients, 24
    images) with the plain versions patched in, through the C++ host ops
    and (where `omp`, the OpenMP build, is given) through that build; one
    loader run of 3 batches per variant."""
    from datr_torch import native
    from datr_torch.tools import serve_bench

    argv = ["--clients", "4", "--images", "24", "--in_flight", "2",
            "--wire", "u8"]
    variants = [("plain", plain_host_ops), ("cpp", contextlib.nullcontext)]
    if omp is not None:
        variants.append(("openmp", lambda: mock.patch.dict(
            native._host_libs, {"image_ops": omp})))
    out = {ops: {"loader": []} for ops, _ in variants}
    for ops, ctx in variants:
        with ctx():
            out[ops]["loader"].append(loader_rate(n_batches=3))
            r = serve_bench.run(serve_bench.get_args_parser().parse_args(
                argv))
        assert r["msda_fwd_launches"] == MSDA_PER_FORWARD * r["batches"], r
        log(f"  host ops {ops}: serve_bench {' '.join(argv)}: "
            f"{r['img_s']:.2f} img/s, p50 / p95 {r['p50_latency_s']:.3f} / "
            f"{r['p95_latency_s']:.3f} s, occupancy "
            f"{r['mean_batch_occupancy']:.2f} on {card}")
        out[ops]["submit"] = r
        gc.collect()
        torch.cuda.empty_cache()
    for ops, _ in variants:
        rates = [x["img_s"] for x in out[ops]["loader"]]
        out[ops]["loader_img_s"] = float(np.mean(rates))
        log(f"  host ops {ops}: loader {rates} img/s, mean "
            f"{out[ops]['loader_img_s']:.3f}; submit "
            f"{out[ops]['submit']['img_s']:.2f} img/s")
    return out


def run_benchmark_tool(card) -> dict:
    """`python -m datr_torch.tools.benchmark` on the flagship (9 classes)
    at 800x1344, batch 1, its line printed."""
    import tempfile

    from datr_torch.tools import benchmark

    with tempfile.TemporaryDirectory() as tmp:
        r = benchmark.main(["-c", FLAGSHIP, "--options", "num_classes=9",
                            "--hw", "800", "1344", "--batch", "1",
                            "--out", os.path.join(tmp, "log.txt")])
    assert r["device"] == torch.cuda.get_device_name(0)
    assert r["fps"] > 0 and r["gflops_per_image"] > 0, r
    log(f"  benchmark tool: {json.dumps(r)} on {card}")
    gc.collect()
    torch.cuda.empty_cache()
    return r


def run_registry_and_host(msda, card, host_build) -> dict:
    """Phase 12: shared two-stage heads through the registry, the C++ host
    ops, the loader and submit traffic with and without them, the
    benchmark tool."""
    omp, omp_build = openmp_image_ops()
    out = {"openmp_build_s" if omp else "openmp_unavailable": omp_build}
    for part, fn in (
            ("shared_heads", lambda: run_shared_heads(msda, card)),
            ("host_ops", lambda: run_host_ops(card, host_build, omp)),
            ("traffic", lambda: run_host_traffic(msda, card, omp)),
            ("benchmark", lambda: run_benchmark_tool(card))):
        log(f"  --- {part}")
        t0 = time.perf_counter()
        out[part] = fn()
        out[f"{part}_s"] = time.perf_counter() - t0
    sh = out["shared_heads"]
    out["launches"] = dict(
        msda_fwd=(sh["serving"]["launches"]
                  + sh["training"]["launches"]["msda_fwd"]
                  + sum(t["submit"]["msda_fwd_launches"]
                        for t in out["traffic"].values())),
        msda_bwd=sh["training"]["launches"]["msda_bwd"])
    return out


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- phase 13

DIST_WORLD = 2  # ranks sharing the one card over gloo (NCCL refuses that)
DIST_STEPS = 1  # timed burn-in steps per rank, after a warm-up step
DIST_ST_STEPS = 1  # self-training steps per rank
# the host's mask finish (~90 ms a detection) sets 13c's time
DIST_EVAL_IMAGES, DIST_EVAL_SELECT = 4, 10
DIST_SERVE_REQUESTS = 6
# the C2F model's depth on phase 13's ranks and in its checkpoint (full
# width), as phase 14's: the smoke must fit its limit on the card's
# slowest hosts
DIST_DEPTH = dict(enc_layers=2, dec_layers=2)


def _rank_device() -> torch.device:
    """The one card, which every rank of phase 13 shares."""
    return torch.device("cuda", 0)


def _dist_entry(rank, world, tmp, task, kwargs):
    """One rank of phase 13 (spawned): gloo over CUDA tensors on the one
    card, started by the package's `init_from_env` with torchrun's
    variables set and a FileStore in `tmp` (one per task), the kernel
    library the parent built; runs `task` and saves what it returns to
    `tmp/<task>.rank<r>.pt`."""
    import faulthandler

    import torch.distributed as dist

    from datr_torch.ops import _build
    from datr_torch.parallel import dist as pdist

    faulthandler.enable()  # a rank's fatal signal prints its stack
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK="0")
    pdist.init_from_env(_rank_device(), backend="gloo", store=dist.FileStore(
        os.path.join(tmp, f"{task}.store"), world))
    try:
        _build.load_library()
        memoize_seeded_inits()
        out = globals()[task](rank, world, tmp, **kwargs)
        torch.save(out, os.path.join(tmp, f"{task}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(task, tmp, world=DIST_WORLD, **kwargs) -> list:
    """Run `task` on `world` spawned ranks; every rank must end well. Each
    rank's result, in rank order."""
    import torch.multiprocessing as mp

    mp.start_processes(_dist_entry, args=(world, tmp, task, kwargs),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(os.path.join(tmp, f"{task}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


@contextlib.contextmanager
def one_process_view():
    """The package as one process sees it (no all-reduce of counts, sums
    or metrics), for a rank's run of the whole batch."""
    from datr_torch.parallel import dist as pdist

    with mock.patch.object(pdist, "process_count", lambda *a: 1), \
            mock.patch.object(pdist, "data_parallel", lambda: False):
        yield


def _on(batch, device):
    return {k: v.to(device) for k, v in batch.items()}


def _bits_of(tensors) -> torch.Tensor:
    """Two int64 sums of the bit patterns of f32 tensors, taken as one
    flat sequence (plain and position-weighted): equal on two ranks only
    if (but for a vanishing chance) the tensors are bitwise equal."""
    total, pos = None, 0
    for t in tensors:
        b = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = (torch.arange(b.numel(), device=b.device) + pos) % 65521 + 1
        part = torch.stack([b.sum(), (b * w).sum()])
        total = part if total is None else total + part.to(total.device)
        pos += b.numel()
    return total


def _bits(state) -> torch.Tensor:
    """`_bits_of` every parameter and the prototype state."""
    return _bits_of([*state.model.parameters(), state.global_proto,
                     state.amount])


def _ranks_agree(state) -> bool:
    import torch.distributed as dist

    mine = _bits(state).cpu()
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return all(torch.equal(p, parts[0]) for p in parts)


def _gathered(t: torch.Tensor, axis=None) -> torch.Tensor:
    """The whole of a tensor sharded on dim 0 (FSDP's DTensor) over the
    world or the mesh axis `axis`, by c10d's all_gather of the padded
    local shards (DTensor.full_tensor's functional all-gather dies of a
    segmentation fault over gloo with CUDA tensors on the card's torch
    2.11); a plain tensor as it is."""
    import torch.distributed as dist

    from datr_torch.parallel import dist as pdist

    if not hasattr(t, "to_local"):
        return t.detach()
    local = t.to_local().detach()
    if axis is None:
        world, me, group = dist.get_world_size(), dist.get_rank(), None
    else:
        world, me = pdist.process_count(axis), pdist.process_index(axis)
        group = pdist.axis_group(axis)
    sizes = [len(c) for c in torch.arange(t.shape[0]).chunk(world)]
    sizes += [0] * (world - len(sizes))
    assert local.shape[0] == sizes[me], (t.shape, local.shape)
    buf = local.new_zeros((max(sizes), *t.shape[1:]))
    buf[:local.shape[0]] = local
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)])


def _grads(state) -> dict:
    return {n: _gathered(p.grad).clone()
            for n, p in state.model.named_parameters() if p.grad is not None}


def _held_to(held, device) -> dict:
    """A record of held_choices on `device` (each choice a tensor or a list
    of them)."""
    def to(v):
        return v.to(device) if torch.is_tensor(v) else [x.to(device)
                                                        for x in v]
    return {k: [to(v) for v in vs] for k, vs in held.items()}


def _against(losses, grads, want_losses, want_grads) -> dict:
    """check_step_against_plain's measures: each loss's relative error,
    each gradient tensor's error relative to its norm (or 1e-4 of the
    whole gradient's, where that is larger)."""
    g_norm = torch.stack([g.norm() for g in want_grads.values()]).norm()
    loss_rel = {k: abs(losses[k] - want_losses[k])
                / max(abs(want_losses[k]), 1e-6) for k in want_losses
                if k.startswith("loss")}
    grad_rel = {n: ((grads[n] - want_grads[n]).norm() / max(
        want_grads[n].norm(), 1e-4 * g_norm)).item() for n in want_grads}
    return dict(max_loss_rel=max(loss_rel.values()),
                worst_loss=max(loss_rel.items(), key=lambda kv: kv[1]),
                max_grad_rel=max(grad_rel.values()),
                median_grad_rel=float(np.median(list(grad_rel.values()))),
                worst_grad=max(grad_rel.items(), key=lambda kv: kv[1]),
                n_grads=len(grad_rel))


def dist_train(rank, world, tmp):
    """Phase 13 a, b, d on one rank. a: the C2F burn-in step on the whole
    global batch (2 + 2 images) in one-process view, its choices recorded
    (the ranks in turn), then the DDP step on this rank's 1 + 1 with its
    share of those choices, against it; a warm-up and DIST_STEPS timed
    burn-in steps and DIST_ST_STEPS self-training steps in DDP, the ranks'
    state compared after each. b: a fresh state under FSDP, one burn-in
    step on the warm-up's batch and draws, against DDP's. d: the FSDP
    state's eval forward of one image, then its sharded save. Before its
    update, the FSDP step's losses and gradients are held against a's DDP
    step on the same batch, draws and choices."""
    import torch.distributed as dist

    from datr_torch.models import cdn as cdn_mod
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.ops import msda
    from datr_torch.parallel.mesh import (
        local_bytes,
        optimizer_local_bytes,
        shard_batch,
        shard_train_state,
    )
    from datr_torch.train import checkpoint as ckpt
    from datr_torch.train.steps import (
        loss_and_grads,
        train_step_burnin,
        train_step_self_training,
    )

    dev = _rank_device()
    out = {}
    state, ccfg, wd, cfg = c2f_train_state(DIST_STEPS + 1, seed=0,
                                           **DIST_DEPTH)
    model = state.model
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    remat = 2 if model.use_remat else 1
    batches = paired_batches(DIST_STEPS + 1, "cpu", seed=2, strong=True)
    groups, _ = cdn_mod.cdn_layout(model.dn_number, model.dn_single_pad)
    draws = cdn_mod.draw_cdn_noise(torch.Generator().manual_seed(7), 2,
                                   groups, model.dn_single_pad,
                                   model.num_classes, "cpu")
    lo = rank  # one source and one target image per rank
    my_draws = cdn_mod.CdnDraws(*(d[lo:lo + 1].to(dev) for d in draws))
    state.dn_generator.manual_seed(rank)  # the state's seed (0) + rank
    mine = [_on(shard_batch(b, rank, world), dev) for b in batches]

    # ---- a: the whole batch in one process's view, the ranks in turn
    want = None
    for r in range(world):
        if r == rank:
            with one_process_view(), held_choices() as rec:
                total, losses, _ = loss_and_grads(
                    state, _on({k: v for k, v in batches[0].items()
                                if k != "images_strong"}, dev),
                    ccfg, wd, draws._replace(**{
                        k: getattr(draws, k).to(dev)
                        for k in draws._fields}))
            want = dict(losses={k: v.item() for k, v in losses.items()},
                        grads=_grads(state), held=rec)
            state.optimizer.zero_grad()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    log(f"  rank {rank}: the whole batch's step recorded")
    shard_train_state(state)  # DDP
    held = want.pop("held")
    with held_choices(rank, world, held) as flips:
        total, losses, _ = loss_and_grads(state, mine[0], ccfg, wd,
                                          my_draws)
    got_losses = {k: v.item() for k, v in losses.items()}
    # DDP's gradients (the ranks' mean) and this rank's losses, for b
    ddp_ref = dict(losses=got_losses, grads={n: g.cpu() for n, g in
                                             _grads(state).items()})
    held = _held_to(held, "cpu")
    # the ranks' mean of each loss is the whole batch's
    lv = torch.tensor([got_losses[k] for k in sorted(got_losses)],
                      dtype=torch.float64)
    dist.all_reduce(lv)
    mean_losses = dict(zip(sorted(got_losses), (lv / world).tolist()))
    check = _against(mean_losses, ddp_ref["grads"], want["losses"],
                     {n: g.cpu() for n, g in want["grads"].items()})
    check.update(relu_calls=flips["relu_calls"],
                 relu_flips=sum(flips["relu_flips"]),
                 cls_flips=sum(flips["cls_flips"]), cells_held=False)
    out["step_check"] = check
    del want, rec
    state.optimizer.zero_grad()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- a: the DDP steps, timed; the ranks' state compared after each
    def step_timed(fn):
        torch.cuda.synchronize()
        dist.barrier()
        msda.msda_fwd.launches = msda.msda_bwd.launches = 0
        t0 = time.perf_counter()
        m = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        return s, m, (msda.msda_fwd.launches, msda.msda_bwd.launches)

    warm = step_timed(lambda: train_step_burnin(
        state, {k: v for k, v in mine[0].items() if k != "images_strong"},
        ccfg, wd, dn_draws=my_draws))
    agree = [_ranks_agree(state)]
    ddp_after = {n: p.detach().cpu().clone()
                 for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    burn = []
    for b in mine[1:]:
        burn.append(step_timed(lambda: train_step_burnin(
            state, {k: v for k, v in b.items() if k != "images_strong"},
            ccfg, wd)))
        agree.append(_ranks_agree(state))
    ddp_peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():  # one threshold on every rank: all images
        thr_t = torch.tensor(pseudo_threshold(
            state, [_on(b, dev) for b in batches[:DIST_ST_STEPS]]))
    dist.all_reduce(thr_t, op=dist.ReduceOp.MIN)
    thr = float(thr_t)
    thresholds = torch.full((model.num_classes,), thr, device=dev)
    st = []
    for b in mine[:DIST_ST_STEPS]:
        st.append(step_timed(lambda: train_step_self_training(
            state, b, ccfg, wd, thresholds, TRAIN_CANVAS)))
        agree.append(_ranks_agree(state))
    out["ddp"] = dict(
        warmup_s=warm[0],
        burnin_s=[s for s, _, _ in burn],
        burnin_s_per_step=float(np.mean([s for s, _, _ in burn])),
        self_training_s=[s for s, _, _ in st],
        self_training_s_per_step=float(np.mean([s for s, _, _ in st])),
        burnin_launches=[n for _, _, n in burn],
        self_training_launches=[n for _, _, n in st],
        num_pseudo=[float(m["num_pseudo"]) for _, m, _ in st],
        loss=[float(m["loss"]) for _, m, _ in burn + st],
        peak_memory_gb=ddp_peak, ranks_bitwise_equal=agree,
        model_bytes=local_bytes(model),
        ema_bytes=local_bytes(state.ema_teacher),
        moment_bytes=optimizer_local_bytes(state.optimizer),
        threshold=thr, n_msda=n_msda, remat=remat)
    want_burn = (2 * n_msda * remat, 2 * n_msda)
    want_st = (n_msda + 2 * n_msda * remat, 2 * n_msda)
    assert all(n == want_burn for n in out["ddp"]["burnin_launches"]), out
    assert all(n == want_st for n in out["ddp"]["self_training_launches"])
    assert all(agree), agree
    assert min(out["ddp"]["num_pseudo"]) > 0, out["ddp"]["num_pseudo"]
    del state, model
    gc.collect()
    torch.cuda.empty_cache()

    log(f"  rank {rank}: DDP steps done")
    # ---- b: FSDP, one burn-in step from the same weights, batch, draws
    state, ccfg, wd, cfg = c2f_train_state(DIST_STEPS + 1, seed=0,
                                           **DIST_DEPTH)
    shard_train_state(state, fsdp=True)
    # a's step under FSDP, before any update: its losses and its gradients
    # (reduce-scattered, then gathered) against DDP's
    with held_choices(rank, world, _held_to(held, dev)):
        _, f_losses, _ = loss_and_grads(state, mine[0], ccfg, wd, my_draws)
    fsdp_check = _against({k: v.item() for k, v in f_losses.items()},
                          {n: g.cpu() for n, g in _grads(state).items()},
                          ddp_ref["losses"], ddp_ref["grads"])
    state.optimizer.zero_grad()
    del held, ddp_ref, f_losses
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    f = step_timed(lambda: train_step_burnin(
        state, {k: v for k, v in mine[0].items() if k != "images_strong"},
        ccfg, wd, dn_draws=my_draws))
    fsdp_after = {n: _gathered(p).cpu()
                  for n, p in state.model.named_parameters()}
    lr = {"main": cfg.lr, "backbone": cfg.lr_backbone}
    from datr_torch.train.optim import param_group

    dev_p = {n: ((fsdp_after[n] - v).abs().max().item(),
                 2 * lr.get(param_group(n), 0.0) + 1e-6)
             for n, v in ddp_after.items()}
    worst = max(dev_p.items(), key=lambda kv: kv[1][0] / kv[1][1])
    out["fsdp"] = dict(
        step_s=f[0], launches=f[2],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        model_bytes=local_bytes(state.model),
        ema_bytes=local_bytes(state.ema_teacher),
        moment_bytes=optimizer_local_bytes(state.optimizer),
        loss=float(f[1]["loss"]), ddp_warmup_loss=float(warm[1]["loss"]),
        worst_param=(worst[0], *worst[1]),
        params_within=all(d <= t for d, t in dev_p.values()),
        against_ddp=fsdp_check)
    assert (fsdp_check["max_loss_rel"] <= 1e-5
            and fsdp_check["max_grad_rel"] <= 1e-3), fsdp_check
    assert out["fsdp"]["params_within"], out["fsdp"]["worst_param"]
    assert f[2] == want_burn, f[2]
    del ddp_after, fsdp_after

    log(f"  rank {rank}: FSDP step done")
    # ---- d: the FSDP state's forward and its student gathered, then its
    # sharded save
    b0 = mine[0]
    with torch.no_grad():
        fwd = state.model.eval()(b0["images"][:1], b0["pad_mask"][:1])
    out["forward"] = {k: fwd[k].cpu() for k in ("pred_logits",
                                                "pred_boxes")}
    state.model.train()
    student = {k: _gathered(v).cpu() for k, v in
               state.model.state_dict().items()}
    if rank == 0:
        torch.save(student, os.path.join(tmp, "student.pt"))
    del student
    path = os.path.join(tmp, "sharded")
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    ckpt.save_checkpoint_sharded(path, state, 0, {"ranks": world})
    out["save_s"] = time.perf_counter() - t0
    out["ckpt_gb"] = sum(os.path.getsize(os.path.join(path, f_))
                         for f_ in os.listdir(path)) / 1e9
    out["step"] = state.step
    out["batch"] = {k: v[:1].cpu() for k, v in b0.items()
                    if k in ("images", "pad_mask")}
    return out


def gt_from_own_detections(model, root, per_image=3):
    """Rewrite <root>/masks/val's annotations with the model's own top
    detections and masks (the first `per_image` whose label is one of the
    tree's categories 1-8), one process, batch 1: the seeded model finds
    none of the drawn objects, and its own detections give the evaluations
    APs above 0, so that a merge that loses or misplaces records shows."""
    from datr_torch.data.coco import build_dataset
    from datr_torch.data.loader import make_eval_loader
    from datr_torch.data.transforms import EvalTransform
    from datr_torch.models.segmentation import det_mask_rles
    from datr_torch.train.steps import eval_step
    from datr_torch.utils.rle import area_of_counts

    ann_path = root / "masks" / "val" / "annotations.json"
    ann = json.loads(ann_path.read_text())
    ann["annotations"] = []
    dev = next(model.parameters()).device
    model.eval()
    for b in make_eval_loader(build_dataset("val", "masks", str(root)), 1,
                              CANVAS, EvalTransform(800, 1333), 100):
        with torch.no_grad():
            res = eval_step(model, {k: torch.from_numpy(b[k]).to(dev)
                                    for k in ("images", "pad_mask",
                                              "orig_sizes")},
                            num_select=DIST_EVAL_SELECT, with_masks=True)
        keep = [j for j, lab in enumerate(res["labels"][0].tolist())
                if 1 <= lab <= 8][:per_image]
        oh, ow = (int(v) for v in b["orig_sizes"][0])
        rles = det_mask_rles(res["mask_logits"][0][keep].float().cpu()
                             .numpy(), CANVAS, tuple(b["real_sizes"][0]),
                             (oh, ow))
        for j, c in zip(keep, rles):
            x0, y0, x1, y1 = res["boxes"][0][j].tolist()
            ann["annotations"].append({
                "id": len(ann["annotations"]) + 1,
                "image_id": int(b["image_ids"][0]),
                "bbox": [x0, y0, x1 - x0, y1 - y0], "iscrowd": 0,
                "category_id": int(res["labels"][0][j]),
                "area": float(area_of_counts(c)),
                "segmentation": {"size": [oh, ow], "counts": c.tolist()}})
    ann_path.write_text(json.dumps(ann))
    return len(ann["annotations"])


def dist_eval(rank, world, tmp, root):
    """Phase 13 c on one rank: engine.evaluate(segm=True) of phase 11's
    masks flagship (seeded) over this rank's shard of the val images,
    batch 2, its detections dumped."""
    from datr_torch import engine
    from datr_torch.data.coco import build_dataset
    from datr_torch.data.loader import make_eval_loader
    from datr_torch.data.transforms import EvalTransform
    from datr_torch.ops import msda

    torch.backends.cudnn.allow_tf32 = False  # f32, as the reference's
    torch.backends.cuda.matmul.allow_tf32 = False
    model = flagship_model(masks=True, mask_query_chunk=MASK_CHUNK)
    ds = build_dataset("val", "masks", root)
    loader = make_eval_loader(ds, 2, CANVAS, EvalTransform(800, 1333), 100,
                              process_index=rank, process_count=world)
    dump = os.path.join(tmp, f"dets.rank{rank}.npz")
    msda.msda_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = engine.evaluate(model, loader, range(1, 9), DIST_EVAL_SELECT,
                            segm=True, save_results_path=dump)
    wall = time.perf_counter() - t0
    return dict(stats={k: np.asarray(v) for k, v in stats.items()},
                wall_s=wall, images=len(loader.indices),
                img_s=len(loader.indices) / wall, batches=loader.n_batches,
                launches=msda.msda_fwd.launches, dump=dump)


def _dets_by_image(path) -> dict:
    return {int(r["image_id"]): r for r in np.load(
        path, allow_pickle=True)["results"]}


def dets_match(got, want, box_tol, score_tol) -> dict:
    """One image's detections (the top-k of its scores) against another
    run's, robust to the order of near-tied scores: the sorted scores
    within score_tol, and each detection a match among the other's of its
    label whose score is within score_tol, its box within box_tol; a
    detection within score_tol of the other run's lowest kept score may
    have no match (a near-tie at the top-k's cut). The largest
    differences."""
    gs, ws = np.sort(got["scores"])[::-1], np.sort(want["scores"])[::-1]
    assert gs.shape == ws.shape, (gs.shape, ws.shape)
    score_d = float(np.abs(gs - ws).max()) if len(gs) else 0.0
    box_d, cut = 0.0, (ws.min() if len(ws) else 0.0) + score_tol
    for b, s, lab in zip(got["boxes"], got["scores"], got["labels"]):
        near = (want["labels"] == lab) & (np.abs(want["scores"] - s)
                                          <= score_tol)
        if not near.any():
            assert s <= cut, (s, lab)
            continue
        box_d = max(box_d, float(np.abs(want["boxes"][near]
                                        - b).max(-1).min()))
    assert score_d <= score_tol and box_d <= box_tol, (score_d, box_d)
    return dict(scores=score_d, boxes=box_d)


def run_distributed(msda, card, cli_ref) -> dict:
    """Phase 13: data-parallel training, evaluation, checkpoints, the CLI
    and serving across processes or replicas on the one card. Two ranks on
    one card show the code path, not scaling: they share its time and
    memory."""
    import pathlib
    import tempfile

    from datr_torch import engine
    from datr_torch.data.coco import build_dataset
    from datr_torch.data.loader import make_eval_loader
    from datr_torch.data.transforms import EvalTransform
    from datr_torch.serve import InferenceServer
    from datr_torch.train import checkpoint as ckpt
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp) / "data"
        write_mask_tree(root, n=DIST_EVAL_IMAGES, fog=0.35,
                        n_val=DIST_EVAL_IMAGES)

        # ---- c, one process: the reference evaluation
        log("  --- 13c reference: one process")
        # f32 without TF32 on both sides: cuDNN may pick other algorithms
        # in the ranks (less free memory), and TF32's would differ by 1e-3
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model = flagship_model(masks=True, mask_query_chunk=MASK_CHUNK)
        n_gt = gt_from_own_detections(model, root)
        ds = build_dataset("val", "masks", str(root))
        one_dump = os.path.join(tmp, "dets.one.npz")
        t0 = time.perf_counter()
        one = engine.evaluate(model, make_eval_loader(
            ds, 2, CANVAS, EvalTransform(800, 1333), 100), range(1, 9),
            DIST_EVAL_SELECT, segm=True, save_results_path=one_dump)
        one_s = time.perf_counter() - t0
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # ---- a, b, d on 2 ranks, then c on 2 ranks
        log(f"  --- 13a/b/d: C2F on {DIST_WORLD} ranks (gloo, CUDA "
            f"tensors, one card)")
        t0 = time.perf_counter()
        tr = spawn_ranks("dist_train", tmp)
        out["train_wall_s"] = time.perf_counter() - t0
        for r, res in enumerate(tr):
            log(f"  rank {r}: DDP {res['ddp']}")
            log(f"  rank {r}: FSDP {res['fsdp']}")
            log(f"  rank {r}: step check {res['step_check']}")
        for res in tr:
            c = res["step_check"]
            assert c["max_loss_rel"] <= 1e-3 and c["max_grad_rel"] <= 1e-3, c
        out["ranks"] = [{k: res[k] for k in ("ddp", "fsdp", "step_check",
                                             "save_s", "ckpt_gb")}
                        for res in tr]
        log("  --- 13c: evaluate on the ranks")
        t0 = time.perf_counter()
        ev = spawn_ranks("dist_eval", tmp, root=str(root))
        out["eval_wall_s"] = time.perf_counter() - t0
        for k in ("coco_eval_bbox", "coco_eval_masks"):
            for res in ev[1:]:
                assert np.array_equal(res["stats"][k], ev[0]["stats"][k]), k
            d = np.abs(ev[0]["stats"][k] - np.asarray(one[k])).max()
            assert d <= 1e-3, (k, d)
            assert one[k][1] > 0, (k, one[k])  # AP50: the GT was found
            out.setdefault("eval_stats_diff", {})[k] = float(d)
        want = _dets_by_image(one_dump)
        worst = {"boxes": 0.0, "scores": 0.0}
        for res in ev:
            for iid, r in _dets_by_image(res["dump"]).items():
                m = dets_match(r, want[iid], 1e-4 * max(FRAME_HW), 1e-3)
                worst = {k: max(worst[k], m[k]) for k in worst}
        out["eval"] = dict(
            one_process=dict(wall_s=one_s, img_s=len(ds) / one_s,
                             stats={k: [float(x) for x in one[k]]
                                    for k in ("coco_eval_bbox",
                                              "coco_eval_masks")},
                             gt_boxes=n_gt),
            ranks=[dict(img_s=r["img_s"], wall_s=r["wall_s"],
                        images=r["images"], launches=r["launches"])
                   for r in ev], detections_diff=worst)
        assert sum(r["images"] for r in ev) == len(ds)
        log(f"  13c: {out['eval']}, stats diff {out['eval_stats_diff']}")

        # ---- d: the ranks' sharded save into one process
        log("  --- 13d: the sharded checkpoint into one process")
        state, _, _, _ = c2f_train_state(DIST_STEPS + 1, seed=5,
                                           **DIST_DEPTH)
        t0 = time.perf_counter()
        state, start, meta = ckpt.load_resume(os.path.join(tmp, "sharded"),
                                              state)
        load_s = time.perf_counter() - t0
        # the loaded student's forward against the forward, in this
        # process, of the student the ranks held (gathered before the save)
        saved, _, _, _ = c2f_train_state(DIST_STEPS + 1, seed=6,
                                           **DIST_DEPTH)
        saved.model.load_state_dict(torch.load(
            os.path.join(tmp, "student.pt"), weights_only=True))
        b = _on(tr[0]["batch"], _rank_device())
        with torch.no_grad():
            fwd = state.model.eval()(b["images"], b["pad_mask"])
            want = saved.model.eval()(b["images"], b["pad_mask"])
        keys = ("pred_logits", "pred_boxes")
        same = {k: torch.equal(fwd[k], want[k]) for k in keys}
        # and against the FSDP ranks' own forward (other process, other
        # cuDNN choices): phase 3's tolerances
        ranks_diff = {k: (fwd[k].cpu() - tr[0]["forward"][k]).abs().max()
                      .item() for k in keys}
        out["checkpoint"] = dict(save_s=[r["save_s"] for r in tr],
                                 load_s=load_s, gb=tr[0]["ckpt_gb"],
                                 forward_bitwise=same, step=state.step,
                                 forward_vs_ranks=ranks_diff, meta=meta)
        log(f"  13d: {out['checkpoint']}")
        assert all(same.values()) and state.step == tr[0]["step"], same
        assert ranks_diff["pred_logits"] <= 1e-3, ranks_diff
        assert ranks_diff["pred_boxes"] <= 1e-4, ranks_diff
        del saved, want
        assert meta == {"epoch": 0, "ranks": DIST_WORLD}, meta
        del state, fwd
        gc.collect()
        torch.cuda.empty_cache()

    # ---- e: the CLI under torchrun's environment, NCCL, world 1
    log("  --- 13e: datr_torch.main over NCCL, world 1 (DDP on one card)")
    import socket

    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    with mock.patch.dict(os.environ, env):
        cl = run_cli(msda, card)
    assert not torch.distributed.is_initialized()
    out["cli"] = dict(cl, phase7_step_s=cli_ref["step_s"])
    log(f"  13e: s per step, DDP at world 1 {cl['step_s']} against phase "
        f"7's {cli_ref['step_s']} (each epoch's second step is warm) on "
        f"{card}")

    # ---- f: serving over two replicas on the one card
    log("  --- 13f: InferenceServer(devices=[cuda:0, cuda:0])")
    from datr_torch.models.layers import MSDeformAttn

    imgs = request_images()[:DIST_SERVE_REQUESTS]
    model = flagship_model()
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    answers = {}
    for name, kw in (("one", dict(device="cuda")),
                     ("two", dict(devices=["cuda:0", "cuda:0"]))):
        srv = InferenceServer(model, canvas_hw=CANVAS, batch_size=2,
                              score_threshold=0.0, batch_timeout_s=1.0, **kw)
        try:
            srv.warmup()
            torch.cuda.synchronize()
            msda.msda_fwd.launches = 0
            answers[name] = [f.result(timeout=600)
                             for f in [srv.submit(im) for im in imgs]]
            st_ = srv.stats()
            answers[name + "_launches"] = msda.msda_fwd.launches
            answers[name + "_batches"] = st_["batches"]
        finally:
            srv.close()
    n_rep = 2
    assert answers["two_launches"] == (n_msda * n_rep
                                       * answers["two_batches"]), (
        answers["two_launches"], answers["two_batches"])
    worst = {"boxes": 0.0, "scores": 0.0}
    for g, w in zip(answers["two"], answers["one"]):
        m = dets_match(g, w, DETECT_TOL["boxes"], DETECT_TOL["scores"])
        worst = {k: max(worst[k], m[k]) for k in worst}
    out["serving"] = dict(requests=len(imgs), diff=worst,
                          launches=answers["two_launches"],
                          batches=answers["two_batches"],
                          launches_per_replica_batch=answers["two_launches"]
                          // (n_rep * answers["two_batches"]))
    log(f"  13f: {out['serving']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 14

# timed burn-in steps beyond the held one (14a times its held step, which
# runs the tp burn-in path, and its self-training step)
AXES_STEPS = 0
AXES_SERVE_REQUESTS = 4
# the C2F model's depth in every part held to the reference (full width):
# each tp / sp layer adds gloo round trips of its activations through the
# host, which at 6 + 6 layers took 26 s a tp step
AXES_DEPTH = dict(enc_layers=2, dec_layers=2)


def _burnin(b) -> dict:
    return {k: v for k, v in b.items() if k != "images_strong"}


def _axes_batches():
    """Phase 14's paired C2F batches (2 + 2 images at 1216x2048, strong
    views), on the host; the first is the step every part is held to."""
    return paired_batches(AXES_STEPS + 1, "cpu", seed=3, strong=True)


def _axes_draws(model, device):
    """The CDN draws of that step (2 source images)."""
    from datr_torch.models import cdn as cdn_mod

    groups, _ = cdn_mod.cdn_layout(model.dn_number, model.dn_single_pad)
    draws = cdn_mod.draw_cdn_noise(torch.Generator().manual_seed(7), 2,
                                   groups, model.dn_single_pad,
                                   model.num_classes, "cpu")
    return cdn_mod.CdnDraws(*(d.to(device) for d in draws))


def _pack_held(held) -> dict:
    """A record of held_choices on the host, its ReLU masks as bits."""
    out = {k: [[x.cpu() for x in v] if isinstance(v, list) else v.cpu()
               for v in vs] for k, vs in held.items() if k != "relu"}
    out["relu"] = [(tuple(m.shape), torch.from_numpy(np.packbits(
        m.cpu().numpy().reshape(-1)))) for m in held["relu"]]
    return out


def _unpack_held(saved, device) -> dict:
    held = _held_to({k: v for k, v in saved.items() if k != "relu"}, device)
    held["relu"] = [torch.from_numpy(np.unpackbits(p.numpy())[
        :int(np.prod(shape))].astype(bool).reshape(shape)).to(device)
        for shape, p in saved["relu"]]
    return held


def axes_reference(tmp) -> dict:
    """The one-process C2F burn-in step on the whole batch through the
    kernels, its choices recorded (the top-k, assignments, prototype
    classes and ReLU signs): what every part of phase 14 is held to.
    Saved to tmp/axes_ref.pt."""
    from datr_torch.train.steps import loss_and_grads

    dev = _rank_device()
    state, ccfg, wd, _ = c2f_train_state(AXES_STEPS + 1, seed=0,
                                         **AXES_DEPTH)
    b0 = _on(_burnin(_axes_batches()[0]), dev)
    t0 = time.perf_counter()
    with held_choices() as rec:
        _, losses, _ = loss_and_grads(state, b0, ccfg, wd,
                                      _axes_draws(state.model, dev))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    ref = dict(losses={k: v.item() for k, v in losses.items()},
               grads={n: p.grad.detach().cpu() for n, p in
                      state.model.named_parameters() if p.grad is not None},
               grad_norm=state.optimizer.grad_norm().item(),
               held=_pack_held(rec))
    torch.save(ref, os.path.join(tmp, "axes_ref.pt"))
    return dict(step_s=step_s, grad_norm=ref["grad_norm"],
                loss=sum(ref["losses"][k] * w for k, w in wd.items()
                         if k in ref["losses"]))


def _fresh_state(pristine, cfg):
    """A training state around a copy of the untouched seeded model (the
    seeded init on the host takes seconds; a copy on the card does not)."""
    import copy

    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state

    model = copy.deepcopy(pristine)
    opt = Optimizer(model, lr=cfg.lr, lr_backbone=cfg.lr_backbone,
                    weight_decay=cfg.weight_decay,
                    clip_max_norm=cfg.clip_max_norm,
                    lr_drop_step=cfg.lr_drop * (AXES_STEPS + 1))
    return create_train_state(model, opt, seed=0)


def _tp_whole(model, name, t):
    """The whole of tensor `t` of parameter `name` of a tensor-parallel
    model (gathered over 'model'); `t` itself for a whole one."""
    from datr_torch.parallel.mesh import whole_tensor

    split = getattr(model, "tp_plan", {}).get(name)
    return t if split is None else whole_tensor(t, split)


def _whole_state_bits(state, student=None) -> torch.Tensor:
    """`_bits_of` the whole state, in parameter-name order: the student's
    parameters, its AdamW moments and the EMA tracks' parameters, each
    gathered whole (FSDP's shards over 'data', tensor parallelism's over
    'model'; every rank calls this), then the prototype state. One
    process passes plain tensors through. `student` (a dict) receives the
    student's whole parameters on the host."""
    from datr_torch.train.state import EMA_TRACKS

    def whole(module, name, t):
        return _tp_whole(module, name, _gathered(t, "data"))

    model = state.model
    params = dict(model.named_parameters())
    moments = {n: state.optimizer.opt.state[p] for n, p in params.items()
               if p in state.optimizer.opt.state}

    def tensors():
        for name, p in params.items():
            t = whole(model, name, p)
            if student is not None:
                student[name] = t.cpu()
            yield t
        for name in sorted(moments):
            for k in ("exp_avg", "exp_avg_sq"):
                yield whole(model, name, moments[name][k])
        for track in EMA_TRACKS:
            m = getattr(state, track)
            for name, p in m.named_parameters():
                yield whole(m, name, p)
        yield state.global_proto
        yield state.amount

    return _bits_of(tensors()).cpu()


def _axes_grads(state) -> dict:
    """Every gradient whole on the host: FSDP's shards gathered over
    'data', tensor parallelism's over 'model'."""
    return {n: _tp_whole(state.model, n, _gathered(p.grad, "data")).cpu()
            for n, p in state.model.named_parameters() if p.grad is not None}


def _axes_check(name, losses, grads, ref, flips=None, norm=None) -> dict:
    """A step's losses and whole gradients against the reference (phase
    13's measures), within phase 5's 1e-3."""
    c = _against(losses, grads, ref["losses"],
                 {n: ref["grads"][n] for n in grads})
    assert grads.keys() == ref["grads"].keys(), name
    if flips is not None:
        c.update(relu_calls=flips.get("relu_calls", 0),
                 relu_flips=sum(flips.get("relu_flips", [])),
                 cls_flips=sum(flips["cls_flips"]))
    if norm is not None:
        c.update(grad_norm=norm, grad_norm_rel=abs(norm - ref["grad_norm"])
                 / ref["grad_norm"])
        assert c["grad_norm_rel"] <= 1e-3, (name, c)
    log(f"  {name} against the one-process step: {c}")
    assert c["max_loss_rel"] <= 1e-3 and c["max_grad_rel"] <= 1e-3, (name, c)
    return c


@contextlib.contextmanager
def _match_digests():
    """Two int64 sums of every assignment of the matcher in the block,
    per call (ranks holding the same data must agree on them)."""
    from datr_torch.train import criterion as crit_mod

    out, match = [], crit_mod.match_many

    def rec(*a, **kw):
        res = match(*a, **kw)
        for t in res:
            v = t.reshape(-1).to(torch.int64)
            w = torch.arange(v.numel(), device=v.device) % 65521 + 1
            out.append(torch.stack([v.sum(), (v * w).sum()]))
        return res

    with mock.patch.object(crit_mod, "match_many", rec):
        yield out


def _agree_over(t: torch.Tensor, axis: str) -> bool:
    import torch.distributed as dist

    from datr_torch.parallel import dist as pdist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(pdist.process_count(axis))]
    dist.all_gather(parts, t, group=pdist.axis_group(axis))
    return all(torch.equal(p, parts[0]) for p in parts)


def _step_timed(fn, msda):
    import torch.distributed as dist

    torch.cuda.synchronize()
    dist.barrier()
    msda.msda_fwd.launches = msda.msda_bwd.launches = 0
    t0 = time.perf_counter()
    m = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, m,
            (msda.msda_fwd.launches, msda.msda_bwd.launches))


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def axes_two(rank, world, tmp):
    """Phase 14 a, b, c and e's save on two ranks (gloo, CUDA tensors, the
    one card). a: the C2F burn-in step split by tensor parallelism (tp =
    2) against the reference, choices held, timed; one self-training
    step, the matcher's assignments and, after its update, the whole
    (replicated) parameters compared between the ranks; one encoder and one decoder call of 4
    heads through check_model_locations. e: that state's forward, its
    whole student written by rank 0, its sharded save. b: sequence
    parallelism (sp = 2): the flagship's eval forward at 800x1344 on
    uneven shards against the one-process forward of the same model on
    the same rank, its encoder call of Lq = S / 2 through
    check_model_locations, then the C2F burn-in step against the
    reference. c: the pipelined encoder (2 stages of 1 layer, 2
    microbatches): the C2F burn-in step against the reference."""
    import copy

    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.ops import msda
    from datr_torch.parallel import dist as pdist
    from datr_torch.parallel.mesh import (
        local_bytes,
        make_mesh,
        optimizer_local_bytes,
        shard_train_state,
    )
    from datr_torch.parallel.pipeline import make_pipe_mesh
    from datr_torch.train import checkpoint as ckpt
    from datr_torch.train.steps import (
        loss_and_grads,
        train_step_burnin,
        train_step_self_training,
    )

    dev = _rank_device()
    ref = torch.load(os.path.join(tmp, "axes_ref.pt"), weights_only=False)
    held = _unpack_held(ref.pop("held"), dev)
    batches = _axes_batches()
    b0 = _on(_burnin(batches[0]), dev)
    out = {}

    # ---- a: tensor parallelism
    t_part = time.perf_counter()
    make_mesh(dev.type, tp=world)
    me = pdist.process_index("model")
    state, ccfg, wd, cfg = c2f_train_state(AXES_STEPS + 1, seed=0,
                                           **AXES_DEPTH)
    model = state.model
    pristine = copy.deepcopy(model)  # parts b and c start from it
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    remat = 2 if model.use_remat else 1
    whole_bytes = local_bytes(model)
    shard_train_state(state)
    draws = _axes_draws(model, dev)
    torch.cuda.reset_peak_memory_stats()
    with held_choices(0, 1, held, inner=(me, world, -1)) as flips:
        burn = [_step_timed(lambda: loss_and_grads(state, b0, ccfg, wd,
                                                   draws), msda)]
    losses = burn[0][1][1]
    norm = state.optimizer.grad_norm().item()
    check = _axes_check("14a tp=2", {k: v.item() for k, v in losses.items()},
                        _axes_grads(state), ref, flips, norm)
    state.optimizer.zero_grad()
    _free()
    with torch.no_grad():
        thr = pseudo_threshold(state, [_on(batches[0], dev)])
    with _match_digests() as digests:
        st = _step_timed(lambda: train_step_self_training(
            state, _on(batches[0], dev), ccfg, wd,
            torch.full((model.num_classes,), thr, device=dev),
            TRAIN_CANVAS), msda)
    peak = torch.cuda.max_memory_allocated() / 1e9
    matches_agree = _agree_over(torch.stack(digests), "model")
    # the tensors every tp rank holds whole stay bitwise equal
    whole_agree = _agree_over(_bits_of(
        [p for n, p in model.named_parameters()
         if n not in model.tp_plan]), "model")
    want_burn = (2 * n_msda * remat, 2 * n_msda)
    want_st = (n_msda + 2 * n_msda * remat, 2 * n_msda)
    assert all(n == want_burn for _, _, n in burn), burn
    assert st[2] == want_st, st[2]
    assert matches_agree, "the tp ranks' assignments differ"
    assert whole_agree, "the tp ranks' whole parameters differ"
    assert float(st[1]["num_pseudo"]) > 0 and all(
        np.isfinite(float(t)) for t in (burn[0][1][0], st[1]["loss"]))
    calls = training_msda_calls(msda, state, b0)  # both ranks: TP's reduces
    at_model = None
    if rank == 0:
        at_model = check_model_locations(
            msda, calls, dict(encoder=TRAIN_S, decoder_src=TRAIN_DEC_LQ[0]),
            TRAIN_SHAPES, backward=True)
    del calls
    _free()
    out["tp"] = dict(
        step_check=check, burnin_s=[s for s, _, _ in burn],
        burnin_s_per_step=float(np.mean([s for s, _, _ in burn])),
        self_training_s=st[0], num_pseudo=float(st[1]["num_pseudo"]),
        threshold=thr, peak_memory_gb=peak,
        model_bytes=local_bytes(model), whole_model_bytes=whole_bytes,
        ema_bytes=local_bytes(state.ema_teacher),
        moment_bytes=optimizer_local_bytes(state.optimizer),
        burnin_launches=[n for _, _, n in burn],
        self_training_launches=st[2], want_burnin=want_burn,
        want_self_training=want_st, matches_agree=matches_agree,
        whole_params_agree=whole_agree,
        match_calls=len(digests), model_locations=at_model,
        loss=[float(burn[0][1][0]), float(st[1]["loss"])])
    log(f"  rank {rank}: 14a tp {out['tp']}")

    # ---- e: the split state's forward, whole student, sharded save
    with torch.no_grad():
        fwd = model.eval()(b0["images"][:1], b0["pad_mask"][:1])
    out["forward"] = {k: fwd[k].cpu() for k in ("pred_logits", "pred_boxes",
                                                 "topk_idx")}
    model.train()
    ckpt.save_checkpoint(os.path.join(tmp, "axes_student.pt"), model, 0)
    torch.cuda.synchronize()
    pdist.barrier()
    t0 = time.perf_counter()
    ckpt.save_checkpoint_sharded(os.path.join(tmp, "axes_sharded"), state,
                                 0, {"tp": world})
    out["save_s"] = time.perf_counter() - t0
    out["step"] = state.step
    out["batch"] = {k: v[:1].cpu() for k, v in b0.items()
                    if k in ("images", "pad_mask")}
    del state, model, fwd
    _free()
    out["tp"]["wall_s"] = time.perf_counter() - t_part

    # ---- b: sequence parallelism
    t_part = time.perf_counter()
    make_mesh(dev.type, sp=world)
    me = pdist.process_index("seq")
    flag = flagship_model()
    gen = torch.Generator().manual_seed(4)
    images = torch.randn(B, *CANVAS, 3, generator=gen)
    pad = torch.zeros(B, *CANVAS, dtype=torch.bool)
    pad[1, :, 1100:] = True
    pad[1, 700:] = True
    images[pad] = 0.0
    images, pad = images.to(dev), pad.to(dev)
    with torch.no_grad():
        one = flag(images, pad)
        flag.sp_axis = "seq"
        msda.msda_fwd.launches = 0
        sp_out = flag(images, pad)
        sp_launches = msda.msda_fwd.launches
    calls = capture_msda_calls(msda, lambda: flag(images, pad))
    lq = pdist.shard_sizes(S, world)[me]  # this rank's encoder queries
    sp_diff = {k: (sp_out[k] - one[k]).abs().max().item()
               for k in ("pred_logits", "pred_boxes")}
    for k in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(sp_out[k], one[k], **TOL["f32"])
    sp_model = None
    if rank == 0:
        sp_model = check_model_locations(msda, {lq: calls[lq]},
                                         dict(encoder_sp=lq), SHAPES,
                                         backward=False)
    del flag, one, sp_out, calls
    _free()
    state = _fresh_state(pristine, cfg)
    for m in (state.model, state.ema_teacher):
        m.sp_axis = "seq"
    shard_train_state(state)
    msda.msda_fwd.launches = msda.msda_bwd.launches = 0
    with held_choices(0, 1, held, inner=(me, world, 1)) as flips:
        _, losses, _ = loss_and_grads(state, b0, ccfg, wd,
                                      _axes_draws(state.model, dev))
    sp_step_launches = (msda.msda_fwd.launches, msda.msda_bwd.launches)
    assert sp_step_launches == want_burn, sp_step_launches
    sp_check = _axes_check("14b sp=2",
                           {k: v.item() for k, v in losses.items()},
                           _axes_grads(state), ref, flips,
                           state.optimizer.grad_norm().item())
    del state
    _free()
    out["sp"] = dict(serving_diff=sp_diff, encoder_lq=lq,
                     serving_launches=sp_launches, model_locations=sp_model,
                     step_check=sp_check, step_launches=sp_step_launches,
                     wall_s=time.perf_counter() - t_part)
    log(f"  rank {rank}: 14b sp {out['sp']}")

    # ---- c: the pipelined encoder
    t_part = time.perf_counter()
    mesh = make_pipe_mesh(dev.type, world)
    state = _fresh_state(pristine, cfg)
    del pristine
    shard_train_state(state)
    model = state.model
    n_micro, per_stage = 2, model.enc_layers // world
    ticks = n_micro + world - 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    msda.msda_fwd.launches = msda.msda_bwd.launches = 0
    with held_choices(0, 1, held, relu=False) as flips:
        _, losses, _ = loss_and_grads(state, b0, ccfg, wd,
                                      _axes_draws(model, dev), pp_mesh=mesh,
                                      pp_n_micro=n_micro)
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t0
    pp_launches = (msda.msda_fwd.launches, msda.msda_bwd.launches)
    # per pass: every tick runs the stage's layers (warm-up and overrun
    # ticks too), recomputed under remat; the decoder's 6 as usual
    want_pp = (2 * (ticks * per_stage + model.dec_layers) * remat,
               2 * (ticks * per_stage + model.dec_layers))
    assert pp_launches == want_pp, (pp_launches, want_pp)
    pp_check = _axes_check(f"14c pp {world} stages x {per_stage} layers",
                           {k: v.item() for k, v in losses.items()},
                           _axes_grads(state), ref, flips,
                           state.optimizer.grad_norm().item())
    out["pp"] = dict(step_check=pp_check, step_s=pp_s, launches=pp_launches,
                     want_launches=want_pp, n_micro=n_micro, stages=world,
                     peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                     wall_s=time.perf_counter() - t_part)
    log(f"  rank {rank}: 14c pp {out['pp']}")
    del state, model, held
    _free()
    return out


def axes_four(rank, world, tmp):
    """Phase 14 d on four ranks: data 2 x model 2 with FSDP over 'data'
    (each data shard 1 + 1 images): the burn-in step against the
    reference (its losses the data shards' mean, its gradients gathered
    whole), then one timed step; the state after it saved sharded (and
    its whole student by rank 0), then loaded on the same ranks as dp 1 x
    tp 4, its whole state's bits against the saved state's."""
    import copy

    import torch.distributed as dist

    from datr_torch.models.cdn import CdnDraws
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.ops import msda
    from datr_torch.parallel import dist as pdist
    from datr_torch.parallel.mesh import (
        local_bytes,
        make_mesh,
        optimizer_local_bytes,
        shard_batch,
        shard_train_state,
    )
    from datr_torch.train import checkpoint as ckpt
    from datr_torch.train.steps import loss_and_grads, train_step_burnin

    t_part = time.perf_counter()
    dev = _rank_device()
    ref = torch.load(os.path.join(tmp, "axes_ref.pt"), weights_only=False)
    held = _unpack_held(ref.pop("held"), dev)
    make_mesh(dev.type, tp=2)
    d, n, me = (pdist.process_index(), pdist.process_count(),
                pdist.process_index("model"))
    state, ccfg, wd, cfg = c2f_train_state(AXES_STEPS + 1, seed=0,
                                           **AXES_DEPTH)
    model = state.model
    pristine = copy.deepcopy(model)  # the layout 14d's load fills
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    remat = 2 if model.use_remat else 1
    shard_train_state(state, fsdp=True)
    mine = _on(shard_batch(_burnin(_axes_batches()[0]), d, n), dev)
    draws = CdnDraws(*(t[d:d + 1] for t in _axes_draws(model, dev)))
    with held_choices(d, n, held, inner=(me, 2, -1)) as flips:
        _, losses, _ = loss_and_grads(state, mine, ccfg, wd, draws)
    keys = sorted(losses)
    lv = torch.stack([losses[k].detach().double() for k in keys])
    dist.all_reduce(lv, group=pdist.axis_group("data"))
    check = _axes_check("14d dp 2 x tp 2, FSDP",
                        dict(zip(keys, (lv / n).tolist())),
                        _axes_grads(state), ref, flips,
                        state.optimizer.grad_norm().item())
    state.optimizer.zero_grad()
    del held
    _free()
    torch.cuda.reset_peak_memory_stats()
    f = _step_timed(lambda: train_step_burnin(state, mine, ccfg, wd,
                                              dn_draws=draws), msda)
    want = (2 * n_msda * remat, 2 * n_msda)
    assert f[2] == want, f[2]
    out = dict(step_check=check, step_s=f[0], launches=f[2],
               loss=float(f[1]["loss"]),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               model_bytes=local_bytes(model),
               ema_bytes=local_bytes(state.ema_teacher),
               moment_bytes=optimizer_local_bytes(state.optimizer))
    # the state after the step, saved sharded (every FSDP piece of a
    # rank's MHA in_proj rows crosses a q / k / v boundary at d = 256),
    # then loaded on dp 1 x tp 4: bitwise
    path = os.path.join(tmp, "axes_fsdp")
    dist.barrier()
    t0 = time.perf_counter()
    ckpt.save_checkpoint_sharded(path, state, 0, extra={"mesh": "dp2xtp2"})
    out["save_s"] = time.perf_counter() - t0
    student = {}
    out["saved_bits"] = _whole_state_bits(state, student)
    student.update((name, b.cpu()) for name, b in model.named_buffers())
    if rank == 0:  # the whole student, for the one process's forward
        torch.save(student, path + "_student.pt")
    del state, model, student
    _free()
    make_mesh(dev.type, tp=4)
    tp4 = _fresh_state(pristine, cfg)
    shard_train_state(tp4)
    t0 = time.perf_counter()
    tp4, meta = ckpt.load_checkpoint_sharded(path, tp4)
    out["tp4_load_s"] = time.perf_counter() - t0
    out["tp4_bits"] = _whole_state_bits(tp4)
    out["tp4_meta"], out["tp4_step"] = meta, tp4.step
    assert torch.equal(out["tp4_bits"], out["saved_bits"]), out
    assert meta == {"epoch": 0, "mesh": "dp2xtp2"} and tp4.step == 1, meta
    out["wall_s"] = time.perf_counter() - t_part
    log(f"  rank {rank}: 14d {out}")
    return out


def run_model_axes(msda, card) -> dict:
    """Phase 14: datr_tpu's model axes on the one card: tensor, sequence
    and pipeline parallelism across ranks (gloo, CUDA tensors), data x
    tensor parallelism with FSDP on four ranks, a tensor-parallel sharded
    checkpoint loaded into one process, and serving with tp = 2. Ranks on
    one card show the code path, not scaling."""
    import tempfile

    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.serve import InferenceServer
    from datr_torch.train import checkpoint as ckpt

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        log("  --- 14: the one-process reference step (2 + 2 images)")
        t0 = time.perf_counter()
        out["reference"] = axes_reference(tmp)
        out["reference"]["wall_s"] = time.perf_counter() - t0
        _free()
        log("  --- 14a/e/b/c: tp = 2, its save, sp = 2, pp 2 stages on 2 "
            "ranks (gloo, CUDA tensors, one card)")
        t0 = time.perf_counter()
        two = spawn_ranks("axes_two", tmp, world=2)
        out["two_wall_s"] = time.perf_counter() - t0
        log("  --- 14d: dp 2 x tp 2 with FSDP on 4 ranks")
        t0 = time.perf_counter()
        four = spawn_ranks("axes_four", tmp, world=4)
        out["four_wall_s"] = time.perf_counter() - t0
        out["ranks"] = [{k: r[k] for k in ("tp", "sp", "pp", "save_s")}
                        for r in two]
        out["dp_tp"] = four

        log("  --- 14e: the tensor-parallel sharded save into one process")
        state, _, _, cfg = c2f_train_state(AXES_STEPS + 1, seed=5,
                                           **AXES_DEPTH)
        saved = _fresh_state(state.model, cfg)  # before the load
        t0 = time.perf_counter()
        state, meta = ckpt.load_checkpoint_sharded(
            os.path.join(tmp, "axes_sharded"), state)
        load_s = time.perf_counter() - t0
        saved.model.load_state_dict(torch.load(
            os.path.join(tmp, "axes_student.pt"), weights_only=True))
        b = _on(two[0]["batch"], _rank_device())
        keys = ("pred_logits", "pred_boxes")
        with torch.no_grad():
            fwd = state.model.eval()(b["images"], b["pad_mask"])
            want = saved.model.eval()(b["images"], b["pad_mask"])
        same = {k: torch.equal(fwd[k], want[k]) for k in keys}
        # against the ranks' split forward (row-split sums add in another
        # order), the two-stage top-k held to theirs: a near-tie among the
        # seeded model's encoder scores may pick other queries
        from datr_torch.models import dino as dino_mod

        ranks_topk = two[0]["forward"]["topk_idx"].to(fwd["topk_idx"].device)
        topk_differ = int((fwd["topk_idx"] != ranks_topk).sum())
        with torch.no_grad(), mock.patch.object(
                dino_mod, "_stable_topk_indices", lambda x, k: ranks_topk):
            held = state.model(b["images"], b["pad_mask"])
        ranks_diff = {k: (held[k].cpu() - two[0]["forward"][k]).abs().max()
                      .item() for k in keys}
        # where the loaded state and the whole save differ, if they do
        sd, sd_w = state.model.state_dict(), saved.model.state_dict()
        differ = sorted(((sd[k] - sd_w[k]).abs().max().item(), k)
                        for k in sd if not torch.equal(sd[k], sd_w[k]))
        out["checkpoint"] = dict(save_s=[r["save_s"] for r in two],
                                 load_s=load_s, forward_bitwise=same,
                                 forward_vs_ranks=ranks_diff, meta=meta,
                                 step=state.step, topk_differ=topk_differ,
                                 tensors_differ=len(differ),
                                 worst_differ=differ[-8:])
        log(f"  14e: {out['checkpoint']}")
        assert all(same.values()) and state.step == two[0]["step"], same
        assert ranks_diff["pred_logits"] <= 1e-3, ranks_diff
        assert ranks_diff["pred_boxes"] <= 1e-4, ranks_diff
        assert meta == {"epoch": 0, "tp": 2}, meta

        log("  --- 14d: the dp 2 x tp 2 FSDP save into one process")
        path = os.path.join(tmp, "axes_fsdp")
        t0 = time.perf_counter()
        state, meta = ckpt.load_checkpoint_sharded(path, state)
        load_s = time.perf_counter() - t0
        bits = _whole_state_bits(state)
        saved.model.load_state_dict(torch.load(path + "_student.pt",
                                               weights_only=True))
        with torch.no_grad():
            fwd = state.model.eval()(b["images"], b["pad_mask"])
            want = saved.model.eval()(b["images"], b["pad_mask"])
        same = {k: torch.equal(fwd[k], want[k]) for k in keys}
        out["fsdp_checkpoint"] = dict(
            save_s=[r["save_s"] for r in four],
            tp4_load_s=[r["tp4_load_s"] for r in four], load_s=load_s,
            state_bitwise=all(torch.equal(bits, r["saved_bits"])
                              for r in four),
            tp4_bitwise=all(torch.equal(r["tp4_bits"], r["saved_bits"])
                            for r in four),
            forward_bitwise=same, meta=meta, step=state.step)
        log(f"  14d checkpoint: {out['fsdp_checkpoint']}")
        assert out["fsdp_checkpoint"]["state_bitwise"], out["fsdp_checkpoint"]
        assert all(same.values()) and state.step == 1, same
        assert meta == {"epoch": 0, "mesh": "dp2xtp2"}, meta
        del state, saved, fwd, want, held
        _free()

    log("  --- 14f: InferenceServer(devices=[cuda:0, cuda:0], tp=2)")
    import threading

    from datr_torch.models import dino as dino_mod

    t0 = time.perf_counter()
    imgs = request_images()[:AXES_SERVE_REQUESTS]
    model = flagship_model()
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    # the two-stage top-k of each one-device batch, recorded and held in
    # the tp run (both shards of a replica take the batch's): a near-tie
    # among the seeded model's encoder scores may pick other queries
    topk, seen, flips, lock, calls = (dino_mod._stable_topk_indices, [], [],
                                      threading.Lock(), [0])

    def record(x, k):
        seen.append(topk(x, k))
        return seen[-1]

    def replay(x, k):
        with lock:
            i = calls[0] // 2
            calls[0] += 1
        flips.append(int((topk(x, k) != seen[i]).sum()))
        return seen[i]

    answers = {}
    for name, kw, fn in (("one", dict(device="cuda"), record),
                         ("tp", dict(devices=["cuda:0", "cuda:0"], tp=2),
                          replay)):
        # one batch at a time, so the batches meet the top-k in order
        srv = InferenceServer(model, canvas_hw=CANVAS, batch_size=2,
                              score_threshold=0.0, batch_timeout_s=1.0,
                              dispatcher_threads=1, max_in_flight=1, **kw)
        try:
            with mock.patch.object(dino_mod, "_stable_topk_indices", fn):
                srv.warmup()
                torch.cuda.synchronize()
                msda.msda_fwd.launches = 0
                answers[name] = [f.result(timeout=600)
                                 for f in [srv.submit(im) for im in imgs]]
                answers[name + "_launches"] = msda.msda_fwd.launches
                answers[name + "_batches"] = srv.stats()["batches"]
        finally:
            srv.close()
    assert calls[0] == 2 * len(seen), (calls, len(seen))
    assert answers["tp_launches"] == 2 * n_msda * answers["tp_batches"], (
        answers["tp_launches"], answers["tp_batches"])
    worst = {"boxes": 0.0, "scores": 0.0}
    for g, w in zip(answers["tp"], answers["one"]):
        m = dets_match(g, w, DETECT_TOL["boxes"], DETECT_TOL["scores"])
        worst = {k: max(worst[k], m[k]) for k in worst}
    out["serving"] = dict(requests=len(imgs), diff=worst,
                          topk_flips=flips,
                          launches=answers["tp_launches"],
                          batches=answers["tp_batches"],
                          wall_s=time.perf_counter() - t0)
    log(f"  14f: {out['serving']}")
    del model
    _free()
    return out


# ---------------------------------------------------------------- phase 15

# f64 kernels against their plain versions: the sums differ only in order
F64_TOL = dict(rtol=1e-9, atol=1e-12)
# NVIDIA H100 SXM data sheet: FP64 outside the tensor cores (the f64
# kernels' FMAs)
F64_FLOPS_PER_S = 34e12
# phase 3's forward tolerances (f32) scaled by f64's epsilon over f32's
F64_FORWARD_TOL = {k: v * 2.0 ** -52 / 2.0 ** -23 for k, v in
                   {"memory": 1e-4, "pred_logits": 1e-3,
                    "pred_boxes": 1e-4}.items()}


def tool_json(args, timeout=900) -> list:
    """Run `python -m <args>` from the repository's root; its JSON lines
    (a tool's result lines). Raises with its output when it fails."""
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(args)} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]


def msda_f64_bounds(msda, loc, d=D, shapes=SHAPES) -> dict:
    """The forward's and the backward's bounds (ms, bound_by) at f64
    widths: as `msda_bound` / `msda_bwd_bound` count them, every element 8
    bytes (value, loc, attn, out, grad_out, grad_value, grad_loc,
    grad_attn), the operations at the f64 rate."""
    lq, heads, n_l, n_p = loc.shape[1:5]
    s_tok = sum(h * w for h, w in shapes)
    rows = value_rows_touched(msda, loc, shapes)
    n = B * lq * heads * n_l * n_p

    def bound(n_bytes, flops):
        t_b, t_o = n_bytes / HBM_BYTES_PER_S, flops / F64_FLOPS_PER_S
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    fwd = bound((rows * d + n * 3 + B * lq * heads * d) * 8, n * 4 * d * 2)
    bwd = bound(((rows + B * s_tok * heads + B * lq * heads) * d
                 + n * 3 * 2) * 8, n * 4 * d * 4)
    return dict(fwd_bound_ms=fwd[0], fwd_bound_by=fwd[1],
                bwd_bound_ms=bwd[0], bwd_bound_by=bwd[1])


def check_f64_kernels(msda, name, value, shapes, loc, attn, g,
                      time_it=True) -> dict:
    """msda_fwd / msda_bwd in f64 against their plain versions on the same
    inputs, F64_TOL (grad_loc's atol times the largest level side, as the
    f32 check's); with `time_it` each timed beside its plain version and
    its bound."""
    got = msda.msda_fwd(value, shapes, loc, attn)
    got_b = msda.msda_bwd(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and all(
        t.dtype == torch.float64 for t in got_b)
    want = msda.ms_deform_attn_plain(value, shapes, loc, attn)
    want_b = msda.ms_deform_attn_plain_bwd(value, shapes, loc, attn, g)
    side = max(max(hw) for hw in shapes)
    errs = {"fwd": (got - want).abs().max().item()}
    torch.testing.assert_close(got, want, **F64_TOL,
                               msg=lambda m: f"msda_fwd f64 {name}: {m}")
    for part, a, b in zip(("value", "loc", "attn"), got_b, want_b):
        errs[f"grad_{part}"] = (a - b).abs().max().item()
        torch.testing.assert_close(
            a, b, rtol=F64_TOL["rtol"],
            atol=F64_TOL["atol"] * (side if part == "loc" else 1),
            msg=lambda m: f"msda_bwd f64 {name} grad_{part}: {m}")
    out = dict(lq=loc.shape[1], max_abs_err=errs)
    if time_it:
        enc = loc.shape[1] == value.shape[1]
        iters, p_iters = (10, 2) if enc else (50, 5)
        out.update(
            fwd_ms=cuda_ms(lambda: msda.msda_fwd(value, shapes, loc, attn),
                           iters),
            fwd_plain_ms=cuda_ms(lambda: msda.ms_deform_attn_plain(
                value, shapes, loc, attn), p_iters, warmup=1),
            bwd_ms=cuda_ms(lambda: msda.msda_bwd(value, shapes, loc, attn,
                                                 g), iters),
            bwd_plain_ms=cuda_ms(lambda: msda.ms_deform_attn_plain_bwd(
                value, shapes, loc, attn, g), p_iters, warmup=1),
            **msda_f64_bounds(msda, loc, value.shape[-1], shapes))
    log(f"  f64 {name}: max_abs_err {errs}" + (
        f"; fwd {out['fwd_ms']:.4f} ms (plain {out['fwd_plain_ms']:.3f}, "
        f"bound {out['fwd_bound_ms']:.4f} {out['fwd_bound_by']}), bwd "
        f"{out['bwd_ms']:.4f} ms (plain {out['bwd_plain_ms']:.3f}, bound "
        f"{out['bwd_bound_ms']:.4f} {out['bwd_bound_by']})"
        if time_it else ""))
    return out


def f64_forward_against_plain(model, x, pad, msda, dino_mod) -> dict:
    """The f64 forward through the kernels against the plain f64 forward,
    the two-stage selection held, at F64_FORWARD_TOL; the kernel
    forward's outputs and its ms by CUDA events."""
    memories = []
    hook = getattr(model, f"enc_layer{model.enc_layers - 1}") \
        .register_forward_hook(lambda m, i, o: memories.append(o))
    try:
        with torch.inference_mode():
            msda.msda_fwd.launches = 0
            out_k = model(x, pad)
            launches = msda.msda_fwd.launches
            idx = out_k["topk_idx"]
            with mock.patch.object(msda, "ms_deform_attn",
                                   msda.ms_deform_attn_plain), \
                    mock.patch.object(dino_mod, "_stable_topk_indices",
                                      lambda s, k: idx):
                out_p = model(x, pad)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    diffs = {"memory": (memories[0] - memories[1]).abs().max().item(),
             **{k: (out_k[k] - out_p[k]).abs().max().item()
                for k in ("pred_logits", "pred_boxes")}}
    assert all(out_k[k].dtype == torch.float64
               for k in ("pred_logits", "pred_boxes"))
    log(f"  f64 forward, kernels vs plain (tolerance {F64_FORWARD_TOL}): "
        f"{diffs}")
    for k, t in F64_FORWARD_TOL.items():
        assert diffs[k] <= t, f"f64 forward through the kernels: {k}"
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(x, pad), 3, warmup=1)
    return dict(diffs=diffs, launches=launches, ms=ms, out=out_k)


def run_float64(msda, card) -> dict:
    """Phase 15f: amp_dtype="float64" on the card (datr_tpu's x64 mode)."""
    from datr_torch.models import dino as dino_mod
    from datr_torch.serve import wire_decode
    from datr_torch.train.steps import train_step_burnin

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(15)
    out = {"random": {}, "model_locations": {}}
    # ---- the f64 kernels at uniform-random locations, serving shapes ----
    for part, lq in (("encoder", S), ("decoder", N_QUERIES)):
        value, loc, attn = msda_inputs(gen, lq, torch.float64)
        loc, attn = loc.double(), attn.double()
        g = torch.randn(B, lq, H * D, device="cuda", generator=gen,
                        dtype=torch.float64)
        out["random"][part] = check_f64_kernels(
            msda, f"{part} Lq={lq} random", value, SHAPES, loc, attn, g)
    value, loc, attn = msda_inputs(gen, N_QUERIES, torch.float64,
                                   case="outside")
    g = torch.randn(B, N_QUERIES, H * D, device="cuda", generator=gen,
                    dtype=torch.float64)
    out["outside_errs"] = check_f64_kernels(
        msda, "decoder outside", value, SHAPES, loc.double(), attn.double(),
        g, time_it=False)["max_abs_err"]

    # ---- the flagship in f64: its locations, its serving forward ----
    model = flagship_model(amp_dtype="float64")
    imgs = request_images()
    canv = torch.from_numpy(np.stack([imgs[0][:800, :1344]])).cuda()
    x, pad = wire_decode(canv, torch.tensor([[800, 1344]], device="cuda"),
                         CANVAS, "u8")
    batch2 = torch.cat([x, x.flip(2)]), torch.cat([pad, pad])
    calls = capture_msda_calls(msda, lambda: model(*batch2))
    for part, lq in (("encoder", S), ("decoder", N_QUERIES)):
        value, sh, loc, attn = calls[lq]
        assert loc.dtype == attn.dtype == value.dtype == torch.float64
        g = torch.randn(B, lq, H * D, device="cuda", generator=gen,
                        dtype=torch.float64)
        out["model_locations"][part] = check_f64_kernels(
            msda, f"{part} Lq={lq} at the model's locations", value, sh, loc,
            attn, g)
    del calls
    fwd = f64_forward_against_plain(model, x, pad, msda, dino_mod)
    out.update(forward_diffs=fwd["diffs"], forward_ms=fwd["ms"],
               serving_launches=fwd["launches"])
    assert fwd["launches"] == MSDA_PER_FORWARD, fwd["launches"]
    # ---- finding: the f32 kernel forward's distance from the f64 one ----
    f32 = flagship_model()
    with torch.inference_mode():
        o32 = f32(x, pad)
    out["f32_vs_f64"] = {
        "topk_idx_mismatch": int((o32["topk_idx"] != fwd["out"]["topk_idx"])
                                 .sum().item()),
        **{k: (o32[k].double() - fwd["out"][k]).abs().max().item()
           for k in ("pred_logits", "pred_boxes")}}
    log(f"  f64 serving forward, batch 1: {fwd['ms']:.2f} ms on {card}; "
        f"the f32 forward's distance from it (a finding): "
        f"{out['f32_vs_f64']}")
    del f32, o32, model, fwd
    gc.collect()
    torch.cuda.empty_cache()

    # ---- one f64 burn-in step (msda_bwd's f64 instantiation on its
    # path): the C2F model, train_bench's batch at the serving canvas ----
    from datr_torch.tools.train_bench import bench_batch

    state, ccfg, wd, _ = c2f_train_state(1, amp_dtype="float64")
    batch = bench_batch(2, CANVAS, torch.device("cuda"), False)
    msda.msda_fwd.launches = msda.msda_bwd.launches = 0
    metrics, step_ms = cuda_timed(lambda: train_step_burnin(
        state, batch, ccfg, wd))
    out["training_launches"] = {"msda_fwd": msda.msda_fwd.launches,
                                "msda_bwd": msda.msda_bwd.launches}
    loss = metrics["loss"].item()
    assert np.isfinite(loss) and metrics["loss"].dtype == torch.float64, loss
    assert out["training_launches"]["msda_bwd"] > 0
    out.update(training_step_ms=step_ms, training_loss=loss)
    log(f"  f64 C2F burn-in step at {CANVAS}, 1 + 1 images: "
        f"{step_ms:.1f} ms, loss {loss:.6f}, launches "
        f"{out['training_launches']}")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def host_us(fn, reps=200) -> float:
    """Host microseconds per call of fn (no synchronization inside: what
    the host spends issuing it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def registered_op_cost(msda) -> dict:
    """Host us per MSDA call through the registered op (ms_deform_attn,
    the model's route) beside the wrapper called directly (msda_fwd), f32
    and bf16, at the decoder's serving shape; times 12 per forward."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        value, loc, attn = msda_inputs(gen, N_QUERIES, dtype)
        op = host_us(lambda: msda.ms_deform_attn(value, SHAPES, loc, attn))
        direct = host_us(lambda: msda.msda_fwd(value, SHAPES, loc, attn))
        out[dt] = dict(op_us=op, direct_us=direct, extra_us=op - direct,
                       per_forward_us=MSDA_PER_FORWARD * (op - direct))
    log(f"  host us per MSDA call, registered op vs direct wrapper: {out}")
    return out


def run_tools(msda, card) -> dict:
    """Phase 15a-e: datr_torch/tools/ on the card."""
    import tempfile

    from datr_torch.models import dino as dino_mod
    from datr_torch.serve import InferenceServer, wire_decode
    from datr_torch.tools import convert_checkpoint as conv
    from datr_torch.tools import export_model, repro_c2f, train_bench

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    imgs = request_images()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- a: a reference-layout .pth into the flagship ----
        t0 = time.perf_counter()
        sd = {k: torch.from_numpy(v) for k, v in conv.build_reference_state_dict(
            "configs/DINO/DINO_4scale.py", ["num_classes=9"]).items()}
        pth = os.path.join(tmp, "reference.pth")
        torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                    "args": __import__("argparse").Namespace(lr=1e-4)}, pth)
        model = flagship_model()
        init = {k: v.clone() for k, v in model.state_dict().items()}
        kept = conv.load_reference_checkpoint(model, pth)
        got = model.state_dict()
        want = conv.convert_checkpoint(conv.read_reference_state_dict(pth))
        eval_keys = {k for k in got if k.split(".")[0] not in conv.DA_HEADS}
        assert set(want) == eval_keys, sorted(set(want) ^ eval_keys)
        assert all(k.split(".")[0] in conv.DA_HEADS for k in kept)
        assert all(torch.equal(got[k].cpu(), want[k]) for k in eval_keys)
        at_init = [k for k in eval_keys if torch.equal(got[k], init[k])
                   and init[k].numel() > 1]
        assert not at_init, at_init
        convert_s = time.perf_counter() - t0
        srv = InferenceServer(model, canvas_hw=CANVAS, batch_size=2,
                              score_threshold=0.0, batch_timeout_s=1.0)
        try:
            srv.warmup()
            served = serve_requests(srv, msda, imgs[:2])
            batch, sizes = serving_batch(srv, imgs)
            diffs = check_forward_against_plain(srv.model, batch, sizes,
                                                msda, dino_mod)
        finally:
            srv.close()
        out["convert"] = dict(seconds=convert_s, tensors=len(want),
                              kept_at_init=len(kept),
                              launches=served["launches"],
                              forward_diffs=diffs)
        log(f"  15a: {len(want)} tensors converted and loaded in "
            f"{convert_s:.2f} s ({len(kept)} DA-head tensors kept at init); "
            f"served {served['requests']} requests, {served['launches']} "
            f"msda_fwd launches")

        # ---- b: export at 1 x 800x1344, f32; save, load, run ----
        canv = torch.from_numpy(batch[:1]).cuda()
        x, pad = wire_decode(canv, torch.from_numpy(sizes[:1]).cuda(),
                             CANVAS, "u8")
        t0 = time.perf_counter()
        ep = export_model.build_exported(model, 1, CANVAS)
        export_s = time.perf_counter() - t0
        art = os.path.join(tmp, "flagship.pt2")
        torch.export.save(ep, art)
        t0 = time.perf_counter()
        exported = export_model.load_exported(art)
        load_s = time.perf_counter() - t0
        with torch.inference_mode():
            eager = export_model.EvalForward(model)(x, pad)
            msda.msda_fwd.launches = 0
            got_e = exported(x, pad)
            torch.cuda.synchronize()
            ex_launches = msda.msda_fwd.launches
            eager_ms = cuda_ms(lambda: model(x, pad), 5, warmup=1)
            ex_ms = cuda_ms(lambda: exported(x, pad), 5, warmup=1)
        assert ex_launches == MSDA_PER_FORWARD, ex_launches
        ex_diffs = {k: (a - b).abs().max().item() for k, a, b in zip(
            ("pred_logits", "pred_boxes"), got_e, eager)}
        bitwise = all(torch.equal(a, b) for a, b in zip(got_e, eager))
        assert ex_diffs["pred_logits"] <= 1e-3, ex_diffs
        assert ex_diffs["pred_boxes"] <= 1e-4, ex_diffs
        out["export"] = dict(
            export_s=export_s, load_s=load_s, bytes=os.path.getsize(art),
            msda_nodes=export_model.msda_nodes(ep), launches=ex_launches,
            diffs=ex_diffs, bitwise=bitwise, exported_ms=ex_ms,
            eager_ms=eager_ms,
            copy_ops_top=export_model.rank_copies(ep, top=5))
        log(f"  15b: exported in {export_s:.1f} s ({out['export']['bytes']} "
            f"bytes, loaded in {load_s:.1f} s), {ex_launches} msda_fwd "
            f"launches per forward; exported {ex_ms:.2f} ms vs eager "
            f"{eager_ms:.2f} ms, batch 1, f32, on {card}; diffs {ex_diffs}, "
            f"bitwise {bitwise}")
        out["registered_op"] = registered_op_cost(msda)
        del model, ep, exported, srv
        gc.collect()
        torch.cuda.empty_cache()

        # ---- c: train_bench, f32 burn-in: warm-up + 3 steps ----
        tb = train_bench.main(["--steps", "3"])
        assert tb["metric"] == "burnin_s_per_step" and tb["value"] > 0
        # the warm-up and 3 steps, each 2 passes (remat: the forward twice)
        assert (tb["msda_fwd_launches"], tb["msda_bwd_launches"]) == (
            4 * 2 * 2 * MSDA_PER_FORWARD, 4 * 2 * MSDA_PER_FORWARD), tb
        out["train_bench"] = tb
        log(f"  15c: train_bench {json.dumps(tb)}")
        gc.collect()
        torch.cuda.empty_cache()

        # ---- d: profile_model, bf16 eval forward and burn-in step ----
        out["profile"] = {}
        for name, flags in (("eval_forward", ["--copies"]),
                            ("burnin_step", ["--train"])):
            (pr,) = tool_json(["datr_torch.tools.profile_model",
                               "--trace-dir", os.path.join(tmp, "trace"),
                               *flags])
            assert pr["clock"] == "device" and pr["profile"] == name
            assert pr["covered_share"] >= 0.95, pr["other_top"]
            assert pr["categories_ms"].get("msda_fwd", 0) > 0
            if name == "burnin_step":
                assert pr["categories_ms"].get("msda_bwd", 0) > 0
            out["profile"][name] = pr
            log(f"  15d: profile_model {name} {json.dumps(pr)}")

        # ---- e: repro_c2f --dry_run on the card ----
        msda.msda_fwd.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            verdict = repro_c2f.main(["--dry_run", "--work_dir",
                                      os.path.join(tmp, "repro")])
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
                 if ln.startswith("{")]
        stages = {ln["stage"]: ln for ln in lines if "stage" in ln}
        assert all(stages.get(s, {}).get("ok") for s in
                   ("stage", "convert", "eval")), lines
        assert verdict["dry_run"] and lines[-1] == verdict, lines
        out["repro"] = dict(stages=sorted(stages),
                            launches=msda.msda_fwd.launches, **verdict)
        assert out["repro"]["launches"] > 0
        log(f"  15e: repro_c2f --dry_run {json.dumps(out['repro'])}")
    return out


# ---------------------------------------------------------------- phase 16

# the distillation tool's run: 4 teacher steps, 2 + 2 student steps, the
# fog val set's 2 images in 1 batch per evaluation (flagship width, bf16 +
# remat, 320x640, 2 + 2 images a step)
DISTILL_ARGS = ("--steps", "4", "--images", "8", "--val_images", "2")


def distill_launches(recs, n_msda, remat, eval_batches) -> dict:
    """The tool's launches by phase against those derived from the model:
    per burn-in step 2 passes x n_msda forward launches (again in remat's
    recompute) and 2 x n_msda backward; a distillation step adds the
    4-point teacher's forward (n_msda); an evaluation n_msda per batch."""
    per_step = {"teacher": (2 * n_msda * remat, 2 * n_msda),
                "student_burnin": (2 * n_msda * remat, 2 * n_msda),
                "student_distill": (2 * n_msda * remat + n_msda,
                                    2 * n_msda)}
    out = {}
    for r in recs:
        phase = r.get("phase")
        if phase in per_step and "train_s" in r:
            want = tuple(v * r["steps"] for v in per_step[phase])
            got = (r["msda_fwd_launches"], r["msda_bwd_launches"])
            assert got == want, (phase, got, want)
            out[phase] = dict(launches=got, per_step=per_step[phase],
                              steps=r["steps"], step_s=r["step_s"],
                              first_step_s=r["first_step_s"])
        elif phase and phase.endswith("_eval"):
            assert r["msda_fwd_launches"] == n_msda * eval_batches, r
            out[phase] = dict(launches=(r["msda_fwd_launches"], 0),
                              ap50=r["ap50"])
    assert set(out) == {"teacher", "teacher_eval", "student_burnin",
                        "student_distill", "student_eval"}, sorted(out)
    return out


def run_png_kinds() -> dict:
    """A seeded 1024x2048 frame as 8-bit RGB, as 16-bit RGB (its high
    bytes the frame, its low bytes seeded) and as Adam7-interlaced 8-bit
    RGB PNGs, each decoded on the host by data/png.py bitwise to PIL's
    convert("RGB") (and to the frame itself), timed beside PIL (one
    thread, the median of 3); then every colour type at every bit depth,
    plain and Adam7, at 37x53, bitwise to PIL."""
    from PIL import Image

    from datr_torch.data import png
    from datr_torch.tools import serve_bench

    frame = serve_bench.synthetic_frames(1, FRAME_HW, seed=16)[0]
    low = np.random.default_rng(16).integers(0, 256, frame.shape, np.uint16)
    bodies = {"rgb8": png.encode_png(frame),
              "rgb16": png.encode_png((frame.astype(np.uint16) << 8) | low,
                                      depth=16),
              "rgb8_adam7": png.encode_png(frame, interlace=True)}
    out = {}
    for name, body in bodies.items():
        got = png.decode_png_rgb(body)
        with Image.open(io.BytesIO(body)) as im:
            want = np.asarray(im.convert("RGB"))
        assert np.array_equal(got, want) and np.array_equal(got, frame), name
        out[name] = dict(mb=len(body) / 1e6,
                         decode_ms=host_ms(lambda: png.decode_png_rgb(body),
                                           3),
                         pil_ms=host_ms(lambda: np.asarray(Image.open(
                             io.BytesIO(body)).convert("RGB")), 3))
    # every colour type x bit depth x interlace at a small odd size
    rng = np.random.default_rng(17)
    kinds = []
    for ctype, depths in png.DEPTHS.items():
        for depth, interlace in ((d, i) for d in depths for i in (0, 1)):
            px = rng.integers(0, 1 << depth, (37, 53, png.CHANNELS[ctype]))
            px = px.astype(np.uint16 if depth == 16 else np.uint8)
            pal = None
            if ctype == 3:
                px, pal = px[..., 0], rng.integers(0, 256, (3, 3), np.uint8)
            body = png.encode_png(px, pal, depth=depth, interlace=interlace)
            with Image.open(io.BytesIO(body)) as im:
                want = np.asarray(im.convert("RGB"))
            assert np.array_equal(png.decode_png_rgb(body), want), (
                ctype, depth, interlace)
            kinds.append((ctype, depth, interlace))
    out["kinds_bitwise"] = len(kinds)
    log(f"  PNG kinds at {FRAME_HW}, bitwise to PIL: {out}")
    return out


def run_distill_tools(msda, card) -> dict:
    """Phase 16: `python -m datr_torch.tools.distill_retention` at
    flagship width in a process of its own (a 4-point teacher, a 2-point
    student burnt in and distilled, each evaluated): the launches of each
    phase against the count derived from the model, its step times; then,
    in this process, the kernels at the 2-point student's own training
    locations against their plain versions (timed beside their bounds),
    one bf16 step of the student through the kernels against the plain
    step (phase 8's floor and control), one f32 step (phase 5's 1e-3);
    last the PNG kinds on the host."""
    from datr_torch.data.coco import DAPairedDataset
    from datr_torch.data.loader import to_device
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.tools import distill_retention as dr
    from datr_torch.train.steps import loss_and_grads

    out = {}
    t0 = time.perf_counter()
    recs = tool_json(["datr_torch.tools.distill_retention", *DISTILL_ARGS])
    out["tool_wall_s"] = time.perf_counter() - t0
    result = recs[-1]
    assert {"retention", "ap50_teacher", "ap50_student"} <= set(result)
    assert all(0.0 <= result[k] <= 1.0 for k in ("ap50_teacher",
                                                 "ap50_student")), result
    args = dr.get_args_parser().parse_args(list(DISTILL_ARGS))
    dev = torch.device("cuda")
    ns = dr.setup(args, dev)
    student = ns.make_model(2, seed=10)
    n_msda = sum(isinstance(m, MSDeformAttn) for m in student.modules())
    remat = 2 if student.use_remat else 1
    out["phases"] = distill_launches(recs, n_msda, remat,
                                     -(-args.val_images // args.batch))
    out["result"] = result
    log(f"  the tool ({out['tool_wall_s']:.1f} s): {out['phases']}; "
        f"{result}")

    batch = to_device(next(iter(ns.loader(
        DAPairedDataset(ns.clear, ns.fog), 0, 1))), dev, dr.BURNIN_KEYS)
    state = ns.init_state(student, seed=10)
    calls = training_msda_calls(msda, state, batch)
    enc_lq = max(calls)
    pad = 2 * student.dn_single_pad * (student.dn_number
                                       // student.dn_single_pad)
    parts = dict(encoder=enc_lq, decoder_src=student.num_queries + pad,
                 decoder_tgt=student.num_queries)
    out["p2_bf16_model_locations"] = check_model_locations(
        msda, calls, parts, calls[enc_lq][1], backward=True)
    del calls
    def run(d):
        return loss_and_grads(state, batch, ns.ccfg, ns.wd, d)[:2]

    out["bf16_step"] = check_step_against_plain(state, run, msda,
                                                **BF16_STEP_TOL)
    with computed_in_f32(student):  # the same student, f32 throughout
        out["f32_step"] = check_step_against_plain(state, run, msda)
    del state, student
    _free()
    out["png"] = run_png_kinds()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    from datr_torch.ops import _build, msda

    memoize_seeded_inits()
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
    from datr_torch import native

    so = native.BUILD_DIR / "libimage_ops.so"
    fresh = not so.exists()
    t0 = time.perf_counter()
    native.image_ops_library()
    host_build = dict(s=time.perf_counter() - t0, fresh=fresh,
                      flags=list(native.IMAGE_OPS_FLAGS),
                      source="datr_torch/csrc/image_ops.cpp")
    log(f"  host library image_ops {'built' if fresh else 'loaded'} in "
        f"{host_build['s']:.2f} s (g++ {' '.join(native.IMAGE_OPS_FLAGS)})")

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

    # phase 9 runs before the training phases: after their large profiles
    # the profiler's short sessions (the wire decode's launch count) lose
    # device events
    log("phase 9: the serving surface: the flagship over HTTP (PNG / JPEG "
        "bodies, f32 and bf16, u8 and yuv420 wires), serve_bench's traffic "
        "through submit, the overload path")
    sv = run_serving_surface(msda, card)
    log("serving_surface " + json.dumps(dict(sv, card=card)))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("9")

    log("phase 10: the other backbones: DINO_4scale_swin (Swin-L) and "
        "DINO_4scale_convnext (ConvNeXt-XL) served in f32 and bf16 and "
        "trained one step each, and C2F self-training with a Swin-L "
        "distillation teacher")
    bb = run_backbones(msda, card)
    log("backbones " + json.dumps(dict(bb, card=card)))
    phase_done("10")

    log("phase 11: instance masks: the flagship with masks=True served "
        "(f32 and bf16, HTTP), evaluated with segm AP and trained on a COCO "
        "tree with instance masks")
    mk = run_masks(msda, card)
    log("masks " + json.dumps(dict(mk, card=card)))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("11")

    log("phase 12: the model registry with shared two-stage heads (served "
        "and trained), the C++ host image ops against their plain versions, "
        "the loader and submit traffic with and without them, the "
        "benchmark tool")
    rh = run_registry_and_host(msda, card, host_build)
    log("registry_and_host " + json.dumps(dict(rh, card=card)))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("12")

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

    log("phase 13: data parallelism on the one card: DDP and FSDP "
        "training on 2 ranks, sharded evaluation and checkpoints, the CLI "
        "over NCCL at world 1, serving over two replicas")
    dp = run_distributed(msda, card, cl)
    log("distributed " + json.dumps(dict(dp, card=card), default=str))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("13")

    log("phase 14: the model axes on the one card: tensor parallelism "
        "(tp = 2), encoder sequence parallelism (sp = 2), the GPipe "
        "encoder (2 stages), data x tensor parallelism with FSDP on 4 "
        "ranks, a tensor-parallel sharded checkpoint into one process, "
        "serving with tp = 2")
    ax = run_model_axes(msda, card)
    log("model_axes " + json.dumps(dict(ax, card=card), default=str))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("14")

    log("phase 15: the tools on the card (a reference-layout .pth "
        "converted into the flagship, torch.export of its eval forward, "
        "train_bench, profile_model, repro_c2f --dry_run) and the float64 "
        "mode (the f64 kernels against their plain versions, the f64 "
        "flagship served and one f64 burn-in step)")
    tl = run_tools(msda, card)
    log("tools " + json.dumps(dict(tl, card=card), default=str))
    gc.collect()
    torch.cuda.empty_cache()
    f64 = run_float64(msda, card)
    log("float64 " + json.dumps(dict(f64, card=card), default=str))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("15")

    log("phase 16: the distillation tool at flagship width (a 4-point "
        "teacher, a 2-point student burnt in and distilled) in its own "
        "process, the 2-point student's bf16 and f32 steps against the "
        "plain steps, every PNG kind against PIL")
    ds = run_distill_tools(msda, card)
    log("distill " + json.dumps(dict(ds, card=card), default=str))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("16")

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
    # phase 10: per path, f32 and bf16 serving of both configurations, one
    # plain training step of each, the distillation steps
    bb_fwd = {
        "backbones_serving": sum(bb[f"{n}_serving"][m]["launches"]
                                 for n, _ in BACKBONE_CONFIGS
                                 for m in ("f32", "bf16")),
        "backbones_training": sum(bb[f"{n}_training"]["launches"]["msda_fwd"]
                                  for n, _ in BACKBONE_CONFIGS),
        "distillation": bb["distillation"]["launches"]["msda_fwd"]}
    bb_bwd = {
        "backbones_training": sum(bb[f"{n}_training"]["launches"]["msda_bwd"]
                                  for n, _ in BACKBONE_CONFIGS),
        "distillation": bb["distillation"]["launches"]["msda_bwd"]}
    # phase 11: the masks server (f32 requests, HTTP, bf16), the segm
    # evaluation, the training steps
    mk_fwd = {
        "masks_serving": (mk["serving"]["f32"]["launches"]
                          + mk["serving"]["f32"]["http_launches"]
                          + mk["serving"]["bf16"]["launches"]),
        "masks_eval": mk["eval"]["launches"],
        "masks_training": mk["training"]["launches"]["msda_fwd"]}
    mk_bwd = {"masks_training": mk["training"]["launches"]["msda_bwd"]}
    # phase 12: the shared-head server and training steps, the traffic
    # runs through submit
    sh = rh["shared_heads"]
    rh_fwd = {
        "shared_heads_serving": sh["serving"]["launches"],
        "shared_heads_training": sh["training"]["launches"]["msda_fwd"],
        "host_traffic": sum(t["submit"]["msda_fwd_launches"]
                            for t in rh["traffic"].values())}
    rh_bwd = {"shared_heads_training": sh["training"]["launches"][
        "msda_bwd"]}
    # phase 13: each rank's DDP burn-in and self-training steps and its
    # FSDP step (counted in the rank's process), the CLI at world 1, the
    # two-replica server
    dd = [r["ddp"] for r in dp["ranks"]]
    dp_fwd = {
        "ddp_training_ranks": sum(n[0] for d in dd for n in
                                  d["burnin_launches"]
                                  + d["self_training_launches"]),
        "fsdp_training_ranks": sum(r["fsdp"]["launches"][0]
                                   for r in dp["ranks"]),
        "cli_nccl_world1": dp["cli"]["launches"]["msda_fwd"],
        "serving_two_replicas": dp["serving"]["launches"]}
    dp_bwd = {
        "ddp_training_ranks": sum(n[1] for d in dd for n in
                                  d["burnin_launches"]
                                  + d["self_training_launches"]),
        "fsdp_training_ranks": sum(r["fsdp"]["launches"][1]
                                   for r in dp["ranks"]),
        "cli_nccl_world1": dp["cli"]["launches"]["msda_bwd"]}
    # phase 14: each rank's launches (its process's counts) on the tp, sp
    # and pp paths, the dp x tp ranks', the tp server's
    ar = ax["ranks"]
    ax_fwd = {
        "tp_training_ranks": sum(n[0] for r in ar for n in
                                 r["tp"]["burnin_launches"]
                                 + [r["tp"]["self_training_launches"]]),
        "sp_ranks": sum(r["sp"]["serving_launches"]
                        + r["sp"]["step_launches"][0] for r in ar),
        "pp_ranks": sum(r["pp"]["launches"][0] for r in ar),
        "dp_tp_fsdp_ranks": sum(r["launches"][0] for r in ax["dp_tp"]),
        "serving_tp2": ax["serving"]["launches"]}
    ax_bwd = {
        "tp_training_ranks": sum(n[1] for r in ar for n in
                                 r["tp"]["burnin_launches"]
                                 + [r["tp"]["self_training_launches"]]),
        "sp_ranks": sum(r["sp"]["step_launches"][1] for r in ar),
        "pp_ranks": sum(r["pp"]["launches"][1] for r in ar),
        "dp_tp_fsdp_ranks": sum(r["launches"][1] for r in ax["dp_tp"])}
    # phase 15: the converted flagship's serving, the exported forward,
    # train_bench and the kit's evaluation, profile_model's own processes
    # (each counted in its process from 0); the f64 paths are entries of
    # their own below
    tl_fwd = {"converted_serving": tl["convert"]["launches"],
              "exported_forward": tl["export"]["launches"],
              "train_bench": tl["train_bench"]["msda_fwd_launches"],
              "repro_c2f_eval": tl["repro"]["launches"],
              **{f"profile_{n}_process": v["msda_fwd_launches"]
                 for n, v in tl["profile"].items()}}
    tl_bwd = {"train_bench": tl["train_bench"]["msda_bwd_launches"],
              "profile_burnin_step_process": tl["profile"]["burnin_step"][
                  "msda_bwd_launches"]}
    # phase 16: the distillation tool's process (its own counts from 0):
    # the teacher's and the student's steps, the three evaluations
    ds_launches = [v["launches"] for v in ds["phases"].values()]
    ds_fwd, ds_bwd = (sum(n[i] for n in ds_launches) for i in (0, 1))
    dsm = ds["p2_bf16_model_locations"]
    # per bf16 training step of the 2-point student: 12 encoder launches
    # (2 passes x 6 layers) and 6 per decoder pass; forward again in remat
    ds_step = {"fwd": {k2: 2 * per_train_step(dsm, key, 12, 6) for k2, key
                       in (("ms", "fwd_ms"), ("plain_ms", "fwd_plain_ms"),
                           ("bound_ms", "fwd_bound_ms"))},
               "bwd": {k2: per_train_step(dsm, key, 12, 6) for k2, key in
                       (("ms", "bwd_ms"), ("plain_ms", "bwd_plain_ms"),
                        ("bound_ms", "bwd_bound_ms"))}}
    f64r, f64m = f64["random"], f64["model_locations"]
    # the kernels at the model axes' shapes: a tp rank's encoder and
    # decoder calls (4 heads), an sp rank's encoder call (Lq = S / 2)
    ax_tp = ar[0]["tp"]["model_locations"]
    ax_sp = ar[0]["sp"]["model_locations"]["encoder_sp"]
    k2, k3 = kg["copy"], kg["fma"]
    kernels = [{
        "name": "msda_fwd",
        "route": "cuda",
        "source": "datr_torch/csrc/msda_fwd.cu",
        "replaces": "datr_tpu/ops/msda_pallas.py:45",
        "launches": (s["launches"] + tr["launches"]["msda_fwd"]
                     + st["launches"]["msda_fwd"] + st["eval"]["launches"]
                     + cl["launches"]["msda_fwd"] + sv["launches"]
                     + sum(bb_fwd.values()) + sum(mk_fwd.values())
                     + sum(rh_fwd.values()) + sum(dp_fwd.values())
                     + sum(ax_fwd.values()) + sum(tl_fwd.values())
                     + ds_fwd),
        "launches_by_path": {"serving": s["launches"],
                             "training": tr["launches"]["msda_fwd"],
                             "self_training": st["launches"]["msda_fwd"],
                             "eval": st["eval"]["launches"],
                             "cli": cl["launches"]["msda_fwd"],
                             "serving_surface": sv["launches"], **bb_fwd,
                             **mk_fwd, **rh_fwd, **dp_fwd, **ax_fwd,
                             **tl_fwd, "distill_tool_process": ds_fwd},
        # phase 14: per step on each tp rank (2 + 2 images, 4 heads)
        "launches_per_tp_step_per_rank": ar[0]["tp"]["burnin_launches"][0][0],
        "launches_per_pp_step_per_rank": ar[0]["pp"]["launches"][0],
        "model_axes": {
            "tp_h4_encoder": {k: ax_tp["encoder"][k] for k in (
                "lq", "heads", "fwd_ms", "fwd_plain_ms", "fwd_bound_ms",
                "fwd_bound_by", "max_abs_err")},
            "tp_h4_decoder": {k: ax_tp["decoder_src"][k] for k in (
                "lq", "heads", "fwd_ms", "fwd_plain_ms", "fwd_bound_ms",
                "fwd_bound_by", "max_abs_err")},
            "sp_half_encoder": {k: ax_sp[k] for k in (
                "lq", "heads", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err")}},
        # phase 13: per step on each DDP rank (1 + 1 images), per FSDP step
        "launches_per_ddp_step_per_rank": dd[0]["burnin_launches"][0][0],
        "launches_per_ddp_self_training_step_per_rank": dd[0][
            "self_training_launches"][0][0],
        "launches_per_distillation_step": bb["distillation"][
            "launches_per_step"]["msda_fwd"],
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
        # phase 16: the 2-point student's bf16 training launches at its
        # own locations (320x640, 2 + 2 images), per launch and per step
        "launches_per_distill_step": ds["phases"]["student_distill"][
            "per_step"][0],
        "per_launch_train_p2_bf16_model": dsm,
        "per_train_step_p2_bf16_model": ds_step["fwd"],
    }, {
        "name": "msda_bwd",
        "route": "cuda",
        "source": "datr_torch/csrc/msda_bwd.cu",
        "replaces": "datr_tpu/ops/msda_pallas.py:154",
        "launches": (tr["launches"]["msda_bwd"] + st["launches"]["msda_bwd"]
                     + cl["launches"]["msda_bwd"] + sum(bb_bwd.values())
                     + sum(mk_bwd.values()) + sum(rh_bwd.values())
                     + sum(dp_bwd.values()) + sum(ax_bwd.values())
                     + sum(tl_bwd.values())),
        "launches_by_path": {"training": tr["launches"]["msda_bwd"],
                             "self_training": st["launches"]["msda_bwd"],
                             "cli": cl["launches"]["msda_bwd"], **bb_bwd,
                             **mk_bwd, **rh_bwd, **dp_bwd, **ax_bwd,
                             **tl_bwd},
        "model_axes": {
            "tp_h4_encoder": {k: ax_tp["encoder"][k] for k in (
                "lq", "heads", "bwd_ms", "bwd_plain_ms", "bwd_bound_ms",
                "bwd_bound_by", "max_abs_err")},
            "tp_h4_decoder": {k: ax_tp["decoder_src"][k] for k in (
                "lq", "heads", "bwd_ms", "bwd_plain_ms", "bwd_bound_ms",
                "bwd_bound_by", "max_abs_err")}},
        "launches_per_ddp_step_per_rank": dd[0]["burnin_launches"][0][1],
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
        # the bf16 route (phase 8): bf16 value / grad_out / grad_value
        # through an f32 workspace, f32 grad_loc / grad_attn; the split
        # kernel on the encoder's launches
        "name": "msda_bwd_bf16",
        "route": "cuda",
        "source": "datr_torch/csrc/msda_bwd.cu",
        "replaces": "datr_tpu/ops/msda_pallas.py:154",
        "launches": (bf_launches["training"]["msda_bwd"]
                     + bf_launches["self_training"]["msda_bwd"]
                     + bf_launches["cli"]["msda_bwd"] + ds_bwd),
        "launches_by_path": {
            "training": bf_launches["training"]["msda_bwd"],
            "self_training": bf_launches["self_training"]["msda_bwd"],
            "cli": bf_launches["cli"]["msda_bwd"],
            "distill_tool_process": ds_bwd},
        # phase 16: the 2-point student's launches at its own locations
        "per_launch_train_p2_model": dsm,
        "per_train_step_p2_model": ds_step["bwd"],
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
        # the f64 instantiations (phase 15f, amp_dtype="float64"): f64
        # value, loc, attn and sums; per launch at the serving shapes,
        # uniform-random locations (encoder Lq = S, decoder Lq = 900) and
        # the f64 flagship's own
        "name": "msda_fwd_f64",
        "route": "cuda",
        "source": "datr_torch/csrc/msda_fwd.cu",
        "replaces": "datr_tpu/ops/msda_pallas.py:45",
        "launches": (f64["serving_launches"]
                     + f64["training_launches"]["msda_fwd"]),
        "launches_by_path": {
            "serving_f64": f64["serving_launches"],
            "training_f64": f64["training_launches"]["msda_fwd"]},
        "max_abs_err": max(v["max_abs_err"]["fwd"] for v in
                           [*f64r.values(), *f64m.values()]),
        # per serving forward: 6 encoder + 6 decoder launches, random
        "ms": 6 * f64r["encoder"]["fwd_ms"] + 6 * f64r["decoder"]["fwd_ms"],
        "plain_ms": (6 * f64r["encoder"]["fwd_plain_ms"]
                     + 6 * f64r["decoder"]["fwd_plain_ms"]),
        "bound_ms": (6 * f64r["encoder"]["fwd_bound_ms"]
                     + 6 * f64r["decoder"]["fwd_bound_ms"]),
        "bound_by": f64r["encoder"]["fwd_bound_by"],
        "library_ms": None,  # no single PyTorch call computes MSDA
        "ms_model": (6 * f64m["encoder"]["fwd_ms"]
                     + 6 * f64m["decoder"]["fwd_ms"]),
        "bound_ms_model": (6 * f64m["encoder"]["fwd_bound_ms"]
                           + 6 * f64m["decoder"]["fwd_bound_ms"]),
        "per_launch": f64r, "per_launch_model": f64m,
    }, {
        "name": "msda_bwd_f64",
        "route": "cuda",
        "source": "datr_torch/csrc/msda_bwd.cu",
        "replaces": "datr_tpu/ops/msda_pallas.py:154",
        "launches": f64["training_launches"]["msda_bwd"],
        "launches_by_path": {
            "training_f64": f64["training_launches"]["msda_bwd"]},
        "max_abs_err": max(e for v in [*f64r.values(), *f64m.values()]
                           for n, e in v["max_abs_err"].items()
                           if n in ("grad_value", "grad_attn")),
        "max_abs_err_grad_loc": max(v["max_abs_err"]["grad_loc"] for v in
                                    [*f64r.values(), *f64m.values()]),
        # one encoder + one decoder launch at the serving shapes, random
        "ms": f64r["encoder"]["bwd_ms"] + f64r["decoder"]["bwd_ms"],
        "plain_ms": (f64r["encoder"]["bwd_plain_ms"]
                     + f64r["decoder"]["bwd_plain_ms"]),
        "bound_ms": (f64r["encoder"]["bwd_bound_ms"]
                     + f64r["decoder"]["bwd_bound_ms"]),
        "bound_by": f64r["encoder"]["bwd_bound_by"],
        "library_ms": None,  # no PyTorch call computes MSDA's backward
        "per_launch": f64r, "per_launch_model": f64m,
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
