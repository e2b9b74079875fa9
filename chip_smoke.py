#!/usr/bin/env python3
"""Smoke test of the datr_torch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. environment: card name and power limit, torch/CUDA versions, and a fresh
     build of every CUDA kernel from datr_torch/csrc (one nvcc per source,
     all at once; build time printed);
  2. msda_fwd against its plain PyTorch version at the serving shapes, in
     f32 and bf16, plus an edge set; kernel, plain-version and bound times;
  2b. the training slice's kernels against their plain versions:
     msda_fwd/msda_bwd at the C2F training shapes (encoder Lq 51,680,
     decoder 1,100 / 900; random, integer and outside locations, D=8);
     kernel, plain-version and bound times;
  3. the serving slice at full width: the flagship DINO-R50 4-scale model
     (configs/DINO/DINO_4scale.py, 9 classes, seeded random weights) behind
     InferenceServer at 800x1344, batch 2, answering uint8 requests of
     several sizes; the kernel launch counts of that run; one batch's forward
     through the kernels against the forward through the plain versions;
  4. the gather bench entry point (datr_torch.tools.msda_gather_bench),
     which holds row_gather (K2 shapes, K4/K5/K6 patterns; exact) and
     gather_fma (K3 shapes; one bf16 rounding) against their plain versions
     and times each beside its plain version and its PyTorch yardstick;
     its launch counts, and each case's bound;
  5. the training slice at full width: the Cityscapes->Foggy burn-in config
     (configs/DA/Cityscapes2FoggyCityscapes/DINO_4scale_C2F.py, seeded
     random weights) trained by engine.train_one_epoch on synthetic paired
     batches at 1216x2048, 4 images per step: a warm-up step, then 3 timed
     steps (launch counts of those, s/step, peak memory); one step's losses
     and gradients through the kernels against the same step through the
     plain versions (discrete choices held fixed); a profile, last: its
     trace overflows the profiler's buffers, after which the profiler
     records no device time in this process;
  6. the result: a {"kernels": [...]} line, the card line, and as the last
     line {"ok": true, "device": {...}}.
Imports nothing of JAX or datr_tpu. Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
                shapes=SHAPES):
    dev = "cuda"
    s_tok = sum(h * w for h, w in shapes)
    value = torch.randn(B, s_tok, H, d, device=dev, generator=gen).to(dtype)
    attn = torch.rand(B, lq, H, L, P, device=dev, generator=gen)
    attn = (attn / attn.sum((-1, -2), keepdim=True)).contiguous()
    if case == "random":
        loc = torch.rand(B, lq, H, L, P, 2, device=dev, generator=gen)
    elif case == "outside":
        loc = torch.rand(B, lq, H, L, P, 2, device=dev, generator=gen)
        loc = loc * 1.6 - 0.3
    else:  # "integer": on pixel centres, as DINO's initial offsets put them
        wh = torch.tensor([(w, h) for h, w in shapes], dtype=torch.float32,
                          device=dev)
        hi = (wh + 2).to(torch.int64)[:, None, :].expand(L, P, 2)
        ij = (torch.rand(B, lq, H, L, P, 2, device=dev, generator=gen)
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
    lq = loc.shape[1]
    rows = value_rows_touched(msda, loc, shapes)
    n_bytes = (rows * d * elt + B * lq * H * L * P * 2 * 4
               + B * lq * H * L * P * 4 + B * lq * H * d * elt)
    flops = B * lq * H * L * P * 4 * d * 2
    return (*roofline(n_bytes, flops), rows)


def msda_bwd_bound(msda, loc, d=D, shapes=SHAPES):
    """(bound ms, bound_by, value rows) for one backward launch: what the
    function must move, not what the atomic design moves — the value rows
    touched read once, grad_value (f32, every row) written once,
    grad_out/loc/attn read once, grad_loc and grad_attn written once; 4 f32
    operations per gathered element (the dot product's multiply-add and the
    scattered multiply-add)."""
    lq = loc.shape[1]
    s_tok = sum(h * w for h, w in shapes)
    rows = value_rows_touched(msda, loc, shapes)
    n_samples = B * lq * H * L * P
    n_bytes = (rows * d * 4 + B * s_tok * H * d * 4
               + B * lq * H * d * 4 + n_samples * 2 * 4 * 2
               + n_samples * 4 * 2)
    flops = n_samples * 4 * d * 4
    return (*roofline(n_bytes, flops), rows)


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
        got = msda.msda_fwd(value, SHAPES, loc, attn)
        torch.cuda.synchronize()
        # bf16: held against the plain version in f32 on the same bf16 values
        want = msda.ms_deform_attn_plain(value.float(), SHAPES, loc, attn)
        err = (got.float() - want).abs().max().item()
        name = f"Lq={lq} {dt} {case} D={d}"
        errs[name] = err
        log(f"  msda_fwd {name}: max_abs_err {err:.3g}")
        torch.testing.assert_close(got.float(), want, **TOL[dt],
                                   msg=lambda m: f"msda_fwd {name}: {m}")

    timing = {}
    for part, lq in (("encoder", S), ("decoder", N_QUERIES)):
        value, loc, attn = msda_inputs(gen, lq)
        k_ms = cuda_ms(lambda: msda.msda_fwd(value, SHAPES, loc, attn), 50)
        p_ms = cuda_ms(lambda: msda.ms_deform_attn_plain(
            value, SHAPES, loc, attn), 5, warmup=1)
        bound_ms, bound_by, rows = msda_bound(msda, loc)
        timing[part] = dict(lq=lq, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                            bound_by=bound_by, value_rows_read=rows,
                            value_rows=B * H * S)
        log(f"  msda_fwd {part} Lq={lq} f32: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"{rows} of {B * H * S} value rows read)")
    return dict(errs=errs, timing=timing)


# ---------------------------------------------------------------- phase 3


def request_images():
    """Seeded uint8 images of several sizes and aspect ratios, so the pad
    masks on the 800x1344 canvas differ from slot to slot."""
    rng = np.random.default_rng(0)
    sizes = [(1024, 2048), (480, 640), (720, 1280), (900, 600), (375, 1242),
             (800, 800)]
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


def check_forward_against_plain(model, batch, sizes, msda, dino_mod):
    """One full batch through the kernels and through the plain versions,
    f32 with TF32 off, the two-stage selection held fixed."""
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

            with mock.patch.object(msda, "ms_deform_attn",
                                   msda.ms_deform_attn_plain), \
                    mock.patch.object(dino_mod, "_stable_topk_indices",
                                      fixed_topk):
                out_p = model(x, pad)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    diffs = {
        "memory": (memories[0] - memories[1]).abs().max().item(),
        "pred_logits": (out_k["pred_logits"] - out_p["pred_logits"]).abs()
        .max().item(),
        "pred_boxes": (out_k["pred_boxes"] - out_p["pred_boxes"]).abs()
        .max().item(),
    }
    # the kernel run's selection is a top-k of the plain run's scores up to
    # near-ties: sorted scores agree even where tied indices swap
    sel = torch.gather(scores["plain"], 1, kernel_idx).sort(-1).values
    own = torch.gather(scores["plain"], 1, scores["plain_idx"]).sort(-1).values
    diffs["topk_scores"] = (sel - own).abs().max().item()
    diffs["topk_idx_mismatch"] = int(
        (kernel_idx != scores["plain_idx"]).sum().item())
    tol = {"memory": 1e-4, "pred_logits": 1e-3, "pred_boxes": 1e-4,
           "topk_scores": 1e-4}
    log(f"  kernel vs plain forward (tolerance atol {tol}): {diffs}")
    for k, t in tol.items():
        assert diffs[k] <= t, f"forward through the kernels: {k} {diffs[k]}"
    return diffs


def run_slice(msda, card) -> dict:
    from datr_torch.config import load_config
    from datr_torch.models import dino as dino_mod
    from datr_torch.serve import InferenceServer

    cfg = load_config("configs/DINO/DINO_4scale.py")
    cfg["num_classes"] = 9
    model = dino_mod.build_dino_from_config(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  DINO-R50 4-scale, {n_params} parameters, on "
        f"{next(model.parameters()).device}")
    imgs = request_images()
    # threshold 0 keeps all 300 detections of the random-weight model; the
    # long batch timeout fills each batch although submit() resizes on the
    # host first (so the smoke times no latency)
    srv = InferenceServer(model, canvas_hw=(800, 1344), batch_size=2,
                          score_threshold=0.0, batch_timeout_s=1.0)
    try:
        srv.warmup()
        torch.cuda.synchronize()
        # ---- the main path: counts from 0, requests, counts read ----
        msda.msda_fwd.launches = 0
        futs = [srv.submit(im) for im in imgs]
        results = [f.result(timeout=600) for f in futs]
        launches = msda.msda_fwd.launches
        st = srv.stats()
        n_fwd = st["batches"]
        log(f"  served {len(results)} requests in {n_fwd} batches; msda_fwd "
            f"launches {launches}")
        assert st["requests"] == len(imgs)
        assert launches == 12 * n_fwd, (launches, n_fwd)
        for im, r in zip(imgs, results):
            assert r["boxes"].shape == (300, 4), r["boxes"].shape
            assert r["scores"].shape == (300,)
            assert np.isfinite(r["boxes"]).all() and np.isfinite(
                r["scores"]).all(), f"non-finite answer for {im.shape}"
            assert (r["boxes"][:, 2] <= im.shape[1]).all()
            assert (r["boxes"][:, 3] <= im.shape[0]).all()

        # ---- device time of one full batch through the step ----
        canv = [srv._preprocess(im) for im in imgs[:2]]
        batch = np.stack([c for c, _ in canv])
        sizes = np.array([hw for _, hw in canv], np.int32)
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
    return dict(launches=launches, batches=n_fwd, requests=len(results),
                step_ms=fwd_ms, step_img_s=2e3 / fwd_ms, forward_diffs=diffs,
                profile=prof)


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


def profile_step(fn, kernels=("msda_fwd",), top=12) -> dict:
    """Device time by kernel and by ATen op (with input shapes) over one
    call of fn, and the device's busy share of its wall time. Busy time is
    the union of the kernels' intervals; the sum of their times exceeds it
    where kernels overlap. `kernels`: names whose device time is summed as
    the MSDA share."""
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
    return out


# ---------------------------------------------------------------- phase 2b


def check_train_msda(msda) -> dict:
    """msda_fwd and msda_bwd against their plain versions at the training
    shapes, and their times per launch and per step."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    enc, (dec_src, dec_tgt) = TRAIN_S, TRAIN_DEC_LQ
    sh = TRAIN_SHAPES
    max_side = max(max(hw) for hw in sh)
    errs = {}
    cases = [(enc, "random", D), (dec_src, "random", D), (enc, "integer", D),
             (dec_src, "integer", D), (dec_src, "outside", D),
             (dec_src, "random", 8)]
    for lq, case, d in cases:
        value, loc, attn = msda_inputs(gen, lq, d=d, case=case, shapes=sh)
        g = torch.randn(B, lq, H * d, device="cuda", generator=gen)
        name = f"Lq={lq} f32 {case} D={d}"
        got = msda.msda_fwd(value, sh, loc, attn)
        torch.cuda.synchronize()
        want = msda.ms_deform_attn_plain(value, sh, loc, attn)
        errs[f"msda_fwd {name}"] = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **TOL["f32"],
                                   msg=lambda m: f"msda_fwd {name}: {m}")
        got = msda.msda_bwd(value, sh, loc, attn, g)
        torch.cuda.synchronize()
        want = msda.ms_deform_attn_plain_bwd(value, sh, loc, attn, g)
        for part, a, b in zip(("value", "loc", "attn"), got, want):
            errs[f"msda_bwd {name} grad_{part}"] = (a - b).abs().max().item()
            # grad_loc is the bilinear slope times the level's side (up to
            # 256 px here), so its atol scales with it; grad_value sums
            # atomic adds in a run-dependent order
            atol = 1e-5 * (max_side if part == "loc" else 1)
            torch.testing.assert_close(
                a, b, rtol=1e-4, atol=atol,
                msg=lambda m: f"msda_bwd {name} grad_{part}: {m}")
        log(f"  msda_fwd/bwd {name}: max_abs_err fwd "
            f"{errs[f'msda_fwd {name}']:.3g}, grad value/loc/attn "
            + "/".join(f"{errs[f'msda_bwd {name} grad_{p}']:.3g}"
                       for p in ("value", "loc", "attn")))
        del value, loc, attn, g, got, want

    timing = {}
    for part, lq in (("encoder", enc), ("decoder_src", dec_src),
                     ("decoder_tgt", dec_tgt)):
        value, loc, attn = msda_inputs(gen, lq, shapes=sh)
        g = torch.randn(B, lq, H * D, device="cuda", generator=gen)
        iters = 10 if lq == enc else 50
        p_iters = 2 if lq == enc else 5
        f_ms = cuda_ms(lambda: msda.msda_fwd(value, sh, loc, attn), iters)
        b_ms = cuda_ms(lambda: msda.msda_bwd(value, sh, loc, attn, g), iters)
        fp_ms = cuda_ms(lambda: msda.ms_deform_attn_plain(
            value, sh, loc, attn), p_iters, warmup=1)
        bp_ms = cuda_ms(lambda: msda.ms_deform_attn_plain_bwd(
            value, sh, loc, attn, g), p_iters, warmup=1)
        fb, fb_by, rows = msda_bound(msda, loc, shapes=sh)
        bb, bb_by, _ = msda_bwd_bound(msda, loc, shapes=sh)
        timing[part] = dict(lq=lq, fwd_ms=f_ms, fwd_plain_ms=fp_ms,
                            fwd_bound_ms=fb, fwd_bound_by=fb_by, bwd_ms=b_ms,
                            bwd_plain_ms=bp_ms, bwd_bound_ms=bb,
                            bwd_bound_by=bb_by, value_rows_read=rows,
                            value_rows=B * H * TRAIN_S)
        log(f"  train {part} Lq={lq} f32: fwd {f_ms:.4f} ms (plain "
            f"{fp_ms:.3f}, bound {fb:.4f} {fb_by}); bwd {b_ms:.4f} ms "
            f"(plain {bp_ms:.3f}, bound {bb:.4f} {bb_by}); {rows} of "
            f"{B * H * TRAIN_S} value rows")
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


def train_batches(n, device):
    """n paired batches at 1216x2048: 2 source images, 2 fogged target
    images, Cityscapes-sized (1024x2048) frames of 8 classes."""
    from datr_torch.data.synthetic import (
        SyntheticDetectionDataset,
        synthetic_da_batch,
    )

    src = SyntheticDetectionDataset(2 * n, (1024, 2048), 8, max_objects=16,
                                    seed=0)
    tgt = SyntheticDetectionDataset(2 * n, (1024, 2048), 8, max_objects=16,
                                    seed=1, fog=0.35)
    return [synthetic_da_batch(src, tgt, [2 * i, 2 * i + 1], TRAIN_CANVAS,
                               max_boxes=100, device=device)
            for i in range(n)]


def check_step_against_plain(state, batch, ccfg, wd, msda) -> dict:
    """One step's losses and gradients through the kernels against the
    same step through the plain versions, f32 with TF32 off, with the CDN
    noise, the two-stage top-k of both passes, the matcher's assignments and
    the prototypes' class of each query held to the kernel run's (each a
    discrete choice that a near-tie can flip)."""
    from datr_torch.models import cdn as cdn_mod
    from datr_torch.models import dino as dino_mod
    from datr_torch.train import criterion as crit_mod
    from datr_torch.train.steps import loss_and_grads

    model = state.model
    groups, _ = cdn_mod.cdn_layout(model.dn_number, model.dn_single_pad)
    draws = cdn_mod.draw_cdn_noise(torch.Generator().manual_seed(7), 2,
                                   groups, model.dn_single_pad,
                                   model.num_classes, batch["images"].device)
    topk, match = dino_mod._stable_topk_indices, crit_mod.match_many
    protos = dino_mod.class_prototypes
    seen_topk, seen_assign, seen_cls = [], [], []
    cls_flips = []

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

    with mock.patch.object(dino_mod, "_stable_topk_indices", rec_topk), \
            mock.patch.object(crit_mod, "match_many", rec_match), \
            mock.patch.object(dino_mod, "class_prototypes", rec_protos):
        total_k, losses_k, _ = loss_and_grads(state, batch, ccfg, wd, draws)
    grads_k = {n: p.grad.clone() for n, p in model.named_parameters()
               if p.grad is not None}
    replay_topk, replay_assign = iter(seen_topk), iter(seen_assign)
    replay_cls = iter(seen_cls)
    t0 = time.perf_counter()
    with mock.patch.object(msda, "ms_deform_attn",
                           msda.ms_deform_attn_plain), \
            mock.patch.object(dino_mod, "_stable_topk_indices",
                              lambda x, k: next(replay_topk)), \
            mock.patch.object(crit_mod, "match_many",
                              lambda *a, **kw: next(replay_assign)), \
            mock.patch.object(dino_mod, "class_prototypes", replay_protos):
        total_p, losses_p, _ = loss_and_grads(state, batch, ccfg, wd, draws)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    grads_p = {n: p.grad for n, p in model.named_parameters()
               if p.grad is not None}
    state.optimizer.zero_grad()
    assert grads_k.keys() == grads_p.keys()
    g_norm = torch.stack([g.norm() for g in grads_p.values()]).norm().item()
    loss_rel = {k: abs(losses_k[k].item() - losses_p[k].item())
                / max(abs(losses_p[k].item()), 1e-6) for k in losses_p}
    # relative norm per tensor; a tensor whose gradient is zero in exact
    # arithmetic (a conv bias in front of a GroupNorm) is held against
    # 1e-4 of the whole gradient's norm instead
    grad_rel = {n: ((grads_k[n] - grads_p[n]).norm()
                    / max(grads_p[n].norm().item(), 1e-4 * g_norm)).item()
                for n in grads_p}
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:5]
    res = dict(total_kernel=total_k.item(), total_plain=total_p.item(),
               max_loss_rel=max(loss_rel.values()),
               max_grad_rel=max(grad_rel.values()), worst_grads=worst,
               n_grads=len(grad_rel), plain_step_s=plain_s,
               topk_calls=len(seen_topk), match_calls=len(seen_assign),
               prototype_class_flips=cls_flips)
    tol = 1e-3
    log(f"  step through kernels vs plain (tolerance {tol} relative): {res}")
    assert res["max_loss_rel"] <= tol, res
    assert res["max_grad_rel"] <= tol, res
    return res


def run_training(msda, card) -> dict:
    """The burn-in training slice at full width through engine's
    train_one_epoch."""
    from datr_torch.config import load_config
    from datr_torch.engine import train_one_epoch
    from datr_torch.models import dino as dino_mod
    from datr_torch.models.layers import MSDeformAttn
    from datr_torch.train.criterion import criterion_from_config
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state
    from datr_torch.train.steps import train_step_burnin

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(C2F)
    model = dino_mod.build_dino_from_config(cfg, seed=0)
    ccfg, wd = criterion_from_config(cfg, model)
    n_batches = 4  # one warm-up step, then the timed ones
    opt = Optimizer(model, lr=cfg.lr, lr_backbone=cfg.lr_backbone,
                    weight_decay=cfg.weight_decay,
                    clip_max_norm=cfg.clip_max_norm,
                    lr_drop_step=cfg.lr_drop * n_batches)
    state = create_train_state(model, opt, seed=0)
    trainable = {n: p.detach().clone() for n, p in model.named_parameters()
                 if p.requires_grad}
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in trainable.values())
    log(f"  C2F burn-in: {n_params} parameters ({n_train} trainable), "
        f"use_remat {model.use_remat}, canvas {TRAIN_CANVAS}, 4 images per "
        f"step")
    t0 = time.perf_counter()
    batches = train_batches(n_batches, "cuda")
    log(f"  synthetic batches built in {time.perf_counter() - t0:.2f} s")

    # launches per step, from the model: every MSDeformAttn runs once per
    # pass (source and target), once more in the backward's recompute
    # under use_remat, and its backward once per pass
    n_msda = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    want_fwd = 2 * n_msda * (2 if model.use_remat else 1)
    want_bwd = 2 * n_msda

    warm = train_one_epoch(state, batches[:1], ccfg, wd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = batches[1:]
    # ---- the main path: counts from 0, steps, counts read ----
    msda.msda_fwd.launches = msda.msda_bwd.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = train_one_epoch(state, steps, ccfg, wd)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(msda_fwd=msda.msda_fwd.launches,
                    msda_bwd=msda.msda_bwd.launches)
    step_s = start.elapsed_time(end) / 1e3 / len(steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {len(steps)} steps: {step_s:.3f} s/step by CUDA events "
        f"({wall_s / len(steps):.3f} s/step host), "
        f"{4 / step_s:.3f} img/s, peak memory {peak_gb:.2f} GB on {card}")
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

    check = check_step_against_plain(state, batches[0], ccfg, wd, msda)
    prof = profile_step(lambda: train_step_burnin(state, batches[1], ccfg,
                                                  wd)["loss"].item(),
                        kernels=("msda_fwd", "msda_bwd"), top=15)
    return dict(launches=launches, steps=len(steps),
                launches_per_step=dict(msda_fwd=want_fwd, msda_bwd=want_bwd),
                step_s=step_s, img_s=4 / step_s, host_step_s=wall_s / len(
                    steps), peak_memory_gb=peak_gb, loss=metrics["loss"],
                against_plain=check, profile=prof)


def run_gather_bench(gather, bench) -> dict:
    """The gather bench entry point on the card, counts from 0. The bench
    holds each kernel against its plain version on the card (row_gather
    exact, gather_fma within one bf16 rounding) and times the kernel, the
    plain version and the yardstick by the profiler's device time; the
    bound is the bytes it reports over the memory rate (the 5.8 MB table is
    L2-resident, so this HBM bound is loose)."""
    gather.row_gather.launches = gather.gather_fma.launches = 0
    results = bench.run("cuda")
    launches = dict(row_gather=gather.row_gather.launches,
                    gather_fma=gather.gather_fma.launches)
    cases = {}
    for r in results:
        bound_ms, bound_by = roofline(r["bytes"], r["flops"])
        cases[r["case"]] = dict(
            kernel=r["kernel"], rows=r["rows"], ok=r["ok"],
            max_abs_err=r["max_abs_err"], ms=r["device_ms"],
            plain_ms=r["plain_device_ms"], library_ms=r["library_device_ms"],
            event_ms=r["ms"], bound_ms=bound_ms, bound_by=bound_by,
            table_rows_read=r["table_rows_read"])
        lib = (f"{r['library_device_ms']:.5f} ms = "
               f"{r['library_rows_per_s'] / 1e9:.3f} Grows/s"
               if r["library_device_ms"] else "refused bf16")
        log(f"  {r['case']}: {r['kernel']} ok {r['ok']} (max_abs_err "
            f"{r['max_abs_err']:.3g}); device {r['device_ms']:.5f} ms = "
            f"{r['rows_per_s'] / 1e9:.3f} Grows/s ({r['ms']:.5f} ms per "
            f"call by events); plain {r['plain_device_ms']:.5f} ms; "
            f"{r['library']} {lib}; bound {bound_ms:.5f} ms ({bound_by})")
    log(f"  launches {launches}")
    assert all(r["ok"] for r in results), results
    assert launches["row_gather"] > 0 and launches["gather_fma"] > 0
    return dict(cases=cases, launches=launches)


# ---------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    from datr_torch.ops import _build, msda

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _, build_log = _build.build()
    build_s = time.perf_counter() - t0
    _build.load_library()
    log(f"  built {[s.name for s in _build.sources()]} in {build_s:.2f} s")
    log("\n".join("  " + ln for ln in build_log.splitlines()
                  if "registers" in ln or "spill" in ln))

    log("phase 2: msda_fwd against its plain version, serving shapes")
    k = check_msda(msda)

    log("phase 2b: the training kernels against their plain versions")
    kt = check_train_msda(msda)

    log("phase 3: serving slice at full width")
    s = run_slice(msda, card)
    log("slice " + json.dumps(dict(s, card=card)))

    log("phase 4: gather bench entry point, its kernels against their "
        "plain versions")
    from datr_torch.ops import gather
    from datr_torch.tools import msda_gather_bench as bench

    gb = run_gather_bench(gather, bench)
    kg = gb["cases"]

    log("phase 5: training slice at full width (C2F burn-in)")
    tr = run_training(msda, card)
    log("training " + json.dumps(dict(tr, card=card)))

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
    bwd_errs = {n: v for n, v in kt["errs"].items() if "msda_bwd" in n}
    k2, k3 = kg["copy"], kg["fma"]
    kernels = [{
        "name": "msda_fwd",
        "route": "cuda",
        "source": "datr_torch/csrc/msda_fwd.cu",
        "replaces": "datr_tpu/ops/msda_pallas.py:45",
        "launches": s["launches"] + tr["launches"]["msda_fwd"],
        "launches_by_path": {"serving": s["launches"],
                             "training": tr["launches"]["msda_fwd"]},
        "launches_per_forward": s["launches"] // s["batches"],
        "launches_per_train_step": tr["launches_per_step"]["msda_fwd"],
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
        "per_launch": {"encoder": enc, "decoder": dec},
        "per_train_step": dict(fwd_step, bound_by=tt["encoder"][
            "fwd_bound_by"]),
        "per_launch_train": tt,
    }, {
        "name": "msda_bwd",
        "route": "cuda",
        "source": "datr_torch/csrc/msda_bwd.cu",
        "replaces": "datr_tpu/ops/msda_pallas.py:154",
        "launches": tr["launches"]["msda_bwd"],
        "launches_per_train_step": tr["launches_per_step"]["msda_bwd"],
        "max_abs_err": max(v for n, v in bwd_errs.items()
                           if "grad_loc" not in n),
        "max_abs_err_grad_loc": max(v for n, v in bwd_errs.items()
                                    if "grad_loc" in n),
        # per training step: 12 encoder + 6 + 6 decoder launches
        **bwd_step,
        "bound_by": tt["encoder"]["bwd_bound_by"],
        "library_ms": None,  # no PyTorch call computes MSDA's backward
        "per_launch_train": tt,
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
        # K2 copy; K4/K5/K6: the three probes, by name
        "cases": {n: v for n, v in kg.items() if v["kernel"] == "row_gather"},
    }, {
        "name": "gather_fma",
        "route": "cuda",
        "source": "datr_torch/csrc/gather.cu",
        "replaces": "tools/msda_pallas_bench.py:79",
        "launches": gb["launches"]["gather_fma"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],  # F.embedding_bag, per-sample weights
    }]
    log("gather bench " + json.dumps(kg))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
