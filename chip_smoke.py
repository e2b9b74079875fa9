#!/usr/bin/env python3
"""Smoke test of the datr_torch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. environment: card name and power limit, torch/CUDA versions, and a fresh
     build of every CUDA kernel from datr_torch/csrc (build time printed);
  2. every kernel against its plain PyTorch version on the card, at the main
     path's shapes, in f32 and bf16, plus an edge set; kernel, plain-version
     and memory-bound times;
  3. the serving slice at full width: the flagship DINO-R50 4-scale model
     (configs/DINO/DINO_4scale.py, 9 classes, seeded random weights) behind
     InferenceServer at 800x1344, batch 2, answering uint8 requests of
     several sizes; the kernel launch counts of that run; one batch's forward
     through the kernels against the forward through the plain versions;
  4. the result: a {"kernels": [...]} line, the card line, and as the last
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


def msda_inputs(gen, lq, dtype=torch.float32, d=D, case="random"):
    dev = "cuda"
    value = torch.randn(B, S, H, d, device=dev, generator=gen).to(dtype)
    attn = torch.rand(B, lq, H, L, P, device=dev, generator=gen)
    attn = (attn / attn.sum((-1, -2), keepdim=True)).contiguous()
    if case == "random":
        loc = torch.rand(B, lq, H, L, P, 2, device=dev, generator=gen)
    elif case == "outside":
        loc = torch.rand(B, lq, H, L, P, 2, device=dev, generator=gen)
        loc = loc * 1.6 - 0.3
    else:  # "integer": on pixel centres, as DINO's initial offsets put them
        wh = torch.tensor([(w, h) for h, w in SHAPES], dtype=torch.float32,
                          device=dev)
        hi = (wh + 2).to(torch.int64)[:, None, :].expand(L, P, 2)
        ij = (torch.rand(B, lq, H, L, P, 2, device=dev, generator=gen)
              * hi).floor() - 1  # -1 .. W (H): the borders included
        loc = (ij + 0.5) / wh[:, None, :]
    return value, loc.contiguous(), attn


def value_rows_touched(msda, loc) -> int:
    """Distinct (b, h, token) rows of value that carry a nonzero bilinear
    weight for these sampling locations: the rows the function must read."""
    indices, weights = msda._corner_gather_indices(loc, SHAPES)
    bh = (torch.arange(B, device=loc.device)[:, None, None, None, None] * H
          + torch.arange(H, device=loc.device)[None, None, :, None, None]) * S
    touched = torch.zeros(B * H * S, dtype=torch.bool, device=loc.device)
    for idx, w in zip(indices, weights):
        touched[(bh + idx)[w != 0]] = True
    return int(touched.sum().item())


def msda_bound(msda, loc, elt=4, d=D):
    """(bound ms, bound_by, value rows read) for one launch on these inputs:
    the value rows they touch, loc and attn each read once and the output
    written once, over the memory rate, against the f32 operations (a
    multiply-add per gathered element) over the f32 rate."""
    lq = loc.shape[1]
    rows = value_rows_touched(msda, loc)
    n_bytes = (rows * d * elt + B * lq * H * L * P * 2 * 4
               + B * lq * H * L * P * 4 + B * lq * H * d * elt)
    flops = B * lq * H * L * P * 4 * d * 2
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", rows)


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
        prof = profile_step(srv, batch, sizes)

        diffs = check_forward_against_plain(srv.model, batch, sizes, msda,
                                            dino_mod)
    finally:
        srv.close()
    return dict(launches=launches, batches=n_fwd, requests=len(results),
                step_ms=fwd_ms, step_img_s=2e3 / fwd_ms, forward_diffs=diffs,
                profile=prof)


def profile_step(srv, batch, sizes, top=12) -> dict:
    """Device time by kernel over one step, and the device's busy share of
    the step's wall time (one stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv._step(batch, sizes).cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    msda_ms = sum(r[1] for r in rows if "msda_fwd" in r[0])
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
               msda_ms=msda_ms,
               top=[dict(kernel=k[:90], ms=round(ms, 4), count=n)
                    for k, ms, n in rows[:top]])
    if not rows:
        log("  profile: the profiler recorded no device time (not measured)")
    else:
        log(f"  profile of one step: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.2f} ms, msda_fwd {msda_ms:.2f} ms")
        for r in out["top"]:
            log(f"    {r['ms']:9.3f} ms  x{r['count']:<4} {r['kernel']}")
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
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _, build_log = _build.build()
    build_s = time.perf_counter() - t0
    _build.load_library()
    log(f"  built {[s.name for s in _build.sources()]} in {build_s:.2f} s")
    log("\n".join("  " + ln for ln in build_log.splitlines()
                  if "registers" in ln or "spill" in ln))

    log("phase 2: kernels against their plain versions")
    k = check_msda(msda)

    log("phase 3: serving slice at full width")
    s = run_slice(msda, card)
    log("slice " + json.dumps(dict(s, card=card)))

    enc, dec = k["timing"]["encoder"], k["timing"]["decoder"]
    per_fwd = {key: 6 * enc[key] + 6 * dec[key]
               for key in ("ms", "plain_ms", "bound_ms")}
    kernels = [{
        "name": "msda_fwd",
        "route": "cuda",
        "source": "datr_torch/csrc/msda_fwd.cu",
        "replaces": "datr_tpu/ops/msda_pallas.py:45",
        "launches": s["launches"],
        "launches_per_forward": s["launches"] // s["batches"],
        "max_abs_err": max(v for n, v in k["errs"].items() if "f32" in n),
        "max_abs_err_bf16": max(v for n, v in k["errs"].items()
                                if "bf16" in n),
        # per forward: 6 encoder launches (Lq=22,323) + 6 decoder (Lq=900)
        "ms": per_fwd["ms"],
        "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"],
        "bound_by": enc["bound_by"],
        "library_ms": None,  # no single PyTorch call computes MSDA
        "per_launch": {"encoder": enc, "decoder": dec},
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
