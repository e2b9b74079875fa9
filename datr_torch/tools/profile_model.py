"""Profile the flagship's eval forward (and, with `--train`, the DA burn-in
step) with torch.profiler and print where the device time goes (port of
tools/profile_model.py).

    python -m datr_torch.tools.profile_model [--train] \\
        [--trace-dir runs/profile] [--copies] [--device cpu] [--tiny]
    python -m datr_torch.tools.profile_model --summarize-only <trace.json>

The shapes are datr_tpu's tool's: the C2F configuration
(configs/DA/Cityscapes2FoggyCityscapes/DINO_4scale_C2F.py) with seeded
weights, bf16, 800x1344, batch 2 (the burn-in step: 1 source + 1 target
image, tools/train_bench.py's batch). One untimed call warms the card (the
kernel build, cuDNN's choices), then one call is profiled (CPU and CUDA
activity, shapes recorded) inside a `record_function` window, and the
Chrome trace goes to `<trace-dir>/<name>.trace.json`.

`summarize` reads a trace: the device's kernels (and memcpy / memset
activity) are grouped by name into `CATEGORIES` (MSDA's two kernels under
their own names; cuDNN's FFT convolutions apart from the others), with
their share of the device's busy time; busy is the union of the device
intervals in the window, idle the rest of the window; the longest idle
gaps on the device are the host's (launch, synchronization and host work
between kernels). `--copies` ranks the `aten::copy_` calls (every copy,
cast, `contiguous` and layout change of eager PyTorch) by the bytes they
write, with their shapes and types. A trace without device activity (the
CPU) is summarized over its top-level host ops instead, under
"clock": "host": not a device time. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

import torch

# (category, substrings of the lower-cased kernel name), first match wins
CATEGORIES = (
    ("msda_fwd", ("msda_fwd",)),
    ("msda_bwd", ("msda_bwd", "msda_round_bf16")),
    ("memset", ("memset",)),
    ("copy/cast", ("memcpy", "copy", "cast", "nchwtonhwc", "nhwctonchw",
                   "transpose", "catarray", "cat_kernel", "convert")),
    ("conv_fft", ("fft",)),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")),
    ("gemm", ("gemm", "cutlass", "cublas", "xmma", "nvjet", "matmul",
              "gemv", "splitk", "sm90_", "sm80_", "ampere", "hopper")),
    ("sort/top-k", ("sort", "radix", "topk", "bitonic", "segmented")),
    ("index", ("index", "gather", "scatter", "embedding", "take")),
    ("reduce", ("reduce", "norm", "softmax", "scan", "welford", "moments",
                "gammabeta", "sum_", "mean", "argmax", "max_")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise",
                     "fill", "foreach", "triton", "where", "clamp")),
)
DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "double": 8, "c10::Half": 2,
               "long int": 8, "int": 4, "bool": 1, "unsigned char": 1,
               "signed char": 1, "short int": 2}
WINDOW = "datr_profile_window"
BATCH = 2  # images of the forward, or 1 + 1 of the burn-in step
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def _union(spans):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _top_level(events):
    """The events not nested in another of the same list (one thread)."""
    out, end = [], -1.0
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        if e["ts"] >= end:
            out.append(e)
            end = e["ts"] + e["dur"]
    return out


def copy_ranking(events, top: int = 20) -> list:
    """`aten::copy_` calls by (shape, source -> destination type), the
    bytes they write first."""
    groups = defaultdict(lambda: [0, 0])
    for e in events:
        if e.get("name") != "aten::copy_":
            continue
        a = e.get("args", {})
        dims, types = a.get("Input Dims") or [[]], a.get("Input type") or []
        shape = tuple(dims[0]) if dims else ()
        dst = types[0] if types else "?"
        src = types[1] if len(types) > 1 else dst
        n = 1
        for d in shape:
            n *= d
        g = groups[(shape, src, dst)]
        g[0] += 1
        g[1] += n * DTYPE_BYTES.get(dst, 4)
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][1])
    return {"calls": sum(c for c, _ in groups.values()),
            "casts": sum(c for (_, s, d), (c, _) in groups.items() if s != d),
            "bytes": sum(b for _, b in groups.values()),
            "top": [{"shape": list(shape), "from": src, "to": dst,
                     "count": c, "bytes": b}
                    for (shape, src, dst), (c, b) in ranked[:top]]}


def summarize(path: str, copies: bool = False, gaps: int = 5) -> dict:
    """The breakdown of one trace (`path`: a .trace.json, or a directory:
    its newest one)."""
    if os.path.isdir(path):
        files = glob.glob(os.path.join(path, "**", "*.trace.json"),
                          recursive=True)
        if not files:
            raise FileNotFoundError(f"no *.trace.json under {path}")
        path = max(files, key=os.path.getmtime)
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in events if e.get("name") == WINDOW]
    if windows:
        w = max(windows, key=lambda e: e["dur"])
        t0, t1 = w["ts"], w["ts"] + w["dur"]
    else:
        t0 = min(e["ts"] for e in events)
        t1 = max(e["ts"] + e["dur"] for e in events)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and t0 <= e["ts"] <= t1]
    clock = "device"
    if not dev:  # a CPU run: the top-level host ops
        clock = "host"
        dev = _top_level([e for e in events if e.get("cat") == "cpu_op"
                          and t0 <= e["ts"] <= t1])
    tot, cnt, other = defaultdict(float), defaultdict(int), defaultdict(float)
    for e in dev:
        cat = category(e["name"])
        tot[cat] += e["dur"]
        cnt[cat] += 1
        if cat == "other":
            other[e["name"][:100]] += e["dur"]
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy_us = sum(b - a for a, b in busy)
    window_us = max(t1 - t0, 1e-9)
    idle = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:gaps]
    kernel_us = sum(tot.values())
    out = {
        "trace": path, "clock": clock,
        "window_ms": window_us / 1e3, "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / window_us,
        "idle_share": 1.0 - busy_us / window_us,
        "kernels": len(dev),
        "categories_ms": {k: v / 1e3 for k, v in
                          sorted(tot.items(), key=lambda kv: -kv[1])},
        "categories_count": dict(cnt),
        # the named categories' share of the summed kernel time
        "covered_share": (1.0 - tot.get("other", 0.0) / kernel_us
                          if kernel_us else 0.0),
        "longest_gaps_ms": [{"gap_ms": g / 1e3, "at_ms": (s - t0) / 1e3}
                            for g, s in idle],
        "other_top": [{"name": n, "ms": v / 1e3} for n, v in sorted(
            other.items(), key=lambda kv: -kv[1])[:8]],
    }
    if copies:
        out["copies"] = copy_ranking(events)
    return out


def build(args):
    """(name, one call) for the flags: the eval forward, or the burn-in
    step with `args.train`."""
    from .train_bench import build_step, c2f_config

    bench = argparse.Namespace(
        tiny=args.tiny, amp=True, no_remat=False, points=0,
        device=args.device, batch=BATCH, self_training=False)
    if args.train:
        step, _, _ = build_step(bench)
        return "burnin_step", step
    from ..models import build_model

    cfg = c2f_config(bench)
    model, _, _ = build_model(cfg, args.device, seed=0)
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    h, w = (64, 96) if args.tiny else (800, 1344)
    images = torch.zeros((BATCH, h, w, 3), device=dev)
    pad_mask = torch.zeros((BATCH, h, w), dtype=torch.bool, device=dev)

    def forward():
        with torch.inference_mode():
            return model(images, pad_mask)
    return "eval_forward", forward


def profile(name: str, fn, trace_dir: str, device) -> str:
    """One warm call, then one profiled call of `fn`; the trace's path."""
    fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize(device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    return path


def get_args_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="the DA burn-in step instead of the eval forward")
    ap.add_argument("--trace-dir", default="runs/profile")
    ap.add_argument("--summarize-only", default="",
                    help="summarize this trace (or the newest under this "
                         "directory) and stop")
    ap.add_argument("--copies", action="store_true",
                    help="rank the copy / cast ops by bytes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true",
                    help="a narrow model at 64x96 (CPU tests)")
    return ap


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)
    if args.summarize_only:
        result = summarize(args.summarize_only, args.copies)
        print(json.dumps(result))
        return result
    from .. import resolve_device
    from ..ops import msda

    device = resolve_device(args.device)
    name, fn = build(args)
    path = profile(name, fn, args.trace_dir, device)
    result = {"profile": name, "dtype": "bfloat16", "batch": BATCH,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else str(device)),
              **summarize(path, args.copies),
              # the warm call's and the profiled call's
              "msda_fwd_launches": msda.msda_fwd.launches,
              "msda_bwd_launches": msda.msda_bwd.launches}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
