"""The kernels of another commit beside the port's own, on one card, in one
process.

    python msda_kernel_bench.py [--source NAME=DIR ...] [--only SUBSTR]
                                [--dtype f32,bf16,f64] [--split]
                                [--out FILE]

Run from the repository root, beside chip_smoke.py, whose inputs, bounds,
models and tolerances it uses. It builds the port's kernel sources
(datr_torch/csrc: msda_fwd.cu, msda_bwd.cu, gather.cu and msda_common.cuh)
as they are ("new") and, for every --source NAME=DIR, the same files of
another commit unpacked into DIR, e.g. parent=build/parent_csrc filled by
`git show <commit>:datr_torch/csrc/<file> > build/parent_csrc/<file>`.
MSDA cases: the encoder and decoder launches of the serving path
(800x1344, Lq 22,323 / 900) and of the training path (1216x2048, Lq 51,680
/ 1,100 / 900), each at uniform-random locations and at the locations the
seeded models produce (captured from one forward of each), and the
training encoder at the model's locations moved, each coordinate of each
sample by a normal draw of 1, 4 or 16 pixels of its level (names
"training encoder moved<n>px": a trained model's offsets spread from
DINO's initial ones), in each --dtype: f32, and bf16 value / grad_out with
f32 locations (names ending in "bf16"; the seeded models computing in
bf16). f64 (names ending in "f64": value, loc, attn and grad_out all f64,
the float64 mode's kernels) has the serving shapes only, forward and
backward, at uniform-random locations, at the f64 flagship's own (the
batch chip_smoke.py's phase 15f captures them from) and at its encoder's
moved by 1, 4 and 16 pixels ("serving encoder moved<n>px f64"): the
float64 mode's training step runs at the serving canvas. Every library is
held against the plain versions on every case (chip_smoke.py's
tolerances; f64 against the plain f64 version at F64_TOL), then the
libraries are timed in turns (a, b, b, a) by CUDA events over
back-to-back calls of the port's own wrappers; the time kept is the mean
of the two turns. The forward is also timed by the profiler's device time
per call (`fwd_device_ms`): a decoder's launch is shorter than the
host's time per call, which the CUDA events then measure. The tree's
forward is held to the kernel its geometry takes (chip_smoke.fwd_route,
by the launcher's counts). The backward of a --source
library in bf16 is called as the port's wrapper called it before its f32
workspace was zeroed in the C call: zeroed by torch.zeros
(`zeroed_bf16_bwd`). --split adds, per backward case and library, the
profiler's device time per call by kernel (zero-fill, scatter, rounding)
and the host's time per call. Gather cases (names start with "gather"): the
gather bench's row_gather (K2) and gather_fma (K3, 16 rows per output) and
gather_fma at K = 1, 3 and 36 over the same table (2,048 outputs), held
against the plain versions as the gather bench holds them and timed in
turns by the profiler's device time (the bench's `device_ms`). --only keeps
the cases whose name holds SUBSTR, and captures a model's locations only
when one of its cases is kept. Prints a table beside each case's bound
(MSDA: device memory and the bytes requested from the caches; gathers:
the roofline and the launch floor), and writes everything as JSON to --out
(default build/msda_kernel_bench.json).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from datr_torch.ops import _build, gather, msda
from datr_torch.tools import msda_gather_bench as gbench

FMA_KS = (16, 1, 3, 36)  # gather_fma's rows per output; 16 is the bench's
MOVED_PX = (1, 4, 16)  # the spreads of the moved training encoder cases


def build_libraries(source_dirs: dict) -> tuple[dict, dict]:
    """{name: directory holding the port's kernel sources} -> ({name:
    library}, {name: ptxas lines}); all compile at once."""
    root = _build.BUILD_DIR.parent / "msda_kernel_bench"

    def one(item):
        name, src_dir = item
        srcs = [Path(src_dir) / s.name for s in _build.sources()]
        path, log = _build.build(srcs, out_dir=root / name)
        return name, _build.open_library(path), log

    with ThreadPoolExecutor(len(source_dirs)) as pool:
        built = list(pool.map(one, source_dirs.items()))
    return ({n: lib for n, lib, _ in built},
            {n: [ln for ln in log.splitlines()
                 if any(w in ln for w in ("registers", "spill", "Compiling"))]
             for n, _, log in built})


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}


def collect_cases(only=None, device="cuda", dtypes=("f32",)) -> list:
    """(name, value, shapes, loc, attn, grad_out or None) for every MSDA case
    whose name holds `only`, in each of `dtypes` ("f32", "bf16": bf16 value
    and grad_out, names ending in " bf16", the models computing in bf16;
    "f64": everything f64, names ending in " f64", serving shapes only);
    the backward is timed at the training shapes only, as on the main
    path, and in f64 at the serving shapes, where the float64 mode's
    training step runs."""
    cases = []
    gen = torch.Generator(device=device).manual_seed(0)

    def kept(name):
        return not only or only in name

    def add(name, shapes, value, loc, attn, backward):
        g = (torch.randn(value.shape[0], loc.shape[1],
                         value.shape[2] * value.shape[3], device=device,
                         generator=gen).to(value.dtype)
             if backward else None)
        cases.append((name, value, tuple(shapes), loc, attn, g))

    def add_captured(name, call, backward):
        value, shapes, loc, attn = call
        add(name, shapes, value, loc, attn, backward)

    def add_moved(names, call):
        """The encoder's captured locations, each coordinate moved by a
        normal draw of px pixels of its level, for each name's px."""
        value, shapes, loc, attn = call
        wh = torch.tensor([(w, h) for h, w in shapes], device=device,
                          dtype=loc.dtype)[:, None, :]  # [L, 1, 2]
        for px, name in zip(MOVED_PX, names):
            if kept(name):
                add(name, shapes, value,
                    (loc + px / wh * torch.randn(
                        loc.shape, device=device, generator=gen,
                        dtype=loc.dtype)).contiguous(), attn, True)

    serving = (("encoder", cs.S), ("decoder", cs.N_QUERIES))
    training = (("encoder", cs.TRAIN_S), ("decoder_src", cs.TRAIN_DEC_LQ[0]),
                ("decoder_tgt", cs.TRAIN_DEC_LQ[1]))
    for dt in dtypes:
        sfx = "" if dt == "f32" else f" {dt}"
        dtype = DTYPES[dt]
        f64 = dt == "f64"
        amp = cs.BF16 if dt == "bf16" else {}
        for part, lq in serving:
            if kept(f"serving {part} random{sfx}"):
                value, loc, attn = cs.msda_inputs(gen, lq, dtype,
                                                  shapes=cs.SHAPES)
                add(f"serving {part} random{sfx}", cs.SHAPES, value,
                    loc.to(msda.compute_dtype(value)),
                    attn.to(msda.compute_dtype(value)), f64)
        if f64:
            moved = [f"serving encoder moved{px}px{sfx}" for px in MOVED_PX]
            if any(map(kept, [f"serving {part} model{sfx}"
                              for part, _ in serving] + moved)):
                model = cs.flagship_model(amp_dtype="float64")
                _, batch2 = cs.f64_serving_batches(device)
                calls = cs.capture_msda_calls(msda, lambda: model(*batch2))
                del model
                for part, lq in serving:
                    if kept(f"serving {part} model{sfx}"):
                        add_captured(f"serving {part} model{sfx}", calls[lq],
                                     True)
                add_moved(moved, calls[cs.S])
            continue
        for part, lq in training:
            if kept(f"training {part} random{sfx}"):
                add(f"training {part} random{sfx}", cs.TRAIN_SHAPES,
                    *cs.msda_inputs(gen, lq, dtype, shapes=cs.TRAIN_SHAPES),
                    True)

        if any(kept(f"serving {part} model{sfx}") for part, _ in serving):
            srv = cs.flagship_server(**amp, **({"use_remat": False}
                                               if amp else {}))
            try:
                batch, sizes = cs.serving_batch(srv, cs.request_images())
                calls = cs.capture_msda_calls(msda,
                                              lambda: srv._step(batch, sizes))
            finally:
                srv.close()
            del srv
            for part, lq in serving:
                if kept(f"serving {part} model{sfx}"):
                    add_captured(f"serving {part} model{sfx}", calls[lq],
                                 False)

        moved = [f"training encoder moved{px}px{sfx}" for px in MOVED_PX]
        if any(map(kept, [f"training {part} model{sfx}"
                          for part, _ in training] + moved)):
            state, _, _, _ = cs.c2f_train_state(1, device=device, **amp)
            calls = cs.training_msda_calls(
                msda, state, cs.paired_batches(1, device, seed=0)[0])
            del state
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            for part, lq in training:
                if kept(f"training {part} model{sfx}"):
                    add_captured(f"training {part} model{sfx}", calls[lq],
                                 True)
            add_moved(moved, calls[cs.TRAIN_S])
    return cases


def gather_cases(only=None) -> list:
    """(name, wrapper, args, want, tolerance or None for exact, bound ms,
    bound_by) for every gather case whose name holds `only`: the gather
    bench's inputs, checked as the bench checks them (gather_fma against
    the plain version's f32 sum, one bf16 rounding)."""
    cases = []

    def add(name, fn, args, want, tol, work):
        if not only or only in name:
            cases.append((name, fn, args, want, tol,
                          *cs.roofline(work["bytes"], work["flops"])))

    table, idx, _ = gbench.bench_inputs("cuda")
    add("gather copy (K2)", gather.row_gather, (table, idx),
        gather.row_gather_plain(table, idx), None,
        gbench.roofline_work(table, idx))
    for k in FMA_KS:
        table, idx, w = gbench.bench_inputs("cuda", k=k)
        add(f"gather fma K={k}" + (" (K3)" if k == gbench.K else ""),
            gather.gather_fma, (table, idx, w, k),
            gather.gather_fma_plain(table.float(), idx, w, k), cs.TOL["bf16"],
            gbench.roofline_work(table, idx, k=k))
    return cases


def run_gather_case(case, libs, floor_ms) -> dict:
    """Each library held against the plain result, then timed in turns (a,
    b, b, a) by the profiler's device time per call."""
    name, fn, args, want, tol, bound_ms, bound_by = case
    res = dict(case=name, bound_ms=bound_ms, bound_by=bound_by,
               floor_ms=floor_ms, libraries={})
    for lname, lib in libs.items():
        with _build.use_library(lib):
            got = fn(*args)
            torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if tol is None:
            assert torch.equal(got, want), f"{name} ({lname}): not exact"
        else:
            torch.testing.assert_close(
                got.float(), want.float(), **tol,
                msg=lambda m: f"{name} ({lname}): {m}")
        res["libraries"][lname] = dict(max_abs_err=err, device_ms=[])
    order = list(libs)
    for turn in (order, order[::-1]):
        for lname in turn:
            with _build.use_library(libs[lname]):
                res["libraries"][lname]["device_ms"].append(
                    gbench.device_ms(lambda: fn(*args)))
    line = [f"{name}: bound {bound_ms * 1e3:.3f} us ({bound_by}), launch "
            f"floor {floor_ms * 1e3:.3f} us"]
    for lname, r in res["libraries"].items():
        ms = sum(r["device_ms"]) / 2
        line.append(f"   {lname:>12}: {ms * 1e3:.3f} us device "
                    f"({bound_ms / ms:.1%} of the bound, "
                    f"{ms / floor_ms:.2f}x the floor); max_abs_err "
                    f"{r['max_abs_err']:.3g}; turns {r['device_ms']}")
    print("\n".join(line), flush=True)
    return res


def zeroed_bf16_bwd(lib, value, shapes, loc, attn, grad_out):
    """The bf16 route of `msda_bwd` as the port's wrapper called it before
    the C call zeroed its own workspace: the f32 sum in a workspace of
    value's shape zeroed by torch.zeros, the scatter kernel and its
    rounding pass from one call of the C entry point `msda_bwd` (dtype
    1)."""
    B, S, H, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    work = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    grad_value = torch.empty_like(value)
    grad_loc = torch.empty_like(loc)
    grad_attn = torch.empty_like(attn)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    rc = lib.msda_bwd(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
        grad_out.data_ptr(), work.data_ptr(), grad_value.data_ptr(),
        grad_loc.data_ptr(), grad_attn.data_ptr(), B, S, Lq, H, D, L, P,
        msda._shapes_arg(shapes), 1, value.device.index, stream)
    _build.check(lib, rc, "msda_bwd (bf16, a workspace) launch")
    return grad_value, grad_loc, grad_attn


def bwd_call(lib, case, own):
    """The backward of `case` through the port's wrapper (`own`: the port's
    library), or for another commit's library in bf16 with a zeroed
    workspace (to be called inside `_build.use_library(lib)`)."""
    name, value, shapes, loc, attn, g = case
    if value.dtype == torch.bfloat16 and not own:
        return lambda: zeroed_bf16_bwd(lib, value, shapes, loc, attn, g)
    return lambda: msda.msda_bwd(value, shapes, loc, attn, g)


def dtype_name(value) -> str:
    return next(k for k, v in DTYPES.items() if v == value.dtype)


def plain_dtype(value) -> torch.dtype:
    """The type the plain versions compute a case in: f64 for f64 value,
    else f32 on the same values."""
    return torch.float64 if value.dtype == torch.float64 else torch.float32


def check_case(case, want, bwd) -> dict:
    """Max abs errors of the loaded library against the plain results
    `want` (computed in `plain_dtype` on the same values); raises outside
    chip_smoke.py's tolerances (check_fwd / check_bwd: a bf16 output within
    one rounding of the f32 sum; check_f64_kernels: F64_TOL)."""
    name, value, shapes, loc, attn, g = case
    bf16 = value.dtype == torch.bfloat16
    f64 = value.dtype == torch.float64
    wd = plain_dtype(value)
    max_side = max(max(hw) for hw in shapes)
    got = msda.msda_fwd(value, shapes, loc, attn)
    torch.cuda.synchronize()
    errs = {"fwd": (got.to(wd) - want["fwd"]).abs().max().item()}
    torch.testing.assert_close(
        got.to(wd), want["fwd"],
        **(cs.F64_TOL if f64 else cs.TOL[cs.dtype_name(value)]),
        msg=lambda m: f"msda_fwd {name}: {m}")
    if g is not None:
        got = bwd()
        torch.cuda.synchronize()
        for part, a, b in zip(("value", "loc", "attn"), got, want["bwd"]):
            errs[f"grad_{part}"] = (a.to(wd) - b).abs().max().item()
            if f64:
                rtol, atol = cs.F64_TOL["rtol"], cs.F64_TOL["atol"]
            else:
                rtol = 1e-4 + (2.0 ** -8 if bf16 and part == "value" else 0.)
                atol = 1e-5
            torch.testing.assert_close(
                a.to(wd), b, rtol=rtol,
                atol=atol * (max_side if part == "loc" else 1),
                msg=lambda m: f"msda_bwd {name} grad_{part}: {m}")
    return errs


def split_call(fn, iters=20) -> dict:
    """The host's time per call of fn (enqueue, no synchronisation) and the
    device time per call by kernel name, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            kernels[e.key[:90]] = dict(ms=us / 1e3 / iters,
                                       per_call=e.count / iters)
    return dict(host_ms=host_ms, kernels=kernels,
                device_ms=sum(k["ms"] for k in kernels.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=DIR", help="directory holding another "
                    "commit's msda_fwd.cu, msda_bwd.cu, gather.cu and "
                    "msda_common.cuh")
    ap.add_argument("--only", help="run the cases whose name contains this")
    ap.add_argument("--dtype", default="f32,bf16",
                    help="comma-separated value types of the MSDA cases "
                    "(f32, bf16, f64)")
    ap.add_argument("--split", action="store_true",
                    help="profile each backward call by kernel and host")
    ap.add_argument("--out", default="build/msda_kernel_bench.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("msda_kernel_bench: needs a CUDA card", file=sys.stderr)
        return 1

    source_dirs = dict(spec.split("=", 1) for spec in args.source)
    source_dirs["new"] = _build.CSRC_DIR

    card = cs.card_line()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    libs, ptxas = build_libraries(source_dirs)
    for name, lines in ptxas.items():
        print(f"-- {name}: {source_dirs[name]}")
        print("\n".join("   " + ln for ln in lines), flush=True)

    results = []
    with _build.use_library(libs["new"]):
        cases = collect_cases(args.only, dtypes=args.dtype.split(","))
    for case in cases:
        name, value, shapes, loc, attn, g = case
        lq = loc.shape[1]
        elt = value.element_size()
        f64 = value.dtype == torch.float64
        wd = plain_dtype(value)
        iters = 10 if lq == value.shape[1] else 50  # encoder / decoder
        want = {"fwd": msda.ms_deform_attn_plain(value.to(wd), shapes, loc,
                                                 attn)}
        fb, _, rows = cs.msda_bound(msda, loc, elt=elt, shapes=shapes)
        if f64:  # 8-byte elements throughout, f64 operations
            bounds = cs.msda_f64_bounds(msda, loc, shapes=shapes)
            fb = bounds["fwd_bound_ms"]
        traffic = cs.cache_traffic(msda, loc, shapes, elt=elt,
                                   sum_elt=8 if f64 else 4)
        res = dict(case=name, lq=lq, dtype=dtype_name(value),
                   fwd_bound_ms=fb, value_rows_read=rows,
                   fwd_cache_bytes=traffic["fwd"], libraries={})
        if g is not None:
            want["bwd"] = msda.ms_deform_attn_plain_bwd(
                value.to(wd), shapes, loc, attn, g.to(wd))
            res["bwd_bound_ms"] = (
                bounds["bwd_bound_ms"] if f64 else
                cs.msda_bwd_bound(msda, loc, shapes=shapes, elt=elt)[0])
            res["bwd_cache_bytes"] = traffic["bwd"]
        bwds = {lname: bwd_call(lib, case, lname == "new")
                for lname, lib in libs.items()}
        for lname, lib in libs.items():
            with _build.use_library(lib):
                res["libraries"][lname] = dict(
                    max_abs_err=check_case(case, want, bwds[lname]),
                    fwd_ms=[], fwd_device_ms=[], bwd_ms=[])
        # the tree's forward went through the kernel its geometry takes, by
        # its launcher's counts
        with _build.use_library(libs["new"]):
            cs.fwd_routed(msda, lambda: msda.msda_fwd(value, shapes, loc,
                                                      attn), value, loc)
        res["fwd_route"] = cs.fwd_route(value, loc)
        del want
        order = list(libs)
        for turn in (order, order[::-1]):
            for lname in turn:
                r = res["libraries"][lname]
                with _build.use_library(libs[lname]):
                    r["fwd_ms"].append(cs.cuda_ms(lambda: msda.msda_fwd(
                        value, shapes, loc, attn), iters))
                    r["fwd_device_ms"].append(gbench.device_ms(
                        lambda: msda.msda_fwd(value, shapes, loc, attn),
                        iters))
                    if g is not None:
                        r["bwd_ms"].append(cs.cuda_ms(bwds[lname], iters))
        if g is not None and args.split:
            for lname in order:
                with _build.use_library(libs[lname]):
                    res["libraries"][lname]["bwd_split"] = split_call(
                        bwds[lname])
        line = [f"{name} Lq={lq}, the tree's forward through "
                f"{res['fwd_route']}: fwd bound {fb:.4f} ms, "
                f"{traffic['fwd'] / 1e9:.3f} GB from the caches"
                + (f"; bwd bound {res['bwd_bound_ms']:.4f} ms, "
                   f"{traffic['bwd'] / 1e9:.3f} GB" if g is not None else "")]
        for lname, r in res["libraries"].items():
            f_ms = sum(r["fwd_ms"]) / 2
            txt = (f"   {lname:>12}: fwd {f_ms:.4f} ms ({f_ms / fb:.1f}x "
                   f"bound, {traffic['fwd'] / f_ms / 1e9:.2f} TB/s; device "
                   f"{sum(r['fwd_device_ms']) / 2:.4f} ms)")
            if r["bwd_ms"]:
                b_ms = sum(r["bwd_ms"]) / 2
                txt += (f"; bwd {b_ms:.4f} ms "
                        f"({b_ms / res['bwd_bound_ms']:.1f}x bound, "
                        f"{traffic['bwd'] / b_ms / 1e9:.2f} TB/s)")
            line.append(txt + f"; turns fwd {r['fwd_ms']} bwd {r['bwd_ms']}"
                        f"; max_abs_err {r['max_abs_err']}")
            if "bwd_split" in r:
                sp = r["bwd_split"]
                line.append(f"      split: host {sp['host_ms']:.4f} ms/call, "
                            f"device {sp['device_ms']:.4f} ms/call: " + "; "
                            .join(f"{k} {v['ms']:.4f} ms x{v['per_call']:g}"
                                  for k, v in sp["kernels"].items()))
        print("\n".join(line), flush=True)
        results.append(res)

    del cases
    torch.cuda.empty_cache()
    with _build.use_library(libs["new"]):
        floor = gbench.launch_floor(torch.device("cuda"))
    print(f"launch floor (new library): row_gather on one row "
          f"{floor['row_gather_ms'] * 1e3:.3f} us, index_select on one row "
          f"{floor['index_select_ms'] * 1e3:.3f} us; kernels per call "
          f"{floor['row_gather_kernels']}, {floor['index_select_kernels']}",
          flush=True)
    for case in gather_cases(args.only):
        results.append(run_gather_case(case, libs, floor["floor_ms"]))

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        launch_floor=floor, libraries={n: dict(source=str(d), ptxas=ptxas[n])
                   for n, d in source_dirs.items()},
        results=results), indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
