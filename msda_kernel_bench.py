"""The kernels of another commit beside the port's own, on one card, in one
process.

    python msda_kernel_bench.py [--source NAME=DIR ...] [--only SUBSTR]
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
seeded models produce (captured from one forward of each). Every library is
held against the plain versions on every case (chip_smoke.py's
tolerances), then the libraries are timed in turns (a, b, b, a) by CUDA
events over back-to-back calls of the port's own wrappers; the time kept is
the mean of the two turns. Gather cases (names start with "gather"): the
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from datr_torch.ops import _build, gather, msda
from datr_torch.tools import msda_gather_bench as gbench

FMA_KS = (16, 1, 3, 36)  # gather_fma's rows per output; 16 is the bench's


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


def collect_cases(only=None, device="cuda") -> list:
    """(name, value, shapes, loc, attn, grad_out or None) for every MSDA case
    whose name holds `only`; the backward is timed at the training shapes
    only, as on the main path."""
    cases = []
    gen = torch.Generator(device=device).manual_seed(0)

    def kept(name):
        return not only or only in name

    def add(name, shapes, value, loc, attn, backward):
        g = (torch.randn(value.shape[0], loc.shape[1],
                         value.shape[2] * value.shape[3], device=device,
                         generator=gen) if backward else None)
        cases.append((name, value, tuple(shapes), loc, attn, g))

    def add_captured(name, call, backward):
        value, shapes, loc, attn = call
        add(name, shapes, value, loc, attn, backward)

    serving = (("encoder", cs.S), ("decoder", cs.N_QUERIES))
    training = (("encoder", cs.TRAIN_S), ("decoder_src", cs.TRAIN_DEC_LQ[0]),
                ("decoder_tgt", cs.TRAIN_DEC_LQ[1]))
    for part, lq in serving:
        if kept(f"serving {part} random"):
            add(f"serving {part} random", cs.SHAPES,
                *cs.msda_inputs(gen, lq), False)
    for part, lq in training:
        if kept(f"training {part} random"):
            add(f"training {part} random", cs.TRAIN_SHAPES,
                *cs.msda_inputs(gen, lq, shapes=cs.TRAIN_SHAPES), True)

    if any(kept(f"serving {part} model") for part, _ in serving):
        srv = cs.flagship_server()
        try:
            batch, sizes = cs.serving_batch(srv, cs.request_images())
            calls = cs.capture_msda_calls(msda,
                                          lambda: srv._step(batch, sizes))
        finally:
            srv.close()
        del srv
        for part, lq in serving:
            if kept(f"serving {part} model"):
                add_captured(f"serving {part} model", calls[lq], False)

    if any(kept(f"training {part} model") for part, _ in training):
        state, _, _, _ = cs.c2f_train_state(1, device=device)
        calls = cs.training_msda_calls(
            msda, state, cs.paired_batches(1, device, seed=0)[0])
        del state
        torch.cuda.empty_cache()
        for part, lq in training:
            if kept(f"training {part} model"):
                add_captured(f"training {part} model", calls[lq], True)
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


def check_case(case, want) -> dict:
    """Max abs errors of the loaded library against the plain results
    `want`; raises outside chip_smoke.py's tolerances."""
    name, value, shapes, loc, attn, g = case
    got = msda.msda_fwd(value, shapes, loc, attn)
    torch.cuda.synchronize()
    errs = {"fwd": (got - want["fwd"]).abs().max().item()}
    torch.testing.assert_close(got, want["fwd"], **cs.TOL["f32"],
                               msg=lambda m: f"msda_fwd {name}: {m}")
    if g is not None:
        max_side = max(max(hw) for hw in shapes)
        got = msda.msda_bwd(value, shapes, loc, attn, g)
        torch.cuda.synchronize()
        for part, a, b in zip(("value", "loc", "attn"), got, want["bwd"]):
            errs[f"grad_{part}"] = (a - b).abs().max().item()
            atol = 1e-5 * (max_side if part == "loc" else 1)
            torch.testing.assert_close(
                a, b, rtol=1e-4, atol=atol,
                msg=lambda m: f"msda_bwd {name} grad_{part}: {m}")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=DIR", help="directory holding another "
                    "commit's msda_fwd.cu, msda_bwd.cu, gather.cu and "
                    "msda_common.cuh")
    ap.add_argument("--only", help="run the cases whose name contains this")
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
        cases = collect_cases(args.only)
    for case in cases:
        name, value, shapes, loc, attn, g = case
        lq = loc.shape[1]
        iters = 10 if lq == value.shape[1] else 50  # encoder / decoder
        want = {"fwd": msda.ms_deform_attn_plain(value, shapes, loc, attn)}
        fb, _, rows = cs.msda_bound(msda, loc, shapes=shapes)
        traffic = cs.cache_traffic(msda, loc, shapes)
        res = dict(case=name, lq=lq, fwd_bound_ms=fb, value_rows_read=rows,
                   fwd_cache_bytes=traffic["fwd"], libraries={})
        if g is not None:
            want["bwd"] = msda.ms_deform_attn_plain_bwd(value, shapes, loc,
                                                        attn, g)
            res["bwd_bound_ms"] = cs.msda_bwd_bound(msda, loc,
                                                    shapes=shapes)[0]
            res["bwd_cache_bytes"] = traffic["bwd"]
        for lname, lib in libs.items():
            with _build.use_library(lib):
                res["libraries"][lname] = dict(
                    max_abs_err=check_case(case, want), fwd_ms=[], bwd_ms=[])
        del want
        order = list(libs)
        for turn in (order, order[::-1]):
            for lname in turn:
                r = res["libraries"][lname]
                with _build.use_library(libs[lname]):
                    r["fwd_ms"].append(cs.cuda_ms(lambda: msda.msda_fwd(
                        value, shapes, loc, attn), iters))
                    if g is not None:
                        r["bwd_ms"].append(cs.cuda_ms(lambda: msda.msda_bwd(
                            value, shapes, loc, attn, g), iters))
        line = [f"{name} Lq={lq}: fwd bound {fb:.4f} ms, "
                f"{traffic['fwd'] / 1e9:.3f} GB from the caches"
                + (f"; bwd bound {res['bwd_bound_ms']:.4f} ms, "
                   f"{traffic['bwd'] / 1e9:.3f} GB" if g is not None else "")]
        for lname, r in res["libraries"].items():
            f_ms = sum(r["fwd_ms"]) / 2
            txt = (f"   {lname:>12}: fwd {f_ms:.4f} ms ({f_ms / fb:.1f}x "
                   f"bound, {traffic['fwd'] / f_ms / 1e9:.2f} TB/s)")
            if r["bwd_ms"]:
                b_ms = sum(r["bwd_ms"]) / 2
                txt += (f"; bwd {b_ms:.4f} ms "
                        f"({b_ms / res['bwd_bound_ms']:.1f}x bound, "
                        f"{traffic['bwd'] / b_ms / 1e9:.2f} TB/s)")
            line.append(txt + f"; turns fwd {r['fwd_ms']} bwd {r['bwd_ms']}")
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
