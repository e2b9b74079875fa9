"""Row-gather microbenchmark on the card: the port of the gather benchmark
tools/msda_pallas_bench.py (:116-143) and the gather probes of
tools/mosaic_probe.py (:55-118).

    python -m datr_torch.tools.msda_gather_bench [--device cpu]

Cases, each at the shapes and index pattern of its TPU original:
  copy     row_gather over table [22528, 128] bf16, 32,768 random indices
  fma      gather_fma, the same table and indices, f32 weights, 16 rows
           to one output row (MSDA's inner operation) -> [2048, 128] bf16
  vectorized_gather / dynamic_sublane_load / partial_unroll
           row_gather over table arange(1024*128) f32 [1024, 128], 256
           indices arange(256) % 1024 / arange(256) % 1023 with row offset 1
           / arange(256) * 8 % 1024
Each is checked against its plain PyTorch version on the same device
(exact for the gathers, one bf16 rounding for fma), then timed beside the
plain version and its PyTorch yardstick (index_select; embedding_bag for
fma, where it takes bf16, else its times are None): `ms` per call by CUDA
events over back-to-back calls (launch-bound at these sizes: it holds the
host's time per call) and `device_ms`, the kernels' own time per call from
the profiler (`plain_` and `library_` prefixes for the others); rows/s, the
kernel's and the yardstick's, is taken on the device time. Each case also
carries `bytes` and `flops`, what the function must move and do (each
distinct table row read once, idx and weights read once, the output written
once), for a roofline bound. Prints one JSON line per case and writes no
file. The table (5.8 MB) stays in the card's 50 MB L2 between launches.
`--device cpu` runs the plain versions, timed by the host clock.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import gather

T, NBLK, NGRID = 22528, 2048, 16  # tools/msda_pallas_bench.py:52-54
N = NBLK * NGRID
K = 16  # rows per fma output
PROBE_T, PROBE_D, PROBE_N = 1024, 128, 256  # tools/mosaic_probe.py:38

PROBES = {  # name -> (index pattern, row offset)
    "vectorized_gather": (np.arange(PROBE_N) % PROBE_T, 0),
    "dynamic_sublane_load": (np.arange(PROBE_N) % (PROBE_T - 1), 1),
    "partial_unroll": (np.arange(PROBE_N) * 8 % PROBE_T, 0),
}


def bench_inputs(device, seed: int = 0):
    """(table bf16 [T, 128], idx int32 [N], w f32 [N, 1]) on `device`, from
    the seeds and draws the TPU bench uses (msda_pallas_bench.py:117-120)."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((T, 128))).to(torch.bfloat16)
    idx = rng.integers(0, T, (N,)).astype(np.int32)
    w = rng.standard_normal((N, 1)).astype(np.float32)
    return (table.to(device), torch.from_numpy(idx).to(device),
            torch.from_numpy(w).to(device))


def probe_inputs(name: str, device):
    idx, offset = PROBES[name]
    table = torch.arange(PROBE_T * PROBE_D, dtype=torch.float32).reshape(
        PROBE_T, PROBE_D)
    return (table.to(device),
            torch.from_numpy(idx.astype(np.int32)).to(device), offset)


def _time_ms(fn, dev, iters: int) -> float:
    fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, iters: int = 50, attempts: int = 3) -> float:
    """Device time per call of fn on the card: the time of the kernels it
    launches, summed by the profiler, without the host's gaps between
    launches. A profiler session now and then records no device activity at
    all; such a session is run again, up to `attempts` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / iters
    raise RuntimeError(f"the profiler recorded no device time in "
                       f"{attempts} sessions")


def _timed(dev, iters, fns):
    """For each (prefix, fn) of `fns`: `<prefix>ms`, the time per call by
    CUDA events (by the host's clock on the CPU), and `<prefix>device_ms`,
    the profiler's device time per call (None on the CPU); both None where
    fn is None."""
    out = {}
    for prefix, fn in fns.items():
        out[f"{prefix}ms"] = _time_ms(fn, dev, iters) if fn else None
        out[f"{prefix}device_ms"] = (device_ms(fn) if fn and dev.type == "cuda"
                                     else None)
    return out


def _work(table, idx, offset=0, k=None):
    """(bytes, f32 operations) the function must move and do on these
    inputs: each distinct table row read once, idx (and the fma's weights)
    read once, the output written once; a multiply-add per gathered element
    of the fma."""
    rows = int(torch.unique(idx.long() + offset).numel())
    row_b = table.shape[1] * table.element_size()
    n_out = idx.numel() // k if k else idx.numel()
    n_bytes = (rows * row_b + idx.numel() * 4 + n_out * row_b
               + (idx.numel() * 4 if k else 0))
    flops = idx.numel() * table.shape[1] * 2 if k else 0
    return dict(bytes=n_bytes, flops=flops, table_rows_read=rows)


def run(device=None, iters: int = 200):
    """Check every case against its plain version on the same device and
    time the kernel, the plain version and the yardstick; returns a list of
    result dicts (see the module docstring)."""
    dev = resolve_device(device)
    results = []

    def add(case, kernel, rows, got, want, tol, library, fns, work):
        err = (got.float() - want.float()).abs().max().item()
        ok = (torch.equal(got, want) if tol is None else
              torch.allclose(got.float(), want.float(), **tol))
        timed = _timed(dev, iters, fns)
        per_call = timed["device_ms"] or timed["ms"]
        lib_call = timed["library_device_ms"] or timed["library_ms"]
        results.append(dict(
            case=case, kernel=kernel, rows=rows, ok=bool(ok), max_abs_err=err,
            rows_per_s=rows / per_call * 1e3, library=library,
            library_rows_per_s=rows / lib_call * 1e3 if lib_call else None,
            **timed, **work))

    table, idx, w = bench_inputs(dev)
    idx64 = idx.long()
    add("copy", "row_gather", N, gather.row_gather(table, idx),
        gather.row_gather_plain(table, idx), None, "index_select",
        {"": lambda: gather.row_gather(table, idx),
         "plain_": lambda: gather.row_gather_plain(table, idx),
         "library_": lambda: torch.index_select(table, 0, idx64)},
        _work(table, idx))

    bags, wb = idx64.view(-1, K), w.view(-1, K).to(table.dtype)

    def bag():
        return F.embedding_bag(bags, table, per_sample_weights=wb,
                               mode="sum")

    try:
        bag()
    except RuntimeError:  # this build's embedding_bag refuses bf16
        bag = None
    # held against the plain version's f32 sum: one bf16 rounding
    add("fma", "gather_fma", N, gather.gather_fma(table, idx, w, K),
        gather.gather_fma_plain(table.float(), idx, w, K),
        dict(rtol=2.0 ** -8, atol=1e-5), "embedding_bag",
        {"": lambda: gather.gather_fma(table, idx, w, K),
         "plain_": lambda: gather.gather_fma_plain(table, idx, w, K),
         "library_": bag},
        _work(table, idx, k=K))

    for name in PROBES:
        ptable, pidx, offset = probe_inputs(name, dev)
        pidx64 = pidx.long() + offset
        add(name, "row_gather", PROBE_N,
            gather.row_gather(ptable, pidx, offset),
            gather.row_gather_plain(ptable, pidx, offset), None,
            "index_select",
            {"": lambda: gather.row_gather(ptable, pidx, offset),
             "plain_": lambda: gather.row_gather_plain(ptable, pidx, offset),
             "library_": lambda: torch.index_select(ptable, 0, pidx64)},
            _work(ptable, pidx, offset))
    for r in results:
        r["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' runs the plain "
                        "versions")
    p.add_argument("--iters", type=int, default=200)
    args = p.parse_args(argv)
    results = run(args.device, args.iters)
    for r in results:
        print(json.dumps(r), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
