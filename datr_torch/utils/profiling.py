"""Profiling helpers (port of datr_tpu/utils/profiling.py): named host
spans (`TimeHolder`), a device trace (`device_trace`, through
torch.profiler) and a two-point throughput measurement
(`measure_throughput`)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict

import torch


class TimeHolder:
    """Accumulate named wall-clock spans."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {
            k: self.totals[k] / max(self.counts[k], 1) for k in self.totals
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block (host and, where a card is present,
    CUDA activity); the trace goes to `<log_dir>/trace.json` (Chrome trace
    format: chrome://tracing or Perfetto). Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(args):
    for a in args:
        if torch.is_tensor(a):
            return a
        if isinstance(a, (list, tuple)):
            t = _first_tensor(a)
            if t is not None:
                return t
    return None


def measure_throughput(
    fn: Callable, args: tuple, batch: int, n1: int = 2, n2: int = 10,
) -> float:
    """Seconds per call of `fn(*args)`, as the difference of two runs of
    n1 and n2 back-to-back calls divided by n2 - n1, so that what a run
    pays once (the first launch's wait, the final synchronization) drops
    out. Each run follows one untimed call. Where the first tensor in
    `args` is on a CUDA card the runs are timed by CUDA events on its
    current stream, else by the host clock. `batch` is unused (datr_tpu's
    signature); divide it by the result for images per second."""
    t = _first_tensor(args)
    cuda = t is not None and t.is_cuda
    times = {}
    for n in (n1, n2):
        fn(*args)  # warm
        if cuda:
            torch.cuda.synchronize(t.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn(*args)
            end.record()
            end.synchronize()
            times[n] = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(*args)
            times[n] = time.perf_counter() - t0
    return (times[n2] - times[n1]) / (n2 - n1)
