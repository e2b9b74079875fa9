"""The traced run's records: `torch.profiler` over two stretches, reduced to
what the per-layer readers and the result's `breakdown` need.

- The device stretch (the window's last `seconds`; a training cell's ends
  where its detail stretch begins, `detail_seconds` before the close) records
  device activity alone, so that it costs the host little: the device is
  busy where any kernel, copy or memset runs, the union of their
  intervals, and idle for the rest of the stretch (its length on the host's
  clock, both ends synchronised). The longest idle gaps are labelled by the
  CUDA call the host was in at their middle, or the one that ended them.
  The arithmetic is that of the measured package's profile tool
  (`datr_torch/tools/profile_model.py` `summarize`; `chip_smoke.py`
  `profile_step`).
- The detail stretch records host ops with their input shapes, whose cost
  on the host would distort the first stretch's idle share: a training
  cell's last steps of the window (every thread: the backward runs in the
  autograd engine's); a serving cell's own step
  (`InferenceServer._step`) on two of the cell's batches, called from the
  profiling thread once the window has closed. Kernels are attributed to a
  registered op through the profiler's launch correlation (an op's device
  time counts every kernel launched under it, whatever the kernels are
  called), which the MSDA rooflines read: kernel time does not depend on
  how busy the host is.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List

import torch

CUDA = torch.autograd.DeviceType.CUDA


def _all_threads_config():
    """Record the host ops of every thread, where this PyTorch offers it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class Stretch:
    """One profiler over start() .. stop(); both ends synchronise.
    `all_threads`: record host ops of every thread (a training step's
    backward runs in the autograd engine's threads); off where other
    threads run the model meanwhile (with the server's threads alive it
    once crashed the process)."""

    def __init__(self, device: torch.device, detail: bool,
                 all_threads: bool = False):
        self.device, self.detail = device, detail
        self.all_threads = all_threads
        self.prof = None
        self.t_a = self.t_b = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        acts = []
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        if self.detail or self.device.type != "cuda":
            acts.append(torch.profiler.ProfilerActivity.CPU)
        cfg = _all_threads_config() if self.all_threads else None
        kw = {"experimental_config": cfg} if cfg is not None else {}
        self._sync()
        self.prof = torch.profiler.profile(activities=acts,
                                           record_shapes=self.detail, **kw)
        self.prof.start()
        self.t_a = time.perf_counter()

    def stop(self):
        if self.prof is None or self.t_b is not None:
            return
        self._sync()
        self.t_b = time.perf_counter()
        self.prof.stop()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t_b is None


class Tracer:
    """The two stretches; `records()` after both have stopped."""

    def __init__(self, device: torch.device, seconds: float,
                 detail_seconds: float, all_threads: bool = False):
        self.seconds, self.detail_seconds = seconds, detail_seconds
        self.main = Stretch(device, detail=False)
        self.detail = Stretch(device, detail=True, all_threads=all_threads)

    def records(self, top: int = 10) -> Dict:
        rec = self._device_records(top)
        rec["ops"] = self._op_records()
        return rec

    def _device_records(self, top: int) -> Dict:
        events = list(self.main.prof.events())
        dev = [e for e in events if e.device_type == CUDA
               and not getattr(e, "is_user_annotation", False)]
        busy: List[List[float]] = []
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in dev):
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        busy_us = sum(b - a for a, b in busy)
        by_name: Dict[str, float] = defaultdict(float)
        for e in dev:
            by_name[e.name] += e.time_range.end - e.time_range.start
        calls = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in events if e.device_type != CUDA
                       and not e.name.startswith(("Activity Buffer",
                                                  "Buffer Flush")))
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(busy, busy[1:])), reverse=True)[:top]

        def doing(a: float, b: float) -> str:
            mid = (a + b) / 2
            inside = [c for c in calls if c[0] <= mid <= c[1]]
            if inside:
                return f"host in {min(inside, key=lambda c: c[1] - c[0])[2]}"
            after = [c for c in calls if a <= c[0] <= b]
            if after:
                return f"host busy, then {after[-1][2]}"
            return "host busy, no CUDA call"

        return {
            "window_s": self.main.t_b - self.main.t_a,
            "busy_s": busy_us / 1e6,
            "device_ops": sorted(([n, t / 1e6] for n, t in by_name.items()),
                                 key=lambda r: -r[1])[:top],
            "idle_gaps": [[doing(a, b), g / 1e6] for g, a, b in gaps],
        }

    def _op_records(self) -> Dict[str, list]:
        ops = defaultdict(list)
        if self.detail.prof is None:
            return {}
        for e in self.detail.prof.events():
            if e.device_type != CUDA and e.name.startswith("datr_torch::"):
                ops[e.name].append({"shapes": e.input_shapes,
                                    "device_s": e.device_time_total / 1e6})
        return dict(ops)
