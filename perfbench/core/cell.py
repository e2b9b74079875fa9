"""One run of one cell: its driver (perfbench/drivers/<driver>.py, by the
cell file's `driver`), then the result line from what the driver measured
and what the per-layer readers find in the traced run's records."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from . import spec as specs


def load(name: str) -> dict:
    return specs.cell_spec(name)


def run(spec: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: str = None, tiny: bool = False) -> Dict:
    result = specs.driver(spec["cell"]["driver"]).run(
        spec, seed, seconds, trace, device, t_start, fault=fault, tiny=tiny)
    details = [{"detail": result.get("detail", {}),
                "readings": result["checks"]}]
    try:
        from datr_torch.ops import msda
        details.append({"launches": {
            "msda_fwd": msda.msda_fwd.launches,
            "msda_bwd": msda.msda_bwd.launches}})
    except ImportError:
        pass
    host = result.get("host") or {}
    if host.get("late_s"):
        late = sorted(host["late_s"])
        details.append({"generator_late_s": {
            "p50": late[len(late) // 2],
            "p95": late[math.ceil(0.95 * len(late)) - 1],
            "max": late[-1]}})
    details.append({"end_to_end_in_this_run": result["end_to_end"],
                    "window_s": result["window_s"],
                    "traced": trace})
    result["details"] = details
    return result


def checks_of(spec: dict, result: Dict) -> Dict[str, Dict[str, float]]:
    limits = spec["cell"]["limits"]
    return {k: {"value": result["checks"][k], "limit": limits[k]}
            for k in limits}


def result_line(spec: dict, result: Dict, trace: bool,
                device) -> Tuple[Dict, Dict]:
    checks = checks_of(spec, result)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"]}
    if not trace:
        for m in spec["end_to_end"]:
            v = (result["setup_s"] if m["name"] == "setup_s"
                 else result["end_to_end"].get(m["name"]))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        rec = result["records"]
        for m in spec["per_layer"]:
            v = specs.metric_reader(m["name"])(rec) if rec else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": spec["entry"]["chips"],
           "memory_peak_bytes": result["mem_peak"]}
    line["metrics"] = metrics
    if trace and result["records"]:
        rec = result["records"]
        dev["busy_s"] = rec["busy_s"]
        dev["window_s"] = rec["window_s"]
        line["device"] = dev
        line["breakdown"] = {"device_ops": rec["device_ops"],
                             "idle_gaps": rec["idle_gaps"]}
    else:
        line["device"] = dev
    line["checks"] = checks
    return line, checks
