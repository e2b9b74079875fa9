"""Where the harness finds each named piece, all by name:

    BENCHMARK.json                      the cells, metrics, bounds
    perfbench/workloads/<cell>.json     one cell: config, traffic, driver,
                                        its check's limits, its FLOPs
    perfbench/configs/<config>.json     one model configuration
    perfbench/traffic/<mix>.json        one traffic mix (data only)
    perfbench/drivers/<driver>.py       how a kind of cell drives the
                                        program (training, serving)
    perfbench/metrics/<metric>.py       the reader of one per-layer metric

A later cell, configuration, mix or metric is a new file; no file here
names another cell's.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> dict:
    return _json(BENCH / "workloads" / f"{name}.json")


def load_config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def load_traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def driver(name: str):
    """The module perfbench/drivers/<name>.py."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"not a driver's name: {name!r}")
    return importlib.import_module(f"perfbench.drivers.{name}")


def metric_reader(name: str) -> Callable[[dict], object]:
    """`read(records)` of perfbench/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_spec(name: str, bench: dict = None) -> Dict:
    """Everything one run of cell `name` needs: its BENCHMARK.json entry,
    its own file, its configuration and traffic, and the metrics it
    reports with and without tracing."""
    bench = bench or load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if ("workloads" in m and name in m["workloads"])
                 or ("workloads" not in m and m["moves"] in e2e_names)]
    return {"name": name, "entry": entry, "cell": load_cell(name),
            "config": load_config(entry["config"]),
            "traffic": load_traffic(entry["traffic"]),
            "end_to_end": e2e, "per_layer": per_layer}
