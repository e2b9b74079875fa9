"""BENCHMARK.json against the harness's files: names and units, the metrics'
arrows, and every named piece found by its name."""

import json
import re

import pytest

from perfbench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in BENCH["workloads"]] + [
            w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_moves_reported_where_listed(cell):
    s = spec.cell_spec(cell, BENCH)
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert s["per_layer"]
    for m in s["per_layer"]:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    s = spec.cell_spec(cell, BENCH)
    entry, own = s["entry"], s["cell"]
    for k in ("config", "traffic", "chips", "why"):
        assert own[k] == entry[k], k
    for m in s["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    drv = spec.driver(own["driver"])
    assert callable(drv.run) and callable(drv.control)
    assert s["traffic"]["kind"] in ("batches", *getattr(drv, "LOOPS", ()))
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert (spec.ROOT / conf["file"]).exists()
    assert s["config"]["name"] == conf["name"]
    assert s["config"]["reduced"] == conf["reduced"]
    limits = own["limits"]
    assert limits and all(v > 0 for v in limits.values())


def test_every_file_is_used():
    used_configs = {w["config"] for w in BENCH["workloads"]}
    assert used_configs == {c["name"] for c in BENCH["configs"]}
    for kind, names in (("workloads", CELLS),
                        ("metrics", [m["name"] for m in BENCH["per_layer"]])):
        files = {p.name.rsplit(".", 1)[0]
                 for p in (spec.BENCH / kind).iterdir()
                 if p.suffix in (".json", ".py")}
        assert files == set(names), kind


def test_readers_return_nothing_without_records():
    for m in BENCH["per_layer"]:
        assert spec.metric_reader(m["name"])({}) is None
        assert spec.metric_reader(m["name"])(None) is None


def test_json_files_parse():
    for p in spec.BENCH.rglob("*.json"):
        json.loads(p.read_text())
