"""run.py refuses to measure without the card, and without the measured
package beside it: a non-zero exit and no result line."""

import shutil
import subprocess
import sys

import pytest
import torch

from perfbench.core import spec


def _run(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "c2f_r50.burnin",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(p):
    last = (p.stdout.strip().splitlines() or [""])[-1]
    return p.returncode != 0 and '"correct"' not in last


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert _no_result(_run(spec.ROOT))


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _no_result(_run(tmp_path))
