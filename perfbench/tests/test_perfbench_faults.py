"""The whole of a run past the look for a card, at a tiny size on the CPU,
with the timed path sound and with each fault the cell can have planted
underneath it: `correct` comes out true once and false for every fault.
(One chip, so no exchange between chips to leave out.)"""

import time

import pytest
import torch

from perfbench.core import cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242


def _run(name, fault):
    spec = cell.load(name)
    res = cell.run(spec, SEED, 1.5, False, CPU, time.perf_counter(),
                   fault=fault, tiny=True)
    # the limits are the cell's own (set at full size on the card)
    line, checks = cell.result_line(spec, res, False, CPU)
    return line, checks


@pytest.mark.parametrize("name,fault,correct", [
    ("c2f_r50.burnin", None, True),
    ("c2f_r50.burnin", "state_unchanged", False),
    ("c2f_r50.burnin", "half_batch", False),
    ("swinl.serve_sat", None, True),
    ("swinl.serve_sat", "altered_answer", False),
    ("c2f_r50.serve_open", None, True),
    ("c2f_r50.serve_open", "altered_answer", False),
])
def test_correct_sees_the_fault(tiny, name, fault, correct):
    line, checks = _run(name, fault)
    assert line["correct"] is correct, checks
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
