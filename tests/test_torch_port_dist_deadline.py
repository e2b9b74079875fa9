"""The multi-rank helper's deadline (tests/torch_port_dist_worker.py): a
rank that never finishes fails its test at `join`'s deadline, its ranks
terminated, instead of holding the whole run."""

import os
import sys
import time

import pytest
import torch_port_threads  # noqa: F401  (torch threads under xdist)

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_dist_worker as worker  # noqa: E402


def test_a_rank_past_the_deadline_fails_the_join(tmp_path):
    t0 = time.monotonic()
    ctx = worker.spawn([("sleep", dict(seconds=300, ranks=[1]))], 2,
                       tmp_path)
    with pytest.raises(TimeoutError, match=r"ranks \[.*1\] of 2 still "
                       r"running after 10 s"):
        worker.join(ctx, timeout=10)
    assert time.monotonic() - t0 < 40
    assert not any(p.is_alive() for p in ctx.processes)


def test_ranks_inside_the_deadline_join(tmp_path):
    ctx = worker.spawn([("sleep", dict(seconds=1, ranks=[0]))], 2, tmp_path)
    worker.join(ctx, timeout=120)
    assert [r for r in worker.results(tmp_path, "sleep", 2)] == [0, 1]


def test_a_thread_past_the_deadline_fails_in_threads():
    """`in_threads`: a fn that sleeps past a 2 s deadline fails the call
    in about 2 s, beside one that finishes; the sleeper's daemon thread is
    left behind and holds nothing."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"threads \[1\] of 2 still "
                       r"running after 2 s"):
        worker.in_threads(lambda: 1, lambda: time.sleep(300), timeout=2)
    assert time.monotonic() - t0 < 10


def test_in_threads_returns_in_order_and_raises_a_fns_error():
    assert worker.in_threads(lambda: "a", lambda: "b", timeout=60) == [
        "a", "b"]
    with pytest.raises(ZeroDivisionError):
        worker.in_threads(lambda: 1, lambda: 1 / 0, timeout=60)
