"""The one traffic generator: a seed repeats exactly, seeds differ, and
every seed offers the same amount of work; the open loop times each
request from when it was due."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from perfbench.core import spec, traffic
from perfbench.drivers import serve
from perfbench.reference import serve as rserve

CPU = torch.device("cpu")


def _train_mix():
    mix = spec.load_traffic("c2f_train_2x2")
    return dict(mix, **mix["tiny"])


def _same(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def test_train_batches_repeat_and_differ():
    mix = _train_mix()
    a = traffic.train_batches(mix, 9, (96, 128), 2 ** 31 + 5, CPU)
    b = traffic.train_batches(mix, 9, (96, 128), 2 ** 31 + 5, CPU)
    c = traffic.train_batches(mix, 9, (96, 128), 2 ** 31 + 6, CPU)
    assert _same(a, b)
    assert not _same(a, c)


def test_train_batches_same_work_every_seed():
    mix = _train_mix()

    def work(seed):
        bs = traffic.train_batches(mix, 9, (96, 128), seed, CPU)
        ext = sorted(int((~b["pad_mask"][i]).sum()) for b in bs
                     for i in range(b["pad_mask"].shape[0]))
        boxes = sorted(int(b["valid"][i].sum()) for b in bs
                       for i in range(b["valid"].shape[0]))
        return ext, boxes

    assert work(1) == work(99) == work(2 ** 31 + 77)


@pytest.mark.parametrize("mix", ["coco_closed8", "foggy_poisson"])
def test_frames_repeat_and_differ(mix):
    m = spec.load_traffic(mix)
    m = dict(m, **m["tiny"])
    a = traffic.base_frames(m, 7, CPU)
    b = traffic.base_frames(m, 7, CPU)
    c = traffic.base_frames(m, 8, CPU)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert sorted(f.shape for f in a) == sorted(f.shape for f in c)


def _gaps(due):
    return np.diff([0.0] + due).round(12).tolist()


def test_arrivals_same_set_other_order():
    """The gaps are a Poisson process's, in a fixed order: every seed is
    offered the same schedule (a tail depends on how arrivals bunch)."""
    m = spec.load_traffic("foggy_poisson")
    a = traffic.arrival_times(m, 60.0)
    assert a == traffic.arrival_times(m, 60.0) and a == sorted(a)
    gaps = _gaps(a)
    assert gaps != sorted(gaps)
    assert len(a) == round(60.0 * m["rate_per_s"])
    assert abs(len(a) / a[-1] - m["rate_per_s"]) < 0.05 * m["rate_per_s"]


def test_on_off_arrivals_are_data():
    """Bursts need no code: phases in the mix's data, cycled over the
    window, each with its own Poisson arrivals."""
    m = {"kind": "open", "threads": 4,
         "phases": [{"seconds": 2.0, "rate_per_s": 20.0},
                    {"seconds": 3.0, "rate_per_s": 0.0}]}
    a = traffic.arrival_times(m, 12.0)
    assert len(a) == 3 * 40 and a == sorted(a)
    on = [(0.0, 2.0), (5.0, 7.0), (10.0, 12.0)]
    for lo, hi in on:
        assert sum(lo < t <= hi + 0.3 for t in a) == 40


@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (360, 640),
                                (1024, 2048)])
def test_stamp_survives_the_resize(hw):
    rng = np.random.default_rng(0)
    img = traffic.stamped(rng.integers(0, 256, (*hw, 3), dtype=np.uint8),
                          0x12AB34)
    oh, ow = rserve.resized_hw(hw[0], hw[1], 800, 1333, (800, 1344))
    assert traffic.stamp_of(rserve.resize_u8(img, oh, ow)) == 0x12AB34


class _StallingServer:
    """Answers each request 10 ms after it is submitted, except that one
    submit blocks for `stall` seconds (as a host stall would)."""

    def __init__(self, stall_at, stall):
        self.n, self.stall_at, self.stall = 0, stall_at, stall
        self.lock = threading.Lock()

    def submit(self, img, timeout=None):
        with self.lock:
            k, self.n = self.n, self.n + 1
            if k == self.stall_at:
                time.sleep(self.stall)
        fut = Future()
        threading.Timer(0.01, fut.set_result, args=({"k": k},)).start()
        return fut


def test_open_loop_counts_a_stall_against_later_requests():
    due = [0.02 * (k + 1) for k in range(30)]
    frames = [np.zeros((8, 8, 3), np.uint8)]
    got = serve._open_loop(_StallingServer(5, 0.3), frames, lambda k: 0,
                           due, 1, lambda t0, t_end: None)
    lat = got["latencies_s"]
    assert max(lat[:5]) < 0.1
    # with one sending thread, the stall holds back the requests due
    # during it: their time counts from when they were due
    assert all(x > 0.1 for x in lat[6:12])
    assert got["failed"] == 0 and got["attempted"] == 30
