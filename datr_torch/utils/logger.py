"""Logging and training meters (port of datr_tpu/utils/logger.py; reference
util/logger.py:setup_logger :31-92, util/misc.py SmoothedValue /
MetricLogger :32-262): the window smoothing and the log_every cadence. The
meters need no cross-rank sync: the training steps return global metrics
(train/steps.py). Across processes rank 0 logs to stdout and `log.txt`,
rank i > 0 to `log.txt.rank{i}` only (datr_tpu/utils/logger.py:19-44).
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional


def setup_logger(
    output: Optional[str] = None, name: str = "datr_torch",
    process_index: int = 0,
) -> logging.Logger:
    """The named logger, to stdout and to `output` (a .txt/.log file, or
    `<output>/log.txt`); for `process_index` > 0 to `<file>.rank{i}` and
    not to stdout. Once it has handlers it is returned as it is."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s.%(msecs)03d] %(name)s %(levelname)s: %(message)s",
        datefmt="%m/%d %H:%M:%S",
    )
    if process_index == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    if output:
        if output.endswith(".txt") or output.endswith(".log"):
            filename = output
        else:
            os.makedirs(output, exist_ok=True)
            filename = os.path.join(output, "log.txt")
        if process_index > 0:
            filename = f"{filename}.rank{process_index}"
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} "
                 "({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  ", logger=None):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.logger = logger or logging.getLogger("datr_torch")

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        """Yields from `iterable`, logging the meters, the step time and
        the time spent waiting for data every `print_freq` items."""
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                msg = [header, f"[{i}" + (f"/{total}]" if total else "]"),
                       str(self), f"time: {iter_time}", f"data: {data_time}"]
                self.logger.info(self.delimiter.join(m for m in msg if m))
            i += 1
            end = time.time()
        self.logger.info(
            f"{header} Total time: {time.time() - start:.1f}s ({i} iters)"
        )
