"""torch's intra-op threads for the port's tests under pytest-xdist.

Every `tests/test_torch_port_*.py` imports this module. Under xdist each
worker collects (imports) every test file, so the cap below reaches the
whole worker process, whichever file it then runs. Without it each of n
workers carries torch's default team of one thread per core beside JAX's
pool: the port's tiny-model tests make tens of thousands of small ops, and
each op waits at the barrier of an oversubscribed team. A file run alone
(no `PYTEST_XDIST_WORKER`) keeps torch's default.
"""

import os

import torch


def worker_threads():
    """The cores per xdist worker (at least 1), or None outside xdist."""
    n = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not os.environ.get("PYTEST_XDIST_WORKER") or not n:
        return None
    return max(1, (os.cpu_count() or 1) // max(1, int(n)))


THREADS = worker_threads()
if THREADS is not None:
    torch.set_num_threads(THREADS)


def loader_threads(default: int) -> int:
    """`default` data-loader threads alone; no more than the worker's
    cores under xdist."""
    return default if THREADS is None else max(1, min(default, THREADS))
