"""The open-loop server's device idle share over a traced stretch of the window
(%)."""

from perfbench.core import readers


def read(records):
    return readers.idle_pct(records)
