"""The training step's device idle share over a traced stretch of whole steps
(%)."""

from perfbench.core import readers


def read(records):
    return readers.idle_pct(records)
