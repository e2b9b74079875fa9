"""Useful FLOPs of the training steps in the traced stretch (forward and
backward, no recomputation) over its length and the dtype's peak (%)."""

from perfbench.core import readers


def read(records):
    return readers.mfu_pct(records)
