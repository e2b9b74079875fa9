"""Useful FLOPs of the images the saturated server answered in the traced
stretch over its length and the dtype's peak (%)."""

from perfbench.core import readers


def read(records):
    return readers.mfu_pct(records)
