"""MSDA forward calls of the open-loop server: their bounds over their device
time (%)."""

from perfbench.core import readers


def read(records):
    return readers.msda_roofline_pct(records, backward=False)
