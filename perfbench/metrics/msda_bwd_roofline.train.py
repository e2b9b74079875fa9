"""MSDA backward calls of the training steps: their bounds over their device
time (%)."""

from perfbench.core import readers


def read(records):
    return readers.msda_roofline_pct(records, backward=True)
