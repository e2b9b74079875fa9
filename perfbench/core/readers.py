"""Arithmetic shared by the per-layer readers under perfbench/metrics/:
each reader is one file that names its metric's quantity; none returns 0
for a share it could not read."""

from __future__ import annotations

from typing import Optional

from .peaks import PEAK_FLOPS, msda_bound_s


def idle_pct(rec: dict) -> Optional[float]:
    """The traced stretch's share without any device activity."""
    if not rec or rec.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def mfu_pct(rec: dict) -> Optional[float]:
    """The useful FLOPs finished in the traced stretch over its length and
    the configuration dtype's peak."""
    if not rec or not rec.get("flops") or rec.get("window_s", 0) <= 0:
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / PEAK_FLOPS[rec["dtype"]]


def msda_roofline_pct(rec: dict, backward: bool) -> Optional[float]:
    """The sum of each MSDA call's bound over the device time of every
    kernel launched under the registered op."""
    name = ("datr_torch::ms_deform_attn_backward" if backward
            else "datr_torch::ms_deform_attn")
    calls = (rec or {}).get("ops", {}).get(name, [])
    dev_s = sum(c["device_s"] for c in calls)
    if not calls or dev_s <= 0:
        return None
    bound = sum(msda_bound_s(c["shapes"], rec["dtype"], backward)
                for c in calls)
    return 100.0 * bound / dev_s
