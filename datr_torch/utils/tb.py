"""TensorBoard scalar logging (port of datr_tpu/utils/tb.py): the log.txt
scalars of each epoch, mirrored to an event file. The backend is
torch.utils.tensorboard, else tensorboardX, else a no-op: never a hard
dependency. Only scalars are written, so the files stay small."""

from __future__ import annotations

import numbers
from typing import Dict, Optional


def _make_summary_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir)
    except Exception:
        pass
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(log_dir)
    except Exception:
        return None


class ScalarWriter:
    """Write a dict of scalars per step; a no-op when disabled or when no
    TensorBoard backend imports (`active` says which)."""

    def __init__(self, log_dir: Optional[str], enabled: bool = True):
        self._w = (_make_summary_writer(log_dir) if (enabled and log_dir)
                   else None)

    @property
    def active(self) -> bool:
        return self._w is not None

    def write(self, step: int, scalars: Dict[str, object],
              prefix: str = "") -> None:
        if self._w is None:
            return
        for k, v in scalars.items():
            if isinstance(v, numbers.Number):
                self._w.add_scalar(prefix + k, float(v), global_step=step)
        self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None
