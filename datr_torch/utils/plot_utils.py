"""Training-log plotting (port of datr_tpu/utils/plot_utils.py): per-field
curves from the JSON lines of `<output_dir>/log.txt`, with optional
exponential smoothing. The parsing needs nothing beyond the standard
library; `plot_logs` imports matplotlib when it is called."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence


def read_log(log_dir: str, log_name: str = "log.txt") -> List[dict]:
    """The JSON lines of the epoch log datr_torch.main writes (the
    logger's own lines in the same file are skipped)."""
    rows = []
    with open(os.path.join(log_dir, log_name)) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return rows


def extract_fields(rows: List[dict], fields: Sequence[str],
                   ewm_alpha: float = 0.0) -> Dict[str, List[float]]:
    """Per-field series over epochs; ewm_alpha > 0 smooths them
    exponentially (prev = alpha * prev + (1 - alpha) * value)."""
    out: Dict[str, List[float]] = {}
    for field in fields:
        series = [float(r[field]) for r in rows if field in r]
        if ewm_alpha > 0 and series:
            sm, prev = [], series[0]
            for v in series:
                prev = ewm_alpha * prev + (1 - ewm_alpha) * v
                sm.append(prev)
            series = sm
        out[field] = series
    return out


def plot_logs(log_dirs, fields=("train_loss", "ap50_student",
                                "ap50_teacher"),
              ewm_alpha: float = 0.0, log_name: str = "log.txt",
              out_path: str | None = None):
    """Per-field curves of one or more runs; returns (fig, axs) and saves
    to `out_path` if given. Needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(log_dirs, (str, os.PathLike)):
        log_dirs = [log_dirs]
    fig, axs = plt.subplots(ncols=len(fields),
                            figsize=(5 * len(fields), 4), squeeze=False)
    axs = axs[0]
    for d in log_dirs:
        rows = read_log(str(d), log_name)
        data = extract_fields(rows, fields, ewm_alpha)
        for ax, field in zip(axs, fields):
            ax.plot(data[field], label=os.path.basename(str(d)))
            ax.set_title(field)
    for ax in axs:
        ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig, axs
