"""Small IO and class-mapping utilities (port of datr_tpu/utils/io.py):
`sl_load` / `sl_dump` (json, pickle or yaml, by the file's extension) and
`CocoClassMapper`, COCO's sparse category ids (1..90, 80 of them used) to
compact indices (0..79) and back, derived from the ids COCO leaves out."""

from __future__ import annotations

import json
import os
import pickle
from typing import Any

# COCO ids absent from the 80-class detection set (of 1..90)
_COCO_MISSING = (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)
_ORIGIN_IDS = [i for i in range(1, 91) if i not in _COCO_MISSING]


class CocoClassMapper:
    """COCO sparse category id (1..90) <-> compact index (0..79)."""

    def __init__(self) -> None:
        self.origin2compact_mapper = {o: c for c, o in enumerate(_ORIGIN_IDS)}
        self.compact2origin_mapper = {c: o for c, o in enumerate(_ORIGIN_IDS)}

    def origin2compact(self, idx) -> int:
        return self.origin2compact_mapper[int(idx)]

    def compact2origin(self, idx) -> int:
        return self.compact2origin_mapper[int(idx)]


def _handler(filepath: str):
    ext = os.path.splitext(filepath)[1].lower().lstrip(".")
    if ext == "json":
        return "json"
    if ext in ("pkl", "pickle"):
        return "pickle"
    if ext in ("yml", "yaml"):
        return "yaml"
    raise ValueError(f"unsupported file extension: {filepath!r}")


def sl_load(filepath: str, **kwargs) -> Any:
    """Load json / pickle / yaml by extension. Unpickle only files this
    program wrote: unpickling can run arbitrary code."""
    kind = _handler(filepath)
    if kind == "json":
        with open(filepath) as f:
            return json.load(f, **kwargs)
    if kind == "pickle":
        with open(filepath, "rb") as f:
            return pickle.load(f, **kwargs)
    import yaml

    with open(filepath) as f:
        return yaml.safe_load(f)


def sl_dump(obj: Any, filepath: str, **kwargs) -> None:
    """Dump json / pickle / yaml by extension."""
    kind = _handler(filepath)
    if kind == "json":
        with open(filepath, "w") as f:
            json.dump(obj, f, default=str, **kwargs)
    elif kind == "pickle":
        with open(filepath, "wb") as f:
            pickle.dump(obj, f, **kwargs)
    else:
        import yaml

        with open(filepath, "w") as f:
            yaml.safe_dump(obj, f)
