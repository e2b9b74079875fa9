"""The harness's own tests: `python -m pytest perfbench/tests -q` from the
repository root (the CPU ones here; those marked `gpu` run on a card and
skip without one)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
                 window_size=4)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny(monkeypatch):
    """The configurations' tiny backbones, registered in the measured
    package and in the reference alike (no file of either changes)."""
    import datr_torch.models.dino as dino
    from datr_torch.models import swin

    from perfbench.reference import model as ref

    monkeypatch.setitem(dino.RESNET_STAGES, "resnet_tiny", (1, 1, 1, 1))
    monkeypatch.setitem(swin.SWIN_CONFIGS, "swin_tiny_test", TINY_SWIN)
    monkeypatch.setitem(ref.SWIN, "swin_tiny_test", TINY_SWIN)
    torch.set_num_threads(min(4, torch.get_num_threads()))
