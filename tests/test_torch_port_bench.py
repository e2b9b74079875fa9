"""msda_kernel_bench.py's MSDA cases, collected on the CPU at a tiny size:
the bench calls chip_smoke.py's helpers (the C2F training state, the paired
batches, the capture of the MSDA inputs a model produces) as they are
defined, so a change to one of them fails here rather than on the card."""

import sys
from pathlib import Path
from unittest import mock

import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.models.cdn import cdn_layout

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import msda_kernel_bench as bench  # noqa: E402

CANVAS = (64, 96)
NQ, DN, PAD = 12, 4, 2
TINY_C2F = """
_base_ = ["{base}"]
hidden_dim = 32
nheads = 4
enc_layers = 1
dec_layers = 2
dim_feedforward = 64
num_queries = {nq}
dn_number = {dn}
dn_single_pad = {pad}
use_remat = False
"""


def test_collect_training_cases(tmp_path):
    """Every training case (uniform-random and at the seeded model's own
    locations) comes back with a gradient, at the canvas's level shapes."""
    cfg = tmp_path / "tiny_c2f.py"
    cfg.write_text(TINY_C2F.format(base=ROOT / cs.C2F, nq=NQ, dn=DN,
                                   pad=PAD))
    shapes = tuple((-(-CANVAS[0] // s), -(-CANVAS[1] // s))
                   for s in (8, 16, 32, 64))
    real_state = cs.c2f_train_state

    def tiny_state(n_batches, seed=0, device=None):
        return real_state(n_batches, str(cfg), seed, device)

    with mock.patch.object(cs, "c2f_train_state", tiny_state), \
            mock.patch.object(cs, "TRAIN_CANVAS", CANVAS), \
            mock.patch.object(cs, "TRAIN_SHAPES", shapes), \
            mock.patch.object(cs, "TRAIN_S", sum(h * w for h, w in shapes)), \
            mock.patch.object(cs, "TRAIN_DEC_LQ",
                              (NQ + cdn_layout(DN, PAD)[1], NQ)):
        cases = bench.collect_cases("training", device="cpu")
    names = [c[0] for c in cases]
    assert names == [f"training {p} {kind}" for kind in ("random", "model")
                     for p in ("encoder", "decoder_src", "decoder_tgt")]
    for name, value, got_shapes, loc, attn, g in cases:
        assert got_shapes == shapes, name
        assert value.shape[1] == sum(h * w for h, w in shapes), name
        assert loc.shape[:2] == attn.shape[:2] == g.shape[:2], name
        assert g.shape[-1] == value.shape[2] * value.shape[3], name
        assert torch.isfinite(loc).all() and torch.isfinite(value).all()
