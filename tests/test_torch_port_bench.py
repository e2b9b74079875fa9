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
    """Every training case (uniform-random, at the seeded model's own
    locations and at the encoder's moved from them) comes back with a
    gradient, at the canvas's level shapes."""
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
                     for p in ("encoder", "decoder_src", "decoder_tgt")] + [
        f"training encoder moved{px}px" for px in bench.MOVED_PX]
    model = cases[3]
    wh = torch.tensor([(w, h) for h, w in shapes], dtype=torch.float32)
    for px, case in zip(bench.MOVED_PX, cases[6:]):
        assert case[1] is model[1] and case[4] is model[4]  # value, attn
        # moved by px pixels of each level, in the spread of a normal draw
        moved = ((case[3] - model[3]) * wh[:, None, :] / px).std().item()
        assert 0.9 < moved < 1.1, (px, moved)
    for name, value, got_shapes, loc, attn, g in cases:
        assert got_shapes == shapes, name
        assert value.shape[1] == sum(h * w for h, w in shapes), name
        assert loc.shape[:2] == attn.shape[:2] == g.shape[:2], name
        assert g.shape[-1] == value.shape[2] * value.shape[3], name
        assert torch.isfinite(loc).all() and torch.isfinite(value).all()


def test_collect_f64_cases():
    """The f64 cases (serving shapes, f64 throughout, a gradient each): at
    uniform-random locations and at the f64 flagship's own, captured from
    the batch phase 15f runs, here a tiny f64 model on a small canvas."""
    from datr_torch.config import apply_overrides, load_config
    from datr_torch.models import build_model
    from datr_torch.models import dino as dino_mod

    canvas = (64, 96)
    shapes = tuple((-(-canvas[0] // s), -(-canvas[1] // s))
                   for s in (8, 16, 32, 64))
    opts = ["num_classes=4", "hidden_dim=64", "nheads=2", "enc_layers=1",
            "dec_layers=1", "dim_feedforward=64", f"num_queries={NQ}",
            "amp_dtype=float64"]

    def tiny_flagship(**overrides):
        assert overrides == {"amp_dtype": "float64"}
        cfg = apply_overrides(load_config(str(ROOT / cs.FLAGSHIP)), opts)
        return build_model(cfg, device="cpu", seed=0)[0]

    with mock.patch.object(cs, "flagship_model", tiny_flagship), \
            mock.patch.object(cs, "CANVAS", canvas), \
            mock.patch.object(cs, "SHAPES", shapes), \
            mock.patch.object(cs, "S", sum(h * w for h, w in shapes)), \
            mock.patch.object(cs, "N_QUERIES", NQ), \
            mock.patch.dict(dino_mod.RESNET_STAGES,
                            {"resnet50": (1, 1, 1, 1)}):
        cases = bench.collect_cases(None, device="cpu", dtypes=("f64",))
    assert [c[0] for c in cases] == [
        f"serving {p} {kind} f64" for kind in ("random", "model")
        for p in ("encoder", "decoder")] + [
        f"serving encoder moved{px}px f64" for px in bench.MOVED_PX]
    s_tok = sum(h * w for h, w in shapes)
    for (name, value, got_shapes, loc, attn, g), lq in zip(
            cases, (s_tok, NQ) * 2 + (s_tok,) * len(bench.MOVED_PX)):
        assert got_shapes == shapes, name
        assert value.shape[1] == s_tok and loc.shape[1] == lq, name
        assert all(t.dtype == torch.float64 for t in (value, loc, attn, g))
        assert g.shape == (value.shape[0], lq,
                           value.shape[2] * value.shape[3]), name
        assert torch.isfinite(loc).all() and torch.isfinite(value).all()
    model = cases[2]
    wh = torch.tensor([(w, h) for h, w in shapes], dtype=torch.float64)
    for px, case in zip(bench.MOVED_PX, cases[4:]):
        assert case[1] is model[1] and case[4] is model[4]  # value, attn
        moved = ((case[3] - model[3]) * wh[:, None, :] / px).std().item()
        assert 0.9 < moved < 1.1, (px, moved)
