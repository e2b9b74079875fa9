"""The FLOP count the cells keep equals FlopCounterMode's count plus the
MSDA formula on the frozen reference, at a tiny size."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.core import flops, spec
from perfbench.reference import model as ref
from perfbench.reference.train import is_frozen


def _tiny():
    c = spec.load_config("datr_c2f_r50")
    return c["tiny"]["model"], c["tiny"]["canvas"]


def _msda_calls(kw, canvas, n_src=1, n_tgt=0):
    """(B, Lq) of every MSDA call, read from the shapes: the encoder over
    the four levels' tokens, the decoder over the queries (and the source
    pass's CDN slots)."""
    H, W = canvas
    sizes, h, w = [], H, W
    for _ in range(6):
        h, w = -(-h // 2), -(-w // 2)
        sizes.append((h, w))
    S = sum(a * b for a, b in sizes[2:])
    nq, enc, dec = kw["num_queries"], kw["enc_layers"], kw["dec_layers"]
    pad = 2 * kw["dn_single_pad"] * max(1, kw["dn_number"]
                                        // kw["dn_single_pad"])
    if not n_tgt:
        return [(n_src, S)] * enc + [(n_src, nq)] * dec
    return ([(n_src, S)] * enc + [(n_src, pad + nq)] * dec
            + [(n_tgt, S)] * enc + [(n_tgt, nq)] * dec)


def _formula(kw, calls, factor):
    H, L, P = kw["nheads"], kw["num_feature_levels"], kw["enc_n_points"]
    D = kw["hidden_dim"] // H
    return sum(factor * 2 * B * Lq * H * L * P * 4 * D for B, Lq in calls)


def test_eval_count():
    kw, canvas = _tiny()
    with torch.device("meta"):
        m = ref.DINO(**kw).eval().requires_grad_(False)
        x = torch.zeros((1, *canvas, 3))
        pad = torch.zeros((1, *canvas), dtype=torch.bool)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        m(x, pad)
    want = counter.get_total_flops() + _formula(
        kw, _msda_calls(kw, canvas), 1)
    assert flops.eval_flops_per_image(kw, canvas) == want


def test_train_count():
    """Forward and backward of the DA burn-in forward: the counter's
    matmuls and convolutions, and MSDA's formula three times over (its
    backward is twice its forward)."""
    kw, canvas = _tiny()
    with torch.device("meta"):
        m = ref.DINO(**kw)
        for n, p in m.named_parameters():
            p.requires_grad_(not is_frozen(n))
        x = torch.zeros((2, *canvas, 3))
        pad = torch.zeros((2, *canvas), dtype=torch.bool)
        tg = {"boxes": torch.full((1, 4, 4), 0.25),
              "labels": torch.zeros((1, 4), dtype=torch.long),
              "valid": torch.ones((1, 4), dtype=torch.bool)}
        shape = (1, m.dn_groups, 2, m.dn_single_pad)
        draws = ref.CdnDraws(torch.zeros(shape),
                             torch.zeros(shape, dtype=torch.long),
                             torch.zeros((*shape, 4), dtype=torch.long),
                             torch.zeros((*shape, 4)))
        K, C = kw["num_classes"], kw["hidden_dim"]
        proto, amount = torch.zeros((K, C)), torch.zeros((K,))
    counter = FlopCounterMode(display=False)
    with counter:
        out = m.forward_train(x, pad, tg, proto, amount, draws)
        sum(v.float().sum() for v in out.values()
            if torch.is_tensor(v) and v.requires_grad).backward()
    want = counter.get_total_flops() + _formula(
        kw, _msda_calls(kw, canvas, 1, 1), 3)
    assert flops.train_flops_per_step(kw, canvas, 1, 1, 4) == want
