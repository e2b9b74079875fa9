"""The useful FLOPs of a configuration's eval forward and training step,
counted on the benchmark's reference (never on the measured program, so a
change to what the program runs leaves the yardstick alone).

The arithmetic is that of the measured package's `tools/benchmark.py`
(`forward_flops`): `torch.utils.flop_counter.FlopCounterMode`'s count (2
per multiply-add of every matmul, convolution and attention product; no
elementwise work, norms or softmax) plus MSDA's multiply-adds by formula,
which the counter cannot see in a gather: 2 x B x Lq x H x L x P x 4
corners x D per call forward, twice that backward. The training step is the
DA burn-in forward and its backward over every output, without the
recomputation of `use_remat`. Counted on the meta device, so no memory or
time is spent: `python -m perfbench.core.flops <config>` prints the numbers
that the cell files keep.
"""

from __future__ import annotations

import json
import sys
from unittest import mock

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model as ref


def _count(fn, model) -> float:
    msda_flops = []
    call = ref.ms_deform_attn

    def counted(value, shapes, loc, attn):
        B, Lq, H, L, P, _ = loc.shape
        n = 2 * B * Lq * H * L * P * 4 * value.shape[-1]
        msda_flops.append(n * (3 if value.requires_grad or loc.requires_grad
                               else 1))
        return call(value, shapes, loc, attn)

    counter = FlopCounterMode(display=False)
    with mock.patch.object(ref, "ms_deform_attn", counted), counter:
        fn()
    return float(counter.get_total_flops() + sum(msda_flops))


def eval_flops_per_image(model_kw: dict, canvas, batch: int = 1) -> float:
    with torch.device("meta"):
        model = ref.DINO(**model_kw).eval()
        model.requires_grad_(False)
        H, W = canvas
        x = torch.zeros((batch, H, W, 3))
        m = torch.zeros((batch, H, W), dtype=torch.bool)
    with torch.no_grad():
        total = _count(lambda: model(x, m), model)
    return total / batch


def train_flops_per_step(model_kw: dict, canvas, n_src: int, n_tgt: int,
                         n_boxes: int) -> float:
    """Forward and backward of one DA burn-in forward over n_src source
    and n_tgt target images (n_boxes targets each), the frozen backbone
    stages taking no gradient."""
    from ..reference.train import is_frozen

    kw = dict(model_kw, use_remat=False)
    with torch.device("meta"):
        model = ref.DINO(**kw)
        for n, p in model.named_parameters():
            p.requires_grad_(not is_frozen(n))
        B = n_src + n_tgt
        H, W = canvas
        x = torch.zeros((B, H, W, 3))
        m = torch.zeros((B, H, W), dtype=torch.bool)
        tg = {"boxes": torch.full((n_src, n_boxes, 4), 0.25),
              "labels": torch.zeros((n_src, n_boxes), dtype=torch.long),
              "valid": torch.ones((n_src, n_boxes), dtype=torch.bool)}
        K, C = model.num_classes, model.hidden_dim
        shape = (n_src, model.dn_groups, 2, model.dn_single_pad)
        draws = ref.CdnDraws(torch.zeros(shape), torch.zeros(
            shape, dtype=torch.long), torch.zeros((*shape, 4),
                                                  dtype=torch.long),
            torch.zeros((*shape, 4)))

    def step():
        out = model.forward_train(x, m, tg, torch.zeros((K, C), device="meta"),
                                  torch.zeros((K,), device="meta"), draws)
        loss = sum(v.float().sum() for v in out.values()
                   if torch.is_tensor(v) and v.requires_grad)
        loss.backward()

    return _count(step, model)


def main(argv=None):
    from .spec import load_config

    name = (argv or sys.argv[1:])[0]
    cfg = load_config(name)
    kw, canvas = cfg["model"], cfg["canvas"]
    print(json.dumps({"config": name,
                      "eval_flops_per_image": eval_flops_per_image(kw, canvas),
                      "train_flops_per_step_2x2": train_flops_per_step(
                          kw, canvas, 2, 2, 20)}))


if __name__ == "__main__":
    main()
