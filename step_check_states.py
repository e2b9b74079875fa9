"""chip_smoke.py's bf16 step check over several training states, on one
card.

    python step_check_states.py [--burn-in N] [--self-training M]
                                [--out FILE]

Run from the repository root, beside chip_smoke.py, whose models, batches
and check (`check_step_against_plain` with `BF16_STEP_TOL`) it uses. The
bf16 C2F burn-in model (1216x2048, 2 + 2 images, as phase 8 seeds it)
takes N training steps through engine.train_one_epoch and after each one
checks the step on its first batch through the kernels against the plain
step; then the bf16 C2F self-training model takes M steps and checks the
step on its second batch, pseudo-labels made once, as phase 8 does. The
training steps launch the kernels, so each state is another draw of the
bf16 noise that the check's floor (the plain step with its MSDA points
summed in another order) and control (the model computing in f32) read.
Prints one line per check: the largest gradient error and its tensor
beside the floor's of that tensor, the limits raised by the floor, the
largest error over its limit, `kernel_over_floor`, the medians; writes
them all as JSON to --out (default build/step_check_states.json). Exits 1
when a check fails (after the rest have run) or there is no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

KEYS = ("max_loss_rel", "max_grad_rel", "median_grad_rel", "worst_grads",
        "kernel_over_floor", "limits_above_grad_tol", "max_grad_over_limit",
        "floor", "control")


def check(state, run, msda, kind, k) -> dict:
    try:
        res, ok = cs.check_step_against_plain(state, run, msda,
                                              **cs.BF16_STEP_TOL), True
    except AssertionError as e:
        res, ok = e.args[0], False
    r = dict(kind=kind, state=k, ok=ok, **{x: res.get(x) for x in KEYS})
    name, err, floor, _ = r["worst_grads"][0]
    print(f"{kind} state {k}: {'ok' if ok else 'FAILED'}; largest "
          f"{err:.4f} ({name}, floor {floor:.4f}); over limit "
          f"{r['max_grad_over_limit']:.4f}, limits raised "
          f"{r['limits_above_grad_tol']}, kernel_over_floor "
          f"{r['kernel_over_floor']:.4f}; floor / control largest "
          f"{r['floor']['max_grad_rel']:.4f} / "
          f"{r['control']['max_grad_rel']:.4f}; median "
          f"{r['median_grad_rel']:.4f} (floor "
          f"{r['floor']['median_grad_rel']:.4f}, control "
          f"{r['control']['median_grad_rel']:.4f})", flush=True)
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--burn-in", type=int, default=8)
    ap.add_argument("--self-training", type=int, default=5)
    ap.add_argument("--out", default="build/step_check_states.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_check_states: no CUDA device", file=sys.stderr)
        return 1
    from datr_torch import engine
    from datr_torch.ops import _build, msda
    from datr_torch.train.steps import (
        loss_and_grads,
        self_training_loss_and_grads,
        teacher_pseudo_labels,
    )

    print(cs.card_line(), flush=True)
    _build.build()
    _build.load_library()
    out = []
    n = args.burn_in
    if n:
        state, ccfg, wd, _ = cs.c2f_train_state(n, **cs.BF16)
        batches = cs.paired_batches(n, "cuda", seed=0)
        for k in range(n):
            engine.train_one_epoch(state, batches[k:k + 1], ccfg, wd)
            out.append(check(state, lambda d: loss_and_grads(
                state, batches[0], ccfg, wd, d)[:2], msda, "burn-in", k))
        del state, batches
        torch.cuda.empty_cache()
    n = args.self_training
    if n:
        state, ccfg, wd, _ = cs.c2f_train_state(max(n, 2), cs.C2F_ST,
                                                seed=1, **cs.BF16)
        batches = cs.paired_batches(max(n, 2), "cuda", seed=2, strong=True)
        thr = cs.pseudo_threshold(state, batches)
        thresholds = np.full((state.model.num_classes,), thr, np.float32)
        thr_t = torch.as_tensor(thresholds, device=state.amount.device)
        b = batches[1]
        for k in range(n):
            engine.train_one_epoch_self_training(
                state, batches[k:k + 1], ccfg, wd, thresholds,
                cs.TRAIN_CANVAS)
            pseudo = teacher_pseudo_labels(state, b, thr_t, cs.TRAIN_CANVAS)

            def run(draws):
                total, src, tgt, _ = self_training_loss_and_grads(
                    state, b, ccfg, wd, pseudo, draws)
                return total, {**src, **{f"{key}_target": v
                                         for key, v in tgt.items()}}

            out.append(check(state, run, msda, "self-training", k))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if all(r["ok"] for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
