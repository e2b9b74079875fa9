"""A training cell: set-up builds one training state, drives it from the
seed through its first steps through the window's own call and feed (the
checked steps), then the window times the same call over the cycled
batches; after the window the reference follows the checked steps.

What is compared (each with its limit in the cell file):
  loss_gap    the first step's |loss - reference loss| / |reference loss|
              (the later steps' gap is printed beside it: see `gaps`);
  grad_gap    the first step's gradient as the optimizer got it (Adam's
              first moment after one step, over 1 - b1), leaf by leaf:
              | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|);
  change_gap  each leaf's change over the checked steps, the same gap of
              norms; leaves whose reference gradient is under a thousandth
              of the median leaf's move by round-off alone and are left out;
  select_gap  how far the program's two-stage top-k at the first step
              (which the reference follows, since f32 rounding reorders
              near-tied proposals) lies from the reference's own ranking,
              in logits, rank by rank and as a set (reference/model.py).
"""

from __future__ import annotations

import gc
import itertools
import time
from typing import Dict, List

import torch

from ..core import program
from ..core.traffic import train_batches
from ..core.weights import make_state_dict
from ..reference import model as ref
from ..reference import train as rtrain

B1 = 0.9  # AdamW's first-moment decay, the program's and the reference's


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tf32_flags(on: bool):
    """The process's TF32 switches as the configuration states them (the
    measured package's training entry leaves cuDNN's at PyTorch's default,
    on; its tools and server turn both off for an f32 model)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _leaf_gaps(prog: Dict[str, float], refn: Dict[str, float],
               names: List[str]) -> float:
    med = sorted(refn[n] for n in names)[len(names) // 2]
    return max(abs(prog[n] - refn[n]) / max(refn[n], med, 1e-30)
               for n in names)


def reference_steps(config: dict, state_dict, batches, seed: int, device,
                    selects, tf32: bool = False, use_remat: bool = True):
    """The reference's own run of the checked steps: (losses, first
    gradient's leaf norms, leaf norms of the change, select gap,
    selections). `selects[i]` is the choice to follow at step i (None: its
    own)."""
    m = config["model"]
    model = ref.DINO(**dict(m, use_remat=use_remat)).to(device)
    model.load_state_dict(state_dict)
    for n, p in model.named_parameters():
        p.requires_grad_(not rtrain.is_frozen(n))
    o = config["optim"]
    opt = rtrain.AdamW(model.named_parameters(), o["lr"], o["lr_backbone"],
                       o["weight_decay"], o["clip_max_norm"])
    weights = rtrain.weight_dict(config["loss"], m["dec_layers"])
    lcfg = dict(config["loss"], dn_single_pad=model.dn_single_pad,
                dn_groups=model.dn_groups)
    gen = torch.Generator().manual_seed(int(seed))
    K, C = m["num_classes"], m["hidden_dim"]
    proto, amount = torch.zeros(K, C, device=device), torch.zeros(K, device=device)
    half = batches[0]["images"].shape[0] // 2
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    losses, g1, sel_gaps, chosen = [], None, [], []
    try:
        for i, b in enumerate(batches):
            draws = ref.draw_cdn(gen, half, model.dn_groups,
                                 model.dn_single_pad, K, device)
            for p in model.parameters():
                p.grad = None
            out = model.forward_train(
                b["images"], b["pad_mask"],
                {k: b[k] for k in ("boxes", "labels", "valid")}, proto,
                amount, draws, selects[i])
            chosen.append(out["chosen"])
            total = rtrain.total_loss(rtrain.burnin_losses(
                out, b["labels"], b["boxes"], b["valid"], lcfg), weights)
            total.backward()
            grads = opt.clipped_grads()
            if i == 0:
                g1 = {n: float(g.norm()) for n, g in grads.items()}
            opt.step(grads)
            proto = out["new_global_proto"].detach()
            amount = out["new_amount"].detach()
            losses.append(float(total.detach()))
            sel_gaps.append(float(out["select_gap"]))
            del out, total, grads
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    params = dict(model.named_parameters())
    change = {n: float((params[n].detach() - state_dict[n]).norm())
              for n in g1}
    return losses, g1, change, sel_gaps, chosen


def gaps(prog_losses, prog_g1, prog_change, ref_losses, ref_g1, ref_change,
         sel_gaps) -> Dict[str, float]:
    """The compared numbers (the first step's loss and choice, the first
    gradient, the change over the checked steps) and, beside them, the
    later steps' loss and choice gaps, which Adam's first update makes
    noisy: it moves every element by about the learning rate whatever its
    gradient's size, so elements whose gradient is round-off take either
    sign, and the two runs part by that much from step 2 on."""
    names = sorted(ref_g1)
    med = sorted(ref_g1[n] for n in names)[len(names) // 2]
    moved = [n for n in names if ref_g1[n] >= 1e-3 * med]
    loss = [abs(a - b) / abs(b) for a, b in zip(prog_losses, ref_losses)]
    return {
        "loss_gap": loss[0],
        "grad_gap": _leaf_gaps(prog_g1, ref_g1, names),
        "change_gap": _leaf_gaps(prog_change, ref_change, moved),
        "select_gap": sel_gaps[0],
        "loss_gap_later_steps": max(loss[1:], default=0.0),
        "select_gap_later_steps": max(sel_gaps[1:], default=0.0),
    }


def run(spec: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: str = None, tiny: bool = False) -> Dict:
    from ..core.trace import Tracer

    cell, config, mix = spec["cell"], spec["config"], spec["traffic"]
    options = None
    if tiny:
        options = program.tiny_options(config)
        config = dict(config, **config["tiny"])
        mix = dict(mix, **mix["tiny"])
    m = config["model"]
    tf32_flags(config["tf32"])
    sd_model = ref.DINO(**m)  # shapes only: weights come from the seed
    state_dict = make_state_dict(sd_model.to(device), seed, device)
    del sd_model
    model, ccfg, wd, pcfg = program.build_model(
        config, state_dict, device, options)
    del state_dict
    state = program.train_state(model, pcfg, seed, cell["steps_per_epoch"])
    batches = train_batches(mix, m["num_classes"], config["canvas"], seed,
                            device)
    n_check = cell["check_steps"]
    per_step = mix["source_images"] + mix["target_images"]

    # -- the checked steps, through the window's own call and feed
    chosen = []
    hook = model.register_forward_hook(lambda mod, a, out: chosen.append(
        (out["topk_idx"].detach().clone(),
         out["topk_idx_target"].detach().clone())))
    names = state.optimizer.names
    p0 = {n: p.detach().clone() for n, p in zip(names,
                                                 state.optimizer.params)}
    if fault == "state_unchanged":
        state.optimizer.opt.step = lambda *a, **k: None
    prog_losses, prog_g1 = [], None
    for i in range(n_check):
        b = batches[i]
        if fault == "half_batch":  # half of each domain left out
            ns = b["boxes"].shape[0]
            keep = list(range(ns // 2)) + list(range(ns, ns + ns // 2))
            b = {"images": b["images"][keep], "pad_mask": b["pad_mask"][keep],
                 **{k: b[k][:ns // 2] for k in ("boxes", "labels", "valid")}}
        metrics = program.train_one_epoch(state, [b], ccfg, wd)
        prog_losses.append(float(metrics["loss"]))
        if i == 0:
            st = state.optimizer.opt.state
            prog_g1 = {n: float(st[p]["exp_avg"].norm()) / (1 - B1)
                       if p in st else 0.0
                       for n, p in zip(names, state.optimizer.params)}
    hook.remove()
    prog_change = {n: float((p.detach() - p0[n]).norm())
                   for n, p in zip(names, state.optimizer.params)}
    del p0
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # -- the window; a traced run traces its last stretches (trace.py)
    tr = cell.get("trace", {})
    tracer = (Tracer(device, tr.get("seconds", 5.0),
                     tr.get("detail_seconds", 2.0), all_threads=True)
              if trace else None)
    order = itertools.cycle(list(range(n_check, len(batches)))
                            + list(range(n_check)))
    steps = [0]
    traced = [0, 0]  # the device stretch's first step and its step count
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def feed():
        while True:
            now = time.perf_counter()
            if now >= deadline:
                return
            if tracer is not None:
                left = deadline - now
                if (tracer.main.prof is None
                        and left <= tracer.seconds + tracer.detail_seconds):
                    tracer.main.start()
                    traced[0] = steps[0]
                elif tracer.main.running and left <= tracer.detail_seconds:
                    tracer.main.stop()
                    traced[1] = steps[0] - traced[0]
                    tracer.detail.start()
            steps[0] += 1
            yield batches[next(order)]

    program.train_one_epoch(state, feed(), ccfg, wd)
    _sync(device)
    window_s = time.perf_counter() - t0
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    records = None
    if tracer is not None and tracer.main.prof is not None:
        if tracer.main.running:
            tracer.main.stop()
            traced[1] = steps[0] - traced[0]
        tracer.detail.stop()
        records = tracer.records()
        records.update(steps=traced[1],
                       flops=cell["flops_per_step"] * traced[1],
                       dtype=config["dtype"])
        del tracer
    img_s = per_step * steps[0] / window_s

    # -- free the program, then the reference follows the checked steps
    del state, model, hook
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    state_dict = make_state_dict(ref.DINO(**m).to(device), seed, device)
    n_src = batches[0]["boxes"].shape[0]
    follow = [c if c[0].shape[0] == n_src else (None, None) for c in chosen]
    ref_losses, ref_g1, ref_change, sel_gaps, _ = reference_steps(
        config, state_dict, batches[:n_check], seed, device, follow)
    checks = gaps(prog_losses, prog_g1, prog_change, ref_losses, ref_g1,
                  ref_change, sel_gaps)
    return {"attempted": steps[0], "failed": 0, "setup_s": setup_s,
            "window_s": window_s, "mem_peak": mem_peak,
            "end_to_end": {"train_img_s": img_s}, "records": records,
            "checks": checks,
            "detail": {"losses": prog_losses, "ref_losses": ref_losses}}


def control(spec, seed, device):
    """The TF32 control's readings: the reference in TF32 in the program's
    place over the checked steps, judged by the f32 reference as the
    program is (following the control's own choices)."""
    config, mix, cell = spec["config"], spec["traffic"], spec["cell"]
    m = config["model"]
    sd = make_state_dict(ref.DINO(**m).to(device), seed, device)
    batches = train_batches(mix, m["num_classes"], config["canvas"], seed,
                            device)[:cell["check_steps"]]
    n = len(batches)
    c_losses, c_g1, c_change, _, chosen = reference_steps(
        config, sd, batches, seed, device, [(None, None)] * n, tf32=True)
    r_losses, r_g1, r_change, sel, _ = reference_steps(
        config, sd, batches, seed, device, chosen)
    return gaps(c_losses, c_g1, c_change, r_losses, r_g1, r_change, sel)
