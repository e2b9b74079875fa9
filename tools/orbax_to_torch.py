"""Read a datr_tpu orbax checkpoint and write it in datr_torch's format.

    python tools/orbax_to_torch.py --ckpt runs/c2f/checkpoint \
        -c configs/DA/Cityscapes2FoggyCityscapes/DINO_4scale_C2F.py \
        --out runs/c2f_torch/checkpoint [--options hidden_dim=...]

Runs where JAX and orbax are installed (the card's machine has neither):
the port reads only its own format. The checkpoint may be a whole
TrainState written by `datr_tpu/train/checkpoint.py:save_checkpoint`, one
written sharded from a device mesh by `save_checkpoint_sharded` (every leaf
is restored whole, as host numpy, whatever the mesh it was saved from), or
a best family's params tree (BestTracker). The tool builds the port's model
of the config on the CPU (`datr_torch.models.build_model`), carries the
tree over (`convert.load_flax_train_state`, or `load_flax_params` for a
family) and writes `datr_torch/train/checkpoint.save_checkpoint`'s file
with its `.meta.json` (the epoch and the extras of datr_tpu's meta).

The optimizer's moments are not carried: a resumed run starts AdamW's
moments afresh, at the checkpoint's step count. The tool says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

STATE_FIELDS = ("params", "opt_state", "ema_teacher", "best_ema",
                "model_ema", "global_proto", "amount", "ema_updates", "step")


def restore_numpy(path: str):
    """The checkpoint's tree as stored, every leaf host numpy (a sharded
    save is gathered from its shards on disk)."""
    import jax
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    meta = ckptr.metadata(path)
    tree = getattr(meta, "item_metadata", meta)
    tree = getattr(tree, "tree", tree)
    restore_args = jax.tree.map(
        lambda _: ocp.RestoreArgs(restore_type=np.ndarray), tree)
    return ckptr.restore(path, restore_args=restore_args)


def convert(ckpt: str, config: str, out: str, options=(), seed: int = 42
            ) -> dict:
    """Write `out` from the orbax checkpoint `ckpt` for the port's model of
    `config` (with `options` as the CLI's --options). Returns a summary."""
    from datr_torch.config import apply_overrides, load_config
    from datr_torch.convert import load_flax_params, load_flax_train_state
    from datr_torch.models import build_model
    from datr_torch.train.checkpoint import save_checkpoint
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state

    ckpt = os.path.abspath(ckpt)
    raw = restore_numpy(ckpt)
    meta = {}
    if os.path.exists(ckpt + ".meta.json"):
        with open(ckpt + ".meta.json") as f:
            meta = json.load(f)
    epoch = int(meta.pop("epoch", -1))
    cfg = apply_overrides(load_config(config), list(options))
    model, _, _ = build_model(cfg, "cpu", seed=seed)
    whole = isinstance(raw, dict) and {"params", "opt_state"} <= set(raw)
    if whole:
        state = create_train_state(model, Optimizer(model), seed=seed)
        load_flax_train_state(state, types.SimpleNamespace(
            **{k: raw[k] for k in STATE_FIELDS if k != "opt_state"}))
        save_checkpoint(out, state, epoch, extra=meta)
        left = []
    else:
        left = load_flax_params(model, raw)
        save_checkpoint(out, model, epoch, extra=meta)
    return {"from": ckpt, "to": os.path.abspath(out),
            "kind": "train_state" if whole else "params",
            "epoch": epoch, "meta": meta,
            "from_the_model_init": left,
            "optimizer_moments": "not carried (AdamW starts afresh)"
            if whole else "none in a params checkpoint"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True,
                    help="datr_tpu orbax checkpoint directory")
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--options", nargs="+", default=[])
    ap.add_argument("--out", required=True,
                    help="the port's checkpoint file to write")
    ap.add_argument("--seed", type=int, default=42,
                    help="seed of the model the tree is loaded into (only "
                         "the DA heads a params tree lacks keep its init)")
    args = ap.parse_args(argv)
    print(json.dumps(convert(args.ckpt, args.config_file, args.out,
                             args.options, args.seed)))


if __name__ == "__main__":
    main()
