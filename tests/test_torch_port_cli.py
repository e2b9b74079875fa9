"""The port's training CLI (`python -m datr_torch.main`) on the CPU at
tests/test_main_cli.py's tiny config, through `main(args)` in-process:
the flows of the verify recipe (burn-in; self-training relaunched from
best_ema_teacher; --eval), --test, auto-resume and the lr_drop reload; the
log.txt keys against the set datr_tpu/main.py:449-466 writes; the flags
whose parts are not ported; a synthetic run with PIL blocked, as on the
card's machine; and the learning-rate schedules against optax."""

import json
import logging
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch
import torch_port_threads  # torch threads under xdist

from datr_torch.main import get_args_parser, main
from datr_torch.models import dino as tdino
from datr_torch.train.optim import Optimizer

# tests/test_main_cli.py:17-47
TINY_CFG = """
_base_ = ["{base}"]
num_classes = 5
dn_labelbook_size = 5
hidden_dim = 32
nheads = 2
enc_layers = 1
dec_layers = 2
dim_feedforward = 64
num_queries = 16
dn_number = 4
dn_single_pad = 4
canvas_h = 96
canvas_w = 128
max_boxes = 8
batch_size = 2
epochs = 1
lr_drop = 40
synthetic_images = 4
use_remat = False
data_aug_scales = [72, 80]
data_aug_max_size = 120
data_aug_scales2_resize = [64, 72]
data_aug_scales2_crop = [48, 72]
num_select = 10
dataset_file = "city2foggy"
burn_epochs = 40
pseudo_label_threshold = 0.05
ema_decay_teacher = 0.9
ema_decay_best_model = 0.5
"""

# the keys of datr_tpu's log line (datr_tpu/main.py:449-457), besides the
# train_* means; ap50_ema with use_ema (:455), ap50_best_ema on
# self-training epochs (:458-464)
LOG_KEYS = {"epoch", "lr", "ap50_student", "ap50_teacher", "time"}
# one bottleneck block per ResNet stage in the CLI's runs (as
# tests/test_torch_port_utils.py's CLI run): the same CLI paths with a
# quarter of R50's blocks to draw, run and write to each checkpoint
STAGES = (1, 1, 1, 1)


def _cfg(tmp_path):
    p = tmp_path / "tiny_cfg.py"
    p.write_text(TINY_CFG.format(base=os.path.abspath(
        "configs/DINO/DINO_4scale.py")))
    return str(p)


def _run(cfg, out_dir, *extra, data="--synthetic"):
    args = get_args_parser().parse_args([
        "-c", cfg, "--output_dir", str(out_dir), "--debug", "--device", "cpu",
        "--num_workers", str(torch_port_threads.loader_threads(2)),
        *data.split(), *extra])
    return main(args)


def _write_single_domain(root):
    """<root>/single/{train,val}/{images/*.png, annotations.json}: 4 and 2
    random images with boxes of categories 1-3 and one crowd box each."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        d = root / "single" / split
        (d / "images").mkdir(parents=True)
        images, anns = [], []
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (60, 80, 3), np.uint8)).save(
                d / "images" / f"{i}.png")
            images.append({"id": i + 1, "file_name": f"{i}.png",
                           "height": 60, "width": 80})
            for j, crowd in ((0, 0), (1, 0), (2, 1)):
                anns.append({"id": len(anns), "image_id": i + 1,
                             "bbox": [5 + 20 * j, 10, 15, 25],
                             "iscrowd": crowd, "category_id": j + 1})
        (d / "annotations.json").write_text(json.dumps({
            "images": images, "annotations": anns,
            "categories": [{"id": c} for c in (1, 2, 3)]}))


def _log(out_dir):
    """The JSON lines of log.txt (the logger's own lines start with '[')."""
    return [json.loads(ln) for ln in (out_dir / "log.txt").read_text()
            .splitlines() if ln.startswith("{")]


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Burn-in for 2 epochs with lr_drop at 1 and use_ema; then the same
    output directory with epochs=3 (auto-resume); a self-training relaunch
    from the burn-in's best_ema_teacher with PIL blocked; --eval --ema
    --save_results from a best family; --test; single-domain training on a
    PNG COCO folder (the plain step, raw-GT evaluation)."""
    stages = pytest.MonkeyPatch()
    stages.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    tmp = tmp_path_factory.mktemp("cli")
    cfg = _cfg(tmp)
    # the messages of main's logger, kept here (with a handler of its own
    # the logger writes to no log.txt: setup_logger leaves it as it is)
    logger = logging.getLogger("datr_torch")
    msgs = _Messages()
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(msgs)
    try:
        burn = tmp / "burn"
        _run(cfg, burn, "--options", "epochs=2", "lr_drop=1", "use_ema=True",
             "save_checkpoint_interval=2")
        burn_log = _log(burn)
        burn_meta = json.loads((burn / "checkpoint.meta.json").read_text())
        _run(cfg, burn, "--options", "epochs=3", "lr_drop=1", "use_ema=True",
             "save_checkpoint_interval=0")
        resumed = msgs.lines[:]

        st = tmp / "st"
        mp = pytest.MonkeyPatch()
        mp.setitem(sys.modules, "PIL", None)
        try:
            _run(cfg, st, "--pretrain_model_path",
                 str(burn / "best_ema_teacher"), "--finetune_ignore",
                 "label_enc", "--options", "burn_epochs=0", "epochs=1",
                 "save_checkpoint_interval=0")
        finally:
            mp.undo()

        ev = tmp / "ev"
        stats = _run(cfg, ev, "--eval", "--ema", "--save_results",
                     "--resume", str(burn / "best_ema_teacher"))
        te = tmp / "te"
        _run(cfg, te, "--test")
        _write_single_domain(tmp)
        single = tmp / "single_run"
        _run(cfg, single, "--options", "save_checkpoint_interval=0",
             data=f"--data_root {tmp} --dataset_file single")
    finally:
        logger.removeHandler(msgs)
        logger.setLevel(level)
        stages.undo()
    return dict(burn=burn, burn_log=burn_log, burn_meta=burn_meta,
                log=_log(burn), messages=resumed, st=st, ev=ev, stats=stats,
                te=te, single=single)


def _train_keys(line):
    return {k for k in line if k.startswith("train_")}


def test_burn_in_log_lines_and_families(runs):
    """Two burn-in epochs: datr_tpu's keys (ap50_ema with use_ema, no
    ap50_best_ema), finite means of the weighted losses, the checkpoint,
    its per-interval copy and the three families of a burn-in with
    use_ema, `best` recorded in the checkpoint's meta."""
    log = runs["burn_log"]
    assert [ln["epoch"] for ln in log] == [0, 1]
    for ln in log:
        assert set(ln) - _train_keys(ln) == LOG_KEYS | {"ap50_ema"}
        assert {"train_loss", "train_grad_norm", "train_loss_ce",
                "train_loss_backbone_DA"} <= _train_keys(ln)
        assert all(np.isfinite(v) for v in ln.values())
    # lr_drop=1 epoch of 2 steps: 1e-4 before update 2, 1e-5 from it on
    assert log[0]["lr"] == pytest.approx(1e-5)
    d = runs["burn"]
    for name in ("checkpoint", "checkpoint0001", "checkpoint_best_regular",
                 "best_ema_teacher", "checkpoint_best_ema"):
        assert (d / name).exists() and (d / f"{name}.meta.json").exists()
    # save_checkpoint_interval=2: a copy after epoch 1 only
    assert not (d / "checkpoint0000").exists()
    assert not (d / "best_ema_model").exists()
    best = runs["burn_meta"]["best"]
    assert set(best) == {"checkpoint_best_regular", "best_ema_teacher",
                         "checkpoint_best_ema"}
    cfg = json.loads((d / "config_args_all.json").read_text())
    assert cfg["use_ema"] is True and cfg["synthetic"] is True


def test_lr_drop_reload_and_auto_resume(runs):
    """Epoch 1 (= lr_drop) restarts the student from best_ema_teacher; the
    second launch resumes after epoch 1 and runs epoch 2 only."""
    msgs = runs["messages"]
    assert sum("reloaded best_ema_teacher weights at lr_drop" in m
               for m in msgs) == 1
    assert [ln["epoch"] for ln in runs["log"]] == [0, 1, 2]
    assert json.loads((runs["burn"] / "checkpoint.meta.json").read_text()
                      )["epoch"] == 2


def test_self_training_relaunch_without_pil(runs):
    """The relaunch ran with `import PIL` failing: a self-training epoch
    with pseudo-labels, ap50_best_ema, the best_ema_model family."""
    log = _log(runs["st"])
    assert len(log) == 1
    ln = log[0]
    assert set(ln) - _train_keys(ln) == LOG_KEYS | {"ap50_best_ema"}
    assert {"train_num_pseudo", "train_loss_ce_target"} <= _train_keys(ln)
    assert all(np.isfinite(v) for v in ln.values())
    assert (runs["st"] / "best_ema_model").exists()


def test_eval_and_save_results(runs):
    stats = runs["stats"]
    assert len(stats["coco_eval_bbox"]) == 12 and "ap50" in stats
    res = np.load(runs["ev"] / "results.npz", allow_pickle=True)["results"]
    assert len(res) == 8  # the synthetic val set
    assert {"image_id", "boxes", "scores", "labels", "gt_boxes",
            "gt_labels"} <= set(res[0])
    assert not (runs["ev"] / "checkpoint").exists()


def test_test_dump(runs):
    recs = json.loads((runs["te"] / "results0.json").read_text())
    assert len(recs) == 8 * 10  # 8 images x num_select
    assert set(recs[0]) == {"image_id", "category_id", "bbox", "score"}
    assert all(len(r["bbox"]) == 4 for r in recs)


def test_single_domain_training(runs):
    """A train/ + val/ layout trains with the plain step (no DA losses, no
    pseudo-labels) and evaluates against the raw annotations."""
    log = _log(runs["single"])
    assert len(log) == 1
    ln = log[0]
    assert set(ln) - _train_keys(ln) == LOG_KEYS
    assert "train_loss_ce" in ln and not any(
        "_DA" in k or "target" in k for k in ln)
    assert all(np.isfinite(v) for v in ln.values())


def test_loader_error_reaches_the_caller(tmp_path, monkeypatch):
    """Training on a PNG folder with one corrupt file, PIL blocked: the
    port's PNG decoder refuses the file (a chunk fails its CRC), and that
    ValueError, raised in a loader thread, ends main (it does not leave the
    epoch waiting for a batch that never comes)."""
    _write_single_domain(tmp_path)
    bad = tmp_path / "single" / "train" / "images" / "1.png"
    raw = bytearray(bad.read_bytes())
    raw[-20] ^= 0xFF  # inside the last IDAT chunk: its CRC no longer holds
    bad.write_bytes(bytes(raw))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="CRC"):
        _run(_cfg(tmp_path), tmp_path / "out",
             data=f"--data_root {tmp_path} --dataset_file single")


@pytest.mark.parametrize("extra", [
    ["--options", "amp_dtype=fp32"],
    ["--options", "amp_dtype=float16"],
])
def test_unported_flags_raise(tmp_path, extra):
    """`--amp` and amp_dtype=bfloat16 run (tests/test_torch_port_bf16.py),
    float64 (datr_tpu's x64 debugging mode) too
    (tests/test_torch_port_x64.py); other dtype names do not (datr_tpu
    reads them as float32). use_tensorboard runs
    (tests/test_torch_port_utils.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run(_cfg(tmp_path), tmp_path / "out", *extra)
    assert not (tmp_path / "out").exists()


def test_masks_train_and_evaluate(tmp_path):
    """`--options masks=True mask_query_chunk=N` on a single-domain PNG
    tree whose annotations carry polygon and RLE segmentations: one epoch
    of the plain step with finite loss_mask / loss_dice, then the epoch's
    evaluations with mask AP (datr_tpu/main.py:196-205, 318-342). The mask
    head's GroupNorm(8) needs hidden_dim / 16 >= 8."""
    _write_single_domain(tmp_path)
    for split in ("train", "val"):
        p = tmp_path / "single" / split / "annotations.json"
        ann = json.loads(p.read_text())
        for a in ann["annotations"]:
            x, y, w, h = a["bbox"]
            a["segmentation"] = (
                [[x, y, x + w, y, x + w / 2, y + h]] if a["id"] % 2 else
                {"size": [60, 80], "counts": [int(y + 80 * 60 // 2), 9]})
        p.write_text(json.dumps(ann))
    out = tmp_path / "masks_run"
    # main's logger messages (its file is bound to the process's first
    # output_dir, another test's under xdist)
    logger = logging.getLogger("datr_torch")
    msgs, level = _Messages(), logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(msgs)
    try:
        _run(_cfg(tmp_path), out, "--options", "masks=True",
             "mask_query_chunk=12", "hidden_dim=128", "nheads=8",
             "save_checkpoint_interval=0",
             data=f"--data_root {tmp_path} --dataset_file single")
    finally:
        logger.removeHandler(msgs)
        logger.setLevel(level)
    (ln,) = _log(out)
    assert np.isfinite(ln["train_loss_mask"]) and np.isfinite(
        ln["train_loss_dice"])
    # the student's and the EMA teacher's evaluations, each with mask AP
    assert sum("COCO segm stats" in m for m in msgs.lines) == 2


# ---------------- the learning-rate schedules ----------------


@pytest.mark.parametrize("kind", ["multistep", "onecycle"])
def test_schedules_equal_optax(kind):
    """Every step of a 200-step range, both groups, rtol 1e-6 against
    optax's schedule evaluated in float64 (x64). Without x64 optax
    evaluates the cosine in float32, whose cancellation near the cycle's
    end puts its value up to 3.2e-5 off (measured at 200 steps)."""
    model = torch.nn.Linear(2, 2)
    if kind == "multistep":
        steps = [40, 90, 90, 150]
        opt = Optimizer(model, lr=2e-4, lr_backbone=2e-5,
                        schedule_type="multistep", lr_drop_steps=steps)
        make = lambda base: optax.piecewise_constant_schedule(  # noqa: E731
            base, {s: 0.1 for s in steps})
    else:
        opt = Optimizer(model, lr=2e-4, lr_backbone=2e-5,
                        schedule_type="onecycle", total_steps=170)
        make = lambda base: optax.cosine_onecycle_schedule(  # noqa: E731
            170, peak_value=base)
    for group, base in (("main", 2e-4), ("backbone", 2e-5)):
        with jax.enable_x64(True):
            sched = make(base)
            want = np.array([float(sched(i)) for i in range(200)])
        got = np.array([opt.lr_at(i, group) for i in range(200)])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
