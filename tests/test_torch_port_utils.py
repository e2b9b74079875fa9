"""The rest of the port's utils/ and its two tools on the CPU, against
datr_tpu where datr_tpu has the same function:
- tb: `main` with use_tensorboard=True writes `<output_dir>/tb`, whose
  event file holds each epoch's log.txt scalars (read back by
  tensorboard's own EventAccumulator); a disabled writer is a no-op;
- visualizer: draw_boxes / draw_masks / save_pseudo_label_debug
  pixel-equal to datr_tpu's (the same Pillow draws both);
- io: sl_load / sl_dump round trips (json, pickle, yaml) and the files
  equal to datr_tpu's; CocoClassMapper equal to datr_tpu's;
- plot_utils: read_log / extract_fields equal to datr_tpu's on a log.txt
  with the logger's lines in it; plot_logs saves a figure;
- profiling: TimeHolder, device_trace's trace file, measure_throughput's
  two-point difference;
- tools: `python -m datr_torch.tools.benchmark` and `.loader_bench` with
  `--device cpu` at a tiny size (their numbers are the CPU's); the
  benchmark's parameter count equals the size of datr_tpu's eval-init
  tree of the same config.
The models take a ResNet of one bottleneck block per stage (RESNET_STAGES
patched on both sides)."""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from PIL import Image

from datr_torch.models import dino as tdino
from datr_torch.tools import benchmark as tbench
from datr_torch.tools import loader_bench as tloader
from datr_torch.utils import io as tio
from datr_torch.utils import plot_utils as tplot
from datr_torch.utils import profiling as tprof
from datr_torch.utils import tb as ttb
from datr_torch.utils import visualizer as tvis
from datr_tpu import config as jconfig
from datr_tpu.models import build_model as jbuild_model
from datr_tpu.models import dino as jdino
from datr_tpu.utils import io as jio
from datr_tpu.utils import plot_utils as jplot
from datr_tpu.utils import visualizer as jvis

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_cli import _cfg, _log, _run  # noqa: E402

STAGES = (1, 1, 1, 1)


@pytest.fixture
def small_backbone(monkeypatch):
    monkeypatch.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    monkeypatch.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)


# ---------------- tb ----------------


def _event_scalars(tb_dir):
    """{tag: [(step, value)]} of the event files under `tb_dir`."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(str(tb_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_cli_writes_the_log_scalars_to_tensorboard(tmp_path,
                                                   small_backbone):
    out = tmp_path / "run"
    _run(_cfg(tmp_path), out, "--options", "epochs=2",
         "use_tensorboard=True")
    lines = _log(out)
    assert len(lines) == 2
    events = sorted((out / "tb").glob("events.out.tfevents.*"))
    assert len(events) == 1
    got = _event_scalars(out / "tb")
    want = {}
    for ln in lines:
        for k, v in ln.items():
            want.setdefault(k, []).append((ln["epoch"], np.float32(v)))
    assert set(got) == set(want) and "train_loss" in got
    for k in want:
        assert [(s, np.float32(v)) for s, v in got[k]] == want[k], k
    # the plot utils read the same log.txt (with the logger's lines) as
    # datr_tpu's do
    rows = tplot.read_log(str(out))
    assert rows == jplot.read_log(str(out)) == lines
    fields = ["train_loss", "ap50_student", "lr"]
    for alpha in (0.0, 0.6):
        assert (tplot.extract_fields(rows, fields, alpha)
                == jplot.extract_fields(rows, fields, alpha))
    fig, _ = tplot.plot_logs([out], fields, out_path=str(tmp_path / "p.png"))
    assert (tmp_path / "p.png").stat().st_size > 0
    import matplotlib.pyplot as plt

    plt.close(fig)


def test_disabled_writer_is_a_no_op(tmp_path):
    w = ttb.ScalarWriter(str(tmp_path / "tb"), enabled=False)
    assert not w.active
    w.write(0, {"loss": 1.0})
    w.close()
    assert not (tmp_path / "tb").exists()
    assert not ttb.ScalarWriter(None).active


# ---------------- visualizer ----------------


def _picture(seed=0, hw=(60, 90)):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8), "RGB")


def test_draw_boxes_and_masks_equal_datr_tpu():
    img = _picture()
    boxes = np.array([[5, 6, 40, 50], [30.5, 10.2, 85, 58], [0, 0, 3, 3]],
                     np.float32)
    labels = np.array([0, 13, 2])
    scores = np.array([0.9, 0.25, 0.5], np.float32)
    for kw in ({}, dict(labels=labels), dict(labels=labels, scores=scores),
               dict(labels=labels, class_names=["car", "bus", "person"]),
               dict(scores=scores, width=3)):
        a = tvis.draw_boxes(img, boxes, **kw)
        b = jvis.draw_boxes(img, boxes, **kw)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(kw))
    masks = np.random.default_rng(1).random((3, 60, 90)) > 0.6
    for lab in (None, labels):
        np.testing.assert_array_equal(
            np.asarray(tvis.draw_masks(img, masks, lab)),
            np.asarray(jvis.draw_masks(img, masks, lab)))
    with pytest.raises(ValueError, match="shape"):
        tvis.draw_masks(img, masks[:, :50])


@pytest.mark.parametrize("with_gt", [False, True])
def test_save_pseudo_label_debug_equals_datr_tpu(tmp_path, with_gt):
    rng = np.random.default_rng(2)
    image = rng.standard_normal((64, 96, 3)).astype(np.float32)
    pseudo = {"boxes": rng.random((5, 4)).astype(np.float32) * 0.5 + 0.2,
              "labels": rng.integers(0, 8, 5),
              "valid": np.array([1, 1, 0, 1, 0], bool)}
    gt = {"boxes": rng.random((3, 4)).astype(np.float32) * 0.5 + 0.2,
          "labels": rng.integers(0, 8, 3), "valid": np.ones(3, bool)}
    args = (image, pseudo, gt if with_gt else None, (60, 90))
    a = tvis.save_pseudo_label_debug(*args, str(tmp_path / "t" / "a.png"))
    b = jvis.save_pseudo_label_debug(*args, str(tmp_path / "j" / "b.png"))
    assert a.size == b.size == ((96 * 2 + 8) if with_gt else 96, 64)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "t" / "a.png")),
        np.asarray(Image.open(tmp_path / "j" / "b.png")))


# ---------------- io ----------------


@pytest.mark.parametrize("ext", ["json", "pkl", "pickle", "yaml", "yml"])
def test_sl_load_dump_round_trip(tmp_path, ext):
    obj = {"a": [1, 2.5, "x"], "b": {"c": None, "d": True}}
    tio.sl_dump(obj, str(tmp_path / f"t.{ext}"))
    jio.sl_dump(obj, str(tmp_path / f"j.{ext}"))
    assert tio.sl_load(str(tmp_path / f"t.{ext}")) == obj
    assert jio.sl_load(str(tmp_path / f"t.{ext}")) == obj
    assert ((tmp_path / f"t.{ext}").read_bytes()
            == (tmp_path / f"j.{ext}").read_bytes())


def test_sl_refuses_unknown_extensions(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        tio.sl_dump({}, str(tmp_path / "x.txt"))
    with pytest.raises(ValueError, match="unsupported"):
        tio.sl_load(str(tmp_path / "x.csv"))


def test_coco_class_mapper_equals_datr_tpu():
    t, j = tio.CocoClassMapper(), jio.CocoClassMapper()
    assert t.origin2compact_mapper == j.origin2compact_mapper
    assert t.compact2origin_mapper == j.compact2origin_mapper
    assert len(t.origin2compact_mapper) == 80
    assert all(t.compact2origin(t.origin2compact(o)) == o
               for o in t.origin2compact_mapper)


# ---------------- profiling ----------------


def test_time_holder_and_device_trace(tmp_path):
    th = tprof.TimeHolder()
    for _ in range(3):
        with th.span("a"):
            time.sleep(0.002)
    with th.span("b"):
        pass
    s = th.summary()
    assert set(s) == {"a", "b"} and th.counts["a"] == 3
    assert 0.002 <= s["a"] < 1.0
    with tprof.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def test_measure_throughput_differences_two_runs():
    """The two-point difference on the host clock: a call that sleeps
    5 ms reads about 5 ms, whatever one run pays once."""
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.005)
        return x + 1

    dt = tprof.measure_throughput(fn, (torch.zeros(3),), batch=1, n1=2,
                                  n2=6)
    assert 0.004 <= dt < 0.05
    assert len(calls) == 2 + 6 + 2  # each run after one untimed call


# ---------------- tools ----------------


def test_benchmark_tool_on_the_cpu(tmp_path, small_backbone, capsys):
    """One JSON line with datr_tpu's keys; the parameter count equals the
    size of datr_tpu's eval-init tree (frozen-BN statistics included, the
    DA heads not: an eval init creates none)."""
    cfg_path = _cfg(tmp_path)
    out = tmp_path / "flops" / "log.txt"
    r = tbench.main(["-c", cfg_path, "--hw", "64", "96", "--n1", "1",
                     "--n2", "3", "--device", "cpu", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == r == json.loads(out.read_text())
    assert set(r) == {"nparam_M", "gflops_per_image", "latency_ms", "fps",
                      "tflops_per_s", "mfu_pct", "batch", "hw", "device"}
    assert r["device"] == "cpu" and r["hw"] == [64, 96] and r["batch"] == 1
    assert r["gflops_per_image"] > 0 and r["fps"] > 0

    jm, _, _ = jbuild_model(jconfig.load_config(cfg_path))
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 64, 96, 3)), jnp.zeros((1, 64, 96), bool),
        train=False), jax.random.PRNGKey(1))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    from datr_torch.config import load_config
    from datr_torch.models import build_model

    model, _, _ = build_model(load_config(cfg_path), device="cpu")
    assert tbench.eval_parameters(model) == n_jax
    assert r["nparam_M"] == round(n_jax / 1e6, 2)


def test_benchmark_counts_msda_by_formula(small_backbone, tmp_path):
    """FlopCounterMode's count plus 2 x B x Lq x H x L x P x 4 x D per MSDA
    call: the tiny model has 1 encoder call (Lq = S tokens) and 2 decoder
    calls (Lq = 16 queries)."""
    from torch.utils.flop_counter import FlopCounterMode

    from datr_torch.config import load_config
    from datr_torch.models import build_model

    model, _, _ = build_model(load_config(_cfg(tmp_path)), device="cpu")
    images = torch.zeros((1, 64, 96, 3))
    pad = torch.zeros((1, 64, 96), dtype=torch.bool)
    counter = FlopCounterMode(display=False)
    model.requires_grad_(False)
    with counter, torch.inference_mode():
        model(images, pad)
    S = sum(h * w for h, w in ((8, 12), (4, 6), (2, 3), (1, 2)))
    msda = 2 * 1 * (S + 2 * 16) * 2 * 4 * 4 * 4 * (32 // 2)
    assert tbench.forward_flops(model, images, pad) == (
        counter.get_total_flops() + msda)


def test_loader_bench_on_the_cpu():
    rows = tloader.main(["--images", "2", "--batch", "1", "--threads", "2",
                         "--hw", "96", "160", "--device", "cpu"])
    assert [r["mode"] for r in rows] == ["da_train_strong", "da_train_weak",
                                         "eval"]
    for r in rows:
        assert r["img_per_s"] > 0 and r["ms_per_batch"] > 0
        assert r["device"] == "cpu" and r["threads"] == 2
        assert r["format"] in ("jpg", "png")
