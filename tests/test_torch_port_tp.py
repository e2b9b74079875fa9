"""The port's tensor parallelism (datr_torch/parallel/mesh.py: the TP plan,
`apply_tp`; the TP layers of models/layers.py and models/transformer.py)
against datr_tpu on the CPU (the plan itself: test_torch_port_tp_plan.py).

- Two gloo ranks on a mesh of tp = 2 (tests/torch_port_dist_worker.py,
  spawned; no rank imports JAX) take a burn-in and a self-training step
  on the whole global batch, against datr_tpu's steps on it: losses and
  grad_norm (the clip's norm: each shard once, each whole tensor once),
  the whole gradients, the updated parameters against the port's
  one-process step, and the prototypes, `amount` and the matcher's
  assignments equal on both ranks. Each rank reduces its counts and sums
  over the data axis only (one rank): this is the step that shows the
  world-group reductions of data parallelism gone.
- `engine.evaluate` of the split model on both ranks against one
  process's, and InferenceServer(tp=2) against one device's.

The size is tests/test_torch_port_selftrain.py's (hidden 32, 4 heads, 1 + 2
layers, 12 queries, 64x96) with a ResNet of one block per stage; datr_tpu's
parameters are drawn with numpy over `jax.eval_shape`'s tree."""

import os
import sys

import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.data import loader as tloader
from datr_torch.data import transforms as ttf
from datr_torch.data.coco import build_dataset
from datr_torch.engine import evaluate as t_evaluate
from datr_torch.models import dino as tdino
from datr_torch.train.optim import param_group
from datr_torch.train.state import EMA_TRACKS
from datr_tpu.models import dino as jdino

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_dist_worker as worker  # noqa: E402
from test_torch_port_dist import (  # noqa: E402
    LR,
    LR_BACKBONE,
    STAGES,
    _grad_errors,
    _run as dist_run,
)
from test_torch_port_dist_eval import (  # noqa: E402
    CANVAS as EVAL_CANVAS,
    EVAL_MAX,
    KW as MASK_KW,
    MAX_BOXES,
    NUM_SELECT,
    _gt_from_own_detections,
    _write_masks_coco,
)

TP = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """datr_tpu's burn-in and self-training steps on the global batch and
    the ranks' tp = 2 steps (test_torch_port_dist.py's `_run` with these
    tasks), the port's one-process steps, and the evaluations."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    try:
        tmp = tmp_path_factory.mktemp("tp")
        model = tdino.DINO(**MASK_KW, with_masks=True, mask_query_chunk=10)
        model.init_params(torch.Generator().manual_seed(3))
        model.eval()
        root = tmp / "data"
        _write_masks_coco(root / "single", "val", 4, 8)
        _gt_from_own_detections(model, root)
        ev = dict(stages=STAGES, kw=dict(MASK_KW, with_masks=True,
                                         mask_query_chunk=10),
                  sd=model.state_dict(),
                  dataset=("coco", str(root), "single"), batch_size=1,
                  canvas=EVAL_CANVAS, eval_max=EVAL_MAX,
                  max_boxes=MAX_BOXES, num_select=NUM_SELECT, segm=True,
                  nms=-1.0, tp=TP)

        def one_process(common, *_):
            ds = build_dataset("val", "single", str(root))
            one_eval = t_evaluate(model, tloader.make_eval_loader(
                ds, 1, EVAL_CANVAS, ttf.EvalTransform(*EVAL_MAX), MAX_BOXES,
                num_threads=1), ds.category_ids(), NUM_SELECT, segm=True)
            return dict(eval=one_eval, steps=worker.steps(0, 1, **common))

        yield dist_run(tmp / "ranks", tasks=lambda common: [
            ("steps", dict(common, tp=TP)), ("evaluate", ev)],
            also=one_process)
    finally:
        mp.undo()


@pytest.mark.parametrize("name", ["burnin", "self_training"])
def test_tp_step_equals_datr_tpu_global_step(run, name):
    """Each rank's losses are datr_tpu's at rtol 1e-5 / atol 1e-6,
    grad_norm and the rank-mean logging counts at test_torch_port_dist.py's
    rtol 1e-4 / atol 1e-5, num_pseudo equal;
    the whole gradients the optimizer was given within the step tests'
    bounds; the ranks' metrics equal."""
    want = run["jax"][name]
    r0, r1 = (r[name] for r in run["steps"])
    assert r0["metrics"] == r1["metrics"]
    assert set(r0["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        tol = (dict(rtol=1e-5, atol=1e-6) if k.startswith("loss")
               else dict(rtol=1e-4, atol=1e-5))
        np.testing.assert_allclose(r0["metrics"][k], v, err_msg=k, **tol)
    if name == "self_training":
        assert 0 < r0["metrics"]["num_pseudo"] == int(
            want["metrics"]["num_pseudo"])
    worst = _grad_errors(r0["grads"], want["grads"])
    assert worst[1] <= 1.0, worst


@pytest.mark.parametrize("name", ["burnin", "self_training"])
def test_tp_ranks_agree_and_update_as_one_process(run, name):
    """After the step both ranks' whole parameters, EMA tracks,
    global_proto and amount are bitwise equal, and so are their matcher's
    assignments; the parameters are the one-process step's within 2 lr
    (Adam's first step maps a near-zero gradient of either sign to +-lr),
    the EMA tracks and global_proto within f32 rounding, amount equal and
    datr_tpu's."""
    a0, a1 = (r[name]["after"] for r in run["steps"])
    for part in ("model", *EMA_TRACKS):
        for k, v in a0[part].items():
            assert torch.equal(v, a1[part][k]), (part, k)
    assert torch.equal(a0["global_proto"], a1["global_proto"])
    assert torch.equal(a0["amount"], a1["amount"])
    m0, m1 = (r[name]["matches"] for r in run["steps"])
    assert len(m0) == len(m1) > 0
    for x, y in zip(m0, m1):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    one = run["one"]["steps"][name]["after"]
    for k, v in a0["model"].items():
        tol = {"main": 2 * LR, "backbone": 2 * LR_BACKBONE}.get(
            param_group(k), 0.0) + 1e-6
        assert (v - one["model"][k]).abs().max() <= tol, k
    for part in EMA_TRACKS:
        for k, v in a0[part].items():
            torch.testing.assert_close(v, one[part][k], rtol=0, atol=1e-5)
    torch.testing.assert_close(a0["global_proto"], one["global_proto"],
                               rtol=0, atol=1e-5)
    assert torch.equal(a0["amount"], one["amount"])
    np.testing.assert_array_equal(a0["amount"].numpy(),
                                  run["jax"][name]["state"].amount)


def test_tp_evaluate_equals_one_process(run):
    """engine.evaluate of the split model (masks on, batch 1) on both
    ranks: the bbox and segm stats equal on both and within 1e-6 of one
    process's, APs above 0 (the GT are the model's own detections)."""
    r0, r1 = run["evaluate"]
    one = run["one"]["eval"]
    for k in ("coco_eval_bbox", "coco_eval_masks"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_allclose(r0[k], one[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert one[k][1] > 0, (k, one[k])


def test_tp_serving_equals_one_device():
    """InferenceServer(tp=2) on two entries of the CPU, and two replicas
    of tp = 2, answer every request as one device does: boxes within
    1e-4 of the frame's size, scores within 1e-3 (chip_smoke.py phase 3's
    DETECT_TOL), in request order."""
    from datr_torch.serve import InferenceServer

    model = tdino.DINO(**MASK_KW).init_params(
        torch.Generator().manual_seed(4)).eval()
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (90, 120, 3), dtype=np.uint8)
            for _ in range(4)]
    answers = {}
    for name, kw in (("one", dict(device="cpu")),
                     ("tp", dict(devices=["cpu", "cpu"], tp=2)),
                     ("tp_x2", dict(devices=["cpu"] * 4, tp=2))):
        srv = InferenceServer(model, canvas_hw=(96, 128), batch_size=2,
                              resize_short=96, resize_max=128,
                              score_threshold=0.0, **kw)
        try:
            answers[name] = [f.result(timeout=300)
                             for f in [srv.submit(x) for x in imgs]]
        finally:
            srv.close()
    for name in ("tp", "tp_x2"):
        for got, want in zip(answers[name], answers["one"]):
            np.testing.assert_array_equal(got["labels"], want["labels"])
            np.testing.assert_allclose(got["scores"], want["scores"],
                                       rtol=0, atol=1e-3)
            np.testing.assert_allclose(got["boxes"], want["boxes"],
                                       rtol=0, atol=1e-4 * 120)
    with pytest.raises(ValueError, match="tp=2"):
        InferenceServer(model, devices=["cpu"] * 3, tp=2)
