"""The port's encoder sequence parallelism (datr_torch/models/dino.py
`sp_axis`, datr_tpu/models/dino.py:359-367, 409-429) against datr_tpu on
the CPU: three gloo ranks (tests/torch_port_dist_worker.py, spawned; no
rank imports JAX) on a mesh of sp = 3, so the shards of the token axis are
uneven (128 tokens at 64x96: 43 / 43 / 42; 151 at 72x96: 51 / 51 / 49).

- The eval forward at 72x96 against datr_tpu's unsharded forward, at
  tests/test_parallel.py:234-263's atol 2e-5 / rtol 2e-4.
- The burn-in step on the whole global batch against datr_tpu's step:
  losses, grad_norm and the gradients (the encoder layers' summed over
  'seq', the rest whole on every rank), the ranks' updated state equal.

The size is tests/test_torch_port_selftrain.py's, as in
tests/test_torch_port_dist.py."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.models import dino as tdino
from datr_torch.train.state import EMA_TRACKS
from datr_tpu.models import dino as jdino

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_backbones import FAST_COMPILE  # noqa: E402
from test_torch_port_dist import (  # noqa: E402
    RANK_MEANS,
    STAGES,
    _grad_errors,
    _run as dist_run,
)

SP = 3
FWD_HW = (72, 96)  # 9x12 + 5x6 + 3x3 + 2x2 = 151 tokens


def _fwd_batch():
    rng = np.random.default_rng(7)
    images = rng.standard_normal((2, *FWD_HW, 3)).astype(np.float32)
    pad = np.zeros((2, *FWD_HW), bool)
    pad[:, :, 80:] = True  # masked positions too
    pad[1, 64:] = True
    images[pad] = 0.0
    return images, pad


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    images, pad = _fwd_batch()
    try:
        def tasks(common):
            return [("steps", dict(common, st_draws=None, sp=SP)),
                    ("sp_forward", dict(
                        stages=STAGES, kw=common["kw"], sd=common["sd"],
                        images=torch.from_numpy(images),
                        pad_mask=torch.from_numpy(pad)))]

        def forward(common, jm, params):
            out = jax.jit(lambda p: jm.apply(
                p, jnp.asarray(images), jnp.asarray(pad), train=False),
                compiler_options=FAST_COMPILE)(params)
            return {k: np.asarray(out[k]) for k in
                    ("pred_logits", "pred_boxes", "interm_logits")}

        yield dist_run(tmp_path_factory.mktemp("sp"), tasks=tasks,
                       world=SP, also=forward, self_training=False)
    finally:
        mp.undo()


def test_sp_forward_matches_unsharded_datr_tpu(run):
    """Every rank's eval outputs on uneven shards equal datr_tpu's
    unsharded forward at atol 2e-5 / rtol 2e-4, and each other's
    bitwise."""
    want = run["one"]
    r0 = run["sp_forward"][0]
    for r in run["sp_forward"]:
        for k, v in want.items():
            np.testing.assert_allclose(r[k].numpy(), v, atol=2e-5,
                                       rtol=2e-4, err_msg=k)
            assert torch.equal(r[k], r0[k]), k


def test_sp_step_equals_datr_tpu_global_step(run):
    """The burn-in step with sp = 3: losses at rtol 1e-5 / atol 1e-6,
    grad_norm at rtol 1e-4 / atol 1e-5 (the rank-mean logging counts
    left out: every rank holds the whole batch), the gradients within the
    step tests' bounds, and every rank's metrics and state after the step
    bitwise equal."""
    want = run["jax"]["burnin"]
    ranks = [r["burnin"] for r in run["steps"]]
    r0 = ranks[0]
    for k, v in want["metrics"].items():
        if k.startswith(RANK_MEANS):
            continue
        tol = (dict(rtol=1e-5, atol=1e-6) if k.startswith("loss")
               else dict(rtol=1e-4, atol=1e-5))
        np.testing.assert_allclose(r0["metrics"][k], v, err_msg=k, **tol)
    worst = _grad_errors(r0["grads"], want["grads"])
    assert worst[1] <= 1.0, worst
    for r in ranks[1:]:
        assert r["metrics"] == r0["metrics"]
        for part in ("model", *EMA_TRACKS):
            for k, v in r0["after"][part].items():
                assert torch.equal(v, r["after"][part][k]), (part, k)
        assert torch.equal(r0["after"]["global_proto"],
                           r["after"]["global_proto"])
