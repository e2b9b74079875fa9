"""datr_tpu's orbax checkpoints reach the port through
tools/orbax_to_torch.py: a whole TrainState saved by datr_tpu's
`save_checkpoint`, the same saved sharded from a 2-device mesh by
`save_checkpoint_sharded` (`parallel/mesh.py:shard_train_state(fsdp=True)`),
and a best family's params tree. The tool writes the port's format; the
port's `load_checkpoint` / `load_pretrain_params` read it, and the port's
eval forward of the student and of the EMA teacher then matches datr_tpu's
of the same trees (logits atol 2e-3, boxes 1e-4: datr_tpu's own parity
tolerances, tests/test_torch_parity.py); the prototype state and the
counters are carried.

The config is tests/test_main_cli.py's tiny one with a ResNet of one
bottleneck block per stage (RESNET_STAGES patched on both sides); the
parameters are seeded numpy draws over `jax.eval_shape`'s tree, the EMA
teacher's other draws than the student's."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.config import load_config as t_load_config
from datr_torch.models import build_model as t_build_model
from datr_torch.models import dino as tdino
from datr_torch.train.checkpoint import load_checkpoint, load_pretrain_params
from datr_torch.train.optim import Optimizer
from datr_torch.train.state import create_train_state as t_train_state
from datr_tpu.config import load_config as j_load_config
from datr_tpu.models import dino as jdino
from datr_tpu.models.registry import build_model as j_build_model
from datr_tpu.parallel.mesh import make_mesh, shard_train_state
from datr_tpu.train import checkpoint as jckpt
from datr_tpu.train.optim import make_optimizer
from datr_tpu.train.state import create_train_state as j_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import orbax_to_torch  # noqa: E402
from test_main_cli import _write_cfg  # noqa: E402
from test_torch_port_backbones import (  # noqa: E402
    FAST_COMPILE,
    train_tree_shapes,
)
from test_torch_port_bf16 import seeded_params  # noqa: E402

STAGES = (1, 1, 1, 1)
HW = (96, 128)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """datr_tpu's tiny TrainState saved three ways, its eval forward of the
    student and the EMA teacher on one padded image pair, and the config."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    try:
        yield _save(tmp_path_factory.mktemp("orbax"))
    finally:
        mp.undo()


def _save(tmp):
    cfg_path = _write_cfg(tmp)
    cfg = j_load_config(cfg_path)
    jm = j_build_model(cfg)[0]
    shapes = train_tree_shapes(jm, HW)  # DN and DA heads included
    params = {"params": seeded_params(shapes, seed=3)}
    teacher = {"params": seeded_params(shapes, seed=4)}
    rng = np.random.default_rng(5)
    st = j_train_state(params, make_optimizer(params, lr=1e-4,
                                              lr_backbone=1e-5),
                       cfg.num_classes, cfg.hidden_dim,
                       jax.random.PRNGKey(0))
    st = st.replace(
        ema_teacher=teacher,
        global_proto=jnp.asarray(rng.standard_normal(
            (cfg.num_classes, cfg.hidden_dim)).astype(np.float32)),
        amount=jnp.asarray(np.arange(cfg.num_classes, dtype=np.float32)),
        step=jnp.int32(7), ema_updates=jnp.int32(2))
    jckpt.save_checkpoint(str(tmp / "whole"), st, 3,
                          extra={"best": {"best_ema_teacher": 0.25}})
    jckpt.save_checkpoint_sharded(
        str(tmp / "sharded"), shard_train_state(st, make_mesh(2), fsdp=True),
        4)
    jckpt.save_checkpoint(str(tmp / "family"), teacher, 2,
                          extra={"ap50": 0.5})

    x = np.random.default_rng(6).standard_normal((2, *HW, 3)).astype(
        np.float32)
    pad = np.zeros((2, *HW), bool)
    pad[1, :, 100:] = True
    x[pad] = 0.0
    fwd = jax.jit(lambda p: jm.apply(p, x, pad),
                  compiler_options=FAST_COMPILE)
    want = {name: {k: np.asarray(v) for k, v in jax.device_get(fwd(p))
                   .items() if k in ("pred_logits", "pred_boxes")}
            for name, p in (("student", params), ("teacher", teacher))}
    return dict(tmp=tmp, cfg=cfg_path, x=x, pad=pad, want=want,
                proto=np.asarray(st.global_proto), amount=np.asarray(
                    st.amount))


def _port_state(cfg_path):
    model = t_build_model(t_load_config(cfg_path), "cpu", seed=0)[0]
    return t_train_state(model, Optimizer(model))


def _assert_forward(model, saved, which):
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(saved["x"]),
                           torch.from_numpy(saved["pad"]))
    want = saved["want"][which]
    np.testing.assert_allclose(out["pred_logits"].numpy(),
                               want["pred_logits"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(out["pred_boxes"].numpy(),
                               want["pred_boxes"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind,epoch", [("whole", 3), ("sharded", 4)])
def test_train_state_reaches_the_port(saved, kind, epoch, capsys):
    """The tool's output loads with the port's load_checkpoint: the meta's
    epoch and extras, the counters, the prototype state, and the student's
    and EMA teacher's forwards as datr_tpu's; it says that the moments are
    not carried."""
    out = saved["tmp"] / f"{kind}.pt"
    orbax_to_torch.main(["--ckpt", str(saved["tmp"] / kind), "-c",
                         saved["cfg"], "--out", str(out)])
    said = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert said["kind"] == "train_state" and said["epoch"] == epoch
    assert "not carried" in said["optimizer_moments"]
    state, meta = load_checkpoint(str(out), _port_state(saved["cfg"]))
    assert meta["epoch"] == epoch
    if kind == "whole":
        assert meta["best"] == {"best_ema_teacher": 0.25}
    assert (state.step, state.ema_updates) == (7, 2)
    np.testing.assert_array_equal(state.global_proto.numpy(), saved["proto"])
    np.testing.assert_array_equal(state.amount.numpy(), saved["amount"])
    _assert_forward(state.model, saved, "student")
    _assert_forward(state.ema_teacher, saved, "teacher")


def test_params_family_reaches_the_port(saved, capsys):
    out = saved["tmp"] / "family.pt"
    orbax_to_torch.main(["--ckpt", str(saved["tmp"] / "family"), "-c",
                         saved["cfg"], "--out", str(out)])
    said = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert said["kind"] == "params" and said["meta"] == {"ap50": 0.5}
    model = t_build_model(t_load_config(saved["cfg"]), "cpu", seed=0)[0]
    model.load_state_dict(load_pretrain_params(str(out), model))
    _assert_forward(model, saved, "teacher")
