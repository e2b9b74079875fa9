"""The registered MSDA op (`datr_torch::ms_deform_attn`, ops/msda.py) and
datr_torch/tools/export_model.py on the CPU. torch.library.opcheck passes
on the op in f32, bf16 and f64 (its schema, fake kernel, autograd
registration and a traced backward). A tiny DINO's eval forward is
exported with torch.export, saved, loaded by `load_exported` and run: its
outputs equal eager's bit for bit, and are within the full-model
tolerances (logits atol 2e-3, boxes 1e-4) of datr_tpu's forward on the
same parameters (a ResNet of one bottleneck per stage on both sides,
RESNET_STAGES patched). The CLI exports a port checkpoint and writes the
graph's text with its copy ops ranked."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.config import apply_overrides, load_config
from datr_torch.convert import load_flax_params
from datr_torch.models.dino import build_dino_from_config
from datr_torch.ops import msda
from datr_torch.tools import export_model
from datr_torch.train.checkpoint import save_checkpoint
from datr_torch.models import dino as tdino
from datr_tpu import config as jconfig
from datr_tpu.models import dino as jdino
from datr_tpu.models.dino import build_dino_from_config as jax_build

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_bf16 import seeded_params  # noqa: E402
from test_torch_port_configs import TINY  # noqa: E402

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
CANVAS = (64, 96)
PATH = "configs/DINO/DINO_4scale.py"
SHAPES = ((8, 4), (4, 2), (2, 8))
STAGES = (1, 1, 1, 1)  # a ResNet of one bottleneck per stage, both sides


@pytest.fixture
def one_block_resnet(monkeypatch):
    monkeypatch.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    monkeypatch.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_registered_op_passes_opcheck(dtype):
    cd = msda.compute_dtype(torch.empty((), dtype=dtype))
    g = torch.Generator().manual_seed(0)
    s = sum(h * w for h, w in SHAPES)
    value = torch.randn(2, s, 2, 8, generator=g).to(dtype)
    loc = (torch.rand(2, 5, 2, 3, 2, 2, generator=g) * 1.4 - 0.2).to(cd)
    attn = torch.rand(2, 5, 2, 3, 2, generator=g).to(cd)
    flat = [v for hw in SHAPES for v in hw]
    torch.library.opcheck(msda._msda_op, (value, flat,
                                          loc.requires_grad_(), attn))
    torch.library.opcheck(msda._msda_bwd_op, (
        value, flat, loc.detach(), attn,
        torch.randn(2, 5, 16, generator=g).to(dtype)))


def _tiny_pair():
    """The tiny DINO_4scale model of both packages on one seeded tree."""
    cfg = apply_overrides(load_config(PATH), TINY)
    jm = jax_build(jconfig.apply_overrides(jconfig.load_config(PATH), TINY))
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, *CANVAS, 3)), jnp.zeros((1, *CANVAS), bool),
        train=False), jax.random.PRNGKey(0))
    params = {"params": seeded_params(shapes["params"])}
    tm = build_dino_from_config(cfg, device="cpu").eval()
    load_flax_params(tm, params)
    return tm, jm, params


def test_exported_forward_equals_eager_and_datr_tpu(tmp_path,
                                                    one_block_resnet):
    tm, jm, params = _tiny_pair()
    ep = export_model.build_exported(tm, 2, CANVAS)
    assert export_model.msda_nodes(ep) == 3  # 1 encoder + 2 decoder layers
    path = tmp_path / "tiny.pt2"
    torch.export.save(ep, str(path))
    loaded = export_model.load_exported(str(path))
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, *CANVAS, 3)).astype(np.float32)
    pm = np.zeros((2, *CANVAS), bool)
    pm[0, 52:] = True
    pm[1, :, 75:] = True
    img[pm] = 0.0
    x, m = torch.from_numpy(img), torch.from_numpy(pm)
    with torch.no_grad():
        eager = export_model.EvalForward(tm)(x, m)
        got = loaded(x, m)
    for a, b in zip(got, eager):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = jax.device_get(jax.jit(
        lambda p, a, b: jm.apply(p, a, b, train=False),
        compiler_options=FAST)(params, img, pm))
    np.testing.assert_allclose(got[0].numpy(), want["pred_logits"], rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(got[1].numpy(), want["pred_boxes"], rtol=0,
                               atol=1e-4)


def test_cli_exports_a_checkpoint(tmp_path, capsys, one_block_resnet):
    """`main` builds the config's model, loads a port checkpoint, exports
    at --batch / --canvas and writes --out and --print_graph; one JSON
    line."""
    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text(f'_base_ = ["{os.path.abspath(PATH)}"]\n'
                        + "\n".join(TINY) + "\n")
    model = build_dino_from_config(load_config(str(cfg_path)), device="cpu",
                                   seed=4)
    ckpt = tmp_path / "ckpt.pth"
    save_checkpoint(str(ckpt), model, epoch=0)
    out, graph = tmp_path / "m.pt2", tmp_path / "graph.txt"
    export_model.main(["-c", str(cfg_path), "--ckpt", str(ckpt), "--out",
                       str(out), "--batch", "1", "--canvas", "64", "96",
                       "--device", "cpu", "--print_graph", str(graph)])
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    assert res["msda_nodes"] == 3 and res["bytes"] == out.stat().st_size
    text = graph.read_text()
    assert "datr_torch.ms_deform_attn" in text
    assert "# copy / cast / layout ops by bytes written" in text
    assert res["copy_bytes_top"][0]["bytes"] >= res["copy_bytes_top"][-1][
        "bytes"]
    ckpt.unlink()  # the suite shares one disk
    out.unlink()
