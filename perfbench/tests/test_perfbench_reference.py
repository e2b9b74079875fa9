"""The frozen reference against the measured package's CPU path at a tiny
size, on the same weights and inputs. (The test imports both; the
reference itself imports neither the port nor the JAX package.)"""

import numpy as np
import pytest
import torch

from perfbench.core import program, spec, traffic
from perfbench.core.weights import make_state_dict
from perfbench.drivers import train
from perfbench.reference import model as ref
from perfbench.reference import msda as rmsda
from perfbench.reference import serve as rserve

CPU = torch.device("cpu")


def _tiny(name):
    c = spec.load_config(name)
    return dict(c, **c["tiny"], tiny_options=program.tiny_options(c))


@pytest.mark.parametrize("name", ["datr_c2f_r50", "dino_swinl_4scale"])
def test_eval_forward_follows_the_port(tiny, name):
    c = _tiny(name)
    r = ref.DINO(**c["model"]).eval()
    sd = make_state_dict(r, 2 ** 31 + 3, CPU)
    r.load_state_dict(sd)
    p = program.build_model(c, sd, CPU, c["tiny_options"])[0].eval()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 96, 128, 3), generator=g)
    m = torch.zeros((2, 96, 128), dtype=torch.bool)
    m[1, 70:] = True
    m[1, :, 100:] = True
    with torch.no_grad():
        po = p(x, m)
        ro = r(x, m, select=po["topk_idx"])
    assert float(ro["select_gap"]) == 0.0
    torch.testing.assert_close(ro["pred_logits"], po["pred_logits"],
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ro["pred_boxes"], po["pred_boxes"],
                               atol=1e-5, rtol=1e-5)


def test_train_steps_follow_the_port(tiny):
    """Three burn-in steps: the losses, the first gradient and the change
    of every leaf as the cell's check reads them, with the port's own
    engine, optimizer and state."""
    c = _tiny("datr_c2f_r50")
    mix = spec.load_traffic("c2f_train_2x2")
    mix = dict(mix, **mix["tiny"])
    seed = 2 ** 31 + 11
    batches = traffic.train_batches(mix, 9, c["canvas"], seed, CPU)[:3]
    sd = make_state_dict(ref.DINO(**c["model"]), seed, CPU)
    model, ccfg, wd, pcfg = program.build_model(c, sd, CPU,
                                                c["tiny_options"])
    state = program.train_state(model, pcfg, seed, 1488)
    chosen = []
    model.register_forward_hook(lambda mod, a, out: chosen.append(
        (out["topk_idx"].clone(), out["topk_idx_target"].clone())))
    names, params = state.optimizer.names, state.optimizer.params
    p0 = {n: p.detach().clone() for n, p in zip(names, params)}
    losses, g1 = [], None
    for i, b in enumerate(batches):
        losses.append(program.train_one_epoch(state, [b], ccfg, wd)["loss"])
        if i == 0:
            g1 = {n: float(state.optimizer.opt.state[p]["exp_avg"].norm())
                  / 0.1 for n, p in zip(names, params)}
    change = {n: float((p.detach() - p0[n]).norm())
              for n, p in zip(names, params)}
    rl, rg, rc, sel, _ = train.reference_steps(c, sd, batches, seed,
                                                    CPU, chosen)
    assert set(rg) == set(g1)
    gaps = train.gaps(losses, g1, change, rl, rg, rc, sel)
    assert gaps["select_gap"] == gaps["select_gap_later_steps"] == 0.0
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-4, gaps
    assert gaps["change_gap"] < 1e-4, gaps


def test_msda_follows_the_port_and_its_gradients():
    from datr_torch.ops import msda

    g = torch.Generator().manual_seed(1)
    shapes = ((12, 16), (6, 8), (3, 4))
    S = sum(h * w for h, w in shapes)
    value = torch.randn((2, S, 4, 8), generator=g, requires_grad=True)
    loc = torch.rand((2, 50, 4, 3, 2, 2), generator=g)
    # a third of the points exactly on the pixel lattice, as seeded
    # weights put them
    w = torch.tensor([16.0, 8.0, 4.0])[None, None, None, :, None]
    loc[:, :17, ..., 0] = (torch.floor(loc[:, :17, ..., 0] * w) + 0.5) / w
    loc.requires_grad_(True)
    attn = torch.rand((2, 50, 4, 3, 2), generator=g, requires_grad=True)
    out_r = rmsda.ms_deform_attn(value, shapes, loc, attn)
    out_p = msda.ms_deform_attn(value, shapes, loc, attn)
    torch.testing.assert_close(out_r, out_p, atol=1e-5, rtol=1e-5)
    go = torch.randn(out_r.shape, generator=g)
    gr = torch.autograd.grad(out_r, (value, loc, attn), go)
    gp = torch.autograd.grad(out_p, (value, loc, attn), go)
    for a, b in zip(gr, gp):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hw,out", [((480, 640), (800, 1066)),
                                    ((640, 480), (800, 600)),
                                    ((360, 640), (750, 1333)),
                                    ((1024, 2048), (1024, 2048)),
                                    ((777, 1001), (411, 530))])
def test_resize_bitwise_equal_to_the_port(hw, out):
    from datr_torch import native

    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    mine = rserve.resize_u8(img, *out)
    theirs = native.resize_pad_u8(img, out, out)
    assert np.array_equal(mine, theirs)


@pytest.mark.parametrize("hw,short,cap", [((480, 640), 800, 1333),
                                          ((640, 480), 800, 1333),
                                          ((427, 640), 800, 1333),
                                          ((360, 640), 800, 1333),
                                          ((1024, 2048), 1200, 2048)])
def test_resize_rule_is_the_servers(hw, short, cap):
    from datr_torch.serve import InferenceServer

    canvas = (800, 1344) if short == 800 else (1216, 2048)
    srv = InferenceServer.__new__(InferenceServer)
    srv.canvas_hw, srv.resize_short, srv.resize_max = canvas, short, cap
    srv.wire_format = "u8"
    img = np.zeros((*hw, 3), np.uint8)
    _, real = srv._preprocess(img)
    assert tuple(real) == rserve.resized_hw(*hw, short, cap, canvas)
