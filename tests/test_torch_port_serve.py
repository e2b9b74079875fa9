"""The port's serving slice against datr_tpu on the CPU: the whole eval
forward on a padded batch, postprocess, host resize, wire decode and the
InferenceServer answering the same uint8 requests.

Tiny configuration of tests/test_serve.py (hidden 32, 2 heads, 12 queries,
canvas 96x128) with 1 encoder and 2 decoder layers so aux outputs exist.
Tolerances are the ones datr_tpu met against the original reference
(tests/test_torch_parity.py:82-109): logits atol 2e-3, boxes atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from flax.traverse_util import flatten_dict, unflatten_dict

from datr_torch import native as tnative
from datr_torch import resolve_device
from datr_torch import serve as tserve
from datr_torch.convert import load_flax_params
from datr_torch.models.dino import DINO as TorchDINO
from datr_torch.models.postprocess import postprocess as torch_postprocess
from datr_tpu import native as jnative
from datr_tpu import serve as jserve
from datr_tpu.models.dino import DINO
from datr_tpu.models.postprocess import postprocess as jax_postprocess

CANVAS = (96, 128)
K = 4
KW = dict(num_classes=K, num_queries=12, hidden_dim=32, nheads=2,
          enc_layers=1, dec_layers=2, dim_feedforward=64)
LOGIT_ATOL, BOX_ATOL = 2e-3, 1e-4


def _perturb(params, seed=0):
    """Seeded noise on every constant-initialized leaf (zero kernels, unit
    norms, identity frozen BN), so no path sees a trivial weight."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(params)
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        if np.all(v == v.flat[0]):
            scale = 0.2 if k[-1] == "running_var" else 0.1
            noise = (rng.random(v.shape) if k[-1] == "running_var"
                     else rng.standard_normal(v.shape))
            v = v + scale * noise.astype(np.float32)
        flat[k] = v
    return unflatten_dict(flat)


@pytest.fixture(scope="module")
def models():
    jm = DINO(**KW, dn_number=2, dn_single_pad=2, dn_labelbook_size=K,
              use_remat=False)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *CANVAS, 3)),
                     jnp.zeros((1, *CANVAS), bool), train=False)
    params = {"params": _perturb(params["params"])}
    tm = TorchDINO(**KW)
    load_flax_params(tm, params)
    return jm, params, tm.eval()


def _padded_batch():
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, *CANVAS, 3)).astype(np.float32)
    pm = np.zeros((2, *CANVAS), bool)
    pm[0, 70:] = True
    pm[0, :, 101:] = True
    pm[1, :, 77:] = True
    img[pm] = 0.0
    return img, pm


def test_eval_forward_parity_padded_batch(models, monkeypatch):
    jm, params, tm = models
    img, pm = _padded_batch()
    seen = {}
    top_k = jax.lax.top_k

    def spy(x, k):  # the first top_k of the forward is the two-stage one
        v, i = top_k(x, k)
        seen.setdefault("idx", i)
        return v, i

    monkeypatch.setattr(jax.lax, "top_k", spy)
    want, want_idx = jax.device_get(jax.jit(
        lambda p, a, b: (jm.apply(p, a, b, train=False), seen["idx"]))(
            params, img, pm))
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(pm))
    np.testing.assert_array_equal(got["topk_idx"].numpy(), want_idx)
    for key in ("pred_logits", "aux_logits", "interm_logits"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=LOGIT_ATOL, err_msg=key)
    for key in ("pred_boxes", "aux_boxes", "interm_boxes",
                "init_box_proposal"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=BOX_ATOL, err_msg=key)
    assert got["aux_logits"].shape[0] == KW["dec_layers"] - 1


def test_postprocess_parity():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 30, 5)).astype(np.float32) * 3
    boxes = rng.random((2, 30, 4)).astype(np.float32)
    sizes = np.array([[480, 640], [96, 128]], np.float32)
    want = jax.device_get(jax_postprocess(logits, boxes, sizes, num_select=40))
    got = torch_postprocess(torch.from_numpy(logits), torch.from_numpy(boxes),
                            torch.from_numpy(sizes), num_select=40)
    for key in ("labels", "queries"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"],
                               rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("src_hw,out_hw", [((80, 110), (64, 88)),
                                           ((37, 53), (96, 128)),
                                           ((200, 90), (96, 43))])
def test_resize_pad_u8_matches_datr_tpu(src_hw, out_hw, monkeypatch):
    """The port's C++ (csrc/image_ops.cpp) bitwise equal to datr_tpu's
    native C++ kernel, which datr_tpu runs wherever g++ builds it, and the
    port's plain version bitwise equal to datr_tpu's numpy fallback."""
    img = np.random.default_rng(sum(src_hw)).integers(
        0, 256, (*src_hw, 3)).astype(np.uint8)
    assert jnative.get_lib() is not None  # the C++ path of datr_tpu
    np.testing.assert_array_equal(
        tnative.resize_pad_u8(img, out_hw, CANVAS),
        jnative.resize_pad_u8(img, out_hw, CANVAS))
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    np.testing.assert_array_equal(
        tnative.resize_pad_u8_plain(img, out_hw, CANVAS),
        jnative.resize_pad_u8(img, out_hw, CANVAS))


def test_wire_decode_matches_jax():
    rng = np.random.default_rng(5)
    canvas = rng.integers(0, 256, (2, *CANVAS, 3)).astype(np.uint8)
    sizes = np.array([[70, 101], [96, 77]], np.int32)
    want_x, want_m = jax.device_get(jserve.wire_decode(
        jnp.asarray(canvas), jnp.asarray(sizes), CANVAS, "u8"))
    got_x, got_m = tserve.wire_decode(torch.from_numpy(canvas),
                                      torch.from_numpy(sizes), CANVAS, "u8")
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=1e-6)


def _server_kw():
    return dict(canvas_hw=CANVAS, batch_size=2, num_select=8,
                score_threshold=0.0, resize_short=64, resize_max=128,
                batch_timeout_s=0.05)


def test_server_matches_datr_tpu_server(models):
    """Both servers answer the same uint8 requests of several sizes and
    aspect ratios with the same detections. Both resize with their C++
    (bitwise equal), so both models see the same canvas bytes."""
    jm, params, tm = models
    assert jnative.get_lib() is not None
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((80, 110), (120, 60), (50, 200), (96, 128),
                         (33, 47))]
    with jserve.InferenceServer(jm, params, **_server_kw()) as srv:
        want = [f.result(timeout=120) for f in [srv.submit(i) for i in imgs]]
    with tserve.InferenceServer(tm, device="cpu", **_server_kw()) as srv:
        futs = [srv.submit(i) for i in imgs]
        got = [f.result(timeout=120) for f in futs]
        st = srv.stats()
    assert st["requests"] == len(imgs) and st["batches"] >= 3
    for img, g, w in zip(imgs, got, want):
        h0, w0 = img.shape[:2]
        assert g["boxes"].shape == (8, 4)
        np.testing.assert_array_equal(g["labels"], w["labels"])
        # scores are sigmoids of logits: within the logit tolerance
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=LOGIT_ATOL)
        # boxes scaled from normalized units to original pixels
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0,
                                   atol=BOX_ATOL * max(h0, w0))


def test_server_closed_and_bad_input(models):
    _, _, tm = models
    srv = tserve.InferenceServer(tm, device="cpu", **_server_kw())
    with pytest.raises(ValueError):
        srv.submit(np.zeros((32, 32), np.uint8))
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.zeros((32, 32, 3), np.uint8))
    assert not any(t.is_alive() for t in (srv._batcher, *srv._dispatchers,
                                          *srv._collectors))


def test_default_device_raises_without_a_card(models, monkeypatch):
    _, _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.InferenceServer(tm, device=None, **_server_kw())
    assert resolve_device("cpu") == torch.device("cpu")


def test_server_over_two_devices_answers_as_one(models):
    """devices=["cpu", "cpu"]: a replica per entry, each micro-batch of 2
    split one image to each, the answers in request order: the labels
    equal one device's, scores and boxes within the forward tolerances
    (each replica runs a batch of 1). A batch size the devices do not
    divide raises datr_tpu's ValueError; device and devices together
    raise."""
    _, _, tm = models
    rng = np.random.default_rng(12)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((80, 110), (120, 60), (50, 200), (33, 47),
                         (96, 128))]
    answers = []
    for kw in (dict(device="cpu"), dict(devices=["cpu", "cpu"])):
        with tserve.InferenceServer(tm, **kw, **_server_kw()) as srv:
            answers.append([f.result(timeout=120)
                            for f in [srv.submit(i) for i in imgs]])
            n_replicas = len(srv.replicas)
    assert n_replicas == 2
    for img, g, w in zip(imgs, answers[1], answers[0]):
        h0, w0 = img.shape[:2]
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0,
                                   atol=BOX_ATOL * max(h0, w0))
    kw = dict(_server_kw(), batch_size=3)
    with pytest.raises(ValueError, match="batch_size 3 not divisible by "
                       "the mesh data axis \\(2\\)"):
        tserve.InferenceServer(tm, devices=["cpu", "cpu"], **kw)
    with pytest.raises(ValueError, match="device or devices"):
        tserve.InferenceServer(tm, device="cpu", devices=["cpu"],
                               **_server_kw())
