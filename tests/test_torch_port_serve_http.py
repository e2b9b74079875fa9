"""The port's serving surface against datr_tpu on the CPU: the yuv420 wire
(device decode and whole server), the server's options and reset_stats,
the HTTP front end (routes, 413, 503 overloaded / deadline, 500), the
serve and inference CLIs (flags, load_eval_params, run_inference) and the
serving bench's smoke mode.

The tiny configuration of tests/test_torch_port_serve.py (hidden 32, one
encoder and two decoder layers, canvas 96x128); the HTTP tests mirror
tests/test_serve.py:272-448. Tolerances: wire decode f32 atol 1e-5;
detections as test_server_matches_datr_tpu_server (scores 2e-3, boxes 1e-4
x the image's longer side); run_inference boxes 1e-4 x size, scores 1e-3.
"""

import argparse
import contextlib
import http.client
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from PIL import Image

from datr_torch import inference as tinference
from datr_torch import serve as tserve
from datr_torch.convert import load_flax_params
from datr_torch.data import png
from datr_torch.models import dino as tdino
from datr_torch.tools import serve_bench
from datr_torch.train import checkpoint as tckpt
from datr_tpu import inference as jinference
from datr_tpu import native as jnative
from datr_tpu import serve as jserve
from datr_tpu.models import dino as jdino

from test_torch_port_bf16 import seeded_params  # noqa: E402
from test_torch_port_eval import _trained_state  # noqa: E402
from test_torch_port_serve import (  # noqa: E402
    BOX_ATOL,
    CANVAS,
    KW,
    LOGIT_ATOL,
    _server_kw,
)

STAGES = (1, 1, 1, 1)  # one bottleneck block per ResNet stage, both sides


@pytest.fixture(scope="module", autouse=True)
def small_backbone():
    """Every model of this module, datr_tpu's and the port's, takes a
    ResNet of one block per stage (tests/test_torch_port_bf16_train.py
    does the same): the serving surface is under test, not the backbone,
    and a whole ResNet-50 costs seconds per build and checkpoint."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def models(small_backbone):
    """datr_tpu's tiny DINO with seeded parameters (numpy draws over
    `jax.eval_shape`'s tree: no init is compiled) and the port's with the
    converted weights."""
    jm = jdino.DINO(**KW, dn_number=2, dn_single_pad=2, dn_labelbook_size=4,
                    use_remat=False)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, *CANVAS, 3)), jnp.zeros((1, *CANVAS), bool),
        train=False), jax.random.PRNGKey(0))
    params = {"params": seeded_params(shapes["params"])}
    tm = tdino.DINO(**KW)
    load_flax_params(tm, params)
    return jm, params, tm.eval()


def _images(seed, sizes=((80, 110), (120, 60), (50, 200), (96, 128),
                         (33, 47))):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in sizes]


def _assert_detections_equal(got, want, img, score_atol=LOGIT_ATOL):
    h0, w0 = img.shape[:2]
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=score_atol)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=BOX_ATOL * max(h0, w0))


# ---------------- the yuv420 wire ----------------


def test_wire_decode_yuv420_matches_jax():
    """The device decode of a planar I420 batch (full-range BT.601, 2x
    nearest chroma, clamp, normalize, pads zeroed) against datr_tpu's on
    JAX-CPU, f32 atol 1e-5; the pad mask exactly."""
    rng = np.random.default_rng(5)
    n = CANVAS[0] * CANVAS[1] * 3 // 2
    wire = rng.integers(0, 256, (2, n)).astype(np.uint8)
    sizes = np.array([[70, 101], [96, 77]], np.int32)
    want_x, want_m = jserve.wire_decode(jnp.asarray(wire), jnp.asarray(sizes),
                                        CANVAS, "yuv420")
    got_x, got_m = tserve.wire_decode(torch.from_numpy(wire),
                                      torch.from_numpy(sizes), CANVAS,
                                      "yuv420")
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="wire_format"):
        tserve.wire_decode(torch.from_numpy(wire), torch.from_numpy(sizes),
                           CANVAS, "rgb565")


def test_yuv420_server_matches_datr_tpu_server(models):
    """Both servers with the yuv420 wire answer the same uint8 requests
    with the same detections (both resize and pack with their C++, which
    are bitwise equal)."""
    jm, params, tm = models
    assert jnative.get_lib() is not None
    imgs = _images(11)
    kw = dict(_server_kw(), wire_format="yuv420")
    with jserve.InferenceServer(jm, params, **kw) as srv:
        want = [f.result(timeout=120) for f in [srv.submit(i) for i in imgs]]
    with tserve.InferenceServer(tm, device="cpu", **kw) as srv:
        got = [f.result(timeout=120) for f in [srv.submit(i) for i in imgs]]
        assert srv._wire_shape() == (CANVAS[0] * CANVAS[1] * 3 // 2,)
    for img, g, w in zip(imgs, got, want):
        assert g["boxes"].shape == (8, 4)
        _assert_detections_equal(g, w, img)


def test_server_options(models):
    """datr_tpu's options and errors: the wire formats, an odd canvas for
    yuv420, the thread counts, max_in_flight / max_queue, mask_top_k
    (clamped to num_select); reset_stats zeroes the counters and the
    latency ring."""
    _, _, tm = models
    kw = _server_kw()
    with pytest.raises(ValueError, match="unknown wire_format"):
        tserve.InferenceServer(tm, device="cpu", **dict(kw, wire_format="x"))
    with pytest.raises(ValueError, match="even canvas"):
        tserve.InferenceServer(tm, device="cpu", **dict(
            kw, canvas_hw=(95, 128), wire_format="yuv420"))
    with tserve.InferenceServer(tm, device="cpu", mask_top_k=500,
                                **kw) as srv:
        assert srv.mask_top_k == kw["num_select"] and not srv._with_masks
    with tserve.InferenceServer(tm, device="cpu", max_in_flight=3,
                                max_queue=5, collector_threads=3,
                                dispatcher_threads=1, **kw) as srv:
        assert len(srv._collectors) == 3 and len(srv._dispatchers) == 1
        assert srv._queue.maxsize == 5 and srv._dev_slots._value == 3
        assert srv.wire_format == "u8"
        srv.detect(_images(2)[0])
        assert srv.stats()["requests"] == 1
        srv.reset_stats()
        st = srv.stats()
        assert st["requests"] == st["batches"] == 0
        assert st["latency_sum_s"] == 0.0 and "p50_latency_s" not in st
    assert not any(t.is_alive() for t in (srv._batcher, *srv._dispatchers,
                                          *srv._collectors))


# ---------------- the HTTP front end ----------------


@contextlib.contextmanager
def _http(srv, **kw):
    httpd = tserve.serve_http(srv, "127.0.0.1", 0, start=False, **kw)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def _post(url, body, timeout=60):
    """(status, JSON answer) of one POST."""
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _png(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def test_http_front_end(models, monkeypatch):
    """/healthz, /detect (a Pillow PNG and a body of the port's encoder,
    decoded with PIL blocked) against detect on the same image, /stats,
    404, and a body no decoder reads: 500 with the decoder's error."""
    _, _, tm = models
    imgs = _images(4, ((48, 72), (61, 90)))
    with tserve.InferenceServer(tm, device="cpu", **_server_kw()) as srv, \
            _http(srv) as url:
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            assert json.load(r) == {"ok": True}
        code, out = _post(url + "/detect", _png(imgs[0]))
        assert code == 200 and len(out["boxes"]) == len(out["scores"]) == 8
        want = srv.detect(imgs[0])
        np.testing.assert_array_equal(out["labels"], want["labels"])
        np.testing.assert_allclose(out["boxes"], want["boxes"], rtol=0,
                                   atol=1e-4)
        monkeypatch.setitem(sys.modules, "PIL", None)
        code, out = _post(url + "/detect", png.encode_png(imgs[1]))
        want = srv.detect(imgs[1])
        assert code == 200
        np.testing.assert_allclose(out["scores"], want["scores"], atol=1e-6)
        code, out = _post(url + "/detect", b"neither jpeg nor png")
        assert code == 500 and "needs PIL" in out["error"]
        code, out = _post(url + "/nowhere", b"x")
        assert code == 404
        with urllib.request.urlopen(url + "/stats", timeout=10) as r:
            st = json.load(r)
        assert st["requests"] == 4 and "p95_latency_s" in st


@pytest.mark.parametrize("wire", ["u8", "yuv420"])
def test_stalled_device_sheds_fast(models, wire):
    """With the device step stalled: 503 overloaded beyond max_concurrent,
    503 deadline after result_timeout_s (its Future cancelled, the
    collector alive and serving after), 413 above max_body_bytes unread;
    then the server recovers (tests/test_serve.py:320-425)."""
    _, _, tm = models
    body = _png(_images(8, ((40, 60),))[0])
    kw = dict(_server_kw(), batch_size=1, batch_timeout_s=0.01,
              max_in_flight=1, wire_format=wire)
    with tserve.InferenceServer(tm, device="cpu", **kw) as srv:
        srv.warmup()
        real_step, stall = srv._step, threading.Event()
        futures = []
        real_submit = srv.submit

        def slow_step(*a):
            stall.wait(timeout=20)
            return real_step(*a)

        def spy_submit(*a, **k):
            futures.append(real_submit(*a, **k))
            return futures[-1]

        srv._step, srv.submit = slow_step, spy_submit
        with _http(srv, result_timeout_s=0.5, max_concurrent=2,
                   max_body_bytes=1 << 20) as url:
            codes, errors, times = [], [], []

            def hit():
                t0 = time.monotonic()
                code, out = _post(url + "/detect", body, timeout=30)
                codes.append(code)
                errors.append(out.get("error"))
                times.append(time.monotonic() - t0)

            threads = [threading.Thread(target=hit) for _ in range(6)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            assert len(codes) == 6 and set(codes) == {503}, codes
            assert errors.count("deadline") >= 1, errors
            assert errors.count("overloaded") >= 1, errors
            assert max(times) < 10, times
            assert futures and all(f.cancelled() for f in futures)
            host, port = url.rsplit("/", 1)[1].split(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=10)
            conn.putrequest("POST", "/detect")  # the body is never sent
            conn.putheader("Content-Length", str((1 << 20) + 1))
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 413
            assert json.load(resp) == {"error": "body too large"}
            conn.close()
            stall.set()
            srv._step = real_step
            deadline, code = time.monotonic() + 60, None
            while time.monotonic() < deadline and code != 200:
                code, out = _post(url + "/detect", body)
                if code != 200:
                    time.sleep(0.2)
            assert code == 200 and len(out["scores"]) == 8
            assert all(c.is_alive() for c in srv._collectors)


def test_full_queue_answers_overloaded(models):
    """A full request queue (max_queue 1, the batcher held at its hand-off
    to the dispatchers) refuses a submit after submit_timeout_s: 503
    overloaded. Released, the held requests resolve and close() returns
    with every thread stopped."""
    _, _, tm = models
    img = _images(9, ((40, 60),))[0]
    srv = tserve.InferenceServer(tm, device="cpu", max_queue=1,
                                 **_server_kw())
    gate = threading.Event()
    real_put = srv._dispatch_q.put

    def held_put(*a, **k):
        gate.wait(timeout=30)
        return real_put(*a, **k)

    srv._dispatch_q.put = held_put
    try:
        first = srv.submit(img)
        deadline = time.monotonic() + 10  # the batcher takes it and waits
        while srv._queue.qsize() and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        second = srv.submit(img)  # the queue is full now
        with _http(srv, submit_timeout_s=0.2) as url:
            code, out = _post(url + "/detect", _png(img))
        assert code == 503 and out == {"error": "overloaded"}
        gate.set()
        for f in (first, second):
            assert len(f.result(timeout=60)["scores"]) == 8
    finally:
        gate.set()
        srv.close()
    assert not any(t.is_alive() for t in (srv._batcher, *srv._dispatchers,
                                          *srv._collectors))


# ---------------- the CLIs ----------------


class _Parsed(Exception):
    pass


def _flags(entry):
    """The option strings and defaults of the parser `entry` builds and
    parses with, caught at its parse_args."""
    seen = {}

    def parse_args(self, *a, **k):
        seen["parser"] = self
        raise _Parsed

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse_args
    try:
        with pytest.raises(_Parsed):
            entry()
    finally:
        argparse.ArgumentParser.parse_args = orig
    return {tuple(a.option_strings): (a.default, a.required)
            for a in seen["parser"]._actions if a.option_strings}


@pytest.mark.parametrize("pair", ["serve", "inference"])
def test_cli_flags_equal_datr_tpu(pair):
    """The serve and inference CLIs take datr_tpu's flags with datr_tpu's
    defaults, plus `--device` (default: the card)."""
    jmain, tmain = {"serve": (jserve.main, tserve.main),
                    "inference": (jinference.main, tinference.main)}[pair]
    want, got = _flags(jmain), _flags(tmain)
    want.pop(("-h", "--help"))
    got.pop(("-h", "--help"))
    assert got.pop(("--device",)) == (None, False)
    assert got == want


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A tiny config (the flagship's, narrowed) and a params-only
    checkpoint of its model (a best family, as BestTracker writes it)."""
    from datr_torch.config import load_config

    tmp = tmp_path_factory.mktemp("infer")
    cfg_path = tmp / "tiny.py"
    cfg_path.write_text(
        '_base_ = ["%s"]\nnum_classes = 5\ndn_labelbook_size = 5\n'
        "hidden_dim = 32\nnheads = 2\nenc_layers = 1\ndec_layers = 2\n"
        "dim_feedforward = 64\nnum_queries = 12\ndn_number = 2\n"
        "dn_single_pad = 2\ncanvas_h = 96\ncanvas_w = 128\nnum_select = 8\n"
        "use_remat = False\n" % (Path(__file__).resolve().parents[1]
                                  / "configs/DINO/DINO_4scale.py"))
    model = tdino.build_dino_from_config(load_config(str(cfg_path)), "cpu",
                                         seed=3)
    path = tmp / "best_ema_teacher"
    tckpt.save_checkpoint(str(path), model, 0)
    return cfg_path, path


def test_load_eval_params_picks_each_track(tmp_path):
    """From a whole training state (tests/test_torch_port_eval.py's small
    stand-in, its EMA tracks apart from the student): the student,
    model_ema (`ema`), ema_teacher (`teacher`); a params-only best family
    as it is."""
    state = _trained_state(0)
    path = tmp_path / "checkpoint"
    tckpt.save_checkpoint(str(path), state, 0)
    tckpt.save_checkpoint(str(tmp_path / "family"), state.best_ema, 0)
    for kw, src in (({}, state.model), ({"ema": True}, state.model_ema),
                    ({"teacher": True}, state.ema_teacher),
                    ({"ema": True, "teacher": True}, state.model_ema)):
        got = tinference.load_eval_params(str(path), **kw)
        want = src.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (kw, k)
    tracks = [tinference.load_eval_params(str(path), **kw)
              for kw in ({}, {"ema": True}, {"teacher": True})]
    key = next(k for k in tracks[0] if tracks[0][k].is_floating_point())
    assert not torch.equal(tracks[0][key], tracks[1][key])
    assert not torch.equal(tracks[1][key], tracks[2][key])
    family = tinference.load_eval_params(str(tmp_path / "family"))
    for k, v in state.best_ema.state_dict().items():
        assert torch.equal(family[k], v)


def test_inference_cli_end_to_end(tiny_ckpt, tmp_path, monkeypatch, capsys):
    """`python -m datr_torch.inference` on the CPU: decodes a PNG, draws,
    saves; without PIL it raises PIL's ImportError at the drawing step
    (datr_tpu's drawing, utils/visualizer.py included, needs PIL)."""
    cfg, path = tiny_ckpt
    img = _images(6, ((60, 90),))[0]
    (tmp_path / "in.png").write_bytes(png.encode_png(img))
    argv = ["-c", str(cfg), "--ckpt", str(path), "--image",
            str(tmp_path / "in.png"), "--out", str(tmp_path / "out.png"),
            "--threshold", "0", "--device", "cpu"]
    tinference.main(argv)
    assert "with 8 detections" in capsys.readouterr().out
    assert Image.open(tmp_path / "out.png").size == (90, 60)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        tinference.main(argv)


def test_serve_cli_warms_up_and_serves(tiny_ckpt, monkeypatch, capsys):
    """`python -m datr_torch.serve` builds the server from the flags
    (yuv420, the thread counts), prints datr_tpu's warmup and ready lines
    and hands the server to serve_http; close() follows."""
    cfg, path = tiny_ckpt
    seen = {}

    def fake_serve_http(srv, host, port):
        seen.update(srv=srv, host=host, port=port,
                    answer=srv.detect(_images(3, ((50, 70),))[0]))

    monkeypatch.setattr(tserve, "serve_http", fake_serve_http)
    tserve.main(["-c", str(cfg), "--ckpt", str(path), "--ema", "--port",
                 "0", "--wire", "yuv420", "--collectors", "3",
                 "--threshold", "0", "--num_select", "8", "--device",
                 "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["serve"] for ln in lines][1] == "ready"
    assert lines[1]["canvas"] == list(CANVAS)
    srv = seen["srv"]
    assert srv.wire_format == "yuv420" and len(srv._collectors) == 3
    assert len(seen["answer"]["scores"]) == 8
    assert not any(t.is_alive() for t in (srv._batcher, *srv._collectors))


def test_run_inference_matches_datr_tpu(models):
    """run_inference on the same image and converted weights: PIL's
    bilinear resize (pil_ops), finalize_example, forward, postprocess,
    boxes in original pixels (boxes 1e-4 x size, scores 1e-3)."""
    jm, params, tm = models
    img = _images(12, ((60, 90),))[0]
    jitted = jax.jit(lambda p, x, m: jm.apply(p, x, m, train=False))
    # datr_tpu's run_inference applies the model eagerly: hand it the same
    # model's apply, compiled once
    jit_model = type("Jitted", (), {
        "apply": staticmethod(lambda p, x, m, train: jitted(p, x, m))})
    jb, jl, js = jinference.run_inference(jit_model, params,
                                          Image.fromarray(img), CANVAS,
                                          num_select=8, threshold=0)
    tb, tl, ts = tinference.run_inference(tm, img, CANVAS, num_select=8,
                                          threshold=0)
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tb, np.asarray(jb), rtol=0, atol=1e-4 * 90)
    assert tb.shape == (8, 4) and tb.dtype == np.float32


# ---------------- the serving bench ----------------


@pytest.mark.parametrize("mode", [[], ["--http", "--wire", "yuv420"]])
def test_serve_bench_tiny_prints_one_json_line(mode, capsys):
    serve_bench.main(["--device", "cpu", "--tiny", "--images", "6",
                      "--warm_images", "2", "--clients", "2", *mode])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert {"img_s", "p50_latency_s", "p95_latency_s",
            "mean_batch_occupancy", "wire", "dtype",
            "msda_fwd_launches"} <= set(out)
    assert out["img_s"] > 0 and out["images"] == 6 and out["device"] == "cpu"
    assert out["msda_fwd_launches"] == 0  # the plain version on the CPU
    assert out["wire"] == ("yuv420" if mode else "u8")
    if mode:
        assert out["http_p95_latency_s"] >= out["http_p50_latency_s"] > 0
