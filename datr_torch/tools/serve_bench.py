"""Serving bench: img/s and latency through the InferenceServer pipeline
(port of tools/serve_bench.py).

    python -m datr_torch.tools.serve_bench [--batch 2] [--images 64]
        [--clients 4] [--in_flight 2] [--wire u8|yuv420] [--amp]
        [--http [--body png|jpeg]] [--device cpu --tiny]

The flagship DINO-R50 4-scale (configs/DINO/DINO_4scale.py, 9 classes,
seeded random weights, use_remat off) on the CUDA card at the 800x1344
canvas, fed 1024x2048 (Cityscapes-sized) seeded synthetic frames: host
resize -> micro-batch -> upload -> wire decode + forward + postprocess on
the card -> the result copy. `--clients` threads submit in-process, or with
`--http` POST encoded frames (PNG by default, the Cityscapes format; the
port's encoders, no PIL) to `serve_http` on a local port, so the body's
decode is on the measured path. After a warm-up and `reset_stats`, prints
one JSON line: img/s by wall clock from the first submit to the last
completed future, the server's p50 / p95 latency (enqueue to result, from
`stats()`; with `--http` also the clients' own), mean batch occupancy, the
wire, the dtype and the msda_fwd launches of the timed run.
`--device cpu --tiny` runs a tiny model on the CPU (the tests' smoke mode;
its numbers are no device metric).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request

import numpy as np
import torch

FLAGSHIP = "configs/DINO/DINO_4scale.py"
FRAMES = 8  # distinct synthetic frames, cycled over the requests
TIMEOUT_S = 600.0  # per result; the first batch builds the kernels
TINY = dict(num_classes=4, num_queries=12, hidden_dim=32, nheads=2,
            enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=2,
            dn_single_pad=2, dn_labelbook_size=4)


def synthetic_frames(n: int, hw, seed: int = 0):
    """`n` seeded uint8 [h, w, 3] frames with a photo's entropy: upsampled
    coarse noise (low-frequency fields) and hard-edged rectangles (cars,
    signs, windows), as tools/serve_bench.py's "smooth" content, plus
    sensor noise of about 1% so that a PNG of them is as large as a
    camera frame's."""
    rng = np.random.default_rng(seed)
    h, w = hw
    cell = max(1, min(h, w) // 32)
    out = []
    for _ in range(n):
        coarse = rng.random((-(-h // cell), -(-w // cell), 3)).astype(
            np.float32)
        img = np.kron(coarse, np.ones((cell, cell, 1), np.float32))[:h, :w]
        for _ in range(12):
            y0 = int(rng.integers(0, max(1, h - h // 8)))
            x0 = int(rng.integers(0, max(1, w - w // 8)))
            img[y0:y0 + int(rng.integers(h // 64 + 1, h // 4 + 2)),
                x0:x0 + int(rng.integers(w // 64 + 1, w // 4 + 2))] = \
                rng.random(3)
        img += rng.normal(0.0, 0.01, img.shape).astype(np.float32)
        out.append((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
    return out


def encode_bodies(frames, body: str):
    """The request bodies: PNG (`data/png.py`, the five filters cycled over
    the rows) or JPEG at quality 90 (libjpeg)."""
    if body == "png":
        from ..data.png import encode_png

        return [encode_png(f) for f in frames]
    from ..native import encode_jpeg_rgb

    return [encode_jpeg_rgb(f, 90) for f in frames]


def build_server(args):
    """The bench's model behind an InferenceServer, as the flags say."""
    from ..config import load_config
    from ..models import build_model
    from ..serve import InferenceServer

    cfg = load_config(FLAGSHIP)
    cfg.update(num_classes=9, use_remat=False)
    if args.tiny:
        cfg.update(TINY)
    if args.amp:
        cfg["amp_dtype"] = "bfloat16"
    model, _, _ = build_model(cfg, args.device, seed=0)
    canvas = tuple(args.canvas or ((96, 128) if args.tiny else (800, 1344)))
    return InferenceServer(
        model, canvas_hw=canvas, batch_size=args.batch,
        num_select=8 if args.tiny else 300, score_threshold=0.0,
        resize_short=64 if args.tiny else 800,
        resize_max=128 if args.tiny else 1333,
        max_in_flight=args.in_flight, collector_threads=args.collectors,
        dispatcher_threads=args.dispatchers, wire_format=args.wire,
        device=args.device)


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def _run_clients(n_images, clients, work):
    """`work(i)` for i in 0..n_images-1 from `clients` threads; returns the
    wall time from the first start to the last finish."""
    per = [range(c, n_images, clients) for c in range(max(1, clients))]
    errors = []

    def client(idxs):
        try:
            for i in idxs:
                work(i)
        except Exception as e:  # re-raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(p,)) for p in per]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return dt


def run(args) -> dict:
    """The bench as `args` (from `get_args_parser`) says; returns the JSON
    line's dict."""
    from ..ops import msda
    from ..serve import serve_http

    src_hw = (120, 200) if args.tiny else (1024, 2048)
    frames = synthetic_frames(FRAMES, src_hw, seed=0)
    srv = build_server(args)
    httpd = None
    try:
        srv.warmup()
        for f in [srv.submit(frames[i % len(frames)])
                  for i in range(args.warm_images)]:
            f.result(timeout=TIMEOUT_S)
        if args.http:
            bodies = encode_bodies(frames, args.body)
            httpd = serve_http(srv, "127.0.0.1", 0, start=False,
                               result_timeout_s=TIMEOUT_S)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}/detect"
            lat_lock, client_lats = threading.Lock(), []

            def work(i):
                t = time.perf_counter()
                req = urllib.request.Request(
                    url, data=bodies[i % len(bodies)], method="POST")
                with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
                    json.loads(r.read())
                with lat_lock:
                    client_lats.append(time.perf_counter() - t)

            work(0)  # the HTTP path's own warm-up
            client_lats.clear()
        else:
            def work(i):
                srv.submit(frames[i % len(frames)]).result(
                    timeout=TIMEOUT_S)

        srv.reset_stats()  # the tails are the steady state's
        msda.msda_fwd.launches = 0
        dt = _run_clients(args.images, args.clients, work)
        launches = msda.msda_fwd.launches
        st = srv.stats()
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        srv.close()
    dev = srv.device
    out = {
        "metric": "serving images/sec (%s, batch %d)" % (
            "HTTP end-to-end" if args.http else "in-process submit",
            args.batch),
        "img_s": args.images / dt,
        "images": args.images,
        "wall_s": dt,
        "p50_latency_s": st.get("p50_latency_s"),
        "p95_latency_s": st.get("p95_latency_s"),
        "mean_latency_s": st["mean_latency_s"],
        "mean_batch_occupancy": st["mean_batch_occupancy"],
        "batches": st["batches"],
        "wire": args.wire,
        "dtype": "bfloat16" if args.amp else "float32",
        "msda_fwd_launches": launches,
        "clients": args.clients,
        "in_flight": args.in_flight,
        "collectors": args.collectors,
        "dispatchers": args.dispatchers,
        "canvas": list(srv.canvas_hw),
        "source_hw": list(src_hw),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if args.http:
        out.update(body=args.body,
                   http_p50_latency_s=_percentile(client_lats, 0.5),
                   http_p95_latency_s=_percentile(client_lats, 0.95))
    return out


def get_args_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--warm_images", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent submitting threads (the HTTP front "
                         "end's handler threads; the host resize runs in "
                         "the submitter)")
    ap.add_argument("--in_flight", type=int, default=2)
    ap.add_argument("--collectors", type=int, default=2)
    ap.add_argument("--dispatchers", type=int, default=2)
    ap.add_argument("--wire", default="u8", choices=["u8", "yuv420"])
    ap.add_argument("--canvas", type=int, nargs=2, default=None,
                    help="serving canvas H W (default 800 1344)")
    ap.add_argument("--amp", action="store_true",
                    help="the model in bfloat16 (amp_dtype)")
    ap.add_argument("--http", action="store_true",
                    help="POST encoded frames to serve_http instead of "
                         "submitting in-process")
    ap.add_argument("--body", default="png", choices=["png", "jpeg"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny model at a 96x128 canvas (smoke mode)")
    return ap


def main(argv=None):
    print(json.dumps(run(get_args_parser().parse_args(argv))))


if __name__ == "__main__":
    main()
