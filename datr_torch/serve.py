"""Dynamic-batching inference server, its HTTP front end and the `serve`
CLI (port of datr_tpu/serve.py).

  request -> host resize kept in uint8 (datr_torch.native) -> fixed uint8
  canvas, or its planar I420 packing (wire_format "yuv420", 1.5 bytes/px)
  -> micro-batch padded to the static batch size -> upload -> wire_decode
  (colour, normalize and pad mask on the device) -> DINO eval forward ->
  postprocess -> per-request detections in original-image pixels.

Threads as in datr_tpu: a batcher assembles batches, dispatchers upload and
enqueue the forward (CUDA work is asynchronous, so a dispatcher returns while
the card still runs), collectors copy results to the host (the copy waits for
the card) and resolve futures. A semaphore bounds the live batches on the
device (`max_in_flight`). Over `devices` (the data axis of datr_tpu's mesh
serving) the server holds one replica of the model per device and splits
each micro-batch over them in order. A model with masks also answers each
detection's instance mask (the top `mask_top_k`), finished on the host.

Components:
  InferenceServer - request queue + micro-batcher + device step + futures
  serve_http      - stdlib ThreadingHTTPServer JSON front end
  CLI             - python -m datr_torch.serve -c CONFIG --ckpt CKPT --port P
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import native, resolve_device
from .data.coco import decode_rgb
from .data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    get_size_with_aspect_ratio,
)
from .models.postprocess import postprocess
from .models.segmentation import det_mask_rles
from .parallel.mesh import LocalTP, local_tp_shards
from .train.steps import gather_masks

WIRE_FORMATS = ("u8", "yuv420")


def wire_decode(images: torch.Tensor, real_hw: torch.Tensor,
                canvas_hw: Tuple[int, int], wire_format: str):
    """Wire payload + [B, 2] real (h, w) -> (normalized f32 [B, H, W, 3]
    with pads zeroed, pad_mask [B, H, W] True = pad). Formats:
      'u8'     - uint8 [B, H, W, 3] RGB canvas (3 bytes/px);
      'yuv420' - uint8 [B, H*W*3//2] planar I420, full-range BT.601
                 (native.rgb_to_yuv420); chroma upsampled 2x-nearest, the
                 inverse JFIF matrix applied and clamped to [0, 255]
                 (datr_tpu/serve.py:66-107).
    Plain PyTorch ops: in datr_tpu this decode is XLA fused into the first
    convolution, not a Pallas kernel."""
    B = images.shape[0]
    H, W = canvas_hw
    dev = images.device
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]
    pad_mask = ((rows >= real_hw[:, 0, None, None])
                | (cols >= real_hw[:, 1, None, None]))
    if wire_format == "yuv420":
        n_y, n_c = H * W, (H // 2) * (W // 2)
        y = images[:, :n_y].reshape(B, H, W).to(torch.float32)

        def chroma(plane):
            c = plane.reshape(B, H // 2, 1, W // 2, 1).to(torch.float32)
            return (c - 128.0).expand(B, H // 2, 2, W // 2, 2).reshape(
                B, H, W)

        u = chroma(images[:, n_y:n_y + n_c])
        v = chroma(images[:, n_y + n_c:])
        rgb = torch.stack([y + 1.402 * v,
                           y - 0.344136 * u - 0.714136 * v,
                           y + 1.772 * u], -1).clamp(0.0, 255.0)
    elif wire_format == "u8":
        rgb = images.to(torch.float32)
    else:
        raise ValueError(f"unknown wire_format {wire_format!r}")
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    out = (rgb / 255.0 - mean) / std
    return out.masked_fill(pad_mask[..., None], 0.0), pad_mask


class _Request:
    __slots__ = ("image", "orig_hw", "real_hw", "future", "t_enqueue")

    def __init__(self, image, orig_hw, real_hw, future):
        self.image = image  # uint8 wire payload: [H, W, 3] RGB canvas
        # (zero-padded) or flat [H*W*3//2] I420, per the server's wire_format
        self.orig_hw = orig_hw
        self.real_hw = real_hw  # unpadded (h, w) on the canvas
        self.future = future
        self.t_enqueue = time.monotonic()


class InferenceServer:
    """Micro-batching detection server over the port's DINO.

    Batches always have `batch_size` slots; short batches are padded with
    empty images whose outputs are discarded. `submit` returns a Future of
    {"boxes": [N, 4] xyxy px, "scores": [N], "labels": [N]}. The model runs
    on `device` (default: the CUDA card; raises without one) in its own
    dtype (`amp_dtype`: the wire decode stays f32 to the canvas, the model
    casts). On a CUDA device the server turns TF32 off for cuDNN
    convolutions and for matmuls (PyTorch's process-wide flags), so an f32
    model runs what the kernel-vs-plain check holds; a bf16 model's
    products are bf16 either way.

    Options as datr_tpu's (datr_tpu/serve.py:130-146): `max_in_flight`
    batches live on the device at once, `max_queue` requests wait for a
    batch (submit blocks beyond it), `dispatcher_threads` upload and
    enqueue, `collector_threads` copy results back, and `wire_format`
    ('u8' or 'yuv420', which needs an even canvas) is the upload's
    layout.

    `devices` (in place of `device`) serves over a mesh, as datr_tpu's
    `mesh` does (datr_tpu/serve.py:168-191): each replica is `tp`
    consecutive entries of `devices` (the same device may repeat), each
    micro-batch split over the replicas in order, `batch_size` a multiple
    of their count. With `tp` > 1 a replica holds the model split by the
    tensor-parallel plan (parallel/mesh.py `tp_plan`, datr_tpu's
    `param_sharding_tree` with a 'model' axis), one shard per entry, run
    in lockstep by one thread each; the partial sums of its row-split
    layers are brought to its first device and added there
    (parallel/mesh.py `LocalTP`), and its detections are read there.
    Answers come back in request order, equal to one device's within
    float rounding.

    A model with masks (`with_masks`) copies the f16 stride-4 mask logits
    of each image's top `mask_top_k` detections (datr_tpu/serve.py:195-233)
    and the collector finishes them to original-size RLE counts
    (`det_mask_rles`): the result's `masks` holds one per kept detection,
    None for a detection ranked below `mask_top_k`."""

    def __init__(
        self,
        model: torch.nn.Module,
        canvas_hw: Tuple[int, int] = (800, 1344),
        batch_size: int = 2,
        num_select: int = 300,
        score_threshold: float = 0.2,
        resize_short: int = 800,
        resize_max: int = 1333,
        batch_timeout_s: float = 0.02,
        max_in_flight: int = 2,
        max_queue: int = 256,
        collector_threads: int = 2,
        dispatcher_threads: int = 2,
        wire_format: str = "u8",
        device=None,
        mask_top_k: int = 50,
        devices=None,
        tp: int = 1,
    ):
        if wire_format not in WIRE_FORMATS:
            raise ValueError(f"unknown wire_format {wire_format!r}")
        if wire_format == "yuv420" and (canvas_hw[0] % 2 or canvas_hw[1] % 2):
            raise ValueError(
                f"yuv420 wire format needs an even canvas, got {canvas_hw}")
        self.wire_format = wire_format
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        self.devices = [resolve_device(d) for d in (
            devices if devices is not None else [device])]
        if not self.devices:
            raise ValueError("devices is empty")
        self.tp = int(tp)
        if self.tp < 1 or len(self.devices) % self.tp:
            raise ValueError(f"{len(self.devices)} devices do not make "
                             f"replicas of tp={self.tp}")
        n_rep = len(self.devices) // self.tp
        self.batch_size = int(batch_size)
        if self.batch_size % n_rep:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by the mesh "
                f"data axis ({n_rep})")
        self.device = self.devices[0]
        if any(d.type == "cuda" for d in self.devices):
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model.to(self.device).eval()
        # each replica's first device (where its batch share lands), and
        # the replica: the model, a copy, or (tp > 1) its shards
        self.replica_devices = self.devices[::self.tp]
        if self.tp > 1:
            self.replicas = [
                local_tp_shards(self.model, self.devices[i:i + self.tp])
                for i in range(0, len(self.devices), self.tp)]
        else:
            self.replicas = [self.model] + [
                copy.deepcopy(self.model).to(d).eval()
                for d in self.devices[1:]]
        self.canvas_hw = tuple(canvas_hw)
        self.num_select = int(num_select)
        self.score_threshold = float(score_threshold)
        self.resize_short = int(resize_short)
        self.resize_max = int(resize_max)
        self.batch_timeout_s = float(batch_timeout_s)
        self._with_masks = bool(getattr(model, "with_masks", False))
        self.mask_top_k = min(int(mask_top_k), self.num_select)

        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            max_queue)
        # a batch holds a slot from before its upload until its results are
        # on the host and its device tensors dropped: at most max_in_flight
        # batches live on the device
        self._dev_slots = threading.Semaphore(max(1, int(max_in_flight)))
        self._in_flight: "queue.Queue" = queue.Queue()
        self._dispatch_q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._wedged = False  # set when device slots stop freeing at close
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "batch_slots": 0,
                       "latency_sum_s": 0.0}
        self._latencies = deque(maxlen=4096)
        self._batcher = threading.Thread(
            target=self._batch_loop, name="serve-batcher", daemon=True)
        self._dispatchers = [
            threading.Thread(target=self._dispatch_loop,
                             name=f"serve-dispatcher-{i}", daemon=True)
            for i in range(max(1, int(dispatcher_threads)))
        ]
        self._collectors = [
            threading.Thread(target=self._collect_loop,
                             name=f"serve-collector-{i}", daemon=True)
            for i in range(max(1, int(collector_threads)))
        ]
        self._batcher.start()
        for t in (*self._dispatchers, *self._collectors):
            t.start()

    # ---------------- the device step ----------------

    def _step(self, wire: np.ndarray, sizes: np.ndarray):
        """Upload one batch of wire payloads and enqueue decode + forward +
        postprocess. Returns the packed [B, num_select, 6] (score, label,
        xyxy) results on the device, and for a model with masks also the
        f16 mask logits [B, mask_top_k, h4, w4] of the best detections;
        reading them waits for the card. Over several devices: a list of
        each replica's results for its share of the batch, in order."""
        if len(self.replicas) == 1:
            return self._replica_step(self.replicas[0], self.device, wire,
                                      sizes)
        n = len(wire) // len(self.replicas)
        return [self._replica_step(m, d, wire[i * n:(i + 1) * n],
                                   sizes[i * n:(i + 1) * n])
                for i, (m, d) in enumerate(zip(self.replicas,
                                               self.replica_devices))]

    @staticmethod
    def _forward(model, x, pad_mask):
        """The replica's forward: a module's, or its TP shards' in
        lockstep (the first shard's outputs)."""
        if not isinstance(model, list):
            return model(x, pad_mask)

        def shard(m):
            dev = next(m.parameters()).device
            with torch.inference_mode():  # per thread
                return m(x.to(dev), pad_mask.to(dev))

        return LocalTP.run_shards(
            [functools.partial(shard, m) for m in model])[0]

    def _replica_step(self, model, device, wire, sizes):
        with torch.inference_mode():
            images = torch.from_numpy(wire).to(device)
            real_hw = torch.from_numpy(sizes).to(device)
            x, pad_mask = wire_decode(images, real_hw, self.canvas_hw,
                                      self.wire_format)
            out = self._forward(model, x, pad_mask)
            # target size (1, 1): boxes relative to the real extent, scaled
            # to original pixels per request on the host
            ones = torch.ones((x.shape[0], 2), device=device)
            res = postprocess(out["pred_logits"], out["pred_boxes"], ones,
                              num_select=self.num_select)
            packed = torch.cat([res["scores"].to(torch.float32)[..., None],
                                res["labels"].to(torch.float32)[..., None],
                                res["boxes"].to(torch.float32)], -1)
            if not self._with_masks:
                return packed
            # the scores come sorted: [:k] are the k best detections
            return packed, gather_masks(out["pred_masks"],
                                        res["queries"][:, :self.mask_top_k])

    # ---------------- client API ----------------

    def warmup(self):
        """One full batch outside the serving path (kernel build, cuDNN
        algorithm choice, allocator growth)."""
        H, W = self.canvas_hw
        self._to_host(self._step(
            np.zeros((self.batch_size, *self._wire_shape()), np.uint8),
            np.tile(np.int32([H, W]), (self.batch_size, 1))))

    @staticmethod
    def _to_host(res_d):
        """A step's results on the host: (packed, mask logits or None),
        the replicas' shares concatenated in order."""
        parts = res_d if isinstance(res_d, list) else [res_d]
        packed, masks = [], []
        for r in parts:
            if isinstance(r, tuple):
                packed.append(r[0].cpu().numpy())
                masks.append(r[1].cpu().numpy())
            else:
                packed.append(r.cpu().numpy())
        return (np.concatenate(packed),
                np.concatenate(masks) if masks else None)

    def submit(self, img_u8: np.ndarray,
               timeout: Optional[float] = None) -> Future:
        """Enqueue one [h, w, 3] uint8 image; returns a Future. With the
        queue full, blocks up to `timeout` s, then raises queue.Full."""
        if self._stop.is_set():
            raise RuntimeError("server is closed")
        img_u8 = np.asarray(img_u8)
        if img_u8.ndim != 3 or img_u8.shape[2] != 3:
            raise ValueError(f"expected [h, w, 3] image, got {img_u8.shape}")
        h0, w0 = img_u8.shape[:2]
        image, real_hw = self._preprocess(img_u8.astype(np.uint8))
        fut: Future = Future()
        self._queue.put(_Request(image, (h0, w0), real_hw, fut),
                        timeout=timeout)
        return fut

    def detect(self, img_u8: np.ndarray) -> Dict[str, np.ndarray]:
        return self.submit(img_u8).result()

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            s = dict(self._stats)
            lats = sorted(self._latencies)
        n = max(1, s["batches"])
        s["mean_batch_occupancy"] = s["batch_slots"] / (n * self.batch_size)
        s["mean_latency_s"] = s["latency_sum_s"] / max(1, s["requests"])
        if lats:
            s["p50_latency_s"] = lats[len(lats) // 2]
            s["p95_latency_s"] = lats[min(len(lats) - 1,
                                          int(len(lats) * 0.95))]
        s["queue_depth"] = self._queue.qsize()
        return s

    def reset_stats(self):
        """Zero the counters and the latency ring (after a warm-up, so the
        tails are the steady state's)."""
        with self._stats_lock:
            for k in self._stats:
                self._stats[k] = 0 if k != "latency_sum_s" else 0.0
            self._latencies.clear()

    def close(self):
        self._stop.set()
        self._queue.put(None)  # wake the batcher
        self._batcher.join(timeout=30)
        # a submit that raced close() may have enqueued after the batcher's
        # own drain: fail it now that no consumer is left
        self._fail_queued(self._queue)
        for _ in self._dispatchers:
            self._dispatch_q.put(None)
        for d in self._dispatchers:
            d.join(timeout=30)
        while True:  # batches no dispatcher picked up
            try:
                got = self._dispatch_q.get_nowait()
            except queue.Empty:
                break
            if got is not None:
                for it in got[2]:
                    it.future.set_exception(RuntimeError("server closed"))
        for _ in self._collectors:
            self._in_flight.put(None)
        for c in self._collectors:
            c.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------- pipeline threads ----------------

    @staticmethod
    def _fail_queued(q):
        while True:
            try:
                it = q.get_nowait()
            except queue.Empty:
                break
            if it is not None:
                it.future.set_exception(RuntimeError("server closed"))

    def _preprocess(self, img_u8: np.ndarray):
        H, W = self.canvas_hw
        h, w = img_u8.shape[:2]
        oh, ow = get_size_with_aspect_ratio((w, h), self.resize_short,
                                            self.resize_max)
        if oh > H or ow > W:  # the resized extent must fit the canvas
            s = min(H / oh, W / ow)
            oh, ow = int(oh * s), int(ow * s)
        canvas = native.resize_pad_u8(img_u8, (oh, ow), (H, W))
        if self.wire_format == "yuv420":
            # packed here, in the submitting thread, not in the batcher
            return native.rgb_to_yuv420(canvas, (oh, ow)), (oh, ow)
        return canvas, (oh, ow)

    def _wire_shape(self):
        H, W = self.canvas_hw
        if self.wire_format == "yuv420":
            return (H * W * 3 // 2,)
        return (H, W, 3)

    def _batch_loop(self):
        B = self.batch_size
        wire_shape = self._wire_shape()
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                break
            items = [first]
            deadline = time.monotonic() + self.batch_timeout_s
            while len(items) < B:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                items.append(nxt)
            images = np.zeros((B, *wire_shape), np.uint8)
            sizes = np.zeros((B, 2), np.int32)  # empty slots: fully padded
            for i, it in enumerate(items):
                images[i] = it.image
                sizes[i] = it.real_hw
            self._dispatch_q.put((images, sizes, items))
        self._fail_queued(self._queue)

    def _dispatch_loop(self):
        while True:
            got = self._dispatch_q.get()
            if got is None:
                break
            images, sizes, items = got
            # waiting for a device slot here is the backpressure
            got_slot = self._dev_slots.acquire(timeout=0.1)
            stop_deadline = None
            while not got_slot and not self._wedged:
                if self._stop.is_set():
                    if stop_deadline is None:
                        stop_deadline = time.monotonic() + 10.0
                    elif time.monotonic() > stop_deadline:
                        self._wedged = True  # fail fast from here on
                got_slot = self._dev_slots.acquire(timeout=0.1)
            if not got_slot:
                for it in items:
                    it.future.set_exception(RuntimeError("server closed"))
                continue
            try:
                packed = self._step(images, sizes)
            except Exception as e:  # build/launch failure -> fail futures
                self._dev_slots.release()
                for it in items:
                    it.future.set_exception(e)
                continue
            self._in_flight.put((packed, items))

    def _collect_loop(self):
        while True:
            got = self._in_flight.get()
            if got is None:
                break
            res_d, items = got
            try:
                packed, pred_masks = self._to_host(res_d)
            except Exception as e:  # a fault during the device run
                del res_d
                self._dev_slots.release()
                self._resolve_items(items, None, exc=e)
                continue
            del res_d  # drop the device tensors before freeing the slot
            self._dev_slots.release()
            now = time.monotonic()
            with self._stats_lock:
                self._stats["batches"] += 1
                self._stats["batch_slots"] += len(items)
                self._stats["requests"] += len(items)
                self._stats["latency_sum_s"] += sum(
                    now - it.t_enqueue for it in items)
                self._latencies.extend(now - it.t_enqueue for it in items)
            self._resolve_items(items, packed, pred_masks)

    def _resolve_items(self, items, packed, pred_masks=None, exc=None):
        """Resolve each request's Future; a cancelled Future or one bad item
        must not strand the batch's other futures."""
        for i, it in enumerate(items):
            try:
                if not it.future.set_running_or_notify_cancel():
                    continue  # the client cancelled
            except RuntimeError:
                continue
            if exc is not None:
                it.future.set_exception(exc)
                continue
            try:
                scores = packed[i, :, 0]
                keep = scores > self.score_threshold
                h0, w0 = it.orig_hw
                scale = np.array([w0, h0, w0, h0], np.float32)
                b = packed[i, :, 2:6][keep] * scale
                b[:, 0::2] = np.clip(b[:, 0::2], 0, w0)
                b[:, 1::2] = np.clip(b[:, 1::2], 0, h0)
                result = {
                    "boxes": b,
                    "scores": scores[keep],
                    "labels": packed[i, :, 1][keep].astype(np.int32),
                }
                if pred_masks is not None:
                    result["masks"] = self._finish_masks(
                        pred_masks[i], np.nonzero(keep)[0], it)
                it.future.set_result(result)
            except Exception as e:
                it.future.set_exception(e)

    def _finish_masks(self, pm_i: np.ndarray, kept_idx: np.ndarray,
                      it: _Request) -> List[Optional[np.ndarray]]:
        """Original-size RLE counts of the kept detections
        (datr_tpu/serve.py:571-590): pm_i holds the top mask_top_k only, so
        a kept detection ranked below them gets None."""
        with_mask = kept_idx[kept_idx < self.mask_top_k]
        rles = det_mask_rles(pm_i[with_mask].astype(np.float32),
                             self.canvas_hw, it.real_hw, it.orig_hw)
        out: List[Optional[np.ndarray]] = [None] * len(kept_idx)
        for slot, rle in zip(with_mask, rles):
            out[int(np.searchsorted(kept_idx, slot))] = rle
        return out


# ---------------- HTTP front end ----------------


def serve_http(server: InferenceServer, host: str = "127.0.0.1",
               port: int = 8080, start: bool = True,
               result_timeout_s: float = 30.0,
               submit_timeout_s: float = 5.0,
               max_body_bytes: int = 32 * 1024 * 1024,
               max_concurrent: int = 64):
    """JSON-over-HTTP front end (stdlib only; datr_tpu/serve.py:594-716).

    POST /detect   body = encoded image -> {"boxes": [[x1, y1, x2, y2], ...],
                   "scores": [...], "labels": [...]} and, for a model with
                   masks, "masks": [{"size": [h, w], "counts": [...]} or
                   null, ...] (uncompressed COCO RLE); the body is decoded
                   by `data.coco.decode_rgb` (JPEG through libjpeg, PNG
                   through the port's decoder, other formats through PIL
                   where the machine has it)
    GET  /healthz  -> {"ok": true}
    GET  /stats    -> server.stats()

    At most `max_concurrent` /detect requests are in flight; beyond that a
    request gets an immediate 503 {"error": "overloaded"} (so does one the
    full queue refuses for `submit_timeout_s`). A request waits at most
    `result_timeout_s` for its result, then cancels its Future (the
    collector skips cancelled futures) and gets 503 {"error": "deadline"}.
    Bodies above `max_body_bytes` get 413 unread. Any other failure is a
    500 with the error, sent only while no header has gone out.

    Returns the http.server instance; `start=False` skips serve_forever
    (the caller runs it in a thread; port 0 picks a free port, read it from
    `server_address`)."""
    from concurrent.futures import TimeoutError as FutTimeout
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    slots = threading.Semaphore(max(1, int(max_concurrent)))

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self._headers_sent = True
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                self._send(200, server.stats())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            self._headers_sent = False
            if self.path != "/detect":
                self._send(404, {"error": "not found"})
                return
            n = int(self.headers.get("Content-Length", "0"))
            if n > max_body_bytes:
                self._send(413, {"error": "body too large"})
                return
            if not slots.acquire(blocking=False):
                # a stalled device must give quick 503s, not a pile of
                # threads parked on fut.result
                self._send(503, {"error": "overloaded"})
                return
            try:
                img = decode_rgb(self.rfile.read(n))
                try:
                    fut = server.submit(img, timeout=submit_timeout_s)
                except queue.Full:
                    self._send(503, {"error": "overloaded"})
                    return
                try:
                    res = fut.result(timeout=result_timeout_s)
                except FutTimeout:
                    fut.cancel()  # the collector skips cancelled futures
                    self._send(503, {"error": "deadline"})
                    return
                payload = {"boxes": res["boxes"].tolist(),
                           "scores": res["scores"].tolist(),
                           "labels": res["labels"].tolist()}
                if "masks" in res:  # None past the server's mask_top_k
                    h0, w0 = img.shape[:2]
                    payload["masks"] = [
                        None if r is None
                        else {"size": [h0, w0], "counts": r.tolist()}
                        for r in res["masks"]]
                self._send(200, payload)
            except Exception as e:
                # a client socket broken mid-200 raises again on a 500:
                # answer only while nothing has been sent
                if not self._headers_sent:
                    try:
                        self._send(500, {"error": str(e)})
                    except OSError:
                        pass
            finally:
                slots.release()

        def log_message(self, *a):  # stdout keeps to the JSON lines
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    if start:
        httpd.serve_forever()
    return httpd


# ---------------- CLI ----------------


def get_args_parser():
    """datr_tpu's flags (datr_tpu/serve.py:719-748) and `--device`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--options", nargs="+", default=[])
    ap.add_argument("--ckpt", required=True,
                    help="a checkpoint of the port's format "
                         "(datr_torch/train/checkpoint.py)")
    ap.add_argument("--ema", action="store_true",
                    help="serve the model_ema track")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--num_select", type=int, default=300)
    ap.add_argument("--threshold", type=float, default=0.2)
    ap.add_argument("--batch_timeout_ms", type=float, default=20.0)
    ap.add_argument("--in_flight", type=int, default=2,
                    help="max live batches on the device (backpressure)")
    ap.add_argument("--collectors", type=int, default=2,
                    help="concurrent device->host result-copy threads")
    ap.add_argument("--dispatchers", type=int, default=2,
                    help="concurrent host->device upload + enqueue threads")
    ap.add_argument("--wire", default="u8", choices=list(WIRE_FORMATS),
                    help="host->device wire format: yuv420 halves the "
                         "upload bytes again (1.5/px)")
    ap.add_argument("--device", default=None, nargs="+",
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions); several devices "
                         "serve one replica each, every batch split over "
                         "them (e.g. --device cuda:0 cuda:1)")
    return ap


def main(argv: Optional[List[str]] = None):
    args = get_args_parser().parse_args(argv)

    from .config import apply_overrides, load_config
    from .inference import load_model

    cfg = apply_overrides(load_config(args.config_file), args.options)
    devices = args.device or [None]
    model = load_model(cfg, args.ckpt, ema=args.ema, device=devices[0])
    canvas = (cfg.get("canvas_h", 800), cfg.get("canvas_w", 1344))

    srv = InferenceServer(
        model, canvas_hw=canvas, batch_size=args.batch_size,
        num_select=args.num_select, score_threshold=args.threshold,
        batch_timeout_s=args.batch_timeout_ms / 1e3,
        max_in_flight=args.in_flight, collector_threads=args.collectors,
        dispatcher_threads=args.dispatchers, wire_format=args.wire,
        devices=devices,
    )
    print(json.dumps({"serve": "warmup (kernel build + first batch)"}),
          flush=True)
    srv.warmup()
    print(json.dumps({
        "serve": "ready", "host": args.host, "port": args.port,
        "batch_size": args.batch_size, "canvas": list(canvas),
    }), flush=True)
    try:
        serve_http(srv, args.host, args.port)
    finally:
        srv.close()


if __name__ == "__main__":
    main()
