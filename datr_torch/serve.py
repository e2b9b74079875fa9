"""Dynamic-batching inference server (port of datr_tpu/serve.py:66-590).

  request -> host resize kept in uint8 (datr_torch.native) -> fixed uint8
  canvas -> micro-batch padded to the static batch size -> upload ->
  wire_decode (normalize + pad mask on the device) -> DINO eval forward ->
  postprocess -> per-request detections in original-image pixels.

Threads as in datr_tpu: a batcher assembles batches, dispatchers upload and
enqueue the forward (CUDA work is asynchronous, so a dispatcher returns while
the card still runs), collectors copy results to the host (the copy waits for
the card) and resolve futures. A semaphore bounds the live batches on the
device. Single device, u8 wire format, detection only.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import native, resolve_device
from .data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    get_size_with_aspect_ratio,
)
from .models.postprocess import postprocess

MAX_IN_FLIGHT = 2  # batches live on the device at once
MAX_QUEUE = 256  # requests waiting for a batch; submit blocks beyond it
DISPATCHER_THREADS = 2
COLLECTOR_THREADS = 2


def wire_decode(images: torch.Tensor, real_hw: torch.Tensor):
    """uint8 [B, H, W, 3] canvas + [B, 2] real (h, w) -> (normalized f32
    [B, H, W, 3] with pads zeroed, pad_mask [B, H, W] True = pad)."""
    B, H, W, _ = images.shape
    dev = images.device
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]
    pad_mask = ((rows >= real_hw[:, 0, None, None])
                | (cols >= real_hw[:, 1, None, None]))
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    out = (images.to(torch.float32) / 255.0 - mean) / std
    return out.masked_fill(pad_mask[..., None], 0.0), pad_mask


class _Request:
    __slots__ = ("image", "orig_hw", "real_hw", "future", "t_enqueue")

    def __init__(self, image, orig_hw, real_hw, future):
        self.image = image  # uint8 [H, W, 3] canvas, zero-padded
        self.orig_hw = orig_hw
        self.real_hw = real_hw  # unpadded (h, w) on the canvas
        self.future = future
        self.t_enqueue = time.monotonic()


class InferenceServer:
    """Micro-batching detection server over the port's DINO.

    Batches always have `batch_size` slots; short batches are padded with
    empty images whose outputs are discarded. `submit` returns a Future of
    {"boxes": [N, 4] xyxy px, "scores": [N], "labels": [N]}. The model runs
    on `device` (default: the CUDA card; raises without one), in f32: on a
    CUDA device the server turns TF32 off for cuDNN convolutions and for
    matmuls (PyTorch's process-wide flags), so it runs what the kernel-vs-plain
    check holds."""

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
        device=None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model.to(self.device).eval()
        self.canvas_hw = tuple(canvas_hw)
        self.batch_size = int(batch_size)
        self.num_select = int(num_select)
        self.score_threshold = float(score_threshold)
        self.resize_short = int(resize_short)
        self.resize_max = int(resize_max)
        self.batch_timeout_s = float(batch_timeout_s)

        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(MAX_QUEUE)
        # a batch holds a slot from before its upload until its results are
        # on the host and its device tensors dropped: at most MAX_IN_FLIGHT
        # batches live on the device
        self._dev_slots = threading.Semaphore(MAX_IN_FLIGHT)
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
            for i in range(DISPATCHER_THREADS)
        ]
        self._collectors = [
            threading.Thread(target=self._collect_loop,
                             name=f"serve-collector-{i}", daemon=True)
            for i in range(COLLECTOR_THREADS)
        ]
        self._batcher.start()
        for t in (*self._dispatchers, *self._collectors):
            t.start()

    # ---------------- the device step ----------------

    def _step(self, images_u8: np.ndarray, sizes: np.ndarray) -> torch.Tensor:
        """Upload one batch and enqueue decode + forward + postprocess.
        Returns the packed [B, num_select, 6] (score, label, xyxy) results on
        the device; reading them waits for the card."""
        with torch.inference_mode():
            images = torch.from_numpy(images_u8).to(self.device)
            real_hw = torch.from_numpy(sizes).to(self.device)
            x, pad_mask = wire_decode(images, real_hw)
            out = self.model(x, pad_mask)
            # target size (1, 1): boxes relative to the real extent, scaled
            # to original pixels per request on the host
            ones = torch.ones((x.shape[0], 2), device=self.device)
            res = postprocess(out["pred_logits"], out["pred_boxes"], ones,
                              num_select=self.num_select)
            return torch.cat([res["scores"][..., None],
                              res["labels"].to(torch.float32)[..., None],
                              res["boxes"].to(torch.float32)], -1)

    # ---------------- client API ----------------

    def warmup(self):
        """One full batch outside the serving path (kernel build, cuDNN
        algorithm choice, allocator growth)."""
        H, W = self.canvas_hw
        packed = self._step(
            np.zeros((self.batch_size, H, W, 3), np.uint8),
            np.tile(np.int32([H, W]), (self.batch_size, 1)))
        packed.cpu()

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
        return native.resize_pad_u8(img_u8, (oh, ow), (H, W)), (oh, ow)

    def _batch_loop(self):
        B = self.batch_size
        H, W = self.canvas_hw
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
            images = np.zeros((B, H, W, 3), np.uint8)
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
            packed_d, items = got
            try:
                packed = packed_d.cpu().numpy()
            except Exception as e:  # a fault during the device run
                del packed_d
                self._dev_slots.release()
                self._resolve_items(items, None, exc=e)
                continue
            del packed_d  # drop the device tensor before freeing the slot
            self._dev_slots.release()
            now = time.monotonic()
            with self._stats_lock:
                self._stats["batches"] += 1
                self._stats["batch_slots"] += len(items)
                self._stats["requests"] += len(items)
                self._stats["latency_sum_s"] += sum(
                    now - it.t_enqueue for it in items)
                self._latencies.extend(now - it.t_enqueue for it in items)
            self._resolve_items(items, packed)

    def _resolve_items(self, items, packed, exc=None):
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
                it.future.set_result({
                    "boxes": b,
                    "scores": scores[keep],
                    "labels": packed[i, :, 1][keep].astype(np.int32),
                })
            except Exception as e:
                it.future.set_exception(e)
