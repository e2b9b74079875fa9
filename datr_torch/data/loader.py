"""Batch assembly on the host: paired DA batches, single-domain batches and
eval batches with static shapes, as numpy dicts with datr_tpu's keys, shapes
and dtypes (port of datr_tpu/data/loader.py).

The paired layout is [source images ; target images] along the batch axis,
every image padded to one static canvas, targets padded to max_boxes.
Background threads build the batches (numpy's array work releases the GIL)
and the generator delivers them in order. Item j of batch bi draws from
`random.Random(seed + 7919 * epoch + bi * 1000 + j)`, the shuffle from
`random.Random(seed + epoch)`, so for one seed both pipelines give the same
batches. `to_device` moves a batch onto the model's device.

Across processes (`process_index` of `process_count`) each takes datr_tpu's
share: the training loaders every process_count-th batch of the shuffled
order (`batches[process_index::process_count]`, numbered from 0 on each
process, as datr_tpu numbers them), the eval loader every process_count-th
image, with the batch count rounded up to the same number on every process
so that the evaluation's all-gathers line up.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .transforms import DATrainTransform, EvalTransform, finalize_example


def _stack(dicts, key):
    return np.stack([d[key] for d in dicts])


def to_device(batch: Dict, device: torch.device,
              keys: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """The batch's arrays (or `keys` of them) as tensors on `device`: numpy
    arrays through pinned memory and a copy that does not block the host;
    tensors moved if they are elsewhere."""
    out = {}
    for k, v in batch.items():
        if keys is not None and k not in keys:
            continue
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        if t.device != device:
            if device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        out[k] = t
    return out


def da_batch(s, t, ts=None) -> Dict[str, np.ndarray]:
    """The paired batch of finalized source examples `s` and target
    examples `t` (finalize_example's dicts), with `ts` the target's
    finalized strong views; without them images_strong is the weak batch
    itself."""
    images = np.concatenate([_stack(s, "image"), _stack(t, "image")])
    images_strong = (images if ts is None else
                     np.concatenate([_stack(s, "image"), _stack(ts, "image")]))
    return {
        "images": images,
        "images_strong": images_strong,
        "pad_mask": np.concatenate([_stack(s, "pad_mask"),
                                    _stack(t, "pad_mask")]),
        "boxes": _stack(s, "boxes"),
        "labels": _stack(s, "labels"),
        "valid": _stack(s, "valid"),
        "real_sizes": _stack(t, "real_size"),
    }


def _batch_order(n: int, batch_size: int, seed: int, epoch: int,
                 shuffle: bool, process_index: int = 0,
                 process_count: int = 1) -> List[List[int]]:
    order = list(range(n))
    if shuffle:
        random.Random(seed + epoch).shuffle(order)
    batches = [order[i:i + batch_size]
               for i in range(0, n - batch_size + 1, batch_size)]
    return batches[process_index::process_count]


def _threaded_in_order(batches, make_batch: Callable, base_seed: int,
                       num_threads: int) -> Iterator[Dict[str, np.ndarray]]:
    """Batch bi is make_batch([(idx, base_seed + bi * 1000 + j), ...]),
    built by thread bi % num_threads and yielded in order. An exception
    raised while building batch bi ends its thread and is raised to the
    consumer in bi's place."""
    num_threads = max(1, num_threads)  # 0/negative would stall q.get()
    q: queue.Queue = queue.Queue(maxsize=max(2, num_threads))

    def worker(chunk):
        for bi, idxs in chunk:
            try:
                b = make_batch([(idx, base_seed + bi * 1000 + j)
                                for j, idx in enumerate(idxs)])
            except BaseException as e:  # noqa: BLE001 (re-raised in gen)
                q.put((bi, e))
                return
            q.put((bi, b))

    enumerated = list(enumerate(batches))
    chunks = [enumerated[i::num_threads] for i in range(num_threads)]
    for c in chunks:
        if c:
            threading.Thread(target=worker, args=(c,), daemon=True).start()

    def gen():
        buf = {}
        want = 0
        while want < len(batches):
            bi, b = q.get()
            buf[bi] = b
            while want in buf:
                b = buf.pop(want)
                if isinstance(b, BaseException):
                    raise b
                yield b
                want += 1

    return gen()


def make_da_loader(
    dataset,
    batch_size: int,  # images per domain per batch
    canvas_hw,
    transform: DATrainTransform,
    max_boxes: int = 100,
    seed: int = 0,
    shuffle: bool = True,
    num_threads: int = 4,
    epoch: int = 0,
    compute_strong: bool = True,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields batches:
      images        [2b, H, W, 3] f32: b source (weak), then b target (weak)
      images_strong [2b, H, W, 3]: [source weak ; target strong], same
                    geometry (the source has no strong view)
      pad_mask      [2b, H, W]
      boxes/labels/valid  [b, max_boxes, ...]  (source GT)
      real_sizes    [b, 2]: the target half's unpadded (h, w)

    compute_strong=False (burn-in epochs, which drop the strong views)
    skips the photometric aug and its canvas, and images_strong is the weak
    batch itself.
    """

    def load_one(idx, seed_i):
        r = random.Random(seed_i)
        s_img, _, s_tgt, t_img, t_strong, t_tgt = dataset.load(
            idx, r, strong=compute_strong)
        # the source's strong view is its weak one: no second geometry
        s_img, _, s_tgt = transform(s_img, None, s_tgt, r)
        if not compute_strong:
            t_strong = None  # no strong-view geometry either
        # the same transform instance re-rolls geometry for the target pair
        t_img, t_strong, t_tgt = transform(t_img, t_strong, t_tgt, r)
        s = finalize_example(s_img, s_tgt, canvas_hw, max_boxes)
        t = finalize_example(t_img, t_tgt, canvas_hw, max_boxes)
        if not compute_strong:
            return s, t, None
        return s, t, finalize_example(t_strong, None, canvas_hw, max_boxes)

    def make_batch(items):
        s, t, ts = zip(*[load_one(idx, seed_i) for idx, seed_i in items])
        return da_batch(s, t, ts if compute_strong else None)

    batches = _batch_order(len(dataset), batch_size, seed, epoch, shuffle,
                           process_index, process_count)
    return _threaded_in_order(batches, make_batch, seed + 7919 * epoch,
                              num_threads)


def make_single_loader(
    dataset,
    batch_size: int,
    canvas_hw,
    transform,  # SingleDomainTrainTransform
    max_boxes: int = 100,
    seed: int = 0,
    shuffle: bool = True,
    num_threads: int = 4,
    epoch: int = 0,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Single-domain supervised batches:
      images [b, H, W, 3], pad_mask [b, H, W],
      boxes/labels/valid [b, max_boxes, ...],
      masks [b, max_boxes, H/4, W/4] f16 when the dataset returns masks
    """

    def make_batch(items):
        out = []
        for idx, seed_i in items:
            img, tgt = dataset.load(idx)
            img, tgt = transform(img, tgt, random.Random(seed_i))
            out.append(finalize_example(img, tgt, canvas_hw, max_boxes))
        keys = ("boxes", "labels", "valid") + (
            ("masks",) if "masks" in out[0] else ())
        return {"images": _stack(out, "image"),
                "pad_mask": _stack(out, "pad_mask"),
                **{k: _stack(out, k) for k in keys}}

    batches = _batch_order(len(dataset), batch_size, seed, epoch, shuffle,
                           process_index, process_count)
    return _threaded_in_order(batches, make_batch, seed + 7919 * epoch,
                              num_threads)


class EvalLoader:
    """Eval batches with image ids and original sizes. The tail batch is
    padded by repeating the last image; `batch_valid` marks real entries.
    Re-iterable, and carries `.dataset` so engine.evaluate can fetch the
    raw GT (crowd and annotation areas). With `process_count` > 1 the
    process evaluates images process_index::process_count, in as many
    batches as every other process."""

    def __init__(self, dataset, batch_size: int, canvas_hw,
                 transform: EvalTransform, max_boxes: int = 100,
                 num_threads: int = 4, process_index: int = 0,
                 process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.canvas_hw = canvas_hw
        self.transform = transform
        self.max_boxes = max_boxes
        self.indices = list(range(len(dataset)))[process_index::process_count]
        self.num_threads = max(1, num_threads)
        # equal batch counts on every process: the merges' all-gathers
        self.n_batches = -(-max(len(dataset), 1) // batch_size)
        self.n_batches = -(-self.n_batches // max(process_count, 1))

    def _make_batch(self, b: int) -> Dict[str, np.ndarray]:
        bs = self.batch_size
        idxs = self.indices[b * bs:(b + 1) * bs]
        valid = np.zeros((bs,), bool)
        valid[:len(idxs)] = True
        while len(idxs) < bs:
            idxs.append(self.indices[-1] if self.indices else 0)
        items = []
        for idx in idxs:
            img, tgt = self.transform(*self.dataset.load(idx))
            items.append(
                finalize_example(img, tgt, self.canvas_hw, self.max_boxes))
        return {
            "images": _stack(items, "image"),
            "pad_mask": _stack(items, "pad_mask"),
            "orig_sizes": _stack(items, "orig_size").astype(np.float32),
            "real_sizes": _stack(items, "real_size"),
            "image_ids": _stack(items, "image_id"),
            "batch_valid": valid,
            "boxes": _stack(items, "boxes"),
            "labels": _stack(items, "labels"),
            "valid": _stack(items, "valid"),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # threaded prefetch, in-order delivery
        if self.num_threads == 1 or self.n_batches <= 1:
            for b in range(self.n_batches):
                yield self._make_batch(b)
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_threads) as pool:
            depth = self.num_threads + 1
            futs = {b: pool.submit(self._make_batch, b)
                    for b in range(min(depth, self.n_batches))}
            for b in range(self.n_batches):
                nxt = b + depth
                if nxt < self.n_batches:
                    futs[nxt] = pool.submit(self._make_batch, nxt)
                yield futs.pop(b).result()


def make_eval_loader(
    dataset,
    batch_size: int,
    canvas_hw,
    transform: EvalTransform,
    max_boxes: int = 100,
    num_threads: int = 4,
    process_index: int = 0,
    process_count: int = 1,
) -> EvalLoader:
    return EvalLoader(dataset, batch_size, canvas_hw, transform, max_boxes,
                      num_threads=num_threads, process_index=process_index,
                      process_count=process_count)
