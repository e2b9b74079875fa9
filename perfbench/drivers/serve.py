"""A serving cell: the measured package's `InferenceServer`, warmed up on
the cell's own canvas, under a closed loop of clients (the end-to-end
metric is the answered images per second) or an open loop of seeded
arrivals at a fixed rate (the 95th percentile of every request's time from
when it was due to when its answer was on the host; a failed or refused
request counts as missing it).

Every request carries its own id in its image (traffic.stamped), so each
answer can be judged alone: after the window, a seeded sample of the
answered requests is run through the reference, which follows the
program's two-stage choice for that image (read from the model's own
output by a forward hook beside the server's step) and judges it apart
(`select_gap`), and then holds the answer to its candidates (`det_gap`,
compare.py).
"""

from __future__ import annotations

import gc
import math
import queue
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from ..core import program
from ..core.compare import det_gap
from ..core.traffic import (arrival_times, base_frames, frame_order,
                            stamp_of, stamped)
from ..core.weights import make_state_dict
from ..reference import model as ref
from ..reference import serve as rserve

WARM_ID = 1 << 23  # ids of the warm-up requests, above any window's


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Choices:
    """The program's two-stage choice per request id: a forward hook keeps
    the model's `topk_idx` in the calling thread, the server's step (wrapped)
    files it under the ids stamped in the batch."""

    def __init__(self, srv, model):
        self.by_id: Dict[int, torch.Tensor] = {}
        self._local = threading.local()
        self._hook = model.register_forward_hook(
            lambda m, a, out: setattr(self._local, "topk", out["topk_idx"]))
        step = srv._step

        def wrapped(wire, sizes):
            res = step(wire, sizes)
            topk = self._local.topk
            for i in range(len(wire)):
                if sizes[i, 0] > 0:
                    self.by_id[stamp_of(wire[i])] = topk[i]
            return res

        srv._step = wrapped

    def close(self):
        self._hook.remove()


def _alter(srv):
    """A fault: the first detection's box moved by 1% of the image where the
    answer is produced."""
    step = srv._step

    def altered(wire, sizes):
        res = step(wire, sizes)
        with torch.inference_mode():
            res[:, 0, 2:6] += 0.01
        return res

    srv._step = altered


def _closed_loop(srv, frames, order, clients, seconds, on_tick):
    lock = threading.Lock()
    state = {"next": 0}
    done: List[tuple] = []
    failed = [0]
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def client():
        while True:
            with lock:
                if time.perf_counter() >= deadline:
                    return
                rid = state["next"]
                state["next"] += 1
            img = stamped(frames[order(rid)], rid)
            t_send = time.perf_counter()
            try:
                res = srv.submit(img).result(timeout=300)
            except Exception:
                with lock:
                    failed[0] += 1
                continue
            with lock:
                done.append((rid, t_send, time.perf_counter(), res))

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    on_tick(t0, deadline)
    for t in threads:
        t.join()
    t_end = max([d[2] for d in done] + [t0])
    return {"t0": t0, "window_s": t_end - t0, "done": done,
            "attempted": state["next"], "failed": failed[0]}


def _open_loop(srv, frames, order, due_s, threads, on_tick):
    """Request k sent at `due_s[k]` seconds after the start (sorted), from
    a pool of `threads` sending threads; each timed from when it was
    due."""
    n = len(due_s)
    t0 = time.perf_counter() + 0.05
    due = t0 + np.asarray(due_s, dtype=np.float64)
    lat = [math.inf] * n
    late = [0.0] * n
    ingest = [(0.0, 0.0)] * n
    results: Dict[int, tuple] = {}
    pending = threading.Semaphore(0)
    lock = threading.Lock()
    work: "queue.Queue" = queue.Queue()
    for k in range(n):
        work.put(k)

    def finish(k, fut):
        t = time.perf_counter()
        try:
            res = fut.result()
        except Exception:
            res = None
        with lock:
            if res is not None:
                lat[k] = t - due[k]
                results[k] = (t, res)
        pending.release()

    def worker():
        while True:
            try:
                k = work.get_nowait()
            except queue.Empty:
                return
            img = stamped(frames[order(k)], k)
            wait = due[k] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            t_sub = time.perf_counter()
            late[k] = t_sub - due[k]
            try:
                fut = srv.submit(img, timeout=60)
            except Exception:
                pending.release()
                continue
            ingest[k] = (t_sub, time.perf_counter() - t_sub)
            fut.add_done_callback(lambda f, k=k: finish(k, f))

    pool = [threading.Thread(target=worker, daemon=True)
            for _ in range(threads)]
    for t in pool:
        t.start()
    on_tick(t0, float(due[-1]))
    for t in pool:
        t.join()
    for _ in range(n):  # every answer, a minute past the close at most
        if not pending.acquire(timeout=max(1.0, due[-1] + 60
                                           - time.perf_counter())):
            break
    with lock:
        done = [(k, due[k], results[k][0], results[k][1])
                for k in sorted(results)]
        lat_s = list(lat)
    t_end = max([d[2] for d in done] + [float(due[-1])])
    return {"t0": t0, "window_s": t_end - t0, "done": done, "attempted": n,
            "failed": n - len(done), "latencies_s": lat_s, "late_s": late,
            "ingest_s": [ingest[d[0]] for d in done]}


# how a mix's `kind` offers its load; both take every parameter from the
# mix's data (core/traffic.py)
LOOPS = {
    "closed": lambda srv, frames, order, mix, seed, seconds, on_tick:
        _closed_loop(srv, frames, order, mix["clients"], seconds, on_tick),
    "open": lambda srv, frames, order, mix, seed, seconds, on_tick:
        _open_loop(srv, frames, order, arrival_times(mix, seconds),
                   mix["threads"], on_tick),
}


def reference_answers(config, cell, frames_by_id, choices, seed, device,
                      tf32=False):
    """{rid: (top-k scores, labels, pixel boxes; every candidate's score
    [Q, K] and pixel box [Q, 4]; select gap; own choice)} of the reference
    for each stamped frame, following `choices[rid]` where given."""
    m = config["model"]
    model = ref.DINO(**m).to(device).eval()
    model.load_state_dict(make_state_dict(model, seed, device))
    srv = cell["server"]
    short, cap = srv["resize_short"], srv["resize_max"]
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    out = {}
    try:
        with torch.no_grad():
            for rid, img in frames_by_id.items():
                x, pad, _ = rserve.canvas_input(img, short, cap,
                                                config["canvas"], device)
                sel = choices.get(rid)
                o = model(x, pad, None if sel is None else sel[None])
                out[rid] = (*rserve.detections(
                    o["pred_logits"][0], o["pred_boxes"][0], img.shape[:2],
                    srv.get("num_select", 300)), float(o["select_gap"]),
                    o["chosen"][0])
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    return out


def answers_of_reference(config, cell, frames_by_id, seed, device, tf32):
    """The reference (in TF32 for the control) in the program's place:
    ({rid: its answer as the server gives it}, {rid: its choice})."""
    thr = cell["server"].get("score_threshold", 0.2)
    answers, chosen = {}, {}
    for rid, (s, lab, b, _, _, _, ch) in reference_answers(
            config, cell, frames_by_id, {}, seed, device, tf32).items():
        keep = s > thr
        answers[rid] = {"scores": s[keep].cpu().numpy(),
                        "labels": lab[keep].cpu().numpy(),
                        "boxes": b[keep].cpu().numpy()}
        chosen[rid] = ch
    return answers, chosen


def judge(config, cell, frames_by_id, answers, choices, seed, device):
    """(det_gap, select_gap) over the judged requests; a request whose
    choice was not seen reads an infinite select gap."""
    thr = cell["server"].get("score_threshold", 0.2)
    worst_det, worst_sel = 0.0, 0.0
    for rid, (top, _, _, prob, boxes, sel_gap, _) in reference_answers(
            config, cell, frames_by_id, choices, seed, device).items():
        img = frames_by_id[rid]
        worst_det = max(worst_det, det_gap(answers[rid], top, prob, boxes,
                                           img.shape[:2], thr))
        worst_sel = max(worst_sel, sel_gap if rid in choices else math.inf)
    return {"det_gap": worst_det, "select_gap": worst_sel}


def run(spec: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: str = None, tiny: bool = False) -> Dict:
    from ..core.trace import Tracer

    cell, config, mix = spec["cell"], spec["config"], spec["traffic"]
    options = None
    if tiny:
        options = program.tiny_options(config)
        config = dict(config, **config["tiny"])
        mix = dict(mix, **mix["tiny"])
    sd_model = ref.DINO(**config["model"]).to(device)
    state_dict = make_state_dict(sd_model, seed, device)
    del sd_model
    model = program.build_model(
        config, state_dict, device,
        options)[0]
    del state_dict
    srv = program.inference_server(model, config["canvas"], cell["server"],
                                   device)
    choices = _Choices(srv, model)
    if fault == "altered_answer":
        _alter(srv)
    frames = base_frames(mix, seed, device)
    k = len(frames)
    order_of = frame_order(mix, seed, k)

    def order(rid):
        return order_of[rid % k]

    # warm-up: the canvas's one shape, and every distinct frame once
    srv.warmup()
    futs = [srv.submit(stamped(frames[i], WARM_ID + i)) for i in range(k)]
    for f in futs:
        f.result(timeout=600)
    _sync(device)
    srv.reset_stats()
    setup_s = time.perf_counter() - t_start

    # a traced run traces the window's last stretch, and the server's own
    # step after it (trace.py); the host's per-layer readings are taken
    # over the untraced part before
    tracer = (Tracer(device, cell.get("trace", {}).get("seconds", 5.0), 0.0)
              if trace else None)
    untraced = {}

    def on_tick(t0, t_end):
        if tracer is None:
            return
        time.sleep(max(0.0, t_end - tracer.seconds - time.perf_counter()))
        untraced["stats"] = srv.stats()
        tracer.main.start()
        time.sleep(max(0.0, t_end - time.perf_counter()))
        tracer.main.stop()

    got = LOOPS[mix["kind"]](srv, frames, order, mix, seed, seconds,
                             on_tick)
    _sync(device)
    stats = srv.stats()
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    done = got["done"]
    e2e = {"serve_img_s": len(done) / got["window_s"]}
    if "latencies_s" in got:
        lat = sorted(got["latencies_s"])
        e2e["serve_p95_ms"] = 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
    t_trace = tracer.main.t_a if tracer is not None else math.inf
    ingest = [d for t, d in got.get("ingest_s", []) if t < t_trace]
    records_host = {"stats": untraced.get("stats", stats),
                    "ingest_s": ingest, "late_s": got.get("late_s", [])}
    records = None
    if tracer is not None and tracer.main.prof is not None:
        batch = [srv._preprocess(stamped(frames[i % k], WARM_ID + k + i))
                 for i in range(srv.batch_size)]
        wire = np.stack([w for w, _ in batch])
        sizes = np.array([hw for _, hw in batch], np.int32)
        tracer.detail.start()
        for _ in range(2):
            srv._to_host(srv._step(wire, sizes))
        tracer.detail.stop()
        records = tracer.records()
        m = tracer.main
        answered = sum(1 for d in done if m.t_a <= d[2] <= m.t_b)
        records.update(images=answered,
                       flops=cell["flops_per_image"] * answered,
                       dtype=config["dtype"], **records_host)
        del tracer
    srv.close()
    choices.close()
    by_id = {d[0]: d[3] for d in done}
    picks = torch.randperm(len(done), generator=torch.Generator().manual_seed(
        int(seed) % (2 ** 63)))[:cell["check_requests"]].tolist()
    sample = sorted(done[i][0] for i in picks)
    sel = {rid: choices.by_id[rid] for rid in sample if rid in choices.by_id}
    del srv, model, choices
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    frames_by_id = {rid: stamped(frames[order(rid)], rid) for rid in sample}
    checks = judge(config, cell, frames_by_id, {r: by_id[r] for r in sample},
                   sel, seed, device)
    return {"attempted": got["attempted"], "failed": got["failed"],
            "setup_s": setup_s, "window_s": got["window_s"],
            "mem_peak": mem_peak, "end_to_end": e2e, "records": records,
            "host": records_host, "checks": checks,
            "detail": {"checked": len(sample)}}


def control(spec, seed, device):
    """The TF32 control's readings: the reference in TF32 answers the
    cell's first `check_requests` requests in the program's place, judged
    as the program's answers are."""
    config, mix, cell = spec["config"], spec["traffic"], spec["cell"]
    frames = base_frames(mix, seed, device)
    order = frame_order(mix, seed, len(frames))
    by_id = {rid: stamped(frames[order[rid % len(frames)]], rid)
             for rid in range(cell["check_requests"])}
    answers, chosen = answers_of_reference(config, cell, by_id, seed,
                                           device, tf32=True)
    return judge(config, cell, by_id, answers, chosen, seed, device)


def sweep(spec, seed, rates, seconds, device):
    """One server, the open loop at each rate in turn (the knee: the
    highest rate without a growing backlog): p50 / p95 from the due time,
    the answered rate, and the mean latency of the last quarter of the
    requests against the first. One JSON line a rate."""
    import json

    config, mix, cell = spec["config"], spec["traffic"], spec["cell"]
    sd = make_state_dict(ref.DINO(**config["model"]).to(device), seed,
                         device)
    model = program.build_model(config, sd, device)[0]
    srv = program.inference_server(model, config["canvas"], cell["server"],
                                   device)
    frames = base_frames(mix, seed, device)
    order = frame_order(mix, seed, len(frames))
    srv.warmup()
    for rate in rates:
        due = arrival_times(dict(mix, rate_per_s=rate, phases=None),
                            seconds)
        n = len(due)
        srv.reset_stats()
        got = _open_loop(srv, frames, lambda k: order[k % len(frames)], due,
                         mix["threads"], lambda t0, t_end: None)
        lat = sorted(got["latencies_s"])
        q = max(1, n // 4)
        first = sum(got["latencies_s"][:q]) / q
        last = sum(got["latencies_s"][-q:]) / q
        print(json.dumps({
            "rate_per_s": rate, "requests": n, "failed": got["failed"],
            "answered_per_s": len(got["done"]) / got["window_s"],
            "p50_ms": 1e3 * lat[n // 2],
            "p95_ms": 1e3 * lat[math.ceil(0.95 * n) - 1],
            "first_quarter_ms": 1e3 * first, "last_quarter_ms": 1e3 * last,
            "occupancy": srv.stats()["mean_batch_occupancy"],
            "late_p95_s": sorted(got["late_s"])[math.ceil(0.95 * n) - 1]}),
            flush=True)
    srv.close()
