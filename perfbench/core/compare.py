"""Judging one served answer against the reference.

The reference follows the program's two-stage top-k (f32 rounding reorders
near-tied proposals, and every decoder query pairs a learnt content
embedding with one proposal, so an order that differs in the last bit
pairs them differently); how far that choice lies from the reference's own
ranking is `select_gap`, judged apart: rank by rank, and as a set, where a
proposal left out of the reference's top-k or taken from outside it reads
its distance from the k-th score (reference/model.py), so that a program
may trade only near-tied proposals. The answer itself is then held to the
reference's candidates:

  det_gap = the larger of
    - the worst gap between the answer's scores, sorted, and the
      reference's top scores (a wrong, missing or duplicated detection
      shows here), and
    - over the answer's detections, the distance to the nearest reference
      candidate of the same class: max(|score gap|, box corners' gap over
      the image's width or height). Near-tied candidates may trade places
      in the top-k; any candidate the reference holds is an answer it
      could give.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def det_gap(answer: Dict[str, np.ndarray], ref_scores: torch.Tensor,
            prob: torch.Tensor, boxes: torch.Tensor, orig_hw,
            threshold: float) -> float:
    """`answer`: the program's {"scores", "labels", "boxes"} (pixels);
    `ref_scores` the reference's top-k scores; `prob` [Q, K] and `boxes`
    [Q, 4] every reference candidate's score and pixel box."""
    dev = prob.device
    expect = ref_scores[ref_scores > threshold]
    s = torch.as_tensor(np.asarray(answer["scores"], np.float32), device=dev)
    if s.numel() != expect.numel():
        return 1.0
    if s.numel() == 0:
        return 0.0
    rank = (torch.sort(s, descending=True).values - expect).abs().max()
    lab = torch.as_tensor(np.asarray(answer["labels"], np.int64), device=dev)
    if bool(((lab < 0) | (lab >= prob.shape[1])).any()):
        return 1.0
    b = torch.as_tensor(np.asarray(answer["boxes"], np.float32), device=dev)
    h0, w0 = orig_hw
    dims = torch.tensor([w0, h0, w0, h0], dtype=torch.float32, device=dev)
    ds = (s[:, None] - prob[:, lab].T).abs()  # [N, Q]
    db = ((b[:, None, :] - boxes[None]).abs() / dims).amax(-1)  # [N, Q]
    near = torch.maximum(ds, db).amin(-1).max()
    return float(torch.maximum(rank, near))
