"""datr_torch — the PyTorch/CUDA port of datr_tpu for NVIDIA Hopper (sm_90a).

The package mirrors datr_tpu's module paths, names and public layouts
(images [B, H, W, 3], pad masks [B, H, W] with True = pad, tokens [B, S, C])
so each module can be held against its JAX counterpart. It imports torch and
never jax or datr_tpu. Hand-written CUDA kernels live under `csrc/` and are
compiled on first CUDA use (`ops/_build.py`).

Entry points run on the card: `device=None` means CUDA and raises when no card
is present. Pass `device="cpu"` to run the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA card; anything else is taken as given.

    Never falls back to the CPU: asking for CUDA (explicitly or by default)
    on a machine without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "datr_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
