"""EMA model tracks (port of datr_tpu/train/ema.py; reference
models/dino/EMA.py):
- ramped: decay * (1 - exp(-updates / 2000))  (ModelEMA :21-54)
- cosine: decay annealed per epoch from decay_start to decay_end
  (CosineEMA :92-135, update_decay :129-131)

`ema_update` covers the parameters and the buffers: the frozen batch-norm
statistics are buffers here and parameters in datr_tpu's tree (they never
change, so the update leaves them as they are up to rounding). Under FSDP
the track and its source are sharded alike (parallel/mesh.py:
shard_train_state), and each rank updates its own shards.
"""

from __future__ import annotations

import math
from typing import List, Union

import torch
from torch import nn


def _tensors(m: nn.Module) -> List[torch.Tensor]:
    """Every floating-point parameter and buffer, this rank's shard of a
    sharded one."""
    out = []
    for t in (*m.parameters(), *m.buffers()):
        if t.is_floating_point():
            t = t.data
            out.append(t.to_local() if hasattr(t, "to_local") else t)
    return out


@torch.no_grad()
def ema_update(ema: nn.Module, src: nn.Module,
               decay: Union[float, torch.Tensor]):
    """ema <- ema * decay + (1 - decay) * src, in place, over every
    floating-point parameter and buffer. A 0-d f32 tensor decay gives
    1 - decay in f32, as datr_tpu's traced decays; a Python float gives it
    in double, rounded once, as datr_tpu's static one."""
    e, p = _tensors(ema), _tensors(src)
    if [t.shape for t in e] != [t.shape for t in p]:
        raise ValueError("the EMA track and its source differ in structure")
    if isinstance(decay, torch.Tensor):
        d = decay.to(device=e[0].device, dtype=torch.float32)
        one_minus = 1.0 - d
    else:
        d, one_minus = float(decay), 1.0 - float(decay)
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, torch._foreach_mul(p, one_minus))


def ramped_decay(base_decay: float, updates) -> torch.Tensor:
    """Exponential warm-up of the decay (ModelEMA, EMA.py:37), in f32."""
    u = torch.as_tensor(updates, dtype=torch.float32)
    return base_decay * (1.0 - torch.exp(-u / 2000.0))


def cosine_decay(decay_start: float, decay_end: float, cur_epoch: int,
                 total_epochs: int) -> torch.Tensor:
    """CosineEMA.update_decay (EMA.py:129-131), in f32 from the cosine on."""
    c = torch.cos(torch.tensor(math.pi * cur_epoch / total_epochs,
                               dtype=torch.float32))
    return decay_end - (decay_end - decay_start) * (c + 1.0) / 2.0
