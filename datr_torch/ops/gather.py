"""Row gathers of the gather microbenchmarks (csrc/gather.cu).

- `row_gather(table, idx, offset)`: out[i] = table[idx[i] + offset];
  replaces tools/msda_pallas_bench.py:copy_kernel and the three probes of
  tools/mosaic_probe.py.
- `gather_fma(table, idx, w, k)`: out[q] = sum_{j<k} w[k*q+j] *
  f32(table[idx[k*q+j]]), accumulated in f32, stored as bf16; replaces
  tools/msda_pallas_bench.py:fma_kernel, whose table is bf16.

Tables are [T, C] with rows of a multiple of 16 bytes: f32 or bf16 for
`row_gather`, bf16 only for `gather_fma`; idx is int32. CPU tensors go to
the plain versions (`*_plain`), CUDA tensors to the kernels, which count
their launches in `.launches`; anything else raises.
On the card, rows outside the table read as zeros (the plain versions
raise).
"""

from __future__ import annotations

import threading

import torch

from . import _build

_launch_lock = threading.Lock()
_DTYPES = (torch.float32, torch.bfloat16)


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                     offset: int = 0) -> torch.Tensor:
    return table[idx.long() + offset]


def gather_fma_plain(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                     k: int = 16) -> torch.Tensor:
    rows = table[idx.long()].float() * w.reshape(-1, 1).float()
    return rows.reshape(-1, k, table.shape[1]).sum(1).to(table.dtype)


def _check(name, table, idx, *more):
    tensors = (table, idx, *more)
    if not all(t.is_cuda and t.device == table.device for t in tensors):
        raise ValueError(f"{name} needs all inputs on one CUDA device")
    if table.dim() != 2 or table.dtype not in _DTYPES:
        raise ValueError(f"{name}: table must be [T, C] f32 or bf16")
    if (table.shape[1] * table.element_size()) % 16:
        raise ValueError(f"{name}: table rows must be a multiple of 16 bytes")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"{name}: idx must be a 1-d int32 tensor")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: the table must be 16-byte aligned")


def _count(fn):
    with _launch_lock:
        fn.launches += 1


def row_gather(table: torch.Tensor, idx: torch.Tensor,
               offset: int = 0) -> torch.Tensor:
    """CPU -> plain version; CUDA -> the kernel on the current stream."""
    if table.device.type == "cpu":
        return row_gather_plain(table, idx, offset)
    if not table.is_cuda:
        raise ValueError(f"row_gather: unsupported device {table.device}")
    _check("row_gather", table, idx)
    lib = _build.load_library()
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = lib.row_gather(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                        table.shape[0], idx.shape[0],
                        table.shape[1] * table.element_size(), int(offset),
                        table.device.index, stream)
    _build.check(lib, rc, "row_gather launch")
    _count(row_gather)
    return out


row_gather.launches = 0


def gather_fma(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
               k: int = 16) -> torch.Tensor:
    """CPU -> plain version; CUDA -> the kernel on the current stream.
    table is bf16; idx and w (f32) hold k entries per output row."""
    if table.dtype != torch.bfloat16:
        raise ValueError(f"gather_fma: table must be bf16, not {table.dtype}")
    if table.device.type == "cpu":
        return gather_fma_plain(table, idx, w, k)
    if not table.is_cuda:
        raise ValueError(f"gather_fma: unsupported device {table.device}")
    _check("gather_fma", table, idx, w)
    if w.dtype != torch.float32 or w.numel() != idx.shape[0]:
        raise ValueError("gather_fma: w must be f32 with one entry per index")
    if idx.shape[0] % k:
        raise ValueError(f"gather_fma: {idx.shape[0]} indices are not a "
                         f"multiple of k={k}")
    lib = _build.load_library()
    n_out = idx.shape[0] // k
    out = torch.empty((n_out, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = lib.gather_fma(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                        out.data_ptr(), table.shape[0], n_out, table.shape[1],
                        k, table.device.index, stream)
    _build.check(lib, rc, "gather_fma launch")
    _count(gather_fma)
    return out


gather_fma.launches = 0
