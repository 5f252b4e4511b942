"""Row gather: the port of `scripts_dev/probe_kernel_gather.py`'s
`kernel_gather`. It builds the sorted stream (`ops.cuda.sorted_stream`) that
the compositor probes and tests cut with `seg_copy`; the render and training
path fetch with `tile_fetch.py` instead.

`row_gather(table, idx)` is `table[idx]` for a (N, P) float32 table and int32
indices of any shape: (*idx.shape, P). On a CUDA tensor it launches
`csrc/row_gather.cu`, which reads the int32 indices as they are; on a CPU
tensor it runs `row_gather_plain`, the indexing call. Both move bits, so they
are bitwise equal.
"""
from __future__ import annotations

import ctypes

import torch

from ...device import use_kernel
from . import build


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor, pad_rows: int = 0) -> torch.Tensor:
    """table[idx], with pad_rows zero rows appended (1-D idx only)."""
    out = table[idx.long()]
    if pad_rows:
        out = torch.cat([out, out.new_zeros((pad_rows, out.shape[-1]))], dim=0)
    return out


def _check_inputs(table: torch.Tensor, idx: torch.Tensor) -> None:
    if not (table.is_cuda and idx.is_cuda and table.device == idx.device):
        raise ValueError(f"row_gather kernel needs CUDA tensors on one device, got "
                         f"{table.device} and {idx.device}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"row_gather wants a float32 table and int32 indices, got "
                         f"{table.dtype}, {idx.dtype}")
    if table.ndim != 2:
        raise ValueError(f"row_gather wants a (N, P) table, got {tuple(table.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather wants contiguous inputs")
    if table.shape[1] % 4 == 0 and table.data_ptr() % 16:
        raise ValueError("row_gather wants a 16-byte aligned table for float4 copies")


def row_gather(table: torch.Tensor, idx: torch.Tensor, impl: str = "auto",
               pad_rows: int = 0) -> torch.Tensor:
    """(*idx.shape, P) rows of `table`; every index must lie in [0, N).

    pad_rows > 0 (1-D idx only) appends that many zero rows to the output, so
    a caller that needs a padded stream gets it without a second copy.
    impl: `device.use_kernel`'s; otherwise `row_gather_plain`."""
    if pad_rows and idx.ndim != 1:
        raise ValueError("pad_rows needs 1-D indices")
    if not use_kernel(impl, table):
        return row_gather_plain(table, idx, pad_rows)
    _check_inputs(table, idx)
    if torch.is_grad_enabled() and table.requires_grad:
        raise NotImplementedError(
            "row_gather's CUDA kernel has no backward of its own: differentiate "
            "through ops.cuda.gather_table, whose backward gathers over entry_slots")
    n, p = idx.numel(), table.shape[1]
    out = torch.empty((n + pad_rows, p), dtype=table.dtype, device=table.device)
    if pad_rows:
        out[n:].zero_()
    fn = build.entry("row_gather", "row_gather_f32",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        build.count_launch(row_gather)
        build.check(fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, p, stream),
                    "row_gather")
    return out if pad_rows else out.reshape(tuple(idx.shape) + (p,))


row_gather.launches = 0
