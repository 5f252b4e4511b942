"""Row scatter-accumulate: the port of `scripts_dev/probe_kernel_gather.py`'s
`kernel_scatter`.

`row_scatter(idx, g, n_rows)` returns the (n_rows, P) table whose row d is the
sum of the rows g[r] with idx[r] == d, added in ascending r from zero: the
sequential loop `acc[idx[r]] += g[r]`. On CUDA tensors `scatter_plan` makes a
stable sort of the indices and the per-row segment offsets with torch ops, and
`csrc/row_scatter.cu` gives each destination row to one group of lanes that
adds its contributors in that order: no float atomics, two launches bitwise
equal. On CPU tensors `row_scatter_plain` runs `index_add_`, which is the
sequential loop there.
"""
from __future__ import annotations

import ctypes

import torch

from . import build


def row_scatter_plain(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """zeros(n_rows, P).index_add_(0, idx, g) over the flattened rows."""
    width = g.shape[-1]
    return g.new_zeros((n_rows, width)).index_add_(0, idx.reshape(-1).long(),
                                                    g.reshape(-1, width))


def scatter_plan(idx: torch.Tensor, n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets), both int32: order[k] is the source row of the k-th
    index in stable ascending order, offsets[d] the first k whose index is
    >= d (n_rows + 1 entries). Indices outside [0, n_rows) fall outside every
    segment and are dropped."""
    flat = idx.reshape(-1)
    sorted_idx, order = torch.sort(flat, stable=True)
    edges = torch.arange(n_rows + 1, dtype=flat.dtype, device=flat.device)
    offsets = torch.searchsorted(sorted_idx, edges, out_int32=True)
    return order.to(torch.int32), offsets


def row_scatter(idx: torch.Tensor, g: torch.Tensor, n_rows: int, impl: str = "auto",
                plan: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """(n_rows, P) sums of g's rows by destination, in index order.

    idx: int32, any shape; g: float32 (*idx.shape, P). plan: a
    `scatter_plan(idx, n_rows)` made earlier (the same indices serve many
    calls). impl as `row_gather`'s."""
    if impl == "torch" or (impl == "auto" and not g.is_cuda):
        return row_scatter_plain(idx, g, n_rows)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if not (g.is_cuda and idx.is_cuda and g.device == idx.device):
        raise ValueError(f"row_scatter kernel needs CUDA tensors on one device, got "
                         f"{g.device} and {idx.device}")
    if g.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"row_scatter wants float32 rows and int32 indices, got "
                         f"{g.dtype}, {idx.dtype}")
    if tuple(g.shape[:-1]) != tuple(idx.shape):
        raise ValueError(f"row_scatter wants g (*idx.shape, P), got {tuple(g.shape)} for "
                         f"indices {tuple(idx.shape)}")
    if not g.is_contiguous():
        raise ValueError("row_scatter wants contiguous rows")
    width = g.shape[-1]
    if width % 4 == 0 and g.data_ptr() % 16:
        raise ValueError("row_scatter wants 16-byte aligned rows for float4 loads")
    order, offsets = plan if plan is not None else scatter_plan(idx, n_rows)
    if order.numel() != idx.numel() or offsets.numel() != n_rows + 1:
        raise ValueError("row_scatter: the plan was made for other indices")
    out = torch.empty((n_rows, width), dtype=g.dtype, device=g.device)
    fn = build.entry("row_scatter", "row_scatter_f32",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        row_scatter.launches += 1
        build.check(fn(g.data_ptr(), order.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                       n_rows, width, stream), "row_scatter")
    return out


row_scatter.launches = 0
