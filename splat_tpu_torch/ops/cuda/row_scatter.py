"""Row scatter-accumulate: the port of `scripts_dev/probe_kernel_gather.py`'s
`kernel_scatter`.

`row_scatter(idx, g, n_rows)` returns the (n_rows, P) table whose row d is the
sum of the rows g[r] with idx[r] == d, added in ascending r from zero: the
sequential loop `acc[idx[r]] += g[r]`. On CUDA tensors both of its steps are
kernels of `csrc/row_scatter.cu`: `scatter_plan` orders the contributors by
destination (a two-level counting sort, no sort call), and the sum gives
each destination's segment to a group of lanes that adds its rows in that
order, loading eight at a time: no float atomics, two launches bitwise
equal. The plan kernels take up to 2^24 - 1 destinations (`MAX_PLAN_ROWS`)
and raise beyond. On CPU tensors `row_scatter_plain` runs `index_add_`, which is the
sequential loop there, and `scatter_plan_plain` makes the plan with a
stable sort.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ...device import use_kernel
from . import build

# the plan kernels' bucket table covers up to 2^24 destinations (with the dropped)
MAX_PLAN_ROWS = 2**24


def row_scatter_plain(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """zeros(n_rows, P).index_add_(0, idx, g) over the flattened rows."""
    width = g.shape[-1]
    return g.new_zeros((n_rows, width)).index_add_(0, idx.reshape(-1).long(),
                                                    g.reshape(-1, width))


def scatter_plan_plain(idx: torch.Tensor, n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plan by a stable sort: (order, offsets), both int32. An index
    outside [0, n_rows) counts as n_rows (it is dropped); order[k] is the
    source row of the k-th index in stable ascending order of those keys, so
    each destination's sources ascend and the dropped ones close `order`, and
    offsets[d] is the first k whose key is >= d (n_rows + 1 entries)."""
    flat = idx.reshape(-1)
    key = torch.where((flat >= 0) & (flat < n_rows), flat, n_rows)
    sorted_key, order = torch.sort(key, stable=True)
    edges = torch.arange(n_rows + 1, dtype=flat.dtype, device=flat.device)
    offsets = torch.searchsorted(sorted_key, edges, out_int32=True)
    return order.to(torch.int32), offsets


@functools.cache
def _entries():
    """The C functions of csrc/row_scatter.cu, built at first use, with their
    argument types set once (the wrapper's host time is on the clock of
    every back-to-back call)."""
    lib = build.load("row_scatter")
    scratch = lib.row_scatter_plan_scratch
    scratch.argtypes = [ctypes.c_longlong, ctypes.c_int]
    scratch.restype = ctypes.c_longlong
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    plan = build.entry("row_scatter", "row_scatter_plan_i32", [ptr, i64, i32, ptr, ptr, ptr, ptr])
    total = build.entry("row_scatter", "row_scatter_f32", [ptr, ptr, ptr, ptr, i64, i32, ptr])
    return scratch, plan, total


def _stream(dev: torch.device) -> int:
    """The raw handle of the device's current stream."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(dev.index) if raw is not None else torch.cuda.current_stream(dev).cuda_stream


def _on(dev: torch.device):
    """The device's context, entered only when it is not the current one."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _plan_buffers(n: int, n_rows: int, dev: torch.device):
    """One int32 buffer: the plan kernels' scratch (8-byte aligned at its
    start), then order (n) and offsets (n_rows + 1)."""
    words = _entries()[0](n, n_rows) // 4
    buf = torch.empty(words + n + n_rows + 1, dtype=torch.int32, device=dev)
    return buf, buf[words:words + n], buf[words + n:]


def _check_plan_args(idx: torch.Tensor, n_rows: int) -> None:
    if idx.dtype != torch.int32:
        raise ValueError(f"scatter_plan wants int32 indices, got {idx.dtype}")
    if not 1 <= n_rows < MAX_PLAN_ROWS or idx.numel() >= 2**31:
        raise ValueError(f"scatter_plan kernels take up to 2^31 - 1 indices over 1 to "
                         f"{MAX_PLAN_ROWS - 1} rows, got {idx.numel()} over {n_rows}")


def scatter_plan(idx: torch.Tensor, n_rows: int,
                 impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets) as `scatter_plan_plain` makes them, bit for bit: the
    plan kernels of csrc/row_scatter.cu where `device.use_kernel(impl, idx)`
    says so, else the stable sort."""
    if not use_kernel(impl, idx):
        return scatter_plan_plain(idx, n_rows)
    _check_plan_args(idx, n_rows)
    flat = idx.reshape(-1).contiguous()
    buf, order, offsets = _plan_buffers(flat.numel(), n_rows, idx.device)
    with _on(idx.device):
        build.count_launch(scatter_plan)
        build.check(_entries()[1](flat.data_ptr(), flat.numel(), n_rows, order.data_ptr(),
                                  offsets.data_ptr(), buf.data_ptr(), _stream(idx.device)),
                    "scatter_plan")
    return order, offsets


scatter_plan.launches = 0


def row_scatter(idx: torch.Tensor, g: torch.Tensor, n_rows: int, impl: str = "auto",
                plan: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """(n_rows, P) sums of g's rows by destination, in index order.

    idx: int32, any shape; g: float32 (*idx.shape, P). plan: a
    `scatter_plan(idx, n_rows)` made earlier (the same indices serve many
    calls); without one `scatter_plan` makes it first. impl as
    `row_gather`'s; otherwise `row_scatter_plain`."""
    if not use_kernel(impl, g):
        return row_scatter_plain(idx, g, n_rows)
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
    order, offsets = scatter_plan(idx, n_rows, impl="cuda") if plan is None else plan
    if order.numel() != idx.numel() or offsets.numel() != n_rows + 1:
        raise ValueError("row_scatter: the plan was made for other indices")
    out = torch.empty((n_rows, width), dtype=g.dtype, device=g.device)
    with _on(g.device):
        build.count_launch(row_scatter)
        build.check(_entries()[2](g.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                                  out.data_ptr(), n_rows, width, _stream(g.device)), "row_scatter")
    return out


row_scatter.launches = 0
