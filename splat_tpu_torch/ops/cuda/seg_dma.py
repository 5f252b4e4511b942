"""Per-tile segment fetch through asynchronous copies: the port of
`scripts_dev/probe_seg_dma.py`'s `pallas_dma` and `pallas_dma_aligned`.

`seg_dma(sp, starts, k_pad, tps, align)` computes `seg_copy`'s function, dense
(T, k_pad, P) blocks from the (L, P) stream, with `tps` tiles per thread block
staged in shared memory by `cp.async` (`csrc/seg_dma.cu`). align = 0 copies
each window from its start; align > 0 floors the start to `align` rows, copies
`k_pad + align` rows and shifts the remainder off on the way out. On CPU
tensors it runs `seg_copy_plain`. All are bitwise equal.
"""
from __future__ import annotations

import ctypes

import torch

from ...device import use_kernel
from . import build
from .seg_copy import check_inputs, seg_copy_plain

MAX_SHARED_BYTES = 232448   # dynamic shared memory a block may use on sm_90


def seg_dma(sp: torch.Tensor, starts: torch.Tensor, k_pad: int, tps: int = 4, align: int = 0,
            impl: str = "auto") -> torch.Tensor:
    """Dense (T, k_pad, P) per-tile blocks; sp must hold max(starts) + k_pad rows.

    tps: tiles per thread block; align: 0, or the row multiple each start is
    floored to. tps * (k_pad + align) * P * 4 bytes must fit a block's shared
    memory, and P must be a multiple of 4 (16-byte copies). impl as
    `seg_copy`'s."""
    if not use_kernel(impl, sp):
        return seg_copy_plain(sp, starts, k_pad)
    check_inputs(sp, starts, k_pad, name="seg_dma")
    p = sp.shape[1]
    if p % 4:
        raise ValueError(f"seg_dma copies 16 bytes at a time: P must be a multiple of 4, got {p}")
    if tps <= 0 or align < 0:
        raise ValueError(f"seg_dma wants tps > 0 and align >= 0, got {tps}, {align}")
    shared = tps * (k_pad + align) * p * 4
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"seg_dma: tps={tps}, k_pad={k_pad}, align={align} need {shared} bytes "
                         f"of shared memory, a block has {MAX_SHARED_BYTES}")
    n_tiles = starts.shape[0]
    out = torch.empty((n_tiles, k_pad, p), dtype=sp.dtype, device=sp.device)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    with torch.cuda.device(sp.device):
        stream = torch.cuda.current_stream(sp.device).cuda_stream
        head = (sp.data_ptr(), starts.data_ptr(), out.data_ptr(), n_tiles, sp.shape[0], k_pad,
                p, tps)
        build.count_launch(seg_dma)
        if align:
            fn = build.entry("seg_dma", "seg_dma_aligned_f32",
                             [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr])
            err = fn(*head, align, stream)
        else:
            fn = build.entry("seg_dma", "seg_dma_f32",
                             [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr])
            err = fn(*head, stream)
        build.check(err, f"seg_dma(tps={tps}, align={align})")
    return out


seg_dma.launches = 0
