"""Per-tile segment fetch: the port of `splat_tpu/ops/pallas/seg_copy.py`.

`seg_copy(sp, starts, k_pad)` turns the depth-sorted (L + k_pad, P) stream and
the (T,) first row of each tile into dense (T, k_pad, P) blocks. On a CUDA
tensor it launches `csrc/seg_copy.cu`; on a CPU tensor it runs
`seg_copy_plain`, the same gather in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from ...device import use_kernel
from . import build


def seg_copy_plain(sp: torch.Tensor, starts: torch.Tensor, k_pad: int) -> torch.Tensor:
    """sp[starts[:, None] + arange(k_pad)]: (T, k_pad, P)."""
    pos = starts.long()[:, None] + torch.arange(k_pad, device=sp.device)[None, :]
    return sp[pos]


def check_inputs(sp: torch.Tensor, starts: torch.Tensor, k_pad: int,
                 name: str = "seg_copy") -> None:
    if not (sp.is_cuda and starts.is_cuda and sp.device == starts.device):
        raise ValueError(f"{name} kernel needs CUDA tensors on one device, got "
                         f"{sp.device} and {starts.device}")
    if sp.dtype != torch.float32 or starts.dtype != torch.int32:
        raise ValueError(f"{name} wants float32 sp and int32 starts, got "
                         f"{sp.dtype}, {starts.dtype}")
    if sp.ndim != 2 or starts.ndim != 1:
        raise ValueError(f"{name} wants sp (L, P) and starts (T,), got "
                         f"{tuple(sp.shape)}, {tuple(starts.shape)}")
    if not (sp.is_contiguous() and starts.is_contiguous()):
        raise ValueError(f"{name} wants contiguous inputs")
    if sp.shape[1] % 4 == 0 and sp.data_ptr() % 16:
        raise ValueError(f"{name} wants a 16-byte aligned sp for float4 copies")
    if k_pad <= 0:
        raise ValueError(f"k_pad must be positive, got {k_pad}")


def seg_copy(sp: torch.Tensor, starts: torch.Tensor, k_pad: int,
             impl: str = "auto") -> torch.Tensor:
    """Dense (T, k_pad, P) per-tile blocks. sp must hold >= max(starts) + k_pad
    rows (the caller appends k_pad zero rows).

    impl: `device.use_kernel`'s; otherwise `seg_copy_plain`."""
    if not use_kernel(impl, sp):
        return seg_copy_plain(sp, starts, k_pad)
    check_inputs(sp, starts, k_pad)
    if torch.is_grad_enabled() and sp.requires_grad:
        raise NotImplementedError(
            "seg_copy's CUDA kernel has no backward of its own: differentiate "
            "through ops.cuda.gather_table, whose backward gathers over entry_slots")
    n_tiles, p = starts.shape[0], sp.shape[1]
    out = torch.empty((n_tiles, k_pad, p), dtype=sp.dtype, device=sp.device)
    fn = build.entry("seg_copy", "seg_copy_f32",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(sp.device):
        stream = torch.cuda.current_stream(sp.device).cuda_stream
        build.count_launch(seg_copy)
        build.check(fn(sp.data_ptr(), starts.data_ptr(), out.data_ptr(),
                       n_tiles, k_pad, p, stream), "seg_copy")
    return out


seg_copy.launches = 0
