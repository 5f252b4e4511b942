"""Exclusive cumulative sum along the chunk axis: the port of
`scripts_dev/probe_cumsum.py`'s `run`.

`chunk_cumsum(x)` maps a (T, C, NPIX) float32 tensor to out[t, r] = sum of
x[t, :r] (zeros in row 0). On a CUDA tensor it launches `csrc/chunk_cumsum.cu`:
variant "seq" walks the C rows in order with one thread per pixel column,
variant "warp" lays the chunk axis across a warp and scans with shuffles. On a
CPU tensor it runs `chunk_cumsum_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

VARIANTS = {"seq": "chunk_cumsum_seq_f32", "warp": "chunk_cumsum_warp_f32"}
WARP_CHUNKS = (32, 64, 128, 256)


def chunk_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """The inclusive cumulative sum along axis 1, shifted down one row."""
    incl = torch.cumsum(x, dim=1)
    return torch.cat([torch.zeros_like(x[:, :1]), incl[:, :-1]], dim=1)


def chunk_cumsum(x: torch.Tensor, variant: str = "seq", impl: str = "auto") -> torch.Tensor:
    """Exclusive cumulative sum along axis 1 of a (T, C, NPIX) tensor.

    variant: "seq" (any C) or "warp" (C in WARP_CHUNKS). impl: "auto" (kernel
    on CUDA tensors, plain version on CPU tensors), "torch" or "cuda"."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.ndim != 3:
        raise ValueError(f"chunk_cumsum wants (T, C, NPIX), got {tuple(x.shape)}")
    if impl == "torch" or (impl == "auto" and not x.is_cuda):
        return chunk_cumsum_plain(x)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"chunk_cumsum kernel wants a contiguous float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    n_blocks, chunk, npix = x.shape
    if variant == "warp" and chunk not in WARP_CHUNKS:
        raise ValueError(f"the warp variant lays C over 32 lanes: C must be one of "
                         f"{WARP_CHUNKS}, got {chunk}")
    out = torch.empty_like(x)
    fn = build.entry("chunk_cumsum", VARIANTS[variant],
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        chunk_cumsum.launches += 1
        build.check(fn(x.data_ptr(), out.data_ptr(), n_blocks, chunk, npix, stream),
                    f"chunk_cumsum({variant})")
    return out


chunk_cumsum.launches = 0
