"""Device choice for the port's entry points, and which implementation a
call takes on that device."""
from __future__ import annotations

import torch

IMPLS = ("auto", "torch", "cuda")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks otherwise.

    Raises RuntimeError when CUDA is wanted (by default or by name) and this
    process has no CUDA device; there is no silent move to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "splat_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def use_kernel(impl: str, x: torch.Tensor) -> bool:
    """Whether a call on `x` takes its hand-written kernel: always for impl
    "cuda" (a ValueError on a CPU tensor), on a CUDA tensor for "auto",
    never for "torch". Otherwise the caller runs its own plain version."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {x.device}")
    return impl == "cuda" or (impl == "auto" and x.is_cuda)


def scalar_tensor(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """x as a 0-dim tensor on `device`. A Python number is filled in place on
    the device: `torch.tensor(x, device="cuda")` copies from pageable host
    memory, which synchronizes the stream and stops the host from running
    ahead of the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=device)
