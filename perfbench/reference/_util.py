"""Frozen copy of `splat_tpu_torch/device.py:scalar_tensor` at commit 49129b2."""
from __future__ import annotations

import torch


def scalar_tensor(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """x as a 0-dim tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=device)
