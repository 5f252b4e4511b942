"""Frozen copy of `splat_tpu_torch/ops/ssim.py` at commit 49129b2, the
benchmark's plain reference; the program's copy may change, this one does not.

SSIM and PSNR (port of `splat_tpu/ops/ssim.py`).

Wang et al.'s SSIM with an 11x11 Gaussian window, sigma 1.5, K1 0.01, K2
0.03, over valid windows only, as torchmetrics' defaults and the JAX package
compute it. The window is separable: two depthwise 1-D convolutions.

The convolutions must stay in full float32: blur(x^2) - blur(x)^2 cancels to
~1e-6 for flat windows, so TF32 rounding (cuDNN's default for float32
convolutions on CUDA) would drive the variances through zero. The blur is an
autograd Function that runs only forward convolutions, with cuDNN's TF32 off,
in both directions: the gradient of a valid correlation with a symmetric
kernel is the fully padded correlation with the same kernel. So the backward
never reaches cuDNN's backward-data algorithms, some of which accumulate with
atomics.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _full_fp32_conv():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _window(window_size: int, sigma: float, like: torch.Tensor) -> torch.Tensor:
    half = window_size // 2
    x = torch.arange(window_size, dtype=like.dtype, device=like.device) - half
    w = torch.exp(-0.5 * (x / sigma) ** 2)
    return w / w.sum()


def _separable(x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """Depthwise correlation of (1, C, H, W) with w along H, then along W."""
    c, k = x.shape[1], w.shape[0]
    with _full_fp32_conv():
        x = F.conv2d(x, w.reshape(1, 1, k, 1).expand(c, 1, k, 1), padding=(pad, 0), groups=c)
        return F.conv2d(x, w.reshape(1, 1, 1, k).expand(c, 1, 1, k), padding=(0, pad), groups=c)


class _Blur(torch.autograd.Function):
    """Valid separable Gaussian blur; the window is a constant (no gradient)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        return _separable(x, w, 0)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return _separable(g.contiguous(), w, w.shape[0] - 1), None


def _blur(img: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H - k + 1, W - k + 1, C)."""
    x = img.permute(2, 0, 1)[None].contiguous()
    return _Blur.apply(x, w)[0].permute(1, 2, 0)


def ssim_map(img0: torch.Tensor, img1: torch.Tensor, window_size: int = 11,
             sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
             data_range: float = 1.0) -> torch.Tensor:
    """Per-window SSIM, (H - w + 1, W - w + 1, C), for (H, W, C) images."""
    if img0.ndim != 3:
        raise ValueError(f"expected (H, W, C) images, got {tuple(img0.shape)}")
    w = _window(window_size, sigma, img0)
    mu0, mu1 = _blur(img0, w), _blur(img1, w)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    # clamp tiny negative rounding-noise variances so the stabilised
    # denominator stays >= c1 * c2 (true variances are nonnegative);
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    zero = img0.new_zeros(())
    s00 = torch.maximum(_blur(img0 * img0, w) - mu00, zero)
    s11 = torch.maximum(_blur(img1 * img1, w) - mu11, zero)
    s01 = _blur(img0 * img1, w) - mu01
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu01 + c1) * (2 * s01 + c2)
    den = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    return num / den


def ssim(img0: torch.Tensor, img1: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair."""
    return ssim_map(img0, img1, window_size, sigma, k1, k2, data_range).mean()


def psnr(img0: torch.Tensor, img1: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((img0 - img1) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))
