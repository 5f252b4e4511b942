"""Image stacks (port of `ImageCache` of `splat_tpu/data/dataset.py`).

All images of a split as one (N, H, W, 3) float32 array in [0, 1] beside
their paths. Here a cache is built from an array; the constructor that
decodes image files comes with the data slice.
"""
from __future__ import annotations

import numpy as np


class ImageCache:
    def __init__(self, images: np.ndarray, paths: list[str] | None = None):
        images = np.asarray(images, dtype=np.float32)
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected an (N, H, W, 3) image stack, got {images.shape}")
        self.images = images
        self.paths = list(paths) if paths is not None else [
            f"frame_{i:05d}" for i in range(len(images))]
        if len(self.paths) != len(images):
            raise ValueError(f"{len(self.paths)} paths for {len(images)} images")

    def __len__(self) -> int:
        return len(self.paths)
