"""Full-image dataset cache (port of `splat_tpu/data/dataset.py`).

3DGS trains on whole images, one (camera, image) pair per step, with all
images of a split cached up front as one (N, H, W, 3) float32 array in [0, 1]
on the host; the trainer moves the stacks to its device. Files are decoded by
the first decoder that serves: the native multithreaded PNG decoder
(`native_loader`, needs g++ and zlib), PIL where it imports, then `png.py`.
`ImageCache.decoder` says which one did ("native", "pil", "png"; "arrays" for
a cache built from an array).
"""
from __future__ import annotations

import time

import numpy as np

from .dataparser import ParsedScene

_DISTORTION_KEYS = ("k1", "k2", "p1", "p2", "k3")


def _have_pil() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def _load_image(path: str, downscale: int, distortion: dict | None,
                decoder: str) -> np.ndarray:
    """One image as (H, W, 3) float32 in [0, 1], decoded by "pil" or "png"."""
    if decoder == "pil":
        from PIL import Image

        img = Image.open(path)
        if downscale != 1:
            img = img.resize((img.width // downscale, img.height // downscale), Image.BILINEAR)
        arr = np.asarray(img, dtype=np.float32) / 255.0
    else:
        from . import png

        if downscale != 1:
            raise ValueError(
                f"{path}: downscale {downscale} needs the native decoder or PIL (the "
                "pure-Python PNG reader has no counterpart of PIL's bilinear resize)")
        arr = png.read_png(path).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.shape[-1] == 2:      # grey + alpha
        arr = np.repeat(arr[..., :1], 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]  # drop alpha (white-composite handled upstream if needed)
    if distortion and any(abs(distortion.get(k, 0.0)) > 1e-12 for k in _DISTORTION_KEYS):
        arr = _undistort(arr, distortion)
    return arr


def _undistort(arr: np.ndarray, distortion: dict) -> np.ndarray:
    """Brown-Conrady undistortion via OpenCV (intrinsics supplied in `distortion`)."""
    K = distortion.get("K")
    if K is None:
        return arr  # no intrinsics provided for undistortion; pass through
    import cv2

    d = np.array([distortion.get(k, 0.0) for k in _DISTORTION_KEYS], dtype=np.float64)
    out = cv2.undistort((arr * 255).astype(np.uint8), np.asarray(K), d)
    return out.astype(np.float32) / 255.0


class ImageCache:
    """All images of a split as one (N, H, W, 3) float32 array.

    `ImageCache(paths, downscale, distortion)` decodes files with the first
    decoder that serves. `decoder` forces one of "native", "pil", "png": it is
    there for the tests and for timing one decoder against another; no
    training path sets it.
    `ImageCache.from_arrays(images, paths)` wraps a stack that already exists."""

    def __init__(self, paths: list[str], downscale: int = 1, distortion: dict | None = None,
                 decoder: str | None = None):
        if decoder not in (None, "native", "pil", "png"):
            raise ValueError(f"unknown decoder {decoder!r}")
        t0 = time.perf_counter()
        native = None
        needs_undistort = bool(distortion) and any(
            abs(distortion.get(k, 0.0) or 0.0) > 1e-12 for k in _DISTORTION_KEYS)
        if (decoder in (None, "native") and paths and not needs_undistort
                and all(str(p).endswith(".png") for p in paths)):
            from . import native_loader

            native = native_loader.load_images(paths, downscale)
        if decoder == "native" and native is None:
            raise RuntimeError("the native PNG decoder is not available for these files")
        if native is not None:
            self.images = native
            self.decoder = "native"
        else:
            self.decoder = decoder or ("pil" if _have_pil() else "png")
            imgs = [_load_image(p, downscale, distortion, self.decoder) for p in paths]
            shapes = {im.shape for im in imgs}
            if len(shapes) > 1:
                raise ValueError(f"inconsistent image shapes in split: {shapes}")
            self.images = np.stack(imgs) if imgs else np.zeros((0, 0, 0, 3), np.float32)
        self.paths = list(paths)
        self.decode_seconds = time.perf_counter() - t0

    @classmethod
    def from_arrays(cls, images: np.ndarray, paths: list[str] | None = None) -> "ImageCache":
        """A cache around an (N, H, W, 3) stack in [0, 1]; no file is read."""
        images = np.asarray(images, dtype=np.float32)
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected an (N, H, W, 3) image stack, got {images.shape}")
        self = cls.__new__(cls)
        self.images = images
        self.paths = list(paths) if paths is not None else [
            f"frame_{i:05d}" for i in range(len(images))]
        if len(self.paths) != len(images):
            raise ValueError(f"{len(self.paths)} paths for {len(images)} images")
        self.decoder = "arrays"
        self.decode_seconds = 0.0
        return self

    def __len__(self) -> int:
        return len(self.paths)


def load_scene_images(scene: ParsedScene) -> tuple[ImageCache, ImageCache]:
    d = scene.metadata.get("downscale_factor", 1)
    dist = scene.metadata.get("distortion")
    return (
        ImageCache(scene.train_paths, d, dist),
        ImageCache(scene.eval_paths, d, dist),
    )
