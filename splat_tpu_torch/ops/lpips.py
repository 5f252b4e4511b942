"""LPIPS perceptual distance with the AlexNet backbone, in plain PyTorch.

The JAX package's `ops/lpips.py` graph, op for op: inputs scaled to [-1, 1]
and shifted and scaled by LPIPS's ImageNet layer; AlexNet's five
convolutions (ReLU after each, 3x3 max pools of stride 2 after the first
two); each layer's features unit-normalised over channels; the squared
differences weighted by LPIPS's linear heads, summed over channels and
averaged over the image; the five layers summed. The convolutions are
library calls (`F.conv2d`): the JAX package computes them outside any
kernel of its own. TF32 is off for them, as everywhere in the port.

Weights come from an .npz with the JAX package's key contract: AlexNet's
`features.{0,3,6,8,10}.weight` (OIHW) and `.bias`, and the heads
`lin{0..4}.weight` (1, C, 1, 1). It is read from the path in
$SPLAT_TPU_TORCH_LPIPS_WEIGHTS, else from data/lpips_alex.npz in the
repository. `convert_torch_checkpoint` (or `python -m
splat_tpu_torch.ops.lpips convert LPIPS_CKPT OUT.npz`) writes one from the
LPIPS checkpoint and torchvision's AlexNet.

`lpips` and `lpips_batch` return None when no weights file is configured
(no environment variable and no default file), and only then: a variable
that names a missing file, a file without a key, or any error inside the
graph raises, so that a broken metric never reads as a missing one.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ENV_VAR = "SPLAT_TPU_TORCH_LPIPS_WEIGHTS"
DEFAULT_PATH = Path(__file__).resolve().parents[2] / "data" / "lpips_alex.npz"

# AlexNet's feature trunk: (out channels, kernel, stride, padding) per
# convolution, at torchvision's feature indices; ReLU after each, a 3x3 max
# pool of stride 2 after the first two
_ALEX_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
_CONV_IDX = [0, 3, 6, 8, 10]
_POOL_AFTER = {0, 1}
KEYS = ([f"features.{i}.{p}" for i in _CONV_IDX for p in ("weight", "bias")]
        + [f"lin{k}.weight" for k in range(len(_CONV_IDX))])

# the weights last loaded for each device: device -> ((resolved path,
# mtime_ns, size), tensors)
_WEIGHTS_CACHE: dict[str, tuple[tuple, dict[str, torch.Tensor]]] = {}

# LPIPS's scaling layer, applied to [-1, 1] inputs
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def weights_path() -> Path | None:
    """The weights file in use: the environment variable's (which must
    exist), else the default file if it exists, else None."""
    env = os.environ.get(ENV_VAR)
    if env:
        path = Path(env)
        if not path.is_file():
            raise FileNotFoundError(f"{ENV_VAR}={env}: no such LPIPS weights file")
        return path
    return DEFAULT_PATH if DEFAULT_PATH.is_file() else None


def load_weights(device: str | torch.device = "cpu") -> dict[str, torch.Tensor] | None:
    """The weights as float32 tensors on `device`, or None when no file is
    configured. The file (about 10 MB) is read once for each device and kept
    until another file, or the same one rewritten, is configured; the
    returned tensors are shared and must not be changed. Raises on a file
    that lacks one of the contract's keys."""
    path = weights_path()
    if path is None:
        return None
    stat = path.stat()
    key = (str(path.resolve()), stat.st_mtime_ns, stat.st_size)
    device = torch.device(device)
    cached = _WEIGHTS_CACHE.get(str(device))
    if cached is not None and cached[0] == key:
        return cached[1]
    with np.load(path) as raw:
        missing = [k for k in KEYS if k not in raw.files]
        if missing:
            raise KeyError(f"{path}: LPIPS weights lack {missing}")
        weights = {k: torch.as_tensor(raw[k], dtype=torch.float32).to(device) for k in KEYS}
    _WEIGHTS_CACHE[str(device)] = (key, weights)
    return weights


def _prep(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) in [0, 1] -> (1, 3, H, W) through the scaling layer."""
    shift = torch.tensor(_SHIFT, dtype=torch.float32, device=img.device)
    scale = torch.tensor(_SCALE, dtype=torch.float32, device=img.device)
    x = (img.to(torch.float32) * 2.0 - 1.0 - shift) / scale
    return x.permute(2, 0, 1)[None]


def _alex_features(x: torch.Tensor, weights: dict[str, torch.Tensor]) -> list[torch.Tensor]:
    feats = []
    for k, (idx, (_, _, stride, pad)) in enumerate(zip(_CONV_IDX, _ALEX_CONVS)):
        x = F.relu(F.conv2d(x, weights[f"features.{idx}.weight"], weights[f"features.{idx}.bias"],
                            stride=stride, padding=pad))
        feats.append(x)
        if k in _POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


@torch.no_grad()
def lpips_pair(img0: torch.Tensor, img1: torch.Tensor,
               weights: dict[str, torch.Tensor]) -> torch.Tensor:
    """The LPIPS distance of two (H, W, 3) images in [0, 1], a 0-d tensor."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        f0 = _alex_features(_prep(img0), weights)
        f1 = _alex_features(_prep(img1), weights)
    total = torch.zeros((), dtype=torch.float32, device=img0.device)
    for k, (a, b) in enumerate(zip(f0, f1)):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        total = total + torch.mean(torch.sum(d * weights[f"lin{k}.weight"], dim=1))
    return total


def lpips(img0, img1) -> float | None:
    """LPIPS of two (H, W, 3) images in [0, 1] (tensors or arrays, on the
    first one's device); None when no weights file is configured."""
    img0 = torch.as_tensor(img0)
    weights = load_weights(img0.device)
    if weights is None:
        return None
    return float(lpips_pair(img0, torch.as_tensor(img1, device=img0.device), weights))


def lpips_batch(preds, gts) -> float | None:
    """The mean LPIPS over image pairs; None when no weights file is
    configured (or there are no pairs)."""
    preds = [torch.as_tensor(p) for p in preds]
    if not preds:
        return None
    weights = load_weights(preds[0].device)
    if weights is None:
        return None
    vals = [float(lpips_pair(p, torch.as_tensor(g, device=p.device), weights))
            for p, g in zip(preds, gts)]
    return float(np.mean(vals))


def convert_torch_checkpoint(lpips_ckpt: str, out_npz: str,
                             alexnet_state: str | dict | None = None) -> None:
    """Pack AlexNet's feature trunk and LPIPS's linear heads into the .npz
    contract above. The trunk comes from `alexnet_state` (a state dict with
    torchvision's keys, or its path), or when None from torchvision's
    pretrained AlexNet (torchvision and its cached weights needed)."""
    out = {}
    if alexnet_state is None:
        import torchvision

        alex = torchvision.models.alexnet(weights="IMAGENET1K_V1").features
        for idx in _CONV_IDX:
            out[f"features.{idx}.weight"] = alex[idx].weight.detach().numpy()
            out[f"features.{idx}.bias"] = alex[idx].bias.detach().numpy()
    else:
        if isinstance(alexnet_state, (str, Path)):
            alexnet_state = torch.load(alexnet_state, map_location="cpu")
        for idx in _CONV_IDX:
            for part in ("weight", "bias"):
                key = f"features.{idx}.{part}"
                out[key] = torch.as_tensor(alexnet_state[key]).detach().numpy()
    lin = torch.load(lpips_ckpt, map_location="cpu")
    for k in range(len(_CONV_IDX)):
        out[f"lin{k}.weight"] = lin[f"lin{k}.model.1.weight"].detach().numpy()
    np.savez(out_npz, **out)


def random_weights(seed: int = 0) -> dict[str, np.ndarray]:
    """Weights of the contract's shapes drawn from a seed (He-scaled
    convolutions, small positive biases, non-negative heads): what the tests
    and `chip_smoke.py` check the graph with, as no pretrained file ships."""
    rng = np.random.default_rng(seed)
    out, c_in = {}, 3
    for k, (idx, (c_out, ks, _, _)) in enumerate(zip(_CONV_IDX, _ALEX_CONVS)):
        std = np.sqrt(2.0 / (c_in * ks * ks))
        out[f"features.{idx}.weight"] = (rng.standard_normal((c_out, c_in, ks, ks)) * std
                                         ).astype(np.float32)
        out[f"features.{idx}.bias"] = rng.uniform(0.0, 0.1, c_out).astype(np.float32)
        out[f"lin{k}.weight"] = rng.uniform(0.0, 1.0 / c_out, (1, c_out, 1, 1)).astype(np.float32)
        c_in = c_out
    return out


if __name__ == "__main__":
    import sys

    if len(sys.argv) == 4 and sys.argv[1] == "convert":
        convert_torch_checkpoint(sys.argv[2], sys.argv[3])
    else:
        print(__doc__)
