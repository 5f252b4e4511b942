"""Frozen copy of `splat_tpu_torch/ops/sh.py` at commit 49129b2, the
benchmark's plain reference; the program's copy may change, this one does not.

Real spherical-harmonics color evaluation, degrees 0..3
(port of `splat_tpu/ops/sh.py`; gsplat's hard-coded real-SH constants)."""
from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)

MAX_SH_DEGREE = 3


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis at unit directions (..., 3) -> (..., (degree+1)**2)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full(x.shape, _C0, dtype=dirs.dtype, device=dirs.device)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def spherical_harmonics(degree: int, dirs: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Raw SH output (..., 3) from dirs (..., 3) and coeffs (..., K, 3),
    K >= (degree+1)^2; only the first (degree+1)^2 bases contribute."""
    basis = eval_sh_basis(degree, dirs)
    n_b = basis.shape[-1]
    return torch.einsum("...k,...kc->...c", basis, coeffs[..., :n_b, :])


def sh_to_rgb(degree: int, dirs: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Splatfacto-style color: clip(SH(dirs) + 0.5, min=0)."""
    return torch.clamp(spherical_harmonics(degree, dirs, coeffs) + 0.5, min=0.0)
