"""Projection and SH colour of every Gaussian slot in one pass, forward and
analytic backward (`csrc/project_sh.cu`).

`project_sh` computes what the plain route of `models/splatfacto.py:
subframe_inputs` computes at one sub-frame pose (Rt, pt):
`projection.project_gaussians(means, exp(scales_log), quats, Rt^T, -(Rt^T @
pt), ...)` and `sh_eval_switch(degree_active, D, normalize(means - pt),
cat([features_dc, features_rest]))`, with D the highest degree that
features_rest holds. It reads features_dc and features_rest in place (no
(N, 16, 3) concatenation) and saves only its inputs for the backward, which
recomputes the forward's intermediates.

The camera enters as one (22,) vector (`camera_vector`): Rt row-major, pt,
lin_vel, ang_vel, fx, fy, cx, cy. Its gradient covers the first 18 entries;
the intrinsics are constants here (a caller that differentiates them takes
the plain route).

On CUDA tensors the forward and backward are the two kernels (each wrapper
counts its launches); on CPU tensors `project_sh_fwd_plain` and
`project_sh_bwd_plain`, the same closed form in plain PyTorch, operation for
operation in the kernels' order, in any float dtype.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from ...utils.profiling import span
from ..projection import COV2D_DILATION, DEFAULT_CLIP_THRESH, ProjectedGaussians
from . import build

BLOCK = 128            # Gaussians a block, as in csrc/project_sh.cu
NCAM = 22              # the camera vector
NCAM_GRAD = 18         # its entries with a gradient: Rt, pt, lin_vel, ang_vel
# features_rest's rows a Gaussian -> the highest SH degree
REST_ROWS_DEGREE = {0: 0, 3: 1, 8: 2, 15: 3}

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def camera_vector(R_c2w: torch.Tensor, p_c2w: torch.Tensor, lin_vel: torch.Tensor,
                  ang_vel: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """The (22,) camera vector of one sub-frame pose: R_c2w (3, 3) row-major,
    p_c2w, lin_vel, ang_vel (3,) each, then the intrinsics (0-d or (1,)
    tensors). One concatenation; its backward hands each piece its slice."""
    return torch.cat([R_c2w.reshape(9), p_c2w.reshape(3), lin_vel.reshape(3),
                      ang_vel.reshape(3), fx.reshape(1), fy.reshape(1), cx.reshape(1),
                      cy.reshape(1)])


def _sh_degree(features_rest: torch.Tensor) -> int:
    rows = features_rest.shape[1]
    if rows not in REST_ROWS_DEGREE:
        raise ValueError(f"features_rest has {rows} rows a Gaussian; SH degrees 0-3 have "
                         f"{sorted(REST_ROWS_DEGREE)}")
    return REST_ROWS_DEGREE[rows]


def _clamp_min(v, lo):
    return torch.where(v < lo, torch.full_like(v, lo), v)


def _terms(means, scales_log, quats, cam, img_w: int, img_h: int, use_vel: bool):
    """The forward's per-Gaussian intermediates, in the kernel's order."""
    t = SimpleNamespace()
    R = [[cam[j * 3 + k] for j in range(3)] for k in range(3)]   # R_cw = Rt^T
    pt = [cam[9 + k] for k in range(3)]
    v = [cam[12 + k] for k in range(3)]
    w = [cam[15 + k] for k in range(3)]
    fx, fy = cam[18], cam[19]
    t.R, t.pt, t.v, t.w, t.fx, t.fy, t.cx, t.cy = R, pt, v, w, fx, fy, cam[20], cam[21]
    tc = [-(R[k][0] * pt[0] + R[k][1] * pt[1] + R[k][2] * pt[2]) for k in range(3)]
    t.lim_x = 1.3 * ((1.0 / fx) * (0.5 * img_w))
    t.lim_y = 1.3 * ((1.0 / fy) * (0.5 * img_h))

    t.m = [means[:, k] for k in range(3)]
    t.s = [torch.exp(scales_log[:, k]) for k in range(3)]
    t.q = [quats[:, k] for k in range(4)]
    t.x, t.y, t.z = (R[k][0] * t.m[0] + R[k][1] * t.m[1] + R[k][2] * t.m[2] + tc[k]
                     for k in range(3))
    t.in_front = t.z > DEFAULT_CLIP_THRESH
    t.zs = torch.where(t.in_front, t.z, torch.ones_like(t.z))

    q = t.q
    t.qnorm = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    t.qden = _clamp_min(t.qnorm, 1e-12)
    t.qn = [q[k] / t.qden for k in range(4)]
    qw, qx, qy, qz = t.qn
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    t.Rq = [[1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)],
            [2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)],
            [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)]]
    t.M = [[t.Rq[r][j] * t.s[j] for j in range(3)] for r in range(3)]
    t.P = [[R[k][0] * t.M[0][j] + R[k][1] * t.M[1][j] + R[k][2] * t.M[2][j] for j in range(3)]
           for k in range(3)]
    P = t.P

    def cov(k, l):
        return P[k][0] * P[l][0] + P[k][1] * P[l][1] + P[k][2] * P[l][2]

    t.c00, t.c01, t.c02, t.c11, t.c12, t.c22 = (cov(0, 0), cov(0, 1), cov(0, 2), cov(1, 1),
                                                cov(1, 2), cov(2, 2))
    t.vx = t.x / t.zs
    t.ux = torch.maximum(t.vx, -t.lim_x)
    t.wx = torch.minimum(t.ux, t.lim_x)
    t.tx = t.zs * t.wx
    t.vy = t.y / t.zs
    t.uy = torch.maximum(t.vy, -t.lim_y)
    t.wy = torch.minimum(t.uy, t.lim_y)
    t.ty = t.zs * t.wy
    t.inv_z = 1.0 / t.zs
    t.inv_z2 = t.inv_z * t.inv_z
    t.j00 = fx * t.inv_z
    t.j02 = -fx * t.tx * t.inv_z2
    t.j11 = fy * t.inv_z
    t.j12 = -fy * t.ty * t.inv_z2
    t.A0 = t.j00 * t.c00 + t.j02 * t.c02
    t.A1 = t.j00 * t.c02 + t.j02 * t.c22
    t.a = t.j00 * t.A0 + t.j02 * t.A1
    t.B0 = t.j11 * t.c01 + t.j12 * t.c02
    t.B1 = t.j11 * t.c12 + t.j12 * t.c22
    t.b = t.j00 * t.B0 + t.j02 * t.B1
    t.C0 = t.j11 * t.c11 + t.j12 * t.c12
    t.C1 = t.j11 * t.c12 + t.j12 * t.c22
    t.c = t.j11 * t.C0 + t.j12 * t.C1
    t.det_orig = t.a * t.c - t.b * t.b
    t.a_d = t.a + COV2D_DILATION
    t.c_d = t.c + COV2D_DILATION
    t.det = t.a_d * t.c_d - t.b * t.b
    t.det_ok = t.det > 1e-12
    t.det_safe = torch.where(t.det_ok, t.det, torch.ones_like(t.det))
    t.u = _clamp_min(t.det_orig, 0.0) / t.det_safe
    t.comp_raw = torch.sqrt(t.u)
    t.inv_det = 1.0 / t.det_safe
    t.valid = t.in_front & t.det_ok
    if use_vel:
        cr = [w[1] * t.z - w[2] * t.y, w[2] * t.x - w[0] * t.z, w[0] * t.y - w[1] * t.x]
        t.xd = [-cr[k] - v[k] for k in range(3)]
    # colour direction
    t.d = [t.m[k] - pt[k] for k in range(3)]
    t.dn = torch.sqrt(t.d[0] * t.d[0] + t.d[1] * t.d[1] + t.d[2] * t.d[2])
    t.den = _clamp_min(t.dn, 1e-9)
    t.dir = [t.d[k] / t.den for k in range(3)]
    return t


def _sh_basis(degree: int, x, y, z) -> list:
    B = [torch.full_like(x, _C0)]
    if degree >= 1:
        B += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        B += [_C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy), _C2[3] * xz,
              _C2[4] * (xx - yy)]
        if degree >= 3:
            B += [_C3[0] * y * (3.0 * xx - yy), _C3[1] * xy * z,
                  _C3[2] * y * (4.0 * zz - xx - yy), _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  _C3[4] * x * (4.0 * zz - xx - yy), _C3[5] * z * (xx - yy),
                  _C3[6] * x * (xx - 3.0 * yy)]
    return B


def _sh_basis_vjp(degree: int, x, y, z, g) -> tuple:
    """d/d(x, y, z) of sum_k g[k] B_k(x, y, z)."""
    dx, dy, dz = torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(x)
    if degree >= 1:
        dy = dy + -_C1 * g[1]
        dz = dz + _C1 * g[2]
        dx = dx + -_C1 * g[3]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        dx = dx + _C2[0] * y * g[4]
        dy = dy + _C2[0] * x * g[4]
        dy = dy + _C2[1] * z * g[5]
        dz = dz + _C2[1] * y * g[5]
        dx = dx + -2.0 * _C2[2] * x * g[6]
        dy = dy + -2.0 * _C2[2] * y * g[6]
        dz = dz + 4.0 * _C2[2] * z * g[6]
        dx = dx + _C2[3] * z * g[7]
        dz = dz + _C2[3] * x * g[7]
        dx = dx + 2.0 * _C2[4] * x * g[8]
        dy = dy + -2.0 * _C2[4] * y * g[8]
        if degree >= 3:
            xy, yz, xz = x * y, y * z, x * z
            dx = dx + 6.0 * _C3[0] * xy * g[9]
            dy = dy + 3.0 * _C3[0] * (xx - yy) * g[9]
            dx = dx + _C3[1] * yz * g[10]
            dy = dy + _C3[1] * xz * g[10]
            dz = dz + _C3[1] * xy * g[10]
            dx = dx + -2.0 * _C3[2] * xy * g[11]
            dy = dy + _C3[2] * (4.0 * zz - xx - 3.0 * yy) * g[11]
            dz = dz + 8.0 * _C3[2] * yz * g[11]
            dx = dx + -6.0 * _C3[3] * xz * g[12]
            dy = dy + -6.0 * _C3[3] * yz * g[12]
            dz = dz + _C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * g[12]
            dx = dx + _C3[4] * (4.0 * zz - 3.0 * xx - yy) * g[13]
            dy = dy + -2.0 * _C3[4] * xy * g[13]
            dz = dz + 8.0 * _C3[4] * xz * g[13]
            dx = dx + 2.0 * _C3[5] * xz * g[14]
            dy = dy + -2.0 * _C3[5] * yz * g[14]
            dz = dz + _C3[5] * (xx - yy) * g[14]
            dx = dx + 3.0 * _C3[6] * (xx - yy) * g[15]
            dy = dy + -6.0 * _C3[6] * xy * g[15]
    return dx, dy, dz


def _masked_basis(t, degree: int, degree_active):
    """The basis at the colour direction with the bands above the active
    degree masked (multiplied by 0, as `sh_eval_switch` does), and the masks."""
    B = _sh_basis(degree, *t.dir)
    n_active = (degree_active + 1) ** 2
    mask = [torch.as_tensor(k < n_active).to(B[0].dtype) for k in range(len(B))]
    return [B[k] * mask[k] for k in range(len(B))], mask


def _sh_out(Bm, features_dc, features_rest):
    """SH + 0.5 before the clamp, per channel, summed over the bases in order."""
    out = []
    for ch in range(3):
        acc = Bm[0] * features_dc[:, ch]
        for k in range(1, len(Bm)):
            acc = acc + Bm[k] * features_rest[:, k - 1, ch]
        out.append(acc)
    return out


def project_sh_fwd_plain(means, scales_log, quats, features_dc, features_rest, cam,
                         degree_active, img_w: int, img_h: int, use_vel: bool) -> tuple:
    """The kernel's forward in plain PyTorch: (means2d, depths, conics, radii,
    compensations, pix_vels, valid, extents, colors), the first eight as in
    `ProjectedGaussians`."""
    degree = _sh_degree(features_rest)
    t = _terms(means, scales_log, quats, cam, img_w, img_h, use_vel)
    zero = torch.zeros((), dtype=means.dtype, device=means.device)
    conics = torch.stack([t.c_d * t.inv_det, -t.b * t.inv_det, t.a_d * t.inv_det], dim=-1)
    mid = 0.5 * (t.a_d + t.c_d)
    lam1 = mid + torch.sqrt(_clamp_min(mid * mid - t.det, 0.01))
    radii = torch.ceil(3.0 * torch.sqrt(_clamp_min(lam1, 0.0)))
    ext = [torch.ceil(3.0 * torch.sqrt(_clamp_min(e, 0.0))) for e in (t.a_d, t.c_d)]
    means2d = torch.stack([t.fx * t.x * t.inv_z + t.cx, t.fy * t.y * t.inv_z + t.cy], dim=-1)
    if use_vel:
        pv = torch.stack([t.j00 * t.xd[0] + t.j02 * t.xd[2],
                          t.j11 * t.xd[1] + t.j12 * t.xd[2]], dim=-1)
        pix_vels = torch.where(t.valid[:, None], pv, zero)
    else:
        pix_vels = torch.zeros_like(means2d)
    Bm, _ = _masked_basis(t, degree, degree_active)
    out = _sh_out(Bm, features_dc, features_rest)
    colors = torch.stack([_clamp_min(o + 0.5, 0.0) for o in out], dim=-1)
    return (means2d, t.z, conics, torch.where(t.valid, radii, zero),
            torch.where(t.valid, t.comp_raw, zero), pix_vels, t.valid,
            torch.where(t.valid[:, None], torch.stack(ext, dim=-1), zero), colors)


def _tie_factor(v, bound, below: bool):
    """torch.maximum(v, bound)'s (below) or torch.minimum's gradient factor:
    1 where v is taken, 0.5 at a tie, 0 where the bound is."""
    lost = v < bound if below else v > bound
    return torch.where(v == bound, 0.5, torch.where(lost, 0.0, 1.0)).to(v.dtype)


def project_sh_bwd_plain(means, scales_log, quats, features_dc, features_rest, cam,
                         degree_active, img_w: int, img_h: int, use_vel: bool,
                         grads: tuple, needs: tuple = (True,) * 6) -> tuple:
    """The kernel's backward in plain PyTorch. grads: the cotangents of
    (means2d, depths, conics, compensations, pix_vels, colors). Returns the
    gradients of (means, scales_log, quats, features_dc, features_rest, cam),
    None where `needs` says no; the camera's as a (22,) vector."""
    g_m2, g_z, g_con, g_comp, g_pv, g_rgb = grads
    degree = _sh_degree(features_rest)
    t = _terms(means, scales_log, quats, cam, img_w, img_h, use_vel)
    zero = torch.zeros((), dtype=means.dtype, device=means.device)
    R, fx, fy = t.R, t.fx, t.fy

    # colour
    Bm, mask = _masked_basis(t, degree, degree_active)
    out = _sh_out(Bm, features_dc, features_rest)
    go = [torch.where(out[ch] + 0.5 >= 0.0, g_rgb[:, ch], zero) for ch in range(3)]
    coef = [features_dc] + [features_rest[:, k - 1] for k in range(1, len(Bm))]
    dB = [(go[0] * coef[k][:, 0] + go[1] * coef[k][:, 1] + go[2] * coef[k][:, 2])
          * (1.0 if k == 0 else mask[k]) for k in range(len(Bm))]
    d_fdc = torch.stack([Bm[0] * go[ch] for ch in range(3)], dim=-1)
    d_frest = (torch.stack([torch.stack([Bm[k] * go[ch] for ch in range(3)], dim=-1)
                            for k in range(1, len(Bm))], dim=1)
               if len(Bm) > 1 else torch.zeros_like(features_rest))
    ddir = _sh_basis_vjp(degree, *t.dir, dB)
    dd = [ddir[k] / t.den for k in range(3)]
    d_den = sum(-ddir[k] * (t.dir[k] / t.den) for k in range(3))
    d_dn = torch.where(t.dn >= 1e-9, d_den, zero)
    d_scale = torch.where(t.dn == 0.0, zero, d_dn / t.dn)
    dd = [dd[k] + t.d[k] * d_scale for k in range(3)]

    # projected outputs
    gcomp = torch.where(t.valid, g_comp, zero)
    dp = [torch.zeros_like(t.z), torch.zeros_like(t.z), g_z]
    d_j00 = d_j02 = d_j11 = d_j12 = d_inv_z = torch.zeros_like(t.z)
    dv = dw = [torch.zeros_like(t.z)] * 3
    if use_vel:
        gpx = torch.where(t.valid, g_pv[:, 0], zero)
        gpy = torch.where(t.valid, g_pv[:, 1], zero)
        d_j00 = d_j00 + gpx * t.xd[0]
        d_j02 = d_j02 + gpx * t.xd[2]
        d_j11 = d_j11 + gpy * t.xd[1]
        d_j12 = d_j12 + gpy * t.xd[2]
        dxd = [gpx * t.j00, gpy * t.j11, gpx * t.j02 + gpy * t.j12]
        dv = [-dxd[k] for k in range(3)]
        dw = [dxd[1] * t.z - dxd[2] * t.y, dxd[2] * t.x - dxd[0] * t.z,
              dxd[0] * t.y - dxd[1] * t.x]
        w = t.w
        dp = [dp[0] + (w[1] * dxd[2] - w[2] * dxd[1]), dp[1] + (w[2] * dxd[0] - w[0] * dxd[2]),
              dp[2] + (w[0] * dxd[1] - w[1] * dxd[0])]
    dp[0] = dp[0] + g_m2[:, 0] * t.inv_z * fx
    dp[1] = dp[1] + g_m2[:, 1] * t.inv_z * fy
    d_inv_z = d_inv_z + (g_m2[:, 0] * (fx * t.x) + g_m2[:, 1] * (fy * t.y))

    du = gcomp / (2.0 * t.comp_raw)
    d_cl = du / t.det_safe
    d_det_safe = -du * (t.u / t.det_safe)
    d_det_orig = torch.where(t.det_orig >= 0.0, d_cl, zero)
    gca, gcb, gcc = g_con[:, 0], g_con[:, 1], g_con[:, 2]
    d_inv_det = gca * t.c_d + gcb * (-t.b) + gcc * t.a_d
    d_c_d = gca * t.inv_det
    d_b = -(gcb * t.inv_det)
    d_a_d = gcc * t.inv_det
    d_det_safe = d_det_safe + d_inv_det * -(t.inv_det * t.inv_det)
    d_det = torch.where(t.det_ok, d_det_safe, zero)
    d_a_d = d_a_d + d_det * t.c_d
    d_c_d = d_c_d + d_det * t.a_d
    d_b = d_b + -2.0 * t.b * d_det
    da = d_det_orig * t.c + d_a_d
    dcc = d_det_orig * t.a + d_c_d
    db = d_b + -2.0 * t.b * d_det_orig

    dA0, dA1 = da * t.j00, da * t.j02
    dB0, dB1 = db * t.j00, db * t.j02
    dC0, dC1 = dcc * t.j11, dcc * t.j12
    d_j00 = d_j00 + (da * t.A0 + dA0 * t.c00 + dA1 * t.c02 + db * t.B0)
    d_j02 = d_j02 + (da * t.A1 + dA0 * t.c02 + dA1 * t.c22 + db * t.B1)
    d_j11 = d_j11 + (dB0 * t.c01 + dB1 * t.c12 + dcc * t.C0 + dC0 * t.c11 + dC1 * t.c12)
    d_j12 = d_j12 + (dB0 * t.c02 + dB1 * t.c22 + dcc * t.C1 + dC0 * t.c12 + dC1 * t.c22)
    dc00 = dA0 * t.j00
    dc01 = dB0 * t.j11
    dc02 = dA0 * t.j02 + dA1 * t.j00 + dB0 * t.j12
    dc11 = dC0 * t.j11
    dc12 = dB1 * t.j11 + dC0 * t.j12 + dC1 * t.j11
    dc22 = dA1 * t.j02 + dB1 * t.j12 + dC1 * t.j12

    d_inv_z = d_inv_z + (d_j00 * fx + d_j11 * fy)
    d_tx = d_j02 * t.inv_z2 * (-fx)
    d_ty = d_j12 * t.inv_z2 * (-fy)
    d_inv_z2 = d_j02 * (-fx * t.tx) + d_j12 * (-fy * t.ty)
    d_inv_z = d_inv_z + 2.0 * t.inv_z * d_inv_z2
    d_zs = -d_inv_z * (t.inv_z * t.inv_z)
    d_zs = d_zs + (d_tx * t.wx + d_ty * t.wy)
    d_vx = (d_tx * t.zs * _tie_factor(t.ux, t.lim_x, below=False)
            * _tie_factor(t.vx, -t.lim_x, below=True))
    d_vy = (d_ty * t.zs * _tie_factor(t.uy, t.lim_y, below=False)
            * _tie_factor(t.vy, -t.lim_y, below=True))
    dp[0] = dp[0] + d_vx / t.zs
    dp[1] = dp[1] + d_vy / t.zs
    d_zs = d_zs + (-d_vx * (t.vx / t.zs) - d_vy * (t.vy / t.zs))
    dp[2] = dp[2] + torch.where(t.in_front, d_zs, zero)

    P, M = t.P, t.M
    Gs = [[2.0 * dc00, dc01, dc02], [dc01, 2.0 * dc11, dc12], [dc02, dc12, 2.0 * dc22]]
    dP = [[Gs[k][0] * P[0][j] + Gs[k][1] * P[1][j] + Gs[k][2] * P[2][j] for j in range(3)]
          for k in range(3)]
    dM = [[R[0][r] * dP[0][j] + R[1][r] * dP[1][j] + R[2][r] * dP[2][j] for j in range(3)]
          for r in range(3)]
    dm = [R[0][j] * dp[0] + R[1][j] * dp[1] + R[2][j] * dp[2] + dd[j] for j in range(3)]

    res = [None] * 6
    if needs[0]:
        res[0] = torch.stack(dm, dim=-1)
    dRq = [[dM[r][j] * t.s[j] for j in range(3)] for r in range(3)]
    if needs[1]:
        res[1] = torch.stack([(dM[0][j] * t.Rq[0][j] + dM[1][j] * t.Rq[1][j]
                               + dM[2][j] * t.Rq[2][j]) * t.s[j] for j in range(3)], dim=-1)
    if needs[2]:
        qw, qx, qy, qz = t.qn
        dqn = [
            2.0 * (-qz * dRq[0][1] + qy * dRq[0][2] + qz * dRq[1][0] - qx * dRq[1][2]
                   - qy * dRq[2][0] + qx * dRq[2][1]),
            2.0 * (qy * dRq[0][1] + qz * dRq[0][2] + qy * dRq[1][0] - 2.0 * qx * dRq[1][1]
                   - qw * dRq[1][2] + qz * dRq[2][0] + qw * dRq[2][1] - 2.0 * qx * dRq[2][2]),
            2.0 * (-2.0 * qy * dRq[0][0] + qx * dRq[0][1] + qw * dRq[0][2] + qx * dRq[1][0]
                   + qz * dRq[1][2] - qw * dRq[2][0] + qz * dRq[2][1] - 2.0 * qy * dRq[2][2]),
            2.0 * (-2.0 * qz * dRq[0][0] - qw * dRq[0][1] + qx * dRq[0][2] + qw * dRq[1][0]
                   - 2.0 * qz * dRq[1][1] + qy * dRq[1][2] + qx * dRq[2][0] + qy * dRq[2][1]),
        ]
        d_qden = sum(-dqn[k] * (t.qn[k] / t.qden) for k in range(4))
        d_qnorm = torch.where(t.qnorm >= 1e-12, d_qden, zero)
        q_scale = torch.where(t.qnorm == 0.0, zero, d_qnorm / t.qnorm)
        res[2] = torch.stack([dqn[k] / t.qden + t.q[k] * q_scale for k in range(4)], dim=-1)
    if needs[3]:
        res[3] = d_fdc
    if needs[4]:
        res[4] = d_frest
    if needs[5]:
        cols = [None] * NCAM_GRAD
        for k in range(3):
            for j in range(3):
                cols[j * 3 + k] = dp[k] * (t.m[j] - t.pt[j]) + (
                    dP[k][0] * M[j][0] + dP[k][1] * M[j][1] + dP[k][2] * M[j][2])
        for j in range(3):
            cols[9 + j] = -(R[0][j] * dp[0] + R[1][j] * dp[1] + R[2][j] * dp[2]) - dd[j]
            cols[12 + j] = dv[j]
            cols[15 + j] = dw[j]
        d_cam = torch.zeros(NCAM, dtype=means.dtype, device=means.device)
        d_cam[:NCAM_GRAD] = torch.stack(cols, dim=-1).sum(dim=0)
        res[5] = d_cam
    return tuple(res)


def _check_inputs(tensors: dict, cam: torch.Tensor, n_rest: int) -> None:
    dev = cam.device
    for name, t in tensors.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"project_sh kernel needs CUDA tensors on one device, got "
                             f"{name} on {t.device} and cam on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"project_sh wants float32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"project_sh wants a contiguous {name}")
    n = tensors["means"].shape[0]
    want = {"means": (n, 3), "scales_log": (n, 3), "quats": (n, 4), "features_dc": (n, 3),
            "features_rest": (n, n_rest, 3), "cam": (NCAM,)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"project_sh wants {name} {shape}, got "
                             f"{tuple(tensors[name].shape)}")
    if n >= 2 ** 31 - BLOCK:
        raise ValueError(f"project_sh supports fewer than 2^31 Gaussians, got {n}")


def _degree_args(degree_active, device):
    """(pointer or None, value, tensor kept alive) for the kernels' degree."""
    if torch.is_tensor(degree_active):
        t = degree_active.to(device=device, dtype=torch.int64).reshape(())
        return t.data_ptr(), 0, t
    return None, int(degree_active), None


_F = ctypes.c_void_p
_I = ctypes.c_int


def project_sh_fwd(means, scales_log, quats, features_dc, features_rest, cam, degree_active,
                   img_w: int, img_h: int, use_vel: bool) -> tuple:
    """The forward kernel (CUDA tensors only): project_sh_fwd_plain's outputs."""
    n_rest = features_rest.shape[1]
    _sh_degree(features_rest)
    _check_inputs({"means": means, "scales_log": scales_log, "quats": quats,
                   "features_dc": features_dc, "features_rest": features_rest, "cam": cam},
                  cam, n_rest)
    n, dev = means.shape[0], means.device
    f = dict(dtype=torch.float32, device=dev)
    means2d, depths = torch.empty((n, 2), **f), torch.empty((n,), **f)
    conics, radii, comps = torch.empty((n, 3), **f), torch.empty((n,), **f), torch.empty((n,), **f)
    pix_vels, extents = torch.empty((n, 2), **f), torch.empty((n, 2), **f)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    colors = torch.empty((n, 3), **f)
    deg_ptr, deg_val, _keep = _degree_args(degree_active, dev)
    fn = build.entry("project_sh", "project_sh_fwd_f32",
                     [_F] * 7 + [_I] * 6 + [_F] * 9 + [_F])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.count_launch(project_sh_fwd)
        build.check(fn(means.data_ptr(), scales_log.data_ptr(), quats.data_ptr(),
                       features_dc.data_ptr(), features_rest.data_ptr(), cam.data_ptr(),
                       deg_ptr, deg_val, n, n_rest, img_w, img_h, int(use_vel),
                       means2d.data_ptr(), depths.data_ptr(), conics.data_ptr(),
                       radii.data_ptr(), comps.data_ptr(), pix_vels.data_ptr(),
                       valid.data_ptr(), extents.data_ptr(), colors.data_ptr(), stream),
                    "project_sh_fwd")
    return means2d, depths, conics, radii, comps, pix_vels, valid, extents, colors


project_sh_fwd.launches = 0


def project_sh_bwd(means, scales_log, quats, features_dc, features_rest, cam, degree_active,
                   img_w: int, img_h: int, use_vel: bool, grads: tuple,
                   needs: tuple = (True,) * 6) -> tuple:
    """The backward kernels (CUDA tensors only): project_sh_bwd_plain's
    result. The camera's gradient is summed over blocks by a second kernel in
    a fixed order; a gradient `needs` declines is neither written nor
    allocated."""
    n_rest = features_rest.shape[1]
    _sh_degree(features_rest)
    g = {name: t.contiguous() for name, t in zip(
        ("g_means2d", "g_depths", "g_conics", "g_comps", "g_pix_vels", "g_colors"), grads)}
    _check_inputs({"means": means, "scales_log": scales_log, "quats": quats,
                   "features_dc": features_dc, "features_rest": features_rest, "cam": cam,
                   **g}, cam, n_rest)
    n, dev = means.shape[0], means.device
    outs = [torch.empty_like(x) if need else None for x, need in
            zip((means, scales_log, quats, features_dc, features_rest), needs[:5])]
    n_blocks = (n + BLOCK - 1) // BLOCK
    d_cam = partial = None
    if needs[5]:
        d_cam = (torch.empty((NCAM,), dtype=torch.float32, device=dev) if n
                 else torch.zeros((NCAM,), dtype=torch.float32, device=dev))
        partial = torch.empty((NCAM_GRAD * n_blocks,), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    deg_ptr, deg_val, _keep = _degree_args(degree_active, dev)
    fn = build.entry("project_sh", "project_sh_bwd_f32",
                     [_F] * 7 + [_I] * 6 + [_F] * 13 + [_F])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.count_launch(project_sh_bwd)
        build.check(fn(means.data_ptr(), scales_log.data_ptr(), quats.data_ptr(),
                       features_dc.data_ptr(), features_rest.data_ptr(), cam.data_ptr(),
                       deg_ptr, deg_val, n, n_rest, img_w, img_h, int(use_vel),
                       *(t.data_ptr() for t in g.values()), *(ptr(t) for t in outs),
                       ptr(partial), ptr(d_cam), stream), "project_sh_bwd")
    return (*outs, d_cam)


project_sh_bwd.launches = 0


class _ProjectSH(torch.autograd.Function):
    """The pair as one differentiable op. Saved: the inputs (and the active
    degree when it is a tensor); radii, valid and extents carry no gradient."""

    @staticmethod
    def forward(ctx, means, scales_log, quats, features_dc, features_rest, cam, degree_active,
                img_w, img_h, use_vel):
        fwd = project_sh_fwd if means.is_cuda else project_sh_fwd_plain
        outs = fwd(means, scales_log, quats, features_dc, features_rest, cam, degree_active,
                   img_w, img_h, use_vel)
        deg_t = degree_active if torch.is_tensor(degree_active) else None
        ctx.save_for_backward(means, scales_log, quats, features_dc, features_rest, cam, deg_t)
        ctx.cfg = (None if deg_t is not None else degree_active, img_w, img_h, use_vel)
        ctx.mark_non_differentiable(outs[3], outs[6], outs[7])
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    def backward(ctx, g_m2, g_z, g_con, _g_radii, g_comp, g_pv, _g_valid, _g_ext, g_rgb):
        needs = ctx.needs_input_grad[:6]
        if not any(needs):
            return (None,) * 10
        means, scales_log, quats, fdc, frest, cam, deg_t = ctx.saved_tensors
        degree, img_w, img_h, use_vel = ctx.cfg
        if deg_t is not None:
            degree = deg_t
        n = means.shape[0]
        like = {"m2": (n, 2), "z": (n,), "con": (n, 3), "comp": (n,), "pv": (n, 2), "rgb": (n, 3)}
        grads = tuple(g if g is not None else means.new_zeros(shape)
                      for g, shape in zip((g_m2, g_z, g_con, g_comp, g_pv, g_rgb), like.values()))
        with span("splat.project"):
            bwd = project_sh_bwd if means.is_cuda else project_sh_bwd_plain
            res = bwd(means, scales_log, quats, fdc, frest, cam, degree, img_w, img_h, use_vel,
                      grads, needs)
        return (*res, None, None, None, None)


def project_sh(means: torch.Tensor, scales_log: torch.Tensor, quats: torch.Tensor,
               features_dc: torch.Tensor, features_rest: torch.Tensor,
               R_c2w: torch.Tensor, p_c2w: torch.Tensor, fx, fy, cx, cy,
               img_w: int, img_h: int, degree_active,
               lin_vel: torch.Tensor | None = None, ang_vel: torch.Tensor | None = None,
               ) -> tuple[ProjectedGaussians, torch.Tensor]:
    """Projection and SH colour at the sub-frame pose (R_c2w, p_c2w):
    (ProjectedGaussians, colors (N, 3)), through the kernels on CUDA tensors
    and the plain closed form on CPU tensors. lin_vel / ang_vel None: no
    pixel velocities (zeros). degree_active: an int or an integer tensor
    (read on the device)."""
    if any(torch.is_tensor(a) and a.requires_grad for a in (fx, fy, cx, cy)):
        raise NotImplementedError("project_sh takes the intrinsics as constants; "
                                  "differentiate them through the plain route")
    use_vel = lin_vel is not None
    if not use_vel:
        lin_vel = ang_vel = torch.zeros(3, dtype=means.dtype, device=means.device)
    intr = [torch.as_tensor(a, dtype=means.dtype, device=means.device) for a in (fx, fy, cx, cy)]
    cam = camera_vector(R_c2w, p_c2w, lin_vel, ang_vel, *intr)
    outs = _ProjectSH.apply(means, scales_log, quats, features_dc, features_rest, cam,
                            degree_active, int(img_w), int(img_h), use_vel)
    return ProjectedGaussians(*outs[:8]), outs[8]
