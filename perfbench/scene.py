"""The benchmark's inputs, made from the seed on the device: a scene that both
the program and the reference are handed.

The scene is two textured spheres: an object of radius `inner_radius` at the
origin and a room of radius `room_radius` around it, the cameras between them
on the handheld `shake` trajectory (a look-at orbit with a camera-frame
rotational shake; `splat_tpu_torch/data/synthetic.py:shake_pose_gl`'s
formula). The texture is a seeded colour field: a few low-frequency waves and
sharp steps across seeded planes.

* Gaussians: `alive` of `capacity` slots, alive slots scattered among dead
  ones, flat discs on the two surfaces (density by area), coloured by the
  field at their centres, as a trained scene is: what a trainer resumed
  mid-run holds.
* Target frames: ray-cast on the device from the benchmark's own code (never
  rendered by the program): the field at the first surface hit, averaged in
  linear light over `GT_SAMPLES` (8) times of the exposure, each scanline at its
  own rolling-shutter time, the camera moved by the frame's own velocities
  (the method's first-order model), then gamma-encoded.

Every draw comes from a `torch.Generator` on the device seeded with the run's
seed (host draws from numpy's generator with the same seed), in a few large
calls, so the same seed gives the same scene on the same device.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814
SH_REST = 15                    # degree 3: 16 bases, DC apart
GT_SAMPLES = 8


def full_precision(fn):
    """Run `fn` with TF32 off, whatever the caller has set: the inputs are the
    same for the program, the reference and the reference's control (which
    computes with TF32 on)."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return wrapped


def _seed(seed: int) -> int:
    return int(seed) % (2**63)


def device_generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for one independent stream of the seed."""
    return torch.Generator(device=device).manual_seed(_seed(seed * 1009 + stream))


# --------------------------------------------------------------- trajectory
def _look_at_gl(position, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    z = position - target
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, dtype=np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, position
    return m


def _rotvec_to_matrix(phi: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(phi))
    if th < 1e-12:
        return np.eye(3)
    k = phi / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _matrix_to_rotvec(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = float(np.arccos(cos))
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-9:
        return 0.5 * w
    return th / (2.0 * np.sin(th)) * w


def pose_gl(t: float, traj: dict, offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    """OpenGL c2w at time t: the orbit (radius, height, wobble, period) with
    the camera-frame shake (amp rad, shake_period s), moved by `offset`."""
    a = 2 * np.pi * t / traj["orbit_period"]
    pos = np.array([traj["radius"] * np.cos(a), traj["radius"] * np.sin(a),
                    traj["height"] + traj["wobble"] * np.sin(2.3 * a)]) + np.asarray(offset)
    m = _look_at_gl(pos, np.zeros(3))
    w = 2 * np.pi / traj["shake_period"]
    theta = traj["shake_amp"] * np.array([np.sin(w * t), np.sin(0.83 * w * t + 1.7),
                                          0.35 * np.sin(1.21 * w * t + 3.1)])
    m[:3, :3] = m[:3, :3] @ _rotvec_to_matrix(theta)
    return m


def velocities_gl(t: float, traj: dict, dt: float = 1e-3) -> tuple[np.ndarray, np.ndarray]:
    """Camera-frame linear and angular velocity (OpenGL axes) by central
    differences of the trajectory."""
    m0, m1, mm = pose_gl(t - dt, traj), pose_gl(t + dt, traj), pose_gl(t, traj)
    v = mm[:3, :3].T @ ((m1[:3, 3] - m0[:3, 3]) / (2 * dt))
    w = _matrix_to_rotvec(m0[:3, :3].T @ m1[:3, :3]) / (2 * dt)
    return v, w


_FLIP = np.array([1.0, -1.0, -1.0])


def cameras(sc: dict, indices, sharp: bool = False) -> dict[str, np.ndarray]:
    """Cameras of the frames `indices` (OpenCV c2w, camera-frame velocities,
    intrinsics, exposure and readout) as float64 host arrays. sharp: the
    frame has no motion, no exposure and no readout."""
    traj = sc["trajectory"]
    out = {k: [] for k in ("R_c2w", "p_c2w", "lin_vel", "ang_vel")}
    for i in indices:
        t = i * sc["frame_dt"]
        m = pose_gl(t, traj)
        out["R_c2w"].append(m[:3, :3] * _FLIP)
        out["p_c2w"].append(m[:3, 3])
        v, w = (np.zeros(3), np.zeros(3)) if sharp else velocities_gl(t, traj)
        out["lin_vel"].append(v * _FLIP)
        out["ang_vel"].append(w * _FLIP)
    n = len(indices)
    cams = {k: np.asarray(v, np.float64) for k, v in out.items()}
    for k in ("fx", "fy", "cx", "cy"):
        cams[k] = np.full(n, float(sc[k]))
    cams["exposure_time"] = np.full(n, 0.0 if sharp else float(sc["exposure"]))
    cams["rolling_shutter_time"] = np.full(n, 0.0 if sharp else float(sc["readout"]))
    cams["width"], cams["height"] = int(sc["width"]), int(sc["height"])
    return cams


def split(sc: dict) -> tuple[list[int], list[int]]:
    """(train, eval) frame indices: every `eval_every`-th frame, from
    `eval_offset`, is held out."""
    n = sc["n_train"] + sc["n_eval"]
    ev = [i for i in range(n) if i % sc["eval_every"] == sc["eval_offset"]]
    tr = [i for i in range(n) if i % sc["eval_every"] != sc["eval_offset"]]
    if len(ev) != sc["n_eval"] or len(tr) != sc["n_train"]:
        raise ValueError(f"the eval rule gives {len(tr)} train and {len(ev)} eval frames, "
                         f"the configuration says {sc['n_train']} and {sc['n_eval']}")
    return tr, ev


# -------------------------------------------------------------- the texture
class Texture:
    """The seeded colour field in linear light, (..., 3) -> (..., 3)."""

    def __init__(self, seed: int, device, n_waves: int = 4, n_planes: int = 8):
        g = device_generator(seed, device, stream=1)
        f32 = dict(dtype=torch.float32, device=device)
        self.freq = torch.randn((n_waves, 3, 3), generator=g, **f32) * 1.5     # (k, c, xyz)
        self.phase = torch.rand((n_waves, 3), generator=g, **f32) * (2 * math.pi)
        self.amp = 0.05 + 0.05 * torch.rand((n_waves, 3), generator=g, **f32)
        n = torch.randn((n_planes, 3), generator=g, **f32)
        self.normal = n / torch.linalg.norm(n, dim=-1, keepdim=True)
        self.offset = (torch.rand((n_planes,), generator=g, **f32) - 0.5) * 2.0
        self.step = (torch.rand((n_planes, 3), generator=g, **f32) - 0.5) * 0.3

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        c = torch.full(x.shape[:-1] + (3,), 0.45, dtype=x.dtype, device=x.device)
        for k in range(self.freq.shape[0]):
            c = c + self.amp[k] * torch.sin(x @ self.freq[k].T + self.phase[k])
        side = (x @ self.normal.T - self.offset > 0).to(x.dtype)          # (..., planes)
        c = c + side @ self.step
        return torch.clamp(c, 0.05, 0.95)


# -------------------------------------------------------------- Gaussians
def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


@full_precision
@torch.no_grad()
def gaussians(sc: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The Gaussian leaves of the resumed state, (capacity, ...) float32."""
    cap, n = int(sc["capacity"]), int(sc["alive"])
    n_in = int(round(sc["inner_share"] * n))
    g = device_generator(seed, device, stream=2)
    f32 = dict(dtype=torch.float32, device=device)
    d = torch.randn((n, 3), generator=g, **f32)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    radius = torch.full((n, 1), float(sc["room_radius"]), **f32)
    radius[:n_in] = float(sc["inner_radius"])
    means = d * radius
    area_per = torch.full((n,), 4 * math.pi * sc["room_radius"] ** 2 / max(n - n_in, 1), **f32)
    area_per[:n_in] = 4 * math.pi * sc["inner_radius"] ** 2 / max(n_in, 1)
    s_t = sc["disc_scale"] * torch.sqrt(area_per)
    scales_log = (torch.log(torch.stack([s_t, s_t, sc["disc_flatness"] * s_t], dim=-1))
                  + sc["scale_jitter"] * torch.randn((n, 3), generator=g, **f32))
    nrm = torch.where(d[:, 2:3] < 0, -d, d)
    q_align = torch.stack([1.0 + nrm[:, 2], -nrm[:, 1], nrm[:, 0], torch.zeros_like(nrm[:, 0])],
                          dim=-1)
    q_align = q_align / torch.linalg.norm(q_align, dim=-1, keepdim=True)
    psi = torch.rand((n,), generator=g, **f32) * (2 * math.pi)
    q_twist = torch.stack([torch.cos(psi / 2), torch.zeros_like(psi), torch.zeros_like(psi),
                           torch.sin(psi / 2)], dim=-1)
    quats = _quat_mul(q_align, q_twist)
    opac = sc["opacity_lo"] + (sc["opacity_hi"] - sc["opacity_lo"]) * torch.rand(
        (n,), generator=g, **f32)
    color = Texture(seed, device)(means)
    rest = sc["sh_rest_std"] * torch.randn((n, SH_REST, 3), generator=g, **f32)

    slots = torch.randperm(cap, generator=g, device=device)[:n]
    out = {
        "means": torch.zeros((cap, 3), **f32),
        "scales_log": torch.full((cap, 3), -8.0, **f32),
        "quats": torch.zeros((cap, 4), **f32),
        "opacities_logit": torch.full((cap,), math.log(0.1 / 0.9), **f32),
        "features_dc": torch.zeros((cap, 3), **f32),
        "features_rest": torch.zeros((cap, SH_REST, 3), **f32),
        "alive": torch.zeros((cap,), **f32),
    }
    out["quats"][:, 0] = 1.0
    out["means"][slots] = means
    out["scales_log"][slots] = scales_log
    out["quats"][slots] = quats
    out["opacities_logit"][slots] = torch.log(opac / (1 - opac))
    out["features_dc"][slots] = (color - 0.5) / SH_C0
    out["features_rest"][slots] = rest
    out["alive"][slots] = 1.0
    return out


@full_precision
@torch.no_grad()
def corrections(n: int, seed: int, device, stream: int) -> dict[str, torch.Tensor]:
    """Learned pose (phi, dp) and velocity (dv, dom) corrections of n cameras:
    small seeded values, as a run mid-way holds."""
    g = device_generator(seed, device, stream=stream)
    f32 = dict(dtype=torch.float32, device=device)
    return {"phi": 1e-3 * torch.randn((n, 3), generator=g, **f32),
            "dp": 1e-3 * torch.randn((n, 3), generator=g, **f32),
            "dv": 1e-2 * torch.randn((n, 3), generator=g, **f32),
            "dom": 1e-2 * torch.randn((n, 3), generator=g, **f32)}


# ----------------------------------------------------------------- frames
def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exp of (..., 3) rotation vectors, float64."""
    th = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    k = w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True), min=1e-30)
    zero = torch.zeros_like(k[..., 0])
    K = torch.stack([torch.stack([zero, -k[..., 2], k[..., 1]], -1),
                     torch.stack([k[..., 2], zero, -k[..., 0]], -1),
                     torch.stack([-k[..., 1], k[..., 0], zero], -1)], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + torch.sin(th) * K + (1 - torch.cos(th)) * (K @ K)


def _hit(o: torch.Tensor, d: torch.Tensor, r: float, far: bool):
    """Ray parameter of the sphere |x| = r: the near root (far=False) or the
    far root; inf where the ray misses or the root is behind."""
    b = (o * d).sum(-1)
    c = (o * o).sum(-1) - r * r
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b + sq if far else -b - sq
    return torch.where((disc >= 0) & (t > 1e-6), t, torch.full_like(t, float("inf")))


@torch.no_grad()
def frame(sc: dict, cams: dict, i: int, texture: Texture, gamma: float, device) -> torch.Tensor:
    """The target image of camera i of `cams`: (H, W, 3) float32 in [0, 1]."""
    f64 = dict(dtype=torch.float64, device=device)
    h, w = cams["height"], cams["width"]
    u = torch.arange(w, **f64) + 0.5
    v = torch.arange(h, **f64) + 0.5
    d_cam = torch.stack(torch.broadcast_tensors(
        ((u - cams["cx"][i]) / cams["fx"][i])[None, :],
        ((v - cams["cy"][i]) / cams["fy"][i])[:, None],
        torch.ones((1, 1), **f64)), dim=-1)                              # (H, W, 3)
    R0 = torch.as_tensor(cams["R_c2w"][i], **f64)
    p0 = torch.as_tensor(cams["p_c2w"][i], **f64)
    lin = torch.as_tensor(cams["lin_vel"][i], **f64)
    ang = torch.as_tensor(cams["ang_vel"][i], **f64)
    exposure, rs = float(cams["exposure_time"][i]), float(cams["rolling_shutter_time"][i])
    n_s = GT_SAMPLES if exposure > 0 else 1
    eps = (torch.linspace(-0.5, 0.5, n_s, **f64) * exposure if n_s > 1
           else torch.zeros(1, **f64))
    acc = torch.zeros((h, w, 3), **f64)
    for e in eps:
        tau = e + rs * (v / h - 0.5)                                     # (H,)
        R = R0 @ _so3_exp(ang * tau[:, None])                            # (H, 3, 3)
        o = p0 + (R0 @ (lin[:, None] * tau[None, :])).T                  # (H, 3)
        d = torch.einsum("hij,hwj->hwi", R, d_cam)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = o[:, None, :].expand_as(d)
        t_in = _hit(o, d, sc["inner_radius"], far=False)
        t_room = _hit(o, d, sc["room_radius"], far=True)
        t = torch.minimum(t_in, t_room)
        t = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
        x = (o + t[..., None] * d).to(torch.float32)
        acc += texture(x).to(torch.float64)
    lin_rgb = (acc / n_s).to(torch.float32)
    return torch.clamp(lin_rgb, 1e-6, 1.0) ** (1.0 / gamma)


@full_precision
@torch.no_grad()
def frames(sc: dict, cams: dict, seed: int, gamma: float, device, indices=None) -> torch.Tensor:
    """Target images of `cams` (all, or those at `indices`): (N, H, W, 3)."""
    tex = Texture(seed, device)
    idx = range(len(cams["fx"])) if indices is None else indices
    out = torch.empty((len(idx), cams["height"], cams["width"], 3), dtype=torch.float32,
                      device=device)
    for j, i in enumerate(idx):
        out[j] = frame(sc, cams, i, tex, gamma, device)
    return out
