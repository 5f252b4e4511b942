"""The projection and SH kernel pair's plain closed form against the plain
route, and the dispatch in `subframe_inputs`, on the CPU.

`ops/cuda/project_sh.py` holds the forward and the analytic backward of the
kernels in plain PyTorch, operation for operation in the kernels' order; on
CPU tensors `project_sh` runs them. They are held here against the plain
route (`project_gaussians` and `sh_eval_switch`) and its autograd, in
float64, every output and every gradient, the camera's included: a float64
closed form and autograd differ by rounding in another order only, so each
Gaussian's row and the camera's vector agree to 1e-9 of their largest entry
(entries of 1e3 to 1e26 in the edge batch). Where autograd's own arithmetic
gives NaN or inf (a compensation of exactly 0: g / (2 sqrt(0))), the closed
form gives the same at the same entries. radii, extents and valid are equal.

The dispatch: impl "auto" on CPU tensors is today's plain route, bitwise,
forward and backward; impl "cuda" on CPU tensors raises.
"""
import numpy as np
import pytest
import torch

from splat_tpu_torch.cameras.cameras import Cameras
from splat_tpu_torch.models import splatfacto as sf
from splat_tpu_torch.ops import projection, se3
from splat_tpu_torch.ops.cuda import path_launches
from splat_tpu_torch.ops.cuda import project_sh as ps

F64 = torch.float64
W, H = 320, 240
INTR = (300.0, 310.0, 160.0, 120.0)     # fx, fy, cx, cy
RTOL = 1e-9
OUTS = ("means2d", "depths", "conics", "compensations", "pix_vels")
EXACT = ("radii", "valid", "extents")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain_route(g, cam, deg, use_vel, max_degree):
    """Today's plain route of `subframe_inputs` at the pose (Rt, pt)."""
    Rt, pt, v, w = cam["Rt"], cam["pt"], cam["v"], cam["w"]
    fx, fy, cx, cy = cam["intr"]
    R_cw = Rt.T
    proj = projection.project_gaussians(
        g["means"], torch.exp(g["scales_log"]), g["quats"], R_cw, -torch.matmul(R_cw, pt),
        fx, fy, cx, cy, W, H, lin_vel=v if use_vel else None, ang_vel=w if use_vel else None)
    dirs = g["means"] - pt
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-9)
    coeffs = torch.cat([g["features_dc"][:, None, :], g["features_rest"]], dim=1)
    return proj, sf.sh_eval_switch(deg, max_degree, dirs, coeffs)


def closed_form(g, cam, deg, use_vel):
    fx, fy, cx, cy = cam["intr"]
    return ps.project_sh(g["means"], g["scales_log"], g["quats"], g["features_dc"],
                         g["features_rest"], cam["Rt"], cam["pt"], fx, fy, cx, cy, W, H, deg,
                         lin_vel=cam["v"] if use_vel else None,
                         ang_vel=cam["w"] if use_vel else None)


def gaussians(rng, n, degree, grad=True):
    """A cloud in front of the camera, most of it in view, some of it not."""
    k = (degree + 1) ** 2
    g = {"means": rng.normal(size=(n, 3)) * [2.0, 1.5, 1.0] + [0.0, 0.0, 5.0],
         "scales_log": rng.normal(size=(n, 3)) * 0.5 - 2.0,
         "quats": rng.normal(size=(n, 4)),
         "features_dc": rng.normal(size=(n, 3)) * 0.5,
         "features_rest": rng.normal(size=(n, k - 1, 3)) * 0.3}
    return {name: torch.tensor(a, dtype=F64, requires_grad=grad) for name, a in g.items()}


def camera(rng, identity=False):
    Rt = (torch.eye(3, dtype=F64) if identity
          else se3.so3_exp(torch.tensor(rng.normal(size=3) * 0.1, dtype=F64)))
    pt = torch.zeros(3, dtype=F64) if identity else torch.tensor(rng.normal(size=3) * 0.2,
                                                                 dtype=F64)
    return {"Rt": Rt.requires_grad_(True), "pt": pt.requires_grad_(True),
            "v": torch.tensor(rng.normal(size=3), dtype=F64, requires_grad=True),
            "w": torch.tensor(rng.normal(size=3), dtype=F64, requires_grad=True),
            "intr": tuple(torch.tensor(a, dtype=F64) for a in INTR)}


def edge_batch(rng, degree):
    """Every branch of the plain route: behind the camera (zs = 1) and
    between the camera and the clip plane; the frustum clamp on x and y,
    exact ties with the clamp included (maximum / minimum split their
    gradient there); det <= 1e-12 (needles of 1e9 whose float64 determinant
    rounds below it in both routes, picked by a first pass), so det_orig < 0
    under the compensation's clamp; the lam1 clamp and dead slots (tiny
    isotropic scales); the direction norm at and under its 1e-9 clamp; colours
    clamped at 0; the quaternion norm at and under its 1e-12 clamp; plus
    ordinary Gaussians. Identity camera (exact ties)."""
    cam = camera(rng, identity=True)
    fx, fy = cam["intr"][:2]
    lim_x = (1.3 * ((1.0 / fx) * (0.5 * W))).item()
    lim_y = (1.3 * ((1.0 / fy) * (0.5 * H))).item()
    base = gaussians(rng, 24, degree, grad=False)
    rows = {k: [v.detach().numpy()] for k, v in base.items()}

    def add(means, scales_log=(-2.0, -2.0, -2.0), quats=(0.9, 0.1, -0.3, 0.2), dc=None):
        n = len(means)
        rows["means"].append(np.asarray(means, float))
        rows["scales_log"].append(np.broadcast_to(np.asarray(scales_log, float), (n, 3)))
        rows["quats"].append(np.broadcast_to(np.asarray(quats, float), (n, 4)))
        rows["features_dc"].append(rng.normal(size=(n, 3)) * 0.5 if dc is None
                                   else np.broadcast_to(np.asarray(dc, float), (n, 3)))
        rows["features_rest"].append(rng.normal(size=(n, base["features_rest"].shape[1], 3))
                                     * 0.3)

    add([[0.2, 0.1, -1.0], [0.3, -0.2, 0.005], [-0.1, 0.4, 0.0]])          # behind the camera
    add([[5.0, 0.3, 2.0], [-6.0, 0.2, 3.0], [0.1, -6.0, 2.0], [8.0, 9.0, 1.5]])  # frustum clamp
    add([[lim_x, 0.1, 1.0], [-lim_x, 0.2, 1.0], [0.1, lim_y, 1.0], [0.3, -lim_y, 1.0]])  # ties
    add([[0.1, 0.2, 3.0]] * 3, scales_log=(-8.0, -8.0, -8.0))              # dead slots, lam1
    add([[0.0, 0.0, 0.0], [1e-10, 0.0, 0.0]])                              # direction norm
    add([[0.2, -0.3, 4.0]] * 2, dc=(-5.0, -4.0, -6.0))                      # colour at 0
    add([[0.3, 0.1, 3.0]], quats=(0.0, 0.0, 0.0, 0.0))                       # quaternion norm
    add([[-0.2, 0.1, 3.0]], quats=(1e-13, 0.0, 0.0, 0.0))
    # needles: det rounds to <= 1e-12 in both routes for some of them, and
    # det_orig below 0 (where it rounds to exactly 0, autograd's clamp passes
    # g / (2 sqrt(0)): the degenerate batch's case)
    cand = {"means": torch.tensor(rng.normal(size=(64, 3)) * 0.3 + [0.0, 0.0, 5.0], dtype=F64),
            "scales_log": torch.tensor(np.broadcast_to([20.7, -7.0, -7.0], (64, 3)).copy(),
                                       dtype=F64),
            "quats": torch.tensor(rng.normal(size=(64, 4)), dtype=F64),
            "features_dc": torch.zeros((64, 3), dtype=F64),
            "features_rest": torch.zeros((64, base["features_rest"].shape[1], 3), dtype=F64)}
    cand["means"].requires_grad_(True)
    pick = torch.ones(64, dtype=torch.bool)
    for route in ("plain", "closed"):
        proj, _, (d_means,) = run(route, cand, cam, degree, True, degree, cotangents(rng, 64),
                                  [cand["means"]])
        pick &= (~proj.valid) & (proj.depths > 0.01) & torch.isfinite(d_means).all(dim=1)
    pick = pick.numpy()
    assert pick.sum() >= 4, "needles whose determinant rounds under 1e-12 in both routes"
    cand["means"] = cand["means"].detach()
    add(cand["means"].numpy()[pick], scales_log=(20.7, -7.0, -7.0),
        quats=cand["quats"].numpy()[pick])
    g = {k: torch.tensor(np.concatenate(v), dtype=F64, requires_grad=True)
         for k, v in rows.items()}
    return g, cam


def degenerate_batch(rng, degree):
    """Compensations of exactly 0 (det_orig == 0: needles of zero width,
    axis-aligned, in exact arithmetic), where autograd of the plain route
    gives g / (2 sqrt(0)), beside ordinary Gaussians."""
    cam = camera(rng, identity=True)
    g = gaussians(rng, 8, degree, grad=False)
    g["means"][:3] = torch.tensor([[0.5, 0.25, 2.0], [-0.25, 0.5, 4.0], [0.0, 0.0, 3.0]])
    g["scales_log"][:3] = torch.tensor([0.0, -1000.0, -1000.0])
    g["quats"][:3] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    return {k: v.detach().requires_grad_(True) for k, v in g.items()}, cam


def cotangents(rng, n):
    shapes = {"means2d": (n, 2), "depths": (n,), "conics": (n, 3), "compensations": (n,),
              "pix_vels": (n, 2), "colors": (n, 3)}
    return {k: torch.tensor(rng.normal(size=s), dtype=F64) for k, s in shapes.items()}


def run(route, g, cam, deg, use_vel, max_degree, cot, wrt):
    proj, colors = (plain_route(g, cam, deg, use_vel, max_degree) if route == "plain"
                    else closed_form(g, cam, deg, use_vel))
    loss = sum((getattr(proj, k) * cot[k]).sum() for k in OUTS) + (colors * cot["colors"]).sum()
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return proj, colors, grads


def _rows(a):
    return a.reshape(a.shape[0], -1)


def row_scale(leaves):
    """Each row's largest finite |entry| over the leaves (a Gaussian's over
    all its gradients: where a Gaussian is isotropic, its quaternion gradient
    is rounding noise beside the others)."""
    fin = [torch.where(torch.isfinite(_rows(a)), _rows(a), 0.0).abs() for a in leaves
           if a.numel()]
    return torch.cat(fin, dim=1).amax(dim=1, keepdim=True)


def assert_rows_close(a, b, what, nan_ok=False, scale=None):
    """|a - b| <= RTOL * each row's largest |a| (rows: a Gaussian's entries,
    or the whole vector; `scale` gives them); NaN and inf where the other has
    them, if nan_ok."""
    assert a.shape == b.shape, what
    if a.numel() == 0:
        return
    a2, b2 = _rows(a), _rows(b)
    if nan_ok:
        fin_a, fin_b = torch.isfinite(a2), torch.isfinite(b2)
        assert torch.equal(fin_a, fin_b), f"{what}: non-finite entries differ"
        assert torch.equal(a2[~fin_a].isnan(), b2[~fin_b].isnan()), f"{what}: NaN against inf"
        assert torch.equal(torch.sign(a2[a2.isinf()]), torch.sign(b2[b2.isinf()])), what
        a2, b2 = torch.where(fin_a, a2, 0.0), torch.where(fin_b, b2, 0.0)
    else:
        assert torch.isfinite(a2).all() and torch.isfinite(b2).all(), f"{what}: not finite"
    scale = (a2.abs().amax(dim=1, keepdim=True) if scale is None else scale).clamp(min=1e-30)
    err = ((a2 - b2).abs() / scale).max().item()
    assert err <= RTOL, f"{what}: {err:.3g} of the row's largest entry"


CASES = ([pytest.param(dict(vel=vel, degree=d, active=max(d - 1, 0)),
                       id=f"{'vel' if vel else 'novel'}-deg{d}")
          for vel in (True, False) for d in range(4)]
         + [pytest.param(dict(vel=True, degree=3, active=3, frozen=True), id="frozen"),
            pytest.param(dict(vel=True, degree=3, active=1, batch="edge"), id="edge"),
            pytest.param(dict(vel=False, degree=2, active=0, batch="edge"), id="edge-novel"),
            pytest.param(dict(vel=True, degree=3, active=3, batch="degenerate"),
                         id="degenerate")])


@pytest.mark.parametrize("case", CASES)
def test_closed_form_matches_plain_route(case):
    rng = np.random.default_rng(100 + case["degree"])
    batch = case.get("batch")
    if batch == "edge":
        g, cam = edge_batch(rng, case["degree"])
    elif batch == "degenerate":
        g, cam = degenerate_batch(rng, case["degree"])
    else:
        g, cam = gaussians(rng, 300, case["degree"]), camera(rng)
    if case.get("frozen"):
        g = {k: v.detach() for k, v in g.items()}
    n = g["means"].shape[0]
    cot = cotangents(rng, n)
    wrt_g = [] if case.get("frozen") else list(g.values())
    wrt = wrt_g + [cam["Rt"], cam["pt"], cam["v"], cam["w"]]
    deg = case["active"]
    pa, ca, ga = run("plain", g, cam, deg, case["vel"], case["degree"], cot, wrt)
    pb, cb, gb = run("closed", g, cam, deg, case["vel"], case["degree"], cot, wrt)

    nan_ok = batch == "degenerate"
    for name in OUTS:
        assert_rows_close(getattr(pa, name).detach(), getattr(pb, name).detach(), name)
    assert_rows_close(ca.detach(), cb.detach(), "colors")
    for name in EXACT:
        assert torch.equal(getattr(pa, name), getattr(pb, name)), name
    names = [*(list(g) if wrt_g else []), "Rt", "pt", "lin_vel", "ang_vel"]
    per_gaussian = row_scale(ga[:len(wrt_g)]) if wrt_g else None
    for name, a, b in zip(names, ga, gb):
        if name in ("lin_vel", "ang_vel") and not case["vel"]:
            assert a is None and b is None, f"{name}: no gradient without velocities"
            continue
        if name in ("Rt", "pt", "lin_vel", "ang_vel"):
            assert_rows_close(a.reshape(1, -1), b.reshape(1, -1), f"d {name}", nan_ok=nan_ok)
        else:
            assert_rows_close(a, b, f"d {name}", nan_ok=nan_ok, scale=per_gaussian)
    if batch == "edge":
        # the branches were reached
        assert int((~pa.valid).sum()) >= 10, "invalid slots"
        assert int((pa.depths <= 0.01).sum()) == 5, "behind the camera and at its centre"
        assert (cb.detach() == 0).any(), "a colour clamped at 0"
    if nan_ok:
        assert (pa.compensations[:3] == 0).all() and pa.valid[:3].all()
        assert not torch.isfinite(ga[0][:3]).all() and torch.isfinite(ga[0][3:]).all()


def test_closed_form_degree_tensor_and_masks():
    """A 0-d integer tensor for the active degree gives what the int gives;
    bands above it get exactly zero gradient."""
    rng = np.random.default_rng(7)
    g, cam = gaussians(rng, 64, 3), camera(rng)
    cot = cotangents(rng, 64)
    wrt = list(g.values())
    _, c_int, g_int = run("closed", g, cam, 1, True, 3, cot, wrt)
    _, c_t, g_t = run("closed", g, cam, torch.tensor(1), True, 3, cot, wrt)
    assert torch.equal(c_int, c_t)
    for a, b in zip(g_int, g_t):
        assert torch.equal(a, b)
    assert not g_int[4][:, 3:].any() and g_int[4][:, :3].abs().sum() > 0


def test_closed_form_float32_close_to_plain_route():
    """In float32 the closed form stays within rounding of the plain route
    (the kernels' arithmetic; their comparison on the card is chip_smoke.py
    phase 2's)."""
    rng = np.random.default_rng(11)
    g64, cam64 = gaussians(rng, 512, 3), camera(rng)
    g = {k: v.detach().float().requires_grad_(True) for k, v in g64.items()}
    cam = {k: (tuple(a.float() for a in v) if k == "intr"
               else v.detach().float().requires_grad_(True)) for k, v in cam64.items()}
    cot = {k: v.float() for k, v in cotangents(rng, 512).items()}
    wrt = list(g.values()) + [cam["Rt"], cam["pt"], cam["v"], cam["w"]]
    pa, ca, ga = run("plain", g, cam, 3, True, 3, cot, wrt)
    pb, cb, gb = run("closed", g, cam, 3, True, 3, cot, wrt)
    for name in OUTS:
        a, b = getattr(pa, name).detach(), getattr(pb, name).detach()
        assert ((a - b).abs().max() <= 1e-5 * a.abs().max()), name
    assert (ca - cb).abs().max() <= 1e-5
    for a, b in zip(ga, gb):
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


def test_closed_form_launches_nothing_on_cpu():
    rng = np.random.default_rng(3)
    g, cam = gaussians(rng, 16, 3), camera(rng)
    before = path_launches()
    _, colors, _ = run("closed", g, cam, 3, True, 3, cotangents(rng, 16), list(g.values()))
    assert path_launches() == before and colors.shape == (16, 3)


def _model(rng, n=96, degree=3):
    g = gaussians(rng, n, degree)
    f32 = {k: v.detach().float().requires_grad_(True) for k, v in g.items()}
    return sf.ModelParams(
        gaussians=sf.GaussianParams(**f32, opacities_logit=torch.zeros(n),
                                    alive=torch.ones(n)),
        background_logit=torch.zeros(3), camera_opt={}, velocity_opt={},
        eval_camera_opt={}, eval_velocity_opt={})


def _camera():
    return Cameras(R_c2w=torch.eye(3)[None], p_c2w=torch.tensor([[0.1, -0.2, 0.0]]),
                   fx=torch.tensor([300.0]), fy=torch.tensor([310.0]),
                   cx=torch.tensor([160.0]), cy=torch.tensor([120.0]), width=W, height=H,
                   lin_vel=torch.tensor([[0.3, -0.1, 0.2]]),
                   ang_vel=torch.tensor([[0.2, 0.4, -0.1]]),
                   exposure_time=torch.tensor([0.05]),
                   rolling_shutter_time=torch.tensor([0.03]))


@pytest.mark.parametrize("mode", ["antialiased", "classic"])
def test_auto_on_cpu_is_the_plain_route_bitwise(mode):
    """impl "auto" on CPU tensors runs today's plain route: outputs and
    gradients bitwise those of impl "torch" and of the route written out,
    with the probe and a row strip's shift."""
    rng = np.random.default_rng(5)
    params = _model(rng)
    cam = _camera()
    probe = torch.zeros((96, 2), requires_grad=True)
    results = []
    for impl in ("auto", "torch", None):
        cfg = sf.SplatfactoConfig(impl=impl or "torch", rasterize_mode=mode)
        motion = sf.camera_motion(params, cam, cfg)
        t_s = motion.eps[1]
        if impl is None:
            g = params.gaussians
            Rt, pt = se3.se3_advance_c2w(motion.R0, motion.p0, motion.lin_vel,
                                         motion.ang_vel, t_s)
            R_cw = Rt.T
            proj = projection.project_gaussians(
                g.means, torch.exp(g.scales_log), g.quats, R_cw, -torch.matmul(R_cw, pt),
                cam.fx[0], cam.fy[0], cam.cx[0], cam.cy[0], W, H, lin_vel=motion.lin_vel,
                ang_vel=motion.ang_vel)
            proj = proj._replace(means2d=proj.means2d - torch.tensor([0.0, 16.0]) + probe)
            if mode == "classic":
                proj = proj._replace(compensations=torch.ones_like(proj.compensations))
            dirs = g.means - pt
            dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-9)
            colors = sf.sh_eval_switch(2, 3, dirs, torch.cat(
                [g.features_dc[:, None, :], g.features_rest], dim=1))
        else:
            proj, colors = sf.subframe_inputs(params, motion, cfg, 2, t_s, probe, row0=16)
        loss = (proj.means2d.sum() + (proj.conics * 0.1).sum() + proj.compensations.sum()
                + proj.pix_vels.sum() + proj.depths.sum() + colors.sum())
        leaves = list(params.gaussians)[:3] + list(params.gaussians)[4:6] + [probe]
        grads = torch.autograd.grad(loss, leaves)
        results.append((proj, colors, grads))
    (pa, ca, ga), *others = results
    for pb, cb, gb in others:
        for a, b in zip(pa, pb):
            assert torch.equal(a, b)
        assert torch.equal(ca, cb)
        for a, b in zip(ga, gb):
            assert torch.equal(a, b)


def test_cuda_on_cpu_raises():
    rng = np.random.default_rng(6)
    params = _model(rng, n=8)
    cfg = sf.SplatfactoConfig(impl="cuda")
    motion = sf.camera_motion(params, _camera(), cfg)
    with pytest.raises(ValueError, match="CUDA"):
        sf.subframe_inputs(params, motion, cfg, 3, motion.eps[0])
    g = params.gaussians
    with pytest.raises(ValueError, match="CUDA"):
        ps.project_sh_fwd(g.means.detach(), g.scales_log.detach(), g.quats.detach(),
                          g.features_dc.detach(), g.features_rest.detach(), torch.zeros(22),
                          3, W, H, True)
