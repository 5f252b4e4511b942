"""The depth-slab mesh's training loss and gradients against the benchmark's
plain reference (`perfbench/reference/`, which imports nothing of the
program), on the CPU: 4 gloo ranks on a `(1, 4, 1, 1)` slab mesh, the
benchmark's own seeded scene (`perfbench/scene.py`) at 64 x 48 px with 4,096
slots (3,072 alive), the flagship variant (5 blur samples in 2 anchors,
rolling shutter, SH 3, the pose and velocity corrections), one camera.

Tolerances, with their reasons:
- loss: relative 1e-5. Each slab composites from T = 1 and stops at its own
  T_EPS (1e-4), so a pixel the single composite stops in may gain up to
  T_EPS of a colour from the slabs behind, and the kernels' plain versions
  sum in another order than the reference; measured 3.9e-7.
- gradients: each leaf's |program - reference| at most 1e-4 of the leaf's
  largest reference entry, and the norms within 1e-4 of each other: the
  same early stop and reassociated sums; measured at most 6.3e-6 and
  3.4e-6.
The tile capacity K is below every tile's count, so both sides drop
entries: a tile keeps the whole cloud's K nearest rows, and the slabs behind
the first get what the slabs in front leave of K. (At a K above the counts
a slab that kept K rows of its own would pass too: the pixels are opaque
long before the rows past a K of 64.)
"""
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from splat_tpu_torch.models import splatfacto as sf
from splat_tpu_torch.models.convert import cameras_from_numpy, named_leaves
from splat_tpu_torch.ops import tiling
from splat_tpu_torch.parallel import launch, sharding

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 2300000017
STEP = 7000
K = 16            # under every tile's count (44-91): both sides drop entries
CAM = 3
LOSS_RTOL = 1e-5
GRAD_ATOL_SHARE = 1e-4
NORM_RTOL = 1e-4


def _setup():
    """The scene's configuration, the seeded inputs and the program's
    configuration of the cell."""
    from perfbench import harness
    from perfbench import scene as bscene

    config = harness.load("configs", "phone_mbrs_xl")
    sc = config["scene"]
    sc.update(width=64, height=48, fx=48.0, fy=48.0, cx=32.0, cy=24.0, capacity=4096,
              alive=3072, n_train=16, n_eval=2)
    tr_idx, _ = bscene.split(sc)
    cams = bscene.cameras(sc, [tr_idx[CAM]])
    gt = bscene.frames(sc, cams, SEED, float(config["gamma"]), "cpu")[0]
    gauss = bscene.gaussians(sc, SEED, "cpu")
    corr = bscene.corrections(len(tr_idx), SEED, "cpu", stream=3)
    return config, cams, gt, gauss, corr


def _program_loss(rank, world, device, out_dir):
    torch.set_num_threads(1)
    from perfbench import harness

    config, cams, gt, gauss, corr = _setup()
    cfg, _ = harness.program_configs(config, SEED, "cpu")
    cfg = sf.SplatfactoConfig(**{**cfg.__dict__, "max_per_tile": K, "blur_anchors": 2,
                                 "gauss_shard_mode": "slab"})
    mesh = sharding.make_mesh({"gauss": 4})
    g = sf.GaussianParams(**{f: sharding.shard_rows(mesh, v) for f, v in gauss.items()})
    params = sf.ModelParams(
        gaussians=g, background_logit=torch.zeros(3),
        camera_opt={k: corr[k].clone() for k in ("phi", "dp")},
        velocity_opt={k: corr[k].clone() for k in ("dv", "dom")},
        eval_camera_opt={}, eval_velocity_opt={})
    for name, leaf in named_leaves(params).items():
        if not name.endswith("alive"):
            leaf.requires_grad_(True)
    cam = cameras_from_numpy(dict(cams, cam_idx=[CAM]), "cpu")
    probe = torch.zeros_like(g.means[:, :2], requires_grad=True)
    share, info = sharding.sharded_loss(mesh, params, cam, gt, cfg, STEP, probe=probe)
    share.backward()
    leaves = named_leaves(params)
    gauss_leaves = [v for k, v in leaves.items() if k.startswith("gaussians.") and v.requires_grad]
    sharding.reduce_gradients(mesh, gauss_leaves + [probe],
                              [v for k, v in leaves.items() if not k.startswith("gaussians.")])
    res = {"loss": sharding.world_sum(mesh, share).numpy(),
           "overflow": info["slab_overflow"].numpy()}
    for name, leaf in leaves.items():
        if leaf.grad is not None:
            sharded = name.startswith("gaussians.")
            grad = sharding.gather_rows(mesh, leaf.grad) if sharded else leaf.grad
            res[f"grad.{name}"] = grad.numpy()
    if rank == 0:
        np.savez(Path(out_dir) / "mesh.npz", **res)


def _reference_params(rm, gauss, corr):
    return rm.ModelParams(rm.GaussianParams(**gauss), torch.zeros(3),
                          {k: corr[k].clone() for k in ("phi", "dp")},
                          {k: corr[k].clone() for k in ("dv", "dom")}, {}, {})


def _reference_camera(rm, cams):
    from perfbench.traffic import train as single

    cam = single._ref_cameras(rm, cams, "cpu")
    return rm.Cameras(**{**cam.__dict__, "cam_idx": torch.tensor([CAM])})


def _reference_loss():
    from perfbench import harness
    from perfbench.reference import model as rm
    from perfbench.reference import train as rt

    config, cams, gt, gauss, corr = _setup()
    cfg, _ = harness.reference_configs(config, SEED)
    cfg = rm.SplatfactoConfig(**{**cfg.__dict__, "max_per_tile": K, "blur_anchors": 2})
    params = _reference_params(rm, gauss, corr)
    named = rt.leaves(params)
    for t in named.values():
        t.requires_grad_(True)
    cam = _reference_camera(rm, cams)
    out = rm.render_camera(params, cam, cfg, rm.active_sh_degree(cfg, STEP),
                           rm.background_color(params, cfg))
    loss, _ = rm.compute_losses(rm.gamma_encode(out.rgb, cfg), gt, params, cfg)
    loss.backward()
    return float(loss.detach()), {f"grad.{k}": v.grad.numpy() for k, v in named.items()
                         if v.grad is not None}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_reference")
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        launch.launch(_program_loss, 4, args=(str(out),), device="cpu")
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _reference_loss()
    finally:
        torch.set_num_threads(n)
    return dict(np.load(out / "mesh.npz")), ref


def test_the_tile_capacity_drops_entries_in_the_compared_render():
    from perfbench import harness
    from perfbench.reference import blocked
    from perfbench.reference import model as rm

    config, cams, _, gauss, corr = _setup()
    cfg, _ = harness.reference_configs(config, SEED)
    counts = blocked.binning_counts(_reference_params(rm, gauss, corr),
                                    _reference_camera(rm, cams), cfg)
    assert int((counts > K).sum()) >= counts.numel() // 2


def _lists(budget=None):
    gen = torch.Generator().manual_seed(5)
    n = 300
    means = torch.rand((n, 2), generator=gen) * torch.tensor([64.0, 48.0])
    ext = 2.0 + 6.0 * torch.rand((n, 2), generator=gen)
    depths = torch.rand(n, generator=gen)
    valid = torch.rand(n, generator=gen) > 0.1
    return tiling.build_tile_lists(means, ext, depths, valid, 64, 48, 16, max_per_tile=32,
                                   tile_budget=budget)


def test_a_tile_budget_of_k_everywhere_is_the_plain_cap():
    plain = _lists()
    same = _lists(lambda c: torch.full_like(c, 32))
    for a, b in zip(plain, same):
        assert torch.equal(a, b)


def test_a_tile_budget_caps_each_tile_and_its_slots():
    plain = _lists()
    full = _lists(lambda c: torch.full_like(c, 32))
    cap = torch.tensor([0, 5, 32, 17] * 3, dtype=torch.int32)
    got = _lists(lambda c: cap)
    assert torch.equal(got.counts, torch.minimum(plain.counts, cap))
    assert int((plain.counts > cap).sum()) >= 6
    j = torch.arange(32)[None, :]
    assert torch.equal(got.indices, torch.where(j < got.counts[:, None], full.indices, -1))
    dummy = 12 * 32
    kept = (full.entry_slots < dummy) & ((full.entry_slots % 32) < cap[full.entry_slots // 32
                                                                        % 12])
    assert torch.equal(got.entry_slots, torch.where(kept, full.entry_slots, dummy))


def test_slab_mesh_loss_matches_the_plain_reference(both):
    mesh, (loss, _) = both
    assert int(mesh["overflow"]) == 0
    assert math.isclose(float(mesh["loss"]), loss, rel_tol=LOSS_RTOL)


LEAVES = ["gaussians.means", "gaussians.scales_log", "gaussians.quats",
          "gaussians.opacities_logit", "gaussians.features_dc", "gaussians.features_rest",
          "camera_opt.phi", "camera_opt.dp", "velocity_opt.dv", "velocity_opt.dom"]


@pytest.mark.parametrize("leaf", LEAVES)
def test_slab_mesh_gradients_match_the_plain_reference(both, leaf):
    mesh, (_, grads) = both
    got, want = mesh[f"grad.{leaf}"], grads[f"grad.{leaf}"]
    scale = float(np.abs(want).max())
    assert scale > 0, leaf
    assert float(np.abs(got - want).max()) <= GRAD_ATOL_SHARE * scale, leaf
    assert math.isclose(float(np.linalg.norm(got)), float(np.linalg.norm(want)),
                        rel_tol=NORM_RTOL), leaf
