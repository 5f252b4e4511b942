"""The port's tile binning against the JAX package: exact integer equality.

Both sides get the same JAX-projected arrays, so the comparison isolates the
binning (footprint rects, conic cull, (tile, depth) sort, bin edges, caps and
the slot <-> entry bijection).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_tpu.ops import projection as jproj
from splat_tpu.ops import tiling as jtiling
from splat_tpu_torch.ops import tiling as ttiling

W, H = 48, 32
FIELDS = ("indices", "counts", "starts", "sorted_ids", "entry_slots", "overflow",
          "clipped", "entry_overflow")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here, and
    the suite's xdist workers would each start a full intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _projected(n=300, seed=0, stack=0):
    """JAX-projected Gaussians as numpy, with velocities; `stack` of them
    piled onto one spot so that tile overflows."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)) * np.array([0.6, 0.45, 0.8]) + np.array([0, 0, 4.0])
    means[:stack] = np.array([0.1, 0.05, 3.0]) + rng.normal(size=(stack, 3)) * 0.01
    scales = np.exp(rng.normal(size=(n, 3)) * 0.4) * 0.08
    quats = rng.normal(size=(n, 4))
    proj = jproj.project_gaussians(
        *(jnp.asarray(a, jnp.float32) for a in (means, scales, quats)),
        jnp.eye(3), jnp.zeros(3), 40.0, 40.0, W / 2, H / 2, W, H,
        lin_vel=jnp.array([0.5, -0.3, 0.2]), ang_vel=jnp.array([0.1, 0.15, -0.1]),
    )
    opac = rng.uniform(0.3, 0.95, size=n).astype(np.float32)
    arrs = {k: np.array(getattr(proj, k)) for k in
            ("means2d", "extents", "depths", "valid", "conics", "pix_vels", "compensations")}
    arrs["op_eff"] = opac * arrs["compensations"] * arrs["valid"].astype(np.float32)
    arrs["radius_pad"] = np.abs(arrs["pix_vels"]) * np.float32(0.03 + 0.5 * 0.04)
    return arrs


def _near_plane(arrs):
    """Values a Gaussian at the near plane can reach: far outside the int32
    range after the divide by the tile size, infinite, or NaN."""
    a = {k: v.copy() for k, v in arrs.items()}
    a["means2d"][:7] = [[1e12, 5.0], [-1e12, 5.0], [np.nan, 10.0], [20.0, 3e11],
                        [np.inf, -np.inf], [24.0, 16.0], [30.0, 12.0]]
    a["extents"][:7] = [[4.0, 4.0], [3.0, 3.0], [2.0, 2.0], [5.0, 1e12],
                        [2.0, 2.0], [3e10, 3e10], [60.0, 40.0]]   # the last one is clamped
    a["valid"][:7] = True
    return a


def _both(arrs, **kw):
    j_in = [jnp.asarray(arrs[k]) for k in ("means2d", "extents", "depths", "valid")]
    t_in = [torch.tensor(arrs[k]) for k in ("means2d", "extents", "depths", "valid")]
    j_kw = dict(radius_pad=jnp.asarray(arrs["radius_pad"]), conics=jnp.asarray(arrs["conics"]),
                opacities=jnp.asarray(arrs["op_eff"]))
    t_kw = dict(radius_pad=torch.tensor(arrs["radius_pad"]), conics=torch.tensor(arrs["conics"]),
                opacities=torch.tensor(arrs["op_eff"]))
    return (j_in, {**j_kw, **kw}), (t_in, {**t_kw, **kw})


CASES = {
    "base": dict(arrs=dict(), kw=dict(tile_size=8, max_per_tile=128)),
    "rect_tile": dict(arrs=dict(), kw=dict(tile_size=(16, 8), max_per_tile=128)),
    "capped_stream": dict(arrs=dict(), kw=dict(tile_size=8, max_per_tile=128,
                                               max_total_entries=700)),
    "overflow_tile": dict(arrs=dict(stack=120), kw=dict(tile_size=8, max_per_tile=32)),
    "near_plane_casts": dict(arrs=dict(near=True), kw=dict(tile_size=8, max_per_tile=128)),
    # without the conic cull the NaN mean's rect ([0, 1) under XLA's cast) lands
    "near_plane_casts_nocull": dict(arrs=dict(near=True),
                                    kw=dict(tile_size=8, max_per_tile=128, conics=None)),
}


def _case_arrays(spec):
    arrs = _projected(stack=spec.get("stack", 0))
    return _near_plane(arrs) if spec.get("near") else arrs


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_tile_lists_equals_jax(case):
    spec = CASES[case]
    arrs = _case_arrays(spec["arrs"])
    (j_in, j_kw), (t_in, t_kw) = _both(arrs, max_tiles_per_gaussian=16, **spec["kw"])
    lj = jtiling.build_tile_lists(*j_in, W, H, **j_kw)
    lt = ttiling.build_tile_lists(*t_in, W, H, **t_kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(lt, f).numpy(), np.asarray(getattr(lj, f)),
                                      err_msg=f)
    if case == "capped_stream":
        assert int(lt.entry_overflow) > 0
    if case == "overflow_tile":
        assert int(lt.overflow) > 0
    if case.startswith("near_plane"):
        assert int(lt.clipped) > 0


@pytest.mark.parametrize("case", ["base", "near_plane_casts", "near_plane_casts_nocull",
                                  "rect_tile"])
def test_tile_population_equals_jax(case):
    spec = CASES[case]
    arrs = _case_arrays(spec["arrs"])
    extra = {"conics": None} if "conics" in spec["kw"] else {}
    (j_in, j_kw), (t_in, t_kw) = _both(arrs, **extra)
    ts = spec["kw"]["tile_size"]
    pj = jtiling.tile_population(*j_in, W, H, ts, 16, **j_kw)
    pt = ttiling.tile_population(*t_in, W, H, ts, 16, **t_kw)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_float_to_int32_cast_saturates_like_xla():
    x = torch.tensor([1e12, -1e12, float("nan"), float("inf"), -float("inf"), 3.7, -3.7])
    want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.int32))
    np.testing.assert_array_equal(ttiling._f2i(x).numpy(), want)
    big = ttiling._f2i(torch.tensor([1e12]))
    assert int(ttiling._add_i32(big, 1)) == -(2**31)   # int32 wraparound, as XLA
