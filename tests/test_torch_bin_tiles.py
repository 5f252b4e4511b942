"""The binning kernels' algorithm on the CPU (`ops/cuda/bin_tiles.py`).

`tile_lists_plain` is the kernels' count -> scan -> scatter -> per-tile sort
in plain PyTorch: ranks handed out in a scrambled arrival order (as the
atomics hand them out), the 64-bit (depth bits, entry) keys, and the sort
network with its long-segment path (a small `chunk` sends many tiles down
it). It is held to the plain route (`tiling._tile_lists_plain`, which
`tests/test_torch_tiling.py` holds to the JAX package) under the kernels'
contract: counts, starts, overflow, clipped, entry_overflow, entry_slots,
the real count and the dense indices equal; sorted_ids equal below the real
entries capped at the stream's length. Past that count sorted_ids is read by
nothing: a render's output and gradients do not move when it changes. CPU
tensors take the plain route, bitwise as before, and launch no kernel.
"""
import numpy as np
import pytest
import torch

from splat_tpu_torch.models import splatfacto as sf
from splat_tpu_torch.models.convert import cameras_from_numpy, params_from_numpy
from splat_tpu_torch.ops import projection, rasterize, tiling
from splat_tpu_torch.ops.cuda import bin_tiles
from splat_tpu_torch.utils import profiling

W, H = 48, 32
ALPHA = 1.0 / 255.0
FIELDS = ("counts", "starts", "overflow", "clipped", "entry_overflow", "entry_slots")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _projected(n=300, seed=0, stack=0, near=False):
    """Projected Gaussians with velocities (`test_torch_tiling.py`'s scene,
    through the port's projection); `stack` of them piled onto one spot;
    `near`: values a Gaussian at the near plane can reach."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)) * np.array([0.6, 0.45, 0.8]) + np.array([0, 0, 4.0])
    means[:stack] = np.array([0.1, 0.05, 3.0]) + rng.normal(size=(stack, 3)) * 0.01
    scales = np.exp(rng.normal(size=(n, 3)) * 0.4) * 0.08
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    p = projection.project_gaussians(
        f32(means), f32(scales), f32(rng.normal(size=(n, 4))), torch.eye(3), torch.zeros(3),
        40.0, 40.0, W / 2, H / 2, W, H, lin_vel=f32([0.5, -0.3, 0.2]),
        ang_vel=f32([0.1, 0.15, -0.1]))
    opac = f32(rng.uniform(0.3, 0.95, size=n))
    a = {"means2d": p.means2d.clone(), "extents": p.extents.clone(), "depths": p.depths,
         "valid": p.valid.clone(), "conics": p.conics,
         "opacities": opac * p.compensations * p.valid.float(),
         "radius_pad": torch.abs(p.pix_vels) * (0.03 + 0.5 * 0.04)}
    if near:
        a["means2d"][:7] = f32([[1e12, 5.0], [-1e12, 5.0], [np.nan, 10.0], [20.0, 3e11],
                                [np.inf, -np.inf], [24.0, 16.0], [30.0, 12.0]])
        a["extents"][:7] = f32([[4.0, 4.0], [3.0, 3.0], [2.0, 2.0], [5.0, 1e12],
                                [2.0, 2.0], [3e10, 3e10], [60.0, 40.0]])
        a["valid"][:7] = True
    return a


def _zero_rows(a, live_share=8):
    """A receive buffer 7/8 zero rows: each live row followed by 7 rows that
    are not valid and have no extent."""
    out = {}
    for k, v in a.items():
        z = torch.zeros((v.shape[0] * live_share,) + tuple(v.shape[1:]), dtype=v.dtype)
        z[::live_share] = v
        out[k] = z
    return out


def _kw(a, **over):
    kw = dict(img_w=W, img_h=H, tile_size=8, max_per_tile=128, max_tiles_per_gaussian=16,
              radius_pad=a["radius_pad"], conics=a["conics"], opacities=a["opacities"],
              alpha_thresh=ALPHA, row0_px=0.0, full_img_h=None, max_total_entries=0,
              tile_budget=None)
    kw.update(over)
    return kw


def _call(fn, a, kw, **extra):
    return fn(a["means2d"], a["extents"], a["depths"], a["valid"], kw["img_w"], kw["img_h"],
              kw["tile_size"], kw["max_per_tile"], kw["max_tiles_per_gaussian"],
              kw["radius_pad"], kw["conics"], kw["opacities"], kw["alpha_thresh"],
              kw["row0_px"], kw["full_img_h"], kw["max_total_entries"], kw["tile_budget"],
              **extra)


def _cut_inside_a_tile(a, kw):
    """A stream cap that falls inside a tile of at least 4 real entries."""
    cnt = bin_tiles.population_plain(a["means2d"], a["extents"], a["valid"], kw["img_w"],
                                     kw["img_h"], kw["tile_size"], kw["max_tiles_per_gaussian"],
                                     kw["radius_pad"], kw["conics"], kw["opacities"], ALPHA,
                                     kw["row0_px"], kw["full_img_h"]).long()
    prefix = torch.cumsum(cnt, 0) - cnt
    t = int(torch.nonzero(cnt >= 4)[len(torch.nonzero(cnt >= 4)) // 2])
    return int(prefix[t] + cnt[t] // 2)


def _ties(a):
    """Several Gaussians at one depth in the same tiles."""
    b = dict(a)
    b["depths"] = torch.round(a["depths"] * 2.0) / 2.0
    return b


CASES = {
    # test_torch_tiling.py's cases
    "base": (dict(), dict()),
    "rect_tile": (dict(), dict(tile_size=(16, 8))),
    "capped_stream": (dict(), dict(max_total_entries=700)),
    "overflow_tile": (dict(stack=120), dict(max_per_tile=32)),
    "near_plane_casts": (dict(near=True), dict()),
    "near_plane_casts_nocull": (dict(near=True), dict(conics=None)),
    # and the kernels' own
    "equal_depths": (dict(stack=60, ties=True), dict()),
    "zero_rows": (dict(zero=True), dict()),
    "tile_budget": (dict(stack=80), dict(max_per_tile=48, tile_budget="front")),
    "cut_inside_a_tile": (dict(stack=60), dict(max_total_entries="inside")),
    "row_strip": (dict(), dict(img_h=16, full_img_h=H, row0_px=torch.tensor(16.0))),
    "row_strip_number": (dict(), dict(img_h=12, full_img_h=H, row0_px=8.0)),
    "count_over_k": (dict(stack=120), dict(max_per_tile=16, tile_budget="front")),
}


def _case(name):
    spec, over = CASES[name]
    a = _projected(stack=spec.get("stack", 0), near=spec.get("near", False))
    if spec.get("ties"):
        a = _ties(a)
    if spec.get("zero"):
        a = _zero_rows(a)
    kw = _kw(a, **{k: v for k, v in over.items() if k not in ("tile_budget", "max_total_entries")})
    if over.get("tile_budget") == "front":
        k = kw["max_per_tile"]
        # a slab's budget: K less a made-up front slab's rows, never below 0
        kw["tile_budget"] = lambda c: torch.clamp(k - (c * 2) // 3, min=0, max=k).to(c.dtype)
    if "max_total_entries" in over:
        cap = over["max_total_entries"]
        kw["max_total_entries"] = _cut_inside_a_tile(a, kw) if cap == "inside" else cap
    return a, kw


def _assert_contract(got, want, real_got, real_want, max_per_tile):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert int(real_got) == int(real_want)
    assert got.sorted_ids.shape == want.sorted_ids.shape
    nr = min(int(real_want), want.sorted_ids.shape[0])
    assert torch.equal(got.sorted_ids[:nr], want.sorted_ids[:nr])
    assert torch.equal(tiling.materialize(got, max_per_tile),
                       tiling.materialize(want, max_per_tile))


@pytest.mark.parametrize("chunk", [bin_tiles.SORT_CAP, 16, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_algorithm_matches_the_plain_route(case, chunk):
    a, kw = _case(case)
    want, real_want = _call(tiling._tile_lists_plain, a, kw)
    got, real, long_tiles = _call(bin_tiles.tile_lists_plain, a, kw, chunk=chunk,
                                  generator=torch.Generator().manual_seed(len(case) + chunk))
    _assert_contract(got, want, real, real_want, kw["max_per_tile"])
    pop = bin_tiles.population_plain(a["means2d"], a["extents"], a["valid"], kw["img_w"],
                                     kw["img_h"], kw["tile_size"], kw["max_tiles_per_gaussian"],
                                     kw["radius_pad"], kw["conics"], kw["opacities"], ALPHA,
                                     kw["row0_px"], kw["full_img_h"])
    assert torch.equal(pop, tiling.tile_population(
        a["means2d"], a["extents"], a["depths"], a["valid"], kw["img_w"], kw["img_h"],
        kw["tile_size"], kw["max_tiles_per_gaussian"], radius_pad=kw["radius_pad"],
        conics=kw["conics"], opacities=kw["opacities"], row0_px=kw["row0_px"],
        full_img_h=kw["full_img_h"]))
    assert int(long_tiles) == int(((pop > chunk) & (torch.cumsum(pop, 0) - pop
                                                    < want.sorted_ids.shape[0])).sum())
    if chunk == 4:
        assert int(long_tiles) > 0, "the long-segment path must run"
    if case in ("capped_stream", "cut_inside_a_tile"):
        assert int(want.entry_overflow) > 0
    if case in ("overflow_tile", "tile_budget", "count_over_k"):
        assert int(want.overflow) > 0
    if case == "zero_rows":
        assert not a["valid"][1::8].any() and int(real) > 0


def test_the_cut_falls_inside_a_tile():
    a, kw = _case("cut_inside_a_tile")
    lists, _ = _call(tiling._tile_lists_plain, a, kw)
    cap = kw["max_total_entries"]
    cnt = bin_tiles.population_plain(a["means2d"], a["extents"], a["valid"], W, H, 8, 16,
                                     a["radius_pad"], a["conics"], a["opacities"], ALPHA, 0.0,
                                     None).long()
    prefix = torch.cumsum(cnt, 0) - cnt
    t = int(torch.nonzero((prefix < cap) & (prefix + cnt > cap))[0])
    assert int(lists.starts[t]) == int(prefix[t]) and 0 < int(lists.counts[t]) <= cap - prefix[t]
    assert int(cnt[t]) >= 4 and int(lists.counts[t + 1:].sum()) == 0


def test_equal_depths_share_tiles():
    a, kw = _case("equal_depths")
    want, _ = _call(tiling._tile_lists_plain, a, kw)
    idx = tiling.materialize(want, kw["max_per_tile"])
    depth = torch.where(idx >= 0, a["depths"][idx.clamp(min=0).long()], torch.tensor(-1.0))
    ties = (depth[:, 1:] == depth[:, :-1]) & (idx[:, 1:] >= 0)
    assert int(ties.sum()) >= 10, "several Gaussians at one depth in one tile"


def test_depth_keys_order_as_torch_sort():
    """The key's bits order every float32 as a stable torch.sort does: -0.0
    equals +0.0, NaN after +inf, denormals and infinities in place."""
    vals = torch.tensor([3.5, -0.0, 0.0, float("inf"), -float("inf"), float("nan"), 1e-45,
                         -1e-45, -2.0, 0.0, -0.0, float("nan"), 2.0, 1e-38, -3.4e38, 3.4e38,
                         3.5, -2.0])
    keys = bin_tiles.depth_keys(vals)
    assert int(keys.min()) >= 0 and int(keys.max()) <= 0xFFFFFFFF
    by_key = torch.sort(keys * 64 + torch.arange(vals.shape[0])).indices
    assert torch.equal(by_key, torch.sort(vals, stable=True).indices)


def test_sort_network_sorts_any_length():
    g = torch.Generator().manual_seed(3)
    for n in list(range(1, 40)) + [63, 64, 65, 127, 200]:
        for chunk in (4, 8, 16, 4096):
            s = torch.randint(-2**62, 2**62, (n,), generator=g, dtype=torch.int64)
            got = s.clone()
            if n <= chunk:
                bin_tiles._sort_shared(got, n)
            else:
                bin_tiles._sort_long(got, n, chunk)
            assert torch.equal(got, torch.sort(s).values), (n, chunk)


def test_cpu_tensors_take_the_plain_route():
    """On CPU tensors build_tile_lists and tile_population are the plain
    route, bitwise, and launch no kernel; impl="cuda" refuses them."""
    a, kw = _case("base")
    before = (bin_tiles.tile_lists.launches, bin_tiles.population.launches)
    args = (a["means2d"], a["extents"], a["depths"], a["valid"], W, H)
    opts = dict(tile_size=8, max_per_tile=128, max_tiles_per_gaussian=16,
                radius_pad=a["radius_pad"], conics=a["conics"], opacities=a["opacities"])
    got = tiling.build_tile_lists(*args, **opts)
    want, _ = _call(tiling._tile_lists_plain, a, kw)
    for f in FIELDS + ("sorted_ids",):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.indices, tiling.materialize(want, 128))
    assert torch.equal(tiling.build_tile_lists(*args, **opts, impl="torch").sorted_ids,
                       want.sorted_ids)
    tiling.tile_population(*args, 8, 16, radius_pad=a["radius_pad"], conics=a["conics"],
                           opacities=a["opacities"])
    assert (bin_tiles.tile_lists.launches, bin_tiles.population.launches) == before
    with pytest.raises(ValueError, match="impl='cuda'"):
        tiling.build_tile_lists(*args, **opts, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tiling.tile_population(*args, 8, 16, impl="triton")


def test_plain_route_counts_no_long_tiles():
    a, kw = _case("overflow_tile")
    c = profiling.BinningCounters()
    with profiling.counting(c):
        tiling.build_tile_lists(a["means2d"], a["extents"], a["depths"], a["valid"], W, H,
                                tile_size=8, max_per_tile=32, max_tiles_per_gaussian=16,
                                radius_pad=a["radius_pad"], conics=a["conics"],
                                opacities=a["opacities"])
    _, real = _call(tiling._tile_lists_plain, a, _kw(a, max_per_tile=32))
    got = c.read()
    assert got["long_tiles"] == 0 and got["real"] == int(real) and got["binnings"] == 1


def _scene(n=400, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    means = rng.normal(size=(n, 3)) * np.array([0.5, 0.4, 0.5]) + np.array([0, 0, 4.0])
    means[:150] = np.array([0.05, 0.0, 3.5]) + rng.normal(size=(150, 3)) * 0.05
    tree = {"gaussians": {
        "means": means.astype(f32),
        "scales_log": (rng.normal(size=(n, 3)) * 0.3 - 2.6).astype(f32),
        "quats": rng.normal(size=(n, 4)).astype(f32),
        "opacities_logit": rng.normal(size=n).astype(f32),
        "features_dc": rng.normal(size=(n, 3)).astype(f32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(f32),
        "alive": np.ones(n, f32)}, "background_logit": np.zeros(3, f32)}
    cams = dict(R_c2w=np.eye(3, dtype=f32)[None], p_c2w=np.zeros((1, 3), f32),
                fx=f32([40.0]), fy=f32([40.0]), cx=f32([W / 2]), cy=f32([H / 2]),
                width=W, height=H, lin_vel=f32([[0.5, -0.3, 0.2]]),
                ang_vel=f32([[0.1, 0.15, -0.1]]), exposure_time=f32([0.06]),
                rolling_shutter_time=f32([0.04]))
    return params_from_numpy(tree, device="cpu"), cameras_from_numpy(cams, device="cpu")


def _render_grads(params, cams, cfg):
    g = params.gaussians
    leaves = [g.means, g.scales_log, g.quats, g.opacities_logit, g.features_dc,
              g.features_rest]
    for t in leaves:
        t.requires_grad_(True)
    out = sf.render_camera(params, cams, cfg, 3, torch.full((3,), 0.2))
    cot = torch.linspace(-1.0, 1.0, out.rgb.numel()).reshape(out.rgb.shape)
    grads = torch.autograd.grad((out.rgb * cot).sum() + out.transmittance.sum(), leaves)
    return [out.rgb.detach(), out.transmittance.detach()], grads


def test_sorted_ids_past_the_real_entries_are_not_read(monkeypatch):
    """A render through the sorted stream (impl "auto": the fetch and
    compositors' plain versions on the CPU) gives bitwise the same output and
    gradients when sorted_ids past the real entries holds other ids."""
    params, cams = _scene()
    cfg = sf.SplatfactoConfig(tile_size=8, max_per_tile=24, blur_samples=3)
    base_out, base_grads = _render_grads(params, cams, cfg)
    bin_orig = rasterize.bin_tiles
    seen = []

    def scrambled(*args, **kw):
        c = profiling.BinningCounters()
        with profiling.counting(c):
            lists = bin_orig(*args, **kw)
        real = min(c.read()["real"], lists.sorted_ids.shape[0])
        ids = lists.sorted_ids.clone()
        g = torch.Generator().manual_seed(len(seen))
        n = int(torch.amax(ids)) + 1
        ids[real:] = torch.randint(0, n, (ids.shape[0] - real,), generator=g,
                                   dtype=torch.int32)
        seen.append((real, ids.shape[0], bool(lists.overflow > 0)))
        return lists._replace(sorted_ids=ids)

    monkeypatch.setattr(rasterize, "bin_tiles", scrambled)
    out, grads = _render_grads(params, cams, cfg)
    assert seen and all(real < length for real, length, _ in seen)
    assert any(over for *_, over in seen), "a tile must overflow K"
    assert all(torch.equal(a, b) for a, b in zip(out, base_out))
    assert all(torch.equal(a, b) for a, b in zip(grads, base_grads))
