"""The compositor's backward against the JAX package on the CPU.

1. `rasterize_bwd_plain` against the Pallas backward kernels (interpret
   mode, as tests/test_pallas.py runs them): `rasterize_bwd_packed` in the
   (T, 13, K) row layout and `rasterize_bwd_gpacked` in the (T, K, 13)
   G-major layout, on the same blocks, forward output and seeded cotangent,
   with one empty and one full (count = K) tile. Tolerance per column:
   |port - jax| <= 2e-5 * max|jax column| + 1e-7 (the largest seen is
   5e-6). The per-pixel math is the same; the TPU kernels sum over pixels
   through moment matmuls (expanding (px - mx)^2 and cancelling), the port
   sums each term directly.
2. Gradients of `rasterize` and `rasterize_fused(reduce="mean")` with
   respect to colours, opacities, means2d, conics and pixel velocities, on
   both the "auto" route (sorted stream, entry_slots gather backward) and the
   "torch" route (dense id table), against `jax.grad` of the jnp tile path:
   atol 2e-4, rtol 1e-3, as tests/test_pallas.py holds the Pallas kernels.
3. The kernel route's autograd graph holds no scatter-add node.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import IMG_H, IMG_W, K, _blocks

from splat_tpu.ops import projection as jproj
from splat_tpu.ops import rasterize as jrast
from splat_tpu.ops import tiling as jtiling
from splat_tpu.ops.pallas.rasterize_kernels import rasterize_bwd_packed, rasterize_fwd_packed
from splat_tpu.ops.pallas.rasterize_kernels_gmajor import rasterize_bwd_gpacked
from splat_tpu_torch.ops import projection as tproj
from splat_tpu_torch.ops import rasterize as trast
from splat_tpu_torch.ops.cuda import rasterize_kernels as trk

CASES = [
    # (tile_size, n_samples, rs_time, row_offset)
    (8, 1, 0.0, 0.0),
    (8, 5, 0.04, 16.0),
    ((16, 8), 5, 0.04, 8.0),
    ((16, 8), 1, 0.0, 0.0),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here, and
    the suite's xdist workers would each start a full intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tile_size,n_samples,rs,row_off", CASES)
@pytest.mark.parametrize("layout", ["packed", "gpacked"])
def test_rasterize_bwd_plain_matches_pallas(tile_size, n_samples, rs, row_off, layout):
    blocks, counts = _blocks(tile_size)
    n_tiles = blocks.shape[0]
    tiles_x = jtiling.num_tiles(IMG_W, IMG_H, tile_size)[0]
    full_h = IMG_H + 2 * int(row_off)
    eps = np.linspace(-0.5, 0.5, n_samples).astype(np.float32) * 0.06
    jargs = (jnp.asarray(counts), jnp.float32(rs))
    jkw = dict(tile_size=tile_size, tiles_x=tiles_x, img_h=full_h,
               row_offset=jnp.float32(row_off), eps=jnp.asarray(eps))
    rows = jnp.asarray(blocks).transpose(0, 2, 1)                  # (T, 13, K)
    fwd = rasterize_fwd_packed(rows, *jargs, **jkw)                 # (T, S, 8, npix)
    rng = np.random.default_rng(5)
    g_out = np.zeros(fwd.shape, np.float32)
    g_out[:, :, :trk.NOUT] = rng.normal(size=g_out[:, :, :trk.NOUT].shape)
    if layout == "packed":
        want = np.asarray(rasterize_bwd_packed(rows, *jargs, fwd, jnp.asarray(g_out), **jkw))
        want = want.transpose(0, 2, 1)                              # (T, K, 13)
    else:
        want = np.asarray(rasterize_bwd_gpacked(jnp.asarray(blocks), *jargs, fwd,
                                                jnp.asarray(g_out), **jkw))

    padded = torch.nn.functional.pad(torch.tensor(blocks), (0, trk.PARAM_STRIDE - trk.NPARAM))
    scalars = trk.scalar_vec(rs, row_off, torch.tensor(eps), torch.device("cpu"))
    got = trk.rasterize_bwd(
        padded, torch.tensor(counts, dtype=torch.int32), scalars,
        torch.tensor(np.asarray(fwd)[:, :, :trk.NOUT]).contiguous(),
        torch.tensor(g_out[:, :, :trk.NOUT]).contiguous(), tile_size, tiles_x, full_h).numpy()
    assert got.shape == (n_tiles, K, trk.PARAM_STRIDE)
    assert not got[:, :, trk.NPARAM - 1:].any(), "log-opacity and pad columns are zero"
    assert not got[0].any(), "the empty tile has no gradient"
    for n, c in zip(counts, got):
        assert not c[n:].any(), "slots past the count have no gradient"
    for col in range(trk.NPARAM - 1):
        scale = np.abs(want[:, :, col]).max()
        assert scale > 0, col
        np.testing.assert_allclose(got[:, :, col], want[:, :, col], rtol=0,
                                   atol=2e-5 * scale + 1e-7, err_msg=f"column {col}")


def _scene(n=80, seed=2, img_w=24, img_h=16):
    """tests/test_pallas.py's gradient scene: JAX-projected, numpy-seeded."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)) * np.array([0.45, 0.4, 0.8]) + np.array([0, 0, 4.0])
    scales = np.exp(rng.normal(size=(n, 3)) * 0.35) * 0.12
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    colors = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, size=(n,)).astype(np.float32)
    proj = jproj.project_gaussians(
        *(jnp.asarray(a, jnp.float32) for a in (means, scales, quats)),
        jnp.eye(3), jnp.zeros(3), 40.0, 40.0, img_w / 2, img_h / 2, img_w, img_h,
        lin_vel=jnp.array([0.5, -0.3, 0.2]), ang_vel=jnp.array([0.1, 0.15, -0.1]))
    return proj, colors, opac


GRAD_NAMES = ["colors", "opac", "means2d", "conics", "pix_vels"]


def _loss_terms(rgb, alpha, depth, tgt):
    return ((rgb - tgt) ** 2).mean() + 0.1 * alpha.mean() + 0.05 * (depth * alpha).mean()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_rasterize_gradients_match_jax(fused, impl):
    w, h = 24, 16
    proj, colors, opac = _scene(img_w=w, img_h=h)
    bg = np.float32([0.5, 0.4, 0.3])
    tgt = np.random.default_rng(4).uniform(size=(h, w, 3)).astype(np.float32)
    eps = np.float32([-0.03, 0.0, 0.02])
    kw = dict(tile_size=8, max_per_tile=128, max_tiles_per_gaussian=16,
              rolling_shutter_time=0.05)

    def j_loss(colors, opac, means2d, conics, pix_vels):
        p = proj._replace(means2d=means2d, conics=conics, pix_vels=pix_vels)
        if fused:
            out = jrast.rasterize_fused(p, colors, opac, w, h, jnp.asarray(bg),
                                        eps=jnp.asarray(eps), reduce="mean", impl="jnp",
                                        chunk=16, **kw)
        else:
            out = jrast.rasterize(p, colors, opac, w, h, jnp.asarray(bg), impl="jnp",
                                  chunk=16, **kw)
        return _loss_terms(out.rgb, out.alpha, out.depth, jnp.asarray(tgt))

    args = (jnp.asarray(colors), jnp.asarray(opac), proj.means2d, proj.conics, proj.pix_vels)
    want = jax.grad(j_loss, argnums=tuple(range(5)))(*args)

    leaves = [torch.tensor(np.array(a)).requires_grad_(True) for a in args]
    tp = tproj.ProjectedGaussians(*(torch.tensor(np.array(f)) for f in proj))
    tp = tp._replace(means2d=leaves[2], conics=leaves[3], pix_vels=leaves[4])
    if fused:
        out = trast.rasterize_fused(tp, leaves[0], leaves[1], w, h, torch.tensor(bg),
                                    eps=torch.tensor(eps), reduce="mean", impl=impl, **kw)
    else:
        out = trast.rasterize(tp, leaves[0], leaves[1], w, h, torch.tensor(bg), impl=impl, **kw)
    _loss_terms(out.rgb, out.alpha, out.depth, torch.tensor(tgt)).backward()
    for name, leaf, gj in zip(GRAD_NAMES, leaves, want):
        gj = np.asarray(gj)
        assert np.abs(gj).sum() > 0, f"zero reference gradient for {name}"
        np.testing.assert_allclose(leaf.grad.numpy(), gj, atol=2e-4, rtol=1e-3,
                                   err_msg=f"gradient of {name}")


SCATTER_NODES = ("IndexBackward", "IndexPutBackward", "IndexAddBackward",
                 "IndexSelectBackward", "ScatterAddBackward", "GatherBackward",
                 "EmbeddingBackward", "PutBackward")


def _graph_nodes(root):
    seen, todo = set(), [root]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_backward_graph_has_no_scatter_add(impl):
    """Neither route's tape holds an accumulating index_put_ (the backward of
    advanced indexing) or another scatter-add: the per-tile fetches and the
    compositor carry gather-form backwards of their own."""
    w, h = 24, 16
    proj, colors, opac = _scene(img_w=w, img_h=h)
    tp = tproj.ProjectedGaussians(*(torch.tensor(np.array(f)) for f in proj))
    tp = tp._replace(means2d=tp.means2d.requires_grad_(True))
    out = trast.rasterize_fused(tp, torch.tensor(colors).requires_grad_(True),
                                torch.tensor(opac), w, h, torch.zeros(3),
                                eps=torch.tensor([-0.02, 0.02]), reduce="mean", tile_size=8,
                                max_per_tile=128, max_tiles_per_gaussian=16, impl=impl)
    names = _graph_nodes(out.rgb.sum().grad_fn)
    bad = sorted(n for n in names if n.startswith(SCATTER_NODES))
    assert not bad, bad
    assert any("Composite" in n for n in names), names
