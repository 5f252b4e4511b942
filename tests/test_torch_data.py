"""The port's data front end against the JAX package's on the CPU.

- `generate_scene` of both packages with the same arguments (40 px, 10
  frames, shake trajectory, exposure and rolling shutter on): `transforms.json`
  and `sparse_pc.ply` byte for byte (every draw is numpy's and the
  trajectories are float64 numpy); the frames within 1 grey level, at most
  1 % of the values differing at all (both render the same Gaussians through
  their own rasterizers and quantise to 8 bits; one value in 48,000 differed
  when this was written).
- `parse_scene` of both on the JAX-written scene and on edited copies of its
  `transforms.json` (no `orientation_override`, an `applied_transform`,
  `eval_` file names): every `Cameras` field, the splits, the paths,
  `transform`, `scale` and the seed cloud, atol 1e-6 (the numpy part is the
  same code; the cameras are cast to float32 by jax.numpy and by torch).
- `png.py`: a round trip, PIL-written grey / grey+alpha / RGB / RGBA files, and
  files whose scanlines all use one of the five filters (written by a small
  encoder here and read back by PIL too), all exact; what it does not read
  raises with the file's name.
- `ImageCache` from files: bitwise the JAX package's stack for each decoder
  ("native" against its native loader, "pil" and "png" against its PIL path;
  the native decoder multiplies by a float32 1/255 where the others divide by
  255, so "native" and "pil" are not compared with each other).
"""
import dataclasses
import json
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from splat_tpu.data import dataparser as jdp
from splat_tpu.data import dataset as jds
from splat_tpu.data import native_loader as jnative
from splat_tpu.data import synthetic as jsyn
from splat_tpu_torch.data import dataparser as tdp
from splat_tpu_torch.data import dataset as tds
from splat_tpu_torch.data import native_loader as tnative
from splat_tpu_torch.data import png
from splat_tpu_torch.data import synthetic as tsyn

SCENE = dict(n_gaussians=120, n_frames=10, img_size=40, exposure=0.1, rolling_shutter=0.03,
             n_blur_samples=3, seed=3, trajectory="shake", n_seed_points=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    jdir, tdir = tmp_path_factory.mktemp("scene_jax"), tmp_path_factory.mktemp("scene_torch")
    jsyn.generate_scene(jdir, **SCENE)
    tsyn.generate_scene(tdir, device="cpu", **SCENE)
    return jdir, tdir


def test_generate_scene_matches_jax_generator(scenes):
    jdir, tdir = scenes
    for name in ("transforms.json", "sparse_pc.ply"):
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    names = sorted(p.name for p in (jdir / "images").iterdir())
    assert names == sorted(p.name for p in (tdir / "images").iterdir())
    assert len(names) == SCENE["n_frames"]
    differing = total = 0
    for name in names:
        a = np.asarray(Image.open(jdir / "images" / name)).astype(np.int32)
        b = png.read_png(tdir / "images" / name).astype(np.int32)
        assert a.shape == b.shape == (40, 40, 3)
        assert a.std() > 5, "the frame shows the scene"
        diff = np.abs(a - b)
        assert diff.max() <= 1, name
        differing += int((diff > 0).sum())
        total += diff.size
    assert differing <= 0.01 * total, differing / total


def _edited(scene_dir, out_dir, edit):
    """A copy of the scene's metadata (json and seed cloud) with `edit`
    applied to the json; parsing opens no image."""
    out_dir.mkdir()
    meta = json.loads((scene_dir / "transforms.json").read_text())
    edit(meta)
    (out_dir / "transforms.json").write_text(json.dumps(meta))
    shutil.copy(scene_dir / "sparse_pc.ply", out_dir / "sparse_pc.ply")
    return out_dir


def _no_override(meta):
    del meta["orientation_override"]


def _applied(meta):
    _no_override(meta)
    meta["applied_transform"] = [[0.0, 1.0, 0.0, 0.1], [1.0, 0.0, 0.0, -0.2], [0.0, 0.0, -1.0, 0.3]]
    meta["frames"][3]["fl_x"] = 50.0         # per-frame overrides
    meta["frames"][4]["exposure_time"] = 0.02


def _eval_names(meta):
    for i in (2, 7):
        meta["frames"][i]["file_path"] = f"images/eval_{i:05d}.png"


PARSE_CASES = [
    # (json edit, DataParserConfig fields)
    (None, dict(eval_mode="interval", eval_interval=4)),
    (None, dict(eval_mode="all", auto_scale_poses=False)),
    (None, dict(eval_mode="fraction", train_split_fraction=0.7, downscale_factor=2)),
    (_eval_names, dict(eval_mode="filename", center_method="none")),
    (_no_override, dict(orientation_method="up")),
    (_no_override, dict(orientation_method="pca", auto_scale_poses=False)),
    (_no_override, dict(orientation_method="none", eval_interval=3)),
    (_applied, dict(orientation_method="up", downscale_factor=2)),
]


@pytest.mark.parametrize("edit,fields", PARSE_CASES,
                         ids=[f"{e.__name__ if e else 'asis'}-{'-'.join(map(str, f.values()))}"
                              for e, f in PARSE_CASES])
def test_parse_scene_matches_jax_parser(scenes, tmp_path, edit, fields):
    scene_dir = scenes[0] if edit is None else _edited(scenes[0], tmp_path / "edited", edit)
    want = jdp.parse_scene(scene_dir, jdp.DataParserConfig(**fields))
    got = tdp.parse_scene(scene_dir, tdp.DataParserConfig(**fields))
    for split in ("train", "eval"):
        jc, tc = getattr(want, f"{split}_cameras"), getattr(got, f"{split}_cameras")
        assert len(tc) == len(jc) > 0
        assert (tc.width, tc.height) == (jc.width, jc.height)
        assert tc.R_c2w.device.type == "cpu"
        for field in tc._tensor_fields:
            np.testing.assert_allclose(getattr(tc, field).numpy(), np.asarray(getattr(jc, field)),
                                       rtol=0, atol=1e-6, err_msg=f"{split} {field}")
        assert getattr(got, f"{split}_paths") == getattr(want, f"{split}_paths")
        np.testing.assert_array_equal(getattr(got, f"{split}_indices"),
                                      getattr(want, f"{split}_indices"))
    np.testing.assert_allclose(got.transform, want.transform, rtol=0, atol=1e-6)
    assert got.scale == pytest.approx(want.scale, abs=1e-6)
    np.testing.assert_allclose(got.points_xyz, want.points_xyz, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.points_rgb, want.points_rgb)
    assert got.metadata["distortion"] == want.metadata["distortion"]
    assert got.metadata["downscale_factor"] == want.metadata["downscale_factor"]
    jdp.save_dataparser_transforms(tmp_path / "j.json", want)
    tdp.save_dataparser_transforms(tmp_path / "t.json", got)
    assert json.loads((tmp_path / "t.json").read_text()).keys() == \
        json.loads((tmp_path / "j.json").read_text()).keys()


def test_parse_scene_raises_as_the_jax_parser(scenes, tmp_path):
    for mod in (jdp, tdp):
        with pytest.raises(ValueError, match="no eval_"):
            mod.parse_scene(scenes[0], mod.DataParserConfig(eval_mode="filename"))
        with pytest.raises(ValueError, match="unknown eval_mode"):
            mod.parse_scene(scenes[0], mod.DataParserConfig(eval_mode="blur"))
    empty = _edited(scenes[0], tmp_path / "empty", lambda meta: meta.update(frames=[]))
    with pytest.raises(ValueError, match="no frames"):
        tdp.parse_scene(empty)


def _encode(image: np.ndarray, kind: int) -> bytes:
    """A PNG of `image` (H, W) or (H, W, C) uint8 whose scanlines all use
    filter `kind`, by the specification's own definitions."""
    h, w = image.shape[:2]
    ch = 1 if image.ndim == 2 else image.shape[2]
    flat = image.reshape(h, w * ch).astype(np.int32)
    lines = bytearray()
    for y in range(h):
        cur = flat[y]
        up = flat[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        lines += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(name, body):
        return struct.pack(">I", len(body)) + name + body + struct.pack(
            ">I", zlib.crc32(name + body))

    colour = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (png.MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(lines))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_takes_every_filter_and_layout(tmp_path, kind, channels):
    rng = np.random.default_rng(10 * kind + channels)
    image = rng.integers(0, 256, size=(19, 23, channels), dtype=np.uint8)
    if channels == 1:
        image = image[..., 0]
    path = tmp_path / "f.png"
    path.write_bytes(_encode(image, kind))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), image)   # the encoder is right
    np.testing.assert_array_equal(png.read_png(path), image)


def test_png_round_trip_and_pil_written_files(tmp_path):
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    png.write_png(tmp_path / "w.png", image)
    np.testing.assert_array_equal(png.read_png(tmp_path / "w.png"), image)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")), image)
    yy, xx = np.mgrid[0:64, 0:80]        # smooth: PIL's encoder picks its filters row by row
    smooth = np.stack([(xx * 3) % 256, (yy * 4 + xx) % 256, (xx * yy // 8) % 256,
                       (255 - xx) % 256], -1).astype(np.uint8)
    for mode, arr in (("L", smooth[..., 0]), ("LA", smooth[..., :2]), ("RGB", smooth[..., :3]),
                      ("RGBA", smooth)):
        Image.fromarray(arr, mode).save(tmp_path / f"{mode}.png", optimize=True)
        np.testing.assert_array_equal(png.read_png(tmp_path / f"{mode}.png"), arr)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(tmp_path / "w.png", image.astype(np.float32))


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 65535, size=(8, 8)).astype(np.uint16)).save(tmp_path / "deep.png")
    Image.fromarray(rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)).convert(
        "P").save(tmp_path / "palette.png")
    (tmp_path / "not.png").write_bytes(b"JFIF....")
    for name in ("deep.png", "palette.png", "not.png"):
        with pytest.raises(ValueError, match=name):
            png.read_png(tmp_path / name)


def test_image_cache_from_files_matches_jax_cache(scenes):
    jdir, _ = scenes
    paths = sorted(str(p) for p in (jdir / "images").iterdir())
    pil_stack = np.stack([jds._load_image(p, 1, None) for p in paths])
    for decoder in ("pil", "png"):
        cache = tds.ImageCache(paths, decoder=decoder)
        assert cache.decoder == decoder and len(cache) == len(paths)
        np.testing.assert_array_equal(cache.images, pil_stack)
    native = jnative.load_images(paths, 1)
    assert (native is None) == (tnative.load_images(paths, 1) is None)
    if native is not None:
        cache = tds.ImageCache(paths, decoder="native")
        np.testing.assert_array_equal(cache.images, native)
        np.testing.assert_array_equal(tds.ImageCache(paths, 2).images,
                                      jds.ImageCache(paths, 2).images)
    # the default order: native, then PIL (here), then png.py
    auto = tds.ImageCache(paths)
    np.testing.assert_array_equal(auto.images, jds.ImageCache(paths).images)
    assert auto.decoder == ("native" if native is not None else "pil")
    assert auto.decode_seconds > 0
    with pytest.raises(ValueError, match="downscale"):
        tds.ImageCache(paths, 2, decoder="png")
    np.testing.assert_array_equal(tds.ImageCache(paths, 2, decoder="pil").images,
                                  np.stack([jds._load_image(p, 2, None) for p in paths]))


def test_image_cache_from_arrays_and_scene_images(scenes):
    jdir, _ = scenes
    cfg = dict(eval_mode="interval", eval_interval=4)
    scene = tdp.parse_scene(jdir, tdp.DataParserConfig(**cfg))
    train, evals = tds.load_scene_images(scene)
    jtrain, jevals = jds.load_scene_images(jdp.parse_scene(jdir, jdp.DataParserConfig(**cfg)))
    np.testing.assert_array_equal(train.images, jtrain.images)
    np.testing.assert_array_equal(evals.images, jevals.images)
    assert train.paths == scene.train_paths and len(evals) == 3
    stack = tds.ImageCache.from_arrays(train.images.astype(np.float64))
    assert stack.decoder == "arrays" and stack.images.dtype == np.float32
    assert stack.paths[0] == "frame_00000" and len(stack) == len(train)
    with pytest.raises(ValueError, match="image stack"):
        tds.ImageCache.from_arrays(train.images[0])
    grey = dataclasses.replace(scene, train_paths=[])
    assert tds.ImageCache(grey.train_paths).images.shape == (0, 0, 0, 3)
