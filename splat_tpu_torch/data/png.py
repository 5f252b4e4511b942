"""An 8-bit PNG reader and writer on the standard library's `zlib` and numpy.

It stands in for PIL where there is none: `data.dataset` reads training
images through it and `data.synthetic` writes its frames with it.

`read_png` takes non-interlaced 8-bit greyscale, greyscale + alpha, RGB and
RGBA files with any of the five scanline filters and returns the pixels as
they are stored, (H, W) or (H, W, C) uint8; anything else (16-bit, palette,
Adam7) raises ValueError with the file's name. `write_png` writes (H, W, 3)
uint8 as RGB8 with the Sub filter on every scanline. `decode_png` and
`encode_png` do the same on bytes in memory (the viewer serves them).
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}    # colour type -> samples per pixel


def _unfilter_sequential(kind: int, line: np.ndarray, up: np.ndarray, ch: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte needs the one `ch` to its left."""
    src, prev = line.tolist(), up.tolist()
    out = [0] * len(src)
    for x, v in enumerate(src):
        a = out[x - ch] if x >= ch else 0
        b = prev[x]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[x - ch] if x >= ch else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[x] = (v + pred) & 255
    return np.array(out, dtype=np.uint8)


def read_png(path: str | Path) -> np.ndarray:
    """The file's pixels: (H, W) uint8 for greyscale, else (H, W, C)."""
    return decode_png(Path(path).read_bytes(), path)


def decode_png(data: bytes, path: str | Path = "<bytes>") -> np.ndarray:
    """The pixels of a PNG held in memory (`path` names it in errors)."""
    if data[:8] != MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or interlace != 0 or colour not in _CHANNELS:
        raise ValueError(f"{path}: only non-interlaced 8-bit grey, grey+alpha, RGB and RGBA "
                         f"PNGs are read (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[colour]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != (stride + 1) * h:
        raise ValueError(f"{path}: {raw.size} bytes of scanlines for a {w}x{h}x{ch} image")
    raw = raw.reshape(h, stride + 1)
    img = np.empty((h, stride), dtype=np.uint8)
    up = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            img[y] = line
        elif kind == 1:      # Sub: a running sum per channel, modulo 256
            img[y] = np.cumsum(line.reshape(w, ch), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:      # Up
            img[y] = line + up
        elif kind in (3, 4):
            img[y] = _unfilter_sequential(kind, line, up, ch)
        else:
            raise ValueError(f"{path}: unknown scanline filter {kind} in row {y}")
        up = img[y]
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str | Path, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as an RGB8 PNG."""
    Path(path).write_bytes(encode_png(image))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 as the bytes of an RGB8 PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png wants (H, W, 3) uint8, got {image.shape} {image.dtype}")
    h, w, _ = image.shape
    lines = np.empty((h, 1 + w * 3), dtype=np.uint8)
    lines[:, 0] = 1                                         # Sub on every scanline
    diff = image.copy()
    diff[:, 1:] -= image[:, :-1]                            # modulo 256
    lines[:, 1:] = diff.reshape(h, w * 3)
    return (MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(lines.tobytes())) + _chunk(b"IEND", b""))
