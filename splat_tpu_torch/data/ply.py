"""Minimal PLY point-cloud I/O (ascii + binary_little_endian).

Covers the reference data contract's `sparse_pc.ply` seed clouds
(`ply_file_path`, reference process_synthetic_inputs.py:203-219,298): vertices
with float x/y/z and optional uchar red/green/blue. No external deps.
"""
from __future__ import annotations

import io
from pathlib import Path

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply(path: str | Path) -> dict[str, np.ndarray]:
    """Read vertex element -> {'xyz': (N,3) f32, 'rgb': (N,3) u8 or None}."""
    raw = Path(path).read_bytes()
    header_end = raw.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = raw[:header_end].decode("ascii", errors="replace").splitlines()
    body = raw[header_end + len(b"end_header\n"):]

    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: missing 'ply' magic")
    fmt = None
    n_vertex = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header[1:]:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n_vertex = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError(f"{path}: list properties unsupported in vertex")
            props.append((parts[2], _DTYPES[parts[1]]))

    dtype = np.dtype([(name, dt) for name, dt in props])
    if fmt == "binary_little_endian":
        verts = np.frombuffer(body[: n_vertex * dtype.itemsize], dtype=dtype)
    elif fmt == "ascii":
        verts = np.loadtxt(io.BytesIO(body), dtype=np.float64, max_rows=n_vertex, ndmin=2)
        rec = np.zeros(n_vertex, dtype=dtype)
        for i, (name, _) in enumerate(props):
            rec[name] = verts[:, i]
        verts = rec
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    xyz = np.stack([verts["x"], verts["y"], verts["z"]], axis=-1).astype(np.float32)
    rgb = None
    if all(k in dtype.names for k in ("red", "green", "blue")):
        rgb = np.stack([verts["red"], verts["green"], verts["blue"]], axis=-1).astype(np.uint8)
    return {"xyz": xyz, "rgb": rgb}


def write_ply(path: str | Path, xyz: np.ndarray, rgb: np.ndarray | None = None) -> None:
    """Write (N,3) float points (+ optional (N,3) uint8 colors), binary LE."""
    xyz = np.asarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    lines = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x", "property float y", "property float z",
    ]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if rgb is not None:
        rgb = np.asarray(rgb, dtype=np.uint8)
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    lines.append("end_header")
    rec = np.zeros(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if rgb is not None:
        rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(rec.tobytes())
