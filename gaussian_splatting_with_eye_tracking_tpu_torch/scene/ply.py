"""Minimal PLY reader/writer (binary little-endian + ascii), numpy only.

Port (an own copy) of ``read_ply``, ``write_ply``, ``fetch_point_cloud``
and ``store_point_cloud`` from
``gaussian_splatting_with_eye_tracking_tpu/scene/ply.py``; files written by
either package read back bit-for-bit in the other.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}
_NP_TO_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int"}


def _skip_list_element(f, fmt: str, count: int, plist) -> None:
    if fmt == "ascii":
        for _ in range(count):
            f.readline()
        return
    for _ in range(count):
        for t, _pn in plist:
            if t.startswith("list:"):
                _, cnt_t, val_t = t.split(":")
                cnt = np.frombuffer(
                    f.read(np.dtype(_PLY_TO_NP[cnt_t]).itemsize), _PLY_TO_NP[cnt_t])[0]
                f.read(int(cnt) * np.dtype(_PLY_TO_NP[val_t]).itemsize)
            else:
                f.read(np.dtype(_PLY_TO_NP[t]).itemsize)


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element into {property_name: (N,) array}."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = "binary_little_endian"
        elements: List[Tuple[str, int]] = []
        props: Dict[str, List[Tuple[str, str]]] = {}
        cur = None
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = parts[1]
                elements.append((cur, int(parts[2])))
                props[cur] = []
            elif parts[0] == "property" and cur is not None:
                if parts[1] == "list":
                    props[cur].append(("list:" + parts[2] + ":" + parts[3], parts[4]))
                else:
                    props[cur].append((parts[1], parts[2]))

        out: Dict[str, np.ndarray] = {}
        for name, count in elements:
            plist = props[name]
            if any(t.startswith("list:") for t, _ in plist):
                _skip_list_element(f, fmt, count, plist)  # faces: read & discard
                continue
            dtype = np.dtype([(pn, _PLY_TO_NP[t]) for t, pn in plist])
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                arr = np.array([tuple(r) for r in rows], dtype=dtype)
            else:
                arr = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
            if name == "vertex":
                for _t, pn in plist:
                    out[pn] = np.ascontiguousarray(arr[pn])
        return out


def write_ply(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Write a 'vertex' element, binary little-endian, fields in dict order."""
    names = list(fields)
    n = len(fields[names[0]])
    for k in names:
        v = np.asarray(fields[k])
        if v.shape != (n,):
            raise ValueError(f"write_ply: field {k} has shape {v.shape}, expected ({n},)")
    dtype = np.dtype([(k, np.asarray(fields[k]).dtype.str[1:]) for k in names])
    rec = np.empty(n, dtype=dtype)
    for k in names:
        rec[k] = fields[k]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for k in names:
            t = _NP_TO_PLY[np.asarray(fields[k]).dtype.str[1:]]
            f.write(f"property {t} {k}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def fetch_point_cloud(path: str):
    """(points, colors, normals) float32 (N, 3) from a point-cloud PLY;
    uchar colors scaled to [0, 1] (0.5 gray without colors), zero normals
    without normals."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    if "red" in v:
        colors = np.stack([v["red"], v["green"], v["blue"]], -1).astype(np.float32) / 255.0
    else:
        colors = np.full_like(pts, 0.5)
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], -1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, colors, normals


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write xyz (float32), zero normals and uchar rgb, as the reference's
    ``storePly``."""
    fields = {
        "x": xyz[:, 0].astype(np.float32),
        "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "nx": np.zeros(len(xyz), np.float32),
        "ny": np.zeros(len(xyz), np.float32),
        "nz": np.zeros(len(xyz), np.float32),
        "red": rgb[:, 0].astype(np.uint8),
        "green": rgb[:, 1].astype(np.uint8),
        "blue": rgb[:, 2].astype(np.uint8),
    }
    write_ply(path, fields)
