"""Point-cloud file I/O, dependency-free numpy implementations.

The port's own copy of :mod:`bufferx_tpu.data.io`.

The reference leans on Open3D's C++ readers (``o3d.io.read_point_cloud``,
``dataset/threedmatch.py:75``); here the formats used by the 13 benchmark
datasets are implemented directly:

- PLY (ascii + binary little/big endian) — 3DMatch fragments, ETH
- PCD (ascii + binary + binary_compressed unsupported) — MIT, Oxford, TIERS
- KITTI/HeLiPR ``.bin`` (float32 x,y,z,intensity records)
- ``.npy`` passthrough
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["read_points", "read_ply", "read_pcd", "read_kitti_bin", "save_ply"]

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> np.ndarray:
    """Reads vertex x/y/z from a PLY file -> [N, 3] float32."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype), ...])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                cur = (tok[1].decode(), int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == b"property":
                if tok[1] == b"list":
                    cur[2].append((tok[4].decode(), "list", tok[2], tok[3]))
                else:
                    cur[2].append(
                        (tok[2].decode(), _PLY_DTYPES[tok[1].decode()])
                    )
            elif tok[0] == b"end_header":
                break

        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        for name, count, props in elements:
            if name != "vertex":
                # skip non-vertex elements only if they come after vertex
                break
            names = [p[0] for p in props]
            if any(p[1] == "list" for p in props):
                raise ValueError(f"{path}: list property in vertex element")
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                arr = np.asarray(rows, dtype=np.float64)
                data = {n: arr[:, i] for i, n in enumerate(names)}
            else:
                dt = np.dtype([(p[0], endian + p[1]) for p in props])
                raw = np.frombuffer(f.read(count * dt.itemsize), dtype=dt,
                                    count=count)
                data = {n: raw[n] for n in names}
            return np.stack(
                [data["x"], data["y"], data["z"]], axis=-1
            ).astype(np.float32)
    raise ValueError(f"{path}: no vertex element found")


def read_pcd(path: str) -> np.ndarray:
    """Reads x/y/z from a PCD file -> [N, 3] float32."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        counts = list(map(int, header.get("COUNT", " ".join(["1"] * len(fields))).split()))
        n = int(header["POINTS"])
        mode = header["DATA"].split()[0]

        np_types = {"F": "f", "I": "i", "U": "u"}
        if mode == "ascii":
            arr = np.loadtxt(f, dtype=np.float64, max_rows=n)
            arr = np.atleast_2d(arr)
            cols = {}
            ci = 0
            for fname, cnt in zip(fields, counts):
                cols[fname] = arr[:, ci]
                ci += cnt
        elif mode == "binary":
            dt = np.dtype(
                [
                    (fname if cnt == 1 else f"{fname}", f"{np_types[t]}{s}")
                    if cnt == 1
                    else (fname, f"({cnt},){np_types[t]}{s}")
                    for fname, s, t, cnt in zip(fields, sizes, types, counts)
                ]
            )
            raw = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            cols = {fname: raw[fname] for fname in fields}
        else:
            raise ValueError(f"{path}: unsupported PCD DATA mode {mode!r}")
        pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1)
        return np.asarray(pts, np.float32)


def read_kitti_bin(path: str) -> np.ndarray:
    """KITTI velodyne / HeLiPR binary scans: float32 (x, y, z, intensity)."""
    raw = np.fromfile(path, dtype=np.float32)
    return raw.reshape(-1, 4)[:, :3].copy()


def read_points(path: str) -> np.ndarray:
    """Extension-dispatched reader -> [N, 3] float32."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return read_ply(path)
    if ext == ".pcd":
        return read_pcd(path)
    if ext == ".bin":
        return read_kitti_bin(path)
    if ext == ".npy":
        return np.asarray(np.load(path), np.float32)[:, :3]
    if ext == ".npz":
        z = np.load(path)
        key = "points" if "points" in z else list(z.keys())[0]
        return np.asarray(z[key], np.float32)[:, :3]
    raise ValueError(f"unsupported point cloud format: {path}")


def save_ply(path: str, points: np.ndarray) -> str:
    """Writes [N, 3] points as a binary little-endian PLY (x, y, z float):
    the JAX package's ``utils/vis.py:save_ply`` without colors."""
    points = np.asarray(points, np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % len(points))
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"end_header\n")
        f.write(points.astype("<f4").tobytes())
    return path
