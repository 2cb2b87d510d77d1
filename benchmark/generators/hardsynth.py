"""Hard synthetic registration pairs (frozen copy of the program's
``data/hardsynth.py``, numpy only, the same random streams).

Room-scale ``eval_scene`` (floor, walls, boxes, cylinders, blobs) and
object-scale ``train_scene`` families of parametric surfaces; source and
target sample the surfaces independently. :func:`hard_pair` crops the two
clouds by half-spaces to a true overlap ratio and applies the sensor knobs:
Gaussian noise in meters, density mismatch (the target subsampled
``density_ratio``:1) and uniform clutter in the scene's bounding box.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

__all__ = [
    "train_scene",
    "eval_scene",
    "sample_scene",
    "hard_pair",
]


# ---------------------------------------------------------------------------
# parametric primitives: params are drawn ONCE per scene; sample() draws
# fresh points every call (independent src/tgt sampling)
# ---------------------------------------------------------------------------


def _sinusoid_field(rs, k, dim, freq_scale, amp_lo, amp_hi):
    return dict(
        freqs=rs.randn(k, dim) * freq_scale,
        amps=rs.uniform(amp_lo, amp_hi, k),
        phases=rs.uniform(0, 2 * np.pi, k),
    )


def _eval_field(field, x):
    """x: [N, dim] -> [N] sum of directional sinusoids."""
    return np.sin(x @ field["freqs"].T + field["phases"]) @ field["amps"]


class _Blob(NamedTuple):
    """Displacement-modulated ellipsoidal shell."""

    center: np.ndarray
    radii: np.ndarray
    rot: np.ndarray
    field: dict
    bump: float

    def sample(self, rs, n):
        v = rs.randn(n, 3)
        v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9
        r = 1.0 + self.bump * _eval_field(self.field, v)
        pts = (v * r[:, None]) * self.radii
        return pts @ self.rot.T + self.center

    def area(self):
        return 4 * np.pi * float(np.mean(self.radii)) ** 2


class _Plane(NamedTuple):
    """Relief-modulated planar patch (floor / wall / facet / box face)."""

    origin: np.ndarray
    u: np.ndarray          # in-plane basis x size
    v: np.ndarray
    normal: np.ndarray
    field: dict
    relief: float

    def sample(self, rs, n):
        uv = rs.uniform(-0.5, 0.5, (n, 2))
        h = self.relief * _eval_field(self.field, uv)
        return (
            self.origin
            + uv[:, :1] * self.u
            + uv[:, 1:] * self.v
            + h[:, None] * self.normal
        )

    def area(self):
        return float(np.linalg.norm(self.u) * np.linalg.norm(self.v))


class _Cylinder(NamedTuple):
    """Radially-modulated open cylinder (pillar / barrel)."""

    base: np.ndarray
    rot: np.ndarray        # local z = axis
    radius: float
    height: float
    field: dict
    bump: float

    def sample(self, rs, n):
        th = rs.uniform(0, 2 * np.pi, n)
        z = rs.uniform(0, self.height, n)
        m = 1.0 + self.bump * _eval_field(
            self.field, np.stack([np.cos(th), np.sin(th), z / self.height], -1)
        )
        r = self.radius * m
        local = np.stack([r * np.cos(th), r * np.sin(th), z], -1)
        return local @ self.rot.T + self.base

    def area(self):
        return 2 * np.pi * self.radius * self.height


def _rand_rot(rs):
    q = rs.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _box(rs, center, size, field_fn):
    """6 relief faces of an axis-aligned-then-rotated box."""
    R = _rand_rot(rs)
    faces = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[axis] = sign
            o = center + R @ (n * size / 2)
            t1 = np.zeros(3)
            t1[(axis + 1) % 3] = size[(axis + 1) % 3]
            t2 = np.zeros(3)
            t2[(axis + 2) % 3] = size[(axis + 2) % 3]
            faces.append(
                _Plane(
                    origin=o, u=R @ t1, v=R @ t2, normal=R @ n,
                    field=field_fn(2), relief=0.015 * float(size.min()),
                )
            )
    return faces


# ---------------------------------------------------------------------------
# the two disjoint scene families
# ---------------------------------------------------------------------------


def train_scene(rs: np.random.RandomState) -> List:
    """Object-scale family (matches the ``data/modelnet.py`` training
    statistics): 2-3 bump-modulated shells + one corrugated facet."""
    prims = []
    for _ in range(rs.randint(2, 4)):
        prims.append(
            _Blob(
                center=rs.uniform(-0.3, 0.3, 3),
                radii=rs.uniform(0.25, 0.5, 3),
                rot=np.eye(3),
                field=_sinusoid_field(rs, 6, 3, 4.0, 0.3, 1.0),
                bump=0.25 / np.sqrt(6.0),
            )
        )
    normal = rs.randn(3)
    normal /= np.linalg.norm(normal)
    basis = np.linalg.svd(np.eye(3) - np.outer(normal, normal))[0][:, :2]
    prims.append(
        _Plane(
            origin=rs.uniform(-0.2, 0.2, 3),
            u=basis[:, 0], v=basis[:, 1], normal=normal,
            field=_sinusoid_field(rs, 4, 2, 8.0, 0.3, 1.0),
            relief=0.05,
        )
    )
    return prims


def eval_scene(rs: np.random.RandomState, extent: float = 3.0) -> List:
    """Room-scale family, DISJOINT from :func:`train_scene`: floor + two
    walls + 4-7 furniture-like objects (boxes, cylinders, squashed blobs)
    with different displacement statistics (higher frequencies, lower
    amplitude — closer to sensor-scale surface texture)."""
    e = extent
    prims: List = []

    def field(dim):
        return _sinusoid_field(rs, 5, dim, rs.uniform(8.0, 14.0), 0.2, 0.6)

    # floor + two walls meeting in a corner (gives the scene long-range
    # planar structure like RGB-D fragments)
    prims.append(
        _Plane(
            origin=np.array([0.0, 0.0, 0.0]),
            u=np.array([e, 0, 0]), v=np.array([0, e, 0]),
            normal=np.array([0, 0, 1.0]),
            field=field(2), relief=0.02 * e / 3,
        )
    )
    prims.append(
        _Plane(
            origin=np.array([-e / 2, 0.0, e / 4]),
            u=np.array([0, e, 0]), v=np.array([0, 0, e / 2]),
            normal=np.array([1.0, 0, 0]),
            field=field(2), relief=0.02 * e / 3,
        )
    )
    prims.append(
        _Plane(
            origin=np.array([0.0, -e / 2, e / 4]),
            u=np.array([e, 0, 0]), v=np.array([0, 0, e / 2]),
            normal=np.array([0, 1.0, 0]),
            field=field(2), relief=0.02 * e / 3,
        )
    )

    for _ in range(rs.randint(4, 8)):
        kind = rs.randint(3)
        c = np.array(
            [rs.uniform(-e / 3, e / 3), rs.uniform(-e / 3, e / 3), 0.0]
        )
        if kind == 0:
            size = rs.uniform(0.15 * e / 3, 0.45 * e / 3, 3)
            c[2] = size[2] / 2
            prims.extend(_box(rs, c, size, field))
        elif kind == 1:
            h = rs.uniform(0.3, 0.9) * e / 3
            prims.append(
                _Cylinder(
                    base=c, rot=np.eye(3),
                    radius=rs.uniform(0.05, 0.18) * e / 3, height=h,
                    field=field(3), bump=rs.uniform(0.05, 0.15),
                )
            )
        else:
            radii = rs.uniform(0.1, 0.3, 3) * e / 3
            c[2] = radii[2]
            prims.append(
                _Blob(
                    center=c, radii=radii, rot=_rand_rot(rs),
                    field=field(3), bump=rs.uniform(0.04, 0.1),
                )
            )
    return prims


def sample_scene(prims: List, rs: np.random.RandomState,
                 num_points: int) -> np.ndarray:
    """Independent area-weighted surface sample of the scene."""
    areas = np.array([p.area() for p in prims])
    counts = np.maximum(
        (areas / areas.sum() * num_points).astype(int), 8
    )
    pts = np.concatenate([p.sample(rs, int(n)) for p, n in zip(prims, counts)])
    if len(pts) > num_points:
        pts = pts[rs.choice(len(pts), num_points, replace=False)]
    return pts.astype(np.float32)


# ---------------------------------------------------------------------------
# pair synthesis
# ---------------------------------------------------------------------------


def _crop_overlap(pts, d, c, side):
    proj = pts @ d
    if side == "low":
        return pts[proj <= np.quantile(proj, c)]
    return pts[proj >= np.quantile(proj, 1.0 - c)]


def hard_pair(
    rs: np.random.RandomState,
    *,
    family: str = "eval",
    num_points: int = 30000,
    overlap_ratio: float = 0.5,
    noise: float = 0.0,
    density_ratio: float = 1.0,
    outlier_frac: float = 0.0,
    extent: float = 3.0,
    max_trans: float | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One benchmark pair. Returns (src, tgt, T_gt), tgt ≈ T_gt @ src on
    the overlap region.

    overlap_ratio r: shared fraction of each crop (half-space crops keep
    c = 1/(2-r) each). noise: Gaussian sigma in meters, applied to both
    clouds. density_ratio: the target is subsampled ratio:1 after cropping
    (hetero-sensor proxy). outlier_frac: fraction of each cloud replaced by
    uniform clutter in the 1.2x scene bbox.
    """
    prims = (train_scene(rs) if family == "train"
             else eval_scene(rs, extent=extent))
    r = float(np.clip(overlap_ratio, 0.02, 1.0))
    c = 1.0 / (2.0 - r)

    d = rs.randn(3)
    d /= np.linalg.norm(d)
    src = _crop_overlap(sample_scene(prims, rs, num_points), d, c, "low")
    tgt = _crop_overlap(sample_scene(prims, rs, num_points), d, c, "high")

    if density_ratio > 1.0:
        keep = max(int(len(tgt) / density_ratio), 256)
        tgt = tgt[rs.choice(len(tgt), keep, replace=False)]

    def clutter(pts):
        n_out = int(len(pts) * outlier_frac)
        if n_out == 0:
            return pts
        lo, hi = pts.min(0), pts.max(0)
        pad = 0.1 * (hi - lo)
        out = rs.uniform(lo - pad, hi + pad, (n_out, 3)).astype(np.float32)
        return np.concatenate([pts, out])

    src, tgt = clutter(src), clutter(tgt)
    if noise > 0:
        src = src + rs.randn(*src.shape).astype(np.float32) * noise
        tgt = tgt + rs.randn(*tgt.shape).astype(np.float32) * noise

    axis = rs.randn(3)
    axis /= np.linalg.norm(axis)
    ang = rs.uniform(0, np.pi)
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
         [-axis[1], axis[0], 0]]
    )
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    mt = extent / 3.0 if max_trans is None else max_trans
    T[:3, 3] = rs.uniform(-mt, mt, 3)
    tgt = (tgt @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return src.astype(np.float32), tgt, T
