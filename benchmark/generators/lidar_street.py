"""KITTI-style street scans: pairs of 64-beam LiDAR scans taken 10-20 m
apart along synthetic streets, each through the test split's ingest.

A scene is a straight road along x with a grade: building blocks set back
from both curbs (a second row behind them, seen through the cross
streets' gaps), cars parked along the curbs, poles and trees on the
sidewalks. Everything is an axis-aligned box or, for a tree's canopy, a
sphere. Along the road stand ``positions`` sensor positions ``spacing``
m apart in the right lane. A scan is cast from one of them with KITTI's
Velodyne HDL-64E: ``beams`` beams spread evenly over ``elevation_deg``,
``azimuth_steps`` steps a turn, mounted ``height`` m above the road, range
noise of ``range_noise`` m along the ray, a share ``dropout`` of the
returns lost, returns kept from ``min_range`` to ``max_range`` m. A scan's
yaw follows the road within ``yaw_jitter_deg``; its roll and pitch stay
within ``tilt_deg`` (the scans are gravity-aligned). Moving cars drive in
the opposite lane, each in the scan of one position only: at each
position an eighth of the parked cars within ``moving_window`` m, so that
of the cars of a pair's two scans about a fifth are in one scan only.

A pair is two positions ``separation`` m apart (KITTI's ``pdist`` of 10 m
as the least), ``pairs_per_scene`` a scene; the source is the earlier
scan, each cloud in its own sensor frame, and ``T_gt`` maps the source
into the target's frame. Each pair then goes through the test split's
ingest, a frozen copy of the program's (``data/base.py``'s
``PairDataset.preprocess``): the pair's adaptive voxel from
:func:`sphericity_based_voxel_analysis`, :func:`voxel_downsample_np` of
both clouds at that voxel, and at most ``max_num_pts`` points a cloud.

The pairs are a fixed set made from ``scene_key``, pair k of every scene
before pair k + 1 of any. The run's seed shuffles them within blocks of
``block`` and moves each target by a motion of its own that keeps gravity
alignment: a rotation about z uniform in [0, 360) degrees and a
translation uniform in ``max_trans_xy`` m in x and y and ``max_trans_z`` m
in z (:func:`reorder_and_move`).

params: ``scenes``, ``positions``, ``spacing``, ``pairs_per_scene``,
``separation`` [lo, hi] (m), ``road_width`` [lo, hi], ``grade_deg``,
``setback`` [lo, hi], ``car`` [length, width, height], ``moving_window``,
``pole_every`` [lo, hi], ``beams``, ``elevation_deg`` [top, bottom],
``azimuth_steps``, ``height``, ``min_range``, ``max_range``,
``range_noise``, ``dropout``, ``yaw_jitter_deg``, ``tilt_deg``,
``max_num_pts``, ``scene_key``, ``max_trans_xy``, ``max_trans_z``,
``block``.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.seeding import random_state

__all__ = ["compute_pca_alignment", "sphericity_based_voxel_analysis",
           "voxel_downsample_np", "ingest", "make_scene", "scan",
           "fixed_pairs", "yaw_motion", "reorder_and_move", "pairs"]

_BITS = 21  # 3 * 21 = 63 bits: grids of up to 2M cells a side


# ---- the test split's ingest: frozen copies of the program's --------------

def compute_pca_alignment(pts: np.ndarray,
                          rng: np.random.RandomState | None = None):
    """PCA over a 1/10 subsample: (sphericity, is_z_aligned, components,
    mean)."""
    rng = rng or np.random
    num = len(pts)
    sample = pts[rng.choice(num, size=max(num // 10, min(num, 3)),
                            replace=False)]
    mean = sample.mean(axis=0)
    centered = sample - mean
    cov = centered.T @ centered / max(len(sample) - 1, 1)
    eigvals, eigvecs = np.linalg.eigh(cov)        # ascending
    lam1, lam3 = eigvals[2], eigvals[0]
    sphericity = lam3 / max(lam1, 1e-12)
    z_candidate = eigvecs[:, 0] / max(np.linalg.norm(eigvecs[:, 0]), 1e-12)
    is_aligned = abs(np.dot(z_candidate, [0.0, 0.0, 1.0])) > 0.98
    return sphericity, is_aligned, eigvecs, mean


def sphericity_based_voxel_analysis(src_pts: np.ndarray, tgt_pts: np.ndarray,
                                    rng: np.random.RandomState | None = None):
    """(voxel_size, sphericity, is_aligned_to_global_z) of a pair: voxel =
    sqrt(z range of the denser cloud in its PCA frame) / 100 * alpha, alpha
    1.0 for planar scenes (sphericity < 0.05) else 1.5."""
    s_sph, s_aligned, s_vecs, s_mean = compute_pca_alignment(src_pts, rng)
    t_sph, t_aligned, t_vecs, t_mean = compute_pca_alignment(tgt_pts, rng)

    if len(src_pts) > len(tgt_pts):
        ref, sph, vecs, mean = src_pts, s_sph, s_vecs, s_mean
    else:
        ref, sph, vecs, mean = tgt_pts, t_sph, t_vecs, t_mean

    projected = (ref - mean) @ vecs[:, 0]
    z_range = projected.max() - projected.min()
    alpha = 1.0 if sph < 0.05 else 1.5
    voxel_size = max(float(np.sqrt(z_range) / 100.0 * alpha), 0.001)

    z_src = s_vecs[:, 0] / max(np.linalg.norm(s_vecs[:, 0]), 1e-12)
    z_tgt = t_vecs[:, 0] / max(np.linalg.norm(t_vecs[:, 0]), 1e-12)
    same_direction = abs(np.dot(z_src, z_tgt)) > 0.96
    is_aligned = bool(s_aligned and t_aligned and same_direction)

    return round(voxel_size, 4), float(sph), is_aligned


def voxel_downsample_np(xyz: np.ndarray, voxel_size: float) -> np.ndarray:
    """Barycenter voxel downsample, ragged [N, 3] in, ragged [M, 3] out."""
    if len(xyz) == 0:
        return xyz
    cell = np.floor((xyz - xyz.min(axis=0)) / voxel_size).astype(np.int64)
    vid = (cell[:, 0] << (2 * _BITS)) | (cell[:, 1] << _BITS) | cell[:, 2]
    uniq, inv, cnt = np.unique(vid, return_inverse=True, return_counts=True)
    sums = np.zeros((len(uniq), 3), xyz.dtype)
    np.add.at(sums, inv, xyz)
    return sums / cnt[:, None]


def ingest(src: np.ndarray, tgt: np.ndarray, cap: int,
           rng: np.random.RandomState) -> tuple:
    """The test split's preprocessing of a raw pair (``data/base.py``):
    adaptive voxel, downsample, at most ``cap`` points a cloud."""
    voxel, _sph, _aligned = sphericity_based_voxel_analysis(src, tgt, rng)
    src = voxel_downsample_np(src, voxel)
    tgt = voxel_downsample_np(tgt, voxel)
    if len(src) > cap:
        src = src[rng.choice(len(src), cap, replace=False)]
    if len(tgt) > cap:
        tgt = tgt[rng.choice(len(tgt), cap, replace=False)]
    return src, tgt


# ---- scenes ---------------------------------------------------------------

def _ground_z(x, grade: float):
    return np.tan(grade) * np.asarray(x, np.float64)


def _box(lo, hi, boxes: list, only: list, at: int = -1) -> None:
    boxes.append((lo, hi))
    only.append(at)


def make_scene(rs: np.random.RandomState, params: dict) -> dict:
    """One street: {"lo", "hi" [n, 3] boxes, "only" [n] (-1, or the one
    position whose scan holds the box), "centre" [m, 3] and "radius" [m]
    spheres, "grade" (rad) and "sensors" [positions, 3]}."""
    grade = math.radians(rs.uniform(-1.0, 1.0) * params["grade_deg"])
    width = rs.uniform(*params["road_width"])
    n_pos, step = int(params["positions"]), float(params["spacing"])
    xs = np.arange(n_pos) * step * math.cos(grade)
    reach = float(params["max_range"]) + 10.0
    x_lo, x_hi = xs[0] - reach, xs[-1] + reach
    car_l, car_w, car_h = params["car"]
    boxes: list = []
    only: list = []
    centres, radii, parked = [], [], []

    # building blocks on both sides, cross streets between blocks, and a
    # second row behind each side
    for side in (1.0, -1.0):
        setback = rs.uniform(*params["setback"])
        for row, extra in ((0, 0.0), (1, rs.uniform(18.0, 30.0))):
            x = x_lo - rs.uniform(0.0, 30.0)
            while x < x_hi:
                end = x + rs.uniform(15.0, 60.0)
                while x < end:
                    length = rs.uniform(8.0, 25.0)
                    face = width / 2 + setback + extra + rs.uniform(-0.8, 0.8)
                    depth = rs.uniform(10.0, 20.0)
                    h = rs.uniform(6.0, 20.0)
                    y0, y1 = sorted((side * face, side * (face + depth)))
                    z0 = float(_ground_z(x, grade)) - 1.0
                    if row == 0 or rs.uniform() < 0.8:
                        _box((x, y0, z0 - abs(np.tan(grade)) * length),
                             (x + length, y1,
                              float(_ground_z(x + length / 2, grade)) + h),
                             boxes, only)
                    x += length
                x += rs.uniform(10.0, 16.0)               # a cross street

        # parked cars along the curb, poles and trees on the sidewalk
        y_car = side * (width / 2 - car_w / 2 - 0.2)
        x = x_lo
        while x < x_hi:
            x += rs.uniform(0.8, 3.0)
            if rs.uniform() < 0.3:
                x += rs.uniform(5.0, 20.0)                # an empty stretch
                continue
            z0 = float(_ground_z(x + car_l / 2, grade))
            _box((x, y_car - car_w / 2, z0 - 0.3),
                 (x + car_l, y_car + car_w / 2, z0 + car_h), boxes, only)
            parked.append(x + car_l / 2)
            x += car_l
        x = x_lo + rs.uniform(0.0, 15.0)
        while x < x_hi:
            y = side * (width / 2 + rs.uniform(0.5, 1.5))
            z0 = float(_ground_z(x, grade))
            if rs.uniform() < 0.5:                        # a tree
                trunk = rs.uniform(2.5, 4.0)
                r = rs.uniform(1.5, 2.5)
                _box((x - 0.15, y - 0.15, z0 - 0.3),
                     (x + 0.15, y + 0.15, z0 + trunk), boxes, only)
                centres.append((x, y, z0 + trunk + 0.6 * r))
                radii.append(r)
            else:                                         # a pole
                _box((x - 0.1, y - 0.1, z0 - 0.3),
                     (x + 0.1, y + 0.1, z0 + rs.uniform(6.0, 9.0)),
                     boxes, only)
            x += rs.uniform(*params["pole_every"])

    # the travel lanes lie between the parked cars: the sensor in the right
    # one, moving cars in the other, each in one position's scan
    lane = (width / 2 - car_w - 0.2) / 2
    window = float(params["moving_window"])
    parked = np.array(parked)
    for k, xk in enumerate(xs):
        near = int(np.sum(np.abs(parked - xk) < window))
        for _ in range(int(round(near / 8.0))):
            x = xk + rs.uniform(-window, window)
            z0 = float(_ground_z(x, grade))
            _box((x - car_l / 2, lane - car_w / 2, z0 - 0.3),
                 (x + car_l / 2, lane + car_w / 2, z0 + car_h), boxes,
                 only, at=k)

    sensors = np.stack([xs, np.full(n_pos, -lane),
                        _ground_z(xs, grade) + float(params["height"])], 1)
    return dict(lo=np.array([b[0] for b in boxes], np.float64),
                hi=np.array([b[1] for b in boxes], np.float64),
                only=np.array(only), grade=grade, sensors=sensors,
                centre=np.array(centres, np.float64).reshape(-1, 3),
                radius=np.array(radii, np.float64))


# ---- the scanner ----------------------------------------------------------

def _rotation(yaw: float, pitch: float, roll: float) -> np.ndarray:
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return rz @ ry @ rx


def _columns(centre_az: float, half: float, yaw: float, steps: int):
    """The azimuth columns of a scan at ``yaw`` whose rays can reach an
    object seen from the sensor under [centre_az - half, centre_az +
    half] (with a degree of room for the tilt)."""
    step = 2.0 * math.pi / steps
    room = half + math.radians(1.0)
    j0 = math.floor((centre_az - yaw - room) / step)
    j1 = math.ceil((centre_az - yaw + room) / step)
    return np.arange(j0, j1 + 1) % steps


def _beams(tan_lo, tan_hi, z: float, r_near: float, r_far: float,
           lo_z: float, hi_z: float) -> tuple:
    """[b0, b1): the beams (elevations falling with the index, their
    tangents with the tilt's room either side) whose rays pass a height in
    [lo_z, hi_z] somewhere between horizontal distances r_near and r_far
    from a sensor at height z."""
    top = z + np.maximum(r_near * tan_hi, r_far * tan_hi)
    bottom = z + np.minimum(r_near * tan_lo, r_far * tan_lo)
    keep = np.flatnonzero((top >= lo_z) & (bottom <= hi_z))
    return (int(keep[0]), int(keep[-1]) + 1) if len(keep) else (0, 0)


def scan(scene: dict, k: int, rs: np.random.RandomState,
         params: dict) -> tuple:
    """The scan from position ``k``: (points [N, 3] f32 in the sensor's
    frame, sensor-to-world pose [4, 4] f64)."""
    steps = int(params["azimuth_steps"])
    top, bottom = params["elevation_deg"]
    elev = np.radians(np.linspace(top, bottom, int(params["beams"])))
    az = 2.0 * math.pi * np.arange(steps) / steps
    d_sensor = np.stack([np.cos(elev)[:, None] * np.cos(az)[None],
                         np.cos(elev)[:, None] * np.sin(az)[None],
                         np.broadcast_to(np.sin(elev)[:, None],
                                         (len(elev), steps))], -1)
    yaw = math.radians(rs.uniform(-1.0, 1.0) * params["yaw_jitter_deg"])
    tilt = math.radians(params["tilt_deg"])
    rot = _rotation(yaw, rs.uniform(-tilt, tilt), rs.uniform(-tilt, tilt))
    o = scene["sensors"][k]
    d = d_sensor @ rot.T                                  # world directions
    room = tilt * 1.5 + math.radians(0.2)
    tan_lo, tan_hi = np.tan(elev - room), np.tan(elev + room)

    # the road surface z = tan(grade) x
    g = scene["grade"]
    n = np.array([-math.sin(g), 0.0, math.cos(g)])
    nd = d @ n
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(nd < 0.0, -(o @ n) / nd, np.inf)
        inv = [np.ascontiguousarray(1.0 / d[..., a]) for a in range(3)]
    for i in np.flatnonzero((scene["only"] < 0) | (scene["only"] == k)):
        lo, hi = scene["lo"][i] - o, scene["hi"][i] - o
        corners = np.array([[lo[0], lo[1]], [lo[0], hi[1]], [hi[0], lo[1]],
                            [hi[0], hi[1]]])
        c = math.atan2(0.5 * (lo[1] + hi[1]), 0.5 * (lo[0] + hi[0]))
        off = np.angle(np.exp(1j * (np.arctan2(corners[:, 1], corners[:, 0])
                                    - c)))
        near_xy = np.hypot(max(lo[0], 0.0, -hi[0]), max(lo[1], 0.0, -hi[1]))
        b0, b1 = _beams(tan_lo, tan_hi, 0.0, near_xy,
                        float(np.hypot(*corners.T).max()), lo[2], hi[2])
        if b0 == b1:
            continue
        cols = _columns(c + 0.5 * (off.max() + off.min()),
                        0.5 * (off.max() - off.min()), yaw, steps)
        near = far = None
        with np.errstate(invalid="ignore"):
            for a in range(3):
                ia = inv[a][b0:b1, cols]
                t1, t2 = lo[a] * ia, hi[a] * ia
                lo_t, hi_t = np.minimum(t1, t2), np.maximum(t1, t2)
                near = lo_t if near is None else np.maximum(near, lo_t)
                far = hi_t if far is None else np.minimum(far, hi_t)
        hit = (far >= near) & (near > 0.0)
        cur = t[b0:b1, cols]
        t[b0:b1, cols] = np.where(hit & (near < cur), near, cur)
    for c3, r in zip(scene["centre"], scene["radius"]):
        rel = o - c3
        dist = float(np.linalg.norm(rel[:2]))
        half = math.asin(min(r / max(dist, 1e-6), 1.0))
        cols = _columns(math.atan2(-rel[1], -rel[0]), half, yaw, steps)
        dd = d[:, cols]
        b = dd @ rel
        disc = b * b - (rel @ rel - r * r)
        with np.errstate(invalid="ignore"):
            tt = -b - np.sqrt(disc)
        hit = (disc >= 0.0) & (tt > 0.0)
        t[:, cols] = np.where(hit, np.minimum(t[:, cols], tt), t[:, cols])

    t = t + rs.normal(0.0, params["range_noise"], t.shape)
    keep = ((t >= params["min_range"]) & (t <= params["max_range"])
            & (rs.uniform(size=t.shape) >= params["dropout"]))
    pts = d_sensor[keep] * t[keep][:, None]
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = rot, o
    return pts.astype(np.float32), pose


# ---- pairs ----------------------------------------------------------------

def _scene_pairs(rs: np.random.RandomState, params: dict) -> list:
    """``pairs_per_scene`` (earlier, later) positions ``separation`` apart,
    drawn without repeats."""
    n, step = int(params["positions"]), float(params["spacing"])
    lo, hi = params["separation"]
    cands = [(a, b) for a in range(n) for b in range(a + 1, n)
             if lo - 1e-9 <= (b - a) * step <= hi + 1e-9]
    pick = rs.choice(len(cands), int(params["pairs_per_scene"]),
                     replace=False)
    return [cands[i] for i in sorted(pick)]


def fixed_pairs(params: dict) -> list:
    """The fixed set [(src, tgt, T_gt)] before the seed's motion: pair k of
    every scene before pair k + 1 of any, numpy f32."""
    key = int(params["scene_key"])
    per_scene = []
    for s in range(int(params["scenes"])):
        scene = make_scene(random_state(key, "lidar_street.scene", s), params)
        chosen = _scene_pairs(random_state(key, "lidar_street.pairs", s),
                              params)
        scans = {k: scan(scene, k, random_state(key, "lidar_street.scan",
                                                s * 1000 + k), params)
                 for k in sorted({k for ab in chosen for k in ab})}
        out = []
        for j, (a, b) in enumerate(chosen):
            (src, pose_a), (tgt, pose_b) = scans[a], scans[b]
            src, tgt = ingest(src, tgt, int(params["max_num_pts"]),
                              random_state(key, "lidar_street.ingest",
                                           s * 1000 + j))
            t_gt = np.linalg.inv(pose_b) @ pose_a
            out.append((src.astype(np.float32), tgt.astype(np.float32),
                        t_gt.astype(np.float32)))
        per_scene.append(out)
    return [scene[j] for j in range(int(params["pairs_per_scene"]))
            for scene in per_scene]


def yaw_motion(rs: np.random.RandomState, max_xy: float,
               max_z: float) -> np.ndarray:
    """A rotation about z uniform in [0, 2 pi) and a translation uniform in
    [-max_xy, max_xy]^2 x [-max_z, max_z], as a 4x4 f64."""
    a = rs.uniform(0.0, 2.0 * math.pi)
    m = np.eye(4)
    m[:2, :2] = [[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]
    m[:3, 3] = rs.uniform(-1.0, 1.0, 3) * [max_xy, max_xy, max_z]
    return m


def reorder_and_move(seed: int, fixed: list, max_xy: float, max_z: float,
                     block: int) -> list:
    """``fixed`` [(src, tgt, T_gt)] shuffled by the seed within each block of
    ``block``, each target moved by the seed's yaw motion M of that pair:
    (src, M tgt, M T_gt)."""
    rs = random_state(seed, "lidar_street.motion")
    order = np.concatenate([start + rs.permutation(min(block,
                                                       len(fixed) - start))
                            for start in range(0, len(fixed), block)])
    out = []
    for i in order:
        src, tgt, t_gt = fixed[i]
        m = yaw_motion(rs, max_xy, max_z)
        moved = tgt.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
        out.append((src, moved.astype(np.float32),
                    (m @ t_gt.astype(np.float64)).astype(np.float32)))
    return out


def pairs(seed: int, params: dict) -> list:
    """[(src [N, 3], tgt [M, 3], T_gt [4, 4])], numpy f32."""
    return reorder_and_move(seed, fixed_pairs(params),
                            float(params["max_trans_xy"]),
                            float(params["max_trans_z"]),
                            int(params["block"]))
