"""Port parity for the data layer: every loader of the port gives the JAX
package's samples, bit for bit, on small layouts written to temporary
directories (the test benchmarks of 3DMatch and 3DLoMatch, 3DMatch's
train/val manifest, ETH, ScanNet++ iPhone and FARO, ModelNet40, KITTI with
its ICP refinement, WOD, MIT, Oxford, KAIST, TIERS and both hetero
datasets): the same pairs in the same order, and per sample the points,
pose, ids, voxel size, sphericity, alignment flag, dataset name and any
extra key. Each package reads its own copy of a layout, since KITTI and the
hetero datasets write caches into it. The file readers and trajectory
files round-trip as the JAX package's do, and the harness's prefetch gives
the samples of sequential ``ds[i]`` (the loaders share one
``RandomState``, so the order of the draws decides the samples).
"""

import os
import warnings

import numpy as np
import pytest

from bufferx_tpu.config import make_cfg as jax_make_cfg
from bufferx_tpu.data import base as jbase
from bufferx_tpu.data import io as jio
from bufferx_tpu.data.datasets import get_dataset as jax_get_dataset
from bufferx_tpu.geometry.sphericity import (
    sphericity_based_voxel_analysis as jax_sphericity,
)
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.data import base as tbase
from bufferx_tpu_torch.data import io as tio
from bufferx_tpu_torch.data import splits
from bufferx_tpu_torch.data.datasets import get_dataset
from bufferx_tpu_torch.data.prefetch import prefetch_samples
from bufferx_tpu_torch.geometry.sphericity import (
    sphericity_based_voxel_analysis,
)
import test_data


def _pcd(path, pts):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pts = np.asarray(pts, np.float32)
    with open(path, "wb") as f:
        f.write((f"VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                 f"COUNT 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\n"
                 f"POINTS {len(pts)}\nDATA binary\n").encode())
        f.write(pts.tobytes())


def _bin(path, pts):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rec = np.zeros((len(pts), 4), np.float32)
    rec[:, :3] = pts
    rec.tofile(path)


def _poses_file(path, positions):
    """KITTI-format rows (translation only) for the given positions."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rows = []
    for p in positions:
        m = np.eye(4)[:3]
        m[:, 3] = p
        rows.append(" ".join(f"{v:.6f}" for v in m.reshape(-1)))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def _scene(rs, n=2500, scale=3.0):
    """An indoor-like cloud: a floor, two walls and a box."""
    parts = [
        np.c_[rs.uniform(0, scale, (n // 2, 2)), rs.normal(0, 0.01, n // 2)],
        np.c_[rs.uniform(0, scale, n // 4), rs.normal(0, 0.01, n // 4),
              rs.uniform(0, 1.5, n // 4)],
        np.c_[rs.normal(0, 0.01, n // 8), rs.uniform(0, scale, n // 8),
              rs.uniform(0, 1.5, n // 8)],
    ]
    box = rs.uniform(0.8, 1.4, (n - sum(len(p) for p in parts), 3))
    return np.concatenate(parts + [box]).astype(np.float32)


def _odometry_scans(rs, frames, step, world_scale=20.0):
    """Translation-only poses along x, ``step`` m apart, and per frame the
    shared world cloud in that frame's coordinates (so the pairs overlap)."""
    world = rs.uniform(-world_scale, world_scale, (3000, 3)).astype(np.float32)
    positions = np.c_[np.arange(frames) * step, np.zeros(frames),
                      np.zeros(frames)]
    scans = [(world - p).astype(np.float32) for p in positions]
    return positions, scans


def _fragments(root, rs, scenes, frags=3):
    """3DMatch-style test layout: fragments, gt.log of consecutive pairs,
    3DLoMatch gt.log of the (0, frags-1) pair."""
    base = os.path.join(root, "test")
    for scene in scenes:
        frag_dir = os.path.join(base, "3DMatch", "fragments", scene)
        world = _scene(rs)
        poses = []
        for i in range(frags):
            T = np.eye(4)
            T[:3, 3] = rs.uniform(-0.2, 0.2, 3)
            poses.append(T)
            tio.save_ply(os.path.join(frag_dir, f"cloud_bin_{i}.ply"),
                         world[rs.rand(len(world)) < 0.8] + T[:3, 3])
        pairs = [[i, i + 1, frags] for i in range(frags - 1)]
        tbase.write_trajectory_log(
            os.path.join(base, "3DMatch", "gt_result", scene, "gt.log"),
            pairs, [poses[i] for i, _, _ in pairs])
        tbase.write_trajectory_log(
            os.path.join(base, "3DLoMatch", scene, "gt.log"),
            [[0, frags - 1, frags]], [poses[0]])


def _layout(name, root, seed):
    """Writes a small layout of dataset ``name`` under ``root``; returns the
    preset name and the split to load."""
    rs = np.random.RandomState(seed)
    split = "test"
    preset = name
    pdist = make_cfg(name.split(":")[0], root).data.pdist
    if name in ("3DMatch", "3DLoMatch"):
        _fragments(root, rs, splits.THREEDMATCH_TEST_SCENES[:2])
    elif name.startswith("3DMatch:"):
        test_data.TestLoaders()._make_3dmatch_train(root, rs)
        preset, split = "3DMatch", name.split(":")[1]
    elif name == "ETH":
        test_data.TestLoaders()._make_eth(root, rs)
    elif name in ("Scannetpp_iphone", "Scannetpp_faro"):
        pinned = (splits.SCANNETPP_IPHONE_TEST if name == "Scannetpp_iphone"
                  else splits.SCANNETPP_FARO_TEST)
        scene = os.path.join(root, pinned[0])
        sub = ((os.path.join(scene, "iphone"),
                os.path.join(scene, "iphone", "tsdf"))
               if name == "Scannetpp_iphone" else (scene, scene))
        world = _scene(rs)
        for i in range(2):
            tio.save_ply(os.path.join(sub[1], f"cloud_bin_{i}.ply"),
                         world[rs.rand(len(world)) < 0.7])
        tbase.write_trajectory_log(os.path.join(sub[0], "gt.log"),
                                   [[0, 1, 2]], [np.eye(4)])
    elif name == "ModelNet40":
        for obj in ("airplane_0001", "chair_0002"):
            d = os.path.join(root, obj)
            os.makedirs(d)
            shape = rs.randn(900, 3).astype(np.float32) * [1.0, 0.5, 0.2]
            for i in range(2):
                np.save(os.path.join(d, f"cloud_bin_{i}.npy"), shape)
            tbase.write_trajectory_log(os.path.join(d, "gt.log"),
                                       [[0, 1, 2]], [np.eye(4)])
    elif name == "KITTI":
        positions, scans = _odometry_scans(rs, 8, pdist / 3.0)
        seq = f"{int(splits.KITTI['test'][0]):02d}"
        _poses_file(os.path.join(root, "dataset", "poses", f"{seq}.txt"),
                    positions)
        for t, scan in enumerate(scans):
            _bin(os.path.join(root, "dataset", "sequences", seq, "velodyne",
                              f"{t:06d}.bin"), scan)
    elif name == "WOD":
        positions, scans = _odometry_scans(rs, 8, pdist / 3.0)
        d = os.path.join(root, "test", "sequences", splits.WOD_TEST[0])
        _poses_file(os.path.join(d, "poses.txt"), positions)
        for t, scan in enumerate(scans):
            _bin(os.path.join(d, "scans", f"{t:06d}.bin"), scan)
    elif name in ("MIT", "Oxford", "KAIST"):
        seq = {"MIT": splits.MIT_TEST, "Oxford": splits.OXFORD_TEST,
               "KAIST": splits.KAIST_TEST}[name][0]
        positions, scans = _odometry_scans(rs, 7, pdist / 2.5)
        _poses_file(os.path.join(root, seq, "poses_kitti.txt"), positions)
        for t, scan in enumerate(scans):
            path = os.path.join(root, seq, "scans", f"{t:06d}")
            if name == "KAIST":
                _bin(path + ".bin", scan)
            else:
                _pcd(path + ".pcd", scan)
    elif name in ("TIERS", "TIERS_hetero"):
        for sensor in ("os0_128", "os1_64"):
            positions, scans = _odometry_scans(
                np.random.RandomState(seed), 7, pdist / 2.5)
            base = os.path.join(root, splits.TIERS_TEST[0], sensor)
            _poses_file(os.path.join(base, "poses_kitti.txt"), positions)
            for t, scan in enumerate(scans):
                keep = rs.rand(len(scan)) < 0.9
                _pcd(os.path.join(base, "scans", f"{t:06d}.pcd"), scan[keep])
    elif name == "KAIST_hetero":
        for sensor in ("Aeva", "Avia"):
            positions, scans = _odometry_scans(
                np.random.RandomState(seed), 7, pdist / 2.5)
            base = os.path.join(root, sensor)
            _poses_file(os.path.join(base, "poses_kitti.txt"), positions)
            for t, scan in enumerate(scans):
                keep = rs.rand(len(scan)) < 0.9
                _bin(os.path.join(base, "scans", f"{t:06d}.bin"), scan[keep])
    else:
        raise ValueError(name)
    return preset, split


LOADERS = ["3DMatch", "3DLoMatch", "3DMatch:train", "3DMatch:val", "ETH",
           "Scannetpp_iphone", "Scannetpp_faro", "ModelNet40", "KITTI", "WOD",
           "MIT", "Oxford", "KAIST", "TIERS", "TIERS_hetero", "KAIST_hetero"]


def _assert_same_sample(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert type(a[k]) is type(b[k]) and a[k] == b[k], k


def _both(name, tmp_path):
    roots = [str(tmp_path / side) for side in ("jax", "port")]
    for r in roots:
        os.makedirs(r, exist_ok=True)
        preset, split = _layout(name, r, seed=len(name))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # partial pinned scene lists
        jds = jax_get_dataset(jax_make_cfg(preset, roots[0]), split)
        tds = get_dataset(make_cfg(preset, roots[1]), split)
    return jds, tds, roots


@pytest.mark.parametrize("name", LOADERS)
def test_loader_samples_equal(name, tmp_path):
    jds, tds, roots = _both(name, tmp_path)
    assert len(tds) == len(jds) >= 1
    assert type(tds).__name__ == type(jds).__name__
    for i in range(len(tds)):
        a, b = jds[i], tds[i]
        for k in ("src_id", "tgt_id"):   # ids name each package's own root
            if isinstance(a[k], str):
                a[k] = a[k].replace(roots[0], "ROOT")
                b[k] = b[k].replace(roots[1], "ROOT")
        _assert_same_sample(a, b)
        assert len(b["src_points"]) > 100 and len(b["tgt_points"]) > 100


def test_prefetch_gives_the_sequential_samples(tmp_path):
    """Through the harness's prefetch, from a fresh dataset each time: the
    dataset itself (ordered, though it is indexable: its samples share one
    ``RandomState``) and ``iter(ds)`` as the CLI passes it, both equal to
    ``ds[i]`` in order."""
    root = str(tmp_path)
    _layout("3DMatch", root, seed=3)
    cfg = make_cfg("3DMatch", root)
    want = [s for s in get_dataset(cfg)]
    assert len(want) == 4          # 2 scenes x 2 pairs
    for source in (lambda: get_dataset(cfg), lambda: iter(get_dataset(cfg))):
        got = list(prefetch_samples(source(), num_workers=2, depth=2))
        assert len(got) == len(want)
        for a, b in zip(want, got):
            _assert_same_sample(a, b)


def test_readers_and_trajectory_files(tmp_path):
    """PLY (binary and ascii), PCD, KITTI ``.bin``, ``.npy`` and the
    trajectory ``.log``/``.info`` files read the same in both packages;
    ``save_ply`` writes what both read."""
    rs = np.random.RandomState(0)
    pts = rs.randn(50, 3).astype(np.float32)
    paths = {"a.ply": lambda p: tio.save_ply(p, pts),
             "b.pcd": lambda p: _pcd(p, pts),
             "c.bin": lambda p: _bin(p, pts),
             "d.npy": lambda p: np.save(p, pts)}
    for fname, write in paths.items():
        p = str(tmp_path / fname)
        write(p)
        assert np.array_equal(tio.read_points(p), jio.read_points(p))
        assert np.array_equal(tio.read_points(p), pts)
    ascii_ply = tmp_path / "e.ply"
    with open(ascii_ply, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                "property float y\nproperty float z\nend_header\n")
        for row in pts[:3]:
            f.write(" ".join(str(v) for v in row) + "\n")
    assert np.array_equal(tio.read_ply(str(ascii_ply)),
                          jio.read_ply(str(ascii_ply)))
    poses = np.stack([np.eye(4), np.diag([1.0, -1.0, -1.0, 1.0])])
    log = tbase.write_trajectory_log(str(tmp_path / "gt.log"),
                                     [[0, 1, 4], [1, 3, 4]], poses)
    for got, want in zip(tbase.read_trajectory_log(log),
                         jbase.read_trajectory_log(log)):
        assert np.array_equal(got, want)
    with open(tmp_path / "gt.info", "w") as f:
        for i in range(2):
            f.write(f"{i} {i + 1} 4\n")
            for r in range(6):
                f.write(" ".join(str(float(r == c) * (i + 1))
                                 for c in range(6)) + "\n")
    for got, want in zip(tbase.read_trajectory_info(str(tmp_path / "gt.info")),
                         jbase.read_trajectory_info(str(tmp_path / "gt.info"))):
        assert np.array_equal(got, want)
    positions = np.c_[np.arange(30) * 0.7, np.zeros(30), np.zeros(30)]
    assert tbase.walk_odometry_pairs(positions, 2.0, exclude=[(3, 6)]) == \
        jbase.walk_odometry_pairs(positions, 2.0, exclude=[(3, 6)])
    src = _scene(rs)
    T = np.eye(4)
    T[:3, 3] = [0.05, 0.0, 0.0]
    assert tbase.compute_overlap_ratio(src, src + 0.05, T, 0.1) == \
        jbase.compute_overlap_ratio(src, src + 0.05, T, 0.1)
    a = sphericity_based_voxel_analysis(src, src[::2],
                                        np.random.RandomState(1))
    b = jax_sphericity(src, src[::2], np.random.RandomState(1))
    assert a == b
