"""Port parity of the ScanNet++ iPhone preprocessing
(``bufferx_tpu_torch/tools/scannetpp.py``) against
``bufferx_tpu/tools/scannetpp.py``.

The raw scene of ``tests/test_scannetpp_offline.py`` (a bumpy wall seen
from 6 poses, one raw-deflate depth stream) goes through both packages'
``prepare_scene`` at that test's small grid. The port fuses on the CPU
here (``device="cpu"``); its TSDF rounds as XLA's CPU code does
(``tests/test_torch_tsdf.py``), so every output file is byte-equal but
``gt.log``: the depth ``.npy`` files, poses, intrinsics, fragment PLYs,
``valid_pcd_files.txt`` and ``overlap_ratio.txt``. ``gt.log`` lists the
same pairs, and each of the port's poses is the inverse of the JAX
package's: the port writes the pose in the convention its loader reads
(``relt_pose = inv(log pose)``), the JAX package the relative pose itself,
which its loader turns into the inverse. The output then loads through the
port's ``ScannetppIphoneDataset``; on a scene whose camera turns between
fragments, a loaded pair's pose lays the source fragment onto the target.
"""

import json
import os
import shutil
import zlib
from os.path import join

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins the CPU)
from bufferx_tpu.tools import scannetpp as js
from bufferx_tpu_torch.tools import scannetpp as ts
from test_scannetpp_offline import render_depth

FRAGMENT_KW = dict(frames_per_fragment=2, voxel_size=0.05,
                   grid_dims=(64, 64, 64), grid_origin=(-1.6, -1.6, 0.4))


def write_raw_scene(root: str, per_frame_blocks: bool = False,
                    yaw_deg: float = 0.0) -> str:
    """``tests/test_scannetpp_offline.py``'s raw scene under ``root``: one
    raw-deflate stream, or 4-byte-length-prefixed deflate blocks a frame.
    ``yaw_deg``: the camera turns by that much about its y axis from one
    fragment to the next (0: it only slides along the wall)."""
    scene = ts.SceneLayout(root)
    os.makedirs(scene.iphone_dir)
    k_video = np.array(
        [[200.0 * ts.INTRINSIC_SCALE, 0, 128.0 * ts.INTRINSIC_SCALE],
         [0, 200.0 * ts.INTRINSIC_SCALE, 96.0 * ts.INTRINSIC_SCALE],
         [0, 0, 1.0]])
    k_depth = k_video / ts.INTRINSIC_SCALE
    depths, meta = [], {}
    for t in range(6):
        frag = t // 2
        cam2world = np.eye(4)
        a = np.deg2rad(yaw_deg * frag)
        cam2world[:3, :3] = [[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                             [-np.sin(a), 0.0, np.cos(a)]]
        cam2world[:3, 3] = [0.05 * frag, 0.03 * frag, 0.01 * t]
        depths.append(render_depth(k_depth, cam2world))
        meta[f"frame_{t:06d}"] = dict(aligned_pose=cam2world.tolist(),
                                      intrinsic=k_video.tolist())
    with open(scene.depth_bin_path, "wb") as f:
        if per_frame_blocks:
            for d in depths:
                comp = zlib.compressobj(wbits=-zlib.MAX_WBITS)
                blob = comp.compress(d.astype(np.float32).tobytes()) \
                    + comp.flush()
                f.write(len(blob).to_bytes(4, "little") + blob)
        else:
            comp = zlib.compressobj(wbits=-zlib.MAX_WBITS)
            f.write(comp.compress(np.stack(depths).astype(np.float32)
                                  .tobytes()) + comp.flush())
    with open(scene.pose_json_path, "w") as f:
        json.dump(meta, f)
    return root


def _files(root: str) -> dict:
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            p = join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    base = tmp_path_factory.mktemp("scannetpp_parity")
    stats = {}
    for name, mod, kw in (("jax", js, {}), ("port", ts, dict(device="cpu"))):
        root = write_raw_scene(str(base / name / "scene0"))
        stats[name] = mod.prepare_scene(root, pair_kw=dict(keep_prob=1.0),
                                        **kw, **FRAGMENT_KW)
    return base, stats


def test_stats_equal(prepared):
    _, stats = prepared
    seconds = stats["port"].pop("seconds")
    assert set(seconds) == {"extract", "fragments", "pairs"}
    assert stats["port"] == stats["jax"]
    assert stats["jax"]["fragments"] >= 2 and stats["jax"]["pairs"] >= 1


def test_every_output_file_byte_equal(prepared):
    """Every file byte-equal but ``gt.log``, whose pair lines are equal and
    whose poses are the inverses of the JAX package's within 1e-6."""
    from bufferx_tpu_torch.data.base import read_trajectory_log

    base, _ = prepared
    fj, fp = _files(str(base / "jax")), _files(str(base / "port"))
    assert sorted(fp) == sorted(fj)
    kinds = {k.split(os.sep)[2] if k.count(os.sep) > 2 else k
             for k in fj}
    for want in ("depth", "pose", "intrinsic", "tsdf"):
        assert want in kinds
    log = join("scene0", "iphone", "gt.log")
    for k in ("gt.log", "valid_pcd_files.txt", "overlap_ratio.txt"):
        assert join("scene0", "iphone", k) in fj
    for k in fj:
        if k != log:
            assert fp[k] == fj[k], k
    pairs_j, poses_j = read_trajectory_log(str(base / "jax" / log))
    pairs_p, poses_p = read_trajectory_log(str(base / "port" / log))
    assert len(pairs_p) == len(poses_p) >= 1
    np.testing.assert_array_equal(pairs_p, pairs_j)
    for pj, pp in zip(poses_j, poses_p):
        np.testing.assert_allclose(pp, np.linalg.inv(pj), rtol=0, atol=1e-6)
    assert fp[log] != fj[log]


def test_loads_through_the_ports_dataset(prepared, tmp_path):
    from bufferx_tpu_torch.config import make_cfg
    from bufferx_tpu_torch.data.datasets import ScannetppIphoneDataset

    base, stats = prepared
    root = tmp_path / "ds_root"
    shutil.copytree(base / "port", root)
    with pytest.warns(UserWarning, match="pinned benchmark"):
        ds = ScannetppIphoneDataset(make_cfg("Scannetpp_iphone", str(root)))
    assert len(ds) == stats["port"]["pairs"]
    src, tgt, relt, *_ = ds.load_pair(ds.pairs[0])
    assert len(src) > 100 and len(tgt) > 100
    from scipy.spatial import cKDTree

    warped = src @ relt[:3, :3].T + relt[:3, 3]
    d, _ = cKDTree(tgt).query(warped)
    assert np.median(d) < 0.08


def test_loaded_pose_aligns_a_turning_camera(tmp_path):
    """The camera turns 10 degrees about its y axis from one fragment to
    the next. Through the port's loader, each pair's ``relt_pose`` lays the
    source fragment onto the target: over the source points that land in
    the target's bounding box, the mean distance to the nearest target
    point is below the fragments' voxel size (measured ~0.03 m at 0.05 m
    voxels), and with the inverse pose it is not (0.14-0.3 m)."""
    from scipy.spatial import cKDTree

    from bufferx_tpu_torch.config import make_cfg
    from bufferx_tpu_torch.data.datasets import ScannetppIphoneDataset

    root = write_raw_scene(str(tmp_path / "turning" / "scene0"), yaw_deg=10.0)
    stats = ts.prepare_scene(root, pair_kw=dict(keep_prob=1.0), device="cpu",
                             **FRAGMENT_KW)
    assert stats["pairs"] >= 2
    with pytest.warns(UserWarning, match="pinned benchmark"):
        ds = ScannetppIphoneDataset(make_cfg("Scannetpp_iphone",
                                             str(tmp_path / "turning")))
    assert len(ds) == stats["pairs"]
    voxel = FRAGMENT_KW["voxel_size"]
    for desc in ds.pairs:
        src, tgt, relt, *_ = ds.load_pair(desc)
        tree = cKDTree(tgt)
        lo, hi = tgt.min(0), tgt.max(0)

        def overlap_mean(T):
            warped = src @ T[:3, :3].T + T[:3, 3]
            inside = np.all((warped >= lo) & (warped <= hi), axis=1)
            assert inside.mean() > 0.5
            return float(tree.query(warped[inside])[0].mean())

        assert overlap_mean(relt) < voxel, desc
        assert overlap_mean(np.linalg.inv(relt)) > 2 * voxel, desc


def test_per_frame_block_stream(tmp_path):
    """The per-frame block encoding (no lz4 on this host: the deflate
    branch) decodes to the same depth files in both packages."""
    out = {}
    for name, mod in (("jax", js), ("port", ts)):
        root = write_raw_scene(str(tmp_path / name / "scene0"),
                               per_frame_blocks=True)
        scene = mod.SceneLayout(root)
        assert mod.extract_depth(scene) == 6
        out[name] = _files(scene.depth_dir)
    assert out["port"] == out["jax"] and len(out["port"]) == 6


def test_ffmpeg_contract_and_layout():
    scene = ts.SceneLayout("/data/scene0")
    assert ts.rgb_ffmpeg_command(scene) == js.rgb_ffmpeg_command(
        js.SceneLayout("/data/scene0"))
    for prop in ("iphone_dir", "video_path", "depth_bin_path",
                 "pose_json_path", "rgb_dir", "depth_dir", "pose_dir",
                 "intrinsic_dir", "tsdf_dir"):
        assert getattr(scene, prop) == getattr(js.SceneLayout("/data/scene0"),
                                               prop)
