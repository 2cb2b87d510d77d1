"""The 13 benchmark dataset loaders.

The port's own copy of :mod:`bufferx_tpu.data.datasets` (numpy and scipy
only): the same pairs, in the same order, from the same random stream.

Re-implements the reference's loader inventory (SURVEY §2.5) on top of
:class:`bufferx_tpu_torch.data.base.PairDataset`: fragment datasets enumerate
pairs from ``gt.log`` files; LiDAR datasets walk odometry at ``pdist``
meters. No Open3D: file reading is :mod:`bufferx_tpu_torch.data.io`, ICP GT
refinement (KITTI) is a scipy-KDTree point-to-point ICP with the
reference's parameters (0.20 m, 200 iters, cached as npy —
``dataset/kitti.py:84-109``).

All loaders raise ``FileNotFoundError`` with the expected layout when the
dataset root is absent.
"""

from __future__ import annotations

import os
from os.path import join
from typing import List

import numpy as np

from bufferx_tpu_torch.config import Config
from bufferx_tpu_torch.data import splits
from bufferx_tpu_torch.data.base import (
    PairDataset,
    read_trajectory_log,
    walk_odometry_pairs,
)
from bufferx_tpu_torch.data.io import read_points

__all__ = [
    "ThreeDMatchDataset",
    "ETHDataset",
    "KITTIDataset",
    "WODDataset",
    "MITDataset",
    "OxfordDataset",
    "KAISTDataset",
    "KAISTHeteroDataset",
    "TIERSDataset",
    "TIERSHeteroDataset",
    "ScannetppIphoneDataset",
    "ScannetppFaroDataset",
    "ModelNet40Dataset",
    "get_dataset",
    "icp_refine",
]


def _require(path: str, hint: str):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"dataset path {path!r} not found; expected layout: {hint}"
        )


def _loadlog(gtpath: str):
    """gt.log -> {"i_j": pose} (reference ``utils/tools.py`` loadlog)."""
    pairs, poses = read_trajectory_log(join(gtpath, "gt.log"))
    return {
        f"{int(i)}_{int(j)}": pose for (i, j, _n), pose in zip(pairs, poses)
    }


def icp_refine(
    src: np.ndarray,
    tgt: np.ndarray,
    init: np.ndarray,
    max_dist: float = 0.20,
    max_iter: int = 200,
) -> np.ndarray:
    """Point-to-point ICP (scipy cKDTree), matching the reference's Open3D
    call used to refine KITTI GT (``dataset/kitti.py:95-102``)."""
    from scipy.spatial import cKDTree

    T = np.asarray(init, np.float64).copy()
    tree = cKDTree(tgt)
    prev_err = None
    for _ in range(max_iter):
        warped = src @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(warped, distance_upper_bound=max_dist)
        ok = np.isfinite(d)
        if ok.sum() < 3:
            break
        a = warped[ok]
        b = tgt[idx[ok]]
        ca, cb = a.mean(0), b.mean(0)
        H = (a - ca).T @ (b - cb)
        U, S, Vt = np.linalg.svd(H)
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ D @ U.T
        t = cb - R @ ca
        dT = np.eye(4)
        dT[:3, :3] = R
        dT[:3, 3] = t
        T = dT @ T
        err = float(d[ok].mean())
        if prev_err is not None and abs(prev_err - err) < 1e-8:
            break
        prev_err = err
    return T


# ---------------------------------------------------------------------------
# fragment-style datasets (gt.log pair enumeration)
# ---------------------------------------------------------------------------


class _FragmentDataset(PairDataset):
    """gt.log-enumerated fragment pairs; relt_pose = inv(log pose)
    (reference ``dataset/threedmatch.py:36-63,113-118``)."""

    def _add_scene(self, gtpath: str, pcd_dir: str, name_fmt: str):
        if not os.path.exists(join(gtpath, "gt.log")):
            return  # partially-downloaded benchmarks: skip missing scenes
        gtlog = _loadlog(gtpath)
        for key, pose in gtlog.items():
            i, j = key.split("_")
            self.pairs.append(
                (
                    join(pcd_dir, name_fmt.format(i)),
                    join(pcd_dir, name_fmt.format(j)),
                    pose,
                )
            )

    def load_pair(self, desc):
        src_path, tgt_path, pose = desc
        src = read_points(src_path)
        tgt = read_points(tgt_path)
        relt = np.linalg.inv(pose)
        return src, tgt, relt, src_path, tgt_path, {}


class ThreeDMatchDataset(_FragmentDataset):
    """3DMatch fragments (``dataset/threedmatch.py``).

    test: the 8-scene 3DMatch / 3DLoMatch benchmark at
    ``root/test/{3DMatch/gt_result/<scene>|3DLoMatch/<scene>}/gt.log`` with
    fragments at ``root/test/3DMatch/fragments/<scene>/cloud_bin_N.ply``.

    train / val: overlap-manifest pairs over the *training* scenes
    (reference ``dataset/threedmatch.py:21-34``), NEVER the test benchmark:

    - ``root/train/3DMatch_train_overlap.pkl`` — pickled dict whose keys are
      ``"<src_id>@<tgt_id>"`` (fragment ids relative to ``root/train``, e.g.
      ``"sun3d-.../seq-01/cloud_bin_3"``) for fragment pairs with sufficient
      overlap;
    - ``root/train/{train,val}_3dmatch.txt`` — whitespace-separated scene
      lists selecting the split;
    - per fragment: ``<id>.ply`` cloud + ``<id>.pose.npy`` world pose
      (relative GT = inv(tgt_pose) @ src_pose, ``threedmatch.py:113-115``).
    """

    def __init__(self, cfg: Config, split: str = "test"):
        super().__init__(cfg, split)
        if split == "test":
            benchmark = cfg.benchmark or "3DMatch"
            root = join(cfg.data.root, "test")
            _require(root, "ThreeDMatch/test/{3DMatch,3DLoMatch}/...")
            for scene in splits.THREEDMATCH_TEST_SCENES:
                if benchmark == "3DMatch":
                    gtpath = join(root, "3DMatch", "gt_result", scene)
                else:
                    gtpath = join(root, "3DLoMatch", scene)
                pcd_dir = join(root, "3DMatch", "fragments", scene)
                self._add_scene(gtpath, pcd_dir, "cloud_bin_{}.ply")
        else:
            self._prepare_train_pairs(split)

    def _prepare_train_pairs(self, split: str):
        import pickle

        root = join(self.cfg.data.root, "train")
        manifest = join(root, "3DMatch_train_overlap.pkl")
        scene_file = join(root, f"{split}_3dmatch.txt")
        _require(
            manifest,
            "ThreeDMatch/train/{3DMatch_train_overlap.pkl,"
            f"{split}_3dmatch.txt,<scene>/seq-NN/cloud_bin_N.ply"
            " + .pose.npy} — training must NOT enumerate the test benchmark",
        )
        _require(scene_file, f"ThreeDMatch/train/{split}_3dmatch.txt")
        with open(manifest, "rb") as f:
            overlap = pickle.load(f)
        with open(scene_file) as f:
            scenes = set(f.read().split())
        self._train_root = root
        for key in sorted(overlap):
            src_id, tgt_id = key.split("@")
            if src_id.split("/")[0] in scenes:
                self.pairs.append((src_id, tgt_id))

    def load_pair(self, desc):
        if len(desc) == 3:  # test: (src_path, tgt_path, gt.log pose)
            return super().load_pair(desc)
        src_id, tgt_id = desc
        if self.rng.rand() > 0.5:  # random direction (threedmatch.py:69-71)
            src_id, tgt_id = tgt_id, src_id
        sp = join(self._train_root, src_id)
        tp = join(self._train_root, tgt_id)
        src = read_points(sp + ".ply")
        tgt = read_points(tp + ".ply")
        src_pose = np.load(sp + ".pose.npy")
        tgt_pose = np.load(tp + ".pose.npy")
        relt = np.linalg.inv(tgt_pose) @ src_pose
        return src, tgt, relt, src_id, tgt_id, {}


class ETHDataset(_FragmentDataset):
    """ETH Hokuyo scans, 4 scenes (``dataset/eth.py:18-37``)."""

    def __init__(self, cfg: Config, split: str = "test"):
        super().__init__(cfg, split)
        _require(cfg.data.root, "ETH/<scene>/{gt.log,Hokuyo_N.ply}")
        for scene in splits.ETH_TEST_SCENES:
            self._add_scene(
                join(cfg.data.root, scene),
                join(cfg.data.root, scene),
                "Hokuyo_{}.ply",
            )


class ScannetppIphoneDataset(_FragmentDataset):
    """ScanNet++ iPhone TSDF fragments (``dataset/scannetpp_iphone.py``).

    Supports both the reference layout —
    ``<root>/<scene>/iphone/gt.log`` + ``iphone/tsdf/cloud_bin_N.ply``
    (what the JAX package's ``tools/scannetpp.py`` produces) —
    and a flat ``<root>/<scene>/{gt.log,cloud_bin_N.ply}``.

    The scene set is the PINNED benchmark list
    (``splits.SCANNETPP_IPHONE_TEST``, reference
    ``config/splits/test_scannetpp_iphone.txt``); a partially downloaded
    root warns loudly instead of silently evaluating a smaller benchmark
    (see :func:`bufferx_tpu_torch.data.splits.pinned_scenes`)."""

    scene_split = splits.SCANNETPP_IPHONE_TEST
    split_name = "test_scannetpp_iphone"

    def __init__(self, cfg: Config, split: str = "test"):
        super().__init__(cfg, split)
        _require(
            cfg.data.root,
            "scannetpp_iphone/<scene>/{iphone/{gt.log,tsdf/*.ply}|"
            "gt.log,*.ply}",
        )
        for scene in splits.pinned_scenes(
            cfg.data.root, self.scene_split, self.split_name
        ):
            base = join(cfg.data.root, scene)
            if os.path.exists(join(base, "iphone", "gt.log")):
                self._add_scene(
                    join(base, "iphone"), join(base, "iphone", "tsdf"),
                    "cloud_bin_{}.ply",
                )
            elif os.path.exists(join(base, "gt.log")):
                self._add_scene(base, base, "cloud_bin_{}.ply")


class ScannetppFaroDataset(ScannetppIphoneDataset):
    """ScanNet++ simulated-Faro scans (``dataset/scannetpp_faro.py``);
    pinned scene list ``splits.SCANNETPP_FARO_TEST`` (reference
    ``config/splits/test_scannetpp_faro.txt``, 163 scenes)."""

    scene_split = splits.SCANNETPP_FARO_TEST
    split_name = "test_scannetpp_faro"


class ModelNet40Dataset(_FragmentDataset):
    """Object-scale pairs synthesized offline (``dataset/modelnet40.py``):
    gt.log with object ids, clouds at <root>/<scene>/cloud_bin_N.npy."""

    def __init__(self, cfg: Config, split: str = "test"):
        super().__init__(cfg, split)
        _require(cfg.data.root, "modelnet40_pairs/<object>/{gt.log,*.npy}")
        for scene in sorted(os.listdir(cfg.data.root)):
            gtpath = join(cfg.data.root, scene)
            if os.path.exists(join(gtpath, "gt.log")):
                self._add_scene(gtpath, gtpath, "cloud_bin_{}.npy")


# ---------------------------------------------------------------------------
# odometry-walked LiDAR datasets
# ---------------------------------------------------------------------------


class _OdometryDataset(PairDataset):
    """Sequence datasets paired by accumulated odometry distance."""

    ext = ".pcd"

    def __init__(self, cfg: Config, split: str = "test"):
        super().__init__(cfg, split)
        last_err = None
        for seq in self.sequences(split):
            try:
                poses = self.odometry(seq)          # [T, 4, 4] world<-scan
            except FileNotFoundError as e:
                last_err = e                        # partial download: skip
                continue
            if poses is None or not len(poses):
                continue
            idx_pairs = walk_odometry_pairs(
                poses[:, :3, 3], cfg.data.pdist, exclude=self.exclude(seq)
            )
            for i, j in idx_pairs:
                self.pairs.append((seq, i, j, poses[i], poses[j]))
        if not self.pairs and last_err is not None:
            raise last_err

    # hooks ------------------------------------------------------------
    def sequences(self, split: str) -> List[str]:
        raise NotImplementedError

    def odometry(self, seq: str):
        raise NotImplementedError

    def scan_path(self, seq: str, t: int) -> str:
        raise NotImplementedError

    def exclude(self, seq: str):
        return ()

    def refine_gt(self, seq, i, j, src, tgt, relt):
        return relt

    # template ----------------------------------------------------------
    def load_pair(self, desc):
        seq, i, j, Ti, Tj = desc
        src = read_points(self.scan_path(seq, i))
        tgt = read_points(self.scan_path(seq, j))
        # tgt ≈ relt @ src with world-from-scan odometry: relt = inv(Tj) Ti
        relt = np.linalg.inv(Tj) @ Ti
        relt = self.refine_gt(seq, i, j, src, tgt, relt)
        return src, tgt, relt, f"{seq}/{i}", f"{seq}/{j}", {}

    @staticmethod
    def _kitti_pose_file(path: str) -> np.ndarray:
        """KITTI-format pose rows (12 or 16 values) -> [T, 4, 4]."""
        raw = np.loadtxt(path).reshape(-1)
        w = 12 if raw.size % 12 == 0 else 16
        mats = raw.reshape(-1, w)[:, :12].reshape(-1, 3, 4)
        out = np.tile(np.eye(4), (len(mats), 1, 1))
        out[:, :3, :4] = mats
        return out


class KITTIDataset(_OdometryDataset):
    """KITTI odometry velodyne pairs at pdist=10 m (``dataset/kitti.py``).

    GT = velo2cam-conjugated camera odometry refined by ICP, cached under
    ``root/icp/`` exactly like the reference (``:84-109``); the known-bad
    pair index (8, 15, 58) is excluded (``:60-61``)."""

    ext = ".bin"

    def __init__(self, cfg: Config, split: str = "test"):
        self._velo2cam = None
        super().__init__(cfg, split)

    def sequences(self, split):
        return splits.KITTI[split]

    def exclude(self, seq):
        # reference removes the known-bad test pair (drive 8, frames 15->58)
        # from the walk (dataset/kitti.py:60-61)
        if self.split == "test" and int(seq) == 8:
            return ((15, 58),)
        return ()

    def odometry(self, seq):
        path = join(
            self.cfg.data.root, "dataset", "poses", f"{int(seq):02d}.txt"
        )
        alt = join(self.cfg.data.root, "poses", f"{int(seq):02d}.txt")
        path = path if os.path.exists(path) else alt
        _require(path, "kitti/{dataset/,}poses/NN.txt + sequences/NN/velodyne")
        cam = self._kitti_pose_file(path)
        v2c = self.velo2cam()
        # world<-velo = cam_pose @ velo2cam: the reference's transposed
        # expression (kitti.py:86-91) simplifies to
        # relt = V^-1 P1^-1 P0 V with V = velo->cam, i.e. exactly
        # inv(P1 V) @ (P0 V) — our generic inv(Tj) @ Ti with T = P V.
        return np.einsum("tij,jk->tik", cam, v2c)

    def scan_path(self, seq, t):
        base = join(self.cfg.data.root, "dataset", "sequences")
        alt = join(self.cfg.data.root, "sequences")
        base = base if os.path.exists(base) else alt
        return join(base, f"{int(seq):02d}", "velodyne", f"{t:06d}.bin")

    def velo2cam(self) -> np.ndarray:
        """Fixed velodyne->camera extrinsics V (``dataset/kitti.py:198-219``).
        The reference stores Vᵀ and conjugates with transposes; expanding its
        ``(Vᵀ P0ᵀ inv(P1ᵀ) inv(Vᵀ))ᵀ`` gives ``V⁻¹ P1⁻¹ P0 V`` — we keep the
        plain V and fold it into the odometry instead."""
        if self._velo2cam is None:
            R = np.array(
                [
                    7.533745e-03, -9.999714e-01, -6.166020e-04,
                    1.480249e-02, 7.280733e-04, -9.998902e-01,
                    9.998621e-01, 7.523790e-03, 1.480755e-02,
                ]
            ).reshape(3, 3)
            T = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01])
            M = np.eye(4)
            M[:3, :3] = R
            M[:3, 3] = T
            self._velo2cam = M
        return self._velo2cam

    def refine_gt(self, seq, i, j, src, tgt, relt):
        icp_dir = join(self.cfg.data.root, "icp")
        os.makedirs(icp_dir, exist_ok=True)
        key = f"{int(seq)}_{i}_{j}"
        cache = join(icp_dir, key + ".npy")
        if os.path.exists(cache):
            return np.load(cache)
        # subsample for speed, mirror reference's full-cloud 0.20 m ICP
        rs = np.random.RandomState(0)
        s = src[rs.choice(len(src), min(len(src), 20000), replace=False)]
        t = tgt[rs.choice(len(tgt), min(len(tgt), 20000), replace=False)]
        refined = icp_refine(s, t, relt, max_dist=0.20, max_iter=200)
        np.save(cache, refined)
        return refined


class WODDataset(_OdometryDataset):
    """Waymo Open Dataset preprocessed scans (``dataset/wod.py``)."""

    ext = ".bin"

    def sequences(self, split):
        return splits.WOD_TEST

    def odometry(self, seq):
        path = join(self.cfg.data.root, "test", "sequences", seq, "poses.txt")
        _require(path, "WOD/test/sequences/<seq>/{poses.txt,scans/*.bin}")
        return self._kitti_pose_file(path)

    def scan_path(self, seq, t):
        return join(
            self.cfg.data.root, "test", "sequences", seq, "scans", f"{t:06d}.bin"
        )


class _ScansPosesDataset(_OdometryDataset):
    """Shared layout: root/<seq>/scans/NNNNNN.pcd + poses file."""

    pose_file = "poses_kitti.txt"
    seq_list: List[str] = []

    def sequences(self, split):
        return self.seq_list

    def odometry(self, seq):
        path = join(self.cfg.data.root, seq, self.pose_file)
        _require(path, f"<root>/<seq>/{self.pose_file} + scans/*{self.ext}")
        return self._kitti_pose_file(path)

    def scan_path(self, seq, t):
        return join(self.cfg.data.root, seq, "scans", f"{t:06d}{self.ext}")


class MITDataset(_ScansPosesDataset):
    """Kimera-Multi jackal sequences (``dataset/mit.py``)."""

    seq_list = splits.MIT_TEST


class OxfordDataset(_ScansPosesDataset):
    """Newer College (``dataset/oxford.py``)."""

    seq_list = splits.OXFORD_TEST


class KAISTDataset(_ScansPosesDataset):
    """HeLiPR KAIST05 per-sensor sequences (``dataset/kaist.py``)."""

    ext = ".bin"
    seq_list = splits.KAIST_TEST


class TIERSDataset(_OdometryDataset):
    """TIERS indoor multi-sensor sequences (``dataset/tiers.py``):
    root/<seq>/<sensor>/{scans/*.pcd, poses_kitti.txt}; every sensor of
    every sequence contributes pairs."""

    SENSORS = ["os0_128", "os1_64", "vel16"]

    def __init__(self, cfg: Config, split: str = "test"):
        PairDataset.__init__(self, cfg, split)
        for seq in splits.TIERS_TEST:
            for sensor in self.SENSORS:
                base = join(cfg.data.root, seq, sensor)
                pose_path = join(base, "poses_kitti.txt")
                if not os.path.exists(pose_path):
                    continue
                poses = self._kitti_pose_file(pose_path)
                for i, j in walk_odometry_pairs(
                    poses[:, :3, 3], cfg.data.pdist
                ):
                    self.pairs.append(
                        ((seq, sensor), i, j, poses[i], poses[j])
                    )
        if not self.pairs:
            _require(
                join(cfg.data.root, splits.TIERS_TEST[0]),
                "tiers_indoor/<seq>/<sensor>/{poses_kitti.txt,scans/*.pcd}",
            )

    def scan_path(self, seq_sensor, t):
        seq, sensor = seq_sensor
        return join(self.cfg.data.root, seq, sensor, "scans", f"{t:06d}.pcd")

    def load_pair(self, desc):
        seq_sensor, i, j, Ti, Tj = desc
        src = read_points(self.scan_path(seq_sensor, i))
        tgt = read_points(self.scan_path(seq_sensor, j))
        relt = np.linalg.inv(Tj) @ Ti
        return (
            src, tgt, relt,
            f"{seq_sensor[0]}/{seq_sensor[1]}/{i}",
            f"{seq_sensor[0]}/{seq_sensor[1]}/{j}",
            {"sensor": seq_sensor[1]},
        )


class _HeteroDataset(PairDataset):
    """Cross-sensor pairs (``dataset/tiers.py:193-309`` / ``kaist.py``):
    walk the source sensor's trajectory; for each frame, take the first
    target-sensor frame (within a 100-frame window) whose position is more
    than ``pdist`` away; gate by bidirectional overlap ratio
    (max(o0, o1) > overlap_thresh, voxel 0.1 — tiers_hetero_config.py:21-24)
    and cache the computed pair list like the reference."""

    OVERLAP_VOXEL = 0.1
    OVERLAP_THRESH = 0.3

    def __init__(self, cfg: Config, split: str, src_sensor: str,
                 tgt_sensor: str):
        super().__init__(cfg, split)
        self.src_sensor = src_sensor
        self.tgt_sensor = tgt_sensor
        from bufferx_tpu_torch.data.base import compute_overlap_ratio

        cache = join(
            cfg.data.root, "overlap_pairs",
            f"{src_sensor}_to_{tgt_sensor}_overlap_pairs.npy",
        )
        if os.path.exists(cache):
            raw = np.load(cache, allow_pickle=True)
            for seq, i, j, Ti, Tj, o0, o1 in raw:
                if max(o0, o1) > self.OVERLAP_THRESH:
                    self.pairs.append((seq, int(i), int(j), Ti, Tj))
            return
        records = []
        for seq in self.sequence_list():
            src_poses = self.sensor_odometry(seq, src_sensor)
            tgt_poses = self.sensor_odometry(seq, tgt_sensor)
            if src_poses is None or tgt_poses is None:
                continue
            n = min(len(src_poses), len(tgt_poses))
            cur = 0
            while cur < n:
                d = np.linalg.norm(
                    tgt_poses[cur : cur + 100, :3, 3]
                    - src_poses[cur, :3, 3],
                    axis=-1,
                )
                hits = np.where(d > cfg.data.pdist)[0]
                if len(hits) == 0:
                    cur += 1
                    continue
                j = cur + int(hits[0])
                if j >= n:
                    break
                relt = np.linalg.inv(tgt_poses[j]) @ src_poses[cur]
                try:
                    src = read_points(
                        self.sensor_scan_path(seq, src_sensor, cur)
                    )
                    tgt = read_points(
                        self.sensor_scan_path(seq, tgt_sensor, j)
                    )
                    o0, o1 = compute_overlap_ratio(
                        src, tgt, relt, self.OVERLAP_VOXEL
                    )
                except FileNotFoundError:
                    o0 = o1 = 1.0
                records.append(
                    (seq, cur, j, src_poses[cur], tgt_poses[j], o0, o1)
                )
                cur = j + 1
        if records:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            np.save(cache, np.asarray(records, dtype=object),
                    allow_pickle=True)
        for seq, i, j, Ti, Tj, o0, o1 in records:
            if max(o0, o1) > self.OVERLAP_THRESH:
                self.pairs.append((seq, i, j, Ti, Tj))

    def sequence_list(self):
        raise NotImplementedError

    def sensor_odometry(self, seq, sensor):
        raise NotImplementedError

    def sensor_scan_path(self, seq, sensor, t):
        raise NotImplementedError

    def load_pair(self, desc):
        seq, i, j, Ti, Tj = desc
        src = read_points(self.sensor_scan_path(seq, self.src_sensor, i))
        tgt = read_points(self.sensor_scan_path(seq, self.tgt_sensor, j))
        relt = np.linalg.inv(Tj) @ Ti
        return (
            src, tgt, relt,
            f"{seq}/{self.src_sensor}/{i}", f"{seq}/{self.tgt_sensor}/{j}",
            {"sensor": f"{self.src_sensor}->{self.tgt_sensor}"},
        )


class TIERSHeteroDataset(_HeteroDataset):
    def sequence_list(self):
        return splits.TIERS_TEST

    def sensor_odometry(self, seq, sensor):
        path = join(self.cfg.data.root, seq, sensor, "poses_kitti.txt")
        if not os.path.exists(path):
            return None
        return _OdometryDataset._kitti_pose_file(path)

    def sensor_scan_path(self, seq, sensor, t):
        return join(self.cfg.data.root, seq, sensor, "scans", f"{t:06d}.pcd")


class KAISTHeteroDataset(_HeteroDataset):
    def sequence_list(self):
        return [""]

    def sensor_odometry(self, seq, sensor):
        path = join(self.cfg.data.root, sensor, "poses_kitti.txt")
        if not os.path.exists(path):
            return None
        return _OdometryDataset._kitti_pose_file(path)

    def sensor_scan_path(self, seq, sensor, t):
        return join(self.cfg.data.root, sensor, "scans", f"{t:06d}.bin")


_DATASETS = {
    "3DMatch": ThreeDMatchDataset,
    "3DLoMatch": ThreeDMatchDataset,
    "ETH": ETHDataset,
    "KITTI": KITTIDataset,
    "WOD": WODDataset,
    "MIT": MITDataset,
    "Oxford": OxfordDataset,
    "KAIST": KAISTDataset,
    "TIERS": TIERSDataset,
    "Scannetpp_iphone": ScannetppIphoneDataset,
    "Scannetpp_faro": ScannetppFaroDataset,
    "ModelNet40": ModelNet40Dataset,
}


def get_dataset(cfg: Config, split: str = "test", src_sensor=None,
                tgt_sensor=None):
    """Loader factory (reference ``dataset/dataloader.py:127-171``)."""
    name = cfg.data.dataset
    if name == "TIERS_hetero":
        return TIERSHeteroDataset(cfg, split, src_sensor or "os0_128",
                                  tgt_sensor or "os1_64")
    if name == "KAIST_hetero":
        return KAISTHeteroDataset(cfg, split, src_sensor or "Aeva",
                                  tgt_sensor or "Avia")
    try:
        return _DATASETS[name](cfg, split)
    except KeyError:
        raise ValueError(f"unknown dataset {name!r}") from None
