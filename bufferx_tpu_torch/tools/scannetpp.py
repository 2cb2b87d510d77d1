"""ScanNet++ iPhone offline preprocessing pipeline.

The port's counterpart of :mod:`bufferx_tpu.tools.scannetpp`. Takes a raw
ScanNet++ iPhone scene (compressed depth stream + per-frame pose/intrinsic
JSON + RGB video) to registration-ready TSDF fragments with a gt.log
consumable by :class:`bufferx_tpu_torch.data.datasets.
ScannetppIphoneDataset`. A rebuild of the reference's front half
(``dataset/scannetpp/iphone/prepare_iphone_data.py``,
``scannetpp.cu:120-250``, ``pair_gen_iphone.py``, ``scene_release.py``):
the CUDA fusion kernel becomes the volume of
:mod:`bufferx_tpu_torch.tools.tsdf`, which stays on the card (``device``)
for a whole scene; everything else is dependency-free numpy.

Scene layout (reference ``scene_release.py``), rooted at
``<root>/<scene_id>/iphone/``:

- ``rgb.mp4``                      RGB video (optional; see
  :func:`rgb_ffmpeg_command` — registration only needs depth+pose)
- ``depth.bin``                    compressed depth stream, 192x256
- ``pose_intrinsic_imu.json``      per-frame ``aligned_pose``/``intrinsic``
- outputs: ``depth/frame_%06d.depth.npy`` (uint16 mm — the reference
  writes PNGs of the same values; npy keeps this pipeline dependency-
  free), ``pose/frame_%06d.pose.txt``, ``intrinsic/frame_%06d
  .intrinsic.txt``, ``tsdf/cloud_bin_N.ply``, ``gt.log``,
  ``valid_pcd_files.txt``, ``overlap_ratio.txt``.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from dataclasses import dataclass
from os.path import join
from typing import Optional

import numpy as np

__all__ = [
    "SceneLayout",
    "rgb_ffmpeg_command",
    "extract_depth",
    "extract_poses",
    "extract_intrinsics",
    "build_fragments",
    "generate_pairs",
    "prepare_scene",
]

DEPTH_H, DEPTH_W = 192, 256           # iPhone LiDAR depth resolution
INTRINSIC_SCALE = 7.5                 # 1920 / 256: video -> depth pixels
FRAMES_PER_FRAGMENT = 50              # scannetpp.cu:127


@dataclass(frozen=True)
class SceneLayout:
    """Path contract for one scene (reference ``scene_release.py``)."""

    root: str                          # <data_root>/<scene_id>
    scene_id: str = ""

    @property
    def iphone_dir(self):
        return join(self.root, "iphone")

    @property
    def video_path(self):
        return join(self.iphone_dir, "rgb.mp4")

    @property
    def depth_bin_path(self):
        return join(self.iphone_dir, "depth.bin")

    @property
    def pose_json_path(self):
        return join(self.iphone_dir, "pose_intrinsic_imu.json")

    @property
    def rgb_dir(self):
        return join(self.iphone_dir, "rgb")

    @property
    def depth_dir(self):
        return join(self.iphone_dir, "depth")

    @property
    def pose_dir(self):
        return join(self.iphone_dir, "pose")

    @property
    def intrinsic_dir(self):
        return join(self.iphone_dir, "intrinsic")

    @property
    def tsdf_dir(self):
        return join(self.iphone_dir, "tsdf")


def rgb_ffmpeg_command(scene: SceneLayout) -> str:
    """The RGB frame-extraction contract (reference
    ``prepare_iphone_data.py:22-25``). RGB frames are not consumed by the
    registration pipeline; run this only if you need imagery:

        ffmpeg -i <iphone>/rgb.mp4 -start_number 0 -q:v 1 \
            <iphone>/rgb/frame_%06d.color.jpg
    """
    return (
        f"ffmpeg -i {scene.video_path} -start_number 0 -q:v 1 "
        f"{scene.rgb_dir}/frame_%06d.color.jpg"
    )


def extract_depth(scene: SceneLayout, sample_rate: int = 1) -> int:
    """Decode the compressed depth stream to per-frame uint16-mm arrays.

    Handles both ScanNet++ encodings (reference
    ``prepare_iphone_data.py:34-84``): a single zlib-deflate stream of
    float32 meters [T, 192, 256], or per-frame 4-byte-length-prefixed
    blocks (lz4, or zlib-deflate float32). Returns the frame count.
    """
    os.makedirs(scene.depth_dir, exist_ok=True)
    path = scene.depth_bin_path
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: expected ScanNet++ depth.bin")

    def write(frame_id: int, depth_mm: np.ndarray):
        np.save(
            join(scene.depth_dir, f"frame_{frame_id:06d}.depth.npy"),
            depth_mm.astype(np.uint16),
        )

    with open(path, "rb") as f:
        blob = f.read()
    try:
        raw = zlib.decompress(blob, wbits=-zlib.MAX_WBITS)
        depth = np.frombuffer(raw, np.float32).reshape(-1, DEPTH_H, DEPTH_W)
        n = 0
        for t in range(0, depth.shape[0], sample_rate):
            write(t, depth[t] * 1000.0)
            n += 1
        return n
    except (zlib.error, ValueError):
        pass

    # per-frame blocks: [u32 little-endian size][payload] ...
    n = 0
    frame_id = 0
    off = 0
    while off + 4 <= len(blob):
        size = int.from_bytes(blob[off : off + 4], "little")
        off += 4
        payload = blob[off : off + size]
        off += size
        if frame_id % sample_rate == 0:
            depth_mm = None
            try:
                import lz4.block

                raw = lz4.block.decompress(
                    payload, uncompressed_size=DEPTH_H * DEPTH_W * 2
                )
                depth_mm = np.frombuffer(raw, np.uint16).reshape(
                    DEPTH_H, DEPTH_W
                )
            except Exception:
                raw = zlib.decompress(payload, wbits=-zlib.MAX_WBITS)
                depth_mm = (
                    np.frombuffer(raw, np.float32).reshape(DEPTH_H, DEPTH_W)
                    * 1000.0
                )
            write(frame_id, np.asarray(depth_mm))
            n += 1
        frame_id += 1
    return n


def extract_poses(scene: SceneLayout) -> int:
    """``aligned_pose`` per frame -> ``pose/frame_%06d.pose.txt`` (4x4)."""
    os.makedirs(scene.pose_dir, exist_ok=True)
    with open(scene.pose_json_path) as f:
        data = json.load(f)
    n = 0
    for frame_name, frame_data in data.items():
        pose = frame_data.get("aligned_pose")
        if pose:
            np.savetxt(
                join(scene.pose_dir, f"{frame_name}.pose.txt"),
                np.asarray(pose, np.float64),
            )
            n += 1
    return n


def extract_intrinsics(scene: SceneLayout,
                       ratio: float = INTRINSIC_SCALE) -> int:
    """Per-frame intrinsics scaled from video to depth resolution
    (reference ``prepare_iphone_data.py:106-126`` divides by 7.5)."""
    os.makedirs(scene.intrinsic_dir, exist_ok=True)
    with open(scene.pose_json_path) as f:
        data = json.load(f)
    n = 0
    for frame_name, frame_data in data.items():
        K = frame_data.get("intrinsic")
        if K:
            np.savetxt(
                join(scene.intrinsic_dir, f"{frame_name}.intrinsic.txt"),
                np.asarray(K, np.float64) / ratio,
            )
            n += 1
    return n


def _read_depth_m(scene: SceneLayout, frame_id: int) -> Optional[np.ndarray]:
    """Depth in meters, or None when the frame doesn't exist."""
    p = join(scene.depth_dir, f"frame_{frame_id:06d}.depth.npy")
    if os.path.exists(p):
        return np.load(p).astype(np.float32) / 1000.0
    return None


def build_fragments(
    scene: SceneLayout,
    frames_per_fragment: int = FRAMES_PER_FRAGMENT,
    voxel_size: float = 0.006,
    grid_dims=(500, 500, 500),
    grid_origin=(-1.5, -1.5, 0.5),
    surface_band: float = 0.2,
    device="cuda",
) -> int:
    """Fuse consecutive depth frames into per-fragment TSDF point clouds.

    Fragment ``cloud_bin_N`` fuses frames [N*F, (N+1)*F) in the BASE frame
    of frame N*F (reference ``scannetpp.cu:163-246``: cam2base =
    inv(base2world) @ cam2world; grid origin (-1.5, -1.5, 0.5), 500^3
    voxels at 6 mm, truncation 5 voxels, surface band |tsdf| < 0.2 with
    weight >= 1). Intrinsics come from the base frame. Writes binary PLYs
    and returns the fragment count. The volume is allocated once on
    ``device`` (the card unless the caller asks for the CPU) and emptied
    in place for each fragment.
    """
    from bufferx_tpu_torch.tools.tsdf import (
        extract_points,
        integrate_frame,
        make_volume,
        reset_volume,
    )
    from bufferx_tpu_torch.utils.vis import save_ply

    os.makedirs(scene.tsdf_dir, exist_ok=True)
    vol = None
    frag = 0
    base_idx = 0
    while True:
        pose_file = join(scene.pose_dir, f"frame_{base_idx:06d}.pose.txt")
        if _read_depth_m(scene, base_idx) is None or not os.path.exists(
            pose_file
        ):
            break
        base2world = np.loadtxt(pose_file)
        K = np.loadtxt(
            join(scene.intrinsic_dir, f"frame_{base_idx:06d}.intrinsic.txt")
        )
        world2base = np.linalg.inv(base2world)

        if vol is None:
            vol = make_volume(grid_origin, grid_dims, voxel_size,
                              device=device)
        else:
            reset_volume(vol)
        fused = 0
        for k in range(frames_per_fragment):
            t = base_idx + k
            depth = _read_depth_m(scene, t)
            pf = join(scene.pose_dir, f"frame_{t:06d}.pose.txt")
            if depth is None or not os.path.exists(pf):
                break
            cam2world = np.loadtxt(pf)
            cam2base = world2base @ cam2world
            vol = integrate_frame(vol, K, cam2base, depth)
            fused += 1
        if fused == 0:
            break
        pts = extract_points(vol, band=surface_band)
        save_ply(join(scene.tsdf_dir, f"cloud_bin_{frag}.ply"), pts)
        frag += 1
        base_idx += frames_per_fragment
        if fused < frames_per_fragment:
            break
    return frag


def generate_pairs(
    scene: SceneLayout,
    voxel_size: float = 0.05,
    overlap_thresh: float = 0.5,
    window: int = 60,
    keep_prob: float = 0.25,
    min_count_ratio: float = 0.6,
    frames_per_fragment: int = FRAMES_PER_FRAGMENT,
    seed: int = 0,
) -> int:
    """Overlap-filtered pair enumeration (reference ``pair_gen_iphone.py``).

    1. Fragments with point count below ``min_count_ratio`` x median are
       dropped (-> ``valid_pcd_files.txt``).
    2. Candidate pairs (i, j) within ``window`` positions are subsampled at
       ``keep_prob`` (the reference keeps a random 25%).
    3. trans = inv(pose_j) @ pose_i (poses of frames idx*F) maps fragment
       i into fragment j; pairs whose max bidirectional overlap at
       ``voxel_size`` reaches ``overlap_thresh`` are written to ``gt.log``
       (+ all ratios to ``overlap_ratio.txt``). Returns the accepted pair
       count.

    ``gt.log`` holds ``inv(trans)``, in the 3DMatch convention that the
    fragment loader reads (``relt_pose = inv(log pose)``, as
    ``tools/pairgen.py`` writes its logs), so a loaded pair's pose maps the
    source fragment onto the target. The JAX package writes ``trans``
    itself, which its loader inverts into the pair's inverse pose.
    """
    from bufferx_tpu_torch.data.base import compute_overlap_ratio
    from bufferx_tpu_torch.data.io import read_points

    rs = np.random.RandomState(seed)
    plys = sorted(
        (f for f in os.listdir(scene.tsdf_dir) if f.endswith(".ply")),
        key=lambda f: int("".join(c for c in f if c.isdigit()) or 0),
    )
    counts = {
        f: len(read_points(join(scene.tsdf_dir, f))) for f in plys
    }
    median = np.median(list(counts.values())) if counts else 0
    valid = [f for f in plys if counts[f] >= min_count_ratio * median]
    with open(join(scene.iphone_dir, "valid_pcd_files.txt"), "w") as f:
        f.write("".join(v + "\n" for v in valid))

    def frag_pose(name: str) -> np.ndarray:
        idx = int(name.split("_")[-1].split(".")[0])
        return np.loadtxt(
            join(
                scene.pose_dir,
                f"frame_{idx * frames_per_fragment:06d}.pose.txt",
            )
        )

    accepted = 0
    ratio_lines = []
    with open(join(scene.iphone_dir, "gt.log"), "w") as gt:
        for i in range(len(valid)):
            for j in range(i + 1, len(valid)):
                if j - i > window:
                    break
                if rs.random_sample() >= keep_prob:
                    continue
                src_idx = int(valid[i].split("_")[-1].split(".")[0])
                tgt_idx = int(valid[j].split("_")[-1].split(".")[0])
                trans = np.linalg.inv(frag_pose(valid[j])) @ frag_pose(
                    valid[i]
                )
                p0 = read_points(join(scene.tsdf_dir, valid[i]))
                p1 = read_points(join(scene.tsdf_dir, valid[j]))
                o0, o1 = compute_overlap_ratio(p0, p1, trans, voxel_size)
                ratio = max(o0, o1)
                ratio_lines.append(f"{src_idx}\t{tgt_idx}\t{ratio:.6f}")
                if ratio >= overlap_thresh:
                    gt.write(f"{src_idx}\t{tgt_idx}\t{len(plys)}\n")
                    for row in np.linalg.inv(trans):
                        gt.write(
                            "\t".join(f"{v: .8e}" for v in row) + "\n"
                        )
                    accepted += 1
    with open(join(scene.iphone_dir, "overlap_ratio.txt"), "w") as f:
        f.write("\n".join(ratio_lines))
    return accepted


def prepare_scene(scene_root: str, pair_kw: dict | None = None,
                  device="cuda", **fragment_kw) -> dict:
    """Full offline pipeline for one scene: depth/pose/intrinsic extraction
    -> TSDF fragments (on ``device``) -> overlap-filtered gt.log. Returns
    stage counts, and under ``"seconds"`` each stage's wall time
    (``extract``: depth, poses and intrinsics; ``fragments``: fusion,
    extraction and the PLY writes; ``pairs``)."""
    scene = SceneLayout(scene_root)
    t0 = time.perf_counter()
    stats = dict(
        depth_frames=extract_depth(scene),
        poses=extract_poses(scene),
        intrinsics=extract_intrinsics(scene),
    )
    t1 = time.perf_counter()
    # extract_points copies each fragment to the host: the clock reads
    # after the card's work
    stats["fragments"] = build_fragments(scene, device=device, **fragment_kw)
    t2 = time.perf_counter()
    stats["pairs"] = generate_pairs(
        scene,
        frames_per_fragment=fragment_kw.get(
            "frames_per_fragment", FRAMES_PER_FRAGMENT
        ),
        **(pair_kw or {}),
    )
    stats["seconds"] = dict(extract=t1 - t0, fragments=t2 - t1,
                            pairs=time.perf_counter() - t2)
    return stats
