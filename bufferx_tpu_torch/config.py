"""Typed configuration: the port's own copy of the serving-path dataclasses.

Mirrors :mod:`bufferx_tpu.config` field for field (names, defaults) for the
parts the ported path reads: data, test thresholds, patch embedder,
matching, and the static capacities. Training and optimizer settings come
with the training slice. ``make_cfg`` knows the presets ported so far.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

__all__ = [
    "DataConfig",
    "TestConfig",
    "PatchConfig",
    "MatchConfig",
    "CapacityConfig",
    "Config",
    "make_cfg",
    "indoor_base",
    "DATASETS",
]


@dataclass(frozen=True)
class DataConfig:
    dataset: str = ""
    root: str = ""
    downsample: float = 0.02
    voxel_size_0: float = 0.035
    max_num_pts: int = 30000
    manual_seed: int = 123
    pdist: float = 10.0
    clutter_filter: bool = False       # density prefilter before FPS


@dataclass(frozen=True)
class TestConfig:
    experiment_id: str = "threedmatch"
    pose_refine: bool = False
    enable_timing: bool = False
    rte_thresh: float = 0.3
    rre_thresh: float = 15.0


@dataclass(frozen=True)
class PatchConfig:
    des_r: float = 0.3
    num_points_per_patch: int = 512
    num_fps: int = 1500
    rad_n: int = 3
    azi_n: int = 20
    ele_n: int = 7
    delta: float = 0.8
    voxel_sample: int = 10
    num_scales: int = 3
    is_aligned_to_global_z: bool = False
    search_radius_thresholds: Tuple[float, ...] = (5.0, 2.0, 0.5)
    num_points_radius_estimate: int = 2000
    radius_max: float = 5.0
    desc_mode: str = "sampled"         # "sampled" | "moments"
    desc_pool: str = "gated"           # "gated" | "softmax"
    desc_width: float = 1.0
    exact_topk: bool = False
    block_ball_query: bool = False
    bq_block: int = 32
    bq_cand_blocks: int = 64
    strat_ball_query: bool = True      # fused stratified ball query (K2)
    radius_subsample: int = 4          # column prefix 1/4 in radius estimation
    radius_source: str = "denser"      # "denser" | "sparser"
    spt_pool_subsample: int = 1
    vmap_scales: bool = False
    fused_conv: bool = False
    scale_batch_conv: bool = False
    mxu_gather: bool = True            # matched-equi rows rounded through bf16


@dataclass(frozen=True)
class MatchConfig:
    pose_estimator: str = "ransac"     # "ransac" | "gnc"
    dist_th: float = 0.10
    inlier_th: float = 1.25
    similar_th: float = 0.8
    confidence: float = 0.999
    iter_n: int = 50000
    kiss_resolution: float = 0.3
    enable_early_exit: bool = False
    early_exit_min_inliers: int = 50


@dataclass(frozen=True)
class CapacityConfig:
    max_points: int = 30208            # = 512 * 59: strips of the strat query
    num_ransac_hypotheses: int = 8192
    ransac_chunk: int = 2048
    sphere_query_chunk: int = 256
    irls_iters: int = 20


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    test: TestConfig = field(default_factory=TestConfig)
    patch: PatchConfig = field(default_factory=PatchConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)
    stage: str = "test"
    benchmark: Optional[str] = None

    def override(self, **kw) -> "Config":
        """Nested override: ``cfg.override(match=dict(dist_th=0.2))``."""
        updates = {}
        for k, v in kw.items():
            cur = getattr(self, k)
            if isinstance(v, dict) and dataclasses.is_dataclass(cur):
                updates[k] = replace(cur, **v)
            else:
                updates[k] = v
        return replace(self, **updates)


def indoor_base() -> Config:
    return Config(data=DataConfig(clutter_filter=True))


def _modelnet40(root: str) -> Config:
    return indoor_base().override(
        data=dict(dataset="ModelNet40", root=root, downsample=0.01,
                  voxel_size_0=0.02, clutter_filter=False),
        test=dict(rte_thresh=0.1, rre_thresh=15.0),
    )


DATASETS = {"ModelNet40": _modelnet40}


def make_cfg(dataset_name: str, root_dir: str = "") -> Config:
    try:
        return DATASETS[dataset_name](root_dir)
    except KeyError:
        raise ValueError(
            f"Unknown or not yet ported dataset {dataset_name!r}; expected one "
            f"of {sorted(DATASETS)}"
        ) from None
