"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``bufferx_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   its path gives it (taken from a real batch of 8 pairs and its first
   pair): FPS indices exact, there and
   on edge shapes (tied distances across blocks, rounds past the valid
   count, an all-padded cloud, ragged sizes, 1 and 5 clouds), with the
   latency floor of its design (the rounds' exchange alone) timed beside it,
   and timed at the batch's 16 clouds beside the pair's 2;
   the stratified query bit-exact at one cloud, one pair (2 clouds) and the
   batch (16 clouds), for all three radii and for phase 1's single radius,
   and on edge shapes (ragged and odd tile widths, 1 and 127 strips, 1 to 4
   radii, 1 to 10 clouds, a matrix view with a larger cloud stride), each
   shape timed alone and back to back beside its bound by bytes; the
   cell query bit-exact, moment counts exact and sums
   within |k - p| <= 1e-4 + 1e-5 |p| (f32 summation order), both also on
   edge shapes (ragged and maximal patch sizes, all points masked, all
   points in one cell, points at distance r and one ulp either side of it,
   points on the z axis, 1x1x1 and 2x3x5 grids, 1 and 3001 patches, no
   ring length given), two moment launches equal to the bit, and the ring
   cull both share against its plain twin on the patches of all three
   scales (equal candidate counts per ring, no hit dropped); the conv stack
   twice on the path's input: with small random weights (outputs below 1)
   within 1e-2 absolute and a mean error under 2^-10 of the mean magnitude,
   and with the shipped weights (outputs near 10, where one bf16 step is
   2^-4) within two bf16 steps at its largest output magnitude and a mean
   error under 2^-8 of the mean magnitude (the two sum in another f32
   order, so an activation near a bf16 rounding boundary rounds the other
   way and later layers carry the step); kernel, plain and
   library-yardstick times (median of CUDA-event runs) and the bound;
3b. the conv layers' serving epilogue (``kernels/conv_epilogue.py``) on
   one scale's pass (``_scale_candidates``) of the batch of 8 (24000
   patches, 12000 matches) and of the first pair (3000, 1500) on the
   moments path, and of 2 pairs on the sampled + fused path (one chunk of
   6000 patches, 3000 matches): every layer's kernel output ``torch.equal``
   to the plain version on the layer's real input, kernel and plain ms
   (medians of CUDA-event runs, summed over a net's layers) beside the
   bound by bytes; the nets' ``desc``, ``equi`` and ``ind`` through the
   kernel equal to the plain route's (the plain version in the kernel's
   place) and to the eager chain's (the layers' own ops, as they run off
   the card); 21 launches a pass (11 the descriptor net, 10 the
   cost volume; 3 + 10 on the sampled path) and no conv forward served by
   the eager chain;
3c. the hypothesis scoring (``kernels/hyp_score.py``) on the real
   candidates of the batch of 8 (all scales): RANSAC's checked minimal sets
   from the solver's own pool at B = 8, H = 8192 on scale 0's 1500
   correspondences and on all 4500, at H = 50000 on 4500 (the outdoor
   preset's budget) and at B = 1 on 4500, and the consensus's candidates
   at C x C (B = 8 and 1500 or 4500, B = 1 and 4500): counts
   ``torch.equal`` to the plain version, kernel and plain ms beside the
   bound by operations over every pair and over the pairs the gate and the
   mask leave; every distance of 256 hypotheses equal to the eager chain's
   (the kernel's rounding order); every phase that registers pairs holds
   its launches to a consensus and a RANSAC scoring a solve (a consensus
   alone with GNC), one solve a precomputation;
4. the main path: ``register_pair`` with the ``hard_moments_r4ft2`` weights
   ("moments" descriptor) at full width (30208 points, 1500 keypoints, 2000
   probes, 512-point patches, 3 scales, 8192 hypotheses) on 4 seeded
   full-overlap pairs after one warm-up; per-pair ms, RTE/RRE/success
   against ModelNet40's thresholds; launch counts read around exactly
   these 4 registrations;
4b. the sampled path: the same with the ``hard`` weights (the reference
   "sampled" descriptor, 10 samples per cell) and ``fused_conv``;
5. the card path against the CPU path (plain versions) end to end on a
   small input with the same draws, for both paths, and for one batch of 3
   through ``register_pairs_batched``;
6. batched two-phase serving at full width, moments path, batches of 8, 16
   seeded full-overlap pairs after a warm-up batch, four times: (a) the
   shipped early-exit threshold, (b) a threshold no pair reaches (scale 0,
   then all scales, for every pair), (c) a threshold every pair reaches
   (scale 0 alone), and (d) a threshold at the median of (c)'s inlier
   counts, which splits the pairs and gives redo batches shorter than 8;
   pairs per second, the ``scales_used`` histogram, peak
   memory, successes; launches per batch asserted (FPS and the stratified
   query 1 a batch run, moment pooling 1 a scale); (b)'s poses against
   ``register_pair`` and (c)'s and (d)'s against
   ``register_pair_early_exit`` with the same draws within 0.02 m / 2
   degrees; one batch under
   ``torch.cuda.set_sync_debug_mode("warn")`` to count synchronizing calls;
6b. the sampled + fused path batched (one batch of 4 pairs, all scales),
   each pose against ``register_pair``: the cell query 1 launch a scale a
   batch, the conv stack 1 for each sub-batch of the descriptor net (2);
7. ``register_pair_early_exit``, ``register_pair_timed`` with IRLS
   refinement and ``pose_estimator="gnc"`` on one full-width pair each;
8. the quality-gate path at full width: ``tools/exp_hard.py``'s runner on
   all 17 cells of the hard gate, one batch of 8 pairs a cell, with the
   3DMatch configuration (clutter prefilter and IRLS on): per-cell recall,
   pairs per second and peak memory, launches asserted (FPS and the
   stratified query 1 a batch, moment pooling 3), successes >= the JAX
   package's count on the same 136 pairs less 6; then the prefilter on the
   card against its plain version (the same torch ops on the CPU) on the
   16 clouds of the 20%-clutter cell's batch (slots that flip, timed), and
   that batch through all scales under the sync-debug mode (no
   synchronizing call);
9. the evaluation harness: ``evaluate_pairs`` on 4 hard pairs with per-phase
   timing off and on, ``evaluate_pairs_batched`` on 16 pairs at B = 8, the
   per-sample CSVs written under ``chiprun_out/``; every pose within 1e-5 m
   of ``register_batch``'s on the same clouds with the same draws;
10. training on the card, at the configuration that trained
   ``hard_moments_r4ft2`` (``tools/train_synthetic.py``'s: 4096-point
   clouds, 256 correspondences, 256-point patches, moments mode, gated
   pool, width 1, float32), on 3 ``hard_training_stream`` batches: moment
   pooling (K3) and the cell query (K4) against their plain versions on a
   batch's training patches (counts exact and sums within
   1e-4 + 1e-5 |p|; slots bit-exact), timed; one Desc and one Pose step
   from ``hard_moments_r4ft2`` on the card and on the CPU with the same
   batch and draws (loss within 1e-4 relative; global gradient norm within
   1e-2: the Pose stage's train-mode BatchNorm makes its float32 gradient
   ill-conditioned, JAX's own is 3.6e-3 from a float64 evaluation in
   tests/test_torch_train_forward.py; the parameters' step equal within
   1e-3 learning rates on at least 98% of the elements and never more than
   two learning rates apart: Adam turns a gradient element at the float32
   noise level into a full step of either sign; running statistics within
   1e-3 relative L2); then 20 Desc and 20 Pose steps from ``hard_moments_r4ft2`` and 5
   sampled-mode Desc steps from ``snapshot/hard``, each after 3 untimed
   steps (the last under the sync-debug mode: no synchronizing call), timed
   with CUDA events: ms a step, peak memory (and its excess over what the
   smoke held before the steps), every loss finite and every
   step accepted, K3 (K4 in sampled mode) launched 2 times a step and no
   other kernel; the trained moments nets written as a snapshot
   (``tools/weights.py``), loaded back with ``load_snapshot`` and its
   ``config.json``, and phase 4's first pair registered with it;
11. the dataset entry points at full width on a 3DMatch-layout scene of 8
   hardsynth pairs (``tools/hard_layout.py``: binary PLY fragments of
   ~200k points, ``gt.log``, ``gt.info``) written to a temporary
   directory: ``tools/evaluate.py --dataset 3DMatch`` with the
   ``hard_moments_r4ft2`` weights, in-process, sequential (the fused query,
   K1-K3), with ``--batched 8``, with ``--fast`` (the flat query at 4096
   points), with ``--num-points-per-patch 1024`` (the flat query) and
   ``128`` (the single-radius stratified query), and with the
   ``snapshot/hard`` weights (sampled mode, K4) at 1024- and 128-point
   patches on 2 pairs: launches asserted (K2 0 off the fused query),
   successes >= the JAX package's count on the same files at the same
   width less 1, the RMSE protocol's recall, ms a pair and the loaders'
   data stall; the loader alone on one pair; the four patch queries alone
   on one pair at 512-point patches; K3 and K4 against their plain
   versions on the 1024- and 128-point patches; one batch of the flat,
   single-radius and block queries under the sync-debug mode (no
   synchronizing call); the gate runner's cells 0, 3 and 6 on the sampled
   path with the fused conv stack, with ``--no-strat`` (the block query,
   K2 0) and without, the block query's successes >= the JAX package's
   on the same pairs less 2; ``tools/train.py --dataset 3DMatch`` from
   ``snapshot/hard`` on a training manifest of hardsynth pairs at the
   preset's width (512 correspondences, 512-point patches, 30208 points),
   3 Desc and 3 Pose steps timed with CUDA events, then one pair served
   with the result; the ``hard_moments_r4ft2`` descriptor's Desc stage on
   the same stream, 3 steps timed; K3 and K4 against their plain versions
   on one training batch's patches;
12. the multi-frame front end and the distributed layer:
   ``tools/exp_multiframe.py`` (a) at its defaults (50 frames, 55 edges,
   4096 points, ``hard_moments_r4ft2``) and (b) at the main path's capacity
   (30208 points, 20 frames), each a warm-up and a timed run: edges
   registered >= the JAX package's count on the same frames less 1, the
   refined ATE <= JAX's + 0.02 m, K1-K3 launched (the counts of (a) give
   the ``multiframe`` launches, those of (b) ``multiframe_30208``); K1, K2
   and K3 against their plain versions at each run's batch shapes (16
   clouds of 4096 points; 16 clouds of 30208 points); no synchronizing
   call in a batch of its edges, in the GN loop or in the BA loop; GN on
   (a)'s graph and BA on a synthetic problem (50 frames, 2000 landmarks,
   20000 observations, the chain's factors) on the card in float32 against
   the CPU in float64 (pose entries within 1e-4), ms a call, one profiled
   call of each (device time, launches); ``entry()`` on
   the card and ``dryrun_multichip(torch.cuda.device_count())`` over NCCL;
13. the offline tools at full width: (a) a synthetic raw ScanNet++ iPhone
   scene (``write_iphone_scene``: a room of boxes ray-cast at 192 x 256,
   200 frames, a raw-deflate depth stream and the poses' JSON) through
   ``tools/scannetpp.py:prepare_scene`` on the card with the reference's
   defaults (500^3 voxels at 6 mm, band 0.2, 4 fragments of 50 frames,
   every candidate pair scored): fragments, points and accepted pairs
   against the JAX package's on the same scene (``JAX_IPHONE``; points
   within ``IPHONE_POINT_TOL``, pairs exactly), the ``gt.log`` poses the
   inverses of the JAX package's log (``jax_gt_log``), the card's volume after 2
   frames against the CPU's at the full grid (``IPHONE_CARD_CPU_FLIPS``),
   ms a frame of ``integrate_frame`` (CUDA events, 50 frames) beside its
   bound by bytes, s a fragment, peak memory; (b) the fragments through
   ``tools/evaluate.py --dataset Scannetpp_iphone`` with the
   ``hard_moments_r4ft2`` weights, on the ``gt.log`` as written and
   inverted into the JAX package's direction (``gt_log_inverted``; ROADMAP
   Queue 3), successes >= the JAX package's on the log of the same
   direction less 1, K1-K3 launches asserted and held against
   their plain versions at one pair's shapes; (c) ``snapshot/hard`` written
   as the reference's ``{Desc,Pose}/best.pth`` (``reference_state_dict``)
   and imported with ``tools/import_reference_checkpoint.py``: every array
   equal to ``snapshot/hard``'s, its bytes once the keys are in pytree
   order, and phase 4b's 4 pairs registered with it (poses equal to phase
   4b's, or within 1e-5 m / 1e-4 degrees; K1 1, K2 1, K4 3, K5 3 a pair);
   (d) ``tools/bench_scaling.py`` at its defaults over the card's one NCCL
   rank (a spawned process): its JSON lines, pairs/s, its launches a run,
   and K1, K2 and K4 against their plain versions at its batch's shapes;
14. the last names of the port: (a) a batch of 4 full-width pairs on the
   moments path, two gravity-aligned (a turn about z) flagged True and two
   not, ``is_aligned`` a [4] tensor, through ``register_pairs_batched``
   with every scale, and the same pairs and draws as an all-True and an
   all-False batch (Python bools): each slot's pose within 1e-4 m / 0.01
   degrees of its flag's batch, the same launches, no synchronizing call
   in the mixed batch, K1-K3 held against their plain versions at its
   shapes (launch path ``mixed_flags``), then ``evaluate_pairs_batched`` on
   the pairs as samples with mixed flags; (b) ``CylindricalUNet`` with
   seeded flax-layout weights (``tools/weights.py:UNET_MODULES``): eval
   mode at 3000 patches in float32 and bf16 against the same module on the
   CPU (its first ``UNET_CPU_PATCHES`` patches: eval mode treats each
   patch alone), 1e-5 and 3e-2 of the largest magnitude, ms a forward and
   peak memory; train mode at 512 patches, forward and every parameter's
   gradient against the CPU within 1e-2 relative L2; (c) ``random_rotation``
   and the point-form ``density_aware_radius`` (phase 4's first cloud, its
   2000 FPS probes) on the card against the CPU.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(HERE, "snapshot", "hard_moments_r4ft2")
SNAPSHOT_SAMPLED = os.path.join(HERE, "snapshot", "hard")
NUM_PAIRS = 4
BATCH = 8                 # pairs a batch in phase 6
NUM_BATCHED_PAIRS = 16
# Successes of the JAX package on the first 4 pairs at full width, on the
# CPU, with its own draws (PRNGKey(i) for pair i): 4 of 4 on both paths with
# all scales, and 4 of 4 on the moments path with scale 0 alone
# (tests/test_torch_serving.py runs that one). Each path here must reach
# that count minus 1.
JAX_SUCCESSES = {"moments": 4, "sampled": 4, "moments_scale0": 4}
# Successes of the JAX package on phase 8's 136 pairs (17 cells x 8), at full
# width on the CPU, with its own draws:
#   python scripts/exp_hard.py --cpu --pairs-per-cell 8 --batch 1 \
#       --checkpoint-dir snapshot/hard_moments_r4ft2
# (batches of 1: a vmapped batch of 8 at full width needs tens of GB on the
# CPU; the pairs are the same, the draws those of its batches of 1). Phase 8
# must reach this count less 6.
JAX_GATE_SUCCESSES = 95
GATE_PAIRS = 8            # pairs a cell in phase 8: one batch
# phase 10: batches in the resident pool, untimed steps before the timed
# ones (one of them under the sync-debug mode), timed steps of each stage,
# and timed sampled-mode Desc steps
TRAIN_POOL = 3
TRAIN_WARMUP = 2
TRAIN_STEPS = 20
TRAIN_SAMPLED_STEPS = 5
# phase 11: hardsynth pairs of the 3DMatch test layout, the gate cells of its
# block-query run, and the training steps a stage of tools/train.py
DATASET_PAIRS = 8
DATASET_GATE_CELLS = (0, 3, 6)
DATASET_TRAIN_STEPS = 3
# Successes of the JAX package on phase 11's 8 pairs, on the CPU, with its
# own draws, one pair at a time:
#   python3 -m bufferx_tpu_torch.tools.hard_layout --out D
#   python scripts/evaluate.py --dataset 3DMatch --root D --cpu \
#       --checkpoint-dir snapshot/hard_moments_r4ft2 [--fast]
# at full width (30208 points, 1500 keypoints, 512-point patches: the fused
# query) and at the --fast capacities (4096 points, 384 keypoints, 192-point
# patches: the flat query). Every tools/evaluate.py run of phase 11 on the
# moments checkpoint must reach the count at its width less 1.
JAX_DATASET_SUCCESSES = {"full": 8, "fast": 8}
# ... and on the sampled checkpoint (snapshot/hard) on the first
# DATASET_SAMPLED_PAIRS pairs at 1024- and 128-point patches:
#   python scripts/evaluate.py --dataset 3DMatch --root D --cpu \
#       --checkpoint-dir snapshot/hard --num-points-per-patch P --max-pairs 2
# (their runs here must reach it less 1)
DATASET_SAMPLED_PAIRS = 2
JAX_DATASET_SAMPLED_SUCCESSES = {1024: 2, 128: 2}
# ... and on the gate cells of the block-query run, sampled checkpoint, with
# the unfused conv backbone (the fused one runs in interpret mode on the CPU):
#   python scripts/exp_hard.py --cpu --desc-mode sampled \
#       --checkpoint-dir snapshot/hard --no-strat --cells 0,3,6 \
#       --pairs-per-cell 8 --batch 1
# (the block-query run here must reach it less 2)
JAX_DATASET_GATE_SUCCESSES = 17


def with_derived(want: dict, chunks: int = 1, per_solve: int = 2) -> dict:
    """``want``, the other kernels' expected launches, with those that
    follow from them. The conv layers' serving epilogue: one launch a conv
    layer of every serving pass of the nets. A moments pass (one moment
    pooling) runs the descriptor net's 11 layers and the cost volume's 10;
    a sampled pass (one cell query) runs the cost volume and, for each
    sub-batch of patches, the stem and the attention head around the fused
    conv stack (3, one conv stack launch each) or, with the cuDNN backbone,
    11 layers (``chunks`` sub-batches a pass). The hypothesis scoring: a
    solve follows every precomputation (one FPS launch), and scores the
    consensus's candidates and, with RANSAC, its hypotheses: ``per_solve``
    launches (1 with GNC)."""
    passes = want.get("cell_query", 0)
    sampled_desc = 3 * want.get("conv_stack", 0) or 11 * chunks * passes
    return dict(want, conv_epilogue=21 * want.get("moments", 0)
                + 10 * passes + sampled_desc,
                hyp_score=per_solve * want.get("fps", 0))


# launches per pair: FPS for both clouds in one launch, the stratified query
# for both clouds and all scales in one launch, then per scale moment pooling
# ("moments"), or the cell query and the fused conv stack ("sampled" with
# fused_conv), the serving epilogue for each conv layer, and the scoring of
# the consensus's candidates and of RANSAC's hypotheses; a batch run
# launches what one pair does, but the conv stack once for each sub-batch
# of patches the descriptor net takes
EXPECTED_PER_PAIR = {
    "moments": with_derived({"fps": 1, "strat": 1, "moments": 3,
                              "cell_query": 0, "conv_stack": 0}),
    "sampled": with_derived({"fps": 1, "strat": 1, "moments": 0,
                              "cell_query": 3, "conv_stack": 3}),
}
# the path whose run gives a kernel's "launches" in the kernels line
PATH_OF = {"fps": "moments", "strat": "moments", "moments": "moments",
           "cell_query": "sampled", "conv_stack": "sampled",
           "conv_epilogue": "moments", "hyp_score": "moments"}
# launches a timing of the serving epilogue (phase 3b)
EPILOGUE_REPS = 10
# published H100 SXM peaks: HBM bytes/s, float32 outside the tensor
# cores and dense bf16 on the tensor cores, flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_TC_PER_S = 989e12


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, ops: float, peak_ops: float = PEAK_F32_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fps_edge_cases():
    """Seeded (name, xyz [B, N, 3] f32, mask [B, N] bool, rounds) for K1.
    N and the valid counts are chosen against the kernel's ownership of
    points (8 blocks x 256 threads per cloud)."""
    rs = np.random.RandomState(11)

    def case(name, n, valid, rounds, grid=False):
        b = len(valid)
        if grid:   # integer coordinates, each point many times: exact ties
            xyz = rs.randint(0, 6, size=(b, n, 3)).astype(np.float32)
        else:
            xyz = (rs.randn(b, n, 3) * [1.0, 2.0, 0.5]).astype(np.float32)
        mask = np.zeros((b, n), bool)
        for i, v in enumerate(valid):
            mask[i, :v] = True
        return name, xyz, mask, rounds

    return [
        case("duplicated grid points", 30208, (30208, 20000), 600, grid=True),
        case("300 valid of 1000, 512 rounds", 1000, (300,), 512),
        case("all padded", 5000, (0, 0), 64),
        case("N = 12345 (not a multiple of 2048)", 12345, (12345, 7, 9000),
             300),
        case("B = 1", 30208, (24000,), 500),
        case("B = 5", 9000, (9000, 1, 4000, 8999, 100), 200),
    ]


def cell_edge_cases(grid_cell_centers):
    """Seeded (name, patches [K, P, 3] f32, mask [K, P] bool, cells [G, 3],
    radius, nsample, ring_len) for K3 and K4, chosen against their design:
    input runs that do and do not qualify for bulk copies (P a multiple of
    16 or not), output runs likewise, ring batches (P = 3072, no ring
    length), lists that are empty, full, or decided at the boundary."""
    rs = np.random.RandomState(13)
    grid = grid_cell_centers(3, 7, 20)
    r = 0.8 / 3

    def ball(k, p):
        v = rs.randn(k, p, 3)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        return (v * rs.uniform(0, 1, (k, p, 1)) ** (1 / 3)).astype(np.float32)

    def valid(k, p, share=0.9):
        return rs.uniform(size=(k, p)) < share

    # at distance r, nextafter(r, 0), nextafter(r, inf) from cell centres
    r32 = np.float32(r)
    dists = np.array([r32, np.nextafter(r32, np.float32(0)),
                      np.nextafter(r32, np.float32(np.inf))], np.float64)
    u = rs.randn(4, 420, 2, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    u[0] = np.eye(3)[None, [0, 2]]             # along x and z
    boundary = (grid[None, :, None, None, :].astype(np.float64)
                + u[:, :, :, None, :] * dists[None, None, None, :, None])
    boundary = boundary.reshape(4, 420 * 6, 3).astype(np.float32)
    zs = rs.uniform(-1, 1, (3, 512)).astype(np.float32)
    axis = np.stack([np.zeros_like(zs), np.zeros_like(zs), zs], -1)
    axis[1, :, 0] = 1e-30
    axis[2, :, 1] = -1e-7
    cluster = (grid[rs.randint(0, 420, 6)][:, None, :]
               + ball(6, 512) * r * 0.9).astype(np.float32)
    tiny = grid_cell_centers(2, 3, 5)
    return [
        ("P = 100", ball(7, 100), valid(7, 100), grid, r, 10, 20),
        ("P = 101 (runs not 16-byte multiples)", ball(5, 101), valid(5, 101),
         grid, r, 10, 20),
        ("P = 3072", ball(5, 3072), valid(5, 3072), grid, r, 10, 20),
        ("all points masked", ball(4, 512), np.zeros((4, 512), bool), grid,
         r, 10, 20),
        ("every point inside one cell", cluster, valid(6, 512), grid, r, 10,
         20),
        ("points at r and one ulp either side", boundary,
         np.ones(boundary.shape[:2], bool), grid, r, 10, 20),
        ("points on the z axis", axis, np.ones((3, 512), bool), grid, r, 10,
         20),
        ("1x1x1 grid", ball(9, 512), valid(9, 512), grid_cell_centers(1, 1, 1),
         0.8, 10, 1),
        ("2x3x5 grid", ball(9, 512), valid(9, 512), tiny, 0.4, 10, 5),
        ("2x3x5 grid, nsample 3 (output runs not 16-byte multiples)",
         ball(9, 256), valid(9, 256), tiny, 0.4, 3, 5),
        ("nsample 32", ball(6, 512), valid(6, 512), grid, r, 32, 20),
        ("K = 1", ball(1, 512), valid(1, 512), grid, r, 10, 20),
        ("K = 3001", ball(3001, 64), valid(3001, 64), grid, r, 10, 20),
        ("no ring length given", ball(40, 512), valid(40, 512), grid, r, 10,
         None),
    ]


def run_path(torch, reg, se3, cuda_build, name, cfg, models, pairs,
             poses=None):
    """One warm-up, then ``register_pair`` on every pair with the launch
    counts set to 0 just before and read just after; asserts the launches
    per pair, finite poses and the success count. Returns the counts, and
    appends each pose to ``poses`` when given."""
    gen = torch.Generator()
    dev = pairs[0][2].device
    reg.register_pair(cfg, pairs[0][0], pairs[0][1], models,
                      generator=gen.manual_seed(100), device=dev)
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    per_pair = []
    for i, (src, tgt, T) in enumerate(pairs):
        before = {n: kk.launches for n, kk in cuda_build.KERNELS.items()}
        t0 = time.perf_counter()
        res = reg.register_pair(cfg, src, tgt, models,
                                generator=gen.manual_seed(i), device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for kname, want_n in EXPECTED_PER_PAIR[name].items():
            got_n = cuda_build.KERNELS[kname].launches - before[kname]
            if got_n != want_n:
                raise AssertionError(f"{name} pair {i}: {kname} launched "
                                     f"{got_n} times, expected {want_n}")
        pose = res.pose
        if poses is not None:
            poses.append(pose.clone())
        if pose.shape != (4, 4) or not bool(torch.isfinite(pose).all()):
            raise AssertionError(f"{name} pair {i}: pose not a finite 4x4: "
                                 f"{pose}")
        rte = float(se3.compute_rte(pose, T))
        rre = float(se3.compute_rre(pose, T))
        ok = rte < cfg.test.rte_thresh and rre < cfg.test.rre_thresh
        per_pair.append(dict(ms=ms, success=ok))
        log(f"{name} pair {i}: {ms:.1f} ms, RTE {rte:.4f} m, RRE {rre:.3f} "
            f"deg, success {ok}, inliers {int(res.num_inliers)}, mutual "
            f"{int(res.num_mutual)}")
    launches = {n: kk.launches for n, kk in cuda_build.KERNELS.items()}
    successes = sum(p["success"] for p in per_pair)
    log(f"{name} path: {successes}/{len(pairs)} successes, median "
        f"{float(np.median([p['ms'] for p in per_pair])):.1f} ms/pair, "
        f"launches {launches}")
    if successes < JAX_SUCCESSES[name] - 1:
        raise AssertionError(f"{name}: {successes} successes < JAX package's "
                             f"{JAX_SUCCESSES[name]} - 1")
    return launches


def pose_errors(se3, cfg, pose, T):
    """(RTE m, RRE degrees, success against the configuration's thresholds)."""
    rte = float(se3.compute_rte(pose, T))
    rre = float(se3.compute_rre(pose, T))
    return rte, rre, rte < cfg.test.rte_thresh and rre < cfg.test.rre_thresh


def run_batched(torch, reg, se3, cuda_build, label, cfg, models, pairs,
                batch_size, per_scale_kernels, reference=None):
    """``register_pairs_batched`` over ``pairs`` after a warm-up batch, with
    seeded draws; asserts the launches (a batch run launches FPS and the
    stratified query once and each of ``per_scale_kernels``, a dict of name
    -> launches a scale for a batch run of that many pairs, that often),
    finite poses, and, with ``reference(i, src, tgt, draws0, draws1) ->
    pose``, every pair's pose within 0.02 m / 2 degrees of the reference
    with the same draws (``draws0``: the pair's phase-1 draws; ``draws1``:
    the phase-2 draws of its slot in its batch's redo batch). Returns a dict
    of what it measured."""
    statics = reg.PipelineStatics.from_config(cfg)
    dev = pairs[0][2].device
    srcs, tgts = [p[0] for p in pairs], [p[1] for p in pairs]
    gen = torch.Generator().manual_seed(1000)
    batches = [list(range(i, min(i + batch_size, len(pairs))))
               for i in range(0, len(pairs), batch_size)]
    draws = [tuple(reg.make_draws(statics, gen, dev, batch=len(idx))
                   for _phase in range(2)) for idx in batches]
    reg.register_pairs_batched(cfg, srcs[:batch_size], tgts[:batch_size],
                               models, batch_size=batch_size,
                               draws=draws[:1], device=dev)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    out = reg.register_pairs_batched(cfg, srcs, tgts, models,
                                     batch_size=batch_size, draws=draws,
                                     device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: kk.launches for n, kk in cuda_build.KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    scales_used = [int(r.scales_used) for r in out]
    num_scales = statics.num_scales
    redone = [[i for i in idx if scales_used[i] == num_scales]
              for idx in batches]
    redo_batches = sum(1 for r in redone if r)
    want = {n: 0 for n in launches}
    want["fps"] = want["strat"] = len(batches) + redo_batches
    for n, per_scale in per_scale_kernels.items():
        want[n] = sum(per_scale(len(idx)) for idx in batches) + \
            num_scales * sum(per_scale(len(r)) for r in redone if r)
    want = with_derived(want)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want} "
                             f"({len(batches)} batches, {redo_batches} redone)")
    successes, worst = [], (0.0, 0.0)
    for i, (r, (src, tgt, T)) in enumerate(zip(out, pairs)):
        if r.pose.shape != (4, 4) or not bool(torch.isfinite(r.pose).all()):
            raise AssertionError(f"{label} pair {i}: pose not a finite 4x4")
        rte, rre, ok = pose_errors(se3, cfg, r.pose, T)
        successes.append(ok)
        line = (f"{label} pair {i}: scales {scales_used[i]}, RTE {rte:.4f} m, "
                f"RRE {rre:.3f} deg, success {ok}, inliers "
                f"{int(r.num_inliers)}, mutual {int(r.num_mutual)}")
        if reference is not None:
            k, j = divmod(i, batch_size)
            slot = redone[k].index(i) if i in redone[k] else j
            ref = reference(i, src, tgt,
                            reg.Draws(*(x[j] for x in draws[k][0])),
                            reg.Draws(*(x[slot] for x in draws[k][1])))
            d_rte = float(se3.compute_rte(r.pose, ref))
            d_rre = float(se3.compute_rre(r.pose, ref))
            _, _, ref_ok = pose_errors(se3, cfg, ref, T)
            worst = (max(worst[0], d_rte), max(worst[1], d_rre))
            line += (f"; against the single-pair path {d_rte:.2e} m, "
                     f"{d_rre:.3f} deg")
            if d_rte > 0.02 or d_rre > 2.0:
                raise AssertionError(f"{label} pair {i}: batched and "
                                     f"single-pair poses disagree: {line}")
            if ref_ok and not ok:
                raise AssertionError(f"{label} pair {i}: the batch loses a "
                                     "pair the single-pair path registers")
        log(line)
    hist = {k: scales_used.count(k) for k in sorted(set(scales_used))}
    log(f"{label}: {len(pairs)} pairs in {seconds * 1e3:.1f} ms, "
        f"{len(pairs) / seconds:.2f} pairs/s, {seconds / len(pairs) * 1e3:.1f}"
        f" ms/pair, scales_used {hist}, successes {sum(successes)}/"
        f"{len(pairs)} (first 4: {sum(successes[:4])}/4), peak memory "
        f"{peak_gb:.2f} GB, launches {launches}, worst against the "
        f"single-pair path {worst[0]:.2e} m / {worst[1]:.3f} deg, redo "
        f"batches of {[len(r) for r in redone if r]} pairs")
    return dict(label=label, pairs_per_s=len(pairs) / seconds,
                inliers=[int(r.num_inliers) for r in out],
                redo_batch_sizes=[len(r) for r in redone if r],
                ms_per_pair=seconds / len(pairs) * 1e3, scales_used=hist,
                successes=sum(successes), successes_first4=sum(successes[:4]),
                peak_memory_gb=peak_gb, launches=launches,
                worst_vs_single_m=worst[0], worst_vs_single_deg=worst[1])


def run_gate(torch, reg, cuda_build, models, dev):
    """Phase 8. Returns (launches of the gate run, what it measured)."""
    from bufferx_tpu_torch.tools import exp_hard

    cfg = exp_hard.gate_config("moments", SNAPSHOT)
    statics = reg.PipelineStatics.from_config(cfg)
    if not (statics.clutter_filter and statics.pose_refine):
        raise AssertionError("the gate configuration lost its prefilter or "
                             "IRLS")
    cells = exp_hard.build_cells(False)
    kw = dict(pairs_per_cell=GATE_PAIRS, num_points=24000, batch=BATCH,
              voxel=0.025, seed=20240)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    rows = [exp_hard.run_cell(cfg, models, cell, ci, device=dev, **kw)
            for ci, cell in enumerate(cells)]
    seconds = time.perf_counter() - t0
    launches = {n: kk.launches for n, kk in cuda_build.KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for ci, row in enumerate(rows):
        log(f"gate cell {ci} {cells[ci]}: recall {row['recall']:.3f} "
            f"({sum(row['successes'])}/{row['n']}), RTE median "
            f"{row['rte_med']:.4f} m, {row['pairs_per_s']:.2f} pairs/s")
    n_batches = len(cells) * -(-GATE_PAIRS // BATCH)
    want = {n: 0 for n in launches}
    want.update(fps=n_batches, strat=n_batches,
                moments=n_batches * statics.num_scales)
    want = with_derived(want)
    if launches != want:
        raise AssertionError(f"gate: launches {launches}, expected {want}")
    successes = sum(sum(r["successes"]) for r in rows)
    pairs = sum(r["n"] for r in rows)
    reg_s = sum(r["n"] / r["pairs_per_s"] for r in rows)
    log(f"gate: {successes}/{pairs} successes (JAX package "
        f"{JAX_GATE_SUCCESSES}), mean recall "
        f"{np.mean([r['recall'] for r in rows]):.4f}, {pairs / reg_s:.2f} "
        f"pairs/s of registration ({pairs / seconds:.2f} with the host's "
        f"pair synthesis), peak memory {peak_gb:.2f} GB, launches "
        f"{launches}")
    if successes < JAX_GATE_SUCCESSES - 6:
        raise AssertionError(f"gate: {successes} successes < the JAX "
                             f"package's {JAX_GATE_SUCCESSES} - 6")
    for r in rows:
        r.pop("successes")
    return launches, dict(
        rows=rows, successes=successes, pairs=pairs,
        jax_successes=JAX_GATE_SUCCESSES,
        mean_recall=float(np.mean([r["recall"] for r in rows])),
        pairs_per_s_registration=pairs / reg_s,
        pairs_per_s_with_synthesis=pairs / seconds, peak_memory_gb=peak_gb,
        filter=check_gate_filter(torch, reg, models, dev, cfg, cells, kw))


def sync_calls(torch, fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``: every
    call that makes the host wait for the card warns (a host-to-device copy
    does too). Returns the place (file:line) of each such call."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
            for w in caught if "called a synchronizing" in str(w.message)]


def check_gate_filter(torch, reg, models, dev, cfg, cells, kw):
    """The prefilter on the card against the same ops on the CPU, on the 16
    clouds of the 20%-clutter cell's batch, timed; then that batch through
    all scales under the sync-debug mode."""
    from bufferx_tpu_torch.kernels.density import density_inlier_mask
    from bufferx_tpu_torch.tools import exp_hard
    from bufferx_tpu_torch.tools.bench_strat import time_ms

    statics = reg.PipelineStatics.from_config(cfg)
    ci = len(cells) - 1
    pairs8 = exp_hard.cell_pairs(cells[ci], ci, BATCH, kw["num_points"],
                                 kw["voxel"], kw["seed"])
    src8 = reg.stack_clouds([reg.prepare_cloud(p[0], cfg, seed=i, device=dev)
                             for i, p in enumerate(pairs8)])
    tgt8 = reg.stack_clouds([reg.prepare_cloud(p[1], cfg, seed=i + 1,
                                               device=dev)
                             for i, p in enumerate(pairs8)])
    xyz = torch.cat([src8.xyz, tgt8.xyz])
    mask = torch.cat([src8.mask, tgt8.mask])
    got = density_inlier_mask(xyz, mask)
    want_m = density_inlier_mask(xyz.cpu(), mask.cpu())
    torch.cuda.synchronize()
    flips = int((got.cpu() != want_m).sum())
    valid = int(mask.sum())
    removed = int((mask & ~got).sum())
    torch.cuda.synchronize()
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    filter_ms = time_ms(lambda: density_inlier_mask(xyz, mask), 5)
    above_gb = torch.cuda.max_memory_allocated() / 1e9 - before_gb
    log(f"clutter filter, {xyz.shape[0]} clouds of {xyz.shape[1]} slots: "
        f"{flips} of {valid} valid slots flip against the plain version on "
        f"the CPU; removes {removed}; {filter_ms:.3f} ms a batch; "
        f"{above_gb:.2f} GB above the memory allocated before it")
    if flips > 0.01 * valid:
        raise AssertionError("clutter filter: the card and the CPU disagree "
                             "on more than 1% of the slots")

    # that batch through all scales under the sync-debug mode
    draws8 = reg.make_draws(statics, torch.Generator().manual_seed(5), dev,
                            batch=BATCH)
    scales = tuple(range(statics.num_scales))
    reg._register_batch(models, statics, src8, tgt8, draws8, scales, False)
    syncs = sync_calls(torch, lambda: reg._register_batch(
        models, statics, src8, tgt8, draws8, scales, False))
    log(f"gate batch of {BATCH} pairs, all scales, prefilter and IRLS, under "
        f"sync-debug mode: {len(syncs)} synchronizing calls "
        f"{sorted(set(syncs))}")
    if syncs:
        raise AssertionError("a gate batch makes the host wait for the card")
    return dict(clouds=int(xyz.shape[0]), flips=flips, valid=valid,
                removed=removed, ms=filter_ms, memory_above_before_gb=above_gb)


def run_harness(torch, reg, models, dev):
    """Phase 9: both harness functions on hard pairs, every pose against
    ``register_batch`` with the same clouds and draws."""
    from bufferx_tpu_torch.core import se3
    from bufferx_tpu_torch.eval.harness import (
        evaluate_pairs,
        evaluate_pairs_batched,
    )
    from bufferx_tpu_torch.tools import exp_hard

    cfg = exp_hard.gate_config("moments", SNAPSHOT)
    statics = reg.PipelineStatics.from_config(cfg)
    cell = exp_hard.build_cells(False)[7]        # overlap 0.75, half-voxel
    samples = [dict(src_points=s, tgt_points=t, relt_pose=T, src_id=f"s{i}",
                    tgt_id=f"t{i}", is_aligned_to_global_z=False)
               for i, (s, t, T) in enumerate(exp_hard.cell_pairs(
                   cell, 7, 2 * BATCH, 24000, 0.025, 20240))]
    out_dir = os.path.join(HERE, "chiprun_out", "harness")
    gen = torch.Generator().manual_seed(9)
    seq_draws = [reg.make_draws(statics, gen, dev) for _ in range(4)]
    batch_draws = [reg.make_draws(statics, gen, dev, batch=BATCH)
                   for _ in range(2)]

    def reference(idx, draws):
        srcs = [reg.prepare_cloud(samples[i]["src_points"], cfg, seed=2 * i,
                                  device=dev) for i in idx]
        tgts = [reg.prepare_cloud(samples[i]["tgt_points"], cfg,
                                  seed=2 * i + 1, device=dev) for i in idx]
        return reg.register_batch(cfg, srcs, tgts, models, draws=draws,
                                  device=dev).pose

    def check(label, summary, refs):
        worst = 0.0
        for row, ref in zip(summary["rows"], refs):
            worst = max(worst, float(se3.compute_rte(
                torch.as_tensor(row["pose"], device=dev), ref)))
        log(f"harness, {label}: recall {summary['recall']:.3f} over "
            f"{summary['num_pairs']} pairs, model time "
            f"{summary['model_time_mean'] * 1e3:.1f} ms a pair"
            + (f", {summary['pairs_per_second']:.2f} pairs/s"
               if "pairs_per_second" in summary else "")
            + f"; poses within {worst:.2e} m of register_batch's")
        if worst > 1e-5:
            raise AssertionError(f"harness, {label}: a pose differs from "
                                 "register_batch's by more than 1e-5 m")
        return dict(recall=summary["recall"], num_pairs=summary["num_pairs"],
                    model_time_mean_s=summary["model_time_mean"],
                    pairs_per_second=summary.get("pairs_per_second"),
                    worst_vs_register_batch_m=worst)

    refs = [reference([i], reg.stack_draws([d]))
            for i, d in enumerate(seq_draws)]
    out = {}
    for timing in (False, True):
        summary = evaluate_pairs(
            cfg, samples[:4], models, enable_timing=timing,
            csv_path=os.path.join(out_dir, f"pairs_timing{int(timing)}.csv"),
            draws=seq_draws, device=dev)
        out[f"evaluate_pairs, timing {timing}"] = check(
            f"evaluate_pairs, timing {timing}", summary, refs)
        if timing and not all(r["desc_time"] > 0 and r["pose_optim_time"] > 0
                              for r in summary["rows"]):
            raise AssertionError("harness: a timed phase took no time")
    summary = evaluate_pairs_batched(
        cfg, samples, models, batch_size=BATCH,
        csv_path=os.path.join(out_dir, "batched.csv"), draws=batch_draws,
        device=dev)
    refs = torch.cat([reference(range(b * BATCH, (b + 1) * BATCH), d)
                      for b, d in enumerate(batch_draws)])
    out["evaluate_pairs_batched"] = check("evaluate_pairs_batched, B = 8",
                                          summary, refs)
    return out


def _rel_l2(ref: dict, got: dict, keys, base=None) -> float:
    num = sum(float(((ref[k] - got[k]).double() ** 2).sum()) for k in keys)
    den = sum(float(((ref[k] - (0 if base is None else base[k])).double()
                     ** 2).sum()) for k in keys)
    return (num / max(den, 1e-30)) ** 0.5


def run_training(torch, cuda_build, reg, se3, make_cfg, dev, serve_pair):
    """Phase 10: training on the card (see the module notes). Returns
    (launches of the moments run, launches of the sampled run, what it
    measured, kernel entries at training shapes)."""
    import tempfile

    from bufferx_tpu_torch.data.hardsynth import hard_training_stream
    from bufferx_tpu_torch.data.training import (
        pool_batch,
        stack_batches,
        to_device,
    )
    from bufferx_tpu_torch.models.layers import ConvBNRelu
    from bufferx_tpu_torch.tools.train_synthetic import training_config
    from bufferx_tpu_torch.tools.weights import (
        load_snapshot,
        load_snapshot_config,
        save_snapshot,
    )
    from bufferx_tpu_torch.train import forward as tf
    from bufferx_tpu_torch.train import trainer as tt

    t_phase = time.perf_counter()
    cfg = training_config("moments")            # hard_moments_r4ft2's
    cfg_s = training_config("sampled")          # snapshot/hard's
    st, st_s = tf.TrainStatics.from_config(cfg), tf.TrainStatics.from_config(
        cfg_s)
    n_pts = cfg.capacity.max_points
    host = list(hard_training_stream(cfg, TRAIN_POOL, seed=7, num_points=4000,
                                     host_arrays=True))
    pool = stack_batches(host, dev)
    gen = torch.Generator(dev).manual_seed(1)
    log(f"training: {TRAIN_POOL} hard_training_stream batches, "
        f"{[int(b['corr_valid'].sum()) for b in host]} valid "
        f"correspondences of {cfg.train.pos_num}, "
        f"{[int(b['src_fds_mask'].sum()) for b in host]} source points of "
        f"{n_pts}")

    # -- K3 and K4 against their plain versions on the training patches --
    b0 = pool_batch(pool, 0)
    dr0 = tf.make_train_draws(st, n_pts, gen, dev)
    aligned, pmask, _R, _a, _aug = tf.training_patches(
        st, b0["src_fds"], b0["src_fds_mask"], b0["src_kpt"], b0["des_r"],
        b0["is_aligned"], dr0.off_src)
    entries = k3_k4_entries(torch, aligned, pmask, st, "training",
                            ("training", "training_sampled"))

    # -- one Desc and one Pose step on the card and on the CPU --
    sd = load_snapshot(SNAPSHOT)
    host_b = host[0]
    cpu_draws = tf.make_train_draws(st, n_pts, torch.Generator().manual_seed(3),
                                    "cpu")
    steps = {}
    for label, d in (("cpu", torch.device("cpu")), ("card", dev)):
        batch = to_device(host_b, d)
        draws = tf.TrainDraws(*(x.to(d) for x in cpu_draws))
        desc, pose = tt.train_models(cfg, sd, d)
        out = {}
        for stage, model in (("Desc", desc), ("Pose", pose)):
            if stage == "Desc":
                loss, _ = tf.desc_stage_loss(desc, st, batch, draws)
            else:
                loss, _ = tf.pose_stage_loss(pose, desc, st, batch, draws)
            params = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, list(params.values()))
            gnorm = torch.sqrt(sum(torch.sum(x * x) for x in grads))
            before = {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}
            opt = tt.make_optimizer(cfg, stage, 100)
            step = tt.make_train_step(cfg, stage, opt)
            state = opt.init(params)
            if stage == "Desc":
                _, m = step(model, state, batch, draws)
            else:
                _, m = step(model, state, desc, batch, draws)
            out[stage] = dict(
                loss=float(loss.detach()), gnorm=float(gnorm),
                ok=bool(m["grads_finite"]),
                before=before,
                after={k: v.detach().cpu() for k, v in model.state_dict().items()},
                dead={f"{n}.bias" for n, mm in model.named_modules()
                      if isinstance(mm, ConvBNRelu) and mm.use_bn},
                lr=opt.lr)
        steps[label] = out
    agree = {}
    for stage in ("Desc", "Pose"):
        c, k = steps["cpu"][stage], steps["card"][stage]
        keys = list(c["after"])
        stats = [x for x in keys if x.endswith(("bn_mean", "bn_var"))]
        live = [x for x in keys if x not in stats and x not in c["dead"]]
        diff = torch.cat([(c["after"][x] - k["after"][x]).abs().flatten()
                          for x in live])
        a = dict(
            loss_rel=abs(k["loss"] - c["loss"]) / abs(c["loss"]),
            grad_norm_rel=abs(k["gnorm"] - c["gnorm"]) / c["gnorm"],
            step_rel_l2=_rel_l2(c["after"], k["after"], live, c["before"]),
            step_differs_share=float((diff > 1e-3 * c["lr"]).float().mean()),
            step_max_over_lr=float(diff.max()) / c["lr"],
            stats_rel_l2=_rel_l2(c["after"], k["after"], stats),
        )
        log(f"training {stage} step, card vs CPU: loss {k['loss']:.6f} / "
            f"{c['loss']:.6f}, grad norm {k['gnorm']:.6f} / {c['gnorm']:.6f}, "
            + ", ".join(f"{n} {v:.3e}" for n, v in a.items()))
        if not (k["ok"] and c["ok"]) or a["loss_rel"] > 1e-4 or \
                a["grad_norm_rel"] > 1e-2 or \
                a["step_differs_share"] > 0.02 or \
                a["step_max_over_lr"] > 2.0 + 1e-3 or a["stats_rel_l2"] > 1e-3:
            raise AssertionError(f"training {stage}: card and CPU steps "
                                 f"disagree: {a}")
        agree[stage] = a
    del steps

    # -- ~20 Desc then ~20 Pose steps, moments mode, from hard_moments_r4ft2 --
    desc, pose = tt.train_models(cfg, sd, dev)

    def run_stage(stage, model, frozen, stage_cfg, n_steps, count_kernel):
        statics = tf.TrainStatics.from_config(stage_cfg)
        opt = tt.make_optimizer(stage_cfg, stage, 100)
        step_fn = tt.make_train_step(stage_cfg, stage, opt)
        state = [opt.init(dict(model.named_parameters()))]
        metrics = []

        def one(i):
            batch = pool_batch(pool, i % TRAIN_POOL)
            draws = tf.make_train_draws(statics, n_pts, gen, dev)
            args = (batch, draws) if frozen is None else (frozen, batch, draws)
            state[0], m = step_fn(model, state[0], *args)
            metrics.append(m)

        for i in range(TRAIN_WARMUP):
            one(i)
        syncs = sync_calls(torch, lambda: one(TRAIN_WARMUP))
        if syncs:
            raise AssertionError(f"training {stage}: a step waits for the "
                                 f"card at {sorted(set(syncs))}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        cuda_build.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n_steps):
            one(TRAIN_WARMUP + 1 + i)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / n_steps
        launches = {n: kk.launches for n, kk in cuda_build.KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        above = peak - held / 1e9
        read = {k: torch.stack([m[k].float() for m in metrics]).cpu()
                for k in metrics[0]}
        if not bool(torch.isfinite(read["loss"]).all()) or \
                not bool((read["grads_finite"] == 1).all()):
            raise AssertionError(f"training {stage}: non-finite loss or a "
                                 f"rejected step: {read}")
        per_step = launches[count_kernel] / n_steps
        if per_step != 2:
            raise AssertionError(f"training {stage}: {count_kernel} launched "
                                 f"{per_step} times a step, expected 2")
        others = {n: c for n, c in launches.items()
                  if c and n != count_kernel}
        if others:
            raise AssertionError(f"training {stage}: other kernels launched: "
                                 f"{others}")
        losses = read["loss"].tolist()
        log(f"training {stage} ({statics.desc_mode}): {n_steps} steps, "
            f"{ms:.3f} ms a step, peak memory {peak:.3f} GB ({above:.3f} "
            "above what the smoke held before the steps), "
            f"{count_kernel} {per_step:g} launches a step, loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        return launches, dict(steps=n_steps, ms_per_step=ms,
                              peak_memory_gb=peak,
                              peak_above_held_gb=above,
                              launches_per_step=per_step,
                              loss_first=losses[0], loss_last=losses[-1],
                              sync_calls=len(syncs))

    launches_d, desc_m = run_stage("Desc", desc, None, cfg, TRAIN_STEPS,
                                   "moments")
    launches_p, pose_m = run_stage("Pose", pose, desc, cfg, TRAIN_STEPS,
                                   "moments")

    # -- a few sampled-mode Desc steps from snapshot/hard: K4 on the path --
    desc_s, _ = tt.train_models(cfg_s, load_snapshot(SNAPSHOT_SAMPLED), dev)
    launches_s, sampled_m = run_stage("Desc", desc_s, None, cfg_s,
                                      TRAIN_SAMPLED_STEPS, "cell_query")

    # -- train -> save -> serve --
    tmp = tempfile.mkdtemp(prefix="bx_train_")
    try:
        save_snapshot(tmp, {"desc": desc.state_dict(),
                            "pose": pose.state_dict()}, cfg)
        knobs = load_snapshot_config(tmp)
        serve_cfg = make_cfg("ModelNet40").override(patch=knobs)
        statics = reg.PipelineStatics.from_config(serve_cfg)
        models = reg.build_models(statics, load_snapshot(tmp), dev)
        src, tgt, T = serve_pair
        res = reg.register_pair(serve_cfg, src, tgt, models,
                                generator=torch.Generator().manual_seed(0),
                                device=dev)
        rte, rre, ok = pose_errors(se3, serve_cfg, res.pose, T)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"training: snapshot written and served: config {knobs}, RTE "
        f"{rte:.4f} m, RRE {rre:.3f} deg, success {ok}, valid "
        f"{bool(res.valid)}")
    if not (bool(torch.isfinite(res.pose).all()) and bool(res.valid)):
        raise AssertionError("training: the port-written snapshot did not "
                             "serve the pair")
    seconds = time.perf_counter() - t_phase
    log(f"training phase: {seconds:.1f} s")
    launches = {n: launches_d[n] + launches_p[n] for n in launches_d}
    return launches, launches_s, dict(
        card_vs_cpu=agree, desc=desc_m, pose=pose_m, sampled_desc=sampled_m,
        served=dict(rte=rte, rre=rre, success=ok), seconds=seconds), entries


def k3_k4_entries(torch, normed, pmask, statics, case, paths):
    """K3 and K4 against their plain versions on ``normed``/``pmask``
    (normalized aligned patches): moment counts exact and sums within
    1e-4 + 1e-5 |p|, cell-query slots bit-exact; both timed beside their
    bounds. ``paths``: the launch paths of the two entries."""
    from bufferx_tpu_torch.geometry import spt_pallas
    from bufferx_tpu_torch.geometry.cylindrical import grid_cells_on
    from bufferx_tpu_torch.tools.bench_strat import time_ms

    dev = normed.device
    normed, pmask = normed.contiguous(), pmask.contiguous()
    cells = grid_cells_on(statics.rad_n, statics.ele_n, statics.azi_n, dev)
    radius = statics.delta / statics.rad_n
    r2, azi, ns = radius * radius, statics.azi_n, statics.voxel_sample
    got = spt_pallas.spt_moments_cuda(normed, pmask, cells, r2, ring_len=azi)
    want = spt_pallas.spt_moments_plain(normed, pmask, cells, r2)
    got4 = spt_pallas.spt_cell_query_cuda(normed, pmask, cells, radius, ns,
                                          ring_len=azi)
    want4 = spt_pallas.spt_cell_query_plain(normed, pmask, cells, radius, ns)
    torch.cuda.synchronize()
    if not torch.equal(got[:, 9], want[:, 9]):
        raise AssertionError(f"moments, {case}: counts differ from the plain "
                             "version")
    err = (got - want).abs()
    if bool((err > 1e-4 + 1e-5 * want.abs()).any()):
        raise AssertionError(f"moments, {case}: sums off by up to "
                             f"{float(err.max())}")
    if not torch.equal(got4, want4):
        raise AssertionError(f"cell_query, {case}: "
                             f"{int((got4 != want4).any(-1).sum())} slots "
                             "differ from the plain version")
    kept = int(spt_pallas.ring_candidate_counts_cuda(
        normed, pmask, cells, radius, azi).sum()) * azi
    kq, p = pmask.shape
    g = cells.shape[0]
    cull_ops = 4.0 * float(pmask.sum()) + 6.0 * kq * p * (g // azi) \
        + 9.0 * kept
    hits = float(want[:, 9].sum())

    def cdist_bmm():
        ok = (torch.cdist(cells[None].expand(kq, -1, -1), normed)
              <= radius).to(torch.float32)
        return torch.bmm(ok, spt_pallas.point_moment_features(
            normed, pmask)).transpose(1, 2)

    shapes = f"patches {list(normed.shape)} ({case})"
    entries = [
        dict(name="moments", case=case, path=paths[0],
             match="counts exact, sums within 1e-4 + 1e-5|p|",
             max_abs_err=float(err.max()),
             ms=time_ms(lambda: spt_pallas.spt_moments_cuda(
                 normed, pmask, cells, r2, ring_len=azi), 10),
             plain_ms=time_ms(lambda: spt_pallas.spt_moments_plain(
                 normed, pmask, cells, r2), 3),
             library_ms=time_ms(cdist_bmm, 3),
             bound=bound_ms(kq * p * 13 + g * 12 + kq * 10 * g * 4,
                            cull_ops + 16.0 * hits),
             shapes=shapes + f" -> {list(got.shape)}"),
        dict(name="cell_query", case=case, path=paths[1],
             match="bit-exact", max_abs_err=0.0,
             ms=time_ms(lambda: spt_pallas.spt_cell_query_cuda(
                 normed, pmask, cells, radius, ns, ring_len=azi), 10),
             plain_ms=time_ms(lambda: spt_pallas.spt_cell_query_plain(
                 normed, pmask, cells, radius, ns), 3),
             library_ms=None,
             bound=bound_ms(kq * p * 13 + g * 12 + got4.numel() * 4,
                            cull_ops),
             shapes=shapes + f" -> {list(got4.shape)}"),
    ]
    for e in entries:
        log(f"{e['name']}, {case}: {e['shapes']} matches the plain version; "
            f"kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.3f} ms, library "
            f"{e['library_ms']}, bound {e['bound'][0]:.4f} ms "
            f"({e['bound'][1]})")
    return entries


def run_dataset_path(torch, cuda_build, reg, se3, dev):
    """Phase 11: the dataset entry points at full width (see the module
    notes). Returns (launches by run, what it measured, kernel entries)."""
    import shutil
    import tempfile

    from bufferx_tpu_torch.config import make_cfg
    from bufferx_tpu_torch.data.datasets import get_dataset
    from bufferx_tpu_torch.geometry.lrf import align_patches
    from bufferx_tpu_torch.kernels.neighbors import (
        ball_query_blocks,
        ball_query_stratified,
    )
    from bufferx_tpu_torch.geometry.patches import select_patches
    from bufferx_tpu_torch.kernels.strat_pallas import (
        ball_query_stratified_multi,
    )
    from bufferx_tpu_torch.tools import evaluate as tev
    from bufferx_tpu_torch.tools import exp_hard, hard_layout
    from bufferx_tpu_torch.tools import train as ttrain
    from bufferx_tpu_torch.tools.bench_strat import time_ms
    from bufferx_tpu_torch.tools.weights import (
        load_snapshot,
        load_snapshot_config,
    )
    from bufferx_tpu_torch.train import trainer as tt

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="bufferx_dataset_")
    out_dir = os.path.join(HERE, "chiprun_out", "dataset")
    launches, measured, entries = {}, {}, []
    try:
        t0 = time.perf_counter()
        scene = hard_layout.write_test_scene(root, DATASET_PAIRS)
        hard_layout.write_train_manifest(root, pairs=DATASET_TRAIN_STEPS)
        log(f"dataset: 3DMatch layout of {DATASET_PAIRS} hardsynth pairs "
            f"(scene {scene}) and a training manifest written in "
            f"{time.perf_counter() - t0:.1f} s")

        # ---- (a), (b): tools/evaluate.py on the layout ------------------
        n, ns = DATASET_PAIRS, DATASET_SAMPLED_PAIRS
        moments = dict(fps=n, strat=0, moments=3 * n)
        full, fast = (JAX_DATASET_SUCCESSES[k] for k in ("full", "fast"))
        runs = {   # run -> (checkpoint, flags, expected launches, JAX count)
            "fused": (SNAPSHOT, [], dict(moments, strat=n), full),
            "fused_batched": (SNAPSHOT, ["--batched", str(n)],
                              dict(fps=2, strat=2, moments=6), full),
            "fast_flat": (SNAPSHOT, ["--fast"], moments, fast),
            "p1024_flat": (SNAPSHOT, ["--num-points-per-patch", "1024"],
                           moments, full),
            "p128_strat1": (SNAPSHOT, ["--num-points-per-patch", "128"],
                            moments, full),
        }
        for p in (1024, 128):
            runs[f"p{p}_sampled"] = (
                SNAPSHOT_SAMPLED, ["--num-points-per-patch", str(p),
                                   "--max-pairs", str(ns)],
                dict(fps=ns, cell_query=3 * ns),
                JAX_DATASET_SAMPLED_SUCCESSES[p])
        cli = {}
        for label, (snap, flags, want, jax_count) in runs.items():
            cuda_build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = tev.run(["--dataset", "3DMatch", "--root", root,
                               "--checkpoint-dir", snap, "--out-dir",
                               out_dir, "--experiment-id", label] + flags,
                              log=lambda *_: None)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = {k: kk.launches for k, kk in cuda_build.KERNELS.items()}
            launches[f"dataset_{label}"] = got
            want = with_derived(dict({k: 0 for k in got}, **want))
            successes = sum(r["success"] for r in summary["rows"])
            cli[label] = dict(
                checkpoint=os.path.basename(snap), flags=" ".join(flags),
                successes=successes, jax_successes=jax_count,
                pairs=summary["num_pairs"], recall=summary["recall"],
                rmse_recall=summary.get("rmse_recall"),
                model_ms_a_pair=summary["model_time_mean"] * 1e3,
                data_ms_a_pair=summary["data_time_mean"] * 1e3,
                pairs_per_second=summary.get("pairs_per_second"),
                seconds=seconds)
            log(f"dataset, tools/evaluate.py {os.path.basename(snap)} "
                f"{' '.join(flags) or '(defaults)'}: {successes}/"
                f"{summary['num_pairs']} successes (JAX package: {jax_count})"
                f", RMSE recall {summary.get('rmse_recall')}, model "
                f"{cli[label]['model_ms_a_pair']:.1f} ms a pair, data stall "
                f"{cli[label]['data_ms_a_pair']:.1f} ms a pair"
                + (f", {summary['pairs_per_second']:.2f} pairs/s"
                   if "pairs_per_second" in summary else "")
                + f", {seconds:.1f} s in all, launches {got}")
            if got != want:
                raise AssertionError(f"dataset {label}: launches {got}, "
                                     f"expected {want}")
            if summary["num_pairs"] != (ns if "sampled" in label else n):
                raise AssertionError(f"dataset {label}: "
                                     f"{summary['num_pairs']} pairs")
            if successes < jax_count - 1:
                raise AssertionError(
                    f"dataset {label}: {successes} successes of "
                    f"{summary['num_pairs']} < the JAX package's {jax_count}"
                    " - 1")
        measured["evaluate"] = cli

        # loader cost alone: one pair read, analysed and downsampled
        cfg3 = make_cfg("3DMatch", root).override(
            patch=load_snapshot_config(SNAPSHOT))
        ds = get_dataset(cfg3)
        t0 = time.perf_counter()
        sample = ds[0]
        measured["loader_ms_a_pair"] = (time.perf_counter() - t0) * 1e3
        log(f"dataset: the loader takes {measured['loader_ms_a_pair']:.0f} ms "
            f"a pair on the host (two PLYs, sphericity, voxel grid, cap): "
            f"{len(sample['src_points'])} + {len(sample['tgt_points'])} "
            f"points, voxel {sample['voxel_size']}")

        # ---- the queries alone on one pair's d2, and K3/K4 at P = 1024, 128
        pair_clouds = [reg.prepare_cloud(sample[k], cfg3, seed=s, device=dev)
                       for s, k in enumerate(("src_points", "tgt_points"))]
        queries = {}
        for label, p in (("p1024_flat", 1024), ("p128_strat1", 128),
                         ("p512", 512)):
            cfg_p = cfg3.override(patch=dict(num_points_per_patch=p))
            st = reg.PipelineStatics.from_config(cfg_p)
            dr = reg.make_draws(st, torch.Generator().manual_seed(p), dev,
                                batch=1)
            scales = tuple(range(st.num_scales))
            pre = reg._precompute(st, reg.stack_clouds(pair_clouds[:1]),
                                  reg.stack_clouds(pair_clouds[1:]), dr,
                                  scales, keep_d2=True)
            if label != "p512":
                des_r = torch.clamp_min(pre.radii[:, 0], 1e-3)
                patches, pvalid = reg._scale_patches(st, pre, dr, des_r, 0)
                kpts = pre.kpts.reshape(-1, 3)
                aligned, _, _ = align_patches(
                    patches.reshape(-1, p, 3) - kpts[:, None, :], kpts, False)
                entries += k3_k4_entries(
                    torch, aligned / des_r[0], pvalid.reshape(-1, p), st,
                    f"P = {p}, {'flat' if p == 1024 else 'single-radius'} "
                    "query, scale 0", (f"dataset_{label}",
                                       f"dataset_p{p}_sampled"))
                continue
            # every query at P = 512 over all three scales, both clouds
            nf = st.num_fps
            radii = torch.clamp_min(pre.radii[0], 1e-3)
            xyz = torch.stack([c.xyz for c in pair_clouds])
            mask = pre.mask
            kp = pre.kpts
            d2 = pre.d2[:, :nf]
            g = torch.Generator(dev).manual_seed(3)
            l, s = st.max_points // p, p
            off_strat = torch.randint(0, l, (2, nf, s), generator=g,
                                      device=dev, dtype=torch.int32)
            off_flat = torch.randint(0, st.max_points, (2, nf), generator=g,
                                     device=dev, dtype=torch.int32)
            nb = st.max_points // st.bq_block
            off_blk = torch.stack([
                torch.randint(0, nb, (2, nf), generator=g, device=dev),
                torch.randint(0, st.bq_cand_blocks * st.bq_block, (2, nf),
                              generator=g, device=dev)], dim=1)
            r3 = radii[None].expand(2, -1).contiguous()

            def fused():
                return ball_query_stratified_multi(xyz, mask, kp, r3,
                                                   off_strat, p, d2)

            def per_scale(fn):
                return lambda: [fn(r) for r in radii]

            queries = {
                "fused (K2)": time_ms(fused, 10),
                "single-radius stratified": time_ms(per_scale(
                    lambda r: ball_query_stratified(
                        xyz, mask, kp, r.expand(2), off_strat, p, d2)), 5),
                "block": time_ms(per_scale(
                    lambda r: ball_query_blocks(
                        xyz, mask, kp, r.expand(2), off_blk, p, d2,
                        block=st.bq_block, cand_blocks=st.bq_cand_blocks)), 5),
                "flat": time_ms(per_scale(
                    lambda r: select_patches(xyz, mask, kp, r.expand(2),
                                             off_flat, p, d2=d2)), 5),
            }
            log("dataset: patch queries alone, one pair (2 clouds x "
                f"{nf} keypoints x {st.max_points} points), P = {p}, all "
                f"{len(radii)} scales: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in queries.items()))
        measured["query_ms_a_pair_p512"] = queries
        del pre

        # ---- no synchronizing call inside a batch on the new queries ----
        sync = {}
        models3 = reg.build_models(reg.PipelineStatics.from_config(cfg3),
                                   load_snapshot(SNAPSHOT), dev)
        for label, over in (("flat", dict(num_points_per_patch=1024)),
                            ("single-radius", dict(num_points_per_patch=128)),
                            ("block", dict(strat_ball_query=False,
                                           block_ball_query=True))):
            cfg_q = cfg3.override(patch=over)
            st = reg.PipelineStatics.from_config(cfg_q)
            dr = reg.make_draws(st, torch.Generator().manual_seed(1), dev,
                                batch=1)
            sb = reg.stack_clouds(pair_clouds[:1])
            tb = reg.stack_clouds(pair_clouds[1:])
            scales = tuple(range(st.num_scales))
            reg._register_batch(models3, st, sb, tb, dr, scales, False)
            calls = sync_calls(torch, lambda: reg._register_batch(
                models3, st, sb, tb, dr, scales, False))
            sync[label] = len(calls)
            log(f"dataset, {label} query: one batch under sync-debug mode, "
                f"{len(calls)} synchronizing calls {sorted(set(calls))}")
            if calls:
                raise AssertionError(f"the {label} query makes the host wait "
                                     "for the card inside a batch")
        measured["sync_calls"] = sync
        del models3

        # ---- (c) the gate runner, block query, sampled path + fused conv -
        gate = {}
        sd_s = load_snapshot(SNAPSHOT_SAMPLED)
        for label, kw in (("gate_blocks", dict(no_strat=True)),
                          ("gate_fused", {})):
            cfg_g = exp_hard.gate_config("sampled", SNAPSHOT_SAMPLED,
                                         ["patch.fused_conv=True"], **kw)
            st = reg.PipelineStatics.from_config(cfg_g)
            models_g = reg.build_models(st, sd_s, dev)
            cells = exp_hard.build_cells(False)
            cuda_build.reset_launch_counts()
            t0 = time.perf_counter()
            rows = [exp_hard.run_cell(cfg_g, models_g, cells[ci], ci,
                                      pairs_per_cell=GATE_PAIRS,
                                      num_points=24000, batch=BATCH,
                                      voxel=0.025, seed=20240, device=dev)
                    for ci in DATASET_GATE_CELLS]
            seconds = time.perf_counter() - t0
            got = {k: kk.launches for k, kk in cuda_build.KERNELS.items()}
            launches[f"dataset_{label}"] = got
            nb = len(DATASET_GATE_CELLS)
            want = {k: 0 for k in got}
            want.update(fps=nb, strat=nb if label == "gate_fused" else 0,
                        cell_query=3 * nb,
                        conv_stack=3 * nb * -(-2 * BATCH * st.num_fps
                                              // reg.SAMPLED_DESC_CHUNK))
            want = with_derived(want)
            if got != want:
                raise AssertionError(f"dataset {label}: launches {got}, "
                                     f"expected {want}")
            succ = sum(sum(r["successes"]) for r in rows)
            reg_s = sum(r["n"] / r["pairs_per_s"] for r in rows)
            gate[label] = dict(successes=succ, pairs=sum(r["n"] for r in rows),
                               recalls=[r["recall"] for r in rows],
                               pairs_per_s_registration=sum(
                                   r["n"] for r in rows) / reg_s,
                               seconds=seconds)
            log(f"dataset, gate cells {DATASET_GATE_CELLS} sampled + fused "
                f"conv, {'block' if 'blocks' in label else 'fused'} query: "
                f"{succ}/{gate[label]['pairs']} successes, recalls "
                f"{gate[label]['recalls']}, "
                f"{gate[label]['pairs_per_s_registration']:.2f} pairs/s of "
                f"registration, launches {got}")
            del models_g
        gate["gate_blocks"]["jax_successes"] = JAX_DATASET_GATE_SUCCESSES
        if gate["gate_blocks"]["successes"] < JAX_DATASET_GATE_SUCCESSES - 2:
            raise AssertionError(
                f"dataset gate: the block query registers "
                f"{gate['gate_blocks']['successes']} pairs < the JAX "
                f"package's {JAX_DATASET_GATE_SUCCESSES} - 2")
        measured["gate"] = gate

        # ---- (d) tools/train.py on the training manifest ------------------
        events = []
        step = tt.Trainer._step

        def timed_step(self, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(self, batch)
            end.record()
            events.append((self.stage, start, end))
            return m

        cwd = os.getcwd()
        cuda_build.reset_launch_counts()
        tt.Trainer._step = timed_step
        try:
            os.chdir(root)
            t0 = time.perf_counter()
            ttrain.main(["--dataset", "3DMatch", "--root", root, "--epochs",
                         "1", "--steps-per-epoch", str(DATASET_TRAIN_STEPS),
                         "--pretrain", SNAPSHOT_SAMPLED, "--experiment-id",
                         "smoke"], log=lambda *_: None)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        finally:
            tt.Trainer._step = step
            os.chdir(cwd)
        got = {k: kk.launches for k, kk in cuda_build.KERNELS.items()}
        launches["dataset_train"] = got
        step_ms = {st_: [a.elapsed_time(b) for s_, a, b in events if s_ == st_]
                   for st_ in ("Desc", "Pose")}
        if any(len(v) != DATASET_TRAIN_STEPS for v in step_ms.values()):
            raise AssertionError(f"dataset training: steps {step_ms}")
        if got["cell_query"] < 2 * DATASET_TRAIN_STEPS or got["strat"] or \
                got["fps"] or got["moments"]:
            raise AssertionError(f"dataset training: launches {got}")
        snap = os.path.join(root, "snapshot", "3DMatch", "smoke")
        cfg_t = make_cfg("3DMatch", root)

        # the shipped moments descriptor's Desc stage on the same dataset
        # stream at the preset's width, through the trainer tools/train.py
        # drives (which trains the preset's sampled mode): K3 at the
        # training shapes
        cfg_m = cfg_t.override(patch=load_snapshot_config(SNAPSHOT))
        desc_m, _pose_m = tt.train_models(cfg_m, load_snapshot(SNAPSHOT), dev)
        rs_m = np.random.RandomState(cfg_m.data.manual_seed)
        events.clear()
        cuda_build.reset_launch_counts()
        tt.Trainer._step = timed_step
        try:
            tt.Trainer(
                cfg_m.override(stage="Desc"), "Desc", desc_m, None,
                ttrain.dataset_stream(cfg_m, get_dataset(cfg_m, "train"),
                                      DATASET_TRAIN_STEPS, rs_m, dev),
                ttrain.dataset_stream(cfg_m, get_dataset(cfg_m, "val"), 2,
                                      rs_m, dev),
                steps_per_epoch=DATASET_TRAIN_STEPS,
                snapshot_dir=os.path.join(root, "snapshot_moments"),
                log=lambda *_: None).train(1)
            torch.cuda.synchronize()
        finally:
            tt.Trainer._step = step
        got_m = {k: kk.launches for k, kk in cuda_build.KERNELS.items()}
        launches["dataset_train_moments"] = got_m
        moments_step_ms = [a.elapsed_time(b) for _s, a, b in events]
        if len(moments_step_ms) != DATASET_TRAIN_STEPS or \
                got_m["moments"] < 2 * DATASET_TRAIN_STEPS or \
                got_m["cell_query"] or got_m["strat"] or got_m["fps"]:
            raise AssertionError(f"dataset moments training: steps "
                                 f"{moments_step_ms}, launches {got_m}")
        del desc_m, _pose_m
        log(f"dataset, moments Desc stage on the 3DMatch stream: "
            f"{DATASET_TRAIN_STEPS} steps, ms a step "
            f"{[round(x, 1) for x in moments_step_ms]}, launches {got_m}")
        # K3 and K4 on one training batch's patches at the preset's width
        from bufferx_tpu_torch.train import forward as tf

        st_t = tf.TrainStatics.from_config(cfg_t)
        b0 = next(iter(ttrain.dataset_stream(
            cfg_t, get_dataset(cfg_t, "train"), 1, np.random.RandomState(0),
            dev)()))
        dr_t = tf.make_train_draws(st_t, cfg_t.capacity.max_points,
                                   torch.Generator(dev).manual_seed(2), dev)
        aligned_t, pmask_t, _r, _a, _g = tf.training_patches(
            st_t, b0["src_fds"], b0["src_fds_mask"], b0["src_kpt"],
            b0["des_r"], b0["is_aligned"], dr_t.off_src)
        entries += k3_k4_entries(
            torch, aligned_t, pmask_t, reg.PipelineStatics.from_config(cfg_t),
            f"training batch, 3DMatch preset: {cfg_t.train.pos_num} "
            f"correspondences, {cfg_t.patch.num_points_per_patch}-point "
            "patches", ("dataset_train_moments", "dataset_train"))
        res = reg.register_pair(cfg_t, *pair_clouds, load_snapshot(snap),
                                generator=torch.Generator().manual_seed(0),
                                device=dev)
        rte, rre, ok = pose_errors(se3, cfg_t, res.pose,
                                   torch.as_tensor(sample["relt_pose"],
                                                   device=dev))
        if not bool(torch.isfinite(res.pose).all()):
            raise AssertionError("dataset training: the trained nets serve "
                                 "no finite pose")
        measured["train"] = dict(
            steps=DATASET_TRAIN_STEPS, seconds=train_s,
            desc_step_ms=step_ms["Desc"], pose_step_ms=step_ms["Pose"],
            moments_desc_step_ms=moments_step_ms,
            served_rte=rte, served_rre=rre, served_success=ok)
        log(f"dataset, tools/train.py (sampled mode from snapshot/hard, "
            f"3DMatch preset: {cfg_t.train.pos_num} correspondences, "
            f"{cfg_t.patch.num_points_per_patch}-point patches, "
            f"{cfg_t.capacity.max_points} points): "
            f"{DATASET_TRAIN_STEPS} Desc + {DATASET_TRAIN_STEPS} Pose steps, "
            f"ms a step Desc {[round(x, 1) for x in step_ms['Desc']]}, Pose "
            f"{[round(x, 1) for x in step_ms['Pose']]}, {train_s:.1f} s with "
            f"loading and validation, launches {got}; served one pair with "
            f"the result: RTE {rte:.3f} m, RRE {rre:.2f} deg, success {ok}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    measured["seconds"] = time.perf_counter() - t_phase
    log(f"dataset phase: {measured['seconds']:.1f} s")
    return launches, measured, entries


# phase 12: the multi-frame tool's runs. The JAX package's numbers on the
# same frames (the same trajectory, clouds, configuration and checkpoint), on
# the CPU, with its own draws:
#   python scripts/exp_multiframe.py --cpu [--num-points 30208 --frames 20]
# (a) at the defaults: 55 of 55 edges registered, ATE chained 0.0774 m,
#     refined 0.0620 m; (b) at the main path's capacity (30208 points, 20
#     frames, 22 edges): 22 of 22, ATE chained 0.0638 m, refined 0.0497 m.
# Each run here must register the JAX count less 1 and refine to within
# 0.02 m of JAX's ATE.
MF_RUNS = {
    "a": dict(argv=[], edges=55, registered=55, ate_refined=0.0620,
              path="multiframe"),
    "b": dict(argv=["--num-points", "30208", "--frames", "20"], edges=22,
              registered=22, ate_refined=0.0497, path="multiframe_30208"),
}
MF_GN_BA_TOL = 1e-4     # card float32 against the CPU's float64, pose entries


def synthetic_ba(rs, frames=50, landmarks=2000, per_landmark=10,
                 noise=0.002):
    """A bundle-adjustment problem on the multi-frame tool's trajectory:
    ``landmarks`` points in the room, each seen from ``per_landmark``
    random frames (noise in metres), poses but frame 0 and landmarks
    perturbed, the chain's exact relative poses as factors. Returns (gt
    poses, gt landmarks, (frame, landmark, local) observations, initial
    poses, initial landmarks, chain relative poses), float64 numpy."""
    from bufferx_tpu_torch.tools.exp_multiframe import make_trajectory

    poses = np.stack(make_trajectory(frames, 1.6, rs))
    lms = np.concatenate([rs.uniform(-3, 3, (landmarks, 2)),
                          rs.uniform(0, 2, (landmarks, 1))], axis=1)
    of = np.concatenate([rs.choice(frames, per_landmark, replace=False)
                         for _ in range(landmarks)])
    ol = np.repeat(np.arange(landmarks), per_landmark)
    R, t = poses[of, :3, :3], poses[of, :3, 3]
    oz = np.einsum("mji,mj->mi", R, lms[ol] - t) \
        + rs.randn(len(of), 3) * noise
    p0 = poses.copy()
    for i in range(1, frames):
        a = rs.uniform(-0.05, 0.05)
        c, s_ = np.cos(a), np.sin(a)
        p0[i, :3, :3] = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]]) \
            @ p0[i, :3, :3]
        p0[i, :3, 3] += rs.uniform(-0.1, 0.1, 3)
    l0 = lms + rs.uniform(-0.1, 0.1, lms.shape)
    rel = np.stack([np.linalg.inv(poses[i]) @ poses[i + 1]
                    for i in range(frames - 1)])
    return poses, lms, (of, ol, oz), p0, l0, rel


def multiframe_kernel_entries(torch, reg, mf_setup, dev, path):
    """K1, K2 and K3 against their plain versions at the shapes the
    multi-frame tool's batches give them: the first 8 edges' precompute
    (16 clouds of the run's points, 512 probes, 256-point patches).
    ``path``: the launch path of the entries (the run's counts)."""
    cfg = mf_setup["cfg"]
    edges = mf_setup["edges"][:BATCH]
    prepared = {i: reg.prepare_cloud(mf_setup["clouds"][i], cfg, seed=i,
                                     device=dev)
                for i in sorted({i for e in edges for i in e})}
    return batch_kernel_entries(
        torch, reg, cfg, [prepared[i] for i, _ in edges],
        [prepared[j] for _, j in edges], dev, path,
        f"multi-frame batch, {2 * BATCH} clouds of "
        f"{cfg.capacity.max_points} points")


def batch_kernel_entries(torch, reg, cfg, srcs, tgts, dev, path, case,
                         patch_kernel="moments", is_aligned=False):
    """K1, K2 and the patch kernel (K3 ``"moments"`` or K4
    ``"cell_query"``) against their plain versions at the shapes that a
    batch of the pairs (``srcs``, ``tgts``: prepared clouds) gives them
    under ``cfg``, labelled ``case``; the patch kernel's patches aligned
    with ``is_aligned`` (a bool, or a flag a pair). ``path``: the launch
    path of the entries. Returns (entries, (source batch, target batch,
    draws))."""
    from bufferx_tpu_torch.geometry.lrf import align_patches
    from bufferx_tpu_torch.kernels import fps as fps_mod
    from bufferx_tpu_torch.kernels import strat_pallas
    from bufferx_tpu_torch.tools import bench_strat
    from bufferx_tpu_torch.tools.bench_strat import time_ms

    statics = reg.PipelineStatics.from_config(cfg)
    src8 = reg.stack_clouds(srcs)
    tgt8 = reg.stack_clouds(tgts)
    draws8 = reg.make_draws(statics, torch.Generator(device=dev).manual_seed(0),
                            dev, batch=len(srcs))
    pre = reg._precompute(statics, src8, tgt8, draws8,
                          tuple(range(statics.num_scales)), keep_d2=True)
    torch.cuda.synchronize()
    entries = []

    xyz16 = torch.cat([src8.xyz, tgt8.xyz])
    mask16 = torch.cat([src8.mask, tgt8.mask])
    k = statics.num_probe
    got = fps_mod.farthest_point_sampling_cuda(xyz16, mask16, k)
    want = fps_mod.farthest_point_sampling_plain(xyz16, mask16, k)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"fps, {case}: {int((got != want).sum())} "
                             "indices differ from the plain version")
    b, n = mask16.shape
    entries.append(dict(
        name="fps", case=case, path=path, match="indices exact",
        max_abs_err=0.0, library_ms=None,
        ms=time_ms(lambda: fps_mod.farthest_point_sampling_cuda(
            xyz16, mask16, k), 5),
        plain_ms=time_ms(lambda: fps_mod.farthest_point_sampling_plain(
            xyz16, mask16, k), 2),
        bound=bound_ms(b * n * 13 + b * k * 4, 9.0 * b * k * n),
        shapes=f"xyz {list(xyz16.shape)} -> idx [{b}, {k}]"))

    nf, S = statics.num_fps, statics.patch_sample
    q16, _lo, _res = strat_pallas.quantize(xyz16, mask16)
    L = statics.max_points // S
    q_t = q16.reshape(b, L, S, 3).permute(0, 3, 1, 2).contiguous()
    radii2 = (torch.clamp_min(torch.cat([pre.radii, pre.radii]), 1e-3)
              ** 2).contiguous()
    off = torch.cat([draws8.strat_src, draws8.strat_tgt]).contiguous()
    args = (pre.d2[:, :nf], q_t, off, radii2)
    got = strat_pallas.strat_packed_cuda(*args)
    want = strat_pallas.strat_packed_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"strat, {case}: {int((got != want).sum())} "
                             "packed words differ from the plain version")
    entries.append(dict(
        name="strat", case=case, path=path, match="bit-exact",
        max_abs_err=0.0, library_ms=None,
        ms=time_ms(lambda: strat_pallas.strat_packed_cuda(*args), 20),
        plain_ms=time_ms(lambda: strat_pallas.strat_packed_plain(*args), 2),
        bound=bound_ms(bench_strat.strat_bytes(*args),
                       args[0].numel() * (2.0 + 3.0 * statics.num_scales)),
        shapes=f"d2 {list(args[0].shape)}, R = {statics.num_scales} -> "
               f"packed {list(got.shape)}"))
    del got, want, args

    patches = pre.patches[:, 0].reshape(b * nf, S, 3)
    pmask = pre.pvalid[:, 0].reshape(b * nf, S)
    kpts = pre.kpts.reshape(b * nf, 3)
    aligned, _, _ = align_patches(patches - kpts[:, None, :], kpts,
                                  reg.patch_flags(is_aligned, nf))
    r_patch = torch.clamp_min(torch.cat([pre.radii[:, 0], pre.radii[:, 0]]),
                              1e-3).repeat_interleave(nf)
    normed = aligned / r_patch[:, None, None]
    k3, k4 = k3_k4_entries(torch, normed, pmask, statics, case,
                           (path, path))
    entries.append(k3 if patch_kernel == "moments" else k4)
    return entries, (src8, tgt8, draws8)


def run_multiframe(torch, cuda_build, reg, se3, dev):
    """Phase 12: the multi-frame front end and the distributed layer (see
    the module notes). Returns (launches of runs (a) and (b), what it
    measured, kernel entries)."""
    import dataclasses

    from bufferx_tpu_torch.parallel import bundle as ba
    from bufferx_tpu_torch.parallel import posegraph as pg
    from bufferx_tpu_torch.tools import dryrun
    from bufferx_tpu_torch.tools import exp_multiframe as mf
    from bufferx_tpu_torch.tools.bench_strat import time_ms
    from bufferx_tpu_torch.tools.trace_pair import _profiled

    t_phase = time.perf_counter()
    measured, launches, setups = {}, {}, {}
    for run, spec in MF_RUNS.items():
        args = mf.parse_args(spec["argv"])
        t0 = time.perf_counter()
        s = mf.setup(args, dev)
        t1 = time.perf_counter()
        mf.run_sequence(s, args)                  # warm-up
        log(f"multi-frame ({run}): set-up {t1 - t0:.1f} s, warm-up run "
            f"{time.perf_counter() - t1:.1f} s")
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        result = mf.run_sequence(s, args)
        reg_s = time.perf_counter() - t0
        counts = {n: kk.launches for n, kk in cuda_build.KERNELS.items()}
        summary = mf.summarize(s, args, result, reg_s, 1)
        summary["launches"] = counts
        log(f"multi-frame ({run}) {spec['argv']}: {json.dumps(summary)}")
        if summary["edges"] != spec["edges"]:
            raise AssertionError(f"multi-frame ({run}): {summary['edges']} "
                                 f"edges, expected {spec['edges']}")
        for kname in ("fps", "strat", "moments"):
            if counts[kname] < 1:
                raise AssertionError(f"multi-frame ({run}): {kname} never "
                                     "launched")
        if counts["hyp_score"] != with_derived(counts)["hyp_score"]:
            raise AssertionError(f"multi-frame ({run}): hyp_score launched "
                                 f"{counts['hyp_score']} times for "
                                 f"{counts['fps']} precomputations")
        if summary["edges_registered"] < spec["registered"] - 1:
            raise AssertionError(
                f"multi-frame ({run}): {summary['edges_registered']} edges "
                f"registered < the JAX package's {spec['registered']} - 1")
        if summary["ate_refined"] > spec["ate_refined"] + 0.02:
            raise AssertionError(
                f"multi-frame ({run}): ATE refined {summary['ate_refined']} "
                f"> the JAX package's {spec['ate_refined']} + 0.02")
        measured[run] = summary
        launches[spec["path"]] = counts
        setups[run] = s
        if run == "a":
            args_a, result_a = args, result

    # (c) K1-K3 at each run's batch shapes; no synchronizing call in a
    # batch of its edges nor in the GN loop
    t0 = time.perf_counter()
    entries, _ = multiframe_kernel_entries(torch, reg, setups["b"], dev,
                                           MF_RUNS["b"]["path"])
    setup_a = setups["a"]
    entries_a, (src8, tgt8, draws8) = multiframe_kernel_entries(
        torch, reg, setup_a, dev, MF_RUNS["a"]["path"])
    entries += entries_a
    log(f"multi-frame kernel checks: {time.perf_counter() - t0:.1f} s")
    statics = dataclasses.replace(
        reg.PipelineStatics.from_config(setup_a["cfg"]),
        enable_early_exit=False)
    syncs = sync_calls(torch, lambda: reg._register_batch(
        setup_a["models"], statics, src8, tgt8, draws8, (0,), False))
    if syncs:
        raise AssertionError(f"multi-frame batch: synchronizing calls at "
                             f"{syncs}")
    k = args_a.frames
    graph = result_a.graph
    init = pg.chain_initialization(graph, k)
    gn_kw = dict(num_poses=k, num_iters=args_a.gn_iters, robust="huber",
                 robust_scale=0.3)
    syncs = sync_calls(torch, lambda: pg.pose_graph_gauss_newton(
        graph, init, **gn_kw))
    if syncs:
        raise AssertionError(f"GN loop: synchronizing calls at {syncs}")

    # (d) GN on (a)'s graph and BA on a synthetic problem, card (float32)
    # against the CPU (float64)
    t_d = time.perf_counter()
    gn = pg.pose_graph_gauss_newton(graph, init, **gn_kw)
    graph64 = pg.PoseGraph(graph.edges_i.cpu(), graph.edges_j.cpu(),
                           graph.t_meas.cpu().double(),
                           graph.weights.cpu().double())
    t0 = time.perf_counter()
    gn64 = pg.pose_graph_gauss_newton(graph64, init.cpu().double(), **gn_kw)
    gn_cpu_ms = (time.perf_counter() - t0) * 1e3
    gn_err = float((gn.cpu().double() - gn64).abs().max())
    if gn_err > MF_GN_BA_TOL:
        raise AssertionError(f"GN: card and CPU float64 differ by {gn_err}")
    gn_ms = time_ms(lambda: pg.pose_graph_gauss_newton(graph, init, **gn_kw),
                    5)
    poses_gt, lms_gt, (of, ol, oz), p0, l0, rel = synthetic_ba(
        np.random.RandomState(0))
    n_f, n_l = len(poses_gt), len(lms_gt)

    def ba_problem(device, dtype):
        obs = ba.LandmarkGraph(
            torch.from_numpy(of).to(device), torch.from_numpy(ol).to(device),
            torch.from_numpy(oz).to(device, dtype),
            torch.ones(len(of), dtype=dtype, device=device))
        chain = pg.PoseGraph(
            torch.arange(n_f - 1, device=device),
            torch.arange(1, n_f, device=device),
            torch.from_numpy(rel).to(device, dtype),
            torch.ones(n_f - 1, dtype=dtype, device=device))
        return (torch.from_numpy(p0).to(device, dtype),
                torch.from_numpy(l0).to(device, dtype), obs, chain)

    ba_kw = dict(num_poses=n_f, num_lms=n_l, num_iters=10)
    p_c, l_c, obs_c, chain_c = ba_problem(dev, torch.float32)

    def ba_card():
        return ba.bundle_adjust(p_c, l_c, obs_c, pose_graph=chain_c, **ba_kw)

    syncs = sync_calls(torch, ba_card)
    if syncs:
        raise AssertionError(f"BA loop: synchronizing calls at {syncs}")
    ba_p, ba_l = ba_card()
    p_h, l_h, obs_h, chain_h = ba_problem("cpu", torch.float64)
    t0 = time.perf_counter()
    ba_p64, ba_l64 = ba.bundle_adjust(p_h, l_h, obs_h, pose_graph=chain_h,
                                      **ba_kw)
    ba_cpu_ms = (time.perf_counter() - t0) * 1e3
    ba_err = max(float((ba_p.cpu().double() - ba_p64).abs().max()),
                 float((ba_l.cpu().double() - ba_l64).abs().max()))
    if ba_err > MF_GN_BA_TOL:
        raise AssertionError(f"BA: card and CPU float64 differ by {ba_err}")
    ba_gt = float(np.abs(ba_p64.numpy() - poses_gt).max())
    if ba_gt > 0.01:
        raise AssertionError(f"BA: poses {ba_gt} from the ground truth")
    ba_ms = time_ms(ba_card, 3)
    # device time against launches: one profiled call of each loop (a
    # profiled run of a whole sequence, ~92k launches, takes the profiler
    # about a minute to process)
    gn_prof, _ = _profiled(lambda: pg.pose_graph_gauss_newton(
        graph, init, **gn_kw), "GN", 1)
    ba_prof, _ = _profiled(ba_card, "BA", 1)
    measured["profiles"] = {"gn": gn_prof, "ba": ba_prof}
    log(f"GN, BA and the profiles: {time.perf_counter() - t_d:.1f} s")
    measured["gn"] = dict(frames=k, factors=int(graph.weights.shape[0]),
                          iters=args_a.gn_iters, ms=gn_ms, cpu_f64_ms=gn_cpu_ms,
                          max_abs_err_vs_f64=gn_err)
    measured["ba"] = dict(frames=n_f, landmarks=n_l, observations=len(of),
                          chain_factors=n_f - 1, iters=10, ms=ba_ms,
                          cpu_f64_ms=ba_cpu_ms, max_abs_err_vs_f64=ba_err,
                          max_pose_err_vs_gt=ba_gt)
    log(f"GN ({k} frames, {measured['gn']['factors']} factors, "
        f"{args_a.gn_iters} iterations): {gn_ms:.2f} ms on the card, CPU "
        f"float64 {gn_cpu_ms:.1f} ms, max difference {gn_err:.2e}; BA "
        f"({n_f} frames, {n_l} landmarks, {len(of)} observations, 10 "
        f"iterations): {ba_ms:.2f} ms on the card, CPU float64 "
        f"{ba_cpu_ms:.1f} ms, max difference {ba_err:.2e}; no synchronizing "
        "call in a batch, the GN loop or the BA loop")

    # (e) the dry run: entry() on the card, then the training step, the
    # sharded eval and the sharded GN over one NCCL rank a card
    fn, example = dryrun.entry(dev)
    out = fn(*example)
    if not bool(torch.isfinite(out.pose).all()):
        raise AssertionError("entry(): pose not finite")
    t0 = time.perf_counter()
    ranks = dryrun.dryrun_multichip(torch.cuda.device_count())
    dry_s = time.perf_counter() - t0
    backends = sorted({r["backend"] for r in ranks})
    if backends != ["nccl"] or not all(np.isfinite(r["loss"]) for r in ranks):
        raise AssertionError(f"dry run: backends {backends}, losses "
                             f"{[r['loss'] for r in ranks]}")
    measured["dryrun"] = dict(ranks=len(ranks), backend=backends[0],
                              seconds=dry_s,
                              loss=[r["loss"] for r in ranks],
                              devices=[r["device"] for r in ranks])
    log(f"dry run over {len(ranks)} NCCL rank(s): {dry_s:.1f} s, loss "
        f"{measured['dryrun']['loss']}")
    measured["seconds"] = time.perf_counter() - t_phase
    log(f"multi-frame phase: {measured['seconds']:.1f} s")
    return launches, measured, entries


# ---- phase 13: the offline tools ------------------------------------------
# (a) the synthetic ScanNet++ iPhone scene: IPHONE_FRAMES frames of a room of
# axis-aligned boxes (camera convention: x right, y down, z ahead; the room
# is [x0, x1] x [y0, y1] x [z0, z1] metres, the floor at y = 1.2), ray-cast
# at 192 x 256 with the iPhone intrinsics, depth noise 1 mm from the seed
IPHONE_FRAMES = 200
IPHONE_SEED = 0
IPHONE_K_VIDEO = np.array([[1500.0, 0.0, 960.0], [0.0, 1500.0, 720.0],
                           [0.0, 0.0, 1.0]])
IPHONE_ROOM = ((-2.2, 2.2), (-1.6, 1.2), (-1.0, 3.4))
IPHONE_BOXES = (
    ((-1.2, 0.4, 1.8), (-0.5, 1.2, 2.5)),
    ((0.3, -0.2, 2.2), (1.0, 1.2, 2.8)),
    ((-0.3, 0.7, 1.2), (0.2, 1.2, 1.6)),
    ((-0.8, -1.0, 2.7), (0.4, -0.6, 3.1)),
    ((0.9, 0.5, 1.0), (1.4, 1.2, 1.5)),
    ((-1.6, -0.4, 2.9), (-1.0, 1.2, 3.4)),
)


def iphone_trajectory(frames: int = IPHONE_FRAMES) -> np.ndarray:
    """[frames, 4, 4] camera-to-world poses: a pan from -20 to +20 degrees
    of yaw with a slight nod, sliding 0.8 m sideways, so that each
    fragment's base frame sees the boxes and the back wall 0.5-3.5 m ahead
    (inside the default TSDF grid) and fragments overlap."""
    out = np.zeros((frames, 4, 4))
    for t in range(frames):
        s = t / max(frames - 1, 1)
        yaw = np.deg2rad(-20.0 + 40.0 * s)
        pitch = np.deg2rad(5.0 * np.sin(np.pi * s))
        cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
        r_yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        r_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        out[t, :3, :3] = r_yaw @ r_pitch
        out[t, :3, 3] = [-0.4 + 0.8 * s, 0.1 * np.sin(2 * np.pi * s),
                         0.1 * np.sin(2 * np.pi * s)]
        out[t, 3, 3] = 1.0
    return out


def render_iphone_depth(k_depth: np.ndarray, cam2world: np.ndarray,
                        rs: np.random.RandomState) -> np.ndarray:
    """[192, 256] float32 z-depth (metres) of the room and its boxes seen
    from ``cam2world``: the nearest box entry in front of the camera, else
    the room's wall where the ray leaves it."""
    h, w = 192, 256
    v, u = np.mgrid[0:h, 0:w].reshape(2, -1)
    rays = np.stack([(u - k_depth[0, 2]) / k_depth[0, 0],
                     (v - k_depth[1, 2]) / k_depth[1, 1],
                     np.ones(h * w)])               # z = 1: t is z-depth
    d = cam2world[:3, :3] @ rays                    # [3, h w]
    c = cam2world[:3, 3:]
    with np.errstate(divide="ignore"):
        inv = 1.0 / d                         # +-inf on an axis-parallel ray

    def slabs(lo, hi):
        t0 = (np.asarray(lo)[:, None] - c) * inv
        t1 = (np.asarray(hi)[:, None] - c) * inv
        near, far = np.minimum(t0, t1), np.maximum(t0, t1)
        return (np.maximum(np.maximum(near[0], near[1]), near[2]),
                np.minimum(np.minimum(far[0], far[1]), far[2]))

    _, depth = slabs(*zip(*IPHONE_ROOM))
    for bmin, bmax in IPHONE_BOXES:
        t_in, t_out = slabs(bmin, bmax)
        hit = (t_in <= t_out) & (t_in > 0.05) & (t_in < depth)
        depth = np.where(hit, t_in, depth)
    depth = depth.reshape(h, w)
    depth = depth + rs.randn(h, w) * 0.001
    return np.where(np.isfinite(depth) & (depth > 0.1), depth,
                    0.0).astype(np.float32)


def write_iphone_scene(scene_root: str, frames: int = IPHONE_FRAMES,
                       seed: int = IPHONE_SEED) -> str:
    """A raw ScanNet++ iPhone scene at ``<scene_root>/iphone/``: ``depth.bin``
    (one raw-deflate stream of float32 metres [frames, 192, 256]) and
    ``pose_intrinsic_imu.json`` (``aligned_pose``, video ``intrinsic``).
    Returns ``scene_root``."""
    import zlib

    rs = np.random.RandomState(seed)
    poses = iphone_trajectory(frames)
    k_depth = IPHONE_K_VIDEO / 7.5          # INTRINSIC_SCALE: 1920 / 256
    iphone = os.path.join(scene_root, "iphone")
    os.makedirs(iphone, exist_ok=True)
    comp = zlib.compressobj(level=1, wbits=-zlib.MAX_WBITS)
    meta = {}
    with open(os.path.join(iphone, "depth.bin"), "wb") as f:
        for t in range(frames):
            f.write(comp.compress(
                render_iphone_depth(k_depth, poses[t], rs).tobytes()))
            meta[f"frame_{t:06d}"] = dict(aligned_pose=poses[t].tolist(),
                                          intrinsic=IPHONE_K_VIDEO.tolist())
        f.write(comp.flush())
    with open(os.path.join(iphone, "pose_intrinsic_imu.json"), "w") as f:
        json.dump(meta, f)
    return scene_root


def gt_log_inverted(iphone_dir: str, out_root: str) -> str:
    """A ScanNet++ iPhone layout at ``<out_root>/scene0/iphone/`` whose
    ``gt.log`` holds the inverse of each pose in ``iphone_dir/gt.log`` (its
    ``tsdf/`` a link to the original). The port's ``generate_pairs`` writes
    inv(trans), trans = inv(pose_j) pose_i mapping fragment i into fragment
    j, and the fragment loader inverts the log's pose: the pair is scored
    against its true relative pose. The JAX package writes trans itself,
    which the loader turns into the inverse (ROADMAP.md, Queue 3): inverting
    the port's log gives that direction. Returns out_root."""
    from bufferx_tpu_torch.data.base import (
        read_trajectory_log,
        write_trajectory_log,
    )

    iphone = os.path.join(out_root, "scene0", "iphone")
    os.makedirs(iphone, exist_ok=True)
    pairs, poses = read_trajectory_log(os.path.join(iphone_dir, "gt.log"))
    write_trajectory_log(os.path.join(iphone, "gt.log"), pairs,
                         [np.linalg.inv(p) for p in poses])
    os.symlink(os.path.join(iphone_dir, "tsdf"),
               os.path.join(iphone, "tsdf"))
    return out_root


# The JAX package's output on this scene, on the CPU (``prepare_scene`` with
# the defaults and keep_prob 1.0, then ``scripts/evaluate.py``):
#   python - <<'PY'
#   import chip_smoke
#   from bufferx_tpu.tools.scannetpp import prepare_scene
#   chip_smoke.write_iphone_scene("D/scene0")
#   print(prepare_scene("D/scene0", pair_kw=dict(keep_prob=1.0)))
#   chip_smoke.gt_log_inverted("D/scene0/iphone", "DI")
#   PY
#   python scripts/evaluate.py --dataset Scannetpp_iphone --cpu \
#       --checkpoint-dir snapshot/hard_moments_r4ft2 --root D   (and DI)
# 4 fragments of 50 frames, 4 of the 6 candidate pairs accepted, the points
# of each fragment, the first 16 hex digits of each PLY's sha256 and of its
# gt.log's; at the preset's full width 0 of 4 successes on its log as
# written ("as_written": the JAX package writes trans = inv(pose_j) pose_i,
# which the loader inverts, so each pair is scored against its inverse pose:
# RRE 19-41 degrees, twice each pair's rotation) and 4 of 4 on that log
# inverted ("inverted": the true relative pose). The port writes the
# inverted direction itself: its log as written must reach the JAX
# package's "inverted" count less 1, and its log inverted (the JAX
# direction) is scored and logged beside the JAX package's "as_written"
# count. Phase 13 must match the fragments' points within IPHONE_POINT_TOL
# (relative) and the pairs exactly; the port's gt.log poses are the
# inverses of the JAX log's (rebuilt from the fragments' poses with the JAX
# package's formula and format, whose sha256 must be JAX's) within
# IPHONE_LOG_TOL.
JAX_IPHONE = dict(
    fragments=4, pairs=4, gt_pairs=[[0, 1], [1, 2], [1, 3], [2, 3]],
    points=[427994, 440485, 442378, 355049],
    ply_sha256=["6cd3ca69a763452a", "02e9724ae72659e5", "2492921c37b66177",
                "233da940e8eb4bd2"],
    gt_log_sha256="f28534c9672471ff",
    successes={"as_written": 0, "inverted": 4})
IPHONE_POINT_TOL = 1e-4
IPHONE_LOG_TOL = 1e-6
# the port's phase 13 (b) runs: its log as written and that log inverted,
# each held to the JAX package's count on the log of the same direction
IPHONE_LOGS = {"as_written": "inverted", "jax_direction": "as_written"}
# voxels of the card's volume allowed to differ from the CPU's after the
# first 2 frames at the full grid (the operations round alike on both)
IPHONE_CARD_CPU_FLIPS = 0
IPHONE_TIMED_FRAMES = 50
IPHONE_GRID = dict(origin=(-1.5, -1.5, 0.5), dims=(500, 500, 500),
                   voxel=0.006)
# (d): tools/bench_scaling.py's batch run at world size 1 (4 pairs, every
# scale, the sampled path with the cuDNN backbone; 12000 patches a pass, two
# sub-batches of the descriptor net)
BENCH_LAUNCHES = with_derived({"fps": 1, "strat": 1, "moments": 0,
                                "cell_query": 3, "conv_stack": 0}, chunks=2)


def jax_gt_log(layout, rows, poses):
    """The JAX package's ``gt.log`` for the port's pairs ``rows``, rebuilt
    as its ``generate_pairs`` writes it: trans = inv(pose_j) pose_i from the
    fragments' base-frame poses, ``f"{v: .8e}"`` entries. Returns (its
    bytes, the largest entry of |pose - inv(trans)| over the port's log
    ``poses``)."""
    from bufferx_tpu_torch.tools.scannetpp import FRAMES_PER_FRAGMENT

    def frag_pose(idx):
        return np.loadtxt(os.path.join(
            layout.pose_dir,
            f"frame_{int(idx) * FRAMES_PER_FRAGMENT:06d}.pose.txt"))

    out, err = [], 0.0
    for (i, j, n), pose in zip(rows, poses):
        trans = np.linalg.inv(frag_pose(j)) @ frag_pose(i)
        err = max(err, float(np.abs(pose - np.linalg.inv(trans)).max()))
        out.append(f"{int(i)}\t{int(j)}\t{int(n)}\n")
        out += ["\t".join(f"{v: .8e}" for v in row) + "\n" for row in trans]
    return "".join(out).encode(), err


def reference_state_dict(torch, snapshot_dir: str) -> dict:
    """A staged snapshot (``{Desc,Pose}/best.msgpack``, sampled descriptor)
    as the state dict of the reference's whole ``BufferX`` module: the
    inverse of ``tools/torch_import.py``'s map, with ``Desc.`` and
    ``Pose.`` keys, BatchNorm running statistics and
    ``num_batches_tracked``."""
    from bufferx_tpu_torch.tools.weights import msgpack_restore

    sd = {}

    def cbr(p, st, conv_key, bn_key, affine):
        w = p["Conv_0"]["kernel"]
        perm = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[w.ndim]
        sd[conv_key + ".weight"] = torch.from_numpy(
            np.array(np.transpose(w, perm), order="C"))
        sd[conv_key + ".bias"] = torch.from_numpy(p["Conv_0"]["bias"].copy())
        if bn_key is None:
            return
        if affine:
            sd[bn_key + ".weight"] = torch.from_numpy(
                p["BatchNorm_0"]["scale"].copy())
            sd[bn_key + ".bias"] = torch.from_numpy(
                p["BatchNorm_0"]["bias"].copy())
        sd[bn_key + ".running_mean"] = torch.from_numpy(
            st["BatchNorm_0"]["mean"].copy())
        sd[bn_key + ".running_var"] = torch.from_numpy(
            st["BatchNorm_0"]["var"].copy())
        sd[bn_key + ".num_batches_tracked"] = torch.tensor(1000)

    trees = {}
    for stage in ("Desc", "Pose"):
        with open(os.path.join(snapshot_dir, stage, "best.msgpack"), "rb") as f:
            trees[stage] = msgpack_restore(f.read())
    p, st = trees["Desc"]["params"], trees["Desc"]["batch_stats"]
    cbr(p["ConvBNRelu_0"], st["ConvBNRelu_0"], "Desc.pnt_layer.0",
        "Desc.pnt_layer.1", True)
    op = 0
    for i in range(8):
        name = f"ConvBNRelu_{i}"
        cbr(p["CylindricalConvNet_0"][name],
            st["CylindricalConvNet_0"].get(name), f"Desc.conv_net.ops.{op}",
            f"Desc.conv_net.ops.{op + 1}" if i < 7 else None, False)
        op += 3 if i < 7 else 1
    for name, conv, bn in (("ConvBNRelu_1", "0", "1"),
                           ("ConvBNRelu_2", "3", "4")):
        cbr(p[name], st[name], f"Desc.pool_layer.{conv}",
            f"Desc.pool_layer.{bn}", True)
    p, st = trees["Pose"]["params"], trees["Pose"]["batch_stats"]
    op = 0
    for i in range(10):
        name = f"ConvBNRelu_{i}"
        cbr(p[name], st.get(name), f"Pose.conv.ops.{op}",
            f"Pose.conv.ops.{op + 1}" if i < 9 else None, False)
        op += 3 if i < 9 else 1
    return sd


def write_reference_snapshot(torch, snapshot_dir: str, out_dir: str) -> str:
    """``<out_dir>/{Desc,Pose}/best.pth``, each the whole reference-layout
    state dict of ``snapshot_dir`` (:func:`reference_state_dict`), as the
    reference ships its checkpoints. Returns out_dir."""
    sd = reference_state_dict(torch, snapshot_dir)
    for stage in ("Desc", "Pose"):
        os.makedirs(os.path.join(out_dir, stage), exist_ok=True)
        torch.save(sd, os.path.join(out_dir, stage, "best.pth"))
    return out_dir


def _sha16(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def run_offline_tools(torch, cuda_build, reg, se3, dev, cfg_s, pairs,
                      poses_4b):
    """Phase 13: the offline tools at full width (see the module notes).
    Returns (launches by run, what it measured, kernel entries)."""
    import shutil
    import tempfile

    from bufferx_tpu_torch.config import make_cfg
    from bufferx_tpu_torch.data.base import read_trajectory_log
    from bufferx_tpu_torch.data.datasets import get_dataset
    from bufferx_tpu_torch.data.io import read_points
    from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
    from bufferx_tpu_torch.tools import bench_scaling
    from bufferx_tpu_torch.tools import evaluate as tev
    from bufferx_tpu_torch.tools import import_reference_checkpoint as imp
    from bufferx_tpu_torch.tools import scannetpp, tsdf
    from bufferx_tpu_torch.tools.weights import (
        load_snapshot,
        load_snapshot_config,
        msgpack_dumps,
        msgpack_restore,
    )

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="bufferx_offline_")
    out_dir = os.path.join(HERE, "chiprun_out", "offline")
    launches, measured, entries = {}, {}, []
    try:
        # ---- (a) ScanNet++ iPhone preprocessing at the reference's sizes
        iphone_root = os.path.join(root, "iphone")
        scene_root = os.path.join(iphone_root, "scene0")
        t0 = time.perf_counter()
        write_iphone_scene(scene_root)
        scene_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = scannetpp.prepare_scene(scene_root,
                                        pair_kw=dict(keep_prob=1.0),
                                        device=dev)
        prep_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        layout = scannetpp.SceneLayout(scene_root)
        plys = [os.path.join(layout.tsdf_dir, f"cloud_bin_{i}.ply")
                for i in range(stats["fragments"])]
        points = [len(read_points(f)) for f in plys]
        log_rows, log_poses = read_trajectory_log(
            os.path.join(layout.iphone_dir, "gt.log"))
        gt_pairs = [[int(i), int(j)] for i, j, _n in log_rows]
        hashes = [_sha16(f) for f in plys]
        jax_log, log_err = jax_gt_log(layout, log_rows, log_poses)
        jax_log_hash = hashlib.sha256(jax_log).hexdigest()[:16]
        frag_s = stats["seconds"]["fragments"] / max(stats["fragments"], 1)
        log(f"offline (a): scene of {IPHONE_FRAMES} frames written in "
            f"{scene_s:.1f} s; prepare_scene {prep_s:.1f} s (extract "
            f"{stats['seconds']['extract']:.1f} s, fragments "
            f"{stats['seconds']['fragments']:.1f} s = {frag_s:.2f} s a "
            f"fragment with extraction and the PLY write, pairs "
            f"{stats['seconds']['pairs']:.1f} s); {stats['fragments']} "
            f"fragments of {points} points (JAX package: "
            f"{JAX_IPHONE['points']}), pairs {gt_pairs} (JAX: "
            f"{JAX_IPHONE['gt_pairs']}); peak {peak / 2**30:.2f} GiB "
            f"allocated ({(peak - base_mem) / 2**30:.2f} GiB above the "
            f"{base_mem / 2**30:.2f} GiB held before); PLY bytes equal to "
            f"JAX's: {hashes == JAX_IPHONE['ply_sha256']}; gt.log poses "
            f"the inverses of the JAX log's within {log_err:.2e} (that log "
            f"rebuilt: sha256 {jax_log_hash}, JAX's "
            f"{JAX_IPHONE['gt_log_sha256']})")
        if stats["depth_frames"] != IPHONE_FRAMES or \
                stats["fragments"] != JAX_IPHONE["fragments"]:
            raise AssertionError(f"offline (a): {stats}")
        if gt_pairs != JAX_IPHONE["gt_pairs"] or \
                stats["pairs"] != JAX_IPHONE["pairs"]:
            raise AssertionError(f"offline (a): accepted pairs {gt_pairs}, "
                                 f"the JAX package's {JAX_IPHONE['gt_pairs']}")
        for got_n, want_n in zip(points, JAX_IPHONE["points"]):
            if abs(got_n - want_n) > IPHONE_POINT_TOL * want_n:
                raise AssertionError(f"offline (a): fragment points "
                                     f"{points}, the JAX package's "
                                     f"{JAX_IPHONE['points']}")
        if jax_log_hash != JAX_IPHONE["gt_log_sha256"] or \
                log_err > IPHONE_LOG_TOL:
            raise AssertionError(
                f"offline (a): gt.log poses {log_err:.2e} from the inverses "
                f"of the JAX log's (rebuilt with sha256 {jax_log_hash}, "
                f"JAX's {JAX_IPHONE['gt_log_sha256']})")

        # the card against the CPU on the first 2 frames at the full grid
        def frame(t):
            depth = np.load(os.path.join(
                layout.depth_dir, f"frame_{t:06d}.depth.npy")).astype(
                    np.float32) / 1000.0
            pose = np.loadtxt(os.path.join(layout.pose_dir,
                                           f"frame_{t:06d}.pose.txt"))
            return depth, pose

        k = np.loadtxt(os.path.join(layout.intrinsic_dir,
                                    "frame_000000.intrinsic.txt"))
        frames = [frame(t) for t in range(IPHONE_TIMED_FRAMES)]
        base_inv = np.linalg.inv(frames[0][1])
        g = IPHONE_GRID
        vols = {}
        for d in (dev, torch.device("cpu")):
            vol = tsdf.make_volume(g["origin"], g["dims"], g["voxel"],
                                   device=d)
            for depth, pose in frames[:2]:
                tsdf.integrate_frame(vol, k, base_inv @ pose, depth)
            vols[d.type] = vol
        flips = int((vols["cuda"].tsdf.cpu() != vols["cpu"].tsdf).sum()
                    + (vols["cuda"].weight.cpu() != vols["cpu"].weight).sum())
        log(f"offline (a): card vs CPU after 2 frames at "
            f"{g['dims']} voxels: {flips} values differ (tsdf and weight)")
        if flips > IPHONE_CARD_CPU_FLIPS:
            raise AssertionError(f"offline (a): the card's volume differs "
                                 f"from the CPU's in {flips} values")
        vol = vols["cuda"]
        del vols

        # ms a frame with CUDA events, the first fragment's frames
        tsdf.reset_volume(vol)
        ms = []
        for depth, pose in frames:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tsdf.integrate_frame(vol, k, base_inv @ pose, depth)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        n_vox = int(np.prod(g["dims"]))
        frame_bound = bound_ms(4 * 4.0 * n_vox, 0.0)
        del vol
        measured["iphone"] = dict(
            frames=stats["depth_frames"], fragments=stats["fragments"],
            points=points, jax_points=JAX_IPHONE["points"],
            pairs=gt_pairs, jax_pairs=JAX_IPHONE["gt_pairs"],
            ply_bytes_equal_jax=hashes == JAX_IPHONE["ply_sha256"],
            gt_log_inverse_of_jax_max_err=log_err,
            jax_gt_log_rebuilt_sha256=jax_log_hash,
            card_cpu_values_differing=flips,
            integrate_ms_median=float(np.median(ms)),
            integrate_ms_mean=float(np.mean(ms)),
            integrate_ms_min=float(np.min(ms)),
            integrate_bound_ms=frame_bound[0],
            integrate_bound_by=frame_bound[1],
            seconds_a_fragment=frag_s, stage_seconds=stats["seconds"],
            prepare_scene_seconds=prep_s, scene_write_seconds=scene_s,
            peak_allocated_gib=peak / 2**30,
            peak_above_before_gib=(peak - base_mem) / 2**30)
        log(f"offline (a): integrate_frame {np.median(ms):.3f} ms a frame "
            f"(median of {len(ms)}, min {np.min(ms):.3f}, mean "
            f"{np.mean(ms):.3f}) against a bound of {frame_bound[0]:.3f} ms "
            f"({frame_bound[1]}: both volumes read and written)")

        # ---- (b) the fragments through tools/evaluate.py ----------------
        inv_root = gt_log_inverted(layout.iphone_dir,
                                   os.path.join(root, "iphone_jax"))
        n = stats["pairs"]
        cli = {}
        for label, data_root in (("as_written", iphone_root),
                                 ("jax_direction", inv_root)):
            cuda_build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = tev.run(["--dataset", "Scannetpp_iphone", "--root",
                               data_root, "--checkpoint-dir", SNAPSHOT,
                               "--out-dir", out_dir, "--experiment-id",
                               f"iphone_{label}"], log=lambda *_: None)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = {kk: kr.launches for kk, kr in cuda_build.KERNELS.items()}
            launches[f"iphone_{label}"] = got
            want = with_derived(dict({kk: 0 for kk in got}, fps=n, strat=n,
                                      moments=3 * n))
            rows = summary["rows"]
            successes = sum(r["success"] for r in rows)
            jax_count = JAX_IPHONE["successes"][IPHONE_LOGS[label]]
            # the harness's means leave out its first 5 pairs (the
            # reference's warm-up): the rows' own times, the first pair's
            # aside
            cli[label] = dict(
                successes=successes, jax_successes=jax_count,
                pairs=summary["num_pairs"],
                rte=[float(r["rte"]) for r in rows],
                rre=[float(r["rre"]) for r in rows],
                model_ms_a_pair=float(np.median(
                    [r["model_time"] for r in rows[1:]])) * 1e3,
                data_ms_a_pair=float(np.median(
                    [r["data_time"] for r in rows[1:]])) * 1e3,
                seconds=seconds, launches=got)
            log(f"offline (b), tools/evaluate.py Scannetpp_iphone, gt.log "
                f"{label.replace('_', ' ')}: {successes}/"
                f"{summary['num_pairs']} successes (JAX package: "
                f"{jax_count}), RRE {[round(x, 2) for x in cli[label]['rre']]}"
                f" deg, model {cli[label]['model_ms_a_pair']:.1f} ms a pair, "
                f"data stall {cli[label]['data_ms_a_pair']:.1f} ms a pair, "
                f"{seconds:.1f} s in all, launches {got}")
            if got != want:
                raise AssertionError(f"offline (b) {label}: launches {got}, "
                                     f"expected {want}")
            if summary["num_pairs"] != n or successes < jax_count - 1:
                raise AssertionError(
                    f"offline (b) {label}: {successes} successes of "
                    f"{summary['num_pairs']} < the JAX package's "
                    f"{jax_count} - 1")
        measured["iphone_evaluate"] = cli
        # K1-K3 at the shapes the evaluation gives them: one pair of
        # fragments, loaded and capped as tools/evaluate.py loads them
        cfg_i = make_cfg("Scannetpp_iphone", iphone_root).override(
            patch=load_snapshot_config(SNAPSHOT))
        sample = get_dataset(cfg_i)[0]
        pair_i = [reg.prepare_cloud(sample[key], cfg_i, seed=s, device=dev)
                  for s, key in enumerate(("src_points", "tgt_points"))]
        e_iphone, _ = batch_kernel_entries(
            torch, reg, cfg_i, pair_i[:1], pair_i[1:], dev,
            "iphone_as_written",
            f"ScanNet++ iPhone fragments, 1 pair (2 clouds of "
            f"{cfg_i.capacity.max_points} points)")
        entries += e_iphone

        # ---- (c) the reference weights through the importer -------------
        ref_dir = write_reference_snapshot(torch, SNAPSHOT_SAMPLED,
                                           os.path.join(root, "ref_hard"))
        imp_dir = os.path.join(root, "imported_hard")
        t0 = time.perf_counter()
        if imp.main(["--src", ref_dir, "--out", imp_dir]) != 0:
            raise AssertionError("offline (c): the importer refused "
                                 "snapshot/hard")
        import_s = time.perf_counter() - t0
        byte_equal, sorted_equal = [], []
        for stage in ("Desc", "Pose"):
            with open(os.path.join(imp_dir, stage, "best.msgpack"), "rb") as f:
                got_b = f.read()
            with open(os.path.join(SNAPSHOT_SAMPLED, stage, "best.msgpack"),
                      "rb") as f:
                want_b = f.read()
            got_t, want_t = msgpack_restore(got_b), msgpack_restore(want_b)

            def leaves(tree, prefix=""):
                for kk, v in tree.items():
                    if isinstance(v, dict):
                        yield from leaves(v, prefix + "/" + kk)
                    else:
                        yield prefix + "/" + kk, v

            got_l, want_l = dict(leaves(got_t)), dict(leaves(want_t))
            if sorted(got_l) != sorted(want_l) or any(
                    got_l[kk].dtype != want_l[kk].dtype
                    or not np.array_equal(got_l[kk], want_l[kk])
                    for kk in want_l):
                raise AssertionError(f"offline (c): imported {stage} arrays "
                                     "differ from snapshot/hard's")

            def sort(tree):
                return {kk: sort(tree[kk]) for kk in sorted(tree)} \
                    if isinstance(tree, dict) else tree

            byte_equal.append(got_b == want_b)
            sorted_equal.append(msgpack_dumps(sort(got_t)) == want_b)
        if not all(sorted_equal):
            raise AssertionError("offline (c): the imported trees in pytree "
                                 "key order are not snapshot/hard's bytes")
        log(f"offline (c): snapshot/hard as reference .pth files imported "
            f"in {import_s:.2f} s: every array equal; files byte-equal "
            f"{byte_equal} (the importer writes the reference's module "
            f"order, as the JAX importer does), byte-equal in pytree key "
            f"order {sorted_equal}")
        statics_s = reg.PipelineStatics.from_config(cfg_s)
        models_imp = reg.build_models(statics_s, load_snapshot(imp_dir), dev)
        poses_imp = []
        launches["imported"] = run_path(torch, reg, se3, cuda_build,
                                        "sampled", cfg_s, models_imp, pairs,
                                        poses=poses_imp)
        equal = all(torch.equal(a, b) for a, b in zip(poses_imp, poses_4b))
        d_rte = max(float(se3.compute_rte(a, b))
                    for a, b in zip(poses_imp, poses_4b))
        d_rre = max(float(se3.compute_rre(a, b))
                    for a, b in zip(poses_imp, poses_4b))
        log(f"offline (c): imported snapshot/hard on phase 4b's "
            f"{len(pairs)} pairs: poses equal to phase 4b's: {equal} (at "
            f"most {d_rte:.2e} m, {d_rre:.2e} deg apart)")
        if len(poses_imp) != len(poses_4b) or not equal and (
                d_rte > 1e-5 or d_rre > 1e-4):
            raise AssertionError("offline (c): the imported weights register "
                                 "phase 4b's pairs otherwise")
        measured["import"] = dict(
            seconds=import_s, arrays_equal=True, bytes_equal=byte_equal,
            bytes_equal_in_pytree_order=sorted_equal, poses_equal=equal,
            max_rte_m=d_rte, max_rre_deg=d_rre)

        # ---- (d) tools/bench_scaling.py at world size 1 ----------------
        t0 = time.perf_counter()
        bench = bench_scaling.run(["--checkpoint-dir",
                                   os.path.join(HERE, "snapshot",
                                                "synthetic")])
        bench_s = time.perf_counter() - t0
        r = bench[0]
        launches["bench_scaling"] = r["launches"]
        log(f"offline (d): tools/bench_scaling.py at world size 1: "
            f"{r['line']} ({r['pairs']} pairs in {r['seconds'] * 1e3:.1f} ms "
            f"a run), {bench_s:.1f} s in all, launches a run "
            f"{r['launches']}")
        if r["line"]["mesh"] != 1 or \
                r["launches"] != BENCH_LAUNCHES:
            raise AssertionError(f"offline (d): {r['line']}, launches "
                                 f"{r['launches']}, expected "
                                 f"{BENCH_LAUNCHES} at world size 1")
        if not bool(torch.isfinite(r["pose"]).all()):
            raise AssertionError("offline (d): a pose is not finite")
        measured["bench_scaling"] = dict(
            line=r["line"], pairs=r["pairs"], seconds_a_run=r["seconds"],
            seconds=bench_s, launches=r["launches"])
        # its batch: pair i from RandomState(i), 24000 points, seed i
        cfg_b = bench_scaling.bench_config(False)
        b_src, b_tgt = [], []
        for i in range(r["pairs"]):
            s_i, t_i, _ = synthetic_pair_full_overlap(
                np.random.RandomState(i), num_points=24000)
            b_src.append(reg.prepare_cloud(s_i, cfg_b, seed=i, device=dev))
            b_tgt.append(reg.prepare_cloud(t_i, cfg_b, seed=i, device=dev))
        e_bench, _ = batch_kernel_entries(
            torch, reg, cfg_b, b_src, b_tgt, dev, "bench_scaling",
            f"bench_scaling batch, {2 * r['pairs']} clouds of 24000 points",
            patch_kernel="cell_query")
        entries += e_bench
    finally:
        shutil.rmtree(root, ignore_errors=True)
    measured["seconds"] = time.perf_counter() - t_phase
    log(f"offline tools phase: {measured['seconds']:.1f} s")
    return launches, measured, entries


# ---- phase 3b: the conv layers' serving epilogue ---------------------------

def run_conv_epilogue(torch, cuda_build, reg, dev, statics, models, pre8,
                      draws8, pair, statics_s, models_s, pairs_s):
    """Phase 3b (module notes): the serving epilogue against its plain
    version on every layer of one scale's pass, at the batch of 8 and one
    pair on the moments path and two pairs on the sampled + fused path;
    the nets' outputs through the kernel against the plain route and the
    eager chain; the launches of a pass. Returns (launches by pass, kernel
    entries, whose launches are those of phase 4's path)."""
    import contextlib

    import torch.nn.functional as F

    from bufferx_tpu_torch.kernels import conv_epilogue as ce
    from bufferx_tpu_torch.models import heads, layers, spinnet
    from bufferx_tpu_torch.tools.bench_strat import time_ms

    bf16 = torch.bfloat16
    rows, owner, case = {}, {}, {"name": None}

    def conv_out(layer, args, kwargs):
        """The layer's conv (or matmul) output as its forward makes it."""
        ws, _const = layer.serving_state()
        kw = {}
        if isinstance(layer, heads.FactoredCostStem):
            d1 = args[0].to(bf16)
            a_in = torch.cat([d1[..., -2:], d1, d1[..., :2]], dim=-1)
            return (F.conv2d(a_in, ws[0]).contiguous(),
                    F.conv2d(args[1].to(bf16), ws[1]).contiguous(), kw)
        if isinstance(layer, spinnet.PointwiseStem):
            x = args[0]
            if isinstance(layer, spinnet.MomentsMajorStem):
                x = x.transpose(1, 2)
            kw = dict(channel_dim=-1, grid=kwargs.get("grid"))
            return torch.matmul(x.to(bf16), ws[0]).contiguous(), None, kw
        conv = F.conv2d if len(layer.kernel) == 2 else F.conv3d
        return conv(args[0].to(bf16), ws[0]), None, kw

    def check(layer, args, kwargs):
        if case["name"] is None:
            return
        out = kwargs.get("out", "f32")
        y, c2d, kw = conv_out(layer, args, kwargs)
        const = layer.serving_state()[1]

        def kernel():
            return ce.conv_epilogue_cuda(y, const, out, c2d=c2d, **kw)

        def plain():
            return ce.conv_epilogue_plain(y, const, out, c2d=c2d, **kw)

        got, want = kernel(), plain()
        what = f"{type(layer).__name__} {out} {list(y.shape)}"
        if got.dtype != want.dtype or not torch.equal(got, want):
            bad = int((got.float() != want.float()).sum())
            raise AssertionError(f"conv_epilogue, {case['name']}, {what}: "
                                 f"{bad} of {want.numel()} entries differ "
                                 "from the plain version")
        key = (case["name"], owner[layer], args[0].shape[0])
        row = rows.setdefault(key, dict(layers=[], ms=0.0, plain_ms=0.0,
                                        nbytes=0))
        nbytes = (y.numel() + (0 if c2d is None else c2d.numel())) * 2 + \
            got.numel() * got.element_size()
        # launches back to back, so that the wrapper's host time overlaps
        # the card's work where a launch takes longer than it
        ms = time_ms(lambda: [kernel() for _ in range(EPILOGUE_REPS)], 3) / \
            EPILOGUE_REPS
        row["layers"].append(f"{what} -> {list(got.shape)}: {ms:.4f} ms, "
                             f"bound {nbytes / PEAK_BYTES_PER_S * 1e3:.4f}")
        row["ms"] += ms
        row["plain_ms"] += time_ms(plain, 3)
        row["nbytes"] += nbytes

    hooks = []
    for net_name, mdl in (("moments", models), ("sampled", models_s)):
        for part in ("desc", "pose"):
            for m in getattr(mdl, part).modules():
                if isinstance(m, layers.ConvBNRelu):
                    owner[m] = part
                    hooks.append(m.register_forward_pre_hook(
                        check, with_kwargs=True))

    def add_entries(label, path, match):
        for (name, part, n), row in rows.items():
            if name != label:
                continue
            entries.append(dict(
                name="conv_epilogue", path=path,
                case=f"{label}, {part} net, {n} "
                     f"{'patches' if part == 'desc' else 'matches'}",
                match="every layer torch.equal to the plain version; " + match,
                max_abs_err=0.0, ms=row["ms"], plain_ms=row["plain_ms"],
                bound=(row["nbytes"] / PEAK_BYTES_PER_S * 1e3, "bytes"),
                library_ms=None, shapes="; ".join(row["layers"]),
                extra=dict(layers=len(row["layers"]), bytes=row["nbytes"])))
            log(f"conv_epilogue, {entries[-1]['case']}: "
                f"{len(row['layers'])} layers, kernel {row['ms']:.3f} ms, "
                f"plain {row['plain_ms']:.3f} ms, bound "
                f"{entries[-1]['bound'][0]:.4f} ms (bytes)")

    @contextlib.contextmanager
    def plain_route():
        """The nets with the plain version in the kernel's place."""
        mods = (layers, spinnet, heads)
        saved = [m.conv_epilogue for m in mods]
        for m in mods:
            m.conv_epilogue = ce.conv_epilogue_plain
        try:
            yield
        finally:
            for m, f in zip(mods, saved):
                m.conv_epilogue = f

    @contextlib.contextmanager
    def eager_route():
        """The nets as the layers run them off the card: the eager chain."""
        on_card = layers._on_card
        layers._on_card = lambda _t: False
        try:
            yield
        finally:
            layers._on_card = on_card

    def capture(net, box, name):
        return net.register_forward_pre_hook(
            lambda _m, a: box.setdefault(name, a))

    def stack(clouds):
        return reg.stack_clouds(list(clouds))

    draws1 = reg.make_draws(statics, torch.Generator().manual_seed(1), dev,
                            batch=1)
    pre1 = reg._precompute(statics, stack([pair[0]]), stack([pair[1]]),
                           draws1, (0,))
    draws_s = reg.make_draws(statics_s, torch.Generator().manual_seed(2), dev,
                             batch=len(pairs_s))
    pre_s = reg._precompute(statics_s, stack(p[0] for p in pairs_s),
                            stack(p[1] for p in pairs_s), draws_s, (0,))
    runs = [("moments B=8", models, statics, pre8, draws8, 21),
            ("moments B=1", models, statics, pre1, draws1, 21),
            (f"sampled B={len(pairs_s)}", models_s, statics_s, pre_s, draws_s,
             3 + 10)]
    launches, entries = {}, []
    try:
        for label, mdl, st, pre, draws, per_pass in runs:
            # the launches of one scale's pass, and the nets' inputs
            inputs = {}
            caps = [capture(mdl.desc, inputs, "desc"),
                    capture(mdl.pose, inputs, "pose")]
            torch.cuda.synchronize()
            cuda_build.reset_launch_counts()
            eager_before = ce.eager_serving_forwards
            reg._scale_candidates(mdl, st, pre, draws, 0, 0, False)
            torch.cuda.synchronize()
            for h in caps:
                h.remove()
            counts = {n: kk.launches for n, kk in cuda_build.KERNELS.items()}
            path = "epilogue_" + label.replace(" ", "_").replace("=", "")
            launches[path] = counts
            if counts["conv_epilogue"] != per_pass or \
                    ce.eager_serving_forwards != eager_before:
                raise AssertionError(
                    f"conv_epilogue, {label}: {counts['conv_epilogue']} "
                    f"launches a pass (expected {per_pass}), "
                    f"{ce.eager_serving_forwards - eager_before} conv "
                    "forwards served by the eager chain (expected 0)")
            # every layer against the plain version, timed
            case["name"] = label
            with torch.no_grad():
                got = (mdl.desc(*inputs["desc"]), mdl.pose(*inputs["pose"]))
            case["name"] = None
            # the nets through the kernel against the plain route and the
            # eager chain
            want = {}
            for route, ctx in (("plain route", plain_route),
                               ("eager chain", eager_route)):
                with torch.no_grad(), ctx():
                    want[route] = (mdl.desc(*inputs["desc"]),
                                   mdl.pose(*inputs["pose"]))
            torch.cuda.synchronize()
            for route, (w_desc, w_ind) in want.items():
                same = [torch.equal(got[0][k], w_desc[k])
                        for k in ("desc", "equi")] + [torch.equal(got[1],
                                                                  w_ind)]
                if not all(same):
                    raise AssertionError(
                        f"conv_epilogue, {label}: desc, equi, ind equal to "
                        f"the {route}: {same}")
            log(f"conv_epilogue, {label}: {per_pass} launches a pass, no "
                f"eager-served conv forward; desc {list(got[0]['desc'].shape)}"
                f", equi, ind {list(got[1].shape)} equal to the "
                f"{' and the '.join(want)}")
            # launches: phase 4's run of the pass's path
            add_entries(label, label.split()[0], "desc, equi and ind equal "
                        "to the plain route's and the eager chain's")
    finally:
        for h in hooks:
            h.remove()
    return launches, entries


# ---- phase 3c: the hypothesis scoring ---------------------------------------
# flops a scored (hypothesis, correspondence): the rotation (3 products, 6
# fused multiply-adds), the translation and the difference (6), the squared
# norm (3 products, 2 sums), the compare and the count
HYP_FLOPS = 28
# hypotheses of the outdoor preset's solve (kitti.lidar.b8)
KITTI_HYPOTHESES = 50000
# launches a timing of the kernel; of its plain version
HYP_REPS, HYP_PLAIN_REPS = 20, 3


def run_hyp_score(torch, reg, dev, statics, models, src8, tgt8, draws8):
    """Phase 3c (module notes): K6 against its plain version on the real
    candidates of a registered batch of 8, at the cells' shapes: RANSAC at
    H = 8192 on scale 0's 1500 correspondences and on all scales' 4500, at
    H = 50000 on 4500, at B = 1 on 4500, the consensus at C x C; counts
    ``torch.equal``, the kernel's distances equal to the eager chain's;
    kernel, plain and bound ms. Returns the kernel entries (their launches
    are phase 4's)."""
    from bufferx_tpu_torch.kernels import hyp_score as hs
    from bufferx_tpu_torch.solver.consensus import cross_scale_consensus
    from bufferx_tpu_torch.solver.ransac import hypotheses
    from bufferx_tpu_torch.tools.bench_strat import time_ms

    scales = tuple(range(statics.num_scales))
    with torch.no_grad():
        cands = reg._batch_candidates(models, statics, src8, tgt8, draws8,
                                      scales, False)
    gen = torch.Generator().manual_seed(1300)
    kitti_draws = torch.randint(0, 1 << 30, (BATCH, KITTI_HYPOTHESES, 3),
                                generator=gen).to(dev)
    entries = []

    def thresholds(c):
        return (torch.linalg.norm(c.ss, dim=-1) * (np.pi / statics.azi_n)
                * statics.inlier_th)

    def pool_of(c):
        """The sampling pool ``_pool_and_solve`` gives RANSAC."""
        mask, _best, _n = cross_scale_consensus(
            c.Rc, c.tc, c.ss, c.tt, c.valid, azi_n=statics.azi_n,
            inlier_th=statics.inlier_th)
        return reg._sampling_pool(c, mask, torch.sum(c.valid, dim=1))

    def check(label, args, chunk):
        R, _t, src, _tgt, _thr, mask, gate = args
        got = hs.hyp_score_cuda(*args)
        want = hs.hyp_score_plain(*args, chunk)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hyp_score, {label}: "
                                 f"{int((got != want).sum())} counts differ "
                                 "from the plain version")
        b, h, c = R.shape[0], R.shape[1], src.shape[1]
        scored = float((gate.sum(1) * mask.sum(1)).sum())
        ms = time_ms(lambda: hs.hyp_score_cuda(*args), HYP_REPS)
        plain = time_ms(lambda: hs.hyp_score_plain(*args, chunk),
                        HYP_PLAIN_REPS)
        bound = bound_ms(0.0, HYP_FLOPS * b * h * c)
        bound_scored = bound_ms(0.0, HYP_FLOPS * scored)[0]
        log(f"hyp_score, {label}: counts equal, kernel {ms:.4f} ms, plain "
            f"{plain:.3f} ms, bound {bound[0]:.4f} ms (every pair), "
            f"{bound_scored:.4f} ms (the {scored:.0f} pairs the gate and the "
            f"mask leave), gated in {float(gate.float().mean()):.4f}, masked "
            f"in {float(mask.float().mean()):.4f}, splits "
            f"{hs.split_count(b, h, c, hs._sm_count(dev.index or 0))}")
        entries.append(dict(
            name="hyp_score", case=label, match="counts torch.equal",
            max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=None,
            bound=bound, shapes=f"R [{b}, {h}, 3, 3], C = {c}",
            extra=dict(bound_scored_ms=bound_scored,
                       gated_in=float(gate.float().mean()),
                       masked_in=float(mask.float().mean()))))

    every = reg._cat_candidates(cands)
    for label, c, draws in (
            ("RANSAC, mixed phase 1 (B = 8, H = 8192, C = 1500)", cands[0],
             draws8.ransac),
            ("RANSAC, mixed phase 2 (B = 8, H = 8192, C = 4500)", every,
             draws8.ransac),
            ("RANSAC, kitti phase 2 (B = 8, H = 50000, C = 4500)", every,
             kitti_draws),
            ("RANSAC, online (B = 1, H = 8192, C = 4500)",
             reg._Candidates(*(x[:1] for x in every)), draws8.ransac[:1])):
        R, t, ok = hypotheses(c.ss, c.tt, pool_of(c), c.valid, draws,
                              statics.dist_th, statics.similar_th)
        check(label, (R, t, c.ss, c.tt, statics.dist_th, c.valid, ok),
              statics.ransac_chunk)
        del R, t, ok
    for label, c in (("consensus, scale 0 (B = 8, C = 1500)", cands[0]),
                     ("consensus, all scales (B = 8, C = 4500)", every),
                     ("consensus, online (B = 1, C = 4500)",
                      reg._Candidates(*(x[:1] for x in every)))):
        check(label, (c.Rc, c.tc, c.ss, c.tt, thresholds(c), c.valid,
                      c.valid), 512)
    # the rounding order: every distance the kernel scores equals the eager
    # chain's, for the consensus's candidates and RANSAC's minimal sets
    R, t, _ok = hypotheses(every.ss, every.tt, every.valid, every.valid,
                           draws8.ransac[:, :256], statics.dist_th,
                           statics.similar_th)
    all_c = torch.ones_like(every.valid)
    for label, Rh, th in (("RANSAC", R, statics.dist_th),
                          ("consensus", every.Rc[:, :256].contiguous(),
                           thresholds(every))):
        tt = t if label == "RANSAC" else every.tc[:, :256].contiguous()
        dist = torch.full((BATCH, 256, all_c.shape[1]), float("nan"),
                          device=dev)
        hs.hyp_score_cuda(Rh, tt, every.ss, every.tt, th, all_c,
                          all_c[:, :256].contiguous(), dist=dist)
        eager = torch.linalg.norm(
            torch.einsum("bhij,bcj->bhci", Rh, every.ss) + tt[:, :, None, :]
            - every.tt[:, None], dim=-1)
        torch.cuda.synchronize()
        if not torch.equal(dist, eager):
            raise AssertionError(
                f"hyp_score, {label}: {int((dist != eager).sum())} of "
                f"{eager.numel()} distances differ from the eager chain's")
        log(f"hyp_score, {label}: all {eager.numel()} distances of 256 "
            "hypotheses equal to the eager chain's")
    return entries


# ---- phase 14: the last names of the port ----------------------------------
# (a): the flags of the mixed batch, pair by pair (True: a gravity-aligned
# pair), and how far a slot's pose may be from its flag's single-flag batch
# (m, degrees; the same draws give the same bits where every operation is
# pair by pair)
MIXED_FLAGS = (True, False, True, False)
MIXED_POINTS = 24000
MIXED_POSE_TOL = (1e-4, 0.01)
MIXED_LAUNCHES = with_derived({"fps": 2, "strat": 2, "moments": 4,
                                "cell_query": 0, "conv_stack": 0})
# (b): CylindricalUNet at the serving patch count (2 x 1500 keypoints), the
# patches the CPU runs beside the card in eval mode, the training batch;
# tolerances of tests/test_torch_models.py (LAYER_TOL, against the largest
# magnitude) and tests/test_torch_train_forward.py (GRAD_TOL, relative L2)
UNET_PATCHES = 3000
UNET_CPU_PATCHES = 300
UNET_TRAIN_PATCHES = 512
UNET_TOL = {"f32": 1e-5, "bf16": 3e-2}
UNET_GRAD_TOL = 1e-2
UNET_CHANNELS = ((16, 32), (32, 32), (32, 64), (64, 128), (128, 128),
                 (256, 64), (128, 32), (64, 32), (32, 32))


def gravity_pair(rs: np.random.RandomState, num_points: int):
    """``synthetic_pair_full_overlap``'s object and noise under a turn about
    z and a translation: a gravity-aligned pair. (src, tgt, T)."""
    from bufferx_tpu_torch.data.modelnet import synthetic_object

    obj = synthetic_object(rs, num_points)
    a = rs.uniform(0.0, 2.0 * np.pi)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                 [0.0, 0.0, 1.0]]
    T[:3, 3] = rs.uniform(-0.5, 0.5, 3)
    src = (obj + rs.randn(*obj.shape) * 0.002).astype(np.float32)
    tgt = (obj @ T[:3, :3].T + T[:3, 3]
           + rs.randn(*obj.shape) * 0.002).astype(np.float32)
    return src, tgt, T


def unet_tree(rs: np.random.RandomState) -> dict:
    """flax ``{params, batch_stats}`` of a ``CylindricalUNet`` (16 input
    channels, dim 32): kernels scaled by their fan in, BatchNorm scale,
    bias and running statistics away from their initial values."""
    params, stats = {}, {}
    for i, (cin, cout) in enumerate(UNET_CHANNELS):
        kshape = (3, 3, 3, cin, cout) if i == 0 else (3, 3, cin, cout)
        fan_in = int(np.prod(kshape[:-1]))
        params[f"ConvBNRelu_{i}"] = {
            "Conv_0": {"kernel": (rs.randn(*kshape) / np.sqrt(fan_in))
                       .astype(np.float32),
                       "bias": (rs.randn(cout) * 0.1).astype(np.float32)},
            "BatchNorm_0": {
                "scale": rs.uniform(0.5, 1.5, cout).astype(np.float32),
                "bias": (rs.randn(cout) * 0.1).astype(np.float32)}}
        stats[f"ConvBNRelu_{i}"] = {"BatchNorm_0": {
            "mean": (rs.randn(cout) * 0.1).astype(np.float32),
            "var": rs.uniform(0.5, 1.5, cout).astype(np.float32)}}
    return {"params": params, "batch_stats": stats}


def pose_diff(torch, a, b):
    """(translation difference m, rotation difference degrees) in float64,
    the angle from the skew part of a^T b (arccos of the trace loses
    1e-2 degrees to float32 rounding near the identity)."""
    a, b = a.double(), b.double()
    d = a[:3, :3].T @ b[:3, :3]
    w = torch.stack([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    ang = torch.atan2(0.5 * torch.linalg.norm(w),
                      0.5 * (torch.trace(d) - 1.0))
    return (float(torch.linalg.norm(a[:3, 3] - b[:3, 3])),
            float(torch.rad2deg(ang)))


def run_last_names(torch, cuda_build, reg, se3, dev, cfg, models, cloud):
    """Phase 14 (see the module notes): ``cfg``/``models`` the moments
    path's, ``cloud`` phase 4's first source cloud. Returns (launches by
    run, what it measured, kernel entries)."""
    from bufferx_tpu_torch.core.se3 import random_rotation
    from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
    from bufferx_tpu_torch.eval.harness import evaluate_pairs_batched
    from bufferx_tpu_torch.kernels import density_aware_radius
    from bufferx_tpu_torch.kernels.fps import fps
    from bufferx_tpu_torch.models.layers import CylindricalUNet
    from bufferx_tpu_torch.tools.bench_strat import time_ms
    from bufferx_tpu_torch.tools.weights import UNET_MODULES, params_from_numpy

    t_phase = time.perf_counter()
    launches, measured = {}, {}

    # ---- (a) a batch whose pairs differ in is_aligned_to_global_z --------
    raw = []
    for i, flag in enumerate(MIXED_FLAGS):
        rs = np.random.RandomState(1400 + i)
        raw.append(gravity_pair(rs, MIXED_POINTS) if flag else
                   synthetic_pair_full_overlap(rs, num_points=MIXED_POINTS))
    srcs = [reg.prepare_cloud(p[0], cfg, seed=i, device=dev)
            for i, p in enumerate(raw)]
    tgts = [reg.prepare_cloud(p[1], cfg, seed=i, device=dev)
            for i, p in enumerate(raw)]
    gts = [torch.from_numpy(p[2]).to(dev) for p in raw]
    flags = torch.tensor(MIXED_FLAGS, dtype=torch.bool, device=dev)
    cfg_all = cfg.override(match=dict(early_exit_min_inliers=10 ** 6))
    statics = reg.PipelineStatics.from_config(cfg_all)
    gen = torch.Generator().manual_seed(1400)
    draws = [tuple(reg.make_draws(statics, gen, dev, batch=len(raw))
                   for _phase in range(2))]

    def batched(aligned):
        return reg.register_pairs_batched(
            cfg_all, srcs, tgts, models, batch_size=len(raw), draws=draws,
            is_aligned=aligned, device=dev)

    batched(flags)                                         # warm-up
    runs = {}
    for label, aligned in (("mixed", flags), ("all_true", True),
                           ("all_false", False)):
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        out = batched(aligned)
        torch.cuda.synchronize()
        runs[label] = dict(out=out, seconds=time.perf_counter() - t0,
                           launches={n: kk.launches
                                     for n, kk in cuda_build.KERNELS.items()})
        if runs[label]["launches"] != MIXED_LAUNCHES:
            raise AssertionError(f"mixed flags ({label}): launches "
                                 f"{runs[label]['launches']}, expected "
                                 f"{MIXED_LAUNCHES}")
    launches["mixed_flags"] = runs["mixed"]["launches"]
    worst, bit_equal, successes, rows = (0.0, 0.0), True, 0, []
    for i, flag in enumerate(MIXED_FLAGS):
        got = runs["mixed"]["out"][i]
        ref = runs["all_true" if flag else "all_false"]["out"][i]
        other = runs["all_false" if flag else "all_true"]["out"][i]
        d_m, d_deg = pose_diff(torch, got.pose, ref.pose)
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        bit_equal &= equal
        worst = (max(worst[0], d_m), max(worst[1], d_deg))
        rte, rre, ok = pose_errors(se3, cfg, got.pose, gts[i])
        o_rte, o_rre, o_ok = pose_errors(se3, cfg, other.pose, gts[i])
        successes += ok
        rows.append(dict(flag=flag, rte=rte, rre=rre, success=ok,
                         vs_flag_batch_m=d_m, vs_flag_batch_deg=d_deg,
                         equal_bits=equal, other_flag_success=o_ok))
        log(f"mixed flags, slot {i} (flag {flag}): RTE {rte:.4f} m, RRE "
            f"{rre:.3f} deg, success {ok}; against the all-{flag} batch "
            f"{d_m:.2e} m, {d_deg:.2e} deg, equal bits {equal}; with the "
            f"other flag RTE {o_rte:.4f} m, RRE {o_rre:.3f} deg")
        if not bool(torch.isfinite(got.pose).all()) or \
                d_m > MIXED_POSE_TOL[0] or d_deg > MIXED_POSE_TOL[1]:
            raise AssertionError(f"mixed flags, slot {i}: {d_m:.2e} m, "
                                 f"{d_deg:.2e} deg from its flag's batch")
    if successes < len(MIXED_FLAGS) - 1:
        raise AssertionError(f"mixed flags: {successes} of "
                             f"{len(MIXED_FLAGS)} pairs register")
    src4, tgt4 = reg.stack_clouds(srcs), reg.stack_clouds(tgts)
    scales = tuple(range(statics.num_scales))

    def one_batch():
        return reg._register_batch(models, statics, src4, tgt4, draws[0][1],
                                   scales, flags)

    one_batch()
    syncs = sync_calls(torch, one_batch)
    log(f"mixed flags: {successes}/{len(MIXED_FLAGS)} successes; each slot "
        f"within {worst[0]:.2e} m / {worst[1]:.2e} deg of its flag's "
        f"batch (equal bits: {bit_equal}); {len(MIXED_FLAGS)} pairs in "
        f"{runs['mixed']['seconds'] * 1e3:.1f} ms mixed, "
        f"{runs['all_true']['seconds'] * 1e3:.1f} all True, "
        f"{runs['all_false']['seconds'] * 1e3:.1f} all False; launches "
        f"{launches['mixed_flags']}; the mixed batch through all scales "
        f"under the sync-debug mode: {len(syncs)} synchronizing calls "
        f"{sorted(set(syncs))}")
    if syncs:
        raise AssertionError("a mixed-flag batch makes the host wait for "
                             "the card")
    entries, _ = batch_kernel_entries(
        torch, reg, cfg_all, srcs, tgts, dev, "mixed_flags",
        f"mixed-flag batch, {2 * len(raw)} clouds of "
        f"{cfg.capacity.max_points} points, flags {list(MIXED_FLAGS)}",
        is_aligned=flags)
    samples = [dict(src_points=p[0], tgt_points=p[1], relt_pose=p[2],
                    src_id=f"s{i}", tgt_id=f"t{i}",
                    is_aligned_to_global_z=flag)
               for i, (p, flag) in enumerate(zip(raw, MIXED_FLAGS))]
    summary = evaluate_pairs_batched(cfg, samples, models,
                                     batch_size=len(samples), device=dev)
    h_succ = sum(r["success"] for r in summary["rows"])
    log(f"mixed flags, evaluate_pairs_batched at B = {len(samples)}: "
        f"{h_succ}/{summary['num_pairs']} successes, "
        f"{summary['pairs_per_second']:.2f} pairs/s")
    measured["mixed_flags"] = dict(
        flags=list(MIXED_FLAGS), slots=rows, successes=successes,
        worst_vs_flag_batch_m=worst[0], worst_vs_flag_batch_deg=worst[1],
        equal_bits=bit_equal, synchronizing_calls=len(syncs),
        seconds={k: r["seconds"] for k, r in runs.items()},
        launches=launches["mixed_flags"], harness_successes=h_succ,
        harness_pairs_per_s=summary["pairs_per_second"])
    del runs, src4, tgt4

    # ---- (b) CylindricalUNet on the card against the CPU -----------------
    sd = params_from_numpy(unet_tree(np.random.RandomState(1401)),
                           UNET_MODULES)
    x = torch.from_numpy(np.random.RandomState(1402).randn(
        UNET_PATCHES, 16, 3, 7, 20).astype(np.float32))
    x_dev = x.to(dev)
    unet = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        card = CylindricalUNet(compute_dtype=dt).to(dev).eval()
        card.load_state_dict(sd, strict=True)
        host = CylindricalUNet(compute_dtype=dt).eval()
        host.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got, none = card(x_dev)
            want, _ = host(x[:UNET_CPU_PATCHES])
        got_h = got.cpu()
        scale = max(1.0, float(want.abs().max()))
        err = float((got_h[:UNET_CPU_PATCHES] - want).abs().max())
        if none is not None or got.shape != (UNET_PATCHES, 32, 7, 20) or \
                not bool(torch.isfinite(got_h).all()) or \
                err > UNET_TOL[name] * scale:
            raise AssertionError(f"CylindricalUNet {name}: card against CPU "
                                 f"{err} > {UNET_TOL[name]} x {scale}")
        del got

        def forward(card=card):
            with torch.no_grad():
                return card(x_dev)

        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        forward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        ms = time_ms(forward, 10)
        unet[name] = dict(max_abs_err=err, scale=scale, ms=ms,
                          peak_above_before_gib=peak / 2 ** 30)
        log(f"CylindricalUNet {name}, eval, {UNET_PATCHES} patches: "
            f"{ms:.3f} ms a forward, peak {peak / 2 ** 30:.2f} GiB above "
            f"what was held; against the CPU on {UNET_CPU_PATCHES} patches "
            f"{err:.2e} (tolerance {UNET_TOL[name]} x {scale:.2f})")
    # train mode: the batch's statistics, forward and backward
    xt = x[:UNET_TRAIN_PATCHES]
    wt = torch.from_numpy(np.random.RandomState(1403).randn(
        UNET_TRAIN_PATCHES, 32, 7, 20).astype(np.float32))
    res = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m = CylindricalUNet().to(d).train()
        m.load_state_dict(sd, strict=True)
        out, _ = m(xt.to(d))
        torch.sum(out * wt.to(d)).backward()
        res[where] = (out.detach().cpu(),
                      {k: p.grad.cpu() for k, p in m.named_parameters()})
    fwd_l2 = _rel_l2({"out": res["cpu"][0]}, {"out": res["card"][0]},
                     ["out"])
    keys = sorted(res["cpu"][1])
    grad_l2 = _rel_l2(res["cpu"][1], res["card"][1], keys)
    log(f"CylindricalUNet f32, train, {UNET_TRAIN_PATCHES} patches, card "
        f"against CPU: forward {fwd_l2:.2e}, gradients {grad_l2:.2e} "
        f"relative L2 over {len(keys)} parameters")
    if fwd_l2 > UNET_GRAD_TOL or grad_l2 > UNET_GRAD_TOL:
        raise AssertionError("CylindricalUNet: train-mode card and CPU "
                             "disagree")
    unet["train"] = dict(forward_rel_l2=fwd_l2, grad_rel_l2=grad_l2)
    measured["unet"] = unet
    del x_dev, res

    # ---- (c) random_rotation and density_aware_radius -------------------
    gen_u = torch.Generator().manual_seed(1404)
    rot_err = 0.0
    for _ in range(4):
        u = torch.rand(3, generator=gen_u)
        for num_axis in (0, 1, 3):
            for magnitude in (1.0, 0.25):
                on_card = random_rotation(u.to(dev), num_axis, magnitude)
                if on_card.device.type != dev.type:
                    raise AssertionError("random_rotation left the card")
                rot_err = max(rot_err, float((on_card.cpu() - random_rotation(
                    u, num_axis, magnitude)).abs().max()))
    xyz, mask = cloud.xyz[None], cloud.mask[None]
    idx, valid = fps(xyz, mask, statics.num_probe)
    kpts = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
    r_card = density_aware_radius(xyz, mask, kpts, valid, statics.thresholds,
                                  statics.radius_max)
    r_cpu = density_aware_radius(xyz.cpu(), mask.cpu(), kpts.cpu(),
                                 valid.cpu(), statics.thresholds,
                                 statics.radius_max)
    r_diff = float((r_card.cpu() - r_cpu).abs().max())
    log(f"random_rotation card against CPU: {rot_err:.2e}; "
        f"density_aware_radius on phase 4's first cloud "
        f"({int(mask.sum())} points, {statics.num_probe} probes): card "
        f"{r_card.cpu().tolist()}, CPU {r_cpu.tolist()}")
    if rot_err > 1e-6 or r_diff > 0.01 + 1e-6:
        raise AssertionError("random_rotation or density_aware_radius: "
                             "card and CPU disagree")
    measured["names"] = dict(random_rotation_max_err=rot_err,
                             radii_card=r_card.cpu().tolist(),
                             radii_cpu=r_cpu.tolist())
    measured["seconds"] = time.perf_counter() - t_phase
    log(f"last names phase: {measured['seconds']:.1f} s")
    return launches, measured, entries


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "bufferx_tpu_torch")):
        log("chip_smoke: bufferx_tpu_torch/ is not beside this script")
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this run needs "
            "an NVIDIA card")
        return 2

    from bufferx_tpu_torch import cuda_build
    from bufferx_tpu_torch.config import make_cfg
    from bufferx_tpu_torch.core import se3
    from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
    from bufferx_tpu_torch.geometry import spt_pallas
    from bufferx_tpu_torch.geometry.cylindrical import (
        grid_cell_centers,
        spatial_point_transformer,
    )
    from bufferx_tpu_torch.geometry.lrf import align_patches
    from bufferx_tpu_torch.kernels import conv_pallas
    from bufferx_tpu_torch.kernels import fps as fps_mod
    from bufferx_tpu_torch.kernels import strat_pallas
    from bufferx_tpu_torch.models import layers
    from bufferx_tpu_torch.models.layers import CylindricalConvNet
    from bufferx_tpu_torch.pipeline import registration as reg
    from bufferx_tpu_torch.tools import bench_strat
    from bufferx_tpu_torch.tools.bench_strat import time_ms
    from bufferx_tpu_torch.tools.weights import (
        load_snapshot,
        load_snapshot_config,
    )

    dev = torch.device("cuda")
    # ---- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build ---------------------------------------------------------
    build_s = cuda_build.build_all()
    log(f"kernels built in {build_s:.1f} s")
    for k in cuda_build.KERNELS.values():
        for line in k.ptxas_log.splitlines():
            if "C7519" in line:    # ptxas adds a wgmma fence: information only
                continue
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{k.name}]: {line.strip()}")
            if k.name in ("conv_stack", "cell_query", "moments") and \
                    "spill" in line and \
                    "0 bytes spill stores, 0 bytes spill loads" not in line:
                raise AssertionError(f"{k.name} spills: {line.strip()}")

    # ---- both paths' configurations and the pairs -------------------------
    cfg = make_cfg("ModelNet40").override(patch=dict(desc_mode="moments"))
    cfg = cfg.override(patch=load_snapshot_config(SNAPSHOT))
    statics = reg.PipelineStatics.from_config(cfg)
    log(f"statics: {statics}")
    models = reg.build_models(statics, load_snapshot(SNAPSHOT), dev)
    # snapshot/hard has no config.json: the default desc_mode="sampled"
    cfg_s = make_cfg("ModelNet40").override(
        patch=dict(load_snapshot_config(SNAPSHOT_SAMPLED), fused_conv=True))
    statics_s = reg.PipelineStatics.from_config(cfg_s)
    sd_s = load_snapshot(SNAPSHOT_SAMPLED)
    models_s = reg.build_models(statics_s, sd_s, dev)
    if statics_s.desc_mode != "sampled" or not models_s.desc.fused:
        raise AssertionError("the sampled path did not configure the fused "
                             "conv stack")
    pairs16 = []
    for i in range(NUM_BATCHED_PAIRS):
        s, t, T = synthetic_pair_full_overlap(np.random.RandomState(i),
                                              num_points=24000)
        pairs16.append((reg.prepare_cloud(s, cfg, seed=i, device=dev),
                        reg.prepare_cloud(t, cfg, seed=i, device=dev),
                        torch.from_numpy(T).to(dev)))
    pairs = pairs16[:NUM_PAIRS]

    # ---- 3. kernels against their plain versions at their paths' shapes ---
    # a batch of 8 pairs' precomputation: clouds 0-7 are the sources, 8-15
    # the targets; clouds 0 and 8 are the first pair
    src, tgt, _ = pairs[0]
    draws8 = reg.make_draws(statics, torch.Generator().manual_seed(0), dev,
                            batch=BATCH)
    src8 = reg.stack_clouds([p[0] for p in pairs16[:BATCH]])
    tgt8 = reg.stack_clouds([p[1] for p in pairs16[:BATCH]])
    pre = reg._precompute(statics, src8, tgt8, draws8,
                          tuple(range(statics.num_scales)), keep_d2=True)
    torch.cuda.synchronize()
    nf, S = statics.num_fps, statics.patch_sample
    first = [0, BATCH]          # the first pair's two clouds
    pre_radii = pre.radii[0]
    pre_kpts = torch.cat([pre.kpts[c] for c in first])

    def pair_patches(scale):
        return (torch.cat([pre.patches[c, scale] for c in first]),
                torch.cat([pre.pvalid[c, scale] for c in first]))

    kernels = []

    # ---- 3b. the conv layers' serving epilogue ----------------------------
    launches_3b, epilogue_kernels = run_conv_epilogue(
        torch, cuda_build, reg, dev, statics, models, pre, draws8, pairs[0],
        statics_s, models_s, pairs16[:2])
    kernels.extend(epilogue_kernels)

    # ---- 3c. the hypothesis scoring ---------------------------------------
    kernels.extend(run_hyp_score(torch, reg, dev, statics, models, src8,
                                 tgt8, draws8))

    # K1: both clouds, num_probe rounds
    xyz2 = torch.stack([src.xyz, tgt.xyz])
    mask2 = torch.stack([src.mask, tgt.mask])
    k = statics.num_probe
    got = fps_mod.farthest_point_sampling_cuda(xyz2, mask2, k)
    want = fps_mod.farthest_point_sampling_plain(xyz2, mask2, k)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"fps: {int((got != want).sum())} indices differ from the plain version")
    for label, e_xyz, e_mask, e_k in fps_edge_cases():
        e_xyz = torch.from_numpy(e_xyz).to(dev)
        e_mask = torch.from_numpy(e_mask).to(dev)
        got = fps_mod.farthest_point_sampling_cuda(e_xyz, e_mask, e_k)
        want = fps_mod.farthest_point_sampling_plain(e_xyz, e_mask, e_k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"fps, {label}: {int((got != want).sum())} indices differ "
                "from the plain version")
        log(f"fps, {label}: xyz {list(e_xyz.shape)}, {e_k} rounds, indices "
            "exact")
    b, n = mask2.shape
    bnd = bound_ms(b * n * 13 + b * k * 4, 9.0 * b * k * n)
    # the design's latency floor: the same rounds with the exchange between
    # the cluster's blocks alone (no field update, no argmax)
    floor_ms = time_ms(lambda: fps_mod.fps_exchange_floor_cuda(
        xyz2, mask2, k), 5)
    log(f"fps: latency floor (exchange-only rounds) {floor_ms:.3f} ms, "
        f"{floor_ms / k * 1e3:.3f} us a round")
    kernels.append(dict(
        name="fps", match="indices exact, also on 6 edge shapes",
        max_abs_err=0.0, extra=dict(latency_floor_ms=floor_ms),
        ms=time_ms(lambda: fps_mod.farthest_point_sampling_cuda(
            xyz2, mask2, k), 5),
        plain_ms=time_ms(lambda: fps_mod.farthest_point_sampling_plain(
            xyz2, mask2, k), 2),
        library_ms=None, bound=bnd,
        shapes=f"xyz {list(xyz2.shape)} -> idx [{b}, {k}]",
    ))
    # the batch's 16 clouds in one launch: 128 blocks in clusters of 8
    xyz16 = torch.cat([src8.xyz, tgt8.xyz])
    mask16 = torch.cat([src8.mask, tgt8.mask])
    got = fps_mod.farthest_point_sampling_cuda(xyz16, mask16, k)
    in_pair = fps_mod.farthest_point_sampling_cuda(xyz2, mask2, k)
    torch.cuda.synchronize()
    for c, ref_c in zip(first, in_pair):
        if not torch.equal(got[c], ref_c):
            raise AssertionError(f"fps: cloud {c} of the batch of 16 differs "
                                 "from the same cloud in the pair's launch")
    fps16_ms = time_ms(lambda: fps_mod.farthest_point_sampling_cuda(
        xyz16, mask16, k), 5)
    kernels[-1]["extra"]["ms_16_clouds"] = fps16_ms
    log(f"fps: 16 clouds in one launch {fps16_ms:.3f} ms, beside "
        f"{kernels[-1]['ms']:.3f} ms for 2")

    # K2: one cloud (the single-cloud shape of the first design), one pair
    # (2 clouds) and the batch (16 clouds), all radii and phase 1's one
    n_edges = bench_strat.check_edges(log)
    q16, _lo, _res = strat_pallas.quantize(xyz16, mask16)
    L = statics.max_points // S
    q_t16 = q16.reshape(2 * BATCH, L, S, 3).permute(0, 3, 1, 2).contiguous()
    radii2_16 = (torch.clamp_min(torch.cat([pre.radii, pre.radii]), 1e-3)
                 ** 2).contiguous()
    off16 = torch.cat([draws8.strat_src, draws8.strat_tgt]).contiguous()
    d2_16 = pre.d2[:, :nf]           # a view: clouds num_probe rows apart
    for clouds, label in (([0], "1 cloud"), (first, "1 pair, 2 clouds"),
                          (list(range(2 * BATCH)), "8 pairs, 16 clouds")):
        whole = len(clouds) == 2 * BATCH
        d2 = d2_16 if whole else d2_16[clouds]
        q_t = q_t16 if whole else q_t16[clouds]
        off = off16 if whole else off16[clouds]
        for R in (statics.num_scales, 1):
            radii2 = radii2_16[clouds][:, :R].contiguous()
            args = (d2, q_t, off, radii2)
            got = strat_pallas.strat_packed_cuda(*args)
            want = strat_pallas.strat_packed_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"strat, {label}, R = {R}: {int((got != want).sum())} "
                    "packed words differ")
            shapes = (f"d2 {list(d2.shape)}, R = {R} -> packed "
                      f"{list(got.shape)}")
            del got, want

            def launch(args=args):
                return strat_pallas.strat_packed_cuda(*args)

            kernels.append(dict(
                name="strat", case=f"{label}, R = {R}",
                match=f"bit-exact, also on {n_edges} edge shapes",
                max_abs_err=0.0,
                extra=dict(ms_back_to_back=bench_strat.time_back_to_back_ms(
                    launch)),
                ms=time_ms(launch, 20),
                plain_ms=time_ms(
                    lambda args=args: strat_pallas.strat_packed_plain(*args),
                    2),
                library_ms=None,
                bound=bound_ms(bench_strat.strat_bytes(*args),
                               d2.numel() * (2.0 + 3.0 * R)),
                shapes=shapes,
            ))
    del d2_16, d2, q16, q_t16, q_t, off16, off, args
    pre = pre._replace(d2=None)     # 3.9 GB that no later phase reads

    # K3: scale 0's normalized aligned patches of both clouds
    patches, pmask = pair_patches(0)
    pmask = pmask.contiguous()
    kpts = pre_kpts
    aligned, _, _ = align_patches(patches - kpts[:, None, :], kpts, False)
    normed = (aligned / torch.clamp_min(pre_radii[0], 1e-3)).contiguous()
    cells = torch.as_tensor(grid_cell_centers(statics.rad_n, statics.ele_n,
                                              statics.azi_n), device=dev)
    radius = statics.delta / statics.rad_n
    r2 = radius * radius
    azi = statics.azi_n

    def check_moments(label, got, want):
        """Counts exact, sums within 1e-4 + 1e-5 |p|; the largest error."""
        if not torch.equal(got[:, 9], want[:, 9]):
            raise AssertionError(f"moments, {label}: "
                                 f"{int((got[:, 9] != want[:, 9]).sum())} "
                                 "counts differ from the plain version")
        err = (got - want).abs()
        if bool((err > 1e-4 + 1e-5 * want.abs()).any()):
            raise AssertionError(
                f"moments, {label}: sums off by up to {float(err.max())}")
        return float(err.max()) if err.numel() else 0.0

    # the plain versions run without the ring length: no cull on their side
    got = spt_pallas.spt_moments_cuda(normed, pmask, cells, r2, ring_len=azi)
    want = spt_pallas.spt_moments_plain(normed, pmask, cells, r2)
    again = spt_pallas.spt_moments_cuda(normed, pmask, cells, r2, ring_len=azi)
    torch.cuda.synchronize()
    moments_err = check_moments("the path's shapes", got, want)
    if not torch.equal(got, again):
        raise AssertionError("moments: two launches on the same input differ "
                             f"in {int((got != again).sum())} entries")
    log("moments: two launches on the same input give equal bits")

    edge_cases = cell_edge_cases(grid_cell_centers)
    for label, e_p, e_m, e_c, e_r, e_ns, e_ring in edge_cases:
        e_p = torch.from_numpy(e_p).to(dev)
        e_m = torch.from_numpy(e_m).to(dev)
        e_c = torch.from_numpy(e_c).to(dev)
        e_err = check_moments(
            label,
            spt_pallas.spt_moments_cuda(e_p, e_m, e_c, e_r * e_r,
                                        ring_len=e_ring),
            spt_pallas.spt_moments_plain(e_p, e_m, e_c, e_r * e_r, chunk=16))
        got_q = spt_pallas.spt_cell_query_cuda(e_p, e_m, e_c, e_r, e_ns,
                                               ring_len=e_ring)
        want_q = spt_pallas.spt_cell_query_plain(e_p, e_m, e_c, e_r, e_ns,
                                                 chunk=16)
        torch.cuda.synchronize()
        if not torch.equal(got_q, want_q):
            raise AssertionError(
                f"cell_query, {label}: "
                f"{int((got_q != want_q).any(-1).sum())} slots differ from "
                "the plain version")
        log(f"moments and cell_query, {label}: patches {list(e_p.shape)}, "
            f"cells {list(e_c.shape)}, nsample {e_ns}, ring length {e_ring}: "
            f"counts exact, sums within {e_err:.2e}; slots bit-exact")

    # the ring cull on the card against its plain twin, on every scale's
    # patches: equal candidate counts per (patch, ring), and no hit dropped
    cull_pairs = cull_kept = cull_hits = 0
    kept_by_scale = []
    for s_i in range(statics.num_scales):
        pa_s, ma_s = pair_patches(s_i)
        al_s, _, _ = align_patches(pa_s - kpts[:, None, :], kpts, False)
        no_s = (al_s / torch.clamp_min(pre_radii[s_i], 1e-3)).contiguous()
        counts = spt_pallas.ring_candidate_counts_cuda(no_s, ma_s, cells,
                                                       radius, azi)
        dropped = 0
        for i in range(0, no_s.shape[0], 250):
            pa_c, ma_c = no_s[i:i + 250], ma_s[i:i + 250]
            cand = spt_pallas.ring_candidates_plain(pa_c, ma_c, cells, radius,
                                                    azi)
            if not torch.equal(cand.sum(-1).to(torch.int32),
                               counts[i:i + 250]):
                raise AssertionError(
                    f"ring cull, scale {s_i}: the kernel's candidate counts "
                    "differ from the plain twin's")
            hit = spt_pallas.in_radius(pa_c, cells, r2) & ma_c[:, None, :]
            dropped += int((hit & ~cand.repeat_interleave(azi, dim=1)).sum())
            cull_hits += int(hit.sum())
        if dropped:
            raise AssertionError(f"ring cull, scale {s_i}: {dropped} hits "
                                 "are no candidates of their ring")
        kept = int(counts.sum()) * azi
        cull_kept += kept
        kept_by_scale.append(kept)
        cull_pairs += no_s.shape[0] * no_s.shape[1] * cells.shape[0]
        log(f"ring cull, scale {s_i}: candidate counts equal the twin's on "
            f"{counts.numel()} (patch, ring) lists, 0 hits dropped, keeps "
            f"{kept / (no_s.shape[0] * no_s.shape[1] * cells.shape[0]):.4f} "
            "of the point-cell pairs")
    cull_extra = dict(cull_kept_share=cull_kept / cull_pairs,
                      hit_share=cull_hits / cull_pairs)
    log(f"ring cull: keeps {cull_extra['cull_kept_share']:.4f} of the pairs "
        f"of the three scales; {cull_extra['hit_share']:.4f} are hits")

    def cdist_bmm():
        ok = (torch.cdist(cells[None].expand(normed.shape[0], -1, -1),
                          normed) <= radius).to(torch.float32)
        psi = spt_pallas.point_moment_features(normed, pmask)
        return torch.bmm(ok, psi).transpose(1, 2)

    # Operations of K3 and K4 for the bound: what the function needs on this
    # input, not the 9 flops a pair of a brute-force walk. Per valid point its
    # rho (4), per point and ring the 2-D test (6), per pair the cull keeps
    # at scale 0 (these patches) the exact test (9); K3 adds 16 a hit. K4
    # stops at a cell's 10th hit and needs fewer exact tests than are
    # counted; bytes decide either way.
    kq, p = pmask.shape
    g = cells.shape[0]
    hits = float(want[:, 9].sum())
    cull_ops = 4.0 * float(pmask.sum()) + 6.0 * kq * p * (g // azi) \
        + 9.0 * kept_by_scale[0]
    kernels.append(dict(
        name="moments",
        match="counts exact, sums within 1e-4 + 1e-5|p|, also on "
              f"{len(edge_cases)} edge shapes; two launches equal bits",
        max_abs_err=moments_err,
        extra=cull_extra,
        ms=time_ms(lambda: spt_pallas.spt_moments_cuda(
            normed, pmask, cells, r2, ring_len=azi), 10),
        plain_ms=time_ms(lambda: spt_pallas.spt_moments_plain(
            normed, pmask, cells, r2), 3),
        library_ms=time_ms(cdist_bmm, 5),
        bound=bound_ms(kq * p * 13 + g * 12 + kq * 10 * g * 4,
                       cull_ops + 16.0 * hits),
        shapes=f"patches {list(normed.shape)} -> {list(got.shape)}",
    ))

    # K4: the same patches, the sampled path's cell query
    ns = statics_s.voxel_sample
    got = spt_pallas.spt_cell_query_cuda(normed, pmask, cells, radius, ns,
                                         ring_len=azi)
    want = spt_pallas.spt_cell_query_plain(normed, pmask, cells, radius, ns)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"cell_query: {int((got != want).any(-1).sum())} slots differ")
    kernels.append(dict(
        name="cell_query",
        match=f"bit-exact, also on {len(edge_cases)} edge shapes",
        max_abs_err=0.0,
        extra=cull_extra,
        ms=time_ms(lambda: spt_pallas.spt_cell_query_cuda(
            normed, pmask, cells, radius, ns, ring_len=azi), 20),
        plain_ms=time_ms(lambda: spt_pallas.spt_cell_query_plain(
            normed, pmask, cells, radius, ns), 3),
        library_ms=None,
        bound=bound_ms(kq * p * 13 + g * 12 + got.numel() * 4, cull_ops),
        shapes=f"patches {list(normed.shape)} -> {list(got.shape)}",
    ))

    # K5: the sampled stem's output on those cells, through the fused stack
    with torch.no_grad():
        inv = spatial_point_transformer(
            normed, pmask, statics_s.rad_n, statics_s.ele_n, statics_s.azi_n,
            statics_s.delta, ns).to(torch.bfloat16)
        x5 = torch.amax(models_s.desc.stem(inv), dim=2).reshape(
            kq, statics_s.rad_n, statics_s.ele_n, statics_s.azi_n, 16)
    w5, b5 = models_s.desc.backbone.folded_w, models_s.desc.backbone.folded_b
    p5 = models_s.desc.backbone.packed_w   # packed once, where the fold ran

    def compare_stack(label, w, b):
        got = conv_pallas.cyl_conv_stack_cuda(
            x5, w, b, conv_pallas.pack_cyl_weights(w))
        want = conv_pallas.cyl_conv_stack_plain(x5, w, b)
        torch.cuda.synchronize()
        err = (got - want).abs()
        log(f"conv_stack, {label}: max err {float(err.max())}, mean err "
            f"{float(err.mean())}, max |p| {float(want.abs().max())}, "
            f"mean |p| {float(want.abs().mean())}, entries differing "
            f"{int((err > 0).sum())}, by more than 1e-2 "
            f"{int((err > 1e-2).sum())}, of {err.numel()}")
        return got, want, err

    # small random weights on the fold's layout: outputs stay below 1, so
    # a rounding flip is at most a few 2^-9 steps and 1e-2 holds between
    # f32 summation orders, while a wrong rounding mode (truncation, say)
    # moves most entries and shows in the mean error
    rs5 = np.random.RandomState(3)
    w5r = torch.from_numpy((w5.float().cpu().numpy() != 0)
                           * rs5.randn(*w5.shape).astype(np.float32) * 0.03)
    w5r = w5r.to(torch.bfloat16).to(dev)
    b5r = torch.from_numpy((rs5.randn(*b5.shape) * 0.1).astype(np.float32))
    b5r = b5r.to(dev)
    _, want_r, err_r = compare_stack("random weights", w5r, b5r)
    if float(want_r.abs().max()) >= 1.0 or float(err_r.max()) > 1e-2 or \
            float(err_r.mean()) > 2.0 ** -10 * float(want_r.abs().mean()):
        raise AssertionError("conv_stack: kernel and plain version differ "
                             "beyond 1e-2 (or 2^-10 of the mean magnitude "
                             "on average) with small random weights")
    got, want, err = compare_stack("shipped weights", w5, b5)
    step = 2.0 ** float(torch.floor(torch.log2(want.abs().max())))
    if float(err.max()) > 2.0 ** -6 * step or \
            float(err.mean()) > 2.0 ** -8 * float(want.abs().mean()):
        raise AssertionError("conv_stack: kernel and plain version differ "
                             "by more than bf16 rounding flips")
    cudnn = CylindricalConvNet(32, 1.0, torch.bfloat16)
    cudnn.load_state_dict(models_s.desc.backbone.state_dict(), strict=True)
    cudnn = cudnn.to(dev).eval()
    x5_cf = x5.permute(0, 4, 1, 2, 3)

    def cudnn_stack(epilogue=False):
        """The library yardstick: cuDNN's convolutions with the layers'
        eager epilogue (as they run off the card), or with E1's."""
        on_card = layers._on_card
        if not epilogue:
            layers._on_card = lambda _t: False
        try:
            with torch.no_grad():
                return cudnn(x5_cf)
        finally:
            layers._on_card = on_card

    flops = 2.0 * kq * 7 * 20 * 9 * sum(
        ci * co for ci, co in conv_pallas.CYL_LAYER_CHANNELS)
    kernels.append(dict(
        name="conv_stack",
        match="random weights: within 1e-2, mean err <= 2^-10 mean|p|; "
              "shipped weights: within 2 bf16 steps at max|p|, mean err "
              "<= 2^-8 mean|p|",
        max_abs_err=float(err.max()),
        extra=dict(max_abs_err_random_weights=float(err_r.max()),
                   mean_abs_err_random_weights=float(err_r.mean()),
                   mean_abs_err=float(err.mean()),
                   cudnn_with_epilogue_ms=time_ms(
                       lambda: cudnn_stack(epilogue=True), 5)),
        ms=time_ms(lambda: conv_pallas.cyl_conv_stack_cuda(
            x5, w5, b5, p5), 10),
        plain_ms=time_ms(lambda: conv_pallas.cyl_conv_stack_plain(
            x5, w5, b5), 3),
        library_ms=time_ms(cudnn_stack, 5),
        bound=bound_ms(x5.numel() * 4 + w5.numel() * 2 + b5.numel() * 4
                       + got.numel() * 4, flops, PEAK_BF16_TC_PER_S),
        shapes=f"x {list(x5.shape)} -> {list(got.shape)}",
    ))
    for kr in kernels:
        log(f"{kr['name']}: {kr['shapes']} matches the plain version; "
            f"kernel {kr['ms']:.3f} ms, plain {kr['plain_ms']:.3f} ms, "
            f"library {kr['library_ms']}, bound {kr['bound'][0]:.4f} ms "
            f"({kr['bound'][1]})")

    # ---- 4. the main path; 4b. the sampled path ---------------------------
    poses_4b = []
    launches = {
        "moments": run_path(torch, reg, se3, cuda_build, "moments", cfg,
                            models, pairs),
        "sampled": run_path(torch, reg, se3, cuda_build, "sampled", cfg_s,
                            models_s, pairs, poses=poses_4b),
        **launches_3b,
    }

    # ---- 6. batched two-phase serving at full width, moments path ----------
    def with_threshold(base, threshold):
        return base.override(match=dict(early_exit_min_inliers=threshold))

    # one scale-0 batch under the sync-debug mode
    stat_b = reg.PipelineStatics.from_config(cfg)
    reg._register_batch(models, stat_b, src8, tgt8, draws8, (0,), False)
    syncs = sync_calls(torch, lambda: reg._register_batch(
        models, stat_b, src8, tgt8, draws8, (0,), False))
    log(f"batched scale-0 run of {BATCH} pairs under sync-debug mode: "
        f"{len(syncs)} synchronizing calls {sorted(set(syncs))}")
    if syncs:
        raise AssertionError("a batch run makes the host wait for the card")

    def single_all_scales(_i, s_c, t_c, _d0, d1):
        return reg.register_pair(cfg, s_c, t_c, models, draws=d1,
                                 device=dev).pose

    cfg_exit = with_threshold(cfg, 1)

    def single_scale0(_i, s_c, t_c, d0, d1):
        return reg.register_pair_early_exit(cfg_exit, s_c, t_c, models,
                                            draws=(d0, d1), device=dev).pose

    batched = {}
    for tag, b_cfg, reference in (
            ("a", cfg, None),
            ("b", with_threshold(cfg, 10 ** 6), single_all_scales),
            ("c", cfg_exit, single_scale0)):
        batched[tag] = run_batched(
            torch, reg, se3, cuda_build,
            f"batched moments ({tag}, threshold "
            f"{b_cfg.match.early_exit_min_inliers})", b_cfg, models, pairs16,
            BATCH, {"moments": lambda _n: 1}, reference)
    if batched["b"]["scales_used"] != {statics.num_scales: NUM_BATCHED_PAIRS} \
            or batched["c"]["scales_used"] != {1: NUM_BATCHED_PAIRS}:
        raise AssertionError("the thresholds 10^6 and 1 did not send every "
                             "pair through all scales and through scale 0")
    if batched["b"]["successes_first4"] < JAX_SUCCESSES["moments"] - 1:
        raise AssertionError("batched, all scales: fewer successes on the "
                             "first 4 pairs than the JAX package's minus 1")
    for tag in ("a", "c"):
        if batched[tag]["successes_first4"] < \
                JAX_SUCCESSES["moments_scale0"] - 1:
            raise AssertionError(f"batched ({tag}): fewer than 3 of the "
                                 "first 4 pairs register")
    launches["batched"] = batched["b"]["launches"]
    # (d) a threshold at the median of the scale-0 inlier counts: about half
    # of the pairs exit, the others go on in redo batches shorter than 8
    cfg_mixed = with_threshold(cfg, int(np.median(batched["c"]["inliers"])))

    def single_mixed(_i, s_c, t_c, d0, d1):
        return reg.register_pair_early_exit(cfg_mixed, s_c, t_c, models,
                                            draws=(d0, d1), device=dev).pose

    batched["d"] = run_batched(
        torch, reg, se3, cuda_build,
        f"batched moments (d, threshold "
        f"{cfg_mixed.match.early_exit_min_inliers})", cfg_mixed, models,
        pairs16, BATCH, {"moments": lambda _n: 1}, single_mixed)
    if sorted(batched["d"]["scales_used"]) != [1, statics.num_scales]:
        raise AssertionError("the median threshold did not split the pairs "
                             "between scale 0 and all scales")

    # ---- 6b. the sampled + fused path, batched ----------------------------
    # one batch of 4 pairs is 12000 patches a scale: the descriptor net, and
    # with it the conv stack, runs over them in sub-batches
    def desc_calls(n_pairs):
        return -(-2 * n_pairs * statics_s.num_fps // reg.SAMPLED_DESC_CHUNK)

    if desc_calls(len(pairs)) < 2:
        raise AssertionError("the sampled batch does not reach the "
                             "descriptor net's sub-batches")

    def single_sampled(_i, s_c, t_c, _d0, d1):
        return reg.register_pair(cfg_s, s_c, t_c, models_s, draws=d1,
                                 device=dev).pose

    batched["sampled"] = run_batched(
        torch, reg, se3, cuda_build, "batched sampled (threshold 10^6)",
        with_threshold(cfg_s, 10 ** 6), models_s, pairs, len(pairs),
        {"cell_query": lambda _n: 1, "conv_stack": desc_calls},
        single_sampled)
    if batched["sampled"]["successes"] < JAX_SUCCESSES["sampled"] - 1:
        raise AssertionError("batched sampled path: fewer successes than "
                             "the JAX package's minus 1")
    launches["batched_sampled"] = batched["sampled"]["launches"]

    # ---- 7. early exit, the timed path with IRLS, GNC ---------------------
    s7, t7, T7 = pairs[1]
    gen7 = torch.Generator()
    runs7 = {
        "register_pair_early_exit": lambda: (reg.register_pair_early_exit(
            cfg, s7, t7, models, generator=gen7.manual_seed(7), device=dev),
            None),
        "register_pair_timed, pose_refine": lambda: reg.register_pair_timed(
            cfg.override(test=dict(pose_refine=True)), s7, t7, models,
            generator=gen7.manual_seed(7), device=dev),
        "register_pair, gnc": lambda: (reg.register_pair(
            cfg.override(match=dict(pose_estimator="gnc")), s7, t7, models,
            generator=gen7.manual_seed(7), device=dev), None),
    }
    for name7, run7 in runs7.items():
        run7()                                       # warm-up
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        res7, phases7 = run7()
        torch.cuda.synchronize()
        ms7 = (time.perf_counter() - t0) * 1e3
        got7 = {n: kk.launches for n, kk in cuda_build.KERNELS.items()}
        rte, rre, ok = pose_errors(se3, cfg, res7.pose, T7)
        log(f"{name7}: {ms7:.1f} ms, scales {int(res7.scales_used)}, RTE "
            f"{rte:.4f} m, RRE {rre:.3f} deg, success {ok}, inliers "
            f"{int(res7.num_inliers)}, launches {got7}"
            + (f", phases (s) {phases7}" if phases7 else ""))
        # a solve a precomputation: the consensus, and RANSAC but with GNC
        per_solve = 1 if name7.endswith("gnc") else 2
        if got7["fps"] < 1 or got7["hyp_score"] != per_solve * got7["fps"]:
            raise AssertionError(f"{name7}: hyp_score launched "
                                 f"{got7['hyp_score']} times for "
                                 f"{got7['fps']} precomputations, expected "
                                 f"{per_solve} each")
        if not bool(torch.isfinite(res7.pose).all()) or not ok:
            raise AssertionError(f"{name7}: no finite, successful pose")
        if phases7 and not (phases7["desc_time"] > 0 and phases7["pose_time"]
                            > 0 and phases7["pose_optim_time"] > 0):
            raise AssertionError(f"{name7}: a phase took no time: {phases7}")

    # ---- 5. card path against CPU path on a small input -------------------
    shrink = dict(
        capacity=dict(max_points=2048, num_ransac_hypotheses=256,
                      ransac_chunk=128),
        patch=dict(num_fps=128, num_points_radius_estimate=160,
                   num_points_per_patch=64),
    )
    for name, base, sd in (("moments", cfg, load_snapshot(SNAPSHOT)),
                           ("sampled", cfg_s, sd_s)):
        small = base.override(**shrink)
        s_st = reg.PipelineStatics.from_config(small)
        s, t, T = synthetic_pair_full_overlap(np.random.RandomState(7), 2000)
        sdraws = reg.make_draws(s_st, torch.Generator().manual_seed(7), "cpu")
        poses = {}
        for d in ("cpu", "cuda"):
            dr = reg.Draws(*(x.to(d) for x in sdraws))
            r = reg.register_pair(small, reg.prepare_cloud(s, small, 7, d),
                                  reg.prepare_cloud(t, small, 7, d), sd,
                                  draws=dr, device=d)
            poses[d] = r.pose.cpu()
        d_rte = float(se3.compute_rte(poses["cuda"], poses["cpu"]))
        d_rre = float(se3.compute_rre(poses["cuda"], poses["cpu"]))
        log(f"{name} small pair, card vs CPU: pose differs by {d_rte:.2e} m, "
            f"{d_rre:.3f} deg")
        if d_rte > 0.02 or d_rre > 1.0:
            raise AssertionError(f"{name}: card and CPU paths disagree on the "
                                 "small pair")
        if name != "moments":
            continue
        # one batch of 3 through both phases (every pair redone)
        small_b = small.override(match=dict(early_exit_min_inliers=10 ** 6))
        clouds3 = [synthetic_pair_full_overlap(np.random.RandomState(20 + i),
                                               2000) for i in range(3)]
        gen3 = torch.Generator().manual_seed(3)
        draws3 = tuple(reg.make_draws(s_st, gen3, "cpu", batch=3)
                       for _phase in range(2))
        poses3 = {}
        for d in ("cpu", "cuda"):
            out3 = reg.register_pairs_batched(
                small_b,
                [reg.prepare_cloud(c[0], small, 7, d) for c in clouds3],
                [reg.prepare_cloud(c[1], small, 7, d) for c in clouds3], sd,
                batch_size=3, device=d,
                draws=[tuple(reg.Draws(*(x.to(d) for x in dr))
                             for dr in draws3)])
            poses3[d] = torch.stack([r.pose.cpu() for r in out3])
        d_rte = float(se3.compute_rte(poses3["cuda"], poses3["cpu"]).max())
        d_rre = float(se3.compute_rre(poses3["cuda"], poses3["cpu"]).max())
        log(f"{name} small batch of 3, card vs CPU: poses differ by at most "
            f"{d_rte:.2e} m, {d_rre:.3f} deg")
        # three pairs share the batched products: the repo's end-to-end
        # tolerance, not the single pair's tighter one
        if d_rte > 0.02 or d_rre > 2.0:
            raise AssertionError(f"{name}: card and CPU paths disagree on the "
                                 "small batch")

    # ---- 8. the quality gate at full width ----------------------------------
    launches["gate"], gate = run_gate(torch, reg, cuda_build, models, dev)

    # ---- 9. the evaluation harness ----------------------------------------
    harness = run_harness(torch, reg, models, dev)

    # ---- 10. training on the card ------------------------------------------
    launches["training"], launches["training_sampled"], training, \
        train_kernels = run_training(torch, cuda_build, reg, se3, make_cfg,
                                     dev, pairs[0])
    kernels.extend(train_kernels)

    # ---- 11. the dataset entry points ---------------------------------------
    launches_ds, dataset, dataset_kernels = run_dataset_path(
        torch, cuda_build, reg, se3, dev)
    launches.update(launches_ds)
    kernels.extend(dataset_kernels)

    # ---- 12. the multi-frame front end and the distributed layer -----------
    launches_mf, multiframe, mf_kernels = run_multiframe(
        torch, cuda_build, reg, se3, dev)
    launches.update(launches_mf)
    kernels.extend(mf_kernels)

    # ---- 13. the offline tools ---------------------------------------------
    launches_off, offline, off_kernels = run_offline_tools(
        torch, cuda_build, reg, se3, dev, cfg_s, pairs, poses_4b)
    launches.update(launches_off)
    kernels.extend(off_kernels)

    # ---- 14. the last names of the port -------------------------------------
    launches_last, last, last_kernels = run_last_names(
        torch, cuda_build, reg, se3, dev, cfg, models, pairs[0][0])
    launches.update(launches_last)
    kernels.extend(last_kernels)

    # ---- result lines -----------------------------------------------------
    out = kernels_line(cuda_build, kernels, launches)
    print(json.dumps({"batched": list(batched.values())}), flush=True)
    print(json.dumps({"gate": gate, "harness": harness}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"dataset": dataset}), flush=True)
    print(json.dumps({"multiframe": multiframe}), flush=True)
    print(json.dumps({"offline": offline}), flush=True)
    print(json.dumps({"last_names": last}), flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": device_line(torch)}), flush=True)
    return 0


def kernels_line(cuda_build, kernels: list, launches: dict) -> list:
    """The kernels line's entries: each kernel entry with its source, what
    it replaces and its launches on its path and on every path."""
    out = []
    for kr in kernels:
        kk = cuda_build.KERNELS[kr["name"]]
        out.append(dict(
            name=kr["name"], route="cuda", match=kr["match"],
            shapes=kr["shapes"], **({"case": kr["case"]} if "case" in kr
                                    else {}),
            source=os.path.relpath(kk.source_path, HERE),
            replaces=kk.replaces,
            launches=launches[kr.get("path", PATH_OF[kr["name"]])][
                kr["name"]],
            launches_by_path={n: c[kr["name"]] for n, c in launches.items()},
            max_abs_err=kr["max_abs_err"], ms=kr["ms"],
            plain_ms=kr["plain_ms"], bound_ms=kr["bound"][0],
            bound_by=kr["bound"][1], library_ms=kr["library_ms"],
            **kr.get("extra", {}),
        ))
    return out


def device_line(torch) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


if __name__ == "__main__":
    sys.exit(main())
