"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``bufferx_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (taken from a real pair): FPS indices exact,
   stratified query bit-exact, moment counts exact and sums within
   |k - p| <= 1e-4 + 1e-5 |p| (f32 summation order); kernel, plain and
   library-yardstick times (median of CUDA-event runs) and the bound;
4. the main path: ``register_pair`` with the ``hard_moments_r4ft2`` weights
   at full width (30208 points, 1500 keypoints, 2000 probes, 512-point
   patches, 3 scales, 8192 hypotheses) on 4 seeded full-overlap pairs after
   one warm-up; per-pair ms, RTE/RRE/success against ModelNet40's
   thresholds; launch counts read around exactly these 4 registrations;
5. the card path against the CPU path (plain versions) end to end on a
   small input with the same draws.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(HERE, "snapshot", "hard_moments_r4ft2")
NUM_PAIRS = 4
# Successes of the JAX package on these 4 pairs, taken as the most there
# can be (4 of 4): the JAX package cannot run on the card's machine, and
# full-width runs are not made on the CPU-only build host. The threshold
# below (this minus 1) is therefore at least as strict as any measured
# JAX count would make it.
JAX_SUCCESSES = 4
# the main path's launches per pair: FPS for both clouds in one launch,
# the stratified query once per cloud, moment pooling once per scale
EXPECTED_PER_PAIR = {"fps": 1, "strat": 2, "moments": 3}
# published H100 SXM peaks: HBM bytes/s and
# float32 outside the tensor cores, flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
    from bufferx_tpu_torch.geometry.cylindrical import grid_cell_centers
    from bufferx_tpu_torch.geometry.lrf import align_patches
    from bufferx_tpu_torch.kernels import fps as fps_mod
    from bufferx_tpu_torch.kernels import strat_pallas
    from bufferx_tpu_torch.pipeline import registration as reg
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
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{k.name}]: {line.strip()}")

    # ---- main-path configuration and pairs --------------------------------
    cfg = make_cfg("ModelNet40").override(patch=dict(desc_mode="moments"))
    cfg = cfg.override(patch=load_snapshot_config(SNAPSHOT))
    statics = reg.PipelineStatics.from_config(cfg)
    log(f"statics: {statics}")
    models = reg.build_models(statics, load_snapshot(SNAPSHOT), dev)
    pairs = []
    for i in range(NUM_PAIRS):
        s, t, T = synthetic_pair_full_overlap(np.random.RandomState(i),
                                              num_points=24000)
        pairs.append((reg.prepare_cloud(s, cfg, seed=i, device=dev),
                      reg.prepare_cloud(t, cfg, seed=i, device=dev),
                      torch.from_numpy(T).to(dev)))

    # ---- 3. kernels against their plain versions at main-path shapes ------
    src, tgt, _ = pairs[0]
    draws = reg.make_draws(statics, torch.Generator().manual_seed(0), dev)
    pre = reg._precompute(statics, src, tgt, draws)
    nf, S = statics.num_fps, statics.patch_sample
    kernels = []

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
    b, n = mask2.shape
    bnd = bound_ms(b * n * 13 + b * k * 4, 9.0 * b * k * n)
    kernels.append(dict(
        name="fps", match="indices exact", max_abs_err=0.0,
        ms=time_ms(torch, lambda: fps_mod.farthest_point_sampling_cuda(
            xyz2, mask2, k), 5),
        plain_ms=time_ms(torch, lambda: fps_mod.farthest_point_sampling_plain(
            xyz2, mask2, k), 2),
        library_ms=None, bound=bnd,
        shapes=f"xyz {list(xyz2.shape)} -> idx [{b}, {k}]",
    ))

    # K2: the source cloud's all-scale query
    d2 = pre.d2_src[:nf].contiguous()
    q, _lo, _res = strat_pallas.quantize(src.xyz, src.mask)
    L = statics.max_points // S
    q_t = q.reshape(L, S, 3).permute(2, 0, 1).contiguous()
    radii2 = (torch.clamp_min(pre.radii, 1e-3) ** 2).contiguous()
    off = draws.strat_src.contiguous()
    got = strat_pallas.strat_packed_cuda(d2, q_t, off, radii2)
    want = strat_pallas.strat_packed_plain(d2, q_t, off, radii2)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"strat: {int((got != want).sum())} packed words differ")
    R = radii2.shape[0]
    nbytes = d2.numel() * 4 + off.numel() * 4 + q_t.numel() * 4 + R * 4 \
        + R * 3 * nf * S * 4
    kernels.append(dict(
        name="strat", match="bit-exact", max_abs_err=0.0,
        ms=time_ms(torch, lambda: strat_pallas.strat_packed_cuda(
            d2, q_t, off, radii2), 20),
        plain_ms=time_ms(torch, lambda: strat_pallas.strat_packed_plain(
            d2, q_t, off, radii2), 5),
        library_ms=None,
        bound=bound_ms(nbytes, d2.numel() * (2.0 + 8.0 * R)),
        shapes=f"d2 {list(d2.shape)} -> packed {list(got.shape)}",
    ))

    # K3: scale 0's normalized aligned patches of both clouds
    patches = torch.cat([pre.src_patches[0], pre.tgt_patches[0]])
    pmask = torch.cat([pre.src_pvalid[0], pre.tgt_pvalid[0]]).contiguous()
    kpts = torch.cat([pre.src_kpts, pre.tgt_kpts])
    aligned, _, _ = align_patches(patches - kpts[:, None, :], kpts, False)
    normed = (aligned / torch.clamp_min(pre.radii[0], 1e-3)).contiguous()
    cells = torch.as_tensor(grid_cell_centers(statics.rad_n, statics.ele_n,
                                              statics.azi_n), device=dev)
    radius = statics.delta / statics.rad_n
    r2 = radius * radius
    got = spt_pallas.spt_moments_cuda(normed, pmask, cells, r2)
    want = spt_pallas.spt_moments_plain(normed, pmask, cells, r2)
    torch.cuda.synchronize()
    if not torch.equal(got[:, 9], want[:, 9]):
        raise AssertionError(
            f"moments: {int((got[:, 9] != want[:, 9]).sum())} counts differ")
    err = (got - want).abs()
    if bool((err > 1e-4 + 1e-5 * want.abs()).any()):
        raise AssertionError(f"moments: sums off by up to {float(err.max())}")

    def cdist_bmm():
        ok = (torch.cdist(cells[None].expand(normed.shape[0], -1, -1),
                          normed) <= radius).to(torch.float32)
        psi = spt_pallas.point_moment_features(normed, pmask)
        return torch.bmm(ok, psi).transpose(1, 2)

    kq, p = pmask.shape
    g = cells.shape[0]
    hits = float(want[:, 9].sum())
    kernels.append(dict(
        name="moments", match="counts exact, sums within 1e-4 + 1e-5|p|",
        max_abs_err=float(err.max()),
        ms=time_ms(torch, lambda: spt_pallas.spt_moments_cuda(
            normed, pmask, cells, r2), 10),
        plain_ms=time_ms(torch, lambda: spt_pallas.spt_moments_plain(
            normed, pmask, cells, r2), 3),
        library_ms=time_ms(torch, cdist_bmm, 5),
        bound=bound_ms(kq * p * 13 + g * 12 + kq * 10 * g * 4,
                       9.0 * kq * g * p + 16.0 * hits),
        shapes=f"patches {list(normed.shape)} -> {list(got.shape)}",
    ))
    for kr in kernels:
        log(f"{kr['name']}: {kr['shapes']} matches the plain version; "
            f"kernel {kr['ms']:.3f} ms, plain {kr['plain_ms']:.3f} ms, "
            f"library {kr['library_ms']}, bound {kr['bound'][0]:.4f} ms "
            f"({kr['bound'][1]})")

    # ---- 4. the main path -------------------------------------------------
    gen = torch.Generator()
    res = reg.register_pair(cfg, pairs[0][0], pairs[0][1], models,
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
        for name, want_n in EXPECTED_PER_PAIR.items():
            got_n = cuda_build.KERNELS[name].launches - before[name]
            if got_n != want_n:
                raise AssertionError(
                    f"pair {i}: {name} launched {got_n} times, expected {want_n}")
        pose = res.pose
        if pose.shape != (4, 4) or not bool(torch.isfinite(pose).all()):
            raise AssertionError(f"pair {i}: pose not a finite 4x4: {pose}")
        rte = float(se3.compute_rte(pose, T))
        rre = float(se3.compute_rre(pose, T))
        ok = rte < cfg.test.rte_thresh and rre < cfg.test.rre_thresh
        per_pair.append(dict(ms=ms, rte=rte, rre=rre, success=ok))
        log(f"pair {i}: {ms:.1f} ms, RTE {rte:.4f} m, RRE {rre:.3f} deg, "
            f"success {ok}, inliers {int(res.num_inliers)}, "
            f"mutual {int(res.num_mutual)}")
    launches = {n: kk.launches for n, kk in cuda_build.KERNELS.items()}
    successes = sum(p["success"] for p in per_pair)
    log(f"main path: {successes}/{NUM_PAIRS} successes, median "
        f"{float(np.median([p['ms'] for p in per_pair])):.1f} ms/pair, "
        f"launches {launches}")
    if successes < JAX_SUCCESSES - 1:
        raise AssertionError(
            f"{successes} successes < JAX package's {JAX_SUCCESSES} - 1")

    # ---- 5. card path against CPU path on a small input -------------------
    small = cfg.override(
        capacity=dict(max_points=2048, num_ransac_hypotheses=256,
                      ransac_chunk=128),
        patch=dict(num_fps=128, num_points_radius_estimate=160,
                   num_points_per_patch=64),
    )
    s_st = reg.PipelineStatics.from_config(small)
    s, t, T = synthetic_pair_full_overlap(np.random.RandomState(7), 2000)
    sdraws = reg.make_draws(s_st, torch.Generator().manual_seed(7), "cpu")
    sd = load_snapshot(SNAPSHOT)
    poses = {}
    for d in ("cpu", "cuda"):
        dr = reg.Draws(*(x.to(d) for x in sdraws))
        r = reg.register_pair(small, reg.prepare_cloud(s, small, 7, d),
                              reg.prepare_cloud(t, small, 7, d), sd,
                              draws=dr, device=d)
        poses[d] = r.pose.cpu()
    d_rte = float(se3.compute_rte(poses["cuda"], poses["cpu"]))
    d_rre = float(se3.compute_rre(poses["cuda"], poses["cpu"]))
    log(f"small pair, card vs CPU: pose differs by {d_rte:.2e} m, "
        f"{d_rre:.3f} deg")
    if d_rte > 0.02 or d_rre > 1.0:
        raise AssertionError("card and CPU paths disagree on the small pair")

    # ---- result lines -----------------------------------------------------
    out = []
    for kr in kernels:
        kk = cuda_build.KERNELS[kr["name"]]
        out.append(dict(
            name=kr["name"], route="cuda", match=kr["match"],
            source=os.path.relpath(kk.source_path, HERE),
            replaces=kk.replaces, launches=launches[kr["name"]],
            max_abs_err=kr["max_abs_err"], ms=kr["ms"],
            plain_ms=kr["plain_ms"], bound_ms=kr["bound"][0],
            bound_by=kr["bound"][1], library_ms=kr["library_ms"],
        ))
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
