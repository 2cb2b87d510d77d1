"""The hypothesis scoring of RANSAC and the cross-scale consensus
(``kernels/hyp_score.py``): its plain version against the inline chunk loops
the two solvers ran before it, both solvers against their inline forms, the
CUDA wrapper's guards, the split of C, the square-root-free compare the kernel
makes, and (marked ``chip``) the kernel against the plain version on the card
at the cells' shapes.

Every comparison is exact (``torch.equal``): the plain version is the inline
loop moved, and the kernel rounds where the eager chain rounds.
"""

import math

import numpy as np
import pytest
import torch

from bufferx_tpu_torch.core.linalg import kabsch, take_rows
from bufferx_tpu_torch.core.se3 import integrate
from bufferx_tpu_torch.kernels import hyp_score as hs
from bufferx_tpu_torch.solver.consensus import cross_scale_consensus
from bufferx_tpu_torch.solver.ransac import hypotheses, ransac_pose


def _inline_ransac(src, tgt, pool_mask, eval_mask, rank_draws, dist_th,
                   similar_th=0.8, chunk=2048):
    """``ransac_pose`` as it was before the scoring left it: the minimal
    sets, the inline chunk loop, the refit. Returns (result, scores)."""
    R, t, hyp_ok = hypotheses(src, tgt, pool_mask, eval_mask, rank_draws,
                              dist_th, similar_th)
    h = R.shape[1]
    scores = []
    for i in range(0, h, chunk):
        warped = (torch.einsum("bhij,bcj->bhci", R[:, i:i + chunk], src)
                  + t[:, i:i + chunk, None, :])
        d = torch.linalg.norm(warped - tgt[:, None], dim=-1)
        counts = torch.sum((d < dist_th) & eval_mask[:, None], dim=-1)
        scores.append(torch.where(hyp_ok[:, i:i + chunk], counts,
                                  torch.full_like(counts, -1)))
    scores = torch.cat(scores, dim=1)
    best = torch.argmax(scores, dim=1)
    R_best = take_rows(R, best[:, None])[:, 0]
    t_best = take_rows(t, best[:, None])[:, 0]
    warped = torch.matmul(src, R_best.transpose(1, 2)) + t_best[:, None]
    inliers = (torch.linalg.norm(warped - tgt, dim=-1) < dist_th) & eval_mask
    w = inliers.to(src.dtype)
    R_fit, t_fit = kabsch(src, tgt, w)
    enough = torch.sum(w, dim=1) >= 3
    R_out = torch.where(enough[:, None, None], R_fit, R_best)
    t_out = torch.where(enough[:, None], t_fit, t_best)
    warped2 = torch.matmul(src, R_out.transpose(1, 2)) + t_out[:, None]
    final = (torch.linalg.norm(warped2 - tgt, dim=-1) < dist_th) & eval_mask
    return (integrate(R_out, t_out), torch.sum(final, dim=1), final), scores


def _inline_consensus(R_cand, t_cand, ss_kpts, tt_kpts, valid, azi_n,
                      inlier_th, chunk=512):
    """``cross_scale_consensus`` as it was, with its inline chunk loop.
    Returns (result, counts)."""
    thr = torch.linalg.norm(ss_kpts, dim=-1) * (math.pi / azi_n) * inlier_th
    counts = []
    for i in range(0, R_cand.shape[1], chunk):
        Rc, tc = R_cand[:, i:i + chunk], t_cand[:, i:i + chunk]
        warped = (torch.einsum("bhij,bcj->bhci", Rc, ss_kpts)
                  + tc[:, :, None, :])
        d = torch.linalg.norm(warped - tt_kpts[:, None], dim=-1)
        n_in = torch.sum((d < thr[:, None]) & valid[:, None], dim=-1)
        counts.append(torch.where(valid[:, i:i + chunk], n_in,
                                  torch.full_like(n_in, -1)))
    counts = torch.cat(counts, dim=1)
    best = torch.argmax(counts, dim=1)
    R_best = take_rows(R_cand, best[:, None])[:, 0]
    t_best = take_rows(t_cand, best[:, None])
    warped_best = torch.matmul(ss_kpts, R_best.transpose(1, 2)) + t_best
    d_best = torch.linalg.norm(warped_best - tt_kpts, dim=-1)
    return ((d_best < thr) & valid, best,
            torch.gather(counts, 1, best[:, None])[:, 0]), counts


def _rotations(g, n):
    q = torch.randn(n, 4, generator=g, dtype=torch.float64)
    w, x, y, z = (q / q.norm(dim=1, keepdim=True)).unbind(1)
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                        2 * (x * z + y * w), 2 * (x * y + z * w),
                        1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                        2 * (x * z - y * w), 2 * (y * z + x * w),
                        1 - 2 * (x * x + y * y)], 1).reshape(n, 3, 3).float()


def _correspondences(seed, b, c, extent=1.0, inliers=0.5, device="cpu"):
    """src, tgt [b, c, 3] (a share ``inliers`` under one rigid motion with
    noise, the rest anywhere) and a valid mask [b, c]."""
    g = torch.Generator().manual_seed(seed)
    src = (torch.rand(b, c, 3, generator=g) * 2 - 1) * extent
    R = _rotations(g, b)
    t = torch.randn(b, 3, generator=g) * extent * 0.2
    tgt = src @ R.transpose(1, 2) + t[:, None] \
        + 0.01 * extent * torch.randn(b, c, 3, generator=g)
    out = torch.rand(b, c, generator=g) > inliers
    tgt = torch.where(out[..., None],
                      (torch.rand(b, c, 3, generator=g) * 2 - 1) * extent, tgt)
    valid = torch.rand(b, c, generator=g) < 0.7
    return src.to(device), tgt.to(device), valid.to(device)


def _ransac_case(seed, b, h, c, extent=1.0, dist_th=0.05, similar_th=0.8,
                 device="cpu"):
    src, tgt, valid = _correspondences(seed, b, c, extent, device=device)
    g = torch.Generator().manual_seed(seed + 1)
    ranks = torch.randint(0, 1 << 30, (b, h, 3), generator=g).to(device)
    R, t, ok = hypotheses(src, tgt, valid, valid, ranks, dist_th, similar_th)
    return R, t, src, tgt, valid, ok


def _consensus_case(seed, b, c, extent=1.0, device="cpu"):
    src, tgt, valid = _correspondences(seed, b, c, extent, device=device)
    g = torch.Generator().manual_seed(seed + 2)
    Rc = _rotations(g, b * c).reshape(b, c, 3, 3).to(device)
    # each candidate carries its own correspondence onto its target
    tc = tgt - torch.einsum("bcij,bcj->bci", Rc, src)
    thr = torch.linalg.norm(src, dim=-1) * (math.pi / 20) * 1.25
    return Rc, tc.contiguous(), src, tgt, thr, valid


# (label, pairs, hypotheses, correspondences, chunk): a ragged last chunk,
# one chunk, a chunk larger than the budget
RANSAC_CASES = [("ragged last chunk", 2, 300, 80, 128),
                ("whole chunks", 3, 256, 64, 64),
                ("one chunk", 1, 50, 40, 2048)]


@pytest.mark.parametrize("case", RANSAC_CASES, ids=[c[0] for c in RANSAC_CASES])
def test_plain_equals_inline_ransac(case):
    """RANSAC's counts and result: ``hyp_score_plain`` through
    ``ransac_pose`` against the inline loop, scalar threshold, gated
    hypotheses and masked correspondences."""
    _label, b, h, c, chunk = case
    src, tgt, valid = _correspondences(3, b, c)
    pool = valid & (torch.rand(b, c, generator=torch.Generator()
                               .manual_seed(4)) < 0.8)
    ranks = torch.randint(0, 1 << 30, (b, h, 3),
                          generator=torch.Generator().manual_seed(5))
    R, t, ok = hypotheses(src, tgt, pool, valid, ranks, 0.05)
    assert 0 < int(ok.sum()) < ok.numel()          # some gated out
    assert 0 < int(valid.sum()) < valid.numel()    # some masked out
    want_res, want_scores = _inline_ransac(src, tgt, pool, valid, ranks, 0.05,
                                           chunk=chunk)
    got = hs.hyp_score_plain(R, t, src, tgt, 0.05, valid, ok, chunk)
    assert got.dtype == torch.int64
    assert torch.equal(got, want_scores)
    assert torch.equal(hs.hyp_score(R, t, src, tgt, 0.05, valid, ok, chunk),
                       want_scores)
    res = ransac_pose(src, tgt, pool, valid, ranks, 0.05, chunk=chunk)
    for a, w in zip(res, want_res):
        assert torch.equal(a, w)


def test_plain_equals_inline_ransac_empty_pool():
    """An empty pool (falls back to the scored set) and a pair with no valid
    correspondence at all (falls back to everything; every count 0)."""
    src, tgt, valid = _correspondences(6, 3, 60)
    pool = valid.clone()
    pool[1] = False
    pool[2] = False
    valid[2] = False
    ranks = torch.randint(0, 1 << 30, (3, 200, 3),
                          generator=torch.Generator().manual_seed(7))
    want_res, want_scores = _inline_ransac(src, tgt, pool, valid, ranks, 0.05,
                                           chunk=64)
    R, t, ok = hypotheses(src, tgt, pool, valid, ranks, 0.05)
    got = hs.hyp_score_plain(R, t, src, tgt, 0.05, valid, ok, 64)
    assert torch.equal(got, want_scores)
    assert int(got[2].clamp_min(0).sum()) == 0
    res = ransac_pose(src, tgt, pool, valid, ranks, 0.05, chunk=64)
    for a, w in zip(res, want_res):
        assert torch.equal(a, w)


@pytest.mark.parametrize("chunk", [512, 100, 7])
def test_plain_equals_inline_consensus(chunk):
    """The consensus's per-correspondence threshold, its valid mask as both
    the gate and the mask, chunks whole and ragged, and a pair with no
    valid match."""
    Rc, tc, src, tgt, _thr, valid = _consensus_case(8, 3, 150)
    valid[2] = False
    want_res, want_counts = _inline_consensus(Rc, tc, src, tgt, valid, 20,
                                              1.25, chunk=chunk)
    assert int(want_counts.max()) > 0
    res = cross_scale_consensus(Rc, tc, src, tgt, valid, azi_n=20,
                                inlier_th=1.25, chunk=chunk)
    for a, w in zip(res, want_res):
        assert torch.equal(a, w)
    thr = torch.linalg.norm(src, dim=-1) * (math.pi / 20) * 1.25
    got = hs.hyp_score_plain(Rc, tc, src, tgt, thr, valid, valid, chunk)
    assert torch.equal(got, want_counts)
    assert bool((got[2] == -1).all())


def test_scalar_and_tensor_thresholds_agree():
    """A [B, C] threshold that holds one value counts as the scalar does."""
    R, t, src, tgt, valid, ok = _ransac_case(9, 2, 100, 70)
    thr = torch.full(valid.shape, 0.05)
    assert torch.equal(hs.hyp_score_plain(R, t, src, tgt, 0.05, valid, ok, 64),
                       hs.hyp_score_plain(R, t, src, tgt, thr, valid, ok, 64))


def _args():
    R, t, src, tgt, valid, ok = _ransac_case(10, 2, 20, 30)
    return dict(R=R, t=t, src=src, tgt=tgt, thr=0.05, mask=valid, gate=ok)


@pytest.mark.parametrize("bad", [
    "R_shape", "t_shape", "src_shape", "tgt_shape", "mask_shape",
    "gate_shape", "thr_shape"])
def test_wrapper_raises_on_shape(bad):
    a = _args()
    fix = {"R_shape": ("R", a["R"][..., :2]),
           "t_shape": ("t", a["t"][:, :-1]),
           "src_shape": ("src", a["src"][None]),
           "tgt_shape": ("tgt", a["tgt"][:, :-1]),
           "mask_shape": ("mask", a["mask"][:, :-1]),
           "gate_shape": ("gate", a["gate"][:1]),
           "thr_shape": ("thr", torch.ones(2, 29))}[bad]
    a[fix[0]] = fix[1]
    with pytest.raises(ValueError):
        hs.hyp_score_cuda(**a)


@pytest.mark.parametrize("name,dtype", [("R", torch.float64),
                                        ("src", torch.float16),
                                        ("mask", torch.uint8),
                                        ("gate", torch.int64)])
def test_wrapper_raises_on_dtype_and_device(name, dtype):
    """The kernel takes CUDA float32 and bool tensors; on this CPU every
    tensor is off the card, so the guards raise before any launch, and a
    wrong dtype raises too."""
    a = _args()
    with pytest.raises(ValueError, match="CUDA|expected"):
        hs.hyp_score_cuda(**a)
    a[name] = a[name].to(dtype)
    with pytest.raises(ValueError):
        hs.hyp_score_cuda(**a)
    assert hs.HYP_SCORE_KERNEL.launches == 0


def test_dispatch_raises_on_other_devices():
    a = _args()
    a = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
         for k, v in a.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        hs.hyp_score(**a, chunk=64)


@pytest.mark.parametrize("b,h,c", [(8, 8192, 1500), (8, 8192, 4500),
                                   (8, 50000, 4500), (1, 8192, 4500),
                                   (8, 1500, 1500), (1, 4500, 4500),
                                   (3, 10, 100), (1, 1, 1)])
def test_split_count(b, h, c):
    """Parts of C: 1 where the pairs' hypothesis tiles fill the card, more
    where they fall short, each part at least 256 correspondences (or all
    of them), and never more blocks than the aim needs."""
    sms = 132
    s = hs.split_count(b, h, c, sms)
    blocks = b * -(-h // 256)
    assert 1 <= s <= max(1, c // 256)
    assert s == 1 or -(-c // s) >= 256
    aim = 8 * sms
    assert (s - 1) * blocks < aim
    if blocks >= aim:
        assert s == 1


def _below_limit(thr: np.float32) -> np.float32:
    """The kernel's ``below_limit`` (csrc/hyp_score.cu) in numpy float32."""
    zero, inf = np.float32(0), np.float32(np.inf)
    if not thr > 0:
        return thr if np.isnan(thr) else zero
    q = np.float32(thr * thr)      # inf for a huge thr, as on the card
    while q > 0 and np.sqrt(np.nextafter(q, zero)) >= thr:
        q = np.nextafter(q, zero)
    while np.sqrt(q) < thr:
        q = np.nextafter(q, inf)
    return q


def test_square_root_free_compare_is_exact():
    """For thresholds across the ranges the cells use (and subnormal, huge,
    zero, negative, infinite and NaN ones), ``sqrt(q) < thr`` holds exactly
    when ``q < below_limit(thr)``, for every q within 4 ulps of the limit
    and of thr * thr, and at 0, inf and NaN."""
    rs = np.random.RandomState(0)
    thrs = np.concatenate([
        rs.uniform(0.01, 0.5, 300), rs.uniform(0.5, 20.0, 300),
        np.exp(rs.uniform(-80, 40, 300)),
        [1e-45, 1e-40, 3e19, 3.4e38, 0.0, -1.0, np.inf, np.nan, 0.3, 0.1],
    ]).astype(np.float32)
    for thr in thrs:
        with np.errstate(over="ignore"):
            lim, square = _below_limit(thr), np.float32(thr * thr)
        probes = [np.float32(0), np.float32(np.inf), np.float32(np.nan)]
        for centre in (lim, square):
            if not np.isfinite(centre):
                continue
            q = centre
            for _ in range(4):
                q = np.nextafter(q, np.float32(0))
            for _ in range(9):
                probes.append(q)
                q = np.nextafter(q, np.float32(np.inf))
        for q in probes:
            if q < 0:
                continue
            assert bool(np.sqrt(q) < thr) == bool(q < lim), (thr, q, lim)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the test runs on the chip")
    return torch.device("cuda", 0)


# each cell's shapes: (pairs, hypotheses, correspondences, extent, dist_th,
# similar_th); the consensus scores C candidates against C
CHIP_RANSAC = [(8, 8192, 1500, 3.0, 0.1, 0.8), (8, 8192, 4500, 3.0, 0.1, 0.8),
               (8, 50000, 4500, 100.0, 0.3, 0.9),
               (1, 8192, 4500, 3.0, 0.1, 0.8)]
CHIP_CONSENSUS = [(8, 1500, 3.0), (8, 4500, 3.0), (8, 4500, 100.0),
                  (1, 4500, 3.0)]


@pytest.mark.chip
@pytest.mark.parametrize("shape", CHIP_RANSAC, ids=lambda s: "x".join(
    map(str, s[:3])))
def test_kernel_counts_equal_plain_ransac(card, shape):
    b, h, c, extent, dist_th, similar_th = shape
    R, t, src, tgt, valid, ok = _ransac_case(11, b, h, c, extent, dist_th,
                                             similar_th, device=card)
    got = hs.hyp_score_cuda(R, t, src, tgt, dist_th, valid, ok)
    want = hs.hyp_score_plain(R, t, src, tgt, dist_th, valid, ok, 2048)
    assert torch.equal(got, want)


@pytest.mark.chip
@pytest.mark.parametrize("shape", CHIP_CONSENSUS, ids=lambda s: "x".join(
    map(str, s)))
def test_kernel_counts_equal_plain_consensus(card, shape):
    b, c, extent = shape
    Rc, tc, src, tgt, thr, valid = _consensus_case(12, b, c, extent,
                                                   device=card)
    got = hs.hyp_score_cuda(Rc, tc, src, tgt, thr, valid, valid)
    want = hs.hyp_score_plain(Rc, tc, src, tgt, thr, valid, valid, 512)
    assert torch.equal(got, want)


@pytest.mark.chip
def test_kernel_distances_equal_the_eager_chain(card):
    """The kernel's rounding order: every distance it scores equals the
    eager chain's (einsum, + t, - g, norm) to the bit."""
    R, t, src, tgt, _valid, _ok = _ransac_case(13, 2, 300, 1500, 3.0,
                                               device=card)
    ones_c = torch.ones(src.shape[:2], dtype=torch.bool, device=card)
    ones_h = torch.ones(R.shape[:2], dtype=torch.bool, device=card)
    dist = torch.full((2, 300, 1500), float("nan"), device=card)
    hs.hyp_score_cuda(R.contiguous(), t.contiguous(), src, tgt, 0.1, ones_c,
                      ones_h, dist=dist)
    warped = torch.einsum("bhij,bcj->bhci", R, src) + t[:, :, None, :]
    assert torch.equal(dist, torch.linalg.norm(warped - tgt[:, None], dim=-1))
