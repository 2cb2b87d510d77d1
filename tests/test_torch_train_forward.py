"""Port parity of the training forward: the flat ball query and
``select_patches`` (equal indices), ``sample_gt_correspondences``,
``cal_so2_gt``, train-mode BatchNorm (outputs and new running statistics),
``embed_training`` and both stage losses with their gradients, each held
against the JAX function on the same inputs with JAX's draws fed in, at
``tests/test_train.py``'s sizes (max_points 1024, 64-point patches,
pos_num 32).

Tolerances (float32 on both sides; convolutions, matrix products and
reductions sum in another order in XLA and in PyTorch): activations, losses
and running statistics within 2e-5 of the largest magnitude, at least 1
(measured <= 1.3e-5, the train-mode descriptor through ten BatchNorm
layers). Gradients: within 1e-2 relative L2 over all of a model's tensors
and 5e-2 of each tensor's largest magnitude against JAX (measured: Desc
6.8e-4 and 1.1e-2, Pose 3.6e-3 and 2.2e-2), and within 1e-3 relative L2
of the port's own float64 evaluation (measured 4.3e-5 for Pose). Train-mode
BatchNorm's backward subtracts batch means of the incoming gradient, which
makes the float32 gradient ill-conditioned; JAX's float32 gradient is the
farther of the two from float64, so the JAX comparison cannot be tighter.
Indices and masks are equal. ``cal_so2_gt``'s continuous label within
1e-4 bins; rounded labels equal except where the continuous label lies
within 1e-4 of a bin edge (the two ``arccos`` differ in the last bits).
"""

import copy
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bufferx_tpu.config import make_cfg as jax_make_cfg
from bufferx_tpu.data.training import build_training_batch as jax_build_batch
from bufferx_tpu.data.modelnet import synthetic_pair as jax_synthetic_pair
from bufferx_tpu.geometry.patches import select_patches as jax_select_patches
from bufferx_tpu.kernels.neighbors import ball_query as jax_ball_query
from bufferx_tpu.kernels.neighbors import masked_sqdist as jax_masked_sqdist
from bufferx_tpu.models.layers import ConvBNRelu as JaxConvBNRelu
from bufferx_tpu.pipeline.registration import build_models as jax_build_models
from bufferx_tpu.train import forward as jfwd
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.geometry.patches import select_patches
from bufferx_tpu_torch.kernels.neighbors import ball_query
from bufferx_tpu_torch.models.layers import ConvBNRelu, running_stats
from bufferx_tpu_torch.train import forward as tfwd
from bufferx_tpu_torch.train.trainer import train_models
from bufferx_tpu_torch.tools.weights import (
    DESC_MODULES,
    POSE_MODULES,
    load_snapshot,
    params_from_numpy,
)
from test_torch_pipeline import few_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SNAP = os.path.join(ROOT, "snapshot", "hard_moments_r4ft2")
SNAP_SAMPLED = os.path.join(ROOT, "snapshot", "hard")
TINY = dict(capacity=dict(max_points=1024, sphere_query_chunk=32),
            patch=dict(num_points_per_patch=64),
            train=dict(pos_num=32))
ACT_TOL = 2e-5
GRAD_TOL = 1e-2          # relative L2 error over all of a model's gradients
GRAD_TENSOR_TOL = 5e-2   # each tensor, against its largest magnitude
F64_GRAD_TOL = 1e-3      # the port in f32 against itself in f64


def _close(ref, got, tol, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(ref - got).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _restore(snap, stage):
    with open(os.path.join(snap, stage, "best.msgpack"), "rb") as f:
        tree = flax.serialization.msgpack_restore(f.read())
    return jax.tree.map(jnp.asarray, tree)


def jax_draws(key, k, n):
    """The draws JAX's stage losses make from ``key``: the patch query's
    offsets of both halves and the target half's SO(2) angles."""
    offs, angles = [], []
    for kh in jax.random.split(key):
        ka, k3 = jax.random.split(kh)
        offs.append(np.array(jax.random.randint(ka, (k, 1), 0, n))[:, 0])
        angles.append(np.array(jax.random.uniform(k3, (k,)) * 2.0 * jnp.pi))
    return tfwd.TrainDraws(torch.from_numpy(offs[0]).long(),
                           torch.from_numpy(offs[1]).long(),
                           torch.from_numpy(angles[1]))


def torch_batch(batch):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
           if k != "is_aligned"}
    out["is_aligned"] = bool(batch["is_aligned"])
    return out


def cfgs(mode="moments"):
    jcfg = jax_make_cfg("ModelNet40").override(
        **{**TINY, "patch": dict(TINY["patch"], desc_mode=mode)})
    tcfg = make_cfg("ModelNet40").override(
        **{**TINY, "patch": dict(TINY["patch"], desc_mode=mode)})
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    """A tiny host batch (JAX's builder), the shipped moments weights in
    both packages, JAX's draws for one step."""
    jcfg, tcfg = cfgs()
    rs = np.random.RandomState(0)
    s, t, T = jax_synthetic_pair(rs, num_points=2500, overlap=0.8)
    batch = jax_build_batch(jcfg, s, t, T, rs, None, host_arrays=True)
    key = jax.random.PRNGKey(5)
    variables = {"desc": _restore(SNAP, "Desc"), "pose": _restore(SNAP, "Pose")}
    desc, pose = train_models(tcfg, load_snapshot(SNAP), "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, key=key,
                variables=variables, desc=desc, pose=pose,
                draws=jax_draws(key, jcfg.train.pos_num,
                                jcfg.capacity.max_points))


# ---- the flat ball query ----------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ball_query_and_select_patches_equal_indices(seed):
    rs = np.random.RandomState(seed)
    n, k = 1024, 48
    pts = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    mask = rs.rand(n) < 0.9
    centers = pts[rs.choice(n, k)] + rs.randn(k, 3).astype(np.float32) * 0.01
    radius = np.float32([0.15, 0.3, 0.6][seed])
    key = jax.random.PRNGKey(seed)
    j_idx, j_valid = jax_ball_query(jnp.asarray(pts), jnp.asarray(mask),
                                    jnp.asarray(centers), radius, key, 64)
    off = torch.from_numpy(
        np.array(jax.random.randint(key, (k, 1), 0, n))[:, 0]).long()
    t_idx, t_valid = ball_query(torch.from_numpy(pts), torch.from_numpy(mask),
                                torch.from_numpy(centers),
                                torch.tensor(radius), off, 64)
    assert np.array_equal(np.asarray(j_valid), t_valid.numpy())
    assert np.array_equal(np.asarray(j_idx), t_idx.numpy())
    assert 0 < t_valid.float().mean() < 1          # both kinds of slot
    j_p, j_m = jax_select_patches(jnp.asarray(pts), jnp.asarray(mask),
                                  jnp.asarray(centers), radius, key, 64)
    t_p, t_m = select_patches(torch.from_numpy(pts), torch.from_numpy(mask),
                              torch.from_numpy(centers), torch.tensor(radius),
                              off, 64)
    assert np.array_equal(np.asarray(j_m), t_m.numpy())
    assert np.array_equal(np.asarray(j_p), t_p.numpy())


def test_select_patches_refuses_other_queries():
    """The block and the stratified branches of ``select_patches`` against
    the JAX function, with its offsets and its d2: equal patches and masks
    (``tests/test_torch_queries.py`` holds the dispatch and warnings)."""
    rs = np.random.RandomState(4)
    n, k, s = 1024, 40, 32
    pts = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    mask = rs.rand(n) < 0.9
    centers = pts[rs.choice(n, k)]
    d2 = np.array(jax_masked_sqdist(
        jnp.asarray(centers), jnp.asarray(pts), jnp.ones(k, bool),
        jnp.asarray(mask), precise=False))
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    offsets = {
        "use_blocks": np.stack([
            np.array(jax.random.randint(k1, (k, 1), 0, n // 32))[:, 0],
            np.array(jax.random.randint(k2, (k, 1), 0, 32 * 32))[:, 0]]),
        "use_strat": np.array(jax.random.randint(key, (k, 1, s), 0,
                                                 n // s))[:, 0],
    }
    for flag, off in offsets.items():
        j_p, j_m = jax_select_patches(
            jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(centers),
            np.float32(0.3), key, s, d2=jnp.asarray(d2), **{flag: True})
        t_p, t_m = select_patches(
            torch.from_numpy(pts), torch.from_numpy(mask),
            torch.from_numpy(centers), torch.tensor(np.float32(0.3)),
            torch.from_numpy(off), s, d2=torch.from_numpy(d2),
            **{flag: True})
        assert np.array_equal(np.asarray(j_m), t_m.numpy()), flag
        assert np.array_equal(np.asarray(j_p), t_p.numpy()), flag
        assert 0 < float(t_m.float().mean()) < 1, flag


# ---- ground-truth correspondences -------------------------------------------
@pytest.mark.parametrize("voxel", [0.02, 0.05])
def test_sample_gt_correspondences(setup, voxel):
    rs = np.random.RandomState(3)
    n = 600
    src = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.linalg.qr(rs.randn(3, 3))[0].astype(np.float32)
    T[:3, 3] = [0.3, -0.2, 0.1]
    tgt = (src @ T[:3, :3].T + T[:3, 3]
           + rs.randn(n, 3).astype(np.float32) * 0.02).astype(np.float32)
    sm, tm = rs.rand(n) < 0.95, rs.rand(n) < 0.95
    key = jax.random.PRNGKey(11)
    js, jt, jv = jfwd.sample_gt_correspondences(
        jnp.asarray(src), jnp.asarray(sm), jnp.asarray(tgt), jnp.asarray(tm),
        jnp.asarray(T), jnp.float32(voxel), key, 64)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    ts, tt, tv = tfwd.sample_gt_correspondences(
        torch.from_numpy(src), torch.from_numpy(sm), torch.from_numpy(tgt),
        torch.from_numpy(tm), torch.from_numpy(T), voxel, noise, 64)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert 0 < tv.sum() <= 64


def test_sample_gt_correspondences_ties_go_to_the_lower_index():
    src = torch.zeros(6, 3)
    noise = torch.tensor([0.5, 0.9, 0.5, 0.9, 0.1, 0.9])
    s, t, v = tfwd.sample_gt_correspondences(
        src, torch.ones(6, dtype=torch.bool), src,
        torch.ones(6, dtype=torch.bool), torch.eye(4), 0.01, noise, 4)
    assert v.all()
    # equal noise: the order lax.top_k gives, lower index first
    js = jfwd.sample_gt_correspondences(
        jnp.zeros((6, 3)), jnp.ones(6, bool), jnp.zeros((6, 3)),
        jnp.ones(6, bool), jnp.eye(4), jnp.float32(0.01),
        jax.random.PRNGKey(0), 4)
    assert np.asarray(js[2]).all()
    order = torch.sort(torch.where(torch.ones(6, dtype=torch.bool), noise,
                                   -1.0), descending=True, stable=True)[1]
    assert order[:4].tolist() == [1, 3, 5, 0]


# ---- SO(2) labels -------------------------------------------------------------
def _random_frames(rs, k):
    q = np.stack([np.linalg.qr(rs.randn(3, 3))[0] for _ in range(2 * k + 1)])
    q = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    axis = rs.randn(k, 3).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    return axis, q[:k], q[k:2 * k], q[-1]


@pytest.mark.parametrize("augment", [False, True])
def test_cal_so2_gt(augment):
    rs = np.random.RandomState(4)
    k, azi = 4000, 20
    axis, sR, tR, gt = _random_frames(rs, k)
    aug = None
    if augment:
        ang = rs.uniform(0, 2 * np.pi, k).astype(np.float32)
        c, s = np.cos(ang), np.sin(ang)
        aug = np.zeros((k, 3, 3), np.float32)
        aug[:, 0, 0], aug[:, 0, 1], aug[:, 1, 0], aug[:, 1, 1] = c, -s, s, c
        aug[:, 2, 2] = 1.0
    args = (axis, sR, tR, gt)
    jf = np.asarray(jfwd.cal_so2_gt(*map(jnp.asarray, args), azi,
                                    aug_R=None if aug is None else
                                    jnp.asarray(aug), integer=False))
    tf = tfwd.cal_so2_gt(*map(torch.from_numpy, args), azi,
                         aug_R=None if aug is None else torch.from_numpy(aug),
                         integer=False).numpy()
    ji = np.asarray(jfwd.cal_so2_gt(*map(jnp.asarray, args), azi,
                                    aug_R=None if aug is None else
                                    jnp.asarray(aug), integer=True))
    ti = tfwd.cal_so2_gt(*map(torch.from_numpy, args), azi,
                         aug_R=None if aug is None else torch.from_numpy(aug),
                         integer=True).numpy()
    # the wrap at azi_n maps labels near 20 to 0 on one side only
    gap = np.minimum(np.abs(jf - tf), azi - np.abs(jf - tf))
    assert gap.max() <= 1e-4
    edge = np.abs(jf - np.floor(jf) - 0.5) <= 1e-4
    flips = (ji != ti) & ~edge
    assert not flips.any()
    assert int((ji != ti).sum()) <= int(edge.sum())


def test_cal_so2_gt_at_bin_edges():
    """Rotations about z by exact bin centres and half-bin edges, in the
    global frame: centres give the bin on both sides; at the 20 half-bin
    edges the two packages round the same way (pinned: 0 flips)."""
    azi = 20
    theta = np.concatenate([np.arange(azi), np.arange(azi) + 0.5]) \
        * 2 * np.pi / azi
    k = len(theta)
    eye = np.tile(np.eye(3, dtype=np.float32), (k, 1, 1))
    ax = np.tile([[1.0, 0.0, 0.0]], (k, 1)).astype(np.float32)
    c, s = np.cos(theta), np.sin(theta)
    aug = np.zeros((k, 3, 3), np.float32)
    aug[:, 0, 0], aug[:, 0, 1], aug[:, 1, 0], aug[:, 1, 1] = c, -s, s, c
    aug[:, 2, 2] = 1.0
    gt = np.eye(3, dtype=np.float32)
    ji = np.asarray(jfwd.cal_so2_gt(jnp.asarray(ax), jnp.asarray(eye),
                                    jnp.asarray(eye), jnp.asarray(gt), azi,
                                    aug_R=jnp.asarray(aug), integer=True))
    ti = tfwd.cal_so2_gt(torch.from_numpy(ax), torch.from_numpy(eye),
                         torch.from_numpy(eye), torch.from_numpy(gt), azi,
                         aug_R=torch.from_numpy(aug), integer=True).numpy()
    assert np.array_equal(ti[:azi], np.arange(azi))
    assert int((ji != ti).sum()) == 0


# ---- train-mode BatchNorm ---------------------------------------------------
@pytest.mark.parametrize("affine,kernel", [(False, (3, 3)), (True, (1, 1)),
                                           (False, (3, 1, 3))])
def test_conv_bn_relu_train_mode(affine, kernel):
    rs = np.random.RandomState(5)
    cin, cout = 6, 8
    x = rs.randn(*((4,) + (5,) * len(kernel) + (cin,))).astype(np.float32)
    jm = JaxConvBNRelu(cout, kernel, bn_affine=affine)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # every leaf moved off its initial value; running variances positive
    v = jax.tree.map(
        lambda a: jnp.abs(a + jnp.asarray(rs.randn(*a.shape) * 0.3, a.dtype)),
        v)
    out, mutated = jm.apply(v, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    p, st = v["params"], v["batch_stats"]["BatchNorm_0"]
    tm = ConvBNRelu(cin, cout, kernel, bn_affine=affine)
    with torch.no_grad():
        w = np.asarray(p["Conv_0"]["kernel"])
        tm.weight.copy_(torch.from_numpy(np.moveaxis(w, (-1, -2), (0, 1))))
        tm.bias.copy_(torch.from_numpy(np.asarray(p["Conv_0"]["bias"])))
        if affine:
            tm.bn_scale.copy_(torch.from_numpy(
                np.asarray(p["BatchNorm_0"]["scale"])))
            tm.bn_bias.copy_(torch.from_numpy(
                np.asarray(p["BatchNorm_0"]["bias"])))
        tm.bn_mean.copy_(torch.from_numpy(np.asarray(st["mean"])))
        tm.bn_var.copy_(torch.from_numpy(np.asarray(st["var"])))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1)).contiguous()
    tm.train()
    bn = {}
    got = tm(xt, bn)
    _close(out, torch.movedim(got, 1, -1), ACT_TOL, "output")
    new = running_stats(tm, bn)
    jst = mutated["batch_stats"]["BatchNorm_0"]
    _close(jst["mean"], new["bn_mean"], ACT_TOL, "running mean")
    _close(jst["var"], new["bn_var"], ACT_TOL, "running var")
    # the forward leaves the buffers alone
    assert torch.equal(tm.bn_mean, torch.from_numpy(np.asarray(st["mean"])))
    # eval mode normalizes with the running statistics, as before
    tm.eval()
    _close(jm.apply(v, jnp.asarray(x), train=False),
           torch.movedim(tm(xt), 1, -1), ACT_TOL, "eval output")


def test_batch_variance_is_biased_and_clamped():
    from bufferx_tpu_torch.models.layers import batch_moments

    x = torch.tensor([[1.0], [3.0]])
    mean, var = batch_moments(x, channel_dim=1)
    assert float(mean) == 2.0 and float(var) == 1.0   # biased: /N, not /N-1
    x = torch.full((7, 1), 0.1)
    assert float(batch_moments(x, channel_dim=1)[1]) >= 0.0


@pytest.mark.parametrize("mode", ["moments", "sampled"])
def test_minispinnet_train_mode(mode):
    """The whole descriptor net in training mode: outputs and every layer's
    new running statistics."""
    snap = SNAP if mode == "moments" else SNAP_SAMPLED
    jcfg, tcfg = cfgs(mode)
    rs = np.random.RandomState(6)
    x = (rs.randn(12, 10, 420) * 0.5 if mode == "moments"
         else rs.randn(12, 420, 10, 3) * 0.3).astype(np.float32)
    jdesc, _ = jax_build_models(jcfg)
    jv = _restore(snap, "Desc")
    out, mutated = jax.jit(lambda v, x: jdesc.apply(
        v, x, train=True, mutable=["batch_stats"]))(jv, jnp.asarray(x))
    desc, _ = train_models(tcfg, load_snapshot(snap), "cpu")
    bn = {}
    got = desc(torch.from_numpy(x), bn)
    _close(out["desc"], got["desc"], ACT_TOL, "desc")
    _close(out["equi"], got["equi"], ACT_TOL, "equi")
    want = params_from_numpy({"batch_stats": jax.tree.map(
        np.asarray, mutated["batch_stats"])}, DESC_MODULES)
    new = running_stats(desc, bn)
    assert sorted(want) == sorted(new)
    for k in want:
        _close(want[k], new[k], ACT_TOL, k)


# ---- embedding and the stage losses -----------------------------------------
@pytest.mark.parametrize("augment", [False, True])
def test_embed_training(setup, augment):
    jcfg, b = setup["jcfg"], setup["batch"]
    jdesc, _ = jax_build_models(jcfg)
    key = jax.random.PRNGKey(9)
    ka, k3 = jax.random.split(key)
    k, n = jcfg.train.pos_num, jcfg.capacity.max_points
    j = jax.jit(lambda v, key: jfwd.embed_training(
        v, jdesc, jfwd.TrainStatics.from_config(jcfg),
        jnp.asarray(b["src_fds"]), jnp.asarray(b["src_fds_mask"]),
        jnp.asarray(b["src_kpt"]), jnp.asarray(b["des_r"]),
        jnp.asarray(b["is_aligned"]), key, so2_augment=augment))(
            setup["variables"]["desc"], key)
    off = torch.from_numpy(
        np.array(jax.random.randint(ka, (k, 1), 0, n))[:, 0]).long()
    angles = torch.from_numpy(np.array(
        jax.random.uniform(k3, (k,)) * 2.0 * jnp.pi)) if augment else None
    tb = torch_batch(b)
    bn = {}
    t = tfwd.embed_training(setup["desc"],
                            tfwd.TrainStatics.from_config(setup["tcfg"]),
                            tb["src_fds"], tb["src_fds_mask"], tb["src_kpt"],
                            tb["des_r"], tb["is_aligned"], off, angles, bn)
    for name in ("desc", "equi", "R", "rand_axis", "aug_R"):
        _close(j[name], t[name], ACT_TOL, name)
    want = params_from_numpy({"batch_stats": jax.tree.map(
        np.asarray, j["batch_stats"])}, DESC_MODULES)
    new = running_stats(setup["desc"], bn)
    for key_ in want:
        _close(want[key_], new[key_], ACT_TOL, key_)


def _grad_errors(ref: dict, got: dict):
    """(relative L2 error over all tensors, largest error of a tensor
    against its largest magnitude, or against 1e-3 of the largest gradient
    where that is larger: a conv bias before train-mode BatchNorm has a
    gradient of 0 up to rounding)."""
    assert sorted(ref) == sorted(got)
    ref = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    got = {k: np.asarray(v.detach().double().numpy() if torch.is_tensor(v)
                         else v, np.float64) for k, v in got.items()}
    top = max(float(np.abs(r).max()) for r in ref.values())
    num = sum(float(np.sum((ref[k] - got[k]) ** 2)) for k in ref)
    den = sum(float(np.sum(r ** 2)) for r in ref.values())
    worst = max(float(np.abs(ref[k] - got[k]).max())
                / max(float(np.abs(ref[k]).max()), 1e-3 * top) for k in ref)
    return (num / den) ** 0.5, worst


def _f64(model):
    """A float64 copy of a port model (weights and compute dtype): the
    reference that says which of two float32 gradients is the closer."""
    twin = copy.deepcopy(model).double()
    for m in twin.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return twin


def _grads(loss, model) -> dict:
    params = dict(model.named_parameters())
    return dict(zip(params, torch.autograd.grad(loss,
                                                list(params.values()))))


def _check_stage_grads(jgrads, tgrads, t64grads, modules):
    want = params_from_numpy({"params": jax.tree.map(np.asarray, jgrads)},
                             modules)
    l2, worst = _grad_errors(want, tgrads)
    assert l2 <= GRAD_TOL and worst <= GRAD_TENSOR_TOL, (l2, worst)
    l2_64, _ = _grad_errors(t64grads, tgrads)
    assert l2_64 <= F64_GRAD_TOL, l2_64


def test_desc_stage_loss_and_grad(setup):
    jcfg, b, key = setup["jcfg"], setup["batch"], setup["key"]
    jdesc, _ = jax_build_models(jcfg)
    jst = jfwd.TrainStatics.from_config(jcfg)
    jb = jax.tree.map(jnp.asarray, b)
    v = setup["variables"]["desc"]

    def loss_fn(p):
        return jfwd.desc_stage_loss({**v, "params": p}, jdesc, jst, jb, key)

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    tst = tfwd.TrainStatics.from_config(setup["tcfg"])
    tloss, taux = tfwd.desc_stage_loss(setup["desc"], tst, torch_batch(b),
                                       setup["draws"])
    _close(jloss, tloss, ACT_TOL, "loss")
    for name in ("desc_loss", "desc_acc", "eqv_loss", "eqv_acc"):
        _close(jaux[name], taux[name], ACT_TOL, name)
    want = params_from_numpy({"batch_stats": jax.tree.map(
        np.asarray, jaux["batch_stats"])}, DESC_MODULES)
    assert sorted(want) == sorted(taux["batch_stats"])
    for k in want:
        _close(want[k], taux["batch_stats"][k], ACT_TOL, k)
    desc64 = _f64(setup["desc"])
    loss64, _ = tfwd.desc_stage_loss(desc64, tst, torch_batch(b),
                                     setup["draws"])
    _check_stage_grads(jgrads, _grads(tloss, setup["desc"]),
                       _grads(loss64, desc64), DESC_MODULES)


def test_pose_stage_loss_and_grad(setup):
    jcfg, b, key = setup["jcfg"], setup["batch"], setup["key"]
    jdesc, jpose = jax_build_models(jcfg)
    jst = jfwd.TrainStatics.from_config(jcfg)
    jb = jax.tree.map(jnp.asarray, b)
    v = setup["variables"]["pose"]

    def loss_fn(p):
        return jfwd.pose_stage_loss({**v, "params": p},
                                    setup["variables"]["desc"], jdesc, jpose,
                                    jst, jb, key)

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    tst = tfwd.TrainStatics.from_config(setup["tcfg"])
    tloss, taux = tfwd.pose_stage_loss(setup["pose"], setup["desc"], tst,
                                       torch_batch(b), setup["draws"])
    _close(jloss, tloss, ACT_TOL, "loss")
    want = params_from_numpy({"batch_stats": jax.tree.map(
        np.asarray, jaux["batch_stats"])}, POSE_MODULES)
    assert sorted(want) == sorted(taux["batch_stats"])
    for k in want:
        _close(want[k], taux["batch_stats"][k], ACT_TOL, k)
    pose64 = _f64(setup["pose"])
    loss64, _ = tfwd.pose_stage_loss(pose64, _f64(setup["desc"]), tst,
                                     torch_batch(b), setup["draws"])
    _check_stage_grads(jgrads, _grads(tloss, setup["pose"]),
                       _grads(loss64, pose64), POSE_MODULES)


def test_stage_losses_need_training_mode(setup):
    st = tfwd.TrainStatics.from_config(setup["tcfg"])
    setup["desc"].eval()
    try:
        with pytest.raises(ValueError, match="training mode"):
            tfwd.desc_stage_loss(setup["desc"], st, torch_batch(setup["batch"]),
                                 setup["draws"])
    finally:
        setup["desc"].train()


def test_cell_kernels_refuse_inputs_that_require_grad():
    from bufferx_tpu_torch.geometry.spt_pallas import spt_cell_query, spt_moments

    p = torch.zeros(2, 8, 3, requires_grad=True)
    m = torch.ones(2, 8, dtype=torch.bool)
    c = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="grad"):
        spt_moments(p, m, c, 0.01)
    with pytest.raises(ValueError, match="grad"):
        spt_cell_query(p, m, c, 0.1, 2)
