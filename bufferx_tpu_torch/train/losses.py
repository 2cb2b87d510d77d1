"""Training losses.

Counterpart of :mod:`bufferx_tpu.train.losses`: the batch-hard contrastive
descriptor loss with safe-radius masking (optionally mined both ways), the
cross-entropy over the azimuth-shift logits (Desc stage) and the Huber loss
on the predicted SO(2) index (Pose stage), all aware of padded slots; and
the reference's variants that the default trainer does not use (with a
second-order-similarity term, hardest-contrastive, class-balanced inlier
classification, transformation loss).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "contrastive_loss",
    "so2_cross_entropy",
    "huber_loss",
    "contrastive_loss_with_sos",
    "hardest_contrastive_loss",
    "inlier_classification_loss",
    "transformation_loss",
]

_BIG = 1e5


def _masked_mean(per: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    vf = valid.to(per.dtype)
    return torch.sum(per * vf) / torch.clamp_min(torch.sum(vf), 1.0)


def _pair_dists(anchor: torch.Tensor, positive: torch.Tensor) -> torch.Tensor:
    diff = anchor[:, None, :] - positive[None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)    # [N, N]


def contrastive_loss(anchor, positive, dist_keypts, valid,
                     pos_margin: float = 0.1, neg_margin: float = 1.4,
                     safe_radius: float = 0.10, dist_keypts_src=None):
    """Batch-hard contrastive loss of slot-aligned descriptors anchor/positive
    [N, C]; returns (loss, accuracy). Negatives within ``safe_radius`` of the
    positive (``dist_keypts`` [N, N] among target keypoints) are excluded;
    invalid slots take neither role. With ``dist_keypts_src`` the hardest
    source descriptor per target is mined too (columns)."""
    n = anchor.shape[0]
    dists = _pair_dists(anchor, positive)
    eye = torch.eye(n, dtype=torch.bool, device=anchor.device)
    pair_invalid = ~(valid[:, None] & valid[None, :])
    near_t = (dist_keypts < safe_radius) & ~eye
    row_dists = dists + _BIG * (near_t | pair_invalid | eye).to(dists.dtype)

    furthest_positive = torch.sqrt(
        torch.sum((anchor - positive) ** 2, dim=-1) + 1e-12)
    closest_negative = torch.amin(row_dists, dim=1)
    per_slot = torch.clamp_min(furthest_positive - pos_margin, 0.0) \
        + torch.clamp_min(neg_margin - closest_negative, 0.0)
    if dist_keypts_src is not None:
        near_s = (dist_keypts_src < safe_radius) & ~eye
        col_dists = dists + _BIG * (near_s | pair_invalid | eye).to(
            dists.dtype)
        closest_negative_col = torch.amin(col_dists, dim=0)
        per_slot = per_slot + torch.clamp_min(
            neg_margin - closest_negative_col, 0.0)
        closest_negative = torch.minimum(closest_negative,
                                         closest_negative_col)
    loss = _masked_mean(per_slot, valid)
    acc = _masked_mean((furthest_positive < closest_negative).to(dists.dtype),
                       valid)
    return loss, acc


def so2_cross_entropy(logits, labels, valid):
    """Masked cross-entropy and accuracy of the azimuth-shift logits
    [N, azi_n] against integer bins [N]. A label outside the bins (from
    non-finite inputs) gives a NaN term, as ``take_along_axis`` fills it,
    for the guarded step to reject."""
    logp = F.log_softmax(logits, dim=-1)
    labels = labels.long()
    inside = (labels >= 0) & (labels < logits.shape[-1])
    picked = torch.gather(logp, 1, torch.where(inside, labels, 0)[:, None])
    nll = -torch.where(inside, picked[:, 0], float("nan"))
    loss = _masked_mean(nll, valid)
    hit = (torch.argmax(logits, dim=-1) == labels).to(logits.dtype)
    return loss, _masked_mean(hit, valid)


def huber_loss(pred, target, valid, delta: float = 1.0):
    """Masked Huber loss (``torch.nn.HuberLoss`` per element)."""
    err = torch.abs(pred - target)
    quad = torch.clamp_max(err, delta)
    per = 0.5 * quad * quad + delta * (err - quad)
    return _masked_mean(per, valid)


def contrastive_loss_with_sos(anchor, positive, dist_keypts, valid,
                              pos_margin: float = 0.1,
                              neg_margin: float = 1.4,
                              safe_radius: float = 0.10,
                              sos_weight: float = 0.1):
    """Contrastive loss plus the second-order-similarity term: the RMS
    difference of the two descriptor sets' valid Gram matrices."""
    base, acc = contrastive_loss(anchor, positive, dist_keypts, valid,
                                 pos_margin=pos_margin, neg_margin=neg_margin,
                                 safe_radius=safe_radius)
    pair = (valid[:, None] & valid[None, :]).to(anchor.dtype)
    sim_a = anchor @ anchor.T * pair
    sim_p = positive @ positive.T * pair
    sos = torch.sqrt(torch.sum((sim_a - sim_p) ** 2)
                     / torch.clamp_min(torch.sum(pair), 1.0))
    return base + sos_weight * sos, acc


def hardest_contrastive_loss(anchor, positive, valid,
                             pos_margin: float = 0.1,
                             neg_margin: float = 1.4):
    """FCGF-style hardest-contrastive loss: the positive distance and the
    hardest negative both ways."""
    dists = _pair_dists(anchor, positive)
    n = anchor.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=anchor.device)
    invalid = ~(valid[:, None] & valid[None, :])
    masked = dists + _BIG * (eye | invalid).to(dists.dtype)
    pos_d = torch.sqrt(torch.sum((anchor - positive) ** 2, dim=-1) + 1e-12)
    per = (torch.clamp_min(pos_d - pos_margin, 0.0)
           + 0.5 * torch.clamp_min(neg_margin - torch.amin(masked, dim=1), 0.0)
           + 0.5 * torch.clamp_min(neg_margin - torch.amin(masked, dim=0),
                                   0.0))
    return _masked_mean(per, valid)


def inlier_classification_loss(logits, labels, valid):
    """Class-balanced binary cross-entropy of inlier logits [N] against
    {0, 1} labels: each class weighs half."""
    vf = valid.to(logits.dtype)
    lab = labels.to(logits.dtype)
    n_pos = torch.clamp_min(torch.sum(lab * vf), 1.0)
    n_neg = torch.clamp_min(torch.sum((1.0 - lab) * vf), 1.0)
    w = torch.where(labels > 0, 0.5 / n_pos, 0.5 / n_neg) * vf
    bce = -(lab * F.logsigmoid(logits) + (1.0 - lab) * F.logsigmoid(-logits))
    return torch.sum(bce * w) / torch.clamp_min(torch.sum(w), 1e-9)


def transformation_loss(pred_pose, gt_pose, loss_type: str = "frobenius"):
    """Rotation plus translation error of a [4, 4] pose: chordal
    (``frobenius``) or angular (``geodesic``) rotation term, L2
    translation."""
    R_p, R_g = pred_pose[:3, :3], gt_pose[:3, :3]
    t_loss = torch.linalg.norm(pred_pose[:3, 3] - gt_pose[:3, 3])
    if loss_type == "frobenius":
        r_loss = torch.linalg.norm(R_p - R_g)
    elif loss_type == "geodesic":
        cos = torch.clamp((torch.trace(R_p.T @ R_g) - 1.0) / 2.0, -1.0, 1.0)
        r_loss = torch.arccos(cos)
    else:
        raise ValueError(loss_type)
    return r_loss + t_loss
