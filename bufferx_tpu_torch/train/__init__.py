"""Two-stage training (Desc, then Pose): losses, forward passes, the
guarded optimizer step, the trainer and the collapse guard."""

from bufferx_tpu_torch.train.forward import (  # noqa: F401
    TrainStatics,
    cal_so2_gt,
    desc_stage_loss,
    pose_stage_loss,
    sample_gt_correspondences,
)
from bufferx_tpu_torch.train.losses import (  # noqa: F401
    contrastive_loss,
    huber_loss,
    so2_cross_entropy,
)
