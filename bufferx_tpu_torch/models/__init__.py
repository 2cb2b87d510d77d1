"""models of the PyTorch/CUDA port (counterpart of bufferx_tpu.models)."""

from bufferx_tpu_torch.models.heads import (  # noqa: F401
    CostVolume,
    equi_match_scores,
)
from bufferx_tpu_torch.models.spinnet import MiniSpinNet  # noqa: F401
