"""solver of the PyTorch/CUDA port (counterpart of bufferx_tpu.solver)."""

from bufferx_tpu_torch.solver.consensus import (  # noqa: F401
    cross_scale_consensus,
)
from bufferx_tpu_torch.solver.gnc import gnc_tls_solve  # noqa: F401
from bufferx_tpu_torch.solver.irls import post_refinement  # noqa: F401
from bufferx_tpu_torch.solver.ransac import ransac_pose  # noqa: F401
from bufferx_tpu_torch.solver.so2 import so2_pose_candidates  # noqa: F401
