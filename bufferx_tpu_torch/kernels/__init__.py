"""kernels of the PyTorch/CUDA port (counterpart of bufferx_tpu.kernels).

Farthest point sampling is ``kernels.fps.fps`` (kernel K1 on the card, its
plain version :func:`farthest_point_sampling_plain` on the CPU); the JAX
name ``farthest_point_sampling`` belongs to its Pallas entry and is not
used here, and the function ``fps`` is not re-exported, because it would
hide the module ``kernels.fps``. Importing builds no kernel: each is built
at its first launch."""

from bufferx_tpu_torch.kernels.fps import (  # noqa: F401
    farthest_point_sampling_plain,
)
from bufferx_tpu_torch.kernels.neighbors import (  # noqa: F401
    ball_query,
    masked_sqdist,
    mutual_nearest,
    nearest_neighbor,
    sqdist,
)
from bufferx_tpu_torch.kernels.radius import density_aware_radius  # noqa: F401
from bufferx_tpu_torch.kernels.voxel import (  # noqa: F401
    voxel_downsample,
    voxel_downsample_np,
)
