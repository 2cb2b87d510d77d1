"""geometry of the PyTorch/CUDA port (counterpart of bufferx_tpu.geometry)."""

from bufferx_tpu_torch.geometry.cylindrical import (  # noqa: F401
    grid_cell_centers,
    spatial_point_transformer,
    var_to_invar,
)
from bufferx_tpu_torch.geometry.lrf import (  # noqa: F401
    align_patches,
    compute_z_axis,
)
from bufferx_tpu_torch.geometry.patches import select_patches  # noqa: F401
from bufferx_tpu_torch.geometry.sphericity import (  # noqa: F401
    sphericity_based_voxel_analysis,
)
