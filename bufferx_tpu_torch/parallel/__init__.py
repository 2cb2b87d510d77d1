from bufferx_tpu_torch.parallel.bundle import (  # noqa: F401
    LandmarkGraph,
    bundle_adjust,
    robust_weight,
)
from bufferx_tpu_torch.parallel.mesh import Mesh, make_mesh, spawn  # noqa: F401
from bufferx_tpu_torch.parallel.posegraph import (  # noqa: F401
    PoseGraph,
    chain_initialization,
    pose_graph_gauss_newton,
)
from bufferx_tpu_torch.parallel.sharded import (  # noqa: F401
    make_sharded_eval,
    make_sharded_train_step,
)
