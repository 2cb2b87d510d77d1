"""BUFFER-X in PyTorch + CUDA for NVIDIA Hopper (H100).

The counterpart of :mod:`bufferx_tpu` (the JAX/Pallas package, which stays
the reference): the same module names, PyTorch idiom inside (``nn.Module``s,
plain functions on tensors, explicit ``device`` arguments and
``torch.Generator``s, batch dimensions written out instead of ``vmap``).
Every Pallas kernel on the ported path is a hand-written CUDA kernel for
``sm_90a`` under :mod:`bufferx_tpu_torch.csrc`, built with ``nvcc`` at first
use; each has a plain PyTorch twin in the same module, which runs only for
tensors that live on the CPU.

Geometry and solver code is float32 with TF32 off (the JAX code pins
``Precision.HIGHEST`` there), so both switches are cleared at import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from bufferx_tpu_torch.config import make_cfg  # noqa: E402,F401
