"""core of the PyTorch/CUDA port (counterpart of bufferx_tpu.core)."""

from bufferx_tpu_torch.core import linalg, se3  # noqa: F401
