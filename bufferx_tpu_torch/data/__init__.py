"""data of the PyTorch/CUDA port (counterpart of bufferx_tpu.data)."""

from bufferx_tpu_torch.data.modelnet import synthetic_pair  # noqa: F401
