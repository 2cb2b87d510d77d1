"""pipeline of the PyTorch/CUDA port (counterpart of bufferx_tpu.pipeline)."""
