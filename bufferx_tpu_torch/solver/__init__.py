"""solver of the PyTorch/CUDA port (counterpart of bufferx_tpu.solver)."""
