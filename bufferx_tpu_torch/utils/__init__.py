"""utils of the PyTorch/CUDA port (counterpart of bufferx_tpu.utils)."""
from bufferx_tpu_torch.utils.timers import AverageMeter, DeviceTimer, Timer  # noqa: F401
