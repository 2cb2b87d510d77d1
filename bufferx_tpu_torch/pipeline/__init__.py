"""pipeline of the PyTorch/CUDA port (counterpart of bufferx_tpu.pipeline).

The JAX package's ``register_pair_jit`` is an XLA dispatch form; its
counterpart is :func:`register_pair` (or :func:`register_batch` for a
batch)."""

from bufferx_tpu_torch.pipeline.registration import (  # noqa: F401
    Cloud,
    RegistrationResult,
    build_models,
    init_params,
    prepare_cloud,
    register_batch,
    register_pair,
    register_pairs_batched,
)
