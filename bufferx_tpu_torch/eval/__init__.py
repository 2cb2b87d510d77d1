from bufferx_tpu_torch.eval.metrics import (  # noqa: F401
    evaluate_registration_rmse,
    pairwise_recall,
    transformation_error,
)
