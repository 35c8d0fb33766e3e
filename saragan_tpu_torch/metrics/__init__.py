"""Evaluation metrics of the port (counterpart of ``saragan_tpu/metrics``): FID over
Inception or random-conv features, SWD, SSIM, PSNR, MSE, NRMSE and the KS distance."""

from saragan_tpu_torch.metrics.fid import (  # noqa: F401
    calculate_fid_given_batch_volumes,
    frechet_distance,
)
from saragan_tpu_torch.metrics.kms import kolmogorov_smirnov_distance  # noqa: F401
from saragan_tpu_torch.metrics.save_metrics import save_metrics  # noqa: F401
from saragan_tpu_torch.metrics.skim import (  # noqa: F401
    get_mean_squared_error,
    get_normalized_root_mse,
    get_psnr,
    get_ssim,
    structural_similarity,
)
from saragan_tpu_torch.metrics.swd import get_swd_for_volumes  # noqa: F401
