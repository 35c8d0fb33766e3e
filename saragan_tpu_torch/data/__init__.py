"""Data utilities of the port: the npy-pyramid dataset, its prefetcher and the input
normalization."""

from saragan_tpu_torch.data.dataset import NumpyPathDataset, Prefetcher, get_numpy_dataset
from saragan_tpu_torch.data.normalize import (invert_normalize_numpy, normalize_numpy,
                                              stdnormal_to_8bit_numpy)

__all__ = ["NumpyPathDataset", "Prefetcher", "get_numpy_dataset", "invert_normalize_numpy",
           "normalize_numpy", "stdnormal_to_8bit_numpy"]
