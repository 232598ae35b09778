from vq_tpu_torch.data.datasets import (
    Dataset,
    compute_ground_truth,
    load_dummy_dataset,
    load_npy_dataset,
    load_fvecs_dataset,
    get_dataset,
)
from vq_tpu_torch.data.io import load_fvecs, write_fvecs, load_ivecs, write_ivecs

__all__ = [
    "Dataset",
    "compute_ground_truth",
    "load_dummy_dataset",
    "load_npy_dataset",
    "load_fvecs_dataset",
    "get_dataset",
    "load_fvecs",
    "write_fvecs",
    "load_ivecs",
    "write_ivecs",
]
