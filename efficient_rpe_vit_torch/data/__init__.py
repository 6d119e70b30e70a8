from .datasets import compute_dataset_stats, get_dataloaders, get_sample_batch, load_dataset
from .io import read_cifar10_batches, read_idx_images, read_idx_labels
from .pipeline import DeviceDataset, augment_cifar, augment_mnist, normalize_images

__all__ = [
    "read_idx_images",
    "read_idx_labels",
    "read_cifar10_batches",
    "load_dataset",
    "get_dataloaders",
    "get_sample_batch",
    "compute_dataset_stats",
    "DeviceDataset",
    "normalize_images",
    "augment_mnist",
    "augment_cifar",
]
