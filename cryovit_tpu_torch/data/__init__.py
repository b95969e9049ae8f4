"""Host-side data: preprocessing, datasets, batching and loading."""

from cryovit_tpu_torch.data.datamodules import FileDataModule
from cryovit_tpu_torch.data.datasets import FileDataset, random_crop
from cryovit_tpu_torch.data.pipeline import BucketSpec, DataLoader, collate

__all__ = ["BucketSpec", "DataLoader", "FileDataModule", "FileDataset", "collate", "random_crop"]
