"""Host-side data: preprocessing, datasets, split policies, batching and loading."""

from cryovit_tpu_torch.data.datamodules import (
    BaseDataModule,
    FileDataModule,
    FractionalDataModule,
    FractionalSampleDataModule,
    MultiSampleDataModule,
    SingleSampleDataModule,
)
from cryovit_tpu_torch.data.datasets import FileDataset, TomoDataset, VITDataset, random_crop
from cryovit_tpu_torch.data.pipeline import BucketSpec, DataLoader, collate

__all__ = [
    "BaseDataModule",
    "BucketSpec",
    "DataLoader",
    "FileDataModule",
    "FileDataset",
    "FractionalDataModule",
    "FractionalSampleDataModule",
    "MultiSampleDataModule",
    "SingleSampleDataModule",
    "TomoDataset",
    "VITDataset",
    "collate",
    "random_crop",
]
