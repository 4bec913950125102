"""Host decode, datasets, the training feeds (``BatchIterator``, the packed
file and its native reader, the resident store) and batch preprocessing.

The JAX package's exports; ``data/packed.py`` (ctypes, the g++ build) is
imported from its module, as in the JAX package.
"""

from pldepth_torch.data.datasets import DATASETS, SyntheticDepthDataset, get_dataset
from pldepth_torch.data.pipeline import (
    BatchIterator,
    pregenerate_val_rankings,
    train_val_split,
    val_batches,
)
from pldepth_torch.data.resident import ResidentStore, build_resident_store
from pldepth_torch.data.scenes import SceneDepthDataset

__all__ = [
    "DATASETS",
    "BatchIterator",
    "ResidentStore",
    "SceneDepthDataset",
    "SyntheticDepthDataset",
    "build_resident_store",
    "get_dataset",
    "pregenerate_val_rankings",
    "train_val_split",
    "val_batches",
]
