"""data of the PyTorch port (see the package docstring)."""

from infinite_texture_gans_torch.data.datasets import (
    MultipleImagesDataset,
    Prefetcher,
    SingleImageDataset,
    prepare_data,
)

__all__ = ["SingleImageDataset", "MultipleImagesDataset", "Prefetcher", "prepare_data"]
