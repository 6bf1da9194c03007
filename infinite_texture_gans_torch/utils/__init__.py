"""utils of the PyTorch port (see the package docstring)."""

from infinite_texture_gans_torch.utils.metrics import seam_mse

__all__ = ["seam_mse"]
