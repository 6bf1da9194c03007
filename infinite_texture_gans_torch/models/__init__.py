"""models of the PyTorch port (see the package docstring)."""

from infinite_texture_gans_torch.models.discriminator import (
    DCDiscriminator,
    PatchDiscriminator,
    ResDiscriminator,
    SNDiscriminator,
)
from infinite_texture_gans_torch.models.generator import (
    ResidualPatchGenerator,
    generator_site_specs,
)

__all__ = [
    "ResidualPatchGenerator",
    "generator_site_specs",
    "PatchDiscriminator",
    "ResDiscriminator",
    "DCDiscriminator",
    "SNDiscriminator",
]
