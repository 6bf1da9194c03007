"""train of the PyTorch port (see the package docstring).

``train`` is resolved at first use: ``python -m
infinite_texture_gans_torch.train.train_loop`` imports this package first,
and a package that imported the module ``-m`` runs would run it twice."""

from infinite_texture_gans_torch.train.losses import d_loss_fake, d_loss_real, g_loss

__all__ = ["d_loss_fake", "d_loss_real", "g_loss", "train"]


def __getattr__(name):
    if name == "train":
        from infinite_texture_gans_torch.train.train_loop import train

        return train
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
