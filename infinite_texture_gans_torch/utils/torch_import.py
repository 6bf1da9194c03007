"""Reference PyTorch checkpoints (``.pth``) -> flax-style variable trees.

Port of ``infinite_texture_gans_tpu/utils/torch_import.py``: converts the
reference's checkpoints (its ``train.py`` save format; the state-dict names
of its ``models/generators.py`` and ``models/discriminators.py``) into the
nested numpy tree the JAX package's importer builds, which
``weights.from_jax_variables`` then maps onto the port's modules, so one
name map serves both checkpoint formats.

Conversions: OIHW conv weights -> HWIO; ``module.`` DataParallel prefixes
stripped; spectral-norm ``weight_orig``/``weight_u``/``weight_v`` -> kernel
+ ``spectral`` ``u``/``v`` (``v`` permuted from torch's OIHW-flat order to
the HWIO-flat order the port's SN keeps, ``ops/conv.py``); BatchNorm
``weight``/``bias``/``running_*`` -> ``scale``/``bias`` + ``batch_stats``
``mean``/``var``, and ``num_batches_tracked`` into a ``torch_extras`` side
tree that the modules ignore and ``utils/torch_export.py`` restores.

:func:`load_torch_checkpoint` reads with ``torch.load(weights_only=True)``,
allowing ``argparse.Namespace`` (the reference's stored flags) and nothing
else: a file that needs any other global raises before it is unpickled.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def _conv_weight(w) -> np.ndarray:
    """OIHW -> HWIO."""
    return _np(w).transpose(2, 3, 1, 0)


class _TreeBuilder:
    def __init__(self):
        self.params: Dict[str, Any] = {}
        self.batch_stats: Dict[str, Any] = {}
        self.spectral: Dict[str, Any] = {}
        self.torch_extras: Dict[str, Any] = {}

    @staticmethod
    def _set(root, path, value):
        d = root
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = value

    def conv(self, sd, tkey, *path):
        """A conv (plain or spectrally normalised) at params ``path``."""
        if f"{tkey}.weight_orig" in sd:
            w = _np(sd[f"{tkey}.weight_orig"])
            self._set(self.params, (*path, "kernel"), _conv_weight(w))
            if f"{tkey}.weight_u" in sd:
                self._set(self.spectral, (*path, "u"), _np(sd[f"{tkey}.weight_u"]))
            if f"{tkey}.weight_v" in sd:
                # torch flattens (O, I, kh, kw) to (O, I*kh*kw); the HWIO view
                # flattens to (O, kh*kw*I)
                v = _np(sd[f"{tkey}.weight_v"])
                if w.ndim == 4:
                    _, i, kh, kw = w.shape
                    v = v.reshape(i, kh, kw).transpose(1, 2, 0).reshape(-1)
                self._set(self.spectral, (*path, "v"), v)
        else:
            self._set(self.params, (*path, "kernel"), _conv_weight(sd[f"{tkey}.weight"]))
        if f"{tkey}.bias" in sd:
            self._set(self.params, (*path, "bias"), _np(sd[f"{tkey}.bias"]))

    def bn(self, sd, tkey, *path, affine=True):
        if affine:
            self._set(self.params, (*path, "scale"), _np(sd[f"{tkey}.weight"]))
            self._set(self.params, (*path, "bias"), _np(sd[f"{tkey}.bias"]))
        self._set(self.batch_stats, (*path, "mean"), _np(sd[f"{tkey}.running_mean"]))
        self._set(self.batch_stats, (*path, "var"), _np(sd[f"{tkey}.running_var"]))
        if f"{tkey}.num_batches_tracked" in sd:
            # no module reads torch's counter, but an export restores it
            self._set(self.torch_extras, (*path, "num_batches_tracked"),
                      int(_np(sd[f"{tkey}.num_batches_tracked"])))

    def scalar(self, sd, tkey, *path):
        self._set(self.params, path, _np(sd[tkey]))

    def variables(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"params": self.params}
        for name in ("batch_stats", "spectral", "torch_extras"):
            if getattr(self, name):
                out[name] = getattr(self, name)
        return out


def import_generator(sd: Dict[str, Any], *, n_layers_G: int = 6, type_norm: str = "BN",
                     attention: bool = True) -> Dict[str, Any]:
    """Reference ``ResidualPatchGenerator`` state dict -> variables tree.

    Torch module names: ``start.conv``, ``blockN.{conv1,conv2}.conv``,
    ``blockN.conv3``, ``blockN.{bn1,bn2,bn3}`` (SSM: ``.bn``,
    ``.mlp_shared.0``, ``.embed``), ``attention.{theta,phi,g,o,gamma}``,
    ``bn``, ``final.conv``."""
    sd = strip_module_prefix(sd)
    b = _TreeBuilder()
    n_blocks = {4: 4, 5: 5, 6: 6}[n_layers_G]

    b.conv(sd, "start.conv", "start", "conv")
    for i in range(1, n_blocks + 1):
        blk = f"block{i}"
        b.conv(sd, f"{blk}.conv1.conv", blk, "conv1", "conv")
        b.conv(sd, f"{blk}.conv2.conv", blk, "conv2", "conv")
        if f"{blk}.conv3.weight" in sd or f"{blk}.conv3.weight_orig" in sd:
            b.conv(sd, f"{blk}.conv3", blk, "conv3")
        for bn_name in ("bn1", "bn2", "bn3"):
            if type_norm == "BN":
                if f"{blk}.{bn_name}.weight" in sd:
                    b.bn(sd, f"{blk}.{bn_name}", blk, bn_name)
            elif f"{blk}.{bn_name}.bn.running_mean" in sd:  # SSM
                b.bn(sd, f"{blk}.{bn_name}.bn", blk, bn_name, "bn", affine=False)
                b.conv(sd, f"{blk}.{bn_name}.mlp_shared.0", blk, bn_name, "mlp_shared")
                b.conv(sd, f"{blk}.{bn_name}.embed", blk, bn_name, "embed")
    if attention:
        for part in ("theta", "phi", "g", "o"):
            b.conv(sd, f"attention.{part}", "attention", "attn", part)
        b.scalar(sd, "attention.gamma", "attention", "attn", "gamma")
    if type_norm == "BN":
        b.bn(sd, "bn", "bn")
    b.conv(sd, "final.conv", "final", "conv")
    return b.variables()


def import_patch_discriminator(sd: Dict[str, Any], *, n_layers_D: int = 4,
                               norm_layer: Optional[str] = None) -> Dict[str, Any]:
    """Reference ``PatchDiscriminator`` (an ``nn.Sequential``) state dict ->
    variables tree. Layout: [conv, lrelu] + (n_layers_D - 1) x [conv,
    norm?, lrelu] + [conv]; a norm shifts the indices even without state
    (``'instance'``)."""
    sd = strip_module_prefix(sd)
    b = _TreeBuilder()
    idx = 0
    b.conv(sd, f"model.{idx}", "conv0")
    idx += 2  # conv, lrelu
    per = 3 if norm_layer else 2
    for n in range(1, n_layers_D):
        b.conv(sd, f"model.{idx}", f"conv{n}")
        if norm_layer == "batch":
            b.bn(sd, f"model.{idx + 1}", f"norm{n}")
        idx += per
    b.conv(sd, f"model.{idx}", "conv_out")
    return b.variables()


#: the one global a reference checkpoint needs besides tensors and containers
SAFE_GLOBALS = (argparse.Namespace,)


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference ``.pth`` checkpoint as its raw dict (keys ``epoch``,
    ``netG_state_dict``, ``netD_state_dict``, ``Gloss``, ``Dloss``,
    ``args``, ``seed``; an EMA file: ``netG_state_dict``, ``args``), on the
    CPU. Loaded with ``weights_only=True`` and ``argparse.Namespace``
    allowed; a file that needs any other global raises a ``ValueError``
    naming it, and nothing of it is unpickled (no retry without
    ``weights_only``)."""
    try:
        with torch.serialization.safe_globals(list(SAFE_GLOBALS)):
            return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        allowed = {f"{g.__module__}.{g.__qualname__}" for g in SAFE_GLOBALS}
        try:  # a scan of the pickle's opcodes, which builds nothing
            found = torch.serialization.get_unsafe_globals_in_checkpoint(path)
        except Exception:  # not torch.save's format
            found = []
        needs = [g for g in found if g not in allowed]
        raise ValueError(
            f"{path}: the file needs the globals {needs or '(unknown)'}; a reference checkpoint "
            "holds tensors, plain containers and an argparse.Namespace only, and the loader "
            "unpickles nothing else") from e
