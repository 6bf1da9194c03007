"""Carry a generator's weights from the flax variable tree to the port.

The port's module names follow the flax paths, so the walk is mechanical:
``params/block4/conv1/conv/kernel`` becomes ``block4.conv1.conv.weight``
(HWIO -> OIHW), BN ``scale``/``bias`` stay parameters under the same names,
``batch_stats`` ``mean``/``var`` become buffers, and the attention ``gamma``
scalar carries over. The result loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

# The SN power-iteration vectors: an eval generator is rebuilt with SN off
# (as the reference rebuilds it), so they have no module to load into.
_IGNORED_COLLECTIONS = ("spectral",)


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes array from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def from_jax_variables(variables: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """flax ``{'params': ..., 'batch_stats': ...}`` (numpy arrays or
    tensors) -> a state dict for the port's ResidualPatchGenerator. Each
    leaf yields exactly one entry."""
    state: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection in _IGNORED_COLLECTIONS:
            continue
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unexpected variable collection {collection!r}")
        for path, leaf in _leaves(tree):
            *modules, name = path
            t = _tensor(leaf)
            if collection == "params" and name == "kernel":
                name = "weight"
                t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
            key = ".".join([*modules, name])
            if key in state:
                raise ValueError(f"two leaves map to {key!r}")
            state[key] = t.contiguous()
    return state
