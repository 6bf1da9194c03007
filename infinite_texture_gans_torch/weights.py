"""Carry weights between the flax variable tree and the port's modules.

The port's module names follow the flax paths, so the walk is mechanical:
``params/block4/conv1/conv/kernel`` becomes ``block4.conv1.conv.weight``
(HWIO -> OIHW), BN ``scale``/``bias`` stay parameters under the same names,
``batch_stats`` ``mean``/``var`` become buffers, the attention ``gamma``
scalar carries over, and the ``spectral`` power-iteration vectors ``u``/``v``
become the SN convs' buffers (the port keeps ``v`` in the reference's
order). :func:`to_jax_variables` is the inverse, for the checkpoint writer.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

# state-dict leaf name -> variable collection, for the leaves not in 'params'
_COLLECTION_OF = {"mean": "batch_stats", "var": "batch_stats", "u": "spectral", "v": "spectral"}


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


def from_jax_variables(variables: Mapping[str, Mapping], *, spectral: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """flax ``{'params': ..., 'batch_stats': ..., 'spectral': ...}`` (numpy
    arrays or tensors) -> a state dict for the port's module. Each leaf
    yields exactly one entry. ``spectral``: keep the SN vectors (a
    discriminator, or a generator trained with SN); without it they are
    dropped, as for a generator rebuilt with SN off."""
    state: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection == "spectral" and not spectral:
            continue
        if collection not in ("params", "batch_stats", "spectral"):
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


def to_jax_variables(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    """The inverse of :func:`from_jax_variables`: a module's state dict ->
    ``{'params': ..., 'batch_stats': ..., 'spectral': ...}`` nested dicts of
    numpy arrays (float32; OIHW weights back to HWIO kernels). Collections
    without leaves are left out."""
    out: Dict[str, Dict[str, Any]] = {}
    for key, t in state.items():
        *modules, name = key.split(".")
        collection = _COLLECTION_OF.get(name, "params")
        a = t.detach().cpu()
        if name == "weight":
            name = "kernel"
            a = a.permute(2, 3, 1, 0) if a.dim() == 4 else a.t()
        node = out.setdefault(collection, {})
        for m in modules:
            node = node.setdefault(m, {})
        node[name] = a.float().numpy().copy()
    return out
