"""Variable trees -> reference PyTorch checkpoints (``.pth``).

Port of ``infinite_texture_gans_tpu/utils/torch_export.py``, the inverse
of ``utils/torch_import.py``: a generator's (or a PatchGAN's) flax-style
variable tree, as a port ``.ckpt`` stores it or the importer builds it,
becomes the reference's state dict (its ``models/generators.py`` and
``models/discriminators.py`` names) inside the reference's checkpoint dict
(``{'netG_state_dict', 'args', ...}``), so models trained by the port go
back to the reference's PyTorch tools unchanged.

Conversions (each the importer's inverse): HWIO kernels -> OIHW;
``scale``/``bias`` + ``batch_stats`` -> BN ``weight``/``bias``/
``running_mean``/``running_var`` and ``num_batches_tracked`` (int64, from
the ``torch_extras`` side tree where the importer kept it, else 0); SSM's
``mlp_shared`` conv -> ``mlp_shared.0``; a ``spectral`` collection -> the
torch SN buffers ``weight_orig``/``weight_u``/``weight_v`` of each covered
conv, ``v`` permuted from the HWIO-flat order back to torch's OIHW-flat
order.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a)


def _t(a) -> torch.Tensor:
    """An array (numpy, or a tensor: a ``.ckpt``'s bfloat16 leaves) -> a
    float32 CPU tensor of its own (the reference's parameter dtype)."""
    a = _np(a)
    if a.dtype != np.float32:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True))


def _conv(sd: Dict[str, Any], params: Dict[str, Any], tkey: str,
          sn: Optional[Dict[str, Any]] = None) -> None:
    """params {kernel HWIO, bias?} -> ``tkey.weight`` (OIHW) [+ ``.bias``];
    with spectral state ``sn`` ({u, v}) the SN buffer set instead."""
    kernel = _np(params["kernel"])
    oihw = kernel.transpose(3, 2, 0, 1)
    if sn is not None:
        sd[f"{tkey}.weight_orig"] = _t(oihw)
        if "u" in sn:
            sd[f"{tkey}.weight_u"] = _t(sn["u"])
        if "v" in sn:
            kh, kw, i, _ = kernel.shape
            v = _np(sn["v"]).reshape(kh, kw, i).transpose(2, 0, 1).reshape(-1)
            sd[f"{tkey}.weight_v"] = _t(v)
    else:
        sd[f"{tkey}.weight"] = _t(oihw)
    if "bias" in params:
        sd[f"{tkey}.bias"] = _t(params["bias"])


def _bn(sd, tkey: str, params: Optional[Dict[str, Any]], stats: Dict[str, Any],
        extras: Optional[Dict[str, Any]] = None) -> None:
    if params is not None:  # affine BN
        sd[f"{tkey}.weight"] = _t(params["scale"])
        sd[f"{tkey}.bias"] = _t(params["bias"])
    sd[f"{tkey}.running_mean"] = _t(stats["mean"])
    sd[f"{tkey}.running_var"] = _t(stats["var"])
    nbt = (extras or {}).get("num_batches_tracked", 0)
    sd[f"{tkey}.num_batches_tracked"] = torch.tensor(int(nbt), dtype=torch.int64)


def _node(tree: Optional[Dict[str, Any]], *path) -> Optional[Dict[str, Any]]:
    """Walk ``path`` through nested dicts; None wherever absent."""
    for k in path:
        if not isinstance(tree, dict):
            return None
        tree = tree.get(k)
    return tree


def export_generator_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Generator variables -> the reference ``ResidualPatchGenerator``'s
    state dict (loads with ``strict=True``). The topology (conv3, bn3, SSM
    or BN, attention) is read off the tree; a ``spectral`` collection
    exports each covered conv as SN buffers."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    spectral = variables.get("spectral", {})
    extras = variables.get("torch_extras", {})
    sd: Dict[str, torch.Tensor] = {}

    _conv(sd, params["start"]["conv"], "start.conv", _node(spectral, "start", "conv"))
    blocks = sorted((k for k in params if k.startswith("block")), key=lambda k: int(k[5:]))
    for blk in blocks:
        bp, bs = params[blk], stats.get(blk, {})
        bsn, bex = spectral.get(blk, {}), extras.get(blk, {})
        _conv(sd, bp["conv1"]["conv"], f"{blk}.conv1.conv", _node(bsn, "conv1", "conv"))
        _conv(sd, bp["conv2"]["conv"], f"{blk}.conv2.conv", _node(bsn, "conv2", "conv"))
        if "conv3" in bp:
            _conv(sd, bp["conv3"], f"{blk}.conv3", _node(bsn, "conv3"))
        for bn in ("bn1", "bn2", "bn3"):
            if bn in bp and "mlp_shared" in bp[bn]:  # SSM site
                _bn(sd, f"{blk}.{bn}.bn", None, bs[bn]["bn"], _node(bex, bn, "bn"))
                _conv(sd, bp[bn]["mlp_shared"], f"{blk}.{bn}.mlp_shared.0",
                      _node(bsn, bn, "mlp_shared"))
                _conv(sd, bp[bn]["embed"], f"{blk}.{bn}.embed", _node(bsn, bn, "embed"))
            elif bn in bp:  # BN site
                _bn(sd, f"{blk}.{bn}", bp[bn], bs[bn], _node(bex, bn))
    if "attention" in params:
        ap = params["attention"]["attn"]
        for part in ("theta", "phi", "g", "o"):
            _conv(sd, ap[part], f"attention.{part}", _node(spectral, "attention", "attn", part))
        sd["attention.gamma"] = _t(ap["gamma"])
    if "bn" in params:  # the final BN (BN generators)
        _bn(sd, "bn", params["bn"], stats["bn"], _node(extras, "bn"))
    _conv(sd, params["final"]["conv"], "final.conv", _node(spectral, "final", "conv"))
    return sd


def export_patch_discriminator_state_dict(variables: Dict[str, Any], *,
                                          norm_layer: Optional[str] = None
                                          ) -> Dict[str, torch.Tensor]:
    """PatchDiscriminator variables -> the reference's ``nn.Sequential``
    state dict ([conv, lrelu] + (n_layers_D - 1) x [conv, norm?, lrelu] +
    [conv]). ``norm_layer`` must be the model's: it shifts the indices even
    where the norm has no state (``'instance'``)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    spectral = variables.get("spectral", {})
    extras = variables.get("torch_extras", {})
    sd: Dict[str, torch.Tensor] = {}

    n_layers_D = sum(1 for k in params if k.startswith("conv") and k != "conv_out")
    per = 3 if norm_layer else 2
    idx = 0
    _conv(sd, params["conv0"], f"model.{idx}", spectral.get("conv0"))
    idx += 2  # conv, lrelu
    for n in range(1, n_layers_D):
        _conv(sd, params[f"conv{n}"], f"model.{idx}", spectral.get(f"conv{n}"))
        if norm_layer == "batch":
            _bn(sd, f"model.{idx + 1}", params[f"norm{n}"], stats[f"norm{n}"],
                extras.get(f"norm{n}"))
        idx += per
    _conv(sd, params["conv_out"], f"model.{idx}", spectral.get("conv_out"))
    return sd


def export_generator_pth(path: str, variables: Dict[str, Any], args: Any, *,
                         epoch: Optional[int] = None, gloss: Optional[Sequence[float]] = None,
                         dloss: Optional[Sequence[float]] = None, seed: Optional[int] = None,
                         d_variables: Optional[Dict[str, Any]] = None,
                         d_norm_layer: Optional[str] = None) -> None:
    """Write a reference-format ``.pth``: ``{'netG_state_dict', 'args'}``
    (what the reference's sampling script needs), plus ``netD_state_dict``,
    ``epoch``, ``Gloss``, ``Dloss`` and ``seed`` where given. ``args``: a
    Namespace or a flag dict (a ``.ckpt``'s ``meta['args']``); the port's
    own flags ride along as extra attributes."""
    if not isinstance(args, argparse.Namespace):
        args = argparse.Namespace(**dict(args))
    ckpt: Dict[str, Any] = {"netG_state_dict": export_generator_state_dict(variables),
                            "args": args}
    if d_variables is not None:
        ckpt["netD_state_dict"] = export_patch_discriminator_state_dict(
            d_variables, norm_layer=d_norm_layer)
    if epoch is not None:
        ckpt["epoch"] = int(epoch)
    if gloss is not None:
        ckpt["Gloss"] = list(gloss)
    if dloss is not None:
        ckpt["Dloss"] = list(dloss)
    if seed is not None:
        ckpt["seed"] = int(seed)
    torch.save(ckpt, path)
