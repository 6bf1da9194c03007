"""Texture quality metrics: SIFID, an LPIPS-style distance, the Gram
distance, power-spectrum and colour statistics, and their CLI.

Port of ``infinite_texture_gans_tpu/utils/quality.py``. The metrics'
arithmetic is the reference's; the feature extractor is pluggable. With a
pretrained torchvision AlexNet state dict on a local path (``--weights`` or
``$ITG_QUALITY_WEIGHTS``) its five LPIPS conv taps run as ``F.conv2d`` and
the scores are comparable with published ones. Without one (nothing is
downloaded) the default, with a visible notice, is a fixed random
conv/ReLU/avg-pool pyramid: random-filter features are a standard stand-in
for texture statistics (Ustyuzhaninov et al. 2017), and the score compares
any two models evaluated with the same pyramid.

The default pyramid is the JAX package's own draw (``jax.random.key(1234)``,
which PyTorch cannot reproduce), stored once in ``random_pyramid.npz`` beside
this file (three HWIO float32 kernels, 5x5x3x16, 5x5x16x32, 5x5x32x64), so
the port's scores and the README's SIFID ranges use one yardstick.

The features run on the extractor's device (``F.conv2d``, float32); the
SIFID statistics in numpy, the LPIPS and Gram sums in float32 tensors, as
the reference computes each.

Usage (CLI):
    python -m infinite_texture_gans_torch.utils.quality \\
        --image examples/241_tpu_crop_1024x2048.jpg --data_path datasets/241.jpg
(``--device cpu`` without a card.) Every entry point runs its features on
the card unless the caller passes ``device="cpu"`` (or a ``features_fn``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from infinite_texture_gans_torch import resolve_device

FeaturesFn = Callable[[np.ndarray], List[torch.Tensor]]

#: the JAX package's default pyramid, drawn from jax.random.key(1234)
PYRAMID_FILE = Path(__file__).with_name("random_pyramid.npz")


def _input(img, device) -> torch.Tensor:
    """An (N, H, W, C) image batch (an array or a tensor) as a float32 NCHW
    view on ``device``."""
    if isinstance(img, torch.Tensor):
        x = img.to(device=device, dtype=torch.float32)
    else:
        x = torch.as_tensor(np.asarray(img, dtype=np.float32), device=device)
    return x.permute(0, 3, 1, 2)


def _pyramid(kernels: Sequence[torch.Tensor], device) -> FeaturesFn:
    ws = [k.to(device) for k in kernels]

    def features(img) -> List[torch.Tensor]:
        feats = []
        with torch.no_grad():
            h = _input(img, device)
            for w in ws:
                h = torch.relu(F.conv2d(h, w, padding=w.shape[-1] // 2))
                feats.append(h.permute(0, 2, 3, 1))
                h = F.avg_pool2d(h, 2)
        return feats

    return features


def stored_pyramid() -> List[np.ndarray]:
    """The JAX package's default pyramid kernels, HWIO float32."""
    with np.load(PYRAMID_FILE, allow_pickle=False) as f:
        return [f[f"w{i}"] for i in range(len(f.files))]


_default_cache: Dict[str, FeaturesFn] = {}


def random_conv_features(device="cuda") -> FeaturesFn:
    """The default extractor: the stored pyramid (the JAX package's
    ``random_conv_features()``), a fixed random conv/ReLU/avg-pool stack:
    img (N, H, W, 3) in [-1, 1] -> one (N, h_i, w_i, c_i) float32 feature
    map per level, on ``device`` (cached per device)."""
    device = resolve_device(device)
    key = str(device)
    if key not in _default_cache:
        kernels = [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in stored_pyramid()]
        _default_cache[key] = _pyramid(kernels, device)
    return _default_cache[key]


#: ImageNet normalisation (applied to [-1, 1] inputs taken to [0, 1])
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

#: torchvision AlexNet ``features`` convs: (key index, stride, pad), with a
#: 3x3 / stride-2 max-pool after the ReLU of layers 0 and 3 (the last pool
#: follows the last tap, so it never matters)
_ALEXNET_CONVS = ((0, 4, 2), (3, 1, 2), (6, 1, 1), (8, 1, 1), (10, 1, 1))
_ALEXNET_POOL_AFTER = {0, 3}


def alexnet_features_from_state_dict(sd, device="cuda") -> FeaturesFn:
    """The LPIPS/SIFID extractor from a torchvision ``alexnet`` state dict
    (``features.{0,3,6,8,10}.{weight,bias}``, the five conv taps LPIPS uses,
    Zhang et al. 2018), on ``device``. Widths are read off the dict, so
    reduced-width stubs drive the same path."""
    device = resolve_device(device)
    layers: List[Tuple[torch.Tensor, torch.Tensor, int, int, bool]] = []
    for idx, stride, pad in _ALEXNET_CONVS:
        w = torch.as_tensor(np.asarray(sd[f"features.{idx}.weight"], np.float32), device=device)
        b = torch.as_tensor(np.asarray(sd[f"features.{idx}.bias"], np.float32), device=device)
        layers.append((w, b, stride, pad, idx in _ALEXNET_POOL_AFTER))
    mean = torch.tensor(_IMAGENET_MEAN, device=device).reshape(1, 3, 1, 1)
    std = torch.tensor(_IMAGENET_STD, device=device).reshape(1, 3, 1, 1)

    def features(img) -> List[torch.Tensor]:
        feats = []
        with torch.no_grad():
            x = ((_input(img, device) + 1.0) / 2.0 - mean) / std
            for w, b, stride, pad, pool in layers:
                x = torch.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
                feats.append(x.permute(0, 2, 3, 1))
                if pool:
                    x = F.max_pool2d(x, 3, 2)
        return feats

    return features


#: names a local AlexNet weights file (a torchvision state dict, or a
#: checkpoint dict holding one under 'state_dict')
WEIGHTS_ENV = "ITG_QUALITY_WEIGHTS"

_resolve_cache: Dict[Tuple[str, str], FeaturesFn] = {}


def resolve_features_fn(weights_path: Optional[str] = None, verbose: bool = True,
                        device="cuda") -> FeaturesFn:
    """The extractor every metric defaults to: pretrained AlexNet features
    when a weights file is given (``weights_path`` or ``$ITG_QUALITY_WEIGHTS``),
    else the default random pyramid with a one-time notice. The file is
    read with ``torch.load(weights_only=True)`` only; a file that fails
    that load gets a notice and the random pyramid. The features run on
    ``device``; every metric called without ``features_fn`` takes this
    one, on the card."""
    device = resolve_device(device)
    path = weights_path or os.environ.get(WEIGHTS_ENV)
    key = (path or "", str(device))
    if key in _resolve_cache:
        return _resolve_cache[key]
    fn = None
    if path:
        try:
            obj = torch.load(path, map_location="cpu", weights_only=True)
            sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
            fn = alexnet_features_from_state_dict(
                {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}, device)
            if verbose:
                print(f"quality metrics: pretrained AlexNet features ({path})")
        except Exception as e:  # a missing file, other keys, a file that needs unpickling
            print(f"quality metrics: failed to load pretrained weights from {path!r} ({e}); "
                  "falling back to the fixed random pyramid", file=sys.stderr)
            fn = None
    if fn is None:
        if path is None and verbose:
            print(f"quality metrics: no pretrained weights (set ${WEIGHTS_ENV} to an AlexNet "
                  "state_dict for paper-comparable scores); using the fixed random pyramid",
                  file=sys.stderr)
        fn = random_conv_features(device=device)
    _resolve_cache[key] = fn
    return fn


def _numpy(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _tensor(t) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t, np.float32))


# --- SIFID: the Frechet distance between the spatial feature distributions
# of one real and one generated image (SinGAN, Shaham et al. 2019)


def _stats(feat: np.ndarray):
    """(H*W, C) spatial feature samples -> (mu, cov)."""
    mu = feat.mean(axis=0)
    cov = np.cov(feat, rowvar=False)
    return mu, np.atleast_2d(cov)


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """FID between two Gaussians; the matrix square root by symmetric eigh."""
    diff = mu1 - mu2
    w, v = np.linalg.eigh(cov1)
    sq1 = (v * np.sqrt(np.clip(w, 0, None))) @ v.T
    inner = sq1 @ cov2 @ sq1
    w2 = np.linalg.eigvalsh((inner + inner.T) / 2)
    tr_sqrt = np.sqrt(np.clip(w2, 0, None)).sum()
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * tr_sqrt)


def sifid(real: np.ndarray, fake: np.ndarray, features_fn: Optional[FeaturesFn] = None,
          level: int = 1) -> float:
    """Single-image FID of (H, W, 3) images in [-1, 1] (sizes may differ)
    at the feature pyramid's ``level``."""
    features_fn = features_fn or resolve_features_fn()
    fr = _numpy(features_fn(np.asarray(real)[None])[level])[0]
    ff = _numpy(features_fn(np.asarray(fake)[None])[level])[0]
    mur, covr = _stats(fr.reshape(-1, fr.shape[-1]))
    muf, covf = _stats(ff.reshape(-1, ff.shape[-1]))
    return frechet_distance(mur, covr, muf, covf)


# --- the LPIPS-style distance: unit-normalised deep features, squared
# differences averaged over positions and layers (Zhang et al. 2018)


def lpips_distance(a: np.ndarray, b: np.ndarray,
                   features_fn: Optional[FeaturesFn] = None) -> float:
    """a, b: (H, W, 3) in [-1, 1], of the SAME size (LPIPS is positional)."""
    features_fn = features_fn or resolve_features_fn()
    fa = features_fn(np.asarray(a)[None])
    fb = features_fn(np.asarray(b)[None])
    total = 0.0
    for xa, xb in zip(fa, fb):
        xa, xb = _tensor(xa), _tensor(xb)
        na = xa / (torch.linalg.vector_norm(xa, dim=-1, keepdim=True) + 1e-10)
        nb = xb / (torch.linalg.vector_norm(xb, dim=-1, keepdim=True) + 1e-10)
        total += float(((na - nb) ** 2).sum(dim=-1).mean())
    return total / len(fa)


# --- statistics without a pretrained network


def gram_distance(a: np.ndarray, b: np.ndarray,
                  features_fn: Optional[FeaturesFn] = None) -> float:
    """Normalised Gram-matrix (texture statistics) distance; any sizes."""
    features_fn = features_fn or resolve_features_fn()
    fa = features_fn(np.asarray(a)[None])
    fb = features_fn(np.asarray(b)[None])
    total = 0.0
    for xa, xb in zip(fa, fb):
        xa, xb = _tensor(xa), _tensor(xb)
        va = xa[0].reshape(-1, xa.shape[-1])
        vb = xb[0].reshape(-1, xb.shape[-1])
        ga = va.T @ va / va.shape[0]
        gb = vb.T @ vb / vb.shape[0]
        total += float(((ga - gb) ** 2).mean() / ((ga ** 2).mean() + 1e-10))
    return total / len(fa)


def radial_spectrum(img: np.ndarray, bins: int = 64) -> np.ndarray:
    """Radially averaged log power spectrum of the grayscale image."""
    gray = img.mean(axis=-1)
    gray = gray - gray.mean()
    # normalised by the pixel count: comparable across image sizes
    f = np.abs(np.fft.fftshift(np.fft.fft2(gray))) ** 2 / gray.size
    h, w = f.shape
    ry = (np.arange(h) - h / 2)[:, None]
    rx = (np.arange(w) - w / 2)[None, :]
    r = np.hypot(ry, rx)
    r = (r / (r.max() + 1e-9) * (bins - 1)).astype(np.int32).ravel()
    sums = np.bincount(r, weights=f.ravel(), minlength=bins)
    counts = np.bincount(r, minlength=bins)
    return np.log1p(sums / np.maximum(counts, 1))


def spectrum_distance(a: np.ndarray, b: np.ndarray, bins: int = 64) -> float:
    """L2 between radially averaged log power spectra (periodicity)."""
    return float(np.mean((radial_spectrum(a, bins) - radial_spectrum(b, bins)) ** 2))


def color_histogram_distance(a: np.ndarray, b: np.ndarray, bins: int = 32) -> float:
    """Mean per-channel chi-square distance between colour histograms."""
    total = 0.0
    for ch in range(a.shape[-1]):
        ha, _ = np.histogram(a[..., ch], bins=bins, range=(-1, 1), density=True)
        hb, _ = np.histogram(b[..., ch], bins=bins, range=(-1, 1), density=True)
        total += float(np.sum((ha - hb) ** 2 / (ha + hb + 1e-10)))
    return total / a.shape[-1]


def texture_quality_report(source: np.ndarray, generated: np.ndarray,
                           features_fn: Optional[FeaturesFn] = None) -> dict:
    """Every size-agnostic metric of a generated texture against its source."""
    features_fn = features_fn or resolve_features_fn()
    return {
        "sifid_rand": sifid(source, generated, features_fn),
        "gram_dist": gram_distance(source, generated, features_fn),
        "spectrum_dist": spectrum_distance(source, generated),
        "color_hist_chi2": color_histogram_distance(source, generated),
    }


def load_image(path: str) -> np.ndarray:
    """An image file as (H, W, 3) float32 in [-1, 1]."""
    from PIL import Image

    im = np.asarray(Image.open(path).convert("RGB"), np.float32)
    return im / 127.5 - 1.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image", required=True, help="generated texture image")
    ap.add_argument("--data_path", required=True, help="source texture image")
    ap.add_argument("--self_baseline", action="store_true",
                    help="also score two disjoint halves of the source against each other "
                         "(the 'perfect texture' floor)")
    ap.add_argument("--weights", default=None,
                    help="local pretrained AlexNet state_dict (.pth) for paper-comparable "
                         f"features; default: ${WEIGHTS_ENV} or the fixed random pyramid")
    ap.add_argument("--device", default="cuda",
                    help="device of the feature convs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    features_fn = resolve_features_fn(args.weights, device=args.device)
    src = load_image(args.data_path)
    gen = load_image(args.image)
    report = {"image": args.image, **texture_quality_report(src, gen, features_fn)}
    if args.self_baseline:
        h = src.shape[0] // 2
        report["baseline_self"] = texture_quality_report(src[:h], src[h:], features_fn)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
