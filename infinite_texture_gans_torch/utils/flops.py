"""Analytic FLOP count and the card's peak rates, for model-FLOPs utilisation.

Port of ``infinite_texture_gans_tpu/utils/flops.py``: counts the
matmul-shaped FLOPs (convolutions, attention contractions) of the port's
generator and PatchGAN forwards and composes them into per-train-step and
per-canvas totals, so a measured wall can be given as a share of the card's
peak (MFU). Elementwise work (norms, activations, upsamples, residual adds,
the EMA and Adam updates) is left out: it is O(activations) against the
convs' O(activations x channels x taps), under 1% of the model FLOPs at
the flagship's shapes (it does cost wall time, which is what MFU shows).

Backward convention (the usual 2x rule): a differentiated forward costs 3x
its forward FLOPs (the forward, then the dW and dx convolutions); a
backward that needs only input gradients (the G update through the frozen
D) costs about 1x, so that pass totals 2x. The composition follows the
fused step: the last D iteration's G forward is reused for the G update.

The shapes are the port's modules' (``generator_channel_plan``, the
PatchGAN's k4 convs); the counts equal the JAX package's for the same
configuration.

:data:`CARD_PEAKS` holds each card's HBM rate, dense bf16 tensor-core rate
and float32 rate outside the tensor cores, keyed by
``torch.cuda.get_device_name``; :func:`peak_flops` reads it and returns
None for the CPU or a card not in the table, never a guess.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from infinite_texture_gans_torch.models.generator import generator_channel_plan


def conv2d_flops(cin: int, cout: int, k: int, out_h: int, out_w: int) -> int:
    """2 * MACs of a k x k convolution producing an (out_h, out_w, cout) map."""
    return 2 * cin * cout * k * k * out_h * out_w


def attention_flops(channels: int, h: int, w: int) -> int:
    """SAGAN self-attention on one (h, w, C) patch (``models/layers.py:
    Attention``): theta/phi C->C/8, g C->C/2, o C/2->C 1x1 convs (phi and g
    on the 2x2-max-pooled map), plus the theta^T phi and attn @ g
    contractions."""
    hw = h * w
    hw4 = (h // 2) * (w // 2)  # phi/g are 2x2 max-pooled
    c8, c2 = channels // 8, channels // 2
    f = conv2d_flops(channels, c8, 1, h, w)  # theta
    f += conv2d_flops(channels, c8, 1, h // 2, w // 2)  # phi (pooled)
    f += conv2d_flops(channels, c2, 1, h // 2, w // 2)  # g (pooled)
    f += conv2d_flops(c2, channels, 1, h, w)  # o
    f += 2 * hw * hw4 * c8  # scores = theta^T phi
    f += 2 * hw * hw4 * c2  # out = attn @ g
    return f


def generator_forward_flops(G, *, num_images: int = 1, gh: Optional[int] = None,
                            gw: Optional[int] = None) -> int:
    """Conv FLOPs of ONE generator forward on a (gh x gw)-patch merged grid
    (training uses the module's own grid; the raster calls each sub-image
    with the same 3x3 grid): the start conv, the residual blocks (conv1,
    conv2, the 1x1 shortcut), the SSM embed chains, the per-patch attention
    and the final conv."""
    gh = G.num_patches_h if gh is None else gh
    gw = G.num_patches_w if gw is None else gw
    br = G.base_res
    plan = generator_channel_plan(G.G_ch, G.n_layers_G)

    total = conv2d_flops(G.z_dim, G.G_ch * 8, 3, gh * br, gw * br)  # start
    for i, (cin, cout) in enumerate(plan, start=1):
        r = br * (2 ** (i - 1))
        h_i, w_i = gh * r, gw * r
        total += conv2d_flops(cin, cout, 3, h_i, w_i)  # conv1
        total += conv2d_flops(cout, cout, 3, h_i, w_i)  # conv2
        if cin != cout:
            total += conv2d_flops(cin, cout, 1, h_i, w_i)  # shortcut
        if G.type_norm == "SSM":
            # bn1 (cin), bn2 (cout), bn3 (cin, learnable shortcut only): each
            # runs mlp_shared (map_dim -> 128) and embed (128 -> 2C) 3x3 convs
            ssm_sites = [cin, cout] + ([cin] if cin != cout else [])
            for c in ssm_sites:
                total += conv2d_flops(G.map_dim, 128, 3, h_i, w_i)
                total += conv2d_flops(128, 2 * c, 3, h_i, w_i)
        if i == 3 and G.attention is not None:
            # per patch: the patches are the attention's batch
            r3 = br * 4
            total += gh * gw * attention_flops(plan[2][1], r3, r3)
    P = br * (2 ** (G.n_layers_G - 1))
    total += conv2d_flops(plan[-1][1], G.img_ch, 3, gh * P, gw * P)  # final
    return total * num_images


def discriminator_forward_flops(D, h: int, w: int, batch: int, in_ch: int = 3) -> int:
    """Conv FLOPs of one PatchDiscriminator forward on a (batch, h, w,
    in_ch) input: the k4 s2 stem, n_layers_D - 1 convs doubling the channels
    (cap 512), stride 2 but the last, the k4 s1 conv to one logit."""
    base_ch, _, k, _ = D.conv0.weight.shape
    p = 1

    def out_size(size: int, stride: int) -> int:
        return (size + 2 * p - k) // stride + 1

    h, w = out_size(h, 2), out_size(w, 2)
    total = conv2d_flops(in_ch, base_ch, k, h, w)
    nf = base_ch
    for n in range(1, D.n_layers_D):
        cin, nf = nf, min(nf * 2, 512)
        stride = 1 if n == D.n_layers_D - 1 else 2
        h, w = out_size(h, stride), out_size(w, stride)
        total += conv2d_flops(cin, nf, k, h, w)
    h, w = out_size(h, 1), out_size(w, 1)
    total += conv2d_flops(nf, 1, k, h, w)
    return total * batch


def train_step_flops(G, D, *, batch_size: int, crop: int, num_images: int,
                     disc_iters: int = 1) -> int:
    """Model FLOPs of ONE fused G + D train step: per D iteration a fresh G
    forward (only the last is differentiated; it serves the G update) and a
    differentiated D pass on real and fake; then the G update's D forward
    with its dx-only backward, and G's backward."""
    g_fwd = generator_forward_flops(G, num_images=num_images)
    P = G.patch_resolution
    fake_hw = (G.num_patches_h * P, G.num_patches_w * P)
    d_real = discriminator_forward_flops(D, crop, crop, batch_size, G.img_ch)
    d_fake = discriminator_forward_flops(D, *fake_hw, num_images, G.img_ch)

    total = (disc_iters - 1) * g_fwd  # forward-only G samples
    total += 3 * g_fwd  # the last G forward and its backward
    total += disc_iters * 3 * (d_real + d_fake)  # D updates (forward, dW and dx)
    total += 2 * d_fake  # G update: D forward and dx-only backward
    return total


def canvas_flops(G, out_h: int, out_w: int, num_images: int = 1) -> int:
    """Conv FLOPs of one canvas of the raster engine: steps_h x steps_w
    sub-images, each a 3x3-grid G forward."""
    P = G.patch_resolution
    steps_h = -(-max(out_h // P - 1, 1) // 2)  # ceil((out/P - 1) / 2)
    steps_w = -(-max(out_w // P - 1, 1) // 2)
    return steps_h * steps_w * generator_forward_flops(G, num_images=num_images)


class CardPeaks(NamedTuple):
    bytes_per_s: float  # HBM
    bf16_flop_per_s: float  # dense, tensor cores
    f32_flop_per_s: float  # CUDA cores (TF32 off)


#: The NVIDIA H100 SXM's name as ``torch.cuda.get_device_name`` gives it.
H100_SXM = "NVIDIA H100 80GB HBM3"

#: Peak rates per card, from the data sheet, by ``torch.cuda.get_device_name``.
CARD_PEAKS = {
    H100_SXM: CardPeaks(bytes_per_s=3.35e12, bf16_flop_per_s=989e12, f32_flop_per_s=67e12),
}


def peak_flops(device, compute_dtype: str = "bfloat16") -> Optional[float]:
    """The card's peak FLOP/s for ``compute_dtype`` ('bfloat16': dense
    tensor-core rate; 'float32': the CUDA cores' rate), or None on the CPU
    or for a card not in :data:`CARD_PEAKS`; callers then leave MFU out."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    peaks = CARD_PEAKS.get(torch.cuda.get_device_name(dev))
    if peaks is None:
        return None
    return peaks.bf16_flop_per_s if compute_dtype == "bfloat16" else peaks.f32_flop_per_s
