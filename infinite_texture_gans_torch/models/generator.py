"""ResidualPatchGenerator — the flagship model, eval and train forward.

Port of ``infinite_texture_gans_tpu/models/generator.py`` for the BN
generator: start conv (z_dim -> 8 G_ch) -> block1 -> up -> block2 -> up ->
block3 -> [attention] -> up -> block4 [-> up -> block5] [-> up -> block6]
-> BN -> act -> final conv -> tanh. Activations are merged NHWC grids; from
the first block that passes the channels-major gate on, the tail runs on
(N, C, H, W) through the CUDA kernels of ``ops/kernels.py``.

In train mode (``.train()``) the forward is the reference's ``train=True``
path (:189-397): batch statistics and running-stat updates, the tail's
BatchNorm moments threaded from kernel to kernel, and with ``out_chw`` the
image stays channels-major for the discriminator's stem. Under
``fuse_up='auto'`` (the default, as in the reference) every channels-major
block but block 1 takes its input at half resolution and runs the
subpixel-fused up-conv (K9, K10); ``'off'`` upsamples first. At eval both
run the unfused tail. Not ported yet (raise): zeros padding mode, SSM norm,
spectral norm, ``fuse_up='all'`` (the fused eval up-conv).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from infinite_texture_gans_torch.models.layers import (
    BNFold,
    ConvLP,
    PatchAttention,
    ResBlockGenerator,
    activation_fn,
)
from infinite_texture_gans_torch.ops import kernels
from infinite_texture_gans_torch.ops.grid import upsample_nearest
from infinite_texture_gans_torch.ops.padding import GridPos, SiteSpec, SiteState


def generator_channel_plan(G_ch: int, n_layers_G: int) -> List[tuple[int, int]]:
    """(in_ch, out_ch) per residual block."""
    plan = [
        (G_ch * 8, G_ch * 8),
        (G_ch * 8, G_ch * 4),
        (G_ch * 4, G_ch * 2),
        (G_ch * 2, G_ch),
    ]
    if n_layers_G >= 5:
        plan.append((G_ch, G_ch // 2))
    if n_layers_G == 6:
        plan.append((G_ch // 2, G_ch // 4))
    return plan


def generator_site_specs(G_ch: int = 52, base_res: int = 4, n_layers_G: int = 6) -> List[SiteSpec]:
    """Halo site inventory in forward-call order: two per residual block
    plus the final conv (the start conv's input z arrives pre-padded)."""
    specs: List[SiteSpec] = []
    plan = generator_channel_plan(G_ch, n_layers_G)
    for i, (cin, cout) in enumerate(plan, start=1):
        res = base_res * (2 ** (i - 1))
        specs.append(SiteSpec(f"block{i}.conv1", res, cin))
        specs.append(SiteSpec(f"block{i}.conv2", res, cout))
    specs.append(SiteSpec("final", base_res * (2 ** (n_layers_G - 1)), plan[-1][1]))
    return specs


class ResidualPatchGenerator(nn.Module):
    """See module docstring. Constructor arguments follow the reference's
    fields. ``dtype`` is the compute type (parameters stay float32).
    ``chw_tail``: 'auto' runs blocks with ``i > 3`` and ``cin <= 128``
    (eval) or ``cin <= 64`` (train) channels-major on any device (the
    boundaries are the reference's TPU-measured gates, a starting point to
    re-measure on the GPU); 'off' keeps every block NHWC, for comparison with
    the reference's XLA path on the CPU only: on a CUDA tensor the tail runs
    the kernels. ``fuse_up``: 'auto' fuses every channels-major training
    block but block 1 with the upsample before it (K9, K10), 'off' does not;
    eval never fuses.

    ``forward(z, halo=None, pos=None, grid=None, out_chw=False)``: z merged
    (N, gh*base_res+2, gw*base_res+2, z_dim) in local mode; returns (merged
    image (N, gh*P, gw*P, img_ch) in [-1, 1], or (N, img_ch, gh*P, gw*P)
    with ``out_chw``; halo dict or None).
    """

    def __init__(self, z_dim: int = 128, G_ch: int = 52, base_res: int = 4,
                 n_layers_G: int = 6, attention: bool = True, img_ch: int = 3,
                 leak: float = 0.0, SN: bool = False, type_norm: str = "BN",
                 padding_mode: str = "local", outer_padding: str = "replicate",
                 num_patches_h: int = 3, num_patches_w: int = 3,
                 dtype: torch.dtype = torch.float32, chw_tail: str = "auto",
                 fuse_up: str = "auto"):
        super().__init__()
        if type_norm != "BN":
            raise NotImplementedError(f"type_norm={type_norm!r}: only 'BN' is ported yet")
        if SN:
            raise NotImplementedError("spectral norm is not ported yet; rebuild with SN=False")
        if chw_tail not in ("auto", "off"):
            raise ValueError(f"chw_tail must be 'auto' or 'off', got {chw_tail!r}")
        if fuse_up not in ("auto", "off"):
            raise ValueError(f"fuse_up must be 'auto' or 'off', got {fuse_up!r}")
        if padding_mode != "local":
            raise NotImplementedError(f"padding_mode={padding_mode!r}: only 'local' is ported yet")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.z_dim, self.G_ch, self.base_res = z_dim, G_ch, base_res
        self.n_layers_G, self.img_ch, self.leak = n_layers_G, img_ch, leak
        self.outer_padding = outer_padding
        self.num_patches_h, self.num_patches_w = num_patches_h, num_patches_w
        self.dtype, self.chw_tail, self.fuse_up = dtype, chw_tail, fuse_up

        self.start = ConvLP(z_dim, G_ch * 8, outer_padding, pre_padded=True)
        self.plan = generator_channel_plan(G_ch, n_layers_G)
        for i, (cin, cout) in enumerate(self.plan, start=1):
            self.add_module(f"block{i}", ResBlockGenerator(cin, cout, leak, outer_padding))
        self.attention = PatchAttention(G_ch * 2) if attention else None
        self.bn = BNFold(self.plan[-1][1])
        self.final = ConvLP(self.plan[-1][1], img_ch, outer_padding)

    def chw_gate(self, i: int, cin: int, wide: bool = True) -> bool:
        """Block ``i`` (input channels ``cin``) runs channels-major iff True.
        ``i > 3``: the per-patch attention after block3 needs NHWC. ``wide``
        (eval) extends the tail to cin <= 128; training keeps cin <= 64."""
        return (self.leak == 0 and self.chw_tail != "off" and i > 3
                and cin <= (128 if wide else 64))

    def emits_chw(self) -> bool:
        """True when the train forward runs a channels-major tail, so that
        ``out_chw=True`` hands the image over with no transpose (the train
        step's G->D wire)."""
        return any(self.chw_gate(i, cin, wide=False) for i, (cin, _) in enumerate(self.plan, start=1))

    @property
    def patch_resolution(self) -> int:
        return (2 ** (self.n_layers_G - 1)) * self.base_res

    def site_specs(self) -> List[SiteSpec]:
        return generator_site_specs(self.G_ch, self.base_res, self.n_layers_G)

    def forward(self, z: torch.Tensor, *, halo: Optional[Dict[str, SiteState]] = None,
                pos: Optional[GridPos] = None, grid: Optional[tuple[int, int]] = None,
                out_chw: bool = False):
        """``grid`` overrides (num_patches_h, num_patches_w), e.g. to run the
        whole canvas as one grid (the one-pass oracle)."""
        if self.chw_tail == "off" and z.is_cuda:
            raise ValueError("chw_tail='off' is a CPU reference path; a CUDA generator runs the tail kernels")
        grid = grid or (self.num_patches_h, self.num_patches_w)
        if self.training:
            if halo is not None:
                raise ValueError("the halo engine is eval-only; call .eval() first")
            return self._forward_train(z, grid, out_chw), None
        act = activation_fn(self.leak)
        halo_out: Dict[str, SiteState] = {}

        def site(name):
            return halo.get(name) if halo is not None else None

        h, _ = self.start(z.to(self.dtype), grid=grid)
        is_chw = False
        for i, (cin, _) in enumerate(self.plan, start=1):
            if not is_chw and self.chw_gate(i, cin):
                h = h.permute(0, 3, 1, 2).contiguous()
                is_chw = True
            if i > 1:
                h = kernels.upsample2_chw(h) if is_chw else upsample_nearest(h, 2)
            name = f"block{i}"
            h, h1, h2 = getattr(self, name)(
                h, site(f"{name}.conv1"), site(f"{name}.conv2"), pos, grid=grid, chw=is_chw
            )
            if halo is not None:
                halo_out[f"{name}.conv1"] = h1
                halo_out[f"{name}.conv2"] = h2
            if i == 3 and self.attention is not None:
                h = self.attention(h, grid)

        if is_chw:
            h, hf = self.final(h, site("final"), pos, grid=grid, chw_fold=(*self.bn.fold(), True))
            out = torch.tanh(h if out_chw else h.permute(0, 2, 3, 1))
        else:
            h, hf = self.final(act(self.bn(h)), site("final"), pos, grid=grid)
            out = torch.tanh(h)
            if out_chw:
                out = out.permute(0, 3, 1, 2).contiguous()
        if halo is not None:
            halo_out["final"] = hf
        return out, (halo_out if halo is not None else None)

    def _forward_train(self, z: torch.Tensor, grid: tuple[int, int], out_chw: bool):
        """The reference's ``train=True`` forward. A channels-major block
        ``i > 1`` fuses with its upsample unless ``fuse_up`` is 'off' (the
        reference's ``fuse``, :276-289, with stats and no halo)."""
        act = activation_fn(self.leak)
        h, _ = self.start(z.to(self.dtype), grid=grid)
        is_chw = False
        stats = None  # producer-kernel BN moments threaded block to block
        for i, (cin, _) in enumerate(self.plan, start=1):
            if not is_chw and self.chw_gate(i, cin, wide=False):
                # entry stats for the first tail block's bn1, in the NHWC
                # layout (the following nearest-2x upsample keeps mean, E[x²])
                hf = h.float()
                stats = (hf.sum(dim=(0, 1, 2)), (hf * hf).sum(dim=(0, 1, 2)),
                         h.shape[0] * h.shape[1] * h.shape[2])
                h = h.permute(0, 3, 1, 2).contiguous()
                is_chw = True
            fuse = is_chw and i > 1 and self.fuse_up != "off"
            if i > 1 and not fuse:
                h = kernels.upsample2_chw(h) if is_chw else upsample_nearest(h, 2)
            h, out_stats = getattr(self, f"block{i}").forward_train(
                h, grid=grid, chw=is_chw, in_stats=stats if is_chw else None, fuse_up=fuse)
            stats = out_stats if is_chw else None
            if i == 3 and self.attention is not None:
                h = self.attention(h, grid)
        if is_chw:
            sc, sh = self.bn.train_fold(h, stats)
            w, b = self.final.conv.weight, self.final.conv.bias
            h = kernels.conv3x3_chw(h, w, b, sc, sh, True, self.outer_padding)
            return torch.tanh(h if out_chw else h.permute(0, 2, 3, 1))
        h, _ = self.final(act(self.bn(h)), grid=grid)
        out = torch.tanh(h)
        return out.permute(0, 3, 1, 2).contiguous() if out_chw else out
