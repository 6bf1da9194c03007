"""ResidualPatchGenerator — the flagship model, eval and train forward.

Port of ``infinite_texture_gans_tpu/models/generator.py`` for the BN and the
SSM generator: start conv (z_dim -> 8 G_ch) -> block1 -> up -> block2 -> up
-> block3 -> [attention] -> up -> block4 [-> up -> block5] [-> up -> block6]
-> BN (none for SSM) -> act -> final conv -> tanh. Activations are merged
NHWC grids; from the first block that passes the channels-major gate on,
the tail runs on (N, C, H, W) through the CUDA kernels of ``ops/kernels.py``
and, for SSM, the embed chain K15 of ``ops/ssm.py`` at every norm site.

In train mode (``.train()``) the forward is the reference's ``train=True``
path (:189-397): batch statistics and running-stat updates, the tail's
norm moments threaded from kernel to kernel, and with ``out_chw`` the image
stays channels-major for the discriminator's stem. Under ``fuse_up='auto'``
(the default, as in the reference) and ``'all'`` every channels-major BN
block but block 1 takes its input at half resolution and runs the
subpixel-fused up-conv (K9, K10); ``'off'`` upsamples first, and SSM always
does (the reference fuses BN only). At eval only ``'all'`` fuses
(:meth:`ResidualPatchGenerator.eval_fuse_blocks`): the one pass runs K9, the
raster engine K14 with half-resolution conv1 halo sites. An SSM generator
takes one random map per block (``maps``, see
:class:`ResidualPatchGenerator`). Under ``padding_mode='zeros'`` (the
reference's default) every block runs NHWC with pad-1 convs, one patch per
image, attention on a 1x1 grid: the channels-major gate needs local padding
and no spectral norm, as the reference's does, so that path launches none of
the port's kernels. So does a spectrally normalised generator (``SN``,
the reference's :214-222 and the ``update_sn`` of its blocks): every conv
normalised by its power-iteration vectors, which a train forward called
with ``update_sn`` refreshes, all NHWC on ``F.conv2d``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from infinite_texture_gans_torch.models.layers import (
    BNFold,
    ConvLP,
    PatchAttention,
    ResBlockGenerator,
    activation_fn,
    identity_fold,
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


def generator_site_specs(G_ch: int = 52, base_res: int = 4, n_layers_G: int = 6,
                         fused_blocks: frozenset = frozenset()) -> List[SiteSpec]:
    """Halo site inventory in forward-call order: two per residual block
    plus the final conv (the start conv's input z arrives pre-padded). The
    conv1 site of a block in ``fused_blocks`` (``fuse_up='all'`` at eval)
    caches its halo at half resolution (``ops/kernels.py:
    chw_upconv_halo_step``)."""
    specs: List[SiteSpec] = []
    plan = generator_channel_plan(G_ch, n_layers_G)
    for i, (cin, cout) in enumerate(plan, start=1):
        res = base_res * (2 ** (i - 1))
        specs.append(SiteSpec(f"block{i}.conv1", res // 2 if i in fused_blocks else res, cin))
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
    block but block 1 with the upsample before it (K9, K10), 'all' does so
    at eval too (K9 on the one pass, K14 in the raster engine), 'off' never
    does; neither does SSM (the reference fuses BN only).
    ``type_norm``: 'BN' or 'SSM' (the stochastic spatial modulation, whose
    ``map_dim``-channel random maps the caller passes); an SSM generator has
    no final norm. ``SN``: spectral norm on every conv, NHWC throughout.

    ``forward(z, maps=None, halo=None, pos=None, grid=None, out_chw=False,
    update_sn=False)``:
    z merged (N, gh*base_res+2, gw*base_res+2, z_dim) in local mode; for SSM
    ``maps`` is a list of n_layers_G NHWC maps, maps[i] (N, gh*r+4, gw*r+4,
    map_dim) with r = 2^i * base_res (block i+1 reads maps[i]); returns
    (merged image (N, gh*P, gw*P, img_ch) in [-1, 1], or (N, img_ch, gh*P,
    gw*P) with ``out_chw``; halo dict or None). In zeros mode z is (N, h, w,
    z_dim) (``base_res`` square in training; any size at sampling), maps[i]
    (N, 2^i*h, 2^i*w, map_dim), and the image (N, h*S, w*S, img_ch) with
    S = 2^(n_layers_G-1); the halo engine needs local padding.
    """

    def __init__(self, z_dim: int = 128, G_ch: int = 52, base_res: int = 4,
                 n_layers_G: int = 6, attention: bool = True, img_ch: int = 3,
                 leak: float = 0.0, SN: bool = False, type_norm: str = "BN", map_dim: int = 1,
                 padding_mode: str = "local", outer_padding: str = "replicate",
                 num_patches_h: int = 3, num_patches_w: int = 3,
                 dtype: torch.dtype = torch.float32, chw_tail: str = "auto",
                 fuse_up: str = "auto"):
        super().__init__()
        if type_norm not in ("BN", "SSM"):
            raise ValueError(f"type_norm must be 'BN' or 'SSM', got {type_norm!r}")
        if chw_tail not in ("auto", "off"):
            raise ValueError(f"chw_tail must be 'auto' or 'off', got {chw_tail!r}")
        if fuse_up not in ("auto", "all", "off"):
            raise ValueError(f"fuse_up must be 'auto', 'all' or 'off', got {fuse_up!r}")
        if padding_mode not in ("local", "zeros"):
            raise ValueError(f"padding_mode must be 'local' or 'zeros', got {padding_mode!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.z_dim, self.G_ch, self.base_res = z_dim, G_ch, base_res
        self.n_layers_G, self.img_ch, self.leak = n_layers_G, img_ch, leak
        self.type_norm, self.map_dim = type_norm, map_dim
        self.padding_mode, self.SN = padding_mode, SN
        self.outer_padding = outer_padding
        self.num_patches_h, self.num_patches_w = num_patches_h, num_patches_w
        self.dtype, self.chw_tail, self.fuse_up = dtype, chw_tail, fuse_up

        self.start = ConvLP(z_dim, G_ch * 8, outer_padding, pre_padded=True,
                            padding_mode=padding_mode, sn=SN)
        self.plan = generator_channel_plan(G_ch, n_layers_G)
        for i, (cin, cout) in enumerate(self.plan, start=1):
            self.add_module(f"block{i}", ResBlockGenerator(cin, cout, leak, outer_padding,
                                                           type_norm, map_dim, padding_mode, SN))
        self.attention = PatchAttention(G_ch * 2, SN) if attention else None
        # SSM mode has no final norm (reference generator.py:339-351, :376-381)
        self.bn = BNFold(self.plan[-1][1]) if type_norm == "BN" else None
        self.final = ConvLP(self.plan[-1][1], img_ch, outer_padding, padding_mode=padding_mode,
                            sn=SN)

    def chw_gate(self, i: int, cin: int, wide: bool = True) -> bool:
        """Block ``i`` (input channels ``cin``) runs channels-major iff True:
        the reference's gate (:150-152), local padding, no spectral norm,
        leak 0. ``i > 3``: the per-patch attention after block3 needs NHWC.
        ``wide`` (eval) extends the tail to cin <= 128; training keeps
        cin <= 64."""
        return (self.padding_mode == "local" and not self.SN and self.leak == 0
                and self.chw_tail != "off" and i > 3 and cin <= (128 if wide else 64))

    def eval_fuse_blocks(self) -> frozenset:
        """The blocks whose upsample -> BN -> ReLU -> conv1 runs
        subpixel-fused at eval (``fuse_up='all'``, BN only): every
        channels-major block but block 1, under the wide eval gate. It
        decides both the eval forward and which conv1 halo sites are cached
        at half resolution, so the two never disagree."""
        if self.fuse_up != "all" or self.type_norm != "BN":
            return frozenset()
        fused, is_chw = set(), False
        for i, (cin, _) in enumerate(self.plan, start=1):
            is_chw = is_chw or self.chw_gate(i, cin)
            if is_chw and i > 1:
                fused.add(i)
        return frozenset(fused)

    def emits_chw(self) -> bool:
        """True when the train forward runs a channels-major tail, so that
        ``out_chw=True`` hands the image over with no transpose (the train
        step's G->D wire)."""
        return any(self.chw_gate(i, cin, wide=False) for i, (cin, _) in enumerate(self.plan, start=1))

    @property
    def patch_resolution(self) -> int:
        return (2 ** (self.n_layers_G - 1)) * self.base_res

    def site_specs(self) -> List[SiteSpec]:
        return generator_site_specs(self.G_ch, self.base_res, self.n_layers_G,
                                    fused_blocks=self.eval_fuse_blocks())

    def _block_maps(self, maps: Optional[Sequence[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
        if self.type_norm != "SSM":
            return [None] * self.n_layers_G
        if maps is None or len(maps) != self.n_layers_G:
            raise ValueError(f"an SSM generator takes a list of {self.n_layers_G} maps")
        return list(maps)

    def _final(self, h: torch.Tensor, is_chw: bool, grid, halo=None, pos=None, stats=None,
               update_sn: bool = False):
        """The final norm (BN; none for SSM), the activation and the final
        conv. Channels-major, the BN fold (in training from the last block's
        ``stats``) and the ReLU run in the conv kernel."""
        if is_chw:
            if self.bn is None:
                fold = identity_fold(h)
            elif self.training:
                fold = (*self.bn.train_fold(h, stats), True)
            else:
                fold = (*self.bn.fold(), True)
            return self.final(h, halo, pos, grid=grid, chw_fold=fold)
        act = activation_fn(self.leak)
        return self.final(act(h if self.bn is None else self.bn(h)), halo, pos, grid=grid,
                          update_sn=update_sn)

    def forward(self, z: torch.Tensor, maps: Optional[Sequence[torch.Tensor]] = None, *,
                halo: Optional[Dict[str, SiteState]] = None, pos: Optional[GridPos] = None,
                grid: Optional[tuple[int, int]] = None, out_chw: bool = False,
                update_sn: bool = False):
        """``grid`` overrides (num_patches_h, num_patches_w), e.g. to run the
        whole canvas as one grid (the one-pass oracle); in zeros mode each
        image is one patch, so the attention's grid is 1x1. ``update_sn``
        (train mode) refreshes the spectral-norm vectors of every conv, once
        each, before the conv uses them."""
        if self.chw_tail == "off" and z.is_cuda:
            raise ValueError("chw_tail='off' is a CPU reference path; a CUDA generator runs the tail kernels")
        if self.padding_mode == "zeros":
            if halo is not None:
                raise ValueError("the halo engine needs padding_mode='local'")
            grid = (1, 1)
        grid = grid or (self.num_patches_h, self.num_patches_w)
        block_maps = self._block_maps(maps)
        if self.training:
            if halo is not None:
                raise ValueError("the halo engine is eval-only; call .eval() first")
            return self._forward_train(z, block_maps, grid, out_chw, update_sn), None
        halo_out: Dict[str, SiteState] = {}

        def site(name):
            return halo.get(name) if halo is not None else None

        h, _ = self.start(z.to(self.dtype), grid=grid)
        is_chw = False
        fused = self.eval_fuse_blocks()
        for i, (cin, _) in enumerate(self.plan, start=1):
            if not is_chw and self.chw_gate(i, cin):
                h = h.permute(0, 3, 1, 2).contiguous()
                is_chw = True
            if i > 1 and i not in fused:
                h = kernels.upsample2_chw(h) if is_chw else upsample_nearest(h, 2)
            name = f"block{i}"
            h, h1, h2 = getattr(self, name)(
                h, site(f"{name}.conv1"), site(f"{name}.conv2"), pos, grid=grid, chw=is_chw,
                maps=block_maps[i - 1], fuse_up=i in fused,
            )
            if halo is not None:
                halo_out[f"{name}.conv1"] = h1
                halo_out[f"{name}.conv2"] = h2
            if i == 3 and self.attention is not None:
                h = self.attention(h, grid)

        h, hf = self._final(h, is_chw, grid, site("final"), pos)
        if is_chw:
            out = torch.tanh(h if out_chw else h.permute(0, 2, 3, 1))
        else:
            out = torch.tanh(h)
            if out_chw:
                out = out.permute(0, 3, 1, 2).contiguous()
        if halo is not None:
            halo_out["final"] = hf
        return out, (halo_out if halo is not None else None)

    def _forward_train(self, z: torch.Tensor, block_maps, grid: tuple[int, int], out_chw: bool,
                       update_sn: bool = False):
        """The reference's ``train=True`` forward. A channels-major BN block
        ``i > 1`` fuses with its upsample unless ``fuse_up`` is 'off' (the
        reference's ``fuse``, :276-289, with stats and no halo)."""
        h, _ = self.start(z.to(self.dtype), grid=grid, update_sn=update_sn)
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
            fuse = is_chw and i > 1 and self.fuse_up != "off" and self.type_norm == "BN"
            if i > 1 and not fuse:
                h = kernels.upsample2_chw(h) if is_chw else upsample_nearest(h, 2)
            h, out_stats = getattr(self, f"block{i}").forward_train(
                h, grid=grid, chw=is_chw, in_stats=stats if is_chw else None, fuse_up=fuse,
                maps=block_maps[i - 1], update_sn=update_sn)
            stats = out_stats if is_chw else None
            if i == 3 and self.attention is not None:
                h = self.attention(h, grid, update_sn)
        h, _ = self._final(h, is_chw, grid, stats=stats, update_sn=update_sn)
        if is_chw:
            return torch.tanh(h if out_chw else h.permute(0, 2, 3, 1))
        out = torch.tanh(h)
        return out.permute(0, 3, 1, 2).contiguous() if out_chw else out
