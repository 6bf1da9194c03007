"""Local padding and the halo cache of the raster engine, on NHWC tensors.

Port of ``infinite_texture_gans_tpu/ops/padding.py``. Every 3x3 conv of the
generator pads each patch with the border pixels of its neighbouring
patches instead of zeros, so patches tile seamlessly.

* One-pass: local padding of a merged grid is an edge ("replicate") or zero
  pad of the merged image; :func:`local_pad` does it.
* Patch-by-patch: each conv site keeps a :class:`SiteState`:

  - ``v``        (N, gh*H, 1, C): the column just left of the current
    sub-image (merged column (gw-1)*W - 1 of the previous step);
  - ``row_read`` (N, 1, Wtot+2, C): the canvas-wide bottom-edge row written
    by the previous row of sub-images; index 0 is canvas column -1, filled
    by :func:`finalize_row` from the outer padding mode;
  - ``row_write`` (N, 1, Wtot+2, C): the buffer the current row fills
    (merged row (gh-1)*H - 1 of every step, last writer wins).

Unlike the reference, :class:`GridPos` holds plain Python values (there is
no tracing), so position tests are ``if`` statements, and ``row_write`` is
updated in place: the engine never reads a site's earlier state again.

The batched-diagonal engine (``sampling/diag.py``) runs several canvas rows
(lanes) in one generator call, each at its own sub-image: it passes a
:class:`LanePos`, one position per batch element, and every lane reads its
own window of its own row buffer and writes its own back (none where the
lane is inactive), with tensor gathers and scatters in place of ``if``s.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class SiteSpec(NamedTuple):
    """Static description of one local-padding conv site in the generator."""

    name: str
    patch_res: int  # patch H (== W) in pixels at this site
    channels: int  # channels of the activation entering the padder


class SiteState(NamedTuple):
    """Halo cache of one conv site (see module docstring)."""

    v: torch.Tensor  # (N, gh*H, 1, C)
    row_read: torch.Tensor  # (N, 1, Wtot+2, C)
    row_write: torch.Tensor  # (N, 1, Wtot+2, C)


class GridPos(NamedTuple):
    """Position of the current sub-image in the canvas raster."""

    col: int  # sub-image column index c
    first_row: bool
    first_col: bool


class LanePos(NamedTuple):
    """Positions of a batched-diagonal step, one per batch element (a lane's
    images share its position), on the activations' device."""

    col: torch.Tensor  # (N,) int64: sub-image column index c
    first_row: torch.Tensor  # (N,) bool
    first_col: torch.Tensor  # (N,) bool
    active: torch.Tensor  # (N,) bool: False leaves the element's cache as it was


def _per_elem(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (N,) mask shaped to broadcast over (N, ...) of ``ndim`` dims."""
    return mask.view((-1,) + (1,) * (ndim - 1))


def lane_read_row(row_read: torch.Tensor, pos: LanePos, step: int, width: int) -> torch.Tensor:
    """Each element's window of its row buffer (N, 1, Wtot+2, C): columns
    ``col * step`` to ``col * step + width - 1`` -> (N, width, C)."""
    buf = row_read[:, 0]
    idx = pos.col[:, None] * step + torch.arange(width, device=buf.device)
    return buf.gather(1, idx[:, :, None].expand(-1, -1, buf.shape[-1]))


def lane_write_row(row_write: torch.Tensor, pos: LanePos, step: int, vals: torch.Tensor) -> None:
    """Write ``vals`` (N, width, C) into each active element's row buffer
    (N, 1, Wtot+2, C) in place, at columns ``col * step + 1`` on; an inactive
    element's buffer keeps its values."""
    buf = row_write[:, 0]
    idx = pos.col[:, None] * step + 1 + torch.arange(vals.shape[1], device=buf.device)
    idx = idx[:, :, None].expand(-1, -1, buf.shape[-1])
    vals = vals.to(buf.dtype)
    buf.scatter_(1, idx, torch.where(_per_elem(pos.active, 3), vals, buf.gather(1, idx)))


def _edge_pad_nhwc(x: torch.Tensor, pad: int) -> torch.Tensor:
    x = torch.cat([x[:, :1]] * pad + [x] + [x[:, -1:]] * pad, dim=1)
    return torch.cat([x[:, :, :1]] * pad + [x] + [x[:, :, -1:]] * pad, dim=2)


def local_pad(x: torch.Tensor, pad: int = 1, outer_padding: str = "replicate") -> torch.Tensor:
    """Outer-pad a merged NHWC grid; interior halos are already neighbour
    borders, so a valid conv after this equals the per-patch local pad."""
    if outer_padding == "replicate":
        return _edge_pad_nhwc(x, pad)
    return torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))


def _outer(x_edge: torch.Tensor, outer_padding: str) -> torch.Tensor:
    return x_edge if outer_padding == "replicate" else torch.zeros_like(x_edge)


def halo_pad_step(
    x: torch.Tensor,
    site: SiteState,
    pos: GridPos,
    gh: int,
    gw: int,
    outer_padding: str = "replicate",
) -> tuple[torch.Tensor, SiteState]:
    """Assemble the padded input for one sub-image step and update the cache.

    x: merged activation (N, gh*H, gw*W, C) of the current sub-image.
    Returns (padded (N, gh*H+2, gw*W+2, C), updated SiteState). ``pos`` may
    be a :class:`LanePos` (:func:`lane_halo_pad_step`).
    """
    if isinstance(pos, LanePos):
        return lane_halo_pad_step(x, site, pos, gh, gw, outer_padding)
    n, hm, wm, c = x.shape
    h, w = hm // gh, wm // gw

    left = _outer(x[:, :, :1], outer_padding) if pos.first_col else site.v
    right = _outer(x[:, :, -1:], outer_padding)
    tmp = torch.cat([left, x, right], dim=2)  # (N, Hm, Wm+2, C)
    bottom = _outer(tmp[:, -1:], outer_padding)
    offset = (gw - 1) * w * pos.col
    if pos.first_row:
        top = _outer(tmp[:, :1], outer_padding)
    else:
        top = site.row_read[:, :, offset : offset + wm + 2]
    padded = torch.cat([top, tmp, bottom], dim=1)

    v_new = x[:, :, (gw - 1) * w - 1 : (gw - 1) * w]
    site.row_write[:, :, offset + 1 : offset + 1 + wm] = x[:, (gh - 1) * h - 1 : (gh - 1) * h]
    return padded, SiteState(v=v_new, row_read=site.row_read, row_write=site.row_write)


def lane_halo_pad_step(x: torch.Tensor, site: SiteState, pos: LanePos, gh: int, gw: int,
                       outer_padding: str = "replicate") -> tuple[torch.Tensor, SiteState]:
    """:func:`halo_pad_step` with one position per batch element: each
    element's left column from the cache or its own edge, its top row from
    its own window of its row buffer or its own edge, and the cache update
    for the active elements only."""
    n, hm, wm, c = x.shape
    h, w = hm // gh, wm // gw
    first_col, first_row = _per_elem(pos.first_col, 4), _per_elem(pos.first_row, 4)
    left = torch.where(first_col, _outer(x[:, :, :1], outer_padding), site.v.to(x.dtype))
    tmp = torch.cat([left, x, _outer(x[:, :, -1:], outer_padding)], dim=2)
    bottom = _outer(tmp[:, -1:], outer_padding)
    cached = lane_read_row(site.row_read, pos, (gw - 1) * w, wm + 2).unsqueeze(1).to(x.dtype)
    top = torch.where(first_row, _outer(tmp[:, :1], outer_padding), cached)
    padded = torch.cat([top, tmp, bottom], dim=1)

    v_new = torch.where(_per_elem(pos.active, 4), x[:, :, (gw - 1) * w - 1 : (gw - 1) * w],
                        site.v)
    lane_write_row(site.row_write, pos, (gw - 1) * w, x[:, (gh - 1) * h - 1])
    return padded, SiteState(v=v_new, row_read=site.row_read, row_write=site.row_write)


def init_halo_state(
    specs: Sequence[SiteSpec],
    num_images: int,
    gh: int,
    gw: int,
    total_patches_w: int,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> dict[str, SiteState]:
    """Zero-initialised halo cache for a canvas of ``total_patches_w`` columns."""
    del gw  # the row buffers span the whole canvas width
    state = {}
    for spec in specs:
        h = spec.patch_res
        wtot = total_patches_w * spec.patch_res
        kw = dict(dtype=dtype, device=device)
        state[spec.name] = SiteState(
            v=torch.zeros((num_images, gh * h, 1, spec.channels), **kw),
            row_read=torch.zeros((num_images, 1, wtot + 2, spec.channels), **kw),
            row_write=torch.zeros((num_images, 1, wtot + 2, spec.channels), **kw),
        )
    return state


def finalize_row(state: SiteState, outer_padding: str = "replicate") -> SiteState:
    """Fill the canvas-border cells of a completed row buffer (in place).
    For zeros outer padding the zero init already holds the right value."""
    buf = state.row_write
    if outer_padding == "replicate":
        buf[:, :, 0] = buf[:, :, 1]
        buf[:, :, -1] = buf[:, :, -2]
    return state


def rotate_rows(state: SiteState) -> SiteState:
    """Start a new canvas row: consumed buffer <- accumulated buffer."""
    return SiteState(
        v=state.v,
        row_read=state.row_write,
        row_write=torch.zeros_like(state.row_write),
    )
