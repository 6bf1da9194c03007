"""The host planners of the float32 routes of K9 dx, K13's forward, K3-dW,
K1/K2, K6, K7, K9's forward (with K14), K9 dW and K13 dW (ops/kernels.py:
upconv_dx_f32_plan, stem_f32_plan, conv1x1_dw_f32_plan, conv3x3_f32_plan,
conv3x3_dx_f32_plan, conv3x3_dw_f32_plan, upconv_f32_plan,
upconv_dw_f32_plan, stem_dw_f32_plan) and of K15's
forward and backward (ops/ssm.py: fwd_f32_plan, bwd_f32_plan): the tiles
and splits they choose at the Experiment-1,
SSM, eval and ``--D_ch 640`` shapes, and the shapes they refuse. The kernels
themselves run only on the card (chip_smoke.py, tests/test_torch_gpu.py); on
the CPU the wrappers take the plain versions, which
tests/test_torch_upconv.py, tests/test_torch_stem_tc.py,
tests/test_torch_conv1x1_tc.py, tests/test_torch_kernels.py and
tests/test_torch_train_kernels.py hold to the JAX package."""

import pytest
import torch
from _torch_threads import _few_torch_threads  # noqa: F401  (autouse)

from infinite_texture_gans_torch.ops import kernels as tk
from infinite_texture_gans_torch.ops import ssm

# (N, C, Co, H, W) of x at half resolution: the Experiment-1 step's two fused
# up-convs (tail blocks 5 and 6, --fuse_up auto)
EXP1_DX = [(8, 52, 26, 96, 96), (8, 26, 13, 192, 192)]


@pytest.mark.parametrize("shape, cc, groups, tiles", [
    (EXP1_DX[0], 8, 7, (12, 3)),
    (EXP1_DX[1], 13, 2, (24, 6)),
])
def test_upconv_dx_f32_plan_at_exp1(shape, cc, groups, tiles):
    """52 input channels in 7 groups of 8 (56: 13's 1.2x cost a channel
    outweighs 4 padded ones), 26 in 2 groups of 13; 8 x 32 tiles cover
    96^2 and 192^2 exactly; the partials have a row per tile."""
    n, c, co, h, w = shape
    plan = tk.upconv_dx_f32_plan(n, c, co, h, w)
    assert (plan.cc, plan.groups, (plan.tiles_h, plan.tiles_w)) == (cc, groups, tiles)
    assert plan.part_rows == n * (h // 8) * (w // 32)
    assert plan.wq_numel == co * groups * 16 * (-(-cc // 4) * 4)


@pytest.mark.parametrize("c, cc", [(1, 8), (3, 8), (4, 8), (7, 8), (8, 8), (11, 13), (13, 13),
                                   (16, 8), (26, 13), (52, 8), (64, 8), (100, 8), (104, 8)])
def test_upconv_dx_f32_plan_channel_split(c, cc):
    """The least UPCONV_DX_F32_COST over the padded channels: 13 channels a
    thread where that pads least (11, 13, 26), else 8, the last group's
    channels past C zero weights."""
    plan = tk.upconv_dx_f32_plan(2, c, 5, 20, 20)
    assert plan.cc == cc
    assert plan.groups == -(-c // cc) and plan.groups * plan.cc >= c


@pytest.mark.parametrize("h, w, tiles", [(64, 16, (8, 1)), (16, 64, (2, 2)), (1, 1, (1, 1)),
                                         (13, 45, (2, 2)), (17, 19, (3, 1))])
def test_upconv_dx_f32_plan_tiles_cover_the_image(h, w, tiles):
    """Every shape takes 8 x 32 half-res tiles, the last row and column of
    tiles padded; the partials have a row per tile of each image."""
    plan = tk.upconv_dx_f32_plan(3, 13, 3, h, w)
    assert (plan.tiles_h, plan.tiles_w) == tiles
    assert plan.part_rows == 3 * tiles[0] * tiles[1]


@pytest.mark.parametrize("shape", [(0, 5, 3, 8, 8), (1, 0, 3, 8, 8), (1, 5, 0, 8, 8),
                                   (1, 5, 3, 0, 8), (1, 5, 3, 8, 0), (65536, 5, 3, 8, 8)])
def test_upconv_dx_f32_plan_refuses(shape):
    with pytest.raises(ValueError, match="upconv3x3_chw_dx"):
        tk.upconv_dx_f32_plan(*shape)


@pytest.mark.parametrize("shape, tiles, chunks, blocks", [
    ((8, 3, 64, 384, 384), 8 * 24 * 6, 1, 396),  # Experiment-1: 8 fake 384^2 grids
    ((8, 3, 64, 192, 192), 8 * 12 * 3, 1, 288),  # the SSM recipe's 192^2 fakes
    ((8, 3, 640, 384, 384), 8 * 24 * 6, 10, 40),  # --D_ch 640
    ((1, 4, 100, 8, 8), 1, 2, 1),  # fewer tiles than the card holds blocks
])
def test_stem_f32_plan(shape, tiles, chunks, blocks):
    """8 x 32 output pixels x 64 channels a tile; three blocks an SM of 132,
    shared among the channel chunks, and no more blocks than tiles."""
    n, c, co, h, w = shape
    plan = tk.stem_f32_plan(n, c, co, h, w)
    assert (plan.tiles, plan.chunks, plan.blocks) == (tiles, chunks, blocks)


@pytest.mark.parametrize("shape", [(8, 5, 64, 32, 32), (8, 0, 64, 32, 32), (8, 3, 64, 33, 32),
                                   (8, 3, 64, 32, 31), (8, 3, 0, 32, 32), (0, 3, 64, 32, 32),
                                   (8, 3, 64, 0, 32)])
def test_stem_f32_plan_refuses(shape):
    with pytest.raises(ValueError, match="float32 stem forward"):
        tk.stem_f32_plan(*shape)


# K13 dW's float32 route: (N, C, Co, H, W) and its plan (slots, rows,
# chunks, channel blocks, blocks)
STEM_DW_PLANS = [
    ((8, 3, 64, 384, 384), (12, 6, 8 * 32 * 6, 1, 132)),  # Experiment-1: 8 fake 384^2 grids
    ((8, 3, 64, 192, 192), (12, 6, 8 * 16 * 3, 1, 132)),  # the SSM recipe's 192^2 fakes
    ((8, 3, 512, 384, 384), (12, 6, 8 * 32 * 6, 8, 16)),  # --D_ch 512: 8 channel blocks
    ((2, 4, 5, 22, 70), (8, 4, 2 * 3 * 2, 1, 12)),  # C = 4: 8 warps; fewer chunks than SMs
]


@pytest.mark.parametrize("shape, plan", STEM_DW_PLANS, ids=lambda v: str(v))
def test_stem_dw_f32_plan(shape, plan):
    """12 warps a block (8 at C = 4), a run of 16 pixels for each in a chunk
    of rows x 32 output pixels; one block an SM of 132 for each 64-channel
    block, no more blocks than chunks; a partial row of Co 16 C + Co."""
    n, c, co, h, w = shape
    got = tk.stem_dw_f32_plan(n, c, co, h, w)
    assert (got.slots, got.rows, got.chunks, got.channel_blocks, got.blocks) == plan
    assert got.part_entries == co * 16 * c + co


@pytest.mark.parametrize("shape", [(8, 3, 64, 384, 384), (8, 3, 64, 192, 192), (1, 1, 1, 2, 2),
                                   (3, 4, 24, 10, 34), (2, 2, 130, 26, 66)])
def test_stem_dw_f32_plans_cover_the_image(shape):
    """Every plan the planner chooses from gives each slot a run and fits two
    stages in the H100's shared memory; its chunks of rows x 32 output pixels
    cover the H/2 x W/2 output of every image, and the chosen plan is one of
    them."""
    n, c, co, h, w = shape
    plans = tk.stem_dw_f32_plans(n, c, co, h, w)
    assert tk.stem_dw_f32_plan(n, c, co, h, w) in plans
    for plan in plans:
        assert plan.slots <= 2 * plan.rows
        stage = 4 * (c * (2 * plan.rows + 2) * tk.STEM_DW_F32_XS + plan.rows * 32 * 64)
        assert 2 * stage <= tk.CONV3X3_DW_F32_SMEM
        assert plan.chunks == n * -(-(h // 2) // plan.rows) * -(-(w // 2) // 32)
        assert plan.rows * -(-(h // 2) // plan.rows) >= h // 2
        assert 1 <= plan.blocks <= plan.chunks


@pytest.mark.parametrize("shape", [(8, 5, 64, 32, 32), (8, 0, 64, 32, 32), (8, 3, 64, 33, 32),
                                   (8, 3, 64, 32, 31), (8, 3, 0, 32, 32), (0, 3, 64, 32, 32),
                                   (8, 3, 64, 0, 32), (1, 3, 8, 65536, 32768)])
def test_stem_dw_f32_plan_refuses(shape):
    with pytest.raises(ValueError, match="float32 stem dW"):
        tk.stem_dw_f32_plan(*shape)


# K15's float32 backward: (N, md, hid, H, W, Co) and its plan (s1, slots2,
# rows2, chunks2, channel blocks, s2)
SSM_BWD_PLANS = [
    # the SSM step's bn1 and shortcut bn3 (Co 104) and bn2 (Co 52) sites
    ((8, 1, 128, 192, 192, 104), (8 * 13 * 7, 2, 8, 8 * 24 * 6, 8, 16)),
    ((8, 1, 128, 192, 192, 52), (8 * 13 * 7, 2, 8, 8 * 24 * 6, 4, 33)),
    # map_dim 3, hid and Co no multiple of the tiles, a plane of one tile
    ((1, 3, 100, 20, 37, 57), (1 * 2 * 2, 2, 4, 5 * 2, 8, 10)),
]


@pytest.mark.parametrize("shape, plan", SSM_BWD_PLANS, ids=lambda v: str(v))
def test_ssm_bwd_f32_plan(shape, plan):
    """part1 has a row per 16 x 32 tile of each image's (H+2) x (W+2) hidden
    grid; dW2's blocks hold up to 52 output x 32 hidden channels (more split
    over the grid's second axis), two pixel slots of 156 threads at 52 x 32,
    one block an SM of 132 for each channel block, chunks of rows2 x 32
    output pixels."""
    got = ssm.bwd_f32_plan(*shape)
    assert (got.s1, got.slots2, got.rows2, got.chunks2, got.channel_blocks2, got.s2) == plan


@pytest.mark.parametrize("shape", [(8, 1, 128, 192, 192, 104), (2, 2, 40, 17, 23, 19),
                                   (1, 1, 16, 1, 3, 3), (4, 3, 128, 64, 80, 52)])
def test_ssm_bwd_f32_plans_cover_the_grids(shape):
    """Every plan: the hidden tiles cover each image's hidden grid, the dW2
    chunks its output grid, each pixel slot has a run of 8 pixels, two
    stages fit the H100's shared memory; the chosen plan is one of them."""
    n, md, hid, h, w, co = shape
    plans = ssm.bwd_f32_plans(*shape)
    assert ssm.bwd_f32_plan(*shape) in plans
    for plan in plans:
        assert plan.s1 == n * -(-(h + 2) // 16) * -(-(w + 2) // 32)
        assert plan.chunks2 == n * -(-h // plan.rows2) * -(-w // 32)
        assert plan.slots2 <= 4 * plan.rows2 and plan.slots2 & (plan.slots2 - 1) == 0
        assert 1 <= plan.s2 <= plan.chunks2


@pytest.mark.parametrize("shape, match", [((0, 1, 128, 8, 8, 4), "float32"),
                                          ((1, 0, 128, 8, 8, 4), "float32"),
                                          ((1, 1, 128, 8, 8, 0), "float32"),
                                          ((65536, 1, 8, 8, 8, 4), "float32"),
                                          ((1, 64, 128, 8, 8, 4), "map_dim 64")])
def test_ssm_bwd_f32_plan_refuses(shape, match):
    """Empty shapes, N past 65535 and a map_dim whose first launch's shared
    memory exceeds the card's raise, naming the kernel."""
    with pytest.raises(ValueError, match=match):
        ssm.bwd_f32_plan(*shape)


# K15's float32 forward: (N, md, hid, H, W, Co) and its plan (warps, tiles,
# channel blocks): the SSM step's sites (N = 8 at 192^2: Co 104 twice, 52
# once) and the eval sub-image's (N = 1: Co 208 and 104 at 96^2, 104 and 52
# at 192^2)
SSM_FWD_PLANS = [
    ((8, 1, 128, 192, 192, 104), (4, 8 * 12 * 6, 4)),  # 13 groups of 8: 4 blocks of 4 warps
    ((8, 1, 128, 192, 192, 52), (4, 8 * 12 * 6, 2)),
    ((1, 1, 128, 96, 96, 208), (4, 6 * 3, 7)),  # 126 blocks: one an SM, each 4 warps wide
    ((1, 1, 128, 96, 96, 104), (4, 6 * 3, 4)),  # 72 blocks: narrower ones would share SMs
    ((1, 1, 128, 192, 192, 104), (2, 12 * 6, 7)),  # 504 blocks of 2: 4 an SM, 8 warps
    ((1, 1, 128, 192, 192, 52), (1, 12 * 6, 7)),  # 504 of 1: 4 warps a SM, no idle warp
]


def _ssm_fwd_cost(plan, co, sms=132):
    """The planner's cost as ops/ssm.py states it: the busiest SM's blocks
    x (a block's active warps + ssm.F32_FWD_HIDDEN) over the warps issuing
    at once (at most ssm.F32_FWD_ISSUE)."""
    busiest = -(-plan.blocks // sms)
    work = -(-co // 8) / plan.channel_blocks + ssm.F32_FWD_HIDDEN
    return busiest * work / min(ssm.F32_FWD_ISSUE, busiest * plan.warps)


@pytest.mark.parametrize("shape, plan", SSM_FWD_PLANS, ids=lambda v: str(v))
def test_ssm_fwd_f32_plan(shape, plan):
    """A block per 16 x 32 output tile of an image and 8 output channels a
    warp; 4 warps a block at the training shapes (the hidden chunk computed
    for the most channels), and at eval the block width that loads the
    H100's 132 SMs best, not the most blocks."""
    got = ssm.fwd_f32_plan(*shape)
    assert (got.warps, got.tiles, got.channel_blocks) == plan
    assert got.blocks == got.tiles * got.channel_blocks


@pytest.mark.parametrize("shape", [(8, 1, 128, 192, 192, 104), (1, 1, 128, 96, 96, 208),
                                   (3, 2, 40, 33, 47, 210), (1, 1, 16, 5, 7, 1),
                                   (2, 3, 100, 20, 37, 57), (1, 56, 8, 8, 8, 4)])
def test_ssm_fwd_f32_plans_cover_the_output(shape):
    """Every plan: the tiles cover each image's H x W output, the channel
    blocks every output channel (8 a warp), the shared memory fits the
    H100's; the chosen plan is one of them, with the least cost."""
    n, md, hid, h, w, co = shape
    plans = ssm.fwd_f32_plans(*shape)
    chosen = ssm.fwd_f32_plan(*shape)
    assert chosen in plans
    assert {p.warps for p in plans} <= set(ssm.F32_FWD_WARPS)
    for plan in plans:
        assert plan.tiles == n * -(-h // 16) * -(-w // 32)
        width = 8 * plan.warps
        assert plan.channel_blocks * width >= co > (plan.channel_blocks - 1) * width
        assert plan.smem <= tk.CONV3X3_DW_F32_SMEM
        assert _ssm_fwd_cost(chosen, co) <= _ssm_fwd_cost(plan, co)


@pytest.mark.parametrize("shape, match", [((0, 1, 128, 8, 8, 4), "float32"),
                                          ((1, 0, 128, 8, 8, 4), "float32"),
                                          ((1, 1, 0, 8, 8, 4), "float32"),
                                          ((1, 1, 128, 8, 8, 0), "float32"),
                                          ((1, 1, 128, 0, 8, 4), "float32"),
                                          ((65536, 1, 8, 8, 8, 4), "float32"),
                                          ((1, 80, 128, 8, 8, 4), "map_dim 80")])
def test_ssm_fwd_f32_plan_refuses(shape, match):
    """Empty shapes, N past 65535 and a map_dim whose maps tile overflows a
    block's shared memory raise, naming the kernel."""
    with pytest.raises(ValueError, match=match):
        ssm.fwd_f32_plan(*shape)


# (N, C, Co, H, W) of K1's float32 route, and the plan (TO, groups a block,
# channel chunks, tiles (rows, columns)): the Experiment-1 step's `auto`
# shapes, `off`'s two more, the SSM step's, and the flagship's 384^2
# sub-image at eval (N = 1)
K1_PLANS = [
    ((8, 26, 26, 192, 192), 7, 4, 1, (12, 6)),  # auto, off, SSM: the four groups in a block
    ((8, 13, 13, 384, 384), 7, 2, 1, (24, 12)),  # auto, off
    ((8, 13, 3, 384, 384), 3, 1, 1, (24, 12)),  # auto, off: the final conv
    ((8, 52, 26, 192, 192), 7, 4, 1, (12, 6)),  # off, SSM
    ((8, 26, 13, 384, 384), 7, 2, 1, (24, 12)),  # off
    ((8, 26, 3, 192, 192), 3, 1, 1, (12, 6)),  # SSM: the final conv
    ((1, 104, 52, 96, 96), 3, 4, 5, (6, 3)),  # eval: 7 a thread would leave 144 warps
    ((1, 52, 52, 96, 96), 3, 4, 5, (6, 3)),
    ((1, 52, 26, 192, 192), 3, 4, 3, (12, 6)),  # eval: 288 warps at 7 a thread
    ((1, 26, 26, 192, 192), 3, 4, 3, (12, 6)),
    ((1, 26, 13, 384, 384), 7, 2, 1, (24, 12)),  # eval: 576 warps
    ((1, 13, 13, 384, 384), 7, 2, 1, (24, 12)),
    ((1, 13, 3, 384, 384), 3, 1, 1, (24, 12)),
]


@pytest.mark.parametrize("shape, to, g, chunks, tiles", K1_PLANS, ids=lambda v: str(v))
def test_conv3x3_f32_plan(shape, to, g, chunks, tiles):
    """7 output channels a thread, 3 at Co = 3 and where 7 would leave under
    four warps an SM (the N = 1 layers at 96^2 and 192^2); as many groups a
    block as there are, up to 4; 16 x 32 tiles, one partial row a tile."""
    n, c, co, h, w = shape
    plan = tk.conv3x3_f32_plan(n, c, co, h, w)
    assert (plan.to, plan.g, plan.chunks, (plan.tiles_h, plan.tiles_w)) == (to, g, chunks, tiles)
    assert plan.groups == -(-co // to) and plan.chunks * plan.g >= plan.groups
    assert plan.part_rows == n * tiles[0] * tiles[1]


@pytest.mark.parametrize("co, to, g", [(1, 3, 1), (2, 3, 1), (3, 3, 1), (4, 7, 1), (7, 7, 1),
                                       (8, 7, 2), (13, 7, 2), (26, 7, 4), (52, 7, 4),
                                       (64, 7, 4)])
def test_conv3x3_f32_plan_channel_split(co, to, g):
    """On a grid with warps to spare, TO is 7 unless Co <= 3; a block holds
    the most groups of (4, 2, 1) that the channels fill."""
    plan = tk.conv3x3_f32_plan(8, 16, co, 192, 192)
    assert (plan.to, plan.g) == (to, g) and plan.groups * plan.to >= co


@pytest.mark.parametrize("shape", [(0, 5, 3, 8, 8), (1, 0, 3, 8, 8), (1, 5, 0, 8, 8),
                                   (1, 5, 3, 0, 8), (1, 5, 3, 8, 0), (65536, 5, 3, 8, 8),
                                   (1, 5, 3, 65536, 32768)])
def test_conv3x3_f32_plan_refuses(shape):
    with pytest.raises(ValueError, match="conv3x3_chw"):
        tk.conv3x3_f32_plan(*shape)


@pytest.mark.parametrize("shape, chunks, blocks", [
    ((8, 52, 26, 96 * 96), 8 * 144, 132),  # auto: the half-res shortcut of block 5
    ((8, 26, 13, 192 * 192), 8 * 576, 132),  # auto: block 6's
    ((8, 52, 26, 192 * 192), 8 * 576, 132),  # off and SSM: block 5's
    ((8, 26, 13, 384 * 384), 8 * 2304, 132),  # off: block 6's
    ((2, 3, 5, 7 * 7), 2, 2),  # fewer chunks than SMs: a block each
    ((3, 52, 26, 13 * 45), 3 * 10, 30),  # an odd HW: the last chunk of an image padded
])
def test_conv1x1_dw_f32_plan(shape, chunks, blocks):
    """64-pixel chunks that never leave their image; one block of 256
    threads an SM, no more blocks than chunks; a partial row of Co C + Co."""
    n, c, co, hw = shape
    plan = tk.conv1x1_dw_f32_plan(n, c, co, hw)
    assert (plan.chunks, plan.blocks, plan.part_entries) == (chunks, blocks, co * c + co)


@pytest.mark.parametrize("shape", [(8, 65, 64, 100), (8, 90, 7, 100), (8, 7, 90, 100),
                                   (8, 0, 3, 100), (8, 3, 0, 100), (0, 3, 5, 100),
                                   (8, 3, 5, 0)])
def test_conv1x1_dw_f32_plan_refuses(shape):
    """Outside C * Co <= 4096 and C + Co <= 96 (the bf16 route's limits too),
    or an empty shape."""
    with pytest.raises(ValueError, match=r"C\*Co <= 4096, C\+Co <= 96"):
        tk.conv1x1_dw_f32_plan(*shape)


# (N, C, Co, H, W) of K6's and K7's float32 routes at every float32 training
# shape (the convs K1 runs: K1_PLANS' first six), K6's plan (CC, groups,
# groups a block, channel chunks, tiles) and K7's (output and input tiles a
# block, pixel slots, threads, rows a chunk, chunks)
BWD_PLANS = [
    ((8, 26, 26, 192, 192), (7, 4, 4, 1, (12, 6)), (9, 2, 4, 224, 12, 8 * 16 * 6)),
    ((8, 13, 13, 384, 384), (7, 2, 2, 1, (24, 12)), (5, 1, 16, 256, 24, 8 * 16 * 12)),
    ((8, 13, 3, 384, 384), (7, 2, 2, 1, (24, 12)), (1, 1, 64, 192, 32, 8 * 12 * 12)),
    ((8, 52, 26, 192, 192), (7, 8, 4, 2, (12, 6)), (9, 4, 2, 224, 8, 8 * 24 * 6)),
    ((8, 26, 13, 384, 384), (7, 4, 4, 1, (24, 12)), (5, 2, 8, 256, 16, 8 * 24 * 12)),
    ((8, 26, 3, 192, 192), (7, 4, 4, 1, (12, 6)), (1, 2, 32, 192, 24, 8 * 8 * 6)),
]


@pytest.mark.parametrize("shape, dx, dw", BWD_PLANS, ids=lambda v: str(v))
def test_conv3x3_bwd_f32_plans_at_exp1(shape, dx, dw):
    """K6: 7 input channels a thread (13 -> 14, 26 -> 28, 52 -> 56: at most
    one partial group), every group of a tile in one block up to 4, 16 x 32
    tiles, a partial row a tile. K7: 3 x 13 channel tiles a row tap, every
    channel in one block (Co = 3 in one output tile: no padded output
    channel), the most pixel slots a power of two that 256 threads hold, the
    chunk's rows with the least (chunks of the busiest block) x (rows + 2)
    among those whose two stages fit 227 KB (52 -> 26 only 8: its stage is
    99 KB), one block an SM of 132."""
    n, c, co, h, w = shape
    p6 = tk.conv3x3_dx_f32_plan(n, c, co, h, w)
    assert (p6.cc, p6.groups, p6.g, p6.chunks, (p6.tiles_h, p6.tiles_w)) == dx
    assert p6.groups * p6.cc - c < p6.cc and p6.chunks * p6.g >= p6.groups
    assert p6.part_rows == n * p6.tiles_h * p6.tiles_w
    p7 = tk.conv3x3_dw_f32_plan(n, c, co, h, w)
    assert (p7.tiles_o, p7.tiles_c, p7.slots, p7.threads, p7.rows, p7.chunks) == dw
    assert p7.tiles_o * 3 - co < 3 and p7.tiles_c * 13 - c < 13
    assert (p7.channel_blocks, p7.blocks) == (1, 132)
    assert p7.slots * p7.tiles_o * p7.tiles_c * 3 <= 256 and p7.slots <= 4 * p7.rows
    assert p7.rows in tk.CONV3X3_DW_F32_ROWS
    assert p7.part_entries == co * c * 9 + co


@pytest.mark.parametrize("h, w", [(1, 1), (13, 45), (17, 19), (16, 32), (33, 47), (384, 384)])
def test_conv3x3_bwd_f32_plans_tiles_cover_the_image(h, w):
    """K6's 16 x 32 tiles and K7's chunks (rows x 32 columns) cover every
    shape, the last row and column of them padded."""
    p6 = tk.conv3x3_dx_f32_plan(2, 5, 7, h, w)
    assert (p6.tiles_h - 1) * 16 < h <= p6.tiles_h * 16
    assert (p6.tiles_w - 1) * 32 < w <= p6.tiles_w * 32
    p7 = tk.conv3x3_dw_f32_plan(2, 5, 7, h, w)
    assert p7.chunks == 2 * -(-h // p7.rows) * -(-w // 32)
    assert p7.blocks == min(p7.chunks, 132)


@pytest.mark.parametrize("c, co, cc, blocks", [(3, 5, 3, (1, 132)), (1, 1, 3, (1, 132)),
                                               (60, 30, 7, (4, 33)), (200, 3, 7, (4, 33)),
                                               (5, 100, 7, (4, 33))])
def test_conv3x3_bwd_f32_plans_channel_split(c, co, cc, blocks):
    """K6 takes 3 input channels a thread where C <= 3; K7 splits the
    channels past 52 input or 27 output over its grid's second axis, and
    shares the card's SMs among those channel blocks."""
    p6 = tk.conv3x3_dx_f32_plan(8, c, co, 192, 192)
    assert p6.cc == cc and p6.groups == -(-c // cc)
    p7 = tk.conv3x3_dw_f32_plan(8, c, co, 192, 192)
    assert (p7.channel_blocks, p7.blocks) == blocks
    assert p7.tiles_c == min(-(-c // 13), 4) and p7.tiles_o == min(-(-co // 3), 9)


@pytest.mark.parametrize("plan", ["conv3x3_dx_f32_plan", "conv3x3_dw_f32_plan"])
@pytest.mark.parametrize("shape", [(0, 5, 3, 8, 8), (1, 0, 3, 8, 8), (1, 5, 0, 8, 8),
                                   (1, 5, 3, 0, 8), (1, 5, 3, 8, 0), (65536, 5, 3, 8, 8),
                                   (1, 5, 3, 65536, 32768)])
def test_conv3x3_bwd_f32_plans_refuse(plan, shape):
    with pytest.raises(ValueError, match=r"conv3x3_chw_d[xw] \(float32\)"):
        getattr(tk, plan)(*shape)


# (N, C, Co, H, W) of x at half resolution for K9's float32 forward (with
# K14 at eval), and its plan (TO, groups, groups a block, channel chunks,
# tiles): the Experiment-1 step's two fused up-convs, then the flagship's
# three fused conv1 sites of the --fuse_up all one pass and sub-image (N = 1)
UPCONV_PLANS = [
    ((8, 52, 26, 96, 96), (2, 13, 4, 4, (12, 3))),  # auto, block 5
    ((8, 26, 13, 192, 192), (2, 7, 4, 2, (24, 6))),  # auto, block 6
    ((1, 104, 52, 48, 48), (1, 52, 4, 13, (6, 2))),  # eval: 2 a thread would leave 312 warps
    ((1, 52, 26, 96, 96), (1, 26, 4, 7, (12, 3))),  # eval: 2 a thread would leave 468
    ((1, 26, 13, 192, 192), (2, 7, 4, 2, (24, 6))),  # eval: 1008 warps at 2 a thread
]


@pytest.mark.parametrize("shape, plan", UPCONV_PLANS, ids=lambda v: str(v))
def test_upconv_f32_plan(shape, plan):
    """2 output channels a thread where that leaves four warps an SM of 132
    (every training shape, the N = 1 layer at 192^2), else 1 (the N = 1
    layers at 48^2 and 96^2); 4 groups a block; 8 x 32 half-res tiles, a
    partial row a tile; the packed weights chunks x C x 16 x G TO floats."""
    n, c, co, h, w = shape
    p = tk.upconv_f32_plan(n, c, co, h, w)
    assert (p.to, p.groups, p.g, p.chunks, (p.tiles_h, p.tiles_w)) == plan
    assert p.groups == -(-co // p.to) and p.chunks * p.g >= p.groups > (p.chunks - 1) * p.g
    assert p.part_rows == n * p.tiles_h * p.tiles_w
    assert p.wp_numel == p.chunks * c * 16 * p.g * p.to
    assert p.tiles_h * p.tiles_w * n * p.groups >= 4 * 132


@pytest.mark.parametrize("co, to, g, chunks", [(1, 1, 1, 1), (3, 2, 2, 1), (5, 2, 2, 2),
                                               (13, 2, 4, 2), (26, 2, 4, 4), (32, 2, 4, 4),
                                               (33, 2, 4, 5), (52, 2, 4, 7), (64, 2, 4, 8),
                                               (100, 2, 4, 13), (256, 2, 4, 32)])
def test_upconv_f32_plan_channel_split(co, to, g, chunks):
    """On N = 8 at 96^2 (288 tiles) TO is 2 from Co = 3 on (two groups fill
    four warps an SM; Co = 1 takes one channel a thread); a block holds the
    most of (4, 2, 1) groups that the channels fill, and wider layers (a
    --G_ch past 52) split their groups over the grid's second axis."""
    p = tk.upconv_f32_plan(8, 16, co, 96, 96)
    assert (p.to, p.g, p.chunks) == (to, g, chunks)
    assert p.g in tk.UPCONV_F32_G and p.chunks * p.g * p.to >= co


@pytest.mark.parametrize("h, w, tiles", [(1, 1, (1, 1)), (13, 45, (2, 2)), (17, 33, (3, 2)),
                                         (8, 32, (1, 1)), (9, 31, (2, 1)), (48, 48, (6, 2))])
def test_upconv_f32_plan_tiles_cover_the_image(h, w, tiles):
    """8 x 32 half-res tiles, the last row and column of them padded."""
    p = tk.upconv_f32_plan(3, 5, 7, h, w)
    assert (p.tiles_h, p.tiles_w) == tiles
    assert (p.tiles_h - 1) * 8 < h <= p.tiles_h * 8 and (p.tiles_w - 1) * 32 < w <= p.tiles_w * 32
    assert p.part_rows == 3 * tiles[0] * tiles[1]


# K9 dW's float32 plan at the Experiment-1 shapes: (output and input tiles a
# block, pixel slots, threads, rows a chunk, chunks)
UPDW_PLANS = [
    ((8, 52, 26, 96, 96), (13, 13, 1, 352, 4, 8 * 24 * 3)),
    ((8, 26, 13, 192, 192), (7, 7, 4, 416, 8, 8 * 24 * 6)),
]


@pytest.mark.parametrize("shape, plan", UPDW_PLANS, ids=lambda v: str(v))
def test_upconv_dw_f32_plan_at_exp1(shape, plan):
    """2 x 4 channel tiles a phase row, every channel in one block, the most
    pixel slots a power of two that 512 threads hold (52 -> 26 one: 338
    threads a slot), the chunk's rows with the least (chunks of the busiest
    block) x (rows + 1) among those whose two stages fit 227 KB (52 -> 26
    at most 4: its stage is 100 KB), one block an SM of 132, a partial row
    of Co C 16 + Co."""
    n, c, co, h, w = shape
    p = tk.upconv_dw_f32_plan(n, c, co, h, w)
    assert (p.tiles_o, p.tiles_c, p.slots, p.threads, p.rows, p.chunks) == plan
    assert (p.channel_blocks, p.blocks) == (1, 132)
    assert p.slots * p.tiles_o * p.tiles_c * 2 <= 512 and p.slots <= 4 * p.rows
    assert p.rows in tk.UPCONV_DW_F32_ROWS
    assert p.part_entries == co * c * 16 + co
    assert 2 * tk.upconv_dw_stage_bytes(p.rows, p.tiles_o, p.tiles_c) <= tk.CONV3X3_DW_F32_SMEM


@pytest.mark.parametrize("c, co, slots, rows", [(1, 1, 32, 8), (4, 4, 32, 8), (1, 5, 32, 8),
                                                (8, 8, 32, 8), (16, 16, 8, 4), (26, 13, 4, 4)])
def test_upconv_dw_f32_plan_slots_have_runs(c, co, slots, rows):
    """Narrow layers hold more slots than 512 threads would allow tiles for:
    the slots stop at the 32 runs of an 8-row chunk, whose rows the plan then
    takes, so that every slot has a run (the entry point refuses a plan
    where one would not)."""
    p = tk.upconv_dw_f32_plan(8, c, co, 96, 96)
    assert (p.slots, p.rows) == (slots, rows)
    assert p.slots * tk.UPCONV_DW_F32_RUN <= p.rows * tk.UPCONV_DW_F32_COLS


@pytest.mark.parametrize("h, w", [(1, 1), (13, 45), (17, 19), (8, 32), (33, 47), (192, 192)])
def test_upconv_dw_f32_plan_tiles_cover_the_image(h, w):
    """The chunks (rows x 32 half-res columns) cover every shape, the last
    row and column of them padded, a block each up to the card's 132."""
    p = tk.upconv_dw_f32_plan(2, 5, 7, h, w)
    assert p.chunks == 2 * -(-h // p.rows) * -(-w // 32)
    assert p.blocks == min(p.chunks, 132)


@pytest.mark.parametrize("c, co, channel_blocks, blocks", [(3, 5, 1, 132), (1, 1, 1, 132),
                                                            (52, 32, 1, 132), (53, 26, 2, 66),
                                                            (60, 30, 2, 66), (64, 32, 2, 66),
                                                            (104, 52, 4, 33), (5, 100, 4, 33)])
def test_upconv_dw_f32_plan_channel_split(c, co, channel_blocks, blocks):
    """Channels past 52 input or 32 output (a --G_ch past 52) split over the
    grid's second axis, the card's SMs shared among those channel blocks;
    the largest block's two stages still fit."""
    p = tk.upconv_dw_f32_plan(8, c, co, 96, 96)
    assert (p.channel_blocks, p.blocks) == (channel_blocks, blocks)
    assert p.tiles_c == min(-(-c // 4), 13) and p.tiles_o == min(-(-co // 2), 16)
    assert 2 * tk.upconv_dw_stage_bytes(p.rows, p.tiles_o, p.tiles_c) <= tk.CONV3X3_DW_F32_SMEM


@pytest.mark.parametrize("plan, name", [("upconv_f32_plan", r"upconv3x3_chw \(float32\)"),
                                        ("upconv_dw_f32_plan", r"upconv3x3_chw_dw \(float32\)")])
@pytest.mark.parametrize("shape", [(0, 5, 3, 8, 8), (1, 0, 3, 8, 8), (1, 5, 0, 8, 8),
                                   (1, 5, 3, 0, 8), (1, 5, 3, 8, 0), (65536, 5, 3, 8, 8),
                                   (1, 5, 3, 65536, 32768)])
def test_upconv_f32_plans_refuse(plan, name, shape):
    with pytest.raises(ValueError, match=name):
        getattr(tk, plan)(*shape)


@pytest.mark.parametrize("fn, args", [
    ("upconv3x3_chw_dx", lambda: (torch.zeros(1, 3, 4, 4), torch.zeros(1, 2, 8, 8),
                                  torch.zeros(2, 3, 3, 3), torch.ones(3), torch.zeros(3), True,
                                  "replicate")),
    ("stem_fwd", lambda: (torch.zeros(1, 3, 8, 8), torch.zeros(4, 3, 4, 4), torch.zeros(4))),
    ("stem_dw", lambda: (torch.randn(2, 3, 6, 10, generator=torch.Generator().manual_seed(18)),
                         torch.randn(2, 3, 5, 7, generator=torch.Generator().manual_seed(19)))),
    ("conv1x1_chw_dw", lambda: (torch.randn(2, 5, 3, 4, generator=torch.Generator().manual_seed(1)),
                                torch.randn(2, 3, 3, 4, generator=torch.Generator().manual_seed(2)))),
    ("conv3x3_chw", lambda: (torch.randn(2, 4, 5, 6, generator=torch.Generator().manual_seed(3)),
                             torch.randn(3, 4, 3, 3, generator=torch.Generator().manual_seed(4)),
                             torch.zeros(3), torch.ones(4), torch.zeros(4), True, "replicate",
                             True)),
    ("conv3x3_chw_dx", lambda: (torch.randn(2, 4, 5, 6, generator=torch.Generator().manual_seed(7)),
                                torch.randn(2, 3, 5, 6, generator=torch.Generator().manual_seed(8)),
                                torch.randn(3, 4, 3, 3, generator=torch.Generator().manual_seed(9)),
                                torch.ones(4), torch.zeros(4), True, "replicate")),
    ("conv3x3_chw_dw", lambda: (torch.randn(2, 4, 5, 6, generator=torch.Generator().manual_seed(10)),
                                torch.randn(2, 3, 5, 6, generator=torch.Generator().manual_seed(11)),
                                torch.ones(4), torch.zeros(4), True, "constant")),
    ("upconv3x3_chw", lambda: (torch.randn(2, 4, 5, 6, generator=torch.Generator().manual_seed(12)),
                               torch.randn(3, 4, 3, 3, generator=torch.Generator().manual_seed(13)),
                               torch.zeros(3), torch.ones(4), torch.zeros(4), True, "replicate",
                               True)),
    ("upconv3x3_chw_dw", lambda: (torch.randn(2, 4, 5, 6, generator=torch.Generator().manual_seed(14)),
                                  torch.randn(2, 3, 10, 12, generator=torch.Generator().manual_seed(15)),
                                  torch.ones(4), torch.zeros(4), True, "constant")),
    ("upconv3x3_chw_halo", lambda: (torch.randn(1, 4, 5, 6, generator=torch.Generator().manual_seed(16)),
                                    torch.randn(3, 4, 3, 3, generator=torch.Generator().manual_seed(17)),
                                    torch.zeros(3), torch.ones(4), torch.zeros(4), True, "constant",
                                    torch.ones(1, 4, 8), torch.ones(1, 4, 5))),
    ("conv3x3_chw_halo", lambda: (torch.randn(1, 4, 5, 6, generator=torch.Generator().manual_seed(5)),
                                  torch.randn(3, 4, 3, 3, generator=torch.Generator().manual_seed(6)),
                                  torch.zeros(3), torch.ones(4), torch.zeros(4), True, "constant",
                                  torch.ones(1, 4, 8), torch.ones(1, 4, 5))),
])
def test_cpu_tensors_take_the_plain_versions(fn, args):
    """On CPU tensors the wrappers run their plain versions: no kernel is
    built or launched and no route is counted."""
    before = dict(tk.ROUTE_LAUNCHES)
    out = getattr(tk, fn)(*args())
    plain = getattr(tk, fn + "_plain")(*args())
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    plain if isinstance(plain, tuple) else (plain,)):
        assert torch.equal(a, b)
    assert tk.ROUTE_LAUNCHES == before
