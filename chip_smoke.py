#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports only
the PyTorch package (``infinite_texture_gans_torch``), never JAX.

1. Prints the card's name and power limit, builds the CUDA kernels of
   ``infinite_texture_gans_torch/csrc`` with nvcc (one process per source).
2. Holds each generation kernel (K1-K4) against its plain PyTorch version
   in float32 with TF32 off and in bfloat16, at the shapes of the flagship
   and of the SSM recipe at eval (blocks 4-5, identity-folded convs): one
   sub-image (the raster path; 384^2 and 192^2, timed) and, for K1, K3 and
   K4, the 768^2 one-pass grid too. K1 (with K5's sums) and K2 route by
   dtype: bf16 on the tensor-core kernel of ``csrc/chw_fwd_tc.cu``, held to
   the plain versions with the route's rounded weights (``*_tc_plain``;
   the unrounded one's distance reported), K2 in its four border cases,
   two calls bit-equal, and at the flagship sub-image's first and last conv
   four planted faults (ky and kx swapped, the replicate ring as zeros, K2
   ignoring its cached top row, one channel's Σy² x 1.01) must fail those
   checks; f32 on the CUDA-core kernel of ``csrc/conv3x3_fwd_f32.cu``, two
   calls bit-equal and, at the same two convs, a planted fault (the
   weights' bottom row of taps dropped) at least F32_PLANT times its limit
   (``check_fwd_f32``). K3 routes the
   same way: bf16 on the tensor-core kernel of ``csrc/conv1x1_tc.cu``, held
   to ``conv1x1_chw_tc_plain`` (W and b rounded to bf16; each y also within
   its own limit, ``k3_limits``), two calls bit-equal, and at each sub-image's
   first shortcut four planted faults (one input channel's weights x 1.01,
   the bias dropped, the residual dropped, one k16 step skipped) must read
   at least K3_PLANT times their limits (``check_1x1``); f32 on the
   CUDA-core kernel of ``csrc/conv1x1_chw.cu``. The conv2 and final sites of
   ``--fuse_up all`` (phase 2b) are the flagship's shapes checked here.
2b. ``--fuse_up all`` at eval: K14 (K9's forward with the raster's cached
   half-res borders) against its plain version at the flagship's three
   fused conv1 sites of a 384^2 sub-image (blocks 4-6: 104 -> 52 at 48^2
   half resolution, 52 -> 26 at 96^2, 26 -> 13 at 192^2) with no cache, a
   top row, a left column and both; K9 (no stats), the half-res shortcut K3
   and K10 (no stats) there and at the 768^2 one pass's grid (K3 as in
   phase 2, with planted faults at the first site); f32 and bf16, both
   paddings; timed into the ``:gen_all`` rows with K1/K2 at the conv2 and
   final sites.
3. Holds each training kernel (K5 stats, K6, K7, K8, K3 stats and dW, K4's
   adjoint, the K13 stem trio, and the fused up-conv K9 forward with and
   without stats, dx, dW and its residual join K10 with and without stats)
   against its plain version at every shape of the Experiment-1 step (N = 8
   fake 384^2 grids, tail blocks 5-6) under both tails: ``--fuse_up off``
   and ``auto``, whose half-res shortcut (K3 and its dx form, K3-dW) and
   K10 adjoint (K4-bwd) run at shapes of their own; f32 and bf16, both
   outer paddings. K1/K5 is checked as in phase 2 (no K2 in training). K6
   and K9 dx route by dtype: bf16 on the tensor-core kernels of
   ``csrc/chw_dx_tc.cu``, held to the plain versions with the
   route's rounded weights (``*_tc_plain``; the unrounded one's distance
   reported), two calls bit-equal, and at two shapes each three planted
   faults (the top fold dropped, one input channel's weights x 1.01, ky and
   kx swapped) must fail that check. K7 routes the same way: bf16 on the
   tensor-core kernel of ``csrc/chw_dw_tc.cu``, held to the plain version
   itself (its operands are bf16 values, so it needs no rounded twin) at
   the sums' limit, two calls bit-equal, and at two shapes three planted
   faults (one input channel's dW x 1.01, ky and kx swapped, the replicate
   ring taken as zeros) must fail that check. K13's forward routes the
   same way: bf16 on the tensor-core kernel of ``csrc/stem_fwd_tc.cu``,
   held to ``stem_fwd_tc_plain`` (w and b rounded to bf16), two calls
   bit-equal, and four planted faults (ky and kx swapped, the bias
   dropped, the zero border read as the edge pixel, one k16 step skipped)
   must read at least STEM_PLANT times that check's limit; its library
   call is ``F.conv2d`` writing NHWC (channels_last weights), with NCHW
   and NCHW-then-permute printed beside it (the same at the SSM step's
   shapes, phase 3b). K3 (with the residual and the sums, and its dx form)
   is checked as in phase 2 (``check_1x1``, five planted faults with the
   sums' at block 5's shapes), and K3-dW routes by dtype too: bf16 on the
   tensor-core kernel of ``csrc/conv1x1_tc.cu``, held to the plain version
   itself at the sums' limit, two calls bit-equal, and three planted faults
   (one input channel's dW x 1.01, the last pixel tile of each image
   dropped, db from one image only) must read at least K3_PLANT times the
   limit (``check_1x1_dw``). K9 dW and K13 dW route by dtype too: bf16 on
   the tensor-core kernels of ``csrc/upconv_dw_tc.cu`` and
   ``csrc/stem_dw_tc.cu``, held to the plain versions themselves at the
   sums' limit (both operands are bf16 values) at every Exp-1 and SSM
   shape, both paddings, and K13 dW also at the STEM_ANY_CO widths; two
   calls bit-equal; four planted faults each (one input channel's dW x
   1.01, ky and kx swapped, the replicate ring as zeros or the zero border
   as the edge pixel, db from the even full-res rows or one image) must
   read at least DW_PLANT times the limit (``check_wgrad``); the K9 dW row
   includes the wrapper's fold to 3x3, and the entry point alone is
   printed. K13 dx routes by dtype too: bf16 on the tensor-core kernel of
   ``csrc/stem_dx_tc.cu``, held to ``stem_dx_tc_plain`` (w rounded to
   bf16; the unrounded plain version's distance reported) at the Exp-1 and
   SSM shapes and the STEM_ANY_CO widths, two calls bit-equal, and three
   planted faults (ky and kx swapped, one k16 step skipped, g's zero border
   read as the edge pixel) must read at least STEM_PLANT times that check's
   limit (``check_stem_dx``); its f32 route (``csrc/stem_dx_f32.cu``) is held
   to ``stem_dx_plain`` at the same shapes and ``--D_ch`` WIDE_D_CH, two
   calls bit-equal, and three planted faults (ky and kx swapped, output
   channels 0-3 skipped, g's zero border read as the edge
   pixel) must read at least F32_PLANT times the f32 limit. K8 (16-byte
   vectors) is held bit-equal to its
   plain version at every path's shapes, at an odd HW and on a g one element
   into its storage, and a planted fault must break the equality
   (``check_bn_corr_edges``). K4 (one 16-byte vector body for both dtypes) is
   held bit-equal at every path's shapes. K10 (16-byte vectors, its sums as
   fixed-order partials) is held bit-equal at every path's shapes, its sums
   to float32 sums of its stored y there and to float64 ones (UP2ADD_SUM_TOL)
   at the Exp-1 shapes, an odd W, a W of 1 and on an x or res one element
   into its storage; two calls with stats give the same bits, and planted
   faults (one y element one step off, one block's partial lost) must fail
   those checks (``check_up2add_edges``). The f32 routes (K1, K6, K7,
   K9 dx, K9 dW, K13's forward, dW and dx, K3, K3-dW) run on the CUDA-core kernels, timed into
   rows of their own (``:f32_<path>``), and each CUDA-core kernel is timed in
   bf16 beside the tensor-core one. K9 dx's and K13's forward's f32 routes
   (``csrc/upconv_dx_f32.cu``, ``csrc/stem_fwd_f32.cu``) are also held to
   their plain versions with the ReLU off, at an odd C and W, with zeros
   padding, with K9 dx's last channel group and its tiles padded (C = 11 on
   13 x 45 and 13 x 46, both paddings), at the STEM_ANY_CO widths and ``--D_ch`` WIDE_D_CH, and in bf16
   through the same entry points; two calls give the same bits; a planted
   fault each (K9 dx's top border fold dropped, K13's bottom row of taps
   dropped) must read at least F32_PLANT times its limit; and their times
   are printed beside the recorded times of the bodies they replaced
   (K9DX_F32_PARENT_MS, STEM_F32_PARENT_MS). K1's and K3-dW's f32 routes
   (``csrc/conv3x3_fwd_f32.cu``, ``csrc/conv1x1_dw_f32.cu``) are held the same
   way: two calls bit-equal at every path shape (K1's y, Σy, Σy²; K3-dW's dW
   and db), a planted fault each (K1's bottom row of taps dropped at block
   5's shapes; K3-dW's last 64-pixel chunk of each image dropped at the
   first shortcut of each path) at least F32_PLANT times its limit, and off
   the path's shapes (``check_f32_edges``): K1 with K5's sums at odd H and
   W, zeros padding, the ReLU off and an odd Co, K2 in its four border
   cases; K3-dW at an odd HW, its widest thread grid and one-channel sides;
   both C entry points in bf16; their times beside the recorded times of
   the bodies they replaced (K1_F32_PARENT_MS, K3DW_F32_PARENT_MS). K6's
   and K7's f32 routes (``csrc/conv3x3_dx_f32.cu``,
   ``csrc/conv3x3_dw_f32.cu``) likewise: two calls bit-equal at every path
   shape (dx, d(scale), d(shift); dW, db), planted faults at the block's
   two 192^2 shapes (K6: the top fold dropped, the bottom row of taps
   dropped; K7: one input channel's dW x 1.01, ky and kx swapped, one pixel
   chunk dropped) at least F32_PLANT times their limits
   (``check_dx_f32``, ``check_dw_f32``), odd shapes, both paddings and the
   ReLU off in ``check_f32_edges``, and their times beside the recorded
   times of the bodies they replaced (K6_F32_PARENT_MS, K7_F32_PARENT_MS).
   K9's forward (with K14) and K9 dW's f32 routes (``csrc/upconv_fwd_f32.cu``,
   ``csrc/upconv_dw_f32.cu``) likewise: two calls bit-equal at every path
   shape (y, Σy, Σy², K14 with both borders at the eval shapes; dW, db), K9's
   sums also against float64 sums (K9_SUM_TOL), planted faults at both
   training shapes (the forward: slot (1, 1) of phase (0, 0) skipped, ky and
   kx swapped, the first tile's Σy partial dropped, K14 reading its cached
   top row as the own edge; dW: one phase tap's dW x 1.01, ky and kx
   swapped, one pixel chunk dropped) at least F32_PLANT times their limits
   (``check_up_f32``, ``check_updw_f32``), odd shapes, both paddings, the
   ReLU off, channels past the planner's tiles, one-channel sides and
   ``--G_ch`` 64 in ``check_f32_edges``, and their times beside the recorded
   times of the bodies they replaced (K9_F32_PARENT_MS, K9DW_F32_PARENT_MS).
   K13 dW's f32 route (``csrc/stem_dw_f32.cu``) likewise: two calls bit-equal
   at every shape it is checked at, planted faults at both training shapes
   (ky and kx swapped, one chunk of pixels dropped) at least F32_PLANT times
   its limit (``check_stem_dw_f32``); the parent's times come from
   ``f32_route_study.py --tree`` in turns, not from a recorded table. Times
   each (CUDA-graph replay) beside its bound, its plain version and one
   PyTorch library call, summed per
   step for each tail, and holds the timed calls per step to the tail's
   launch counts.
3b. The SSM recipe (README: ``12.jpg``, ``--type_norm SSM --n_layers_G 5
   --n_layers_D 3 --random_crop 128``, map_dim 1, bf16): the SSM embed
   chain K15, forward and backward, against its plain versions at every
   SSM site's shape (training: N = 8, C = 52 and 26 at 192^2; eval: N = 1,
   C = 104 and 52 at 96^2, 52 and 26 at 192^2), on both of its routes:
   bf16 on the tensor-core kernels (the forward within the bf16 limit, the
   backward's sums within the sums' limit of the plain version that applies
   the route's roundings, which planted faults must fail, two backward
   calls bit-equal) and f32 on the CUDA-core kernels (the f32 limits; two
   forward calls bit-equal at every shape, w2's dy and dx swapped and one
   hidden chunk skipped (its 8 channels' w2 zeroed) at least F32_PLANT times
   the forward's limit; the backward's two calls bit-equal and a dropped
   chunk's partials at least F32_PLANT times the dW2 and dW1 limits), the
   window compare bit-equal on both; timed beside its bound (operations: it is the
   compute-bound kernel), its plain version and the cuDNN calls for the
   same chain, each of the backward's launches also on its own
   (``[launch]``, torch.profiler), the f32 route at the training shapes into rows of its own
   (``:f32_parity``, launches from the f32 SSM step parity; the backward's
   ``:f32_ssm``, launches from the graphed f32 SSM training run), the f32
   forward at the eval shapes too (``:f32_gen_ssm``, per 192^2 sub-image,
   launches from phase 7's f32 768^2 canvases); and K1/K5, K6, K7 (the
   identity fold), K8, K3 (+ its dx form), K3-dW, K4, K4-bwd and the stem
   at the SSM step's own shapes, summed per SSM step (K1, K6 and K7 on both
   routes, as in phase 3; K3 and K3-dW checked with planted faults as there).
4. Loads the trained flagship checkpoint ``examples/241_300ep_ema.ckpt``
   and runs the generation phase (``generation_phase``):
   - float32, 768^2: the one-pass oracle (a main path, launch counts
     read), then the raster engine against it;
   - bfloat16, 1024^2 through ``generate_canvas(wire='u8')`` (the main
     path: K2, K3, K4, launch counts held to 7/3/3 per sub-image), its seam
     ratios and warm wall time, one traced canvas;
   - on the first canvas's latents: the seam ratio of the one pass and of
     sub-images generated without the halo cache (which set the raster's
     seam limit), and, attention gate zeroed, the bf16 raster canvas held to
     the bf16 one pass;
   - ``[route]``: the f32 one pass and canvases launch K1/K2 and K3 on the
     CUDA cores only, every bf16 canvas on the tensor cores only (the
     counted raster exactly its K2 and K3 launches), and no K3-dW, K9 dW
     or K13 dW;
   - the raster runs as it runs for users, a CUDA graph replay per canvas
     row once its kind has come up (``RasterRow``), and against its eager
     form (``graphs=False``): the f32 768^2 canvas equal, the bf16 1024^2
     u8 canvas byte-equal, the same launches per canvas cold (eager warm-up
     rows, the rest's capture at its second row), second (the first row's
     capture) and warm (replays only); both forms' cold, second and warm walls and
     traced busy shares; two planted faults (replays without the row's new latent
     strip; graphs that do not write the halo cache back) must break the
     byte equality (flagship only).
4b. The same generation phase for a freshly loaded flagship with
   ``fuse_up='all'`` (one pass: K9 3, K1 4, K3 3, K10 3; per sub-image K14
   3, K2 4, K3 3, K10 3); its canvases against the unfused engine's on the
   same latents, gate zeroed (f32 768^2 held to the reference test's
   tolerance, bf16 1024^2 in u8 levels); a 4096^2 canvas streamed into a
   PNG (``sampling/stream.py``) and held byte-equal to the in-memory u8
   canvas, both walls; K1/K2's ``[route]`` as in phase 4.
5. Step parity: at full Experiment-1 width in float32 (TF32 off), under
   ``--fuse_up auto`` and ``off``, one fused training step from a fixed
   state with the kernels, and the same step with the tail and the stem on
   their plain versions; losses and each gradient leaf must agree (its
   largest deviation against its largest value). Then the fused step
   against the unfused one from the same state and crops, both on the
   kernels. The same step parity for the SSM recipe (K15 included). Each
   f32 step parity runs K1, K6, K7, K9's forward, dx and dW, K13's forward,
   dW and dx, K3 and K3-dW on their CUDA-core entry points only
   (``[route]``).
   ``step_parity_study.py`` measures the limits' spread and planted faults.
   Then the train loop's dispatched step (``StepDispatch``), GRAPH_STEPS
   steps from one state and one generator state, eagerly and as the train
   loop runs it (WARMUP_STEPS eager warm-up steps on a side stream, then
   replays of the captured step), under ``auto``, ``off`` and SSM
   (``graph_parity``): both runs start the first replayed step from the
   eager run's state; in f32 that step is held to step parity's gates and
   the last reported beside a second eager run (K3's f32 sums add with
   atomics); in bf16 every loss, gradient, parameter and buffer
   bit-equal; the same launches; under ``auto`` a planted fault (every
   replay draws the first replay's crops and latents) must break them.
6. Training runs: 30 bf16 steps each through the train CLI's ``train``:
   the Experiment-1 recipe on ``datasets/241.jpg`` under ``--fuse_up auto``
   (the default) and ``off``, then the SSM recipe on ``datasets/12.jpg``,
   each in both dispatch forms: the CLI default ``--steps_per_dispatch 0``
   (two eager warm-up steps, then replays of a captured CUDA graph of the
   step) and ``--steps_per_dispatch 1`` (eager); exact launch counts per
   step, warm steps/s, the device's busy share over the run's last
   TRACED_STEPS steps (torch.profiler), the peak device memory, then the
   written ``.ckpt`` reloaded through the sampling loader and rendered to
   a 384^2 canvas. Each bf16 run launches
   K1/K2, K6, K7, K9's forward, dx and dW, K13's forward, dW and dx, K3
   and K3-dW on their tensor-core entry points only (``[route]``). Then
   the Experiment-1 recipe at ``--compute_dtype float32`` (the train CLI's
   default; cuDNN's TF32 as PyTorch leaves it), graphed, under ``auto`` and
   ``off``, and the SSM recipe the same way: the warm step and its device
   busy time beside the recorded parent tree's (F32_STEP_PARENT_MS), and
   every routed kernel on its CUDA-core entry point only (``[route]``:
   ``itg_upconv3x3_chw_dx`` 2, ``itg_stem_fwd`` 2, ``itg_conv3x3_chw`` 3
   and ``itg_conv1x1_chw_dw`` 2 a step under ``auto``; K15's
   ``itg_ssm_embed_fwd`` and ``itg_ssm_embed_bwd`` at least 3 a step under
   SSM, the kernels line's ``ssm_embed_bwd:f32_ssm`` row).
7. SSM generation from the SSM run's EMA checkpoint through the same
   generation phase (one-pass launches K15 6, K1 5, K3 2, K4 2; per 1024^2
   canvas K15 384, K2 320, K3 128, K4 128; the bf16 raster against the
   bf16 one pass is reported, not held: see CANVAS_U8_TOL); the sample CLI
   renders a PNG from the checkpoint.
8. Resume (``resume_phase``): the Experiment-1 ``--fuse_up auto`` recipe at
   full width with RESUME_STEPS steps an epoch, graphed, through ``train``:
   a 2-epoch leg without ``--seed``, two uninterrupted 4-epoch runs with the
   seed it drew, and a fresh ``train`` resumed from the leg's ``2_2.ckpt``
   without ``--seed``; the restored seed, the loss histories and the final
   G, D, Adam and EMA tensors (bit-equal where the two uninterrupted runs
   are, else within STEP_GRAD_TOL), the launches of the resumed epochs, and
   a planted fault (the resume without the per-epoch reseed) that must
   fail; the epoch walls with a save in flight and without, and each
   save's time on the worker thread.
9. Zeros padding, the parsers' default (``zeros_phase``): the graphed steps
   against eager ones (``graph_parity``: bf16 bit-equal; f32 reported), 30
   graphed bf16 steps through ``train`` (warm wall, busy share, peak
   memory), the sample CLI on the
   run's EMA checkpoint (a 1024^2 one pass, a 4096^2 ``--tiles`` canvas,
   both walls), and in f32 at 2048^2 the tiled canvas's first tile against
   the one pass; none of it may launch one of the port's kernels.
10. The training options (``options_phase``) at full Experiment-1 width,
   ``--fuse_up auto``: ``--loss wgan --gp_weight 10 --disc_iters 5``,
   ``--norm_layer_D batch --disc_iters 2``, ``--norm_layer_D instance`` and
   ``--spec_norm_G --spec_norm_D``: graphed steps against eager ones
   (``graph_parity``; bf16 bit-equal, the exact launches of each step, a
   planted fault under WGAN-GP: every replay reusing the first replay's
   penalty weights; f32 at step parity's gates, WGAN-GP's losses at
   WGAN_STEP_LOSS_TOL), the f32 WGAN-GP step against its plain versions, 30
   graphed bf16 steps through ``train`` for WGAN-GP and for SN in G (warm
   wall, busy share, peak memory), and the SN run's EMA checkpoint through
   the sample CLI to a 1024^2 PNG with phase 4's launches per canvas.
11. Multi-image training (``multi_phase``): the README's multi-image recipe
   (``--data multiple_images --data_path datasets/multi``: the three bundled
   textures stacked on the card, crops drawn in the step) at full Exp-1
   width, 30 graphed bf16 steps through ``train`` with every step's launches
   held to ``auto``'s, its warm wall, busy share and peak memory beside
   phase 6's single-image ``auto`` run; its graphed steps bit-equal to eager
   ones (``graph_parity``, bf16); a stack of the textures raised to >= 1
   from which no drawn batch holds an exact -1 (padding never read); then
   MULTI8 images cut from the textures under a cap that keeps 2 resident
   (``RotatingMultiImageSampler``): 30 graphed steps in chunks of MULTI8_SPD
   against the same images all resident, the windows each chunk used, each
   swap's host time, the epoch's residency spread (at most one window), and
   a 2 + 2-epoch resume bit-equal to 4 uninterrupted epochs.
12. The batched-diagonal engine (``diag_phase``) on the flagship: f32
   768^2 (TF32 off) against the raster within CANVAS_TOL, bf16 1024^2 u8
   at lanes 1 byte-equal to the raster with its launches and at lanes 4
   byte-equal to the raster at batch 4 (cuDNN's algorithms at batch 4
   against batch 1 reported in u8 levels); at 1024^2 lanes
   DIAG_LANES and at DIAG_BIG^2 lanes 8, beside the raster graphed and
   eager: warm walls, traced device busy per canvas, generator calls, K2 /
   K3 / K4 launches and K2's device ms per launch; ``--fuse_up all`` and
   the SSM run's checkpoint through the same gates at lanes 4; ``sample
   --diag_lanes 4`` writing a 1024^2 PNG.
13. Interop (``pth_phase``, ``mfu_phase``, ``quality_phase``,
   ``zoo_phase``): the flagship ``.ckpt`` through ``sample --export_pth``
   to a reference ``.pth``, both loaded (timed) and rendered to a 1024^2
   bf16 u8 canvas byte-equal with phase 4's launches; ``.pth -> .pth``
   bit-equal (BN counters set nonzero); phase 10's SN-in-G checkpoint
   exported and imported back to its tree with ``u``/``v``; phase 6's
   runs' stall watchdogs (one beat an epoch, stopped, thread joined);
   ``[mfu]``: model TFLOP (``utils/flops.py``) per graphed Exp-1 ``auto``
   / ``off`` and SSM step and per BN / ``all`` / SSM 1024^2 canvas over the
   walls phases 4-7 measured, against ``peak_flops``; ``[quality]``: the
   flagship canvas's ``texture_quality_report`` against
   ``datasets/241.jpg`` on the card and on the CPU within QUALITY_REL;
   ``[zoo]``: the three discriminators (``ResDiscriminator`` unconditional
   with attention and with each conditioning method, ``DCDiscriminator``,
   ``SNDiscriminator``) at the JAX package's default widths, a forward with
   an SN refresh and a backward on the card: float64 held to the CPU within
   ZOO_TOL, float32 (TF32 off) to the CPU's float64 within ZOO_F32_TOL by
   the gradients' median over ZOO_DRAWS input draws, beside the CPU's own
   float32 and a TF32 control. ``[api]`` (``api_phase``): every name of
   the port's subpackage ``__all__``s imported (no JAX loaded);
   ``crop_images`` of the flagship's 1024^2 canvas in bf16 on the card,
   bit for bit the CPU's, windows of 256 at strides 256 and 192, the first
   merged back by ``merge_patches_into_image`` to the canvas exactly;
   ``calc_ralsloss_G`` on the card within API_LOSS_REL of the CPU.
14. ``parallel/`` on the one card (``parallel_phase``): the data-parallel
   Experiment-1 ``auto`` bf16 step at world size 1 through NCCL, its
   all-reduces captured in the step's CUDA graph, GRAPH_STEPS steps
   bit-equal to the undistributed step with the same launches (both walls
   printed); GLOO_RANKS gloo ranks on the one card, one eager f32 step held
   to the 1-rank step at step parity's gates; the wavefront and its
   slab-streamed PNG at world size 1 on the flagship at 1024^2 bf16 u8
   byte-equal to the graphed raster with its K2/K3/K4 launches (walls
   beside the raster's); one graphed bf16 step at ``--D_ch 640`` with no
   stem launch and finite losses.
15. Prints the ``kernels`` JSON line (``:gen_all`` rows for K1, K9, K14, K2,
   K3 and K10 per 384^2 sub-image under ``--fuse_up all``, ``:gen_ssm`` rows
   for K15, K1, K2, K3 and K4 per 192^2 SSM sub-image, and a ``:train_ssm``
   row for every kernel
   of the SSM step among them; ``:mesh_step`` and ``:wavefront`` rows for
   phase 14's paths, the times of the ``:train_auto`` and generation rows
   at their shapes and the path's own launches), the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line; so does a machine without
a card, or a directory that holds this file and nothing else of the repo.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "examples" / "241_300ep_ema.ckpt"

# float32 with TF32 off: kernel and cuDNN sum up to 9 * 104 = 936 products
# in other orders, and cuDNN may pick Winograd transforms (~1e-5 relative);
# 1e-4 of the output range leaves headroom above both.
F32_TOL = 1e-4
# bfloat16: both sides compute in float32 and round the output once, so an
# output can sit one bf16 ulp (2^-8 of its magnitude) apart; allow two.
BF16_TOL = 2.0**-7
# raster vs one pass, float32, attention gate zeroed: the engine is exact
# up to cuDNN choosing other algorithms for the NHWC blocks 1-3 on a
# sub-image than on the whole canvas (float32 rounding, ~1e-6 relative)
# carried through 13 convs; 5e-3 on the [-1, 1] image.
CANVAS_TOL = 5e-3
# the same in bfloat16 on the u8 canvas: where cuDNN's choices round a
# block 1-3 output one bf16 ulp apart, the difference is carried through
# 13 convs and reaches the image as a few bf16 ulps, each about one u8
# level near +-1 (a bf16 ulp there is 2^-8 of the [-1, 1] range's half).
# Flagship only: the SSM generator's NHWC embeds (cuDNN in bf16 on the
# maps) round differently on a sub-image than on the whole canvas at every
# block 1-3 site, and on an H100 the SSM canvas read 5 levels (4.4% of the
# values differ) with its f32 counterpart at 4e-6; it is reported.
CANVAS_U8_TOL = 4
# seam ratio of the raster canvas (trained attention gate) against the one
# pass and a broken halo on the same latents: on an H100 (flagship, seed
# 21) the working halo read 0.0005 from the one pass and the broken one 6.4
# above it, so a tenth of that gap leaves a wide margin on both sides
SEAM_GAP_SHARE = 0.1

# The flagship the checks are sized for: G_ch 52, n_layers_G 6, base_res 4
# (patch 128, sub-image 3 x 3 patches = 384^2).
FLAGSHIP = dict(G_ch=52, n_layers_G=6, base_res=4)
GRID = 3


def tail_shapes(plan, base, gh, gw):
    """The channels-major tail's kernel shapes (N = 1) for a merged grid of
    gh x gw patches: conv3x3 (C, Co, H, W), conv1x1 (C, Co, H, W) and the
    upsample's input (C, H, W), from blocks 4 on (the eval gate: i > 3,
    cin <= 128, which holds for every flagship block from 4 on)."""
    conv3, conv1, up2 = [], [], []
    for i, (cin, cout) in enumerate(plan, start=1):
        if i <= 3:
            continue
        h, w = gh * base * 2 ** (i - 1), gw * base * 2 ** (i - 1)
        up2.append((cin, h // 2, w // 2))
        conv3 += [(cin, cout, h, w), (cout, cout, h, w)]
        conv1.append((cin, cout, h, w))
    conv3.append((plan[-1][1], 3, h, w))
    return conv3, conv1, up2


def fused_shapes(plan, base, gh, gw):
    """The fused blocks' shapes under ``--fuse_up all`` (N = 1) for a merged
    grid of gh x gw patches: (C, Co, H/2, W/2), the half-resolution input
    of each tail block (blocks 4 on: every one is past block 1, so each
    fuses)."""
    return [(cin, cout, gh * base * 2 ** (i - 2), gw * base * 2 ** (i - 2))
            for i, (cin, cout) in enumerate(plan, start=1) if i > 3]


def exp1_shapes(plan, base):
    """The Experiment-1 step's tail shapes (N = EXP1_N): conv3x3 (C, Co, H, W,
    with stats), conv1x1 (C, Co, H, W) and the upsample's input (C, H, W),
    from the train gate's blocks on (i > 3, cin <= 64: blocks 5 and 6)."""
    conv3, conv1, up2 = [], [], []
    for i, (cin, cout) in enumerate(plan, start=1):
        if i <= 3 or cin > 64:
            continue
        h = w = GRID * base * 2 ** (i - 1)
        up2.append((cin, h // 2, w // 2))
        conv3 += [(cin, cout, h, w, True), (cout, cout, h, w, False)]
        conv1.append((cin, cout, h, w))
    conv3.append((plan[-1][1], 3, h, w, False))
    return conv3, conv1, up2


# kernel -> (tag, CUDA source, pallas_call site in infinite_texture_gans_tpu/ops/)
KERNELS = {
    "conv3x3_chw": ("K1/K5", "chw_fwd_tc.cu", "pallas_conv.py:395"),
    "chw_halo_step": ("K2", "chw_fwd_tc.cu", "pallas_conv.py:539"),
    "conv3x3_chw_dx": ("K6", "chw_dx_tc.cu", "pallas_conv.py:775"),
    "conv3x3_chw_dw": ("K7", "chw_dw_tc.cu", "pallas_conv.py:888"),
    "bn_corr": ("K8", "conv3x3_chw_bwd.cu", "pallas_conv.py:1061"),
    "conv1x1_chw": ("K3", "conv1x1_tc.cu", "pallas_conv.py:2311"),
    "conv1x1_chw_dw": ("K3-dW", "conv1x1_tc.cu", "pallas_conv.py:2361"),
    "upsample2_chw": ("K4", "upsample2_chw.cu", "pallas_conv.py:2540"),
    "upsample2_chw_bwd": ("K4-bwd", "upsample2_chw.cu", "pallas_conv.py:2560"),
    "upconv3x3_chw": ("K9", "upconv_fwd_tc.cu", "pallas_conv.py:1457"),
    "upconv3x3_chw_dx": ("K9-dx", "chw_dx_tc.cu", "pallas_conv.py:1642"),
    "upconv3x3_chw_dw": ("K9-dW", "upconv_dw_tc.cu", "pallas_conv.py:1777"),
    "chw_upconv_halo_step": ("K14", "upconv_fwd_tc.cu", "pallas_conv.py:2019"),
    "upsample2_chw_add": ("K10", "upsample2_chw.cu", "pallas_conv.py:2199"),
    "stem_fwd": ("K13", "stem_fwd_tc.cu", "pallas_conv.py:2769"),
    "stem_dw": ("K13-dW", "stem_dw_tc.cu", "pallas_conv.py:2840"),
    "stem_dx": ("K13-dx", "stem_dx_tc.cu", "pallas_conv.py:2977"),
    "ssm_embed": ("K15", "ssm_embed_tc.cu", "pallas_ssm.py:343"),
    "ssm_embed_bwd": ("K15-bwd", "ssm_embed_tc.cu", "pallas_ssm.py:392"),
}
# The kernels with two routes (K15: ops/ssm.py; K1/K2, K6, K7, K9/K14's forward, K9 dx,
# K9 dW, K13's forward, K13 dW, K13 dx, K3 and K3-dW: ops/kernels.py): the main paths run bf16 on
# the tensor-core kernels above;
# float32 (step parity, the f32 raster) keeps the CUDA-core kernels, reported
# in rows of their own: kernel -> (C entry point, source)
F32_ROUTE = {"conv3x3_chw": ("itg_conv3x3_chw", "conv3x3_fwd_f32.cu"),
             "chw_halo_step": ("itg_conv3x3_chw", "conv3x3_fwd_f32.cu"),
             "ssm_embed": ("itg_ssm_embed_fwd", "ssm_embed_chw.cu"),
             "ssm_embed_bwd": ("itg_ssm_embed_bwd", "ssm_embed_chw.cu"),
             "conv3x3_chw_dx": ("itg_conv3x3_chw_dx", "conv3x3_dx_f32.cu"),
             "conv3x3_chw_dw": ("itg_conv3x3_chw_dw", "conv3x3_dw_f32.cu"),
             "upconv3x3_chw_dx": ("itg_upconv3x3_chw_dx", "upconv_dx_f32.cu"),
             "upconv3x3_chw_dw": ("itg_upconv3x3_chw_dw", "upconv_dw_f32.cu"),
             "stem_fwd": ("itg_stem_fwd", "stem_fwd_f32.cu"),
             "stem_dw": ("itg_stem_dw", "stem_dw_f32.cu"),
             "stem_dx": ("itg_stem_dx", "stem_dx_f32.cu"),
             "upconv3x3_chw": ("itg_upconv3x3_chw", "upconv_fwd_f32.cu"),
             "chw_upconv_halo_step": ("itg_upconv3x3_chw", "upconv_fwd_f32.cu"),
             "conv1x1_chw": ("itg_conv1x1_chw", "conv1x1_chw.cu"),
             "conv1x1_chw_dw": ("itg_conv1x1_chw_dw", "conv1x1_dw_f32.cu")}
TC_ENTRY = {"conv3x3_chw": "itg_conv3x3_chw_tc", "chw_halo_step": "itg_conv3x3_chw_tc",
            "ssm_embed": "itg_ssm_embed_tc_fwd", "ssm_embed_bwd": "itg_ssm_embed_tc_bwd",
            "conv3x3_chw_dx": "itg_conv3x3_chw_dx_tc", "conv3x3_chw_dw": "itg_conv3x3_chw_dw_tc",
            "upconv3x3_chw_dx": "itg_upconv3x3_chw_dx_tc", "stem_fwd": "itg_stem_fwd_tc",
            "upconv3x3_chw_dw": "itg_upconv3x3_chw_dw_tc", "stem_dw": "itg_stem_dw_tc",
            "upconv3x3_chw": "itg_upconv3x3_chw_tc", "chw_upconv_halo_step": "itg_upconv3x3_chw_tc",
            "conv1x1_chw": "itg_conv1x1_chw_tc", "conv1x1_chw_dw": "itg_conv1x1_chw_dw_tc",
            "stem_dx": "itg_stem_dx_tc"}
# K1/K2, K6, K7, K9 dx, K9 dW, K13's forward, K13 dW, K13 dx, K9/K14's forward, K3
# and K3-dW (ops/kernels.py's ROUTE_LAUNCHES): their bf16 rows also carry the CUDA-core
# kernel's time in bf16 (the design the tensor-core one replaced, timed in the
# same run), and their f32 route has a row for each training path (K2 and
# K14 run only at eval: none)
ROUTED = ("conv3x3_chw", "chw_halo_step", "conv3x3_chw_dx", "conv3x3_chw_dw", "upconv3x3_chw_dx",
          "stem_fwd", "upconv3x3_chw", "chw_upconv_halo_step", "conv1x1_chw", "conv1x1_chw_dw",
          "upconv3x3_chw_dw", "stem_dw", "stem_dx")
# K2's four border cases: (top row cached, left column cached)
BORDERS = {"no cache": (False, False), "top only": (True, False), "left only": (False, True),
           "top and left": (True, True)}
# kernels on the generation paths (timed per sub-image: K1 on the one pass,
# the rest on the raster); those of the training step (timed per step) are
# the ones STEP_LAUNCHES counts
GEN_KERNELS = ("conv3x3_chw", "chw_halo_step", "conv1x1_chw", "upsample2_chw")
# exact raster launches per sub-image: the flagship's tail (blocks 4-6, BN
# folds inside K2) and the SSM recipe's at eval (blocks 4-5: K15 at bn1, bn2
# and the shortcut's bn3 of each, identity-folded K2)
GEN_PER_SUB = {"flagship": {"chw_halo_step": 7, "conv1x1_chw": 3, "upsample2_chw": 3},
               "SSM": {"ssm_embed": 6, "chw_halo_step": 5, "conv1x1_chw": 2, "upsample2_chw": 2},
               # --fuse_up all: blocks 4-6 fuse; K14 at their conv1, K2 at conv2
               # and the final conv, the half-res shortcut K3 and K10's join
               "all": {"chw_upconv_halo_step": 3, "chw_halo_step": 4, "conv1x1_chw": 3,
                       "upsample2_chw_add": 3}}
# the --fuse_up all generation path's kernels (K1 and K9 on the one pass, the
# rest on the raster) and its one-pass launches
GEN_ALL_KERNELS = ("conv3x3_chw", "upconv3x3_chw", "chw_upconv_halo_step", "chw_halo_step",
                   "conv1x1_chw", "upsample2_chw_add")
ALL_ONE_PASS = {"upconv3x3_chw": 3, "conv3x3_chw": 4, "conv1x1_chw": 3, "upsample2_chw_add": 3}
# 'all' against the unfused engine, f32 canvas: the reference test's own
# tolerance (tests/test_upconv.py:345; the fused kernels regroup additions)
FUSE_ALL_ATOL, FUSE_ALL_RTOL = 5e-4, 1e-3
# the streamed canvas (one side in pixels): 16 x 16 sub-images of 384^2
STREAM_SIZE = 4096

# The Experiment-1 step (README quick start; --fuse_up auto, the default):
# N = 8 fake 384^2 grids, tail blocks 5 (52 -> 26 at 192^2) and 6 (26 -> 13
# at 384^2).
EXP1_N = 8
EXP1_BATCH = 64
EXP1_ARGS = ["--data_path", str(ROOT / "datasets" / "241.jpg"), "--random_crop", "192",
             "--G_ch", "52", "--D_ch", "64", "--z_dim", "128", "--n_layers_G", "6",
             "--n_layers_D", "4", "--attention", "--padding_mode", "local", "--type_norm_G", "BN",
             "--spec_norm_D", "--smooth", "--ema", "--compute_dtype", "bfloat16",
             "--batch_size", str(EXP1_BATCH), "--num_images", str(EXP1_N)]
TRAIN_STEPS = 30
WARM_STEPS = 20  # steps/s is the median over the last WARM_STEPS steps
TRACED_STEPS = 3
GRAPH_STEPS = 6  # steps of phase 5's graph parity: the warm-up, then 4 replays
# Phase 8 (resume): the Experiment-1 --fuse_up auto recipe with a --sampling
# of RESUME_STEPS steps an epoch, graphed (the CLI's default dispatch: two
# eager warm-up steps, a capture, replays), a save every second epoch;
# RESUME_EPOCHS epochs uninterrupted against half of them and a resumed half
RESUME_STEPS = 4
RESUME_EPOCHS = 4
# Phase 9: the Experiment-1 recipe under the parsers' default --padding_mode
# (zeros: pad-1 convs, one 128^2 patch per fake, every block NHWC), and the
# sample CLI's canvases of its checkpoint: one pass, and --tiles (tile 32,
# pad 16 latent pixels); the tiled canvas's first tile against the one pass
# in f32 at ZEROS_F32^2 within the reference test's tolerance
# (tests/test_tiled.py:32: atol and rtol 1e-4)
ZEROS_ARGS = EXP1_ARGS[:EXP1_ARGS.index("--padding_mode")] + \
    EXP1_ARGS[EXP1_ARGS.index("--padding_mode") + 2:]
ZEROS_CANVAS = 1024
ZEROS_TILED = 4096
ZEROS_F32 = 2048
TILE_TOL = 1e-4
# Phase 10: the training options on the Experiment-1 recipe (--fuse_up auto,
# full width): WGAN-GP with the paper's n_critic and penalty weight
# (Gulrajani et al. 2017: 5 critic updates a G update, lambda 10), D
# BatchNorm with 2 D updates a step, D InstanceNorm, and spectral norm in G
# (with the recipe's own in D); the SN run's EMA checkpoint rendered at
# OPTION_CANVAS^2 through the sample CLI
OPTION_RECIPES = {"wgan": ["--loss", "wgan", "--gp_weight", "10", "--disc_iters", "5"],
                  "batch": ["--norm_layer_D", "batch", "--disc_iters", "2"],
                  "instance": ["--norm_layer_D", "instance"],
                  "sn": ["--spec_norm_G", "--spec_norm_D"]}
# the options' parser defaults (a step parity or training line names the others)
OPTION_DEFAULTS = {"loss": "standard", "disc_iters": 1, "norm_layer_D": None,
                   "spec_norm_G": False}
OPTION_CANVAS = 1024
# the option recipes whose f32 graph parity is reported, not held: G's
# gradient through D's batch or per-image statistics carries the f32
# kernels' atomic order far past step parity's gate (on an H100 80GB HBM3 at
# 700 W this script's first graphed step read 1.07e-2 and 1.65e-2 of a
# leaf's largest value from eager under the batch recipe, an eager run
# 2.63e-2 from another, and 1.16e-2 under the instance recipe, at the conv
# biases before G's train-mode norms; on the CPU JAX's own f32 step of the
# batch recipe reads 3% from its f64 one, tests/test_torch_train_options.py)
F32_REPORTED = ("batch", "instance")
# The README's SSM recipe (Exp-3 style; benchmarks/trace_step.py's
# BENCH_RECIPE=ssm): the Experiment-1 flags with --type_norm_G SSM, map_dim
# 1, n_layers_G 5 (64^2 patches, 192^2 grids), n_layers_D 3, 128^2 crops of
# datasets/12.jpg. The train gate runs block 5 (52 -> 26 at 192^2) channels-
# major; at eval blocks 4 (104 -> 52 at 96^2) and 5.
# Phase 11: the README's multi-image recipe (the three bundled textures,
# 600x450 to 614x440, stacked on the card) at the Exp-1 widths; the padding
# check's batches; MULTI8 images of MULTI8_SIZE cut from the textures for the
# rotating subset, trained in chunks of MULTI8_SPD steps (a window swap
# before each) and resumed in chunks of MULTI_RESUME_SPD
MULTI_ARGS = ["--data", "multiple_images", "--data_path", str(ROOT / "datasets" / "multi")] + \
    EXP1_ARGS[2:]
MULTI_PAD_DRAWS = 50
MULTI8 = 8
MULTI8_SIZE = (400, 440)
MULTI8_SPD = "5"
MULTI_RESUME_SPD = "2"
# Phase 12: the batched-diagonal engine's lanes timed at 1024^2 (at most
# steps_h = 4 run), and lanes 8 at DIAG_BIG^2
DIAG_LANES = (1, 2, 4, 8)
DIAG_BIG = 4096
DIAG_GATE_LANES = 4
DIAG_TOP = 8  # kernels by device time printed for each traced diagonal canvas
# Phase 14 (parallel/, one card): the data-parallel Experiment-1 --fuse_up
# auto step at world size 1 through NCCL, graphed as the train loop runs it
# (GRAPH_STEPS steps), bit-equal to the undistributed step; GLOO_RANKS gloo
# ranks on the one card, one eager float32 step, held to the 1-rank step at
# step parity's gates (STEP_LOSS_TOL, STEP_GRAD_TOL, NOISE_TOL); the
# wavefront and its slab-streamed form (slabs of PARALLEL_SLAB canvas rows)
# at world size 1 on the flagship at PARALLEL_CANVAS^2 bf16 u8, byte-equal
# to the graphed raster; one graphed bf16 step at --D_ch WIDE_D_CH, past the
# tensor-core stem's 512 output channels (conv0 NHWC, no stem launch)
# The gloo step is held with cuDNN off on both sides: cuDNN picks other
# float32 algorithms for G's NHWC blocks at batch 4 (a rank's fakes) than
# at 8, and on an H100 80GB HBM3 at 700 W that put G's block-2 conv1
# weight gradient (GLOO_LEAF, upstream of a train-mode BatchNorm) 1.17e-2
# of its largest value from the 1-rank step, over step parity's 5e-3;
# with cuDNN off it sat where the 1-rank step on the same batch in another
# order sits (the control, reported with the cuDNN-on gap)
GLOO_RANKS = 2
GLOO_LEAF = "G.block2.conv1.conv.weight"
PARALLEL_CANVAS = 1024
PARALLEL_SLAB = 2
WIDE_D_CH = 640
SSM_N = 8
SSM_ARGS = ["--data_path", str(ROOT / "datasets" / "12.jpg"), "--random_crop", "128",
            "--G_ch", "52", "--D_ch", "64", "--z_dim", "128", "--n_layers_G", "5",
            "--n_layers_D", "3", "--attention", "--padding_mode", "local", "--type_norm_G", "SSM",
            "--map_dim", "1", "--spec_norm_D", "--smooth", "--ema", "--compute_dtype", "bfloat16",
            "--batch_size", "64", "--num_images", str(SSM_N)]
# the differentiable kernel wrappers the models call, and the plain
# versions (differentiable PyTorch) that step parity swaps in for them
PLAIN_TWINS = {"conv3x3_chw": "conv3x3_chw_plain", "conv1x1_chw": "conv1x1_chw_plain",
               "conv1x1_chw_add": "conv1x1_chw_plain", "upsample2_chw": "upsample2_chw_plain",
               "upconv3x3_chw": "upconv3x3_chw_plain",
               "upsample2_chw_add": "upsample2_chw_add_plain",
               "conv4x4s2_stem_chw": "stem_fwd_plain"}
# exact kernel launches of one Experiment-1 step under each --fuse_up. Fused
# (blocks 5 and 6): forward K9, conv2 (K1), the half-res shortcut (K3), K10
# per block and the final conv (K1); backward K8 at each stats producer,
# K6/K7 for conv2 and the final conv, K9 dx/dW, the shortcut's dx (K3 with
# Wᵀ) and dW, K4's adjoint for K10; no K4 forward. The default tail first.
STEP_LAUNCHES = {
    "auto": {**dict.fromkeys(KERNELS, 0), "conv3x3_chw": 3, "conv3x3_chw_dx": 3,
             "conv3x3_chw_dw": 3, "bn_corr": 4, "conv1x1_chw": 4, "conv1x1_chw_dw": 2,
             "upsample2_chw_bwd": 2, "upconv3x3_chw": 2, "upconv3x3_chw_dx": 2,
             "upconv3x3_chw_dw": 2, "upsample2_chw_add": 2, "stem_fwd": 2, "stem_dw": 1,
             "stem_dx": 1},
    "off": {**dict.fromkeys(KERNELS, 0), "conv3x3_chw": 5, "conv3x3_chw_dx": 5,
            "conv3x3_chw_dw": 5, "bn_corr": 4, "conv1x1_chw": 4, "conv1x1_chw_dw": 2,
            "upsample2_chw": 2, "upsample2_chw_bwd": 2, "stem_fwd": 2, "stem_dw": 1, "stem_dx": 1},
    # the SSM recipe (block 5 only, never fused): K15 at bn1, bn2 and the
    # shortcut's bn3; K1 for conv1 (stats, which bn2 reads: K8 once; the
    # block output's stats have no reader, as there is no final norm), conv2
    # and the final conv, K6/K7 for all three; the shortcut K3 and its dx
    # form, K3-dW; K4 before the block and its adjoint
    "ssm": {**dict.fromkeys(KERNELS, 0), "ssm_embed": 3, "ssm_embed_bwd": 3, "conv3x3_chw": 3,
            "conv3x3_chw_dx": 3, "conv3x3_chw_dw": 3, "bn_corr": 1, "conv1x1_chw": 2,
            "conv1x1_chw_dw": 1, "upsample2_chw": 1, "upsample2_chw_bwd": 1, "stem_fwd": 2,
            "stem_dw": 1, "stem_dx": 1},
}
# the training paths of the kernels line: (label, what a row's times sum over)
TRAIN_PATHS = {"auto": ("train --fuse_up auto", "per Experiment-1 step"),
               "off": ("train --fuse_up off", "per Experiment-1 step"),
               "ssm": ("train SSM", "per SSM-recipe step")}
# float32 reductions (Σy, Σy², d(scale), d(shift), dW, db) in another order
# (K3's sums by atomics; K5, K6, K7, K9's sums, K9 dx, K9 dW, K3-dW, K13 dW
# and K15's backward by fixed-order partials): 1e-4 of the largest reference
# entry
SUM_TOL = 1e-4
# K15's bf16 dW1 and db1 sum d_pre, which the route rounds to bf16: where the
# kernel's float32 d_act and the plain version's float64 one straddle a
# rounding midpoint, the two round a bf16 step apart; those steps read up to
# 2.2e-4 of max|ref| on an H100 (tests/test_torch_gpu.py at SSM_SHAPES),
# 1.02e-4 at the training shape. A planted dW1 x 1.01 is 20 times this.
DPRE_TOL = 5e-4
# step parity (f32, TF32 off): losses relative 1e-4; each gradient leaf's
# largest deviation within STEP_GRAD_TOL of its largest value. The float32
# step itself sits far from exact arithmetic on the leaves upstream of the
# train-mode norms: on an H100 (step_parity_study.py) the plain versions
# read 2.8e-2 (SSM) and 4.7e-3 (BN --fuse_up off) from a float64 step, the
# kernels as far within 1%; kernels against plain read up to 3.1e-3 (SSM)
# and 9.4e-4 (BN), kernels against themselves (the atomics' order) 9.5e-4
# and 5.5e-4. Planted faults read 3.3e-2 and 6.4e-2 (K6 without the top
# border's fold) and 1.0e-2 (the embed's dW1 scaled by 1 + 1e-2). A leaf
# below 1e-6 of the model's largest gradient is rounding noise (zero in
# exact arithmetic: a bias that reaches only train-mode norms) and is held
# to 1e-3 of that largest.
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 5e-3
NOISE_TOL = 1e-3
# The same for the WGAN-GP recipe of phase 10 (five critic updates before
# the G update, each moving D by Adam's near-sign steps, amplify the f32
# kernels' atomic order): on an H100 80GB HBM3 at 700 W
# (step_parity_study.py WGAN) the kernels read 5.0e-4 (losses) and 1.77e-2
# (G's largest leaf deviation) from themselves, 1.35e-4 and 1.19e-2 from the
# plain versions, and the plain versions 5.5e-3 and 4.67e-2 from a CPU
# float64 step; K6 without the top border's fold reads 1.21e-1. This
# script's phase 10 then read 5.3e-4 and 2.55e-2 kernels against plain. The
# gates sit at about twice the largest of those readings, the planted fault
# 2.4x over the gradients' gate. The loss gate also holds this recipe's f32
# graph parity (the first replay against eager, and a second eager run
# against the first), which at STEP_LOSS_TOL sat below the kernels' own
# 5.0e-4 spread and failed one run of four at 1.373e-4 (H100 80GB HBM3, 700 W).
WGAN_STEP_LOSS_TOL = 1e-3
WGAN_STEP_GRAD_TOL = 5e-2
NOISE_SHARE = 1e-6
# fused against unfused step (kernels both, f32): each gradient leaf's
# norm-relative deviation at most max(FUSE_FLOOR, FUSE_FLOOR_SCALE x) that
# leaf's kernels-vs-plain deviation under --fuse_up off, the reference's
# calibrated criterion (tests/test_upconv.py:214-232); a rounding-noise leaf
# (below NOISE_SHARE of the model's largest gradient) is held as step parity
# holds it
FUSE_FLOOR = 2e-3
FUSE_FLOOR_SCALE = 1.5
# K10's Σy and Σy² against float64 sums of the stored y: float32 adds in one
# fixed order, at most ~90 deep (64 values a thread at the widest plan, a
# tree over the block's threads, then the N x chunks partials), so each
# sits within 90 x 2^-24 ~ 5.4e-6 of Σ|y| (Σy² for the squares) of the
# exact sum; 1e-5 leaves a factor of two. A planted lost partial must read this many times
# that limit.
UP2ADD_SUM_TOL = 1e-5
UP2ADD_PLANT = 10.0
# K10's design before its redesign (one thread per half-res pixel, 2-byte
# accesses, atomic sums), bf16, CUDA-graph replay, per call at each timed
# shape: the mean of two runs of that tree's own chip_smoke.py on one
# NVIDIA H100 80GB HBM3 at 700 W, in the call that timed this design
# beside it (PERF.md section 6)
K10_PARENT_MS = {"(1, 52, 48x48) + (1, 52, 96x96)": 0.00285,
                 "(1, 26, 96x96) + (1, 26, 192x192)": 0.00355,
                 "(1, 13, 192x192) + (1, 13, 384x384)": 0.0048,
                 "(8, 26, 96x96) + (8, 26, 192x192) +stats": 0.0220,
                 "(8, 13, 192x192) + (8, 13, 384x384) +stats": 0.04255}
# K13's bf16 forward and dx: each planted fault must read at least this many times
# the check's limit (BF16_TOL of max|ref|)
STEM_PLANT = 10.0
# K13's forward, dW and dx at output widths that are no multiple of 8 or
# above 128 (--D_ch), held to their plain versions beside the flagship's 64
STEM_ANY_CO = (4, 12, 100, 136, 256)
# K9 dx's, K13's forward's, K1's, K3-dW's, K6's, K7's, K9's forward's (with
# K14) and K9 dW's float32 routes: each planted fault must read at least this
# many times the check's limit
F32_PLANT = 10.0
# K9's float32 Σy and Σy² against float64 sums of the stored y: float32 adds
# in one fixed order, about 55 deep (a thread's 32 outputs, a warp's shuffle
# tree, then the N x tiles partials: 256 threads, a shuffle tree, 8 warps),
# so each sits within 55 x 2^-24 ~ 3.3e-6 of Σ|y| (Σy² for the squares) of
# the exact sum; 1e-5 leaves a factor of three, and a dropped tile's partial
# (1 of 288 or 1152 at the Experiment-1 shapes) reads tens of times it.
K9_SUM_TOL = 1e-5
# The float32 bodies that K9 dx's and K13's forward's redesigns replaced
# (the old csrc/upconv3x3_chw.cu: upconv_dx_kernel, and stem_fwd_kernel of
# the stem's old float32 source), CUDA-graph replay, per call at each timed shape: the
# mean of two runs of f32_route_study.py on that parent tree, taken in turns
# with the redesign's in one call on one NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6)
K9DX_F32_PARENT_MS = {"(8, 52->26, 96x96 -> 192x192)": 0.4037,
                      "(8, 26->13, 192x192 -> 384x384)": 0.4117}
STEM_F32_PARENT_MS = {"(8, 3, 384x384) -> (8, 192, 192, 64)": 0.3110,
                      "ssm (8, 3, 192x192) -> (8, 96, 96, 64)": 0.0824}
# The float32 bodies that K1's and K3-dW's redesigns replaced (the old
# csrc/conv3x3_chw.cu, csrc/conv1x1_chw.cu: conv1x1_dw_kernel), the same
# way (K1 with K5's sums where the path takes them)
K1_F32_PARENT_MS = {"(8, 26->26, 192x192)": 0.2779, "(8, 13->13, 384x384)": 0.2754,
                    "(8, 13->3, 384x384)": 0.1425, "(8, 52->26, 192x192)": 0.5053,
                    "(8, 26->13, 384x384)": 0.5576, "(8, 26->3, 192x192)": 0.0844}
K3DW_F32_PARENT_MS = {"(8, 52->26, 96x96)": 0.0546, "(8, 26->13, 192x192)": 0.0879,
                      "(8, 52->26, 192x192)": 0.2234, "(8, 26->13, 384x384)": 0.3333}
# The float32 bodies that K6's and K7's redesigns replaced (the old
# csrc/conv3x3_chw_bwd.cu: conv3x3_dx_kernel, conv3x3_dw_kernel), the same
# way
K6_F32_PARENT_MS = {"(8, 26->26, 192x192)": 0.5114, "(8, 13->13, 384x384)": 0.5188,
                    "(8, 13->3, 384x384)": 0.3020, "(8, 52->26, 192x192)": 0.9247,
                    "(8, 26->13, 384x384)": 0.9588, "(8, 26->3, 192x192)": 0.1740}
K7_F32_PARENT_MS = {"(8, 26->26, 192x192)": 0.3453, "(8, 13->13, 384x384)": 0.5649,
                    "(8, 13->3, 384x384)": 0.2485, "(8, 52->26, 192x192)": 0.6657,
                    "(8, 26->13, 384x384)": 0.6912, "(8, 26->3, 192x192)": 0.1332}
# The float32 bodies that K9's forward's and K9 dW's redesigns replaced (the
# old csrc/upconv3x3_chw.cu: upconv_fwd_kernel with its atomic sums,
# upconv_dw_kernel with its atomics and the wrapper's fold to 3 x 3), the
# same way, and the graphed float32 steps that ran them (warm wall and device
# busy, ms; cuDNN's TF32 as the train CLI leaves it)
K9_F32_PARENT_MS = {"(8, 52->26, 96x96 -> 192x192)": 0.3973,
                    "(8, 26->13, 192x192 -> 384x384)": 0.4180}
K9DW_F32_PARENT_MS = {"(8, 52->26, 96x96 -> 192x192)": 0.3121,
                      "(8, 26->13, 192x192 -> 384x384)": 0.3926}
F32_STEP_PARENT_MS = {"auto": (22.205, 21.227), "off": (22.881, 22.006), "ssm": (53.546, 52.563)}
# K9/K14's bf16 forward: the same for its planted faults
UP_PLANT = 10.0
# K3's and K3-dW's bf16 routes: the same for their planted faults, each
# against the limit of the check it must fail (K3's y: each output's own
# limit, k3_limits; the sums and dW/db: SUM_TOL of max|ref|)
K3_PLANT = 10.0
# the tensor-core dW's pixel tile (csrc/conv1x1_tc.cu: kDwTP): a planted
# fault drops the last one of each image
DW1X1_TILE = 256
# K9 dW's and K13 dW's bf16 routes: each planted fault must read at least this
# many times the check's limit (SUM_TOL of max|ref|)
DW_PLANT = 10.0


def option_flags(args) -> str:
    """The training options of ``args`` that differ from their defaults,
    as flags (a line's label)."""
    return "".join(f" --{f} {getattr(args, f)}" for f, default in OPTION_DEFAULTS.items()
                   if getattr(args, f) != default)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def route_want(per_kernel: dict, tc: bool) -> dict:
    """The launches by C entry point (ops/kernels.py: ROUTE_LAUNCHES) of
    ``per_kernel`` launches of the ROUTED kernels on one route: the
    tensor-core entry points (``tc``) or the CUDA-core ones, the other
    route's 0 (K1 and K2 share their entry points, as K9 and K14 do)."""
    want = {}
    for k in ROUTED:
        on, off = (TC_ENTRY[k], F32_ROUTE[k][0]) if tc else (F32_ROUTE[k][0], TC_ENTRY[k])
        want[on] = want.get(on, 0) + per_kernel[k]
        want.setdefault(off, 0)
    return want


def fwd_route(label: str, tc: bool, want=None, up_want=None, k3_want=None) -> None:
    """The eval kernels' launches by C entry point since the last call, which
    then start again from 0: the bf16 route's (``tc``) or the float32 one's
    only; K1 / K2 and K3 at least once (or exactly ``want`` and
    ``k3_want``), K9 / K14 exactly ``up_want`` where it is given, K3-dW,
    K9 dW, K13 dW and K13 dx none."""
    from infinite_texture_gans_torch.ops import kernels

    for tag, kernel, need, at_least_one in (("K1 / K2", "conv3x3_chw", want, True),
                                            ("K9 / K14", "upconv3x3_chw", up_want, False),
                                            ("K3", "conv1x1_chw", k3_want, True),
                                            ("K3-dW", "conv1x1_chw_dw", 0, False),
                                            ("K9 dW", "upconv3x3_chw_dw", 0, False),
                                            ("K13 dW", "stem_dw", 0, False),
                                            ("K13 dx", "stem_dx", 0, False)):
        on, off = (TC_ENTRY[kernel], F32_ROUTE[kernel][0])[:: 1 if tc else -1]
        counts = {e: kernels.ROUTE_LAUNCHES[e] for e in (on, off)}
        kernels.ROUTE_LAUNCHES.update(dict.fromkeys(counts, 0))
        print(f"[route] {label}: {tag} launches by entry point {counts}"
              + ("" if need is None else f" (want {need} on {on})"))
        if counts[off] or (at_least_one and not counts[on]) or (
                need is not None and counts[on] != need):
            fail(f"{label}: {tag} took the launches {counts}, not {on}'s only")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def seam_ratio(u8, patch: int) -> float:
    """Seam MSE (width 1) of a uint8 canvas over its adjacent-pixel MSE."""
    import numpy as np

    from infinite_texture_gans_torch.utils.metrics import adjacent_mse_baseline, seam_mse

    imgf = u8.astype(np.float64) / 127.5 - 1.0
    return seam_mse(imgf, patch, width=1) / max(adjacent_mse_baseline(imgf), 1e-12)


def to_u8(x):
    """[-1, 1] tensor -> uint8 numpy with the save mapping."""
    import torch

    return torch.clamp((x.float() * 0.5 + 0.5) * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()


def bound_ms(nbytes: float, flops: float, peak: float, bytes_per_s: float) -> float:
    return max(nbytes / bytes_per_s, flops / peak) * 1e3


def upconv_dx_work(n: int, c: int, co: int, h: int, w: int, es: int) -> tuple[float, float]:
    """K9 dx's (bytes, FLOPs) for x (N, C, H, W) at half resolution, Co
    output channels and ``es``-byte activations: x and g read and dx written
    once, the float32 weights, scale, shift and sums; four phases of 2 x 2
    taps (K9's forward and dW do the same FLOPs)."""
    act = n * h * w
    return (act * (2 * c + 4 * co) * es + (co * c * 9 + co + 2 * c) * 4 + 2 * c * 4,
            2.0 * act * co * c * 16)


def stem_fwd_work(n: int, c: int, h: int, w: int, co: int, es: int) -> tuple[float, float]:
    """K13's forward's (bytes, FLOPs) for x (N, C, H, W) to Co channels in
    ``es``-byte activations: x read and y written once, the float32 weights
    and bias."""
    act = n * (h // 2) * (w // 2)
    return (n * c * h * w + act * co) * es + (co * 16 * c + co) * 4, 2.0 * act * co * 16 * c


def device_ms(fn, iters: int = 20) -> float:
    """Per call, replayed from a CUDA graph of ``iters`` calls: device time
    alone."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k3_limits(x, wt, b, res, ref):
    """Each bf16 K3 output's own limit: one bf16 step of its reference value
    (2^-7 of it, a rounding either way) and a bound on the float32 sums'
    reorder, 4 (C + 2) 2^-24 of the sum of the magnitudes of its terms
    (kernel and plain version add the same exact products of bf16 values,
    the bias and the residual in other orders; the tensor cores'
    accumulation may round toward zero)."""
    import torch
    import torch.nn.functional as F

    co, c = wt.shape[0], x.shape[1]
    w16 = wt.detach().reshape(co, c, 1, 1).to(torch.bfloat16).float().abs()
    mag = F.conv2d(x.float().abs(), w16) + b.to(torch.bfloat16).float().abs().reshape(1, -1, 1, 1)
    if res is not None:
        mag = mag + res.float().abs()
    return 2.0**-7 * ref.float().abs() + 4 * (c + 2) * 2.0**-24 * mag


def kernel_name(name: str) -> str:
    """A profiler event's kernel name without its return type, namespace and
    argument list (``ssm_dw2_f32_kernel``)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def device_busy_ms(prof):
    """Device time by kernel name from a torch.profiler trace:
    ({name: (ms, calls)}, total ms). Ranges that annotate the device
    timeline (``Optimizer.step#Adam.step``) are not device work and are
    left out."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms_, n_ = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms_ + e.time_range.elapsed_us() / 1e3, n_ + 1)
    return by_name, sum(v[0] for v in by_name.values())


@contextlib.contextmanager
def plain_tail():
    """The models' kernel wrappers replaced by their plain versions: the
    comparison run of step parity (the port itself has no such switch)."""
    from infinite_texture_gans_torch.ops import kernels, ssm

    swaps = [(kernels, k, getattr(kernels, plain)) for k, plain in PLAIN_TWINS.items()]
    swaps.append((ssm, "ssm_embed", ssm.ssm_embed_plain))
    saved = [(mod, k, getattr(mod, k)) for mod, k, _ in swaps]
    for mod, k, fn in swaps:
        setattr(mod, k, fn)
    try:
        yield
    finally:
        for mod, k, fn in saved:
            setattr(mod, k, fn)


def parity_inputs(dev, argv):
    """Step parity's flags, real crops and each D iteration's draws (latent,
    maps, the penalty's weights: ``train_step.Draw``), drawn from seed 7 in
    the train loop's order."""
    import torch

    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.data.datasets import DeviceCropSampler, SingleImageDataset
    from infinite_texture_gans_torch.train.train_step import draw_iterations

    args = prepare_parser().parse_args(argv)
    data = SingleImageDataset(args.data_path, args.data_ext, None, args.random_crop, 64)
    gen = torch.Generator(device=dev).manual_seed(7)
    real = DeviceCropSampler(data, dev).sample(gen, args.batch_size)
    return args, real, draw_iterations(gen, args, dev)


def run_step(dev, args, real, draws, sync, patch=contextlib.nullcontext, reference=None):
    """One train step from the fixed state (seed 11) on the given inputs
    (``parity_inputs``), under the context ``patch`` (``plain_tail`` for the
    plain versions).
    ``reference``: a dtype, the step in it on the CPU with every block NHWC
    (``chw_tail='off'``; the kernels' plain versions compute in float32):
    float64 is the exact arithmetic the others are measured against,
    float32 the recipe's own rounding. Returns (losses, G grads, D grads,
    launches), the gradients as float32 on ``dev``."""
    import torch

    from infinite_texture_gans_torch.ops import kernels
    from infinite_texture_gans_torch.train.train_step import (
        create_train_state,
        make_optimizers,
        train_step,
    )

    st = create_train_state(args, 1, "cpu" if reference else dev, seed=11)
    if reference:
        st.G.to(reference)
        st.D.to(reference)
        st.G.dtype = st.D.dtype = reference
        st.G.chw_tail = "off"
        st.opt_G, st.opt_D = make_optimizers(st.G, st.D, args)
        st.ema = {k: v.detach().clone() for k, v in st.G.state_dict().items()}
        cpu = lambda t: None if t is None else t.detach().to("cpu", reference)  # noqa: E731
        real = cpu(real)
        draws = [d._replace(z=cpu(d.z), maps=None if d.maps is None else [cpu(m) for m in d.maps],
                            eps=cpu(d.eps)) for d in draws]
    sync()
    kernels.reset_launches()
    with patch():
        m = train_step(st, real, [d.z for d in draws],
                       None if draws[0].maps is None else [d.maps for d in draws],
                       eps=[d.eps for d in draws], loss_type=args.loss, smooth=args.smooth,
                       gp_weight=args.gp_weight, use_ema=args.ema)
    sync()
    grads = {model: {f"{model}.{n}": p.grad.to(dev, torch.float32)
                     for n, p in module.named_parameters()}
             for model, module in (("G", st.G), ("D", st.D))}
    return ({k: float(v) for k, v in m.items()}, grads["G"], grads["D"], dict(kernels.LAUNCHES))


def leaf_deviations(got, want):
    """{leaf: (max |got - want| over the leaf's largest |want|, norm-relative
    deviation, rounding noise?)}. A rounding-noise leaf (largest |want| below
    NOISE_SHARE of the model's largest gradient: zero in exact arithmetic)
    is measured against that largest instead."""
    top = max(float(r.abs().max()) for r in want.values())
    out = {}
    for name, ref in want.items():
        scale = float(ref.abs().max())
        noise = scale < NOISE_SHARE * top
        diff = got[name] - ref
        out[name] = (float(diff.abs().max()) / (top if noise else scale),
                     float(diff.norm()) / max(float(ref.norm()), 1e-30), noise)
    return out


def step_parity(dev, argv, want_launches, sync, loss_tol=STEP_LOSS_TOL,
                grad_tol=STEP_GRAD_TOL):
    """One fused step from a fixed state with the kernels, and the same step
    with the tail's and the stem's plain versions: the losses and every
    gradient leaf must agree (``loss_tol``; each leaf's largest deviation
    within ``grad_tol`` of its largest value, a rounding-noise leaf within
    NOISE_TOL of the model's largest gradient); the kernel run must launch
    ``want_launches``. Returns {'kernels' | 'plain': (losses, G grads,
    D grads, launches)}."""
    args, real, draws = parity_inputs(dev, argv)
    runs = {"kernels": run_step(dev, args, real, draws, sync),
            "plain": run_step(dev, args, real, draws, sync, plain_tail)}
    (lk, gk, dk, nk), (lp, gp, dp, n_plain) = runs["kernels"], runs["plain"]
    print(f"[step parity] {args.type_norm_G} --fuse_up {args.fuse_up}{option_flags(args)}, "
          f"{args.compute_dtype}, G_ch {args.G_ch}, n_layers_G {args.n_layers_G}, "
          f"D_ch {args.D_ch}, {args.num_images} fakes + {args.batch_size} real "
          f"{args.random_crop}^2 crops; launches with kernels {json.dumps(nk)}")
    if nk != want_launches or any(n_plain.values()):
        fail(f"step parity launches: kernels {nk} (want {want_launches}), plain {n_plain} (want 0)")
    for k, ref in lp.items():
        rel = abs(lk[k] - ref) / max(abs(ref), 1e-30)
        print(f"[step parity] {k}: kernels {lk[k]:.7f} plain {ref:.7f} rel {rel:.3e} "
              f"limit {loss_tol:g}")
        if not (math.isfinite(lk[k]) and rel <= loss_tol):
            fail(f"step parity: {k} {lk[k]} vs plain {ref}")
    for model, got, want in (("G", gk, gp), ("D", dk, dp)):
        devs = leaf_deviations(got, want)
        for name, (share, _, noise) in devs.items():
            if not share <= (NOISE_TOL if noise else grad_tol):
                fail(f"step parity: gradient {name} differs by {share:.3e} of "
                     f"{'the largest gradient' if noise else 'its largest value'}")
        signal = {k: v for k, v in devs.items() if not v[2]}
        worst = max(signal, key=lambda k: signal[k][0])
        worst_norm = max(signal, key=lambda k: signal[k][1])
        print(f"[step parity] {model} gradients, {len(want)} leaves: worst {worst} at "
              f"{signal[worst][0]:.3e} of its largest value (limit {grad_tol:g}); largest "
              f"norm-relative deviation {signal[worst_norm][1]:.3e} ({worst_norm}); "
              f"{len(devs) - len(signal)} rounding-noise leaves within {NOISE_TOL:g} of the "
              "model's largest gradient")
    return runs


def fused_vs_unfused(auto, off) -> None:
    """The fused step (``--fuse_up auto``) against the unfused one, both on
    the kernels, from the same state, crops and latents (``step_parity``'s
    runs): losses within STEP_LOSS_TOL; each gradient leaf's norm-relative
    deviation within max(FUSE_FLOOR, FUSE_FLOOR_SCALE x) the same leaf's
    kernels-vs-plain deviation under ``off``."""
    (la, ga, da, _), (lo, go, do, _), (_, gp, dp, _) = auto["kernels"], off["kernels"], off["plain"]
    for k, ref in lo.items():
        rel = abs(la[k] - ref) / max(abs(ref), 1e-30)
        print(f"[fused vs unfused] {k}: auto {la[k]:.7f} off {ref:.7f} rel {rel:.3e} "
              f"limit {STEP_LOSS_TOL:g}")
        if not rel <= STEP_LOSS_TOL:
            fail(f"fused vs unfused step: {k} {la[k]} vs {ref}")
    for model, fused, unfused, plain in (("G", ga, go, gp), ("D", da, do, dp)):
        top = max(float(r.abs().max()) for r in unfused.values())
        worst, noise = (0.0, "", 0.0, 0.0), 0
        for name, ref in unfused.items():
            if float(ref.abs().max()) < NOISE_SHARE * top:
                noise += 1
                share = float((fused[name] - ref).abs().max()) / top
                if not share <= NOISE_TOL:
                    fail(f"fused vs unfused: noise leaf {name} differs by {share:.3e} of the "
                         f"largest gradient")
                continue
            norm = float(ref.norm()) + 1e-12
            dev_ = float((fused[name] - ref).norm()) / norm
            floor = float((ref - plain[name]).norm()) / norm
            limit = max(FUSE_FLOOR, FUSE_FLOOR_SCALE * floor)
            worst = max(worst, (dev_ / limit, name, dev_, limit))
            if not dev_ <= limit:
                fail(f"fused vs unfused: gradient {name} deviates {dev_:.3e} (norm-relative) "
                     f"> {limit:.3e} (kernels-vs-plain floor {floor:.3e})")
        print(f"[fused vs unfused] {model} gradients, {len(unfused)} leaves ({noise} rounding-noise "
              f"leaves held to {NOISE_TOL:g} of the largest gradient): closest to its limit "
              f"{worst[1]}, norm-relative deviation {worst[2]:.3e} against max({FUSE_FLOOR:g}, "
              f"{FUSE_FLOOR_SCALE:g} x its kernels-vs-plain deviation) = {worst[3]:.3e}")


def train_tensors(st):
    """Every tensor of a train state that a step reads and writes, by name:
    both models' parameters and buffers, both Adam states and the EMA."""
    out = {f"{model}.{k}": v for model, module in (("G", st.G), ("D", st.D))
           for k, v in module.state_dict().items()}
    for model, module, opt in (("G", st.G, st.opt_G), ("D", st.D, st.opt_D)):
        for n, p in module.named_parameters():
            out.update({f"adam.{model}.{n}.{k}": v for k, v in opt.state[p].items()})
    out.update({f"ema.{k}": v for k, v in (st.ema or {}).items()})
    return out


def dispatch_run(dev, args, graphed, sync, start=None, plant=None, axis=None, steps=GRAPH_STEPS,
                 reorder=False):
    """GRAPH_STEPS steps of the train loop's ``StepDispatch`` from the fixed
    state (seed 11) and crop / latent generator (seed 7): eager, or
    ``graphed`` as the train loop runs it (WARMUP_STEPS eager warm-up
    steps on a side stream, then the captured step replayed). Before step
    WARMUP_STEPS + 1 (the first replay) the state and the generator are
    set to ``start`` (another run's ``start``; the f32 warm-up steps
    differ from run to run) in place. ``plant`` 'draws': the generator is
    set back before every later replay, so all replays draw the first one's
    crops and latents; 'eps': the captured step reads the penalty's weights
    from a buffer filled before the capture with the first replay's (its
    draws still made, so the crops and latents stay fresh), so every replay
    reuses them. ``axis``: a rank's data axis (``parallel/mesh.py``): the
    data-parallel step. ``steps``: the steps run. ``reorder``: each step
    takes its crops and latents with the two halves of each batch swapped
    (the same batch in another order). Returns {'start': the
    state and generator state before that step, 'losses': per step,
    'walls': each step's wall in s (its losses read), 'grads1' / 'grads':
    that step's / the last step's gradients by model ({'G': {leaf: grad},
    'D': ...}), 'state': parameters and buffers after the run, 'launches':
    kernel launches, 'routes': the routed kernels' launches by entry
    point}."""
    import torch

    from infinite_texture_gans_torch.data.datasets import prepare_data
    from infinite_texture_gans_torch.ops import kernels, ssm
    from infinite_texture_gans_torch.train.train_loop import make_sampler
    from infinite_texture_gans_torch.train.train_step import (
        WARMUP_STEPS,
        StepDispatch,
        create_train_state,
    )

    st = create_train_state(args, GRAPH_STEPS, dev, seed=11, axis=axis)
    sampler = make_sampler(prepare_data(args), args, dev, 7, GRAPH_STEPS)
    rng = torch.Generator(device=dev).manual_seed(7)
    dispatch = StepDispatch(st, sampler, rng, args, graphed=graphed)
    if reorder:
        draw = dispatch.draw

        def swap(x):
            return None if x is None else torch.cat([x[len(x) // 2:], x[:len(x) // 2]])

        def swapped(rng=None):
            real, draws = draw(rng)
            return swap(real), [d._replace(z=swap(d.z), eps=swap(d.eps)) for d in draws]

        dispatch.draw = swapped
    dispatch.set_lr()
    sync()
    kernels.reset_launches()
    for counter in (kernels.ROUTE_LAUNCHES, ssm.ROUTE_LAUNCHES):
        counter.update(dict.fromkeys(counter, 0))

    def grads():
        return {model: {f"{model}.{n}": p.grad.detach().float().clone()
                        for n, p in module.named_parameters()}
                for model, module in (("G", st.G), ("D", st.D))}

    out = {"losses": [], "walls": []}
    for i in range(steps):
        if i == WARMUP_STEPS:
            sync()
            if start is not None:
                with torch.no_grad():
                    for k, v in train_tensors(st).items():
                        v.copy_(start["tensors"][k])
                rng.set_state(start["rng"])
            out["start"] = {"tensors": {k: v.clone() for k, v in train_tensors(st).items()},
                            "rng": rng.get_state()}
            if plant == "eps":
                plant_stale_eps(dispatch, dev)
        elif plant == "draws" and i > WARMUP_STEPS:
            rng.set_state(out["start"]["rng"])
        t = time.perf_counter()
        out["losses"].append({k: float(v) for k, v in dispatch.step().items()})
        out["walls"].append(time.perf_counter() - t)
        if i == WARMUP_STEPS:
            out["grads1"] = grads()
    sync()
    out["grads"] = grads()
    out["state"] = {f"{model}.{k}": v.detach().clone()
                    for model, module in (("G", st.G), ("D", st.D))
                    for k, v in module.state_dict().items()}
    out["launches"] = dict(kernels.LAUNCHES)
    out["routes"] = {**kernels.ROUTE_LAUNCHES, **ssm.ROUTE_LAUNCHES}
    return out


def plant_stale_eps(dispatch, dev) -> None:
    """The planted fault of ``dispatch_run``'s 'eps': ``dispatch``'s draws
    made while a capture runs hand on, in place of the penalty's weights
    they draw, a buffer filled now with the weights the next step will
    draw (a copy of the generator's state draws them ahead)."""
    import torch

    peek = torch.Generator(device=dev)
    peek.set_state(dispatch.rng.get_state())
    stale = [d.eps.clone() for d in dispatch.draw(peek)[1]]
    draw = dispatch.draw

    def planted(rng=None):
        real, draws = draw(rng)
        if torch.cuda.is_current_stream_capturing():
            draws = [d._replace(eps=e) for d, e in zip(draws, stale)]
        return real, draws

    dispatch.draw = planted


def graph_parity_gap(ref, got, lo, hi, grads):
    """``got``'s run against ``ref``'s (``dispatch_run``) over steps ``lo``
    to ``hi`` - 1 (from 0): (largest loss deviation relative to the
    reference loss, (the largest gradient deviation over its limit under step
    parity's rule, that deviation, its leaf) for the ``grads`` gradients,
    the gradient leaves outside their limits, whether every loss, gradient,
    parameter and buffer is bit-equal)."""
    import torch

    loss_rel = max(abs(g[k] - e[k]) / max(abs(e[k]), 1e-30)
                   for e, g in zip(ref["losses"][lo:hi], got["losses"][lo:hi]) for k in e)
    worst, bad = (0.0, 0.0, ""), []
    for model in ("G", "D"):
        for name, (share, _, noise) in leaf_deviations(got[grads][model],
                                                       ref[grads][model]).items():
            limit = NOISE_TOL if noise else STEP_GRAD_TOL
            worst = max(worst, (share / limit, share, name))
            if not share <= limit:
                bad.append(name)
    bits = (ref["losses"] == got["losses"]
            and all(torch.equal(got["grads"][m][k], v) for m in ref["grads"]
                    for k, v in ref["grads"][m].items())
            and all(torch.equal(got["state"][k], v) for k, v in ref["state"].items()))
    return loss_rel, worst, bad, bits


PLANTS = {"draws": "every replay draws the first replay's crops and latents",
          "eps": "every replay reuses the first replay's penalty weights"}


def graph_parity(dev, label, argv, sync, plant=None, f32_held: bool = True,
                 dtypes=("float32", "bfloat16"), loss_tol: float = STEP_LOSS_TOL) -> None:
    """The train loop's dispatched step, eagerly and as the train loop runs
    it (WARMUP_STEPS eager warm-up steps, then CUDA graph replays), from one
    state and one generator state, GRAPH_STEPS steps each, every run
    starting the first replayed step from the eager run's state:

    - float32, TF32 off: that step's losses within ``loss_tol`` and its
      gradients within step parity's limits (STEP_GRAD_TOL of the
      leaf's largest value; a rounding-noise leaf NOISE_TOL of the model's
      largest gradient); the later steps are reported beside a second
      eager run, since the float32 CUDA-core kernels sum with atomics and
      the training amplifies their order from step to step;
    - bfloat16 (the recipes' dtype, whose kernels sum in a fixed order):
      every loss, the last step's gradients and every parameter and buffer
      bit-equal; with ``plant`` (a key of PLANTS, ``dispatch_run``'s
      faults) the planted run must break that and fail the gates;
    - both: the same launches by kernel and by entry point.

    Returns the eager bf16 run's launches over its GRAPH_STEPS steps.

    ``f32_held=False`` reports the float32 comparison without holding it:
    the zeros path's float32 steps are cuDNN's throughout, whose weight
    gradients two eager runs do not reproduce to step parity's gates at the
    biases of block 3 (on an H100 80GB HBM3 at 700 W, this script's phase 9
    read 4.9e-3 of the leaf's largest value eager against eager).
    ``dtypes``: the dtypes run (phase 11 runs bf16 only)."""
    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.train.train_step import WARMUP_STEPS

    first_replay = WARMUP_STEPS + 1
    for dtype in dtypes:
        args = prepare_parser().parse_args(argv + ["--compute_dtype", dtype, "--device", "cuda"])
        eager = dispatch_run(dev, args, False, sync)
        start = eager["start"]
        runs = {"graphed": dispatch_run(dev, args, True, sync, start)}
        if dtype == "float32":
            runs["eager again"] = dispatch_run(dev, args, False, sync, start)
        elif plant:
            runs[f"planted fault ({PLANTS[plant]})"] = dispatch_run(dev, args, True, sync, start,
                                                                    plant=plant)
        for what, run in runs.items():
            if run["launches"] != eager["launches"] or run["routes"] != eager["routes"]:
                fail(f"{label} {dtype}: {what} launches {run['launches']} {run['routes']} != "
                     f"eager {eager['launches']} {eager['routes']}")
            first = graph_parity_gap(eager, run, WARMUP_STEPS, first_replay, "grads1")
            last = graph_parity_gap(eager, run, WARMUP_STEPS, GRAPH_STEPS, "grads")
            print(f"[graph parity] {label}, {dtype}, {what} vs eager: step {first_replay} (the "
                  f"first replay, from one state) losses max rel {first[0]:.3e} (limit "
                  f"{loss_tol:g}), gradients largest deviation {first[1][1]:.3e} "
                  f"({first[1][2]}), {len(first[2])} leaves over their limits; steps "
                  f"{first_replay}-{GRAPH_STEPS} ({GRAPH_STEPS - WARMUP_STEPS} replays) losses "
                  f"{last[0]:.3e}, last gradients {last[1][1]:.3e} ({last[1][2]}); bit-equal "
                  f"over all {GRAPH_STEPS} steps: {last[3]}")
            passed = first[0] <= loss_tol and not first[2]
            if what.startswith("planted"):
                if last[3] or (passed and last[0] <= loss_tol and not last[2]):
                    fail(f"{label}: the planted fault ({PLANTS[plant]}) passed")
            elif dtype == "bfloat16" and not last[3]:
                fail(f"{label}: the bf16 graphed steps are not bit-equal to the eager ones")
            elif not passed and f32_held:
                fail(f"{label} {dtype}: the {what} step differs from the eager one (losses "
                     f"{first[0]:.3e}, gradients over their limits {first[2]})")
            elif not passed:
                print(f"[graph parity] {label}, {dtype}, {what}: reported, not held "
                      f"(f32_held=False): leaves over step parity's limits {first[2]}")
    print(f"[graph parity] {label}: launches in {GRAPH_STEPS} bf16 steps, graphed as eager: "
          f"{json.dumps(eager['launches'])}")
    return eager["launches"]


def training_run(dev, argv, steps, want_launches, sync, card, out_dir, spd, render=True):
    """``steps`` steps of the train CLI's loop (one epoch) under
    ``--steps_per_dispatch spd`` ('0': the CLI default, on the card replays
    of a captured CUDA graph of the step, as under any K > 1; '1': eager
    per-step dispatch),
    with the exact kernel launches of every step held to ``want_launches``,
    finite losses, moved parameters, the warm step time (the median of the
    WARM_STEPS steps before the traced window), the device busy share of
    the run's last TRACED_STEPS steps (torch.profiler, started and stopped
    between steps), the peak device memory, and (``render``) the written
    checkpoint rendered to a 384^2 canvas by the raster engine. Returns the run's launch counts, its warm
    step time (s), its device busy time per traced step (ms, or None where
    the profiler recorded no device time), its steps' launches by C entry
    point (ops/kernels.py: ROUTE_LAUNCHES, read before the canvas, whose K1
    / K2 launches are checked on their own) and its peak memory (bytes)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.ops import kernels
    from infinite_texture_gans_torch.sampling.infinite import generate_canvas
    from infinite_texture_gans_torch.train import train_loop
    from infinite_texture_gans_torch.train.checkpoint import (
        load_checkpoint,
        load_generator_from_checkpoint,
    )
    from infinite_texture_gans_torch.train.train_step import create_train_state

    args = prepare_parser().parse_args(argv + [
        "--sampling", str(int(argv[argv.index("--batch_size") + 1]) * steps), "--epochs", "1",
        "--saving_rate", "1", "--seed", "5", "--fname", str(out_dir), "--device", dev.type,
        "--steps_per_dispatch", spd])
    form = {"0": "graphed", "1": "eager"}.get(spd, f"graphed, chunks of {spd}")
    zeros = " --padding_mode zeros" if args.padding_mode == "zeros" else ""
    multi = (f" --data multiple_images ({Path(args.data_path).name})"
             if args.data != "single_image" else "")
    label = f"{args.type_norm_G} --fuse_up {args.fuse_up}{zeros}{option_flags(args)}{multi}, {form}"
    step_log = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced = []

    def on_step(epoch, i, metrics):
        losses = {k: float(v) for k, v in metrics.items()}  # synchronises
        now = time.perf_counter()
        step_log.append((now, dict(kernels.LAUNCHES), losses))
        if i == steps - TRACED_STEPS - 1:
            prof.start()
            traced.append(now)
        elif i == steps - 1:
            sync()
            traced.append(time.perf_counter())
            prof.stop()

    sync()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t_train = time.perf_counter()
    state, _, _ = train_loop.train(args, step_callback=on_step)
    sync()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.LAUNCHES)
    print(f"[path train] {steps} {args.compute_dtype} steps ({label}), "
          f"launches {json.dumps(launches)}")
    if len(step_log) != steps:
        fail(f"the train loop ran {len(step_log)} steps, not {steps}")
    prev = {k: 0 for k in launches}
    for i, (_, counts, losses) in enumerate(step_log):
        per_step = {k: counts[k] - prev[k] for k in counts}
        prev = counts
        if per_step != want_launches:
            fail(f"{label}: step {i} launched {per_step}, not {want_launches}")
        if not all(math.isfinite(v) for v in losses.values()):
            fail(f"{label}: step {i} losses {losses} are not finite")
    print(f"[path train] {label}: launches in each of the {steps} steps: "
          f"{json.dumps(want_launches)}")
    print(f"[train] {label}: losses after step 1 {step_log[0][2]}, after step {steps} "
          f"{step_log[-1][2]}")
    init = create_train_state(args, 1, "cpu", seed=args.seed)
    for model, before, after in (("G", init.G, state.G), ("D", init.D, state.D)):
        now = after.state_dict()
        leaves = dict(before.named_parameters())
        still = [k for k, p in leaves.items() if torch.equal(p.detach(), now[k].cpu())]
        print(f"[train] {model}: {len(leaves) - len(still)} of {len(leaves)} parameter leaves "
              f"moved; unchanged: {still}")
        if any(leaves[k].dim() == 4 for k in still):
            fail(f"{model} conv weights did not move: {still}")
    del init, state
    times = [t for t, _, _ in step_log]
    step_s = [b - a for a, b in zip(times[:-1], times[1:])][:-TRACED_STEPS][-WARM_STEPS:]
    warm = statistics.median(step_s)
    print(f"[time] train step ({label}): median of {len(step_s)} steps before the traced window "
          f"{warm * 1e3:.2f} ms ({1.0 / warm:.3f} steps/s), min {min(step_s) * 1e3:.2f} ms, max "
          f"{max(step_s) * 1e3:.2f} ms; the whole run with set-up and checkpoints "
          f"{time.perf_counter() - t_train:.1f} s; peak device memory {peak / 2**30:.3f} GiB "
          f"[{card}]")
    traced_s = traced[1] - traced[0]
    by_name, busy = device_busy_ms(prof)
    per_step = None
    if busy > 0:
        per_step = busy / TRACED_STEPS
        print(f"[trace] {label}: the run's last {TRACED_STEPS} steps, traced wall {traced_s:.4f} s, "
              f"device busy {busy / 1e3:.4f} s ({100 * busy / 1e3 / traced_s:.1f}% of the traced "
              f"wall); {per_step:.2f} ms per step, {100 * per_step / (warm * 1e3):.1f}% of the "
              f"untraced warm step [{card}]")
        for name, (ms_, n_) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
            print(f"[trace]   {ms_ / TRACED_STEPS:9.3f} ms/step {n_ / TRACED_STEPS:6.1f}x  "
                  f"{name[:100]}")
    else:
        print(f"[trace] {label}: train step device time: not measured (no device events recorded)")
    routed = dict(kernels.ROUTE_LAUNCHES)
    kernels.ROUTE_LAUNCHES.update(dict.fromkeys(kernels.ROUTE_LAUNCHES, 0))

    ck = load_checkpoint(str(out_dir / "1_1.ckpt"))
    if ck["meta"]["epoch"] != 1 or int(ck["opt_G"]["0"]["count"]) != steps:
        fail(f"checkpoint epoch {ck['meta']['epoch']}, opt count {ck['opt_G']['0']['count']}")
    if not render:
        return launches, warm, per_step, routed, peak
    trained, _ = load_generator_from_checkpoint(str(out_dir / "1__ema.ckpt"), device=dev)
    canvas = generate_canvas(trained, torch.Generator(device=dev).manual_seed(3), 384, 384,
                             wire="u8")
    print(f"[train] 1_1.ckpt and 1__ema.ckpt written; the EMA generator renders a 384^2 canvas "
          f"{canvas.shape} {canvas.dtype}, std {canvas.std():.3f}")
    if canvas.shape != (1, 384, 384, 3) or canvas.dtype != np.uint8 or not canvas.std() > 0:
        fail(f"canvas from the trained checkpoint: {canvas.shape} {canvas.dtype} std {canvas.std()}")
    fwd_route(f"the {label} checkpoint's 384^2 canvas", tc=args.compute_dtype == "bfloat16")
    return launches, warm, per_step, routed, peak


def generation_phase(dev, gen, args, label, one_pass_want, per_sub, n_sub_want, card, sync,
                     u8_tol=CANVAS_U8_TOL, plant_faults=False):
    """One checkpoint's generator ``gen`` (bf16) through the generation
    paths; an SSM generator's maps are drawn with its latents.

    - float32, 768^2: the one-pass oracle (a main path, its launches held to
      ``one_pass_want``), the raster canvas against it with the trained
      attention gate (printed) and with the gate zeroed (held to CANVAS_TOL);
    - bfloat16, 1024^2 through ``generate_canvas(wire='u8')`` (the main path,
      its launches held to ``per_sub`` for each of ``n_sub_want``
      sub-images), seam ratios and warm walls of seeds 21-24, one traced
      canvas;
    - on seed 21's latents: the seam ratio of the one pass and of sub-images
      without the halo cache, which set the raster's seam limit; then, gate
      zeroed, the bf16 raster held to the bf16 one pass in u8 levels (to
      ``u8_tol``; reported only where it is None);
    - the raster as CUDA graph replays (the default) against its eager form
      (``graphs=False``): the f32 768^2 canvas equal, the bf16 1024^2 u8
      canvas byte-equal, the same launches per canvas (cold: eager warm-up
      rows and the capture of the rest; second: the first row's capture;
      warm: replays only), both forms' cold, second and warm walls and
      traced busy shares; with ``plant_faults`` two planted faults
      (replays without the row's new strip; graphs that do not write the
      halo cache back) must break the byte equality.

    Returns (one-pass launches, raster launches, median warm wall s)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from infinite_texture_gans_torch.config import generator_kwargs
    from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
    from infinite_texture_gans_torch.ops import kernels
    from infinite_texture_gans_torch.sampling.infinite import (
        canvas_geometry,
        generate_canvas,
        generate_one_pass,
    )
    from infinite_texture_gans_torch.sampling.latents import (
        build_maps_full,
        build_z_full,
        slice_sub_maps,
        slice_sub_z,
    )

    P, base, ssm = gen.patch_resolution, gen.base_res, gen.type_norm == "SSM"

    def draw(seed, th, tw):
        """The latents (and maps) ``generate_canvas`` draws from ``seed``."""
        g = torch.Generator(device=dev).manual_seed(seed)
        z = build_z_full(g, 1, gen.z_dim, base, th, tw, device=dev)
        if not ssm:
            return z, None
        return z, build_maps_full(g, 1, gen.map_dim, gen.n_layers_G, base, th, tw, device=dev)

    gen32 = ResidualPatchGenerator(**{**generator_kwargs(args), "dtype": torch.float32})
    gen32.load_state_dict(gen.state_dict(), strict=True)
    gen32 = gen32.to(dev).eval()
    _, _, th, tw = canvas_geometry(768, 768, P, GRID, GRID)
    z, maps = draw(0, th, tw)
    sync()
    kernels.reset_launches()
    kernels.ROUTE_LAUNCHES.update(dict.fromkeys(kernels.ROUTE_LAUNCHES, 0))
    one = generate_one_pass(gen32, z, th, tw, maps_full=maps)
    sync()
    one_launches = dict(kernels.LAUNCHES)
    print(f"[path one_pass {label}] f32 {th}x{tw} patches, launches {json.dumps(one_launches)}")
    fwd_route(f"{label} one pass f32 {th}x{tw} patches", False, one_launches["conv3x3_chw"],
              one_launches["upconv3x3_chw"], one_launches["conv1x1_chw"])
    want = {**dict.fromkeys(kernels.LAUNCHES, 0), **one_pass_want}
    if one_launches != want:
        fail(f"{label} one-pass launches {one_launches} != {want}")
    if not bool(torch.isfinite(one).all()) or one.shape != (1, th * P, tw * P, 3):
        fail(f"{label} one-pass output {tuple(one.shape)} not finite or of the wrong shape")
    graphed768 = generate_canvas(gen32, None, 768, 768, z_full=z, maps_full=maps)
    eager768 = generate_canvas(gen32, None, 768, 768, z_full=z, maps_full=maps, graphs=False)
    n_diff = int(np.count_nonzero(graphed768 != eager768))
    print(f"[graph canvas {label} f32 768^2] graph replays vs eager rows: {n_diff} of "
          f"{graphed768.size} values differ (want 0)")
    if n_diff:
        fail(f"{label}: the graphed f32 768^2 canvas differs from the eager one")
    d = np.abs(graphed768 - one[:, :768, :768].cpu().numpy())
    print(f"[canvas {label} f32 768^2, trained attention gate] raster vs one-pass: max abs "
          f"{d.max():.3e}, mean abs {d.mean():.3e} (the gate spreads sub-image edge padding into "
          "the cached halo: PARITY.md)")
    with torch.no_grad():
        gen32.attention.attn.gamma.zero_()
    one0 = generate_one_pass(gen32, z, th, tw, maps_full=maps)[:, :768, :768].cpu().numpy()
    err0 = float(np.abs(generate_canvas(gen32, None, 768, 768, z_full=z, maps_full=maps)
                        - one0).max())
    print(f"[canvas {label} f32 768^2, gate zeroed] raster vs one-pass: max abs {err0:.3e} limit "
          f"{CANVAS_TOL:.1e} (the engine is exact, K15 giving a sub-image the one pass's bits; "
          "the limit covers cuDNN picking other algorithms for the NHWC blocks on a sub-image "
          "than on the whole canvas)")
    if not err0 <= CANVAS_TOL:
        fail(f"{label} raster canvas differs from the one-pass oracle by {err0}")
    fwd_route(f"{label} f32 768^2 raster canvases and one pass", False)
    del gen32, one, one0

    steps_h, steps_w, th1k, tw1k = canvas_geometry(1024, 1024, P, GRID, GRID)
    n_sub = steps_h * steps_w
    sync()
    kernels.reset_launches()
    t1 = time.perf_counter()
    img = generate_canvas(gen, torch.Generator(device=dev).manual_seed(21), 1024, 1024, wire="u8")
    sync()
    cold_s = time.perf_counter() - t1
    raster_launches = dict(kernels.LAUNCHES)
    print(f"[path raster {label}] bf16 1024^2, {steps_h}x{steps_w} sub-images, launches "
          f"{json.dumps(raster_launches)}")
    fwd_route(f"{label} raster bf16 1024^2", True,
              raster_launches["chw_halo_step"] + raster_launches["conv3x3_chw"],
              raster_launches["chw_upconv_halo_step"] + raster_launches["upconv3x3_chw"],
              raster_launches["conv1x1_chw"])
    want = {**dict.fromkeys(kernels.LAUNCHES, 0), **{k: v * n_sub for k, v in per_sub.items()}}
    if n_sub != n_sub_want or raster_launches != want:
        fail(f"{label} raster launches {raster_launches} != {want} for {n_sub} sub-images")
    # the flagship is trained; the SSM run's 30 steps leave a faint texture
    if img.shape != (1, 1024, 1024, 3) or img.dtype != np.uint8 or not img.std() > (0 if ssm else 1):
        fail(f"{label} canvas {img.shape} {img.dtype} std {img.std()}")
    # the eager form of the same canvas (graphs=False): launches and bytes
    sync()
    kernels.reset_launches()
    t1 = time.perf_counter()
    eager = generate_canvas(gen, torch.Generator(device=dev).manual_seed(21), 1024, 1024,
                            wire="u8", graphs=False)
    sync()
    eager_cold_s = time.perf_counter() - t1
    n_diff = int(np.count_nonzero(eager != img))
    print(f"[graph canvas {label} bf16 1024^2 u8] graph replays vs eager rows: {n_diff} of "
          f"{img.size} values differ (want 0); eager launches {json.dumps(dict(kernels.LAUNCHES))}")
    if n_diff or dict(kernels.LAUNCHES) != want:
        fail(f"{label}: the graphed canvas or its launches differ from the eager one's")
    # a second canvas (seed 25; graphed: the first row's capture), then
    # three warm ones (seeds 22-24; graphed: replays only)
    ratios, walls = [seam_ratio(img, P)], {"graphed": [], "eager": []}
    for form in walls:
        kernels.reset_launches()
        for seed in (25, 22, 23, 24):
            sync()
            t1 = time.perf_counter()
            more = generate_canvas(gen, torch.Generator(device=dev).manual_seed(seed), 1024, 1024,
                                   wire="u8", graphs=form == "graphed")
            sync()
            walls[form].append(time.perf_counter() - t1)
            if form == "graphed" and seed != 25:
                ratios.append(seam_ratio(more, P))
        if dict(kernels.LAUNCHES) != {k: 4 * v for k, v in want.items()}:
            fail(f"{label}: four more {form} canvases launched {dict(kernels.LAUNCHES)}, not "
                 f"four times {want}")
    print(f"[quality] {label} seam ratio 1024^2 (u8 canvas, width 1), seeds 21-24: "
          f"{', '.join(f'{r:.4f}' for r in ratios)} (mean {statistics.mean(ratios):.4f})")
    for form, cold in (("graphed", cold_s), ("eager", eager_cold_s)):
        second, warm = walls[form][0], walls[form][1:]
        print(f"[time] {label} canvas 1024^2 bf16 u8 wall, {form}: cold {cold:.4f} s"
              f"{' (eager warm-up rows, the rest captured)' if form == 'graphed' else ''}, second "
              f"{second:.4f} s{' (the first row captured)' if form == 'graphed' else ''}, warm "
              f"{', '.join(f'{w:.4f}' for w in warm)} s (median {statistics.median(warm):.4f} s) "
              f"[{card}]")
        walls[form] = warm

    # one traced canvas of each form: device busy time by kernel (torch.profiler, CUPTI)
    for form in walls:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sync()
            t1 = time.perf_counter()
            generate_canvas(gen, torch.Generator(device=dev).manual_seed(21), 1024, 1024,
                            wire="u8", graphs=form == "graphed")
            sync()
            traced_s = time.perf_counter() - t1
        by_name, busy = device_busy_ms(prof)
        if busy > 0:
            print(f"[trace] {label} canvas 1024^2 bf16, {form}: traced wall {traced_s:.4f} s, "
                  f"device busy {busy / 1e3:.4f} s ({100 * busy / 1e3 / traced_s:.1f}% of the "
                  f"traced wall) [{card}]")
            for name, (ms_, n_) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
                print(f"[trace]   {ms_:9.3f} ms {n_:6d}x  {name[:110]}")
        else:
            print(f"[trace] {label} canvas, {form}: device time not measured (the profiler "
                  "recorded no device events)")
    if plant_faults:
        raster_faults_caught(dev, gen, eager, sync)

    # seed 21's latents once more, drawn as generate_canvas drew them: the
    # same canvas through the one-pass oracle (no sub-image edges) and with
    # the halo cache left out (a broken halo protocol)
    z21, m21 = draw(21, th1k, tw1k)
    if not np.array_equal(generate_canvas(gen, None, 1024, 1024, z_full=z21, maps_full=m21,
                                          wire="u8"), img):
        fail(f"seed 21's latents do not reproduce the counted {label} canvas")
    one21 = to_u8(generate_one_pass(gen, z21, th1k, tw1k, maps_full=m21)[:, :1024, :1024])
    stride, size = (GRID - 1) * P, GRID * P
    tiles = torch.zeros(1, th1k * P, tw1k * P, 3, device=dev)
    with torch.no_grad():
        for r in range(steps_h):
            for c in range(steps_w):
                sub_maps = slice_sub_maps(m21, r, c, base, GRID, GRID) if ssm else None
                sub, _ = gen(slice_sub_z(z21, r, c, base, GRID, GRID), sub_maps)
                tiles[:, r * stride : r * stride + size, c * stride : c * stride + size] = sub.float()
    r_one, r_broken = seam_ratio(one21, P), seam_ratio(to_u8(tiles[:, :1024, :1024]), P)
    limit = r_one + SEAM_GAP_SHARE * (r_broken - r_one)
    print(f"[quality] {label} seam ratio 1024^2, seed 21's latents: raster {ratios[0]:.4f}, one "
          f"pass {r_one:.4f} (no sub-image edges), sub-images without the halo cache "
          f"{r_broken:.4f} (a broken halo); limit {limit:.4f} ({SEAM_GAP_SHARE:g} of the way from "
          "the one pass to the broken halo)")
    if not ratios[0] <= limit:
        fail(f"{label} seam ratio {ratios[0]} > {limit}: the raster canvas shows sub-image seams")
    del tiles
    with torch.no_grad():
        gen.attention.attn.gamma.zero_()
    one0 = generate_one_pass(gen, z21, th1k, tw1k, maps_full=m21)[:, :1024, :1024]
    raster0 = generate_canvas(gen, None, 1024, 1024, z_full=z21, maps_full=m21, wire="f32")
    err_f = float(np.abs(raster0 - one0.float().cpu().numpy()).max())
    d = np.abs(to_u8(torch.from_numpy(raster0)).astype(np.int16) - to_u8(one0).astype(np.int16))
    print(f"[canvas {label} bf16 1024^2, gate zeroed] raster vs one-pass: max abs {err_f:.3e} on "
          f"[-1, 1]; u8: max {int(d.max())} levels, {np.count_nonzero(d)} of {d.size} values "
          f"differ; limit {'none' if u8_tol is None else f'{u8_tol} levels'} (bf16 ulps from "
          "cuDNN's choices in the NHWC blocks)")
    if u8_tol is not None and not d.max() <= u8_tol:
        fail(f"{label} bf16 raster canvas differs from the one-pass oracle by {d.max()} u8 levels")
    fwd_route(f"{label} bf16 canvases, one pass and sub-images", True)
    return one_launches, raster_launches, statistics.median(walls["graphed"])


def raster_faults_caught(dev, gen, eager, sync) -> None:
    """Two planted faults of the graphed raster must break its byte
    equality with ``eager`` (seed 21's eager 1024^2 u8 canvas): replays
    that run without the row's new latent strip copied in, and graphs
    captured without the halo cache's write-back. The generator's graphs
    are captured anew afterwards."""
    import numpy as np
    import torch

    from infinite_texture_gans_torch.sampling.infinite import RasterRow, generate_canvas

    def render():
        return generate_canvas(gen, torch.Generator(device=dev).manual_seed(21), 1024, 1024,
                               wire="u8")

    load, store = RasterRow.load, RasterRow._store_halo

    def store_outside_capture(self, halo):
        if not torch.cuda.is_current_stream_capturing():
            store(self, halo)

    for fault, attr, planted in (("replays without the row's new strip", "load",
                                  lambda self, strip, maps: None),
                                 ("graphs that do not write the halo cache back", "_store_halo",
                                  store_outside_capture)):
        gen.raster_rows.clear()
        if attr == "load":
            for _ in range(2):  # warm-up rows and captures
                render()
        setattr(RasterRow, attr, planted)
        try:
            if attr == "_store_halo":
                for _ in range(2):  # warm-up rows and captures under the fault
                    render()
            bad = render()  # replays only
        finally:
            RasterRow.load, RasterRow._store_halo = load, store
            gen.raster_rows.clear()
        sync()
        n_diff = int(np.count_nonzero(bad != eager))
        print(f"[graph canvas] planted fault ({fault}): {n_diff} of {eager.size} values differ "
              f"from the eager canvas; caught: {n_diff > 0}")
        if not n_diff:
            fail(f"the planted raster fault ({fault}) passed the byte-equality check")


def fuse_all_vs_unfused(dev, gen_all, args, gen_unfused, sync) -> None:
    """The flagship under --fuse_up all against the unfused engine on the
    same latents, attention gate zeroed in both: float32 768^2 held to the
    reference test's tolerance, bf16 1024^2 reported in u8 levels."""
    import numpy as np
    import torch

    from infinite_texture_gans_torch.config import generator_kwargs
    from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
    from infinite_texture_gans_torch.ops import kernels
    from infinite_texture_gans_torch.sampling.infinite import canvas_geometry, generate_canvas
    from infinite_texture_gans_torch.sampling.latents import build_z_full

    kernels.ROUTE_LAUNCHES.update(dict.fromkeys(kernels.ROUTE_LAUNCHES, 0))
    with torch.no_grad():
        for g in (gen_all, gen_unfused):
            g.attention.attn.gamma.zero_()
    twins = []
    for g in (gen_all, gen_unfused):
        t = ResidualPatchGenerator(**{**generator_kwargs(args), "fuse_up": g.fuse_up,
                                      "dtype": torch.float32})
        t.load_state_dict(g.state_dict(), strict=True)
        twins.append(t.to(dev).eval())
    _, _, th, tw = canvas_geometry(768, 768, gen_all.patch_resolution, GRID, GRID)
    z = build_z_full(torch.Generator(device=dev).manual_seed(5), 1, gen_all.z_dim, gen_all.base_res,
                     th, tw, device=dev)
    fused, unfused = (generate_canvas(t, None, 768, 768, z_full=z) for t in twins)
    sync()
    d = np.abs(fused - unfused)
    excess = float((d - (FUSE_ALL_ATOL + FUSE_ALL_RTOL * np.abs(unfused))).max())
    print(f"[canvas fuse_up all vs unfused, f32 768^2, gate zeroed] max abs {d.max():.3e}, mean abs "
          f"{d.mean():.3e}; limit atol {FUSE_ALL_ATOL:g} + rtol {FUSE_ALL_RTOL:g} (the reference "
          "test's: the combined 2x2 kernels regroup float32 additions)")
    if not excess <= 0:
        fail(f"the --fuse_up all canvas differs from the unfused one by {d.max()} (f32)")
    fwd_route("fuse_up all and unfused f32 768^2 canvases", False)
    del twins
    fused, unfused = (generate_canvas(g, torch.Generator(device=dev).manual_seed(21), 1024, 1024,
                                      wire="u8").astype(np.int16) for g in (gen_all, gen_unfused))
    d = np.abs(fused - unfused)
    print(f"[canvas fuse_up all vs unfused, bf16 1024^2 u8, gate zeroed] max {int(d.max())} levels, "
          f"{np.count_nonzero(d)} of {d.size} values differ (reported: bf16 roundings of "
          "regrouped sums carried through the tail)")
    fwd_route("fuse_up all and unfused bf16 1024^2 canvases", True)


def stream_phase(dev, gen, card, sync) -> None:
    """A STREAM_SIZE^2 bf16 canvas under --fuse_up all through
    ``generate_canvas_streamed`` into a PNG under build/, decoded with zlib
    and held byte-equal to ``generate_canvas(wire='u8')`` of the same seed;
    both walls."""
    import numpy as np
    import torch

    from infinite_texture_gans_torch.ops import kernels
    from infinite_texture_gans_torch.sampling.infinite import generate_canvas
    from infinite_texture_gans_torch.sampling.stream import generate_canvas_streamed, read_png

    kernels.ROUTE_LAUNCHES.update(dict.fromkeys(kernels.ROUTE_LAUNCHES, 0))
    png = ROOT / "build" / "smoke_stream_all.png"
    png.parent.mkdir(exist_ok=True)
    size = STREAM_SIZE
    sync()
    t1 = time.perf_counter()
    generate_canvas_streamed(gen, torch.Generator(device=dev).manual_seed(31), size, size, str(png))
    sync()
    stream_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    mem = generate_canvas(gen, torch.Generator(device=dev).manual_seed(31), size, size, wire="u8")
    sync()
    mem_s = time.perf_counter() - t1
    got = read_png(str(png))
    nbytes = png.stat().st_size
    png.unlink()
    print(f"[stream] fuse_up all {size}^2 bf16: streamed PNG {stream_s:.4f} s wall ({nbytes} bytes, "
          f"encoding included), in-memory u8 canvas {mem_s:.4f} s wall (no encoding) [{card}]")
    if got.shape != mem.shape[1:] or not np.array_equal(got, mem[0]):
        fail(f"the streamed {size}^2 PNG differs from the in-memory u8 canvas")
    print(f"[stream] the decoded PNG equals the in-memory canvas byte for byte ({got.shape})")
    fwd_route(f"fuse_up all streamed and in-memory bf16 {size}^2 canvases", True)


def resume_phase(dev, sync, card) -> None:
    """Phase 8: resume at full width, graphed, through the train CLI's
    ``train``. A 2-epoch leg without ``--seed`` (it draws one), two
    uninterrupted RESUME_EPOCHS-epoch runs with that seed, then a fresh
    ``train`` resumed from the leg's ``2_2.ckpt`` without ``--seed``. Fails
    unless the resumed run restored the leg's seed; its loss histories and
    final G, D, Adam and EMA tensors equal the uninterrupted run's (bit for
    bit where the two uninterrupted runs are bit-equal, else within
    STEP_GRAD_TOL of each tensor's largest value and of each loss); its
    launches equal the uninterrupted run's over the same epochs; and a
    planted fault (the resume without the per-epoch reseed) fails that same
    check. Reports the epoch walls with a save in flight and without, and
    each save's time on the worker thread and at submit."""
    import shutil

    import torch

    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.ops import kernels, ssm
    from infinite_texture_gans_torch.train import train_loop
    from infinite_texture_gans_torch.train.checkpoint import AsyncCheckpointer, load_checkpoint

    root = ROOT / "build" / "smoke_resume"
    shutil.rmtree(root, ignore_errors=True)
    counters = (kernels.LAUNCHES, kernels.ROUTE_LAUNCHES, ssm.ROUTE_LAUNCHES)

    class TimedSaver(AsyncCheckpointer):
        """The loop's checkpointer, timing each submit on the main thread."""

        def __init__(self):
            super().__init__()
            self.submit_seconds = []

        def submit(self, path, payload):
            t = time.perf_counter()
            super().submit(path, payload)
            self.submit_seconds.append(time.perf_counter() - t)

    def run(name, epochs, seed=None, resume=None):
        argv = EXP1_ARGS + ["--fuse_up", "auto", "--sampling", str(EXP1_BATCH * RESUME_STEPS),
                            "--saving_rate", "2", "--epochs", str(epochs), "--device", dev.type,
                            "--fname", str(root / name)]
        argv += (["--seed", str(seed)] if seed is not None else []) + (
            ["--resume", resume] if resume else [])
        args = prepare_parser().parse_args(argv)
        marks, saver = [], TimedSaver()

        def on_step(epoch, i, m):
            float(m["g_loss"])  # synchronises
            marks.append((epoch, time.perf_counter(), [dict(c) for c in counters]))

        sync()
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        t0 = time.perf_counter()
        state, g, d = train_loop.train(args, step_callback=on_step, saver=saver)
        sync()
        return {"args": args, "tensors": train_tensors(state), "losses": (g, d),
                "marks": marks, "saver": saver, "t0": t0, "wall": time.perf_counter() - t0}

    def gap(ref, got):
        """(bit-equal, (largest deviation of a tensor over its largest value,
        its name), largest loss deviation over the loss)."""
        bits = ref["losses"] == got["losses"] and all(
            torch.equal(got["tensors"][k], v) for k, v in ref["tensors"].items())
        worst = max((float((got["tensors"][k].float() - v.float()).abs().max())
                     / max(float(v.float().abs().max()), 1e-30), k)
                    for k, v in ref["tensors"].items())
        loss = max(abs(b - a) / max(abs(a), 1e-30)
                   for la, lb in zip(ref["losses"], got["losses"]) for a, b in zip(la, lb))
        return bits, worst, loss

    half = run("half", RESUME_EPOCHS // 2)
    leg = root / "half" / f"{RESUME_EPOCHS // 2}_{RESUME_EPOCHS // 2}.ckpt"
    drawn = load_checkpoint(str(leg))["meta"]["seed"]
    full = run("full", RESUME_EPOCHS, drawn)
    again = run("full_again", RESUME_EPOCHS, drawn)
    resumed = run("resumed", RESUME_EPOCHS, resume=str(leg))
    print(f"[resume] the first leg drew seed {drawn}; the resumed run (no --seed) restored "
          f"{resumed['args'].seed}")
    if resumed["args"].seed != drawn:
        fail(f"the resumed run took seed {resumed['args'].seed}, not the first leg's {drawn}")
    keep = train_loop.reseed_epoch
    train_loop.reseed_epoch = lambda rng, seed, epoch: None
    try:
        planted = run("planted", RESUME_EPOCHS, resume=str(leg))
    finally:
        train_loop.reseed_epoch = keep

    bits_mode, twin, twin_loss = gap(full, again)
    rule = "bit-equal" if bits_mode else (f"within {STEP_GRAD_TOL:g} of each tensor's largest "
                                          "value and of each loss")
    print(f"[resume] two uninterrupted runs: bit-equal {bits_mode}, largest tensor deviation "
          f"{twin[0]:.3e} ({twin[1]}), losses {twin_loss:.3e}; the resume is held {rule}")
    for what, got in (("resumed", resumed), ("planted fault (no per-epoch reseed)", planted)):
        bits, worst, loss = gap(full, got)
        held = bits if bits_mode else (worst[0] <= STEP_GRAD_TOL and loss <= STEP_GRAD_TOL)
        print(f"[resume] {what} vs uninterrupted over {RESUME_EPOCHS} epochs of {RESUME_STEPS} "
              f"steps: bit-equal {bits}, largest tensor deviation {worst[0]:.3e} ({worst[1]}), "
              f"losses {loss:.3e}; held: {held}")
        print(f"[resume]   G losses {got['losses'][0]}")
        if what == "resumed" and not held:
            fail(f"the resumed run differs from the uninterrupted one ({rule} required)")
        if what != "resumed" and held:
            fail("the planted fault (a resume without the per-epoch reseed) passed")
    print(f"[resume]   uninterrupted G losses {full['losses'][0]}")
    at_half = [m for m in full["marks"] if m[0] == RESUME_EPOCHS // 2 - 1][-1][2]
    last = full["marks"][-1][2]
    want = [{k: c[k] - h[k] for k in c} for c, h in zip(last, at_half)]
    if resumed["marks"][-1][2] != want:
        fail(f"the resumed run launched {resumed['marks'][-1][2]}, not the uninterrupted run's "
             f"{want} over the same epochs")
    print(f"[resume] launches of the resumed {RESUME_EPOCHS // 2} epochs equal the uninterrupted "
          f"run's over them: {json.dumps(want[0])}")

    for label, r in (("uninterrupted", full), ("uninterrupted, again", again)):
        ends = {e: t for e, t, _ in r["marks"]}  # each epoch's last step
        steps = {e: [] for e in ends}
        prev = None
        for e, t, _ in r["marks"]:
            if prev is not None:
                steps[e].append(t - prev)
            prev = t
        walls = {e: ends[e] - ends[e - 1] for e in ends if e > 0}
        saves = ", ".join(f"{Path(p).name} {w:.3f} s" for p, w in r["saver"].save_seconds)
        submits = ", ".join(f"{w * 1e3:.2f} ms" for w in r["saver"].submit_seconds)
        print(f"[resume] {label}: epoch walls (from the previous epoch's last step; steps synced "
              f"one by one) " + ", ".join(f"epoch {e + 1} {w * 1e3:.2f} ms" for e, w in walls.items())
              + f"; epoch 2 has no save in flight, epoch 3 starts with the {RESUME_EPOCHS}_2.ckpt "
              f"save submitted; median step of epoch 2 "
              f"{statistics.median(steps[1]) * 1e3:.2f} ms, of epoch 3 "
              f"{statistics.median(steps[2]) * 1e3:.2f} ms [{card}]")
        print(f"[resume] {label}: saves on the worker thread: {saves}; submits on the main thread "
              f"(clone + event): {submits}; the whole run {r['wall']:.2f} s [{card}]")
    shutil.rmtree(root, ignore_errors=True)


def zeros_phase(dev, sync, card) -> None:
    """Phase 9: the Experiment-1 recipe under the parsers' default
    ``--padding_mode`` (zeros). The graphed steps against eager ones from one
    state (``graph_parity``: bf16 bit-equal; f32 reported, since two eager
    f32 runs of this all-cuDNN step differ too), then 30 bf16 steps through ``train``, graphed; then the sample
    CLI on its EMA checkpoint: a ZEROS_CANVAS^2 canvas as one pass and a
    ZEROS_TILED^2 one with ``--tiles``, each timed through the CLI and warm
    through ``sample_from_gen``; then, in f32 at ZEROS_F32^2, the tiled
    canvas's first tile against the one pass (TILE_TOL). Fails if any of it
    launches one of the port's kernels (the reference's gate keeps this path
    off its Pallas kernels), if a loss is not finite, or if a check fails."""
    import numpy as np
    import torch

    from infinite_texture_gans_torch import sample
    from infinite_texture_gans_torch.ops import kernels, ssm
    from infinite_texture_gans_torch.sampling.stream import read_png
    from infinite_texture_gans_torch.sampling.tiled import sample_from_gen, tile_process
    from infinite_texture_gans_torch.train.checkpoint import (
        load_checkpoint,
        load_generator_from_checkpoint,
    )

    counters = (kernels.LAUNCHES, kernels.ROUTE_LAUNCHES, ssm.ROUTE_LAUNCHES)

    def reset():
        for c in counters:
            c.update(dict.fromkeys(c, 0))

    def no_launches(what, extra=()):
        got = {k: v for c in (*counters, *extra) for k, v in c.items() if v}
        print(f"[zeros] {what}: the port's kernel launches {got or 0}")
        if got:
            fail(f"{what} launched the port's kernels {got}; the zeros path runs none")

    reset()
    graph_parity(dev, "train zeros", ZEROS_ARGS, sync, f32_held=False)
    no_launches("graph parity (f32 and bf16, eager and graphed)")
    out_dir = ROOT / "build" / "smoke_train_zeros"
    reset()
    _, warm, busy, routed, peak = training_run(dev, ZEROS_ARGS, TRAIN_STEPS,
                                               dict.fromkeys(KERNELS, 0), sync, card, out_dir,
                                               "0", render=False)
    no_launches(f"{TRAIN_STEPS} graphed bf16 steps", (routed,))
    share = f"{busy:.2f} ms, {100 * busy / (warm * 1e3):.1f}%" if busy else "not measured"
    print(f"[zeros] train zeros, graphed: warm step {warm * 1e3:.2f} ms ({1.0 / warm:.3f} "
          f"steps/s), device busy per traced step {share}, peak device memory "
          f"{peak / 2**30:.3f} GiB [{card}]")

    ema = out_dir / "1__ema.ckpt"
    gen, args = load_generator_from_checkpoint(str(ema), device=dev)
    scale = 2 ** (gen.n_layers_G - 1)
    if (args.padding_mode, gen.dtype, gen.emits_chw()) != ("zeros", torch.bfloat16, False):
        fail(f"the zeros run's generator: {args.padding_mode} {gen.dtype} chw {gen.emits_chw()}")
    for size, tiles in ((ZEROS_CANVAS, False), (ZEROS_TILED, True)):
        label = f"{size}^2 {'--tiles' if tiles else 'one pass'}"
        png = out_dir / f"zeros_{size}{'_tiles' if tiles else ''}.png"
        reset()
        sync()
        t = time.perf_counter()
        sample.main(["--model_path", str(ema), "--output_resolution_height", str(size),
                     "--output_resolution_width", str(size), "--output_name", png.name,
                     "--seed", "1", "--device", dev.type] + (["--tiles"] if tiles else []))
        sync()
        cli = time.perf_counter() - t
        if not png.exists() or png.stat().st_size == 0:
            fail(f"the sample CLI wrote no {png}")
        if size == ZEROS_CANVAS and read_png(str(png)).shape != (size, size, 3):
            fail(f"the {label} PNG is not {size}^2 RGB")
        nbytes = png.stat().st_size
        png.unlink()
        walls = []
        for _ in range(3):
            sync()
            t = time.perf_counter()
            img = sample_from_gen(gen, torch.Generator(device=dev).manual_seed(1),
                                  base_res=size // scale, tiles=tiles)
            sync()
            walls.append(time.perf_counter() - t)
        if img.shape != (1, size, size, 3) or not bool(torch.isfinite(img).all()) or not float(
                img.abs().max()) <= 1.0 or not float(img.std()) > 0:
            fail(f"the {label} canvas: {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")
        no_launches(f"the {label} canvases")
        print(f"[zeros] canvas {label}, bf16: through the sample CLI {cli:.4f} s wall (checkpoint "
              f"load and {nbytes}-byte PNG included); the engine warm {statistics.median(walls):.4f} "
              f"s (median of 3: {', '.join(f'{w:.4f}' for w in walls)}) [{card}]")
    del gen, img

    ck = load_checkpoint(str(ema))
    ck["meta"]["args"]["compute_dtype"] = "float32"
    gen32, _ = load_generator_from_checkpoint(str(ema), device=dev, ckpt=ck)
    lat = ZEROS_F32 // scale
    z = torch.randn((1, lat, lat, gen32.z_dim), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    reset()
    with torch.no_grad():
        one = gen32(z)[0].float()
    tiled = tile_process(gen32, z, scale=scale, tile_size=32, tile_pad=16)
    no_launches(f"the f32 {ZEROS_F32}^2 one pass and tiled canvas")
    n = 16 * scale  # the first tile's interior (tests/test_tiled.py:32)
    a, b = one[:, :n, :n], tiled[:, :n, :n]
    err = float((a - b).abs().max())
    over = float(((a - b).abs() - TILE_TOL * b.abs()).max())
    print(f"[zeros] f32 {ZEROS_F32}^2: the tiled canvas's first tile ({n}^2) against the one pass "
          f"max abs err {err:.3e} (limit {TILE_TOL:g} + {TILE_TOL:g} x |ref|); the whole canvas "
          f"max abs err {float((one - tiled).abs().max()):.3e} (the tiles' seams)")
    if not over <= TILE_TOL:
        fail(f"the tiled {ZEROS_F32}^2 canvas's first tile differs from the one pass by {err}")


def option_launches(disc_iters: int, wire: bool) -> dict:
    """The exact kernel launches of one Experiment-1 ``--fuse_up auto`` step
    with ``disc_iters`` D iterations: G's forward kernels (K1 at conv2 and
    the final conv, K9, the half-res shortcut K3, K10) once per D
    iteration, its backward once; with the channels-major G->D wire (not
    under ``--loss wgan``) K13's forward once per D iteration and once for
    the G pass, its dW once per D iteration and its dx once."""
    want = dict(STEP_LAUNCHES["auto"])
    for name, per_forward in (("conv3x3_chw", 3), ("upconv3x3_chw", 2), ("conv1x1_chw", 2),
                              ("upsample2_chw_add", 2)):
        want[name] += (disc_iters - 1) * per_forward
    want.update(stem_fwd=disc_iters + 1, stem_dw=disc_iters, stem_dx=1) if wire else want.update(
        stem_fwd=0, stem_dw=0, stem_dx=0)
    return want


def options_phase(dev, sync, card) -> None:
    """Phase 10: the training options (OPTION_RECIPES) at full Experiment-1
    width under ``--fuse_up auto``. Each recipe's graphed steps against eager
    ones (``graph_parity``: bf16 bit-equal, the launches of GRAPH_STEPS
    steps held to ``option_launches``; f32 held to step parity's gates but
    for F32_REPORTED), with a planted fault under WGAN-GP (every replay reuses
    the first replay's penalty weights). The f32 WGAN-GP step against its
    plain versions (``step_parity`` at WGAN_STEP_LOSS_TOL and
    WGAN_STEP_GRAD_TOL; the CUDA-core routes
    only, no K13). TRAIN_STEPS graphed bf16 steps through ``train`` for
    WGAN-GP and SN in G: exact launches per step (the tensor-core routes
    only), warm step wall, busy share, peak memory. The SN run's EMA
    checkpoint, rebuilt SN off as the reference rebuilds it, rendered by
    the sample CLI to an OPTION_CANVAS^2 PNG, its launches held to phase
    4's per canvas."""
    from infinite_texture_gans_torch import sample
    from infinite_texture_gans_torch.ops import kernels, ssm
    from infinite_texture_gans_torch.sampling.stream import read_png

    base = EXP1_ARGS + ["--fuse_up", "auto"]
    wants = {"wgan": option_launches(5, wire=False), "batch": option_launches(2, wire=True),
             "instance": option_launches(1, wire=True), "sn": dict.fromkeys(KERNELS, 0)}
    counters = (kernels.LAUNCHES, kernels.ROUTE_LAUNCHES, ssm.ROUTE_LAUNCHES)

    def reset():
        for c in counters:
            c.update(dict.fromkeys(c, 0))

    for name, argv in OPTION_RECIPES.items():
        label = f"train {' '.join(argv)}"
        got = graph_parity(dev, label, base + argv, sync, plant="eps" if name == "wgan" else None,
                           f32_held=name not in F32_REPORTED,
                           loss_tol=WGAN_STEP_LOSS_TOL if name == "wgan" else STEP_LOSS_TOL)
        want = {k: GRAPH_STEPS * v for k, v in wants[name].items()}
        if got != want:
            fail(f"{label}: {GRAPH_STEPS} steps launched {got}, not {want}")
        print(f"[options] {label}: launches per step {json.dumps(wants[name])}")

    reset()
    argv = base + OPTION_RECIPES["wgan"]
    step_parity(dev, argv + ["--compute_dtype", "float32"], wants["wgan"], sync,
                WGAN_STEP_LOSS_TOL, WGAN_STEP_GRAD_TOL)
    want = route_want(wants["wgan"], tc=False)
    if dict(kernels.ROUTE_LAUNCHES) != {**dict.fromkeys(kernels.ROUTE_LAUNCHES, 0), **want}:
        fail(f"the f32 WGAN-GP step parity took the routed kernels' launches "
             f"{dict(kernels.ROUTE_LAUNCHES)}, not {want}")
    print(f"[route] f32 step parity, train {' '.join(OPTION_RECIPES['wgan'])}: the routed "
          f"kernels' launches by entry point {dict(kernels.ROUTE_LAUNCHES)}")

    for name in ("wgan", "sn"):
        reset()
        out_dir = ROOT / "build" / f"smoke_train_{name}"
        _, warm, busy, routed, peak = training_run(dev, base + OPTION_RECIPES[name], TRAIN_STEPS,
                                                   wants[name], sync, card, out_dir, "0",
                                                   render=False)
        want = route_want({k: TRAIN_STEPS * v for k, v in wants[name].items()}, tc=True)
        if routed != {**dict.fromkeys(routed, 0), **want}:
            fail(f"the bf16 {name} run took the routed kernels' launches {routed}, not {want}")
        share = f"{busy:.2f} ms, {100 * busy / (warm * 1e3):.1f}%" if busy else "not measured"
        print(f"[options] train {' '.join(OPTION_RECIPES[name])}, graphed: warm step "
              f"{warm * 1e3:.2f} ms ({1.0 / warm:.3f} steps/s), device busy per traced step "
              f"{share}, peak device memory {peak / 2**30:.3f} GiB [{card}]")

    ema = ROOT / "build" / "smoke_train_sn" / "1__ema.ckpt"
    png = ema.parent / f"sn_{OPTION_CANVAS}.png"
    reset()
    sync()
    t = time.perf_counter()
    sample.main(["--model_path", str(ema), "--output_resolution_height", str(OPTION_CANVAS),
                 "--output_resolution_width", str(OPTION_CANVAS), "--output_name", png.name,
                 "--seed", "1", "--device", dev.type])
    sync()
    wall = time.perf_counter() - t
    img = read_png(str(png))
    if img.shape != (OPTION_CANVAS, OPTION_CANVAS, 3) or not img.std() > 0:
        fail(f"the SN checkpoint's canvas: {img.shape}, std {img.std()}")
    want = {**dict.fromkeys(KERNELS, 0), **{k: 16 * v for k, v in GEN_PER_SUB["flagship"].items()}}
    if dict(kernels.LAUNCHES) != want:
        fail(f"the SN checkpoint's {OPTION_CANVAS}^2 canvas launched {dict(kernels.LAUNCHES)}, "
             f"not {want}")
    print(f"[options] the SN run's {ema.name} (rebuilt SN off) through the sample CLI: a "
          f"{OPTION_CANVAS}^2 PNG, std {img.std():.3f}, {wall:.4f} s wall (load and PNG included); "
          f"launches {json.dumps(want)}, phase 4's per canvas [{card}]")
    fwd_route(f"the SN checkpoint's {OPTION_CANVAS}^2 canvas", tc=True,
              want=16 * GEN_PER_SUB["flagship"]["chw_halo_step"],
              k3_want=16 * GEN_PER_SUB["flagship"]["conv1x1_chw"])
    png.unlink()


def multi_phase(dev, sync, card, auto) -> None:
    """Phase 11: multi-image training. ``auto``: phase 6's graphed Exp-1
    ``auto`` run in this call, (launches, warm s, busy ms, peak bytes),
    printed beside the multi-image run.

    - The README's multi-image recipe (MULTI_ARGS: ``datasets/multi``, the
      three bundled textures stacked on the card) at full Exp-1 width, 30
      graphed bf16 steps through ``train``: every step's launches held to
      ``auto``'s, the tensor-core routes, the warm step wall, the traced
      busy share and the peak memory.
    - The same recipe's steps as the loop runs them (``graph_parity``, bf16:
      graphed bit-equal to eager).
    - The stack of the three textures with every value raised to >= 1: no
      drawn batch holds an exact -1 (padding is never read).
    - MULTI8 images cut from the textures (crops and flips) with a cap that
      keeps 2 resident: 30 graphed steps in chunks of MULTI8_SPD (a window
      swapped before each chunk) against the same images all resident, the
      windows each chunk used, each swap's host time and the epoch's
      residency spread (at most one window, the reference's
      tests/test_train.py:1104); then a 2 + 2-epoch resume in chunks of 2
      bit-equal to 4 uninterrupted epochs."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.data import datasets as D
    from infinite_texture_gans_torch.train import train_loop

    root = ROOT / "build" / "smoke_multi"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    recipe = MULTI_ARGS + ["--fuse_up", "auto"]
    auto_launches = STEP_LAUNCHES["auto"]
    _, warm, busy, routed, peak = training_run(
        dev, recipe, TRAIN_STEPS, auto_launches, sync, card, root / "recipe", "0", render=False)
    want = route_want({k: TRAIN_STEPS * v for k, v in STEP_LAUNCHES["auto"].items()}, tc=True)
    if routed != want:
        fail(f"the multi-image run took the routed kernels' launches {routed}, not {want}")
    share = lambda b, w: f"{b:.2f} ms ({100 * b / (w * 1e3):.1f}%)" if b else "not measured"  # noqa: E731
    print(f"[multi] README recipe, datasets/multi (3 images stacked on the card), 30 graphed bf16 "
          f"steps: warm step {warm * 1e3:.2f} ms, busy {share(busy, warm)}, peak "
          f"{peak / 2**30:.3f} GiB; the single-image Exp-1 auto run of phase 6 in this call: "
          f"{auto[1] * 1e3:.2f} ms, busy {share(auto[2], auto[1])}, peak {auto[3] / 2**30:.3f} GiB; "
          f"multi / single warm step {warm / auto[1]:.4f} [{card}] (the JAX package reports its "
          "two steps within 0.1% of each other on a TPU, docs/PERF.md:622-633)")
    graph_parity(dev, "multi-image --fuse_up auto", recipe, sync, dtypes=("bfloat16",))

    srcs = {f.name: np.asarray(Image.open(f).convert("RGB"))
            for f in sorted((ROOT / "datasets" / "multi").iterdir())}
    bright = root / "bright"
    bright.mkdir()
    for f, a in srcs.items():
        Image.fromarray(np.maximum(a, 1)).save(bright / f"{Path(f).stem}.png")
    sampler = D.DeviceMultiImageSampler(D.MultipleImagesDataset(str(bright), "png",
                                                                random_crop=192), dev)
    g = torch.Generator(device=dev).manual_seed(3)
    lows = torch.stack([sampler.sample(g, EXP1_BATCH).min() for _ in range(MULTI_PAD_DRAWS)])
    low = float(lows.min())
    print(f"[multi] the stack of the three textures raised to >= 1: {tuple(sampler.imgs.shape)} "
          f"uint8, valid extents h {sampler.h_valid.tolist()} w {sampler.w_valid.tolist()}; "
          f"{MULTI_PAD_DRAWS} batches of {EXP1_BATCH} 192^2 crops, lowest value {low:.6f} (an "
          "exact -1 would be padding)")
    if not low > -1.0:
        fail("a drawn multi-image batch read the stack's zero padding")

    eight = root / "eight"
    eight.mkdir()
    h, w = MULTI8_SIZE
    for i in range(MULTI8):
        a = list(srcs.values())[i % 3]
        top, left = (i * 23) % (a.shape[0] - h + 1), (i * 61) % (a.shape[1] - w + 1)
        c = a[top : top + h, left : left + w]
        c = c[:, ::-1] if i >= 3 else c
        c = c[::-1] if i >= 6 else c
        Image.fromarray(np.ascontiguousarray(c)).save(eight / f"{i}.png")
    cap = h * w * 3 / 2**20 * 4.5  # two windows of two images fit
    argv8 = ["--data", "multiple_images", "--data_path", str(eight), "--data_ext", "png"] + \
        recipe[4:]
    resident = training_run(dev, argv8, TRAIN_STEPS, auto_launches, sync, card,
                            root / "resident8", MULTI8_SPD, render=False)
    windows, swaps = [], []
    swap = D.RotatingMultiImageSampler.next_window

    def timed(self):
        t = time.perf_counter()
        out = swap(self)
        swaps.append(time.perf_counter() - t)
        windows.append(out.tolist())
        return out

    keep = D.DeviceMultiImageSampler.MAX_DEVICE_MB
    D.DeviceMultiImageSampler.MAX_DEVICE_MB = cap
    D.RotatingMultiImageSampler.next_window = timed
    try:
        rotating = training_run(dev, argv8, TRAIN_STEPS, auto_launches, sync, card,
                                root / "rotating8", MULTI8_SPD, render=False)
        counts = np.bincount(np.concatenate(windows), minlength=MULTI8)
        print(f"[multi] rotating subset: {MULTI8} images of {h}x{w}, cap {cap:.3f} MB (2 "
              f"resident), {len(windows)} chunks of {MULTI8_SPD} steps, windows {windows}; "
              f"residency per image {counts.tolist()} (spread {counts.max() - counts.min()}, "
              f"limit 1); swap host time per chunk {', '.join(f'{t * 1e3:.3f}' for t in swaps)} ms "
              f"[{card}]")
        print(f"[multi] rotating vs all resident, the same {MULTI8} images, chunks of "
              f"{MULTI8_SPD}: warm step {rotating[1] * 1e3:.2f} ms vs {resident[1] * 1e3:.2f} ms, "
              f"busy {share(rotating[2], rotating[1])} vs {share(resident[2], resident[1])}, peak "
              f"{rotating[4] / 2**30:.3f} vs {resident[4] / 2**30:.3f} GiB [{card}]")
        if len(windows) != TRAIN_STEPS // int(MULTI8_SPD) or counts.max() - counts.min() > 1:
            fail(f"the rotating windows {windows} break the epoch's residency bound")

        def run(name, epochs, resume=None):
            argv = argv8 + ["--sampling", str(EXP1_BATCH * RESUME_STEPS), "--saving_rate", "2",
                            "--epochs", str(epochs), "--device", dev.type, "--seed", "17",
                            "--fname", str(root / name), "--steps_per_dispatch",
                            MULTI_RESUME_SPD] + (["--resume", resume] if resume else [])
            windows.clear()
            state, gl, dl = train_loop.train(prepare_parser().parse_args(argv))
            sync()
            return train_tensors(state), (gl, dl), list(windows)

        full = run("full", RESUME_EPOCHS)
        run("half", RESUME_EPOCHS // 2)
        resumed = run("resumed", RESUME_EPOCHS, str(root / "half" / "2_2.ckpt"))
    finally:
        D.DeviceMultiImageSampler.MAX_DEVICE_MB = keep
        D.RotatingMultiImageSampler.next_window = swap
    bits = full[1] == resumed[1] and all(torch.equal(resumed[0][k], v) for k, v in full[0].items())
    print(f"[multi] rotating resume, {RESUME_EPOCHS // 2} + {RESUME_EPOCHS // 2} epochs of "
          f"{RESUME_STEPS} steps in chunks of {MULTI_RESUME_SPD} against {RESUME_EPOCHS} "
          f"uninterrupted: windows {resumed[2]} against the last {len(resumed[2])} of "
          f"{full[2]}; losses and every tensor bit-equal: {bits}")
    if not bits or resumed[2] != full[2][-len(resumed[2]):]:
        fail("the resumed rotating-subset run differs from the uninterrupted one")
    shutil.rmtree(root, ignore_errors=True)


def traced_canvas(fn, sync):
    """``fn()`` (a canvas) under torch.profiler: (wall s, device busy ms,
    {kernel name: (ms, calls)})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t
    by_name, busy = device_busy_ms(prof)
    return wall, busy, by_name


def diag_gates(dev, gen, args, label, sync, path_kernels) -> None:
    """The batched-diagonal engine against the raster for one checkpoint's
    bf16 generator ``gen`` (DIAG_GATE_LANES lanes, one canvas: N = lanes):

    - f32 768^2 (TF32 off, lanes None) within CANVAS_TOL of the raster;
    - bf16 1024^2 u8 at lanes 1 byte-equal to the raster, with the raster's
      launches;
    - bf16 1024^2 u8 at DIAG_GATE_LANES byte-equal to canvas 0 of the
      raster run with DIAG_GATE_LANES canvases (canvas 0 on the same
      latents): every call at the same batch, so cuDNN picks the same
      algorithms; against the one-canvas raster reported, beside that
      raster's own canvas 0 against it (cuDNN's choices at batch 4 alone:
      on an H100 80GB HBM3 at 700 W the first run of this phase read 8 u8
      levels on 4.07% of the flagship's values at lanes 4, from block 2's
      first cuDNN conv on, which rounds one bf16 ulp apart at batch 4);
    - ``path_kernels`` launched in the lanes-4 canvas."""
    import numpy as np
    import torch

    from infinite_texture_gans_torch.config import generator_kwargs
    from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
    from infinite_texture_gans_torch.ops import kernels
    from infinite_texture_gans_torch.sampling.diag import generate_canvas_diag
    from infinite_texture_gans_torch.sampling.infinite import (
        canvas_geometry,
        canvas_latents,
        generate_canvas,
    )

    kernels.ROUTE_LAUNCHES.update(dict.fromkeys(kernels.ROUTE_LAUNCHES, 0))
    gen32 = ResidualPatchGenerator(**{**generator_kwargs(args), "dtype": torch.float32})
    gen32.load_state_dict(gen.state_dict(), strict=True)
    gen32 = gen32.to(dev).eval()
    rng = lambda seed=0: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
    ref = generate_canvas(gen32, rng(), 768, 768)
    err = float(np.abs(generate_canvas_diag(gen32, rng(), 768, 768) - ref).max())
    steps_h = canvas_geometry(768, 768, gen.patch_resolution, GRID, GRID)[0]
    print(f"[diag] {label} f32 768^2 (TF32 off, lanes {min(steps_h, 8)}): diagonal vs raster max "
          f"abs {err:.3e}, limit {CANVAS_TOL:.0e}")
    if not err <= CANVAS_TOL:
        fail(f"{label}: the f32 diagonal canvas differs from the raster by {err}")
    fwd_route(f"{label} f32 768^2 diagonal and raster canvases", False)
    del gen32
    # canvas 0's latents (drawn as generate_canvas draws them) and more canvases'
    lat = [canvas_latents(gen, rng(seed), 1024, 1024)[1:] for seed in range(DIAG_GATE_LANES)]
    z = [z for z, _ in lat]
    maps = None if lat[0][1] is None else [torch.cat(m) for m in zip(*(m for _, m in lat))]
    kw = dict(wire="u8")
    sync()
    kernels.reset_launches()
    raster = generate_canvas(gen, None, 1024, 1024, z_full=z[0], maps_full=lat[0][1],
                             graphs=False, **kw)
    want = dict(kernels.LAUNCHES)
    batched = generate_canvas(gen, None, 1024, 1024, z_full=torch.cat(z), maps_full=maps,
                              graphs=False, **kw)[:1]
    out = {}
    for lanes in (1, DIAG_GATE_LANES):
        sync()
        kernels.reset_launches()
        out[lanes] = generate_canvas_diag(gen, None, 1024, 1024, lanes=lanes, z_full=z[0],
                                          maps_full=lat[0][1], **kw)
        sync()
        out[lanes, "launches"] = dict(kernels.LAUNCHES)

    def levels(a, b):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        return (f"max {int(d.max())} levels, {np.count_nonzero(d)} of {d.size} values differ "
                f"({100 * np.count_nonzero(d) / d.size:.2f}%)")

    same = {lanes: bool(np.array_equal(out[lanes], ref_)) for lanes, ref_ in
            ((1, raster), (DIAG_GATE_LANES, batched))}
    print(f"[diag] {label} bf16 1024^2 u8: lanes 1 vs the raster byte-equal {same[1]}, launches "
          f"{json.dumps(out[1, 'launches'])} (raster {json.dumps(want)}); lanes {DIAG_GATE_LANES} "
          f"vs canvas 0 of the raster at batch {DIAG_GATE_LANES} byte-equal "
          f"{same[DIAG_GATE_LANES]}, launches {json.dumps(out[DIAG_GATE_LANES, 'launches'])}")
    print(f"[diag] {label} bf16 1024^2 u8, reported (cuDNN's algorithms at batch "
          f"{DIAG_GATE_LANES} against batch 1): lanes {DIAG_GATE_LANES} vs the one-canvas raster "
          f"{levels(out[DIAG_GATE_LANES], raster)}; the batch-{DIAG_GATE_LANES} raster's canvas 0 "
          f"vs it {levels(batched, raster)}")
    if not all(same.values()):
        fail(f"{label}: the bf16 diagonal canvas is not byte-equal to the raster at its batch "
             f"({same})")
    if out[1, "launches"] != want:
        fail(f"{label}: the diagonal engine at lanes 1 launched {out[1, 'launches']}, not {want}")
    missing = [k for k in path_kernels if not out[DIAG_GATE_LANES, "launches"][k]]
    if missing:
        fail(f"{label}: the diagonal canvas launched none of {missing}")
    fwd_route(f"{label} diagonal canvases, bf16", True)


def diag_phase(dev, sync, card) -> None:
    """Phase 12: the batched-diagonal engine on the flagship
    (``diag_gates``), its walls, traced busy per canvas, generator calls,
    K2/K3/K4 launches and K2's device ms per launch at lanes DIAG_LANES at
    1024^2 and lanes 8 at DIAG_BIG^2, beside the sequential raster graphed
    and eager in the same call; ``--fuse_up all`` and the SSM run's
    checkpoint through the same gates at lanes 4; ``sample --diag_lanes 4``
    end to end."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from infinite_texture_gans_torch import sample
    from infinite_texture_gans_torch.ops import kernels
    from infinite_texture_gans_torch.sampling.diag import generate_canvas_diag, schedule_constants
    from infinite_texture_gans_torch.sampling.infinite import canvas_geometry, generate_canvas
    from infinite_texture_gans_torch.train.checkpoint import (
        load_checkpoint,
        load_generator_from_checkpoint,
    )

    ckpt = load_checkpoint(str(CKPT))
    gen, args = load_generator_from_checkpoint(str(CKPT), device=dev, ckpt=ckpt)
    diag_gates(dev, gen, args, "flagship", sync, ("chw_halo_step", "conv1x1_chw", "upsample2_chw"))
    P = gen.patch_resolution

    def k2_ms(by_name, n):
        ms = sum(v[0] for k, v in by_name.items() if "chw_fwd_tc_kernel" in k)
        return ms / n if n else float("nan")

    def measure(label, fn, size, calls, trace=True):
        """A cold canvas, then three warm ones (the median wall; launches
        per canvas counted over them), then, with ``trace``, a traced one
        (busy per canvas, K2's device ms per launch, the top kernels)."""
        fn(0)
        walls = []
        kernels.reset_launches()
        for seed in (1, 2, 3):
            sync()
            t = time.perf_counter()
            fn(seed)
            sync()
            walls.append(time.perf_counter() - t)
        n = {k: v // 3 for k, v in kernels.LAUNCHES.items()}
        if not (n["chw_halo_step"] and n["conv1x1_chw"] and n["upsample2_chw"]):
            fail(f"{label} {size}^2 launched {n}: a kernel of the path none")
        busy, traced_s = None, "not traced (the same device work as the graphed raster's)"
        if trace:
            traced, busy, by_name = traced_canvas(lambda: fn(4), sync)
            traced_s = (f"traced {traced:.4f} s, device busy {busy:.2f} ms per canvas "
                        f"({100 * busy / 1e3 / traced:.1f}%), K2 "
                        f"{k2_ms(by_name, n['chw_halo_step']):.4f} ms per launch")
        print(f"[diag time] {label} {size}^2 bf16 u8: warm wall median "
              f"{statistics.median(walls):.4f} s ({', '.join(f'{w:.4f}' for w in walls)}); "
              f"{traced_s}; generator calls {calls}; K2/K3/K4 launches "
              f"{n['chw_halo_step']}/{n['conv1x1_chw']}/{n['upsample2_chw']} [{card}]")
        if trace and "diagonal" in label:
            for name, (ms_, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:DIAG_TOP]:
                print(f"[diag trace]   {ms_:9.3f} ms {k:6d}x  {name[:100]}")
        return busy

    for size, lane_set in ((1024, DIAG_LANES), (DIAG_BIG, (8,))):
        steps_h, steps_w, _, _ = canvas_geometry(size, size, P, GRID, GRID)
        busy = {}
        for lanes in lane_set:
            used = min(lanes, steps_h)
            calls = f"{schedule_constants(steps_w, steps_h, used)[1]} against {steps_h * steps_w}"
            busy[f"lanes {lanes}"] = measure(
                f"diagonal lanes {lanes}" + (f" (runs {used}: steps_h {steps_h})" if used != lanes
                                             else ""),
                lambda seed, lanes=lanes, size=size: generate_canvas_diag(
                    gen, torch.Generator(device=dev).manual_seed(seed), size, size, lanes=lanes,
                    wire="u8"), size, calls)
        for form in ("graphed", "eager"):
            fn = lambda seed, size=size, form=form: generate_canvas(  # noqa: E731
                gen, torch.Generator(device=dev).manual_seed(seed), size, size, wire="u8",
                graphs=form == "graphed")
            if form == "graphed":
                fn(0)  # with measure's cold canvas, every kind of row captured
            busy[f"raster {form}"] = measure(f"raster, {form}", fn, size,
                                             f"{steps_h * steps_w} (sequential)",
                                             trace=form == "graphed" or size == 1024)
        per = json.dumps({k: round(v, 3) for k, v in busy.items() if v is not None})
        print(f"[diag] {size}^2: device busy per canvas {per} ms [{card}]")
    del gen

    gen_all, args_all = load_generator_from_checkpoint(str(CKPT), device=dev, ckpt=ckpt,
                                                       fuse_up="all")
    diag_gates(dev, gen_all, args_all, "flagship --fuse_up all", sync,
               ("chw_upconv_halo_step", "chw_halo_step", "conv1x1_chw", "upsample2_chw_add"))
    del gen_all
    ssm_ckpt = ROOT / "build" / "smoke_train_ssm" / "1__ema.ckpt"
    gen_ssm, args_ssm = load_generator_from_checkpoint(str(ssm_ckpt), device=dev)
    diag_gates(dev, gen_ssm, args_ssm, "SSM", sync,
               ("ssm_embed", "chw_halo_step", "conv1x1_chw", "upsample2_chw"))
    del gen_ssm

    out = ROOT / "build" / "smoke_diag"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copy(CKPT, out / CKPT.name)
    t = time.perf_counter()
    sample.main(["--model_path", str(out / CKPT.name), "--output_resolution_height", "1024",
                 "--output_resolution_width", "1024", "--output_name", "diag.png", "--seed", "1",
                 "--diag_lanes", "4", "--device", dev.type])
    wall = time.perf_counter() - t
    img = np.asarray(Image.open(out / "diag.png"))
    print(f"[sample diag] sample --diag_lanes 4 wrote diag.png {img.shape} (std {img.std():.2f}) in "
          f"{wall:.4f} s (load and PNG included) [{card}]")
    if img.shape != (1024, 1024, 3) or not img.std() > 1:
        fail(f"sample --diag_lanes 4 wrote {img.shape}, std {img.std()}")
    shutil.rmtree(out, ignore_errors=True)


# Phase 13 (interop): the zoo's cases at the JAX package's default widths,
# 64^2 inputs, batch ZOO_BATCH. In float64 the card is held to the CPU within
# ZOO_TOL of each output's, gradient's and state tensor's largest value (a
# gradient leaf below ZOO_NOISE_SHARE of the model's largest is rounding
# noise, zero in exact arithmetic: the attention's phi bias; it is held to
# ZOO_TOL of that largest). Float32 (TF32 off) is held to the CPU's float64
# by the median gradient, and that median by its median over ZOO_DRAWS input
# draws, since the largest leaf, and for SNDiscriminator the median too,
# swings with the draw: on the CPU (zoo_precision_study.py) its float32
# gradients' median reads 2.3e-6 to 4.8e-3 over ten draws (cancellation in
# its backward; its gradients move 2e-7 for a 1e-7 change of the inputs or
# weights). ZOO_F32_TOL sits between the CPU's own float32 and a TF32
# control on the card, both printed beside it: on an H100 80GB HBM3 at 700 W
# the phase read the card's float32 at 6.5e-7 to 2.4e-6 over the cases, the
# CPU's at 1.3e-6 to 6.2e-6 and the TF32 control at 1.2e-2 to 9.3e-2; the
# limit is 16x over the CPU's largest and 122x under the control's smallest.
ZOO_BATCH = 8
ZOO_TOL = 1e-4
ZOO_NOISE_SHARE = 1e-6
ZOO_DRAWS = 5
ZOO_F32_TOL = 1e-4
ZOO_CLASSES = 10
ZOO_CASES = {
    "ResDiscriminator att": ("ResDiscriminator", dict(att=True)),
    **{f"ResDiscriminator {m}": ("ResDiscriminator", dict(n_classes=ZOO_CLASSES, cond_method=m))
       for m in ("concat", "proj", "conv1x1", "conv3x3")},
    "DCDiscriminator": ("DCDiscriminator", {}),
    "SNDiscriminator SN": ("SNDiscriminator", dict(SN=True)),
}
# the quality metrics of one canvas on the card against the CPU (f32, TF32 off)
QUALITY_REL = 1e-3


class WatchdogSpy:
    """Patches ``train_loop.StallWatchdog`` with a subclass that records each
    instance's beats, stops and thread (the reference's test spies the same
    way, tests/test_watchdog.py)."""

    def __init__(self):
        self.made = []

    def __enter__(self):
        from infinite_texture_gans_torch.train import train_loop
        from infinite_texture_gans_torch.utils.watchdog import StallWatchdog

        made = self.made

        class Spy(StallWatchdog):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.beats, self.stops, self.thread = 0, 0, None
                made.append(self)

            def start(self):
                out = super().start()
                self.thread = self._thread
                return out

            def beat(self):
                self.beats += 1
                super().beat()

            def stop(self):
                self.stops += 1
                super().stop()

        self._module, self._saved = train_loop, train_loop.StallWatchdog
        train_loop.StallWatchdog = Spy
        return self

    def __exit__(self, *exc):
        self._module.StallWatchdog = self._saved
        return False


def read_pth(path):
    import argparse

    import torch

    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def flat_tree(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_tree(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def pth_phase(dev, sync, card) -> dict:
    """The flagship ``.ckpt`` through ``sample --export_pth`` to a ``.pth``;
    both loaded (timed) and rendered to a 1024^2 bf16 u8 canvas at one
    seed: byte-equal, with phase 4's launches; the ``.pth`` (its BN counters
    set nonzero) re-exported bit-equal; phase 10's SN-in-G checkpoint
    exported and imported back to its own tree, ``u``/``v`` included.
    Returns the flagship's 1024^2 canvas (u8) for the quality check."""
    import numpy as np
    import torch

    from infinite_texture_gans_torch import sample
    from infinite_texture_gans_torch.ops import kernels
    from infinite_texture_gans_torch.sampling.infinite import generate_canvas
    from infinite_texture_gans_torch.train.checkpoint import (
        load_checkpoint,
        load_generator_from_checkpoint,
    )

    out = ROOT / "build" / "smoke_interop"
    out.mkdir(parents=True, exist_ok=True)
    pth = out / "241_300ep_ema.pth"
    t = time.perf_counter()
    sample.main(["--model_path", str(CKPT), "--export_pth", str(pth), "--device", dev.type])
    print(f"[interop] sample --export_pth wrote {pth.name} ({pth.stat().st_size} bytes) from "
          f"{CKPT.name} in {time.perf_counter() - t:.3f} s")
    want = {**dict.fromkeys(KERNELS, 0), **{k: 16 * v for k, v in GEN_PER_SUB["flagship"].items()}}
    canvases = {}
    for path in (CKPT, pth):
        sync()
        t = time.perf_counter()
        ckpt = load_checkpoint(str(path))
        t_read = time.perf_counter() - t
        gen, args = load_generator_from_checkpoint(str(path), device=dev, ckpt=ckpt)
        sync()
        t_load = time.perf_counter() - t
        if gen.dtype != torch.bfloat16 or (args.G_ch, args.n_layers_G, args.attention) != (
                52, 6, True):
            fail(f"{path.name} builds {gen.dtype} G_ch {args.G_ch} n_layers_G {args.n_layers_G}, "
                 "not the flagship")
        kernels.reset_launches()
        canvases[path.suffix] = generate_canvas(gen, torch.Generator(device=dev).manual_seed(21),
                                                1024, 1024, wire="u8")
        sync()
        launches = dict(kernels.LAUNCHES)
        print(f"[interop] load {path.name}: file read {t_read:.3f} s, generator on the card "
              f"{t_load:.3f} s (read included); 1024^2 bf16 u8 canvas (seed 21) launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})} [{card}]")
        if launches != want:
            fail(f"the {path.name} canvas launched {launches}, not {want}")
        del gen
    n_diff = int(np.count_nonzero(canvases[".ckpt"] != canvases[".pth"]))
    print(f"[interop] .pth canvas vs .ckpt canvas, 1024^2 bf16 u8, seed 21: {n_diff} of "
          f"{canvases['.pth'].size} values differ (want 0)")
    if n_diff:
        fail("the .pth's canvas differs from the .ckpt's")

    # .pth -> .pth, the BN counters set nonzero first
    raw = read_pth(pth)
    nbt = [k for k in raw["netG_state_dict"] if k.endswith("num_batches_tracked")]
    for i, k in enumerate(nbt):
        raw["netG_state_dict"][k] = torch.tensor(1000 + i, dtype=torch.int64)
    counted = out / "counted.pth"
    torch.save(raw, counted)
    again = out / "again.pth"
    sample.main(["--model_path", str(counted), "--export_pth", str(again), "--device", dev.type])
    a, b = raw["netG_state_dict"], read_pth(again)["netG_state_dict"]
    same = a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and torch.equal(a[k], b[k])
        for k in a)
    print(f"[interop] .pth -> .pth: {len(a)} tensors ({len(nbt)} BN counters set to 1000+), "
          f"{'bit-equal' if same else 'DIFFERENT'}")
    if not same or not nbt:
        fail(".pth -> .pth did not keep the state dict bit for bit")

    # phase 10's SN-in-G checkpoint: its raw tree with the SN vectors
    sn_ckpt = ROOT / "build" / "smoke_train_sn" / "1_1.ckpt"
    sn_pth = out / "sn.pth"
    sample.main(["--model_path", str(sn_ckpt), "--export_pth", str(sn_pth), "--device", dev.type])
    src = load_checkpoint(str(sn_ckpt))["netG_variables"]
    _, _, back = load_generator_from_checkpoint(str(sn_pth), device=dev, with_variables=True)
    got = dict(flat_tree({c: back[c] for c in ("params", "batch_stats", "spectral")}))
    want_t = dict(flat_tree(src))
    n_sn = sum(1 for k in want_t if k[0] == "spectral")
    bad = sorted(k for k in want_t if k not in got or not np.array_equal(
        np.asarray(got[k]), np.asarray(want_t[k], dtype=np.float32)))
    print(f"[interop] SN-in-G {sn_ckpt.name} -> sample --export_pth -> import: {len(want_t)} "
          f"leaves ({n_sn} SN vectors), {len(bad)} differ, {len(got) - len(want_t)} extra")
    if bad or got.keys() != want_t.keys() or not n_sn:
        fail(f"the SN checkpoint's tree did not come back through the .pth: {bad[:5]}")
    return canvases[".ckpt"]


def quality_phase(dev, canvas_u8, card) -> None:
    """``texture_quality_report`` of the flagship's 1024^2 canvas against
    its source texture with the default pyramid, on the card and on the
    CPU: each metric within QUALITY_REL."""
    import numpy as np

    from infinite_texture_gans_torch.utils import quality

    src = quality.load_image(str(ROOT / "datasets" / "241.jpg"))
    img = canvas_u8[0].astype(np.float32) / 127.5 - 1.0
    reports = {}
    for where in (dev.type, "cpu"):
        features = quality.random_conv_features(device=where)
        features(img[None])  # the first call's set-up
        t = time.perf_counter()
        reports[where] = quality.texture_quality_report(src, img, features)
        print(f"[quality] flagship 1024^2 canvas vs datasets/241.jpg on {where}: "
              f"{json.dumps(reports[where])} in {time.perf_counter() - t:.3f} s"
              + (f" [{card}]" if where != "cpu" else ""))
    for k, v in reports["cpu"].items():
        rel = abs(reports[dev.type][k] - v) / max(abs(v), 1e-12)
        print(f"[quality] {k}: card vs CPU relative {rel:.2e} (limit {QUALITY_REL:g})")
        if not rel <= QUALITY_REL:
            fail(f"the quality metric {k} on the card is {rel:.2e} from the CPU's")


def zoo_inputs(kw, draw: int):
    """Input draw ``draw`` of a zoo case (``kw`` its constructor's keywords):
    images (ZOO_BATCH, 64, 64, 3) and, for a conditional case, labels (one-hot
    for concat / proj, a 16-vector for conv1x1 / conv3x3) or None."""
    import torch

    g = torch.Generator().manual_seed(1 + draw)
    x = torch.randn(ZOO_BATCH, 64, 64, 3, generator=g)
    y = None
    if kw.get("n_classes"):
        y = (torch.eye(ZOO_CLASSES)[torch.randint(ZOO_CLASSES, (ZOO_BATCH,), generator=g)]
             if kw["cond_method"] in ("concat", "proj")
             else torch.randn(ZOO_BATCH, 16, generator=g))
    return x, y


def zoo_models(cls: str, kw) -> dict:
    """A zoo case's module on the CPU in float64 and float32 from one
    initialisation, its attention gate opened: {dtype: module}."""
    import torch

    from infinite_texture_gans_torch.models import discriminator

    models = {}
    for dt in (torch.float64, torch.float32):
        torch.manual_seed(0)
        m = getattr(discriminator, cls)(**kw, dtype=dt).to(dt).train()
        for name, p in m.named_parameters():
            if name.endswith("gamma"):
                p.data.fill_(0.5)
        models[dt] = m
    return models


def zoo_run(model, x, y, dev):
    """A train-mode forward with an SN refresh and a backward of ``model``
    on ``dev``: (output, dx, gradients by name, state dict), on the CPU."""
    import torch

    dt = model.dtype
    xt = x.to(dev, dt, copy=True).requires_grad_()
    out = model(xt, *([y.to(dev, dt)] if y is not None else []), update_sn=True)
    (out * torch.linspace(-1, 1, out.numel(), dtype=dt, device=dev).reshape(out.shape)).sum().backward()
    return (out.detach().cpu(), xt.grad.cpu(),
            {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: t.cpu() for n, t in model.state_dict().items()})


def zoo_errors(got, ref) -> dict:
    """{tensor: the largest deviation of ``got`` from ``ref`` (zoo_run
    results) over that tensor's largest value in ``ref``, or over the
    model's largest gradient for a rounding-noise leaf}; gradients are
    named 'd <parameter>'."""
    o0, dx0, g0, s0 = ref
    o1, dx1, g1, s1 = got
    top = max(float(v.abs().max()) for v in g0.values())
    pairs = [("output", o1, o0, 0.0), ("dx", dx1, dx0, 0.0)]
    pairs += [(f"d {n}", g1[n], g0[n], top) for n in g0]
    pairs += [(n, s1[n], s0[n], 0.0) for n in s0 if n.split(".")[-1] in ("u", "v", "mean", "var")]
    errs = {}
    for name, a, b, model_top in pairs:
        scale = float(b.abs().max())
        if scale < ZOO_NOISE_SHARE * model_top:
            scale = model_top
        errs[name] = float((a.double() - b.double()).abs().max()) / max(scale, 1e-30)
    return errs


def zoo_gap(got, ref) -> tuple:
    """``zoo_errors`` summed up: (the largest, the tensor it is at, the
    median over the gradients, the number of tensors)."""
    errs = zoo_errors(got, ref)
    at = max(errs, key=errs.get)
    return errs[at], at, statistics.median(v for k, v in errs.items() if k.startswith("d ")), \
        len(errs)


API_LOSS_REL = 1e-6
API_SUBPACKAGES = ("ops", "models", "sampling", "data", "train", "utils", "parallel")


def api_phase(dev, canvas_u8, card) -> None:
    """The port's public surface on the card: every subpackage's exports
    import, ``crop_images`` / ``merge_patches_into_image`` on the flagship's
    1024^2 canvas (bf16 on [-1, 1]) and ``calc_ralsloss_G`` against the same
    calls on the CPU."""
    import importlib

    import torch

    from infinite_texture_gans_torch.ops.grid import crop_images, merge_patches_into_image
    from infinite_texture_gans_torch.train.losses import calc_ralsloss_G

    names = 0
    for sub in API_SUBPACKAGES:
        pkg = importlib.import_module(f"infinite_texture_gans_torch.{sub}")
        for name in pkg.__all__:
            getattr(pkg, name)
        names += len(pkg.__all__)
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "infinite_texture_gans_tpu"))
    if jax_mods:
        fail(f"[api] the port's exports loaded {jax_mods[:5]}")
    print(f"[api] {names} names of {len(API_SUBPACKAGES)} subpackages' __all__ imported; no JAX")
    x = torch.from_numpy(canvas_u8).to(dev).to(torch.bfloat16) / 127.5 - 1.0
    if tuple(x.shape) != (1, 1024, 1024, 3):
        fail(f"[api] the flagship canvas is {tuple(x.shape)}")
    for stride, n_win in ((256, 16), (192, 25)):
        got = crop_images(x, 256, 256, stride)
        want = crop_images(x.cpu(), 256, 256, stride)
        same = got.is_cuda and tuple(got.shape) == (n_win, 256, 256, 3) and torch.equal(
            got.cpu(), want)
        print(f"[api] crop_images(1024^2 bf16 canvas, 256, 256, {stride}): {tuple(got.shape)} "
              f"on {got.device}, bit-equal to the CPU's {same}")
        if not same:
            fail(f"[api] crop_images at stride {stride} differs from the CPU's")
        if stride == 256:
            back = merge_patches_into_image(got, 4, 4)
            if not torch.equal(back, x):
                fail("[api] merge_patches_into_image(crop_images(x, 256, 256, 256), 4, 4) != x")
            print("[api] merge_patches_into_image(crop_images(x, 256, 256, 256), 4, 4) == x")
    gen = torch.Generator().manual_seed(5)
    real, fake = (torch.randn(8, 1, 24, 24, generator=gen) for _ in range(2))
    want = float(calc_ralsloss_G(real, fake))
    got_t = calc_ralsloss_G(real.to(dev), fake.to(dev))
    got = float(got_t)
    rel = abs(got - want) / abs(want)
    print(f"[api] calc_ralsloss_G (8, 1, 24, 24) f32 on {got_t.device}: {got:.8f}, CPU "
          f"{want:.8f}, rel {rel:.3e} (limit {API_LOSS_REL:g}) [{card}]")
    if not (got_t.is_cuda and rel <= API_LOSS_REL):
        fail(f"[api] calc_ralsloss_G on the card {got} vs CPU {want}")


def zoo_phase(dev, card) -> None:
    """Each discriminator of the zoo at the JAX package's default widths on
    the card and on the CPU (the same weights and inputs): a train-mode
    forward with an SN refresh and a backward. Float64 on the card is held
    to the CPU's float64 (ZOO_TOL); float32 on the card (TF32 off) to the
    CPU's float64 by its gradients' median over ZOO_DRAWS input draws
    (ZOO_F32_TOL), beside the CPU's own float32 and a TF32 control on the
    card. Every case is printed before a failure ends the phase."""
    import copy

    import torch

    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    failed = []
    for label, (cls, kw) in ZOO_CASES.items():
        models = zoo_models(cls, kw)
        times = {}

        def run(dt, d, draw, tf32=False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                t = time.perf_counter()
                out = zoo_run(copy.deepcopy(models[dt]).to(d), *zoo_inputs(kw, draw), d)
                times[d.type, dt, tf32] = time.perf_counter() - t  # .cpu() copies synchronise
            finally:
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            return out

        exact = run(f64, cpu, 0)
        held, at, _, n = zoo_gap(run(f64, dev, 0), exact)
        medians = {"float32 card": [], "the CPU's float32": [], "TF32 card (control)": []}
        for draw in range(ZOO_DRAWS):
            if draw:
                exact = run(f64, cpu, draw)
            for what, (d, tf32) in zip(medians, ((dev, False), (cpu, False), (dev, True))):
                gap = zoo_gap(run(f32, d, draw, tf32), exact)
                medians[what].append(gap[2])
                if draw == 0 and what == "float32 card":
                    worst, worst_at = gap[:2]
        stats = {what: statistics.median(v) for what, v in medians.items()}
        print(f"[zoo] {label} (64^2, batch {ZOO_BATCH}): {n} tensors (output, dx, gradients, "
              f"SN/BN state), each's deviation over its largest value. float64 card vs CPU: "
              f"largest {held:.2e} at {at} (limit {ZOO_TOL:g}). Gradients' median against the "
              f"CPU's float64, median over {ZOO_DRAWS} input draws: "
              + "; ".join(f"{what} {stats[what]:.2e} (draws "
                          + " ".join(f"{v:.1e}" for v in medians[what]) + ")"
                          for what in medians)
              + f"; float32 card limit {ZOO_F32_TOL:g}. Float32 card, draw 0: largest "
              f"{worst:.2e} at {worst_at} (reported); forward + backward f32 card "
              f"{times[dev.type, f32, False]:.3f} s, CPU {times['cpu', f32, False]:.3f} s "
              f"[{card}]")
        if not held <= ZOO_TOL:
            failed.append(f"{label}: float64 {at} on the card is {held:.2e} of its largest "
                          "value from the CPU's")
        if not stats["float32 card"] <= ZOO_F32_TOL:
            failed.append(f"{label}: float32 on the card, gradients' median "
                          f"{stats['float32 card']:.2e} from the CPU's float64 "
                          f"(limit {ZOO_F32_TOL:g})")
    if failed:
        fail("[zoo] " + "; ".join(failed))


def gloo_rank_step(argv) -> dict:
    """One eager float32 step of the train loop's ``StepDispatch`` (seed 11,
    crops and latents seed 7) in a rank of phase 14's gloo run on the card,
    from the same state each time: with cuDNN off ('step'), then with the
    BatchNorm moments' all-reduce removed too ('planted': each rank
    normalises by its own slice), then with cuDNN on and the all-reduce
    back ('cudnn'): each the global losses, the averaged gradients (on the
    host) and the rank's launches."""
    import torch

    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.ops import collectives
    from infinite_texture_gans_torch.parallel.mesh import current_axis

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    axis = current_axis()
    global_sums = collectives.global_sums
    out = {}
    for what in ("step", "planted", "cudnn"):
        torch.backends.cudnn.enabled = what == "cudnn"
        collectives.global_sums = (global_sums if what != "planted"
                                   else lambda s1, s2, count: (s1, s2, count))
        run = dispatch_run(axis.device, prepare_parser().parse_args(argv), False,
                           torch.cuda.synchronize, axis=axis, steps=1)
        out[what] = {"losses": run["losses"], "launches": run["launches"],
                     "grads": {m: {k: v.cpu() for k, v in g.items()}
                               for m, g in run["grads"].items()}}
    return out


def parallel_phase(dev, sync, card) -> dict:
    """Phase 14: ``parallel/`` on the one card (NCCL will not put two ranks
    on one device, so several NCCL ranks are not run here).

    - world size 1, NCCL, graphed: the data-parallel Experiment-1 ``auto``
      bf16 step (every BatchNorm moment and gradient bucket through an
      all-reduce captured in the step's CUDA graph), GRAPH_STEPS steps as
      the train loop runs them, held bit-equal to the undistributed step
      (losses, gradients, parameters, buffers) with the same launches; both
      replays' median walls printed (the all-reduces' cost at world size 1);
    - GLOO_RANKS ranks on the one card through gloo (it all-reduces CUDA
      tensors), eagerly: one float32 step against the 1-rank step with
      cuDNN off on both sides, held to step parity's gates, both ranks'
      gradients bit-equal, a planted fault (the moments' all-reduce
      removed) caught; reported: with cuDNN on, and the control (the
      1-rank step on the same batch in another order): the only run in
      which the kernels' own statistics (K5, K10) pass through the global
      sums;
    - the wavefront and its streamed form at world size 1 on the flagship
      (PARALLEL_CANVAS^2, bf16, u8): byte-equal to the graphed raster, with
      the raster's K2/K3/K4 launches, walls beside the raster's;
    - one graphed bf16 step at ``--D_ch`` WIDE_D_CH: no stem launch, finite
      losses.

    Returns {'mesh': the data-parallel step's launches over its run,
    'wavefront': the wavefront canvas's launches}."""
    import tempfile

    import numpy as np
    import torch

    from infinite_texture_gans_torch.config import prepare_parser
    from infinite_texture_gans_torch.ops import kernels
    from infinite_texture_gans_torch.parallel.mesh import Mesh, data_axis, run_ranks
    from infinite_texture_gans_torch.parallel.wavefront import (
        generate_canvas_wavefront,
        generate_canvas_wavefront_streamed,
    )
    from infinite_texture_gans_torch.sampling.infinite import canvas_geometry, generate_canvas
    from infinite_texture_gans_torch.sampling.stream import generate_canvas_streamed, read_png
    from infinite_texture_gans_torch.train.checkpoint import load_generator_from_checkpoint
    from infinite_texture_gans_torch.train.train_step import WARMUP_STEPS

    out = {}
    card_dev = f"cuda:{torch.cuda.current_device()}"
    argv = EXP1_ARGS + ["--fuse_up", "auto", "--device", "cuda"]
    args = prepare_parser().parse_args(argv)
    t0 = time.perf_counter()
    plain = dispatch_run(dev, args, True, sync)
    with tempfile.TemporaryDirectory() as tmp, \
            data_axis(Mesh(1, (card_dev,), "nccl"), 0, f"file://{tmp}/rendezvous") as axis:
        mesh = dispatch_run(dev, args, True, sync, axis=axis)
    gap = graph_parity_gap(plain, mesh, 0, GRAPH_STEPS, "grads")
    replays = slice(WARMUP_STEPS + 1, GRAPH_STEPS)
    walls = [statistics.median(r["walls"][replays]) for r in (mesh, plain)]
    print(f"[parallel] data:1 NCCL, the data-parallel Experiment-1 --fuse_up auto bf16 step, "
          f"{GRAPH_STEPS} steps graphed as the train loop runs them: bit-equal to the "
          f"undistributed step (losses, gradients, parameters, buffers): {gap[3]}; launches "
          f"{json.dumps(mesh['launches'])} (undistributed {json.dumps(plain['launches'])}); "
          f"median wall of the {GRAPH_STEPS - WARMUP_STEPS - 1} later replays {walls[0]:.4f} s "
          f"against {walls[1]:.4f} s undistributed ({walls[0] / walls[1]:.3f}x: the all-reduces "
          f"at world size 1) [{card}]")
    if not gap[3] or mesh["launches"] != plain["launches"] or mesh["routes"] != plain["routes"]:
        fail("the data-parallel step at world size 1 differs from the undistributed step")
    if any(mesh["launches"][k] != GRAPH_STEPS * v for k, v in STEP_LAUNCHES["auto"].items()):
        fail(f"the data-parallel step's launches {mesh['launches']} are not {GRAPH_STEPS} steps' "
             f"{STEP_LAUNCHES['auto']}")
    out["mesh"] = mesh["launches"]
    del plain, mesh
    print(f"[phase 14] data:1 NCCL step in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    f32_argv = argv + ["--compute_dtype", "float32"]
    f32 = prepare_parser().parse_args(f32_argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    one = {}
    for cudnn, reorder in ((False, False), (False, True), (True, False)):
        torch.backends.cudnn.enabled = cudnn
        run = dispatch_run(dev, f32, False, sync, steps=1, reorder=reorder)
        one["control" if reorder else cudnn] = {
            "losses": run["losses"], "launches": run["launches"],
            "grads": {m: {k: v.cpu() for k, v in g.items()} for m, g in run["grads"].items()}}
    two = run_ranks(gloo_rank_step, Mesh(GLOO_RANKS, (card_dev,) * GLOO_RANKS, "gloo"),
                    (f32_argv,), timeout=600)
    for what in ("control", "step", "planted", "cudnn"):
        ref, run = one[what == "cudnn"], one["control"] if what == "control" else two[0][what]
        loss_rel = max(abs(run["losses"][0][k] - v) / max(abs(v), 1e-30)
                       for k, v in ref["losses"][0].items())
        worst, bad = (0.0, 0.0, ""), []
        for model in ("G", "D"):
            for name, (share, _, noise) in leaf_deviations(run["grads"][model],
                                                           ref["grads"][model]).items():
                limit = NOISE_TOL if noise else STEP_GRAD_TOL
                worst = max(worst, (share / limit, share, name))
                if not share <= limit:
                    bad.append(name)
        ranks_equal = what == "control" or all(
            torch.equal(v, two[1][what]["grads"][m][k]) for m in run["grads"]
            for k, v in run["grads"][m].items())
        at_leaf = leaf_deviations({GLOO_LEAF: run["grads"]["G"][GLOO_LEAF]},
                                  {GLOO_LEAF: ref["grads"]["G"][GLOO_LEAF]})[GLOO_LEAF][0]
        label = {"control": "the control: the 1-rank step on the same batch with its halves "
                 "swapped, cuDNN off, reported", "step": f"data:{GLOO_RANKS} gloo on one card, "
                 "cuDNN off", "planted": f"data:{GLOO_RANKS} gloo on one card, cuDNN off, the "
                 "planted fault (the moments' all-reduce removed)",
                 "cudnn": f"data:{GLOO_RANKS} gloo on one card, cuDNN on, reported"}[what]
        print(f"[parallel] {label}: one eager f32 Experiment-1 step (each rank 4 of the 8 fakes "
              f"and 32 of the 64 crops, the kernels' statistics through the global sums) against "
              f"the 1-rank step: losses max rel {loss_rel:.3e} (limit {STEP_LOSS_TOL:g}), "
              f"gradients largest deviation {worst[1]:.3e} ({worst[2]}), at {GLOO_LEAF} "
              f"{at_leaf:.3e}, {len(bad)} leaves over step parity's limits"
              + ("" if what == "control" else f"; the ranks' gradients bit-equal: {ranks_equal}")
              + f"; launches {json.dumps(run['launches'])} [{card}]")
        passed = loss_rel <= STEP_LOSS_TOL and not bad and ranks_equal
        if what == "step" and not passed:
            fail(f"the {GLOO_RANKS}-rank gloo step differs from the 1-rank step (losses "
                 f"{loss_rel}, leaves {bad}, ranks equal {ranks_equal})")
        if what == "planted" and passed:
            fail("the gloo step's check passes a step without the moments' all-reduce")
        if what not in ("planted", "control") and run["launches"] != {
                **dict.fromkeys(kernels.LAUNCHES, 0),
                **STEP_LAUNCHES["auto"]}:
            fail(f"the gloo step's launches {run['launches']} are not one step's "
                 f"{STEP_LAUNCHES['auto']}")
    torch.backends.cudnn.enabled = True
    del one, two
    print(f"[phase 14] data:{GLOO_RANKS} gloo step in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gen, _ = load_generator_from_checkpoint(str(CKPT), device=dev)
    if gen.dtype != torch.bfloat16:
        fail(f"the flagship generator runs {gen.dtype}, not bfloat16")
    steps_h, steps_w, _, _ = canvas_geometry(PARALLEL_CANVAS, PARALLEL_CANVAS,
                                             gen.patch_resolution, GRID, GRID)
    want = {**dict.fromkeys(kernels.LAUNCHES, 0),
            **{k: v * steps_h * steps_w for k, v in GEN_PER_SUB["flagship"].items()}}
    size = (PARALLEL_CANVAS, PARALLEL_CANVAS)

    def timed(fn):
        sync()
        kernels.reset_launches()
        t = time.perf_counter()
        img = fn()
        sync()
        return img, time.perf_counter() - t, dict(kernels.LAUNCHES)

    def rng():
        return torch.Generator(device=dev).manual_seed(31)

    for _ in range(3):  # the raster's rows: warm-up, captures, then replays only
        raster, raster_s, raster_launches = timed(
            lambda: generate_canvas(gen, rng(), *size, wire="u8"))
    wave, wave_s, wave_launches = timed(
        lambda: generate_canvas_wavefront(gen, rng(), *size, wire="u8"))
    with tempfile.TemporaryDirectory() as tmp:
        seq, slab = f"{tmp}/raster.png", f"{tmp}/wavefront.png"
        _, seq_s, _ = timed(lambda: generate_canvas_streamed(gen, rng(), *size, seq,
                                                             row_group=PARALLEL_SLAB))
        _, slab_s, slab_launches = timed(lambda: generate_canvas_wavefront_streamed(
            gen, rng(), *size, slab, slab_rows=PARALLEL_SLAB))
        with open(seq, "rb") as a, open(slab, "rb") as b:
            files_equal = a.read() == b.read()
        slab_img = read_png(slab)
    n_diff = int(np.count_nonzero(wave != raster))
    print(f"[parallel] wavefront data:1, flagship {PARALLEL_CANVAS}^2 bf16 u8: {n_diff} of "
          f"{raster.size} values differ from the graphed raster (want 0); launches "
          f"{json.dumps(wave_launches)} (raster {json.dumps(raster_launches)}); wall "
          f"{wave_s:.3f} s eager against the graphed raster's warm {raster_s:.3f} s [{card}]")
    print(f"[parallel] wavefront streamed data:1, slabs of {PARALLEL_SLAB} rows: the PNG "
          f"byte-equal to the raster stream's (row_group {PARALLEL_SLAB}): {files_equal}, "
          f"pixels equal to the raster canvas: {np.array_equal(slab_img, raster[0])}; launches "
          f"{json.dumps(slab_launches)}; wall {slab_s:.3f} s against the raster stream's "
          f"{seq_s:.3f} s [{card}]")
    if n_diff or wave_launches != want or raster_launches != want or slab_launches != want:
        fail(f"the wavefront canvas or its launches {wave_launches} differ from the raster's "
             f"({want})")
    if not files_equal or not np.array_equal(slab_img, raster[0]):
        fail("the slab-streamed wavefront PNG differs from the raster stream's")
    out["wavefront"] = wave_launches
    del gen
    print(f"[phase 14] wavefront in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    wide = prepare_parser().parse_args(argv + ["--D_ch", str(WIDE_D_CH)])
    run = dispatch_run(dev, wide, True, sync, steps=WARMUP_STEPS + 1)
    stem = {k: run["launches"][k] for k in ("stem_fwd", "stem_dw", "stem_dx")}
    finite = all(math.isfinite(v) for step in run["losses"] for v in step.values())
    print(f"[parallel] --D_ch {WIDE_D_CH} bf16, graphed ({WARMUP_STEPS} eager warm-up steps, a "
          f"captured one): stem launches {json.dumps(stem)} (want 0: conv0 NHWC past "
          f"{kernels.STEM_TC_MAX_CO} channels), losses {json.dumps(run['losses'][-1])}, "
          f"finite {finite} [{card}]")
    if any(stem.values()) or not finite:
        fail(f"--D_ch {WIDE_D_CH}: stem launches {stem}, losses finite {finite}")
    print(f"[phase 14] --D_ch {WIDE_D_CH} step in {time.perf_counter() - t0:.1f} s")
    return out


def mfu_phase(dev, walls, card) -> None:
    """Model TFLOP per step and per 1024^2 canvas (``utils/flops.py``) over
    the walls phases 4-7 measured, against the card's bf16 peak."""
    import torch

    from infinite_texture_gans_torch.config import (
        discriminator_kwargs,
        generator_kwargs,
        prepare_parser,
    )
    from infinite_texture_gans_torch.models.discriminator import PatchDiscriminator
    from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
    from infinite_texture_gans_torch.utils import flops

    peak = flops.peak_flops(dev, "bfloat16")
    recipes = {"auto": EXP1_ARGS + ["--fuse_up", "auto"], "off": EXP1_ARGS + ["--fuse_up", "off"],
               "ssm": SSM_ARGS}
    with torch.device("meta"):
        models = {}
        for tail, argv in recipes.items():
            args = prepare_parser().parse_args(argv)
            models[tail] = (ResidualPatchGenerator(**generator_kwargs(args)),
                            PatchDiscriminator(**discriminator_kwargs(args)), args)
    work = {}
    for tail in ("auto", "off", "ssm"):
        G, D, args = models[tail]
        work[f"train step {TRAIN_PATHS[tail][0]}"] = (flops.train_step_flops(
            G, D, batch_size=args.batch_size, crop=args.random_crop, num_images=args.num_images,
            disc_iters=args.disc_iters), walls[f"step {tail}"])
    for label, tail in (("BN", "auto"), ("--fuse_up all", "auto"), ("SSM", "ssm")):
        work[f"1024^2 canvas {label}"] = (flops.canvas_flops(models[tail][0], 1024, 1024),
                                          walls[f"canvas {label}"])
    for label, (f, wall) in work.items():
        rate = f / wall
        share = f"{100 * rate / peak:.2f}% of {peak / 1e12:.0f} TFLOP/s bf16" if peak else (
            "MFU not measured (no peak for this card)")
        print(f"[mfu] {label}: {f / 1e12:.4f} model TFLOP over the warm graphed wall "
              f"{wall * 1e3:.2f} ms = {rate / 1e12:.2f} TFLOP/s, {share} [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "infinite_texture_gans_torch" / "csrc").is_dir() or not CKPT.exists():
        print("chip_smoke: run from the root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from infinite_texture_gans_torch.utils.flops import CARD_PEAKS, H100_SXM

    # NVIDIA H100 SXM data sheet (the port's one table, utils/flops.py):
    # HBM rate, dense bf16 tensor-core rate and the float32 rate outside the
    # tensor cores (the bound of K15's f32 route)
    PEAK_BYTES_PER_S, PEAK_BF16_FLOP_PER_S, PEAK_F32_FLOP_PER_S = CARD_PEAKS[H100_SXM]

    from infinite_texture_gans_torch.models.generator import generator_channel_plan
    from infinite_texture_gans_torch.ops import _build, kernels, ssm
    from infinite_texture_gans_torch.sampling.infinite import canvas_geometry
    from infinite_texture_gans_torch.train.checkpoint import (
        load_checkpoint,
        load_generator_from_checkpoint,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print(f"[build] {line.strip()}")

    def sync():
        torch.cuda.synchronize()

    def eager_ms(fn, iters=50, warmup=5):
        """Per call, back to back from Python: includes host issue time."""
        for _ in range(warmup):
            fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / iters

    def table():
        return {k: dict(err=None, sum_err=0.0, ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        library_ms=0.0, cuda_cores_ms=0.0, nbytes=0.0, flops=0.0, calls=0)
                for k in KERNELS}

    stats = table()  # per 384^2 sub-image (generation)
    astats = table()  # per 384^2 sub-image (generation under --fuse_up all)
    gstats = table()  # per 192^2 SSM sub-image (SSM generation)
    fstats = table()  # K15's float32 route, per SSM step at the training shapes
    estats = table()  # K15's float32 forward, per 192^2 SSM sub-image at eval
    tstats = {tail: table() for tail in STEP_LAUNCHES}  # per training step, each tail
    # the routed kernels' f32 routes (ROUTED), per step
    dstats = {tail: table() for tail in STEP_LAUNCHES}

    def compare(name, shape, got, ref, exact=False, into=None, floor=1.0):
        """Values within the dtype's limit of max(floor, max|ref|)."""
        sync()
        err = float((got.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        tol = 0.0 if exact else (F32_TOL if got.dtype == torch.float32 else BF16_TOL)
        limit = tol * max(floor, top)
        print(f"[check] {name} {str(got.dtype).replace('torch.', '')} {shape}: "
              f"max_abs_err {err:.3e} max_rel_err {err / max(top, 1e-12):.3e} "
              f"(of max|ref| {top:.3e}) limit {limit:.3e}")
        if not err <= limit:
            fail(f"{name} {shape} {got.dtype}: max abs err {err} > {limit}")
        (into or stats)[name]["err"] = max((into or stats)[name]["err"] or 0.0, err)

    def compare_sum(name, shape, got, ref, into=None, tol=SUM_TOL):
        """A float32 reduction: within ``tol`` of the largest reference entry."""
        sync()
        err = float((got.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        limit = tol * max(top, 1e-30)
        print(f"[check] {name} sums {shape}: max_abs_err {err:.3e} (of max|ref| {top:.3e}) "
              f"limit {limit:.3e}")
        if not err <= limit:
            fail(f"{name} {shape} sums: max abs err {err} > {limit}")
        (into or stats)[name]["sum_err"] = max((into or stats)[name]["sum_err"], err)

    # -- 2. kernels against their plain versions --------------------------
    def randn(g, *shape):
        return torch.randn(*shape, device=dev, generator=g)

    def conv3_inputs(c, co, h, w, dtype, seed, bias=0.1):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = randn(g, 1, c, h, w).to(dtype)
        wt = randn(g, co, c, 3, 3) * (9 * c) ** -0.5
        b = bias * randn(g, co)
        sc = 1 + 0.1 * randn(g, c)
        sh = 0.1 * randn(g, c)
        top = torch.relu(randn(g, 1, c, w + 2)).to(dtype)
        left = torch.relu(randn(g, 1, c, h)).to(dtype)
        return x, wt, b, sc, sh, top, left

    def account(name, shape_s, kernel_fn, plain_fn, lib_fn, nbytes, flops, tails=(), count=1,
                into=None, also=None, peak=PEAK_BF16_FLOP_PER_S, old_fn=None, f32_route=False,
                parent_ms=None):
        """Time the kernel, its plain version and the library call (bf16,
        device time from CUDA-graph replay, per call) and add ``count`` calls
        to the kernel's sums: per sub-image without ``tails`` (in ``into``,
        the flagship's table by default, and in ``also`` where another path
        runs the same shape), else per step of each training tail named (a
        shape both tails run goes into both; with ``f32_route``, into the
        f32 routes' tables of the ROUTED kernels).
        ``old_fn``: the same function on the CUDA-core kernel that the
        tensor-core one replaced, timed beside it. ``parent_ms``: the time
        the design this one replaced took at the same shape (recorded, not
        timed here), printed beside it."""
        ms, plain, lib = device_ms(kernel_fn), device_ms(plain_fn), device_ms(lib_fn)
        old = device_ms(old_fn) if old_fn is not None else 0.0
        eager = eager_ms(kernel_fn)
        b = bound_ms(nbytes, flops, peak, PEAK_BYTES_PER_S)
        targets = [(dstats if f32_route else tstats)[t][name] for t in tails] or [(into or stats)[name]]
        for s in targets + ([also[name]] if also is not None else []):
            s["ms"] += count * ms
            s["eager_ms"] += count * eager
            s["plain_ms"] += count * plain
            s["library_ms"] += count * lib
            s["cuda_cores_ms"] += count * old
            s["nbytes"] += count * nbytes
            s["flops"] += count * flops
            s["bound_ms"] += count * b
            s["calls"] += count
        by = "bytes" if nbytes / PEAK_BYTES_PER_S >= flops / peak else "operations"
        per = f", x{count} per step of {' and '.join(TRAIN_PATHS[t][0] for t in tails)}" if tails else ""
        was = f", the CUDA-core kernel {old:.4f} ms" if old_fn is not None else ""
        if parent_ms is not None:
            was += f", the design it replaced {parent_ms:.4f} ms (recorded: {ms / parent_ms:.2f}x)"
        print(f"[time] {name} {shape_s}: kernel {ms:.4f} ms (eager call {eager:.4f} ms), "
              f"bound {b:.4f} ms ({by}), plain {plain:.4f} ms, library {lib:.4f} ms{was}{per}  "
              f"[{card}]")

    def check_dx(name, tag, x, gy, wt, sc, sh, outer, plant=False):
        """K6 or K9 dx (``name``) against its plain version. bf16 runs the
        tensor cores: dx within BF16_TOL of max|ref| and the sums within
        SUM_TOL of the plain version with the route's rounded weights
        (``*_tc_plain``), the unrounded one's distance reported, two calls
        bit-equal, and with ``plant`` (replicate padding) three planted
        faults must fail that check. f32 runs the CUDA cores, held to the
        plain version."""
        k = getattr(kernels, name)
        tc = x.dtype == torch.bfloat16
        route = "tensor cores" if tc else "CUDA cores"
        got = k(x, gy, wt, sc, sh, True, outer)
        ref = getattr(kernels, name + ("_tc_plain" if tc else "_plain"))(x, gy, wt, sc, sh, True,
                                                                         outer)
        compare(name, f"{tag} [{route}]", got[0], ref[0], floor=0.0 if tc else 1.0)
        compare_sum(name, f"d(scale) {tag} [{route}]", got[1], ref[1])
        compare_sum(name, f"d(shift) {tag} [{route}]", got[2], ref[2])
        if not tc:
            if name == "conv3x3_chw_dx":
                check_dx_f32(tag, x, gy, wt, sc, sh, outer, got, ref, plant)
            return
        unrounded = getattr(kernels, name + "_plain")(x, gy, wt, sc, sh, True, outer)
        moved = [float((a.float() - r.float()).abs().max() / r.float().abs().max())
                 for a, r in zip(got, unrounded)]
        print(f"[check] {name} {tag} [tensor cores]: against the plain version without the "
              f"weights' rounding, max abs err / max|ref| dx {moved[0]:.3e} d(scale) "
              f"{moved[1]:.3e} d(shift) {moved[2]:.3e} (reported)")
        again = k(x, gy, wt, sc, sh, True, outer)
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        print(f"[check] {name} {tag} [tensor cores]: two calls {'bit-equal' if same else 'differ'}")
        if not same:
            fail(f"{name} {tag}: two bf16 calls differ")
        if not plant or outer != "replicate":
            return

        def ratio(bad):  # the worst of the check's three errors over their limits
            lims = (BF16_TOL, SUM_TOL, SUM_TOL)
            return max(float((a.float() - r.float()).abs().max()) / (t * float(r.float().abs().max()))
                       for a, r, t in zip(bad, ref, lims))

        no_top = got[0].clone()
        no_top[..., 0, 1:-1] = k(x, gy, wt, sc, sh, True, "constant")[0][..., 0, 1:-1]
        w_ch = wt.clone()
        w_ch[:, int(ref[1].abs().argmax())] *= 1.01
        for fault, bad in (("top fold dropped", (no_top, got[1], got[2])),
                           ("one input channel's weights x 1.01",
                            k(x, gy, w_ch, sc, sh, True, outer)),
                           ("ky<->kx", k(x, gy, wt.transpose(2, 3).contiguous(), sc, sh, True, outer))):
            r_ = ratio(bad)
            print(f"[check] {name} {tag} [tensor cores]: planted {fault}: max abs err / limit "
                  f"{r_:.2f} (must exceed 1)")
            if not r_ > 1.0:
                fail(f"{name} {tag}: the check passes a planted {fault}")

    def check_dx_f32(tag, x, gy, wt, sc, sh, outer, got, ref, plant):
        """K6's float32 route (CUDA cores, csrc/conv3x3_dx_f32.cu) beyond the
        check against its plain version: two calls bit-equal (dx, d(scale),
        d(shift): fixed-order partial sums), and with ``plant`` (replicate
        padding) two planted faults (the top border fold dropped; the
        weights' bottom row of taps dropped, as a kernel skipping a tap row
        would) must read at least F32_PLANT times the check's limit."""
        k = kernels.conv3x3_chw_dx
        tag = f"{tag} [CUDA cores]"
        same = all(torch.equal(a, b_) for a, b_ in zip(got, k(x, gy, wt, sc, sh, True, outer)))
        print(f"[check] conv3x3_chw_dx {tag}: two calls {'bit-equal' if same else 'differ'} "
              "(dx, d(scale), d(shift))")
        if not same:
            fail(f"conv3x3_chw_dx {tag}: two f32 calls differ")
        if not plant or outer != "replicate":
            return

        def ratio(bad):  # the worst of the check's three errors over their limits
            lims = (F32_TOL * max(1.0, float(ref[0].abs().max())),
                    SUM_TOL * float(ref[1].abs().max()), SUM_TOL * float(ref[2].abs().max()))
            return max(float((a - r).abs().max()) / t for a, r, t in zip(bad, ref, lims))

        no_top = got[0].clone()
        no_top[..., 0, 1:-1] = k(x, gy, wt, sc, sh, True, "constant")[0][..., 0, 1:-1]
        w_bad = wt.clone()
        w_bad[:, :, 2] = 0.0
        for fault, bad in (("the top fold dropped", (no_top, got[1], got[2])),
                           ("the bottom row of taps dropped", k(x, gy, w_bad, sc, sh, True, outer))):
            r_ = ratio(bad)
            print(f"[check] conv3x3_chw_dx {tag}: planted {fault}: max abs err / limit {r_:.2f} "
                  f"(must reach {F32_PLANT:g})")
            if not r_ >= F32_PLANT:
                fail(f"conv3x3_chw_dx {tag}: a planted fault ({fault}) reads only {r_:.2f}x the "
                     "limit")

    def check_dw_f32(tag, x, gy, sc, sh, outer, got, ref, plant):
        """K7's float32 route (CUDA cores, csrc/conv3x3_dw_f32.cu) beyond the
        check against its plain version: two calls bit-equal (dW, db:
        fixed-order partial sums), and with ``plant`` (replicate padding)
        three planted faults (one input channel's dW x 1.01; ky and kx
        swapped; the first pixel chunk of the last image dropped, as a block
        skipping it would: g zeroed over the plan's rows x 32 pixels there)
        must read at least F32_PLANT times the check's limit."""
        k = kernels.conv3x3_chw_dw
        tag = f"{tag} [CUDA cores]"
        same = all(torch.equal(a, b_) for a, b_ in zip(got, k(x, gy, sc, sh, True, outer)))
        print(f"[check] conv3x3_chw_dw {tag}: two calls {'bit-equal' if same else 'differ'} "
              "(dW, db)")
        if not same:
            fail(f"conv3x3_chw_dw {tag}: two f32 calls differ")
        if not plant or outer != "replicate":
            return

        def ratio(bad):  # the worse of the check's two errors over their limits
            return max(float((a - r).abs().max()) / (SUM_TOL * float(r.abs().max()))
                       for a, r in zip(bad, ref))

        one = got[0].clone()
        one[:, int(ref[0].abs().amax(dim=(0, 2, 3)).argmax())] *= 1.01
        rows = kernels.conv3x3_dw_f32_plan(*x.shape[:2], gy.shape[1], *x.shape[2:]).rows
        g_bad = gy.clone()
        g_bad[-1, :, :rows, :kernels.CONV3X3_DW_F32_COLS] = 0.0
        for fault, bad in (("one input channel's dW x 1.01", (one, got[1])),
                           ("ky<->kx", (got[0].transpose(2, 3), got[1])),
                           (f"a {rows} x {kernels.CONV3X3_DW_F32_COLS} pixel chunk dropped",
                            k(x, g_bad, sc, sh, True, outer))):
            r_ = ratio(bad)
            print(f"[check] conv3x3_chw_dw {tag}: planted {fault}: max abs err / limit {r_:.2f} "
                  f"(must reach {F32_PLANT:g})")
            if not r_ >= F32_PLANT:
                fail(f"conv3x3_chw_dw {tag}: a planted fault ({fault}) reads only {r_:.2f}x the "
                     "limit")

    def check_updx_f32(tag, x, gy, wt, sc, sh, outer):
        """K9 dx's float32 route (CUDA cores) beyond check_dx: the ReLU off
        against the plain version, two calls bit-equal (dx, d(scale),
        d(shift): fixed-order partial sums), and with replicate padding a
        planted fault (the top border fold dropped) must read at least
        F32_PLANT times the check's limit."""
        k = kernels.upconv3x3_chw_dx
        tag = f"{tag} {outer} [CUDA cores]"
        off = k(x, gy, wt, sc, sh, False, outer)
        ref = kernels.upconv3x3_chw_dx_plain(x, gy, wt, sc, sh, False, outer)
        compare("upconv3x3_chw_dx", f"ReLU off {tag}", off[0], ref[0])
        compare_sum("upconv3x3_chw_dx", f"d(scale) ReLU off {tag}", off[1], ref[1])
        compare_sum("upconv3x3_chw_dx", f"d(shift) ReLU off {tag}", off[2], ref[2])
        got = k(x, gy, wt, sc, sh, True, outer)
        same = all(torch.equal(a, b_) for a, b_ in zip(got, k(x, gy, wt, sc, sh, True, outer)))
        print(f"[check] upconv3x3_chw_dx {tag}: two calls {'bit-equal' if same else 'differ'} "
              "(dx, d(scale), d(shift))")
        if not same:
            fail(f"upconv3x3_chw_dx {tag}: two f32 calls differ")
        if outer != "replicate":
            return
        ref = kernels.upconv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, outer)
        no_top = got[0].clone()
        no_top[..., 0, 1:-1] = k(x, gy, wt, sc, sh, True, "constant")[0][..., 0, 1:-1]
        r_ = float((no_top - ref[0]).abs().max()) / (F32_TOL * max(1.0, float(ref[0].abs().max())))
        print(f"[check] upconv3x3_chw_dx {tag}: planted the top fold dropped: max abs err / limit "
              f"{r_:.2f} (must reach {F32_PLANT:g})")
        if not r_ >= F32_PLANT:
            fail(f"upconv3x3_chw_dx {tag}: a planted dropped fold reads only {r_:.2f}x the limit")

    def check_f32_entry_bf16(tag, x, gy, wt, sc, sh, xs, ws, bs):
        """The CUDA-core entry points of K9 dx and K13's forward take bf16
        too (the bf16 rows time them beside the tensor-core kernels): each
        held to its plain version in bf16 within the bf16 limit."""
        got = kernels._upconv_dx_cuda_cores(x, gy, wt, sc, sh, True, False)
        ref = kernels.upconv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate")
        compare("upconv3x3_chw_dx", f"{tag} through itg_upconv3x3_chw_dx [CUDA cores]", got[0],
                ref[0])
        compare_sum("upconv3x3_chw_dx", f"d(scale) {tag} through itg_upconv3x3_chw_dx", got[1],
                    ref[1])
        compare_sum("upconv3x3_chw_dx", f"d(shift) {tag} through itg_upconv3x3_chw_dx", got[2],
                    ref[2])
        compare("stem_fwd", f"{tag} through itg_stem_fwd [CUDA cores]",
                kernels._stem_fwd_cuda_cores(xs, ws, bs), kernels.stem_fwd_plain(xs, ws, bs))

    def check_dw(tag, x, gy, sc, sh, outer, plant=False):
        """K7 against its plain version: dW and db within SUM_TOL of the
        plain version on both routes (bf16 on the tensor cores: its operands
        are bf16 values, so the plain version computes its function); bf16
        two calls bit-equal and, with ``plant`` (replicate padding), three
        planted faults must fail that check."""
        tc = x.dtype == torch.bfloat16
        route = "tensor cores" if tc else "CUDA cores"
        got = kernels.conv3x3_chw_dw(x, gy, sc, sh, True, outer)
        ref = kernels.conv3x3_chw_dw_plain(x, gy, sc, sh, True, outer)
        compare_sum("conv3x3_chw_dw", f"dW {tag} [{route}]", got[0], ref[0])
        compare_sum("conv3x3_chw_dw", f"db {tag} [{route}]", got[1], ref[1])
        if not tc:
            check_dw_f32(tag, x, gy, sc, sh, outer, got, ref, plant)
            return
        again = kernels.conv3x3_chw_dw(x, gy, sc, sh, True, outer)
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        print(f"[check] conv3x3_chw_dw {tag} [tensor cores]: two calls "
              f"{'bit-equal' if same else 'differ'}")
        if not same:
            fail(f"conv3x3_chw_dw {tag}: two bf16 calls differ")
        if not plant or outer != "replicate":
            return

        def ratio(bad):  # the worse of the check's two errors over their limits
            return max(float((a - r).abs().max()) / (SUM_TOL * float(r.abs().max()))
                       for a, r in zip(bad, ref))

        one = got[0].clone()
        one[:, int(ref[0].abs().amax(dim=(0, 2, 3)).argmax())] *= 1.01
        for fault, bad in (("one input channel's dW x 1.01", (one, got[1])),
                           ("ky<->kx", (got[0].transpose(2, 3), got[1])),
                           ("replicate ring as zeros",
                            kernels.conv3x3_chw_dw(x, gy, sc, sh, True, "constant"))):
            r_ = ratio(bad)
            print(f"[check] conv3x3_chw_dw {tag} [tensor cores]: planted {fault}: max abs err / "
                  f"limit {r_:.2f} (must exceed 1)")
            if not r_ > 1.0:
                fail(f"conv3x3_chw_dw {tag}: the check passes a planted {fault}")

    def check_fwd_f32(tag, x, wt, b, sc, sh, top, left, outer, halo, got, ref, plant):
        """K1/K2's float32 route beyond check_fwd: two calls bit-equal (y, Σy,
        Σy² and, with ``halo``, K2 with both borders: fixed-order sums), and
        with ``plant`` (replicate padding) a planted fault (the weights'
        bottom row of taps dropped, as a kernel skipping it would) must read
        at least F32_PLANT times the check's limit."""
        again = kernels.conv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        if halo:
            same = same and torch.equal(
                kernels.conv3x3_chw_halo(x, wt, b, sc, sh, True, outer, top, left),
                kernels.conv3x3_chw_halo(x, wt, b, sc, sh, True, outer, top, left))
        print(f"[check] conv3x3_chw {tag}: two calls {'bit-equal' if same else 'differ'}"
              f"{' (y, Σy, Σy² and K2 with both borders)' if halo else ' (y, Σy, Σy²)'}")
        if not same:
            fail(f"conv3x3_chw {tag}: two f32 calls differ")
        if not plant or outer != "replicate":
            return
        w_bad = wt.clone()
        w_bad[:, :, 2] = 0.0
        bad = kernels.conv3x3_chw(x, w_bad, b, sc, sh, True, outer).float()
        r_ = float((bad - ref.float()).abs().max()) / (F32_TOL * max(1.0, float(ref.abs().max())))
        print(f"[check] conv3x3_chw {tag}: planted the bottom row of taps dropped: max abs err / "
              f"limit {r_:.2f} (must reach {F32_PLANT:g})")
        if not r_ >= F32_PLANT:
            fail(f"conv3x3_chw {tag}: a planted dropped tap row reads only {r_:.2f}x the limit")

    def check_fwd(where, shape_s, x, wt, b, sc, sh, top, left, outer, halo=True, plant=False,
                  f32_plant=None):
        """K1 with K5's sums and, with ``halo``, K2 in its four border cases
        against their plain versions; returns K1's y. bf16 runs the tensor
        cores: y within BF16_TOL of max|ref| of the plain version with the
        route's rounded weights (``*_tc_plain``), the unrounded one's
        distance reported, the sums within SUM_TOL of the plain sums of the
        stored y, two calls bit-equal, and with ``plant`` (replicate padding)
        four planted faults must fail those checks. f32 runs the CUDA
        cores, held to the plain versions, two calls bit-equal, and with
        ``f32_plant`` (``plant`` where not given) a planted fault
        (``check_fwd_f32``)."""
        tc = x.dtype == torch.bfloat16
        tag = f"{where} {shape_s} {outer} [{'tensor cores' if tc else 'CUDA cores'}]"
        plain = kernels.conv3x3_chw_tc_plain if tc else kernels.conv3x3_chw_plain
        halo_plain = kernels.conv3x3_chw_halo_tc_plain if tc else kernels.conv3x3_chw_halo_plain
        floor = 0.0 if tc else 1.0
        ref = plain(x, wt, b, sc, sh, True, outer)
        y, s1, s2 = kernels.conv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
        compare("conv3x3_chw", tag, y, ref, floor=floor)
        s1_ref, s2_ref = y.float().sum(dim=(0, 2, 3)), (y.float() ** 2).sum(dim=(0, 2, 3))
        compare_sum("conv3x3_chw", f"Σy {tag}", s1, s1_ref)
        compare_sum("conv3x3_chw", f"Σy² {tag}", s2, s2_ref)
        for case, (t_, l_) in BORDERS.items() if halo else ():
            tb, lb = (top if t_ else None), (left if l_ else None)
            compare("chw_halo_step", f"{tag} {case}",
                    kernels.conv3x3_chw_halo(x, wt, b, sc, sh, True, outer, tb, lb),
                    halo_plain(x, wt, b, sc, sh, True, outer, tb, lb), floor=floor)
        if not tc:
            check_fwd_f32(tag, x, wt, b, sc, sh, top, left, outer, halo, (y, s1, s2), ref,
                          plant if f32_plant is None else f32_plant)
            return y
        unrounded = kernels.conv3x3_chw_plain(x, wt, b, sc, sh, True, outer).float()
        moved = float((y.float() - unrounded).abs().max() / unrounded.abs().max())
        print(f"[check] conv3x3_chw {tag}: against the plain version without the weights' "
              f"rounding, max abs err / max|ref| {moved:.3e} (reported)")
        again = kernels.conv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
        same = all(torch.equal(a, b_) for a, b_ in zip((y, s1, s2), again))
        if halo:
            same = same and torch.equal(
                kernels.conv3x3_chw_halo(x, wt, b, sc, sh, True, outer, top, left),
                kernels.conv3x3_chw_halo(x, wt, b, sc, sh, True, outer, top, left))
        print(f"[check] conv3x3_chw {tag}: two calls {'bit-equal' if same else 'differ'}"
              f"{' (y, Σy, Σy² and K2 with both borders)' if halo else ' (y, Σy, Σy²)'}")
        if not same:
            fail(f"conv3x3_chw {tag}: two bf16 calls differ")
        if not plant or outer != "replicate":
            return y

        def ratio(bad, r, tol=BF16_TOL):  # max abs err over the check's limit
            r = r.float()
            return float((bad.float() - r).abs().max()) / (tol * float(r.abs().max()))

        s2_bad = s2.clone()
        s2_bad[int(s2.abs().argmax())] *= 1.01
        halo_ref = halo_plain(x, wt, b, sc, sh, True, outer, top, left)
        for fault, r_ in (
                ("ky<->kx in the weights",
                 ratio(kernels.conv3x3_chw(x, wt.transpose(2, 3).contiguous(), b, sc, sh, True,
                                           outer), ref)),
                ("the replicate ring taken as zeros",
                 ratio(kernels.conv3x3_chw(x, wt, b, sc, sh, True, "constant"), ref)),
                ("K2 ignoring its cached top row (the own edge in its place)",
                 ratio(kernels.conv3x3_chw_halo(x, wt, b, sc, sh, True, outer, None, left),
                       halo_ref)),
                ("one channel's Σy² x 1.01", ratio(s2_bad, s2_ref, SUM_TOL))):
            print(f"[check] conv3x3_chw {tag}: planted {fault}: max abs err / limit {r_:.2f} "
                  "(must exceed 1)")
            if not r_ > 1.0:
                fail(f"conv3x3_chw {tag}: the check passes a planted {fault}")
        return y

    def k9_sums_ratio(y, s1, s2):
        """K9's float32 Σy and Σy² against float64 sums of the stored y: the
        worse of the two errors over its limit (K9_SUM_TOL of Σ|y| or Σy²),
        channel by channel."""
        yd = y.double()
        return max(float(((got.double() - v.sum(dim=(0, 2, 3))).abs()
                          / (K9_SUM_TOL * v.abs().sum(dim=(0, 2, 3)))).max())
                   for got, v in ((s1, yd), (s2, yd * yd)))

    def check_up_f32(tag, x, wt, b, sc, sh, top, left, outer, halo, got, ref, plant):
        """K9/K14's float32 route (CUDA cores, csrc/upconv_fwd_f32.cu) beyond
        the check against its plain version: Σy and Σy² against float64 sums
        of the stored y (k9_sums_ratio), two calls bit-equal (y, Σy, Σy², y
        without the sums and, with ``halo``, K14 with both borders:
        fixed-order sums), and with ``plant`` (replicate padding) four planted
        faults (slot (1, 1) of phase (0, 0) skipped; ky and kx swapped; the
        first tile's Σy partial dropped; K14 reading its cached top row as
        the own edge, on borders drawn here where the path has none) must
        read at least F32_PLANT times the check's limit."""
        y, s1, s2 = got
        k = kernels.upconv3x3_chw
        r_sum = k9_sums_ratio(y, s1, s2)
        print(f"[check] upconv3x3_chw {tag}: Σy, Σy² against float64 sums of the stored y: max "
              f"abs err / limit {r_sum:.3f} (limit {K9_SUM_TOL:g} of Σ|y|, Σy²)")
        if not r_sum <= 1.0:
            fail(f"upconv3x3_chw {tag}: f32 sums {r_sum:.3f}x their float64 limit")
        again = k(x, wt, b, sc, sh, True, outer, want_stats=True)
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        same = same and torch.equal(y, k(x, wt, b, sc, sh, True, outer))
        if halo:
            same = same and torch.equal(
                kernels.upconv3x3_chw_halo(x, wt, b, sc, sh, True, outer, top, left),
                kernels.upconv3x3_chw_halo(x, wt, b, sc, sh, True, outer, top, left))
        print(f"[check] upconv3x3_chw {tag}: two calls {'bit-equal' if same else 'differ'} (y, "
              f"Σy, Σy², y without the sums{', K14 with both borders' if halo else ''})")
        if not same:
            fail(f"upconv3x3_chw {tag}: two f32 calls differ")
        if not plant or outer != "replicate":
            return

        def ratio(bad, r):  # max abs err over the f32 check's limit
            return float((bad - r).abs().max()) / (F32_TOL * max(1.0, float(r.abs().max())))

        n_, c, h, w = x.shape
        co = wt.shape[0]
        if top is None:
            g_ = torch.Generator(device=dev).manual_seed(977)
            top, left = torch.relu(randn(g_, n_, c, w + 2)), torch.relu(randn(g_, n_, c, h))
        a_pad = F.pad(kernels.prenorm(x, sc, sh, True), (1, 1, 1, 1), mode="replicate")
        wc = kernels._upconv_phase_weights(wt).reshape(co, c, 2, 2, 2, 2)
        skipped = y.clone()
        skipped[..., 0::2, 0::2] -= F.conv2d(a_pad[:, :, 1 : h + 1, 1 : w + 1],
                                             wc[:, :, 0, 0, 1, 1, None, None])
        # the first tile: 8 x 32 half-res pixels of image 0, 16 x 64 of y
        s1_bad = s1.double() - y[0, :, :16, :64].double().sum(dim=(1, 2))
        for fault, r_ in (
                ("slot (1, 1) of phase (0, 0) skipped", ratio(skipped, ref)),
                ("ky<->kx (phases (0, 1) and (1, 0) swap taps)",
                 ratio(k(x, wt.transpose(2, 3).contiguous(), b, sc, sh, True, outer), ref)),
                ("the first tile's Σy partial dropped", k9_sums_ratio(y, s1_bad, s2)),
                ("K14 reading its cached top row as the own edge",
                 ratio(kernels.upconv3x3_chw_halo(x, wt, b, sc, sh, True, outer, None, left),
                       kernels.upconv3x3_chw_halo_plain(x, wt, b, sc, sh, True, outer, top,
                                                        left)))):
            print(f"[check] upconv3x3_chw {tag}: planted {fault}: max abs err / limit {r_:.2f} "
                  f"(must reach {F32_PLANT:g})")
            if not r_ >= F32_PLANT:
                fail(f"upconv3x3_chw {tag}: a planted {fault} reads only {r_:.2f}x the limit")

    def check_up(where, shape_s, x, wt, b, sc, sh, top, left, outer, halo=True, with_stats=False,
                 plant=False, f32_plant=None):
        """K9's forward (with its sums where ``with_stats``) and, with
        ``halo``, K14 in its four border cases against their plain versions.
        bf16 runs the tensor cores: y within BF16_TOL of max|ref| of the plain
        version with the combined weights rounded to bf16 (``*_tc_plain``), the
        unrounded one's distance reported, the sums within SUM_TOL of the plain
        sums of the stored y, two calls bit-equal (y, the sums, the call
        without sums, K14), and with ``plant`` (replicate padding) four planted
        faults (three without ``halo``) must read at least UP_PLANT times the
        limit. f32 runs the CUDA cores, held to the plain versions, the sums
        to float64 ones, two calls bit-equal, and with ``f32_plant``
        (``plant`` where not given) four planted faults (``check_up_f32``)."""
        tc = x.dtype == torch.bfloat16
        tag = f"{where} {shape_s} {outer} [{'tensor cores' if tc else 'CUDA cores'}]"
        plain = kernels.upconv3x3_chw_tc_plain if tc else kernels.upconv3x3_chw_plain
        halo_plain = kernels.upconv3x3_chw_halo_tc_plain if tc else kernels.upconv3x3_chw_halo_plain
        floor = 0.0 if tc else 1.0
        ref = plain(x, wt, b, sc, sh, True, outer)
        y, s1, s2 = kernels.upconv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
        compare("upconv3x3_chw", tag, y, ref, floor=floor)
        if with_stats:
            compare_sum("upconv3x3_chw", f"Σy {tag}", s1, y.float().sum(dim=(0, 2, 3)))
            compare_sum("upconv3x3_chw", f"Σy² {tag}", s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
        for case, (t_, l_) in BORDERS.items() if halo else ():
            tb, lb = (top if t_ else None), (left if l_ else None)
            compare("chw_upconv_halo_step", f"{tag} {case}",
                    kernels.upconv3x3_chw_halo(x, wt, b, sc, sh, True, outer, tb, lb),
                    halo_plain(x, wt, b, sc, sh, True, outer, tb, lb), floor=floor)
        if not tc:
            check_up_f32(tag, x, wt, b, sc, sh, top, left, outer, halo, (y, s1, s2), ref,
                         plant if f32_plant is None else f32_plant)
            return
        unrounded = kernels.upconv3x3_chw_plain(x, wt, b, sc, sh, True, outer).float()
        moved = float((y.float() - unrounded).abs().max() / unrounded.abs().max())
        print(f"[check] upconv3x3_chw {tag}: against the plain version without the combined "
              f"weights' rounding, max abs err / max|ref| {moved:.3e} (reported)")
        again = kernels.upconv3x3_chw(x, wt, b, sc, sh, True, outer, want_stats=True)
        same = all(torch.equal(a, b_) for a, b_ in zip((y, s1, s2), again))
        same = same and torch.equal(y, kernels.upconv3x3_chw(x, wt, b, sc, sh, True, outer))
        if halo:
            same = same and torch.equal(
                kernels.upconv3x3_chw_halo(x, wt, b, sc, sh, True, outer, top, left),
                kernels.upconv3x3_chw_halo(x, wt, b, sc, sh, True, outer, top, left))
        print(f"[check] upconv3x3_chw {tag}: two calls {'bit-equal' if same else 'differ'} (y, "
              f"Σy, Σy², y without the sums{', K14 with both borders' if halo else ''})")
        if not same:
            fail(f"upconv3x3_chw {tag}: two bf16 calls differ")
        if not plant or outer != "replicate":
            return
        c, co, h, w = x.shape[1], wt.shape[0], x.shape[2], x.shape[3]
        a_pad = F.pad(kernels.prenorm(x, sc, sh, True).float(), (1, 1, 1, 1), mode="replicate")
        wc = kernels._upconv_phase_weights(wt).to(torch.bfloat16).float().reshape(co, c, 2, 2, 2, 2)
        skipped = y.float()
        skipped[..., 0::2, 0::2] -= F.conv2d(a_pad[:, :, 1 : h + 1, 1 : w + 1],
                                             wc[:, :, 0, 0, 1, 1, None, None])
        plants = [("ky<->kx (phases (0, 1) and (1, 0) swap taps)",
                   kernels.upconv3x3_chw(x, wt.transpose(2, 3).contiguous(), b, sc, sh, True, outer),
                   ref),
                  ("slot (1, 1) of phase (0, 0) skipped", skipped, ref),
                  ("the bias dropped",
                   kernels.upconv3x3_chw(x, wt, torch.zeros_like(b), sc, sh, True, outer), ref)]
        if halo:
            plants.append(("K14 reading its cached top row as the own edge",
                           kernels.upconv3x3_chw_halo(x, wt, b, sc, sh, True, outer, None, left),
                           halo_plain(x, wt, b, sc, sh, True, outer, top, left)))
        for fault, bad, r in plants:
            r_ = float((bad.float() - r.float()).abs().max()) / (BF16_TOL * float(r.float().abs().max()))
            print(f"[check] upconv3x3_chw {tag}: planted {fault}: max abs err / limit {r_:.2f} "
                  f"(must reach {UP_PLANT:g})")
            if not r_ >= UP_PLANT:
                fail(f"upconv3x3_chw {tag}: a planted {fault} reads only {r_:.2f}x the limit")

    def check_stem(tag, x, wt, b):
        """K13's forward against its plain version. bf16 runs the tensor
        cores: y within BF16_TOL of max|ref| of the plain version with w and
        b rounded to bf16 (``stem_fwd_tc_plain``), the unrounded one's
        distance reported, two calls bit-equal, and four planted faults must
        read at least STEM_PLANT times that limit. f32 runs the CUDA cores,
        held to the plain version, two calls bit-equal, and a planted fault
        (the bottom row of taps, ky = 3, dropped) must read at least
        F32_PLANT times that limit."""
        tc = x.dtype == torch.bfloat16
        tag = f"{tag} [{'tensor cores' if tc else 'CUDA cores'}]"
        y = kernels.stem_fwd(x, wt, b)
        ref = (kernels.stem_fwd_tc_plain if tc else kernels.stem_fwd_plain)(x, wt, b)
        compare("stem_fwd", tag, y, ref, floor=0.0 if tc else 1.0)
        if not tc:
            same = torch.equal(y, kernels.stem_fwd(x, wt, b))
            print(f"[check] stem_fwd {tag}: two calls {'bit-equal' if same else 'differ'}")
            if not same:
                fail(f"stem_fwd {tag}: two f32 calls differ")
            no_row = wt.clone()
            no_row[:, :, 3] = 0.0
            limit = F32_TOL * max(1.0, float(ref.abs().max()))
            r_ = float((kernels.stem_fwd(x, no_row, b) - ref).abs().max()) / limit
            print(f"[check] stem_fwd {tag}: planted the bottom row of taps dropped: max abs err / "
                  f"limit {r_:.2f} (must reach {F32_PLANT:g})")
            if not r_ >= F32_PLANT:
                fail(f"stem_fwd {tag}: a planted dropped tap row reads only {r_:.2f}x the limit")
            return
        unrounded = kernels.stem_fwd_plain(x, wt, b).float()
        moved = float((y.float() - unrounded).abs().max() / unrounded.abs().max())
        print(f"[check] stem_fwd {tag}: against the plain version without the rounding of w and "
              f"b, max abs err / max|ref| {moved:.3e} (reported)")
        same = torch.equal(y, kernels.stem_fwd(x, wt, b))
        print(f"[check] stem_fwd {tag}: two calls {'bit-equal' if same else 'differ'}")
        if not same:
            fail(f"stem_fwd {tag}: two bf16 calls differ")
        limit = BF16_TOL * float(ref.float().abs().max())
        skip = wt.clone()
        skip[:, 0] = 0.0
        edge = kernels.stem_fwd(F.pad(x, (2, 2, 2, 2), mode="replicate"), wt, b)[:, 1:-1, 1:-1]
        for fault, bad in (("ky<->kx", kernels.stem_fwd(x, wt.transpose(2, 3).contiguous(), b)),
                           ("the bias dropped", kernels.stem_fwd(x, wt, torch.zeros_like(b))),
                           ("the zero border read as the edge pixel", edge),
                           ("one k16 step (input channel 0's taps) skipped",
                            kernels.stem_fwd(x, skip, b))):
            r_ = float((bad.float() - ref.float()).abs().max()) / limit
            print(f"[check] stem_fwd {tag}: planted {fault}: max abs err / limit {r_:.2f} (must "
                  f"reach {STEM_PLANT:g})")
            if not r_ >= STEM_PLANT:
                fail(f"stem_fwd {tag}: a planted {fault} reads only {r_:.2f}x the limit")

    def check_1x1(where, shape_s, x, wt, b, res=None, stats=False, plant=False):
        """K3 (``conv1x1_chw_add``; without ``res`` the plain shortcut or the
        dx form) against its plain version. bf16 runs the tensor cores: y
        within BF16_TOL of max|ref| of the plain version with W and b rounded
        to bf16 (``conv1x1_chw_tc_plain``) and each y within its own limit
        (``k3_limits``), the unrounded one's distance reported, with ``stats``
        the sums within SUM_TOL of the plain sums of the stored y, two calls
        bit-equal, and with ``plant`` up to five planted faults (one input
        channel's weights x 1.01, the bias dropped, the residual dropped,
        one k16 step skipped, one channel's Σy² x 1.01) must read at least
        K3_PLANT times their limits. f32 runs the CUDA cores, held to the
        plain version."""
        tc = x.dtype == torch.bfloat16
        tag = (f"{where} {shape_s}{' +res' if res is not None else ''}{' +stats' if stats else ''} "
               f"[{'tensor cores' if tc else 'CUDA cores'}]")
        out = kernels.conv1x1_chw_add(x, wt, b, res, want_stats=stats)
        got = out if stats else (out,)
        y = got[0]
        ref = (kernels.conv1x1_chw_tc_plain if tc else kernels.conv1x1_chw_plain)(x, wt, b, res)
        compare("conv1x1_chw", tag, y, ref, floor=0.0 if tc else 1.0)
        if stats:
            s2_ref = (y.float() ** 2).sum(dim=(0, 2, 3))
            compare_sum("conv1x1_chw", f"Σy {tag}", got[1], y.float().sum(dim=(0, 2, 3)))
            compare_sum("conv1x1_chw", f"Σy² {tag}", got[2], s2_ref)
        if not tc:
            return
        lim = k3_limits(x, wt, b, res, ref)

        def ratio(bad):  # the worst output's error over its own limit
            return float(((bad.float() - ref.float()).abs() / lim).max())

        worst = ratio(y)
        print(f"[check] conv1x1_chw {tag}: each y within its own limit (a bf16 step of its "
              f"reference value + the f32 reorder bound): worst err / limit {worst:.3f}")
        if not worst <= 1.0:
            fail(f"conv1x1_chw {tag}: an output is {worst:.3f}x its own limit")
        unrounded = kernels.conv1x1_chw_plain(x, wt, b, res).float()
        moved = float((y.float() - unrounded).abs().max() / unrounded.abs().max())
        print(f"[check] conv1x1_chw {tag}: against the plain version without the rounding of W "
              f"and b, max abs err / max|ref| {moved:.3e} (reported)")
        again = kernels.conv1x1_chw_add(x, wt, b, res, want_stats=stats)
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again if stats else (again,)))
        print(f"[check] conv1x1_chw {tag}: two calls {'bit-equal' if same else 'differ'}")
        if not same:
            fail(f"conv1x1_chw {tag}: two bf16 calls differ")
        if not plant:
            return
        w_ch = wt.clone()
        w_ch[:, int(wt.reshape(wt.shape[0], -1).abs().amax(dim=0).argmax())] *= 1.01
        skip = wt.clone()
        skip[:, :16] = 0
        plants = [("one input channel's weights x 1.01 (the column of the largest weight)",
                   ratio(kernels.conv1x1_chw_add(x, w_ch, b, res))),
                  ("the bias dropped", ratio(kernels.conv1x1_chw_add(x, wt, 0 * b, res))),
                  ("one k16 step (input channels 0-15) skipped",
                   ratio(kernels.conv1x1_chw_add(x, skip, b, res)))]
        if res is not None:
            plants.append(("the residual dropped", ratio(kernels.conv1x1_chw(x, wt, b))))
        if stats:
            s2_bad = got[2].clone()
            s2_bad[int(s2_bad.abs().argmax())] *= 1.01
            plants.append(("one channel's Σy² x 1.01", float((s2_bad - s2_ref).abs().max())
                           / (SUM_TOL * float(s2_ref.abs().max()))))
        for fault, r_ in plants:
            print(f"[check] conv1x1_chw {tag}: planted {fault}: max err / limit {r_:.2f} (must "
                  f"reach {K3_PLANT:g})")
            if not r_ >= K3_PLANT:
                fail(f"conv1x1_chw {tag}: a planted {fault} reads only {r_:.2f}x the limit")

    def check_1x1_dw_f32(tag, x, gy, got, ref, plant):
        """K3-dW's float32 route beyond check_1x1_dw: two calls bit-equal (dW,
        db: fixed-order partial sums), and with ``plant`` a planted fault
        (the last pixel chunk of each image dropped, as a kernel skipping
        it would) must read at least F32_PLANT times the limit."""
        same = all(torch.equal(a, b_) for a, b_ in zip(got, kernels.conv1x1_chw_dw(x, gy)))
        print(f"[check] conv1x1_chw_dw {tag}: two calls {'bit-equal' if same else 'differ'} "
              "(dW, db)")
        if not same:
            fail(f"conv1x1_chw_dw {tag}: two f32 calls differ")
        if not plant:
            return
        chunk = kernels.CONV1X1_DW_F32_CHUNK
        keep = (x.shape[2] * x.shape[3] - 1) // chunk * chunk
        x_bad, g_bad = x.clone(), gy.clone()
        x_bad.flatten(2)[..., keep:] = 0.0
        g_bad.flatten(2)[..., keep:] = 0.0
        bad = kernels.conv1x1_chw_dw(x_bad, g_bad)
        r_ = max(float((a - r).abs().max()) / (SUM_TOL * float(r.abs().max()))
                 for a, r in zip(bad, ref))
        print(f"[check] conv1x1_chw_dw {tag}: planted the last {chunk}-pixel chunk of each image "
              f"dropped: max abs err / limit {r_:.2f} (must reach {F32_PLANT:g})")
        if not r_ >= F32_PLANT:
            fail(f"conv1x1_chw_dw {tag}: a planted dropped chunk reads only {r_:.2f}x the limit")

    def check_f32_edges(seed):
        """K1/K2's and K3-dW's float32 routes off the path's shapes: K1 with
        K5's sums at odd H and W (ragged tiles, element copies), zeros
        padding, the ReLU off and odd Co, K2 in its four border cases, two
        calls bit-equal; K3-dW at an odd HW (element copies), its widest
        thread grid (C = 53, Co = 43) and one-channel sides, two calls
        bit-equal; K6 and K7 at odd H and W, one row, channels split over
        K7's grid, both paddings and the ReLU off, two calls bit-equal; all
        four C entry points in bf16. K9's forward (with its sums and K14 in
        its four border cases) and K9 dW at odd H, W, C and Co, both
        paddings, the ReLU off, channels just past the planner's tiles (more
        than 4 groups a block; past 52 input and 32 output channels on dW),
        one-channel sides and a --G_ch of 64 (its fused tail), two calls
        bit-equal; both C entry points in bf16."""
        g_ = torch.Generator(device=dev).manual_seed(seed)
        for n_, c_, co_, h_, w_, outer, relu in ((2, 11, 7, 13, 45, "constant", False),
                                                 (2, 5, 3, 17, 33, "replicate", False),
                                                 (1, 13, 13, 9, 7, "constant", True),
                                                 (3, 26, 3, 40, 64, "replicate", True)):
            x = randn(g_, n_, c_, h_, w_)
            wt = randn(g_, co_, c_, 3, 3) * (9 * c_) ** -0.5
            b, sc, sh = 0.1 * randn(g_, co_), 1 + 0.1 * randn(g_, c_), 0.1 * randn(g_, c_)
            top = torch.relu(randn(g_, n_, c_, w_ + 2))
            left = torch.relu(randn(g_, n_, c_, h_))
            tag = f"({n_}, {c_}->{co_}, {h_}x{w_}) {outer} ReLU {'on' if relu else 'off'} [CUDA cores]"
            got = kernels.conv3x3_chw(x, wt, b, sc, sh, relu, outer, want_stats=True)
            compare("conv3x3_chw", tag, got[0], kernels.conv3x3_chw_plain(x, wt, b, sc, sh, relu,
                                                                          outer))
            compare_sum("conv3x3_chw", f"Σy {tag}", got[1], got[0].sum(dim=(0, 2, 3)))
            compare_sum("conv3x3_chw", f"Σy² {tag}", got[2], (got[0] ** 2).sum(dim=(0, 2, 3)))
            same = all(torch.equal(a, b_) for a, b_ in zip(
                got, kernels.conv3x3_chw(x, wt, b, sc, sh, relu, outer, want_stats=True)))
            for case, (t_, l_) in BORDERS.items():
                tb, lb = (top if t_ else None), (left if l_ else None)
                y2 = kernels.conv3x3_chw_halo(x, wt, b, sc, sh, relu, outer, tb, lb)
                compare("chw_halo_step", f"{tag} {case}", y2,
                        kernels.conv3x3_chw_halo_plain(x, wt, b, sc, sh, relu, outer, tb, lb))
                same = same and torch.equal(
                    y2, kernels.conv3x3_chw_halo(x, wt, b, sc, sh, relu, outer, tb, lb))
            print(f"[check] conv3x3_chw {tag}: two calls {'bit-equal' if same else 'differ'} "
                  "(y, Σy, Σy², K2 in its four border cases)")
            if not same:
                fail(f"conv3x3_chw {tag}: two f32 calls differ")
        for n_, c_, co_, h_, w_ in ((3, 52, 26, 13, 45), (2, 53, 43, 10, 10), (2, 1, 95, 8, 8),
                                    (2, 95, 1, 9, 9)):
            x, gy = randn(g_, n_, c_, h_, w_), randn(g_, n_, co_, h_, w_)
            tag = f"({n_}, {c_}->{co_}, {h_}x{w_}) [CUDA cores]"
            got = kernels.conv1x1_chw_dw(x, gy)
            ref = kernels.conv1x1_chw_dw_plain(x, gy)
            compare_sum("conv1x1_chw_dw", f"dW {tag}", got[0], ref[0])
            compare_sum("conv1x1_chw_dw", f"db {tag}", got[1], ref[1])
            check_1x1_dw_f32(tag, x, gy, got, ref, False)
        # the CUDA-core entry points take bf16 too (timed beside the tensor cores)
        x = randn(g_, 2, 26, 24, 40).bfloat16()
        wt = randn(g_, 13, 26, 3, 3) * 234 ** -0.5
        b, sc, sh = 0.1 * randn(g_, 13), 1 + 0.1 * randn(g_, 26), 0.1 * randn(g_, 26)
        compare("conv3x3_chw", "bf16 (2, 26->13, 24x40) through itg_conv3x3_chw [CUDA cores]",
                kernels._fwd_cuda_cores(x, wt, b, sc, sh, True, False, None, None)[0],
                kernels.conv3x3_chw_plain(x, wt, b, sc, sh, True, "replicate"))
        gy = randn(g_, 2, 13, 24, 40).bfloat16()
        dw_ = kernels._conv1x1_dw_cuda_cores(x, gy)
        ref = kernels.conv1x1_chw_dw_plain(x, gy)
        compare_sum("conv1x1_chw_dw", "dW bf16 (2, 26->13, 24x40) through itg_conv1x1_chw_dw",
                    dw_[0], ref[0])
        compare_sum("conv1x1_chw_dw", "db bf16 (2, 26->13, 24x40) through itg_conv1x1_chw_dw",
                    dw_[1], ref[1])
        # K6 and K7: odd H and W, one row, channels split over K7's grid (C >
        # 52, Co > 27), both paddings, the ReLU off; then bf16 through the
        # C entry points
        for n_, c_, co_, h_, w_, outer, relu in ((2, 5, 7, 33, 47, "constant", False),
                                                 (1, 13, 3, 1, 5, "replicate", True),
                                                 (3, 26, 13, 17, 64, "replicate", False),
                                                 (1, 60, 30, 9, 40, "constant", True)):
            x, gy = randn(g_, n_, c_, h_, w_), randn(g_, n_, co_, h_, w_)
            wt = randn(g_, co_, c_, 3, 3) * (9 * c_) ** -0.5
            sc, sh = 1 + 0.1 * randn(g_, c_), 0.1 * randn(g_, c_)
            tag = f"({n_}, {c_}->{co_}, {h_}x{w_}) {outer} ReLU {'on' if relu else 'off'} [CUDA cores]"
            got = kernels.conv3x3_chw_dx(x, gy, wt, sc, sh, relu, outer)
            ref = kernels.conv3x3_chw_dx_plain(x, gy, wt, sc, sh, relu, outer)
            compare("conv3x3_chw_dx", tag, got[0], ref[0])
            compare_sum("conv3x3_chw_dx", f"d(scale) {tag}", got[1], ref[1])
            compare_sum("conv3x3_chw_dx", f"d(shift) {tag}", got[2], ref[2])
            got_w = kernels.conv3x3_chw_dw(x, gy, sc, sh, relu, outer)
            ref_w = kernels.conv3x3_chw_dw_plain(x, gy, sc, sh, relu, outer)
            compare_sum("conv3x3_chw_dw", f"dW {tag}", got_w[0], ref_w[0])
            compare_sum("conv3x3_chw_dw", f"db {tag}", got_w[1], ref_w[1])
            same = all(torch.equal(a, b_) for a, b_ in zip(
                got + got_w, kernels.conv3x3_chw_dx(x, gy, wt, sc, sh, relu, outer)
                + kernels.conv3x3_chw_dw(x, gy, sc, sh, relu, outer)))
            print(f"[check] conv3x3_chw_dx / conv3x3_chw_dw {tag}: two calls "
                  f"{'bit-equal' if same else 'differ'} (dx, d(scale), d(shift), dW, db)")
            if not same:
                fail(f"conv3x3_chw_dx / conv3x3_chw_dw {tag}: two f32 calls differ")
        x, gy = randn(g_, 2, 26, 24, 40).bfloat16(), randn(g_, 2, 13, 24, 40).bfloat16()
        wt = randn(g_, 13, 26, 3, 3) * 234 ** -0.5
        sc, sh = 1 + 0.1 * randn(g_, 26), 0.1 * randn(g_, 26)
        got = kernels._dx_cuda_cores(x, gy, wt, sc, sh, True, False)
        ref = kernels.conv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate")
        compare("conv3x3_chw_dx", "bf16 (2, 26->13, 24x40) through itg_conv3x3_chw_dx [CUDA cores]",
                got[0], ref[0])
        compare_sum("conv3x3_chw_dx", "d(scale) bf16 (2, 26->13, 24x40) through itg_conv3x3_chw_dx",
                    got[1], ref[1])
        compare_sum("conv3x3_chw_dx", "d(shift) bf16 (2, 26->13, 24x40) through itg_conv3x3_chw_dx",
                    got[2], ref[2])
        got = kernels._dw_cuda_cores(x, gy, sc, sh, True, False)
        ref = kernels.conv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate")
        compare_sum("conv3x3_chw_dw", "dW bf16 (2, 26->13, 24x40) through itg_conv3x3_chw_dw",
                    got[0], ref[0])
        compare_sum("conv3x3_chw_dw", "db bf16 (2, 26->13, 24x40) through itg_conv3x3_chw_dw",
                    got[1], ref[1])
        # K9's forward (with its sums and K14) and K9 dW: odd H, W, C and Co,
        # both paddings, the ReLU off, Co 37 (19 groups of 2: five chunks) and
        # C 53 / Co 33 (dW's channel blocks), one-channel sides, then --G_ch
        # 64's fused tail (64 -> 32 at 96^2 and 32 -> 16 at 192^2 in training,
        # 128 -> 64 at 48^2 at eval); half-res shapes
        for n_, c_, co_, h_, w_, outer, relu in ((2, 11, 7, 13, 45, "constant", False),
                                                 (1, 5, 3, 17, 33, "replicate", False),
                                                 (8, 17, 37, 40, 64, "replicate", True),
                                                 (2, 53, 33, 10, 40, "constant", True),
                                                 (2, 1, 5, 6, 33, "replicate", True),
                                                 (2, 6, 1, 7, 8, "constant", False),
                                                 (8, 64, 32, 96, 96, "replicate", True),
                                                 (8, 32, 16, 192, 192, "replicate", True),
                                                 (1, 128, 64, 48, 48, "constant", True)):
            x = randn(g_, n_, c_, h_, w_)
            wt = randn(g_, co_, c_, 3, 3) * (9 * c_) ** -0.5
            b, sc, sh = 0.1 * randn(g_, co_), 1 + 0.1 * randn(g_, c_), 0.1 * randn(g_, c_)
            top = torch.relu(randn(g_, n_, c_, w_ + 2))
            left = torch.relu(randn(g_, n_, c_, h_))
            gy = randn(g_, n_, co_, 2 * h_, 2 * w_)
            tag = (f"({n_}, {c_}->{co_}, {h_}x{w_} -> {2 * h_}x{2 * w_}) {outer} ReLU "
                   f"{'on' if relu else 'off'} [CUDA cores]")
            got = kernels.upconv3x3_chw(x, wt, b, sc, sh, relu, outer, want_stats=True)
            compare("upconv3x3_chw", tag, got[0],
                    kernels.upconv3x3_chw_plain(x, wt, b, sc, sh, relu, outer))
            r_sum = k9_sums_ratio(*got)
            print(f"[check] upconv3x3_chw {tag}: Σy, Σy² against float64 sums of the stored y: "
                  f"max abs err / limit {r_sum:.3f}")
            if not r_sum <= 1.0:
                fail(f"upconv3x3_chw {tag}: f32 sums {r_sum:.3f}x their float64 limit")
            again = list(kernels.upconv3x3_chw(x, wt, b, sc, sh, relu, outer, want_stats=True))
            for case, (t_, l_) in BORDERS.items():
                tb, lb = (top if t_ else None), (left if l_ else None)
                y14 = kernels.upconv3x3_chw_halo(x, wt, b, sc, sh, relu, outer, tb, lb)
                compare("chw_upconv_halo_step", f"{tag} {case}", y14,
                        kernels.upconv3x3_chw_halo_plain(x, wt, b, sc, sh, relu, outer, tb, lb))
                got += (y14,)
                again.append(kernels.upconv3x3_chw_halo(x, wt, b, sc, sh, relu, outer, tb, lb))
            got_w = kernels.upconv3x3_chw_dw(x, gy, sc, sh, relu, outer)
            ref_w = kernels.upconv3x3_chw_dw_plain(x, gy, sc, sh, relu, outer)
            compare_sum("upconv3x3_chw_dw", f"dW {tag}", got_w[0], ref_w[0])
            compare_sum("upconv3x3_chw_dw", f"db {tag}", got_w[1], ref_w[1])
            again += kernels.upconv3x3_chw_dw(x, gy, sc, sh, relu, outer)
            same = all(torch.equal(a, b_) for a, b_ in zip(got + got_w, again))
            print(f"[check] upconv3x3_chw / upconv3x3_chw_dw {tag}: two calls "
                  f"{'bit-equal' if same else 'differ'} (y, Σy, Σy², K14 in its four border "
                  "cases, dW, db)")
            if not same:
                fail(f"upconv3x3_chw / upconv3x3_chw_dw {tag}: two f32 calls differ")
            del x, gy, got, again, got_w, ref_w
        x, gy = randn(g_, 2, 26, 24, 40).bfloat16(), randn(g_, 2, 13, 48, 80).bfloat16()
        wt = randn(g_, 13, 26, 3, 3) * 234 ** -0.5
        b, sc, sh = 0.1 * randn(g_, 13), 1 + 0.1 * randn(g_, 26), 0.1 * randn(g_, 26)
        top = torch.relu(randn(g_, 2, 26, 42)).bfloat16()
        left = torch.relu(randn(g_, 2, 26, 24)).bfloat16()
        got = kernels._upconv_cuda_cores(x, wt, b, sc, sh, True, False, None, None, True)
        compare("upconv3x3_chw", "bf16 (2, 26->13, 24x40) through itg_upconv3x3_chw [CUDA cores]",
                got[0], kernels.upconv3x3_chw_plain(x, wt, b, sc, sh, True, "replicate"))
        compare_sum("upconv3x3_chw", "Σy bf16 (2, 26->13, 24x40) through itg_upconv3x3_chw",
                    got[1], got[0].float().sum(dim=(0, 2, 3)))
        compare_sum("upconv3x3_chw", "Σy² bf16 (2, 26->13, 24x40) through itg_upconv3x3_chw",
                    got[2], (got[0].float() ** 2).sum(dim=(0, 2, 3)))
        compare("chw_upconv_halo_step",
                "bf16 (2, 26->13, 24x40) both borders through itg_upconv3x3_chw [CUDA cores]",
                kernels._upconv_cuda_cores(x, wt, b, sc, sh, True, False, top, left)[0],
                kernels.upconv3x3_chw_halo_plain(x, wt, b, sc, sh, True, "replicate", top, left))
        got = kernels._upconv_dw_cuda_cores(x, gy, sc, sh, True, False)
        ref = kernels.upconv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate")
        compare_sum("upconv3x3_chw_dw", "dW bf16 (2, 26->13, 24x40) through itg_upconv3x3_chw_dw",
                    got[0], ref[0])
        compare_sum("upconv3x3_chw_dw", "db bf16 (2, 26->13, 24x40) through itg_upconv3x3_chw_dw",
                    got[1], ref[1])

    def check_1x1_dw(tag, x, gy, plant=False):
        """K3-dW against its plain version: dW and db within SUM_TOL of the
        plain version on both routes (bf16 on the tensor cores: its operands
        are bf16 values, so the plain version computes its function); bf16
        two calls bit-equal and, with ``plant``, three planted faults (one
        input channel's dW x 1.01, the last pixel tile of each image dropped,
        db taken from one image only) must read at least K3_PLANT times the
        limit; f32 two calls bit-equal and, with ``plant``, a planted fault
        (``check_1x1_dw_f32``)."""
        tc = x.dtype == torch.bfloat16
        tag = f"{tag} [{'tensor cores' if tc else 'CUDA cores'}]"
        got = kernels.conv1x1_chw_dw(x, gy)
        ref = kernels.conv1x1_chw_dw_plain(x, gy)
        compare_sum("conv1x1_chw_dw", f"dW {tag}", got[0], ref[0])
        compare_sum("conv1x1_chw_dw", f"db {tag}", got[1], ref[1])
        if not tc:
            check_1x1_dw_f32(tag, x, gy, got, ref, plant)
            return
        same = all(torch.equal(a, b_) for a, b_ in zip(got, kernels.conv1x1_chw_dw(x, gy)))
        print(f"[check] conv1x1_chw_dw {tag}: two calls {'bit-equal' if same else 'differ'}")
        if not same:
            fail(f"conv1x1_chw_dw {tag}: two bf16 calls differ")
        if not plant:
            return

        def ratio(bad):  # the worse of dW's and db's errors over their limits
            return max(float((a - r).abs().max()) / (SUM_TOL * float(r.abs().max()))
                       for a, r in zip(bad, ref))

        one = got[0].clone()
        one[:, int(ref[0].abs().amax(dim=0).argmax())] *= 1.01
        keep = (x.shape[2] * x.shape[3] - 1) // DW1X1_TILE * DW1X1_TILE
        xf, gf = x.flatten(2)[..., :keep].float(), gy.flatten(2)[..., :keep].float()
        for fault, bad in (("one input channel's dW x 1.01", (one, got[1])),
                           ("the last pixel tile of each image dropped",
                            (torch.einsum("nop,ncp->oc", gf, xf), gf.sum(dim=(0, 2)))),
                           ("db taken from one image only",
                            (got[0], gy[:1].float().sum(dim=(0, 2, 3))))):
            r_ = ratio(bad)
            print(f"[check] conv1x1_chw_dw {tag}: planted {fault}: max abs err / limit {r_:.2f} "
                  f"(must reach {K3_PLANT:g})")
            if not r_ >= K3_PLANT:
                fail(f"conv1x1_chw_dw {tag}: a planted {fault} reads only {r_:.2f}x the limit")

    def check_wgrad(name, tag, args, faults=None):
        """K9 dW or K13 dW (``name``) on ``args`` against its plain version:
        dW and db within SUM_TOL of the plain version on both routes (bf16 on
        the tensor cores: its operands are bf16 values, so the plain version
        computes its function); bf16 two calls bit-equal and, with
        ``faults`` (got, ref -> {fault: (dW, db)}), each planted fault must
        read at least DW_PLANT times the limit."""
        k = getattr(kernels, name)
        tc = args[0].dtype == torch.bfloat16
        tag = f"{tag} [{'tensor cores' if tc else 'CUDA cores'}]"
        got = k(*args)
        ref = getattr(kernels, name + "_plain")(*args)
        compare_sum(name, f"dW {tag}", got[0], ref[0])
        compare_sum(name, f"db {tag}", got[1], ref[1])
        if not tc:
            return
        same = all(torch.equal(a, b_) for a, b_ in zip(got, k(*args)))
        print(f"[check] {name} {tag}: two calls {'bit-equal' if same else 'differ'}")
        if not same:
            fail(f"{name} {tag}: two bf16 calls differ")
        if faults is None:
            return
        one = got[0].clone()
        one[:, int(ref[0].abs().amax(dim=(0, 2, 3)).argmax())] *= 1.01
        planted = {"one input channel's dW x 1.01": (one, got[1]),
                   "ky<->kx": (got[0].transpose(2, 3), got[1]), **faults(got, ref)}
        for fault, bad in planted.items():
            r_ = max(float((a - r).abs().max()) / (SUM_TOL * float(r.abs().max()))
                     for a, r in zip(bad, ref))
            print(f"[check] {name} {tag}: planted {fault}: max abs err / limit {r_:.2f} (must "
                  f"reach {DW_PLANT:g})")
            if not r_ >= DW_PLANT:
                fail(f"{name} {tag}: a planted {fault} reads only {r_:.2f}x the limit")

    def check_updw_f32(tag, x, gy, sc, sh, outer, got, ref, plant):
        """K9 dW's float32 route (CUDA cores, csrc/upconv_dw_f32.cu) beyond
        the check against its plain version: two calls bit-equal (dW, db:
        fixed-order partials, folded to 3 x 3 in the last launch), and with
        ``plant`` (replicate padding) three planted faults (one phase tap's
        dW x 1.01: tap (0, 0) of phase (0, 0), which reaches dW[..., 0, 0]
        alone; ky and kx swapped; the first pixel chunk of the last image
        dropped, as a block skipping it would: g zeroed over the plan's rows
        x 32 half-res pixels there) must read at least F32_PLANT times the
        check's limit."""
        k = kernels.upconv3x3_chw_dw
        tag = f"{tag} [CUDA cores]"
        same = all(torch.equal(a, b_) for a, b_ in zip(got, k(x, gy, sc, sh, True, outer)))
        print(f"[check] upconv3x3_chw_dw {tag}: two calls {'bit-equal' if same else 'differ'} "
              "(dW, db)")
        if not same:
            fail(f"upconv3x3_chw_dw {tag}: two f32 calls differ")
        if not plant or outer != "replicate":
            return

        def ratio(bad):  # the worse of the check's two errors over their limits
            return max(float((a - r).abs().max()) / (SUM_TOL * float(r.abs().max()))
                       for a, r in zip(bad, ref))

        n_, c, h, w = x.shape
        co = gy.shape[1]
        a_pad = F.pad(kernels.prenorm(x, sc, sh, True), (1, 1, 1, 1), mode="replicate")
        d00 = torch.nn.grad.conv2d_weight(a_pad[:, :, :h, :w], (co, c, 1, 1),
                                          gy[:, :, 0::2, 0::2])[..., 0, 0]
        one = got[0].clone()
        one[:, :, 0, 0] += 0.01 * d00
        rows = kernels.upconv_dw_f32_plan(n_, c, co, h, w).rows
        cols = kernels.UPCONV_DW_F32_COLS
        g_bad = gy.clone()
        g_bad[-1, :, :2 * rows, :2 * cols] = 0.0
        for fault, bad in (("phase (0, 0) tap (0, 0)'s dW x 1.01", (one, got[1])),
                           ("ky<->kx", (got[0].transpose(2, 3), got[1])),
                           (f"a {rows} x {cols} half-res pixel chunk dropped",
                            k(x, g_bad, sc, sh, True, outer))):
            r_ = ratio(bad)
            print(f"[check] upconv3x3_chw_dw {tag}: planted {fault}: max abs err / limit "
                  f"{r_:.2f} (must reach {F32_PLANT:g})")
            if not r_ >= F32_PLANT:
                fail(f"upconv3x3_chw_dw {tag}: a planted fault ({fault}) reads only {r_:.2f}x "
                     "the limit")

    def check_updw(tag, x, gy, sc, sh, outer, plant=False):
        """K9 dW (check_wgrad); with ``plant`` (replicate padding) also the
        replicate ring taken as zeros and db from the even full-res rows; f32
        also ``check_updw_f32``."""
        def faults(got, ref):
            return {"replicate ring as zeros":
                    kernels.upconv3x3_chw_dw(x, gy, sc, sh, True, "constant"),
                    "db from the even full-res rows only":
                    (got[0], gy[:, :, ::2].float().sum(dim=(0, 2, 3)))}

        args = (x, gy, sc, sh, True, outer)
        check_wgrad("upconv3x3_chw_dw", tag, args,
                    faults if plant and outer == "replicate" else None)
        if x.dtype == torch.float32:
            check_updw_f32(tag, x, gy, sc, sh, outer, kernels.upconv3x3_chw_dw(*args),
                           kernels.upconv3x3_chw_dw_plain(*args), plant)

    def check_stem_dw_f32(tag, x, gy, plant):
        """K13 dW's float32 route (CUDA cores, csrc/stem_dw_f32.cu) beyond
        the check against its plain version: two calls bit-equal (dW, db:
        fixed-order partials), and with ``plant`` two planted faults (ky and
        kx swapped; the first chunk of the last image dropped, as a block
        skipping it would: g zeroed over the plan's rows x 32 output pixels
        there) must read at least F32_PLANT times the check's limit."""
        k = kernels.stem_dw
        tag = f"{tag} [CUDA cores]"
        got = k(x, gy)
        same = all(torch.equal(a, b_) for a, b_ in zip(got, k(x, gy)))
        print(f"[check] stem_dw {tag}: two calls {'bit-equal' if same else 'differ'} (dW, db)")
        if not same:
            fail(f"stem_dw {tag}: two f32 calls differ")
        if not plant:
            return
        ref = kernels.stem_dw_plain(x, gy)
        n_, c, h, w = x.shape
        rows = kernels.stem_dw_f32_plan(n_, c, gy.shape[-1], h, w).rows
        g_bad = gy.clone()
        g_bad[-1, :rows, :kernels.STEM_DW_F32_COLS] = 0.0
        for fault, bad in (("ky<->kx", (got[0].transpose(2, 3), got[1])),
                           (f"a {rows} x {kernels.STEM_DW_F32_COLS} pixel chunk dropped",
                            k(x, g_bad))):
            r_ = max(float((a - r).abs().max()) / (SUM_TOL * float(r.abs().max()))
                     for a, r in zip(bad, ref))
            print(f"[check] stem_dw {tag}: planted {fault}: max abs err / limit {r_:.2f} (must "
                  f"reach {F32_PLANT:g})")
            if not r_ >= F32_PLANT:
                fail(f"stem_dw {tag}: a planted fault ({fault}) reads only {r_:.2f}x the limit")

    def check_stem_dw(tag, x, gy, plant=False):
        """K13 dW (check_wgrad); with ``plant`` also the zero border read as
        the edge pixel and db from one image only; f32 also
        ``check_stem_dw_f32``."""
        def faults(got, ref):
            edge = kernels.stem_dw(F.pad(x, (2, 2, 2, 2), mode="replicate"),
                                   F.pad(gy, (0, 0, 1, 1, 1, 1)))
            return {"the zero border read as the edge pixel": edge,
                    "db from one image only": (got[0], gy[:1].float().sum(dim=(0, 1, 2)))}

        check_wgrad("stem_dw", tag, (x, gy), faults if plant else None)
        if x.dtype == torch.float32:
            check_stem_dw_f32(tag, x, gy, plant)

    def check_ssm_fwd_f32(tag, maps, w1, b1, w2, b2, got, ref):
        """K15's float32 forward (CUDA cores, csrc/ssm_embed_chw.cu) beyond
        the check against its plain version: two calls bit-equal (each
        output sums in one order), and two planted faults (w2's dy and dx
        swapped; one hidden chunk skipped, its 8 channels' w2 zeroed) must
        read at least F32_PLANT times the check's limit."""
        same = torch.equal(got, ssm.ssm_embed(maps, w1, b1, w2, b2))
        print(f"[check] ssm_embed {tag} [CUDA cores]: two calls "
              f"{'bit-equal' if same else 'differ'}")
        if not same:
            fail(f"ssm_embed {tag}: two f32 calls differ")
        limit = F32_TOL * max(1.0, float(ref.abs().max()))
        skip = w2.clone()
        skip[:, ssm.F32_FWD_KC : 2 * ssm.F32_FWD_KC] = 0
        swapped = w2.transpose(2, 3).contiguous()
        for fault, bad in (("w2 dy<->dx", ssm.ssm_embed(maps, w1, b1, swapped, b2)),
                           (f"hidden chunk {ssm.F32_FWD_KC}..{2 * ssm.F32_FWD_KC - 1} skipped",
                            ssm.ssm_embed(maps, w1, b1, skip, b2))):
            r_ = float((bad - ref).abs().max()) / limit
            print(f"[check] ssm_embed {tag} [CUDA cores]: planted {fault}: max abs err / limit "
                  f"{r_:.2f} (must reach {F32_PLANT:g})")
            if not r_ >= F32_PLANT:
                fail(f"ssm_embed {tag}: a planted fault ({fault}) reads only {r_:.2f}x the limit")

    def check_stem_dx(tag, gy, wt, plant=False):
        """K13 dx against its plain version. bf16 runs the tensor cores: dx
        within BF16_TOL of max|ref| of the plain version with w rounded to
        bf16 (``stem_dx_tc_plain``; the unrounded one's distance reported),
        two calls bit-equal, and with ``plant`` three planted faults (ky and
        kx swapped, one k16 step of output channels skipped, g's zero border
        read as the edge pixel) must read at least STEM_PLANT times that
        limit. f32 runs the CUDA cores, held to the plain version, two calls
        bit-equal, and with ``plant`` ky and kx swapped, output channels 0-3
        skipped and g's zero border read as the edge pixel
        must read at least F32_PLANT times the f32 limit."""
        got = kernels.stem_dx(gy, wt)
        g_edge = F.pad(gy.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
        if gy.dtype != torch.bfloat16:
            ref = kernels.stem_dx_plain(gy, wt)
            compare("stem_dx", f"{tag} [CUDA cores]", got, ref)
            same = torch.equal(got, kernels.stem_dx(gy, wt))
            print(f"[check] stem_dx {tag} [CUDA cores]: two calls "
                  f"{'bit-equal' if same else 'differ'}")
            if not same:
                fail(f"stem_dx {tag}: two f32 calls differ")
            if not plant:
                return
            limit = F32_TOL * max(1.0, float(ref.abs().max()))
            skip = wt.clone()
            skip[:4] = 0
            planted = {"ky<->kx": kernels.stem_dx(gy, wt.transpose(2, 3).contiguous()),
                       "output channels 0-3 skipped": kernels.stem_dx(gy, skip),
                       "g's zero border read as the edge pixel": kernels.stem_dx(
                           g_edge.permute(0, 2, 3, 1).contiguous(), wt)[:, :, 2:-2, 2:-2]}
            for fault, bad in planted.items():
                r_ = float((bad - ref).abs().max()) / limit
                print(f"[check] stem_dx {tag} [CUDA cores]: planted {fault}: max abs err / limit "
                      f"{r_:.2f} (must reach {F32_PLANT:g})")
                if not r_ >= F32_PLANT:
                    fail(f"stem_dx {tag}: a planted {fault} reads only {r_:.2f}x the f32 limit")
            return
        ref = kernels.stem_dx_tc_plain(gy, wt)
        compare("stem_dx", f"{tag} [tensor cores]", got, ref, floor=0.0)
        unrounded = float((got.float() - kernels.stem_dx_plain(gy, wt).float()).abs().max())
        same = torch.equal(got, kernels.stem_dx(gy, wt))
        print(f"[check] stem_dx {tag} [tensor cores]: against stem_dx_plain (w unrounded) max abs "
              f"err {unrounded:.3e} (reported); two calls {'bit-equal' if same else 'differ'}")
        if not same:
            fail(f"stem_dx {tag}: two bf16 calls differ")
        if not plant:
            return
        limit = BF16_TOL * float(ref.float().abs().max())
        skip = wt.clone()
        skip[:16] = 0
        planted = {"ky<->kx": kernels.stem_dx(gy, wt.transpose(2, 3).contiguous()),
                   "one k16 step (16 output channels) skipped": kernels.stem_dx(gy, skip),
                   "g's zero border read as the edge pixel": kernels.stem_dx(
                       g_edge.permute(0, 2, 3, 1).contiguous(), wt)[:, :, 2:-2, 2:-2]}
        for fault, bad in planted.items():
            r_ = float((bad.float() - ref.float()).abs().max()) / limit
            print(f"[check] stem_dx {tag}: planted {fault}: max abs err / limit {r_:.2f} (must "
                  f"reach {STEM_PLANT:g})")
            if not r_ >= STEM_PLANT:
                fail(f"stem_dx {tag}: a planted {fault} reads only {r_:.2f}x the limit")

    def check_bn_corr_edges(dtype):
        """K8 bit-equal to its plain version where its 16-byte vectors do not
        tile a plane: an odd HW (every other plane starts mid-vector: the
        scalar head and tail) and g one element into its storage (its planes
        at other offsets within 16 bytes than y's and out's); a planted fault
        (the neighbouring channel's alpha and beta2) must break the
        equality."""
        g_ = torch.Generator(device=dev).manual_seed(350)
        shape = (EXP1_N, 13, 191, 193)
        gy, y = randn(g_, *shape).to(dtype), randn(g_, *shape).to(dtype)
        alpha, beta2 = 0.1 * randn(g_, 13), 0.1 * randn(g_, 13)  # moves every bf16 output
        ref = kernels.bn_corr_plain(gy, y, alpha, beta2)
        compare("bn_corr", f"odd HW {shape}", kernels.bn_corr(gy, y, alpha, beta2), ref,
                exact=True)
        view = torch.empty(gy.numel() + 1, dtype=dtype, device=dev)[1:].view(shape)
        view.copy_(gy)
        compare("bn_corr", f"g one element into its storage {shape}",
                kernels.bn_corr(view, y, alpha, beta2), ref, exact=True)
        bad = float((kernels.bn_corr(gy, y, alpha.roll(1), beta2.roll(1)).float()
                     - ref.float()).abs().max())
        print(f"[check] bn_corr {str(dtype).replace('torch.', '')}: planted fault (the "
              f"neighbouring channel's alpha and beta2): max abs err {bad:.3e} (must exceed 0)")
        if not bad > 0:
            fail("bn_corr: a planted fault (the neighbouring channel's alpha and beta2) passes "
                 "the bit-equal check")

    def up2add_sums_ratio(y, s1, s2):
        """K10's Σy and Σy² against float64 sums of the stored y: the worse
        of the two errors over its limit (UP2ADD_SUM_TOL of Σ|y| or Σy²)."""
        yd = y.double()
        return max(float(((got.double() - v.sum(dim=(0, 2, 3))).abs()
                          / (UP2ADD_SUM_TOL * v.abs().sum(dim=(0, 2, 3)))).max())
                   for got, v in ((s1, yd), (s2, yd * yd)))

    def check_up2add_edges(dtype):
        """K10 where its 16-byte vectors do not tile a row: an odd W (rows at
        every offset within 16 bytes), a W of 1, x and res one element into
        their storage; y bit-equal to the plain version and the sums within
        UP2ADD_SUM_TOL of float64 sums of the stored y, there and at the
        Experiment-1 shapes; two calls with stats bit-equal; and planted
        faults (one y element one step of its type off, one (image, row
        chunk) partial of one channel lost) must fail those checks, the
        second at UP2ADD_PLANT times its limit or more."""
        name = "upsample2_chw_add"
        dt = str(dtype).replace("torch.", "")
        g_ = torch.Generator(device=dev).manual_seed(360)
        # the residual shifted by one: a chunk's sum sits far from zero, as an
        # activation's mean does
        cases = [(f"{what} {shape}", randn(g_, *shape).to(dtype),
                  (1 + randn(g_, *shape[:2], 2 * shape[2], 2 * shape[3])).to(dtype))
                 for what, shape in (("odd W", (2, 5, 7, 47)), ("W of 1", (2, 3, 5, 1)),
                                     ("Exp-1 block 5", (EXP1_N, 26, 96, 96)),
                                     ("Exp-1 block 6", (EXP1_N, 13, 192, 192)))]
        x, res = cases[0][1:]
        for which in (0, 1):
            src = (x, res)[which]
            view = torch.empty(src.numel() + 1, dtype=dtype, device=dev)[1:].view(src.shape)
            view.copy_(src)
            args = (view, res) if which == 0 else (x, view)
            cases.append((f"{('x', 'res')[which]} one element into its storage", *args))
        for what, x, res in cases:
            y, s1, s2 = kernels.upsample2_chw_add(x, res, want_stats=True)
            compare(name, what, y, kernels.upsample2_chw_add_plain(x, res), exact=True)
            r = up2add_sums_ratio(y, s1, s2)
            print(f"[check] {name} {dt} sums {what}: {r:.3f}x the float64 limit")
            if not r <= 1.0:
                fail(f"{name} {what} {dt}: sums {r:.3f}x the float64 limit")
        what, x, res = cases[3]
        first = kernels.upsample2_chw_add(x, res, want_stats=True)
        again = kernels.upsample2_chw_add(x, res, want_stats=True)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail(f"{name} {what} {dt}: two calls with stats differ")
        print(f"[check] {name} {dt} {what}: two calls with stats bit-equal")
        y, s1, s2 = first
        ref = kernels.upsample2_chw_add_plain(x, res)
        bad = y.clone()
        bits = bad.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).view(-1)
        bits[12345] += 1  # the next value of the type
        err = float((bad.float() - ref.float()).abs().max())
        plan = kernels.upsample2_add_plan(*x.shape, x.element_size(),
                                           kernels._sm_count(x.device.index))
        rows = y[-1, 5, 2 * plan.chunk : 4 * plan.chunk].double()  # last image, chunk 1, channel 5
        lost1, lost2 = s1.clone(), s2.clone()
        lost1[5] -= float(rows.sum())
        lost2[5] -= float((rows * rows).sum())
        r1, r2 = up2add_sums_ratio(y, lost1, s2), up2add_sums_ratio(y, s1, lost2)
        print(f"[check] {name} {dt} {what}: planted faults: one y element one step off "
              f"max abs err {err:.3e} (limit 0); one partial lost: Σy {r1:.1f}x, Σy² {r2:.1f}x "
              f"the limit")
        if not (err > 0 and min(r1, r2) >= UP2ADD_PLANT):
            fail(f"{name} {dt}: a planted fault passes (y err {err}, sums {r1:.2f}x, {r2:.2f}x)")

    def time_stem(shape_s, x, wt, b, nbytes, flops, tails, parent_ms=None):
        """K13's forward, twice per step of each tail in ``tails``: bf16 on
        the tensor cores (its CUDA-core kernel in bf16 timed beside it),
        float32 on the CUDA cores into the f32 route's rows. library_ms is
        F.conv2d with the weights channels_last, so that cuDNN writes NHWC as
        K13 does; F.conv2d writing NCHW, and the same then permuted to NHWC,
        are printed beside it. ``parent_ms``: the f32 body the route's
        redesign replaced, recorded (STEM_F32_PARENT_MS)."""
        tc = x.dtype == torch.bfloat16
        wl, bl = wt.to(x.dtype), b.to(x.dtype)
        wcl = wl.contiguous(memory_format=torch.channels_last)

        def nhwc():
            return F.conv2d(x, wcl, bl, stride=2, padding=1)

        if not nhwc().is_contiguous(memory_format=torch.channels_last):
            fail(f"stem_fwd {shape_s}: F.conv2d with channels_last weights did not write NHWC")
        if tc:
            account("stem_fwd", f"{shape_s} [tensor cores]", lambda: kernels.stem_fwd(x, wt, b),
                    lambda: kernels.stem_fwd_tc_plain(x, wt, b), nhwc, nbytes, flops, tails=tails,
                    count=2, old_fn=lambda: kernels._stem_fwd_cuda_cores(x, wt, b))
        else:
            account("stem_fwd", f"{shape_s} [CUDA cores, f32]", lambda: kernels.stem_fwd(x, wt, b),
                    lambda: kernels.stem_fwd_plain(x, wt, b), nhwc, nbytes, flops, tails=tails,
                    count=2, peak=PEAK_F32_FLOP_PER_S, f32_route=True, parent_ms=parent_ms)
        nchw = device_ms(lambda: F.conv2d(x, wl, bl, stride=2, padding=1))
        permuted = device_ms(lambda: F.conv2d(x, wl, bl, stride=2, padding=1)
                             .permute(0, 2, 3, 1).contiguous())
        print(f"[library] stem_fwd {shape_s} {str(x.dtype).replace('torch.', '')}: F.conv2d with "
              f"channels_last weights, NHWC out (library_ms) {device_ms(nhwc):.4f} ms; NCHW out "
              f"{nchw:.4f} ms; NCHW then permuted to NHWC {permuted:.4f} ms  [{card}]")

    print(f"[tolerance] f32 (TF32 off): max abs err <= {F32_TOL:g} * max(1, max|ref|): kernel "
          "and cuDNN sum up to 936 products in other orders, and cuDNN may use Winograd "
          "(~1e-5 relative)")
    print(f"[tolerance] bf16: max abs err <= {BF16_TOL:g} * max(1, max|ref|): both sides "
          "compute in f32 and round the output once, so an output may sit one bf16 ulp "
          "(2^-8 relative) apart; two allowed")
    print("[tolerance] upsample2_chw: bit-equal (a copy)")
    print(f"[tolerance] K13 forward, bf16 (tensor cores, which round w and b to bf16): y max abs "
          f"err <= {BF16_TOL:g} * max|ref| of the plain version with that rounding "
          f"(stem_fwd_tc_plain); two calls bit-equal; planted faults >= {STEM_PLANT:g}x that "
          "limit; f32 (CUDA cores) as above")
    print(f"[tolerance] K9 / K14, bf16 (tensor cores, which round the combined 2x2 phase weights "
          f"to bf16): y max abs err <= {BF16_TOL:g} * max|ref| of the plain version with that "
          f"rounding (*_tc_plain), K9's Σy, Σy² <= {SUM_TOL:g} * max|ref| of the plain sums of the "
          f"stored y; two calls bit-equal (fixed-order sums, no atomics); planted faults >= "
          f"{UP_PLANT:g}x the limit; f32 (CUDA cores) as above")
    print(f"[tolerance] K3, bf16 (tensor cores, which round W and b to bf16): y max abs err <= "
          f"{BF16_TOL:g} * max|ref| of the plain version with that rounding (conv1x1_chw_tc_plain), "
          "and each y within its own limit, 2^-7 of its reference value + 4 (C + 2) 2^-24 of the "
          "sum of its terms' magnitudes (a bf16 step either way; the f32 sums' reorder); Σy, Σy² <= "
          f"{SUM_TOL:g} * max|ref| of the plain sums of the stored y; two calls bit-equal (fixed-order "
          f"sums, no atomics); planted faults >= {K3_PLANT:g}x their limits; f32 (CUDA cores) as above")
    print(f"[tolerance] K1 / K2, bf16 (tensor cores, which round the weights to bf16): y max abs "
          f"err <= {BF16_TOL:g} * max|ref| of the plain version with that rounding (*_tc_plain), "
          f"K5's Σy, Σy² <= {SUM_TOL:g} * max|ref| of the plain sums of the stored y; two calls "
          "bit-equal (fixed-order sums, no atomics); f32 (CUDA cores) as above")
    plan = generator_channel_plan(FLAGSHIP["G_ch"], FLAGSHIP["n_layers_G"])
    base = FLAGSHIP["base_res"]
    # the SSM recipe's generator at eval: blocks 4 (104 -> 52 at 96^2) and 5
    # (52 -> 26 at 192^2) channels-major, identity-folded convs
    ssm_plan = generator_channel_plan(52, 5)
    # K2, K3, K4 on the raster path: one sub-image (checked and timed); K1,
    # K3, K4 on the one-pass path: the 768^2 canvas's whole grid (checked);
    # for the flagship (timed into ``stats``) and the SSM recipe (``gstats``)
    shape_sets = []
    for label, plan_, table_, ident in (("", plan, stats, False), ("SSM ", ssm_plan, gstats, True)):
        patch = base * 2 ** (len(plan_) - 1)
        _, _, th_, tw_ = canvas_geometry(768, 768, patch, GRID, GRID)
        shape_sets += [(f"{label}sub-image", tail_shapes(plan_, base, GRID, GRID), True, table_, ident),
                       (f"{label}one-pass {th_}x{tw_}", tail_shapes(plan_, base, th_, tw_), False,
                        table_, ident)]
    t0 = time.perf_counter()
    for where, (conv3, conv1, up2), timed, into, ident in shape_sets:
        for i, (c, co, h, w) in enumerate(conv3):
            for dtype in (torch.float32, torch.bfloat16):
                x, wt, b, sc, sh, top, left = conv3_inputs(c, co, h, w, dtype, i)
                if ident:
                    sc, sh = torch.ones(c, device=dev), torch.zeros(c, device=dev)
                shape_s = f"{c}->{co} @{h}x{w}"
                # K2 runs on the raster's sub-images; planted faults at the
                # flagship sub-image's first and last conv
                for outer in ("replicate", "constant"):
                    check_fwd(where, shape_s, x, wt, b, sc, sh, top, left, outer, halo=timed,
                              plant=timed and into is stats and i in (0, len(conv3) - 1))
                if not timed or dtype != torch.bfloat16:
                    continue
                es = x.element_size()
                act_bytes = (c + co) * h * w * es + (co * c * 9 + co + 2 * c) * 4
                flops = 2.0 * co * c * 9 * h * w
                a_pad = F.pad(kernels.prenorm(x, sc, sh, True), (1, 1, 1, 1), mode="replicate")
                wl, bl = wt.to(dtype), b.to(dtype)
                # under --fuse_up all the flagship's conv2 and final sites
                # stay (K1 on the one pass, K2 on the raster); every conv1
                # of the tail fuses (phase 2b)
                also = astats if into is stats and (i % 2 or i == len(conv3) - 1) else None
                account("conv3x3_chw", shape_s,
                        lambda: kernels.conv3x3_chw(x, wt, b, sc, sh, True),
                        lambda: kernels.conv3x3_chw_tc_plain(x, wt, b, sc, sh, True),
                        lambda: F.conv2d(a_pad, wl, bl), act_bytes, flops, into=into, also=also,
                        old_fn=lambda: kernels._fwd_cuda_cores(x, wt, b, sc, sh, True, False, None,
                                                               None))
                halo_bytes = act_bytes + (h + w + 2) * c * es
                account("chw_halo_step", shape_s,
                        lambda: kernels.conv3x3_chw_halo(x, wt, b, sc, sh, True, "replicate",
                                                         top, left),
                        lambda: kernels.conv3x3_chw_halo_tc_plain(x, wt, b, sc, sh, True,
                                                                  "replicate", top, left),
                        lambda: F.conv2d(a_pad, wl, bl), halo_bytes, flops, into=into, also=also,
                        old_fn=lambda: kernels._fwd_cuda_cores(x, wt, b, sc, sh, True, False, top,
                                                               left))

        for i, (c, co, h, w) in enumerate(conv1):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(100 + i)
                x = randn(g, 1, c, h, w).to(dtype)
                wt = randn(g, co, c, 1, 1) * c ** -0.5
                b = 0.1 * randn(g, co)
                res = randn(g, 1, co, h, w).to(dtype)
                shape_s = f"{c}->{co} @{h}x{w}"
                # planted faults at each sub-image's first shortcut
                check_1x1(where, shape_s, x, wt, b)
                check_1x1(where, shape_s, x, wt, b, res, plant=timed and i == 0)
                if not timed or dtype != torch.bfloat16:
                    continue
                es = x.element_size()
                nbytes = (c + 2 * co) * h * w * es + (co * c + co) * 4
                flops = 2.0 * co * c * h * w + 2.0 * co * h * w
                wl, bl = wt.to(dtype), b.to(dtype)
                account("conv1x1_chw", shape_s,
                        lambda: kernels.conv1x1_chw_add(x, wt, b, res),
                        lambda: kernels.conv1x1_chw_tc_plain(x, wt, b, res),
                        lambda: torch.add(F.conv2d(x, wl, bl), res), nbytes, flops, into=into,
                        old_fn=lambda: kernels._conv1x1_cuda_cores(x, wt, b, res))

        for i, (c, h, w) in enumerate(up2):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(200 + i)
                x = randn(g, 1, c, h, w).to(dtype)
                shape_s = f"(1, {c}, {h}, {w})"
                compare("upsample2_chw", f"{where} {shape_s}", kernels.upsample2_chw(x),
                        kernels.upsample2_chw_plain(x), exact=True)
                if not timed or dtype != torch.bfloat16:
                    continue
                nbytes = 5.0 * c * h * w * x.element_size()
                account("upsample2_chw", shape_s,
                        lambda: kernels.upsample2_chw(x),
                        lambda: kernels.upsample2_chw_plain(x),
                        lambda: F.interpolate(x, scale_factor=2, mode="nearest"), nbytes, 0.0,
                        into=into)
    print(f"[phase 2] kernel checks and timings in {time.perf_counter() - t0:.1f} s")

    # -- 2b. the --fuse_up all eval kernels: K14 at the flagship's three fused
    # conv1 sites of a 384^2 sub-image in four border cases, and K9 (no
    # stats), the half-res shortcut K3 and K10 (no stats) there (timed into
    # ``astats``) and at the 768^2 one pass's grid (checked)
    t0 = time.perf_counter()
    print("[tolerance] chw_upconv_halo_step (K14) against its plain version (the bordered "
          "post-norm half-res slab, nearest-2x, F.conv2d; in bf16 plus the combined weights' "
          "rounding): the f32/bf16 limits above, as K9's; K10 bit-equal")
    _, _, th7, tw7 = canvas_geometry(768, 768, base * 2 ** (len(plan) - 1), GRID, GRID)
    for where, shapes, timed in (("sub-image", fused_shapes(plan, base, GRID, GRID), True),
                                 (f"one-pass {th7}x{tw7}", fused_shapes(plan, base, th7, tw7), False)):
        for i, (c, co, h, w) in enumerate(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                # K9's bias at unit scale: a dropped one reads well above the bf16 limit
                x, wt, b, sc, sh, top, left = conv3_inputs(c, co, h, w, dtype, 1000 + i, bias=1.0)
                g_ = torch.Generator(device=dev).manual_seed(1100 + i)
                w3 = randn(g_, co, c, 1, 1) * c ** -0.5
                b3 = 0.1 * randn(g_, co)
                s_half = randn(g_, 1, co, h, w).to(dtype)
                res = randn(g_, 1, co, 2 * h, 2 * w).to(dtype)
                shape_s = f"{c}->{co} @{h}x{w} -> {2 * h}x{2 * w}"
                # K14 runs on the raster's sub-images; planted faults at the
                # sub-image's first and last fused site
                for outer in ("replicate", "constant"):
                    check_up(f"all {where}", shape_s, x, wt, b, sc, sh, top, left, outer, halo=timed,
                             plant=timed and i in (0, len(shapes) - 1), f32_plant=False)
                check_1x1(f"all {where} shortcut", f"{c}->{co} @{h}x{w}", x, w3, b3,
                          plant=timed and i == 0)
                k10_s = f"(1, {co}, {h}x{w}) + (1, {co}, {2 * h}x{2 * w})"
                compare("upsample2_chw_add", f"all {where} {k10_s}",
                        kernels.upsample2_chw_add(s_half, res),
                        kernels.upsample2_chw_add_plain(s_half, res), exact=True)
                if not timed or dtype != torch.bfloat16:
                    continue
                es = x.element_size()
                wbytes = (co * c * 9 + co + 2 * c) * 4
                flops = 2.0 * co * c * 16 * h * w  # four phases of 2x2 taps
                io = (c + 4 * co) * h * w * es
                wl, bl, w3l, b3l = wt.to(dtype), b.to(dtype), w3.to(dtype), b3.to(dtype)
                slab = kernels._halo_padded(x, sc, sh, True, "replicate", top, left)
                a_half = kernels.prenorm(x, sc, sh, True)
                account("chw_upconv_halo_step", shape_s,
                        lambda: kernels.upconv3x3_chw_halo(x, wt, b, sc, sh, True, "replicate",
                                                           top, left),
                        lambda: kernels.upconv3x3_chw_halo_tc_plain(x, wt, b, sc, sh, True,
                                                                    "replicate", top, left),
                        lambda: F.conv2d(F.interpolate(slab, scale_factor=2, mode="nearest")
                                         [..., 1:-1, 1:-1], wl, bl),
                        io + (h + w + 2) * c * es + wbytes, flops, into=astats,
                        old_fn=lambda: kernels._upconv_cuda_cores(x, wt, b, sc, sh, True, False, top,
                                                                  left))
                account("upconv3x3_chw", shape_s,
                        lambda: kernels.upconv3x3_chw(x, wt, b, sc, sh, True),
                        lambda: kernels.upconv3x3_chw_tc_plain(x, wt, b, sc, sh, True),
                        lambda: F.conv2d(F.interpolate(a_half, scale_factor=2, mode="nearest"), wl,
                                         bl, padding=1), io + wbytes, flops, into=astats,
                        old_fn=lambda: kernels._upconv_cuda_cores(x, wt, b, sc, sh, True, False, None,
                                                                  None))
                account("conv1x1_chw", f"shortcut {c}->{co} @{h}x{w}",
                        lambda: kernels.conv1x1_chw(x, w3, b3),
                        lambda: kernels.conv1x1_chw_tc_plain(x, w3, b3), lambda: F.conv2d(x, w3l, b3l),
                        (c + co) * h * w * es + (co * c + co) * 4, 2.0 * co * c * h * w, into=astats,
                        old_fn=lambda: kernels._conv1x1_cuda_cores(x, w3, b3, None))
                account("upsample2_chw_add", k10_s, lambda: kernels.upsample2_chw_add(s_half, res),
                        lambda: kernels.upsample2_chw_add_plain(s_half, res),
                        lambda: torch.add(F.interpolate(s_half, scale_factor=2, mode="nearest"), res),
                        9 * co * h * w * es, 4.0 * co * h * w, into=astats,
                        parent_ms=K10_PARENT_MS.get(k10_s))
    print("[library] K14: F.interpolate of the bordered post-norm half-res slab, one full-res ring "
          "cropped, then F.conv2d (two calls); K9 (eval): F.interpolate then F.conv2d, zero "
          "padding; K10 (eval): F.interpolate then add")
    # the timed calls per sub-image are the 'all' raster's launches (K1 and
    # K9, timed at the sub-image's shapes, run on the one pass instead)
    want = {**dict.fromkeys(KERNELS, 0), **GEN_PER_SUB["all"]}
    timed_calls = {k: 0 if k in ("conv3x3_chw", "upconv3x3_chw") else s_["calls"]
                   for k, s_ in astats.items()}
    if timed_calls != want or astats["upconv3x3_chw"]["calls"] != ALL_ONE_PASS["upconv3x3_chw"]:
        fail(f"phase 2b timed {timed_calls} --fuse_up all calls per sub-image, not {want}")
    print(f"[phase 2b] --fuse_up all kernel checks and timings in {time.perf_counter() - t0:.1f} s")

    # -- 3. training kernels against their plain versions, Experiment-1 shapes
    t0 = time.perf_counter()
    conv3_t, conv1_t, up2_t = exp1_shapes(plan, base)
    n = EXP1_N
    print(f"[tolerance] sums (Σy, Σy², d(scale), d(shift), dW, db): max abs err <= {SUM_TOL:g} * "
          "max|ref|: float32 reductions in another order (K3's sums by atomics; K6's, K7's, "
          "K9's and K13 dW's f32 sums by fixed-order partials: two calls bit-equal, "
          f"planted faults >= {F32_PLANT:g}x the limits at the 192^2 shapes; K9's f32 Σy, Σy² "
          f"also within {K9_SUM_TOL:g} of float64 sums of Σ|y|, Σy²); K5's sums are held "
          "to the sums of the kernel's own stored y; K4's adjoint bit-equal")
    print(f"[tolerance] K13 dx, bf16 (tensor cores, which round w to bf16): dx max abs err <= "
          f"{BF16_TOL:g} * max|ref| of the plain version with that rounding (stem_dx_tc_plain); two "
          f"calls bit-equal (one summation order, no atomics); planted faults >= {STEM_PLANT:g}x "
          "that limit; f32 (CUDA cores) as above")
    print("[tolerance] K8 (bn_corr): bit-equal to its plain version (the same float32 operations, "
          "one rounding at the store), also at an odd HW and on a g one element into its storage")
    print("[tolerance] K3-dW, bf16 (tensor cores): dW and db as the sums above, against the plain "
          "version itself (both operands are bf16 values); two calls bit-equal (fixed-order partial "
          f"sums, no atomics); planted faults >= {K3_PLANT:g}x the limit")
    print("[tolerance] K7, bf16 (tensor cores): dW and db as the sums above, against the plain "
          "version itself (both operands are bf16 values, every product exact in float32); two "
          "calls bit-equal (fixed-order partial sums, no atomics)")
    print(f"[tolerance] K6 / K9 dx, bf16 (tensor cores, which round the weights, for K9 the "
          f"combined 4x4 ones, to bf16): dx max abs err <= {BF16_TOL:g} * max|ref| and the sums as "
          "above, against the plain version with that rounding (*_tc_plain); two calls bit-equal "
          "(fixed-order partial sums); f32 (CUDA cores) as before")
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        es = 2 if timed else 4
        check_bn_corr_edges(dtype)
        check_up2add_edges(dtype)
        for i, (c, co, h, w, with_stats) in enumerate(conv3_t):
            g_ = torch.Generator(device=dev).manual_seed(300 + i)
            x = randn(g_, n, c, h, w).to(dtype)
            wt = randn(g_, co, c, 3, 3) * (9 * c) ** -0.5
            b = 0.1 * randn(g_, co)
            sc = 1 + 0.1 * randn(g_, c)
            sh = 0.1 * randn(g_, c)
            gy = randn(g_, n, co, h, w).to(dtype)
            alpha, beta2 = 1e-3 * randn(g_, co), 1e-4 * randn(g_, co)
            shape_s = f"({n}, {c}->{co}, {h}x{w})"
            for outer in ("replicate", "constant"):
                tag = f"{shape_s} {outer}"
                y = check_fwd("train", shape_s, x, wt, b, sc, sh, None, None, outer, halo=False,
                              f32_plant=i < 2)
                # planted faults at the block's two 192^2 shapes
                check_dx("conv3x3_chw_dx", tag, x, gy, wt, sc, sh, outer, plant=i < 2)
                check_dw(tag, x, gy, sc, sh, outer, plant=i < 2)
                if with_stats:
                    compare("bn_corr", tag, kernels.bn_corr(gy, y, alpha, beta2),
                            kernels.bn_corr_plain(gy, y, alpha, beta2), exact=True)
            act = n * h * w
            pbytes = (co * c * 9 + co) * 4
            flops = 2.0 * act * co * c * 9
            dx_bytes = act * (2 * c + co) * es + pbytes + 4 * c * 4
            # a block's conv1 (the stats producer) runs only unfused: under
            # auto K9 takes its place; conv2 and the final conv run in both
            tails = ("off",) if with_stats else ("auto", "off")
            a_pad = F.pad(kernels.prenorm(x, sc, sh, True), (1, 1, 1, 1), mode="replicate")
            if not timed:  # K1's, K6's and K7's f32 routes (CUDA cores), in rows of their own
                account("conv3x3_chw", f"{shape_s} [CUDA cores, f32]",
                        lambda: kernels.conv3x3_chw(x, wt, b, sc, sh, True, want_stats=with_stats),
                        lambda: kernels.conv3x3_chw_plain(x, wt, b, sc, sh, True,
                                                          want_stats=with_stats),
                        lambda: F.conv2d(a_pad, wt, b), act * (c + co) * es + pbytes + 2 * c * 4,
                        flops, tails=tails, peak=PEAK_F32_FLOP_PER_S, f32_route=True,
                        parent_ms=K1_F32_PARENT_MS.get(shape_s))
                account("conv3x3_chw_dx", f"{shape_s} [CUDA cores, f32]",
                        lambda: kernels.conv3x3_chw_dx(x, gy, wt, sc, sh, True, "replicate"),
                        lambda: kernels.conv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate"),
                        lambda: torch.nn.grad.conv2d_input(x.shape, wt, gy, padding=1),
                        dx_bytes, flops, tails=tails, peak=PEAK_F32_FLOP_PER_S, f32_route=True,
                        parent_ms=K6_F32_PARENT_MS.get(shape_s))
                account("conv3x3_chw_dw", f"{shape_s} [CUDA cores, f32]",
                        lambda: kernels.conv3x3_chw_dw(x, gy, sc, sh, True, "replicate"),
                        lambda: kernels.conv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate"),
                        lambda: torch.nn.grad.conv2d_weight(a_pad, wt.shape, gy),
                        act * (c + co) * es + pbytes + 2 * c * 4, flops, tails=tails,
                        peak=PEAK_F32_FLOP_PER_S, f32_route=True,
                        parent_ms=K7_F32_PARENT_MS.get(shape_s))
                continue
            wl, bl = wt.to(dtype), b.to(dtype)
            w32 = kernels._f32(wt)
            account("conv3x3_chw", f"{shape_s} [tensor cores]",
                    lambda: kernels.conv3x3_chw(x, wt, b, sc, sh, True, want_stats=with_stats),
                    lambda: kernels.conv3x3_chw_tc_plain(x, wt, b, sc, sh, True,
                                                         want_stats=with_stats),
                    lambda: F.conv2d(a_pad, wl, bl), act * (c + co) * es + pbytes + 2 * c * 4,
                    flops, tails=tails,
                    old_fn=lambda: kernels._fwd_cuda_cores(x, wt, b, sc, sh, True, False, None, None,
                                                           with_stats))
            account("conv3x3_chw_dx", f"{shape_s} [tensor cores]",
                    lambda: kernels.conv3x3_chw_dx(x, gy, wt, sc, sh, True, "replicate"),
                    lambda: kernels.conv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate"),
                    lambda: torch.nn.grad.conv2d_input(x.shape, wl, gy, padding=1),
                    dx_bytes, flops, tails=tails,
                    old_fn=lambda: kernels._dx_cuda_cores(x, gy, w32, sc, sh, True, False))
            account("conv3x3_chw_dw", f"{shape_s} [tensor cores]",
                    lambda: kernels.conv3x3_chw_dw(x, gy, sc, sh, True, "replicate"),
                    lambda: kernels.conv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate"),
                    lambda: torch.nn.grad.conv2d_weight(a_pad, wl.shape, gy),
                    act * (c + co) * es + pbytes + 2 * c * 4, flops, tails=tails,
                    old_fn=lambda: kernels._dw_cuda_cores(x, gy, sc, sh, True, False))
            if with_stats:
                # two stats producers per block, each (N, Co, H, W) in both
                # tails: conv1 (K5 or K9) and the block's output (K3 or K10)
                ab = alpha.reshape(1, -1, 1, 1).to(dtype)
                b2b = beta2.reshape(1, -1, 1, 1).to(dtype)
                account("bn_corr", f"({n}, {co}, {h}x{w})",
                        lambda: kernels.bn_corr(gy, y, alpha, beta2),
                        lambda: kernels.bn_corr_plain(gy, y, alpha, beta2),
                        lambda: torch.addcmul(gy + ab, y, b2b),
                        3 * act * co * es + 2 * co * 4, 3.0 * act * co, tails=("auto", "off"),
                        count=2)
        for i, (c, co, h, w) in enumerate(conv1_t):
            g_ = torch.Generator(device=dev).manual_seed(400 + i)
            x = randn(g_, n, c, h, w).to(dtype)
            wt = randn(g_, co, c, 1, 1) * c ** -0.5
            b = 0.1 * randn(g_, co)
            res = randn(g_, n, co, h, w).to(dtype)
            gy = randn(g_, n, co, h, w).to(dtype)
            wT = wt.reshape(co, c).t().contiguous()
            zc = torch.zeros(c, device=dev)
            shape_s = f"({n}, {c}->{co}, {h}x{w})"
            # planted faults at block 5's shapes (52 -> 26 at 192^2)
            check_1x1("train", shape_s, x, wt, b, res, stats=True, plant=i == 0)
            check_1x1("train dx form", f"({n}, {co}->{c}, {h}x{w})", gy, wT, zc)
            check_1x1_dw(f"train {shape_s}", x, gy, plant=i == 0)
            act = n * h * w
            wl, bl, wTl = wt.to(dtype), b.to(dtype), wT.reshape(c, co, 1, 1).to(dtype)
            f32 = {} if timed else dict(peak=PEAK_F32_FLOP_PER_S, f32_route=True)
            route = "tensor cores" if timed else "CUDA cores, f32"
            account("conv1x1_chw", f"{shape_s} +res +stats [{route}]",
                    lambda: kernels.conv1x1_chw_add(x, wt, b, res, want_stats=True),
                    lambda: (kernels.conv1x1_chw_tc_plain if timed else kernels.conv1x1_chw_plain)(
                        x, wt, b, res, want_stats=True),
                    lambda: torch.add(F.conv2d(x, wl, bl), res),
                    act * (c + 2 * co) * es + (co * c + 3 * co) * 4, 2.0 * act * co * c,
                    tails=("off",), **f32,
                    old_fn=(lambda: kernels._conv1x1_cuda_cores(x, wt, b, res, True)) if timed
                    else None)
            account("conv1x1_chw", f"dx form ({n}, {co}->{c}, {h}x{w}) [{route}]",
                    lambda: kernels.conv1x1_chw(gy, wT, zc),
                    lambda: (kernels.conv1x1_chw_tc_plain if timed else kernels.conv1x1_chw_plain)(
                        gy, wT, zc),
                    lambda: F.conv2d(gy, wTl), act * (c + co) * es + (co * c + c) * 4,
                    2.0 * act * co * c, tails=("off",), **f32,
                    old_fn=(lambda: kernels._conv1x1_cuda_cores(gy, wT, zc, None)) if timed
                    else None)
            account("conv1x1_chw_dw", f"{shape_s} [{route}]", lambda: kernels.conv1x1_chw_dw(x, gy),
                    lambda: kernels.conv1x1_chw_dw_plain(x, gy),
                    lambda: torch.nn.grad.conv2d_weight(x, wl.shape, gy),
                    act * (c + co) * es + (co * c + co) * 4, 2.0 * act * co * c, tails=("off",),
                    **f32, old_fn=(lambda: kernels._conv1x1_dw_cuda_cores(x, gy)) if timed else None,
                    parent_ms=None if timed else K3DW_F32_PARENT_MS.get(shape_s))
        for i, (c, h, w) in enumerate(up2_t):
            g_ = torch.Generator(device=dev).manual_seed(500 + i)
            x = randn(g_, n, c, h, w).to(dtype)
            gy = randn(g_, n, c, 2 * h, 2 * w).to(dtype)
            shape_s = f"({n}, {c}, {h}, {w})"
            compare("upsample2_chw", f"train {shape_s}", kernels.upsample2_chw(x),
                    kernels.upsample2_chw_plain(x), exact=True)
            compare("upsample2_chw_bwd", f"({n}, {c}, {2 * h}, {2 * w})",
                    kernels.upsample2_chw_bwd(gy), kernels.upsample2_chw_bwd_plain(gy), exact=True)
            if not timed:
                continue
            account("upsample2_chw", shape_s, lambda: kernels.upsample2_chw(x),
                    lambda: kernels.upsample2_chw_plain(x),
                    lambda: F.interpolate(x, scale_factor=2, mode="nearest"),
                    5.0 * n * c * h * w * es, 0.0, tails=("off",))
            account("upsample2_chw_bwd", f"({n}, {c}, {2 * h}, {2 * w})",
                    lambda: kernels.upsample2_chw_bwd(gy),
                    lambda: kernels.upsample2_chw_bwd_plain(gy),
                    lambda: F.avg_pool2d(gy, 2, divisor_override=1),
                    5.0 * n * c * h * w * es, 3.0 * n * c * h * w, tails=("off",))
        hs = conv3_t[-1][2]
        co = 64
        g_ = torch.Generator(device=dev).manual_seed(600)
        x = randn(g_, n, 3, hs, hs).to(dtype)
        wt = randn(g_, co, 3, 4, 4) * 48 ** -0.5
        b = randn(g_, co)  # unit scale: a dropped bias reads well above the bf16 limit
        gy = randn(g_, n, hs // 2, hs // 2, co).to(dtype)
        shape_s = f"({n}, 3, {hs}x{hs}) -> ({n}, {hs // 2}, {hs // 2}, {co})"
        check_stem(f"train {shape_s}", x, wt, b)
        for co_ in STEM_ANY_CO if timed else ():
            g_s = torch.Generator(device=dev).manual_seed(610 + co_)
            w_s, b_s = randn(g_s, co_, 3, 4, 4) * 48 ** -0.5, randn(g_s, co_)
            compare("stem_fwd", f"--D_ch {co_}: (2, 3, {hs}x{hs}) -> (2, {hs // 2}, {hs // 2}, {co_}) "
                    "[tensor cores]", kernels.stem_fwd(x[:2], w_s, b_s),
                    kernels.stem_fwd_tc_plain(x[:2], w_s, b_s), floor=0.0)
            gy_s = randn(g_s, 2, hs // 2, hs // 2, co_).to(dtype)
            check_stem_dw(f"--D_ch {co_}: (2, 3, {hs}x{hs}) -> (2, {hs // 2}, {hs // 2}, {co_})",
                          x[:2], gy_s)
            check_stem_dx(f"--D_ch {co_}: (2, {hs // 2}, {hs // 2}, {co_}) -> (2, 3, {hs}x{hs})",
                          gy_s, w_s)
        for co_ in () if timed else STEM_ANY_CO + (WIDE_D_CH,):  # the f32 route takes any Co
            g_s = torch.Generator(device=dev).manual_seed(610 + co_)
            w_s, b_s = randn(g_s, co_, 3, 4, 4) * 48 ** -0.5, randn(g_s, co_)
            compare("stem_fwd", f"--D_ch {co_}: (2, 3, {hs}x{hs}) -> (2, {hs // 2}, {hs // 2}, {co_}) "
                    "[CUDA cores]", kernels.stem_fwd(x[:2], w_s, b_s),
                    kernels.stem_fwd_plain(x[:2], w_s, b_s))
            gy_s = randn(g_s, 2, hs // 2, hs // 2, co_)
            check_stem_dw(f"--D_ch {co_}: (2, 3, {hs}x{hs}) -> (2, {hs // 2}, {hs // 2}, {co_})",
                          x[:2], gy_s)
            check_stem_dx(f"--D_ch {co_}: (2, {hs // 2}, {hs // 2}, {co_}) -> (2, 3, {hs}x{hs})",
                          gy_s, w_s)
        check_stem_dx(f"train {shape_s}", gy, wt, plant=True)
        check_stem_dw(f"train {shape_s}", x, gy, plant=True)
        nbytes, flops = stem_fwd_work(n, 3, hs, hs, co, es)
        time_stem(shape_s, x, wt, b, nbytes, flops, ("auto", "off"),
                  None if timed else STEM_F32_PARENT_MS.get(shape_s))
        wl = wt.to(dtype)
        g_nchw = gy.permute(0, 3, 1, 2)
        if not timed:  # K13 dW's and dx's f32 routes (CUDA cores), in rows of their own
            account("stem_dw", f"{shape_s} [CUDA cores, f32]", lambda: kernels.stem_dw(x, gy),
                    lambda: kernels.stem_dw_plain(x, gy),
                    lambda: torch.nn.grad.conv2d_weight(x, wl.shape, g_nchw, stride=2, padding=1),
                    nbytes, flops, tails=("auto", "off"), peak=PEAK_F32_FLOP_PER_S, f32_route=True)
            account("stem_dx", f"{shape_s} [CUDA cores, f32]", lambda: kernels.stem_dx(gy, wt),
                    lambda: kernels.stem_dx_plain(gy, wt),
                    lambda: torch.nn.grad.conv2d_input(x.shape, wl, g_nchw, stride=2, padding=1),
                    nbytes, flops, tails=("auto", "off"), peak=PEAK_F32_FLOP_PER_S, f32_route=True)
        else:
            account("stem_dw", f"{shape_s} [tensor cores]", lambda: kernels.stem_dw(x, gy),
                    lambda: kernels.stem_dw_plain(x, gy),
                    lambda: torch.nn.grad.conv2d_weight(x, wl.shape, g_nchw, stride=2, padding=1),
                    nbytes, flops, tails=("auto", "off"),
                    old_fn=lambda: kernels._stem_dw_cuda_cores(x, gy))
            account("stem_dx", f"{shape_s} [tensor cores]", lambda: kernels.stem_dx(gy, wt),
                    lambda: kernels.stem_dx_tc_plain(gy, wt),
                    lambda: torch.nn.grad.conv2d_input(x.shape, wl, g_nchw, stride=2, padding=1),
                    nbytes, flops, tails=("auto", "off"),
                    old_fn=lambda: kernels._stem_dx_cuda_cores(gy, wt))
    # The fused blocks under --fuse_up auto: the unfused conv1 entries at half
    # resolution. K9 and K10, and the kernels that run there at shapes of
    # their own: the half-res shortcut (K3 with no residual and no stats),
    # its dx form and dW, and K4's adjoint of K10's (N, Co, 2H, 2W) gradient.
    print("[tolerance] upconv3x3_chw (K9) against its plain version, the unfused pair "
          "upsample2 + conv3x3 (in bf16 plus the combined weights' rounding): the combined 2x2 "
          "kernels regroup float32 additions (~1e-6 relative), inside the f32/bf16 limits above; "
          "K9's sums as K5's; upsample2_chw_add (K10) bit-equal (one rounded add on both sides), "
          "its sums as K5's")
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        es = 2 if timed else 4
        for i, (c, co, h, w) in enumerate((c, co, h // 2, w // 2) for c, co, h, w in conv1_t):
            g_ = torch.Generator(device=dev).manual_seed(700 + i)
            x = randn(g_, n, c, h, w).to(dtype)
            wt = randn(g_, co, c, 3, 3) * (9 * c) ** -0.5
            b = randn(g_, co)  # unit scale: a dropped bias reads well above the bf16 limit
            sc = 1 + 0.1 * randn(g_, c)
            sh = 0.1 * randn(g_, c)
            gy = randn(g_, n, co, 2 * h, 2 * w).to(dtype)
            s_half = randn(g_, n, co, h, w).to(dtype)
            res = randn(g_, n, co, 2 * h, 2 * w).to(dtype)
            w3 = randn(g_, co, c, 1, 1) * c ** -0.5
            b3 = 0.1 * randn(g_, co)
            w3T = w3.reshape(co, c).t().contiguous()
            zc = torch.zeros(c, device=dev)
            shape_s = f"({n}, {c}->{co}, {h}x{w} -> {2 * h}x{2 * w})"
            half_s = f"({n}, {c}->{co}, {h}x{w})"
            half_t = f"({n}, {co}->{c}, {h}x{w})"
            up_s = f"({n}, {co}, {2 * h}, {2 * w})"
            check_1x1("train auto shortcut", half_s, x, w3, b3, plant=i == 0)
            check_1x1("train auto dx form", half_t, s_half, w3T, zc)
            check_1x1_dw(f"train auto {half_s}", x, s_half, plant=i == 0)
            compare("upsample2_chw_bwd", f"train auto {up_s}", kernels.upsample2_chw_bwd(gy),
                    kernels.upsample2_chw_bwd_plain(gy), exact=True)
            for outer in ("replicate", "constant"):
                tag = f"{shape_s} {outer}"
                check_up("train", shape_s, x, wt, b, sc, sh, None, None, outer, halo=False,
                         with_stats=True, plant=i == 0, f32_plant=True)
                check_dx("upconv3x3_chw_dx", tag, x, gy, wt, sc, sh, outer, plant=True)
                if not timed:
                    check_updx_f32(shape_s, x, gy, wt, sc, sh, outer)
                check_updw(tag, x, gy, sc, sh, outer, plant=True)
            k10_s = f"({n}, {co}, {h}x{w}) + ({n}, {co}, {2 * h}x{2 * w})"
            y_ref = kernels.upsample2_chw_add_plain(s_half, res)
            compare("upsample2_chw_add", k10_s, kernels.upsample2_chw_add(s_half, res), y_ref,
                    exact=True)
            y, s1, s2 = kernels.upsample2_chw_add(s_half, res, want_stats=True)
            compare("upsample2_chw_add", f"{k10_s} +stats", y, y_ref, exact=True)
            compare_sum("upsample2_chw_add", f"Σy {k10_s}", s1, y.float().sum(dim=(0, 2, 3)))
            compare_sum("upsample2_chw_add", f"Σy² {k10_s}", s2, (y.float() ** 2).sum(dim=(0, 2, 3)))
            del y_ref, y
            act = n * h * w  # half-res pixels
            wbytes = (co * c * 9 + co + 2 * c) * 4
            dx_bytes, flops = upconv_dx_work(n, c, co, h, w, es)
            wt4 = kernels._upconv_dx_weights(wt)
            a_half = kernels.prenorm(x, sc, sh, True)
            a_up = F.pad(kernels.upsample2_chw_plain(a_half), (1, 1, 1, 1), mode="replicate")
            w3l, b3l, w3Tl = w3.to(dtype), b3.to(dtype), w3T.reshape(c, co, 1, 1).to(dtype)
            if not timed:  # the f32 routes (CUDA cores) of K9, K9 dx, K3 and K3-dW: rows of their own
                f32 = dict(tails=("auto",), peak=PEAK_F32_FLOP_PER_S, f32_route=True)
                account("conv1x1_chw", f"shortcut {half_s} [CUDA cores, f32]",
                        lambda: kernels.conv1x1_chw(x, w3, b3),
                        lambda: kernels.conv1x1_chw_plain(x, w3, b3), lambda: F.conv2d(x, w3l, b3l),
                        act * (c + co) * es + (co * c + co) * 4, 2.0 * act * co * c, **f32)
                account("conv1x1_chw", f"dx form {half_t} [CUDA cores, f32]",
                        lambda: kernels.conv1x1_chw(s_half, w3T, zc),
                        lambda: kernels.conv1x1_chw_plain(s_half, w3T, zc),
                        lambda: F.conv2d(s_half, w3Tl), act * (c + co) * es + (co * c + c) * 4,
                        2.0 * act * co * c, **f32)
                account("conv1x1_chw_dw", f"{half_s} [CUDA cores, f32]",
                        lambda: kernels.conv1x1_chw_dw(x, s_half),
                        lambda: kernels.conv1x1_chw_dw_plain(x, s_half),
                        lambda: torch.nn.grad.conv2d_weight(x, w3l.shape, s_half),
                        act * (c + co) * es + (co * c + co) * 4, 2.0 * act * co * c, **f32,
                        parent_ms=K3DW_F32_PARENT_MS.get(half_s))
                account("upconv3x3_chw", f"{shape_s} +stats [CUDA cores, f32]",
                        lambda: kernels.upconv3x3_chw(x, wt, b, sc, sh, True, want_stats=True),
                        lambda: kernels.upconv3x3_chw_plain(x, wt, b, sc, sh, True, want_stats=True),
                        lambda: F.conv2d(F.interpolate(a_half, scale_factor=2, mode="nearest"), wt,
                                         b, padding=1),
                        act * (c + 4 * co) * es + wbytes + 2 * co * 4, flops, tails=("auto",),
                        peak=PEAK_F32_FLOP_PER_S, f32_route=True,
                        parent_ms=K9_F32_PARENT_MS.get(shape_s))
                account("upconv3x3_chw_dx", f"{shape_s} [CUDA cores, f32]",
                        lambda: kernels.upconv3x3_chw_dx(x, gy, wt, sc, sh, True, "replicate"),
                        lambda: kernels.upconv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate"),
                        lambda: F.conv2d(gy, wt4.transpose(0, 1).contiguous(), stride=2, padding=1),
                        dx_bytes, flops, tails=("auto",), peak=PEAK_F32_FLOP_PER_S,
                        f32_route=True, parent_ms=K9DX_F32_PARENT_MS.get(shape_s))
                account("upconv3x3_chw_dw", f"{shape_s} [CUDA cores, f32]",
                        lambda: kernels.upconv3x3_chw_dw(x, gy, sc, sh, True, "replicate"),
                        lambda: kernels.upconv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate"),
                        lambda: torch.nn.grad.conv2d_weight(a_up, wt.shape, gy),
                        act * (c + 4 * co) * es + wbytes, flops, tails=("auto",),
                        peak=PEAK_F32_FLOP_PER_S, f32_route=True,
                        parent_ms=K9DW_F32_PARENT_MS.get(shape_s))
                continue
            wl, bl = wt.to(dtype), b.to(dtype)
            wt4l = wt4.transpose(0, 1).contiguous().to(dtype)
            account("upconv3x3_chw", f"{shape_s} +stats [tensor cores]",
                    lambda: kernels.upconv3x3_chw(x, wt, b, sc, sh, True, want_stats=True),
                    lambda: kernels.upconv3x3_chw_tc_plain(x, wt, b, sc, sh, True, want_stats=True),
                    lambda: F.conv2d(F.interpolate(a_half, scale_factor=2, mode="nearest"), wl, bl,
                                     padding=1),
                    act * (c + 4 * co) * es + wbytes + 2 * co * 4, flops, tails=("auto",),
                    old_fn=lambda: kernels._upconv_cuda_cores(x, wt, b, sc, sh, True, False, None,
                                                              None, True))
            account("upconv3x3_chw_dx", f"{shape_s} [tensor cores]",
                    lambda: kernels.upconv3x3_chw_dx(x, gy, wt, sc, sh, True, "replicate"),
                    lambda: kernels.upconv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate"),
                    lambda: F.conv2d(gy, wt4l, stride=2, padding=1), dx_bytes, flops,
                    tails=("auto",),
                    old_fn=lambda: kernels._upconv_dx_cuda_cores(x, gy, wt, sc, sh, True, False))
            account("upconv3x3_chw_dw", f"{shape_s} [tensor cores]",
                    lambda: kernels.upconv3x3_chw_dw(x, gy, sc, sh, True, "replicate"),
                    lambda: kernels.upconv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate"),
                    lambda: torch.nn.grad.conv2d_weight(a_up, wl.shape, gy),
                    act * (c + 4 * co) * es + wbytes, flops, tails=("auto",),
                    old_fn=lambda: kernels._upconv_dw_cuda_cores(x, gy, sc, sh, True, False))
            entry = device_ms(lambda: kernels._upconv_dw_tensor_cores(x, gy, sc, sh, True, False))
            print(f"[time] upconv3x3_chw_dw {shape_s}: the entry point alone (kernel and "
                  f"reduce launch, without the wrapper's fold to 3x3) {entry:.4f} ms  [{card}]")
            account("upsample2_chw_add", f"{k10_s} +stats",
                    lambda: kernels.upsample2_chw_add(s_half, res, want_stats=True),
                    lambda: kernels.upsample2_chw_add_plain(s_half, res, want_stats=True),
                    lambda: torch.add(F.interpolate(s_half, scale_factor=2, mode="nearest"), res),
                    9 * act * co * es + 2 * co * 4, 3.0 * 4 * act * co, tails=("auto",),
                    parent_ms=K10_PARENT_MS.get(f"{k10_s} +stats"))
            account("conv1x1_chw", f"shortcut {half_s} [tensor cores]",
                    lambda: kernels.conv1x1_chw(x, w3, b3),
                    lambda: kernels.conv1x1_chw_tc_plain(x, w3, b3), lambda: F.conv2d(x, w3l, b3l),
                    act * (c + co) * es + (co * c + co) * 4, 2.0 * act * co * c, tails=("auto",),
                    old_fn=lambda: kernels._conv1x1_cuda_cores(x, w3, b3, None))
            account("conv1x1_chw", f"dx form {half_t} [tensor cores]",
                    lambda: kernels.conv1x1_chw(s_half, w3T, zc),
                    lambda: kernels.conv1x1_chw_tc_plain(s_half, w3T, zc),
                    lambda: F.conv2d(s_half, w3Tl), act * (c + co) * es + (co * c + c) * 4,
                    2.0 * act * co * c, tails=("auto",),
                    old_fn=lambda: kernels._conv1x1_cuda_cores(s_half, w3T, zc, None))
            account("conv1x1_chw_dw", f"{half_s} [tensor cores]",
                    lambda: kernels.conv1x1_chw_dw(x, s_half),
                    lambda: kernels.conv1x1_chw_dw_plain(x, s_half),
                    lambda: torch.nn.grad.conv2d_weight(x, w3l.shape, s_half),
                    act * (c + co) * es + (co * c + co) * 4, 2.0 * act * co * c, tails=("auto",),
                    old_fn=lambda: kernels._conv1x1_dw_cuda_cores(x, s_half))
            account("upsample2_chw_bwd", up_s, lambda: kernels.upsample2_chw_bwd(gy),
                    lambda: kernels.upsample2_chw_bwd_plain(gy),
                    lambda: F.avg_pool2d(gy, 2, divisor_override=1), 5.0 * act * co * es,
                    3.0 * act * co, tails=("auto",))
    # K9 dx's f32 route at an odd C and odd W (element-loaded g), and with
    # zeros padding at another C; at C = 11 (13 channels a thread, two past
    # C) on a 13 x 45 and a 13 x 46 image (tiles padded on both axes; g by
    # element loads, then by TMA boxes past g's edges), both paddings; both
    # f32 entry points in bf16
    for i, (n_, c_, co_, h_, w_, outer) in enumerate(((2, 13, 7, 17, 19, "replicate"),
                                                       (2, 5, 3, 24, 40, "constant"),
                                                       (2, 11, 19, 13, 45, "replicate"),
                                                       (2, 11, 19, 13, 45, "constant"),
                                                       (2, 11, 19, 13, 46, "replicate"))):
        g_ = torch.Generator(device=dev).manual_seed(760 + i)
        x = randn(g_, n_, c_, h_, w_)
        wt = randn(g_, co_, c_, 3, 3) * (9 * c_) ** -0.5
        sc, sh = 1 + 0.1 * randn(g_, c_), 0.1 * randn(g_, c_)
        gy = randn(g_, n_, co_, 2 * h_, 2 * w_)
        tag = f"({n_}, {c_}->{co_}, {h_}x{w_} -> {2 * h_}x{2 * w_})"
        check_dx("upconv3x3_chw_dx", f"{tag} {outer}", x, gy, wt, sc, sh, outer)
        check_updx_f32(tag, x, gy, wt, sc, sh, outer)
    check_f32_edges(790)
    g_ = torch.Generator(device=dev).manual_seed(770)
    check_f32_entry_bf16("bf16 (2, 52->26, 24x24)", randn(g_, 2, 52, 24, 24).bfloat16(),
                         randn(g_, 2, 26, 48, 48).bfloat16(), randn(g_, 26, 52, 3, 3) * 468 ** -0.5,
                         1 + 0.1 * randn(g_, 52), 0.1 * randn(g_, 52),
                         randn(g_, 2, 3, 34, 30).bfloat16(), randn(g_, 100, 3, 4, 4) * 48 ** -0.5,
                         randn(g_, 100))
    print("[library] K9 forward: F.interpolate then F.conv2d (two calls, zero padding); K9 dx: "
          "F.conv2d of g with the 4x4 phase-combined kernels at stride 2 (no border folds, no "
          "ReLU mask); K9 dW: conv2d_weight on the materialised padded upsample; K10: "
          "F.interpolate then add (two calls, no stats)")
    print(f"[phase 3] Experiment-1 training-kernel checks and timings in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 3b. the SSM recipe's kernels: K15 at every SSM site's shape (train,
    # N = 8 at 192^2; eval, N = 1 at 96^2 and 192^2), and the tail kernels at
    # the SSM step's shapes (block 5, 52 -> 26 at 192^2, identity folds)
    t0 = time.perf_counter()
    print("[tolerance] ssm_embed (K15): f32 (CUDA cores) as the f32 limits above; bf16 "
          "(tensor cores, which round the hidden activation and w2 to bf16) the bf16 limit above; "
          "a window of the maps bit-equal to the same window of the whole output (one fixed "
          "summation order), both routes")
    print("[tolerance] ssm_embed_bwd (K15): f32 dW2, db2, dW1, db1 as the sums above; bf16 "
          "(tensor cores) the same limits against ssm.ssm_embed_bwd_tc_plain, the plain version "
          "with the route's roundings (its float32 pre-activation; the hidden activation, w2 and "
          "d_pre to bf16), but dW1 and "
          f"db1 within {DPRE_TOL:g} x max|ref| (d_pre entries a bf16 step apart where float32 and "
          "float64 sums straddle a rounding midpoint), and a planted "
          "dW1 x 1.01 and dW1/dW2 with dy and dx swapped must fail it; two calls bit-equal on "
          "both routes (fixed-order partial sums); f32: a dropped chunk's partials (g zeroed over "
          f"one dW2 chunk) must read >= {F32_PLANT:g}x the dW2 and dW1 limits")
    hid, n = 128, SSM_N
    # (N, C, H = W, path, calls per step or sub-image): bn1 and the shortcut's
    # bn3 modulate C channels, bn2 C/2
    k15_shapes = [(n, 52, 192, "train", 2), (n, 26, 192, "train", 1), (1, 104, 96, "gen", 2),
                  (1, 52, 96, "gen", 1), (1, 52, 192, "gen", 2), (1, 26, 192, "gen", 1)]
    for dtype in (torch.float32, torch.bfloat16):
        tc = dtype == torch.bfloat16
        es = 2 if tc else 4
        route = "tensor cores" if tc else "CUDA cores"
        for i, (nk, c, h, path, count) in enumerate(k15_shapes):
            g_ = torch.Generator(device=dev).manual_seed(800 + i)
            maps = randn(g_, nk, 1, h + 4, h + 4).to(dtype)
            w1 = randn(g_, hid, 1, 3, 3) / 3
            b1 = 0.1 * randn(g_, hid)
            w2 = randn(g_, 2 * c, hid, 3, 3) * (9 * hid) ** -0.5
            b2 = 0.1 * randn(g_, 2 * c)
            shape_s = f"({nk}, 1 -> {hid} -> {2 * c}, {h}x{h})"
            train = path == "train"
            gy = randn(g_, nk, 2 * c, h, h).to(dtype) if train else None
            y = ssm.ssm_embed(maps, w1, b1, w2, b2)
            y_ref = ssm.ssm_embed_plain(maps, w1, b1, w2, b2)
            rt = None if tc else (fstats if train else estats)  # the f32 route's own rows
            compare("ssm_embed", f"{path} {shape_s} [{route}]", y, y_ref, into=rt)
            if not tc:
                check_ssm_fwd_f32(f"{path} {shape_s}", maps, w1, b1, w2, b2, y, y_ref)
            if not train:
                # a raster sub-image's window of the maps: the one pass's bits
                r0, c0 = h // 3, h // 2
                win = maps[..., r0 : r0 + h // 2 + 4, c0 : c0 + h // 2 + 4].contiguous()
                compare("ssm_embed", f"{path} {shape_s} window [{route}]",
                        ssm.ssm_embed(win, w1, b1, w2, b2),
                        y[..., r0 : r0 + h // 2, c0 : c0 + h // 2], exact=True, into=rt)
            if train:
                got = ssm.ssm_embed_bwd(maps, w1, b1, w2, gy)
                plain = ssm.ssm_embed_bwd_tc_plain if tc else ssm.ssm_embed_bwd_plain
                ref = plain(maps, w1, b1, w2, gy)
                tols = (SUM_TOL, SUM_TOL) + (DPRE_TOL if tc else SUM_TOL,) * 2
                for part, a_, r_, tol in zip(("dW2", "db2", "dW1", "db1"), got, ref, tols):
                    compare_sum("ssm_embed_bwd", f"{part} {shape_s} [{route}]", a_, r_, into=rt,
                                tol=tol)
                if tc:
                    # what the roundings move: the unrounded plain version's sums
                    moved = [float((a_ - r_).abs().max() / r_.abs().max()) for a_, r_ in
                             zip(got, ssm.ssm_embed_bwd_plain(maps, w1, b1, w2, gy))]
                    print(f"[check] ssm_embed_bwd {shape_s} [tensor cores]: against the plain "
                          f"version without the roundings, max abs err / max|ref| dW2 {moved[0]:.3e} "
                          f"db2 {moved[1]:.3e} dW1 {moved[2]:.3e} db1 {moved[3]:.3e} (reported)")
                    for fault, bad, r_, tol in (("dW1 x 1.01", got[2] * 1.01, ref[2], DPRE_TOL),
                                                ("dW1 dy<->dx", got[2].transpose(2, 3), ref[2], DPRE_TOL),
                                                ("dW2 dy<->dx", got[0].transpose(2, 3), ref[0], SUM_TOL)):
                        ratio = float((bad - r_).abs().max()) / (tol * float(r_.abs().max()))
                        print(f"[check] ssm_embed_bwd {shape_s} [tensor cores]: planted {fault}: "
                              f"max abs err / limit {ratio:.2f} (must exceed 1)")
                        if not ratio > 1.0:
                            fail(f"ssm_embed_bwd {shape_s}: the check passes a planted {fault}")
                again = ssm.ssm_embed_bwd(maps, w1, b1, w2, gy)
                same = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
                print(f"[check] ssm_embed_bwd {shape_s} [{route}]: two calls "
                      f"{'bit-equal' if same else 'differ'}")
                if not same:
                    fail(f"ssm_embed_bwd {shape_s}: two {route} calls differ")
                if not tc:
                    # a block's partials dropped: g zeroed over one dW2 chunk
                    # (the plan's rows x 32 output pixels of the last image),
                    # whose hidden tile's dW1 partial goes with it
                    rows2 = ssm.bwd_f32_plan(nk, 1, hid, h, h, 2 * c).rows2
                    g_bad = gy.clone()
                    g_bad[-1, :, :rows2, :ssm.F32_COLS2] = 0.0
                    dropped = ssm.ssm_embed_bwd(maps, w1, b1, w2, g_bad)
                    for part, k_ in (("dW2", 0), ("dW1", 2)):
                        r_ = float((dropped[k_] - ref[k_]).abs().max()) / (
                            SUM_TOL * float(ref[k_].abs().max()))
                        print(f"[check] ssm_embed_bwd {shape_s} [CUDA cores]: planted a {rows2} x "
                              f"{ssm.F32_COLS2} pixel chunk dropped: {part} max abs err / limit "
                              f"{r_:.2f} (must reach {F32_PLANT:g})")
                        if not r_ >= F32_PLANT:
                            fail(f"ssm_embed_bwd {shape_s}: a dropped chunk reads only {r_:.2f}x "
                                 f"the {part} limit")
            pix, hpix = nk * h * h, nk * (h + 2) ** 2
            fl1, fl2 = 2.0 * hpix * hid * 9, 2.0 * pix * 2 * c * hid * 9  # stage 1, stage 2
            wbytes = (hid * 9 + hid + 2 * c * hid * 9 + 2 * c) * 4
            io_bytes = nk * (h + 4) ** 2 * es + pix * 2 * c * es
            w1l, b1l, w2l, b2l = w1.to(dtype), b1.to(dtype), w2.to(dtype), b2.to(dtype)
            if tc:
                where = dict(tails=("ssm",)) if train else dict(into=gstats)
            else:  # the f32 route: per SSM step at the training shapes, per sub-image at eval
                where = dict(into=fstats if train else estats, peak=PEAK_F32_FLOP_PER_S)
            account("ssm_embed", f"{shape_s} [{route}]", lambda: ssm.ssm_embed(maps, w1, b1, w2, b2),
                    lambda: ssm.ssm_embed_plain(maps, w1, b1, w2, b2),
                    lambda: F.conv2d(torch.relu(F.conv2d(maps, w1l, b1l)), w2l, b2l),
                    io_bytes + wbytes, fl1 + fl2, count=count, **where)
            if train:
                a_lib = torch.relu(F.conv2d(maps, w1l, b1l))

                def lib_bwd():
                    torch.nn.grad.conv2d_weight(a_lib, w2l.shape, gy)
                    d_act = torch.nn.grad.conv2d_input(a_lib.shape, w2l, gy)
                    torch.nn.grad.conv2d_weight(maps, w1l.shape, d_act)

                account("ssm_embed_bwd", f"{shape_s} [{route}]",
                        lambda: ssm.ssm_embed_bwd(maps, w1, b1, w2, gy),
                        lambda: ssm.ssm_embed_bwd_plain(maps, w1, b1, w2, gy), lib_bwd,
                        io_bytes + 2 * wbytes, 2 * fl1 + 2 * fl2, count=count, **where)
                # each of the backward's launches on its own: device time by
                # kernel name over ten calls
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        ssm.ssm_embed_bwd(maps, w1, b1, w2, gy)
                    sync()
                by_name, _ = device_busy_ms(prof)
                for kname, (kms, _) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
                    print(f"[launch] ssm_embed_bwd {shape_s} [{route}]: {kernel_name(kname)}: "
                          f"{kms / 10:.4f} ms a call (profiler), x{count} per SSM step  [{card}]")
    print("[library] K15 forward: F.conv2d -> ReLU -> F.conv2d (three calls); K15 backward: "
          "conv2d_weight (dW2, on a precomputed hidden) + conv2d_input + conv2d_weight (dW1), "
          "no ReLU mask, no biases' sums")
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        es = 2 if timed else 4
        # conv1 (K5, stats), conv2, the final conv: ReLU with the identity fold
        for i, (c, co, with_stats) in enumerate(((52, 26, True), (26, 26, False), (26, 3, False))):
            h = w = 192
            g_ = torch.Generator(device=dev).manual_seed(900 + i)
            x = randn(g_, n, c, h, w).to(dtype)
            wt = randn(g_, co, c, 3, 3) * (9 * c) ** -0.5
            b = 0.1 * randn(g_, co)
            sc, sh = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            gy = randn(g_, n, co, h, w).to(dtype)
            alpha, beta2 = 1e-3 * randn(g_, co), 1e-4 * randn(g_, co)
            tag = f"ssm ({n}, {c}->{co}, {h}x{w}) identity fold"
            y = check_fwd("ssm", f"({n}, {c}->{co}, {h}x{w}) identity fold", x, wt, b, sc, sh,
                          None, None, "replicate", halo=False, f32_plant=i == 0)
            check_dx("conv3x3_chw_dx", tag, x, gy, wt, sc, sh, "replicate")
            check_dw(tag, x, gy, sc, sh, "replicate")
            if with_stats:
                compare("bn_corr", tag, kernels.bn_corr(gy, y, alpha, beta2),
                        kernels.bn_corr_plain(gy, y, alpha, beta2), exact=True)
            act = n * h * w
            pbytes = (co * c * 9 + co) * 4
            flops = 2.0 * act * co * c * 9
            dx_bytes = act * (2 * c + co) * es + pbytes + 4 * c * 4
            shape_s = f"({n}, {c}->{co}, {h}x{w})"
            a_pad = F.pad(torch.relu(x), (1, 1, 1, 1), mode="replicate")
            if not timed:  # K1's, K6's and K7's f32 routes (CUDA cores), in rows of their own
                account("conv3x3_chw", f"{shape_s} [CUDA cores, f32]",
                        lambda: kernels.conv3x3_chw(x, wt, b, sc, sh, True, want_stats=with_stats),
                        lambda: kernels.conv3x3_chw_plain(x, wt, b, sc, sh, True,
                                                          want_stats=with_stats),
                        lambda: F.conv2d(a_pad, wt, b), act * (c + co) * es + pbytes + 2 * c * 4,
                        flops, tails=("ssm",), peak=PEAK_F32_FLOP_PER_S, f32_route=True,
                        parent_ms=K1_F32_PARENT_MS.get(shape_s))
                account("conv3x3_chw_dx", f"{shape_s} [CUDA cores, f32]",
                        lambda: kernels.conv3x3_chw_dx(x, gy, wt, sc, sh, True, "replicate"),
                        lambda: kernels.conv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate"),
                        lambda: torch.nn.grad.conv2d_input(x.shape, wt, gy, padding=1),
                        dx_bytes, flops, tails=("ssm",), peak=PEAK_F32_FLOP_PER_S, f32_route=True,
                        parent_ms=K6_F32_PARENT_MS.get(shape_s))
                account("conv3x3_chw_dw", f"{shape_s} [CUDA cores, f32]",
                        lambda: kernels.conv3x3_chw_dw(x, gy, sc, sh, True, "replicate"),
                        lambda: kernels.conv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate"),
                        lambda: torch.nn.grad.conv2d_weight(a_pad, wt.shape, gy),
                        act * (c + co) * es + pbytes + 2 * c * 4, flops, tails=("ssm",),
                        peak=PEAK_F32_FLOP_PER_S, f32_route=True,
                        parent_ms=K7_F32_PARENT_MS.get(shape_s))
                continue
            wl, bl = wt.to(dtype), b.to(dtype)
            w32 = kernels._f32(wt)
            account("conv3x3_chw", f"{shape_s} [tensor cores]",
                    lambda: kernels.conv3x3_chw(x, wt, b, sc, sh, True, want_stats=with_stats),
                    lambda: kernels.conv3x3_chw_tc_plain(x, wt, b, sc, sh, True,
                                                         want_stats=with_stats),
                    lambda: F.conv2d(a_pad, wl, bl), act * (c + co) * es + pbytes + 2 * c * 4,
                    flops, tails=("ssm",),
                    old_fn=lambda: kernels._fwd_cuda_cores(x, wt, b, sc, sh, True, False, None, None,
                                                           with_stats))
            account("conv3x3_chw_dx", f"{shape_s} [tensor cores]",
                    lambda: kernels.conv3x3_chw_dx(x, gy, wt, sc, sh, True, "replicate"),
                    lambda: kernels.conv3x3_chw_dx_plain(x, gy, wt, sc, sh, True, "replicate"),
                    lambda: torch.nn.grad.conv2d_input(x.shape, wl, gy, padding=1),
                    dx_bytes, flops, tails=("ssm",),
                    old_fn=lambda: kernels._dx_cuda_cores(x, gy, w32, sc, sh, True, False))
            account("conv3x3_chw_dw", f"{shape_s} [tensor cores]",
                    lambda: kernels.conv3x3_chw_dw(x, gy, sc, sh, True, "replicate"),
                    lambda: kernels.conv3x3_chw_dw_plain(x, gy, sc, sh, True, "replicate"),
                    lambda: torch.nn.grad.conv2d_weight(a_pad, wl.shape, gy),
                    act * (c + co) * es + pbytes + 2 * c * 4, flops, tails=("ssm",),
                    old_fn=lambda: kernels._dw_cuda_cores(x, gy, sc, sh, True, False))
            if with_stats:
                ab = alpha.reshape(1, -1, 1, 1).to(dtype)
                b2b = beta2.reshape(1, -1, 1, 1).to(dtype)
                account("bn_corr", f"({n}, {co}, {h}x{w})",
                        lambda: kernels.bn_corr(gy, y, alpha, beta2),
                        lambda: kernels.bn_corr_plain(gy, y, alpha, beta2),
                        lambda: torch.addcmul(gy + ab, y, b2b),
                        3 * act * co * es + 2 * co * 4, 3.0 * act * co, tails=("ssm",))
        # the shortcut 52 -> 26 at 192^2 (+ residual, + stats), its dx form
        # and dW; K4 before block 5 and its adjoint; the stem on the fake
        c, co, h = 52, 26, 192
        g_ = torch.Generator(device=dev).manual_seed(950)
        x = randn(g_, n, c, h, h).to(dtype)
        wt = randn(g_, co, c, 1, 1) * c ** -0.5
        b = 0.1 * randn(g_, co)
        res = randn(g_, n, co, h, h).to(dtype)
        gy = randn(g_, n, co, h, h).to(dtype)
        wT = wt.reshape(co, c).t().contiguous()
        zc = torch.zeros(c, device=dev)
        x_half = randn(g_, n, c, h // 2, h // 2).to(dtype)
        g_up = randn(g_, n, c, h, h).to(dtype)
        xs = randn(g_, n, 3, h, h).to(dtype)
        ws = randn(g_, 64, 3, 4, 4) * 48 ** -0.5
        bs = randn(g_, 64)  # unit scale: a dropped bias reads well above the bf16 limit
        gs = randn(g_, n, h // 2, h // 2, 64).to(dtype)
        tag = f"({n}, {c}->{co}, {h}x{h})"
        check_1x1("ssm", tag, x, wt, b, res, stats=True, plant=True)
        check_1x1("ssm dx form", f"({n}, {co}->{c}, {h}x{h})", gy, wT, zc)
        check_1x1_dw(f"ssm {tag}", x, gy, plant=True)
        compare("upsample2_chw", f"ssm ({n}, {c}, {h // 2}, {h // 2})", kernels.upsample2_chw(x_half),
                kernels.upsample2_chw_plain(x_half), exact=True)
        compare("upsample2_chw_bwd", f"ssm ({n}, {c}, {h}, {h})", kernels.upsample2_chw_bwd(g_up),
                kernels.upsample2_chw_bwd_plain(g_up), exact=True)
        stem_s = f"ssm ({n}, 3, {h}x{h}) -> ({n}, {h // 2}, {h // 2}, 64)"
        check_stem(stem_s, xs, ws, bs)
        check_stem_dx(stem_s, gs, ws, plant=True)
        check_stem_dw(stem_s, xs, gs, plant=True)
        sbytes, sflops = stem_fwd_work(n, 3, h, h, 64, es)
        time_stem(stem_s, xs, ws, bs, sbytes, sflops, ("ssm",),
                  None if timed else STEM_F32_PARENT_MS.get(stem_s))
        act = n * h * h
        wl, bl, wTl = wt.to(dtype), b.to(dtype), wT.reshape(c, co, 1, 1).to(dtype)
        shape_s = f"({n}, {c}->{co}, {h}x{h})"
        # K3's and K3-dW's f32 routes (CUDA cores) into rows of their own
        f32 = {} if timed else dict(peak=PEAK_F32_FLOP_PER_S, f32_route=True)
        route = "tensor cores" if timed else "CUDA cores, f32"
        account("conv1x1_chw", f"{shape_s} +res +stats [{route}]",
                lambda: kernels.conv1x1_chw_add(x, wt, b, res, want_stats=True),
                lambda: (kernels.conv1x1_chw_tc_plain if timed else kernels.conv1x1_chw_plain)(
                    x, wt, b, res, want_stats=True),
                lambda: torch.add(F.conv2d(x, wl, bl), res),
                act * (c + 2 * co) * es + (co * c + 3 * co) * 4, 2.0 * act * co * c, tails=("ssm",),
                **f32,
                old_fn=(lambda: kernels._conv1x1_cuda_cores(x, wt, b, res, True)) if timed else None)
        account("conv1x1_chw", f"dx form ({n}, {co}->{c}, {h}x{h}) [{route}]",
                lambda: kernels.conv1x1_chw(gy, wT, zc),
                lambda: (kernels.conv1x1_chw_tc_plain if timed else kernels.conv1x1_chw_plain)(
                    gy, wT, zc),
                lambda: F.conv2d(gy, wTl), act * (c + co) * es + (co * c + c) * 4,
                2.0 * act * co * c, tails=("ssm",), **f32,
                old_fn=(lambda: kernels._conv1x1_cuda_cores(gy, wT, zc, None)) if timed else None)
        account("conv1x1_chw_dw", f"{shape_s} [{route}]", lambda: kernels.conv1x1_chw_dw(x, gy),
                lambda: kernels.conv1x1_chw_dw_plain(x, gy),
                lambda: torch.nn.grad.conv2d_weight(x, wl.shape, gy),
                act * (c + co) * es + (co * c + co) * 4, 2.0 * act * co * c, tails=("ssm",), **f32,
                old_fn=(lambda: kernels._conv1x1_dw_cuda_cores(x, gy)) if timed else None,
                parent_ms=None if timed else K3DW_F32_PARENT_MS.get(shape_s))
        wsl, gs_nchw = ws.to(dtype), gs.permute(0, 3, 1, 2)
        if not timed:  # K13 dW's and dx's f32 routes (CUDA cores), in rows of their own
            account("stem_dw", f"{stem_s} [CUDA cores, f32]", lambda: kernels.stem_dw(xs, gs),
                    lambda: kernels.stem_dw_plain(xs, gs),
                    lambda: torch.nn.grad.conv2d_weight(xs, wsl.shape, gs_nchw, stride=2,
                                                        padding=1),
                    sbytes, sflops, tails=("ssm",), peak=PEAK_F32_FLOP_PER_S, f32_route=True)
            account("stem_dx", f"{stem_s} [CUDA cores, f32]", lambda: kernels.stem_dx(gs, ws),
                    lambda: kernels.stem_dx_plain(gs, ws),
                    lambda: torch.nn.grad.conv2d_input(xs.shape, wsl, gs_nchw, stride=2,
                                                       padding=1),
                    sbytes, sflops, tails=("ssm",), peak=PEAK_F32_FLOP_PER_S, f32_route=True)
            continue
        account("upsample2_chw", f"({n}, {c}, {h // 2}, {h // 2})", lambda: kernels.upsample2_chw(x_half),
                lambda: kernels.upsample2_chw_plain(x_half),
                lambda: F.interpolate(x_half, scale_factor=2, mode="nearest"),
                5.0 * act // 4 * c * es, 0.0, tails=("ssm",))
        account("upsample2_chw_bwd", f"({n}, {c}, {h}, {h})", lambda: kernels.upsample2_chw_bwd(g_up),
                lambda: kernels.upsample2_chw_bwd_plain(g_up),
                lambda: F.avg_pool2d(g_up, 2, divisor_override=1), 5.0 * act // 4 * c * es,
                3.0 * act // 4 * c, tails=("ssm",))
        account("stem_dw", f"{stem_s} [tensor cores]", lambda: kernels.stem_dw(xs, gs),
                lambda: kernels.stem_dw_plain(xs, gs),
                lambda: torch.nn.grad.conv2d_weight(xs, wsl.shape, gs_nchw, stride=2, padding=1),
                sbytes, sflops, tails=("ssm",), old_fn=lambda: kernels._stem_dw_cuda_cores(xs, gs))
        account("stem_dx", f"{stem_s} [tensor cores]", lambda: kernels.stem_dx(gs, ws),
                lambda: kernels.stem_dx_tc_plain(gs, ws),
                lambda: torch.nn.grad.conv2d_input(xs.shape, wsl, gs_nchw, stride=2, padding=1),
                sbytes, sflops, tails=("ssm",), old_fn=lambda: kernels._stem_dx_cuda_cores(gs, ws))
    for tail, want in STEP_LAUNCHES.items():
        timed_calls = {k: s["calls"] for k, s in tstats[tail].items()}
        if timed_calls != want:
            fail(f"phases 3/3b timed {timed_calls} calls per {TRAIN_PATHS[tail][0]} step, not {want}")
        f32_calls = {k: dstats[tail][k]["calls"] for k in ROUTED}
        if f32_calls != {k: want[k] for k in ROUTED}:
            fail(f"phases 3/3b timed the routed kernels' f32 routes {f32_calls} per "
                 f"{TRAIN_PATHS[tail][0]} step")
    # generation: the timed calls per sub-image are the raster's launches
    # (K1, timed at the sub-image's shapes, runs on the one pass instead)
    for label, table_ in (("flagship", stats), ("SSM", gstats)):
        want = {**dict.fromkeys(KERNELS, 0), **GEN_PER_SUB[label], "conv3x3_chw": 0}
        timed_calls = {k: 0 if k == "conv3x3_chw" else s["calls"] for k, s in table_.items()}
        if timed_calls != want:
            fail(f"phases 2/3b timed {timed_calls} {label} calls per sub-image, not {want}")
    print(f"[phase 3b] SSM kernel checks and timings in {time.perf_counter() - t0:.1f} s; the "
          "timed calls per step and per sub-image match each path's launch counts")

    # -- 4. the flagship checkpoint through the port ------------------------
    t0 = time.perf_counter()
    ckpt = load_checkpoint(str(CKPT))
    gen, args = load_generator_from_checkpoint(str(CKPT), device=dev, ckpt=ckpt)
    print(f"[load] G_ch {args.G_ch} z_dim {args.z_dim} n_layers_G {args.n_layers_G} "
          f"attention {args.attention} dtype {gen.dtype} patch {gen.patch_resolution}")
    if (gen.plan, gen.base_res, gen.num_patches_h, gen.num_patches_w) != (plan, base, GRID, GRID):
        fail("the checkpoint's generator is not the flagship the kernel checks were sized for")
    walls = {}  # the warm graphed walls of phases 4-7, for phase 13's [mfu]
    one_pass_launches, raster_launches, walls["canvas BN"] = generation_phase(
        dev, gen, args, "flagship", {"conv3x3_chw": 7, "conv1x1_chw": 3, "upsample2_chw": 3},
        GEN_PER_SUB["flagship"], 16, card, sync, plant_faults=True)
    print(f"[phase 4] checkpoint phases in {time.perf_counter() - t0:.1f} s")
    del gen

    # -- 4b. --fuse_up all: a freshly loaded flagship through the fused eval
    # engines (K9 on the one pass, K14 with half-res conv1 caches in the
    # raster), then against the unfused engine, then streamed
    t0 = time.perf_counter()
    gen, args = load_generator_from_checkpoint(str(CKPT), device=dev, ckpt=ckpt, fuse_up="all")
    if args.fuse_up != "all" or gen.eval_fuse_blocks() != {4, 5, 6}:
        fail(f"--fuse_up all fuses blocks {sorted(gen.eval_fuse_blocks())}, not 4-6")
    all_one_pass, all_raster, walls["canvas --fuse_up all"] = generation_phase(
        dev, gen, args, "flagship --fuse_up all", ALL_ONE_PASS, GEN_PER_SUB["all"], 16, card, sync)
    fuse_all_vs_unfused(dev, gen, args, load_generator_from_checkpoint(
        str(CKPT), device=dev, ckpt=ckpt)[0], sync)
    del gen
    gen, _ = load_generator_from_checkpoint(str(CKPT), device=dev, ckpt=ckpt, fuse_up="all")
    stream_phase(dev, gen, card, sync)
    print(f"[phase 4b] --fuse_up all generation in {time.perf_counter() - t0:.1f} s")
    del gen, ckpt

    # -- 5. step parity: kernels against plain versions, full width, f32 ------
    t0 = time.perf_counter()
    # the routed kernels' launches by entry point in each f32 step parity
    dx_f32 = {}

    def parity_run(tail, argv):
        kernels.ROUTE_LAUNCHES.update(dict.fromkeys(kernels.ROUTE_LAUNCHES, 0))
        out = step_parity(dev, argv + ["--compute_dtype", "float32"], STEP_LAUNCHES[tail], sync)
        dx_f32[tail] = dict(kernels.ROUTE_LAUNCHES)
        return out

    parity = {fuse: parity_run(fuse, EXP1_ARGS + ["--fuse_up", fuse]) for fuse in ("auto", "off")}
    fused_vs_unfused(parity["auto"], parity["off"])
    del parity
    ssm.ROUTE_LAUNCHES.update(dict.fromkeys(ssm.ROUTE_LAUNCHES, 0))
    parity_run("ssm", SSM_ARGS)
    f32_route = dict(ssm.ROUTE_LAUNCHES)
    for tail, counts in dx_f32.items():
        want = route_want(STEP_LAUNCHES[tail], tc=False)
        if counts != want:
            fail(f"the f32 step parity ({TRAIN_PATHS[tail][0]}) took the routed kernels' "
                 f"launches {counts}, not {want}")
        print(f"[route] f32 step parity, {TRAIN_PATHS[tail][0]}: the routed kernels' (K1, K6, K7, "
              f"K9, K9 dx, K9 dW, K13, K13 dW, K13 dx, K3, K3-dW) launches by entry point {counts}")
    if f32_route["itg_ssm_embed_tc_fwd"] or f32_route["itg_ssm_embed_tc_bwd"] or not (
            f32_route["itg_ssm_embed_fwd"] and f32_route["itg_ssm_embed_bwd"]):
        fail(f"the f32 SSM step parity took K15's launches {f32_route}, not the CUDA-core route's")
    print(f"[route] f32 SSM step parity: K15 launches by entry point {f32_route}")
    for tail, argv in (("auto", EXP1_ARGS + ["--fuse_up", "auto"]),
                       ("off", EXP1_ARGS + ["--fuse_up", "off"]), ("ssm", SSM_ARGS)):
        graph_parity(dev, TRAIN_PATHS[tail][0], argv, sync, plant="draws" if tail == "auto" else None)
    print(f"[phase 5] step parity in {time.perf_counter() - t0:.1f} s")

    # -- 6. training runs: the train CLI's loop, bf16, graphed (the CLI
    # default) and eager, each form's runs in turn
    t0 = time.perf_counter()
    recipes = {"auto": EXP1_ARGS + ["--fuse_up", "auto"], "off": EXP1_ARGS + ["--fuse_up", "off"],
               "ssm": SSM_ARGS}
    forms = {"graphed": ("0", ""), "eager": ("1", "_eager")}
    ssm.ROUTE_LAUNCHES.update(dict.fromkeys(ssm.ROUTE_LAUNCHES, 0))
    runs, dx_bf16 = {}, {}
    with WatchdogSpy() as spy:  # each run's stall watchdog (phase 13 reads it)
        for tail, argv in recipes.items():
            for form, (spd, suffix) in forms.items():
                kernels.ROUTE_LAUNCHES.update(dict.fromkeys(kernels.ROUTE_LAUNCHES, 0))
                out = training_run(dev, argv, TRAIN_STEPS, STEP_LAUNCHES[tail], sync, card,
                                   ROOT / "build" / f"smoke_train_{tail}{suffix}", spd)
                runs[tail, form], dx_bf16[tail, form] = out[:3] + out[4:], out[3]
    bf16_route = dict(ssm.ROUTE_LAUNCHES)
    for (tail, form), counts in dx_bf16.items():
        want = route_want({k: TRAIN_STEPS * v for k, v in STEP_LAUNCHES[tail].items()}, tc=True)
        if counts != want:
            fail(f"the bf16 training run ({TRAIN_PATHS[tail][0]}, {form}) took the routed "
                 f"kernels' launches {counts}, not {want}")
        print(f"[route] bf16 training run, {TRAIN_PATHS[tail][0]}, {form}: the routed kernels' "
              f"(K1, K6, K7, K9, K9 dx, K9 dW, K13, K13 dW, K13 dx, K3, K3-dW) launches by entry "
              f"point {counts} (CUDA-core kernels: 0)")
    if bf16_route["itg_ssm_embed_fwd"] or bf16_route["itg_ssm_embed_bwd"] or min(
            bf16_route["itg_ssm_embed_tc_fwd"], bf16_route["itg_ssm_embed_tc_bwd"]) < 6 * TRAIN_STEPS:
        fail(f"the bf16 training runs took K15's launches {bf16_route}, not the tensor-core route's")
    print(f"[route] bf16 training runs: K15 launches by entry point {bf16_route}")
    for (tail, form), (_, warm, busy, peak) in runs.items():
        share = f"{busy:.2f} ms, {100 * busy / (warm * 1e3):.1f}%" if busy else "not measured"
        print(f"[train] {TRAIN_PATHS[tail][0]}, {form}: warm step {warm * 1e3:.2f} ms "
              f"({1.0 / warm:.3f} steps/s), device busy per traced step {share}, peak device "
              f"memory {peak / 2**30:.3f} GiB [{card}]")
    # the graphed float32 steps (Experiment-1 auto and off, SSM) as the train
    # CLI runs them: its default --compute_dtype, cuDNN's TF32 as PyTorch
    # leaves it
    torch.backends.cudnn.allow_tf32 = True
    for tail in ("auto", "off", "ssm"):
        argv32 = [a if a != "bfloat16" else "float32" for a in recipes[tail]]
        kernels.ROUTE_LAUNCHES.update(dict.fromkeys(kernels.ROUTE_LAUNCHES, 0))
        ssm.ROUTE_LAUNCHES.update(dict.fromkeys(ssm.ROUTE_LAUNCHES, 0))
        _, warm, busy, routed, _ = training_run(
            dev, argv32, TRAIN_STEPS, STEP_LAUNCHES[tail], sync, card,
            ROOT / "build" / f"smoke_train_f32_{tail}", "0", render=False)
        want = route_want({k: TRAIN_STEPS * v for k, v in STEP_LAUNCHES[tail].items()}, tc=False)
        if routed != want:
            fail(f"the f32 training run ({TRAIN_PATHS[tail][0]}) took the routed kernels' "
                 f"launches {routed}, not {want}")
        print(f"[route] f32 training run, {TRAIN_PATHS[tail][0]}, graphed: the routed kernels' "
              f"launches by entry point {routed} (tensor-core kernels: 0)")
        if tail == "ssm":  # K15's launches in the graphed f32 SSM run: its kernels line row
            f32_ssm_run = dict(ssm.ROUTE_LAUNCHES)
            if f32_ssm_run["itg_ssm_embed_tc_fwd"] or f32_ssm_run["itg_ssm_embed_tc_bwd"] or (
                    f32_ssm_run["itg_ssm_embed_bwd"]
                    < TRAIN_STEPS * STEP_LAUNCHES["ssm"]["ssm_embed_bwd"]):
                fail(f"the f32 SSM training run took K15's launches {f32_ssm_run}, not the "
                     "CUDA-core route's once a site a step")
            print(f"[route] f32 training run, train SSM, graphed: K15 launches by entry point "
                  f"{f32_ssm_run}")
        parent = F32_STEP_PARENT_MS.get(tail)
        was = (f"; the parent tree's {parent[0]:.2f} ms and {parent[1]:.2f} ms busy (recorded)"
               if parent else "")
        share = "not measured" if busy is None else f"{busy:.2f} ms"
        print(f"[train] f32 {TRAIN_PATHS[tail][0]}, graphed (cuDNN TF32 on, the train CLI's "
              f"setting): warm step {warm * 1e3:.2f} ms, device busy per traced step "
              f"{share}{was} [{card}]")
    torch.backends.cudnn.allow_tf32 = False
    runs = {tail: runs[tail, "graphed"] for tail in recipes}  # the main path's launches
    walls.update({f"step {tail}": run[1] for tail, run in runs.items()})
    print(f"[phase 6] training runs in {time.perf_counter() - t0:.1f} s")

    # -- 7. SSM generation from the SSM run's EMA checkpoint ----------------
    t0 = time.perf_counter()
    ssm_ckpt = ROOT / "build" / "smoke_train_ssm" / "1__ema.ckpt"
    gen, args = load_generator_from_checkpoint(str(ssm_ckpt), device=dev)
    print(f"[load ssm] {ssm_ckpt.name}: G_ch {args.G_ch} n_layers_G {args.n_layers_G} map_dim "
          f"{args.map_dim} dtype {gen.dtype} patch {gen.patch_resolution}")
    if (gen.type_norm, gen.plan, gen.base_res, gen.num_patches_h, gen.dtype) != (
            "SSM", ssm_plan, base, GRID, torch.bfloat16):
        fail("the SSM run's generator is not the recipe the kernel checks were sized for")
    ssm.ROUTE_LAUNCHES.update(dict.fromkeys(ssm.ROUTE_LAUNCHES, 0))
    ssm_one_pass, ssm_raster, walls["canvas SSM"] = generation_phase(
        dev, gen, args, "SSM", {"ssm_embed": 6, "conv3x3_chw": 5, "conv1x1_chw": 2,
                                "upsample2_chw": 2}, GEN_PER_SUB["SSM"], 64, card, sync,
        u8_tol=None)
    # K15's launches in the SSM canvases: the f32 768^2 ones on the CUDA-core
    # forward (its eval kernels line row), the bf16 ones on the tensor cores
    f32_gen_ssm = dict(ssm.ROUTE_LAUNCHES)
    print(f"[route] SSM canvases: K15 launches by entry point {f32_gen_ssm}")
    if not (f32_gen_ssm["itg_ssm_embed_fwd"] and f32_gen_ssm["itg_ssm_embed_tc_fwd"]) or (
            f32_gen_ssm["itg_ssm_embed_bwd"] or f32_gen_ssm["itg_ssm_embed_tc_bwd"]):
        fail(f"the SSM canvases took K15's launches {f32_gen_ssm}, not both forwards only")
    del gen
    from infinite_texture_gans_torch import sample

    png = ssm_ckpt.parent / "ssm_sample.png"
    sample.main(["--model_path", str(ssm_ckpt), "--output_resolution_height", "320",
                 "--output_resolution_width", "448", "--output_name", png.name, "--seed", "1",
                 "--device", dev.type])
    if not png.exists() or png.stat().st_size == 0:
        fail(f"the sample CLI wrote no {png}")
    print(f"[sample ssm] the sample CLI rendered {png.name} ({png.stat().st_size} bytes) from "
          f"{ssm_ckpt.name}")
    print(f"[phase 7] SSM generation in {time.perf_counter() - t0:.1f} s")

    # -- 8. resume at full width, graphed ----------------------------------
    t0 = time.perf_counter()
    resume_phase(dev, sync, card)
    print(f"[phase 8] resume in {time.perf_counter() - t0:.1f} s")

    # -- 9. zeros padding (the parsers' default) and the tiled engine -------
    t0 = time.perf_counter()
    zeros_phase(dev, sync, card)
    print(f"[phase 9] zeros padding in {time.perf_counter() - t0:.1f} s")

    # -- 10. the training options: WGAN-GP, disc_iters, D norms, SN in G ----
    t0 = time.perf_counter()
    options_phase(dev, sync, card)
    print(f"[phase 10] training options in {time.perf_counter() - t0:.1f} s")

    # -- 11. multi-image training: the README's recipe, the rotating subset ---
    t0 = time.perf_counter()
    multi_phase(dev, sync, card, runs["auto"])
    print(f"[phase 11] multi-image training in {time.perf_counter() - t0:.1f} s")

    # -- 12. the batched-diagonal engine ---------------------------------------
    t0 = time.perf_counter()
    diag_phase(dev, sync, card)
    print(f"[phase 12] batched-diagonal engine in {time.perf_counter() - t0:.1f} s")

    # -- 13. interop: reference .pth in and out, the utilities, the zoo ------
    t0 = time.perf_counter()
    canvas = pth_phase(dev, sync, card)
    watch = [(w.beats, w.stops, w.thread is not None and not w.thread.is_alive())
             for w in spy.made]
    print(f"[interop] watchdog: phase 6's {len(watch)} one-epoch training runs, (beats, stops, "
          f"thread joined) each: {watch}")
    if len(watch) != len(runs) * len(forms) or any(w != (1, 1, True) for w in watch):
        fail(f"the train loop's watchdog: {watch}, not one beat an epoch, stopped and joined")
    mfu_phase(dev, walls, card)
    quality_phase(dev, canvas, card)
    zoo_phase(dev, card)
    api_phase(dev, canvas, card)
    print(f"[phase 13] interop in {time.perf_counter() - t0:.1f} s")

    # -- 14. parallel/: the data-parallel step and the wavefront on one card --
    t0 = time.perf_counter()
    parallel = parallel_phase(dev, sync, card)
    print(f"[phase 14] parallel in {time.perf_counter() - t0:.1f} s")

    # -- 15. report -----------------------------------------------------------
    # K1 (and under --fuse_up all K9) runs on the one pass, the other
    # generation kernels on the raster
    gen_launches = {label: {k: (one if k in ("conv3x3_chw", "upconv3x3_chw") else raster)[k]
                            for k in KERNELS}
                    for label, one, raster in (("flagship", one_pass_launches, raster_launches),
                                               ("all", all_one_pass, all_raster),
                                               ("SSM", ssm_one_pass, ssm_raster))}
    rows = []
    paths = [("generation", "", GEN_KERNELS, stats, gen_launches["flagship"],
              "per 384^2 sub-image"),
             ("generation --fuse_up all", ":gen_all", GEN_ALL_KERNELS, astats,
              gen_launches["all"], "per 384^2 sub-image under --fuse_up all"),
             ("generation SSM", ":gen_ssm", ("ssm_embed",) + GEN_KERNELS, gstats,
              gen_launches["SSM"], "per 192^2 SSM sub-image")]
    paths += [(TRAIN_PATHS[tail][0], f":train_{tail}", [k for k, v in want.items() if v],
               tstats[tail], runs[tail][0], TRAIN_PATHS[tail][1])
              for tail, want in STEP_LAUNCHES.items()]
    # phase 14's paths run the shapes of the train_auto and raster rows:
    # their times, with the path's own launches
    paths += [("mesh step data:1 (NCCL, graphed)", ":mesh_step",
               [k for k, v in STEP_LAUNCHES["auto"].items() if v], tstats["auto"],
               parallel["mesh"], TRAIN_PATHS["auto"][1] + " (world size 1)"),
              ("wavefront data:1", ":wavefront", [k for k, v in GEN_PER_SUB["flagship"].items()
                                                  if v], stats, parallel["wavefront"],
               "per 384^2 sub-image")]
    for path, suffix, names, table_, counts, per in paths:
        for name in names:
            tag, src, site = KERNELS[name]
            s = table_[name]
            dom = "bytes" if s["nbytes"] / PEAK_BYTES_PER_S >= s["flops"] / PEAK_BF16_FLOP_PER_S else "operations"
            # the largest error over the kernel's value checks (its reductions'
            # where it has no value output: K7, K3-dW, stem dW)
            err, sum_err = stats[name]["err"], stats[name]["sum_err"]
            rows.append({
                "name": name + suffix, "path": path, "route": "cuda",
                **({"dtype": "bfloat16", "cores": "tensor", "entry": TC_ENTRY[name]}
                   if name in TC_ENTRY else {}),
                **({"cuda_cores_ms": s["cuda_cores_ms"]} if name in ROUTED else {}),
                "source": f"infinite_texture_gans_torch/csrc/{src}",
                "replaces": f"infinite_texture_gans_tpu/ops/{site}",
                "launches": counts[name], "max_abs_err": err if err is not None else sum_err,
                "max_abs_err_sums": sum_err, "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": dom,
                "library_ms": s["library_ms"],
            })
            was = (f", the CUDA-core kernel it replaced {s['cuda_cores_ms']:.4f} ms"
                   if name in ROUTED else "")
            print(f"[kernel] {tag} {name}: {per} (bf16, sum over its shapes) "
                  f"{s['ms']:.4f} ms device (eager calls {s['eager_ms']:.4f} ms) vs bound "
                  f"{s['bound_ms']:.4f} ms ({dom}), plain "
                  f"{s['plain_ms']:.4f} ms, library {s['library_ms']:.4f} ms{was}, launches "
                  f"{counts[name]} on the {path} path [{card}]")
    # the float32 routes (CUDA cores): K15's launches in the f32 SSM step
    # parity and its times at the training shapes, per SSM step; K6's and K9
    # dx's launches in each path's f32 step parity and their times per step
    f32_rows = [(name, ":f32_parity", "step parity SSM (float32)", fstats[name], f32_route,
                 "per SSM step") for name in ("ssm_embed", "ssm_embed_bwd")]
    f32_rows += [("ssm_embed_bwd", ":f32_ssm", "train SSM (float32, graphed)",
                  fstats["ssm_embed_bwd"], f32_ssm_run, "per SSM step"),
                 ("ssm_embed", ":f32_gen_ssm", "generation SSM (float32 768^2 canvases)",
                  estats["ssm_embed"], f32_gen_ssm, "per 192^2 SSM sub-image")]
    f32_rows += [(name, f":f32_{tail}", f"step parity {TRAIN_PATHS[tail][0]} (float32)",
                  dstats[tail][name], dx_f32[tail], TRAIN_PATHS[tail][1])
                 for name in ROUTED for tail, want in STEP_LAUNCHES.items() if want[name]]
    for name, suffix, path, s, route_counts, per in f32_rows:
        entry, src = F32_ROUTE[name]
        tag, _, site = KERNELS[name]
        dom = "bytes" if s["nbytes"] / PEAK_BYTES_PER_S >= s["flops"] / PEAK_F32_FLOP_PER_S else "operations"
        err = stats[name] if name in ROUTED else s
        rows.append({
            "name": name + suffix, "path": path, "route": "cuda",
            "dtype": "float32", "cores": "cuda", "entry": entry,
            "source": f"infinite_texture_gans_torch/csrc/{src}",
            "replaces": f"infinite_texture_gans_tpu/ops/{site}", "launches": route_counts[entry],
            "max_abs_err": err["err"] if err["err"] is not None else err["sum_err"],
            "max_abs_err_sums": err["sum_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": dom, "library_ms": s["library_ms"],
        })
        print(f"[kernel] {tag} {name} float32 route ({src}, CUDA cores): {per} (f32, sum "
              f"over its shapes) {s['ms']:.4f} ms device vs bound {s['bound_ms']:.4f} ms ({dom}, "
              f"f32 at 67 TFLOP/s), plain {s['plain_ms']:.4f} ms, library {s['library_ms']:.4f} ms, "
              f"launches {route_counts[entry]} in the {path} [{card}]")
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
