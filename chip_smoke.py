"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main path, the Stage-3 surfel training step
(`vidu4d_tpu_torch.engine.gs4d_trainer.Stage3Trainer.train_step`), at the
workload `bench.py` times: 200k surfels, 256x256, 2 frames per step, SH
degree 3, 25 bones, 16-dim registration features, in the JAX trainer's
default configuration (``--fg_motion gs-bob``: warp AdamW, pair flow as 2
extra kernel channels, cycle/skin regularisers, feature reprojection; the
2DGS normal and distortion terms in the last steps, with lambda_dist
MAIN_LAMBDA_DIST). Then the reduced configuration
(``--nogs_optim_warp --rgb_loss_only --flow_wt 0``) as a second path, at
the same width and a smaller depth, the round loop at the JAX default
capacity, and the Stage-3 command line (train / render / export /
reanimate) from a Stage-2 output, and the static 2DGS command line
(`gs_static`) on a synthetic COLMAP scene at 1237 x 822. Weights are
random from a seed; the data is the synthetic database of
`tests/helpers.make_fake_db` and the scene of
`tests/torch_parity.static_scene`.

Phases (any failed check raises, so the exit code is non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from vidu4d_tpu_torch/csrc with nvcc, one process
     per source in parallel (timed);
  3. hold each kernel against its plain PyTorch version on seeded scenes:
     64^2, 256^2 and 512^2, 2 folded frames, 0 and 2 extra channels, a deep chain
     of 24k splats over one tile (timed), entry_cap below the entry count,
     and the cases of the kernels' work-item split (items of SEG entries,
     `chain_batch`): stops on the first and the last entry of an item, a
     tile of exactly 2 items, an opaque front layer whose later items are
     dead;
  4. one small step (64^2, 4k surfels) on the card vs the same step on the
     CPU (plain versions), from the same state and batch, in the default
     configuration, without and with the 2DGS terms: every loss, gnorm,
     the surfel and deformer gradients and the deformer after its AdamW
     update;
  5. build the main trainer, set the intrinsics to the pixel-true prior and
     place the cloud through the warp on one batch (as bench.py does; every
     step then trains on that batch, as bench.py's timed steps do); require
     >= 50% of the surfels valid in each frame;
  6. compare the kernels with their plain versions at the main path's
     shapes (2 flow channels, random cotangents on every channel) and time
     both (CUDA events, plain/kernel/kernel/plain); print the tile depths,
     the work lists (no item longer than SEG, every entry covered once,
     items within the grid), the (entry, pixel) pairs these inputs need and
     each kernel's bound (`kernel_bounds`);
     then [tile] (`tile_path`): the same inputs binned at tile sides 8 and
     32 (TILE_PHASE_SIDES; the step itself runs at 16), both kernels held
     to their plain versions there (timed, pairs, bounds, work lists), and
     one small step (64^2, 4k surfels) at each side on the card against
     the CPU, its launches counted from 0; the kernels line gains the
     tile8_* / tile32_* fields;
  7. main path: reset the launch counters, run 2 warm-up + 8 timed steps,
     then 2 steps with the 2DGS terms, read the counters: both kernels must
     have launched and no plain version run; every loss term of the
     configuration present and finite, gnorm finite, the deformer moved by
     its AdamW;
  8. reduced path: the same at 2 warm-up + 4 timed steps;
  9. the densify / opacity-reset / outlier hooks on the CPU and on the card
     from one seeded state (capacity 8192, 4096 alive, the same split
     noise): info counts and masks equal, float rows within 1e-6;
 10. the round path (`Stage3Trainer.train` + `train_one_round`) at the JAX
     trainer's default capacity, 400k slots with the 200k calibrated
     surfels alive, ROUND_OPTS' cadence: 2 rounds of 20 steps (an eval
     render each, the forward kernel only; checkpoints and .ply after
     each), the last checkpoint reloaded into a fresh trainer (bitwise
     equal), then 11 steps in chunks of 3. The cloud lies on a surface
     (`scene_target`) seen from one camera pose in every frame. Every hook
     must fire when and where ROUND_FIRED says (densify with clones or
     splits, the size rules from step 40, the reset leaving every alive
     opacity <= 0.01, the outlier prune, the last densify after a 2-step
     chunk), alive must move as the hooks' counts say, every step's
     metrics and every render stay finite, each eval render must cover
     >= ROUND_MIN_COVER of its image (mask > 0.01), and the launches count
     1 forward per step and per eval render, 1 backward per step, no plain
     version. After
     the counts are read, both kernels are held against their plain
     versions on the inputs of ROUND_CHECKS, kept from the run. Prints the
     hooks', the eval renders', the checkpoints' and the rounds' times,
     the file sizes and the median step;
 11. the command line (`cli_path`), in process, in a run directory that
     holds a Stage-2 output (`write_stage2_output`: the database, a
     24,320-face ellipsoid shell mesh with vertex colours and features, a
     Stage-2-layout checkpoint): `vidu4d_tpu_torch.train.main` with
     --gs_init_mesh and --load_path (200k surfels on the mesh in 400k
     slots, 1 round of 10 steps at 256^2, a checkpoint), then
     `render.main` at 512^2 (rot_0_360 and ref), `export.main` (mesh
     stride 4) and `reanimate.main` on the exported motion.json, each from
     the run's opts.log. Requires: 200k alive after every mesh init; the
     transferred deformer tensors bitwise those written; every step
     finite and >= 50% of the surfels valid per frame in the first; the
     run's opts.log, checkpoints and .ply; every render finite, (15, 512,
     512, 3) renders, each ref frame covered >= CLI_MIN_COVER; a .ply of
     ~200k rows, 16 frames of motion, 4 OBJ files; reanimated frame 0
     within CLI_REANIMATE_TOL of the ref render's; launches K1 = steps +
     1 eval render and K2 = steps in train, K1 = 1 per render / reanimate,
     none in export, no plain call. Prints the mesh-init, transfer, step,
     render and entry-point times and the entries and truncated entries
     per frame against entry_cap. Then both kernels against their plain
     versions on frames CLI_CHECK_FRAMES of the ref render's own inputs
     (K2 with random cotangents; timed, with their pairs and bounds);
 12. one static 2DGS step (`gs_trainer.train_step`, STATIC_SMALL: 72 x
     104, 4.5 x 6.5 tiles with cut edges, 4k surfels, SH 3 with random
     higher bands, white background) on the card and on the CPU from one
     state: loss, PSNR, every surfel gradient and the densification
     statistics; then both kernels against their plain versions on the
     card step's inputs (a non-square frame with cut edge tiles);
 13. the static 2DGS command line (`static_path`): a synthetic COLMAP
     reconstruction at 1237 x 822 (24 ring cameras, PNGs of the port's K1
     render of 200k seeded ground-truth surfels, 100k initial points), then
     `gs_static.main` in process (400k slots, SH 3, 300 steps, densify at
     100 / 150 / 200, opacity reset at 150, the eval over every 3rd camera,
     the TSDF mesh over every 4th). Requires: every loss finite; the hooks
     at STATIC_FIRED, alive moving as their counts say, every opacity <=
     0.01 after the reset; the eval PSNR STATIC_PSNR_MARGIN dB above the
     initial store's on the same views; history.json with the JAX keys,
     the .ply rows = alive; a non-empty fused_mesh.obj inside the fusion
     volume; launches K1 = steps + 8 eval + 6 depth renders, K2 = steps,
     no plain call. Then 2 + 8 steps at active SH 3 on one camera, and both
     kernels against their plain versions on the last one's inputs (timed,
     with pairs and bounds). Prints the step, hook, eval (render, PSNR,
     SSIM, LPIPS per view), .ply and extraction (render, fuse_tsdf,
     marching_tets, weld) times, the entries per frame and the mesh's
     size.
 14. Stage 2 (`stage2_small_vs_cpu`, `stage2_path`): 2 steps of a small
     configuration (S2_SMALL, 32^2) on the CPU and on the card in float64
     from one state, batch and draws (every loss term, gnorm, every
     gradient, the parameters after each AdamW update); then the README's
     Stage-2 recipe (S2_FLAGS: bob, --rgb_timefree --rgb_dirfree, 256 pairs
     x 16 pixels x 64 samples = 524,288 samples per step, an 8 x 256 field)
     on make_fake_db(T=16) at 256^2 through the port's entry points:
     `Stage2Trainer` with the command line's options, its full `mlp_init`
     (the prior fits, 1000 SDF pretrain steps; the proxy mesh's mean radius
     in S2_RADIUS), `train()` for 2 rounds of 20 steps. Requires every loss
     term of the configuration (S2_TERMS) finite in every step, gnorm
     finite, >= 90% of the parameters moved, a non-empty 001-fg-geo.obj,
     001-fg-feat.npy of 16 unit channels (within 1e-3), the last checkpoint
     reloaded into a fresh trainer bitwise (parameters, field state,
     optimiser, steps). Then `render.main` at 512^2 on 2 frames (chunks of
     RENDER_CHUNK rays): finite, (2, 512, 512, 3), mask > 0.01 on some pixel
     of each frame; and the hand-off: `train.main --fg_motion gs-bob` from
     this run's own mesh and checkpoint, 2 steps: finite losses, K1 and K2
     launched, no plain version. Prints mlp_init (each fit's steps and
     seconds, the SDF pretrain), every step's ms (median, p90), the host
     batch ms, peak memory, round times, update_geometry_aux and
     export_geometry ms, the render's time and cover, the hand-off's.
 15. the other motions (`S2_MOTIONS`, `S3_MOTION_NO_TERMS`): one small
     float64 Stage-2 step each on the card vs the CPU (dense, denseSE3,
     nvp, bob-nosoft, bob-sc, skel-human, comp_skel-quad_dense, and
     --field_type bg; the fields start from the bob check's pretrained
     ones), same tolerances as its bob steps; one small Stage-3 step each
     (gs-denseSE3, gs-rigid, gs-bob-sc; 64^2, 4k surfels) as in phase 4,
     without the skin terms each motion lacks, K1 and K2 launched on the
     card, no plain version;
 16. [stage2-comp-skel]: `stage2_path` with S2C_FLAGS (--field_type comp
     --fg_motion skel-quad: the 25-bone quad skeleton fg field and a rigid
     bg field, each 8 x 256 at 524,288 samples per step), 1 round of 20
     steps; requires every term of S2C_TERMS finite, a proxy mesh and
     000-<cate>-geo.obj / -feat.npy per field, the checkpoint reloaded
     bitwise for both fields, the 512^2 render of 2 frames; `export.main`
     (motion.json with field2cam, t_articulation and joint_so3 of (16, 25,
     3), no kernel launch); `train.main --fg_motion gs-skel-quad` from the
     fg mesh and the checkpoint (200k surfels, 2 steps, K1 and K2 launched,
     no plain version); `reanimate.main` of that Stage 3 with the Stage-2
     motion at 256^2 (16 finite frames, K1 launched, no plain version).
 17. [stage1] (`stage1_small_vs_cpu`, `stage1_path`): `preprocess_video`
     on a 10 x 64 x 64 clip (crop 32, deltas (1, 2), its masks given) on
     the card and on the CPU, every written file within S1_TOL, and the
     motion-seeded segmentation of both within 0.5% of the pixels; then a
     48 x 720 x 1280 video (a textured 200k-surfel ellipsoid shell turning
     3 deg and drifting 4 px per frame over a background panning 3 px per
     frame, rendered by K1) through `preprocess_video(...,
     segment_backend="auto")` with every other default (crop 256, deltas
     (1, 2, 4, 8), TSDF grid 96, canonical 2 x 500 steps) and
     `write_config`: the RAFT, DepthNet and FeatNet backends, every file of
     the contract with JAX's shape and dtype and finite, canonical z in
     (0, 10], a non-empty centred mesh, the port's loaders reading it, no
     tile kernel launched; prints the seed's source, mask IoU and depth
     rank correlation against the render's ground truth, each stage's
     seconds, RAFT's chunk and the peak memory. Then `stage2_path` on that
     database (S2_FLAGS, full mlp_init, 1 round of 10 steps, the 512^2
     render, the gs-bob hand-off: K1 and K2 launched, no plain version).
 18. [stage1-train] (`stage1_train_path`): one step of each Stage-1
     trainer (RAFT, FeatNet, DepthNet at 128^2, their default batches) on
     the card and on the CPU from the same parameters and batch (loss,
     gradients, updated parameters); then each trainer's `main` on the card
     at the JAX script's default width, resolution and batch for ST_STEPS
     steps (DepthNet on a pool of ST_POOL scenes rendered by K1): every loss
     finite, the parameters moved, an npz with the shipped file's keys,
     shapes and dtypes that the port's loader reads back to the trained
     net's outputs, K1 launched once per rendered scene and nothing else;
     both kernels against their plain versions on one make_scene render's
     inputs (timed; no tile above the JAX tiles path's budget of 1024).
     Prints each trainer's step ms, the ms per rendered scene and the
     held-out scores (EPE vs LK, match accuracy vs HOG, order accuracy vs
     the flow parallax);
 19. [multi-inst] (`multi_inst_path`): a small float64 Stage-2 step with
     one instance code per video (a 2-video database) on the card vs the
     CPU, as in phase 14; two 24 x 720 x 1280 clips of `stage1_video` with
     different motions through `preprocess_video` into one database; Stage 2
     --nosingle_inst at the README recipe's width (1 round of 10 steps,
     num_inst 2), the 512^2 render and `export` of video 1 (export_0001/
     with video 1's frames), the gs-bob --nosingle_inst hand-off (2 steps,
     K1 and K2 launched, no plain version). Prints the step median and
     p90, mlp_init and the peak memory.
 20. [multi-gpu] (`multi_gpu_path`): data parallelism over frame pairs on
     the one card: the main path's Stage-3 step (200k surfels, 256^2, 2
     pairs, the 2DGS terms in the last of 3 steps) and the README's
     Stage-2 recipe (2 steps) by 2 gloo ranks against one process on the
     same global batch, each step from the one process's state before it
     (within MG_STEP / MG_S2_STEP; printed beside a second run of the one
     process against the first), the densify, opacity-reset and outlier
     hooks fired once at the end against the one process's (MG_HOOKS), the
     ranks' checksums equal after every step and after the hooks, 1 K1
     and 1 K2 launch per step on each rank and no
     plain version, both kernels against their plain versions on rank 0's
     inputs (timed); the uneven case (3 pairs over 2 ranks, 64^2, 1 step);
     a world-size-1 NCCL group's step bitwise the step without a group (in
     deterministic-algorithms mode). Prints each run's step ms (median,
     p90), host batch ms and gradient all-reduce ms per rank and peak
     memory;
 21. [c1] (`c1_gate`): K1 on small, distant splats against `reference.py`
     in float64 at 512^2 and 1237 x 822; fails if any pixel's alpha is
     more than 1/255 off. Prints the float32 rho2d error of the kernels'
     splat-centred form beside the Pallas kernel's polynomial's on the same
     splats, rho3d's, and K1's alpha error (largest, share of pixels
     beyond 1/255);
 22. [e2e] (`e2e_path`): the end-to-end quality run
     (`vidu4d_tpu_torch.examples.synthetic_e2e.main`) at E2E_FLAGS: the
     surfel GT video (16 frames at 64^2, K1), Stage 1, Stage 2, Stage 3
     and the reference render, scored. Requires metrics.json with the JAX
     main run's keys, all finite; the render's foreground PSNR
     E2E_PSNR_MARGIN dB above an all-white frame's over the same GT
     foreground and mask IoU >= E2E_MIN_IOU; every step of the schedule taken; launches K1 = GT
     frames + Stage-3 steps + one eval render per round + the reference
     render, K2 = Stage-3 steps, no plain call. Then both kernels against
     their plain versions on GT frame 0's, the last Stage-3 step's (timed,
     with pairs and bounds) and the reference render's inputs, kept from
     the run. Prints each stage's seconds, the step medians, the white
     frame's PSNR and the scores;
 23. [depth eval] (`depth_eval_path`): `preprocess.eval_depthnet.main` on
     the shipped weights (DE_DEPTHNET) and
     `preprocess.eval_depth_registration.main` (DE_REGISTRATION): every
     number finite, K1 once per rendered scene and frame, nothing else.
The last two lines are a JSON object of per-kernel results and
{"ok": true, "device": {...}}.

Tolerances (kernel vs plain version, same inputs, float32):
  forward: max |diff| <= 5e-4 on colour and the aux channels except the two
    discontinuous ones (median depth/weight, n_contrib), which must agree
    on >= 99.9% of pixels (an include or T > 0.5 decision can flip on one
    rounding); 5e-4 is the Pallas-vs-XLA bound of tests/test_pallas_kernel.py;
  backward: in each column c of the (E, 32) grad slab,
    max |diff_c| <= 1e-3 * max |g_c| + 1e-6 * max |g| (summation order
    differs: the kernel rebuilds T by sequential division and reduces
    across warps). The bound is per column because the PB/PC columns scale
    with pixel coordinates and are orders of magnitude above the opacity,
    colour, normal and extra columns; the floor covers columns whose
    per-pixel terms cancel in the sum.
Static small step, card vs CPU: loss and PSNR to 1e-3 relative; each
surfel gradient to STEP_GRAD_REL_TOL * its max |g| + STEP_GRAD_FLOOR * the
largest, grad_accum to STEP_GRAD_REL_TOL of its max, except at most
STATIC_SMALL_ROWS surfels, each within STATIC_SMALL_ROW_TOL of the max
(entries the two devices sort into another order); denom and max_radii2d
equal.
Hooks, card vs CPU: info counts and alive masks equal; every float row
within 1e-6 (relative above magnitude 1: the log-scales and logits reach
~10); the outlier masks equal except at slots with an alive neighbour whose
squared distance is within 1e-6 r^2 + 4 eps32 (|q|^2 + |p|^2) of r^2 (the
float32 rounding of |q|^2 + |p|^2 - 2 q.p), which are listed.
Stage-2 small step, card vs CPU, float64: each loss term and gnorm within
1e-9 relative; each parameter's gradient within 1e-7 of its max |g| +
1e-10 of the largest; parameters after each update within 1e-6 x lr x
multiplier + 4 ulp.
Other Stage-3 motions' small steps: the same bounds, but for at most
STATIC_SMALL_ROWS surfels per field, each within STATIC_SMALL_ROW_TOL of
the field's max |g| (measured on the H100: gs-denseSE3, 1 surfel's xyz
gradient at 5.8e-3 of the max, bound 5e-3).
Whole small step, card vs CPU: each loss to 1e-3 relative + 1e-8 (the
cycle term is a difference of nearly equal points), gnorm 1e-3 relative;
gradients of each surfel field and deformer parameter to STEP_GRAD_REL_TOL
* its max |g| + 1e-5 * the largest max |g| of its group (terms that cancel
leave only rounding); deformer parameters after the first AdamW update
within 2 lr x multiplier (Adam's first step is ~lr * g / |g|, which flips
sign where g is near 0), and to 1e-6 + 1e-3 of that where |g| > 1e-2
max |g|.
Stage-1 training step, card vs CPU: the loss within ST_LOSS_RTOL (1e-4)
relative; each gradient within STEP_GRAD_REL_TOL * its max |g| +
STEP_GRAD_FLOOR * the largest; the parameters after the update within 2 x
the first learning rate + 1e-6 |p|.
Stage 1's small clip, card vs CPU (S1_TOL, the bounds of
tests/test_torch_preprocess_pipeline.py): annotations, crop2raw and
is_detected equal; crops within one float16 step; flow within the RAFT
bound 2e-4 plus a float16 step at 16 px, occlusion at <= 0.5% of the
pixels; depth a float16 step at 4; the features' masked-out pixels equal
and unit vectors elsewhere (the PCA basis may turn within near-equal
singular values); cameras 2e-2 rad and 2e-2; canonical translations 1e-6
(from the mask bbox), rotations 0.05 rad; the centred mesh's bounds 5% and
symmetric Chamfer distance 2% of its extent; the config text equal.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

MAIN_SURFELS, MAIN_RES = 200_000, 256  # the bench.py workload
MAIN_LAMBDA_DIST = 100.0  # distortion weight of the steps with the 2DGS terms
MAIN_STEPS = (2, 8, 2)  # warm-up, timed, then with the 2DGS terms
REDUCED_STEPS = (2, 4)  # warm-up, timed
ROUND_CAPACITY = 400_000  # the JAX trainer's default gs_capacity
# the command-line path: a Stage-2 output (a mesh of 2 * 128 * 95 = 24,320
# faces on the round path's ellipsoid shell, semi-axes 0.10, 0.12, 0.07, at
# depth 0.38 from the Stage-2 camera), the JAX defaults of the Stage-3
# recipe (the trainer's 200k surfels on the mesh in 400k slots), 1 round of
# 10 steps, renders at the README's 512^2
CLI_SURFELS, CLI_STEPS, CLI_RENDER_RES, CLI_FRAMES = 200_000, 10, 512, 16
CLI_MESH = (96, 128)  # rings + 1, meridians
MESH_AXES, MESH_DEPTH = (0.10, 0.12, 0.07), 0.38
# the Stage-2 field's scale exp(logscale): the rot_* viewpoint places its
# camera object-size x rot_dist x exp(logscale) from the centre (as the JAX
# render does), outside the shell only for a scale near 1 (the deformer's
# initial 0.1 puts it inside)
MESH_SCALE = 0.8
CLI_MIN_COVER = 0.05  # share of each ref frame's pixels with mask > 0.01
# the warp AdamW's peak rate: a 1-round run squeezes the OneCycle warm-up
# (lr / 25 to lr over 2 rounds) into its 10 steps, and at the default 5e-4
# the camera MLP and the focal length walk the cloud out of view on the
# synthetic data (the ref renders covered 0.6-1.2% of their pixels on the
# H100). The JAX trainer does the same from the same Stage-2 output
# (tests/test_torch_warp_lr.py, at 32^2). The README recipe (61 rounds of
# 200 steps) is at 2e-5 .. 3.1e-5 over its first 10 steps
CLI_WARP_LR = 3e-5
# reanimated frame 0 vs the ref render's: the same camera, articulation and
# intrinsics but for the t / exp(s) * exp(s) round trip of the translation
CLI_REANIMATE_TOL = 1e-4
# the round path: 2 rounds of 20 steps through train(), then a round of 11
# steps in chunks of 3 (ending at steps 43, 46, 49 and 51). The cadence is
# scaled down so every hook fires at full width: densify at 10, 20, 30, 40
# and 50 (the size rules from 40, after the first reset; 50 fires after
# the 2-step chunk ending at 51), opacity reset at 30, outlier prune at 20
# and 40
ROUND_OPTS = {"num_rounds": 2, "iters_per_round": 20, "save_freq": 1,
              "densify_from_iter": 5, "densification_interval": 10,
              "opacity_reset_interval": 30, "outlier_filtering_interval": 20}
ROUND_K3 = {"iters_per_dispatch": 3, "iters_per_round": 11}
# share of an eval render's pixels (mask > 0.01) the cloud must cover: all
# of them at step 0; training on the synthetic database (noise images and
# masks) moves and shrinks the cloud, to ~0.16 of frame 0 at step 20
ROUND_MIN_COVER = 0.05
# (hook, step m it fired for, current_steps when it ran) of the round path
ROUND_FIRED = [("densify", 10, 10), ("densify", 20, 20), ("outlier", 20, 20),
               ("densify", 30, 30), ("reset_opacity", 30, 30), ("densify", 40, 40),
               ("outlier", 40, 40), ("densify", 50, 51)]
# the static 2DGS path (`gs_static.main`): a synthetic COLMAP scene at the
# width of a MipNeRF-360 outdoor scene as full_eval.py trains it (images at
# downscale 4: 1237 x 822, PINHOLE; `--downscale 1` since the images are
# written at that size), 24 cameras on a ring, ground-truth images rendered
# by the port from 200k seeded surfels on an ellipsoid shell, 100k initial
# points (the ground truth's centres with noise, wrong colours) in the JAX
# default 400k slots, SH 3, black background; 300 of the recipe's 30,000
# steps with the cadence scaled: densify at 100, 150 and 200 (the size
# rules at 200, after the reset), opacity reset at 150
STATIC_W, STATIC_H = 1237, 822
STATIC_GT, STATIC_INIT, STATIC_CAMS, STATIC_CAPACITY = 200_000, 100_000, 24, 400_000
STATIC_STEPS = 300
STATIC_FLAGS = ["--iterations", str(STATIC_STEPS), "--densify_from_iter", "50",
                "--densification_interval", "50", "--densify_until_iter", "250",
                "--opacity_reset_interval", "150", "--downscale", "1",
                "--gs_capacity", str(STATIC_CAPACITY)]
# (hook, step it ran after, max_screen_size for densify)
STATIC_FIRED = [("densify", 100, 0.0), ("densify", 150, 0.0), ("reset_opacity", 150, None),
                ("densify", 200, 20.0)]
STATIC_FULL_SH = (2, 8)  # warm-up, timed steps at active SH 3 on one camera
# the eval PSNR (every 3rd camera) must beat the initial store's on the same
# views by this many dB (predicted in PERF.md before the first chip run)
STATIC_PSNR_MARGIN = 5.0
# the small static step on the card and on the CPU: 72 x 104 (4.5 x 6.5
# tiles), 4k surfels, SH 3, white background. The two devices can sort a
# few entries of equal-looking depth into another order (their quantised
# depths one code apart), which moves those surfels' gradients: at most
# STATIC_SMALL_ROWS of them may exceed the step's bound, each within
# STATIC_SMALL_ROW_TOL of its field's max |g| (measured on the H100: 1 row
# at 8.5e-3 in xyz and grad_accum, 5 beyond 1e-3)
STATIC_SMALL = (72, 104, 4096)
STATIC_SMALL_ROWS, STATIC_SMALL_ROW_TOL = 4, 2e-2
# the kernels' inputs held against the plain versions, by the step count
# when they were built: the eval render of round 2 (1 frame, no extra
# channel, after densify and the outlier prune at 10 and 20) and the step
# after densify (size rules on) and the outlier prune at 40
ROUND_CHECKS = {"eval render after the hooks of round 1": ("render", 20),
                "step after densify and outlier@40": ("step", 40)}
# [tile]: the tile sides held on the main path's workload besides 16
TILE_PHASE_SIDES = (8, 32)
# the keys of a prepared batch that compare_kernels reads
KERNEL_INPUTS = ("slab", "tile_start", "tile_count", "bg", "tiles_x", "tiles_per_frame",
                 "n_extra", "tile")
# the hooks on the CPU and on the card, from one state
HOOK_CAP, HOOK_ALIVE, HOOK_TOL = 8192, 4096, 1e-6
# the reduced configuration: no warp AdamW, rgb/depth/mask losses only, no flow
REDUCED = {"gs_optim_warp": False, "rgb_loss_only": True, "flow_wt": 0.0}
# the loss terms of the default configuration (+ the 2DGS ones)
DEFAULT_TERMS = {"rgb", "flow", "depth", "mask", "feat_reproj", "reg_deform_cyc",
                 "reg_delta_skin", "reg_skin_entropy"}
REG_2DGS_TERMS = {"normal_loss", "dist_loss"}
FWD_TOL = 5e-4
DISCONT_AGREE = 0.999
BWD_REL_TOL = 1e-3
BWD_FLOOR = 1e-6
# whole step, CPU (plain versions) vs card (kernels): the depth loss divides
# by the rendered alpha, so pixels of small alpha scale rounding differences
# by depth / alpha^2, and the warp's reductions sum in another order
STEP_GRAD_REL_TOL = 5e-3
STEP_GRAD_FLOOR = 1e-5
STEP_LOSS_REL_TOL, STEP_LOSS_ABS_TOL = 1e-3, 1e-8
DEEP = "deep chain 24k splats / one tile"
# frames of the 512^2 ref render whose kernel inputs are held against the
# plain versions and timed (the plain versions of all 15 take tens of seconds)
CLI_CHECK_FRAMES = (0, 1)
# FP32 operations per (entry, pixel) pair, counted from the kernels' source
# (a division or an expf counts as one): the splat response and cull of
# every pair that needs it (the splat-centred rho2d, FIS (dx^2 + dy^2), is 6
# of them); the compositing of an included pair is 29 + 2 X more (forward),
# its gradient chain and column sums 105 + 4 X (backward)
OPS_RESPONSE = 34
# H100 SXM, FP32 outside the tensor cores (data sheet). It counts an FMA as
# two operations; the kernels build with -fmad=false and issue separate
# multiplies and adds, so this bound is below what they could reach.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# Stage 2 (stage2_path): the README recipe (--fg_motion bob --rgb_timefree
# --rgb_dirfree, every other flag at its default: 256 pairs x 16 pixels, 64
# samples per ray, an 8 x 256 field, 25 bones) on make_fake_db(T=16) at
# 256^2, 2 rounds of 20 steps. The learning rate is CLI_WARP_LR's: 2 rounds
# squeeze the OneCycle warm-up that the recipe spreads over 2 of 21 rounds.
S2_RES, S2_FRAMES, S2_ROUNDS, S2_ITERS = 256, 16, 2, 20
S2_FLAGS = ["--seqname", "toy", "--logname", "s2", "--fg_motion", "bob", "--rgb_timefree",
            "--rgb_dirfree", "--train_res", str(S2_RES), "--num_rounds", str(S2_ROUNDS),
            "--iters_per_round", str(S2_ITERS), "--save_freq", "1", "--seed", "0",
            "--learning_rate", "3e-5"]
S2_TERMS = {"mask", "feature", "feat_reproj", "rgb", "depth", "flow", "vis", "reg_gauss_mask",
            "reg_eikonal", "reg_deform_cyc", "reg_delta_skin", "reg_skin_entropy",
            "reg_visibility", "reg_gauss_skin", "reg_cam_prior"}
S2_RADIUS = (0.04, 0.2)  # proxy mesh mean radius after mlp_init (the 0.1 sphere)
S2_RENDER_RES, S2_RENDER_FRAMES, S2_HANDOFF_STEPS = 512, 2, 2
# the small Stage-2 step on the card vs the CPU (field depth 2, width 32, 8
# samples, 4 pairs x 8 pixels, 2 steps, the same state, batch and draws) runs
# in float64: in float32 the camera and intrinsics gradients are
# ill-conditioned (the colour field's 12-band encoding; a 1e-6 relative
# change of the parameters moves them by 4-15%, tests/test_torch_dyn_nerf.py)
S2_SMALL = {"field_depth": 2, "field_width": 32, "train_depth_samples": 8,
            "imgs_per_gpu": 4, "pixels_per_image": 8}
S2_SMALL_LOSS_RTOL, S2_SMALL_GRAD_REL, S2_SMALL_GRAD_FLOOR = 1e-9, 1e-7, 1e-10
S2_SMALL_SDF_ITERS = 200  # the small step's SDF pretrain (in float32, on the CPU)
# the other Stage-2 motions and field types, one small float64 step each on
# the card vs the CPU (from the bob check's pretrained fields): (fg_motion,
# field_type)
S2_MOTIONS = [("dense", "fg"), ("denseSE3", "fg"), ("nvp", "fg"), ("bob-nosoft", "fg"),
              ("bob-sc", "fg"), ("skel-human", "fg"), ("comp_skel-quad_dense", "fg"),
              ("bob", "bg")]
# the other Stage-3 motions, one small step each on the card vs the CPU, and
# the skin terms each has not
S3_MOTION_NO_TERMS = {"gs-denseSE3": {"reg_delta_skin", "reg_skin_entropy"},
                      "gs-rigid": {"reg_delta_skin", "reg_skin_entropy"},
                      "gs-bob-sc": {"reg_delta_skin"}}
# the [stage2-comp-skel] phase: the README's Stage-2 recipe with Lab4D's
# quadruped layout, --field_type comp --fg_motion skel-quad (fg: the 25-bone
# quad skeleton; bg: a rigid field; each 8 x 256 at 524,288 samples per
# step), 1 round of 20 steps; then export (joint_so3), the hand-off to a
# gs-skel-quad Stage 3 (200k surfels on the fg mesh, 2 steps) and reanimate
# of that Stage 3 with the Stage-2 export's motion
S2C_ROUNDS = 1
S2C_FLAGS = ["--seqname", "toy", "--logname", "s2comp", "--field_type", "comp",
             "--fg_motion", "skel-quad", "--rgb_timefree", "--rgb_dirfree", "--train_res",
             str(S2_RES), "--num_rounds", str(S2C_ROUNDS), "--iters_per_round", str(S2_ITERS),
             "--save_freq", "1", "--seed", "0", "--learning_rate", "3e-5"]
S2C_TERMS = S2_TERMS | {"reg_skel_prior"}
S2C_REANIMATE_RES = 256
# [stage1]: a video through the port's Stage 1 (`preprocess_video` with the
# defaults a user without masks runs: segment_backend "auto", crop 256,
# deltas (1, 2, 4, 8), TSDF grid 96, canonical 2 x 500 steps), then Stage 2
# (S2_FLAGS on its database: full mlp_init, 1 round of S1_S2_ITERS steps)
# and the gs-bob hand-off. The video: S1_FRAMES frames at S1_RES of a
# textured ellipsoid shell of S1_SURFELS surfels (semi-axes S1_AXES at
# S1_DEPTH, the pipeline's raw focal max(H, W)) turning S1_TURN_DEG per
# frame and drifting S1_DRIFT_PX, rendered by the port's K1 over a
# procedural background that pans S1_PAN_PX per frame
S1_FRAMES, S1_RES, S1_SURFELS = 48, (720, 1280), 200_000
S1_AXES, S1_DEPTH = (0.30, 0.38, 0.24), 2.0
S1_TURN_DEG, S1_DRIFT_PX, S1_PAN_PX = 3.0, 4.0, 3.0
S1_DELTAS, S1_CROP, S1_S2_ITERS = (1, 2, 4, 8), 256, 10
S1_S2_FLAGS = (["--seqname", "synth", "--logname", "s1s2"] + S2_FLAGS[4:]).copy()
S1_S2_FLAGS[S1_S2_FLAGS.index("--num_rounds") + 1] = "1"
S1_S2_FLAGS[S1_S2_FLAGS.index("--iters_per_round") + 1] = str(S1_S2_ITERS)
# the small clip on the card and on the CPU: frames, height, width, surfels,
# crop, deltas, TSDF grid; its masks given (the render's alpha > 0.5)
S1_SMALL = (10, 64, 64, 4096, 32, (1, 2), 32)
# card vs CPU bounds of the small clip, those of
# tests/test_torch_preprocess_pipeline.py: crops one float16 step; flow the
# RAFT bound + a float16 step at 16 px; occlusion / masks <= 0.5% of the
# pixels; depth a float16 step at 4; cameras 2e-2 rad / 2e-2; the mesh's
# bounds 5% and Chamfer 2% of its extent; canonical translations 1e-6,
# rotations 0.05 rad
S1_TOL = {"crop": 2.0 ** -10, "flow": 2e-4 + 2.0 ** -6, "share": 5e-3, "depth": 4e-3,
          "cam_rad": 2e-2, "cam_t": 2e-2, "mesh_bounds": 0.05, "chamfer": 0.02,
          "canon_t": 1e-6, "canon_rad": 0.05}

# [stage1-train]: each Stage-1 trainer's main (`vidu4d_tpu_torch.preprocess.
# train_{raft,featnet,depthnet}`) at the JAX script's default width,
# resolution and batch (128^2; batch 8 / 4 / 8), ST_STEPS steps, DepthNet on
# a pool of ST_POOL scenes; its K1 launches: the init batch, the pool and
# the 4 held-out batches. One step per net on the card and on the CPU from
# the same parameters and batch: the loss within ST_LOSS_RTOL relative,
# each gradient within STEP_GRAD_REL_TOL of its max |g| + STEP_GRAD_FLOOR of
# the largest (cuDNN's and the CPU's convolutions sum in other orders), the
# parameters after the update within 2 x the first learning rate (Adam's
# first step is ~lr * g / |g|) + 1e-6 |p|
ST_STEPS, ST_POOL, ST_RES = 30, 16, 128
ST_BATCH = {"raft": 8, "featnet": 4, "depthnet": 8}
ST_LR = {"raft": 2e-4, "featnet": 3e-4, "depthnet": 3e-4}
ST_LOSS_RTOL = 1e-4
ST_SHIPPED = {"raft": "raft_small_synthetic.npz", "featnet": "featnet_synthetic.npz",
              "depthnet": "depthnet_synthetic.npz"}
# [multi-inst]: two clips of one object (stage1_video, MI_FRAMES frames at
# S1_RES, different motions: (turn deg, drift px, seed) each) through
# preprocess_video into one 2-video database, then Stage 2 --nosingle_inst
# with the README recipe (S2_FLAGS: 8 x 256, 524,288 samples per step), 1
# round of MI_ITERS steps, the 512^2 render and export of video 1, and the
# gs-bob --nosingle_inst hand-off
MI_FRAMES, MI_ITERS = 24, 10
MI_MOTIONS = ((3.0, 4.0, 2), (-4.0, -3.0, 3))
MI_FLAGS = (["--seqname", "multi", "--logname", "mi", "--nosingle_inst"] + S2_FLAGS[4:]).copy()
MI_FLAGS[MI_FLAGS.index("--num_rounds") + 1] = "1"
MI_FLAGS[MI_FLAGS.index("--iters_per_round") + 1] = str(MI_ITERS)
# [multi-gpu]: 2 ranks (gloo, both on the one card) against one process.
# Stage 3: the main path's scene with MG_PAIRS pairs (4 frames), MG_STEPS
# steps (the 2DGS terms in the last); the uneven case MG_UNEVEN (pairs,
# resolution, surfels: 3 pairs over 2 ranks), 1 step. Stage 2: S2_FLAGS,
# MG_S2_STEPS steps after MG_S2_SDF_ITERS SDF pretrain steps. Each step of
# a rank starts from the one process's state before that step (the
# one process saves its whole state after each), so every step is held to
# the same bounds (float32, the same terms summed in another order;
# without it a step's Adam flips, ~lr * g / |g| where g is rounding noise,
# carry into the next, and one process drifts from itself by 1.6e-5 to
# 1.2e-3 relative on the second step's losses and 4e-2 to 1e-1 on the
# third, in development runs on the H100). MG_STEP: loss terms and gnorm
# 1e-5 relative; Adam moments 1e-4 of each tensor's max |.|; grad_accum and
# max_radii2d 1e-5 of their max; no denom slot differing; the parameters
# within 2 x the step's learning rate x multiplier (those flips); the
# overflow / truncated counts within MG_BOUNDARY (a splat on a span
# boundary); alive exactly. The hooks, fired from the one process's last
# state: the same log and alive mask, the surfel store, its moments and
# statistics within MG_HOOKS of each tensor's max (the same inputs; 0
# expected). Stage 2 (float64, MG_S2_STEP): the moments within 1e-5 of
# their max and the loss terms within 3e-4 relative: `nonzero_mean` counts
# every entry > 0, and an entry that is exactly 0 in one process can come
# out ~1e-18 when a rank's half of the rows goes through the matmuls
# (their blocking changes with the row count): one such entry of the 8192
# mask entries (256 pairs x 2 x 16 px) moves that term by 1/8192 = 1.2e-4;
# the parameters within 2 lr
MG_RANKS, MG_PAIRS, MG_STEPS = 2, 2, 3
MG_UNEVEN = (3, 64, 4096)
MG_S2_STEPS, MG_S2_SDF_ITERS = 2, 200
MG_BOUNDARY = 20
MG_STEP = {"metrics_rel": 1e-5, "warp_mu_rel_to_max": 1e-4, "surfel_mu_rel_to_max": 1e-4,
           "grad_accum_rel_to_max": 1e-5, "max_radii2d_rel_to_max": 1e-5,
           "denom_slots_differing": 0, "deformer_over_2lr": 1.0, "surfel_over_2lr": 1.0,
           "count_diff": MG_BOUNDARY}
MG_HOOKS = {"hooks_rel_to_max": 1e-6}
MG_S2_STEP = {"metrics_rel": 3e-4, "mu_rel_to_max": 1e-5, "param_over_2lr": 1.0}
# [c1]: K1 on small, distant splats (c1_scene) against reference.py in
# float64 at each (width, height, splats) of C1_RUNS: 512^2, and the static
# path's 1237 x 822 at the same density of splats. Gate: no pixel's alpha
# more than C1_ALPHA_TOL from the reference's (ROADMAP C1). The reference
# evaluates C1_PIXEL_CHUNK pixels at a time.
C1_RUNS = ((512, 512, 192), (1237, 822, 745))
C1_ALPHA_TOL = 1.0 / 255.0
C1_PIXEL_CHUNK = 1 << 16
# [e2e]: the port's end-to-end quality run (`examples.synthetic_e2e.main`)
# at the JAX main run's width (64^2, 16 frames of the surfel GT, the
# Stage-2 / Stage-3 options of the JAX script) with the schedule cut to
# 2 x 60 Stage-2 and 4 x 75 Stage-3 steps. Gates: every metric finite, the
# render's foreground PSNR E2E_PSNR_MARGIN dB above an all-white frame's
# over the same GT foreground, mask IoU >= E2E_MIN_IOU; the launches K1 =
# GT frames + Stage-3 steps + one eval render per round + the reference
# render, K2 = Stage-3 steps, no plain call. Why this schedule (measured on
# the H100, PERF.md's end-to-end findings): the warp AdamW's OneCycle warm-up spans 2
# rounds, so a 2-round Stage 3 ends at its peak rate (2 x 50 steps: mask
# IoU 0.4751); after only 2 x 20 Stage-2 steps Stage 3 keeps or loses the
# object by chance (6 x 50 steps: IoU 0.9179 in one run, 0.0 in two
# others; 8 x 50: 0.0094 and 0.0), while after 2 x 60 the 4 x 75 steps
# reached 0.8964-0.9227 in three runs, with and without TF32 convolutions.
# Why the foreground PSNR: in 300 steps the learnable background has only
# reached grey (`learned_bg` in `[e2e]`, against the GT's white), which
# holds the full-frame PSNR ~1.5 dB above the white frame's
E2E_FLAGS = ["--res", "64", "--frames", "16", "--s2_rounds", "2", "--s2_iters", "60",
             "--s3_rounds", "4", "--s3_iters", "75"]
E2E_PSNR_MARGIN, E2E_MIN_IOU = 3.0, 0.7
# [depth eval]: both depth scorers at a small size (DepthNet on 1 batch of 4
# scenes at 64^2; the registration on 8 frames at 64^2): K1 once per scene
# and frame, every number finite
DE_DEPTHNET = ["--res", "64", "--batch", "4", "--rounds", "1"]
DE_REGISTRATION = ["--res", "64", "--frames", "8"]


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_scene(rng, n, res, frames, n_extra, device, deep=False, tile=16):
    """Seeded splat projections (M, P) + colours for the kernel checks.
    deep: every splat projects into the middle of one tile (of side
    ``tile``), with low opacities, so per-pixel chains run for hundreds of
    entries."""
    import torch

    from vidu4d_tpu_torch.ops.rasterize.common import project_splats

    shift = 0.0
    if deep:
        means = np.zeros((n, 3))
        means[:, :2] = rng.normal(0.0, 0.012, size=(n, 2))
        means[:, 2] = 2.0 + rng.uniform(0.0, 1.0, size=n)
        scales = np.full((n, 2), 0.01)
        opac = rng.uniform(0.005, 0.02, size=n)
        shift = tile / 2.0  # principal point in the middle of a tile
    else:
        means = rng.normal(size=(n, 3)) * 0.6 + np.array([0.0, 0.0, 3.0])
        scales = np.exp(rng.normal(size=(n, 2)) * 0.5) * 0.04
        opac = 1.0 / (1.0 + np.exp(-rng.normal(size=n)))
    quats = rng.normal(size=(frames, n, 4))
    means_b = np.stack([means + f * np.array([0.05, -0.03, 0.1]) for f in range(frames)])
    colors = rng.uniform(size=(frames, n, 3 + n_extra))
    if n_extra:
        colors[..., 3:] = rng.normal(size=(frames, n, n_extra))
    intr = np.tile([res * 1.0, res * 1.0, res / 2.0 + shift, res / 2.0 + shift],
                   (frames, 1))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    proj = project_splats(t(means_b), t(quats), t(scales), torch.eye(4, device=device),
                          t(intr))
    bg = t(rng.uniform(size=3 + n_extra))
    return proj, t(colors), t(opac), bg


def chain_batch(rng, seg, n_extra, device, tile=16):
    """Kernel inputs of one frame of 4 x 4 tiles of side ``tile`` built row
    by row, for the cases of the work-item split (items of ``seg``
    entries). Each row's response is nearly constant over the tile (A =
    (0, 0, 1), B and C ~1e-4, so at 64 x 64 alpha is opacity to 2e-4 and
    depth = q), which places every pixel's stop:
      tile 0: stops on the first entry of its second item (rank seg);
      tile 1: stops on the last entry of its first item (rank seg - 1);
      tile 2: 2 * seg low-alpha entries, an exact multiple of seg;
      tile 3: an opaque front layer stops every pixel within its first
              entries; 3 * seg entries behind it are dead;
      tile 5: one entry; the other tiles are empty.
    Returns a dict with the keys of tile_backward.prepare_batch."""
    import torch

    from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf

    # T after seg low-alpha entries ~3e-3: the next opaque entry stops
    a_low = 1.0 - 3e-3 ** (1.0 / seg)
    alphas = {
        0: [a_low] * seg + [1.0] + list(rng.uniform(0.01, 0.3, 200)),
        1: [a_low] * (seg - 1) + [1.0] + list(rng.uniform(0.01, 0.3, 50)),
        2: list(rng.uniform(0.002, 0.006, 2 * seg)),
        3: [0.85] * 8 + list(rng.uniform(0.01, 0.5, 3 * seg)),  # stop at rank 4
        5: [0.5],
    }
    tiles_x, tiles_per_frame = 4, 16
    width = tf.SLAB_WIDTH
    starts, counts, blocks, offset = [0] * tiles_per_frame, [0] * tiles_per_frame, [], 0
    for t, al in alphas.items():
        n = len(al)
        rows = np.zeros((-(-n // tf.CHUNK) * tf.CHUNK, width))
        rows[:n, tf.PA + 2] = 1.0
        rows[:n, tf.PB:tf.PB + 2] = rng.uniform(-1e-4, 1e-4, (n, 2))
        rows[:n, tf.PC:tf.PC + 2] = rng.uniform(-1e-4, 1e-4, (n, 2))
        rows[:n, tf.QD] = np.sort(rng.uniform(1.0, 5.0, n))
        rows[:n, tf.TW2] = rows[:n, tf.QD]
        rows[:n, tf.CX:tf.CY + 1] = -100.0  # centre far off: rho2d > rho3d, the 3D branch
        rows[:n, tf.OPAC] = al
        rows[:n, tf.RGB:tf.RGB + 3] = rng.uniform(size=(n, 3))
        nrm = rng.normal(size=(n, 3))
        rows[:n, tf.NRM:tf.NRM + 3] = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
        rows[:n, tf.EXTRA:tf.EXTRA + n_extra] = rng.normal(size=(n, n_extra))
        starts[t], counts[t] = offset, n
        blocks.append(rows)
        offset += rows.shape[0]
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return dict(slab=t(np.concatenate(blocks)), tile_start=t(starts, torch.int32),
                tile_count=t(counts, torch.int32), bg=t(rng.uniform(size=3 + n_extra)),
                tiles_x=tiles_x, tiles_y=4, tiles_per_frame=tiles_per_frame,
                n_extra=n_extra, tile=tile)


def check_forward(plain, kernel, name):
    """Hold the forward kernel's (color, aux) to its plain version's; return
    the largest smooth-channel error and the discontinuous channels'
    agreement."""
    (col_p, aux_p), (col_k, aux_k) = plain, kernel
    smooth = [i for i in range(12) if i not in (5, 7, 9)]
    fwd_err = max(float((col_k - col_p).abs().max()),
                  float((aux_k[..., smooth] - aux_p[..., smooth]).abs().max()))
    agree = {
        ch: float(((aux_k[..., i] - aux_p[..., i]).abs() <= FWD_TOL).float().mean())
        for ch, i in (("median_depth", 5), ("median_weight", 7), ("n_contrib", 9))
    }
    if not fwd_err <= FWD_TOL or min(agree.values()) < DISCONT_AGREE:
        per_ch = [float(x) for x in (col_k - col_p).abs().amax(dim=(0, 1))] + \
            [float(x) for x in (aux_k - aux_p).abs().amax(dim=(0, 1))]
        raise AssertionError(f"[{name}] forward kernel disagrees with its plain "
                             f"version: max_abs_err={fwd_err}, agree={agree}, "
                             f"per channel (color, aux)={per_ch}")
    return fwd_err, agree


def check_backward(g_p, g_k, name):
    """Hold the backward's grad slab to its plain version's, column by
    column; return the largest error, the largest |g|, and the largest
    per-column error as a share of that column's bound."""
    import torch

    col_err = (g_k - g_p).abs().amax(dim=0)
    col_max = g_p.abs().amax(dim=0)
    bwd_err, g_max = float(col_err.max()), float(col_max.max())
    bound = BWD_REL_TOL * col_max + BWD_FLOOR * g_max
    bad = torch.nonzero(col_err > bound).flatten()
    if bad.numel():
        raise AssertionError(
            f"[{name}] backward kernel disagrees with its plain version in slab "
            f"columns {bad.tolist()}: max_abs_err {col_err[bad].tolist()}, "
            f"max|g| {col_max[bad].tolist()}")
    return bwd_err, g_max, float((col_err / (bound + 1e-30)).max())


def compare_kernels(batch, rng, name, reps_k=20, reps_p=2, timed=False):
    """Run both kernels and both plain versions on one prepared batch;
    check the tolerances; return errors, the (entry, pixel) pairs these
    inputs need and each kernel's bound (`needed_pairs`, `kernel_bounds`),
    and (optionally) timings."""
    import torch

    from vidu4d_tpu_torch.ops.rasterize import tile_backward as tb
    from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf

    geo = (batch["tiles_x"], batch["tiles_per_frame"], batch["n_extra"], batch["tile"])
    fw_args = (batch["slab"], batch["tile_start"], batch["tile_count"], batch["bg"])
    col_k, aux_k = tf.forward_tiles(*fw_args, *geo)
    torch.cuda.synchronize()
    plain = tf.forward_tiles_plain(*fw_args, *geo)
    torch.cuda.synchronize()
    fwd_err, agree = check_forward(plain, (col_k, aux_k), name)

    nt = batch["tile_start"].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    cot = torch.randn((nt, batch["tile"] ** 2, 10 + batch["n_extra"]), device="cuda",
                      generator=gen)
    resid = aux_k[..., 8:12].contiguous()
    bw_args = (batch["slab"], batch["tile_start"], batch["tile_count"], cot, resid)
    g_k = tb.backward_tiles(*bw_args, *geo)
    torch.cuda.synchronize()
    g_p = tb.backward_tiles_plain(*bw_args, *geo)
    torch.cuda.synchronize()
    bwd_err, g_max, bwd_bound_share = check_backward(g_p, g_k, name)
    res = {"case": name, "fwd_max_abs_err": fwd_err, "fwd_discont_agree": agree,
           "bwd_max_abs_err": bwd_err, "bwd_max_abs_g": g_max,
           "bwd_bound_share": bwd_bound_share,
           "entries": int(batch["tile_count"].sum()),
           "max_tile": int(batch["tile_count"].max()), "tile": batch["tile"]}
    res["pairs"] = needed_pairs(batch, plain[1])
    res["bounds"] = kernel_bounds(batch, res["pairs"])
    if timed:
        # plain, kernel, kernel, plain: compare within one run, in turns
        fk = lambda: tf.forward_tiles(*fw_args, *geo)
        fp = lambda: tf.forward_tiles_plain(*fw_args, *geo)
        bk = lambda: tb.backward_tiles(*bw_args, *geo)
        bp = lambda: tb.backward_tiles_plain(*bw_args, *geo)
        fk(), bk()
        pf = [cuda_ms(fp, reps_p)]
        pb = [cuda_ms(bp, reps_p)]
        kf = [cuda_ms(fk, reps_k), cuda_ms(fk, reps_k)]
        kb = [cuda_ms(bk, reps_k), cuda_ms(bk, reps_k)]
        pf.append(cuda_ms(fp, reps_p))
        pb.append(cuda_ms(bp, reps_p))
        res.update(fwd_ms=float(np.mean(kf)), fwd_plain_ms=float(np.mean(pf)),
                   bwd_ms=float(np.mean(kb)), bwd_plain_ms=float(np.mean(pb)))
    log(f"[check] {json.dumps(res)}")
    return res


def kernel_cases(rng):
    """Each kernel vs its plain version on seeded scenes, the work-item
    split's cases included; the deep chain is timed. Returns the scenes'
    results by name."""
    import torch

    from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf
    from vidu4d_tpu_torch.ops.rasterize.tile_backward import prepare_batch

    cases = [
        ("64x64 2 frames X=0", dict(n=3000, res=64, frames=2, n_extra=0), 0),
        ("256x256 2 frames X=2", dict(n=40000, res=256, frames=2, n_extra=2), 0),
        (DEEP, dict(n=24000, res=64, frames=1, n_extra=0, deep=True), 0),
        ("256x256 entry_cap < entries", dict(n=40000, res=256, frames=2,
                                             n_extra=0), 40000),
        ("512x512 1 frame X=0", dict(n=60000, res=512, frames=1, n_extra=0), 0),
    ]
    results = {}
    for name, kw, cap in cases:
        with torch.no_grad():
            proj, colors, opac, bg = random_scene(rng, device="cuda", **kw)
            batch = prepare_batch(proj, colors, opac, bg, kw["res"], kw["res"],
                                  span_cap=4, entry_cap=cap)
        if cap:
            full = prepare_batch(proj, colors, opac, bg, kw["res"], kw["res"],
                                 span_cap=4, entry_cap=0)
            n_full, n_cap = int(full["tile_count"].sum()), int(batch["tile_count"].sum())
            if not n_cap < n_full:
                raise AssertionError(f"[{name}] entry_cap did not truncate "
                                     f"({n_cap} of {n_full})")
            log(f"[check] {name}: {n_cap} of {n_full} entries kept")
        results[name] = compare_kernels(batch, rng, name, timed=name == DEEP)
    # the split's own cases: a stop on the first and on the last entry of an
    # item, a tile of exactly 2 items, an opaque front layer (later items dead)
    for n_extra in (0, 2):
        batch = chain_batch(rng, tf.SEG, n_extra, "cuda")
        compare_kernels(batch, rng, f"item boundaries X={n_extra} (SEG {tf.SEG})")
    return results


def tile_histogram(counts):
    """Entries per (frame, tile) block of a batch, over the occupied ones."""
    occ = counts[counts > 0].double()
    return {"tiles": int(counts.numel()), "occupied": int(occ.numel()),
            "max": int(occ.max()), "p99": float(occ.quantile(0.99)),
            "mean": float(occ.mean())}


def work_list_report(counts, n_rows, label):
    """The kernels' work list over `counts`: every tile's entries covered
    once, no item longer than SEG, the items within the launch grid."""
    from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf

    item_off, grid = tf.work_list(counts, n_rows)
    _, _, n = tf.decode_items(item_off, counts)
    rep = {"seg": tf.SEG, "items": int(item_off[-1]), "grid": grid,
           "max_entries_per_item": int(n.max()) if n.numel() else 0,
           "max_items_per_tile": int((item_off[1:] - item_off[:-1]).max())}
    log(f"[work list {label}] {json.dumps(rep)}")
    if not (rep["max_entries_per_item"] <= tf.SEG and rep["items"] <= grid
            and int(n.sum()) == int(counts.sum())):
        raise AssertionError(f"[work list {label}] breaks its contract: {rep}")


def needed_pairs(batch, aux):
    """(entry, pixel) pairs these inputs need, from the plain version's
    aux: the forward visits each pixel's entries up to its stop (the first
    candidate at or after its n_contrib, else the tile's end), and
    composites the candidates below n_contrib (included); the backward
    needs the response of each pixel's entries below its n_contrib
    (bwd_responses) and differentiates the included pairs. bwd_walked is
    what the backward kernel walks: every tile's entries below count_eff,
    its largest n_contrib, for all of the tile's pixels."""
    import torch

    from vidu4d_tpu_torch.ops.rasterize import common
    from vidu4d_tpu_torch.ops.rasterize import tile_backward as tb
    from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf

    slab, start, count = batch["slab"], batch["tile_start"], batch["tile_count"]
    nt = start.shape[0]
    ncon = aux[..., 9]
    pxf, pyf = tf._pixel_centers(nt, batch["tiles_x"], batch["tiles_per_frame"],
                                 slab.device, batch["tile"])
    stop = torch.full_like(ncon, -1.0)
    included = 0
    k = torch.arange(tf.CHUNK, device=slab.device)
    with torch.no_grad():
        for base in range(0, int(count.max()), tf.CHUNK):
            rank = base + k
            valid = rank[None, :] < count[:, None]
            idx = torch.clamp(start[:, None].long() + rank[None, :], max=slab.shape[0] - 1)
            r = tf.splat_response(slab[idx], pxf[:, None, :], pyf[:, None, :])
            alpha = torch.clamp(r["alpha_raw"], max=common.ALPHA_CLAMP)
            cand = (r["pz_ok"] & (r["depth"] >= common.NEAR_PLANE)
                    & (alpha >= common.ALPHA_EPS) & valid[..., None])
            below = rank.float()[None, :, None] < ncon[:, None, :]
            included += int((cand & below).sum())
            after = (cand & ~below).int()
            first = torch.where(after.any(1), base + after.argmax(1).float(), -1.0)
            stop = torch.where((stop < 0) & (first >= 0), first, stop)
    visited = torch.where(stop >= 0, stop + 1, count[:, None].float())
    count_eff = tb.effective_counts(count, aux[..., 8:12])
    return {"fwd_visited": int(visited.sum()), "included": included,
            "bwd_responses": int(ncon.double().sum()),
            "bwd_walked": int(count_eff.sum()) * batch["tile"] ** 2,
            "count_eff_entries": int(count_eff.sum())}


def kernel_bounds(batch, pairs):
    """The least time the card could take for each kernel's work on these
    inputs: the larger of its FP32 operations over 67 TFLOP/s and its bytes
    (inputs read once, outputs written once) over 3.35 TB/s."""
    x = batch["n_extra"]
    nt = batch["tile_start"].shape[0]
    px_n = batch["tile"] ** 2
    fwd_ops = OPS_RESPONSE * pairs["fwd_visited"] + (29 + 2 * x) * pairs["included"]
    bwd_ops = OPS_RESPONSE * pairs["bwd_responses"] + (105 + 4 * x) * pairs["included"]
    row = 32 * 4
    fwd_bytes = (int(batch["tile_count"].sum()) * row + nt * 8 + (3 + x) * 4
                 + nt * px_n * (3 + x + 12) * 4)
    # slab rows below count_eff read, their grad rows written (the rest of
    # the grad slab is zero-filled by torch, outside the kernel)
    bwd_bytes = (2 * pairs["count_eff_entries"] * row + nt * 8
                 + nt * px_n * (10 + x + 4) * 4)
    out = {}
    for name, ops, nbytes in (("tile_forward", fwd_ops, fwd_bytes),
                              ("tile_backward", bwd_ops, bwd_bytes)):
        t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return out


def scene_target(n, surface=False):
    """Camera-space points the cloud is placed at: bench.py's Gaussian blob
    (sd 0.05, 0.06, 0.035 at depth 0.38), or with ``surface`` an ellipsoid
    shell of semi-axes 2 sd with 1% radial jitter, 1% of the points moved
    to a sparse halo in the box of 3 sd: surfels on a surface, as in a
    trained scene, which the radius-outlier rule (20 neighbours within
    0.004) keeps, and stray ones, which it prunes."""
    rngl = np.random.default_rng(1)
    sd, centre = np.array([0.05, 0.06, 0.035]), np.array([0.0, 0.0, 0.38])
    if not surface:
        return (rngl.normal(size=(n, 3)) * sd + centre).astype(np.float32)
    u = rngl.normal(size=(n, 3))
    pts = (u / np.linalg.norm(u, axis=-1, keepdims=True) * 2.0 * sd
           * (1.0 + 0.01 * rngl.normal(size=(n, 1))))
    halo = rngl.permutation(n)[:n // 100]
    pts[halo] = rngl.uniform(-3.0 * sd, 3.0 * sd, (len(halo), 3))
    return (pts + centre).astype(np.float32)


def calibrate_scene(trainer, pts, batch, target):
    """bench.py:_calibrate_scene through the port's warp: affine-fit
    cam = world @ A + b on a subsample, solve for a cloud that lands on
    the camera-space ``target`` points; iterate to absorb the warp's
    nonlinearity."""
    import torch

    d = trainer.deformer
    dev = trainer.device
    n = pts.shape[0]
    with torch.no_grad():
        samples = d.get_samples(batch)
        rot = torch.zeros((n, 4), device=dev)
        rot[:, 0] = 1.0
        sub = np.arange(0, n, max(1, n // 2048))
        for _ in range(3):
            xc = d.warp_surfels(torch.as_tensor(pts, device=dev), rot, samples)[0]
            xc = xc.cpu().numpy()
            x_s = np.concatenate([pts[sub]] * xc.shape[0])
            y_s = np.concatenate([xc[f][sub] for f in range(xc.shape[0])])
            xh = np.concatenate([x_s, np.ones((len(x_s), 1), np.float32)], 1)
            w, *_ = np.linalg.lstsq(xh, y_s, rcond=None)
            pts = ((target - w[3]) @ np.linalg.pinv(w[:3], rcond=1e-3)).astype(np.float32)
    return pts


def scene_diag(prepared):
    """Per-frame valid surfels / entries the kernels see / occupied tiles /
    densest tile, from the kernels' inputs of one step."""
    counts = prepared["tile_count"].reshape(-1, prepared["tiles_per_frame"])
    return {"valid": prepared["valid"].tolist(),
            "entries": counts.sum(dim=1).tolist(),
            "tiles_occupied": (counts > 0).sum(dim=1).tolist(),
            "max_tile": counts.amax(dim=1).tolist()}


def load_test_module(name):
    """tests/<name>.py, loaded by path: an installed package named
    ``tests`` would shadow the repo's (a directory without __init__.py).
    torch's CPU thread count is kept (tests/torch_parity.py lowers it for
    pytest's workers)."""
    import importlib.util

    import torch

    threads = torch.get_num_threads()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"vidu4d_test_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.set_num_threads(threads)
    return mod


def build_trainer(tmp, device, surfels, res, frames=2, reduced=False, capacity=None,
                  surface=False, **extra):
    """The bench.py workload through the port's trainer: the default
    configuration (or the reduced one), pixel-true intrinsics, a cloud
    placed through the warp on one batch, 16-dim registration features, in
    a store of ``capacity`` slots (default: ``surfels``, no dead slot);
    ``surface``: the cloud on `scene_target`'s shell, and the camera MLP's
    output layers set to the identity pose in every frame, so that every
    frame sees the cloud, as a video's camera keeps its subject in view
    (the random time-varying pose puts the cloud behind the camera in
    some frames, frame 0, the eval render's, among them);
    ``extra``: more options. Returns (trainer, that batch)."""
    import torch

    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer
    from vidu4d_tpu_torch.models.fields.time_mlp import init_intrinsics_base_params
    from vidu4d_tpu_torch.models.gaussian.surfels import init_from_points

    db = load_test_module("helpers").make_fake_db(tmp, num_vids=1, T=16, H=res, W=res)
    opts = {
        "dataroot": db, "seqname": "toy", "logname": "smoke",
        "logroot": os.path.join(tmp, "logdir"), "data_prefix": "crop",
        "train_res": res, "pixels_per_image": -1, "imgs_per_gpu": frames // 2,
        "fg_motion": "gs-bob", "gs_capacity": capacity or surfels,
        "gs_init_samples": surfels, "sh_degree": 3, "raster_impl": "pallas_grad",
        "raster_span_cap": 4, "num_rounds": 60, "iters_per_round": 200,
        "lambda_dist": MAIN_LAMBDA_DIST, **(REDUCED if reduced else {}), **extra,
    }
    trainer = Stage3Trainer(opts, device)
    n_frames = int(np.asarray(trainer.frame_info.frame_offset)[-1])
    prior = np.tile(np.array([1.2 * res, 1.2 * res, res / 2, res / 2], np.float32),
                    (n_frames, 1))
    init_intrinsics_base_params(trainer.deformer.intrinsics, prior, trainer.frame_info)
    if surface:
        cam = trainer.deformer.camera_mlp
        with torch.no_grad():
            for head, bias in ((cam.trans_head, (0.0, 0.0, 0.0)),
                               (cam.quat_head, (1.0, 0.0, 0.0, 0.0))):
                head.out.weight.zero_()
                head.out.bias.copy_(torch.tensor(bias))
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(surfels, 3)).astype(np.float32)
    pts *= np.array([0.03, 0.04, 0.03], np.float32)
    batch = trainer._next_batch()
    pts = calibrate_scene(trainer, pts, batch, scene_target(surfels, surface))
    cols = rng.uniform(size=(surfels, 3)).astype(np.float32)
    feats = rng.normal(size=(surfels, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    t = lambda a: torch.as_tensor(a, device=trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    trainer.set_surfels(init_from_points(t(pts), t(cols), capacity or surfels, sh_degree=3,
                                         generator=gen, regist_feat=t(feats)))
    return trainer, batch


def small_step_vs_cpu(tmp, use_2dgs_reg, fg_motion="gs-bob", raster_tile=16):
    """One step at 64^2 / 4k surfels in the default configuration (with
    ``fg_motion`` and tile side ``raster_tile``) on the card (kernels) and
    on the CPU (plain versions) from the same state and batch: the port's
    own reference on a small input. For a motion other than gs-bob, at most STATIC_SMALL_ROWS
    surfels may have a gradient beyond the bound, each within
    STATIC_SMALL_ROW_TOL of the field's max (the static check's rule; on
    the H100, gs-denseSE3 had one surfel's xyz gradient at 5.8e-3 of the
    max). Returns the card step's kernel launches."""
    import torch

    from vidu4d_tpu_torch import kernels
    from vidu4d_tpu_torch.engine.optim import lr_multiplier
    from vidu4d_tpu_torch.models.gaussian.surfels import SurfelState, SurfelParams
    from vidu4d_tpu_torch.models.gaussian.optimizer import gs_adam_init

    tag = f"2dgs{int(use_2dgs_reg)}_{fg_motion}_tile{raster_tile}"
    cpu, batch = build_trainer(os.path.join(tmp, f"small_cpu_{tag}"), "cpu", 4096, 64,
                               fg_motion=fg_motion, raster_tile=raster_tile)
    gpu, _ = build_trainer(os.path.join(tmp, f"small_gpu_{tag}"), "cuda", 4096, 64,
                           fg_motion=fg_motion, raster_tile=raster_tile)
    gpu.deformer.load_state_dict(cpu.deformer.state_dict())
    s = cpu.surfels
    gpu.surfels = SurfelState(
        params=SurfelParams(*[p.detach().clone().cuda().requires_grad_(True)
                              for p in s.params]),
        alive=s.alive.cuda(), max_radii2d=s.max_radii2d.cuda(),
        grad_accum=s.grad_accum.cuda(), denom=s.denom.cuda())
    gpu.gs_adam = gs_adam_init(gpu.surfels.params)
    m_cpu = cpu.train_step(batch, use_2dgs_reg=use_2dgs_reg)
    kernels.reset_counts()
    m_gpu = gpu.train_step({k: v.cuda() for k, v in batch.items()},
                           use_2dgs_reg=use_2dgs_reg)
    torch.cuda.synchronize()
    counts = dict(kernels.COUNTS)
    out, bad = {"launches": counts}, []
    terms = DEFAULT_TERMS | (REG_2DGS_TERMS if use_2dgs_reg else set())
    terms -= S3_MOTION_NO_TERMS.get(fg_motion, set())
    if not terms <= set(m_cpu) or set(m_cpu) != set(m_gpu):
        raise AssertionError(f"small step: loss terms cpu {sorted(m_cpu)} gpu "
                             f"{sorted(m_gpu)}, expected {sorted(terms)}")
    for k in sorted(terms | {"total", "gnorm"}):
        a, b = float(m_cpu[k]), float(m_gpu[k])
        rel, floor = (1e-3, 0.0) if k == "gnorm" else (STEP_LOSS_REL_TOL, STEP_LOSS_ABS_TOL)
        out[k] = {"cpu": a, "gpu": b, "rel": abs(a - b) / max(abs(a), 1e-30)}
        if not (np.isfinite(b) and abs(a - b) <= rel * abs(a) + floor):
            bad.append(k)
    # gradients (kept on the leaves after the step); the first Adam step
    # moves every param by ~lr * sign(g), so compare g itself
    groups = [("surfel", [(f, getattr(cpu.surfels.params, f).grad,
                           getattr(gpu.surfels.params, f).grad)
                          for f in ("xyz", "opacity", "features_dc", "scaling",
                                    "rotation", "regist_feat")]),
              ("deformer", [(k, p.grad, dict(gpu.deformer.named_parameters())[k].grad)
                            for k, p in cpu.deformer.named_parameters()
                            if p.grad is not None])]
    for group, items in groups:
        g_all = max(float(gc.abs().max()) for _, gc, _ in items)
        worst = (0.0, "")
        for name, gc, gg in items:
            diff = (gc - gg.cpu()).abs()
            err = float(diff.max())
            bound = STEP_GRAD_REL_TOL * float(gc.abs().max()) + STEP_GRAD_FLOOR * g_all
            if not err <= bound:
                rows = torch.nonzero((diff.reshape(diff.shape[0], -1) > bound).any(-1))
                if group == "surfel":  # the surfels whose rows are beyond it
                    out[f"rows_beyond {name}"] = {
                        "count": int(rows.numel()), "first": rows.flatten()[:8].tolist(),
                        "worst_over_max": err / float(gc.abs().max())}
                # the other motions: as the static step, a few surfels may
                # exceed the bound, each within STATIC_SMALL_ROW_TOL of the max
                few = (fg_motion != "gs-bob" and group == "surfel"
                       and rows.numel() <= STATIC_SMALL_ROWS
                       and err <= STATIC_SMALL_ROW_TOL * float(gc.abs().max()))
                if not few:
                    bad.append(f"grad {name}")
            worst = max(worst, (err / bound, name))
        out[f"{group}_grad_worst_share_of_bound"] = {"share": worst[0], "name": worst[1]}
    # the deformer after its first AdamW update
    lr0 = cpu.warp_opt.schedule(0)
    gpu_params = dict(gpu.deformer.named_parameters())
    worst = 0.0
    for k, p in cpu.deformer.named_parameters():
        bound = 2 * lr0 * lr_multiplier(k)
        diff = (p.detach() - gpu_params[k].detach().cpu()).abs()
        g = cpu.warp_opt.mu[k].abs()
        big = g > 1e-2 * g.max()
        ok = float(diff.max()) <= bound + 1e-6 and (
            not bool(big.any()) or float(diff[big].max()) <= 1e-6 + 1e-3 * bound)
        worst = max(worst, float(diff.max()) / bound)
        if not ok:
            bad.append(f"param {k}")
    out["deformer_param_diff_over_2lr"] = worst
    label = (f"2dgs={use_2dgs_reg}" + ("" if fg_motion == "gs-bob" else f" {fg_motion}")
             + ("" if raster_tile == 16 else f" raster_tile={raster_tile}"))
    log(f"[small step cpu-vs-gpu {label}] {json.dumps(out)}")
    if bad:
        raise AssertionError(f"small step ({label}): {bad} differ beyond their tolerance")
    if (counts["tile_forward"] < 1 or counts["tile_backward"] < 1
            or counts["tile_forward_plain"] or counts["tile_backward_plain"]):
        raise AssertionError(f"small step ({label}) on the card: launches {counts}")
    return counts


def tile_path(tmp, rng, trainer, batch):
    """[tile]: the tile sides TILE_PHASE_SIDES on the main path's workload.
    For each side: both kernels against their plain versions on the kernel
    inputs of ``trainer``'s step on ``batch`` binned at that side (timed,
    with their pairs and bounds), the tile depths and both work lists;
    then one small step at that side on the card against the CPU
    (`small_step_vs_cpu`), its launches counted from 0. Returns {side:
    (kernel check, the card step's launches)}."""
    import torch

    from vidu4d_tpu_torch.ops.rasterize import tile_backward as tb
    from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf

    out = {}
    cfg = trainer.raster_cfg
    for side in TILE_PHASE_SIDES:
        trainer.raster_cfg = cfg._replace(tile=side)
        try:
            with torch.no_grad():
                b, _ = trainer.render_inputs(batch)
        finally:
            trainer.raster_cfg = cfg
        if b["tile"] != side or b["tiles_x"] != -(-MAIN_RES // side):
            raise AssertionError(f"[tile {side}] binned at {b['tile']}, {b['tiles_x']} tiles")
        label = f"tile {side}"
        log(f"[tiles {label}] {json.dumps(tile_histogram(b['tile_count']))}")
        cmp = compare_kernels(b, rng, f"{label}: main path 200k 256x256 2 frames X=2",
                              reps_p=1, timed=True)
        _, aux = tf.forward_tiles_plain(b["slab"], b["tile_start"], b["tile_count"], b["bg"],
                                        b["tiles_x"], b["tiles_per_frame"], b["n_extra"],
                                        side)
        work_list_report(b["tile_count"], b["slab"].shape[0], f"{label} fwd")
        work_list_report(tb.effective_counts(b["tile_count"], aux[..., 8:12]),
                         b["slab"].shape[0], f"{label} bwd")
        log(f"[pairs {label}] {json.dumps(cmp['pairs'])}")
        log(f"[bounds {label}] {json.dumps(cmp['bounds'])}")
        del b, aux
        counts = small_step_vs_cpu(tmp, False, raster_tile=side)
        log(f"[counts {label}] {json.dumps(counts)}")
        out[side] = (cmp, counts)
        torch.cuda.empty_cache()
    return out


def run_steps(trainer, batch, phases, label):
    """Run (n_steps, use_2dgs_reg, timed) phases on one batch with the launch
    counters from 0; check losses, gnorm and counters. Returns (step_ms of
    the timed steps, counters, metrics of the last step of each phase)."""
    import torch

    from vidu4d_tpu_torch import kernels

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    step_ms, last = [], []
    for n_steps, reg, timed in phases:
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch, use_2dgs_reg=reg)
            torch.cuda.synchronize()
            if timed:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            bad = [k for k, v in metrics.items() if not np.isfinite(float(v))]
            if bad:
                raise AssertionError(f"[{label}] non-finite {bad}: {metrics}")
        last.append({k: float(v) for k, v in metrics.items()})
    counts = dict(kernels.COUNTS)
    for m in last:
        log(f"[steps {label}] metrics {json.dumps(m)}")
    log(f"[steps {label}] step_ms {json.dumps([round(x, 3) for x in step_ms])} "
        f"median {float(np.median(step_ms)):.3f} ms "
        f"peak_mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[counts {label}] {json.dumps(counts)}")
    if counts["tile_forward"] < 1 or counts["tile_backward"] < 1:
        raise AssertionError(f"[{label}] a kernel of the path never launched: {counts}")
    if counts["tile_forward_plain"] or counts["tile_backward_plain"]:
        raise AssertionError(f"[{label}] a plain version ran on the path: {counts}")
    return step_ms, counts, last


def hook_state(rng, cap, n_alive):
    """numpy arrays of a surfel store of ``cap`` slots, ``n_alive`` of them
    alive, in which the densify rules fire (clone, split, opacity, screen-
    and world-size prune, child prune) and the outlier rule splits the
    cloud: four clusters of ~radius spread near the origin, a sparse halo.
    Returns (params dict, state dict, adam moments (mu, nu))."""
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    n_cl = 3 * cap // 8
    centres = rng.uniform(-0.05, 0.05, (4, 3))
    xyz = np.concatenate([c + rng.normal(size=(n_cl // 4, 3)) * 0.002 for c in centres]
                         + [rng.uniform(-0.2, 0.2, (cap - n_cl // 4 * 4, 3))])
    params = {
        "xyz": xyz.astype(np.float32), "features_dc": f(cap, 1, 3),
        "features_rest": f(cap, 15, 3) * 0.1,
        "scaling": np.log(10 ** rng.uniform(-3.3, -0.95, (cap, 2))).astype(np.float32),
        "rotation": f(cap, 4), "opacity": f(cap, 1) * 2.0 - 2.0, "regist_feat": f(cap, 16),
    }
    denom = rng.integers(0, 6, cap).astype(np.float32)
    grads = 2e-4 * np.exp(rng.normal(size=cap))
    state = {"alive": rng.permutation(cap) < n_alive,
             "max_radii2d": rng.uniform(0, 21, cap).astype(np.float32),
             "grad_accum": (grads * denom).astype(np.float32), "denom": denom}
    moments = tuple({k: f(*v.shape) * scale for k, v in params.items()}
                    for scale in (1.0, 0.1))
    return params, state, moments


def hooks_cpu_vs_gpu(rng):
    """densify_and_prune (size rules on), reset_opacity and
    radius_outlier_mask from one state (capacity HOOK_CAP, HOOK_ALIVE alive,
    the same split noise) on the CPU and on the card: info counts and masks
    equal, float rows within HOOK_TOL (relative above 1), the outlier masks
    equal except slots with an alive neighbour within the float32 rounding
    of |q|^2 + |p|^2 - 2 q.p (or 1e-6 r^2) of the radius, listed."""
    import torch

    from vidu4d_tpu_torch.models.gaussian import densify as dn
    from vidu4d_tpu_torch.models.gaussian.optimizer import GsAdamState
    from vidu4d_tpu_torch.models.gaussian.surfels import SurfelParams, SurfelState

    params, state, (mu, nu) = hook_state(rng, HOOK_CAP, HOOK_ALIVE)
    noise = rng.normal(size=(HOOK_CAP, 2, 2)).astype(np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.tensor(a, device=dev)  # a copy: the hooks write in place
        tree = lambda d: SurfelParams(**{k: t(v) for k, v in d.items()})
        s = SurfelState(params=tree(params), **{k: t(v) for k, v in state.items()})
        a = GsAdamState(count=3, mu=tree(mu), nu=tree(nu))
        s, a, info = dn.densify_and_prune(s, a, t(noise), extent=1.0, max_screen_size=20.0)
        # copies: on the CPU .numpy() is a view, and reset_opacity writes in place
        npy = lambda x: x.detach().cpu().numpy().copy()
        out = {"info": {k: int(v) for k, v in info.items()}, "alive": npy(s.alive)}
        for group, tr in (("", s.params), ("mu.", a.mu), ("nu.", a.nu)):
            out.update({group + k: npy(v) for k, v in zip(SurfelParams._fields, tr)})
        s, a = dn.reset_opacity(s, a)
        out["reset opacity"] = npy(s.params.opacity)
        out["outlier"] = npy(dn.radius_outlier_mask(s.params.xyz, s.alive))
        res[dev] = out
    cpu, gpu = res["cpu"], res["cuda"]
    rep = {"info": cpu["info"], "info_gpu": gpu["info"],
           "alive_equal": bool(np.array_equal(cpu["alive"], gpu["alive"])),
           "outlier_pruned": int(cpu["outlier"].sum())}
    errs = {k: float((np.abs(cpu[k] - gpu[k]) / np.maximum(1.0, np.abs(cpu[k]))).max())
            if cpu[k].size else 0.0
            for k in cpu if k not in ("info", "alive", "outlier")}
    rep["max_err"] = max(errs.values())
    rep["worst"] = max(errs, key=errs.get)
    # outlier mismatches: slots with a pair at the radius within rounding
    r2 = 0.004 ** 2
    xyz = cpu["xyz"].astype(np.float64)
    sq = (xyz * xyz).sum(-1)
    boundary, other = [], []
    for i in np.flatnonzero(cpu["outlier"] != gpu["outlier"]):
        d2 = ((xyz - xyz[i]) ** 2).sum(-1)
        band = 1e-6 * r2 + 4 * np.finfo(np.float32).eps * (sq[i] + sq)
        near = cpu["alive"] & (np.abs(d2 - r2) <= band)
        (boundary if near.any() else other).append(int(i))
    rep["outlier_boundary_slots"] = boundary
    log(f"[hooks cpu-vs-gpu] {json.dumps(rep)} per field {json.dumps(errs)}")
    if (cpu["info"] != gpu["info"] or not rep["alive_equal"] or rep["max_err"] > HOOK_TOL
            or other):
        raise AssertionError(f"[hooks cpu-vs-gpu] the card disagrees with the CPU: {rep}, "
                             f"outlier slots off the boundary {other}")
    if not (cpu["info"]["cloned"] and cpu["info"]["split"] and cpu["info"]["pruned"]
            and 0 < rep["outlier_pruned"] < int(cpu["alive"].sum())):
        raise AssertionError(f"[hooks cpu-vs-gpu] a rule did not fire: {rep}")


def round_path(tmp, rng, surfels, capacity, res):
    """The Stage-3 round loop on the card at ``capacity`` slots with
    ``surfels`` alive: `train()` for ROUND_OPTS' 2 rounds (eval render,
    hooks, checkpoints), the checkpoint reloaded into a fresh trainer
    (bitwise), then one `train_one_round` in chunks of 3 (ROUND_K3). Times
    every step, eval render, checkpoint and hook, checks each, and counts
    the kernel launches from 0; then holds both kernels against their plain
    versions on the inputs of ROUND_CHECKS, kept from the run. Returns
    (report, launch counts)."""
    import torch

    from vidu4d_tpu_torch import kernels
    from vidu4d_tpu_torch.engine import gs4d_trainer
    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer
    from vidu4d_tpu_torch.models.gaussian import deformable
    from vidu4d_tpu_torch.models.gaussian import densify as dn
    from vidu4d_tpu_torch.models.gaussian.surfels import get_opacity

    sync = torch.cuda.synchronize
    trainer, _ = build_trainer(os.path.join(tmp, "round"), "cuda", surfels, res,
                               capacity=capacity, surface=True, **ROUND_OPTS)
    rec = {"step_ms": [], "render_ms": [], "save_ms": [], "hooks": [], "render_k1": 0,
           "render_cover": []}
    kept = {}  # ROUND_CHECKS name -> detached copies of the kernels' inputs

    def timed(fn, key):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            rec[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def keep(fn, where):
        """composite_batch, keeping the inputs that ROUND_CHECKS names."""
        def run(prepared, *a, **kw):
            for name, (w, at) in ROUND_CHECKS.items():
                if w == where and at == trainer.current_steps and name not in kept:
                    kept[name] = {k: prepared[k].detach().clone()
                                  if torch.is_tensor(prepared[k]) else prepared[k]
                                  for k in KERNEL_INPUTS}
            return fn(prepared, *a, **kw)
        return run

    step, render = (timed(trainer.train_step, "step_ms"),
                    timed(trainer.render_batch, "render_ms"))

    def train_step(*a, **kw):
        m = step(*a, **kw)
        bad = [k for k, v in m.items() if not np.isfinite(float(v))]
        if bad:
            raise AssertionError(f"[round] step {trainer.current_steps}: non-finite {bad}")
        return m

    def render_batch(*a, **kw):
        k1, k2 = kernels.COUNTS["tile_forward"], kernels.COUNTS["tile_backward"]
        out = render(*a, **kw)
        if kernels.COUNTS["tile_backward"] != k2:
            raise AssertionError("[round] the eval render launched the backward kernel")
        rec["render_k1"] += kernels.COUNTS["tile_forward"] - k1
        if not all(np.isfinite(v).all() for v in out.values()):
            raise AssertionError("[round] non-finite eval render")
        rec["render_cover"].append(float((out["mask"] > 0.01).mean()))
        return out

    def alive_finite(s):
        return all(bool(torch.isfinite(p[s.alive]).all()) for p in s.params)

    def hook(name, fn):
        def run(*a, **kw):
            n_before = int(a[0].alive.sum()) if name != "outlier" else None
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            ev = {"hook": name, "at_step": trainer.current_steps,
                  "ms": (time.perf_counter() - t0) * 1e3}
            if name == "densify":
                s, _, info = out
                ev.update(max_screen_size=kw["max_screen_size"], alive_before=n_before,
                          **{k: int(v) for k, v in info.items()})
                n = int(s.alive.sum())
                if not (n == ev["alive"] and n_before - ev["split"] - ev["pruned"] <= n
                        <= n_before + ev["cloned"] + ev["split"]):
                    raise AssertionError(f"[round] alive after densify disagrees with "
                                         f"its counts: {n}, {ev}")
                if not alive_finite(s):
                    raise AssertionError(f"[round] non-finite surfels after densify: {ev}")
            elif name == "reset_opacity":
                s = out[0]
                ev["alive_before"] = n_before
                ev["max_alive_opacity"] = float(torch.where(
                    s.alive[:, None], get_opacity(s.params).detach(), 0.0).max())
                if not ev["max_alive_opacity"] <= 0.01 + 1e-6 or not alive_finite(s):
                    raise AssertionError(f"[round] opacity reset: {ev}")
            else:
                ev.update(outliers=int(out.sum()), alive_before=int(a[1].sum()))
            rec["hooks"].append(ev)
            return out
        return run

    trainer.train_step, trainer.render_batch = train_step, render_batch
    trainer.save_checkpoint = timed(trainer.save_checkpoint, "save_ms")
    wraps = {(dn, "densify_and_prune"): lambda f: hook("densify", f),
             (dn, "reset_opacity"): lambda f: hook("reset_opacity", f),
             (dn, "radius_outlier_mask"): lambda f: hook("outlier", f),
             (deformable, "composite_batch"): lambda f: keep(f, "render"),
             (gs4d_trainer, "composite_batch"): lambda f: keep(f, "step")}
    originals = {key: getattr(*key) for key in wraps}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    try:
        for (mod, k), wrap in wraps.items():
            setattr(mod, k, wrap(originals[mod, k]))
        trainer.train()
        save_dir = trainer.save_dir
        files = {f: os.path.getsize(os.path.join(save_dir, f)) for f in sorted(os.listdir(
            save_dir)) if f.endswith((".pth", ".ply"))}
        want = {"ckpt_0001.pth", "ckpt_0002.pth", "ckpt_latest.pth", "point_cloud_0001.ply",
                "point_cloud_0002.ply"}
        if not want <= set(files):
            raise AssertionError(f"[round] checkpoint files: {sorted(files)}")
        # the last checkpoint into a fresh trainer: bitwise the live state
        fresh = Stage3Trainer({**trainer.opts, "logname": "reload"}, "cuda")
        fresh.load_checkpoint(os.path.join(save_dir, "ckpt_latest.pth"), reset_steps=False)
        pairs = [(f"surfels.{i}", x, y) for i, (x, y) in enumerate(zip(
            (*trainer.surfels.params, *trainer.surfels[1:]),
            (*fresh.surfels.params, *fresh.surfels[1:])))]
        pairs += [(f"adam.{i}", x, y) for i, (x, y) in enumerate(zip(
            (*trainer.gs_adam.mu, *trainer.gs_adam.nu), (*fresh.gs_adam.mu, *fresh.gs_adam.nu)))]
        fd = fresh.deformer.state_dict()
        pairs += [(k, v, fd[k]) for k, v in trainer.deformer.state_dict().items()]
        differ = [k for k, x, y in pairs if not torch.equal(x, y)]
        if differ or fresh.gs_adam.count != trainer.gs_adam.count or \
                fresh.current_steps != trainer.current_steps:
            raise AssertionError(f"[round] the reloaded checkpoint differs: {differ}")
        del fresh
        n_reload = len(pairs)
        # one more round in chunks of 3, 3, 3 and 2
        trainer.opts.update(ROUND_K3)
        sync()
        t0 = time.perf_counter()
        trainer.train_one_round()
        sync()
        k3_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (mod, k), fn in originals.items():
            setattr(mod, k, fn)
    counts = dict(kernels.COUNTS)
    # the kernels against their plain versions on the run's own inputs
    # (after the counts are read: these launches are not the path's)
    missing = sorted(set(ROUND_CHECKS) - set(kept))
    if missing:
        raise AssertionError(f"[round] no kernel inputs kept for {missing}")
    checks = {}
    for name, (where, _) in ROUND_CHECKS.items():
        b = kept.pop(name)
        r = compare_kernels(b, rng, f"round: {name}")
        checks[name] = {"frames": b["tile_start"].shape[0] // b["tiles_per_frame"],
                        "n_extra": b["n_extra"], "entries": r["entries"],
                        "max_tile": r["max_tile"], "fwd_max_abs_err": r["fwd_max_abs_err"],
                        "bwd_max_abs_err": r["bwd_max_abs_err"]}
        del b
    n_steps = len(rec["step_ms"])
    fired = [(h["hook"], h["step"], e["at_step"]) for h, e in zip(trainer.hook_log,
                                                                   rec["hooks"])]
    by_hook = {}
    for e in rec["hooks"]:
        by_hook.setdefault(e["hook"], []).append(round(e["ms"], 3))
    rep = {
        "capacity": capacity, "alive_start": surfels, "res": res, "steps": n_steps,
        "alive_end": int(trainer.surfels.alive.sum()),
        "step_ms_median": float(np.median(rec["step_ms"])),
        "step_ms": [round(x, 3) for x in rec["step_ms"]],
        "round_wall_ms": [round(s * 1e3, 3) for s in trainer.round_seconds],
        "k3_round_ms": round(k3_ms, 3),
        "eval_render_ms": [round(x, 3) for x in rec["render_ms"]],
        "eval_render_cover": rec["render_cover"],
        "save_ms": [round(x, 3) for x in rec["save_ms"]], "file_bytes": files,
        "hook_ms": by_hook, "fired": fired, "reload_tensors_equal": n_reload,
        "eval_render_k1": rec["render_k1"], "counts": counts, "kernel_checks": checks,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    for e in rec["hooks"]:
        log(f"[round hook] {json.dumps(e)}")
    log(f"[round] {json.dumps(rep)}")
    dens = [e for e in rec["hooks"] if e["hook"] == "densify"]
    problems = []
    n_rounds = ROUND_OPTS["num_rounds"]
    if n_steps != n_rounds * ROUND_OPTS["iters_per_round"] + ROUND_K3["iters_per_round"]:
        problems.append(f"{n_steps} steps")
    if fired != ROUND_FIRED or len(rec["hooks"]) != len(trainer.hook_log):
        problems.append(f"hooks fired (hook, step, run after step) {fired}, "
                        f"expected {ROUND_FIRED}")
    if not any(e["cloned"] + e["split"] for e in dens):
        problems.append("no densify cloned or split")
    # alive moves only by the hooks' counts: densify to its "alive", the
    # outlier prune by its outliers
    expect = surfels
    for e in rec["hooks"]:
        if e["alive_before"] != expect:
            problems.append(f"alive {e['alive_before']} before {e}, expected {expect}")
        expect = {"densify": e.get("alive"), "outlier": expect - e.get("outliers", 0),
                  "reset_opacity": expect}[e["hook"]]
    if rep["alive_end"] != expect:
        problems.append(f"alive {rep['alive_end']} at the end, expected {expect}")
    if [e["max_screen_size"] for e in dens] != [0.0, 0.0, 0.0, 20.0, 20.0]:
        problems.append("the size rules are not on from step 40")
    if len(rec["render_ms"]) != n_rounds or rec["render_k1"] != n_rounds:
        problems.append("one eval render per round")
    if min(rec["render_cover"]) < ROUND_MIN_COVER:
        problems.append(f"an eval render misses the cloud: cover {rec['render_cover']}")
    if (counts["tile_forward"] != n_steps + n_rounds or counts["tile_backward"] != n_steps
            or counts["tile_forward_plain"] or counts["tile_backward_plain"]):
        problems.append(f"launch counts {counts}")
    shapes = {name: (c["frames"], c["n_extra"]) for name, c in checks.items()}
    if shapes != {name: (1, 0) if where == "render" else (2, 2)
                  for name, (where, _) in ROUND_CHECKS.items()}:
        problems.append(f"kernel checks' (frames, extra channels) {shapes}")
    if problems:
        raise AssertionError(f"[round] {problems}")
    return rep, counts


def write_stage2_output(run, rng, res):
    """A Stage-2 output in ``run``: the database (`make_fake_db`, T =
    CLI_FRAMES at res x res), and in ``run/logdir/toy-s2`` the mesh (semi-axes
    MESH_AXES, CLI_MESH rings and meridians), its vertex colours and
    features and a Stage-2-layout checkpoint whose camera sits MESH_DEPTH
    from the mesh (`tests/torch_parity.write_stage2_output`). Returns (mesh
    path, checkpoint path, the source deformer's state dict)."""
    db = load_test_module("helpers").make_fake_db(run, num_vids=1, T=CLI_FRAMES, H=res, W=res)
    return load_test_module("torch_parity").write_stage2_output(
        os.path.join(run, "logdir", "toy-s2"), db, res, rng, CLI_MESH, MESH_AXES, MESH_DEPTH,
        MESH_SCALE)


def frames_of(batch, frames):
    """A kept render batch cut to ``frames``: their tile tables, the whole
    slab."""
    import torch

    tpf = batch["tiles_per_frame"]
    sel = torch.cat([torch.arange(f * tpf, (f + 1) * tpf, device=batch["slab"].device)
                     for f in frames])
    return dict(batch, tile_start=batch["tile_start"][sel].contiguous(),
                tile_count=batch["tile_count"][sel].contiguous())


def cli_path(tmp, rng, device="cuda", capacity=ROUND_CAPACITY, train_res=MAIN_RES,
             render_res=CLI_RENDER_RES, steps=CLI_STEPS):
    """The Stage-3 command line on ``device``, in process, from a Stage-2
    output (`write_stage2_output`), with the working directory in the run
    directory (the CLIs read ``database/`` from it): `train.main` (surfels
    on the mesh, the Stage-2 transfer, 1 round of ``steps`` steps, a
    checkpoint), `render.main` at ``render_res`` for rot_0_360 and ref,
    `export.main` (mesh stride 4) and `reanimate.main` on the exported
    motion. Counts the kernel launches of each entry point from 0, times
    the mesh inits, the transfer, the steps and each entry point, and
    checks what the module docstring lists. Returns (report, launch counts
    of the whole path, the ref render's kernel inputs, kept)."""
    import torch

    from vidu4d_tpu_torch import export as export_cli
    from vidu4d_tpu_torch import kernels
    from vidu4d_tpu_torch import reanimate as reanimate_cli
    from vidu4d_tpu_torch import render as render_cli
    from vidu4d_tpu_torch import train as train_cli
    from vidu4d_tpu_torch.engine import gs4d_trainer
    from vidu4d_tpu_torch.models.gaussian import deformable
    from vidu4d_tpu_torch.models.gaussian.ply_io import load_ply
    from vidu4d_tpu_torch.ops.rasterize import common

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    surfels = min(CLI_SURFELS, capacity)  # the mesh draw, cut to the capacity
    run = os.path.join(tmp, "cli")
    os.makedirs(run)
    mesh, s2_ckpt, s2_sd = write_stage2_output(run, rng, train_res)
    Trainer = gs4d_trainer.Stage3Trainer
    rec = {"mesh_init_ms": [], "alive_after_init": [], "load_stage2_ms": [], "transfer": [],
           "step_ms": [], "render_batch_ms": [], "first_step_valid": None, "bins": [],
           "keep": False, "kept": None}

    def clock(fn, *a, **kw):
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def mesh_init(*a, **kw):
        state, ms = clock(originals[gs4d_trainer, "init_surfels_from_mesh"], *a, **kw)
        rec["mesh_init_ms"].append(ms)
        rec["alive_after_init"].append(int(state.alive.sum()))
        return state

    def load_stage2(self, path):
        keys, ms = clock(originals[Trainer, "load_stage2"], self, path)
        rec["load_stage2_ms"].append(ms)
        # bitwise the source deformer's tensors, before any step moves them
        sd = self.deformer.state_dict()
        rec["transfer"].append((len(keys), [k for k in keys
                                            if not torch.equal(sd[k].cpu(), s2_sd[k])]))
        return keys

    def train_step(self, *a, **kw):
        m, ms = clock(originals[Trainer, "train_step"], self, *a, **kw)
        rec["step_ms"].append(ms)
        bad = [k for k, v in m.items() if not np.isfinite(float(v))]
        if bad:
            raise AssertionError(f"[cli] step {self.current_steps}: non-finite {bad}: {m}")
        return m

    def render_batch(self, *a, **kw):
        out, ms = clock(originals[Trainer, "render_batch"], self, *a, **kw)
        rec["render_batch_ms"].append(ms)
        return out

    def step_composite(prepared, *a, **kw):
        if rec["first_step_valid"] is None:
            rec["first_step_valid"] = prepared["valid"].tolist()
        return originals[gs4d_trainer, "composite_batch"](prepared, *a, **kw)

    def render_composite(prepared, *a, **kw):
        if rec["keep"]:
            rec["kept"] = {k: prepared[k].detach().clone() if torch.is_tensor(prepared[k])
                           else prepared[k] for k in KERNEL_INPUTS}
        return originals[deformable, "composite_batch"](prepared, *a, **kw)

    def bins(*a, **kw):
        b = originals[common, "bin_splats_aligned"](*a, **kw)
        rec["bins"].append((int(b.num_entries), int(b.tile_count.sum())))
        return b

    wraps = {(gs4d_trainer, "init_surfels_from_mesh"): mesh_init,
             (Trainer, "load_stage2"): load_stage2, (Trainer, "train_step"): train_step,
             (Trainer, "render_batch"): render_batch,
             (gs4d_trainer, "composite_batch"): step_composite,
             (deformable, "composite_batch"): render_composite,
             (common, "bin_splats_aligned"): bins}
    originals = {key: getattr(*key) for key in wraps}
    rep, counts, outs = {}, {}, {}

    def entry(label, fn, argv):
        kernels.reset_counts()
        rec["bins"].clear()
        out, rep[f"{label}_ms"] = clock(fn, argv)
        counts[label] = dict(kernels.COUNTS)
        rep[f"{label}_entries"] = [b[0] for b in rec["bins"]]
        rep[f"{label}_truncated"] = [b[0] - b[1] for b in rec["bins"]]
        return out

    dev = ["--device", device]
    cwd = os.getcwd()
    try:
        for key, fn in wraps.items():
            setattr(*key, fn)
        os.chdir(run)
        trainer = entry("train", train_cli.main, [
            *dev, "--seqname", "toy", "--logname", "s3", "--fg_motion", "gs-bob",
            "--gs_init_mesh", mesh, "--load_path", s2_ckpt, "--gs_capacity", str(capacity),
            "--train_res", str(train_res), "--imgs_per_gpu", "1", "--pixels_per_image", "-1",
            "--num_rounds", "1", "--iters_per_round", str(steps), "--save_freq", "1",
            "--learning_rate", str(CLI_WARP_LR)])
        run_dir = os.path.abspath(trainer.save_dir)
        rep["round_ms"] = [s * 1e3 for s in trainer.round_seconds]
        rep["entry_cap"] = trainer.raster_cfg.entry_cap
        del trainer
        opts_log = os.path.join(run_dir, "opts.log")
        load = [*dev, "--flagfile", opts_log, "--load_suffix", "latest"]
        render_args = load + ["--render_res", str(render_res)]
        outs["rot"] = entry("render_rot", render_cli.main,
                            render_args + ["--viewpoint", "rot_0_360"])
        rec["keep"] = True
        outs["ref"] = entry("render_ref", render_cli.main, render_args + ["--viewpoint", "ref"])
        rec["keep"] = False
        exp_dir = os.path.abspath(entry("export", export_cli.main,
                                        load + ["--export_mesh_stride", "4"]))
        motion_path = os.path.join(exp_dir, "motion.json")
        outs["reanimate"] = entry("reanimate", reanimate_cli.main,
                                  render_args + ["--motion_path", motion_path])
    finally:
        os.chdir(cwd)
        for key, fn in originals.items():
            setattr(*key, fn)
    with open(motion_path) as f:
        motion = json.load(f)
    _, n_ply = load_ply(os.path.join(exp_dir, "canonical-surfels.ply"))
    rep.update({
        "surfels": surfels, "capacity": capacity, "train_res": train_res,
        "render_res": render_res, "mesh_faces": 2 * CLI_MESH[1] * (CLI_MESH[0] - 1),
        "mesh_init_ms": rec["mesh_init_ms"], "alive_after_init": rec["alive_after_init"],
        "load_stage2_ms": rec["load_stage2_ms"],
        "transferred_tensors": rec["transfer"][0][0] if rec["transfer"] else 0,
        "first_step_valid": rec["first_step_valid"], "step_ms": rec["step_ms"],
        "render_batch_ms": rec["render_batch_ms"],
        "step_ms_median": float(np.median(rec["step_ms"])),
        "run_files": sorted(os.listdir(run_dir)),
        "ref_cover": [float(x) for x in (outs["ref"]["mask"] > 0.01).mean(axis=(1, 2, 3))],
        "reanimate_frame0_max_abs_diff": float(np.abs(
            outs["reanimate"]["rendered"][0] - outs["ref"]["rendered"][0]).max()),
        "motion_frames": len(motion["field2cam"]["quat"]), "ply_rows": n_ply,
        "obj_files": sorted(f for f in os.listdir(exp_dir) if f.endswith(".obj")),
        "counts": counts,
    })
    log(f"[cli] {json.dumps(rep)}")

    problems = []
    # one mesh init per trainer build: train, two renders, export, reanimate
    if rec["alive_after_init"] != [surfels] * 5:
        problems.append(f"alive after each mesh init {rec['alive_after_init']}")
    if len(rec["transfer"]) != 1 or rec["transfer"][0][1] or not rep["transferred_tensors"]:
        problems.append(f"Stage-2 transfer (tensors, differing) {rec['transfer']}")
    if min(rec["first_step_valid"]) < 0.5 * surfels:
        problems.append(f"< 50% valid in the first step {rec['first_step_valid']}")
    if not {"opts.log", "ckpt_latest.pth", "ckpt_0001.pth",
            "point_cloud_0001.ply"} <= set(rep["run_files"]):
        problems.append(f"run files {rep['run_files']}")
    for label, out in outs.items():
        if not all(np.isfinite(v).all() for v in out.values()):
            problems.append(f"non-finite {label} render")
    # ref and rot render every frame but the last; reanimate every frame
    want_shape = {"rot": CLI_FRAMES - 1, "ref": CLI_FRAMES - 1, "reanimate": CLI_FRAMES}
    for label, m in want_shape.items():
        if outs[label]["rendered"].shape != (m, render_res, render_res, 3):
            problems.append(f"{label} rendered {outs[label]['rendered'].shape}")
    if min(rep["ref_cover"]) < CLI_MIN_COVER:
        problems.append(f"ref cover {rep['ref_cover']}")
    if rep["motion_frames"] != CLI_FRAMES or not 0.99 * surfels <= n_ply <= capacity:
        problems.append(f"motion frames {rep['motion_frames']}, ply rows {n_ply}")
    if len(rep["obj_files"]) != -(-CLI_FRAMES // 4):
        problems.append(f"mesh sequence {rep['obj_files']}")
    if not rep["reanimate_frame0_max_abs_diff"] <= CLI_REANIMATE_TOL:
        problems.append(f"reanimated frame 0 vs ref {rep['reanimate_frame0_max_abs_diff']}")
    expect = {"train": (steps + 1, steps), "render_rot": (1, 0), "render_ref": (1, 0),
              "export": (0, 0), "reanimate": (1, 0)}
    for label, (k1, k2) in expect.items():
        c = counts[label]
        if (c["tile_forward"], c["tile_backward"]) != (k1, k2) or \
                c["tile_forward_plain"] or c["tile_backward_plain"]:
            problems.append(f"{label} launches {c}, expected K1 {k1} K2 {k2}, no plain")
    if problems:
        raise AssertionError(f"[cli] {problems}")
    total = {k: sum(c[k] for c in counts.values()) for k in kernels.COUNTS}
    return rep, total, rec["kept"]


def static_small_vs_cpu(rng):
    """One static `train_step` (STATIC_SMALL: a non-square frame with cut
    edge tiles, SH 3 with random higher bands, white background) on the
    card and on the CPU from one state: loss, PSNR, every surfel gradient
    and the densification statistics; then both kernels against their
    plain versions on the card step's own inputs."""
    import torch

    from vidu4d_tpu_torch.engine import gs_trainer
    from vidu4d_tpu_torch.models.gaussian import surfels as sf
    from vidu4d_tpu_torch.models.gaussian.optimizer import gs_adam_init
    from vidu4d_tpu_torch.ops.rasterize import api, common

    h, w, n = STATIC_SMALL
    rs = np.random.default_rng(11)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    state = sf.init_from_points(f32(rs.normal(size=(n, 3)) * [0.5, 0.35, 0.4]),
                                f32(rs.uniform(size=(n, 3))), n + 512, sh_degree=3,
                                generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        state.params.features_rest.copy_(f32(rs.normal(size=(n + 512, 15, 3)) * 0.1))
    vm = load_test_module("torch_parity").look_at((0.4, -0.5, 2.6))
    cam = (f32(vm), f32([95.0, 92.0, w / 2 - 0.5, h / 2 + 0.5]), f32(rs.uniform(size=(h, w, 3))))
    cfg = gs_trainer.GsTrainConfig(white_background=True)
    runs, kept = {}, {}
    orig = api.composite_batch

    def composite(prepared, *a, **kw):
        kept.update({k: prepared[k].detach().clone() if torch.is_tensor(prepared[k])
                     else prepared[k] for k in KERNEL_INPUTS})
        return orig(prepared, *a, **kw)

    for dev in ("cpu", "cuda"):
        st = sf.SurfelState(
            params=sf.SurfelParams(*[p.detach().clone().to(dev).requires_grad_(True)
                                     for p in state.params]),
            alive=state.alive.to(dev), max_radii2d=state.max_radii2d.to(dev),
            grad_accum=state.grad_accum.to(dev), denom=state.denom.to(dev))
        p = st.params
        with torch.no_grad():
            proj = common.project_splats(p.xyz[None], sf.get_rotation(p)[None],
                                         sf.get_scaling(p), cam[0].to(dev),
                                         cam[1].to(dev)[None], mask=st.alive)
            ids = common.bin_splats_aligned(common.SplatProjection(*[x[0] for x in proj]),
                                            h, w, entry_cap=0).sorted_splat_ids.cpu()
        api.composite_batch = composite
        try:
            new, _, m = gs_trainer.train_step(st, gs_adam_init(st.params),
                                              *[x.to(dev) for x in cam], h, w, 3, cfg)
        finally:
            api.composite_batch = orig
        runs[dev] = (new, m, {f: getattr(p, f).grad.cpu()
                              for f in sf.SurfelParams._fields if f != "regist_feat"}, ids)
    torch.cuda.synchronize()
    (s_c, m_c, g_c, ids_c), (s_g, m_g, g_g, ids_g) = runs["cpu"], runs["cuda"]
    out, bad = {}, []
    for k in ("loss", "psnr"):
        a, b = float(m_c[k]), float(m_g[k])
        out[k] = {"cpu": a, "gpu": b, "rel": abs(a - b) / abs(a)}
        if not (np.isfinite(b) and abs(a - b) <= STEP_LOSS_REL_TOL * abs(a)):
            bad.append(k)
    # entries the two devices sort into another order: a depth one
    # quantisation code apart flips two splats of a tile, which changes
    # their compositing order and so their gradients
    out["entries"] = len(ids_c)
    out["entries_in_other_order"] = int((ids_c != ids_g).sum())
    # each field's rows to STEP_GRAD_REL_TOL of its max |g| (+ the floor),
    # but for at most STATIC_SMALL_ROWS surfels whose gradients such a flip
    # moved, each within STATIC_SMALL_ROW_TOL of the max
    acc_c, acc_g = s_c.grad_accum[:, None], s_g.grad_accum.cpu()[:, None]
    g_all = max(float(g.abs().max()) for g in g_c.values())
    rows = {}
    for f, gc, gg in [(f, gc, g_g[f]) for f, gc in g_c.items()] + [("grad_accum", acc_c, acc_g)]:
        err = (gc - gg).abs().reshape(len(gc), -1).amax(dim=1)
        scale = float(gc.abs().max())
        floor = STEP_GRAD_FLOOR * (g_all if f != "grad_accum" else scale)
        beyond = torch.nonzero(err > STEP_GRAD_REL_TOL * scale + floor).flatten()
        rows[f] = {"beyond": beyond.tolist(), "worst_over_max": float(err.max()) / scale}
        if (len(beyond) > STATIC_SMALL_ROWS
                or float(err.max()) > STATIC_SMALL_ROW_TOL * scale + floor):
            bad.append(f)
    for k in ("denom", "max_radii2d"):
        if not torch.equal(getattr(s_c, k), getattr(s_g, k).cpu()):
            bad.append(k)
    out["rows"] = rows
    out["visible"] = int(s_c.denom.sum())
    log(f"[static small step cpu-vs-gpu {h}x{w}] {json.dumps(out)}")
    if bad or out["visible"] < n // 2:
        raise AssertionError(f"static small step: {bad} differ beyond their tolerance, "
                             f"{out['visible']} of {n} surfels visible")
    return compare_kernels(kept, rng, f"static small {h}x{w} (card step's inputs)")


def static_path(tmp, rng):
    """The static 2DGS command line on the card, in process: a synthetic
    COLMAP scene (`tests/torch_parity.static_scene`, STATIC_* above), then
    `gs_static.main` with the launch counters from 0, every step, hook,
    eval and extraction part timed through wrappers; then STATIC_FULL_SH
    steps at active SH 3 on one camera, whose last inputs hold both kernels
    against their plain versions (timed). Returns (report, launch counts of
    `gs_static.main`, the kernel check)."""
    import torch

    from vidu4d_tpu_torch import gs_static, kernels
    from vidu4d_tpu_torch.engine import gs_trainer
    from vidu4d_tpu_torch.models.gaussian import densify as densify_mod
    from vidu4d_tpu_torch.models.gaussian import extract, ply_io
    from vidu4d_tpu_torch.models.gaussian import surfels as sf
    from vidu4d_tpu_torch.ops import image_losses
    from vidu4d_tpu_torch.ops import lpips as lpips_mod
    from vidu4d_tpu_torch.ops import marching
    from vidu4d_tpu_torch.ops import rasterize as raster_pkg
    from vidu4d_tpu_torch.ops.image_losses import psnr
    from vidu4d_tpu_torch.ops.rasterize import api, common

    root, out_dir = os.path.join(tmp, "static", "scene"), os.path.join(tmp, "static", "out")
    t0 = time.perf_counter()
    load_test_module("torch_parity").static_scene(
        root, np.random.default_rng(7), STATIC_GT, STATIC_INIT, STATIC_CAMS, STATIC_W,
        STATIC_H, device="cuda")
    scene_ms = (time.perf_counter() - t0) * 1e3
    rec = {"step_ms": [], "hooks": [], "lpips_ms": [], "psnr_ms": [], "ssim_ms": [],
           "eval_render_ms": [], "bins": [], "keep": False}

    def clock(fn, *a, **kw):
        torch.cuda.synchronize()
        t_0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t_0) * 1e3

    @torch.no_grad()
    def eval_psnr(state, cams, sh_degree):
        p, vals = state.params, []
        for cam in cams[::max(1, len(cams) // 8)]:
            h, w = cam.image.shape[:2]
            out = api.rasterize(p.xyz, sf.get_rotation(p), sf.get_scaling(p),
                                sf.get_opacity(p)[:, 0], cam.viewmat, cam.intrins, h, w,
                                shs=sf.get_features(p), sh_degree=sh_degree, mask=state.alive)
            vals.append(float(psnr(torch.clamp(out.color, 0, 1).permute(2, 0, 1),
                                   cam.image.permute(2, 0, 1))))
        return float(np.mean(vals))

    def train(state, cams, config, *a, **kw):
        # the initial store's PSNR on the eval views; its launches are not
        # the entry point's
        saved = dict(kernels.COUNTS)
        rec["init_psnr"] = eval_psnr(state, cams, config.sh_degree)
        kernels.COUNTS.update(saved)
        rec["alive_init"] = int(state.alive.sum())
        out, rec["train_ms"] = clock(originals[gs_trainer, "train"], state, cams, config,
                                     *a, **kw)
        rec.update(state=out[0], adam=out[1], cams=cams, config=config)
        return out

    def train_step(*a, **kw):
        out, ms = clock(originals[gs_trainer, "train_step"], *a, **kw)
        rec["step_ms"].append(ms)
        bad = [k for k, v in out[2].items() if not np.isfinite(float(v))]
        if bad:
            raise AssertionError(f"[static] step {len(rec['step_ms'])}: non-finite {bad}")
        return out

    def densify_step(state, adam, noise, extent, max_screen_size, config):
        before = int(state.alive.sum())
        out, ms = clock(originals[gs_trainer, "densify_step"], state, adam, noise, extent,
                        max_screen_size, config)
        rec["hooks"].append({"hook": "densify", "step": len(rec["step_ms"]), "ms": ms,
                             "alive_before": before, "alive_after": int(out[0].alive.sum()),
                             "max_screen_size": max_screen_size,
                             **{k: int(v) for k, v in out[2].items()}})
        return out

    def reset_opacity(state, adam):
        before = int(state.alive.sum())
        out, ms = clock(originals[densify_mod, "reset_opacity"], state, adam)
        opac = sf.get_opacity(out[0].params)[:, 0].detach()[out[0].alive]
        rec["hooks"].append({"hook": "reset_opacity", "step": len(rec["step_ms"]), "ms": ms,
                             "alive_before": before, "max_opacity_after": float(opac.max())})
        return out

    def save_ply(*a, **kw):
        _, rec["ply_ms"] = clock(originals[ply_io, "save_ply"], *a, **kw)
        rec["eval_t0"] = time.perf_counter()

    def lpips(*a):
        out, ms = clock(originals[lpips_mod, "lpips"], *a)
        rec["lpips_ms"].append(ms)
        return out

    def eval_metric(name):
        # timed in the eval only (the training loss calls ssim too)
        def wrapped(*a, **kw):
            if "eval_t0" not in rec or "eval_ms" in rec:
                return originals[image_losses, name](*a, **kw)
            out, ms = clock(originals[image_losses, name], *a, **kw)
            rec[f"{name}_ms"].append(ms)
            return out
        return wrapped

    def rasterize(*a, **kw):
        out, ms = clock(originals[raster_pkg, "rasterize"], *a, **kw)
        rec["eval_render_ms"].append(ms)
        return out

    def extract_mesh(*a, **kw):
        rec["eval_ms"] = (time.perf_counter() - rec["eval_t0"]) * 1e3
        out, rec["extract_ms"] = clock(originals[extract, "extract_mesh"], *a, **kw)
        return out

    def render_depth_maps(*a, **kw):
        out, rec["extract_render_ms"] = clock(originals[extract, "render_depth_maps"], *a,
                                              **kw)
        return out

    def fuse_tsdf(*a, **kw):
        rec["vol_bnds"] = a[4].cpu().numpy()
        out, rec["fuse_tsdf_ms"] = clock(originals[extract, "fuse_tsdf"], *a, **kw)
        return out

    def marching_tets(*a, **kw):
        out, rec["marching_tets_ms"] = clock(originals[marching, "marching_tets"], *a, **kw)
        rec["soup_triangles"] = int(out[1].sum())
        return out

    def weld_vertices(*a, **kw):
        out, rec["weld_ms"] = clock(originals[marching, "weld_vertices"], *a, **kw)
        return out

    def bins(*a, **kw):
        b = originals[common, "bin_splats_aligned"](*a, **kw)
        rec["bins"].append(int(b.num_entries))
        return b

    def composite(prepared, *a, **kw):
        if rec["keep"]:
            rec["kept"] = {k: prepared[k].detach().clone() if torch.is_tensor(prepared[k])
                           else prepared[k] for k in KERNEL_INPUTS}
        return originals[api, "composite_batch"](prepared, *a, **kw)

    wraps = {(gs_trainer, "train"): train, (gs_trainer, "train_step"): train_step,
             (gs_trainer, "densify_step"): densify_step,
             (densify_mod, "reset_opacity"): reset_opacity, (ply_io, "save_ply"): save_ply,
             (lpips_mod, "lpips"): lpips, (image_losses, "psnr"): eval_metric("psnr"),
             (image_losses, "ssim"): eval_metric("ssim"), (raster_pkg, "rasterize"): rasterize,
             (extract, "extract_mesh"): extract_mesh,
             (extract, "render_depth_maps"): render_depth_maps,
             (extract, "fuse_tsdf"): fuse_tsdf, (marching, "marching_tets"): marching_tets,
             (marching, "weld_vertices"): weld_vertices,
             (common, "bin_splats_aligned"): bins, (api, "composite_batch"): composite}
    originals = {key: getattr(*key) for key in wraps}
    try:
        for key, fn in wraps.items():
            setattr(*key, fn)
        kernels.reset_counts()
        _, main_ms = clock(gs_static.main, ["--device", "cuda", f"--source_path_={root}",
                                            f"--model_path_={out_dir}", *STATIC_FLAGS])
        counts = dict(kernels.COUNTS)
        n_bins = len(rec["bins"])
        # full SH: active degree 3 on camera 0, the last step's inputs kept
        state, adam, cam = rec["state"], rec["adam"], rec["cams"][0]
        h, w = cam.image.shape[:2]
        warm, timed = STATIC_FULL_SH
        for i in range(warm + timed):
            rec["keep"] = i == warm + timed - 1
            state, adam, _ = train_step(state, adam, cam.viewmat, cam.intrins, cam.image,
                                        h, w, 3, rec["config"])
        full_sh_ms = rec["step_ms"][-timed:]
    finally:
        for key, fn in originals.items():
            setattr(*key, fn)

    with open(os.path.join(out_dir, "history.json")) as f:
        hist = json.load(f)
    verts, faces = marching.load_obj(os.path.join(out_dir, "fused_mesh.obj"))
    _, ply_rows = ply_io.load_ply(os.path.join(out_dir, "point_cloud.ply"))
    entries = rec["bins"][:n_bins]
    rep = {
        "res": [STATIC_W, STATIC_H], "capacity": STATIC_CAPACITY, "init_points": STATIC_INIT,
        "gt_surfels": STATIC_GT, "cameras": STATIC_CAMS, "scene_ms": scene_ms,
        "main_ms": main_ms, "train_ms": rec["train_ms"], "steps": STATIC_STEPS,
        "step_ms_median": float(np.median(rec["step_ms"][:STATIC_STEPS])),
        "step_ms_p90": float(np.percentile(rec["step_ms"][:STATIC_STEPS], 90)),
        "full_sh_step_ms": [round(x, 3) for x in full_sh_ms],
        "full_sh_step_ms_median": float(np.median(full_sh_ms)),
        "entries_per_frame": {"min": min(entries), "median": float(np.median(entries)),
                              "max": max(entries), "frames": len(entries)},
        "init_psnr": rec["init_psnr"], "eval_psnr": hist[-1]["eval_psnr"],
        "eval_ssim": hist[-1]["eval_ssim"], "eval_lpips": hist[-1]["eval_lpips"],
        "lpips_kind": hist[-1]["lpips_kind"], "eval_ms": rec["eval_ms"],
        "eval_render_ms": [round(x, 3) for x in rec["eval_render_ms"]],
        "psnr_ms": [round(x, 3) for x in rec["psnr_ms"]],
        "ssim_ms": [round(x, 3) for x in rec["ssim_ms"]],
        "lpips_ms": [round(x, 3) for x in rec["lpips_ms"]], "ply_ms": rec["ply_ms"],
        "extract_ms": rec["extract_ms"], "extract_render_ms": rec["extract_render_ms"],
        "fuse_tsdf_ms": rec["fuse_tsdf_ms"], "marching_tets_ms": rec["marching_tets_ms"],
        "weld_ms": rec["weld_ms"], "soup_triangles": rec["soup_triangles"],
        "mesh_vertices": len(verts), "mesh_faces": len(faces), "ply_rows": ply_rows,
        "alive_end": hist[-1]["alive"], "history_keys": sorted(hist[-1]), "counts": counts,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    for e in rec["hooks"]:
        log(f"[static hook] {json.dumps(e)}")
    log(f"[static] {json.dumps(rep)}")

    problems = []
    if len(rec["step_ms"]) != STATIC_STEPS + sum(STATIC_FULL_SH):
        problems.append(f"{len(rec['step_ms'])} steps")
    fired = [(e["hook"], e["step"], e.get("max_screen_size")) for e in rec["hooks"]]
    if fired != STATIC_FIRED:
        problems.append(f"hooks fired {fired}, expected {STATIC_FIRED}")
    dens = [e for e in rec["hooks"] if e["hook"] == "densify"]
    if not any(e["cloned"] + e["split"] for e in dens):
        problems.append("no densify cloned or split")
    # alive moves only by densify, to its info's count, within what its
    # counts allow
    expect = rec["alive_init"]
    if expect != STATIC_INIT:
        problems.append(f"{expect} alive at the start")
    for e in rec["hooks"]:
        if e["alive_before"] != expect:
            problems.append(f"alive {e['alive_before']} before {e}, expected {expect}")
        if e["hook"] == "densify":
            lo = e["alive_before"] - e["split"] - e["pruned"]
            hi = e["alive_before"] + e["cloned"] + e["split"]
            if not (e["alive_after"] == e["alive"] and lo <= e["alive"] <= hi):
                problems.append(f"densify alive {e['alive_after']} vs its info {e}")
            expect = e["alive"]
        elif e["max_opacity_after"] > 0.01 + 1e-6:
            problems.append(f"opacity above 0.01 after the reset: {e}")
    if not rep["alive_end"] == ply_rows == expect:
        problems.append(f"alive at the end {rep['alive_end']}, ply rows {ply_rows}, "
                        f"expected {expect}")
    if not rep["eval_psnr"] >= rep["init_psnr"] + STATIC_PSNR_MARGIN:
        problems.append(f"eval PSNR {rep['eval_psnr']} not {STATIC_PSNR_MARGIN} dB above "
                        f"the initial store's {rep['init_psnr']}")
    if set(hist[-1]) != {"loss", "psnr", "alive", "iter", "elapsed", "eval_psnr",
                         "eval_ssim", "eval_lpips", "lpips_kind"} or len(hist) != 3:
        problems.append(f"history {len(hist)} entries, keys {sorted(hist[-1])}")
    bnds = rec["vol_bnds"]
    slack = 1e-4 * float(np.linalg.norm(bnds[1] - bnds[0]))
    if not len(faces) or not (np.all(verts >= bnds[0] - slack) and np.all(verts <= bnds[1] + slack)):
        problems.append(f"mesh of {len(faces)} faces, vertices in {verts.min(0)} .. "
                        f"{verts.max(0)} vs volume {bnds.tolist()}")
    n_eval, n_extract = len(rec["eval_render_ms"]), -(-STATIC_CAMS // 4)
    if n_eval != STATIC_CAMS // (STATIC_CAMS // 8) or not (
            len(rec["lpips_ms"]) == len(rec["psnr_ms"]) == len(rec["ssim_ms"]) == n_eval):
        problems.append(f"{n_eval} eval renders, {len(rec['lpips_ms'])} LPIPS, "
                        f"{len(rec['psnr_ms'])} PSNR, {len(rec['ssim_ms'])} SSIM")
    if (counts["tile_forward"] != STATIC_STEPS + n_eval + n_extract
            or counts["tile_backward"] != STATIC_STEPS
            or counts["tile_forward_plain"] or counts["tile_backward_plain"]):
        problems.append(f"launch counts {counts}")
    if problems:
        raise AssertionError(f"[static] {problems}")
    check = compare_kernels(rec["kept"], rng, f"static {STATIC_W}x{STATIC_H} full SH",
                            reps_p=1, timed=True)
    return rep, counts, check


def stage2_small_vs_cpu(tmp, fg_motion="bob", field_type="fg", steps=2, init=None,
                        single_inst=True):
    """``steps`` Stage-2 steps of a small configuration (S2_SMALL, 32^2;
    ``fg_motion``, ``field_type``; with ``single_inst`` False on a 2-video
    database with one instance code per video) on the CPU and on the card
    in float64,
    from the same parameters, field state, batch and draws: every loss term
    and gnorm within S2_SMALL_LOSS_RTOL; each parameter's gradient within
    S2_SMALL_GRAD_REL of its max |g| + S2_SMALL_GRAD_FLOOR of the largest;
    the parameters after each AdamW update within 1e-6 of a step (lr x
    multiplier) + 4 ulp. The starting state is the CPU trainer's after
    `mlp_init` with S2_SMALL_SDF_ITERS pretrain steps, or ``init`` (a state
    dict and field states of such an fg field, returned by an earlier
    call): its fields' parameters outside the warp, for every field of
    this configuration. Returns (state dict, field states) after the
    init."""
    import torch

    from vidu4d_tpu_torch.engine.optim import lr_multiplier, make_stage2_optimizer
    from vidu4d_tpu_torch.engine.trainer import Stage2Trainer
    from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState

    label = f"{field_type}-{fg_motion}" + ("" if single_inst else "-nosingle_inst")
    run = os.path.join(tmp, f"s2small-{label}")
    db = load_test_module("helpers").make_fake_db(run, num_vids=1 if single_inst else 2, T=8,
                                                  H=32, W=32)
    opts = {"dataroot": db, "seqname": "toy", "logroot": os.path.join(run, "logdir"),
            "data_prefix": "crop", "train_res": 32, "fg_motion": fg_motion,
            "field_type": field_type, "rgb_timefree": True, "rgb_dirfree": True,
            "num_rounds": 1, "iters_per_round": 2, "seed": 0, "learning_rate": 5e-4,
            "single_inst": single_inst, **S2_SMALL}
    f64 = lambda d, dev: {k: (v.double() if v.is_floating_point() else v).to(dev)
                          for k, v in d.items()}
    cpu = Stage2Trainer({**opts, "logname": "small_cpu"}, "cpu")
    gpu = Stage2Trainer({**opts, "logname": "small_gpu"}, "cuda")
    # the state a step starts from: the prior fits and a short SDF pretrain
    # (from the random init every ray's mask is ~1, and the mask loss's
    # nonzero mean then counts entries of ~1e-30)
    if init is None:
        cpu.mlp_init(sdf_iters=S2_SMALL_SDF_ITERS, verbose=False)
        init = ({k: v.clone() for k, v in cpu.model.state_dict().items()}, dict(cpu.states))
    else:
        base, base_states = init
        own = cpu.model.state_dict()
        for k in own:
            parts = k.split(".")
            src = ".".join(["fields", "fg"] + parts[2:]) if parts[0] == "fields" else k
            if not (parts[0] == "fields" and parts[2] == "warp"):
                own[k] = base[src]
        cpu.model.load_state_dict(own)
        cpu.states = {c: base_states["fg"] for c in cpu.states}
    for tr in (cpu, gpu):
        tr.model.double()
        tr.states = {c: FieldState(*[x.double().to(tr.device) for x in st])
                     for c, st in cpu.states.items()}
    gpu.model.load_state_dict(cpu.model.state_dict())
    for tr in (cpu, gpu):
        tr.optimizer = make_stage2_optimizer(tr.model, opts["learning_rate"], 2, 1)
    batch = cpu._next_batch()
    draws = cpu.model.reg_draws(torch.Generator().manual_seed(0))
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for step in range(steps):
        m_cpu = cpu.train_step(f64(batch, "cpu"), f64(draws, "cpu"))
        m_gpu = gpu.train_step(f64(batch, "cuda"), f64(draws, "cuda"))
        torch.cuda.synchronize()
        terms = S2_TERMS if (fg_motion, field_type) == ("bob", "fg") else set(m_cpu)
        if not single_inst and cpu.num_inst != 2:
            raise AssertionError(f"stage-2 small step {label}: num_inst {cpu.num_inst}")
        if set(m_cpu) != terms | {"total", "gnorm"} or set(m_gpu) != set(m_cpu):
            raise AssertionError(f"stage-2 small step {label} terms: {sorted(m_cpu)} / "
                                 f"{sorted(m_gpu)}")
        for k in m_cpu:
            a, b = float(m_cpu[k]), float(m_gpu[k])
            rel = abs(a - b) / max(abs(a), 1e-300)
            worst["loss"] = max(worst["loss"], rel)
            if not (np.isfinite(a) and rel <= S2_SMALL_LOSS_RTOL):
                raise AssertionError(f"stage-2 small step {label} {step} {k}: cpu {a!r} "
                                     f"gpu {b!r}")
        pc = dict(cpu.model.named_parameters())
        pg = dict(gpu.model.named_parameters())
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in pc.items()}
        floor = S2_SMALL_GRAD_FLOOR * max(float(g.abs().max()) for g in grads.values())
        lr = cpu.optimizer.schedule(step)
        for k, p in pc.items():
            g_gpu = pg[k].grad.cpu() if pg[k].grad is not None else torch.zeros_like(p)
            err = float((g_gpu - grads[k]).abs().max())
            scale = float(grads[k].abs().max())
            worst["grad"] = max(worst["grad"], err / (scale + floor))
            if err > S2_SMALL_GRAD_REL * scale + floor:
                raise AssertionError(f"stage-2 small step {label} {step} grad {k}: {err} "
                                     f"vs {scale}")
            bound = 1e-6 * lr * lr_multiplier(k) + 4 * torch.finfo(p.dtype).eps * p.detach().abs()
            diff = (pg[k].detach().cpu() - p.detach()).abs()
            worst["param"] = max(worst["param"], float((diff / bound).max()))
            if (diff > bound).any():
                raise AssertionError(f"stage-2 small step {label} {step} param {k}: "
                                     f"{float(diff.max())}")
    tag = "" if label == "fg-bob" else f" {label}"
    log(f"[stage2 small step cpu-vs-gpu float64{tag}] {json.dumps(worst)} "
        f"(loss: max relative difference; grad, param: max share of their bounds; "
        f"{len(m_cpu) - 2} terms)")
    return init


def stage2_path(tmp, flags=S2_FLAGS, rounds=S2_ROUNDS, terms=S2_TERMS, tag="stage2",
                handoff_motion="gs-bob", export_reanimate=False, database=None,
                iters=S2_ITERS, inst_id=0, handoff_flags=()):
    """A Stage-2 recipe on the card through the port's entry points (``flags``:
    S2_FLAGS, the README's, or S2C_FLAGS, comp + skel-quad), in a run
    directory holding make_fake_db(T=16) at 256^2: `Stage2Trainer` with the
    command line's options, its full `mlp_init`, `train()` for ``rounds``
    rounds of S2_ITERS steps with a checkpoint per round (every loss term
    of ``terms`` finite in every step), the last checkpoint reloaded into a
    fresh trainer; then `render.main` at S2_RENDER_RES^2 on S2_RENDER_FRAMES
    frames (in chunks of rays); with ``export_reanimate`` `export.main`
    (motion.json with the skeleton's joint_so3); the hand-off:
    `train.main --fg_motion <handoff_motion>` from this run's own fg mesh
    and ckpt_latest.pth for S2_HANDOFF_STEPS steps; with
    ``export_reanimate`` then `reanimate.main` of that Stage 3 with the
    Stage-2 export's motion at S2C_REANIMATE_RES^2. Logs under ``[tag]``.
    ``database``: a database to train on (linked into the run directory)
    in place of make_fake_db's; ``iters``: steps per round; ``inst_id``:
    the video the render shows (and, when not 0, `export.main
    --inst_id` of it: export_<inst_id>/ with that video's frames, no
    kernel launch); ``handoff_flags``: more flags of the hand-off.
    Returns (report, kernel launches of the Stage-2 training, of the
    hand-off, of the reanimation or None)."""
    import torch

    from vidu4d_tpu_torch import config, kernels
    from vidu4d_tpu_torch import export as export_cli
    from vidu4d_tpu_torch import reanimate as reanimate_cli
    from vidu4d_tpu_torch import render as render_cli
    from vidu4d_tpu_torch import train as train_cli
    from vidu4d_tpu_torch.engine import trainer as s2
    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer
    from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState

    run = os.path.join(tmp, tag)
    os.makedirs(run)
    if database is None:
        load_test_module("helpers").make_fake_db(run, num_vids=1, T=S2_FRAMES, H=S2_RES,
                                                 W=S2_RES)
    else:
        os.symlink(os.path.abspath(database), os.path.join(run, "database"))
    seqname = flags[flags.index("--seqname") + 1]
    cwd = os.getcwd()
    os.chdir(run)  # the command line reads database/ from the working directory
    rep = {"step_ms": [], "batch_ms": [], "aux_ms": [], "export_ms": []}
    originals = {}
    reanimate_counts = None

    def timed(cls, name, key):
        fn = getattr(cls, name)
        originals[cls, name] = fn

        def wrapper(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            rep[key].append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(cls, name, wrapper)

    def restore():
        for (cls, name), fn in originals.items():
            setattr(cls, name, fn)
        originals.clear()

    try:
        opts = config.parse_flags(flags)
        opts.pop("device")
        config.save_config(opts)
        trainer = s2.Stage2Trainer(opts, "cuda")
        rep["num_inst"] = trainer.num_inst
        rep["frame_offset_raw"] = [int(x) for x in trainer.frame_info.frame_offset_raw]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = trainer.mlp_init()
        torch.cuda.synchronize()
        rep["mlp_init_s"] = time.perf_counter() - t0
        rep["mlp_init"] = info
        verts = trainer._proxy_mesh[0] if trainer._proxy_mesh is not None else np.zeros((0, 3))
        radius = float(np.linalg.norm(verts, axis=-1).mean()) if len(verts) else 0.0
        rep["init_mesh"] = {"verts": int(len(verts)), "mean_radius": radius,
                            "fields": {c: int(len(m[0])) for c, m in
                                       trainer.proxy_meshes.items()}}
        if not (np.isfinite(info["sdf_loss"]) and S2_RADIUS[0] < radius < S2_RADIUS[1]
                and set(trainer.proxy_meshes) == set(trainer.states)):
            raise AssertionError(f"{tag} mlp_init: sdf loss {info['sdf_loss']}, proxy mesh "
                                 f"mean radius {radius} not in {S2_RADIUS}, meshes "
                                 f"{sorted(trainer.proxy_meshes)}")

        before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
        metrics = []
        timed(s2.Stage2Trainer, "_next_batch", "batch_ms")
        timed(s2.Stage2Trainer, "update_geometry_aux", "aux_ms")
        timed(s2.Stage2Trainer, "export_geometry", "export_ms")
        step_fn = s2.Stage2Trainer.train_step

        def train_step(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step_fn(self, *a, **kw)
            torch.cuda.synchronize()
            rep["step_ms"].append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            return m
        originals[s2.Stage2Trainer, "train_step"] = step_fn
        s2.Stage2Trainer.train_step = train_step
        kernels.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        trainer.train(log_fn=lambda *a: None)
        s2_counts = dict(kernels.COUNTS)
        restore()
        rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rep["round_s"] = list(trainer.round_seconds)
        bad = [(i, k) for i, m in enumerate(metrics) for k, v in m.items() if not np.isfinite(v)]
        missing = terms - set(metrics[-1])
        if bad or missing or len(metrics) != rounds * iters:
            raise AssertionError(f"{tag} steps: {len(metrics)}, non-finite {bad[:5]}, "
                                 f"missing terms {sorted(missing)}")
        moved = [k for k, p in trainer.model.named_parameters()
                 if not torch.equal(p.detach(), before[k])]
        if len(moved) < 0.9 * len(before):
            raise AssertionError(f"{tag}: {len(moved)} of {len(before)} parameters moved")
        rep["moved"] = f"{len(moved)}/{len(before)}"
        save_dir = trainer.save_dir
        rep["export"] = {}
        for cate in trainer.states:
            path = os.path.join(save_dir, f"{rounds - 1:03d}-{cate}-geo.obj")
            feats = np.load(os.path.join(save_dir, f"{rounds - 1:03d}-{cate}-feat.npy"))
            norms = np.linalg.norm(feats, axis=-1)
            rep["export"][cate] = {"obj_bytes": os.path.getsize(path),
                                   "feat": list(feats.shape),
                                   "feat_norm_dev": float(np.abs(norms - 1).max())}
            if (os.path.getsize(path) == 0 or feats.shape[-1] != 16
                    or np.abs(norms - 1).max() > 1e-3):
                raise AssertionError(f"{tag} export: {rep['export']}")
        geo = os.path.join(save_dir, f"{rounds - 1:03d}-fg-geo.obj")
        fresh = s2.Stage2Trainer(opts, "cuda")
        fresh.load_checkpoint(os.path.join(save_dir, "ckpt_latest.pth"), reset_steps=False)
        same = (all(torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                                     fresh.model.state_dict().values()))
                and list(fresh.states) == list(trainer.states)
                and all(torch.equal(getattr(trainer.states[c], f), getattr(fresh.states[c], f))
                        for c in trainer.states for f in FieldState._fields)
                and fresh.optimizer.count == trainer.optimizer.count
                and all(torch.equal(trainer.optimizer.mu[k], fresh.optimizer.mu[k])
                        and torch.equal(trainer.optimizer.nu[k], fresh.optimizer.nu[k])
                        for k in trainer.optimizer.mu)
                and fresh.current_steps == trainer.current_steps)
        if not same:
            raise AssertionError(f"{tag} checkpoint: the reloaded trainer differs")
        step_ms = np.asarray(rep["step_ms"])
        rep["step_ms_median"] = float(np.median(step_ms))
        rep["step_ms_p90"] = float(np.percentile(step_ms, 90))
        rep["batch_ms_median"] = float(np.median(rep["batch_ms"]))
        # per field: every field takes every ray's samples
        rep["samples_per_step"] = (2 * opts["imgs_per_gpu"] * opts["pixels_per_image"]
                                   * trainer.model.fields["fg"].train_depth_samples)
        rep["fields"] = list(trainer.model.fields)
        log(f"[{tag}] {json.dumps({k: v for k, v in rep.items() if k not in ('step_ms', 'batch_ms')})}")
        log(f"[{tag} steps] {json.dumps([round(x, 3) for x in rep['step_ms']])}")
        del trainer, fresh
        torch.cuda.empty_cache()

        # the eval render at 512^2, chunked
        s2_flag = [f"--flagfile={save_dir}/opts.log", "--load_suffix", "latest"]
        t0 = time.perf_counter()
        out = render_cli.main(s2_flag + ["--render_res", str(S2_RENDER_RES), "--freeze_id", "0",
                                         "--num_frames", str(S2_RENDER_FRAMES),
                                         "--viewpoint", "ref", "--inst_id", str(inst_id)])
        torch.cuda.synchronize()
        rep_r = {"render_s": time.perf_counter() - t0,
                 "chunks_per_frame": -(-S2_RENDER_RES ** 2 // s2.RENDER_CHUNK),
                 "cover": [float((m > 0.01).mean()) for m in out["mask"]],
                 "inst_id": inst_id}
        finite = all(np.isfinite(v).all() for v in out.values())
        if (not os.path.isdir(os.path.join(save_dir, "renderings_%04d" % inst_id, "ref"))
                or not finite
                or out["rgb"].shape != (S2_RENDER_FRAMES, S2_RENDER_RES, S2_RENDER_RES, 3)
                or min(rep_r["cover"]) <= 0):
            raise AssertionError(f"{tag} render: finite {finite}, {rep_r}")
        log(f"[{tag} render] {json.dumps(rep_r)}")
        rep.update(rep_r)
        del out
        torch.cuda.empty_cache()

        if inst_id:
            # the canonical mesh, video inst_id's motion and mesh sequence
            kernels.reset_counts()
            t0 = time.perf_counter()
            exp_dir = export_cli.main(s2_flag + ["--inst_id", str(inst_id),
                                                 "--export_mesh_stride", "8"])
            rep["export_s"] = time.perf_counter() - t0
            with open(os.path.join(exp_dir, "motion.json")) as f:
                motion = json.load(f)
            offsets = rep["frame_offset_raw"]
            n_frames = offsets[inst_id + 1] - offsets[inst_id]
            objs = sorted(f for f in os.listdir(exp_dir) if f.startswith("fg-"))
            rep["export"] = {"dir": os.path.basename(exp_dir),
                             "frames": len(motion["field2cam"]["quat"]), "video_frames": n_frames,
                             "objs": [objs[0], objs[-1], len(objs)] if objs else [],
                             "launches": dict(kernels.COUNTS)}
            if (os.path.basename(exp_dir) != "export_%04d" % inst_id
                    or len(motion["field2cam"]["quat"]) != n_frames
                    or objs[0] != "fg-%05d.obj" % offsets[inst_id]
                    or not np.isfinite(np.asarray(motion["field2cam"]["trans"])).all()
                    or any(kernels.COUNTS.values())):
                raise AssertionError(f"{tag} export: {rep['export']}")
            log(f"[{tag} export] {json.dumps({'s': rep['export_s'], **rep['export']})}")

        if export_reanimate:
            # the canonical mesh and the motion with the skeleton's joint angles
            kernels.reset_counts()
            t0 = time.perf_counter()
            exp_dir = export_cli.main(s2_flag + ["--export_mesh_stride", "4"])
            rep["export_s"] = time.perf_counter() - t0
            motion_path = os.path.abspath(os.path.join(exp_dir, "motion.json"))
            with open(motion_path) as f:
                motion = json.load(f)
            so3 = np.asarray(motion.get("joint_so3", []))
            rep["motion"] = {"keys": sorted(motion), "joint_so3": list(so3.shape),
                             "files": sorted(os.listdir(exp_dir)), "launches": dict(kernels.COUNTS)}
            if (sorted(motion) != ["field2cam", "joint_so3", "t_articulation"]
                    or so3.shape != (S2_FRAMES, 25, 3) or not np.isfinite(so3).all()
                    or any(kernels.COUNTS.values())):
                raise AssertionError(f"{tag} export: {rep['motion']}")
            log(f"[{tag} export] {json.dumps({'s': rep['export_s'], **rep['motion']})}")

        # the hand-off: the port's Stage 3 from this Stage-2 output
        s3_metrics = []
        s3_step = Stage3Trainer.train_step

        def s3_train_step(self, *a, **kw):
            m = s3_step(self, *a, **kw)
            s3_metrics.append({k: float(v) for k, v in m.items()})
            return m
        originals[Stage3Trainer, "train_step"] = s3_step
        Stage3Trainer.train_step = s3_train_step
        kernels.reset_counts()
        t0 = time.perf_counter()
        s3 = train_cli.main(["--seqname", seqname, "--logname", f"s3-{tag}", "--fg_motion",
                             handoff_motion, "--train_res", str(S2_RES), "--num_rounds", "1",
                             "--iters_per_round", str(S2_HANDOFF_STEPS), "--imgs_per_gpu",
                             "1", "--pixels_per_image", "-1", "--learning_rate", "3e-5",
                             "--seed", "0", "--gs_init_mesh", geo,
                             "--load_path", os.path.join(save_dir, "ckpt_latest.pth"),
                             *handoff_flags])
        torch.cuda.synchronize()
        handoff = dict(kernels.COUNTS)
        restore()
        rep["handoff_s"] = time.perf_counter() - t0
        s3_dir = os.path.abspath(s3.save_dir)
        rep["handoff_alive"] = int(s3.surfels.num_alive())
        rep["handoff_num_inst"] = s3.deformer.num_inst
        del s3
        bad = [k for m in s3_metrics for k, v in m.items() if not np.isfinite(v)]
        if (len(s3_metrics) != S2_HANDOFF_STEPS or bad or handoff["tile_forward"] < 1
                or handoff["tile_backward"] < 1 or handoff["tile_forward_plain"]
                or handoff["tile_backward_plain"]):
            raise AssertionError(f"{tag} hand-off: {len(s3_metrics)} steps, non-finite {bad}, "
                                 f"launches {handoff}")
        rep_h = {"s": rep["handoff_s"], "motion": handoff_motion, "flags": list(handoff_flags),
                 "num_inst": rep["handoff_num_inst"], "alive": rep["handoff_alive"],
                 "launches": handoff, "losses": s3_metrics[-1]}
        log(f"[{tag} handoff] {json.dumps(rep_h)}")
        torch.cuda.empty_cache()

        if export_reanimate:
            # the hand-off's Stage 3 driven by the Stage-2 export's motion
            kernels.reset_counts()
            t0 = time.perf_counter()
            out = reanimate_cli.main([f"--flagfile={s3_dir}/opts.log", "--load_suffix", "latest",
                                      "--render_res", str(S2C_REANIMATE_RES),
                                      "--motion_path", motion_path])
            torch.cuda.synchronize()
            reanimate_counts = dict(kernels.COUNTS)
            rep["reanimate_s"] = time.perf_counter() - t0
            img = out["rendered"]
            rep_a = {"s": rep["reanimate_s"], "shape": list(img.shape),
                     "cover": float((out["mask"] > 0.01).mean()), "launches": reanimate_counts}
            if (img.shape != (S2_FRAMES, S2C_REANIMATE_RES, S2C_REANIMATE_RES, 3)
                    or not all(np.isfinite(v).all() for v in out.values())
                    or reanimate_counts["tile_forward"] < 1
                    or reanimate_counts["tile_forward_plain"]
                    or reanimate_counts["tile_backward_plain"]):
                raise AssertionError(f"{tag} reanimate: {rep_a}")
            log(f"[{tag} reanimate] {json.dumps(rep_a)}")
            del out
    finally:
        restore()
        os.chdir(cwd)
    return rep, s2_counts, handoff, reanimate_counts


def stage1_video(frames, h, w, n, device="cuda", seed=0, turn_deg=S1_TURN_DEG,
                 drift_px=S1_DRIFT_PX):
    """A synthetic video of ``frames`` frames at h x w rendered by the
    port (K1 on the card): ``n`` opaque surfels tangent to an ellipsoid
    shell (S1_AXES at S1_DEPTH, colours a texture of the object's own
    coordinates), turning ``turn_deg`` per frame about a tilted axis and
    drifting ``drift_px`` (scaled by w / 1280) per frame, over a procedural
    background panning S1_PAN_PX (scaled) per frame; the camera is the
    pipeline's raw one (focal max(h, w), centred). Returns (frames
    (T, h, w, 3) float32, ground-truth masks (alpha > 0.5) and depths
    (T, h, w) float32)."""
    import torch

    from vidu4d_tpu_torch.ops.quaternion import matrix_to_quaternion, quaternion_mul
    from vidu4d_tpu_torch.ops.rasterize import rasterize

    rng = np.random.default_rng(seed)
    par = load_test_module("torch_parity")
    axes = np.asarray(S1_AXES)
    u = rng.normal(size=(n, 3))
    pts = u / np.linalg.norm(u, axis=-1, keepdims=True) * axes
    normal = pts / axes ** 2
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    tangent = np.cross(normal, rng.normal(size=(n, 3)))
    tangent /= np.linalg.norm(tangent, axis=-1, keepdims=True)
    quat0 = par.rot_to_qvec(np.stack([tangent, np.cross(normal, tangent), normal], axis=-1))
    checker = np.sign(np.sin(24 * pts[:, 0]) * np.sin(24 * pts[:, 1]) * np.sin(24 * pts[:, 2]))
    cols = np.clip(np.stack([0.65 + 0.2 * np.sin(9 * pts[:, 1] + 1.0),
                             0.35 + 0.2 * np.sin(11 * pts[:, 2]),
                             0.25 + 0.15 * np.cos(7 * pts[:, 0])], -1)
                   + 0.15 * checker[:, None], 0, 1)
    area = 4 * np.pi * np.prod(axes) ** (2 / 3)
    sigma = 0.8 * np.sqrt(area / n)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    focal, scale = float(max(h, w)), w / 1280.0
    intrins = t([focal, focal, w / 2.0, h / 2.0])
    tilt = np.radians(20.0)
    tilt_m = np.array([[1, 0, 0], [0, np.cos(tilt), -np.sin(tilt)], [0, np.sin(tilt), np.cos(tilt)]])
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32) / scale
    pts_t, quat_t = t(pts), t(quat0)
    out_f, out_m, out_d = [], [], []
    with torch.no_grad():
        for i in range(frames):
            a = np.radians(turn_deg * i)
            spin = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
            rot = tilt_m @ spin
            centre = np.array([(-0.12 + drift_px * i / 1280.0) * S1_DEPTH, 0.02, S1_DEPTH])
            means = pts_t @ t(rot).T + t(centre)
            quats = quaternion_mul(matrix_to_quaternion(t(rot))[None].expand(n, 4), quat_t)
            out = rasterize(means, quats, t(np.full((n, 2), sigma)), t(np.full(n, 0.9)),
                            t(np.eye(4)), intrins, h, w, colors=t(cols))
            bx = xs + S1_PAN_PX * i
            bg = np.stack([0.30 + 0.12 * np.sin(bx / 17 + c) * np.cos(ys / 23 - c)
                           + 0.08 * np.sin(bx / 5.3 + 2 * c) * np.sin(ys / 4.1 - c)
                           + 0.05 * np.sign(np.sin(bx / 9.7) * np.sin(ys / 8.3 + c))
                           for c in (0.0, 1.3, 2.1)], -1)
            alpha = out.alpha.cpu().numpy()[..., None]
            out_f.append(np.clip(out.color.cpu().numpy() + (1 - alpha) * bg, 0, 1))
            out_m.append(alpha[..., 0] > 0.5)
            out_d.append(out.depth.cpu().numpy() / np.maximum(alpha[..., 0], 1e-6))
    return (np.stack(out_f).astype(np.float32), np.stack(out_m),
            np.stack(out_d).astype(np.float32))


def stage1_files(seq, frames, crop, deltas):
    """The database files Stage 1 writes for one video (as the JAX package
    writes them): relative path -> (shape, dtype) or None; the frames as
    .jpg with imageio installed, else .png (the card's host has none)."""
    import importlib.util

    ext = "jpg" if importlib.util.find_spec("imageio") else "png"
    full = lambda kind, name: os.path.join("processed", kind, "Full-Resolution", seq, name)
    pre = f"crop-{crop}"
    files = {full("JPEGImages", f"{pre}.npy"): ((frames, crop, crop, 3), "float16"),
             full("Annotations", f"{pre}.npy"): ((frames, crop, crop, 2), "float16"),
             full("Annotations", f"{pre}-crop2raw.npy"): ((frames, 4), "float32"),
             full("Annotations", f"{pre}-is_detected.npy"): ((frames,), "float32"),
             full("Depth", f"{pre}.npy"): ((frames, crop, crop), "float16"),
             full("Features", f"{pre}-dinov2-01.npy"): ((frames, 112, 112, 16), "float16")}
    for d in deltas:
        for kind in ("FlowFW", "FlowBW"):
            files[full(f"{kind}_{d}", f"{pre}.npy")] = ((-(-(frames - d) // d), crop, crop, 3),
                                                         "float16")
    for name in ("00.npy", "01.npy", "01-canonical.npy"):
        files[full("Cameras", name)] = ((frames, 4, 4), "float32")
    for name in ("mesh-01-centered.obj", "mesh-00-centered.obj"):
        files[full("Cameras", name)] = None
    for i in range(frames):
        files[full("JPEGImages", f"{i:05d}.{ext}")] = None
    return files


def check_stage1_files(root, files):
    """Every file exists; every .npy has its shape and dtype and is finite."""
    bad = []
    for rel, spec in files.items():
        path = os.path.join(root, rel)
        if not os.path.isfile(path) or os.path.getsize(path) == 0:
            bad.append(f"missing {rel}")
        elif spec is not None:
            arr = np.load(path)
            if arr.shape != spec[0] or str(arr.dtype) != spec[1] or not np.isfinite(arr).all():
                bad.append(f"{rel}: {arr.shape} {arr.dtype} finite {np.isfinite(arr).all()}")
    if bad:
        raise AssertionError(f"stage1 database: {bad}")


def compare_stage1(ref_root, got_root, seq, crop, deltas):
    """A Stage-1 database (got) against another of the same clip (ref)
    within S1_TOL, file by file. Returns the worst differences."""
    import torch

    from vidu4d_tpu_torch.ops.geometry import rot_angle
    from vidu4d_tpu_torch.ops.marching import load_obj

    def load(root, kind, name):
        return np.load(os.path.join(root, "processed", kind, "Full-Resolution", seq, name))

    def angles(a, b):
        m = torch.as_tensor(a[:, :3, :3]) @ torch.as_tensor(b[:, :3, :3]).transpose(-1, -2)
        return float(rot_angle(m).max())

    pre, rep, bad = f"crop-{crop}", {}, []
    f32 = lambda kind, name: [load(r, kind, name).astype(np.float32) for r in (ref_root, got_root)]
    a, b = f32("JPEGImages", f"{pre}.npy")
    rep["crop"] = float(np.abs(a - b).max())
    for name in (f"{pre}.npy", f"{pre}-crop2raw.npy", f"{pre}-is_detected.npy"):
        a, b = f32("Annotations", name)
        rep[f"ann {name}"] = float(np.abs(a - b).max())
        if rep[f"ann {name}"] != 0.0:
            bad.append(f"Annotations {name}")
    for d in deltas:
        for kind in ("FlowFW", "FlowBW"):
            a, b = f32(f"{kind}_{d}", f"{pre}.npy")
            rep[f"{kind}_{d}"] = [float(np.abs(a[..., :2] - b[..., :2]).max()),
                                  float(np.mean(a[..., 2] != b[..., 2]))]
            if rep[f"{kind}_{d}"][0] > S1_TOL["flow"] or rep[f"{kind}_{d}"][1] > S1_TOL["share"]:
                bad.append(f"{kind}_{d}")
    a, b = f32("Depth", f"{pre}.npy")
    rep["depth"] = float(np.abs(a - b).max())
    a, b = f32("Features", f"{pre}-dinov2-01.npy")
    off_a, off_b = np.all(a == 0, -1), np.all(b == 0, -1)
    rep["features_off_equal"] = bool(np.array_equal(off_a, off_b))
    rep["features_norm_dev"] = float(np.abs(np.linalg.norm(b, axis=-1)[~off_b] - 1).max())
    for name in ("00.npy", "01.npy"):
        a, b = f32("Cameras", name)
        rep[f"cam {name}"] = [angles(a, b), float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())]
        if rep[f"cam {name}"][0] > S1_TOL["cam_rad"] or rep[f"cam {name}"][1] > S1_TOL["cam_t"]:
            bad.append(f"Cameras {name}")
    a, b = f32("Cameras", "01-canonical.npy")
    rep["canonical"] = [angles(a, b), float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())]
    mesh = [load_obj(os.path.join(r, "processed", "Cameras", "Full-Resolution", seq,
                                  "mesh-01-centered.obj"))[0] for r in (ref_root, got_root)]
    extent = float((mesh[0].max(0) - mesh[0].min(0)).max())
    dist = torch.cdist(torch.as_tensor(mesh[1]), torch.as_tensor(mesh[0]))
    rep["mesh"] = {"verts": [len(m) for m in mesh], "extent": extent,
                   "bounds": float(max(np.abs(mesh[0].min(0) - mesh[1].min(0)).max(),
                                       np.abs(mesh[0].max(0) - mesh[1].max(0)).max())),
                   "chamfer": 0.5 * float(dist.min(1).values.mean() + dist.min(0).values.mean())}
    texts = []
    for r in (ref_root, got_root):
        with open(os.path.join(r, "configs", f"{seq.rsplit('-', 1)[0]}.config")) as f:
            texts.append(f.read().replace(r, "<root>"))
    if (rep["crop"] > S1_TOL["crop"] or rep["depth"] > S1_TOL["depth"]
            or not rep["features_off_equal"] or rep["features_norm_dev"] > 2e-3
            or rep["canonical"][0] > S1_TOL["canon_rad"]
            or rep["canonical"][1] > S1_TOL["canon_t"]
            or rep["mesh"]["bounds"] > S1_TOL["mesh_bounds"] * extent
            or rep["mesh"]["chamfer"] > S1_TOL["chamfer"] * extent or texts[0] != texts[1]):
        bad.append("crop / depth / features / canonical / mesh / config")
    if bad:
        raise AssertionError(f"stage1 card vs cpu: {bad}: {rep}")
    return rep


def stage1_small_vs_cpu(tmp):
    """`preprocess_video` on the S1_SMALL clip (its masks given) on the
    card and on the CPU, compared file by file (`compare_stage1`); then
    `segment_video` with the motion seed on both, masks within
    S1_TOL["share"]."""
    import torch

    from vidu4d_tpu_torch.preprocess.pipeline import preprocess_video, write_config
    from vidu4d_tpu_torch.preprocess.segment import segment_video

    nf, h, w, n, crop, deltas, grid = S1_SMALL
    frames, masks, _ = stage1_video(nf, h, w, n)
    roots = {}
    for dev in ("cpu", "cuda"):
        roots[dev] = os.path.join(tmp, f"stage1-small-{dev}", "database")
        preprocess_video(frames, roots[dev], "small-0000", masks=masks.astype(np.float32),
                         crop_size=crop, delta_list=deltas, tsdf_grid=grid, device=dev)
        write_config(roots[dev], "small", crop_size=crop)
    rep = compare_stage1(roots["cpu"], roots["cuda"], "small-0000", crop, deltas)
    seg = {dev: segment_video(frames, auto_seed=True, device=dev) for dev in ("cpu", "cuda")}
    rep["segment_auto_share"] = float(np.mean((seg["cpu"] > 0.5) != (seg["cuda"] > 0.5)))
    if rep["segment_auto_share"] > S1_TOL["share"]:
        raise AssertionError(f"stage1 small segment card vs cpu: {rep['segment_auto_share']}")
    log(f"[stage1 small cpu-vs-gpu {nf}x{h}x{w}] {json.dumps(rep)}")
    torch.cuda.empty_cache()
    return rep


def stage1_path(tmp):
    """[stage1]: the S1_FRAMES x S1_RES video through `preprocess_video`
    (segment_backend "auto", the defaults) and `write_config` on the card;
    requires the RAFT / DepthNet / FeatNet backends, every file of the
    contract (`stage1_files`) with its shape and dtype and finite,
    canonical z in (0, 10], a non-empty centred mesh, the port's loaders
    reading the database back, and no tile kernel launched; prints the
    seed's source, the mask IoU and the depth's rank correlation against
    the render's ground truth (in the crop frame), each stage's seconds,
    RAFT's chunk and the peak memory. Then `stage2_path` on this database
    (S1_S2_FLAGS: full mlp_init, 1 round of S1_S2_ITERS steps, the render,
    the gs-bob hand-off). Returns (report, Stage-1 launches, Stage-2
    launches, hand-off launches)."""
    import torch
    from scipy.stats import spearmanr

    from vidu4d_tpu_torch import kernels
    from vidu4d_tpu_torch.data import data_utils
    from vidu4d_tpu_torch.preprocess import ops as pops
    from vidu4d_tpu_torch.preprocess.pipeline import preprocess_video, write_config

    t0 = time.perf_counter()
    frames, gt_mask, gt_depth = stage1_video(S1_FRAMES, *S1_RES, S1_SURFELS)
    rep = {"render_s": time.perf_counter() - t0, "gt_cover": float(gt_mask.mean())}
    db = os.path.join(tmp, "stage1", "database")
    stats = {}
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    preprocess_video(frames, db, "synth-0000", masks=None, segment_backend="auto",
                     device="cuda", stats=stats)
    write_config(db, "synth")
    torch.cuda.synchronize()
    s1_counts = dict(kernels.COUNTS)
    rep["preprocess_s"] = time.perf_counter() - t0
    rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rep.update(stats)
    backends = (stats["segment_flow"], stats["flow"], stats["depth"], stats["features"])
    if backends != ("raft", "raft", "depthnet", "featnet") or any(s1_counts.values()):
        raise AssertionError(f"stage1 backends {backends}, launches {s1_counts}")
    check_stage1_files(db, stage1_files("synth-0000", S1_FRAMES, S1_CROP, S1_DELTAS))
    full = lambda kind, name: np.load(os.path.join(db, "processed", kind, "Full-Resolution",
                                                   "synth-0000", name))
    canon = full("Cameras", "01-canonical.npy")
    from vidu4d_tpu_torch.ops.marching import load_obj

    mesh_v, mesh_f = load_obj(os.path.join(db, "processed", "Cameras", "Full-Resolution",
                                           "synth-0000", "mesh-01-centered.obj"))
    rep["mesh"] = [int(len(mesh_v)), int(len(mesh_f))]
    rep["canonical_z"] = [float(canon[:, 2, 3].min()), float(canon[:, 2, 3].max())]
    if not ((canon[:, 2, 3] > 0).all() and (canon[:, 2, 3] <= 10.0).all() and len(mesh_f)):
        raise AssertionError(f"stage1: canonical z {rep['canonical_z']}, mesh {rep['mesh']}")
    datasets = data_utils.build_datasets({"dataroot": db, "seqname": "synth",
                                          "data_prefix": "crop", "train_res": S1_CROP})
    info = data_utils.get_data_info(datasets)
    if info["rtmat"].shape[1] != S1_FRAMES or not np.isfinite(info["rtmat"]).all():
        raise AssertionError(f"stage1: the loaders read rtmat {info['rtmat'].shape}")

    # against the render's ground truth, in the crop frame
    c2r = torch.as_tensor(full("Annotations", f"crop-{S1_CROP}-crop2raw.npy"))
    ann = full("Annotations", f"crop-{S1_CROP}.npy").astype(np.float32)[..., 0] > 0.5
    depth = full("Depth", f"crop-{S1_CROP}.npy").astype(np.float32)
    ious, rhos = [], []
    for i in range(S1_FRAMES):
        m = pops.crop_resample(torch.as_tensor(gt_mask[i, ..., None], dtype=torch.float32),
                               c2r[i], S1_CROP, nearest=True)[..., 0].numpy() > 0.5
        d = pops.crop_resample(torch.as_tensor(gt_depth[i, ..., None]), c2r[i],
                               S1_CROP)[..., 0].numpy()
        ious.append(float((m & ann[i]).sum() / max((m | ann[i]).sum(), 1)))
        rhos.append(float(spearmanr(depth[i][m], d[m])[0]) if m.sum() > 2 else float("nan"))
    rep["mask_iou"] = [float(np.min(ious)), float(np.mean(ious))]
    rep["depth_rank_corr"] = [float(np.nanmin(rhos)), float(np.nanmean(rhos))]
    log(f"[stage1] {json.dumps(rep)}")
    torch.cuda.empty_cache()

    s2_rep, s2_counts, handoff, _ = stage2_path(tmp, S1_S2_FLAGS, 1, S2_TERMS, "stage1-stage2",
                                                database=db, iters=S1_S2_ITERS)
    rep["stage2"] = {k: s2_rep[k] for k in ("mlp_init_s", "step_ms_median", "peak_gib",
                                             "render_s", "handoff_s")}
    return rep, s1_counts, s2_counts, handoff


def stage1_train_step_vs_cpu():
    """One step of each Stage-1 trainer (`train_step` with its optimiser of
    ST_STEPS steps) on the CPU and on the card from the same flax-initialised
    parameters and the same batch at the default size: the loss, every
    gradient and the updated parameters (the bounds of ST_LOSS_RTOL).
    Returns the worst shares by net."""
    import copy

    import torch

    from vidu4d_tpu_torch.preprocess import train_common as tc
    from vidu4d_tpu_torch.preprocess import train_depthnet as tdp
    from vidu4d_tpu_torch.preprocess import train_featnet as tfe
    from vidu4d_tpu_torch.preprocess import train_raft as tra
    from vidu4d_tpu_torch.preprocess.depthnet import DepthNet, ranking_pairs
    from vidu4d_tpu_torch.preprocess.featnet import FeatNet
    from vidu4d_tpu_torch.preprocess.raft import RaftSmall

    rng = np.random.default_rng(7)
    raft_batch = tra.make_batch(rng, ST_RES, ST_BATCH["raft"])
    i1, i2, fl = tra.make_batch(rng, ST_RES, ST_BATCH["featnet"])
    feat_batch = (i1, i2) + tfe.batch_correspondences(rng, fl, 512, ST_RES, "cpu")
    rot = tdp.scene_rotations(torch.Generator().manual_seed(0))
    depth_batch = tuple(x.cpu() for x in tdp.make_batch(rng, ST_RES, ST_BATCH["depthnet"],
                                                        rot, "cuda"))
    depth_batch += ranking_pairs(ST_BATCH["depthnet"], ST_RES * ST_RES,
                                 torch.Generator().manual_seed(1))
    cases = {"raft": (RaftSmall, tra, raft_batch), "featnet": (FeatNet, tfe, feat_batch),
             "depthnet": (DepthNet, tdp, depth_batch)}
    worst = {}
    for name, (net, module, batch) in cases.items():
        base = tc.flax_conv_init_(net(), torch.Generator().manual_seed(0))
        runs = {}
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(base).to(dev)
            opt = module.make_optimizer(model, ST_STEPS, ST_LR[name])
            out = module.train_step(model, opt, *[x.to(dev) for x in batch])
            loss = out[0] if isinstance(out, tuple) else out
            runs[dev] = (float(loss), {k: p.grad.cpu() for k, p in model.named_parameters()},
                         {k: p.detach().cpu() for k, p in model.named_parameters()},
                         opt.schedule(0))
        torch.cuda.synchronize()
        (l_c, g_c, p_c, lr0), (l_g, g_g, p_g, _) = runs["cpu"], runs["cuda"]
        floor = STEP_GRAD_FLOOR * max(float(g.abs().max()) for g in g_c.values())
        rep = {"loss": [l_c, l_g], "loss_rel": abs(l_g - l_c) / abs(l_c), "grad": 0.0,
               "param": 0.0, "lr0": lr0}
        bad = []
        for k in g_c:
            err = float((g_g[k] - g_c[k]).abs().max())
            bound = STEP_GRAD_REL_TOL * float(g_c[k].abs().max()) + floor
            rep["grad"] = max(rep["grad"], err / bound)
            pbound = 2 * lr0 + 1e-6 * p_c[k].abs()
            rep["param"] = max(rep["param"], float(((p_g[k] - p_c[k]).abs() / pbound).max()))
            if err > bound or ((p_g[k] - p_c[k]).abs() > pbound).any():
                bad.append(k)
        if not np.isfinite(l_c) or rep["loss_rel"] > ST_LOSS_RTOL or bad:
            raise AssertionError(f"stage1-train step cpu-vs-gpu {name}: {rep}, {bad[:5]}")
        worst[name] = rep
    log(f"[stage1-train step cpu-vs-gpu {ST_RES}^2] {json.dumps(worst)} (loss_rel: relative "
        f"difference; grad, param: max share of their bounds)")
    return worst


def stage1_train_path(tmp, rng):
    """[stage1-train]: `stage1_train_step_vs_cpu`, then each trainer's
    `main` on the card at ST_RES^2 with its default batch for ST_STEPS steps
    (DepthNet on a pool of ST_POOL scenes rendered by K1): every loss
    finite, the parameters moved, the npz with the shipped file's keys,
    shapes and dtypes, read back by the port's loader to the trained net's
    outputs; the launches: K1 once per rendered scene (the init batch, the
    pool, the 4 held-out batches), no K2, no plain version; then both
    kernels against their plain versions on the inputs of one make_scene
    render (timed). Returns (report, launches, kernel check)."""
    import torch

    from vidu4d_tpu_torch import kernels
    from vidu4d_tpu_torch.ops.rasterize import api
    from vidu4d_tpu_torch.preprocess import train_depthnet as tdp
    from vidu4d_tpu_torch.preprocess import train_featnet as tfe
    from vidu4d_tpu_torch.preprocess import train_raft as tra
    from vidu4d_tpu_torch.preprocess.layers import WEIGHTS_DIR, load_net

    stage1_train_step_vs_cpu()
    out_dir = os.path.join(tmp, "stage1-train")
    x1 = torch.rand((2, 3, ST_RES, ST_RES), generator=torch.Generator().manual_seed(3)).cuda()
    x2 = torch.rand((2, 3, ST_RES, ST_RES), generator=torch.Generator().manual_seed(4)).cuda()
    apply = {"raft": lambda m: m(x1, x2), "featnet": lambda m: m(x1),
             "depthnet": lambda m: m(x1)}
    rep = {}
    kernels.reset_counts()
    for name, module, extra in (("raft", tra, []), ("featnet", tfe, []),
                                ("depthnet", tdp, ["--pool", str(ST_POOL)])):
        path = os.path.join(out_dir, ST_SHIPPED[name])
        t0 = time.perf_counter()
        res = module.main(["--steps", str(ST_STEPS), "--res", str(ST_RES), "--batch",
                           str(ST_BATCH[name]), "--out", path, "--device", "cuda", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        model = res.pop("model")
        with np.load(os.path.join(WEIGHTS_DIR, ST_SHIPPED[name])) as a, np.load(path) as b:
            same_layout = a.files == b.files and all(
                a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a.files)
        back = load_net(type(model)(), path, "cuda")
        with torch.no_grad():
            reread = torch.equal(apply[name](model.eval()), apply[name](back))
        losses = np.asarray(res["loss"])
        rep[name] = {k: v for k, v in res.items() if k not in ("loss", "epe", "step_ms",
                                                                "render_ms", "out")}
        rep[name].update(wall_s=wall, loss_first_last=[float(losses[0]), float(losses[-1])],
                         step_ms_median=float(np.median(res["step_ms"])),
                         step_ms_p90=float(np.percentile(res["step_ms"], 90)),
                         same_layout=same_layout, reread=reread)
        if name == "depthnet":
            rep[name]["render_ms_median"] = float(np.median(res["render_ms"]))
        if (not np.isfinite(losses).all() or len(losses) != ST_STEPS
                or not res["param_change"] > 0 or not same_layout or not reread):
            raise AssertionError(f"stage1-train {name}: {rep[name]}")
        del model, back
    launches = dict(kernels.COUNTS)
    scenes = ST_BATCH["depthnet"] + ST_POOL + 4 * ST_BATCH["depthnet"]
    rep["scenes_rendered"] = scenes
    if (launches["tile_forward"] != scenes or launches["tile_backward"]
            or launches["tile_forward_plain"] or launches["tile_backward_plain"]):
        raise AssertionError(f"stage1-train launches {launches}, expected {scenes} K1")
    log(f"[stage1-train] {json.dumps(rep)} launches {json.dumps(launches)}")

    # K1 (and K2 on random cotangents) against the plain versions on the
    # inputs of one make_scene render at ST_RES^2
    kept, orig = {}, api.composite_batch

    def composite(prepared, *a, **kw):
        kept.update({k: prepared[k].detach().clone() if torch.is_tensor(prepared[k])
                     else prepared[k] for k in KERNEL_INPUTS})
        return orig(prepared, *a, **kw)

    api.composite_batch = composite
    try:
        tdp.make_scene(np.random.default_rng(11), ST_RES,
                       tdp.scene_rotations(torch.Generator().manual_seed(0)), "cuda")
    finally:
        api.composite_batch = orig
    check = compare_kernels(kept, rng, f"stage1-train make_scene {ST_RES}^2", timed=True)
    if check["max_tile"] > 1024:
        raise AssertionError(f"make_scene: a tile holds {check['max_tile']} entries, above "
                             "the JAX tiles path's budget of 1024")
    torch.cuda.empty_cache()
    return rep, launches, check


def multi_inst_path(tmp):
    """[multi-inst]: the small float64 Stage-2 step with one instance code
    per video on the card vs the CPU (`stage2_small_vs_cpu`); two clips of
    MI_FRAMES x S1_RES (MI_MOTIONS) through `preprocess_video` (segment
    "auto", the defaults) into one database with `write_config`, every
    file of the contract; then `stage2_path` with MI_FLAGS (--nosingle_inst:
    num_inst 2) on it: full mlp_init, 1 round of MI_ITERS steps, the render
    and export of video 1 (--inst_id 1), the gs-bob --nosingle_inst
    hand-off (its deformer's num_inst 2, K1 and K2 launched, no plain
    version). Returns (report, Stage-2 launches, hand-off launches)."""
    import torch

    from vidu4d_tpu_torch.preprocess.pipeline import preprocess_video, write_config

    stage2_small_vs_cpu(tmp, single_inst=False)
    db = os.path.join(tmp, "multi", "database")
    rep = {"clips": []}
    for i, (turn, drift, seed) in enumerate(MI_MOTIONS):
        t0 = time.perf_counter()
        frames, _, _ = stage1_video(MI_FRAMES, *S1_RES, S1_SURFELS, seed=seed, turn_deg=turn,
                                    drift_px=drift)
        clip = {"turn_deg": turn, "drift_px": drift, "render_s": time.perf_counter() - t0}
        stats = {}
        t0 = time.perf_counter()
        preprocess_video(frames, db, f"multi-{i:04d}", masks=None, segment_backend="auto",
                         device="cuda", stats=stats)
        torch.cuda.synchronize()
        clip["preprocess_s"] = time.perf_counter() - t0
        clip["seed"] = stats["seed"]
        check_stage1_files(db, stage1_files(f"multi-{i:04d}", MI_FRAMES, S1_CROP, S1_DELTAS))
        rep["clips"].append(clip)
        del frames
    write_config(db, "multi")
    log(f"[multi-inst stage1] {json.dumps(rep)}")
    torch.cuda.empty_cache()
    s2_rep, s2_counts, handoff, _ = stage2_path(tmp, MI_FLAGS, 1, S2_TERMS, "multi-inst",
                                                database=db, iters=MI_ITERS, inst_id=1,
                                                handoff_flags=("--nosingle_inst",))
    rep.update({k: s2_rep[k] for k in ("num_inst", "handoff_num_inst", "frame_offset_raw",
                                        "mlp_init_s", "step_ms_median", "step_ms_p90",
                                        "peak_gib", "render_s", "export_s", "handoff_s")})
    if (rep["num_inst"] != 2 or rep["handoff_num_inst"] != 2
            or len(rep["frame_offset_raw"]) != 3 or any(s2_counts.values())):
        raise AssertionError(f"multi-inst: {rep}, Stage-2 launches {s2_counts}")
    log(f"[multi-inst] {json.dumps({k: v for k, v in rep.items() if k != 'clips'})}")
    return rep, s2_counts, handoff


# ----------------------------------------------------------------------
# [multi-gpu]: data parallelism over frame pairs (2 gloo ranks on one card)
# ----------------------------------------------------------------------


def mg_save_state(trainer, batch, path):
    """A Stage-3 trainer's deformer and surfel store and a batch, as CPU
    tensors in one pickle (every run of the phase starts from it)."""
    import pickle

    cpu = lambda t: t.detach().cpu()
    s = trainer.surfels
    with open(path, "wb") as f:
        pickle.dump({"opts": trainer.opts,
                     "deformer": {k: cpu(v) for k, v in trainer.deformer.state_dict().items()},
                     "surfels": [cpu(x) for x in (*s.params, *s[1:])],
                     "batch": {k: cpu(v) for k, v in batch.items()}}, f)


def mg_stage3_snapshot(trainer):
    cpu = lambda t: t.detach().float().cpu()
    s, a = trainer.surfels, trainer.gs_adam
    return {"deformer": {k: cpu(v) for k, v in trainer.deformer.named_parameters()},
            "warp_mu": {k: cpu(v) for k, v in trainer.warp_opt.mu.items()},
            "surfels": {f: cpu(v) for f, v in zip(s.params._fields, s.params)},
            "surfel_mu": {f: cpu(v) for f, v in zip(a.mu._fields, a.mu)},
            "stats": {f: cpu(getattr(s, f)) for f in ("grad_accum", "denom", "max_radii2d")},
            "alive": s.alive.cpu()}


def mg_stage3_run(mesh, state_path, steps, ref_path=None, check_kernels=False, hooks=False):
    """One run of the Stage-3 comparison: a trainer of the saved state's
    options on this process's card (ngpu = the group's size), the saved
    state loaded (and broadcast), then ``steps`` steps on the saved global
    batch, the 2DGS terms in the last. Without ``ref_path`` (the one
    process) the metrics and the state after each step are written to
    ``state_path`` + ".ref"; with it each rank compares its own with them.
    The one process also saves its whole trainable state after each step
    (``.ref.state<i>``); a run against it starts each later step from that
    state (`force_state`), so that every step is compared from the same
    state as the first: a step's rounding differences do not carry into
    the next. ``check_kernels``: after the steps rank 0 holds both kernels
    against their plain versions on its share's inputs. With ``hooks``,
    then (from the one process's last state, against it) the densify,
    opacity-reset and outlier hooks fire once (their cadence set to the
    step count), and the ranks' checksums are compared again. Returns the
    report: per step the metrics and the worst differences, the ranks'
    checksum agreement, step ms, the host batch ms, the gradient all-reduce
    ms, the launches and the peak memory."""
    import pickle

    import torch

    from vidu4d_tpu_torch import kernels
    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer
    from vidu4d_tpu_torch.models.gaussian import surfels as sf
    from vidu4d_tpu_torch.models.gaussian.optimizer import field_lrs
    from vidu4d_tpu_torch.parallel import sharding

    with open(state_path, "rb") as f:
        st = pickle.load(f)
    dev = torch.device("cuda", torch.cuda.current_device())
    world = 1 if mesh is None else mesh.world
    opts = {**st["opts"], "ngpu": world, "logname": f"mg{world}",
            **({"densify_from_iter": 0, "densification_interval": steps,
                "opacity_reset_interval": steps, "outlier_filtering_interval": steps}
               if hooks else {})}
    trainer = Stage3Trainer(opts, dev, group=mesh)
    trainer.deformer.load_state_dict(st["deformer"])
    n = len(sf.SurfelParams._fields)
    t = [x.to(dev) for x in st["surfels"]]
    trainer.set_surfels(sf.SurfelState(
        sf.SurfelParams(*[p.clone().requires_grad_(True) for p in t[:n]]), *t[n:]))
    trainer.broadcast_state()
    batch = {k: v.to(dev) for k, v in st["batch"].items()}
    ref = None
    if ref_path is not None:
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
    saved = (state_path + ".ref") if ref is None else ref_path
    rep = {"rank": 0 if mesh is None else mesh.rank, "world": world, "steps": [],
           "agree": [trainer.ranks_agree()], "step_ms": []}
    snaps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    for i in range(steps):
        if ref is not None and i > 0:
            force_state(trainer.state_tensors(), f"{saved}.state{i - 1}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch, use_2dgs_reg=(i == steps - 1))
        torch.cuda.synchronize()
        rep["step_ms"].append((time.perf_counter() - t0) * 1e3)
        metrics = {k: float(v) for k, v in m.items()}
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"[multi-gpu] rank {rep['rank']} step {i}: non-finite {bad}")
        rep["agree"].append(trainer.ranks_agree())
        snap = mg_stage3_snapshot(trainer)
        lrs = (trainer.warp_opt.schedule(i), field_lrs(trainer.gs_lrs, float(i + 1))._asdict())
        entry = {"metrics": metrics}
        if ref is None:
            snaps.append({"metrics": metrics, **snap})
            torch.save([x.detach().cpu() for x in trainer.state_tensors()],
                       f"{saved}.state{i}")
        else:
            entry["diff"] = mg_stage3_diff(ref["steps"][i], metrics, snap, lrs)
        rep["steps"].append(entry)
    rep["launches"] = dict(kernels.COUNTS)
    rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # the host's read of the global batch from the memory maps, which every
    # rank makes, and the flat all-reduce of the step's gradients
    rep["batch_ms"] = []
    for _ in range(3):
        t0 = time.perf_counter()
        trainer._next_batch()
        torch.cuda.synchronize()
        rep["batch_ms"].append((time.perf_counter() - t0) * 1e3)
    params = [*trainer.deformer.parameters(), *trainer.surfels.params]
    rep["grad_floats"] = int(sum(p.numel() for p in params))
    if mesh is not None:
        rep["allreduce_ms"] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sharding.all_reduce_grads_(params, mesh)
            torch.cuda.synchronize()
            rep["allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
    if check_kernels and rep["rank"] == 0:
        with torch.no_grad():
            local, _ = sharding.shard_batch(batch, mesh) if mesh is not None else (batch, None)
            prepared, _ = trainer.render_inputs(local)
        rep["kernel_check"] = compare_kernels(
            prepared, np.random.default_rng(11),
            f"multi-gpu rank {rep['rank']} of {world}: {int(local['frameid'].shape[0])} frames",
            timed=True)
    out = {"steps": snaps}
    if hooks:
        if ref is not None:
            force_state(trainer.state_tensors(), f"{saved}.state{steps - 1}")
        trainer._densify_hooks()
        rep["hooks"] = [{k: v if k in ("hook", "step") else int(v) for k, v in e.items()}
                        for e in trainer.hook_log]
        rep["agree_after_hooks"] = trainer.ranks_agree()
        rep["alive_after_hooks"] = int(trainer.surfels.num_alive())
        snap = mg_stage3_snapshot(trainer)
        if ref is None:
            out.update(hooks=rep["hooks"], after_hooks=snap)
        else:
            rep["hooks_diff"] = mg_hooks_diff(ref, rep["hooks"], snap)
    if ref is None:
        with open(saved, "wb") as f:
            pickle.dump(out, f)
    return rep


def force_state(tensors, path):
    """Copy a saved trainable state (`Stage3Trainer.state_tensors` order)
    into ``tensors``, in place."""
    import torch

    with torch.no_grad():
        for t, v in zip(tensors, torch.load(path), strict=True):
            t.copy_(v)


def mg_hooks_diff(ref, hooks, snap):
    """The hooks fired from the one process's last state against the one
    process's: their log (what fired, how many slots each touched) and the
    alive mask exactly; the surfel parameters, Adam moments and densify
    statistics after them relative to each tensor's max |.|."""
    if hooks != ref["hooks"]:
        raise AssertionError(f"[multi-gpu] hooks {hooks}, one process {ref['hooks']}")
    want = ref["after_hooks"]
    if not bool((want["alive"] == snap["alive"]).all()):
        raise AssertionError("[multi-gpu] the alive masks after the hooks differ")
    rel_max = lambda a, b: float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30) \
        if a.numel() else 0.0
    return {"hooks_rel_to_max": max(rel_max(v, snap[g][k]) for g in ("surfels", "surfel_mu",
                                                                      "stats")
                                    for k, v in want[g].items())}


def mg_stage3_diff(ref, metrics, snap, lrs):
    """The worst differences of one step against the one process's, both
    from the same state: loss terms and gnorm relative; the Adam moments
    (the gradients' running means) relative to each tensor's max |.|; the
    parameters over 2 x the step's learning rate (x the multiplier: Adam's
    ~lr * g / |g| flips where g is rounding noise); grad_accum and
    max_radii2d relative to their max, denom's differing slots; alive
    exactly; the overflow and truncated counts' difference. ``lrs``: (warp
    learning rate, per-field surfel learning rates) of the step. The
    overflow and truncated counts and denom's slots may differ where a
    splat sits on a span or visibility boundary."""
    from vidu4d_tpu_torch.engine.optim import lr_multiplier

    rel_max = lambda a, b: float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30) \
        if a.numel() else 0.0
    out = {"metrics_rel": 0.0, "count_diff": 0}
    if set(ref["metrics"]) != set(metrics):
        raise AssertionError(f"[multi-gpu] terms {sorted(set(ref['metrics']) ^ set(metrics))}")
    for k, a in ref["metrics"].items():
        b = metrics[k]
        if k == "alive":
            if a != b:
                raise AssertionError(f"[multi-gpu] alive: one process {a}, rank {b}")
        elif k in ("overflow_splats", "truncated_entries"):
            out["count_diff"] = max(out["count_diff"], int(abs(a - b)))
        else:
            out["metrics_rel"] = max(out["metrics_rel"], abs(a - b) / max(abs(a), 1e-12))
    warp_lr, surfel_lr = lrs
    out["warp_mu_rel_to_max"] = max(rel_max(v, snap["warp_mu"][k])
                                    for k, v in ref["warp_mu"].items())
    out["deformer_over_2lr"] = max(
        float((v - snap["deformer"][k]).abs().max()) / (2 * warp_lr * lr_multiplier(k))
        for k, v in ref["deformer"].items())
    out["surfel_mu_rel_to_max"] = max(rel_max(v, snap["surfel_mu"][k])
                                      for k, v in ref["surfel_mu"].items())
    out["surfel_over_2lr"] = max(
        float((v - snap["surfels"][k]).abs().max()) / (2 * surfel_lr[k]) if v.numel() else 0.0
        for k, v in ref["surfels"].items())
    out["grad_accum_rel_to_max"] = rel_max(ref["stats"]["grad_accum"], snap["stats"]["grad_accum"])
    out["max_radii2d_rel_to_max"] = rel_max(ref["stats"]["max_radii2d"],
                                            snap["stats"]["max_radii2d"])
    out["denom_slots_differing"] = int((ref["stats"]["denom"] != snap["stats"]["denom"]).sum())
    if not bool((ref["alive"] == snap["alive"]).all()):
        raise AssertionError("[multi-gpu] the alive masks differ")
    return out


def mg_stage2_state(run, flags, path):
    """A Stage-2 trainer of ``flags`` on the card after a short SDF pretrain
    (MG_S2_SDF_ITERS) and the proxy geometry, its model, field states and
    MG_S2_STEPS global batches saved to ``path``."""
    import pickle

    import torch

    from vidu4d_tpu_torch import config
    from vidu4d_tpu_torch.engine.trainer import Stage2Trainer

    opts = config.parse_flags(flags)
    opts.pop("device")
    tr = Stage2Trainer({**opts, "logroot": os.path.join(run, "logdir")}, "cuda")
    tr._geometry_init(sdf_iters=MG_S2_SDF_ITERS, verbose=False)
    tr.update_geometry_aux(beta=0.0)
    cpu = lambda t: t.detach().cpu()
    with open(path, "wb") as f:
        pickle.dump({"opts": tr.opts,
                     "model": {k: cpu(v) for k, v in tr.model.state_dict().items()},
                     "states": {c: [cpu(x) for x in s] for c, s in tr.states.items()},
                     "batches": [{k: cpu(v) for k, v in tr._next_batch().items()}
                                 for _ in range(MG_S2_STEPS)]}, f)
    torch.cuda.synchronize()


def mg_stage2_run(mesh, state_path, ref_path=None):
    """The Stage-2 comparison on this process (one rank of ``mesh``), in
    float64 (as the Stage-2 card-vs-CPU checks: in float32 the camera and
    intrinsics gradients are ill-conditioned, and another summation order
    moves them by percents): the saved model and states, MG_S2_STEPS steps
    on the saved global batches with the draws of a generator seeded with
    the step; the metrics, the parameters and the AdamW moments after each
    step written to ``state_path`` + ".ref" (the one process, with its
    whole state after each step in ``.ref.state<i>``) or compared with them
    (each rank, which starts each later step from the one process's state,
    as `mg_stage3_run` does). Returns the report."""
    import pickle

    import torch

    from vidu4d_tpu_torch.engine.optim import lr_multiplier, make_stage2_optimizer
    from vidu4d_tpu_torch.engine.trainer import Stage2Trainer
    from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState
    from vidu4d_tpu_torch.parallel import sharding

    with open(state_path, "rb") as f:
        st = pickle.load(f)
    dev = torch.device("cuda", torch.cuda.current_device())
    f64 = lambda d: {k: (v.double() if v.is_floating_point() else v).to(dev)
                     for k, v in d.items()}
    world = 1 if mesh is None else mesh.world
    tr = Stage2Trainer({**st["opts"], "ngpu": world, "logname": f"mg-s2-{world}"}, dev,
                       group=mesh)
    tr.model.double()
    tr.model.load_state_dict(f64(st["model"]))
    tr.states = {c: FieldState(*[x.double().to(dev) for x in s]) for c, s in st["states"].items()}
    tr.optimizer = make_stage2_optimizer(tr.model, tr.opts.get("learning_rate", 5e-4),
                                         tr.total_steps, tr.opts["num_rounds"])
    tr.broadcast_state()
    ref = None
    if ref_path is not None:
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
    saved = (state_path + ".ref") if ref is None else ref_path
    state = lambda: [*tr.model.state_dict().values(), *tr.optimizer.mu.values(),
                     *tr.optimizer.nu.values()]
    rep = {"rank": 0 if mesh is None else mesh.rank, "world": world, "steps": [],
           "step_ms": [], "agree": [tr.ranks_agree()]}
    snaps = []
    torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(st["batches"]):
        if ref is not None and i > 0:
            force_state(state(), f"{saved}.state{i - 1}")
        batch = f64(b)
        draws = f64(tr.model.reg_draws(torch.Generator(dev).manual_seed(i)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch, draws)
        torch.cuda.synchronize()
        rep["step_ms"].append((time.perf_counter() - t0) * 1e3)
        lr = tr.optimizer.schedule(i)
        rep["agree"].append(tr.ranks_agree())
        metrics = {k: float(v) for k, v in m.items()}
        snap = {"params": {k: p.detach().cpu() for k, p in tr.model.named_parameters()},
                "mu": {k: v.cpu() for k, v in tr.optimizer.mu.items()}}
        if ref is None:
            snaps.append({"metrics": metrics, **snap})
            rep["steps"].append({"metrics": metrics})
            torch.save([x.detach().cpu() for x in state()], f"{saved}.state{i}")
            continue
        r = ref[i]
        if set(r["metrics"]) != set(metrics):
            raise AssertionError(f"[multi-gpu] stage 2 terms differ: {sorted(metrics)}")
        d = {"metrics_rel": max(abs(r["metrics"][k] - metrics[k]) / max(abs(r["metrics"][k]),
                                                                          1e-30)
                                for k in metrics)}
        d["mu_rel_to_max"] = max(float((r["mu"][k] - v).abs().max())
                                 / max(float(r["mu"][k].abs().max()), 1e-30)
                                 for k, v in snap["mu"].items())
        d["param_over_2lr"] = max(float((r["params"][k] - v).abs().max())
                                  / (2 * lr * lr_multiplier(k))
                                  for k, v in snap["params"].items())
        rep["steps"].append({"metrics": metrics, "diff": d})
    rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # the host's read of a global batch (every rank reads all of it) and the
    # flat all-reduce of the step's gradients
    rep["batch_ms"] = []
    for _ in range(3):
        t0 = time.perf_counter()
        tr._next_batch()
        torch.cuda.synchronize()
        rep["batch_ms"].append((time.perf_counter() - t0) * 1e3)
    params = list(tr.model.parameters())
    rep["grad_floats"] = int(sum(p.numel() for p in params))
    if mesh is not None:
        rep["allreduce_ms"] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sharding.all_reduce_grads_(params, mesh)
            torch.cuda.synchronize()
            rep["allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
    if ref is None:
        with open(saved, "wb") as f:
            pickle.dump(snaps, f)
    return rep


def mg_ranks(mesh, jobs):
    """The rank side of the [multi-gpu] phase: each (function name,
    arguments) of ``jobs`` in turn."""
    return [globals()[name](mesh, *args) for name, args in jobs]


def mg_nccl_world1(mesh, state_path):
    """One Stage-3 step with a world-size-1 NCCL group (``mesh``) and one
    without a group, each from the saved state and batch, in
    deterministic-algorithms mode (so that two runs of the same step are
    bitwise equal: index_add_ and cuBLAS pick their deterministic paths);
    and a second step without a group. Returns whether each is bitwise the
    first no-group step (metrics, surfel store with its statistics,
    deformer)."""
    import pickle

    import torch

    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer
    from vidu4d_tpu_torch.models.gaussian import surfels as sf

    torch.use_deterministic_algorithms(True, warn_only=True)
    with open(state_path, "rb") as f:
        st = pickle.load(f)
    dev = torch.device("cuda", torch.cuda.current_device())

    def step(group):
        tr = Stage3Trainer({**st["opts"], "ngpu": 1, "logname": "nccl1"}, dev, group=group)
        tr.deformer.load_state_dict(st["deformer"])
        n = len(sf.SurfelParams._fields)
        t = [x.to(dev) for x in st["surfels"]]
        tr.set_surfels(sf.SurfelState(
            sf.SurfelParams(*[p.clone().requires_grad_(True) for p in t[:n]]), *t[n:]))
        m = tr.train_step({k: v.to(dev) for k, v in st["batch"].items()})
        s = tr.surfels
        return ([m[k].cpu() for k in sorted(m)],
                [x.detach().cpu() for x in (*s.params, *s[1:], *tr.deformer.parameters())])

    base = step(None)
    same = lambda other: all(torch.equal(a, b) for x, y in zip(base, other)
                             for a, b in zip(x, y))
    return {"backend": mesh.backend, "world": mesh.world,
            "no_group_twice_bitwise": same(step(None)), "nccl_world1_bitwise": same(step(mesh))}


def multi_gpu_path(tmp):
    """[multi-gpu]: data parallelism over frame pairs on the one card.

    1. Stage 3 at the main path's width (MG_PAIRS pairs of the calibrated
       200k-surfel scene at 256^2, default configuration, the 2DGS terms in
       the last of MG_STEPS steps): one process, then 2 gloo ranks on
       cuda:0 (gloo's all_reduce and broadcast take CUDA tensors; NCCL
       refuses two ranks on one card), on one global batch, each step from
       the one process's state before it; each rank's metrics and state
       after each step against the one process's (MG_STEP), the three
       hooks fired once at the end against the one process's (MG_HOOKS),
       the ranks' checksums equal after each step and after the hooks, 1
       K1 and 1 K2 launch per step on each rank and no plain version; both
       kernels against their plain versions on rank 0's inputs, timed.
       Then the uneven case (MG_UNEVEN: 3 pairs over 2 ranks, every pair on
       both at weight 1/2) for 1 step.
    2. Stage 2 at the README recipe's width (S2_FLAGS: 256 pairs x 16
       pixels x 64 samples, 8 x 256 field) on make_fake_db(T=16) at 256^2:
       one process and 2 gloo ranks, MG_S2_STEPS steps from one state after
       MG_S2_SDF_ITERS SDF pretrain steps, each step from the one
       process's state before it (MG_S2_STEP).
    3. A world-size-1 NCCL group through the same code (`sharding.spawn`,
       `make_mesh`): one Stage-3 step of the uneven case's state, bitwise
       the step without a group.
    Returns (report, launches per rank of the Stage-3 steps)."""
    import torch

    from vidu4d_tpu_torch.parallel import sharding

    mg = os.path.join(tmp, "multi_gpu")
    os.makedirs(mg)
    rep = {}
    states = {}
    for name, (pairs, res, surfels) in (("main", (MG_PAIRS, MAIN_RES, MAIN_SURFELS)),
                                        ("uneven", MG_UNEVEN)):
        trainer, batch = build_trainer(os.path.join(mg, name), "cuda", surfels, res,
                                       frames=2 * pairs)
        states[name] = os.path.join(mg, f"{name}.pkl")
        mg_save_state(trainer, batch, states[name])
        del trainer, batch
        torch.cuda.empty_cache()
    s2_run = os.path.join(mg, "stage2")
    os.makedirs(s2_run)
    load_test_module("helpers").make_fake_db(s2_run, num_vids=1, T=S2_FRAMES, H=S2_RES,
                                             W=S2_RES)
    cwd = os.getcwd()
    os.chdir(s2_run)  # the trainers read database/ from the working directory
    try:
        mg_stage2_state(s2_run, S2_FLAGS, os.path.join(mg, "s2.pkl"))
        torch.cuda.empty_cache()
        # one process, twice: the second run against the first is how far the
        # step drifts from itself (index_add_'s atomics sum in any order, and
        # Adam moves a parameter by ~lr whatever the size of its gradient)
        s2_state = os.path.join(mg, "s2.pkl")
        one = {"main": mg_stage3_run(None, states["main"], MG_STEPS, hooks=True),
               "uneven": mg_stage3_run(None, states["uneven"], 1)}
        again = {"main": mg_stage3_run(None, states["main"], MG_STEPS, states["main"] + ".ref"),
                 "uneven": mg_stage3_run(None, states["uneven"], 1, states["uneven"] + ".ref")}
        torch.cuda.empty_cache()
        one["stage2"] = mg_stage2_run(None, s2_state)
        again["stage2"] = mg_stage2_run(None, s2_state, s2_state + ".ref")
        torch.cuda.empty_cache()
        # 2 ranks on cuda:0 over gloo
        t0 = time.perf_counter()
        jobs = [("mg_stage3_run", (states["main"], MG_STEPS, states["main"] + ".ref", True,
                                   True)),
                ("mg_stage3_run", (states["uneven"], 1, states["uneven"] + ".ref")),
                ("mg_stage2_run", (s2_state, s2_state + ".ref"))]
        ranks = sharding.spawn(mg_ranks, MG_RANKS, args=(jobs,), device="cuda:0",
                               backend="gloo")
        rep["ranks_wall_s"] = time.perf_counter() - t0
        # a world-size-1 NCCL group (cuBLAS's deterministic workspace is set
        # before the rank starts)
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        try:
            nccl = sharding.spawn(mg_nccl_world1, 1, args=(states["uneven"],), device="cuda:0",
                                  backend="nccl")[0]
        finally:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
    finally:
        os.chdir(cwd)

    counts, bad = {}, []
    for key, idx in (("main", 0), ("uneven", 1), ("stage2", 2)):
        r1 = one[key]
        drift = [st["diff"] for st in again[key]["steps"]]
        summary = {"one": {"step_ms_median": float(np.median(r1["step_ms"])),
                           "step_ms_p90": float(np.percentile(r1["step_ms"], 90)),
                           "step_ms": r1["step_ms"], "peak_gib": r1["peak_gib"],
                           **{k: r1[k] for k in ("hooks", "alive_after_hooks") if k in r1}},
                   "one_again_per_step": drift}
        bounds = MG_S2_STEP if key == "stage2" else MG_STEP
        for r, rr in enumerate(rank[idx] for rank in ranks):
            d = [st["diff"] for st in rr["steps"]]
            summary[f"rank{r}"] = {
                "step_ms_median": float(np.median(rr["step_ms"])),
                "step_ms_p90": float(np.percentile(rr["step_ms"], 90)),
                "step_ms": rr["step_ms"], "peak_gib": rr["peak_gib"], "agree": rr["agree"],
                "per_step": d}
            for k in ("batch_ms", "allreduce_ms", "grad_floats", "launches", "hooks",
                      "alive_after_hooks"):
                if k in rr:
                    summary[f"rank{r}"][k] = rr[k]
            if not all(rr["agree"]) or not rr.get("agree_after_hooks", True):
                bad.append(f"{key} rank {r}: the ranks' checksums differ: {rr['agree']}, "
                           f"after the hooks {rr.get('agree_after_hooks')}")
            # every step, each from the one process's state before it
            for i, di in enumerate(d):
                for k, bound in bounds.items():
                    if di[k] > bound:
                        bad.append(f"{key} rank {r} step {i}: {k} {di[k]} > {bound}")
            if "hooks_diff" in rr:
                summary[f"rank{r}"]["hooks_diff"] = rr["hooks_diff"]
                for k, bound in MG_HOOKS.items():
                    if rr["hooks_diff"][k] > bound:
                        bad.append(f"{key} rank {r} hooks: {k} {rr['hooks_diff'][k]} > {bound}")
            elif key == "main":
                bad.append(f"main rank {r}: the hooks were not compared with one process")
            if key != "stage2":
                c = rr["launches"]
                steps = len(rr["steps"])
                if (c["tile_forward"] != steps or c["tile_backward"] != steps
                        or c["tile_forward_plain"] or c["tile_backward_plain"]):
                    bad.append(f"{key} rank {r} launches {c}, expected {steps} of each kernel "
                               "and no plain version")
                if key == "main":
                    counts[r] = c
        rep[key] = summary
        log(f"[multi-gpu {key}] {json.dumps(summary)}")
    rep["kernel_check"] = ranks[0][0]["kernel_check"]
    rep["nccl_world1"] = nccl
    log(f"[multi-gpu nccl world 1] {json.dumps(nccl)}")
    if not nccl["nccl_world1_bitwise"]:
        bad.append(f"the world-size-1 NCCL step is not bitwise the step without a group: {nccl}")
    if bad:
        raise AssertionError("[multi-gpu] " + "; ".join(bad))
    return rep, counts


def c1_scene(rng, n, width, height, box=None):
    """[c1]'s splats: n small, distant splats (depth 20-40, 0.5-2 px
    across, opacity 0.3-0.9, so that the 2D filter's rho2d decides much of
    their response) whose centres fall in box = (x0, x1, y0, y1) of a width
    x height frame (default: the whole frame, 8 px in from its edges), seen
    by the identity camera at focal length `width`. Returns float64 numpy
    (means, quats, scales, opacities, colours, intrinsics (1, 4))."""
    x0, x1, y0, y1 = box or (8, width - 8, 8, height - 8)
    z = rng.uniform(20.0, 40.0, n)
    u, v = rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)
    f, cx, cy = float(width), width / 2.0, height / 2.0
    means = np.stack([(u - cx) * z / f, (v - cy) * z / f, z], -1)
    scales = rng.uniform(0.5, 2.0, (n, 2)) * z[:, None] / f
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(0.3, 0.9, n)
    colors = rng.uniform(size=(n, 3))
    return means, quats, scales, opac, colors, np.array([[f, f, cx, cy]])


def c1_project(scene, dtype, device, means=None):
    """A c1_scene's projection, (1, P) fields, in `dtype` on `device`
    (`means` replaces the scene's, e.g. a leaf that requires grad)."""
    import torch

    from vidu4d_tpu_torch.ops.rasterize import common

    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    m, quats, scales, _, _, intr = scene
    return common.project_splats(t(m)[None] if means is None else means[None],
                                 t(quats)[None], t(scales),
                                 torch.eye(4, dtype=dtype, device=device), t(intr))


def c1_gate(rng, width, height, n):
    """[c1]: K1 at width x height on n c1_scene splats against
    `reference.py` in float64 on the float64 projection (ROADMAP C1). The
    kernels evaluate rho2d in splat-centred coordinates, FIS ((cx - px)^2
    + (cy - py)^2); the Pallas kernel's polynomial in absolute pixel
    coordinates, FIS (px^2 + py^2) + E0 + px E1 + py E2, has float32 terms
    that reach FIS (width^2 + height^2). Over each splat's 9 x 9 pixels
    where the float64 value is < 10: the largest float32 error of rho2d in
    both forms (the polynomial on the float32 centres, as the slab held it
    before, and the kernels' form through `splat_response` on the slab),
    and of rho3d (the slab's A + px B + py C); the share of those pairs
    that the 2D branch decides. K1's alpha against the reference's: the
    largest error, the share of pixels beyond C1_ALPHA_TOL, of all and of
    covered ones (reference alpha > 1/255). The gated reference restricts
    each splat to the tiles that K1 binned it to (the rects of the float32
    projection): the radius is ceil(3 sigma) pixels, and float32 and
    float64 round it to different integers for a few splats, which moves
    a rect edge by a tile and cuts a splat's tail there at alpha ~0.01.
    Printed beside it, not gated: the splats whose rects differ and the
    largest alpha error against the reference on its own rects. Raises
    unless no pixel is beyond C1_ALPHA_TOL."""
    import torch

    from vidu4d_tpu_torch.ops.rasterize import common, reference
    from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf
    from vidu4d_tpu_torch.ops.rasterize.tile_backward import composite_batch, prepare_batch

    scene = c1_scene(rng, n, width, height)
    _, _, _, opac, colors, _ = scene
    p32, p64 = (c1_project(scene, dt, "cuda") for dt in (torch.float32, torch.float64))
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device="cuda")
    frame = lambda p: common.SplatProjection(*[x[0] for x in p])
    with torch.no_grad():
        prepared = prepare_batch(p32, t(colors, torch.float32)[None],
                                 t(opac, torch.float32), t(np.zeros(3), torch.float32),
                                 height, width)
        alpha_k = composite_batch(prepared, height, width).alpha[0].double()
        rects32, rects64 = (common.compute_tile_rects(frame(p), height, width, tf.TILE, 4)
                            for p in (p32, p64))
        alpha_ref, alpha_own = (reference.rasterize_naive_from_projection(
            frame(p64), t(colors, torch.float64), t(opac, torch.float64),
            torch.zeros(3, dtype=torch.float64, device="cuda"), height, width,
            pixel_chunk=C1_PIXEL_CHUNK, rects=r).alpha for r in (rects32, None))
        torch.cuda.synchronize()
        # each splat's 9 x 9 pixel centres, (P, 1, 81)
        off = torch.arange(-4, 5, device="cuda", dtype=torch.float64)
        c64 = p64.center2d[0]
        px = (torch.floor(c64[:, 0:1]) + 0.5 + off.repeat(9)[None, :])[:, None, :]
        py = (torch.floor(c64[:, 1:2]) + 0.5 + off.repeat_interleave(9)[None, :])[:, None, :]
        ids = torch.arange(n, device="cuda")

        def response(p, x, y):
            rows = tf.pack_props(frame(p), t(colors, p.tu.dtype), t(opac, p.tu.dtype),
                                 ids)[:, None, :]
            r = tf.splat_response(rows, x, y)
            return r["rho3d"], common.FILTER_INV_SQUARE * (r["dx"] ** 2 + r["dy"] ** 2)

        rho3d_64, rho2d_64 = response(p64, px, py)
        rho3d_32, rho2d_32 = response(p32, px.float(), py.float())
        cx, cy = p32.center2d[0, :, 0, None, None], p32.center2d[0, :, 1, None, None]
        pxf, pyf = px.float(), py.float()
        fis = common.FILTER_INV_SQUARE
        poly = (fis * (pxf * pxf + pyf * pyf) + fis * (cx * cx + cy * cy)
                + pxf * (-2.0 * fis * cx) + pyf * (-2.0 * fis * cy))
        valid = p64.valid[0][:, None, None]
        err = lambda x, exact: float(((x.double() - exact).abs()
                                      * ((exact < 10.0) & valid)).max())
        seen = (torch.minimum(rho3d_64, rho2d_64) < 10.0) & valid
        diff = (alpha_k - alpha_ref).abs()
        moved = sum(getattr(rects32, k) != getattr(rects64, k)
                    for k in ("min_x", "min_y", "span_x", "span_y")) > 0
        covered = alpha_ref > 1.0 / 255.0
        beyond = diff > C1_ALPHA_TOL
    out = {"width": width, "height": height, "splats": n, "valid": int(p64.valid.sum()),
           "max_rho2d_err_poly": err(poly, rho2d_64),
           "max_rho2d_err_centred": err(rho2d_32, rho2d_64),
           "max_rho3d_err": err(rho3d_32, rho3d_64),
           "share_pairs_2d_branch": float(((rho2d_64 < rho3d_64) & seen).sum()
                                          / max(int(seen.sum()), 1)),
           "max_alpha_err": float(diff.max()),
           "share_px_alpha_err_over_1_255": float(beyond.double().mean()),
           "covered_px": int(covered.sum()),
           "share_covered_px_over_1_255": float((beyond & covered).sum()
                                                / max(int(covered.sum()), 1)),
           "splats_rects_differ": int(moved.sum()),
           "max_alpha_err_own_rects": float((alpha_k - alpha_own).abs().max())}
    log(f"[c1 {width}x{height}] {json.dumps(out)}")
    if not all(np.isfinite(x) for x in out.values()):
        raise AssertionError(f"[c1] non-finite measurement: {out}")
    if out["max_alpha_err"] > C1_ALPHA_TOL or out["share_covered_px_over_1_255"] > 0:
        raise AssertionError(f"[c1 {width}x{height}] K1's alpha is more than 1/255 from "
                             f"the float64 reference: {out}")
    return out


def e2e_path(tmp, rng):
    """[e2e]: `examples.synthetic_e2e.main` on the card at E2E_FLAGS (GT
    video -> Stage 1 -> Stage 2 -> Stage 3 -> the reference render,
    scored), the launches counted from 0 and every Stage-2 and Stage-3
    step timed (host clock, synchronised); requires the metrics of the JAX
    main run's metrics.json, all finite, the foreground PSNR gate against
    an all-white frame, the mask IoU gate and the launch counts. Then both
    kernels against their plain versions on inputs kept from the run: GT
    frame 0, the last Stage-3 step (timed, with its pairs and bounds), the
    reference render (K2 on random cotangents). Returns (report, launch
    counts, the step's kernel check)."""
    import torch

    from vidu4d_tpu_torch import kernels
    from vidu4d_tpu_torch.engine import gs4d_trainer
    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer
    from vidu4d_tpu_torch.engine.trainer import Stage2Trainer
    from vidu4d_tpu_torch.examples import synthetic_e2e
    from vidu4d_tpu_torch.models.gaussian import deformable
    from vidu4d_tpu_torch.ops.rasterize import api

    sync = torch.cuda.synchronize
    kept, gt, step_ms, stage3 = {}, [], {"stage2": [], "stage3": []}, []

    def keep(fn, name, first_only):
        def run(prepared, *a, **kw):
            if not (first_only and name in kept):
                kept[name] = {k: prepared[k].detach().clone() if torch.is_tensor(prepared[k])
                              else prepared[k] for k in KERNEL_INPUTS}
            return fn(prepared, *a, **kw)
        return run

    def timed(fn, key):
        def run(self, *a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            sync()
            step_ms[key].append((time.perf_counter() - t0) * 1e3)
            if key == "stage3" and not stage3:
                stage3.append(self)
            return out
        return run

    def gt_video(fn):
        def run(*a, **kw):
            gt.append(fn(*a, **kw))
            return gt[-1]
        return run

    # the eval renders and the reference render go through deformable's
    # composite_batch; the last one kept is the reference render
    wraps = {(api, "composite_batch"): lambda f: keep(f, "GT frame 0", True),
             (gs4d_trainer, "composite_batch"): lambda f: keep(f, "last Stage-3 step", False),
             (deformable, "composite_batch"): lambda f: keep(f, "reference render", False),
             (synthetic_e2e, "make_gt_video"): gt_video,
             (Stage2Trainer, "train_step"): lambda f: timed(f, "stage2"),
             (Stage3Trainer, "train_step"): lambda f: timed(f, "stage3")}
    originals = {key: getattr(*key) for key in wraps}
    out_dir = os.path.join(tmp, "e2e")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        for (obj, k), wrap in wraps.items():
            setattr(obj, k, wrap(originals[obj, k]))
        res = synthetic_e2e.main(E2E_FLAGS + ["--out", out_dir, "--device", "cuda"])
    finally:
        for (obj, k), fn in originals.items():
            setattr(obj, k, fn)
    wall = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)
    with open(os.path.join(out_dir, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "results",
                           "metrics.json")) as f:
        jax_keys = set(json.load(f))
    arg = lambda name: int(E2E_FLAGS[E2E_FLAGS.index(name) + 1])
    frames, rounds = arg("--frames"), arg("--s3_rounds")
    n_eval = min(frames - 1, 8)
    gt_rgb, gt_masks, gt_depth = gt[0]
    white = synthetic_e2e.score_renders(
        {"rendered": np.ones_like(gt_rgb[:n_eval]), "mask": np.zeros_like(gt_rgb[:n_eval, ..., :1]),
         "depth": np.zeros_like(gt_rgb[:n_eval, ..., :1])}, gt_rgb[:n_eval], gt_masks, gt_depth)
    steps = {k: len(v) for k, v in step_ms.items()}
    rep = {"wall_s": wall, "flags": E2E_FLAGS,
           **{k: metrics[k] for k in ("stage1_s", "stage2_s", "stage3_s", "total_s")},
           "stage2_round_s": res["stage2_round_s"], "stage3_round_s": res["stage3_round_s"],
           "steps": steps,
           **{f"{k}_step_ms_median": float(np.median(v)) for k, v in step_ms.items() if v},
           **{f"{k}_step_ms_p90": float(np.percentile(v, 90)) for k, v in step_ms.items() if v},
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "learned_bg": stage3[0].deformer.background().tolist(),
           "white_frame_psnr": white["render_psnr_mean"],
           "white_frame_psnr_fg": white["render_psnr_fg_mean"], "counts": counts,
           **{k: v for k, v in metrics.items() if k.startswith("render_")}}
    log(f"[e2e] {json.dumps(rep)}")
    want = {"tile_forward": frames + steps["stage3"] + rounds + 1,
            "tile_backward": steps["stage3"], "tile_forward_plain": 0, "tile_backward_plain": 0}
    numbers = [x for k, v in metrics.items() if k != "config"
               for x in (v if isinstance(v, list) else [v])]
    problems = []
    if not jax_keys <= set(metrics):
        problems.append(f"metrics.json lacks {sorted(jax_keys - set(metrics))}")
    if not all(np.isfinite(x) for x in numbers):
        problems.append("a non-finite metric")
    if steps["stage3"] != arg("--s3_rounds") * arg("--s3_iters") or \
            steps["stage2"] != arg("--s2_rounds") * arg("--s2_iters"):
        problems.append(f"steps {steps}")
    if counts != want:
        problems.append(f"launch counts {counts}, expected {want}")
    if not metrics["render_psnr_fg_mean"] >= white["render_psnr_fg_mean"] + E2E_PSNR_MARGIN:
        problems.append(f"foreground PSNR {metrics['render_psnr_fg_mean']} < the white "
                        f"frame's {white['render_psnr_fg_mean']:.3f} + {E2E_PSNR_MARGIN}")
    if not metrics["render_mask_iou"] >= E2E_MIN_IOU:
        problems.append(f"mask IoU {metrics['render_mask_iou']} < {E2E_MIN_IOU}")
    # the kernels against their plain versions on the run's own inputs
    # (after the counts are read: these launches are not the path's)
    checks = {}
    for name in ("GT frame 0", "last Stage-3 step", "reference render"):
        if name not in kept:
            problems.append(f"no kernel inputs kept for {name}")
            continue
        b = kept.pop(name)
        checks[name] = compare_kernels(b, rng, f"e2e: {name}",
                                       timed=name == "last Stage-3 step")
        checks[name]["frames"] = b["tile_start"].shape[0] // b["tiles_per_frame"]
        checks[name]["n_extra"] = b["n_extra"]
    shapes = {k: (c["frames"], c["n_extra"]) for k, c in checks.items()}
    if shapes != {"GT frame 0": (1, 0), "last Stage-3 step": (2, 2),
                  "reference render": (n_eval, 0)}:
        problems.append(f"kernel checks' (frames, extra channels) {shapes}")
    if problems:
        raise AssertionError(f"[e2e] {problems}")
    rep["kernel_checks"] = {k: {x: c[x] for x in ("fwd_max_abs_err", "bwd_max_abs_err",
                                                   "entries", "max_tile")}
                            for k, c in checks.items()}
    torch.cuda.empty_cache()
    return rep, counts, checks["last Stage-3 step"]


def depth_eval_path(tmp):
    """[depth eval]: `preprocess.eval_depthnet.main` on the shipped weights
    (DE_DEPTHNET) and `preprocess.eval_depth_registration.main`
    (DE_REGISTRATION) on the card: every number finite, K1 launched once
    per rendered scene and frame, nothing else. Returns (report, launch
    counts)."""
    import torch

    from vidu4d_tpu_torch import kernels
    from vidu4d_tpu_torch.preprocess import eval_depth_registration, eval_depthnet
    from vidu4d_tpu_torch.preprocess.layers import WEIGHTS_DIR

    kernels.reset_counts()
    t0 = time.perf_counter()
    dn = eval_depthnet.main(["--weights", os.path.join(WEIGHTS_DIR, ST_SHIPPED["depthnet"]),
                             *DE_DEPTHNET, "--device", "cuda"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reg = eval_depth_registration.main([*DE_REGISTRATION, "--out",
                                        os.path.join(tmp, "registration.json"),
                                        "--device", "cuda"])
    t2 = time.perf_counter()
    counts = dict(kernels.COUNTS)
    arg = lambda flags, name: int(flags[flags.index(name) + 1])
    scenes = arg(DE_DEPTHNET, "--batch") * arg(DE_DEPTHNET, "--rounds")
    want = {"tile_forward": scenes + arg(DE_REGISTRATION, "--frames"), "tile_backward": 0,
            "tile_forward_plain": 0, "tile_backward_plain": 0}
    rep = {"eval_depthnet": dn, "eval_depth_registration": reg,
           "eval_depthnet_s": t1 - t0, "eval_depth_registration_s": t2 - t1, "counts": counts}
    log(f"[depth eval] {json.dumps(rep)}")
    numbers = list(dn.values()) + [v for errs in reg.values() for v in errs.values()]
    if counts != want or not all(np.isfinite(x) for x in numbers):
        raise AssertionError(f"[depth eval] launch counts {counts} (expected {want}) or a "
                             f"non-finite number: {rep}")
    return rep, counts

def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs "
                         "only on a machine with an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vidu4d_tpu_torch import kernels
    from vidu4d_tpu_torch.ops.rasterize import tile_backward as tb
    from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf

    # float32 matmuls in full precision (the default), stated explicitly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_name_and_power()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    info = kernels.build()
    log(f"[build] {info['path']} in {info['seconds']:.1f} s (cached={info['cached']})")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[ptxas] {line.strip()}")
    tf.tile_library()

    rng = np.random.default_rng(1234)
    deep_cmp = kernel_cases(rng)[DEEP]

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        small_step_vs_cpu(tmp, use_2dgs_reg=False)
        small_step_vs_cpu(tmp, use_2dgs_reg=True)

        t0 = time.perf_counter()
        trainer, batch = build_trainer(os.path.join(tmp, "main"), "cuda", MAIN_SURFELS,
                                       MAIN_RES)
        torch.cuda.synchronize()
        log(f"[setup] trainer + calibrated scene in {time.perf_counter() - t0:.1f} s")
        # the kernels' inputs of the main path's first step
        with torch.no_grad():
            main_batch, _ = trainer.render_inputs(batch)
        diag = scene_diag(main_batch)
        log(f"[scene] {json.dumps(diag)} entry_cap {trainer.raster_cfg.entry_cap} "
            f"n_extra {main_batch['n_extra']}")
        if min(diag["valid"]) < 0.5 * MAIN_SURFELS:
            raise AssertionError(f"degenerate scene, < 50% surfels valid: {diag}")
        if main_batch["n_extra"] != 2:
            raise AssertionError(f"the main path renders {main_batch['n_extra']} extra "
                                 "channels, expected the 2 flow channels")

        # the kernels at the main path's shapes: check and time; the tile
        # depths, the work list, the pairs these inputs need, the bounds
        main_cmp = compare_kernels(main_batch, rng, "main path 200k 256x256 2 frames X=2",
                                   timed=True)
        bounds = main_cmp["bounds"]
        log(f"[tiles main] {json.dumps(tile_histogram(main_batch['tile_count']))}")
        log(f"[pairs main] {json.dumps(main_cmp['pairs'])}")
        _, aux_plain = tf.forward_tiles_plain(
            main_batch["slab"], main_batch["tile_start"], main_batch["tile_count"],
            main_batch["bg"], main_batch["tiles_x"], main_batch["tiles_per_frame"],
            main_batch["n_extra"])
        work_list_report(main_batch["tile_count"], main_batch["slab"].shape[0], "main fwd")
        work_list_report(tb.effective_counts(main_batch["tile_count"], aux_plain[..., 8:12]),
                         main_batch["slab"].shape[0], "main bwd")
        log(f"[bounds main] {json.dumps(bounds)}")
        del main_batch, aux_plain

        # [tile]: the kernels at tile 8 and 32 on this workload, and a small
        # step at each side on the card against the CPU
        t0 = time.perf_counter()
        tile_rep = tile_path(tmp, rng, trainer, batch)
        log(f"[tile wall] {time.perf_counter() - t0:.1f} s")

        # the main path, default configuration
        before = {k: p.detach().clone() for k, p in trainer.deformer.named_parameters()}
        warm, timed, reg = MAIN_STEPS
        step_ms, counts, last = run_steps(
            trainer, batch, [(warm, False, False), (timed, False, True), (reg, True, False)],
            "main")
        for m, terms in ((last[1], DEFAULT_TERMS), (last[2], DEFAULT_TERMS | REG_2DGS_TERMS)):
            if not terms <= set(m):
                raise AssertionError(f"missing loss terms {sorted(terms - set(m))}: {m}")
        moved = [k for k, p in trainer.deformer.named_parameters()
                 if not torch.equal(p.detach(), before[k])]
        log(f"[adamw] {len(moved)} of {len(before)} deformer parameters moved in "
            f"{trainer.warp_opt.count} updates; unmoved: "
            f"{sorted(set(before) - set(moved))}")
        if trainer.warp_opt.count != sum(MAIN_STEPS) or len(moved) < 0.9 * len(before):
            raise AssertionError("the warp AdamW did not update the deformer")
        main_ms = float(np.median(step_ms))
        del trainer, batch
        torch.cuda.empty_cache()

        # the reduced configuration at the same width, smaller depth
        trainer, batch = build_trainer(os.path.join(tmp, "reduced"), "cuda",
                                       MAIN_SURFELS, MAIN_RES, reduced=True)
        warm, timed = REDUCED_STEPS
        red_ms, _, red_last = run_steps(
            trainer, batch, [(warm, False, False), (timed, False, True)], "reduced")
        if not {"rgb", "depth", "mask"} <= set(red_last[-1]) or "flow" in red_last[-1]:
            raise AssertionError(f"reduced path loss terms: {sorted(red_last[-1])}")
        del trainer, batch
        torch.cuda.empty_cache()

        # the round loop at the JAX default capacity
        hooks_cpu_vs_gpu(rng)
        round_rep, round_counts = round_path(tmp, rng, MAIN_SURFELS, ROUND_CAPACITY,
                                             MAIN_RES)
        torch.cuda.empty_cache()

        # the command line: train / render / export / reanimate from a
        # Stage-2 output; then both kernels on the 512^2 ref render's own
        # inputs (K2 with random cotangents)
        cli_rep, cli_counts, ref_inputs = cli_path(tmp, rng)
        render512 = compare_kernels(frames_of(ref_inputs, CLI_CHECK_FRAMES), rng,
                                    f"cli ref render {CLI_RENDER_RES}^2", reps_p=1,
                                    timed=True)
        del ref_inputs
        torch.cuda.empty_cache()

        # the static 2DGS path: a small step on the card vs the CPU, then
        # gs_static at 1237 x 822
        static_small_vs_cpu(rng)
        torch.cuda.reset_peak_memory_stats()
        static_rep, static_counts, static_cmp = static_path(tmp, rng)
        torch.cuda.empty_cache()

        # Stage 2: a small float64 step on the card vs the CPU (bob, then
        # every other motion and field type from its pretrained fields), the
        # other Stage-3 motions' small steps, then the README recipe at full
        # width, its render and the hand-off to Stage 3
        s2_init = stage2_small_vs_cpu(tmp)
        for fg_motion, field_type in S2_MOTIONS:
            stage2_small_vs_cpu(tmp, fg_motion, field_type, steps=1, init=s2_init)
        s3_motion_counts = {m: small_step_vs_cpu(tmp, False, m) for m in S3_MOTION_NO_TERMS}
        s2_rep, s2_counts, handoff_counts, _ = stage2_path(tmp)
        torch.cuda.empty_cache()

        # [stage2-comp-skel]: comp + skel-quad Stage 2 at full width, its
        # render and export, the gs-skel-quad hand-off and its reanimation
        s2c_rep, s2c_counts, s2c_handoff, s2c_reanimate = stage2_path(
            tmp, S2C_FLAGS, S2C_ROUNDS, S2C_TERMS, "stage2-comp-skel", "gs-skel-quad", True)
        torch.cuda.empty_cache()

        # [stage1]: the card vs the CPU on a small clip; then a 720p video
        # through Stage 1, Stage 2 on its database and the gs-bob hand-off
        t0 = time.perf_counter()
        stage1_small_vs_cpu(tmp)
        s1_rep, s1_counts, s1_s2_counts, s1_handoff = stage1_path(tmp)
        log(f"[stage1 wall] {time.perf_counter() - t0:.1f} s")

        # [stage1-train]: the three Stage-1 trainers at their default sizes
        t0 = time.perf_counter()
        st_rep, st_counts, st_check = stage1_train_path(tmp, rng)
        log(f"[stage1-train wall] {time.perf_counter() - t0:.1f} s")

        # [multi-inst]: two clips -> one database -> Stage 2 --nosingle_inst
        # -> render / export of video 1 -> the Stage-3 hand-off
        t0 = time.perf_counter()
        mi_rep, mi_counts, mi_handoff = multi_inst_path(tmp)
        log(f"[multi-inst wall] {time.perf_counter() - t0:.1f} s")

        # [multi-gpu]: data parallelism over frame pairs, 2 ranks on the card
        # against one process; a world-size-1 NCCL group
        t0 = time.perf_counter()
        mg_rep, mg_counts = multi_gpu_path(tmp)
        log(f"[multi-gpu wall] {time.perf_counter() - t0:.1f} s")
        # [c1]: K1 against exact math on small, distant splats
        t0 = time.perf_counter()
        c1_reps = [c1_gate(rng, w, h, n) for w, h, n in C1_RUNS]
        log(f"[c1 wall] {time.perf_counter() - t0:.1f} s")
        # [e2e]: GT video -> Stage 1 -> 2 -> 3 -> render, scored; then the
        # two depth scorers
        t0 = time.perf_counter()
        e2e_rep, e2e_counts, e2e_check = e2e_path(tmp, rng)
        log(f"[e2e wall] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        de_rep, de_counts = depth_eval_path(tmp)
        log(f"[depth eval wall] {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # no single PyTorch call composites depth-sorted splats per tile with an
    # early stop and a median, or differentiates that: library_ms is null
    result = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"vidu4d_tpu_torch/csrc/{name}.cu", "replaces": replaces,
         "launches": counts[name], "max_abs_err": main_cmp[f"{key}_max_abs_err"],
         "ms": main_cmp[f"{key}_ms"], "plain_ms": main_cmp[f"{key}_plain_ms"],
         "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
         "library_ms": None, "deep_chain_ms": deep_cmp[f"{key}_ms"],
         "round_launches": round_counts[name],
         "round_max_abs_err": max(c[f"{key}_max_abs_err"]
                                  for c in round_rep["kernel_checks"].values()),
         "eval_render_launches": round_rep["eval_render_k1"] if key == "fwd" else 0,
         "cli_launches": cli_counts[name],
         # on frames CLI_CHECK_FRAMES of the CLI's 512^2 ref render
         "render512_max_abs_err": render512[f"{key}_max_abs_err"],
         "render512_ms": render512[f"{key}_ms"],
         "render512_plain_ms": render512[f"{key}_plain_ms"],
         "render512_bound_ms": render512["bounds"][name]["bound_ms"],
         # gs_static at 1237 x 822: launches of gs_static.main; the check
         # and times on the inputs of a full-SH step
         "static_launches": static_counts[name],
         "static_max_abs_err": static_cmp[f"{key}_max_abs_err"],
         "static_ms": static_cmp[f"{key}_ms"], "static_plain_ms": static_cmp[f"{key}_plain_ms"],
         "static_bound_ms": static_cmp["bounds"][name]["bound_ms"],
         # Stage 2 runs no tile kernel; its hand-off to Stage 3 does
         "stage2_launches": s2_counts[name], "handoff_launches": handoff_counts[name],
         # comp + skel-quad Stage 2, its gs-skel-quad hand-off and reanimation
         "stage2_comp_skel_launches": s2c_counts[name],
         "handoff_skel_launches": s2c_handoff[name],
         "reanimate_skel_launches": s2c_reanimate[name],
         # one small card step of each other Stage-3 motion
         "s3_motion_launches": {m: c[name] for m, c in s3_motion_counts.items()},
         # Stage 1 (preprocess_video on the 720p video) runs no tile kernel;
         # Stage 2 on its database neither, the hand-off to Stage 3 both
         "stage1_launches": s1_counts[name], "stage1_stage2_launches": s1_s2_counts[name],
         "stage1_handoff_launches": s1_handoff[name],
         # the three Stage-1 trainers (DepthNet's make_scene renders: K1
         # only); the kernels on one make_scene render's inputs
         "stage1_train_launches": st_counts[name],
         "stage1_train_max_abs_err": st_check[f"{key}_max_abs_err"],
         "stage1_train_ms": st_check[f"{key}_ms"],
         "stage1_train_plain_ms": st_check[f"{key}_plain_ms"],
         "stage1_train_bound_ms": st_check["bounds"][name]["bound_ms"],
         # Stage 2 --nosingle_inst on the 2-video database, its hand-off
         "multi_inst_launches": mi_counts[name], "multi_inst_handoff_launches": mi_handoff[name],
         # [multi-gpu]: each rank's launches in the Stage-3 steps; both
         # kernels against their plain versions on rank 0's inputs
         "multi_gpu_launches": [c[name] for _, c in sorted(mg_counts.items())],
         "multi_gpu_max_abs_err": mg_rep["kernel_check"][f"{key}_max_abs_err"],
         "multi_gpu_ms": mg_rep["kernel_check"][f"{key}_ms"],
         "multi_gpu_plain_ms": mg_rep["kernel_check"][f"{key}_plain_ms"],
         "multi_gpu_bound_ms": mg_rep["kernel_check"]["bounds"][name]["bound_ms"],
         # [e2e]: the launches of the whole run (K1: GT frames, steps, eval
         # and reference renders; K2: steps); both kernels against their
         # plain versions on the last Stage-3 step's inputs
         "e2e_launches": e2e_counts[name],
         "e2e_max_abs_err": e2e_check[f"{key}_max_abs_err"],
         "e2e_ms": e2e_check[f"{key}_ms"], "e2e_plain_ms": e2e_check[f"{key}_plain_ms"],
         "e2e_bound_ms": e2e_check["bounds"][name]["bound_ms"],
         # [depth eval]: DepthNet's scenes and the registration's frames
         "depth_eval_launches": de_counts[name],
         # [tile]: each side's small card step's launches; both kernels
         # against their plain versions on the main workload binned at it
         **{f"tile{side}_{k}": v for side, (cmp, cnt) in tile_rep.items()
            for k, v in (("launches", cnt[name]),
                         ("max_abs_err", cmp[f"{key}_max_abs_err"]),
                         ("ms", cmp[f"{key}_ms"]), ("plain_ms", cmp[f"{key}_plain_ms"]),
                         ("bound_ms", cmp["bounds"][name]["bound_ms"]),
                         ("bound_by", cmp["bounds"][name]["bound_by"]))}}
        for name, key, replaces in (
            ("tile_forward", "fwd", "vidu4d_tpu/ops/rasterize/pallas_kernel.py:111"),
            ("tile_backward", "bwd", "vidu4d_tpu/ops/rasterize/pallas_backward.py:95"))
    ]}
    log(f"[summary] {card}: median step {main_ms:.3f} ms (default configuration), "
        f"{float(np.median(red_ms)):.3f} ms (reduced); "
        f"tile_forward {main_cmp['fwd_ms']:.3f} ms (plain {main_cmp['fwd_plain_ms']:.3f}); "
        f"tile_backward {main_cmp['bwd_ms']:.3f} ms (plain {main_cmp['bwd_plain_ms']:.3f}); "
        + "".join(f"at tile {side}: K1 {c['fwd_ms']:.3f} ms (plain {c['fwd_plain_ms']:.3f}), "
                  f"K2 {c['bwd_ms']:.3f} ms (plain {c['bwd_plain_ms']:.3f}); "
                  for side, (c, _) in tile_rep.items())
        + f"round path at capacity {ROUND_CAPACITY}: median step "
        f"{round_rep['step_ms_median']:.3f} ms, rounds {round_rep['round_wall_ms']} ms "
        f"+ {round_rep['k3_round_ms']} ms; command line: train {cli_rep['train_ms']:.1f} ms "
        f"(median step {cli_rep['step_ms_median']:.3f} ms), render {CLI_RENDER_RES}^2 "
        f"{cli_rep['render_rot_ms']:.1f} / {cli_rep['render_ref_ms']:.1f} ms, export "
        f"{cli_rep['export_ms']:.1f} ms, reanimate {cli_rep['reanimate_ms']:.1f} ms; "
        f"at {CLI_RENDER_RES}^2 K1 {render512['fwd_ms']:.3f} ms "
        f"(plain {render512['fwd_plain_ms']:.3f}, "
        f"bound {render512['bounds']['tile_forward']['bound_ms']:.4f}), "
        f"K2 {render512['bwd_ms']:.3f} ms (plain {render512['bwd_plain_ms']:.3f}, "
        f"bound {render512['bounds']['tile_backward']['bound_ms']:.4f}); "
        f"static {STATIC_W}x{STATIC_H}: median step {static_rep['step_ms_median']:.3f} ms "
        f"(full SH {static_rep['full_sh_step_ms_median']:.3f}), eval PSNR "
        f"{static_rep['eval_psnr']:.3f} dB (init {static_rep['init_psnr']:.3f}), eval "
        f"{static_rep['eval_ms']:.1f} ms, extract {static_rep['extract_ms']:.1f} ms, "
        f"K1 {static_cmp['fwd_ms']:.3f} ms (plain {static_cmp['fwd_plain_ms']:.3f}, bound "
        f"{static_cmp['bounds']['tile_forward']['bound_ms']:.4f}), K2 "
        f"{static_cmp['bwd_ms']:.3f} ms (plain {static_cmp['bwd_plain_ms']:.3f}, bound "
        f"{static_cmp['bounds']['tile_backward']['bound_ms']:.4f}); stage 2 "
        f"({s2_rep['samples_per_step']} samples/step): mlp_init {s2_rep['mlp_init_s']:.1f} s, "
        f"median step {s2_rep['step_ms_median']:.3f} ms (p90 {s2_rep['step_ms_p90']:.3f}), "
        f"peak {s2_rep['peak_gib']:.2f} GiB, render {S2_RENDER_RES}^2 x {S2_RENDER_FRAMES} "
        f"{s2_rep['render_s']:.1f} s, hand-off {s2_rep['handoff_s']:.1f} s; stage 2 comp + "
        f"skel-quad ({s2c_rep['samples_per_step']} samples/step per field): mlp_init "
        f"{s2c_rep['mlp_init_s']:.1f} s, median step {s2c_rep['step_ms_median']:.3f} ms (p90 "
        f"{s2c_rep['step_ms_p90']:.3f}), peak {s2c_rep['peak_gib']:.2f} GiB, render "
        f"{s2c_rep['render_s']:.1f} s, export {s2c_rep['export_s']:.1f} s, gs-skel-quad "
        f"hand-off {s2c_rep['handoff_s']:.1f} s, reanimate {s2c_rep['reanimate_s']:.1f} s; "
        f"stage 1 ({S1_FRAMES} x {S1_RES[0]}x{S1_RES[1]}, seed {s1_rep['seed']}): "
        f"preprocess_video {s1_rep['seconds']['total']:.1f} s (segment "
        f"{s1_rep['seconds']['segment']:.1f}, canonical {s1_rep['seconds']['canonical']:.1f}), "
        f"peak {s1_rep['peak_gib']:.2f} GiB, mask IoU {s1_rep['mask_iou'][1]:.3f}, depth rank "
        f"corr {s1_rep['depth_rank_corr'][1]:.3f}; its Stage 2: mlp_init "
        f"{s1_rep['stage2']['mlp_init_s']:.1f} s, median step "
        f"{s1_rep['stage2']['step_ms_median']:.3f} ms, hand-off "
        f"{s1_rep['stage2']['handoff_s']:.1f} s; stage-1 training at {ST_RES}^2: step "
        f"{st_rep['raft']['step_ms_median']:.3f} / {st_rep['featnet']['step_ms_median']:.3f} / "
        f"{st_rep['depthnet']['step_ms_median']:.3f} ms (raft / featnet / depthnet), "
        f"{st_rep['depthnet']['render_ms_median']:.3f} ms per scene, held-out EPE "
        f"{st_rep['raft']['epe_raft']:.3f} px (lk {st_rep['raft']['epe_lk']:.3f}), match acc "
        f"{st_rep['featnet']['match_acc_featnet']:.3f} (hog "
        f"{st_rep['featnet']['match_acc_hog']:.3f}), order acc "
        f"{st_rep['depthnet']['order_acc']:.3f} (flow parallax "
        f"{st_rep['depthnet']['flow_parallax_order_acc']:.3f}); multi-inst (2 x {MI_FRAMES} "
        f"frames): preprocess {mi_rep['clips'][0]['preprocess_s']:.1f} + "
        f"{mi_rep['clips'][1]['preprocess_s']:.1f} s, mlp_init {mi_rep['mlp_init_s']:.1f} s, "
        f"median step {mi_rep['step_ms_median']:.3f} ms (p90 {mi_rep['step_ms_p90']:.3f}), "
        f"peak {mi_rep['peak_gib']:.2f} GiB, hand-off {mi_rep['handoff_s']:.1f} s; multi-gpu "
        f"(2 gloo ranks on one card): stage 3 step {mg_rep['main']['one']['step_ms_median']:.3f}"
        f" ms one process, {mg_rep['main']['rank0']['step_ms_median']:.3f} / "
        f"{mg_rep['main']['rank1']['step_ms_median']:.3f} ms per rank, gradient all-reduce "
        f"{float(np.median(mg_rep['main']['rank0']['allreduce_ms'])):.3f} ms; stage 2 step "
        f"{mg_rep['stage2']['one']['step_ms_median']:.3f} ms one process, "
        f"{mg_rep['stage2']['rank0']['step_ms_median']:.3f} ms per rank; c1: "
        + ", ".join(f"{c['width']}x{c['height']} max alpha err {c['max_alpha_err']:.3g}, "
                    f"rho2d err {c['max_rho2d_err_centred']:.3g} (polynomial "
                    f"{c['max_rho2d_err_poly']:.3g}), rho3d err {c['max_rho3d_err']:.3g}"
                    for c in c1_reps) + "; "
        f"e2e ({' '.join(E2E_FLAGS)}): {e2e_rep['wall_s']:.1f} s (stage 1 "
        f"{e2e_rep['stage1_s']} s, stage 2 {e2e_rep['stage2_s']} s, stage 3 "
        f"{e2e_rep['stage3_s']} s), steps {e2e_rep['stage2_step_ms_median']:.3f} / "
        f"{e2e_rep['stage3_step_ms_median']:.3f} ms (stage 2 / 3), PSNR "
        f"{e2e_rep['render_psnr_mean']} dB (white frame {e2e_rep['white_frame_psnr']:.3f}), "
        f"foreground {e2e_rep['render_psnr_fg_mean']} dB (white "
        f"{e2e_rep['white_frame_psnr_fg']:.3f}), mask IoU {e2e_rep['render_mask_iou']}; "
        f"depth eval: order acc "
        f"{de_rep['eval_depthnet']['order_acc']:.3f} (flow parallax "
        f"{de_rep['eval_depthnet']['flow_parallax_order_acc']:.3f}), pair rotation error "
        f"{de_rep['eval_depth_registration']['depthnet']['pair_rot_err_deg_mean']} deg "
        f"(GT depth {de_rep['eval_depth_registration']['gt_depth']['pair_rot_err_deg_mean']})")
    log(f"[wall] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
