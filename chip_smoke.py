#!/usr/bin/env python
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--profile DIR]

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from joint_tensorf_tpu_torch/csrc (one nvcc per
   source, in parallel) and prints the build time;
3. holds each kernel against its plain PyTorch version at the shapes of
   the training step (compositor K1/K2 with saturated rays included, K2
   without g_weights as the dense appearance path calls it and with them,
   as the two-stage appearance does; the row scatter K3 also at a
   160k-row destination), and times the kernel (back to back, and K1/K2's
   device time from torch.profiler), the plain version and, where one
   exists, the one PyTorch call that computes the same function (K3:
   index_add_);
4. holds K6 (the summed density sample, forward and backward) and K7
   (the concatenated appearance sample) against their plain versions at
   the masked cell's shape and times them; holds
   K4 (the tile-binned plane-gradient scatter) and K5 (the
   block-local row scatter) against their plain versions at the JAX
   bench scripts' shapes (K4 also at a 400x400 plane with 2.03M samples in
   march order and with every sample in one cell, exactly; K5 also with
   every sample in one row, and with int32 indices), and times them (the
   route back to back and its kernels' device time by torch.profiler, and
   the accumulate kernel alone), their plain versions, the library calls
   (K4: grid_sample's plane gradient; K5: index_add_) and K3 at K5's
   shapes; both routes run under torch's sync debug mode "error" (which
   sees the torch calls of their glue, not the ctypes launches);
5. runs one small train step on the card and on the CPU (plain versions)
   from the same state and compares loss and gradients (and a small L2G
   step and a small NDC step: loss, gradients, error map, registered
   poses, check_small_l2g_ndc): on the dense path,
   with in-bbox compaction, the dense-grid density and app_k below the
   gated count under the blur, with an alpha mask, group compaction and
   app_k, as TensoRF's step (no pose optimisation: the pose gradient
   exactly zero), with bfloat16 factors, with the dense grid's rows
   read in bfloat16, and on the dense path with soft edge masks; and
   renders 3 views of the solids scene on the card
   and on the CPU (within 1e-5);
6. drives K4 and K5 through their own entry points (sample_plane_binned
   forward + backward, scatter_add_rows_tiled), counters zeroed just
   before and read just after each: each must launch once;
7. trains BAT's first phase at full width (configs/bat_blender_VM.yaml on
   the procedural scene: 400x400, 12 views, 2028 rays x 221 samples, VM
   ranks 16/48) for 20 iterations through Trainer.run on the default
   tpu: path (the dense grid allowed, two-stage appearance, the in-bbox
   budget), with the launch counters zeroed just before and read just
   after: every step must launch what its configuration calls for
   (expected_launches: K1 = 1, K2 = 1, K3 = 0, K6 once each way for the
   density, since the allowed grid is built only where K6 does not apply,
   and K7 once each way for the appearance);
   then K3 at that path's shapes (the appearance planes and the longest
   appearance line) and at a 3-D grid's rows of that resolution (as CP's
   or bf16 rows' dense grid gathers them);
8. trains BAT at full width through every phase, with the schedule cut to
   40 iterations (PHASES_ARGS: upsamples after iterations 2, 4, 6, 8,
   mask updates after 7 and 14): 64^3 -> 101^3 -> 160^3 -> 252^3, the
   uncapped mask and bbox shrink, the 64M-voxel grid in the shrunk box,
   the capped mask, S up to 1000; twice: on the default tpu: path, and
   with the alternatives off (ALTERNATIVES_OFF: the slices before this
   one's path, except that the alpha mask's own budget compacts, as it
   does in the JAX trainer).  A fresh field's density stays below the
   alpha threshold for far longer than such a schedule runs (its mask
   keeps nothing after 7 iterations and spans the whole box after 40), so
   the density factors start raised over the cores of the scene's blobs
   (warm_start_density; sparser than a trained field, so the gaps between
   the paths hold for this field only).  Checks every transition, every
   step's launches against its configuration, finite losses, that the
   mask culls samples once the blur is off, and on the default path that
   the masked last phase compacts (compact_k < S) and the blurred phases
   allow the dense grid; prints each transition and one line per phase
   (budgets, the step's choices, kept and live fractions, launches,
   median step) and the peak memory; on the default path K6 and K7
   against their plain versions at each phase's own shape (rays, kept
   slots, app_k, resolution up to 252^3, live share;
   check_density_at_phases, check_app_at_phases); with
   --profile, two blurred steps at the 64M-voxel grid and the last 3
   steps of the default path run under torch.profiler;
9. holds K1/K2/K3 against their plain versions again at the shapes of
   each path's last phase (the compacted samples, the density and
   appearance planes' scatters; S = 1000 and the fused planes with the
   alternatives off) and K3 at a 3-D grid's rows of the blurred phase's
   64M voxels (as a CP or bf16-row field's dense grid has them), and
   times them there (K3's memset and kernel apart, by
   torch.profiler);
10. evaluates the default path's trained state at full width
   (run_eval_phase, before the alternatives-off run): a checkpoint
   round trip into a fresh trainer (every state leaf, the mask bits, both
   generators and the re-probed budgets equal, one val view rendered
   equal bit for bit; save / restore seconds and the file's size);
   validate on 4 val views with the counters zeroed around each 4096-ray
   chunk (K1 = 1, K2-K5 = 0 each; eval budget, dense-grid choice, ms per
   view, peak memory); pose_error and eval_clip_stats; test-time pose
   optimisation of the 4 views, EVAL_TEST_ITER steps each, counters
   zeroed around each step (K1 = 1, K2 = 1, K3 = 0; median step ms); and
   the evaluate entry point in-process on the checkpoint (quant_pose.txt,
   quant.txt, quant_eval.json); then a small state's render_views and
   test-time pose gradient on the card against the CPU (check_small_eval);
11. viz/ on the same trained state (run_viz_phase): two model_it*
   snapshots (two steps apart), then the evaluate entry point in-process
   with both videos on (VIZ_FRAMES = 4 novel-view frames, cut from JAX's
   60; VIZ_TEST_ITER test-time steps a view), every render_views chunk at
   K1 = 1, K2-K5 = 0 (counters zeroed around each), ms a frame, and the
   files the installed packages call for (imageio, imageio_ffmpeg,
   matplotlib: the mp4, PNG frames or frames.npz; poses.png and the pose
   frames, or JAX's skip and failure lines); visualize_pose_gradient on
   view 0 at 400x400 in chunks of 256 rays (K1 = K2 = 1, K3 = 0 each,
   seconds, finite [3, 400, 400] maps); the maps of a small state on the
   card against the CPU (check_small_grad_viz, 1e-3 of each map's max);
   BAT's first phase with --soft_edge_mask=true
   --+sync_2d_3d_scales=true for VIZ_STEPS steps (run_option_steps: each
   step's launches against expected_launches, finite losses, soft masks;
   step 5 also holds a small soft-mask step card against CPU); the train
   CLI with --profiling=true at a tiny size (a trace with device kernels,
   back at iteration 8) and both CLIs through run_cli with --pdb
   (run_cli_options);
12. trains TensoRF (configs/tensorf_blender_VM.yaml on the blob scene at
   its widths: 400x400, 12 views, 4096 rays, 128^3 -> 300^3, S up to
   1000, ranks 16/48) and BAT on the solids scene
   (configs/bat_synthetic_convergence_20k.yaml: 128^2, 100 views, 48^3 ->
   160^3, S up to 384, 2048 rays) through every phase of 40-iteration
   schedules (TENSORF_ARGS, SOLIDS_ARGS), with run_all_phases' checks,
   launches and per-phase lines and the scene's render time, and K1-K3 at
   each one's last-phase shapes;
13. the variants (run_variants) at BAT's widths on the 64M-voxel grid,
   blurred: float32, bfloat16 factors and lane's bfloat16 dense-grid
   reads, 6 steps each (peak memory, step median, launches, the first
   loss against float32's), and one reset_on_last_upsample transition;
   then the field zoo (run_field_zoo, [zoo] and [phase-steps cp] lines,
   its wall time): the eight shading heads ZOO_HEADS (MLP_Fea4, the
   density head with predict_density, MLP_PE with both detach flags off,
   MLP, MLP_Albedo, GaRF, SH, RGB at app_dim 3) on BAT's first phase at
   full width, ZOO_STEPS steps each; CP at the TensoRF paper's CP-384
   widths (96 / 288 components) through every phase of PHASES_ARGS with
   run_all_phases' checks (warm_start_density raises its lines); the six
   VM variants, detach_viewdirs off, unstratified samples and a pose
   lambda schedule (ZOO_VARIANTS) on the blurred 64M-voxel grid,
   ZOO_STEPS steps each; every step's launches against expected_launches
   of its step and field configurations (the dense grid only where the
   field allows it, CP without planes, the density head's appearance
   planes alone), finite losses, median step and peak memory; the small
   card-vs-CPU step on each new branch (check_small_zoo); and K1/K2/K3
   against their plain versions at CP's last-phase shapes (K3 on its
   blurred dense grid) and at the density head's (K1 ungated);
14. trains L2G-BAT at BAT's widths (configs/l2g_bat_blender_VM.yaml:
   400x400, 12 views, error map 128^2, warp MLP 64-64-6, embedding 32)
   through every phase of PHASES_ARGS' schedule with run_all_phases'
   checks and lines (the in-bbox budget probed from the registered poses,
   the live samples it dropped), counts the host syncs of 3 steps (sync
   debug "warn"), runs the registration's SVD, determinant and backward
   under sync debug "error", then 5 steps of
   configs/l2g_synthetic_convergence.yaml; K1-K3 at its last phase's
   shapes;
15. trains BAT on the NDC route at configs/bat_llff_VM_MLP.yaml's widths
   (ranks 16/20, app_dim 20, MLP_Fea_WeakView 32 hidden, relu, S up to
   1000, 50^3 -> 800^3) on the facing scene at 480x640 with 20 views
   through LLFF_ARGS' 40 iterations (warmup_pose, the pose reset, the
   n_rays switch 20480 -> 4096 with the first upsample, the second
   upsample to 771x859x771, one capped mask update), every step's
   launches held against its configuration (the dense grid in every
   phase: no budget under NDC); 10 test-time steps on 2 views with the
   test-kernel blur rising (K1 = K2 = 1, K3 = 0 each); K6 and K7 at each
   phase's shape; K1/K2 and K3 at its last phase's shapes; then 3 steps at
   the 800^3 grid from the start at the largest ray count of
   LLFF_FINAL_RAYS that fits (the published first phase's 20480 rays,
   19440 a step over 20 views, x 1000 samples; the smaller counts stay as
   fallbacks), K6 and K7 at that shape, and K3 into the grid's 510M rows;
16. compares one small step of BARF (fine sampling, density noise, NDC
   rays; at progress 0) and of each planar image on the card with the CPU
   from the same parameters and draws (check_small_mlp_planar: loss rel
   1e-5, gradients 1e-3 of each leaf's max), and reports BARF's distance
   at progress 0.3 beside the CPU's own under a 1e-7 perturbation of the
   weights (a fresh MLP's float32 gradients inside the c2f window are
   ill-conditioned); trains BARF
   (configs/barf_blender.yaml: 400x400, 12 views, 1020 rays x 128
   samples, 8 x 256 with skip, L 10 / 4) and MLP-NeRF with fine sampling
   (configs/nerf_blender_repr.yaml, 64 + 192 samples, density noise 1)
   through BarfTrainer.run for MLP_STEPS steps with max_iter cut to 40, so
   that BARF's c2f window is crossed (step ms against the bound of the
   MLPs' float32 operations, peak memory, host syncs of 3 steps),
   validates 2 views (ms a view) and runs BARF's test-time optimisation
   on 2 views (MLP_TEST_ITER steps each); trains the three planar configs
   as they stand (planar_bat, planar_fft, planar_barf) for PLANAR_STEPS
   steps each (step ms, peak memory, host syncs, warp_error) and checks
   whether torch.linalg.matrix_exp synchronises the host; the counters
   zeroed before and read after each piece: K1-K7 launch 0 times there
   (none lies on these paths, as no Pallas kernel does in JAX);
17. the [parallel] phase (run_parallel; parallel/, the rays layout of
   configs/bat_blender_VM_pod16.yaml on 16 views, whose 4096 rays make a
   16 x 16 grid a view: 12 views' 19 x 19 does not divide by 2): one rank
   in a process group of one over NCCL through every phase of
   PHASES_ARGS' schedule ([parallel] (a) lines: ms a step by phase, K1-K3
   against expected_launches, the bucket's bytes and one all-reduce's ms,
   host syncs with and without the mesh), L2G-BAT's first two steps on it,
   then 2 and 4 gloo ranks on this one card started from its snapshots
   before the first step of each phase (and 2 ranks from L2G's second
   step): loss within 1e-4 relative, gradients within 1e-3 of each leaf's
   max, K1-K3 per rank as expected_launches, the ranks' state and budgets
   equal bit for bit; their step times are contention of several ranks on
   one card, not scaling; then ([parallel] (d) lines) the comp layout
   (the factor components split over ranks, no shipped config sets it):
   tpu.mesh_shape [1,2] and [2,2] over [rays,comp], gloo ranks on this
   card from the same snapshots, BAT one step a phase at both shapes,
   L2G's two steps and CP (96 / 288 components, from a one-rank CP run to
   the last snapshot's phase) one step a phase at [1,2], held as above,
   the replicas bit-identical by group; the collectives a step by purpose
   and their bytes, the peak GB per rank and the ms a step (contention);
   K3 against index_add_ at the shapes those steps launched it at
   (cuda_build.SCATTER_SHAPES, noted by the ranks step by step): for
   each channel count the launch of the most rows, and the launches into
   the fewest and into the most destination rows;
18. the [rest] phase (run_rest_phase, after the viz phase on the same
   trained state): the JAX package's functions on no entry point at
   BAT's widths: (a) the lane-packed dense grid (ops/lane_grid.py) of the
   trained field's 423x359x420 grid against packed8, values and every
   gradient with float32 and bf16 rows, 2028 x 1000 samples in march
   order, K3 once a backward at 128 channels, ms forward + backward of
   each against the function's byte bound; (b) the direct VM lane build
   against the pack of the dense grid (values, factor gradients, ms);
   (c) the hybrid plane / line samples against the plain samplers on
   the largest appearance plane and its line (2028 x app_k samples) and
   the longest density line (2028 x 1000), and K3's line scatter against
   the one-hot matmul and index_add_ at each line shape (march order and
   every sample in one row); (d) the trained state saved queued
   (async_write) and synchronously: the ms the caller is blocked, the
   files equal, the queued one restored equal leaf for leaf; (e) the
   small helpers once on the card and once on the CPU, within 1e-6;
   K3's entry in the kernels line lists the new shapes;
19. the [f1] phase (run_f1_phase, on the same trained state): the fused
   factor sample's backward in chunks of at most _PROD_BWD_CHUNK samples,
   its plane and line gradients through K3: the density and appearance
   factors of the largest plane at 2028 x 1000 samples (two chunks),
   values and every gradient on the K3 route against the plain route
   (scatter_add_rows_plain) and against the unchunked call, K3 launches
   a call against 2 x the chunks; sample_line at CP-384's widths (K3 once
   a backward); the peak memory one backward adds and its ms at the LLFF
   appearance line (4420 x 1000 samples into 771 rows, where the one-hot
   took 13.6 GB); K3 against the one-hot matmul and index_add_ (and its
   device time) at every line shape the trainers now give it, listed
   under K3's entry of the kernels line;
20. the [entry] phase (run_entry_phase, after [parallel]): the port's
   graft_entry.entry() on the card against entry(device="cpu") within
   1e-5 of the largest output, its K1 launch; dryrun_multichip(2) and (4)
   as gloo ranks on cuda:0 (seconds each); run_experiments' scheduler
   over two slots running two tiny train CLIs on this card (return codes,
   seconds);
21. prints one {"kernels": [...]} line and, last, {"ok": true, "device": ...}.

Any failed check raises and the script exits non-zero without the last
line.  It needs one CUDA card and exits 2 without one.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
N_STEPS = 20                    # full-width training steps on the main path
# BAT's schedule cut to 40 iterations: upsamples after 2, 4, 6, 8, mask
# updates after 7 (uncapped at 252^3: the bbox shrink) and 14 (capped);
# the blur ends at iteration 12 (progress 0.3)
PHASES_ARGS = ["--data.dataset=synthetic", "--max_iter=40",
               "--train_schedule.upsample_iters=[2,4,6,8]",
               "--train_schedule.update_alphamask_iters=[7,14]"]
# the JAX trainer's tpu: alternatives off: no in-bbox or blur-mask budget,
# the factored density, dense appearance; the alpha mask's budget stays
# (the JAX trainer probes it at every mask update, with no switch)
ALTERNATIVES_OFF = ["--tpu.bbox_compact=false", "--tpu.blur_mask_compact=false",
                    "--tpu.densify_density=false", "--tpu.app_k=null"]
# added to one density component per blob over +-WARM_RADII blob radii:
# the masked phases' budgets come out of the order the JAX trainer records
# for Blender (K 256-640 of S = 1000), with far fewer live samples a ray
WARM_DENSITY = 2.0
WARM_RADII = 0.5
WARM_CP = (3 * WARM_DENSITY ** 2) ** (1 / 3)
# TensoRF (configs/tensorf_blender_VM.yaml) cut to 40 iterations in the
# published schedule's order: upsamples after 2, 4, 6, 8, 10 (128^3 ->
# 300^3), mask updates after 2 (uncapped at 151^3: the bbox shrink) and 6
TENSORF_ARGS = ["--data.dataset=synthetic", "--max_iter=40",
                "--train_schedule.upsample_iters=[2,4,6,8,10]",
                "--train_schedule.update_alphamask_iters=[2,6]"]
# BAT on the solids scene (configs/bat_synthetic_convergence_20k.yaml: 128^2,
# 100 views, 48^3 -> 160^3, S up to 384) cut to 40 iterations at the
# published schedule's fractions: upsamples after 2, 4, 6, 8, mask updates
# after 12 and 20 (0.3 and 0.5 of the run), the blur until 12
SOLIDS_ARGS = ["--max_iter=40", "--train_schedule.upsample_iters=[2,4,6,8]",
               "--train_schedule.update_alphamask_iters=[12,20]"]
# the variants at BAT's widths on the final 400^3 grid (64M voxels) from
# the start, blurred (the first iterations of 40k), no upsample or mask
VARIANT_ARGS = ["--data.dataset=synthetic",
                "--train_schedule.n_voxel_init=64000000",
                "--train_schedule.upsample_iters=[1000000]",
                "--train_schedule.update_alphamask_iters=[1000000]"]
VARIANT_STEPS = 6
# the field zoo (run_field_zoo): the eight shading heads beside MLP_Fea and
# MLP_Fea_WeakView on BAT's first phase, each with the options it needs;
# CP at the TensoRF paper's CP-384 widths (96 density and 288 appearance
# components, Chen et al., "TensoRF", ECCV 2022) through PHASES_ARGS; the
# six VM variants (ignore_negative_split where it acts, under
# convolve_positive_only) and the last render and pose options on
# VARIANT_ARGS
ZOO_HEADS = {
    "MLP_Fea4": [],
    "MLP_Fea_WeakView_Density": ["--+arch.shading.predict_density=true"],
    "MLP_PE": ["--arch.shading.detach_xyz=false",
               "--arch.shading.detach_viewdirs=false"],
    "MLP": [], "MLP_Albedo": [], "GaRF": [], "SH": [],
    "RGB": ["--arch.shading.app_dim=3"]}
ZOO_STEPS = 6
CP_ARGS = ["--arch.tensorf.model=BAT_CP",
           "--arch.tensorf.density_components=[96,96,96]",
           "--arch.tensorf.color_components=[288,288,288]"]
ZOO_VARIANTS = {
    "abs_components": ["--arch.abs_components=true"],
    "component_wise_feature2density": [
        "--arch.component_wise_feature2density=true"],
    "plane_feature2density": ["--arch.plane_feature2density=true"],
    "convolve_plane_only": ["--arch.convolve_plane_only=true"],
    "convolve_positive_only": ["--arch.convolve_positive_only=true"],
    "ignore_negative_split": ["--arch.convolve_positive_only=true",
                              "--arch.ignore_negative_split=true"],
    "detach_viewdirs_false": ["--arch.shading.detach_viewdirs=false"],
    "sample_stratified_false": ["--nerf.sample_stratified=false"],
    "lr_pose_schedule": ["--optim.sched_pose.type=LambdaLR",
                         "--+optim.sched_pose.lr_pose_schedule="
                         "[0.001,0.0005,0.0001]"]}
# the small card-vs-CPU steps' VM variants (check_small_zoo)
ZOO_SMALL_VARIANTS = {
    "abs_components": dict(abs_components=True),
    "component_wise_feature2density": dict(
        component_wise_feature2density=True, density_shift=-4.0),
    "plane_feature2density": dict(plane_feature2density=True,
                                  density_shift=-4.0),
    "convolve_plane_only": dict(convolve_plane_only=True),
    "convolve_positive_only": dict(convolve_positive_only=True),
    "ignore_negative_split": dict(convolve_positive_only=True,
                                  ignore_negative_split=True)}
# evaluation on the trained default path: 4 val / test views (val_sub: 4,
# the base config's; BAT's own config takes 10), test-time optimisation cut
# from BAT's 400 steps to 20 (40 until the [parallel] phase came)
EVAL_ARGS = ["--data.val_sub=4"]
EVAL_TEST_ITER = 20
# the viz phase on the same trained state: the novel-view video cut from
# JAX's 60 frames to 4 (8 until the [parallel] phase came), the test-time
# optimisation (run in step 10 at 20 steps) cut to 4 steps a view; the
# pose-gradient maps in JAX's chunks of 256 rays; BAT's first phase with
# the two options of the paper's edge mask and blur schedule, VIZ_STEPS
# steps
VIZ_FRAMES = 4
VIZ_TEST_ITER = 4
GRAD_CHUNK = 256
VIZ_OPTIONS = ["--soft_edge_mask=true", "--+sync_2d_3d_scales=true"]
VIZ_STEPS = 10
# the CLIs' small runs (profiling, --pdb): BAT on a 32x32 scene
TINY_CLI_ARGS = ["--data.dataset=synthetic", "--data.image_size=[32,32]",
                 "--data.n_views=4", "--data.val_sub=2",
                 "--train_schedule.n_voxel_init=4096",
                 "--train_schedule.n_voxel_final=32768",
                 "--train_schedule.n_rays_init=256", "--c2f_kernel_size=8",
                 "--blur_2d_c2f_kernel_size=15", "--max_iter=12",
                 "--train_schedule.upsample_iters=[4,8]",
                 "--train_schedule.update_alphamask_iters=[6]",
                 "--freq.scalar=2", "--freq.val=0", "--freq.ckpt=6",
                 "--+tb_logging=false"]
# L2G-BAT's solids convergence config: steps run
L2G_CONV_STEPS = 5
# BAT on the NDC route (configs/bat_llff_VM_MLP.yaml) on the facing scene at
# 480x640, cut to 40 iterations in the published order (warmup 500, reset
# 2500, n_rays switch and first upsample 6000, second upsample 8000, mask
# 19500, accumulation switch 20000 of 50000): warmup_pose 2, pose
# accumulation 2 (of 8, so that the reset finds moved poses), the reset
# before step 4, the n_rays switch and the first upsample after 6 (50^3
# -> 200^3), the second after 8 (-> 800^3), the mask after 16, the
# accumulation 2 -> 1 at 16; dense appearance (tpu.app_k null, as
# configs/bat_synthetic_llff.yaml sets for forward-facing rays)
LLFF_VIEWS = 20
LLFF_ARGS = ["--data.dataset=synthetic", "--data.scene=facing",
             f"--data.n_views={LLFF_VIEWS}", "--data.val_sub=2",
             "--max_iter=40", "--optim.warmup_pose=2",
             "--train_schedule.n_AccumPoseGrad_init=2",
             "--train_schedule.reset_pose_on_iter=4",
             "--train_schedule.change_n_rays_after_n_iters=6",
             "--train_schedule.upsample_iters=[6,8]",
             "--train_schedule.update_alphamask_iters=[16]",
             "--train_schedule.change_AccumPoseGrad_after_n_iters=16",
             "--tpu.app_k=null"]
# test-time steps on the trained NDC state, with the test-kernel blur
# rising from 0 to 0.05 world units
LLFF_TEST_ITER = 10
LLFF_TEST_KERNEL = [0.0, 0.05]
# ray counts tried at the final 800^3 grid, the first that fits runs
LLFF_FINAL_RAYS = [20480, 10240, 4096]
# BARF (configs/barf_blender.yaml) and MLP-NeRF with fine sampling
# (configs/nerf_blender_repr.yaml, density noise 1 as nerf_llff_repr.yaml
# sets it) at their widths on the procedural scene (400x400, 12 views,
# 1020 rays); max_iter cut from 200000 to 40, so that the 20 steps cross
# BARF's c2f window [0.1, 0.5] (partial band weights from step 4); 2
# validation views; BARF's test-time optimisation on 2 views cut from 100
# steps to 20
MLP_ARGS = ["--data.dataset=synthetic", "--max_iter=40", "--data.val_sub=2"]
MLP_STEPS = 20
MLP_TEST_ITER = 20
# the planar configs as they stand (500^2 rank 100, 400^2 FFT, 4 x 256
# MLP; 5 patches of 180^2 under SL(3)), 50 steps each at the schedule's
# start (kernel_t sigma 128 -> 127.6 for the SVD and FFT images)
PLANAR_CFGS = ("planar_bat.yaml", "planar_fft.yaml", "planar_barf.yaml")
PLANAR_STEPS = 50
# K1-K7: none lies on the MLP or planar paths (JAX computes them in plain
# XLA, no Pallas kernel)
NO_LAUNCHES = {"composite_fwd": 0, "composite_bwd": 0, "scatter_add_rows": 0,
               "binned_plane_scatter": 0, "scatter_add_rows_tiled": 0,
               "density_sample_fwd": 0, "density_sample_bwd": 0,
               "app_sample_fwd": 0, "app_sample_bwd": 0}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``reps``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the float32 peak."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_times(fn, reps: int = 20, warmup: int = 3) -> dict:
    """Mean device time of one call from torch.profiler (CUPTI), by device
    activity (kernel or memset): {short name: ms} over ``reps`` calls.  An
    activity's mean is taken over the events recorded (a lost event does
    not lower it), times how many a call launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.key)
            name = m.group(1) if m else e.key[:48]
            per_call = max(1, round(e.count / reps))
            times[name] = times.get(name, 0.0) + \
                e.self_device_time_total / e.count * per_call / 1e3
    return times


def device_ms(fn, match: str) -> float:
    """Summed device time of one call's kernels whose name contains
    ``match``."""
    return sum(ms for name, ms in device_times(fn).items() if match in name)


def max_err(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


# ------------------------------------------------------------ kernel checks
def composite_inputs(N, S, gen):
    """Alpha, rgb, z and cotangents at the step's shape; a few rays are
    saturated (alpha == 1.0 exactly) or fully transparent."""
    import torch

    dev = "cuda"
    alpha = torch.rand((N, S), generator=gen, device=dev) ** 4 * 0.5
    alpha[0] = 1.0
    alpha[1, ::3] = 1.0
    alpha[2] = 0.0
    rgb = torch.rand((N, S, 3), generator=gen, device=dev)
    z = 2.0 + torch.cumsum(torch.full((N, S), 0.024, device=dev), -1)
    cots = (torch.randn((N, 3), generator=gen, device=dev),
            torch.randn((N,), generator=gen, device=dev),
            torch.randn((N,), generator=gen, device=dev),
            torch.randn((N, S), generator=gen, device=dev))
    return alpha, rgb, z, cots


def check_composite(N, S, thres, gen, tol):
    """K1 and K2 against their plain versions (K2 given K1's weights, once
    with g_weights None, as the dense appearance calls it, and once with
    them, as the two-stage appearance of the default tpu: path does);
    times each back to back and, from torch.profiler, on the device.
    Returns the rows [K1, K2 without g_weights, K2 with them]."""
    import torch

    from joint_tensorf_tpu_torch.ops import composite as C

    alpha, rgb, z, cots = composite_inputs(N, S, gen)
    w = C.composite_fwd_cuda(alpha, rgb, z, thres)[3]   # the forward's
    NS = N * S
    # K1: alpha, rgb, z in; rgb_map, depth, acc, weights out
    checks = [("composite_fwd", None,
               lambda: C.composite_fwd_cuda(alpha, rgb, z, thres),
               lambda: C.composite_fwd_plain(alpha, rgb, z, thres),
               NS * 4 * (1 + 3 + 1) + NS * 4 + N * 4 * 5, NS * 13, 138)]
    for g_w in (None, cots[3]):
        args = (alpha, rgb, z, w, thres, *cots[:3], g_w)
        # K2: alpha, rgb, z, weights (and g_weights), g_rgb, g_depth, g_acc
        # in; d_alpha, d_rgb, d_z out
        n_in = 6 if g_w is None else 7
        checks.append(("composite_bwd", g_w is not None,
                       lambda args=args: C.composite_bwd_cuda(*args),
                       lambda args=args: C.composite_bwd_plain(*args),
                       NS * 4 * n_in + N * 4 * 5 + NS * 4 * 5, NS * 30, 189))
    rows = []
    for name, g_weights, kfn, pfn, n_bytes, flops, src_line in checks:
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in got):
            fail(f"{name} produced non-finite values")
        err = max_err(got, want)
        if err > tol:
            fail(f"{name} (g_weights given: {g_weights}) disagrees with its "
                 f"plain version at {(N, S)}: {err:.3g} > {tol}")
        b_ms, b_by = bound(n_bytes, flops)
        row = {
            "name": name, "route": "cuda",
            "source": "joint_tensorf_tpu_torch/csrc/composite.cu",
            "replaces": f"joint_tensorf_tpu/ops/pallas_kernels.py:{src_line}",
            "launches": None, "max_abs_err": err, "tolerance": tol,
            "ms": time_ms(kfn), "device_ms": device_ms(kfn, name + "_kernel"),
            "plain_ms": time_ms(pfn),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"N": N, "S": S, "thres": thres}}
        if g_weights is not None:
            row["g_weights"] = ("given (two-stage app_k)" if g_weights
                                else "none (dense appearance)")
        rows.append(row)
    return rows


def march_points(n_rays, S, H, W, gen):
    """Continuous plane positions (x, y) [n_rays * S] in march order: each
    ray's samples step across the plane by at most half a cell, like the
    training step's samples (step = half a voxel)."""
    import torch

    dev = "cuda"
    start = torch.rand((n_rays, 2), generator=gen, device=dev) \
        * torch.tensor([W - 1.0, H - 1.0], device=dev)
    ang = torch.rand((n_rays,), generator=gen, device=dev) * 2 * math.pi
    speed = 0.5 * torch.rand((n_rays, 1), generator=gen, device=dev)
    step = torch.stack([torch.cos(ang), torch.sin(ang)], -1) * speed
    t = torch.arange(S, device=dev, dtype=torch.float32)[None, :, None]
    pos = start[:, None, :] + t * step[:, None, :]
    return (pos[..., 0].clamp(0, W - 1.001).reshape(-1),
            pos[..., 1].clamp(0, H - 1.001).reshape(-1))


def march_indices(n_rays, S, H, W, gen):
    """Plane-row indices of march_points."""
    x, y = march_points(n_rays, S, H, W, gen)
    return (y.floor().long() * W + x.floor().long()).contiguous()


def march_indices_3d(n_rays, S, X, Y, Z, gen):
    """Row indices (x * Y + y) * Z + z of a dense [X, Y, Z] grid along
    rays in march order, each step at most half a cell per axis (the dense
    grid's row gather)."""
    import torch

    dev = "cuda"
    size = torch.tensor([X - 1.0, Y - 1.0, Z - 1.0], device=dev)
    start = torch.rand((n_rays, 3), generator=gen, device=dev) * size
    step = (torch.rand((n_rays, 3), generator=gen, device=dev) - 0.5)
    t = torch.arange(S, device=dev, dtype=torch.float32)[None, :, None]
    pos = torch.minimum((start[:, None] + t * step[:, None]).clamp(min=0),
                        size - 0.001).floor().long()
    return ((pos[..., 0] * Y + pos[..., 1]) * Z + pos[..., 2]).reshape(-1)


def step_samples(cfg, rays: int = 1) -> tuple:
    """(N, N_app): the samples one rank's factor samples see in a step with
    StepConfig ``cfg`` when the step's rays are split over ``rays`` ranks
    (the mesh's rays axis): its rays x the kept samples a ray (compact_k
    below S, else S), and x app_k of those on a two-stage appearance."""
    n = cfg.n_views * cfg.rays_per_view // rays
    S = cfg.n_samples
    if cfg.compact_k is not None and cfg.compact_k < S:
        S = cfg.compact_k
    return n * S, n * (min(cfg.app_k, S) if cfg.app_k is not None else S)


def _fused_k3(n_samples: int) -> int:
    """K3 launches of one fused factor sample's backward on n_samples:
    a plane and a line scatter per chunk of at most _PROD_BWD_CHUNK."""
    from joint_tensorf_tpu_torch.ops import sampling

    return 2 * -(-n_samples // sampling._PROD_BWD_CHUNK)


def expected_launches(cfg, vm_cfg=None, rays: int = 1) -> dict:
    """Launches of one training step with StepConfig ``cfg`` on a field of
    VMConfig ``vm_cfg`` (the default VM field when None), on one rank of a
    mesh whose rays axis has ``rays`` ranks: K1 and K2 once; K3 once for
    the dense grid's row gather, and for each axis's fused factor sample
    (sampling.sample_planeline_prod) two a chunk of at most
    _PROD_BWD_CHUNK samples (the plane's and the line's row scatters), for
    each sample_line (CP's lines, convolve_positive_only's density lines
    under the blur) one; K6 (sampling.sample_planeline_prod_sum) once
    forward and once backward for a VM density sampled from its factors
    apart from the appearance (vm.density_sample_skips_dead: not the dense
    grid, the fused sample, the head's density, CP or the split), with no
    K3 call; K7 (sampling.sample_planeline_prod_cat) once forward and once
    backward for a VM appearance sampled apart from the density (every
    route but the fused sample), with no K3 call, whatever its samples.
    The samples are the rank's (step_samples): all kept samples for the
    fused sample's K3 chunks.  The density's route is the renderer's
    (renderer.density_route): the dense grid only where densify_density
    allows it, vm.can_densify and K6 does not apply (CP) or the rows are
    read in bfloat16, the fused sample only where no grid is allowed,
    neither with the head's density (predict_density: the appearance
    alone, on every sample); a CP field has no planes, its six lines are
    sample_line's.  The same without pose optimisation (TensoRF):
    detached coordinates drop the coordinate derivatives, not the
    factors' scatters; bf16 factors and bf16 dense reads scatter float32
    gradients through the same calls."""
    from joint_tensorf_tpu_torch.models import vm as vm_lib
    from joint_tensorf_tpu_torch.render.renderer import density_route

    vm_cfg = vm_cfg or vm_lib.VMConfig()
    cp = vm_cfg.decomposition == "CP"
    route = density_route(cfg, vm_cfg, cfg.blur is not None)
    k6 = render_k6(cfg, vm_cfg, blur=cfg.blur is not None)
    k7 = render_k7(cfg, vm_cfg, blur=cfg.blur is not None)
    N, _ = step_samples(cfg, rays)
    split = cfg.blur is not None and vm_cfg.convolve_positive_only
    app = 3 if cp else 0            # CP's appearance lines (sample_line)
    if route == "grid":
        k3 = 1 + app
    elif route == "head":
        k3 = app
    elif route == "fused":
        k3 = 3 * _fused_k3(N)
    else:
        k3 = (3 if cp or split else 0) + app
    return {"composite_fwd": 1, "composite_bwd": 1, "scatter_add_rows": k3,
            "binned_plane_scatter": 0, "scatter_add_rows_tiled": 0,
            "density_sample_fwd": k6, "density_sample_bwd": k6,
            "app_sample_fwd": k7, "app_sample_bwd": k7}


def render_k6(cfg, vm_cfg, blur: bool = False) -> int:
    """K6's launches in one render_rays call (forward, and as many in
    its backward where one runs) with a StepConfig or RenderConfig ``cfg``
    on a field of VMConfig ``vm_cfg``, blurred or not: 1 where the density
    takes the summed factor sample (renderer.density_route "factored" and
    vm.density_sample_skips_dead)."""
    from joint_tensorf_tpu_torch.models import vm as vm_lib
    from joint_tensorf_tpu_torch.render.renderer import density_route

    return int(density_route(cfg, vm_cfg, blur) == "factored"
               and vm_lib.density_sample_skips_dead(vm_cfg, blur))


def render_k7(cfg, vm_cfg, blur: bool = False) -> int:
    """K7's launches in one render_rays call (forward, and as many in its
    backward where one runs) with a StepConfig or RenderConfig ``cfg`` on
    a field of VMConfig ``vm_cfg``, blurred or not: 1 where the appearance
    is vm.compute_app_feature's on a VM field, which is every density
    route but the fused sample (renderer.density_route)."""
    from joint_tensorf_tpu_torch.render.renderer import density_route

    return int(vm_cfg.decomposition == "VM"
               and density_route(cfg, vm_cfg, blur) != "fused")


def blur_mask_k6(vm_cfg, mask_res) -> int:
    """K6 forwards of one blur-mask build on a field of ``vm_cfg`` at
    ``mask_res`` (Trainer.blur_mask_built; the build runs inside
    train_iteration, and alpha_mask.dense_alpha samples the density one
    chunk of 128K mask voxels at a time); 0 for None."""
    from joint_tensorf_tpu_torch.models import vm as vm_lib

    if mask_res is None or not vm_lib.density_sample_skips_dead(vm_cfg,
                                                                 False):
        return 0
    return -(-math.prod(mask_res) // (128 * 1024))


def step_launches(tr, vm_cfg=None, rays: int = 1) -> dict:
    """expected_launches of trainer ``tr``'s last step, with the K6
    forwards of a blur mask built in that iteration."""
    want = expected_launches(tr.last_step_config, vm_cfg, rays)
    want["density_sample_fwd"] += blur_mask_k6(tr.vm_cfg,
                                               tr.blur_mask_built)
    return want


def march_indices_1d(n_rays, S, D, gen):
    """Row indices of a D-long line along rays in march order (a line
    factor's rows, as sample_line and the fused sample gather them): each
    ray starts at a random row and steps by at most half a row, folded
    back at the ends.  In float64, so that D may be as long as the dense
    grid's 64M rows (float32 positions there round past the last row)."""
    import torch

    dev, f64 = "cuda", torch.float64
    end = float(D - 1)
    start = torch.rand((n_rays, 1), generator=gen, device=dev, dtype=f64)
    step = torch.rand((n_rays, 1), generator=gen, device=dev, dtype=f64)
    t = torch.arange(S, device=dev, dtype=f64)
    p = torch.remainder(start * end + t * (step - 0.5), 2 * end)
    p = torch.where(p > end, 2 * end - p, p)
    return p.floor().long().clamp_(0, D - 1).reshape(-1).contiguous()


def check_scatter(n_rays, S, H, W, C, gen, tol, grid3d=None, line=None,
                  n=None):
    """K3 on n_rays x S rows of C channels into an H x W plane in march
    order, with grid3d = (X, Y, Z) into the dense grid's X*Y*Z rows, or
    with ``line`` into a line of that many rows; with ``n`` on the first n
    of those rows;
    times the wrapper back to back and, from torch.profiler, its memset
    and its kernel apart (device_ms_by_kernel; device_ms is the kernel's)."""
    import torch

    from joint_tensorf_tpu_torch.ops import segment_scatter as K

    if line is not None:
        idx = march_indices_1d(n_rays, S, line, gen)
        H, W = 1, line
    elif grid3d is None:
        idx = march_indices(n_rays, S, H, W, gen)
    else:
        idx = march_indices_3d(n_rays, S, *grid3d, gen)
        H, W = grid3d[0] * grid3d[1], grid3d[2]
    idx = idx[:n].contiguous()
    upd = torch.randn((idx.shape[0], C), generator=gen, device="cuda")
    n_rows = H * W
    got = K.scatter_add_rows_cuda(idx, upd, n_rows)
    want = K.scatter_add_rows_plain(idx, upd, n_rows)
    torch.cuda.synchronize()
    # atomics on both sides sum in run-dependent orders: compare relative
    # to the largest destination value
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not torch.isfinite(got).all() or err > tol * scale:
        fail(f"scatter kernel disagrees with index_add_ at {n_rows} rows: "
             f"{err:.3g} > {tol} x {scale:.3g}")
    del got, want
    N = idx.shape[0]
    b_ms, b_by = bound(N * 8 + N * C * 4 + n_rows * C * 4, N * C)

    def k3():
        return K.scatter_add_rows_cuda(idx, upd, n_rows)

    # the plain version is index_add_, which is also the library call;
    # the profiler runs last, so that no timing follows its teardown
    k3_ms = time_ms(k3)
    plain = time_ms(lambda: K.scatter_add_rows_plain(idx, upd, n_rows))
    library = time_ms(lambda: torch.zeros(
        (n_rows, C), device="cuda").index_add_(0, idx, upd))
    # the wrapper's device activities by name: its memset and the kernel
    by_kernel = device_times(k3)
    return {"name": "scatter_add_rows", "route": "cuda",
            "source": "joint_tensorf_tpu_torch/csrc/segment_scatter.cu",
            "replaces": "joint_tensorf_tpu/ops/segment_scatter.py:168",
            "launches": None, "max_abs_err": err,
            "tolerance": f"{tol} x max|out| = {tol * scale:.3g}",
            "ms": k3_ms,
            "device_ms": sum(t for name, t in by_kernel.items()
                             if "scatter_add_rows" in name),
            "device_ms_by_kernel": by_kernel,
            "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library,
            "shape": {"N": N, "C": C, "n_rows": n_rows,
                      "rows": ("line" if line is not None else
                               "dense grid" if grid3d else "plane")}}


def density_sample_inputs(gen, rays=2500, K=896, res=400, R=16, live=None,
                          ndc=False):
    """K6's inputs, by default at the masked cell's shape: the three
    planes and lines of R ranks of a field of ``res`` voxels an axis (an
    int: a cube) as vm.AXES reads them, rays x K slots marching through
    the box (``ndc``: x and y within +-0.05 of the ray's start while z
    sweeps the box, as a forward-facing ray's samples do under NDC), each
    ray's live slots a prefix: of 0-96 slots (about 5%, as the masked
    cell's kept_slot_use) where ``live`` is None, else of a share of K
    drawn about ``live``."""
    import torch

    from joint_tensorf_tpu_torch.models import vm as vm_lib

    res = [res] * 3 if isinstance(res, int) else list(res)
    planes = [torch.randn((res[m1], res[m0], R), generator=gen,
                          device="cuda") for m0, m1, _ in vm_lib.AXES]
    lines = [torch.randn((res[w], R), generator=gen, device="cuda")
             for _, _, w in vm_lib.AXES]
    if ndc:
        start = torch.rand((rays, 1, 2), generator=gen,
                           device="cuda") * 1.8 - 0.9
        drift = (torch.rand((rays, 1, 2), generator=gen, device="cuda")
                 - 0.5) * 0.1
        t = (torch.arange(K, device="cuda")[None, :, None]
             + torch.rand((rays, K, 1), generator=gen, device="cuda")) / K
        pts = torch.cat([start + drift * t, t * 2 - 1], -1)
    else:
        start = torch.rand((rays, 1, 3), generator=gen,
                           device="cuda") * 2.2 - 1.1
        step = (torch.rand((rays, 1, 3), generator=gen, device="cuda")
                - 0.5) * (4.0 / K)
        pts = start + torch.arange(K, device="cuda")[None, :, None] * step
    coords = [pts[..., a].reshape(-1).contiguous() for a in range(3)]
    lo, hi = ((0, 96) if live is None else
              (max(0, round((2 * live - 1) * K)), min(K, round(2 * live * K))))
    n_live = torch.randint(lo, hi + 1, (rays, 1), generator=gen,
                           device="cuda")
    live = (torch.arange(K, device="cuda")[None] < n_live).reshape(-1)
    return planes, lines, coords, vm_lib.AXES, live


def held_to_plain(got, plain, tol, exact, key):
    """A factor-sample kernel's outputs ``got`` (the feature, then the
    three plane, three line and three coordinate gradients) against
    ``plain(dtype)``, its plain version's: (each output's largest error
    over its largest magnitude, the same against float64 with ``exact`` as
    {key: the kernel's, "plain": the float32 plain's}, the outputs past
    ``tol``).  With ``exact`` a factor gradient past ``tol`` of the float32
    plain passes where the kernel lies within max(tol, 2 x the float32
    plain's error) of the float64 one: each line or plane row sums
    thousands of slots' adds in float32, in an order that differs between
    the two."""
    import torch

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / max(
            float(b.abs().max()), 1e-30)

    want = plain(torch.float32)
    torch.cuda.synchronize()
    errs = [rel(a, b) for a, b in zip(got, want)]
    bad = [i for i, e in enumerate(errs) if e > tol]
    f64 = None
    if exact:
        ref = plain(torch.float64)
        f64 = {key: [rel(a, r) for a, r in zip(got, ref)],
               "plain": [rel(b, r) for b, r in zip(want, ref)]}
        # outputs 1-6: the plane and line gradients
        bad = [i for i in bad if not (1 <= i <= 6 and f64[key][i] <= max(
            tol, 2 * f64["plain"][i]))]
    return errs, f64, bad


def check_density_sample(gen, tol=1e-5, exact=False, **shape):
    """K6 (ops/density_sample.py) against its plain version at a shape of
    density_sample_inputs (``shape``; the masked cell's by default):
    forward and backward (every gradient), within ``tol`` of each
    output's largest magnitude, and with ``exact`` against float64 too
    (held_to_plain, ``f64_rel_err``).  Times the forward and the backward back to back and by torch.profiler, the
    plain version's forward + backward, and the bound: the bytes of the
    predicates, the live slots' coordinates and factor rows (four plane
    and two line rows of R floats an axis) read and, backward, as many
    gradient adds, the feature and coordinate gradients written."""
    import torch

    from joint_tensorf_tpu_torch.ops import density_sample as K6
    from joint_tensorf_tpu_torch.ops import sampling

    planes, lines, coords, axes, live = density_sample_inputs(gen, **shape)
    g = torch.randn(coords[0].shape, generator=gen, device="cuda")

    def plain(dtype=torch.float32):
        xs = [t.detach().to(dtype).requires_grad_(True)
              for t in planes + lines + coords]
        out = sampling.sample_planeline_prod_sum_plain(
            xs[0:3], xs[3:6], xs[6:9], axes, live)
        return [out.detach()] + list(torch.autograd.grad(
            (out * g.to(dtype)).sum(), xs))

    def fwd():
        return K6.density_sample_fwd_cuda(planes, lines, coords, axes, live)

    def bwd():
        return K6.density_sample_bwd_cuda(planes, lines, coords, axes, live,
                                          g)

    d_p, d_l, d_c = bwd()
    got = [fwd()] + d_p + d_l + d_c
    errs, f64, bad = held_to_plain(got, plain, tol, exact, "k6")
    dead = int(torch.count_nonzero(got[0][~live])) + sum(
        int(torch.count_nonzero(d[~live])) for d in d_c)
    if bad or dead or not all(torch.isfinite(t).all() for t in got):
        fail(f"K6 disagrees with its plain version: relative errors "
             f"{errs} (against float64: {f64}), {dead} non-zero dead-slot "
             f"outputs")
    del got, d_p, d_l, d_c
    N, n_live = coords[0].shape[0], int(live.sum())
    R = planes[0].shape[-1]
    rows = n_live * 3 * 6 * R * 4
    fwd_bytes = N + n_live * 12 + rows + N * 4
    bwd_bytes = N + n_live * 16 + 2 * rows + N * 12
    f_ms, f_by = bound(fwd_bytes, n_live * 3 * R * 12)
    b_ms, b_by = bound(bwd_bytes, n_live * 3 * R * 40)
    return {"name": "density_sample", "route": "cuda",
            "source": "joint_tensorf_tpu_torch/csrc/density_sample.cu",
            "replaces": None, "max_rel_err": errs, "f64_rel_err": f64,
            "tolerance": f"{tol} x max|out|",
            "fwd_ms": time_ms(fwd), "bwd_ms": time_ms(bwd),
            "plain_ms": time_ms(plain, reps=5),
            "fwd_device_ms": device_times(fwd),
            "bwd_device_ms": device_times(bwd),
            "fwd_bound_ms": f_ms, "fwd_bound_by": f_by,
            "bwd_bound_ms": b_ms, "bwd_bound_by": b_by,
            "shape": {"N": N, "live": n_live, "R": R,
                      "plane": list(planes[0].shape),
                      "lines": [ln.shape[0] for ln in lines],
                      # the backward's line adds: shared memory where the
                      # three lines fit in csrc/density_sample.cu's
                      # kMaxLineSmem (96 KB), else global atomics
                      "line_adds": ("shared" if sum(ln.numel() for ln in
                                                    lines) * 4 <= 96 * 1024
                                    else "global")}}


def check_density_at_phases(label, rows, rays=None, ndc=False):
    """check_density_sample at each distinct shape at which a run's
    phases (``rows``: the phase lines' resolution, n_samples, compact_k
    where given, valid_frac, launches_per_step and rays, else ``rays``)
    launched K6: the rays, the slots each kept, the field's resolution
    and the phase's live share of the kept slots, NDC marches with
    ``ndc``; the factor gradients also against float64 (``exact``).
    Emits one kernel_check a shape, its path the label and iterations."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(25)
    seen = set()
    for row in rows:
        if not row["launches_per_step"].get("density_sample_fwd"):
            continue
        S = row["n_samples"]
        K = min(row.get("compact_k") or S, S)
        n = row.get("rays", rays)
        key = (n, K, tuple(row["resolution"]))
        if key in seen:
            continue
        seen.add(key)
        r = check_density_sample(gen, exact=True, rays=n, K=K,
                                 res=row["resolution"],
                                 live=min(1.0, row["valid_frac"] * S / K),
                                 ndc=ndc)
        emit({"kernel_check": dict(
            r, path=f"{label} its {row['iterations']}")})
        print(f"[k6 {label}] its {row['iterations']} {n} rays x {K} at "
              f"{row['resolution']}: live {r['shape']['live']}, lines "
              f"{r['shape']['line_adds']}, max rel err "
              f"{max(r['max_rel_err']):.3g} (float64: K6 "
              f"{max(r['f64_rel_err']['k6'][1:7]):.3g}, plain "
              f"{max(r['f64_rel_err']['plain'][1:7]):.3g} on the factor "
              f"gradients), fwd {r['fwd_ms']:.4f} / bwd "
              f"{r['bwd_ms']:.4f} ms, bound {r['fwd_bound_ms']:.4f} / "
              f"{r['bwd_bound_ms']:.4f} ms", flush=True)
        torch.cuda.empty_cache()


def check_app_sample(gen, tol=1e-5, exact=False, **shape):
    """K7 (ops/app_sample.py) against its plain version at a shape of
    density_sample_inputs (``shape``, R the appearance's rank an axis; the
    masked cell's app_k slots by default: 2500 rays x 128 at 400^3, R 48),
    every slot sampled: forward and backward (every gradient), within
    ``tol`` of each output's largest magnitude, and with ``exact`` against
    float64 too (held_to_plain, ``f64_rel_err``).  Times the forward and
    the backward
    back to back and by torch.profiler, the plain version's forward +
    backward, and the bound: the coordinates read and the feature rows
    written (forward), the cotangent rows and coordinates read and the
    coordinate gradients written (backward); the factors read once and,
    backward, their gradients written once (the kernel's zeroing of them
    is its own choice, not the function's traffic)."""
    import torch

    from joint_tensorf_tpu_torch.ops import app_sample as K7
    from joint_tensorf_tpu_torch.ops import sampling

    shape = {"K": 128, "R": 48, **shape}
    planes, lines, coords, axes, _ = density_sample_inputs(gen, **shape)
    N, C = coords[0].shape[0], sum(p.shape[-1] for p in planes)
    g = torch.randn((N, C), generator=gen, device="cuda")

    def plain(dtype=torch.float32):
        xs = [t.detach().to(dtype).requires_grad_(True)
              for t in planes + lines + coords]
        out = sampling.sample_planeline_prod_cat_plain(
            xs[0:3], xs[3:6], xs[6:9], axes)
        return [out.detach()] + list(torch.autograd.grad(
            (out * g.to(dtype)).sum(), xs))

    def fwd():
        return K7.app_sample_fwd_cuda(planes, lines, coords, axes)

    def bwd():
        return K7.app_sample_bwd_cuda(planes, lines, coords, axes, g)

    d_p, d_l, d_c = bwd()
    got = [fwd()] + d_p + d_l + d_c
    errs, f64, bad = held_to_plain(got, plain, tol, exact, "k7")
    if bad or not all(torch.isfinite(t).all() for t in got):
        fail(f"K7 disagrees with its plain version: relative errors "
             f"{errs} (against float64: {f64})")
    del got, d_p, d_l, d_c
    factors = sum(t.numel() for t in planes + lines) * 4
    fwd_bytes = N * 12 + N * C * 4 + factors
    bwd_bytes = N * 24 + N * C * 4 + 2 * factors
    f_ms, f_by = bound(fwd_bytes, N * C * 14)
    b_ms, b_by = bound(bwd_bytes, N * C * 40)
    return {"name": "app_sample", "route": "cuda",
            "source": "joint_tensorf_tpu_torch/csrc/app_sample.cu",
            "replaces": None, "max_rel_err": errs, "f64_rel_err": f64,
            "tolerance": f"{tol} x max|out|",
            "fwd_ms": time_ms(fwd), "bwd_ms": time_ms(bwd),
            "plain_ms": time_ms(plain, reps=3, warmup=1),
            "fwd_device_ms": device_times(fwd),
            "bwd_device_ms": device_times(bwd),
            "fwd_bound_ms": f_ms, "fwd_bound_by": f_by,
            "bwd_bound_ms": b_ms, "bwd_bound_by": b_by,
            "shape": {"N": N, "R": [p.shape[-1] for p in planes],
                      "plane": list(planes[0].shape),
                      "lines": [ln.shape[0] for ln in lines]}}


def check_app_at_phases(label, rows, R, rays=None, ndc=False):
    """check_app_sample at each distinct shape at which a run's phases
    (``rows``, as check_density_at_phases reads them, with app_k where
    given) launched K7: the rays, the slots each sampled (app_k of the
    kept ones, else all kept), the field's resolution, the appearance's
    rank R an axis, NDC marches with ``ndc``; the factor gradients also
    against float64 (``exact``).  Emits one kernel_check a shape, its
    path the label and iterations."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(27)
    seen = set()
    for row in rows:
        if not row["launches_per_step"].get("app_sample_fwd"):
            continue
        S = row["n_samples"]
        K = min(row.get("compact_k") or S, S)
        if row.get("app_k") is not None:
            K = min(row["app_k"], K)
        n = row.get("rays", rays)
        key = (n, K, tuple(row["resolution"]))
        if key in seen:
            continue
        seen.add(key)
        r = check_app_sample(gen, exact=True, rays=n, K=K,
                             res=row["resolution"], R=R, ndc=ndc)
        emit({"kernel_check": dict(
            r, path=f"{label} its {row['iterations']}")})
        print(f"[k7 {label}] its {row['iterations']} {n} rays x {K} at "
              f"{row['resolution']} R {R}: max rel err "
              f"{max(r['max_rel_err']):.3g} (float64: K7 "
              f"{max(r['f64_rel_err']['k7'][1:7]):.3g}, plain "
              f"{max(r['f64_rel_err']['plain'][1:7]):.3g} on the factor "
              f"gradients), fwd {r['fwd_ms']:.4f} / bwd "
              f"{r['bwd_ms']:.4f} ms, bound {r['fwd_bound_ms']:.4f} / "
              f"{r['bwd_bound_ms']:.4f} ms", flush=True)
        torch.cuda.empty_cache()


def check_binned(H, W, R, N, gen, tol, samples="uniform"):
    """K4 against its plain version on N samples: "uniform" in [-1, 1],
    "march" (2028 rays of N / 2028 samples in march order) or "one_cell"
    (every sample at one point of a 257 x 257 plane whose fractions are
    dyadic, g small integers: every partial sum is exact, so the kernel
    must equal the plain version).  The route runs once under sync debug
    mode "error", which sees its torch calls (allocation, .contiguous) but
    not its ctypes launches; that it never waits on the host is read from
    ops/binned_scatter.py (sizes from N, H, W and R alone, no .item()).
    Times the route (bucketing + accumulate) back to back and, from
    torch.profiler, its kernels' summed device time (device_ms, and by
    kernel); the accumulate kernel alone on a prebuilt bucketing
    (kernel_ms, kernel_device_ms); the plain version; and the library call,
    grid_sample's plane gradient, after checking that it computes the same
    function."""
    import torch
    import torch.nn.functional as F

    from joint_tensorf_tpu_torch.ops import binned_scatter as K

    dev = "cuda"
    if samples == "march":
        x, y = march_points(2028, N // 2028, H, W, gen)
        u, v = x * (2.0 / (W - 1)) - 1.0, y * (2.0 / (H - 1)) - 1.0
    elif samples == "one_cell":     # x = 5.5, y = 7.25 exactly
        if H != 257 or W != 257:
            fail(f"the one-cell case needs a 257 x 257 plane, got {H, W}")
        u = torch.full((N,), 5.5 / 128 - 1, device=dev)
        v = torch.full((N,), 7.25 / 128 - 1, device=dev)
        tol = 0.0
    else:
        u = torch.rand((N,), generator=gen, device=dev) * 2 - 1
        v = torch.rand((N,), generator=gen, device=dev) * 2 - 1
    if samples == "one_cell":
        g = torch.randint(-4, 5, (N, R), generator=gen, device=dev).float()
    else:
        g = torch.randn((N, R), generator=gen, device=dev)
    bins = K.pixel_bins(u, v, H, W)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = K.plane_grad_scatter_cuda(g, *bins, H, W)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = K.plane_grad_scatter_plain(g, *bins, H, W)
    # the library call: grid_sample's gradient w.r.t. its input plane
    plane = torch.zeros((1, R, H, W), device=dev, requires_grad=True)
    grid = torch.stack([u, v], -1)[None, :, None, :]
    out = F.grid_sample(plane, grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    g_lib = g.T.contiguous()[None, :, :, None]

    def lib():
        return torch.autograd.grad(out, plane, g_lib, retain_graph=True)[0]

    lib_grad = lib()[0].permute(1, 2, 0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err_lib = float((lib_grad - want).abs().max())
    scale = float(want.abs().max())
    if not torch.isfinite(got).all() or err > tol * scale:
        fail(f"K4 disagrees with its plain version at {(H, W, R, N)}, "
             f"{samples}: {err:.3g} > {tol} x {scale:.3g}")
    if err_lib > 1e-5 * scale:
        fail(f"grid_sample's plane gradient is not K4's function at "
             f"{(H, W, R, N)}: {err_lib:.3g} > 1e-5 x {scale:.3g}")
    bk, buf = K.bucket_by_tile(bins[0], bins[1], H, W, R)
    # g, u and v read once (8 B per sample), d_plane written once
    b_ms, b_by = bound(N * R * 4 + N * 8 + H * W * R * 4, 8 * N * R)

    def route():
        return K.plane_grad_scatter_cuda(g, *bins, H, W)

    def accumulate():
        return K.accumulate(g, bk, buf, bins[2], bins[3])

    by_kernel = device_times(route)
    return {"name": "binned_plane_scatter", "route": "cuda",
            "source": "joint_tensorf_tpu_torch/csrc/binned_scatter.cu",
            "replaces": "joint_tensorf_tpu/ops/binned_scatter.py:163",
            "launches": None, "max_abs_err": err,
            "tolerance": f"{tol} x max|out| = {tol * scale:.3g}",
            "ms": time_ms(route), "device_ms": sum(by_kernel.values()),
            "device_ms_by_kernel": by_kernel,
            "kernel_ms": time_ms(accumulate),
            "kernel_device_ms": device_ms(accumulate,
                                          "binned_plane_scatter_kernel"),
            "plain_ms": time_ms(
                lambda: K.plane_grad_scatter_plain(g, *bins, H, W)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lib), "library_max_abs_err": err_lib,
            "shape": {"H": H, "W": W, "R": R, "N": N, "samples": samples}}


def check_tiled(N, n_rows, C, gen, tol, case="uniform"):
    """K5 against its plain version (index_add_, also the library call);
    case "uniform" (random rows), "int32" (the same with int32 indices) or
    "one_row" (every sample into one row: one bucket of many chunks; the
    updates are small integers, so both sums are exact and must be equal).
    The route runs once under sync debug mode "error", which sees its
    torch calls (allocation, .contiguous) but not its ctypes launches; that
    it never waits on the host is read from ops/tile_scatter.py (sizes from
    N, n_rows and C alone, no .item()).  Times the route
    (bucketing + accumulate) back to back and, from torch.profiler, its
    kernels' summed device time (device_ms, and by kernel); the accumulate
    kernel alone on a prebuilt bucketing (kernel_ms, kernel_device_ms);
    index_add_; and K3 on the same inputs."""
    import torch

    from joint_tensorf_tpu_torch.ops import segment_scatter as K3
    from joint_tensorf_tpu_torch.ops import tile_scatter as K

    if case == "one_row":
        idx = torch.full((N,), 7, device="cuda")
        upd = torch.randint(-4, 5, (N, C), generator=gen,
                            device="cuda").float()
        tol = 0.0
    else:
        idx = torch.randint(0, n_rows, (N,), generator=gen, device="cuda")
        upd = torch.randn((N, C), generator=gen, device="cuda")
    if case == "int32":
        idx = idx.int()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = K.scatter_add_rows_tiled_cuda(idx, upd, n_rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = K.scatter_add_rows_tiled_plain(idx, upd, n_rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not torch.isfinite(got).all() or err > tol * scale:
        fail(f"K5 disagrees with index_add_ at {(N, n_rows, C, case)}: "
             f"{err:.3g} > {tol} x {scale:.3g}")
    bucketed = K.bucket_by_block(idx, n_rows, C)
    idx64 = idx.long()   # K3 takes int64 indices
    plain = time_ms(lambda: K.scatter_add_rows_tiled_plain(idx, upd, n_rows))
    b_ms, b_by = bound(N * idx.element_size() + N * C * 4 + n_rows * C * 4,
                       N * C)

    def route():
        return K.scatter_add_rows_tiled_cuda(idx, upd, n_rows)

    def accumulate():
        return K.accumulate(upd, *bucketed, n_rows)

    by_kernel = device_times(route)
    return {"name": "scatter_add_rows_tiled", "route": "cuda",
           "source": "joint_tensorf_tpu_torch/csrc/tile_scatter.cu",
           "replaces": "joint_tensorf_tpu/ops/tile_scatter.py:155",
           "launches": None, "max_abs_err": err,
           "tolerance": f"{tol} x max|out| = {tol * scale:.3g}",
           "ms": time_ms(route), "device_ms": sum(by_kernel.values()),
           "device_ms_by_kernel": by_kernel,
           "kernel_ms": time_ms(accumulate),
           "kernel_device_ms": device_ms(accumulate,
                                         "scatter_add_rows_tiled_kernel"),
           "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": plain,
           "k3_ms": time_ms(lambda: K3.scatter_add_rows_cuda(
               idx64, upd, n_rows)),
           "shape": {"N": N, "n_rows": n_rows, "C": C, "case": case}}


def run_entry_points(gen):
    """K4 and K5 lie on no trainer path (in the JAX package either): drive
    each through its own public entry point, with the counters zeroed
    just before and read just after."""
    import torch

    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.ops.binned_scatter import sample_plane_binned
    from joint_tensorf_tpu_torch.ops.tile_scatter import scatter_add_rows_tiled

    H = W = 400
    x, y = march_points(2028, 1000, H, W, gen)
    u = (x * (2.0 / (W - 1)) - 1.0).requires_grad_(True)
    v = (y * (2.0 / (H - 1)) - 1.0).requires_grad_(True)
    plane = torch.randn((H, W, 64), generator=gen, device="cuda",
                        requires_grad=True)
    g = torch.randn((u.shape[0], 64), generator=gen, device="cuda")
    idx = torch.randint(0, 90000, (524288,), generator=gen, device="cuda")
    upd = torch.randn((524288, 64), generator=gen, device="cuda")
    torch.cuda.synchronize()

    cuda_build.reset_launches()
    out = sample_plane_binned(plane, u, v)
    d_plane, d_u, d_v = torch.autograd.grad(out, (plane, u, v), g)
    torch.cuda.synchronize()
    k4 = dict(cuda_build.LAUNCHES)
    cuda_build.reset_launches()
    rows = scatter_add_rows_tiled(idx, upd, 90000)
    torch.cuda.synchronize()
    k5 = dict(cuda_build.LAUNCHES)
    if not all(torch.isfinite(t).all() for t in (d_plane, d_u, d_v, rows)):
        fail("K4/K5 entry points produced non-finite values")
    if k4["binned_plane_scatter"] != 1 or k5["scatter_add_rows_tiled"] != 1:
        fail(f"entry points: K4 launched {k4['binned_plane_scatter']}, K5 "
             f"{k5['scatter_add_rows_tiled']} times, expected 1 each")
    return {"entry_points": {
        "sample_plane_binned": {"shape": [H, W, 64, int(u.shape[0])],
                                "launches": k4},
        "scatter_add_rows_tiled": {"shape": [524288, 90000, 64],
                                   "launches": k5}}}, {
        "binned_plane_scatter": k4["binned_plane_scatter"],
        "scatter_add_rows_tiled": k5["scatter_add_rows_tiled"]}


# ------------------------------------------- small step: card vs the CPU
def _small_setup_vm_config():
    """The small steps' field: ranks 4 / 8, app_dim 9, MLP_Fea with 16
    hidden units (their density factors are raised x 8)."""
    from joint_tensorf_tpu_torch.models import vm as vm_lib

    return vm_lib.VMConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8),
                           app_dim=9, hidden=16)


def _small_setup():
    """The tiny scene, field and draws of the card-vs-CPU steps: a 24^3
    field (ranks 4/8, app_dim 9, density x 8), 3 views of 24 x 24, 64 rays
    a view, a random mask, blur and jitter."""
    import torch

    from joint_tensorf_tpu_torch.data.synthetic import make_scene
    from joint_tensorf_tpu_torch.geometry import lie, poses
    from joint_tensorf_tpu_torch.models import vm as vm_lib
    from joint_tensorf_tpu_torch.models.alpha_mask import AlphaMask
    from joint_tensorf_tpu_torch.render.renderer import BlurSpec
    from joint_tensorf_tpu_torch.train.step import StepConfig, StepScalars

    cfg = _small_setup_vm_config()
    res, V, H, W, R = (24, 24, 24), 3, 24, 24, 64
    scene = make_scene(n_views=V, H=H, W=W, device="cpu")
    gen = torch.Generator().manual_seed(0)
    field = vm_lib.init_vm(cfg, res, [-1.5] * 3 + [1.5] * 3, gen)
    with torch.no_grad():
        for p in list(field.density_planes) + list(field.density_lines):
            p.mul_(8.0)
    noise = torch.randn((V, 6), generator=gen) * 0.05
    pose_base = poses.compose([lie.se3_to_SE3(noise),
                               torch.as_tensor(scene.poses)])
    images = torch.as_tensor(scene.images).reshape(V, 3, -1).transpose(1, 2)
    edges = (torch.rand((V, H * W), generator=gen) > 0.7).float()
    ray_idx = torch.randperm(H * W, generator=gen)[:R]
    mask = AlphaMask(grid=(torch.rand(res, generator=gen) > 0.4).float(),
                     aabb=field.aabb.clone())
    base = StepConfig(H=H, W=W, n_views=V, rays_per_view=R, n_samples=41,
                      blur=BlurSpec("uniform-gaussian", 8))
    s = StepScalars(lr_index=0.02, lr_basis=1e-3, lr_pose=1e-3,
                    c2f_density=0.1, c2f_color=0.2, l1_weight=8e-5,
                    use_edge=1.0, edge_factor=1.5, non_edge_factor=0.5)
    jitter = torch.rand((V * R, 1), generator=gen)
    return dict(cfg=cfg, res=res, V=V, scene=scene, field=field, gen=gen,
                pose_base=pose_base, images=images, edges=edges,
                ray_idx=ray_idx, mask=mask, base=base, s=s, jitter=jitter)


def _small_pair(name, st_kw, field, cfg, scfg, am=None, soft=False):
    """One train step of ``field`` (VMConfig ``cfg``, StepConfig ``scfg``,
    alpha mask ``am``) on the card (kernels) and on the CPU (plain
    versions) from the same state and draws of _small_setup's ``st_kw``;
    fails unless the losses agree to 1e-5 relative and every gradient to
    1e-3 of its leaf's max (2^-7 for a bf16 leaf).  Returns the row."""
    import copy

    import torch

    from joint_tensorf_tpu_torch.models.alpha_mask import AlphaMask
    from joint_tensorf_tpu_torch.ops import sobel
    from joint_tensorf_tpu_torch.train.step import init_train_state, train_step

    k = st_kw
    bf16 = field.density_lines[0].dtype == torch.bfloat16
    out = {}
    for dev in ("cpu", "cuda"):
        f = copy.deepcopy(field).to(dev)
        st = init_train_state(f, k["V"])
        se3 = st.se3_refine.detach().clone()
        mv = lambda t: t.to(dev)  # noqa: E731
        e = (sobel.soft_edge_mask(mv(torch.as_tensor(k["scene"].images)))
             if soft else mv(k["edges"]))
        metrics, grads = train_step(
            st, scfg, cfg, mv(k["pose_base"]),
            mv(torch.as_tensor(k["scene"].intr_inv)),
            mv(k["images"].contiguous()), e, mv(torch.arange(k["V"])),
            mv(k["ray_idx"]), k["s"], jitter=mv(k["jitter"]),
            alpha_mask=None if am is None else AlphaMask(
                grid=mv(am.grid), aabb=mv(am.aabb)), stats=True)
        out[dev] = (float(metrics["loss"]),
                    {n: g.detach().cpu() for n, g in grads.items()},
                    float(metrics["kept_frac"]))
        if not scfg.pose_opt and (
                torch.count_nonzero(grads["se3_refine"]) > 0
                or not torch.equal(st.se3_refine.detach(), se3)):
            fail(f"small step ({name}) on {dev}: the pose table got a "
                 f"gradient or moved without pose optimisation")
        if bf16 and f.density_lines[0].dtype != torch.bfloat16:
            fail(f"small step ({name}): the factors left bfloat16")
    loss_c, g_c, kept = out["cpu"]
    loss_g, g_g, _ = out["cuda"]
    if not math.isfinite(loss_g) or \
            abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        fail(f"small step ({name}): card loss {loss_g} vs CPU {loss_c}")
    worst = over = 0.0      # max |card - CPU| / leaf max; / tolerance
    worst_leaf = None
    for n in g_c:
        scale = float(g_c[n].abs().max()) + 1e-12
        err = float((g_g[n].float() - g_c[n].float()).abs().max())
        tol = 2.0 ** -7 if g_c[n].dtype == torch.bfloat16 else 1e-3
        if err / scale / tol > over:
            worst_leaf = (n, scale)
        worst = max(worst, err / scale)
        over = max(over, err / scale / tol)
    if over > 1.0:
        fail(f"small step ({name}): card gradients differ from the "
             f"CPU's by {worst:.3g} of their max (leaf {worst_leaf[0]}, "
             f"max {worst_leaf[1]:.3g})")
    return {"loss_cuda": loss_g, "loss_cpu": loss_c,
            "max_grad_err_rel": worst, "max_grad_err_over_tol": over,
            "kept_frac": kept, "bf16_factors": bf16,
            "step_config": {n: getattr(scfg, n) for n in (
                "n_samples", "compact_k", "densify_density", "densify_dtype",
                "app_k", "pose_opt", "mlp_predict_density", "stratified",
                "detach_viewdirs", "detach_xyz")}}


def check_small_step():
    """One train step of a tiny field on the card (kernels) and on the CPU
    (plain versions) from the same state and rays (_small_pair), in these
    configurations:
    the dense path under the blur; the blur with in-bbox compaction, the
    dense-grid density and app_k below the gated count; an alpha mask with
    group compaction and app_k; TensoRF's step (no pose optimisation: the
    pose gradient must be exactly zero and the pose table unchanged on
    both); that compacted dense-grid step with bfloat16 factors (gradients
    within 2^-7 of each bf16 leaf's max: a bf16 gradient keeps 8 mantissa
    bits, and a float32 sum in another order can round it one ulp apart);
    and with the dense grid's rows read in bfloat16 (lane's bf16 reads);
    and the dense path under the blur with soft edge masks (soft_edge_mask:
    each device computes the mask from the scene's images;
    sync_2d_3d_scales changes only host-drawn scalars, which the CPU tests
    hold against JAX's draws)."""
    import dataclasses

    import torch

    from joint_tensorf_tpu_torch.models import vm as vm_lib

    k = _small_setup()
    base, field, mask = k["base"], k["field"], k["mask"]
    compacted = dataclasses.replace(base, n_samples=64, compact_k=48,
                                    densify_density=True, app_k=4)
    bf16_field = vm_lib._with_factors(
        field, lambda i, p: p.to(torch.bfloat16),
        lambda i, l: l.to(torch.bfloat16))
    variants = {
        "dense": (base, None, field),
        "bbox_compaction_densify_app_k": (compacted, None, field),
        "mask_compaction_app_k": (dataclasses.replace(
            base, n_samples=64, blur=None, mask_stride=2, compact_k=32,
            app_k=4), mask, field),
        "tensorf_densify_app_k": (dataclasses.replace(
            compacted, blur=None, pose_opt=False), None, field),
        "bf16_factors": (compacted, None, bf16_field),
        "lane_bf16_reads": (dataclasses.replace(
            compacted, densify_dtype="bfloat16"), None, field),
        "soft_edge_mask": (base, None, field)}
    return {"small_step": {
        name: _small_pair(name, k, f, k["cfg"], scfg, am,
                          soft=name == "soft_edge_mask")
        for name, (scfg, am, f) in variants.items()}}


# --------------------------------------------------------------- main path
def run_main_path(n_steps: int, profile_dir=None):
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    opt = set_options(os.path.join(HERE, "configs", "bat_blender_VM.yaml"),
                      ["--data.dataset=synthetic"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = load_dataset(opt, "train", device="cuda")
    t_scene = time.perf_counter() - t0
    trainer = Trainer(opt, data, device="cuda")
    torch.cuda.synchronize()

    stamps, losses = [], []
    expected = {name: 0 for name in cuda_build.LAUNCHES}
    configs = set()

    def on_step(tr, m):
        if m is None:
            return
        configs.add(step_config_summary(tr.last_step_config))
        for name, n in step_launches(tr).items():
            expected[name] += n

    def on_log(tr, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(m["loss"])

    cuda_build.reset_launches()
    stamps.append(time.perf_counter())
    trainer.run(max_iter=n_steps, log_every=1, callback=on_log,
                on_step=on_step)
    launches = dict(cuda_build.LAUNCHES)
    steps = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    if len(losses) != n_steps or not all(math.isfinite(x) for x in losses):
        fail(f"main path: losses {losses}")
    # K4 and K5 lie on no trainer path: 0 launches
    if launches != expected:
        fail(f"main path: launched {launches} in {n_steps} steps, expected "
             f"{expected}")
    if not all(c["densify_density"] for c in map(dict, configs)):
        fail(f"main path: the first phase did not allow the dense grid: "
             f"{configs}")
    result = {
        "main_path": {
            "config": "configs/bat_blender_VM.yaml --data.dataset=synthetic",
            "image_hw": [trainer.H, trainer.W], "views": trainer.n_views,
            "resolution": trainer.resolution, "n_samples": trainer.n_samples,
            "rays_per_step": trainer.rays_per_step,
            "step_configs": [dict(c) for c in configs],
            "budgets": budgets(trainer),
            "steps": n_steps, "loss": losses,
            "step_ms_first": steps[0] * 1e3,
            "step_ms_median": statistics.median(steps[1:]) * 1e3,
            "step_ms_all": [x * 1e3 for x in steps],
            "launches": launches,
            "launches_per_step": {k: v / n_steps for k, v in launches.items()},
            "scene_render_s": t_scene,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}}
    if profile_dir:
        result["profile"] = profile_steps(
            trainer, n_steps + 3,
            os.path.join(profile_dir, "step_profile.txt"))
    return result, launches, (trainer.rays_per_step, trainer.last_step_config,
                              list(trainer.resolution))


def step_config_summary(cfg):
    """The step's tpu: choices, hashable."""
    return tuple((k, getattr(cfg, k)) for k in (
        "n_samples", "compact_k", "densify_density", "app_k"))


def budgets(trainer) -> dict:
    return {k: getattr(trainer, k) for k in (
        "compact_k_bbox", "compact_k_blur", "compact_k", "app_k_dyn")}


def warm_start_density(trainer, seed: int):
    """Raise one density component per object of the synthetic scene (a
    blob, or with data.scene: solids a sphere or box) by WARM_DENSITY over
    a box of +-WARM_RADII radii around its centre (component k of every
    plane over the box's two axes, of every line over its third): the
    density feature there clears the alpha threshold, elsewhere it stays at
    its fresh value, so the first mask update has objects to keep, and rays
    cross empty space between them.  Its masked phases are sparser than a
    trained Blender field's, so the gaps between the paths hold for this
    field only.  A CP field (no planes; its density is the sum over
    components of the three lines' product) gets WARM_CP added to
    component k of each line over the box's extent on that line's axis:
    the feature inside is then about WARM_CP^3 = 3 WARM_DENSITY^2, the
    VM warm start's three plane x line products.  Returns the boxes."""
    import numpy as np
    import torch

    from joint_tensorf_tpu_torch.data.synthetic import BlobField, SolidField
    from joint_tensorf_tpu_torch.models.vm import MAT_MODE, VEC_MODE

    if str(trainer.opt.data.get("scene")) == "solids":
        solids = SolidField(seed=seed)
        objects = zip(solids.centers, solids.sizes)
    else:
        blobs = BlobField(seed=seed)
        objects = zip(blobs.centers, blobs.radii)
    field = trainer.state.field
    cp = len(field.density_planes) == 0
    aabb = field.aabb.cpu().numpy()
    res = field.resolution()
    axes = [np.linspace(aabb[0, a], aabb[1, a], res[a]) for a in range(3)]
    boxes = []
    with torch.no_grad():
        for k, (c, r) in enumerate(objects):
            lo, hi = c - WARM_RADII * r, c + WARM_RADII * r
            inside = [torch.as_tensor((x >= lo[a]) & (x <= hi[a]),
                                      dtype=torch.float32,
                                      device=field.aabb.device)
                      for a, x in enumerate(axes)]
            for i in range(3):
                m0, m1 = MAT_MODE[i]
                if cp:
                    field.density_lines[i][:, k].add_(
                        WARM_CP * inside[VEC_MODE[i]])
                    continue
                field.density_planes[i][..., k].add_(
                    WARM_DENSITY * inside[m1][:, None] * inside[m0][None, :])
                field.density_lines[i][:, k].add_(
                    WARM_DENSITY * inside[VEC_MODE[i]])
            boxes.append([lo.tolist(), hi.tolist()])
    return boxes


def run_all_phases(label: str, extra_args=(), profile_dir=None,
                   yaml="bat_blender_VM.yaml", base_args=PHASES_ARGS,
                   sparse=True, default_path=None):
    """A model at full width through every phase of a schedule cut to 40
    iterations (configs/<yaml> with base_args + extra_args: BAT by
    default, TensoRF and the solids scene with their own).  The scene's
    render is timed (synchronised).  ``sparse``: the warm-started field
    stays sparse over the cut schedule, so the first mask update must
    shrink the box and the default path's masked last phase must compact
    (the blobs; the solids' field fills the box within 12 steps of their
    100 views, and keeps as many live samples a ray as S).  Trainer.run's
    on_step hook
    reads the host clock between synchronised points after each step and
    after each schedule update, so each step and each transition is timed
    on its own, and the launch counters are read after every step and held
    against expected_launches of the step's configuration.  With
    profile_dir, two blurred steps at the last resolution (the dense grid
    of 64M voxels) and the last 3 steps run under torch.profiler and are
    left out of the step times.  Prints one line per phase; returns the
    last step's shape: (rays, samples per ray as composited, resolution,
    the step's configuration, and (samples per ray kept, resolution) of
    the last blurred dense-grid step at the last resolution, or None), and
    (the trainer, its training data).  ``default_path``: hold the run to
    the default tpu: path's checks (masked compaction, the blurred dense
    grid; by default when no extra_args are given), else to the
    alternatives-off checks."""
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.train.l2g_trainer import L2GTrainer
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    args = list(base_args) + list(extra_args)
    opt = set_options(os.path.join(HERE, "configs", yaml), args)
    if default_path is None:
        default_path = not extra_args
    torch.cuda.synchronize()
    t_scene = time.perf_counter()
    data = load_dataset(opt, "train", device="cuda")
    torch.cuda.synchronize()
    t_scene = time.perf_counter() - t_scene
    trainer = (L2GTrainer if opt.model == "l2g_bat" else Trainer)(
        opt, data, device="cuda")
    support = warm_start_density(trainer, int(opt.data.get("seed", 0)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ups = list(opt.train_schedule.upsample_iters)
    masks = list(opt.train_schedule.update_alphamask_iters)

    def state():
        mask = trainer.alpha_mask
        return {"resolution": list(trainer.resolution),
                "n_voxels": int(trainer.n_voxels),
                "n_samples": trainer.n_samples,
                "aabb": trainer.state.field.aabb.cpu().numpy().tolist(),
                "mask_res": (list(trainer.alphamask_resolution)
                             if mask is not None else None),
                "mask_kept": (float(mask.grid.mean())
                              if mask is not None else None),
                **budgets(trainer)}

    steps, transitions = [], []
    clock = {"t": time.perf_counter(), "launches": dict(cuda_build.LAUNCHES)}

    def on_step(tr, m):
        """After each step (m: its metrics) and after each schedule update
        (m None): synchronise, then time the step or the transition alone
        and count the step's launches."""
        torch.cuda.synchronize()
        now, launches = time.perf_counter(), dict(cuda_build.LAUNCHES)
        ms = (now - clock["t"]) * 1e3
        if m is not None:
            before = state()
            cfg = tr.last_step_config
            steps.append({
                "it": tr.it, "step_ms": ms, "blur": bool(m["blur"]),
                # peak since the last transition (reset there)
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                **{k: before[k] for k in ("resolution", "n_samples",
                                          "mask_res")},
                **{k: float(m[k]) for k in ("loss", "valid_frac",
                                            "inbbox_frac", "kept_frac",
                                            "dropped_frac")},
                "config": dict(step_config_summary(cfg)),
                "budgets": budgets(tr),
                "launches": {k: launches[k] - clock["launches"][k]
                             for k in launches},
                "expected": step_launches(tr, tr.vm_cfg)})
        elif tr.it in ups or tr.it in masks:
            after = state()
            transitions.append({
                "after_it": tr.it, "ms": ms, **after,
                "peak_mem_gb_before": torch.cuda.max_memory_allocated() / 1e9})
            print(f"[phase {label}] after it {tr.it}: {json.dumps(after)} "
                  f"({ms:.1f} ms)", flush=True)
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        clock["t"], clock["launches"] = time.perf_counter(), launches

    n_iter = int(opt.max_iter)
    n_timed = n_iter - 3 if profile_dir else n_iter
    # with profile_dir, two blurred steps at the last resolution (after
    # the last upsample and its first step) run under torch.profiler too
    blur_window = (ups[-1] + 2, ups[-1] + 4) if profile_dir else None
    profiled = set(range(n_timed, n_iter))
    t_run = time.perf_counter()
    prof, prof_blur = None, None
    if profile_dir:
        trainer.run(max_iter=blur_window[0], log_every=1, on_step=on_step,
                    stats=True)
        prof_blur = profile_steps(trainer, blur_window[1], os.path.join(
            profile_dir, f"all_phases_{label}_blurred_steps_profile.txt"),
            on_step)
        profiled.update(range(*blur_window))
        clock["t"] = time.perf_counter()
    trainer.run(max_iter=n_timed, log_every=1, on_step=on_step, stats=True)
    t_run = time.perf_counter() - t_run
    if profile_dir:
        prof = profile_steps(trainer, n_iter, os.path.join(
            profile_dir, f"all_phases_{label}_last_steps_profile.txt"),
            on_step)
    peak_last = torch.cuda.max_memory_allocated() / 1e9

    # ---------------- checks (collected; raised after the result is out)
    faults = []
    if len(steps) != n_iter or not all(math.isfinite(r["loss"])
                                       for r in steps):
        faults.append(f"losses {[r.get('loss') for r in steps]}")
    faults += [f"step {r['it']} launched {r['launches']}, expected "
               f"{r['expected']}" for r in steps
               if r["launches"] != r["expected"]]
    by_it = {t["after_it"]: t for t in transitions}
    n_prev = int(opt.train_schedule.n_voxel_init)
    for it in sorted(by_it):
        t = by_it[it]
        if it in ups and t["n_voxels"] <= n_prev:
            faults.append(f"the upsample after it {it} did not grow the "
                          f"grid ({n_prev} -> {t['n_voxels']} voxels)")
        n_prev = t["n_voxels"]
    first, second = by_it[masks[0]], by_it[masks[1]]
    if not 0 < first["mask_kept"] < 1 or (
            sparse and first["aabb"] == [[-1.5] * 3, [1.5] * 3]):
        faults.append(f"the first mask update kept nothing or every "
                      f"voxel, or did not shrink the box: {first}")
    cap = int(opt.tpu.get("mask_cap_voxels", 256 ** 3))
    if math.prod(first["mask_res"]) >= cap:
        faults.append(f"the first mask update was capped: {first}")
    # capped exactly when the grid has reached the cap
    want_capped = math.prod(second["resolution"]) >= cap
    if (math.prod(second["mask_res"]) < math.prod(second["resolution"])) \
            != want_capped:
        faults.append(f"the second mask update was {'not ' * want_capped}"
                      f"capped: {second}")
    gated = [r for r in steps if r["mask_res"] and not r["blur"]]
    if not gated or not any(0 < r["valid_frac"] < r["inbbox_frac"]
                            for r in gated):
        faults.append("the mask culled no sample (or every sample) once "
                      "the blur was off")
    last = [r for r in gated if r["resolution"] == steps[-1]["resolution"]]
    # the dense grid under the blur after the last upsample (64M voxels)
    blurred_last = [r for r in steps if r["blur"]
                    and r["config"]["densify_density"] and r["it"] > ups[-1]]
    if blur_window and not set(range(*blur_window)) <= {
            r["it"] for r in blurred_last}:
        faults.append(f"the profiled steps {list(range(*blur_window))} "
                      f"were not all blurred dense-grid steps at the last "
                      f"resolution")
    if default_path:
        if sparse and not any(
                (r["config"]["compact_k"] or r["n_samples"]) < r["n_samples"]
                for r in last):
            faults.append("no step of the masked last phase compacted "
                          "(compact_k < S)")
        if trainer.is_bat and not blurred_last:
            faults.append("no step under the blur allowed the dense grid "
                          "at the last resolution")
        if not any(r["config"]["densify_density"] for r in steps):
            faults.append("no step used the dense grid")
    elif any(r["config"]["densify_density"] or r["config"]["app_k"]
             or r["budgets"]["compact_k_blur"] is not None
             or (r["config"]["compact_k"] and (r["blur"] or not r["mask_res"]))
             for r in steps):
        # the alpha mask's own budget stays: the JAX trainer has no switch
        # for it (joint_tensorf_tpu/train/trainer.py:874)
        faults.append("a tpu: alternative ran with the alternatives off")

    # ---------------- per-phase step times
    phases = []
    for r in steps:
        if r["it"] in profiled:
            continue
        key = (r["resolution"], r["n_samples"], r["mask_res"], r["blur"],
               r["config"]["compact_k"], r["config"]["densify_density"],
               r["config"]["app_k"])
        if not phases or phases[-1]["key"] != key:
            phases.append({"key": key, "its": [], "ms": [], "kept": [],
                           "valid": [], "dropped": [], "peak": [],
                           "launches": r["launches"],
                           "budgets": r["budgets"]})
        phases[-1]["its"].append(r["it"])
        phases[-1]["ms"].append(r["step_ms"])
        phases[-1]["kept"].append(r["kept_frac"])
        phases[-1]["valid"].append(r["valid_frac"])
        phases[-1]["dropped"].append(r["dropped_frac"])
        phases[-1]["peak"].append(r["peak_gb"])
    rows = []
    for p in phases:
        k = p["key"]
        row = {"resolution": k[0], "n_samples": k[1], "mask_res": k[2],
               "blur": k[3], "compact_k": k[4], "densified": k[5],
               "app_k": k[6], "budgets": p["budgets"],
               "iterations": [p["its"][0], p["its"][-1]],
               "kept_frac": statistics.mean(p["kept"]),
               "valid_frac": statistics.mean(p["valid"]),
               "dropped_frac_max": max(p["dropped"]),
               "launches_per_step": {n: c for n, c in p["launches"].items()
                                     if n in ("composite_fwd",
                                              "composite_bwd",
                                              "scatter_add_rows",
                                              "density_sample_fwd",
                                              "density_sample_bwd",
                                              "app_sample_fwd",
                                              "app_sample_bwd")},
               "step_ms_median": statistics.median(p["ms"]),
               "peak_mem_gb": max(p["peak"]), "step_ms": p["ms"]}
        rows.append(row)
        print(f"[phase-steps {label}] its {row['iterations']} res {k[0]} "
              f"S {k[1]} blur {k[3]} mask {k[2]} budgets {p['budgets']} "
              f"step: compact_k {k[4]} densified {k[5]} app_k {k[6]} "
              f"kept {row['kept_frac']:.3f} live {row['valid_frac']:.3f} "
              f"dropped {row['dropped_frac_max']:.3g} "
              f"launches {row['launches_per_step']} median "
              f"{row['step_ms_median']:.1f} ms peak "
              f"{row['peak_mem_gb']:.2f} GB", flush=True)
    result = {f"all_phases_{label}": {
        "config": f"configs/{yaml} " + " ".join(args),
        "model": opt.model, "image_hw": [trainer.H, trainer.W],
        "views": trainer.n_views, "scene_render_s": t_scene,
        "rays_per_step": trainer.rays_per_step, "run_s": t_run,
        "warm_density": {"add": WARM_DENSITY, "radii": WARM_RADII,
                         "boxes": support},
        "transitions": transitions, "phases": rows,
        "valid_frac_mean_gated": statistics.mean(
            r["valid_frac"] for r in gated) if gated else None,
        "inbbox_frac_mean_gated": statistics.mean(
            r["inbbox_frac"] for r in gated) if gated else None,
        "loss": [r["loss"] for r in steps],
        "peak_mem_gb_last_phase": peak_last,
        "peak_mem_gb": max([peak_last] + [t["peak_mem_gb_before"]
                                          for t in transitions]),
        "profile_blurred_steps": prof_blur,
        "profile_last_steps": prof}}
    emit(result)
    if faults:
        fail(f"all phases ({label}): " + "; ".join(faults))
    if default_path:
        # K6 at each phase's own shape: the first phase's (the main path's),
        # the blurred phases' up to 252^3, the masked ones'
        check_density_at_phases(label, rows, trainer.rays_per_step)
        # K7 at each phase's shape: app_k of the kept slots, or all
        check_app_at_phases(label, rows, trainer.vm_cfg.app_n_comp[0],
                            trainer.rays_per_step)
    cfg = trainer.last_step_config
    blurred = None
    if blurred_last:
        r = blurred_last[-1]
        blurred = (min(r["config"]["compact_k"] or r["n_samples"],
                       r["n_samples"]), r["resolution"])
    return (trainer.rays_per_step,
            min(cfg.compact_k or cfg.n_samples, cfg.n_samples),
            list(trainer.resolution), cfg, blurred, (trainer, data))


def check_solids_render():
    """A 3-view solids render (64x64, 512 samples a ray) on the card and
    on the CPU: within 1e-5 (float32 sums in another order)."""
    import numpy as np

    from joint_tensorf_tpu_torch.data.synthetic import make_scene

    t0 = time.perf_counter()
    card = make_scene(n_views=3, H=64, W=64, kind="solids", device="cuda")
    t_card = time.perf_counter() - t0
    cpu = make_scene(n_views=3, H=64, W=64, kind="solids", device="cpu")
    err = float(np.abs(card.images - cpu.images).max())
    if not np.isfinite(card.images).all() or err > 1e-5:
        fail(f"solids render: card vs CPU {err:.3g} > 1e-5")
    return {"solids_render_card_vs_cpu": {
        "views": 3, "hw": [64, 64], "max_abs_err": err, "tolerance": 1e-5,
        "card_s": t_card, "min_pixel": float(card.images.min())}}


def run_variants():
    """The variants at BAT's widths on the 64M-voxel grid from the start
    (VARIANT_ARGS: blurred steps, the dense grid under the in-bbox budget),
    VARIANT_STEPS steps each from the same seed, on one scene: float32
    factors with float32 dense-grid reads (the lane layout's default),
    bfloat16 factors, and lane's bfloat16 reads.  Per variant: the peak
    memory, the step median (host clock between synchronised points), the
    launches of every step against expected_launches, and the first
    step's loss (the same draws: only the rounding differs, so it stays
    within 1e-2 of float32's).  Then one reset_on_last_upsample transition
    (density re-drawn after the last upsample, 64^3 -> 400^3): the carried
    groups equal the upsampled field's bit for bit, the re-drawn ones are
    new, and the next step launches as its configuration asks."""
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.models import vm as vm_lib
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    cfg_path = os.path.join(HERE, "configs", "bat_blender_VM.yaml")
    data = load_dataset(set_options(cfg_path, VARIANT_ARGS), "train",
                        device="cuda")
    variants = {"float32": [],
                "bf16_factors": ["--tpu.factor_dtype=bfloat16"],
                "lane_bf16_reads": ["--tpu.densify_impl=lane",
                                    "--tpu.densify_dtype=bfloat16"]}
    rows, faults = {}, []
    for name, extra in variants.items():
        opt = set_options(cfg_path, VARIANT_ARGS + extra)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(opt, data, device="cuda")
        stamps, losses, configs, wants = [], [], [], []

        def on_step(tr, m):
            if m is None:
                return
            torch.cuda.synchronize()
            stamps.append((time.perf_counter(), dict(cuda_build.LAUNCHES)))
            losses.append(float(m["loss"]))
            configs.append(tr.last_step_config)
            wants.append(step_launches(tr))

        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), dict(cuda_build.LAUNCHES)))
        trainer.run(max_iter=VARIANT_STEPS, log_every=1, on_step=on_step)
        for (_, a), (_, b), want in zip(stamps[:-1], stamps[1:], wants):
            got = {k: b[k] - a[k] for k in b}
            if got != want:
                faults.append(f"{name}: a step launched {got}, expected "
                              f"{want}")
        ms = [(b - a) * 1e3 for (a, _), (b, _) in zip(stamps[:-1],
                                                      stamps[1:])]
        field = trainer.state.field
        cfg = configs[-1]
        rows[name] = {
            "factor_dtype": str(field.density_planes[0].dtype),
            "densify_dtype": cfg.densify_dtype,
            "resolution": trainer.resolution, "n_samples": cfg.n_samples,
            "compact_k": cfg.compact_k, "densified": cfg.densify_density,
            "blur": cfg.blur is not None, "loss": losses,
            "step_ms_median": statistics.median(ms[1:]), "step_ms": ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "factor_mb": sum(p.numel() * p.element_size() for n, p in
                             field.named_parameters()
                             if field.is_factor(n)) / 1e6}
        if not all(math.isfinite(x) for x in losses) or not all(
                c.densify_density and c.blur is not None for c in configs):
            faults.append(f"{name}: losses {losses} or a step off the "
                          f"blurred dense grid")
        del trainer, field
    ref = rows["float32"]["loss"][0]
    for name, r in rows.items():
        if abs(r["loss"][0] - ref) > 1e-2 * abs(ref):
            faults.append(f"{name}: first loss {r['loss'][0]} vs float32 "
                          f"{ref}")
    if rows["bf16_factors"]["factor_dtype"] != "torch.bfloat16" or \
            rows["lane_bf16_reads"]["densify_dtype"] != "bfloat16":
        faults.append(f"a variant did not run as asked: {rows}")
    for name, r in rows.items():
        print(f"[variants] {name}: factors {r['factor_dtype']} "
              f"({r['factor_mb']:.1f} MB), dense-grid reads "
              f"{r['densify_dtype']}, res {r['resolution']} S "
              f"{r['n_samples']} K {r['compact_k']}: median "
              f"{r['step_ms_median']:.1f} ms, peak {r['peak_mem_gb']:.2f} GB",
              flush=True)

    # ---- one reset_on_last_upsample transition
    torch.cuda.empty_cache()
    opt = set_options(cfg_path, [
        "--data.dataset=synthetic", "--train_schedule.upsample_iters=[1]",
        "--train_schedule.update_alphamask_iters=[1000000]",
        "--train_schedule.reset_on_last_upsample.density=true"])
    trainer = Trainer(opt, data, device="cuda")
    seen = {}

    def on_step(tr, m):
        torch.cuda.synchronize()
        if m is not None and tr.it == 1:
            seen["old"] = tr.state.field
            seen["t"] = time.perf_counter()
            seen["launches"] = dict(cuda_build.LAUNCHES)
        elif m is None and tr.it == 1:
            seen["ms"] = (time.perf_counter() - seen["t"]) * 1e3
        elif m is not None and tr.it == 2:
            seen["step"] = ({k: v - seen["launches"][k] for k, v in
                             cuda_build.LAUNCHES.items()},
                            step_launches(tr),
                            float(m["loss"]))

    trainer.run(max_iter=3, log_every=1, on_step=on_step)
    new = trainer.state.field
    up = vm_lib.upsample(seen["old"], trainer.resolution)
    carried = all(torch.equal(a, b) for g in ("app_planes", "app_lines")
                  for a, b in zip(getattr(new, g), getattr(up, g))) and \
        torch.equal(new.basis, up.basis) and new.shading is up.shading
    redrawn = all(not torch.equal(a, b) and a.shape == b.shape
                  for g in ("density_planes", "density_lines")
                  for a, b in zip(getattr(new, g), getattr(up, g)))
    launches, expected, loss = seen["step"]
    if not (carried and redrawn) or launches != expected or \
            not math.isfinite(loss) or trainer.state.scene_opt.count != 1:
        faults.append(f"reset_on_last_upsample: carried {carried}, "
                      f"re-drawn {redrawn}, launches {launches} vs "
                      f"{expected}, loss {loss}")
    reset = {"resolution": trainer.resolution, "transition_ms": seen["ms"],
             "carried_equal": carried, "redrawn": redrawn,
             "launches_next_step": launches, "loss_next_step": loss}
    print(f"[variants] reset_on_last_upsample (density) after it 1: "
          f"{seen['ms']:.1f} ms to {trainer.resolution}, carried groups "
          f"equal {carried}, density re-drawn {redrawn}", flush=True)
    result = {"variants": {"config": "configs/bat_blender_VM.yaml " +
                           " ".join(VARIANT_ARGS), "steps": VARIANT_STEPS,
                           "runs": rows, "reset_on_last_upsample": reset}}
    emit(result)
    if faults:
        fail("variants: " + "; ".join(faults))
    return rows


# ------------------------------------------------------------ the field zoo
def _zoo_steps(label, args, data, n_steps):
    """A Trainer on configs/bat_blender_VM.yaml with ``args`` for n_steps
    steps through Trainer.run on ``data``, the counters zeroed after each
    schedule update and read after each step: every step's launches
    against expected_launches of its step and field configurations.
    Returns (the row, faults, the trainer)."""
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    opt = set_options(os.path.join(HERE, "configs", "bat_blender_VM.yaml"),
                      args)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(opt, data, device="cuda")
    torch.cuda.synchronize()
    stamps, losses, faults, configs, wants = [], [], [], set(), []

    def on_step(tr, m):
        if m is None:
            cuda_build.reset_launches()
            return
        want = step_launches(tr, tr.vm_cfg)
        wants.append(want)
        configs.add(step_config_summary(tr.last_step_config))
        if dict(cuda_build.LAUNCHES) != want:
            faults.append(f"{label} it {tr.it}: launched "
                          f"{dict(cuda_build.LAUNCHES)}, expected {want}")

    def on_log(tr, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(m["loss"])

    cuda_build.reset_launches()
    stamps.append(time.perf_counter())
    trainer.run(max_iter=n_steps, log_every=1, callback=on_log,
                on_step=on_step)
    steps = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    if len(losses) != n_steps or not all(map(math.isfinite, losses)):
        faults.append(f"{label}: losses {losses}")
    cfg = trainer.last_step_config
    row = {"args": args, "resolution": trainer.resolution,
           "n_samples": cfg.n_samples, "rays_per_step": trainer.rays_per_step,
           "step_configs": [dict(c) for c in configs],
           "launches_per_step": wants[-1],
           "loss": losses, "step_ms_first": steps[0],
           "step_ms_median": statistics.median(steps[1:]),
           "step_ms_all": steps,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[zoo] {label}: res {trainer.resolution} S {cfg.n_samples} "
          f"{dict(step_config_summary(cfg))} K3 "
          f"{row['launches_per_step']['scatter_add_rows']} a step: median "
          f"{row['step_ms_median']:.1f} ms (first {steps[0]:.1f}), peak "
          f"{row['peak_mem_gb']:.2f} GB, launches as configured: "
          f"{not faults}", flush=True)
    return row, faults, trainer


def _signed(field, frac=0.3):
    """The field with every factor minus ``frac`` x its mean magnitude, so
    that some are negative (the variants act on signs)."""
    from joint_tensorf_tpu_torch.models import vm as vm_lib

    def shift(_, t):
        return t - frac * t.abs().mean()

    return vm_lib._with_factors(field, shift, shift)


def check_small_zoo():
    """The card-vs-CPU small step (_small_pair, check_small_step's gates)
    on each new branch: the eight heads (RGB at app_dim 3, SH at 27), CP,
    each VM variant on signed factors (the activation variants at density
    shift -4, which a fresh field's softplus(x - 10) per component would
    leave empty), the density head with predict_density, MLP_Fea with
    detach_viewdirs off, MLP_PE with detach_xyz and detach_viewdirs off,
    and unstratified samples; under the blur on the dense path, and the
    variants, CP and the density head also with in-bbox compaction, the
    dense grid and the two-stage appearance asked for."""
    import dataclasses

    import torch

    from joint_tensorf_tpu_torch.models import vm as vm_lib

    k = _small_setup()
    base = k["base"]
    # app_k at the kept count: a cap below the gated count picks among
    # near-equal weights, which one rounding of the density reorders (on
    # CP's dense grid it parted card and CPU past the gate)
    compacted = dataclasses.replace(base, n_samples=64, compact_k=48,
                                    densify_density=True, app_k=48)

    def field_of(signed=False, **cfg_kw):
        """VM density factors x 8 (check_small_step's); CP density lines
        |l| x 2 + 1, a feature of ~6 (a CP field's signed products of
        0.1 N(0, 1) lines would leave it empty, its gradients sums that
        cancel to nothing)."""
        cfg = dataclasses.replace(k["cfg"], **cfg_kw)
        f = vm_lib.init_vm(cfg, k["res"], [-1.5] * 3 + [1.5] * 3,
                           torch.Generator().manual_seed(1))
        with torch.no_grad():
            for t in f.density_planes:
                t.mul_(8.0)
            for t in f.density_lines:
                if cfg.decomposition == "CP":
                    t.copy_(t.abs() * 2 + 1)
                else:
                    t.mul_(8.0)
        return cfg, _signed(f) if signed else f

    cases = {}
    for head in ZOO_HEADS:
        kw = dict(shading_mode=head)
        kw.update(app_dim=3 if head == "RGB" else 27 if head == "SH" else 9)
        flags = {}
        if head == "MLP_Fea_WeakView_Density":
            flags = dict(mlp_predict_density=True)
        if head == "MLP_PE":
            flags = dict(detach_xyz=False, detach_viewdirs=False)
        cases[head] = (kw, False, [dataclasses.replace(base, **flags)])
    cases["MLP_Fea_WeakView_Density"][2].append(dataclasses.replace(
        compacted, mlp_predict_density=True))
    cases["CP"] = (dict(decomposition="CP"), False, [base, compacted])
    for name, kw in ZOO_SMALL_VARIANTS.items():
        cases[name] = (kw, True, [base, compacted])
    cases["detach_viewdirs_false"] = (
        {}, False, [dataclasses.replace(base, detach_viewdirs=False)])
    cases["stratified_false"] = ({}, False, [dataclasses.replace(
        base, stratified=False)])
    result = {}
    for name, (kw, signed, scfgs) in cases.items():
        cfg, field = field_of(signed, **kw)
        for i, scfg in enumerate(scfgs):
            label = name + ("" if i == 0 else "_densify_app_k")
            result[label] = _small_pair(label, k, field, cfg, scfg)
    worst = max(r["max_grad_err_rel"] for r in result.values())
    print(f"[zoo] small steps card vs CPU: {len(result)} branches, worst "
          f"gradient {worst:.3g} of the leaf max (gate 1e-3)", flush=True)
    return {"small_step_zoo": result}


def run_field_zoo(gen):
    """The field zoo at BAT's widths (step 13 of the module docstring):
    (a) each of ZOO_HEADS on BAT's first phase (configs/bat_blender_VM.yaml
    on the procedural scene: 400x400, 12 views, 2028 rays x 221 samples,
    ranks 16/48, hidden 64, PE 2/2/2), ZOO_STEPS steps; (b) CP at the
    TensoRF paper's CP-384 widths (CP_ARGS) through every phase of
    PHASES_ARGS with run_all_phases' checks on the default path; (c)
    ZOO_VARIANTS on VARIANT_ARGS' blurred 64M-voxel grid, ZOO_STEPS steps
    each; every step's launches against expected_launches; (d) the small
    card-vs-CPU steps of check_small_zoo, then K1/K2/K3 against their plain
    versions at CP's last-phase shapes (and its blurred dense grid) and at
    the density head's.  Prints its wall time; returns its result."""
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.models.vm import MAT_MODE

    t0 = time.perf_counter()
    cfg_path = os.path.join(HERE, "configs", "bat_blender_VM.yaml")
    data = load_dataset(set_options(cfg_path, ["--data.dataset=synthetic"]),
                        "train", device="cuda")
    faults, heads, variants, checks = [], {}, {}, []
    for head, extra in ZOO_HEADS.items():
        row, f, trainer = _zoo_steps(
            head, ["--data.dataset=synthetic",
                   f"--arch.shading.model={head}", *extra], data, ZOO_STEPS)
        heads[head], faults = row, faults + f
        if head == "MLP_Fea_WeakView_Density":
            predict_shape = (trainer.rays_per_step, row["n_samples"],
                             trainer.resolution)
        del trainer
    for name, extra in ZOO_VARIANTS.items():
        row, f, trainer = _zoo_steps(name, VARIANT_ARGS + extra, data,
                                     ZOO_STEPS)
        variants[name], faults = row, faults + f
        del trainer
    if faults:
        emit({"field_zoo": {"heads": heads, "variants": variants}})
        fail("field zoo: " + "; ".join(faults[:4]))
    torch.cuda.empty_cache()
    n_rays, S, res, cfg, blurred, trained = run_all_phases(
        "cp", CP_ARGS, default_path=True)
    del trained
    torch.cuda.empty_cache()
    small = check_small_zoo()
    # K1/K2 and K3 at CP's last phase (the compacted samples; no plane,
    # so K3 only on the blurred phase's dense grid) and at the density
    # head's first phase (ungated K1, the appearance planes' 4 x 48
    # channels on every sample)
    for r in check_composite(n_rays, S, 1e-6, gen, tol=1e-4):
        checks.append(dict(r, path="cp"))
    if blurred:
        checks.append(dict(check_scatter(
            n_rays, blurred[0], 0, 0, 8, gen, tol=1e-5,
            grid3d=tuple(blurred[1])), path="cp"))
    n_p, S_p, res_p = predict_shape
    for r in check_composite(n_p, S_p, float("-inf"), gen, tol=1e-4):
        checks.append(dict(r, path="predict_density"))
    Hp, Wp = max(((res_p[m1], res_p[m0]) for m0, m1 in MAT_MODE),
                 key=lambda hw: hw[0] * hw[1])
    checks.append(dict(check_scatter(n_p, S_p, Hp, Wp, 192, gen, tol=1e-5),
                       path="predict_density"))
    for r in checks:
        emit({"kernel_check": r})
    wall = time.perf_counter() - t0
    print(f"[zoo] field zoo phase: {wall:.1f} s", flush=True)
    return {"field_zoo": {"heads": heads, "variants": variants,
                          "cp_last_phase": {"rays": n_rays, "samples": S,
                                            "resolution": res},
                          "wall_s": wall, **small}}


# ------------------------------------------- evaluation and checkpoints
def _state_leaves(t) -> dict:
    """Every tensor of a trainer's state by name, and the Adam counts."""
    st = t.state
    out = dict(st.field.named_parameters())
    out.update(aabb=st.field.aabb, se3_refine=st.se3_refine,
               pose_grad_accum=st.pose_grad_accum)
    for m in ("mu", "nu"):
        out.update({f"scene_opt.{m}.{k}": v
                    for k, v in getattr(st.scene_opt, m).items()})
        out[f"pose_opt.{m}"] = getattr(st.pose_opt, m)["se3_refine"]
    return out, (st.scene_opt.count, st.pose_opt.count)


def _differing_leaves(a, b) -> list:
    import torch

    (la, ca), (lb, cb) = _state_leaves(a), _state_leaves(b)
    bad = [k for k in la if k not in lb or not torch.equal(la[k], lb[k])]
    return bad + (["adam counts"] if ca != cb else [])


def run_eval_phase(trainer, data):
    """Evaluation on the default path's trained trainer at full width:

    1. checkpoint round trip: save_checkpoint to a temporary directory,
       restore into a fresh Trainer of the same options; every state leaf,
       the mask bits and the torch generator's state equal; the budgets
       restore re-probed (compact_k, app_k_dyn) and the numpy generator
       equal to the saved trainer's after the same probes; one val view
       rendered by both equal bit for bit;
    2. validate on the EVAL_VIEWS val views (sim(3)-aligned poses), the
       launch counters zeroed around each chunk: K1 = 1, K2-K5 = 0;
    3. pose_error and eval_clip_stats;
    4. test-time optimisation of each val view's aligned pose
       (EVAL_TEST_ITER steps, evaluate.py's render config), the counters
       zeroed around each step: K1 = 1, K2 = 1, K3-K5 = 0; finite losses,
       refined poses off their inputs; then K1 against its plain version
       at an eval chunk's shape and K2 (no g_weights) at a step's;
    5. the evaluate entry point in-process on the checkpoint of 1.
    Prints one [eval] line per part; returns {"eval": ...}."""
    import shutil
    import tempfile

    import torch

    from joint_tensorf_tpu_torch import evaluate
    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.geometry import align as align_lib
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.pose.test_optim import (
        make_test_time_optimizer, render_config)
    from joint_tensorf_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    cfg_path = os.path.join(HERE, "configs", "bat_blender_VM.yaml")
    opt = set_options(cfg_path, PHASES_ARGS + EVAL_ARGS)
    val = load_dataset(opt, "val", device="cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    faults, out = [], {}
    try:
        # ---------------- 1. checkpoint round trip
        path = os.path.join(tmp, "model.ckpt.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, trainer)
        save_s = time.perf_counter() - t0
        fresh = Trainer(set_options(cfg_path, PHASES_ARGS), data,
                        device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_checkpoint(path, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bad = _differing_leaves(trainer, fresh)
        if bad:
            faults.append(f"round trip: leaves differ: {bad[:8]}")
        if not (torch.equal(trainer.alpha_mask.grid, fresh.alpha_mask.grid)
                and torch.equal(trainer.alpha_mask.aabb,
                                fresh.alpha_mask.aabb)):
            faults.append("round trip: the mask differs")
        if not torch.equal(trainer.generator.get_state(),
                           fresh.generator.get_state()):
            faults.append("round trip: the torch generator differs")
        budgets = (trainer._probe_compact_k(), trainer._probe_app_k())
        if budgets != (fresh.compact_k, fresh.app_k_dyn) or \
                trainer.rng_np.bit_generator.state != \
                fresh.rng_np.bit_generator.state:
            faults.append(f"round trip: budgets {budgets} vs "
                          f"{(fresh.compact_k, fresh.app_k_dyn)} or the "
                          f"numpy generator differ")
        one = (torch.as_tensor(val.poses[:1], device="cuda"), val.intr[:1],
               torch.as_tensor(val.intr_inv[:1], device="cuda"))
        if not torch.equal(trainer.render_views(*one)[0],
                           fresh.render_views(*one)[0]):
            faults.append("round trip: a val view renders differently")
        del fresh
        torch.cuda.empty_cache()
        out["checkpoint"] = {"save_s": save_s, "restore_s": restore_s,
                             "bytes": os.path.getsize(path),
                             "it": trainer.it, "budgets": list(budgets)}
        print(f"[eval] checkpoint: save {save_s:.2f} s, restore "
              f"{restore_s:.2f} s, {os.path.getsize(path) / 1e6:.1f} MB, "
              f"leaves / mask / generators / budgets / render equal: "
              f"{not faults}", flush=True)

        # ---------------- 2. validate, counters zeroed around each chunk
        expect_chunk = {k: 0 for k in cuda_build.LAUNCHES}
        expect_chunk["composite_fwd"] = 1
        chunks = []

        def on_chunk(i):
            chunks.append(dict(cuda_build.LAUNCHES))
            cuda_build.reset_launches()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        v = trainer.validate(val, on_chunk=on_chunk)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        rcfg = trainer.last_eval_config
        expect_chunk["density_sample_fwd"] = render_k6(rcfg, trainer.vm_cfg)
        expect_chunk["app_sample_fwd"] = render_k7(rcfg, trainer.vm_cfg)
        bad = [c for c in chunks if c != expect_chunk]
        if bad or not chunks:
            faults.append(f"validate: {len(bad)} of {len(chunks)} chunks "
                          f"launched otherwise than {expect_chunk}: "
                          f"{bad[:2]}")
        if not math.isfinite(v["psnr"]):
            faults.append(f"validate: psnr {v['psnr']}")
        out["validate"] = {
            "views": val.n_views, "hw": [val.H, val.W], "psnr": v["psnr"],
            "n_samples": rcfg.n_samples, "eval_compact_k": rcfg.compact_k,
            "dense_grid": rcfg.densify_density, "app_k": rcfg.app_k,
            "chunks": len(chunks), "launches_per_chunk": expect_chunk,
            "ms_per_view": val_s * 1e3 / val.n_views,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"[eval] validate: {val.n_views} views {val.H}x{val.W}, psnr "
              f"{v['psnr']:.3f}, budget {rcfg.compact_k} of S "
              f"{rcfg.n_samples}, dense grid {rcfg.densify_density}, "
              f"{len(chunks)} chunks at K1 1 / K2-K5 0 each, "
              f"{out['validate']['ms_per_view']:.1f} ms per view, peak "
              f"{out['validate']['peak_mem_gb']:.2f} GB", flush=True)

        # ---------------- 3. pose error, clip stats
        err = trainer.pose_error()
        pose, pose_GT = trainer.get_all_training_poses()
        _, sim3 = align_lib.prealign_cameras(pose, pose_GT)
        test_pose = align_lib.align_test_pose(
            torch.as_tensor(val.poses, device="cuda"), sim3)
        intr_inv = torch.as_tensor(val.intr_inv, device="cuda")
        clip = trainer.eval_clip_stats(test_pose, intr_inv)
        if not all(math.isfinite(x) for x in err.values()) or not all(
                math.isfinite(clip[k]) for k in ("compact_clip_rate",
                                                 "app_k_clip_rate")):
            faults.append(f"pose error {err} / clip stats {clip}")
        out["pose_error"], out["clip_stats"] = err, clip
        print(f"[eval] pose error {err}, clip stats {clip}", flush=True)

        # ---------------- 4. test-time optimisation, counters per step
        k6 = render_k6(render_config(trainer), trainer.vm_cfg)
        k7 = render_k7(render_config(trainer), trainer.vm_cfg)
        expect_step = dict(expect_chunk, composite_bwd=1,
                           density_sample_fwd=k6, density_sample_bwd=k6,
                           app_sample_fwd=k7, app_sample_bwd=k7)
        steps = []
        clock = [0.0]

        def on_step(it, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            steps.append({"ms": (now - clock[0]) * 1e3, "loss": float(loss),
                          "launches": dict(cuda_build.LAUNCHES)})
            cuda_build.reset_launches()
            clock[0] = time.perf_counter()

        n_rays = trainer._n_rays()
        optimize = make_test_time_optimizer(
            trainer.vm_cfg, render_config(trainer), val.H, val.W,
            n_rays=n_rays, test_iter=EVAL_TEST_ITER,
            lr_init=float(opt.optim.lr_pose_test),
            lr_end=float(opt.optim.lr_pose_test_end),
            generator=torch.Generator(device="cuda").manual_seed(7),
            on_step=on_step)
        images = torch.as_tensor(val.images, device="cuda").reshape(
            val.n_views, 3, -1).transpose(1, 2)
        moved = []
        for i in range(val.n_views):
            torch.cuda.synchronize()
            cuda_build.reset_launches()
            clock[0] = time.perf_counter()
            p, _ = optimize(trainer.state.field, trainer.alpha_mask,
                            test_pose[i], images[i], intr_inv[i],
                            trainer._near_far())
            moved.append(float((p - test_pose[i]).abs().max()))
        bad = [s["launches"] for s in steps if s["launches"] != expect_step]
        if bad:
            faults.append(f"test-time: {len(bad)} of {len(steps)} steps "
                          f"launched otherwise than {expect_step}: {bad[:2]}")
        if not all(math.isfinite(s["loss"]) for s in steps) or \
                not all(m > 0 for m in moved):
            faults.append(f"test-time: losses {[s['loss'] for s in steps]}, "
                          f"pose moved {moved}")
        step_ms = statistics.median(s["ms"] for s in steps[1:])
        out["test_time"] = {
            "views": val.n_views, "test_iter": EVAL_TEST_ITER,
            "n_rays": n_rays, "n_samples": trainer.n_samples,
            "launches_per_step": expect_step, "step_ms_median": step_ms,
            "step_ms_first": steps[0]["ms"], "pose_moved_max_abs": moved,
            "loss_first_last": [[steps[i * EVAL_TEST_ITER]["loss"],
                                 steps[(i + 1) * EVAL_TEST_ITER - 1]["loss"]]
                                for i in range(val.n_views)]}
        print(f"[eval] test-time: {val.n_views} views x {EVAL_TEST_ITER} "
              f"steps of {n_rays} rays x S {trainer.n_samples}, K1 1 / K2 1 "
              f"/ K3 0 each, median {step_ms:.2f} ms per step", flush=True)

        # ---------------- K1 at an eval chunk's shape (4096 rays at the
        # eval budget), K2 without g_weights at a test-time step's
        gen = torch.Generator(device="cuda").manual_seed(1)
        k1 = check_composite(4096, rcfg.compact_k or rcfg.n_samples, 1e-6,
                             gen, tol=1e-4)[0]
        k2 = check_composite(n_rays, trainer.n_samples, 1e-6, gen,
                             tol=1e-4)[1]
        for r in (k1, k2):
            emit({"kernel_check": r})
        out["kernels_at_eval_shapes"] = {
            r["name"]: {k: r[k] for k in ("shape", "ms", "device_ms",
                                          "plain_ms", "bound_ms")}
            for r in (k1, k2)}
        print(f"[eval] K1 at {k1['shape']}: {k1['device_ms']:.4f} ms device "
              f"(plain {k1['plain_ms']:.3f}, bound {k1['bound_ms']:.4f}); "
              f"K2 at {k2['shape']}: {k2['device_ms']:.4f} (plain "
              f"{k2['plain_ms']:.3f}, bound {k2['bound_ms']:.4f})",
              flush=True)

        # ---------------- 5. the evaluate entry point
        out_root = os.path.join(tmp, "out")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quant = evaluate.main([
            f"--yaml={cfg_path}", *PHASES_ARGS, *EVAL_ARGS, f"--ckpt={path}",
            f"--output_root={out_root}", "--name=chip_smoke",
            f"--optim.test_iter={EVAL_TEST_ITER}", "--generate_video=false",
            "--generate_pose_video=false", "--+tb_logging=false"])
        eval_s = time.perf_counter() - t0
        run_dir = os.path.join(out_root, "default", "chip_smoke")
        with open(os.path.join(run_dir, "quant_eval.json")) as f:
            written = json.load(f)
        with open(os.path.join(run_dir, "quant.txt")) as f:
            per_view = [json.loads(line) for line in f]
        with open(os.path.join(run_dir, "quant_pose.txt")) as f:
            pose_rows = [[float(x) for x in line.split()] for line in f]
        if written != json.loads(json.dumps(quant)) or \
                len(per_view) != val.n_views or \
                len(pose_rows) != trainer.n_views or not all(
                    math.isfinite(written[k]) for k in ("psnr", "ssim")):
            faults.append(f"evaluate: quant_eval {written}, {len(per_view)} "
                          f"views, {len(pose_rows)} pose rows")
        out["evaluate"] = {"s": eval_s, "psnr": written["psnr"],
                           "ssim": written["ssim"],
                           "rot_deg": written["rot_deg"],
                           "trans": written["trans"],
                           "files": sorted(os.listdir(run_dir))}
        print(f"[eval] evaluate entry point: {eval_s:.1f} s, psnr "
              f"{written['psnr']:.3f} ssim {written['ssim']:.4f}, wrote "
              f"quant_pose.txt, quant.txt, quant_eval.json", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = {"eval": out}
    if faults:
        emit(result)
        fail("evaluation: " + "; ".join(faults))
    return result


def check_small_eval():
    """Evaluation of a small state on the card (kernels) and on the CPU
    (plain versions): a CPU trainer with warm density builds its mask (and
    shrinks its box), its checkpoint restores into a card trainer; one
    32 x 32 view rendered by both (render_views) agrees within 1e-5 and
    on the eval budget, and one test-time step's pose gradient
    (pose_loss, evaluate.py's render config, the field frozen) within 1e-3
    of its max."""
    import tempfile

    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.pose.test_optim import (frozen, pose_loss,
                                                         render_config)
    from joint_tensorf_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    args = ["--data.dataset=synthetic", "--data.image_size=[32,32]",
            "--data.n_views=4", "--data.val_sub=1",
            "--train_schedule.n_voxel_init=262144"]
    opt = set_options(os.path.join(HERE, "configs", "bat_blender_VM.yaml"),
                      args)
    trainers, vals = {}, {}
    for dev in ("cpu", "cuda"):
        trainers[dev] = Trainer(opt, load_dataset(opt, "train", device=dev),
                                device=dev)
        vals[dev] = load_dataset(opt, "val", device=dev)
    cpu, card = trainers["cpu"], trainers["cuda"]
    warm_start_density(cpu, int(opt.data.get("seed", 0)))
    cpu._update_alphamask(int(opt.train_schedule.update_alphamask_iters[0]))
    with torch.no_grad():
        cpu.state.se3_refine.copy_(torch.randn(
            cpu.state.se3_refine.shape,
            generator=torch.Generator().manual_seed(3)) * 0.01)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "small.ckpt.npz")
        save_checkpoint(path, cpu)
        restore_checkpoint(path, card)
    val = vals["cpu"]
    rgb, cfgs, grads = {}, {}, {}
    gen = torch.Generator().manual_seed(5)
    ray_idx = torch.randperm(val.H * val.W, generator=gen)[:card._n_rays()]
    jitter = torch.rand((ray_idx.shape[0], 1), generator=gen)
    image = torch.as_tensor(val.images[0]).reshape(3, -1).T
    for dev, t in trainers.items():
        rgb[dev] = t.render_views(torch.as_tensor(val.poses, device=dev),
                                  val.intr, torch.as_tensor(
                                      val.intr_inv, device=dev))[0].cpu()
        cfgs[dev] = t.last_eval_config
        se3 = torch.zeros((1, 6), device=dev, requires_grad=True)
        mv = lambda x: x.to(dev)  # noqa: E731
        with frozen(t.state.field):
            loss = pose_loss(se3, t.state.field, t.vm_cfg, render_config(t),
                             mv(torch.as_tensor(val.poses[0])), mv(image),
                             mv(torch.as_tensor(val.intr_inv[0])),
                             t._near_far(), mv(ray_idx), mv(jitter),
                             t.alpha_mask, val.H, val.W)
            grads[dev] = torch.autograd.grad(loss, [se3])[0].cpu()
    render_err = float((rgb["cuda"] - rgb["cpu"]).abs().max())
    g_err = float((grads["cuda"] - grads["cpu"]).abs().max()) / (
        float(grads["cpu"].abs().max()) + 1e-12)
    result = {"small_eval": {
        "render_max_abs_err": render_err, "pose_grad_err_rel": g_err,
        "eval_compact_k": cfgs["cuda"].compact_k,
        "n_samples": cfgs["cuda"].n_samples, "mask_res":
            list(card.alphamask_resolution)}}
    print(f"[eval] small state card vs CPU: render {render_err:.3g}, pose "
          f"gradient {g_err:.3g} of its max, budget "
          f"{cfgs['cuda'].compact_k} of S {cfgs['cuda'].n_samples}",
          flush=True)
    if render_err > 1e-5 or g_err > 1e-3 or \
            cfgs["cuda"].compact_k != cfgs["cpu"].compact_k or \
            not math.isfinite(render_err + g_err):
        emit(result)
        fail(f"small eval: card vs CPU render {render_err:.3g}, pose "
             f"gradient {g_err:.3g}, budgets {cfgs['cuda'].compact_k} / "
             f"{cfgs['cpu'].compact_k}")
    return result


# ---------------------------------------------------------------- viz
def _imports(name: str) -> bool:
    import importlib

    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


def _check_viz_files(run_dir, printed, snaps, n_views, have) -> list:
    """The files evaluate wrote for the installed packages (``have``:
    imageio, imageio_ffmpeg, matplotlib), or, where one is missing, the
    lines the JAX package's evaluate prints in its place.  -> faults."""
    import numpy as np

    faults = []
    files = set(os.listdir(run_dir))
    frames = os.path.join(run_dir, "novel_views_frames")
    if have["imageio"] and have["imageio_ffmpeg"]:
        if "novel_views.mp4" not in files:
            faults.append("no novel_views.mp4")
    elif have["imageio"]:
        if sorted(os.listdir(frames)) != [f"{i:04d}.png"
                                          for i in range(VIZ_FRAMES)]:
            faults.append(f"novel_views_frames: {os.listdir(frames)}")
    else:
        with np.load(os.path.join(frames, "frames.npz")) as z:
            arrs = [z[k] for k in z.files]
        if len(arrs) != VIZ_FRAMES or any(
                a.shape != (400, 400, 3) or a.dtype != np.uint8
                for a in arrs):
            faults.append(f"frames.npz: {[(a.shape, a.dtype) for a in arrs]}")
    if have["matplotlib"]:
        pose_frames = sorted(os.listdir(os.path.join(run_dir, "poses")))
        if "poses.png" not in files or \
                pose_frames != sorted(f"{it}.png" for it in snaps):
            faults.append(f"pose plot / frames: {sorted(files)}, "
                          f"{pose_frames}")
        video = ("poses.mp4" if have["imageio_ffmpeg"] else "poses_frames"
                 if have["imageio"] else "poses")
        if f"[video] wrote {os.path.join(run_dir, video)}" not in printed:
            faults.append(f"the pose video is not {video}")
    elif "[vis] pose plot skipped: " not in printed or \
            "[video] pose video failed: " not in printed:
        faults.append("no pose-plot skip / pose-video failure line")
    if have["imageio"]:
        dumped = sorted(os.listdir(os.path.join(run_dir, "test_renders")))
        if dumped != [f"rgb_{i}.png" for i in range(min(n_views, 8))]:
            faults.append(f"test_renders: {dumped}")
    elif "[vis] skipped image dump: " not in printed:
        faults.append("no image-dump skip line")
    return faults


def run_viz_phase(trainer, data):
    """viz/ at BAT's full width on the default path's trained trainer
    (after run_eval_phase):

    1. two snapshots into a temporary run directory: model_it{it - 2} of
       the trained state, then two more steps and model_it{it} (also
       model.ckpt.npz);
    2. the evaluate entry point in-process on that directory with both
       videos on (the config's defaults), VIZ_FRAMES frames and
       VIZ_TEST_ITER test-time steps a view; every render_views call is
       observed with the counters zeroed around each 4096-ray chunk (K1 =
       1, K2-K5 = 0) and timed (ms a novel-view frame); the files that the
       installed packages call for (_check_viz_files);
    3. visualize_pose_gradient on training view 0 at 400x400 in chunks of
       GRAD_CHUNK rays, the counters zeroed around each (K1 = 1, K2 = 1,
       K3-K5 = 0): seconds, finite [3, 400, 400] rotation and translation
       maps.
    Prints one [viz] line per part; returns {"viz": ...}."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from joint_tensorf_tpu_torch import evaluate
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.train.checkpoint import save_checkpoint
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    have = {m: _imports(m) for m in ("imageio", "imageio_ffmpeg",
                                     "matplotlib")}
    print(f"[viz] packages that import: {have}", flush=True)
    expect_chunk = {k: 0 for k in cuda_build.LAUNCHES}
    expect_chunk["composite_fwd"] = 1
    tmp = tempfile.mkdtemp(prefix="chip_smoke_viz_")
    faults, out = [], {"packages": have}
    try:
        # ---------------- 1. two snapshots
        run_dir = os.path.join(tmp, "default", "viz")
        os.makedirs(run_dir)
        ckpt = os.path.join(run_dir, "model.ckpt.npz")
        trainer.it -= 2
        snaps = [trainer.it, trainer.it + 2]
        for it in snaps:
            trainer.run(max_iter=it)
            save_checkpoint(ckpt, trainer, snapshot_path=os.path.join(
                run_dir, f"model_it{it}.ckpt.npz"))

        # ---------------- 2. evaluate, every render_views call observed
        calls = []
        render_views = Trainer.render_views

        def observed(self, pose, intr, intr_inv, chunk=4096, on_chunk=None):
            chunks = []

            def on(i):
                chunks.append(dict(cuda_build.LAUNCHES))
                cuda_build.reset_launches()

            torch.cuda.synchronize()
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            r = render_views(self, pose, intr, intr_inv, chunk, on)
            torch.cuda.synchronize()
            rcfg = self.last_eval_config
            calls.append({"views": int(pose.shape[0]),
                          "s": time.perf_counter() - t0, "chunks": chunks,
                          "eval_compact_k": rcfg.compact_k,
                          "dense_grid": rcfg.densify_density,
                          "k6": render_k6(rcfg, self.vm_cfg),
                          "k7": render_k7(rcfg, self.vm_cfg)})
            return r

        buf = io.StringIO()
        Trainer.render_views = observed
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                quant = evaluate.main([
                    f"--yaml={os.path.join(HERE, 'configs', 'bat_blender_VM.yaml')}",
                    *PHASES_ARGS, *EVAL_ARGS, f"--output_root={tmp}",
                    "--name=viz", f"--optim.test_iter={VIZ_TEST_ITER}",
                    f"--video_n_frames={VIZ_FRAMES}", "--+tb_logging=false"])
        finally:
            Trainer.render_views = render_views
        eval_s = time.perf_counter() - t0
        printed = buf.getvalue()
        for line in printed.splitlines():
            if line.startswith(("[video]", "[vis]")):
                print(f"[viz] evaluate: {line}", flush=True)
        with open(os.path.join(run_dir, "quant.txt")) as f:
            n_test = sum(1 for _ in f)
        bad = [c for call in calls for c in call["chunks"]
               if c != dict(expect_chunk, density_sample_fwd=call["k6"],
                            app_sample_fwd=call["k7"])]
        if [c["views"] for c in calls] != [n_test, VIZ_FRAMES] or bad:
            faults.append(f"evaluate: render_views calls "
                          f"{[(c['views'], len(c['chunks'])) for c in calls]}"
                          f", {len(bad)} chunks launched otherwise than "
                          f"{expect_chunk}: {bad[:2]}")
        faults += [f"evaluate: {f}" for f in _check_viz_files(
            run_dir, printed, snaps, n_test, have)]
        frame_ms = calls[-1]["s"] * 1e3 / VIZ_FRAMES if calls else None
        out["evaluate"] = {
            "s": eval_s, "snapshots": snaps, "frames": VIZ_FRAMES,
            "test_iter": VIZ_TEST_ITER, "psnr": quant["psnr"],
            "render_views_calls": [
                dict(c, chunks=len(c["chunks"])) for c in calls],
            "launches_per_chunk": expect_chunk, "ms_per_frame": frame_ms,
            "files": sorted(os.listdir(run_dir))}
        print(f"[viz] evaluate with both videos: {eval_s:.1f} s, "
              f"{VIZ_FRAMES} novel-view frames at {frame_ms:.1f} ms a frame "
              f"(eval budget {calls[-1]['eval_compact_k']}, dense grid "
              f"{calls[-1]['dense_grid']}), "
              f"{sum(len(c['chunks']) for c in calls)} chunks at K1 1 / "
              f"K2-K5 0 each, wrote {sorted(os.listdir(run_dir))}",
              flush=True)

        # ---------------- 3. pose-gradient maps of view 0
        expect_grad = dict(expect_chunk, composite_bwd=1)
        chunks = []

        def on_chunk(i):
            chunks.append(dict(cuda_build.LAUNCHES))
            cuda_build.reset_launches()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        maps = trainer.visualize_pose_gradient(view=0, n_rays_chunk=GRAD_CHUNK,
                                               on_chunk=on_chunk)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        bad = [c for c in chunks if c != expect_grad]
        n_chunks = -(-trainer.H * trainer.W // GRAD_CHUNK)
        if bad or len(chunks) != n_chunks:
            faults.append(f"grad viz: {len(bad)} of {len(chunks)} chunks "
                          f"launched otherwise than {expect_grad}: {bad[:2]}")
        for name, m in zip(("rot", "trans"), maps):
            if m.shape != (3, trainer.H, trainer.W) or \
                    not np.isfinite(m).all() or not np.abs(m).max() > 0:
                faults.append(f"grad viz: {name} map {m.shape}, finite "
                              f"{np.isfinite(m).all()}")
        out["grad_viz"] = {
            "view": 0, "hw": [trainer.H, trainer.W], "chunk": GRAD_CHUNK,
            "chunks": len(chunks), "n_samples": trainer.n_samples,
            "launches_per_chunk": expect_grad, "s": grad_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "max_abs": [float(np.abs(m).max()) for m in maps]}
        print(f"[viz] pose-gradient maps of view 0, {trainer.H}x{trainer.W} "
              f"x S {trainer.n_samples}: {len(chunks)} chunks of "
              f"{GRAD_CHUNK} rays at K1 1 / K2 1 / K3 0 each, {grad_s:.2f} s, "
              f"peak {out['grad_viz']['peak_mem_gb']:.2f} GB", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = {"viz": out}
    if faults:
        emit(result)
        fail("viz: " + "; ".join(faults))
    return result


def check_small_grad_viz():
    """Pose-gradient maps of a small state on the card (K1/K2) and on the
    CPU (plain versions): the CPU trainer's warm-started state (random pose
    refinement) restored into a card trainer; view 0 at 30x30 in chunks of
    GRAD_CHUNK rays (900 pixels: the last chunk pads); each of the six maps
    within 1e-3 of its largest entry."""
    import tempfile

    import numpy as np
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    opt = set_options(os.path.join(HERE, "configs", "bat_blender_VM.yaml"),
                      ["--data.dataset=synthetic", "--data.image_size=[30,30]",
                       "--data.n_views=4",
                       "--train_schedule.n_voxel_init=262144"])
    trainers = {dev: Trainer(opt, load_dataset(opt, "train", device=dev),
                             device=dev) for dev in ("cpu", "cuda")}
    cpu, card = trainers["cpu"], trainers["cuda"]
    warm_start_density(cpu, int(opt.data.get("seed", 0)))
    with torch.no_grad():
        cpu.state.se3_refine.copy_(torch.randn(
            cpu.state.se3_refine.shape,
            generator=torch.Generator().manual_seed(3)) * 0.01)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "small.ckpt.npz")
        save_checkpoint(path, cpu)
        restore_checkpoint(path, card)
    maps = {dev: t.visualize_pose_gradient(view=0, n_rays_chunk=GRAD_CHUNK)
            for dev, t in trainers.items()}
    worst = 0.0
    for g, c in zip(maps["cuda"], maps["cpu"]):
        for i in range(3):
            scale = float(np.abs(c[i]).max())
            worst = max(worst, float(np.abs(g[i] - c[i]).max()) / (
                scale + 1e-30) if scale > 0 else float("inf"))
    result = {"small_grad_viz": {"hw": [cpu.H, cpu.W],
                                 "n_samples": cpu.n_samples,
                                 "max_err_rel": worst}}
    print(f"[viz] small state card vs CPU: pose-gradient maps within "
          f"{worst:.3g} of each map's max", flush=True)
    if not worst <= 1e-3:
        emit(result)
        fail(f"small grad viz: card vs CPU {worst:.3g} of a map's max")
    return result


def run_option_steps():
    """BAT's first phase at full width (configs/bat_blender_VM.yaml on the
    procedural scene) with VIZ_OPTIONS (soft edge masks, one random scale
    for the 2D and 3D blurs) for VIZ_STEPS steps through Trainer.run, the
    counters zeroed before each step and read after it: every step's
    launches against expected_launches (K1 = K2 = 1, K3 = 0, K6 and K7
    once each way: the dense grid allowed does not pay); finite losses;
    the edge masks soft (values strictly between 0 and 1, each view's
    largest 1).  Returns {"option_steps": ...}."""
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    opt = set_options(os.path.join(HERE, "configs", "bat_blender_VM.yaml"),
                      ["--data.dataset=synthetic", *VIZ_OPTIONS])
    trainer = Trainer(opt, load_dataset(opt, "train", device="cuda"),
                      device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps, losses, faults, configs = [], [], [], set()

    def on_step(tr, m):
        if m is None:
            cuda_build.reset_launches()
            return
        want = step_launches(tr)
        configs.add(step_config_summary(tr.last_step_config))
        if dict(cuda_build.LAUNCHES) != want:
            faults.append(f"it {tr.it}: launched {dict(cuda_build.LAUNCHES)},"
                          f" expected {want}")

    def on_log(tr, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(m["loss"])

    cuda_build.reset_launches()
    stamps.append(time.perf_counter())
    trainer.run(max_iter=VIZ_STEPS, log_every=1, callback=on_log,
                on_step=on_step)
    steps = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    if len(losses) != VIZ_STEPS or not all(map(math.isfinite, losses)):
        faults.append(f"losses {losses}")
    soft = [m for sc, m in trainer.edge_masks.items() if sc > 0]
    if not soft or not all(bool(((m > 0) & (m < 1)).any()) and torch.allclose(
            m.max(dim=1).values, torch.ones_like(m[:, 0])) for m in soft):
        faults.append("the edge masks are not soft")
    result = {"option_steps": {
        "options": VIZ_OPTIONS, "steps": VIZ_STEPS, "loss": losses,
        "step_configs": [dict(c) for c in configs],
        "launches_per_step": expected_launches(trainer.last_step_config),
        "step_ms_first": steps[0], "step_ms_median": statistics.median(
            steps[1:]), "step_ms_all": steps,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}}
    print(f"[viz] first phase with {' '.join(VIZ_OPTIONS)}: {VIZ_STEPS} steps"
          f", median {result['option_steps']['step_ms_median']:.1f} ms "
          f"(first {steps[0]:.1f}), launches as configured: {not faults}",
          flush=True)
    if faults:
        emit(result)
        fail("option steps: " + "; ".join(faults[:4]))
    return result


def run_cli_options():
    """The train CLI with --profiling=true on TINY_CLI_ARGS (a trace file
    with device kernels, the CLI back at iteration 8), then the train and
    evaluate CLIs through run_cli with --pdb on a run that succeeds
    (evaluate with its defaults: both videos from the train run's
    snapshots).  Returns {"cli_options": ...}."""
    import shutil
    import tempfile

    from joint_tensorf_tpu_torch import evaluate
    from joint_tensorf_tpu_torch.train import __main__ as train_cli
    from joint_tensorf_tpu_torch.utils import run_cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    args = [f"--yaml={os.path.join(HERE, 'configs', 'bat_blender_VM.yaml')}",
            *TINY_CLI_ARGS, f"--output_root={tmp}"]
    try:
        t0 = time.perf_counter()
        prof = train_cli.main(args + ["--name=prof", "--profiling=true"])
        prof_s = time.perf_counter() - t0
        with open(prof["trace"]) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        t0 = time.perf_counter()
        run_cli(train_cli.main, args + ["--name=pdb", "--pdb"])
        quant = run_cli(evaluate.main, args + ["--name=pdb", "--pdb",
                                               "--optim.test_iter=2"])
        pdb_s = time.perf_counter() - t0
        written = sorted(os.listdir(os.path.join(tmp, "default", "pdb")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = {"cli_options": {
        "profiling": {"iters": prof["iters"], "trace_events": len(events),
                      "kernel_events": kernels, "s": prof_s},
        "pdb": {"s": pdb_s, "psnr": quant["psnr"], "files": written}}}
    print(f"[viz] train CLI --profiling=true: back at it {prof['iters']}, "
          f"trace of {len(events)} events ({kernels} device kernels); both "
          f"CLIs with --pdb: {pdb_s:.1f} s, wrote {written}", flush=True)
    if prof["iters"] != 8 or kernels == 0 or not math.isfinite(
            quant["psnr"]):
        emit(result)
        fail(f"CLI options: {result}")
    return result


# ------------------------------------------------------ L2G-BAT and NDC
def _small_field(cfg, res, gen):
    """A small field drawn from ``gen`` with its density raised."""
    import torch

    from joint_tensorf_tpu_torch.models import vm as vm_lib

    field = vm_lib.init_vm(cfg, res, [-1.5, -1.67, -2.0, 1.5, 1.67, 1.0],
                           gen, init_scale=0.3, init_bias=0.2)
    with torch.no_grad():
        for p in field.density_planes:
            p.mul_(4.0)
    return field


def check_small_l2g_ndc():
    """One small L2G step and one small NDC step on the card (kernels) and
    on the CPU (plain versions) from the same state and draws.  L2G: the
    blob scene, an error map (its Gumbel and cell-jitter uniforms
    pre-drawn), a live warp MLP, the in-bbox compaction with the dense
    grid and app_k under the blur; NDC: the facing scene, MLP_Fea_WeakView
    and relu, setbg_opaque false (the coin pre-drawn), the per-sample
    jitter, TV weights, pin_first_pose, the dense grid.  Loss within 1e-5
    relative, every gradient within 1e-3 of its leaf's max, the updated
    error map and registered poses within 1e-5."""
    import copy
    import dataclasses

    import torch

    from joint_tensorf_tpu_torch.data.synthetic import make_scene
    from joint_tensorf_tpu_torch.geometry import lie, poses
    from joint_tensorf_tpu_torch.models import vm as vm_lib
    from joint_tensorf_tpu_torch.render.renderer import BlurSpec
    from joint_tensorf_tpu_torch.train import l2g
    from joint_tensorf_tpu_torch.train.step import (StepConfig, StepScalars,
                                                    init_train_state,
                                                    train_step)

    gen = torch.Generator().manual_seed(1)
    result = {}
    # ---- L2G
    cfg = vm_lib.VMConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8),
                          app_dim=9, hidden=16)
    lcfg = l2g.L2GConfig(embedding_dim=8, layers_warp=(16, 16, 6),
                         error_map_size=8)
    V, H, W, R = 3, 24, 24, 25
    scene = make_scene(n_views=V, H=H, W=W, device="cpu")
    field = _small_field(cfg, (24, 24, 24), gen)
    noise = torch.randn((V, 6), generator=gen) * 0.05
    pose_base = poses.compose([lie.se3_to_SE3(noise),
                               torch.as_tensor(scene.poses)])
    state0 = l2g.init_l2g_state(field, lcfg, V, pose_base, generator=gen)
    with torch.no_grad():
        state0.warp_mlp.w[-1].normal_(0.0, 0.02, generator=gen)
    images = torch.as_tensor(scene.images).reshape(V, 3, -1).transpose(1, 2)
    edges = (torch.rand((V, H * W), generator=gen) > 0.7).float()
    scfg = StepConfig(H=H, W=W, n_views=V, rays_per_view=R, n_samples=64,
                      blur=BlurSpec("uniform-gaussian", 8), compact_k=48,
                      densify_density=True, app_k=4)
    s = StepScalars(lr_index=0.02, lr_basis=1e-3, lr_pose=1e-3,
                    c2f_density=0.1, c2f_color=0.2, l1_weight=8e-5,
                    use_edge=1.0, edge_factor=1.5, non_edge_factor=0.5)
    draws = l2g.draw_error_map_uniforms(V, 8, R, gen, "cpu")
    jitter = torch.rand((V * R, 1), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        st = copy.deepcopy(state0)
        st.field, st.warp_mlp = st.field.to(dev), st.warp_mlp.to(dev)
        for k in ("warp_embedding", "optimised_poses", "error_map"):
            t = getattr(st, k).detach().to(dev)
            setattr(st, k, t.requires_grad_(k == "warp_embedding"))
        st.scene_opt = l2g.adam_init(dict(st.field.named_parameters()))
        params = l2g.pose_params(st)
        st.pose_opt = l2g.adam_init(params)
        st.pose_grad_accum = {k: torch.zeros_like(p)
                              for k, p in params.items()}
        mv = lambda t: t.to(dev)  # noqa: E731
        m, g = l2g.l2g_train_step(
            st, scfg, lcfg, cfg, mv(pose_base), mv(torch.as_tensor(
                scene.intr)), mv(torch.as_tensor(scene.intr_inv)),
            mv(images.contiguous()), mv(edges), mv(torch.arange(V)),
            mv(torch.arange(R)), s, jitter=mv(jitter),
            error_draws=tuple(mv(d) for d in draws), stats=True)
        out[dev] = (float(m["loss"]), {k: v.detach().cpu()
                                       for k, v in g.items()},
                    st.error_map.cpu(), st.optimised_poses.cpu(),
                    float(m["kept_frac"]))
    result["l2g"] = _compare_small("l2g", out)
    # ---- NDC
    cfg = dataclasses.replace(cfg, shading_mode="MLP_Fea_WeakView",
                              fea2dense="relu", density_shift=0.0)
    scene = make_scene(n_views=V, H=H, W=W, kind="facing", near=0.0,
                       far=1.0, device="cpu")
    field = _small_field(cfg, (24, 26, 24), gen)
    images = torch.as_tensor(scene.images).reshape(V, 3, -1).transpose(1, 2)
    ray_idx = torch.randperm(H * W, generator=gen)[:R]
    scfg = StepConfig(H=H, W=W, n_views=V, rays_per_view=R, n_samples=48,
                      densify_density=True, ndc=True, white_bg=False,
                      pin_first_pose=True)
    s = dataclasses.replace(s, c2f_density=0.0, c2f_color=0.0,
                            near_far=(0.2, 1.0), tv_density_weight=10.0,
                            tv_color_weight=10.0)
    jitter = torch.rand((V * R, 48), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        st = init_train_state(copy.deepcopy(field).to(dev), V)
        with torch.no_grad():
            st.se3_refine.copy_(noise.to(dev) * 0.1)
        mv = lambda t: t.to(dev)  # noqa: E731
        m, g = train_step(
            st, scfg, cfg, mv(torch.as_tensor(scene.poses)),
            mv(torch.as_tensor(scene.intr_inv)), mv(images.contiguous()),
            mv(edges), mv(torch.arange(V)), mv(ray_idx), s,
            jitter=mv(jitter), intr=mv(torch.as_tensor(scene.intr)),
            bg_coin=True, stats=True)
        out[dev] = (float(m["loss"]), {k: v.detach().cpu()
                                       for k, v in g.items()},
                    None, None, float(m["kept_frac"]))
    result["ndc"] = _compare_small("ndc", out)
    return {"small_step_l2g_ndc": result}


def _compare_small(name, out):
    loss_c, g_c, em_c, op_c, kept = out["cpu"]
    loss_g, g_g, em_g, op_g, _ = out["cuda"]
    if not math.isfinite(loss_g) or abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        fail(f"small {name} step: card loss {loss_g} vs CPU {loss_c}")
    worst = 0.0
    for k in g_c:
        scale = float(g_c[k].abs().max()) + 1e-12
        worst = max(worst, float((g_g[k] - g_c[k]).abs().max()) / scale)
    if worst > 1e-3:
        fail(f"small {name} step: card gradients differ from the CPU's by "
             f"{worst:.3g} of their max")
    tables = 0.0
    if em_c is not None:
        tables = max(float((em_g - em_c).abs().max()),
                     float((op_g - op_c).abs().max()))
        if tables > 1e-5:
            fail(f"small {name} step: error map or registered poses differ "
                 f"by {tables:.3g}")
    return {"loss_cuda": loss_g, "loss_cpu": loss_c,
            "max_grad_err_rel": worst, "max_table_err": tables,
            "kept_frac": kept, "n_grads": len(g_c)}


def check_registration_sync():
    """L2G's batched Kabsch fit (rigid_points_registration on [12, 4096, 3]:
    torch.linalg.svd and torch.linalg.det of [12, 3, 3]) under torch's
    sync debug mode "error", the SVD, the determinant and the whole fit's
    backward each alone: which of them synchronise the host.  Also the
    fit's forward + backward time."""
    import torch

    from joint_tensorf_tpu_torch.geometry.align import \
        rigid_points_registration

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((12, 4096, 3), generator=gen, device="cuda",
                    requires_grad=True)
    y = x.detach() * 0.9 + 0.1 * torch.randn((12, 4096, 3), generator=gen,
                                             device="cuda")
    H = torch.randn((12, 3, 3), generator=gen, device="cuda")

    def fwd_bwd():
        R, t = rigid_points_registration(x, y)
        return torch.autograd.grad(R.sum() + t.sum(), [x])

    pieces = {"svd": lambda: torch.linalg.svd(H),
              "det": lambda: torch.linalg.det(H),
              "fit_forward_backward": fwd_bwd}
    syncs = {}
    for name, fn in pieces.items():
        fn()                                        # load the library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            syncs[name] = None
        except RuntimeError as e:
            syncs[name] = str(e).splitlines()[0][:160]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ms = time_ms(fwd_bwd)
    print(f"[l2g] rigid_points_registration [12, 4096, 3] fwd+bwd "
          f"{ms:.3f} ms; under sync debug 'error': "
          + ", ".join(f"{k} {'syncs' if v else 'no sync'}"
                      for k, v in syncs.items()), flush=True)
    return {"batch": 12, "points": 4096, "fwd_bwd_ms": ms,
            "synchronises": {k: v is not None for k, v in syncs.items()},
            "sync_errors": syncs}


def count_host_syncs(trainer, n_steps: int) -> list:
    """Synchronising CUDA calls of each of ``n_steps`` training steps (the
    schedule updates included)."""
    from joint_tensorf_tpu_torch.utils.tracing import count_syncs

    def step():
        trainer.train_iteration()
        trainer._update_schedule()
        trainer.it += 1
    return count_syncs(step, n_steps)


def run_l2g(profile_dir=None):
    """L2G-BAT at BAT's widths (configs/l2g_bat_blender_VM.yaml: 400x400,
    12 views, error map 128^2, warp MLP 64-64-6, embedding 32) through
    every phase of PHASES_ARGS' 40-iteration schedule (run_all_phases'
    checks, launches and per-phase lines, the live fraction against the
    in-bbox budget probed from the registered poses, and the samples the
    budget dropped); the host syncs of 3 steps in its last phase; the
    registration under sync debug "error"; then the solids convergence
    config (configs/l2g_synthetic_convergence.yaml: 128^2, 100 views,
    error map 64^2) for L2G_CONV_STEPS steps."""
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.train.l2g_trainer import L2GTrainer

    out = run_all_phases("l2g", yaml="l2g_bat_blender_VM.yaml",
                         base_args=PHASES_ARGS)
    trainer = out[5][0]
    trainer.it -= 3                  # the last phase's last 3 steps again
    syncs = count_host_syncs(trainer, 3)
    print(f"[l2g] host syncs per step (sync debug 'warn', last phase, "
          f"schedule updates included): {syncs}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    reg = check_registration_sync()

    opt = set_options(os.path.join(HERE, "configs",
                                   "l2g_synthetic_convergence.yaml"), [])
    data = load_dataset(opt, "train", device="cuda")
    trainer = L2GTrainer(opt, data, device="cuda")
    stamps, losses, faults = [], [], []

    def on_step(tr, m):
        if m is None:
            return
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), dict(cuda_build.LAUNCHES)))
        losses.append(float(m["loss"]))
        got = {k: stamps[-1][1][k] - stamps[-2][1][k] for k in
               stamps[-1][1]}
        if got != step_launches(tr):
            faults.append(f"step {tr.it} launched {got}")

    torch.cuda.synchronize()
    stamps.append((time.perf_counter(), dict(cuda_build.LAUNCHES)))
    trainer.run(max_iter=L2G_CONV_STEPS, log_every=1, on_step=on_step)
    ms = [(b - a) * 1e3 for (a, _), (b, _) in zip(stamps[:-1], stamps[1:])]
    if not all(math.isfinite(x) for x in losses):
        faults.append(f"losses {losses}")
    conv = {"config": "configs/l2g_synthetic_convergence.yaml",
            "views": trainer.n_views, "hw": [trainer.H, trainer.W],
            "resolution": trainer.resolution,
            "n_samples": trainer.n_samples, "steps": L2G_CONV_STEPS,
            "loss": losses, "step_ms": ms,
            "step_ms_median": statistics.median(ms[1:]),
            "error_map_size": trainer.l2g_cfg.error_map_size,
            "pose_error": trainer.pose_error()}
    print(f"[l2g] solids convergence config: {L2G_CONV_STEPS} steps, "
          f"median {conv['step_ms_median']:.1f} ms, losses "
          f"{[round(x, 5) for x in losses]}", flush=True)
    emit({"l2g": {"host_syncs_per_step": syncs, "registration": reg,
                  "solids_convergence": conv}})
    if faults:
        fail("l2g: " + "; ".join(faults))
    return out


def run_ndc_route():
    """BAT on the NDC route at configs/bat_llff_VM_MLP.yaml's widths (ranks
    16/20, app_dim 20, WeakView hidden 32, S up to 1000, relu, 50^3 ->
    800^3) on the facing scene (480x640, LLFF_VIEWS views) through
    LLFF_ARGS' 40-iteration schedule: warmup_pose, reset_pose_on_iter, the
    n_rays switch 20480 -> 4096 with the first upsample, the second
    upsample to the final grid, one (capped) mask update, the pose
    accumulation switch.  Every step's launches against its configuration
    (the dense grid in every phase: no budget under NDC), finite losses,
    one line per phase; then LLFF_TEST_ITER test-time steps on 2 views with
    the test-kernel blur rising (optim.test_kernel_schedule LLFF_TEST_KERNEL:
    the configs' [0, 0] blurs nothing), counters around each step (K1 = 1,
    K2 = 1, K3 = 0).  Returns (rays, S, resolution) of the last phase."""
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.pose.test_optim import (
        make_test_time_optimizer, render_config)
    from joint_tensorf_tpu_torch.render.renderer import BlurSpec
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    yaml = os.path.join(HERE, "configs", "bat_llff_VM_MLP.yaml")
    opt = set_options(yaml, LLFF_ARGS)
    torch.cuda.synchronize()
    t_scene = time.perf_counter()
    data = load_dataset(opt, "train", device="cuda")
    torch.cuda.synchronize()
    t_scene = time.perf_counter() - t_scene
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(opt, data, device="cuda")
    steps, faults = [], []
    clock = {"t": time.perf_counter(), "launches": dict(cuda_build.LAUNCHES)}

    def on_step(tr, m):
        torch.cuda.synchronize()
        now, launches = time.perf_counter(), dict(cuda_build.LAUNCHES)
        if m is not None:
            cfg = tr.last_step_config
            steps.append({
                "it": tr.it, "step_ms": (now - clock["t"]) * 1e3,
                "loss": float(m["loss"]), "blur": bool(m["blur"]),
                "resolution": list(tr.resolution), "n_samples": cfg.n_samples,
                "rays": tr.rays_per_step, "densified": cfg.densify_density,
                "compact_k": cfg.compact_k, "app_k": cfg.app_k,
                "mask": tr.alpha_mask is not None,
                "valid_frac": float(m["valid_frac"]),
                "lr_pose": tr._lr_pose(),
                "pose_absmax": float(tr.state.se3_refine.detach().abs()
                                     .max()),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": {k: launches[k] - clock["launches"][k]
                             for k in launches},
                "expected": step_launches(tr)})
        else:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        clock["t"], clock["launches"] = time.perf_counter(), launches

    t_run = time.perf_counter()
    trainer.run(log_every=1, on_step=on_step, stats=True)
    t_run = time.perf_counter() - t_run
    faults += [f"step {r['it']} launched {r['launches']}, expected "
               f"{r['expected']}" for r in steps
               if r["launches"] != r["expected"]]
    if not all(math.isfinite(r["loss"]) for r in steps):
        faults.append(f"losses {[r['loss'] for r in steps]}")
    if not all(r["densified"] and r["compact_k"] is None for r in steps):
        faults.append("a step under NDC left the dense grid or compacted")
    final = steps[-1]["resolution"]
    if math.prod(final) < 400e6 or not steps[-1]["mask"]:
        faults.append(f"the run did not reach the 800^3 grid and its mask: "
                      f"{final}")
    reset = int(opt.train_schedule.reset_pose_on_iter)
    before = [r["pose_absmax"] for r in steps if r["it"] == reset - 1]
    phases = []
    for r in steps:
        key = (tuple(r["resolution"]), r["n_samples"], r["rays"], r["blur"],
               r["mask"])
        if not phases or phases[-1]["key"] != key:
            phases.append({"key": key, "rows": []})
        phases[-1]["rows"].append(r)
    rows = []
    for p in phases:
        rs = p["rows"]
        ms = [r["step_ms"] for r in rs]
        row = {"iterations": [rs[0]["it"], rs[-1]["it"]],
               "resolution": list(p["key"][0]), "n_samples": p["key"][1],
               "rays": p["key"][2], "blur": p["key"][3], "mask": p["key"][4],
               "densified": rs[0]["densified"], "app_k": rs[0]["app_k"],
               "launches_per_step": {k: v for k, v in rs[0]["launches"].items()
                                     if k in ("composite_fwd",
                                              "composite_bwd",
                                              "scatter_add_rows",
                                              "density_sample_fwd",
                                              "density_sample_bwd",
                                              "app_sample_fwd",
                                              "app_sample_bwd")},
               "valid_frac": statistics.mean(r["valid_frac"] for r in rs),
               "step_ms_median": statistics.median(ms), "step_ms": ms,
               "peak_mem_gb": max(r["peak_gb"] for r in rs),
               "lr_pose": [rs[0]["lr_pose"], rs[-1]["lr_pose"]],
               "pose_absmax": rs[-1]["pose_absmax"]}
        rows.append(row)
        print(f"[phase-steps llff] its {row['iterations']} res "
              f"{row['resolution']} S {row['n_samples']} rays {row['rays']} "
              f"blur {row['blur']} mask {row['mask']} dense grid "
              f"{row['densified']} live {row['valid_frac']:.3f} launches "
              f"{row['launches_per_step']} median "
              f"{row['step_ms_median']:.1f} ms peak "
              f"{row['peak_mem_gb']:.2f} GB lr_pose {row['lr_pose']}",
              flush=True)

    # ---- test-time steps with the test-kernel blur
    val = load_dataset(opt, "val", device="cuda")
    optimize = make_test_time_optimizer(
        trainer.vm_cfg, render_config(trainer), trainer.H, trainer.W,
        n_rays=trainer._n_rays(), test_iter=LLFF_TEST_ITER,
        lr_init=float(opt.optim.lr_pose_test),
        lr_end=float(opt.optim.lr_pose_test_end),
        generator=torch.Generator(device="cuda").manual_seed(7),
        blur=BlurSpec("uniform-gaussian", int(opt.c2f_kernel_size)),
        test_kernel_schedule=LLFF_TEST_KERNEL,
        on_step=lambda it, loss: test_steps.append(
            (torch.cuda.synchronize() or time.perf_counter(),
             dict(cuda_build.LAUNCHES))))
    V, H, W = 2, trainer.H, trainer.W
    target = torch.as_tensor(val.images[:V], device="cuda").reshape(
        V, 3, -1).transpose(1, 2)
    test_rows = []
    for i in range(V):
        torch.cuda.synchronize()
        test_steps = [(time.perf_counter(), dict(cuda_build.LAUNCHES))]
        _, loss = optimize(
            trainer.state.field, trainer.alpha_mask,
            torch.as_tensor(val.poses[i], device="cuda"), target[i],
            torch.as_tensor(val.intr_inv[i], device="cuda"),
            trainer._near_far(), intr=torch.as_tensor(val.intr[i],
                                                      device="cuda"))
        per = [{k: b[1][k] - a[1][k] for k in b[1]}
               for a, b in zip(test_steps[:-1], test_steps[1:])]
        k6 = render_k6(render_config(trainer), trainer.vm_cfg, blur=True)
        k7 = render_k7(render_config(trainer), trainer.vm_cfg, blur=True)
        want = {"composite_fwd": 1, "composite_bwd": 1,
                "scatter_add_rows": 0, "binned_plane_scatter": 0,
                "scatter_add_rows_tiled": 0, "density_sample_fwd": k6,
                "density_sample_bwd": k6, "app_sample_fwd": k7,
                "app_sample_bwd": k7}
        if any(p != want for p in per) or not math.isfinite(loss):
            faults.append(f"test-time view {i}: launches {per[:2]}, loss "
                          f"{loss}")
        ms = [(b[0] - a[0]) * 1e3
              for a, b in zip(test_steps[:-1], test_steps[1:])]
        test_rows.append({"view": i, "final_loss": loss,
                          "step_ms_median": statistics.median(ms[1:]),
                          "launches_per_step": per[-1]})
    print(f"[llff] test-time with the test-kernel blur "
          f"{LLFF_TEST_KERNEL}: {LLFF_TEST_ITER} steps a view, median "
          f"{[round(r['step_ms_median'], 1) for r in test_rows]} ms, "
          f"launches {test_rows[0]['launches_per_step']}", flush=True)
    n_rays, S, res = trainer.rays_per_step, trainer.n_samples, \
        list(trainer.resolution)
    app_rank = trainer.vm_cfg.app_n_comp[0]
    del trainer
    torch.cuda.empty_cache()
    emit({"llff_route": {
        "config": "configs/bat_llff_VM_MLP.yaml " + " ".join(LLFF_ARGS),
        "views": data.n_views, "image_hw": [data.H, data.W],
        "scene_render_s": t_scene, "run_s": t_run, "phases": rows,
        "pose_absmax_before_reset": before,
        "loss": [r["loss"] for r in steps], "test_time": test_rows}})
    if faults:
        fail("llff route: " + "; ".join(faults))
    # K6 and K7 at each LLFF phase's shape (NDC rays; at 771 x 859 x 771
    # K6's line gradients go to global memory)
    check_density_at_phases("llff", rows, ndc=True)
    check_app_at_phases("llff", rows, app_rank, ndc=True)
    return n_rays, S, res


def run_llff_final_grid():
    """3 steps at the LLFF config's final grid (800^3 voxels: 771 x 859 x
    771, S = 1000) from the start, as VARIANT_ARGS does for 64M voxels,
    at the first ray count of LLFF_FINAL_RAYS that fits in the card's
    memory (a count that does not fit prints its failed allocation and
    the next is tried): the published first phase's 20480 rays never
    meets this grid (the n_rays switch to 4096 comes with the first
    upsample), so this is the largest step the config could ask of it,
    19.44M samples: K6 once each way for the density and K7 once each
    way for the appearance, no K3; then K6 and K7 against their plain
    versions at that shape.  Returns (rays, S, resolution) of the steps
    that ran."""
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    yaml = os.path.join(HERE, "configs", "bat_llff_VM_MLP.yaml")
    base = [a for a in LLFF_ARGS if not a.startswith(
        ("--train_schedule.upsample_iters", "--train_schedule.update_alpha",
         "--max_iter"))]
    base += ["--train_schedule.n_voxel_init=512000000",
             "--train_schedule.upsample_iters=[1000000]",
             "--train_schedule.update_alphamask_iters=[1000000]"]
    data = load_dataset(set_options(yaml, base), "train", device="cuda")
    tried = []
    for n_rays in LLFF_FINAL_RAYS:
        opt = set_options(yaml, base + [
            f"--train_schedule.n_rays_init={n_rays}"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(opt, data, device="cuda")
        stamps = []
        try:
            for _ in range(3):
                torch.cuda.synchronize()
                stamps.append((time.perf_counter(),
                               dict(cuda_build.LAUNCHES)))
                m = trainer.train_iteration()
                trainer._update_schedule()
                trainer.it += 1
                float(m["loss"])
            torch.cuda.synchronize()
            stamps.append((time.perf_counter(), dict(cuda_build.LAUNCHES)))
        except torch.cuda.OutOfMemoryError as e:
            tried.append({"rays": trainer.rays_per_step, "fits": False,
                          "peak_gb_before_failure":
                          torch.cuda.max_memory_allocated() / 1e9,
                          "error": str(e).splitlines()[0][:160]})
            print(f"[llff-800] {trainer.rays_per_step} rays x "
                  f"{trainer.n_samples} samples at {trainer.resolution}: "
                  f"out of memory ({tried[-1]['error']})", flush=True)
            del trainer
            continue
        cfg = trainer.last_step_config
        ms = [(b[0] - a[0]) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
        per = [{k: b[1][k] - a[1][k] for k in b[1]}
               for a, b in zip(stamps[:-1], stamps[1:])]
        res = list(trainer.resolution)
        row = {"rays": trainer.rays_per_step, "fits": True,
               "resolution": res, "n_samples": cfg.n_samples,
               "voxels": math.prod(res), "densified": cfg.densify_density,
               "blur": cfg.blur is not None, "step_ms": ms,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": per, "loss": float(m["loss"]),
               "packed_grid_gb": math.prod(res) * 8 * 4 / 1e9}
        tried.append(row)
        print(f"[llff-800] {row['rays']} rays x {row['n_samples']} samples "
              f"at {res} ({row['voxels'] / 1e6:.1f}M voxels, packed grid "
              f"{row['packed_grid_gb']:.1f} GB): steps "
              f"{[round(x, 1) for x in ms]} ms, peak {row['peak_gb']:.2f} "
              f"GB, launches {per[-1]}", flush=True)
        want = expected_launches(cfg)
        if any(p != want for p in per) or not math.isfinite(row["loss"]):
            fail(f"llff 800^3: launches {per} vs {want}, loss "
                 f"{row['loss']}")
        n_rays, S = trainer.rays_per_step, cfg.n_samples
        app_rank = trainer.vm_cfg.app_n_comp[0]
        del trainer
        torch.cuda.empty_cache()
        emit({"llff_final_grid": tried})
        # K6 at these steps' shape, every slot live (the most it can
        # sample here), its line gradients in global memory
        llff_800 = [{"iterations": [0, 2], "resolution": res,
                     "n_samples": S, "rays": n_rays, "valid_frac": 1.0,
                     "launches_per_step": per[-1]}]
        check_density_at_phases("llff_800", llff_800, ndc=True)
        check_app_at_phases("llff_800", llff_800, app_rank, ndc=True)
        return n_rays, S, res
    emit({"llff_final_grid": tried})
    fail("llff 800^3: no ray count fit")


# ------------------------------------------------- BARF / MLP-NeRF, planar
def mlp_step_flops(cfg, n_points: int) -> float:
    """Float32 operations of one MLP-NeRF step on ``n_points`` samples: 2
    per MAC of every layer in the forward, 4 in the backward (the
    weights' and the inputs' gradients)."""
    dims = [cfg.input_3d_dim] + list(cfg.layers_feat)
    macs = 0
    for li in range(len(dims) - 1):
        k_in = dims[li] + (cfg.input_3d_dim if li in cfg.skip else 0)
        k_out = dims[li + 1] + (1 if li == len(dims) - 2 else 0)
        macs += k_in * k_out
    rdims = [cfg.layers_feat[-1] + (cfg.input_view_dim if cfg.view_dep
                                    else 0)] + list(cfg.layers_rgb)
    macs += sum(a * b for a, b in zip(rdims[:-1], rdims[1:]))
    return 6.0 * macs * n_points


def _no_launches(label, launches, faults):
    if launches != NO_LAUNCHES:
        faults.append(f"{label}: launched {launches}, expected none of "
                      f"K1-K7")


def run_mlp_nerf(yaml: str, extra=()):
    """BARF / MLP-NeRF at the config's widths through the train and
    evaluation entry points: MLP_STEPS steps of BarfTrainer.run (step ms,
    the bound of the coarse MLP's operations, peak memory), the host syncs
    of 3 more steps, validate on 2 views (ms a view), with BARF
    MLP_TEST_ITER test-time steps on each of 2 views; the counters zeroed
    before and read after each piece: K1-K7 launch 0 times."""
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.pose.test_optim import \
        make_barf_test_time_optimizer
    from joint_tensorf_tpu_torch.train.barf_trainer import BarfTrainer
    from joint_tensorf_tpu_torch.utils.tracing import count_syncs

    opt = set_options(os.path.join(HERE, "configs", yaml),
                      MLP_ARGS + list(extra))
    data = load_dataset(opt, "train", device="cuda")
    val = load_dataset(opt, "val", device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = BarfTrainer(opt, data, device="cuda")
    faults, stamps, losses = [], [], []

    def on_log(tr, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(m["loss"])

    torch.cuda.synchronize()
    cuda_build.reset_launches()
    stamps.append(time.perf_counter())
    trainer.run(max_iter=MLP_STEPS, log_every=1, callback=on_log)
    _no_launches(f"{yaml} train", dict(cuda_build.LAUNCHES), faults)
    ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    if not all(math.isfinite(x) for x in losses):
        faults.append(f"{yaml}: losses {losses}")
    n_rays = trainer.n_views * (int(opt.nerf.n_rays) // trainer.n_views)
    # every MLP call: the coarse samples, and the fine MLP's S + n_fine
    points = n_rays * (trainer.n_samples + (
        trainer.n_samples + trainer.n_fine if trainer.fine_sampling else 0))
    bound_ms = mlp_step_flops(trainer.mlp_cfg, points) / \
        PEAK_F32_FLOP_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9

    def step():
        trainer.train_iteration()
        trainer.it += 1

    sync_lines = {}
    syncs = count_syncs(step, 3, sync_lines)
    val_times = []
    cuda_build.reset_launches()
    for i in range(val.n_views):
        sub = dataclasses.replace(val, images=val.images[i:i + 1],
                                  poses=val.poses[i:i + 1],
                                  intr=val.intr[i:i + 1],
                                  intr_inv=val.intr_inv[i:i + 1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psnr = trainer.validate(sub)["psnr"]
        val_times.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(psnr):
            faults.append(f"{yaml}: val psnr {psnr}")
    _no_launches(f"{yaml} validate", dict(cuda_build.LAUNCHES), faults)
    row = {"config": f"configs/{yaml} " + " ".join(MLP_ARGS + list(extra)),
           "model": opt.model, "image_hw": [trainer.H, trainer.W],
           "views": trainer.n_views, "rays_per_step": n_rays,
           "samples": [trainer.n_samples, trainer.n_fine],
           "fine_sampling": trainer.fine_sampling,
           "density_noise": trainer.density_noise,
           "steps": MLP_STEPS, "loss": losses,
           "step_ms_first": ms[0], "step_ms_median": statistics.median(ms[1:]),
           "mlp_points": points, "bound_ms": bound_ms,
           "bound_ratio": statistics.median(ms[1:]) / bound_ms,
           "peak_mem_gb": peak, "host_syncs_per_step": syncs,
           "host_sync_lines": sync_lines, "val_ms_per_view": val_times,
           "pose_error": trainer.pose_error() if trainer.is_barf else None}
    if trainer.is_barf:
        test_steps = []
        optimize = make_barf_test_time_optimizer(
            trainer, trainer.H, trainer.W, int(opt.nerf.n_rays),
            MLP_TEST_ITER, float(opt.optim.lr_pose),
            generator=torch.Generator(device="cuda").manual_seed(7),
            on_step=lambda it, loss: test_steps.append(
                torch.cuda.synchronize() or time.perf_counter()))
        target = torch.as_tensor(val.images, device="cuda").reshape(
            val.n_views, 3, -1).transpose(1, 2)
        cuda_build.reset_launches()
        losses_t, per = [], []
        for i in range(val.n_views):
            torch.cuda.synchronize()
            test_steps[:] = [time.perf_counter()]
            _, loss = optimize(torch.as_tensor(val.poses[i], device="cuda"),
                               target[i], torch.as_tensor(val.intr[i],
                                                          device="cuda"),
                               torch.as_tensor(val.intr_inv[i],
                                               device="cuda"))
            losses_t.append(loss)
            per += [(b - a) * 1e3
                    for a, b in zip(test_steps[1:-1], test_steps[2:])]
        _no_launches(f"{yaml} test-time", dict(cuda_build.LAUNCHES), faults)
        row["test_time"] = {"views": val.n_views, "steps": MLP_TEST_ITER,
                            "final_loss": losses_t,
                            "step_ms_median": statistics.median(per)}
        if not all(math.isfinite(x) for x in losses_t):
            faults.append(f"{yaml}: test-time losses {losses_t}")
    print(f"[{opt.model}] {MLP_STEPS} steps at {n_rays} rays x "
          f"{trainer.n_samples}+{trainer.n_fine} samples: median "
          f"{row['step_ms_median']:.2f} ms (MLP bound {bound_ms:.2f} ms, "
          f"x{row['bound_ratio']:.1f}), peak {peak:.2f} GB, host syncs "
          f"{syncs} {sync_lines}, val {[round(t, 1) for t in val_times]} "
          f"ms a view"
          + (f", test-time step {row['test_time']['step_ms_median']:.2f} ms"
             if "test_time" in row else ""), flush=True)
    del trainer
    torch.cuda.empty_cache()
    emit({"mlp_nerf": row})
    if faults:
        fail("; ".join(faults))
    return row


def run_planar():
    """The three planar configs at their widths through PlanarTrainer.run:
    PLANAR_STEPS steps each (step ms, peak memory, host syncs of 3 more
    steps, warp_error, the counters zeroed before and read after: K1-K7
    launch 0 times), and whether torch.linalg.matrix_exp of the 5
    homographies synchronises the host (sync debug "error")."""
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.geometry import warp2d
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.train.planar_trainer import PlanarTrainer
    from joint_tensorf_tpu_torch.utils.tracing import count_syncs

    rows, faults = [], []
    for yaml in PLANAR_CFGS:
        opt = set_options(os.path.join(HERE, "configs", yaml), [])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = PlanarTrainer(opt, device="cuda")
        stamps, losses = [], []

        def on_log(t, m):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            losses.append(m["loss"])

        torch.cuda.synchronize()
        cuda_build.reset_launches()
        stamps.append(time.perf_counter())
        tr.run(max_iter=PLANAR_STEPS, log_every=1, callback=on_log)
        _no_launches(f"planar {yaml}", dict(cuda_build.LAUNCHES), faults)
        ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not all(math.isfinite(x) for x in losses):
            faults.append(f"planar {yaml}: losses {losses}")

        def step():
            tr.train_iteration()
            tr.it += 1

        sync_lines = {}
        syncs = count_syncs(step, 3, sync_lines)
        row = {"config": f"configs/{yaml}", "model": opt.model,
               "image_hw": [tr.H, tr.W], "patches": tr.B,
               "crop": [tr.H_crop, tr.W_crop], "warp": tr.warp_type,
               "steps": PLANAR_STEPS, "loss_first_last": [losses[0],
                                                         losses[-1]],
               "sigma_first_last": [tr.metrics_history[0]["sigma"],
                                    tr.metrics_history[-1]["sigma"]],
               "step_ms_first": ms[0],
               "step_ms_median": statistics.median(ms[1:]),
               "peak_mem_gb": peak, "host_syncs_per_step": syncs,
               "host_sync_lines": sync_lines, "warp_error": tr.warp_error()}
        rows.append(row)
        print(f"[planar] {opt.model} ({yaml}): {PLANAR_STEPS} steps, median "
              f"{row['step_ms_median']:.2f} ms, peak {peak:.3f} GB, host "
              f"syncs {syncs} {sync_lines}, warp_error "
              f"{row['warp_error']:.4f}, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
        del tr
    h = torch.randn((5, 8), device="cuda") * 0.1
    warp2d.sl3_to_SL3(h)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        warp2d.sl3_to_SL3(h)
        expm_sync = None
    except RuntimeError as e:
        expm_sync = str(e).splitlines()[0][:160]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"[planar] matrix_exp of [5, 3, 3] under sync debug 'error': "
          f"{'syncs: ' + expm_sync if expm_sync else 'no sync'}", flush=True)
    emit({"planar": rows, "matrix_exp_synchronises": expm_sync is not None,
          "matrix_exp_sync_error": expm_sync})
    if faults:
        fail("; ".join(faults))
    return rows


def _grad_dist(a, b) -> dict:
    """Loss distance (relative) and the worst leaf's gradient distance
    relative to that leaf's max, with the leaf's name."""
    (loss_a, g_a), (loss_b, g_b) = a, b
    rel = {k: float((g_b[k] - g_a[k]).abs().max())
           / (float(g_a[k].abs().max()) + 1e-12) for k in g_a}
    worst = max(rel, key=rel.get)
    return {"loss_rel": abs(loss_b - loss_a) / abs(loss_a),
            "max_grad_err_rel": rel[worst], "leaf": worst}


def check_small_mlp_planar():
    """One small step of BARF with fine sampling, density noise and NDC
    rays, and of each planar image, on the card and on the CPU from the
    same parameters and draws: the loss and every gradient."""
    import numpy as np
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.convert import (simple_state_from_numpy,
                                                 simple_to_numpy)
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.train.barf_trainer import BarfTrainer
    from joint_tensorf_tpu_torch.train.planar_trainer import PlanarTrainer

    def copy(src, dst):
        dst.params, dst.opt_state = simple_state_from_numpy(
            simple_to_numpy(src.params, src.opt_state), device=dst.device)

    def grads(loss, params):
        """(loss, {leaf: gradient on the CPU})."""
        names = list(params)
        g = torch.autograd.grad(loss, [params[k] for k in names],
                                allow_unused=True)
        return float(loss.detach()), {
            k: (torch.zeros_like(params[k]) if x is None else x).cpu()
            for k, x in zip(names, g)}

    def compare(name, cpu, card):
        """_compare_small's loss and gradient gates (no tables here)."""
        return _compare_small(name, {"cpu": cpu + (None, None, None),
                                     "cuda": card + (None, None, None)})

    out = {}
    opt = set_options(os.path.join(HERE, "configs", "barf_blender.yaml"), [
        "--data.dataset=synthetic", "--data.scene=facing",
        "--camera.ndc=true", "--nerf.depth.range=[0,1]",
        "--data.image_size=[32,32]", "--data.n_views=4",
        "--nerf.n_rays=256", "--nerf.fine_sampling=true",
        "--+nerf.sample_intvs_fine=64", "--nerf.density_noise_reg=1",
        "--+loss_weight.render_fine=0", "--max_iter=20"])
    data = load_dataset(opt, "train", device="cpu")
    cpu = BarfTrainer(opt, data, device="cpu")
    card = BarfTrainer(opt, data, device="cuda")
    copy(cpu, card)
    card.pose_noise = cpu.pose_noise.cuda()
    card.pose_base = cpu.pose_base.cuda()
    view_sel, ray_idx = (torch.as_tensor(a) for a in cpu._sample_rays())
    draws = cpu.draw(len(view_sel) * len(ray_idx))

    def barf_grads(tr, params=None):
        d = {k: v.to(tr.device) for k, v in draws.items()}
        if params is not None:
            tr.params, kept = params, tr.params
        loss, _ = tr.loss(view_sel.to(tr.device), ray_idx.to(tr.device),
                          tr.progress, d)
        g = grads(loss, tr.params)
        if params is not None:
            tr.params = kept
        return g

    # gated at progress 0 (the c2f weights all 0); inside the c2f window
    # (progress 0.3) the fresh MLP's float32 gradients are ill-conditioned:
    # there the card's distance from the CPU is reported beside the CPU's
    # own change under a 1e-7 relative perturbation of the weights
    cpu.it = card.it = 0
    out["barf_fine_ndc"] = compare(
        "barf", *[barf_grads(tr) for tr in (cpu, card)])
    cpu.it = card.it = 6
    ref, got = barf_grads(cpu), barf_grads(card)
    noise = torch.Generator().manual_seed(1)
    perturbed = barf_grads(cpu, {
        k: (v.detach() * (1 + 1e-7 * torch.randn(v.shape, generator=noise))
            ).requires_grad_(True) for k, v in cpu.params.items()})
    out["barf_fine_ndc_progress_0.3"] = {
        "card_vs_cpu": _grad_dist(ref, got),
        "cpu_vs_cpu_perturbed_1e-7": _grad_dist(ref, perturbed)}
    for yaml, extra in (("planar_bat.yaml", ["--arch.resolution=[96,96]",
                                             "--arch.max_ranks=16",
                                             "--arch.kernel_size=32",
                                             "--c2f_schedule.rank=[16]",
                                             "--c2f_schedule.kernel_t=[8,0]"]),
                        ("planar_fft.yaml", ["--arch.resolution=[60,60]",
                                             "--arch.kernel_size=32",
                                             "--c2f_schedule.kernel_t=[8,0]"]),
                        ("planar_barf.yaml", ["--arch.layers=[null,64,64,3]",
                                              "--barf_c2f=[0.1,0.5]"])):
        popt = set_options(os.path.join(HERE, "configs", yaml), [
            "--data.image_size=[72,96]", "--data.patch_crop=[36,36]",
            "--batch_size=3", "--max_iter=10"] + extra)
        cpu = PlanarTrainer(popt, device="cpu")
        card = PlanarTrainer(popt, device="cuda")
        copy(cpu, card)
        with torch.no_grad():           # a warp away from zero
            w = torch.as_tensor(np.random.default_rng(1).normal(
                size=tuple(cpu.params["warp"].shape)) * 0.02,
                dtype=torch.float32)
            cpu.params["warp"].copy_(w)
            card.params["warp"].copy_(w.cuda())
        cpu.it = card.it = 3
        sigma, rank = cpu.schedule()
        res = [grads(tr.loss(tr.params, sigma, rank, tr.progress)[0],
                     tr.params) for tr in (cpu, card)]
        out[popt.model] = compare(popt.model, *res)
    conditioning = out.pop("barf_fine_ndc_progress_0.3")
    print("[mlp/planar] small steps card vs CPU: " + ", ".join(
        f"{k} loss {v['loss_cuda']:.6g}/{v['loss_cpu']:.6g} grads "
        f"{v['max_grad_err_rel']:.2g}" for k, v in out.items())
        + f"; barf at progress 0.3 (not gated): {conditioning}", flush=True)
    out["barf_fine_ndc_progress_0.3"] = conditioning
    return {"small_mlp_planar": out}



def profile_steps(trainer, end, table_path, on_step=None):
    """torch.profiler over the steps up to ``end``: device time by kernel,
    written as a table to table_path; returns the device-busy time per step
    and the ported kernels' mean device durations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = end - trainer.it
    os.makedirs(os.path.dirname(table_path), exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run(max_iter=end, log_every=1, on_step=on_step,
                    stats=on_step is not None)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    with open(table_path, "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # K3's narrow route is the dense grid's scatter, its wide route the
    # planes'
    ours = {name: [(e.self_device_time_total, e.count)
                   for e in kernels if name in e.key]
            for name in ("composite_fwd_kernel", "composite_bwd_kernel",
                         "scatter_add_rows_narrow_kernel",
                         "scatter_add_rows_wide_kernel")}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {"steps": n, "device_busy_ms_per_step": busy_ms / n,
            "kernel_mean_ms": {
                k: sum(t for t, _ in v) / sum(c for _, c in v) / 1e3
                if v else None for k, v in ours.items()},
            "top_kernels_ms_per_step": [
                (e.key[:90], e.self_device_time_total / 1e3 / n, e.count // n)
                for e in top]}


def check_tiled_all(gen):
    """K5 at the JAX bench scripts' shapes, then with every sample in one
    row and with int32 indices."""
    rows = [check_tiled(N, n_rows, C, gen, 1e-5) for N, n_rows, C in (
        (524288, 90000, 64), (524288, 160000, 64), (131072, 160000, 192))]
    return rows + [check_tiled(524288, 90000, 64, gen, 1e-5, case=case)
                   for case in ("one_row", "int32")]


# the rays layout of configs/bat_blender_VM_pod16.yaml (4096 rays a step,
# BAT's widths) through PHASES_ARGS' schedule.  16 views: the grid
# strategy's 4096 // 12 rays a view on 12 views make a 19 x 19 grid (361,
# odd), 16 views a 16 x 16 one (256 rays a view), which divides by 2 and 4
PAR_VIEWS = 16
PAR_ARGS = PHASES_ARGS + [f"--data.n_views={PAR_VIEWS}"]
# the first step of every phase: 64^3 under the blur (it 0), 101^3 (3),
# 160^3 (5), 252^3 (7), the uncapped mask and the shrunk box (8), 400^3
# (9), the blur off and the mask's compaction (12), the capped mask (15)
PAR_SNAPSHOT_ITS = (0, 3, 5, 7, 8, 9, 12, 15)
PAR_RANKS = (2, 4)
# L2G-BAT (configs/l2g_bat_blender_VM.yaml, error map 128^2) on the same
# 16 views (2048 rays: 144 a view on the grid), its second step
PAR_L2G_ARGS = ["--data.dataset=synthetic", f"--data.n_views={PAR_VIEWS}",
                "--max_iter=40"]
PAR_L2G_STEPS = 2
# the comp layout (no shipped config sets it): [R, C] over [rays, comp],
# BAT from (a)'s snapshots at both shapes, L2G's two steps and CP (the
# zoo's 96 / 288 components, one NCCL rank to the last snapshot's phase)
# at the first
PAR_COMP_SHAPES = ((1, 2), (2, 2))


def _keep_grads(trainer) -> dict:
    """Wrap trainer._step so that the last step's loss and gradients are
    kept (in the returned dict)."""
    kept = {}
    step = trainer._step

    def capture(*a, **k):
        metrics, grads = step(*a, **k)
        kept.update(loss=float(metrics["loss"]), grads=grads)
        return metrics, grads

    trainer._step = capture
    return kept


def _par_steps(trainer, n_iter, snap_its, tmp, label, device):
    """One-rank steps of ``trainer`` up to ``n_iter`` (timed, launches and
    collectives counted); before each iteration of ``snap_its`` a snapshot
    of the trainer, after it the step's loss and gradients: the files the
    D-rank runs start from and are held against."""
    import torch

    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.parallel import launch

    kept = _keep_grads(trainer)
    rows, snaps, refs, faults = [], [], [], []
    cuda = device != "cpu"
    while trainer.it < n_iter:
        it = trainer.it
        if it in snap_its:
            snaps.append(os.path.join(tmp, f"{label}_{it}.pt"))
            launch.snapshot(trainer, snaps[-1])
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        launches = dict(cuda_build.LAUNCHES)
        counts = dict(trainer.mesh.counts)
        m = trainer.train_iteration()
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cfg = trainer.last_step_config
        got = {k: v - launches[k] for k, v in cuda_build.LAUNCHES.items()}
        want = (step_launches(trainer, trainer.vm_cfg, trainer.mesh.rays)
                if cuda
                else {k: 0 for k in got})
        coll = {k: v - counts.get(k, 0) for k, v in trainer.mesh.counts.items()
                if v - counts.get(k, 0)}
        if got != want:
            faults.append(f"{label} it {it}: launched {got}, expected {want}")
        if coll.get("grads") != 1 or coll.get("nan_counts", 0) > 1:
            faults.append(f"{label} it {it}: collectives {coll}")
        if it in snap_its:
            refs.append(snaps[-1] + ".ref")
            torch.save({"loss": kept["loss"], "grads": kept["grads"]},
                       refs[-1])
        rows.append({"it": it, "ms": ms, "loss": float(m["loss"]),
                     "resolution": list(trainer.resolution),
                     "n_samples": trainer.n_samples,
                     "mask": trainer.alpha_mask is not None,
                     "blur": cfg.blur is not None,
                     "compact_k": cfg.compact_k,
                     "densify": cfg.densify_density, "app_k": cfg.app_k,
                     "launches": got, "collectives": coll})
        trainer._update_schedule()
        trainer.it += 1
    if not all(math.isfinite(r["loss"]) for r in rows):
        faults.append(f"{label}: losses {[r['loss'] for r in rows]}")
    return rows, snaps, refs, kept, faults


def _held_against(per_rank, tag, vm, cuda, faults, comp=None) -> dict:
    """The checks of a spawned run's ranks against the one-rank run they
    started from: each step's loss within 1e-4 relative, every gradient
    within 1e-3 of its leaf's max, K1-K3 per rank as expected_launches,
    one gradient bucket a step (under the comp layout the comp group's
    basis bucket, and the rays group's over a rays axis of more than one
    rank), the budgets equal and the replicas bit-identical by group:
    every replicated tensor over the world, the factor blocks over the
    ranks of one comp index.  Returns the worst loss and gradient
    errors."""
    from joint_tensorf_tpu_torch.train.step import StepConfig

    worst = {"loss_rel": 0.0, "grad_rel": 0.0}
    for rank, o in enumerate(per_rank):
        for row in o["history"]:
            cfg = StepConfig(**row["config"])
            rays = comp[0] if comp is not None else len(per_rank)
            want = (expected_launches(cfg, vm, rays) if cuda else
                    {k: 0 for k in row["launches"]})
            if cuda:
                want["density_sample_fwd"] += blur_mask_k6(
                    vm, row["blur_mask_built"])
            if row["launches"] != want:
                faults.append(f"{tag} rank {rank} it {row['it']}: launched "
                              f"{row['launches']}, expected {want}")
            c = row["counts"]
            rays_axis = comp is None or comp[0] > 1
            if (c.get("grads", 0) != int(rays_axis)
                    or c.get("nan_counts", 0) > 1
                    or (comp is not None and c.get("comp_grads") != 1)):
                faults.append(f"{tag} rank {rank} it {row['it']}: "
                              f"collectives {c}")
            lr = abs(row["metrics"]["loss"] - row["loss_ref"]) \
                / abs(row["loss_ref"])
            gr = max(row["grad_err"].values())
            worst["loss_rel"] = max(worst["loss_rel"], lr)
            worst["grad_rel"] = max(worst["grad_rel"], gr)
            if lr > 1e-4 or gr > 1e-3:
                faults.append(f"{tag} rank {rank} it {row['it']}: loss rel "
                              f"{lr:.3g}, worst gradient {gr:.3g} of its "
                              f"leaf's max")
    first = per_rank[0]
    for o in per_rank[1:]:
        if o["budgets"] != first["budgets"] or \
                o["checksums"]["world"] != first["checksums"]["world"]:
            faults.append(f"{tag}: rank {o['rank']} differs from rank 0")
        if comp is not None:
            same = [p for p in per_rank if p["coords"][1] == o["coords"][1]]
            if o["checksums"]["rays"] != same[0]["checksums"]["rays"]:
                faults.append(f"{tag}: rank {o['rank']}'s factor blocks "
                              f"differ from rank {same[0]['rank']}'s")
    return worst


def _phase_rows(rows) -> list:
    """Consecutive steps of one phase, with their median ms."""
    out = []
    for r in rows:
        key = (r["resolution"], r["n_samples"], r["mask"], r["blur"],
               r["compact_k"], r["densify"], r["app_k"])
        if not out or out[-1]["key"] != key:
            out.append({"key": key, "its": [], "ms": [],
                        "launches": r["launches"]})
        out[-1]["its"].append(r["it"])
        out[-1]["ms"].append(r["ms"])
    return [{"iterations": [p["its"][0], p["its"][-1]],
             "resolution": p["key"][0], "n_samples": p["key"][1],
             "mask": p["key"][2], "blur": p["key"][3],
             "compact_k": p["key"][4], "densified": p["key"][5],
             "app_k": p["key"][6], "launches_per_step": p["launches"],
             "step_ms_median": statistics.median(p["ms"]),
             "step_ms": p["ms"]} for p in out]


def run_parallel(device="cuda", backend="nccl", bat_args=PAR_ARGS,
                 l2g_args=PAR_L2G_ARGS, snap_its=PAR_SNAPSHOT_ITS,
                 ranks=PAR_RANKS, l2g_steps=PAR_L2G_STEPS,
                 comp_shapes=PAR_COMP_SHAPES, cp_args=CP_ARGS, smi="",
                 gen=None):
    """The [parallel] phase (parallel/: the rays and comp layouts of
    configs/bat_blender_VM_pod16.yaml).

    (a) one rank over NCCL (a process group of one, world size 1) at full
    width through every phase of the cut schedule: ms a step by phase,
    K1-K3 launches a step against expected_launches, one gradient
    all-reduce (and one of the NaN counts) a step, the bucket's bytes and
    one all-reduce of that size timed, the host syncs of 3 steps with the
    mesh and of the same 3 steps without it (none may be added);
    (c) L2G-BAT's first steps on the same rank;
    (b) 2 and then 4 gloo ranks, all on this one card, each started from
    (a)'s snapshot before the first step of every phase (and the 2 ranks
    from (c)'s before L2G's second step): each step's loss within 1e-4
    relative of (a)'s, every gradient within 1e-3 of its leaf's largest
    entry, K1-K3 per rank as expected_launches of the rank's own step,
    the replicas' state and budgets equal bit for bit at the end.  Times
    of several ranks on one card are contention, not scaling;
    (d) the comp layout, ``comp_shapes`` [R, C] over [rays, comp], gloo
    ranks on this card: BAT from (a)'s snapshots at each shape, L2G's two
    steps from (c)'s and CP (``cp_args``, one NCCL rank to the last
    snapshot's phase first) at the first, held as (b) is, the replicas
    bit-identical by group (the factor blocks over a rays group, the
    rest over the world); the collectives a step by purpose with their
    bytes, the peak GB per rank and the ms a step (contention); then K3
    against its plain version (index_add_) on ``gen`` at the shapes those
    steps launched it at (each step's scatter_shapes, from the ranks'
    cuda_build.SCATTER_SHAPES): for each channel count C the launch of the
    most rows N, the launch into the fewest destination rows (the most
    collisions) and the one into the most (a plane or the dense grid),
    each at its own N, C and n_rows.  Any mismatch raises.  ``device``, ``backend`` and the arguments exist so
    that the phase can be rehearsed at a tiny size on the CPU."""
    import gc
    import tempfile

    import torch
    import torch.distributed as dist

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.data import load_dataset
    from joint_tensorf_tpu_torch.parallel import launch, sharding
    from joint_tensorf_tpu_torch.parallel.mesh import initialize_distributed
    from joint_tensorf_tpu_torch.train.l2g_trainer import L2GTrainer
    from joint_tensorf_tpu_torch.train.step import StepConfig
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    cuda = device != "cpu"
    bat_yaml = os.path.join(HERE, "configs", "bat_blender_VM_pod16.yaml")
    l2g_yaml = os.path.join(HERE, "configs", "l2g_bat_blender_VM.yaml")
    faults, result = [], {"card": smi}
    tmp = tempfile.TemporaryDirectory(dir=HERE, prefix=".parallel_")
    try:
        initialize_distributed(f"file://{tmp.name}/store", 1, 0,
                               backend=backend, device=device)
        # ---------------- (a) one rank, full width, every phase
        opt = set_options(bat_yaml, bat_args + ["--tpu.mesh_shape=[1]"])
        data = load_dataset(opt, "train", device=device)
        tr = Trainer(opt, data, device=device)
        if tr.mesh.backend != backend or tr.mesh.world_size != 1:
            faults.append(f"(a) mesh {tr.mesh}")
        warm_start_density(tr, int(opt.data.get("seed", 0)))
        vm_cfg = tr.vm_cfg
        t0 = time.perf_counter()
        rows, snaps, refs, kept, f = _par_steps(
            tr, int(opt.max_iter), snap_its, tmp.name, "bat", device)
        faults += f
        run_s = time.perf_counter() - t0
        phases = _phase_rows(rows)
        for p in phases:
            print(f"[parallel] (a) {backend} 1 rank its {p['iterations']} res "
                  f"{p['resolution']} S {p['n_samples']} mask {p['mask']} "
                  f"blur {p['blur']} compact_k {p['compact_k']} densified "
                  f"{p['densified']} app_k {p['app_k']} launches "
                  f"{p['launches_per_step']} median "
                  f"{p['step_ms_median']:.1f} ms ({smi})", flush=True)
        grads = list(kept["grads"].values())
        n_bytes = sharding.bucket_bytes(grads) + 8
        buf = torch.zeros(n_bytes // 4, device=device)
        for _ in range(3):
            dist.all_reduce(buf)
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(20):
            dist.all_reduce(buf)
        if cuda:
            torch.cuda.synchronize()
        ar_ms = (time.perf_counter() - t1) * 1e3 / 20
        del buf
        print(f"[parallel] (a) bucket {n_bytes} bytes ({len(grads)} "
              f"gradients + loss, MSE numerator), one all_reduce "
              f"{ar_ms:.3f} ms over {backend} at world size 1 ({smi})",
              flush=True)
        syncs = None
        if cuda:
            mesh = tr.mesh
            tr.it -= 3
            with_mesh = count_host_syncs(tr, 3)
            tr.mesh = None
            tr.it -= 3
            without = count_host_syncs(tr, 3)
            tr.mesh = mesh
            syncs = {"mesh": with_mesh, "no_mesh": without}
            print(f"[parallel] (a) host syncs per step, last phase: with "
                  f"the mesh {with_mesh}, without {without}", flush=True)
            if any(a > b for a, b in zip(with_mesh, without)):
                faults.append(f"(a) the mesh added host syncs: {syncs}")
        bat_rays = tr.rays_per_step
        result["a"] = {
            "config": "configs/bat_blender_VM_pod16.yaml "
                      + " ".join(bat_args) + " --tpu.mesh_shape=[1]",
            "backend": backend, "world_size": 1,
            "rays_per_step": tr.rays_per_step, "views": tr.n_views,
            "run_s": run_s, "phases": phases,
            "loss": [r["loss"] for r in rows],
            "collectives_per_step": rows[-1]["collectives"],
            "bucket_bytes": n_bytes, "all_reduce_ms": ar_ms,
            "host_syncs": syncs}
        del tr, data, kept, grads
        # ---------------- (c) L2G, one rank
        opt_l = set_options(l2g_yaml, l2g_args + ["--tpu.mesh_shape=[1]"])
        data_l = load_dataset(opt_l, "train", device=device)
        tl = L2GTrainer(opt_l, data_l, device=device)
        l2g_rows, l2g_snaps, l2g_refs, kept, f = _par_steps(
            tl, l2g_steps, tuple(range(l2g_steps)), tmp.name, "l2g", device)
        faults += f
        l2g_vm, l2g_rays = tl.vm_cfg, tl.rays_per_step
        result["c_one_rank"] = {"rays_per_step": tl.rays_per_step,
                                "views": tl.n_views,
                                "loss": [r["loss"] for r in l2g_rows],
                                "step_ms": [r["ms"] for r in l2g_rows]}
        del tl, data_l, kept
        gc.collect()            # the kept-gradient hooks hold the trainers
        if cuda:
            torch.cuda.empty_cache()
        # ---------------- (d) CP, one rank, to the last snapshot's phase
        opt_cp = set_options(bat_yaml, bat_args + cp_args
                             + ["--tpu.mesh_shape=[1]"])
        data_cp = load_dataset(opt_cp, "train", device=device)
        tc = Trainer(opt_cp, data_cp, device=device)
        warm_start_density(tc, int(opt_cp.data.get("seed", 0)))
        cp_rows, cp_snaps, cp_refs, kept, f = _par_steps(
            tc, max(snap_its) + 1, snap_its, tmp.name, "cp", device)
        faults += f
        cp_vm = tc.vm_cfg
        result["d_cp_one_rank"] = {"its": [r["it"] for r in cp_rows],
                                   "loss": [r["loss"] for r in cp_rows],
                                   "step_ms": [r["ms"] for r in cp_rows]}
        del tc, data_cp, kept
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        rank_dev = f"{device}:0" if cuda else "cpu"
        # ---------------- (b) and (c): D gloo ranks on this card
        for d in ranks:
            jobs = [dict(kind="trainer", yaml=bat_yaml,
                         args=bat_args + [f"--tpu.mesh_shape=[{d}]"],
                         snapshots=snaps, refs=refs)]
            if d == 2:
                jobs.append(dict(kind="trainer", yaml=l2g_yaml,
                                 args=l2g_args + ["--tpu.mesh_shape=[2]"],
                                 snapshots=l2g_snaps, refs=l2g_refs))
            t0 = time.perf_counter()
            out = launch.spawn(launch.run_jobs, d, {"jobs": jobs},
                               backend="gloo", device=rank_dev,
                               timeout_s=900)
            wall = time.perf_counter() - t0
            for j, (label, vm) in enumerate([("bat", vm_cfg),
                                             ("l2g", l2g_vm)][:len(jobs)]):
                per_rank = [o[j] for o in out]
                worst = _held_against(per_rank, f"(b) {label} D={d}", vm,
                                      cuda, faults)
                hist = per_rank[0]["history"]
                ms = [row["ms"] for row in hist]
                result[f"{label}_{d}_ranks"] = {
                    "ranks": d, "backend": "gloo", "device": "one card",
                    "its": [row["it"] for row in hist],
                    "loss": [row["metrics"]["loss"] for row in hist],
                    "loss_ref": [row["loss_ref"] for row in hist],
                    "worst": worst, "bucket_bytes": hist[-1]["bucket_bytes"],
                    "launches_rank0": [row["launches"] for row in hist],
                    "contention_step_ms": ms, "spawn_wall_s": wall,
                    "budgets_rank0": per_rank[0]["budgets"]}
                print(f"[parallel] ({'b' if label == 'bat' else 'c'}) "
                      f"{label} {d} gloo ranks on one card, its "
                      f"{[row['it'] for row in hist]}: worst loss rel "
                      f"{worst['loss_rel']:.3g}, worst gradient "
                      f"{worst['grad_rel']:.3g} of the leaf's max, replicas "
                      f"bit-identical; step ms (contention of {d} ranks on "
                      f"one card, not scaling) "
                      f"{[round(x, 1) for x in ms]}; spawn {wall:.1f} s "
                      f"({smi})", flush=True)
        # ---------------- (d) the comp layout: R x C gloo ranks
        launched = {}   # C -> [(N, n_rows, S kept, job, it)] of K3
        for n, (R_, C_) in enumerate(comp_shapes):
            mesh_args = [f"--tpu.mesh_shape=[{R_},{C_}]",
                         "--tpu.mesh_axes=[rays,comp]"]
            jobs = [("bat", vm_cfg, dict(kind="trainer", yaml=bat_yaml,
                                         args=bat_args + mesh_args,
                                         snapshots=snaps, refs=refs))]
            if n == 0:
                jobs += [("l2g", l2g_vm, dict(
                             kind="trainer", yaml=l2g_yaml,
                             args=l2g_args + mesh_args,
                             snapshots=l2g_snaps, refs=l2g_refs)),
                         ("cp", cp_vm, dict(
                             kind="trainer", yaml=bat_yaml,
                             args=bat_args + cp_args + mesh_args,
                             snapshots=cp_snaps, refs=cp_refs))]
            t0 = time.perf_counter()
            out = launch.spawn(launch.run_jobs, R_ * C_,
                               {"jobs": [j for _, _, j in jobs]},
                               backend="gloo", device=rank_dev,
                               timeout_s=900)
            wall = time.perf_counter() - t0
            for j, (label, vm, _) in enumerate(jobs):
                per_rank = [o[j] for o in out]
                tag = f"(d) {label} [{R_},{C_}]"
                worst = _held_against(per_rank, tag, vm, cuda, faults,
                                      comp=(R_, C_))
                hist = per_rank[0]["history"]
                for o in per_rank:
                    for row in o["history"]:
                        cfg = StepConfig(**row["config"])
                        S_kept = min(cfg.compact_k or cfg.n_samples,
                                     cfg.n_samples)
                        for C, n_rows, N in row["scatter_shapes"]:
                            launched.setdefault(C, []).append(
                                (N, n_rows, S_kept, label, row["it"]))
                ms = [row["ms"] for row in hist]
                last = hist[-1]
                peak = [max(row.get("peak_gb", 0.0) for row in o["history"])
                        for o in per_rank]
                result[f"comp_{label}_{R_}x{C_}"] = {
                    "mesh_shape": [R_, C_], "mesh_axes": ["rays", "comp"],
                    "backend": "gloo", "device": "one card",
                    "its": [row["it"] for row in hist],
                    "loss": [row["metrics"]["loss"] for row in hist],
                    "loss_ref": [row["loss_ref"] for row in hist],
                    "worst": worst,
                    "launches_rank0": [row["launches"] for row in hist],
                    "collectives_last_step": last["counts"],
                    "collective_bytes_last_step": last["bytes"],
                    "peak_gb_per_rank": peak,
                    "contention_step_ms": ms, "spawn_wall_s": wall}
                print(f"[parallel] {tag} over [rays,comp], {R_ * C_} gloo "
                      f"ranks on one card, its {[row['it'] for row in hist]}"
                      f": worst loss rel {worst['loss_rel']:.3g}, worst "
                      f"gradient {worst['grad_rel']:.3g} of the leaf's max, "
                      f"replicas bit-identical by group; collectives of the "
                      f"last step {last['counts']} bytes {last['bytes']}; "
                      f"peak GB per rank {[round(x, 2) for x in peak]}; "
                      f"step ms (contention of {R_ * C_} ranks on one card, "
                      f"not scaling) {[round(x, 1) for x in ms]}; spawn "
                      f"{wall:.1f} s ({smi})", flush=True)
        # K3 against index_add_ at the shapes the comp steps launched it
        # at: for each channel count the launch of the most rows, the
        # launch into the fewest destination rows and the one into the
        # most, with march-order indices along its n_rows rows (S kept
        # samples a ray)
        checks = []
        picked = sorted({(C,) + pick for C, runs in launched.items()
                         for pick in (max(runs, key=lambda r: (r[0], -r[1])),
                                      min(runs, key=lambda r: (r[1], -r[0])),
                                      max(runs, key=lambda r: (r[1], r[0])))})
        if cuda and not picked:
            faults.append("(d): the ranks noted no K3 launch")
        for C, N, n_rows, S_k, label, it in picked if cuda else ():
            r = check_scatter(-(-N // S_k), S_k, 0, 0, C, gen, tol=1e-5,
                              line=n_rows, n=N)
            r["shape"]["rows"] = "as launched"
            r.update(path=f"comp {label} it {it}")
            checks.append(r)
            emit({"kernel_check": r})
            print(f"[parallel] (d) K3 as launched: {N} x {C} into {n_rows} "
                  f"rows ({label} it {it}): "
                  f"{r['ms']:.3f} ms, device "
                  f"{r['device_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
                  f"({r['bound_by']}), index_add_ {r['library_ms']:.3f} ms, "
                  f"err {r['max_abs_err']:.3g} ({smi})", flush=True)
        result["d_k3"] = [{k: r[k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "shape", "path")} for r in checks]
        result["d_k3_launched"] = sorted(
            [C, n_rows, max(r[0] for r in runs if r[1] == n_rows)]
            for C, runs in launched.items() for n_rows in {r[1] for r in runs})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmp.cleanup()
    emit({"parallel": result})
    if faults:
        fail("parallel: " + "; ".join(faults))
    return result


# ---------------------------------------------- [rest]: the last functions
REST_REPS = 5           # timed calls of each [rest] function (heavy ones)


def _rel(got, want) -> float:
    """max |got - want| over max |want| (at least 1e-30)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def march_coords(n_rays, S, shape, gen, device="cuda"):
    """Normalised coordinates (cx, cy, cz) [n_rays * S] along rays in march
    order, each step at most half a cell per axis, folded back at the
    box's faces so that every ray stays inside; the first 6 samples lie
    exactly on faces (+-1), where jnp.clip gives half the gradient."""
    import torch

    size = torch.tensor([float(s - 1) for s in shape], device=device)
    start = torch.rand((n_rays, 3), generator=gen, device=device) * 2 - 1
    step = (torch.rand((n_rays, 3), generator=gen, device=device) - 0.5) \
        * 2 / size
    t = torch.arange(S, device=device, dtype=torch.float32)[None, :, None]
    p = torch.remainder(start[:, None] + 1 + t * step[:, None], 4.0)
    c = (torch.where(p > 2, 4 - p, p) - 1).reshape(-1, 3)
    c[:6] = torch.tensor([[-1, 1, -1], [1, -1, 1], [1, 1, 1],
                          [-1, -1, -1], [0.5, -1, 1], [1, 0.25, -1]],
                         device=device, dtype=torch.float32)
    return c.unbind(-1)


def _fwd_bwd(fn, inputs, cot):
    """fn(*inputs) and the gradients of <fn(*inputs), cot> w.r.t. inputs
    (fresh leaves): (value, [grads])."""
    import torch

    leaves = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, cot)
    return out.detach(), list(grads)


def _held(name, got, want, tol, faults) -> float:
    """The worst relative error of the (value, grads) pair ``got`` against
    ``want``; a fault past ``tol`` or a non-finite value."""
    import torch

    errs = [_rel(got[0], want[0])] + [_rel(a, b) for a, b in
                                      zip(got[1], want[1], strict=True)]
    finite = all(torch.isfinite(t).all() for t in [got[0]] + got[1])
    if not finite or max(errs) > tol:
        faults.append(f"{name}: errors {['%.3g' % e for e in errs]} > {tol}"
                      f" (finite {finite})")
    return max(errs)


def _launches_of(fn) -> dict:
    """The counted kernel launches of one call of fn, counters zeroed
    just before it."""
    from joint_tensorf_tpu_torch.ops import cuda_build

    cuda_build.reset_launches()
    fn()
    return {k: v for k, v in cuda_build.LAUNCHES.items() if v}


def rest_lane(G, coords, gen, faults, device="cuda"):
    """(a) sample_lane_grid(pack_lane_grid(G)) against
    sample_packed_grid(pack_corners(G)): values, G's gradient and the
    coordinates', float32 and bf16 rows; K3 launches once a backward at
    128 channels; ms forward + backward of each (one call: the pack, the
    sample and their backwards) against the function's byte bound.
    Returns (out, the K3 row at 128 channels into X*Y*Zb rows)."""
    import torch

    from joint_tensorf_tpu_torch.ops import densify, lane_grid, sampling

    X, Y, Z = G.shape
    N = coords[0].shape[0]
    cot = torch.randn((N,), generator=gen, device=device)

    def lane(dt):
        return lambda g, cx, cy, cz: lane_grid.sample_lane_grid(
            lane_grid.pack_lane_grid(g), (cx, cy, cz), Z, dt)

    def packed8(dt):
        return lambda g, cx, cy, cz: densify.sample_packed_grid(
            densify.pack_corners(g), (cx, cy, cz), dt)

    inputs = (G,) + tuple(coords)
    out = {"grid": [X, Y, Z], "samples": N}
    for dt in ("float32", "bfloat16"):
        got = _fwd_bwd(lane(dt), inputs, cot)
        want = _fwd_bwd(packed8(dt), inputs, cot)
        out[f"err_{dt}"] = _held(f"[rest] (a) lane vs packed8 ({dt})", got,
                                 want, 1e-5, faults)
        del got, want
    launches = _launches_of(lambda: _fwd_bwd(lane("float32"), inputs, cot))
    if launches != {"scatter_add_rows": 1} and device == "cuda":
        faults.append(f"[rest] (a) lane fwd+bwd launches {launches}, want "
                      f"one K3")
    out["launches"] = launches
    # the function's bytes: G and the coordinates and cotangent read, the
    # samples, G's gradient and the coordinates' written
    out["bound_ms"], out["bound_by"] = bound(
        2 * X * Y * Z * 4 + N * 4 * (3 + 1 + 1 + 3), 0)
    out["rows_bytes"] = {"lane": 2 * N * 128 * 4, "packed8": 2 * N * 8 * 4}
    if device == "cuda":
        for name, fn in (("lane", lane("float32")),
                         ("packed8", packed8("float32")),
                         ("lane_bf16", lane("bfloat16")),
                         ("packed8_bf16", packed8("bfloat16"))):
            out[f"{name}_ms"] = time_ms(lambda: _fwd_bwd(fn, inputs, cot),
                                        reps=REST_REPS, warmup=1)
    # K3 alone at the lane backward's shape: 128 channels into X*Y*Zb rows
    Zb = lane_grid.n_blocks(Z)
    x0, y0, z0 = (sampling._floor_frac(sampling._pix(c, n), n)[0]
                  for c, n in zip(coords, (X, Y, Z)))
    idx = ((x0 * Y + y0) * Zb + z0 // lane_grid.ZRUN).contiguous()
    del x0, y0, z0
    return out, rest_k3(idx, lane_grid.LANES, X * Y * Zb, gen, faults,
                        device)


def rest_vm_build(field, cfg, gen, faults, device="cuda") -> dict:
    """(b) compute_lane_density_grid (the direct build) against
    pack_lane_grid(compute_density_grid): values and the density factors'
    gradients; ms forward + backward of each."""
    import torch

    from joint_tensorf_tpu_torch.models import vm
    from joint_tensorf_tpu_torch.ops import lane_grid

    params = list(field.density_planes) + list(field.density_lines)

    def run(direct):
        G = (vm.compute_lane_density_grid(field, cfg) if direct else
             lane_grid.pack_lane_grid(vm.compute_density_grid(field, cfg)))
        return G.detach(), list(torch.autograd.grad(G, params, cot))

    X, Y, Z = field.resolution()
    cot = torch.randn((X, Y, lane_grid.n_blocks(Z), lane_grid.LANES),
                      generator=gen, device=device)
    out = {"grid": [X, Y, Z], "err": _held(
        "[rest] (b) direct lane build vs pack of the dense grid",
        run(True), run(False), 1e-5, faults)}
    if device == "cuda":
        out["direct_ms"] = time_ms(lambda: run(True), reps=REST_REPS,
                                   warmup=1)
        out["pack_ms"] = time_ms(lambda: run(False), reps=REST_REPS,
                                 warmup=1)
    del cot
    return out


def rest_hybrid(field, n_rays, S, app_k, gen, faults, device="cuda"):
    """(c) the hybrids against the plain samplers on the trained field's
    largest appearance plane and its line (n_rays x app_k samples, 4R and
    2R channels) and its longest density line (n_rays x S samples):
    values and every gradient, K3 once a backward; then K3's line scatter
    against the one-hot matmul the trainer's lines used before they went
    through K3 (onehot_rows_matmul) and index_add_ at each line shape.
    Returns (out, K3 rows for the kernels line)."""
    import torch

    from joint_tensorf_tpu_torch.models.vm import MAT_MODE, VEC_MODE
    from joint_tensorf_tpu_torch.ops import sampling

    res = field.resolution()
    i = max(range(3), key=lambda a: res[MAT_MODE[a][0]] * res[MAT_MODE[a][1]])
    j = max(range(3), key=lambda a: res[VEC_MODE[a]])
    cases = {"app_plane": (field.app_planes[i], app_k),
             "app_line": (field.app_lines[i], app_k),
             "density_line": (field.density_lines[j], S)}
    out, k3_rows = {}, []
    for name, (table, per_ray) in cases.items():
        table = table.detach().float()
        is_plane = table.dim() == 3
        if is_plane:
            H, W, R = table.shape
            coords = march_coords(n_rays, per_ray, (W, H, 2), gen,
                                  device)[:2]
            hybrid, plain = sampling.sample_plane_hybrid, sampling.sample_plane
        else:
            D, R = table.shape
            coords = march_coords(n_rays, per_ray, (2, 2, D), gen,
                                  device)[2:]
            hybrid, plain = sampling.sample_line_hybrid, sampling.sample_line
        n = n_rays * per_ray
        cot = torch.randn((n, R), generator=gen, device=device)
        inputs = (table,) + tuple(coords)
        row = {"table": list(table.shape), "samples": n,
               "channels": (4 if is_plane else 2) * R,
               "err": _held(f"[rest] (c) {name} hybrid vs plain",
                            _fwd_bwd(hybrid, inputs, cot),
                            _fwd_bwd(plain, inputs, cot), 1e-5, faults),
               "launches": _launches_of(
                   lambda: _fwd_bwd(hybrid, inputs, cot))}
        if device == "cuda":
            if row["launches"] != {"scatter_add_rows": 1}:
                faults.append(f"[rest] (c) {name} hybrid launches "
                              f"{row['launches']}, want one K3")
            row["hybrid_ms"] = time_ms(lambda: _fwd_bwd(hybrid, inputs, cot),
                                       reps=REST_REPS, warmup=1)
            row["plain_ms"] = time_ms(lambda: _fwd_bwd(plain, inputs, cot),
                                      reps=REST_REPS, warmup=1)
        if not is_plane:
            idx = sampling._floor_frac(sampling._pix(coords[0], D), D)[0]
            row["scatter"] = rest_k3(idx.contiguous(), 2 * R, D, gen,
                                     faults, device)
            k3_rows.append(row["scatter"])
        out[name] = row
        del cot
    return out, k3_rows


def onehot_rows_matmul(idx, updates, n_rows: int):
    """zeros([n_rows, C]).at[idx].add(updates) as onehot(idx)^T @ updates:
    the JAX package's _scatter_rows_matmul (its unchunked line gradient),
    which the port's line gradients took until they went through K3; an
    [N, n_rows] float32 one-hot keeps every product exact, only the
    summation order differs from a scatter.  Timed here as K3's
    comparison at the line shapes; no port path calls it."""
    import torch

    onehot = (torch.arange(n_rows, device=idx.device)[None, :]
              == idx[:, None]).to(updates.dtype)
    return onehot.T @ updates


def rest_k3(idx, C, n_rows, gen, faults, device="cuda") -> dict:
    """K3 at a new shape: the samples' rows ``idx`` in march order, C
    channels into n_rows rows, against index_add_ (its plain version and
    the library call) and, for a short destination (the lines), the
    one-hot matmul (onehot_rows_matmul); the same with every sample in
    one row, exactly.  Atomics sum in a run-dependent order: march order is
    held at 1e-5 of the output's largest magnitude."""
    import torch

    from joint_tensorf_tpu_torch.ops import segment_scatter as K

    n = idx.shape[0]
    short = n_rows <= 4096
    upd = torch.randn((n, C), generator=gen, device=device)
    # every sample in one row: integer updates, whose sums are exact in
    # any order (|sum| <= 4n < 2^24), so all three agree exactly
    ints = torch.randint(-4, 5, (n, C), generator=gen, device=device).float()
    out = {"name": "scatter_add_rows", "N": n, "C": C, "n_rows": n_rows}
    for case, ix, u, tol in (
            ("march", idx, upd, 1e-5),
            ("one_row", torch.full_like(idx, n_rows // 2), ints, 0.0)):
        want = K.scatter_add_rows_plain(ix, u, n_rows)
        got = K.scatter_add_rows(ix, u, n_rows)
        err = _rel(got, want)
        if short:
            err = max(err, _rel(onehot_rows_matmul(ix, u, n_rows), want))
        if not torch.isfinite(got).all() or err > tol:
            faults.append(f"[rest] K3 at {n} x {C} into {n_rows} rows "
                          f"({case}): {err:.3g} > {tol}")
        out[f"max_rel_err_{case}"] = err
        out.setdefault("max_abs_err", float((got - want).abs().max()))
        del want, got
    del ints
    out["bound_ms"], out["bound_by"] = bound(
        n * 8 + n * C * 4 + n_rows * C * 4, n * C)
    if device == "cuda":
        out["ms"] = time_ms(lambda: K.scatter_add_rows_cuda(idx, upd, n_rows))
        # the kernel's device time from torch.profiler (its memset apart)
        by_kernel = device_times(
            lambda: K.scatter_add_rows_cuda(idx, upd, n_rows))
        out["device_ms"] = sum(t for name, t in by_kernel.items()
                               if "scatter_add_rows" in name)
        out["device_ms_by_kernel"] = by_kernel
        out["plain_ms"] = time_ms(
            lambda: K.scatter_add_rows_plain(idx, upd, n_rows))
        out["library_ms"] = out["plain_ms"]       # index_add_ is both
        if short:
            out["onehot_ms"] = time_ms(
                lambda: onehot_rows_matmul(idx, upd, n_rows))
    return out


def rest_checkpoint(trainer, data, faults) -> dict:
    """(d) BAT's last-phase state saved with async_write and without: the
    ms the caller is blocked in each, the drain, and the queued file
    restored into a fresh trainer equal leaf for leaf, and equal to the
    synchronous file array for array."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from joint_tensorf_tpu_torch.config import set_options
    from joint_tensorf_tpu_torch.train import checkpoint as ckpt
    from joint_tensorf_tpu_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rest_")
    try:
        paths = {k: os.path.join(tmp, f"{k}.ckpt.npz")
                 for k in ("queued", "sync")}
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(paths["queued"], trainer, async_write=True)
        t1 = time.perf_counter()
        ckpt.wait_for_pending()
        t2 = time.perf_counter()
        ckpt.save_checkpoint(paths["sync"], trainer)
        t3 = time.perf_counter()
        a, b = (np.load(paths[k]) for k in ("queued", "sync"))
        diff = [k for k in b.files if k not in a.files
                or (a[k].dtype, a[k].shape, a[k].tobytes())
                != (b[k].dtype, b[k].shape, b[k].tobytes())]
        if diff or set(a.files) != set(b.files):
            faults.append(f"[rest] (d) the queued file differs from the "
                          f"synchronous one: {diff[:8]}")
        fresh = Trainer(set_options(
            os.path.join(HERE, "configs", "bat_blender_VM.yaml"),
            PHASES_ARGS), data, device=trainer.device)
        ckpt.restore_checkpoint(paths["queued"], fresh)
        bad = _differing_leaves(trainer, fresh)
        if bad:
            faults.append(f"[rest] (d) restored leaves differ: {bad[:8]}")
        del fresh
        return {"bytes": os.path.getsize(paths["queued"]),
                "queued_blocked_ms": (t1 - t0) * 1e3,
                "drain_ms": (t2 - t1) * 1e3,
                "sync_blocked_ms": (t3 - t2) * 1e3,
                "restored_equal": not bad, "files_equal": not diff}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rest_helpers(faults, device="cuda") -> dict:
    """(e) each small helper once on the card and once on the CPU from the
    same inputs (a seeded CPU generator): within 1e-6 of the larger of 1
    and the CPU result's largest magnitude, NaNs in the same places, the
    uint8 mask and the booleans equal."""
    import torch

    from joint_tensorf_tpu_torch.geometry import lie, rays
    from joint_tensorf_tpu_torch.models import alpha_mask, vm
    from joint_tensorf_tpu_torch.ops import composite, kernels
    from joint_tensorf_tpu_torch.render import renderer
    from joint_tensorf_tpu_torch.train import losses

    g = torch.Generator().manual_seed(5)

    def r(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    alpha = r(32, 48)
    alpha[0, 7] = 1.0
    target = r(32, 10, 3)
    target[0, 3] = float("nan")
    x = {"sigma": r(32, 48, hi=30), "dists": r(32, 48, hi=0.05),
         "one_minus": 1.0 - alpha + 1e-10, "dT": torch.randn(
             (32, 48), generator=g), "w": r(32, 48, hi=0.02),
         "rgb": r(32, 48, 3), "z": r(32, 48, lo=2, hi=6),
         "last": r(32, lo=-1, hi=1), "sigmas": r(5, hi=6),
         "x": r(33, lo=-2, hi=2), "so3": torch.cat([torch.zeros(1, 3),
                                                      r(4, 3, lo=-1)]),
         "dR": torch.randn((5, 3, 3), generator=g),
         "pix": r(2, 30, 3, hi=50),
         "intr_inv": torch.linalg.inv(r(2, 3, 3, lo=.5, hi=2)),
         "mask": (r(30, 20, 25) > 0.6).float(),
         "aabb": torch.tensor([[-1.5, -1.2, -1.0], [1.5, 1.3, 1.1]]),
         "centers": r(200, 3, lo=-4, hi=4), "dirs": r(200, 3, lo=-1),
         "jitter": r(200, 1), "coords": r(50, 3, lo=-1),
         "pred": r(32, 10, 3), "target": target, "edge": r(32, 10)}
    calls = {
        "raw2alpha": lambda d, t: composite.raw2alpha(t["sigma"],
                                                      t["dists"]),
        "exclusive_cumprod": lambda d, t: _fwd_bwd(
            composite.exclusive_cumprod, (t["one_minus"],), t["dT"]),
        "composite_weights": lambda d, t: composite.composite_weights(
            t["w"], t["rgb"], t["z"], t["last"]),
        "batch_gaussian_kernel": lambda d, t: (
            kernels.batch_gaussian_kernel(t["sigmas"], 15, device=d),),
        "discrete_gaussian_kernel": lambda d, t: (
            kernels.discrete_gaussian_kernel(3.5, 15, device=d),),
        "taylor_C": lambda d, t: (lie.taylor_C(t["x"]),),
        "so3_to_SO3": lambda d, t: _fwd_bwd(lie.so3_to_SO3, (t["so3"],),
                                            t["dR"]),
        "img2cam": lambda d, t: (rays.img2cam(t["pix"], t["intr_inv"]),),
        "pack_neighborhoods": lambda d, t: (
            alpha_mask.pack_neighborhoods(t["mask"]),),
        "sample_ray": lambda d, t: renderer.sample_ray(
            t["aabb"], 0.05, 64, t["centers"], t["dirs"], 2.0, 6.0, True,
            jitter=t["jitter"]),
        "coord_axes": lambda d, t: vm.coord_axes(t["coords"]),
        "soft_edge_render_loss": lambda d, t: (losses.soft_edge_render_loss(
            t["pred"], t["target"], t["edge"], 2.0, 0.5),),
    }

    def flat(outs):
        return [y.cpu() for o in outs for y in (o if isinstance(o, list)
                                                else [o])]

    card = {k: v.to(device) for k, v in x.items()}
    out = {}
    for name, fn in calls.items():
        err = 0.0
        for a, b in zip(flat(fn(device, card)), flat(fn("cpu", x)),
                        strict=True):
            if b.dtype in (torch.uint8, torch.bool):
                err = max(err, float((a != b).sum()))
                continue
            if not torch.equal(torch.isnan(a), torch.isnan(b)):
                err = max(err, 1.0)
            scale = max(1.0, float(b.nan_to_num().abs().max()))
            err = max(err, float((a - b).nan_to_num().abs().max()) / scale)
        out[name] = err
        if err > 1e-6:
            faults.append(f"[rest] (e) {name}: card vs CPU {err:.3g} > 1e-6")
    return out


def run_rest_phase(trainer, data, n_rays, cfg, gen):
    """[rest] the JAX package's last functions at BAT's widths on the
    default path's trained trainer (its last phase: the 423x359x420 grid,
    density R 16, appearance R 48, S and app_k of its last step):
    (a) the lane grid against packed8 on the trained field's dense grid
    with n_rays x S samples in march order; (b) the direct VM lane build
    against the pack of the dense grid; (c) the hybrids against the plain
    samplers and K3's line scatter against the one-hot matmul and
    index_add_; (d) queued and synchronous checkpoints; (e) the small
    helpers card vs CPU; K3 against index_add_ at each new shape (128
    channels into the lane grid's rows, 2R into a line).  Prints one
    [rest] line per part; returns ({"rest": ...}, K3's rows at the new
    shapes)."""
    import torch

    from joint_tensorf_tpu_torch.models import vm

    t0 = time.perf_counter()
    faults = []
    field, vm_cfg = trainer.state.field, trainer.vm_cfg
    S, app_k = cfg.n_samples, cfg.app_k or cfg.n_samples
    with torch.no_grad():
        G = vm.compute_density_grid(field, vm_cfg).contiguous()
    coords = march_coords(n_rays, S, G.shape, gen)
    a, k3_lane = rest_lane(G, coords, gen, faults)
    del G, coords
    torch.cuda.empty_cache()
    print(f"[rest] (a) lane vs packed8 at {a['grid']} x {a['samples']} "
          f"samples: err {a['err_float32']:.3g} (bf16 rows "
          f"{a['err_bfloat16']:.3g}), launches {a['launches']}, fwd+bwd "
          f"lane {a['lane_ms']:.3f} / packed8 {a['packed8_ms']:.3f} ms "
          f"(bf16 {a['lane_bf16_ms']:.3f} / {a['packed8_bf16_ms']:.3f}), "
          f"bound {a['bound_ms']:.3f} ms ({a['bound_by']})", flush=True)
    b = rest_vm_build(field, vm_cfg, gen, faults)
    torch.cuda.empty_cache()
    print(f"[rest] (b) direct lane build vs pack of the dense grid at "
          f"{b['grid']}: err {b['err']:.3g}, fwd+bwd direct "
          f"{b['direct_ms']:.3f} / pack {b['pack_ms']:.3f} ms", flush=True)
    c, k3_lines = rest_hybrid(field, n_rays, S, app_k, gen, faults)
    torch.cuda.empty_cache()
    for name, row in c.items():
        line = (f"[rest] (c) {name} {row['table']} x {row['samples']} "
                f"samples ({row['channels']} channels): hybrid vs plain err "
                f"{row['err']:.3g}, launches {row['launches']}, fwd+bwd "
                f"hybrid {row['hybrid_ms']:.3f} / plain "
                f"{row['plain_ms']:.3f} ms")
        if "scatter" in row:
            s = row["scatter"]
            line += (f"; line scatter K3 {s['ms']:.4f} / one-hot "
                     f"{s['onehot_ms']:.4f} / index_add_ "
                     f"{s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} "
                     f"({s['bound_by']})")
        print(line, flush=True)
    d = rest_checkpoint(trainer, data, faults)
    torch.cuda.empty_cache()
    print(f"[rest] (d) checkpoint {d['bytes'] / 1e6:.1f} MB: caller blocked "
          f"{d['queued_blocked_ms']:.1f} ms queued (drain "
          f"{d['drain_ms']:.1f} ms) vs {d['sync_blocked_ms']:.1f} ms "
          f"synchronous; files equal {d['files_equal']}, restored equal "
          f"{d['restored_equal']}", flush=True)
    e = rest_helpers(faults)
    print(f"[rest] (e) helpers card vs CPU: worst {max(e.values()):.3g} "
          f"({len(e)} functions)", flush=True)
    wall = time.perf_counter() - t0
    print(f"[rest] phase: {wall:.1f} s", flush=True)
    k3_rows = [k3_lane] + k3_lines
    for k in k3_rows:
        print(f"[rest] K3 at {k['N']} x {k['C']} into {k['n_rows']} rows: "
              f"{k['ms']:.4f} ms, index_add_ {k['library_ms']:.4f}, bound "
              f"{k['bound_ms']:.4f} ({k['bound_by']}), err march "
              f"{k['max_rel_err_march']:.3g} / one row "
              f"{k['max_rel_err_one_row']:.3g}", flush=True)
    result = {"rest": {"lane": a, "vm_build": b, "hybrid": c,
                       "checkpoint": d, "helpers": e, "k3": k3_rows,
                       "wall_s": wall}}
    emit(result)
    if faults:
        fail("[rest]: " + "; ".join(faults))
    return result, k3_rows


# ------------------------------ [f1]: the fused sample's chunked backward
# the LLFF / NDC appearance line: 4420 rays x 1000 samples on the
# 771 x 859 x 771 grid, 20 appearance components (bat_llff_VM_MLP.yaml)
F1_LLFF = (4420, 1000, (771, 859, 771), 20)
# CP-384's components (density, appearance) on BAT's last-phase lines
F1_CP = (96, 288)


def f1_fused(name, plane, line, n_rays, S, gen, faults):
    """The fused factor sample on n_rays x S march-order samples: values
    and every gradient on the K3 route against the plain route
    (scatter_add_rows_plain) and against the same call with
    _PROD_BWD_CHUNK above N, within 1e-5 of each leaf's largest value; K3
    launches a call against 2 x the chunks; ms forward + backward."""
    import torch

    from joint_tensorf_tpu_torch.ops import sampling
    from joint_tensorf_tpu_torch.ops import segment_scatter as K

    H, W, R = plane.shape
    D = line.shape[0]
    u, v, w = march_coords(n_rays, S, (W, H, D), gen)
    N = n_rays * S
    cot = torch.randn((N, R), generator=gen, device="cuda")
    inputs = (plane, line, u, v, w)

    def call():
        return _fwd_bwd(sampling.sample_planeline_prod, inputs, cot)

    chunks = -(-N // sampling._PROD_BWD_CHUNK)
    got = call()
    with mock.patch.object(sampling, "scatter_add_rows",
                           K.scatter_add_rows_plain):
        err_plain = _held(f"[f1] {name} K3 vs plain route", got, call(),
                          1e-5, faults)
    with mock.patch.object(sampling, "_PROD_BWD_CHUNK", N + 1):
        err_whole = _held(f"[f1] {name} chunked vs unchunked", got, call(),
                          1e-5, faults)
        whole_launches = _launches_of(call)
    del got
    launches = _launches_of(call)
    want = {"scatter_add_rows": 2 * chunks}
    if launches != want or whole_launches != {"scatter_add_rows": 2}:
        faults.append(f"[f1] {name}: launches {launches} (want {want}), "
                      f"unchunked {whole_launches} (want 2)")
    return {"plane": [H, W, R], "line": [D, R], "samples": N,
            "chunks": chunks, "err_plain_route": err_plain,
            "err_unchunked": err_whole, "launches": launches,
            "ms": time_ms(call, reps=REST_REPS, warmup=1)}


def f1_line(name, line, n_rays, S, gen, faults):
    """sample_line on n_rays x S march-order samples: values and
    gradients on the K3 route against the plain route, K3 once a
    backward, ms forward + backward."""
    import torch

    from joint_tensorf_tpu_torch.ops import sampling
    from joint_tensorf_tpu_torch.ops import segment_scatter as K

    D, R = line.shape
    w = march_coords(n_rays, S, (2, 2, D), gen)[2]
    cot = torch.randn((n_rays * S, R), generator=gen, device="cuda")

    def call():
        return _fwd_bwd(sampling.sample_line, (line, w), cot)

    got = call()
    with mock.patch.object(sampling, "scatter_add_rows",
                           K.scatter_add_rows_plain):
        err = _held(f"[f1] {name} K3 vs plain route", got, call(), 1e-5,
                    faults)
    del got
    launches = _launches_of(call)
    if launches != {"scatter_add_rows": 1}:
        faults.append(f"[f1] {name}: launches {launches}, want one K3")
    return {"line": [D, R], "samples": n_rays * S, "err_plain_route": err,
            "launches": launches,
            "ms": time_ms(call, reps=REST_REPS, warmup=1)}


def f1_llff_memory(gen, faults):
    """One fused sample of the LLFF appearance plane and line (F1_LLFF:
    4420 x 1000 samples, 20 components, its line 771 long): the peak
    memory its backward adds over the forward's, ms forward + backward
    and K3 launches, beside the [N, 771] float32 one-hot the line's
    gradient took before it went through K3."""
    import torch

    from joint_tensorf_tpu_torch.ops import sampling

    n_rays, S, (X, Y, Z), R = F1_LLFF
    plane = torch.rand((Y, X, R), generator=gen, device="cuda")
    line = torch.rand((Z, R), generator=gen, device="cuda")
    u, v, w = march_coords(n_rays, S, (X, Y, Z), gen)
    N = n_rays * S
    cot = torch.randn((N, R), generator=gen, device="cuda")
    leaves = [t.detach().requires_grad_(True)
              for t in (plane, line, u, v, w)]
    torch.cuda.synchronize()
    out = sampling.sample_planeline_prod(*leaves)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    from joint_tensorf_tpu_torch.ops import cuda_build

    cuda_build.reset_launches()
    grads = torch.autograd.grad(out, leaves, cot)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    finite = all(torch.isfinite(g).all() for g in grads)
    del out, grads
    chunks = -(-N // sampling._PROD_BWD_CHUNK)
    if launches != {"scatter_add_rows": 2 * chunks} or not finite:
        faults.append(f"[f1] llff line: launches {launches} (want "
                      f"{2 * chunks}), finite {finite}")
    inputs = (plane.detach(), line.detach(), u.detach(), v.detach(),
              w.detach())
    ms = time_ms(lambda: _fwd_bwd(sampling.sample_planeline_prod, inputs,
                                  cot), reps=REST_REPS, warmup=1)
    return {"plane": [Y, X, R], "line": [Z, R], "samples": N,
            "chunks": chunks, "launches": launches,
            "backward_peak_gb": peak, "ms": ms,
            "onehot_gb": N * Z * 4 / 1e9}


def run_f1_phase(trainer, n_rays, cfg, gen):
    """[f1] the fused factor sample's backward in chunks of at most
    _PROD_BWD_CHUNK samples with its line gradient through K3, on the
    default path's trained state (its last phase: the 423x359x420 grid,
    density R 16, appearance R 48): the density and appearance factors of
    the largest plane at n_rays x S (2028 x 1000: two chunks) held
    against the plain route and the unchunked call (f1_fused); sample_line
    at CP-384's widths on the longest line (density 96 components on
    every sample, appearance 288 on app_k a ray: f1_line); the LLFF
    appearance line's backward peak and ms (f1_llff_memory); K3 against
    index_add_ and the one-hot matmul at every line shape the trainers now
    give it (a chunk of at most _PROD_BWD_CHUNK rows for the fused sample,
    all samples for sample_line).  Prints one [f1] line per part; returns
    ({"f1": ...}, K3's rows at the line shapes)."""
    import torch

    from joint_tensorf_tpu_torch.models.vm import MAT_MODE, VEC_MODE
    from joint_tensorf_tpu_torch.ops import sampling

    t0 = time.perf_counter()
    faults = []
    field = trainer.state.field
    res = field.resolution()
    S, app_k = cfg.n_samples, cfg.app_k or cfg.n_samples
    i = max(range(3), key=lambda a: res[MAT_MODE[a][0]] * res[MAT_MODE[a][1]])
    j = max(range(3), key=lambda a: res[VEC_MODE[a]])
    out = {"fused": {}, "line": {}}
    for name, plane, line in (
            ("density", field.density_planes[i], field.density_lines[i]),
            ("appearance", field.app_planes[i], field.app_lines[i])):
        row = f1_fused(name, plane.detach().float(), line.detach().float(),
                       n_rays, S, gen, faults)
        out["fused"][name] = row
        print(f"[f1] fused {name} {row['plane']} x {row['line']} at "
              f"{row['samples']} samples ({row['chunks']} chunks): K3 vs "
              f"plain route {row['err_plain_route']:.3g}, vs unchunked "
              f"{row['err_unchunked']:.3g}, launches {row['launches']}, "
              f"fwd+bwd {row['ms']:.3f} ms", flush=True)
        torch.cuda.empty_cache()
    D = res[VEC_MODE[j]]
    for name, R, per_ray in (("cp_density", F1_CP[0], S),
                             ("cp_appearance", F1_CP[1], app_k)):
        line = torch.rand((D, R), generator=gen, device="cuda")
        row = f1_line(name, line, n_rays, per_ray, gen, faults)
        out["line"][name] = row
        print(f"[f1] sample_line {name} {row['line']} at {row['samples']} "
              f"samples: K3 vs plain route {row['err_plain_route']:.3g}, "
              f"launches {row['launches']}, fwd+bwd {row['ms']:.3f} ms",
              flush=True)
        torch.cuda.empty_cache()
    llff = f1_llff_memory(gen, faults)
    out["llff"] = llff
    print(f"[f1] LLFF appearance {llff['plane']} x {llff['line']} at "
          f"{llff['samples']} samples ({llff['chunks']} chunks): backward "
          f"peak {llff['backward_peak_gb']:.2f} GB over the forward's "
          f"(the one-hot alone was {llff['onehot_gb']:.1f} GB), fwd+bwd "
          f"{llff['ms']:.2f} ms, launches {llff['launches']}", flush=True)
    torch.cuda.empty_cache()
    # K3 at the line shapes as the trainers call it: a fused sample's
    # chunk (2R channels of its line) and a whole sample_line
    ck = sampling._PROD_BWD_CHUNK
    shapes = [("density line chunk", 2 * field.density_lines[i].shape[1],
               field.density_lines[i].shape[0], min(n_rays * S, ck)),
              ("appearance line (app_k)", 2 * field.app_lines[i].shape[1],
               field.app_lines[i].shape[0], min(n_rays * app_k, ck)),
              ("llff appearance line chunk", 2 * F1_LLFF[3], F1_LLFF[2][2],
               ck),
              ("cp density line", 2 * F1_CP[0], D, n_rays * S),
              ("cp appearance line (app_k)", 2 * F1_CP[1], D,
               n_rays * app_k)]
    k3_rows = []
    for name, C, n_rows, N in shapes:
        w = march_coords(-(-N // S), S, (2, 2, n_rows), gen)[2][:N]
        idx = sampling._floor_frac(sampling._pix(w, n_rows), n_rows)[0]
        k = rest_k3(idx.contiguous(), C, n_rows, gen, faults)
        k["path"] = f"[f1] {name}"
        k3_rows.append(k)
        print(f"[f1] K3 {name}: {N} x {C} into {n_rows} rows {k['ms']:.4f} "
              f"ms (device {k['device_ms']:.4f}), one-hot "
              f"{k['onehot_ms']:.4f}, index_add_ {k['library_ms']:.4f}, "
              f"bound {k['bound_ms']:.4f} ({k['bound_by']}), err march "
              f"{k['max_rel_err_march']:.3g} / one row "
              f"{k['max_rel_err_one_row']:.3g}", flush=True)
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"[f1] phase: {wall:.1f} s", flush=True)
    out.update(k3=k3_rows, wall_s=wall)
    emit({"f1": out})
    if faults:
        fail("[f1]: " + "; ".join(faults))
    return out, k3_rows


# ------------------------------------- [entry]: the root's entry points
ENTRY_RANKS = (2, 4)


def run_entry_phase(smi=""):
    """[entry] the port's graft_entry and run_experiments on the card:
    entry()'s render held against entry(device="cpu") (the same state,
    rays and offsets) within 1e-5 of the largest output, its K1 launch
    counted (counters zeroed just before and read just after) and its ms;
    dryrun_multichip(2) and (4), gloo ranks on cuda:0, with the seconds
    each took; the scheduler over two slots on two tiny train CLIs
    (TINY_CLI_ARGS on the blob and solids scenes, both on this card) with
    their return codes and seconds."""
    import shutil
    import tempfile

    import torch

    from joint_tensorf_tpu_torch import graft_entry
    from joint_tensorf_tpu_torch import run_experiments as sched
    from joint_tensorf_tpu_torch.ops import cuda_build

    faults, out = [], {"card": smi}
    fn, args = graft_entry.entry()
    fn_c, args_c = graft_entry.entry(device="cpu")
    with torch.no_grad():
        fn(*args)
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        got = fn(*args)
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        want = fn_c(*args_c)
        largest = max(float(w.abs().max()) for w in want)
        err = max(float((g.cpu() - w).abs().max())
                  for g, w in zip(got, want))
        ms = time_ms(lambda: fn(*args))
    finite = all(torch.isfinite(g).all() for g in got)
    if err > 1e-5 * largest or not finite or \
            launches != {"composite_fwd": 1}:
        faults.append(f"entry(): err {err:.3g} of {largest:.3g}, finite "
                      f"{finite}, launches {launches}")
    out["entry"] = {"shapes": [list(g.shape) for g in got],
                    "max_abs_err_vs_cpu": err, "largest": largest,
                    "launches": launches, "ms": ms}
    print(f"[entry] entry(): {out['entry']['shapes']} on the card vs the "
          f"CPU {err:.3g} (largest output {largest:.3g}), launches "
          f"{launches}, {ms:.3f} ms ({smi})", flush=True)
    for n in ENTRY_RANKS:
        t0 = time.perf_counter()
        ranks = graft_entry.dryrun_multichip(n)
        secs = time.perf_counter() - t0
        out[f"dryrun_{n}"] = {"s": secs, "rank0": ranks[0]}
        print(f"[entry] dryrun_multichip({n}): {n} gloo ranks on cuda:0, "
              f"{secs:.1f} s", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sched_")
    try:
        class A:
            yaml = os.path.join(HERE, "configs", "bat_blender_VM.yaml")
            scenes = ["blobs", "solids"]
            mode = "train"
            prefix = "sched_"
            group = "sched"

        cmds = sched.build_commands(A, [*TINY_CLI_ARGS,
                                        f"--output_root={tmp}"])
        t0 = time.perf_counter()
        results = sched.run_scheduler(cmds, n_slots=2)
        secs = time.perf_counter() - t0
        written = {s: os.path.exists(os.path.join(
            tmp, "sched", f"sched_{s}", "model.ckpt.npz"))
            for s in A.scenes}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rcs = [rc for _, rc in results]
    out["scheduler"] = {"slots": 2, "return_codes": rcs, "s": secs,
                        "checkpoints": written}
    print(f"[entry] run_experiments: 2 tiny train CLIs over 2 slots on one "
          f"card, return codes {rcs}, {secs:.1f} s, checkpoints "
          f"{written}", flush=True)
    if rcs != [0, 0] or not all(written.values()):
        faults.append(f"scheduler: {out['scheduler']}")
    emit({"entry_phase": out})
    if faults:
        fail("[entry]: " + "; ".join(faults))
    return out


def main(argv):
    if argv and (len(argv) != 2 or argv[0] != "--profile"):
        fail(f"usage: python3 chip_smoke.py [--profile DIR], got {argv}")
    profile_dir = argv[1] if argv else None

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "joint_tensorf_tpu_torch")):
        print("chip_smoke: the joint_tensorf_tpu_torch package is not next "
              "to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from joint_tensorf_tpu_torch.ops import cuda_build
    from joint_tensorf_tpu_torch.utils import setup_torch

    setup_torch()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi printed nothing", flush=True)
    emit({"nvidia_smi": smi[0] if smi else None,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    took = cuda_build.build_all()
    emit({"build": took, "seconds": time.perf_counter() - t0})

    gen = torch.Generator(device="cuda").manual_seed(0)
    for r in check_composite(2028, 221, 1e-6, gen, tol=1e-4):
        emit({"kernel_check": r})
    emit({"kernel_check": check_scatter(2028, 221, 64, 64, 256, gen,
                                        tol=1e-5)})
    emit({"kernel_check": check_scatter(2028, 221, 400, 400, 256, gen,
                                        tol=1e-5)})
    binned = [check_binned(400, 400, 64, 2028 * 1000, gen, 1e-5, "march")]
    for H, W, R, N in ((300, 300, 64, 2000000), (300, 300, 64, 524288),
                       (128, 128, 64, 886000)):
        binned.append(check_binned(H, W, R, N, gen, 1e-5))
    binned.append(check_binned(257, 257, 64, 2028 * 1000, gen, 0.0,
                               "one_cell"))
    for r in binned:
        emit({"kernel_check": r})
    tiled = check_tiled_all(gen)
    for r in tiled:
        emit({"kernel_check": r})
    emit({"kernel_check": check_density_sample(gen)})
    emit({"kernel_check": check_app_sample(gen)})
    torch.cuda.empty_cache()
    emit(check_small_step())
    emit(check_small_l2g_ndc())
    emit(check_solids_render())
    entry, entry_launches = run_entry_points(gen)
    emit(entry)

    result, launches, (n_rays, cfg, res) = run_main_path(N_STEPS,
                                                         profile_dir)
    emit(result)
    main_cfg = cfg
    # K1/K2 and K3 at the main path's own shapes: the samples each ray
    # composites; the appearance planes' gradient (4 x 48 packed channels)
    # on the app_k samples of each ray.  K3 into a 3-D grid's rows at that
    # resolution is a CP or bf16-row field's dense grid (this field's
    # density is K6's, checked at each phase's shape in run_all_phases)
    S = min(cfg.compact_k or cfg.n_samples, cfg.n_samples)
    rows = check_composite(n_rays, S, 1e-6, gen, tol=1e-4)
    for r in rows:
        emit({"kernel_check": r})
    dense_rows = check_scatter(n_rays, S, 0, 0, 8, gen, tol=1e-5,
                               grid3d=tuple(res))
    dense_rows["path"] = "3-D grid rows at the main path's resolution"
    emit({"kernel_check": dense_rows})
    scatter = check_scatter(n_rays, min(cfg.app_k, S), res[1], res[0], 192,
                            gen, tol=1e-5)
    emit({"kernel_check": scatter})
    # and the appearance lines' gradient (2 x 48 packed channels) into the
    # longest line, the most collisions of the path's scatters
    main_line = check_scatter(n_rays, min(cfg.app_k, S), 0, 0, 2 * 48, gen,
                              tol=1e-5, line=max(res))
    main_line["path"] = "main path appearance line"
    emit({"kernel_check": main_line})
    torch.cuda.empty_cache()
    n_rays, S, res, cfg, (S_blur, res_blur), trained = run_all_phases(
        "tpu_default", (), profile_dir)
    torch.cuda.empty_cache()
    # K3 into a 3-D grid's rows at the blurred phase's last resolution (64M
    # voxels at this schedule; a CP or bf16-row field's dense grid): the
    # samples each ray kept there
    emit({"kernel_check": check_scatter(n_rays, S_blur, 0, 0, 8, gen,
                                        tol=1e-5, grid3d=tuple(res_blur))})
    torch.cuda.empty_cache()
    # K1-K3 again at the shapes the default path's last phase gave them: the
    # compacted samples of each ray, and K3 into the largest of the three
    # planes (density planes: 4 x 16 packed channels on every kept sample;
    # appearance: 4 x 48 on app_k of them)
    from joint_tensorf_tpu_torch.models.vm import MAT_MODE

    Hp, Wp = max(((res[m1], res[m0]) for m0, m1 in MAT_MODE),
                 key=lambda hw: hw[0] * hw[1])
    for r in check_composite(n_rays, S, 1e-6, gen, tol=1e-4):
        emit({"kernel_check": r})
    emit({"kernel_check": check_scatter(n_rays, S, Hp, Wp, 64, gen,
                                        tol=1e-5)})
    emit({"kernel_check": check_scatter(n_rays, min(cfg.app_k or S, S), Hp,
                                        Wp, 192, gen, tol=1e-5)})
    torch.cuda.empty_cache()
    # the host syncs of BAT's last 3 steps (L2G's are counted the same way)
    trained[0].it -= 3
    syncs = count_host_syncs(trained[0], 3)
    print(f"[bat] host syncs per step (sync debug 'warn', last phase, "
          f"schedule updates included): {syncs}", flush=True)
    emit({"bat_host_syncs_per_step": syncs})
    # evaluation and viz/ on the default path's trained state, then its
    # trainer goes
    emit(run_eval_phase(*trained))
    emit(run_viz_phase(*trained))
    torch.cuda.empty_cache()
    # [rest]: the lane grid, the hybrids, queued checkpoints and the small
    # helpers at the last phase's shapes, K3 at its new ones
    _, rest_k3_rows = run_rest_phase(trained[0], trained[1], n_rays, cfg,
                                     gen)
    torch.cuda.empty_cache()
    # [f1]: the fused sample's chunked backward and the line gradients
    # through K3, on the same state
    _, f1_k3_rows = run_f1_phase(trained[0], n_rays, cfg, gen)
    del trained
    torch.cuda.empty_cache()
    emit(check_small_eval())
    emit(check_small_grad_viz())
    emit(run_option_steps())
    torch.cuda.empty_cache()
    emit(run_cli_options())
    # the alternatives off, at the same cut schedule: every slot of S =
    # 1000 composited, K3 on the fused planes' 4 x 64 channels
    n_rays, S, res, _, _, _ = run_all_phases("alternatives_off",
                                             ALTERNATIVES_OFF)
    torch.cuda.empty_cache()
    for r in check_composite(n_rays, S, 1e-6, gen, tol=1e-4):
        emit({"kernel_check": r})
    emit({"kernel_check": check_scatter(n_rays, S, Hp, Wp, 256, gen,
                                        tol=1e-5)})
    torch.cuda.empty_cache()
    # TensoRF and BAT on the solids scene through every phase, then K1-K3
    # at the shapes of each one's last phase (the composited samples; the
    # density planes' 4 x 16 channels on every kept sample, the
    # appearance planes' 4 x 48 on app_k of them) and, for the solids, K3
    # on the blurred phase's dense grid at the last resolution
    for label, yaml, args, sparse in (
            ("tensorf", "tensorf_blender_VM.yaml", TENSORF_ARGS, True),
            ("solids", "bat_synthetic_convergence_20k.yaml", SOLIDS_ARGS,
             False)):
        n_rays, S, res, cfg, blurred, trained = run_all_phases(
            label, yaml=yaml, base_args=args, sparse=sparse)
        del trained
        torch.cuda.empty_cache()
        Hp, Wp = max(((res[m1], res[m0]) for m0, m1 in MAT_MODE),
                     key=lambda hw: hw[0] * hw[1])
        for S_k in sorted({S, cfg.n_samples}):
            for r in check_composite(n_rays, S_k, 1e-6, gen, tol=1e-4):
                emit({"kernel_check": dict(r, path=label)})
        emit({"kernel_check": dict(check_scatter(
            n_rays, S, Hp, Wp, 64, gen, tol=1e-5), path=label)})
        emit({"kernel_check": dict(check_scatter(
            n_rays, min(cfg.app_k or S, S), Hp, Wp, 192, gen, tol=1e-5),
            path=label)})
        if blurred:
            emit({"kernel_check": dict(check_scatter(
                n_rays, blurred[0], 0, 0, 8, gen, tol=1e-5,
                grid3d=tuple(blurred[1])), path=label)})
        torch.cuda.empty_cache()
    run_variants()
    torch.cuda.empty_cache()
    emit(run_field_zoo(gen))
    torch.cuda.empty_cache()
    # L2G-BAT through every phase, then K1-K3 at its last phase's shapes
    n_rays, S, res, cfg, _, trained = run_l2g()
    del trained
    torch.cuda.empty_cache()
    Hp, Wp = max(((res[m1], res[m0]) for m0, m1 in MAT_MODE),
                 key=lambda hw: hw[0] * hw[1])
    for r in check_composite(n_rays, S, 1e-6, gen, tol=1e-4):
        emit({"kernel_check": dict(r, path="l2g")})
    emit({"kernel_check": dict(check_scatter(
        n_rays, S, Hp, Wp, 64, gen, tol=1e-5), path="l2g")})
    torch.cuda.empty_cache()
    # BAT on the NDC route, then K1/K2 and K3 at its last phase's shapes
    # (S = 1000 dense; the appearance planes' 20 channels), and at the
    # final 800^3 grid: 3 steps and K3 into its 510M rows
    n_rays, S, res = run_ndc_route()
    Hp, Wp = max(((res[m1], res[m0]) for m0, m1 in MAT_MODE),
                 key=lambda hw: hw[0] * hw[1])
    for r in check_composite(n_rays, S, 1e-7, gen, tol=1e-4):
        emit({"kernel_check": dict(r, path="llff")})
    emit({"kernel_check": dict(check_scatter(
        n_rays, S, Hp, Wp, 20, gen, tol=1e-5), path="llff")})
    torch.cuda.empty_cache()
    n_rays, S, res = run_llff_final_grid()
    # K3 into a 3-D grid's rows at that resolution (a CP or bf16-row
    # field's dense grid; this field's density is K6's)
    emit({"kernel_check": dict(check_scatter(
        n_rays, S, 0, 0, 8, gen, tol=1e-5, grid3d=tuple(res)),
        path="llff_800 3-D grid rows")})
    torch.cuda.empty_cache()
    # BARF, MLP-NeRF with fine sampling and the planar images: none of
    # K1-K7 on their paths; their small steps on the card against the CPU
    emit(check_small_mlp_planar())
    run_mlp_nerf("barf_blender.yaml")
    run_mlp_nerf("nerf_blender_repr.yaml", ["--nerf.density_noise_reg=1"])
    run_planar()
    torch.cuda.empty_cache()
    # the rays and comp layouts of bat_blender_VM_pod16.yaml: one NCCL
    # rank through every phase, then 2 and 4 gloo ranks on this card
    # against it, then [1,2] and [2,2] over [rays,comp]
    run_parallel(smi=smi[0] if smi else "", gen=gen)
    torch.cuda.empty_cache()
    # [entry]: the port's graft_entry (entry(), the dry runs) and its
    # experiment scheduler
    run_entry_phase(smi=smi[0] if smi else "")
    torch.cuda.empty_cache()
    launches.update(entry_launches)
    kernels = []
    # K1 and K2 as the main path's step calls them: K2 with g_weights when
    # the two-stage appearance gathers the selected weights
    main_k2 = rows[2] if main_cfg.app_k is not None else rows[1]
    for r in [rows[0], main_k2, scatter, binned[0], tiled[0]]:
        k = {key: r[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        k["launches"] = launches[r["name"]]
        if r["name"] == "scatter_add_rows":
            # K3 at the shapes of the lane grid's and the hybrid lines'
            # backwards ([rest]) and at the trainers' line shapes ([f1])
            keys = ("N", "C", "n_rows", "max_abs_err", "ms", "device_ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "onehot_ms", "path")
            k["new_shapes"] = [{key: row[key] for key in keys if key in row}
                               for row in rest_k3_rows]
            main = dict(main_line["shape"], **main_line)
            k["line_shapes"] = [{key: row[key] for key in keys if key in row}
                                for row in [main] + f1_k3_rows]
        kernels.append(k)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
