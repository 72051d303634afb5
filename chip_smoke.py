#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nnuzoo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, one line each (a failure anywhere exits non-zero):
  1. the card's name and power limit; builds every CUDA kernel from
     ``nnuzoo_tpu_torch/csrc`` (one nvcc per source, in parallel);
  2. the selective-scan forward kernel against its plain PyTorch version at
     every scan shape of the main paths (batch 4 as serving runs it, timed
     without carries; batch 12 as training does, timed with them), its y and
     the carries it writes for the backward, and the backward kernel on those
     carries against its plain version at batch 12, each also at L=12, at
     K*Dh=1024 and on steep-decay inputs (delta up to 4, A down to -16), with
     errors, times and bounds; then both kernels again at each (L, K*Dh) of
     M2Net's that M2NetP does not have (K*Dh 256, 512 and 1024);
  3. one SS2D (forward, and backward for the input and every parameter) and
     one MU at stage-1 width and 256x224, kernel path against plain path;
  4. serving end to end: M2NetP at full width and depth (7, 6, 5, 4), seeded
     weights, through ``Predictor.predict_single_npy_array`` (2d plans, patch
     256x224, mirror TTA, tile batch 4) on a seeded 1x4x224x256 volume,
     after a warm-up of one tile batch; the scan launches of that run,
     seconds per volume, and one tile batch's logits from the kernel path
     and the fp32 plain path, each against the plain path in fp64 (with
     the mirrors for M2NetP at full depth; every other model's tile check,
     here and in the phases below, is one pass without them);
  5. training end to end: a seeded preprocessed 2d dataset is written to a
     temporary folder and ``Trainer(...).run_training()`` of
     ``nnUNetTrainerM2NetP`` (full depth, patch 256x224, batch 12) takes one
     epoch of TRAIN_STEPS (2) steps and 1 validation step (so do the other
     training phases); the losses, seconds per step,
     scan launches per step and peak memory;
  6. one training step's loss and gradients, kernel path and fp32 plain path
     from the same weights and batch, each against the plain path in fp64,
     for M2NetP with weights drawn from a fixed seed, on batches that
     samplers with fixed seeds draw from phase 5's dataset (not the trained
     weights, which differ from run to run: training is not bit-reproducible
     on the card): at stage layers (1, 1, 1, 1) on the batches of six
     sampler seeds, each within absolute limits and the median of the
     kernel path's error over the plain path's within 2x; at full depth on
     one seeded batch;
  7. the checkpoint of phase 5 loaded through
     ``Predictor.initialize_from_trained_model_folder`` predicts a volume;
  8. the file-to-file paths on phase 5's model: its final validation on
     the fold's first case (so do phases 13, 21 and 30;
     ``Trainer.perform_actual_validation``, segmentations written through
     the plans' NIfTI writer and scored against ``gt_segmentations``), then
     the command line's ``predict`` entry on a seeded raw folder of two
     1x4x224x256 ``.nii.gz`` cases from phase 5's results folder, each
     written segmentation held to ``predict_single_npy_array`` on the same
     image, and its ``evaluate_folder`` entry against the labels; seconds per
     case (read, preprocess, device, export), K1 launches and Dice;
  9. the fused cross-scan kernels (K3 forward, K4 backward) against their
     plain versions at every scan length of the main paths, in both traversal
     orientations (K3 at batch 4 as serving runs it, timed without carries,
     and at batch 12 as training does, timed with them; K4 at batch 12 on
     K3's carries), at L=12, a ragged L and M2Net's width, with errors,
     times and bounds; then both again at each (L, Dh, R) of M2Net's that
     M2NetP does not have (Dh 64, 128 and 256 with R 2, 4 and 8);
 10. one SS2D at stage-1 width with the fused glue against the default
     glue, forward and every gradient, both on the kernels;
 11. serving with the fused glue (``NNUZOO_SS2D_FUSED=1``): phase 4 again
     with M2NetP at stage layers (1, 1, 1, 1) (phases 11-13 repeat phases
     4, 5 and 8, which run it at full depth), 16 K3 launches and no K1
     launch per forward;
 12. training with the fused glue: phase 5 again at stage layers (1, 1, 1,
     1), 16 K3 and 16 K4 launches and no K1/K2 launch per step, then the
     steps at stage layers (1, 1, 1, 1) on the six seeded batches against
     fp64 as in phase 6;
 13. phase 8 with the fused glue on phase 12's model: K3 launches and no K1
     launch;
 14. from a raw dataset, default glue: a seeded raw folder (three training
     cases of (z, y, x) 80x256x224 at spacing (3, 1, 1), two test cases of
     4x256x224, ``.nii``) planned and preprocessed by the command line's
     ``plan_and_preprocess`` (the 2d plan must be patch [256, 224] at batch
     12, every case's ``class_locations`` must hold labels 1 and 2), then
     ``run_training`` at full depth on fold 0 (one epoch of 2 steps and one
     validation step, 80 K1 and 80 K2 launches a step) with its final
     validation, ``predict_from_modelfolder`` on the test images and
     ``evaluate_simple`` against their labels; seconds of fingerprint,
     planning and preprocessing per case, seconds per step and Dice;
 15. M2Net (``nnUNetTrainerM2Net``) at full width and depth, each glue
     (after phase 4, and after phase 11 with the fused glue): phase 4's
     serving and tile-batch checks, 80 K1 or 160 K3 launches a forward;
 16. M2Net training, each glue (after phase 8, and after phase 13): phase
     5 on phase 5's dataset, 80 K1 and 80 K2 or 160 K3 and 160 K4 launches
     a step (the family's full-depth step against fp64 is M2NetP's, phase
     6);
 17. the fine-tuning trainer (``nnUNetTrainerFineTuneDecoderWarmUp``,
     M2Net) from phase 16's fold through ``load_pretrained_weights``: 2
     steps with the encoder frozen, every frozen parameter bit for bit the
     loaded one, then 2 steps after which every one has moved;
 18. one M2Net step at batch 12 with ``remat`` off, off again and on, each
     glue: the forward kernel's launches with remat on the remat-off count,
     the peak memory of each, the gradients held to the remat-off step's;
 19. the nnU-Net CNN baselines on phase 14's raw dataset at 3d, after it:
     the command line's ``plan_and_preprocess -c 3d_fullres`` with the
     default planner and with ``-pl ResEncUNetPlanner``, ``train <id>
     3d_fullres 0`` with the default trainer (``nnUNetTrainer``,
     PlainConvUNet, SGD) and with ``-tr nnUNetTrainerResEncUNet -p
     nnUNetResEncUNetPlans`` (ResidualEncoderUNet), each cut to one epoch of
     2 steps and one validation step, with the final validation, then
     ``predict_from_modelfolder`` and ``evaluate_simple`` on the test
     cases; seconds per step and Dice;
 20. ``nnUNetTrainer`` at 3d_fullres at full width
     (benchmarks/zoo_sweep.py's plan: patch 48x192x192, 6 stages of 32-320
     features, 30.7M parameters), serving: ``predict_single_npy_array`` on
     a seeded 1x64x256x256 volume (8 tiles, mirror TTA over 3 axes, tile
     batch 2), seconds per volume, one tile batch's logits against the
     model in fp64 by phase 4's limits;
 21. the same model training: ``run_training`` on three seeded preprocessed
     1x80x256x256 cases (2 steps at batch 2, SGD and poly, one validation
     step), its final validation, one step's loss and gradient against fp64
     (CNN_STEP_LIMITS), and one profiled step for the device's busy share;
 22. ``nnUNetTrainer`` at 2d at full width (benchmarks/bench_inference.py's
     PlainConvUNet, 256x224): phase 4's serving and tile check, 2 training
     steps at batch 12 on phase 5's dataset;
 23. ``nnUNetTrainerU2NetP`` and ``nnUNetTrainerU2Net`` at 256x224: phase
     22 again for each;
     phases 19-23 print seconds, peak memory and the launches of K1-K4,
     which must be none;
 24. the Mamba baselines, after phase 3: K1 (with the chunk
     carries, and timed without) and K2 against their plain versions at
     every (L, K*Dh, K) of SwinUMamba(D), LightMUNet, LightSS2DMambaUNet and
     SegMamba that no earlier phase has (MAMBA_SCANS_2D at batch 12,
     MAMBA_SCANS_3D at batch 2; K=1 with K*Dh 64-768, K=4 with K*Dh up to
     6144, lengths up to 1.77M), and on steep-decay inputs;
 25. one MambaBlock (bimamba None and "v3") at SegMamba's stage-0 width and
     one LightMUNet MambaLayer, kernel path against plain path, output and
     every gradient;
 26. serving each of the five Mamba trainers at full width with seeded
     weights (after phase 15): phase 4's volume, settings and tile-batch
     check, K1 launches a forward as the CPU tests' scan tables count them;
 27. training each of them (after phase 16, on phase 5's dataset): 2 steps
     at batch 12 and a validation step, K1 and K2 launches a step, peak
     memory; one full-width step against fp64 for SegMamba (one model of
     the family) by phase 16's rule;
 28. LightMUNet and SegMamba at 3d_fullres on phase 20-21's plan and
     dataset (after phase 23): serving one tile of the plan
     (1x48x192x192, mirror TTA over 3 axes) and 2
     training steps at batch 2, seconds, peak memory and launches;
 29. the nnU-Net cascade on phase 14's raw dataset, after phase 19:
     ``add_lowres_and_cascade``, ``preprocess -c 3d_lowres``, ``train <id>
     3d_lowres all`` (PlainConvUNet at the planner's widths, 2 steps and a
     validation step; its final validation writes
     ``predicted_next_stage/3d_cascade_fullres/``), ``train <id>
     3d_cascade_fullres 0`` with the cascade augmentation on the card and
     its final validation on previous-stage input, ``predict`` with each
     stage (the second with ``-prev_stage_predictions``) and
     ``evaluate_folder``; seconds a step and peak memory of each stage, the
     cascade augmentation's device ms a batch apart from the step, the
     next-stage files and export seconds a case, Dice, no K1-K4 launch; its
     morphology and component removal on the card equal the CPU's bit for
     bit;
 30. the translation target: ``nnUNetTrainerM2NetP`` at full width and
     stage layers (1, 1, 1, 1) (phase 5 trains it at full depth) on a seeded
     2d dataset of float targets (phase 5's shapes, batch 12), 2 steps with
     8 K1 and 8 K2 launches each, its final validation
     and ``evaluate_folder`` with the regression metrics, and the step at
     stage layers (1, 1, 1, 1) against fp64 on six seeded batches, the
     median kernel-over-plain ratio within phase 6's 2x;
 31. the Transformer baselines' attention blocks, after phase 25, each at
     its full-width shape against its own fp64 twin on the card (output,
     and the gradient of the input and of every parameter): a ViTBlock at
     UNETR's width (768, 12 heads, 224 tokens, batch 12), a shifted
     SwinBlock at SwT's stage 0 (96 channels, 3 heads, 64x56 padded to
     70x56, batch 12), a shifted SwinBlockND at 3d SwinUNETR's stage 0 (48
     channels, 3 heads, 24x96x96 padded to 28x98x98, batch 2);
 32. ``nnUNetTrainerUNETR`` through the command line on phase 14's raw
     dataset and 2d plan (after phase 14): ``train <id> 2d 0 -tr
     nnUNetTrainerUNETR`` (one epoch of 2 steps and one validation step)
     with its final validation, ``predict_from_modelfolder`` and
     ``evaluate_simple``; seconds a step, peak memory, Dice;
 33. ``nnUNetTrainerUNETR``, ``nnUNetTrainerSwinTransformerUnet`` and
     ``nnUNetTrainerSwUNETR`` at 2d at full width (after phase 28): phase
     22's serving and tile check, 2 training steps at batch 12 on phase 5's
     dataset, and one full-width step against fp64
     (TRANSFORMER_STEP_LIMITS);
 34. UNETR and SwinUNETR at 3d_fullres on phase 20-21's plan and dataset:
     serving the 1x64x256x256 volume (with the tile check) and 2 training
     steps at batch 2;
     phases 31-34 print seconds, peak memory, TFLOP/s and the launches of
     K1-K4, which must be none;
 35. the LM2Net family (LM2Net, LM2NetP, LightMamba2Net, LightMamba2NetP),
     after phase 25: K1 (with the carries at batch 12, without them at
     batch 4) and K2 against their plain versions at every (L, K*Dh, K) of
     their scan tables (LM2NET_SCANS_2D; LightMamba2Net(P) on the mamba1
     route, LM2NET_MAMBA1_SCANS_2D) that no earlier phase has, K=1 with
     K*Dh 32-512 and L from 57,344 down to 28, and on steep decay at K*Dh
     32;
 36. one Mamba2Block at LightMamba2NetP's stage-1 width (d_model 32, 16
     heads, d_state 16) over 12x57,344 tokens: the SSD route against its
     fp64 twin (output to 1e-4 of its max, every gradient to 1e-3 of its
     max), against the mamba1 route on K1/K2 (2e-3), the ms of each route
     forwards and backwards and the SSD route's peak memory;
 37. serving each of the four at full width with seeded weights (after
     phase 34): phase 4's volume, settings and tile batch (LightMamba2Net(P)
     held to the ratio rule alone: their random weights amplify fp32
     rounding past the absolute limits), K1 launches a forward as the CPU
     tests' tables count them (none on SSD), none of K3/K4, TFLOP/s;
 38. training each of them on phase 5's dataset (2 steps at batch 12 and a
     validation step, K1/K2 launches a step, peak memory within the card
     without remat, TFLOP/s), one step of LM2Net (kernel and fp32 plain
     paths) and of LightMamba2Net (SSD) at full width with the stage minis
     at two levels against fp64 by phase 16's rule;
 39. LightMamba2Net's serving again on the mamba1 route
     (``NNUZOO_SCAN_BACKEND=mamba1``): 202 K1 launches a forward, its
     segmentation in argmax agreement with the SSD route's (ROUTE_AGREE_MIN);
 40. the SSND2Net family (SSND2Net, SSND2NetP), after phase 36: K1 (with
     the carries at batch 12, without them at batch 4; at 3d batch 2, timed
     both ways) and K2 against their plain versions at every (L, K*Dh, K)
     of SSND2NET_SCANS that no earlier phase has (K=4 with K*Dh up to 2048
     at 2d; K=6 with K*Dh 192-3072 and L up to 1,769,472 at 3d), and on
     steep decay at K=6;
 41. one SSND against its plain path (output and every gradient): d_model
     16 over 2x256x224 and d_model 128 over 2x32x28 on each glue, d_model
     16 over 2x48x192x192 on each glue (K=6 on K1/K2, G=3 on K3/K4);
 42. after phase 9's rows: K3 and K4 against their plain versions at every
     (L, G, Dh, R) of SSND2NetP's fused glue that phase 9 lacks, both
     orientations (L=28 at 2d; G=3 at 3d, batch 2, L up to 1,769,472);
 43. the family at 3d_fullres on phase 20-21's plan and dataset (after
     phase 34): serving one tile of the plan (1x48x192x192, mirror TTA over
     3 axes) with each name on the default glue and SSND2NetP on the fused
     glue (157 K1 or 314 K3 launches a forward), SSND2NetP's tile on the
     default glue against fp64 by the ratio rule (the plain scans in
     2048-step chunks), and training (2 steps at batch 2 and a validation
     step) of SSND2NetP on the fused glue with remat, each mini rerun whole
     (K3 twice a step, K4 once, at G=3), its peak within the card: the one
     3d training of the family that fits it;
 44. the family at 2d, after phase 39: serving (phase 4's volume and tile
     batch; the tile against fp64 by phase 4's limits for SSND2Net, by the
     ratio rule for SSND2NetP, whose random weights amplify fp32 rounding
     past the absolute limits) and training (2 steps at batch 12 and a
     validation step, peak memory within the card without remat,
     TFLOP/s) of each name on the default glue and SSND2NetP on the fused
     glue too (K1/K2 or K3/K4 launches a forward and a step as the tables
     say, none of the other glue's), one full-width step of SSND2NetP on
     the default glue and one on the fused glue with the stage minis at
     one level against fp64 by phase 16's rule;
 45. one JSON line ``{"kernels": [...]}`` listing K1-K4 with their launches
     on every path, M2Net's under the key ``m2net``, the Mamba baselines'
     under ``mamba``, the LM2Net family's under ``lm2net`` (K1 and K2) and
     the SSND2Net family's under ``ssnd2net`` (K1/K2 on the default glue's
     paths, K3/K4 on the fused glue's, each nonzero),
     on each CNN path, the cascade's included (none), under
     ``launches_on_cnn_paths``, on each Transformer path (none) under
     ``launches_on_transformer_paths``, and K3/K4 on each LM2Net-family
     path (none) under ``launches_on_lm2net_paths``; every SSND2Net path
     of phases 43-44 present with nonzero launches;
 46. last line ``{"ok": true, "device": {...}}``.
Every line is also written to ``chiprun_out/chip_smoke.jsonl``.
``--profile`` adds torch.profiler tables of one tile batch and of one
training step under ``chiprun_out/``, for each glue. fp32 throughout (but
for the fp64 references of phases 4, 6, 11, 12, 15, 20-23, 26, 27, 30,
31, 33, 34, 36-38, 43 and 44),
TF32 off for matmuls and convolutions. Phases 14, 19 and 29 run the port's
own planning and preprocessing on the host (numpy and scipy, 4 threads).
To fit the time limit, the depth of earlier paths is cut: TRAIN_STEPS
and CASCADE_STEPS 3 -> 2, M2Net's full-depth step against fp64 left to
M2NetP's (phase 6), the Mamba baselines' to SegMamba's, the LM2Net
family's two at stage minis of two levels, the Mamba baselines'
3d serving on one tile of the plan, and ``phase_cnn_serving``'s warm-up
one pass of a tile batch without the mirrors.
"""

import contextlib
import copy
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PATCH = (256, 224)
TILE_BATCH = 4
TRAIN_BATCH = 12
TRAIN_STEPS = 2
KD, N_STATE, K_DIRS = 128, 16, 4
# (L, scan calls with that L in one forward of M2NetP at 256x224)
PATH_SHAPES = [(57344, 4), (14336, 8), (3584, 12), (896, 16), (224, 16), (56, 24)]
SCANS_PER_FORWARD = sum(n for _, n in PATH_SHAPES)
# the fused glue: G=2 axis orders of Dh=32 channels, dt rank 1; two
# cross-scan calls (one per orientation) where the default glue makes one scan
CROSS_G, CROSS_DH, CROSS_R = 2, 32, 1
FUSED_PER_FORWARD = 2 * SCANS_PER_FORWARD
# M2Net at 256x224: each stage's SS2D d_model and its (L, scan calls with
# that L in one forward), the stage and its decoder twin together; 80 calls
# in all. The default glue scans K*Dh = 4*2*d_model channels; the fused glue
# G=2 streams of Dh = 2*d_model with dt rank R = ceil(d_model/16).
M2NET_STAGES = [
    (16, [(57344, 4), (14336, 4), (3584, 4), (896, 4), (224, 4), (56, 6)]),
    (32, [(14336, 4), (3584, 4), (896, 4), (224, 4), (56, 6)]),
    (64, [(3584, 4), (896, 4), (224, 4), (56, 6)]),
    (128, [(896, 4), (224, 4), (56, 6)])]
# {(L, K*Dh): calls in one forward} and {(L, Dh, R): calls in each orientation}
M2NET_SCANS = {(L, 8 * d): n for d, shapes in M2NET_STAGES for L, n in shapes}
M2NET_CROSS = {(L, 2 * d, -(-d // 16)): n for d, shapes in M2NET_STAGES
               for L, n in shapes}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# exp2 (the special function units: 16 a clock on each of 132 SMs at the
# 1.98 GHz boost clock; CUDA C++ Programming Guide, arithmetic instructions)
PEAK_EXP2_PER_S = 16 * 132 * 1.98e9
# tolerances: scan kernel vs plain, fp32 (exp2 and another association)
SCAN_TOL = 1e-4          # max abs error / max |y|
SS2D_TOL = 1e-4          # max abs error / max |out| for one SS2D
MU_TOL = 1e-3            # max abs error / range for one MU
# one tile batch of M2NetP at full depth with random weights, each fp32 path
# (kernel, plain) against the plain path in fp64. On an H100 both fp32 paths
# read 4.2-4.8% of the range in max abs error, 3.4-3.6e-4 in mean and 0.998
# in argmax agreement: fp32 rounding grows through the net's depth whichever
# scan runs. The limits sit about 2x outside those readings.
TILE_MAX_TOL = 0.1       # max abs error / range of the fp64 logits
TILE_MEAN_TOL = 1e-3     # mean abs error / range
AGREE_MIN = 0.99         # argmax agreement with the fp64 logits
KERNEL_MEAN_RATIO = 1.5  # kernel path's mean abs error / the fp32 plain path's
# backward scan kernel vs its plain version, fp32: max abs error of each
# gradient (du, ddelta, dbc, dA) / that gradient's max magnitude
SCAN_BWD_TOL = 1e-4
# one SS2D, gradients of the input and of every parameter, kernel path vs
# autograd through the plain scan, fp32: max abs error / that gradient's max.
# Parameter gradients are sums over 2 x 57344 positions taken in another order.
SS2D_GRAD_TOL = 1e-3
# fused cross-scan kernels vs their plain versions, fp32: y and d_streams to
# 1e-4 of their max; the weight gradients, sums over up to 688,128 positions
# in another order, to 1e-3 of each one's max
CROSS_TOL = 1e-4
CROSS_WEIGHT_GRAD_TOL = 1e-3
STEP_BATCH = 4           # batch of the one-step comparison (fp64 must fit too)
STEP_SEED = 1            # its weights, and the full-depth check's batch
# one training step of M2NetP with random weights: the loss and every
# parameter's gradient from each fp32 path (kernel, plain) against the plain
# path in fp64. Keys: |loss - fp64 loss| / |fp64 loss|; the norm of the whole
# gradient's error over the norm of the fp64 gradient; the median over the
# parameters of max abs error / max magnitude.
# At full depth, as with the logits above, fp32 rounding grows through the
# net's depth whichever scan runs, and more so backwards: on an H100 the loss
# reads 6e-7 to 7e-5 off in both fp32 paths, the gradient's error 0.14-0.40
# of its norm on the kernel path and 0.19-1.17 on the fp32 plain path over
# four runs (the weights after 4 steps differ from run to run), the median
# parameter 0.15-0.37 and 0.18-0.45. The limits sit about 2x outside the
# most that the fp32 plain path read. In that regime either fp32 path may
# land nearer to fp64: the kernel path's error norm read 0.35x to 1.39x the
# plain path's over four runs, and is held to 3x. Those readings were of the
# trained weights; the check now runs on weights and a batch drawn from
# STEP_SEED, where an H100 reads 3.2e-6, 0.114 and 0.099 on the kernel path
# and 6.2e-6, 0.167 and 0.141 on the fp32 plain path (0.68x), run after run.
STEP_LIMITS = {"loss_rel_err": 2e-4, "grad_rel_err_norm": 2.5,
               "median_param_rel_err": 1.0, "kernel_over_plain": 3.0}
# at stage layers (1, 1, 1, 1), same widths, fp32 is well conditioned
# (an H100 reads 2e-7, 3.7e-3 and 3.4e-3 on the kernel path, 3e-8, 2.8e-3 and
# 3.2e-3 on the fp32 plain path). Both paths stay within 2.9e-4..4.8e-3 of
# the gradient's norm on every batch, but the plain path's own error moves
# 15x between batches, so the ratio of the two read 9.11, 5.12, 1.05, 0.98,
# 1.06 and 0.89 on the batches of sampler seeds 1-6: each batch is held to
# the absolute limits, and the median of the kernel-over-plain ratios over
# SHALLOW_SEEDS to kernel_over_plain.
SHALLOW_STEP_LIMITS = {"loss_rel_err": 2e-6, "grad_rel_err_norm": 1e-2,
                       "median_param_rel_err": 1e-2, "kernel_over_plain": 2.0}
SHALLOW_SEEDS = (1, 2, 3, 4, 5, 6)
STEP_LIVE_GRAD = 1e-6    # a parameter counts if its fp64 gradient reaches this
                         # share of the largest gradient entry
# the SS2D parameters whose gradients come out of the scan kernels' backward
# (dA, dD, and through d_delta and dB/dC the dt and x projections): each
# reading says what share of a path's squared gradient error sits in them
SCAN_PARAMS = ("A_logs", "Ds", "dt_projs_weight", "dt_projs_bias", "x_proj_weight")
# and a Mamba scan branch's (MambaBlock, K=1)
MAMBA_SCAN_PARAMS = ("A_log", "D", "dt_proj_weight", "dt_proj_bias", "x_proj.weight")


LOG = ROOT / "chiprun_out" / "chip_smoke.jsonl"


def out(line):
    """Print a line, and keep it in LOG: the per-shape lines are more than
    the end of the output that a remote run shows."""
    print(line, flush=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


def emit(phase, **fields):
    out(json.dumps({"phase": phase, **fields}))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """Per kernel of one source's compiler output: registers, static shared
    memory and spill bytes, as ``ptxas -v`` states them."""
    import re
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            found = re.search(r"\d+([a-z_]+kernel)", m.group(1))
            name = found.group(1) if found else m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(dict(kernel=name, registers=int(m.group(1)),
                            smem_bytes=int(smem.group(1)) if smem else 0,
                            spill_store_bytes=spills[0],
                            spill_load_bytes=spills[1]))
            name = None
    return out


def time_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_once(fn):
    """(``fn()``, the ms of that one call on CUDA events, without a warm-up)."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


def scan_bound(batch, L, kd, n, k):
    """Least time for one forward scan: each input read once, y written once
    (u, delta, y of (B, L, KD) and bc of (B, L, K*2N), fp32), against ~7
    fp32 operations per state (exp, 2 mul + 1 fma for the state, 1 fma for y)."""
    nbytes = 4 * (3 * batch * L * kd + batch * L * k * 2 * n)
    ops = 7 * batch * L * kd * n
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scan_bwd_bound(batch, L, kd, n, k):
    """Least time for one backward scan: u, delta, dy and bc read once, du,
    ddelta and dbc written once (A and dA are (N, KD)), against ~14 fp32
    operations per state (the state again: exp, 2 mul, fma; the adjoint: fma,
    mul; and one multiply or fma each for g*h*dA, its sums into ddelta and
    dA, g*B, dB and dC, not counting the sums over channels)."""
    nbytes = 4 * (5 * batch * L * kd + 2 * batch * L * k * 2 * n + 2 * n * kd)
    ops = 14 * batch * L * kd * n
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scan_inputs(batch, L, kd, n, k, seed, steep=False):
    """Seeded inputs in the model's regime: delta in [0.001, 0.1] (the dt
    initialisation), A = -(1..N) (S4D real), unit-normal u, B/C and dy.
    ``steep``: delta in [0, 4] and A in [-16, 0), where a step's decay
    reaches e^-64 and a decay across many steps underflows."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(batch, L, kd, device="cuda", generator=g)
    if steep:
        delta = 4.0 * torch.rand(batch, L, kd, device="cuda", generator=g)
        A_t = -16.0 * torch.rand(n, kd, device="cuda", generator=g) - 1e-3
    else:
        delta = 0.001 + 0.099 * torch.rand(batch, L, kd, device="cuda", generator=g)
        A_t = -torch.arange(1, n + 1, device="cuda", dtype=torch.float32)[:, None]
        A_t = A_t.expand(n, kd).contiguous()
    bc = torch.randn(batch, L, k * 2 * n, device="cuda", generator=g)
    dy = torch.randn(batch, L, kd, device="cuda", generator=g)
    return (u, delta, A_t, bc), dy


# K1/K2's shapes (L, K*Dh, steep) for M2NetP: the path's lengths, L=12,
# K*Dh=1024 and steep decay (off the path: its L is none of the path's);
# and for M2Net, its (L, K*Dh) pairs other than M2NetP's K*Dh
SCAN_SHAPES = {
    "M2NetP": [(L, KD, False) for L, _ in PATH_SHAPES] + [
        (12, KD, False), (56, 1024, False), (3000, KD, True)],
    "M2Net": [(L, kd, False) for L, kd in M2NET_SCANS if kd != KD]}


def phase_scan_kernels(model="M2NetP", seed=0):
    """Forward kernel at the serving and the training batch, backward kernel
    at the training batch, at the shapes of SCAN_SHAPES[model]: error against
    the plain version, times, bound."""
    import torch
    from nnuzoo_tpu_torch.ops.selective_scan import (
        _pick_chunk, scan_core, scan_core_bwd, scan_core_bwd_plain,
        scan_core_plain)
    fwd_rows, bwd_rows = [], []
    for i, (L, kd, steep) in enumerate(SCAN_SHAPES[model], start=seed):
        for b in (TILE_BATCH, TRAIN_BATCH):
            args, dy = scan_inputs(b, L, kd, N_STATE, K_DIRS, seed=i, steep=steep)
            # serving asks for no carries, training for the backward's
            train = b == TRAIN_BATCH
            with torch.inference_mode():
                y, carries = scan_core(*args, return_carries=True)
                want, want_carries = scan_core_plain(
                    *args, chunk=_pick_chunk(b, L, kd), return_carries=True)
                torch.cuda.synchronize()
                err = (y - want).abs().max().item()
                scale = want.abs().max().item()
                carries_err = (carries - want_carries).abs().max().item()
                carries_scale = want_carries.abs().max().item()
                del want, want_carries
                ms = time_ms(lambda: scan_core(*args, return_carries=train), reps=20)
                plain_ms = time_ms(lambda: scan_core_plain(*args), reps=2, warmup=1)
            bound_ms, bound_by = scan_bound(b, L, kd, N_STATE, K_DIRS)
            row = dict(model=model, B=b, L=L, KD=kd, N=N_STATE, steep=steep,
                       carries=train, max_abs_err=err, rel_err=err / scale,
                       carries_rel_err=carries_err / max(carries_scale, 1e-30),
                       ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
            emit("scan_kernel", **row)
            if not (err <= SCAN_TOL * scale
                    and carries_err <= SCAN_TOL * carries_scale):
                raise AssertionError(f"scan kernel disagrees at B={b} L={L} "
                                     f"KD={kd}: y {err} against {scale}, carries "
                                     f"{carries_err} against {carries_scale}")
            fwd_rows.append(row)
            if not train:
                continue
            # the forward's carries, as the autograd function hands them over
            carries = carries if carries.shape[1] > 1 else None
            with torch.inference_mode():
                got = scan_core_bwd(*args, dy, carries)
                want = scan_core_bwd_plain(*args, dy)
                torch.cuda.synchronize()
                errs = {name: ((g - w).abs().max().item(), w.abs().max().item())
                        for name, g, w in zip(("du", "ddelta", "dbc", "dA"),
                                              got, want)}
                ms = time_ms(lambda: scan_core_bwd(*args, dy, carries), reps=10)
                plain_ms = time_ms(lambda: scan_core_bwd_plain(*args, dy),
                                   reps=1, warmup=1)
            del got, want
            bound_ms, bound_by = scan_bwd_bound(b, L, kd, N_STATE, K_DIRS)
            row = dict(model=model, B=b, L=L, KD=kd, N=N_STATE, steep=steep,
                       max_abs_err=max(e for e, _ in errs.values()),
                       rel_err={k: e / m for k, (e, m) in errs.items()},
                       ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
            emit("scan_bwd_kernel", **row)
            for name, (e, m) in errs.items():
                if not e <= SCAN_BWD_TOL * m:
                    raise AssertionError(
                        f"backward scan kernel disagrees at L={L} KD={kd}, "
                        f"{name}: {e} > {SCAN_BWD_TOL} * {m}")
            bwd_rows.append(row)
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def cross_ops(n, r):
    """fp32 operations of one cross-scan step of one channel, forward and
    backward: the projection (2C, x_dbl shared by the Dh channels of a
    direction), dt_proj (2R), softplus and the D term (~4) and ~7 a state;
    the backward does the forward again, ~14 a state for the adjoint and its
    sums, 2C each for the sums of d_xdbl, du's projection term and dwx, 2R
    for dwdt and ~6 more (ddelta, softplus', du, dD, dbias)."""
    c = r + 2 * n
    fwd = 2 * c + 2 * r + 4 + 7 * n
    return fwd, fwd + 14 * n + 6 * c + 2 * r + 6


def cross_bound(batch, L, g, dh, n, r, backward):
    """Least time for one cross-scan call, the largest of three: the streams
    (and dy) read once, y (or d_streams) written once, the weights read (and
    their gradients written) once; the operations of :func:`cross_ops` at
    the fp32 rate; and the exp2 that the function cannot avoid, one a
    state-step (the decay of each state), at the exp2 rate. Returns (ms,
    what bounds it: "bytes", "operations" or "exp2")."""
    c = r + 2 * n
    weights = g * c * dh + g * dh * r + g * dh + g * dh * n + g * dh
    acts = (3 if backward else 2) * batch * L * g * dh
    nbytes = 4 * (acts + (2 if backward else 1) * weights)
    ops = batch * L * g * dh * cross_ops(n, r)[1 if backward else 0]
    times = {"bytes": nbytes / PEAK_BYTES_PER_S,
             "operations": ops / PEAK_FP32_PER_S,
             "exp2": batch * L * g * dh * n / PEAK_EXP2_PER_S}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def cross_inputs(batch, L, g, dh, r, seed, n=N_STATE):
    """Seeded (streams, wx, wdt, dtb, A, Ds) of the fused cross-scan in the
    model's regime (delta around softplus(-3) = 0.05, A near -(1..N), D
    near 1), and an output gradient dy."""
    import math
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    streams = [rnd(batch, L, dh) for _ in range(g)]
    wx = rnd(g, r + 2 * n, dh) / math.sqrt(dh)
    wdt = 0.5 * rnd(g, dh, r) / math.sqrt(r)
    dtb = -3.0 + 0.5 * rnd(g, dh)
    A = -torch.arange(1, n + 1, device="cuda").float() * torch.exp(0.1 * rnd(g * dh, n))
    Ds = 1.0 + 0.1 * rnd(g * dh)
    return streams, [wx, wdt, dtb, A, Ds], rnd(batch, L, g * dh)


# K3/K4's shapes (L, G, Dh, R) for M2NetP: the path's lengths, L=12, a ragged
# L and M2Net's widest; and for M2Net, its (L, Dh, R) other than M2NetP's
CROSS_SHAPES = {
    "M2NetP": [(L, CROSS_G, CROSS_DH, CROSS_R) for L, _ in PATH_SHAPES] + [
        (12, CROSS_G, CROSS_DH, CROSS_R), (1000, CROSS_G, CROSS_DH, CROSS_R),
        (56, CROSS_G, 256, 8)],
    "M2Net": [(L, CROSS_G, dh, r) for L, dh, r in M2NET_CROSS if dh != CROSS_DH]}


def phase_cross_scan_kernels(model="M2NetP", seed=100, shapes=None):
    """K3 at the serving and the training batch, K4 at the training batch,
    both orientations, at the shapes of CROSS_SHAPES[model] (TILE_BATCH and
    TRAIN_BATCH), or of ``shapes``, rows (L, G, Dh, R, serving batch,
    training batch): errors against the plain versions, times, bounds. Where
    the two batches are one, the row is timed with the carries and without
    them. At L > 100,000 the plain versions walk chunks of 2048 steps (a
    row names its chunk) and are timed once."""
    import torch
    from nnuzoo_tpu_torch.ops.cross_scan import (
        cross_scan_bwd, cross_scan_bwd_plain, cross_scan_fwd, cross_scan_ref)
    names = ("d_streams", "dWx", "dWdt", "dbias", "dA", "dD")
    fwd_rows, bwd_rows = [], []
    if shapes is None:
        shapes = [key + (TILE_BATCH, TRAIN_BATCH) for key in CROSS_SHAPES[model]]
    for i, (L, g, dh, r, serve_b, train_b) in enumerate(shapes, start=seed):
        long = L > 100_000
        with plain_chunk(2048 if long else 256):
            for b in sorted({serve_b, train_b}):
                streams, w, dy = cross_inputs(b, L, g, dh, r, seed=i)
                for reverse in (False, True):
                    with torch.inference_mode():
                        y, carries = cross_scan_fwd(streams, *w, reverse,
                                                    return_carries=True)
                        want = cross_scan_ref(streams, *w, reverse)
                        torch.cuda.synchronize()
                        err = (y - want).abs().max().item()
                        scale = want.abs().max().item()
                        # serving asks for no carries, training for K4's
                        train = b == train_b
                        ms = time_ms(lambda: cross_scan_fwd(
                            streams, *w, reverse, return_carries=train), reps=20)
                        ms_without = ms if not train else time_ms(
                            lambda: cross_scan_fwd(streams, *w, reverse), reps=20) \
                            if b == serve_b else None
                        plain_ms = time_ms(lambda: cross_scan_ref(streams, *w, reverse),
                                           reps=1 if long else 2, warmup=0 if long else 1)
                    del y, want
                    bound_ms, bound_by = cross_bound(b, L, g, dh, N_STATE, r, False)
                    row = dict(model=model, B=b, L=L, G=g, Dh=dh, R=r,
                               reverse=reverse, carries=train,
                               plain_chunk=2048 if long else 256, max_abs_err=err,
                               rel_err=err / scale, ms=ms, ms_without_carries=ms_without,
                               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
                    emit("cross_scan_kernel", **row)
                    if not err <= CROSS_TOL * scale:
                        raise AssertionError(f"K3 disagrees at {row}")
                    fwd_rows.append(row)
                    if not train:
                        continue
                    with torch.inference_mode():
                        got = cross_scan_bwd(streams, *w, dy, reverse, carries)
                        want, plain_once = time_once(
                            lambda: cross_scan_bwd_plain(streams, *w, dy, reverse))
                        torch.cuda.synchronize()
                        flat = lambda t: [torch.cat(t[0], -1), *t[1:]]
                        errs = {k: ((a - e).abs().max().item(), e.abs().max().item())
                                for k, a, e in zip(names, flat(got), flat(want))}
                        ms = time_ms(lambda: cross_scan_bwd(streams, *w, dy, reverse,
                                                            carries), reps=10)
                        plain_ms = plain_once if long else time_ms(
                            lambda: cross_scan_bwd_plain(streams, *w, dy, reverse),
                            reps=1, warmup=1)
                    del got, want
                    bound_ms, bound_by = cross_bound(b, L, g, dh, N_STATE, r, True)
                    row = dict(model=model, B=b, L=L, G=g, Dh=dh, R=r,
                               reverse=reverse, plain_chunk=2048 if long else 256,
                               max_abs_err=max(e for e, _ in errs.values()),
                               rel_err={k: e / m for k, (e, m) in errs.items()},
                               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
                    emit("cross_scan_bwd_kernel", **row)
                    for k, (e, m) in errs.items():
                        tol = CROSS_TOL if k == "d_streams" else CROSS_WEIGHT_GRAD_TOL
                        if not e <= tol * m:
                            raise AssertionError(f"K4 disagrees at L={L} Dh={dh} "
                                                 f"reverse={reverse}, {k}: {e} > "
                                                 f"{tol} * {m}")
                    bwd_rows.append(row)
                del streams, w, dy, carries
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def compare(a, b):
    d = (a - b).abs()
    rng = (b.max() - b.min()).item()
    return dict(max_abs=d.max().item(), mean_abs=d.mean().item(),
                max_ref=b.abs().max().item(), range_ref=rng)


def phase_blocks():
    import torch
    from nnuzoo_tpu_torch.models.layers import init_parameters
    from nnuzoo_tpu_torch.models.ss2d import SS2D, set_scan_backend
    from nnuzoo_tpu_torch.models.vssm import MU
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, module, ch in (("SS2D", SS2D(16), 16), ("MU", MU(1, 16, 64, 7), 1)):
        init_parameters(module, torch.Generator().manual_seed(2))
        module = module.cuda().eval()
        x = torch.randn(TILE_BATCH, *PATCH, ch, device="cuda", generator=g)
        with torch.inference_mode():
            got = module(x)
            set_scan_backend(module, "plain")
            want = module(x)
        c = compare(got, want)
        emit("block", block=name, shape=list(x.shape), **c)
        ok = (c["max_abs"] <= SS2D_TOL * c["max_ref"] if name == "SS2D"
              else c["max_abs"] <= MU_TOL * c["range_ref"])
        if not ok:
            raise AssertionError(f"{name}: kernel path vs plain path {c}")
        if name != "SS2D":
            continue
        # forward and backward: the gradients of the input and of every
        # parameter, both scan kernels against autograd through the plain scan
        # (which keeps every level of the plain scan: batch 2 of the 4)
        x = x[:2].clone().requires_grad_()
        dout = torch.randn(2, *PATCH, ch, device="cuda", generator=g)
        names = ["input"] + [n for n, _ in module.named_parameters()]
        leaves = [x] + list(module.parameters())
        grads = {}
        for backend in (None, "plain"):
            set_scan_backend(module, backend)
            grads[backend] = torch.autograd.grad(module(x), leaves, dout)
            torch.cuda.synchronize()
        rel = {n: ((a - b).abs().max() / b.abs().max()).item()
               for n, a, b in zip(names, grads[None], grads["plain"])}
        emit("block_grads", block=name, shape=list(x.shape), rel_err=rel)
        bad = {n: e for n, e in rel.items() if not e <= SS2D_GRAD_TOL}
        if bad:
            raise AssertionError(f"SS2D gradients, kernel path vs plain path: {bad}")
        del grads
        torch.cuda.empty_cache()


def phase_fused_ss2d():
    """One SS2D at stage-1 width and 2x256x224: the fused glue (K3, K4)
    against the default glue (K1, K2), output and the gradients of the input
    and of every parameter."""
    import torch
    from nnuzoo_tpu_torch.models.layers import init_parameters
    from nnuzoo_tpu_torch.models.ss2d import SS2D, set_ss2d_glue
    g = torch.Generator(device="cuda").manual_seed(3)
    module = SS2D(16)
    init_parameters(module, torch.Generator().manual_seed(4))
    module = module.cuda()
    x = torch.randn(2, *PATCH, 16, device="cuda", generator=g).requires_grad_()
    dout = torch.randn(2, *PATCH, 16, device="cuda", generator=g)
    names = ["input"] + [n for n, _ in module.named_parameters()]
    leaves = [x] + list(module.parameters())
    runs = {}
    for glue in ("default", "fused"):
        set_ss2d_glue(module, glue)
        out = module(x)
        runs[glue] = (out.detach(), torch.autograd.grad(out, leaves, dout))
        torch.cuda.synchronize()
    c = compare(runs["fused"][0], runs["default"][0])
    rel = {n: ((a - b).abs().max() / b.abs().max()).item()
           for n, a, b in zip(names, runs["fused"][1], runs["default"][1])}
    emit("fused_ss2d", shape=list(x.shape), **c, grad_rel_err=rel)
    bad = {n: e for n, e in rel.items() if not e <= SS2D_GRAD_TOL}
    if not c["max_abs"] <= SS2D_TOL * c["max_ref"] or bad:
        raise AssertionError(f"fused SS2D vs default SS2D: {c}, gradients {bad}")
    del runs
    torch.cuda.empty_cache()


@contextlib.contextmanager
def first_validation_case(trainer):
    """The trainer's final validation over its fold's first case only (the
    smoke run's cut: each case takes the same path)."""
    split = trainer.do_split
    trainer.do_split = lambda: (lambda tr, val: (tr, val[:1]))(*split())
    try:
        yield
    finally:
        del trainer.do_split


@contextlib.contextmanager
def ss2d_glue(glue):
    """``NNUZOO_SS2D_FUSED`` as a user sets it, for the models built inside."""
    before = os.environ.get("NNUZOO_SS2D_FUSED")
    os.environ["NNUZOO_SS2D_FUSED"] = "1" if glue == "fused" else "0"
    try:
        yield
    finally:
        if before is None:
            del os.environ["NNUZOO_SS2D_FUSED"]
        else:
            os.environ["NNUZOO_SS2D_FUSED"] = before


# M2NetP's stage layers where a phase runs it shallow (``shallow_m2netp``);
# None: full depth
M2NETP_LAYERS = None


@contextlib.contextmanager
def shallow_m2netp(layers=(1, 1, 1, 1)):
    """``nnUNetTrainerM2NetP`` built at stage layers ``layers`` by the
    registry inside (the trainer, the Predictor, the command line), for the
    paths that repeat one that runs at full depth elsewhere."""
    import functools
    from nnuzoo_tpu_torch.models import m2net, registry
    global M2NETP_LAYERS
    name = "nnUNetTrainerM2NetP"
    before = registry.get_model_builder(name)
    registry.MODEL_BUILDERS[name] = functools.partial(
        m2net.get_m2net_from_plans, small=True, stage_layers=layers)
    M2NETP_LAYERS = tuple(layers)
    try:
        yield
    finally:
        registry.MODEL_BUILDERS[name] = before
        M2NETP_LAYERS = None


def shallow_m2netp_scans():
    """Scan calls of one forward of M2NetP at M2NETP_LAYERS: one an SS2D
    (the fused glue makes two), counted on the meta device."""
    import torch
    from nnuzoo_tpu_torch.models.m2net import M2NetP
    from nnuzoo_tpu_torch.models.ss2d import SS2D
    with torch.device("meta"):
        model = M2NetP(1, 3, stage_layers=M2NETP_LAYERS)
    return sum(isinstance(m, SS2D) for m in model.modules())


def glue_kernels(glue, trainer_name="nnUNetTrainerM2NetP"):
    """(forward kernel wrapper, backward kernel wrapper, launches of each per
    forward of ``trainer_name``'s model at 256x224, the other glue's
    wrappers) of an SS2D glue."""
    from nnuzoo_tpu_torch.ops.cross_scan import cross_scan_bwd, cross_scan_fwd
    from nnuzoo_tpu_torch.ops.selective_scan import scan_core, scan_core_bwd
    shallow = trainer_name == "nnUNetTrainerM2NetP" and M2NETP_LAYERS is not None
    if glue == "fused":
        if trainer_name in SSND2NET_FAMILY:
            per_forward = ssnd2net_calls(trainer_name, 2, glue)
        else:
            per_forward = 2 * shallow_m2netp_scans() if shallow \
                else FUSED_PER_FORWARD
        return cross_scan_fwd, cross_scan_bwd, per_forward, (scan_core,
                                                             scan_core_bwd)
    if shallow:
        per_forward = shallow_m2netp_scans()
    elif trainer_name in MAMBA_SCANS_2D:
        per_forward = sum(MAMBA_SCANS_2D[trainer_name].values())
    elif trainer_name in LM2NET_FAMILY:
        per_forward = sum(lm2net_scans(trainer_name).values())
    elif trainer_name in SSND2NET_FAMILY:
        per_forward = ssnd2net_calls(trainer_name, 2)
    else:
        per_forward = SCANS_PER_FORWARD
    return scan_core, scan_core_bwd, per_forward, (cross_scan_fwd, cross_scan_bwd)


def plans_and_dataset(target_type="segmentation"):
    """The 2d plans at PATCH and TRAIN_BATCH and the dataset.json: three
    labels, or for the translation target one regression channel (the
    labels less one)."""
    rs = {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None}
    plans = {
        "dataset_name": "Dataset999_BenchAbdomenMR", "plans_name": "nnUNetPlans",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "image_reader_writer": "NiftiIO",
        "foreground_intensity_properties_per_channel": {},
        "configurations": {"2d": {
            "data_identifier": "nnUNetPlans_2d", "batch_size": 12,
            "batch_dice": True,
            "patch_size": list(PATCH), "spacing": [1.0, 1.0],
            "normalization_schemes": ["ZScoreNormalization"],
            "use_mask_for_norm": [False],
            "resampling_fn_data": "resample_data_or_seg_to_shape",
            "resampling_fn_data_kwargs": rs,
            "resampling_fn_seg": "resample_data_or_seg_to_shape",
            "resampling_fn_seg_kwargs": dict(rs, is_seg=True, order=1),
            "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
            "resampling_fn_probabilities_kwargs": dict(rs, order=1)}},
    }
    dataset_json = {"channel_names": {"0": "MRI"},
                    "labels": {"background": 0, "organ": 1, "tumor": 2},
                    "file_ending": ".nii.gz"}
    if target_type == "translation":
        plans["dataset_name"] = "Dataset998_BenchTranslation"
        dataset_json = dict(dataset_json, target_type="translation",
                            labels={"background": 0, "target": 1})
    return plans, dataset_json


def phase_end_to_end(profile, glue="default", trainer_name="nnUNetTrainerM2NetP",
                     result=None, tile_check=True):
    """Serving with one SS2D glue and the model of ``trainer_name``. Returns
    the forward kernel's launches of the timed prediction; ``result``, a
    dict, also gets its seconds, forwards, peak memory and segmentation.
    ``tile_check``: True holds one tile batch's logits to phase 4's limits
    against fp64 and the kernel path's mean error to KERNEL_MEAN_RATIO of
    the fp32 plain path's; "ratio" the latter only (a model whose random
    weights amplify fp32 rounding past the absolute limits whichever path
    runs); None leaves the tile batch out."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.inference.predictor import Predictor
    from nnuzoo_tpu_torch.inference.sliding_window import pad_nd_image
    from nnuzoo_tpu_torch.models.registry import get_model_builder
    from nnuzoo_tpu_torch.plans.plans_handler import PlansManager
    from nnuzoo_tpu_torch.preprocessing.preprocessor import DefaultPreprocessor

    kernel, _, per_forward, others = glue_kernels(glue, trainer_name)
    plans, dataset_json = plans_and_dataset()
    pm = PlansManager(plans)
    cfg = pm.get_configuration("2d")
    t0 = time.perf_counter()
    with ss2d_glue(glue):
        model = get_model_builder(trainer_name)(
            pm, dataset_json, cfg, 1, deep_supervision=False, device="cuda",
            seed=0)
    predictor = Predictor(tile_step_size=0.5, use_gaussian=True,
                          use_mirroring=True, tile_batch_size=TILE_BATCH,
                          device="cuda")
    predictor.manual_initialization(model, [model.state_dict()], pm, cfg,
                                    dataset_json, trainer_name, (0, 1))
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    volume = (100 * rng.rand(1, 4, 224, 256)).astype(np.float32)
    props = {"spacing": [3.0, 1.0, 1.0]}
    # the first 4 tiles of the preprocessed volume: the warm-up (one tile
    # batch with the mirrors, as the prediction runs it) and the tile check
    data, _ = DefaultPreprocessor().run_case_npy(
        volume, None, dict(props), pm, cfg, dataset_json)
    padded, _ = pad_nd_image(data, PATCH)
    tiles = torch.from_numpy(np.ascontiguousarray(
        padded[:, :TILE_BATCH, :PATCH[0], :PATCH[1]].transpose(1, 2, 3, 0))).cuda()

    predictor.tile_forward(tiles)                                 # warm-up
    torch.cuda.synchronize()
    for k in (kernel, *others):
        k.launches = 0
    predictor.forward_count = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seg = predictor.predict_single_npy_array(volume, dict(props))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, forwards = kernel.launches, predictor.forward_count
    other_launches = sum(k.launches for k in others)
    if result is not None:
        result.update(seconds=seconds, forwards=forwards, segmentation=seg,
                      peak_memory_bytes=torch.cuda.max_memory_allocated())

    labels = sorted(int(v) for v in np.unique(seg))
    emit("end_to_end", glue=glue, trainer=trainer_name,
         model=type(model).__name__, model_build_s=build_s,
         seconds_per_volume=seconds, volume=list(volume.shape),
         segmentation_shape=list(seg.shape), labels=labels, forwards=forwards,
         scan_launches=launches, other_glue_launches=other_launches,
         launches_per_forward=launches / max(forwards, 1))
    if seg.shape != volume.shape[1:] or not set(labels) <= {0, 1, 2}:
        raise AssertionError(f"segmentation {seg.shape} labels {labels}")
    if forwards == 0 or launches != per_forward * forwards or other_launches:
        raise AssertionError(f"{launches} scan launches ({other_launches} of the "
                             f"other glue's kernels) for {forwards} forwards, "
                             f"expected {per_forward} per forward")

    if tile_check is None:
        return launches
    # with the mirrors for M2NetP at full depth, whose readings sit within
    # 2x of the limits, else one pass
    mirrored = trainer_name == "nnUNetTrainerM2NetP" and M2NETP_LAYERS is None
    readings = tile_readings(model, tiles, pm, cfg, dataset_json, trainer_name,
                             (0, 1), TILE_BATCH, mirrored, bool(per_forward))
    emit("tile_logits", glue=glue, model=type(model).__name__,
         trainer=trainer_name, limits=tile_check, mirrored=mirrored,
         stage_layers=M2NETP_LAYERS if trainer_name == "nnUNetTrainerM2NetP"
         else None, **readings)
    if result is not None:
        result["tile_logits"] = readings
    check_tile_readings(readings, tile_check)
    if profile and trainer_name == "nnUNetTrainerM2NetP":
        profile_tile_batch(predictor, tiles, glue)
    return launches


def tile_readings(model, tiles, pm, cfg, dataset_json, trainer_name, axes,
                  tile_batch, mirrored, has_scans):
    """One tile batch on the card through the kernel path, the plain path in
    fp32 (where the path has scans: else it is the same computation) and,
    as the reference both are held to, the plain path in fp64: each fp32
    path against fp64 (max, mean, range, argmax agreement) and the two fp32
    paths against each other."""
    from nnuzoo_tpu_torch.inference.predictor import Predictor
    from nnuzoo_tpu_torch.models.ss2d import set_scan_backend

    def predictor(net):
        p = Predictor(use_mirroring=mirrored, tile_batch_size=tile_batch,
                      device="cuda")
        p.manual_initialization(net, [net.state_dict()], pm, cfg, dataset_json,
                                trainer_name, axes)
        return p

    check = predictor(model)
    got = check.tile_forward(tiles)
    plain = got
    if has_scans:
        set_scan_backend(model, "plain")
        plain = check.tile_forward(tiles)
        set_scan_backend(model, None)
    model64 = copy.deepcopy(model).double()
    set_scan_backend(model64, "plain")
    want = predictor(model64).tile_forward(tiles.double())
    del model64
    readings = {}
    for name, out in (("kernel_vs_fp64", got), ("plain_fp32_vs_fp64", plain)):
        c = compare(out, want)
        c["argmax_agreement"] = (out.argmax(-1) == want.argmax(-1)).float().mean().item()
        readings[name] = c
    readings["kernel_vs_plain_fp32"] = compare(got, plain)
    return readings


def check_tile_readings(readings, tile_check):
    """Phase 4's limits (``tile_check`` True: each fp32 path against fp64
    within TILE_MAX_TOL and TILE_MEAN_TOL of the range and AGREE_MIN in
    argmax; "ratio": only the rule below) and the kernel path's mean error
    within KERNEL_MEAN_RATIO of the fp32 plain path's."""
    for name in ("kernel_vs_fp64", "plain_fp32_vs_fp64") \
            if tile_check is True else ():
        c = readings[name]
        if not (c["max_abs"] <= TILE_MAX_TOL * c["range_ref"]
                and c["mean_abs"] <= TILE_MEAN_TOL * c["range_ref"]
                and c["argmax_agreement"] >= AGREE_MIN):
            raise AssertionError(f"tile logits, {name}: {c}")
    if not (readings["kernel_vs_fp64"]["mean_abs"]
            <= KERNEL_MEAN_RATIO * readings["plain_fp32_vs_fp64"]["mean_abs"]):
        raise AssertionError(f"tile logits: the kernel path is further from "
                             f"fp64 than the fp32 plain path: {readings}")


def kernel_ms(kernels, *names, exclude=()):
    """Device ms of the profiled kernels whose names hold one of ``names``
    and none of ``exclude``."""
    return sum(e.self_device_time_total for e in kernels
               if any(n in e.key for n in names)
               and not any(x in e.key for x in exclude)) / 1e3


# kernel-name fragments of the scan kernels in a profile, and the fragments
# that exclude a name: K1 (one kernel), K2 (passes A, B, C), K3 (one
# kernel), K4 (passes A and C) and K4's carry pass
SCAN_KERNEL_NAMES = {
    "k1": (("scan_lookback_kernel",), ()),
    "k2": (("forward_chunk_kernel", "adjoint_carry_kernel", "grad_tile_kernel"),
           ()),
    "k3": (("cross_fwd_tile_kernel",), ()),
    "k4": (("cross_walk_kernel<", "cross_grad_kernel<"), ()),
    "k4_carry": (("cross_scan::carry_kernel",), ()),
}


def profile_suffix(glue):
    return "" if glue == "default" else "_" + glue


def profile_tile_batch(predictor, tiles, glue="default"):
    """Device time by kernel for one tile batch (4 mirrored forwards), and
    the share of the unprofiled wall time the device is busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        predictor.tile_forward(tiles)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        predictor.tile_forward(tiles)
        torch.cuda.synchronize()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    events = prof.key_averages()
    table = f"chiprun_out/profile_tile_batch{profile_suffix(glue)}.txt"
    (ROOT / table).write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=40))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    names, exclude = SCAN_KERNEL_NAMES["k3" if glue == "fused" else "k1"]
    scan = kernel_ms(kernels, *names, exclude=exclude)
    emit("profile", glue=glue, tile_batch_wall_ms=wall_ms, device_ms=total,
         scan_kernel_ms=scan, scan_share=scan / total if total else None,
         device_busy_share=total / wall_ms, launches=sum(e.count for e in kernels),
         table=table)


def blob_labels(rs, shape, block):
    """Smooth seeded label blobs 0..2 of ``shape`` (z, y, x), constant over
    ``block`` x ``block`` squares."""
    import numpy as np
    coarse = rs.rand(shape[0], shape[1] // block, shape[2] // block)
    field = np.kron(coarse, np.ones((1, block, block)))
    return np.digitize(field, [0.6, 0.85]).astype(np.int16)


def write_dataset(folder, cases=3, shape=(8, 280, 320), seed=0,
                  spacing=(3.0, 1.0, 1.0), block=40, target_type="segmentation"):
    """A seeded preprocessed dataset in the format ``DatasetNumpy`` reads:
    per case ``.npz`` {data (1, z, y, x) float32, seg (1, z, y, x) int16 with
    labels 0..2} and ``.pkl`` properties with ``class_locations`` and the
    geometry that export needs (nothing cropped, nothing resampled), and the
    segmentation in ``../gt_segmentations`` as the final validation reads it.
    The labels are smooth blobs (constant over ``block`` x ``block`` squares,
    which must tile y and x) that the intensities follow, so there is
    something to learn. For the translation target, seg is a float32 image
    to regress, 2 * data + 10 plus a little noise (no ``class_locations``),
    written to ``gt_segmentations`` as float32."""
    import numpy as np
    from nnuzoo_tpu_torch.imageio.nifti import NiftiIO, write_nifti
    gt = os.path.join(os.path.dirname(folder), "gt_segmentations")
    os.makedirs(folder)
    os.makedirs(gt)
    rs = np.random.RandomState(seed)
    for i in range(cases):
        seg = blob_labels(rs, shape, block)[None]
        data = (seg + 0.5 * rs.randn(1, *shape)).astype(np.float32)
        locations = {}
        if target_type == "translation":
            seg = (2 * data + 10 + 0.1 * rs.randn(1, *shape)).astype(np.float32)
        else:
            for label in (1, 2):
                where = np.argwhere(seg == label)
                locations[label] = where[rs.choice(len(where),
                                                   min(len(where), 10000),
                                                   replace=False)]
        np.savez_compressed(os.path.join(folder, f"case_{i:03d}.npz"),
                            data=data, seg=seg)
        props = {"class_locations": locations, "spacing": list(spacing),
                 "shape_before_cropping": shape,
                 "bbox_used_for_cropping": [[0, s] for s in shape],
                 "shape_after_cropping_and_before_resampling": shape}
        with open(os.path.join(folder, f"case_{i:03d}.pkl"), "wb") as f:
            pickle.dump(props, f)
        gt_file = os.path.join(gt, f"case_{i:03d}.nii.gz")
        if target_type == "translation":
            write_nifti(gt_file, seg[0].transpose(2, 1, 0), spacing_xyz=spacing[::-1])
        else:
            NiftiIO().write_seg(seg[0], gt_file, props)


def write_test_folder(root, cases=2, shape=(4, 224, 256), seed=5):
    """A seeded raw test folder as a user hands it to prediction:
    ``imagesTs/{case}_0000.nii.gz`` (one channel, (z, y, x) = ``shape``, the
    intensities following the labels) and ``labelsTs/{case}.nii.gz``, written
    through the port's NIfTI writer. Returns the two folders."""
    import numpy as np
    from nnuzoo_tpu_torch.imageio.nifti import NiftiIO, write_nifti
    images, labels = os.path.join(root, "imagesTs"), os.path.join(root, "labelsTs")
    os.makedirs(images)
    os.makedirs(labels)
    rs = np.random.RandomState(seed)
    for i in range(cases):
        seg = blob_labels(rs, shape, 32)
        vol = (100 + 40 * seg + 20 * rs.randn(*shape)).astype(np.float32)
        write_nifti(os.path.join(images, f"test_{i:03d}_0000.nii.gz"),
                    vol.transpose(2, 1, 0), spacing_xyz=(1.0, 1.0, 3.0))
        NiftiIO().write_seg(seg, os.path.join(labels, f"test_{i:03d}.nii.gz"),
                            {"spacing": [3.0, 1.0, 1.0]})
    return images, labels


def ds_scales_list(trainer):
    """The trainer's deep-supervision scales as lists (None without)."""
    scales = trainer.train_aug_cfg.deep_supervision_scales
    return None if scales is None else [list(s) for s in scales]


def phase_training(profile, glue="default", trainer_name="nnUNetTrainerM2NetP",
                   target_type="segmentation"):
    """``Trainer.run_training()`` of ``trainer_name`` for one epoch of
    TRAIN_STEPS steps and one validation step, with one SS2D glue, on the
    seeded dataset of the target type (written unless it is there). Returns
    the trainer, the scan launches (forward, backward) of the run and the
    weights it ended with."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.training.trainer import Trainer

    fwd_kernel, bwd_kernel, per_forward, others = glue_kernels(glue, trainer_name)
    plans, dataset_json = plans_and_dataset(target_type)
    folder = os.path.join(os.environ["nnUNet_preprocessed"], plans["dataset_name"],
                          "nnUNetPlans_2d")
    if not os.path.isdir(folder):
        write_dataset(folder, target_type=target_type)
    trainer = Trainer(plans, "2d", "all", dataset_json, num_epochs=1,
                      trainer_name=trainer_name, device="cuda", seed=0)
    trainer.config = replace(trainer.config, num_iterations_per_epoch=TRAIN_STEPS,
                             num_val_iterations_per_epoch=1)
    with ss2d_glue(glue):
        trainer.initialize()    # builds the model and probes its output scales

    # observe the steps that run_training takes: time, loss and launches of each
    steps, batches = [], []
    inner = trainer.train_step

    def observed_step(data, seg):
        batches.append((data, seg))
        torch.cuda.synchronize()
        before = fwd_kernel.launches, bwd_kernel.launches
        t0 = time.perf_counter()
        loss = inner(data, seg)
        torch.cuda.synchronize()
        steps.append(dict(seconds=time.perf_counter() - t0, loss=loss.item(),
                          fwd_launches=fwd_kernel.launches - before[0],
                          bwd_launches=bwd_kernel.launches - before[1]))
        return loss

    trainer.train_step = observed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in (fwd_kernel, bwd_kernel, *others):
        k.launches = 0
    t0 = time.perf_counter()
    trainer.run_training()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fwd_kernel.launches, bwd_kernel.launches
    other_launches = sum(k.launches for k in others)
    trainer.train_step = inner
    peak = torch.cuda.max_memory_allocated()
    trained = {k: v.detach().cpu().clone()
               for k, v in trainer.model.state_dict().items()}

    losses = [s["loss"] for s in steps]
    log = trainer.logger.my_fantastic_logging
    counts = {}
    step_s = float(np.mean([s["seconds"] for s in steps[1:]]))
    if trainer_name in LM2NET_FAMILY + SSND2NET_FAMILY:
        c = family_counts(trainer.model, trainer_name)
        counts = dict(parameters=c["parameters"],
                      step_tflop=TRAIN_BATCH * c["step_flop"] / 1e12,
                      tflop_per_s=TRAIN_BATCH * c["step_flop"] / step_s / 1e12,
                      saved_activation_bytes=TRAIN_BATCH * c["saved_bytes"])
    elif trainer_name in MAMBA_SCANS_2D:
        flop, saved = model_counts(trainer.model, (TRAIN_BATCH, *PATCH, 1), True)
        counts = dict(parameters=sum(p.numel() for p in trainer.model.parameters()),
                      step_tflop=flop / 1e12, tflop_per_s=flop / step_s / 1e12,
                      saved_activation_bytes=saved)
    emit("training", glue=glue, trainer=trainer_name, target_type=target_type,
         **counts,
         model=type(trainer.model).__name__, steps=steps, losses=losses,
         loss_fell=losses[-1] < losses[0],
         seconds_per_step_after_first=float(np.mean([s["seconds"]
                                                     for s in steps[1:]])),
         run_training_seconds=seconds, val_loss=log["val_losses"][0],
         pseudo_dice=log["dice_per_class_or_region"][0],
         fwd_launches=launches[0], bwd_launches=launches[1],
         other_glue_launches=other_launches, peak_memory_bytes=peak, batch=list(batches[0][0].shape),
         remat=getattr(trainer.model, "remat", False),
         ds_scales=ds_scales_list(trainer))
    if len(steps) != TRAIN_STEPS or not all(np.isfinite(losses)) or \
            not np.isfinite(log["val_losses"][0]):
        raise AssertionError(f"training losses {losses}, val {log['val_losses']}")
    if tuple(batches[0][0].shape[:2]) != (TRAIN_BATCH, 1):
        raise AssertionError(f"batch shape {batches[0][0].shape}")
    # a step runs one forward and one backward of the model's scans (a
    # rematted stage keeps its scans' outputs)
    for s in steps:
        if s["bwd_launches"] != per_forward or s["fwd_launches"] != per_forward:
            raise AssertionError(f"scan launches of a step: {s}")
    # the validation step is one more forward
    if launches[1] != TRAIN_STEPS * per_forward or \
            launches[0] != (TRAIN_STEPS + 1) * per_forward or other_launches:
        raise AssertionError(f"scan launches of the run: {launches}, "
                             f"{other_launches} of the other glue's kernels")
    for name in ("checkpoint_final.pth", "checkpoint_best.pth"):
        if not os.path.isfile(os.path.join(trainer.output_folder, name)):
            raise AssertionError(f"{name} was not written")
    if profile and trainer_name == "nnUNetTrainerM2NetP":
        profile_train_step(trainer, *batches[-1], glue=glue)
    return trainer, launches, trained


def profile_train_step(trainer, data, seg, glue="default"):
    """Device time by kernel for one training step, the share of the
    unprofiled step time the device is busy, the device time under
    ``aten::bmm``, and the step with ``remat``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        trainer.train_step(data, seg)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        trainer.train_step(data, seg)
        torch.cuda.synchronize()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    events = prof.key_averages()
    table = f"chiprun_out/profile_train_step{profile_suffix(glue)}.txt"
    (ROOT / table).write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=40))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    by_kernel = {n: kernel_ms(kernels, *names, exclude=exclude)
                 for n, (names, exclude) in SCAN_KERNEL_NAMES.items()}
    fwd, bwd = ((by_kernel["k3"], by_kernel["k4"]) if glue == "fused"
                else (by_kernel["k1"], by_kernel["k2"]))
    # the same step with M2NetP's remat off and on: time, peak memory, launches
    fwd_kernel, bwd_kernel, _, _ = glue_kernels(glue)
    remat_readings = {}
    for remat in (False, True):
        trainer.model.remat = remat
        trainer.train_step(data, seg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd_kernel.launches = bwd_kernel.launches = 0
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.train_step(data, seg)
        torch.cuda.synchronize()
        remat_readings["remat_on" if remat else "remat_off"] = dict(
            seconds_per_step=(time.perf_counter() - t0) / 2,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            fwd_launches_per_step=fwd_kernel.launches / 2,
            bwd_launches_per_step=bwd_kernel.launches / 2)
    trainer.model.remat = False
    emit("profile_train_step", glue=glue, step_wall_ms=wall_ms, device_ms=total,
         **remat_readings, scan_kernel_ms_by_name=by_kernel,
         scan_fwd_kernel_ms=fwd, scan_bwd_kernel_ms=bwd,
         scan_share=(fwd + bwd) / total if total else None,
         # the default glue's projection weight gradients run under bmm
         bmm_ms=sum(e.device_time_total for e in events
                    if e.key == "aten::bmm") / 1e3,
         device_busy_share=total / wall_ms, launches=sum(e.count for e in kernels),
         table=table)


def step_readings(trainer, model, data_aug, targets, same_paths=False):
    """Loss and gradients of one training step of ``model`` (DropPath off)
    through the kernel path and the fp32 plain path, each held against the
    plain path in fp64, with the three parameters that carry most of each
    path's squared gradient error and the share that sits in SCAN_PARAMS.
    ``same_paths``: the model has no scan kernel on its path, so the plain
    path is the kernel path's computation and is not run again. Returns the
    readings by path name and the fp64 loss and gradient norm."""
    import torch
    from nnuzoo_tpu_torch.models.layers import DropPath
    from nnuzoo_tpu_torch.models.ss2d import set_scan_backend

    rates = {m: m.rate for m in model.modules() if isinstance(m, DropPath)}
    for m in rates:
        m.rate = 0.0

    def loss_and_grads(net, cast):
        net.train()
        outputs = net(cast(data_aug).movedim(1, -1).contiguous())
        loss = trainer._compute_loss(outputs, targets)
        params = list(net.parameters())
        # a deep-supervision head of loss weight 0 (SwinUMamba's /8 head)
        # gets no gradient
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        return loss.item(), [torch.zeros_like(p, dtype=torch.float64) if g is None
                             else g.double() for p, g in zip(params, grads)]

    runs = {}
    try:
        for name, backend in (("kernel", None), ("plain_fp32", "plain_pair")):
            set_scan_backend(model, backend)
            runs[name] = runs["kernel"] if same_paths and runs else \
                loss_and_grads(model, lambda t: t)
        # the fp64 reference: the plain scan pair on a copy of the model in fp64
        model64 = copy.deepcopy(model).double()
        set_scan_backend(model64, "plain_pair")
        want_loss, want = loss_and_grads(model64, lambda t: t.double())
        del model64
    finally:
        set_scan_backend(model, None)
        for m, rate in rates.items():
            m.rate = rate
    torch.cuda.empty_cache()

    want_norm = torch.sqrt(sum((w ** 2).sum() for w in want)).item()
    want_max = max(w.abs().max().item() for w in want)
    # a parameter whose true gradient is zero (a bias that a norm takes out
    # again) has no relative error: such parameters are left out of the
    # per-parameter statistic
    live = [i for i, w in enumerate(want)
            if w.abs().max().item() > STEP_LIVE_GRAD * want_max]
    names = [n for n, _ in model.named_parameters()]
    is_scan = [n.rsplit(".", 1)[-1] in SCAN_PARAMS
               or any(n.endswith("." + p) for p in MAMBA_SCAN_PARAMS) for n in names]
    readings = {}
    for name, (loss, grads) in runs.items():
        sq = [((g - w) ** 2).sum().item() for g, w in zip(grads, want)]
        err_sq = sum(sq)
        err_norm = err_sq ** 0.5
        worst = sorted(range(len(sq)), key=sq.__getitem__, reverse=True)[:3]
        dot = sum((g * w).sum() for g, w in zip(grads, want)).item()
        norm = torch.sqrt(sum((g ** 2).sum() for g in grads)).item()
        per_param = sorted(((grads[i] - want[i]).abs().max()
                            / want[i].abs().max()).item() for i in live)
        readings[name] = dict(
            loss=loss, loss_rel_err=abs(loss - want_loss) / abs(want_loss),
            grad_norm=norm, grad_err_norm=err_norm,
            grad_rel_err_norm=err_norm / want_norm,
            grad_cosine=dot / (norm * want_norm),
            median_param_rel_err=per_param[len(per_param) // 2],
            worst_param_rel_err=per_param[-1],
            worst_err_share=[[names[i], sq[i] / err_sq] for i in worst],
            scan_param_err_share=sum(e for e, scan in zip(sq, is_scan) if scan)
            / err_sq,
            finite=all(bool(torch.isfinite(g).all()) for g in grads))
    return readings, dict(fp64_loss=want_loss, fp64_grad_norm=want_norm,
                          parameters=len(want), parameters_with_gradient=len(live))


def augmented(trainer, data, seg):
    """One augmentation of a batch with a fixed seed."""
    import torch
    from nnuzoo_tpu_torch.data.augment import augment_train_batch
    with torch.no_grad():
        return augment_train_batch(
            trainer.train_aug_cfg, torch.Generator(device="cuda").manual_seed(7),
            data, seg)


def seeded_batch(trainer, seed=STEP_SEED, batch_size=STEP_BATCH,
                 for_augmentation=True):
    """``batch_size`` patches that a sampler of its own, seeded with
    ``seed``, draws from the trainer's dataset (with the previous stage's
    segmentation as target channel 1 for a cascaded configuration): the
    same batch on every run, whatever the trainer's own sampler did. At the
    augmentation's initial patch size, or with ``for_augmentation=False``
    at the patch size, as the validation draws them."""
    import torch
    from nnuzoo_tpu_torch.data.patch_sampler import PatchSampler
    patch = tuple(trainer.configuration_manager.patch_size)
    initial = trainer.train_aug_cfg.initial_patch_size[-len(patch):] \
        if for_augmentation else patch
    sampler = PatchSampler(
        trainer.dataset_class(trainer.preprocessed_dataset_folder,
                              folder_with_segs_from_previous_stage=
                              trainer._previous_stage_folder()), batch_size,
        initial_patch_size=initial,
        final_patch_size=patch, label_manager=trainer.label_manager,
        oversample_foreground_percent=trainer.local_oversample, seed=seed,
        target_type=trainer.target_type)
    batch = next(sampler)
    return (torch.from_numpy(batch["data"]).cuda(),
            torch.from_numpy(batch["target"]).cuda())


def check_step(depth, name, readings, limits):
    for path, r in readings.items():
        if not (r["finite"] and all(r[key] <= limit for key, limit in
                                    limits.items() if key in r)):
            raise AssertionError(f"training step at {depth}, {name}, {path} vs "
                                 f"fp64: {r} against {limits}")


def phase_step_agreement(trainer, glue="default"):
    """One training step's loss and gradients, kernel path and fp32 plain
    path against the plain path in fp64, each path from the same weights and
    batch (augmented once with a fixed seed, DropPath off), for M2NetP at the
    trainer's widths with weights drawn from STEP_SEED. At stage layers
    (1, 1, 1, 1), where fp32 is well conditioned and the limits are tight,
    on the batch of each sampler seed of SHALLOW_SEEDS: every batch within
    the absolute limits, and the median over the batches of the kernel
    path's error norm over the plain path's within ``kernel_over_plain``.
    With the default glue also at full depth (7, 6, 5, 4), on the batch of
    STEP_SEED, the ratio held on that batch. The batches come from samplers
    of their own (``seeded_batch``) and neither model is the trainer's, so
    nothing depends on the training run, which is not bit-reproducible on
    the card."""
    import numpy as np
    from nnuzoo_tpu_torch.models.registry import get_model_builder

    def model_of(stage_layers):
        with ss2d_glue(glue):
            return get_model_builder(trainer.trainer_name)(
                trainer.plans_manager, trainer.dataset_json,
                trainer.configuration_manager, trainer.num_input_channels, True,
                device="cuda", seed=STEP_SEED, stage_layers=stage_layers)

    limits = SHALLOW_STEP_LIMITS
    model = model_of((1, 1, 1, 1))
    ratios = []
    for seed in SHALLOW_SEEDS:
        readings, reference = step_readings(
            trainer, model, *augmented(trainer, *seeded_batch(trainer, seed)))
        ratio = readings["kernel"]["grad_err_norm"] / \
            readings["plain_fp32"]["grad_err_norm"]
        ratios.append(ratio)
        emit("step_agreement", glue=glue, depth="stage_layers_1_1_1_1",
             batch=STEP_BATCH, seed=STEP_SEED, sampler_seed=seed,
             kernel_over_plain=ratio, **reference, **readings)
        check_step("stage_layers_1_1_1_1", f"sampler seed {seed}", readings,
                   limits)
    del model
    median = float(np.median(ratios))
    emit("step_agreement_median", glue=glue, depth="stage_layers_1_1_1_1",
         sampler_seeds=list(SHALLOW_SEEDS), kernel_over_plain=ratios,
         median_kernel_over_plain=median, limit=limits["kernel_over_plain"])
    if not median <= limits["kernel_over_plain"]:
        raise AssertionError(f"training step at stage layers (1, 1, 1, 1): the "
                             f"kernel path's gradients are further from fp64 "
                             f"than the fp32 plain path's: median ratio {median} "
                             f"over {ratios}")
    if glue != "default":
        return
    limits = STEP_LIMITS
    model = model_of((7, 6, 5, 4))
    readings, reference = step_readings(
        trainer, model, *augmented(trainer, *seeded_batch(trainer)))
    del model
    emit("step_agreement", glue=glue, depth="full_depth", batch=STEP_BATCH,
         seed=STEP_SEED, sampler_seed=STEP_SEED, **reference, **readings)
    check_step("full_depth", f"sampler seed {STEP_SEED}", readings, limits)
    if not (readings["kernel"]["grad_err_norm"] <= limits["kernel_over_plain"]
            * readings["plain_fp32"]["grad_err_norm"]):
        raise AssertionError(f"training step at full depth: the kernel path's "
                             f"gradients are further from fp64 than the fp32 "
                             f"plain path's: {readings}")


def phase_full_step_agreement(trainer, same_paths=False, glue="default",
                              depth="full_depth"):
    """The trainer's model at full width and depth (M2Net,
    SwinUMamba, LightMUNet and SegMamba; SSND2NetP also on the fused glue),
    on ``glue``: one training step's
    loss and gradients from weights drawn from STEP_SEED on the batch of
    STEP_SEED, kernel path and fp32 plain path against the plain path in
    fp64, under phase 6's full-depth rule: the kernel path's error norm
    within ``kernel_over_plain`` of the fp32 plain path's. M2NetP's absolute
    full-depth limits are not assumed to hold for these models: their
    distances are reported."""
    from nnuzoo_tpu_torch.models.registry import get_model_builder
    with ss2d_glue(glue):
        model = get_model_builder(trainer.trainer_name)(
            trainer.plans_manager, trainer.dataset_json,
            trainer.configuration_manager, trainer.num_input_channels, True,
            device="cuda", seed=STEP_SEED)
    readings, reference = step_readings(
        trainer, model, *augmented(trainer, *seeded_batch(trainer)),
        same_paths=same_paths)
    model_name = type(model).__name__
    del model
    emit("step_agreement", glue=glue, model=model_name,
         trainer=trainer.trainer_name, depth=depth,
         batch=STEP_BATCH, seed=STEP_SEED, sampler_seed=STEP_SEED,
         kernel_over_plain=readings["kernel"]["grad_err_norm"]
         / readings["plain_fp32"]["grad_err_norm"], **reference, **readings)
    limit = STEP_LIMITS["kernel_over_plain"]
    if not (all(r["finite"] for r in readings.values())
            and readings["kernel"]["grad_err_norm"]
            <= limit * readings["plain_fp32"]["grad_err_norm"]):
        raise AssertionError(f"{trainer.trainer_name} training step at full "
                             f"depth: the kernel path's gradients against fp64, "
                             f"{readings}")


M2NET = "nnUNetTrainerM2Net"
FINETUNE = "nnUNetTrainerFineTuneDecoderWarmUp"
FINETUNE_STEPS = 2       # steps with the encoder frozen, then as many without


def phase_finetune(m2net_trainer):
    """``nnUNetTrainerFineTuneDecoderWarmUp`` (M2Net) from the M2Net fold's
    final checkpoint through ``load_pretrained_weights``, its configuration
    cut to an epoch of FINETUNE_STEPS steps with the encoder frozen and one
    without (one validation step each): every frozen parameter must be bit
    for bit the loaded one after each frozen step, and every one must have
    moved after the unfrozen steps. Returns the K1 and K2 launches of the
    run."""
    import torch
    from nnuzoo_tpu_torch.ops.selective_scan import scan_core, scan_core_bwd
    from nnuzoo_tpu_torch.run.load_pretrained_weights import load_pretrained_weights
    from nnuzoo_tpu_torch.training.trainer import Trainer

    plans, dataset_json = plans_and_dataset()
    with ss2d_glue("default"):
        trainer = Trainer(plans, "2d", "all", dataset_json, trainer_name=FINETUNE,
                          device="cuda", seed=0)
        trainer.config = replace(
            trainer.config, num_epochs=2, num_iterations_per_epoch=FINETUNE_STEPS,
            num_val_iterations_per_epoch=1, freeze_encoder_epochs=1,
            encoder_warmup_epochs=1, decoder_warmup_epochs=1)
        trainer.initialize()
    state, transferred = load_pretrained_weights(
        trainer.model, os.path.join(m2net_trainer.output_folder,
                                    "checkpoint_final.pth"))
    trainer.model.load_state_dict(state)
    names = set(Trainer._encoder_freeze_mask(trainer.model))
    frozen = {n: p for n, p in trainer.model.named_parameters() if n in names}
    loaded = {n: p.detach().clone() for n, p in frozen.items()}
    steps = []
    inner = trainer.train_step

    def observed_step(data, seg):
        torch.cuda.synchronize()
        before = scan_core.launches, scan_core_bwd.launches
        t0 = time.perf_counter()
        loss = inner(data, seg)
        torch.cuda.synchronize()
        steps.append(dict(
            step=trainer.step, seconds=time.perf_counter() - t0, loss=loss.item(),
            lr=trainer.optimizer.param_groups[0]["lr"],
            k1_launches=scan_core.launches - before[0],
            k2_launches=scan_core_bwd.launches - before[1],
            frozen_as_loaded=sum(torch.equal(p, loaded[n])
                                 for n, p in frozen.items())))
        return loss

    trainer.train_step = observed_step
    scan_core.launches = scan_core_bwd.launches = 0
    trainer.run_training()
    trainer.train_step = inner
    launches = scan_core.launches, scan_core_bwd.launches
    moved = sum(not torch.equal(p, loaded[n]) for n, p in frozen.items())
    emit("finetune", trainer=FINETUNE, model=type(trainer.model).__name__,
         transferred_arrays=transferred, arrays=len(state),
         frozen_parameters=len(frozen),
         parameters=len(list(trainer.model.parameters())), steps=steps,
         frozen_moved_after_unfreeze=moved, k1_launches=launches[0],
         k2_launches=launches[1])
    if len(steps) != 2 * FINETUNE_STEPS or not 0 < transferred < len(state):
        raise AssertionError(f"fine-tuning: {len(steps)} steps, {transferred} "
                             f"arrays transferred")
    if any(s["frozen_as_loaded"] != len(frozen) for s in steps[:FINETUNE_STEPS]):
        raise AssertionError(f"fine-tuning: frozen parameters changed while "
                             f"frozen: {steps}")
    if moved != len(frozen) or any(
            s["k1_launches"] != SCANS_PER_FORWARD
            or s["k2_launches"] != SCANS_PER_FORWARD for s in steps):
        raise AssertionError(f"fine-tuning: {moved} of {len(frozen)} frozen "
                             f"parameters moved after the unfreeze; {steps}")
    return launches


def phase_remat(trainer, glue="default"):
    """One M2Net training step (weights from STEP_SEED, the TRAIN_BATCH
    patches of sampler seed STEP_SEED augmented once, DropPath off) with
    ``remat`` off, off again and on: the scan forward kernel's launches of
    the step with remat on must be the remat-off count (a rematted stage
    keeps its scans' outputs), and its gradients the remat-off step's within
    twice the spread of two remat-off steps (nondeterministic sums in the
    library's backward kernels) plus 1e-6 of the gradient's norm. Returns the
    forward kernel's launches of the remat-on step."""
    import torch
    from nnuzoo_tpu_torch.models.layers import DropPath
    from nnuzoo_tpu_torch.models.registry import get_model_builder

    fwd_kernel, bwd_kernel, per_forward, _ = glue_kernels(glue)
    with ss2d_glue(glue):
        model = get_model_builder(trainer.trainer_name)(
            trainer.plans_manager, trainer.dataset_json,
            trainer.configuration_manager, trainer.num_input_channels, True,
            device="cuda", seed=STEP_SEED)
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    model.train()
    data_aug, targets = augmented(
        trainer, *seeded_batch(trainer, batch_size=TRAIN_BATCH))
    params = list(model.parameters())

    def step(remat):
        model.remat = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd_kernel.launches = bwd_kernel.launches = 0
        t0 = time.perf_counter()
        loss = trainer._compute_loss(
            model(data_aug.movedim(1, -1).contiguous()), targets)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return dict(seconds=time.perf_counter() - t0,
                    peak_memory_bytes=torch.cuda.max_memory_allocated(),
                    fwd_launches=fwd_kernel.launches,
                    bwd_launches=bwd_kernel.launches, loss=loss.item()), grads

    def err_norm(a, b):
        return torch.sqrt(sum(((x - y).double() ** 2).sum()
                              for x, y in zip(a, b))).item()

    off, g_off = step(False)
    off2, g_off2 = step(False)
    on, g_on = step(True)
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in g_off)).item()
    spread, err = err_norm(g_off2, g_off), err_norm(g_on, g_off)
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(g_on, g_off))
    emit("remat", glue=glue, model=type(model).__name__, batch=TRAIN_BATCH,
         remat_off=off, remat_off_again=off2, remat_on=on, grad_norm=norm,
         remat_on_err_norm=err, remat_off_spread_norm=spread,
         worst_param_rel_err=worst)
    del model, g_off, g_off2, g_on
    torch.cuda.empty_cache()
    if not (on["fwd_launches"] == off["fwd_launches"] == per_forward
            and on["bwd_launches"] == off["bwd_launches"] == per_forward):
        raise AssertionError(f"remat: scan launches on {on}, off {off}")
    if not err <= 2 * spread + 1e-6 * norm:
        raise AssertionError(f"remat: gradients {err} off the remat-off step's "
                             f"(spread {spread}, norm {norm})")
    return on["fwd_launches"]


def phase_train_save_predict(trainer, trained):
    """The checkpoint that the training run wrote, loaded from its folder,
    holds the weights ``trained`` that the run ended with and predicts a
    volume through the serving path."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.inference.predictor import Predictor
    predictor = Predictor(tile_step_size=0.5, use_gaussian=True, use_mirroring=True,
                          tile_batch_size=TILE_BATCH, device="cuda")
    predictor.initialize_from_trained_model_folder(trainer.output_folder_base,
                                                   use_folds=["all"])
    loaded = predictor.list_of_parameters[0]
    same = set(loaded) == set(trained) and all(
        torch.equal(loaded[k], v) for k, v in trained.items())
    volume = (100 * np.random.RandomState(1).rand(1, 2, 224, 256)).astype(np.float32)
    seg = predictor.predict_single_npy_array(volume, {"spacing": [3.0, 1.0, 1.0]})
    labels = sorted(int(v) for v in np.unique(seg))
    emit("train_save_predict", trainer=predictor.trainer_name,
         weights_are_the_trained_ones=same, segmentation_shape=list(seg.shape),
         labels=labels, mirroring_axes=list(predictor.allowed_mirroring_axes))
    if not same or seg.shape != volume.shape[1:] or not set(labels) <= {0, 1, 2}:
        raise AssertionError(f"prediction from the trained checkpoint: same={same} "
                             f"{seg.shape} {labels}")


def phase_files_and_validation(trainer, glue="default"):
    """The two file-to-file paths with one SS2D glue, on the model that
    ``trainer`` trained: its final validation (``perform_actual_validation``
    over the fold's preprocessed cases, Dice against ``gt_segmentations``),
    then a seeded raw test folder predicted through the command line's
    ``predict`` entry from the trained-model folder and scored by its
    ``evaluate_folder`` entry. Each written segmentation must equal
    ``predict_single_npy_array`` of the same image read by the port's reader.
    Returns the forward kernel's launches on each path."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.cli.entry_points import (evaluate_folder_entry,
                                                   predict_entry)
    from nnuzoo_tpu_torch.imageio.nifti import NiftiIO

    kernel, _, per_forward, others = glue_kernels(glue)

    def counted(fn):
        torch.cuda.synchronize()
        for k in (kernel, *others):
            k.launches = 0
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return (result, time.perf_counter() - t0, kernel.launches,
                sum(k.launches for k in others))

    with ss2d_glue(glue), first_validation_case(trainer):
        metrics, seconds, val_launches, other = counted(
            trainer.perform_actual_validation)
    dice = metrics["foreground_mean"]["Dice"]
    written = sorted(os.listdir(os.path.join(trainer.output_folder, "validation")))
    emit("validation", glue=glue, cases=len(trainer.validation_case_times),
         seconds=seconds, seconds_per_case=trainer.validation_case_times,
         scan_launches=val_launches, other_glue_launches=other,
         foreground_dice=dice, written=written)
    if not (val_launches > 0 and val_launches % per_forward == 0 and other == 0):
        raise AssertionError(f"validation: {val_launches} scan launches, {other} "
                             f"of the other glue's kernels")
    if not np.isfinite(dice) or "summary.json" not in written:
        raise AssertionError(f"validation: Dice {dice}, files {written}")

    root = os.path.join(os.environ["nnUNet_results"], "test_data")
    images, labels = write_test_folder(root)
    predicted = os.path.join(root, "predicted")
    args = ["-i", images, "-o", predicted, "-d", trainer.plans_manager.dataset_name,
            "-c", trainer.configuration_name, "-tr", trainer.trainer_name,
            "-f", "all", "-device", "cuda"]
    with ss2d_glue(glue):
        predictor, seconds, launches, other = counted(lambda: predict_entry(args))
    forwards = predictor.forward_count
    rw = NiftiIO()
    same = []
    for name in sorted(os.listdir(images)):
        case = name[:-len("_0000.nii.gz")]
        image, props = rw.read_images([os.path.join(images, name)])
        want = predictor.predict_single_npy_array(image, props)
        got = rw.read_seg(os.path.join(predicted, case + ".nii.gz"))[0][0]
        same.append(got.shape == want.shape and bool((got == want).all()))
    summary = evaluate_folder_entry(
        [labels, predicted, "-djfile",
         os.path.join(trainer.output_folder_base, "dataset.json"),
         "-pfile", os.path.join(trainer.output_folder_base, "plans.json"),
         "-o", os.path.join(root, "summary.json")])
    dice = summary["foreground_mean"]["Dice"]
    emit("predict_from_files", glue=glue, cases=len(same), seconds=seconds,
         seconds_per_case={os.path.basename(k): v
                           for k, v in predictor.case_times.items()},
         forwards=forwards, scan_launches=launches, other_glue_launches=other,
         equal_to_predict_single_npy_array=same, foreground_dice=dice,
         dice_per_label={str(k): v["Dice"] for k, v in summary["mean"].items()})
    if not (forwards > 0 and launches == per_forward * forwards and other == 0):
        raise AssertionError(f"predict_from_files: {launches} scan launches ({other} "
                             f"of the other glue's kernels) for {forwards} forwards")
    if len(same) != 2 or not all(same) or not np.isfinite(dice):
        raise AssertionError(f"predict_from_files: equal {same}, Dice {dice}")
    return val_launches, launches


RAW_ID, RAW_NAME = 997, "Dataset997_RawAbdomenMR"
RAW_TRAIN_SHAPE = (80, 256, 224)    # (z, y, x) of a training case
RAW_TEST_SHAPE = (4, 256, 224)
RAW_SPACING_XYZ = (1.0, 1.0, 3.0)   # (z, y, x) spacing (3, 1, 1)


def write_raw_dataset(root, train_cases=3, test_cases=2, seed=11):
    """A seeded dataset in nnU-Net's raw layout under ``root``:
    ``imagesTr``/``labelsTr`` (``train_cases`` of RAW_TRAIN_SHAPE),
    ``imagesTs``/``labelsTs`` (``test_cases`` of RAW_TEST_SHAPE) and
    ``dataset.json`` (background, organ, tumor), one MR channel whose
    intensities follow smooth label blobs, at spacing (3, 1, 1), written
    through the port's NIfTI writer as ``.nii`` (the simple evaluation takes
    the file ending from ``os.path.splitext``)."""
    import numpy as np
    from nnuzoo_tpu_torch.imageio.nifti import write_nifti
    from nnuzoo_tpu_torch.utilities.io import save_json
    folder = os.path.join(root, RAW_NAME)
    rs = np.random.RandomState(seed)
    for split, cases, shape in (("Tr", train_cases, RAW_TRAIN_SHAPE),
                                ("Ts", test_cases, RAW_TEST_SHAPE)):
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(folder, sub + split))
        for i in range(cases):
            seg = blob_labels(rs, shape, 32)
            vol = (100 + 40 * seg + 20 * rs.randn(*shape)).astype(np.float32)
            case = f"{split.lower()}_{i:03d}"
            write_nifti(os.path.join(folder, "images" + split, case + "_0000.nii"),
                        vol.transpose(2, 1, 0), spacing_xyz=RAW_SPACING_XYZ)
            write_nifti(os.path.join(folder, "labels" + split, case + ".nii"),
                        seg.astype(np.uint8).transpose(2, 1, 0),
                        spacing_xyz=RAW_SPACING_XYZ)
    save_json({"channel_names": {"0": "MRI"},
               "labels": {"background": 0, "organ": 1, "tumor": 2},
               "numTraining": train_cases, "file_ending": ".nii"},
              os.path.join(folder, "dataset.json"))
    return folder


@contextlib.contextmanager
def timed_planning(seconds):
    """The seconds of each step that ``plan_and_preprocess`` takes, by the
    names of ``planning.api``'s functions."""
    from nnuzoo_tpu_torch.planning import api
    saved = {n: getattr(api, n) for n in ("extract_fingerprints",
                                          "plan_experiments", "preprocess")}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = time.perf_counter() - t0
        return run

    for name, fn in saved.items():
        setattr(api, name, timed(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(api, name, fn)


def phase_planned_dataset(card):
    """From a raw dataset to a scored prediction through the port's entry
    points, with the default glue: ``plan_and_preprocess`` (fingerprint,
    plans, preprocessing of ``2d`` with 4 threads, integrity check) on
    ``write_raw_dataset``; the plan must be patch [256, 224] at batch 12
    (the JAX package's planner plans the same for this dataset) and every
    case's ``.pkl`` must hold ``class_locations`` for labels 1 and 2. Then
    ``run_training`` of ``nnUNetTrainerM2NetP`` at full width and depth on
    fold 0, one epoch of TRAIN_STEPS steps and one validation step, and the
    final validation; ``predict_from_modelfolder`` on ``imagesTs`` and
    ``evaluate_simple`` against ``labelsTs``. Returns the K1 and K2 launches
    of the whole phase."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.cli.entry_points import main as cli
    from nnuzoo_tpu_torch.ops.cross_scan import cross_scan_bwd, cross_scan_fwd
    from nnuzoo_tpu_torch.ops.selective_scan import scan_core, scan_core_bwd
    from nnuzoo_tpu_torch.run.run_training import run_training
    from nnuzoo_tpu_torch.training import trainer_config
    from nnuzoo_tpu_torch.training.trainer import Trainer
    from nnuzoo_tpu_torch.utilities.io import load_json, load_pickle

    raw = write_raw_dataset(os.environ["nnUNet_raw"])
    planning = {}
    with timed_planning(planning):
        cli(["plan_and_preprocess", "-d", str(RAW_ID), "-c", "2d", "-np", "4",
             "--verify_dataset_integrity"])
    pp = os.path.join(os.environ["nnUNet_preprocessed"], RAW_NAME)
    plan = load_json(os.path.join(pp, "nnUNetPlans.json"))["configurations"]["2d"]
    folder = os.path.join(pp, plan["data_identifier"])
    locations = {}
    for f in sorted(os.listdir(folder)):
        if f.endswith(".pkl"):
            locs = load_pickle(os.path.join(folder, f))["class_locations"]
            locations[f[:-4]] = {str(k): len(v) for k, v in locs.items()}
    if plan["patch_size"] != list(PATCH) or plan["batch_size"] != TRAIN_BATCH:
        raise AssertionError(f"2d plan: patch {plan['patch_size']}, batch "
                             f"{plan['batch_size']}")
    if len(locations) != 3 or not all(
            set(c) == {"1", "2"} and min(c.values()) > 0 for c in locations.values()):
        raise AssertionError(f"class_locations: {locations}")

    # the steps that run_training takes: seconds and launches of each
    steps = []
    inner = Trainer.train_step

    def observed_step(self, data, seg):
        torch.cuda.synchronize()
        before = scan_core.launches, scan_core_bwd.launches
        t0 = time.perf_counter()
        loss = inner(self, data, seg)
        torch.cuda.synchronize()
        steps.append(dict(seconds=time.perf_counter() - t0, loss=loss.item(),
                          fwd_launches=scan_core.launches - before[0],
                          bwd_launches=scan_core_bwd.launches - before[1]))
        return loss

    name = "nnUNetTrainerM2NetP"
    base = trainer_config.TRAINER_CONFIGS[name]
    trainer_config.TRAINER_CONFIGS[name] = replace(
        base, num_epochs=1, num_iterations_per_epoch=TRAIN_STEPS,
        num_val_iterations_per_epoch=1)
    Trainer.train_step = observed_step
    kernels = (scan_core, scan_core_bwd, cross_scan_fwd, cross_scan_bwd)
    try:
        with ss2d_glue("default"):
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            trainer = run_training(RAW_ID, "2d", 0, trainer_name=name,
                                   device="cuda", seed=0)
            torch.cuda.synchronize()
            train_seconds = time.perf_counter() - t0
            model_folder = trainer.output_folder_base
            summary = load_json(os.path.join(trainer.output_folder, "validation",
                                             "summary.json"))
            val_dice = summary["foreground_mean"]["Dice"]
            val_cases = trainer.validation_case_times
            del trainer
            predicted = os.path.join(os.environ["nnUNet_results"], "planned_test")
            t0 = time.perf_counter()
            predictor = cli(["predict_from_modelfolder", "-i",
                             os.path.join(raw, "imagesTs"), "-o", predicted,
                             "-m", model_folder, "-f", "0", "-device", "cuda"])
            torch.cuda.synchronize()
            predict_seconds = time.perf_counter() - t0
            launches = scan_core.launches, scan_core_bwd.launches
            other = cross_scan_fwd.launches + cross_scan_bwd.launches
    finally:
        Trainer.train_step = inner
        trainer_config.TRAINER_CONFIGS[name] = base
    scores = cli(["evaluate_simple", os.path.join(raw, "labelsTs"), predicted,
                  "-l", "1", "2", "-o", os.path.join(predicted, "summary.json"),
                  "-np", "2"])
    dice = scores["foreground_mean"]["Dice"]
    emit("planned_dataset", card=card, dataset=RAW_NAME,
         raw_train_cases=3, raw_shape=list(RAW_TRAIN_SHAPE),
         plan_patch=plan["patch_size"], plan_batch=plan["batch_size"],
         fingerprint_s_per_case=planning["extract_fingerprints"] / 3,
         planning_s=planning["plan_experiments"],
         preprocessing_s_per_case=planning["preprocess"] / 3,
         class_locations=locations, steps=steps,
         seconds_per_step_after_first=float(np.mean([s["seconds"]
                                                     for s in steps[1:]])),
         k1_launches_per_step=[s["fwd_launches"] for s in steps],
         k2_launches_per_step=[s["bwd_launches"] for s in steps],
         run_training_s=train_seconds, validation_cases=val_cases,
         validation_dice=val_dice, predict_s=predict_seconds,
         forwards=predictor.forward_count, k1_launches=launches[0],
         k2_launches=launches[1], other_glue_launches=other,
         foreground_dice=dice,
         dice_per_label={k: v["Dice"] for k, v in scores["mean"].items()})
    if len(steps) != TRAIN_STEPS or not all(
            s["fwd_launches"] == s["bwd_launches"] == SCANS_PER_FORWARD
            for s in steps) or other:
        raise AssertionError(f"planned dataset: steps {steps}, {other} launches "
                             f"of the fused glue's kernels")
    if launches[1] != TRAIN_STEPS * SCANS_PER_FORWARD or \
            launches[0] <= (TRAIN_STEPS + 1) * SCANS_PER_FORWARD:
        raise AssertionError(f"planned dataset: K1/K2 launches {launches}")
    if not (np.isfinite(dice) and np.isfinite(val_dice)) or \
            len(scores["metric_per_case"]) != 2:
        raise AssertionError(f"planned dataset: Dice {dice}, validation "
                             f"{val_dice}, {len(scores['metric_per_case'])} cases")
    return launches


# ----------------------------------------------------------------- CNN baselines
# The nnU-Net CNN baselines: PlainConvUNet and ResidualEncoderUNet from the
# plans (nnUNetTrainer, nnUNetTrainerResEncUNet) and U2Net / U2NetP. Their
# convolutions run through cuDNN and their paths launch none of K1-K4.
CNN = "nnUNetTrainer"
RESENC = "nnUNetTrainerResEncUNet"
U2NETS = ("nnUNetTrainerU2NetP", "nnUNetTrainerU2Net")
# benchmarks/zoo_sweep.py's 3d_fullres plan (``build_plans`` with a 3-d patch;
# copied, that file imports the JAX package): a planner-derived AbdomenCT
# 3d_fullres, 6 stages to 320 features, anisotropic first and last strides
CNN_3D_PATCH = (48, 192, 192)
CNN_3D_BATCH = 2
CNN_3D_SPACING = (2.5, 0.8, 0.8)
CNN_3D_ARCH = {
    "n_stages": 6,
    "features_per_stage": [32, 64, 128, 256, 320, 320],
    "kernel_sizes": [[1, 3, 3]] + [[3, 3, 3]] * 5,
    "strides": [[1, 1, 1], [1, 2, 2]] + [[2, 2, 2]] * 3 + [[1, 2, 2]],
    "n_conv_per_stage": [2] * 6,
    "n_conv_per_stage_decoder": [2] * 5,
}
# benchmarks/bench_inference.py's 2d PlainConvUNet (copied likewise)
CNN_2D_ARCH = {
    "n_stages": 5,
    "features_per_stage": [32, 64, 128, 256, 512],
    "kernel_sizes": [[3, 3]] * 5,
    "strides": [[1, 1]] + [[2, 2]] * 4,
    "n_conv_per_stage": [2] * 5,
    "n_conv_per_stage_decoder": [2] * 4,
}
CNN_3D_TILE_BATCH = 2
CNN_3D_VOLUME = (1, 64, 256, 256)   # (c, z, y, x): 2x2x2 tiles of the patch
# one tile of the patch: the 3d serving volume of the models with scans
# (zoo_sweep's 1x64x256x256 takes 8 tiles, 64 forwards with the mirrors)
ONE_TILE_3D = (1, *CNN_3D_PATCH)
CNN_3D_CASE = (80, 256, 256)        # (z, y, x) of a preprocessed training case
# one 3d training step of PlainConvUNet (random weights from STEP_SEED, GroupNorm
# after every conv) against the same step in fp64: |loss - fp64| / |fp64| and
# the gradient's error norm over the fp64 gradient's norm
CNN_STEP_LIMITS = {"loss_rel_err": 1e-5, "grad_rel_err_norm": 1e-3}


def scan_kernels():
    """The wrappers of K1-K4, each counting its launches."""
    from nnuzoo_tpu_torch.ops.cross_scan import cross_scan_bwd, cross_scan_fwd
    from nnuzoo_tpu_torch.ops.selective_scan import scan_core, scan_core_bwd
    return scan_core, scan_core_bwd, cross_scan_fwd, cross_scan_bwd


def reset_scan_launches():
    for k in scan_kernels():
        k.launches = 0


def scan_launches():
    return sum(k.launches for k in scan_kernels())


def model_flop(model, batch_shape, backward):
    """Operations of one forward (and with ``backward`` the backward too) of
    ``model`` on a channels-last input of ``batch_shape``, as
    ``torch.utils.flop_counter`` counts them on a copy on the meta device
    (a convolution's multiply-adds count twice; the scans and norms are not
    counted)."""
    return model_counts(model, batch_shape, backward)[0]


def model_counts(model, batch_shape, backward):
    """(``model_flop``, the bytes of the tensors that the forward saves for
    the backward, counted each time an op saves one, so views and shared
    tensors count more than once: an upper bound)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    # eval mode: DropPath, the one module that differs, would draw its masks
    # from a generator on the card
    meta = copy.deepcopy(model).to("meta").eval()
    x = torch.empty(batch_shape, device="meta")
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    with FlopCounterMode(display=False) as counter:
        if backward:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                outputs = meta(x)
            sum(o.sum() for o in outputs).backward()
        else:
            with torch.no_grad():
                meta(x)
    return counter.get_total_flops(), saved[0]


def cnn_plans(dim):
    """Phase 4's 2d plans with bench_inference's PlainConvUNet, or
    zoo_sweep's 3d_fullres plan with phase 4's resampling settings (a
    dataset of its own): (plans, dataset.json, configuration name)."""
    plans, dataset_json = plans_and_dataset()
    config = plans["configurations"]["2d"]
    if dim == 2:
        config["architecture"] = {"network_class_name": "PlainConvUNet",
                                  "arch_kwargs": CNN_2D_ARCH}
        return plans, dataset_json, "2d"
    plans["dataset_name"] = "Dataset998_Sweep3d"
    plans["configurations"] = {"3d_fullres": dict(
        config, data_identifier="nnUNetPlans_3d_fullres", batch_size=CNN_3D_BATCH,
        patch_size=list(CNN_3D_PATCH), spacing=list(CNN_3D_SPACING),
        architecture={"network_class_name": "PlainConvUNet",
                      "arch_kwargs": CNN_3D_ARCH})}
    return plans, dataset_json, "3d_fullres"


def scan_calls(trainer_name, dim, glue="default"):
    """K1 launches (K3's with the fused glue) of one forward of the
    trainer's model at full width (256x224, or zoo_sweep's 3d patch): none
    for the CNN baselines."""
    if trainer_name in SSND2NET_FAMILY:
        return ssnd2net_calls(trainer_name, dim, glue)
    table = MAMBA_SCANS_3D if dim == 3 else MAMBA_SCANS_2D
    return sum(table.get(trainer_name, {}).values())


def phase_cnn_serving(trainer_name, dim, glue="default", volume_shape=None,
                      tile_check=None):
    """Serving a CNN or Transformer baseline (or a Mamba baseline at 3d) at
    full width through ``Predictor.predict_single_npy_array``: at 3d
    zoo_sweep's plan on a seeded 1x64x256x256 volume (8 tiles, tile batch 2,
    mirror TTA over 3 axes), at 2d phase 4's volume and settings. Seconds
    per volume, peak memory and K1-K4 launches (none for a CNN or a
    Transformer; a Mamba model's K1 launches a forward as its scan table
    says, an SSND2Net's K1 or K3 by ``glue``); for a model without scans one
    tile batch's logits, fp32 against the same model in fp64, by phase 4's
    limits; for a model with scans, where ``tile_check`` asks for it, the
    tile batch through ``tile_readings`` (one pass, the plain scans in
    2048-step chunks) held by ``check_tile_readings``' rule. ``volume_shape``
    (c, z, y, x) replaces the 3d volume. Returns the launches."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.inference.predictor import Predictor
    from nnuzoo_tpu_torch.inference.sliding_window import (
        get_sliding_window_slicers, pad_nd_image)
    from nnuzoo_tpu_torch.models.registry import get_model_builder
    from nnuzoo_tpu_torch.plans.plans_handler import PlansManager
    from nnuzoo_tpu_torch.preprocessing.preprocessor import DefaultPreprocessor

    plans, dataset_json, name = cnn_plans(dim)
    pm = PlansManager(plans)
    cfg = pm.get_configuration(name)
    patch = tuple(cfg.patch_size)
    per_forward = scan_calls(trainer_name, dim, glue)
    t0 = time.perf_counter()
    with ss2d_glue(glue):
        model = get_model_builder(trainer_name)(pm, dataset_json, cfg, 1,
                                                deep_supervision=False,
                                                device="cuda", seed=0)
    build_s = time.perf_counter() - t0
    tile_batch = CNN_3D_TILE_BATCH if dim == 3 else TILE_BATCH
    axes = (0, 1, 2) if dim == 3 else (0, 1)
    predictor = Predictor(tile_step_size=0.5, use_gaussian=True, use_mirroring=True,
                          tile_batch_size=tile_batch, device="cuda")
    predictor.manual_initialization(model, [model.state_dict()], pm, cfg,
                                    dataset_json, trainer_name, axes)
    rng = np.random.RandomState(0)
    if dim == 3:
        volume = (100 * rng.rand(*(volume_shape or CNN_3D_VOLUME))).astype(
            np.float32)
        props = {"spacing": list(CNN_3D_SPACING)}
    else:
        volume = (100 * rng.rand(1, 4, 224, 256)).astype(np.float32)
        props = {"spacing": [3.0, 1.0, 1.0]}

    # the first tile batch of the volume: the warm-up and the tile check.
    # One pass warms up: the mirrored passes run the same kernels on the
    # same shapes (and at one tile, a mirrored warm-up would double the
    # work of the volume)
    data, _ = DefaultPreprocessor().run_case_npy(
        volume, None, dict(props), pm, cfg, dataset_json)
    padded, _ = pad_nd_image(data, patch)
    slicers = get_sliding_window_slicers(padded.shape[1:], patch, 0.5)[:tile_batch]
    tiles = torch.stack([torch.from_numpy(np.ascontiguousarray(padded[sl]))
                         for sl in slicers]).cuda().movedim(1, -1).contiguous()
    predictor.use_mirroring = False
    predictor.tile_forward(tiles)                                 # warm-up
    predictor.use_mirroring = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_scan_launches()
    predictor.forward_count = 0
    t0 = time.perf_counter()
    seg = predictor.predict_single_npy_array(volume, dict(props))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, forwards = scan_launches(), predictor.forward_count
    labels = sorted(int(v) for v in np.unique(seg))
    tile_flop = ssnd2net_counts(model, trainer_name, glue)["forward_flop"] \
        if trainer_name in SSND2NET_FAMILY and dim == 3 \
        else model_flop(model, (1, *patch, 1), backward=False)
    kind = path_kind(trainer_name)
    emit("mamba_serving_3d" if per_forward and kind == "cnn" else f"{kind}_serving",
         trainer=trainer_name, model=type(model).__name__, dim=dim, glue=glue,
         parameters=sum(p.numel() for p in model.parameters()), patch=list(patch),
         model_build_s=build_s, seconds_per_volume=seconds,
         tile_tflop=tile_flop / 1e12,
         tflop_per_s=tile_flop * forwards * tile_batch / seconds / 1e12,
         scans_per_forward=per_forward, volume=list(volume.shape),
         segmentation_shape=list(seg.shape), labels=labels, tile_batch=tile_batch,
         forwards=forwards, scan_launches=launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if seg.shape != volume.shape[1:] or not set(labels) <= {0, 1, 2} or \
            forwards == 0 or launches != per_forward * forwards:
        raise AssertionError(f"{trainer_name} serving: segmentation {seg.shape} "
                             f"labels {labels}, {forwards} forwards, {launches} "
                             f"scan launches, {per_forward} a forward expected")

    if per_forward:
        # a Mamba model at 3d: its fp64 twin would run the plain scan over
        # up to 1.77M positions for each of 8 mirrorings; its kernels are
        # held to their plain versions at these shapes in phase 24
        if tile_check is not None:
            # 256-step chunks would cost the host a minute of launches at
            # these lengths
            with plain_chunk(2048):
                readings = tile_readings(model, tiles, pm, cfg, dataset_json,
                                         trainer_name, axes, tile_batch,
                                         False, True)
            emit(f"{kind}_tile_logits", trainer=trainer_name, dim=dim,
                 glue=glue, tiles=len(slicers), limits=tile_check,
                 plain_chunk=2048, **readings)
            check_tile_readings(readings, tile_check)
        torch.cuda.empty_cache()
        return launches
    # the tile batch, fp32 against the model in fp64, one pass without the
    # mirrors
    check = Predictor(use_mirroring=False, tile_batch_size=tile_batch,
                      device="cuda")
    check.manual_initialization(model, [model.state_dict()], pm, cfg,
                                dataset_json, trainer_name, axes)
    got = check.tile_forward(tiles)
    model64 = copy.deepcopy(model).double()
    reference = Predictor(use_mirroring=False, tile_batch_size=tile_batch,
                          device="cuda")
    reference.manual_initialization(model64, [model64.state_dict()], pm, cfg,
                                    dataset_json, trainer_name, axes)
    want = reference.tile_forward(tiles.double())
    del reference, model64
    c = compare(got, want)
    c["argmax_agreement"] = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    emit(f"{path_kind(trainer_name)}_tile_logits", trainer=trainer_name, dim=dim,
         tiles=len(slicers),
         fp32_vs_fp64=c)
    if not (c["max_abs"] <= TILE_MAX_TOL * c["range_ref"]
            and c["mean_abs"] <= TILE_MEAN_TOL * c["range_ref"]
            and c["argmax_agreement"] >= AGREE_MIN):
        raise AssertionError(f"{trainer_name} tile logits against fp64: {c}")
    torch.cuda.empty_cache()
    return launches


def phase_cnn_training(trainer_name, dim, glue="default", remat=False):
    """``Trainer.run_training()`` of a CNN or Transformer baseline (or a
    Mamba baseline at 3d) for one epoch of TRAIN_STEPS steps and one
    validation step (SGD and poly for the PlainConvUNet), at 3d on three
    seeded preprocessed 1x80x256x256 cases at zoo_sweep's spacing (written
    unless there), at 2d on phase 5's dataset. Seconds per step, peak
    memory, K1-K4 launches (none for a CNN or a Transformer; a Mamba
    model's K1 and K2 as its scan table says, each step and the validation
    step; an SSND2Net's K1 and K2 or K3 and K4 by ``glue``, the forward
    kernel twice a step with ``remat``, which reruns each mini whole).
    Returns the trainer, the launches (all of K1-K4; the forward and the
    backward kernel's for a model with scans) and the last batch."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.training.trainer import Trainer

    fwd_kernel, bwd_kernel = scan_kernels()[2:] if glue == "fused" \
        else scan_kernels()[:2]
    plans, dataset_json, name = cnn_plans(dim)
    folder = os.path.join(os.environ["nnUNet_preprocessed"], plans["dataset_name"],
                          plans["configurations"][name]["data_identifier"])
    if not os.path.isdir(folder):
        if dim == 3:
            write_dataset(folder, shape=CNN_3D_CASE, spacing=CNN_3D_SPACING,
                          block=32)
        else:
            write_dataset(folder)
    trainer = Trainer(plans, name, "all", dataset_json, num_epochs=1,
                      trainer_name=trainer_name, device="cuda", seed=0)
    trainer.config = replace(trainer.config, num_iterations_per_epoch=TRAIN_STEPS,
                             num_val_iterations_per_epoch=1)
    before_remat = os.environ.get("NNUZOO_REMAT")
    os.environ["NNUZOO_REMAT"] = "1" if remat else "0"
    try:
        with ss2d_glue(glue):
            trainer.initialize()
    finally:
        os.environ.pop("NNUZOO_REMAT")
        if before_remat is not None:
            os.environ["NNUZOO_REMAT"] = before_remat
    steps, batches = [], []
    inner = trainer.train_step

    def observed_step(data, seg):
        batches.append((data, seg))
        torch.cuda.synchronize()
        before = scan_launches()
        t0 = time.perf_counter()
        loss = inner(data, seg)
        torch.cuda.synchronize()
        steps.append(dict(seconds=time.perf_counter() - t0, loss=loss.item(),
                          scan_launches=scan_launches() - before))
        return loss

    trainer.train_step = observed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_scan_launches()
    t0 = time.perf_counter()
    trainer.run_training()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    trainer.train_step = inner
    launches = scan_launches()
    k1_k2 = fwd_kernel.launches, bwd_kernel.launches
    per_forward = scan_calls(trainer_name, dim, glue)
    # with remat each step runs the forward twice
    fwd_per_step = (2 if remat else 1) * per_forward
    peak = torch.cuda.max_memory_allocated()
    losses = [s["loss"] for s in steps]
    log = trainer.logger.my_fantastic_logging
    step_s = float(np.mean([s["seconds"] for s in steps[1:]]))
    batch = batches[0][0].shape[0]
    if trainer_name in SSND2NET_FAMILY:
        # the meta device's backward would walk every plain scan chunk on
        # the host: three forwards' worth
        c = ssnd2net_counts(trainer.model, trainer_name, glue)
        step_flop, saved = 3 * batch * c["forward_flop"], batch * c["saved_bytes"]
    else:
        step_flop, saved = model_counts(
            trainer.model, (batch, *trainer.configuration_manager.patch_size, 1),
            backward=True)
    readings = dict(
        trainer=trainer_name, model=type(trainer.model).__name__, dim=dim,
        glue=glue, remat=getattr(trainer.model, "remat", False),
        parameters=sum(p.numel() for p in trainer.model.parameters()),
        optimizer=type(trainer.optimizer).__name__, steps=steps, losses=losses,
        seconds_per_step_after_first=step_s, step_tflop=step_flop / 1e12,
        tflop_per_s=step_flop / step_s / 1e12, saved_activation_bytes=saved,
        k1_launches=k1_k2[0], k2_launches=k1_k2[1], scans_per_forward=per_forward,
        run_training_seconds=seconds, val_loss=log["val_losses"][0],
        pseudo_dice=log["dice_per_class_or_region"][0], scan_launches=launches,
        peak_memory_bytes=peak, batch=list(batches[0][0].shape),
        initial_patch=list(trainer.train_aug_cfg.initial_patch_size),
        do_dummy_2d=trainer.train_aug_cfg.do_dummy_2d,
        ds_scales=ds_scales_list(trainer))
    kind = path_kind(trainer_name)
    emit(f"mamba_training_{dim}d" if per_forward and kind == "cnn"
         else f"{kind}_training", **readings)
    if len(steps) != TRAIN_STEPS or not all(np.isfinite(losses)) or \
            not np.isfinite(log["val_losses"][0]) or \
            k1_k2 != (TRAIN_STEPS * fwd_per_step + per_forward,
                      TRAIN_STEPS * per_forward) \
            or launches != sum(k1_k2) or \
            getattr(trainer.model, "remat", False) != remat or any(
                s["scan_launches"] != fwd_per_step + per_forward for s in steps):
        raise AssertionError(f"{trainer_name} training: losses {losses}, val "
                             f"{log['val_losses']}, {launches} scan launches "
                             f"(K1, K2: {k1_k2}), {per_forward} a forward expected")
    if tuple(batches[0][0].shape[:2]) != (trainer.configuration_manager.batch_size, 1):
        raise AssertionError(f"batch shape {batches[0][0].shape}")
    for f in ("checkpoint_final.pth", "checkpoint_best.pth"):
        if not os.path.isfile(os.path.join(trainer.output_folder, f)):
            raise AssertionError(f"{f} was not written")
    return trainer, (k1_k2 if per_forward else launches), batches[-1]


def profile_cnn_step(trainer, data, seg):
    """Device time of one training step under torch.profiler, against the
    wall time of two unprofiled steps: the share of the step the device is
    busy (the steps move the trainer's weights: run it after the fold's
    validation). The table goes to chiprun_out/profile_cnn_step_<dim>d.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        trainer.train_step(data, seg)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        trainer.train_step(data, seg)
        torch.cuda.synchronize()
    events = prof.key_averages()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    table = (f"chiprun_out/profile_cnn_step_"
             f"{len(trainer.configuration_manager.patch_size)}d.txt")
    (ROOT / table).write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=40))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return dict(step_wall_ms=wall_ms, device_ms=total,
                device_busy_share=total / wall_ms,
                launches=sum(e.count for e in kernels), table=table,
                top_kernels_ms=[[e.key[:80], e.self_device_time_total / 1e3]
                                for e in top])


def phase_cnn_step_agreement(trainer, limits=CNN_STEP_LIMITS, augment=True):
    """One training step of the trainer's model (the 3d PlainConvUNet, or a
    Transformer baseline), with weights drawn from STEP_SEED, on the batch of
    STEP_SEED's sampler (the plan's batch, augmented once with a fixed
    seed; with ``augment=False`` drawn at the patch size and not augmented):
    the loss and every gradient in fp32 against the same step in fp64 on the
    card, with the same DropPath masks, held to ``limits``."""
    import torch
    from nnuzoo_tpu_torch.data.augment import prepare_val_batch
    from nnuzoo_tpu_torch.models.layers import DropPath
    from nnuzoo_tpu_torch.models.registry import get_model_builder
    model = get_model_builder(trainer.trainer_name)(
        trainer.plans_manager, trainer.dataset_json, trainer.configuration_manager,
        trainer.num_input_channels, True, device="cuda", seed=STEP_SEED)
    batch = seeded_batch(trainer, batch_size=trainer.configuration_manager.batch_size,
                         for_augmentation=augment)
    data_aug, targets = augmented(trainer, *batch) if augment else \
        prepare_val_batch(trainer.val_aug_cfg, *batch)

    def loss_and_grads(net, dtype):
        net.train()
        for m in net.modules():     # the twins share one generator
            if isinstance(m, DropPath) and m.generator is not None:
                m.generator.manual_seed(STEP_SEED)
        outputs = net(data_aug.to(dtype).movedim(1, -1).contiguous())
        loss = trainer._compute_loss(outputs, targets)
        params = list(net.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        # the deepest head's weight in the loss is 0: no gradient reaches it
        return loss.item(), [torch.zeros_like(p, dtype=torch.float64) if g is None
                             else g.double() for p, g in zip(params, grads)]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(model, torch.float32)
    fp32_s = time.perf_counter() - t0
    model64 = copy.deepcopy(model).double()
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want_loss, want = loss_and_grads(model64, torch.float64)
    fp64_s = time.perf_counter() - t0
    del model64
    torch.cuda.empty_cache()
    norm = torch.sqrt(sum((w ** 2).sum() for w in want)).item()
    err = torch.sqrt(sum(((g - w) ** 2).sum() for g, w in zip(grads, want))).item()
    readings = dict(loss=loss, fp64_loss=want_loss,
                    loss_rel_err=abs(loss - want_loss) / abs(want_loss),
                    grad_norm_fp64=norm, grad_err_norm=err,
                    grad_rel_err_norm=err / norm,
                    finite=all(bool(torch.isfinite(g).all()) for g in grads))
    emit(f"{path_kind(trainer.trainer_name)}_step_agreement",
         trainer=trainer.trainer_name, augmented=augment,
         batch=list(data_aug.shape), seed=STEP_SEED, fp32_s=fp32_s, fp64_s=fp64_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         limits=limits, **readings)
    if not (readings["finite"] and all(readings[k] <= v
                                       for k, v in limits.items())):
        raise AssertionError(f"{trainer.trainer_name} step against fp64: "
                             f"{readings} against {limits}")


def phase_cnn_validation(trainer):
    """The final validation of a CNN fold (``perform_actual_validation``:
    every case of the fold through the sliding window, written and scored
    against ``gt_segmentations``): seconds per case, Dice, launches."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_scan_launches()
    t0 = time.perf_counter()
    with first_validation_case(trainer):
        metrics = trainer.perform_actual_validation()
    torch.cuda.synchronize()
    seconds, launches = time.perf_counter() - t0, scan_launches()
    dice = metrics["foreground_mean"]["Dice"]
    emit("cnn_validation", trainer=trainer.trainer_name,
         dim=len(trainer.configuration_manager.patch_size),
         cases=len(trainer.validation_case_times), seconds=seconds,
         seconds_per_case=trainer.validation_case_times, foreground_dice=dice,
         scan_launches=launches, peak_memory_bytes=torch.cuda.max_memory_allocated())
    if not np.isfinite(dice) or launches or not trainer.validation_case_times:
        raise AssertionError(f"{trainer.trainer_name} validation: Dice {dice}, "
                             f"{launches} scan launches")
    return launches


def phase_planned_3d(card):
    """Phase 14's raw dataset at 3d through the command line:
    ``plan_and_preprocess -c 3d_fullres`` with the default planner and with
    ``-pl ResEncUNetPlanner``, then ``train <id> 3d_fullres 0`` with the
    default trainer (PlainConvUNet plans) and with ``-tr
    nnUNetTrainerResEncUNet -p nnUNetResEncUNetPlans``, each cut to one epoch
    of TRAIN_STEPS steps and one validation step, with its final validation;
    ``predict_from_modelfolder`` on ``imagesTs`` and ``evaluate_simple``
    against ``labelsTs`` for each. Returns the K1-K4 launches (none)."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.cli.entry_points import main as cli
    from nnuzoo_tpu_torch.training import trainer_config
    from nnuzoo_tpu_torch.training.trainer import Trainer
    from nnuzoo_tpu_torch.utilities.io import load_json

    raw = os.path.join(os.environ["nnUNet_raw"], RAW_NAME)
    pp = os.path.join(os.environ["nnUNet_preprocessed"], RAW_NAME)
    runs = {}
    for planner, plans_name, trainer_name in (
            ("ExperimentPlanner", "nnUNetPlans", CNN),
            ("ResEncUNetPlanner", "nnUNetResEncUNetPlans", RESENC)):
        planning = {}
        with timed_planning(planning):
            cli(["plan_and_preprocess", "-d", str(RAW_ID), "-c", "3d_fullres",
                 "-np", "4", "-pl", planner])
        plan = load_json(os.path.join(pp, plans_name + ".json"))[
            "configurations"]["3d_fullres"]
        runs[trainer_name] = dict(
            planner=planner, plans=plans_name, patch=plan["patch_size"],
            batch=plan["batch_size"], spacing=plan["spacing"],
            architecture=plan["architecture"]["network_class_name"],
            planning_s=planning["plan_experiments"],
            preprocessing_s_per_case=planning["preprocess"] / 3)

    steps = []
    inner = Trainer.train_step

    def observed_step(self, data, seg):
        torch.cuda.synchronize()
        before = scan_launches()
        t0 = time.perf_counter()
        loss = inner(self, data, seg)
        torch.cuda.synchronize()
        steps.append(dict(seconds=time.perf_counter() - t0, loss=loss.item(),
                          scan_launches=scan_launches() - before))
        return loss

    bases = {n: trainer_config.TRAINER_CONFIGS[n] for n in (CNN, RESENC)}
    for n, base in bases.items():
        trainer_config.TRAINER_CONFIGS[n] = replace(
            base, num_epochs=1, num_iterations_per_epoch=TRAIN_STEPS,
            num_val_iterations_per_epoch=1)
    Trainer.train_step = observed_step
    reset_scan_launches()
    try:
        for trainer_name, run in runs.items():
            steps.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cli(["train", str(RAW_ID), "3d_fullres", "0", "-p", run["plans"],
                 "-device", "cuda"] + (["-tr", trainer_name]
                                       if trainer_name != CNN else []))
            torch.cuda.synchronize()
            run["train_and_validation_s"] = time.perf_counter() - t0
            run["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            run["steps"] = list(steps)
            run["seconds_per_step_after_first"] = float(np.mean(
                [s["seconds"] for s in steps[1:]]))
            model_folder = os.path.join(os.environ["nnUNet_results"], RAW_NAME,
                                        f"{trainer_name}__{run['plans']}__3d_fullres")
            summary = load_json(os.path.join(model_folder, "fold_0", "validation",
                                             "summary.json"))
            run["validation_dice"] = summary["foreground_mean"]["Dice"]
            predicted = os.path.join(os.environ["nnUNet_results"],
                                     f"planned_3d_{trainer_name}")
            t0 = time.perf_counter()
            predictor = cli(["predict_from_modelfolder", "-i",
                             os.path.join(raw, "imagesTs"), "-o", predicted,
                             "-m", model_folder, "-f", "0", "-device", "cuda"])
            torch.cuda.synchronize()
            run["predict_s"] = time.perf_counter() - t0
            run["forwards"] = predictor.forward_count
            scores = cli(["evaluate_simple", os.path.join(raw, "labelsTs"),
                          predicted, "-l", "1", "2", "-o",
                          os.path.join(predicted, "summary.json"), "-np", "2"])
            run["test_cases"] = len(scores["metric_per_case"])
            run["foreground_dice"] = scores["foreground_mean"]["Dice"]
            del predictor
            torch.cuda.empty_cache()
    finally:
        Trainer.train_step = inner
        trainer_config.TRAINER_CONFIGS.update(bases)
    launches = scan_launches()
    emit("planned_3d", card=card, dataset=RAW_NAME, runs=runs, scan_launches=launches)
    for trainer_name, run in runs.items():
        if len(run["steps"]) != TRAIN_STEPS or run["test_cases"] != 2 or \
                not (np.isfinite(run["validation_dice"])
                     and np.isfinite(run["foreground_dice"])):
            raise AssertionError(f"planned 3d, {trainer_name}: {run}")
    if launches or runs[RESENC]["architecture"] != "ResidualEncoderUNet":
        raise AssertionError(f"planned 3d: {launches} scan launches, {runs}")
    return launches


# ----------------------------------------------------------------- cascade
CASCADE_STEPS = 2        # steps of each stage of the cascade (and one val step)
CASCADE_AUG_REPS = 5     # timed augmentations of one batch, each setting
CASCADE_CHECK_CROP = (32, 64, 64)   # the card-against-CPU morphology's volume


def cascade_augmentation(trainer):
    """The cascaded stage's augmentation of one batch of its plan, timed
    apart from the step with CUDA events (the median of CASCADE_AUG_REPS
    calls after one warm-up): as configured (the noise's gates drawn, p=0.4
    and 0.2 a sample), with both gates open, and without the cascade move;
    then the morphology and the component removal of that batch's one-hot
    channels (a CASCADE_CHECK_CROP crop of each, every operation in turn,
    given radii and seed voxels) on the card against the same functions on
    the CPU, bit for bit."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.data import augment as aug

    data, seg = seeded_batch(trainer,
                             batch_size=trainer.configuration_manager.batch_size)
    cfg = trainer.train_aug_cfg
    settings = {"as_configured": cfg,
                "gates_open": replace(cfg, p_cascade_binary_op=1.0,
                                      p_cascade_remove_component=1.0),
                "no_cascade": replace(cfg, is_cascaded=False)}
    ms = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        for name, setting in settings.items():
            aug.augment_train_batch(setting, gen, data, seg)
            times = []
            for _ in range(CASCADE_AUG_REPS):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
                start.record()
                aug.augment_train_batch(setting, gen, data, seg)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ms[name] = float(np.median(times))

    # the card against the CPU, bit for bit, on a crop of the batch's one-hot
    # around the median foreground voxel of the first sample
    centre = (seg[0, 1] > 0).nonzero().median(0).values.tolist()
    crop = []
    for m, c, n in zip(centre, CASCADE_CHECK_CROP, seg.shape[2:]):
        low = max(0, min(m - c // 2, n - c))
        crop.append(slice(low, low + c))
    crop = tuple(crop)
    prev = seg[(slice(None), 1) + crop]
    onehot = torch.stack([prev == label for label in cfg.foreground_labels],
                         dim=1).float()
    B, F = onehot.shape[:2]
    cpu = torch.Generator().manual_seed(5)
    perm = torch.rand((B, F), generator=cpu).argsort(1)
    op = torch.arange(B * F).reshape(B, F) % 4          # every operation
    radius = 1.0 + (cfg.cascade_strel_max - 1.0) * torch.rand((B, F), generator=cpu)
    checks = {}
    with torch.no_grad():
        on_card = aug.binary_operations_apply(onehot, perm.cuda(), op.cuda(),
                                              radius.cuda(), cfg.cascade_strel_max)
        on_cpu = aug.binary_operations_apply(onehot.cpu(), perm, op, radius,
                                             cfg.cascade_strel_max)
        checks["morphology_equal"] = bool(torch.equal(on_card.cpu(), on_cpu))
        flat = on_cpu.flatten(0, 1)
        seeds = aug.draw_seed_voxels(cpu, flat)
        removed_card = aug.remove_component_apply(flat.cuda(), seeds.cuda())
        removed_cpu = aug.remove_component_apply(flat, seeds)
        checks["component_removal_equal"] = bool(torch.equal(removed_card.cpu(),
                                                             removed_cpu))
    checks.update(crop=list(onehot.shape[2:]), radii=radius.flatten().tolist(),
                  operations=op.flatten().tolist(),
                  foreground_voxels=float(onehot.sum()),
                  changed_by_morphology=float((on_cpu != onehot.cpu()).sum()),
                  removed_voxels=float((flat - removed_cpu).sum()))
    return ms, list(data.shape), list(seg.shape), checks


def phase_cascade(card):
    """The nnU-Net cascade on phase 14's raw dataset, after phase 19 has
    planned and preprocessed its 3d_fullres with the default planner:
    ``add_lowres_and_cascade`` adds ``3d_lowres`` (spacing doubled, the
    fullres patch and widths) and ``3d_cascade_fullres``; the command line's
    ``preprocess -c 3d_lowres``; ``train <id> 3d_lowres all`` (the default
    trainer, PlainConvUNet, CASCADE_STEPS steps and one validation step),
    whose final validation predicts every training case and writes
    ``predicted_next_stage/3d_cascade_fullres/``; ``train <id>
    3d_cascade_fullres 0`` with the cascade augmentation on the card and its
    final validation on previous-stage input; ``predict`` of the test images
    with 3d_lowres, then with 3d_cascade_fullres on ``-prev_stage_predictions``,
    and ``evaluate_folder`` against the labels. The cascaded stage's
    augmentation is timed apart from the step and its morphology and
    component removal held to the CPU's (``cascade_augmentation``). Returns
    the K1-K4 launches of the phase, which must be none."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.cli.entry_points import main as cli
    from nnuzoo_tpu_torch.planning.plans_editing import add_lowres_and_cascade
    from nnuzoo_tpu_torch.training import trainer_config
    from nnuzoo_tpu_torch.training.trainer import Trainer

    raw = os.path.join(os.environ["nnUNet_raw"], RAW_NAME)
    pp = os.path.join(os.environ["nnUNet_preprocessed"], RAW_NAME)
    res = os.environ["nnUNet_results"]
    plans = add_lowres_and_cascade(RAW_ID)
    t0 = time.perf_counter()
    cli(["preprocess", "-d", str(RAW_ID), "-c", "3d_lowres", "-np", "4"])
    lowres_preprocess_s = time.perf_counter() - t0

    steps = []
    peak = {}
    inner = Trainer.train_step

    def observed_step(self, data, seg):
        torch.cuda.synchronize()
        before = scan_launches()
        t0 = time.perf_counter()
        loss = inner(self, data, seg)
        torch.cuda.synchronize()
        steps.append(dict(seconds=time.perf_counter() - t0, loss=loss.item(),
                          scan_launches=scan_launches() - before,
                          data=list(data.shape), seg=list(seg.shape)))
        peak[self.configuration_name] = torch.cuda.max_memory_allocated()
        return loss

    base = trainer_config.TRAINER_CONFIGS[CNN]
    trainer_config.TRAINER_CONFIGS[CNN] = replace(
        base, num_epochs=1, num_iterations_per_epoch=CASCADE_STEPS,
        num_val_iterations_per_epoch=1)
    Trainer.train_step = observed_step
    reset_scan_launches()
    stages = {}
    try:
        for configuration, fold in (("3d_lowres", "all"),
                                    ("3d_cascade_fullres", "0")):
            steps.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = cli(["train", str(RAW_ID), configuration, fold,
                           "-device", "cuda"])
            torch.cuda.synchronize()
            summary = json.load(open(os.path.join(
                trainer.output_folder, "validation", "summary.json")))
            cm = trainer.configuration_manager
            stages[configuration] = dict(
                fold=fold, patch=list(cm.patch_size), batch=cm.batch_size,
                spacing=list(cm.spacing), input_channels=trainer.num_input_channels,
                parameters=sum(p.numel() for p in trainer.model.parameters()),
                steps=list(steps),
                seconds_per_step_after_first=float(np.mean(
                    [s["seconds"] for s in steps[1:]])),
                peak_memory_bytes_training=peak[configuration],
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                train_and_validation_s=time.perf_counter() - t0,
                validation_cases=trainer.validation_case_times,
                validation_dice=summary["foreground_mean"]["Dice"])
            if configuration == "3d_cascade_fullres":
                aug_ms, data_shape, seg_shape, checks = \
                    cascade_augmentation(trainer)
            model_folder = trainer.output_folder_base
            del trainer
            torch.cuda.empty_cache()
    finally:
        Trainer.train_step = inner
        trainer_config.TRAINER_CONFIGS[CNN] = base
    next_stage = os.path.join(pp, "predicted_next_stage", "3d_cascade_fullres")
    exported = sorted(f for f in os.listdir(next_stage) if f.endswith(".npz"))
    export_s = [c["next_stage_s"] for c in
                stages["3d_lowres"]["validation_cases"].values()]

    predicted = {}
    for configuration, fold, extra in (
            ("3d_lowres", "all", []),
            ("3d_cascade_fullres", "0",
             ["-prev_stage_predictions", os.path.join(res, "cascade_3d_lowres")])):
        out_folder = os.path.join(res, f"cascade_{configuration}")
        t0 = time.perf_counter()
        predictor = cli(["predict", "-i", os.path.join(raw, "imagesTs"),
                         "-o", out_folder, "-d", str(RAW_ID), "-c", configuration,
                         "-f", fold, "-device", "cuda"] + extra)
        torch.cuda.synchronize()
        predicted[configuration] = dict(seconds=time.perf_counter() - t0,
                                        forwards=predictor.forward_count,
                                        cases=predictor.case_times)
        del predictor
        torch.cuda.empty_cache()
    scores = cli(["evaluate_folder", os.path.join(raw, "labelsTs"),
                  os.path.join(res, "cascade_3d_cascade_fullres"),
                  "-djfile", os.path.join(model_folder, "dataset.json"),
                  "-pfile", os.path.join(model_folder, "plans.json"), "-np", "2"])
    launches = scan_launches()
    cascade_step = stages["3d_cascade_fullres"]["seconds_per_step_after_first"]
    emit("cascade", card=card, dataset=RAW_NAME,
         configurations={k: {n: v.get(n) for n in ("spacing", "patch_size",
                                                   "batch_size", "next_stage",
                                                   "previous_stage",
                                                   "inherits_from")}
                         for k, v in plans["configurations"].items()},
         lowres_preprocess_s=lowres_preprocess_s, stages=stages,
         predicted_next_stage_files=len(exported),
         next_stage_export_s_per_case=export_s,
         augmentation_ms=aug_ms, augmentation_batch=[data_shape, seg_shape],
         cascade_augmentation_ms=aug_ms["as_configured"] - aug_ms["no_cascade"],
         augmentation_share_of_step=aug_ms["as_configured"] / 1e3 / cascade_step,
         card_against_cpu=checks, predict=predicted,
         test_cases=len(scores["metric_per_case"]),
         foreground_dice=scores["foreground_mean"]["Dice"],
         dice_per_label={str(k): v["Dice"] for k, v in scores["mean"].items()},
         scan_launches=launches)
    if launches or not (checks["morphology_equal"]
                        and checks["component_removal_equal"]
                        and checks["changed_by_morphology"] > 0):
        raise AssertionError(f"cascade: {launches} scan launches, {checks}")
    if len(exported) != 3 or stages["3d_cascade_fullres"]["input_channels"] != 3:
        raise AssertionError(f"cascade: next-stage files {exported}, {stages}")
    for configuration, stage in stages.items():
        if len(stage["steps"]) != CASCADE_STEPS or not all(
                np.isfinite(s["loss"]) for s in stage["steps"]) or \
                not np.isfinite(stage["validation_dice"]):
            raise AssertionError(f"cascade, {configuration}: {stage}")
    if stages["3d_cascade_fullres"]["steps"][0]["seg"][1] != 2 or \
            len(scores["metric_per_case"]) != 2 or \
            not np.isfinite(scores["foreground_mean"]["Dice"]):
        raise AssertionError(f"cascade: {stages}, {scores['foreground_mean']}")
    return launches


# ----------------------------------------------------------------- translation
def phase_translation(card):
    """The translation target: a seeded preprocessed 2d dataset of float
    targets at phase 5's shapes (``write_dataset``, 2 * image + 10),
    ``target_type: "translation"`` with one regression channel;
    ``nnUNetTrainerM2NetP`` at full width and depth trains on it through
    ``run_training`` (TRAIN_STEPS steps at batch 12 and one validation step,
    80 K1 and 80 K2 launches a step: ``phase_training``); its final
    validation scored with the regression metrics and ``evaluate_folder`` on
    the same folders; then one step at stage layers (1, 1, 1, 1) against
    fp64 on the batches of SHALLOW_SEEDS, held to phase 6's ratio rule (the
    median of the kernel path's gradient error over the fp32 plain path's
    within ``kernel_over_plain``). Returns the K1 and K2 launches of the
    training run."""
    import numpy as np
    from nnuzoo_tpu_torch.cli.entry_points import main as cli
    from nnuzoo_tpu_torch.models.registry import get_model_builder

    trainer, launches, _ = phase_training(False, target_type="translation")
    t0 = time.perf_counter()
    with first_validation_case(trainer):
        metrics = trainer.perform_actual_validation()
    validation_s = time.perf_counter() - t0
    validation = os.path.join(trainer.output_folder, "validation")
    scored = cli(["evaluate_folder", os.path.join(
        trainer.preprocessed_dataset_folder_base, "gt_segmentations"), validation,
        "-djfile", os.path.join(trainer.output_folder_base, "dataset.json"),
        "-pfile", os.path.join(trainer.output_folder_base, "plans.json"),
        "-o", os.path.join(validation, "evaluate_folder.json"), "-np", "2"])

    model = get_model_builder(trainer.trainer_name)(
        trainer.plans_manager, trainer.dataset_json, trainer.configuration_manager,
        trainer.num_input_channels, True, device="cuda", seed=STEP_SEED,
        stage_layers=(1, 1, 1, 1))
    ratios = []
    for seed in SHALLOW_SEEDS:
        readings, reference = step_readings(
            trainer, model, *augmented(trainer, *seeded_batch(trainer, seed)))
        ratios.append(readings["kernel"]["grad_err_norm"]
                      / readings["plain_fp32"]["grad_err_norm"])
        emit("translation_step_agreement", depth="stage_layers_1_1_1_1",
             batch=STEP_BATCH, seed=STEP_SEED, sampler_seed=seed,
             kernel_over_plain=ratios[-1], **reference, **readings)
        if not all(r["finite"] for r in readings.values()):
            raise AssertionError(f"translation step, seed {seed}: {readings}")
    del model
    median = float(np.median(ratios))
    limit = SHALLOW_STEP_LIMITS["kernel_over_plain"]
    emit("translation", card=card, heads=trainer.label_manager.num_segmentation_heads,
         fwd_launches=launches[0], bwd_launches=launches[1],
         validation_s=validation_s, validation_cases=trainer.validation_case_times,
         regression_metrics=metrics["mean"], evaluate_folder=scored["mean"],
         kernel_over_plain=ratios, median_kernel_over_plain=median, limit=limit)
    if not median <= limit:
        raise AssertionError(f"translation step at stage layers (1, 1, 1, 1): "
                             f"median kernel-over-plain {median} over {ratios}")
    if trainer.label_manager.num_segmentation_heads != 1 or \
            not all(np.isfinite(v) for v in metrics["mean"].values()) or \
            scored["mean"] != metrics["mean"]:
        raise AssertionError(f"translation metrics {metrics['mean']}, "
                             f"{scored['mean']}")
    return launches


SWIN_UMAMBA = "nnUNetTrainerSwinUMamba"
SWIN_UMAMBA_D = "nnUNetTrainerSwinUMambaD"
LIGHT_MUNET = "nnUNetTrainerLightMUNet"
LIGHT_SS2D = "nnUNetTrainerLightSS2DMambaUNet"
SEG_MAMBA = "nnUNetTrainerSegMamba"
MAMBA_TRAINERS = (SWIN_UMAMBA, SWIN_UMAMBA_D, LIGHT_MUNET, LIGHT_SS2D, SEG_MAMBA)
# {(L, K*Dh, K): scan calls} of one forward at 256x224 and at zoo_sweep's 3d
# patch 48x192x192, as the CPU tests fix them (tests/test_torch_light_munet.py,
# test_torch_seg_mamba.py, test_torch_swin_umamba.py); a MambaBlock branch
# scans K=1 direction of d_inner channels, an SS2D K=4 of d_inner each
MAMBA_SCANS_2D = {
    SWIN_UMAMBA: {(3584, 768, 4): 2, (896, 1536, 4): 2, (224, 3072, 4): 9,
                  (56, 6144, 4): 2},
    SWIN_UMAMBA_D: {(3584, 768, 4): 3, (896, 1536, 4): 3, (224, 3072, 4): 10,
                    (56, 6144, 4): 2, (14336, 384, 4): 1},
    LIGHT_MUNET: {(57344, 64, 1): 3, (14336, 128, 1): 5, (3584, 256, 1): 5,
                  (896, 512, 1): 8},
    LIGHT_SS2D: {(57344, 256, 4): 3, (14336, 512, 4): 5, (3584, 1024, 4): 5,
                 (896, 2048, 4): 8},
    SEG_MAMBA: {(14336, 96, 1): 6, (3584, 192, 1): 6, (896, 384, 1): 6,
                (224, 768, 1): 6}}
MAMBA_SCANS_3D = {
    LIGHT_MUNET: {(1769472, 64, 1): 3, (221184, 128, 1): 5, (27648, 256, 1): 5,
                  (3456, 512, 1): 8},
    SEG_MAMBA: {(221184, 96, 1): 6, (27648, 192, 1): 6, (3456, 384, 1): 6,
                (432, 768, 1): 6}}
MAMBA_3D_BATCH = 2
# the fp64 step check at full width (phase 16's rule) for these three
MAMBA_STEP_CHECKED = (SEG_MAMBA,)


def mamba_scan_shapes():
    """(L, K*Dh, K, batch, steep) of K1/K2 for the Mamba baselines: every
    (L, K*Dh, K) of their tables that no earlier phase has (M2NetP's K*Dh
    128 and M2Net's 256-1024 at K=4, at their lengths), at batch 12 for the
    2d lengths and 2 for the 3d ones; and steep decay (phase 2's inputs) at
    K=1 with K*Dh 64 and 96 and at K=4 with K*Dh 6144."""
    seen = {(L, KD, K_DIRS) for L, _ in PATH_SHAPES} | \
        {(L, kd, K_DIRS) for L, kd in M2NET_SCANS}
    shapes = []
    for table, batch in ((MAMBA_SCANS_2D, TRAIN_BATCH),
                         (MAMBA_SCANS_3D, MAMBA_3D_BATCH)):
        for scans in table.values():
            for key in scans:
                if key not in seen:
                    seen.add(key)
                    shapes.append(key + (batch, False))
    return shapes + [(3000, 64, 1, TRAIN_BATCH, True),
                     (3000, 96, 1, TRAIN_BATCH, True),
                     (56, 6144, 4, TRAIN_BATCH, True)]


def phase_mamba_scan_kernels(seed=2000, shapes=None, event="mamba_scan_kernel"):
    """K1 (with the chunk carries a backward starts from, and timed also
    without them) and K2 on K1's carries against their plain versions at each
    shape (L, K*Dh, K, batch, steep) of ``shapes`` (those of
    ``mamba_scan_shapes`` when None): y, carries and the four gradients to
    SCAN_TOL / SCAN_BWD_TOL of their max, times and bounds; at TILE_BATCH,
    as serving calls it, K1 alone, timed without the carries. The plain
    versions walk chunks of 256 steps (the plain path's), or of 2048 at
    L > 100,000, where 256-step chunks would take the host minutes of
    launches; a row names its chunk. The lines are ``event`` and its
    ``_bwd_kernel`` twin. Returns the forward and backward rows."""
    import torch
    from nnuzoo_tpu_torch.ops.selective_scan import (
        _pick_chunk, scan_core, scan_core_bwd, scan_core_bwd_plain,
        scan_core_plain)
    fwd_rows, bwd_rows = [], []
    shapes = mamba_scan_shapes() if shapes is None else shapes
    for i, (L, kd, k, b, steep) in enumerate(shapes, start=seed):
        args, dy = scan_inputs(b, L, kd, N_STATE, k, seed=i, steep=steep)
        chunk = 2048 if L > 100_000 else 256
        with torch.inference_mode():
            y, carries = scan_core(*args, return_carries=True)
            want, want_carries = scan_core_plain(
                *args, chunk=_pick_chunk(b, L, kd), return_carries=True)
            torch.cuda.synchronize()
            err, scale = (y - want).abs().max().item(), want.abs().max().item()
            carries_err = (carries - want_carries).abs().max().item()
            carries_scale = want_carries.abs().max().item()
            del want, want_carries
            serving = b == TILE_BATCH
            ms_carries = None if serving else time_ms(
                lambda: scan_core(*args, return_carries=True), reps=10)
            ms = time_ms(lambda: scan_core(*args), reps=10)
            plain_ms = time_ms(lambda: scan_core_plain(*args, chunk=chunk), reps=1,
                               warmup=0)
        bound_ms, bound_by = scan_bound(b, L, kd, N_STATE, k)
        # "ms" is the training step's call (with the carries), as phase 2's
        # rows at the training batch are, or at the serving batch serving's
        row = dict(B=b, L=L, KD=kd, K=k, N=N_STATE, steep=steep, max_abs_err=err,
                   rel_err=err / scale,
                   carries_rel_err=carries_err / max(carries_scale, 1e-30),
                   ms=ms if serving else ms_carries, ms_without_carries=ms,
                   plain_ms=plain_ms, plain_chunk=chunk, bound_ms=bound_ms,
                   bound_by=bound_by)
        emit(event, **row)
        if not (err <= SCAN_TOL * scale
                and carries_err <= SCAN_TOL * carries_scale):
            raise AssertionError(f"scan kernel disagrees at B={b} L={L} KD={kd} "
                                 f"K={k}: y {err} against {scale}, carries "
                                 f"{carries_err} against {carries_scale}")
        fwd_rows.append(row)
        if serving:
            del args, dy, carries
            continue
        carries = carries if carries.shape[1] > 1 else None
        with torch.inference_mode():
            got = scan_core_bwd(*args, dy, carries)
            # the plain version's one call is also its timing
            want, plain_ms = time_once(
                lambda: scan_core_bwd_plain(*args, dy, chunk=chunk))
            errs = {name: ((g - w).abs().max().item(), w.abs().max().item())
                    for name, g, w in zip(("du", "ddelta", "dbc", "dA"), got, want)}
            del got, want
            ms = time_ms(lambda: scan_core_bwd(*args, dy, carries), reps=10)
        bound_ms, bound_by = scan_bwd_bound(b, L, kd, N_STATE, k)
        row = dict(B=b, L=L, KD=kd, K=k, N=N_STATE, steep=steep,
                   max_abs_err=max(e for e, _ in errs.values()),
                   rel_err={n: e / m for n, (e, m) in errs.items()}, ms=ms,
                   plain_ms=plain_ms, plain_chunk=chunk, bound_ms=bound_ms,
                   bound_by=bound_by)
        emit(event.replace("_kernel", "_bwd_kernel"), **row)
        for name, (e, m) in errs.items():
            if not e <= SCAN_BWD_TOL * m:
                raise AssertionError(f"backward scan kernel disagrees at L={L} "
                                     f"KD={kd} K={k}, {name}: {e} > "
                                     f"{SCAN_BWD_TOL} * {m}")
        bwd_rows.append(row)
        del args, dy, carries
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def phase_mamba_blocks():
    """A MambaBlock (bimamba None and "v3" with 64 slices) at SegMamba's
    stage-0 width (d_model 48, 2x14336 tokens) and a LightMUNet MambaLayer
    (32 to 64 channels, 2x256x224, axis order (1, 0)): the kernel path
    against the plain path (autograd through the plain scan), the output to
    SS2D_TOL of its max, the input's and every parameter's gradient to
    SS2D_GRAD_TOL of each one's max."""
    import torch
    from nnuzoo_tpu_torch.models.layers import init_parameters
    from nnuzoo_tpu_torch.models.light_munet import MambaLayer
    from nnuzoo_tpu_torch.models.mamba import MambaBlock
    from nnuzoo_tpu_torch.models.ss2d import set_scan_backend
    g = torch.Generator(device="cuda").manual_seed(5)
    cases = (("MambaBlock", MambaBlock(48), (2, 14336, 48), {}),
             ("MambaBlock_v3", MambaBlock(48, bimamba_type="v3", nslices=64),
              (2, 14336, 48), {}),
             ("MambaLayer", MambaLayer(32, 64), (2, 256, 224, 32),
              {"order": (1, 0)}))
    for name, module, shape, kw in cases:
        init_parameters(module, torch.Generator().manual_seed(6))
        module = module.cuda()
        x = torch.randn(*shape, device="cuda", generator=g).requires_grad_()
        names = ["input"] + [n for n, _ in module.named_parameters()]
        leaves = [x] + list(module.parameters())
        runs = {}
        for backend in (None, "plain"):
            set_scan_backend(module, backend)
            out = module(x, **kw)
            dout = torch.randn(out.shape, device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(7))
            runs[backend] = (out.detach(), torch.autograd.grad(out, leaves, dout))
            torch.cuda.synchronize()
        c = compare(runs[None][0], runs["plain"][0])
        rel = {n: ((a - b).abs().max() / b.abs().max()).item()
               for n, a, b in zip(names, runs[None][1], runs["plain"][1])}
        emit("mamba_block", block=name, shape=list(shape), **kw, **c,
             grad_rel_err=rel)
        bad = {n: e for n, e in rel.items() if not e <= SS2D_GRAD_TOL}
        if not c["max_abs"] <= SS2D_TOL * c["max_ref"] or bad:
            raise AssertionError(f"{name}: kernel path vs plain path {c}, "
                                 f"gradients {bad}")
        del runs, module
        torch.cuda.empty_cache()


def mamba_entry(fwd_rows, bwd_rows, backward, launches_by_path):
    """A kernel's Mamba-baseline key of the kernels line: for each trainer,
    the ms, plain ms and bound of one training step's calls (rows at the
    training batch of each (L, K*Dh, K) weighted by the model's calls; the
    shapes an earlier phase timed, SwinUMambaD's none, come from none here),
    its launches a step, and the launches on each Mamba path."""
    rows = {(r["L"], r["KD"], r["K"], r["B"]): r
            for r in (bwd_rows if backward else fwd_rows) if not r["steep"]}
    per_model = {}
    for dim, table, batch in ((2, MAMBA_SCANS_2D, TRAIN_BATCH),
                              (3, MAMBA_SCANS_3D, MAMBA_3D_BATCH)):
        for trainer, scans in table.items():
            own = {key: n for key, n in scans.items() if key + (batch,) in rows}
            per_model[f"{trainer}_{dim}d"] = dict(
                launches_per_step=sum(scans.values()),
                timed_calls=sum(own.values()),
                **{field: sum(n * rows[key + (batch,)][field]
                              for key, n in own.items())
                   for field in ("ms", "plain_ms", "bound_ms")})
    return {"per": ("one training step of each model: its calls at each "
                    "(L, K*Dh, K) at B=12 (2d) or B=2 (3d) times the row's ms"),
            "per_model": per_model, "launches_by_path": launches_by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "shapes": list(rows.values())}


def kernel_entry(name, source, replaces, launches, rows, path, weight, per,
                 **more):
    """One kernel's line: the per-shape rows, and the times of the rows of
    the training path weighted by the calls of each length in one step."""
    sums = {key: sum(weight[r["L"]] * r[key] for r in path)
            for key in ("ms", "plain_ms", "bound_ms")}
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **sums, "library_ms": None,
            # an exp2 bound is one of operations (at the exp2 units' rate)
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in path)
            else "operations",
            "per": per, **more, "shapes": rows}


def m2net_entry(shared_rows, own_rows, calls, key, per, launches_by_path):
    """A kernel's M2Net rows: the times of one training step (the rows at
    the training batch weighted by M2Net's calls of each shape, ``key`` of a
    row; M2Net's own rows, and M2NetP's where M2Net has none of that shape),
    of one serving forward where the kernel serves, the launches on M2Net's
    paths and the rows of M2Net's own shapes."""
    own = {key(r) for r in own_rows}
    rows = own_rows + [r for r in shared_rows if key(r) not in own]

    def total(batch, field):
        return sum(calls[key(r)] * r[field] for r in rows
                   if r["B"] == batch and key(r) in calls)
    entry = {"per": per, "launches_by_path": launches_by_path,
             **{field: total(TRAIN_BATCH, field)
                for field in ("ms", "plain_ms", "bound_ms")},
             "max_abs_err": max(r["max_abs_err"] for r in own_rows),
             "shapes": own_rows}
    if any(r["B"] == TILE_BATCH for r in rows):
        entry["serving_forward_ms"] = total(TILE_BATCH, "ms")
    return entry


def on_path(rows, weight, batch, **widths):
    """The rows at the main paths' lengths, the given batch and widths."""
    return [r for r in rows if r["L"] in weight and r["B"] == batch
            and all(r[k] == v for k, v in widths.items())]


# ----------------------------------------------------------------- Transformer baselines
# UNETR (ViT-B), SwinTransformerUnet and SwinUNETR: attention in plain PyTorch
# (matmuls and softmax through cuBLAS), convolutions through cuDNN; their
# paths launch none of K1-K4.
UNETR = "nnUNetTrainerUNETR"
SWT = "nnUNetTrainerSwinTransformerUnet"
SWIN_UNETR = "nnUNetTrainerSwUNETR"
TRANSFORMERS = (UNETR, SWT, SWIN_UNETR)
TRANSFORMERS_3D = (UNETR, SWIN_UNETR)
ATTN_TOL = 1e-4          # max abs error / max |out| of one block against fp64
ATTN_GRAD_TOL = 1e-3     # each gradient's max abs error / its max
# one full-width 2d training step (weights from STEP_SEED, batch 12 of
# STEP_SEED's sampler at the patch size, not augmented, DropPath live with the
# same masks) against the same step in fp64: |loss - fp64| / |fp64| and the
# gradient's error norm over the fp64 gradient's norm. The first run on an
# H100 80GB HBM3 at 700 W read, (loss, gradient): UNETR 5.3e-8, 1.22e-4; SwT
# 4.8e-8, 2.4e-6; SwinUNETR 1.21e-7, 1.31e-4. The limits sit about 2.5x
# outside. Zero-padded tokens (the sampler's and the augmentation's fill)
# pass exactly zero through the Swin blocks at initialisation (zero biases),
# and each LayerNorm of a zero token (eps 1e-6) scales its gradient by 1000:
# the Swin models' fp64 gradient norms read 2e34 and 1.6e37 here, and on
# the augmented batch SwinUNETR's overflows fp32 (the JAX package's model
# does the same), so the check takes the batch unaugmented.
TRANSFORMER_STEP_LIMITS = {
    UNETR: {"loss_rel_err": 1.5e-7, "grad_rel_err_norm": 3e-4},
    SWT: {"loss_rel_err": 1.5e-7, "grad_rel_err_norm": 6e-6},
    SWIN_UNETR: {"loss_rel_err": 3e-7, "grad_rel_err_norm": 3e-4},
}


def path_kind(trainer_name):
    if trainer_name in SSND2NET_FAMILY:
        return "ssnd2net"
    return "transformer" if trainer_name in TRANSFORMERS else "cnn"


def timed(label, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, then a ``phase_seconds`` line of its wall
    time."""
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    emit("phase_seconds", of=label, seconds=time.perf_counter() - t0)
    return result


def phase_transformer_blocks():
    """Each attention block at its full-width shape against its own fp64
    twin on the card, the output and the gradient of the input and of every
    parameter: a ViTBlock at UNETR's width (768, 12 heads, 224 tokens,
    batch 12), a shifted SwinBlock at SwT's stage 0 (96 channels, 3 heads,
    64x56 padded to 70x56, batch 12) and a shifted SwinBlockND at 3d
    SwinUNETR's stage 0 (48 channels, 3 heads, 24x96x96 padded to
    28x98x98, batch 2); ms of an fp32 forward and backward, peak memory."""
    import torch
    from nnuzoo_tpu_torch.models.attention import SwinBlock, SwinBlockND, ViTBlock
    from nnuzoo_tpu_torch.models.layers import init_parameters
    g = torch.Generator(device="cuda").manual_seed(8)
    cases = (("ViTBlock", lambda: ViTBlock(768, 12), (TRAIN_BATCH, 224, 768)),
             ("SwinBlock", lambda: SwinBlock(96, 3, (64, 56), 7, 3),
              (TRAIN_BATCH, 64, 56, 96)),
             ("SwinBlockND", lambda: SwinBlockND(48, 3, (24, 96, 96), 7, 3),
              (CNN_3D_BATCH, 24, 96, 96, 48)))
    for name, make, shape in cases:
        module = make()
        init_parameters(module, torch.Generator().manual_seed(9))
        module = module.cuda()
        twin = copy.deepcopy(module).double()
        x = torch.randn(*shape, device="cuda", generator=g)
        dout = torch.randn(*shape, device="cuda", generator=g)
        names = ["input"] + [n for n, _ in module.named_parameters()]

        def run(m, dtype):
            xx = x.to(dtype).requires_grad_()
            out = m(xx)
            return out.detach(), torch.autograd.grad(
                out, [xx] + list(m.parameters()), dout.to(dtype))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: run(module, torch.float32), reps=5)
        peak = torch.cuda.max_memory_allocated()
        got, grads = run(module, torch.float32)
        want, want_grads = run(twin, torch.float64)
        c = compare(got.double(), want)
        rel = {n: ((a.double() - b).abs().max() / b.abs().max()).item()
               for n, a, b in zip(names, grads, want_grads)}
        window = padded = None
        if len(shape) > 3:
            window, _ = module.window_and_shift(shape[1:-1])
            padded = [s + (-s) % w for s, w in zip(shape[1:-1], window)]
        emit("transformer_block", block=name, shape=list(shape), window=window,
             padded=padded, fwd_bwd_ms=ms, peak_memory_bytes=peak,
             fp32_vs_fp64=c, grad_rel_err=rel)
        bad = {n: e for n, e in rel.items() if not e <= ATTN_GRAD_TOL}
        if not c["max_abs"] <= ATTN_TOL * c["max_ref"] or bad:
            raise AssertionError(f"{name} against fp64: {c}, gradients {bad}")
        del module, twin, grads, want_grads
        torch.cuda.empty_cache()


def phase_planned_transformer(card):
    """UNETR through the command line on phase 14's raw dataset and its 2d
    plan (patch 256x224, batch 12): ``train <id> 2d 0 -tr
    nnUNetTrainerUNETR``, one epoch of TRAIN_STEPS steps and one validation
    step, with its final validation; ``predict_from_modelfolder`` on
    ``imagesTs`` and ``evaluate_simple`` against ``labelsTs``. Seconds per
    step, peak memory, Dice. Returns the K1-K4 launches (none)."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.cli.entry_points import main as cli
    from nnuzoo_tpu_torch.training import trainer_config
    from nnuzoo_tpu_torch.training.trainer import Trainer
    from nnuzoo_tpu_torch.utilities.io import load_json

    raw = os.path.join(os.environ["nnUNet_raw"], RAW_NAME)
    steps = []
    inner = Trainer.train_step

    def observed_step(self, data, seg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = inner(self, data, seg)
        torch.cuda.synchronize()
        steps.append(dict(seconds=time.perf_counter() - t0, loss=loss.item()))
        return loss

    base = trainer_config.TRAINER_CONFIGS[UNETR]
    trainer_config.TRAINER_CONFIGS[UNETR] = replace(
        base, num_epochs=1, num_iterations_per_epoch=TRAIN_STEPS,
        num_val_iterations_per_epoch=1)
    Trainer.train_step = observed_step
    reset_scan_launches()
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli(["train", str(RAW_ID), "2d", "0", "-tr", UNETR, "-device", "cuda"])
        torch.cuda.synchronize()
        train_seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        Trainer.train_step = inner
        trainer_config.TRAINER_CONFIGS[UNETR] = base
    model_folder = os.path.join(os.environ["nnUNet_results"], RAW_NAME,
                                f"{UNETR}__nnUNetPlans__2d")
    summary = load_json(os.path.join(model_folder, "fold_0", "validation",
                                     "summary.json"))
    predicted = os.path.join(os.environ["nnUNet_results"], "planned_unetr")
    t0 = time.perf_counter()
    predictor = cli(["predict_from_modelfolder", "-i", os.path.join(raw, "imagesTs"),
                     "-o", predicted, "-m", model_folder, "-f", "0",
                     "-device", "cuda"])
    torch.cuda.synchronize()
    predict_seconds = time.perf_counter() - t0
    scores = cli(["evaluate_simple", os.path.join(raw, "labelsTs"), predicted,
                  "-l", "1", "2", "-o", os.path.join(predicted, "summary.json"),
                  "-np", "2"])
    launches = scan_launches()
    dice, val_dice = scores["foreground_mean"]["Dice"], \
        summary["foreground_mean"]["Dice"]
    emit("planned_transformer", card=card, dataset=RAW_NAME, trainer=UNETR,
         model=type(predictor.model).__name__, steps=steps,
         seconds_per_step_after_first=float(np.mean([s["seconds"]
                                                     for s in steps[1:]])),
         train_and_validation_s=train_seconds, peak_memory_bytes=peak,
         validation_dice=val_dice, predict_s=predict_seconds,
         forwards=predictor.forward_count, foreground_dice=dice,
         dice_per_label={k: v["Dice"] for k, v in scores["mean"].items()},
         scan_launches=launches)
    del predictor
    torch.cuda.empty_cache()
    if len(steps) != TRAIN_STEPS or launches or \
            len(scores["metric_per_case"]) != 2 or \
            not (np.isfinite(dice) and np.isfinite(val_dice)):
        raise AssertionError(f"planned UNETR: steps {steps}, {launches} scan "
                             f"launches, Dice {dice}, validation {val_dice}")
    return launches


# ----------------------------------------------------------------- the LM2Net family
# The X²Net hybrids on mini LightMUNets: LM2Net(P) mix with Mamba (K1/K2),
# LightMamba2Net(P) with Mamba2 on the chunked SSD (matmuls, no scan kernel),
# or on K1/K2 under NNUZOO_SCAN_BACKEND=mamba1.
LM2NET = "nnUNetTrainerLM2Net"
LM2NET_P = "nnUNetTrainerLM2NetP"
LIGHT_M2 = "nnUNetTrainerLightMamba2Net"
LIGHT_M2_P = "nnUNetTrainerLightMamba2NetP"
LM2NET_FAMILY = (LM2NET, LM2NET_P, LIGHT_M2, LIGHT_M2_P)
# {(L, K*Dh, K): scan calls} of one forward at 256x224, as the CPU tests fix
# them on the meta device (tests/test_torch_lm2net.py); on the SSD route
# LightMamba2Net(P) make none
LM2NET_SCANS_2D = {
    LM2NET: {(57344, 32, 1): 2, (57344, 64, 1): 2, (14336, 32, 1): 2,
             (14336, 64, 1): 6, (3584, 32, 1): 2, (3584, 64, 1): 6,
             (3584, 128, 1): 4, (896, 32, 1): 2, (896, 64, 1): 6,
             (896, 128, 1): 4, (896, 256, 1): 4, (224, 32, 1): 2,
             (224, 64, 1): 6, (224, 128, 1): 4, (224, 256, 1): 4, (56, 32, 1): 2,
             (56, 64, 1): 6, (56, 128, 1): 4, (56, 256, 1): 4, (28, 32, 1): 2,
             (28, 64, 1): 6, (28, 128, 1): 4, (28, 256, 1): 4},
    LM2NET_P: {(57344, 64, 1): 4, (14336, 64, 1): 8, (3584, 64, 1): 12,
               (896, 64, 1): 16, (448, 64, 1): 6, (224, 64, 1): 14,
               (112, 64, 1): 4, (56, 64, 1): 12, (28, 64, 1): 12},
    LIGHT_M2: {}, LIGHT_M2_P: {}}
# LightMamba2Net(P) on the mamba1 route: K=1 over d_inner = 2C channels, N=16
LM2NET_MAMBA1_SCANS_2D = {
    LIGHT_M2: {(57344, 32, 1): 4, (14336, 32, 1): 8, (14336, 64, 1): 4,
               (3584, 32, 1): 8, (3584, 64, 1): 8, (3584, 128, 1): 4,
               (896, 32, 1): 8, (896, 64, 1): 8, (896, 128, 1): 8,
               (896, 256, 1): 4, (224, 32, 1): 8, (224, 64, 1): 8,
               (224, 128, 1): 8, (224, 256, 1): 8, (224, 512, 1): 4,
               (112, 512, 1): 2, (56, 32, 1): 8, (56, 64, 1): 8, (56, 128, 1): 8,
               (56, 256, 1): 8, (56, 512, 1): 8, (28, 32, 1): 8, (28, 64, 1): 8,
               (28, 128, 1): 8, (28, 256, 1): 8, (28, 512, 1): 28},
    LIGHT_M2_P: {(57344, 64, 1): 4, (14336, 64, 1): 12, (3584, 64, 1): 20,
                 (896, 64, 1): 28, (224, 64, 1): 36, (112, 64, 1): 2,
                 (56, 64, 1): 40, (28, 64, 1): 60}}
# one Mamba2Block (Mamba2 on SSD) against its fp64 twin: output to 1e-4 of
# its max, each gradient to 1e-3 of its max (PERF.md section 2's block
# limits); the SSD route against the mamba1 route (K1/K2) as the JAX
# package's own test holds them: |a - b| <= 2e-3 + 2e-3 |b|
MAMBA2_ROUTE_TOL = 2e-3
# LightMamba2Net(P) with random weights amplify fp32 rounding through their
# stages (CPU, fp64: a 1e-9 change of the input moves a Mamba2 mini's output
# 20-40 times as much, a Mamba mini's 1.4 times): one tile batch in fp32
# reads 5-6% of the logits' range off fp64 in mean on either route, and
# 0.937 (LightMamba2Net) and 0.993 (LightMamba2NetP) in argmax agreement on
# an H100 80GB HBM3 at 700 W. Their tile batch is held to the ratio rule
# alone, and the mamba1 route's segmentation of phase 4's volume to the SSD
# route's by argmax agreement, which read 0.946 there.
ROUTE_AGREE_MIN = 0.9
MAMBA2_SHAPE = (TRAIN_BATCH, 57344, 32)    # LightMamba2NetP's stage 1
CARD_BYTES = 80 * 2 ** 30


@contextlib.contextmanager
def scan_route(route):
    """``NNUZOO_SCAN_BACKEND`` as a user sets it, for the Mamba2Blocks built
    inside: "mamba1" puts them on K1/K2, "ssd" (unset) on the SSD."""
    before = os.environ.get("NNUZOO_SCAN_BACKEND")
    if route == "mamba1":
        os.environ["NNUZOO_SCAN_BACKEND"] = "mamba1"
    else:
        os.environ.pop("NNUZOO_SCAN_BACKEND", None)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("NNUZOO_SCAN_BACKEND", None)
        else:
            os.environ["NNUZOO_SCAN_BACKEND"] = before


def lm2net_scans(trainer_name):
    """The model's scan table for the route that NNUZOO_SCAN_BACKEND picks."""
    if os.environ.get("NNUZOO_SCAN_BACKEND") == "mamba1" and \
            trainer_name in LM2NET_MAMBA1_SCANS_2D:
        return LM2NET_MAMBA1_SCANS_2D[trainer_name]
    return LM2NET_SCANS_2D[trainer_name]


def lm2net_scan_shapes():
    """(L, K*Dh, K, batch, steep) of K1/K2 for the LM2Net family: each
    (L, K*Dh, K) of its tables (both routes) that no earlier phase has, at
    the training batch with the carries and the backward, and at the serving
    batch without them; and steep decay at K*Dh 32, a width no earlier
    phase has."""
    seen = {(L, KD, K_DIRS) for L, _ in PATH_SHAPES} | \
        {(L, kd, K_DIRS) for L, kd in M2NET_SCANS} | \
        {key for table in (MAMBA_SCANS_2D, MAMBA_SCANS_3D)
         for scans in table.values() for key in scans}
    keys = sorted({key for table in (LM2NET_SCANS_2D, LM2NET_MAMBA1_SCANS_2D)
                   for scans in table.values() for key in scans} - seen,
                  key=lambda k: (-k[0], k[1]))
    return [key + (b, False) for key in keys for b in (TRAIN_BATCH, TILE_BATCH)] \
        + [(3000, 32, 1, TRAIN_BATCH, True)]


_FAMILY_COUNTS = {}


@contextlib.contextmanager
def shallow_minis(family, layers):
    """The X²Net family of the module ``family`` ("lm2net" or "ssnd2net")
    built with its stage minis at ``layers`` levels by the registry inside
    (the bottleneck minis keep theirs)."""
    import importlib
    module = importlib.import_module(f"nnuzoo_tpu_torch.models.{family}")
    before = module._N_LAYERS
    module._N_LAYERS = tuple(layers)
    try:
        yield
    finally:
        module._N_LAYERS = before


def family_counts(model, trainer_name):
    """Per sample: the operations of a forward and of a training step and
    the bytes the forward saves for the backward (``model_counts``' upper
    bound), counted once a model at batch 1 on a copy of it on its own
    device (the meta device's shape functions cost the host tens of seconds
    a model); the three are linear in the batch. The kernels' launch counts
    are left as they were."""
    if trainer_name not in _FAMILY_COUNTS:
        import torch
        from torch.utils.flop_counter import FlopCounterMode
        kernels = scan_kernels()
        launches = [k.launches for k in kernels]
        twin = copy.deepcopy(model).eval()
        device = next(twin.parameters()).device
        x = torch.zeros((1, *PATCH, 1), device=device)
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        with FlopCounterMode(display=False) as forward:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                outputs = twin(x)
        with FlopCounterMode(display=False) as backward:
            sum(o.sum() for o in outputs).backward()
        fwd = forward.get_total_flops()
        _FAMILY_COUNTS[trainer_name] = dict(
            parameters=sum(p.numel() for p in model.parameters()),
            forward_flop=fwd, step_flop=fwd + backward.get_total_flops(),
            saved_bytes=saved[0])
        del twin, outputs
        for k, n in zip(kernels, launches):
            k.launches = n
    return _FAMILY_COUNTS[trainer_name]


def phase_mamba2_block():
    """One Mamba2Block at LightMamba2NetP's stage-1 width (d_model 32, 16
    heads of 4 channels, d_state 16) over L = 57,344 tokens at batch 12:
    the SSD route in fp32 against its fp64 twin (output to SS2D_TOL of its
    max, the input's and every parameter's gradient to SS2D_GRAD_TOL of each
    one's max), the SSD route against the mamba1 route on K1/K2 (output by
    MAMBA2_ROUTE_TOL), the forward and backward ms of each route and the
    peak memory of the SSD route's forward and backward."""
    import torch
    from nnuzoo_tpu_torch.models.layers import init_parameters
    from nnuzoo_tpu_torch.models.light_munet import mamba2_headdim
    from nnuzoo_tpu_torch.models.mamba import Mamba2Block
    from nnuzoo_tpu_torch.ops.selective_scan import scan_core, scan_core_bwd
    B, L, C = MAMBA2_SHAPE
    block = Mamba2Block(C, d_state=16, headdim=mamba2_headdim(C), route="ssd")
    init_parameters(block, torch.Generator().manual_seed(8))
    block = block.cuda()
    x = torch.randn(B, L, C, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    dout = torch.randn(B, L, C, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(10))
    names = ["input"] + [n for n, _ in block.named_parameters()]

    def run(module, xin, grad_out):
        xin = xin.detach().requires_grad_()
        out = module(xin)
        grads = torch.autograd.grad(out, [xin] + list(module.parameters()),
                                    grad_out)
        return out.detach(), grads

    def fwd_bwd_ms(module):
        def once():
            out = module(x.detach().requires_grad_())
            out.backward(dout)
        return time_ms(once, reps=3, warmup=1)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, grads = run(block, x, dout)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    twin = copy.deepcopy(block).double()
    want, want_grads = run(twin, x.double(), dout.double())
    del twin
    c = compare(out.double(), want)
    rel = {n: ((g.double() - w).abs().max() / w.abs().max()).item()
           for n, g, w in zip(names, grads, want_grads)}
    del want_grads
    ssd_ms = fwd_bwd_ms(block)
    mamba1 = copy.deepcopy(block)
    mamba1.route = "mamba1"
    launches = scan_core.launches, scan_core_bwd.launches
    other, other_grads = run(mamba1, x, dout)
    launches = (scan_core.launches - launches[0],
                scan_core_bwd.launches - launches[1])
    route_err = (other - out).abs()
    route_ok = bool((route_err <= MAMBA2_ROUTE_TOL * (1 + out.abs())).all())
    route_rel = {n: ((g - w).abs().max() / w.abs().max()).item()
                 for n, g, w in zip(names, other_grads, grads)}
    mamba1_ms = fwd_bwd_ms(mamba1)
    emit("mamba2_block", shape=[B, L, C], heads=block.nheads,
         headdim=block.headdim, d_state=block.d_state, ssd_vs_fp64=c,
         grad_rel_err=rel, ssd_vs_mamba1_max_abs=route_err.max().item(),
         ssd_vs_mamba1_grad_rel=route_rel, mamba1_launches=list(launches),
         ssd_fwd_bwd_ms=ssd_ms, mamba1_fwd_bwd_ms=mamba1_ms,
         ssd_fwd_bwd_peak_bytes=peak)
    bad = {n: e for n, e in rel.items() if not e <= SS2D_GRAD_TOL}
    if not c["max_abs"] <= SS2D_TOL * c["max_ref"] or bad:
        raise AssertionError(f"Mamba2Block on SSD against fp64: {c}, gradients "
                             f"{bad}")
    if not route_ok or launches != (1, 1):
        raise AssertionError(f"Mamba2Block, SSD against mamba1: max abs "
                             f"{route_err.max().item()}, launches {launches}")
    del block, mamba1, out, other, grads, other_grads
    torch.cuda.empty_cache()


def phase_lm2net(profile):
    """The four names at the 2d plan (256x224, batch 12, phase 5's dataset):
    serving (phase 4's volume and tile batch; the tile readings against
    fp64 by phase 4's limits for LM2Net(P), by the ratio rule alone for
    LightMamba2Net(P)) and training (TRAIN_STEPS steps and a validation
    step), each with TFLOP/s from ``family_counts``; K1/K2 launches a
    forward and a step as the tables say (none for LightMamba2Net(P) on
    SSD), no K3/K4 launch; each training run's peak memory within the card
    without remat; a serving pass of LightMamba2Net on the mamba1 route (K1
    launches as its table says; its segmentation against the SSD route's by
    ROUTE_AGREE_MIN); one full-width step of LM2Net (kernel path and fp32
    plain path) and of LightMamba2Net on SSD against fp64 by phase 16's
    rule. Returns the launches by path, the K3/K4 launches by name and the
    routes' argmax agreement."""
    import numpy as np
    import torch
    from nnuzoo_tpu_torch.ops.cross_scan import cross_scan_bwd, cross_scan_fwd
    launches, cross, segs = {}, {}, {}
    for name in LM2NET_FAMILY:
        got = {}
        before = cross_scan_fwd.launches, cross_scan_bwd.launches
        launches[f"serving_{name}"] = timed(
            f"serving {name}", phase_end_to_end, profile, trainer_name=name,
            result=got,
            tile_check="ratio" if name in (LIGHT_M2, LIGHT_M2_P) else True)
        segs[name] = got["segmentation"]
        torch.cuda.empty_cache()
        trainer, launches[f"training_{name}"], _ = timed(
            f"training {name}", phase_training, profile, trainer_name=name)
        peak = torch.cuda.max_memory_allocated()
        c = family_counts(trainer.model, name)
        emit("lm2net_serving", trainer=name, parameters=c["parameters"],
             seconds_per_volume=got["seconds"], forwards=got["forwards"],
             tile_tflop=TILE_BATCH * c["forward_flop"] / 1e12,
             tflop_per_s=TILE_BATCH * c["forward_flop"] * got["forwards"]
             / got["seconds"] / 1e12,
             peak_memory_bytes=got["peak_memory_bytes"])
        if peak > CARD_BYTES or getattr(trainer.model, "remat", False):
            raise AssertionError(f"{name}: the training run peaked at {peak} "
                                 f"bytes")
        if name in (LM2NET, LIGHT_M2):
            # LightMamba2Net on SSD, its default route: no scan kernel runs,
            # so its one fp32 path is held to fp64; both at minis of two
            # levels (the stage tables and the bottleneck stay)
            with shallow_minis("lm2net", (2, 2, 2, 2)):
                timed(f"step_agreement {name}", phase_full_step_agreement,
                      trainer, same_paths=name == LIGHT_M2,
                      depth="stage_minis_2_2_2_2")
        del trainer
        torch.cuda.empty_cache()
        cross[name] = (cross_scan_fwd.launches - before[0]
                       + cross_scan_bwd.launches - before[1])
    got = {}
    with scan_route("mamba1"):
        launches[f"serving_mamba1_{LIGHT_M2}"] = timed(
            f"serving mamba1 {LIGHT_M2}", phase_end_to_end, profile,
            trainer_name=LIGHT_M2, result=got, tile_check=None)
    agreement = float(np.mean(got["segmentation"] == segs[LIGHT_M2]))
    emit("lm2net_routes", trainer=LIGHT_M2, argmax_agreement=agreement,
         limit=ROUTE_AGREE_MIN)
    if not agreement >= ROUTE_AGREE_MIN:
        raise AssertionError(f"{LIGHT_M2}: the mamba1 route's segmentation "
                             f"agrees with the SSD route's on {agreement}")
    torch.cuda.empty_cache()
    return launches, cross, agreement


def family_entry(tables, own, shared, launches_by_path, per,
                 key=lambda r: (r["L"], r["KD"], r.get("K", K_DIRS))):
    """A kernel's key of the kernels line for an X²Net family: for each
    model of ``tables`` ({label: (batch, {shape: calls})}), the ms, plain ms
    and bound of one training step's calls (the rows at that batch of each
    shape, the family's own ``own`` or an earlier phase's ``shared`` where
    they share one, weighted by the model's calls of that shape), its
    launches a step; the launches on each path of the family."""
    per_model = {}
    for label, (batch, calls) in tables.items():
        rows = {}
        for r in own + shared:
            if not r.get("steep") and r["B"] == batch:
                rows.setdefault(key(r), r)
        per_model[label] = dict(
            launches_per_step=sum(calls.values()),
            **{field: sum(n * rows[k][field] for k, n in calls.items())
               for field in ("ms", "plain_ms", "bound_ms")})
    return {"per": per, "per_model": per_model,
            "launches_by_path": launches_by_path,
            "max_abs_err": max(r["max_abs_err"] for r in own), "shapes": own}


# the LM2Net family's tables for ``family_entry``: LM2Net(P), and
# LightMamba2Net(P) on the mamba1 route, at the training batch
LM2NET_TABLES = {trainer + tag: (TRAIN_BATCH, scans)
                 for tag, table in (("", LM2NET_SCANS_2D),
                                    ("_mamba1", LM2NET_MAMBA1_SCANS_2D))
                 for trainer, scans in table.items() if scans}
LM2NET_PER = ("one training step of each model: its calls at each "
              "(L, K*Dh, K) at B=12 times the row's ms")


# ----------------------------------------------------------------- the SSND2Net family
# The X²Net hybrid on mini N-d cross-scan U-Nets: each mini level mixes with
# SSND, whose default glue scans K = 2*dim directions on K1/K2 and whose
# fused glue makes two G = dim calls of K3/K4 (SSND2NetP only: SSND2Net's
# bottleneck SSNDs, Dh 512 and dt rank 16, are wider than K3/K4 take).
SSND2NET = "nnUNetTrainerSSND2Net"
SSND2NET_P = "nnUNetTrainerSSND2NetP"
SSND2NET_FAMILY = (SSND2NET, SSND2NET_P)
# (name, glue) of every serving path of the family, at 2d and at 3d, and of
# every training path at 2d: SSND2Net's bottleneck SSNDs (Dh 512, dt rank
# 16) are wider than K3/K4 take, so it has no fused path
SSND2NET_PATHS = ((SSND2NET, "default"), (SSND2NET_P, "default"),
                  (SSND2NET_P, "fused"))
# {(L, K*Dh, K): scan calls} of one forward at 256x224 and at zoo_sweep's 3d
# patch 48x192x192, as the CPU tests fix them on the meta device
# (tests/test_torch_ssnd2net.py); 157 SSNDs a forward either way
SSND2NET_SCANS = {
    2: {SSND2NET_P: {(57344, 128, 4): 6, (14336, 128, 4): 12,
                     (3584, 128, 4): 18, (896, 128, 4): 24, (224, 128, 4): 46,
                     (56, 128, 4): 35, (28, 128, 4): 16},
        SSND2NET: {(57344, 128, 4): 6, (14336, 128, 4): 6, (14336, 256, 4): 6,
                   (3584, 128, 4): 6, (3584, 256, 4): 6, (3584, 512, 4): 6,
                   (896, 128, 4): 6, (896, 256, 4): 6, (896, 512, 4): 6,
                   (896, 1024, 4): 6, (224, 128, 4): 6, (224, 256, 4): 6,
                   (224, 512, 4): 6, (224, 1024, 4): 6, (224, 2048, 4): 22,
                   (56, 128, 4): 6, (56, 256, 4): 6, (56, 512, 4): 6,
                   (56, 1024, 4): 6, (56, 2048, 4): 11, (28, 128, 4): 4,
                   (28, 256, 4): 4, (28, 512, 4): 4, (28, 1024, 4): 4}},
    3: {SSND2NET_P: {(1769472, 192, 6): 6, (221184, 192, 6): 12,
                     (27648, 192, 6): 18, (3456, 192, 6): 24, (432, 192, 6): 46,
                     (108, 192, 6): 35, (27, 192, 6): 16},
        SSND2NET: {(1769472, 192, 6): 6, (221184, 192, 6): 6,
                   (221184, 384, 6): 6, (27648, 192, 6): 6, (27648, 384, 6): 6,
                   (27648, 768, 6): 6, (3456, 192, 6): 6, (3456, 384, 6): 6,
                   (3456, 768, 6): 6, (3456, 1536, 6): 6, (432, 192, 6): 6,
                   (432, 384, 6): 6, (432, 768, 6): 6, (432, 1536, 6): 6,
                   (432, 3072, 6): 22, (108, 192, 6): 6, (108, 384, 6): 6,
                   (108, 768, 6): 6, (108, 1536, 6): 6, (108, 3072, 6): 11,
                   (27, 192, 6): 4, (27, 384, 6): 4, (27, 768, 6): 4,
                   (27, 1536, 6): 4}}}
# {(L, G, Dh, R): K3 calls in each orientation} of one forward of SSND2NetP
# on the fused glue: one call an SSND each way, G = dim streams of Dh 32, R 1
SSND2NET_CROSS = {dim: {(L, dim, kd // (2 * dim), 1): n for (L, kd, _), n in
                        SSND2NET_SCANS[dim][SSND2NET_P].items()}
                  for dim in (2, 3)}
# the tile check's rule for each: SSND2NetP with random weights amplifies
# fp32 rounding past phase 4's absolute limits whichever scan runs (one tile
# batch at 2d read 6.9e-3 of the range in mean and 0.972 in argmax on the
# kernel path, 6.8e-3 and 0.972 on the fp32 plain path; 3.6e-2 and 0.79 at
# 3d, on an H100 80GB HBM3 at 700 W), SSND2Net reads 3.1e-4 and 0.998
SSND2NET_TILE_CHECK = {SSND2NET: True, SSND2NET_P: "ratio"}



def ssnd2net_calls(trainer_name, dim, glue="default"):
    """Scan-kernel launches of one forward of the model at full width: K1's
    on the default glue, K3's (two an SSND) on the fused glue."""
    n = sum(SSND2NET_SCANS[dim][trainer_name].values())
    return 2 * n if glue == "fused" else n


def ssnd2net_scan_shapes():
    """(L, K*Dh, K, batch, steep) of K1/K2 for the SSND2Net family: each
    (L, K*Dh, K) of its 2d table that no earlier phase has, at the training
    batch with the carries and the backward and at the serving batch
    without them; each of its 3d table (K=6, new to the kernels) at
    MAMBA_3D_BATCH, the 3d training batch and tile batch both, timed with
    and without the carries; and steep decay at K=6."""
    seen = {(L, KD, K_DIRS) for L, _ in PATH_SHAPES} | \
        {(L, kd, K_DIRS) for L, kd in M2NET_SCANS} | \
        {key for table in (MAMBA_SCANS_2D, MAMBA_SCANS_3D, LM2NET_SCANS_2D,
                           LM2NET_MAMBA1_SCANS_2D)
         for scans in table.values() for key in scans}
    order = lambda k: (-k[0], k[1])
    keys_2d = sorted({k for scans in SSND2NET_SCANS[2].values() for k in scans}
                     - seen, key=order)
    keys_3d = sorted({k for scans in SSND2NET_SCANS[3].values() for k in scans}
                     - seen, key=order)
    return [k + (b, False) for k in keys_2d for b in (TRAIN_BATCH, TILE_BATCH)] \
        + [k + (MAMBA_3D_BATCH, False) for k in keys_3d] \
        + [(3000, 192, 6, TRAIN_BATCH, True)]


def ssnd2net_cross_shapes():
    """(L, G, Dh, R, serving batch, training batch) of K3/K4 for SSND2NetP's
    fused glue: its 2d lengths that phase 9 does not have (TILE_BATCH,
    TRAIN_BATCH), and every 3d length at G=3 (MAMBA_3D_BATCH, the 3d tile
    and training batch)."""
    seen = set(CROSS_SHAPES["M2NetP"])
    return [key + (TILE_BATCH, TRAIN_BATCH) for key in SSND2NET_CROSS[2]
            if key not in seen] + \
        [key + (MAMBA_3D_BATCH, MAMBA_3D_BATCH) for key in SSND2NET_CROSS[3]]


@contextlib.contextmanager
def plain_chunk(chunk):
    """The plain scan and its plain backward walking chunks of ``chunk``
    steps (256 by default) wherever the plain paths call them: at 3d
    lengths, 256-step chunks cost the host a minute of launches a block."""
    import functools
    from nnuzoo_tpu_torch.ops import selective_scan as ops
    saved = ops.scan_core_plain, ops.scan_core_bwd_plain
    ops.scan_core_plain = functools.partial(saved[0], chunk=chunk)
    ops.scan_core_bwd_plain = functools.partial(saved[1], chunk=chunk)
    try:
        yield
    finally:
        ops.scan_core_plain, ops.scan_core_bwd_plain = saved


def phase_ssnd_blocks():
    """One SSND at full width on each glue, the kernel path against the plain
    path: the output to SS2D_TOL of its max, the input's and every
    parameter's gradient to SS2D_GRAD_TOL of each one's max. At 2d d_model
    16 over 2x256x224 (SSND2Net(P)'s stage 1) and d_model 128 over 2x32x28
    (SSND2Net's stage 4, the widest SSND the fused glue takes); at 3d
    d_model 16 over 2x48x192x192 (K=6 on K1/K2, G=3 on K3/K4), where the
    plain path is the plain scan pair (autograd through the plain scan would
    keep every level of 3.5M positions) in chunks of 2048 steps."""
    import torch
    from nnuzoo_tpu_torch.models.layers import init_parameters
    from nnuzoo_tpu_torch.models.ss2d import set_scan_backend, set_ss2d_glue
    from nnuzoo_tpu_torch.models.ssnd import SSND
    cases = [(16, (2, *PATCH), g) for g in ("default", "fused")] + \
        [(128, (2, 32, 28), g) for g in ("default", "fused")] + \
        [(16, (MAMBA_3D_BATCH, *CNN_3D_PATCH), g) for g in ("default", "fused")]
    for i, (width, shape, glue) in enumerate(cases):
        dim = len(shape) - 1
        module = SSND(width, dim)
        init_parameters(module, torch.Generator().manual_seed(20 + i))
        module = module.cuda()
        set_ss2d_glue(module, glue)
        g = torch.Generator(device="cuda").manual_seed(30 + i)
        x = torch.randn(*shape, width, device="cuda",
                        generator=g).requires_grad_()
        names = ["input"] + [n for n, _ in module.named_parameters()]
        leaves = [x] + list(module.parameters())
        runs = {}
        plain = "plain_pair" if dim == 3 else "plain"
        for backend in (None, plain):
            set_scan_backend(module, backend)
            t0 = time.perf_counter()
            with plain_chunk(2048 if dim == 3 else 256):
                out = module(x)
            dout = torch.randn(out.shape, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(40 + i))
            with plain_chunk(2048 if dim == 3 else 256):
                runs[backend] = (out.detach(),
                                 torch.autograd.grad(out, leaves, dout))
            torch.cuda.synchronize()
            runs[backend] += (time.perf_counter() - t0,)
            del out, dout
        c = compare(runs[None][0], runs[plain][0])
        rel = {n: ((a - b).abs().max() / b.abs().max()).item()
               for n, a, b in zip(names, runs[None][1], runs[plain][1])}
        emit("ssnd_block", d_model=width, glue=glue, shape=list(shape) + [width],
             plain=plain, **c, grad_rel_err=rel, kernel_path_s=runs[None][2],
             plain_path_s=runs[plain][2])
        bad = {n: e for n, e in rel.items() if not e <= SS2D_GRAD_TOL}
        if not c["max_abs"] <= SS2D_TOL * c["max_ref"] or bad:
            raise AssertionError(f"SSND d_model {width} {glue} at {shape}: "
                                 f"kernel path vs plain path {c}, gradients {bad}")
        del runs, module, x, leaves
        torch.cuda.empty_cache()


def ssnd2net_counts(model, trainer_name, glue):
    """Per sample at the 3d plan, on a copy of the model on the meta device
    with ``glue`` (the scans by their operators' shape functions): the
    operations of a forward and the bytes it saves for the backward
    (``model_counts``' upper bound). The backward is not run on the meta
    device (its plain scans would walk every chunk on the host). Counted
    once a model and glue."""
    key = (trainer_name, 3, glue)
    if key not in _FAMILY_COUNTS:
        import torch
        from torch.utils.flop_counter import FlopCounterMode
        from nnuzoo_tpu_torch.models.ss2d import set_ss2d_glue
        meta = copy.deepcopy(model).to("meta").train()
        set_ss2d_glue(meta, glue)
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        for m in meta.modules():
            if hasattr(m, "rate"):      # DropPath: no masks on the meta device
                m.rate = 0.0
        with FlopCounterMode(display=False) as forward:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                meta(torch.empty((1, *CNN_3D_PATCH, 1), device="meta",
                                 requires_grad=True))
        _FAMILY_COUNTS[key] = dict(
            parameters=sum(p.numel() for p in model.parameters()),
            forward_flop=forward.get_total_flops(), saved_bytes=saved[0])
    return _FAMILY_COUNTS[key]


def phase_ssnd2net(profile):
    """The two names at the 2d plan (256x224, batch 12, phase 5's dataset),
    on the default glue and SSND2NetP also on the fused glue: serving
    (phase 4's volume and tile batch, the tile against fp64 by phase 4's
    limits) and training (TRAIN_STEPS steps and a validation step, each
    with TFLOP/s from ``family_counts``; peak memory within the card
    without remat); K1/K2 (K3/K4) launches a forward and a step as the
    tables say, none of the other glue's. One full-width step of SSND2NetP
    on the default glue against fp64 by phase 16's rule, and one on the
    fused glue at stage minis of one level. Returns the launches by path."""
    import torch
    launches = {}
    for name, glue in SSND2NET_PATHS:
        got = {}
        launches[f"serving_2d_{glue}_{name}"] = timed(
            f"serving {glue} {name}", phase_end_to_end, profile, glue,
            name, result=got, tile_check=SSND2NET_TILE_CHECK[name])
        torch.cuda.empty_cache()
        trainer, launches[f"training_2d_{glue}_{name}"], _ = timed(
            f"training {glue} {name}", phase_training, profile, glue, name)
        peak = torch.cuda.max_memory_allocated()
        c = family_counts(trainer.model, name)
        emit("ssnd2net_serving", trainer=name, glue=glue, dim=2,
             parameters=c["parameters"], seconds_per_volume=got["seconds"],
             forwards=got["forwards"],
             tile_tflop=TILE_BATCH * c["forward_flop"] / 1e12,
             tflop_per_s=TILE_BATCH * c["forward_flop"] * got["forwards"]
             / got["seconds"] / 1e12,
             peak_memory_bytes=got["peak_memory_bytes"])
        if peak > CARD_BYTES or trainer.model.remat:
            raise AssertionError(f"{name}: the training run peaked at "
                                 f"{peak} bytes")
        if name == SSND2NET_P and glue == "default":
            timed(f"step_agreement {name}", phase_full_step_agreement,
                  trainer)
        elif name == SSND2NET_P:
            with shallow_minis("ssnd2net", (1, 1, 1, 1)):
                timed(f"step_agreement fused {name}",
                      phase_full_step_agreement, trainer, glue=glue,
                      depth="stage_minis_1_1_1_1")
        del trainer
        torch.cuda.empty_cache()
    return launches


def phase_ssnd2net_3d():
    """The two names at zoo_sweep's 3d plan (48x192x192, batch 2, phase
    20-21's dataset): serving one tile of the plan (``ONE_TILE_3D``, mirror
    TTA over 3 axes) on the default glue and SSND2NetP on the fused glue
    too, SSND2NetP's tile on the default glue (K1 at K=6) held against fp64
    by the ratio rule (the plain scans in 2048-step chunks); training
    (TRAIN_STEPS steps and a validation step) of SSND2NetP on the fused glue
    with remat, the one 3d training of the family that fits the card (the
    default glue's steps, with remat or without, do not: ROADMAP), its peak
    memory within the card. Returns the launches by path."""
    import torch
    launches = {}
    for name, glue in SSND2NET_PATHS:
        launches[f"serving_3d_{glue}_{name}"] = timed(
            f"serving_3d {glue} {name}", phase_cnn_serving, name, 3, glue,
            ONE_TILE_3D,
            tile_check="ratio" if (name, glue) == (SSND2NET_P, "default")
            else None)
        torch.cuda.empty_cache()
    trainer, launches[f"training_3d_fused_{SSND2NET_P}"], _ = timed(
        f"training_3d fused {SSND2NET_P}", phase_cnn_training, SSND2NET_P, 3,
        "fused", remat=True)
    peak = torch.cuda.max_memory_allocated()
    emit("ssnd2net_3d_peak", trainer=SSND2NET_P, glue="fused", remat=True,
         peak_bytes=peak, card_bytes=CARD_BYTES)
    if peak > CARD_BYTES:
        raise AssertionError(f"{SSND2NET_P} 3d training peaked at {peak} bytes")
    del trainer
    torch.cuda.empty_cache()
    return launches


def ssnd2net_tables(cross):
    """The SSND2Net family's tables for ``family_entry``: each name at 2d
    (the training batch) and 3d (MAMBA_3D_BATCH), K1/K2's calls of each
    (L, K*Dh, K), or (``cross``) SSND2NetP's fused calls of each (L, G, Dh,
    R) in each orientation."""
    return {f"{trainer}_{dim}d": (batch, calls)
            for dim, batch in ((2, TRAIN_BATCH), (3, MAMBA_3D_BATCH))
            for trainer, calls in (
                {SSND2NET_P: {k + (rev,): n for k, n in SSND2NET_CROSS[dim].items()
                              for rev in (False, True)}} if cross
                else SSND2NET_SCANS[dim]).items()}


SSND2NET_PER = ("one training step of each model: its calls at each shape at "
                "B=12 (2d) or B=2 (3d) times the row's ms (K3/K4: the calls of "
                "each orientation)")


def cross_key(r):
    return r["L"], r["G"], r["Dh"], r["R"], r["reverse"]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import nnuzoo_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from nnuzoo_tpu_torch import _build
    from nnuzoo_tpu_torch.models.ss2d import GLUES
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile = "--profile" in sys.argv[1:]

    LOG.parent.mkdir(exist_ok=True)
    LOG.write_text("")
    card = card_line()
    out(card)
    start = time.perf_counter()

    def elapsed(after):
        emit("elapsed", after=after, seconds=time.perf_counter() - start)

    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(built),
         ptxas={name: ptxas_summary(log) for name, log in built.items()},
         torch=torch.__version__, cuda=torch.version.cuda)

    fwd_rows, bwd_rows = timed("scan_kernels", phase_scan_kernels)
    m2_fwd_rows, m2_bwd_rows = timed("scan_kernels M2Net", phase_scan_kernels,
                                     "M2Net", seed=1000)
    timed("blocks", phase_blocks)
    # the Mamba baselines' scan shapes and blocks
    mamba_fwd_rows, mamba_bwd_rows = timed("mamba_scan_kernels",
                                           phase_mamba_scan_kernels)
    timed("mamba_blocks", phase_mamba_blocks)
    # the LM2Net family's new scan shapes, and one Mamba2Block on each route
    lm2_fwd_rows, lm2_bwd_rows = timed(
        "lm2net_scan_kernels", phase_mamba_scan_kernels, seed=3000,
        shapes=lm2net_scan_shapes(), event="lm2net_scan_kernel")
    timed("mamba2_block", phase_mamba2_block)
    # the SSND2Net family's new K1/K2 shapes (K=6 at 3d), and one SSND on
    # each glue at 2d and 3d
    ssnd_fwd_rows, ssnd_bwd_rows = timed(
        "ssnd2net_scan_kernels", phase_mamba_scan_kernels, seed=4000,
        shapes=ssnd2net_scan_shapes(), event="ssnd2net_scan_kernel")
    timed("ssnd_blocks", phase_ssnd_blocks)
    # the Transformer baselines' attention blocks against fp64
    timed("transformer_blocks", phase_transformer_blocks)
    elapsed("kernels and blocks")
    serving_launches = timed("serving", phase_end_to_end, profile)
    torch.cuda.empty_cache()
    m2 = {"serving": timed("serving M2Net", phase_end_to_end, profile,
                           trainer_name=M2NET)}
    torch.cuda.empty_cache()
    mamba = {}
    for name in MAMBA_TRAINERS:
        mamba[f"serving_2d_{name}"] = timed(f"serving {name}", phase_end_to_end,
                                           profile, trainer_name=name)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["nnUNet_preprocessed"] = os.path.join(tmp, "preprocessed")
        os.environ["nnUNet_results"] = os.path.join(tmp, "results")
        trainer, (fwd_launches, bwd_launches), trained = timed(
            "training", phase_training, profile)
        timed("step_agreement", phase_step_agreement, trainer)
        timed("train_save_predict", phase_train_save_predict, trainer, trained)
        validation_launches, files_launches = timed(
            "files_and_validation", phase_files_and_validation, trainer)
        del trainer, trained
        torch.cuda.empty_cache()
        # M2Net on the same dataset: training, one step against fp64, the
        # fine-tuning trainer from its fold, and a step with remat
        trainer, m2["training"], _ = timed("training M2Net", phase_training,
                                           profile, trainer_name=M2NET)
        m2["finetune"] = timed("finetune", phase_finetune, trainer)
        m2["remat"] = timed("remat", phase_remat, trainer)
        del trainer
        torch.cuda.empty_cache()
        # the Mamba baselines on the same dataset: training, and one step
        # against fp64 for three of them
        for name in MAMBA_TRAINERS:
            trainer, mamba[f"training_2d_{name}"], _ = timed(
                f"training {name}", phase_training, profile, trainer_name=name)
            if name in MAMBA_STEP_CHECKED:
                timed(f"step_agreement {name}", phase_full_step_agreement, trainer)
            del trainer
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    elapsed("serving and training, default glue")

    # the fused cross-scan glue (NNUZOO_SS2D_FUSED=1): K3 and K4
    cross_fwd_rows, cross_bwd_rows = timed("cross_scan_kernels",
                                           phase_cross_scan_kernels)
    m2_cross_fwd_rows, m2_cross_bwd_rows = timed(
        "cross_scan_kernels M2Net", phase_cross_scan_kernels, "M2Net", seed=1100)
    # SSND2NetP's fused shapes: G=3 at 3d, L up to 1,769,472
    ssnd_cross_fwd_rows, ssnd_cross_bwd_rows = timed(
        "cross_scan_kernels SSND2NetP", phase_cross_scan_kernels, "SSND2NetP",
        seed=4100, shapes=ssnd2net_cross_shapes())
    timed("fused_ss2d", phase_fused_ss2d)
    # M2NetP's fused paths at stage layers (1, 1, 1, 1): they repeat the
    # default glue's at full depth, and K3/K4 are held to their plain
    # versions at every full-depth shape above
    with shallow_m2netp():
        fused_serving_launches = timed("serving fused", phase_end_to_end,
                                       profile, "fused")
    torch.cuda.empty_cache()
    m2["serving_fused"] = timed("serving fused M2Net", phase_end_to_end, profile,
                                "fused", M2NET)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["nnUNet_preprocessed"] = os.path.join(tmp, "preprocessed")
        os.environ["nnUNet_results"] = os.path.join(tmp, "results")
        with shallow_m2netp():
            trainer, (k3_launches, k4_launches), _ = timed(
                "training fused", phase_training, profile, "fused")
            timed("step_agreement fused", phase_step_agreement, trainer, "fused")
            fused_validation_launches, fused_files_launches = timed(
                "files_and_validation fused", phase_files_and_validation, trainer,
                "fused")
        del trainer
        torch.cuda.empty_cache()
        trainer, m2["training_fused"], _ = timed(
            "training fused M2Net", phase_training, profile, "fused", M2NET)
        m2["remat_fused"] = timed("remat fused", phase_remat, trainer, "fused")
        del trainer
    torch.cuda.empty_cache()
    elapsed("fused glue")

    # from a raw dataset: the port's planning and preprocessing, then
    # training, the final validation, prediction and the score, default glue
    with tempfile.TemporaryDirectory() as tmp:
        for var in ("nnUNet_raw", "nnUNet_preprocessed", "nnUNet_results"):
            os.environ[var] = os.path.join(tmp, var)
            os.makedirs(os.environ[var])
        planned_fwd_launches, planned_bwd_launches = timed(
            "planned_dataset", phase_planned_dataset, card)
        torch.cuda.empty_cache()
        # UNETR through the command line on the same 2d plan
        transformer = {"planned_2d": timed("planned_transformer",
                                           phase_planned_transformer, card)}
        torch.cuda.empty_cache()
        # the same raw dataset at 3d: PlainConvUNet and ResidualEncoderUNet
        cnn = {"planned_3d": timed("planned_3d", phase_planned_3d, card)}
        torch.cuda.empty_cache()
        # and the cascade on its 3d_fullres plan: 3d_lowres, the next-stage
        # export, 3d_cascade_fullres with the cascade augmentation
        cnn["cascade"] = timed("cascade", phase_cascade, card)
    torch.cuda.empty_cache()
    elapsed("raw dataset, 3d planning and cascade")

    # the translation target: M2NetP at full width on float targets
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["nnUNet_preprocessed"] = os.path.join(tmp, "preprocessed")
        os.environ["nnUNet_results"] = os.path.join(tmp, "results")
        # M2NetP at stage layers (1, 1, 1, 1): phase 5 trains it at full depth
        with shallow_m2netp():
            translation_launches = timed("translation", phase_translation, card)
    torch.cuda.empty_cache()
    elapsed("translation")

    # the nnU-Net CNN baselines at full width, whose paths launch no scan
    # kernel: 3d_fullres serving, training, one step against fp64 and the
    # final validation; 2d PlainConvUNet, U2NetP and U2Net serving and training
    cnn["serving_3d"] = timed("serving_3d cnn", phase_cnn_serving, CNN, 3)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["nnUNet_preprocessed"] = os.path.join(tmp, "preprocessed")
        os.environ["nnUNet_results"] = os.path.join(tmp, "results")
        trainer, cnn["training_3d"], batch = timed("training_3d cnn",
                                                   phase_cnn_training, CNN, 3)
        cnn["validation_3d"] = timed("validation_3d cnn", phase_cnn_validation,
                                     trainer)
        timed("step_agreement_3d cnn", phase_cnn_step_agreement, trainer)
        emit("cnn_profile", trainer=CNN, dim=3, **timed(
            "profile_3d cnn", profile_cnn_step, trainer, *batch))
        del trainer, batch
        torch.cuda.empty_cache()
        for name in (CNN,) + U2NETS:
            cnn[f"serving_2d_{name}"] = timed(f"serving_2d {name}",
                                               phase_cnn_serving, name, 2)
            trainer, cnn[f"training_2d_{name}"], _ = timed(
                f"training_2d {name}", phase_cnn_training, name, 2)
            del trainer
            torch.cuda.empty_cache()
        # LightMUNet and SegMamba at 3d_fullres on the same plan and dataset
        for name in MAMBA_SCANS_3D:
            mamba[f"serving_3d_{name}"] = timed(f"serving_3d {name}",
                                                 phase_cnn_serving, name, 3,
                                                 volume_shape=ONE_TILE_3D)
            torch.cuda.empty_cache()
            trainer, mamba[f"training_3d_{name}"], _ = timed(
                f"training_3d {name}", phase_cnn_training, name, 3)
            del trainer
            torch.cuda.empty_cache()
        elapsed("CNN and Mamba baselines")
        # the Transformer baselines: serving, training and one step against
        # fp64 at 2d, then UNETR and SwinUNETR at 3d_fullres
        for name in TRANSFORMERS:
            transformer[f"serving_2d_{name}"] = timed(
                f"serving_2d {name}", phase_cnn_serving, name, 2)
            trainer, transformer[f"training_2d_{name}"], _ = timed(
                f"training_2d {name}", phase_cnn_training, name, 2)
            timed(f"step_agreement {name}", phase_cnn_step_agreement, trainer,
                  TRANSFORMER_STEP_LIMITS[name], augment=False)
            del trainer
            torch.cuda.empty_cache()
        for name in TRANSFORMERS_3D:
            transformer[f"serving_3d_{name}"] = timed(
                f"serving_3d {name}", phase_cnn_serving, name, 3)
            torch.cuda.empty_cache()
            trainer, transformer[f"training_3d_{name}"], _ = timed(
                f"training_3d {name}", phase_cnn_training, name, 3)
            del trainer
            torch.cuda.empty_cache()
        elapsed("Transformer baselines")
        # the SSND2Net family at 3d on the same plan and dataset
        ssnd = timed("ssnd2net_3d", phase_ssnd2net_3d)
        torch.cuda.empty_cache()
        elapsed("SSND2Net family at 3d")

    # the LM2Net family at 2d: serving, training, the mamba1 route and two
    # steps against fp64
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["nnUNet_preprocessed"] = os.path.join(tmp, "preprocessed")
        os.environ["nnUNet_results"] = os.path.join(tmp, "results")
        reset_scan_launches()   # phase_lm2net counts K3/K4 from here
        lm2, lm2_cross, route_agreement = phase_lm2net(profile)
    torch.cuda.empty_cache()
    elapsed("LM2Net family")

    # the SSND2Net family at 2d: serving and training on each glue, and a
    # step of SSND2NetP on each glue against fp64
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["nnUNet_preprocessed"] = os.path.join(tmp, "preprocessed")
        os.environ["nnUNet_results"] = os.path.join(tmp, "results")
        ssnd.update(timed("ssnd2net_2d", phase_ssnd2net, profile))
    torch.cuda.empty_cache()
    elapsed("SSND2Net family at 2d")
    # K1/K2 on the default glue's paths, K3/K4 on the fused glue's: the
    # forward kernel's launches of each serving and training path, the
    # backward kernel's of each training path
    ssnd_by = {glue: {k: v for k, v in ssnd.items() if f"_{glue}_" in k}
               for glue in GLUES}
    ssnd_fwd = {g: {k: v[0] if isinstance(v, tuple) else v
                    for k, v in paths.items()} for g, paths in ssnd_by.items()}
    ssnd_bwd = {g: {k: v[1] for k, v in paths.items() if isinstance(v, tuple)}
                for g, paths in ssnd_by.items()}
    ssnd_shared_fwd = fwd_rows + m2_fwd_rows + mamba_fwd_rows + lm2_fwd_rows
    ssnd_shared_bwd = bwd_rows + m2_bwd_rows + mamba_bwd_rows + lm2_bwd_rows

    # one training step's scan work: the per-shape numbers at the training
    # batch weighted by the calls of each shape
    weight = dict(PATH_SHAPES)
    per = (f"one training step: {SCANS_PER_FORWARD} launches at B={TRAIN_BATCH}; "
           f"'launches' counts the training run ({TRAIN_STEPS} steps and one "
           f"validation step)")
    fused_per = (f"one training step with the fused glue: {FUSED_PER_FORWARD} "
                 f"launches at B={TRAIN_BATCH}, {SCANS_PER_FORWARD} in each "
                 f"orientation; 'launches' counts the fused training run "
                 f"({TRAIN_STEPS} steps and one validation step) of M2NetP at "
                 f"stage layers (1, 1, 1, 1)")
    cross = dict(G=CROSS_G, Dh=CROSS_DH, R=CROSS_R)
    m2_per = (f"M2Net: one training step, {SCANS_PER_FORWARD} launches at "
              f"B={TRAIN_BATCH} over its (L, K*Dh) pairs (K3/K4: (L, Dh, R) in "
              f"each orientation), the pairs M2NetP shares from its rows")
    kernels = [
        kernel_entry("selective_scan_fwd",
                     "nnuzoo_tpu_torch/csrc/selective_scan_fwd.cu",
                     "nnuzoo_tpu/ops/selective_scan.py:868", fwd_launches,
                     fwd_rows, on_path(fwd_rows, weight, TRAIN_BATCH, KD=KD),
                     weight, per,
                     launches_by_path={"serving": serving_launches,
                                       "training": fwd_launches,
                                       "validation": validation_launches,
                                       "predict_from_files": files_launches,
                                       "planned_dataset": planned_fwd_launches,
                                       "translation": translation_launches[0]},
                     serving_forward_ms=sum(
                         weight[r["L"]] * r["ms"]
                         for r in on_path(fwd_rows, weight, TILE_BATCH, KD=KD)),
                     m2net=m2net_entry(
                         fwd_rows, m2_fwd_rows, M2NET_SCANS,
                         lambda r: (r["L"], r["KD"]), m2_per,
                         {"serving": m2["serving"], "training": m2["training"][0],
                          "finetune": m2["finetune"][0], "remat": m2["remat"]}),
                     mamba=mamba_entry(
                         mamba_fwd_rows, mamba_bwd_rows, False,
                         {k: v[0] if isinstance(v, tuple) else v
                          for k, v in mamba.items()}),
                     lm2net=family_entry(
                         LM2NET_TABLES, lm2_fwd_rows, mamba_fwd_rows,
                         {k: v[0] if isinstance(v, tuple) else v
                          for k, v in lm2.items()}, LM2NET_PER),
                     ssnd2net=family_entry(
                         ssnd2net_tables(False), ssnd_fwd_rows, ssnd_shared_fwd,
                         ssnd_fwd["default"], SSND2NET_PER)),
        kernel_entry("selective_scan_bwd",
                     "nnuzoo_tpu_torch/csrc/selective_scan_bwd.cu",
                     "nnuzoo_tpu/ops/selective_scan.py:915", bwd_launches,
                     bwd_rows, on_path(bwd_rows, weight, TRAIN_BATCH, KD=KD),
                     weight, per,
                     launches_by_path={"training": bwd_launches,
                                       "planned_dataset": planned_bwd_launches,
                                       "translation": translation_launches[1]},
                     m2net=m2net_entry(
                         bwd_rows, m2_bwd_rows, M2NET_SCANS,
                         lambda r: (r["L"], r["KD"]), m2_per,
                         {"training": m2["training"][1],
                          "finetune": m2["finetune"][1]}),
                     mamba=mamba_entry(
                         mamba_fwd_rows, mamba_bwd_rows, True,
                         {k: v[1] for k, v in mamba.items()
                          if isinstance(v, tuple)}),
                     lm2net=family_entry(
                         LM2NET_TABLES, lm2_bwd_rows, mamba_bwd_rows,
                         {k: v[1] for k, v in lm2.items()
                          if isinstance(v, tuple)}, LM2NET_PER),
                     ssnd2net=family_entry(
                         ssnd2net_tables(False), ssnd_bwd_rows, ssnd_shared_bwd,
                         ssnd_bwd["default"], SSND2NET_PER)),
        kernel_entry("cross_scan_fwd",
                     "nnuzoo_tpu_torch/csrc/cross_scan_fwd.cu",
                     "nnuzoo_tpu/ops/cross_scan.py:313", k3_launches,
                     cross_fwd_rows,
                     on_path(cross_fwd_rows, weight, TRAIN_BATCH, **cross),
                     weight, fused_per,
                     launches_by_path={"serving_fused": fused_serving_launches,
                                       "training_fused": k3_launches,
                                       "validation_fused": fused_validation_launches,
                                       "predict_from_files_fused":
                                           fused_files_launches},
                     serving_forward_ms=sum(
                         weight[r["L"]] * r["ms"] for r in
                         on_path(cross_fwd_rows, weight, TILE_BATCH, **cross)),
                     m2net=m2net_entry(
                         cross_fwd_rows, m2_cross_fwd_rows,
                         M2NET_CROSS, lambda r: (r["L"], r["Dh"], r["R"]), m2_per,
                         {"serving_fused": m2["serving_fused"],
                          "training_fused": m2["training_fused"][0],
                          "remat_fused": m2["remat_fused"]}),
                     ssnd2net=family_entry(
                         ssnd2net_tables(True), ssnd_cross_fwd_rows,
                         cross_fwd_rows, ssnd_fwd["fused"], SSND2NET_PER,
                         key=cross_key)),
        kernel_entry("cross_scan_bwd",
                     "nnuzoo_tpu_torch/csrc/cross_scan_bwd.cu",
                     "nnuzoo_tpu/ops/cross_scan.py:346", k4_launches,
                     cross_bwd_rows,
                     on_path(cross_bwd_rows, weight, TRAIN_BATCH, **cross),
                     weight, fused_per,
                     launches_by_path={"training_fused": k4_launches},
                     m2net=m2net_entry(
                         cross_bwd_rows, m2_cross_bwd_rows,
                         M2NET_CROSS, lambda r: (r["L"], r["Dh"], r["R"]), m2_per,
                         {"training_fused": m2["training_fused"][1]}),
                     ssnd2net=family_entry(
                         ssnd2net_tables(True), ssnd_cross_bwd_rows,
                         cross_bwd_rows, ssnd_bwd["fused"], SSND2NET_PER,
                         key=cross_key)),
    ]
    for entry in kernels:
        # K1-K4 together on each path of the CNN and Transformer baselines:
        # none
        entry["launches_on_cnn_paths"] = cnn
        entry["launches_on_transformer_paths"] = transformer
    for entry in kernels[2:]:
        # K3 and K4 together on each path of the LM2Net family: none
        entry["launches_on_lm2net_paths"] = lm2_cross
    if any(lm2_cross.values()):
        raise AssertionError(f"K3/K4 launched on the LM2Net paths: {lm2_cross}")
    # LightMamba2Net(P) on the SSD route launch no scan kernel
    ssd_paths = {k: v for k, v in lm2.items()
                 if k.endswith((LIGHT_M2, LIGHT_M2_P)) and "mamba1" not in k}
    if any(n for v in ssd_paths.values()
           for n in (v if isinstance(v, tuple) else (v,))):
        raise AssertionError(f"scan kernels launched on the SSD route: {ssd_paths}")
    if any(cnn.values()):
        raise AssertionError(f"scan kernels launched on the CNN paths: {cnn}")
    # every SSND2Net path ran and launched its glue's kernels (and, by the
    # checks of its phase, none of the other glue's): K3/K4 at G=3 on the 3d
    # fused training
    ssnd_paths = {f"{kind}_{dim}d_{glue}_{name}" for kind in ("serving", "training")
                  for dim in (2, 3) for name, glue in SSND2NET_PATHS
                  if kind == "serving" or dim == 2} | \
        {f"training_3d_fused_{SSND2NET_P}"}
    ssnd_counts = [n for v in ssnd.values()
                   for n in (v if isinstance(v, tuple) else (v,))]
    if set(ssnd) != ssnd_paths or min(ssnd_counts) <= 0 or \
            not all(isinstance(ssnd[k], tuple) for k in ssnd if "training" in k):
        raise AssertionError(f"an SSND2Net path did not run or launched no "
                             f"kernel of its glue: {ssnd}")
    if any(transformer.values()):
        raise AssertionError(f"scan kernels launched on the Transformer paths: "
                             f"{transformer}")
    if min(serving_launches, fwd_launches, bwd_launches, validation_launches,
           files_launches, fused_serving_launches, k3_launches, k4_launches,
           fused_validation_launches, fused_files_launches,
           planned_fwd_launches, planned_bwd_launches, *translation_launches,
           m2["serving"],
           *m2["training"], *m2["finetune"], m2["remat"], m2["serving_fused"],
           *m2["training_fused"], m2["remat_fused"],
           *(n for v in mamba.values()
             for n in (v if isinstance(v, tuple) else (v,))),
           *(n for k, v in lm2.items() if k not in ssd_paths
             for n in (v if isinstance(v, tuple) else (v,)))) <= 0:
        raise AssertionError("a kernel of the main paths was never launched")
    out(json.dumps({"kernels": kernels}))

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                           "msgpack", "nnuzoo_tpu"))
    if leaked:
        raise AssertionError(f"JAX-side modules imported: {leaked}")
    out(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
