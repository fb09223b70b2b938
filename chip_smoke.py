#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (cobevt_tpu_torch) on one GPU.

  python3 chip_smoke.py [--out results.json]

Phases, all under main(); any failure raises and the process exits
non-zero without printing the final line:

  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: compiles K1 and K8 (csrc/window_attention.cu), K2
     (csrc/fused_cross_attention.cu), K3 (csrc/conv3x3.cu), K4
     (csrc/fused_swap_fusion.cu), K5 (csrc/window_attention_bwd.cu), K6
     (csrc/fused_swap_fusion_streaming.cu) and K7 with the int8 chain's conv
     (csrc/conv3x3_int8.cu), K11 and K12 (csrc/ffd_fused.cu), K9 and K10
     (csrc/bn_stats.cu), and the bare TMA + wgmma tile
     (csrc/hopper_tile.cu) with nvcc for sm_90a from the checkout's
     sources, one nvcc process each, all started together (every source
     includes the shared csrc/hopper.cuh or mma.cuh), and beside them the
     host box library (csrc/box_ops.cpp, g++, utils/native_ops.py); the
     Triton route of K9 and K10 (ops/bn_stats.py, shapes the CUDA kernel
     does not take) compiles at its first launch in phase 3;
  3. kernels vs plain: first the bare TMA + wgmma tile of each product form
     that K1, K3, K8, K11 and K12 use against torch.matmul in f32 (and the
     8-bit forms against the integer product); then every
     kernel against its plain PyTorch version on
     the card at every shape of the CorpBEVT serving forward and train step
     (5 agents x 4 cameras x 512^2, BEV 256^2) and of the cooperative LiDAR
     forward (fused map 5 x 96 x 176 x 256: K6, and K1 at the 264 windows
     x 8 heads of its stock path), K7 at the two trunk shapes of the int8
     serving mode and the int8 chain's conv at layer1 (both must EQUAL their
     plain versions: equal integers, the same unfused f32 epilogue), K9 and
     K10 at the four shapes of tools/micro_bn_stats.py (the route that
     ran, which must be csrc/bn_stats.cu; a second call equal bit for
     bit; on the card alone the kernel, the Triton route on the same
     inputs in turns and the library's torch.batch_norm_stats and
     torch.batch_norm_backward_reduce, and at corp_layer2, whose inputs fit
     L2, both once more with L2 flushed before each call), K5 also at the
     LiDAR train step's shape (264 windows x 8 heads, mask), K11 and K12 at
     the LiDAR fusion token count (84480 x 256, hidden 512) and at a shape
     whose rows do not divide a tile, in f32 and bf16, timed with
     CUDA events, each beside its bound (the larger of its bytes over 3.35
     TB/s and its operations over 989 TFLOP/s, or 1,979 TOP/s for int8
     products) and, where one PyTorch call computes the same function, that
     call's time; K3 also alone (``launch_ms``: the kernel without its
     wrapper, the weight packed once as a block's cache packs it) and with a
     weight packed at every call (``unpacked_ms``), with the operand bytes
     its wgmma tiles fetch from L2; K5 (bf16) both fed by the row
     statistics K1 writes in a train step and alone, a second call equal bit
     for bit (dbias included: bf16 sums its windows in a launch of its own,
     per-chunk partials added in a fixed order,
     ops/window_attention.py:dbias_plan), and K5,
     K2, K6, K11 and K12 with each launch timed on the card alone
     (``launch_device_ms``), K5's SDPA yardstick on the card alone too; K11
     and K12 with their route (ops/ffd_fused.py:kernel_path) and, on the
     card alone, the kernel and the library chain (autograd's forward +
     backward less its forward for K12); K7's cuDNN and K8's SDPA yardsticks
     on the card alone; K7 with its scale path (one absmax
     into a zeroed slot), alone on a slot, and both on the card alone, with
     the slot its epilogue folds held to the plain fold of its output, the
     absmax kernel (``int8_absmax``) against its plain version, and the
     8-bit wgmma tiles (A from shared memory, and from registers as K7
     and the chain's conv load it) against the integer product; K4 on the
     card alone as it runs and by launch kind with its launches one after
     the other, at four cases (one with a dead agent between live ones),
     and the chain's conv and cuDNN's bf16 conv on the card alone, at the
     layer1 cases and a height its strips do not divide; since the
     SinBEVT slice also K1 at the stock shapes of a nuScenes frame (Tq 600,
     100 and 625: ragged query windows; a bit-for-bit repeat) and K2 at its
     six nuScenes branches (route, launches one by one, a bit-for-bit
     repeat), since the SinBEVT training slice K5 at the four shapes of a
     nuScenes train step (B 8: Tq 600, 100 and 625, each with its launches a
     step; K1's output at those windows, with and without the statistics,
     against its plain forward, whose output feeds the plain backward) and
     K2's six branches at B 8 too (the train step under
     COBEVT_FUSED_XATTN_TRAIN=1), and K1, K2 and K3 at one SinBEVT-OPV2V
     vehicle's shapes (K1's FAX and self-attention windows at G / 5, K2's
     six branches at B 1, K3 on 4 camera images; each with a bit-for-bit
     repeat) (``--kernels K5,K2``, ``--kernels tiles,K6,K7`` or ``--kernels
     K4,S8`` runs only such rows and stops without the final line;
     ``--kernels K9`` the K9 and K10 rows, ``A7`` the absmax rows);
  4. slice, the serving default (COBEVT_FUSED_XATTN and
     COBEVT_FUSED_FUSION unset): full-width CorpBEVT (ResNet-34, seeded
     random weights) in bf16 serves synthetic requests with mixed
     live-agent counts through the staged runner; the launch counters show
     every frame ran 1 K1, 6 x 4 K2, 20 K3 and 14 K4 launches; one frame is
     checked against the plain path in f32 (argmax IoU >= 0.99 on
     dynamic_seg);
  5. stock path (both switches "0"): a shorter run with 13 K1 and 20 K3
     launches per frame, and the argmax IoU of its bf16 output against the
     fused path's on one frame;
  6. train: a few optimizer steps of full-width CorpBEVT in bf16 (f32
     master parameters) on the seeded synthetic batch, through the code of
     cobevt_tpu_torch/tools/benchmark.py: every step runs 13 K1 and 12 K5
     launches and none of K2, K3, K4, with finite loss and gradient norm;
     then the gradient gate of tools/validate_kernels.py (K1 + K5 against
     COBEVT_FLASH_BWD=0, same dropout seed), and one training forward and
     backward with COBEVT_FUSED_XATTN_TRAIN=1: 24 K2 launches, loss and
     gradient norm within 1% of the switch-off run;
  7. K8: the head-major entry point, forward and gradients, at the
     self-attention and the fusion shape;
  8. LiDAR: full-width PointPillar + FuseBEVT (5 agents x 8000 pillars x 32
     points, 352 x 192 grid, fused map 96 x 176 x 256, seeded random
     weights) in bf16 answers requests with 5, 3, 1, 4, 2 live agents on
     the default path (K6, as under force-stream: 4 K6 calls a frame, no
     K1) and on the stock modules (COBEVT_FUSED_FUSION=0: 4 K1, no K6); K6
     against the stock modules and bf16 against the f32 plain path within
     the budget of tools/validate_kernels.py; two forwards of one request
     agree bit for bit;
  9. int8 serving (COBEVT_INT8=1 on the fused path): full-width CorpBEVT in
     bf16 answers requests with 5, 3, 1, 4, 2 live agents; every frame runs
     14 K7, 2 absmax, 6 K3 and 6 launches of the int8 chain's conv (layer1
     int8-resident) beside 1 K1, 24 K2 and 14 K4, and one 5-agent frame
     makes no more device operations (torch.profiler) than the same frame
     in bf16; then the int8 gate of
     tools/validate_kernels.py against the stock bf16 path (relative drift,
     argmax IoU >= 0.99, clipped share <= 0.01 over 3 blocks), and one frame
     with COBEVT_INT8_RESIDENT=0 (14 K7, 6 K3, no chain conv);
 10. tools/micro_bn_stats.py at its four full shapes (K9, K10), every
     call on csrc/bn_stats.cu and none on the Triton route;
 11. LiDAR train: a few optimizer steps of full-width PointPillar + FuseBEVT
     in bf16 (f32 master parameters) on the detection loss, through the code
     of tools/benchmark.py: every step runs 4 K1 and 4 K5 launches and no
     K6, with finite loss and gradient norm; then the LiDAR gradient gate of
     tools/validate_kernels.py with its f32 gradient-truth check;
 12. tools/micro_ffd_fused.py at the full shape in bf16 (K11, K12): the
     parity figures against the erf oracle and the fused and autograd times;
 13. SinBEVT: the nuScenes flagship (cvt_pyramid_axial_nuscenes_vehicle:
     EfficientNet-b4, 6 cameras x 224 x 480, BEV 200^2, bev + center,
     seeded random weights) in bf16 answers 5 frames on the serving default
     (24 K2 launches a frame, no K1) and 2 on the stock path
     (COBEVT_FUSED_XATTN=0: 6 K1, no K2); one frame against the f32 plain
     path and the stock frame against the default one (relative drift
     within tools/validate_kernels.py's budget, sign-of-logit IoU on bev
     >= 0.99, and about the reference's median); each FAX stage's device
     time on both paths; the frame through tools/benchmark.py --model
     sinbevt with --profile_steps 2 on both paths; the forward gate at
     seeds 0-4, and at seed 0 with each of its planted faults in one K2
     or K1 call (it must fail on a dropped head; a wrong softmax scale,
     which random weights hide, is read); then SinBEVT-OPV2V (corpbevt.yaml
     width, one vehicle x 4 cameras x 512^2) answers 3 frames on each path
     (24 K2 + 1 K1 + 20 K3, or 7 K1 + 20 K3, a frame) within the drift
     budget of the f32 plain path, and its benchmark row.  ``--sinbevt``
     runs this phase alone after the build (and the rows of ``--kernels``)
     and stops without the final line;
 14. SinBEVT train: the nuScenes flagship's train step at B 8 (8 distinct
     seeded samples) on its experiment's recipe (visibility-masked focal +
     0.1 x center loss, one-cycle AdamW, clip 5.0) through
     tools/benchmark.py, 1 warmup, 3 timed and 2 profiled steps: 6 K1 and 6
     K5 launches a step (K5 at the ragged windows of 600, 100 and 625
     queries), no backward on the composite, finite loss and gradient norm;
     one step under COBEVT_FUSED_XATTN_TRAIN=1 (24 K2 launches, and 6 K1 and
     6 K5 in the composite's backward); the fused-xattn gate of
     tools/validate_kernels.py (that step against the default step at B 8,
     both bf16, seeds 0-4: scalars, each parameter's gradient and the
     train forward's outputs within budgets of their own, which a dropped K2
     head at stage 2 must fail at every seed); the
     SinBEVT gradient gate of tools/validate_kernels.py at seeds 0-4 and
     with each of its planted K5 faults (it must fail on both); then
     SinBEVT-OPV2V's train step on the OPV2V recipe (1 + 2 steps: 7 K1, 6 K5
     and one composite backward, the self-attention's, a step).
     ``--sinbevt_train`` runs this phase alone after the build and stops
     without the final line;
 15. camera entry points: a synthetic OPV2V fixture written through
     data/image_io.py (1 scenario x 5 CAVs x 4 timestamps to train on, 3
     CAVs x 2 to validate; 512^2 camera PNGs, 256^2 labels, JSON-text
     YAML), then tools/train_camera.main on the full-width corpbevt.yaml
     hypes of tools/export_config.py with --half (4 steps at batch 1, 2 of
     them traced with torch.profiler, one validation pass, one save): each
     step 13 K1 + 12 K5 + 1 composite backward, each validation frame 1
     K1 + 24 K2 + 20 K3 + 14 K4; the saved checkpoint restored into a fresh
     state bit for bit, with save and restore times; then
     tools/inference_camera.main from the checkpoint (its IoU equal to the
     trainer's) and tools/serve_camera.main --model_dir over the
     validation folder (argmax IoU >= 0.99 against inference_camera, the
     p50 a request).  ``--train_camera`` runs this phase alone after the
     build and stops without the final line.
 16. nuScenes entry points: PIL's and cv2's presence on the host; a
     synthetic scene set written by data/nuscenes_labelgen.py through
     tools/bench_input.py's fixture writer (2 scenes x 8 samples, 6 camera
     PNGs at 1600 x 900 from 12 files, 200^2 bit-packed labels, visibility
     and aux); decode + resize ms of one camera PNG with filter 0, the
     adaptive filters and Paeth on every row; tools/train_nuscenes.main at
     the default experiment (EfficientNet-b4, 6 x 224 x 480, B 8) with
     --half, 4 steps and a checkpoint every 2 (the loader crosses an
     epoch), each step 6 K1 + 6 K5 and no composite backward, each IoU-pass
     frame 24 K2, with host, loader-wait and CUDA-event times, and the
     device busy time of step 3 traced alone; the step-4 checkpoint
     restored into a fresh state bit for bit (save and restore times); the
     same command to 5 steps, which resumes from step 4 at the one-cycle
     schedule's lr; finite IoUs; tools/view_data.py panels the codec
     decodes; tools/bench_input.py on both tracks with the adaptive PNG
     filters (2 OPV2V and 8 nuScenes samples, 2 workers; the f32, u8 and
     u8+cache pipelines of each) against the device busy rates of this
     phase and of phase 15.  ``--train_nuscenes`` runs this
     phase alone after the build and stops without the final line.
 17. LiDAR data to AP: a synthetic OPV2V LiDAR scenario written by
     tools/lidar_fixture.py (5 CAVs x 4 timestamps, 24 vehicles, ~120,000
     returns a cloud from a 64-beam spinning sensor, one cloud in ASCII);
     load_pcd and voxelize_points timed a cloud (with each CAV's voxels
     before the cut at 8000) and generate_label a sample; OPV2VLidarDataset
     at the LiDAR map's full width (+-70.4 x +-38.4 m, 8000 pillars x 32
     points) through data/loader.py's 2 workers: 4 eval frames in bf16 on
     the default dispatch (K6 x 4 each, outputs finite at (1, 96, 176, 2)
     and (1, 96, 176, 14)), then 5 bf16 train steps on f32 masters with
     PointPillarLoss on the augmented train split (K1 x 4 + K5 x 4 each,
     across an epoch boundary), with loader waits and CUDA-event times,
     one eval frame and one train step traced alone (torch.profiler: device
     busy ms and idle share), and the time close() takes to stop the train
     loader's abandoned iteration (it reads the batches in flight); the
     ideal-map gate (each sample's targets decoded and NMS'd must give AP
     1.0 at IoU 0.5 and 0.7 against its ground truth, and the anchor round
     trip must hold; swapped x/y deltas and a one-cell shift must fail it);
     one decode of the model's own eval maps (candidates over the score
     threshold, boxes kept, ms); every box call of the phase on the native
     route.  ``--lidar_data`` runs this phase alone after the build and
     stops without the final line.
 18. camera model zoo: each of the six OPV2V graphs (cvt, cvt_att_fuse,
     cvt_swap_fuse, cvt_fcooper, cvt_v2vnet, cvt_disconet) built through
     tools/export_config.export_preset -> configs/hypes.build_from_hypes at
     its preset's width (ResNet-34, 4 cameras x 512^2, dense CVT at 32^2,
     BEV 256^2; 3 of 5 agents live, turned and shifted, cameras a quarter
     turn apart), seeded, on the bf16 compute twin with its kernels (K3 x
     20 a frame, K4 x 14 for the swap fusion) against the f32 plain forward
     of its weights: the largest logit deviation within ZOO_BUDGET of the
     largest logit and ZOO_WITNESS_RATIO times the bf16 plain forward's,
     a gate each graph must fail again with one K3 residual skipped (and,
     for the swap fusion, one K4 head dropped); the argmax IoUs and the IoU
     about the reference's median margin read beside it, with host ms, the
     device ms of a frame traced alone and peak memory;
     tools/train_camera.main on a phase-15-style fixture with the
     cvt_swap_fuse hypes (2 bf16 steps at batch 1: K1 x 6 + K5 x 6 each;
     a validation frame; the checkpoint restored bit for bit), then
     tools/serve_camera.main from that checkpoint under --bucketing staged
     (the sliced BucketedRunner) and off (FullRunner), the served sliced
     frames held by the same gate, and the same faults, to that runner
     over the served weights in f32 on the plain versions (beside it the
     unrounded master's run); tools/train_nuscenes.main
     --experiment cvt_nuscenes_vehicle (1 bf16 step at B 8 on 2 scenes x 4
     samples, finite losses and IoUs, the step-1 checkpoint restored bit
     for bit).  ``--zoo`` runs this phase alone after the build and stops
     without the final line; ``--zoo_seed`` draws its weights, frames and
     fixtures from another seed.  A failing gate raises once the phase has
     printed every reading.
 19. the LiDAR zoo: SECOND + swap fusion from a tools/lidar_fixture.py
     scenario (5 CAVs x 2 timestamps), its hypes (yaml_parser
     load_second_params) through configs/hypes.load_hypes and
     models/lidar/second_models.second_config_from_hypes at the JAX
     SecondConfig's geometry (0.1 m voxels, grid 1408 x 800 x 40, BEV
     backbone 128 / 256 upsampled to 512 channels, window 4, 16 heads of
     32, mlp 256, depth 1), max_voxels set to the most occupied voxels of
     any cloud (all kept), 5 points a voxel, OPV2VLidarDataset through
     data/loader.py's 2 workers: 4 bf16 eval frames (each sample at 5 and
     at 3 live agents; K6 x 2 each, the dispatch's choice printed), each
     held to the same weights in f32 on the plain versions within
     tools/validate_kernels.py's BUDGET_FORWARD beside the bf16 plain
     witness, and again with a K6 head dropped, which must fail; 2 bf16
     train steps on f32 masters with PointPillarLoss on the dataset's
     labels (K1 x 2 + K5 x 2 each, peak memory) and the LiDAR gradient
     gate (K1 + K5 against COBEVT_FLASH_BWD=0 at TRAIN_BUDGETS
     ["pointpillar"]); AttBEVBackbone at PointPillarConfig's widths on the
     same scenario's pillar BEV (5 agents, 3 live; compression 0 and 1):
     bf16 against f32 plain and a padded agent that must not move the
     output; ResNetEncoderConcat (ResNet-34, 5 agents x 4 cameras x 512^2,
     FPN off and at 256) and ResNetEncoderSingle (id_pick 1): K3 x 20 a
     frame, the zoo gate of phase 18 against f32 plain and a K3 residual
     skipped that it must fail; HGTCavAttention at V2X-ViT's widths on the
     (1, 5, 96, 176, 256) map (3 live agents of mixed types), bf16 against
     f32 plain; each with device ms of a frame traced alone and peak
     memory.  ``--lidar_zoo`` runs this phase alone after the build and
     stops without the final line.  A failing gate raises once the phase
     has printed every reading.  Phase 3's K6 rows hold SECOND's map
     (1, 5, 100, 176, 512) too (bf16 takes K6's D 512 wgmma route,
     ops/fused_swap_fusion.py:wide_plan).
 20. serving export and data parallelism: (a) full-width CorpBEVT (bf16,
     the serving default), the same model under COBEVT_INT8=1, and the
     nuScenes flagship (cvt_pyramid_axial_nuscenes_vehicle, 6 x 224 x 480)
     each exported through tools/export_serving.py (torch.export, every
     eval kernel a cobevt:: custom op), saved to a .pt2, loaded and run on
     the card by tools/validate_kernels.py:validate_export: the outputs
     within 0.01 of the live frame's largest (the int8 frame bit for bit),
     the program's launch counts equal to the live frame's, one cobevt::
     node per op call of the live frame, a batch of other shapes refused,
     the export seconds, the .pt2 bytes and both frames' ms (CUDA events);
     the dispatcher's host cost on a served frame, each op call through
     its cobevt:: op or straight to its CUDA implementation, in turns:
     each call's CPU time under torch.profiler on both sides, and the
     frame's host ms; torch.library.opcheck of every op on the card; (b)
     two ranks of this script on the one card in a gloo group (NCCL takes
     one rank a device), each one train step of full-width CorpBEVT with
     every dropout off (K1 x 13 + K5 x 13) on its sample of a global batch
     of 2, in bf16 and on an f32 compute twin of the f32 masters (TF32
     off; the twin's branch of the step, as bf16 takes it), against one
     process's step on the global batch: the loss within 1e-3 relative,
     both ranks' parameters and BatchNorm statistics bit-equal, the f32
     twin's gradients within the camera gradient gate's budgets; the bf16
     gradients' drift is reported beside that of one process's step on the
     batch in the other sample order, not gated; beside them an NCCL
     group of one rank (torchrun's variables) through
     maybe_initialize_distributed, its steps and one all-reduce.
     ``--export_dist`` runs this phase alone after the build and stops
     without the final line;
 21. the ("data", "model") mesh of parallel/mesh.py: two ranks of this
     script on the one card in a gloo group, each case against one process
     on the same global batch from the same dropout generator seed, with
     every dropout on (the preset's 0.1), full-width CorpBEVT: (a) mesh
     2 x 1, data parallel, 5 agents, a sample a rank; (b) mesh 1 x 2,
     tensor parallel (train/step.py:place_state), 5 agents, one sample;
     (c) mesh 1 x 2, the agent axis (cooperative_batch_sharding, two of 4
     agents a rank, tensor-parallel weights); each in f32 on an f32 twin
     (TF32 off; gated: the loss within 1e-3 relative, the gradients at the
     camera gate's budgets, every parameter and BatchNorm statistic within
     its per-tensor budget, the ranks bit-equal, each rank's launches equal
     to one process's) and in bf16 (reported); each step's collectives by
     mesh axis with their bytes, its ms and peak memory, and its mask
     draws' ms against the same shapes drawn locally; (d)
     StagedBucketedRunner over mesh 2 x 1, 2 frames, one a rank, against
     the padded single-process forward: in f32 (TF32 off) within 0.01 of
     the largest logit, in bf16 reported beside one process's spread
     between a frame served alone and in the batch of 2.
     ``--mesh`` runs this phase alone after the build and stops without
     the final line;
 22. measurement: five paths at full width through tools/benchmark.py
     (the 5-agent CorpBEVT eval frame and train step, its COBEVT_INT8=1
     frame, the SinBEVT-nuScenes frame, the PointPillar frame; bf16, the
     serving default), each a row whose last warmup call is counted at the
     dispatcher (utils/flops.py:costs: FLOPs, int8 products, logical bytes,
     the work of each cobevt:: op) with mfu, hbm_util and GB/s beside the
     card's name and power limit, and whose 2 traced calls are written by
     --profile_dir; the same call counted on the plain versions
     (forced_impl("torch")) must count the same FLOPs, every kernel
     launched in the counted call must add work, mfu must be set and at
     most MEASURE_MFU_MAX, and tools/parse_trace.py on the trace must give
     a kernel table with a row of every op that ran and a device total
     within MEASURE_TRACE_TOL of timing.device_profile's, and module keys
     that are attribute paths (hbm_util above 1 is reported with its
     flag).  ``--measure`` runs this phase alone after the build and stops
     without the final line.

Every bound of phase 3 comes from the work formulas of
cobevt_tpu_torch/utils/flops.py, the same ones each cobevt:: op registers
for the counts of phase 22.

K2's phase-3 rows (CorpBEVT, SinBEVT-OPV2V, SinBEVT-nuScenes) draw 20
inputs a bf16 row (the first from the shared generator, the rest from K2's
own) and hold every draw to compare_k2 (|kernel - plain| <= 0.02 + 0.02 *
max(|plain|, k2_scale: the magnitude of the terms added at the skip and the
MLP residual, through the post-LN's |gamma| / std)); a dropped head must
fail it.

The last stdout lines are the kernels JSON line, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

# per-frame shapes of the CorpBEVT serving forward at 5 live agents, and
# the fusion attention of the stock LiDAR path
# (name, G, Tq, Tk, bias, mask, weight, launches per CorpBEVT frame on the
# stock path, on the fused path, heads, launches per stock LiDAR frame);
# head dim 32
K1_CASES = [
    ("fax_local_stage0", 320, 1024, 256, False, False, False, 1, 0, 4, 0),
    ("fax_grid_stage0", 320, 256, 256, False, False, False, 1, 0, 4, 0),
    ("fax_stage1", 80, 256, 256, False, False, False, 2, 0, 4, 0),
    ("fax_stage2", 5, 1024, 1024, False, False, False, 2, 0, 4, 0),
    ("fax_self_attn", 5, 1024, 1024, True, False, False, 1, 1, 4, 0),
    ("fusion", 16, 320, 320, True, True, False, 6, 0, 4, 0),
    # the 264 windows of the 96 x 176 LiDAR map, 8 heads: K6's oracle
    ("lidar_fusion", 264, 320, 320, True, True, False, 0, 0, 8, 4),
    # off the serving path: the other operand combinations
    ("fusion_mask_only", 16, 320, 320, False, True, False, 0, 0, 4, 0),
    ("fusion_weight_only", 16, 320, 320, False, False, True, 0, 0, 4, 0),
    ("self_attn_dropout", 5, 1024, 1024, True, False, True, 0, 0, 4, 0),
    ("fusion_fully_masked_window", 16, 320, 320, True, True, False, 0, 0, 4,
     0),
    ("lidar_fusion_fully_masked_window", 264, 320, 320, True, True, False,
     0, 0, 8, 0),
]
# K1 at the shapes of one vehicle's SinBEVT-OPV2V frame (4 cameras at
# corpbevt.yaml width): CorpBEVT's FAX and self-attention cases at G / 5.
# The fields of K1_CASES, then the calls per SinBEVT frame of each path
K1_SINBEVT_CASES = [
    (f"sinbevt_{c[0]}", c[1] // 5, *c[2:7], 0, 0, c[9], 0,
     {"per_sinbevt_opv2v_frame": c[8],
      "per_sinbevt_opv2v_frame_stock": c[7]})
    for c in K1_CASES[:5]]
# K1 at the stock path's shapes of a SinBEVT-nuScenes frame (B 1, 6 cameras,
# EfficientNet-b4 at 224 x 480, BEV 200^2): the fields of K1_CASES, then the
# calls per nuScenes stock frame.  Stage 0's local branch packs the 6
# cameras' 10 x 10 query windows (600 rows), its grid branch and stage 1 one
# window of 100, stage 2 one of 25 x 25 = 625; the keys are 6 cameras'
# 6 x 12 or 14 x 30 windows.  100 and 625 are the ragged query windows K1
# takes since the nuScenes slice.
K1_NUSC_CASES = [
    ("nusc_local_stage0", 100, 600, 432, False, False, False, 0, 0, 1, 0,
     {"per_nuscenes_frame_stock": 1}),
    ("nusc_grid_stage0", 100, 100, 432, False, False, False, 0, 0, 1, 0,
     {"per_nuscenes_frame_stock": 1}),
    ("nusc_stage1", 25, 100, 432, False, False, False, 0, 0, 2, 0,
     {"per_nuscenes_frame_stock": 2}),
    ("nusc_stage2", 1, 625, 2520, False, False, False, 0, 0, 4, 0,
     {"per_nuscenes_frame_stock": 2}),
]
# heads of the K5 and K8 cases (K1's come with each case), and the head dim
K1_HEADS, K1_HEAD_DIM = 4, 32
# K5: the backward of every weight-free K1 call of a train step (name, G,
# Tq, Tk, bias, mask, calls per step); the 13th attention of a step, the
# self-attention with its dropout weight, takes the composite backward
K5_CASES = [
    ("fax_local_stage0", 320, 1024, 256, False, False, 1),
    ("fax_grid_stage0", 320, 256, 256, False, False, 1),
    ("fax_stage1", 80, 256, 256, False, False, 2),
    ("fax_stage2", 5, 1024, 1024, False, False, 2),
    ("fusion", 16, 320, 320, True, True, 6),
    # off the train step: dropout-free self-attention and the other operand
    # combinations
    ("fax_self_attn_no_dropout", 5, 1024, 1024, True, False, 0),
    ("fusion_bias_only", 16, 320, 320, True, False, 0),
    ("fusion_mask_only", 16, 320, 320, False, True, 0),
    ("fusion_fully_masked_window", 16, 320, 320, True, True, 0),
    # the LiDAR train step: the four fusion sublayers' 264 windows, 8 heads
    # (an eighth field: the heads; a ninth: calls per LiDAR train step)
    ("lidar_fusion", 264, 320, 320, True, True, 0, 8, 4),
]
# K5 at the nuScenes train step's shapes (B 8, the stock FAX modules over K1:
# K1_NUSC_CASES at eight samples): stage 0's local branch (6 cameras' 10 x 10
# query windows, 600 rows), its grid branch and stage 1 (100 rows), stage 2
# (one window of 625 rows a sample); the ragged query windows K5 takes since
# the nuScenes training slice.  The fields of K5_CASES, then the calls per
# nuScenes train step
K5_NUSC_B = 8
K5_NUSC_CASES = [
    (c[0], c[1] * K5_NUSC_B, *c[2:6], 0, c[9], 0,
     {"per_nuscenes_train_step": c[11]["per_nuscenes_frame_stock"]})
    for c in K1_NUSC_CASES]
# K8: head-major attention (name, G, Tq, Tk, bias, mask)
K8_CASES = [
    ("fax_self_attn", 5, 1024, 1024, True, False),
    ("fax_local_stage0", 320, 1024, 256, False, False),
    ("fusion", 16, 320, 320, True, True),
]
# (name, N, H, W, C=O, residual, launches per frame); N = 5 agents x 4 cams
K3_CASES = [
    ("layer2", 20, 64, 64, 128, False, 3),
    ("layer2_residual", 20, 64, 64, 128, True, 3),
    ("layer3", 20, 32, 32, 256, False, 5),
    ("layer3_residual", 20, 32, 32, 256, True, 5),
    ("layer4", 20, 16, 16, 512, False, 2),
    ("layer4_residual", 20, 16, 16, 512, True, 2),
]
# K3 at one vehicle's 4 camera images (SinBEVT-OPV2V); an eighth field, the
# launches per SinBEVT-OPV2V frame
K3_SINBEVT_CASES = [(f"sinbevt_{c[0]}", 4, *c[2:6], 0, c[6])
                    for c in K3_CASES]
# launches of each wgmma K3 case that must equal its first result bit for bit
K3_REPEATS = 20
# K2 rows: fresh input draws a row in each dtype, every one of which must
# pass compare_k2
K2_DRAWS = {"float32": 1, "bfloat16": 20}
# K2: the six FAX cross-view branches of a 5-agent frame (B = 5 agents,
# n = 4 cameras, D = C = 128, 4 heads); each is one call of 4 launches
# (name, BEV H=W, keys h=w, q_win, k_win, embed, post_ln, grid keys)
K2_CASES = [
    ("stage0_local", 128, 64, 16, 8, True, False, False),
    ("stage0_grid", 128, 64, 16, 8, False, True, True),
    ("stage1_local", 64, 32, 16, 8, False, False, False),
    ("stage1_grid", 64, 32, 16, 8, False, True, True),
    ("stage2_local", 32, 16, 32, 16, False, False, False),
    ("stage2_grid", 32, 16, 32, 16, False, True, True),
]
K2_B, K2_CAMS, K2_DIM, K2_HEADS = 5, 4, 128, 4
# the maps of one SinBEVT-OPV2V frame: the same branches at one vehicle
K2_SINBEVT_B = 1
# K2 at the six branches of a SinBEVT-nuScenes frame (B 1, 6 cameras, keys
# padded to window multiples; head dim 32, MLP hidden 2 D): (name, BEV H=W,
# keys (h, w), q_win, k_win, D = C, heads, embed, post_ln, grid keys).  Stage
# 0's local branch carries 6 query segments; every stage takes the wgmma
# route in bf16 (ops/fused_cross_attention.py:kernel_path): stages 0 and 1
# at D 32 / 64, stage 2 at D 128 (one window of 625 queries over 2,520
# keys).
K2_NUSC_CASES = [
    ("nusc_stage0_local", 100, (60, 120), (10, 10), (6, 12), 32, 1, True,
     False, False),
    ("nusc_stage0_grid", 100, (60, 120), (10, 10), (6, 12), 32, 1, False,
     True, True),
    ("nusc_stage1_local", 50, (30, 60), (10, 10), (6, 12), 64, 2, False,
     False, False),
    ("nusc_stage1_grid", 50, (30, 60), (10, 10), (6, 12), 64, 2, False,
     True, True),
    ("nusc_stage2_local", 25, (14, 30), (25, 25), (14, 30), 128, 4, False,
     False, False),
    ("nusc_stage2_grid", 25, (14, 30), (25, 25), (14, 30), 128, 4, False,
     True, True),
]
# batches of the K2 nuScenes rows: a serving frame (B 1) and the train
# step under COBEVT_FUSED_XATTN_TRAIN=1 (B 8, one call a step each)
K2_NUSC_BATCHES, K2_NUSC_CAMS = (1, 8), 6
# launches a kernel must repeat bit for bit at the SinBEVT shapes
NUSC_REPEATS = 5
# K4: the FuseBEVT encoder at CorpBEVT (B 1, L 5 = max_cav, 32^2, D 128,
# window 8, 4 heads, depth 3, mlp 256); (name, mask, mean_over_valid,
# calls per frame)
K4_CASES = [
    ("encoder_masked", True, False, 1),
    ("encoder_mean_over_valid", True, True, 0),
    ("encoder_unmasked", False, False, 0),
    # agent 2 of 5 dead (agent_mask 0, every key of it masked) between live
    # ones, pooled over the live agents
    ("encoder_dead_agent", True, True, 0),
]
# K6: the streaming FuseBEVT sublayers, one call = depth x 2 sublayers + the
# head.  (name, (B, L, H, W, D, window, heads, depth, mlp), mask,
# mean_over_valid, calls per LiDAR frame); the first is the cooperative
# LiDAR map, the small ones are the shapes of the CPU tests (D 128: one
# 128-channel head group on the TPU, D 256: two)
K6_LIDAR = (1, 5, 96, 176, 256, 8, 8, 2, 512)
# SECOND + swap fusion (phase 19): the (1, 5, 100, 176, 512) map of its BEV
# backbone, window 4, 16 heads of 32, mlp 256, depth 1 (2 K6 calls a frame,
# SECOND_PER_FRAME); bf16 at D 512 takes K6's D 512 wgmma route
# (ops/fused_swap_fusion.py:stream_kernel_path, wide_plan)
K6_SECOND = (1, 5, 100, 176, 512, 4, 16, 1, 256)
K6_CASES = [
    ("lidar_masked", K6_LIDAR, "random", False, 1),
    ("second_d512_masked", K6_SECOND, "random", False, 0),
    ("lidar_mean_over_valid", K6_LIDAR, "random", True, 0),
    ("lidar_fully_masked_window", K6_LIDAR, "fully_masked", False, 0),
    ("small_d128", (1, 3, 16, 16, 128, 8, 4, 2, 256), "random", False, 0),
    ("small_d256", (1, 3, 16, 16, 256, 8, 8, 2, 512), "random", True, 0),
]
# K7 at the two shapes the int8 mode sends it (name, N, H, W, C=O, residual,
# launches per frame): conv1 of a block has no residual, conv2 has one
K7_CASES = [
    ("layer3", 20, 32, 32, 256, False, 5),
    ("layer3_residual", 20, 32, 32, 256, True, 5),
    ("layer4", 20, 16, 16, 512, False, 2),
    ("layer4_residual", 20, 16, 16, 512, True, 2),
]
# the absmax kernel that scales a stage's first K7: the inputs of layer3's and
# layer4's first stride-1 blocks (name, shape, launches per frame)
A7_CASES = [
    ("layer3_input", (20, 32, 32, 256), 1),
    ("layer4_input", (20, 16, 16, 512), 1),
]
# the int8 chain's conv over layer1 (20 x 128 x 128 x 64): (name, (N, H, W,
# C), residual, exit, launches per frame); a block's conv1 requantizes,
# conv2 adds the s8 residual and requantizes, the last block's conv2 casts
# to the model's dtype.  "tail": 45 rows, which the strip plan of 132 SMs
# cuts into strips of 4 and a last strip of 1, at a width of 96
S8_SHAPE = (20, 128, 128, 64)
S8_CASES = [
    ("layer1_conv1", S8_SHAPE, False, False, 3),
    ("layer1_conv2", S8_SHAPE, True, False, 2),
    ("layer1_conv2_exit", S8_SHAPE, True, True, 1),
    ("tail_conv2", (20, 45, 96, 64), True, False, 0),
]
# K11, K12: (name, N, D, M, calls of the micro protocol's one pass): the
# LiDAR fusion token count of tools/micro_ffd_fused.py, and a shape whose rows
# divide neither kernel's row tile (16, 64)
FFD_CASES = [
    ("lidar_tokens", 84480, 256, 512, 1),
    ("row_tail", 1000, 128, 256, 0),
]
# K9, K10: the (rows, channels) of tools/micro_bn_stats.py
BN_TOL = 1e-4     # of the largest sum: f32 sums in another order
# kernel vs plain version: |kernel - plain| <= atol + rtol * |plain|.
# f32: sums in another order (and __expf in K1).  bf16: both round an f32
# result to bf16 once, so they differ by about one bf16 ulp (2^-8 rel).
# K4 in bf16 rounds its residual state after each of 6 sublayers (K6 after
# each of 4), and a one-ulp flip at |x| ~ 4 (0.03) carries on: 5e-2 abs.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
K4_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}
# K5: dq, dk, dv and dbias are sums of up to 1024 terms, so the tolerance is
# a share of the plain result's largest value: f32 1e-4 (sums in another
# order; dbias sums the windows through per-chunk partials), bf16 2e-2
# (the kernel takes the row maximum per head, the plain version over all
# heads as the TPU body does, so the exp rounds to bf16 elsewhere: one bf16
# ulp on a weight, summed with random signs).
K5_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the card's L2 (the bounds' peaks: utils/flops.py)
L2_BYTES = 50 * 2 ** 20
TRAIN_STEPS = 3
TRAIN_PER_STEP = {"fused_window_attention_packed": 13,
                  "fused_window_attention_packed_bwd": 12,
                  "fused_cross_view_attention": 0, "fused_conv3x3": 0,
                  "fused_swap_fusion": 0, "fused_window_attention": 0,
                  "fused_swap_fusion_streaming": 0, "fused_conv3x3_int8": 0,
                  "conv3x3_s8": 0, "int8_absmax": 0}
# the LiDAR step: FuseBEVT depth 2 = 4 attentions, K1 forward and K5 backward
# (the fusion dropouts sit on outputs, so no attention carries a weight);
# every other wrapper 0
LIDAR_TRAIN_PER_STEP = {"fused_window_attention_packed": 4,
                        "fused_window_attention_packed_bwd": 4}
# phase 15: the fixture's train split (4 samples of 5 agents: 4 steps at
# batch 1) and validation split (2 frames of 3 live agents), and the steps
# after the first that torch.profiler traces
TRAIN_CAM_CAVS, TRAIN_CAM_STAMPS = 5, 4
VAL_CAM_CAVS, VAL_CAM_STAMPS = 3, 2
TRAIN_CAM_PROFILED = 2
# phase 16: the synthetic nuScenes scene set (2 scenes x 8 samples, 6 camera
# PNGs at 1600 x 900 from a pool of 12 files, 200^2 labels), the steps of
# the first run and of the resumed one, the checkpoint interval, the train
# step of the first run that torch.profiler traces (its third: the workers
# are up and the device is idle while the loader catches up), and the
# bench_input fixtures (the adaptive PNG filters only: 2 OPV2V samples at
# batch 1 and 8 nuScenes samples, one batch, each pass through the
# training loader's 2 workers).  At 9 samples, 6 resumed steps and 4 OPV2V
# + 16 nuScenes samples over 3 fixtures (filter 0 and the adaptive ones)
# the script took 1196.6 s on one H100 host, over its 1200 s with the
# machine's start (this phase 359.4 s, ~205 s of it bench_input's nine
# passes, each spawning its 2 workers for 15-30 s)
NUSC_CLI_SCENES, NUSC_CLI_SAMPLES, NUSC_CLI_POOL = 2, 8, 12
NUSC_CLI_STEPS, NUSC_CLI_RESUMED_STEPS, NUSC_CLI_CKPT_EVERY = 4, 5, 2
NUSC_CLI_TRACED = 2
BENCH_INPUT_ARGS = ["--opv2v_frames", "2", "--nusc_frames", "8",
                    "--num_workers", "2", "--filters", "adaptive"]
SERVE_AGENTS = [5, 3, 1, 4, 2, 5, 3, 5, 2, 4]
INT8_AGENTS = [5, 3, 1, 4, 2]
STOCK_AGENTS = [5, 2, 4]
# launches per frame on each path: K2 6 branches x 4, K4 on its wgmma route
# the first QKV, 3 blocks x 2 sublayers x 2 (attention, output with the next
# QKV) and the head (ops/fused_*.py: LAUNCHES_PER_CALL, launches_per_call)
FUSED_PER_FRAME = {"fused_window_attention_packed": 1,
                   "fused_cross_view_attention": 6 * 4,
                   "fused_conv3x3": 20, "fused_swap_fusion": 1 + 3 * 2 * 2 + 1,
                   "fused_swap_fusion_streaming": 0, "fused_conv3x3_int8": 0,
                   "conv3x3_s8": 0, "int8_absmax": 0}
# COBEVT_INT8=1 on the fused path: layer3's 5 and layer4's 2 stride-1 blocks
# take K7, layer2's 3 stay on K3, layer1's 3 blocks run the chain's conv; one
# absmax a stage scales its first K7 (the strided block's output), every
# later K7 reads the slot its producer K7 wrote
INT8_PER_FRAME = dict(FUSED_PER_FRAME, fused_conv3x3=6,
                      fused_conv3x3_int8=14, conv3x3_s8=6, int8_absmax=2)
INT8_NOT_RESIDENT_PER_FRAME = dict(INT8_PER_FRAME, conv3x3_s8=0)
# phase 14, launches per train step (every other wrapper 0; "composite": the
# backwards of window attention that take the composite): the nuScenes step
# runs the stock FAX modules, K1 forward and K5 backward for each of its 6
# cross-view branches, none with a weight; under COBEVT_FUSED_XATTN_TRAIN=1
# K2's forward and the composite's K1 and K5 behind it; SinBEVT-OPV2V adds the
# self-attention, whose dropout weight takes the composite backward
NUSC_TRAIN_PER_STEP = {"fused_window_attention_packed": 6,
                       "fused_window_attention_packed_bwd": 6}
NUSC_FUSED_XATTN_TRAIN_PER_STEP = dict(NUSC_TRAIN_PER_STEP,
                                       fused_cross_view_attention=6 * 4)
SINBEVT_OPV2V_TRAIN_PER_STEP = {"fused_window_attention_packed": 7,
                                "fused_window_attention_packed_bwd": 6,
                                "composite": 1}
# phase 13, launches per frame (every other wrapper 0): SinBEVT-nuScenes
# runs K2 for its 6 cross-view branches on the serving default and K1 for
# each on the stock path (no self-attention, no 3x3 trunk conv: EfficientNet
# has none); SinBEVT-OPV2V adds the final self-attention (K1) and the
# ResNet-34 trunk's 20 K3 launches
SINBEVT_FRAMES = 5
SINBEVT_PER_FRAME = {"fused_cross_view_attention": 6 * 4}
SINBEVT_STOCK_PER_FRAME = {"fused_window_attention_packed": 6}
SINBEVT_OPV2V_PER_FRAME = {"fused_cross_view_attention": 6 * 4,
                           "fused_window_attention_packed": 1,
                           "fused_conv3x3": 20}
SINBEVT_OPV2V_STOCK_PER_FRAME = {"fused_window_attention_packed": 7,
                                 "fused_conv3x3": 20}
STOCK_PER_FRAME = {"fused_window_attention_packed": 13,
                   "fused_cross_view_attention": 0,
                   "fused_conv3x3": 20, "fused_swap_fusion": 0,
                   "fused_swap_fusion_streaming": 0, "fused_conv3x3_int8": 0,
                   "conv3x3_s8": 0, "int8_absmax": 0}
# the LiDAR forward: FuseBEVT depth 2 = 4 sublayers, each one K6 call by
# default (and under force-stream) or one K1 call (after a cuBLAS QKV
# projection) on the stock modules (COBEVT_FUSED_FUSION=0)
LIDAR_AGENTS = [5, 3, 1, 4, 2]
LIDAR_FUSED_PER_FRAME = {"fused_swap_fusion_streaming": 4}
LIDAR_STOCK_PER_FRAME = {"fused_window_attention_packed": 4}
# phase 17: the synthetic LiDAR scenario (1 scenario, 5 CAVs x 4 timestamps,
# 24 vehicles, ~120,000 returns a cloud from a 64-beam spinning sensor, one
# cloud in ASCII), the train steps at batch 1 (epoch 0's 4 batches and the
# first of epoch 1, so the loader crosses an epoch boundary), the eval frame
# and the train step (numbered from 0) that torch.profiler traces alone, and
# the AP thresholds of the ideal-map gate
LIDAR_DATA_CAVS, LIDAR_DATA_STAMPS = 5, 4
LIDAR_DATA_VEHICLES, LIDAR_DATA_POINTS = 24, 120_000
LIDAR_DATA_TRAIN_STEPS = 5
LIDAR_TRACED_FRAME, LIDAR_TRACED_STEP = 2, 2
LIDAR_AP_IOUS = (0.5, 0.7)
# phase 18: the six OPV2V graphs of the camera zoo (their presets' widths),
# the live agents of a cooperative graph's frame, the bf16 frames each graph
# serves with its kernels (every one timed, one more traced alone), the
# launches a frame (the ResNet-34 trunk's 20 K3 in every graph; K4 for the
# swap fusion, as CorpBEVT's FuseBEVT at the same (5, 32, 32, 128) state);
# the camera fixture (5 CAVs x 2 timestamps to train on at batch 1, 3 CAVs
# x 1 to validate), the synthetic requests each serve_camera run answers,
# and cvt_swap_fuse's train step (3 FuseBEVT blocks = 6 window attentions,
# K1 forward and K5 backward, no weight on any); the nuScenes fixture (2
# scenes x 4 samples: 1 step at B 8, no wrapper launched: the dense CVT
# and EfficientNet have no kernel; 2 x 8 and 2 steps before phase 22)
ZOO_GRAPHS = ("cvt", "cvt_att_fuse", "cvt_swap_fuse", "cvt_fcooper",
              "cvt_v2vnet", "cvt_disconet")
ZOO_LIVE, ZOO_FRAMES = 3, 3
# the gate of a zoo frame, bf16 with kernels against the f32 plain forward
# of the same weights: the largest logit deviation within ZOO_BUDGET of the
# reference's largest logit, and within ZOO_WITNESS_RATIO times the bf16
# plain forward's own deviation (the kernels add little to bf16's).  Each
# graph runs again with each fault of ZOO_FAULTS planted, which must fail
# the gate.  Readings on an NVIDIA H100 80GB HBM3 (700 W) at --zoo_seed 0,
# 1 and 2: sound, a deviation of 0.0093-0.0461 and 0.87-1.22x bf16 plain's
# (the served frames included); faulted 0.157-1.052 and 10-34x, but for
# cvt_v2vnet's K3 fault, 0.012-0.026 and 1.38-2.74x: at random weights its
# output barely depends on the trunk, and at seed 1 the gate cannot see
# that fault (phase 3 holds K3 to its plain version).  The budget sits at
# 1.7x the sound largest and half the faulted smallest, the ratio between
# 1.22 and 2.13.  The argmax IoU, bf16 plain's and the IoU about the
# reference's median margin are reported: the last overlaps (sound
# 0.782-0.981, faulted 0.265-0.854), so it gates nothing.
ZOO_BUDGET = 0.08
ZOO_WITNESS_RATIO = 1.6
# the K3 call of a frame, counted among those with a residual (from 1), that
# the planted K3 fault runs without it
ZOO_K3_FAULT_CALL = 5
ZOO_PER_FRAME = {"fused_conv3x3": 20}
ZOO_SWAP_PER_FRAME = dict(ZOO_PER_FRAME,
                          fused_swap_fusion=FUSED_PER_FRAME[
                              "fused_swap_fusion"])
ZOO_TRAIN_CAVS, ZOO_TRAIN_STAMPS = 5, 2
ZOO_VAL_CAVS, ZOO_VAL_STAMPS = 3, 1
ZOO_SERVE_FRAMES = 4
ZOO_TRAIN_PER_STEP = {"fused_window_attention_packed": 6,
                      "fused_window_attention_packed_bwd": 6}
ZOO_NUSC_SCENES, ZOO_NUSC_SAMPLES, ZOO_NUSC_STEPS = 2, 4, 1
# phase 19: the LiDAR zoo.  SECOND (+ swap fusion) from the phase-17
# scenario writer at the JAX SecondConfig's geometry (+-70.4 x +-40 x
# [-3, 1] m at 0.1 m: grid 1408 x 800 x 40, map 100 x 176 after the 8x
# voxel stride), 5 CAVs x 2 timestamps; its eval frames at 5 and 3 live
# agents, the train steps at batch 1; 5 points a voxel; depth 1 = a window
# and a grid sublayer: 2 K6 calls an eval frame, 2 K1 + 2 K5 a train step
SECOND_CAVS, SECOND_STAMPS = 5, 2
SECOND_LIVE = (5, 3)
SECOND_POINTS_PER_VOXEL = 5
SECOND_TRAIN_STEPS = 2
SECOND_PER_FRAME = {"fused_swap_fusion_streaming": 2}
SECOND_TRAIN_PER_STEP = {"fused_window_attention_packed": 2,
                         "fused_window_attention_packed_bwd": 2}
# AttBEVBackbone at PointPillarConfig's backbone widths on the pillar BEV of
# the same scenario (5 agents, 3 live); the ResNet variants at corpbevt.yaml
# width (5 agents x 4 cameras x 512^2, ResNet-34: K3 x 20 a frame); HGT at
# V2X-ViT's widths on the LiDAR fusion map (3 live agents of mixed types)
ATT_BEV_LIVE = 3
RESNET_ZOO_PER_FRAME = {"fused_conv3x3": 20}
HGT_SHAPE, HGT_HEADS, HGT_TYPES = (1, 5, 96, 176, 256), 8, (0, 1, 0, 1, 0)
HGT_LIVE = 3
# phase 20: the exported frames (the serving default, COBEVT_INT8=1, and
# SinBEVT-nuScenes) and their gate (validate_kernels.BUDGET_EXPORT, the int8
# frame bit for bit); the served frames a side of the dispatcher A/B (the
# staged runner, 5 live agents, every kernel through its cobevt:: op or
# its CUDA implementation called directly), in turns, untraced and traced;
# the data-parallel step: 2 ranks on the card
# in one gloo group, one sample each of a global batch of 2 at max_cav
# DP_AGENTS, held to one process's step on the global batch (the loss within
# DP_LOSS_TOL relative, the gradients at the camera gradient gate's budgets,
# validate_kernels.TRAIN_BUDGETS["corpbevt"]); a step K1 x 13 + K5 x 13:
# every dropout of this model is off in this phase (phase 21 holds the
# same step with every dropout on), so the self-attention, which carries no
# dropout weight then, takes K5 too
EXPORT_TIMED_FRAMES = 10
DISPATCH_FRAMES, DISPATCH_TRACED = 5, 5
DP_WORLD, DP_AGENTS = 2, 5
DP_LOSS_TOL = 1e-3
# the ranks' step in each precision: bf16, and f32 on an f32 compute twin
# with TF32 off (both take the twin's branch of the step); the f32 twin's
# gradients are held to the camera gate's budgets, the bf16 gradients'
# drift at random weights is reported beside one process's own spread
# (the same step on the batch in the other sample order)
DP_PRECISIONS = ("bf16", "f32")
DP_PER_STEP = {"fused_window_attention_packed": 13,
               "fused_window_attention_packed_bwd": 13}
# phase 21: the ("data", "model") mesh of parallel/mesh.py, 2 ranks of this
# script on the one card in one gloo group, every case against one process
# on the same global batch from the same dropout generator seed, every
# dropout on (the preset's 0.1), full-width CorpBEVT; a case's (n_data,
# n_model, max_cav, global batch, batch placement): (a) data parallel, (b)
# tensor parallel, (c) the agent axis (two agents a rank, tensor-parallel
# weights; at 5 agents the JAX rule replicates, and (b) covers that)
MESH_CASES = {"dp": (2, 1, 5, 2, "data"), "tp": (1, 2, 5, 1, "data"),
              "agent": (1, 2, 4, 1, "agents")}
# (d): StagedBucketedRunner over a 2 x 1 mesh, a batch of 2 frames at 5 live
# agents, against the padded single-process forward: in f32 (TF32 off)
# within MESH_SERVE_TOL of the largest logit (phase 20's export budget); in
# bf16 reported beside one process's own spread between the frame served
# alone and in the batch of 2 (cuDNN and cuBLAS pick their algorithms by
# the batch, and bf16 keeps their roundings)
MESH_SERVE_FRAMES, MESH_SERVE_TOL = 2, 0.01
# f32 on an f32 compute twin (TF32 off) is gated: the loss within
# MESH_LOSS_TOL relative, the gradients at the camera gate's budgets and
# every parameter and BatchNorm statistic within its per-tensor budget
# (relative L2), the ranks bit-equal; bf16 is reported beside it
MESH_PRECISIONS = ("f32", "bf16")
MESH_LOSS_TOL = 1e-3
MESH_DROPOUT_SEED = 0
MESH_KERNELS = ("fused_window_attention_packed",
                "fused_window_attention_packed_bwd",
                "fused_cross_view_attention", "fused_conv3x3",
                "fused_swap_fusion")
# phase 22: the measurement layer (utils/flops.py, tools/benchmark.py's
# counts and shares, tools/parse_trace.py) on five paths at full width, each
# a benchmark row (2 warmup calls, the last one counted, 3 timed, 2 traced
# into a --profile_dir) and the same call on the plain versions (1 + 1):
# (path, --model, further flags)
MEASURE_PATHS = (
    ("corpbevt_frame", "corpbevt", []),
    ("corpbevt_step", "corpbevt", ["--train"]),
    ("corpbevt_int8_frame", "corpbevt", ["--int8"]),
    ("sinbevt_frame", "sinbevt", []),
    ("pointpillar_frame", "pointpillar", []),
)
# an mfu above this is physically impossible: a count at fault; the trace
# table's device total may differ from timing.device_profile's by this share
MEASURE_MFU_MAX = 1.05
MEASURE_TRACE_TOL = 0.01
# the cobevt:: op through which each counted wrapper launches its kernel
WRAPPER_OPS = {"fused_window_attention_packed": "window_attention_packed",
               "fused_window_attention_packed_bwd":
               "window_attention_packed_bwd",
               "fused_window_attention": "window_attention",
               "fused_cross_view_attention": "cross_view_attention",
               "fused_conv3x3": "conv3x3", "fused_swap_fusion": "swap_fusion",
               "fused_swap_fusion_streaming": "swap_fusion_streaming",
               "fused_conv3x3_int8": "conv3x3_int8",
               "conv3x3_s8": "conv3x3_s8", "int8_absmax": "int8_absmax"}
KERNELS = ("window_attention", "fused_cross_attention", "conv3x3",
           "fused_swap_fusion", "window_attention_bwd",
           "fused_swap_fusion_streaming", "conv3x3_int8", "ffd_fused",
           "bn_stats", "hopper_tile")
# the bare tile against torch.matmul in f32: exact bf16 products, f32 sums
# in another order
TILE_TOL = (1e-4, 1e-5)
IOU_FLOOR = 0.99


def log(msg=""):
    print(msg, flush=True)


def run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {out.stderr.strip()}")
    return out.stdout.strip()


def card_line():
    return run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]


def time_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters):
    """ms of one call on the card alone: the launches are queued behind a
    sleep kernel, so the host's enqueue time does not pace them (where a
    call's host work exceeds its kernel time, time_ms measures the host)."""
    from cobevt_tpu_torch.tools import timing
    return timing.device_ms(fn, iters)


def kernel_device_ms(fn, iters):
    """ms of each kernel that one call of ``fn`` launches, on the card
    alone (queued behind a sleep kernel), by kernel name, from
    torch.profiler's device times: the launches of a multi-launch call one
    by one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        name = e.key[5:] if e.key.startswith("void ") else e.key
        name = name.replace("(anonymous namespace)::", "")
        name = name.split("<")[0].split("(")[0].split("::")[-1].strip()
        if us > 0 and name and "sleep" not in name and "spin" not in name:
            out[name] = out.get(name, 0.0) + us / iters / 1e3
    return out


def compare(got, want, dtype_name, tol=TOL):
    import torch
    atol, rtol = tol[dtype_name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output has non-finite values")
    diff = (g - w).abs()
    abs_err = float(diff.max())
    rel_err = abs_err / (float(w.abs().max()) + 1e-12)
    worst = float((diff - (atol + rtol * w.abs())).max())
    return abs_err, rel_err, worst <= 0


def compare_scaled(got, want, dtype_name):
    """|kernel - plain| <= tol * (max|plain| + |plain|): K5's check."""
    import torch
    tol = K5_TOL[dtype_name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output has non-finite values")
    scale = max(float(w.abs().max()), 1e-3)
    diff = (g - w).abs()
    abs_err = float(diff.max())
    worst = float((diff - tol * (scale + w.abs())).max())
    return abs_err, abs_err / scale, worst <= 0


def k2_scale(x, we, ce, key, val, p, q_win, k_win, heads, scale,
             grid=False):
    """The f32 magnitude K2's rounding error scales with, element by
    element: |attention branch| + |x| (the skip) + |MLP term|, times the
    post-LN's |gamma| / std (its beta adds a constant and cancels
    nothing).  An output near zero can be the difference of two large
    terms, each rounded to bf16.  The branch is the plain chain without its
    tail, the tail is taken here in f32 in the chain's order."""
    import torch
    import torch.nn.functional as F
    from cobevt_tpu_torch.ops.fused_cross_attention import (
        PackedParams,
        _reference,
        ln_f32,
    )
    tail = ("ln_m", "w1_t", "b1", "w2_t", "b2", "ln_p")
    a = _reference(x, we, ce, key, val,
                   PackedParams({k: v for k, v in p.items()
                                 if k not in tail}),
                   tuple(q_win), tuple(k_win), heads, scale, False,
                   grid).float()

    def c(t):   # a rounding to the compute dtype, kept as f32 values
        return t.to(x.dtype).float()

    s = a + x.float()
    mag = a.abs() + x.float().abs()
    if "w1_t" in p:
        t = c(ln_f32(c(s), *p["ln_m"]))
        hid = c(F.gelu(t @ p["w1_t"].float().t() + p["b1"].float()))
        m = hid @ p["w2_t"].float().t() + p["b2"].float()
        s = c(s) + m
        mag = mag + m.abs()
    if "ln_p" in p:
        s = c(s)
        var = ((s - s.mean(-1, keepdim=True)) ** 2).mean(-1, keepdim=True)
        mag = mag * p["ln_p"][0].float().abs() * torch.rsqrt(var + 1e-5)
    return mag


def compare_k2(got, want, mag, dtype_name):
    """K2's check: |kernel - plain| <= atol + rtol * max(|plain|, mag),
    ``mag`` from :func:`k2_scale`.  With the plain chain rounding where
    the TPU body rounds, the |plain|-relative rule alone still reads above
    1 at some bf16 draws (1.012 of its bound at CorpBEVT's stage0_local,
    PERF.md), at outputs that cancel.
    Returns the errors, the worst ratio of error to bound (<= 1 holds) and
    that ratio under the |plain|-relative rule."""
    import torch
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output has non-finite values")
    diff = (g - w).abs()
    abs_err = float(diff.max())
    return {"abs_err": abs_err,
            "rel_err": abs_err / (float(w.abs().max()) + 1e-12),
            "ratio": float((diff / (atol + rtol * torch.maximum(
                w.abs(), mag))).max()),
            "ratio_plain": float((diff / (atol + rtol * w.abs())).max())}


def k2_drop_head(out, heads):
    """The attention output of packed (G, T, C) heads with head 0 zeroed:
    the fault K2's check must see."""
    out = out.clone()
    out[..., :out.shape[-1] // heads] = 0
    return out


def argmax_iou(a, b):
    """Mean over classes of the IoU between two argmax maps (the check of
    cobevt_tpu/tools/validate_kernels.py:argmax_iou)."""
    import numpy as np
    a, b = a.argmax(-1), b.argmax(-1)
    ious = []
    for c in np.union1d(np.unique(a), np.unique(b)):
        union = np.logical_or(a == c, b == c).sum()
        if union:
            ious.append(np.logical_and(a == c, b == c).sum() / union)
    return float(np.mean(ious)) if ious else 1.0


def phase_environment():
    import torch
    log("== environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    from cobevt_tpu_torch.ops import _build
    nvcc = _build.nvcc()
    log(f"nvcc {nvcc}: {run([nvcc, '--version']).splitlines()[-1]}")
    log(f"triton importable: {importlib.util.find_spec('triton') is not None}"
        f"  ninja on PATH: {shutil.which('ninja') is not None}")
    log(f"card: {card_line()}  ({torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    import concurrent.futures

    from cobevt_tpu_torch.ops import _build
    from cobevt_tpu_torch.utils import native_ops
    log("== build")
    t0 = time.perf_counter()
    # the host box library (g++, csrc/box_ops.cpp) beside the nvcc builds
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        box_lib = pool.submit(native_ops.get_lib)
        builds = _build.build_all(KERNELS)
        if box_lib.result() is None:
            raise RuntimeError(f"the box library did not build: "
                               f"{native_ops.build_error()}")
    log(f"{len(builds)} kernels and the box library built in "
        f"{time.perf_counter() - t0:.1f} s; box library "
        f"{native_ops.library_path()}")
    for name, b in builds.items():
        log(f"{name}: {b.seconds:.1f} s -> {b.path}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {line.strip()}")
        _build.load(name)


def k1_inputs(case, dtype, gen, heads=K1_HEADS):
    import torch
    name, G, Tq, Tk, has_bias, has_mask, has_weight = case[:7]
    C = heads * K1_HEAD_DIM
    dev = "cuda"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q = (randn(G, Tq, C) * K1_HEAD_DIM ** -0.5).to(dtype)
    k, v = randn(G, Tk, C).to(dtype), randn(G, Tk, C).to(dtype)
    bias = randn(Tq, heads * Tk) * 0.5 if has_bias else None
    mask = None
    if has_mask:
        mask = (torch.rand(G, Tk, generator=gen, device=dev) > 0.3).float()
        if name.endswith("fully_masked_window"):
            mask[3] = 0.0
    weight = None
    if has_weight:
        keep = torch.rand(G, Tq, heads * Tk, generator=gen, device=dev)
        weight = ((keep > 0.1).float() / 0.9).to(dtype)
    return q, k, v, bias, mask, weight


def k3_inputs(case, dtype, gen):
    import torch
    _, N, H, W, C, residual = case[:6]
    dev = "cuda"
    x = torch.randn(N, H, W, C, generator=gen, device=dev).relu().to(dtype)
    w = torch.randn(3, 3, C, C, generator=gen, device=dev)
    w = w * (2 / (9 * C)) ** 0.5
    shift = torch.randn(C, generator=gen, device=dev) * 0.1
    res = None
    if residual:
        res = torch.randn(N, H, W, C, generator=gen, device=dev).relu().to(
            dtype)
    return x, w, shift, res


def _ln_pair(randn, D):
    return 1.0 + 0.1 * randn(D), 0.1 * randn(D)


def k2_inputs(case, dtype, gen, B=K2_B):
    """x, w_embed, c_embed, key, val, params, mlp, post_ln of one FAX
    branch at its serving shape over B maps, weights scaled like the
    seeded model's."""
    _, H, h, _, _, embed, post, _ = case
    return k2_branch_inputs(B, K2_CAMS, H, H, h, h, K2_DIM, K2_DIM,
                            2 * K2_DIM, embed, post, dtype, gen)


def k2_branch_inputs(B, n, H, W, h, w, D, C, hidden, embed, post, dtype,
                     gen):
    """The operands of one branch of B maps, n cameras, BEV H x W, keys
    h x w, widths D and C, MLP hidden ``hidden``."""
    import torch

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = randn(B, H, W, D).to(dtype)
    key, val = randn(B, n, h, w, D).to(dtype), randn(B, n, h, w, D).to(dtype)
    w_embed = randn(H, W, D).to(dtype) if embed else None
    c_embed = randn(B, n, D).to(dtype) if embed else None
    params = {f"ln_{t}": _ln_pair(randn, D) for t in "qkv"}
    for t in "qkv":
        params[f"w{t}"] = randn(D, C, scale=D ** -0.5)
        params[f"b{t}"] = randn(C, scale=0.02)
    params["wo"] = randn(C, D, scale=C ** -0.5)
    params["bo"] = randn(D, scale=0.02)
    mlp = {"ln": _ln_pair(randn, D), "w1": randn(D, hidden, scale=D ** -0.5),
           "b1": randn(hidden, scale=0.02),
           "w2": randn(hidden, D, scale=hidden ** -0.5),
           "b2": randn(D, scale=0.02)}
    post_ln = _ln_pair(randn, D) if post else None
    return x, w_embed, c_embed, key, val, params, mlp, post_ln


def fusion_operands(randn, D, mlp, depth, T, heads):
    """(layers, bias_stack, head) of a FuseBEVT encoder, weights scaled like
    the seeded model's; K4's and K6's operands."""
    def sub():
        return {"ln_a": _ln_pair(randn, D),
                "wqkv": randn(D, 3 * D, scale=D ** -0.5),
                "wout": randn(D, D, scale=D ** -0.5),
                "ln_f": _ln_pair(randn, D),
                "w1": randn(D, mlp, scale=D ** -0.5),
                "b1": randn(mlp, scale=0.02),
                "w2": randn(mlp, D, scale=mlp ** -0.5),
                "b2": randn(D, scale=0.02)}

    layers = [(sub(), sub()) for _ in range(depth)]
    bias = randn(depth, 2, T, heads * T, scale=0.02)
    head = {"ln": _ln_pair(randn, D), "w": randn(D, D, scale=D ** -0.5),
            "b": randn(D, scale=0.02)}
    return layers, bias, head


def k4_inputs(case, dtype, gen):
    """x, mask, agent_mask, bias_stack, layers, head of the FuseBEVT
    encoder at CorpBEVT (one frame, 3 live agents of max_cav 5; at
    "encoder_dead_agent" 4, agent 2 dead)."""
    import torch
    name, masked, _, _ = case
    B, L, H, D, w, heads, depth, mlp = 1, 5, 32, 128, 8, 4, 3, 256

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    live = [1.0, 1.0, 0.0, 1.0, 1.0] if name == "encoder_dead_agent" else \
        [1.0, 1.0, 1.0, 0.0, 0.0]
    agent_mask = torch.tensor([live], device="cuda")
    mask = None
    if masked:
        mask = (torch.rand(B, L, H, H, generator=gen, device="cuda")
                > 0.3).float() * agent_mask[:, :, None, None]
        mask[:, 0] = 1.0
    layers, bias, head = fusion_operands(randn, D, mlp, depth, L * w * w,
                                         heads)
    return (randn(B, L, H, H, D).to(dtype), mask, agent_mask, bias, layers,
            head, w, heads)


def k6_inputs(case, dtype, gen):
    """x, mask, agent_mask, bias_stack, layers, head, window, heads of the
    streaming FuseBEVT encoder."""
    import torch
    _, (B, L, H, W, D, w, heads, depth, mlp), mask_kind, _, _ = case

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    agent_mask = torch.ones(B, L, device="cuda")
    agent_mask[:, L - L // 3:] = 0.0
    mask = (torch.rand(B, L, H, W, generator=gen, device="cuda")
            > 0.3).float() * agent_mask[:, :, None, None]
    mask[:, 0] = 1.0
    if mask_kind == "fully_masked":
        mask[:, :, :w, :w] = 0.0      # window (0, 0) has no live key
    layers, bias, head = fusion_operands(randn, D, mlp, depth, L * w * w,
                                         heads)
    return (randn(B, L, H, W, D).to(dtype), mask, agent_mask, bias, layers,
            head, w, heads)


def sdpa_mask(bias_flat, mask, dtype, heads=K1_HEADS):
    """Packed bias (Tq, H*Tk) and key mask (G, Tk) as the additive
    ``attn_mask`` of ``scaled_dot_product_attention``, or None."""
    import torch
    add = None
    if bias_flat is not None:
        Tq = bias_flat.shape[0]
        add = bias_flat.reshape(Tq, heads, -1).permute(1, 0, 2)[None]
        add = add.to(dtype)
    if mask is not None:
        m = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :].to(dtype)
        add = m if add is None else add + m
    if add is not None:
        add = add.contiguous()
    return add


def k3_l2_bytes(N, H, W, C, O, residual):
    """Bytes the wgmma tiles of one K3 call move between L2 and the SMs:
    every K step of every tile fetches a 128 x 64 box of x (once per tap)
    and a 128 x 64 box of the weight; the residual tile is fetched and the
    output tile stored once a tile."""
    from cobevt_tpu_torch.ops.conv2d import conv_tile_plan
    _, _, ty, tx = conv_tile_plan(H, W)
    tiles = N * ty * tx * -(-O // 128)
    steps = 9 * -(-C // 64)
    return tiles * (steps * 2 * 128 * 64 * 2 + (2 if residual else 1) *
                    128 * 128 * 2)


def s8_plan_fields(shape):
    """The launch plan of the chain's conv at (N, H, W, C = O)."""
    import torch
    from cobevt_tpu_torch.ops.int8_chain import s8_plan
    N, H, W, C = shape
    plan = s8_plan(N, H, W, C, C, torch.cuda.get_device_properties(0)
                   .multi_processor_count)
    return {"path": plan.path, "strip_rows": plan.rows,
            "strips": plan.strips, "blocks": plan.blocks}


@contextlib.contextmanager
def k4_serial():
    """K4's wgmma route without programmatic dependent launch inside the
    block (its plan's ``pdl`` False): each launch starts after the last."""
    import importlib
    module = importlib.import_module("cobevt_tpu_torch.ops.fused_swap_fusion")
    plan = module.k4_plan
    module.k4_plan = lambda *args: plan(*args)._replace(pdl=False)
    try:
        yield
    finally:
        module.k4_plan = plan


def k4_plan_fields(x, heads, layers):
    """The route and launch plan of K4 on x (its packed layers)."""
    import torch
    from cobevt_tpu_torch.ops.fused_swap_fusion import k4_kernel_path, k4_plan
    B, L, H, W, D = x.shape
    mlp = layers[0][0]["w1_t"].shape[0]
    path = k4_kernel_path(D, heads, mlp, x.dtype)
    row = {"path": path}
    if path == "wgmma":
        plan = k4_plan(B * L * H * W, D, mlp,
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count)
        row.update(qkv_blocks=3 * plan.qkv_blocks, blocks=plan.out_blocks,
                   stages=plan.stages)
    return row


def phase_kernels(only=None):
    """Every kernel vs its plain version at every slice shape, f32 and
    bf16 (``only``: the kernel keys to run, e.g. {"K5", "K2"}; None: all).
    Returns one row per (case, dtype); raises if any disagrees."""
    import torch
    import torch.nn.functional as F
    from cobevt_tpu_torch.ops.bn_stats import bn_stats_bwd, bn_stats_fwd
    from cobevt_tpu_torch.utils import flops
    from cobevt_tpu_torch.ops.conv2d import (
        _kernel_path,
        _launch_int8,
        _launch_kernel as _launch_k3,
        fold_amax_,
        fused_conv3x3,
        fused_conv3x3_int8,
        int8_absmax,
        int8_tile_plan,
        new_amax_slots,
        pack_conv3x3_weight,
        pack_int8_weight,
    )
    from cobevt_tpu_torch.ops.hopper_tile import (
        S8_VARIANTS,
        VARIANTS,
        tile_product,
        tile_reference,
    )
    from cobevt_tpu_torch.ops.int8_chain import (
        conv3x3_s8,
        pack_s8_weight,
        quantize_dynamic,
    )
    from cobevt_tpu_torch.ops.ffd_fused import (
        fused_ffd,
        fused_ffd_bwd,
        kernel_path as ffd_kernel_path,
    )
    from cobevt_tpu_torch.ops.fused_cross_attention import (
        _reference as k2_reference,
        cross_view_attention_reference,
        fused_cross_view_attention,
        kernel_path as k2_kernel_path,
        pack_params,
        packed_attention_rounded,
    )
    from cobevt_tpu_torch.ops.fused_swap_fusion import (
        _launch_streaming,
        fused_swap_fusion,
        fused_swap_fusion_streaming,
        pack,
        stream_kernel_path,
    )
    from cobevt_tpu_torch.ops.window_attention import (
        _launch_bwd_kernel,
        _launch_kernel as _launch_k1,
        _packed_to_4d,
        attention_tile_plan,
        bwd_tile_plan,
        dbias_plan,
        fused_window_attention,
        fused_window_attention_packed,
        fused_window_attention_packed_bwd,
        stats_scratch,
    )
    from cobevt_tpu_torch.ops import bn_stats
    from cobevt_tpu_torch.tools import timing
    from cobevt_tpu_torch.tools.micro_bn_stats import (
        SHAPES as BN_SHAPES,
        library_calls as bn_library_calls,
    )
    from cobevt_tpu_torch.tools.micro_ffd_fused import make_operands, ref_ffd
    log("== kernels vs plain versions (CUDA events, after warmup)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    nusc_gen = torch.Generator(device="cuda").manual_seed(14)
    k2_gen = torch.Generator(device="cuda").manual_seed(15)
    details = []
    failures = []

    def selected(key):
        return only is None or key in only

    # the Hopper building blocks alone, before the kernels that use them
    atol, rtol = TILE_TOL
    for variant, (a_shape, b_shape, c_shape, what) in (
            VARIANTS.items() if selected("tiles") else ()):
        a = torch.randn(*a_shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        b = torch.randn(*b_shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        got, want = tile_product(a, b, variant), tile_reference(a, b, variant)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool((got - want).abs().le(atol + rtol * want.abs()).all())
        log(f"bare TMA + wgmma tile {variant}: C {c_shape} = {what}, "
            f"max abs err {err:.2e} {'ok' if ok else 'BAD'}")
        if not ok:
            raise AssertionError(f"bare tile {variant} disagrees with "
                                 f"torch.matmul: {err:.3e}")
    for variant, (a_shape, b_shape, c_shape, what) in (
            S8_VARIANTS.items() if selected("tiles") else ()):
        a = torch.randint(-127, 128, a_shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, b_shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        got, want = tile_product(a, b, variant), tile_reference(a, b, variant)
        torch.cuda.synchronize()
        ok = bool(torch.equal(got, want))
        log(f"bare TMA + wgmma s8 tile {variant}: C {c_shape} = {what}, "
            f"{'equal integers' if ok else 'BAD'}")
        if not ok:
            raise AssertionError(f"bare s8 tile {variant} disagrees with the "
                                 f"integer product")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for case in (K1_CASES + K1_SINBEVT_CASES + K1_NUSC_CASES
                     if selected("K1") else ()):
            heads = case[9]
            q, k, v, bias, mask, weight = k1_inputs(case, dtype, gen, heads)

            def attn(impl):
                return fused_window_attention_packed(
                    q, k, v, heads, bias_flat=bias, mask=mask,
                    weight=weight, impl=impl)

            got, want = attn("kernel"), attn("torch")
            torch.cuda.synchronize()
            abs_err, rel_err, ok = compare(got, want, dname)
            iters = 3 if case[1] * case[2] * case[3] > 5e7 else 10
            row = {"kernel": "K1", "case": case[0], "dtype": dname,
                   "per_frame": case[8], "per_frame_stock": case[7],
                   "per_lidar_frame_stock": case[10], "heads": heads,
                   "blocks": attention_tile_plan(case[1], heads, case[2])[1],
                   "max_abs_err": abs_err,
                   "max_rel_err": rel_err, "ok": ok,
                   "ms": time_ms(lambda: attn("kernel"), iters),
                   "plain_ms": time_ms(lambda: attn("torch"), iters)}
            row.update(flops.bound(*flops.k1_work(q, k, v, heads, bias, mask,
                                                  weight), dname))
            if weight is None:
                # one library call expresses bias and mask as an additive
                # mask; the dropout weight it cannot take
                q4, k4, v4 = (_packed_to_4d(t, heads) for t in (q, k, v))
                add = sdpa_mask(bias, mask, dtype, heads)

                def sdpa():
                    return F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=add, scale=1.0)

                row["library_ms"] = time_ms(sdpa, iters)
                row["library_device_ms"] = device_ms(sdpa, iters)
                del q4, k4, v4, add
            row["device_ms"] = device_ms(lambda: attn("kernel"), iters)
            if len(case) > 11:
                # a SinBEVT path's shapes: launches a frame of that path
                # and a bit-for-bit repeat
                row.update(case[11])
                row["repeats_bit_equal"] = all(
                    torch.equal(attn("kernel"), got)
                    for _ in range(NUSC_REPEATS))
                row["ok"] = ok = ok and row["repeats_bit_equal"]
            details.append(row)
            if not ok:
                failures.append(row)
            del q, k, v, bias, mask, weight, got, want
        for case in K3_CASES + K3_SINBEVT_CASES if selected("K3") else ():
            x, w, shift, res = k3_inputs(case, dtype, gen)
            # packed once, as a block's cache packs it
            packed = pack_conv3x3_weight(w, shift, dtype)

            def conv(impl):
                return fused_conv3x3(x, None, None, res, relu=True, impl=impl,
                                     packed=packed)

            got, want = conv("kernel"), conv("torch")
            torch.cuda.synchronize()
            abs_err, rel_err, ok = compare(got, want, dname)
            w_oihw = w.to(dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            x_cl = x.permute(0, 3, 1, 2)
            _, N, H, W, C = case[:5]
            path = _kernel_path(x, C, C)
            row = {"kernel": "K3", "case": case[0], "dtype": dname,
                   "per_frame": case[6], "path": path,
                   "max_abs_err": abs_err,
                   "max_rel_err": rel_err, "ok": ok,
                   "ms": time_ms(lambda: conv("kernel"), 10),
                   "launch_ms": time_ms(
                       lambda: _launch_k3(x, packed, res, True), 10),
                   "unpacked_ms": time_ms(lambda: fused_conv3x3(
                       x, w, shift, res, relu=True, impl="kernel"), 10),
                   "plain_ms": time_ms(lambda: conv("torch"), 5),
                   "library_ms": time_ms(
                       lambda: F.conv2d(x_cl, w_oihw, padding=1), 10),
                   "device_ms": device_ms(
                       lambda: _launch_k3(x, packed, res, True), 10),
                   "library_device_ms": device_ms(
                       lambda: F.conv2d(x_cl, w_oihw, padding=1), 10)}
            if len(case) > 7:
                row["per_sinbevt_opv2v_frame"] = case[7]
            if path == "wgmma":
                row["l2_bytes"] = k3_l2_bytes(N, H, W, C, C, res is not None)
            if path == "wgmma" or len(case) > 7:
                # the warpgroups share a ring slot in the epilogue: a race
                # there shows as a result that differs between launches
                row["repeats_bit_equal"] = all(
                    torch.equal(conv("kernel"), got)
                    for _ in range(K3_REPEATS))
                row["ok"] = ok = ok and row["repeats_bit_equal"]
            row.update(flops.bound(*flops.k3_work(x, packed.w, shift, res),
                                   dname))
            details.append(row)
            if not ok:
                failures.append(row)
            del x, w, shift, res, packed, got, want
        for case in K7_CASES if selected("K7") else ():
            x, w, shift, res = k3_inputs(case, dtype, gen)
            # quantized once, as a block's cache does
            packed = pack_int8_weight(w, shift)

            def conv7(impl):
                return fused_conv3x3_int8(x, None, None, res, relu=True,
                                          impl=impl, packed=packed)

            got, want = conv7("kernel"), conv7("torch")
            torch.cuda.synchronize()
            abs_err = float((got.float() - want.float()).abs().max())
            w_oihw = w.to(dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            x_cl = x.permute(0, 3, 1, 2)
            # equal integers and the same unfused f32 epilogue: bit for bit
            row = {"kernel": "K7", "case": case[0], "dtype": dname,
                   "per_frame": case[6], "max_abs_err": abs_err,
                   "max_rel_err": abs_err / (float(want.abs().max()) + 1e-12),
                   "ok": bool(torch.equal(got, want)
                              and torch.isfinite(got).all()),
                   "ms": time_ms(lambda: conv7("kernel"), 5),
                   "plain_ms": time_ms(lambda: conv7("torch"), 2, warmup=1),
                   "library_ms": time_ms(
                       lambda: F.conv2d(x_cl, w_oihw, padding=1), 5),
                   "k3_ms": time_ms(lambda: fused_conv3x3(
                       x, w, shift, res, relu=True, impl="kernel"), 5),
                   "k3_device_ms": device_ms(lambda: fused_conv3x3(
                       x, w, shift, res, relu=True, impl="kernel"), 5)}
            # the kernel alone, on its input's |max| slot as a producer K7
            # leaves it (the wrapper's own call adds a zeroed slot and one
            # absmax); the slot its epilogue folds equals the plain fold of
            # what it stored
            slot = int8_absmax(x, new_amax_slots(1, x.device))
            out_slot = new_amax_slots(1, x.device)
            folded = _launch_int8(x, packed, slot, res, True, out_slot)
            want_slot = fold_amax_(new_amax_slots(1, x.device), want)
            row["slot_equal"] = bool(torch.equal(out_slot, want_slot)
                                     and torch.equal(folded, want))
            row["ok"] = row["ok"] and row["slot_equal"]
            row["path"] = int8_tile_plan(*case[2:5]).path
            row["launch_ms"] = time_ms(
                lambda: _launch_int8(x, packed, slot, res, True), 10)
            # on the card alone: the wrapper's call with everything it
            # launches, and the kernel alone
            row["device_ms"] = device_ms(lambda: conv7("kernel"), 10)
            row["alone_device_ms"] = device_ms(
                lambda: _launch_int8(x, packed, slot, res, True), 10)
            row["library_device_ms"] = device_ms(
                lambda: F.conv2d(x_cl, w_oihw, padding=1), 10)
            row.update(flops.bound(*flops.k7_work(
                x, packed.wt, packed.s_w, packed.shift, res), "int8"))
            details.append(row)
            if not row["ok"]:
                failures.append(row)
            del x, w, shift, res, packed, got, want, w_oihw, x_cl, folded
        for name, shape, per_frame in (
                A7_CASES if selected("K7") or selected("A7") else ()):
            x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)

            def absmax(impl):
                return int8_absmax(x, new_amax_slots(1, x.device), impl=impl)

            got, want = absmax("kernel"), absmax("torch")
            torch.cuda.synchronize()
            row = {"kernel": "A7", "case": name, "dtype": dname,
                   "per_frame": per_frame,
                   "max_abs_err": float((got.view(torch.float32)
                                         - want.view(torch.float32)).abs()
                                        .max()),
                   "max_rel_err": 0.0, "ok": bool(torch.equal(got, want)),
                   "ms": time_ms(lambda: absmax("kernel"), 10),
                   "device_ms": device_ms(lambda: absmax("kernel"), 10),
                   "plain_ms": time_ms(lambda: absmax("torch"), 10),
                   "library_ms": time_ms(lambda: torch.linalg.vector_norm(
                       x, float("inf")), 10),
                   "library_device_ms": device_ms(
                       lambda: torch.linalg.vector_norm(x, float("inf")),
                       10)}
            row.update(flops.bound(*flops.a7_work(x, got), "float32"))
            details.append(row)
            if not row["ok"]:
                failures.append(row)
            del x, got, want
        for name, shape, residual, leaves, per_frame in (
                S8_CASES if selected("S8") else ()):
            N, H, W, C = shape
            xq, sx = quantize_dynamic(
                torch.randn(N, H, W, C, generator=gen, device="cuda").relu())
            rq, rs = quantize_dynamic(
                torch.randn(N, H, W, C, generator=gen, device="cuda").relu())
            w = torch.randn(3, 3, C, C, generator=gen, device="cuda") * (
                2 / (9 * C)) ** 0.5
            p8 = pack_s8_weight(w, torch.randn(C, generator=gen,
                                               device="cuda") * 0.1)
            x_cl = torch.randn(N, C, H, W, generator=gen, device="cuda").to(
                dtype).contiguous(memory_format=torch.channels_last)
            w_oihw = w.to(dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            kwargs = {"out_dtype": dtype}
            if residual:
                kwargs.update(residual_q=rq, residual_scale=rs)
            if not leaves:
                kwargs["out_scale"] = sx * 2.0

            def conv8(impl, with_sat=False):
                return conv3x3_s8(xq, sx, p8.w_q, p8.s_w, p8.shift, relu=True,
                                  impl=impl, wt=p8.wt, with_sat=with_sat,
                                  **kwargs)

            (got, sat), (want, want_sat) = (conv8("kernel", True),
                                            conv8("torch", True))
            torch.cuda.synchronize()
            abs_err = float((got.float() - want.float()).abs().max())
            row = {"kernel": "S8", "case": name, "dtype": dname,
                   "per_frame": per_frame, "max_abs_err": abs_err,
                   "max_rel_err": abs_err / (float(want.float().abs().max())
                                             + 1e-12),
                   "clipped_share": float(sat),
                   "ok": bool(torch.equal(got, want)
                              and float(sat) == float(want_sat)),
                   "ms": time_ms(lambda: conv8("kernel"), 5),
                   "plain_ms": time_ms(lambda: conv8("torch"), 2, warmup=1),
                   # the convolution alone, in the model's float dtype
                   "library_ms": time_ms(
                       lambda: F.conv2d(x_cl, w_oihw, padding=1), 5),
                   # both on the card alone
                   "device_ms": device_ms(lambda: conv8("kernel"), 10),
                   "library_device_ms": device_ms(
                       lambda: F.conv2d(x_cl, w_oihw, padding=1), 10)}
            row.update(s8_plan_fields(shape))
            row.update(flops.bound(*flops.s8_work(
                xq, p8.wt, p8.s_w, p8.shift, rq if residual else None,
                got.element_size()), "int8"))
            details.append(row)
            if not row["ok"]:
                failures.append(row)
            del got, want, xq, rq, w, p8, x_cl, w_oihw
        # K9, K10 (bf16 is how BatchNorm sees activations in training):
        # the CUDA route against its plain version, the Triton route
        # on the same inputs in turns (Triton, CUDA, CUDA, Triton) and the
        # library's call, all on the card alone
        for (R, C), name in BN_SHAPES if selected("K9") else ():
            x = torch.randn(R, C, generator=gen, device="cuda").to(dtype)
            dy = torch.randn(R, C, generator=gen, device="cuda").to(dtype)
            library = bn_library_calls(x, dy)
            for key, operands, fn, library_fn in (
                    ("K9", (x,), lambda impl: bn_stats_fwd(x, -1e30,
                                                           impl=impl),
                     library["fwd"]),
                    ("K10", (dy, x), lambda impl: bn_stats_bwd(
                        dy, x, -1e30, impl=impl), library["bwd"])):
                reads = len(operands)
                # the route that ran: the one whose launch count moved
                before = dict(bn_stats.route_launches)
                got = fn("kernel")
                taken = ",".join(k for k, n in bn_stats.route_launches.items()
                                 if n != before[k])
                want, again = fn("torch"), fn("kernel")
                torch.cuda.synchronize()
                abs_err = max(float((g - w_).abs().max())
                              for g, w_ in zip(got, want))
                rel_err = max(float((g - w_).abs().max())
                              / (float(w_.abs().max()) + 1e-9)
                              for g, w_ in zip(got, want))
                repeats = all(torch.equal(g, a) for g, a in zip(got, again))

                def triton():
                    return bn_stats._launch_triton(reads - 1, operands,
                                                   -1e30)

                turns = [device_ms(f, 10)
                         for f in (triton, lambda: fn("kernel"),
                                   lambda: fn("kernel"), triton)]
                row = {"kernel": key, "case": name, "dtype": dname,
                       "per_frame": 1, "max_abs_err": abs_err,
                       "max_rel_err": rel_err, "route": taken,
                       "repeats_bit_equal": repeats,
                       # the tool's shapes are whole 16-byte vectors a row:
                       # the CUDA kernel's, never Triton's
                       "ok": rel_err <= BN_TOL and repeats and taken == "cuda"
                       and all(bool(torch.isfinite(g).all()) for g in got),
                       "ms": time_ms(lambda: fn("kernel"), 10),
                       "device_ms": (turns[1] + turns[2]) / 2,
                       "turns_device_ms": turns,
                       "triton_device_ms": (turns[0] + turns[3]) / 2,
                       "plain_ms": time_ms(lambda: fn("torch"), 5),
                       "library_ms": time_ms(library_fn, 10),
                       "library_device_ms": device_ms(library_fn, 10),
                       "launch_device_ms": kernel_device_ms(
                           lambda: fn("kernel"), 10)}
                if R * C * x.element_size() * reads < L2_BYTES:
                    # the inputs fit L2: read once more from device memory,
                    # a write of twice L2 before each call
                    row["flushed_device_ms"] = timing.device_ms(
                        lambda: fn("kernel"), 10, flush_bytes=2 * L2_BYTES)
                    row["library_flushed_device_ms"] = timing.device_ms(
                        library_fn, 10, flush_bytes=2 * L2_BYTES)
                # max, cast, add and multiply-add per element, f32 units
                row.update(flops.bound(*flops.bn_stats_work(
                    R, C, reads, x.element_size()), "float32"))
                row["gb_per_s"] = reads * R * C * x.element_size() / row[
                    "device_ms"] / 1e6
                details.append(row)
                if not row["ok"]:
                    failures.append(row)
            del x, dy, library
            torch.cuda.empty_cache()

        def k2_draws(make, q_win, k_win, heads, scale, grid):
            """One K2 row over fresh draws (the first from the shared
            generator, the timed one; the rest from K2's own, so no other
            row's inputs move), each held to compare_k2, then head 0 of
            the attention dropped in the plain chain on the first draw:
            (the draws' checks, the fault's check, the first draw's
            operands and kernel output)."""
            draws = []
            for d in range(K2_DRAWS[dname]):
                x, we, ce, key, val, params, mlp, post_ln = make(
                    gen if d == 0 else k2_gen)
                # packed once, as the model packs its weights once
                args = (x, we, ce, key, val,
                        pack_params(params, mlp, post_ln, dtype), q_win,
                        k_win, heads, scale)
                got = fused_cross_view_attention(*args, add_skip=True,
                                                 impl="kernel",
                                                 grid_keys=grid)
                want = cross_view_attention_reference(
                    *args, add_skip=True, grid_keys=grid)
                mag = k2_scale(*args, grid)
                draws.append(compare_k2(got, want, mag, dname))
                if d == 0:
                    first = (args, got, mag)
                del x, we, ce, key, val, params, mlp, post_ln, args, want
            args, got, mag = first
            faulted = k2_reference(
                *args[:6], tuple(q_win), tuple(k_win), heads, scale, True,
                grid, attention=lambda q, k, v: k2_drop_head(
                    packed_attention_rounded(q, k, v, heads, dtype), heads))
            return draws, compare_k2(got, faulted, mag, dname), args, got

        def k2_draw_fields(draws, fault):
            ratios = sorted(r["ratio"] for r in draws)
            return {"max_abs_err": max(r["abs_err"] for r in draws),
                    "max_rel_err": max(r["rel_err"] for r in draws),
                    "draws": len(draws), "ratio_max": ratios[-1],
                    "ratio_median": ratios[len(ratios) // 2],
                    "ratio_plain_max": max(r["ratio_plain"] for r in draws),
                    "fault_ratio": fault["ratio"],
                    "ok": ratios[-1] <= 1.0 and fault["ratio"] > 1.0}

        def k2_log(row):
            log(f"K2 {row['case']} {dname}: {row['draws']} draws, worst "
                f"|kernel - plain| / bound {row['ratio_max']:.3f} (median "
                f"{row['ratio_median']:.3f}), head 0 dropped "
                f"{row['fault_ratio']:.2f}; the |plain| rule alone: worst "
                f"{row['ratio_plain_max']:.3f}")

        # CorpBEVT's 5 agents, then one SinBEVT-OPV2V vehicle
        for B, case in ([(B, c) for B in (K2_B, K2_SINBEVT_B)
                         for c in K2_CASES] if selected("K2") else ()):
            _, _, _, q_win, k_win, embed, _, grid = case
            draws, fault, args, got = k2_draws(
                lambda g: k2_inputs(case, dtype, g, B), (q_win, q_win),
                (k_win, k_win), K2_HEADS, (K2_DIM // K2_HEADS) ** -0.5, grid)

            def xattn(impl):
                return fused_cross_view_attention(
                    *args, add_skip=True, impl=impl, grid_keys=grid)

            row = {"kernel": "K2", "dtype": dname,
                   "route": k2_kernel_path(dtype, K2_DIM, K2_DIM, K2_HEADS,
                                           2 * K2_DIM,
                                           K2_CAMS if embed else 1),
                   **k2_draw_fields(draws, fault),
                   "ms": time_ms(lambda: xattn("kernel"), 5),
                   "plain_ms": time_ms(lambda: xattn("torch"), 5),
                   "device_ms": device_ms(lambda: xattn("kernel"), 5),
                   "launch_device_ms": kernel_device_ms(
                       lambda: xattn("kernel"), 5)}
            if B == K2_B:
                row.update(case=case[0], per_frame=1)
            else:
                repeats = all(torch.equal(xattn("kernel"), got)
                              for _ in range(NUSC_REPEATS))
                row.update(case=f"sinbevt_{case[0]}", per_frame=0,
                           per_sinbevt_opv2v_frame=1,
                           repeats_bit_equal=repeats,
                           ok=row["ok"] and repeats)
            H, h = case[1:3]
            row.update(flops.bound(*flops.k2_work(
                B, K2_CAMS, H, H, h, h, (q_win, q_win), (k_win, k_win),
                K2_DIM, K2_DIM, 2 * K2_DIM, embed, args[0].element_size()),
                dname))
            k2_log(row)
            details.append(row)
            if not row["ok"]:
                failures.append(row)
            del args, got
        for B, case in [(B, c) for B in K2_NUSC_BATCHES
                        for c in K2_NUSC_CASES] if selected("K2") else ():
            name, H, (h, w), q_win, k_win, D, heads, embed, post, grid = case
            n = K2_NUSC_CAMS
            draws, fault, args, got = k2_draws(
                lambda g: k2_branch_inputs(B, n, H, H, h, w, D, D, 2 * D,
                                           embed, post, dtype, g),
                q_win, k_win, heads, (D // heads) ** -0.5, grid)

            def xattn(impl):
                return fused_cross_view_attention(
                    *args, add_skip=True, impl=impl, grid_keys=grid)

            repeats = all(torch.equal(xattn("kernel"), got)
                          for _ in range(NUSC_REPEATS))
            row = {"kernel": "K2", "case": name if B == 1 else f"{name}_b{B}",
                   "dtype": dname, "batch": B, "per_frame": 0,
                   "per_nuscenes_frame": int(B == 1),
                   "per_nuscenes_fused_xattn_train_step": int(B > 1),
                   "route": k2_kernel_path(dtype, D, D, heads, 2 * D,
                                           n if embed else 1),
                   **k2_draw_fields(draws, fault),
                   "repeats_bit_equal": repeats,
                   "ms": time_ms(lambda: xattn("kernel"), 5),
                   "plain_ms": time_ms(lambda: xattn("torch"), 5),
                   "device_ms": device_ms(lambda: xattn("kernel"), 5),
                   "launch_device_ms": kernel_device_ms(
                       lambda: xattn("kernel"), 5)}
            row["ok"] = row["ok"] and repeats
            row.update(flops.bound(*flops.k2_work(
                B, n, H, H, h, w, q_win, k_win, D, D, 2 * D, embed,
                args[0].element_size()), dname))
            k2_log(row)
            details.append(row)
            if not row["ok"]:
                failures.append(row)
            del args, got
        for case in K4_CASES if selected("K4") else ():
            x, mask, am, bias, layers, head, w, heads = k4_inputs(
                case, dtype, gen)
            packed = pack(layers, bias, head, dtype)

            def fusion(impl):
                return fused_swap_fusion(x, mask, am, None, packed, None, w,
                                         heads, mean_over_valid=case[2],
                                         impl=impl)

            got, want = fusion("kernel"), fusion("torch")
            torch.cuda.synchronize()
            abs_err, rel_err, ok = compare(got, want, dname, K4_TOL)
            row = {"kernel": "K4", "case": case[0], "dtype": dname,
                   "per_frame": case[3], "max_abs_err": abs_err,
                   "max_rel_err": rel_err, "ok": ok,
                   "ms": time_ms(lambda: fusion("kernel"), 10),
                   "plain_ms": time_ms(lambda: fusion("torch"), 10),
                   # on the card alone
                   "device_ms": device_ms(lambda: fusion("kernel"), 10)}
            # each kind of launch alone (summed over the call's launches of
            # that kind), the launches one after the other: with their
            # programmatic overlap a kernel's time would include its wait
            # for the one ahead of it
            with k4_serial():
                row["serial_device_ms"] = device_ms(
                    lambda: fusion("kernel"), 10)
                row["launch_device_ms"] = kernel_device_ms(
                    lambda: fusion("kernel"), 5)
            row.update(k4_plan_fields(x, heads, packed.layers))
            row.update(flops.bound(*flops.fusion_work(
                *x.shape, w, heads, len(layers), layers[0][0]["w1"].shape[1],
                x.element_size(), x.element_size(), mask is not None),
                dname))
            details.append(row)
            if not ok:
                failures.append(row)
            del x, mask, am, bias, layers, head, packed, got, want
        for case in K6_CASES if selected("K6") else ():
            x, mask, am, bias, layers, head, w, heads = k6_inputs(
                case, dtype, gen)
            packed = pack(layers, bias, head, dtype, torch.float32)
            sublayers = 2 * case[1][7]

            def stream(impl):
                return fused_swap_fusion_streaming(
                    x, mask, am, None, packed, None, w, heads,
                    mean_over_valid=case[3], impl=impl)

            got, want = stream("kernel"), stream("torch")
            torch.cuda.synchronize()
            abs_err, rel_err, ok = compare(got, want, dname, K4_TOL)
            big = case[1] in (K6_LIDAR, K6_SECOND)
            row = {"kernel": "K6", "case": case[0], "dtype": dname,
                   "per_frame": case[4], "sublayers": sublayers,
                   "route": stream_kernel_path(case[1][4], heads,
                                               case[1][8], dtype),
                   "max_abs_err": abs_err, "max_rel_err": rel_err, "ok": ok}
            del want
            row["ms"] = time_ms(lambda: stream("kernel"), 3 if big else 10)
            # the sublayers' kernels alone, without the plain-PyTorch
            # pooling and head that the call ends with
            row["sublayers_ms"] = time_ms(
                lambda: _launch_streaming(x, mask, packed.bias, packed.layers,
                                          w, heads), 3 if big else 10)
            if big and (case[4] or case[1] == K6_SECOND) and \
                    dtype == torch.bfloat16:
                # the sublayers on the card alone, and each launch of them
                # alone (summed over the call's sublayers)
                row["sublayers_device_ms"] = device_ms(
                    lambda: _launch_streaming(x, mask, packed.bias,
                                              packed.layers, w, heads), 3)
                row["launch_device_ms"] = kernel_device_ms(
                    lambda: _launch_streaming(x, mask, packed.bias,
                                              packed.layers, w, heads), 2)
                # a second call gives the same bits
                row["repeats_bit_equal"] = torch.equal(stream("kernel"), got)
                row["ok"] = ok and row["repeats_bit_equal"]
            row["plain_ms"] = time_ms(lambda: stream("torch"),
                                      2 if big else 10, warmup=1)
            row.update(flops.bound(*flops.fusion_work(
                *case[1], x.element_size(), 4), dname))
            details.append(row)
            if not row["ok"]:
                failures.append(row)
            del x, mask, am, bias, layers, head, packed, got
            torch.cuda.empty_cache()
        for case in K5_CASES + K5_NUSC_CASES if selected("K5") else ():
            name, G, Tq, Tk, has_bias, has_mask, per_step = case[:7]
            heads, per_lidar_step = case[7:9] if len(case) > 7 else (
                K1_HEADS, 0)
            # the nuScenes rows draw from a generator of their own, so the
            # rows before them keep their inputs
            nusc = len(case) > 9
            draw = nusc_gen if nusc else gen
            q, k, v, bias, mask, _ = k1_inputs(
                (name, G, Tq, Tk, has_bias, has_mask, False), dtype, draw,
                heads)
            g = torch.randn(G, Tq, heads * K1_HEAD_DIM, generator=draw,
                            device="cuda").to(dtype)
            out = fused_window_attention_packed(q, k, v, heads, bias, mask,
                                                impl="kernel")
            # at a nuScenes train step's windows (G 800, 200, 8) K1 is held
            # here against its plain forward, and the plain backward takes
            # the plain output: a wrong K1 output fails the row instead of
            # feeding both backwards alike
            plain_out = fused_window_attention_packed(
                q, k, v, heads, bias, mask, impl="torch") if nusc else out
            fwd_errs = {}
            if nusc:
                fwd_errs["k1_out"] = compare(out, plain_out, dname)

            def bwd(impl):
                return fused_window_attention_packed_bwd(
                    q, k, v, g, out if impl == "kernel" else plain_out, heads,
                    bias, mask, impl=impl)

            got, want = bwd("kernel"), bwd("torch")
            # a second call gives the same bits, dbias included: one writer
            # an entry, window order in a chunk, chunks added in order
            repeats = all((a is None and b is None) or torch.equal(a, b)
                          for a, b in zip(got, bwd("kernel")))
            # the train step's path in bf16: K1 wrote the row statistics in
            # the forward, so K5 skips its own statistics sweep
            stats = fed = None
            if dtype == torch.bfloat16:
                stats = stats_scratch(G, heads, Tq, "cuda")
                stats_out = _launch_k1(q, k, v, heads, bias, mask, None,
                                       stats)
                if nusc:   # K1 writing the statistics at the padded pitch
                    fwd_errs["k1_stats_out"] = compare(stats_out, plain_out,
                                                       dname)
                del stats_out

                def bwd_fed():
                    return _launch_bwd_kernel(q, k, v, g, out, heads, bias,
                                              mask, stats)

                fed = bwd_fed()
                repeats = repeats and all(
                    (a is None and b is None) or torch.equal(a, b)
                    for a, b in zip(fed, bwd_fed()))
            torch.cuda.synchronize()
            errs = {}
            ok = repeats and all(e[2] for e in fwd_errs.values())
            for part, a, b in zip(("dq", "dk", "dv", "dbias"),
                                  fed or got, want):
                if (a is None) != (b is None) or (a is None) != (
                        part == "dbias" and bias is None):
                    raise AssertionError(f"K5 {name}: {part} presence")
                if a is not None:
                    abs_err, rel_err, part_ok = compare_scaled(a, b, dname)
                    errs[part] = (abs_err, rel_err)
                    ok = ok and part_ok
            iters = 3 if G * Tq * Tk > 5e7 else 10
            chunks, wpc, part_bytes = dbias_plan(G, heads, Tq, Tk, dtype)
            row = {"kernel": "K5", "case": name, "dtype": dname,
                   "per_frame": per_step, "heads": heads,
                   "per_lidar_step": per_lidar_step,
                   "repeats_bit_equal": repeats,
                   "dbias_chunks": [chunks, wpc] if has_bias else None,
                   "dbias_partial_bytes": part_bytes if has_bias else 0,
                   "blocks": sum(bwd_tile_plan(G, heads, Tq, Tk)[1:]),
                   "max_abs_err": max(e[0] for e in errs.values()),
                   "max_rel_err": max(e[1] for e in errs.values()),
                   "errors": {k_: list(e) for k_, e in errs.items()},
                   "ok": ok, "ms": time_ms(lambda: bwd("kernel"), iters)}
            if fwd_errs:
                row["k1_errors"] = {k_: list(e) for k_, e in fwd_errs.items()}
            if fed is not None:
                # K5 alone with its own statistics sweep (the public
                # wrapper), then fed by K1's statistics: what a train step
                # launches; K1 without and with writing them
                for part, a, b in zip(("dq", "dk", "dv", "dbias"), got,
                                      want):
                    if a is not None:
                        row["ok"] = ok = ok and compare_scaled(a, b,
                                                               dname)[2]
                row["standalone_ms"] = row["ms"]
                row["standalone_device_ms"] = device_ms(
                    lambda: bwd("kernel"), iters)
                row["standalone_launch_device_ms"] = kernel_device_ms(
                    lambda: bwd("kernel"), iters)
                row["ms"] = time_ms(bwd_fed, iters)
                row["k1_device_ms"] = device_ms(
                    lambda: _launch_k1(q, k, v, heads, bias, mask, None),
                    iters)
                row["k1_stats_device_ms"] = device_ms(
                    lambda: _launch_k1(q, k, v, heads, bias, mask, None,
                                       stats), iters)
            del want
            row["plain_ms"] = time_ms(lambda: bwd("torch"), 2, warmup=1)
            row.update(flops.bound(*flops.k5_work(q, k, v, g, out, heads,
                                                  bias, mask), dname))
            # library yardstick: forward + backward of one
            # scaled_dot_product_attention call, less its forward
            leaves = [_packed_to_4d(t, heads).contiguous().requires_grad_()
                      for t in (q, k, v)]
            add = sdpa_mask(bias, mask, dtype, heads)
            if add is not None and bias is not None:
                add = add.requires_grad_()
            g4 = _packed_to_4d(g, heads).contiguous()

            wrt = leaves + ([add] if add is not None and bias is not None
                            else [])

            def sdpa(backward):
                o = F.scaled_dot_product_attention(*leaves, attn_mask=add,
                                                   scale=1.0)
                if backward:
                    torch.autograd.grad(o, wrt, g4)

            # both on the card alone: the host's autograd bookkeeping would
            # otherwise pace the small shapes (PERF.md §6)
            row["library_ms"] = max(
                device_ms(lambda: sdpa(True), iters)
                - device_ms(lambda: sdpa(False), iters), 0.0)
            timed = bwd_fed if fed is not None else (lambda: bwd("kernel"))
            row["device_ms"] = device_ms(timed, iters)
            row["launch_device_ms"] = kernel_device_ms(timed, iters)
            if len(case) > 9:
                # a nuScenes train step's shapes: its launches a step
                row.update(case[9])
            details.append(row)
            if not ok:
                failures.append(row)
            del q, k, v, g, out, plain_out, bias, mask, got, leaves, add, g4
            del wrt, stats, fed
        for name, N, D, M, per_pass in FFD_CASES if selected("K11") else ():
            operands = make_operands(N, D, M, dtype, torch.device("cuda"))
            x, gamma, beta, w1, b1, w2, b2 = operands
            dy = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
            iters = 3 if dtype == torch.float32 and N > 10000 else 10

            def ffd(impl):
                with torch.no_grad():
                    return fused_ffd(*operands, impl=impl)

            def ffd_bwd(impl):
                return fused_ffd_bwd(x, dy, gamma, beta, w1, b1, w2,
                                     impl=impl)

            got, want = ffd("kernel"), ffd("torch")
            torch.cuda.synchronize()
            abs_err, rel_err, ok = compare(got, want, dname)
            route = ffd_kernel_path(N, D, M, dtype)

            def lib_fwd_call():
                with torch.no_grad():
                    return ref_ffd(*operands)

            lib_fwd = time_ms(lib_fwd_call, iters)
            lib_fwd_device = device_ms(lib_fwd_call, iters)
            row = {"kernel": "K11", "case": name, "dtype": dname,
                   "route": route,
                   "per_frame": per_pass, "max_abs_err": abs_err,
                   "max_rel_err": rel_err, "ok": ok,
                   "ms": time_ms(lambda: ffd("kernel"), iters),
                   "device_ms": device_ms(lambda: ffd("kernel"), iters),
                   "launch_device_ms": kernel_device_ms(
                       lambda: ffd("kernel"), iters),
                   "plain_ms": time_ms(lambda: ffd("torch"), iters),
                   # no one call computes the sublayer: the chain of library
                   # calls (layer_norm, two products, gelu, add)
                   "library_ms": lib_fwd,
                   "library_device_ms": lib_fwd_device}
            row.update(flops.bound(*flops.k11_work(*operands), dname))
            details.append(row)
            if not ok:
                failures.append(row)
            del got, want
            got, want = ffd_bwd("kernel"), ffd_bwd("torch")
            again = ffd_bwd("kernel")
            torch.cuda.synchronize()
            errs = {}
            ok = all(torch.equal(a, b) for a, b in zip(got, again))
            for part, a, b in zip(("dx", "dgamma", "dbeta", "dw1", "db1",
                                   "dw2", "db2"), got, want):
                abs_err, rel_err, part_ok = compare_scaled(a, b, dname)
                errs[part] = (abs_err, rel_err)
                ok = ok and part_ok
            row = {"kernel": "K12", "case": name, "dtype": dname,
                   "route": route, "per_frame": per_pass,
                   "max_abs_err": max(e[0] for e in errs.values()),
                   "max_rel_err": max(e[1] for e in errs.values()),
                   "errors": {k_: list(e) for k_, e in errs.items()},
                   "ok": ok, "ms": time_ms(lambda: ffd_bwd("kernel"), iters),
                   "device_ms": device_ms(lambda: ffd_bwd("kernel"), iters),
                   "launch_device_ms": kernel_device_ms(
                       lambda: ffd_bwd("kernel"), iters)}
            del want, again
            row["plain_ms"] = time_ms(lambda: ffd_bwd("torch"), 2, warmup=1)
            # five products of 2 N D M: h, da, dt, dW1, dW2
            row.update(flops.bound(*flops.k12_work(x, dy, gamma, beta, w1, b1,
                                                   w2), dname))
            # library yardstick: autograd over the chain of library calls,
            # forward + backward less its forward
            leaves = [t.clone().requires_grad_() for t in operands]

            def chain():
                for t in leaves:
                    t.grad = None
                ref_ffd(*leaves).backward(dy)

            row["library_ms"] = max(time_ms(chain, iters) - lib_fwd, 0.0)
            # both on the card alone
            row["library_device_ms"] = max(
                device_ms(chain, iters) - lib_fwd_device, 0.0)
            details.append(row)
            if not ok:
                failures.append(row)
            del operands, x, w1, w2, dy, got, leaves
            torch.cuda.empty_cache()
        for case in K8_CASES if selected("K8") else ():
            name, G, Tq, Tk, has_bias, has_mask = case
            q, k, v, bias, mask, _ = k1_inputs(
                (name, G, Tq, Tk, has_bias, has_mask, False), dtype, gen)
            q, k, v = (_packed_to_4d(t, K1_HEADS).contiguous()
                       for t in (q, k, v))
            if bias is not None:
                bias = bias.reshape(Tq, K1_HEADS, Tk).permute(
                    1, 0, 2).contiguous()

            def hm(impl):
                return fused_window_attention(q, k, v, bias, mask, impl=impl)

            got, want = hm("kernel"), hm("torch")
            torch.cuda.synchronize()
            abs_err, rel_err, ok = compare(got, want, dname)
            iters = 3 if G * Tq * Tk > 5e7 else 10
            add = sdpa_mask(None, mask, dtype)
            if bias is not None:
                add = bias[None].to(dtype) if add is None else \
                    add + bias[None].to(dtype)
            def sdpa_hm():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=add,
                                                      scale=1.0)

            row = {"kernel": "K8", "case": name, "dtype": dname,
                   "per_frame": 1, "max_abs_err": abs_err,
                   "max_rel_err": rel_err, "ok": ok,
                   "ms": time_ms(lambda: hm("kernel"), iters),
                   "device_ms": device_ms(lambda: hm("kernel"), iters),
                   "plain_ms": time_ms(lambda: hm("torch"), iters),
                   "library_ms": time_ms(sdpa_hm, iters),
                   "library_device_ms": device_ms(sdpa_hm, iters)}
            row.update(flops.bound(*flops.k8_work(q, k, v, bias, mask),
                                   dname))
            details.append(row)
            if not ok:
                failures.append(row)
            del q, k, v, bias, mask, got, want, add
    for r in details:
        extra = f"  library={r['library_ms']:.3f} ms" \
            if r.get("library_ms") is not None else ""
        if "k3_ms" in r:
            extra += (f"  kernel alone={r['launch_ms']:.3f} ms (on the card "
                      f"alone {r['alone_device_ms']:.4f})  K3 on the "
                      f"same inputs={r['k3_ms']:.3f} ms (on the card alone "
                      f"{r['k3_device_ms']:.3f})")
        elif r["kernel"] == "K3":
            extra += (f"  [{r['path']}] kernel alone={r['launch_ms']:.3f} ms"
                      f"  weight packed every call={r['unpacked_ms']:.3f} ms")
            if "l2_bytes" in r:
                extra += (f"  L2 operand traffic {r['l2_bytes'] / 1e6:.0f} MB"
                          f"  {K3_REPEATS} repeats bit-equal: "
                          f"{r['repeats_bit_equal']}")
        if "device_ms" in r:
            extra += f"  on the card alone: kernel={r['device_ms']:.4f} ms"
            if "library_device_ms" in r:
                extra += f" library={r['library_device_ms']:.4f} ms"
            if "serial_device_ms" in r:
                extra += (f" (launches one after the other: "
                          f"{r['serial_device_ms']:.4f} ms)")
        if "triton_device_ms" in r:
            extra += ("  alone in turns (Triton, CUDA, CUDA, Triton): "
                      + ", ".join(f"{v_:.4f}" for v_ in r["turns_device_ms"])
                      + f"  repeats bit-equal: {r['repeats_bit_equal']}")
        if "flushed_device_ms" in r:
            extra += (f"  L2 flushed: kernel={r['flushed_device_ms']:.4f} "
                      f"library={r['library_flushed_device_ms']:.4f} ms")
        if "blocks" in r:
            extra += f"  {r['blocks']} blocks"
        if "route" in r:
            extra += f"  [{r['route']}]"
        if r["kernel"] == "K5":
            extra += f"  repeats bit-equal: {r['repeats_bit_equal']}"
            if r["dbias_chunks"]:
                extra += (f"  dbias {r['dbias_chunks'][0]} chunks of "
                          f"{r['dbias_chunks'][1]} windows, partials "
                          f"{r['dbias_partial_bytes'] / 1e6:.1f} MB")
        if "launch_device_ms" in r:
            extra += "  launches alone: " + ", ".join(
                f"{k_} {v_:.4f}" for k_, v_ in r["launch_device_ms"].items())
        if "standalone_device_ms" in r:
            extra += (f"  [fed by K1's statistics; K5 alone with its own: "
                      f"{r['standalone_ms']:.3f} ms, on the card alone "
                      f"{r['standalone_device_ms']:.4f} ("
                      + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in
                                  r["standalone_launch_device_ms"].items())
                      + f"); K1 on the card alone {r['k1_device_ms']:.4f} "
                      f"ms, writing them {r['k1_stats_device_ms']:.4f}]")
        if "gb_per_s" in r:
            extra += f"  {r['gb_per_s']:.0f} GB/s"
        log(f"{r['kernel']} {r['case']:<28} {r['dtype']:<8} "
            f"abs={r['max_abs_err']:.2e} rel={r['max_rel_err']:.2e} "
            f"{'ok ' if r['ok'] else 'BAD'} kernel={r['ms']:.3f} ms "
            f"plain={r['plain_ms']:.3f} ms bound={r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){extra}")
        if r["kernel"] == "K6":
            n = r["sublayers"]
            log(f"   the {n} sublayers' kernels alone: "
                f"{r['sublayers_ms']:.3f} ms, {r['sublayers_ms'] / n:.3f} ms "
                f"each; pooling and head: "
                f"{r['ms'] - r['sublayers_ms']:.3f} ms; a {n}th of the "
                f"call: kernel={r['ms'] / n:.3f} ms "
                f"plain={r['plain_ms'] / n:.3f} ms "
                f"bound={r['bound_ms'] / n:.4f} ms")
            if "sublayers_device_ms" in r:
                log(f"   on the card alone: the {n} sublayers "
                    f"{r['sublayers_device_ms']:.3f} ms (by launch above, "
                    f"summed over them); a second call bit for bit: "
                    f"{r['repeats_bit_equal']}")
    k7 = [r for r in details if r["kernel"] == "K7"
          and r["dtype"] == "bfloat16" and r["per_frame"]]
    if k7:
        def frame(field):
            return sum(r[field] * r["per_frame"] for r in k7)
        log(f"K7, the {sum(r['per_frame'] for r in k7)} calls of an int8 "
            f"frame (bf16): with the wrapper {frame('ms'):.3f} ms (on the "
            f"card alone {frame('device_ms'):.3f}), the kernel alone "
            f"{frame('launch_ms'):.3f} ms (on the card alone "
            f"{frame('alone_device_ms'):.3f}), bound "
            f"{frame('bound_ms'):.4f} ms, cuDNN bf16 "
            f"{frame('library_ms'):.3f} ms")
    s8 = [r for r in details if r["kernel"] == "S8"
          and r["dtype"] == "bfloat16" and r["per_frame"]]
    if s8:
        def s8_frame(field):
            return sum(r[field] * r["per_frame"] for r in s8)
        log(f"S8, the {sum(r['per_frame'] for r in s8)} convs of an int8 "
            f"frame (bf16 exit): {s8_frame('ms'):.3f} ms (on the card alone "
            f"{s8_frame('device_ms'):.3f}), bound "
            f"{s8_frame('bound_ms'):.4f} ms, cuDNN bf16 "
            f"{s8_frame('library_ms'):.3f} ms (on the card alone "
            f"{s8_frame('library_device_ms'):.3f})")
    if failures:
        raise AssertionError(f"{len(failures)} kernel cases disagree with "
                             f"their plain versions: "
                             f"{[(r['case'], r['dtype']) for r in failures]}")
    return details


SWITCHES = ("COBEVT_FUSED_XATTN", "COBEVT_FUSED_FUSION")


@contextlib.contextmanager
def switches(value):
    """Both fusion switches unset (None: the serving default) or set to
    ``value`` inside the block."""
    old = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        if value is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = value
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def serve_path(name, runner, frames, cfg, rng, per_frame, check):
    """Serve ``frames`` with every launch count set to 0 just before and
    read just after; raise unless each kernel ran ``per_frame`` launches
    in every frame (bucket warmups included)."""
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.tools import serve_camera
    calls = []

    def counted(batch):
        calls.append(1)
        return runner(batch)

    ops.reset_launch_counts()
    summary = serve_camera.serve(counted, frames, cfg, rng, on_output=check)
    counts = ops.launch_counts()
    log(f"{name}: served {summary['frames']} requests ({len(calls)} frames "
        f"with the bucket warmups); launches {counts}, per frame "
        f"{ {k: c / len(calls) for k, c in counts.items()} }")
    for i, (ms, (n, _)) in enumerate(zip(summary["frame_ms"], frames)):
        log(f"  request {i}: {n} agents, {ms:.2f} ms")
    log(f"{name} summary " + json.dumps(
        {k: v for k, v in summary.items() if k != "frame_ms"}))
    for fn, n in per_frame.items():
        if counts[fn] != n * len(calls):
            raise AssertionError(f"{name}: {fn} ran {counts[fn]} launches "
                                 f"over {len(calls)} frames, expected {n} "
                                 f"each")
    return counts, summary


def serving_setup(seed, agents):
    """Full-width CorpBEVT in bf16 with seeded weights behind the staged
    runner, one synthetic request per entry of ``agents``, and the check
    every answer must pass: (cfg, model, rng, frames, runner, check)."""
    import numpy as np
    import torch
    from cobevt_tpu_torch.configs.presets import corpbevt_default
    from cobevt_tpu_torch.models.corpbevt import CorpBEVT
    from cobevt_tpu_torch.tools import serve_camera
    from cobevt_tpu_torch.utils.serving import StagedBucketedRunner
    from cobevt_tpu_torch.utils.weights import seeded_init_

    cfg = corpbevt_default()
    model = CorpBEVT(cfg)
    seeded_init_(model, seed)
    model = model.to("cuda", torch.bfloat16).eval()
    rng = np.random.RandomState(seed)
    frames = [(n, serve_camera.synthetic_frame(rng, cfg, n)) for n in agents]
    runner = StagedBucketedRunner(model, cfg.max_cav)

    def check(i, n, out):
        seg = out["dynamic_seg"]
        if tuple(seg.shape) != (1, 1, 256, 256, cfg.output_class):
            raise AssertionError(f"frame {i}: dynamic_seg {tuple(seg.shape)}")
        if not torch.isfinite(seg).all():
            raise AssertionError(f"frame {i} ({n} agents): non-finite logits")

    return cfg, model, rng, frames, runner, check


def phase_slice(seed=0):
    """Full-width CorpBEVT serving on the fused path (the default), one
    frame against the f32 plain path, then the stock path."""
    import numpy as np
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.tools import serve_camera
    from cobevt_tpu_torch.utils.serving import StagedBucketedRunner

    log("== slice: CorpBEVT 5 agents x 4 cameras x 512^2, BEV 256^2, bf16, "
        "fused path (switches unset)")
    cfg, model, rng, frames, runner, check = serving_setup(seed, SERVE_AGENTS)
    frame = frames[0][1]
    with switches(None):
        counts, summary = serve_path("fused path", runner, frames, cfg, rng,
                                     FUSED_PER_FRAME, check)
        # A/B context: the same requests through the plain versions, bf16
        with ops.forced_impl("torch"):
            plain = serve_camera.serve(runner, frames, cfg, rng,
                                       on_output=check)
        log("plain-version summary " + json.dumps(
            {k: v for k, v in plain.items() if k != "frame_ms"}))
        # reference: one 5-agent frame, plain versions, f32, same weights
        out = runner(frame)["dynamic_seg"].float().cpu().numpy()
        ref_model = copy.deepcopy(model).float()
        with ops.forced_impl("torch"):
            ref = StagedBucketedRunner(ref_model, cfg.max_cav)(frame)
        ref = ref["dynamic_seg"].cpu().numpy()
        del ref_model
    iou = argmax_iou(out, ref)
    agree = float((out.argmax(-1) == ref.argmax(-1)).mean())
    rel = float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12))
    frac = np.bincount(ref.argmax(-1).ravel(),
                       minlength=cfg.output_class) / ref[..., 0].size
    log(f"bf16 kernels vs f32 plain, one 5-agent frame: argmax IoU {iou:.5f}"
        f", agreement {agree:.5f}, max rel logit err {rel:.3e}, "
        f"reference class shares {np.round(frac, 4).tolist()}")
    if iou < IOU_FLOOR:
        raise AssertionError(f"argmax IoU {iou:.4f} < {IOU_FLOOR}")

    log("== stock path: COBEVT_FUSED_XATTN=0 COBEVT_FUSED_FUSION=0, bf16")
    with switches("0"):
        stock_counts, stock = serve_path(
            "stock path", runner, [frames[SERVE_AGENTS.index(n)]
                                   for n in STOCK_AGENTS],
            cfg, rng, STOCK_PER_FRAME, check)
        stock_out = runner(frame)["dynamic_seg"].float().cpu().numpy()
    stock_iou = argmax_iou(out, stock_out)
    log(f"fused vs stock path, bf16, one 5-agent frame: argmax IoU "
        f"{stock_iou:.5f}")
    if stock_iou < IOU_FLOOR:
        raise AssertionError(f"fused vs stock argmax IoU {stock_iou:.4f} < "
                             f"{IOU_FLOOR}")
    return counts, summary, plain, {
        "argmax_iou": iou, "agreement": agree, "max_rel_logit_err": rel,
        "fused_vs_stock_argmax_iou": stock_iou,
        "stock_counts": stock_counts, "stock_serve": stock}


def phase_train(seed=0):
    """A few optimizer steps at corpbevt.yaml width in bf16 through the
    code of tools/benchmark.py, with exact launch counts per step, then the
    K1 + K5 against stock-autograd gradient gate."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.tools import benchmark, validate_kernels

    log("== train: CorpBEVT 5 agents x 4 cameras x 512^2, BEV 256^2, bf16 "
        "compute, f32 master parameters, B 1")
    opt = benchmark.parse_args(["--train", "--iters", str(TRAIN_STEPS),
                                "--warmup", "1", "--seed", str(seed)])
    device = torch.device("cuda", torch.cuda.current_device())
    model, batch, _ = benchmark.build_corpbevt(opt.max_cav, opt.seed, device)
    ops.reset_launch_counts()
    row = benchmark.measure_train(model, opt.model, batch, opt, device)
    counts = ops.launch_counts()
    log("train " + json.dumps(row))
    log(f"train launches over {TRAIN_STEPS} steps after one warmup step: "
        f"{counts}")
    for fn, n in TRAIN_PER_STEP.items():
        if counts[fn] != n * TRAIN_STEPS:
            raise AssertionError(f"train: {fn} ran {counts[fn]} launches over "
                                 f"{TRAIN_STEPS} steps, expected {n} each")
    import math
    if not (math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])):
        raise AssertionError(f"train: loss {row['loss']}, gradient norm "
                             f"{row['grad_norm']}")
    del model, batch
    torch.cuda.empty_cache()

    log("== gradient gate: K1 + K5 vs COBEVT_FLASH_BWD=0, one step, bf16")
    gate = validate_kernels.validate_train(device, bf16=True, seed=seed)
    log("gate " + json.dumps(gate))
    for fn in ("fused_window_attention_packed",
               "fused_window_attention_packed_bwd"):
        if gate["launches"][fn] != TRAIN_PER_STEP[fn]:
            raise AssertionError(f"gate: {fn} ran {gate['launches'][fn]}")
    if not gate["ok"]:
        raise AssertionError("gradient gate failed: " + json.dumps(gate))
    torch.cuda.empty_cache()

    log("== COBEVT_FUSED_XATTN_TRAIN: one training forward + backward with "
        "the switch on and off, bf16")
    from cobevt_tpu_torch.ops.dispatch import env_switches
    model, batch, _ = benchmark.build_corpbevt(opt.max_cav, seed, device)
    criterion, train_batch = benchmark.make_criterion("corpbevt", model,
                                                      batch)
    model = model.to(torch.bfloat16)
    xattn = {}
    for value in ("1", None):
        with env_switches(COBEVT_FUSED_XATTN_TRAIN=value):
            ops.reset_launch_counts()
            loss, gnorm, _ = validate_kernels.loss_and_grad_norms(
                model, criterion, train_batch, seed)
            xattn[value] = {"loss": loss, "grad_norm": gnorm,
                            "launches": ops.launch_counts()}
    on, off = xattn["1"], xattn[None]
    log("fused_xattn_train " + json.dumps({"on": on, "off": off}))
    k2 = "fused_cross_view_attention"
    if on["launches"][k2] != FUSED_PER_FRAME[k2] or off["launches"][k2] != 0:
        raise AssertionError(f"K2 launches with the switch on "
                             f"{on['launches'][k2]}, off {off['launches'][k2]}")
    for key in ("loss", "grad_norm"):
        rel = abs(on[key] - off[key]) / (abs(off[key]) + 1e-9)
        if not rel <= validate_kernels.BUDGET_SCALAR:
            raise AssertionError(f"COBEVT_FUSED_XATTN_TRAIN: {key} moved by "
                                 f"{rel:.3e}")
    del model, batch, train_batch
    torch.cuda.empty_cache()
    gate["fused_xattn_train"] = {"on": on, "off": off}
    return counts, row, gate


def phase_k8(seed=0):
    """The head-major entry point as a caller uses it: forward and
    gradients through autograd at the self-attention and the fusion shape,
    against the plain version.  Returns the launch count."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.ops.window_attention import fused_window_attention

    log("== K8: fused_window_attention forward + gradients, bf16")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = torch.bfloat16
    ops.reset_launch_counts()
    for name, G, Tq, Tk, has_bias, has_mask in K8_CASES[::2]:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")

        q = (randn(G, K1_HEADS, Tq, K1_HEAD_DIM) * K1_HEAD_DIM ** -0.5).to(
            dtype)
        k = randn(G, K1_HEADS, Tk, K1_HEAD_DIM).to(dtype)
        v = randn(G, K1_HEADS, Tk, K1_HEAD_DIM).to(dtype)
        bias = randn(K1_HEADS, Tq, Tk) * 0.5 if has_bias else None
        mask = ((torch.rand(G, Tk, generator=gen, device="cuda") > 0.3)
                .float() if has_mask else None)
        g = randn(G, K1_HEADS, Tq, K1_HEAD_DIM).to(dtype)
        results = {}
        for impl in ("kernel", "torch"):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            b = None if bias is None else bias.clone().requires_grad_()
            out = fused_window_attention(*leaves, b, mask, impl=impl)
            out.backward(g)
            results[impl] = [out.detach()] + [t.grad for t in leaves] + (
                [] if b is None else [b.grad])
        torch.cuda.synchronize()
        for part, a, w in zip(("out", "dq", "dk", "dv", "dbias"),
                              results["kernel"], results["torch"]):
            abs_err, rel_err, ok = compare_scaled(a, w, "bfloat16")
            log(f"K8 {name} {part}: abs={abs_err:.2e} rel={rel_err:.2e} "
                f"{'ok' if ok else 'BAD'}")
            if not ok:
                raise AssertionError(f"K8 {name}: {part} disagrees")
    launches = ops.launch_counts()["fused_window_attention"]
    if launches != len(K8_CASES[::2]):
        raise AssertionError(f"K8 ran {launches} launches")
    return launches


def lidar_requests(model, batch, agents, expect, name):
    """Answer one request per entry of ``agents`` (that many live agents
    through ``agent_mask``, B 1), each timed on the host clock around a
    forward that ends in a synchronize, after one untimed warmup; the launch
    counts are set to 0 just before the counted requests and read just
    after.  Raises unless every frame ran exactly the ``expect`` launches
    and nothing else."""
    import numpy as np
    import torch
    from cobevt_tpu_torch import ops

    def request(n):
        live = dict(batch)
        live["agent_mask"] = batch["agent_mask"].clone()
        live["agent_mask"][:, n:] = 0.0
        return live

    def answer(req):
        with torch.no_grad():
            out = model(req)
        torch.cuda.synchronize()
        return out

    answer(request(agents[0]))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    frame_ms, outs = [], []
    for n in agents:
        req = request(n)
        t0 = time.perf_counter()
        out = answer(req)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        for key, shape in (("cls_preds", (1, 96, 176, 2)),
                           ("reg_preds", (1, 96, 176, 14))):
            if tuple(out[key].shape) != shape:
                raise AssertionError(f"{name}: {key} {tuple(out[key].shape)}")
            if not torch.isfinite(out[key]).all():
                raise AssertionError(f"{name} ({n} agents): non-finite {key}")
        outs.append(out)
    counts = ops.launch_counts()
    per_frame = {k: c / len(agents) for k, c in counts.items()}
    summary = {"frames": len(agents), "agents": list(agents),
               "frame_ms": frame_ms,
               "p50_ms": float(np.percentile(frame_ms, 50)),
               "min_ms": min(frame_ms), "max_ms": max(frame_ms),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"{name}: {len(agents)} requests, launches per frame "
        f"{ {k: v for k, v in per_frame.items() if v} }")
    log(f"{name} summary " + json.dumps(summary))
    for fn, c in counts.items():
        if c != expect.get(fn, 0) * len(agents):
            raise AssertionError(f"{name}: {fn} ran {c} launches over "
                                 f"{len(agents)} frames, expected "
                                 f"{expect.get(fn, 0)} each")
    return counts, summary, outs


def phase_lidar(seed=0):
    """Full-width cooperative LiDAR forward (PointPillar + FuseBEVT) through
    build_pointpillar of tools/benchmark.py: the default path (K6, as
    "force-stream"), the stock modules (COBEVT_FUSED_FUSION=0, K1), K6 vs
    stock and bf16 vs the f32 plain path within the budget of
    tools/validate_kernels.py, and the bit-for-bit repeat of one request."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.tools import benchmark, validate_kernels

    from cobevt_tpu_torch.ops.dispatch import env_switches

    log("== LiDAR: PointPillar + FuseBEVT, 5 agents x 8000 pillars x 32 "
        "points, grid 352 x 192, fused map 96 x 176 x 256, bf16")
    device = torch.device("cuda", torch.cuda.current_device())
    model, batch, _ = benchmark.build_pointpillar(5, seed, device)
    ref_model = copy.deepcopy(model).eval()            # f32, same weights
    model = model.to(torch.bfloat16).eval()
    lidar_map = (1, 5, 96, 176, 256)
    for value, want in ((None, "K6"), ("force-stream", "K6"), ("0", None)):
        with env_switches(COBEVT_FUSED_FUSION=value):
            kernel = model.fusion_net.fused_kernel(lidar_map)
        if kernel != want:
            raise AssertionError(f"COBEVT_FUSED_FUSION={value} dispatches "
                                 f"the LiDAR map to {kernel}, not {want}")
    budget = validate_kernels.BUDGET_FORWARD

    with switches(None):
        counts, fused, outs = lidar_requests(
            model, batch, LIDAR_AGENTS, LIDAR_FUSED_PER_FRAME,
            "default path (K6)")
        with torch.no_grad():
            again = model(batch)
        for key, t in outs[0].items():
            if not torch.equal(t, again[key]):
                raise AssertionError(f"two forwards of one request differ in "
                                     f"{key}")
        log("two forwards of the 5-agent request agree bit for bit")
        with ops.forced_impl("torch"), torch.no_grad():
            ref = ref_model(batch)
    del ref_model
    with env_switches(COBEVT_FUSED_FUSION="0"):
        stock_counts, stock, stock_outs = lidar_requests(
            model, batch, LIDAR_AGENTS, LIDAR_STOCK_PER_FRAME,
            "stock modules (COBEVT_FUSED_FUSION=0)")
    gates = [validate_kernels.compare_outputs(
        f"pointpillar_fused_vs_stock_{n}_agents", f, s, budget)
        for n, f, s in zip(LIDAR_AGENTS, outs, stock_outs)]
    gates.append(validate_kernels.compare_outputs(
        "pointpillar_bf16_kernels_vs_f32_plain", outs[0], ref, budget))
    for g in gates:
        log("gate " + json.dumps(g))
    bad = [g["component"] for g in gates if not g["ok"]]
    if bad:
        raise AssertionError(f"LiDAR gates failed: {bad}")
    torch.cuda.empty_cache()
    return counts, {"fused": fused, "stock": stock,
                    "stock_counts": stock_counts, "gates": gates}


def phase_int8(seed=0):
    """Full-width CorpBEVT served under COBEVT_INT8=1 on the fused path: the
    launch counts of every frame, the same requests in bf16 for the A/B, one
    frame with the int8-resident layer1 off, and the int8 gate of
    tools/validate_kernels.py against the stock bf16 path."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.ops.dispatch import env_switches
    from cobevt_tpu_torch.tools import benchmark, serve_camera, \
        validate_kernels

    log("== int8 serving: CorpBEVT 5 agents x 4 cameras x 512^2, bf16, "
        "COBEVT_INT8=1 on the fused path")
    cfg, model, rng, frames, runner, check = serving_setup(seed, INT8_AGENTS)
    with switches(None), env_switches(COBEVT_INT8="1",
                                      COBEVT_INT8_RESIDENT=None):
        counts, summary = serve_path("int8 path", runner, frames, cfg, rng,
                                     INT8_PER_FRAME, check)
        with env_switches(COBEVT_INT8_RESIDENT="0"):
            ops.reset_launch_counts()
            check(0, INT8_AGENTS[0], runner(frames[0][1]))
            torch.cuda.synchronize()
            lone = ops.launch_counts()
    log(f"COBEVT_INT8_RESIDENT=0, one 5-agent frame: launches {lone}")
    for fn, n in INT8_NOT_RESIDENT_PER_FRAME.items():
        if lone[fn] != n:
            raise AssertionError(f"COBEVT_INT8_RESIDENT=0: {fn} ran "
                                 f"{lone[fn]} launches, expected {n}")
    # the same requests without the switch, in the same call: the A/B
    with switches(None), env_switches(COBEVT_INT8=None):
        bf16 = serve_camera.serve(runner, frames, cfg, rng, on_output=check)
    log("bf16 fused path, same requests " + json.dumps(
        {k: v for k, v in bf16.items() if k != "frame_ms"}))
    # device operations of one 5-agent frame, int8 against bf16: with the
    # scale fold no K7 call reduces its input or computes its scales on the
    # side, so the int8 frame launches no more than the bf16 one
    ops_per_frame = {}
    for name, value in (("int8", "1"), ("bf16", None)):
        with switches(None), env_switches(COBEVT_INT8=value,
                                          COBEVT_INT8_RESIDENT=None):
            ops_per_frame[name] = benchmark.profile_steps(
                lambda: runner(frames[0][1]), 2, 1.0)["device_ops_per_step"]
    log(f"device operations of a 5-agent frame: {ops_per_frame}")
    if ops_per_frame["int8"] > ops_per_frame["bf16"]:
        raise AssertionError(f"the int8 frame makes more device operations "
                             f"than the bf16 frame: {ops_per_frame}")
    del model, runner, frames
    torch.cuda.empty_cache()

    device = torch.device("cuda", torch.cuda.current_device())
    gate = validate_kernels.validate_int8(device, bf16=True, seed=seed)
    log("gate " + json.dumps(gate))
    for fn in ("fused_conv3x3", "fused_conv3x3_int8", "conv3x3_s8"):
        if gate["launches"][fn] != INT8_PER_FRAME[fn]:
            raise AssertionError(f"int8 gate: {fn} ran "
                                 f"{gate['launches'][fn]} launches")
    if gate["saturation"]["blocks_sampled"] != 3:
        raise AssertionError("layer1 did not run int8-resident: "
                             + json.dumps(gate["saturation"]))
    if not gate["ok"]:
        raise AssertionError("int8 gate failed: " + json.dumps(gate))
    torch.cuda.empty_cache()
    return counts, {"serve": summary, "serve_bf16": bf16, "gate": gate,
                    "not_resident_counts": lone,
                    "device_ops_per_frame": ops_per_frame}


def phase_micro_bn_stats():
    """tools/micro_bn_stats.py at its four full shapes, as a user runs it;
    returns the launch counts of that run."""
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.ops import bn_stats
    from cobevt_tpu_torch.tools import micro_bn_stats

    log("== micro_bn_stats: K9 and K10 at the four shapes")
    ops.reset_launch_counts()
    before = dict(bn_stats.route_launches)
    rc = micro_bn_stats.main(["--iters", "10"])
    counts = ops.launch_counts()
    routes = {k: n - before[k] for k, n in bn_stats.route_launches.items()}
    if rc != 0:
        raise AssertionError(f"micro_bn_stats exited with {rc}")
    # every call of the run went through csrc/bn_stats.cu
    calls = counts["bn_stats_fwd"] + counts["bn_stats_bwd"]
    if routes != {"cuda": calls, "triton": 0}:
        raise AssertionError(f"micro_bn_stats: {calls} calls took the routes "
                             f"{routes}, expected all on cuda")
    return counts


def phase_lidar_train(seed=0):
    """A few optimizer steps of the full-width LiDAR model in bf16 through
    the code of tools/benchmark.py, with exact launch counts per step, then
    its gradient gate with the f32 gradient-truth check."""
    import math

    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.tools import benchmark, validate_kernels

    log("== LiDAR train: PointPillar + FuseBEVT, 5 agents x 8000 pillars, "
        "fused map 96 x 176 x 256, detection loss, bf16 compute, f32 master "
        "parameters, B 1")
    opt = benchmark.parse_args(["--train", "--model", "pointpillar",
                                "--iters", str(TRAIN_STEPS), "--warmup", "1",
                                "--seed", str(seed)])
    device = torch.device("cuda", torch.cuda.current_device())
    model, batch, _ = benchmark.build_pointpillar(opt.max_cav, opt.seed,
                                                  device)
    ops.reset_launch_counts()
    row = benchmark.measure_train(model, opt.model, batch, opt, device)
    counts = ops.launch_counts()
    log("lidar train " + json.dumps(row))
    log(f"lidar train launches over {TRAIN_STEPS} steps after one warmup "
        f"step: {counts}")
    for fn, n in counts.items():
        want = LIDAR_TRAIN_PER_STEP.get(fn, 0) * TRAIN_STEPS
        if n != want:
            raise AssertionError(f"lidar train: {fn} ran {n} launches over "
                                 f"{TRAIN_STEPS} steps, expected {want}")
    if not (math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])):
        raise AssertionError(f"lidar train: loss {row['loss']}, gradient norm "
                             f"{row['grad_norm']}")
    log(f"lidar train loss: first step {row['loss_first']:.4f}, after "
        f"{TRAIN_STEPS + 1} steps {row['loss']:.4f}")
    del model, batch
    torch.cuda.empty_cache()

    log("== LiDAR gradient gate: K1 + K5 vs COBEVT_FLASH_BWD=0, one step, "
        "bf16; f32 gradient truth at a small width")
    gate = validate_kernels.validate_train(device, bf16=True, seed=seed,
                                           model_name="pointpillar")
    gate["f32_truth"] = validate_kernels.gradient_truth(device, seed)
    log("lidar gate " + json.dumps(gate))
    for fn, n in LIDAR_TRAIN_PER_STEP.items():
        if gate["launches"][fn] != n:
            raise AssertionError(f"lidar gate: {fn} ran "
                                 f"{gate['launches'][fn]}")
    if not (gate["ok"] and gate["f32_truth"]["ok"]):
        raise AssertionError("LiDAR gradient gate failed: "
                             + json.dumps(gate))
    torch.cuda.empty_cache()
    return counts, row, gate


def phase_micro_ffd_fused():
    """tools/micro_ffd_fused.py at its full shape in bf16, as a user runs
    it; returns the launch counts of that run."""
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.tools import micro_ffd_fused

    log("== micro_ffd_fused: K11 + K12 against autograd, 84480 x 256 x 512")
    ops.reset_launch_counts()
    rc = micro_ffd_fused.main(["--iters", "10"])
    counts = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"micro_ffd_fused exited with {rc}")
    return counts


def sign_iou_report(name, got, ref, budget):
    """``tools/validate_kernels.py``'s comparison of two SinBEVT-nuScenes
    outputs: per output the largest deviation over the reference's largest
    value within ``budget``, and the sign-of-logit IoU on ``bev``."""
    from cobevt_tpu_torch.tools import validate_kernels as vk
    report = vk.compare_outputs(name, vk.sign_logits(got),
                                vk.sign_logits(ref), budget,
                                iou_keys=vk.SINBEVT_IOU_KEYS)
    report["centered_bev_iou"] = iou = vk.centered_sign_iou(got["bev"],
                                                            ref["bev"])
    report["ok"] = report["ok"] and iou >= vk.SINBEVT_CENTERED_IOU_FLOOR
    log(f"{name}: sign-of-logit IoU on bev "
        f"{report['argmax_iou']['bev']:.5f} (floor {report['iou_floor']}), "
        f"about the reference's median {iou:.5f} (floor "
        f"{vk.SINBEVT_CENTERED_IOU_FLOOR}), "
        f"max relative drift {report['max_rel']:.3e} (budget {budget}), "
        f"per output {json.dumps(report['outputs'])}")
    if not report["ok"]:
        raise AssertionError(f"{name}: " + json.dumps(report))
    return report


def serve_frames(name, model, frames, per_frame, check):
    """One eval forward of each batch in ``frames``, synchronised and
    checked, with every launch count set to 0 just before and read just
    after; raise unless each wrapper ran ``per_frame`` (0 where absent)
    launches a frame.  Returns (counts, host ms of each frame)."""
    import torch
    from cobevt_tpu_torch import ops
    ms = []
    ops.reset_launch_counts()
    for i, batch in enumerate(frames):
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(i, out)
    counts = ops.launch_counts()
    log(f"{name}: {len(frames)} frames, host ms "
        f"{[round(t, 2) for t in ms]}, launches {counts}")
    for fn, n in counts.items():
        if n != per_frame.get(fn, 0) * len(frames):
            raise AssertionError(f"{name}: {fn} ran {n} launches over "
                                 f"{len(frames)} frames, expected "
                                 f"{per_frame.get(fn, 0)} each")
    return counts, ms


def new_images(batch, key, count, seed):
    """``count`` copies of ``batch`` with fresh uniform images under
    ``key``, drawn on the card from ``seed``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [dict(batch, **{key: torch.rand(batch[key].shape, generator=gen,
                                           device="cuda")})
            for _ in range(count)]


def phase_sinbevt(seed=0):
    """Phase 13: SinBEVT-nuScenes (cvt_pyramid_axial_nuscenes_vehicle at
    full width) and SinBEVT-OPV2V serve frames on the default and the stock
    path with exact launch counts; the nuScenes frame against the f32 plain
    path and the stock frame, the forward gate at seeds 0-4 and its planted
    faults, and each model's frame time, device time, operations, idle share and peak
    memory through tools/benchmark.py."""
    import numpy as np
    import torch
    from cobevt_tpu_torch.ops.dispatch import forced_impl
    from cobevt_tpu_torch.tools import benchmark
    from cobevt_tpu_torch.tools import validate_kernels as vk
    t0 = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device())
    log("== phase 13: SinBEVT-nuScenes, EfficientNet-b4, 6 cameras x 224 x "
        "480, BEV 200^2, bev + center, bf16, seeded random weights")
    model, batch, key = benchmark.build_sinbevt(seed=seed, device=device)
    ref_model = copy.deepcopy(model).eval()
    model = model.eval().to(torch.bfloat16)
    frames = [batch] + new_images(batch, key, SINBEVT_FRAMES - 1, seed + 1)

    def check(i, out):
        for k in ("bev", "center"):
            if tuple(out[k].shape) != (1, 200, 200, 1):
                raise AssertionError(f"frame {i}: {k} {tuple(out[k].shape)}")
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"frame {i}: non-finite {k}")

    result = {}
    with switches(None):
        result["counts"], result["frame_ms"] = serve_frames(
            "nuScenes default path", model, frames, SINBEVT_PER_FRAME, check)
        with torch.no_grad():
            out = model(batch)
            with forced_impl("torch"):
                ref = ref_model(batch)
    del ref_model
    budget = vk.BUDGET_SINBEVT
    result["vs_f32_plain"] = sign_iou_report(
        "bf16 default vs f32 plain, one frame", out, ref, budget)
    with switches("0"):
        result["stock_counts"], result["stock_frame_ms"] = serve_frames(
            "nuScenes stock path (COBEVT_FUSED_XATTN=0)", model, frames[:2],
            SINBEVT_STOCK_PER_FRAME, check)
        with torch.no_grad():
            stock = model(batch)
    result["vs_stock"] = sign_iou_report(
        "bf16 default vs bf16 stock, one frame", out, stock, budget)
    result["bev_positive_share"] = float((ref["bev"] > 0).float().mean())
    del out, ref, stock

    # each FAX stage's device time on both paths (its two cross-view
    # branches as K2, or as the stock modules over K1), on the inputs it
    # gets in the frame: the sum of its kernels' times (torch.profiler),
    # which the host's enqueue of ~100 launches a call cannot pace
    stage_args = {}

    def keep_args(i):
        def hook(module, args):
            stage_args[i] = args
        return hook

    hooks = [cv.register_forward_pre_hook(keep_args(i))
             for i, cv in enumerate(model.encoder.cross_views)]
    with torch.no_grad():
        model(batch)
    for h in hooks:
        h.remove()
    result["stage_device_ms"] = {}
    for i, cv in enumerate(model.encoder.cross_views):
        ms = {}
        for path, value in (("default", None), ("stock", "0")):
            with switches(value), torch.no_grad():
                ms[path] = sum(kernel_device_ms(
                    lambda: cv(*stage_args[i]), 5).values())
        result["stage_device_ms"][i] = ms
        log(f"nuScenes FAX stage {i}, device time (kernels summed): K2 "
            f"{ms['default']:.4f} ms, stock modules over K1 "
            f"{ms['stock']:.4f} ms")
    del stage_args

    # frame time, device time and operations, idle share, peak memory
    opt = benchmark.parse_args(["--model", "sinbevt", "--iters", "10",
                                "--profile_steps", "2"])
    for path, value in (("default", None), ("stock", "0")):
        with switches(value):
            row = benchmark.measure_eval(model, "sinbevt", batch, opt, device)
        log(f"nuScenes {path} benchmark " + json.dumps(row))
        result[f"benchmark_{path}"] = row
    del model, frames
    torch.cuda.empty_cache()

    log("== SinBEVT-nuScenes forward gate, seeds 0-4")
    gate = vk.validate_sinbevt(device)
    log("sinbevt gate " + json.dumps({k: v for k, v in gate.items()
                                      if k != "per_seed"}))
    for r in gate["per_seed"]:
        log(f"  seed {r['seed']}: " + json.dumps(
            {n: {"max_rel": r[n]["max_rel"],
                 "bev_iou": r[n]["argmax_iou"]["bev"],
                 "centered_bev_iou": r[n]["centered_bev_iou"]}
             for n in ("bf16_default_vs_f32_plain", "default_vs_stock")})
            + f", bev positive share {r['bev_positive_share']}")
    if not gate["ok"]:
        raise AssertionError("SinBEVT forward gate failed: "
                             + json.dumps(gate))
    result["gate"] = gate
    log("== the gate with a fault planted in one K2 or K1 call, seed 0")
    planted = vk.validate_sinbevt_faults(device)
    for name, r in planted["faults"].items():
        log(f"  {name}: " + json.dumps(r))
    if not planted["ok"]:
        raise AssertionError("the SinBEVT gate passed a planted fault it "
                             "must fail: " + json.dumps(planted))
    result["planted"] = planted
    torch.cuda.empty_cache()

    log("== phase 13: SinBEVT-OPV2V (corpbevt.yaml width, no fusion), one "
        "vehicle x 4 cameras x 512^2, bf16")
    model, batch, key = benchmark.build_sinbevt_opv2v(seed=seed,
                                                      device=device)
    ref_model = copy.deepcopy(model).eval()
    model = model.eval().to(torch.bfloat16)
    frames = [batch] + new_images(batch, key, 2, seed + 2)

    def check_opv2v(i, out):
        seg = out["dynamic_seg"]
        if tuple(seg.shape) != (1, 1, 256, 256, 2):
            raise AssertionError(f"frame {i}: dynamic_seg {tuple(seg.shape)}")
        if not torch.isfinite(seg).all():
            raise AssertionError(f"frame {i}: non-finite dynamic_seg")

    opv2v, outs = {}, {}
    with switches(None), torch.no_grad(), forced_impl("torch"):
        ref = ref_model(batch)["dynamic_seg"].cpu().numpy()
    del ref_model
    margin = np.abs(ref[..., 1] - ref[..., 0])
    opv2v["reference_class_shares"] = (np.bincount(
        ref.argmax(-1).ravel(), minlength=2) / margin.size).tolist()
    for path, value, per_frame in (
            ("default", None, SINBEVT_OPV2V_PER_FRAME),
            ("stock", "0", SINBEVT_OPV2V_STOCK_PER_FRAME)):
        with switches(value):
            opv2v[f"{path}_counts"], opv2v[f"{path}_frame_ms"] = \
                serve_frames(f"OPV2V {path} path", model, frames, per_frame,
                             check_opv2v)
            with torch.no_grad():
                out = model(batch)["dynamic_seg"].float().cpu().numpy()
        diff = np.abs(out - ref)
        rel = float(diff.max() / (np.abs(ref).max() + 1e-12))
        # how many pixels the bf16 drift can flip: reference margins below
        # the largest deviation of the logit difference
        flip = float((margin <= np.abs((out[..., 1] - out[..., 0])
                                       - (ref[..., 1] - ref[..., 0]))
                      .max()).mean())
        outs[path] = out
        opv2v[f"{path}_vs_f32_plain"] = row = {
            "max_rel_logit_err": rel, "argmax_iou": argmax_iou(out, ref),
            "share_within_drift_of_the_boundary": flip}
        log(f"OPV2V {path} bf16 vs f32 plain: " + json.dumps(row)
            + f", reference class shares {opv2v['reference_class_shares']}")
        if not rel <= vk.BUDGET_SINBEVT:
            raise AssertionError(f"OPV2V {path}: relative logit drift "
                                 f"{rel:.3e} > {vk.BUDGET_SINBEVT}")
    opv2v["default_vs_stock_argmax_iou"] = argmax_iou(outs["default"],
                                                      outs["stock"])
    log(f"OPV2V default vs stock, bf16: argmax IoU "
        f"{opv2v['default_vs_stock_argmax_iou']:.5f}")
    opt = benchmark.parse_args(["--model", "sinbevt_opv2v", "--iters", "10",
                                "--profile_steps", "2"])
    with switches(None):
        row = benchmark.measure_eval(model, "sinbevt_opv2v", batch, opt,
                                     device)
    log("OPV2V default benchmark " + json.dumps(row))
    opv2v["benchmark_default"] = row
    result["opv2v"] = opv2v
    del model, frames
    torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t0
    log(f"phase 13: {result['seconds']:.1f} s")
    return result


def train_run(name, model_name, model, batch, per_step, argv):
    """The train step of tools/benchmark.py (``--train --model
    model_name`` and ``argv``) on ``model``, with every launch count set to
    0 just before the timed steps and read just after the profiled ones,
    and the calls of the composite backward of window attention counted
    over every step; raise unless each wrapper ran ``per_step`` (0 where
    absent) launches a step, the composite ran ``per_step["composite"]``
    (0 where absent) times a step, and loss and gradient norm are finite.
    Returns (counts, benchmark row)."""
    import math
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.ops import window_attention
    from cobevt_tpu_torch.tools import benchmark
    opt = benchmark.parse_args(["--train", "--model", model_name, *argv])
    real, composite = window_attention.packed_backward_composite, [0]

    def counted(*args, **kwargs):
        composite[0] += 1
        return real(*args, **kwargs)

    device = torch.device("cuda", torch.cuda.current_device())
    window_attention.packed_backward_composite = counted
    try:
        ops.reset_launch_counts()
        before = time.perf_counter()
        row = benchmark.measure_train(model, model_name, batch, opt, device)
        counts = ops.launch_counts()
    finally:
        window_attention.packed_backward_composite = real
    # measure_train sets the counts to 0 again after its warmup steps
    steps = opt.iters + opt.profile_steps
    row["composite_backwards"] = composite[0]
    log(f"{name}: {opt.warmup} + {steps} steps in "
        f"{time.perf_counter() - before:.1f} s, launches after the warmup "
        f"{counts}, composite backwards {composite[0]}")
    log(f"{name} benchmark " + json.dumps(row))
    for fn, n in counts.items():
        if n != per_step.get(fn, 0) * steps:
            raise AssertionError(f"{name}: {fn} ran {n} launches over {steps} "
                                 f"steps, expected {per_step.get(fn, 0)} "
                                 f"each")
    if composite[0] != per_step.get("composite", 0) * (opt.warmup + steps):
        raise AssertionError(f"{name}: {composite[0]} backwards took the "
                             f"composite")
    if not (math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])):
        raise AssertionError(f"{name}: loss {row['loss']}, gradient norm "
                             f"{row['grad_norm']}")
    return counts, row


def phase_sinbevt_train(seed=0):
    """Phase 14: the nuScenes flagship's train step at B 8, full width, on
    its experiment's recipe through tools/benchmark.py (1 warmup, 3 timed
    and 2 profiled steps: K1 x6 and K5 x6 a step, no composite backward),
    one step under COBEVT_FUSED_XATTN_TRAIN=1 (K2 x24, and K1 and K5 x6 in
    the composite's backward), that step's gate against the default step at
    seeds 0-4 and with a dropped K2 head, the SinBEVT gradient gate at
    seeds 0-4 and its planted K5 faults, then SinBEVT-OPV2V's step (1 + 2
    steps).  The nuScenes batches hold 8 distinct samples."""
    import torch
    from cobevt_tpu_torch.ops.dispatch import env_switches
    from cobevt_tpu_torch.tools import benchmark
    from cobevt_tpu_torch.tools import validate_kernels as vk
    t0 = time.perf_counter()
    result = {}
    device = torch.device("cuda", torch.cuda.current_device())
    log("== phase 14: SinBEVT-nuScenes train step, B 8, EfficientNet-b4, 6 "
        "cameras x 224 x 480, BEV 200^2, bf16 compute, f32 master "
        "parameters, one-cycle AdamW clipped at 5.0")
    argv = ["--iters", str(TRAIN_STEPS), "--warmup", "1", "--seed",
            str(seed), "--profile_steps", "2"]
    # the experiment's batch (--batch's default), B distinct samples
    B = benchmark.parse_args(["--train", "--model", "sinbevt"]).batch
    model, batch, _ = benchmark.build_sinbevt(seed=seed, device=device,
                                              batch_size=B)
    result["counts"], result["step"] = train_run(
        "nuScenes train", "sinbevt", model, batch, NUSC_TRAIN_PER_STEP, argv)
    del model, batch
    torch.cuda.empty_cache()
    model, batch, _ = benchmark.build_sinbevt(seed=seed, device=device,
                                              batch_size=B)
    with env_switches(COBEVT_FUSED_XATTN_TRAIN="1"):
        result["fused_xattn_counts"], result["fused_xattn_step"] = train_run(
            "nuScenes train, COBEVT_FUSED_XATTN_TRAIN=1", "sinbevt", model,
            batch, NUSC_FUSED_XATTN_TRAIN_PER_STEP,
            ["--iters", "1", "--warmup", "0", "--seed", str(seed)])
    del model, batch
    torch.cuda.empty_cache()
    log(f"== COBEVT_FUSED_XATTN_TRAIN=1 against the default step, both "
        f"bf16, B {vk.SINBEVT_XATTN_TRAIN_BATCH}, seeds 0-4; then with K2's "
        f"first head dropped in stage 2's local branch")
    xattn = vk.validate_sinbevt_xattn_train(device)
    xattn["planted"] = vk.validate_sinbevt_xattn_train(device, fault=True)
    for kind, run in (("sound", xattn), ("fault", xattn["planted"])):
        for r in run["per_seed"]:
            log(f"  {kind}, seed {r['seed']}: " + json.dumps(
                {k: r[k] for k in ("ok", "max_scalar", "max_material_rel",
                                   "max_rel", "output_drift", "control",
                                   "worst_material_params", "scalars")}))
    for r in xattn["per_seed"]:
        if r["launches"] != dict(
                {fn: 0 for fn in r["launches"]},
                **{fn: n for fn, n in NUSC_FUSED_XATTN_TRAIN_PER_STEP.items()
                   if fn != "composite"}):
            raise AssertionError(f"fused-xattn gate seed {r['seed']}: "
                                 f"launches {r['launches']}")
    if not xattn["ok"]:
        raise AssertionError("COBEVT_FUSED_XATTN_TRAIN=1 left the default "
                             "step's budget: " + json.dumps(xattn))
    if any(r["ok"] for r in xattn["planted"]["per_seed"]):
        raise AssertionError("the fused-xattn gate passed a dropped K2 head: "
                             + json.dumps(xattn["planted"]))
    result["fused_xattn_gate"] = xattn
    torch.cuda.empty_cache()

    log(f"== SinBEVT gradient gate: the bf16 step vs the f32 plain step and "
        f"vs K5's plain version in its backward, B {vk.SINBEVT_TRAIN_BATCH}, "
        f"seeds 0-4")
    gate = vk.validate_sinbevt_train(device)
    log("sinbevt train gate " + json.dumps(
        {k: v for k, v in gate.items() if k != "per_seed"}))
    for r in gate["per_seed"]:
        log(f"  seed {r['seed']}: " + json.dumps(
            {n: {k: r[n][k] for k in ("max_scalar", "max_material_rel",
                                      "max_rel", "worst_material_params",
                                      "scalars")}
             for n in ("truth", "plain")}))
        if r["launches"] != dict(
                {fn: 0 for fn in r["launches"]},
                **{fn: n for fn, n in NUSC_TRAIN_PER_STEP.items()
                   if fn != "composite"}):
            raise AssertionError(f"gate seed {r['seed']}: launches "
                                 f"{r['launches']}")
    if not gate["ok"]:
        raise AssertionError("SinBEVT gradient gate failed: "
                             + json.dumps(gate))
    result["gate"] = gate
    log("== the gate with a fault planted in the first K5 call (stage 2, "
        "Tq 625), seed 0")
    planted = vk.validate_sinbevt_train_faults(device)
    for name, r in planted["faults"].items():
        log(f"  {name}: " + json.dumps(r))
    if not planted["ok"]:
        raise AssertionError("the SinBEVT gradient gate passed a planted "
                             "fault it must fail: " + json.dumps(planted))
    result["planted"] = planted
    torch.cuda.empty_cache()

    log("== phase 14: SinBEVT-OPV2V train step (corpbevt.yaml width, one "
        "vehicle x 4 cameras x 512^2), the OPV2V recipe, B 1")
    model, batch, _ = benchmark.build_sinbevt_opv2v(seed=seed, device=device)
    result["opv2v_counts"], result["opv2v_step"] = train_run(
        "SinBEVT-OPV2V train", "sinbevt_opv2v", model, batch,
        SINBEVT_OPV2V_TRAIN_PER_STEP,
        ["--iters", "2", "--warmup", "1", "--seed", str(seed)])
    del model, batch
    torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t0
    log(f"phase 14: {result['seconds']:.1f} s")
    return result


@contextlib.contextmanager
def counted_steps(train_calls, eval_calls, module=None, traced=()):
    """Record every train-step and eval-step call of the steps ``module``
    builds from its ``make_train_step`` / ``make_eval_step`` (train/loop.py
    by default, whose Trainer builds its steps from the two factories;
    tools/train_nuscenes.py binds them too): each call's launch counts and
    backwards of window attention on the composite (``launches``), its
    start on the host clock, CUDA events around its launches (read by
    read_step_events; the host paces the launches, so they read the
    host's time where it exceeds the device's) and, for a train step, the
    lr it ran at and its loss (a float after read_step_events).  The
    train calls numbered in ``traced`` (from 0) run alone under
    torch.profiler, the device synchronized before and after: ``profile``
    holds their device busy time (tools/timing.py)."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.tools.timing import device_profile
    from cobevt_tpu_torch.ops import window_attention
    from cobevt_tpu_torch.train import loop
    module = module or loop
    real = (module.make_train_step, module.make_eval_step,
            window_attention.packed_backward_composite)
    composite = [0]

    def composite_counted(*args, **kwargs):
        composite[0] += 1
        return real[2](*args, **kwargs)

    def counting(make, calls, train):
        def make_counted(*args, **kwargs):
            step = make(*args, **kwargs)

            def step_counted(state, *a, **kw):
                prof = None
                if train and len(calls) in traced:
                    from torch.profiler import ProfilerActivity, profile
                    torch.cuda.synchronize()
                    prof = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
                    prof.__enter__()
                before, c0 = ops.launch_counts(), composite[0]
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                t0 = time.perf_counter()
                events[0].record()
                out = step(state, *a, **kw)
                events[1].record()
                if prof is not None:
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                    prof.__exit__(None, None, None)
                after = ops.launch_counts()
                rec = {"launches": {**{k: after[k] - before[k]
                                       for k in after},
                                    "composite": composite[0] - c0},
                       "events": events, "t0": t0}
                if prof is not None:
                    rec["profile"] = device_profile(prof, 1, wall_ms)
                if train:
                    rec["lr"] = state.optimizer.param_groups[0]["lr"]
                    rec["step_before"] = state.step - 1
                    rec["loss"] = out["loss"]
                calls.append(rec)
                return out
            return step_counted
        return make_counted

    module.make_train_step = counting(real[0], train_calls, True)
    module.make_eval_step = counting(real[1], eval_calls, False)
    window_attention.packed_backward_composite = composite_counted
    try:
        yield
    finally:
        (module.make_train_step, module.make_eval_step,
         window_attention.packed_backward_composite) = real


def read_step_events(calls):
    """Pop each call's CUDA events into ``events_ms`` (and a train step's
    loss into a float)."""
    import torch
    torch.cuda.synchronize()
    for rec in calls:
        start, stop = rec.pop("events")
        rec["events_ms"] = start.elapsed_time(stop)
        if "loss" in rec:
            rec["loss"] = float(rec["loss"])


def check_calls(name, calls, expect, n):
    """Every call launched ``expect`` (0 where absent) of each wrapper."""
    if len(calls) != n:
        raise AssertionError(f"{name}: {len(calls)} calls, expected {n}")
    for i, got in enumerate(calls):
        wrong = {k: v for k, v in got.items() if v != expect.get(k, 0)}
        if wrong:
            raise AssertionError(f"{name} {i}: launches {wrong}, expected "
                                 f"{ {k: expect.get(k, 0) for k in wrong} }")


def seg_iou(a, b):
    """Mean over classes of the IoU of two class maps (argmax_iou's
    rule)."""
    import numpy as np
    ious = []
    for c in np.union1d(np.unique(a), np.unique(b)):
        union = np.logical_or(a == c, b == c).sum()
        if union:
            ious.append(np.logical_and(a == c, b == c).sum() / union)
    return float(np.mean(ious)) if ious else 1.0


def camera_run_hypes(tmp, preset, train_split, val_split, seed):
    """A synthetic OPV2V fixture under ``tmp`` (``train_split`` and
    ``val_split``: (CAVs, timestamps)) at the full-width ``preset``'s image
    and label sizes, and its hypes (batch 1, one epoch, a validation pass
    and a save) written as JSON text: (hypes path, validate dir, image
    (h, w), label size)."""
    from cobevt_tpu_torch.tools.bench_input import write_opv2v_fixture
    from cobevt_tpu_torch.tools.export_config import export_preset

    hypes = export_preset(preset)
    res = (hypes["preprocess"]["args"]["resize_y"],
           hypes["preprocess"]["args"]["resize_x"])
    args = hypes["model"]["args"]
    bev = (args.get("fax") or args["cvm"])["bev_embedding"]["bev_height"]
    train_dir, val_dir = (os.path.join(tmp, "train"),
                          os.path.join(tmp, "validate"))
    write_opv2v_fixture(train_dir, *train_split, res, bev, seed)
    write_opv2v_fixture(val_dir, *val_split, res, bev, seed + 1)
    hypes.update(root_dir=train_dir, validate_dir=val_dir)
    hypes["train_params"].update(batch_size=1, epoches=1, eval_freq=1,
                                 save_freq=1)
    path = os.path.join(tmp, f"{preset}.yaml")
    with open(path, "w") as f:
        json.dump(hypes, f)
    return path, val_dir, res, bev


def check_same_state(name, saved, fresh):
    """Raise unless the restored train state ``fresh`` holds ``saved``'s
    step, every model state_dict entry and AdamW moment bit for bit, and
    its bf16 twin still shares the master's BatchNorm buffers."""
    import torch
    if fresh.step != saved.step:
        raise AssertionError(f"{name}: step {fresh.step} vs {saved.step}")
    a, b = saved.model.state_dict(), fresh.model.state_dict()
    for k in a:
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"{name}: {k} differs")
    for p_old, p_new in zip(saved.params, fresh.params):
        s_old = saved.optimizer.state[p_old]
        s_new = fresh.optimizer.state[p_new]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            if not torch.equal(s_old[k], s_new[k]):
                raise AssertionError(f"{name}: AdamW {k} differs")
    for t, m in zip(fresh.compute_model.modules(), fresh.model.modules()):
        if isinstance(m, torch.nn.BatchNorm2d) and \
                t.running_mean is not m.running_mean:
            raise AssertionError(f"{name}: the twin lost the master's "
                                 "BatchNorm buffers")


def phase_train_camera(seed=0):
    """The port's main path through its entry points at corpbevt.yaml
    width: a synthetic OPV2V fixture, tools/train_camera.py (4 bf16 steps,
    one validation pass, one save), a restore into a fresh state,
    tools/inference_camera.py and tools/serve_camera.py from the
    checkpoint."""
    import tempfile

    import numpy as np
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.configs.hypes import load_hypes
    from cobevt_tpu_torch.tools import (
        inference_camera,
        serve_camera,
        train_camera,
    )
    from cobevt_tpu_torch.train import create_train_state, make_optimizer
    from cobevt_tpu_torch.train.checkpoint import (
        checkpoint_paths,
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )
    from cobevt_tpu_torch.train.optim import constant_schedule

    log("== train_camera: CorpBEVT 5 agents x 4 cameras x 512^2 through "
        "train_camera / inference_camera / serve_camera --model_dir, bf16")
    out = {}
    with tempfile.TemporaryDirectory(prefix="cobevt_camera_") as tmp:
        t0 = time.perf_counter()
        hypes_path, val_dir, res, bev = camera_run_hypes(
            tmp, "corpbevt", (TRAIN_CAM_CAVS, TRAIN_CAM_STAMPS),
            (VAL_CAM_CAVS, VAL_CAM_STAMPS), seed)
        out["fixture_s"] = time.perf_counter() - t0
        log(f"fixture: train {TRAIN_CAM_CAVS} CAVs x {TRAIN_CAM_STAMPS} "
            f"timestamps, validate {VAL_CAM_CAVS} x {VAL_CAM_STAMPS}, cameras "
            f"{res[0]}x{res[1]}, labels {bev}^2, written in "
            f"{out['fixture_s']:.1f} s")

        run = os.path.join(tmp, "run")
        train_calls, eval_calls = [], []
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with counted_steps(train_calls, eval_calls):
            trainer = train_camera.main([
                "--hypes_yaml", hypes_path, "--save_dir", run, "--half",
                "--log_every", "1",
                "--profile_steps", str(TRAIN_CAM_PROFILED)])
        out["train_camera_s"] = time.perf_counter() - t0
        counts = ops.launch_counts()
        steps = [{"step": r["step"], "loss": r["scalars"]["loss"],
                  "grad_norm": r["scalars"]["grad_norm"],
                  "host_ms": r["step_s"] * 1e3,
                  "loader_ms": r["loader_s"] * 1e3,
                  "loader_share": r["loader_s"] / r["step_s"],
                  "launches": {k: v for k, v in
                               train_calls[i]["launches"].items() if v}}
                 for i, r in enumerate(trainer.records)]
        for s_ in steps:
            log(f"train_camera step {s_['step']}: loss {s_['loss']:.5f}, "
                f"gradient norm {s_['grad_norm']:.4f}, host "
                f"{s_['host_ms']:.1f} ms, waiting on the loader "
                f"{s_['loader_ms']:.1f} ms ({s_['loader_share']:.3f}), "
                f"launches {s_['launches']}")
        import math
        for s_ in steps:
            if not (math.isfinite(s_["loss"])
                    and math.isfinite(s_["grad_norm"])):
                raise AssertionError(f"train_camera: step {s_}")
        check_calls("train_camera step", [c["launches"] for c in train_calls],
                    dict(TRAIN_PER_STEP, composite=1), TRAIN_CAM_STAMPS)
        check_calls("validation frame", [c["launches"] for c in eval_calls],
                    FUSED_PER_FRAME, VAL_CAM_STAMPS)
        expect_total = {k: TRAIN_CAM_STAMPS * TRAIN_PER_STEP.get(k, 0) +
                        VAL_CAM_STAMPS * FUSED_PER_FRAME.get(k, 0)
                        for k in counts}
        if counts != expect_total:
            raise AssertionError(f"train_camera: launches {counts}, "
                                 f"expected {expect_total}")
        log("validation frame launches: "
            f"{ {k: v for k, v in eval_calls[0]['launches'].items() if v} }")
        with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
            val = [json.loads(x) for x in f if "val_iou_dynamic" in x][-1]
        out.update(steps=steps, counts=counts, profile=trainer.profile,
                   val_iou_dynamic=val["val_iou_dynamic"],
                   validation_launches=eval_calls[0]["launches"])
        log(f"train_camera: {len(steps)} steps + validation + save in "
            f"{out['train_camera_s']:.1f} s; validation IoU "
            f"{val['val_iou_dynamic']!r}")
        if trainer.profile is None:
            raise AssertionError("train_camera: no profile of the steps")
        log("train_camera profile " + json.dumps(
            {k: v for k, v in trainer.profile.items()
             if k != "top_device_ops"}))

        log("== restore: the saved checkpoint into a fresh state")
        epoch = latest_checkpoint(run)
        device = trainer.device
        saved = trainer.state
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(tmp, "again"), saved, epoch,
                        trainer.generator)
        torch.cuda.synchronize()
        out["save_ms"] = (time.perf_counter() - t0) * 1e3
        _, model, _ = train_camera.build_from_hypes(
            load_hypes(os.path.join(run, "config.yaml")), device, seed + 1)
        fresh = create_train_state(
            model, make_optimizer(model.parameters(), constant_schedule(0.0)),
            constant_schedule(0.0), compute_dtype=torch.bfloat16)
        t0 = time.perf_counter()
        fresh, got_epoch = restore_checkpoint(run, fresh)
        torch.cuda.synchronize()
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        out["checkpoint_bytes"] = sum(os.path.getsize(p) for p in
                                      checkpoint_paths(run, epoch))
        if got_epoch != 1:
            raise AssertionError(f"restore: epoch {got_epoch}")
        check_same_state("restore", saved, fresh)
        log(f"restore: bit for bit (parameters, BatchNorm buffers, AdamW "
            f"moments, step {fresh.step}); save {out['save_ms']:.1f} ms, "
            f"restore {out['restore_ms']:.1f} ms, checkpoint "
            f"{out['checkpoint_bytes'] / 2**20:.1f} MiB")
        del fresh, model, trainer, saved
        torch.cuda.empty_cache()

        log("== inference_camera --model_dir")
        inf_dir, srv_dir = (os.path.join(tmp, "inference"),
                            os.path.join(tmp, "serve"))
        eval_calls = []
        with counted_steps([], eval_calls):
            ious = inference_camera.main(["--model_dir", run, "--out_dir",
                                          inf_dir])
        check_calls("inference frame", [c["launches"] for c in eval_calls],
                    FUSED_PER_FRAME, VAL_CAM_STAMPS)
        if ious["iou_dynamic"] != out["val_iou_dynamic"]:
            raise AssertionError(f"inference_camera IoU {ious} vs the "
                                 f"trainer's {out['val_iou_dynamic']!r}")
        log(f"inference_camera: IoU {ious['iou_dynamic']!r}, the trainer's")
        out["inference_iou"] = ious
        torch.cuda.empty_cache()

        log("== serve_camera --model_dir --root_dir (staged runner)")
        ops.reset_launch_counts()
        summary = serve_camera.main(["--model_dir", run, "--root_dir",
                                     val_dir, "--half", "--out_dir",
                                     srv_dir])
        counts = ops.launch_counts()
        served = summary["frames"] + len(summary["buckets"])
        expect_total = {k: served * FUSED_PER_FRAME.get(k, 0) for k in counts}
        if counts != expect_total:
            raise AssertionError(f"serve_camera: launches {counts} over "
                                 f"{served} frames (warmup included)")
        frame_ious = []
        for i in range(VAL_CAM_STAMPS):
            name = f"frame_{i:06d}.npz"
            a = np.load(os.path.join(inf_dir, name))
            b = np.load(os.path.join(srv_dir, name))
            if int(a["n_agents"]) != VAL_CAM_CAVS or \
                    int(b["n_agents"]) != VAL_CAM_CAVS:
                raise AssertionError(f"{name}: agents {a['n_agents']}, "
                                     f"{b['n_agents']}")
            frame_ious.append(seg_iou(a["seg"], b["seg"]))
        log(f"serve_camera: p50 {summary['p50_ms']:.2f} ms a request over "
            f"{summary['frames']} frames ({VAL_CAM_CAVS} live agents); "
            f"argmax IoU against inference_camera {frame_ious}")
        if min(frame_ious) < IOU_FLOOR:
            raise AssertionError(f"serve_camera vs inference_camera argmax "
                                 f"IoU {frame_ious}")
        out.update(serve={k: summary[k] for k in (
            "frames", "p50_ms", "p95_ms", "p99_ms", "frames_per_sec",
            "buckets")}, serve_iou=frame_ious, serve_counts=counts)
    return out


def camera_decode_ms(tmp, seed):
    """Decode + resize ms of one nuScenes camera (1600 x 900 PNG, read by
    the codec, resized to 270 x 480 as the loader does) for each way of
    filtering its rows: none, the adaptive choice, Paeth everywhere.  The
    median of 3."""
    import numpy as np
    from cobevt_tpu_torch.data.image_io import (
        read_png,
        resize_bilinear_u8,
        write_png,
    )
    from cobevt_tpu_torch.tools.bench_input import synth_camera
    img = synth_camera(np.random.RandomState(seed), 900, 1600)
    out = {}
    for name, row_filter in (("filter0", 0), ("adaptive", "adaptive"),
                             ("paeth", 4)):
        path = os.path.join(tmp, f"camera_{name}.png")
        write_png(path, img[..., ::-1], row_filter)
        times, decode = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            got = read_png(path)
            t1 = time.perf_counter()
            small = resize_bilinear_u8(got[..., 2::-1], (270, 480))
            times.append((time.perf_counter() - t0) * 1e3)
            decode.append((t1 - t0) * 1e3)
        if not np.array_equal(got[..., ::-1], img) or small.shape != (
                270, 480, 3):
            raise AssertionError(f"camera {name}: decode or resize wrong")
        out[name] = {"decode_resize_ms": sorted(times)[1],
                     "decode_ms": sorted(decode)[1],
                     "file_bytes": os.path.getsize(path)}
    return out


def camera_device_rate(train_camera):
    """Samples/s of phase 15's camera step on the card (batch 1, the traced
    steps' device time), or None where phase 15 did not run."""
    if not train_camera or not train_camera.get("profile"):
        return None
    return 1e3 / train_camera["profile"]["device_ms_per_step"]


def phase_train_nuscenes(seed=0, corpbevt_device_rate=None):
    """The nuScenes track through its entry points at full width: a
    synthetic scene set written by data/nuscenes_labelgen.py, then
    tools/train_nuscenes.main at the default experiment with --half (4 steps,
    a checkpoint every 2, the IoU pass), a bit-for-bit restore of step 4,
    the same command to 5 steps (a resume from step 4), tools/view_data.py
    and tools/bench_input.py."""
    import tempfile

    import numpy as np
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.configs.nuscenes_experiments import (
        build_model,
        nuscenes_experiment,
    )
    from cobevt_tpu_torch.data.image_io import read_png
    from cobevt_tpu_torch.tools import bench_input, train_nuscenes, view_data
    from cobevt_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        onecycle_schedule,
    )
    from cobevt_tpu_torch.train.checkpoint import (
        restore_step_checkpoint,
        save_step_checkpoint,
        step_checkpoint_paths,
    )
    from cobevt_tpu_torch.train.optim import constant_schedule

    t_phase = time.perf_counter()
    exp = nuscenes_experiment("cvt_pyramid_axial_nuscenes_vehicle")
    log(f"== phase 16: train_nuscenes, {exp.name} (EfficientNet-b4, 6 "
        f"cameras x {exp.encoder.image_height} x {exp.encoder.image_width}, "
        f"B {exp.batch_size}, bf16 compute on f32 masters), from a synthetic "
        f"scene set in the generated-label layout")
    out = {"host_packages": {}}
    for name in ("PIL", "cv2"):
        try:
            out["host_packages"][name] = importlib.import_module(
                name).__version__
        except ImportError:
            out["host_packages"][name] = None
    log(f"host packages: {out['host_packages']} (None: not installed)")
    with tempfile.TemporaryDirectory(prefix="cobevt_nuscenes_") as tmp:
        t0 = time.perf_counter()
        data, labels = bench_input.write_nuscenes_fixture(
            os.path.join(tmp, "fixture"), NUSC_CLI_SCENES, NUSC_CLI_SAMPLES,
            seed=seed, camera_pool=NUSC_CLI_POOL)
        out["fixture_s"] = time.perf_counter() - t0
        log(f"fixture: {NUSC_CLI_SCENES} scenes x {NUSC_CLI_SAMPLES} samples, "
            f"6 camera PNGs at 1600 x 900 ({NUSC_CLI_POOL} files), 200^2 "
            f"labels, written in {out['fixture_s']:.1f} s")
        out["camera_decode"] = camera_decode_ms(tmp, seed)
        for name, r in out["camera_decode"].items():
            log(f"camera {name}: decode + resize {r['decode_resize_ms']:.1f} ms "
                f"(decode {r['decode_ms']:.1f} ms), {r['file_bytes']} bytes; "
                f"{card_line()}")

        save = os.path.join(tmp, "run")
        argv = ["--dataset_dir", data, "--labels_dir", labels, "--save_dir",
                save, "--half", "--ckpt_every", str(NUSC_CLI_CKPT_EVERY)]
        runs = []
        for steps in (NUSC_CLI_STEPS, NUSC_CLI_RESUMED_STEPS):
            train_calls, eval_calls = [], []
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            traced = (NUSC_CLI_TRACED,) if steps == NUSC_CLI_STEPS else ()
            with counted_steps(train_calls, eval_calls, train_nuscenes,
                               traced):
                run = train_nuscenes.main(argv + ["--steps", str(steps)])
            wall = time.perf_counter() - t0
            read_step_events(train_calls)
            read_step_events(eval_calls)
            counts = ops.launch_counts()
            first = run.records[0]["step"]
            check_calls(f"train_nuscenes step ({steps})",
                        [c["launches"] for c in train_calls],
                        dict(NUSC_TRAIN_PER_STEP, composite=0),
                        steps - first + 1)
            check_calls(f"IoU-pass frame ({steps})",
                        [c["launches"] for c in eval_calls],
                        dict(SINBEVT_PER_FRAME, composite=0),
                        NUSC_CLI_SCENES * NUSC_CLI_SAMPLES)
            for r, c in zip(run.records, train_calls):
                r.update(events_ms=c["events_ms"], lr=c["lr"],
                         traced="profile" in c,
                         loader_share=r["loader_s"] / (r["loader_s"]
                                                       + r["step_s"]))
                log(f"train_nuscenes step {r['step']}: host "
                    f"{r['step_s'] * 1e3:.1f} ms, waiting on the loader "
                    f"{r['loader_s'] * 1e3:.1f} ms "
                    f"({r['loader_share']:.3f} of the two), save "
                    f"{r['save_s'] * 1e3:.1f} ms, CUDA events around its "
                    f"host-paced launches {r['events_ms']:.2f} ms, lr "
                    f"{r['lr']!r}; {card_line()}")
                if "profile" in c:
                    out["step_profile"] = c["profile"]
                    log("train_nuscenes step {} traced alone: ".format(
                        r["step"]) + json.dumps(
                        {k: v for k, v in c["profile"].items()
                         if k != "top_device_ops"}) + f"; {card_line()}")
            ious = np.concatenate([run.iou_visible, run.iou_all])
            if not np.all(np.isfinite(ious)):
                raise AssertionError(f"train_nuscenes IoU {ious}")
            starts = [c["t0"] for c in eval_calls]
            runs.append({"steps": steps, "wall_s": wall,
                         "iou_frame_ms": float(np.median(np.diff(starts)))
                         * 1e3,
                         "iou_frame_events_ms": float(np.median(
                             [c["events_ms"] for c in eval_calls])),
                         "resumed_from": run.resumed_from,
                         "records": run.records, "counts": counts,
                         "iou_visible": run.iou_visible.tolist(),
                         "iou_all": run.iou_all.tolist()})
            log(f"train_nuscenes --steps {steps}: {len(run.records)} steps + "
                f"IoU pass over {len(eval_calls)} frames in {wall:.1f} s, "
                f"resumed from {run.resumed_from}; IoU (vis>=2) "
                f"{run.iou_visible.tolist()}, (with occlusions) "
                f"{run.iou_all.tolist()}; launches {counts}")
            if steps == NUSC_CLI_STEPS:
                if run.resumed_from is not None:
                    raise AssertionError("the first run resumed")
                saved = run.state
                log("== restore: the step-4 checkpoint into a fresh state")
                t0 = time.perf_counter()
                save_step_checkpoint(os.path.join(tmp, "again"), saved,
                                     steps)
                out["save_ms"] = (time.perf_counter() - t0) * 1e3
                model = build_model(exp).to(
                    next(saved.model.parameters()).device)
                fresh = create_train_state(
                    model, make_optimizer(model.parameters(),
                                          constant_schedule(0.0)),
                    constant_schedule(0.0), compute_dtype=torch.bfloat16)
                t0 = time.perf_counter()
                fresh, got = restore_step_checkpoint(
                    os.path.join(save, "ckpt"), fresh)
                torch.cuda.synchronize()
                out["restore_ms"] = (time.perf_counter() - t0) * 1e3
                out["checkpoint_bytes"] = sum(
                    os.path.getsize(p) for p in step_checkpoint_paths(
                        os.path.join(save, "ckpt"), steps))
                if got != steps:
                    raise AssertionError(f"restore: step {got}")
                check_same_state("restore", saved, fresh)
                log(f"restore: bit for bit (parameters, BatchNorm buffers, "
                    f"AdamW moments, step {fresh.step}); save "
                    f"{out['save_ms']:.1f} ms, restore {out['restore_ms']:.1f} "
                    f"ms, checkpoint {out['checkpoint_bytes'] / 2**20:.1f} MiB")
                del fresh, model, saved, run
                torch.cuda.empty_cache()
            else:
                if run.resumed_from != NUSC_CLI_STEPS:
                    raise AssertionError(f"resumed from {run.resumed_from}")
                want = onecycle_schedule(exp.lr, steps)(NUSC_CLI_STEPS)
                got = run.records[0]["lr"]
                if train_calls[0]["step_before"] != NUSC_CLI_STEPS or \
                        got != want:
                    raise AssertionError(f"resumed lr {got!r}, the schedule's "
                                         f"{want!r}")
                log(f"resume: step {NUSC_CLI_STEPS} restored, lr {got!r} = "
                    f"the one-cycle schedule's at step {NUSC_CLI_STEPS} of "
                    f"{steps}")
                del run
                torch.cuda.empty_cache()
        out["runs"] = runs
        # K1 and K5 a step and K2 an IoU-pass frame, both runs
        out["counts"] = {k: sum(r["counts"][k] for r in runs)
                         for k in runs[0]["counts"]}
        # the steps after each run's first (which spawns the workers and,
        # in the first run, sets up the card's libraries); the host and
        # event times leave out the traced step (its wait for the loader,
        # before the trace, stays in)
        later = [r for run_ in runs for r in run_["records"][1:]]
        untraced = [r for r in later if not r["traced"]]
        out["ms_per_step"] = float(np.mean([r["step_s"] * 1e3
                                            for r in untraced]))
        out["events_ms_per_step"] = float(np.mean([r["events_ms"]
                                                   for r in untraced]))
        if "step_profile" not in out:
            raise AssertionError("train_nuscenes: no traced step")
        out["busy_ms_per_step"] = out["step_profile"]["device_ms_per_step"]
        out["loader_ms_per_step"] = float(np.mean([r["loader_s"] * 1e3
                                                   for r in later]))
        out["loader_share"] = out["loader_ms_per_step"] / (
            out["loader_ms_per_step"] + out["ms_per_step"])
        out["iou_frame_ms"] = float(np.median([r["iou_frame_ms"]
                                               for r in runs]))
        out["iou_frame_events_ms"] = float(np.median(
            [r["iou_frame_events_ms"] for r in runs]))
        # samples/s at the device's busy time, at the host's pace of a
        # step, and at a step with its wait for the loader
        B = exp.batch_size
        out["samples_per_sec"] = {
            "device_busy": B * 1e3 / out["busy_ms_per_step"],
            "host_step": B * 1e3 / out["ms_per_step"],
            "with_loader": B * 1e3 / (out["ms_per_step"]
                                      + out["loader_ms_per_step"])}
        log(f"train_nuscenes: ms_per_step {out['ms_per_step']:.1f} (host, "
            f"mean of the untraced steps after each run's first), CUDA "
            f"events around them {out['events_ms_per_step']:.2f} ms, device "
            f"busy {out['busy_ms_per_step']:.2f} ms (one step traced alone),"
            f" loader wait {out['loader_ms_per_step']:.1f} ms a step (share "
            f"{out['loader_share']:.3f}); samples/s "
            f"{json.dumps(out['samples_per_sec'])}; IoU pass "
            f"{out['iou_frame_ms']:.1f} ms a frame (host, between frames; "
            f"CUDA events {out['iou_frame_events_ms']:.2f} ms); "
            f"{card_line()}")

        log("== view_data")
        paths = view_data.main(["--dataset_dir", data, "--labels_dir",
                                labels, "--out", os.path.join(tmp, "viz"),
                                "--max_samples", "2"])
        shapes = [read_png(p).shape for p in paths]
        if len(paths) != 2 or any(len(sh) != 3 for sh in shapes):
            raise AssertionError(f"view_data panels {shapes}")
        log(f"view_data: {len(paths)} panels, {shapes}")
        out["view_data"] = shapes

        log("== bench_input")
        argv = ["--root", os.path.join(tmp, "bench"),
                "--sinbevt_device_rate",
                str(out["samples_per_sec"]["device_busy"])] + BENCH_INPUT_ARGS
        if corpbevt_device_rate is not None:
            argv += ["--corpbevt_device_rate", str(corpbevt_device_rate)]
        t0 = time.perf_counter()
        rows = bench_input.main(argv)
        out["bench_input_s"] = time.perf_counter() - t0
        for r in rows:
            log(f"bench_input {r['track']} {r['pipeline']} "
                f"({r['camera_format']}, filter {r['png_filter']}): "
                f"{r['samples_per_sec']:.3f} samples/s over "
                f"{r['samples_timed']} samples, {r['num_workers']} workers "
                f"(device busy rate {r['device_rate']}); {card_line()}")
            if not (r["samples_per_sec"] > 0):
                raise AssertionError(f"bench_input row {r}")
        out["bench_input"] = rows
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16: {out['seconds']:.1f} s")
    return out


def lidar_ideal_gate(post, samples, fault=None):
    """For each sample, its ideal maps (+-10 logits from its positive anchors,
    its targets as the regression) decoded and NMS'd by ``post``, then AP at
    LIDAR_AP_IOUS against the sample's own ground truth.  ``fault`` plants
    one in the maps: "swap_xy" swaps every anchor's x and y deltas, "shift"
    moves both maps one anchor cell along x.  Returns a row a sample."""
    import numpy as np
    from cobevt_tpu_torch.geometry.boxes import boxes_to_corners_3d
    from cobevt_tpu_torch.metrics import detection_ap

    rows = []
    for s in samples:
        cls = np.where(s["pos_equal_one"] > 0, 10.0, -10.0)
        reg = s["targets"].copy()
        if fault == "swap_xy":
            r = reg.reshape(*reg.shape[:2], -1, 7)
            r[..., [0, 1]] = r[..., [1, 0]]
        elif fault == "shift":
            cls, reg = np.roll(cls, 1, axis=1), np.roll(reg, 1, axis=1)
        elif fault is not None:
            raise ValueError(fault)
        corners, scores = post.decode(cls, reg)
        gt = s["object_bbx_center"][s["object_bbx_mask"] == 1]
        gt_corners = boxes_to_corners_3d(gt, post.order)[:, :4, :2]
        stat = detection_ap.new_result_stat(LIDAR_AP_IOUS)
        for t in LIDAR_AP_IOUS:
            detection_ap.accumulate_tp_fp(corners[:, :4, :2], scores,
                                          gt_corners, stat, t)
        rows.append({"gt": len(gt), "kept": len(corners),
                     "ap": {t: detection_ap.calculate_ap(stat, t)[0]
                            for t in LIDAR_AP_IOUS}})
    return rows


def lidar_gate_holds(rows):
    return all(r["gt"] > 0 and min(r["ap"].values()) > 1 - 1e-9
               for r in rows)


def phase_lidar_data(seed=0):
    """The cooperative LiDAR track from point clouds to AP at full width: a
    synthetic OPV2V LiDAR scenario of .pcd files (tools/lidar_fixture.py),
    the host stages timed one by one, OPV2VLidarDataset in eval and train
    mode through data/loader.py's 2 workers, bf16 eval frames on the default
    dispatch (K6 x 4 each), bf16 train steps on f32 masters with
    PointPillarLoss on the dataset's batches (K1 x 4 + K5 x 4 each, across
    an epoch boundary), then the ideal-map AP gate with its planted faults
    and one decode of the model's own maps, every box call on the native
    route."""
    import math
    import tempfile

    import numpy as np
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.data.lidar_preprocess import (
        load_pcd,
        mask_ego_points,
        mask_points_by_range,
    )
    from cobevt_tpu_torch.data.loader import DataLoader
    from cobevt_tpu_torch.data.objects import GT_RANGE, generate_object_center
    from cobevt_tpu_torch.data.opv2v import OPV2VScenarioDatabase
    from cobevt_tpu_torch.data.opv2v_lidar import OPV2VLidarDataset
    from cobevt_tpu_torch.data.voxelize import occupied_voxels, voxelize_points
    from cobevt_tpu_torch.losses.detection_loss import PointPillarLoss
    from cobevt_tpu_torch.models.lidar.point_pillar_models import (
        PointPillarConfig,
        PointPillarFuseBEVT,
    )
    from cobevt_tpu_torch.postprocess.voxel_postprocessor import (
        AnchorArgs,
        VoxelPostprocessor,
    )
    from cobevt_tpu_torch.tools import benchmark
    from cobevt_tpu_torch.tools.debug_utils import check_anchor_roundtrip
    from cobevt_tpu_torch.tools.lidar_fixture import write_lidar_scenario
    from cobevt_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from cobevt_tpu_torch.train.loop import batch_to_device
    from cobevt_tpu_torch.utils import native_ops
    from cobevt_tpu_torch.utils.weights import seeded_init_

    t_phase = time.perf_counter()
    card = card_line()
    rng_range = benchmark.POINTPILLAR_RANGE
    voxel, max_voxels, max_points = (0.4, 0.4, 4.0), 8000, 32
    log(f"== phase 17: the LiDAR track from point clouds to AP, "
        f"{LIDAR_DATA_CAVS} CAVs x {LIDAR_DATA_STAMPS} timestamps, "
        f"~{LIDAR_DATA_POINTS} returns a cloud, {max_voxels} pillars x "
        f"{max_points} points over +-70.4 x +-38.4 m, bf16 on the card")
    routes_before = {k: dict(v) for k, v in native_ops.route_calls.items()}
    device = torch.device("cuda", torch.cuda.current_device())
    out = {"card": card}

    def cuda_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        result = fn()
        stop.record()
        torch.cuda.synchronize()
        return result, start.elapsed_time(stop), \
            (time.perf_counter() - t0) * 1e3

    def check_counts(name, expect):
        counts = ops.launch_counts()
        for fn, n in counts.items():
            if n != expect.get(fn, 0):
                raise AssertionError(f"{name}: {fn} ran {n} launches, "
                                     f"expected {expect.get(fn, 0)}")
        return counts

    kept_keys = ("pos_equal_one", "targets", "object_bbx_center",
                 "object_bbx_mask")
    with tempfile.TemporaryDirectory(prefix="cobevt_lidar_") as tmp:
        # (a) the scenario tree, and each host stage timed alone
        t0 = time.perf_counter()
        paths = write_lidar_scenario(tmp, LIDAR_DATA_CAVS, LIDAR_DATA_STAMPS,
                                     LIDAR_DATA_VEHICLES, LIDAR_DATA_POINTS,
                                     seed=seed)
        out["fixture_s"] = time.perf_counter() - t0
        log(f"fixture: {len(paths)} clouds written in "
            f"{out['fixture_s']:.1f} s")
        load_ms = {"binary": [], "ascii": []}
        vox_ms, clouds = [], []
        for path in paths:
            with open(path, "rb") as f:
                kind = "ascii" if b"DATA ascii" in f.read(512) else "binary"
            t0 = time.perf_counter()
            pts = load_pcd(path)
            load_ms[kind].append((time.perf_counter() - t0) * 1e3)
            pts_in = mask_ego_points(mask_points_by_range(pts, rng_range))
            before_cut = occupied_voxels(pts_in, voxel, rng_range)
            t0 = time.perf_counter()
            vox = voxelize_points(pts_in, voxel, rng_range, max_voxels,
                                  max_points)
            vox_ms.append((time.perf_counter() - t0) * 1e3)
            row = {"cloud": os.path.relpath(path, tmp), "format": kind,
                   "points": len(pts), "in_range": len(pts_in),
                   "voxels_before_cut": before_cut,
                   "voxels_kept": int(vox["voxel_mask"].sum())}
            clouds.append(row)
            log(f"{row['cloud']} ({kind}): {row['points']} points, "
                f"{row['in_range']} in range, {before_cut} voxels before "
                f"the cut at {max_voxels}, {row['voxels_kept']} kept")
        out["clouds"] = clouds
        out["load_pcd_ms"] = {k: float(np.mean(v)) for k, v in
                              load_ms.items()}
        out["voxelize_ms"] = float(np.mean(vox_ms))
        log(f"load_pcd: {out['load_pcd_ms']['binary']:.2f} ms a binary "
            f"cloud (mean of {len(load_ms['binary'])}), "
            f"{out['load_pcd_ms']['ascii']:.1f} ms the ASCII one; "
            f"voxelize_points: {out['voxelize_ms']:.2f} ms a CAV (mean of "
            f"{len(vox_ms)}); {card}")
        if any(r["voxels_before_cut"] <= max_voxels for r in clouds):
            log("note: some clouds stay under the max_voxels cap")

        # (b) the datasets at full width, and generate_label alone
        post = VoxelPostprocessor(
            AnchorArgs(cav_lidar_range=rng_range, W=352, H=192,
                       feature_stride=2))
        kw = dict(voxel_size=voxel, lidar_range=rng_range,
                  max_voxels=max_voxels, max_points_per_voxel=max_points,
                  max_objects=100)
        train_ds = OPV2VLidarDataset(
            OPV2VScenarioDatabase(tmp, max_cav=LIDAR_DATA_CAVS), post,
            augment=True, train=True, seed=seed, **kw)
        eval_ds = OPV2VLidarDataset(
            OPV2VScenarioDatabase(tmp, max_cav=LIDAR_DATA_CAVS), post,
            train=False, **kw)
        label_ms, n_boxes = [], []
        for i in range(len(eval_ds)):
            _, ego_pose, cavs = eval_ds.plan(i)
            boxes, mask, _ = generate_object_center(
                [p for p, _, _ in cavs], ego_pose, 100, order="hwl",
                lidar_range=GT_RANGE)
            t0 = time.perf_counter()
            post.generate_label(boxes, mask)
            label_ms.append((time.perf_counter() - t0) * 1e3)
            n_boxes.append(int(mask.sum()))
        out["generate_label_ms"] = float(np.mean(label_ms))
        log(f"generate_label: {out['generate_label_ms']:.1f} ms a sample "
            f"(mean of {len(label_ms)}; {n_boxes} boxes, 33,792 anchors); "
            f"{card}")

        cfg = PointPillarConfig(max_cav=LIDAR_DATA_CAVS,
                                point_cloud_range=rng_range)
        model = PointPillarFuseBEVT(cfg)
        seeded_init_(model, seed)
        model = model.to(device)
        eval_model = copy.deepcopy(model).to(torch.bfloat16).eval()
        samples, counts_total = [], {}

        def add_counts(counts):
            for k, n in counts.items():
                counts_total[k] = counts_total.get(k, 0) + n

        # (c) eval frames through the loader, bf16, default dispatch
        loader = DataLoader(eval_ds, batch_size=1, shuffle=False,
                            drop_last=False, num_workers=2, device=device)
        frames, maps = [], None
        with switches(None):
            it = iter(loader)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                wait_ms = (time.perf_counter() - t0) * 1e3
                b = batch_to_device(batch, device)
                ops.reset_launch_counts()
                traced = len(frames) == LIDAR_TRACED_FRAME
                with torch.no_grad():
                    if traced:
                        o, prof = traced_frame(lambda: eval_model(b))
                        ev_ms = host_ms = None
                    else:
                        o, ev_ms, host_ms = cuda_ms(lambda: eval_model(b))
                add_counts(check_counts(f"eval frame {len(frames)}",
                                        LIDAR_FUSED_PER_FRAME))
                for key, shape in (("cls_preds", (1, 96, 176, 2)),
                                   ("reg_preds", (1, 96, 176, 14))):
                    if tuple(o[key].shape) != shape or \
                            not torch.isfinite(o[key]).all():
                        raise AssertionError(f"eval frame {len(frames)}: "
                                             f"{key} {tuple(o[key].shape)}")
                if maps is None:
                    maps = {k: v[0].float().cpu().numpy()
                            for k, v in o.items()}
                samples.append({k: batch[k][0].numpy().copy()
                                for k in kept_keys})
                frames.append({"wait_ms": wait_ms, "events_ms": ev_ms,
                               "host_ms": host_ms,
                               "agents": float(batch["agent_mask"].sum())})
                if traced:
                    out["forward_profile"] = prof
                    timed = (f"traced alone: device busy "
                             f"{prof['device_ms_per_step']:.2f} ms, idle "
                             f"{prof['device_idle_share']:.3f}")
                else:
                    timed = (f"{ev_ms:.2f} ms CUDA events (host "
                             f"{host_ms:.1f} ms)")
                log(f"eval frame {len(frames) - 1}: loader wait "
                    f"{wait_ms:.1f} ms, forward {timed}, "
                    f"{frames[-1]['agents']:.0f} agents, launches "
                    f"{LIDAR_FUSED_PER_FRAME}; {card}")
        loader.close()
        if len(frames) != LIDAR_DATA_STAMPS:
            raise AssertionError(f"{len(frames)} eval frames")
        out["eval_frames"] = frames
        out["forward_events_ms"] = float(np.median(
            [f["events_ms"] for f in frames[1:] if f["events_ms"]]))
        del eval_model

        # (d) train steps on the dataset's batches, across an epoch boundary
        schedule, wd, eps, clip = benchmark.train_recipe("pointpillar")
        state = create_train_state(
            model, make_optimizer(model.parameters(), schedule,
                                  weight_decay=wd, eps=eps),
            schedule, compute_dtype=torch.bfloat16, grad_clip=clip)
        loss_fn = PointPillarLoss()
        step = make_train_step(model, lambda o, b: loss_fn(o, b))
        gen = torch.Generator(device=device).manual_seed(seed)
        torch.manual_seed(seed)
        loader = DataLoader(train_ds, batch_size=1, shuffle=True, seed=seed,
                            num_workers=2, device=device)
        records, epoch = [], 0
        while len(records) < LIDAR_DATA_TRAIN_STEPS:
            loader.set_epoch(epoch)
            it = iter(loader)
            first = True
            while len(records) < LIDAR_DATA_TRAIN_STEPS:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                wait_ms = (time.perf_counter() - t0) * 1e3
                b = batch_to_device(batch, device)
                ops.reset_launch_counts()
                traced = len(records) == LIDAR_TRACED_STEP
                if traced:
                    logs, prof = traced_frame(lambda: step(state, b, gen))
                    ev_ms = host_ms = None
                    out["step_profile"] = prof
                else:
                    logs, ev_ms, host_ms = cuda_ms(
                        lambda: step(state, b, gen))
                add_counts(check_counts(f"train step {len(records) + 1}",
                                        LIDAR_TRAIN_PER_STEP))
                loss = float(logs["loss"])
                if not (math.isfinite(loss) and
                        math.isfinite(float(logs["grad_norm"]))):
                    raise AssertionError(f"train step {len(records) + 1}: "
                                         f"loss {loss}")
                samples.append({k: batch[k][0].numpy().copy()
                                for k in kept_keys})
                records.append({"epoch": epoch, "epoch_start": first,
                                "wait_ms": wait_ms, "events_ms": ev_ms,
                                "host_ms": host_ms, "loss": loss,
                                "grad_norm": float(logs["grad_norm"]),
                                "positives": float(
                                    batch["pos_equal_one"].sum())})
                if traced:
                    timed = (f"traced alone: device busy "
                             f"{prof['device_ms_per_step']:.2f} ms, idle "
                             f"{prof['device_idle_share']:.3f}")
                else:
                    timed = (f"{ev_ms:.2f} ms CUDA events (host "
                             f"{host_ms:.1f} ms)")
                log(f"train step {len(records)} (epoch {epoch}"
                    f"{', first batch' if first else ''}): loader wait "
                    f"{wait_ms:.1f} ms, step {timed}, loss {loss:.4f}, "
                    f"{records[-1]['positives']:.0f} positive anchors, "
                    f"launches {LIDAR_TRAIN_PER_STEP}; {card}")
                first = False
            t0 = time.perf_counter()
            it.close()
            close_ms = (time.perf_counter() - t0) * 1e3
            if len(records) == LIDAR_DATA_TRAIN_STEPS:
                # the iteration was abandoned: close() read the batches in
                # flight, then stopped the workers
                left = LIDAR_DATA_STAMPS - sum(r["epoch"] == epoch
                                               for r in records)
                out["abandoned_close_ms"] = close_ms
                log(f"close() of the train loader's abandoned iteration "
                    f"(epoch {epoch}, {left} batches not taken): "
                    f"{close_ms:.1f} ms; {card}")
            epoch += 1
        loader.close()
        del state, model, step
        torch.cuda.empty_cache()
        out["train_steps"] = records
        later = records[1:]
        out["step_events_ms"] = float(np.median(
            [r["events_ms"] for r in later if r["events_ms"]]))
        if "forward_profile" not in out or "step_profile" not in out:
            raise AssertionError("phase 17 traced no eval frame or no "
                                 "train step")
        ready = [r["wait_ms"] for r in later if not r["epoch_start"]]
        boundary = [r["wait_ms"] for r in later if r["epoch_start"]]
        if not boundary:
            raise AssertionError("the train loader crossed no epoch")
        out["loader_wait_ms"] = {"first": records[0]["wait_ms"],
                                 "ready": float(np.median(ready)),
                                 "epoch_boundary": boundary}
        log(f"loader wait a step: {out['loader_wait_ms']['ready']:.1f} ms "
            f"with the workers running (median), "
            f"{', '.join(f'{w:.1f}' for w in boundary)} ms at the epoch "
            f"boundary, {records[0]['wait_ms']:.1f} ms at the first step "
            f"(worker spawn); forward {out['forward_events_ms']:.2f} ms, "
            f"train step {out['step_events_ms']:.2f} ms (CUDA events, "
            f"medians of the untraced after the first); device busy "
            f"{out['forward_profile']['device_ms_per_step']:.2f} ms a "
            f"frame, {out['step_profile']['device_ms_per_step']:.2f} ms a "
            f"step (each traced alone); {card}")

    # (e) the ideal-map AP gate, its planted faults, the model's own maps
    t0 = time.perf_counter()
    gate = lidar_ideal_gate(post, samples)
    ap_s = time.perf_counter() - t0
    out["ideal_gate"] = gate
    out["ap_frames_per_s"] = len(samples) / ap_s
    roundtrip = [check_anchor_roundtrip(post, s["object_bbx_center"],
                                        s["object_bbx_mask"])
                 for s in samples]
    log(f"ideal maps: {len(samples)} samples, AP "
        f"{[r['ap'] for r in gate[:1]]} (first), min "
        f"{min(min(r['ap'].values()) for r in gate):.12f}, kept "
        f"{[r['kept'] for r in gate]} for {[r['gt'] for r in gate]} boxes; "
        f"anchor round trips {roundtrip}; decode + NMS + AP "
        f"{out['ap_frames_per_s']:.1f} frames/s; {card}")
    if not (lidar_gate_holds(gate) and all(roundtrip)):
        raise AssertionError("the ideal-map AP gate failed: "
                             + json.dumps(gate))
    out["faults"] = {}
    for fault in ("swap_xy", "shift"):
        rows = lidar_ideal_gate(post, samples, fault)
        out["faults"][fault] = rows
        worst = {t: min(r["ap"][t] for r in rows) for t in LIDAR_AP_IOUS}
        log(f"planted fault {fault}: lowest AP {worst}")
        if lidar_gate_holds(rows):
            raise AssertionError(f"the ideal-map gate passed the planted "
                                 f"fault {fault}")

    scores = 1 / (1 + np.exp(-maps["cls_preds"].reshape(-1)))
    out["model_candidates"] = int((scores > post.score_threshold).sum())
    t0 = time.perf_counter()
    corners, kept_scores = post.decode(maps["cls_preds"], maps["reg_preds"])
    out["model_decode_ms"] = (time.perf_counter() - t0) * 1e3
    out["model_kept"] = len(corners)
    log(f"decode of the model's eval maps (random weights): "
        f"{out['model_candidates']} of 33,792 anchors over the score "
        f"threshold {post.score_threshold}, {out['model_kept']} boxes kept "
        f"(max_num {post.max_num}), {out['model_decode_ms']:.1f} ms; {card}")

    routes = {k: {r: native_ops.route_calls[k][r] - routes_before[k][r]
                  for r in native_ops.ROUTES}
              for k in native_ops.route_calls}
    out["box_routes"] = routes
    log(f"box calls in this process by route: {routes}")
    for name in ("bbox_overlaps", "rotated_iou", "nms_rotated"):
        if routes[name]["numpy"] or not routes[name]["native"]:
            raise AssertionError(f"{name} did not run on the native route "
                                 f"alone: {routes[name]}")
    out["counts"] = counts_total
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 17: {out['seconds']:.1f} s")
    return out


def centered_margin_iou(a, b):
    """The argmax IoU of two (..., 2) logit maps taken about the median of
    ``b``'s margin (class 1 minus class 0), so that each class covers half
    the reference; at random weights one class may hold nearly every
    pixel, which leaves the plain argmax IoU to the few of the other."""
    import numpy as np
    m = np.median(b[..., 1] - b[..., 0])
    shift = np.zeros_like(b)
    shift[..., 1] = m
    return argmax_iou(a - shift, b - shift)


def zoo_frame(rng, cfg, n_live):
    """A synthetic padded request (serve_camera.synthetic_frame) with the
    four cameras yawed a quarter turn apart and every live agent but the
    ego turned by up to 0.3 rad and shifted by up to 8 m, its pairwise
    transforms (agent j's frame into agent i's at [j, i]) consistent with
    the agent -> ego ones."""
    import numpy as np
    from cobevt_tpu_torch.tools import serve_camera

    frame = serve_camera.synthetic_frame(rng, cfg, n_live)
    for m in range(4):
        a = m * np.pi / 2
        frame["extrinsic"][:, :, m, 0, 0] = np.cos(a)
        frame["extrinsic"][:, :, m, 0, 2] = np.sin(a)
        frame["extrinsic"][:, :, m, 2, 0] = -np.sin(a)
        frame["extrinsic"][:, :, m, 2, 2] = np.cos(a)
    tmat = frame["transformation_matrix"][0]
    for j in range(1, n_live):
        a = rng.uniform(-0.3, 0.3)
        tmat[j, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        tmat[j, :2, 3] = rng.uniform(-8.0, 8.0, 2)
    L = tmat.shape[0]
    frame["pairwise_t_matrix"][0] = np.stack([
        np.stack([np.linalg.inv(tmat[i]) @ tmat[j] for i in range(L)])
        for j in range(L)]).astype(np.float32)
    return frame


def _k3_skipped_residual(real, at=ZOO_K3_FAULT_CALL):
    """K3 whose ``at``-th call with a residual (from 1) skips it."""
    seen = [0]

    def call(*args, residual=None, **kwargs):
        if residual is not None:
            seen[0] += 1
            if seen[0] == at:
                residual = None
        return real(*args, residual=residual, **kwargs)
    return call


def _dropped_head(real):
    """K4 or K6 with the first head of its first window attention dropped:
    the output projection's columns of that head zeroed."""
    def call(x, mask, agent_mask, bias, packed, head, window, heads,
             **kwargs):
        first = dict(packed.layers[0][0])
        dh = first["wout_t"].shape[1] // heads
        first["wout_t"] = first["wout_t"].clone()
        first["wout_t"][:, :dh] = 0
        layers = [(first, packed.layers[0][1])] + list(packed.layers[1:])
        return real(x, mask, agent_mask, bias,
                    packed._replace(layers=layers), head, window, heads,
                    **kwargs)
    return call


# faults planted in one forward to show what the zoo gates (phases 18 and
# 19) catch: (the module whose name the model calls, the wrapper, the
# faulted wrapper).  Layer 2's second residual call is the one a map of
# layer 2 (ResNetEncoderSingle at id_pick 1) depends on.
ZOO_FAULTS = {
    "k3_skipped_residual": ("cobevt_tpu_torch.nn.layers", "fused_conv3x3",
                            _k3_skipped_residual),
    "k3_skipped_residual_layer2": (
        "cobevt_tpu_torch.nn.layers", "fused_conv3x3",
        lambda real: _k3_skipped_residual(real, 2)),
    "k4_dropped_head": ("cobevt_tpu_torch.models.fusion.swap_fusion",
                        "fused_swap_fusion", _dropped_head),
    "k6_dropped_head": ("cobevt_tpu_torch.models.fusion.swap_fusion",
                        "fused_swap_fusion_streaming", _dropped_head),
}


def zoo_faults(cfg):
    """The faults of ZOO_FAULTS that a camera zoo graph of ``cfg`` runs
    into."""
    return ["k3_skipped_residual"] + (
        ["k4_dropped_head"] if cfg.fusion == "swap" else [])


@contextlib.contextmanager
def planted_zoo_fault(name):
    """While open, the wrapper that fault ``name`` names runs faulted."""
    module_name, attr, make = ZOO_FAULTS[name]
    module = importlib.import_module(module_name)
    real = getattr(module, attr)
    setattr(module, attr, make(real))
    try:
        yield
    finally:
        setattr(module, attr, real)


def zoo_gate(got, ref, plain):
    """The zoo gate of a bf16 logit map with the kernels against its f32
    plain reference, beside the bf16 plain forward's map."""
    gate = drift_gate(got, ref, plain, ZOO_BUDGET, ZOO_WITNESS_RATIO)
    return {"max_rel_logit_err": gate["drift"],
            "bf16_plain_max_rel_logit_err": gate["bf16_plain_drift"],
            "centered_iou": centered_margin_iou(got, ref),
            "passes": gate["passes"]}


def zoo_gate_failures(what, sound, faulted):
    """The gate's verdicts as failures: ``sound`` must pass, each of
    ``faulted`` (fault -> gate) must not."""
    out = [] if sound["passes"] else [f"{what}: {sound}"]
    return out + [f"{what}: the gate passed the planted fault {f}: {g}"
                  for f, g in faulted.items() if g["passes"]]


def zoo_graph(name, seed):
    """One zoo graph at its preset's width, built as a user builds it
    (export_preset -> build_from_hypes), seeded, on the card: its bf16
    frames with the kernels, on the compute twin that ``--half`` training
    and serving use (train/state.py:compute_twin: bf16 weights, the f32
    master's BatchNorm statistics, as flax keeps batch_stats in f32),
    against the twin's weights in f32 on the plain versions (phase_slice's
    reference); beside them the twin's bf16 plain forward, and a forward
    with each planted fault.  Gate failures are returned in ``failures``
    for the phase to raise once every graph has been read."""
    import numpy as np
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.configs.hypes import build_from_hypes
    from cobevt_tpu_torch.tools.export_config import export_preset
    from cobevt_tpu_torch.train.state import compute_twin
    from cobevt_tpu_torch.utils.serving import to_device
    from cobevt_tpu_torch.utils.weights import seeded_init_

    cfg, master = build_from_hypes(export_preset(name))
    seeded_init_(master, seed)
    model = compute_twin(master.to("cuda").eval(), torch.bfloat16).eval()
    del master
    live = min(ZOO_LIVE, cfg.max_cav)
    batch = to_device(zoo_frame(np.random.RandomState(seed), cfg, live),
                      "cuda")
    per_frame = ZOO_SWAP_PER_FRAME if cfg.fusion == "swap" else ZOO_PER_FRAME
    row = {"fusion": cfg.fusion, "agents": cfg.max_cav, "live": live}
    if cfg.fusion == "swap":
        H = cfg.cvm.bev_height // 2 ** cfg.cvm.decoder_blocks
        row["fusion_kernel"] = model.fusion_net.fused_kernel(
            (1, cfg.max_cav, H, H, cfg.cvm.dim))
    with switches(None), torch.no_grad():
        with ops.forced_impl("torch"):
            ref_model = copy.deepcopy(model).float()
            ref = ref_model(batch)["dynamic_seg"].cpu().numpy()
            del ref_model
            plain = model(batch)["dynamic_seg"].float().cpu().numpy()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        host_ms = []
        for _ in range(ZOO_FRAMES):
            t0 = time.perf_counter()
            out = model(batch)["dynamic_seg"]
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        _, profiled = traced_frame(lambda: model(batch))
        faulted = {}
        for fault in zoo_faults(cfg):
            with planted_zoo_fault(fault):
                faulted[fault] = model(batch)["dynamic_seg"].float()
    for fn, n in counts.items():
        if n != per_frame.get(fn, 0) * ZOO_FRAMES:
            raise AssertionError(f"{name}: {fn} ran {n} launches over "
                                 f"{ZOO_FRAMES} frames, expected "
                                 f"{per_frame.get(fn, 0)} each")
    out = out.float().cpu().numpy()
    rows = cfg.max_cav if cfg.fusion == "none" else 1
    if out.shape != (1, rows, 256, 256, cfg.output_class) or \
            not np.isfinite(out).all():
        raise AssertionError(f"{name}: dynamic_seg {out.shape}, finite "
                             f"{bool(np.isfinite(out).all())}")
    row.update(
        counts=counts, host_ms=host_ms,
        device_ms=profiled["device_ms_per_step"],
        device_idle_share=profiled["device_idle_share"],
        top_device_ops=profiled["top_device_ops"][:6],
        argmax_iou=argmax_iou(out, ref),
        bf16_plain_argmax_iou=argmax_iou(plain, ref),
        gate=zoo_gate(out, ref, plain),
        faults={f: zoo_gate(t.cpu().numpy(), ref, plain)
                for f, t in faulted.items()})
    row["failures"] = zoo_gate_failures(name, row["gate"], row["faults"])
    log(f"{name} ({cfg.fusion}, {live} of {cfg.max_cav} agents live): "
        f"device {row['device_ms']:.3f} ms a frame (traced alone, idle "
        f"{row['device_idle_share']:.3f}), host "
        f"{[round(t, 2) for t in host_ms]} ms, peak {row['peak_gb']:.2f} GB, "
        f"launches a frame K3 {counts['fused_conv3x3'] // ZOO_FRAMES} K4 "
        f"{counts['fused_swap_fusion'] // ZOO_FRAMES} K1 "
        f"{counts['fused_window_attention_packed'] // ZOO_FRAMES}"
        + (f" (fusion kernel {row['fusion_kernel']})"
           if "fusion_kernel" in row else "")
        + f"; bf16 kernels vs f32 plain: argmax IoU {row['argmax_iou']:.5f}"
        f" (bf16 plain {row['bf16_plain_argmax_iou']:.5f}), gate "
        f"{json.dumps(row['gate'])}, planted faults "
        f"{json.dumps(row['faults'])}; {card_line()}")
    log(f"{name} top device ops: " + json.dumps(row["top_device_ops"]))
    del model, batch, faulted
    torch.cuda.empty_cache()
    return row


def zoo_serving(run, tmp, seed):
    """serve_camera --model_dir on the cvt_swap_fuse checkpoint under
    --bucketing staged (the sliced BucketedRunner: the graph has no stage=
    split) and off (FullRunner); the sliced frames held by the zoo gate to
    the same runner over the served weights in f32 on the plain versions,
    each planted fault failing it.  Gate failures are returned in
    ``failures`` for the phase to raise."""
    import numpy as np
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.configs.hypes import build_from_hypes, load_hypes
    from cobevt_tpu_torch.tools import serve_camera
    from cobevt_tpu_torch.train.checkpoint import load_model_weights
    from cobevt_tpu_torch.train.state import compute_twin
    from cobevt_tpu_torch.utils.serving import BucketedRunner

    out = {}
    for bucketing, runner in (("staged", "BucketedRunner"),
                              ("off", "FullRunner")):
        pred = os.path.join(tmp, f"serve_{bucketing}")
        ops.reset_launch_counts()
        summary = serve_camera.main([
            "--model_dir", run, "--synthetic", str(ZOO_SERVE_FRAMES),
            "--half", "--bucketing", bucketing, "--out_dir", pred,
            "--seed", str(seed)])
        counts = ops.launch_counts()
        served = summary["frames"] + len(summary["buckets"])
        expect = {k: served * ZOO_SWAP_PER_FRAME.get(k, 0) for k in counts}
        if summary["runner"] != runner or counts != expect:
            raise AssertionError(f"serve_camera --bucketing {bucketing}: "
                                 f"{summary['runner']}, launches {counts} "
                                 f"over {served} frames (warmups included)")
        out[bucketing] = {k: summary[k] for k in (
            "runner", "frames", "p50_ms", "p95_ms", "frames_per_sec",
            "buckets")}
        out[bucketing]["counts"] = counts
        log(f"serve_camera cvt_swap_fuse --bucketing {bucketing}: "
            f"{summary['runner']}, p50 {summary['p50_ms']:.2f} ms a request "
            f"over {summary['frames']} requests, buckets "
            f"{ {n: round(b['p50_ms'], 2) for n, b in summary['buckets'].items()} }"
            f"; {card_line()}")

    # the sliced frames are what the JAX semantics give: held to the same
    # runner over the served weights in f32 on the plain versions, not to
    # the padded forward; beside them the bf16 plain run, the unrounded f32
    # master's plain run, and each planted fault
    hypes = load_hypes(os.path.join(run, "config.yaml"))
    cfg, master = build_from_hypes(hypes)
    load_model_weights(run, master)
    master = master.to("cuda").eval()
    twin = compute_twin(master, torch.bfloat16).eval()
    sliced = BucketedRunner(twin)
    ref_runner = BucketedRunner(copy.deepcopy(twin).float())
    master_runner = BucketedRunner(master)
    frames = serve_camera.synthetic_frames(np.random.RandomState(seed), cfg,
                                           ZOO_SERVE_FRAMES)
    rows, failures = [], []
    for i, (n, frame) in enumerate(frames):
        got = sliced(frame)["dynamic_seg"].float().cpu().numpy()
        faulted = {}
        for fault in zoo_faults(cfg):
            with planted_zoo_fault(fault):
                faulted[fault] = sliced(frame)["dynamic_seg"].float()
        with ops.forced_impl("torch"):
            ref = ref_runner(frame)["dynamic_seg"].cpu().numpy()
            plain = sliced(frame)["dynamic_seg"].float().cpu().numpy()
            unrounded = master_runner(frame)["dynamic_seg"].cpu().numpy()
        name = f"frame_{i:06d}.npz"
        served = np.load(os.path.join(tmp, "serve_staged", name))
        padded = np.load(os.path.join(tmp, "serve_off", name))
        if int(served["n_agents"]) != n:
            raise AssertionError(f"{name}: {served['n_agents']} agents, "
                                 f"expected {n}")
        margin = ref[..., 1] - ref[..., 0]
        r = {"agents": n,
             "served_argmax_iou": seg_iou(served["seg"], ref.argmax(-1)),
             "bf16_plain_argmax_iou": argmax_iou(plain, ref),
             "gate": zoo_gate(got, ref, plain),
             "faults": {f: zoo_gate(t.cpu().numpy(), ref, plain)
                        for f, t in faulted.items()},
             "vs_unrounded_argmax_iou": argmax_iou(got, unrounded),
             "rounded_weights_argmax_iou": argmax_iou(ref, unrounded),
             "margin_range": [float(margin.min()), float(margin.max())],
             "share_within_drift": float((np.abs(margin) <= np.abs(
                 (got[..., 1] - got[..., 0]) - margin).max()).mean()),
             "reference_class_shares": (np.bincount(
                 ref.argmax(-1).ravel(), minlength=cfg.output_class)
                 / margin.size).tolist(),
             "served_vs_padded_iou": seg_iou(served["seg"], padded["seg"])}
        rows.append(r)
        failures += zoo_gate_failures(f"sliced frame {i} ({n} agents)",
                                      r["gate"], r["faults"])
        log(f"sliced frame, {n} agents: served map vs the runner's f32 plain"
            f" argmax IoU {r['served_argmax_iou']:.5f} (bf16 plain "
            f"{r['bf16_plain_argmax_iou']:.5f}), gate {json.dumps(r['gate'])}"
            f", planted faults {json.dumps(r['faults'])}; against the unrounded f32 "
            f"master: kernels {r['vs_unrounded_argmax_iou']:.5f}, the "
            f"rounded weights in f32 {r['rounded_weights_argmax_iou']:.5f}; "
            f"reference margin range {np.round(r['margin_range'], 4).tolist()}"
            f", share within the kernels' margin drift "
            f"{r['share_within_drift']:.4f}, class shares "
            f"{np.round(r['reference_class_shares'], 4).tolist()}; vs the "
            f"padded forward (not a gate: its fusion averages over max_cav "
            f"rows) {r['served_vs_padded_iou']:.5f}")
    out["sliced_frames"] = rows
    out["failures"] = failures
    del sliced, ref_runner, master_runner, twin, master
    torch.cuda.empty_cache()
    return out


def zoo_train_camera(tmp, seed):
    """tools/train_camera.py on the phase-15 fixture with the full-width
    cvt_swap_fuse hypes (2 bf16 steps at batch 1, a validation frame, a
    save), then a bit-for-bit restore of its checkpoint.  Returns (summary,
    run dir)."""
    import math

    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.configs.hypes import load_hypes
    from cobevt_tpu_torch.tools import train_camera
    from cobevt_tpu_torch.train import create_train_state, make_optimizer
    from cobevt_tpu_torch.train.checkpoint import restore_checkpoint
    from cobevt_tpu_torch.train.optim import constant_schedule

    path, _, _, _ = camera_run_hypes(
        tmp, "cvt_swap_fuse", (ZOO_TRAIN_CAVS, ZOO_TRAIN_STAMPS),
        (ZOO_VAL_CAVS, ZOO_VAL_STAMPS), seed)
    run = os.path.join(tmp, "run")
    train_calls, eval_calls = [], []
    t0 = time.perf_counter()
    with counted_steps(train_calls, eval_calls):
        trainer = train_camera.main(["--hypes_yaml", path, "--save_dir", run,
                                     "--half", "--log_every", "1"])
    wall = time.perf_counter() - t0
    read_step_events(train_calls)
    check_calls("cvt_swap_fuse train step",
                [c["launches"] for c in train_calls],
                dict(ZOO_TRAIN_PER_STEP, composite=0), ZOO_TRAIN_STAMPS)
    check_calls("cvt_swap_fuse validation frame",
                [c["launches"] for c in eval_calls],
                dict(ZOO_SWAP_PER_FRAME, composite=0), ZOO_VAL_STAMPS)
    steps = [{"step": r["step"], "loss": r["scalars"]["loss"],
              "grad_norm": r["scalars"]["grad_norm"],
              "host_ms": r["step_s"] * 1e3, "events_ms": c["events_ms"]}
             for r, c in zip(trainer.records, train_calls)]
    for s_ in steps:
        log(f"train_camera cvt_swap_fuse step {s_['step']}: loss "
            f"{s_['loss']:.5f}, gradient norm {s_['grad_norm']:.4f}, host "
            f"{s_['host_ms']:.1f} ms, CUDA events {s_['events_ms']:.1f} ms; "
            f"{card_line()}")
        if not (math.isfinite(s_["loss"]) and math.isfinite(s_["grad_norm"])):
            raise AssertionError(f"train_camera cvt_swap_fuse: step {s_}")
    counts = {k: sum(c["launches"].get(k, 0)
                     for c in train_calls + eval_calls)
              for k in ops.launch_counts()}
    device = trainer.device
    saved = trainer.state
    _, model, _ = train_camera.build_from_hypes(
        load_hypes(os.path.join(run, "config.yaml")), device, seed + 1)
    fresh = create_train_state(
        model, make_optimizer(model.parameters(), constant_schedule(0.0)),
        constant_schedule(0.0), compute_dtype=torch.bfloat16)
    fresh, _ = restore_checkpoint(run, fresh)
    check_same_state("cvt_swap_fuse restore", saved, fresh)
    log(f"train_camera cvt_swap_fuse: {len(steps)} steps + validation + "
        f"save in {wall:.1f} s, launches {counts}; the checkpoint restores "
        f"bit for bit (parameters, BatchNorm buffers, AdamW moments, step "
        f"{fresh.step})")
    del fresh, model, trainer, saved
    torch.cuda.empty_cache()
    return {"steps": steps, "counts": counts, "seconds": wall}, run


def zoo_train_nuscenes(tmp, seed):
    """tools/train_nuscenes.py --experiment cvt_nuscenes_vehicle on a
    synthetic scene set (ZOO_NUSC_STEPS bf16 steps at B 8, a checkpoint at
    the last, the IoU pass), then a bit-for-bit restore of that
    checkpoint."""
    import math

    import numpy as np
    import torch
    from cobevt_tpu_torch.configs.nuscenes_experiments import (
        build_model,
        nuscenes_experiment,
    )
    from cobevt_tpu_torch.tools import bench_input, train_nuscenes
    from cobevt_tpu_torch.train import create_train_state, make_optimizer
    from cobevt_tpu_torch.train.checkpoint import restore_step_checkpoint
    from cobevt_tpu_torch.train.optim import constant_schedule

    exp = nuscenes_experiment("cvt_nuscenes_vehicle")
    data, labels = bench_input.write_nuscenes_fixture(
        os.path.join(tmp, "nuscenes"), ZOO_NUSC_SCENES, ZOO_NUSC_SAMPLES,
        seed=seed, camera_pool=NUSC_CLI_POOL)
    save = os.path.join(tmp, "nuscenes_run")
    train_calls, eval_calls = [], []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_steps(train_calls, eval_calls, train_nuscenes):
        run = train_nuscenes.main([
            "--dataset_dir", data, "--labels_dir", labels, "--save_dir", save,
            "--half", "--experiment", exp.name, "--steps",
            str(ZOO_NUSC_STEPS), "--ckpt_every", str(ZOO_NUSC_STEPS)])
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    read_step_events(train_calls)
    check_calls("cvt_nuscenes_vehicle step",
                [c["launches"] for c in train_calls], {}, ZOO_NUSC_STEPS)
    check_calls("cvt_nuscenes_vehicle IoU-pass frame",
                [c["launches"] for c in eval_calls], {},
                ZOO_NUSC_SCENES * ZOO_NUSC_SAMPLES)
    steps = [{"step": r["step"], "loss": c["loss"],
              "host_ms": r["step_s"] * 1e3, "loader_ms": r["loader_s"] * 1e3,
              "events_ms": c["events_ms"]}
             for r, c in zip(run.records, train_calls)]
    for s_ in steps:
        log(f"train_nuscenes cvt_nuscenes_vehicle step {s_['step']}: loss "
            f"{s_['loss']:.5f}, host {s_['host_ms']:.1f} ms, waiting on the "
            f"loader {s_['loader_ms']:.1f} ms, CUDA events "
            f"{s_['events_ms']:.1f} ms; {card_line()}")
        if not math.isfinite(s_["loss"]):
            raise AssertionError(f"train_nuscenes cvt_nuscenes_vehicle: "
                                 f"step {s_}")
    ious = np.concatenate([run.iou_visible, run.iou_all])
    if not np.all(np.isfinite(ious)):
        raise AssertionError(f"train_nuscenes cvt_nuscenes_vehicle IoU "
                             f"{ious}")
    iou_visible, iou_all = run.iou_visible.tolist(), run.iou_all.tolist()
    saved = run.state
    model = build_model(exp).to(next(saved.model.parameters()).device)
    fresh = create_train_state(
        model, make_optimizer(model.parameters(), constant_schedule(0.0)),
        constant_schedule(0.0), compute_dtype=torch.bfloat16)
    fresh, got = restore_step_checkpoint(os.path.join(save, "ckpt"), fresh)
    if got != ZOO_NUSC_STEPS:
        raise AssertionError(f"cvt_nuscenes_vehicle restore: step {got}")
    check_same_state("cvt_nuscenes_vehicle restore", saved, fresh)
    log(f"train_nuscenes cvt_nuscenes_vehicle: {len(steps)} steps + IoU "
        f"pass over {len(eval_calls)} frames in {wall:.1f} s, peak "
        f"{peak_gb:.2f} GB; IoU (vis>=2) {iou_visible}, (with occlusions) "
        f"{iou_all}; the step-{got} checkpoint restores bit for bit")
    del fresh, model, saved, run
    torch.cuda.empty_cache()
    return {"steps": steps, "seconds": wall, "peak_gb": peak_gb,
            "iou_visible": iou_visible, "iou_all": iou_all}


def phase_zoo(seed=0):
    """Phase 18: the camera zoo at its presets' widths (see the module
    docstring)."""
    import tempfile

    t_phase = time.perf_counter()
    log("== phase 18: the camera zoo: cvt, cvt_att_fuse, cvt_swap_fuse, "
        "cvt_fcooper, cvt_v2vnet, cvt_disconet (ResNet-34, 4 cameras x "
        "512^2, dense CVT at 32^2, BEV 256^2), bf16 kernels vs f32 plain")
    out = {"graphs": {name: zoo_graph(name, seed) for name in ZOO_GRAPHS}}
    with tempfile.TemporaryDirectory(prefix="cobevt_zoo_") as tmp:
        log("== phase 18: train_camera on cvt_swap_fuse.yaml, then "
            "serve_camera from its checkpoint")
        out["train_camera"], run = zoo_train_camera(tmp, seed)
        out["serve"] = zoo_serving(run, tmp, seed)
        log("== phase 18: train_nuscenes --experiment cvt_nuscenes_vehicle "
            "(EfficientNet-b4, 6 cameras x 224 x 480, B 8, BEV 200^2)")
        out["train_nuscenes"] = zoo_train_nuscenes(tmp, seed)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 18: {out['seconds']:.1f} s")
    failures = [f for g in out["graphs"].values() for f in g["failures"]]
    failures += out["serve"]["failures"]
    if failures:
        raise AssertionError("the zoo gate: " + "; ".join(failures))
    return out


def traced_frame(fn):
    """fn() alone under torch.profiler, the device synchronized before and
    after: its result and its device profile (tools/timing.py)."""
    import torch
    from cobevt_tpu_torch.tools.timing import device_profile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return result, device_profile(prof, 1, wall_ms)


def rel_drift(got, ref):
    """Largest |got - ref| over the largest |ref| (numpy arrays or
    tensors, or dicts of them: the largest over every output)."""
    if isinstance(ref, dict):
        return max(rel_drift(got[k], ref[k]) for k in ref)
    return float(abs(got - ref).max() / (abs(ref).max() + 1e-12))


def drift_gate(got, ref, plain, budget, ratio):
    """A bf16 output with its kernels against its f32 plain reference:
    its largest deviation within ``budget`` of the reference's largest
    value and within ``ratio`` times the bf16 plain forward's deviation
    (the witness), and finite (numpy arrays or tensors)."""
    import math
    drift, witness = rel_drift(got, ref), rel_drift(plain, ref)
    return {"drift": drift, "bf16_plain_drift": witness,
            "passes": math.isfinite(drift) and drift <= budget
            and drift <= ratio * witness}


def second_hypes(tmp, max_voxels):
    """A SECOND hypes file (JSON text, valid YAML) at the JAX SecondConfig's
    geometry with swap fusion, written into ``tmp``; its path."""
    lidar_range = [-70.4, -40.0, -3.0, 70.4, 40.0, 1.0]
    hypes = {
        "name": "second_swap_fusion",
        "yaml_parser": "load_second_params",
        "train_params": {"batch_size": 1, "epoches": 1,
                         "max_cav": SECOND_CAVS},
        "preprocess": {
            "core_method": "SpVoxelPreprocessor",
            "args": {"voxel_size": [0.1, 0.1, 0.1],
                     "max_points_per_voxel": SECOND_POINTS_PER_VOXEL,
                     "max_voxel_train": max_voxels,
                     "max_voxel_test": max_voxels},
            "cav_lidar_range": lidar_range},
        "postprocess": {
            "core_method": "VoxelPostprocessor",
            "anchor_args": {"cav_lidar_range": lidar_range, "l": 3.9,
                            "w": 1.6, "h": 1.56, "r": [0, 90],
                            "feature_stride": 8, "num": 2},
            "order": "hwl"},
        "model": {"core_method": "second", "args": {
            "mean_vfe": {"num_point_features": 4},
            "base_bev_backbone": {
                "layer_nums": [5, 5], "layer_strides": [1, 2],
                "num_filters": [128, 256], "upsample_strides": [1, 2],
                "num_upsample_filter": [256, 256]},
            "fusion": {"core_method": "swap", "window_size": 4,
                       "dim_head": 32, "mlp_dim": 256, "depth": 1,
                       "drop_out": 0.0}}},
    }
    path = os.path.join(tmp, "second_swap.yaml")
    with open(path, "w") as f:
        json.dump(hypes, f, indent=1)
    return path


def second_from_clouds(tmp, seed):
    """Phase 19's SECOND: the scenario, the voxel count, the hypes through
    load_hypes, the model at full width, its bf16 eval frames at 5 and 3
    live agents with their gate and planted K6 fault, 2 bf16 train steps
    on f32 masters and the LiDAR gradient gate."""
    import math

    import numpy as np
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.configs.hypes import load_hypes
    from cobevt_tpu_torch.data.lidar_preprocess import (
        load_pcd,
        mask_ego_points,
        mask_points_by_range,
    )
    from cobevt_tpu_torch.data.loader import DataLoader
    from cobevt_tpu_torch.data.opv2v import OPV2VScenarioDatabase
    from cobevt_tpu_torch.data.opv2v_lidar import OPV2VLidarDataset
    from cobevt_tpu_torch.data.voxelize import occupied_voxels, voxelize_points
    from cobevt_tpu_torch.losses.detection_loss import PointPillarLoss
    from cobevt_tpu_torch.models.lidar.second_models import (
        SecondDetector,
        second_config_from_hypes,
    )
    from cobevt_tpu_torch.ops.dispatch import env_switches
    from cobevt_tpu_torch.postprocess.voxel_postprocessor import (
        AnchorArgs,
        VoxelPostprocessor,
    )
    from cobevt_tpu_torch.tools import benchmark, validate_kernels
    from cobevt_tpu_torch.tools.lidar_fixture import write_lidar_scenario
    from cobevt_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from cobevt_tpu_torch.train.loop import batch_to_device
    from cobevt_tpu_torch.utils.weights import seeded_init_

    card = card_line()
    device = torch.device("cuda", torch.cuda.current_device())
    out, failures = {}, []
    t0 = time.perf_counter()
    paths = write_lidar_scenario(tmp, SECOND_CAVS, SECOND_STAMPS,
                                 LIDAR_DATA_VEHICLES, LIDAR_DATA_POINTS,
                                 seed=seed)
    out["fixture_s"] = time.perf_counter() - t0

    # every occupied voxel of every cloud is kept: max_voxels covers them
    voxel = (0.1, 0.1, 0.1)
    lidar_range = (-70.4, -40.0, -3.0, 70.4, 40.0, 1.0)
    occupied, vox_ms = [], []
    for path in paths:
        pts = mask_ego_points(mask_points_by_range(load_pcd(path),
                                                   lidar_range))
        occupied.append(occupied_voxels(pts, voxel, lidar_range))
        t0 = time.perf_counter()
        voxelize_points(pts, voxel, lidar_range, occupied[-1],
                        SECOND_POINTS_PER_VOXEL)
        vox_ms.append((time.perf_counter() - t0) * 1e3)
    max_voxels = max(occupied)
    out.update(occupied_voxels=occupied, max_voxels=max_voxels,
               voxelize_ms=float(np.mean(vox_ms)))
    log(f"SECOND fixture: {len(paths)} clouds in {out['fixture_s']:.1f} s; "
        f"occupied 0.1 m voxels a cloud {min(occupied)}-{max_voxels} (all "
        f"kept: max_voxels {max_voxels}, {SECOND_POINTS_PER_VOXEL} points "
        f"a voxel); voxelize_points {out['voxelize_ms']:.1f} ms a cloud; "
        f"{card}")

    hypes = load_hypes(second_hypes(tmp, max_voxels))
    cfg = second_config_from_hypes(hypes)
    aa = hypes["postprocess"]["anchor_args"]
    out["config"] = {"grid_size": list(cfg.grid_size),
                     "anchor_args": {k: aa[k] for k in
                                     ("W", "H", "D", "vw", "vh", "vd",
                                      "feature_stride")},
                     "fusion": cfg.fusion, "max_cav": cfg.max_cav}
    log(f"SECOND hypes through load_hypes (load_second_params): "
        f"{json.dumps(out['config'])}")
    if tuple(cfg.grid_size) != (1408, 800, 40) or cfg.fusion != "swap":
        raise AssertionError(f"SECOND config {cfg}")
    post = VoxelPostprocessor(AnchorArgs(
        cav_lidar_range=tuple(aa["cav_lidar_range"]), vw=aa["vw"],
        vh=aa["vh"], W=aa["W"], H=aa["H"],
        feature_stride=aa["feature_stride"]))
    kw = dict(voxel_size=voxel, lidar_range=lidar_range,
              max_voxels=max_voxels,
              max_points_per_voxel=SECOND_POINTS_PER_VOXEL, max_objects=100)
    eval_ds = OPV2VLidarDataset(
        OPV2VScenarioDatabase(tmp, max_cav=SECOND_CAVS), post, train=False,
        **kw)
    train_ds = OPV2VLidarDataset(
        OPV2VScenarioDatabase(tmp, max_cav=SECOND_CAVS), post, train=True,
        seed=seed, **kw)

    master = SecondDetector(cfg)
    seeded_init_(master, seed)
    master = master.to(device).eval()
    model = copy.deepcopy(master).to(torch.bfloat16).eval()
    H, W = cfg.grid_size[1] // 8, cfg.grid_size[0] // 8
    fmap = (1, cfg.max_cav, H, W, cfg.bev_channels)
    out["fused_kernel"] = model.fusion_net.fused_kernel(fmap)
    log(f"SECOND: fused map {fmap}, the dispatch takes "
        f"{out['fused_kernel']} (fused_kernel)")
    if out["fused_kernel"] != "K6":
        raise AssertionError(f"SECOND's map dispatches to "
                             f"{out['fused_kernel']}, not K6")

    # (a) bf16 eval frames, each at 5 and at 3 live agents
    frames, counts_total = [], {}
    loader = DataLoader(eval_ds, batch_size=1, shuffle=False,
                        drop_last=False, num_workers=2, device=device)
    it = iter(loader)
    with switches(None), torch.no_grad():
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            wait_ms = (time.perf_counter() - t0) * 1e3
            b = batch_to_device(batch, device)
            for n in SECOND_LIVE:
                req = dict(b, agent_mask=b["agent_mask"].clone())
                req["agent_mask"][:, n:] = 0.0
                model(req)                      # warm
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                got = model(req)
                stop.record()
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
                counts = ops.launch_counts()
                peak = torch.cuda.max_memory_allocated() / 1e9
                for fn, c in counts.items():
                    if c != SECOND_PER_FRAME.get(fn, 0):
                        raise AssertionError(f"SECOND frame: {fn} ran {c} "
                                             f"launches")
                    counts_total[fn] = counts_total.get(fn, 0) + c
                for key, shape in (("cls_preds", (1, H, W, 2)),
                                   ("reg_preds", (1, H, W, 14))):
                    if tuple(got[key].shape) != shape:
                        raise AssertionError(f"SECOND {key} "
                                             f"{tuple(got[key].shape)}")
                _, prof = traced_frame(lambda: model(req))
                with ops.forced_impl("torch"):
                    plain = model(req)
                    torch.cuda.empty_cache()
                    ref = master(req)
                with planted_zoo_fault("k6_dropped_head"):
                    faulted = model(req)
                gate = validate_kernels.compare_outputs(
                    f"second_bf16_kernels_vs_f32_plain_{n}_live", got, ref,
                    validate_kernels.BUDGET_FORWARD)
                witness = validate_kernels.compare_outputs(
                    f"second_bf16_plain_vs_f32_plain_{n}_live", plain, ref,
                    validate_kernels.BUDGET_FORWARD)
                fault = validate_kernels.compare_outputs(
                    f"second_k6_dropped_head_vs_f32_plain_{n}_live", faulted,
                    ref, validate_kernels.BUDGET_FORWARD)
                vs_plain = rel_drift(got, plain)
                row = {"sample": len(frames) // len(SECOND_LIVE),
                       "live": n, "loader_wait_ms": wait_ms,
                       "events_ms": start.elapsed_time(stop),
                       "host_ms": host_ms, "peak_gb": peak,
                       "device_ms": prof["device_ms_per_step"],
                       "device_idle_share": prof["device_idle_share"],
                       "top_device_ops": prof["top_device_ops"][:8],
                       "counts": counts, "gate": gate,
                       "bf16_plain_witness": witness,
                       "kernels_vs_bf16_plain": vs_plain,
                       "k6_dropped_head": fault}
                frames.append(row)
                if not gate["ok"]:
                    failures.append(f"SECOND frame ({n} live): {gate}")
                if fault["ok"]:
                    failures.append(f"SECOND ({n} live): the gate passed the "
                                    f"planted K6 fault: {fault}")
                log(f"SECOND eval frame, sample {row['sample']}, {n} of "
                    f"{SECOND_CAVS} agents live: device "
                    f"{row['device_ms']:.2f} ms (traced alone, idle "
                    f"{row['device_idle_share']:.3f}), CUDA events "
                    f"{row['events_ms']:.2f} ms, host {host_ms:.1f} ms, "
                    f"loader wait {wait_ms:.1f} ms, peak {peak:.2f} GB, "
                    f"launches K6 {counts['fused_swap_fusion_streaming']} "
                    f"K1 {counts['fused_window_attention_packed']}; gate "
                    f"(bf16 kernels vs f32 plain, budget "
                    f"{validate_kernels.BUDGET_FORWARD}) "
                    f"{json.dumps(gate['outputs'])}; bf16 plain witness "
                    f"{json.dumps(witness['outputs'])}; kernels vs bf16 "
                    f"plain {vs_plain:.4g}; K6 head dropped "
                    f"{json.dumps(fault['outputs'])}; {card}")
                log("SECOND top device ops: "
                    + json.dumps(row["top_device_ops"]))
                del got, plain, ref, faulted
                torch.cuda.empty_cache()
    loader.close()
    out["eval_frames"] = frames
    if len(frames) != SECOND_STAMPS * len(SECOND_LIVE):
        raise AssertionError(f"SECOND: {len(frames)} eval frames")
    del model

    # (b) bf16 train steps on f32 masters with the detection loss
    master.train()
    schedule, wd, eps, clip = benchmark.train_recipe("pointpillar")
    state = create_train_state(
        master, make_optimizer(master.parameters(), schedule,
                               weight_decay=wd, eps=eps),
        schedule, compute_dtype=torch.bfloat16, grad_clip=clip)
    loss_fn = PointPillarLoss()

    def criterion(o, b):
        return loss_fn(o, b)
    step = make_train_step(master, criterion)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.manual_seed(seed)
    loader = DataLoader(train_ds, batch_size=1, shuffle=False,
                        num_workers=2, device=device)
    steps, last = [], None
    with switches(None):
        for batch in loader:
            b = batch_to_device(batch, device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            logs = step(state, b, gen)
            stop.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            for fn, c in counts.items():
                if c != SECOND_TRAIN_PER_STEP.get(fn, 0):
                    raise AssertionError(f"SECOND train step: {fn} ran {c} "
                                         f"launches")
                counts_total[fn] = counts_total.get(fn, 0) + c
            loss = float(logs["loss"])
            gnorm = float(logs["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"SECOND train step: loss {loss}, "
                                     f"gradient norm {gnorm}")
            row = {"events_ms": start.elapsed_time(stop), "host_ms": host_ms,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "loss": loss, "grad_norm": gnorm,
                   "positives": float(batch["pos_equal_one"].sum()),
                   "counts": counts}
            steps.append(row)
            last = b
            log(f"SECOND train step {len(steps)} (bf16 on f32 masters, "
                f"{SECOND_CAVS} agents): CUDA events {row['events_ms']:.1f} "
                f"ms, host {host_ms:.1f} ms, peak {row['peak_gb']:.2f} GB, "
                f"loss {loss:.4f}, gradient norm {gnorm:.4f}, "
                f"{row['positives']:.0f} positive anchors, launches K1 "
                f"{counts['fused_window_attention_packed']} K5 "
                f"{counts['fused_window_attention_packed_bwd']}; {card}")
            if len(steps) == SECOND_TRAIN_STEPS:
                break
    loader.close()
    out["train_steps"] = steps
    if len(steps) != SECOND_TRAIN_STEPS:
        raise AssertionError(f"SECOND: {len(steps)} train steps")

    # (c) the LiDAR gradient gate: K1 + K5 against COBEVT_FLASH_BWD=0
    compute = state.compute_model
    with env_switches(COBEVT_FLASH_BWD=None, COBEVT_FLASH_BWD_F32=None):
        flash = validate_kernels.step_gradients(compute, criterion, last,
                                                seed)
    with env_switches(COBEVT_FLASH_BWD="0", COBEVT_FLASH_BWD_F32=None):
        stock = validate_kernels.step_gradients(compute, criterion, last,
                                                seed)
    gate = validate_kernels.compare_step(
        flash, stock, *validate_kernels.TRAIN_BUDGETS["pointpillar"],
        metric="norm")
    out["gradient_gate"] = gate
    log(f"SECOND gradient gate (K1 + K5 vs COBEVT_FLASH_BWD=0, bf16, "
        f"TRAIN_BUDGETS['pointpillar']): ok {gate['ok']}, scalars "
        f"{json.dumps(gate['scalars'])}, worst "
        f"{json.dumps(gate['worst_material_params'])}")
    if not gate["ok"]:
        failures.append(f"SECOND gradient gate: {json.dumps(gate)}")
    del state, step, master, compute, flash, stock, last
    torch.cuda.empty_cache()
    out["counts"] = counts_total
    out["failures"] = failures
    return out


def att_bev_frames(tmp, seed):
    """AttBEVBackbone at PointPillarConfig's backbone widths on the pillar
    BEV of phase 19's scenario (5 agents, 3 live), compression 0 and 1:
    bf16 against its f32 plain forward, device ms, peak memory, and a
    padded agent's features changed without changing the output."""
    import torch
    from cobevt_tpu_torch.data.opv2v import OPV2VScenarioDatabase
    from cobevt_tpu_torch.data.opv2v_lidar import OPV2VLidarDataset
    from cobevt_tpu_torch.models.lidar.bev_backbone import AttBEVBackbone
    from cobevt_tpu_torch.models.lidar.pillar_encoder import (
        PillarVFE,
        pillar_scatter,
    )
    from cobevt_tpu_torch.models.lidar.point_pillar_models import (
        PointPillarConfig,
    )
    from cobevt_tpu_torch.postprocess.voxel_postprocessor import (
        AnchorArgs,
        VoxelPostprocessor,
    )
    from cobevt_tpu_torch.tools import benchmark, validate_kernels
    from cobevt_tpu_torch.utils.weights import seeded_init_

    card = card_line()
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = PointPillarConfig(max_cav=SECOND_CAVS,
                            point_cloud_range=benchmark.POINTPILLAR_RANGE)
    post = VoxelPostprocessor(AnchorArgs(
        cav_lidar_range=cfg.point_cloud_range, W=352, H=192,
        feature_stride=2))
    ds = OPV2VLidarDataset(
        OPV2VScenarioDatabase(tmp, max_cav=SECOND_CAVS), post, train=False,
        voxel_size=cfg.voxel_size, lidar_range=cfg.point_cloud_range,
        max_voxels=cfg.max_voxels,
        max_points_per_voxel=cfg.max_points_per_voxel)
    sample = {k: torch.as_tensor(v)[None].to(device)
              for k, v in ds[0].items() if k.startswith("voxel_")}
    vfe = PillarVFE(cfg.pillar_filters, True, False, True, cfg.voxel_size,
                    cfg.point_cloud_range)
    seeded_init_(vfe, seed)
    vfe = vfe.to(device).eval()
    B, L, N, P, _ = sample["voxel_features"].shape
    with torch.no_grad():
        coords = sample["voxel_coords"].reshape(B * L * N, 4)
        pillars = vfe(sample["voxel_features"].reshape(B * L * N, P, 4),
                      sample["voxel_num_points"].reshape(B * L * N), coords)
        agent = torch.arange(B * L, device=device).repeat_interleave(N)
        coords = torch.cat([agent[:, None].to(coords.dtype), coords[:, 1:]],
                           dim=1)
        canvas = pillar_scatter(pillars, coords, B * L, cfg.grid_size,
                                sample["voxel_mask"].reshape(-1) > 0)
    canvas = canvas.reshape(B, L, *canvas.shape[1:])
    agent_mask = torch.zeros(B, L, device=device)
    agent_mask[:, :ATT_BEV_LIVE] = 1.0
    padded = canvas.clone()
    padded[:, L - 1] = 123.0
    rows, failures = {}, []
    for compression in (0, 1):
        master = AttBEVBackbone(
            cfg.pillar_filters[-1], cfg.layer_nums, cfg.layer_strides,
            cfg.num_filters, cfg.upsample_strides, cfg.num_upsample_filter,
            compression=compression)
        seeded_init_(master, seed)
        master = master.to(device).eval()
        model = copy.deepcopy(master).to(torch.bfloat16)
        x16, pad16 = canvas.to(torch.bfloat16), padded.to(torch.bfloat16)
        with torch.no_grad():
            ref = master(canvas, agent_mask)
            model(x16, agent_mask)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            got, prof = traced_frame(lambda: model(x16, agent_mask))
            peak = torch.cuda.max_memory_allocated() / 1e9
            again = model(pad16, agent_mask)
        gate = validate_kernels.compare_outputs(
            f"att_bev_compression{compression}_bf16_vs_f32", {"bev": got},
            {"bev": ref}, validate_kernels.BUDGET_FORWARD)
        padded_diff = float((again.float() - got.float()).abs().max())
        row = {"shape": list(got.shape), "device_ms":
               prof["device_ms_per_step"],
               "device_idle_share": prof["device_idle_share"],
               "peak_gb": peak, "gate": gate,
               "padded_agent_max_abs_change": padded_diff}
        rows[f"compression_{compression}"] = row
        if not gate["ok"]:
            failures.append(f"AttBEVBackbone: {gate}")
        if padded_diff != 0.0:
            failures.append(f"AttBEVBackbone: a padded agent moved the "
                            f"output by {padded_diff}")
        log(f"AttBEVBackbone (compression {compression}, {L} agents, "
            f"{ATT_BEV_LIVE} live, pillar BEV {tuple(canvas.shape[2:])}): "
            f"out {tuple(got.shape)}, device {row['device_ms']:.3f} ms "
            f"(traced alone, idle {row['device_idle_share']:.3f}), peak "
            f"{peak:.2f} GB; bf16 vs f32 plain {json.dumps(gate['outputs'])};"
            f" a padded agent set to 123 changes the output by "
            f"{padded_diff}; {card}")
        del master, model, ref, got, again
        torch.cuda.empty_cache()
    return {"rows": rows, "failures": failures}


def resnet_variant_frames(seed):
    """ResNetEncoderConcat (FPN off and on) and ResNetEncoderSingle at
    corpbevt.yaml width, ResNet-34, on the bf16 compute twin with K3 x 20 a
    frame, each against its f32 plain forward with the zoo gate, and with
    a planted K3 fault that the gate must fail."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.nn.layers import images_from_uint8
    from cobevt_tpu_torch.nn.resnet_variants import (
        ResNetEncoderConcat,
        ResNetEncoderSingle,
    )
    from cobevt_tpu_torch.train.state import compute_twin
    from cobevt_tpu_torch.utils.weights import seeded_init_

    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = images_from_uint8(torch.randint(
        0, 256, (1, 5, 4, 512, 512, 3), generator=gen, device="cuda",
        dtype=torch.uint8))
    variants = (
        ("concat", lambda: ResNetEncoderConcat(34, 0, 128),
         "k3_skipped_residual"),
        ("concat_fpn256", lambda: ResNetEncoderConcat(34, 256, 128),
         "k3_skipped_residual"),
        ("single_id_pick1", lambda: ResNetEncoderSingle(34, 1),
         "k3_skipped_residual_layer2"))
    rows, counts_total, failures = {}, {}, []
    for name, build, fault in variants:
        master = build()
        seeded_init_(master, seed)
        model = compute_twin(master.to("cuda").eval(), torch.bfloat16).eval()
        x16 = images.to(torch.bfloat16)
        with switches(None), torch.no_grad():
            with ops.forced_impl("torch"):
                ref = master(images)
                plain = model(x16)
            model(x16)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            got = model(x16)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            _, prof = traced_frame(lambda: model(x16))
            with planted_zoo_fault(fault):
                faulted = model(x16)
        for fn, c in counts.items():
            if c != RESNET_ZOO_PER_FRAME.get(fn, 0):
                raise AssertionError(f"ResNet {name}: {fn} ran {c} launches")
            counts_total[fn] = counts_total.get(fn, 0) + c
        gate = drift_gate(got, ref, plain, ZOO_BUDGET, ZOO_WITNESS_RATIO)
        faulted_gate = drift_gate(faulted, ref, plain, ZOO_BUDGET,
                                  ZOO_WITNESS_RATIO)
        row = {"shape": list(got.shape), "counts": counts,
               "device_ms": prof["device_ms_per_step"],
               "device_idle_share": prof["device_idle_share"],
               "peak_gb": peak, "gate": gate, fault: faulted_gate}
        rows[name] = row
        if not gate["passes"]:
            failures.append(f"ResNet {name}: {gate}")
        if faulted_gate["passes"]:
            failures.append(f"ResNet {name}: the gate passed the planted "
                            f"fault {fault}: {faulted_gate}")
        log(f"ResNet-34 {name} (5 agents x 4 cameras x 512^2): out "
            f"{tuple(got.shape)}, launches K3 {counts['fused_conv3x3']}, "
            f"device {row['device_ms']:.3f} ms (traced alone, idle "
            f"{row['device_idle_share']:.3f}), peak {peak:.2f} GB; gate "
            f"(budget {ZOO_BUDGET}, {ZOO_WITNESS_RATIO}x bf16 plain) "
            f"{json.dumps(gate)}; {fault} {json.dumps(faulted_gate)}; "
            f"{card}")
        del master, model, ref, plain, got, faulted
        torch.cuda.empty_cache()
    return {"rows": rows, "counts": counts_total, "failures": failures}


def hgt_frames(seed):
    """HGTCavAttention at V2X-ViT's widths on the LiDAR fusion map, 3 live
    agents of mixed types: bf16 against its f32 plain forward, device ms
    and peak memory.  It runs no kernel of this repo."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.models.fusion.hetero import HGTCavAttention
    from cobevt_tpu_torch.tools import validate_kernels
    from cobevt_tpu_torch.utils.weights import seeded_init_

    card = card_line()
    B, L, H, W, C = HGT_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(HGT_SHAPE, generator=gen, device="cuda")
    mask = torch.zeros(B, H, W, L, 1, device="cuda")
    mask[..., :HGT_LIVE, :] = 1.0
    prior = torch.zeros(B, L, H, W, 3, device="cuda")
    prior[..., 2] = torch.tensor(HGT_TYPES, device="cuda",
                                 dtype=torch.float32)[None, :, None, None]
    master = HGTCavAttention(C, HGT_HEADS, num_types=2, num_relations=4,
                             dim_head=C // HGT_HEADS, dropout=0.1)
    seeded_init_(master, seed)
    # seeded_init_ draws raw tensors N(0, 1), 18x the relation matrices'
    # xavier bound, which leaves every softmax near one-hot (bf16 drift
    # 0.037 of the largest output on an NVIDIA H100 80GB HBM3, 700 W);
    # redraw them at their init scale
    master.reset_relations(torch.Generator().manual_seed(seed))
    master = master.to("cuda").eval()
    model = copy.deepcopy(master).to(torch.bfloat16)
    x16, prior16 = x.to(torch.bfloat16), prior.to(torch.bfloat16)
    with torch.no_grad():
        ref = master(x, mask, prior)
        model(x16, mask, prior16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        got, prof = traced_frame(lambda: model(x16, mask, prior16))
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
    gate = validate_kernels.compare_outputs(
        "hgt_bf16_vs_f32", {"x": got}, {"x": ref},
        validate_kernels.BUDGET_FORWARD)
    row = {"shape": list(got.shape), "device_ms": prof["device_ms_per_step"],
           "device_idle_share": prof["device_idle_share"],
           "top_device_ops": prof["top_device_ops"][:6],
           "peak_gb": peak, "gate": gate, "launches": sum(counts.values())}
    log(f"HGTCavAttention (dim {C}, {HGT_HEADS} heads of {C // HGT_HEADS}, "
        f"types {HGT_TYPES}, {HGT_LIVE} of {L} live, map {HGT_SHAPE}): "
        f"device {row['device_ms']:.3f} ms (traced alone, idle "
        f"{row['device_idle_share']:.3f}), peak {peak:.2f} GB, kernel "
        f"launches {row['launches']} (none is this repo's); bf16 vs f32 "
        f"plain {json.dumps(gate['outputs'])}; {card}")
    failures = [] if gate["ok"] and not row["launches"] else [
        f"HGTCavAttention: {gate}, launches {counts}"]
    return {"row": row, "failures": failures}


def phase_lidar_zoo(seed=0):
    """Phase 19: the LiDAR half of the baseline zoo (see the module
    docstring).  Gate failures raise once the phase has printed every
    reading."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    log("== phase 19: the LiDAR zoo: SECOND + swap fusion from point clouds "
        "(grid 1408 x 800 x 40, map 100 x 176 x 512), AttBEVBackbone, the "
        "ResNet encoder variants, HGTCavAttention")
    out = {}
    with tempfile.TemporaryDirectory(prefix="cobevt_lidar_zoo_") as tmp:
        out["second"] = second_from_clouds(tmp, seed)
        out["second_s"] = time.perf_counter() - t_phase
        out["att_bev"] = att_bev_frames(tmp, seed)
    out["resnet_variants"] = resnet_variant_frames(seed)
    out["hgt"] = hgt_frames(seed)
    out["counts"] = dict(out["second"]["counts"])
    for fn, n in out["resnet_variants"]["counts"].items():
        out["counts"][fn] = out["counts"].get(fn, 0) + n
    out["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 19: {out['seconds']:.1f} s (SECOND "
        f"{out['second_s']:.1f} s)")
    failures = [f for part in ("second", "att_bev", "resnet_variants", "hgt")
                for f in out[part]["failures"]]
    if failures:
        raise AssertionError("phase 19: " + "; ".join(failures))
    return out


def op_calls(fn):
    """(fn(), {op name: calls}) of the cobevt:: ops one call of ``fn``
    makes: one per wrapper call that takes its op."""
    from cobevt_tpu_torch.ops import dispatch
    calls = {}
    real = dispatch.KernelOp.__call__

    def counted(self, *args):
        calls[self.name] = calls.get(self.name, 0) + 1
        return real(self, *args)

    dispatch.KernelOp.__call__ = counted
    try:
        return fn(), calls
    finally:
        dispatch.KernelOp.__call__ = real


def export_frame(name, model, batch, wrong_batch, exact=False):
    """Phase 20(a) on one model: validate_kernels.validate_export (export,
    save, load, run on the card, the 0.01 gate, both launch counts, both
    frames' ms), then one cobevt:: node per op call of the live frame and a
    batch of other shapes refused.  ``exact``: the frames must be equal."""
    import torch
    from cobevt_tpu_torch.tools import export_serving, validate_kernels

    device = torch.device("cuda", torch.cuda.current_device())
    with torch.no_grad():
        _, calls = op_calls(lambda: model(batch))
    report, loaded = validate_kernels.validate_export(
        device, model=model, batch=batch, return_program=True)
    report["live_op_calls"] = calls
    log(f"export {name}: " + json.dumps(
        {k: v for k, v in report.items() if k != "outputs"}))
    failures = []
    if not report["ok"]:
        failures.append(f"{name}: the gate failed (max rel "
                        f"{report['max_rel']:.3e}, launches exported "
                        f"{report['launches']['exported']}, live "
                        f"{report['launches']['live']})")
    if exact and not report["bit_equal"]:
        failures.append(f"{name}: the exported frame differs from the live "
                        f"one (max abs {report['max_abs_err']:.3e})")
    if report["nodes"] != calls:
        failures.append(f"{name}: graph nodes {report['nodes']} against the "
                        f"live frame's op calls {calls}")
    try:
        export_serving.run_exported(loaded, wrong_batch)
        failures.append(f"{name}: a batch of other shapes was not refused")
    except Exception as e:
        report["refused"] = f"{type(e).__name__}: {str(e)[:120]}"
    report["failures"] = failures
    del loaded
    torch.cuda.empty_cache()
    return report


def dispatcher_cost(model, cfg, seed):
    """The cobevt:: dispatcher's host cost on a served frame (the staged
    runner at 5 live agents, bf16, the serving default, waited for).  Each
    op call goes through its op ("ops") or straight to its CUDA
    implementation, ``KernelOp.launch`` ("direct": the same launches and
    counts, no dispatcher), the sides in turns.  Traced: DISPATCH_TRACED
    frames a side under torch.profiler (CPU), each op call inside a
    ``call::<op>`` record on either side, so the dispatcher's cost per call
    is the difference of the records' median CPU time, and a frame's is
    the sum over the ops of that times the op's calls a frame.  Untraced:
    the frame's host ms, median of DISPATCH_FRAMES a side."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from cobevt_tpu_torch.ops import dispatch
    from cobevt_tpu_torch.tools import serve_camera
    from cobevt_tpu_torch.utils.serving import StagedBucketedRunner

    runner = StagedBucketedRunner(model, cfg.max_cav)
    frame = serve_camera.synthetic_frame(np.random.RandomState(seed), cfg,
                                         cfg.max_cav)
    real = dispatch.KernelOp.__call__
    sides = {"ops": real, "direct": lambda self, *args: self.launch(*args)}

    def recorded(call):
        def wrapped(self, *args):
            with record_function(f"call::{self.name}"):
                return call(self, *args)
        return wrapped

    def served(call):
        dispatch.KernelOp.__call__ = call
        try:
            t0 = time.perf_counter()
            out = runner(frame)
            torch.cuda.synchronize()
            del out
            return (time.perf_counter() - t0) * 1e3
        finally:
            dispatch.KernelOp.__call__ = real

    for _ in range(2):
        for call in sides.values():
            served(call)
    times = {side: [] for side in sides}
    for _ in range(DISPATCH_FRAMES):
        for side, call in sides.items():
            times[side].append(served(call))
    out = {f"{k}_host_ms": float(np.median(v)) for k, v in times.items()}
    out.update({f"{k}_host_ms_all": v for k, v in times.items()})
    out["untraced_diff_ms"] = out["ops_host_ms"] - out["direct_host_ms"]

    calls = {side: {} for side in sides}         # op -> [cpu us a call]
    for _ in range(DISPATCH_TRACED):
        for side, call in sides.items():
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                served(recorded(call))
            for e in prof.events():
                if e.name.startswith("call::"):
                    calls[side].setdefault(e.name[6:], []).append(
                        e.cpu_time_total)
    per_op = {}
    for op, us in sorted(calls["ops"].items()):
        d_us = calls["direct"][op]
        ops_us, direct_us = float(np.median(us)), float(np.median(d_us))
        per_op[op] = {"calls_per_frame": len(us) / DISPATCH_TRACED,
                      "ops_us": ops_us, "direct_us": direct_us,
                      "ops_us_quartiles": np.percentile(us, [25, 75]).tolist(),
                      "direct_us_quartiles": np.percentile(
                          d_us, [25, 75]).tolist(),
                      "dispatcher_us": ops_us - direct_us}
    out["traced"] = per_op
    out["dispatcher_ms"] = sum(r["calls_per_frame"] * r["dispatcher_us"]
                               for r in per_op.values()) / 1e3
    log(f"dispatcher A/B (served frame; untraced host ms, median of "
        f"{DISPATCH_FRAMES}; traced per-call us, medians over "
        f"{DISPATCH_TRACED} frames): "
        + json.dumps({k: v for k, v in out.items()
                      if not k.endswith("_all")}))
    return out


def dp_config():
    """The full-width CorpBEVT of phase 20(b): every dropout at 0."""
    import dataclasses
    from cobevt_tpu_torch.configs.presets import corpbevt_default

    cfg = corpbevt_default(max_cav=DP_AGENTS)
    return dataclasses.replace(
        cfg, fusion_dropout=0.0,
        fax=dataclasses.replace(cfg.fax, self_attn_dropout=0.0))


def dp_model(device, seed=0):
    """(model with seeded weights, the benchmark's one-sample batch) at
    dp_config."""
    from cobevt_tpu_torch.tools import benchmark

    model, batch, _ = benchmark.build_corpbevt(DP_AGENTS, seed, device,
                                               dp_config())
    return model, batch


def dp_state(model, criterion, precision):
    """(state, step, grads): the benchmark's camera recipe computing on a
    twin of the f32 masters in ``precision`` ("bf16", or "f32": a copy in
    f32, so the step takes the twin's branch, its gradients copied into the
    masters' before the reduction, as in bf16), and the f32 gradients its
    first update reads, filled by an optimizer hook (after the reduction
    over the ranks)."""
    import copy

    import torch
    from cobevt_tpu_torch.tools import benchmark
    from cobevt_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from cobevt_tpu_torch.train import state as train_state

    schedule, weight_decay, eps, clip = benchmark.train_recipe("corpbevt")
    optimizer = make_optimizer(model.parameters(), schedule,
                               weight_decay=weight_decay, eps=eps)
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {}
    optimizer.register_step_pre_hook(lambda opt, args, kwargs: grads.update(
        {names[id(p)]: p.grad.detach().float().cpu()
         for group in opt.param_groups for p in group["params"]}))
    state = create_train_state(
        model, optimizer, schedule, compute_dtype=torch.bfloat16
        if precision == "bf16" else None, grad_clip=clip)
    if precision == "f32":
        state.compute_model = copy.deepcopy(model)
        train_state._share_norm_statistics(model, state.compute_model)
    if state.compute_model is model:
        raise AssertionError("phase 20: no compute twin")
    return state, make_train_step(model, criterion), grads


@contextlib.contextmanager
def tf32_off():
    """f32 products without TF32 inside the block (cuDNN and cuBLAS)."""
    import torch
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def dp_step(batch, precision, generator_seed=0):
    """One counted, timed step of a fresh phase-20 model (seed 0) on
    ``batch`` in ``precision`` (dp_state's twin in "bf16", or in "f32" with
    TF32 off): a dict of the loss, its parts, the f32 gradients the update read
    (CPU), the state after it (CPU), the launch counts, the step's seconds
    and the peak memory."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.tools import benchmark

    device = torch.device("cuda", torch.cuda.current_device())
    model, _ = dp_model(device)
    criterion, _ = benchmark.make_criterion("corpbevt", model, {
        k: v for k, v in batch.items() if not k.startswith("gt_")})
    state, step, grads = dp_state(model, criterion, precision)
    gen = torch.Generator(device="cuda").manual_seed(generator_seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with (tf32_off() if precision == "f32" else contextlib.nullcontext()):
        logs = step(state, batch, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    return {"loss": float(logs["loss"]),
            "parts": {k: float(v) for k, v in logs.items()
                      if k not in ("loss", "grad_norm")},
            "grads": grads,
            "state": {k: v.detach().cpu().clone()
                      for k, v in state.model.state_dict().items()},
            "counts": counts, "step_s": seconds,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def dp_grads(run):
    """(loss, parts, gradients in f64) of a dp_step, as compare_step reads
    them."""
    return run["loss"], run["parts"], {k: g.double()
                                       for k, g in run["grads"].items()}


def dp_rank_main(opt):
    """A rank of phase 20(b), started by phase_export_dist: join the group,
    take one step on its sample of the global batch, save the result."""
    import torch
    from cobevt_tpu_torch.parallel import (
        barrier,
        maybe_initialize_distributed,
        rank,
        world_size,
    )

    env = json.loads(opt.dp_env)
    if not maybe_initialize_distributed(env=env, backend=opt.dp_backend):
        raise AssertionError("no process group")
    device = torch.device("cuda", torch.cuda.current_device())
    data = torch.load(opt.dp_data, map_location=device, weights_only=True)
    r, world = rank(), world_size()
    per = data["inputs"].shape[0] // world
    local = {k: v[r * per:(r + 1) * per] for k, v in data.items()}
    out = {precision: dp_step(local, precision)
           for precision in DP_PRECISIONS}
    if opt.dp_backend == "nccl":
        # one collective on the NCCL group beside the steps
        t = torch.tensor([out["bf16"]["loss"]], device=device)
        torch.distributed.all_reduce(t)
        out["nccl_all_reduce"] = float(t)
    barrier()
    out.update(rank=r, world=world,
               backend=torch.distributed.get_backend())
    torch.save(out, opt.dp_rank)
    torch.distributed.destroy_process_group()
    return 0


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(tmp, data_path, ranks, flag="--dp_rank"):
    """Start one process of this script for each (env, backend) of
    ``ranks``, all together (phase 20(b), or with ``flag`` "--mesh_rank"
    phase 21), wait for all, raise on a failure; returns their saved
    results in order."""
    import torch
    procs = []
    for i, (env, backend) in enumerate(ranks):
        out = os.path.join(tmp, f"{backend}_rank{i}.pt")
        cmd = [sys.executable, os.path.abspath(__file__), flag, out,
               "--dp_data", data_path, "--dp_env", json.dumps(env),
               "--dp_backend", backend]
        procs.append((out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], False
    for i, (_, p) in enumerate(procs):
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            raise
        failed = failed or p.returncode != 0
        logs.append(f"--- process {i}, {ranks[i][1]} (rc {p.returncode}) "
                    f"---\n" + stdout[-3000:])
    if failed:
        raise AssertionError(f"{flag}: a rank failed\n" + "\n".join(logs))
    return [torch.load(out, weights_only=False) for out, _ in procs]


def phase_export_dist(seed=0):
    """Phase 20: the serving export and the data-parallel step (see the
    module docstring)."""
    import math
    import tempfile
    import types

    import torch
    from torch.library import opcheck
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.configs.presets import corpbevt_default
    from cobevt_tpu_torch.ops.dispatch import env_switches
    from cobevt_tpu_torch.ops.op_samples import sample_args
    from cobevt_tpu_torch.tools import benchmark, validate_kernels

    t_phase = time.perf_counter()
    log("== phase 20: serving export (CorpBEVT bf16, COBEVT_INT8=1, "
        "SinBEVT-nuScenes) and the data-parallel step (2 ranks, gloo)")
    device = torch.device("cuda", torch.cuda.current_device())
    out, failures, counts = {}, [], {}

    def add(c):
        for fn, n in c.items():
            counts[fn] = counts.get(fn, 0) + n

    # (a) the exported frames
    model, batch, _ = benchmark.build_corpbevt(5, seed, device)
    model = model.to(torch.bfloat16).eval()
    fewer = {k: v[:, :4] for k, v in batch.items()}
    with switches(None):
        out["corpbevt"] = export_frame("corpbevt bf16", model, batch, fewer)
        with env_switches(COBEVT_INT8="1"):
            out["corpbevt_int8"] = export_frame(
                "corpbevt bf16 COBEVT_INT8=1", model, batch, fewer,
                exact=True)
        out["dispatcher"] = dispatcher_cost(model, corpbevt_default(), seed)
    del model, batch, fewer
    torch.cuda.empty_cache()
    model, batch, _ = benchmark.build_sinbevt(device=device)
    model = model.to(torch.bfloat16).eval()
    batch = {k: batch[k] for k in ("image", "intrinsics", "extrinsics")}
    with switches(None):
        out["sinbevt"] = export_frame(
            "sinbevt_nuscenes bf16", model, batch,
            {k: v[:, :5] for k, v in batch.items()})
    del model, batch
    torch.cuda.empty_cache()
    for key in ("corpbevt", "corpbevt_int8", "sinbevt"):
        failures += out[key]["failures"]
        add(out[key]["launches"]["exported"])

    # opcheck of every op on the card
    out["opcheck"] = {}
    for name, args in sample_args(device).items():
        t0 = time.perf_counter()
        opcheck(ops.KERNEL_OPS[name].custom_op, args)
        out["opcheck"][name] = time.perf_counter() - t0
    log("opcheck on the card, s: " + json.dumps(out["opcheck"]))
    out["export_s"] = time.perf_counter() - t_phase

    # (b) the data-parallel step
    t_dp = time.perf_counter()
    one = benchmark.camera_batch(dp_config(), DP_AGENTS, device)
    two = {k: torch.cat([v, v]) for k, v in one.items()}
    two["inputs"][1:] = torch.rand(
        one["inputs"].shape, generator=torch.Generator(device="cuda")
        .manual_seed(seed + 1), device="cuda")
    # the labels: the benchmark's draw for a batch of 2
    _, train_batch = benchmark.make_criterion(
        "corpbevt", types.SimpleNamespace(config=dp_config()), two)
    del one, two
    # one process on the global batch, in each precision, and in bf16 once
    # more on the batch's samples in the other order: the same function,
    # summed in another order (the rounding's own spread)
    refs = {precision: dp_step(train_batch, precision)
            for precision in DP_PRECISIONS}
    reordered = dp_step({k: v.flip(0) for k, v in train_batch.items()},
                        "bf16")
    torch.cuda.empty_cache()
    for precision, ref in refs.items():
        log(f"data parallel: one process on the global batch of 2, "
            f"{precision}: loss {ref['loss']:.6f}, step "
            f"{ref['step_s']:.2f} s, peak {ref['peak_gb']:.1f} GB, launches "
            f"{ {k: n for k, n in ref['counts'].items() if n} }")
    with tempfile.TemporaryDirectory(prefix="cobevt_dp_") as tmp:
        data_path = os.path.join(tmp, "global_batch.pt")
        torch.save({k: v.cpu() for k, v in train_batch.items()}, data_path)
        del train_batch
        # the gloo ranks and the NCCL world of one, all at once
        port = _free_port()
        t0 = time.perf_counter()
        *ranks, nccl = run_ranks(tmp, data_path, [
            ({"COBEVT_COORDINATOR": f"127.0.0.1:{port}",
              "JAX_NUM_PROCESSES": str(DP_WORLD),
              "JAX_PROCESS_ID": str(r)}, "gloo")
            for r in range(DP_WORLD)] + [
            ({"COBEVT_MULTIHOST": "1", "MASTER_ADDR": "127.0.0.1",
              "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "1",
              "RANK": "0"}, "nccl")])
        wall_s = time.perf_counter() - t0
    budgets = validate_kernels.TRAIN_BUDGETS["corpbevt"]
    out["dp"] = {"world": DP_WORLD, "backend": ranks[0]["backend"],
                 "agents": DP_AGENTS, "ranks_wall_s": wall_s,
                 "budgets": budgets}
    for precision in DP_PRECISIONS:
        got, ref = ranks[0][precision], refs[precision]
        gate = validate_kernels.compare_step(
            dp_grads(got), dp_grads(ref), *budgets, metric="l2")
        loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        equal = {key: all(
            torch.equal(got["state"][k], r[precision]["state"][k])
            for r in ranks[1:] for k in got["state"]
            if ("running" in k) == (key == "bn_statistics"))
            for key in ("bn_statistics", "parameters")}
        row = {"loss": got["loss"], "ref_loss": ref["loss"],
               "loss_rel": loss_rel,
               "gate": {k: v for k, v in gate.items() if k != "scalars"},
               "ranks_equal": equal,
               "rank_step_s": [r[precision]["step_s"] for r in ranks],
               "rank_peak_gb": [r[precision]["peak_gb"] for r in ranks],
               "ref_step_s": ref["step_s"], "ref_peak_gb": ref["peak_gb"],
               "rank_counts": [r[precision]["counts"] for r in ranks]}
        if precision == "bf16":
            noise = validate_kernels.compare_step(
                dp_grads(reordered), dp_grads(ref), *budgets, metric="l2")
            row["reordered_batch"] = {
                k: v for k, v in noise.items() if k != "scalars"}
        out["dp"][precision] = row
        log(f"data parallel, {precision}: " + json.dumps(row))
        for r in ranks:
            add(r[precision]["counts"])
            for fn, n in DP_PER_STEP.items():
                if r[precision]["counts"][fn] != n:
                    failures.append(
                        f"dp {precision} rank {r['rank']}: {fn} ran "
                        f"{r[precision]['counts'][fn]} launches, expected "
                        f"{n}")
        if not loss_rel <= DP_LOSS_TOL:
            failures.append(f"dp {precision}: loss {got['loss']} against "
                            f"one process's {ref['loss']} ({loss_rel:.3e} "
                            f"relative)")
        if not all(equal.values()):
            failures.append(f"dp {precision}: the ranks differ after the "
                            f"step: {equal}")
    f32_gate = out["dp"]["f32"]["gate"]
    if not f32_gate["ok"]:
        failures.append(
            "dp f32: gradients outside the camera gate's budgets: "
            + json.dumps(f32_gate["param_failures"]
                         + f32_gate["noise_tier_failures"])
            + f" max scalar {f32_gate['max_scalar']:.3e}")
    nccl_counts = {}
    for precision in DP_PRECISIONS:
        for fn, n in nccl[precision]["counts"].items():
            nccl_counts[fn] = nccl_counts.get(fn, 0) + n
    add(nccl_counts)
    out["dp"]["nccl_world1"] = {
        "backend": nccl["backend"], "loss": nccl["bf16"]["loss"],
        "all_reduce": nccl["nccl_all_reduce"], "counts": nccl_counts}
    log("data parallel, NCCL world of one: "
        + json.dumps(out["dp"]["nccl_world1"]))
    if nccl["backend"] != "nccl" or not math.isfinite(nccl["bf16"]["loss"]):
        failures.append(f"dp: the NCCL world of one: {nccl['backend']}, "
                        f"loss {nccl['bf16']['loss']}")
    out["dp_s"] = time.perf_counter() - t_dp
    out["counts"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 20: {out['seconds']:.1f} s (export {out['export_s']:.1f} s, "
        f"data parallel {out['dp_s']:.1f} s)")
    if failures:
        raise AssertionError("phase 20: " + "; ".join(failures))
    return out


def mesh_batch(max_cav, B, device, seed=0):
    """The benchmark's camera batch at ``max_cav`` agents, B samples (those
    after the first with other images, drawn on the card from ``seed`` + i)
    and the benchmark's labels."""
    import types

    import torch
    from cobevt_tpu_torch.configs.presets import corpbevt_default
    from cobevt_tpu_torch.tools import benchmark

    cfg = corpbevt_default(max_cav)
    one = benchmark.camera_batch(cfg, max_cav, device)
    batch = {k: torch.cat([v] * B) for k, v in one.items()}
    for i in range(1, B):
        batch["inputs"][i:i + 1] = torch.rand(
            one["inputs"].shape, device=device,
            generator=torch.Generator(device="cuda").manual_seed(seed + i))
    return benchmark.make_criterion(
        "corpbevt", types.SimpleNamespace(config=cfg), batch)[1]


def mesh_models(device):
    """{max_cav: full-width CorpBEVT (the preset, every dropout at 0.1),
    seeded weights (seed 0)} for every max_cav of phase 21, built once a
    process; each use takes a copy."""
    from cobevt_tpu_torch.tools import benchmark
    return {max_cav: benchmark.build_corpbevt(max_cav, 0, device)[0]
            for max_cav in sorted({c[2] for c in MESH_CASES.values()})}


def grads_hook(optimizer, model):
    """The f32 gradients the next update of ``optimizer`` reads, by
    ``model``'s parameter names (an optimizer hook), on the card."""
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {}
    optimizer.register_step_pre_hook(lambda opt, args, kwargs: grads.update(
        {names[id(p)]: p.grad.detach().float().clone()
         for group in opt.param_groups for p in group["params"]}))
    return grads


@contextlib.contextmanager
def counted_collectives(mesh, record):
    """Every ``all_reduce`` inside the block appended to ``record`` as
    (axis, bytes): "data" or "model" for a mesh axis's group, "world" for
    the default group (data x model)."""
    import torch.distributed as dist
    real = dist.all_reduce
    axes = {} if mesh is None else {
        id(mesh.get_group(a)): a for a in ("data", "model")}

    def counted(tensor, *args, **kwargs):
        group = kwargs.get("group", args[1] if len(args) > 1 else None)
        record.append((axes.get(id(group), "world") if group is not None
                       else "world", tensor.numel() * tensor.element_size()))
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counted
    try:
        yield
    finally:
        dist.all_reduce = real


@contextlib.contextmanager
def recorded_draws(record):
    """Every ``nn/layers.py:rank_uniform`` call inside the block appended to
    ``record`` as (shape, device, part, the draw layout in force)."""
    from cobevt_tpu_torch.nn import layers
    from cobevt_tpu_torch.parallel.distributed import current_draw_layout
    real = layers.rank_uniform

    def recorded(shape, device, generator=None, **part):
        record.append((tuple(shape), device, part, current_draw_layout()))
        return real(shape, device, generator, **part)

    layers.rank_uniform = recorded
    try:
        yield
    finally:
        layers.rank_uniform = real


def draws_ms(draws, reps=5):
    """(ms of a step's draws as they ran, ms of the same shapes drawn
    locally): CUDA events around ``reps`` replays after one untimed, on the
    card."""
    import torch
    from cobevt_tpu_torch.nn import layers
    from cobevt_tpu_torch.parallel.distributed import draw_layout

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for keep_layout in (True, False):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        for rep in range(reps + 1):
            if rep == 1:
                start.record()
            for shape, device, part, layout in draws:
                with draw_layout(layout if keep_layout else None):
                    layers.rank_uniform(shape, device, gen, **part)
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return out


def mesh_step(case, batch, precision, models, mesh=None):
    """One counted, timed step of a fresh full-width CorpBEVT (seed 0, every
    dropout on) of phase-21 ``case`` in ``precision`` (dp_state's twin in
    "bf16", or in "f32" with TF32 off), unplaced (``mesh`` None: the one
    process, ``batch`` the global batch) or placed on ``mesh`` (``batch``
    cut to this rank's part): the loss, its parts, the whole f32 gradients
    the update read and the whole state after it (CPU), the launch counts,
    the collectives by axis, the step's seconds, the peak memory and the
    mask draws' ms (as drawn, and drawn locally).  ``models``:
    mesh_models'."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.parallel import mesh as tp
    from cobevt_tpu_torch.tools import benchmark
    from cobevt_tpu_torch.train import (
        full_state_dict,
        make_train_step,
        place_state,
    )

    device = torch.device("cuda", torch.cuda.current_device())
    max_cav, placement = MESH_CASES[case][2], MESH_CASES[case][4]
    model = copy.deepcopy(models[max_cav])
    criterion, _ = benchmark.make_criterion("corpbevt", model, {
        k: v for k, v in batch.items() if not k.startswith("gt_")})
    state, step, grads = dp_state(model, criterion, precision)
    if mesh is not None:
        state = place_state(state, mesh)
        grads = grads_hook(state.optimizer, state.model)
        step = make_train_step(state.model, criterion, mesh)
        place = (tp.cooperative_batch_sharding if placement == "agents"
                 else tp.shard_batch)
        batch = place(mesh, batch)
    gen = torch.Generator(device="cuda").manual_seed(MESH_DROPOUT_SEED)
    collectives, draws = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with (tf32_off() if precision == "f32" else contextlib.nullcontext()), \
            counted_collectives(mesh, collectives), recorded_draws(draws):
        logs = step(state, batch, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    whole = dict(grads)
    if mesh is not None:
        owners = dict(state.model.named_modules())
        for name, g in grads.items():
            owner = owners[name.rpartition(".")[0]]
            if isinstance(owner, tp.ShardedLinear) and \
                    name.endswith(".weight"):
                whole[name] = tp.gather_plain(g, owner.dim, owner.axis)
    by_axis = {}
    for axis, nbytes_ in collectives:
        n, b = by_axis.get(axis, (0, 0))
        by_axis[axis] = (n + 1, b + nbytes_)
    return {"loss": float(logs["loss"]),
            "parts": {k: float(v) for k, v in logs.items()
                      if k not in ("loss", "grad_norm")},
            "grads": {k: g.cpu() for k, g in whole.items()},
            "state": {k: v.detach().cpu().clone()
                      for k, v in full_state_dict(state).items()},
            "counts": {k: counts[k] for k in MESH_KERNELS},
            "collectives": {a: {"calls": n, "bytes": b}
                            for a, (n, b) in by_axis.items()},
            "step_s": seconds, "peak_gb": peak,
            "draws": len(draws), "draws_ms": draws_ms(draws)}


def mesh_serve(frames, precision, models, mesh=None):
    """Phase 21(d): ``frames`` (a host batch) through StagedBucketedRunner
    over ``mesh`` (each rank serves its "data" rows, every rank returns the
    whole batch), or, without one, the padded forward (FullRunner) of one
    process; full-width CorpBEVT in ``precision`` ("bf16", or "f32" with
    TF32 off) on the serving default.  (dynamic_seg on the CPU in f32,
    launch counts of the timed call, its ms)."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.utils.serving import (
        FullRunner,
        StagedBucketedRunner,
    )

    device = torch.device("cuda", torch.cuda.current_device())
    model = copy.deepcopy(models[5])
    if precision == "bf16":
        model = model.to(torch.bfloat16)
    model.eval()
    runner = (FullRunner(model) if mesh is None
              else StagedBucketedRunner(model, 5, mesh))
    with switches(None), (tf32_off() if precision == "f32"
                          else contextlib.nullcontext()):
        runner(frames)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = runner(frames)["dynamic_seg"]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    return {"seg": out.float().cpu(), "ms": ms,
            "counts": {k: counts[k] for k in MESH_KERNELS}}


def mesh_rank_main(opt):
    """A rank of phase 21, started by phase_mesh: join the group, run every
    case on its mesh (the data's global batches cut to this rank's part),
    then the served frames, and save the results."""
    import torch
    from cobevt_tpu_torch.parallel import (
        barrier,
        maybe_initialize_distributed,
        rank,
        world_size,
    )
    from cobevt_tpu_torch.parallel.mesh import make_mesh

    if not maybe_initialize_distributed(env=json.loads(opt.dp_env),
                                        backend=opt.dp_backend):
        raise AssertionError("no process group")
    device = torch.device("cuda", torch.cuda.current_device())
    data = torch.load(opt.dp_data, map_location=device, weights_only=True)
    models = mesh_models(device)
    out = {"rank": rank(), "world": world_size(),
           "backend": torch.distributed.get_backend()}
    for case, (n_data, n_model, *_) in MESH_CASES.items():
        mesh = make_mesh(n_data, n_model)
        out["mesh_" + case] = list(mesh.mesh.shape)
        for precision in MESH_PRECISIONS:
            out[f"{case}/{precision}"] = mesh_step(case, data[case],
                                                   precision, models, mesh)
            if rank() > 0:
                # only rank 0's gradients are held to the one process
                del out[f"{case}/{precision}"]["grads"]
            torch.cuda.empty_cache()
    mesh = make_mesh(2, 1)
    frames = {k: v.cpu().numpy() for k, v in data["serve"].items()}
    out["serve"] = {precision: mesh_serve(frames, precision, models, mesh)
                    for precision in MESH_PRECISIONS}
    barrier()
    torch.save(out, opt.mesh_rank)
    torch.distributed.destroy_process_group()
    return 0


def rel_l2(a, b):
    import torch
    return float(torch.linalg.vector_norm((a - b).double())
                 / (torch.linalg.vector_norm(b.double()) + 1e-30))


def phase_mesh(seed=0):
    """Phase 21: the ("data", "model") mesh (see MESH_CASES): every case
    on two gloo ranks against one process, then the served frames."""
    import tempfile

    import torch
    from cobevt_tpu_torch.tools import validate_kernels

    t_phase = time.perf_counter()
    log("== phase 21: the (data, model) mesh: data parallel 2 x 1, tensor "
        "parallel 1 x 2, the agent axis 1 x 2, served frames 2 x 1 (2 "
        "ranks, gloo, every dropout on)")
    device = torch.device("cuda", torch.cuda.current_device())
    models = mesh_models(device)
    data = {case: mesh_batch(max_cav, B, device, seed)
            for case, (_, _, max_cav, B, _) in MESH_CASES.items()}
    data["serve"] = {k: v for k, v in mesh_batch(
        5, MESH_SERVE_FRAMES, device, seed).items()
        if not k.startswith("gt_")}
    # one process on each global batch, in each precision
    refs = {}
    for case in MESH_CASES:
        for precision in MESH_PRECISIONS:
            refs[f"{case}/{precision}"] = mesh_step(case, data[case],
                                                    precision, models)
            torch.cuda.empty_cache()
    frames = {k: v.cpu().numpy() for k, v in data["serve"].items()}
    serve_ref = {precision: mesh_serve(frames, precision, models)
                 for precision in MESH_PRECISIONS}
    # one process's own spread: the first frame served alone
    alone = mesh_serve({k: v[:1] for k, v in frames.items()}, "bf16",
                       models)
    del models
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cobevt_mesh_") as tmp:
        data_path = os.path.join(tmp, "global_batches.pt")
        torch.save({c: {k: v.cpu() for k, v in b.items()}
                    for c, b in data.items()}, data_path)
        del data
        port = _free_port()
        t0 = time.perf_counter()
        ranks = run_ranks(tmp, data_path, [
            ({"COBEVT_COORDINATOR": f"127.0.0.1:{port}",
              "JAX_NUM_PROCESSES": str(DP_WORLD),
              "JAX_PROCESS_ID": str(r)}, "gloo")
            for r in range(DP_WORLD)], flag="--mesh_rank")
        wall_s = time.perf_counter() - t0
    budgets = validate_kernels.TRAIN_BUDGETS["corpbevt"]
    out = {"world": DP_WORLD, "backend": ranks[0]["backend"],
           "ranks_wall_s": wall_s, "budgets": budgets, "counts": {}}
    failures = []

    def add(c):
        for fn, n in c.items():
            out["counts"][fn] = out["counts"].get(fn, 0) + n

    for case in MESH_CASES:
        for precision in MESH_PRECISIONS:
            key = f"{case}/{precision}"
            got, ref = ranks[0][key], refs[key]
            gate = validate_kernels.compare_step(
                dp_grads(got), dp_grads(ref), *budgets, metric="l2")
            loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
            tensors = {k: rel_l2(got["state"][k].float(),
                                 ref["state"][k].float())
                       for k in ref["state"]
                       if ref["state"][k].is_floating_point()}
            worst = sorted(tensors, key=tensors.get, reverse=True)[:3]
            equal = all(torch.equal(got["state"][k], r[key]["state"][k])
                        for r in ranks[1:] for k in got["state"])
            row = {"mesh": ranks[0]["mesh_" + case], "loss": got["loss"],
                   "ref_loss": ref["loss"], "loss_rel": loss_rel,
                   "gate": {k: v for k, v in gate.items() if k != "scalars"},
                   "state_worst_rel_l2": {k: tensors[k] for k in worst},
                   "ranks_equal": equal,
                   "rank_step_s": [r[key]["step_s"] for r in ranks],
                   "rank_peak_gb": [r[key]["peak_gb"] for r in ranks],
                   "ref_step_s": ref["step_s"], "ref_peak_gb": ref["peak_gb"],
                   "rank_counts": [r[key]["counts"] for r in ranks],
                   "ref_counts": ref["counts"],
                   "collectives": [r[key]["collectives"] for r in ranks],
                   "draws": got["draws"],
                   "draws_ms_global_local": [r[key]["draws_ms"]
                                             for r in ranks]}
            out[key] = row
            log(f"mesh {key}: " + json.dumps(row))
            for r in ranks:
                add(r[key]["counts"])
                if r[key]["counts"] != ref["counts"] or not all(
                        r[key]["counts"][fn] > 0 for fn in MESH_KERNELS[:2]):
                    failures.append(f"{key} rank {r['rank']}: launches "
                                    f"{r[key]['counts']}, one process "
                                    f"{ref['counts']}")
            if not equal:
                failures.append(f"{key}: the ranks differ after the step")
            if precision != "f32":
                continue
            if not loss_rel <= MESH_LOSS_TOL:
                failures.append(f"{key}: loss {got['loss']} against one "
                                f"process's {ref['loss']} ({loss_rel:.3e})")
            if not gate["ok"]:
                failures.append(
                    f"{key}: gradients outside the camera gate's budgets: "
                    + json.dumps(gate["param_failures"]
                                 + gate["noise_tier_failures"])
                    + f" max scalar {gate['max_scalar']:.3e}")
            over = [k for k in worst if tensors[k] > budgets[1]]
            if over:
                failures.append(f"{key}: parameters or statistics past "
                                f"{budgets[1]}: {over}")
    # (d) the served frames
    for precision in MESH_PRECISIONS:
        seg = [r["serve"][precision]["seg"] for r in ranks]
        ref = serve_ref[precision]["seg"]
        err = float((seg[0] - ref).abs().max())
        row = {"frames": MESH_SERVE_FRAMES, "max_abs_err": err,
               "max_logit": float(ref.abs().max()),
               "ranks_equal": all(torch.equal(seg[0], x) for x in seg[1:]),
               "rank_ms": [r["serve"][precision]["ms"] for r in ranks],
               "ref_ms": serve_ref[precision]["ms"],
               "rank_counts": [r["serve"][precision]["counts"]
                               for r in ranks],
               "ref_counts": serve_ref[precision]["counts"]}
        if precision == "bf16":
            row["alone_vs_batch_max_abs_err"] = float(
                (alone["seg"] - ref[:1]).abs().max())
        out["serve/" + precision] = row
        log(f"mesh serve/{precision}: " + json.dumps(row))
        for r in ranks:
            add(r["serve"][precision]["counts"])
            if r["serve"][precision]["counts"] != row["ref_counts"]:
                failures.append(f"serve/{precision} rank {r['rank']}: "
                                f"launches {r['serve'][precision]['counts']}"
                                f", one process {row['ref_counts']}")
        if not row["ranks_equal"] or tuple(seg[0].shape) != tuple(ref.shape):
            failures.append(f"serve/{precision}: {tuple(seg[0].shape)} "
                            f"against {tuple(ref.shape)}, ranks equal "
                            f"{row['ranks_equal']}")
        if precision == "f32" and not err <= MESH_SERVE_TOL * row[
                "max_logit"]:
            failures.append(f"serve/f32: max error {err:.4g} of the largest "
                            f"logit {row['max_logit']:.4g}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 21: {out['seconds']:.1f} s (ranks {wall_s:.1f} s)")
    if failures:
        raise AssertionError("phase 21: " + "; ".join(failures))
    return out


def trace_table(trace_dir, *flags):
    """tools/parse_trace.py's JSON table of ``trace_dir`` (exit code 0
    required)."""
    import io
    from cobevt_tpu_torch.tools import parse_trace
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = parse_trace.main([trace_dir, "--json", "--top", "100000",
                               *flags])
    if rc != 0:
        raise AssertionError(f"parse_trace {' '.join(flags)} on {trace_dir} "
                             f"exited {rc}")
    return json.loads(buf.getvalue())


def measure_path(name, model_name, flags, trace_dir, card, seed=0):
    """One path of phase 22: its benchmark row with counts, shares and a
    written trace, the same call's counts on the plain versions, and the
    trace's tables.  Returns (record, failures)."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.ops.dispatch import env_switches
    from cobevt_tpu_torch.tools import benchmark, timing

    t0 = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device())
    common = ["--model", model_name, "--seed", str(seed), *flags]
    opt = benchmark.parse_args(common + ["--iters", "3", "--warmup", "2",
                                         "--profile_dir", trace_dir])
    plain_opt = benchmark.parse_args(common + ["--iters", "1", "--warmup",
                                               "1"])
    model, batch, _ = benchmark.BUILD_MODEL[model_name](
        opt.max_cav, opt.seed, device)
    measure = benchmark.measure_train if opt.train else benchmark.measure_eval
    unit = "step" if opt.train else "frame"
    with switches(None), env_switches(
            COBEVT_INT8="1" if opt.int8 else None):
        row = measure(model, model_name, batch, opt, device)
        with ops.forced_impl("torch"):
            plain = measure(model, model_name, batch, plain_opt, device)
    rec = {"flops": row[f"flops_per_{unit}"],
           "plain_flops": plain[f"flops_per_{unit}"],
           "bytes": row[f"bytes_per_{unit}"],
           "plain_bytes": plain[f"bytes_per_{unit}"],
           "int8_ops": row.get(f"int8_ops_per_{unit}"),
           "ms": row[f"ms_per_{unit}"], "mfu": row["mfu"],
           "hbm_util": row["hbm_util"], "hbm_gbs": row["hbm_gbs"],
           "hbm_flag": row.get("hbm_flag"), "card": card,
           "kernel_work": row["kernel_work"],
           "counted_launches": row["counted_launches"],
           "profile": row["profile"]}
    failures = []
    if rec["flops"] != rec["plain_flops"]:
        failures.append(f"{name}: the kernel path counts {rec['flops']!r} "
                        f"FLOPs, the plain path {rec['plain_flops']!r}")
    for fn, n in rec["counted_launches"].items():
        work = rec["kernel_work"].get(WRAPPER_OPS.get(fn))
        if n and (work is None or work["ops"] + work["bytes"] <= 0):
            failures.append(f"{name}: {fn} launched {n} times in the counted "
                            f"call and added no work")
    if rec["mfu"] is None or rec["mfu"] > MEASURE_MFU_MAX:
        failures.append(f"{name}: mfu {rec['mfu']}")
    # the trace of the profiled calls: every op whose kernels ran has a row
    # of the kernel table, and its device total is device_profile's
    launched = {f"cobevt::{WRAPPER_OPS[fn]}"
                for fn, n in row[f"launches_per_{unit}"].items() if n}
    by_op = trace_table(trace_dir, "--by", "op")
    seen = {op for r in by_op["rows"] for op in r["ops"]}
    if launched - seen:
        failures.append(f"{name}: the trace's kernel table has no row of "
                        f"{sorted(launched - seen)}")
    n = rec["profile"]["profiled_steps"]
    rec["trace_device_ms"] = by_op["device_total_ms"] / n
    rel = abs(rec["trace_device_ms"] / rec["profile"]["device_ms_per_step"]
              - 1)
    if rel > MEASURE_TRACE_TOL:
        failures.append(f"{name}: the trace table's device total "
                        f"{rec['trace_device_ms']:.4f} ms a {unit} is "
                        f"{rel:.2%} from device_profile's "
                        f"{rec['profile']['device_ms_per_step']:.4f}")
    modules = trace_table(trace_dir, "--depth", "2")
    scopes = {"/".join(timing.scope_name(p).split("/")[:2])
              for p, _ in model.named_modules() if p}
    rec["modules"] = modules["rows"][:8]
    strangers = {r["key"] for r in modules["rows"]} - scopes - {"<unscoped>"}
    if strangers or not any(r["key"] in scopes for r in modules["rows"]):
        failures.append(f"{name}: module keys that are no attribute path: "
                        f"{sorted(strangers)}")
    bandwidth = trace_table(trace_dir, "--bandwidth")
    rec["trace_bandwidth"] = {k: bandwidth[k] for k in (
        "leaf_device_ms", "counted_ms", "bytes_gb", "achieved_gbs",
        "unknown_ops")}
    rec["seconds"] = time.perf_counter() - t0
    log(f"{name}: {rec['flops']:.6g} FLOPs (plain path {rec['plain_flops']:.6g}"
        f"), {rec['bytes']:.6g} bytes (plain {rec['plain_bytes']:.6g})"
        + (f", int8 {rec['int8_ops']:.6g}" if rec["int8_ops"] else "")
        + f"; {rec['ms']:.3f} ms, mfu {rec['mfu']}, hbm_util "
        f"{rec['hbm_util']}, {rec['hbm_gbs']} GB/s"
        + (f" ({rec['hbm_flag']})" if rec["hbm_flag"] else "")
        + f"; {card}")
    log(f"{name}: trace device {rec['trace_device_ms']:.4f} ms a {unit} "
        f"(device_profile {rec['profile']['device_ms_per_step']:.4f}), "
        f"modules {json.dumps(rec['modules'][:4])}, bandwidth "
        f"{json.dumps(rec['trace_bandwidth'])}; work by op "
        f"{json.dumps(rec['kernel_work'])}; {rec['seconds']:.1f} s")
    del model, batch
    torch.cuda.empty_cache()
    return rec, failures


def phase_measure(seed=0):
    """Phase 22: the measurement layer on the card, five paths at full
    width (MEASURE_PATHS): each path's counts equal on the kernel and plain
    paths, every launched kernel counted with work, mfu set and possible,
    the trace's kernel table holding every op that ran and its device total
    within MEASURE_TRACE_TOL of timing.device_profile's, its module keys
    attribute paths.  hbm_util above 1 is reported with its flag."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    log("== phase 22: measurement (utils/flops.py counts, mfu and HBM share; "
        "benchmark --profile_dir; tools/parse_trace.py) on the 5-agent "
        "CorpBEVT frame and train step, its int8 frame, the SinBEVT-nuScenes "
        "frame and the PointPillar frame")
    card = card_line()
    out, failures = {}, []
    tmp = tempfile.mkdtemp(prefix="cobevt_measure_")
    try:
        for name, model_name, flags in MEASURE_PATHS:
            out[name], bad = measure_path(name, model_name, flags,
                                          os.path.join(tmp, name), card, seed)
            failures += bad
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 22: {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 22: " + "; ".join(failures))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="also write every measurement to this JSON file")
    p.add_argument("--kernels", default=None,
                   help="comma-separated kernel keys (e.g. K5,K2): run only "
                        "their phase-3 rows, then stop without the final "
                        "line")
    p.add_argument("--sinbevt", action="store_true",
                   help="run phase 13 (SinBEVT) after the build, and after "
                        "the rows of --kernels if given, then stop without "
                        "the final line")
    p.add_argument("--sinbevt_train", action="store_true",
                   help="run phase 14 (SinBEVT's train step) after the "
                        "build, and after --kernels and --sinbevt if given, "
                        "then stop without the final line")
    p.add_argument("--train_camera", action="store_true",
                   help="run phase 15 (the camera entry points from a "
                        "fixture) after the build, and after the phases "
                        "above if given, then stop without the final line")
    p.add_argument("--train_nuscenes", action="store_true",
                   help="run phase 16 (the nuScenes entry points from a "
                        "fixture) after the build, and after the phases "
                        "above if given, then stop without the final line")
    p.add_argument("--lidar_data", action="store_true",
                   help="run phase 17 (the LiDAR track from point clouds "
                        "to AP) after the build, and after the phases above "
                        "if given, then stop without the final line")
    p.add_argument("--zoo", action="store_true",
                   help="run phase 18 (the camera model zoo) after the "
                        "build, and after the phases above if given, then "
                        "stop without the final line")
    p.add_argument("--zoo_seed", type=int, default=0,
                   help="seed of phase 18's weights, frames and fixtures")
    p.add_argument("--lidar_zoo", action="store_true",
                   help="run phase 19 (the LiDAR zoo: SECOND from point "
                        "clouds, AttBEVBackbone, the ResNet variants, HGT) "
                        "after the build, and after the phases above if "
                        "given, then stop without the final line")
    p.add_argument("--export_dist", action="store_true",
                   help="run phase 20 (the serving export and the "
                        "data-parallel step) after the build, and after the "
                        "phases above if given, then stop without the final "
                        "line")
    p.add_argument("--mesh", action="store_true",
                   help="run phase 21 (the data x model mesh) after the "
                        "build, and after the phases above if given, then "
                        "stop without the final line")
    p.add_argument("--measure", action="store_true",
                   help="run phase 22 (the measurement layer) after the "
                        "build, and after the phases above if given, then "
                        "stop without the final line")
    # a rank of phase 20(b) or 21, started by the phase itself
    for flag in ("--dp_rank", "--mesh_rank", "--dp_data", "--dp_env",
                 "--dp_backend"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    opt = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    if opt.dp_rank:
        return dp_rank_main(opt)
    if opt.mesh_rank:
        return mesh_rank_main(opt)
    t0 = time.perf_counter()
    phase_environment()
    phase_build()
    if (opt.kernels or opt.sinbevt or opt.sinbevt_train or opt.train_camera
            or opt.train_nuscenes or opt.lidar_data or opt.zoo
            or opt.lidar_zoo or opt.export_dist or opt.mesh or opt.measure):
        details = (phase_kernels(set(opt.kernels.split(",")))
                   if opt.kernels else [])
        sinbevt = phase_sinbevt() if opt.sinbevt else None
        sinbevt_train = phase_sinbevt_train() if opt.sinbevt_train else None
        train_camera = phase_train_camera() if opt.train_camera else None
        train_nuscenes = (phase_train_nuscenes(
            corpbevt_device_rate=camera_device_rate(train_camera))
            if opt.train_nuscenes else None)
        lidar_data = phase_lidar_data() if opt.lidar_data else None
        zoo = phase_zoo(opt.zoo_seed) if opt.zoo else None
        lidar_zoo = phase_lidar_zoo() if opt.lidar_zoo else None
        export_dist = phase_export_dist() if opt.export_dist else None
        mesh = phase_mesh() if opt.mesh else None
        measure = phase_measure() if opt.measure else None
        if opt.out:
            os.makedirs(os.path.dirname(os.path.abspath(opt.out)),
                        exist_ok=True)
            with open(opt.out, "w") as f:
                json.dump({"cases": details, "sinbevt": sinbevt,
                           "sinbevt_train": sinbevt_train,
                           "train_camera": train_camera,
                           "train_nuscenes": train_nuscenes,
                           "lidar_data": lidar_data, "zoo": zoo,
                           "lidar_zoo": lidar_zoo,
                           "export_dist": export_dist, "mesh": mesh,
                           "measure": measure, "card": card_line()}, f,
                          indent=1)
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    # seconds of each phase, printed before the kernels line
    seconds = {"1-2": time.perf_counter() - t0}

    def timed(phase, fn, *args, **kwargs):
        start = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[phase] = time.perf_counter() - start

    details = timed("3", phase_kernels)
    counts, summary, plain, ref_check = timed("4-5", phase_slice)
    train_counts, train_row, gate = timed("6", phase_train)
    k8_launches = timed("7", phase_k8)
    lidar_counts, lidar = timed("8", phase_lidar)
    int8_counts, int8 = timed("9", phase_int8)
    bn_counts = timed("10", phase_micro_bn_stats)
    lidar_train_counts, lidar_train_row, lidar_gate = timed(
        "11", phase_lidar_train)
    ffd_counts = timed("12", phase_micro_ffd_fused)
    sinbevt = timed("13", phase_sinbevt)
    sinbevt_train = timed("14", phase_sinbevt_train)
    train_camera = timed("15", phase_train_camera)
    train_nuscenes = timed("16", phase_train_nuscenes,
                           corpbevt_device_rate=camera_device_rate(
                               train_camera))
    lidar_data = timed("17", phase_lidar_data)
    zoo = timed("18", phase_zoo, opt.zoo_seed)
    lidar_zoo = timed("19", phase_lidar_zoo)
    export_dist = timed("20", phase_export_dist)
    mesh = timed("21", phase_mesh)
    measure = timed("22", phase_measure)

    # (wrapper, source, the TPU function it replaces)
    sources = {
        "K1": ("fused_window_attention_packed",
               "cobevt_tpu_torch/csrc/window_attention.cu",
               "cobevt_tpu/ops/window_attention.py:832"),
        "K2": ("fused_cross_view_attention",
               "cobevt_tpu_torch/csrc/fused_cross_attention.cu",
               "cobevt_tpu/ops/fused_cross_attention.py:465"),
        "K3": ("fused_conv3x3", "cobevt_tpu_torch/csrc/conv3x3.cu",
               "cobevt_tpu/ops/conv2d.py:141"),
        "K4": ("fused_swap_fusion",
               "cobevt_tpu_torch/csrc/fused_swap_fusion.cu",
               "cobevt_tpu/ops/fused_swap_fusion.py:232"),
        "K5": ("fused_window_attention_packed_bwd",
               "cobevt_tpu_torch/csrc/window_attention_bwd.cu",
               "cobevt_tpu/ops/window_attention.py:671"),
        "K6": ("fused_swap_fusion_streaming",
               "cobevt_tpu_torch/csrc/fused_swap_fusion_streaming.cu",
               "cobevt_tpu/ops/fused_swap_fusion.py:387"),
        "K7": ("fused_conv3x3_int8",
               "cobevt_tpu_torch/csrc/conv3x3_int8.cu",
               "cobevt_tpu/ops/conv2d.py:308"),
        # the absmax that scales a stage's first K7 (the JAX package's
        # _act_scale, XLA there): a kernel of K7's source here
        "A7": ("int8_absmax", "cobevt_tpu_torch/csrc/conv3x3_int8.cu",
               "cobevt_tpu/ops/conv2d.py:280"),
        # the int8-resident chain's conv: XLA in the JAX package, the second
        # entry of K7's source here
        "S8": ("conv3x3_s8", "cobevt_tpu_torch/csrc/conv3x3_int8.cu",
               "cobevt_tpu/ops/int8_chain.py:68"),
        "K8": ("fused_window_attention",
               "cobevt_tpu_torch/csrc/window_attention.cu",
               "cobevt_tpu/ops/window_attention.py:899"),
        "K9": ("bn_stats_fwd", "cobevt_tpu_torch/csrc/bn_stats.cu",
               "cobevt_tpu/tools/micro_bn_stats.py:55"),
        "K10": ("bn_stats_bwd", "cobevt_tpu_torch/csrc/bn_stats.cu",
                "cobevt_tpu/tools/micro_bn_stats.py:97"),
        "K11": ("fused_ffd", "cobevt_tpu_torch/csrc/ffd_fused.cu",
                "cobevt_tpu/tools/micro_ffd_fused.py:113"),
        "K12": ("fused_ffd_bwd", "cobevt_tpu_torch/csrc/ffd_fused.cu",
                "cobevt_tpu/tools/micro_ffd_fused.py:133"),
    }
    launches = dict(counts)
    launches["fused_window_attention_packed_bwd"] = train_counts[
        "fused_window_attention_packed_bwd"]
    launches["fused_window_attention"] = k8_launches
    launches["fused_swap_fusion_streaming"] = lidar_counts[
        "fused_swap_fusion_streaming"]
    for fn in ("fused_conv3x3_int8", "conv3x3_s8", "int8_absmax"):
        launches[fn] = int8_counts[fn]
    for fn in ("bn_stats_fwd", "bn_stats_bwd"):
        launches[fn] = bn_counts[fn]
    for fn in ("fused_ffd", "fused_ffd_bwd"):
        launches[fn] = ffd_counts[fn]
    # K1, K2 and K3 on the SinBEVT paths of phase 13 too, and K1, K5 and K2
    # on the train steps of phase 14
    for counts13 in (sinbevt["counts"], sinbevt["stock_counts"],
                     sinbevt["opv2v"]["default_counts"],
                     sinbevt["opv2v"]["stock_counts"]):
        for fn in ("fused_window_attention_packed",
                   "fused_cross_view_attention", "fused_conv3x3"):
            launches[fn] += counts13[fn]
    for counts14 in (sinbevt_train["counts"],
                     sinbevt_train["fused_xattn_counts"],
                     sinbevt_train["opv2v_counts"]):
        for fn in ("fused_window_attention_packed",
                   "fused_window_attention_packed_bwd",
                   "fused_cross_view_attention"):
            launches[fn] += counts14[fn]
    # K1-K5 through the camera entry points of phase 15: the train steps and
    # validation frames of train_camera, and serve_camera's frames
    for counts15 in (train_camera["counts"], train_camera["serve_counts"]):
        for fn in ("fused_window_attention_packed",
                   "fused_window_attention_packed_bwd",
                   "fused_cross_view_attention", "fused_conv3x3",
                   "fused_swap_fusion"):
            launches[fn] += counts15[fn]
    # K1 and K5 in the steps of train_nuscenes, K2 in its IoU passes (16)
    for fn in ("fused_window_attention_packed",
               "fused_window_attention_packed_bwd",
               "fused_cross_view_attention"):
        launches[fn] += train_nuscenes["counts"][fn]
    # K6 in the eval frames of the LiDAR dataset, K1 and K5 in its train
    # steps (17)
    for fn in ("fused_swap_fusion_streaming", "fused_window_attention_packed",
               "fused_window_attention_packed_bwd"):
        launches[fn] += lidar_data["counts"][fn]
    # K3 and K4 in the zoo's eval frames, serve_camera's frames and the
    # validation frame, K1 and K5 in cvt_swap_fuse's train steps (18)
    for counts18 in ([g["counts"] for g in zoo["graphs"].values()]
                     + [zoo["serve"][b]["counts"] for b in ("staged", "off")]
                     + [zoo["train_camera"]["counts"]]):
        for fn in ("fused_conv3x3", "fused_swap_fusion",
                   "fused_window_attention_packed",
                   "fused_window_attention_packed_bwd"):
            launches[fn] += counts18[fn]
    # K6 in SECOND's eval frames, K1 and K5 in its train steps, K3 in the
    # ResNet variants' frames (19)
    for fn, n in lidar_zoo["counts"].items():
        launches[fn] += n
    # every op in the exported CorpBEVT, int8 and SinBEVT frames, K1 and K5
    # in the ranks' data-parallel steps and the NCCL world's step (20)
    for fn, n in export_dist["counts"].items():
        launches[fn] += n
    # K1 and K5 in the mesh's rank steps, K1-K4 in its served frames (21)
    for fn, n in mesh["counts"].items():
        launches[fn] += n
    kernels = []
    for key, (fn, src, replaces) in sources.items():
        rows = [r for r in details if r["kernel"] == key]
        # one 5-agent frame's calls on the fused serving path (K1-K4) or in
        # the int8 mode (K7 and the chain's conv), one train step's calls
        # (K5), one LiDAR frame's four sublayers and head (K6), one call at
        # each shape (K8, K9, K10), one call at the micro protocol's shape
        # (K11, K12), bf16
        bf16 = [r for r in rows
                if r["dtype"] == "bfloat16" and r["per_frame"]]

        def total(field):
            return sum(r[field] * r["per_frame"] for r in bf16)

        library = None
        if all(r.get("library_ms") is not None for r in bf16):
            library = total("library_ms")
        if launches[fn] <= 0:
            raise AssertionError(f"{fn} was launched no time on its path")
        kernels.append({
            "name": fn,
            # K9, K10: the route their wrapper took at every shape
            "route": (",".join(sorted({r["route"] for r in rows}))
                      if key in ("K9", "K10") else "cuda"),
            "source": src, "replaces": replaces,
            "launches": launches[fn],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                         else "operations"),
            "library_ms": library,
        })
    if opt.out:
        os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
        with open(opt.out, "w") as f:
            json.dump({"cases": details, "serve": summary,
                       "serve_plain": plain, "reference": ref_check,
                       "train": train_row, "train_counts": train_counts,
                       "gradient_gate": gate, "lidar": lidar, "int8": int8,
                       "bn_stats_counts": bn_counts,
                       "lidar_train": lidar_train_row,
                       "lidar_train_counts": lidar_train_counts,
                       "lidar_gradient_gate": lidar_gate,
                       "ffd_counts": ffd_counts, "sinbevt": sinbevt,
                       "sinbevt_train": sinbevt_train,
                       "train_camera": train_camera,
                       "train_nuscenes": train_nuscenes,
                       "lidar_data": lidar_data, "zoo": zoo,
                       "lidar_zoo": lidar_zoo,
                       "export_dist": export_dist, "mesh": mesh,
                       "measure": measure, "phase_seconds": seconds,
                       "kernels": kernels,
                       "card": card_line(),
                       "torch": torch.__version__,
                       "cuda": torch.version.cuda,
                       "seconds": time.perf_counter() - t0}, f, indent=1)
    log("phase seconds: " + json.dumps({k: round(v, 1)
                                        for k, v in seconds.items()}))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
