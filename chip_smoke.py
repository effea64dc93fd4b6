#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``panacea_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --kernels      # phases 1 and 2 only
    python3 chip_smoke.py --perception   # phase 1, the perception flash check, phases 11, 14-18
    python3 chip_smoke.py --metrics      # phase 1, phase 12
    python3 chip_smoke.py --variants     # phase 1, phase 13
    python3 chip_smoke.py --zoo          # phase 1, phases 15 to 18
    python3 chip_smoke.py --dist         # phase 1, phase 19
    python3 chip_smoke.py --view_shard   # phase 1, phase 20
    python3 chip_smoke.py --train_grid   # phase 1, phase 21 with its reference

Phases, in order; any failure exits non-zero:
  1. build: compile the port's CUDA kernels from ``panacea_tpu_torch/csrc``
     with nvcc (one process per source, started together) and its rasterizer
     with g++; an ignored ``setmaxnreg`` in the ptxas report is a failure;
  2. kernels: each kernel at every shape the generation and training paths
     give it and at ragged and tiny shapes, held against its plain PyTorch
     version on the same inputs (per element, the rule of
     ``panacea_tpu_torch/ops/tolerance.py``), and timed beside the plain
     version, a PyTorch yardstick and its bound: the bf16 kernels (tensor
     cores; the flash forward also with its row log-sum-exp), the fp32
     kernels (flash as 3xTF32 on the tensor cores at head dims 64 and 32,
     on the FMA units at 16 and 128; GEGLU as 3xTF32; both held to their
     plain versions in float64; TF32 off in every PyTorch product), then the
     backward kernels on each route (bf16 wgmma at every head dim; fp32:
     3xTF32 wgmma at head dims 64 and 32, FMA at 16 and 128, held to the
     plain version in float64), their library time read as the device time
     of SDPA's backward; every flash route also with rows of no valid key;
     the fp32 FMA routes (off every path) timed at their small check shapes;
     the bf16 kernels at head dims 16, 32 and 128 (off the generator's
     paths) checked with ragged, empty and one-key rows and tails, and timed
     forward and backward at shapes with real work (``FLASH_REAL``: the
     generator's per-call work at 640 channels) beside bf16 SDPA and their
     bound, whose terms count the exponentials too; ptxas's registers and
     spills of each bf16 flash instantiation on a line of their own (a spill
     fails the run); the fp32 backward at head dim 32 (``tc32``)
     at the perception training's shape, at B 1, with ragged rows and an
     empty one, and off the tiles; the GEGLU backward timed in bf16 and fp32
     at the training shapes; the fp32 flash forward at the perception eval's
     shape (B 1, Sq 900, Skv 1668, 8 heads of dim 32: ``tc32``) beside fp32
     SDPA;
  3. small input: the tiny engine on the card (bf16, kernels) against the
     same weights on the CPU (fp32, plain versions), two sampler steps;
  4. log_images: ``DiffusionEngine3D.log_images`` called directly at full
     production width (INFERENCE_NUSCENES: 6 views x 8 frames, 256 x 3072
     images, CFG batch of 16 frames) on random arrays, 5 steps, random
     weights from a seed; 21 flash and 69 GEGLU launches per network
     evaluation; one step under torch.profiler;
  5. CLI: ``panacea_tpu_torch.inference.main`` in process, ``--synthetic
     --num_batches 1`` at full width and 25 steps: the dataset with the BEV
     rendering on the host, the copy to the card, ``log_images``, the
     writers; the files that came out are checked, the launch counters must
     rise by 525 and 1,725, and the clip's split is printed;
  6. rollout: the CLI with ``--rollout 2 --num_steps 4``: 15 frames stitched,
     the second window conditioned on the first one's last frame;
  7. fp32 engine: the production engine in fp32 and in bf16 with the same
     weights and the same injected noise, two sampler steps each; the fp32
     launch counters must rise by 42 and 138, and the latents' relative
     difference after each step is printed;
  8. train: the port's train step (``train_step.train_step``) at full
     production width, bs 1 x 8 frames, random weights and clip: 3 steps
     training every network parameter with the EMA, then 2 with
     ``freeze_type spatial`` (frozen parameters bit-equal, temporal masters
     moved); s/step and its split, peak memory, and 42 flash forward, 21 flash
     backward (all on the wgmma route), 138 GEGLU forward and 69 GEGLU
     backward launches a step; then train_fp32: the engine in fp32 with the
     same weights, clip, conditioning and draws, the bf16-vs-fp32 drift of
     one ``spatial`` step's loss and temporal gradients, and 2 fp32
     ``spatial`` steps (the same launches, the flash backward on the fp32
     route);
  9. tiny training step: loss and gradients of the tiny engine, bf16 on the
     card against fp32 on the CPU, held to a bf16 run on the CPU;
 10. training CLI: ``train_torch.py --tiny --synthetic --steps 4 --ckpt_every
     2 --use_ema`` on the card, resumed from iter_2 (parameters and EMA equal
     to the uninterrupted run's within ``RESUME_TOL``, bit-equal so far), and
     its ``engine_final.ckpt`` loaded with strict=True into the inference CLI,
     2 steps;
 11. perception: (a) ``StreamPETRWindow`` at the eval recipe's full width
     (ResNet-50, 5-level FPN, SparseHead: 644 queries, 1024 memory slots, 6
     layers; 6 cameras at 256 x 512) with random weights from a seed, one
     window of 8 frames: s/window, its split (backbone + FPN, head), peak
     memory and 48 fp32 flash launches; its first two frames on the card
     and on the CPU with the same weights, within ``PERCEPTION_TOL``; (b)
     ``panacea_tpu_torch.perception.eval.main --synthetic`` in process, every
     window (5 of 4 frames), metrics printed; (c) the round trip on the card:
     the tiny generation CLI, then the tiny eval CLI on its Gen-nuScenes
     tree, with no generated frame missing.
 12. generation metrics and samplers: (a) InceptionV3 at 8 x 3 x 299 x 299
     and I3D at 2 x 3 x 8 x 224 x 224 (the FID CLI's batches), fp32, random
     weights from a seed: frames/s, clips/s, peak memory, card against CPU
     within ``TOWER_TOL``; (b) ``metrics_gen.eval.main --synthetic`` in
     process; (c) the FID CLI with ``--allow_random_towers`` on phase 5's
     Gen-nuScenes tree (6 clips of 8 frames) against itself (FID and FVD
     within ``FD_SELF_TOL`` of 0) and against a copy with its pixels shifted
     (above it); (d) Heun, Euler ancestral, DPM++2S ancestral, DPM++2M, LMS
     and Euler with churn on the tiny engine, card against CPU with the same
     injected noise, 3 steps, within ``SMALL_TOL``; then DPM++2M through
     ``log_images`` at full width, 4 steps: 21 flash and 69 GEGLU launches
     per network evaluation, s/step beside the Euler phase's.
 13. stage 1 and the variants: (a) stage 1, single-frame six-view generation:
     INFERENCE_NUSCENES with one frame in the network and the ControlNet,
     ``log_images`` at full width (a 32 x 384 latent, the 19-channel
     256 x 3072 hint, bf16, 25 Euler-EDM steps at CFG 5.0), random weights:
     s/step, 21 flash and 69 GEGLU launches per network evaluation, peak
     memory, finite outputs; (b) its 'full' spatial mode without the
     cross-view stage (BASELINE config 1), 4 steps: 46 GEGLU launches an
     evaluation and no flash launch; (c) TINY_STAGE1 card against CPU with
     the same injected noise, 128 tokens a view (the flash route), within
     ``SMALL_TOL``; (d) each off-path variant (the label embeddings, the
     legacy attention, the VAE encoder's attention, the temporal VAE blocks,
     CLIP-L, the vision tower and image embedder, the image-space embedders)
     at small widths in fp32 on the card against the CPU, within
     ``PERCEPTION_TOL``. Phase 2 (and ``--variants`` before phase 13) also
     holds the bf16 kernels to their plain versions at stage 1's shapes.
 14. perception training (run after phase 11): (a) the window recipe
     (streampetr_r50_atss_512x256_window: ``StreamPETRWindow`` with the ATSS
     head, bs 2 windows of 8 frames of 6 cameras at 256 x 512, 644 queries,
     DN at scalar 10 with max_gt 64, GridMask, the recipe's augmentations on
     synthetic infos) through ``perception.train.DetectorTrainer.step``, 3
     steps: s/step and its split (host data and targets, history frames,
     grad-frame forward, loss with the Hungarian matching, backward,
     optimizer), peak memory, every loss term finite, 42 fp32 flash
     launches a step and no other, the frozen stem and layer1 and every
     batch-norm statistic bit-equal; one profiled step; (b) one step's loss
     terms at bs 1 over 2 frames on the card and on the CPU from the same
     weights, window, memory and draws, the CPU's assignment given to both,
     within ``PERCEPTION_TOL``; (c) one step without DN, where the grad
     frame takes the fp32 flash forward and backward (6 backward
     launches, all on ``tc32``), then that backward at (2, 900, 1668, 8,
     32) against the float64 plain version and fp32 SDPA's backward, and
     the forward at B 2; (d) the streaming recipe (``StreamPETR``), 2 steps with the
     memory carried; (e) ``train_perception_torch.py --synthetic --tiny
     --steps 2 --ckpt_every 2`` on the card and its ``--resume`` to step 3.
 15. the perception zoo's dense-attention PETR family (run after phase
     14): (a) the fp32 flash forward (``tc32``) at the dense
     cross-attention's shapes, (1, 900, 12288, 8, 32) (r50, stride 8),
     (1, 900, 3072, 8, 32) (VoVNet-99, stride 16) and (1, 644, 12288, 8,
     32) (PETRHeadDN), and with ragged rows off the key tiles, each against
     the float64 plain version and timed beside fp32 SDPA; (b)
     ``PetrWindow3D`` (r50 + StreamPETRHead, 644 queries, 1024 memory
     slots, 6 layers) on one window of 8 frames of 6 cameras at 256 x 512:
     s/window and its split, peak memory, the flash calls by shape (48
     cross-attention at Skv 12,288 and 48 self-attention at Skv 1,668, all
     launched on ``tc32``), card against CPU over two frames, one profiled
     window; (c) VoVNet-99 + PETRHeadDN on a window (card against CPU on
     one frame) and ``Petr3DP`` (PETRMotionHead) streaming two frames with
     its trajectories, card against CPU, decoded with ``decode_with_traj``;
     (d) ``perception.eval.main --synthetic --tiny --backbone vovnet
     --head petr``; (e) LPIPS (VGG16) on 4 image pairs at 256 x 512, the
     PatchGAN (ndf 64, 3 layers) and LatentLPIPS with the production VAE
     decoder on a (1, 4, 32, 64) latent pair, each card against CPU within
     ``LOSS_TOL`` and timed.
 16. training the dense-attention PETR family (run after phase 15): (a)
     the fp32 flash backward (``tc32``) at the dense cross-attention's
     training shapes, (2, 900 + 640, 12288, 8, 32) (r50, 64 boxes' DN
     queries), (2, 900 + 230, 12288, 8, 32), (2, 644 + 640, 3072, 8, 32)
     (VoVNet-99 + PETRHeadDN) and at B 1, each against the float64 plain
     version and timed beside fp32 SDPA's backward; (b) ``PetrWindow3D``
     (r50 + StreamPETRHead) at the window recipe through
     ``DetectorTrainer.step``, 3 steps: s/step and its split, peak memory,
     every loss term finite, the frozen stem and layer1 and every
     batch-norm statistic bit-equal, the fp32 flash calls by shape (84
     history-frame forwards, the grad frame's 6 cross-attention calls
     forward and backward), every launch on ``tc32``; one profiled step;
     (c) one step's loss terms at bs 1 over 2 frames, card against CPU,
     the CPU's assignment given to both, within ``PERCEPTION_TOL``; (d)
     VoVNet-99 (each OSA block recomputed in the backward) + PETRHeadDN, 2
     steps, the same records; (e) ``Petr3DP`` (PETRMotionHead) at the
     streaming recipe with the ground truth's futures, 2 steps:
     ``loss_traj`` finite, the trajectory branch moved; (f)
     ``train_perception_torch.py --synthetic --tiny --steps 2`` on the
     card from a written YAML with the motion head.
 17. EVA-02, the proposal-query heads and FocalHead (run after phase 16):
     (a) the fp32 flash forward (``tc32``) at the new shapes, (1, 900,
     49152, 8, 32) (EVA + StreamPETRHead, EVA's stride-4 level), (1, 900,
     6144, 8, 32) (the same on FocalHead's top half), (1, 556, 1324, 8,
     32) (Sparse4Dv3's 300 proposals), and each at B 2, against the float64
     plain version and timed beside fp32 SDPA; (b) the eval CLI's EVAViT
     (width 768, 12 blocks) + SparseHead, 4 levels, on one window of 8
     frames of 6 cameras at 256 x 512: s/window and its split, EVA's
     attention (``attention_sdpa``) timed apart, peak memory, the flash
     calls by shape (48, all on ``tc32``), card against CPU over two
     frames, one profiled window; (c) EVA-02-L's widths (1024, 24 blocks,
     16 heads, blocks 5, 11, 17, 23 global) + StreamPETRHead on a window:
     48 cross-attention launches at Skv 49,152 and 48 at 1,668, all on
     ``tc32``; (d) ``Sparse4Dv3`` and a ``sparse_v4`` head streaming two
     frames with 300 random proposals, card against CPU; ``PetrWindow3D``'s
     head on one frame restricted to FocalHead's ``topk_indexes``, card
     against CPU with the CPU's indices; (e) EVA + SparseHeadv3 at the
     window recipe through ``DetectorTrainer.step``, 2 steps, and one
     step's loss terms card against CPU; (f) ``perception.eval.main
     --synthetic --tiny --backbone eva --num_levels 4 --head sparse_v3``
     and the training CLI for 2 steps from a written EVA + sparse_v3 YAML.
 18. the rest of the perception zoo (run after phase 17): (a) the fp32
     flash forward (``tc32``) at the joint heads' shapes, (1, 856, 12288, 8,
     32) (JointStreamPETRHead's 6 x 100 lifted proposals + 256 propagated
     to the stride-8 tokens), (1, 856, 1624, 8, 32) (its self-attention
     over queries and memory) and each at B 2, and the ``tc32`` backward at
     (1 | 2, 320 + 856, 12288, 8, 32) (the same with 320 DN rows), against
     the float64 plain version and timed beside fp32 SDPA; (b) ``SimMOD``
     (r50, FPN from C3, FCOS with 600 proposals, the 6-layer decoder) on
     one frame of 6 cameras, with the deformable and the two-stage
     cross-attention: s/frame and its split (backbone + FPN, FCOS head,
     proposal generation, decoder), peak memory, no flash launch (the
     self-attention over 600 proposals is SDPA's), card against CPU (at
     most 4 proposal indices differ, the scores at every rank within
     PERCEPTION_TOL; each piece of the decoder on the CPU's inputs of that
     piece; the deformable decoder chained on the CPU's proposals; the
     two-stage chain, which amplifies rounding, reported beside the CPU's
     own move under 1e-6 nudges);
     (c) ``JointStreamPETRHead`` with QueryRoIHead at its defaults (1024
     wide, 7 x 7 RoIAlign on the stride-16 level) streaming two frames with
     100 random proposals a camera, then ``JointHead``: the flash calls by
     shape, all on ``tc32``, card against CPU from one shared memory; (d)
     ``CascadeRoIHead`` and ``YOLOXHead`` at their defaults on the FPN of
     the six cameras with 100 boxes a camera, card against CPU; (e) one
     backward at B 1 of ``simmod_loss`` with the IoU3D branch (code size
     11) plus ``fcos_loss``, ``joint_family_loss`` with 32 boxes of DN
     queries through JointStreamPETRHead (6 ``tc32`` forward and backward
     launches), ``cascade_roi_loss`` and ``yolox_loss`` after SimOTA: each
     loss term card against CPU (``LOSS_TOL``, the CPU's host assignments
     given to the card), every gradient finite.
 19. data parallelism (``panacea_tpu_torch/parallel``): each item starts a
     CLI through ``scripts/dist_rank.py`` under ``python -m
     torch.distributed.run --standalone``; every rank must exit 0 and print
     its report (rank, world, backend, device, launch counters, times, peak
     memory) and import no JAX. (a) the inference CLI at full width, one
     clip a rank, 2 steps, on 2 ranks sharing the card over gloo
     (``PANACEA_DIST_BACKEND=gloo``): 21 flash and 69 GEGLU launches per
     network evaluation on each rank, each rank's sampled latents against
     this process's ``log_images`` for the same clip and generator
     (``SMALL_TOL``), s/clip per rank with the card shared; (b) the same
     on one NCCL rank; (c) the generator's trainer at full width in
     ``spatial``, ``--dp 2 --bs 2``, 1 step, on 2 ranks over gloo against
     one process of ``--bs 2`` (``--dp 1``, a group of one over NCCL): the
     losses and the sampled parameters' updates (``SMALL_TOL``), both
     ranks' parameters equal, per rank s/step with its ``allreduce``
     phase, the bytes all-reduced a step, peak memory, 42 / 21 / 138 / 69
     launches a step (both runs with the zero-initialised layers drawn at
     ``ZERO_INIT_STD``); (d) the detector's trainer at the window recipe's full
     width, ``--batch 1`` on 2 ranks over gloo against ``--batch 2`` in one
     process, GridMask, DN and the history jitter off: the loss terms and
     the trained parameters (``PERCEPTION_TOL``), the first step's update
     (``DIST_UPDATE_TOL``), both ranks' parameters equal, 48 ``tc32``
     forward and 6 backward launches a step; (e) the synthetic perception
     eval at full width on 2 ranks over gloo: rank 0's merged metrics equal one
     process's, its predictions within ``PERCEPTION_TOL``. The runs share
     the card in three groups: (d)'s 2 ranks and (e) (beside phase 20's
     ranks in the whole run); (c)'s 2 ranks with (b) and (d)'s reference;
     (c)'s reference with (a) while this process samples (a)'s reference.
 20. one clip over several ranks (``--view_shard``): the bf16 flash kernel
     at the ring's ragged shapes (B 24 at each level, ``kv_lens`` 2 Sq or Sq
     for the global last view) against its plain version and timed beside
     SDPA with the same mask; then the inference CLI with ``--synthetic
     --view_shard 2``, 1 clip of 2 steps, through ``scripts/dist_rank.py
     inference_view_shard`` under torchrun on 4 gloo ranks sharing the card
     (t 2 x V 2, their exchanges staged through host memory), random
     weights from the CLI's seed with the zero-initialised layers at
     ``ZERO_INIT_STD``: per rank 21 flash calls an evaluation, all with
     ``kv_lens`` at the ring's shapes, and 69 GEGLU calls; every rank
     returns the same clip; rank 0 writes one clip's files. Then the CLI's
     sample call again for one step with the network in fp32: over the
     grid against rank 0 alone (``VIEW_SHARD_TOL``) and with a planted
     fault (each rank's own boundary views in place of its neighbours',
     set in that script) at least ``VIEW_SHARD_FAULT`` times it. Per rank
     the seconds of the CLI and the clip's split, the exchanges by kind
     with bytes, peak memory. In the whole run the 4 ranks share the card
     with phase 19's first group.
 21. one clip trained over several ranks (the trainer's ``t`` axis): the
     generator's trainer with ``--synthetic --freeze_type spatial --dp 1
     --bs 2``, 1 step, through ``scripts/dist_rank.py train`` under
     torchrun on 2 gloo ranks sharing the card (dp 1, t 2: each rank holds
     frames 4 r to 4 r + 3 of both clips; the frame halos, the temporal
     statistics and the temporal all-to-all staged through host memory,
     forward, recomputed forward and backward), at full width with the
     zero-initialised layers at ``ZERO_INIT_STD``: the losses and the
     sampled parameters' updates against phase 19 (c)'s one process of
     ``--bs 2`` (``SMALL_TOL``), both ranks' parameters equal, per rank
     s/step and its split, the exchanges a step by kind and direction,
     peak memory, 42 / 21 / 138 / 69 launches a step, all on the bf16
     routes, the flash calls at B 40 (one process's ``--bs 1`` shapes).
     The run shards the training state over both ranks (``--fsdp``,
     ZeRO-3: the network's parameters, the masters, AdamW's moments and
     the first stage split by the JAX leaf rule; each unit gathered through
     the host as it runs, the gradients reduce-scattered): the rank's
     layout and state, measured and counted. Then the step's forward and
     backward again with the network in fp32 on the first clip: the grid's
     trained gradients, reduce-scattered and gathered whole, against rank
     0 alone with the whole clip and the network gathered whole
     (``TRAIN_GRID_TOL``) and with a planted fault (the frame halo's
     gradient not sent back, set in that script) at least
     ``TRAIN_GRID_FAULT`` times it; each gradient's AdamW update, the
     sharded one over the ranks' slices, against rank 0's alone
     (``FSDP_UPDATE_TOL``), and with a planted fault (each rank keeps its
     own gradient slice and skips the reduce-scatter) at least
     ``TRAIN_GRID_FAULT`` times it. Then, in the same group, one bf16 step
     with every network parameter trained and the EMA on (``none``), on
     the first clip (4 frames a rank): each rank's state measured within 5
     % of the layout's count, both ranks' peaks together under the card's
     memory, s/step, its split and its exchanges by kind. In the whole run
     its 2 ranks start after phase 8 and run beside phases 6, 9, 10, 12
     (d)'s tiny samplers and the card-against-CPU checks of phases 13 to
     18, whose records say ``shared_card``; phases 11 to 13, which time paths,
     wait for the ranks to end; its checks wait for phase 19 (c).

The backward kernels (``flash_attention_bwd``, ``geglu_bwd``) are checked in
phase 2 at the training shapes, and counted in phase 8 per route.

The whole run's order: phases 1 to 5, 7 and 8; phase 21's ranks started;
beside them phases 6, 9, 10 and 12 (d)'s tiny samplers, then the checks of
the card against the CPU that time nothing (phase 13 (c) and (d), the loss
terms of phases 14, 16 and 17 (b), phase 18 (e); ``checks_beside_ranks``);
phases 11, 12 and 13 once the ranks have ended; phases 14 to 18; phase 20's
kernel checks; phases 19 and 20 in their groups; phase 21's checks.

The last three lines of standard output are the ``{"kernels": [...]}``
summary, the card's name and power limit as nvidia-smi reports them, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

SEED = 0
# random weights: the parameters the model zero-initialises get this std, so
# every branch computes while the output stays in a trained model's range
ZERO_INIT_STD = 0.02
MAIN_STEPS = 25        # the production sampler's step count (the CLI phase)
DIRECT_STEPS = 5       # the direct log_images phase: s/step and the profiled step
ROLLOUT_WINDOWS, ROLLOUT_STEPS = 2, 4
FP32_STEPS = 2
CLI_SEED = 23          # the CLI's default seed
PEAK_BF16 = 989e12     # H100 SXM dense bf16 flop/s (NVIDIA data sheet)
PEAK_FP32 = 67e12      # H100 SXM fp32 flop/s outside the tensor cores (same data sheet)
PEAK_TF32 = 495e12     # H100 SXM dense TF32 flop/s on the tensor cores (same data sheet)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
# exponentials a second with the special-function units and the FMA units
# both at their peak: ex2.approx 16 an SM a clock, where the tensor cores do
# 4,096 bf16 flops (989e12 / 256 = 3.86e12 at the data sheet's clock), and
# a polynomial 2^x (pn::ex2_poly) on the fp32 lanes, which do PEAK_FP32 / 2
# operations a second, at EX2_POLY_OPS of them an exponential (the three
# adds of its split and the three FMAs of its polynomial; its clamp and its
# exponent add run on the integer units): 3.86e12 + 5.58e12 = 9.45e12
EX2_POLY_OPS = 6
PEAK_EX2 = PEAK_BF16 / 256 + PEAK_FP32 / 2 / EX2_POLY_OPS
QUEUE_CYCLES = 400_000  # a sleep of 0.2 ms a call (at 1.98 GHz), past any call's host time
SMALL_TOL = 5e-2       # tiny engine, bf16 card vs fp32 CPU, relative to the latent's scale
FLASH_PER_EVAL, GEGLU_PER_EVAL = 21, 69
TRAIN_B = 8 * 5        # the training batch of one clip: 8 frames x views 0-4
TRAIN_STEPS, SPATIAL_STEPS = 3, 2
TRAIN_LR = 2e-5        # the trainer's default
TRAIN_DRAW_SEED = SEED + 1  # the posterior, sigma and noise draws of every training run
# launches per training step with every ResBlock and transformer recomputed:
# 21 flash and 69 GEGLU calls a network evaluation, forward twice, backward once
TRAIN_LAUNCHES_PER_STEP = {"flash_attention": 42.0, "flash_attention_bwd": 21.0,
                           "geglu": 138.0, "geglu_bwd": 69.0}
# tiny training step, bf16 card vs fp32 CPU: the loss to SMALL_TOL relative;
# each gradient tensor's distance from fp32 (and all together) at most this
# factor times a bf16 CPU run's, plus SMALL_TOL of its norm and 1e-3 of the
# largest tensor norm (biases that a GroupNorm follows have an exact gradient
# of zero and a computed one of rounding noise)
TINY_GRAD_FACTOR = 2.0
# the tiny CLI resumed from iter_2 against the uninterrupted run, where the
# card's reductions are not bit-reproducible: an Adam update moves a
# parameter by about lr whatever the gradient's size, so two further steps
# whose gradients differ in their last bits stay within a few lr
RESUME_TOL = 5 * TRAIN_LR
# (tokens, channels) of the GEGLU calls of one training clip: levels 0 / 1 / 2 / mid
TRAIN_GEGLU = ((98304, 320), (24576, 640), (6144, 1280), (1536, 1280))
# the perception eval recipe: a window of 8 frames (the recipe's
# --queue_length) of 6 cameras at 256 x 512; its self-attention has B 1,
# Sq 644 + 256, Skv 900 + 768, 8 heads of dim 32 (the fp32 FMA flash route)
PERCEPTION_T, PERCEPTION_HW = 8, (256, 512)
PERCEPTION_FLASH = (1, 900, 1668, 8, 32)
# the bf16 flash kernels at the head dims off the generator's (16, 32, 128),
# timed at the generator's per-call work at a width of 640 channels (H = 640
# / D), k and v the halves of one merged projection: (B, Sq, Skv)
FLASH_REAL = ((40, 2048, 4096), (40, 512, 1024))
FLASH_REAL_WIDTH = 640
# batch rows of a real-work call held to the plain versions: the first two
# and the last two, so that the grid's last blocks are checked too
FLASH_REAL_ROWS = (0, 1, -2, -1)
# the detector in fp32 on the card (cuDNN, cuBLAS, the fp32 flash kernel;
# TF32 off) against the CPU (the plain versions): each output's largest
# difference over its largest value, after a randomly drawn ResNet-50
PERCEPTION_TOL = 1e-3
# phase 12: the FID CLI's towers at its full width (Inception: --batch 8 at
# 299 x 299; I3D: 2 clips of 8 frames at 224 x 224), fp32 with TF32 off,
# card against CPU as PERCEPTION_TOL; timed over TOWER_CALLS calls
TOWER_FRAMES, TOWER_CLIPS = 8, 2
TOWER_HW = {"inception": (299, 299), "i3d": (224, 224)}
TOWER_CALLS = 11
TOWER_TOL = 1e-3
# the Gen-nuScenes tree scored against itself: the same features, so FID and
# FVD are 0 up to the rounding of two eigendecompositions of rank-deficient
# covariances; against a copy with every pixel raised by GEN_SHIFT, above it
FD_SELF_TOL = 1e-3
GEN_SHIFT = 40
# the new samplers on the tiny engine (card against CPU, SMALL_TOL) and
# DPM++2M through log_images at full width
NEW_SAMPLERS = (("HeunEDMSampler", {}), ("EulerAncestralSampler", {}),
                ("DPMPP2SAncestralSampler", {}), ("DPMPP2MSampler", {}),
                ("LinearMultistepSampler", {}), ("EulerEDMSampler", {"s_churn": 2.0}))
SAMPLER_STEPS, DPMPP_STEPS = 3, 4
FULL_HW = (256, 3072)   # the production panorama
# phase 14: perception training at the window recipe
# (streampetr_r50_atss_512x256_window: bs 2, 8 frames, 6 cameras at 256 x 512,
# DN at scalar 10 with max_gt 64, ATSS, GridMask); the history frames' 6
# self-attention calls each on the fp32 flash forward, 7 history frames
PTRAIN_RECIPE = "streampetr_r50_atss_512x256_window"
PTRAIN_STREAM_RECIPE = "streampetr_r50_atss_512x256_nopretrain"
PTRAIN_B, PTRAIN_STEPS, PTRAIN_MAX_GT = 2, 3, 64
PTRAIN_FLASH_PER_STEP = 6 * (PERCEPTION_T - 1)
PTRAIN_FLASH = (PTRAIN_B, 900, 1668, 8, 32)   # B, Sq, Skv, H, D of the grad frame without DN
# phase 15: the dense-attention PETR family at the eval recipe's geometry.
# The cross-attention from the 644 + 256 queries to the tokens of 6 cameras
# at stride 8 (r50, the FPN's first level) or 16 (VoVNet-99 from its third
# stage), and PETRHeadDN's 644 queries; B 1, 8 heads of dim 32, fp32 (tc32)
ZOO_FLASH = ((1, 900, 12288, 8, 32), (1, 900, 3072, 8, 32), (1, 644, 12288, 8, 32))
# phase 16: the dense family in training at the window recipe's geometry
# (bs 2, DN at scalar 10 with max_gt 64: 640 DN queries). The grad frame's
# cross-attention backward on tc32: r50's (2, 900 + 640, 12288), at 23 boxes
# (2, 900 + 230, 12288), PETRHeadDN's (2, 644 + 640, 3072) on VoVNet-99, B 1
ZTRAIN_BWD = ((2, 1540, 12288, 8, 32), (2, 1130, 12288, 8, 32), (2, 1284, 3072, 8, 32),
              (1, 1540, 12288, 8, 32))
ZTRAIN_STEPS = 3
ZTRAIN_PETR = {"head_type": "petr"}
ZTRAIN_VOVNET = {"backbone_type": "vovnet", "neck_start_level": 2, "head_type": "petr_dn",
                 "backbone_cfg": {"use_checkpoint": True}}
ZTRAIN_MOTION = {"head_type": "motion"}
# phase 17: EVA-02, the proposal-query heads and FocalHead's token selection.
# New tc32 shapes: EVA + StreamPETRHead's cross-attention to EVA's stride-4
# level (6 x 64 x 128 tokens), the same restricted to FocalHead's top half
# (6,144 tokens), Sparse4Dv3's 300 proposal queries + 256 propagated to 556
# + 768 memory keys; each at B 1 and in the (2, ...) training form
EVA_FLASH = ((1, 900, 49152, 8, 32), (1, 900, 6144, 8, 32), (1, 556, 1324, 8, 32),
             (2, 900, 49152, 8, 32), (2, 900, 6144, 8, 32), (2, 556, 1324, 8, 32))
# the eval CLI's EVAViT (the JAX package's defaults: width 768, 12 blocks of
# 12 heads, windows of 16, blocks 2, 5, 8 and 11 global), its adapter's 4
# levels; and EVA-02-L's widths, as StreamPETR's EVA-02-L config (width
# 1024, 24 blocks of 16 heads, blocks 5, 11, 17 and 23 global)
EVA_B = {"backbone_type": "eva", "num_levels": 4, "neck_start_level": 0,
         "backbone_cfg": {"img_size": PERCEPTION_HW}}
EVA_L = dict(EVA_B, backbone_cfg={"img_size": PERCEPTION_HW, "width": 1024, "layers": 24,
                                  "heads": 16, "window_size": 16,
                                  "window_block_indexes": [i for i in range(24) if i % 6 != 5]})
PROPOSALS = 300
FOCAL_RATIO = 0.5
# phase 18: the rest of the perception zoo. SimMOD's FCOS proposals; the
# joint heads on JOINT_PROPOSALS random 2D proposals a camera, so
# JointStreamPETRHead has 6 x 100 + 256 = 856 queries: its cross-attention
# to the 12,288 stride-8 tokens and its self-attention to 856 + 768 memory
# keys on tc32, at B 1 and in the (2, ...) training form; in training
# JOINT_MAX_GT boxes of DN queries at scalar 10 (320 rows) before them.
# CascadeRoIHead and YOLOX with ROI_BOXES boxes a camera
SIMMOD_PROPOSALS, JOINT_PROPOSALS, JOINT_MAX_GT, ROI_BOXES = 600, 100, 32, 100
# SimMOD card against CPU: the proposal ranks whose index may differ (scores
# that tie within rounding), and the draws of the 1e-6 nudge of the CPU's
# proposal features that measure how far its chained decoder moves
SIMMOD_INDEX_SLACK, SIMMOD_NUDGE_SEEDS = 4, 3
JOINT_FLASH = ((1, 856, 12288, 8, 32), (1, 856, 1624, 8, 32), (2, 856, 12288, 8, 32),
               (2, 856, 1624, 8, 32))
JOINT_BWD = ((1, 320 + 856, 12288, 8, 32), (2, 320 + 856, 12288, 8, 32))
LPIPS_PAIRS = 4
# the VAE's losses in fp32, card against CPU: the largest difference over the
# largest value (a scalar's relative difference)
LOSS_TOL = 1e-3
# phase 19: the CLIs under torchrun. Inference at full width, 2 steps a clip;
# the generator's trainer at full width in ``spatial``, 1 step; the window
# recipe's detector without DN, whose grad frame then takes the fp32 flash
# forward and backward: 7 history frames x 6 layers + 6 forward and 6
# backward launches a step, all tc32. DIST_TIMEOUT bounds each command
DIST_STEPS, DIST_TRAIN_STEPS = 2, 1
DIST_PTRAIN_FLASH, DIST_PTRAIN_BWD = 6 * (PERCEPTION_T - 1) + 6, 6
# the detector's 2-rank step against one process's, fp32 on the card: the
# loss terms and the trained parameters within PERCEPTION_TOL, both ranks'
# parameters equal, and the first AdamW step's update (about lr times the
# gradient's sign) within DIST_UPDATE_TOL of its norm. Where a gradient is
# near zero, cuDNN's algorithms for batch 1 and 2 round it to either sign:
# 1.4e-2 on an H100; a rank that steps on its own half of the batch's
# gradient, without the all-reduce, moves most signs, and one that skips the
# optimizer reads 1
DIST_UPDATE_TOL = 0.1
DIST_TIMEOUT = 300
# the generator's trainer in phases 19 and 21: no final saves (27 GB at full
# width), the zero-initialised layers drawn so that the frame grid's
# exchanges carry gradients
TRAIN_OPTS = ["--no_final", "--zero_init_std", str(ZERO_INIT_STD)]
GEN_ARGS = ["--synthetic", "--freeze_type", "spatial", "--steps", str(DIST_TRAIN_STEPS),
            "--ckpt_every", "0", "--log_every", "1"]
# phase 20: one clip over 4 gloo ranks sharing the card, t 2 x V 2, full
# width, 2 steps. A rank of (t 2, V 2) holds 2 CFG halves x 4 frames x 3
# views: the ring's one flash call a cross-view block has B 24 and kv_lens
# 2 Sq, or Sq for the global last view (view rank 1's third view); the
# mid-block's Sq 32 goes to SDPA. 21 of those calls and 69 GEGLU calls an
# evaluation on every rank, as one process's
VIEW_SHARD_RANKS, VIEW_SHARD_V, VIEW_SHARD_STEPS = 4, 2, 2
RING_FLASH = ((24, 2048, 4096, 5), (24, 512, 1024, 10), (24, 128, 256, 20))
RING_CALLS_PER_LEVEL = 7    # cross-view blocks an evaluation at each of levels 0 to 2
# the check: the CLI's sample call repeated with the network in fp32 (TF32
# off; the fp32 kernels), one step, over the grid and by rank 0 alone, as
# the largest difference over the largest latent: summation orders and
# algorithms differ (the statistics' sums, cuDNN at other widths, the ring's
# one flash call against one process's flash and SDPA calls), within
# VIEW_SHARD_TOL; the planted fault (each rank's own boundary views in place
# of its neighbours' K/V) at least VIEW_SHARD_FAULT times it. In bf16 the
# same one-step call read 4.49e-2 over the grid and 5.29e-2 with the fault
# on an H100 (PERF.md, the single-clip findings): no bf16 check tells them
# apart, so the bf16 route of the ring's call is held by the kernel checks
# at its shapes
VIEW_SHARD_TOL = 1e-4
VIEW_SHARD_FAULT = 10.0
# phase 21: the generator's trainer over t on 2 gloo ranks sharing the card
# (dp 1, t 2: each rank 4 frames of both clips of --bs 2, the shapes of one
# process's --bs 1), full width, ``spatial``, 1 step, against phase 19 (c)'s
# one process of --bs 2. The check: the step's forward and backward again
# with the network in fp32 on the first clip, over the grid and by rank 0
# alone with the whole clip; the trained gradients' distance (the ranks'
# mean, jointly over the norm of rank 0's alone) within TRAIN_GRID_TOL (the
# summation orders differ: the temporal statistics' two all-reduced passes,
# cuDNN and cuBLAS at 4 frames against 8, the flash and GEGLU kernels on
# other batch sizes), and a planted fault (the frame halo's gradient not
# sent back, set in scripts/dist_rank.py) at least TRAIN_GRID_FAULT times it
TRAIN_GRID_RANKS = 2
TRAIN_GRID_TOL = 1e-4
TRAIN_GRID_FAULT = 10.0
# the sharded step's fp32 AdamW update against rank 0's alone, over the
# norm of rank 0's: the gradients differ by the grid's rounding (2.5e-5),
# and AdamW's first step moves an element whose gradient is near 0 by about
# lr either way (the tiny CPU step reads 7e-4); the planted fault (no
# reduce-scatter) at least TRAIN_GRID_FAULT times it
FSDP_UPDATE_TOL = 1e-2
# a rank's training state measured on its tensors against the layout's count
FSDP_STATE_TOL = 0.05
# phase 21's job: the sharded step, its replays and the none + EMA step
TRAIN_GRID_TIMEOUT = 600


T_START = time.perf_counter()
# what runs on the card beside the phases now logging (``card_shared_with``)
SHARED = {"with": None}
# the checks of the card against the CPU that time nothing (phase 13 (c)
# and (d), the loss terms of phases 14, 16 and 17 (b) and 18 (e)): the
# whole run makes them beside phase 21's ranks (``checks_beside_ranks``),
# and their phases leave them out then
BESIDE_RANKS = {"card_vs_cpu": False}


def log(obj) -> None:
    if isinstance(obj, dict) and "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)   # seconds into the run
        if SHARED["with"]:
            obj.update(shared_card=True, card_shared_with=SHARED["with"])
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


@contextlib.contextmanager
def card_shared_with(what: str):
    """Every record logged inside says that ``what`` ran on the card beside
    it (``shared_card``): its times are not the card's alone."""
    SHARED["with"] = what
    try:
        yield
    finally:
        SHARED["with"] = None


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(torch, fn, iters: int) -> float:
    """Device time of one call with the host's time kept out: the calls are
    queued behind a kernel that sleeps for longer than the host takes to
    issue them, so the card runs them back to back; CUDA events over
    ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(QUEUE_CYCLES * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters: int) -> float:
    """Host time of one call, not waiting for the card: checks, tensor-map
    specs and their encoding, and the launch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def bound_terms(flops: float, nbytes: float, peak: float = PEAK_BF16, exps: float = 0.0) -> dict:
    """ms of each term of a bound: the products at ``peak`` ("tensor"), the
    bytes at PEAK_BYTES, the exponentials at PEAK_EX2."""
    return {"tensor": flops / peak * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3,
            "exponentials": exps / PEAK_EX2 * 1e3}


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16, exps: float = 0.0):
    """(ms, "operations" or "bytes"): the largest of the terms of
    ``bound_terms``; the products and the exponentials are both operations."""
    t = bound_terms(flops, nbytes, peak, exps)
    ops = max(t["tensor"], t["exponentials"])
    return max(ops, t["bytes"]), ("operations" if ops >= t["bytes"] else "bytes")


def flash_bound(b, sq, skv, h, d, kv_eff, bwd: bool):
    """(ms, bound_by, terms) of a bf16 flash call with ``kv_eff`` valid
    keys a row: forward 4 B H Sq kv_eff D flops and one exponential a score,
    reading q, k and v and writing o; backward 10 flops a score and channel
    (the five products) and one exponential a score (P, which the function
    needs once, however often a design recomputes it), reading q, k, v, o,
    dO and lse and writing dq, dk and dv."""
    scores = float(b) * h * sq * kv_eff
    if bwd:
        nbytes = 2.0 * b * h * d * (3 * sq + 2 * kv_eff) + 4.0 * b * h * sq \
            + 2.0 * b * h * d * (sq + 2 * skv)
        flops, exps = 10.0 * scores * d, scores
    else:
        nbytes = 2.0 * (2 * b * sq * h * d + 2 * b * kv_eff * h * d)
        flops, exps = 4.0 * scores * d, scores
    terms = bound_terms(flops, nbytes, PEAK_BF16, exps)
    return (*bound(flops, nbytes, PEAK_BF16, exps), terms)


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill stores, spill loads) of each flash kernel
    in an nvcc -Xptxas -v log."""
    import re
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "flash" in name:
            out.append({"kernel": name, "registers": int(m.group(1)),
                        "spill_stores": spill[0], "spill_loads": spill[1]})
            name = None
    return out


def flash_inputs(torch, dev, b, sq, skv, h, d, merged=True, seed=SEED):
    """bf16 q, k, v and dO from a seed; ``merged``: k and v the halves of one
    (B, Skv, 2 H D) projection."""
    g = torch.Generator(device=dev).manual_seed(seed + sq + skv + d)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).bfloat16()
    if merged:
        kv = torch.randn((b, skv, 2 * h * d), generator=g, device=dev).bfloat16()
        k, v = (t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1))
    else:
        k, v = (torch.randn((b, skv, h, d), generator=g, device=dev).bfloat16()
                for _ in range(2))
    do = torch.randn((b, sq, h, d), generator=g, device=dev).bfloat16()
    return q, k, v, do


def flash_fwd_bwd_check(torch, fa, tol, q, k, v, do, lens, rows=None) -> dict:
    """The bf16 forward and backward kernels against the plain versions on
    the batch rows ``rows`` (indices, negative from the end; all by
    default): ``fwd_ratio`` under ``tol.FLASH``,
    ``bwd_ratio`` the worst of dq, dk, dv under ``tol.FLASH_BWD``; keys
    past a row's kv_len and empty rows' dq and dk, which must be exactly 0;
    ``ok`` where all hold."""
    out, lse = fa.flash_attention_with_lse(q, k, v, kv_lens=lens)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, kv_lens=lens)
    n = slice(None) if rows is None else sorted({r % q.shape[0] for r in rows})
    sub = [t[n] for t in (q, k, v, out, lse, do)]
    sub_lens = None if lens is None else lens[n]
    want = fa.flash_attention_plain(*sub[:3], kv_lens=sub_lens)
    want_g = fa.flash_attention_bwd_plain(*sub, kv_lens=sub_lens)
    rec = {"fwd_ratio": tol.worst_ratio(out[n], want, **tol.FLASH),
           "bwd_ratio": max(tol.worst_ratio(a[n], w, **tol.FLASH_BWD)
                            for a, w in zip(grads, want_g))}
    if lens is not None:
        dead = (torch.arange(k.shape[1], device=q.device)[None] >= lens[:, None]) & (
            lens[:, None] > 0)
        empty = lens == 0
        rec["masked_keys_grad_max"] = max(
            (g[dead].abs().max().item() if dead.any() else 0.0) for g in grads[1:])
        rec["empty_rows_dq_dk_max"] = max(
            (g[empty].abs().max().item() if empty.any() else 0.0) for g in grads[:2])
    rec["ok"] = (rec["fwd_ratio"] <= 1.0 and rec["bwd_ratio"] <= 1.0
                 and rec.get("masked_keys_grad_max", 0.0) == 0.0
                 and rec.get("empty_rows_dq_dk_max", 0.0) == 0.0)
    return rec


def flash_real_work(torch, F, fa, tol, dev, b, sq, skv, h, d, iters=10, backward=True,
                    plain=False) -> dict:
    """One real-work shape of the bf16 flash kernels (merged kv): the
    FLASH_REAL_ROWS batch rows of the forward and the backward against the
    plain versions (``flash_fwd_bwd_check``); each timed as device time with
    the host's time kept out (``queued_ms``), as CUDA events over calls
    issued back to back and as the host's microseconds a call; SDPA in bf16
    on the same inputs as device time (its backward alone, of one recorded
    forward); the bounds (``flash_bound``) with their terms; ``plain``: the
    plain versions' time on the whole call too."""
    q, k, v, do = flash_inputs(torch, dev, b, sq, skv, h, d)
    rec = {"kernel": "flash_attention_real_work",
           "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "D": d, "kv": "merged"}}
    before = (dict(fa.flash_attention.route_launches), dict(fa.flash_attention_bwd.route_launches))
    rec.update(flash_fwd_bwd_check(torch, fa, tol, q, k, v, do, None,
                                   rows=FLASH_REAL_ROWS))
    rec["route"], rec["bwd_route"] = (
        next(r for r, n in f.route_launches.items() if n != was[r])
        for f, was in zip((fa.flash_attention, fa.flash_attention_bwd), before))
    out, lse = fa.flash_attention_with_lse(q, k, v)

    def fwd():
        return fa.flash_attention(q, k, v)

    def bwd():
        return fa.flash_attention_bwd(q, k, v, out, lse, do)

    rec["fwd_ms_device"] = queued_ms(torch, fwd, iters)
    rec["fwd_ms"] = time_ms(torch, fwd, iters)
    rec["fwd_host_us"] = host_us(torch, fwd, 2 * iters)
    q0, k0, v0 = (t.transpose(1, 2) for t in (q, k, v))
    rec["sdpa_fwd_ms_device"] = queued_ms(
        torch, lambda: F.scaled_dot_product_attention(q0, k0, v0), iters)
    if plain:
        rec["fwd_plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v), 1)
    ms, rec["fwd_bound_by"], terms = flash_bound(b, sq, skv, h, d, skv, bwd=False)
    rec.update(fwd_bound_ms=ms, fwd_bound_term=max(terms, key=terms.get), fwd_bound_terms_ms=terms)
    if not backward:
        return rec
    rec["bwd_ms_device"] = queued_ms(torch, bwd, iters)
    rec["bwd_ms"] = time_ms(torch, bwd, iters)
    rec["bwd_host_us"] = host_us(torch, bwd, 2 * iters)
    qt, kt, vt = (t.detach().requires_grad_() for t in (q0, k0, v0))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    rec["sdpa_bwd_ms_device"] = queued_ms(
        torch, lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True),
        iters)
    if plain:
        rec["bwd_plain_ms"] = time_ms(
            torch, lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do), 1)
    ms, rec["bwd_bound_by"], terms = flash_bound(b, sq, skv, h, d, skv, bwd=True)
    rec.update(bwd_bound_ms=ms, bwd_bound_term=max(terms, key=terms.get), bwd_bound_terms_ms=terms)
    return rec


def check_flash(torch, F, fa, tol, dev, b, sq, skv, h, d, ragged=False, merged_kv=False,
                timed=True, lens=None, fp32=False):
    """``merged_kv``: k and v are the two halves of one (B, Skv, 2 H D)
    projection, the strided layout the cross-view call gives the kernel.
    ``ragged`` draws the rows' key counts; ``lens`` gives them. ``fp32``:
    fp32 operands (the fp32 route, ``tol.FLASH_F32``), held to the plain
    version evaluated in float64, with the kernel's ratio against the fp32
    plain version and the fp32 plain version's against float64 beside it;
    ``fp32_kernel`` names the fp32 kernel that ran; the bound is three
    products at the TF32 rate at head dims 64 and 32 (3xTF32),
    ``bound_fma_ms`` the fp32 FMA rate's. At head dim 32 in fp32 (the
    perception self-attention) the row log-sum-exp is held to float64's
    under ``FLASH_LSE`` too, and ``ms_device`` and ``library_ms_device``
    are device times with the host's time kept out (``queued_ms``): a call
    there takes about as long on the host as on the card. TF32 is off for
    the plain version and the yardstick."""
    dtype, rule = (torch.float32, tol.FLASH_F32) if fp32 else (torch.bfloat16, tol.FLASH)
    elem = 4.0 if fp32 else 2.0
    g = torch.Generator(device=dev).manual_seed(sq * 7 + skv + d)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
    if merged_kv:
        kv = torch.randn((b, skv, 2 * h * d), generator=g, device=dev).to(dtype)
        k, v = (t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1))
    else:
        k = torch.randn((b, skv, h, d), generator=g, device=dev).to(dtype)
        v = torch.randn((b, skv, h, d), generator=g, device=dev).to(dtype)
    if lens is not None:
        ragged = True
        lens = torch.tensor(lens, device=dev, dtype=torch.int32)
    elif ragged:
        lens = torch.randint(1, skv + 1, (b,), generator=g, device=dev, dtype=torch.int32)
    routes = dict(fa.flash_attention.route_launches)
    kernels = dict(fa.flash_attention.fp32_kernel_launches)
    got = fa.flash_attention(q, k, v, kv_lens=lens)
    route = next(r for r, n in fa.flash_attention.route_launches.items() if n != routes[r])
    plain = fa.flash_attention_plain(q, k, v, kv_lens=lens)
    want = (fa.flash_attention_plain(q.double(), k.double(), v.double(), kv_lens=lens,
                                     return_lse=fp32 and d == 32)
            if fp32 else plain)
    if fp32 and d == 32:
        want, want_lse = want
        got_with_lse, got_lse = fa.flash_attention_with_lse(q, k, v, kv_lens=lens)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs().max().item()
    ratio = tol.worst_ratio(got, want, **rule)
    rec = {"kernel": "flash_attention", "route": route, "dtype": str(dtype),
           "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "D": d, "ragged": ragged,
                     "kv": "merged" if merged_kv else "contiguous"},
           "max_abs_err": err, "rms_want": want.double().square().mean().sqrt().item(),
           "worst_ratio": ratio, "tol": rule}
    if fp32:
        rec["fp32_kernel"] = next(n for n, c in fa.flash_attention.fp32_kernel_launches.items()
                                  if c != kernels[n])
        rec["want"] = "flash_attention_plain in float64"
        rec["worst_ratio_vs_fp32_plain"] = tol.worst_ratio(got, plain, **rule)
        rec["fp32_plain_worst_ratio_vs_f64"] = tol.worst_ratio(plain, want, **rule)
    if fp32 and d == 32:
        rec["lse_worst_ratio"] = tol.worst_ratio(got_lse, want_lse, **tol.FLASH_LSE)
        rec["lse_tol"] = tol.FLASH_LSE
        rec["out_with_lse_equal"] = bool(torch.equal(got_with_lse, got))
        ratio = max(ratio, rec["lse_worst_ratio"]) if rec["out_with_lse_equal"] else float("inf")
        del got_with_lse, got_lse, want_lse
    del want, plain, got
    if fp32:
        free(torch)   # the level-0 float64 operands and chunk scores take a few GB
    if timed:
        mask = None
        if lens is not None:
            mask = (torch.arange(skv, device=dev)[None] < lens[:, None])[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kv_eff = float(lens.sum().item()) / b if lens is not None else skv  # keys the rows need
        flops = 4.0 * b * h * sq * kv_eff * d
        nbytes = elem * (2 * b * sq * h * d + 2 * b * kv_eff * h * d) + (4 * b if ragged else 0)
        if fp32 and d in (32, 64):
            rec["bound_ms"], rec["bound_by"] = bound(3 * flops, nbytes, PEAK_TF32)
            rec["bound_fma_ms"], _ = bound(flops, nbytes, PEAK_FP32)
        elif fp32:   # the FMA kernel: its own bound, and a 3xTF32 design's beside it
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, PEAK_FP32)
            rec["bound_3xtf32_ms"], _ = bound(3 * flops, nbytes, PEAK_TF32)
        else:
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, PEAK_BF16)
        rec["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, kv_lens=lens),
                            5 if fp32 else 20)
        # the same forward also writing the row log-sum-exp (training only),
        # timed next to it, so that both find the card in the same state
        rec["ms_with_lse"] = time_ms(
            torch, lambda: fa.flash_attention_with_lse(q, k, v, kv_lens=lens), 5 if fp32 else 20)
        rec["plain_ms"] = time_ms(
            torch, lambda: fa.flash_attention_plain(q, k, v, kv_lens=lens), 2)
        rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), 5 if fp32 else 20)
        rec["host_us"] = host_us(torch, lambda: fa.flash_attention(q, k, v, kv_lens=lens), 50)
        if fp32 and d == 32:
            rec["ms_device"] = queued_ms(torch, lambda: fa.flash_attention(q, k, v, kv_lens=lens),
                                         20)
            rec["library_ms_device"] = queued_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), 20)
    log(rec)
    if not ratio <= 1.0:
        raise AssertionError(f"flash_attention disagrees with its plain version: {rec}")
    return rec


def device_ms(torch, fn, iters: int) -> float:
    """Device time of one call: the CUDA kernels' time summed by
    torch.profiler over ``iters`` calls (after one warm-up), divided by
    ``iters``; no host time enters. None where the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(evt, "self_device_time_total", 0.0) or 0.0 for evt in prof.key_averages()
             if str(evt.device_type).endswith("CUDA"))
    return us / 1e3 / iters if us > 0 else None


def check_flash_bwd(torch, F, fa, tol, dev, b, sq, skv, h, d, merged_kv=True, lens=None,
                    timed=True, fp32=False):
    """The backward kernel against ``flash_attention_bwd_plain`` on the same
    q, k, v, kernel output, kernel row log-sum-exp and output gradient; the
    kernel's log-sum-exp against the plain forward's. ``fp32``: fp32
    operands (the fp32 route, ``tol.FLASH_BWD_F32``), held to the plain
    version evaluated in float64, with the kernel's ratio against the fp32
    plain version and the fp32 plain version's against float64 beside it;
    ``fp32_kernel`` names the fp32 kernels that ran; the bound is three
    products at the TF32 rate (3xTF32 at head dims 64 and 32),
    ``bound_fma_ms`` the fp32 FMA rate's. A row with ``lens`` 0 attends to
    every key alike: its dq and dk must be exactly 0. ``library_ms`` is
    SDPA's backward alone on the device (the kernels' time under
    torch.profiler; the events' reading where the profiler missed the
    port's kernel); ``library_ms_loop`` the same calls
    timed with CUDA events, and ``library_ms_fwd_bwd_less_fwd`` the older
    reading, which carries autograd's host time. At head dim 32 in fp32
    (the perception self-attention) ``ms`` and ``library_ms`` are CUDA
    events over calls issued back to back, ``ms_device`` and
    ``library_ms_device`` device times with the host's time kept out
    (``queued_ms``), ``host_us`` the host's time a call, and
    ``ms_profiler`` the kernels' time under torch.profiler (None where it
    saw none)."""
    dtype, rule = (torch.float32, tol.FLASH_BWD_F32) if fp32 else (torch.bfloat16, tol.FLASH_BWD)
    elem = 4.0 if fp32 else 2.0
    g = torch.Generator(device=dev).manual_seed(sq * 5 + skv + d)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
    if merged_kv:
        kv = torch.randn((b, skv, 2 * h * d), generator=g, device=dev).to(dtype)
        k, v = (t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1))
    else:
        k = torch.randn((b, skv, h, d), generator=g, device=dev).to(dtype)
        v = torch.randn((b, skv, h, d), generator=g, device=dev).to(dtype)
    do = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
    if lens is not None:
        lens = torch.tensor(lens, device=dev, dtype=torch.int32)
    o, lse = fa.flash_attention_with_lse(q, k, v, kv_lens=lens)
    _, lse_plain = fa.flash_attention_plain(q, k, v, kv_lens=lens, return_lse=True)
    n0, routes = fa.flash_attention_bwd.launches, dict(fa.flash_attention_bwd.route_launches)
    kernels = dict(fa.flash_attention_bwd.fp32_kernel_launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, kv_lens=lens)
    if fa.flash_attention_bwd.launches != n0 + 1:
        raise AssertionError("flash_attention_bwd did not launch its kernel")
    route = next(r for r, n in fa.flash_attention_bwd.route_launches.items() if n != routes[r])
    perception = fp32 and d == 32
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, kv_lens=lens)
    want = (fa.flash_attention_bwd_plain(*(t.double() for t in (q, k, v, o, lse, do)),
                                         kv_lens=lens) if fp32 else plain)
    torch.cuda.synchronize()
    ratios = {n: tol.worst_ratio(a, w, **rule) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    rec = {"kernel": "flash_attention_bwd", "route": route, "dtype": str(dtype),
           "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "D": d, "ragged": lens is not None,
                     "kv": "merged" if merged_kv else "contiguous"},
           "max_abs_err": max((a.float() - w.float()).abs().max().item()
                              for a, w in zip(got, want)),
           "worst_ratio": ratios, "tol": rule,
           "lse_worst_ratio": tol.worst_ratio(lse, lse_plain, **tol.FLASH_LSE),
           "lse_tol": tol.FLASH_LSE}
    if fp32:
        rec["fp32_kernel"] = next(
            n for n, c in fa.flash_attention_bwd.fp32_kernel_launches.items() if c != kernels[n])
        rec["want"] = "flash_attention_bwd_plain in float64"
        rec["worst_ratio_vs_fp32_plain"] = max(tol.worst_ratio(a, p, **rule)
                                               for a, p in zip(got, plain))
        rec["fp32_plain_worst_ratio_vs_f64"] = max(tol.worst_ratio(p, w, **rule)
                                                   for p, w in zip(plain, want))
    del want, plain
    free(torch)
    if lens is not None:
        # keys past a row's kv_len; a row with none attends to every key
        dead = (torch.arange(skv, device=dev)[None] >= lens[:, None]) & (lens[:, None] > 0)
        rec["masked_keys_grad_max"] = max(got[1][dead].abs().max().item() if dead.any() else 0.0,
                                          got[2][dead].abs().max().item() if dead.any() else 0.0)
        empty = lens == 0
        rec["empty_rows_dq_dk_max"] = max(got[0][empty].abs().max().item() if empty.any() else 0.0,
                                          got[1][empty].abs().max().item() if empty.any() else 0.0)
    if timed:
        kv_eff = float(lens.sum().item()) / b if lens is not None else skv
        flops = 10.0 * b * h * sq * kv_eff * d
        nbytes = elem * b * h * d * (3 * sq + 2 * kv_eff) + 4.0 * b * h * sq \
            + elem * b * h * d * (sq + 2 * skv)
        if fp32 and d in (32, 64):
            rec["bound_ms"], rec["bound_by"] = bound(3 * flops, nbytes, PEAK_TF32)
            rec["bound_fma_ms"], _ = bound(flops, nbytes, PEAK_FP32)
        elif fp32:   # the FMA kernels: their own bound, and a 3xTF32 design's beside it
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, PEAK_FP32)
            rec["bound_3xtf32_ms"], _ = bound(3 * flops, nbytes, PEAK_TF32)
        else:
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, PEAK_BF16)

        def kernel():
            return fa.flash_attention_bwd(q, k, v, o, lse, do, kv_lens=lens)

        rec["ms"] = time_ms(torch, kernel, 10)
        if perception:
            rec["ms_device"] = queued_ms(torch, kernel, 20)
            rec["host_us"] = host_us(torch, kernel, 50)
            # whether torch.profiler sees the kernels at this point of the run
            rec["ms_profiler"] = device_ms(torch, kernel, 5)
        else:
            rec["ms_device"] = device_ms(torch, kernel, 5)
        rec["plain_ms"] = time_ms(
            torch, lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, kv_lens=lens), 1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2)
        mask = None
        if lens is not None:
            mask = (torch.arange(skv, device=dev)[None] < lens[:, None])[:, None, None, :]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

        out = sdpa_fwd()

        def sdpa_bwd():  # the backward alone, of one recorded forward
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

        rec["library_ms_loop"] = time_ms(torch, sdpa_bwd, 10)
        rec["library_ms_fwd_bwd_less_fwd"] = (time_ms(torch, sdpa_fwd_bwd, 10)
                                              - time_ms(torch, sdpa_fwd, 10))
        if perception:
            rec["library_ms"], rec["library_ms_from"] = rec["library_ms_loop"], "events"
            rec["library_ms_device"] = queued_ms(torch, sdpa_bwd, 20)
        else:
            # a profiler session that missed the port's kernel is not
            # trusted with SDPA's either: then both readings are the events'
            lib_device = device_ms(torch, sdpa_bwd, 5) if rec["ms_device"] is not None else None
            rec["library_ms"] = lib_device if lib_device is not None else rec["library_ms_loop"]
            rec["library_ms_from"] = "profiler" if lib_device is not None else "events"
        del out
    log(rec)
    if not (max(ratios.values()) <= 1.0 and rec["lse_worst_ratio"] <= 1.0
            and rec.get("masked_keys_grad_max", 0.0) == 0.0
            and rec.get("empty_rows_dq_dk_max", 0.0) == 0.0):
        raise AssertionError(f"flash_attention_bwd disagrees with its plain version: {rec}")
    want_route = "fp32" if fp32 else "wgmma"   # bf16 at every head dim
    if route != want_route or (fp32 and rec["fp32_kernel"] != {64: "tc", 32: "tc32"}.get(d, "fma")):
        raise AssertionError(f"flash_attention_bwd took route {route}, not {want_route}, or "
                             f"the wrong fp32 kernel: {rec}")
    return rec


def check_geglu_bwd(torch, F, gg, tol, dev, tokens, inner, timed=True, fp32=False):
    """The gate-gradient kernel against ``geglu_bwd_plain`` on the same hg
    and dy; ``library_ms``: the unfused PyTorch gate gradient (``F.gelu``,
    its backward and the products) in the operands' type."""
    dtype = torch.float32 if fp32 else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(tokens + inner)
    hg = torch.randn((tokens, 2 * inner), generator=g, device=dev).to(dtype)
    dy = torch.randn((tokens, inner), generator=g, device=dev).to(dtype)
    n0 = gg.geglu_bwd.launches
    got = gg.geglu_bwd(hg, dy)
    if gg.geglu_bwd.launches != n0 + 1:
        raise AssertionError("geglu_bwd did not launch its kernel")
    want = gg.geglu_bwd_plain(hg, dy)
    torch.cuda.synchronize()
    rule = tol.GEGLU_F32 if fp32 else tol.GEGLU_BWD
    ratio = tol.worst_ratio(got, want, **rule)
    rec = {"kernel": "geglu_bwd", "route": "cuda", "dtype": str(dtype),
           "shape": {"tokens": tokens, "inner": inner},
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "worst_ratio": ratio, "tol": rule}
    if timed:
        rec["bound_ms"], rec["bound_by"] = bound(0.0, 5.0 * hg.element_size() * tokens * inner)
        rec["ms"] = time_ms(torch, lambda: gg.geglu_bwd(hg, dy), 20)
        rec["plain_ms"] = time_ms(torch, lambda: gg.geglu_bwd_plain(hg, dy), 3)

        def library():
            h, gate = hg.chunk(2, dim=-1)
            return torch.cat([dy * F.gelu(gate), torch.ops.aten.gelu_backward(dy * h, gate)], -1)

        rec["library_ms"] = time_ms(torch, library, 20)
    log(rec)
    if not ratio <= 1.0:
        raise AssertionError(f"geglu_bwd disagrees with its plain version: {rec}")
    return rec


def check_geglu(torch, F, gg, tol, dev, tokens, c, timed=True, inner=None, fp32=False):
    """``fp32``: fp32 operands, the 3xTF32 kernel, held under
    ``tol.GEGLU_F32`` to the plain version evaluated in float64 (the exact
    function); the record keeps beside that ratio the kernel's against the
    fp32 plain version and the fp32 plain version's (cuBLAS, TF32 off)
    against float64. The bound is three products at the TF32 rate;
    ``bound_fma_ms`` is the fp32 FMA rate's, the earlier kernel's."""
    dtype, rule = (torch.float32, tol.GEGLU_F32) if fp32 else (torch.bfloat16, tol.GEGLU)
    inner = 4 * c if inner is None else inner
    g = torch.Generator(device=dev).manual_seed(tokens + c)
    x = torch.randn((tokens, c), generator=g, device=dev).to(dtype)
    w = (torch.randn((2 * inner, c), generator=g, device=dev) * c**-0.5).to(dtype)
    b = (torch.randn(2 * inner, generator=g, device=dev) * 0.1).to(dtype)
    routes = dict(gg.geglu.route_launches)
    got = gg.geglu(x, w, b)
    route = next(r for r, n in gg.geglu.route_launches.items() if n != routes[r])
    plain = gg.geglu_plain(x, w, b)
    want = gg.geglu_plain(x.double(), w.double(), b.double()) if fp32 else plain
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs().max().item()
    ratio = tol.worst_ratio(got, want, **rule)
    rec = {"kernel": "geglu", "route": route, "dtype": str(dtype),
           "shape": {"tokens": tokens, "C": c, "inner": inner},
           "max_abs_err": err, "rms_want": want.double().square().mean().sqrt().item(),
           "worst_ratio": ratio, "tol": rule}
    if fp32:
        rec["want"] = "geglu_plain in float64"
        rec["worst_ratio_vs_fp32_plain"] = tol.worst_ratio(got, plain, **rule)
        rec["fp32_plain_worst_ratio_vs_f64"] = tol.worst_ratio(plain, want, **rule)
    del want, plain
    if timed:
        flops = 4.0 * tokens * c * inner
        nbytes = (4.0 if fp32 else 2.0) * (tokens * c + 2 * inner * c + 2 * inner + tokens * inner)
        if fp32:
            rec["bound_ms"], rec["bound_by"] = bound(3 * flops, nbytes, PEAK_TF32)
            rec["bound_fma_ms"], _ = bound(flops, nbytes, PEAK_FP32)
        else:
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, PEAK_BF16)
        rec["ms"] = time_ms(torch, lambda: gg.geglu(x, w, b), 5 if fp32 else 20)
        rec["plain_ms"] = time_ms(torch, lambda: gg.geglu_plain(x, w, b), 3)
        rec["library_ms"] = time_ms(torch, lambda: F.linear(x, w, b), 20)

        def unfused():  # the whole function in PyTorch calls, in the operands' type
            hh, gate = F.linear(x, w, b).chunk(2, dim=-1)
            return hh * F.gelu(gate)

        rec["unfused_ms"] = time_ms(torch, unfused, 20)
        rec["host_us"] = host_us(torch, lambda: gg.geglu(x, w, b), 50)
    log(rec)
    if not ratio <= 1.0:
        raise AssertionError(f"geglu disagrees with its plain version: {rec}")
    return rec


TINY_LATENT = (2, 8, 96, 4)   # t, lh, lw, c: 128 tokens per view, the flash route


def tiny_pair(torch, dev, config: str = "TINY_CPU"):
    """A tiny engine (``configs.<config>``) on the CPU (fp32) and on the card
    (bf16), same weights."""
    from panacea_tpu_torch import configs
    from panacea_tpu_torch.registry import instantiate_from_config

    cfg = getattr(configs, config)["model"]
    cpu = instantiate_from_config(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    card = instantiate_from_config(cfg, device=dev)
    card.load_state_dict(cpu.state_dict(), strict=True)
    return cpu, card


def tiny_card_vs_cpu(torch, np, cpu, card, steps: int, sampler_noise=None,
                     latent=TINY_LATENT) -> float:
    """Both engines sample from the same conditioning and injected noise;
    the card's largest difference from the CPU over the CPU's largest value."""
    t, lh, lw, ch = latent
    ih, iw = 8 * lh, 8 * lw
    rng = np.random.default_rng(SEED)
    cond = {"crossattn": rng.standard_normal((1, 77, 64)),
            "concat": rng.standard_normal((t, lh, lw, ch)) * 0.5,
            "cond_feat": rng.uniform(0, 1, (t, ih, iw, 19))}
    uc = dict(cond, crossattn=np.zeros((1, 77, 64)))
    noise = rng.standard_normal((t, lh, lw, ch))
    out = []
    for eng in (cpu, card):
        def tens(c):
            return {k: torch.as_tensor(v, dtype=torch.float32, device=eng.device)
                    for k, v in c.items()}
        z = eng.sample(tens(cond), uc=tens(uc), batch_size=t, shape=(lh, lw, ch),
                       noise=torch.as_tensor(noise, dtype=torch.float32), num_steps=steps,
                       sampler_noise=sampler_noise)
        out.append(z.float().cpu())
    ref, got = out
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return ((got - ref).abs().max() / ref.abs().max()).item()


def small_input_agreement(torch, np, dev):
    """Tiny engine: card (bf16, CUDA kernels) vs CPU (fp32, plain versions)."""
    rel = tiny_card_vs_cpu(torch, np, *tiny_pair(torch, dev), steps=2)
    t, lh, lw, _ = TINY_LATENT
    rec = {"phase": "small_input", "config": "TINY_CPU", "latent": [t, lh, lw, 4],
           "steps": 2, "max_rel_err": rel, "tol": SMALL_TOL, "finite": rel != float("inf")}
    log(rec)
    if not (rec["finite"] and rel <= SMALL_TOL):
        raise AssertionError(f"tiny engine on the card disagrees with the CPU: {rec}")


def reset_counts(fa, gg) -> None:
    fa.flash_attention.shape_launches.clear()
    fa.flash_attention.launches = gg.geglu.launches = 0
    fa.flash_attention_bwd.launches = gg.geglu_bwd.launches = 0
    for counts in (fa.flash_attention.route_launches, fa.flash_attention_bwd.route_launches,
                   gg.geglu.route_launches, fa.flash_attention.fp32_kernel_launches,
                   fa.flash_attention_bwd.fp32_kernel_launches,
                   fa.flash_attention.bf16_head_dim_launches,
                   fa.flash_attention_bwd.bf16_head_dim_launches):
        counts.update(dict.fromkeys(counts, 0))


def read_counts(fa, gg) -> dict:
    return {"flash_attention": fa.flash_attention.launches, "geglu": gg.geglu.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "geglu_bwd": gg.geglu_bwd.launches,
            "flash_routes": dict(fa.flash_attention.route_launches),
            "flash_fp32_kernels": dict(fa.flash_attention.fp32_kernel_launches),
            "flash_bwd_routes": dict(fa.flash_attention_bwd.route_launches),
            "flash_bwd_fp32_kernels": dict(fa.flash_attention_bwd.fp32_kernel_launches),
            "flash_bf16_head_dims": dict(fa.flash_attention.bf16_head_dim_launches),
            "flash_bwd_bf16_head_dims": dict(fa.flash_attention_bwd.bf16_head_dim_launches),
            "geglu_routes": dict(gg.geglu.route_launches)}


def free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main_path(torch, np, dev, fa, gg, steps: int, card: str):
    """``log_images`` called directly on random arrays (no dataset, no
    writers): s/step, the launch counts and one profiled step."""
    from panacea_tpu_torch.configs import INFERENCE_NUSCENES
    from panacea_tpu_torch.registry import instantiate_from_config

    t0 = time.perf_counter()
    eng = instantiate_from_config(INFERENCE_NUSCENES["model"], device=dev)
    eng.init_weights(torch.Generator(device=dev).manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in eng.parameters())
    rng = np.random.default_rng(SEED)
    t, ih, iw = eng.num_frames, 256, 3072
    jpg = rng.uniform(-1, 1, (1, t, ih, iw, 3)).astype(np.float32)
    fcz = np.zeros_like(jpg)
    fcz[:, -1] = jpg[:, -1]   # use_last_frame conditioning
    batch = {"jpg": jpg, "cond_img": rng.uniform(0, 1, (1, t, ih, iw, 19)).astype(np.float32),
             "final_cond_zero": fcz, "txt": ["a driving scene. daytime. sunny."]}

    step_s = []
    last_call = []
    network_fn = eng.network_fn

    def timed_network(*a, **kw):
        s = time.perf_counter()
        out = network_fn(*a, **kw)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s)
        last_call[:] = [a, kw]
        return out

    eng.network_fn = timed_network

    # what log_images does outside the steps, each call between two synchronisations
    outside = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            entry = outside.setdefault(name, {"seconds": 0.0, "calls": 0})
            entry["seconds"] += time.perf_counter() - s
            entry["calls"] += 1
            return out
        return wrapper

    eng.encode_first_stage = timed("vae_encode_8_frames", eng.encode_first_stage)
    eng.decode_first_stage = timed("vae_decode_8_frames", eng.decode_first_stage)
    net = eng.model.diffusion_model
    net.encode_hint = timed("controlnet_hint_stack", net.encode_hint)
    for emb in eng.conditioner.embedders:
        if getattr(emb, "encode_fn", None) is not None:
            emb.encode_fn = eng.encode_first_stage
        elif hasattr(emb, "tokenizer"):
            emb.forward = timed("text_tower", emb.forward)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, gg)
    t0 = time.perf_counter()
    logd = eng.log_images(batch, N=1, generator=torch.Generator(device=dev).manual_seed(SEED),
                          num_steps=steps)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts(fa, gg)
    launches = {k: counts[k] for k in ("flash_attention", "geglu")}

    shapes = {"inputs": (t, ih, iw, 3), "reconstructions": (t, ih, iw, 3),
              "samples": (t, ih, iw, 3), "control": (t, ih, iw, 19)}
    finite = {k: bool(torch.isfinite(logd[k]).all()) for k in shapes}
    ok_shape = {k: tuple(logd[k].shape) == s for k, s in shapes.items()}
    steady = sorted(step_s[1:] or step_s)[len(step_s[1:] or step_s) // 2]
    rec = {"phase": "log_images", "card": card, "params": n_params,
           "dtype": str(eng.dtype), "steps": steps, "setup_s": setup_s,
           "log_images_s": total_s, "step_s": step_s, "s_per_step": steady,
           "s_per_clip_25_steps": total_s - sum(step_s) + 25 * steady,
           "outside_steps_s": total_s - sum(step_s), "outside_steps": outside,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "flash_routes": dict(fa.flash_attention.route_launches),
           "expected": {"flash_attention": FLASH_PER_EVAL * steps, "geglu": GEGLU_PER_EVAL * steps},
           "finite": finite, "shapes_ok": ok_shape,
           "sample_abs_mean": logd["samples"].abs().mean().item()}
    log(rec)
    if not (all(finite.values()) and all(ok_shape.values())):
        raise AssertionError(f"main path output is wrong: {rec}")
    if launches != rec["expected"]:
        raise AssertionError(f"kernel launches {launches} != expected {rec['expected']}")
    if rec["flash_routes"]["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"the main path (head dim 64) left the wgmma route: {rec}")
    profile_step(torch, lambda: network_fn(*last_call[0], **last_call[1]))
    return counts, steady


def tree_of(root: str):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def image_info(path: str):
    """(width, height, frames, pixel standard deviation of the first frame)."""
    import numpy as np
    from PIL import Image

    with Image.open(path) as im:
        frames = getattr(im, "n_frames", 1)
        first = np.asarray(im.convert("RGB"), dtype=np.float32)
        return im.size[0], im.size[1], frames, float(first.std())


def clip_files(t: int = 8) -> list:
    """The files the inference CLI writes for the synthetic set's first clip
    of ``t`` frames, sorted as ``tree_of`` lists them."""
    from panacea_tpu_torch.data.nuscenes.dataset import PANORAMA_VIEWS

    stem = f"synth__CAM_FRONT__{t - 1:012d}"
    want = [f"{key}/{stem}.{ext}" for key in ("control", "inputs", "samples")
            for ext in ("gif", "png")]
    want += [f"gen-nuscenes/{cam}_synth__{cam}__{t - 1:012d}/_{i:06d}.jpg"
             for cam in PANORAMA_VIEWS for i in range(t)]
    return sorted(want)


def cli_phase(torch, np, dev, fa, gg, card: str, keep_gen: str = None):
    """The inference CLI at full width, one synthetic clip, 25 steps; its
    Gen-nuScenes tree is copied to ``keep_gen`` when given."""
    from panacea_tpu_torch import inference

    copies = {"seconds": 0.0, "bytes": 0, "calls": 0}
    as_tensor = torch.as_tensor

    def timed_as_tensor(data, *a, **kw):
        # the host-to-card copies of the batch (numpy arrays of a megabyte and
        # more), each timed between two synchronisations
        if not isinstance(data, np.ndarray) or data.nbytes < 1 << 20:
            return as_tensor(data, *a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = as_tensor(data, *a, **kw)
        if out.is_cuda:
            torch.cuda.synchronize()
            copies["seconds"] += time.perf_counter() - t0
            copies["bytes"] += data.nbytes
            copies["calls"] += 1
        return out

    # the writers' three parts, timed on the host clock inside log_outputs
    from panacea_tpu_torch import writers

    parts = {"save_image_grid": 0.0, "save_gif": 0.0, "save_frames_gen_nuscenes": 0.0}
    real_writers = {name: getattr(writers, name) for name in parts}

    def timed_writer(name):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real_writers[name](*a, **kw)
            finally:
                parts[name] += time.perf_counter() - t0
        return wrapper

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, gg)
        torch.as_tensor = timed_as_tensor
        for name in parts:
            setattr(writers, name, timed_writer(name))
        t0 = time.perf_counter()
        try:
            out = inference.main(["--synthetic", "--num_batches", "1", "--outdir", tmp,
                                  "--name", "smoke", "--seed", str(CLI_SEED)])
        finally:
            torch.as_tensor = as_tensor
            for name, fn in real_writers.items():
                setattr(writers, name, fn)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts = read_counts(fa, gg)
        tree = tree_of(out["outdir"])
        want = clip_files()
        stem = want[0].split("/")[1].rsplit(".", 1)[0]
        sizes = {"jpg": image_info(os.path.join(out["outdir"], want[-1])),
                 "png": image_info(os.path.join(out["outdir"], "samples", stem + ".png")),
                 "gif": image_info(os.path.join(out["outdir"], "samples", stem + ".gif"))}
        jpg_ok = all(image_info(os.path.join(out["outdir"], rel))[:3] == (512, 256, 1)
                     for rel in want if rel.endswith(".jpg"))
        if keep_gen:
            shutil.copytree(os.path.join(out["outdir"], "gen-nuscenes"), keep_gen)
    tm = out["timer"].totals
    clip_wall = tm["dataset"] + tm["clip"] + tm["to_host"] + tm["write"]
    waited = tm["dataset"] + copies["seconds"] + tm["to_host"] + tm["write"]
    rec = {"phase": "cli", "card": card, "steps": MAIN_STEPS, "main_s": main_s,
           "clip": {"dataset_s": tm["dataset"], "copy_to_card_s": copies["seconds"],
                    "copy_to_card_gb": copies["bytes"] / 1e9, "copy_calls": copies["calls"],
                    "log_images_s": tm["clip"], "to_host_s": tm["to_host"],
                    "writers_s": tm["write"], "writers_split_s": parts, "wall_s": clip_wall,
                    # dataset, copies in both directions and writers: the card
                    # has no work then (the idle share inside the steps is the
                    # profiled step's)
                    "card_waited_for_host_share": waited / clip_wall},
           "outside_clip_s": main_s - clip_wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "files": len(tree), "sizes": sizes}
    log(rec)
    if tree != want:
        raise AssertionError(f"the CLI wrote {tree}, expected {want}")
    if not (jpg_ok and sizes["png"][:3] == (3072, 8 * 256, 1) and sizes["gif"][:3] == (3072, 256, 8)):
        raise AssertionError(f"the CLI's images have the wrong sizes: {sizes}")
    if not all(v[3] > 1.0 for v in sizes.values()):
        raise AssertionError(f"the CLI's sample images are blank: {sizes}")
    expected = {"flash_attention": FLASH_PER_EVAL * MAIN_STEPS, "geglu": GEGLU_PER_EVAL * MAIN_STEPS}
    if {k: counts[k] for k in expected} != expected:
        raise AssertionError(f"CLI kernel launches {counts} != expected {expected}")
    if counts["flash_routes"]["wgmma"] != expected["flash_attention"]:
        raise AssertionError(f"the CLI (head dim 64, bf16) left the wgmma route: {counts}")
    return counts


def rollout_phase(torch, np, dev, fa, gg, card: str):
    """``--rollout 2 --num_steps 4`` at full width through the CLI."""
    from panacea_tpu_torch import inference
    from panacea_tpu_torch.models.engine import DiffusionEngine3D

    calls = []
    log_images = DiffusionEngine3D.log_images

    def recording(self, batch, *a, **kw):
        out = log_images(self, batch, *a, **kw)
        calls.append({"fcz": np.array(batch["final_cond_zero"][0]),
                      "share_noise_frame": kw.get("share_noise_frame"),
                      "last": out["samples"][-1].float().cpu().numpy()})
        return out

    frames = ROLLOUT_WINDOWS * 8 - (ROLLOUT_WINDOWS - 1)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(fa, gg)
        DiffusionEngine3D.log_images = recording
        t0 = time.perf_counter()
        try:
            out = inference.main(["--synthetic", "--num_batches", "1", "--outdir", tmp,
                                  "--name", "smoke", "--seed", str(CLI_SEED),
                                  "--rollout", str(ROLLOUT_WINDOWS),
                                  "--num_steps", str(ROLLOUT_STEPS)])
        finally:
            DiffusionEngine3D.log_images = log_images
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts = read_counts(fa, gg)
        tree = tree_of(out["outdir"])
        stem = f"synth__CAM_FRONT__{2 * 8 - 2:012d}"     # the second window's last frame
        want = sorted([f"rollout/{stem}/frame_{i:04d}.jpg" for i in range(frames)]
                      + [f"rollout/{stem}/long.gif"])
        gif = image_info(os.path.join(out["outdir"], "rollout", stem, "long.gif"))
        jpg = image_info(os.path.join(out["outdir"], "rollout", stem, f"frame_{frames - 1:04d}.jpg"))
    tm = out["timer"].totals
    evals = ROLLOUT_WINDOWS * ROLLOUT_STEPS
    rec = {"phase": "rollout", "card": card, "windows": ROLLOUT_WINDOWS, "steps": ROLLOUT_STEPS,
           "frames": frames, "main_s": main_s, "rollout_s": tm["rollout"],
           "writers_s": tm["write"], "launches": counts, "gif": gif, "jpg": jpg,
           "share_noise_frame": [c["share_noise_frame"] for c in calls]}
    log(rec)
    if tree != want:
        raise AssertionError(f"the rollout wrote {tree}, expected {want}")
    if gif[:3] != (3072, 256, frames) or jpg[:3] != (3072, 256, 1) or not jpg[3] > 1.0:
        raise AssertionError(f"the rollout's images are wrong: {rec}")
    if len(calls) != ROLLOUT_WINDOWS or rec["share_noise_frame"] != [-1, 0]:
        raise AssertionError(f"the rollout's windows are wrong: {rec['share_noise_frame']}")
    second = calls[1]["fcz"]
    if not (np.array_equal(second[0], calls[0]["last"]) and not second[1:].any()):
        raise AssertionError("the second window is not conditioned on the first one's last frame")
    if (counts["flash_attention"], counts["geglu"]) != (FLASH_PER_EVAL * evals, GEGLU_PER_EVAL * evals):
        raise AssertionError(f"rollout kernel launches {counts}")
    return counts


def fp32_engine_phase(torch, np, dev, fa, gg, card: str):
    """The production engine in fp32 and in bf16, the same weights (drawn in
    bf16, so both hold the same numbers) and the same injected noise."""
    from panacea_tpu_torch.configs import INFERENCE_NUSCENES
    from panacea_tpu_torch.registry import instantiate_from_config

    t, lh, lw, ih, iw = 8, 32, 384, 256, 3072
    rng = np.random.default_rng(SEED)
    cond = {"crossattn": rng.standard_normal((1, 77, 1024)),
            "concat": rng.standard_normal((t, lh, lw, 4)) * 0.5,
            "cond_feat": rng.uniform(0, 1, (t, ih, iw, 19))}
    uc = dict(cond, crossattn=np.zeros((1, 77, 1024)))
    noise = torch.as_tensor(rng.standard_normal((t, lh, lw, 4)), dtype=torch.float32)

    def run(eng):
        def tens(c):
            return {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in c.items()}
        c, u = tens(cond), tens(uc)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, gg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, traj = eng.sample(c, uc=u, batch_size=t, shape=(lh, lw, 4), noise=noise,
                             num_steps=FP32_STEPS, return_trajectory=True)
        torch.cuda.synchronize()
        return (traj.float().cpu(), time.perf_counter() - t0, read_counts(fa, gg),
                torch.cuda.max_memory_allocated() / 1e9)

    eng16 = instantiate_from_config(INFERENCE_NUSCENES["model"], device=dev)
    eng16.init_weights(torch.Generator(device=dev).manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    traj16, s16, counts16, mem16 = run(eng16)
    eng32 = instantiate_from_config(INFERENCE_NUSCENES["model"], device=dev, dtype=torch.float32)
    eng32.load_state_dict(eng16.state_dict(), strict=True)
    del eng16
    free(torch)
    traj32, s32, counts32, mem32 = run(eng32)
    del eng32
    free(torch)

    drift = []
    for i in range(FP32_STEPS):
        d, ref = traj16[i] - traj32[i], traj32[i]
        drift.append({"step": i + 1, "max_rel": (d.abs().max() / ref.abs().max()).item(),
                      "rms_rel": (d.square().mean().sqrt() / ref.square().mean().sqrt()).item()})
    expected = {"flash": FLASH_PER_EVAL * FP32_STEPS, "geglu": GEGLU_PER_EVAL * FP32_STEPS}
    rec = {"phase": "fp32_engine", "card": card, "steps": FP32_STEPS, "drift_bf16_vs_fp32": drift,
           "fp32": {"sample_s": s32, "s_per_step": s32 / FP32_STEPS, "peak_mem_gb": mem32,
                    "launches": counts32},
           "bf16": {"sample_s": s16, "s_per_step": s16 / FP32_STEPS, "peak_mem_gb": mem16,
                    "launches": counts16},
           "finite": bool(torch.isfinite(traj32).all() and torch.isfinite(traj16).all())}
    log(rec)
    if not rec["finite"]:
        raise AssertionError(f"non-finite latents: {rec}")
    if (counts32["flash_routes"]["fp32"], counts32["flash_fp32_kernels"]["tc"],
            counts32["geglu_routes"]["fp32"]) != (expected["flash"], expected["flash"],
                                                  expected["geglu"]):
        raise AssertionError(f"the fp32 engine's launches {counts32} != {expected} on the fp32 routes")
    if counts32["flash_attention"] != expected["flash"] or counts32["geglu"] != expected["geglu"]:
        raise AssertionError(f"the fp32 engine launched a kernel of another type: {counts32}")
    if (counts16["flash_routes"]["wgmma"], counts16["geglu_routes"]["bf16"]) != (
            expected["flash"], expected["geglu"]):
        raise AssertionError(f"the bf16 engine's launches {counts16} != {expected}")
    return counts32


def synthetic_clip(np, rng, t: int, ih: int, iw: int, b: int = 1) -> dict:
    """A clip batch of random arrays: images, the BEV hint, the conditioning
    frame (the last one, use_last_frame) and a prompt."""
    jpg = rng.uniform(-1, 1, (b, t, ih, iw, 3)).astype(np.float32)
    fcz = np.zeros_like(jpg)
    fcz[:, -1] = jpg[:, -1]
    return {"jpg": jpg, "cond_img": rng.uniform(0, 1, (b, t, ih, iw, 19)).astype(np.float32),
            "final_cond_zero": fcz, "txt": ["a driving scene. daytime. sunny."] * b}


def train_setup(torch, np, dev) -> dict:
    """The production engine in bf16 at full width with random weights and
    its loss, a random clip (bs 1, 8 frames) and the clip's conditioning."""
    from panacea_tpu_torch.configs import INFERENCE_NUSCENES
    from panacea_tpu_torch.registry import instantiate_from_config
    from panacea_tpu_torch.train import default_loss_config

    eng = instantiate_from_config(INFERENCE_NUSCENES["model"], device=dev)
    eng.init_weights(torch.Generator(device=dev).manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    eng.loss_fn = instantiate_from_config(default_loss_config(eng))
    batch = synthetic_clip(np, np.random.default_rng(SEED), eng.num_frames, 256, 3072)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        cond = eng.conditioner(batch, dev, generator=torch.Generator(device=dev).manual_seed(SEED),
                               apply_ucg=True)
    torch.cuda.synchronize()
    return {"eng": eng, "batch": batch, "cond": cond, "cond_s": time.perf_counter() - t0}


def train_run(torch, np, dev, fa, gg, card: str, eng, batch, cond, freeze: str, steps: int,
              name: str):
    """``steps`` train steps of ``eng`` (lr TRAIN_LR, clip, EMA) from a
    fresh train state. The draws come from a generator seeded
    TRAIN_DRAW_SEED, so runs of the same clip see the same draws whatever
    the engine's type. Returns the state and the run's record."""
    from panacea_tpu_torch.train import GRAD_CLIP
    from panacea_tpu_torch.train_step import init_train_state, train_step
    from panacea_tpu_torch.utils.profiling import Timer

    eng.freeze_type = freeze
    state = init_train_state(eng, lr=TRAIN_LR, grad_clip=GRAD_CLIP, use_ema=True)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_DRAW_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = Timer(dev)
    losses, step_s, splits = [], [], []
    reset_counts(fa, gg)
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(train_step(eng, state, batch["jpg"], cond, gen, timer=timer)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        splits.append(dict(timer.last))
    counts = read_counts(fa, gg)
    later = sorted(range(1, steps), key=lambda i: step_s[i]) or [0]
    median = later[len(later) // 2]
    rec = {"phase": name, "card": card, "dtype": str(eng.dtype), "freeze_type": freeze,
           "steps": steps, "losses": losses,
           "trained_params": sum(p.numel() for p in state.params.values()),
           "step_s": step_s, "s_per_step": step_s[median],
           "split_s": splits[median], "split_first_step_s": splits[0],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts,
           "launches_per_step": {k: counts[k] / steps for k in TRAIN_LAUNCHES_PER_STEP},
           "flash_bwd_routes_per_step": {r: n / steps
                                         for r, n in counts["flash_bwd_routes"].items()}}
    return state, rec


def check_train_launches(rec, route: str) -> None:
    """A training step's launches: the totals of TRAIN_LAUNCHES_PER_STEP, and
    every flash backward on ``route`` (the forward kernels on the type's
    routes: wgmma and bf16, or fp32)."""
    fp32 = route == "fp32"
    per = rec["launches_per_step"]
    steps = rec["steps"]
    bwd = {r: (TRAIN_LAUNCHES_PER_STEP["flash_attention_bwd"] if r == route else 0.0)
           for r in rec["flash_bwd_routes_per_step"]}
    fwd_route = rec["launches"]["flash_routes"]["fp32" if fp32 else "wgmma"] / steps
    geglu_route = rec["launches"]["geglu_routes"]["fp32" if fp32 else "bf16"] / steps
    if not (per == TRAIN_LAUNCHES_PER_STEP and rec["flash_bwd_routes_per_step"] == bwd
            and fwd_route == per["flash_attention"] and geglu_route == per["geglu"]):
        raise AssertionError(f"{rec['phase']}: launches a step {per}, flash backward routes "
                             f"{rec['flash_bwd_routes_per_step']}, not {TRAIN_LAUNCHES_PER_STEP} "
                             f"with the backward on {route}: {rec['launches']}")


def train_phase(torch, np, dev, fa, gg, card: str, setup: dict):
    """The port's train step at full production width: 3 steps training
    every network parameter with the EMA, then 2 steps with freeze_type
    spatial (frozen parameters must stay bit-equal, a temporal one must
    move). bs 1, 8 frames, random weights and a random clip."""
    from panacea_tpu_torch.train_step import train_step

    eng, batch, cond = setup["eng"], setup["batch"], setup["cond"]
    network = {f"model.{n}": p for n, p in eng.model.named_parameters()}
    state, rec = train_run(torch, np, dev, fa, gg, card, eng, batch, cond, "none",
                           TRAIN_STEPS, "train_none")
    rec["conditioning_s"] = setup["cond_s"]
    log(rec)
    # one more step of the same state under the profiler (its warm-up is a step too)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_DRAW_SEED)
    profile_step(torch, lambda: train_step(eng, state, batch["jpg"], cond, gen),
                 name="profile_train_step", grad=True)
    if not all(np.isfinite(rec["losses"])):
        raise AssertionError(f"non-finite training loss: {rec}")
    check_train_launches(rec, "wgmma")
    counts = rec["launches"]
    del state
    free(torch)

    mask = {k: "temporal" in k for k in network}
    frozen_before = {k: p.detach().clone() for k, p in network.items() if not mask[k]}
    temporal_before = {k: p.detach().float().clone() for k, p in network.items() if mask[k]}
    state, rec2 = train_run(torch, np, dev, fa, gg, card, eng, batch, cond, "spatial",
                            SPATIAL_STEPS, "train_spatial")
    frozen_equal = all(torch.equal(network[k], v) for k, v in frozen_before.items())
    # the fp32 masters: an update below half a bf16 step leaves the network's copy as it was
    moved = sum(not torch.equal(state.params[k], v) for k, v in temporal_before.items())
    rec2.update({"frozen_params": len(frozen_before), "frozen_bit_equal": frozen_equal,
                 "temporal_params": len(temporal_before), "temporal_moved": moved})
    log(rec2)
    del state, frozen_before, temporal_before, network
    if not (all(np.isfinite(rec2["losses"])) and frozen_equal and moved > 0):
        raise AssertionError(f"spatial-freeze training is wrong: {rec2}")
    check_train_launches(rec2, "wgmma")
    free(torch)
    return counts


def loss_and_grads(torch, dev, eng, batch, cond):
    """One step's loss and the gradients of the temporal parameters
    (freeze_type spatial), with draws from a generator seeded
    TRAIN_DRAW_SEED: (loss, {name: fp32 gradient})."""
    eng.freeze_type = "spatial"
    trained = eng.set_trainable()
    eng.train()
    gen = torch.Generator(device=dev).manual_seed(TRAIN_DRAW_SEED)
    loss = eng.train_loss(batch["jpg"], cond, generator=gen)
    loss.backward()
    grads = {k: p.grad.float() for k, p in trained.items()}
    for p in trained.values():
        p.grad = None
    return loss.item(), grads


def train_fp32_phase(torch, np, dev, fa, gg, card: str, setup: dict):
    """The production engine in fp32, trained at full width with
    freeze_type spatial (bs 1 x 8 frames, the bf16 runs' clip, conditioning
    and draws): first the bf16-vs-fp32 drift of one step's loss and temporal
    gradients with the same weights and draws, then 2 fp32 steps, whose
    flash backward runs on the fp32 kernels (21 launches a step)."""
    from panacea_tpu_torch.configs import INFERENCE_NUSCENES
    from panacea_tpu_torch.registry import instantiate_from_config
    from panacea_tpu_torch.train import default_loss_config

    eng16, batch, cond = setup.pop("eng"), setup["batch"], setup["cond"]
    eng32 = instantiate_from_config(INFERENCE_NUSCENES["model"], device=dev, dtype=torch.float32)
    eng32.load_state_dict(eng16.state_dict(), strict=True)
    eng32.loss_fn = instantiate_from_config(default_loss_config(eng32))

    loss16, g16 = loss_and_grads(torch, dev, eng16, batch, cond)
    del eng16
    free(torch)
    loss32, g32 = loss_and_grads(torch, dev, eng32, batch, cond)
    norms = {k: g.norm().item() for k, g in g32.items()}
    diffs = {k: (g16[k] - g).norm().item() for k, g in g32.items()}
    del g16, g32
    free(torch)
    live = sorted((diffs[k] / norms[k], k) for k in norms if norms[k] > 0)
    total = (sum(d * d for d in diffs.values()) / sum(n * n for n in norms.values())) ** 0.5
    drift = {"phase": "train_drift_bf16_vs_fp32", "card": card, "freeze_type": "spatial",
             "loss_bf16": loss16, "loss_fp32": loss32,
             "loss_rel": abs(loss16 - loss32) / abs(loss32),
             "grad_rel_all": total, "tensors": len(norms),
             "tensors_zero_in_fp32": len(norms) - len(live),
             "grad_rel_per_tensor": {
                 "median": live[len(live) // 2][0], "p90": live[int(0.9 * (len(live) - 1))][0],
                 "max": live[-1][0], "min": live[0][0]},
             "worst5": [[k, r] for r, k in live[-5:]],
             "zero_in_fp32_bf16_norm_max": max(
                 (diffs[k] for k in norms if norms[k] == 0), default=0.0)}
    log(drift)

    state, rec = train_run(torch, np, dev, fa, gg, card, eng32, batch, cond, "spatial",
                           SPATIAL_STEPS, "train_fp32")
    rec["drift"] = {k: drift[k] for k in ("loss_rel", "grad_rel_all", "grad_rel_per_tensor")}
    log(rec)
    del state, eng32
    free(torch)
    if not (all(np.isfinite(rec["losses"])) and np.isfinite(total) and np.isfinite(loss32)):
        raise AssertionError(f"fp32 training is not finite: {rec}")
    check_train_launches(rec, "fp32")
    return rec["launches"]


def train_tiny_card_vs_cpu(torch, np, dev):
    """One training step's loss and gradients of the tiny engine: bf16 on
    the card (kernels, their backward included) against fp32 on the CPU
    (plain versions), the same weights (drawn in bf16) and the same draws.
    The tiny config's temporal GroupNorms take their statistics over 2
    values (2 frames x 1 channel a group), so its bf16 gradients are far
    from fp32 whatever computes them; the card's are therefore held to the
    distance of a bf16 run on the CPU (plain versions, no kernel) from fp32,
    and the loss to fp32 directly."""
    from panacea_tpu_torch.configs import TINY_CPU
    from panacea_tpu_torch.registry import instantiate_from_config

    t, lh, lw, ih, iw = 2, 8, 96, 64, 768   # 128 tokens per view: the flash route
    cpu = instantiate_from_config(TINY_CPU["model"], device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(p.bfloat16().float())
    card = instantiate_from_config(TINY_CPU["model"], device=dev)
    card.load_state_dict(cpu.state_dict(), strict=True)
    cpu16 = instantiate_from_config(TINY_CPU["model"], device="cpu", dtype=torch.bfloat16)
    cpu16.load_state_dict(cpu.state_dict(), strict=True)
    rng = np.random.default_rng(SEED)
    cond = {"crossattn": rng.standard_normal((1, 77, 64)),
            "concat": rng.standard_normal((t, lh, lw, 4)) * 0.5,
            "cond_feat": rng.uniform(0, 1, (t, ih, iw, 19))}
    jpg = rng.uniform(-1, 1, (1, t, ih, iw, 3))
    draws = {"posterior_noise": rng.standard_normal((t, lh, lw, 4)),
             "sigma_rand": rng.integers(0, 1000, t), "noise": rng.standard_normal((t, lh, lw, 4))}
    out = []
    for eng in (cpu, cpu16, card):
        eng.loss_fn = instantiate_from_config(TINY_CPU["loss_fn_config"])
        trained = eng.set_trainable()
        c = {k: torch.as_tensor(v, dtype=torch.float32, device=eng.device) for k, v in cond.items()}
        inject = {k: torch.as_tensor(v, device=eng.device) for k, v in draws.items()}
        inject["sigma_rand"] = inject["sigma_rand"].long()
        loss = eng.train_loss(jpg, c, **inject)
        loss.backward()
        out.append((loss.item(), {k: p.grad.float().cpu() for k, p in trained.items()}))
    (loss_cpu, g_cpu), (loss_cpu16, g_cpu16), (loss_card, g_card) = out
    norms = {k: g.norm().item() for k, g in g_cpu.items()}
    top = max(norms.values())

    def errors(g_other):
        per = {k: (g_other[k] - g).norm().item() for k, g in g_cpu.items()}
        total = (sum(e * e for e in per.values()) / sum(n * n for n in norms.values())) ** 0.5
        ranked = sorted(per[k] / max(norms[k], 1e-30) for k in per)
        return per, total, ranked

    per_card, total_card, ranked_card = errors(g_card)
    per_16, total_16, ranked_16 = errors(g_cpu16)
    bad = [k for k in per_card if per_card[k] > TINY_GRAD_FACTOR * per_16[k]
           + SMALL_TOL * norms[k] + 1e-3 * top]
    rec = {"phase": "train_tiny_card_vs_cpu", "config": "TINY_CPU", "latent": [t, lh, lw, 4],
           "loss_cpu_fp32": loss_cpu, "loss_cpu_bf16": loss_cpu16, "loss_card": loss_card,
           "loss_rel_err": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "grad_rel_err_all": {"card_vs_fp32": total_card, "cpu_bf16_vs_fp32": total_16},
           "grad_rel_err_median": {"card_vs_fp32": ranked_card[len(ranked_card) // 2],
                                   "cpu_bf16_vs_fp32": ranked_16[len(ranked_16) // 2]},
           "grad_rel_err_card_vs_cpu_bf16_all": (
               sum((g_card[k] - g).square().sum() for k, g in g_cpu16.items())
               / sum(g.square().sum() for g in g_cpu.values())).sqrt().item(),
           "tensors": len(norms), "tensors_over_tol": bad[:10],
           "tol": {"loss": SMALL_TOL, "factor": TINY_GRAD_FACTOR, "floor": SMALL_TOL}}
    log(rec)
    if not (rec["loss_rel_err"] <= SMALL_TOL and not bad
            and total_card <= TINY_GRAD_FACTOR * total_16 + SMALL_TOL):
        raise AssertionError(f"tiny training step on the card disagrees with the CPU: {rec}")


def train_cli_phase(torch, np, dev, fa, gg, card: str):
    """``train_torch.py --tiny --synthetic --steps 4 --ckpt_every 2
    --use_ema`` on the card, the same run resumed from iter_2, and the final
    engine checkpoint loaded (strict) into the inference CLI, 2 steps."""
    import shutil

    from panacea_tpu_torch import inference, train

    common = ["--tiny", "--synthetic", "--steps", "4", "--ckpt_every", "2", "--use_ema",
              "--log_every", "1"]
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(fa, gg)
        t0 = time.perf_counter()
        full = train.main(common + ["--ckpt_dir", os.path.join(tmp, "a")])
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        counts = read_counts(fa, gg)
        os.makedirs(os.path.join(tmp, "b"))
        shutil.copytree(os.path.join(tmp, "a", "iter_2"), os.path.join(tmp, "b", "iter_2"))
        resumed = train.main(common + ["--ckpt_dir", os.path.join(tmp, "b"),
                                       "--resume", os.path.join(tmp, "b", "iter_2")])
        diffs = {k: (v - resumed["state"].params[k]).abs().max().item()
                 for k, v in full["state"].params.items()}
        ema_diff = max((v - resumed["state"].ema.shadows[k]).abs().max().item()
                       for k, v in full["state"].ema.shadows.items())
        files = sorted(os.listdir(os.path.join(tmp, "a")))
        out = inference.main(["--synthetic", "--tiny", "--num_batches", "1", "--num_steps", "2",
                              "--outdir", os.path.join(tmp, "inf"), "--ckpt",
                              full["engine_ckpt"], "--prefer_ema"])
        samples = sorted(os.listdir(os.path.join(out["outdir"], "samples")))
    worst = max(diffs.values())
    rec = {"phase": "train_cli", "card": card, "steps": 4, "full_run_s": full_s,
           "losses": full["losses"], "resumed_losses": resumed["losses"],
           "bit_equal": worst == 0.0 and ema_diff == 0.0, "max_param_diff": worst,
           "max_ema_diff": ema_diff, "tol": RESUME_TOL, "files": files,
           "inference_done": out["done"], "inference_samples": samples,
           "launches_full_run": counts}
    log(rec)
    if not (worst <= RESUME_TOL and ema_diff <= RESUME_TOL and np.isfinite(full["losses"]).all()):
        raise AssertionError(f"the resumed run does not continue the uninterrupted one: {rec}")
    if files != ["engine_final.ckpt", "final.pt", "final_ema.pt", "iter_2", "iter_4"]:
        raise AssertionError(f"the trainer wrote {files}")
    if out["done"] != 1 or not samples:
        raise AssertionError(f"inference from the trained checkpoint failed: {rec}")
    if counts["geglu"] == 0 or counts["geglu_bwd"] == 0:
        raise AssertionError(f"the tiny trainer did not reach the GEGLU kernels: {counts}")


def perception_window(torch, np, dev, t: int, seed: int = SEED):
    """A window of the eval recipe: t frames of random 256 x 512 images
    (uniform in [0, 255], normalised) of the synthetic scene's 6 cameras,
    with its calibration and poses, as tensors on ``dev``."""
    from panacea_tpu_torch.data.nuscenes.synthetic import make_synthetic_infos
    from panacea_tpu_torch.perception.eval_dataset import GenNuScenesEvalDataset

    rng = np.random.default_rng(seed)
    infos = make_synthetic_infos(num_frames=t, num_boxes=6, seed=seed)
    ds = GenNuScenesEvalDataset(infos=infos, queue_length=t, final_dim=PERCEPTION_HW,
                                image_loader=lambda path: rng.uniform(
                                    0, 255, PERCEPTION_HW + (3,)).astype(np.float32))
    window = {k: torch.as_tensor(v, device=dev) for k, v in ds.sliding_window(t - 1).items()}
    return window.pop("imgs"), window


def perception_phase(torch, np, dev, fa, gg, card: str):
    """(a) ``StreamPETRWindow`` at the eval recipe's full width on one window
    of PERCEPTION_T frames: s/window with its split, peak memory, the fp32
    flash launches; the same weights on the first two frames on the card
    and on the CPU. Returns the window's launch counts."""
    from panacea_tpu_torch.perception.detector import StreamPETRWindow
    from panacea_tpu_torch.perception.head import init_memory

    model = StreamPETRWindow().to(dev).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    imgs, data = perception_window(torch, np, dev, PERCEPTION_T)
    split = {"backbone_fpn_s": 0.0, "head_s": 0.0}
    model.extract_feats = split_timer(torch, split, "backbone_fpn_s", model.extract_feats)
    model.pts_bbox_head.forward = split_timer(torch, split, "head_s",
                                              model.pts_bbox_head.forward)
    with torch.inference_mode():
        t0 = time.perf_counter()
        model(imgs, data)    # first use: cuDNN's choice of algorithms, the kernel's load
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        split.update(dict.fromkeys(split, 0.0))
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, gg)
        t0 = time.perf_counter()
        outs, memory = model(imgs, data)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        counts = read_counts(fa, gg)
    peak = torch.cuda.max_memory_allocated() / 1e9
    window_split = dict(split)   # the timed window's; the comparison below adds to split
    q = 644 + 256
    shapes_ok = (tuple(outs["all_cls_scores"].shape) == (6, 1, q, 10)
                 and tuple(outs["all_bbox_preds"].shape) == (6, 1, q, 10)
                 and tuple(memory.embedding.shape) == (1, 1024, 256))
    finite = all(bool(torch.isfinite(v).all()) for v in outs.values())

    # the first two frames on the card and on the CPU, frame by frame; the
    # second frame starts on both from the card's memory, since the top-256
    # selection orders near-equal scores by rounding noise
    cpu = StreamPETRWindow().eval()
    cpu.load_state_dict(model.state_dict())
    worst = {}
    mem_card = init_memory(1, 1024, 256, device=dev)
    mem_cpu = init_memory(1, 1024, 256)
    slots_agree = []
    with torch.inference_mode():
        for fi in range(2):
            frame = {k: v[:, fi] for k, v in data.items()}
            got, mem_card_next = model.forward_frame(imgs[:, fi], mem_card, frame)
            want, mem_cpu = cpu.forward_frame(imgs[:, fi].cpu(), mem_cpu,
                                              {k: v.cpu() for k, v in frame.items()})
            for key in ("all_cls_scores", "all_bbox_preds"):
                err = (got[key].cpu() - want[key]).abs().max().item()
                worst[f"{key}_frame{fi}"] = err / want[key].abs().max().item()
            # the same slots in the same order, or reference points metres apart
            slots_agree.append((mem_card_next.reference_point.cpu()
                                - mem_cpu.reference_point).abs().max().item() < 1e-2)
            mem_card = mem_card_next
            mem_cpu = type(mem_card)(*(m.cpu() for m in mem_card))
    flash32 = counts["flash_routes"]["fp32"]
    rec = {"phase": "perception", "card": card, "frames": PERCEPTION_T,
           "image_hw": list(PERCEPTION_HW), "cams": 6, "queries": q, "memory": 1024,
           "params": sum(p.numel() for p in model.parameters()),
           "first_window_s": first_s, "s_per_window": window_s,
           "split_s": window_split, "peak_mem_gb": peak, "launches": counts,
           "expected_fp32_flash": 6 * PERCEPTION_T, "finite": finite, "shapes_ok": shapes_ok,
           "card_vs_cpu_t2": worst, "tol": PERCEPTION_TOL,
           "memory_slots_agree_card_cpu": slots_agree}
    log(rec)
    if not (finite and shapes_ok):
        raise AssertionError(f"the detector's output is wrong: {rec}")
    if (flash32 != 6 * PERCEPTION_T or counts["flash_attention"] != flash32
            or counts["flash_fp32_kernels"]["tc32"] != flash32):
        raise AssertionError(f"a window launched {counts['flash_routes']} flash kernels "
                             f"({counts['flash_fp32_kernels']}), not {6 * PERCEPTION_T} on the "
                             f"fp32 route's head-dim-32 tensor-core kernel: {rec}")
    if not max(worst.values()) <= PERCEPTION_TOL:
        raise AssertionError(f"the detector on the card disagrees with the CPU: {rec}")
    del model.extract_feats, model.pts_bbox_head.forward   # the timers off
    profile_step(torch, lambda: model(imgs, data), name="profile_perception_window")
    return counts


def perception_cli_phase(torch, np, dev, fa, gg, card: str):
    """(b) ``perception.eval.main --synthetic`` at full width, every window;
    (c) the round trip on the card: the tiny generation CLI, then the tiny
    eval CLI reading its Gen-nuScenes tree. Returns (b)'s launch counts."""
    from panacea_tpu_torch import inference
    from panacea_tpu_torch.perception import eval as peval

    reset_counts(fa, gg)
    t0 = time.perf_counter()
    metrics = peval.main(["--synthetic"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = read_counts(fa, gg)
    windows = counts["flash_routes"]["fp32"] // (6 * 4)
    rec = {"phase": "perception_cli", "card": card, "seconds": cli_s, "windows": windows,
           "frames_per_window": 4, "launches": counts, "metrics": metrics}
    log(rec)
    if not (all(np.isfinite(v) for v in metrics.values()) and windows == 5
            and counts["flash_attention"] == counts["flash_routes"]["fp32"]
            == counts["flash_fp32_kernels"]["tc32"]):
        raise AssertionError(f"the synthetic eval went wrong: {rec}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        gen = inference.main(["--synthetic", "--tiny", "--num_batches", "1", "--outdir", tmp,
                              "--name", "e2e", "--seed", "0"])
        rt = peval.main(["--synthetic", "--tiny", "--gen_root",
                         os.path.join(tmp, "e2e", "val", "gen-nuscenes"), "--gen_clip_len", "2",
                         "--queue_length", "2", "--final_dim", "16", "32", "--num_levels", "3",
                         "--num_samples", "1"])
        rt_s = time.perf_counter() - t0
    rec = {"phase": "perception_round_trip", "card": card, "seconds": rt_s,
           "clips_generated": gen["done"], "gen_frames_loaded": rt["gen_frames_loaded"],
           "gen_frames_missing": rt["gen_frames_missing"], "NDS": rt["NDS"], "mAP": rt["mAP"]}
    log(rec)
    if not (rt["gen_frames_missing"] == 0 and rt["gen_frames_loaded"] > 0
            and np.isfinite(rt["NDS"])):
        raise AssertionError(f"the generation -> eval round trip lost frames: {rec}")
    return counts


def median_after_first(torch, fn, calls: int):
    """(median seconds of the calls after the first, the first's), each call
    between two synchronisations."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steady = sorted(times[1:])
    return steady[len(steady) // 2], times[0]


def metric_towers_phase(torch, np, dev, card: str):
    """(a) InceptionV3 and I3D at the FID CLI's full width, fp32, random
    weights from a seed: frames/s and clips/s, peak memory, card against CPU."""
    from panacea_tpu_torch.metrics_gen import eval as geval

    inception, i3d = geval.build_towers(dev, seed=SEED)
    rng = np.random.default_rng(SEED)
    inputs = {"inception": rng.uniform(-1, 1, (TOWER_FRAMES, 3) + TOWER_HW["inception"]),
              "i3d": rng.uniform(-1, 1, (TOWER_CLIPS, 3, 8) + TOWER_HW["i3d"])}
    rec = {"phase": "metric_towers", "card": card, "tol": TOWER_TOL, "dtype": "torch.float32"}
    for name, model in (("inception", inception), ("i3d", i3d)):
        x = torch.as_tensor(inputs[name], dtype=torch.float32, device=dev)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            s, first = median_after_first(torch, lambda: model(x), TOWER_CALLS)
            got = model(x).cpu()
            cpu = type(model)().eval()
            cpu.load_state_dict(model.state_dict())
            want = cpu(x.cpu())
        per = TOWER_FRAMES if name == "inception" else TOWER_CLIPS
        rec[name] = {"input": list(x.shape), "s_per_batch": s, "first_call_s": first,
                     ("frames_per_s" if name == "inception" else "clips_per_s"): per / s,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "out": list(got.shape), "finite": bool(torch.isfinite(got).all()),
                     "card_vs_cpu": ((got - want).abs().max() / want.abs().max()).item()}
    log(rec)
    for name in ("inception", "i3d"):
        r = rec[name]
        if not (r["finite"] and r["card_vs_cpu"] <= TOWER_TOL):
            raise AssertionError(f"the {name} tower on the card disagrees with the CPU: {rec}")
    if rec["inception"]["out"] != [TOWER_FRAMES, 2048] or rec["i3d"]["out"] != [TOWER_CLIPS, 1024]:
        raise AssertionError(f"the towers' features have the wrong shapes: {rec}")


def write_gen_tree(dst: str) -> None:
    """One clip through the generation CLI at full width (2 steps), its
    Gen-nuScenes tree copied to ``dst``: the --metrics mode's input."""
    from panacea_tpu_torch import inference

    with tempfile.TemporaryDirectory() as tmp:
        out = inference.main(["--synthetic", "--num_batches", "1", "--outdir", tmp,
                              "--name", "metrics", "--seed", str(CLI_SEED), "--num_steps", "2"])
        shutil.copytree(os.path.join(out["outdir"], "gen-nuscenes"), dst)


def shifted_copy(np, src: str, dst: str) -> None:
    """Every frame of ``src`` with its pixels raised by GEN_SHIFT (clipped)."""
    from PIL import Image

    for rel in tree_of(src):
        os.makedirs(os.path.join(dst, os.path.dirname(rel)), exist_ok=True)
        with Image.open(os.path.join(src, rel)) as im:
            px = np.asarray(im.convert("RGB"), dtype=np.int16) + GEN_SHIFT
        Image.fromarray(px.clip(0, 255).astype(np.uint8)).save(os.path.join(dst, rel))


@contextlib.contextmanager
def timed_metrics_cli(torch):
    """The FID CLI's parts timed while it runs: the towers' construction, the
    image loading (JPEG decode and resize on the host), the towers' calls
    (between two synchronisations) and the Frechet distances (host)."""
    from panacea_tpu_torch.metrics_gen import eval as geval
    from panacea_tpu_torch.metrics_gen import fid

    split = dict.fromkeys(("build_towers", "load_image", "towers", "frechet_distance"), 0.0)
    real = {"build_towers": geval.build_towers, "load_image": geval.load_image,
            "frechet_distance": fid.frechet_distance}

    def timer(name, fn, sync=False):
        def wrapper(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                split[name] += time.perf_counter() - t0
        return wrapper

    def build_towers(*a, **kw):
        towers = timer("build_towers", real["build_towers"], sync=True)(*a, **kw)
        for m in towers:
            m.forward = timer("towers", m.forward, sync=True)
        return towers

    geval.build_towers, geval.load_image = build_towers, timer("load_image", geval.load_image)
    fid.frechet_distance = timer("frechet_distance", fid.frechet_distance)
    try:
        yield split
    finally:
        geval.build_towers, geval.load_image = real["build_towers"], real["load_image"]
        fid.frechet_distance = real["frechet_distance"]


def metrics_cli_phase(torch, np, dev, card: str, gen_tree: str):
    """(b) the FID CLI's ``--synthetic`` in process; (c) the CLI on the
    Gen-nuScenes tree of a full-width generation run: against itself, and
    against a copy with its pixels shifted."""
    from panacea_tpu_torch.metrics_gen import eval as geval

    t0 = time.perf_counter()
    synth = geval.main(["--synthetic"])
    rec = {"phase": "metrics_cli_synthetic", "card": card, "seconds": time.perf_counter() - t0,
           "result": synth}
    log(rec)
    if not (np.isfinite(synth["fid"]) and np.isfinite(synth["fvd"])):
        raise AssertionError(f"the synthetic FID/FVD is not finite: {rec}")

    frames = {d: len(os.listdir(os.path.join(gen_tree, d))) for d in sorted(os.listdir(gen_tree))}
    with tempfile.TemporaryDirectory() as shifted:
        shifted_copy(np, gen_tree, shifted)
        runs = {}
        for name, other in (("self", gen_tree), ("shifted", shifted)):
            with timed_metrics_cli(torch) as split:
                t0 = time.perf_counter()
                runs[name] = geval.main(["--real_root", gen_tree, "--gen_root", other,
                                         "--allow_random_towers"])
                runs[name]["seconds"] = time.perf_counter() - t0
            runs[name]["split_s"] = split
    rec = {"phase": "metrics_round_trip", "card": card, "clip_frames": frames,
           "self": runs["self"], "shifted": runs["shifted"], "shift": GEN_SHIFT,
           "self_tol": FD_SELF_TOL}
    log(rec)
    if not (len(frames) == 6 and set(frames.values()) == {8}
            and all(r["real_clips"] == r["gen_clips"] == 6 for r in runs.values())):
        raise AssertionError(f"the CLI did not find the 6 clips of 8 frames: {rec}")
    for k in ("fid", "fvd"):
        if not abs(runs["self"][k]) <= FD_SELF_TOL:
            raise AssertionError(f"the tree against itself gives {k} {runs['self'][k]}: {rec}")
        if not (np.isfinite(runs["shifted"][k]) and runs["shifted"][k] > FD_SELF_TOL):
            raise AssertionError(f"the shifted tree gives {k} {runs['shifted'][k]}: {rec}")


def sampler_config(name: str, steps: int, **params) -> dict:
    """An sgm sampler over the production schedule and guidance."""
    return {"target": f"sgm.modules.diffusionmodules.sampling.{name}",
            "params": dict(params, num_steps=steps, discretization_config={
                "target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization"},
                guider_config={"target": "sgm.modules.diffusionmodules.guiders.VanillaCFG",
                               "params": {"scale": 5.0}})}


def samplers_tiny_phase(torch, np, dev, card: str) -> None:
    """(d) each new sampler on the tiny engine, card against CPU with the
    same injected noise."""
    from panacea_tpu_torch.registry import instantiate_from_config

    cpu, card_eng = tiny_pair(torch, dev)
    noise = np.random.default_rng(SEED + 2).standard_normal(
        (SAMPLER_STEPS,) + TINY_LATENT).astype(np.float32)
    tiny = {}
    for name, params in NEW_SAMPLERS:
        key = name + ("_churn" if params else "")
        for eng in (cpu, card_eng):
            eng.sampler = instantiate_from_config(sampler_config(name, SAMPLER_STEPS, **params))
        tiny[key] = tiny_card_vs_cpu(torch, np, cpu, card_eng, SAMPLER_STEPS, sampler_noise=noise)
    rec = {"phase": "samplers_tiny_card_vs_cpu", "card": card, "config": "TINY_CPU",
           "steps": SAMPLER_STEPS, "max_rel_err": tiny, "tol": SMALL_TOL}
    log(rec)
    if not all(v <= SMALL_TOL for v in tiny.values()):
        raise AssertionError(f"a sampler on the card disagrees with the CPU: {rec}")
    del cpu, card_eng
    free(torch)


def dpmpp_phase(torch, np, dev, fa, gg, card: str, euler_s_per_step):
    """(d) DPM++2M through ``log_images`` at full width. Returns that run's
    launch counts."""
    from panacea_tpu_torch.configs import INFERENCE_NUSCENES
    from panacea_tpu_torch.registry import instantiate_from_config

    eng = instantiate_from_config(INFERENCE_NUSCENES["model"], device=dev)
    eng.init_weights(torch.Generator(device=dev).manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    eng.sampler = instantiate_from_config(sampler_config("DPMPP2MSampler", DPMPP_STEPS))
    batch = synthetic_clip(np, np.random.default_rng(SEED), eng.num_frames, *FULL_HW)
    step_s = []
    network_fn = eng.network_fn

    def timed_network(*a, **kw):
        t0 = time.perf_counter()
        out = network_fn(*a, **kw)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    eng.network_fn = timed_network
    torch.cuda.synchronize()
    reset_counts(fa, gg)
    t0 = time.perf_counter()
    logd = eng.log_images(batch, N=1, generator=torch.Generator(device=dev).manual_seed(SEED),
                          num_steps=DPMPP_STEPS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts(fa, gg)
    evals = len(step_s)
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    expected = {"flash_attention": FLASH_PER_EVAL * evals, "geglu": GEGLU_PER_EVAL * evals}
    rec = {"phase": "sampler_dpmpp2m_log_images", "card": card, "steps": DPMPP_STEPS,
           "network_evals": evals, "log_images_s": total_s, "step_s": step_s,
           "s_per_step": steady, "euler_s_per_step": euler_s_per_step,
           "launches": {k: counts[k] for k in expected}, "expected": expected,
           "finite": bool(torch.isfinite(logd["samples"]).all()),
           "samples_shape": list(logd["samples"].shape)}
    log(rec)
    if not (rec["finite"] and rec["samples_shape"] == [eng.num_frames, *FULL_HW, 3]):
        raise AssertionError(f"DPM++2M's samples are wrong: {rec}")
    if evals != DPMPP_STEPS or rec["launches"] != expected:
        raise AssertionError(f"DPM++2M's launches {counts} != {expected}")
    return counts


def metrics_phase(torch, np, dev, fa, gg, card: str, gen_tree: str, euler_s_per_step=None,
                  tiny_samplers: bool = True):
    """Phase 12: the generation metrics, then the new samplers (their tiny
    check left out with ``tiny_samplers`` False: the whole run makes it
    beside phase 21's ranks)."""
    t0 = time.perf_counter()
    metric_towers_phase(torch, np, dev, card)
    free(torch)
    metrics_cli_phase(torch, np, dev, card, gen_tree)
    free(torch)
    if tiny_samplers:
        samplers_tiny_phase(torch, np, dev, card)
    counts = dpmpp_phase(torch, np, dev, fa, gg, card, euler_s_per_step)
    log({"phase": "metrics_total", "seconds": time.perf_counter() - t0})
    return counts


# phase 13: stage 1 (single-frame six-view generation) of the production
# config, its 'full' spatial mode (BASELINE config 1), the tiny stage-1
# engine and the off-path variants, the last two card against CPU
STAGE1 = [f"model.params.network_config.params.{p}num_frames=1"
          for p in ("", "controlnet_config.params.")]
FULL_MODE = [f"model.params.network_config.params.{p}{k}"
             for p in ("", "controlnet_config.params.")
             for k in ("spatial_only_attn_type=full", "insert_crossview=False")]
# launches a network evaluation, from the network's blocks: 23 transformers
# (UNet 6 + 1 + 9, ControlNet 6 + 1), one GEGLU feed-forward per stage (3, or
# 2 without the cross-view stage); one flash call per cross-view stage whose
# views hold >= 128 tokens (levels 0-2; the middle's 32 go to SDPA). Frames
# do not enter either count
STAGE1_PER_EVAL = {"flash_attention": 21, "geglu": 69}
FULL_PER_EVAL = {"flash_attention": 0, "geglu": 46}
FULL_STEPS = 4
STAGE1_TINY_LATENT = (1, 8, 96, 4)   # one frame of TINY_LATENT's 128 tokens a view
# stage 1's kernel shapes: the cross-view call of the CFG batch's 2 frames x
# views 0-4 at the three flash levels (B, Sq, Skv, H), and the GEGLU calls
# of 2 frames at levels 0 / 1 / 2 / mid (tokens, C)
STAGE1_FLASH = ((10, 2048, 4096, 5), (10, 512, 1024, 10), (10, 128, 256, 20))
STAGE1_GEGLU = ((24576, 320), (6144, 640), (1536, 1280), (384, 1280))


def stage1_kernel_checks(torch, F, fa, gg, tol, dev):
    """The bf16 kernels at stage 1's shapes against their plain versions,
    timed beside them, their bound and their library call."""
    flash = [check_flash(torch, F, fa, tol, dev, b, sq, skv, h, 64, merged_kv=True)
             for b, sq, skv, h in STAGE1_FLASH]
    if any(rec["route"] != "wgmma" for rec in flash):
        raise AssertionError(f"stage 1's flash calls left the wgmma route: {flash}")
    return flash, [check_geglu(torch, F, gg, tol, dev, tokens, c) for tokens, c in STAGE1_GEGLU]


def stage1_engine(torch, dev, overrides=()):
    """INFERENCE_NUSCENES with one frame in the network and the ControlNet
    (the dotlist both packages' CLIs accept), random weights from SEED."""
    import copy

    from panacea_tpu_torch.config import apply_dotlist
    from panacea_tpu_torch.configs import INFERENCE_NUSCENES
    from panacea_tpu_torch.registry import instantiate_from_config

    cfg = apply_dotlist(copy.deepcopy(INFERENCE_NUSCENES), STAGE1 + list(overrides))
    eng = instantiate_from_config(cfg["model"], device=dev)
    eng.init_weights(torch.Generator(device=dev).manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    if eng.num_frames != 1:
        raise AssertionError(f"the stage-1 engine has {eng.num_frames} frames")
    return eng


def stage1_run(torch, np, dev, fa, gg, card: str, eng, steps: int, per_eval: dict, name: str,
               profile: bool = False):
    """``log_images`` on one random single-frame clip at full width (6
    views, 256 x 3072, bf16, CFG 5.0): s/step, launches per network
    evaluation, peak memory, finite outputs of the right shapes; with
    ``profile``, one more step under torch.profiler after the run. Returns
    the run's launch counts."""
    ih, iw = FULL_HW
    batch = synthetic_clip(np, np.random.default_rng(SEED), 1, ih, iw)
    step_s = []
    last_call = []
    network_fn = eng.network_fn

    def timed_network(*a, **kw):
        t0 = time.perf_counter()
        out = network_fn(*a, **kw)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        last_call[:] = [a, kw]
        return out

    eng.network_fn = timed_network
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, gg)
    t0 = time.perf_counter()
    logd = eng.log_images(batch, N=1, generator=torch.Generator(device=dev).manual_seed(SEED),
                          num_steps=steps)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts(fa, gg)
    evals = len(step_s)
    launches = {k: counts[k] for k in per_eval}
    shapes = {"inputs": (1, ih, iw, 3), "reconstructions": (1, ih, iw, 3),
              "samples": (1, ih, iw, 3), "control": (1, ih, iw, 19)}
    rec = {"phase": name, "card": card, "dtype": str(eng.dtype), "frames": eng.num_frames,
           "steps": steps, "network_evals": evals, "log_images_s": total_s, "step_s": step_s,
           "s_per_step": sorted(step_s[1:])[len(step_s[1:]) // 2],
           "outside_steps_s": total_s - sum(step_s),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "launches_per_eval": {k: v / evals for k, v in launches.items()},
           "flash_routes": dict(fa.flash_attention.route_launches),
           "finite": {k: bool(torch.isfinite(logd[k]).all()) for k in shapes},
           "shapes_ok": {k: tuple(logd[k].shape) == v for k, v in shapes.items()}}
    log(rec)
    if not (all(rec["finite"].values()) and all(rec["shapes_ok"].values())):
        raise AssertionError(f"{name}: the outputs are wrong: {rec}")
    if evals != steps or launches != {k: v * evals for k, v in per_eval.items()}:
        raise AssertionError(f"{name}: launches {launches} in {evals} evaluations, "
                             f"not {per_eval} each")
    if rec["flash_routes"]["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"{name}: the flash calls (head dim 64) left the wgmma route: {rec}")
    if profile:
        profile_step(torch, lambda: network_fn(*last_call[0], **last_call[1]), f"profile_{name}")
    return counts


def stage1_tiny_phase(torch, np, dev, fa, gg, card: str) -> None:
    """(c) TINY_STAGE1 on the card (bf16, kernels) against the CPU (fp32,
    plain versions), same weights and injected noise, 2 steps; 128 tokens a
    view send the cross-view call down the flash route."""
    cpu, card_eng = tiny_pair(torch, dev, "TINY_STAGE1")
    reset_counts(fa, gg)
    rel = tiny_card_vs_cpu(torch, np, cpu, card_eng, 2, latent=STAGE1_TINY_LATENT)
    rec = {"phase": "stage1_tiny_card_vs_cpu", "card": card, "config": "TINY_STAGE1",
           "latent": list(STAGE1_TINY_LATENT), "steps": 2, "max_rel_err": rel, "tol": SMALL_TOL,
           "flash_launches": fa.flash_attention.launches, "geglu_launches": gg.geglu.launches}
    log(rec)
    if not (rel <= SMALL_TOL and rec["flash_launches"] > 0 and rec["geglu_launches"] > 0):
        raise AssertionError(f"the tiny stage-1 engine on the card disagrees with the CPU: {rec}")


def draw_weights(torch, module, seed: int):
    """Every parameter drawn on the CPU from ``seed``: matrices and kernels
    at 1/sqrt(fan-in), norm scales 1 + 0.05 n, vectors 0.05 n (zero-init
    layers included, so that every branch computes)."""
    import math

    from panacea_tpu_torch.models.layers import GroupNorm

    gen = torch.Generator().manual_seed(seed)
    scales = {f"{n}.weight" for n, m in module.named_modules()
              if isinstance(m, (torch.nn.LayerNorm, GroupNorm))}
    with torch.no_grad():
        for k, p in module.named_parameters():
            n = torch.randn(p.shape, generator=gen)
            if p.ndim >= 2:
                n /= math.sqrt(p[0].numel())
            elif k in scales:
                n = 1.0 + 0.05 * n
            else:
                n *= 0.05
            p.copy_(n)
    return module.eval()


def tensors_of(out):
    if isinstance(out, dict):
        return [t for v in out.values() for t in tensors_of(v)]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in tensors_of(v)]
    return [out] if hasattr(out, "shape") and out.dtype.is_floating_point else []


def variants(torch, np):
    """(name, module factory, inputs, call) of each off-path variant, at
    small widths; inputs are numpy arrays or prompts, made from SEED."""
    from panacea_tpu_torch.models import clip, conditioner, vae_temporal
    from panacea_tpu_torch.models.controlnet import ControlledUNetModel3D
    from panacea_tpu_torch.models.unet import UNetModel3D
    from panacea_tpu_torch.models.vae import AutoencoderKL

    rng = np.random.default_rng(SEED)

    def f32(*shape, lo=None):
        return (rng.uniform(lo, 1, shape) if lo is not None else rng.standard_normal(shape)
                ).astype(np.float32)

    # two clips of three frames (a GroupNorm of one channel over two frames
    # normalises pairs of numbers: ill-conditioned in any backend)
    net = dict(in_channels=8, model_channels=32, num_res_blocks=1, attention_resolutions=(2, 1),
               channel_mult=(1, 2), num_head_channels=16, context_dim=64, num_frames=3,
               use_checkpoint=False)
    x, ts, ctx = f32(6, 8, 48, 8), rng.uniform(0, 999, 6).astype(np.float32), f32(2, 77, 64)
    hint = f32(6, 64, 384, 19, lo=0)
    out = []
    for form, extra, y in (("int", dict(num_classes=10), rng.integers(0, 10, 2)),
                           ("continuous", dict(num_classes="continuous"), f32(2, lo=0) * 5),
                           ("sequential", dict(num_classes="sequential", adm_in_channels=12),
                            f32(2, 12))):
        cn = {"params": dict(net, hint_channels=19, **extra)}
        out.append((f"unet_controlnet_label_{form}",
                    lambda e=extra, c=cn: ControlledUNetModel3D(controlnet_config=c,
                                                                out_channels=4, **net, **e),
                    (x, ts, ctx, hint, y), lambda m, a, b, c, h, yy: m(a, b, c, hint=h, y=yy)))
    out.append(("unet_legacy_attention",
                lambda: UNetModel3D(out_channels=4, **dict(net, model_channels=64),
                                    use_spatial_transformer=False),
                (x, ts, ctx), lambda m, *a: m(*a)))
    dd = dict(double_z=True, z_channels=4, resolution=64, in_channels=3, out_ch=3, ch=32,
              ch_mult=[1, 2, 2], num_res_blocks=1, attn_resolutions=[64, 32])
    out.append(("vae_encoder_attention", lambda: AutoencoderKL(embed_dim=4, ddconfig=dd),
                (f32(2, 64, 64, 3, lo=-1),), lambda m, a: m.decode(m.encode(a))))
    tx = f32(8, 16, 24, 32)
    for name, make in (("Upsample1D", lambda: vae_temporal.Upsample1D(32, num_frames=4)),
                       ("Downsample1D", lambda: vae_temporal.Downsample1D(32, num_frames=4)),
                       ("ResnetBlock1D", lambda: vae_temporal.ResnetBlock1D(32, 48, num_frames=4)),
                       ("ResnetBlock3D", lambda: vae_temporal.ResnetBlock3D(32, 48, True)),
                       ("AttnBlockTemporal",
                        lambda: vae_temporal.AttnBlockTemporal(32, num_frames=4))):
        out.append((f"vae_temporal_{name}", make, (tx,), lambda m, a: m(a)))
    texts = ["a driving scene. daytime. sunny.", "", "night, rain"]
    vision = dict(width=64, heads=4, layers=2, output_dim=32)
    out += [("clip_l_text", clip.FrozenCLIPEmbedder, (texts,), lambda m, t: m(t)),
            ("clip_vision_tower", lambda: clip.CLIPVisionTransformer(**vision),
             (f32(2, 224, 224, 3),), lambda m, a: m(a, output_tokens=True)),
            ("clip_image_embedder",
             lambda: clip.FrozenOpenCLIPImageEmbedder(**vision, unsqueeze_dim=True),
             (f32(2, 96, 160, 3, lo=-1),), lambda m, a: m(a)),
            ("downsampler", conditioner.DownSampler, (f32(2, 64, 96, 13, lo=0),),
             lambda m, a: m(a)),
            ("spatial_rescaler",
             lambda: conditioner.SpatialRescaler(n_stages=1, method="bicubic", multiplier=1.5,
                                                 out_channels=5, bias=True, kernel_size=3),
             (f32(2, 16, 24, 3),), lambda m, a: m(a)),
            ("concat_timestep", lambda: conditioner.ConcatTimestepEmbedderND(64),
             (np.array([[256, 512], [64, 32]], np.float32),), lambda m, a: m(a))]
    vae_cfg = {"target": "sgm.models.autoencoder.AutoencoderKL",
               "params": {"embed_dim": 4, "ddconfig": dict(dd, attn_resolutions=[])}}
    out += [("low_scale_encoder",
             lambda: conditioner.LowScaleEncoder(vae_cfg, 1e-4, 2e-2, output_size=16),
             (f32(2, 64, 64, 3, lo=-1), np.array([3, 200]), f32(2, 16, 16, 4)),
             lambda m, a, t, n: m(a, t=t, noise=n)),
            ("gaussian_encoder",
             lambda: conditioner.GaussianEncoder(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                                 z_channels=4, resolution=32),
             (f32(2, 32, 32, 3, lo=-1), f32(2, 16, 16, 4)), lambda m, a, n: m(a, noise=n))]
    return out


def variants_phase(torch, np, dev, card: str) -> None:
    """(d) each off-path variant in fp32 (TF32 off) on the card against the
    same weights and inputs on the CPU: every output's largest difference
    over its largest value, within PERCEPTION_TOL."""
    import copy

    errs = {}
    t0 = time.perf_counter()
    for i, (name, make, inputs, call) in enumerate(variants(torch, np)):
        cpu = draw_weights(torch, make(), SEED + i)
        on_card = copy.deepcopy(cpu).to(dev)

        def args(d):
            return [torch.as_tensor(a, device=d) if isinstance(a, np.ndarray) else a
                    for a in inputs]

        with torch.no_grad():
            want, got = tensors_of(call(cpu, *args("cpu"))), tensors_of(call(on_card, *args(dev)))
        if len(want) != len(got) or not want:
            raise AssertionError(f"{name}: {len(got)} outputs on the card, {len(want)} on the CPU")
        errs[name] = max(((g.float().cpu() - w).abs().max() / w.abs().max()).item()
                         if bool(torch.isfinite(g).all()) else float("inf")
                         for g, w in zip(got, want))
    rec = {"phase": "variants_card_vs_cpu", "card": card, "dtype": "torch.float32",
           "seconds": time.perf_counter() - t0, "max_rel_err": errs, "tol": PERCEPTION_TOL}
    log(rec)
    if not all(e <= PERCEPTION_TOL for e in errs.values()):
        raise AssertionError(f"a variant on the card disagrees with the CPU: {rec}")


def stage1_phase(torch, np, dev, fa, gg, card: str) -> dict:
    """Phase 13. Returns the launch counts of (a) and (b) by path."""
    t0 = time.perf_counter()
    eng = stage1_engine(torch, dev)
    paths = {"stage1": stage1_run(torch, np, dev, fa, gg, card, eng, MAIN_STEPS,
                                  STAGE1_PER_EVAL, "stage1_log_images", profile=True)}
    del eng
    free(torch)
    eng = stage1_engine(torch, dev, FULL_MODE)
    paths["stage1_full"] = stage1_run(torch, np, dev, fa, gg, card, eng, FULL_STEPS,
                                      FULL_PER_EVAL, "stage1_full_attention")
    del eng
    free(torch)
    if not BESIDE_RANKS["card_vs_cpu"]:
        stage1_tiny_phase(torch, np, dev, fa, gg, card)
        free(torch)
        variants_phase(torch, np, dev, card)
    log({"phase": "stage1_total", "seconds": time.perf_counter() - t0})
    return paths


# --------------------------------------------------------------------------
# phase 14: perception training (the window and the streaming recipes)
# --------------------------------------------------------------------------


def ptrain_setup(torch, np, dev, recipe: str = PTRAIN_RECIPE, queue_length=None, bs=PTRAIN_B,
                 seed: int = SEED, params=None):
    """The recipe's detector on ``dev`` (``params`` overriding its
    ``perception.detector.params``, as a YAML would) with random weights
    from ``seed``, its optimizer (stem and the first stage frozen,
    backbone at 0.1 x lr, clip 35, the cosine schedule), the trainer, and
    its dataset on synthetic infos with random 256 x 512 images and the
    recipe's augmentations (history jitter, IDA resize and flip, global
    rotation and scale); with the motion head the windows carry the
    ground truth's futures (``pred_steps``)."""
    from panacea_tpu_torch.config import load_perception_config
    from panacea_tpu_torch.data.nuscenes.synthetic import make_synthetic_infos, path_seed
    from panacea_tpu_torch.perception.atss import fpn_shapes, grid_anchors
    from panacea_tpu_torch.perception.train import (DetectorOptimizer, DetectorTrainer,
                                                    DetTrainState, cosine_schedule)
    from panacea_tpu_torch.perception.train_dataset import PerceptionTrainDataset
    from panacea_tpu_torch.registry import instantiate_from_config

    cfg = load_perception_config(recipe)["perception"]
    if params:
        cfg["detector"] = dict(cfg["detector"], params=dict(cfg["detector"]["params"], **params))
    tcfg, ocfg, dcfg = cfg["train"], cfg["optimizer"], cfg["data"]
    model = instantiate_from_config(cfg["detector"]).to(dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed), zero_init_std=ZERO_INIT_STD)
    sch = ocfg["schedule"]
    opt = DetectorOptimizer(
        dict(model.named_parameters()), weight_decay=ocfg["weight_decay"],
        backbone_lr_mult=ocfg["backbone_lr_mult"], grad_clip_norm=ocfg["grad_clip_norm"],
        schedule=cosine_schedule(ocfg["lr"], sch["warmup_iters"], sch["warmup_ratio"], 42192,
                                 sch["min_lr_ratio"]),
        backbone_frozen_stages=cfg["backbone_frozen_stages"],
        backbone_bn_trainable=cfg.get("backbone_bn_trainable", True))
    seq_mode = bool(tcfg.get("seq_mode", False))
    ql = queue_length or tcfg["queue_length"]
    infos = make_synthetic_infos(num_frames=24, num_boxes=12, seed=seed)
    for info in infos:
        info["ego2global_rotation"] = [1.0, 0.0, 0.0, 0.0]
        info["ego2global_translation"] = [2.0 * info["frame_idx"], 0, 0]

    def loader(path):
        return np.random.RandomState(path_seed(path)).uniform(
            0, 255, PERCEPTION_HW + (3,)).astype(np.float32)

    ds = PerceptionTrainDataset(
        infos=infos, queue_length=ql, final_dim=PERCEPTION_HW, image_loader=loader,
        random_length=tcfg["random_length"] if queue_length is None else 0,
        ida_aug=dcfg["ida"], rot_range=tuple(dcfg["rot_range"]),
        scale_ratio_range=tuple(dcfg["scale_ratio_range"]),
        seq_split_num=tcfg.get("seq_split_num", 2) if seq_mode else 0, seed=seed)
    anchors = grid_anchors(fpn_shapes(PERCEPTION_HW, len(model.feat_strides),
                                      model.feat_strides[0]), strides=model.feat_strides)
    trainer = DetectorTrainer(
        tuple(cfg["detector"]["params"]["pc_range"]), cls_weight=tcfg["cls_weight"],
        bbox_weight=tcfg["bbox_weight"], use_grid_mask=tcfg["use_grid_mask"],
        with_dn=tcfg["with_dn"], dn_scalar=tcfg["dn_scalar"],
        dn_noise_scale=tcfg["dn_noise_scale"], dn_split=tcfg["dn_split"],
        dn_weight=tcfg["dn_weight"], anchors_per_level=anchors,
        num_frame_losses=tcfg["num_frame_losses"], streaming=seq_mode)
    return {"model": model, "state": DetTrainState(model, opt), "trainer": trainer, "ds": ds,
            "anchors": anchors, "bs": bs, "ql": ql, "detector_cfg": cfg["detector"],
            "generator": torch.Generator().manual_seed(seed + 1),
            "pred_steps": getattr(model.pts_bbox_head, "pred_steps", 0)}


def ptrain_batch(setup, dev, start: int):
    """bs windows ending at the keys from ``start`` on (a window without
    its history is passed over), collated onto ``dev``."""
    from panacea_tpu_torch.perception.train_cli import collate

    ds, items, key = setup["ds"], [], start
    while len(items) < setup["bs"]:
        it = ds.window_with_gt(key % len(ds), max_gt=PTRAIN_MAX_GT,
                               pred_steps=setup["pred_steps"])
        key += 1
        if it is not None:
            items.append(it)
    return collate(items, setup["anchors"], dev)


def ptrain_timers(torch, setup, split: dict):
    """Synchronised timers around the parts of a step, into ``split``: the
    history frames (no grad) and the grad frame's forward, told apart by
    the grad mode, the loss with the Hungarian matching, the backward and
    the optimizer. Returns a function that takes them off."""
    model, trainer, opt = setup["model"], setup["trainer"], setup["state"].optimizer

    def wrap(obj, attr, name=None):
        fn = getattr(obj, attr)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            key = name or ("grad_frame_fwd_s" if torch.is_grad_enabled() else "history_s")
            split[key] = split.get(key, 0.0) + time.perf_counter() - t0
            return out
        setattr(obj, attr, timed)
        return obj, attr

    wrapped = [wrap(model, "extract_feats"), wrap(model.pts_bbox_head, "forward"),
               wrap(model.img_roi_head, "forward"), wrap(trainer, "loss", "loss_hungarian_s"),
               wrap(trainer, "backward", "backward_s"), wrap(opt, "step", "optimizer_s")]

    def off():
        for obj, attr in wrapped:
            delattr(obj, attr)
    return off


def ptrain_window_phase(torch, np, dev, fa, gg, card: str):
    """(a) The window recipe at full width, PTRAIN_STEPS steps of bs 2:
    s/step with its split, peak memory, every loss term, the launches of
    each step (42 fp32 flash forward, nothing else), the frozen stages and
    every batch-norm statistic bit-equal after the steps; then one
    profiled step. Returns (setup, the counts of one step)."""
    setup = ptrain_setup(torch, np, dev)
    state, trainer, model = setup["state"], setup["trainer"], setup["model"]
    frozen = {k: v.detach().clone() for k, v in model.named_parameters() if not v.requires_grad}
    frozen.update({k: v.clone() for k, v in model.named_buffers()})
    splits, times, metrics, counts = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(PTRAIN_STEPS):
        split = {}
        off = ptrain_timers(torch, setup, split)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = ptrain_batch(setup, dev, PERCEPTION_T + 2 * i)
        split["host_data_targets_s"] = time.perf_counter() - t0
        reset_counts(fa, gg)
        out = trainer.step(state, *batch, generator=setup["generator"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(read_counts(fa, gg))
        off()
        splits.append(split)
        metrics.append(out.metrics)
    peak = torch.cuda.max_memory_allocated() / 1e9
    same = {k: bool(torch.equal(v, dict(list(model.named_parameters())
                                        + list(model.named_buffers()))[k]))
            for k, v in frozen.items()}
    steady = sorted(times[1:])
    rec = {"phase": "perception_train", "card": card, "recipe": PTRAIN_RECIPE,
           "batch": PTRAIN_B, "frames": PERCEPTION_T, "image_hw": list(PERCEPTION_HW),
           "cams": 6, "queries": 644, "dn_queries": PTRAIN_MAX_GT * 10, "memory": 1024,
           "params": sum(p.numel() for p in model.parameters()),
           "trained_params": sum(p.numel() for p in state.params.values()),
           "first_step_s": times[0], "s_per_step": steady[len(steady) // 2], "step_s": times,
           "split_s_median_step": splits[1 + times[1:].index(steady[len(steady) // 2])],
           "split_s_first_step": splits[0], "peak_mem_gb": peak, "losses": metrics,
           "launches_per_step": counts, "expected_fp32_flash": PTRAIN_FLASH_PER_STEP,
           "frozen_tensors": len(frozen), "frozen_bit_equal": all(same.values())}
    log(rec)
    finite = all(np.isfinite(v) for m in metrics for v in m.values())
    if not (finite and rec["frozen_bit_equal"]):
        raise AssertionError(f"perception training went wrong: {rec}")
    for c in counts:
        if not (c["flash_attention"] == c["flash_routes"]["fp32"] == PTRAIN_FLASH_PER_STEP
                == c["flash_fp32_kernels"]["tc32"]
                and c["flash_attention_bwd"] == 0 and c["geglu"] == 0):
            raise AssertionError(f"a training step launched {c}, not {PTRAIN_FLASH_PER_STEP} "
                                 f"fp32 flash forwards and nothing else: {rec}")
    batch = ptrain_batch(setup, dev, PERCEPTION_T)
    profile_step(torch, lambda: trainer.step(state, *batch, generator=setup["generator"]),
                 name="profile_perception_train_step", grad=True)
    return setup, counts[-1]


def ptrain_card_vs_cpu(torch, np, dev, card: str, params=None,
                       name: str = "perception_train_card_vs_cpu"):
    """(b) One step's loss terms at full width, bs 1 and 2 frames, on the
    card and on the CPU from the same weights, window and draws: the first
    frame on the card, its memory handed to both (the top-256 selection
    orders near-equal scores by rounding noise), then the grad frame's
    forward and loss on each, with the CPU's Hungarian assignment (and the
    host's ATSS targets) given to both. ``params``: the detector's, as in
    ``ptrain_setup``."""
    import copy

    from panacea_tpu_torch.perception.head import MemoryState, init_memory
    from panacea_tpu_torch.registry import instantiate_from_config

    small = ptrain_setup(torch, np, dev, queue_length=2, bs=1, seed=SEED + 2, params=params)
    model = small["model"]
    cpu_model = instantiate_from_config(small["detector_cfg"])
    cpu_model.load_state_dict(model.state_dict())
    imgs, data, boxes, labels, tgt2d, trajs, traj_mask = ptrain_batch(small, dev, 1)
    cpu_trajs = {} if trajs is None else {"gt_trajs": trajs.cpu(), "gt_traj_mask": traj_mask.cpu()}
    trajs = {} if trajs is None else {"gt_trajs": trajs, "gt_traj_mask": traj_mask}
    frame = copy.copy(small["trainer"])
    frame.streaming = True            # the grad frame alone, from a given memory
    draws = frame.draw(small["generator"], imgs.shape[-3], 1, PTRAIN_MAX_GT)
    with torch.no_grad():
        _, memory = model.forward_frame(imgs[:, 0], init_memory(1, model.memory_len,
                                                                model.embed_dims, device=dev),
                                        {k: v[:, 0] for k, v in data.items()})
        t0 = time.perf_counter()
        cpu_in = (imgs[:, 1].cpu(), {k: v[:, 1].cpu() for k, v in data.items()}, boxes.cpu(),
                  labels.cpu())
        outs, atss_outs, _, dn = frame.forward(cpu_model, *cpu_in, draws,
                                               MemoryState(*(m.cpu() for m in memory)))
        _, want, assignment = frame.loss(outs, atss_outs, dn, cpu_in[2], cpu_in[3], tgt2d,
                                         **cpu_trajs)
        cpu_s = time.perf_counter() - t0
        outs, atss_outs, _, dn = frame.forward(model, imgs[:, 1],
                                               {k: v[:, 1] for k, v in data.items()}, boxes,
                                               labels, draws, memory)
        _, got, _ = frame.loss(outs, atss_outs, dn, boxes, labels, tgt2d, assignment, **trajs)
    terms = {k: abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-6)
             for k in want}
    rec = {"phase": name, "card": card, "batch": 1, "frames": 2,
           "loss_cpu": {k: float(v) for k, v in want.items()},
           "loss_card": {k: float(v) for k, v in got.items()}, "rel_diff": terms,
           "tol": PERCEPTION_TOL, "cpu_grad_frame_s": cpu_s}
    log(rec)
    if not max(terms.values()) <= PERCEPTION_TOL:
        raise AssertionError(f"perception training: the card's loss terms disagree with the "
                             f"CPU's: {rec}")


def ptrain_nodn_phase(torch, F, np, dev, fa, gg, tol, card: str, setup):
    """(c) With ``with_dn`` False, one step of the window recipe: the grad
    frame's self-attention takes the fp32 flash forward and backward
    kernels (6 of each beside the 42 history forwards, the backward's on
    ``tc32``). Then that backward at (2, 900, 1668, 8, 32) against the
    float64 plain version, timed beside fp32 SDPA's backward, and the
    forward at B 2. Returns (the step's counts, the backward's record, the
    forward's)."""
    import copy

    trainer = copy.copy(setup["trainer"])
    trainer.with_dn = False
    batch = ptrain_batch(setup, dev, PERCEPTION_T + 4)
    reset_counts(fa, gg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.step(setup["state"], *batch, generator=setup["generator"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = read_counts(fa, gg)
    rec = {"phase": "perception_train_no_dn", "card": card, "s_per_step": step_s,
           "losses": out.metrics, "launches": counts}
    log(rec)
    layers = 6
    if not (counts["flash_routes"]["fp32"] == PTRAIN_FLASH_PER_STEP + layers
            == counts["flash_fp32_kernels"]["tc32"]
            and counts["flash_bwd_routes"]["fp32"] == layers == counts["flash_attention_bwd"]
            == counts["flash_bwd_fp32_kernels"]["tc32"]
            and all(np.isfinite(v) for v in out.metrics.values())):
        raise AssertionError(f"without DN the grad frame did not take the flash kernels: {rec}")
    free(torch)
    bwd = check_flash_bwd(torch, F, fa, tol, dev, *PTRAIN_FLASH, merged_kv=False, fp32=True)
    fwd = check_flash(torch, F, fa, tol, dev, *PTRAIN_FLASH, fp32=True)
    return counts, bwd, fwd


def ptrain_stream_steps(torch, np, dev, fa, gg, card: str, setup, name: str):
    """2 steps of the streaming recipe's ``setup`` (one frame a step with
    the memory carried across steps, bs 2; with the motion head the frames
    carry the ground truth's futures), the counts zeroed before each step
    and read after it: every loss term finite and the memory filling.
    Returns the record and the last step's counts."""
    from panacea_tpu_torch.perception.head import init_memory
    from panacea_tpu_torch.perception.train_cli import collate
    from panacea_tpu_torch.perception.train_dataset import StreamingSampler

    ds, model, state = setup["ds"], setup["model"], setup["state"]
    sampler = StreamingSampler(ds.seq_flags, batch_size=PTRAIN_B, seed=SEED)
    memory = init_memory(PTRAIN_B, model.memory_len, model.embed_dims, device=dev)
    times, metrics, filled, counts, valid = [], [], [], [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items = [ds.window_with_gt(i, max_gt=PTRAIN_MAX_GT, pred_steps=setup["pred_steps"])
                 for i in sampler.next_batch()]
        imgs, data, *targets = collate(items, setup["anchors"], dev)
        if targets[-1] is not None:
            valid.append(int(targets[-1][..., 0].sum().item()))
        reset_counts(fa, gg)
        out = setup["trainer"].step(state, imgs[:, 0], {k: v[:, 0] for k, v in data.items()},
                                    *targets, generator=setup["generator"], memory=memory)
        memory = out.memory
        torch.cuda.synchronize()
        counts.append(read_counts(fa, gg))
        times.append(time.perf_counter() - t0)
        metrics.append(out.metrics)
        filled.append(int((memory.embedding.abs().sum(-1) > 0).sum()))
    rec = {"phase": name, "card": card, "batch": PTRAIN_B, "pred_steps": setup["pred_steps"],
           "step_s": times, "losses": metrics, "memory_slots_filled": filled,
           "future_steps_valid": valid, "launches": counts, "model": type(model).__name__}
    log(rec)
    if not (all(np.isfinite(v) for m in metrics for v in m.values())
            and filled[0] == PTRAIN_B * model.pts_bbox_head.topk_proposals
            and filled[1] >= filled[0]):
        raise AssertionError(f"{name}: streaming training went wrong: {rec}")
    return rec, counts[-1]


def ptrain_stream_phase(torch, np, dev, fa, gg, card: str):
    """(d) The streaming recipe (``StreamPETR``), 2 steps at bs 2."""
    setup = ptrain_setup(torch, np, dev, recipe=PTRAIN_STREAM_RECIPE)
    return ptrain_stream_steps(torch, np, dev, fa, gg, card, setup,
                               "perception_train_streaming")[1]


def ptrain_cli_phase(torch, np, card: str):
    """(e) ``train_perception_torch.py --synthetic --tiny --steps 2
    --ckpt_every 2`` on the card, then ``--resume`` for one more step."""
    from panacea_tpu_torch.perception import train_cli

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        flags = ["--synthetic", "--tiny", "--ckpt_every", "2", "--workdir", tmp]
        first = train_cli.main(flags + ["--steps", "2"])
        resumed = train_cli.main(flags + ["--steps", "3", "--resume",
                                          os.path.join(tmp, PTRAIN_RECIPE)])
        cli_s = time.perf_counter() - t0
        kept = sorted(os.listdir(os.path.join(tmp, PTRAIN_RECIPE)))
    rec = {"phase": "perception_train_cli", "card": card, "seconds": cli_s,
           "steps": [first["steps"], resumed["steps"]], "files": kept,
           "final_metrics": resumed["final_metrics"]}
    log(rec)
    if not (first["steps"] == 2 and resumed["steps"] == resumed["state"].step == 3
            and "iter_2" in kept and all(np.isfinite(v)
                                         for v in resumed["final_metrics"].values())):
        raise AssertionError(f"the perception training CLI or its resume went wrong: {rec}")


def perception_train_phase(torch, F, np, dev, fa, gg, tol, card: str) -> dict:
    """Phase 14 (a) to (e). Returns the counts of its paths and the
    records of the FMA backward and forward at the training shape."""
    t0 = time.perf_counter()
    setup, counts = ptrain_window_phase(torch, np, dev, fa, gg, card)
    free(torch)
    if not BESIDE_RANKS["card_vs_cpu"]:
        ptrain_card_vs_cpu(torch, np, dev, card)
        free(torch)
    nodn, bwd, fwd = ptrain_nodn_phase(torch, F, np, dev, fa, gg, tol, card, setup)
    del setup
    free(torch)
    stream = ptrain_stream_phase(torch, np, dev, fa, gg, card)
    free(torch)
    ptrain_cli_phase(torch, np, card)
    log({"phase": "perception_train_total", "seconds": time.perf_counter() - t0})
    return {"paths": {"perception_train": counts, "perception_train_no_dn": nodn,
                      "perception_train_streaming": stream}, "bwd": bwd, "fwd": fwd}


# --------------------------------------------------------------------------
# phase 15: the perception zoo's dense-attention PETR family
# --------------------------------------------------------------------------

@contextlib.contextmanager
def flash_shapes():
    """Counts the router's calls of ``flash_attention`` by (Sq, Skv) while
    the block runs (the launch counters count the launches themselves)."""
    from collections import Counter

    from panacea_tpu_torch.ops import attention as pattn

    shapes, flash = Counter(), pattn.flash_attention

    def counted(q, k, v, **kw):
        shapes[f"{q.shape[1]}x{k.shape[1]}"] += 1
        return flash(q, k, v, **kw)

    pattn.flash_attention = counted
    try:
        yield shapes
    finally:
        pattn.flash_attention = flash


def split_timer(torch, split: dict, name: str, fn):
    """``fn`` that adds its synchronised wall time to ``split[name]``."""
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        split[name] += time.perf_counter() - s
        return out
    return wrapper


def frames_card_vs_cpu(torch, model, cpu, imgs, data, frames: int, keys):
    """``frames`` frames through ``forward_frame`` on the card and on the
    CPU, each frame's CPU run starting from the card's memory: the worst
    relative difference of each output in ``keys`` (over its largest
    value), and the last card outputs."""
    from panacea_tpu_torch.perception.head import init_memory

    worst = {}
    mem = init_memory(1, model.memory_len, model.embed_dims, device=imgs.device)
    with torch.inference_mode():
        for fi in range(frames):
            frame = {k: v[:, fi] for k, v in data.items()}
            got, mem_next = model.forward_frame(imgs[:, fi], mem, frame)
            want, _ = cpu.forward_frame(imgs[:, fi].cpu(), type(mem)(*(m.cpu() for m in mem)),
                                        {k: v.cpu() for k, v in frame.items()})
            for key in keys:
                err = (got[key].cpu() - want[key]).abs().max().item()
                worst[f"{key}_frame{fi}"] = err / want[key].abs().max().item()
            mem = mem_next
    return worst, got


def zoo_model(torch, dev, cls_name: str, **kw):
    """A detector of ``perception.detector`` at full width on the card, its
    weights drawn from the seed, and the same weights on the CPU."""
    from panacea_tpu_torch.perception import detector

    model = getattr(detector, cls_name)(**kw).to(dev).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    cpu = getattr(detector, cls_name)(**kw).eval()
    cpu.load_state_dict(model.state_dict())
    return model, cpu


def zoo_geometry(model, stride: int):
    """(decoder layers, queries, image tokens at ``stride``, self-attention
    keys) of a PETR detector on a window of PERCEPTION_HW."""
    q = model.num_query + (model.num_propagated if model.head_type != "petr_dn" else 0)
    tokens = 6 * (PERCEPTION_HW[0] // stride) * (PERCEPTION_HW[1] // stride)
    return (len(model.pts_bbox_head.transformer.decoder.layers), q, tokens,
            q + model.memory_len - model.num_propagated)


def zoo_window_phase(torch, np, dev, fa, gg, card: str):
    """(b) ``PetrWindow3D`` (r50 + StreamPETRHead) on one window of
    PERCEPTION_T frames: s/window and its split, peak memory, the fp32
    flash launches by shape (cross-attention and self-attention 6 a frame,
    all on ``tc32``), card against CPU over two frames, one profiled
    window. Returns the window's launch counts."""
    model, cpu = zoo_model(torch, dev, "PetrWindow3D")
    imgs, data = perception_window(torch, np, dev, PERCEPTION_T)
    split = {"backbone_fpn_s": 0.0, "head_s": 0.0}
    model.extract_feats = split_timer(torch, split, "backbone_fpn_s", model.extract_feats)
    model.pts_bbox_head.forward = split_timer(torch, split, "head_s",
                                              model.pts_bbox_head.forward)
    with torch.inference_mode():
        t0 = time.perf_counter()
        model(imgs, data)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        split.update(dict.fromkeys(split, 0.0))
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, gg)
        with flash_shapes() as shapes:
            t0 = time.perf_counter()
            outs, memory = model(imgs, data)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        counts = read_counts(fa, gg)
    peak = torch.cuda.max_memory_allocated() / 1e9
    window_split = dict(split)
    del model.extract_feats, model.pts_bbox_head.forward
    layers, q, tokens, keys = zoo_geometry(model, 8)
    shapes_ok = (tuple(outs["all_cls_scores"].shape) == (layers, 1, q, 10)
                 and tuple(memory.embedding.shape) == (1, model.memory_len, model.embed_dims))
    finite = all(bool(torch.isfinite(v).all()) for v in outs.values())
    worst, _ = frames_card_vs_cpu(torch, model, cpu, imgs, data, 2,
                                  ("all_cls_scores", "all_bbox_preds"))
    want_shapes = {f"{q}x{tokens}": layers * PERCEPTION_T, f"{q}x{keys}": layers * PERCEPTION_T}
    rec = {"phase": "perception_petr_window", "card": card, "detector": "PetrWindow3D",
           "frames": PERCEPTION_T, "image_hw": list(PERCEPTION_HW), "cams": 6, "queries": q,
           "tokens": tokens, "params": sum(p.numel() for p in model.parameters()),
           "first_window_s": first_s,
           "s_per_window": window_s, "split_s": window_split, "peak_mem_gb": peak,
           "launches": counts, "flash_calls_by_shape": dict(shapes),
           "expected_flash_calls_by_shape": want_shapes, "finite": finite,
           "shapes_ok": shapes_ok, "card_vs_cpu_t2": worst, "tol": PERCEPTION_TOL}
    log(rec)
    n = 2 * layers * PERCEPTION_T
    if not (finite and shapes_ok):
        raise AssertionError(f"the PETR detector's output is wrong: {rec}")
    if (dict(shapes) != want_shapes or counts["flash_attention"] != n
            or counts["flash_routes"]["fp32"] != n or counts["flash_fp32_kernels"]["tc32"] != n):
        raise AssertionError(f"a PETR window did not make {n} fp32 flash launches on tc32 "
                             f"at the expected shapes: {rec}")
    if not max(worst.values()) <= PERCEPTION_TOL:
        raise AssertionError(f"the PETR detector on the card disagrees with the CPU: {rec}")
    profile_step(torch, lambda: model(imgs, data), name="profile_petr_window")
    return counts


def zoo_dn_motion_phase(torch, np, dev, fa, gg, card: str):
    """(c) VoVNet-99 + PETRHeadDN on one window (its cross-attention at Skv
    3,072, its self-attention over the 644 queries on SDPA), card against
    CPU on one frame; then ``Petr3DP`` (r50 + PETRMotionHead) streaming two
    frames, card against CPU with the trajectories, decoded with
    ``decode_with_traj``. Returns the launch counts of the two paths."""
    from panacea_tpu_torch.perception.coder import NMSFreeCoder
    from panacea_tpu_torch.perception.head import init_memory
    from panacea_tpu_torch.perception.motion_head import decode_with_traj

    paths = {}
    imgs, data = perception_window(torch, np, dev, PERCEPTION_T)
    model, cpu = zoo_model(torch, dev, "StreamPETRWindow", backbone_type="vovnet",
                           neck_start_level=2, head_type="petr_dn")
    with torch.inference_mode():
        model(imgs, data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, gg)
        with flash_shapes() as shapes:
            t0 = time.perf_counter()
            outs, _ = model(imgs, data)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        paths["perception_vovnet_petr_dn"] = counts = read_counts(fa, gg)
    worst, _ = frames_card_vs_cpu(torch, model, cpu, imgs, data, 1,
                                  ("all_cls_scores", "all_bbox_preds"))
    layers, q, tokens, _ = zoo_geometry(model, 16)
    want_shapes = {f"{q}x{tokens}": layers * PERCEPTION_T}
    rec = {"phase": "perception_vovnet_petr_dn", "card": card, "backbone": "vovnet",
           "head": "petr_dn", "frames": PERCEPTION_T,
           "params": sum(p.numel() for p in model.parameters()), "s_per_window": window_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
           "flash_calls_by_shape": dict(shapes), "expected_flash_calls_by_shape": want_shapes,
           "finite": all(bool(torch.isfinite(v).all()) for v in outs.values()),
           "card_vs_cpu_t1": worst, "tol": PERCEPTION_TOL}
    log(rec)
    if not (rec["finite"] and dict(shapes) == want_shapes
            and counts["flash_fp32_kernels"]["tc32"] == layers * PERCEPTION_T
            and max(worst.values()) <= PERCEPTION_TOL):
        raise AssertionError(f"VoVNet-99 + PETRHeadDN went wrong: {rec}")
    del model, cpu
    free(torch)

    model, cpu = zoo_model(torch, dev, "Petr3DP")
    mem = init_memory(1, model.memory_len, model.embed_dims, device=dev)
    frame_s = []
    with torch.inference_mode():
        model.stream(imgs[:, 0], {k: v[:, 0] for k, v in data.items()})   # first use
        torch.cuda.synchronize()
        reset_counts(fa, gg)
        with flash_shapes() as shapes:
            for fi in range(2):
                t0 = time.perf_counter()
                outs, mem = model.stream(imgs[:, fi], {k: v[:, fi] for k, v in data.items()},
                                         mem)
                torch.cuda.synchronize()
                frame_s.append(time.perf_counter() - t0)
        paths["perception_petr3dp_stream"] = counts = read_counts(fa, gg)
    keys = ("all_cls_scores", "all_bbox_preds", "all_traj_preds", "all_traj_scores")
    worst, got = frames_card_vs_cpu(torch, model, cpu, imgs, data, 2, keys)
    dets = decode_with_traj(NMSFreeCoder(pc_range=model.pc_range, max_num=300), got)[0]
    rec = {"phase": "perception_petr3dp_stream", "card": card, "detector": "Petr3DP",
           "frames": 2, "s_per_frame": frame_s, "launches": counts,
           "flash_calls_by_shape": dict(shapes),
           "traj_shape": list(outs["all_traj_preds"].shape),
           "decoded": len(dets["labels"]), "decoded_trajs_shape": list(dets["trajs"].shape),
           "finite": all(bool(torch.isfinite(v).all()) for v in outs.values())
           and bool(np.isfinite(dets["trajs"]).all()),
           "card_vs_cpu_t2": worst, "tol": PERCEPTION_TOL}
    log(rec)
    layers, q, tokens, keys = zoo_geometry(model, 8)
    if not (rec["finite"] and rec["traj_shape"] == [layers, 1, q, 6, 12, 2]
            and rec["decoded_trajs_shape"][1:] == [6, 12, 2]
            and dict(shapes) == {f"{q}x{tokens}": 2 * layers, f"{q}x{keys}": 2 * layers}
            and counts["flash_fp32_kernels"]["tc32"] == 4 * layers
            and max(worst.values()) <= PERCEPTION_TOL):
        raise AssertionError(f"Petr3DP's streaming with trajectories went wrong: {rec}")
    return paths


def zoo_cli_phase(torch, np, fa, gg, card: str):
    """(d) ``perception.eval.main --synthetic --tiny --backbone vovnet
    --head petr`` on the card (VoVNet-99 at full width, the tiny head)."""
    from panacea_tpu_torch.perception import eval as peval

    reset_counts(fa, gg)
    t0 = time.perf_counter()
    metrics = peval.main(["--synthetic", "--tiny", "--backbone", "vovnet", "--head", "petr"])
    torch.cuda.synchronize()
    rec = {"phase": "perception_zoo_cli", "card": card, "seconds": time.perf_counter() - t0,
           "launches": read_counts(fa, gg), "metrics": metrics}
    log(rec)
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"the VoVNet + PETR eval CLI went wrong: {rec}")
    return rec["launches"]


def zoo_losses_phase(torch, np, dev, card: str):
    """(e) The VAE's losses at full width, card against CPU within
    LOSS_TOL: LPIPS (VGG16) on LPIPS_PAIRS image pairs at 256 x 512, the
    PatchGAN (ndf 64, 3 layers) on the same images, and LatentLPIPS with
    the production VAE decoder (INFERENCE_NUSCENES' first stage) on one
    (1, 4, 32, 64) latent pair; random weights from the seed, each timed."""
    from panacea_tpu_torch.configs import INFERENCE_NUSCENES
    from panacea_tpu_torch.losses.lpips import LPIPS
    from panacea_tpu_torch.losses.vae_losses import LatentLPIPS, NLayerDiscriminator

    g = torch.Generator().manual_seed(SEED)
    x, y = (torch.rand((LPIPS_PAIRS, 3) + PERCEPTION_HW, generator=g) * 2 - 1 for _ in range(2))
    latent = (1, 4, PERCEPTION_HW[0] // 8, PERCEPTION_HW[1] // 8)
    z_in, z_pred = (torch.randn(latent, generator=g) for _ in range(2))
    lp_cpu = draw_weights(torch, LPIPS(), SEED)
    disc_cpu = draw_weights(torch, NLayerDiscriminator(ndf=64, n_layers=3), SEED + 1)
    lat_cpu = LatentLPIPS(decoder_config=INFERENCE_NUSCENES["model"]["params"][
        "first_stage_config"], lpips_apply=lp_cpu)
    draw_weights(torch, lat_cpu.decoder, SEED + 2)
    lp, disc = copy_to(lp_cpu, dev), copy_to(disc_cpu, dev)
    lat = LatentLPIPS(decoder_config=INFERENCE_NUSCENES["model"]["params"]["first_stage_config"],
                      lpips_apply=lp)
    lat.decoder.load_state_dict(lat_cpu.decoder.state_dict())
    lat = lat.to(dev).eval()
    cases = {"lpips": (lp, lp_cpu, (x, y)), "discriminator": (disc, disc_cpu, (x,)),
             "latent_lpips": (lambda a, b: lat(a, b)[0], lambda a, b: lat_cpu(a, b)[0],
                              (z_in, z_pred))}
    rec = {"phase": "vae_losses", "card": card, "tol": LOSS_TOL, "pairs": LPIPS_PAIRS,
           "image_hw": list(PERCEPTION_HW), "latent": list(latent)}
    with torch.inference_mode():
        for name, (fn, fn_cpu, args) in cases.items():
            dargs = [a.to(dev) for a in args]
            got = fn(*dargs)
            want = fn_cpu(*args)
            rec[f"{name}_rel_err"] = ((got.cpu() - want).abs().max()
                                      / want.abs().max()).item()
            rec[f"{name}_ms"] = time_ms(torch, lambda: fn(*dargs), 3)
    log(rec)
    if not max(v for k, v in rec.items() if k.endswith("rel_err")) <= LOSS_TOL:
        raise AssertionError(f"the VAE's losses on the card disagree with the CPU: {rec}")


def copy_to(module, dev):
    """A copy of ``module`` on ``dev`` (the CPU original stays)."""
    import copy

    return copy.deepcopy(module).to(dev).eval()


def zoo_phase(torch, F, np, dev, fa, gg, tol, card: str) -> dict:
    """Phase 15 (a) to (e). Returns the counts of its paths and the fp32
    flash records at the dense shapes."""
    t0 = time.perf_counter()
    recs = [check_flash(torch, F, fa, tol, dev, *shape, fp32=True) for shape in ZOO_FLASH]
    recs.append(check_flash(torch, F, fa, tol, dev, 3, 900, 12288 + 17, 8, 32, timed=False,
                            fp32=True, lens=[12288 + 17, 1, 6001]))
    for rec in recs:
        if (rec["route"], rec["fp32_kernel"]) != ("fp32", "tc32"):
            raise AssertionError(f"the dense cross-attention took route {rec['route']}, "
                                 f"kernel {rec['fp32_kernel']}: {rec}")
    free(torch)
    paths = {"perception_petr_window": zoo_window_phase(torch, np, dev, fa, gg, card)}
    free(torch)
    paths.update(zoo_dn_motion_phase(torch, np, dev, fa, gg, card))
    free(torch)
    paths["perception_zoo_cli"] = zoo_cli_phase(torch, np, fa, gg, card)
    free(torch)
    zoo_losses_phase(torch, np, dev, card)
    free(torch)
    log({"phase": "perception_zoo_total", "seconds": time.perf_counter() - t0})
    return {"paths": paths, "flash": recs}


# --------------------------------------------------------------------------
# phase 16: training the dense-attention PETR family
# --------------------------------------------------------------------------


def ztrain_counts_ok(c, fwd: int, bwd: int) -> bool:
    """``fwd`` fp32 flash forwards and ``bwd`` backwards, all on ``tc32``,
    none on the FMA kernels, and nothing else launched."""
    return (c["flash_attention"] == c["flash_routes"]["fp32"] == c["flash_fp32_kernels"]["tc32"]
            == fwd and c["flash_attention_bwd"] == c["flash_bwd_routes"]["fp32"]
            == c["flash_bwd_fp32_kernels"]["tc32"] == bwd
            and c["flash_fp32_kernels"]["fma"] == c["flash_bwd_fp32_kernels"]["fma"] == 0
            and c["geglu"] == c["geglu_bwd"] == 0)


def ztrain_steps(torch, np, dev, fa, gg, card: str, name: str, setup, steps: int,
                 want_shapes: dict, want_bwd: int, profile: bool = False):
    """``steps`` training steps of ``setup`` (the window recipe, bs 2):
    s/step with its split, peak memory, every loss term, the fp32 flash
    calls by shape and the launches of each step (all on ``tc32``; the
    counts zeroed before the step and read after it), the frozen stem and
    first stage and every batch-norm statistic bit-equal after the steps;
    with ``profile`` one profiled step. Returns one step's counts."""
    state, trainer, model = setup["state"], setup["trainer"], setup["model"]
    frozen = {k: v.detach().clone() for k, v in model.named_parameters() if not v.requires_grad}
    frozen.update({k: v.clone() for k, v in model.named_buffers()})
    splits, times, metrics, counts, shapes = [], [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        split = {}
        off = ptrain_timers(torch, setup, split)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = ptrain_batch(setup, dev, PERCEPTION_T + 2 * i)
        split["host_data_targets_s"] = time.perf_counter() - t0
        reset_counts(fa, gg)
        with flash_shapes() as calls:
            out = trainer.step(state, *batch, generator=setup["generator"])
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(read_counts(fa, gg))
        shapes.append(dict(calls))
        off()
        splits.append(split)
        metrics.append(out.metrics)
    peak = torch.cuda.max_memory_allocated() / 1e9
    now = dict(list(model.named_parameters()) + list(model.named_buffers()))
    same = all(bool(torch.equal(v, now[k])) for k, v in frozen.items())
    steady = sorted(times[1:])
    median = steady[len(steady) // 2]
    want_fwd = sum(want_shapes.values())
    rec = {"phase": name, "card": card, "backbone": model.backbone_type,
           "head": model.head_type, "batch": setup["bs"], "frames": setup["ql"],
           "image_hw": list(PERCEPTION_HW), "cams": 6, "dn_queries": PTRAIN_MAX_GT * 10,
           "params": sum(p.numel() for p in model.parameters()),
           "trained_params": sum(p.numel() for p in state.params.values()),
           "first_step_s": times[0], "s_per_step": median, "step_s": times,
           "split_s_median_step": splits[1 + times[1:].index(median)],
           "split_s_first_step": splits[0], "peak_mem_gb": peak, "losses": metrics,
           "flash_calls_by_shape": shapes, "expected_flash_calls_by_shape": want_shapes,
           "launches_per_step": counts, "expected_flash_fwd": want_fwd,
           "expected_flash_bwd": want_bwd, "frozen_tensors": len(frozen),
           "frozen_bit_equal": same}
    log(rec)
    if not (all(np.isfinite(v) for m in metrics for v in m.values()) and same):
        raise AssertionError(f"{name}: a loss term is not finite or a frozen tensor moved: {rec}")
    for c, sh in zip(counts, shapes):
        if sh != want_shapes or not ztrain_counts_ok(c, want_fwd, want_bwd):
            raise AssertionError(f"{name}: a step made {sh} / {c}, not {want_shapes} with "
                                 f"{want_bwd} backward launches, all on tc32: {rec}")
    if profile:
        batch = ptrain_batch(setup, dev, PERCEPTION_T)
        profile_step(torch, lambda: trainer.step(state, *batch, generator=setup["generator"]),
                     name=f"profile_{name}_step", grad=True)
    return counts[-1]


def ztrain_window_phase(torch, np, dev, fa, gg, card: str):
    """(b) PetrWindow3D (r50 + StreamPETRHead) at the window recipe,
    ZTRAIN_STEPS steps and one profiled: each history frame's 6
    self-attention (Sq 900, Skv 1,668) and 6 cross-attention (Skv 12,288)
    calls, the grad frame's 6 cross-attention calls with the DN queries
    (Sq 900 + 640) forward and backward; its self-attention with the DN
    mask stays plain fp32."""
    setup = ptrain_setup(torch, np, dev, params=ZTRAIN_PETR)
    layers, q, tokens, keys = zoo_geometry(setup["model"], 8)
    hist = layers * (PERCEPTION_T - 1)
    want = {f"{q}x{tokens}": hist, f"{q}x{keys}": hist,
            f"{q + PTRAIN_MAX_GT * 10}x{tokens}": layers}
    return ztrain_steps(torch, np, dev, fa, gg, card, "perception_zoo_train", setup,
                        ZTRAIN_STEPS, want, layers, profile=True)


def ztrain_vovnet_phase(torch, np, dev, fa, gg, card: str):
    """(d) VoVNet-99 (each OSA block recomputed in the backward) +
    PETRHeadDN at the window recipe, 2 steps: the history frames' 6
    cross-attention calls to the 3,072 stride-16 tokens (the self-attention
    over the 644 queries on SDPA), the grad frame's with the DN queries
    (644 + 640) forward and backward."""
    setup = ptrain_setup(torch, np, dev, params=ZTRAIN_VOVNET)
    layers, q, tokens, _ = zoo_geometry(setup["model"], 16)
    want = {f"{q}x{tokens}": layers * (PERCEPTION_T - 1),
            f"{q + PTRAIN_MAX_GT * 10}x{tokens}": layers}
    return ztrain_steps(torch, np, dev, fa, gg, card, "perception_zoo_train_vovnet_petr_dn",
                        setup, 2, want, layers)


def ztrain_motion_phase(torch, np, dev, fa, gg, card: str):
    """(e) Petr3DP (r50 + PETRMotionHead) at the streaming recipe with the
    ground truth's futures, 2 steps at bs 2 with the memory carried: every
    loss term finite, ``loss_traj`` among them, the trajectory branch's
    weights moved, the grad frame's 6 cross-attention calls forward and
    backward on ``tc32``."""
    setup = ptrain_setup(torch, np, dev, recipe=PTRAIN_STREAM_RECIPE, params=ZTRAIN_MOTION)
    model = setup["model"]
    traj = {k: v.detach().clone() for k, v in model.named_parameters()
            if k.startswith("pts_bbox_head.traj_branches.")}
    rec, counts = ptrain_stream_steps(torch, np, dev, fa, gg, card, setup,
                                      "perception_zoo_train_petr3dp")
    now = dict(model.named_parameters())
    moved = {k: not bool(torch.equal(v, now[k])) for k, v in traj.items()}
    layers = len(model.pts_bbox_head.transformer.decoder.layers)
    log({"phase": "perception_zoo_train_petr3dp_traj", "card": card,
         "traj_branch_moved": moved})
    if not (all("loss_traj" in m for m in rec["losses"]) and moved and all(moved.values())
            and min(rec["future_steps_valid"]) > 0
            and all(ztrain_counts_ok(c, layers, layers) for c in rec["launches"])):
        raise AssertionError(f"Petr3DP's training with trajectories went wrong: {rec}, "
                             f"the trajectory branch moved: {moved}")
    return counts


def ztrain_cli_phase(torch, np, fa, gg, card: str):
    """(f) ``train_perception_torch.py --synthetic --steps 2`` on the card
    from a written YAML: the streaming recipe with the motion head at full
    width (bs 2, 256 x 512), each step's 6 cross-attention calls with the
    640 DN queries forward and backward on ``tc32``. (``--tiny``'s heads
    of dim 4 have no kernel route, so its DN cross-attention runs on the
    CPU only, as the JAX CLI's ``--tiny`` does.)"""
    import yaml

    from panacea_tpu_torch.configs import PERCEPTION
    from panacea_tpu_torch.perception import train_cli

    with tempfile.TemporaryDirectory() as tmp:
        cfg = json.loads(json.dumps(PERCEPTION[PTRAIN_STREAM_RECIPE]))
        cfg["perception"]["detector"]["params"].update(ZTRAIN_MOTION)
        config = os.path.join(tmp, "motion.yaml")
        with open(config, "w") as f:
            yaml.safe_dump(cfg, f)
        reset_counts(fa, gg)
        t0 = time.perf_counter()
        run = train_cli.main(["--synthetic", "--steps", "2", "--config", config,
                              "--workdir", tmp])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    counts = read_counts(fa, gg)
    calls = 2 * len(run["state"].model.pts_bbox_head.transformer.decoder.layers)
    rec = {"phase": "perception_zoo_train_cli", "card": card, "seconds": cli_s,
           "steps": run["steps"], "final_metrics": run["final_metrics"], "launches": counts,
           "expected_flash_fwd_bwd": calls}
    log(rec)
    if not (run["steps"] == 2 and "loss_traj" in run["final_metrics"]
            and all(np.isfinite(v) for v in run["final_metrics"].values())
            and ztrain_counts_ok(counts, calls, calls)):
        raise AssertionError(f"the training CLI with the motion head went wrong: {rec}")
    return counts


def ztrain_phase(torch, F, np, dev, fa, gg, tol, card: str) -> dict:
    """Phase 16 (a) to (f). Returns the counts of its paths and the
    records of the ``tc32`` backward at the dense shapes."""
    t0 = time.perf_counter()
    recs = [check_flash_bwd(torch, F, fa, tol, dev, *shape, merged_kv=False, fp32=True)
            for shape in ZTRAIN_BWD]
    free(torch)
    paths = {"perception_zoo_train": ztrain_window_phase(torch, np, dev, fa, gg, card)}
    free(torch)
    if not BESIDE_RANKS["card_vs_cpu"]:
        ptrain_card_vs_cpu(torch, np, dev, card, params=ZTRAIN_PETR,
                           name="perception_zoo_train_card_vs_cpu")
        free(torch)
    paths["perception_zoo_train_vovnet_petr_dn"] = ztrain_vovnet_phase(torch, np, dev, fa, gg,
                                                                       card)
    free(torch)
    paths["perception_zoo_train_petr3dp"] = ztrain_motion_phase(torch, np, dev, fa, gg, card)
    free(torch)
    paths["perception_zoo_train_cli"] = ztrain_cli_phase(torch, np, fa, gg, card)
    log({"phase": "perception_zoo_train_total", "seconds": time.perf_counter() - t0})
    return {"paths": paths, "bwd": recs}


# --------------------------------------------------------------------------
# phase 17: EVA-02, the proposal-query heads and FocalHead's token selection
# --------------------------------------------------------------------------


@contextlib.contextmanager
def sdpa_seconds(torch):
    """Adds the synchronised wall time of every ``attention_sdpa`` call the
    router makes (EVA's self-attention) to ``out["s"]`` while the block
    runs, and counts the calls."""
    from panacea_tpu_torch.ops import attention as pattn

    out, sdpa = {"s": 0.0, "calls": 0}, pattn.attention_sdpa

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sdpa(*a, **kw)
        torch.cuda.synchronize()
        out["s"] += time.perf_counter() - t0
        out["calls"] += 1
        return res

    pattn.attention_sdpa = timed
    try:
        yield out
    finally:
        pattn.attention_sdpa = sdpa


def timed_window(torch, fa, gg, model, imgs, data):
    """One window after a first one: (outs, memory, s/window, its split
    into backbone and head, peak memory, launch counts, flash calls by
    shape); then the split of a third window with EVA's ``attention_sdpa``
    calls timed apart."""
    split = {"backbone_s": 0.0, "head_s": 0.0}
    model.extract_feats = split_timer(torch, split, "backbone_s", model.extract_feats)
    model.pts_bbox_head.forward = split_timer(torch, split, "head_s",
                                              model.pts_bbox_head.forward)
    with torch.inference_mode():
        model(imgs, data)
        torch.cuda.synchronize()
        split.update(dict.fromkeys(split, 0.0))
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, gg)
        with flash_shapes() as shapes:
            t0 = time.perf_counter()
            outs, memory = model(imgs, data)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        counts = read_counts(fa, gg)
        window_split = dict(split)
        with sdpa_seconds(torch) as sdpa:
            model(imgs, data)
    del model.extract_feats, model.pts_bbox_head.forward
    return {"outs": outs, "memory": memory, "s_per_window": window_s, "split_s": window_split,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
            "flash_calls_by_shape": dict(shapes), "eva_sdpa_s_synced": sdpa["s"],
            "eva_sdpa_calls": sdpa["calls"]}


def eva_window_phase(torch, np, dev, fa, gg, card: str):
    """(b) The eval CLI's EVAViT (num_levels 4) + SparseHead on one window of
    PERCEPTION_T frames: s/window and its split, peak memory, the flash
    calls by shape (the head's self-attention, all on ``tc32``; EVA's on
    SDPA), card against CPU over two frames; EVA's attention timed apart
    and one profiled window. Returns the window's counts."""
    model, cpu = zoo_model(torch, dev, "StreamPETRWindow", **EVA_B)
    imgs, data = perception_window(torch, np, dev, PERCEPTION_T)
    run = timed_window(torch, fa, gg, model, imgs, data)
    outs = run.pop("outs")
    layers, q, _, keys = zoo_geometry(model, 8)
    want_shapes = {f"{q}x{keys}": layers * PERCEPTION_T}
    worst, _ = frames_card_vs_cpu(torch, model, cpu, imgs, data, 2,
                                  ("all_cls_scores", "all_bbox_preds"))
    prof = profile_step(torch, lambda: model(imgs, data), name="profile_eva_window")
    rec = {"phase": "perception_eva_sparse_window", "card": card, "backbone": "eva",
           "head": "sparse", "frames": PERCEPTION_T, "image_hw": list(PERCEPTION_HW),
           "eva_params": sum(p.numel() for p in model.img_backbone.parameters()),
           "params": sum(p.numel() for p in model.parameters()),
           **{k: v for k, v in run.items() if k != "memory"},
           "eva_sdpa_share_synced": run["eva_sdpa_s_synced"] / run["s_per_window"],
           "profile_sdpa_ms": prof["bucket_ms"].get("sdpa", "not measured"),
           "profile_device_ms": prof["device_ms"],
           "expected_flash_calls_by_shape": want_shapes,
           "finite": all(bool(torch.isfinite(v).all()) for v in outs.values()),
           "card_vs_cpu_t2": worst, "tol": PERCEPTION_TOL}
    log(rec)
    if not (rec["finite"] and run["flash_calls_by_shape"] == want_shapes
            and ztrain_counts_ok(run["launches"], layers * PERCEPTION_T, 0)
            and run["eva_sdpa_calls"] == 12 * PERCEPTION_T
            and max(worst.values()) <= PERCEPTION_TOL):
        raise AssertionError(f"EVA + SparseHead went wrong: {rec}")
    return run["launches"]


def eva_large_phase(torch, np, dev, fa, gg, card: str):
    """(c) EVA-02-L's widths + StreamPETRHead on one window: s/window,
    peak memory, the cross-attention to the 49,152 stride-4 tokens and the
    self-attention (Skv 1,668), 48 launches each, all on ``tc32``; outputs
    finite."""
    from panacea_tpu_torch.perception import detector

    model = detector.PetrWindow3D(**EVA_L).to(dev).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    imgs, data = perception_window(torch, np, dev, PERCEPTION_T)
    run = timed_window(torch, fa, gg, model, imgs, data)
    outs = run.pop("outs")
    layers, q, tokens, keys = zoo_geometry(model, 4)
    n = layers * PERCEPTION_T
    want_shapes = {f"{q}x{tokens}": n, f"{q}x{keys}": n}
    rec = {"phase": "perception_eva_l_petr_window", "card": card, "backbone": "eva (EVA-02-L)",
           "head": "petr", "frames": PERCEPTION_T,
           "eva_params": sum(p.numel() for p in model.img_backbone.parameters()),
           "params": sum(p.numel() for p in model.parameters()),
           **{k: v for k, v in run.items() if k != "memory"},
           "eva_sdpa_share_synced": run["eva_sdpa_s_synced"] / run["s_per_window"],
           "expected_flash_calls_by_shape": want_shapes,
           "finite": all(bool(torch.isfinite(v).all()) for v in outs.values())}
    log(rec)
    if not (rec["finite"] and run["flash_calls_by_shape"] == want_shapes
            and ztrain_counts_ok(run["launches"], 2 * n, 0)):
        raise AssertionError(f"EVA-02-L + StreamPETRHead went wrong: {rec}")
    return run["launches"]


def proposal_data(torch, data, dev, frames: int, c: int = 256, seed: int = SEED):
    """``data`` with PROPOSALS random proposals a frame: positions in the
    point-cloud range, features (B, T, P, 2C); drawn on the host."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((1, frames, PROPOSALS, 3), generator=g) * 80.0 - 40.0
    pos[..., 2] = pos[..., 2] / 40.0 * 2.0 - 1.0
    feats = torch.randn((1, frames, PROPOSALS, 2 * c), generator=g)
    return dict(data, proposal_positions=pos.to(dev), proposal_features=feats.to(dev))


def proposal_phase(torch, np, dev, fa, gg, card: str):
    """(d) ``Sparse4Dv3`` (r50 + SparseHeadv3) and a ``sparse_v4`` head
    streaming two frames with PROPOSALS proposals, card against CPU (each
    frame's CPU run from the card's memory); then ``PetrWindow3D``'s head
    on one frame restricted to FocalHead's top half of its 12,288 stride-8
    tokens, card against CPU with the CPU's indices given to both. Returns
    the counts of the three paths."""
    from panacea_tpu_torch.perception.focal_head import FocalHead
    from panacea_tpu_torch.perception.head import init_memory

    paths = {}
    imgs, data = perception_window(torch, np, dev, 2)
    data = proposal_data(torch, data, dev, 2)
    keys = ("all_cls_scores", "all_bbox_preds")
    for name, cls_name, kw, q in (
            ("perception_sparse4dv3_stream", "Sparse4Dv3", {}, PROPOSALS + 256),
            ("perception_sparse_v4_stream", "Sparse4D", {"head_type": "sparse_v4"}, 644 + 256)):
        model, cpu = zoo_model(torch, dev, cls_name, **kw)
        with torch.inference_mode():
            model.stream(imgs[:, 0], {k: v[:, 0] for k, v in data.items()})   # first use
            torch.cuda.synchronize()
            reset_counts(fa, gg)
            frame_s, mem = [], None
            with flash_shapes() as shapes:
                for fi in range(2):
                    t0 = time.perf_counter()
                    outs, mem = model.stream(imgs[:, fi], {k: v[:, fi] for k, v in data.items()},
                                             mem)
                    torch.cuda.synchronize()
                    frame_s.append(time.perf_counter() - t0)
            paths[name] = counts = read_counts(fa, gg)
        worst, _ = frames_card_vs_cpu(torch, model, cpu, imgs, data, 2, keys)
        layers = len(model.pts_bbox_head.transformer.decoder.layers)
        want_shapes = {f"{q}x{q + model.memory_len - model.num_propagated}": 2 * layers}
        rec = {"phase": name, "card": card, "detector": cls_name, "head": model.head_type,
               "proposals": PROPOSALS, "frames": 2, "s_per_frame": frame_s, "launches": counts,
               "flash_calls_by_shape": dict(shapes),
               "expected_flash_calls_by_shape": want_shapes,
               "scores_shape": list(outs["all_cls_scores"].shape),
               "finite": all(bool(torch.isfinite(v).all()) for v in outs.values()),
               "card_vs_cpu_t2": worst, "tol": PERCEPTION_TOL}
        log(rec)
        if not (rec["finite"] and dict(shapes) == want_shapes
                and ztrain_counts_ok(counts, 2 * layers, 0)
                and max(worst.values()) <= PERCEPTION_TOL):
            raise AssertionError(f"{cls_name} with {PROPOSALS} proposals went wrong: {rec}")
        del model, cpu
        free(torch)

    model, cpu = zoo_model(torch, dev, "PetrWindow3D")
    g = torch.Generator().manual_seed(SEED + 3)
    focal_cpu = FocalHead(in_channels=model.embed_dims, infer_ratio=FOCAL_RATIO)
    with torch.no_grad():
        for prm in focal_cpu.parameters():
            prm.add_(torch.randn(prm.shape, generator=g) * 0.02)
    focal = copy_to(focal_cpu, dev)
    d0 = {k: v[:, 0] for k, v in data.items() if not k.startswith("proposal_")}
    level = model.pts_bbox_head.feat_level
    with torch.inference_mode():
        feats = model.extract_feats(imgs[:, 0])
        got_f = focal(feats[level], 6)
        feats_cpu = cpu.extract_feats(imgs[:, 0].cpu())
        want_f = focal_cpu(feats_cpu[level], 6)
        topk = want_f["topk_indexes"]
        mem = init_memory(1, model.memory_len, model.embed_dims, device=dev)
        reset_counts(fa, gg)
        with flash_shapes() as shapes:
            outs, _ = model.pts_bbox_head(feats, mem, d0, PERCEPTION_HW,
                                          topk_indexes=topk.to(dev))
            torch.cuda.synchronize()
        paths["perception_petr_focal_topk"] = counts = read_counts(fa, gg)
        want, _ = cpu.pts_bbox_head(feats_cpu, type(mem)(*(m.cpu() for m in mem)),
                                    {k: v.cpu() for k, v in d0.items()}, PERCEPTION_HW,
                                    topk_indexes=topk)
    worst = {k: ((outs[k].cpu() - want[k]).abs().max() / want[k].abs().max()).item()
             for k in keys}
    worst.update({f"focal_{k}": ((got_f[k].cpu() - want_f[k]).abs().max()
                                 / want_f[k].abs().max()).item()
                  for k in ("enc_cls_scores", "enc_bbox_preds", "pred_centers2d", "centerness")})
    same_idx = (got_f["topk_indexes"].cpu() == topk).float().mean().item()
    layers, q, tokens, _ = zoo_geometry(model, 8)
    k = int(tokens * FOCAL_RATIO)
    want_shapes = {f"{q}x{k}": layers, f"{q}x{q + model.memory_len - model.num_propagated}": layers}
    rec = {"phase": "perception_petr_focal_topk", "card": card, "tokens": tokens, "kept": k,
           "topk_shape": list(topk.shape), "topk_same_position_share_card_cpu": same_idx,
           "launches": counts, "flash_calls_by_shape": dict(shapes),
           "expected_flash_calls_by_shape": want_shapes, "card_vs_cpu": worst,
           "tol": PERCEPTION_TOL}
    log(rec)
    if not (list(topk.shape) == [1, k, 1] and dict(shapes) == want_shapes
            and ztrain_counts_ok(counts, 2 * layers, 0) and max(worst.values()) <= PERCEPTION_TOL):
        raise AssertionError(f"the PETR head on FocalHead's tokens went wrong: {rec}")
    return paths


def eva_train_phase(torch, np, dev, fa, gg, card: str):
    """(e) EVA (the CLI's widths) + SparseHeadv3 at the window recipe
    through ``DetectorTrainer.step``, 2 steps: s/step and its split, peak
    memory, every loss term finite, the fp32 flash calls by shape (the
    history frames' self-attention on ``tc32``; the grad frame's with the
    DN mask plain fp32, EVA's on SDPA); then one step's loss terms at bs 1
    over 2 frames, card against CPU with the CPU's assignment."""
    params = dict(EVA_B, head_type="sparse_v3")
    setup = ptrain_setup(torch, np, dev, params=params)
    layers, q, _, keys = zoo_geometry(setup["model"], 8)
    counts = ztrain_steps(torch, np, dev, fa, gg, card, "perception_eva_train", setup, 2,
                          {f"{q}x{keys}": layers * (PERCEPTION_T - 1)}, 0)
    del setup
    free(torch)
    if not BESIDE_RANKS["card_vs_cpu"]:
        ptrain_card_vs_cpu(torch, np, dev, card, params=params,
                           name="perception_eva_train_card_vs_cpu")
    return counts


def eva_cli_phase(torch, np, fa, gg, card: str):
    """(f) The training CLI for 2 steps at full width from a written YAML
    with EVA (the CLI's widths) and SparseHeadv3 at the window recipe: each
    step's history frames' self-attention on ``tc32`` (the grad frame's,
    with the DN mask, plain fp32); then ``perception.eval.main --synthetic
    --backbone eva --num_levels 4 --head sparse_v3 --num_samples 2`` at
    full width: every frame's self-attention on ``tc32``. The counts are
    zeroed before each CLI and read after it."""
    import yaml

    from panacea_tpu_torch.configs import PERCEPTION
    from panacea_tpu_torch.perception import eval as peval
    from panacea_tpu_torch.perception import train_cli

    with tempfile.TemporaryDirectory() as tmp:
        cfg = json.loads(json.dumps(PERCEPTION[PTRAIN_RECIPE]))
        cfg["perception"]["detector"]["params"].update(
            {k: v for k, v in EVA_B.items() if k != "backbone_cfg"}, head_type="sparse_v3")
        config = os.path.join(tmp, "eva_v3.yaml")
        with open(config, "w") as f:
            yaml.safe_dump(cfg, f)
        reset_counts(fa, gg)
        t0 = time.perf_counter()
        with flash_shapes() as train_shapes:
            run = train_cli.main(["--synthetic", "--steps", "2", "--config", config,
                                  "--workdir", tmp])
            torch.cuda.synchronize()
        train_s, train_counts = time.perf_counter() - t0, read_counts(fa, gg)
    layers, q, _, keys = zoo_geometry(run["state"].model, 8)
    train_want = {f"{q}x{keys}": 2 * layers * (PERCEPTION_T - 1)}
    windows, eval_frames = 2, 4
    eval_want = {f"{q}x{keys}": windows * eval_frames * layers}
    reset_counts(fa, gg)
    t0 = time.perf_counter()
    with flash_shapes() as eval_shapes:
        metrics = peval.main(["--synthetic", "--backbone", "eva", "--num_levels", "4",
                              "--head", "sparse_v3", "--num_samples", str(windows)])
        torch.cuda.synchronize()
    eval_s, eval_counts = time.perf_counter() - t0, read_counts(fa, gg)
    rec = {"phase": "perception_eva_cli", "card": card, "image_hw": list(PERCEPTION_HW),
           "train_seconds": train_s, "train_steps": run["steps"],
           "train_final_metrics": run["final_metrics"], "train_launches": train_counts,
           "train_flash_calls_by_shape": dict(train_shapes),
           "expected_train_flash_calls_by_shape": train_want, "eval_seconds": eval_s,
           "eval_windows": windows, "eval_metrics": metrics, "eval_launches": eval_counts,
           "eval_flash_calls_by_shape": dict(eval_shapes),
           "expected_eval_flash_calls_by_shape": eval_want}
    log(rec)
    if not (run["steps"] == 2 and all(np.isfinite(v) for v in run["final_metrics"].values())
            and all(np.isfinite(v) for v in metrics.values())
            and dict(train_shapes) == train_want and dict(eval_shapes) == eval_want
            and ztrain_counts_ok(train_counts, sum(train_want.values()), 0)
            and ztrain_counts_ok(eval_counts, sum(eval_want.values()), 0)):
        raise AssertionError(f"the CLIs with EVA and SparseHeadv3 went wrong: {rec}")
    return train_counts


def eva_phase(torch, F, np, dev, fa, gg, tol, card: str) -> dict:
    """Phase 17 (a) to (f). Returns the counts of its paths and the fp32
    flash records at its new shapes."""
    t0 = time.perf_counter()
    recs = [check_flash(torch, F, fa, tol, dev, *shape, fp32=True) for shape in EVA_FLASH]
    for rec in recs:
        if (rec["route"], rec["fp32_kernel"]) != ("fp32", "tc32"):
            raise AssertionError(f"a new shape took route {rec['route']}, kernel "
                                 f"{rec['fp32_kernel']}: {rec}")
    free(torch)
    paths = {"perception_eva_sparse_window": eva_window_phase(torch, np, dev, fa, gg, card)}
    free(torch)
    paths["perception_eva_l_petr_window"] = eva_large_phase(torch, np, dev, fa, gg, card)
    free(torch)
    paths.update(proposal_phase(torch, np, dev, fa, gg, card))
    free(torch)
    paths["perception_eva_train"] = eva_train_phase(torch, np, dev, fa, gg, card)
    free(torch)
    paths["perception_eva_cli"] = eva_cli_phase(torch, np, fa, gg, card)
    log({"phase": "perception_eva_total", "seconds": time.perf_counter() - t0})
    return {"paths": paths, "flash": recs}


# --------------------------------------------------------------------------
# phase 18: the rest of the perception zoo (SimMOD, the joint heads,
# cascade RoI, YOLOX and their losses)
# --------------------------------------------------------------------------


def draw_zoo(torch, module, seed: int):
    """``draw_weights``, then every stored-statistics batch norm's scale at 1
    + 0.05 n (not 0.05 n), so that the deep towers keep their scale."""
    from panacea_tpu_torch.perception.resnet import FrozenBatchNorm

    draw_weights(torch, module, seed)
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, FrozenBatchNorm):
                mod.weight.add_(1.0)
    return module


@contextlib.contextmanager
def host_matches(record: list, replay: bool):
    """The DETR3D losses' host Hungarian matchings: appended to ``record``
    while the block runs, or with ``replay`` handed back from it in order,
    so that the card's loss takes the CPU's assignment."""
    from panacea_tpu_torch.perception import vestigial_train

    match, given = vestigial_train.hungarian_match, iter(list(record))

    def recorded(*a, **kw):
        record.append(match(*a, **kw))
        return record[-1]

    vestigial_train.hungarian_match = (lambda *a, **kw: next(given)) if replay else recorded
    try:
        yield
    finally:
        vestigial_train.hungarian_match = match


@contextlib.contextmanager
def given_topk(torch, idx):
    """The FCOS proposals' top-k at the indices ``idx`` (B, K) (the CPU's:
    the local-maximum scores tie at rounding noise)."""
    from panacea_tpu_torch.perception import fcos_proposal

    topk = fcos_proposal.topk_stable

    def given(x, k):
        i = idx.to(x.device)
        return torch.gather(x, -1, i), i

    fcos_proposal.topk_stable = given
    try:
        yield
    finally:
        fcos_proposal.topk_stable = topk


def to_dev(x, dev):
    """Tensors in ``x`` (nested tuples and lists) moved to ``dev``."""
    if isinstance(x, (list, tuple)):
        return type(x)(to_dev(v, dev) for v in x)
    return x.to(dev) if hasattr(x, "to") and hasattr(x, "shape") else x


def rel_diff(torch, got, want) -> float:
    return ((got.detach().cpu().double() - want.double()).abs().max()
            / want.double().abs().max().clamp(min=1e-12)).item()


def random_boxes2d(torch, g, shape, hw=PERCEPTION_HW):
    """xyxy boxes in image pixels, 16 to 128 wide and 16 to 96 high."""
    h, w = hw
    x1 = torch.rand(shape, generator=g) * (w - 144)
    y1 = torch.rand(shape, generator=g) * (h - 112)
    return torch.stack([x1, y1, x1 + 16 + torch.rand(shape, generator=g) * 112,
                        y1 + 16 + torch.rand(shape, generator=g) * 80], -1)


def gt3d(torch, np, g, n: int):
    """``n`` ground-truth boxes (1, n, 9) in the point-cloud range, labels (1, n)."""
    boxes = torch.cat([torch.rand((1, n, 2), generator=g) * 80 - 40,
                       torch.rand((1, n, 1), generator=g) * 2 - 2,
                       torch.rand((1, n, 3), generator=g) * 4 + 0.5,
                       torch.rand((1, n, 1), generator=g) * 6 - 3,
                       torch.randn((1, n, 2), generator=g)], -1)
    return boxes, torch.randint(0, 10, (1, n), generator=g)


def grads_finite(torch, module) -> dict:
    """Of the parameters that take a gradient: how many got one, and
    whether every one is finite."""
    got = [p.grad for p in module.parameters() if p.requires_grad and p.grad is not None]
    return {"with_grad": len(got),
            "without_grad": sum(1 for p in module.parameters() if p.grad is None),
            "finite": all(bool(torch.isfinite(t).all()) for t in got)}


def simmod_phase(torch, np, dev, fa, gg, card: str):
    """(b) SimMOD (r50, the FPN from C3 with 4 levels, FCOS with
    SIMMOD_PROPOSALS proposals, the 6-layer decoder) on one frame of 6
    cameras, with the deformable and then the two-stage cross-attention:
    s/frame and its split, peak memory, the self-attention over the
    proposals on SDPA (no flash launch). Card against CPU: the proposals'
    indices (at most SIMMOD_INDEX_SLACK ranks differ, near-ties; the scores
    at every rank within PERCEPTION_TOL); every piece of the decoder on the
    CPU's inputs of that piece within PERCEPTION_TOL (the input and position
    projections, each layer, each cls and reg branch, each box refinement,
    the score combination); and the whole decoder chained on the CPU's
    proposals, within PERCEPTION_TOL with the deformable attention. The
    two-stage decoder's chain amplifies rounding (its unnormalised sigmoid
    weights), so its chained difference is reported beside how far the
    CPU's own decoder moves when its proposal features move by 1e-6 of
    themselves, over SIMMOD_NUDGE_SEEDS draws. Returns the counts of each."""
    from panacea_tpu_torch.perception import simmod

    imgs, data = perception_window(torch, np, dev, 1)
    img, frame = imgs[:, 0], {k: v[:, 0] for k, v in data.items()}
    cpu_frame = {k: v.cpu() for k, v in frame.items()}
    paths = {}
    for cross in ("deformable", "twostage"):
        cpu = draw_zoo(torch, simmod.SimMOD(num_proposal=SIMMOD_PROPOSALS,
                                            head_cfg={"cross_attn": cross}), SEED)
        model = copy_to(cpu, dev)
        split = dict.fromkeys(("backbone_fpn_s", "fcos_head_s", "proposals_s", "decoder_s"), 0.0)
        model.extract_feats = split_timer(torch, split, "backbone_fpn_s", model.extract_feats)
        model.img_rpn_head.forward = split_timer(torch, split, "fcos_head_s",
                                                 model.img_rpn_head.forward)
        model.img_rpn_head.get_proposals = split_timer(torch, split, "proposals_s",
                                                       model.img_rpn_head.get_proposals)
        model.pts_bbox_head.forward = split_timer(torch, split, "decoder_s",
                                                  model.pts_bbox_head.forward)
        with torch.inference_mode():
            model(img, frame)                       # first use
            torch.cuda.synchronize()
            split.update(dict.fromkeys(split, 0.0))
            torch.cuda.reset_peak_memory_stats()
            reset_counts(fa, gg)
            with flash_shapes() as shapes:
                t0 = time.perf_counter()
                outs, props = model(img, frame)
                torch.cuda.synchronize()
                frame_s = time.perf_counter() - t0
            paths[f"perception_simmod_{cross}"] = counts = read_counts(fa, gg)
            frame_split = dict(split)
            del model.extract_feats, model.img_rpn_head.forward, model.img_rpn_head.get_proposals
            del model.pts_bbox_head.forward
            # every piece of the CPU's decoder, with its inputs and output
            head_c, head = cpu.pts_bbox_head, model.pts_bbox_head
            io, n_layers = [], len(head_c.transformer.decoder.layers)
            pieces = ["input_proj", "pos_proj"] + [
                f"{kind}.{i}" for kind in ("transformer.decoder.layers", "cls_branches",
                                           "reg_branches") for i in range(n_layers)]
            hooks = [head_c.get_submodule(name).register_forward_hook(
                lambda m, a, out, name=name: io.append((name, a, out))) for name in pieces]
            refine = head_c.refine
            head_c.refine = lambda *a: io.append(("refine", a, refine(*a))) or io[-1][2]
            want, want_props = cpu(img.cpu(), cpu_frame)
            for hook in hooks:
                hook.remove()
            del head_c.refine
            feats = model.extract_feats(img)
            on_cpu_props = head(feats, want_props["proposal_features"].to(dev),
                                want_props["proposal_positions"].to(dev), frame, PERCEPTION_HW,
                                proposal_scores=want_props["proposal_scores"].to(dev))
            # each piece on the card on the CPU's inputs of that piece
            on_card = {}
            for name, args, out in io:
                fn = head.refine if name == "refine" else head.get_submodule(name)
                got = fn(*to_dev(args, dev))
                kind = (name.rsplit(".", 1)[0] if name[-1].isdigit() else name).replace(
                    "transformer.decoder.layers", "decoder_layers")
                on_card.setdefault(kind, []).append(max(
                    rel_diff(torch, g, w) for g, w in zip(
                        *((got, out) if isinstance(out, tuple) else ((got,), (out,))))))
            on_card["combine_scores"] = [rel_diff(torch, simmod.combine_scores(
                want["all_cls_scores"].to(dev), want_props["proposal_scores"].to(dev)),
                want["all_cls_scores_combined"])]
            # how far the CPU's own chained decoder moves when its proposal
            # features move by 1e-6 of themselves
            feats_c = cpu.extract_feats(img.cpu())
            chain_keys = ("all_cls_scores", "all_bbox_preds", "all_cls_scores_combined")
            nudges = []
            for seed in range(SIMMOD_NUDGE_SEEDS):
                pf = want_props["proposal_features"]
                nudged = pf * (1.0 + 1e-6 * torch.randn(
                    pf.shape, generator=torch.Generator().manual_seed(seed)))
                moved = head_c(feats_c, nudged, want_props["proposal_positions"], cpu_frame,
                               PERCEPTION_HW, proposal_scores=want_props["proposal_scores"])
                nudges.append({k: rel_diff(torch, moved[k], want[k]) for k in chain_keys})
        same = (props["proposal_indices"].cpu() == want_props["proposal_indices"])
        chained = {k: rel_diff(torch, on_cpu_props[k], want[k]) for k in chain_keys}
        worst = {"proposal_scores": rel_diff(torch, props["proposal_scores"],
                                             want_props["proposal_scores"]),
                 **{f"{k}_max": max(v) for k, v in on_card.items()}}
        rec = {"phase": f"perception_simmod_{cross}", "card": card, "cross_attn": cross,
               "image_hw": list(PERCEPTION_HW), "cams": 6, "proposals": SIMMOD_PROPOSALS,
               "params": sum(p.numel() for p in model.parameters()), "s_per_frame": frame_s,
               "split_s": frame_split, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": counts, "flash_calls_by_shape": dict(shapes),
               "scores_shape": list(outs["all_cls_scores"].shape),
               "finite": all(bool(torch.isfinite(v).all()) for v in outs.values()
                             if v is not None),
               "proposal_index_differing": int((~same).sum()),
               "proposal_index_slack": SIMMOD_INDEX_SLACK,
               "card_vs_cpu": worst, "pieces_card_vs_cpu": on_card,
               "chained_decoder_card_vs_cpu": chained,
               "chained_held": cross == "deformable",
               "cpu_chained_moved_by_1e-6_nudges": nudges, "tol": PERCEPTION_TOL}
        log(rec)
        if not (rec["finite"] and rec["scores_shape"] == [6, 1, SIMMOD_PROPOSALS, 10]
                and not dict(shapes) and ztrain_counts_ok(counts, 0, 0)
                and rec["proposal_index_differing"] <= SIMMOD_INDEX_SLACK
                and len(on_card["refine"]) == n_layers
                and max(worst.values()) <= PERCEPTION_TOL
                and all(np.isfinite(v) for v in chained.values())
                and (cross != "deformable" or max(chained.values()) <= PERCEPTION_TOL)):
            raise AssertionError(f"SimMOD ({cross}) went wrong: {rec}")
        del model, cpu
        free(torch)
    return paths


def joint_model(torch, dev, cls_name: str, head: str):
    """A streaming detector of ``perception.detector`` with ``head`` of
    ``joint_head`` (the detector's full-width head config and QueryRoIHead
    at its defaults) on the card, its weights drawn from the seed by
    ``init_weights``; and the same weights on the CPU."""
    from panacea_tpu_torch.perception import detector, joint_head

    def build():
        m = getattr(detector, cls_name)()
        m.pts_bbox_head = getattr(joint_head, head)(
            num_classes=10, embed_dims=256, num_query=644, memory_len=1024,
            topk_proposals=256, num_propagated=256, num_decoder_layers=6, num_levels=5,
            num_cams=6, pc_range=m.pc_range)
        return m.eval()

    model = build().to(dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    cpu = build()
    cpu.load_state_dict(model.state_dict())
    return model, cpu


def joint_data(torch, data, dev, frames: int, seed: int = SEED):
    """``data`` with JOINT_PROPOSALS random 2D proposal boxes a camera (B, T,
    N, P, 4), all valid; drawn on the host."""
    g = torch.Generator().manual_seed(seed)
    boxes = random_boxes2d(torch, g, (1, frames, 6, JOINT_PROPOSALS))
    return dict(data, proposal_boxes=boxes.to(dev),
                proposal_valid=torch.ones(boxes.shape[:-1], device=dev))


def joint_phase(torch, np, dev, fa, gg, card: str):
    """(c) ``JointStreamPETRHead`` (on Petr3D) streaming two frames with
    JOINT_PROPOSALS proposals a camera lifted by QueryRoIHead (1024-wide RoI
    tower, 7 x 7 RoIAlign on the stride-16 level), then ``JointHead`` (on
    Sparse4D, 'seed'): s/frame, the lifting's share, the flash calls by
    shape, all on ``tc32``, card against CPU (each frame's CPU run from the
    card's memory). Returns the counts of both and the heads' shapes."""
    imgs, data = perception_window(torch, np, dev, 2)
    data = joint_data(torch, data, dev, 2)
    keys = ("all_cls_scores", "all_bbox_preds")
    paths, seen = {}, {}
    for name, cls_name, head in (("perception_joint_streampetr", "Petr3D", "JointStreamPETRHead"),
                                 ("perception_joint_sparse", "Sparse4D", "JointHead")):
        model, cpu = joint_model(torch, dev, cls_name, head)
        split = {"query_head_s": 0.0}
        qh = model.pts_bbox_head.query_head
        qh.forward = split_timer(torch, split, "query_head_s", qh.forward)
        with torch.inference_mode():
            model.stream(imgs[:, 0], {k: v[:, 0] for k, v in data.items()})   # first use
            torch.cuda.synchronize()
            split["query_head_s"] = 0.0
            reset_counts(fa, gg)
            frame_s, mem = [], None
            with flash_shapes() as shapes:
                for fi in range(2):
                    t0 = time.perf_counter()
                    outs, mem = model.stream(imgs[:, fi], {k: v[:, fi] for k, v in data.items()},
                                             mem)
                    torch.cuda.synchronize()
                    frame_s.append(time.perf_counter() - t0)
            paths[name] = counts = read_counts(fa, gg)
        del qh.forward
        worst, _ = frames_card_vs_cpu(torch, model, cpu, imgs, data, 2, keys)
        layers = len(model.pts_bbox_head.transformer.decoder.layers)
        if head == "JointStreamPETRHead":
            q = 6 * JOINT_PROPOSALS + model.num_propagated
            want_shapes = {f"{q}x{6 * (PERCEPTION_HW[0] // 8) * (PERCEPTION_HW[1] // 8)}": 2 * layers,
                           f"{q}x{q + model.memory_len - model.num_propagated}": 2 * layers}
        else:
            q = max(6 * JOINT_PROPOSALS, model.num_query) + model.num_propagated
            want_shapes = {f"{q}x{q + model.memory_len - model.num_propagated}": 2 * layers}
        seen[name] = dict(shapes)
        rec = {"phase": name, "card": card, "head": head, "frames": 2,
               "proposals_per_camera": JOINT_PROPOSALS, "queries": q,
               "params": sum(p.numel() for p in model.parameters()),
               "query_head_params": sum(p.numel() for p in qh.parameters()),
               "s_per_frame": frame_s, "query_head_s_two_frames": split["query_head_s"],
               "launches": counts, "flash_calls_by_shape": dict(shapes),
               "expected_flash_calls_by_shape": want_shapes,
               "scores_shape": list(outs["all_cls_scores"].shape),
               "finite": all(bool(torch.isfinite(v).all()) for v in outs.values()),
               "card_vs_cpu_t2": worst, "tol": PERCEPTION_TOL}
        log(rec)
        if not (rec["finite"] and dict(shapes) == want_shapes
                and ztrain_counts_ok(counts, sum(want_shapes.values()), 0)
                and max(worst.values()) <= PERCEPTION_TOL):
            raise AssertionError(f"{head} went wrong: {rec}")
        del model, cpu
        free(torch)
    return paths, seen


def fpn_feats(torch, np, dev):
    """The r50 + FPN levels (6, 256, h, w) of one frame of the eval window on
    the card, drawn as ``zoo_model`` draws, and a CPU copy of them."""
    model, _ = zoo_model(torch, dev, "StreamPETRWindow")
    imgs, _ = perception_window(torch, np, dev, 1)
    with torch.no_grad():   # not inference tensors: phase (e)'s heads train on them
        feats = model.extract_feats(imgs[:, 0])
    del model
    free(torch)
    return feats, [f.cpu() for f in feats]


def roi_boxes(torch, seed: int):
    """ROI_BOXES boxes on each of the 6 cameras, (6, P, 4), and a validity."""
    g = torch.Generator().manual_seed(seed)
    return random_boxes2d(torch, g, (6, ROI_BOXES)), torch.ones(6, ROI_BOXES)


def cascade_yolox_phase(torch, np, dev, fa, gg, card: str, feats, cpu_feats):
    """(d) ``CascadeRoIHead`` (3 stages, RoIAlign on the stride-16 level) with
    ROI_BOXES boxes a camera and ``YOLOXHead`` (strides 8, 16, 32) at their
    defaults on the FPN of the six cameras: ms a call, card against CPU on
    the card's features."""
    from panacea_tpu_torch.perception import cascade_roi, yolox_head

    boxes, valid = roi_boxes(torch, SEED + 4)
    cas_cpu = draw_zoo(torch, cascade_roi.CascadeRoIHead(), SEED + 5)
    yol_cpu = draw_zoo(torch, yolox_head.YOLOXHead(), SEED + 6)
    cas, yol = copy_to(cas_cpu, dev), copy_to(yol_cpu, dev)
    with torch.inference_mode():
        reset_counts(fa, gg)
        got_c = cas(feats[1], boxes.to(dev), valid.to(dev))
        got_y = yol(feats[:3])
        counts = read_counts(fa, gg)
        cas_ms = time_ms(torch, lambda: cas(feats[1], boxes.to(dev), valid.to(dev)), 5)
        yol_ms = time_ms(torch, lambda: yol(feats[:3]), 5)
        want_c = cas_cpu(cpu_feats[1], boxes, valid)
        want_y = yol_cpu(cpu_feats[:3])
    worst = {f"cascade_{k}": rel_diff(torch, got_c[k], want_c[k]) for k in ("cls_scores", "boxes")}
    worst.update({f"cascade_stage{s}_reg": rel_diff(torch, got_c["stage_reg"][s],
                                                     want_c["stage_reg"][s]) for s in range(3)})
    worst.update({f"yolox_{k}": rel_diff(torch, got_y[k], want_y[k])
                  for k in ("enc_cls_scores", "enc_bbox_preds", "objectnesses",
                            "pred_centers2d_offset")})
    rec = {"phase": "perception_cascade_yolox", "card": card, "boxes_per_camera": ROI_BOXES,
           "cascade_ms": cas_ms, "yolox_ms": yol_ms, "launches": counts,
           "cascade_params": sum(p.numel() for p in cas.parameters()),
           "yolox_params": sum(p.numel() for p in yol.parameters()),
           "yolox_priors": int(got_y["objectnesses"].shape[1]), "card_vs_cpu": worst,
           "tol": PERCEPTION_TOL}
    log(rec)
    if not (max(worst.values()) <= PERCEPTION_TOL and ztrain_counts_ok(counts, 0, 0)):
        raise AssertionError(f"CascadeRoIHead or YOLOXHead went wrong: {rec}")
    return counts


def loss_record(torch, name, card, got, want, module, counts, extra=None):
    terms = {k: abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-6)
             for k in want}
    rec = {"phase": name, "card": card, "batch": 1, "loss_card": {k: float(v)
                                                                 for k, v in got.items()},
           "loss_cpu": {k: float(v) for k, v in want.items()}, "rel_diff": terms,
           "tol": LOSS_TOL, "grads": grads_finite(torch, module), "launches": counts,
           **(extra or {})}
    log(rec)
    if not (max(terms.values()) <= LOSS_TOL and rec["grads"]["finite"]
            and rec["grads"]["with_grad"] > 0):
        raise AssertionError(f"{name}: the card's loss or gradients went wrong: {rec}")
    return rec


def rest_losses_phase(torch, np, dev, fa, gg, card: str, feats, cpu_feats):
    """(e) One backward of each family's loss at full width, B 1, each loss
    term card against CPU (LOSS_TOL; the CPU's host matchings, SimOTA
    targets, cascade stage inputs and FCOS top-k given to the card), every
    parameter's gradient finite: ``simmod_loss`` with the IoU3D branch
    (code size 11) plus ``fcos_loss``; ``joint_family_loss`` with
    JOINT_MAX_GT boxes of DN queries through ``JointStreamPETRHead`` (its 6
    cross-attention calls forward and backward on ``tc32``);
    ``cascade_roi_loss``; ``yolox_loss`` after ``simota_assign``. Returns
    the counts of each."""
    from panacea_tpu_torch.perception import (cascade_roi, denoise, fcos_proposal, joint_head,
                                              simmod, vestigial_train, yolox_head)
    from panacea_tpu_torch.perception.head import init_memory

    paths = {}
    g = torch.Generator().manual_seed(SEED + 7)
    boxes, labels = gt3d(torch, np, g, JOINT_MAX_GT)
    boxes_list, labels_list = [boxes[0].numpy()], [labels[0].numpy()]
    imgs, data = perception_window(torch, np, dev, 1)
    img, frame = imgs[:, 0], {k: v[:, 0] for k, v in data.items()}
    cpu_frame = {k: v.cpu() for k, v in frame.items()}

    # SimMOD: the decoder's and the FCOS head's losses
    cpu = draw_zoo(torch, simmod.SimMOD(num_proposal=SIMMOD_PROPOSALS,
                                        head_cfg={"code_size": 11}), SEED + 8)
    model = copy_to(cpu, dev)
    box2d = [random_boxes2d(torch, g, (5,)).numpy() for _ in range(6)]
    lab2d = [np.arange(5) % 10 for _ in range(6)]
    dep2d = [np.linspace(5.0, 40.0, 5) for _ in range(6)]
    matches = []
    with torch.no_grad():
        feats_c = cpu.extract_feats(img.cpu())
        rpn_c = cpu.img_rpn_head(feats_c)
        props_c = cpu.img_rpn_head.get_proposals(rpn_c, cpu_frame, 6)
        outs_c = cpu.pts_bbox_head(feats_c, props_c["proposal_features"],
                                   props_c["proposal_positions"], cpu_frame, PERCEPTION_HW,
                                   proposal_scores=props_c["proposal_scores"])
        sizes = [tuple(r["cls_score"].shape[-2:]) for r in rpn_c]
        fcos_t = fcos_proposal.fcos_targets(sizes, model.img_rpn_head.strides, box2d, lab2d,
                                            dep2d)
        with host_matches(matches, replay=False):
            want = simmod.simmod_loss(outs_c, boxes_list, labels_list, compute_loss_iou3d=True)
        want.update(fcos_proposal.fcos_loss(rpn_c, fcos_t))
    reset_counts(fa, gg)
    feats_d = model.extract_feats(img)
    rpn = model.img_rpn_head(feats_d)
    with given_topk(torch, props_c["proposal_indices"]):
        props = model.img_rpn_head.get_proposals(rpn, frame, 6)
    outs = model.pts_bbox_head(feats_d, props["proposal_features"], props["proposal_positions"],
                               frame, PERCEPTION_HW, proposal_scores=props["proposal_scores"])
    with host_matches(matches, replay=True):
        got = simmod.simmod_loss(outs, boxes_list, labels_list, compute_loss_iou3d=True)
    got.update(fcos_proposal.fcos_loss(rpn, fcos_t))
    (got["loss"] + sum(v for k, v in got.items() if k.startswith("fcos_"))).backward()
    torch.cuda.synchronize()
    paths["perception_simmod_train"] = counts = read_counts(fa, gg)
    loss_record(torch, "perception_simmod_loss_card_vs_cpu", card, got, want, model, counts,
                {"iou3d": True, "code_size": 11, "gt_boxes": JOINT_MAX_GT,
                 "fcos_pos": float(fcos_t[4])})
    del model, cpu, outs, rpn, feats_d
    free(torch)

    # the joint head with DN queries: forward and backward on tc32
    model, cpu = joint_model(torch, dev, "Petr3D", "JointStreamPETRHead")
    jdata = joint_data(torch, data, dev, 1, seed=SEED + 9)
    jframe = {k: v[:, 0] for k, v in jdata.items()}
    pack = denoise.prepare_dn(boxes, labels, num_query=6 * JOINT_PROPOSALS,
                              num_propagated=model.num_propagated, memory_len=model.memory_len,
                              pc_range=model.pc_range, scalar=10,
                              generator=torch.Generator().manual_seed(SEED + 10))
    pack_dev = denoise.DNPack(*(t.to(dev) if torch.is_tensor(t) else t for t in pack))
    matches = []
    with torch.no_grad():
        outs_c, _, _ = cpu.train_frame(img.cpu(), init_memory(1, cpu.memory_len, cpu.embed_dims),
                                       {k: v.cpu() for k, v in jframe.items()}, dn=pack)
        with host_matches(matches, replay=False):
            want = joint_head.joint_family_loss(outs_c, boxes_list, labels_list, dn_pack=pack,
                                                pc_range=model.pc_range)
    reset_counts(fa, gg)
    with flash_shapes() as shapes:
        t0 = time.perf_counter()
        outs, _, _ = model.train_frame(img, init_memory(1, model.memory_len, model.embed_dims,
                                                        device=dev), jframe, dn=pack_dev)
        with host_matches(matches, replay=True):
            got = joint_head.joint_family_loss(outs, boxes_list, labels_list, dn_pack=pack_dev,
                                               pc_range=model.pc_range)
        got["loss"].backward()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    paths["perception_joint_train"] = counts = read_counts(fa, gg)
    layers = len(model.pts_bbox_head.transformer.decoder.layers)
    sq = pack.pad_size + 6 * JOINT_PROPOSALS + model.num_propagated
    want_shapes = {f"{sq}x{6 * (PERCEPTION_HW[0] // 8) * (PERCEPTION_HW[1] // 8)}": layers}
    loss_record(torch, "perception_joint_loss_card_vs_cpu", card, got, want, model, counts,
                {"dn_pad": pack.pad_size, "fwd_bwd_s": step_s, "flash_calls_by_shape":
                 dict(shapes), "expected_flash_calls_by_shape": want_shapes})
    if not (dict(shapes) == want_shapes and ztrain_counts_ok(counts, layers, layers)):
        raise AssertionError(f"the joint head's DN step did not make {layers} tc32 forward and "
                             f"backward launches at {want_shapes}: {counts} {dict(shapes)}")
    del model, cpu, outs
    free(torch)

    # cascade RoI on the stride-16 level, the proposals near the boxes
    gt2d = [random_boxes2d(torch, g, (8,)).numpy() for _ in range(6)]
    gl2d = [np.arange(8) % 10 for _ in range(6)]
    near = torch.as_tensor(np.stack([b[np.arange(ROI_BOXES) % 8] for b in gt2d]))
    rois = (near + torch.randn(near.shape, generator=g) * 6.0).float()
    valid = torch.ones(6, ROI_BOXES)
    cpu = draw_zoo(torch, cascade_roi.CascadeRoIHead(), SEED + 11)
    model = copy_to(cpu, dev)
    with torch.no_grad():
        outs_c = cpu(cpu_feats[1], rois, valid)
        inputs = [rois.numpy()] + [b.numpy() for b in outs_c["stage_boxes"][:-1]]
        want = vestigial_train.cascade_roi_loss(outs_c["stage_cls"], outs_c["stage_reg"], inputs,
                                                valid.numpy(), gt2d, gl2d, 10)
    reset_counts(fa, gg)
    outs = model(feats[1], rois.to(dev), valid.to(dev))
    got = vestigial_train.cascade_roi_loss(outs["stage_cls"], outs["stage_reg"], inputs,
                                           valid.numpy(), gt2d, gl2d, 10)
    got["loss"].backward()
    torch.cuda.synchronize()
    paths["perception_cascade_train"] = counts = read_counts(fa, gg)
    loss_record(torch, "perception_cascade_loss_card_vs_cpu", card, got, want, model, counts)
    del model, cpu, outs

    # YOLOX after SimOTA on the CPU's outputs
    cpu = draw_zoo(torch, yolox_head.YOLOXHead(), SEED + 12)
    model = copy_to(cpu, dev)
    sizes = [tuple(f.shape[-2:]) for f in cpu_feats[:3]]
    priors = yolox_head.mlvl_priors(sizes, model.strides)
    with torch.no_grad():
        outs_c = cpu(cpu_feats[:3])
        dec = yolox_head.bbox_decode(priors, outs_c["enc_bbox_preds"]).numpy()
        targets = yolox_head.yolox_targets(
            priors, outs_c["enc_cls_scores"].numpy(), outs_c["objectnesses"].numpy(), dec, gt2d,
            gl2d, [(b[:, :2] + b[:, 2:]) / 2 for b in gt2d])
        want = yolox_head.yolox_loss(outs_c, priors, targets, use_l1=True)
    reset_counts(fa, gg)
    outs = model(feats[:3])
    got = yolox_head.yolox_loss(outs, priors, targets, use_l1=True)
    sum(got.values()).backward()
    torch.cuda.synchronize()
    paths["perception_yolox_train"] = counts = read_counts(fa, gg)
    loss_record(torch, "perception_yolox_loss_card_vs_cpu", card, got, want, model, counts,
                {"simota_positives": float(targets[-1])})
    return paths


def rest_zoo_phase(torch, F, np, dev, fa, gg, tol, card: str) -> dict:
    """Phase 18 (a) to (e). Returns the counts of its paths and the ``tc32``
    forward and backward records at its new shapes."""
    t0 = time.perf_counter()
    recs = [check_flash(torch, F, fa, tol, dev, *shape, fp32=True) for shape in JOINT_FLASH]
    for rec in recs:
        if (rec["route"], rec["fp32_kernel"]) != ("fp32", "tc32"):
            raise AssertionError(f"a new shape took route {rec['route']}, kernel "
                                 f"{rec['fp32_kernel']}: {rec}")
    bwd = [check_flash_bwd(torch, F, fa, tol, dev, *shape, merged_kv=False, fp32=True)
           for shape in JOINT_BWD]
    free(torch)
    paths = simmod_phase(torch, np, dev, fa, gg, card)
    free(torch)
    joint_paths, seen = joint_phase(torch, np, dev, fa, gg, card)
    paths.update(joint_paths)
    # a shape the heads gave that JOINT_FLASH lacks (JointHead's 900 x 1668)
    # is held against float64 here too, untimed
    heads = {s for shapes in seen.values() for s in shapes}
    tested = {f"{r['shape']['Sq']}x{r['shape']['Skv']}" for r in recs}
    for shape in sorted(heads - tested):
        sq, skv = map(int, shape.split("x"))
        rec = check_flash(torch, F, fa, tol, dev, 1, sq, skv, 8, 32, timed=False, fp32=True)
        if (rec["route"], rec["fp32_kernel"]) != ("fp32", "tc32"):
            raise AssertionError(f"the joint heads' shape {shape} took route {rec['route']}, "
                                 f"kernel {rec['fp32_kernel']}: {rec}")
    free(torch)
    feats, cpu_feats = fpn_feats(torch, np, dev)
    paths["perception_cascade_yolox"] = cascade_yolox_phase(torch, np, dev, fa, gg, card, feats,
                                                           cpu_feats)
    free(torch)
    if not BESIDE_RANKS["card_vs_cpu"]:
        paths.update(rest_losses_phase(torch, np, dev, fa, gg, card, feats, cpu_feats))
    del feats, cpu_feats
    free(torch)
    log({"phase": "perception_rest_zoo_total", "seconds": time.perf_counter() - t0})
    return {"paths": paths, "flash": recs, "bwd": bwd}


def checks_beside_ranks(torch, np, dev, fa, gg, card: str) -> dict:
    """The checks of ``BESIDE_RANKS``, for the whole run to make beside
    phase 21's ranks: phase 13 (c) and (d), phase 14, 16 and 17 (b)'s loss
    terms card against CPU, phase 18 (e). Returns phase 18 (e)'s counts."""
    stage1_tiny_phase(torch, np, dev, fa, gg, card)
    free(torch)
    variants_phase(torch, np, dev, card)
    free(torch)
    ptrain_card_vs_cpu(torch, np, dev, card)
    free(torch)
    ptrain_card_vs_cpu(torch, np, dev, card, params=ZTRAIN_PETR,
                       name="perception_zoo_train_card_vs_cpu")
    free(torch)
    ptrain_card_vs_cpu(torch, np, dev, card, params=dict(EVA_B, head_type="sparse_v3"),
                       name="perception_eva_train_card_vs_cpu")
    free(torch)
    feats, cpu_feats = fpn_feats(torch, np, dev)
    paths = rest_losses_phase(torch, np, dev, fa, gg, card, feats, cpu_feats)
    del feats, cpu_feats
    free(torch)
    return paths


# --------------------------------------------------------------------------
# phase 19: data parallelism over torch.distributed
# --------------------------------------------------------------------------


def start_ranks(cli: str, cli_args, log: str, nproc=None, backend=None, dump=None,
                opts=()) -> dict:
    """Start ``scripts/dist_rank.py cli`` under ``python -m
    torch.distributed.run --standalone`` on ``nproc`` ranks, or as one plain
    process where ``nproc`` is None, its output to ``log``.out and .err;
    ``backend`` sets PANACEA_DIST_BACKEND; ``opts`` are more of dist_rank's
    own options. ``wait_all`` waits for it."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable]
    if nproc:
        cmd += ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc)]
    cmd += [os.path.join(root, "scripts", "dist_rank.py"), cli, *opts]
    if dump:
        cmd += ["--dump", dump]
    cmd += ["--", *cli_args]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT", "PANACEA_DIST_BACKEND")}
    if backend:
        env["PANACEA_DIST_BACKEND"] = backend
    with open(log + ".out", "w") as out, open(log + ".err", "w") as err:
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=out, stderr=err,
                                start_new_session=True)
    return {"proc": proc, "cli": cli, "nproc": nproc, "log": log, "t0": time.perf_counter()}


def wait_all(jobs, timeout=DIST_TIMEOUT) -> None:
    """Wait for ``start_ranks`` jobs that run side by side, noting when each
    ended; a job past ``timeout`` s from its start is killed, torchrun and
    its workers."""
    import signal

    while True:
        now = time.perf_counter()
        for job in jobs:
            if "end" not in job:
                if job["proc"].poll() is not None:
                    job["end"] = now
                elif now - job["t0"] > timeout:
                    os.killpg(job["proc"].pid, signal.SIGKILL)
                    job["proc"].wait()
                    job["end"] = now
        if all("end" in job for job in jobs):
            return
        time.sleep(0.5)


def stop_job(job: dict) -> None:
    """Kill a ``start_ranks`` job that is still running, torchrun and its
    workers."""
    import signal

    if job["proc"].poll() is None:
        os.killpg(job["proc"].pid, signal.SIGKILL)
        job["proc"].wait()


def finish_ranks(job: dict):
    """The result of a ``start_ranks`` job that ``wait_all`` waited for. Every
    rank must exit 0, print its report and have imported no JAX. Returns
    (reports by rank, seconds from the job's start to its end)."""
    proc, world = job["proc"], job["nproc"] or 1
    seconds = job["end"] - job["t0"]
    with open(job["log"] + ".out") as f:
        out = f.read()
    with open(job["log"] + ".err") as f:
        err = f.read()
    reports, decoder = {}, json.JSONDecoder()
    for line in out.splitlines():
        at = line.find('{"rank_report"')   # wherever another rank's output left it
        if at >= 0:
            rec = decoder.raw_decode(line[at:])[0]["rank_report"]
            reports[rec["rank"]] = rec
    if proc.returncode != 0 or sorted(reports) != list(range(world)):
        raise AssertionError(f"{job['cli']} on {world} rank(s): exit {proc.returncode} after "
                             f"{seconds:.1f} s, reports from ranks {sorted(reports)}: "
                             f"{out[-3000:]} {err[-3000:]}")
    for rec in reports.values():
        if rec["jax_modules"]:
            raise AssertionError(f"rank {rec['rank']} imported {rec['jax_modules']}")
    return reports, seconds


def check_group(torch, reports, world: int, backend: str) -> None:
    """Every rank in a group of ``world`` on ``backend``, on a card: its own
    under NCCL, the one card shared under gloo."""
    cards = torch.cuda.device_count()
    for r, rec in reports.items():
        want = f"cuda:{r % cards}"
        if (rec["world"], rec["backend"], rec["device"]) != (world, backend, want):
            raise AssertionError(f"rank {r}: world {rec['world']}, backend {rec['backend']}, "
                                 f"device {rec['device']}; expected {world}, {backend}, {want}")


def rel_err(a, b) -> float:
    """The largest difference over the largest value of ``b``."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def update_rel_err(torch, got: dict, want: dict) -> float:
    """The relative distance of two runs' parameter updates (final less
    init, at the sampled positions), over every sampled parameter."""
    num = den = 0.0
    for k in want["final"]:
        ug = got["final"][k].double() - got["init"][k].double()
        uw = want["final"][k].double() - want["init"][k].double()
        num += float((ug - uw).norm() ** 2)
        den += float(uw.norm() ** 2)
    return (num / max(den, 1e-300)) ** 0.5


def dist_inference_reference(torch, dev, world: int, steps: int):
    """What each of ``world`` inference ranks samples, from this process: the
    CLI's full-width engine and weights (seed CLI_SEED), rank r's first clip
    of the synthetic set read from a fresh dataset, log_images with the
    generator of its first offset. The sampled latents, by rank."""
    from panacea_tpu_torch import inference
    from panacea_tpu_torch.config import load_configs_with_overrides
    from panacea_tpu_torch.data.nuscenes.dataset import NuScenesVideoDataset, collate
    from panacea_tpu_torch.data.nuscenes.synthetic import (make_synthetic_infos,
                                                           synthetic_image_loader)
    from panacea_tpu_torch.parallel.mesh import shard_indices
    from panacea_tpu_torch.registry import instantiate_from_config

    eng = instantiate_from_config(load_configs_with_overrides(["inference_nuscenes"], [])["model"],
                                  device=dev)
    eng.init_weights(torch.Generator(device=dev).manual_seed(CLI_SEED))
    t = eng.num_frames
    sampled = []
    sample = eng.sample

    def recorded(*a, **kw):
        out = sample(*a, **kw)
        sampled.append(out.detach().float().cpu())
        return out

    eng.sample = recorded
    for r in range(world):
        ds = NuScenesVideoDataset(infos=make_synthetic_infos(num_frames=max(t, 2) * 4,
                                                             seed=CLI_SEED),
                                  queue_length=t, final_dim=inference.FULL_FINAL_DIM,
                                  use_last_frame=True, image_loader=synthetic_image_loader,
                                  seed=CLI_SEED)
        idx = shard_indices([t - 1 + i * t for i in range(len(ds) // t)], r, world)[0]
        eng.log_images(collate([ds[idx]]), N=1,
                       generator=torch.Generator(device=dev).manual_seed(CLI_SEED),
                       num_steps=steps)
    del eng
    return sampled


def clip_split(rec) -> dict:
    ph = rec["phase_s"]
    return {"s_per_clip": sum(ph[k] for k in ("dataset", "clip", "to_host", "write")),
            "log_images_s": ph["clip"], "writers_s": ph["write"], "dataset_s": ph["dataset"],
            "peak_mem_gb": rec["peak_mem_gb"], "launches": {k: rec["launches"][k] for k in
                                                           ("flash_attention", "geglu")}}


def train_split(rep) -> dict:
    """A generator rank's s/step and its split (the last step; the first
    one's warm-up is in the means), all-reduce, peak memory, losses and
    launches."""
    ph = rep["phase_last_s"]
    return {"s_per_step": sum(ph[k] for k in ("dataset", "conditioning", "vae_encode", "forward",
                                              "backward", "allreduce", "optimizer")),
            "split_s": ph, "mean_split_s": rep["phase_s"], "allreduce_ms": 1e3 * ph["allreduce"],
            "allreduce_bytes_per_step": rep["allreduce_bytes_per_step"],
            "peak_mem_gb": rep["peak_mem_gb"], "losses": rep["losses"],
            "launches": {k: rep["launches"][k] for k in TRAIN_LAUNCHES_PER_STEP}}


def param_rel_err(got: dict, want: dict) -> float:
    """The distance of two runs' trained parameters after their steps over
    their norm, at the sampled positions."""
    num = sum(float((got["final"][k].double() - w.double()).norm() ** 2)
              for k, w in want["final"].items())
    den = sum(float(w.double().norm() ** 2) for w in want["final"].values())
    return (num / max(den, 1e-300)) ** 0.5


def detector_recipe(tmp: str) -> str:
    """The window recipe with GridMask, DN and the history jitter off (each
    rank draws its own, so the 2-rank step could not equal one process's)."""
    import yaml

    from panacea_tpu_torch.configs import PERCEPTION

    cfg = PERCEPTION[PTRAIN_RECIPE]
    p = cfg["perception"]
    p = dict(p, train=dict(p["train"], use_grid_mask=False, with_dn=False, random_length=0))
    path = os.path.join(tmp, "window.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg, perception=p), f)
    return path


def dist_phase(torch, np, dev, card: str, beside=None, train_grid=None) -> dict:
    """Phase 19: the CLIs under torchrun through ``scripts/dist_rank.py``,
    in three groups of runs that share the card (the script's time limit)
    while each group's peak memory stays well under the card's.
    ``beside``, (start, finish): ``start(tmp)`` starts another
    ``start_ranks`` job in the first group (phase 20's ranks), and what
    ``finish(tmp, finish_ranks(job))`` returns comes back under
    ``"beside"``. ``train_grid``, (directory, ``finish_ranks`` result) of
    phase 21's run: held to (c)'s one process, its record comes back under
    ``"train_grid"``."""
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        def at(name):
            return os.path.join(tmp, name)

        inf = ["--synthetic", "--num_batches", "1", "--bs", "1", "--num_steps", str(DIST_STEPS),
               "--seed", str(CLI_SEED), "--name", "dist"]
        gen = GEN_ARGS
        det = ["--synthetic", "--config", detector_recipe(tmp), "--steps", "1",
               "--ckpt_every", "0"]
        # three groups of runs that share the card, each within its memory
        # (peak GB on an H100: inference 13.3 a rank; phase 20's 11.6 a rank
        # in the CLI, 13.5 in its fp32 replay and 18.9 on rank 0 alone; the
        # generator's trainer 21.6 a rank of 2 and 28.5 alone, the detector's
        # 4.4 a rank of 2): (d) the detector's 2 gloo ranks and (e) the
        # eval's 2 gloo ranks and one process, beside phase 20's 4 ranks
        jobs = [beside[0](tmp)] if beside else []
        jobs += [start_ranks("perception_train", det + ["--batch", "1", "--workdir", at("pw2")],
                             at("pt2"), nproc=2, backend="gloo", dump=at("pt2_dump")),
                 start_ranks("perception_eval", ["--synthetic", "--out", at("ev2.json")],
                             at("ev2"), nproc=2, backend="gloo", dump=at("ev2_dump")),
                 start_ranks("perception_eval", ["--synthetic", "--out", at("ev1.json")],
                             at("ev1"), dump=at("ev1_dump"))]
        wait_all(jobs)
        besides = beside[1](tmp, finish_ranks(jobs.pop(0))) if beside else None
        (pt2, pt2_s), (ev2, ev2_s), (ev1, ev1_s) = (finish_ranks(j) for j in jobs)
        # (c) 2 generator-training ranks over gloo beside (b) one NCCL
        # inference rank and (d)'s reference, one process of --batch 2
        jobs = [start_ranks("train", gen + ["--dp", "2", "--bs", "2"], at("tr2"), nproc=2,
                            backend="gloo", dump=at("tr2_dump"), opts=TRAIN_OPTS),
                start_ranks("inference", inf + ["--outdir", at("inf1")], at("inf1"), nproc=1,
                            dump=at("inf1_dump")),
                start_ranks("perception_train", det + ["--batch", "2", "--workdir", at("pw1")],
                            at("pt1"), dump=at("pt1_dump"))]
        wait_all(jobs)
        (tr2, tr2_s), (inf1, inf1_s), (pt1, pt1_s) = (finish_ranks(j) for j in jobs)
        # (c)'s reference, one NCCL process of --bs 2 (--dp 1), beside (a) 2
        # inference ranks over gloo and their reference: each rank's clip
        # sampled in this process
        jobs = [start_ranks("train", gen + ["--dp", "1", "--bs", "2"], at("tr1"), nproc=1,
                            dump=at("tr1_dump"), opts=TRAIN_OPTS),
                start_ranks("inference", inf + ["--outdir", at("inf2")], at("inf2"), nproc=2,
                            backend="gloo", dump=at("inf2_dump"))]
        want = dist_inference_reference(torch, dev, 2, DIST_STEPS)
        free(torch)
        wait_all(jobs)
        (tr1, tr1_s), (inf2, inf2_s) = (finish_ranks(j) for j in jobs)
        runs_s = time.perf_counter() - t_start
        if train_grid:
            grid = finish_train_grid(torch, np, *train_grid, tr1[0], at("tr1_dump"), card)

        def dumped(name, rank=0):
            return torch.load(os.path.join(tmp, f"{name}_dump", f"rank{rank}.pt"))

        for reports, world, backend in ((inf2, 2, "gloo"), (inf1, 1, "nccl"), (tr2, 2, "gloo"),
                                        (tr1, 1, "nccl"), (pt2, 2, "gloo"), (ev2, 2, "gloo")):
            check_group(torch, reports, world, backend)

        # (a), (b): each rank's clip against this process's log_images
        got = [dumped("inf2", r)["latents"] for r in (0, 1)]
        nccl = dumped("inf1")["latents"]
        errs = [rel_err(got[r][0], want[r]) for r in (0, 1)]
        nccl_err = rel_err(nccl[0], want[0])
        files = {"gloo": len(tree_of(at("inf2"))), "nccl": len(tree_of(at("inf1")))}
        rec_inf = {"phase": "dist_inference", "card": card, "steps": DIST_STEPS,
                   "tol": SMALL_TOL,
                   "gloo_2_ranks_beside_1_training_process_and_the_reference": {
                       "seconds": inf2_s, "max_rel_err_vs_one_process": errs,
                       "ranks": {r: clip_split(inf2[r]) for r in (0, 1)}},
                   "nccl_1_rank_beside_3_training_ranks": {
                       "seconds": inf1_s, "max_rel_err_vs_one_process": nccl_err,
                       "rank0": clip_split(inf1[0])},
                   "files": files}
        log(rec_inf)
        expected = {"flash_attention": FLASH_PER_EVAL * DIST_STEPS,
                    "geglu": GEGLU_PER_EVAL * DIST_STEPS}
        for rep in list(inf2.values()) + list(inf1.values()):
            if {k: rep["launches"][k] for k in expected} != expected or rep["clips"] != 1:
                raise AssertionError(f"inference rank {rep['rank']}: launches {rep['launches']}, "
                                     f"clips {rep['clips']}; expected {expected} and 1 clip")
        if max(errs + [nccl_err]) > SMALL_TOL or not all(bool(torch.isfinite(g[0]).all())
                                                         for g in got):
            raise AssertionError(f"a rank's clip differs from this process's: {rec_inf}")
        if files["gloo"] != 2 * files["nccl"] or files["nccl"] == 0:
            raise AssertionError(f"2 ranks wrote {files['gloo']} files, one rank {files['nccl']}")

        # (c): the 2-rank generator step against one process of the global batch
        a, a1, b = dumped("tr2"), dumped("tr2", 1), dumped("tr1")
        ranks_same = all(torch.equal(a["final"][k], a1["final"][k]) for k in a["final"])
        loss_err = max(abs(x - y) / abs(y) for r in (0, 1)
                       for x, y in zip(tr2[r]["losses"], tr1[0]["losses"]))
        per_run = {k: v * DIST_TRAIN_STEPS for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
        rec_tr = {"phase": "dist_train", "card": card, "freeze_type": "spatial",
                  "steps": DIST_TRAIN_STEPS, "tol": SMALL_TOL,
                  "gloo_2_ranks_beside_1_inference_rank_and_1_detector": {
                      "seconds": tr2_s, "ranks": {r: train_split(tr2[r]) for r in (0, 1)}},
                  "nccl_1_process_bs2_beside_2_inference_ranks_and_the_reference": {
                      "seconds": tr1_s, **train_split(tr1[0])},
                  "max_loss_rel_err": loss_err, "param_rel_err": param_rel_err(a, b),
                  "update_rel_err": update_rel_err(torch, a, b),
                  "ranks_hold_the_same_parameters": ranks_same,
                  "trained_params": tr2[0]["trained_params"]}
        log(rec_tr)
        for rep in list(tr2.values()) + list(tr1.values()):
            if {k: rep["launches"][k] for k in per_run} != per_run:
                raise AssertionError(f"training rank {rep['rank']}: launches {rep['launches']}, "
                                     f"expected {per_run}")
        if not (ranks_same and loss_err <= SMALL_TOL and rec_tr["update_rel_err"] <= SMALL_TOL
                and all(np.isfinite(r["losses"]).all() for r in tr2.values())):
            raise AssertionError(f"the 2-rank generator step is not one process's: {rec_tr}")

        # (d): the 2-rank detector step against one process of the global batch
        a, a1, b = dumped("pt2"), dumped("pt2", 1), dumped("pt1")
        det_ranks_same = all(torch.equal(a["final"][k], a1["final"][k]) for k in a["final"])
        want_m = pt1[0]["final_metrics"]
        loss_err = max(abs(pt2[r]["final_metrics"][k] - v) / abs(v) for r in (0, 1)
                       for k, v in want_m.items())
        p2 = dumped("ev2")["predictions"]
        p1 = dumped("ev1")["predictions"]
        pred_err = max(rel_err(x[k].float(), y[k].float()) for x, y in zip(p2, p1)
                       for k in ("boxes", "scores"))
        rec_p = {"phase": "dist_perception", "card": card, "recipe": PTRAIN_RECIPE,
                 "tol": PERCEPTION_TOL,
                 "train": {"gloo_2_ranks_s": pt2_s, "one_process_s": pt1_s,
                           "step_s": {r: pt2[r]["steps"][0]["s"] for r in (0, 1)},
                           "one_process_step_s": pt1[0]["steps"][0]["s"],
                           "launches_per_step": {r: {k: pt2[r]["steps"][0][k] for k in
                                                     ("flash_attention", "flash_attention_bwd")}
                                                 for r in (0, 1)},
                           "fp32_kernels": {r: pt2[r]["launches"]["flash_fp32_kernels"]
                                            for r in (0, 1)},
                           "peak_mem_gb": {r: pt2[r]["peak_mem_gb"] for r in (0, 1)},
                           "max_loss_rel_err": loss_err, "param_rel_err": param_rel_err(a, b),
                           "update_rel_err": update_rel_err(torch, a, b),
                           "update_tol": DIST_UPDATE_TOL,
                           "ranks_hold_the_same_parameters": det_ranks_same, "metrics": want_m},
                 "eval": {"gloo_2_ranks_s": ev2_s, "one_process_s": ev1_s, "windows": len(p1),
                          "metrics_equal": ev2[0]["metrics"] == ev1[0]["metrics"],
                          "max_pred_rel_err": pred_err, "NDS": ev1[0]["metrics"].get("NDS"),
                          "launches": {r: ev2[r]["launches"]["flash_fp32_kernels"]
                                       for r in (0, 1)}},
                 "runs_and_reference_s": runs_s}
        log(rec_p)
        for r in (0, 1):
            c = rec_p["train"]["launches_per_step"][r]
            if c != {"flash_attention": DIST_PTRAIN_FLASH, "flash_attention_bwd": DIST_PTRAIN_BWD} \
                    or rec_p["train"]["fp32_kernels"][r]["tc32"] != DIST_PTRAIN_FLASH:
                raise AssertionError(f"detector rank {r}: {c}, expected {DIST_PTRAIN_FLASH} tc32 "
                                     f"forward and {DIST_PTRAIN_BWD} backward launches")
        if not (det_ranks_same and loss_err <= PERCEPTION_TOL
                and rec_p["train"]["param_rel_err"] <= PERCEPTION_TOL
                and rec_p["train"]["update_rel_err"] <= DIST_UPDATE_TOL):
            raise AssertionError(f"the 2-rank detector step is not one process's: {rec_p}")
        if not (rec_p["eval"]["metrics_equal"] and len(p2) == len(p1) > 0
                and pred_err <= PERCEPTION_TOL):
            raise AssertionError(f"the 2-rank eval differs from one process: {rec_p}")
    log({"phase": "dist_total", "seconds": time.perf_counter() - t_start})
    return {"inference": rec_inf, "train": rec_tr, "perception": rec_p, "beside": besides,
            "train_grid": grid if train_grid else None}


# --------------------------------------------------------------------------
# phase 20: one clip over several ranks (--view_shard)
# --------------------------------------------------------------------------


def view_shard_kernels(torch, F, fa, tol, dev) -> list:
    """Phase 20's kernel checks: the bf16 flash kernel at the ring's ragged
    shapes against its plain version, view rank 1's (the global last view
    masks its right block) timed beside SDPA with the same mask."""
    ring = []
    for b, sq, skv, h in RING_FLASH:
        ring.append(check_flash(torch, F, fa, tol, dev, b, sq, skv, h, 64,
                                lens=[skv, skv, sq] * (b // 3)))
        ring.append(check_flash(torch, F, fa, tol, dev, b, sq, skv, h, 64, timed=False,
                                lens=[skv] * b))
    for rec in ring:
        if rec["route"] != "wgmma":
            raise AssertionError(f"the ring's call left the wgmma route: {rec}")
    free(torch)
    return ring


def start_view_shard(tmp: str) -> dict:
    """Phase 20's run: the inference CLI with ``--view_shard`` on 4 gloo
    ranks sharing the card, through ``scripts/dist_rank.py
    inference_view_shard``, with its fp32 replays."""
    args = ["--synthetic", "--view_shard", str(VIEW_SHARD_V), "--num_batches", "1", "--bs", "1",
            "--num_steps", str(VIEW_SHARD_STEPS), "--seed", str(CLI_SEED),
            "--outdir", os.path.join(tmp, "vs"), "--name", "vs"]
    return start_ranks("inference_view_shard", args, os.path.join(tmp, "vs_ranks"),
                       nproc=VIEW_SHARD_RANKS, backend="gloo", dump=os.path.join(tmp, "vs_dump"),
                       opts=["--replay", "fp32", "--zero_init_std", str(ZERO_INIT_STD)])


def finish_view_shard(torch, tmp: str, ranks, card: str, ring: list) -> dict:
    """Phase 20's checks and record, from the ranks' reports
    (``finish_ranks``), their dumps and rank 0's files under ``tmp``."""
    from panacea_tpu_torch.parallel import comm_report

    reports, seconds = ranks
    check_group(torch, reports, VIEW_SHARD_RANKS, "gloo")
    zero = reports[0]
    fp32 = zero["against_one_process"]["fp32"]
    latents = [torch.load(os.path.join(tmp, "vs_dump", f"rank{r}.pt"))["latents"]
               for r in range(VIEW_SHARD_RANKS)]
    files = tree_of(os.path.join(tmp, "vs", "vs", "val"))
    rec = {"phase": "view_shard", "card": card, "ranks": VIEW_SHARD_RANKS,
           "t": VIEW_SHARD_RANKS // VIEW_SHARD_V, "view": VIEW_SHARD_V,
           "steps": VIEW_SHARD_STEPS, "tol_fp32": VIEW_SHARD_TOL,
           "fault_factor": VIEW_SHARD_FAULT, "seconds": seconds,
           "fp32_vs_one_process": fp32["grid"], "fault_fp32_vs_one_process": fp32["fault"],
           "replay_s": {k: fp32[k] for k in ("grid_s", "fault_s", "alone_s")},
           "against_one_process": zero["against_one_process"],
           "latent_abs_max": fp32["latent_abs_max"],
           "latents_shape": [list(x.shape) for x in latents[0]], "files": len(files),
           "exchanges_rank0": zero["exchanges"],
           "flash_by_shape": {r: rep["flash_launches_by_shape"] for r, rep in reports.items()},
           "launches": {r: {k: rep["launches"][k] for k in ("flash_attention", "geglu")}
                        for r, rep in reports.items()},
           "ranks_detail": {r: {"cli_s": rep["seconds"], "phase_s": rep["phase_last_s"],
                                "clip_split_s": rep["clip_split_s"],
                                "cli_peak_mem_gb": rep["cli_peak_mem_gb"],
                                "peak_mem_gb": rep["peak_mem_gb"], "grid": rep["grid"],
                                "exchanges_per_eval": rep["exchanges"]["per_eval_total"],
                                "exchanges_once": rep["exchanges"]["once_total"],
                                "replay_s": rep["against_one_process"]["fp32"]}
                            for r, rep in reports.items()},
           "ring_flash": [{k: x.get(k) for k in ("shape", "ms", "plain_ms", "library_ms",
                                                  "bound_ms", "bound_by", "max_abs_err")}
                          for x in ring]}
    log(rec)
    log("view_shard exchanges, rank 0:\n" + comm_report.format_report(zero["exchanges"]))
    steps = VIEW_SHARD_STEPS
    want = {"flash_attention": FLASH_PER_EVAL * steps, "geglu": GEGLU_PER_EVAL * steps}
    want_shapes = {f"{b}x{sq}x{skv}x{h}x64+kv_lens": RING_CALLS_PER_LEVEL * steps
                   for b, sq, skv, h in RING_FLASH}
    for r, rep in reports.items():
        c = rep["launches"]
        if ({k: c[k] for k in want} != want or c["flash_routes"]["wgmma"] != want[
                "flash_attention"] or rep["flash_launches_by_shape"] != want_shapes):
            raise AssertionError(f"view_shard rank {r}: launches {c}, by shape "
                                 f"{rep['flash_launches_by_shape']}; expected {want}, all on "
                                 f"wgmma, by shape {want_shapes}")
        if not (rep["grid"]["host_staged"] and rep["clips"] == 1 and len(latents[r]) == 1
                and torch.equal(latents[r][0], latents[0][0])):
            raise AssertionError(f"view_shard rank {r}: {rep['grid']}, {rep['clips']} clip(s); "
                                 "every rank returns the same whole clip")
    if not (rec["latents_shape"] == [[8, 32, 384, 4]] and bool(torch.isfinite(latents[0][0]).all())
            and files == clip_files()):
        raise AssertionError(f"view_shard: latents {rec['latents_shape']}, rank 0 wrote {files}")
    if rec["fp32_vs_one_process"]["max_rel"] > VIEW_SHARD_TOL:
        raise AssertionError(f"the sharded clip differs from one process in fp32: {rec}")
    if rec["fault_fp32_vs_one_process"]["max_rel"] < VIEW_SHARD_FAULT * VIEW_SHARD_TOL:
        raise AssertionError(f"the planted ring fault reads within the tolerance: {rec}")
    return {"paths": {"view_shard": zero["launches"]}, "ring": ring}


def view_shard_phase(torch, F, np, dev, fa, gg, tol, card: str) -> dict:
    """Phase 20 alone (``--view_shard``): the kernel checks, then the run
    on the card by itself."""
    t_start = time.perf_counter()
    ring = view_shard_kernels(torch, F, fa, tol, dev)
    with tempfile.TemporaryDirectory() as tmp:
        job = start_view_shard(tmp)
        wait_all([job])
        out = finish_view_shard(torch, tmp, finish_ranks(job), card, ring)
    log({"phase": "view_shard_total", "seconds": time.perf_counter() - t_start})
    return out


# --------------------------------------------------------------------------
# phase 21: training one clip over several ranks (the trainer's t axis)
# --------------------------------------------------------------------------


def start_train_grid(tmp: str) -> dict:
    """Phase 21's run: the generator's trainer with --dp 1 --bs 2 --fsdp on 2
    gloo ranks sharing the card (t 2), through ``scripts/dist_rank.py
    train``, with its fp32 replay against rank 0 alone and the planted
    faults, then the ``none`` + EMA step."""
    return start_ranks("train", GEN_ARGS + ["--dp", "1", "--bs", "2", "--fsdp"],
                       os.path.join(tmp, "tg"), nproc=TRAIN_GRID_RANKS, backend="gloo",
                       dump=os.path.join(tmp, "tg_dump"),
                       opts=TRAIN_OPTS + ["--replay", "fp32", "--none_ema_step"])


def finish_train_grid(torch, np, tmp: str, ranks, ref: dict, ref_dump: str, card: str) -> dict:
    """Phase 21's checks and record, from the ranks' reports and dumps under
    ``tmp`` and ``ref``, the report of phase 19 (c)'s one process of the
    same global batch, whose dump directory is ``ref_dump``."""
    from panacea_tpu_torch.parallel import comm_report

    reports, seconds = ranks
    check_group(torch, reports, TRAIN_GRID_RANKS, "gloo")
    dumps = [torch.load(os.path.join(tmp, "tg_dump", f"rank{r}.pt"))
             for r in range(TRAIN_GRID_RANKS)]
    one = torch.load(os.path.join(ref_dump, "rank0.pt"))
    zero = reports[0]
    fp32 = zero["against_one_process"]["fp32"]
    ranks_same = all(torch.equal(dumps[0]["final"][k], d["final"][k])
                     for d in dumps[1:] for k in dumps[0]["final"])
    loss_err = max(abs(x - y) / abs(y) for rep in reports.values()
                   for x, y in zip(rep["losses"], ref["losses"]))
    steps = DIST_TRAIN_STEPS
    rec = {"phase": "train_grid", "card": card, "ranks": TRAIN_GRID_RANKS, "freeze_type":
           "spatial", "steps": steps, "tol": SMALL_TOL, "tol_fp32": TRAIN_GRID_TOL,
           "fault_factor": TRAIN_GRID_FAULT, "seconds": seconds,
           "max_loss_rel_err": loss_err, "update_rel_err": update_rel_err(torch, dumps[0], one),
           "param_rel_err": param_rel_err(dumps[0], one), "ranks_hold_the_same_parameters":
           ranks_same, "fp32_grid_vs_rank0_alone": fp32["grid"],
           "fault_fp32_vs_rank0_alone": fp32["fault"],
           "replay_s": {k: fp32[k] for k in ("grid_s", "fault_s", "alone_s")},
           "against_one_process": zero["against_one_process"],
           "fsdp_update_vs_rank0_alone": fp32.get("update"),
           "fault_no_reduce_vs_rank0_alone": fp32.get("fault_no_reduce"),
           "fsdp_update_tol": FSDP_UPDATE_TOL,
           "fsdp": {r: rep["fsdp"] for r, rep in reports.items()},
           "none_ema_step": {r: {k: v for k, v in rep["none_ema_step"].items()
                                 if k != "exchanges"} for r, rep in reports.items()},
           "one_process_bs2": {"s_per_step": train_split(ref)["s_per_step"],
                               "peak_mem_gb": ref["peak_mem_gb"], "losses": ref["losses"]},
           "ranks_detail": {r: dict(train_split(rep), grid=rep["grid"], slab=rep["slab"],
                                    cli_s=rep["seconds"], after_cli_s=rep["after_cli_s"],
                                    cli_peak_mem_gb=rep["cli_peak_mem_gb"],
                                    replay_peak_mem_gb=rep["peak_mem_gb"],
                                    flash_by_shape=rep["flash_launches_by_shape"],
                                    routes={k: rep["launches"][k] for k in
                                            ("flash_routes", "flash_bwd_routes",
                                             "geglu_routes")},
                                    exchanges_per_step={
                                        p: rep["exchanges"][p] for p in
                                        comm_report.STEP_PHASES + tuple(
                                            f"{q}_total" for q in comm_report.STEP_PHASES)})
                             for r, rep in reports.items()}}
    log(rec)
    log("train_grid exchanges, rank 0:\n" + comm_report.format_report(zero["exchanges"]))
    log("train_grid none + EMA step exchanges, rank 0:\n"
        + comm_report.format_report(zero["none_ema_step"]["exchanges"]))
    per_run = {k: v * steps for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    # a rank of t 2 at --bs 2 holds 2 clips x 4 frames: the flash calls at
    # B 40 (x 5 views), as one process at --bs 1
    want_shapes = {f"40x{sq}x{skv}x{h}x64": 14 * steps
                   for sq, skv, h in ((2048, 4096, 5), (512, 1024, 10), (128, 256, 20))}
    for r, rep in reports.items():
        c = rep["launches"]
        if ({k: c[k] for k in per_run} != per_run or c["flash_routes"]["wgmma"] != per_run[
                "flash_attention"] or c["flash_bwd_routes"]["wgmma"] != per_run[
                "flash_attention_bwd"] or rep["flash_launches_by_shape"] != want_shapes):
            raise AssertionError(f"train_grid rank {r}: launches {c}, by shape "
                                 f"{rep['flash_launches_by_shape']}; expected {per_run} on "
                                 f"wgmma, by shape {want_shapes}")
        if not (rep["grid"] == {"dp": 1, "t": 2, "dp_index": 0, "t_index": r,
                                "host_staged": True}
                and rep["slab"] == {"clips": [0, 2], "frames": [4 * r, 4 * r + 4]}
                and rep["exchanges"]["steps"] == steps
                and all(rep["exchanges"][f"{p}_total"]["calls"] > 0
                        for p in comm_report.STEP_PHASES)):
            raise AssertionError(f"train_grid rank {r}: grid {rep['grid']}, slab {rep['slab']}, "
                                 f"exchanges {rep['exchanges']}")
    if not (ranks_same and loss_err <= SMALL_TOL and rec["update_rel_err"] <= SMALL_TOL
            and all(np.isfinite(rep["losses"]).all() for rep in reports.values())):
        raise AssertionError(f"the 2-rank grid step is not one process's: {rec}")
    if fp32["grid"]["joint"] > TRAIN_GRID_TOL:
        raise AssertionError(f"the grid's fp32 gradients differ from rank 0 alone: {rec}")
    if fp32["fault"]["joint"] < TRAIN_GRID_FAULT * TRAIN_GRID_TOL:
        raise AssertionError(f"the planted halo fault reads within the tolerance: {rec}")
    if fp32["update"] > FSDP_UPDATE_TOL:
        raise AssertionError(f"the sharded fp32 update differs from rank 0 alone: {rec}")
    if fp32["fault_no_reduce"] < TRAIN_GRID_FAULT * FSDP_UPDATE_TOL:
        raise AssertionError(f"the planted no-reduce fault reads within the tolerance: {rec}")
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    peaks = [rep["none_ema_step"]["peak_mem_gb"] for rep in reports.values()]
    rec["none_ema_peaks_gb"], rec["card_gb"] = peaks, card_gb
    for r, rep in reports.items():
        st = rep["none_ema_step"]
        got, want = st["state_bytes"]["total"], st["counted_bytes"]["total"]
        if not (rep["fsdp"]["leaves_split"] > 0 and abs(got - want) <= FSDP_STATE_TOL * want
                and np.isfinite(st["loss"]) and st["exchanges"]["backward"].get(
                    "fsdp_reduce_scatter_bwd", {}).get("calls", 0) > 0):
            raise AssertionError(f"train_grid rank {r}: the sharded none + EMA step: {st}")
    if sum(peaks) >= card_gb:
        raise AssertionError(f"the sharded none + EMA step's peaks {peaks} GB do not fit in "
                             f"{card_gb:.1f} GB")
    return {"paths": {"train_grid": zero["launches"]}, "record": rec}


def train_grid_phase(torch, np, card: str) -> dict:
    """Phase 21 alone (``--train_grid``): phase 19 (c)'s one process of
    --bs 2, then the 2 grid ranks, each with the card to itself."""
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        job = start_ranks("train", GEN_ARGS + ["--dp", "1", "--bs", "2"],
                          os.path.join(tmp, "tr1"), nproc=1,
                          dump=os.path.join(tmp, "tr1_dump"), opts=TRAIN_OPTS)
        wait_all([job])
        ref, _ = finish_ranks(job)
        job = start_train_grid(tmp)
        wait_all([job], timeout=TRAIN_GRID_TIMEOUT)
        out = finish_train_grid(torch, np, tmp, finish_ranks(job), ref[0],
                                os.path.join(tmp, "tr1_dump"), card)
    log({"phase": "train_grid_total", "seconds": time.perf_counter() - t_start})
    return out


def profile_step(torch, step, name: str = "profile_step", grad: bool = False):
    """One step under torch.profiler (a network evaluation of the main path
    under no_grad, or with ``grad`` a training step, after one warm-up):
    device time per kernel bucket (``utils/profiling.device_summary``: the
    port's buckets, the JAX package's, the port's kernels by symbol) and
    the device's idle share of the wall time. The host's and the card's
    activity are recorded; the kernels are read from the profiler's raw
    events, without the tree of host ops that ``key_averages`` builds first
    (about 40 s for a training step) or a trace file."""
    from torch.profiler import ProfilerActivity, profile

    from panacea_tpu_torch.utils.profiling import device_summary

    with torch.set_grad_enabled(grad):
        step()
    torch.cuda.synchronize()
    with torch.set_grad_enabled(grad), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # host ops carry their kernels' time too: count the device's work only
    summary = device_summary((evt.name(), evt.duration_ns() / 1e6)
                             for evt in prof.profiler.kineto_results.events()
                             if str(evt.device_type()).endswith("CUDA")) or {}
    total = summary.get("device_ms", 0.0)
    rec = {"phase": name, "wall_ms": wall_ms,
           "device_ms": total if total > 0 else "not measured",
           "idle_share": 1 - total / wall_ms if total > 0 else "not measured",
           "bucket_ms": summary.get("port_bucket_ms", {}),
           "jax_bucket_ms": summary.get("bucket_ms", {}),
           "kernel_ms": summary.get("kernel_ms", {})}
    log(rec)
    log({"phase": f"{name}_other", "top10_ms": [
        [n[:120], ms] for n, ms in summary.get("other_ms", {}).items()]})
    return rec


def main(mode: str = "all") -> int:
    """``mode``: "all" (every phase), "kernels" (phases 1 and 2),
    "perception" (phase 1, the flash check at the perception shape and
    phases 11 and 14 to 18), "metrics" (phase 1 and phase 12, on the tree of
    a 2-step full-width generation run), "variants" (phase 1 and phase 13)
    "zoo" (phase 1 and phases 15 to 18), "dist" (phase 1 and phase 19),
    "view_shard" (phase 1 and phase 20) or "train_grid" (phase 1 and phase
    21 with its reference run)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from panacea_tpu_torch.ops import _build
        from panacea_tpu_torch.ops import flash_attention as fa
        from panacea_tpu_torch.ops import geglu as gg
        from panacea_tpu_torch.ops import tolerance as tol
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # fp32 matrix products of the plain versions and yardsticks in full fp32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0], "card": card,
         "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.build_all()
    nvcc_s = time.perf_counter() - t0
    from panacea_tpu_torch import native

    native.get_lib()   # the rasterizer of the dataset's BEV rendering, with g++
    log({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": nvcc_s})
    for src, text in _build.build_log.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "warning" in line.lower()
                    or "entry function" in line
                    or "(C7" in line):   # ptxas advisories: serialised or injected wgmma waits
                log(f"ptxas {src}: {line.strip()}")
        if "C7508" in text or "setmaxnreg ignored" in text:
            raise AssertionError(f"{src}: ptxas ignored setmaxnreg, so the consumer "
                                 "warpgroups do not get the producer's registers")
    # the bf16 flash kernels' instantiations (wg::, one per head dim)
    wg_flash = [r for src in ("flash_attention.cu", "flash_attention_bwd.cu")
                for r in ptxas_report(_build.build_log.get(src, ""))
                if any(n in r["kernel"] for n in ("wg12pn_flash_fwd", "wg20pn_flash_bwd_dkdv_wg",
                                                  "wg18pn_flash_bwd_dq_wg"))]
    log({"phase": "ptxas_bf16_flash", "kernels": wg_flash})
    if len(wg_flash) != 12 or any(r["spill_stores"] or r["spill_loads"] for r in wg_flash):
        raise AssertionError(f"the bf16 flash kernels spill, or not every head dim's forward, "
                             f"dK/dV and dQ kernel was built: {wg_flash}")

    if mode == "perception":
        rec = check_flash(torch, F, fa, tol, dev, *PERCEPTION_FLASH, fp32=True)
        if (rec["route"], rec["fp32_kernel"]) != ("fp32", "tc32"):
            raise AssertionError(f"fp32 operands at head dim 32 took route {rec['route']}, "
                                 f"kernel {rec['fp32_kernel']}: {rec}")
        perception_phase(torch, np, dev, fa, gg, card)
        free(torch)
        perception_cli_phase(torch, np, dev, fa, gg, card)
        free(torch)
        perception_train_phase(torch, F, np, dev, fa, gg, tol, card)
        free(torch)
        zoo_phase(torch, F, np, dev, fa, gg, tol, card)
        free(torch)
        ztrain_phase(torch, F, np, dev, fa, gg, tol, card)
        free(torch)
        eva_phase(torch, F, np, dev, fa, gg, tol, card)
        free(torch)
        rest_zoo_phase(torch, F, np, dev, fa, gg, tol, card)
        log({"phase": "perception_only", "ok": True})
        return 0
    if mode == "zoo":
        zoo_phase(torch, F, np, dev, fa, gg, tol, card)
        free(torch)
        ztrain_phase(torch, F, np, dev, fa, gg, tol, card)
        free(torch)
        eva_phase(torch, F, np, dev, fa, gg, tol, card)
        free(torch)
        rest_zoo_phase(torch, F, np, dev, fa, gg, tol, card)
        log({"phase": "zoo_only", "ok": True})
        return 0
    if mode == "variants":
        stage1_kernel_checks(torch, F, fa, gg, tol, dev)
        stage1_phase(torch, np, dev, fa, gg, card)
        log({"phase": "variants_only", "ok": True})
        return 0
    if mode == "dist":
        dist_phase(torch, np, dev, card)
        log({"phase": "dist_only", "ok": True})
        return 0
    if mode == "view_shard":
        view_shard_phase(torch, F, np, dev, fa, gg, tol, card)
        log({"phase": "view_shard_only", "ok": True})
        return 0
    if mode == "train_grid":
        train_grid_phase(torch, np, card)
        log({"phase": "train_grid_only", "ok": True})
        return 0
    if mode == "metrics":
        with tempfile.TemporaryDirectory() as tmp:
            gen_tree = os.path.join(tmp, "gen-nuscenes")
            write_gen_tree(gen_tree)
            free(torch)
            metrics_phase(torch, np, dev, fa, gg, card, gen_tree)
        log({"phase": "metrics_only", "ok": True})
        return 0
    b = 16 * 5   # CFG batch of 16 frames x views 0-4
    levels = ((2048, 4096, 5), (512, 1024, 10), (128, 256, 20))
    # the main path's layout (k, v halves of the merged kv projection); then
    # contiguous k, v at the same shapes, timed in the same run to compare
    flash = [check_flash(torch, F, fa, tol, dev, b, sq, skv, h, 64, merged_kv=True)
             for sq, skv, h in levels]
    flash += [check_flash(torch, F, fa, tol, dev, b, sq, skv, h, 64)
              for sq, skv, h in levels]
    flash += [check_flash(torch, F, fa, tol, dev, b, 512, 1024, 10, 64, ragged=True),
              check_flash(torch, F, fa, tol, dev, 8, 300, 650, 5, 64),
              check_flash(torch, F, fa, tol, dev, 16, 100, 70, 3, 64, ragged=True, timed=False)]
    # the other head dims at a launch-bound shape (checked, not timed) and
    # with tails, a row of one key and an empty one; timed at real work below
    flash += [check_flash(torch, F, fa, tol, dev, 2, 256, 512, 2, d, timed=False)
              for d in (16, 32, 128)]
    flash += [check_flash(torch, F, fa, tol, dev, 3, 129, 4097, 2, d, timed=False, merged_kv=True,
                          lens=[4097, 1, 0]) for d in (16, 32, 128)]
    # tails of one row past a tile, a single key, one key past a tile edge,
    # and a batch whose rows all differ in length
    flash += [check_flash(torch, F, fa, tol, dev, 4, 129, 4097, 5, 64, timed=False),
              check_flash(torch, F, fa, tol, dev, 4, 256, 512, 5, 64, timed=False,
                          merged_kv=True, lens=[1, 129, 128, 512]),
              check_flash(torch, F, fa, tol, dev, 12, 200, 700, 2, 64, timed=False,
                          lens=[1 + 61 * i for i in range(12)])]
    # rows with no valid key (the mean of V) on each route
    flash += [check_flash(torch, F, fa, tol, dev, 4, 256, 512, 5, 64, timed=False,
                          merged_kv=True, lens=[0, 129, 0, 512])]
    flash += [check_flash(torch, F, fa, tol, dev, 2, 256, 512, 2, d, timed=False, lens=[0, 300])
              for d in (16, 32, 128)]
    for rec in flash:   # bf16 at every head dim: the wgmma kernel
        if rec["route"] != "wgmma":
            raise AssertionError(f"flash_attention took route {rec['route']}, not wgmma: {rec}")
    geglu = []
    for tokens, c in ((196608, 320), (49152, 640), (12288, 1280), (3072, 1280)):
        geglu.append(check_geglu(torch, F, gg, tol, dev, tokens, c))
        geglu.append(check_geglu(torch, F, gg, tol, dev, tokens + 77, c, timed=False))
    # channels off the 64-wide slice, columns off the 128-wide tile (also odd),
    # fewer tokens than one tile, and the tiny config's widths
    for tokens, c, inner in ((1000, 72, 288), (5000, 328, 1312), (300, 64, 200), (300, 64, 77),
                             (50, 320, 1280), (1, 64, 256), (256, 32, 128), (256, 64, 256)):
        geglu.append(check_geglu(torch, F, gg, tol, dev, tokens, c, timed=False, inner=inner))

    flash_s1, geglu_s1 = stage1_kernel_checks(torch, F, fa, gg, tol, dev)

    # the fp32 kernels at the same shapes: the three levels in both layouts,
    # the ragged case, the tails and the tiny widths
    flash32 = [check_flash(torch, F, fa, tol, dev, b, sq, skv, h, 64, merged_kv=True, fp32=True)
               for sq, skv, h in levels]
    flash32 += [check_flash(torch, F, fa, tol, dev, b, sq, skv, h, 64, fp32=True)
                for sq, skv, h in levels]
    flash32 += [check_flash(torch, F, fa, tol, dev, b, 512, 1024, 10, 64, ragged=True, fp32=True),
                check_flash(torch, F, fa, tol, dev, 16, 100, 70, 3, 64, ragged=True, timed=False,
                            fp32=True),
                check_flash(torch, F, fa, tol, dev, 4, 129, 4097, 5, 64, timed=False, fp32=True),
                check_flash(torch, F, fa, tol, dev, 4, 256, 512, 5, 64, timed=False, fp32=True,
                            merged_kv=True, lens=[1, 129, 128, 512]),
                check_flash(torch, F, fa, tol, dev, 12, 200, 700, 2, 64, timed=False, fp32=True,
                            lens=[1 + 61 * i for i in range(12)]),
                check_flash(torch, F, fa, tol, dev, 4, 256, 512, 5, 64, timed=False, fp32=True,
                            merged_kv=True, lens=[0, 129, 0, 512])]
    # the FMA kernels (off every path) timed at their check shape
    flash32 += [check_flash(torch, F, fa, tol, dev, 2, 256, 512, 2, d,
                            timed=lens is None and d != 32, fp32=True, lens=lens)
                for d in (16, 32, 128) for lens in (None, [0, 300])]
    # head dim 32 (the tensor-core kernel): Sq and Skv off every tile
    # multiple, rows of 1 and 2 keys and an empty one, with the keys split
    # over a cluster (few blocks) and not (many); the perception shape with
    # a ragged row
    flash32 += [check_flash(torch, F, fa, tol, dev, 3, 129, 1667, 2, 32, timed=False, fp32=True,
                            lens=[1, 2, 1667]),
                check_flash(torch, F, fa, tol, dev, 20, 130, 97, 8, 32, timed=False, fp32=True,
                            merged_kv=True, lens=[0, 1, 2, 31, 33, 65, 96, 97] * 2 + [97] * 4),
                check_flash(torch, F, fa, tol, dev, 1, 900, 1668, 8, 32, timed=False, fp32=True,
                            lens=[833])]
    geglu32 = []
    for tokens, c in ((196608, 320), (49152, 640), (12288, 1280), (3072, 1280)):
        geglu32.append(check_geglu(torch, F, gg, tol, dev, tokens, c, fp32=True))
        geglu32.append(check_geglu(torch, F, gg, tol, dev, tokens + 77, c, timed=False, fp32=True))
    # as above, and channels that are a multiple of 4 but not of 8
    for tokens, c, inner in ((1000, 72, 288), (5000, 328, 1312), (300, 64, 200), (300, 64, 77),
                             (50, 320, 1280), (1, 64, 256), (256, 32, 128), (256, 64, 256),
                             (100, 36, 100)):
        geglu32.append(check_geglu(torch, F, gg, tol, dev, tokens, c, timed=False, inner=inner,
                                   fp32=True))
    # the perception eval's self-attention (SparseHead, head dim 32: tc32)
    t0 = time.perf_counter()
    flash32_perception = check_flash(torch, F, fa, tol, dev, *PERCEPTION_FLASH, fp32=True)
    flash32_perception_s = time.perf_counter() - t0
    flash32.append(flash32_perception)
    for rec in flash32 + geglu32:
        if rec["route"] != "fp32":
            raise AssertionError(f"fp32 operands took route {rec['route']}: {rec}")
    # the tensor cores at head dims 64 and 32, the FMA units only at 16 and 128
    for rec in flash32:
        want = {64: "tc", 32: "tc32"}.get(rec["shape"]["D"], "fma")
        if rec["fp32_kernel"] != want:
            raise AssertionError(f"fp32 flash at head dim {rec['shape']['D']} took "
                                 f"{rec['fp32_kernel']}, not {want}: {rec}")

    # the backward kernels at the training path's shapes (bs 1: 8 frames x
    # views 0-4, k and v the halves of the merged kv projection), ragged
    # cases, tails and one tiny case per head dim; then the same in fp32
    # (each check asserts its route)
    def bwd_checks(fp32):
        recs = [check_flash_bwd(torch, F, fa, tol, dev, TRAIN_B, sq, skv, h, 64, fp32=fp32)
                for sq, skv, h in levels]
        recs += [check_flash_bwd(torch, F, fa, tol, dev, 4, 512, 1024, 10, 64,
                                 lens=[1, 300, 700, 1024], fp32=fp32),
                 check_flash_bwd(torch, F, fa, tol, dev, 3, 129, 4097, 2, 64, merged_kv=False,
                                 timed=False, lens=[4097, 64, 65], fp32=fp32),
                 # Sq and Skv below one tile; key blocks with one working
                 # warpgroup, and blocks past kv_len
                 check_flash_bwd(torch, F, fa, tol, dev, 2, 100, 70, 3, 64, timed=False,
                                 lens=[1, 65], fp32=fp32),
                 check_flash_bwd(torch, F, fa, tol, dev, 4, 200, 256, 3, 64, timed=False,
                                 lens=[1, 129, 128, 192], fp32=fp32)]
        # every head dim at a launch-bound shape; the fp32 FMA routes (off
        # every path) timed here, the bf16 ones at real work below
        recs += [check_flash_bwd(torch, F, fa, tol, dev, 2, 200, 400, 2, d, merged_kv=False,
                                 timed=fp32 and d in (16, 128), fp32=fp32)
                 for d in (16, 32, 64, 128)]
        # rows with no valid key on each route: dq = dk = 0, dv = sum dO / Skv
        recs += [check_flash_bwd(torch, F, fa, tol, dev, 2, 100, 70, 3, 64, timed=False,
                                 lens=[0, 65], fp32=fp32)]
        recs += [check_flash_bwd(torch, F, fa, tol, dev, 2, 200, 400, 2, d, merged_kv=False,
                                 timed=False, lens=[0, 300], fp32=fp32) for d in (16, 32, 64, 128)]
        if not fp32:   # tails, rows of one key and none, blocks past kv_len
            recs += [check_flash_bwd(torch, F, fa, tol, dev, 3, 129, 4097, 2, d, timed=False,
                                     lens=[4097, 1, 0]) for d in (16, 32, 128)]
        return recs

    flash_bwd = bwd_checks(False)
    flash_bwd32 = bwd_checks(True)
    # the bf16 kernels at head dims 16, 32 and 128 at shapes with real work,
    # forward and backward (the plain versions timed at the smaller shape)
    t0 = time.perf_counter()
    flash_real = []
    for d in (16, 32, 128):
        for b_, sq, skv in FLASH_REAL:
            rec = flash_real_work(torch, F, fa, tol, dev, b_, sq, skv, FLASH_REAL_WIDTH // d, d,
                                  plain=sq <= 512)
            log(rec)
            flash_real.append(rec)
            if not (rec["ok"] and rec["route"] == rec["bwd_route"] == "wgmma"):
                raise AssertionError(f"the bf16 flash kernels at head dim {d} disagree with "
                                     f"their plain versions or left the wgmma route: {rec}")
            free(torch)
    log({"phase": "flash_real_work", "seconds": time.perf_counter() - t0})
    # the fp32 backward at head dim 32 (tc32): the perception training's
    # shape at B 2 (again in phase 14) and at B 1; ragged rows with an empty
    # one, a row of one key and key blocks wholly past kv_len; Sq and Skv
    # off the 64-row blocks and the 32-row tiles, fewer than one tile
    flash_bwd32_d32 = [
        check_flash_bwd(torch, F, fa, tol, dev, *PTRAIN_FLASH, merged_kv=False, fp32=True),
        check_flash_bwd(torch, F, fa, tol, dev, 1, *PTRAIN_FLASH[1:], merged_kv=False,
                        fp32=True),
        check_flash_bwd(torch, F, fa, tol, dev, 4, *PTRAIN_FLASH[1:], timed=False, fp32=True,
                        lens=[0, 1, 833, 1668]),
        check_flash_bwd(torch, F, fa, tol, dev, 3, 129, 1667, 2, 32, merged_kv=False,
                        timed=False, fp32=True, lens=[1667, 0, 65]),
        check_flash_bwd(torch, F, fa, tol, dev, 2, 100, 70, 3, 32, timed=False, fp32=True,
                        lens=[1, 65]),
        check_flash_bwd(torch, F, fa, tol, dev, 3, 31, 33, 2, 32, timed=False, fp32=True)]
    geglu_bwd = []
    for tokens, c in TRAIN_GEGLU:
        geglu_bwd.append(check_geglu_bwd(torch, F, gg, tol, dev, tokens, 4 * c))
    # the tiny widths, columns that are not a multiple of 8; then fp32 at the
    # training shapes (train_fp32's calls) and the same odd widths
    for tokens, inner in ((256, 128), (300, 77), (1, 256)):
        geglu_bwd.append(check_geglu_bwd(torch, F, gg, tol, dev, tokens, inner, timed=False))
    geglu_bwd32 = [check_geglu_bwd(torch, F, gg, tol, dev, tokens, 4 * c, fp32=True)
                   for tokens, c in TRAIN_GEGLU]
    for tokens, inner in ((3000, 1280), (300, 77)):
        geglu_bwd32.append(check_geglu_bwd(torch, F, gg, tol, dev, tokens, inner, timed=False,
                                           fp32=True))

    if mode == "kernels":
        log({"phase": "kernels_only", "ok": True})
        return 0
    small_input_agreement(torch, np, dev)
    paths = {}
    paths["log_images"], euler_s_per_step = main_path(torch, np, dev, fa, gg, DIRECT_STEPS, card)
    free(torch)
    gen_dir = tempfile.TemporaryDirectory()   # phase 5's Gen-nuScenes tree, for phase 12
    gen_tree = os.path.join(gen_dir.name, "gen-nuscenes")
    paths["cli"] = cli_phase(torch, np, dev, fa, gg, card, keep_gen=gen_tree)
    free(torch)
    paths["fp32_engine"] = fp32_engine_phase(torch, np, dev, fa, gg, card)
    free(torch)
    setup = train_setup(torch, np, dev)
    paths["train"] = train_phase(torch, np, dev, fa, gg, card, setup)
    paths["train_fp32"] = train_fp32_phase(torch, np, dev, fa, gg, card, setup)
    del setup
    free(torch)
    # phase 21's 2 ranks start here and run beside phases 6, 9, 10 and the
    # tiny samplers of 12 (d), whose records then say shared_card; phases
    # 11 to 13 time their paths with the card to themselves once the ranks
    # have ended; phase 21's reference is phase 19 (c)'s one process
    grid_dir = tempfile.TemporaryDirectory()
    grid_job = start_train_grid(grid_dir.name)
    try:
        with card_shared_with("phase 21's 2 training ranks"):
            paths["rollout"] = rollout_phase(torch, np, dev, fa, gg, card)
            free(torch)
            train_tiny_card_vs_cpu(torch, np, dev)
            free(torch)
            train_cli_phase(torch, np, dev, fa, gg, card)
            free(torch)
            samplers_tiny_phase(torch, np, dev, card)
            free(torch)
            BESIDE_RANKS["card_vs_cpu"] = True
            paths.update(checks_beside_ranks(torch, np, dev, fa, gg, card))
            free(torch)
            wait_all([grid_job], timeout=TRAIN_GRID_TIMEOUT)
    finally:
        stop_job(grid_job)   # a phase that failed leaves no rank running
    grid_ranks = finish_ranks(grid_job)
    log({"phase": "train_grid_ranks_done", "seconds": grid_ranks[1],
         "ran_beside": "phases 6, 9, 10, 12 (d)'s tiny samplers and the checks of the card "
                       "against the CPU of phases 13 (c, d), 14, 16, 17 (b) and 18 (e)"})
    t0 = time.perf_counter()
    paths["perception"] = perception_phase(torch, np, dev, fa, gg, card)
    free(torch)
    paths["perception_cli"] = perception_cli_phase(torch, np, dev, fa, gg, card)
    log({"phase": "perception_total", "seconds": time.perf_counter() - t0,
         "kernel_check_s": flash32_perception_s})
    free(torch)
    paths["sampler_dpmpp2m"] = metrics_phase(torch, np, dev, fa, gg, card, gen_tree,
                                             euler_s_per_step, tiny_samplers=False)
    gen_dir.cleanup()
    free(torch)
    paths.update(stage1_phase(torch, np, dev, fa, gg, card))
    free(torch)
    ptrain = perception_train_phase(torch, F, np, dev, fa, gg, tol, card)
    paths.update(ptrain["paths"])
    free(torch)
    zoo = zoo_phase(torch, F, np, dev, fa, gg, tol, card)
    paths.update(zoo["paths"])
    free(torch)
    ztrain = ztrain_phase(torch, F, np, dev, fa, gg, tol, card)
    paths.update(ztrain["paths"])
    free(torch)
    eva = eva_phase(torch, F, np, dev, fa, gg, tol, card)
    paths.update(eva["paths"])
    free(torch)
    rest = rest_zoo_phase(torch, F, np, dev, fa, gg, tol, card)
    paths.update(rest["paths"])
    free(torch)
    # phase 20: its kernel checks with the card to themselves, then its ranks
    # beside phase 19's first group; phase 21's checks after phase 19 (c)
    ring = view_shard_kernels(torch, F, fa, tol, dev)
    dist = dist_phase(torch, np, dev, card, beside=(
        start_view_shard,
        lambda tmp, ranks: finish_view_shard(torch, tmp, ranks, card, ring)),
        train_grid=(grid_dir.name, grid_ranks))
    grid_dir.cleanup()
    view_shard = dist["beside"]
    free(torch)
    paths.update(view_shard["paths"])
    paths.update(dist["train_grid"]["paths"])

    def count(c, kernel, fp32, fp32_kernel=None):
        """Launches of one kernel on one type's routes, from a path's counts
        (the GEGLU backward's one kernel serves both types); with
        ``fp32_kernel``, of that fp32 flash kernel alone."""
        if kernel == "geglu_bwd":
            return c[kernel]
        if fp32_kernel:
            return c["flash_bwd_fp32_kernels" if kernel == "flash_attention_bwd"
                     else "flash_fp32_kernels"][fp32_kernel]
        routes = c[{"flash_attention": "flash_routes", "flash_attention_bwd": "flash_bwd_routes",
                    "geglu": "geglu_routes"}[kernel]]
        return routes["fp32"] if fp32 else c[kernel] - routes["fp32"]

    # the fp32 flash forward kernels, which the head dim selects: tc at 64 on
    # the generation paths, tc32 at 32 on the perception paths (both 3xTF32)
    flash32_d32 = [r for r in flash32 if r["shape"]["D"] == 32]
    flash32 = [r for r in flash32 if r["shape"]["D"] != 32]
    perception_paths = ("perception", "perception_cli", "perception_train",
                        "perception_train_no_dn", "perception_train_streaming") + tuple(
        zoo["paths"]) + tuple(ztrain["paths"]) + tuple(eva["paths"]) + tuple(rest["paths"])
    generation_paths = tuple(p for p in paths if p not in perception_paths)

    def summary(name, kernel, source, replaces, recs, main, path, paths_of=tuple(paths),
                fp32_kernel=None, **extra):
        """``launches``: the count of the path that drives this kernel at full
        depth (the CLI for the bf16 kernels, the fp32 engine for the fp32
        ones); ``launches_by_path`` has the count of each path of ``paths_of``."""
        fp32 = main["dtype"] == "torch.float32"
        return {"name": name, **extra, "route": "cuda", "source": source, "replaces": replaces,
                "launches": count(paths[path], kernel, fp32, fp32_kernel),
                "launches_by_path": {p: count(paths[p], kernel, fp32, fp32_kernel)
                                     for p in paths_of},
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"],
                "dtype": main["dtype"], "shape": main["shape"]}

    def head_dims(what):
        """The bf16 kernel's instantiations at head dims 16, 32 and 128
        (``what``: "fwd" or "bwd"), each at the two real-work shapes, with
        their launches on every path."""
        entry = {"fwd": "wg::pn_flash_fwd<{}>",
                 "bwd": "wg::pn_flash_bwd_{{dkdv,dq}}_wg<{}> + pn_flash_bwd_delta<{}>"}[what]
        key = {"fwd": "flash_bf16_head_dims", "bwd": "flash_bwd_bf16_head_dims"}[what]
        out = []
        for d in (16, 32, 128):
            recs = [r for r in flash_real if r["shape"]["D"] == d]
            out.append({
                "entry": entry.format(d, d), "D": d, "shapes": [r["shape"] for r in recs],
                "launches_by_path": {p: paths[p].get(key, {}).get(d) for p in paths},
                "ms_levels": [r[f"{what}_ms_device"] for r in recs],
                "events_ms_levels": [r[f"{what}_ms"] for r in recs],
                "host_us_levels": [r[f"{what}_host_us"] for r in recs],
                "library_ms_levels": [r[f"sdpa_{what}_ms_device"] for r in recs],
                "plain_ms_levels": [r.get(f"{what}_plain_ms") for r in recs],
                "bound_ms_levels": [r[f"{what}_bound_ms"] for r in recs],
                "bound_by": recs[0][f"{what}_bound_by"],
                "bound_term": recs[0][f"{what}_bound_term"],
                "worst_ratio": max(r[f"{what}_ratio"] for r in recs)})
        return out

    def stage1_levels(recs):
        """The bf16 kernel's numbers at stage 1's shapes, level by level."""
        return {f"stage1_{k}_levels": [r[k] for r in recs]
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")}

    d32, d32_train = flash32_perception, ptrain["fwd"]
    d32_recs = flash32_d32 + [ptrain["fwd"]] + zoo["flash"] + eva["flash"] + rest["flash"]
    bwd, bwd_b1 = ztrain["bwd"][0], flash_bwd32_d32[1]
    bwd32_d32 = flash_bwd32_d32 + [ptrain["bwd"]] + ztrain["bwd"] + rest["bwd"]
    bwd_keys = ("ms", "ms_device", "plain_ms", "library_ms", "library_ms_device", "bound_ms",
                "bound_fma_ms", "host_us")
    dense_bwd = [{"worst_ratio": max(r["worst_ratio"].values()), "shape": r["shape"],
                  **{k: r[k] for k in bwd_keys}} for r in ztrain["bwd"]]
    flash_src, geglu_src = ("panacea_tpu_torch/csrc/flash_attention.cu",
                            "panacea_tpu_torch/csrc/geglu.cu")
    flash_bwd_src = "panacea_tpu_torch/csrc/flash_attention_bwd.cu"
    flash_tpu, geglu_tpu = "panacea_tpu/ops/flash_attention.py:33", "panacea_tpu/ops/geglu.py:64"
    log({"kernels": [
        summary("flash_attention", "flash_attention", flash_src, flash_tpu,
                flash + flash_s1 + view_shard["ring"], flash[0], "cli",
                **stage1_levels(flash_s1), head_dims=head_dims("fwd"),
                ring_shapes=[{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}
                             for r in view_shard["ring"] if "ms" in r]),
        summary("geglu", "geglu", geglu_src, geglu_tpu, geglu + geglu_s1, geglu[0], "cli",
                **stage1_levels(geglu_s1)),
        summary("flash_attention_fp32", "flash_attention", flash_src, flash_tpu, flash32,
                flash32[0], "fp32_engine", paths_of=generation_paths, fp32_kernel="tc",
                entry="tc::pn_flash_f32_fwd_tc (3xTF32 wgmma, TMA)",
                bound_fma_ms=flash32[0]["bound_fma_ms"],
                ms_levels=[r["ms"] for r in flash32[:3]],
                library_ms_levels=[r["library_ms"] for r in flash32[:3]],
                worst_ratio_vs_f64=max(r["worst_ratio"] for r in flash32),
                worst_ratio_vs_fp32_plain=max(r["worst_ratio_vs_fp32_plain"] for r in flash32),
                fp32_plain_worst_ratio_vs_f64=max(r["fp32_plain_worst_ratio_vs_f64"]
                                                  for r in flash32)),
        summary("flash_attention_fp32_d32", "flash_attention", flash_src, flash_tpu,
                d32_recs, d32, "perception",
                paths_of=perception_paths,
                fp32_kernel="tc32",
                entry="tc32::pn_flash_f32_fwd_tc32 (3xTF32 wgmma, cp.async, the keys split "
                      "over a 2-block cluster at B 1), the perception eval's and the "
                      "perception training's history frames' self-attention",
                bound_fma_ms=d32["bound_fma_ms"], ms_device=d32["ms_device"],
                library_ms_device=d32["library_ms_device"], host_us=d32["host_us"],
                worst_ratio_vs_f64=max(r["worst_ratio"] for r in d32_recs),
                lse_worst_ratio=max(r["lse_worst_ratio"] for r in d32_recs),
                worst_ratio_vs_fp32_plain=max(r["worst_ratio_vs_fp32_plain"] for r in d32_recs),
                train_shape=d32_train["shape"],
                **{f"train_shape_{k}": d32_train[k]
                   for k in ("ms", "ms_device", "plain_ms", "library_ms", "library_ms_device",
                             "bound_ms", "bound_fma_ms", "host_us")},
                dense_shapes=[{k: r[k] for k in ("shape", "ms", "ms_device", "plain_ms",
                                                 "library_ms", "library_ms_device", "bound_ms",
                                                 "bound_fma_ms", "host_us", "worst_ratio")}
                              for r in zoo["flash"][:len(ZOO_FLASH)]],
                eva_proposal_shapes=[{k: r[k] for k in ("shape", "ms", "ms_device", "plain_ms",
                                                        "library_ms", "library_ms_device",
                                                        "bound_ms", "bound_fma_ms", "host_us",
                                                        "worst_ratio")}
                                     for r in eva["flash"]],
                joint_shapes=[{k: r[k] for k in ("shape", "ms", "ms_device", "plain_ms",
                                                 "library_ms", "library_ms_device", "bound_ms",
                                                 "bound_fma_ms", "host_us", "worst_ratio")}
                              for r in rest["flash"]],
                dense_bwd_shapes=dense_bwd),
        summary("geglu_fp32", "geglu", geglu_src, geglu_tpu, geglu32, geglu32[0],
                "fp32_engine", entry="f32::pn_geglu_3xtf32_fwd (3xTF32 wgmma, TMA)",
                bound_fma_ms=geglu32[0]["bound_fma_ms"],
                worst_ratio_vs_f64=max(r["worst_ratio"] for r in geglu32),
                worst_ratio_vs_fp32_plain=max(r["worst_ratio_vs_fp32_plain"] for r in geglu32),
                fp32_plain_worst_ratio_vs_f64=max(r["fp32_plain_worst_ratio_vs_f64"]
                                                  for r in geglu32)),
        summary("flash_attention_bwd", "flash_attention_bwd", flash_bwd_src, flash_tpu, flash_bwd,
                flash_bwd[0], "train", head_dims=head_dims("bwd")),
        summary("flash_attention_bwd_fp32", "flash_attention_bwd", flash_bwd_src, flash_tpu,
                flash_bwd32, flash_bwd32[0], "train_fp32", paths_of=generation_paths,
                entry="tc::pn_flash_bwd_f32_{dkdv,dq}_tc (3xTF32 wgmma, TMA)",
                bound_fma_ms=flash_bwd32[0]["bound_fma_ms"],
                ms_levels=[r["ms"] for r in flash_bwd32[:3]],
                library_ms_levels=[r["library_ms"] for r in flash_bwd32[:3]],
                worst_ratio_vs_f64=max(max(r["worst_ratio"].values()) for r in flash_bwd32),
                worst_ratio_vs_fp32_plain=max(r["worst_ratio_vs_fp32_plain"]
                                              for r in flash_bwd32),
                fp32_plain_worst_ratio_vs_f64=max(r["fp32_plain_worst_ratio_vs_f64"]
                                                  for r in flash_bwd32)),
        summary("flash_attention_bwd_fp32_d32", "flash_attention_bwd", flash_bwd_src,
                flash_tpu, bwd32_d32, bwd, "perception_zoo_train",
                paths_of=perception_paths, fp32_kernel="tc32",
                entry="tc32::pn_flash_bwd_f32_{dkdv,dq}_tc32 (3xTF32 wgmma, cp.async), the "
                      "dense PETR heads' cross-attention in training (the main path's "
                      "shape, 900 + 640 DN queries to 12,288 tokens) and the SparseHead "
                      "grad frame's self-attention without DN",
                bound_fma_ms=bwd["bound_fma_ms"], ms_device=bwd["ms_device"],
                library_ms_device=bwd["library_ms_device"], host_us=bwd["host_us"],
                ms_levels=[bwd["ms"]], library_ms_levels=[bwd["library_ms"]],
                worst_ratio_vs_f64=max(max(r["worst_ratio"].values()) for r in bwd32_d32),
                worst_ratio_vs_fp32_plain=max(r["worst_ratio_vs_fp32_plain"] for r in bwd32_d32),
                fp32_plain_worst_ratio_vs_f64=max(r["fp32_plain_worst_ratio_vs_f64"]
                                                  for r in bwd32_d32),
                b1_shape=bwd_b1["shape"], **{f"b1_{k}": bwd_b1[k] for k in bwd_keys},
                no_dn_shape=ptrain["bwd"]["shape"],
                **{f"no_dn_{k}": ptrain["bwd"][k] for k in bwd_keys},
                dense_shapes=dense_bwd,
                joint_shapes=[{"worst_ratio": max(r["worst_ratio"].values()), "shape": r["shape"],
                               **{k: r[k] for k in bwd_keys}} for r in rest["bwd"]]),
        summary("geglu_bwd", "geglu_bwd", geglu_src, geglu_tpu, geglu_bwd, geglu_bwd[0],
                "train"),
        summary("geglu_bwd_fp32", "geglu_bwd", geglu_src, geglu_tpu, geglu_bwd32,
                geglu_bwd32[0], "train_fp32",
                ms_levels=[r["ms"] for r in geglu_bwd32[:4]],
                plain_ms_levels=[r["plain_ms"] for r in geglu_bwd32[:4]],
                bound_ms_levels=[r["bound_ms"] for r in geglu_bwd32[:4]],
                library_ms_levels=[r["library_ms"] for r in geglu_bwd32[:4]])]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--kernels"], ["--perception"], ["--metrics"], ["--variants"],
                            ["--zoo"], ["--dist"], ["--view_shard"], ["--train_grid"]):
        sys.exit(f"usage: {sys.argv[0]} [--kernels | --perception | --metrics | --variants | "
                 "--zoo | --dist | --view_shard | --train_grid]")
    sys.exit(main({"--kernels": "kernels", "--perception": "perception",
                   "--metrics": "metrics", "--variants": "variants", "--zoo": "zoo",
                   "--dist": "dist", "--view_shard": "view_shard",
                   "--train_grid": "train_grid"}.get((sys.argv[1:] or [""])[0], "all")))
