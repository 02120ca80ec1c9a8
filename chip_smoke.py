#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (dgvcc_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel of the port from the checkout's sources
   (nvcc, sm_90a, into build/torch_ext/; the training kernels' library,
   the slowest to build, in a process of its own beside phases 1-3, its
   checks and phase 2's training-kernel checks after phase 3 as 2b);
   the bf16 builds of the serving
   kernel, of the training forward and of the training backward's rows
   and cols kernels must hold wgmma fed by TMA (SASS, body by body: HGMMA
   and UTMALDG, no HMMA) with no serialised wgmma (ptxas C7512, C7514)
   and no spill at K=256; so must the 13 kernels of the int8 convolution
   (s8 wgmma: IGMMA and UTMALDG, no IMMA or HMMA, no C7512, C7514 or
   spill);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it: the serving kernel at K=256, S=1024,
   P=192*256 per 768x1024 frame, B=4, and in bf16 at its edges (rows
   below one 128-row tile, the validation shape B=1, S below one chunk,
   S % 8 != 0, every width) and bit for bit across two calls; the
   two-view training kernels
   (forward and backward) at B=16, P=80*80 per 320x320 crop, both views,
   under a mixed objective and under the consistency loss alone;
   each in bf16 and f32, plus an awkward size; the forward also with views
   that agree to 0.1, 0.01 and 0.001 (loss_con, q, two calls bit for bit);
   then data/device_pipeline.py (device_aug, no kernel of its own): a B=16
   batch of 384x384 pre-crops with injected draws against the same draws
   on the CPU (1e-5), each gate's share over 4096 samples within 4 sigma
   of its probability, and the device time of one call;
3. serve full-width DGModel ``final`` (VGG16-BN, 1024x256 bank, seeded
   random weights, bf16, fused_mem=True) through VideoCounter: 768x1024
   frames by count_frames (B=4) and stream (4 batches of 16), a
   1080x1920 batch through bucket padding and through 2x3 tiles of 768.
   Every path must launch the kernel and agree with the same counter on
   the einsum path (fused_mem=False). Then the command line's ``main``
   (``python -m dgvcc_tpu_torch --task serve``, in process) with
   configs/sta_final.yml counts four JPEG frames;
   The density-map kernel (#4) against its plain version, and a second
   call bit for bit, at DMAP_CHECKS: 768x1024 with 1024 points uniform and
   with points on every border, outside the image, in (-1, 0) and masked
   pad rows, 1080x1920 with 4000, no points, 17x23, 2048x3072 with 25,000
   clustered points, 4,096 points in one 32x32 tile (more than a splat
   block's buffer) and radius 63; against the numpy golden at four;
4. time the serving path (frames/s at B=1, 4, 16; stream) and the kernel
   alone against its plain version and one library call (SDPA); the
   density-map kernel at 768x1024 (N=1024) and 2048x3072 (N=25,000): its
   device time per call (torch.profiler), the back-to-back time, the host
   time per call, its plain version's time and cuBLAS A . B^T's device
   time;
5. train full-width DGModel ``final`` as configs/sta_final.yml says (bf16
   compute, f32 AdamW master weights, the OneCycle lr of epoch 0) on a
   synthetic two-view batch of 16 crops of 320x320: step 1 on the kernel
   path must agree with step 1 on the einsum path (fused_mem_train=False)
   from the same weights, ten more steps on the repeated batch must keep
   the loss finite and bring it down, and each step must launch the
   forward and the backward kernel once; then ms/step and peak memory of
   both paths, and the training kernels' times against their bounds and
   their plain version, and per launch by kernel name;
6. from files to a trained model: write a dataset in the canonical layout
   (40 JPEGs of 768x1024 with 50 to 600 head points each), make its
   density maps with ``python -m dgvcc_tpu_torch.data.dmap_cli`` (one
   kernel #4 launch per image; three maps against the numpy golden), time
   each part of a sample's host work (median ms, and how 8 threads
   scale it), then ``DGTrainer.train_and_test`` with configs/sta_final.yml
   pointed there for 2 epochs, three ways (FILE_RUNS: A threads and host
   augmentation; B device_aug, ema 0.999, async_save; C process workers):
   kernels #2/#3 once per train step, kernel #1 in every validation and
   test forward and no einsum-path bank forward, finite losses and MAE,
   the JAX trainer's log.txt lines, ``last`` / ``best_*`` checkpoints; in
   B the counter serves the sidecar's EMA shadow; in A VideoCounter
   strict-loads both and ``--task test`` from the best checkpoint on the
   command line prints the in-process MAE / MSE, and ``--task test`` of
   ``last.pth`` with ``test_quantized: true`` tests through the int8 graph
   (its log line; #1 and the int8 kernel launched, 21 int8 sites a test
   image);
7. configs/tpu/sta_final_bigcrop.yml at full width (B=8 two-view 512^2
   crops, remat, accum_steps 4) on a repeated synthetic batch: parameters
   unchanged after micro steps 1-3 and 5-7, moved after 4 and 8, #2 and #3
   once per micro step; ms per micro step and per update, peak memory;
8. the whitening family (no kernel of its own; #1-#3 launch counts are
   read over it): one SwitchWhiten at 256 channels, B=16, 20x20 in f32
   against float64 (output 1e-4, running statistics 1e-5); sw, ibn and isw
   from configs/baselines/sta_*.yml and sw_vgg, sw_densenet (121) and
   ibn_densenet (121) at their defaults, seeded, each serving 768x1024
   frames through VideoCounter at B=1 and B=4 in bf16 against the same
   counter in f32 (2e-2), frames/s at B=4; sw and ibn train 10 steps of
   mode simple and isw 10 steps at epoch 6 after a covariance pass whose
   masks hold 1008, 16320 and 65408 sensitive entries, each on a repeated
   synthetic B=16 batch of 320^2 crops (bf16, f32 AdamW): finite, falling
   losses, isw's whitening loss on; ms/step, peak memory, and the device
   time of the sw step's SwitchWhiten sites (each site's forward and
   backward alone, torch.profiler) against the step's; then
   ``DGTrainer.train_and_test`` with configs/baselines/sta_isw.yml on phase
   6's files for 2 epochs: masks after epoch 0's validation, the JAX
   trainer's log lines, ``last`` / ``best_*``, ``--task test`` from best_*
   through the command line's ``main`` in process against the in-process
   MAE, and VideoCounter serving best_*;
9. HTTP serving and the fleet (``final``, bf16): a CountingServer over
   phase 3's counter (max batch 16, window 5 ms) takes 64 distinct
   768x1024 JPEGs (quality 90) from 1, 4 and 16 concurrent clients
   (scripts/stress_torch_http.py in a process of its own): each count
   within 1e-2 of count_frames on that frame alone, /metrics equal to
   /stats, a mean batch above 1 at 16 clients; req/s, p50 / p95, mean
   batch and /stats fps beside phase 4's frames/s. Then the fleet through
   the command line: configs/sta_final.yml, 2 replicas on the one card
   (--devices 0,0), restart on; 8 clients: both replicas serve, counts
   within 1e-2 of the same weights in process; one replica SIGKILLed
   mid-run: no client error, the summed /stats never fall, the replica
   comes back on a new port; req/s and each replica's seconds to ready;
10. the U-Net regressors: dgnet in modes simple (sta_reg_base.yml) and
   discrimination (sta_dis.yml), reg_mem in mode regression (sta_reg.yml),
   10 steps each on a repeated B=16 two-view batch of 320^2 (every loss
   part finite, no launch of #2 / #3; ms/step on the host clock and in
   device time, peak memory); dgnet, dgnet_cls, reg and reg_mem serving
   768x1024 at B=4 in bf16 against the same weights in float32 (2e-2 of
   the map's mass, the classifier's binarised gate taken from the f32
   twin), frames/s, and reg_mem's bank through kernel #1 against the
   einsum path (2e-2), once per forward; then DGTrainer.train_and_test on
   phase 6's files: sta_reg_base.yml for 2 epochs (800-px tiles, a test
   after each epoch, ``--task test`` through the command line's ``main`` in
   process within 1e-3 of the trainer's MAE) and sta_reg.yml for 1 epoch
   (finite losses, #1 in every validation and test forward);
11. the generator and the classic baselines (no kernel of their own; #1
   runs in the joint run's evaluation): at full width, seeded, bf16 with f32
   AdamW, on a repeated batch of 320^2 crops, ten steps of each of gen in
   mode generation (sta_gen.yml, B=16, two views), the joint step (gen +
   reg_mem, sta_joint.yml, B=16) and the six baselines at their configs' B=8
   (csrnet, mcnn, sasnet, dssinet, cctrans: MSE against a map at the
   config's stride; bl: the Bayesian loss on padded points): every loss
   finite and falling (the last three steps' mean below the first), no #2 /
   #3; ms/step on the host clock and in device
   time, peak memory above the resident; the six serving 768x1024 at B=4
   through VideoCounter, bf16 against the same weights in float32 (no TF32;
   2e-2 of the map's mass, 5e-2 for dssinet, whose untrained bf16 drifts so
   in the JAX package too), frames/s; then on phase 6's files:
   sta_bl.yml train_and_test for 2 epochs (bay crops, the loss's stride left
   to the prediction), ``--task test`` through the command line's ``main``
   in process within 1e-3 of the trainer's MAE; sta_gen.yml for 1 epoch,
   then ``--task generate`` the same way writes one ``_a.jpg`` per train
   image; sta_joint.yml for
   1 epoch (``last_gen`` / ``last_reg``), then ``--task test`` from that pair
   (the command line's ``main``, in process) launches #1 once per test
   image;
12. data parallel (``dgvcc_tpu_torch/parallel/``; no kernel of its own,
   #1, #2 and #3 on every rank): 2 ranks started by ``parallel/launch.py``,
   NCCL with a card a rank where 2 or more cards are visible, else gloo on
   cuda:0, and a 1-rank NCCL group on card 0. Full-width `final`
   (sta_final.yml, bf16, f32 AdamW, the OneCycle lr of epoch 0), a global
   batch of 16 two-view 320^2 crops, 8 a rank: step 1 against the two
   halves run one after the other without communication in a fresh process
   of its own, then averaged (loss parts 1e-3, gradients 1e-2 in relative
   norm, BN running statistics 1e-3); ten more steps: finite, falling, the
   ranks' parameter checksums equal; #2 / #3 once a step on each rank;
   ms/step and the gradient all-reduce alone. `sw` (sta_sw.yml, B=16)
   against one process's step in f32 (TF32 off; 1e-4, 5e-2, 1e-3) and in
   bf16 (1e-2, and 1.5 times one process's bf16-vs-f32 distance). Then
   ``torchrun --nproc_per_node=2 chip_smoke.py --cli-rank DIR`` (the command
   line's ``main`` on each rank, which writes its launches) runs
   sta_final.yml with ``mesh: {data: 2}`` for 1 epoch on phase 6's files
   (``--dist-backend gloo`` on one card): log.txt written once with the
   ``Data parallel over 2 devices`` line, #1 once per rank per validation
   and test image, the test MAE within 1e-4 of a fresh process's ``--task
   test`` of the same ``last.pth`` (phase 13's, which tests its own runs
   too; a fresh process, as the ranks are: a convolution keeps the cuDNN
   algorithm its shape first ran with, and this process timed these shapes
   with the benchmark on in phases 3 and 6);
13. the bank over a 2-D mesh and the crop's height over 8 ranks
   (``parallel/tp.py``, ``parallel/spatial.py``; no kernel of their own):
   configs/tpu/sta_final_spatial.yml's `final` at full width on 8 ranks
   (NCCL with a card a rank where 8 cards are visible, else gloo on cuda:0),
   step 1 against one fresh process's step from the same weights, batch and
   dropout generator, in f32 (TF32 off) at B=2 of two-view 512^2 crops
   (loss parts 1e-4, gradients 1e-2 in relative norm, BN running statistics
   1e-4; at the config's thresholds, the error-mask and classifier-gate
   elements that flip shown) and in bf16 at the config's B=4 of 1024^2
   (loss parts 1e-2; gradients shown against 5e-2, not held: see TOL_SP;
   the flipped elements shown); three more bf16 steps: finite, falling, the
   ranks' checksums equal, #2 / #3 once a step on each rank; ms/step and
   the halo exchanges' share, peak memory a rank against one process's. Then sta_final.yml with ``mesh: {data: 2,
   model: 2}`` on 4 ranks: step 1 against the 1-D ``{data: 2}`` step over
   the data group, f32 against its einsum bank (1e-4, 1e-3) and bf16
   against its kernels #2 / #3 (1e-2, 5e-2); the trained model counted by
   ``ShardedTiledCounter`` over the 4 ranks with the bank gathered (#1 once
   a rank an image) within 1e-4 of one TiledCounter. Then torchrun
   ``train_test`` for 1 epoch of each: sta_final_spatial.yml over 8 ranks
   on 6 JPEGs of 1152x1280 (#2 / #3 once a step, #1 once per rank per
   validation and test image) and sta_final.yml with the 2-D mesh over 4
   ranks on phase 6's files in f32 under ``exact_f32``: log.txt written once
   with its mesh line, the test MAE within 1e-4 of one fresh process's
   ``--task test`` of the same ``last.pth``;
14. int8 serving (``nn/quant.py``, ``ops/qconv.py``; the int8 convolution
   ``csrc/qconv.cu``, a kernel that replaces XLA's int8 convolution, no
   ``pl.pallas_call``): full-width `final` (seed 0, bf16) folded,
   calibrated on 8 seeded 768x1024 frames and quantized (21 int8 sites);
   the kernel against its plain version at every int8 site of a B=1
   768x1024 forward (its real inputs; each site's schedule logged), at
   QCONV_EDGES (Cin 3, 16, 32, 67, 192, Cout 1, 8, 67, 130, 300, H / W off
   the tiles, a 1x1 image, 1x1 windows, dilation 2, N = 3) and at one
   sasnet, one dssinet and one strided CCTrans site (QCONV_FAMILY_SITES,
   their real inputs): int32 accumulators and outputs bit for bit (the
   strided edges: H / W the stride does not divide, strides 2, 4, 8 and a
   3x3 window at stride 2); ``count_frames`` at B=1, 4,
   16 and ``stream`` against the
   bf16 path (max(2e-2, 1.5 x the JAX package's own int8 drift) of the map's
   mass, INT8_DRIFT), the weight-only graph likewise; #1 and the int8 kernel
   launched; ``--task quantize`` on phase 6's JPEGs (in the background),
   then ``--task serve --artifact`` in a fresh process against the
   in-process int8 counter (1e-3), an HTTP burst of 4 clients on the
   artifact (``/stats`` dispatch_int8 > 0); csrnet, bl, sasnet and dssinet
   int8 at B=4 and CCTrans (alt_gvt_large, seed 11) at B=8, its int8 floor,
   against bf16 (the same gate rule; a family's int8 kernel launches equal
   its int8 sites times its int8 dispatches), frames/s in turns, and mcnn
   with no int8 site; CCTrans's int8 sites' device time against cuDNN bf16
   at the same shapes (each distinct shape once), its heaviest strided site
   against its bound and its plain version; frames/s int8 against bf16 at
   B=1, 4, 16 in turns; the device time
   (median of 20 calls with a cold L2, CUDA events: ``device_ms_cold``) of
   the int8 sites of a B=4 forward, whose shapes must be FINAL_INT8_SITES',
   against cuDNN's bf16 convolution at the same shapes, and the three
   heaviest sites, on the seeded inputs scripts/sweep_qconv.py times, against
   their bound at the site's own Cin;
15. AOT serving (``nn/aot.py``; kernel #1 and ``qconv_int8`` as the custom
   ops ``dgvcc_tpu_torch::memory_attention`` and ``::qconv_int8`` inside
   ``torch.export`` programs): phase 3's bf16 `final` exported on the card
   at 4x768x1024 and 1x768x1024, saved, loaded and served (B=4, B=1 padded
   into its program, a stream) against the live counter (2e-3 of each
   count), one #1 launch a program call; phase 14's int8 counter exported at
   4x768x1024, its counts against the live int8 counter's bit for bit (or
   else 1e-4 of the mass, saying which), one #1 and 21 ``qconv_int8``
   launches a call; an artifact exported from a counter built on the CPU
   for cuda,cpu, served on the card with the same checks; ``count_frames``
   frames/s at B=4 in turns AOT, live, live, AOT; export and load seconds
   and bytes; ``--task serve --aot`` on phase 6's test JPEGs through the
   command line's main against the AOT counter;
16. serving on a mesh (``parallel/serving.py``; ``VideoCounter(mesh=,
   shard=)``) of 2 gloo ranks sharing cuda:0 (NCCL refuses two ranks a
   card), phase 3's weights at full width: batch-sharded bf16 at B=4 and 3
   and spatial bf16 at B=2 and on a 1080x1920 frame through the tiled path
   against phase 3's one-process counter (2e-3 of each count), spatial f32
   at B=1 against an f32 twin (1e-4, TF32 off on both sides), spatial int8
   on ``--task quantize``'s artifact (each rank's density rows bit for bit against
   the same rows of one process's int8 graph, counts 1e-5); #1 once a rank
   a dispatch and ``qconv_int8`` 21 times a rank an int8 dispatch, each
   path's counts set to 0 just before it; frames/s and the halo exchanges'
   share; 8 HTTP requests from 4 clients through the command line's 2-rank
   leader; then ``torchrun --task serve`` with mesh: {spatial: 2} and
   serve_shard: spatial on 4 seeded JPEGs against a fresh one process's
   ``--task serve`` (2e-3 plus the 2 printed decimals). It runs right
   after phase 3, beside mem_attention_train's nvcc build, on a checkpoint,
   JPEGs, an artifact and HTTP bodies it makes itself;
17. the convolutional baselines on a spatial mesh (``mesh: {spatial: 2}``
   set in memory on configs/baselines/sta_{mcnn,csrnet,bl,sasnet,
   dssinet}.yml; 2 gloo ranks sharing cuda:0; run between phases 12 and
   13): step 1 at full width on 2 crops of 320^2 (160 rows a rank)
   against one fresh process, f32 under ``exact_f32`` (loss parts 1e-4,
   gradients 1e-2 in relative norm) and bf16 (the loss 1e-3, its gradients
   shown), each rank's peak memory beside one process's; serving 2 frames
   of 768x1024 with ``shard="spatial"``: bf16 (2e-3), f32 (1e-4, TF32 off)
   and, for csrnet, bl, sasnet and dssinet, int8 on artifacts the one
   process calibrated, with the sites below 128 channels on PyTorch's own
   convolutions on both sides (counts 1e-5, each rank's density rows bit
   for bit) and as served, on cuDNN (counts 1e-2, the rows' difference
   shown); ``qconv_int8`` once an int8 site a rank and path, its count set
   to 0 just before each path; frames/s and the halo exchanges' share; and
   ``torchrun --task train_test`` of sta_bl.yml with mesh: {spatial: 2} on
   phase 6's files beside the one process, whose test MAE phase 13 holds
   against a fresh process's ``--task test`` (1e-4).

Each phase's seconds and the total are printed before the result lines.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout of the repo, the script exits non-zero and prints no result.
"""

import atexit
import collections
import concurrent.futures
import contextlib
import glob
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

K, S = 256, 1024                    # bank width and prototypes of `final`
FRAME = (768, 1024)                 # serving frame; P = 192 * 256 = 49152
P = (FRAME[0] // 4) * (FRAME[1] // 4)
TOL_F32 = 1e-4                      # f32 kernel vs plain (summation order)
TOL_BF16 = 2e-2                     # bf16 output vs f32 plain (one bf16 rounding)
TOL_COUNTS = 2e-2                   # fused vs einsum serving counts, relative:
                                    # the einsum path rounds the attention to bf16

TRAIN_B, TRAIN_CROP = 16, 320       # sta_final.yml: batch 16 of 320x320 crops
TRAIN_P = (TRAIN_CROP // 4) ** 2    # 6400 rows per view and crop at stride 4
# training kernels vs their plain version (TF32 off for the plain one):
TOL_TRAIN_F32 = 1e-4                # f32 forward (loss_con relative): other order
                                    # of summation
TOL_TRAIN_F32_GRAD = 1e-3           # f32 gradients: longer sums, other order
TOL_TRAIN_BF16 = 2e-2               # bf16 outputs: one bf16 rounding
TOL_TRAIN_CON = 1e-3                # loss_con, relative: p is exact f32 in both
# q = (<p1,p1>, <p2,p2>, <p1,p2>)_S per row against saved_reference,
# relative: f32 sums in another order; the bf16 kernel's logits are f32
# sums of the bf16 products in the tensor cores' order and its exp2 is the
# SFU's (2 ulp), each about 1e-6 relative (4e-6 to 6e-6 measured)
TOL_TRAIN_Q = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
NEAR_EPS = (0.1, 0.01, 0.001)       # y2 = y1 + eps N(0, 1): the views agree, so
                                    # loss_con falls to ~1e-9 of q
TOL_TRAIN_DY = (0.05, 0.02)         # bf16 dy rtol, atol and dM relative norm:
TOL_TRAIN_DM = 0.02                 # tests/test_mem_attention_train.py:86-94
TOL_TRAIN_BF16_NORM = 1e-2          # bf16 out and dy, relative norm: the kernel
                                    # rounds dl to bf16, the plain version does not
                                    # (about 1e-3); the elementwise limits above are
                                    # a third of a typical value at full width
TOL_TRAIN_LOSS = {torch.float32: 1e-4,   # gradients of loss_con alone, relative
                  torch.bfloat16: 1e-2}  # norm: f32 sums in another order; bf16
                                         # as TOL_TRAIN_BF16_NORM
# the train step, kernel path vs einsum path, step 1 from the same weights:
TOL_STEP_LOSS = 1e-2                # loss parts, relative: up to the bank the two
                                    # paths compute the same; its bf16 outputs may
                                    # round to neighbouring values
TOL_STEP_GRAD = 5e-2                # gradient relative norm: the two round the
                                    # attention's cotangents to bf16 at other places
                                    # (dp in the einsum path, dl in the kernel)
STEP_GRADS = ("mem", "dec1.0.conv.weight", "den_dec.0.conv.weight",
              "den_head.0.conv.weight")
# density-map kernel vs its plain version (A . B^T, TF32 off) and the numpy
# golden: f32; the kernel sums each pixel's covering points in point order
# (FMA), the product and the golden (float64, rounded once) in their own
TOL_DMAP = dict(atol=1e-5, rtol=1e-4)
# kernel #4's cases: (H, W, N, points, sigma, truncate). Points: "uniform"
# in the image, unmasked; "clustered": 50 Gaussian blobs of sigma 40-120 px
# plus 10% uniform, clipped to the image; "border": dmap_points (every
# border, outside, in (-1, 0), the last quarter masked); "one_tile": all
# inside the 32x32 output tile at (320, 320)
DMAP_CASES = {
    "S1": (768, 1024, 1024, "uniform", 4.0, 7 / 4),       # a ShanghaiTech B frame
    "S2": (2048, 3072, 25000, "clustered", 4.0, 7 / 4),   # JHU-Crowd++'s densest image
                                                          # (25,791 heads) at a 2048 px
                                                          # short side (preprocess.py)
    "S3": (2048, 3072, 1000, "uniform", 4.0, 7 / 4),      # a sparse large image
    "border": (768, 1024, 1024, "border", 4.0, 7 / 4),
    "hd": (1080, 1920, 4000, "border", 4.0, 7 / 4),
    "empty": (768, 1024, 0, "border", 4.0, 7 / 4),
    "small": (17, 23, 40, "border", 4.0, 7 / 4),
    "overflow": (768, 1024, 4096, "one_tile", 4.0, 7 / 4),  # more than a block's buffer
    "r63": (768, 1024, 1024, "border", 16.0, 3.95),       # radius 63: 2 tiles each side
}
DMAP_CHECKS = ("S1", "border", "hd", "empty", "small", "S2", "overflow", "r63")
DMAP_GOLDEN = ("S1", "border", "hd", "S2")      # sigma 4: the golden's radius 7
DMAP_TIMED = {"S1": 50, "S2": 20}   # cuBLAS calls timed (one takes about 6 ms at S2)
DMAP_CALLS = 50                     # kernel #4 calls a device-time median is over
TOL_CLI_TEST = 1e-3                 # CLI --task test vs in-process test(), relative


def log(msg):
    """A line of the script's report, with the seconds since it started."""
    print(f"[chip_smoke {time.perf_counter() - T_START:6.1f}s] {msg}", flush=True)


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


PHASE_S = {}  # each phase's seconds, printed before the result lines


def phase_done(label, t0):
    """Record phase ``label``'s seconds since ``t0``."""
    PHASE_S[label] = time.perf_counter() - t0


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(ma, b, p, dtype, tol, seed, k=K, s=S):
    """Kernel #1 against its f32 plain version on the same inputs; with
    two calls bit for bit in bf16 (no float atomics)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn(b, p, k, generator=g, device="cuda").to(dtype)
    mem = torch.randn(k, s, generator=g, device="cuda").to(dtype)
    out = ma.memory_attention_fused(y, mem)
    again = ma.memory_attention_fused(y, mem)
    torch.cuda.synchronize()
    ref = ma.memory_attention_reference(y.float(), mem.float())
    err = (out.float() - ref).abs()
    max_abs = err.max().item()
    max_rel = (err / ref.abs().clamp_min(1e-3)).max().item()
    same = bool(torch.equal(out, again))
    ok = bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol)) and same
    log(f"kernel {str(dtype):>14} B={b} P={p} K={k} S={s}: max_abs_err="
        f"{max_abs:.3e} max_rel_err(|ref|>=1e-3)={max_rel:.3e} tol={tol}, two calls "
        f"{'bit-identical' if same else 'DIFFER'} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"memory_attention_fused disagrees with its plain version or with "
             f"itself ({dtype}, B={b}, P={p}, K={k}, S={s})")
    return max_abs


# kernel #1's bf16 edges (B, P, K, S): rows below one 128-row tile, the
# validation shape (B=1), S below one 64-prototype chunk, S % 8 != 0 at
# K=256 (M padded for its tensor map), every width
EDGES_BF16 = ((1, 37, 256, 1024), (1, P, 256, 1024), (2, 300, 256, 40),
              (1, 1001, 256, 1001), (2, 333, 16, 200), (2, 333, 32, 200),
              (2, 333, 64, 200), (2, 333, 128, 200), (2, 333, 256, 200))
MMA_SYNC_BF16_ERR = 1.793e-3  # the earlier mma.sync kernel's, B=4 (PERF.md)


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")
# the int8 kernels: wgmma with s8 operands is IGMMA in SASS (HGMMA is its
# f16 / bf16 form), mma.sync with s8 operands IMMA
SASS_OPS_INT8 = ("IGMMA", "HGMMA", "UTMALDG", "IMMA", "HMMA")


def sass_counts(sass, pattern, ops=SASS_OPS):
    """{function name: {op: count}} of the function bodies of ``cuobjdump
    -sass`` text whose (mangled) name matches the regular expression
    ``pattern``, counted body by body."""
    bodies = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        name = f.splitlines()[0].strip()
        if re.search(pattern, name):
            bodies[name] = {op: len(re.findall(rf"\b{op}\b", f)) for op in ops}
    return bodies


def wgmma_tma_faults(bodies, n_expected, gmma="HGMMA", banned=("HMMA",)):
    """What in ``sass_counts`` shows a kernel off wgmma fed by TMA: a count
    of bodies other than ``n_expected``, a body without ``gmma`` (HGMMA;
    IGMMA for s8) or UTMALDG, or one with an op of ``banned`` (mma.sync:
    HMMA; IMMA too for s8)."""
    faults = [] if len(bodies) == n_expected else [
        f"{len(bodies)} function bodies, expected {n_expected}"]
    for name, c in bodies.items():
        if not c[gmma] or not c["UTMALDG"] or any(c[op] for op in banned):
            faults.append(f"{name}: {c}")
    return faults


def check_sass(lib, pattern, n_expected, what, int8=False):
    """The bf16 (``int8``: s8) kernels of ``lib`` whose names match
    ``pattern`` run on wgmma fed by TMA: every one of their SASS bodies
    holds HGMMA (IGMMA) and UTMALDG and no HMMA (and no IMMA). Returns the
    counts summed over those bodies."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        fail(f"cuobjdump not found: the SASS of {what} cannot be checked")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    ops = SASS_OPS_INT8 if int8 else SASS_OPS
    kind = "s8" if int8 else "bf16"
    bodies = sass_counts(sass, pattern, ops)
    counts = {op: sum(c[op] for c in bodies.values()) for op in ops}
    log(f"SASS of {os.path.basename(lib)}, {len(bodies)} {kind} kernels of {what}: {counts}")
    faults = (wgmma_tma_faults(bodies, n_expected, "IGMMA", ("IMMA", "HMMA")) if int8
              else wgmma_tma_faults(bodies, n_expected))
    if faults:
        fail(f"{what}: {kind} build does not run on wgmma fed by TMA: {'; '.join(faults)}")
    return counts


def train_objective(dtype):
    """f32: the asymmetric objective of tests/test_mem_attention_train.py
    (catches view sign errors); bf16: its non-cancelling one, so the two
    views' dM terms do not cancel into bf16 noise. At these shapes its loss
    term is about 1e-11 of dp, so check_train_kernels also holds the
    gradients of loss_con alone."""
    def f(o1, o2, con):
        if dtype == torch.float32:
            w = torch.arange(o1.numel(), dtype=torch.float32, device=o1.device)
            return ((o1 * torch.cos(w).reshape(o1.shape)).sum()
                    + 0.5 * (o2 * torch.sin(w).reshape(o2.shape)).sum() + 10.0 * con)
        return o1.float().sum() + 0.5 * o2.float().sum() + 5.0 * con
    return f


def rel_norm(a, r):
    return ((a - r).norm() / r.norm()).item()


def check_train_kernels(mt, b, p, dtype, seed):
    """Kernels #2 and #3 through memory_attention_train (forward, and the
    gradients by torch.autograd.grad) against the plain version on the
    same inputs. Two objectives: train_objective, and loss_con x rows x S
    alone (cotangent g = rows x S, so dp = +-2 (p1 - p2)): dy1, dy2 and dM
    of the second come from the consistency branch only."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y1, y2 = (torch.randn(b, p, K, generator=g, device="cuda").to(dtype) for _ in range(2))
    mem = torch.randn(K, S, generator=g, device="cuda").to(dtype)
    obj = train_objective(dtype)
    res = {}
    for name, fn in (("kernel", mt.memory_attention_train),
                     ("plain", mt.memory_attention_train_reference)):
        leaves = [t.clone().requires_grad_() for t in (y1, y2, mem)]
        outs = fn(*leaves)
        grads = torch.autograd.grad(obj(*outs), leaves, retain_graph=True)
        con_grads = torch.autograd.grad(outs[2] * float(b * p * S), leaves)
        res[name] = [t.detach().float() for t in outs] + [t.float() for t in grads + con_grads]
        del outs, grads, con_grads, leaves
    torch.cuda.synchronize()
    (o1, o2, con, dy1, dy2, dm, cy1, cy2, cm) = res["kernel"]
    (r1, r2, rcon, ry1, ry2, rdm, rc1, rc2, rcm) = res["plain"]
    err = dict(out=max((o1 - r1).abs().max().item(), (o2 - r2).abs().max().item()),
               out_rel=max(rel_norm(o1, r1), rel_norm(o2, r2)),
               con_rel=abs(con.item() - rcon.item()) / abs(rcon.item()),
               dy=max((dy1 - ry1).abs().max().item(), (dy2 - ry2).abs().max().item()),
               dy_rel=max(rel_norm(dy1, ry1), rel_norm(dy2, ry2)),
               dm_rel=rel_norm(dm, rdm),
               con_dy_rel=max(rel_norm(cy1, rc1), rel_norm(cy2, rc2)),
               con_dm_rel=rel_norm(cm, rcm))
    loss_branch_ok = max(err["con_dy_rel"], err["con_dm_rel"]) <= TOL_TRAIN_LOSS[dtype]
    if dtype == torch.float32:
        ok = (all(torch.allclose(a, r, atol=TOL_TRAIN_F32, rtol=TOL_TRAIN_F32)
                  for a, r in ((o1, r1), (o2, r2)))
              and err["con_rel"] <= TOL_TRAIN_F32
              and all(torch.allclose(a, r, atol=TOL_TRAIN_F32_GRAD, rtol=TOL_TRAIN_F32_GRAD)
                      for a, r in ((dy1, ry1), (dy2, ry2), (dm, rdm)))
              and loss_branch_ok)
    else:
        rtol, atol = TOL_TRAIN_DY
        ok = (all(torch.allclose(a, r, atol=TOL_TRAIN_BF16, rtol=TOL_TRAIN_BF16)
                  for a, r in ((o1, r1), (o2, r2)))
              and err["out_rel"] <= TOL_TRAIN_BF16_NORM
              and err["con_rel"] <= TOL_TRAIN_CON
              and all(torch.allclose(a, r, atol=atol, rtol=rtol)
                      for a, r in ((dy1, ry1), (dy2, ry2)))
              and err["dy_rel"] <= TOL_TRAIN_BF16_NORM
              and err["dm_rel"] < TOL_TRAIN_DM
              and loss_branch_ok)
    log(f"train kernels {str(dtype):>14} B={b} P={p} K={K} S={S}: out max_abs_err "
        f"{err['out']:.3e} rel_norm_err {err['out_rel']:.3e}, loss_con rel_err "
        f"{err['con_rel']:.3e}, dy max_abs_err {err['dy']:.3e} rel_norm_err "
        f"{err['dy_rel']:.3e}, dM rel_norm_err {err['dm_rel']:.3e}; loss_con alone: "
        f"dy rel_norm_err {err['con_dy_rel']:.3e}, dM rel_norm_err "
        f"{err['con_dm_rel']:.3e} (tol {TOL_TRAIN_LOSS[dtype]}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"memory_attention_train disagrees with its plain version "
             f"({dtype}, B={b}, P={p})")
    return err


def check_train_forward_near(mt, dtype, eps, seed):
    """Kernel #2 at the training shape with views that agree (y2 = y1 + eps
    N(0, 1)), where the loss term is a small difference of the q sums:
    loss_con against the plain version, lse and q against saved_reference,
    two calls bit for bit. Returns loss_con's and q's relative errors."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y1 = torch.randn(TRAIN_B, TRAIN_P, K, generator=g, device="cuda")
    y2 = (y1 + eps * torch.randn(TRAIN_B, TRAIN_P, K, generator=g, device="cuda")).to(dtype)
    y1 = y1.to(dtype)
    mem = torch.randn(K, S, generator=g, device="cuda").to(dtype)
    got = mt.memory_attention_train_forward(y1, y2, mem)
    again = mt.memory_attention_train_forward(y1, y2, mem)
    torch.cuda.synchronize()
    r1, r2, rcon = mt.memory_attention_train_reference(y1, y2, mem)
    rlse, rq = mt.saved_reference(y1, y2, mem)
    con_rel = abs(got[2].item() - rcon.item()) / rcon.item()
    q_rel = ((got[4] - rq).abs() / rq.abs()).max().item()
    lse_err = (got[3] - rlse).abs().max().item()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    tol_con = TOL_TRAIN_CON if dtype == torch.bfloat16 else TOL_TRAIN_F32
    tol_out = TOL_TRAIN_BF16 if dtype == torch.bfloat16 else TOL_TRAIN_F32
    ok = (same and con_rel <= tol_con and q_rel <= TOL_TRAIN_Q[dtype]
          and lse_err <= TOL_TRAIN_F32
          and all(torch.allclose(a.float(), r.float(), atol=tol_out, rtol=tol_out)
                  for a, r in ((got[0], r1), (got[1], r2))))
    log(f"train fwd {str(dtype):>14} B={TRAIN_B} P={TRAIN_P} views eps={eps}: loss_con "
        f"{got[2].item():.4e} rel_err {con_rel:.3e} (tol {tol_con}), q max rel_err "
        f"{q_rel:.3e} (tol {TOL_TRAIN_Q[dtype]}), lse max_abs_err {lse_err:.3e}, two calls "
        f"{'bit-identical' if same else 'DIFFER'} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"memory_attention_train_forward disagrees with its plain version or with "
             f"itself where the views agree ({dtype}, eps={eps})")
    return con_rel, q_rel


def launch_times(fn, iters):
    """Device time of each kernel that ``fn`` launches, by kernel name:
    {name: (launches per call, ms per launch)} under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / iters, getattr(e, "self_device_time_total", 0) / 1e3 / e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count}


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = 1e3 * flops / peak_flops, 1e3 * nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def synthetic_batch(seed, b=TRAIN_B, crop=TRAIN_CROP):
    """Two views of b crops (the second a perturbed copy, as augmented
    views are), a density map of about 20 heads a 320^2 crop (box-blurred
    points) and its foreground map at stride 16, NCHW on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, 3, crop, crop)
    img1 = torch.randn(shape, generator=g, device="cuda")
    img2 = img1 + 0.25 * torch.randn(shape, generator=g, device="cuda")
    heads = (torch.rand(b, 1, crop, crop, generator=g, device="cuda")
             < 2e-4).float()
    dmap = torch.nn.functional.avg_pool2d(heads, 9, stride=1, padding=4)
    bmap = (torch.nn.functional.avg_pool2d(dmap, 16) > 0).float()
    return {"img1": img1, "img2": img2, "dmap": dmap, "bmap": bmap}


def train_phase(mt, gpu):
    """Phase 5: the training main path. Returns the launch counts of its
    run and the training kernels' times."""
    import dgvcc_tpu_torch.losses  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
    from dgvcc_tpu_torch.train.state import create_train_state
    from dgvcc_tpu_torch.train.steps import build_train_step

    cfg = load_config(os.path.join(ROOT, "configs", "sta_final.yml"))
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    def build(fused_mem_train):
        model = MODELS.build(cfg.model["name"], dtype=dtype,
                             fused_mem_train=fused_mem_train, **cfg.model.get("params", {}))
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        state = create_train_state(model, cfg.optimizer, cfg.scheduler)
        loss = LOSSES.build(cfg.loss["name"], **cfg.loss.get("params", {}))
        return state, build_train_step(model, loss, cfg.mode, cfg.log_para)

    batch = synthetic_batch(1)
    gen = torch.Generator(device="cuda")

    def run(path):
        """One step on the repeated batch, with the same dropout draw."""
        gen.manual_seed(cfg.seed)
        return path[1](path[0], batch, gen, 0)[1]

    kern, plain = build(True), build(False)
    for (k1, v1), (k2, v2) in zip(kern[0].model.state_dict().items(),
                                  plain[0].model.state_dict().items()):
        if k1 != k2 or not torch.equal(v1, v2):
            fail(f"seeded weights differ between the two train states at {k1}")
    lr = kern[0].optimizer.param_groups[0]["lr"]
    log(f"train: DGModel final (sta_final.yml), {dtype}, AdamW lr {lr:.6g} "
        f"(OneCycle, epoch 0), batch {TRAIN_B}x2 views of {TRAIN_CROP}x{TRAIN_CROP}")

    # ---- the main path: step 1 of both paths, ten more on the kernel path
    mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
    m_kern = {k: v.item() for k, v in run(kern).items()}
    g_kern = {n: p.grad.detach().float().clone()
              for n, p in kern[0].model.named_parameters() if n in STEP_GRADS}
    m_plain = {k: v.item() for k, v in run(plain).items()}
    g_plain = {n: p.grad.detach().float().clone()
               for n, p in plain[0].model.named_parameters() if n in STEP_GRADS}
    for k in m_kern:
        a, b = m_kern[k], m_plain[k]
        rel = abs(a - b) / max(abs(b), 1e-12)
        log(f"train step 1 {k}: kernel path {a:.6g}, einsum path {b:.6g}, rel diff "
            f"{rel:.3e} (tol {TOL_STEP_LOSS})")
        if not (math.isfinite(a) and (rel <= TOL_STEP_LOSS or abs(a - b) <= 1e-12)):
            fail(f"train step 1: {k} of the kernel path disagrees with the einsum path")
    for n in STEP_GRADS:
        rel = ((g_kern[n] - g_plain[n]).norm() / g_plain[n].norm()).item()
        log(f"train step 1 grad {n}: rel norm diff {rel:.3e} (tol {TOL_STEP_GRAD})")
        if not rel <= TOL_STEP_GRAD:
            fail(f"train step 1: the gradient of {n} disagrees with the einsum path")
    losses = [m_kern["loss_total"]]
    for _ in range(10):
        losses.append(run(kern)["loss_total"].item())
    launches = (mt.FWD_LAUNCHES, mt.BWD_LAUNCHES)
    log(f"train kernel path, 11 steps: loss_total {[round(x, 4) for x in losses]}; "
        f"memory_attention_train forward launched {launches[0]}x, backward "
        f"{launches[1]}x")
    if not all(math.isfinite(x) for x in losses):
        fail("train: a loss is not finite")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall over 11 steps ({losses[0]} -> {losses[-1]})")
    if launches != (len(losses), len(losses)):
        fail(f"train: {len(losses)} steps launched the training kernels {launches} times")

    # ---- ms/step and peak memory of both paths
    ms_per_step = {}
    for label, path in (("kernel path", kern), ("einsum path", plain)):
        for _ in range(2):
            run(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run(path)
        torch.cuda.synchronize()
        ms = ms_per_step[label] = 1e3 * (time.perf_counter() - t0) / 5
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        run(path)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        log(f"train step {label} (B={TRAIN_B}x2 {TRAIN_CROP}^2 bf16): {ms:.3f} ms/step, "
            f"peak memory {peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} GiB "
            f"above the {resident / 2**30:.3f} GiB resident) [{gpu}]")
    del kern, plain
    torch.cuda.empty_cache()

    # ---- the training kernels alone, at the step's shapes
    g = torch.Generator(device="cuda").manual_seed(30)
    y1, y2, do1, do2 = (torch.randn(TRAIN_B, TRAIN_P, K, generator=g, device="cuda")
                        .to(torch.bfloat16) for _ in range(4))
    mem = torch.randn(K, S, generator=g, device="cuda").to(torch.bfloat16)
    dcon = torch.ones((), device="cuda")
    out1, out2, _, lse, q = mt.memory_attention_train_forward(y1, y2, mem)
    fwd = cuda_ms(lambda: mt.memory_attention_train_forward(y1, y2, mem), 20)

    def backward():
        return mt.memory_attention_train_backward(y1, y2, mem, lse, q, out1, out2, do1, do2,
                                                  dcon)

    bwd = cuda_ms(backward, 10)
    n = TRAIN_B * TRAIN_P * K * S
    # the work the TPU kernels do (scripts/kernel_bounds.py): forward two
    # products a view, backward five; bf16 in and out, dM in f32
    fwd_bound = bound(2 * 4.0 * n, 2.0 * (4 * TRAIN_B * TRAIN_P * K + K * S) + 4,
                      PEAK_BF16_FLOPS)
    bwd_bound = bound(2 * 10.0 * n, 2.0 * (6 * TRAIN_B * TRAIN_P * K + K * S) + 4.0 * K * S,
                      PEAK_BF16_FLOPS)
    for what, fn, b_ms in (
            ("fwd", lambda: mt.memory_attention_train_forward(y1, y2, mem), fwd_bound[0]),
            ("bwd", backward, bwd_bound[0])):
        for name, (n_launch, ms) in launch_times(fn, 5).items():
            log(f"train kernel {what}, per launch: {name} {ms:.4f} ms ({n_launch:g} launches "
                f"a call; the call's bound {b_ms:.4f} ms) [{gpu}]")
    with torch.no_grad():
        fwd_plain = cuda_ms(lambda: mt.memory_attention_train_reference(y1, y2, mem), 5,
                            warmup=1)
    leaves = [t.clone().requires_grad_() for t in (y1, y2, mem)]
    outs = mt.memory_attention_train_reference(*leaves)
    bwd_plain = cuda_ms(lambda: torch.autograd.grad(outs, leaves, (do1, do2, dcon),
                                                    retain_graph=True), 5, warmup=1)
    del outs, leaves
    step_ms = ms_per_step["kernel path"]
    times = {"fwd": dict(ms=fwd, plain_ms=fwd_plain, bound_ms=fwd_bound[0],
                         bound_by=fwd_bound[1]),
             "bwd": dict(ms=bwd, plain_ms=bwd_plain, bound_ms=bwd_bound[0],
                         bound_by=bwd_bound[1])}
    for name, t in times.items():
        log(f"train kernel {name} B={TRAIN_B} P={TRAIN_P} K={K} S={S} x2 views bf16: "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}; {t['ms'] / t['bound_ms']:.1f}x the bound) [{gpu}]")
    return launches, times, step_ms


def dmap_points(h, w, n, seed):
    """n points over the image and a 10-pixel margin around it; with n >= 12
    also points on every border, in (-1, 0) and outside; the last quarter
    masked off as pad rows. On the CPU."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand(n, 2, generator=g) * torch.tensor([w + 20.0, h + 20.0]) - 10.0
    if n >= 12:
        pts[:8] = torch.tensor([[0.0, 0.0], [w - 0.5, h - 0.5], [-0.4, h / 2],
                                [w / 2, -0.7], [w - 1.0, 3.0], [5.0, h - 1.0],
                                [w + 0.5, 2.0], [-1.5, 4.0]])
    mask = torch.ones(n, dtype=torch.bool)
    mask[3 * n // 4:] = False
    return pts, mask


def dmap_case(name, seed):
    """The points and mask of DMAP_CASES[name], made on the CPU from
    ``seed`` and moved to the card."""
    h, w, n, kind = DMAP_CASES[name][:4]
    g = torch.Generator().manual_seed(seed)
    size = torch.tensor([w - 1.0, h - 1.0])
    mask = torch.ones(n, dtype=torch.bool)
    if kind == "uniform":
        pts = torch.rand(n, 2, generator=g) * size
    elif kind == "clustered":
        k = n - n // 10
        centres = torch.rand(50, 2, generator=g) * size
        spread = 40.0 + 80.0 * torch.rand(50, 1, generator=g)
        blob = torch.randint(50, (k,), generator=g)
        pts = torch.cat([centres[blob] + spread[blob] * torch.randn(k, 2, generator=g),
                         torch.rand(n - k, 2, generator=g) * size])
        pts = torch.minimum(pts.clamp_min(0.0), size)[torch.randperm(n, generator=g)]
    elif kind == "one_tile":
        pts = 320.0 + 31.99 * torch.rand(n, 2, generator=g)
    else:
        pts, mask = dmap_points(h, w, n, seed)
    return pts.cuda(), mask.cuda()


def check_dmap(dm):
    """Kernel #4 against its plain version at DMAP_CHECKS, against the numpy
    golden at DMAP_GOLDEN, and a second call bit for bit. Returns the
    largest max_abs_err."""
    worst = 0.0
    for i, name in enumerate(DMAP_CHECKS):
        h, w, n, _, sigma, truncate = DMAP_CASES[name]
        pts, mask = dmap_case(name, seed=40 + i)
        out = dm.gaussian_density(pts, mask, h, w, sigma, truncate)
        again = dm.gaussian_density(pts, mask, h, w, sigma, truncate)
        torch.cuda.synchronize()
        ref = dm.gaussian_density_reference(pts, mask, h, w, sigma, truncate)
        err = (out - ref).abs().max().item()
        same = bool(torch.equal(out, again))
        ok = bool(torch.allclose(out, ref, **TOL_DMAP)) and out.shape == (h, w) and same
        golden_err = "-"
        if name in DMAP_GOLDEN:
            golden = torch.from_numpy(dm.gaussian_density_fixed_np(
                (h, w), pts[mask].cpu().numpy(), sigma)).cuda()
            ok = ok and bool(torch.allclose(out, golden, **TOL_DMAP))
            golden_err = f"{(out - golden).abs().max().item():.3e}"
        worst = max(worst, err)
        log(f"dmap kernel {name} {h}x{w} N={n} ({int(mask.sum())} unmasked), radius "
            f"{dm.scipy_radius(sigma, truncate)}: max_abs_err {err:.3e} vs plain, "
            f"{golden_err} vs golden, sum {out.sum().item():.4f} (tol {TOL_DMAP}), two "
            f"calls {'bit-identical' if same else 'DIFFER'} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"gaussian_density disagrees with its plain version, the golden or itself "
                 f"({name}: {h}x{w}, N={n})")
    return worst


def device_ms_per_call(fn, calls):
    """Device time of one call of ``fn``: the durations of the device
    activities it runs (kernels, memsets) summed per call, from
    torch.profiler (CUPTI), median over ``calls`` calls. Returns (ms,
    activities a call, {activity: its median ms}, method). Where the trace
    lost some activities, the sum of each activity's median; where it shows
    none, the median of per-call CUDA event pairs with a synchronise between
    calls (that pair also holds the host's launch time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    per_op = {}
    for e in evs:
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0].strip() or e.name
        per_op.setdefault(name, []).append(e.time_range.elapsed_us() / 1e3)
    medians = {name: float(np.median(t)) for name, t in per_op.items()}
    if evs and len(evs) % calls == 0:
        k = len(evs) // calls
        per_call = [sum(e.time_range.elapsed_us() for e in evs[i * k:(i + 1) * k]) / 1e3
                    for i in range(calls)]
        return float(np.median(per_call)), k, medians, "profiler"
    if evs:  # the trace lost some activities: add up each one's median
        return sum(medians.values()), len(medians), medians, (
            f"profiler, sum of per-activity medians ({len(evs)} activities over {calls} calls)")
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), None, {}, (
        f"event pairs (profiler: {len(evs)} device activities over {calls} calls)")


def host_ms_per_call(fn, calls):
    """Host time of one call of ``fn`` (the clock around the call, no
    synchronise), median over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return 1e3 * float(np.median(times))


def dmap_dense_operands(pts, mask, h, w, sigma, r):
    """The TPU kernel's dense form on the card: A (H x N) and B (W x N) f32
    with the unnormalised taps of the valid points, cuBLAS's A . B^T
    inputs."""
    p = torch.trunc(pts).long()

    def axis(size, c):
        d = torch.arange(size, device="cuda")[:, None] - c[None, :]
        return torch.exp(-0.5 * (d.float() / sigma) ** 2) * (d.abs() <= r)

    return axis(h, p[:, 1]) * mask[None, :], axis(w, p[:, 0])


def dmap_bound(pts, mask, h, w, r):
    """Least time for the map of these points: the map written once and the
    points (x, y f32 and the mask byte) read once over HBM, against the
    work they need (each valid point's (2r+1)^2 window clipped to the image,
    one multiply-add a pixel) over the f32 CUDA-core peak. Returns (ms,
    bound_by, MB, MFLOP)."""
    p = torch.trunc(pts).long()
    valid = mask & (p[:, 0] >= 0) & (p[:, 0] < w) & (p[:, 1] >= 0) & (p[:, 1] < h)
    p = p[valid]
    rows = (p[:, 1] + r).clamp_max(h - 1) - (p[:, 1] - r).clamp_min(0) + 1
    cols = (p[:, 0] + r).clamp_max(w - 1) - (p[:, 0] - r).clamp_min(0) + 1
    flops = 2.0 * float((rows * cols).sum())
    nbytes = 4.0 * h * w + 9.0 * len(pts)
    ms, by = bound(flops, nbytes, PEAK_F32_FLOPS)
    return ms, by, nbytes / 1e6, flops / 1e6


def dmap_timing(dm, name, lib_calls, plain_calls=5, seed=50):
    """Kernel #4 at DMAP_CASES[name]: device time per call (profiler), the
    back-to-back time (CUDA events over 200 calls, the earlier method),
    the host time per call, cuBLAS A . B^T's device time on the prebuilt
    f32 operands (TF32 off; ``lib_calls`` calls), the plain version's time
    (``plain_calls`` calls; 0: not timed) and the bound."""
    h, w, n, _, sigma, truncate = DMAP_CASES[name]
    r = dm.scipy_radius(sigma, truncate)
    pts, mask = dmap_case(name, seed)

    def call():
        return dm.gaussian_density(pts, mask, h, w, sigma, truncate)

    device, k, names, method = device_ms_per_call(call, DMAP_CALLS)
    b2b = cuda_ms(call, 200, warmup=5)
    host = host_ms_per_call(call, 100)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a, b = dmap_dense_operands(pts, mask, h, w, sigma, r)
        library = device_ms_per_call(lambda: torch.matmul(a, b.t()), lib_calls)[0]
        del a, b
        plain = (cuda_ms(lambda: dm.gaussian_density_reference(pts, mask, h, w, sigma,
                                                               truncate), plain_calls, warmup=1)
                 if plain_calls else None)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    b_ms, b_by, mb, mflop = dmap_bound(pts, mask, h, w, r)
    dense = bound(2.0 * h * w * n, 4.0 * (h * w + 3 * n), PEAK_F32_FLOPS)[0]
    return dict(H=h, W=w, N=n, device_ms=device, kernels_per_call=k, device_ops=names,
                device_method=method, b2b_ms=b2b, host_ms=host, library_ms=library,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, bound_mb=mb, bound_mflop=mflop,
                bound_ms_dense_form=dense)


def ops(t):
    """dmap_timing's device activities as text: name and median ms each."""
    return ", ".join(f"{name} {ms:.5f}" for name, ms in t["device_ops"].items())


def time_dmap(dm, gpu):
    """Kernel #4 timed at DMAP_TIMED (dmap_timing), logged; returns the
    kernel line's fields: the top-level ones at S1, every shape's under
    ``shapes``."""
    shapes = {}
    for name, lib_calls in DMAP_TIMED.items():
        t = shapes[name] = dmap_timing(dm, name, lib_calls)
        log(f"dmap kernel {name} {t['H']}x{t['W']} N={t['N']} f32: device {t['device_ms']:.4f} "
            f"ms a call ({t['device_method']}; {t['kernels_per_call']} device activities "
            f"a call: {ops(t)}), back-to-back {t['b2b_ms']:.4f} ms, host "
            f"{t['host_ms']:.4f} ms a call, cuBLAS A.B^T device {t['library_ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}: "
            f"{t['bound_mb']:.2f} MB, {t['bound_mflop']:.3f} MFLOP; the TPU's dense form "
            f"{t['bound_ms_dense_form']:.4f} ms) [{gpu}]")
    s1 = shapes["S1"]
    return dict(ms=s1["device_ms"], plain_ms=s1["plain_ms"], library_ms=s1["library_ms"],
                bound_ms=s1["bound_ms"], bound_by=s1["bound_by"],
                bound_ms_dense_form=s1["bound_ms_dense_form"],
                kernels_per_call=s1["kernels_per_call"],
                shapes={name: {k: v for k, v in t.items() if k != "device_ops"}
                        for name, t in shapes.items()})


AUG_B, AUG_PRE = 16, TRAIN_CROP + 64  # device_aug: B=16 pre-crops of 384 -> 320
AUG_STAT_N = 4096                   # samples whose gates are counted
TOL_AUG = 1e-5                      # the card's batch vs the CPU's, same draws


def device_aug_phase(gpu):
    """data/device_pipeline.py on the card: the batch with injected draws
    against the same function on the CPU, the gates' shares over
    AUG_STAT_N samples of one seeded generator, and the device time of one
    B=16 call (logged)."""
    from dgvcc_tpu_torch.data import device_pipeline as dp

    g = torch.Generator(device="cuda").manual_seed(40)
    frames = torch.randint(0, 256, (AUG_B, AUG_PRE, AUG_PRE, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    dmaps = torch.rand((AUG_B, AUG_PRE, AUG_PRE, 1), generator=g, device="cuda") * (
        torch.rand((AUG_B, AUG_PRE, AUG_PRE, 1), generator=g, device="cuda") < 1e-3)
    worst = 0.0
    for seed in range(4):
        draws = dp.draw_augmentation(AUG_B, AUG_PRE, AUG_PRE, TRAIN_CROP,
                                     torch.Generator(device="cuda").manual_seed(seed))
        got = dp.apply_augmentation(frames, dmaps, draws, TRAIN_CROP)
        want = dp.apply_augmentation(frames.cpu(), dmaps.cpu(),
                                     {k: v.cpu() for k, v in draws.items()}, TRAIN_CROP)
        for k, w in want.items():
            if got[k].shape != w.shape or got[k].dtype != w.dtype:
                fail(f"device_aug {k}: {tuple(got[k].shape)} {got[k].dtype} on the card, "
                     f"{tuple(w.shape)} {w.dtype} on the CPU")
            worst = max(worst, (got[k].cpu() - w).abs().max().item())
    log(f"device_aug B={AUG_B} {AUG_PRE}^2 -> {TRAIN_CROP}^2, 4 sets of draws: card vs CPU "
        f"max_abs_err {worst:.3e} (tol {TOL_AUG})")
    if not worst <= TOL_AUG:
        fail("device_aug on the card disagrees with the same draws on the CPU")
    draws = dp.draw_augmentation(AUG_STAT_N, AUG_PRE, AUG_PRE, TRAIN_CROP,
                                 torch.Generator(device="cuda").manual_seed(41))
    for name, p in dp.GATES.items():
        share = draws[name].float().mean().item()
        sigma = math.sqrt(p * (1 - p) / AUG_STAT_N)
        log(f"device_aug gate {name}: share {share:.4f} over {AUG_STAT_N} (p {p}, 4 sigma "
            f"{4 * sigma:.4f})")
        if abs(share - p) > 4 * sigma:
            fail(f"device_aug gate {name}: share {share} is not within 4 sigma of {p}")
    for name, (lo, hi) in dp.JITTER_RANGES.items():
        v = draws[name]
        if not (lo <= v.min().item() and v.max().item() <= hi):
            fail(f"device_aug factor {name} leaves [{lo}, {hi}]")
    for k in ("i", "j"):
        if draws[k].min().item() != 0 or draws[k].max().item() != AUG_PRE - TRAIN_CROP:
            fail(f"device_aug crop offset {k} does not span 0..{AUG_PRE - TRAIN_CROP}")

    gen = torch.Generator(device="cuda").manual_seed(42)

    def call():
        return dp.augment_two_view_batch(frames, dmaps, gen, TRAIN_CROP)

    dev_ms, n_ops, _, method = device_ms_per_call(call, 20)
    event_ms = cuda_ms(call, 20)
    log(f"device_aug B={AUG_B} {AUG_PRE}^2 -> two views of {TRAIN_CROP}^2 on the card: device "
        f"{dev_ms:.4f} ms a call ({method}; {n_ops} device activities a call), "
        f"{event_ms:.4f} ms a call back to back [{gpu}]")


BIG_MICRO = 8                       # bigcrop: micro steps checked, then timed


def bigcrop_phase(mt, gpu):
    """configs/tpu/sta_final_bigcrop.yml at full width: B=8 two-view 512^2
    crops, remat, accum_steps 4, on a repeated synthetic batch. The
    parameters hold still inside each window and move at its end; #2 and
    #3 run on every micro step. Returns the training kernels' launches."""
    import dgvcc_tpu_torch.losses  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
    from dgvcc_tpu_torch.train.state import create_train_state
    from dgvcc_tpu_torch.train.steps import build_train_step

    cfg = load_config(os.path.join(ROOT, "configs", "tpu", "sta_final_bigcrop.yml"))
    accum = int(cfg.extra["accum_steps"])
    b = cfg.train_loader["batch_size"]
    crop = cfg.train_dataset["params"]["crop_size"]
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model = MODELS.build(cfg.model["name"], dtype=dtype, **cfg.model.get("params", {}))
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    state = create_train_state(model, cfg.optimizer, cfg.scheduler, accum_steps=accum)
    step = build_train_step(model, LOSSES.build(cfg.loss["name"], **cfg.loss.get("params", {})),
                            cfg.mode, cfg.log_para)
    batch = synthetic_batch(2, b, crop)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    params = list(model.parameters())
    log(f"bigcrop: sta_final_bigcrop.yml, {cfg.model['name']} remat="
        f"{cfg.model['params'].get('remat')}, {dtype}, B={b} x2 views of {crop}^2, "
        f"accum_steps {accum}")

    # ---- the main path: counts set to 0 just before
    mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
    for k in range(1, BIG_MICRO + 1):
        before = [p.detach().clone() for p in params]
        _, metrics = step(state, batch, gen, 0)
        changed = sum(not torch.equal(a, p) for a, p in zip(before, params))
        loss = metrics["loss_total"].item()
        log(f"bigcrop micro step {k}: loss_total {loss:.4f}, {changed} of {len(params)} "
            f"parameters changed, state.step {state.step}, window {state.mini_step}/{accum}")
        if not math.isfinite(loss):
            fail(f"bigcrop micro step {k}: loss not finite")
        if (k % accum == 0) != (changed > 0):
            fail(f"bigcrop micro step {k}: parameters {'moved' if changed else 'held'} "
                 f"where accum_steps {accum} says otherwise")
    launches = (mt.FWD_LAUNCHES, mt.BWD_LAUNCHES)
    log(f"bigcrop: {BIG_MICRO} micro steps launched #2 {launches[0]}x, #3 {launches[1]}x")
    if launches != (BIG_MICRO, BIG_MICRO):
        fail(f"bigcrop: {BIG_MICRO} micro steps launched the training kernels {launches} "
             "times")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(BIG_MICRO):
        step(state, batch, gen, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"bigcrop (B={b}x2 {crop}^2 {dtype}, remat, accum_steps {accum}): "
        f"{1e3 * dt / BIG_MICRO:.3f} ms per micro step, {1e3 * dt * accum / BIG_MICRO:.3f} "
        f"ms per update, peak memory {peak / 2**30:.3f} GiB [{gpu}]")
    del state, model, batch
    torch.cuda.empty_cache()
    return launches


def write_dataset(root, seed=0, hw=FRAME, counts=(32, 4, 4)):
    """The canonical layout: train 32, val 4, test 4 JPEGs of 768x1024 (a
    smooth random scene with noise) with 50 to 600 head points each."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    for split, n in zip(("train", "val", "test"), counts):
        os.makedirs(os.path.join(root, split))
        for k in range(n):
            low = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
            img = np.asarray(Image.fromarray(low).resize((w, h), Image.BICUBIC), np.float32)
            img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, split, f"IMG_{k}.jpg"), quality=90)
            pts = rng.uniform(0, [w, h], (int(rng.integers(50, 601)), 2)).astype(np.float32)
            np.save(os.path.join(root, split, f"IMG_{k}.npy"), pts)


# the JAX trainer's log.txt lines (dgvcc_tpu/train/trainer.py), numbers free
LOG_LINES = [re.compile(p) for p in (
    r"Start training and testing at \d{4}-\d\d-\d\d \d\d:\d\d:\d\d",
    r"Epoch \d+: Training loss: \d+\.\d{4} Version: sta_final",
    r"Epoch \d+: Val criterion: \d+\.\d{4} mse: \d+\.\d{4} best: \d+\.\d{4}, "
    r"time: \d+\.\d{4}",
    r"Epoch \d+: saving best model\.\.\.",
    r"Start testing at .+", r"Testing results: mae: \d+\.\d{4} mse: \d+\.\d{4} ",
    r"Saving test model\.\.\.", r"Testing results saved to .+", r"End testing at .+",
    r"Best epoch: \d+, best criterion: \d+\.\d+", r"Training results saved to .+",
    r"End training and testing at .+", r"Loading checkpoint from .+",
    r"EMA enabled: decay 0\.999 per optimizer update \(validation, test and vis use the "
    r"averaged weights\)")]


class TimedLoader:
    """A loader that adds up the host time its consumer waits for batches."""

    def __init__(self, loader):
        self.loader, self.wait = loader, 0.0

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def close(self):
        self.loader.close()

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.wait += time.perf_counter() - t
            yield item


# phase 6's runs on the same files: (label, config keys set over sta_final.yml)
FILE_RUNS = (
    ("A threads, host augmentation", {}),
    ("B threads, device_aug, ema 0.999, async_save",
     {"device_aug": True, "ema": 0.999, "async_save": True}),
    ("C process workers, host augmentation",
     {"train_loader": {"worker_mode": "process"}, "val_loader": {"worker_mode": "process"}}),
)
HOST_PART_SAMPLES = 40
HOST_PART_THREADS = 8


def host_parts(root):
    """Where a sample's host time goes, for the den_cls train sample and
    for RawCropDataset's: the median ms of each part over 40 samples, and
    how far 8 threads running the part at once speed it up (about 1x: the
    part holds the GIL)."""
    import glob
    import random as pyrandom
    from concurrent.futures import ThreadPoolExecutor

    import dgvcc_tpu_torch.data  # noqa: F401
    from dgvcc_tpu_torch.core.registry import DATASETS
    from dgvcc_tpu_torch.data import transforms as T
    from dgvcc_tpu_torch.data.datasets import RawCropDataset

    ds = DATASETS.build("den_cls", method="train", root=root, crop_size=TRAIN_CROP,
                        downsample=1, is_grey=False, unit_size=16, pre_resize=1)
    ds.img_fns = sorted(glob.glob(os.path.join(root, "*", "*.jpg")))  # all 40
    raw = RawCropDataset(ds, TRAIN_CROP + 64)
    fns = ds.img_fns[:HOST_PART_SAMPLES]
    loaded = []
    for k, fn in enumerate(fns):
        img, ext = ds._load_img(fn)
        gt_fn, base = ds._gt_path(fn, ext)
        loaded.append((fn, img, ds._load_gt(gt_fn), gt_fn, base,
                       ds._load_dmap(gt_fn, base).astype(np.float32)))
    crops = [ds._train_with_dmap(img, gt, d, pyrandom.Random(k), resize_enabled=False)
             for k, (_, img, gt, _, _, d) in enumerate(loaded)]
    samples = [ds.__getitem__(k, rng=pyrandom.Random(k)) for k in range(len(fns))]
    raws = [raw.__getitem__(k, rng=pyrandom.Random(k)) for k in range(len(fns))]
    batches = [samples[i:i + TRAIN_B] for i in range(0, len(samples) - TRAIN_B + 1, 8)]
    raw_batches = [raws[i:i + TRAIN_B] for i in range(0, len(raws) - TRAIN_B + 1, 8)]

    def pre_crop(k):
        _, img, _, _, _, d = loaded[k]
        pc = raw.pre_crop
        rng = pyrandom.Random(k)
        i, j = rng.randint(0, img.size[1] - pc), rng.randint(0, img.size[0] - pc)
        return np.asarray(img.crop((j, i, j + pc, i + pc)), np.uint8), d[i:i + pc, j:j + pc]

    parts = {
        "den_cls": {
            "JPEG decode": lambda k: ds._load_img(loaded[k][0]),
            "dmap np.load": lambda k: ds._load_dmap(loaded[k][3], loaded[k][4]),
            "crop, flip, normalise": lambda k: ds._train_with_dmap(
                loaded[k][1], loaded[k][2], loaded[k][5], pyrandom.Random(k),
                resize_enabled=False),
            "photometric view": lambda k: T.to_tensor_normalize(
                ds.photo(crops[k][1], pyrandom.Random(k))),
            "whole sample": lambda k: ds.__getitem__(k, rng=pyrandom.Random(k)),
            "collate of 16, per sample": lambda k: ds.collate(batches[k % len(batches)]),
        },
        "RawCropDataset": {
            "JPEG decode": lambda k: ds._load_img(loaded[k][0]),
            "dmap np.load": lambda k: ds._load_dmap(loaded[k][3], loaded[k][4]),
            f"uint8 pre-crop {raw.pre_crop}": pre_crop,
            "whole sample": lambda k: raw.__getitem__(k, rng=pyrandom.Random(k)),
            "collate of 16, per sample": lambda k: raw.collate(raw_batches[k % len(raw_batches)]),
        }}
    out = {}
    n = len(fns)
    with ThreadPoolExecutor(HOST_PART_THREADS) as pool:
        for dataset, fns_ in parts.items():
            for part, fn in fns_.items():
                per = TRAIN_B if part.startswith("collate") else 1
                times = []
                for k in range(n):
                    t = time.perf_counter()
                    fn(k)
                    times.append(time.perf_counter() - t)
                seq = sum(times)
                t = time.perf_counter()
                list(pool.map(fn, range(n)))
                par = time.perf_counter() - t
                out[dataset, part] = (1e3 * float(np.median(times)) / per, seq / par)
    return out


def files_phase(ma, mt, dm, gpu, step_ms_repeated, tmp):
    """Phase 6: from files to a trained model, three ways (FILE_RUNS), in
    directory ``tmp`` (the files stay there for phase 8). Returns kernel
    #4's launches on its path (the dmap_cli run) and the training and eval
    kernels' launches in each run."""
    from dgvcc_tpu_torch.data import dmap_cli

    root = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    write_dataset(root)
    log(f"files: wrote 40 JPEGs of {FRAME[0]}x{FRAME[1]} with points in "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- density maps through the command line (kernel #4)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "dgvcc_tpu_torch.data.dmap_cli",
                          "--path", root], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    wall = time.perf_counter() - t0
    if out.returncode:
        fail(f"dmap_cli exited {out.returncode}:\n{out.stderr[-3000:]}")
    last = out.stdout.strip().splitlines()[-1]
    log(f"dmap_cli ({wall:.1f}s with start-up): {last}")
    m = re.search(r"(\d+) of (\d+) images done in ([\d.]+)s; gaussian_density kernel "
                  r"launched (\d+)x", last)
    if not m or int(m.group(1)) != 40 or int(m.group(4)) != 40:
        fail(f"dmap_cli did not launch the kernel once per image (40): {last}")
    dmap_launches = int(m.group(4))
    for split, k in (("train", 0), ("val", 1), ("test", 3)):
        stem = os.path.join(root, split, f"IMG_{k}")
        got = np.load(stem + "_dmap.npy")
        want = dm.gaussian_density_fixed_np(FRAME, np.load(stem + ".npy"))
        err = float(np.abs(got - want).max())
        log(f"dmap_cli map {split}/IMG_{k}: {got.shape} {got.dtype}, sum "
            f"{got.sum():.4f}, max_abs_err vs numpy golden {err:.3e}")
        if got.dtype != np.float32 or not np.allclose(got, want, **TOL_DMAP):
            fail(f"dmap_cli wrote a map that disagrees with the golden ({stem})")
    img_fns = dmap_cli.list_images(root, ["train", "val", "test"])
    dmap_cli.generate(img_fns[:2], overwrite=True)  # warm: CUDA and the library
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dmap_cli.generate(img_fns, overwrite=True)
    per_image = 1e3 * (time.perf_counter() - t0) / len(img_fns)
    log(f"dmap_cli generate (in process, CUDA up): {per_image:.3f} ms/image at "
        f"{FRAME[0]}x{FRAME[1]} (read points, upload, kernel, download, np.save) "
        f"[{gpu}]")

    # ---- where a sample's host time goes
    for (dataset, part), (ms, speedup) in host_parts(root).items():
        log(f"host part, {dataset} {TRAIN_CROP}^2 from {FRAME[0]}x{FRAME[1]}: {part} "
            f"{ms:.3f} ms (median of {HOST_PART_SAMPLES}); {HOST_PART_THREADS} threads "
            f"at once {speedup:.2f}x one [{gpu}]")

    # ---- train_and_test with configs/sta_final.yml pointed at the files
    with open(os.path.join(ROOT, "configs", "sta_final.yml")) as f:
        import yaml

        base = yaml.safe_load(f)
    for split in ("train", "val", "test"):
        base[f"{split}_dataset"] = dict(base[f"{split}_dataset"], params=dict(
            base[f"{split}_dataset"]["params"], root=root))
    base.update(num_epochs=2)
    runs = {}
    for i, (label, keys) in enumerate(FILE_RUNS):
        raw = dict(base, log_dir=os.path.join(tmp, f"logs{i}"))
        for k, v in keys.items():
            raw[k] = dict(raw[k], **v) if isinstance(v, dict) else v
        runs[label] = file_run(label, raw, tmp, ma, mt, gpu, step_ms_repeated, check=i == 0)
    a = dict(base, log_dir=os.path.join(tmp, "logs0"))
    runs["A --task test, test_quantized"] = test_quantized_run(a, tmp, ma)
    return dmap_launches, runs


def test_quantized_run(raw, tmp, ma):
    """``--task test`` of run A's ``last.pth`` with ``test_quantized: true``
    (the command line's ``main`` in this process): the int8 graph calibrated
    on the first 4 test images and counting all of them. Returns its
    kernels' launches."""
    import yaml

    from dgvcc_tpu_torch.cli.main import main as cli_main
    from dgvcc_tpu_torch.ops import qconv as qc

    last = os.path.join(raw["log_dir"], raw["version"], "last.pth")
    path = os.path.join(tmp, "sta_final_tq.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(raw, version="tq", test_quantized=True), f)
    buf = io.StringIO()
    ma.LAUNCHES = qc.LAUNCHES = 0
    with contextlib.redirect_stdout(buf):
        cli_main(["--config", path, "--task", "test", "--ckpt", last])
    launches = {"memory_attention_fused": ma.LAUNCHES, "qconv_int8": qc.LAUNCHES}
    text = buf.getvalue()
    line = [ln for ln in text.splitlines() if ln.startswith("Testing results:")]
    n_test = 4
    log(f"--task test with test_quantized: true ({os.path.basename(last)}): "
        f"{line[-1] if line else None}; launches {launches} (calibration's f32 forward: #1 "
        f"once; then {n_test} test images, one #1 and {INT8_SITES_FINAL} qconv_int8 each)")
    if "Testing through the int8 PTQ serving graph" not in text or not line:
        fail("--task test with test_quantized did not test through the int8 graph")
    mae = float(re.findall(r"mae: (\S+)", line[-1])[0])
    if not math.isfinite(mae) or launches != {"memory_attention_fused": n_test + 1,
                                             "qconv_int8": INT8_SITES_FINAL * n_test}:
        fail(f"--task test with test_quantized: MAE {mae}, launches {launches}")
    return launches


def file_run(label, raw, tmp, ma, mt, gpu, step_ms_repeated, check):
    """One 2-epoch DGTrainer.train_and_test on the files; with ``check``
    also the checkpoints' strict loads and ``--task test`` on the command
    line. Returns the kernels' launches of the run."""
    import glob

    import yaml

    from dgvcc_tpu_torch.core.config import Config
    from dgvcc_tpu_torch.models.dg import MemoryBank
    from dgvcc_tpu_torch.serve import VideoCounter
    from dgvcc_tpu_torch.train.checkpoint import sidecar_path
    from dgvcc_tpu_torch.train.trainer import DGTrainer

    cfg_path = os.path.join(tmp, f"sta_final_{label[0]}.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    trainer = DGTrainer(Config.from_dict(raw))
    t0 = time.perf_counter()
    trainer.build()
    log(f"[{label}] build (model, loaders and their workers, train state): "
        f"{time.perf_counter() - t0:.3f} s [{gpu}]")
    n_val, n_test = len(trainer.loaders["val"]), len(trainer.loaders["test"])
    steps = len(trainer.loaders["train"])
    train_ld, val_ld = (TimedLoader(trainer.loaders[k]) for k in ("train", "val"))
    trainer.loaders.update(train=train_ld, val=val_ld)
    marks = {"epoch": [], "val": []}
    run_epoch, run_val = trainer.train_epoch, trainer.validate

    def timed_epoch(*a):
        t, w = time.perf_counter(), train_ld.wait
        r = run_epoch(*a)
        marks["epoch"].append((t, time.perf_counter(), train_ld.wait - w))
        return r

    def timed_val(*a):
        t, w = time.perf_counter(), val_ld.wait
        r = run_val(*a)
        marks["val"].append((t, time.perf_counter(), val_ld.wait - w))
        return r

    trainer.train_epoch, trainer.validate = timed_epoch, timed_val
    einsum = [0]
    bank_forward = MemoryBank.forward

    def counting(self, y, mem):
        einsum[0] += not self.fused
        return bank_forward(self, y, mem)

    MemoryBank.forward = counting
    try:
        # ---- the main path of this run: counts set to 0 just before
        ma.LAUNCHES = mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
        trainer.train_and_test()
        launches = {"memory_attention_fused": ma.LAUNCHES,
                    "memory_attention_train_fwd": mt.FWD_LAUNCHES,
                    "memory_attention_train_bwd": mt.BWD_LAUNCHES}
    finally:
        MemoryBank.forward = bank_forward
    text = open(os.path.join(trainer.log_dir, "log.txt")).read()
    n_tests = text.count("Testing results:")
    log(f"[{label}] train_and_test (sta_final.yml, 2 epochs x {steps} steps of B=16, val "
        f"{n_val}, test {n_test} x {n_tests}): launches {launches}, einsum-path bank "
        f"forwards {einsum[0]}")
    if launches["memory_attention_train_fwd"] != 2 * steps or \
            launches["memory_attention_train_bwd"] != 2 * steps:
        fail(f"[{label}] {2 * steps} steps launched the training kernels "
             f"{launches['memory_attention_train_fwd']} / "
             f"{launches['memory_attention_train_bwd']} times")
    if launches["memory_attention_fused"] < 2 * n_val + n_tests * n_test or einsum[0]:
        fail(f"[{label}] a validation or test forward did not go through kernel #1")
    for line in text.splitlines():
        if not any(p.fullmatch(line) for p in LOG_LINES):
            fail(f"[{label}] log.txt line not of the JAX trainer's shapes: {line!r}")
    losses = [float(x) for x in re.findall(r"Training loss: (\S+)", text)]
    maes = [float(x) for x in re.findall(r"Val criterion: (\S+)", text)]
    log(f"[{label}] train losses {losses}, val MAE {maes}")
    if len(losses) != 2 or len(maes) != 2 or not all(map(math.isfinite, losses + maes)):
        fail(f"[{label}] a loss or val MAE is missing or not finite")

    # ---- times, from the wrappers' marks
    for e, ((t0, t1, tw), (v0, v1, vw)) in enumerate(zip(marks["epoch"], marks["val"])):
        log(f"[{label}] epoch {e}: {t1 - t0:.3f} s; train loop with the loader "
            f"{1e3 * (v0 - t0) / steps:.3f} ms/step, of which waiting for the loader "
            f"{1e3 * tw / steps:.3f} ({steps} steps; phase 5, repeated batch: "
            f"{step_ms_repeated:.3f} ms/step); val {1e3 * (v1 - v0) / n_val:.3f} "
            f"ms/image, of which waiting for the loader {1e3 * vw / n_val:.3f} ({n_val} "
            f"of {FRAME[0]}x{FRAME[1]}); checkpoints and the rest "
            f"{t1 - v1:.3f} s [{gpu}]")

    last = os.path.join(trainer.log_dir, "last.pth")
    best = glob.glob(os.path.join(trainer.log_dir, "best_*.pth"))
    if len(best) != 1 or not os.path.exists(last):
        fail(f"[{label}] checkpoints missing: last {os.path.exists(last)}, best {best}")
    params = raw["model"]["params"]
    if raw.get("ema"):
        # the EMA shadow of the sidecar is what a counter serves
        shadow = torch.load(sidecar_path(last), map_location="cpu", weights_only=True)["ema"]
        weights = torch.load(last, map_location="cpu", weights_only=True)
        served = VideoCounter.from_checkpoint("final", last, dtype=torch.bfloat16,
                                              **params).model.state_dict()
        as_shadow = all(torch.equal(served[k].cpu(), v.to(served[k].dtype))
                        for k, v in shadow.items())
        moved = sum(not torch.equal(shadow[k], weights[k]) for k in shadow)
        log(f"[{label}] VideoCounter.from_checkpoint({os.path.basename(last)}) serves the "
            f"sidecar's EMA shadow: {as_shadow}; {moved} of {len(shadow)} parameters differ "
            f"from the raw weights")
        if not as_shadow or not moved:
            fail(f"[{label}] the counter did not serve the EMA shadow, or the shadow "
                 "equals the raw weights")
    if not check:
        return launches

    # ---- checkpoints: strict loads, and --task test from best_* on the CLI
    for path in (last, best[0]):
        VideoCounter.from_checkpoint("final", path, dtype=torch.bfloat16, **params)
    log(f"VideoCounter.from_checkpoint strict-loaded {os.path.basename(last)} and "
        f"{os.path.basename(best[0])}")
    want = trainer.test(checkpoint=best[0])
    out = subprocess.run([sys.executable, "-m", "dgvcc_tpu_torch", "--config", cfg_path,
                          "--task", "test", "--ckpt", best[0]], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    if out.returncode:
        fail(f"CLI test exited {out.returncode}:\n{out.stderr[-3000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("Testing results:")]
    got = dict(re.findall(r"(\w+): ([\d.]+)", line[-1])) if line else {}
    log(f"CLI --task test {os.path.basename(best[0])}: {line[-1] if line else None}; "
        f"in process: mae {want['mae']:.4f} mse {want['mse']:.4f}")
    for k in ("mae", "mse"):
        if k not in got or abs(float(got[k]) - want[k]) > TOL_CLI_TEST * max(want[k], 1.0):
            fail(f"CLI --task test {k} {got.get(k)} != in-process {want[k]}")
    return launches


# ---- phase 8: the whitening family ------------------------------------------
# trained from configs/baselines/sta_{name}.yml; served at their defaults too
WHITEN_CONFIGS = ("sw", "ibn", "isw")
WHITEN_SERVED = ("sw", "ibn", "isw", "sw_vgg", "sw_densenet", "ibn_densenet")
TOL_SW_OUT = 1e-4                   # SwitchWhiten f32 vs float64 on the card: output,
TOL_SW_STATS = 1e-5                 # and running statistics (relative to the largest)
TOL_WHITEN_COUNTS = 1e-1            # bf16 counter vs the same weights in f32, relative to
                                    # the map's mass sum |d| / log_para. A random head's
                                    # map is signed and its count a cancelling sum; bf16
                                    # conv outputs of mean / std 5 into SW (an untrained
                                    # model's running statistics are zeros) leave sw's
                                    # count 4.6% of the mass (20% of the count) from f32
                                    # at B=1 (run 1, PR 10): a fault of the bf16 path
                                    # (a cast, a dtype) moves it by O(1)
WHITEN_STEPS = 10
ISW_SENSITIVE = [1008.0, 16320.0, 65408.0]  # sites of 64, 256, 512 at relax_denom 2


def check_switch_whiten(gpu):
    """One SwitchWhiten at 256 channels (SW_KW), B=16, 20x20, f32 in train
    mode against the same layer in float64: output and running statistics."""
    import copy

    from dgvcc_tpu_torch.models.whitening import SW_KW
    from dgvcc_tpu_torch.nn.whitening import SwitchWhiten

    g = torch.Generator(device="cuda").manual_seed(80)
    sw = SwitchWhiten(256, **SW_KW).cuda()
    with torch.no_grad():
        for p in (sw.sw_mean_weight, sw.sw_var_weight, sw.bias):
            p.copy_(torch.randn(p.shape, generator=g, device="cuda"))
        sw.weight.copy_(0.5 + torch.rand(256, generator=g, device="cuda"))
    ref = copy.deepcopy(sw).double()
    x = 2.0 * torch.randn(16, 256, 20, 20, generator=g, device="cuda") + 1.0
    out, want = sw.train()(x), ref.train()(x.double())
    errs = {"out": rel_max(out, want)}
    for name in ("running_mean", "running_cov"):
        errs[name] = rel_max(getattr(sw, name), getattr(ref, name))
    log(f"SwitchWhiten 256 ch B=16 20x20 f32 vs float64: out {errs['out']:.3e} (tol "
        f"{TOL_SW_OUT}), running_mean {errs['running_mean']:.3e}, running_cov "
        f"{errs['running_cov']:.3e} (tol {TOL_SW_STATS}) [{gpu}]")
    if errs["out"] > TOL_SW_OUT or max(errs["running_mean"], errs["running_cov"]) > TOL_SW_STATS:
        fail("SwitchWhiten on the card disagrees with float64")
    return errs


def rel_max(a, b):
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def whitening_config(name):
    from dgvcc_tpu_torch.core.config import load_config

    return load_config(os.path.join(ROOT, "configs", "baselines", f"sta_{name}.yml"))


class _AbsMap(torch.nn.Module):
    """A counter's model with |d| for its map: its count is the map's mass."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        out = self.model(x)
        return (out[0] if isinstance(out, tuple) else out).abs()


def serve_whitening(gpu):
    """Each family through VideoCounter: 768x1024 frames at B=1 and B=4 in
    bf16 against the same counter in f32; frames/s at B=4."""
    from dgvcc_tpu_torch.serve import VideoCounter

    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (4,) + FRAME + (3,), dtype=np.uint8)
    fps = {}
    for name in WHITEN_SERVED:
        params = (whitening_config(name).model.get("params", {})
                  if name in WHITEN_CONFIGS else {})
        bf16, f32 = (VideoCounter.from_checkpoint(name, None, dtype=dt, seed=8, **params)
                     for dt in (torch.bfloat16, torch.float32))
        mass = VideoCounter(_AbsMap(f32.model), dtype=torch.float32)
        for b in (1, 4):
            got, want = bf16.count_frames(frames[:b]), f32.count_frames(frames[:b])
            scale = float(mass.count_frames(frames[:b]).max())
            err = float(np.abs(got - want).max())
            log(f"{name} count_frames B={b} 768x1024 bf16: counts {np.round(got, 3).tolist()}, "
                f"f32 {np.round(want, 3).tolist()}, max |diff| {err:.4g} = {err / scale:.4f} of "
                f"the mass {scale:.4g} (tol {TOL_WHITEN_COUNTS})")
            if not np.isfinite(got).all() or err > TOL_WHITEN_COUNTS * max(scale, 1.0):
                fail(f"{name} count_frames B={b}: bf16 counts disagree with f32")
        bf16.count_frames(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            bf16.count_frames(frames)
        fps[name] = 24 / (time.perf_counter() - t0)
        log(f"serve {name} count_frames B=4 768x1024 bf16: {fps[name]:.2f} frames/s [{gpu}]")
        del bf16, f32, mass
        torch.cuda.empty_cache()
    return fps


def whitening_state(name, seed=0):
    """A config's counter at full width, seeded, bf16 compute, f32 AdamW
    with the OneCycle lr of epoch 0; its train step."""
    import dgvcc_tpu_torch.losses  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
    from dgvcc_tpu_torch.train.state import create_train_state
    from dgvcc_tpu_torch.train.steps import build_train_step

    cfg = whitening_config(name)
    model = MODELS.build(name, dtype=torch.bfloat16, **cfg.model.get("params", {}))
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed + seed))
    state = create_train_state(model, cfg.optimizer, cfg.scheduler)
    step = build_train_step(model, LOSSES.build(cfg.loss["name"], **cfg.loss.get("params", {})),
                            cfg.mode, cfg.log_para)
    return cfg, state, step


def time_steps(run, label, gpu, steps=10, batch=TRAIN_B):
    """ms/step over ``steps`` synchronised steps after 3, and the peak
    memory of one above what was resident before it (earlier phases keep
    some tensors alive)."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train {label} (B={batch} {TRAIN_CROP}^2 bf16): {ms:.3f} ms/step, peak memory "
        f"{peak:.3f} GiB ({peak - resident:.3f} GiB above the {resident:.3f} GiB resident) "
        f"[{gpu}]")
    return ms, peak - resident


def device_ms_total(fn, calls):
    """Device time of one call of a function that launches many kernels:
    every device activity of ``calls`` calls (torch.profiler) summed and
    divided by ``calls``; with it the five largest activities by name.
    Without device activities in the trace it fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0].strip()[:60] or e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    if not by_name:
        fail("torch.profiler recorded no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return sum(by_name.values()), top


def sw_site_share(state, step, batch, step_ms_device, gpu):
    """Device time of the SwitchWhiten sites of one sw train step: each
    site's forward and backward run alone on its step's input shape (bf16,
    the model's parameters, train mode), torch.profiler device time,
    summed; against the whole step's."""
    import copy

    from dgvcc_tpu_torch.nn.whitening import SwitchWhiten

    shapes = []
    hooks = [m.register_forward_hook(lambda m, i, o: shapes.append((m, tuple(i[0].shape))))
             for m in state.model.modules() if isinstance(m, SwitchWhiten)]
    step(state, batch, None, 0)
    for h in hooks:
        h.remove()
    total = 0.0
    g = torch.Generator(device="cuda").manual_seed(81)
    for m, shape in shapes:
        site = copy.deepcopy(m).train()
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16).requires_grad_()
        cot = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

        def fwd_bwd():
            site(x).backward(cot)

        ms, top = device_ms_total(fwd_bwd, 5)
        total += ms
        log(f"sw step, SwitchWhiten site {tuple(shape)}: {ms:.4f} ms of device time a "
            f"forward and backward; largest: "
            f"{', '.join(f'{n} {t:.3f}' for n, t in top[:3])} [{gpu}]")
    log(f"sw step: the {len(shapes)} SwitchWhiten sites {total:.3f} ms of the step's "
        f"{step_ms_device:.3f} ms of device time ({100 * total / step_ms_device:.1f}%) [{gpu}]")
    return total, len(shapes)


def train_whitening(gpu):
    """sw and ibn: 10 steps of mode simple on a repeated B=16 batch of 320^2
    crops; isw: a covariance pass on the batch's two views fills the
    tracker, then 10 steps at epoch 6 with its masks. Losses finite and
    falling; ms/step and peak memory; the SW sites' share of the sw step."""
    from dgvcc_tpu_torch.models.whitening import IswCovTracker

    batch = {k: v.contiguous(memory_format=torch.channels_last)
             for k, v in synthetic_batch(3).items()}
    out = {}
    for name in WHITEN_CONFIGS:
        cfg, state, step = whitening_state(name)
        epoch, b = 0, dict(batch)
        if name == "isw":
            params = cfg.model["params"]
            tracker = IswCovTracker(relax_denom=params["relax_denom"],
                                    clusters=params["clusters"])
            state.model.eval()
            with torch.no_grad():
                stats = state.model.cov_stats(torch.cat([batch["img1"][:4], batch["img2"][:4]]))
            tracker.add({k: v.cpu().numpy() for k, v in stats.items()})
            tracker.set_mask_matrix()
            log(f"isw covariance pass (2 views x 4 crops of {TRAIN_CROP}^2): sensitive "
                f"counts {tracker.num_sensitive} (want {ISW_SENSITIVE})")
            if tracker.num_sensitive != ISW_SENSITIVE:
                fail("isw: the sensitive counts are not the relax_denom 2 counts")
            for key, tree in zip(("isw_masks", "isw_nums", "isw_margins"),
                                 tracker.mask_batch()):
                b[key] = {k: v.cuda() for k, v in tree.items()}
            epoch = 6

        def run():
            return step(state, b, None, epoch)[1]

        metrics = [{k: v.item() for k, v in run().items()} for _ in range(WHITEN_STEPS)]
        losses = [m["loss_total"] for m in metrics]
        log(f"train {name} ({cfg.mode}, sta_{name}.yml, epoch {epoch}), {WHITEN_STEPS} steps: "
            f"loss_total {[round(x, 4) for x in losses]}"
            + (f"; loss_wt {[round(m['loss_wt'], 5) for m in metrics]}" if name == "isw" else ""))
        if not all(math.isfinite(v) for m in metrics for v in m.values()):
            fail(f"train {name}: a loss is not finite")
        if not losses[-1] < losses[0]:
            fail(f"train {name}: the loss did not fall ({losses[0]} -> {losses[-1]})")
        if name == "isw" and not all(m["loss_wt"] > 0 for m in metrics):
            fail("train isw: the whitening loss is not on at epoch 6")
        ms, peak = time_steps(run, f"{name} ({cfg.mode})", gpu)
        out[name] = {"ms_per_step": ms, "peak_gib": peak, "losses": losses}
        if name == "sw":
            step_dev, top = device_ms_total(run, 3)
            log(f"train sw step: {step_dev:.3f} ms of device time; largest: "
                f"{', '.join(f'{n} {t:.3f}' for n, t in top)} [{gpu}]")
            out[name]["sw_sites_ms"], out[name]["sw_sites"] = sw_site_share(
                state, step, b, step_dev, gpu)
            out[name]["step_device_ms"] = step_dev
        del state, step
        torch.cuda.empty_cache()
    return out


def isw_file_run(tmp, gpu):
    """DGTrainer.train_and_test with configs/baselines/sta_isw.yml on phase
    6's files for 2 epochs: masks after epoch 0's validation, the JAX
    trainer's log lines, last / best_*, ``--task test`` from best_* through
    the command line's ``main``, and a counter serving best_*."""
    import glob

    import yaml

    from dgvcc_tpu_torch.core.config import Config
    from dgvcc_tpu_torch.serve import VideoCounter
    from dgvcc_tpu_torch.train.trainer import DGTrainer

    with open(os.path.join(ROOT, "configs", "baselines", "sta_isw.yml")) as f:
        raw = yaml.safe_load(f)
    root = os.path.join(tmp, "data")
    for split in ("train", "val", "test"):
        raw[f"{split}_dataset"] = dict(raw[f"{split}_dataset"], params=dict(
            raw[f"{split}_dataset"]["params"], root=root))
    raw.update(num_epochs=2, log_dir=os.path.join(tmp, "logs_isw"))
    cfg_path = os.path.join(tmp, "sta_isw.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    trainer = DGTrainer(Config.from_dict(raw))
    trainer.build()
    tracker = trainer.isw_tracker
    selections = []
    select = tracker.set_mask_matrix

    def recording():
        select()
        selections.append(list(tracker.num_sensitive))

    tracker.set_mask_matrix = recording
    t0 = time.perf_counter()
    trainer.train_and_test()
    log(f"[sta_isw.yml] train_and_test 2 epochs: {time.perf_counter() - t0:.1f}s; masks "
        f"selected after each validation: sensitive counts {selections} [{gpu}]")
    if len(selections) != 2 or selections[0] != ISW_SENSITIVE:
        fail("[sta_isw.yml] the tracker holds no masks after epoch 0's validation")
    text = open(os.path.join(trainer.log_dir, "log.txt")).read()
    patterns = [re.compile(p.pattern.replace("sta_final", "sta_isw")) for p in LOG_LINES]
    for line in text.splitlines():
        if not any(p.fullmatch(line) for p in patterns):
            fail(f"[sta_isw.yml] log.txt line not of the JAX trainer's shapes: {line!r}")
    losses = [float(x) for x in re.findall(r"Training loss: (\S+)", text)]
    maes = [float(x) for x in re.findall(r"Val criterion: (\S+)", text)]
    log(f"[sta_isw.yml] train losses {losses}, val MAE {maes}")
    if len(losses) != 2 or len(maes) != 2 or not all(map(math.isfinite, losses + maes)):
        fail("[sta_isw.yml] a loss or val MAE is missing or not finite")
    last = os.path.join(trainer.log_dir, "last.pth")
    best = glob.glob(os.path.join(trainer.log_dir, "best_*.pth"))
    if len(best) != 1 or not os.path.exists(last):
        fail(f"[sta_isw.yml] checkpoints missing: last {os.path.exists(last)}, best {best}")
    want = trainer.test(checkpoint=best[0])
    out = cli_in_process(["--config", cfg_path, "--task", "test", "--ckpt", best[0]])
    line = [ln for ln in out.splitlines() if ln.startswith("Testing results:")]
    got = dict(re.findall(r"(\w+): ([\d.]+)", line[-1])) if line else {}
    log(f"[sta_isw.yml] CLI --task test {os.path.basename(best[0])}: "
        f"{line[-1] if line else None}; in process: mae {want['mae']:.4f}")
    if "mae" not in got or abs(float(got["mae"]) - want["mae"]) > TOL_CLI_TEST * max(want["mae"],
                                                                                   1.0):
        fail(f"[sta_isw.yml] CLI --task test mae {got.get('mae')} != in-process {want['mae']}")
    frames = np.random.default_rng(9).integers(0, 256, (4,) + FRAME + (3,), dtype=np.uint8)
    counts = VideoCounter.from_checkpoint("isw", best[0], dtype=torch.bfloat16,
                                          **raw["model"]["params"]).count_frames(frames)
    log(f"[sta_isw.yml] VideoCounter.from_checkpoint({os.path.basename(best[0])}) counts "
        f"{np.round(counts, 3).tolist()}")
    if counts.shape != (4,) or not np.isfinite(counts).all():
        fail("[sta_isw.yml] the counter of best_* gave no finite counts")
    return {"mae": want["mae"], "losses": losses}


def whitening_phase(ma, mt, tmp, gpu):
    """Phase 8: the whitening family on the card. Returns what it measured
    and the launches of kernels #1-#3 over it (none run on these models)."""
    t0 = time.perf_counter()
    ma.LAUNCHES = mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
    res = {"sw_check": check_switch_whiten(gpu), "fps_b4": serve_whitening(gpu),
           "train": train_whitening(gpu)}
    # the in-process test and the command line's pick their convolution
    # algorithms the same way (phase 3 turned cuDNN's benchmark on): bf16
    # SW and IW counts follow the algorithm's rounding
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        res["files"] = isw_file_run(tmp, gpu)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    launches = {"memory_attention_fused": ma.LAUNCHES,
                "memory_attention_train_fwd": mt.FWD_LAUNCHES,
                "memory_attention_train_bwd": mt.BWD_LAUNCHES}
    log(f"phase 8 (whitening family): {time.perf_counter() - t0:.1f}s; kernel launches "
        f"{launches}")
    return res, launches


@contextlib.contextmanager
def no_autotune():
    """cuDNN's benchmark off inside, as it was after: the f32 reference
    counters of phases 10 and 11 (TF32 off) take cuDNN's heuristic
    algorithms, not a timed search at every new shape, which their first
    calls paid: a baseline's whole check took up to 48 s at B=4 768x1024.
    The bf16 counters, whose frames/s are reported, keep the search."""
    flag = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = flag


def check_counts(name, got, want, want_label="einsum path"):
    got, want = np.asarray(got), np.asarray(want)
    if not np.isfinite(got).all():
        fail(f"{name}: non-finite counts {got}")
    scale = max(1.0, float(np.abs(want).max()))
    diff = float(np.abs(got - want).max())
    log(f"{name}: counts {np.round(got[:4], 3).tolist()} ... {want_label} "
        f"{np.round(want[:4], 3).tolist()} ... max |diff| {diff:.4g} "
        f"(tol {TOL_COUNTS} x {scale:.4g})")
    if diff > TOL_COUNTS * scale:
        fail(f"{name}: counts disagree with the {want_label}")


def check_cli(frames, VideoCounter):
    """The serve task of the command line (its ``main``, in this process) on
    JPEG frames (sta_final.yml: seed 2112, bf16, the kernel path by
    default), against a counter with the same seeded weights on the same
    decoded frames."""
    import tempfile

    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(tmp, f"frame{i}.jpg"), quality=95)
        decoded = np.stack([np.asarray(Image.open(os.path.join(tmp, f"frame{i}.jpg"))
                                       .convert("RGB")) for i in range(len(frames))])
        t0 = time.perf_counter()
        out = cli_in_process(["--config", os.path.join(ROOT, "configs", "sta_final.yml"),
                              "--task", "serve", "--frames", tmp, "--batch",
                              str(len(frames))])
    lines = out.strip().splitlines()
    log(f"CLI serve (the command line's main, {time.perf_counter() - t0:.1f}s; phase 14 "
        f"serves from a fresh process): {lines[-1]}")
    counts = np.array([float(ln.split()[1]) for ln in lines[:-1]])
    if len(counts) != len(frames):
        fail(f"CLI serve printed {len(counts)} counts for {len(frames)} frames")
    want = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16,
                                        seed=2112).count_frames(decoded)
    check_counts("CLI serve sta_final.yml, 4 JPEG 768x1024", counts, want,
                 "VideoCounter")


# ---- phase 9: HTTP serving and the fleet -----------------------------------

HTTP_FRAMES = 64                    # distinct 768x1024 JPEGs (quality 90), posted in turn
HTTP_CLIENTS = (1, 4, 16)           # concurrent clients, HTTP_FRAMES requests each
HTTP_MAX_BATCH, HTTP_WINDOW = 16, 0.005
TOL_HTTP = 1e-2                     # a count through the server vs count_frames on that
#                                     frame alone, relative to max(|c|, 1): in a batch of
#                                     up to 16 the bf16 convolutions take other algorithms
FLEET_CLIENTS, FLEET_REQUESTS = 8, 32
FLEET_KILL_REQUESTS = 96            # the run in which one replica is SIGKILLed
FLEET_READY_S = 300


def _stress_tool():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import stress_torch_http

    return stress_torch_http


def _check_http_counts(label, counts, want):
    worst = 0.0
    for k, cs in counts.items():
        for c in cs:
            worst = max(worst, abs(c - want[k]) / max(abs(want[k]), 1.0))
    log(f"{label}: counts vs count_frames on each frame alone: max relative diff "
        f"{worst:.3e} (tol {TOL_HTTP})")
    if not worst <= TOL_HTTP:
        fail(f"{label}: a count through the server disagrees with count_frames")
    return worst


def http_phase(ma, counter, serve_fps, gpu):
    """Phase 9a: an in-process CountingServer over phase 3's counter (final,
    bf16, seed 0): 64 distinct JPEGs from 1, 4 and 16 clients, each load
    from scripts/stress_torch_http.py in a process of its own (its threads
    do not take the server's GIL). Returns what it measured and kernel #1's
    launches in the served run."""
    import urllib.request

    from PIL import Image

    from dgvcc_tpu_torch.serve_http import METRICS, CountingServer

    st = _stress_tool()
    t0 = time.perf_counter()
    bodies = st.encode_frames(HTTP_FRAMES, *FRAME, seed=90, quality=90)
    decoded = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB")) for b in bodies]
    want = [float(counter.count_frames(f[None])[0]) for f in decoded]
    log(f"http: {HTTP_FRAMES} JPEGs of {FRAME[0]}x{FRAME[1]} encoded, decoded and counted "
        f"alone in {time.perf_counter() - t0:.1f}s")
    srv = CountingServer(counter, port=0, model_name="final", max_batch=HTTP_MAX_BATCH,
                         batch_window=HTTP_WINDOW)
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"
    res = {}
    # as the command line's --http: with cuDNN's benchmark on (phase 3) each
    # new micro-batch size would time every convolution's algorithms first
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        ma.LAUNCHES = 0
        st.post_count(url, bodies[0])
        for clients in HTTP_CLIENTS:
            path = os.path.join(tempfile.gettempdir(), f"chip_smoke_http_{clients}.json")
            out = subprocess.run(
                [sys.executable, os.path.join(ROOT, "scripts", "stress_torch_http.py"),
                 "--url", url, "--clients", str(clients), "--requests", str(HTTP_FRAMES),
                 "--frames", str(HTTP_FRAMES), "--hw", *map(str, FRAME), "--seed", "90",
                 "--quality", "90", "--json", path],
                capture_output=True, text=True, timeout=600, cwd=ROOT)
            if out.returncode or not os.path.exists(path):
                fail(f"http {clients} clients: the load exited {out.returncode}:\n"
                     f"{out.stderr[-3000:]}")
            with open(path) as f:
                r = json.load(f)
            os.remove(path)
            if r["errors"] or r["requests"] != HTTP_FRAMES:
                fail(f"http {clients} clients: {r['errors']} errors, {r['requests']} answers")
            counts = {int(k): v for k, v in r.pop("counts").items()}
            r["max_rel_diff"] = _check_http_counts(f"http {clients} clients", counts, want)
            log(f"http POST /count, {clients} clients x {HTTP_FRAMES} JPEG 768x1024, final "
                f"bf16: {r['req_per_s']:.2f} req/s, p50 {r['p50_ms']:.2f} ms, p95 "
                f"{r['p95_ms']:.2f} ms, mean batch {r['mean_batch']:.2f}, /stats fps "
                f"{r['device_fps']:.2f} (count_frames in phase 4: B=1 {serve_fps[1]:.2f}, "
                f"B=4 {serve_fps[4]:.2f}, B=16 {serve_fps[16]:.2f} frames/s) [{gpu}]")
            res[clients] = r
        launches = ma.LAUNCHES
        if not res[HTTP_CLIENTS[-1]]["mean_batch"] > 1:
            fail(f"http: mean batch {res[HTTP_CLIENTS[-1]]['mean_batch']} at "
                 f"{HTTP_CLIENTS[-1]} clients, not above 1")
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            text = r.read().decode()
        stats = st.get_json(url, "/stats")
        values = dict(ln.split() for ln in text.splitlines() if not ln.startswith("#"))
        for name, key in METRICS:
            want_v = stats[key] - (key == "requests")  # the /stats request after it
            if float(values[name]) != want_v:
                fail(f"http /metrics {name} {values[name]} != /stats {key} {want_v}")
        log(f"http /metrics equals /stats: frames {stats['frames']}, batches "
            f"{stats['batches']}, requests {stats['requests']}, device_s "
            f"{stats['device_s']:.3f}; kernel #1 launched {launches}x")
        if launches == 0:
            fail("http: the served run never launched kernel #1")
    finally:
        srv.shutdown()
        torch.backends.cudnn.benchmark = benchmark
    return res, launches, bodies, decoded


def fleet_phase(bodies, decoded, gpu):
    """Phase 9b: the fleet on the one card, configs/sta_final.yml
    (checkpoint null: seed 2112), 2 replicas of the command line's --http
    (--devices 0,0), restart on."""
    import threading

    from dgvcc_tpu_torch.serve import VideoCounter
    from dgvcc_tpu_torch.serve_fleet import FleetServer

    st = _stress_tool()
    bodies = bodies[:16]
    ref = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16, seed=2112)
    want = [float(ref.count_frames(f[None])[0]) for f in decoded[:16]]
    del ref
    torch.cuda.empty_cache()
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    fleet = FleetServer(os.path.join(ROOT, "configs", "sta_final.yml"), replicas=2,
                        devices=["0", "0"], port=0, host="127.0.0.1", batch=HTTP_MAX_BATCH,
                        restart=True, probe_s=0.5)
    url = None
    try:
        t0 = time.perf_counter()
        fleet.start(ready_timeout=FLEET_READY_S)
        url = f"http://127.0.0.1:{fleet.port}"
        deadline = time.monotonic() + FLEET_READY_S
        while st.get_json(url, "/healthz")["status"] != "ok":
            if time.monotonic() > deadline:
                fail("fleet: the two replicas did not both come up")
            time.sleep(0.25)
        ready = [round(r.ready_s, 3) for r in fleet.replicas]
        log(f"fleet: 2 replicas on card 0 ready in {ready} s (from spawn; both up "
            f"{time.perf_counter() - t0:.1f}s after the start) [{gpu}]")
        st.post_count(url, bodies[0])
        st.post_count(url, bodies[1])  # each replica's first forward, untimed
        r = st.load_report(url, bodies, FLEET_CLIENTS, FLEET_REQUESTS)
        if r["errors"]:
            fail(f"fleet: {r['errors']} client errors")
        _check_http_counts("fleet", r.pop("counts"), want)
        per = st.get_json(url, "/stats")["replicas"]
        frames = [p["frames"] for p in per]
        log(f"fleet POST /count, {FLEET_CLIENTS} clients x {FLEET_REQUESTS} JPEG 768x1024: "
            f"{r['req_per_s']:.2f} req/s, p50 {r['p50_ms']:.2f} ms, p95 {r['p95_ms']:.2f} ms, "
            f"mean batch {r['mean_batch']:.2f}; replicas' frames {frames} [{gpu}]")
        if len(frames) != 2 or not all(f > 0 for f in frames):
            fail(f"fleet: a replica served no frame ({frames})")

        # SIGKILL one replica mid-run: no client error, the sums never fall
        totals, stop = [], threading.Event()

        def monitor():
            while not stop.is_set():
                s = st.get_json(url, "/stats")
                totals.append((s["frames"], s["batches"], s["device_s"]))
                time.sleep(0.1)

        mon = threading.Thread(target=monitor, daemon=True)
        mon.start()
        loaded = {}
        load = threading.Thread(target=lambda: loaded.update(
            r=st.run_load(url, bodies, FLEET_CLIENTS, FLEET_KILL_REQUESTS)))
        start_frames = st.get_json(url, "/stats")["frames"]
        load.start()
        victim = fleet.replicas[0]
        old_port = victim.port
        while st.get_json(url, "/stats")["frames"] < start_frames + 16 and load.is_alive():
            time.sleep(0.02)
        mid_run = load.is_alive()
        os.kill(victim.proc.pid, signal.SIGKILL)
        load.join(timeout=600)
        wall, counts, _, errors = loaded["r"]
        log(f"fleet: replica :{old_port} SIGKILLed {'during' if mid_run else 'AFTER'} a run "
            f"of {FLEET_KILL_REQUESTS} requests: {len(errors)} client errors, "
            f"{sum(map(len, counts.values()))} answers in {wall:.2f}s")
        if not mid_run or errors:
            fail(f"fleet: the kill was not mid-run ({mid_run}) or clients saw errors "
                 f"{errors[:3]}")
        _check_http_counts("fleet through the kill", counts, want)
        deadline = time.monotonic() + FLEET_READY_S
        while not (victim.restarts >= 1 and victim.healthy and victim.ready_s is not None):
            if time.monotonic() > deadline:
                fail("fleet: the killed replica was not respawned")
            time.sleep(0.25)
        r2 = st.load_report(url, bodies, FLEET_CLIENTS, FLEET_REQUESTS)
        stop.set()
        mon.join(timeout=60)
        if r2["errors"]:
            fail(f"fleet after the respawn: {r2['errors']} client errors")
        falls = [(a, b) for a, b in zip(totals, totals[1:])
                 if any(y < x for x, y in zip(a, b))]
        log(f"fleet: respawned on :{victim.port} (was :{old_port}), ready in "
            f"{victim.ready_s:.3f}s; {len(totals)} /stats reads through the kill and "
            f"respawn, frames {totals[0][0]} -> {totals[-1][0]}, falls {len(falls)}; after it "
            f"(its first forwards included): {r2['req_per_s']:.2f} req/s [{gpu}]")
        if falls or victim.port == old_port:
            fail(f"fleet: the summed /stats fell ({falls[:3]}) or the port was reused")
        return {"req_per_s": r["req_per_s"], "p50_ms": r["p50_ms"], "p95_ms": r["p95_ms"],
                "ready_s": ready, "respawn_ready_s": victim.ready_s}
    finally:
        fleet.shutdown()
        if any(rep.alive() for rep in fleet.replicas):
            fail("fleet: a replica outlived the shutdown")


# ---- phase 10: the U-Net regressors ----------------------------------------

REGRESSOR_TRAIN = (("dgnet", "sta_reg_base.yml"), ("dgnet", "sta_dis.yml"),
                   ("reg_mem", "sta_reg.yml"))
REGRESSORS_SERVED = ("dgnet", "dgnet_cls", "reg", "reg_mem")
REGRESSOR_STEPS = 10
TOL_REGRESSOR_COUNTS = 2e-2         # bf16 vs f32 counts, relative to the map's mass, with
#                                     the f32 twin's classifier gate: a gate binarised at
#                                     0.5 flips whole 16x16 blocks on bf16 noise (the JAX
#                                     package's own bf16 `reg` moves 2-26% of the mass so,
#                                     its ungated density 0.1-0.6%: scripts/bf16_drift.py)
# where a regressor's stride-16 classifier map sits in its output
CLS_OF = {"dgnet_cls": lambda out: out[1][1], "reg": lambda out: out[2],
          "reg_mem": lambda out: out[1]}


def config_state(config, model_name=None, params=None):
    """A config's model at full width (or ``model_name``), seeded, bf16
    compute, f32 AdamW with the OneCycle lr of epoch 0."""
    import dgvcc_tpu_torch.losses  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
    from dgvcc_tpu_torch.train.state import create_train_state

    cfg = load_config(os.path.join(ROOT, "configs", config))
    name = model_name or cfg.model["name"]
    kw = cfg.model.get("params", {}) if params is None else params
    model = MODELS.build(name, dtype=torch.bfloat16, **kw)
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    state = create_train_state(model, cfg.optimizer, cfg.scheduler)
    return cfg, model, state, LOSSES.build(cfg.loss["name"], **cfg.loss.get("params", {}))


def regressor_state(config):
    """A regressor config's model at full width, seeded, bf16 compute, f32
    AdamW with the OneCycle lr of epoch 0 (``config_state``); its train step."""
    from dgvcc_tpu_torch.train.steps import build_train_step

    cfg, model, state, loss = config_state(config)
    return cfg, state, build_train_step(model, loss, cfg.mode, cfg.log_para)


def train_regressors(mt, gpu):
    """dgnet (simple, discrimination) and reg_mem (regression): 10 steps on
    a repeated B=16 two-view batch of 320^2 crops; every loss part finite;
    ms/step on the host clock and in device time, peak memory."""
    batch = {k: v.contiguous(memory_format=torch.channels_last)
             for k, v in synthetic_batch(4).items()}
    out = {}
    mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
    for name, config in REGRESSOR_TRAIN:
        cfg, state, step = regressor_state(config)
        dropout = torch.Generator(device="cuda").manual_seed(cfg.seed)

        def run():
            return step(state, batch, dropout, 0)[1]

        metrics = [{k: v.item() for k, v in run().items()} for _ in range(REGRESSOR_STEPS)]
        label = f"{name} ({cfg.mode}, {config})"
        log(f"train {label}, {REGRESSOR_STEPS} steps: "
            + "; ".join(f"{k} {[round(m[k], 4) for m in metrics]}" for k in metrics[0]))
        if not all(math.isfinite(v) for m in metrics for v in m.values()):
            fail(f"train {label}: a loss part is not finite")
        ms, peak = time_steps(run, label, gpu)
        dev, top = device_ms_total(run, 3)
        log(f"train {label}: {dev:.3f} ms of device time a step; largest: "
            f"{', '.join(f'{n} {t:.3f}' for n, t in top[:3])} [{gpu}]")
        out[config] = {"ms_per_step": ms, "device_ms": dev, "peak_gib": peak,
                       "losses": [m["loss_total"] for m in metrics]}
        del state, step
        torch.cuda.empty_cache()
    if mt.FWD_LAUNCHES or mt.BWD_LAUNCHES:
        fail("train regressors: reg_mem's forward_train must take the einsum path, not "
             "kernels #2/#3")
    return out


class _GatedBy(torch.nn.Module):
    """A regressor whose binarised classifier gate (``c_gt``) comes from its
    f32 twin, so that only the bf16 path's arithmetic moves its count."""

    def __init__(self, model, twin, cls_of):
        super().__init__()
        self.model, self.twin, self.cls_of = model, twin, cls_of

    def forward(self, x):
        c = self.cls_of(self.twin(x.float()))
        return self.model(x, c_gt=(c >= 0.5).float())[0]


def serve_regressors(ma, gpu):
    """Each family through VideoCounter at B=4, 768x1024: bf16 against the
    same counter in f32 (2e-2 of the map's mass, with the f32 classifier's
    gate where there is one; the served counts' own drift logged beside),
    frames/s; reg_mem's bank through kernel #1 against the einsum path
    (2e-2), with #1's launches."""
    from dgvcc_tpu_torch.serve import VideoCounter

    frames = np.random.default_rng(10).integers(0, 256, (4,) + FRAME + (3,), dtype=np.uint8)
    fps, errs, launches = {}, {}, 0
    # the f32 counter in float32, not TF32 (phase 8's whitening refuses TF32 itself)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for name in REGRESSORS_SERVED:
        bf16, f32 = (VideoCounter.from_checkpoint(name, None, dtype=dt, seed=10)
                     for dt in (torch.bfloat16, torch.float32))
        mass = VideoCounter(_AbsMap(f32.model), dtype=torch.float32)
        ma.LAUNCHES = 0
        got = bf16.count_frames(frames)
        n = ma.LAUNCHES
        launches += n
        with no_autotune():
            want = f32.count_frames(frames)
            scale = max(float(mass.count_frames(frames).max()), 1.0)
        served = float(np.abs(got - want).max()) / scale
        gated = got
        if name in CLS_OF:
            with torch.no_grad():
                gated = VideoCounter(_GatedBy(bf16.model, f32.model, CLS_OF[name]),
                                     dtype=torch.bfloat16).count_frames(frames)
        errs[name] = {"served": served, "gated": float(np.abs(gated - want).max()) / scale}
        log(f"{name} count_frames B=4 768x1024 bf16: counts {np.round(got, 3).tolist()}, f32 "
            f"{np.round(want, 3).tolist()}: {served:.4f} of the mass {scale:.4g}"
            + (f"; with the f32 classifier's gate {np.round(gated, 3).tolist()}: "
               f"{errs[name]['gated']:.4f}" if name in CLS_OF else "")
            + f" (tol {TOL_REGRESSOR_COUNTS})")
        if not np.isfinite(got).all() or errs[name]["gated"] > TOL_REGRESSOR_COUNTS:
            fail(f"{name} count_frames: bf16 counts disagree with f32")
        if name == "reg_mem":
            plain = VideoCounter.from_checkpoint(name, None, dtype=torch.bfloat16, seed=10,
                                                 fused_mem=False)
            ma.LAUNCHES = 0
            check_counts("reg_mem count_frames B=4 768x1024, kernel #1", got,
                         plain.count_frames(frames))
            log(f"reg_mem serving: kernel #1 launched {n}x for one B=4 call")
            if n != 1 or ma.LAUNCHES:
                fail("reg_mem serving: kernel #1 not launched once per forward, or the "
                     "einsum counter launched it")
            del plain
        elif n:
            fail(f"{name} serving launched kernel #1 (it has no bank)")
        bf16.count_frames(frames)
        torch.cuda.synchronize()
        ma.LAUNCHES = 0
        t0 = time.perf_counter()
        for _ in range(6):
            bf16.count_frames(frames)
        fps[name] = 24 / (time.perf_counter() - t0)
        launches += ma.LAUNCHES
        log(f"serve {name} count_frames B=4 768x1024 bf16: {fps[name]:.2f} frames/s [{gpu}]")
        del bf16, f32, mass
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return fps, errs, launches


class _Tee(io.StringIO):
    """Standard output kept while it is printed."""

    def write(self, s):
        sys.__stdout__.write(s)
        return super().write(s)


def cli_in_process(args):
    """The command line's ``main`` on ``args`` in this process, its standard
    output. Phase 6's ``--task test`` and phase 14's ``--task serve
    --artifact`` run in fresh processes; the other command-line tasks run
    here, without a process start-up each."""
    from dgvcc_tpu_torch.cli.main import main as cli_main

    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        cli_main(args)
    return tee.getvalue()


def regressor_file_runs(ma, mt, tmp, gpu):
    """DGTrainer.train_and_test on phase 6's files: sta_reg_base.yml (dgnet)
    for 2 epochs (800-px tiles, a test after each epoch, --task test through
    the command line's main against the trainer's MAE), then sta_reg.yml
    (reg_mem, regression) for 1 epoch (#1 in validation and test)."""
    import yaml

    from dgvcc_tpu_torch.core.config import Config
    from dgvcc_tpu_torch.train.trainer import DGTrainer

    def config(name, epochs):
        with open(os.path.join(ROOT, "configs", f"{name}.yml")) as f:
            raw = yaml.safe_load(f)
        for split in ("train", "val", "test"):
            raw[f"{split}_dataset"] = dict(raw[f"{split}_dataset"], params=dict(
                raw[f"{split}_dataset"]["params"], root=os.path.join(tmp, "data")))
        raw.update(num_epochs=epochs, log_dir=os.path.join(tmp, f"logs_{name}"))
        path = os.path.join(tmp, f"{name}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
        return raw, path

    raw, cfg_path = config("sta_reg_base", 2)
    trainer = DGTrainer(Config.from_dict(raw))
    t0 = time.perf_counter()
    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        trainer.train_and_test()
    text = open(os.path.join(trainer.log_dir, "log.txt")).read()
    losses = [float(x) for x in re.findall(r"Training loss: (\S+)", text)]
    maes = [float(x) for x in re.findall(r"Testing results: mae: (\S+)", text)]
    said = "validation and test on tiles of 800 px" in tee.getvalue()
    log(f"[sta_reg_base.yml] dgnet train_and_test 2 epochs: {time.perf_counter() - t0:.1f}s; "
        f"eval tile {trainer.counter.patch_size} px (printed: {said}); losses {losses}; test "
        f"MAE after each epoch {maes} [{gpu}]")
    if trainer.counter.patch_size != 800 or not said:
        fail("[sta_reg_base.yml] dgnet does not evaluate on 800-px tiles")
    if len(maes) != 2 or len(losses) != 2 or not all(map(math.isfinite, losses + maes)):
        fail("[sta_reg_base.yml] not one finite test block after each epoch")
    patterns = [re.compile(p.pattern.replace("sta_final", "sta_reg_base")) for p in LOG_LINES]
    for line in text.splitlines():
        if not any(p.fullmatch(line) for p in patterns):
            fail(f"[sta_reg_base.yml] log.txt line not of the JAX trainer's shapes: {line!r}")
    last = os.path.join(trainer.log_dir, "last.pth")
    want = trainer.test(checkpoint=last)
    out = cli_in_process(["--config", cfg_path, "--task", "test", "--ckpt", last])
    line = [ln for ln in out.splitlines() if ln.startswith("Testing results:")]
    got = dict(re.findall(r"(\w+): ([\d.]+)", line[-1])) if line else {}
    log(f"[sta_reg_base.yml] CLI --task test last.pth: {line[-1] if line else None}; in "
        f"process: mae {want['mae']:.4f}")
    if "mae" not in got or abs(float(got["mae"]) - want["mae"]) > TOL_CLI_TEST * max(
            want["mae"], 1.0):
        fail(f"[sta_reg_base.yml] CLI --task test mae {got.get('mae')} != in-process "
             f"{want['mae']}")

    raw, _ = config("sta_reg", 1)
    trainer = DGTrainer(Config.from_dict(raw))
    ma.LAUNCHES = mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer.train_and_test()
    launches = ma.LAUNCHES
    text = open(os.path.join(trainer.log_dir, "log.txt")).read()
    losses = [float(x) for x in re.findall(r"Training loss: (\S+)", text)]
    maes = [float(x) for x in re.findall(r"(?:Val criterion|Testing results: mae): (\S+)",
                                         text)]
    n_eval = len(trainer.loaders["val"]) + len(trainer.loaders["test"])
    log(f"[sta_reg.yml] reg_mem regression 1 epoch: {time.perf_counter() - t0:.1f}s; loss "
        f"{losses}, val and test MAE {maes}; kernel #1 launched {launches}x over "
        f"{n_eval} val and test images; #2 / #3 {mt.FWD_LAUNCHES} / {mt.BWD_LAUNCHES} [{gpu}]")
    if len(losses) != 1 or len(maes) != 2 or not all(map(math.isfinite, losses + maes)):
        fail("[sta_reg.yml] a loss or MAE is missing or not finite")
    if launches < n_eval:
        fail("[sta_reg.yml] validation and test did not run through kernel #1")
    return {"dgnet_test_mae": maes, "reg_mem_launches": launches}, launches


def regressor_phase(ma, mt, tmp, gpu):
    """Phase 10: the U-Net regressors. Returns what it measured and kernel
    #1's launches over its in-process paths."""
    t0 = time.perf_counter()
    res = {"train": train_regressors(mt, gpu)}
    res["fps_b4"], res["bf16_err"], serve_launches = serve_regressors(ma, gpu)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False  # as the command line's --task test
    try:
        res["files"], file_launches = regressor_file_runs(ma, mt, tmp, gpu)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    launches = {"memory_attention_fused": serve_launches + file_launches,
                "memory_attention_train_fwd": mt.FWD_LAUNCHES,
                "memory_attention_train_bwd": mt.BWD_LAUNCHES}
    log(f"phase 10 (regressors): {time.perf_counter() - t0:.1f}s; kernel launches {launches}")
    return res, launches


# ---- phase 11: the generator and the classic baselines ------------------------

BASELINES = ("csrnet", "mcnn", "sasnet", "dssinet", "cctrans", "bl")
GEN_STEPS = 10
TOL_BASELINE_COUNTS = 2e-2          # bf16 vs f32 counts, relative to the map's mass
# dssinet untrained in bf16 (no norm layer, PReLUs, three scales summed): the
# JAX package's own bf16 moves 2.37-2.45% of the mass with the same weights
# (scripts/bf16_drift.py dssinet --port-seed 11 at 384x512 on the CPU), the
# port 2.43-2.49% there and 2.3-2.8% on the card, port against JAX in bf16
# 0.04-0.06%
TOL_BASELINE_FAMILY = {"dssinet": 5e-2}


def baseline_batch(cfg, seed, b=None):
    """A repeated batch of 320^2 crops for a baseline config (B: the
    config's, 8, unless ``b``): the image, and either the density map
    summed to the config's stride (MSE) or, for the Bayesian loss, 20-200
    head points a crop in padded form with their targets and crop sizes
    (the bay collate's)."""
    ds = cfg.train_dataset["params"]
    b = b or cfg.train_loader["batch_size"]
    full = synthetic_batch(seed, b=b)
    batch = {"img1": full["img1"]}
    if cfg.loss["name"] != "bl":
        f = int(ds["downsample"])
        batch["dmap"] = torch.nn.functional.avg_pool2d(full["dmap"], f) * f * f
        return {k: v.contiguous(memory_format=torch.channels_last) for k, v in batch.items()}
    g = torch.Generator().manual_seed(seed)
    counts = torch.randint(20, 201, (b,), generator=g)
    n = int(math.ceil(int(counts.max()) / 64) * 64)
    mask = torch.arange(n)[None] < counts[:, None]
    points = torch.rand(b, n, 2, generator=g) * TRAIN_CROP * mask[..., None]
    targets = (0.3 + 0.7 * torch.rand(b, n, generator=g)) * mask
    batch.update(points=points.cuda(), pt_mask=mask.cuda(), targets=targets.cuda(),
                 st_sizes=torch.full((b,), float(FRAME[0])).cuda())
    batch["img1"] = batch["img1"].contiguous(memory_format=torch.channels_last)
    return batch


def train_generator_and_baselines(mt, gpu):
    """gen (generation), the joint step and the six baselines: ten steps on
    a repeated batch (finite, falling losses, no #2 / #3), then ms/step on
    the host clock and in device time, and peak memory."""
    from dgvcc_tpu_torch.train.genjoint import build_joint_step
    from dgvcc_tpu_torch.train.steps import build_train_step

    runs = []
    cfg, gen, gstate, loss = config_state("sta_gen.yml")
    runs.append(("gen (generation, sta_gen.yml)", cfg, synthetic_batch(11),
                 build_train_step(gen, loss, "generation", cfg.log_para), gstate))
    cfg, gen, gstate, loss = config_state("sta_joint.yml", "gen", {})
    _, reg, rstate, _ = config_state("sta_joint.yml", "reg_mem", {})
    joint = build_joint_step(gen, reg, loss, cfg.log_para)
    runs.append(("gen + reg_mem (joint, sta_joint.yml)", cfg, synthetic_batch(12),
                 lambda st, batch, g, epoch: (st, joint(st[0], st[1], batch, g, epoch)[2]),
                 (gstate, rstate)))
    for i, name in enumerate(BASELINES):
        cfg, model, state, loss = config_state(f"baselines/sta_{name}.yml")
        runs.append((f"{name} ({cfg.loss['name']}, sta_{name}.yml)", cfg,
                     baseline_batch(cfg, 20 + i),
                     build_train_step(model, loss, cfg.mode, cfg.log_para), state))
    out = {}
    mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
    for label, cfg, batch, step, state in runs:
        dropout = torch.Generator(device="cuda").manual_seed(cfg.seed)

        def run():
            return step(state, batch, dropout, 0)[1]

        metrics = [{k: v.item() for k, v in run().items()} for _ in range(GEN_STEPS)]
        losses = [m["loss_total"] for m in metrics]
        log(f"train {label}, {GEN_STEPS} steps: "
            + "; ".join(f"{k} {[round(m[k], 4) for m in metrics]}" for k in metrics[0]))
        if not all(math.isfinite(v) for m in metrics for v in m.values()):
            fail(f"train {label}: a loss part is not finite")
        # the mean of the last three: bl from scratch and dssinet swing from
        # step to step on their way down
        if not sum(losses[-3:]) / 3 < losses[0]:
            fail(f"train {label}: the loss did not fall over {GEN_STEPS} steps on a repeated "
                 "batch")
        b = batch["img1"].shape[0]
        ms, peak = time_steps(run, label, gpu, batch=b)
        dev, top = device_ms_total(run, 3)
        log(f"train {label}: {dev:.3f} ms of device time a step; largest: "
            f"{', '.join(f'{n} {t:.3f}' for n, t in top[:3])} [{gpu}]")
        out[label] = {"batch": b, "ms_per_step": ms, "device_ms": dev, "peak_gib": peak,
                      "losses": losses}
    del runs, state, step
    torch.cuda.empty_cache()
    if mt.FWD_LAUNCHES or mt.BWD_LAUNCHES:
        fail("train generator / baselines: kernels #2 / #3 launched (reg_mem's forward_train "
             "takes the einsum path)")
    return out


def serve_baselines(ma, gpu):
    """The six through VideoCounter at B=4, 768x1024: bf16 against the same
    weights in float32 (TF32 off), relative to the map's mass; frames/s."""
    from dgvcc_tpu_torch.serve import VideoCounter

    frames = np.random.default_rng(11).integers(0, 256, (4,) + FRAME + (3,), dtype=np.uint8)
    fps, errs = {}, {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    ma.LAUNCHES = 0
    for name in BASELINES:
        bf16, f32 = (VideoCounter.from_checkpoint(name, None, dtype=dt, seed=11)
                     for dt in (torch.bfloat16, torch.float32))
        got = bf16.count_frames(frames)
        with no_autotune():
            want = f32.count_frames(frames)
            mass = VideoCounter(_AbsMap(f32.model), dtype=torch.float32).count_frames(frames)
        scale = max(float(mass.max()), 1.0)
        errs[name] = float(np.abs(got - want).max()) / scale
        tol = TOL_BASELINE_FAMILY.get(name, TOL_BASELINE_COUNTS)
        log(f"{name} count_frames B=4 768x1024 bf16: counts {np.round(got, 3).tolist()}, f32 "
            f"{np.round(want, 3).tolist()}: {errs[name]:.4f} of the mass {scale:.4g} (tol "
            f"{tol})")
        if not np.isfinite(got).all() or errs[name] > tol:
            fail(f"{name} count_frames: bf16 counts disagree with f32")
        bf16.count_frames(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            bf16.count_frames(frames)
        fps[name] = 24 / (time.perf_counter() - t0)
        log(f"serve {name} count_frames B=4 768x1024 bf16: {fps[name]:.2f} frames/s [{gpu}]")
        del bf16, f32
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    if ma.LAUNCHES:
        fail("baseline serving launched kernel #1 (no baseline has a bank)")
    return fps, errs


def phase_config(tmp, name, epochs, edit=None):
    """configs/{name}.yml pointed at phase 6's files, for ``epochs``, changed
    by ``edit(raw)`` where given; (raw dict, its path)."""
    import yaml

    with open(os.path.join(ROOT, "configs", f"{name}.yml")) as f:
        raw = yaml.safe_load(f)
    for split in ("train", "val", "test"):
        raw[f"{split}_dataset"] = dict(raw[f"{split}_dataset"], params=dict(
            raw[f"{split}_dataset"]["params"], root=os.path.join(tmp, "data")))
    stem = os.path.basename(name)
    raw.update(num_epochs=epochs, log_dir=os.path.join(tmp, f"logs_{stem}"))
    if edit is not None:
        edit(raw)
    path = os.path.join(tmp, f"{stem}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return raw, path


def generator_file_runs(ma, mt, tmp, gpu):
    """sta_bl.yml (2 epochs, the implied stride, CLI --task test), sta_gen.yml
    (1 epoch, CLI --task generate) and sta_joint.yml (1 epoch, --task test from
    [last_gen, last_reg] through the command line's main in process, kernel #1
    once per test image) on phase 6's files. Returns what they measured and
    #1's launches."""
    from dgvcc_tpu_torch.cli.main import main as cli_main
    from dgvcc_tpu_torch.core.config import Config
    from dgvcc_tpu_torch.train.trainer import DGTrainer

    res = {}
    # the loss's stride left to the prediction: 320 // 40
    raw, cfg_path = phase_config(tmp, "baselines/sta_bl", 2,
                                 edit=lambda raw: raw["loss"]["params"].pop("stride"))
    trainer = DGTrainer(Config.from_dict(raw))
    t0 = time.perf_counter()
    trainer.train_and_test()
    text = open(os.path.join(trainer.log_dir, "log.txt")).read()
    losses = [float(x) for x in re.findall(r"Training loss: (\S+)", text)]
    maes = [float(x) for x in re.findall(r"Testing results: mae: (\S+)", text)]
    log(f"[sta_bl.yml] bl, the Bayesian loss (stride {trainer.loss.stride_for(40)} from the "
        f"prediction) train_and_test 2 epochs: {time.perf_counter() - t0:.1f}s; losses "
        f"{losses}; test MAE after each epoch {maes} [{gpu}]")
    if len(losses) != 2 or len(maes) != 2 or not all(map(math.isfinite, losses + maes)):
        fail("[sta_bl.yml] not one finite loss and test block after each epoch")
    last = os.path.join(trainer.log_dir, "last.pth")
    want = trainer.test(checkpoint=last)
    line = [ln for ln in cli_in_process(["--config", cfg_path, "--task", "test", "--ckpt",
                                         last]).splitlines()
            if ln.startswith("Testing results:")]
    got = dict(re.findall(r"(\w+): ([\d.]+)", line[-1])) if line else {}
    log(f"[sta_bl.yml] CLI --task test last.pth: {line[-1] if line else None}; in process: "
        f"mae {want['mae']:.4f}")
    if "mae" not in got or abs(float(got["mae"]) - want["mae"]) > TOL_CLI_TEST * max(
            want["mae"], 1.0):
        fail(f"[sta_bl.yml] CLI --task test mae {got.get('mae')} != in-process {want['mae']}")
    res["bl_test_mae"] = maes

    raw, cfg_path = phase_config(tmp, "sta_gen", 1)
    trainer = DGTrainer(Config.from_dict(raw))
    t0 = time.perf_counter()
    trainer.train_and_test()
    text = open(os.path.join(trainer.log_dir, "log.txt")).read()
    crit = [float(x) for x in re.findall(r"Val criterion: (\S+)", text)]
    n_train = len(trainer.loaders["train"].dataset)
    log(f"[sta_gen.yml] gen, generation 1 epoch: {time.perf_counter() - t0:.1f}s; "
        f"{re.findall(r'Training loss: (\S+)', text)}; reconstruction MSE (val, test) {crit}")
    if len(crit) < 2 or not all(map(math.isfinite, crit)):
        fail("[sta_gen.yml] no finite validation and test criterion")
    t0 = time.perf_counter()
    cli_in_process(["--config", cfg_path, "--task", "generate", "--ckpt",
                    os.path.join(trainer.log_dir, "last.pth")])
    gen_dir = os.path.join(trainer.log_dir, "gen")
    written = sorted(os.listdir(gen_dir))
    log(f"[sta_gen.yml] --task generate (the command line's main): {len(written)} images in "
        f"{time.perf_counter() - t0:.1f}s under gen/ ({written[:2]} ...)")
    if len(written) != n_train or not all(w.endswith("_a.jpg") for w in written):
        fail(f"[sta_gen.yml] --task generate wrote {len(written)} files, not one _a.jpg per "
             f"train image ({n_train})")

    raw, cfg_path = phase_config(tmp, "sta_joint", 1)
    trainer = DGTrainer(Config.from_dict(raw))
    ma.LAUNCHES = mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer.train_and_test()
    launches = ma.LAUNCHES
    text = open(os.path.join(trainer.log_dir, "log.txt")).read()
    pair = [os.path.join(trainer.log_dir, f"last_{m}.pth") for m in ("gen", "reg")]
    log(f"[sta_joint.yml] gen + reg_mem, joint 1 epoch: {time.perf_counter() - t0:.1f}s; "
        f"{re.findall(r'Training loss: (\S+)', text)}; kernel #1 launched {launches}x; #2 / "
        f"#3 {mt.FWD_LAUNCHES} / {mt.BWD_LAUNCHES}; files "
        f"{sorted(f for f in os.listdir(trainer.log_dir) if f.endswith('.pth'))} [{gpu}]")
    if not all(os.path.exists(p) for p in pair) or mt.FWD_LAUNCHES or mt.BWD_LAUNCHES:
        fail("[sta_joint.yml] no last_gen / last_reg pair, or #2 / #3 launched")
    n_test = len(trainer.loaders["test"])
    ma.LAUNCHES = 0
    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        cli_main(["--config", cfg_path, "--task", "test", "--ckpt", ",".join(pair)])
    test_launches = ma.LAUNCHES
    line = [ln for ln in tee.getvalue().splitlines() if ln.startswith("Testing results:")]
    log(f"[sta_joint.yml] --task test from [last_gen, last_reg] (the command line's main): "
        f"{line[-1] if line else None}; kernel #1 launched {test_launches}x over {n_test} "
        f"test images")
    if not line or test_launches != n_test:
        fail("[sta_joint.yml] --task test from the pair did not launch kernel #1 once per "
             "test image")
    res["joint_launches"] = launches + test_launches
    return res, launches + test_launches


def generator_baselines_phase(ma, mt, tmp, gpu):
    """Phase 11: the generator and the classic baselines. Returns what it
    measured and the kernels' launches over its in-process paths."""
    t0 = time.perf_counter()
    res = {"train": train_generator_and_baselines(mt, gpu)}
    res["fps_b4"], res["bf16_err"] = serve_baselines(ma, gpu)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False  # as the command line's --task test
    try:
        res["files"], launches = generator_file_runs(ma, mt, tmp, gpu)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    out = {"memory_attention_fused": launches,
           "memory_attention_train_fwd": mt.FWD_LAUNCHES,
           "memory_attention_train_bwd": mt.BWD_LAUNCHES}
    log(f"phase 11 (generator and classic baselines): {time.perf_counter() - t0:.1f}s; kernel "
        f"launches {out}")
    return res, out


# ---- phase 12: data parallel --------------------------------------------------
DP_RANKS = 2                        # the ranks the smoke starts
DP_B = 16                           # the global batch (`final`: two-view 320^2 crops), 8 a rank
DP_STEPS = 10                       # `final` steps after step 1
DP_TIMED = 5                        # steps (and gradient all-reduces) timed
DP_SEED = 12
# `final` step 1 against its two halves run in turn in this process, then
# averaged (the JAX per-shard rule without communication): loss parts,
# relative; gradients in relative norm (a bf16 convolution's backward is not
# bit-reproducible across processes); the averaged running statistics,
# relative to the largest
TOL_DP_LOSS, TOL_DP_GRAD, TOL_DP_STATS = 1e-3, 1e-2, 1e-3
# `sw` step 1 against the one-process B=16 step (statistics all-reduced in
# the forward): loss, gradients (relative norm), running mean and covariance
# (relative to the largest). In float32 (TF32 off) the two are the same
# sums in another order; the gradients' bound is the whitening family's
# (a ReLU input within rounding of 0 takes either side; tests/
# test_torch_port_whitening.py). In bf16 the rounding of B=8 and B=16
# convolutions alone moves an untrained `sw`'s gradients by a third: one
# process's bf16 step is 0.38 from its f32 step in relative norm (PERF.md
# §2). Two bf16 steps that round apart are about sqrt(2) times that far from
# each other, so bf16 is held to 1.5 times the one-process step's distance
# from f32 (and at least to the bounds below)
TOL_DP_SW = {torch.float32: (1e-4, 5e-2, 1e-3), torch.bfloat16: (1e-2, 5e-2, 1e-2)}
DP_SW_DTYPES = (torch.float32, torch.bfloat16)
TOL_DP_MAE = 1e-4                   # 2-rank --task test vs one process's, same `last`


def dp_batch(device, b=DP_B):
    """``synthetic_batch`` drawn on the host, so every card gets the same
    global batch."""
    g = torch.Generator().manual_seed(DP_SEED)
    shape = (b, 3, TRAIN_CROP, TRAIN_CROP)
    img1 = torch.randn(shape, generator=g)
    img2 = img1 + 0.25 * torch.randn(shape, generator=g)
    heads = (torch.rand(b, 1, TRAIN_CROP, TRAIN_CROP, generator=g) < 2e-4).float()
    dmap = torch.nn.functional.avg_pool2d(heads, 9, stride=1, padding=4)
    bmap = (torch.nn.functional.avg_pool2d(dmap, 16) > 0).float()
    return {k: v.to(device) for k, v in
            {"img1": img1, "img2": img2, "dmap": dmap, "bmap": bmap}.items()}


def dp_final(device, group=None):
    """Full-width `final` from sta_final.yml, seeded, bf16 compute, f32
    AdamW with the OneCycle lr of epoch 0, on ``device``; its loss_fn and
    (with a group) its data-parallel step."""
    import dgvcc_tpu_torch.losses  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
    from dgvcc_tpu_torch.parallel.mesh import build_parallel_train_step
    from dgvcc_tpu_torch.train.state import create_train_state
    from dgvcc_tpu_torch.train.steps import build_loss_fn

    cfg = load_config(os.path.join(ROOT, "configs", "sta_final.yml"))
    model = MODELS.build("final", dtype=torch.bfloat16, **cfg.model.get("params", {}))
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    state = create_train_state(model, cfg.optimizer, cfg.scheduler, device=device)
    loss = LOSSES.build(cfg.loss["name"], **cfg.loss.get("params", {}))
    step = (build_parallel_train_step(model, loss, cfg.mode, cfg.log_para, group)
            if group is not None else None)
    return state, build_loss_fn(model, loss, cfg.mode, cfg.log_para), step


def dp_sw(device, dtype, group=None):
    """sta_sw.yml's counter at full width, seeded, computing in ``dtype``,
    on ``device``; with a group built with it (statistics all-reduced in the
    forward) and its data-parallel step, else the one-process step."""
    import dgvcc_tpu_torch.losses  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
    from dgvcc_tpu_torch.parallel.mesh import build_parallel_train_step
    from dgvcc_tpu_torch.train.state import create_train_state
    from dgvcc_tpu_torch.train.steps import build_train_step

    cfg = whitening_config("sw")
    params = dict(cfg.model.get("params", {}))
    if group is not None:
        params["process_group"] = group
    model = MODELS.build("sw", dtype=dtype, **params)
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    state = create_train_state(model, cfg.optimizer, cfg.scheduler, device=device)
    loss = LOSSES.build(cfg.loss["name"], **cfg.loss.get("params", {}))
    if group is None:
        return state, build_train_step(model, loss, cfg.mode, cfg.log_para)
    return state, build_parallel_train_step(model, loss, cfg.mode, cfg.log_para, group)


def _grads(model):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).float().cpu()
            for n, p in model.named_parameters()}


def _stats(model):
    return {n: b.float().cpu() for n, b in model.named_buffers()
            if n.rsplit(".", 1)[-1].startswith("running_") and b.is_floating_point()}


def dp_rank(rank, workdir, global_b, with_sw):
    """Phase 12 on one rank: `final` step 1 (its averaged metrics, its
    all-reduced gradients and averaged running statistics), 10 more steps,
    the parameters' checksum, the training kernels' launches, ms/step and
    the gradient all-reduce's ms; then `sw` step 1. Writes
    ``workdir/rank{rank}.pt``."""
    import torch.distributed as dist

    from dgvcc_tpu_torch.ops import mem_attention_train as mt
    from dgvcc_tpu_torch.parallel import mesh

    world = dist.get_world_size()
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    group = mesh.make_mesh(world)
    out = {"device": str(device), "backend": str(dist.get_backend())}
    state, _, step = dp_final(device, group)
    batch = mesh.shard_batch(dp_batch(device, global_b), rank, world)
    gen = torch.Generator(device=device).manual_seed(DP_SEED + rank)

    def run():
        return {k: float(v) for k, v in
                mesh.average_metrics(step(state, batch, gen, 0)[1], group).items()}

    # ---- the main path: counts set to 0 just before
    mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
    out["metrics"] = run()
    if rank == 0:
        out["grads"], out["stats"] = _grads(state.model), _stats(state.model)
    out["losses"] = [out["metrics"]["loss_total"]] + [run()["loss_total"]
                                                      for _ in range(DP_STEPS)]
    out["launches"] = (mt.FWD_LAUNCHES, mt.BWD_LAUNCHES)
    out["checksum"] = float(sum(p.detach().double().sum() for p in state.model.parameters()))

    # ---- ms/step, and the gradient all-reduce alone on the same gradients
    grads = [p.grad for p in state.model.parameters()]
    for label, fn in (("step", run), ("allreduce", lambda: mesh.mean_in_place(grads, group))):
        fn()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED):
            fn()
        torch.cuda.synchronize()
        out[f"{label}_ms"] = 1e3 * (time.perf_counter() - t0) / DP_TIMED
    del state, step, grads
    torch.cuda.empty_cache()
    if with_sw:
        # TF32 off: the f32 step is held to one process's tightly
        torch.backends.cudnn.allow_tf32 = False
        for dtype in DP_SW_DTYPES:
            state, step = dp_sw(device, dtype, group)
            _, metrics = step(state, {k: batch[k] for k in ("img1", "dmap")}, gen, 0)
            out[f"sw_{dtype}"] = {"loss": float(mesh.average_metrics(metrics, group)
                                                ["loss_total"])}
            if rank == 0:
                out[f"sw_{dtype}"].update(grads=_grads(state.model), stats=_stats(state.model))
            del state, step
            torch.cuda.empty_cache()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def rel_norm_all(got, want):
    """||got - want|| / ||want|| over every tensor of two dicts, and the
    worst tensor's own."""
    num = sum(float((got[k] - want[k]).double().norm() ** 2) for k in want)
    den = sum(float(want[k].double().norm() ** 2) for k in want)
    worst = max(want, key=lambda k: float((got[k] - want[k]).norm())
                / max(float(want[k].norm()), 1e-12))
    return math.sqrt(num / max(den, 1e-30)), worst


def dp_reference(rank, workdir):
    """`final` step 1 without communication: each rank's half from the same
    weights and buffers, with that rank's dropout generator, one after the
    other; the halves' loss parts, gradients and running statistics
    averaged. And `sw`'s one-process B=16 step. It runs in a fresh process
    of its own (a group of one rank), as the ranks do: after phases 1-11 this
    process's cuDNN chose other bf16 convolution algorithms, enough to flip
    `final`'s 0.5 thresholds (PERF.md §6). Writes ``workdir/reference.pt``."""
    device = torch.device("cuda", 0)
    state, loss_fn, _ = dp_final(device)
    batch = dp_batch(device)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    halves = []
    for r in range(DP_RANKS):
        state.model.load_state_dict(start)
        state.model.zero_grad(set_to_none=True)
        half = {k: v[r * DP_B // DP_RANKS:(r + 1) * DP_B // DP_RANKS] for k, v in batch.items()}
        gen = torch.Generator(device=device).manual_seed(DP_SEED + r)
        total, metrics = loss_fn(half, gen, 0)
        total.backward()
        halves.append(({k: float(v.detach()) for k, v in metrics.items()}, _grads(state.model),
                       _stats(state.model)))
    ref = {"metrics": {k: sum(h[0][k] for h in halves) / DP_RANKS for k in halves[0][0]},
           "grads": {k: sum(h[1][k] for h in halves) / DP_RANKS for k in halves[0][1]},
           "stats": {k: sum(h[2][k] for h in halves) / DP_RANKS for k in halves[0][2]}}
    del state, loss_fn
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False  # as the ranks' sw steps
    for dtype in DP_SW_DTYPES:
        state, step = dp_sw(device, dtype)
        _, metrics = step(state, {k: batch[k] for k in ("img1", "dmap")}, None, 0)
        ref[f"sw_{dtype}"] = {"loss": float(metrics["loss_total"]),
                              "grads": _grads(state.model), "stats": _stats(state.model)}
        del state, step
        torch.cuda.empty_cache()
    torch.save(ref, os.path.join(workdir, "reference.pt"))


def cli_rank(outdir, argv, exact=False):
    """A torchrun rank of the command line (``python -m dgvcc_tpu_torch``'s
    ``main``; ``exact``: under ``exact_f32``) that writes its kernels'
    launches to ``outdir``."""
    sys.path.insert(0, ROOT)
    from dgvcc_tpu_torch.cli.main import main as cli_main
    from dgvcc_tpu_torch.ops import mem_attention as ma
    from dgvcc_tpu_torch.ops import mem_attention_train as mt

    ma.LAUNCHES = mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
    with exact_f32(exact):
        cli_main(argv)
    with open(os.path.join(outdir, f"rank{os.environ.get('RANK', 0)}.json"), "w") as f:
        json.dump({"memory_attention_fused": ma.LAUNCHES,
                   "memory_attention_train_fwd": mt.FWD_LAUNCHES,
                   "memory_attention_train_bwd": mt.BWD_LAUNCHES}, f)
    return 0


def dp_files_command(tmp, nccl):
    """sta_final.yml with mesh: {data: 2} for 1 epoch on phase 6's files
    through torchrun and the command line: (the command, its config, the
    directory of the ranks' launch counts)."""
    import yaml

    with open(os.path.join(ROOT, "configs", "sta_final.yml")) as f:
        raw = yaml.safe_load(f)
    root = os.path.join(tmp, "data")
    for split in ("train", "val", "test"):
        raw[f"{split}_dataset"] = dict(raw[f"{split}_dataset"], params=dict(
            raw[f"{split}_dataset"]["params"], root=root))
    raw.update(num_epochs=1, log_dir=os.path.join(tmp, "logs12"), mesh={"data": DP_RANKS})
    cfg_path = os.path.join(tmp, "sta_final_dp.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    outdir = os.path.join(tmp, "dp_ranks")
    os.makedirs(outdir)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={DP_RANKS}", os.path.abspath(__file__), "--cli-rank", outdir,
           "--config", cfg_path, "--task", "train_test"]
    if not nccl:
        cmd += ["--dist-backend", "gloo"]
    return cmd, raw, outdir


def dp_files_run(tmp, nccl, run, raw, outdir, t0):
    """Wait for the run of ``dp_files_command``, started at ``t0``, and
    check it. Returns the launches summed over the ranks and what
    ``hold_mesh_tests`` needs for the run's test MAE: a fresh process's
    --task test of the same `last` (phase 13 runs it with its own runs')."""
    import yaml

    stdout, stderr = run.communicate(timeout=900)
    wall = time.perf_counter() - t0
    if run.returncode:
        fail(f"torchrun train_test exited {run.returncode}:\n{stdout[-2000:]}\n"
             f"{stderr[-4000:]}")
    per_rank = []
    for r in range(DP_RANKS):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            per_rank.append(json.load(f))
    log_dir = os.path.join(raw["log_dir"], raw["version"])
    text = open(os.path.join(log_dir, "log.txt")).read()
    n_val, n_test = 4, 4
    steps = 32 // DP_B
    log(f"data parallel from files: torchrun --nproc_per_node={DP_RANKS} -m dgvcc_tpu_torch "
        f"--task train_test{'' if nccl else ' --dist-backend gloo'} (sta_final.yml, "
        f"mesh: {{data: {DP_RANKS}}}, 1 epoch x {steps} steps of B={DP_B}): {wall:.1f} s "
        f"with start-up, beside the one-process reference; launches per rank {per_rank}")
    for line in ("Data parallel over 2 devices", "Start training and testing at"):
        if text.count(line) != 1:
            fail(f"data parallel log.txt has {text.count(line)} {line!r} lines, not 1")
    for line in text.splitlines():
        if line != "Data parallel over 2 devices" and not any(
                p.fullmatch(line) for p in LOG_LINES):
            fail(f"data parallel log.txt line not of the JAX trainer's shapes: {line!r}")
    for r, n in enumerate(per_rank):
        if n["memory_attention_fused"] != n_val + n_test:
            fail(f"rank {r} launched kernel #1 {n['memory_attention_fused']} times for "
                 f"{n_val} val and {n_test} test images")
        if (n["memory_attention_train_fwd"], n["memory_attention_train_bwd"]) != (steps, steps):
            fail(f"rank {r}: {steps} steps launched the training kernels "
                 f"{n['memory_attention_train_fwd']} / {n['memory_attention_train_bwd']} times")
    got = float(re.findall(r"Testing results: mae: (\S+)", text)[-1])
    one = dict(raw, version="one")
    one.pop("mesh")
    one_path = os.path.join(tmp, "sta_final_one.yml")
    with open(one_path, "w") as f:
        yaml.safe_dump(one, f)
    test = [False, ["--config", one_path, "--task", "test", "--ckpt",
                    os.path.join(log_dir, "last.pth")]]
    return ({k: sum(n[k] for n in per_rank) for k in per_rank[0]},
            ("data parallel", DP_RANKS, False, got, test))


def dp_phase(mt, tmp, gpu):
    """Phase 12: data parallel. Returns what it measured, the kernels'
    launches of its ranks and its torchrun run's pending test MAE."""
    from dgvcc_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    nccl = torch.cuda.device_count() >= DP_RANKS
    backend = "nccl" if nccl else "gloo"
    where = (f"NCCL, one card a rank ({DP_RANKS} of {torch.cuda.device_count()} cards)"
             if nccl else f"gloo, {DP_RANKS} ranks on cuda:0 (one card visible)")
    log(f"data parallel: {DP_RANKS} ranks over {where}; a 1-rank NCCL group on card 0")
    # the ranks choose cuDNN's algorithms as the command line does (phase 3
    # turned its benchmark on in this process)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        return _dp_phase(mt, tmp, gpu, t0, nccl, backend)
    finally:
        torch.backends.cudnn.benchmark = benchmark


def _dp_phase(mt, tmp, gpu, t0, nccl, backend):
    from dgvcc_tpu_torch.parallel.launch import run_ranks

    # the command line's torchrun run from files (nothing timed) runs beside
    # the reference process (nothing timed either); the timed steps after
    # them run alone
    cmd, raw, outdir = dp_files_command(tmp, nccl)
    t0 = time.perf_counter()
    run = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        work = tempfile.mkdtemp(prefix="dp_ref_", dir=tmp)
        run_ranks(dp_reference, 1, (work,), init_file=os.path.join(work, "init"),
                  timeout=600, threads=4)
        files, test = dp_files_run(tmp, nccl, run, raw, outdir, t0)
    finally:
        if run.poll() is None:
            run.kill()
            run.wait()
    ref = torch.load(os.path.join(work, "reference.pt"), weights_only=False)
    res, launches = {}, {"memory_attention_train_fwd": 0, "memory_attention_train_bwd": 0}
    runs = (("two ranks", DP_RANKS, backend, DP_B, True), ("one rank", 1, "nccl", DP_B // 2,
                                                           False))
    for label, world, be, global_b, full in runs:
        work = tempfile.mkdtemp(prefix="dp_", dir=tmp)
        run_ranks(dp_rank, world, (work, global_b, full), init_file=os.path.join(work, "init"),
                  backend=be, timeout=600, threads=4)
        outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
        res[label] = outs
        for o in outs:
            launches["memory_attention_train_fwd"] += o["launches"][0]
            launches["memory_attention_train_bwd"] += o["launches"][1]
            if o["launches"] != (DP_STEPS + 1, DP_STEPS + 1):
                fail(f"{label}: {DP_STEPS + 1} steps launched the training kernels "
                     f"{o['launches']} times on {o['device']}")
            losses = o["losses"]
            if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
                fail(f"{label}: the loss is not finite or did not fall: {losses}")
        log(f"data parallel {label} ({outs[0]['backend']}, {[o['device'] for o in outs]}), "
            f"`final` B={global_b}: losses {[round(x, 4) for x in outs[0]['losses']]}; "
            f"parameter checksums {[o['checksum'] for o in outs]}")
        if len({o["checksum"] for o in outs}) != 1:
            fail(f"{label}: the ranks' parameters differ after {DP_STEPS + 1} steps")

    # ---- step 1 of the two ranks against the halves run in turn
    two = res["two ranks"]
    for k, want in ref["metrics"].items():
        got = two[0]["metrics"][k]
        rel = abs(got - want) / max(abs(want), 1e-12)
        log(f"data parallel `final` step 1 {k}: ranks {got:.6g}, halves in turn {want:.6g}, "
            f"rel diff {rel:.3e} (tol {TOL_DP_LOSS})")
        if not rel <= TOL_DP_LOSS and abs(got - want) > 1e-12:
            fail(f"data parallel step 1: {k} disagrees with the halves run in turn")
    rel, worst = rel_norm_all(two[0]["grads"], ref["grads"])
    log(f"data parallel `final` step 1 gradients: rel norm diff {rel:.3e} over every "
        f"parameter (tol {TOL_DP_GRAD}); the worst tensor {worst}")
    if not rel <= TOL_DP_GRAD:
        fail("data parallel step 1: the all-reduced gradients disagree with the halves'")
    err = max(float((two[0]["stats"][k] - v).abs().max()) / max(float(v.abs().max()), 1e-12)
              for k, v in ref["stats"].items())
    log(f"data parallel `final` step 1 averaged BN running statistics: max rel diff {err:.3e} "
        f"over {len(ref['stats'])} buffers (tol {TOL_DP_STATS})")
    if not err <= TOL_DP_STATS:
        fail("data parallel step 1: the averaged running statistics disagree")

    # ---- sw: statistics all-reduced in the forward, against one process's B=16
    def sw_distance(got, want):
        rel_loss = abs(got["loss"] - want["loss"]) / max(abs(want["loss"]), 1e-12)
        rel_g, worst = rel_norm_all(got["grads"], want["grads"])
        err = max(float((got["stats"][k] - v).abs().max()) / max(float(v.abs().max()), 1e-12)
                  for k, v in want["stats"].items())
        return rel_loss, rel_g, err, worst

    bf, f32 = ref[f"sw_{torch.bfloat16}"], ref[f"sw_{torch.float32}"]
    floor = sw_distance(bf, f32)
    log(f"`sw` one process B={DP_B}, bf16 against f32: loss rel {floor[0]:.3e}, gradients rel "
        f"norm {floor[1]:.3e} (the worst tensor {floor[3]}), running statistics max rel "
        f"{floor[2]:.3e}")
    for dtype in DP_SW_DTYPES:
        dist_ = sw_distance(two[0][f"sw_{dtype}"], ref[f"sw_{dtype}"])
        tol = TOL_DP_SW[dtype]
        if dtype == torch.bfloat16:
            tol = (tol[0], max(tol[1], 1.5 * floor[1]), max(tol[2], 1.5 * floor[2]))
        log(f"data parallel `sw` (sta_sw.yml) {dtype} step 1, 2 ranks x {DP_B // DP_RANKS} "
            f"against one process's B={DP_B}: loss rel {dist_[0]:.3e} (tol {tol[0]:.3g}); "
            f"gradients rel norm {dist_[1]:.3e} (tol {tol[1]:.3g}; the worst tensor "
            f"{dist_[3]}); running mean and covariance max rel {dist_[2]:.3e} (tol "
            f"{tol[2]:.3g})")
        if not all(d <= t for d, t in zip(dist_[:3], tol)):
            fail(f"data parallel sw {dtype}: the synced statistics' step disagrees with one "
                 "process's")

    # ---- times
    step_ms, ar_ms = two[0]["step_ms"], two[0]["allreduce_ms"]
    one_ms = res["one rank"][0]["step_ms"]
    kind = ("two cards, NCCL" if nccl else
            "two ranks on one card, gloo: not a scaling figure")
    log(f"data parallel `final` step, {DP_RANKS} ranks x B={DP_B // DP_RANKS} ({kind}): "
        f"{step_ms:.3f} ms/step; the gradient all-reduce alone {ar_ms:.3f} ms = "
        f"{ar_ms / step_ms:.3f} of the step [{gpu}]")
    log(f"data parallel `final` step, 1 rank x B={DP_B // DP_RANKS} (NCCL, card 0): "
        f"{one_ms:.3f} ms/step; its all-reduce (one rank) "
        f"{res['one rank'][0]['allreduce_ms']:.3f} ms [{gpu}]")
    if nccl:
        log(f"data parallel scaling: {DP_B} samples in {step_ms:.3f} ms on 2 cards against "
            f"{DP_B // 2} in {one_ms:.3f} ms on one: {2 * one_ms / step_ms:.3f}x the "
            f"throughput [{gpu}]")

    for k, v in files.items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 12 (data parallel): {time.perf_counter() - t0:.1f}s; kernel launches over "
        f"its ranks {launches}; its test MAE is held in phase 13's fresh process")
    return {"step_ms": step_ms, "allreduce_ms": ar_ms, "one_rank_ms": one_ms,
            "backend": backend}, launches, test


# ---- phase 13: the bank over a 2-D mesh, the crop's height sharded ---------------
SP_RANKS = 8                        # configs/tpu/sta_final_spatial.yml: mesh: {spatial: 8}
SP_F32 = (2, 512)                   # the f32 check: B, crop (64 rows a rank)
SP_STEPS = 3                        # bf16 steps after step 1, at the config's geometry
SP_CLOCKED = 1                      # steps timed again with each halo exchange clocked
SP_SEED = 13
# step 1 on the ranks against one fresh process's step from the same weights,
# batch and dropout generator: loss parts (relative), gradients (relative norm
# over every parameter), BN running statistics (relative to the largest). f32
# with PyTorch's own convolutions and TF32 off (``exact_f32``): the same sums
# in another order, which an untrained `final` turns into 1e-3 to 1e-2 of its
# gradients (ROADMAP.md, Queue 3); the error-mask and gate elements that flip
# are shown. bf16: loss parts held to phase 5's 1e-2; the gradients are shown
# against the issue's 5e-2, not held. An untrained full-width `final`'s bf16
# gradients move by a quarter under any change of summation order: 0.25 with
# the config's thresholds and with thresholds that cannot flip (err_thrs inf,
# cls_thrs 2: no element flipped), with cuDNN and with PyTorch's own
# convolutions on both sides, and against one process's own spatial step at
# N=1 (PERF.md §6, ROADMAP.md Queue 3), so no bf16 reference tells a fault
# from rounding here; f32 holds the mechanism. The bf16 running means are
# shown, not held: the first batch norms' means are near 0 and their bf16
# rounding is of their size.
TOL_SP = {torch.float32: (1e-4, 1e-2, 1e-4), torch.bfloat16: (1e-2, None)}
TP_MESH = (2, 2)                    # sta_final.yml with mesh: {data: 2, model: 2}
TP_B = 16                           # its global batch, 8 a data index
# step 1 of the 2-D mesh (the bank's einsum path over its columns) against the
# 1-D {data: 2} step from the same weights: f32 (TF32 off) against the 1-D
# step's einsum bank, bf16 against its kernels #2 / #3: loss parts, gradients
# with the bank reassembled (relative norm)
TOL_TP = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-2, 5e-2)}
TOL_TP_COUNT = 1e-4                 # sharded eval over 4 ranks vs one TiledCounter (f32)
TP_EVAL_IMAGES = 2                  # phase 6's val images, 768x1024
TP_EVAL_PATCH = 384                 # 2x3 tiles an image, 2 a rank (padded to 8)
SP_FILES_HW = (1152, 1280)          # phase 13's JPEGs: a 1024^2 crop fits
SP_FILES = (4, 1, 1)                # train (1 step of B=4), val, test


@contextlib.contextmanager
def exact_f32(on=True):
    """f32 products in f32 inside: TF32 off, and PyTorch's own convolutions
    (im2col and a cuBLAS GEMM) in place of cuDNN's; the flags as they were
    after. The first f32 step of a process whose card other ranks share
    takes other cuDNN algorithms than its later steps, and an untrained
    `final` turns such rounding changes into 4e-3 to 6e-3 of its gradients'
    norm (ROADMAP.md, Queue 3)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.enabled)
    if on:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.enabled) = flags


def mesh_state(config, device, dtype, group=None, mesh2d=None, **params):
    """A config's `final` at full width, seeded, computing in ``dtype`` with
    f32 AdamW and the OneCycle lr of epoch 0, on ``device``; height sharded
    over ``group`` or its bank over ``mesh2d``'s model group. Returns (cfg,
    state, step): the mesh's step, or the 1-D step over ``group`` with
    ``mesh2d`` None and ``params``, or one process's."""
    import dgvcc_tpu_torch.losses  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
    from dgvcc_tpu_torch.parallel import mesh, spatial, tp
    from dgvcc_tpu_torch.train.state import create_train_state
    from dgvcc_tpu_torch.train.steps import build_train_step

    cfg = load_config(os.path.join(ROOT, "configs", config))
    model = MODELS.build("final", dtype=dtype, **dict(cfg.model.get("params", {}), **params))
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    if mesh2d is not None:
        tp.shard_model_bank(model, mesh2d.model)
    elif group is not None and (cfg.mesh or {}).get("spatial"):
        spatial.shard_height(model, group)
    state = create_train_state(model, cfg.optimizer, cfg.scheduler, device=device)
    loss = LOSSES.build(cfg.loss["name"], **cfg.loss.get("params", {}))
    if mesh2d is not None:
        step = mesh.build_parallel_train_step_2d(model, loss, cfg.mode, cfg.log_para, mesh2d)
    elif group is None:
        step = build_train_step(model, loss, cfg.mode, cfg.log_para)
    elif (cfg.mesh or {}).get("spatial"):
        step = spatial.build_spatial_train_step(model, loss, cfg.mode, cfg.log_para, group)
    else:
        step = mesh.build_parallel_train_step(model, loss, cfg.mode, cfg.log_para, group)
    return cfg, state, step


def mesh_batch(b, crop, device, seed=SP_SEED):
    """``dp_batch``'s synthetic two-view batch at B=b of crop^2, drawn on the
    host (every process draws the same), on ``device``."""
    g = torch.Generator().manual_seed(seed)
    shape = (b, 3, crop, crop)
    img1 = torch.randn(shape, generator=g)
    img2 = img1 + 0.25 * torch.randn(shape, generator=g)
    heads = (torch.rand(b, 1, crop, crop, generator=g) < 2e-4).float()
    dmap = torch.nn.functional.avg_pool2d(heads, 9, stride=1, padding=4)
    bmap = (torch.nn.functional.avg_pool2d(dmap, 16) > 0).float()
    return {k: v.to(device) for k, v in
            {"img1": img1, "img2": img2, "dmap": dmap, "bmap": bmap}.items()}


def capture_gates(model):
    """Hooks that keep each view's den_dec output and classifier map (what
    err_thrs and cls_thrs binarise); returns (kept, remove)."""
    kept = {"den": [], "cls": []}
    # the model runs its Sequentials' layers one by one: hook their last
    hooks = [model.den_dec[-1].register_forward_hook(
                 lambda m, i, o: kept["den"].append(o.detach().float().cpu())),
             model.cls_head[-1].register_forward_hook(
                 lambda m, i, o: kept["cls"].append(o.detach().float().cpu()))]
    return kept, lambda: [h.remove() for h in hooks]


def sp_step1(state, step, batch, device, main):
    """Step 1: (metrics, gradients, running statistics, gates) on this
    process; the gradients and statistics on ``main`` only."""
    from dgvcc_tpu_torch.parallel import mesh

    kept, remove = capture_gates(state.model)
    gen = torch.Generator(device=device).manual_seed(SP_SEED)
    _, metrics = step(state, batch, gen, 0)
    remove()
    if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        metrics = mesh.average_metrics(metrics)
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "gates": kept}
    if main:
        out.update(grads=_grads(state.model), stats=_stats(state.model))
    return out, gen


def sp_rank(rank, workdir):
    """Phase 13's spatial ranks (sta_final_spatial.yml): the f32 step 1 at
    B=2 of 512^2, then the config's geometry in bf16: step 1, SP_STEPS
    more steps, launches, checksum, peak memory, ms/step and the halo
    exchange's share. Writes ``workdir/rank{rank}.pt``."""
    import torch.distributed as dist

    from dgvcc_tpu_torch.nn import collectives
    from dgvcc_tpu_torch.ops import mem_attention_train as mt
    from dgvcc_tpu_torch.parallel import mesh, spatial

    world = dist.get_world_size()
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    group = spatial.make_spatial_mesh(world)
    out = {"device": str(device), "backend": str(dist.get_backend()),
           "transport": collectives.halo_transport(group, device)}
    cfg_name = os.path.join("tpu", "sta_final_spatial.yml")

    def rows(batch):
        return spatial.shard_batch_spatial(batch, rank, world, dim=2)

    with exact_f32():
        _, state, step = mesh_state(cfg_name, device, torch.float32, group)
        out["f32"], _ = sp_step1(state, step, rows(mesh_batch(*SP_F32, device)), device,
                                 rank == 0)
    del state, step
    torch.cuda.empty_cache()

    cfg, state, step = mesh_state(cfg_name, device, torch.bfloat16, group)
    b, crop = cfg.train_loader["batch_size"], cfg.train_dataset["params"]["crop_size"]
    batch = rows(mesh_batch(b, crop, device))
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts set to 0 just before
    mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
    out["bf16"], gen = sp_step1(state, step, batch, device, rank == 0)

    def run():
        _, metrics = step(state, batch, gen, 0)
        return float(mesh.average_metrics(metrics, group)["loss_total"])

    def timed(steps):
        """The steps' losses and ms/step (each step ends in a readback)."""
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [run() for _ in range(steps)]
        return losses, 1e3 * (time.perf_counter() - t0) / steps

    losses, out["step_ms"] = timed(SP_STEPS)
    out["losses"] = [out["bf16"]["metrics"]["loss_total"]] + losses
    out["launches"] = (mt.FWD_LAUNCHES, mt.BWD_LAUNCHES)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["checksum"] = float(sum(p.detach().double().sum() for p in state.model.parameters()))

    # ---- the same steps with each halo exchange clocked
    swap, clock = collectives._swap, [0.0, 0]

    def clocked(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = swap(*args)
        torch.cuda.synchronize()
        clock[0] += time.perf_counter() - t0
        clock[1] += 1
        return got

    collectives._swap = clocked
    try:
        out["clocked_step_ms"] = timed(SP_CLOCKED)[1]
    finally:
        collectives._swap = swap
    out["halo_ms"] = 1e3 * clock[0] / SP_CLOCKED
    out["halo_calls"] = clock[1] // SP_CLOCKED
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def sp_reference(rank, workdir):
    """The spatial ranks' step 1 in one fresh process, from the same weights,
    batch and dropout generator: f32 at B=2 of 512^2 and bf16 at the
    config's geometry; the bf16 step's peak memory. Writes
    ``workdir/reference.pt``."""
    from dgvcc_tpu_torch.core.config import load_config

    device = torch.device("cuda", 0)
    cfg = load_config(os.path.join(ROOT, "configs", "tpu", "sta_final_spatial.yml"))
    b, crop = cfg.train_loader["batch_size"], cfg.train_dataset["params"]["crop_size"]
    out = {}
    for key, dtype, (bb, cc) in (("f32", torch.float32, SP_F32),
                                 ("bf16", torch.bfloat16, (b, crop))):
        with exact_f32(dtype == torch.float32):
            _, state, step = mesh_state(os.path.join("tpu", "sta_final_spatial.yml"), device,
                                        dtype)
            torch.cuda.reset_peak_memory_stats()
            out[key], _ = sp_step1(state, step, mesh_batch(bb, cc, device), device, True)
            out[f"{key}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del state, step
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(workdir, "reference.pt"))


def gate_flips(got, want, cfg_params):
    """Elements of the two-view error mask (err_thrs on the instance-normed
    den_dec outputs) and of the binarised classifier maps (cls_thrs) that
    differ between the ranks' (rows concatenated) and one process's step."""
    from dgvcc_tpu_torch.nn.layers import instance_norm

    def masks(den, cls):
        y1, y2 = (instance_norm(d) for d in den)
        return ((y1 - y2).abs() < cfg_params["err_thrs"],
                [c >= cfg_params["cls_thrs"] for c in cls])

    e_got, c_got = masks(got["den"], got["cls"])
    e_want, c_want = masks(want["den"], want["cls"])
    return (int((e_got != e_want).sum()), e_want.numel(),
            sum(int((a != b).sum()) for a, b in zip(c_got, c_want)),
            sum(c.numel() for c in c_want))


def hold_step1(label, got, want, tol, flips=None):
    """Loss parts, gradients and (where kept) running statistics of step 1
    against the reference; logs each and fails past ``tol`` (gradients
    shown, not held, where ``tol[1]`` is None)."""
    for k, v in want["metrics"].items():
        g = got["metrics"][k]
        rel = abs(g - v) / max(abs(v), 1e-12)
        log(f"{label} step 1 {k}: {g:.6g} vs {v:.6g}, rel diff {rel:.3e} (tol {tol[0]})")
        if not rel <= tol[0] and abs(g - v) > 1e-12:
            fail(f"{label} step 1: {k} disagrees{flips or ''}")
    rel, worst = rel_norm_all(got["grads"], want["grads"])
    if tol[1] is None:
        log(f"{label} step 1 gradients: rel norm diff {rel:.3e} over every parameter; the "
            f"worst tensor {worst}. The issue's 5e-2: {'met' if rel <= 5e-2 else 'MISSED'}, "
            "not held (no reference separates bf16 gradients at this geometry: ROADMAP.md "
            "Queue 3)")
    else:
        log(f"{label} step 1 gradients: rel norm diff {rel:.3e} over every parameter (tol "
            f"{tol[1]:.3g}); the worst tensor {worst}")
        if not rel <= tol[1]:
            fail(f"{label} step 1: the gradients disagree{flips or ''}")
    if "stats" in want:
        err, worst = max((float((got["stats"][k] - v).abs().max())
                          / max(float(v.abs().max()), 1e-12), k)
                         for k, v in want["stats"].items())
        log(f"{label} step 1 BN running statistics: max rel diff {err:.3e} (tol "
            f"{tol[2] if len(tol) > 2 else 'none'}); the worst {worst}")
        if len(tol) > 2 and not err <= tol[2]:
            fail(f"{label} step 1: the running statistics disagree{flips or ''}")


def tp_rank(rank, workdir, image_paths):
    """Phase 13's 2-D mesh ranks (sta_final.yml, data 2 x model 2): step 1
    of the 2-D step against the 1-D {data: 2} step over the data group, f32
    (einsum bank) and bf16 (kernels #2 / #3 in the 1-D step); then the
    model's evaluation of ``image_paths`` over the 4 ranks (the bank
    gathered, kernel #1, tiles of TP_EVAL_PATCH shared out) against one
    TiledCounter on rank 0, in f32 (``exact_f32``). Writes
    ``workdir/rank{rank}.pt``."""
    from PIL import Image

    from dgvcc_tpu_torch.data import transforms as T
    import torch.distributed as dist

    from dgvcc_tpu_torch.ops import mem_attention as ma
    from dgvcc_tpu_torch.ops.tiling import TiledCounter
    from dgvcc_tpu_torch.parallel import mesh, tp
    from dgvcc_tpu_torch.parallel.eval import ShardedTiledCounter

    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    m2 = mesh.make_mesh_2d(*TP_MESH)
    out = {"device": str(device), "backend": str(dist.get_backend())}
    batch = mesh.shard_batch(mesh_batch(TP_B, TRAIN_CROP, device), m2.data_index, TP_MESH[0])
    for dtype in (torch.float32, torch.bfloat16):
        res = {}
        for label, kw in (("2d", {"mesh2d": m2}),
                          ("1d", {"group": m2.data,
                                  "fused_mem_train": dtype == torch.bfloat16})):
            with exact_f32(dtype == torch.float32):
                cfg, state, step = mesh_state("sta_final.yml", device, dtype, **kw)
                gen = torch.Generator(device=device).manual_seed(SP_SEED + m2.data_index)
                _, metrics = step(state, batch, gen, 0)
            grads = _grads(state.model)
            if label == "2d":
                grads["mem"] = tp.gather_bank(state.model.mem.grad, m2.model).float().cpu()
            res[label] = {"metrics": {k: float(v) for k, v in
                                      mesh.average_metrics(metrics, m2.data).items()},
                          "grads": grads}
            del state, step
            torch.cuda.empty_cache()
        out[str(dtype)] = res

    images = [T.to_tensor_normalize(Image.open(p).convert("RGB")) for p in image_paths]
    with exact_f32():
        _, state, _ = mesh_state("sta_final.yml", device, torch.float32, mesh2d=m2)
        model = state.model
        sharded = ShardedTiledCounter(model, cfg.log_para, TP_EVAL_PATCH, dist.group.WORLD,
                                      device=device)
        with tp.full_bank(model, m2.model):
            # ---- the main path: counts set to 0 just before
            ma.LAUNCHES = 0
            out["counts"] = [sharded.count(img) for img in images]
            out["launches"] = ma.LAUNCHES
            if rank == 0:
                one = TiledCounter(model, cfg.log_para, TP_EVAL_PATCH, device=device)
                out["one_counts"] = [one.count(img) for img in images]
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def mesh_files_run(tmp, label, config, world, nccl, edit, n_steps, n_train, n_eval, line,
                   exact=False):
    """``config`` pointed at the files under ``tmp/data`` for 1 epoch,
    changed by ``edit``, through torchrun and the command line on ``world``
    ranks: ``n_steps`` steps that launch #2 / #3 ``n_train`` times on each
    rank, #1 ``n_eval`` times; log.txt holds ``line`` once; ``exact``: the
    ranks under ``exact_f32``. Returns the launches summed over the ranks
    and what ``hold_mesh_tests`` needs for the run's test MAE."""
    raw, cfg_path = phase_config(tmp, config, 1, edit)
    slug = re.sub(r"\W+", "_", label)
    outdir = os.path.join(tmp, f"ranks_{slug}")
    os.makedirs(outdir)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={world}", os.path.abspath(__file__), "--cli-rank", outdir,
           *(["--exact-f32"] if exact else []), "--config", cfg_path, "--task", "train_test"]
    if not nccl:
        cmd += ["--dist-backend", "gloo"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    wall = time.perf_counter() - t0
    if out.returncode:
        fail(f"{label}: torchrun train_test exited {out.returncode}:\n{out.stdout[-2000:]}\n"
             f"{out.stderr[-4000:]}")
    per_rank = []
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            per_rank.append(json.load(f))
    log_dir = os.path.join(raw["log_dir"], raw["version"])
    text = open(os.path.join(log_dir, "log.txt")).read()
    log(f"{label} from files: torchrun --nproc_per_node={world} -m dgvcc_tpu_torch --task "
        f"train_test{'' if nccl else ' --dist-backend gloo'} ({config}, 1 epoch x {n_steps} "
        f"steps): {wall:.1f} s with start-up; launches per rank {per_rank}")
    for want in (line, "Start training and testing at"):
        if text.count(want) != 1:
            fail(f"{label}: log.txt has {text.count(want)} {want!r} lines, not 1")
    losses = [float(x) for x in re.findall(r"Training loss: (\S+)", text)]
    if not losses or not all(map(math.isfinite, losses)):
        fail(f"{label}: training losses {losses}")
    for r, n in enumerate(per_rank):
        train = (n["memory_attention_train_fwd"], n["memory_attention_train_bwd"])
        if n["memory_attention_fused"] != n_eval or train != (n_train, n_train):
            fail(f"{label} rank {r}: launches {n}; {n_eval} of #1 (one per validation and "
                 f"test image) and {n_train} of #2 / #3 were due")
    got = float(re.findall(r"Testing results: mae: (\S+)", text)[-1])
    one = dict(raw, version="one")
    one.pop("mesh")
    one_path = os.path.join(tmp, f"{slug}_one.yml")
    with open(one_path, "w") as f:
        import yaml

        yaml.safe_dump(one, f)
    launches = {k: sum(n[k] for n in per_rank) for k in per_rank[0]}
    test = [exact, ["--config", one_path, "--task", "test", "--ckpt",
                    os.path.join(log_dir, "last.pth")]]
    return launches, (label, world, exact, got, test)


def hold_mesh_tests(tmp, pending):
    """Each torchrun run's test MAE (phase 12's and 13's) against one
    process's --task test of the same `last`: the tests of all runs in turn
    in one fresh process, as the jobs' ranks are fresh (``exact``: under
    ``exact_f32``). A convolution keeps the cuDNN algorithm its shape first
    ran with, whatever the benchmark flag says later, so a reference run in
    this process, which timed these shapes with the benchmark on in phases 3
    and 6, compares unequal work: 1.6e-5 of phase 12's MAE apart, where a
    fresh process equals the ranks per image (scripts/probe_dp_test.py).
    bf16 counts of two processes differed by up to 1.1e-4 (the 2-D mesh's,
    twice in four runs), so the 2-D run compares under exact_f32 (no cuDNN,
    TF32 off)."""
    jobs = os.path.join(tmp, "mesh_tests.json")
    with open(jobs, "w") as f:
        json.dump([test for *_, test in pending], f)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, os.path.abspath(__file__), "--cli-tests", jobs],
                         capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    if run.returncode:
        fail(f"mesh runs' --task test: the command line exited {run.returncode}:\n"
             f"{run.stderr[-3000:]}")
    outs = run.stdout.split(CLI_TESTS_MARK)[1:]
    log(f"one fresh process's --task test of {len(pending)} torchrun runs' last.pth: "
        f"{time.perf_counter() - t0:.1f}s with start-up")
    for (label, world, exact, got, _), out in zip(pending, outs):
        want = float(re.findall(r"Testing results: mae: (\S+)", out)[-1])
        log(f"{label} test MAE {got:.4f} ({world} ranks{', exact_f32' if exact else ''}), "
            f"one process's --task test of the same last.pth {want:.4f} (tol {TOL_DP_MAE} + "
            "the printed 4 decimals)")
        if abs(got - want) > TOL_DP_MAE * max(abs(want), 1.0) + 1e-4:
            fail(f"{label}: the {world}-rank test MAE disagrees with one process's")


CLI_TESTS_MARK = "=== chip_smoke cli test\n"


def cli_tests(path):
    """Phase 13's reference: the command line's ``main`` on each job of the
    JSON file ``path`` ([exact, argv] pairs) in turn, in this one process;
    a marker line before each job's output."""
    sys.path.insert(0, ROOT)
    from dgvcc_tpu_torch.cli.main import main as cli_main

    with open(path) as f:
        jobs = json.load(f)
    for exact, argv in jobs:
        print(CLI_TESTS_MARK, end="", flush=True)
        with exact_f32(exact):
            cli_main(argv)
    return 0


def mesh_phase(tmp, gpu, pending=()):
    """Phase 13: the crop's height sharded over 8 ranks and the bank over a
    (data 2, model 2) mesh; ``pending``: earlier torchrun runs' test MAEs,
    held with its own. Returns what it measured and the kernels' launches of
    its ranks."""
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False  # the ranks choose as the command line does
    try:
        return _mesh_phase(tmp, gpu, list(pending))
    finally:
        torch.backends.cudnn.benchmark = benchmark


def _mesh_phase(tmp, gpu, pending):
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.data import dmap_cli
    from dgvcc_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    launches = {"memory_attention_fused": 0, "memory_attention_train_fwd": 0,
                "memory_attention_train_bwd": 0}
    sp_cfg = load_config(os.path.join(ROOT, "configs", "tpu", "sta_final_spatial.yml"))
    b, crop = sp_cfg.train_loader["batch_size"], sp_cfg.train_dataset["params"]["crop_size"]

    # ---- spatial: one fresh process's step 1, then the 8 ranks
    nccl = cards >= SP_RANKS
    log(f"spatial: {SP_RANKS} ranks over "
        f"{'NCCL, one card a rank' if nccl else 'gloo on cuda:0 (one card visible)'}")
    # the 2-D mesh's ranks (nothing timed) run beside the spatial reference
    # process (nothing timed either); the spatial ranks, timed, run alone
    tp_world = TP_MESH[0] * TP_MESH[1]
    tp_nccl = cards >= tp_world
    tp_work = tempfile.mkdtemp(prefix="tp_", dir=tmp)
    val = sorted(glob.glob(os.path.join(tmp, "data", "val", "*.jpg")))[:TP_EVAL_IMAGES]
    work = tempfile.mkdtemp(prefix="sp_ref_", dir=tmp)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        tp_run = pool.submit(run_ranks, tp_rank, tp_world, (tp_work, val),
                             init_file=os.path.join(tp_work, "init"),
                             backend="nccl" if tp_nccl else "gloo", timeout=600, threads=2)
        run_ranks(sp_reference, 1, (work,), init_file=os.path.join(work, "init"), timeout=600,
                  threads=4)
        tp_run.result()
    ref = torch.load(os.path.join(work, "reference.pt"), weights_only=False)
    log(f"spatial: one process's steps and the 2-D mesh's ranks {time.perf_counter() - t0:.1f}s "
        "into phase 13")
    work = tempfile.mkdtemp(prefix="sp_", dir=tmp)
    run_ranks(sp_rank, SP_RANKS, (work,), init_file=os.path.join(work, "init"),
              backend="nccl" if nccl else "gloo", timeout=900)
    outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(SP_RANKS)]
    log(f"spatial ranks: {outs[0]['backend']} on {sorted({o['device'] for o in outs})}; halo "
        f"rows by {outs[0]['transport']}; {time.perf_counter() - t0:.1f}s into phase 13")
    params = sp_cfg.model["params"]
    runs = ((torch.float32, "f32", SP_F32), (torch.bfloat16, "bf16", (b, crop)))
    for dtype, key, (bb, cc) in runs:
        got = dict(outs[0][key], gates={k: [torch.cat([o[key]["gates"][k][v] for o in outs],
                                                      dim=2) for v in range(2)]
                                        for k in ("den", "cls")})
        flips = gate_flips(got["gates"], ref[key]["gates"], params)
        note = (f"; err_thrs {params['err_thrs']:g} flipped {flips[0]} of {flips[1]} mask "
                f"elements, cls_thrs {params['cls_thrs']:g} {flips[2]} of {flips[3]}")
        log(f"spatial {key} {dtype} B={bb} two-view {cc}^2 ({cc // SP_RANKS} rows a rank), "
            f"step 1 against one process{note}")
        hold_step1(f"spatial {key}", got, ref[key], TOL_SP[dtype], note)
    for o in outs:
        if o["launches"] != (SP_STEPS + 1, SP_STEPS + 1):
            fail(f"spatial: {SP_STEPS + 1} steps launched #2 / #3 {o['launches']} times on a rank")
        if not all(map(math.isfinite, o["losses"])) or not o["losses"][-1] < o["losses"][0]:
            fail(f"spatial: the loss is not finite or did not fall: {o['losses']}")
        launches["memory_attention_train_fwd"] += o["launches"][0]
        launches["memory_attention_train_bwd"] += o["launches"][1]
    checksums = {o["checksum"] for o in outs}
    log(f"spatial bf16 B={b} {crop}^2: losses {[round(x, 4) for x in outs[0]['losses']]}; "
        f"parameter checksums {sorted(checksums)}")
    if len(checksums) != 1:
        fail(f"spatial: the ranks' parameters differ after {SP_STEPS + 1} steps")
    o = outs[0]
    kind = "8 ranks on one card: not a scaling figure" if not nccl else "8 cards, NCCL"
    log(f"spatial `final` step, {SP_RANKS} ranks x B={b} of {crop // SP_RANKS}x{crop} rows "
        f"({kind}): {o['step_ms']:.3f} ms/step; with each halo exchange clocked "
        f"{o['clocked_step_ms']:.3f} ms/step, of which the {o['halo_calls']} exchanges "
        f"{o['halo_ms']:.3f} ms = {o['halo_ms'] / o['clocked_step_ms']:.3f} [{gpu}]")
    log(f"spatial peak memory per rank {max(x['peak_gib'] for x in outs):.3f} GiB (max over "
        f"ranks) against one process's {ref['bf16_peak_gib']:.3f} GiB at B={b} two-view "
        f"{crop}^2 bf16 [{gpu}]")
    res = {"step_ms": o["step_ms"], "halo_ms": o["halo_ms"],
           "clocked_step_ms": o["clocked_step_ms"],
           "peak_gib": max(x["peak_gib"] for x in outs), "one_peak_gib": ref["bf16_peak_gib"]}

    # ---- the 2-D mesh (its ranks ran beside the spatial reference)
    outs = [torch.load(os.path.join(tp_work, f"rank{r}.pt"), weights_only=False)
            for r in range(tp_world)]
    log(f"2-D mesh data={TP_MESH[0]} x model={TP_MESH[1]}: {outs[0]['backend']} on "
        f"{sorted({o['device'] for o in outs})}")
    for dtype in (torch.float32, torch.bfloat16):
        r = outs[0][str(dtype)]
        against = "its einsum bank" if dtype == torch.float32 else "kernels #2 / #3"
        hold_step1(f"2-D mesh {dtype} B={TP_B} against the 1-D {{data: 2}} step on {against}",
                   r["2d"], r["1d"], TOL_TP[dtype])
    for rank, o in enumerate(outs):
        if o["launches"] != TP_EVAL_IMAGES:
            fail(f"2-D mesh eval: rank {rank} launched #1 {o['launches']} times for "
                 f"{TP_EVAL_IMAGES} images")
        if o["counts"] != outs[0]["counts"]:
            fail(f"2-D mesh eval: rank {rank} counted {o['counts']}, rank 0 {outs[0]['counts']}")
        launches["memory_attention_fused"] += o["launches"]
    want = outs[0]["one_counts"]
    err = max(abs(g - w) / max(abs(w), 1.0) for g, w in zip(outs[0]["counts"], want))
    log(f"2-D mesh eval over {tp_world} ranks (f32, {TP_EVAL_PATCH}-px tiles, the bank "
        f"gathered): counts {outs[0]['counts']} on every rank, one TiledCounter {want}: max rel "
        f"diff {err:.3e} (tol {TOL_TP_COUNT}); #1 once a rank an image")
    if not err <= TOL_TP_COUNT or not all(abs(w) > 1e-3 for w in want):
        fail("2-D mesh eval: the sharded counts disagree with one TiledCounter's (or are 0)")

    # ---- from files, through torchrun and the command line
    files = os.path.join(tmp, "sp_files")
    write_dataset(os.path.join(files, "data"), seed=13, hw=SP_FILES_HW, counts=SP_FILES)
    dmap_cli.generate(dmap_cli.list_images(os.path.join(files, "data"),
                                           ["train", "val", "test"]), overwrite=True)
    n_eval = SP_FILES[1] + SP_FILES[2]
    steps = SP_FILES[0] // b
    runs = (
        (files, "spatial", os.path.join("tpu", "sta_final_spatial"), SP_RANKS, nccl,
         None, steps, steps, n_eval,
         f"Spatial parallel over {SP_RANKS} devices (crop height sharded, halo exchange by "
         "send/recv over torch.distributed)", False),
        # phase 6's files; the bank's products are einsums under the 2-D mesh;
        # f32 under exact_f32 (see mesh_files_run)
        (tmp, "2-D mesh", "sta_final", tp_world, tp_nccl,
         lambda raw: raw.update(mesh={"data": TP_MESH[0], "model": TP_MESH[1]},
                                compute_dtype="float32"),
         32 // TRAIN_B, 0, 8,
         f"2-D mesh: data={TP_MESH[0]} x model={TP_MESH[1]} (memory bank sharded)", True))
    for where, label, config, world, use_nccl, edit, n_steps, n_train, n_ev, line, exact \
            in runs:
        got, test = mesh_files_run(where, label, config, world, use_nccl, edit, n_steps,
                                   n_train, n_ev, line, exact)
        for k, v in got.items():
            launches[k] += v
        pending.append(test)
    hold_mesh_tests(tmp, pending)
    log(f"phase 13 (2-D mesh and spatial): {time.perf_counter() - t0:.1f}s; kernel launches "
        f"over its ranks {launches}")
    return res, launches


# ---- phase 14: int8 serving ----------------------------------------------------
# the int8 convolution (ops/qconv.py, csrc/qconv.cu) against its plain
# version (float64 convolution, the epilogue as separate float32 ops): the
# int32 accumulator and the bf16 output bit for bit, at every int8 site of
# `final` at 768x1024 B=1 (its real inputs) and at edge shapes
PEAK_INT8_OPS = 1979e12             # H100 SXM dense int8 tensor-core peak
# (N, H, W, Cin, Cout, k, dilation, stride): Cin 3 and 67 (padded to 16 and
# 80), 16 and 32 (32-byte K steps), 192 (three 64-byte chunks); Cout 1, 8,
# 67, 130, 300 (ragged channel tiles); W 100, 130 and H 45, 37 that the pixel
# tiles do not divide; a 1x1 image; 1x1 windows; dilation 2; N = 3; then
# strided: k x k windows at stride k = 2, 4, 8 on H and W the stride does
# not divide (SAME pads low and high), Cin 16 and 67, Cout 8 and 300, and a
# 3x3 window at stride 2
QCONV_EDGES = ((1, 37, 53, 3, 64, 3, 1, 1), (2, 17, 9, 16, 1, 3, 1, 1),
               (1, 31, 29, 67, 67, 3, 1, 1), (2, 33, 35, 64, 67, 1, 1, 1),
               (1, 45, 39, 128, 96, 3, 2, 1), (1, 5, 7, 512, 512, 3, 1, 1),
               (3, 1, 1, 64, 8, 3, 2, 1), (2, 45, 100, 64, 64, 3, 1, 1),
               (1, 19, 70, 32, 64, 3, 1, 1), (1, 24, 40, 256, 300, 3, 1, 1),
               (1, 13, 21, 192, 128, 3, 1, 1), (3, 50, 130, 128, 130, 3, 2, 1),
               (3, 13, 11, 16, 8, 2, 1, 2), (1, 37, 29, 67, 300, 4, 1, 4),
               (3, 21, 45, 16, 300, 8, 1, 8), (2, 9, 70, 67, 8, 2, 1, 2),
               (1, 100, 67, 67, 8, 8, 1, 8), (2, 15, 17, 16, 8, 3, 1, 2))
QCONV_BODIES = 13                   # 9 per-tap and 4 halo kernels in csrc/qconv.cu
# one site each of sasnet, dssinet and CCTrans held bit for bit too: the
# first int8 call of a B=1 forward whose weights match (kh, kw, Cin), shapes
# final has not (CCTrans's: pe1, a 2x2 window at stride 2)
QCONV_FAMILY_SITES = {"sasnet": (5, 5, None), "dssinet": (1, 1, 768), "cctrans": (2, 2, 128)}
# (H, W, Cin, Cout, k) of final's 21 int8 sites at 768x1024, in call order:
# the 13 encoder convolutions, 6 decoder ones, den_dec (1x1), cls_conv1;
# phase 14 holds a forward's recorded sites to it (Cin 3 arrives padded to 16)
FINAL_INT8_SITES = ((768, 1024, 3, 64, 3), (768, 1024, 64, 64, 3), (384, 512, 64, 128, 3),
                    (384, 512, 128, 128, 3), (192, 256, 128, 256, 3), (192, 256, 256, 256, 3),
                    (192, 256, 256, 256, 3), (96, 128, 256, 512, 3), (96, 128, 512, 512, 3),
                    (96, 128, 512, 512, 3), (48, 64, 512, 512, 3), (48, 64, 512, 512, 3),
                    (48, 64, 512, 512, 3), (48, 64, 512, 1024, 3), (48, 64, 1024, 512, 3),
                    (96, 128, 1024, 512, 3), (96, 128, 512, 256, 3), (192, 256, 512, 256, 3),
                    (192, 256, 256, 128, 3), (192, 256, 896, 256, 1), (48, 64, 512, 256, 3))
INT8_SITES_FINAL = len(FINAL_INT8_SITES)
# (H, W, Cin, Cout, k, sites) of CCTrans's strided int8 sites at 768x1024
# under min_ch=128 (alt_gvt_large: b0_1_sr 8x8, pe1, b1_1_sr 4x4, pe2, pe3,
# and the nine b2_*_sr 2x2), each a k x k window at stride k; phase 14 holds
# a B=8 forward's strided sites to it
CCTRANS_STRIDED_SITES = ((192, 256, 128, 128, 8, 1), (192, 256, 128, 256, 2, 1),
                         (96, 128, 256, 256, 4, 1), (96, 128, 256, 512, 2, 1),
                         (48, 64, 512, 1024, 2, 1), (48, 64, 512, 512, 2, 9))
QCONV_CALLS = 20                    # calls a site's device-time median is over
L2_FLUSH_BYTES = 256 << 20          # read before each timed call: five times the 50 MB L2
INT8_CALIB = 8                      # seeded calibration frames (768x1024; cropped to 768^2)
INT8_BATCHES = (1, 4, 16)
INT8_BASELINES = ("csrnet", "bl", "sasnet", "dssinet", "cctrans")
# int8 (and weight-only) counts against the same weights' bf16 path, as a
# share of the bf16 map's mass: max(2e-2, 1.5 x the JAX package's own drift)
# on the same seeded weights (scripts/int8_drift.py FAMILY --port-seed SEED
# --hw 384 512 --frames 4 --calib 8 on the CPU, the batch this phase holds
# the families at and the largest size a CPU run affords; the largest
# frame's value): final (seed 0) and the baselines (seed 11, the weights of
# phase 11); cctrans at 384x512 as well, its B=8 served here
INT8_DRIFT = {"final": 0.010149, "final weight_only": 0.003599, "csrnet": 0.006611,
              "bl": 0.036439, "sasnet": 0.026715, "dssinet": 0.009178, "cctrans": 0.000844}


# CCTrans's untrained counts are all but zero, so its int8 map is also held
# where it is not: the head's last site before its ReLU (reg_res2), |a - b| /
# |b| per frame (L2) against the bf16 model's, at 1.5 x the JAX package's own
# drift (scripts/int8_drift.py cctrans --port-seed 11 --hw 384 512 --frames 4
# --calib 8 on the CPU: the largest frame's value)
CCTRANS_HEAD_DRIFT = 0.038957  # control, against the next frame's map: 0.265-0.308


def int8_gate(name):
    return max(2e-2, 1.5 * INT8_DRIFT[name])


def rel_l2(a, b):
    """|a - b| / |b| over each frame (L2); numpy arrays."""
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    return np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)


def without_last_relu(forward_fn, last):
    """An int8 graph's forward (nn/quant.py's, or the JAX package's) whose
    site ``last`` skips its ReLU."""
    def fwd(qconv, x, *extras):
        def qc(t, name, **kw):
            return qconv(t, name, **(dict(kw, relu=False) if name == last else kw))
        return forward_fn(qc, x, *extras)
    return fwd


def qconv_bound_ms(n, h, w, cin, cout, k, out_bytes=2, stride=1):
    """The least time of one int8 convolution on the card: 2 N Ho Wo Cout
    k^2 Cin operations at the dense int8 peak, or the bytes (xq and w8 read
    once, the output written once, ws and bias) at the HBM rate, whichever is
    longer, at the site's own Cin (not the padded one); (Ho, Wo) = ceil((H,
    W) / stride). Returns (ms, "bytes" or "operations", operations)."""
    ho, wo = -(-h // stride), -(-w // stride)
    ops = 2.0 * n * ho * wo * cout * k * k * cin
    nbytes = n * h * w * cin + cout * k * k * cin + n * ho * wo * cout * out_bytes + 8 * cout
    b_ops, b_bytes = 1e3 * ops / PEAK_INT8_OPS, 1e3 * nbytes / PEAK_HBM_BYTES
    return max(b_ops, b_bytes), ("operations" if b_ops >= b_bytes else "bytes"), ops


def qconv_site(n, h, w, cin, cout, k, seed, dilation=1, relu=True, out_dtype=torch.bfloat16,
               stride=1):
    """Seeded int8 inputs of one qconv_int8 call on the card, as its
    keyword arguments."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return dict(xq=torch.randint(-127, 128, (n, h, w, cin), generator=g, device="cuda",
                                 dtype=torch.int8),
                w8=torch.randint(-127, 128, (cout, k, k, cin), generator=g, device="cuda",
                                 dtype=torch.int8),
                ws=torch.rand(cout, generator=g, device="cuda") * 1e-3, s=0.0123,
                bias=torch.randn(cout, generator=g, device="cuda"), relu=relu,
                dilation=dilation, out_dtype=out_dtype, stride=stride)


def final_site(i, b):
    """final's int8 site ``i`` (FINAL_INT8_SITES) at batch ``b`` on seeded
    random inputs: the inputs phase 14's kernel time and
    scripts/sweep_qconv.py time."""
    h, w, cin, cout, k = FINAL_INT8_SITES[i]
    return qconv_site(b, h, w, cin, cout, k, 1600 + i)


def check_final_sites(calls):
    """Fail unless a forward's recorded int8 site calls have the shapes of
    FINAL_INT8_SITES (Cin padded to a multiple of 16)."""
    got = [(c["xq"].shape[1], c["xq"].shape[2], c["xq"].shape[3], c["w8"].shape[0],
            c["w8"].shape[1], c["w8"].shape[2]) for c in calls]
    want = [(h, w, -(-cin // 16) * 16, cout, k, k) for h, w, cin, cout, k in FINAL_INT8_SITES]
    if got != want:
        fail(f"int8 final's site calls have the shapes {got}, not FINAL_INT8_SITES's {want}")


def device_ms_cold(fn, calls=QCONV_CALLS):
    """Median device time of one call of ``fn`` with a cold L2, in ms.
    Before each call a 256 MB buffer is read (a sum), which evicts what the
    call before it left in L2 and writes its dirty lines back outside the
    timed span; a CUDA event pair brackets the call alone. The calls are
    queued behind a spin kernel that must still be running when the last
    one is queued (else they are taken again behind a spin twice as long),
    so that the events time the card and not the host's launches."""
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    cycles = 400_000 * calls
    for _ in range(4):
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(calls)]
        torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        spun.record()
        for start, end in pairs:
            flush.sum()
            start.record()
            fn()
            end.record()
        ahead = not spun.query()
        torch.cuda.synchronize()
        if ahead:
            return float(np.median([start.elapsed_time(end) for start, end in pairs]))
        cycles *= 2
    raise RuntimeError(f"the host queued {calls} calls more slowly than a spin of {cycles // 2} "
                       "cycles ran")


@contextlib.contextmanager
def recording_sites():
    """Every int8 site call of the int8 graphs inside: [(name-free) kwargs of
    qconv_int8], in call order."""
    from dgvcc_tpu_torch.nn import quant as pq

    calls, real = [], pq.qconv_int8

    def rec(xq, w8, ws, s, bias, relu=True, dilation=1, out_dtype=torch.bfloat16, acc=False,
            stride=1):
        calls.append(dict(xq=xq, w8=w8, ws=ws, s=s, bias=bias, relu=relu, dilation=dilation,
                          out_dtype=out_dtype, stride=stride))
        return real(xq, w8, ws, s, bias, relu=relu, dilation=dilation, out_dtype=out_dtype,
                    acc=acc, stride=stride)

    pq.qconv_int8 = rec
    try:
        yield calls
    finally:
        pq.qconv_int8 = real


def check_qconv(qc, site):
    """The kernel against its plain version on one site's inputs: the int32
    accumulator and the output bit for bit. Returns the largest |difference|
    of the outputs (0 when they agree)."""
    acc = qc.qconv_int8(site["xq"], site["w8"], None, site["s"], None,
                        dilation=site["dilation"], acc=True, stride=site["stride"])
    ref = qc.conv_acc_reference(site["xq"], site["w8"], site["dilation"], site["stride"])
    y = qc.qconv_int8(**site)
    want = qc.epilogue_reference(ref, site["ws"], site["s"], site["bias"], site["relu"],
                                 site["out_dtype"])
    torch.cuda.synchronize()
    shape = (tuple(site["xq"].shape), tuple(site["w8"].shape), site["dilation"], site["stride"])
    if not torch.equal(acc, ref):
        fail(f"qconv_int8 {shape}: int32 accumulator differs from the float64 convolution's "
             f"at {int((acc != ref).sum())} elements")
    if not torch.equal(y, want):
        err = float((y.float() - want.float()).abs().max())
        fail(f"qconv_int8 {shape}: {site['out_dtype']} output differs from the plain "
             f"epilogue's on the same accumulator (max |diff| {err:.3e})")
    return 0.0


def _mass(counter, frames):
    """sum |d| / log_para per frame of a bf16 counter's map."""
    from dgvcc_tpu_torch.serve import VideoCounter

    return VideoCounter(_AbsMap(counter.model), dtype=counter.dtype).count_frames(frames)


def _check_int8_counts(label, got, want, mass, gate):
    err = float((np.abs(got - want) / np.maximum(mass, 1.0)).max())
    log(f"{label}: int8 {np.round(got, 3).tolist()}, bf16 {np.round(want, 3).tolist()}: "
        f"{err:.4f} of the mass (gate {gate:.4f})")
    if not np.isfinite(got).all() or err > gate:
        fail(f"{label}: int8 counts off the bf16 path by {err:.4f} of the mass > {gate:.4f}")
    return err


def timed_against_cudnn(qc, site):
    """(qconv_int8's device ms, cuDNN's bf16 convolution's at the same shape
    on the dequantized input), each ``device_ms_cold``."""
    xq, w8, k, dil, stride = (site["xq"], site["w8"], site["w8"].shape[1], site["dilation"],
                              site["stride"])
    xb = (xq.float() * site["s"]).to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = w8.to(torch.bfloat16).permute(0, 3, 1, 2)
    # SAME: odd windows d (k / 2) a side; CCTrans's windows at their own
    # stride on sizes it divides, none
    pad = dil * (k // 2) if k % 2 else 0
    return (device_ms_cold(lambda: qc.qconv_int8(**site)),
            device_ms_cold(lambda: torch.nn.functional.conv2d(
                xb, wb, stride=stride, padding=pad, dilation=dil)))


def cctrans_sites(qc, qn, frames, gpu):
    """CCTrans's int8 sites of one forward of ``frames`` on their
    activations: every strided site bit for bit against the plain version,
    each distinct site shape's device time against cuDNN bf16 (a shape that
    recurs counted as often as it does), and the heaviest strided site (by
    its bound) on the same inputs against its bound and its plain version.
    Returns the numbers."""
    with recording_sites() as calls:
        qn.count_frames(frames)
    strided = [c for c in calls if c["stride"] > 1]
    got = collections.Counter((c["xq"].shape[1], c["xq"].shape[2], c["xq"].shape[3],
                               c["w8"].shape[0], c["w8"].shape[1]) for c in strided)
    if got != {site[:5]: site[5] for site in CCTRANS_STRIDED_SITES}:
        fail(f"int8 cctrans's strided sites {dict(got)} are not CCTRANS_STRIDED_SITES")
    for c in strided:
        check_qconv(qc, c)
    shapes = collections.Counter(
        (tuple(c["xq"].shape), tuple(c["w8"].shape), c["dilation"], c["stride"]) for c in calls)
    first = {}
    for c in calls:
        first.setdefault((tuple(c["xq"].shape), tuple(c["w8"].shape), c["dilation"],
                          c["stride"]), c)
    rows = []
    for key, n in shapes.items():
        (b, h, w, cin), (cout, k, _, _), dil, stride = key
        ms, lib = timed_against_cudnn(qc, first[key])
        bound, by, _ = qconv_bound_ms(b, h, w, cin, cout, k, stride=stride)
        rows.append(dict(xq=[b, h, w, cin], w8=[cout, k, k, cin], dilation=dil, stride=stride,
                         sites=n, ms=ms, library_ms=lib, bound_ms=bound, bound_by=by))
    total = sum(r["ms"] * r["sites"] for r in rows)
    total_lib = sum(r["library_ms"] * r["sites"] for r in rows)
    log(f"int8 cctrans: {len(calls)} int8 sites of one B={len(frames)} 768x1024 forward "
        f"({len(strided)} strided, bit for bit against the plain version), {len(rows)} "
        f"distinct shapes: qconv_int8 {total:.3f} ms of device time, cuDNN bf16 "
        f"{total_lib:.3f} ms ({total / total_lib:.2f}x); bound "
        f"{sum(r['bound_ms'] * r['sites'] for r in rows):.3f} ms (median of {QCONV_CALLS} "
        f"calls each, L2 cold) [{gpu}]")
    for r in sorted(rows, key=lambda r: -r["ms"] * r["sites"]):
        log(f"  cctrans site xq {r['xq']} w8 {r['w8']} dil {r['dilation']} stride "
            f"{r['stride']} x{r['sites']}: {r['ms']:.4f} ms, cuDNN bf16 {r['library_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    heavy = max((r for r in rows if r["stride"] > 1), key=lambda r: r["bound_ms"])
    site = first[(tuple(heavy["xq"]), tuple(heavy["w8"]), heavy["dilation"], heavy["stride"])]
    heavy["plain_ms"] = cuda_ms(lambda: qc.qconv_int8_reference(**site), 2, warmup=1)
    log(f"cctrans heaviest strided site xq {heavy['xq']} w8 {heavy['w8']} stride "
        f"{heavy['stride']}: {heavy['ms']:.4f} ms against its bound {heavy['bound_ms']:.4f} ms "
        f"({heavy['bound_by']}; {heavy['ms'] / heavy['bound_ms']:.2f}x), plain "
        f"{heavy['plain_ms']:.4f} ms, cuDNN bf16 {heavy['library_ms']:.4f} ms [{gpu}]")
    return dict(sites=len(calls), strided_sites=len(strided), sites_ms=total,
                sites_library_ms=total_lib, heaviest_strided=heavy, shapes=rows)


def cctrans_head_checks(qc, bf16, qn, frames, gpu):
    """CCTrans's int8 map held where it is not near zero: its head's last
    site before the ReLU (reg_res2) on ``frames``, (1) against the same
    graph with the plain version in place of the kernel at its int8 sites,
    bit for bit, and (2) against the bf16 model's, |a - b| / |b| per frame
    within 1.5 x CCTRANS_HEAD_DRIFT, while the control (the int8 map
    against the next frame's bf16 map) must read above that gate. Launches
    the kernel outside serving's window. Returns the numbers."""
    from dgvcc_tpu_torch.nn import quant as pq

    x = (torch.from_numpy(frames).cuda().permute(0, 3, 1, 2).float() / 255.0 - 0.5) / 0.5
    x = x.to(torch.bfloat16)
    seen = []
    hook = bf16.model.regression.res[3].register_forward_hook(
        lambda mod, args, out: seen.append(out))
    try:
        bf16.model(x)
    finally:
        hook.remove()
    want = seen[0].permute(0, 2, 3, 1).float().cpu().numpy()
    g, kernel = qn.quantized, pq.qconv_int8
    g.forward_fn, real_fwd = without_last_relu(g.forward_fn, "reg_res2"), g.forward_fn
    try:
        got = g(x.permute(0, 2, 3, 1)).float()
        pq.qconv_int8 = qc.qconv_int8_reference
        try:
            plain = g(x.permute(0, 2, 3, 1)).float()
        finally:
            pq.qconv_int8 = kernel
    finally:
        g.forward_fn = real_fwd
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        fail(f"int8 cctrans: reg_res2 before its ReLU differs between the kernel's graph and "
             f"the plain version's by {float((got - plain).abs().max()):.3e} at "
             f"{int((got != plain).sum())} of {got.numel()} elements")
    got = got.cpu().numpy()
    err, control = rel_l2(got, want), rel_l2(got, np.roll(want, -1, axis=0))
    gate = 1.5 * CCTRANS_HEAD_DRIFT
    log(f"int8 cctrans B={len(frames)} 768x1024, reg_res2 before its ReLU (|b| per frame "
        f"{np.round(np.linalg.norm(want.reshape(len(want), -1), axis=1), 2).tolist()}): the "
        f"kernel's graph equal to the plain version's bit for bit; |int8 - bf16| / |bf16| "
        f"{np.round(err, 5).tolist()} (gate {gate:.5f}), control against the next frame's "
        f"bf16 map {np.round(control, 5).tolist()} [{gpu}]")
    if not np.isfinite(got).all() or err.max() > gate:
        fail(f"int8 cctrans: reg_res2 before its ReLU off the bf16 model's by {err.max():.5f} "
             f"> {gate:.5f}")
    if control.min() <= gate:
        fail(f"int8 cctrans: the control reads {control.min():.5f} <= the gate {gate:.5f}: "
             "the head's map does not tell the frames apart")
    return dict(head_err=float(err.max()), head_control=float(control.min()), head_gate=gate)


def int8_phase(ma, counter, tmp, gpu):
    """Phase 14: int8 serving on `final` (and csrnet, bl, sasnet, dssinet).
    Returns its kernel entry's numbers and the launches by path."""
    from dgvcc_tpu_torch.cli.main import _load_calib
    from dgvcc_tpu_torch.core.registry import MODELS
    from dgvcc_tpu_torch.nn import quant as pq
    from dgvcc_tpu_torch.ops import qconv as qc
    from dgvcc_tpu_torch.serve import VideoCounter
    from dgvcc_tpu_torch.serve_http import CountingServer

    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = True
    rng = np.random.default_rng(140)
    calib = rng.integers(0, 256, (INT8_CALIB,) + FRAME + (3,), dtype=np.uint8)
    frames = rng.integers(0, 256, (16,) + FRAME + (3,), dtype=np.uint8)

    # ---- from files, started first: --task quantize on phase 6's JPEGs
    # (its test split) from a checkpoint of phase 3's seeded weights
    ckpt = os.path.join(tmp, "final_seed0.pth")
    torch.save(counter.model.state_dict(), ckpt)
    jpegs, art = os.path.join(tmp, "data", "test"), os.path.join(tmp, "final.int8")
    config = os.path.join(ROOT, "configs", "sta_final.yml")
    t_q = time.perf_counter()
    quantize_cli = subprocess.Popen(
        [sys.executable, "-m", "dgvcc_tpu_torch", "--config", config, "--task", "quantize",
         "--ckpt", ckpt, "--frames", jpegs, "--out", art],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)

    # ---- the int8 graph: calibrated on INT8_CALIB seeded frames
    t0 = time.perf_counter()
    q_counter = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16, seed=0,
                                             quantize=True, calib_frames=calib)
    q = q_counter.quantized
    sites = q.int8_sites()
    log(f"int8 final: folded, calibrated on {INT8_CALIB} frames and quantized in "
        f"{time.perf_counter() - t0:.1f}s; {len(sites)} int8 sites, "
        f"{len(q.sites) - len(sites)} fp ({sorted(set(q.sites) - set(sites))})")
    if len(sites) != INT8_SITES_FINAL:
        fail(f"int8 final has {len(sites)} int8 sites, not {INT8_SITES_FINAL}")

    # ---- the kernel against its plain version: every site of a B=1 forward,
    # on its real inputs, then the edge shapes
    t0 = time.perf_counter()
    with recording_sites() as calls, torch.inference_mode():
        q_counter.count_frames(frames[:1])
    check_final_sites(calls)
    with torch.inference_mode():
        for site in calls:
            check_qconv(qc, site)
        for i, (n, h, w, cin, cout, k, dil, stride) in enumerate(QCONV_EDGES):
            check_qconv(qc, qconv_site(n, h, w, cin, cout, k, 1400 + i, dilation=dil,
                                       relu=bool(i % 2),
                                       out_dtype=torch.bfloat16 if i % 3 else torch.float32,
                                       stride=stride))
    schedules = collections.Counter(
        qc.plan(c["xq"].shape, c["w8"].shape, c["dilation"])["schedule"] for c in calls)
    log(f"qconv_int8 against its plain version: the {len(calls)} sites of a B=1 768x1024 "
        f"forward (Cin {sorted({c['xq'].shape[-1] for c in calls})}; schedules "
        f"{dict(schedules)}) and {len(QCONV_EDGES)} edge shapes (Cin 3, 16, 32, 67, 192; "
        f"Cout 1, 8, 67, 130, 300; H, W off the tiles; a 1x1 image; 1x1 windows; "
        f"dilation 2; N = 3; strides 2, 4, 8 on H, W they do not divide): int32 "
        f"accumulators and outputs bit for bit, {time.perf_counter() - t0:.1f}s")

    # ---- counts against the bf16 path, launches of #1 and the int8 kernel
    wo_fold = MODELS.build("final", dtype=torch.float32)
    wo_fold.reset_parameters(torch.Generator().manual_seed(0))
    wo = VideoCounter(counter.model, dtype=torch.bfloat16, quantized=pq.QuantizedDG.from_model(
        wo_fold, dtype=torch.bfloat16, device="cuda", weight_only=True))
    del wo_fold
    errs, launches = {}, {}
    inputs = {f"count_frames B={b}": np.ascontiguousarray(frames[:b]) for b in INT8_BATCHES}
    inputs["stream 2x B=4"] = np.ascontiguousarray(frames[:8])
    with torch.inference_mode():
        # the bf16 counts and masses first: the launch window below holds
        # the int8 calls alone
        ref = {k: (counter.count_frames(f), _mass(counter, f)) for k, f in inputs.items()}
        before = dict(q_counter.dispatches)
        ma.LAUNCHES = qc.LAUNCHES = 0
        got = {k: q_counter.count_frames(inputs[k]) for k in inputs if k.startswith("count")}
        got["stream 2x B=4"] = np.concatenate(list(q_counter.stream(
            iter([frames[:4], frames[4:8]]), prefetch=1)))
        launches["int8 serving"] = {"memory_attention_fused": ma.LAUNCHES,
                                    "qconv_int8": qc.LAUNCHES}
        n_int8 = q_counter.dispatches["int8"] - before["int8"]
        n_fp = q_counter.dispatches["fp"] - before["fp"]
        for k, (want, mass) in ref.items():
            errs[k.split()[-1] if k.startswith("count") else "stream"] = _check_int8_counts(
                f"int8 final {k} 768x1024", got[k], want, mass, int8_gate("final"))
        ma.LAUNCHES = qc.LAUNCHES = 0
        f = inputs["count_frames B=4"]
        errs["weight_only"] = _check_int8_counts(
            "weight-only final count_frames B=4", wo.count_frames(f), *ref["count_frames B=4"],
            int8_gate("final weight_only"))
        if qc.LAUNCHES:
            fail("the weight-only graph launched the int8 kernel")
    want_launches = {"memory_attention_fused": n_int8, "qconv_int8": INT8_SITES_FINAL * n_int8}
    log(f"int8 final launches in a window of int8 calls alone: {launches['int8 serving']} over "
        f"{n_int8} int8 dispatches and {n_fp} fp ones (one #1 and {INT8_SITES_FINAL} "
        f"qconv_int8 a dispatch: {want_launches})")
    if n_int8 != len(INT8_BATCHES) + 2 or n_fp or launches["int8 serving"] != want_launches:
        fail(f"int8 serving: {n_int8} int8 and {n_fp} fp dispatches, launches "
             f"{launches['int8 serving']}, not {want_launches}")

    # ---- the artifact: served by the command line in a fresh process
    qout, qerr = quantize_cli.communicate(timeout=600)
    if quantize_cli.returncode:
        fail(f"--task quantize exited {quantize_cli.returncode}:\n{qerr[-3000:]}")
    log(f"CLI --task quantize ({time.perf_counter() - t_q:.1f}s with start-up, in the "
        f"background): {qout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    serve_cli = subprocess.Popen(
        [sys.executable, "-m", "dgvcc_tpu_torch", "--config", config, "--task", "serve",
         "--artifact", art, "--frames", jpegs, "--batch", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    from PIL import Image

    names = sorted(fn for fn in os.listdir(jpegs) if fn.endswith(".jpg"))
    decoded = np.stack([np.asarray(Image.open(os.path.join(jpegs, fn)).convert("RGB"))
                        for fn in names])
    inproc = VideoCounter.from_checkpoint("final", ckpt, dtype=torch.bfloat16, quantize=True,
                                          calib_frames=_load_calib(jpegs))
    want = inproc.count_frames(decoded)
    sout, serr = serve_cli.communicate(timeout=600)
    if serve_cli.returncode:
        fail(f"--task serve --artifact exited {serve_cli.returncode}:\n{serr[-3000:]}")
    lines = sout.strip().splitlines()
    log(f"CLI --task serve --artifact ({time.perf_counter() - t0:.1f}s with start-up): "
        f"{lines[-1]}")
    got = np.array([float(ln.split()[1]) for ln in lines[:-1]])
    if len(got) != len(names) or not lines[-1].endswith("(int8)"):
        fail(f"--task serve --artifact printed {len(got)} counts for {len(names)} frames: "
             f"{lines[-1]}")
    worst = float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())
    log(f"artifact served in a fresh process: {np.round(got, 2).tolist()}, the in-process "
        f"int8 counter {np.round(want, 2).tolist()}: max rel diff {worst:.2e} (tol "
        f"{TOL_CLI_TEST}: two processes' cuDNN may pick other algorithms for the fp heads)")
    if worst > TOL_CLI_TEST:
        fail("the artifact's counts in a fresh process disagree with the in-process int8 "
             "counter")

    # ---- HTTP on the artifact: 4 clients
    st = _stress_tool()
    art_counter = VideoCounter.from_artifact(art)
    bodies = st.encode_frames(8, *FRAME, seed=141, quality=90)
    dec = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB")) for b in bodies]
    alone = [float(art_counter.count_frames(d[None])[0]) for d in dec]
    srv = CountingServer(art_counter, port=0, model_name="final", max_batch=4,
                         batch_window=HTTP_WINDOW)
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        ma.LAUNCHES = qc.LAUNCHES = 0
        wall, counts, lats, errors = st.run_load(url, bodies, clients=4, requests=16)
        stats = st.get_json(url, "/stats")
        health = st.get_json(url, "/healthz")
        launches["int8 HTTP (artifact)"] = {"memory_attention_fused": ma.LAUNCHES,
                                            "qconv_int8": qc.LAUNCHES}
    finally:
        srv.shutdown()
        torch.backends.cudnn.benchmark = benchmark
    if errors or sum(len(v) for v in counts.values()) != 16:
        fail(f"int8 HTTP: {len(errors)} errors {errors[:2]}")
    http_err = _check_http_counts("int8 http 4 clients", counts, alone)
    log(f"int8 HTTP on the artifact, 4 clients x 16 requests: {16 / wall:.2f} req/s, "
        f"/healthz quantized={health.get('quantized')}, /stats dispatch_int8 "
        f"{stats['dispatch_int8']} dispatch_fp {stats['dispatch_fp']}, counts within "
        f"{http_err:.2e} of count_frames alone; launches {launches['int8 HTTP (artifact)']}")
    n_http = launches["int8 HTTP (artifact)"]["memory_attention_fused"]
    if (not health.get("quantized") or stats["dispatch_int8"] <= 0 or stats["dispatch_fp"]
            or n_http == 0
            or launches["int8 HTTP (artifact)"]["qconv_int8"] != INT8_SITES_FINAL * n_http):
        fail("int8 HTTP: the server did not serve the int8 graph")
    del inproc, art_counter, wo
    torch.cuda.empty_cache()

    # ---- the conv families at B=4 and CCTrans at B=8: int8 against bf16,
    # frames/s; mcnn none. Each family's launches are counted from zero just
    # before its own run, after the check of its site
    fam, family_sites, strided = {}, {}, None
    baseline_launches = 0
    for name in INT8_BASELINES:
        t0 = time.perf_counter()
        bf16 = VideoCounter.from_checkpoint(name, None, dtype=torch.bfloat16, seed=11)
        qn = VideoCounter.from_checkpoint(name, None, dtype=torch.bfloat16, seed=11,
                                          quantize=True, calib_frames=calib)
        # CCTrans at its graph's int8 floor (8), the others at 4
        nb = max(4, qn.quantized.int8_min_batch)
        f4 = np.ascontiguousarray(frames[:nb])
        with torch.inference_mode():
            if name == "cctrans":
                head = cctrans_head_checks(qc, bf16, qn, f4, gpu)
            if name in QCONV_FAMILY_SITES:
                # one of the family's sites on its real input, bit for bit
                kh, kw, cin = QCONV_FAMILY_SITES[name]
                with recording_sites() as fcalls:
                    qn.count_frames(f4[:1])
                site = next((c for c in fcalls if c["w8"].shape[1:3] == (kh, kw)
                             and cin in (None, c["w8"].shape[3])), None)
                if site is None:
                    fail(f"int8 {name}: no site with a {kh}x{kw} window and Cin {cin}")
                check_qconv(qc, site)
                family_sites[name] = dict(xq=list(site["xq"].shape),
                                          w8=list(site["w8"].shape), stride=site["stride"],
                                          plan=qc.plan(site["xq"].shape, site["w8"].shape,
                                                       site["dilation"], site["stride"]))
                log(f"qconv_int8 against its plain version at a {name} site, xq "
                    f"{family_sites[name]['xq']} w8 {family_sites[name]['w8']} "
                    f"({family_sites[name]['plan']}): bit for bit")
            n_sites = len(qn.quantized.int8_sites())
            want_mass = _mass(bf16, f4)
            want_counts = bf16.count_frames(f4)
            dispatched = qn.dispatches["int8"]
            ma.LAUNCHES = qc.LAUNCHES = 0
            err = _check_int8_counts(
                f"int8 {name} count_frames B={nb} 768x1024 ({n_sites} int8 sites of "
                f"{len(qn.quantized.sites)})", qn.count_frames(f4), want_counts, want_mass,
                int8_gate(name))
            fps = {}
            for label, c in (("bf16", bf16), ("int8", qn), ("int8", qn), ("bf16", bf16)):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(3):
                    c.count_frames(f4)
                fps.setdefault(label, []).append(3 * nb / (time.perf_counter() - t1))
            dispatched = qn.dispatches["int8"] - dispatched
            if qc.LAUNCHES != n_sites * dispatched:
                fail(f"int8 {name}: {qc.LAUNCHES} qconv_int8 launches for {n_sites} int8 sites "
                     f"x {dispatched} int8 dispatches")
            launched = qc.LAUNCHES
            baseline_launches += launched
            if name == "cctrans":
                strided = dict(cctrans_sites(qc, qn, f4, gpu), **head)
        fam[name] = dict(err=err, fps=fps)
        log(f"serve {name} B={nb} 768x1024 in turns (bf16, int8, int8, bf16): int8 "
            f"{[round(v, 2) for v in fps['int8']]}, bf16 {[round(v, 2) for v in fps['bf16']]} "
            f"frames/s; qconv_int8 launched {launched} = {n_sites} sites x {dispatched} "
            f"dispatches; {time.perf_counter() - t0:.1f}s [{gpu}]")
        del bf16, qn
        torch.cuda.empty_cache()
    launches["int8 baselines"] = {"qconv_int8": baseline_launches}
    if baseline_launches == 0:
        fail("the int8 baselines never launched the int8 kernel")
    mcnn = pq.build_quantized(MODELS.build("mcnn"), calib[:1, :256, :256].astype(np.float32)
                              / 127.5 - 1.0)
    log(f"mcnn under min_ch=128: {len(mcnn.int8_sites())} int8 sites of {len(mcnn.sites)} "
        "(pure bf16)")
    if mcnn.int8_sites():
        fail("mcnn built int8 sites under min_ch=128")

    # ---- times: frames/s int8 against bf16 in turns, host clock, synchronised
    fps = {}
    with torch.inference_mode():
        for b in INT8_BATCHES:
            f = np.ascontiguousarray(frames[:b])
            iters = {1: 12, 4: 4, 16: 1}[b]
            for label, c in (("bf16", counter), ("int8", q_counter), ("int8", q_counter),
                             ("bf16", counter)):
                c.count_frames(f)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    c.count_frames(f)
                fps.setdefault(b, {}).setdefault(label, []).append(
                    b * iters / (time.perf_counter() - t0))
            log(f"serve final count_frames B={b} 768x1024 in turns (bf16, int8, int8, bf16): "
                f"int8 {[round(v, 2) for v in fps[b]['int8']]}, bf16 "
                f"{[round(v, 2) for v in fps[b]['bf16']]} frames/s [{gpu}]")

        # device time of the int8 sites of one B=4 forward, on their real
        # activations, against cuDNN's bf16 convolution at the same shapes;
        # the three heaviest also on the seeded inputs scripts/sweep_qconv.py
        # times them on (final_site), which give the kernels line's numbers.
        # Each with a cold L2 (device_ms_cold)
        with recording_sites() as calls4:
            q_counter.count_frames(np.ascontiguousarray(frames[:4]))
        check_final_sites(calls4)

        rows = []
        for i, site in enumerate(calls4):
            h, w, cin, cout, k = FINAL_INT8_SITES[i]
            ms, lib = timed_against_cudnn(qc, site)
            bound, by, ops = qconv_bound_ms(4, h, w, cin, cout, k)
            rows.append(dict(index=i, shape=(4, h, w, cin, cout, k), ms=ms, library_ms=lib,
                             bound_ms=bound, bound_by=by, ops=ops,
                             plan=qc.plan(site["xq"].shape, site["w8"].shape)))
        total, total_lib = sum(r["ms"] for r in rows), sum(r["library_ms"] for r in rows)
        log(f"int8 sites of one B=4 768x1024 forward on its activations: {len(rows)} "
            f"qconv_int8 calls {total:.3f} ms of device time, cuDNN bf16 convolutions at the "
            f"same shapes {total_lib:.3f} ms ({total / total_lib:.2f}x); bound "
            f"{sum(r['bound_ms'] for r in rows):.3f} ms (median of {QCONV_CALLS} calls each, "
            f"L2 cold) [{gpu}]")
        for r in rows:
            log(f"  site {r['index']:2d} {r['shape']}: {r['ms']:.4f} ms, cuDNN bf16 "
                f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}); "
                f"{r['plan']}")
        below = [r["index"] for r in rows if r["ms"] < r["bound_ms"]]
        if below:
            log(f"WARNING: sites {below} read below their bound")
        heavy = sorted(rows, key=lambda r: -r["ops"])[:3]
        for r in heavy:
            seeded = final_site(r["index"], 4)
            r["ms_activations"], r["library_ms_activations"] = r["ms"], r["library_ms"]
            r["ms"], r["library_ms"] = timed_against_cudnn(qc, seeded)
            r["plain_ms"] = cuda_ms(lambda: qc.qconv_int8_reference(**seeded), 2, warmup=1)
            log(f"qconv_int8 site {r['index']} {r['shape']} on seeded inputs: {r['ms']:.4f} ms "
                f"(on the activations {r['ms_activations']:.4f}), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}; {r['ops'] / r['ms'] / 1e9:.1f} TOP/s achieved), plain "
                f"{r['plain_ms']:.4f} ms, cuDNN bf16 {r['library_ms']:.4f} ms "
                f"({r['ms'] / r['library_ms']:.2f}x) [{gpu}]")
            del seeded
    h = heavy[0]
    b, hh, ww, cin, cout, k = h["shape"]
    entry = dict(ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
                 bound_by=h["bound_by"], library_ms=h["library_ms"],
                 ms_activations=h["ms_activations"],
                 shape={"xq": [b, hh, ww, cin], "w8": [cout, k, k, cin], "dilation": 1,
                        "out": "bfloat16"},
                 timing=f"median of {QCONV_CALLS} calls, L2 cold (device_ms_cold)",
                 sites_ms_b4=total, sites_library_ms_b4=total_lib,
                 heaviest=[{key: r[key] for key in ("index", "shape", "ms", "ms_activations",
                                                    "library_ms", "library_ms_activations",
                                                    "bound_ms", "plain_ms", "plan")}
                           for r in heavy],
                 sites_b4=[dict(index=r["index"], shape=r["shape"], ms=r["ms"],
                                library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                                schedule=r["plan"]["schedule"])
                           for r in rows],
                 family_sites=family_sites, cctrans=strided,
                 fps={str(b): v for b, v in fps.items()}, count_errs=errs,
                 families={k: v["fps"] for k, v in fam.items()})
    log(f"phase 14 (int8 serving): {time.perf_counter() - t_phase:.1f}s")
    return entry, launches, q_counter


# ---- phase 15: AOT serving -----------------------------------------------------
# an artifact's counts against the live counter it was exported from, relative
# (to the count, floored at one): the same aten ops and kernels on the same
# weights; a convolution's cuDNN algorithm may differ between the two
# callers' first calls. Int8: bit for bit, or else 1e-4 of the map's mass
AOT_TOL = 2e-3
AOT_INT8_MASS = 1e-4
AOT_FPS_ITERS = 24                  # count_frames calls a turn at B=4


def _aot_counts(label, got, want):
    err = float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())
    log(f"{label}: counts {np.round(got, 3).tolist()}, live {np.round(want, 3).tolist()}: "
        f"largest |diff| / count {err:.3e} (tol {AOT_TOL})")
    if not np.isfinite(got).all() or err > AOT_TOL:
        fail(f"{label}: the artifact's counts disagree with the live counter's")
    return err


def _aot_launches(label, ma, qc, a, n_sites=0):
    """#1 (and qconv_int8) launches since they were zeroed, against the
    AOT counter ``a``'s program calls."""
    n = sum(a.dispatches.values())
    got = {"memory_attention_fused": ma.LAUNCHES}
    if n_sites:
        got["qconv_int8"] = qc.LAUNCHES
    log(f"{label}: {n} program calls, launches {got}")
    if n == 0 or ma.LAUNCHES != n or (n_sites and qc.LAUNCHES != n_sites * n):
        fail(f"{label}: {got} over {n} program calls, not one #1"
             + (f" and {n_sites} qconv_int8" if n_sites else "") + " a call")
    return got


def aot_phase(ma, counter, q_counter, tmp, gpu):
    """Phase 15: AOT serving (nn/aot.py). `final` bf16 (phase 3's counter)
    exported on the card at 4x768x1024 and 1x768x1024, saved, loaded and
    served against the live counter; phase 14's int8 counter at 4x768x1024;
    an artifact exported from a counter built on the CPU for cuda,cpu, served
    on the card; frames/s AOT against live in turns; --task serve --aot on
    phase 6's test JPEGs through the command line's main. Returns its
    numbers and the launches by path."""
    from PIL import Image

    from dgvcc_tpu_torch.nn import aot
    from dgvcc_tpu_torch.ops import qconv as qc
    from dgvcc_tpu_torch.serve import VideoCounter

    t_phase = time.perf_counter()
    frames = np.random.default_rng(150).integers(0, 256, (4,) + FRAME + (3,), dtype=np.uint8)
    shape4, shape1 = (4,) + FRAME, (1,) + FRAME
    out, launches = {}, {}

    # ---- 1. bf16, exported on the card
    t0 = time.perf_counter()
    doc = aot.export_serving(counter, [shape4, shape1])
    out["export_s"] = time.perf_counter() - t0
    path = os.path.join(tmp, "final.aot")
    aot.save_aot(doc, path)
    out["bytes"] = os.path.getsize(path)
    t0 = time.perf_counter()
    a = aot.AotCounter.load(path)
    out["load_s"] = time.perf_counter() - t0
    log(f"AOT bf16 final: exported {sorted(doc['programs'])} in {out['export_s']:.2f}s "
        f"(program bytes {[len(b) for b in doc['programs'].values()]}), saved "
        f"{out['bytes']} bytes, loaded in {out['load_s']:.2f}s")
    with torch.inference_mode():
        live = counter.count_frames(frames)
        ma.LAUNCHES = 0
        got = np.concatenate([a.count_frames(frames), a.count_frames(frames[:1]),
                              np.concatenate(list(a.stream(iter([frames[:3], frames]),
                                                           prefetch=1)))])
        launches["AOT bf16"] = _aot_launches("AOT bf16 (B=4, B=1, stream of 3 and 4)", ma,
                                             qc, a)
    out["max_rel_diff"] = _aot_counts("AOT bf16 final 768x1024", got,
                                      np.concatenate([live, live[:1], live[:3], live]))

    # ---- 2. int8: phase 14's counter
    t0 = time.perf_counter()
    doc8 = aot.export_serving(q_counter, [shape4])
    out["int8_export_s"] = time.perf_counter() - t0
    path8 = os.path.join(tmp, "final_int8.aot")
    aot.save_aot(doc8, path8)
    out["int8_bytes"] = os.path.getsize(path8)
    t0 = time.perf_counter()
    a8 = aot.AotCounter.load(path8)
    out["int8_load_s"] = time.perf_counter() - t0
    with torch.inference_mode():
        live8 = q_counter.count_frames(frames)
        ma.LAUNCHES = qc.LAUNCHES = 0
        got8 = a8.count_frames(frames)
        launches["AOT int8"] = _aot_launches("AOT int8 final", ma, qc, a8, INT8_SITES_FINAL)
        if np.array_equal(got8, live8):
            out["int8_match"] = "bit for bit"
        else:
            mass = np.maximum(_mass(counter, frames), 1.0)
            err = float((np.abs(got8 - live8) / mass).max())
            out["int8_match"] = f"{err:.3e} of the mass"
            if err > AOT_INT8_MASS:
                fail(f"AOT int8: counts {got8} against live {live8}, {err:.3e} of the mass")
    log(f"AOT int8 final 768x1024: exported in {out['int8_export_s']:.2f}s, "
        f"{out['int8_bytes']} bytes, loaded in {out['int8_load_s']:.2f}s; counts "
        f"{np.round(got8, 3).tolist()} against live {np.round(live8, 3).tolist()}: "
        f"{out['int8_match']}")

    # ---- 3. exported on the CPU for cuda and cpu, served on the card
    cpu = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16, seed=0,
                                       device="cpu")
    t0 = time.perf_counter()
    doc_cpu = aot.export_serving(cpu, [shape4], platforms=["cuda", "cpu"])
    out["cpu_export_s"] = time.perf_counter() - t0
    del cpu
    a_cpu = aot.AotCounter(doc_cpu)
    with torch.inference_mode():
        ma.LAUNCHES = 0
        got_cpu = a_cpu.count_frames(frames)
        launches["AOT exported on the CPU"] = _aot_launches(
            "AOT bf16 exported on the CPU, served on the card", ma, qc, a_cpu)
    out["cpu_export_max_rel_diff"] = _aot_counts(
        f"AOT bf16 exported on the CPU ({out['cpu_export_s']:.2f}s), on the card", got_cpu, live)

    # ---- 4. frames/s, count_frames B=4, in turns AOT, live, live, AOT
    fps = {"aot": [], "live": []}
    with torch.inference_mode():
        for label, c in (("aot", a), ("live", counter), ("live", counter), ("aot", a)):
            c.count_frames(frames)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(AOT_FPS_ITERS):
                c.count_frames(frames)
            fps[label].append(4 * AOT_FPS_ITERS / (time.perf_counter() - t0))
    out["fps_b4"] = fps
    log(f"count_frames B=4 768x1024 bf16 frames/s in turns AOT, live, live, AOT: "
        f"{fps['aot'][0]:.2f}, {fps['live'][0]:.2f}, {fps['live'][1]:.2f}, {fps['aot'][1]:.2f} "
        f"[{gpu}]")

    # ---- 5. --task serve --aot through the command line's main
    jpegs = os.path.join(tmp, "data", "test")
    names = sorted(fn for fn in os.listdir(jpegs) if fn.endswith(".jpg"))
    decoded = np.stack([np.asarray(Image.open(os.path.join(jpegs, fn)).convert("RGB"))
                        for fn in names])
    want = a.count_frames(decoded)
    t0 = time.perf_counter()
    ma.LAUNCHES = 0
    lines = cli_in_process(["--config", os.path.join(ROOT, "configs", "sta_final.yml"),
                            "--task", "serve", "--aot", path, "--frames", jpegs,
                            "--batch", "4"]).strip().splitlines()
    launches["AOT CLI serve"] = {"memory_attention_fused": ma.LAUNCHES}
    counts = np.array([float(ln.split()[1]) for ln in lines[:-1]])
    log(f"CLI --task serve --aot ({time.perf_counter() - t0:.1f}s): {lines[-1]}; #1 "
        f"launched {ma.LAUNCHES}x")
    if len(counts) != len(names) or ma.LAUNCHES == 0:
        fail(f"--task serve --aot printed {len(counts)} counts for {len(names)} frames")
    check_counts("CLI serve --aot sta_final.yml, phase 6's test JPEGs", counts, want,
                 "AotCounter")
    del a, a8, a_cpu
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15 (AOT serving): {out['phase_s']:.1f}s")
    return out, launches


# ---- phase 16: serving on a mesh ----------------------------------------------
MS_RANKS = 2                        # gloo ranks sharing cuda:0: NCCL refuses two ranks a card
MS_TOL_BF16 = 2e-3                  # bf16 counts on the mesh vs one process, relative (phase
#                                     15's gate for a program at another batch)
MS_TOL_F32 = 1e-4                   # spatial f32 B=1 vs one process, TF32 off on both sides
MS_TOL_INT8 = 1e-5                  # spatial int8 counts vs one process; density rows bit for bit
MS_TOL_CLI = (2e-3, 0.01)           # torchrun's printed counts vs a fresh one process's:
#                                     relative, plus the 2 decimals printed
MS_BIG = (1080, 1920)               # the tiled frame: tile_threshold 1024, 2x3 tiles of 768
MS_TILE_THRESHOLD = 1024
MS_HTTP = 8                         # requests to the 2-rank leader, from 4 clients
MS_TIMED = 4                        # count_frames calls a rank times for frames/s
# per rank and path: (kernel #1, qconv_int8) launches; one dispatch each
MS_PATHS = {"batch bf16 B=4": (1, 0), "batch bf16 B=3": (1, 0),
            "spatial bf16 B=2": (1, 0), "spatial bf16 tiled 1080x1920": (1, 0),
            "spatial f32 B=1": (1, 0), "spatial int8 B=2": (1, INT8_SITES_FINAL)}


def ms_rank(rank, workdir):
    """Phase 16's ranks (gloo on cuda:0): phase 3's weights served on a
    2-rank mesh through ``VideoCounter(mesh=, shard=)``: each path's counts
    and its launches (counts set to 0 just before it), the int8 graph's
    density on this rank's rows, frames/s and the halo exchanges' share,
    then ``--task serve --http`` through the command line's ``run`` (rank
    0 posts MS_HTTP JPEGs from 4 clients to its own leader). Writes
    ``workdir/rank{rank}.pt``."""
    import torch.distributed as dist
    import urllib.request

    from dgvcc_tpu_torch.cli.main import run as cli_run
    from dgvcc_tpu_torch.nn import collectives
    from dgvcc_tpu_torch.ops import mem_attention as ma
    from dgvcc_tpu_torch.ops import qconv as qc
    from dgvcc_tpu_torch.parallel.mesh import make_mesh
    from dgvcc_tpu_torch.serve import VideoCounter

    torch.cuda.set_device(0)
    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    frames, ckpt = spec["frames"], spec["ckpt"]
    group = make_mesh(MS_RANKS)
    out = {"transport": collectives.halo_transport(group, "cuda"), "counts": {},
           "launches": {}}

    def path(label, fn):
        ma.LAUNCHES = qc.LAUNCHES = 0
        out["counts"][label] = fn()
        out["launches"][label] = (ma.LAUNCHES, qc.LAUNCHES)

    def counter(dtype=torch.bfloat16, **kw):
        return VideoCounter.from_checkpoint("final", ckpt, dtype=dtype, fused_mem=True,
                                            mesh=group, **kw)

    batch = counter(shard="batch")
    path("batch bf16 B=4", lambda: batch.count_frames(frames["b4"]))
    path("batch bf16 B=3", lambda: batch.count_frames(frames["b4"][:3]))
    spatial = counter(shard="spatial", tile_threshold=MS_TILE_THRESHOLD)
    path("spatial bf16 B=2", lambda: spatial.count_frames(frames["b4"][:2]))
    path("spatial bf16 tiled 1080x1920", lambda: spatial.count_frames(frames["big"]))
    with tf32_off():
        f32 = counter(torch.float32, shard="spatial")
        path("spatial f32 B=1", lambda: f32.count_frames(frames["b4"][:1]))
    del f32
    q = VideoCounter.from_artifact(spec["artifact"], mesh=group, shard="spatial")
    path("spatial int8 B=2", lambda: q.count_frames(frames["b4"][:2]))
    rows = FRAME[0] // MS_RANKS
    with torch.inference_mode():
        x = torch.from_numpy(frames["b4"][:2, rank * rows:(rank + 1) * rows]).cuda()
        x = ((x.float() / 255.0 - 0.5) / 0.5).to(q.dtype)
        out["int8_rows"] = q.quantized(x)[0].float().cpu()

    def fps(c, f):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MS_TIMED):
            c.count_frames(f)
        return len(f) * MS_TIMED / (time.perf_counter() - t0)

    out["fps"] = {"batch bf16 B=4": fps(batch, frames["b4"]),
                  "spatial bf16 B=2": fps(spatial, frames["b4"][:2])}
    swap, clock = collectives._swap, [0.0, 0]

    def clocked(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = swap(*args)
        torch.cuda.synchronize()
        clock[0] += time.perf_counter() - t0
        clock[1] += 1
        return got

    collectives._swap = clocked
    try:
        out["fps_clocked"] = fps(spatial, frames["b4"][:2])
    finally:
        collectives._swap = swap
    # the exchanges' seconds over the clocked calls' seconds
    out["halo_share"] = clock[0] / (2 * MS_TIMED / out["fps_clocked"])
    out["halo_ms"], out["halo_calls"] = 1e3 * clock[0] / MS_TIMED, clock[1] // MS_TIMED
    del batch, spatial, q
    torch.cuda.empty_cache()

    # ---- HTTP: the command line's leader and follower
    ma.LAUNCHES = 0
    srv = cli_run(spec["http_config"], "serve", http=0, batch=4, ckpt=ckpt, block=False)
    if rank == 0:
        def post(body):
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/count", data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.load(r)["count"]

        t0 = time.perf_counter()
        try:
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                out["http"] = list(pool.map(post, spec["bodies"]))
            out["http_s"] = time.perf_counter() - t0
            out["http_stats"] = srv.stats()
        finally:
            srv.shutdown()
    out["http_launches"] = ma.LAUNCHES
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def _ms_close(label, got, want, rel, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{label}: counts {got} against {want}")
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))
    log(f"serving mesh, {label}: {np.round(got, 3).tolist()} against one process's "
        f"{np.round(want, 3).tolist()}: max relative diff {err:.3e} (tol {rel}"
        f"{f' + {atol}' if atol else ''})")
    if np.any(np.abs(got - want) > rel * np.maximum(np.abs(want), 1.0) + atol):
        fail(f"{label}: the mesh's counts disagree with one process's")
    return err


def _served_lines(text):
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^(\S+\.jpg) (-?\d+\.\d+)$", text, re.M)}


def mesh_serve_phase(counter, gpu):
    """Phase 16: serving on a mesh of MS_RANKS gloo ranks sharing cuda:0 at
    full width (`final`, 768x1024, phase 3's seed-0 weights through a
    checkpoint of them): batch-sharded bf16 at B=4 and 3, spatial f32 at
    B=1, bf16 at B=2 and tiled at 1080x1920, spatial int8 on ``--task
    quantize``'s artifact (its density rows bit for bit against one
    process's), frames/s a rank and the halo exchanges' share, HTTP through
    a 2-rank leader; and torchrun ``--task serve`` with mesh: {spatial: 2}
    on 4 seeded JPEGs against a fresh one process's. It runs right after
    phase 3, while mem_attention_train's nvcc build runs (phase 2b waits for
    it), and makes its own inputs, as phases 6, 9 and 14 make theirs.
    Returns the launches by path."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        return _mesh_serve_phase(counter, gpu, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _mesh_serve_phase(counter, gpu, tmp):
    import yaml
    from PIL import Image

    from dgvcc_tpu_torch.cli.main import main as cli_main
    from dgvcc_tpu_torch.parallel.launch import run_ranks
    from dgvcc_tpu_torch.serve import VideoCounter

    ckpt, art = os.path.join(tmp, "final_seed0.pth"), os.path.join(tmp, "final.int8")
    torch.save(counter.model.state_dict(), ckpt)
    write_dataset(os.path.join(tmp, "data"), seed=16, counts=(0, 0, 4))
    jpegs = os.path.join(tmp, "data", "test")
    work = os.path.join(tmp, "mesh_serve")
    os.makedirs(work)
    with open(os.path.join(ROOT, "configs", "sta_final.yml")) as f:
        raw = yaml.safe_load(f)
    raw.update(mesh={"spatial": MS_RANKS}, serve_shard="spatial")
    sp_cfg = os.path.join(work, "sta_final_serve_spatial.yml")
    with open(sp_cfg, "w") as f:
        yaml.safe_dump(raw, f)

    # ---- the command line, in fresh processes on both sides, started first
    outdir = os.path.join(work, "cli_ranks")
    os.makedirs(outdir)
    t_cli = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={MS_RANKS}", os.path.abspath(__file__), "--cli-rank", outdir,
         "--config", sp_cfg, "--task", "serve", "--frames", jpegs, "--ckpt", ckpt,
         "--dist-backend", "gloo"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    one = subprocess.Popen(
        [sys.executable, "-m", "dgvcc_tpu_torch", "--config",
         os.path.join(ROOT, "configs", "sta_final.yml"), "--task", "serve", "--frames", jpegs,
         "--ckpt", ckpt], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)

    # ---- the int8 artifact (phase 14's command, in this process) and the
    # HTTP bodies
    with no_autotune():
        cli_main(["--config", os.path.join(ROOT, "configs", "sta_final.yml"), "--task",
                  "quantize", "--ckpt", ckpt, "--frames", jpegs, "--out", art])
    bodies = _stress_tool().encode_frames(MS_HTTP, *FRAME, seed=160, quality=90)
    decoded = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB")) for b in bodies]

    # ---- the API's ranks
    rng = np.random.default_rng(160)
    frames = {"b4": rng.integers(0, 256, (4,) + FRAME + (3,), dtype=np.uint8),
              "big": rng.integers(0, 256, (1,) + MS_BIG + (3,), dtype=np.uint8)}
    torch.save({"frames": frames, "ckpt": ckpt, "artifact": art, "http_config": sp_cfg,
                "bodies": bodies}, os.path.join(work, "spec.pt"))
    t0 = time.perf_counter()
    run_ranks(ms_rank, MS_RANKS, (work,), init_file=os.path.join(work, "init"), timeout=600)
    rank_s = time.perf_counter() - t0
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(MS_RANKS)]
    log(f"serving mesh: {MS_RANKS} ranks ({res[0]['transport']}) ran in {rank_s:.1f} s "
        f"with start-up")

    # ---- one process: phase 3's counter, an f32 twin, the artifact
    with no_autotune():
        want = {"batch bf16 B=4": counter.count_frames(frames["b4"]),
                "batch bf16 B=3": counter.count_frames(frames["b4"][:3]),
                "spatial bf16 B=2": counter.count_frames(frames["b4"][:2])}
        threshold = counter.tile_threshold
        counter.tile_threshold = MS_TILE_THRESHOLD
        try:
            want["spatial bf16 tiled 1080x1920"] = counter.count_frames(frames["big"])
        finally:
            counter.tile_threshold = threshold
        with tf32_off():
            f32 = VideoCounter.from_checkpoint("final", ckpt, dtype=torch.float32,
                                               fused_mem=True)
            want["spatial f32 B=1"] = f32.count_frames(frames["b4"][:1])
        del f32
        q = VideoCounter.from_artifact(art)
        want["spatial int8 B=2"] = q.count_frames(frames["b4"][:2])
        with torch.inference_mode():
            x = torch.from_numpy(frames["b4"][:2]).cuda()
            rows_want = q.quantized(((x.float() / 255.0 - 0.5) / 0.5).to(q.dtype))[0]
            rows_want = rows_want.float().cpu()
        http_want = [float(counter.count_frames(f[None])[0]) for f in decoded]
    del q
    tols = {"spatial f32 B=1": MS_TOL_F32, "spatial int8 B=2": MS_TOL_INT8}
    launches = {"memory_attention_fused": 0, "qconv_int8": 0}
    for r, o in enumerate(res):
        for label, (n1, n8) in MS_PATHS.items():
            _ms_close(f"rank {r} {label}", o["counts"][label], want[label],
                      tols.get(label, MS_TOL_BF16))
            if o["launches"][label] != (n1, n8):
                fail(f"rank {r} {label}: launches (#1, qconv_int8) {o['launches'][label]}, "
                     f"not {(n1, n8)}")
            launches["memory_attention_fused"] += n1
            launches["qconv_int8"] += n8
        rows = FRAME[0] // MS_RANKS
        mine = rows_want[:, r * rows:(r + 1) * rows]
        if not torch.equal(o["int8_rows"], mine):
            diff = (o["int8_rows"] - mine).abs()
            fail(f"rank {r}: the int8 graph's density rows differ from one process's rows "
                 f"(max |diff| {float(diff.max()):.3e} at {int((diff > 0).sum())} pixels)")
        log(f"serving mesh rank {r}: frames/s (each rank returns every count) "
            f"{', '.join(f'{k} {v:.2f}' for k, v in o['fps'].items())}; spatial B=2 with "
            f"each of its {o['halo_calls']} halo exchanges a call clocked "
            f"{o['fps_clocked']:.2f} frames/s, the exchanges {o['halo_ms']:.1f} ms a call "
            f"= {o['halo_share']:.3f} of it [{gpu}]")
    log(f"serving mesh, spatial int8: each rank's density rows bit for bit against the "
        f"same rows of one process's int8 graph ({tuple(rows_want.shape)})")

    # ---- HTTP through the 2-rank leader
    o0 = res[0]
    _check_http_counts(f"serving mesh HTTP ({MS_HTTP} requests, 4 clients)",
                       {i: [c] for i, c in enumerate(o0["http"])},
                       dict(enumerate(http_want)))
    batches = o0["http_stats"]["batches"]
    if o0["http_stats"]["frames"] != MS_HTTP or any(
            o["http_launches"] != batches for o in res):
        fail(f"serving mesh HTTP: stats {o0['http_stats']}, launches of #1 a rank "
             f"{[o['http_launches'] for o in res]} for {batches} batches")
    launches["memory_attention_fused"] += MS_RANKS * batches
    log(f"serving mesh HTTP: {MS_HTTP / o0['http_s']:.2f} req/s, {batches} batches, #1 "
        f"launched once a batch on each rank [{gpu}]")

    # ---- the command line: torchrun's rank 0 against a fresh one process
    cli_out, cli_err = cli.communicate(timeout=600)
    one_out, one_err = one.communicate(timeout=600)
    cli_s = time.perf_counter() - t_cli
    if cli.returncode or one.returncode:
        fail(f"--task serve on the mesh exited {cli.returncode}, one process "
             f"{one.returncode}:\n{cli_err[-3000:]}\n{one_err[-3000:]}")
    got, ref = _served_lines(cli_out), _served_lines(one_out)
    names = sorted(n for n in os.listdir(jpegs) if n.endswith(".jpg"))
    if sorted(got) != names or sorted(ref) != names or "x 2 ranks (spatial)" not in cli_out:
        fail(f"--task serve on the mesh printed {sorted(got)} for {names}:\n{cli_out[-2000:]}")
    _ms_close("torchrun --task serve (mesh: {spatial: 2}, serve_shard: spatial)",
              [got[n] for n in names], [ref[n] for n in names], *MS_TOL_CLI)
    per_rank = []
    for r in range(MS_RANKS):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            per_rank.append(json.load(f)["memory_attention_fused"])
    dispatches = math.ceil(len(names) / 4)
    if per_rank != [dispatches] * MS_RANKS:
        fail(f"torchrun --task serve: #1 launched {per_rank} times on the ranks for "
             f"{dispatches} dispatches")
    launches["memory_attention_fused"] += sum(per_rank)
    log(f"serving mesh CLI: torchrun --nproc_per_node={MS_RANKS} -m dgvcc_tpu_torch --task "
        f"serve --dist-backend gloo ({len(names)} JPEGs): {cli_s:.1f} s with start-up, "
        f"beside the one-process run; #1 launches per rank {per_rank}")
    return launches


# ---- phase 17: the convolutional baselines on a spatial mesh -------------------
BS_RANKS = 2                        # gloo ranks sharing cuda:0, as phase 16's
BS_FAMILIES = ("mcnn", "csrnet", "bl", "sasnet", "dssinet")
BS_INT8 = ("csrnet", "bl", "sasnet", "dssinet")     # mcnn has no site of 128 channels
BS_B = 2                            # train crops of TRAIN_CROP^2: 160 rows a rank
BS_SERVE_B = 2                      # serving frames of FRAME: 384 rows a rank
BS_SEED = 17
BS_TIMED = 3                        # count_frames calls a rank times for frames/s
TOL_BS_F32 = (1e-4, 1e-2)           # f32 step 1 vs one process: loss parts, relative;
#                                     gradients, relative norm (phase 13's f32 gates)
TOL_BS_BF16 = 1e-3                  # bf16 step 1: the loss, relative (its gradients shown)
TOL_BS_SERVE = {"bf16": 2e-3, "f32": 1e-4, "int8": 1e-5,   # counts vs one process
                # int8 as served (cuDNN's plans for the sites below 128 channels): 3x the
                # first reading of that path (dssinet 3.2e-3 on an H100 80GB HBM3, 700 W),
                # 10x bf16's largest on the same plans (dssinet 9.78e-4)
                "int8 cudnn": 1e-2}


def bs_train(name, group=None, rank=0):
    """Step 1 of configs/baselines/sta_{name}.yml at full width, seeded, on
    BS_B crops of TRAIN_CROP^2 (``baseline_batch``), in f32 (``exact_f32``)
    and in the config's bf16 with f32 master weights: over ``group``'s rows
    of the crops (mode simple, MSE or the Bayesian loss on the rank's rows)
    or in one process. Each dtype's metrics (averaged over the ranks),
    gradients (rank 0's, the ranks' mean) and peak memory."""
    import torch.distributed as dist

    import dgvcc_tpu_torch.losses  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
    from dgvcc_tpu_torch.parallel import mesh, spatial
    from dgvcc_tpu_torch.train.state import create_train_state
    from dgvcc_tpu_torch.train.steps import build_train_step

    cfg = load_config(os.path.join(ROOT, "configs", "baselines", f"sta_{name}.yml"))
    out = {}
    for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with exact_f32(dtype == torch.float32):
            model = MODELS.build(name, dtype=dtype, **cfg.model.get("params", {}))
            model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
            loss = LOSSES.build(cfg.loss["name"], **cfg.loss.get("params", {}))
            batch = baseline_batch(cfg, BS_SEED, b=BS_B)
            if group is not None:
                spatial.shard_height(model, group)
                batch = spatial.shard_batch_spatial(batch, rank, dist.get_world_size(group),
                                                    dim=2)
            state = create_train_state(model, cfg.optimizer, cfg.scheduler)
            step = (build_train_step(model, loss, cfg.mode, cfg.log_para) if group is None
                    else spatial.build_spatial_train_step(model, loss, cfg.mode, cfg.log_para,
                                                          group))
            torch.cuda.reset_peak_memory_stats()
            _, metrics = step(state, batch, None, 0)
            if group is not None:
                metrics = mesh.average_metrics(metrics, group)
            out[key] = {"metrics": {k: float(v) for k, v in metrics.items()},
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            if rank == 0:
                out[key]["grads"] = _grads(model)
        del model, state, step, batch
        torch.cuda.empty_cache()
    return out


def bs_counters(name, spec, mesh=None):
    """A family's serving paths, label -> a function that makes its
    counter: bf16 and f32 from its seeded checkpoint, int8 from its
    artifact; sharded over ``mesh``'s rows, or in one process."""
    from dgvcc_tpu_torch.serve import VideoCounter

    kw = {} if mesh is None else {"mesh": mesh, "shard": "spatial"}
    ckpt = spec["ckpts"][name]
    paths = {"bf16": lambda: VideoCounter.from_checkpoint(name, ckpt, **kw),
             "f32": lambda: VideoCounter.from_checkpoint(name, ckpt, dtype=torch.float32,
                                                         **kw)}
    if name in BS_INT8:
        paths["int8"] = paths["int8 cudnn"] = lambda: VideoCounter.from_artifact(
            spec["artifacts"][name], **kw)
    return paths


def bs_serve(name, spec, mesh=None, rank=0):
    """A family's counts on each path, its launches of qconv_int8 (counts set
    to 0 just before each), bf16 frames/s, and the int8 graph's density on
    this rank's rows of the frames. f32 runs with TF32 off. int8 runs twice:
    with the sites below 128 channels on PyTorch's own convolutions
    (``exact_f32``), where a rank's rows must equal one process's bit for
    bit, and as served ("int8 cudnn"), where cuDNN's bf16 plans differ
    between a rank's haloed rows and the whole frame and an int8 site whose
    input moves by a rounding quantizes a step apart (on an H100 80GB HBM3:
    5 of csrnet's density pixels one bf16 step apart, dssinet's counts
    3.2e-3)."""
    from dgvcc_tpu_torch.ops import qconv as qc

    frames, world = spec["frames"], 1 if mesh is None else BS_RANKS
    rows = FRAME[0] // world
    out = {"counts": {}, "launches": {}}
    exact = {"bf16": contextlib.nullcontext, "f32": tf32_off, "int8": exact_f32,
             "int8 cudnn": contextlib.nullcontext}
    for label, build in bs_counters(name, spec, mesh).items():
        with exact[label]():
            c = build()
            qc.LAUNCHES = 0
            out["counts"][label] = c.count_frames(frames)
            out["launches"][label] = qc.LAUNCHES
        if label.startswith("int8"):
            out["int8_sites"] = len(c.quantized.int8_sites())
            with torch.inference_mode(), exact[label]():
                x = torch.from_numpy(frames[:, rank * rows:(rank + 1) * rows]).cuda()
                out.setdefault("int8_rows", {})[label] = c.quantized(
                    ((x.float() / 255.0 - 0.5) / 0.5).to(c.quantized.dtype)).float().cpu()
        if label == "bf16":
            out["fps"] = bs_fps(c, frames, mesh)
        del c
        torch.cuda.empty_cache()
    return out


def bs_fps(counter, frames, mesh):
    """frames/s of BS_TIMED count_frames calls; on a mesh also the halo
    exchanges' milliseconds a call and their share of a clocked call."""
    import torch.distributed as dist

    from dgvcc_tpu_torch.nn import collectives

    def calls():
        if mesh is not None:
            dist.barrier()
        counter.count_frames(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BS_TIMED):
            counter.count_frames(frames)
        return time.perf_counter() - t0

    out = {"fps": len(frames) * BS_TIMED / calls()}
    if mesh is None:
        return out
    swap, clock = collectives._swap, [0.0, 0]

    def clocked(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = swap(*args)
        torch.cuda.synchronize()
        clock[0] += time.perf_counter() - t0
        clock[1] += 1
        return got

    collectives._swap = clocked
    try:
        s = calls()
    finally:
        collectives._swap = swap
    out.update(halo_ms=1e3 * clock[0] / BS_TIMED, halo_share=clock[0] / s,
               halo_calls=clock[1] // BS_TIMED)
    return out


def bs_rank(rank, workdir):
    """Phase 17's ranks (gloo on cuda:0): each family's spatial train step 1
    and its spatial serving paths. Writes ``workdir/rank{rank}.pt``."""
    from dgvcc_tpu_torch.nn import collectives
    from dgvcc_tpu_torch.parallel import spatial

    torch.cuda.set_device(0)
    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    group = spatial.make_spatial_mesh(BS_RANKS)
    out = {"transport": collectives.halo_transport(group, "cuda"), "train": {}, "serve": {}}
    with no_autotune():
        for name in BS_FAMILIES:
            out["train"][name] = bs_train(name, group, rank)
        for name in BS_FAMILIES:
            out["serve"][name] = bs_serve(name, spec, group, rank)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def bs_reference(rank, workdir):
    """Phase 17's one process (fresh, as the ranks are): each family's
    seeded f32 checkpoint and int8 artifact (calibrated on the frames),
    then its step 1 and serving paths. Writes ``workdir/reference.pt``."""
    from dgvcc_tpu_torch.nn.quant_io import save_quantized
    from dgvcc_tpu_torch.serve import VideoCounter

    torch.cuda.set_device(0)
    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    spec["ckpts"], spec["artifacts"] = {}, {}
    for i, name in enumerate(BS_FAMILIES):
        model = VideoCounter.from_checkpoint(name, None, dtype=torch.float32,
                                             seed=BS_SEED + i).model
        path = os.path.join(workdir, f"{name}.pth")
        torch.save(model.state_dict(), path)
        spec["ckpts"][name] = path
        if name in BS_INT8:
            with no_autotune():
                q = VideoCounter.from_checkpoint(name, path, quantize=True,
                                                 calib_frames=spec["frames"]).quantized
            spec["artifacts"][name] = os.path.join(workdir, f"{name}.int8")
            save_quantized(q, spec["artifacts"][name], name, {})
        del model
    torch.save(spec, os.path.join(workdir, "spec.pt"))
    out = {"train": {}, "serve": {}}
    with no_autotune():
        for name in BS_FAMILIES:
            out["train"][name] = bs_train(name)
        for name in BS_FAMILIES:
            out["serve"][name] = bs_serve(name, spec)
    torch.save(out, os.path.join(workdir, "reference.pt"))


def spatial_baselines_phase(tmp, gpu):
    """Phase 17: mcnn, csrnet, bl, sasnet and dssinet with their crop's
    height sharded over BS_RANKS gloo ranks sharing cuda:0 (``mesh:
    {spatial: 2}`` on configs/baselines/sta_*.yml, set in memory). Step 1
    at full width on BS_B crops of 320^2 (160 rows a rank) against one
    fresh process: f32 loss parts and gradients, bf16 loss (its gradients
    shown), each rank's peak memory beside one process's. Serving at
    BS_SERVE_B x 768x1024 with shard="spatial": bf16, f32 and int8 counts
    against one process (int8: csrnet, bl, sasnet, dssinet, under exact_f32
    with the density rows bit for bit, and as served on cuDNN; qconv_int8
    launched once an int8 site a rank and path),
    frames/s and the halo's share of a call. And torchrun ``--task
    train_test`` of sta_bl.yml with mesh: {spatial: 2} on phase 6's files
    (beside the one process, untimed), whose test MAE phase 13 holds
    against a fresh process. Returns (launches, the pending test)."""
    from dgvcc_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    line = ("Spatial parallel over 2 devices (crop height sharded, halo exchange by send/recv "
            "over torch.distributed)")
    work = tempfile.mkdtemp(prefix="bs_", dir=tmp)
    frames = np.random.default_rng(BS_SEED).integers(0, 256, (BS_SERVE_B,) + FRAME + (3,),
                                                     dtype=np.uint8)
    torch.save({"frames": frames}, os.path.join(work, "spec.pt"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cli = pool.submit(mesh_files_run, tmp, "spatial bl", "baselines/sta_bl", BS_RANKS,
                          False, lambda raw: raw.update(mesh={"spatial": BS_RANKS},
                                                        version="sta_bl_spatial"), 4, 0, 0,
                          line)
        run_ranks(bs_reference, 1, (work,), init_file=os.path.join(work, "init_ref"),
                  timeout=600, threads=4)
        cli_launches, pending = cli.result()
    ref = torch.load(os.path.join(work, "reference.pt"), weights_only=False)
    log(f"spatial baselines: one process's steps and serving, and torchrun bl, "
        f"{time.perf_counter() - t0:.1f}s into phase 17")
    run_ranks(bs_rank, BS_RANKS, (work,), init_file=os.path.join(work, "init"), timeout=600)
    outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(BS_RANKS)]
    log(f"spatial baselines: {BS_RANKS} ranks, halo rows by {outs[0]['transport']}; "
        f"{time.perf_counter() - t0:.1f}s into phase 17")
    for name in BS_FAMILIES:
        got, want = outs[0]["train"][name], ref["train"][name]
        label = f"spatial {name} B={BS_B} {TRAIN_CROP}^2 ({TRAIN_CROP // BS_RANKS} rows a rank)"
        hold_step1(f"{label} f32", got["f32"], want["f32"], TOL_BS_F32)
        hold_step1(f"{label} bf16", got["bf16"], want["bf16"], (TOL_BS_BF16, None))
        log(f"{label}: peak memory per rank (f32, bf16) "
            f"{max(o['train'][name]['f32']['peak_gib'] for o in outs):.3f}, "
            f"{max(o['train'][name]['bf16']['peak_gib'] for o in outs):.3f} GiB against one "
            f"process's {want['f32']['peak_gib']:.3f}, {want['bf16']['peak_gib']:.3f} GiB "
            f"[{gpu}]")
    launches = 0
    for name in BS_FAMILIES:
        want = ref["serve"][name]
        for r, o in enumerate(outs):
            got = o["serve"][name]
            for label, counts in got["counts"].items():
                _ms_close(f"spatial {name} rank {r} {label} B={BS_SERVE_B}", counts,
                          want["counts"][label], TOL_BS_SERVE[label])
            n8, n_sites = got["launches"], got.get("int8_sites", 0)
            if any(n8[k] != (n_sites if k.startswith("int8") else 0) for k in n8):
                fail(f"spatial {name} rank {r}: qconv_int8 launched {n8}; once an int8 site "
                     f"({n_sites}) on the int8 paths, never on bf16 / f32")
            launches += sum(n8.values())
            for label, rows in got.get("int8_rows", {}).items():  # at the family's stride
                h = rows.shape[1]
                diff = (rows - want["int8_rows"][label][:, r * h:(r + 1) * h]).abs()
                log(f"spatial {name} rank {r} {label}: density rows against one process's: "
                    f"max |diff| {float(diff.max()):.3e} at {int((diff > 0).sum())} of "
                    f"{diff.numel()} pixels")
                if label == "int8" and diff.max() > 0:
                    fail(f"spatial {name} rank {r}: the int8 graph's density rows differ from "
                         "one process's under exact_f32")
            f = got["fps"]
            log(f"spatial {name} rank {r} bf16 B={BS_SERVE_B} 768x1024: {f['fps']:.2f} "
                f"frames/s (one process {want['fps']['fps']:.2f}); the {f['halo_calls']} halo "
                f"exchanges a call {f['halo_ms']:.2f} ms = {f['halo_share']:.3f} of a clocked "
                f"call [{gpu}]")
        if name in BS_INT8:
            log(f"spatial {name} int8: each rank's density rows bit for bit against one "
                f"process's under exact_f32 ({tuple(want['int8_rows']['int8'].shape)}); "
                f"{outs[0]['serve'][name]['int8_sites']} qconv_int8 launches a rank and path")
    if not launches:
        fail("spatial baselines: qconv_int8 never launched")
    return {"qconv_int8": launches, **cli_launches}, pending


def log_build(logs, t0):
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"nvcc {name}: {line.strip()}")
    log(f"built {sorted(logs) or 'nothing (up to date)'} {time.perf_counter() - t0:.1f}s "
        "after the start of the build")


def check_ptxas(build, kernels):
    """ptxas's report of each (library, kernel, label) on disk; fails on a
    serialised wgmma or a spill. Returns {kernel: report}."""
    ptxas = {}
    for lib, kernel, what in kernels:
        ptxas[kernel] = build.ptxas_report(build.build_log(lib), kernel)
        log(f"ptxas, {what} bf16 K=256: {' | '.join(ptxas[kernel])}")
        faults = build.ptxas_faults(ptxas[kernel])
        if faults:
            fail(f"{what}'s bf16 K=256 build: {'; '.join(faults)}")
    return ptxas


@contextlib.contextmanager
def tf32_off():
    """Matmuls and convolutions in full float32 inside; the flags put back."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def main():
    if not torch.cuda.is_available():
        print("[chip_smoke] CUDA is not available: this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dgvcc_tpu_torch.ops import _build
    from dgvcc_tpu_torch.ops import dmap as dm
    from dgvcc_tpu_torch.ops import mem_attention as ma
    from dgvcc_tpu_torch.ops import mem_attention_train as mt
    from dgvcc_tpu_torch.serve import VideoCounter

    t_start = time.perf_counter()
    gpu = card()
    print(gpu, flush=True)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    t_phase = t0
    # mem_attention_train's nvcc takes most of the build (117.0 s on the
    # card's host, where the other three took 25.5 s together): it builds in a
    # process of its own while the others build and phases 2-3 run, and is
    # waited for before its kernels' checks (2b)
    train_build = subprocess.Popen(
        [sys.executable, "-c", "from dgvcc_tpu_torch.ops import _build; "
         "_build.build_all(['mem_attention_train'])"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), start_new_session=True)
    # a failure before the wait ends the build and its nvcc too
    atexit.register(lambda: train_build.poll() is None
                    and os.killpg(train_build.pid, signal.SIGKILL))
    logs = _build.build_all([n for n in _build.SOURCES if n != "mem_attention_train"])
    log_build(logs, t0)
    # the report of the library on disk (kept beside it), built now or not;
    # a serialised wgmma (C7512, C7514) or a spill slows the kernel and
    # passes every check of its values, so it fails here
    ptxas = check_ptxas(_build, (("mem_attention", "mem_attention_bf16_kernelILi256E",
                                  "kernel #1"),))
    ptxas_k256 = ptxas["mem_attention_bf16_kernelILi256E"]
    sass = check_sass(str(_build.library_path("mem_attention")), "mem_attention_bf16_kernel",
                      5, "kernel #1")
    # qconv_int8: the per-tap kernels (BN 64, 128, 256 x kBK 32, 64, 128)
    # and the halo kernels (BN 64, 128 x kBK 32, 64), all s8 wgmma fed by
    # TMA
    ptxas_qconv = _build.ptxas_report(_build.build_log("qconv"), "qconv_")
    log(f"ptxas, qconv_int8 ({QCONV_BODIES} kernels): {' | '.join(sorted(set(ptxas_qconv)))}")
    faults = _build.ptxas_faults(ptxas_qconv)
    if faults or len(ptxas_qconv) < 2 * QCONV_BODIES:
        fail(f"qconv_int8's build: {'; '.join(faults) or f'{len(ptxas_qconv)} ptxas lines'}")
    sass_qconv = check_sass(str(_build.library_path("qconv")), "qconv_(wgmma|halo)_kernel",
                            QCONV_BODIES, "qconv_int8", int8=True)
    phase_done("1 (build)", t_phase)

    # ---- 2. kernels vs plain versions -------------------------------------
    t_phase = time.perf_counter()
    err_bf16 = check_kernel(ma, 4, P, torch.bfloat16, TOL_BF16, 1)
    log(f"kernel #1 bf16 B=4: max_abs_err {err_bf16:.3e} (the earlier mma.sync "
        f"kernel: {MMA_SYNC_BF16_ERR:.3e})")
    err_f32 = check_kernel(ma, 4, P, torch.float32, TOL_F32, 2)
    check_kernel(ma, 3, 6400 + 37, torch.bfloat16, TOL_BF16, 3)
    check_kernel(ma, 3, 6400 + 37, torch.float32, TOL_F32, 4)
    err_edges = max(check_kernel(ma, b, p, torch.bfloat16, TOL_BF16, 60 + i, k, s)
                    for i, (b, p, k, s) in enumerate(EDGES_BF16))
    # the plain versions' float32 products in full float32 for these
    # comparisons (TF32 off); the flags are put back after them
    with tf32_off():
        dmap_err = check_dmap(dm)
    device_aug_phase(gpu)
    phase_done("2 (kernels #1 and #4 against their plain versions)", t_phase)

    # ---- 3. serve the main path -------------------------------------------
    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = True
    counter = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16,
                                           fused_mem=True, seed=0)
    plain = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16,
                                         fused_mem=False, seed=0)
    for (k1, v1), (k2, v2) in zip(counter.model.state_dict().items(),
                                  plain.model.state_dict().items()):
        if k1 != k2 or not torch.equal(v1, v2):
            fail(f"seeded weights differ between the two counters at {k1}")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4,) + FRAME + (3,), dtype=np.uint8)
    batches = [rng.integers(0, 256, (16,) + FRAME + (3,), dtype=np.uint8)
               for _ in range(4)]
    big = rng.integers(0, 256, (2, 1080, 1920, 3), dtype=np.uint8)

    def tiled(c, on):
        c.tile_threshold = 1536 if on else 4096

    paths = [
        ("count_frames B=4 768x1024", lambda c: c.count_frames(frames)),
        ("stream 4x B=16 768x1024",
         lambda c: np.concatenate(list(c.stream(iter(batches), prefetch=2)))),
        ("count_frames B=2 1080x1920 padded", lambda c: c.count_frames(big)),
        ("count_frames B=2 1080x1920 tiled 2x3x768",
         lambda c: (tiled(c, True), c.count_frames(big), tiled(c, False))[1]),
    ]
    launches = 0
    for name, run in paths:
        ma.LAUNCHES = 0
        fused_counts = run(counter)
        n = ma.LAUNCHES
        launches += n
        log(f"{name}: memory_attention_fused launched {n}x")
        if n == 0:
            fail(f"{name}: the serving path never launched the kernel")
        check_counts(name, fused_counts, run(plain))
    check_cli(frames, VideoCounter)
    phase_done("3 (serving)", t_phase)

    # ---- 16. serving on a mesh (2 ranks: batch and spatial, int8, HTTP, the
    # CLI), while mem_attention_train builds -------------------------------
    t_phase = time.perf_counter()
    mesh_serve_launches = mesh_serve_phase(counter, gpu)
    phase_done("16 (serving on a mesh, beside the training kernels' build)", t_phase)

    # ---- 2b. the training kernels, built beside phases 1-3 ----------------
    t_phase = time.perf_counter()
    out, _ = train_build.communicate()
    if train_build.returncode:
        fail(f"building mem_attention_train exited {train_build.returncode}:\n{out[-3000:]}")
    log_build({"mem_attention_train": _build.build_log("mem_attention_train")}, t0)
    ptxas.update(check_ptxas(_build, (
        ("mem_attention_train", "mat_fwd_bf16ILi256E", "kernel #2"),
        ("mem_attention_train", "mat_bwd_rows_bf16ILi256E", "kernel #3 rows"),
        ("mem_attention_train", "mat_bwd_cols_bf16ILi256E", "kernel #3 cols"))))
    sass_fwd = check_sass(str(_build.library_path("mem_attention_train")), "mat_fwd_bf16", 2,
                          "kernel #2")
    check_sass(str(_build.library_path("mem_attention_train")), "mat_bwd_(rows|cols)_bf16", 4,
               "kernel #3")
    with tf32_off():
        train_bf16 = check_train_kernels(mt, TRAIN_B, TRAIN_P, torch.bfloat16, 5)
        train_f32 = check_train_kernels(mt, TRAIN_B, TRAIN_P, torch.float32, 6)
        check_train_kernels(mt, 3, 6400 + 37, torch.bfloat16, 7)
        check_train_kernels(mt, 3, 6400 + 37, torch.float32, 8)
        near = {(dtype, eps): check_train_forward_near(mt, dtype, eps, 70 + i)
                for i, (dtype, eps) in enumerate((d, e) for d in (torch.bfloat16, torch.float32)
                                                 for e in NEAR_EPS)}
    phase_done("2b (kernels #2 and #3 against their plain versions)", t_phase)

    # ---- 4. times ---------------------------------------------------------
    t_phase = time.perf_counter()
    log(f"card: {gpu}")
    serve_fps = {}
    for b in (1, 4, 16):
        f = np.ascontiguousarray(batches[0][:b])
        for c in (counter, plain):
            c.count_frames(f)
        for label, c in (("fused_mem=True", counter), ("fused_mem=False", plain)):
            # B<=4 host-clock times spread by several percent over 8 calls
            iters = 24 if b < 16 else 4
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                c.count_frames(f)
            dt = time.perf_counter() - t0
            if c is counter:
                serve_fps[b] = b * iters / dt
            log(f"serve count_frames B={b} 768x1024 bf16 {label}: "
                f"{b * iters / dt:.2f} frames/s ({1e3 * dt / (b * iters):.3f} "
                f"ms/frame) [{gpu}]")
    list(counter.stream(iter(batches[:2])))
    t0 = time.perf_counter()
    n_frames = sum(len(x) for x in counter.stream(iter(batches + batches), prefetch=2))
    dt = time.perf_counter() - t0
    log(f"serve stream 8x B=16 768x1024 bf16 fused_mem=True: "
        f"{n_frames / dt:.2f} frames/s [{gpu}]")

    times = {}
    for b in (1, 4):
        g = torch.Generator(device="cuda").manual_seed(10 + b)
        y = torch.randn(b, P, K, generator=g, device="cuda").to(torch.bfloat16)
        mem = torch.randn(K, S, generator=g, device="cuda").to(torch.bfloat16)
        memt = mem.t().contiguous()[None, None].expand(b, 1, S, K)
        kern = cuda_ms(lambda: ma.memory_attention_fused(y, mem), 20)
        ref = cuda_ms(lambda: ma.memory_attention_reference(y, mem), 5, warmup=1)
        sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            y[:, None], memt, memt, scale=1.0 / math.sqrt(K)), 20)
        flops = 4.0 * b * P * K * S
        nbytes = 2.0 * (2 * b * P * K + K * S)
        bound_ops, bound_bytes = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_HBM_BYTES
        times[b] = dict(ms=kern, plain_ms=ref, library_ms=sdpa,
                        bound_ms=max(bound_ops, bound_bytes),
                        bound_by="operations" if bound_ops >= bound_bytes else "bytes")
        log(f"kernel B={b} P={P} K={K} S={S} bf16: memory_attention_fused "
            f"{kern:.4f} ms, plain {ref:.4f} ms, SDPA {sdpa:.4f} ms, bound "
            f"{times[b]['bound_ms']:.4f} ms ({times[b]['bound_by']}; "
            f"{flops / kern / 1e9:.1f} TFLOP/s achieved) [{gpu}]")
    g = torch.Generator(device="cuda").manual_seed(20)
    y = torch.randn(4, P, K, generator=g, device="cuda")
    mem = torch.randn(K, S, generator=g, device="cuda")
    kern32 = cuda_ms(lambda: ma.memory_attention_fused(y, mem), 5)
    log(f"kernel B=4 f32: memory_attention_fused {kern32:.4f} ms, bound "
        f"{1e3 * 4.0 * 4 * P * K * S / PEAK_F32_FLOPS:.4f} ms (f32 CUDA-core "
        f"peak) [{gpu}]")
    dmap_times = time_dmap(dm, gpu)
    phase_done("4 (times)", t_phase)

    # ---- 5. train the main path ----------------------------------------------
    t_phase = time.perf_counter()
    train_launches, train_times, step_ms = train_phase(mt, gpu)
    phase_done("5 (train step)", t_phase)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # ---- 6. from files to a trained model ------------------------------
        t_phase = time.perf_counter()
        dmap_launches, file_launches = files_phase(ma, mt, dm, gpu, step_ms, tmp)
        phase_done("6 (from files)", t_phase)

        # ---- 7. sta_final_bigcrop.yml: accum_steps 4 at 512^2 --------------
        t_phase = time.perf_counter()
        big_launches = bigcrop_phase(mt, gpu)
        phase_done("7 (bigcrop)", t_phase)

        # ---- 8. the whitening family (sw, ibn, isw, sw_vgg, DenseNets) -----
        t_phase = time.perf_counter()
        _, whiten_launches = whitening_phase(ma, mt, tmp, gpu)
        phase_done("8 (whitening family)", t_phase)

        # ---- 9. HTTP serving and the fleet ---------------------------------
        t_phase = time.perf_counter()
        _, http_launches, bodies, decoded = http_phase(ma, counter, serve_fps, gpu)
        fleet_phase(bodies, decoded, gpu)
        phase_done("9 (HTTP serving and the fleet)", t_phase)

        # ---- 10. the U-Net regressors (dgnet, dgnet_cls, reg, reg_mem) -------
        t_phase = time.perf_counter()
        _, regressor_launches = regressor_phase(ma, mt, tmp, gpu)
        phase_done("10 (regressors)", t_phase)

        # ---- 11. the generator (generation, joint) and the classic baselines --
        t_phase = time.perf_counter()
        _, generator_launches = generator_baselines_phase(ma, mt, tmp, gpu)
        phase_done("11 (generator and baselines)", t_phase)

        # ---- 12. data parallel: ranks over torch.distributed -----------------
        t_phase = time.perf_counter()
        _, dp_launches, dp_test = dp_phase(mt, tmp, gpu)
        phase_done("12 (data parallel)", t_phase)

        # ---- 17. the convolutional baselines on a spatial mesh -----------------
        t_phase = time.perf_counter()
        bs_launches, bs_test = spatial_baselines_phase(tmp, gpu)
        phase_done("17 (convolutional baselines on a spatial mesh)", t_phase)

        # ---- 13. the bank over a 2-D mesh, the crop's height over 8 ranks -----
        t_phase = time.perf_counter()
        _, mesh_launches = mesh_phase(tmp, gpu, [dp_test, bs_test])
        phase_done("13 (2-D mesh and spatial)", t_phase)

        # ---- 14. int8 serving: final, its artifact, HTTP, the conv families ----
        t_phase = time.perf_counter()
        int8, int8_launches, q_counter = int8_phase(ma, counter, tmp, gpu)
        phase_done("14 (int8 serving)", t_phase)

        # ---- 15. AOT serving: bf16 and int8 artifacts, one exported on the CPU --
        t_phase = time.perf_counter()
        aot_out, aot_launches = aot_phase(ma, counter, q_counter, tmp, gpu)
        del q_counter
        phase_done("15 (AOT serving)", t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total_s = time.perf_counter() - t_start
    log("phase times (s): " + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_S.items()))
    log(f"total {total_s:.1f}s")

    # ---- result --------------------------------------------------------------
    # each path's launches, from its own run (counts set to 0 just before)
    by_path = {"serving": {"memory_attention_fused": launches},
               "train step (phase 5)": {"memory_attention_train_fwd": train_launches[0],
                                        "memory_attention_train_bwd": train_launches[1]},
               **{f"files {label}": n for label, n in file_launches.items()},
               "bigcrop accum_steps 4": {"memory_attention_train_fwd": big_launches[0],
                                         "memory_attention_train_bwd": big_launches[1]},
               "whitening family (phase 8)": whiten_launches,
               "http serving (phase 9)": {"memory_attention_fused": http_launches},
               "regressors (phase 10)": regressor_launches,
               "generator and baselines (phase 11)": generator_launches,
               "data parallel ranks (phase 12)": dp_launches,
               "2-D mesh and spatial ranks (phase 13)": mesh_launches,
               **{f"{k} (phase 14)": n for k, n in int8_launches.items()},
               **{f"{k} (phase 15)": n for k, n in aot_launches.items()},
               "serving mesh ranks (phase 16)": mesh_serve_launches,
               "spatial baselines (phase 17)": bs_launches}

    def total(name):
        return sum(n.get(name, 0) for n in by_path.values())

    def paths(name):
        return {path: n[name] for path, n in by_path.items() if name in n}

    t4 = times[4]
    train_shape = {"B": TRAIN_B, "P": TRAIN_P, "K": K, "S": S, "views": 2,
                   "dtype": "bfloat16"}
    source = "dgvcc_tpu_torch/csrc/mem_attention_train.cu"
    print(json.dumps({"kernels": [{
        "name": "memory_attention_fused", "route": "cuda",
        "source": "dgvcc_tpu_torch/csrc/mem_attention.cu",
        "replaces": "dgvcc_tpu/ops/mem_attention.py:59",
        "launches": total("memory_attention_fused"),
        "launches_by_path": paths("memory_attention_fused"), "ok": True,
        "max_abs_err": err_bf16, "max_err": err_bf16, "max_abs_err_f32": err_f32,
        "max_abs_err_edges": err_edges, "ptxas_k256": ptxas_k256, "sass": sass,
        "ms": t4["ms"], "plain_ms": t4["plain_ms"], "bound_ms": t4["bound_ms"],
        "bound_by": t4["bound_by"], "library_ms": t4["library_ms"],
        "ms_b1": times[1]["ms"], "library_ms_b1": times[1]["library_ms"],
        "bound_ms_b1": times[1]["bound_ms"], "aot_serving": aot_out,
        "shape": {"B": 4, "P": P, "K": K, "S": S, "dtype": "bfloat16"}}, {
        "name": "memory_attention_train_fwd", "route": "cuda", "source": source,
        "replaces": "dgvcc_tpu/ops/mem_attention_train.py:134",
        "launches": total("memory_attention_train_fwd"),
        "launches_by_path": paths("memory_attention_train_fwd"), "ok": True,
        "max_abs_err": train_bf16["out"], "max_err": train_bf16["out"],
        "max_abs_err_f32": train_f32["out"], "out_rel_norm_err": train_bf16["out_rel"],
        "loss_con_rel_err": train_bf16["con_rel"],
        "loss_con_rel_err_near": {str(e): near[torch.bfloat16, e][0] for e in NEAR_EPS},
        "q_rel_err_near": {str(e): near[torch.bfloat16, e][1] for e in NEAR_EPS},
        "ptxas_k256": ptxas["mat_fwd_bf16ILi256E"], "sass": sass_fwd,
        **train_times["fwd"], "library_ms": None, "shape": train_shape}, {
        "name": "memory_attention_train_bwd", "route": "cuda", "source": source,
        "replaces": "dgvcc_tpu/ops/mem_attention_train.py:177",
        "launches": total("memory_attention_train_bwd"),
        "launches_by_path": paths("memory_attention_train_bwd"), "ok": True,
        "max_abs_err": train_bf16["dy"], "max_err": train_bf16["dy"],
        "max_abs_err_f32": train_f32["dy"], "dy_rel_norm_err": train_bf16["dy_rel"],
        "dm_rel_norm_err": train_bf16["dm_rel"],
        "loss_con_grad_rel_norm_err": max(train_bf16["con_dy_rel"], train_bf16["con_dm_rel"]),
        **train_times["bwd"], "library_ms": None, "shape": train_shape}, {
        "name": "gaussian_density", "route": "cuda",
        "source": "dgvcc_tpu_torch/csrc/dmap.cu",
        "replaces": "dgvcc_tpu/ops/dmap.py:247",
        "launches": dmap_launches, "launches_by_path": {"dmap_cli": dmap_launches},
        "ok": True,
        "max_abs_err": dmap_err, "max_err": dmap_err, **dmap_times,
        "shape": {"H": FRAME[0], "W": FRAME[1], "N": 1024, "sigma": 4.0, "radius": 7,
                  "dtype": "float32"}}, {
        "name": "qconv_int8", "route": "cuda", "source": "dgvcc_tpu_torch/csrc/qconv.cu",
        "replaces": "dgvcc_tpu/nn/quant.py:290 (XLA int8 convolution; not a pl.pallas_call)",
        "launches": total("qconv_int8"), "launches_by_path": paths("qconv_int8"), "ok": True,
        "max_abs_err": 0.0, "max_err": 0.0, "ptxas": sorted(set(ptxas_qconv)),
        "sass": sass_qconv, "aot_serving": {k: aot_out[k] for k in (
            "int8_export_s", "int8_bytes", "int8_load_s", "int8_match")}, **int8}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:  # phase 12's and 13's torchrun ranks
        exact = sys.argv[3:4] == ["--exact-f32"]
        sys.exit(cli_rank(sys.argv[2], sys.argv[3 + exact:], exact))
    if sys.argv[1:2] == ["--cli-tests"]:  # phase 13's one-process references
        sys.exit(cli_tests(sys.argv[2]))
    sys.exit(main())
