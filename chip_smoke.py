#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, conv, training, SSDLite, COCO, FSSD, RFB, YOLO, ResNet, SSD512, export, int8, device-augmentation, data-parallel, observability, spatial (SSD, FSSD, YOLO) and mAP-parity paths on one GPU.

    python3 chip_smoke.py [--seed 0] [--report PATH]

Phases, each of which raises on failure (the script then exits non-zero):

1. inventory: torch, CUDA and the card (``nvidia-smi`` name and power limit);
   no GPU means no run;
2. build: ``ssds_tpu_torch/csrc/*.cu`` compiled with nvcc for sm_90a;
3. the NMS kernel against its plain PyTorch version, on the card and on the
   CPU, over the serving shapes, edge cases and every regime of its launch
   plan (one slot; a cluster of two blocks a slot at batch 1 and 4; several
   slots a block at batch 32; a ragged last block; N = 512 with more than
   48 KB of shared memory a block): masks must be bit-identical;
4. the slice: ``ObjectDetector`` on SSD300-VGG16 (VOC, 21 classes, 8732
   priors, bf16 as the default config says, seeded random weights) serves
   ``predict`` x3 and ``predict_batch`` at batch 4 and 32, with the kernel's
   launch count reset before and read after; then its detections are held
   against the same ``loc`` / ``conf`` through the plain NMS, and a float32
   forward on the card (TF32 off) against the CPU forward;
5. times: ``ssds_tpu_torch.tools.nms_bench`` at the serving shapes
   ``[21, 200]`` and ``[672, 200]`` (every candidate valid, as in serving):
   the kernel's device time, the wrapper's with the host in it and its host
   microseconds a call, the plain version's time and the kernel's bound;
   batch-1 ``predict`` latency and batch-32
   ``predict_batch`` throughput;
6. the conv kernel (``conv3x3_rows`` in every configuration of ``TILES``, and
   ``vconv3``) against its plain version on the card and on the CPU at small
   shapes with partial strips in W, partial row chunks in H, partial output
   slices, Cin != Cout, Cin = 16 / Cout = 8 and more work items than blocks:
   within one bf16 ulp (rtol 2^-7, atol 1e-4);
7. the conv-prototype path, with the conv and stencil kernels' launch counts
   reset before and read after: ``ssds_tpu_torch.tools.conv_bench`` at
   ``[32, 300, 300, 64]`` (every tile held against the float32 plain version,
   then timed against cuDNN bf16 and the plain version in alternating turns)
   and ``ssds_tpu_torch.tools.conv_probes`` (the 17 stencil probes
   bit-identical to the plain version on the card and the CPU, the 2 dot
   probes within the conv tolerance, each timed against its plain version,
   and the stencil wrapper's host microseconds per call at bisect2's block);
8. the training path: SSD300-VGG16 (bf16, ``TRAIN.BATCH_SIZE`` 32) trained by
   ``Solver.train_model`` for 20 epochs (40 steps) over a synthetic VOC tree
   (``tools.synth_voc``: XML annotations on disk, 64 ``trainval`` and 32
   ``test`` images drawn in memory from ``--seed``, as the card's machine
   cannot decode JPEGs), with the eval of the last epoch at
   ``TEST.BATCH_SIZE`` 64 through ``detect`` and the NMS kernel (its launches
   reset before and read after); losses finite and falling, mAP in [0, 1],
   checkpoint and manifest written; a fresh ``Solver`` resumes at the last
   epoch with the saved weights and ``test_model`` gives a mAP; an
   ``ObjectDetector`` on the checkpoint gives the solver's detect rows; one
   float32 step on the card against the same step on the CPU
   (``tools.step_parity``); the batch-32 train step's time and the batch-64
   eval's img/s;
9. SSDLite-MobileNetV2-300 (``experiments/cfgs/ssd_lite_mobilenetv2_train_voc.yml``'s
   model, SGD and sgdr schedule; VOC, 21 classes, 3000 priors, 60
   BatchNorms, bf16, seeded random weights): ``Solver.train_model`` for 5
   epochs at batch 32 over the synthetic VOC with the eval of the last epoch
   (every loss finite, the running variance of every BatchNorm moved);
   resume (weights and running statistics equal), ``test_model``,
   ``ObjectDetector`` on the checkpoint equal to the solver's rows; then that
   detector serves ``predict`` x3 and ``predict_batch`` at 4 and 32 with the
   NMS kernel's launches reset before and read after, its detect rows
   identical with the plain NMS, and a float32 forward on the card against
   the CPU; one float32 step at batch 8, card against CPU, losses, updates
   and running statistics; the batch-32 train step, batch-1 ``predict`` p50 /
   p90 and batch-32 ``predict_batch`` img/s;
10. SSDLite-MobileNetV2-300 on COCO (``experiments/cfgs/ssd_lite_mobilenetv2_train_coco.yml``
   as written, ``config.ssd_lite_mobilenetv2_coco_config()``: 81 classes, 3000
   priors, bf16, batch 64, SGD 0.01, sgdr with its warm-up, ``PROB`` 0.6,
   ``MAX_GT`` 128, ``TEST.BATCH_SIZE`` 64) over a synthetic COCO tree
   (``tools.synth_coco``: JSON annotations on disk, 256 ``train2017`` and 64
   ``val2017`` images of 240-640 x 240-480 drawn in memory): the NMS kernel
   bit-identical to its plain version at ``[81, 200]`` and ``[5184, 200]``
   and timed there beside its bound; a train batch at ``PROB`` 0.6 differs
   from the same images at ``PROB -1`` and called the native crop sampler
   (``csrc/ssd_augment.cpp``); ``Solver.train_model`` for 3 epochs with the
   eval of the last through the port's COCOeval (losses finite, AP and AP50
   in [0, 1], 12 summary lines); resume (weights and running statistics
   equal), ``test_model``; ``ObjectDetector`` on the checkpoint: ``predict``
   on a 640x480 image equal to ``detect`` on the resized image, detect rows
   identical with kernel and plain NMS at batch 1 and 64, ``predict_batch``
   on 32 images of mixed sizes; the batch-64 train step, the train loader's
   img/s over an epoch with the native sampler and with the Python loop, the
   eval's img/s and COCOeval seconds, batch-1 ``predict`` p50 / p90 on the
   640x480 image and batch-32 ``predict_batch`` img/s on mixed sizes;
11. FSSD-VGG16-300 and RFBNet-VGG16-300, each as phase 9 drives SSDLite
   (``drive_model``): the yml's model at full width and depth
   (``config.fssd_vgg16_config()`` / ``rfb_vgg16_config()``: VOC, 21
   classes, 8732 priors, bf16), its SGD (LR 1e-3, momentum 0.9, decay 5e-4),
   its sgdr schedule with its 10 warm-up epochs and its ``TRAINABLE_SCOPE``
   (FSSD's names ``fusion``), at batch 32 over the synthetic VOC. Cut from
   the yml: 64 ``trainval`` and 32 ``test`` synthetic images for VOC07+12,
   3 epochs (``HEAD_EPOCHS``) for 300, ``PROB -1`` for 0.6 (as phase 8),
   ``TEST_SCOPE`` [3, 3] for [290, 300]. ``Solver.train_model`` with the eval
   of the last epoch (losses finite, every BatchNorm's running variance
   moved, mAP in [0, 1]); resume (weights and running statistics equal);
   ``test_model``; ``ObjectDetector`` on the checkpoint equal to the
   solver's rows; ``predict`` x3 and ``predict_batch`` at 4 and 32 with the
   NMS kernel's launches counted, detect rows identical with the kernel and
   the plain NMS at batch 1 and 32; for FSSD, its pyramid and predictors
   float32 in bf16 serving (weights and sources); a float32 forward, card
   against CPU; one float32 step at batch 4 (``HEAD_F32_BATCH``), card
   against CPU (``HEADS``' limits); the batch-32 train step, batch-1
   ``predict`` p50 / p90 and batch-32 ``predict_batch`` img/s;
12. YOLOv3-DarkNet53-416 and YOLOv2-DarkNet19-416, each as phase 11 drives
   its heads (``drive_model``): the yml's model at full width and depth
   (``config.yolo_v3_darknet53_config()`` / ``yolo_v2_darknet19_config()``:
   VOC, 20 classes and no background logit, the paper anchors, bf16), its
   batch (16 / 32), SGD and sgdr schedule, over the synthetic VOC drawn at
   416 px, cut as phase 11 (64 / 32 images, ``PROB -1``, ``TEST_SCOPE`` the
   last epoch) but for the epochs, 20 / 40 (80 steps each), and the 10
   warm-up epochs, kept at their step count over VOC07+12 (``YOLO_EPOCHS``
   says why). Checked besides: 10,647 / 845
   decoded boxes an image and 72 / 22 BatchNorms, the loss falling over the
   epochs, the eval, test and serving through ``detect_decoded`` with the
   NMS kernel (rows identical with the plain NMS); YOLOv2's reorg on the
   card in the JAX package's channel order (``pixel_unshuffle``'s is not), and
   its warm-up's seen images ``step * 32`` at every train step; the float32
   forward (the raw outputs of two test images) and one float32 step at
   batch 4, card against CPU (``YOLO``'s limits); the train step at the
   yml's batch,
   batch-1 ``predict`` p50 / p90 and batch-32 ``predict_batch`` img/s;
13. the rest of the zoo and the serving export (``check_zoo``):
   a. SSD300-ResNet50 (``experiments/cfgs/ssd_resnet50_train_voc.yml``'s model
   and recipe, ``config.ssd_resnet50_config()``: 8732 priors, 53
   BatchNorms, bf16, batch 32) and b. SSD512-VGG16
   (``ssd_vgg16_train_voc_512.yml``, ``config.ssd512_vgg16_config()``: maps
   64/32/16/8/4/2/1, 24,564 priors, batch 16, images drawn at 512 px), each
   through ``drive_model`` cut as phase 11 (64 / 32 images, 3 epochs,
   ``PROB -1``, ``TEST_SCOPE`` the last epoch): losses finite and falling,
   every BatchNorm's running variance moved, resume equal, rows identical
   with the kernel and the plain NMS, the float32 forward and one float32
   step (batch 4 / 2) card against CPU within phase 11's limits, the train
   step, batch-1 ``predict`` p50 / p90 and batch-32 ``predict_batch`` img/s;
   c. the export (``check_export``): the registered operator
   ``ssds_tpu_torch::nms_mask`` bit-identical to the plain version at
   ``[21 / 672 / 1344, 200]``; SSD300-VGG16 (default config, bf16, seeded
   weights) exported with ``ssds_tpu_torch.export`` (symbolic batch) on the
   card and served by a fresh process that imports torch, the operator's
   registration and no model module (``EXPORT_SERVER``) at batches 1, 3 and
   32, the NMS kernel launched once inside the program at each, its rows
   identical to the in-process detector's unpruned rows (a symbolic batch
   takes no prune); the program's batch-1 p50 and batch-32 img/s beside the
   in-process predict function's, ``predict``'s and ``predict_batch``'s. The
   artifact is exported for ``("cuda", "cpu")``: a fresh process moves it to
   the CPU (``load_exported(dir, device="cpu")``) and its rows at batches 1
   and 2 are identical to an in-process CPU ``ObjectDetector``'s on the same
   weights; ``load_exported_sharded`` over every card (two programs on card 0
   when there is one) gives at batch 32 one program's rows on the same pieces,
   the NMS kernel launched once a piece (one program's rows on the whole batch
   against the pieces' are logged: cuDNN may take other algorithms at batch
   16 than at 32).

14. int8 serving of SSD300-VGG16 (``check_int8``): the default config with
   ``MODEL.QUANT: int8`` (35 int8 convs, calibrated on JAX's four seeded
   random images): ``int8_conv`` and ``quantize_act`` (``csrc/int8_conv.cu``)
   bit-identical to their plain versions at every quantised conv's shape and
   a 3x3 stride-2 and a 1x1 conv of MobileNetV2 and DarkNet-53, at batches 1
   and 32 (``tools.int8_bench``), and timed beside their bounds, the plain
   versions, cuDNN's bf16 conv and ``torch._int_mm`` (the same s8 x s8 -> s32
   GEMM in cuBLASLt, whose accumulators are held equal too);
   ``predict`` x3 and ``predict_batch`` x32
   with the kernels' launches reset before and read after (35 each a
   forward); the float32 int8 forward on the card against the CPU on the same
   quantised state within 1e-2 of the largest output; the int8 and the float
   mAP on phase 8's checkpoint and test set (int8 no more than 0.05 below);
   batch-1 p50 / p90 and batch-32 img/s, int8 beside bf16; the exported int8
   program served by a fresh process (``EXPORT_SERVER``) at batches 1, 3 and
   32, the int8 kernels launched inside it, its rows identical to the
   in-process rows;
15. SSDLite-MobileNetV2-300 on the synthetic COCO at ``PROB 0.6`` with
   ``DATASET.DEVICE_AUG`` (``check_device_aug``), cut as phase 10 without the
   eval: the train loader resizes only (its img/s beside phase 10's native
   sampler); ``Solver.train_model`` for 3 epochs, an augmentation a step on
   the card (losses finite and falling); a resume at epoch 2 restores the
   saved state and draws the last epoch's augmentations bit for bit; the
   train step with and without the augmentation, and ``augment_batch``
   alone (device ms); box survival, centre spread and pixel mean and std of
   128 train images augmented on the card against the host recipe's on the
   same images, within ``tests/test_augment_drift.py``'s bounds;
16. data-parallel SSDLite-MobileNetV2-300 (``check_ddp``; phase 9's model at
   full width, the synthetic VOC), its ranks launched by
   ``torch.distributed.run``: with two or more cards one rank a card on NCCL;
   with one, 16a on one NCCL rank and 16b-c on two gloo ranks sharing card 0
   (NCCL refuses two ranks on one card). a. The port's train CLI
   (``python -m ssds_tpu_torch.tools.synth_voc ... train --cfg <json>``: the
   train CLI with the images drawn in memory) for one epoch, while 16b's
   ranks run: rc 0 and one manifest line. b. One float64 step (cuDNN
   float64) at global batch 8, ranks against one rank on the same card
   (``tests/torch_port_ddp_worker.py``):
   losses within rtol 1e-6, every update within 1e-5 of the largest, every
   running statistic within 1e-9, the ranks' states equal. c. The bf16
   recipe (batch 32 global, SGD, sgdr with warm-up) for 1 epoch with the
   eval of the last merged over the ranks (``--lifecycle``): every loss
   finite, every rank the same eval and test mAP, a manifest line an epoch,
   every BatchNorm's running variance moved and equal on every rank; a
   1-process ``Solver.test_model`` on the checkpoint within 1e-3 of the
   merged mAP; the train step and ``test_model``'s img/s on the ranks and on
   one process;
17. observability on SSD300-VGG16 (``check_observability``):
   ``utils.profiler.trace`` around 3 train steps, each under
   ``annotate("train_step")``, and around a ``predict_batch`` of 32: the
   Chrome traces hold the spans and the card's kernels, the NMS kernel's
   among them; ``profiler.timed`` within 10 % of CUDA events over 5 train
   steps; ``Solver.visualize_epoch`` through a recording writer: the prior
   images (one a level), 8 samples, each level's feature-map grid and
   heatmap, and one gradient histogram a parameter;
18. the spatial axis (``check_spatial``; ``TPU.MESH.SPATIAL: 2``, each of 2
   ranks a band of 150 image rows; two gloo ranks on card 0, or one NCCL
   rank a card where there are two or more): a. one float64 step (cuDNN
   float64) of SSD300-VGG16 (seeded weights, 8732 priors, batch 2) and of
   SSDLite-MobileNetV2-300 (its 60 BatchNorms over the bands, batch 4), the
   ranks against one rank on the same card (``tests/torch_port_ddp_worker.py``):
   losses within rtol 1e-6, every update within 1e-5 of the largest, every
   running statistic within 1e-9, the ranks' states equal; b. the bf16
   SSD300-VGG16 recipe (batch 32) through ``Solver.train_model`` for one
   epoch on the 2 ranks (``--lifecycle``): losses finite, the state moved
   (the first conv's weight among it) and equal on the ranks, one manifest
   line, the same test mAP
   on both ranks, the halo and gather transfers of a step; a 1-process
   ``ObjectDetector`` serves the checkpoint with rank 0's weights; c. one
   process on the same recipe: the train step's time and
   ``torch.cuda.max_memory_allocated`` with and without ``TPU.REMAT``, beside
   the ranks' step (read with phase 16's caveat: gloo ranks time-share one
   card and stage every transfer through the host);
19. the spatial axis for the families whose heads mix rows with a layer that
   is neither a conv nor a pool (``check_spatial_heads``; 1 x 2, laid out as
   phase 18): a. one float64 step (cuDNN float64, batch 2, seeded weights)
   of FSSD-VGG16-300 (the fusion's two resizes, 8732 priors),
   YOLOv3-DarkNet53-416 (its two upsamples, 10,647 boxes) and
   YOLOv2-DarkNet19-416 (its reorg, whose 26-row input splits 13 / 13, 845
   boxes), the ranks against one rank on the same card within phase 18's
   bounds, the ranks' states equal (a digest of each), rank 0's halo and
   gather transfers; b. YOLOv3-DarkNet53-416's bf16 recipe (batch 16, cut as
   phase 12) through ``Solver.train_model`` for one epoch on the 2 ranks
   (``--lifecycle``): losses finite, the state moved and equal on the ranks,
   the same test mAP on both; a 1-process ``ObjectDetector`` serves the
   checkpoint through ``detect_decoded`` with the NMS kernel's launches
   reset before and read after, its detect rows identical with the plain
   NMS; c. one process on the same recipe: the train step's time beside the
   ranks' and the gradients' all-reduce alone (phase 18's caveat);
20. the mAP-parity harness (``check_parity``; ``ssds_tpu_torch.tools.parity_check``)
   and the export CLI's ``--check``: a. stage 1, the import audit, of phase
   8's checkpoint against SSD300-VGG16 (its config written as JSON): healthy,
   the four groups' counts printed; b. stage 3 on phase 8's synthetic VOC
   test set: the mAP within ``MAP_TOLERANCE`` (0.001) of phase 8's resumed
   ``test_model`` mAP, the NMS kernel's launches reset before and read
   after; in fresh processes started together with phase 16 (16a-b time
   nothing; they end before 16c): c. ``--selftest`` on
   SSD300-VGG16 at full width on the card (rc 0, ``selftest OK``, the NMS
   kernel's launches), d. ``--when-data --table-only`` with PyYAML hidden:
   the six acceptance rows built at full width from the port's written-out
   configs, e. ``python -m ssds_tpu_torch.export --check`` of SSD300-VGG16
   on the card (rc 0, ``check ok``).

Before the last lines come ``{"training": {...}}``, ``{"lite": {...}}``,
``{"coco": {...}}``, ``{"heads": {"fssd": {...}, "rfb": {...}}}``,
``{"yolo": {"yolo_v3": {...}, "yolo_v2": {...}}}``, ``{"zoo": {"resnet50":
{...}, "ssd512": {...}}}`` and ``{"export": {...}}``, ``{"int8": {...}}``,
``{"device_aug": {...}}``, ``{"ddp": {...}}``, ``{"observability":
{...}, "export_moved_sharded": {...}}``, ``{"spatial": {...}}`` and
``{"spatial_heads": {...}}``, ``{"parity": {...}}``, then ``{"kernels": [...]}`` (the NMS entry's
``launches`` counts phases 4, 9, 10, 11, 12, 13's, 17's and 19's serving,
``launches_by_path`` every path, phase 16's ranks' eval, phase 18's and
19's ranks' test and phase 20's stage 3 and self-test too; ``int8_conv`` and
``quantize_act`` count phase 14's serving, their times summed over its shapes
at batch 32), the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX. In the kernels
line, the NMS entry's ``ms`` is device time alone (launches queued behind a
sleep kernel: at a few µs a launch, back-to-back calls time the host); its
``wrapper_ms`` is back-to-back calls, as the conv and stencil ``ms`` are.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import copy
import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"
# M = 21 x batch; and the launch plan's regimes: one slot, a ragged last
# block, N = 512 in a cluster (42 KB a block) and two slots a block (84 KB)
NMS_SHAPES = [(21, 200), (84, 200), (672, 200), (1, 200), (673, 200), (5, 1), (3, 37),
              (9, 512), (300, 512), (1344, 200)]  # the last: training's eval at batch 64
NMS_SETS = ["random", "dense_overlap", "tied_scores", "full"]
THRESHOLDS = (0.45, 0.6)
SSD300_PRIORS = 8732
# float32 forward, card (cuDNN, TF32 off) against CPU: the same sums in other
# orders through the 15 VGG convs, the extras and the heads. Measured on an
# NVIDIA H100 80GB HBM3: 1.3e-5 on loc (max |loc| 4.5) and 5.1e-6 on conf.
F32_RTOL, F32_ATOL = 1e-4, 1e-4
# phase 8: a float32 train step at batch 2, card (TF32 off) against CPU
# (tools.step_parity; the readings under each change that follow are
# tests/torch_port_step_causes.py's). The losses: rtol 1e-4, as the forward
# (measured 7.5e-8).
# Each parameter's update (the LR times the momentum buffer, i.e. gradient plus
# decay, read before it is rounded into the weights): within 5e-3 of the CPU
# update's norm. Measured on an NVIDIA H100 80GB HBM3 (700 W): 2.81e-3 at most
# (conv5_1, base.24), 1.27e-4 in the median tensor, unchanged with the CPU's
# hard-negative ranks fed to the card and with cudnn.deterministic; with cuDNN
# off (PyTorch's own im2col and GEMM kernels) 3.5e-4 and 9.5e-7, next to the
# CPU's own float32 step against float64 (9.7e-5 and 4.5e-7). The cause is
# cuDNN's float32 convolution algorithms, whose sums differ most from the CPU's
# in the backward; with benchmark off they are fixed for these shapes, so the
# bound is the measured gap with a margin.
STEP_RTOL, UPDATE_RTOL = 1e-4, 5e-3
TRAIN_EPOCHS, TRAIN_IMAGES, TEST_IMAGES = 20, 64, 32
# phase 9: SSDLite-MobileNetV2-300
LITE_PRIORS, LITE_BATCHNORMS, LITE_EPOCHS, LITE_F32_BATCH = 3000, 60, 5, 8
# Its float32 step at batch 8, card against CPU. Losses: STEP_RTOL (measured
# 9.3e-7). Updates as the largest error over the model's largest update (a BN
# bias that feeds another BN has a zero gradient up to rounding, so its own
# norm is no scale): within 3e-2; measured 1.03e-2 (the stem conv), 8.6e-3 with
# cuDNN off, and the CPU's own float32 step lies 6.6e-3 from its float64 step:
# float32 rounding through ~60 train-mode BatchNorms, each dividing by the
# spread of 8 values at the 1x1 maps. Running statistics (a mean in units of
# its channel's standard deviation, a variance relative to itself): within
# 5e-4; measured 4.6e-5, the CPU's float32 2.4e-5 from its float64
# (tests/torch_port_step_causes.py --model lite --batch 8).
LITE_UPDATE_TOL, LITE_STATS_RTOL = 3e-2, 5e-4
# phase 10: SSDLite-MobileNetV2-300 on COCO (81 classes); the NMS kernel at
# serving's [81, 200] and the eval's [64 x 81, 200]
# (the val images were 128: 64 halve the two COCOevals over an untrained
# model's ~8,000 detections an image, which keeps the script inside 800 s)
COCO_EPOCHS, COCO_TRAIN_IMAGES, COCO_VAL_IMAGES = 3, 256, 64
COCO_NMS_SHAPES = [(81, 200), (5184, 200)]
# phase 11: FSSD-VGG16-300 and RFBNet-VGG16-300 (8732 priors each): epochs,
# the float32 step's batch, and for each head its BatchNorm count (FSSD: the
# fusion BN and 6 pyramid blocks; RFB: BasicRFB_a's 14 and 11 in each of 3
# BasicRFB) and its float32 step's limits, card (TF32 off) against CPU, as
# phase 9's measures: the losses STEP_RTOL; the largest update error over the
# model's largest update, 2e-2; a running mean's error in units of its
# channel's standard deviation, a variance's relative to itself, 5e-5.
# Measured on an NVIDIA H100 80GB HBM3 (700 W): losses 2.1e-7 / 5.3e-7 (FSSD
# / RFB), updates 5.6e-3 / 2.8e-3 (base.2, a VGG16 conv, in both: cuDNN's
# float32 algorithms, as phase 8's base.24), statistics 2.1e-6 / 1.3e-6.
HEAD_EPOCHS, HEAD_F32_BATCH = 3, 4
HEADS = {"fssd": (7, 2e-2, 5e-5), "rfb": (47, 2e-2, 5e-5)}
# phase 12: YOLOv3-DarkNet53-416 and YOLOv2-DarkNet19-416, each with its
# decoded boxes an image (3 x (52^2 + 26^2 + 13^2) and 5 x 13^2), its
# BatchNorms (DarkNet-53's 52 and the head's 20; DarkNet-19's 18 and the
# head's 4) and its float32 step's limits, card (TF32 off) against CPU at
# HEAD_F32_BATCH: phase 11's.
YOLO = {"yolo_v3": (10647, 72, 2e-2, 5e-5), "yolo_v2": (845, 22, 2e-2, 5e-5)}
# Epochs: 80 steps each over TRAIN_IMAGES (batch 16 / 32). With the ymls' 10
# warm-up epochs counted over the 64 images, the LR reaches 1e-3 by step 40
# and YOLOv3 diverges (NaN by epoch 10, NVIDIA H100 80GB HBM3); so the
# warm-up keeps its step count over VOC07+12's 16,551 trainval images, and
# these steps run at the LR of the full run's first steps. Fewer than ~50
# steps leave the running statistics short of the batch statistics (0.9^n
# of the init's), which DarkNet-53's 72 BatchNorms compound into an
# eval-mode network whose raw outputs reach 1e9 (12 steps).
YOLO_EPOCHS = {"yolo_v3": 20, "yolo_v2": 40}
VOC0712_TRAINVAL = 16551
# phase 13: SSD300-ResNet50 and SSD512-VGG16, each with its priors, its
# BatchNorms (ResNet-50's 53; none in VGG16) and its float32 step's batch
# (SSD512's at 2, as phase 8's SSD300-VGG16: a 512 px VGG16 step on the CPU
# is most of the phase), the limits phase 11's; then the export of
# SSD300-VGG16, served at EXPORT_BATCHES by a fresh process
ZOO = {"resnet50": (SSD300_PRIORS, 53, HEAD_F32_BATCH), "ssd512": (24564, 0, 2)}
ZOO_UPDATE_TOL, ZOO_STATS_RTOL = 2e-2, 5e-5
EXPORT_BATCHES = (1, 3, 32)
# ... exported for both device types; the CPU serves the moved program at
# these batches (a bf16 SSD300 forward on the host's cores takes seconds)
EXPORT_PLATFORMS, EXPORT_CPU_BATCHES = ("cuda", "cpu"), (1, 2)
EXPORT_NMS_SHAPES = [(21, 200), (672, 200), (1344, 200)]
# phase 14: int8 SSD300-VGG16 (VGG16's 15 convs, the 8 extras, 6 loc + 6 conf);
# the kernels checked at batches 1 and 32; the float32 int8 forward card
# against CPU on the same quantised state within 1e-2 of the largest output
# (float32 rounding ahead of a quantize_act can move a value across a
# rounding boundary); the int8 mAP no more than 0.05 below the float mAP
INT8_CONVS, INT8_BATCHES, INT8_F32_TOL, MAP_DROP = 35, (1, 32), 1e-2, 0.05
# phase 15: the train images of the device augmentation's statistics
AUG_STAT_IMAGES = 128
# phase 16: the epochs of the data-parallel recipe; the float64 step's global
# batch and bounds, 2 ranks against 1 (losses rtol, the largest update error
# over the largest update, a running statistic's error as
# tests/torch_port_ddp_worker.py::running_stats_err measures it); the merged
# mAP against one process's
# (the epochs were 3: 1 keeps the whole script, with phase 20, inside 800 s)
DDP_EPOCHS, DDP_F64_BATCH, DDP_F64_LIMITS, DDP_MAP_TOL = 1, 8, (1e-6, 1e-5, 1e-9), 1e-3
# phase 17: profiler.timed against CUDA events
TIMED_RTOL = 0.1
# phase 18: the spatial axis (1 x 2); the float64 steps' batches (SSD300-VGG16,
# and SSDLite-MobileNetV2-300 for BatchNorm statistics over bands) and bounds,
# 2 ranks against 1 (as phase 16's); the bf16 recipe's epochs
SPATIAL_F64_BATCH, SPATIAL_LITE_F64_BATCH, SPATIAL_F64_LIMITS = 2, 4, (1e-6, 1e-5, 1e-9)
SPATIAL_EPOCHS = 1
# phase 19: the spatial axis for the families whose heads resize or reorg
# (1 x 2): each model's float64 step at this batch, phase 18's bounds; then
# YOLOv3-DarkNet53-416's bf16 recipe for SPATIAL_EPOCHS
SPATIAL_HEADS = {"fssd": "FSSD-VGG16-300", "yolo_v3": "YOLOv3-DarkNet53-416",
                 "yolo_v2": "YOLOv2-DarkNet19-416"}
SPATIAL_HEADS_F64_BATCH = 2
# phase 20: the parity harness's fresh processes (run at once) and their limit
PARITY_TIMEOUT = 300
# a run still going after this many seconds prints every thread's stack and
# exits non-zero, inside the 1200 s the script is given
WATCHDOG_S = 1150


# (B, H, W, Cin, Cout) for phase 6: partial strips in W and partial row chunks
# in H, Cin != Cout with a partial 64-channel output slice, two output slices,
# the narrowest channels the kernel takes, and more work items than blocks
CONV_SHAPES = [(2, 37, 45, 64, 64), (1, 19, 70, 32, 48), (1, 20, 40, 64, 128),
               (3, 31, 161, 16, 8), (12, 95, 310, 64, 64)]
VCONV_SHAPES = [(2, 39, 45, 64, 64), (1, 12, 20, 32, 48)]  # (B, H+2, W, C, Cout)


def log(*args):
    print(*args, flush=True)


def check_nms_kernel(nms_mask, nms_mask_torch, seed, shapes=NMS_SHAPES):
    """Phase 3: kernel == plain on CUDA == plain on CPU, bit for bit."""
    from ssds_tpu_torch.tools.nms_bench import nms_case

    cases, max_err = 0, 0.0
    for m, n in shapes:
        for kind in NMS_SETS:
            boxes, scores = nms_case(np.random.default_rng([seed, m, n, len(kind)]), m, n, kind)
            bc, sc = boxes.to(DEVICE), scores.to(DEVICE)
            for thr in THRESHOLDS:
                got = nms_mask(bc, sc, thr)
                torch.cuda.synchronize()
                plain_gpu = nms_mask_torch(bc, sc, thr).cpu()
                plain_cpu = nms_mask_torch(boxes, scores, thr)
                got = got.cpu()
                err = max((got.float() - plain_gpu.float()).abs().max().item(),
                          (got.float() - plain_cpu.float()).abs().max().item())
                max_err = max(max_err, err)
                if not (torch.equal(got, plain_gpu) and torch.equal(got, plain_cpu)):
                    bad = (got != plain_cpu).nonzero()[:5].tolist()
                    raise AssertionError(f"nms kernel != plain at [{m},{n}] {kind} thr={thr}: "
                                         f"first differing (slot, cand) {bad}")
                cases += 1
    log(f"nms kernel: {cases} cases bit-identical to the plain version on CUDA and CPU "
        f"(shapes {shapes}, sets {NMS_SETS}, thresholds {THRESHOLDS}; zero-area boxes in "
        "every set, invalid tails and an all-invalid row in every set but 'full')")
    return max_err


def check_conv_kernel(seed):
    """Phase 6: conv kernel within one bf16 ulp of the plain version on CUDA and CPU."""
    from ssds_tpu_torch.ops.conv import ATOL, RTOL, conv3x3_rows_torch, vconv3_torch
    from ssds_tpu_torch.ops.cuda.conv import TILES, conv3x3_rows, vconv3

    def bf16(rng, shape, scale=1.0):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(torch.bfloat16)

    def within(got, plain, what):
        err = max((got.float() - p.float()).abs().max().item() for p in plain)
        for p in plain:
            torch.testing.assert_close(got.float(), p.float(), rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{what}: {m}")
        return err

    max_err, cases = 0.0, 0
    for b, h, w, cin, cout in CONV_SHAPES:
        rng = np.random.default_rng([seed, h, w, cin, cout])
        x, wt = bf16(rng, (b, h, w, cin)), bf16(rng, (3, 3, cin, cout), 0.05)
        xc, wc = x.to(DEVICE), wt.to(DEVICE)
        plain = (conv3x3_rows_torch(xc, wc).cpu(), conv3x3_rows_torch(x, wt))
        for tile in TILES:
            got = conv3x3_rows(xc, wc, tile).cpu()
            max_err = max(max_err, within(got, plain, f"conv3x3_rows {[b, h, w, cin, cout]} "
                                                      f"tile {tile}"))
            cases += 1
    for b, h2, w, c, cout in VCONV_SHAPES:
        rng = np.random.default_rng([seed, h2, w, c, cout])
        xp, wd0 = bf16(rng, (b, h2, w, c)), bf16(rng, (3 * c, cout), 0.05)
        got = vconv3(xp.to(DEVICE), wd0.to(DEVICE)).cpu()
        plain = (vconv3_torch(xp.to(DEVICE), wd0.to(DEVICE)).cpu(), vconv3_torch(xp, wd0))
        max_err = max(max_err, within(got, plain, f"vconv3 {[b, h2, w, c, cout]}"))
        cases += 1
    log(f"conv kernel: {cases} cases within one bf16 ulp (rtol 2^-7, atol 1e-4) of the plain "
        f"version on CUDA and CPU, max |d| {max_err:.3e} (conv3x3_rows {CONV_SHAPES} x tiles "
        f"{list(TILES)}; vconv3 {VCONV_SHAPES})")
    return max_err


class ScalarWriter:
    """The summary writer the Solver is given: it keeps every scalar, and
    the tag, step, shape and dtype of every image and histogram."""

    def __init__(self):
        self.scalars = {}
        self.images, self.histograms = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, float(value)))

    def add_image(self, tag, img, step):
        self.images.append((tag, step, tuple(np.shape(img)), str(np.asarray(img).dtype)))

    def add_histogram(self, tag, values, step):
        self.histograms.append((tag, step, tuple(np.shape(values))))


def training_config(root, exp):
    """The default SSD300-VGG16 config (bf16, batch 32, SGD) over the
    synthetic VOC tree: no augmentation (it needs cv2), no warm-up, the eval
    in the last epoch, checkpoints every 10 epochs."""
    from ssds_tpu_torch.config import default_config

    cfg = default_config()
    cfg.DATASET.update(DATASET_DIR=root, TRAIN_SETS=[["2007", "trainval"]],
                       TEST_SETS=[["2007", "test"]], PROB=-1, NUM_WORKERS=4)
    cfg.TRAIN.update(MAX_EPOCHS=TRAIN_EPOCHS, CHECKPOINTS_EPOCHS=10)
    cfg.TRAIN.LR_SCHEDULER.WARM_UP_EPOCHS = 0
    cfg.TEST.TEST_SCOPE = [TRAIN_EPOCHS, TRAIN_EPOCHS]
    cfg.PHASE = ["train", "eval"]
    cfg.EXP_DIR, cfg.LOG_DIR = exp, os.path.join(exp, "logs")
    return cfg


def check_training(seed, dev, card, log, keep_dir=None):
    """Phase 8: the training path, end to end; returns the numbers. With
    ``keep_dir``, the last checkpoint is copied there (``out["checkpoint"]``)
    for phase 14."""
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.data.factory import detection_collate
    from ssds_tpu_torch.detector import ObjectDetector
    from ssds_tpu_torch.ops.cuda.nms import nms_mask
    from ssds_tpu_torch.solver import Solver
    from ssds_tpu_torch.tools import step_parity
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc, write_voc

    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.dict(factory.dataset_map, {"voc": in_memory_voc(seed)}):
        root, exp = os.path.join(tmp, "VOCdevkit"), os.path.join(tmp, "exp")
        write_voc(root, seed, TRAIN_IMAGES, TEST_IMAGES)
        cfg = training_config(root, exp)
        writer = ScalarWriter()
        solver = Solver(cfg, device=dev, writer=writer, seed=seed)
        resumed = None
        try:
            # -- train, with the eval of the last epoch
            nms_mask.launches = 0
            t0 = time.perf_counter()
            solver.train_model()
            torch.cuda.synchronize()
            out["train_model_s"] = time.perf_counter() - t0
            out["nms_launches_eval"] = nms_mask.launches
            epoch_loss = [l + c for (_, l), (_, c) in zip(writer.scalars["loss_loc"],
                                                          writer.scalars["loss_conf"])]
            out["epoch_loss"] = epoch_loss
            out["steps"] = solver.step
            out["eval_map"] = writer.scalars["Eval/mAP"][-1][1]
            out["eval_loss"] = writer.scalars["Eval/loss_loc"][-1][1] + \
                writer.scalars["Eval/loss_conf"][-1][1]
            log(f"trained SSD300-VGG16 bf16 batch 32: {len(epoch_loss)} epochs, {solver.step} "
                f"steps in {out['train_model_s']:.1f} s; epoch mean loss first {epoch_loss[0]:.4f} "
                f"last {epoch_loss[-1]:.4f}; eval mAP {out['eval_map']:.4f}, loss "
                f"{out['eval_loss']:.4f}; nms kernel launches {nms_mask.launches}")
            if not all(np.isfinite(v) for vals in writer.scalars.values() for _, v in vals):
                raise AssertionError(f"a loss is not finite: {writer.scalars}")
            if not (len(epoch_loss) == TRAIN_EPOCHS and epoch_loss[-1] < epoch_loss[0]):
                raise AssertionError(f"the loss did not fall: {epoch_loss}")
            if not 0.0 <= out["eval_map"] <= 1.0:
                raise AssertionError(f"eval mAP {out['eval_map']} outside [0, 1]")
            if out["nms_launches_eval"] <= 0:
                raise AssertionError("the eval never launched the NMS kernel")
            ckpt = os.path.join(exp, f"{cfg.CHECKPOINTS_PREFIX}_epoch_{TRAIN_EPOCHS}.pth")
            with open(os.path.join(exp, "checkpoint_list.txt")) as f:
                manifest = f.read().splitlines()
            if not os.path.exists(ckpt) or manifest[-1] != f"epoch {TRAIN_EPOCHS}:" \
                    f"{os.path.basename(ckpt)}":
                raise AssertionError(f"checkpoint or manifest line missing: {manifest}")
            log(f"checkpoint {os.path.basename(ckpt)} ({os.path.getsize(ckpt) / 1e6:.1f} MB), "
                f"manifest {manifest}")
            if keep_dir:
                out["checkpoint"] = shutil.copy(ckpt, keep_dir)

            # -- resume, test, deploy
            t_resume = time.perf_counter()
            resumed = Solver(cfg, device=dev, writer=ScalarWriter(), seed=seed + 1)
            resumed.train_model()  # auto-resume at the last epoch: no epoch left
            want = solver.model.state_dict()
            same = all(torch.equal(v, want[k]) for k, v in resumed.model.state_dict().items())
            if resumed.start_epoch != TRAIN_EPOCHS or not same:
                raise AssertionError(f"resume: epoch {resumed.start_epoch}, weights equal {same}")
            nms_mask.launches = 0
            out["test_map"] = resumed.test_model()
            torch.cuda.synchronize()
            out["nms_launches_test"] = nms_mask.launches
            if not (0.0 <= out["test_map"] <= 1.0 and out["nms_launches_test"] > 0):
                raise AssertionError(f"test_model: mAP {out['test_map']}, "
                                     f"{out['nms_launches_test']} nms launches")
            dcfg = copy.deepcopy(cfg)
            dcfg.RESUME_CHECKPOINT = ckpt
            det = ObjectDetector(dcfg, device=dev)
            test_set = resumed.get_loader("test").dataset
            imgs = np.stack([test_set.pull_image(i) for i in range(4)])
            with torch.no_grad():
                rows = det.detect_rows(imgs)
                want_rows = resumed.make_eval_forward()(torch.from_numpy(imgs).to(dev))
            if not torch.equal(rows, want_rows):
                raise AssertionError("ObjectDetector on the checkpoint != the solver's eval rows: "
                                     f"max |d| {(rows - want_rows).abs().max().item():.3e}")
            log(f"resumed at epoch {resumed.start_epoch} with the saved weights; test_model mAP "
                f"{out['test_map']:.4f} ({out['nms_launches_test']} nms launches); "
                f"ObjectDetector on {os.path.basename(ckpt)}: detect rows of 4 test images "
                "identical to the solver's eval forward")
            del det

            # -- times: the batch-32 train step (upload included) and the batch-64 eval
            out["resume_test_deploy_s"] = time.perf_counter() - t_resume
            out["train_step_ms"] = train_step_ms(solver)
            out["train_img_s"] = 32 / out["train_step_ms"] * 1e3
            ebatch = solver._upload(next(iter(solver.get_loader("eval"))))
            eval_step = solver.make_eval_step()
            solver.model.eval()
            for _ in range(2):
                eval_step(ebatch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                eval_step(ebatch)
            torch.cuda.synchronize()
            out["eval_img_s"] = 10 * 64 / (time.perf_counter() - t0)
            log(f"train step SSD300-VGG16 bf16 batch 32 (20 steps after 3 warm-up, upload "
                f"included): {out['train_step_ms']:.3f} ms, {out['train_img_s']:.1f} img/s; eval "
                f"(forward, loss, detect) at batch 64: {out['eval_img_s']:.1f} img/s ({card})")
        finally:
            solver.close()
            if resumed is not None:
                resumed.close()

        # -- one float32 step, card against CPU
        t0 = time.perf_counter()
        dataset = factory.load_data(cfg.DATASET, "train", cfg.MODEL.IMAGE_SIZE).dataset
        f32 = step_parity.compare(
            cfg, dev, detection_collate([dataset[0], dataset[1]], int(cfg.DATASET.MAX_GT)), seed)
        out["f32_step_s"] = time.perf_counter() - t0
    f32.update(loss_rtol=STEP_RTOL, update_rtol=UPDATE_RTOL)
    out["f32_step"] = f32
    log_f32_step("SSD300-VGG16 batch 2", f32, log)
    log(f"seconds: train_model {out['train_model_s']:.1f}, resume/test/deploy "
        f"{out['resume_test_deploy_s']:.1f}, float32 step card and CPU {out['f32_step_s']:.1f}")
    if max(f32["loss_rel_err"].values()) > STEP_RTOL or f32["update_rel_err_max"] > UPDATE_RTOL:
        raise AssertionError(f"float32 step card vs CPU outside rtol {STEP_RTOL} / "
                             f"{UPDATE_RTOL}: {f32}")
    return out


def log_f32_step(what, r, log):
    mg, mc, err = r["card"], r["cpu"], r["loss_rel_err"]
    stats = (f"; running statistics max {r['stats_rel_err_max']:.2e} ({r['stats_rel_err_worst']})"
             f", median {r['stats_rel_err_median']:.2e} (a mean in units of its std, a variance "
             "relative to itself)"
             if "stats_rel_err_max" in r else "")
    log(f"float32 train step {what}, card (TF32 off) vs CPU: loss_l {mg['loss_l']:.6f} / "
        f"{mc['loss_l']:.6f}, loss_c {mg['loss_c']:.6f} / {mc['loss_c']:.6f} (rel "
        f"{err['loss_l']:.2e} / {err['loss_c']:.2e}); update norm-relative error max "
        f"{r['update_rel_err_max']:.2e} ({r['update_rel_err_worst']}), median "
        f"{r['update_rel_err_median']:.2e}; largest update error over the largest update "
        f"{r['update_err_over_max_update']:.2e} ({r['update_err_worst']}){stats}")


def lite_config(root, exp):
    """SSDLite-MobileNetV2-300 (``experiments/cfgs/ssd_lite_mobilenetv2_train_voc.yml``'s
    model, optimizer and sgdr schedule with its 5 warm-up epochs; bf16, batch
    32) over the synthetic VOC tree, for ``LITE_EPOCHS`` epochs with the eval
    in the last."""
    from ssds_tpu_torch.config import ssd_lite_mobilenetv2_config

    lite = ssd_lite_mobilenetv2_config()
    cfg = training_config(root, exp)
    cfg.MODEL.update(lite.MODEL)
    cfg.TRAIN.OPTIMIZER.update(lite.TRAIN.OPTIMIZER)
    cfg.TRAIN.update(MAX_EPOCHS=LITE_EPOCHS, CHECKPOINTS_EPOCHS=LITE_EPOCHS)
    cfg.TRAIN.LR_SCHEDULER.update(SCHEDULER="sgdr", WARM_UP_EPOCHS=LITE_EPOCHS)
    cfg.TEST.TEST_SCOPE = [LITE_EPOCHS, LITE_EPOCHS]
    cfg.CHECKPOINTS_PREFIX = "ssd_lite_mobilenetv2_voc"
    return cfg


def serve_times(det, img, batch32):
    """Batch-1 ``predict`` latencies (50 after 10) and batch-32 ``predict_batch``
    img/s (10 batches after 2)."""
    for _ in range(10):
        det.predict(img, threshold=0.01)
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        det.predict(img, threshold=0.01)  # synchronises before its device-to-host copy
        lat.append(time.perf_counter() - t0)
    for _ in range(2):
        det.predict_batch(batch32, threshold=0.01)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        det.predict_batch(batch32, threshold=0.01)
    torch.cuda.synchronize()
    return lat, 10 * 32 / (time.perf_counter() - t0)


def train_step_ms(solver):
    """The train step at the loader's batch (upload included), 20 steps after 3, synchronised."""
    host = next(iter(solver.get_loader("train")))
    step = solver._train_step
    for _ in range(3):
        step(solver._upload(host), solver.step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step(solver._upload(host), solver.step)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 20 * 1e3


def drive_model(what, make_cfg, seed, dev, card, log, *, num_boxes, batchnorms, f32_batch,
                update_tol, stats_rtol, loss_falls=False):
    """Train, resume, deploy, serve and time one model over the synthetic VOC
    (phases 9, 11, 12 and 13), its images drawn at the model's input size;
    ``make_cfg(root, exp)`` gives its config. Checks the box count (the
    priors, or a YOLO head's decoded boxes an image) and the BatchNorm count,
    with ``loss_falls`` that the last epoch's mean loss is below the first's,
    and, for a head with ``FLOAT32_MODULES`` (FSSD), that bf16 serving keeps
    their weights and the pyramid sources in float32. Returns the numbers."""
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.data.factory import detection_collate
    from ssds_tpu_torch.detector import ObjectDetector
    from ssds_tpu_torch.models.layers import BatchNorm
    from ssds_tpu_torch.ops import postprocess
    from ssds_tpu_torch.ops.cuda.nms import nms_mask
    from ssds_tpu_torch.ops.nms import nms_mask_torch
    from ssds_tpu_torch.solver import Solver
    from ssds_tpu_torch.tools import step_parity
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc, write_voc

    out = {"card": card}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        root, exp = os.path.join(tmp, "VOCdevkit"), os.path.join(tmp, "exp")
        cfg = make_cfg(root, exp)
        size = int(cfg.MODEL.IMAGE_SIZE[0])
        stack.enter_context(mock.patch.dict(factory.dataset_map,
                                            {"voc": in_memory_voc(seed, size)}))
        write_voc(root, seed, TRAIN_IMAGES, TEST_IMAGES, size=size)
        epochs, batch = int(cfg.TRAIN.MAX_EPOCHS), int(cfg.TRAIN.BATCH_SIZE)
        writer = ScalarWriter()
        solver = Solver(cfg, device=dev, writer=writer, seed=seed)
        bns = [m for m in solver.model.modules() if isinstance(m, BatchNorm)]
        n_boxes = (solver.model.num_boxes(solver.feature_maps) if solver.priors is None
                   else solver.priors.shape[0])
        out["boxes"], out["batchnorms"] = n_boxes, len(bns)
        if n_boxes != num_boxes or len(bns) != batchnorms:
            raise AssertionError(f"{what}: {n_boxes} boxes an image, {len(bns)} BatchNorms")
        var0 = [m.running_var.clone() for m in bns]
        resumed = None
        try:
            # -- train, with the eval of the last epoch
            nms_mask.launches = 0
            t0 = time.perf_counter()
            solver.train_model()
            torch.cuda.synchronize()
            out["train_model_s"] = time.perf_counter() - t0
            out["nms_launches_eval"] = nms_mask.launches
            out["epoch_loss"] = [l + c for (_, l), (_, c) in zip(writer.scalars["loss_loc"],
                                                                 writer.scalars["loss_conf"])]
            out["eval_map"] = writer.scalars["Eval/mAP"][-1][1]
            moved = sum(not torch.equal(m.running_var, v) for m, v in zip(bns, var0))
            out["bn_running_var_moved"] = moved
            log(f"trained {what} bf16 batch {batch}: {len(out['epoch_loss'])} epochs, "
                f"{solver.step} steps in {out['train_model_s']:.1f} s; epoch mean loss "
                f"{[round(v, 4) for v in out['epoch_loss']]}; eval mAP {out['eval_map']:.4f}; "
                f"running variances moved in {moved}/{len(bns)} BatchNorms; nms kernel launches "
                f"{out['nms_launches_eval']}")
            if not all(np.isfinite(v) for vals in writer.scalars.values() for _, v in vals):
                raise AssertionError(f"a loss is not finite: {writer.scalars}")
            if len(out["epoch_loss"]) != epochs or moved != len(bns):
                raise AssertionError(f"{len(out['epoch_loss'])} epochs, {moved} BNs moved")
            if loss_falls and not out["epoch_loss"][-1] < out["epoch_loss"][0]:
                raise AssertionError(f"{what}: the loss did not fall: {out['epoch_loss']}")
            if not (0.0 <= out["eval_map"] <= 1.0 and out["nms_launches_eval"] > 0):
                raise AssertionError(f"eval: mAP {out['eval_map']}, "
                                     f"{out['nms_launches_eval']} nms launches")
            ckpt = os.path.join(exp, f"{cfg.CHECKPOINTS_PREFIX}_epoch_{epochs}.pth")

            # -- resume, test, deploy
            resumed = Solver(cfg, device=dev, writer=ScalarWriter(), seed=seed + 1)
            resumed.train_model()  # auto-resume at the last epoch: no epoch left
            want = solver.model.state_dict()
            same = all(torch.equal(v, want[k]) for k, v in resumed.model.state_dict().items())
            if resumed.start_epoch != epochs or not same:
                raise AssertionError(f"resume: epoch {resumed.start_epoch}, state equal {same}")
            nms_mask.launches = 0
            out["test_map"] = resumed.test_model()
            torch.cuda.synchronize()
            out["nms_launches_test"] = nms_mask.launches
            if not (0.0 <= out["test_map"] <= 1.0 and out["nms_launches_test"] > 0):
                raise AssertionError(f"test_model: mAP {out['test_map']}, "
                                     f"{out['nms_launches_test']} nms launches")
            dcfg = copy.deepcopy(cfg)
            dcfg.RESUME_CHECKPOINT = ckpt
            det = ObjectDetector(dcfg, device=dev)
            test_set = resumed.get_loader("test").dataset
            imgs = np.stack([test_set.pull_image(i) for i in range(4)])
            with torch.no_grad():
                rows = det.detect_rows(imgs)
                want_rows = resumed.make_eval_forward()(torch.from_numpy(imgs).to(dev))
            if not torch.equal(rows, want_rows):
                raise AssertionError("ObjectDetector on the checkpoint != the solver's eval rows: "
                                     f"max |d| {(rows - want_rows).abs().max().item():.3e}")
            log(f"resumed at epoch {resumed.start_epoch} with the saved weights and running "
                f"statistics; test_model mAP {out['test_map']:.4f} ({out['nms_launches_test']} nms "
                f"launches); ObjectDetector on {os.path.basename(ckpt)}: detect rows of 4 test "
                "images identical to the solver's eval forward")

            # -- serve: predict x3, predict_batch at 4 and 32, on the checkpoint
            rng = np.random.default_rng(seed)
            hw = det.img_hw
            singles = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(3)]
            batch4 = list(rng.integers(0, 256, (4, *hw, 3), dtype=np.uint8))
            batch32 = list(rng.integers(0, 256, (32, *hw, 3), dtype=np.uint8))
            nms_mask.launches = 0
            served = [det.predict(img, threshold=0.01) for img in singles]
            served += det.predict_batch(batch4, threshold=0.01)
            served += det.predict_batch(batch32, threshold=0.01)
            torch.cuda.synchronize()
            out["nms_launches_serve"] = nms_mask.launches
            if out["nms_launches_serve"] <= 0:
                raise AssertionError(f"serving {what} never launched the NMS kernel")
            for boxes, labels, scores in served:
                assert boxes.shape == (len(labels), 4) and len(scores) == len(labels)
                assert np.isfinite(boxes).all() and np.isfinite(scores).all()
                assert ((labels >= 0) & (labels < 20)).all()
            for name, group in (("batch 1", singles[:1]), ("batch 32", batch32)):
                x = torch.from_numpy(np.stack(group)).to(dev)
                with torch.no_grad():
                    served_out = det.forward(x)
                    if served_out[0].shape[1] != num_boxes:
                        raise AssertionError(f"{what}: {served_out[0].shape[1]} boxes served")
                    rows = det.postprocess(served_out)
                    with mock.patch.object(postprocess, "nms_mask", nms_mask_torch):
                        plain_rows = det.postprocess(served_out)
                assert rows.shape == (len(group), 21, 100, 5) and torch.isfinite(rows).all()
                if not torch.equal(rows, plain_rows):
                    raise AssertionError(f"{what} {name}: detect rows with the kernel != plain")
            log(f"served {what} bf16: predict x3, predict_batch x4 and x32 "
                f"({sum(len(s[2]) for s in served)} detections at threshold 0.01), nms kernel "
                f"launches {out['nms_launches_serve']}; detect rows identical with kernel and "
                "plain NMS at batch 1 and 32")
            float32_modules = getattr(det.model, "FLOAT32_MODULES", ())
            if float32_modules:
                x = torch.from_numpy(np.stack(singles[:2])).to(dev)
                with torch.no_grad():
                    xb = ((x.float() - det.means).permute(0, 3, 1, 2)).to(det.dtype)
                    sources = det.model(xb, phase="feature")
                dtypes = {str(p.dtype) for n in float32_modules
                          for p in det.model.get_submodule(n).parameters()}
                out["float32_sources"] = [str(t.dtype) for t in sources]
                log(f"{what} bf16 serving: modules {float32_modules} hold {sorted(dtypes)}; "
                    f"pyramid sources {out['float32_sources']}")
                if dtypes != {"torch.float32"} or any(t.dtype != torch.float32 for t in sources):
                    raise AssertionError(f"{what}: the layers after the fusion BN are not float32")

            # float32 forward on the card (TF32 off) against the CPU, checkpoint weights:
            # (loc, conf) of two noise images, or a YOLO head's raw outputs of two
            # test images. The decode's exp turns a raw error into the same relative
            # error of a box (1e-4 at a raw tw of 7, measured), and noise lies far
            # outside the synthetic data: the barely trained eval-mode network's tw
            # reaches 20 on it, boxes 1e8.
            cfg32 = copy.deepcopy(dcfg)
            cfg32.MODEL.HALF_PRECISION = False
            yolo = det.priors is None
            x = torch.from_numpy(imgs[:2] if yolo else np.stack(singles[:2]))
            phase = "train" if yolo else "eval"
            with torch.no_grad():
                det32 = ObjectDetector(cfg32, device=dev)
                gpu_out = [a.cpu() for a in det32.forward(x.to(dev), phase)]
                del det32
                cpu_out = ObjectDetector(cfg32, device="cpu").forward(x, phase)
            names = [f"raw{i}" for i in range(len(cpu_out))] if yolo else ("loc", "conf")
            for n, g, c in zip(names, gpu_out, cpu_out):
                out[f"f32_{n}_max_abs_err"] = (g - c).abs().max().item()
            log(f"{what} float32 forward, card vs CPU: " + ", ".join(
                f"{n} max|d| {out[f'f32_{n}_max_abs_err']:.3e} (max|{n}| "
                f"{c.abs().max().item():.3e})" for n, c in zip(names, cpu_out)))
            for g, c in zip(gpu_out, cpu_out):
                torch.testing.assert_close(g, c, rtol=F32_RTOL, atol=F32_ATOL)

            # -- times
            out["train_step_ms"] = train_step_ms(solver)
            out["train_img_s"] = batch / out["train_step_ms"] * 1e3
            lat, out["predict_batch32_img_s"] = serve_times(det, singles[0], batch32)
            out["predict_b1_p50_ms"] = float(np.percentile(lat, 50)) * 1e3
            out["predict_b1_p90_ms"] = float(np.percentile(lat, 90)) * 1e3
            log(f"{what} bf16: train step batch {batch} (20 steps after 3 warm-up, upload "
                "included) "
                f"{out['train_step_ms']:.3f} ms, {out['train_img_s']:.1f} img/s; batch-1 predict "
                f"p50 {out['predict_b1_p50_ms']:.3f} ms, p90 {out['predict_b1_p90_ms']:.3f} ms "
                f"(50 requests); batch-32 predict_batch {out['predict_batch32_img_s']:.1f} img/s "
                f"(10 batches) ({card})")
            del det
        finally:
            solver.close()
            if resumed is not None:
                resumed.close()

        # -- one float32 step, card against CPU: losses, updates, running statistics
        t0 = time.perf_counter()
        dataset = factory.load_data(cfg.DATASET, "train", cfg.MODEL.IMAGE_SIZE).dataset
        f32 = step_parity.compare(cfg, dev, detection_collate(
            [dataset[i] for i in range(f32_batch)], int(cfg.DATASET.MAX_GT)), seed)
        out["f32_step_s"] = time.perf_counter() - t0
    f32.update(loss_rtol=STEP_RTOL, update_tol=update_tol, stats_rtol=stats_rtol)
    out["f32_step"] = f32
    out["phase_s"] = time.perf_counter() - t_phase
    log_f32_step(f"{what} batch {f32_batch}", f32, log)
    log(f"{what}: seconds: phase {out['phase_s']:.1f}, train_model {out['train_model_s']:.1f}, "
        f"float32 step card and CPU {out['f32_step_s']:.1f}")
    if (max(f32["loss_rel_err"].values()) > STEP_RTOL
            or f32["update_err_over_max_update"] > update_tol
            or f32.get("stats_rel_err_max", 0.0) > stats_rtol):
        raise AssertionError(f"{what} float32 step card vs CPU outside {STEP_RTOL} / "
                             f"{update_tol} / {stats_rtol}: {f32}")
    return out


def check_lite(seed, dev, card, log):
    """Phase 9: SSDLite-MobileNetV2-300 trained, resumed, deployed and served."""
    return drive_model("SSDLite-MobileNetV2-300", lite_config, seed, dev, card, log,
                       num_boxes=LITE_PRIORS, batchnorms=LITE_BATCHNORMS, f32_batch=LITE_F32_BATCH,
                       update_tol=LITE_UPDATE_TOL, stats_rtol=LITE_STATS_RTOL)


def head_config(kind):
    """Phase 11's config maker for ``kind`` (``fssd`` or ``rfb``): its yml
    (``config.MODELS``) as written, over the synthetic VOC tree, cut as the
    module docstring lists."""
    from ssds_tpu_torch.config import MODELS

    def make(root, exp):
        cfg = MODELS[kind][1]()
        cfg.DATASET.update(DATASET_DIR=root, TRAIN_SETS=[["2007", "trainval"]],
                           TEST_SETS=[["2007", "test"]], PROB=-1, NUM_WORKERS=4)
        cfg.TRAIN.update(MAX_EPOCHS=HEAD_EPOCHS, CHECKPOINTS_EPOCHS=HEAD_EPOCHS)
        cfg.TEST.TEST_SCOPE = [HEAD_EPOCHS, HEAD_EPOCHS]
        cfg.PHASE = ["train", "eval"]
        cfg.EXP_DIR, cfg.LOG_DIR = exp, os.path.join(exp, "logs")
        return cfg

    return make


def check_heads(seed, dev, card, log):
    """Phase 11: FSSD-VGG16-300 and RFBNet-VGG16-300 trained, resumed, deployed
    and served."""
    from ssds_tpu_torch.config import MODELS

    out = {}
    for kind, (batchnorms, update_tol, stats_rtol) in HEADS.items():
        out[kind] = drive_model(MODELS[kind][0], head_config(kind), seed, dev, card, log,
                                num_boxes=SSD300_PRIORS, batchnorms=batchnorms,
                                f32_batch=HEAD_F32_BATCH, update_tol=update_tol,
                                stats_rtol=stats_rtol)
    return out


def check_reorg(dev, log):
    """YOLOv2's reorg on the card at its route's shape ``[B, 64, 26, 26]``:
    the channels in the JAX package's (row offset, column offset, channel)
    order, which ``F.pixel_unshuffle``'s (channel, row, column) is not."""
    import torch.nn.functional as F

    from ssds_tpu_torch.models.heads.yolo import space_to_depth

    x = torch.randn(2, 64, 26, 26, generator=torch.Generator().manual_seed(0)).to(dev)
    got = space_to_depth(x, 2).cpu()
    nhwc = x.cpu().permute(0, 2, 3, 1).reshape(2, 13, 2, 13, 2, 64)
    want = nhwc.permute(0, 1, 3, 2, 4, 5).reshape(2, 13, 13, 256).permute(0, 3, 1, 2)
    if not torch.equal(got, want) or torch.equal(F.pixel_unshuffle(x, 2).cpu(), want):
        raise AssertionError("the reorg's channel order on the card is not (row, column, channel)")
    log("YOLOv2 reorg on the card at [2, 64, 26, 26]: channels in (row offset, column offset, "
        "channel) order, equal to the NHWC reshape; pixel_unshuffle's order differs")


def yolo_config(kind):
    """Phase 12's config maker for ``kind`` (``yolo_v3`` or ``yolo_v2``):
    :func:`head_config`'s cut with ``YOLO_EPOCHS`` epochs and the yml's
    warm-up over as many steps as on VOC07+12."""
    head = head_config(kind)

    def make(root, exp):
        cfg = head(root, exp)
        epochs, batch = YOLO_EPOCHS[kind], int(cfg.TRAIN.BATCH_SIZE)
        cfg.TRAIN.update(MAX_EPOCHS=epochs, CHECKPOINTS_EPOCHS=epochs)
        cfg.TEST.TEST_SCOPE = [epochs, epochs]
        cfg.TRAIN.LR_SCHEDULER.WARM_UP_EPOCHS *= -(-VOC0712_TRAINVAL // batch) / (
            TRAIN_IMAGES // batch)
        return cfg

    return make


def check_yolo(seed, dev, card, log):
    """Phase 12: YOLOv3-DarkNet53-416 and YOLOv2-DarkNet19-416 trained,
    resumed, deployed and served (``drive_model``); YOLOv2's reorg on the
    card; its warm-up's seen-image count at every train step."""
    from ssds_tpu_torch import solver as solver_lib
    from ssds_tpu_torch.config import MODELS

    check_reorg(dev, log)
    seen = []
    v2_loss = solver_lib.yolo_v2_loss

    def counted(*args, seen_images=float("inf"), **kw):
        seen.append(seen_images)
        return v2_loss(*args, seen_images=seen_images, **kw)

    out = {}
    for kind, (num_boxes, batchnorms, update_tol, stats_rtol) in YOLO.items():
        with mock.patch.object(solver_lib, "yolo_v2_loss", counted):
            out[kind] = drive_model(MODELS[kind][0], yolo_config(kind), seed, dev, card, log,
                                    num_boxes=num_boxes, batchnorms=batchnorms,
                                    f32_batch=HEAD_F32_BATCH,
                                    update_tol=update_tol, stats_rtol=stats_rtol,
                                    loss_falls=True)
    # YOLOv2's train steps come first: step * batch seen images each, the
    # warm-up on below 12,800 (the evals pass inf: off)
    v2_cfg = MODELS["yolo_v2"][1]()
    steps = YOLO_EPOCHS["yolo_v2"] * (TRAIN_IMAGES // int(v2_cfg.TRAIN.BATCH_SIZE))
    train_seen = [v for v in seen if v != float("inf")][:steps]
    want = [i * int(v2_cfg.TRAIN.BATCH_SIZE) for i in range(steps)]
    out["yolo_v2"]["seen_images"] = train_seen
    log(f"YOLOv2's {len(train_seen)} train steps saw {train_seen[0]}, {train_seen[1]}, ..., "
        f"{train_seen[-1]} images: step * batch, the warm-up on at every step (< 12800)")
    if train_seen != want or max(train_seen) >= 12800:
        raise AssertionError(f"YOLOv2 seen images {train_seen}, want {want}")
    return out


def check_zoo(seed, dev, card, log):
    """Phase 13: SSD300-ResNet50 and SSD512-VGG16 trained, resumed, deployed
    and served (``drive_model``, their ymls' models and recipes cut as phase
    11's), then the serving export (:func:`check_export`)."""
    from ssds_tpu_torch.config import MODELS

    out = {}
    for name, (num_boxes, batchnorms, f32_batch) in ZOO.items():
        out[name] = drive_model(MODELS[name][0], head_config(name), seed, dev, card, log,
                                num_boxes=num_boxes, batchnorms=batchnorms, f32_batch=f32_batch,
                                update_tol=ZOO_UPDATE_TOL, stats_rtol=ZOO_STATS_RTOL,
                                loss_falls=True)
    out["export"] = check_export(seed, dev, card, log)
    return out


def rows_times(call, imgs):
    """``call(images_u8) -> rows on the host``: its batch-1 latencies (50
    after 10, on ``imgs[:1]``) and its img/s on all of ``imgs`` (10 calls
    after 2). Each call uploads, runs and downloads, so each is synchronised."""
    for _ in range(10):
        call(imgs[:1])
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        call(imgs[:1])
        lat.append(time.perf_counter() - t0)
    for _ in range(2):
        call(imgs)
    t0 = time.perf_counter()
    for _ in range(10):
        call(imgs)
    return lat, 10 * len(imgs) / (time.perf_counter() - t0)


# The serving process of phases 13c and 14: torch, the operators'
# registrations and the artifact, nothing else of the port. It serves each
# batch once with the kernels' launches counted around the call (NMS in
# "launches", the int8 kernels in "int8_launches"), saves the rows and times
# the program (argv: artifact dir, images .npy, rows .npz, repo root, and
# optionally the device to move the program to with its batches; on the CPU
# it serves those batches and times nothing).
EXPORT_SERVER = r"""
import json, sys, time
import numpy as np, torch
from ssds_tpu_torch.export import load_exported
from ssds_tpu_torch.ops.cuda import int8_conv as cuda_int8
from ssds_tpu_torch.ops.cuda import nms as cuda_nms
sys.path.insert(0, sys.argv[4])
from chip_smoke import EXPORT_BATCHES, rows_times
t0 = time.perf_counter()
moved = len(sys.argv) > 5
predict, meta = load_exported(sys.argv[1], device=sys.argv[5] if moved else None)
load_s = time.perf_counter() - t0
imgs = np.load(sys.argv[2])
dev = torch.device(meta["device"])
launches, int8_launches, rows = {}, {}, {}
batches = [int(b) for b in sys.argv[6].split(",")] if moved else EXPORT_BATCHES
for b in batches:
    x = torch.from_numpy(imgs[:b]).to(dev)
    before = cuda_nms.nms_mask.launches
    before8 = (cuda_int8.quantize_act.launches, cuda_int8.int8_conv.launches)
    rows[str(b)] = predict(x).cpu().numpy()
    launches[str(b)] = cuda_nms.nms_mask.launches - before
    int8_launches[str(b)] = [cuda_int8.quantize_act.launches - before8[0],
                             cuda_int8.int8_conv.launches - before8[1]]
np.savez(sys.argv[3], **rows)
lat, ips = ([], None) if moved else rows_times(
    lambda x: predict(torch.from_numpy(x).to(dev)).cpu(), imgs)
print(json.dumps({"meta": meta, "load_s": load_s, "launches": launches,
                  "int8_launches": int8_launches, "lat": lat, "img_s": ips,
                  "modules": sorted(m for m in sys.modules if m.startswith(("ssds_tpu", "jax")))}))
"""


def serve_exported(det, imgs, tmp):
    """Export ``det`` (symbolic batch, for ``EXPORT_PLATFORMS``) into ``tmp``
    and serve ``imgs`` from a fresh ``EXPORT_SERVER`` process: ``(served
    json, rows by batch, export seconds, artifact MB, server seconds)``;
    raises if the process fails or imports a model module."""
    from ssds_tpu_torch.export import export_detector

    t0 = time.perf_counter()
    served_dir = export_detector(det, os.path.join(tmp, "served"), platforms=EXPORT_PLATFORMS)
    export_s = time.perf_counter() - t0
    artifact_mb = os.path.getsize(os.path.join(served_dir, "predict.pt2")) / 1e6
    np.save(os.path.join(tmp, "imgs.npy"), imgs)
    rows_path = os.path.join(tmp, "rows.npz")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_SERVER, served_dir,
                           os.path.join(tmp, "imgs.npy"), rows_path, REPO],
                          capture_output=True, text=True, timeout=600, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))
    server_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the export's serving process failed:\n{proc.stderr[-4000:]}")
    served = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(rows_path) as f:
        rows = {int(b): f[b] for b in f.files}
    bad_modules = [m for m in served["modules"] if m.startswith(("jax", "ssds_tpu.")) or m in (
        "ssds_tpu", "ssds_tpu_torch.config", "ssds_tpu_torch.detector", "ssds_tpu_torch.quant")
        or m.startswith("ssds_tpu_torch.models")]
    if bad_modules or served["meta"]["batch"] != "symbolic":
        raise AssertionError(f"the serving process imported {bad_modules}, meta {served['meta']}")
    return served, rows, export_s, artifact_mb, server_s


def check_export_moved(seed, served_dir, imgs, tmp, log):
    """Phase 13c: the card's artifact moved to the CPU by a fresh
    ``EXPORT_SERVER`` process (``load_exported(dir, device="cpu")``), its rows
    at ``EXPORT_CPU_BATCHES`` identical to an in-process CPU detector's on the
    same weights (unpruned, as a symbolic batch serves)."""
    import dataclasses

    from ssds_tpu_torch.config import default_config
    from ssds_tpu_torch.detector import ObjectDetector, Predict

    t0 = time.perf_counter()
    rows_path = os.path.join(tmp, "rows_cpu.npz")
    proc = subprocess.Popen([sys.executable, "-c", EXPORT_SERVER, served_dir,
                             os.path.join(tmp, "imgs.npy"), rows_path, REPO, "cpu",
                             ",".join(map(str, EXPORT_CPU_BATCHES))],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO))
    try:  # the in-process rows while the process serves
        cpu = ObjectDetector(default_config(), device="cpu", seed=seed)
        unpruned = Predict(cpu.model, cpu.means, cpu.priors,
                           dataclasses.replace(cpu.post, pre_nms_top_n=0), cpu.dtype)
        with torch.no_grad():
            wants = {b: unpruned(torch.from_numpy(imgs[:b])).numpy() for b in EXPORT_CPU_BATCHES}
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"the CPU serving process failed:\n{stderr[-4000:]}")
    served = json.loads(stdout.strip().splitlines()[-1])
    if served["meta"]["device"] != "cpu" or served["meta"]["platforms"] != list(EXPORT_PLATFORMS):
        raise AssertionError(f"the moved program's meta: {served['meta']}")
    with np.load(rows_path) as f:
        for b, want in wants.items():
            if not np.array_equal(f[str(b)], want):
                d = float(np.abs(f[str(b)] - want).max())
                raise AssertionError(f"the program moved to the CPU at batch {b}: rows != the "
                                     f"in-process CPU detector's (max |d| {d:.3e})")
    s = time.perf_counter() - t0
    log(f"the card's artifact (platforms {list(EXPORT_PLATFORMS)}) moved to the CPU by a fresh "
        f"process (load_exported(device='cpu'), {served['load_s']:.2f} s): rows at batches "
        f"{list(EXPORT_CPU_BATCHES)} identical to an in-process CPU ObjectDetector's ({s:.1f} s)")
    return {"moved_cpu_rows_identical": True, "moved_cpu_load_s": served["load_s"],
            "moved_cpu_s": s}


def check_export_sharded(served_dir, imgs, dev, log):
    """Phase 13c: ``load_exported_sharded`` over every visible card (or two
    programs on card 0 when there is one) at batch ``max(EXPORT_BATCHES)``:
    rows identical to one program's on the same pieces, the NMS kernel
    launched once a piece. Beside it, one program's rows on the whole batch
    against its rows on the pieces: cuDNN may take other algorithms at
    another batch size, so their last bits, and then the NMS's order, can
    move (``export_batch_dependence``)."""
    from ssds_tpu_torch.export import load_exported, load_exported_sharded
    from ssds_tpu_torch.ops.cuda.nms import nms_mask

    count = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(count)] if count > 1 else [str(dev)] * 2
    single, _ = load_exported(served_dir)
    sharded, meta = load_exported_sharded(served_dir, devices)
    b = max(EXPORT_BATCHES)
    x = torch.from_numpy(imgs[:b]).to(dev)
    cuts = [i * b // len(devices) for i in range(len(devices) + 1)]
    pieces = torch.cat([single(x[lo:hi]) for lo, hi in zip(cuts, cuts[1:])])
    nms_mask.launches = 0
    got = sharded(x)
    torch.cuda.synchronize()
    launches = nms_mask.launches
    same = torch.equal(got, pieces)
    dependence = export_batch_dependence(single(x), pieces)
    log(f"load_exported_sharded over {meta['devices']} at batch {b}: rows "
        f"{'identical to' if same else 'DIFFER from'} one program's on the same pieces; NMS "
        f"kernel launches {launches}. One program at batch {b} against the same on the pieces "
        f"{cuts}: {dependence}")
    if not same or launches != len(devices):
        raise AssertionError("the sharded export's rows differ from one program's on the same "
                             f"pieces, or it launched the NMS kernel {launches} times")
    return {"sharded_devices": meta["devices"], "nms_launches_sharded": launches,
            "sharded_rows_identical": same, "batch_dependence": dependence}


def export_batch_dependence(whole, pieces):
    """How far rows ``[B, C, K, 5]`` of one batch are from the same images'
    rows served in pieces: the largest difference and the rows and images
    that differ at all."""
    d = (whole - pieces).abs()
    rows = d.amax(-1) > 0
    return {"identical": bool(not rows.any()), "max_abs_diff": float(d.max()),
            "rows_differ": int(rows.sum()), "rows": rows.numel(),
            "images_differ": int(rows.flatten(1).any(1).sum())}


def check_export(seed, dev, card, log):
    """Phase 13c: the registered NMS operator on the card against the plain
    version; SSD300-VGG16 (default config, bf16, seeded weights) exported
    with a symbolic batch on the card, reloaded by a fresh process that
    imports no model module (``EXPORT_SERVER``), served at
    ``EXPORT_BATCHES`` with the kernel launched inside the program, its rows
    identical to the in-process detector's unpruned rows; the program's
    batch-1 latency and batch-32 img/s beside the in-process ones."""
    import dataclasses

    from ssds_tpu_torch.config import default_config
    from ssds_tpu_torch.detector import ObjectDetector, Predict
    from ssds_tpu_torch.ops.nms import nms_mask_torch

    t_phase = time.perf_counter()
    out = {"card": card, "nms_op_max_abs_err": check_nms_kernel(
        torch.ops.ssds_tpu_torch.nms_mask, nms_mask_torch, seed, EXPORT_NMS_SHAPES)}
    log(f"registered operator ssds_tpu_torch::nms_mask on the card: bit-identical to the plain "
        f"version at {EXPORT_NMS_SHAPES}")
    det = ObjectDetector(default_config(), device=dev, seed=seed)
    unpruned = Predict(det.model, det.means, det.priors,
                       dataclasses.replace(det.post, pre_nms_top_n=0), det.dtype)
    imgs = np.random.default_rng(seed).integers(
        0, 256, (max(EXPORT_BATCHES), *det.img_hw, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        served, rows, out["export_s"], out["artifact_mb"], out["server_s"] = serve_exported(
            det, imgs, tmp)
        served_dir = os.path.join(tmp, "served")
        out.update(check_export_moved(seed, served_dir, imgs, tmp, log))
        out.update(check_export_sharded(served_dir, imgs, dev, log))
    out["server_modules"] = served["modules"]
    out["nms_launches_export"] = sum(served["launches"].values())
    for b in EXPORT_BATCHES:
        with torch.no_grad():
            want = unpruned(torch.from_numpy(imgs[:b]).to(dev)).cpu().numpy()
        if served["launches"][str(b)] != 1:
            raise AssertionError(f"the exported program at batch {b} launched the NMS kernel "
                                 f"{served['launches'][str(b)]} times")
        if rows[b].shape != (b, 21, 100, 5) or not np.array_equal(rows[b], want):
            raise AssertionError(f"exported rows at batch {b} != the in-process unpruned rows")
    log(f"exported SSD300-VGG16 bf16 (symbolic batch, {det.device}) in {out['export_s']:.1f} s, "
        f"predict.pt2 {out['artifact_mb']:.1f} MB; a fresh process (modules of the port "
        f"{served['modules']}) loaded it in {served['load_s']:.2f} s and served batches "
        f"{list(EXPORT_BATCHES)}: NMS kernel launches {served['launches']}, rows identical to the "
        "in-process unpruned rows")

    # times: the program in its process; in this one the same work (upload,
    # the unpruned predict function, download) and predict / predict_batch
    lat, ips = rows_times(lambda x: unpruned(torch.from_numpy(x).to(dev)).cpu(), imgs)
    plat, pips = serve_times(det, imgs[0], list(imgs))
    out.update(
        export_b1_p50_ms=float(np.percentile(served["lat"], 50)) * 1e3,
        export_b1_p90_ms=float(np.percentile(served["lat"], 90)) * 1e3,
        export_batch32_img_s=served["img_s"],
        inprocess_b1_p50_ms=float(np.percentile(lat, 50)) * 1e3, inprocess_batch32_img_s=ips,
        predict_b1_p50_ms=float(np.percentile(plat, 50)) * 1e3, predict_batch32_img_s=pips)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"SSD300-VGG16 bf16 unpruned rows (upload, program, download): exported program batch-1 "
        f"p50 {out['export_b1_p50_ms']:.3f} ms (p90 {out['export_b1_p90_ms']:.3f}), batch 32 "
        f"{out['export_batch32_img_s']:.1f} img/s; in-process Predict batch-1 p50 "
        f"{out['inprocess_b1_p50_ms']:.3f} ms, batch 32 "
        f"{out['inprocess_batch32_img_s']:.1f} img/s; "
        f"predict p50 {out['predict_b1_p50_ms']:.3f} ms, predict_batch 32 (pruned) "
        f"{out['predict_batch32_img_s']:.1f} img/s; phase 13c {out['phase_s']:.1f} s ({card})")
    return out


def coco_config(root, exp):
    """``experiments/cfgs/ssd_lite_mobilenetv2_train_coco.yml`` as written
    (81 classes, bf16, batch 64, SGD 0.01, sgdr with its 5 warm-up epochs,
    ``PROB`` 0.6, ``MAX_GT`` 128, ``TEST.BATCH_SIZE`` 64) over the synthetic
    COCO tree, for ``COCO_EPOCHS`` epochs with the eval in the last."""
    from ssds_tpu_torch.config import ssd_lite_mobilenetv2_coco_config

    cfg = ssd_lite_mobilenetv2_coco_config()
    cfg.DATASET.DATASET_DIR = root
    cfg.TRAIN.update(MAX_EPOCHS=COCO_EPOCHS, CHECKPOINTS_EPOCHS=COCO_EPOCHS)
    cfg.TEST.TEST_SCOPE = [COCO_EPOCHS, COCO_EPOCHS]
    cfg.PHASE = ["train", "eval"]
    cfg.EXP_DIR, cfg.LOG_DIR = exp, os.path.join(exp, "logs")
    return cfg


def loader_img_s(cfg, native_sampler: bool):
    """The train loader's img/s over one epoch (its worker processes started
    by an epoch before), with the native crop sampler or its Python loop."""
    from ssds_tpu_torch.data import native
    from ssds_tpu_torch.data.factory import load_data

    with mock.patch.object(native, "available", native.available if native_sampler
                           else (lambda: False)):
        loader = load_data(cfg.DATASET, "train", cfg.MODEL.IMAGE_SIZE, int(cfg.TRAIN.BATCH_SIZE))
        try:
            for _ in loader:  # forks the workers
                pass
            t0 = time.perf_counter()
            n = sum(len(b["images"]) for b in loader)
            return n / (time.perf_counter() - t0), loader.num_workers
        finally:
            loader.close()


def check_coco(seed, dev, card, log, nms_mask, nms_mask_torch):
    """Phase 10: SSDLite-MobileNetV2-300 on COCO, trained with the recipe's
    augmentation, evaluated with the port's COCOeval, resumed, deployed and
    served on images of any size; the NMS kernel at COCO's shapes."""
    import random

    from ssds_tpu_torch.data import factory, native
    from ssds_tpu_torch.data.coco import COCODetection
    from ssds_tpu_torch.data.image_ops import resize_linear
    from ssds_tpu_torch.detector import ObjectDetector
    from ssds_tpu_torch.models.heads.common import finalize
    from ssds_tpu_torch.models.layers import BatchNorm
    from ssds_tpu_torch.ops import postprocess
    from ssds_tpu_torch.solver import Solver, forward_raw
    from ssds_tpu_torch.tools import nms_bench
    from ssds_tpu_torch.tools.synth_coco import in_memory_coco, write_coco

    t_phase = time.perf_counter()
    out = {"card": card}
    # -- the NMS kernel at COCO's shapes: bit-identical, then timed beside its bound
    out["nms_max_abs_err"] = check_nms_kernel(nms_mask, nms_mask_torch, seed, COCO_NMS_SHAPES)
    nms_times = nms_bench.run(shapes=COCO_NMS_SHAPES, sets=("full",), seed=seed, log=log)
    out["nms_bench"] = nms_times["cases"]

    evals = []  # (seconds, stats, summary lines, detections) of every COCOeval run
    evaluate = COCODetection.evaluate_detections

    def timed_evaluate(self, all_boxes, output_dir):
        t0 = time.perf_counter()
        ap = evaluate(self, all_boxes, output_dir)
        evals.append((time.perf_counter() - t0, dict(self.last_stats),
                      len(self.last_stats.summary_lines()),
                      sum(len(b) for c in all_boxes[1:] for b in c)))
        return ap

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.dict(factory.dataset_map, {"coco": in_memory_coco(seed)}), \
            mock.patch.object(COCODetection, "evaluate_detections", timed_evaluate):
        root, exp = os.path.join(tmp, "coco"), os.path.join(tmp, "exp")
        write_coco(root, seed, COCO_TRAIN_IMAGES, COCO_VAL_IMAGES)
        cfg = coco_config(root, exp)
        writer = ScalarWriter()
        solver = Solver(cfg, device=dev, writer=writer, seed=seed)
        bns = [m for m in solver.model.modules() if isinstance(m, BatchNorm)]
        if solver.priors.shape != (LITE_PRIORS, 4) or solver.post_cfg.num_classes != 81:
            raise AssertionError(f"SSDLite-MobileNetV2-300 COCO: {tuple(solver.priors.shape)} "
                                 f"priors, {solver.post_cfg.num_classes} classes")
        resumed = None
        try:
            # -- augmentation on, through the native sampler
            train_set = solver.get_loader("train").dataset
            plain_cfg = copy.deepcopy(cfg)
            plain_cfg.DATASET.PROB = -1
            plain_set = factory.load_data(plain_cfg.DATASET, "train", cfg.MODEL.IMAGE_SIZE).dataset
            idx = list(range(16))
            launches = native.launches
            random.seed(seed)
            aug = factory.detection_collate([train_set[i] for i in idx], int(cfg.DATASET.MAX_GT))
            out["native_sampler_calls"] = native.launches - launches
            plain = factory.detection_collate([plain_set[i] for i in idx], int(cfg.DATASET.MAX_GT))
            differ = int(sum(not np.array_equal(a, b) for a, b in zip(aug["images"],
                                                                      plain["images"])))
            out["augmented_images_differ"] = differ
            log(f"COCO train batch of {len(idx)} at PROB {cfg.DATASET.PROB}: {differ} images "
                f"differ from PROB -1 (sizes {sorted({s for s in map(tuple, aug['sizes'].tolist())})[:4]}"
                f"...); native sampler {os.path.relpath(native.library_path(), REPO)} called "
                f"{out['native_sampler_calls']} times")
            if differ == 0 or out["native_sampler_calls"] == 0:
                raise AssertionError("augmentation did not change the batch or the native "
                                     "sampler was not called")

            # -- train, with the eval of the last epoch
            nms_mask.launches = 0
            t0 = time.perf_counter()
            solver.train_model()
            torch.cuda.synchronize()
            out["train_model_s"] = time.perf_counter() - t0
            out["nms_launches_eval"] = nms_mask.launches
            out["epoch_loss"] = [l + c for (_, l), (_, c) in zip(writer.scalars["loss_loc"],
                                                                 writer.scalars["loss_conf"])]
            out["eval_ap"] = writer.scalars["Eval/mAP"][-1][1]
            out["eval_ap50"] = evals[-1][1]["AP50"]
            out["eval_cocoeval_s"], out["eval_detections"] = evals[-1][0], evals[-1][3]
            log(f"trained SSDLite-MobileNetV2-300 COCO bf16 batch {cfg.TRAIN.BATCH_SIZE} at PROB "
                f"{cfg.DATASET.PROB}: "
                f"{len(out['epoch_loss'])} epochs, {solver.step} steps in "
                f"{out['train_model_s']:.1f} s; epoch mean loss "
                f"{[round(v, 4) for v in out['epoch_loss']]}; eval AP {out['eval_ap']:.4f} AP50 "
                f"{out['eval_ap50']:.4f} over {out['eval_detections']} detections (COCOeval "
                f"{out['eval_cocoeval_s']:.2f} s, {evals[-1][2]} summary lines); nms kernel "
                f"launches {out['nms_launches_eval']}")
            if not all(np.isfinite(v) for vals in writer.scalars.values() for _, v in vals):
                raise AssertionError(f"a loss is not finite: {writer.scalars}")
            if len(out["epoch_loss"]) != COCO_EPOCHS or evals[-1][2] != 12:
                raise AssertionError(f"{len(out['epoch_loss'])} epochs, {evals[-1][2]} lines")
            if not (0.0 <= out["eval_ap"] <= 1.0 and 0.0 <= out["eval_ap50"] <= 1.0
                    and out["nms_launches_eval"] > 0):
                raise AssertionError(f"eval: AP {out['eval_ap']}, AP50 {out['eval_ap50']}, "
                                     f"{out['nms_launches_eval']} nms launches")
            ckpt = os.path.join(exp, f"{cfg.CHECKPOINTS_PREFIX}_epoch_{COCO_EPOCHS}.pth")

            # -- resume, test, deploy
            resumed = Solver(cfg, device=dev, writer=ScalarWriter(), seed=seed + 1)
            resumed.train_model()  # auto-resume at the last epoch: no epoch left
            want = solver.model.state_dict()
            same = all(torch.equal(v, want[k]) for k, v in resumed.model.state_dict().items())
            if resumed.start_epoch != COCO_EPOCHS or not same:
                raise AssertionError(f"resume: epoch {resumed.start_epoch}, state equal {same}")
            nms_mask.launches = 0
            out["test_ap"] = resumed.test_model()
            torch.cuda.synchronize()
            out["nms_launches_test"] = nms_mask.launches
            out["test_ap50"], out["test_cocoeval_s"] = evals[-1][1]["AP50"], evals[-1][0]
            if not (0.0 <= out["test_ap"] <= 1.0 and 0.0 <= out["test_ap50"] <= 1.0
                    and out["nms_launches_test"] > 0 and evals[-1][2] == 12):
                raise AssertionError(f"test_model: AP {out['test_ap']}, AP50 {out['test_ap50']}, "
                                     f"{out['nms_launches_test']} nms launches")
            log(f"resumed at epoch {resumed.start_epoch} with the saved weights and running "
                f"statistics of {len(bns)} BatchNorms; test_model AP {out['test_ap']:.4f} AP50 "
                f"{out['test_ap50']:.4f} (COCOeval {out['test_cocoeval_s']:.2f} s; "
                f"{out['nms_launches_test']} nms launches)")

            # -- eval throughput: forward, loss and detect at TEST.BATCH_SIZE 64
            ebatch = solver._upload(next(iter(solver.get_loader("eval"))))
            eval_step = solver.make_eval_step()
            for _ in range(2):
                eval_step(ebatch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                eval_step(ebatch)
            torch.cuda.synchronize()
            out["eval_img_s"] = 10 * len(ebatch["images"]) / (time.perf_counter() - t0)
            # detect rows with the kernel and with the plain NMS at batch 64: [5184, 200]
            with torch.no_grad():
                solver.model.eval()
                loc, conf = finalize("eval", *forward_raw(solver.model, ebatch["images"],
                                                          solver.means, solver.compute_dtype))
                rows = postprocess.detect(loc, conf, solver.priors, solver.post_cfg)
                with mock.patch.object(postprocess, "nms_mask", nms_mask_torch):
                    plain_rows = postprocess.detect(loc, conf, solver.priors, solver.post_cfg)
            if rows.shape != (len(ebatch["images"]), 81, 100, 5) or not torch.equal(rows,
                                                                                     plain_rows):
                raise AssertionError("COCO batch 64: detect rows with the kernel != plain")

            # -- deploy and serve images of any size
            dcfg = copy.deepcopy(cfg)
            dcfg.RESUME_CHECKPOINT = ckpt
            det = ObjectDetector(dcfg, device=dev)
            rng = np.random.default_rng(seed)
            img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
            nms_mask.launches = 0
            mixed = [rng.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8)
                     for h, w in zip(rng.integers(240, 481, 32), rng.integers(240, 641, 32))]
            boxes, labels, scores = det.predict(img, threshold=0.01)
            served = det.predict_batch(mixed, threshold=0.01)
            torch.cuda.synchronize()
            out["nms_launches_serve"] = nms_mask.launches
            for b, l, sc in served:
                assert b.shape == (len(l), 4) and np.isfinite(b).all() and np.isfinite(sc).all()
                assert ((l >= 0) & (l < 80)).all()
            # predict's rows against detect on the resized image, kernel and plain NMS
            x = resize_linear(img, det.img_hw)[None]
            with torch.no_grad():
                rows = det.detect_rows(x)
                loc, conf = det.forward(torch.from_numpy(x).to(dev))
                with mock.patch.object(postprocess, "nms_mask", nms_mask_torch):
                    plain_rows = postprocess.detect(loc, conf, det.priors, det.post)
            rows_np = rows[0].cpu().numpy()
            cls, slot = np.nonzero(rows_np[..., 0] > 0.01)
            same_predict = (np.array_equal(labels, cls - 1)
                            and np.array_equal(scores, rows_np[cls, slot, 0])
                            and np.array_equal(boxes, rows_np[cls, slot, 1:5]
                                               * np.float32([640, 480, 640, 480])))
            if not same_predict or not torch.equal(rows, plain_rows):
                raise AssertionError(f"predict on 640x480 != detect on the resized image "
                                     f"({same_predict}) or kernel rows != plain rows")
            log(f"served SSDLite-MobileNetV2-300 COCO on the checkpoint: predict on a 640x480 "
                f"image ({len(scores)} detections at 0.01) equal to detect on the resized image, "
                f"detect rows identical with kernel and plain NMS at batch 1 and "
                f"{len(ebatch['images'])}; "
                "predict_batch x32 of mixed sizes; nms kernel launches "
                f"{out['nms_launches_serve']}")

            # -- times
            out["train_step_ms"] = train_step_ms(solver)
            out["train_img_s"] = int(cfg.TRAIN.BATCH_SIZE) / out["train_step_ms"] * 1e3
            lat, out["predict_batch32_mixed_img_s"] = serve_times(det, img, mixed)
            out["predict_640x480_b1_p50_ms"] = float(np.percentile(lat, 50)) * 1e3
            out["predict_640x480_b1_p90_ms"] = float(np.percentile(lat, 90)) * 1e3
            del det
        finally:
            solver.close()
            if resumed is not None:
                resumed.close()
        out["loader_img_s_native"], workers = loader_img_s(cfg, native_sampler=True)
        out["loader_img_s_python_loop"], _ = loader_img_s(cfg, native_sampler=False)
    b81, b5184 = (nms_times["cases"][f"{m}x{n}/full"] for m, n in COCO_NMS_SHAPES)
    out.update(nms_ms_5184x200=min(b5184["kernel_ms"]),
               nms_plain_ms_5184x200=min(b5184["plain_ms"]),
               nms_bound_ms_5184x200=b5184["bound"]["ms"], nms_ms_81x200=min(b81["kernel_ms"]),
               nms_bound_ms_81x200=b81["bound"]["ms"])
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"SSDLite-MobileNetV2-300 COCO bf16: train step batch {cfg.TRAIN.BATCH_SIZE} (20 steps "
        f"after 3 warm-up, "
        f"upload included) {out['train_step_ms']:.3f} ms, {out['train_img_s']:.1f} img/s; train "
        f"loader at PROB 0.6 over one epoch ({workers} workers) {out['loader_img_s_native']:.1f} "
        f"img/s with the native sampler, {out['loader_img_s_python_loop']:.1f} img/s with the "
        f"Python loop; eval (forward, loss, detect) at batch {cfg.TEST.BATCH_SIZE} "
        f"{out['eval_img_s']:.1f} img/s, "
        f"COCOeval {out['eval_cocoeval_s']:.2f} s (eval) / {out['test_cocoeval_s']:.2f} s (test); "
        f"predict 640x480 batch 1 p50 {out['predict_640x480_b1_p50_ms']:.3f} ms p90 "
        f"{out['predict_640x480_b1_p90_ms']:.3f} ms; predict_batch 32 mixed sizes "
        f"{out['predict_batch32_mixed_img_s']:.1f} img/s; nms kernel [5184, 200] "
        f"{out['nms_ms_5184x200'] * 1e3:.2f} us (device) beside its bound "
        f"{out['nms_bound_ms_5184x200'] * 1e3:.2f} us, plain {out['nms_plain_ms_5184x200']:.3f} "
        f"ms; phase {out['phase_s']:.1f} s ({card})")
    return out


def detector_map(solver, det):
    """mAP of ``det``'s predict function over ``solver``'s test set, through
    the Solver's own eval (its loader, its detection gathering, the
    dataset's VOC eval)."""
    with mock.patch.object(solver, "make_eval_forward", lambda: torch.no_grad()(det.predictor)):
        return solver._run_detection_eval(solver.get_loader("test"))


def check_int8(seed, dev, card, log, checkpoint):
    """Phase 14: int8 serving of SSD300-VGG16 (``MODEL.QUANT: int8``);
    ``checkpoint`` is phase 8's last. Returns the numbers."""
    import dataclasses

    from ssds_tpu_torch import quant
    from ssds_tpu_torch.config import default_config
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.detector import ObjectDetector, Predict
    from ssds_tpu_torch.ops.cuda import int8_conv as cuda_int8
    from ssds_tpu_torch.ops.cuda.nms import nms_mask
    from ssds_tpu_torch.solver import Solver
    from ssds_tpu_torch.tools import int8_bench
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc, write_voc

    t_phase = time.perf_counter()
    out = {"card": card}
    cfg = default_config()  # SSD300-VGG16, VOC, bf16
    cfg.MODEL.QUANT = "int8"
    t0 = time.perf_counter()
    det = ObjectDetector(cfg, device=dev, seed=seed)  # quantised at construction
    out["construct_s"] = time.perf_counter() - t0
    n = out["int8_convs"] = quant.num_quantized(det.model)
    if n != INT8_CONVS or det.dtype != torch.bfloat16:
        raise AssertionError(f"SSD300-VGG16 int8: {n} int8 convs, {det.dtype}")

    # -- the kernels against their plain versions at every quantised shape
    shapes = int8_bench.model_shapes(det.model, det.img_hw, dev) + list(int8_bench.EXTRA_SHAPES)
    bench = int8_bench.run(shapes, INT8_BATCHES, seed, log)
    out["bench"] = bench
    out["shapes"] = len(shapes)

    # -- serving: predict x3 and predict_batch x32 through the int8 kernels
    rng = np.random.default_rng(seed)
    hw = det.img_hw
    singles = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(3)]
    batch32 = list(rng.integers(0, 256, (32, *hw, 3), dtype=np.uint8))
    cuda_int8.quantize_act.launches = cuda_int8.int8_conv.launches = nms_mask.launches = 0
    served = [det.predict(img, threshold=0.01) for img in singles]
    served += det.predict_batch(batch32, threshold=0.01)
    torch.cuda.synchronize()
    out["launches"] = {"quantize_act": cuda_int8.quantize_act.launches,
                       "int8_conv": cuda_int8.int8_conv.launches, "nms_mask": nms_mask.launches}
    if out["launches"]["int8_conv"] != 4 * n or out["launches"]["quantize_act"] != 4 * n \
            or nms_mask.launches <= 0:
        raise AssertionError(f"int8 serving launches {out['launches']}: want {4 * n} a kernel")
    for boxes, labels, scores in served:
        assert boxes.shape == (len(labels), 4) and np.isfinite(boxes).all()
        assert np.isfinite(scores).all() and ((labels >= 0) & (labels < 20)).all()
    log(f"served SSD300-VGG16 int8 ({n} int8 convs, calibrated on 4 random images in "
        f"{out['construct_s']:.1f} s with the model build): predict x3 and predict_batch x32, "
        f"kernel launches {out['launches']}")

    # -- the float32 int8 forward on the card against the CPU (the same quantised state)
    cfg32 = default_config()
    cfg32.MODEL.update(QUANT="int8", HALF_PRECISION=False)
    x = torch.from_numpy(np.stack(singles[:2]))
    with torch.no_grad():
        det32 = ObjectDetector(cfg32, device=dev, seed=seed)
        gpu = [a.cpu() for a in det32.forward(x.to(dev))]
        cpu_model = copy.deepcopy(det32.model).cpu()
        del det32
        cpu = Predict(cpu_model, torch.tensor(cfg32.DATASET.PIXEL_MEANS, dtype=torch.float32),
                      None, None, torch.float32).raw(x)
    for name, g, c in zip(("loc", "conf"), gpu, cpu):
        err, scale = (g - c).abs().max().item(), c.abs().max().item()
        out[f"f32_{name}_max_abs_err"], out[f"f32_{name}_max_abs"] = err, scale
        if not err <= INT8_F32_TOL * scale:
            raise AssertionError(f"int8 float32 forward card vs CPU: {name} max |d| {err} > "
                                 f"{INT8_F32_TOL} x {scale}")
    log(f"SSD300-VGG16 int8 float32 forward, card vs CPU on the same quantised state: loc max|d| "
        f"{out['f32_loc_max_abs_err']:.3e} (max|loc| {out['f32_loc_max_abs']:.3e}), conf max|d| "
        f"{out['f32_conf_max_abs_err']:.3e}; bar {INT8_F32_TOL} of the largest")

    # -- accuracy: int8 against float mAP on phase 8's checkpoint and test set
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.dict(factory.dataset_map, {"voc": in_memory_voc(seed)}):
        root, exp = os.path.join(tmp, "VOCdevkit"), os.path.join(tmp, "exp")
        write_voc(root, seed, TRAIN_IMAGES, TEST_IMAGES)
        tcfg = training_config(root, exp)
        tcfg.RESUME_CHECKPOINT = checkpoint
        solver = Solver(tcfg, device=dev, writer=ScalarWriter(), seed=seed)
        try:
            fdet = ObjectDetector(tcfg, device=dev)
            qcfg = copy.deepcopy(tcfg)
            qcfg.MODEL.QUANT = "int8"
            qdet = ObjectDetector(qcfg, device=dev)
            out["float_map"] = detector_map(solver, fdet)
            out["int8_map"] = detector_map(solver, qdet)
            imgs = solver._upload(next(iter(solver.get_loader("test"))), ("images",))["images"]
            with torch.no_grad():
                out["conf_max_abs_diff_test"] = (fdet.forward(imgs)[1] - qdet.forward(imgs)[1]
                                                 ).abs().max().item()
        finally:
            solver.close()
    log(f"phase 8's checkpoint on the synthetic VOC test set ({TEST_IMAGES} images): float "
        f"(bf16) mAP {out['float_map']:.4f}, int8 mAP {out['int8_map']:.4f}; max |d conf| "
        f"{out['conf_max_abs_diff_test']:.3e} on a test batch")
    if not (0.0 <= out["int8_map"] <= 1.0 and out["int8_map"] >= out["float_map"] - MAP_DROP):
        raise AssertionError(f"int8 mAP {out['int8_map']} more than {MAP_DROP} below float "
                             f"{out['float_map']}")

    # -- times: int8 beside bf16 (the same seeded weights)
    bf16 = ObjectDetector(default_config(), device=dev, seed=seed)
    for name, d in (("int8", det), ("bf16", bf16)):
        lat, ips = serve_times(d, singles[0], batch32)
        out[f"{name}_b1_p50_ms"] = float(np.percentile(lat, 50)) * 1e3
        out[f"{name}_b1_p90_ms"] = float(np.percentile(lat, 90)) * 1e3
        out[f"{name}_batch32_img_s"] = ips
    del bf16
    log(f"serving SSD300-VGG16: int8 batch-1 predict p50 {out['int8_b1_p50_ms']:.3f} ms (p90 "
        f"{out['int8_b1_p90_ms']:.3f}), batch-32 predict_batch {out['int8_batch32_img_s']:.1f} "
        f"img/s; bf16 p50 {out['bf16_b1_p50_ms']:.3f} ms (p90 {out['bf16_b1_p90_ms']:.3f}), "
        f"{out['bf16_batch32_img_s']:.1f} img/s ({card})")

    # -- the exported int8 program, served by a fresh process
    unpruned = Predict(det.model, det.means, det.priors,
                       dataclasses.replace(det.post, pre_nms_top_n=0), det.dtype)
    imgs = np.random.default_rng(seed + 1).integers(
        0, 256, (max(EXPORT_BATCHES), *det.img_hw, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        served_x, rows, out["export_s"], out["artifact_mb"], _ = serve_exported(det, imgs, tmp)
    for b in EXPORT_BATCHES:
        with torch.no_grad():
            want = unpruned(torch.from_numpy(imgs[:b]).to(dev)).cpu().numpy()
        if served_x["int8_launches"][str(b)] != [n, n] or served_x["launches"][str(b)] != 1:
            raise AssertionError(f"the exported int8 program at batch {b} launched "
                                 f"{served_x['int8_launches'][str(b)]} int8 and "
                                 f"{served_x['launches'][str(b)]} NMS kernels")
        if not np.array_equal(rows[b], want):
            raise AssertionError(f"exported int8 rows at batch {b} != the in-process rows")
    out["export_b1_p50_ms"] = float(np.percentile(served_x["lat"], 50)) * 1e3
    out["export_batch32_img_s"] = served_x["img_s"]
    out["export_int8_launches"] = served_x["int8_launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"exported SSD300-VGG16 int8 ({out['artifact_mb']:.1f} MB) served by a fresh process at "
        f"batches {list(EXPORT_BATCHES)}: int8 kernel launches {served_x['int8_launches']}, rows "
        f"identical to the in-process rows; batch-1 p50 {out['export_b1_p50_ms']:.3f} ms, batch "
        f"32 {out['export_batch32_img_s']:.1f} img/s; phase 14 {out['phase_s']:.1f} s ({card})")
    return out


def aug_stats(images, boxes, valid, valid_before):
    """Box survival, centre spread of the survivors, pixel mean and std (the
    drift test's statistics) of an augmented batch (mean-subtracted NHWC)."""
    centers = ((boxes[..., 0:2] + boxes[..., 2:4]) / 2)[valid]
    return {"survival": float(valid.sum() / max(1, valid_before.sum())),
            "center_spread": float(centers.std()), "pixel_mean": float(images.mean()),
            "pixel_std": float(images.std())}


def check_device_aug(seed, dev, card, log, native_img_s):
    """Phase 15: SSDLite-MobileNetV2-300 on the synthetic COCO at ``PROB 0.6``
    with ``DATASET.DEVICE_AUG``, cut as phase 10 (no eval); ``native_img_s``
    is phase 10's loader with the native sampler. Returns the numbers."""
    from ssds_tpu_torch.checkpoint import load_state_dict_file
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.ops import augment_device
    from ssds_tpu_torch.solver import Solver, aug_seed, build_train_step
    from ssds_tpu_torch.tools import time_cuda
    from ssds_tpu_torch.tools.synth_coco import in_memory_coco, write_coco

    t_phase = time.perf_counter()
    out = {"card": card, "loader_img_s_native": native_img_s}
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.dict(factory.dataset_map, {"coco": in_memory_coco(seed)}):
        root, exp = os.path.join(tmp, "coco"), os.path.join(tmp, "exp")
        write_coco(root, seed, COCO_TRAIN_IMAGES, COCO_VAL_IMAGES)
        cfg = coco_config(root, exp)
        cfg.DATASET.DEVICE_AUG = True
        cfg.TRAIN.CHECKPOINTS_EPOCHS = 1
        cfg.PHASE = ["train"]
        prob = float(cfg.DATASET.PROB)
        out["loader_img_s_resize_only"], workers = loader_img_s(cfg, native_sampler=True)

        sample = augment_device.sample_params

        def recorder(into):
            def record(generator, boxes, valid, p):
                into.append(sample(generator, boxes, valid, p))
                return into[-1]
            return record

        draws = []
        writer = ScalarWriter()
        solver = Solver(cfg, device=dev, writer=writer, seed=seed)
        resumed = None
        try:
            if solver.get_loader("train").dataset.preproc.p != -1:
                raise AssertionError("DEVICE_AUG: the train loader still augments on the host")
            t0 = time.perf_counter()
            with mock.patch.object(augment_device, "sample_params", recorder(draws)):
                solver.train_model()
            torch.cuda.synchronize()
            out["train_model_s"] = time.perf_counter() - t0
            out["epoch_loss"] = [l + c for (_, l), (_, c) in zip(writer.scalars["loss_loc"],
                                                                 writer.scalars["loss_conf"])]
            out["steps"] = solver.step
            if not all(np.isfinite(v) for vals in writer.scalars.values() for _, v in vals):
                raise AssertionError(f"a loss is not finite: {writer.scalars}")
            if len(draws) != solver.step or not out["epoch_loss"][-1] < out["epoch_loss"][0]:
                raise AssertionError(f"{len(draws)} augmentations for {solver.step} steps; "
                                     f"epoch losses {out['epoch_loss']}")
            log(f"trained SSDLite-MobileNetV2-300 COCO bf16 batch {cfg.TRAIN.BATCH_SIZE} with "
                f"DEVICE_AUG at PROB {prob}: {solver.step} steps in {out['train_model_s']:.1f} s, "
                f"an augmentation each; epoch mean loss {[round(v, 4) for v in out['epoch_loss']]}")

            # -- resume at the last epoch but one: the same weights and the same draws
            per_epoch = solver.step // COCO_EPOCHS
            last = os.path.join(exp, f"{cfg.CHECKPOINTS_PREFIX}_epoch_{COCO_EPOCHS}.pth")
            os.remove(last)
            resumed = Solver(cfg, device=dev, writer=ScalarWriter(), seed=seed + 1)
            again = []
            with mock.patch.object(augment_device, "sample_params", recorder(again)):
                resumed.restore()
                start = {k: v.clone() for k, v in resumed.model.state_dict().items()}
                resumed.train_model()
            saved = load_state_dict_file(os.path.join(
                exp, f"{cfg.CHECKPOINTS_PREFIX}_epoch_{COCO_EPOCHS - 1}.pth"))
            same_start = all(torch.equal(start[k].cpu(), v.cpu()) for k, v in saved.items())
            same_draws = len(again) == per_epoch and all(
                all(torch.equal(a, b) for a, b in zip(x, y))
                for x, y in zip(draws[-per_epoch:], again))
            out["resume_equal"] = bool(same_start and same_draws)
            if not out["resume_equal"]:
                raise AssertionError(f"resume: start state equal {same_start}, draws equal "
                                     f"{same_draws} ({len(again)} of {per_epoch})")
            log(f"resumed at epoch {COCO_EPOCHS - 1}: the saved weights and running statistics, "
                f"and the {per_epoch} steps' augmentation draws identical to the unbroken run's")

            # -- times: the step with and without the augmentation, the augmentation alone
            host = next(iter(solver.get_loader("train")))
            out["train_step_ms"] = train_step_ms(solver)
            plain = build_train_step(solver.model, solver.priors, solver.optimizer,
                                     solver.lr_schedule, solver.compute_dtype,
                                     cfg.DATASET.PIXEL_MEANS)
            with mock.patch.object(solver, "_train_step", plain):
                out["train_step_no_aug_ms"] = train_step_ms(solver)
            batch = solver._upload(host)
            x = batch["images"].float() - solver.means
            gen = torch.Generator(device=dev)

            def augment():
                gen.manual_seed(aug_seed(0))
                return augment_device.augment_batch(gen, x, batch["boxes"], batch["valid"], prob,
                                                    solver.means)

            out["augment_ms"] = time_cuda(augment, 20)
        finally:
            solver.close()
            if resumed is not None:
                resumed.close()

        # -- the distribution against the host recipe on the same images
        plain_set = factory.load_data(cfg.DATASET, "train", cfg.MODEL.IMAGE_SIZE).dataset
        host_cfg = copy.deepcopy(cfg)
        host_cfg.DATASET.DEVICE_AUG = False
        host_set = factory.load_data(host_cfg.DATASET, "train", cfg.MODEL.IMAGE_SIZE).dataset
        idx = list(range(AUG_STAT_IMAGES))
        max_gt = int(cfg.DATASET.MAX_GT)
        means = np.asarray(cfg.DATASET.PIXEL_MEANS, np.float32)
        resized = factory.detection_collate([plain_set[i] for i in idx], max_gt)
        import random
        random.seed(seed)
        np.random.seed(seed)
        host = factory.detection_collate([host_set[i] for i in idx], max_gt)
        gen = torch.Generator(device=dev).manual_seed(aug_seed(seed))
        img, bx, vd = augment_device.augment_batch(
            gen, torch.from_numpy(resized["images"]).to(dev).float() - torch.from_numpy(means).to(dev),
            torch.from_numpy(resized["boxes"]).to(dev), torch.from_numpy(resized["valid"]).to(dev),
            prob, tuple(cfg.DATASET.PIXEL_MEANS))
        out["stats_device"] = aug_stats(img.cpu().numpy(), bx.cpu().numpy(), vd.cpu().numpy(),
                                        resized["valid"])
        out["stats_host"] = aug_stats(host["images"].astype(np.float32) - means, host["boxes"],
                                      host["valid"], resized["valid"])
    d, h = out["stats_device"], out["stats_host"]
    within = (abs(d["survival"] - h["survival"]) < 0.2 and d["survival"] > 0.5
              and abs(d["center_spread"] - h["center_spread"])
              / max(d["center_spread"], h["center_spread"]) < 0.35
              and abs(d["pixel_mean"] - h["pixel_mean"]) < 25.0
              and abs(d["pixel_std"] - h["pixel_std"]) / max(d["pixel_std"], h["pixel_std"]) < 0.25)
    out["stats_within_bounds"] = within
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"SSDLite-MobileNetV2-300 COCO DEVICE_AUG: train loader (resize only, {workers} workers) "
        f"{out['loader_img_s_resize_only']:.1f} img/s against phase 10's native sampler "
        f"{native_img_s:.1f} img/s; train step batch {cfg.TRAIN.BATCH_SIZE} (upload included) "
        f"{out['train_step_ms']:.3f} ms with the augmentation, {out['train_step_no_aug_ms']:.3f} "
        f"ms without; augment_batch alone {out['augment_ms']:.3f} ms (device); {AUG_STAT_IMAGES} "
        f"images, device / host recipe: survival {d['survival']:.3f} / {h['survival']:.3f}, "
        f"centre spread {d['center_spread']:.3f} / {h['center_spread']:.3f}, pixel mean "
        f"{d['pixel_mean']:.1f} / {h['pixel_mean']:.1f}, std {d['pixel_std']:.1f} / "
        f"{h['pixel_std']:.1f} (tests/test_augment_drift.py's bounds); phase 15 "
        f"{out['phase_s']:.1f} s ({card})")
    if not within:
        raise AssertionError(f"device augmentation statistics outside the drift bounds: {out}")
    return out


def ddp_worker():
    """``tests/torch_port_ddp_worker.py`` (it imports no JAX): the ranks'
    runner of phase 16 and its helpers."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_port_ddp_worker

    return torch_port_ddp_worker


def ddp_launch(args, nproc, timeout=600):
    """``python -m torch.distributed.run --nproc_per_node nproc <args>`` on a
    free port, from the repository; returns the finished process."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
           "--master_addr", "localhost", "--master_port", str(ddp_worker().free_port())] + args
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="4"))


def ddp_layout():
    """``(ranks, device, backend)`` of phases 16b-c: one rank a card on NCCL
    when there are two or more, else two gloo ranks on card 0."""
    count = torch.cuda.device_count()
    return (count, "cuda", "nccl") if count > 1 else (2, DEVICE, "gloo")


def check_ddp_f64(seed, lite, tmp, worker, ranks, ddp_dev, backend, log):
    """Phase 16b: one float64 step of ``lite``'s model, ``ranks`` ranks
    against one on the same card (``tests/torch_port_ddp_worker.py``);
    returns the errors."""
    from ssds_tpu_torch.data.factory import load_data
    from ssds_tpu_torch.models.builder import create_model, create_priors, init_model

    collect, errors, launch = worker.collect, worker.errors, worker.launch
    model, fmaps = create_model(lite.MODEL)
    model = init_model(model, seed=seed)
    loader = load_data(lite.DATASET, "train", image_size=lite.MODEL.IMAGE_SIZE,
                       batch_size=DDP_F64_BATCH)
    batch = next(iter(loader))
    loader.close()
    run = {"lite300": dict(model=lite.MODEL, train_cfg=lite.TRAIN,
                           state_dict=model.state_dict(),
                           priors=create_priors(lite.MODEL, fmaps),
                           batch={k: batch[k] for k in ("images", "boxes", "labels", "valid")},
                           steps=1, means=tuple(lite.DATASET.PIXEL_MEANS))}
    t0 = time.perf_counter()
    started = [launch(tmp, "f64_two", run, ranks, device=ddp_dev, backend=backend),
               launch(tmp, "f64_one", run, 1, device=DEVICE, backend="gloo")]
    two, one = (collect(*st) for st in started)
    loss, upd, _ = errors(two[0]["lite300"]["steps"], one[0]["lite300"]["steps"])[0]
    stat = worker.running_stats_err(two[0]["lite300"]["steps"][-1][2],
                                    one[0]["lite300"]["steps"][-1][2])
    same = all(torch.equal(two[0]["lite300"]["steps"][-1][2][k], r["lite300"]["steps"][-1][2][k])
               for r in two[1:] for k in two[0]["lite300"]["steps"][-1][2])
    out = {"loss_rel_err": loss, "update_err_over_max_update": upd, "stats_rel_err": stat,
           "ranks_equal": same, "s": time.perf_counter() - t0}
    log(f"16b: one float64 step (cuDNN float64) of SSDLite-MobileNetV2-300 at global batch "
        f"{DDP_F64_BATCH}, {ranks} {backend} ranks against 1 rank on {DEVICE}: losses rel "
        f"{loss:.2e} (bound {DDP_F64_LIMITS[0]:g}), largest update error over the largest "
        f"update {upd:.2e} (bound {DDP_F64_LIMITS[1]:g}), running statistics {stat:.2e} "
        f"(a mean in units of its std, a variance relative to itself; bound "
        f"{DDP_F64_LIMITS[2]:g}); ranks' states equal: {same}")
    if not same or not all(e < lim for e, lim in zip((loss, upd, stat), DDP_F64_LIMITS)):
        raise AssertionError(f"16b: the {ranks}-rank float64 step is not the 1-rank step")
    return out


def check_ddp(seed, dev, card, log, before_lifecycle=None):
    """Phase 16: data-parallel SSDLite-MobileNetV2-300 (see the docstring);
    ``before_lifecycle()`` runs before 16c, whose steps are timed."""
    from ssds_tpu_torch.checkpoint import find_previous
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.models.builder import create_model, init_model
    from ssds_tpu_torch.models.layers import BatchNorm
    from ssds_tpu_torch.solver import Solver
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc, write_voc

    worker = ddp_worker()
    t_phase = time.perf_counter()
    ranks, ddp_dev, backend = ddp_layout()
    count = torch.cuda.device_count()
    out = {"card": card, "device_count": count, "ranks": ranks, "backend": backend,
           "device": ddp_dev}
    log(f"phase 16: {count} card(s): 16a the train CLI on {count} NCCL rank(s); 16b-c {ranks} "
        f"{backend} ranks on {'one card each' if count > 1 else 'card 0'}")
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.dict(factory.dataset_map, {"voc": in_memory_voc(seed)}):
        root = os.path.join(tmp, "VOCdevkit")
        write_voc(root, seed, TRAIN_IMAGES, TEST_IMAGES)

        # -- 16a: the train CLI under torch.distributed.run, NCCL, one epoch; it
        # runs while 16b's ranks do (its seconds are the CLI's, not a step's)
        cfg = lite_config(root, os.path.join(tmp, "exp_cli"))
        cfg.TRAIN.update(MAX_EPOCHS=1, CHECKPOINTS_EPOCHS=1)
        cfg.PHASE = ["train"]
        cfg_path = os.path.join(tmp, "cli.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)

        def train_cli():
            t0 = time.perf_counter()
            proc = ddp_launch(["-m", "ssds_tpu_torch.tools.synth_voc", "--seed", str(seed),
                               "--size", "300", "train", "--cfg", cfg_path,
                               "--device", torch.device(DEVICE).type], count)
            return proc, time.perf_counter() - t0

        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            cli = pool.submit(train_cli)
            f64 = check_ddp_f64(seed, lite_config(root, os.path.join(tmp, "exp_f64")), tmp,
                                worker, ranks, ddp_dev, backend, log)
            proc, out["cli_s"] = cli.result()
        out["f64_step"] = f64
        manifest = find_previous(cfg.EXP_DIR)
        if proc.returncode != 0 or manifest is None or manifest[0] != [1]:
            raise AssertionError(f"16a: the train CLI on {count} NCCL rank(s): rc "
                                 f"{proc.returncode}, manifest {manifest}\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        epoch_lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("epoch 1/1")]
        log(f"16a: python -m torch.distributed.run --nproc_per_node {count} -m "
            f"ssds_tpu_torch.tools.synth_voc ... train (the port's train CLI, NCCL): rc 0 in "
            f"{out['cli_s']:.1f} s, manifest {manifest[0]}, {epoch_lines}")

        # -- 16c: the bf16 recipe, DDP_EPOCHS, the last eval merged over the ranks
        if before_lifecycle is not None:
            before_lifecycle()
        lite = lite_config(root, os.path.join(tmp, "exp_ddp"))
        lite.TRAIN.update(MAX_EPOCHS=DDP_EPOCHS, CHECKPOINTS_EPOCHS=1)
        lite.TEST.TEST_SCOPE = [DDP_EPOCHS, DDP_EPOCHS]
        cfg_path = os.path.join(tmp, "ddp.json")
        with open(cfg_path, "w") as f:
            json.dump(lite, f)
        prefix = os.path.join(tmp, "rank")
        t0 = time.perf_counter()
        proc = ddp_launch([os.path.join(REPO, "tests", "torch_port_ddp_worker.py"),
                           "--lifecycle", cfg_path, "--out", prefix, "--device", ddp_dev,
                           "--backend", backend, "--synthetic-voc", f"{seed},300"], ranks)
        out["lifecycle_s"] = time.perf_counter() - t0
        if proc.returncode != 0 or proc.stdout.count("DDP_WORKER_OK") != ranks:
            raise AssertionError(f"16c: the {ranks}-rank lifecycle failed (rc {proc.returncode})"
                                 f"\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        reports, states = [], []
        for r in range(ranks):
            with open(f"{prefix}.{r}.json") as f:
                reports.append(json.load(f))
            states.append(torch.load(f"{prefix}.{r}.pt", map_location="cpu"))
        sc = reports[0]["scalars"]
        values = [v for rep in reports for vals in rep["scalars"].values() for _, v in vals]
        maps = [rep["scalars"]["Eval/mAP"][-1][1] for rep in reports]
        tests = [rep["test_map"] for rep in reports]
        manifest = find_previous(lite.EXP_DIR)
        start = init_model(create_model(lite.MODEL)[0], seed=0).state_dict()
        bns = [n for n, m in create_model(lite.MODEL)[0].named_modules() if isinstance(m, BatchNorm)]
        moved = sum(not torch.equal(states[0][f"{n}.running_var"], start[f"{n}.running_var"])
                    for n in bns)
        equal = all(torch.equal(st[k], states[0][k]) for st in states[1:] for k in states[0])
        out.update(epoch_loss=[l + c for (_, l), (_, c) in zip(sc["loss_loc"], sc["loss_conf"])],
                   eval_map=maps, test_map=tests, manifest_epochs=manifest and manifest[0],
                   bn_running_var_moved=moved, batchnorms=len(bns), rank_states_equal=equal,
                   nms_launches_ranks=sum(rep["nms_launches"] for rep in reports),
                   train_step_ms_ranks=reports[0]["train_step_ms"],
                   allreduce_bn_ms=reports[0].get("allreduce_bn_ms"),
                   allreduce_grads_ms=reports[0].get("allreduce_grads_ms"),
                   eval_img_s_ranks=reports[0]["test_images"] / reports[0]["test_s"])
        log(f"16c: SSDLite-MobileNetV2-300 bf16 at global batch {lite.TRAIN.BATCH_SIZE} on "
            f"{ranks} {backend} ranks, {DDP_EPOCHS} epochs in {out['lifecycle_s']:.1f} s: epoch "
            f"losses {[round(v, 4) for v in out['epoch_loss']]}, eval mAP by rank {maps}, test "
            f"mAP by rank {tests}, manifest epochs {out['manifest_epochs']}, {moved}/{len(bns)} "
            f"BatchNorms' running variance moved, ranks' states equal: {equal}, NMS kernel "
            f"launches in the ranks {out['nms_launches_ranks']}")
        if not all(np.isfinite(values)) or len(set(maps)) != 1 or len(set(tests)) != 1:
            raise AssertionError(f"16c: losses finite {all(np.isfinite(values))}, mAP by rank "
                                 f"{maps}, test mAP by rank {tests}")
        if out["manifest_epochs"] != list(range(1, DDP_EPOCHS + 1)) or moved != len(bns) \
                or len(bns) != LITE_BATCHNORMS or not equal or out["nms_launches_ranks"] <= 0:
            raise AssertionError("16c: manifest, running statistics or NMS launches wrong")

        # one process on the checkpoint: the merged mAP; then the 1-rank step
        one = Solver(lite, device=dev, writer=ScalarWriter(), seed=seed)
        try:
            t0 = time.perf_counter()
            single = one.test_model()
            torch.cuda.synchronize()
            test_s = time.perf_counter() - t0
            loader = one.get_loader("train")
            one.build_state(len(loader))
            one._train_step = one.make_train_step()
            out["train_step_ms_one"] = train_step_ms(one)
        finally:
            one.close()
        out.update(test_map_one=single, map_diff=abs(single - tests[0]),
                   eval_img_s_one=len(one.get_loader("test").dataset) / test_s)
        log(f"16c: a 1-process Solver.test_model on the {ranks}-rank checkpoint: mAP {single:.6f}, "
            f"|merged - single| {out['map_diff']:.2e} (bound {DDP_MAP_TOL:g})")
        if out["map_diff"] > DDP_MAP_TOL:
            raise AssertionError("16c: the merged mAP is not the 1-process mAP")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"16c times ({card}): train step at global batch {lite.TRAIN.BATCH_SIZE}: {ranks} "
        f"{backend} ranks {out['train_step_ms_ranks']:.2f} ms, 1 rank "
        f"{out['train_step_ms_one']:.2f} ms (alone, one {backend} all-reduce of a BatchNorm's "
        f"statistics {out['allreduce_bn_ms']:.3f} ms, of the gradients "
        f"{out['allreduce_grads_ms']:.3f} ms; a step makes {2 * LITE_BATCHNORMS} of the first); "
        f"test_model (forward, merge, VOC eval) "
        f"{out['eval_img_s_ranks']:.1f} img/s on {ranks} ranks, {out['eval_img_s_one']:.1f} img/s "
        f"on 1; phase 16 {out['phase_s']:.1f} s")
    return out


def check_spatial(seed, dev, card, log):
    """Phase 18: SSD300-VGG16 on the spatial axis, 1 x 2 (see the docstring)."""
    from ssds_tpu_torch.checkpoint import find_previous
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.data.factory import load_data
    from ssds_tpu_torch.detector import ObjectDetector
    from ssds_tpu_torch.models.builder import create_model, create_priors, init_model
    from ssds_tpu_torch.solver import Solver
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc, write_voc

    worker = ddp_worker()
    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    ranks, sp_dev, backend = (2, "cuda", "nccl") if count > 1 else (2, DEVICE, "gloo")
    out = {"card": card, "ranks": ranks, "backend": backend, "device": sp_dev}
    log(f"phase 18: the spatial axis, 1 x {ranks}, {backend} ranks on "
        f"{'one card each' if count > 1 else 'card 0'}")
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.dict(factory.dataset_map, {"voc": in_memory_voc(seed)}):
        root = os.path.join(tmp, "VOCdevkit")
        write_voc(root, seed, TRAIN_IMAGES, TEST_IMAGES)

        # -- 18a: one float64 step on 2 bands against one process
        runs = {}
        for name, cfg, batch_size in (
                ("vgg300", training_config(root, os.path.join(tmp, "f64")), SPATIAL_F64_BATCH),
                ("lite300", lite_config(root, os.path.join(tmp, "f64l")), SPATIAL_LITE_F64_BATCH)):
            model, fmaps = create_model(cfg.MODEL)
            loader = load_data(cfg.DATASET, "train", image_size=cfg.MODEL.IMAGE_SIZE,
                               batch_size=batch_size)
            batch = next(iter(loader))
            loader.close()
            runs[name] = dict(model=cfg.MODEL, train_cfg=cfg.TRAIN,
                              state_dict=init_model(model, seed=seed).state_dict(),
                              priors=create_priors(cfg.MODEL, fmaps), steps=1,
                              batch={k: batch[k] for k in ("images", "boxes", "labels", "valid")},
                              means=tuple(cfg.DATASET.PIXEL_MEANS))
        t0 = time.perf_counter()
        banded = {k: dict(r, spatial=ranks) for k, r in runs.items()}
        started = [worker.launch(tmp, "sp_two", banded, ranks, device=sp_dev, backend=backend),
                   worker.launch(tmp, "sp_one", runs, 1, device=DEVICE, backend="gloo")]
        two, one = (worker.collect(*st) for st in started)
        out["f64_s"] = time.perf_counter() - t0
        for name in runs:
            got, want = two[0][name]["steps"], one[0][name]["steps"]
            loss, upd, _ = worker.errors(got, want)[0]
            stat = worker.running_stats_err(got[-1][2], want[-1][2])
            same = all(torch.equal(got[-1][2][k], r[name]["steps"][-1][2][k])
                       for r in two[1:] for k in got[-1][2])
            out[f"f64_step_{name}"] = {
                "loss_rel_err": loss, "update_err_over_max_update": upd, "stats_rel_err": stat,
                "ranks_equal": same, "transfers_rank0": two[0][name]["transfers"]}
            log(f"18a: one float64 step (cuDNN float64) of {name} at batch "
                f"{runs[name]['batch']['images'].shape[0]}, 1 x {ranks} {backend} ranks against "
                f"1 rank on {DEVICE}: losses rel {loss:.2e} (bound {SPATIAL_F64_LIMITS[0]:g}), "
                f"largest update error over the largest update {upd:.2e} (bound "
                f"{SPATIAL_F64_LIMITS[1]:g}), running statistics {stat:.2e} (bound "
                f"{SPATIAL_F64_LIMITS[2]:g}); ranks' states equal: {same}; rank 0's transfers "
                f"{two[0][name]['transfers']}")
            if not same or not all(e < lim for e, lim in
                                   zip((loss, upd, stat), SPATIAL_F64_LIMITS)):
                raise AssertionError(f"18a: the 1 x {ranks} float64 step of {name} is not the "
                                     "1-rank step")

        # -- 18b: the bf16 recipe on 2 bands through the Solver; the checkpoint served
        cfg = training_config(root, os.path.join(tmp, "exp_sp"))
        cfg.TRAIN.update(MAX_EPOCHS=SPATIAL_EPOCHS, CHECKPOINTS_EPOCHS=1)
        cfg.PHASE = ["train"]
        cfg.TPU.MESH.SPATIAL = ranks
        cfg_path = os.path.join(tmp, "spatial.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        prefix = os.path.join(tmp, "rank")
        t0 = time.perf_counter()
        proc = ddp_launch([os.path.join(REPO, "tests", "torch_port_ddp_worker.py"),
                           "--lifecycle", cfg_path, "--out", prefix, "--device", sp_dev,
                           "--backend", backend, "--synthetic-voc", f"{seed},300"], ranks)
        out["lifecycle_s"] = time.perf_counter() - t0
        if proc.returncode != 0 or proc.stdout.count("DDP_WORKER_OK") != ranks:
            raise AssertionError(f"18b: the 1 x {ranks} lifecycle failed (rc {proc.returncode})"
                                 f"\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        reports, states = [], []
        for r in range(ranks):
            with open(f"{prefix}.{r}.json") as f:
                reports.append(json.load(f))
            states.append(torch.load(f"{prefix}.{r}.pt", map_location="cpu"))
        sc = reports[0]["scalars"]
        values = [v for rep in reports for vals in rep["scalars"].values() for _, v in vals]
        equal = all(torch.equal(st[k], states[0][k]) for st in states[1:] for k in states[0])
        start = init_model(create_model(cfg.MODEL)[0], seed=0).state_dict()
        still = [k for k in start if torch.equal(states[0][k], start[k])]
        moved = len(start) - len(still)
        manifest = find_previous(cfg.EXP_DIR)
        rep0 = reports[0]
        out.update(epoch_loss=[l + c for (_, l), (_, c) in zip(sc["loss_loc"], sc["loss_conf"])],
                   test_map=[rep["test_map"] for rep in reports], rank_states_equal=equal,
                   tensors_moved=moved, tensors=len(start),
                   manifest_epochs=manifest and manifest[0],
                   nms_launches_ranks=sum(rep["nms_launches"] for rep in reports),
                   train_step_ms_ranks=rep0["train_step_ms"],
                   transfers_per_step={k: rep0[k] for k in ("halo_messages", "halo_bytes",
                                                            "gather_messages", "gather_bytes")},
                   allreduce_grads_ms=rep0.get("allreduce_grads_ms"))
        log(f"18b: SSD300-VGG16 bf16 at batch {cfg.TRAIN.BATCH_SIZE} on 1 x {ranks} {backend} "
            f"ranks, {SPATIAL_EPOCHS} epoch(s) in {out['lifecycle_s']:.1f} s: epoch losses "
            f"{out['epoch_loss']}, test mAP by rank {out['test_map']}, manifest epochs "
            f"{out['manifest_epochs']}, {moved}/{len(start)} tensors moved (not {still}), ranks' "
            f"states equal: "
            f"{equal} (SSD300-VGG16 has no BatchNorm; 18a holds SSDLite's statistics); a step's "
            f"transfers from rank 0: {out['transfers_per_step']}")
        if not all(np.isfinite(values)) or not equal or "base.0.weight" in still \
                or out["manifest_epochs"] != list(range(1, SPATIAL_EPOCHS + 1)) \
                or len(set(out["test_map"])) != 1 \
                or (torch.device(sp_dev).type == "cuda" and out["nms_launches_ranks"] <= 0):
            raise AssertionError(f"18b: losses finite {all(np.isfinite(values))}, states equal "
                                 f"{equal}, moved {moved}/{len(start)}, manifest "
                                 f"{out['manifest_epochs']}, test mAP {out['test_map']}, NMS "
                                 f"kernel launches {out['nms_launches_ranks']}")
        # one process serves the checkpoint: its weights are rank 0's
        dcfg = copy.deepcopy(cfg)
        dcfg.TPU.MESH.SPATIAL = 1
        dcfg.RESUME_CHECKPOINT = manifest[1][-1]
        det = ObjectDetector(dcfg, device=dev)
        imgs = list(np.random.default_rng(seed).integers(0, 256, (4, 300, 300, 3), np.uint8))
        rows = det.predict_batch(imgs, threshold=0.01)
        served = det.model.state_dict()
        same_weights = all(torch.equal(served[k].cpu(), states[0][k].to(served[k].dtype))
                           for k in states[0])  # bf16 serving casts the convs once
        out.update(served_images=len(rows), served_weights_equal=same_weights)
        log(f"18b: a 1-process ObjectDetector on the checkpoint serves {len(rows)} images; its "
            f"weights are rank 0's (in its serving dtype): {same_weights}")
        if not same_weights or len(rows) != len(imgs):
            raise AssertionError("18b: the checkpoint of the spatial run does not serve")

        # -- 18c: one process, the same recipe: the step's time, with and without REMAT
        one = Solver(dcfg, device=dev, writer=ScalarWriter(), seed=seed)
        try:
            loader = one.get_loader("train")
            one.build_state(len(loader))
            for remat in (False, True):
                one.cfg.TPU.REMAT = remat
                one._train_step = one.make_train_step()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resting = torch.cuda.memory_allocated()
                ms = train_step_ms(one)
                key = "remat" if remat else "plain"
                out[f"train_step_ms_one_{key}"] = ms
                out[f"peak_mb_{key}"] = torch.cuda.max_memory_allocated() / 2**20
                out[f"peak_above_resting_mb_{key}"] = (torch.cuda.max_memory_allocated()
                                                       - resting) / 2**20
        finally:
            one.close()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"18c ({card}): SSD300-VGG16 bf16 train step at batch {cfg.TRAIN.BATCH_SIZE}: 1 x {ranks} "
        f"{backend} ranks {out['train_step_ms_ranks']:.2f} ms (gloo stages every halo through "
        f"the host; the ranks time-share the card), 1 process {out['train_step_ms_one_plain']:.2f} "
        f"ms; TPU.REMAT in 1 process: {out['train_step_ms_one_remat']:.2f} ms, peak "
        f"{out['peak_mb_remat']:.0f} MiB ({out['peak_above_resting_mb_remat']:.0f} above the "
        f"resting state) against {out['peak_mb_plain']:.0f} MiB "
        f"({out['peak_above_resting_mb_plain']:.0f}) without; phase 18 {out['phase_s']:.1f} s")
    return out


def check_spatial_heads(seed, dev, card, log):
    """Phase 19: FSSD and YOLO on the spatial axis, 1 x 2 (see the docstring)."""
    from ssds_tpu_torch.checkpoint import find_previous
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.data.factory import load_data
    from ssds_tpu_torch.detector import ObjectDetector
    from ssds_tpu_torch.models.builder import create_model, create_priors, init_model, is_yolo
    from ssds_tpu_torch.ops import postprocess
    from ssds_tpu_torch.ops.cuda.nms import nms_mask
    from ssds_tpu_torch.ops.nms import nms_mask_torch
    from ssds_tpu_torch.solver import Solver
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc, write_voc

    worker = ddp_worker()
    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    ranks, sp_dev, backend = (2, "cuda", "nccl") if count > 1 else (2, DEVICE, "gloo")
    out = {"card": card, "ranks": ranks, "backend": backend, "device": sp_dev}
    log(f"phase 19: FSSD and YOLO on the spatial axis, 1 x {ranks}, {backend} ranks on "
        f"{'one card each' if count > 1 else 'card 0'}")
    makers = {"fssd": head_config("fssd"), "yolo_v3": yolo_config("yolo_v3"),
              "yolo_v2": yolo_config("yolo_v2")}
    with tempfile.TemporaryDirectory() as tmp:
        # -- 19a: one float64 step of each model on 2 bands against one process
        runs = {}
        for name, make in makers.items():
            root = os.path.join(tmp, f"voc_{name}")
            cfg = make(root, os.path.join(tmp, f"f64_{name}"))
            size = int(cfg.MODEL.IMAGE_SIZE[0])
            write_voc(root, seed, SPATIAL_HEADS_F64_BATCH, 0, size=size)
            with mock.patch.dict(factory.dataset_map, {"voc": in_memory_voc(seed, size)}):
                loader = load_data(cfg.DATASET, "train", image_size=cfg.MODEL.IMAGE_SIZE,
                                   batch_size=SPATIAL_HEADS_F64_BATCH)
                batch = next(iter(loader))
                loader.close()
            model, fmaps = create_model(cfg.MODEL)
            priors = None if is_yolo(cfg.MODEL) else create_priors(cfg.MODEL, fmaps)
            runs[name] = dict(model=cfg.MODEL, train_cfg=cfg.TRAIN,
                              state_dict=init_model(model, seed=seed).state_dict(),
                              priors=priors, steps=1, compact=True,
                              batch={k: batch[k] for k in ("images", "boxes", "labels", "valid")},
                              means=tuple(cfg.DATASET.PIXEL_MEANS))
        t0 = time.perf_counter()
        banded = {k: dict(r, spatial=ranks) for k, r in runs.items()}
        started = [worker.launch(tmp, "sph_two", banded, ranks, device=sp_dev, backend=backend),
                   worker.launch(tmp, "sph_one", runs, 1, device=DEVICE, backend="gloo")]
        two, one = (worker.collect(*st) for st in started)
        out["f64_s"] = time.perf_counter() - t0
        for name, run in runs.items():
            got, want = (worker.expand(run, r[0][name]) for r in (two, one))
            loss, upd, _ = worker.errors(got, want)[0]
            stat = worker.running_stats_err(got[-1][2], want[-1][2])
            same = len({r[name]["last_digest"] for r in two}) == 1
            moved = sum(not torch.equal(got[-1][2][k], got[0][2][k]) for k in got[0][2])
            transfers = two[0][name]["transfers"]
            out[f"f64_step_{name}"] = {
                "loss_rel_err": loss, "update_err_over_max_update": upd, "stats_rel_err": stat,
                "ranks_equal": same, "tensors_moved": moved, "transfers_rank0": transfers}
            log(f"19a: one float64 step (cuDNN float64) of {SPATIAL_HEADS[name]} at batch "
                f"{SPATIAL_HEADS_F64_BATCH}, 1 x {ranks} {backend} ranks against 1 rank on "
                f"{DEVICE}: losses rel {loss:.2e} (bound {SPATIAL_F64_LIMITS[0]:g}), largest "
                f"update error over the largest update {upd:.2e} (bound "
                f"{SPATIAL_F64_LIMITS[1]:g}), running statistics {stat:.2e} (bound "
                f"{SPATIAL_F64_LIMITS[2]:g}); ranks' states equal: {same}; {moved} tensors "
                f"moved; rank 0's transfers {transfers}")
            if not same or not moved or not all(e < lim for e, lim in
                                                zip((loss, upd, stat), SPATIAL_F64_LIMITS)):
                raise AssertionError(f"19a: the 1 x {ranks} float64 step of {name} is not the "
                                     "1-rank step")
        del two, one, runs, banded

        # -- 19b: YOLOv3's bf16 recipe on 2 bands through the Solver; the checkpoint served
        root = os.path.join(tmp, "voc_yolo_v3")
        cfg = makers["yolo_v3"](root, os.path.join(tmp, "exp_sph"))
        size = int(cfg.MODEL.IMAGE_SIZE[0])
        write_voc(root, seed, TRAIN_IMAGES, TEST_IMAGES, size=size)
        cfg.TRAIN.update(MAX_EPOCHS=SPATIAL_EPOCHS, CHECKPOINTS_EPOCHS=1)
        # a config file's key takes its default's type: an int (2587.5 -> 2588)
        cfg.TRAIN.LR_SCHEDULER.WARM_UP_EPOCHS = round(cfg.TRAIN.LR_SCHEDULER.WARM_UP_EPOCHS)
        cfg.PHASE = ["train"]
        cfg.TPU.MESH.SPATIAL = ranks
        cfg_path = os.path.join(tmp, "spatial_heads.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        prefix = os.path.join(tmp, "rank")
        t0 = time.perf_counter()
        proc = ddp_launch([os.path.join(REPO, "tests", "torch_port_ddp_worker.py"),
                           "--lifecycle", cfg_path, "--out", prefix, "--device", sp_dev,
                           "--backend", backend, "--synthetic-voc", f"{seed},{size}"], ranks)
        out["lifecycle_s"] = time.perf_counter() - t0
        if proc.returncode != 0 or proc.stdout.count("DDP_WORKER_OK") != ranks:
            raise AssertionError(f"19b: the 1 x {ranks} lifecycle failed (rc {proc.returncode})"
                                 f"\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        reports, states = [], []
        for r in range(ranks):
            with open(f"{prefix}.{r}.json") as f:
                reports.append(json.load(f))
            states.append(torch.load(f"{prefix}.{r}.pt", map_location="cpu"))
        sc = reports[0]["scalars"]
        values = [v for rep in reports for vals in rep["scalars"].values() for _, v in vals]
        equal = all(torch.equal(st[k], states[0][k]) for st in states[1:] for k in states[0])
        start = init_model(create_model(cfg.MODEL)[0], seed=0).state_dict()
        still = [k for k in start if torch.equal(states[0][k], start[k])]
        manifest = find_previous(cfg.EXP_DIR)
        rep0 = reports[0]
        out.update(epoch_loss=[l + c for (_, l), (_, c) in zip(sc["loss_loc"], sc["loss_conf"])],
                   test_map=[rep["test_map"] for rep in reports], rank_states_equal=equal,
                   tensors_moved=len(start) - len(still), tensors=len(start),
                   manifest_epochs=manifest and manifest[0],
                   nms_launches_ranks=sum(rep["nms_launches"] for rep in reports),
                   train_step_ms_ranks=rep0["train_step_ms"],
                   transfers_per_step={k: rep0[k] for k in ("halo_messages", "halo_bytes",
                                                            "gather_messages", "gather_bytes")},
                   allreduce_grads_ms=rep0.get("allreduce_grads_ms"))
        log(f"19b: YOLOv3-DarkNet53-416 bf16 at batch {cfg.TRAIN.BATCH_SIZE} on 1 x {ranks} "
            f"{backend} ranks, {SPATIAL_EPOCHS} epoch(s) in {out['lifecycle_s']:.1f} s: epoch "
            f"losses {out['epoch_loss']}, test mAP by rank {out['test_map']}, manifest epochs "
            f"{out['manifest_epochs']}, {out['tensors_moved']}/{len(start)} tensors moved, "
            f"ranks' states equal: {equal}; NMS kernel launches in the ranks' test "
            f"{out['nms_launches_ranks']}; a step's transfers from rank 0: "
            f"{out['transfers_per_step']}")
        if not all(np.isfinite(values)) or not equal or "base.0.0.weight" in still \
                or "conf0.weight" in still \
                or out["manifest_epochs"] != list(range(1, SPATIAL_EPOCHS + 1)) \
                or len(set(out["test_map"])) != 1 \
                or (torch.device(sp_dev).type == "cuda" and out["nms_launches_ranks"] <= 0):
            raise AssertionError(f"19b: losses finite {all(np.isfinite(values))}, states equal "
                                 f"{equal}, still {still[:8]}, manifest {out['manifest_epochs']}, "
                                 f"test mAP {out['test_map']}, NMS kernel launches "
                                 f"{out['nms_launches_ranks']}")
        # one process serves the checkpoint: its weights are rank 0's; NMS through detect_decoded
        dcfg = copy.deepcopy(cfg)
        dcfg.TPU.MESH.SPATIAL = 1
        dcfg.RESUME_CHECKPOINT = manifest[1][-1]
        det = ObjectDetector(dcfg, device=dev)
        imgs = list(np.random.default_rng(seed).integers(0, 256, (4, size, size, 3), np.uint8))
        nms_mask.launches = 0
        served = det.predict_batch(imgs, threshold=0.01)
        torch.cuda.synchronize()
        out["nms_launches_serve"] = nms_mask.launches
        served_sd = det.model.state_dict()
        same_weights = all(torch.equal(served_sd[k].cpu(), states[0][k].to(served_sd[k].dtype))
                           for k in states[0])  # bf16 serving casts the convs once
        x = torch.from_numpy(np.stack(imgs)).to(dev)
        with torch.no_grad():
            raw = det.forward(x)
            rows = det.postprocess(raw)
            with mock.patch.object(postprocess, "nms_mask", nms_mask_torch):
                plain_rows = det.postprocess(raw)
        identical = rows.shape == plain_rows.shape and bool(
            ((rows == plain_rows) | (rows.isnan() & plain_rows.isnan())).all())
        out.update(served_images=len(served), served_weights_equal=same_weights,
                   served_boxes=int(raw[0].shape[1]), served_rows_identical=identical,
                   served_rows_finite_share=float(torch.isfinite(rows).float().mean()))
        log(f"19b: a 1-process ObjectDetector on the checkpoint serves {len(served)} images "
            f"({out['served_boxes']} decoded boxes an image, NMS kernel launches "
            f"{out['nms_launches_serve']} through detect_decoded); its weights are rank 0's (in "
            f"its serving dtype): {same_weights}; detect rows identical with the kernel and the "
            f"plain NMS: {identical} (NaN taken as equal to NaN; the finite share of the rows "
            f"{out['served_rows_finite_share']:.4f}: one epoch leaves DarkNet-53's running "
            "statistics near their init, which phase 12 saw blow the raw outputs up)")
        if not same_weights or len(served) != len(imgs) or not identical \
                or out["nms_launches_serve"] <= 0 or out["served_boxes"] != YOLO["yolo_v3"][0]:
            raise AssertionError("19b: the checkpoint of the spatial run does not serve")
        del det

        # -- 19c: one process, the same recipe: the step's time
        one = Solver(dcfg, device=dev, writer=ScalarWriter(), seed=seed)
        try:
            with mock.patch.dict(factory.dataset_map, {"voc": in_memory_voc(seed, size)}):
                loader = one.get_loader("train")
                one.build_state(len(loader))
                one._train_step = one.make_train_step()
                out["train_step_ms_one"] = train_step_ms(one)
        finally:
            one.close()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"19c ({card}): YOLOv3-DarkNet53-416 bf16 train step at batch {cfg.TRAIN.BATCH_SIZE}: "
        f"1 x {ranks} {backend} ranks {out['train_step_ms_ranks']:.2f} ms (the ranks time-share "
        f"the card; gloo stages every halo through the host), 1 process "
        f"{out['train_step_ms_one']:.2f} ms, ratio "
        f"{out['train_step_ms_ranks'] / out['train_step_ms_one']:.2f}; the gradients' "
        f"all-reduce alone {out['allreduce_grads_ms']:.2f} ms; phase 19 {out['phase_s']:.1f} s")
    return out


# a CLI as ``python -m`` runs it, in this process: then the NMS kernel's
# launches, whether PyYAML was loaded ("noyaml" hides it first) and the seconds
PARITY_CLI = r"""
import json, runpy, sys, time
t0 = time.perf_counter()
if sys.argv[1] == "noyaml":
    sys.modules["yaml"] = None  # as on a machine without PyYAML
from ssds_tpu_torch.ops.cuda.nms import nms_mask
module, sys.argv = sys.argv[2], sys.argv[2:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
print(json.dumps({"nms_launches": nms_mask.launches, "yaml": sys.modules.get("yaml") is not None,
                  "s": time.perf_counter() - t0}))
"""


def parity_cli(args, tmp, name, noyaml=False):
    """Start ``python -m <args>`` through ``PARITY_CLI`` in a fresh process,
    its output to files in ``tmp``; returns ``(process, stdout path, stderr
    path)``."""
    paths = [os.path.join(tmp, f"{name}.{s}") for s in ("out", "err")]
    with open(paths[0], "w") as out, open(paths[1], "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", PARITY_CLI,
                                 "noyaml" if noyaml else "-", *args],
                                stdout=out, stderr=err, cwd=REPO,
                                env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    return proc, *paths


def start_parity_clis(tmp):
    """Phase 20c-e: start ``--selftest``, ``--when-data --table-only`` (PyYAML
    hidden) and ``export --check`` of SSD300-VGG16 in fresh processes, their
    files in ``tmp``; returns ``{name: parity_cli(...)}``."""
    from ssds_tpu_torch.config import default_config

    vgg_json = os.path.join(tmp, "ssd_vgg16_default.json")
    with open(vgg_json, "w") as f:
        json.dump(default_config(), f)
    return {
        "selftest": parity_cli(["ssds_tpu_torch.tools.parity_check", "--selftest",
                                "--device", "cuda"], tmp, "selftest"),
        "table": parity_cli(["ssds_tpu_torch.tools.parity_check", "--when-data",
                             "--table-only", "--device", "cuda"], tmp, "table", noyaml=True),
        "export": parity_cli(["ssds_tpu_torch.export", "--cfg", vgg_json, "--out",
                              os.path.join(tmp, "served"), "--device", "cuda", "--check"],
                             tmp, "export"),
    }


def wait_parity_clis(started):
    """Wait (up to ``PARITY_TIMEOUT`` each) for :func:`start_parity_clis`'
    processes to exit, reading nothing."""
    for proc, _, _ in started.values():
        try:
            proc.wait(timeout=PARITY_TIMEOUT)
        except subprocess.TimeoutExpired:
            pass  # parity_result reports it


def parity_result(started, what):
    """Wait for a :func:`parity_cli` process; raise unless it exited 0.
    Returns ``(stdout, its last line as JSON)``."""
    proc, out, err = started
    try:
        rc = proc.wait(timeout=PARITY_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"{what}: no exit within {PARITY_TIMEOUT} s")
    with open(out) as f, open(err) as e:
        stdout, stderr = f.read(), e.read()
    if rc != 0:
        raise AssertionError(f"{what}: rc {rc}\n{stdout[-3000:]}\n{stderr[-3000:]}")
    return stdout, json.loads(stdout.strip().splitlines()[-1])


def check_parity(seed, dev, card, log, checkpoint, test_map, started=None):
    """Phase 20: the mAP-parity harness (``ssds_tpu_torch.tools.parity_check``)
    on phase 8's checkpoint (``checkpoint``; its resumed ``test_model`` mAP
    ``test_map``) and test set, its self-test and acceptance table in fresh
    processes, and the export CLI's ``--check``: those three
    :func:`start_parity_clis` ``started`` (``main`` starts them with phase 16,
    whose 16a-b time nothing), or starts now. Returns the numbers."""
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.ops.cuda.nms import nms_mask
    from ssds_tpu_torch.tools import parity_check
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc, write_voc

    t_phase = time.perf_counter()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        if started is None:  # c-e: fresh processes, started together, while a-b run here
            started = start_parity_clis(tmp)
        # a. stage 1 on phase 8's checkpoint, the config as JSON (no PyYAML)
        root, exp = os.path.join(tmp, "VOCdevkit"), os.path.join(tmp, "exp")
        write_voc(root, seed, TRAIN_IMAGES, TEST_IMAGES)
        cfg_path = os.path.join(tmp, "ssd_vgg16_synthetic.json")
        with open(cfg_path, "w") as f:
            json.dump(training_config(root, exp), f)
        cfg = parity_check.load_cfg(cfg_path)
        t0 = time.perf_counter()
        sd, audit = parity_check.stage_import(cfg, checkpoint)
        out["audit"] = {g: len(getattr(audit, g)) for g in audit._fields}
        out["stage1_s"] = time.perf_counter() - t0
        if not audit.healthy:
            raise AssertionError(f"stage 1 on phase 8's checkpoint is unhealthy: {out['audit']}")
        # b. stage 3 on phase 8's synthetic test set
        t0 = time.perf_counter()
        with mock.patch.dict(factory.dataset_map, {"voc": in_memory_voc(seed)}):
            nms_mask.launches = 0
            out["stage3_map"] = parity_check.stage_map(cfg, sd, dev)
            torch.cuda.synchronize()
            out["nms_launches_stage3"] = nms_mask.launches
        out["stage3_s"] = time.perf_counter() - t0
        out["test_map_phase8"] = test_map
        out["map_diff"] = abs(out["stage3_map"] - test_map)
        log(f"parity stage 1 on phase 8's checkpoint: {out['audit']} (healthy) in "
            f"{out['stage1_s']:.1f} s; stage 3 on its {TEST_IMAGES} test images: mAP "
            f"{out['stage3_map']:.4f} against phase 8's test_model {test_map:.4f} (|d| "
            f"{out['map_diff']:.2e}, tolerance {parity_check.MAP_TOLERANCE}), "
            f"{out['nms_launches_stage3']} nms kernel launches, {out['stage3_s']:.1f} s")
        if out["map_diff"] > parity_check.MAP_TOLERANCE or out["nms_launches_stage3"] <= 0:
            raise AssertionError(f"parity stage 3: mAP {out['stage3_map']} against {test_map}, "
                                 f"{out['nms_launches_stage3']} nms launches")
        # c. the self-test on SSD300-VGG16, d. the table without PyYAML, e. export --check
        stdout, res = parity_result(started["selftest"], "parity_check --selftest")
        if "selftest OK" not in stdout or res["nms_launches"] <= 0:
            raise AssertionError(f"parity_check --selftest: {res}\n{stdout[-2000:]}")
        out["nms_launches_selftest"], clis_s = res["nms_launches"], [res["s"]]
        stdout, res = parity_result(started["table"], "parity_check --when-data --table-only")
        rows = [ln for ln in stdout.splitlines() if ln.startswith("   ok   ")]
        if len(rows) != len(parity_check.ACCEPTANCE) or res["yaml"] or "(no PyYAML)" not in rows[0]:
            raise AssertionError(f"the acceptance table: {len(rows)} rows, PyYAML {res['yaml']}"
                                 f"\n{stdout[-3000:]}")
        out["table_rows"] = len(rows)
        clis_s.append(res["s"])
        stdout, res = parity_result(started["export"], "export --check")
        check = [ln for ln in stdout.splitlines() if ln.startswith("check ok")]
        if not check:
            raise AssertionError(f"export --check printed no 'check ok':\n{stdout[-2000:]}")
        out["export_check"], out["clis_s"] = check[-1], max(clis_s + [res["s"]])
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parity --selftest (SSD300-VGG16, fresh process): selftest OK, "
        f"{out['nms_launches_selftest']} nms kernel launches; --when-data --table-only without "
        f"PyYAML: {out['table_rows']} rows built at full width; export --check: "
        f"{out['export_check']}; the slowest of the three processes {out['clis_s']:.1f} s; "
        f"phase 20 {out['phase_s']:.1f} s ({card})")
    return out


def check_observability(seed, dev, card, log):
    """Phase 17: ``utils.profiler`` and ``Solver.visualize_epoch`` on SSD300-VGG16."""
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.detector import ObjectDetector
    from ssds_tpu_torch.ops.cuda.nms import nms_mask
    from ssds_tpu_torch.solver import Solver
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc, write_voc
    from ssds_tpu_torch.utils import profiler

    t_phase = time.perf_counter()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.dict(factory.dataset_map, {"voc": in_memory_voc(seed)}):
        root, exp = os.path.join(tmp, "VOCdevkit"), os.path.join(tmp, "exp")
        write_voc(root, seed, TRAIN_IMAGES, TEST_IMAGES)
        cfg = training_config(root, exp)
        writer = ScalarWriter()
        solver = Solver(cfg, device=dev, writer=writer, seed=seed)
        try:
            loader = solver.get_loader("train")
            solver.build_state(len(loader))
            step = solver._train_step = solver.make_train_step()
            host = next(iter(loader))
            for _ in range(2):  # warm-up
                step(solver._upload(host), solver.step)
            torch.cuda.synchronize()
            with profiler.trace(os.path.join(tmp, "trace"), name="train") as prof:
                for _ in range(3):
                    with profiler.annotate("train_step"):
                        step(solver._upload(host), solver.step)
            train_trace = trace_summary(prof.trace_path)
            det = ObjectDetector(cfg, device=dev, seed=seed)
            imgs = list(np.random.default_rng(seed).integers(0, 256, (32, 300, 300, 3), np.uint8))
            det.predict_batch(imgs, threshold=0.01)
            nms_mask.launches = 0
            with profiler.trace(os.path.join(tmp, "trace"), name="predict") as prof:
                with profiler.annotate("predict_batch"):
                    det.predict_batch(imgs, threshold=0.01)
            serve_trace = trace_summary(prof.trace_path)
            out["nms_launches_traced"] = nms_mask.launches
            out["train_trace"], out["serve_trace"] = train_trace, serve_trace
            log(f"17: torch.profiler trace of 3 SSD300-VGG16 train steps: {train_trace['spans']} "
                f"'train_step' spans, {train_trace['kernels']} card kernel events, "
                f"{train_trace['mb']:.1f} MB; of predict_batch x32: {serve_trace['kernels']} "
                f"card kernel events, NMS kernel events {serve_trace['nms_kernels']} "
                f"(launches {out['nms_launches_traced']})")
            if train_trace["spans"] != 3 or train_trace["kernels"] <= 0 or \
                    serve_trace["spans"] != 1 or serve_trace["nms_kernels"] <= 0:
                raise AssertionError(f"17: the traces lack the spans or kernels: {out}")

            # timed against CUDA events around the same 5 steps
            results = {}
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            with profiler.timed("steps", results):
                start.record()
                for _ in range(5):
                    step(solver._upload(host), solver.step)
                end.record()
            events_s = start.elapsed_time(end) / 1e3
            out.update(timed_s=results["steps"], events_s=events_s,
                       timed_rel_diff=abs(results["steps"] - events_s) / events_s)
            log(f"17: profiler.timed {results['steps'] * 1e3:.2f} ms against CUDA events "
                f"{events_s * 1e3:.2f} ms over 5 train steps: {out['timed_rel_diff']:.2%} apart "
                f"(bound {TIMED_RTOL:.0%}) ({card})")
            if out["timed_rel_diff"] > TIMED_RTOL:
                raise AssertionError("17: profiler.timed disagrees with CUDA events")

            # visualize_epoch through a recording writer
            solver.visualize_epoch(1)
            tags = [t for t, *_ in writer.images]
            levels = len(solver.feature_maps)
            n_params = len(list(solver.model.parameters()))
            trainable = sum(p.requires_grad for p in solver.model.parameters())
            out.update(images=len(tags), histograms=len(writer.histograms), parameters=n_params)
            want = ({"priors/center_cells"} | {f"priors/level{k}" for k in range(levels)}
                    | {f"samples/{i}" for i in range(8)}
                    | {f"features/level{k}" for k in range(levels)}
                    | {f"features/level{k}/channels" for k in range(levels)})
            log(f"17: visualize_epoch wrote {len(tags)} images ({levels} prior levels, 8 samples, "
                f"{levels} feature-map grids and heatmaps) and {len(writer.histograms)} gradient "
                f"histograms for {n_params} parameters ({trainable} trainable)")
            if set(tags) != want or len(tags) != len(want) or len(writer.histograms) != n_params \
                    or trainable != n_params:
                raise AssertionError(f"17: visualize_epoch wrote {sorted(tags)}, "
                                     f"{len(writer.histograms)} histograms")
        finally:
            solver.close()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 17 {out['phase_s']:.1f} s")
    return out


def trace_summary(path):
    """A Chrome trace's size, ``train_step`` / ``predict_batch`` spans, card
    kernel events and NMS kernel events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"mb": os.path.getsize(path) / 1e6,
            "spans": sum(e.get("name") in ("train_step", "predict_batch") and
                         e.get("cat") == "user_annotation" for e in events),
            "kernels": len(kernels),
            "nms_kernels": sum("nms_mask_kernel" in e.get("name", "") for e in kernels)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="weights, images and NMS sets")
    parser.add_argument("--report", default="",
                        help="also write every number of the run to this JSON file")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    # -- 1. inventory ---------------------------------------------------------
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: this script needs a GPU")
    from ssds_tpu_torch.tools import card_line

    card = card_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"device: {kind} x{count}; nvidia-smi name, power.limit: {card}")
    # Every float32 comparison below runs in full float32: cuDNN's TF32 default is off.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN and matmul (float32 comparisons are in full float32)")
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)

    from ssds_tpu_torch.config import default_config
    from ssds_tpu_torch.detector import ObjectDetector
    from ssds_tpu_torch.ops import postprocess
    from ssds_tpu_torch.ops.cuda import _build
    from ssds_tpu_torch.ops.cuda.nms import nms_mask
    from ssds_tpu_torch.ops.nms import nms_mask_torch

    report = {"card": card, "kind": kind, "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {os.path.relpath(_build.build_info['path'], REPO)} in {report['build_s']:.2f} s "
        f"(nvcc {_build.build_info.get('seconds', 0.0):.2f} s)")
    log(_build.build_info.get("ptxas", "(library was already built: no ptxas report)"))

    # -- 3. kernel against its plain version -----------------------------------
    nms_err = check_nms_kernel(nms_mask, nms_mask_torch, args.seed)

    # -- 4. the slice serving requests -----------------------------------------
    cfg = default_config()  # SSD300-VGG16, VOC, bf16 forward
    det = ObjectDetector(cfg, device=dev, seed=args.seed)
    assert det.priors.shape == (SSD300_PRIORS, 4) and det.dtype == torch.bfloat16
    hw = det.img_hw
    rng = np.random.default_rng(args.seed)
    singles = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(3)]
    batch4 = list(rng.integers(0, 256, (4, *hw, 3), dtype=np.uint8))
    batch32 = list(rng.integers(0, 256, (32, *hw, 3), dtype=np.uint8))

    nms_mask.launches = 0
    served = [det.predict(img, threshold=0.01) for img in singles]
    served4 = det.predict_batch(batch4, threshold=0.01)
    served32 = det.predict_batch(batch32, threshold=0.01)
    torch.cuda.synchronize()
    launches = nms_mask.launches
    log(f"served: predict x3, predict_batch x4, predict_batch x32; nms kernel launches {launches}")
    if launches <= 0:
        raise AssertionError("the serving path never launched the NMS kernel")
    for boxes, labels, scores in served + served4 + served32:
        assert boxes.ndim == 2 and boxes.shape[1] == 4 and len(labels) == len(scores) == len(boxes)
        assert np.isfinite(boxes).all() and np.isfinite(scores).all()
        assert ((labels >= 0) & (labels < 20)).all()
    log(f"detections per image (threshold 0.01): batch 1 {[len(s[2]) for s in served]}, "
        f"batch 4 {[len(s[2]) for s in served4]}, batch 32 min/max "
        f"{min(len(s[2]) for s in served32)}/{max(len(s[2]) for s in served32)}")

    # the same loc / conf through detect with the kernel and with the plain NMS
    for name, imgs in (("batch 1", singles[:1]), ("batch 32", batch32)):
        x = torch.from_numpy(np.stack(imgs)).to(dev)
        with torch.no_grad():
            loc, conf = det.forward(x)
            rows = postprocess.detect(loc, conf, det.priors, det.post)
            with mock.patch.object(postprocess, "nms_mask", nms_mask_torch):
                plain_rows = postprocess.detect(loc, conf, det.priors, det.post)
        assert rows.shape == (len(imgs), 21, 100, 5) and torch.isfinite(rows).all()
        if not torch.equal(rows, plain_rows):
            raise AssertionError(f"{name}: detect rows with the kernel != with the plain NMS")
        filled = (rows[..., 0] > 0).sum(-1)[:, 1:]
        log(f"{name}: detect rows identical with kernel and plain NMS; "
            f"kept per class slot min/max {filled.min().item()}/{filled.max().item()}")

    # float32 forward on the card against the CPU
    cfg32 = default_config()
    cfg32.MODEL.HALF_PRECISION = False
    x = torch.from_numpy(np.stack(singles[:2]))
    with torch.no_grad():
        det32 = ObjectDetector(cfg32, device=dev, seed=args.seed)
        gpu_loc, gpu_conf = (a.cpu() for a in det32.forward(x.to(dev)))
        del det32
        cpu_loc, cpu_conf = ObjectDetector(cfg32, device="cpu", seed=args.seed).forward(x)
    loc_err = (gpu_loc - cpu_loc).abs().max().item()
    conf_err = (gpu_conf - cpu_conf).abs().max().item()
    log(f"float32 forward, card vs CPU: loc max|d| {loc_err:.3e} (max|loc| "
        f"{cpu_loc.abs().max().item():.3e}), conf max|d| {conf_err:.3e}")
    torch.testing.assert_close(gpu_loc, cpu_loc, rtol=F32_RTOL, atol=F32_ATOL)
    torch.testing.assert_close(gpu_conf, cpu_conf, rtol=F32_RTOL, atol=F32_ATOL)
    report.update(f32_loc_max_abs_err=loc_err, f32_conf_max_abs_err=conf_err)

    # -- 5. times ---------------------------------------------------------------
    from ssds_tpu_torch.tools import nms_bench

    nms_times = nms_bench.run(sets=("full",), seed=args.seed, log=log)["cases"]
    report["nms_bench"] = nms_times

    lat, ips = serve_times(det, singles[0], batch32)
    p50 = float(np.percentile(lat, 50)) * 1e3
    log(f"serving SSD300-VGG16 bf16: batch-1 predict p50 {p50:.3f} ms "
        f"(p90 {float(np.percentile(lat, 90)) * 1e3:.3f} ms, 50 requests); batch-32 "
        f"predict_batch {ips:.1f} img/s (10 batches) ({card})")
    report.update(predict_b1_p50_ms=p50, predict_b1_lat_ms=[t * 1e3 for t in lat],
                  predict_batch32_img_s=ips, nms_launches_main_path=launches,
                  nms_max_abs_err=nms_err)

    # -- 6. the conv kernel against its plain version ------------------------
    conv_err = check_conv_kernel(args.seed)

    # -- 7. the conv-prototype path ------------------------------------------
    from ssds_tpu_torch.ops.cuda import conv as cuda_conv
    from ssds_tpu_torch.ops.cuda.stencil import row_stencil
    from ssds_tpu_torch.ops.stencil import PROBES
    from ssds_tpu_torch.tools import conv_bench, conv_probes

    cuda_conv.conv3x3_rows.launches = cuda_conv.vconv3.launches = row_stencil.launches = 0
    bench = conv_bench.run(batch=32, seed=args.seed, log=log)
    probes = conv_probes.run(seed=args.seed, log=log)
    torch.cuda.synchronize()
    conv_launches = {"conv3x3_rows": cuda_conv.conv3x3_rows.launches,
                     "vconv3": cuda_conv.vconv3.launches}
    stencil_launches = row_stencil.launches
    log(f"conv-prototype path: conv kernel launches {conv_launches}, stencil kernel launches "
        f"{stencil_launches}")
    for name in conv_probes.HOST_PROBES:
        p = probes["probes"][name]
        log(f"row_stencil host us per call at {name} {p['shape']}: wrapper "
            f"{p['kernel_host_us']:.2f}, plain {p['plain_host_us']:.2f} ({card})")
    if min(conv_launches.values()) <= 0 or stencil_launches <= 0:
        raise AssertionError("the conv-prototype path never launched one of its kernels")
    report.update(conv_kernel_max_abs_err=conv_err, conv_bench=bench, conv_probes=probes,
                  conv_launches_main_path=conv_launches,
                  stencil_launches_main_path=stencil_launches)

    # -- 8. the training path -------------------------------------------------
    keep = tempfile.mkdtemp(prefix="chip_smoke_")  # phase 8's checkpoint, for phases 14 and 20
    atexit.register(shutil.rmtree, keep, True)
    training = check_training(args.seed, dev, card, log, keep_dir=keep)
    report["training"] = training

    # -- 9. SSDLite-MobileNetV2-300: train, resume, deploy, serve ---------------
    lite = check_lite(args.seed, dev, card, log)
    report["lite"] = lite

    # -- 10. SSDLite-MobileNetV2-300 on COCO: augmented training, COCOeval, serving
    coco = check_coco(args.seed, dev, card, log, nms_mask, nms_mask_torch)
    report["coco"] = coco

    # -- 11. FSSD-VGG16-300 and RFBNet-VGG16-300: train, resume, deploy, serve ---
    heads = check_heads(args.seed, dev, card, log)
    report["heads"] = heads

    # -- 12. YOLOv3-DarkNet53-416 and YOLOv2-DarkNet19-416 -----------------------
    yolo = check_yolo(args.seed, dev, card, log)
    report["yolo"] = yolo

    # -- 13. SSD300-ResNet50, SSD512-VGG16 and the serving export ----------------
    zoo = check_zoo(args.seed, dev, card, log)
    report["zoo"] = zoo

    # -- 14. int8 serving of SSD300-VGG16 (MODEL.QUANT) --------------------------
    int8 = check_int8(args.seed, dev, card, log, training["checkpoint"])
    report["int8"] = int8

    # -- 15. SSDLite-MobileNetV2-300 COCO with DATASET.DEVICE_AUG -----------------
    device_aug = check_device_aug(args.seed, dev, card, log, coco["loader_img_s_native"])
    report["device_aug"] = device_aug

    # -- 16. data-parallel SSDLite-MobileNetV2-300 ----------------------------------
    # phase 20's fresh processes run beside 16a-b, which time nothing, and end before 16c
    parity_tmp = tempfile.mkdtemp(prefix="chip_smoke_parity_")
    atexit.register(shutil.rmtree, parity_tmp, True)
    parity_clis = start_parity_clis(parity_tmp)
    ddp = check_ddp(args.seed, dev, card, log,
                    before_lifecycle=lambda: wait_parity_clis(parity_clis))
    report["ddp"] = ddp

    # -- 17. observability: traces, timed, visualize_epoch ---------------------------
    observability = check_observability(args.seed, dev, card, log)
    report["observability"] = observability

    # -- 18. the spatial axis: SSD300-VGG16 on 1 x 2 bands, and TPU.REMAT --------------
    spatial_axis = check_spatial(args.seed, dev, card, log)
    report["spatial"] = spatial_axis

    # -- 19. the spatial axis for FSSD and YOLO: resizes and the reorg on bands ------
    spatial_heads = check_spatial_heads(args.seed, dev, card, log)
    report["spatial_heads"] = spatial_heads

    # -- 20. the mAP-parity harness and the export CLI's --check -------------------
    parity = check_parity(args.seed, dev, card, log, training["checkpoint"],
                          training["test_map"], parity_clis)
    report["parity"] = parity
    shutil.rmtree(keep, ignore_errors=True)
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)

    b32, b1, b64 = (nms_times[f"{m}x200/full"] for m in (672, 21, 1344))
    default_tile = conv_bench.tile_name(cuda_conv.TILES[0])
    halo = probes["probes"]["elem_halo"]
    slowest = probes["slowest_vs_plain"]
    log(json.dumps({"training": {k: training[k] for k in (
        "epoch_loss", "steps", "eval_map", "test_map", "nms_launches_eval", "nms_launches_test",
        "train_step_ms", "train_img_s", "eval_img_s", "train_model_s", "f32_step", "card")}}))
    log(json.dumps({"lite": {k: lite[k] for k in (
        "epoch_loss", "eval_map", "test_map", "nms_launches_eval", "nms_launches_test",
        "nms_launches_serve", "bn_running_var_moved", "train_step_ms", "train_img_s",
        "predict_b1_p50_ms", "predict_b1_p90_ms", "predict_batch32_img_s", "f32_loc_max_abs_err",
        "f32_conf_max_abs_err", "f32_step", "card")}}))
    log(json.dumps({"coco": {k: coco[k] for k in (
        "epoch_loss", "eval_ap", "eval_ap50", "test_ap", "test_ap50", "eval_detections",
        "nms_launches_eval", "nms_launches_test", "nms_launches_serve", "native_sampler_calls",
        "augmented_images_differ", "train_step_ms", "train_img_s", "loader_img_s_native",
        "loader_img_s_python_loop", "eval_img_s", "eval_cocoeval_s", "test_cocoeval_s",
        "predict_640x480_b1_p50_ms", "predict_640x480_b1_p90_ms", "predict_batch32_mixed_img_s",
        "nms_ms_5184x200", "nms_plain_ms_5184x200", "nms_bound_ms_5184x200", "nms_ms_81x200",
        "nms_bound_ms_81x200", "train_model_s", "phase_s", "card")}}))
    log(json.dumps({"heads": {head: {k: h[k] for k in (
        "epoch_loss", "eval_map", "test_map", "nms_launches_eval", "nms_launches_test",
        "nms_launches_serve", "bn_running_var_moved", "float32_sources", "train_step_ms",
        "train_img_s", "predict_b1_p50_ms", "predict_b1_p90_ms", "predict_batch32_img_s",
        "f32_loc_max_abs_err", "f32_conf_max_abs_err", "f32_step", "train_model_s", "phase_s",
        "card") if k in h} for head, h in heads.items()}}))
    log(json.dumps({"yolo": {name: {k: y[k] for k in (
        "boxes", "batchnorms", "epoch_loss", "eval_map", "test_map", "nms_launches_eval",
        "nms_launches_test", "nms_launches_serve", "bn_running_var_moved", "seen_images",
        "train_step_ms", "train_img_s", "predict_b1_p50_ms", "predict_b1_p90_ms",
        "predict_batch32_img_s", "f32_raw0_max_abs_err", "f32_raw1_max_abs_err",
        "f32_raw2_max_abs_err", "f32_step",
        "train_model_s", "phase_s", "card") if k in y} for name, y in yolo.items()}}))
    export = zoo["export"]
    log(json.dumps({"zoo": {name: {k: z[k] for k in (
        "boxes", "batchnorms", "epoch_loss", "eval_map", "test_map", "nms_launches_eval",
        "nms_launches_test", "nms_launches_serve", "bn_running_var_moved", "train_step_ms",
        "train_img_s", "predict_b1_p50_ms", "predict_b1_p90_ms", "predict_batch32_img_s",
        "f32_loc_max_abs_err", "f32_conf_max_abs_err", "f32_step", "train_model_s", "phase_s",
        "card") if k in z} for name, z in zoo.items() if name != "export"}}))
    log(json.dumps({"export": {k: export[k] for k in (
        "export_s", "artifact_mb", "server_s", "server_modules", "nms_launches_export",
        "export_b1_p50_ms", "export_b1_p90_ms", "export_batch32_img_s", "inprocess_b1_p50_ms",
        "inprocess_batch32_img_s", "predict_b1_p50_ms", "predict_batch32_img_s", "phase_s",
        "card")}}))
    log(json.dumps({"int8": {k: int8[k] for k in (
        "int8_convs", "shapes", "launches", "f32_loc_max_abs_err", "f32_loc_max_abs",
        "f32_conf_max_abs_err", "float_map", "int8_map", "conf_max_abs_diff_test",
        "int8_b1_p50_ms", "int8_b1_p90_ms", "int8_batch32_img_s", "bf16_b1_p50_ms",
        "bf16_b1_p90_ms", "bf16_batch32_img_s", "export_int8_launches", "export_b1_p50_ms",
        "export_batch32_img_s", "construct_s", "phase_s", "card")},
        "int8_bench_sums": int8["bench"]["sums"]}))
    log(json.dumps({"device_aug": {k: device_aug[k] for k in (
        "epoch_loss", "steps", "resume_equal", "loader_img_s_resize_only", "loader_img_s_native",
        "train_step_ms", "train_step_no_aug_ms", "augment_ms", "stats_device", "stats_host",
        "stats_within_bounds", "train_model_s", "phase_s", "card")}}))
    log(json.dumps({"ddp": {k: ddp[k] for k in (
        "device_count", "ranks", "backend", "device", "cli_s", "f64_step", "epoch_loss",
        "eval_map", "test_map", "test_map_one", "map_diff", "manifest_epochs",
        "bn_running_var_moved", "rank_states_equal", "nms_launches_ranks", "train_step_ms_ranks",
        "train_step_ms_one", "allreduce_bn_ms", "allreduce_grads_ms", "eval_img_s_ranks",
        "eval_img_s_one", "lifecycle_s", "phase_s", "card")}}))
    log(json.dumps({"observability": {k: observability[k] for k in (
        "train_trace", "serve_trace", "nms_launches_traced", "timed_s", "events_s",
        "timed_rel_diff", "images", "histograms", "parameters", "phase_s", "card")},
        "export_moved_sharded": {k: export[k] for k in (
            "moved_cpu_rows_identical", "moved_cpu_s", "sharded_devices", "nms_launches_sharded",
            "sharded_rows_identical", "batch_dependence")}}))
    log(json.dumps({"spatial": {k: spatial_axis[k] for k in (
        "ranks", "backend", "device", "f64_step_vgg300", "f64_step_lite300", "f64_s",
        "epoch_loss", "test_map", "rank_states_equal", "tensors_moved", "manifest_epochs",
        "nms_launches_ranks", "transfers_per_step", "train_step_ms_ranks",
        "train_step_ms_one_plain", "train_step_ms_one_remat", "peak_mb_plain", "peak_mb_remat",
        "peak_above_resting_mb_plain", "peak_above_resting_mb_remat", "allreduce_grads_ms",
        "served_weights_equal", "lifecycle_s", "phase_s", "card")}}))
    log(json.dumps({"spatial_heads": {k: spatial_heads[k] for k in (
        "ranks", "backend", "device", "f64_step_fssd", "f64_step_yolo_v3", "f64_step_yolo_v2",
        "f64_s", "epoch_loss", "test_map", "rank_states_equal", "tensors_moved",
        "manifest_epochs", "nms_launches_ranks", "nms_launches_serve", "served_boxes",
        "served_rows_identical", "served_rows_finite_share", "served_weights_equal",
        "transfers_per_step", "train_step_ms_ranks", "train_step_ms_one", "allreduce_grads_ms",
        "lifecycle_s", "phase_s", "card")}}))
    log(json.dumps({"parity": {k: parity[k] for k in (
        "audit", "stage1_s", "stage3_map", "test_map_phase8", "map_diff", "nms_launches_stage3",
        "stage3_s", "nms_launches_selftest", "table_rows", "export_check", "clis_s", "phase_s",
        "card")}}))
    i8b = int8["bench"]["sums"][f"b{INT8_BATCHES[-1]}"]
    int8_shape = (f"SSD300-VGG16's {int8['int8_convs']} int8 convs and "
                  f"{int8['shapes'] - int8['int8_convs']} MobileNetV2 / DarkNet-53 shapes, "
                  f"batch {INT8_BATCHES[-1]}, summed")
    head_paths = {}
    for head, h in heads.items():
        head_paths[f"{head}_vgg16_serve"] = h["nms_launches_serve"]
        head_paths[f"{head}_vgg16_train"] = h["nms_launches_eval"] + h["nms_launches_test"]
    for name, y in yolo.items():  # not `kind`: main's, printed on the last line
        head_paths[f"{name}_serve"] = y["nms_launches_serve"]
        head_paths[f"{name}_train"] = y["nms_launches_eval"] + y["nms_launches_test"]
    for name, path in (("resnet50", "ssd300_resnet50"), ("ssd512", "ssd512_vgg16")):
        head_paths[f"{path}_serve"] = zoo[name]["nms_launches_serve"]
        head_paths[f"{path}_train"] = zoo[name]["nms_launches_eval"] + \
            zoo[name]["nms_launches_test"]
    log(f"chip_smoke: phases 1-20 in {time.perf_counter() - t_start:.1f} s")
    head_paths["export_serve"] = export["nms_launches_export"]
    head_paths["export_sharded_serve"] = export["nms_launches_sharded"]
    head_paths["ssd_lite_mobilenetv2_ddp_eval"] = ddp["nms_launches_ranks"]
    head_paths["ssd300_vgg16_traced_serve"] = observability["nms_launches_traced"]
    head_paths["ssd300_vgg16_spatial_test"] = spatial_axis["nms_launches_ranks"]
    head_paths["yolo_v3_spatial_test"] = spatial_heads["nms_launches_ranks"]
    head_paths["yolo_v3_spatial_serve"] = spatial_heads["nms_launches_serve"]
    head_paths["parity_stage3"] = parity["nms_launches_stage3"]
    head_paths["parity_selftest"] = parity["nms_launches_selftest"]
    log(json.dumps({"kernels": [{
        "name": "nms_mask", "route": "cuda", "source": "ssds_tpu_torch/csrc/nms.cu",
        "replaces": "ssds_tpu/ops/pallas/nms.py:55",
        "launches": launches + lite["nms_launches_serve"] + coco["nms_launches_serve"]
        + sum(h["nms_launches_serve"] for h in heads.values())
        + sum(y["nms_launches_serve"] for y in yolo.values())
        + zoo["resnet50"]["nms_launches_serve"] + zoo["ssd512"]["nms_launches_serve"]
        + export["nms_launches_export"] + export["nms_launches_sharded"]
        + observability["nms_launches_traced"] + spatial_heads["nms_launches_serve"],
        "launches_by_path": {"ssd300_vgg16_serve": launches,
                             "ssd_lite_mobilenetv2_serve": lite["nms_launches_serve"],
                             "ssd_lite_mobilenetv2_coco_serve": coco["nms_launches_serve"],
                             "ssd_lite_mobilenetv2_coco_train": coco["nms_launches_eval"]
                             + coco["nms_launches_test"],
                             "ssd300_vgg16_train": training["nms_launches_eval"]
                             + training["nms_launches_test"],
                             "ssd_lite_mobilenetv2_train": lite["nms_launches_eval"]
                             + lite["nms_launches_test"], **head_paths},
        "max_abs_err": max(nms_err, export["nms_op_max_abs_err"]),
        "ms": min(b32["kernel_ms"]), "plain_ms": min(b32["plain_ms"]),
        "bound_ms": b32["bound"]["ms"], "bound_by": b32["bound"]["by"], "library_ms": None,
        "shape": [672, 200], "wrapper_ms": min(b32["wrapper_ms"]),
        "ms_21x200": min(b1["kernel_ms"]), "plain_ms_21x200": min(b1["plain_ms"]),
        "bound_ms_21x200": b1["bound"]["ms"], "wrapper_ms_21x200": min(b1["wrapper_ms"]),
        "ms_1344x200": min(b64["kernel_ms"]), "plain_ms_1344x200": min(b64["plain_ms"]),
        "bound_ms_1344x200": b64["bound"]["ms"], "wrapper_ms_1344x200": min(b64["wrapper_ms"]),
        "ms_5184x200": coco["nms_ms_5184x200"], "plain_ms_5184x200": coco["nms_plain_ms_5184x200"],
        "bound_ms_5184x200": coco["nms_bound_ms_5184x200"],
        "ms_81x200": coco["nms_ms_81x200"], "bound_ms_81x200": coco["nms_bound_ms_81x200"],
    }, {
        "name": "conv3x3_rows", "route": "cuda", "source": "ssds_tpu_torch/csrc/conv3x3.cu",
        "replaces": "tools/pallas_conv_bench.py:50; tools/pallas_conv_bisect.py:71; "
                    "tools/pallas_conv_bisect.py:80",
        "launches": sum(conv_launches.values()), "launches_by_wrapper": conv_launches,
        "max_abs_err": max([conv_err, *(t["max_abs_err"] for t in bench["tiles"].values()),
                            probes["probes"]["dot"]["max_abs_diff"],
                            probes["probes"]["dot3d"]["max_abs_diff"]]),
        "ms": min(bench["tiles"][default_tile]["ms"]), "plain_ms": min(bench["plain_ms"]),
        "bound_ms": bench["bound_ms"], "bound_by": bench["bound_by"],
        "library_ms": min(bench["cudnn_ms"]), "tile": default_tile, "shape": bench["shape"],
        "vconv3": {k: probes["probes"]["dot"][k] for k in
                   ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "shape")},
    }, {
        "name": "row_stencil", "route": "cuda", "source": "ssds_tpu_torch/csrc/stencil.cu",
        "replaces": "; ".join(p.source for p in PROBES.values()), "launches": stencil_launches,
        "max_abs_err": max(probes["probes"][n]["max_abs_diff"] for n in PROBES),
        "ms": halo["kernel_ms"], "plain_ms": halo["plain_ms"], "bound_ms": halo["bound_ms"],
        "bound_by": halo["bound_by"], "library_ms": halo["library_ms"], "shape": halo["shape"],
        "slowest_probe": {"name": slowest, "ms": probes["probes"][slowest]["kernel_ms"],
                          "plain_ms": probes["probes"][slowest]["plain_ms"],
                          "library_ms": probes["probes"][slowest]["library_ms"],
                          "bound_ms": probes["probes"][slowest]["bound_ms"],
                          "shape": probes["probes"][slowest]["shape"]},
    }, {
        "name": "int8_conv", "route": "cuda", "source": "ssds_tpu_torch/csrc/int8_conv.cu",
        "replaces": "ssds_tpu/quant.py:70 (int8_conv, compiled by XLA; no pallas_call)",
        "launches": int8["launches"]["int8_conv"], "max_abs_err": int8["bench"]["max_abs_err"],
        "ms": i8b["kernel_ms"], "plain_ms": i8b["plain_ms"], "bound_ms": i8b["bound_ms"],
        "bound_by": i8b["bound_by"],
        "library_ms": i8b["library_ms"], "library": "torch._int_mm (cuBLASLt s8 x s8 -> s32 GEMM "
        "on the NHWC input or its im2col, the GEMM alone)",
        "cudnn_bf16_ms": i8b["cudnn_bf16_ms"], "share_of_bound": i8b["share"], "shape": int8_shape,
        "launches_export": sum(v[1] for v in int8["export_int8_launches"].values()),
    }, {
        "name": "quantize_act", "route": "cuda", "source": "ssds_tpu_torch/csrc/int8_conv.cu",
        "replaces": "ssds_tpu/quant.py:64 (quantize_act, compiled by XLA; no pallas_call)",
        "launches": int8["launches"]["quantize_act"], "max_abs_err": int8["bench"]["max_abs_err"],
        "ms": i8b["quantize_ms"], "plain_ms": i8b["plain_quantize_ms"],
        "bound_ms": i8b["quantize_bound_ms"], "bound_by": "bytes", "library_ms": None,
        "share_of_bound": i8b["quantize_share"], "shape": int8_shape,
        "launches_export": sum(v[0] for v in int8["export_int8_launches"].values()),
    }]}))
    log(card)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
