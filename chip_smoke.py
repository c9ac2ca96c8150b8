"""Chip smoke test of the PyTorch + CUDA port: drives the serving path, the
training step, the training solver, the detect -> pose programs, W8A8
serving, the serving export, the fused export, the demos, the
multi-process (DDP) training and eval, the wide ResNets' fused layer1,
the discriminative AP gate's path and the detector-chain gate's path on one
CUDA card and holds every kernel against its plain PyTorch version.

    python3 chip_smoke.py

Imports torch, numpy and simple_pose_torch only.  Phases (any failure
raises, and the script exits non-zero without a result line):

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     TF32 off for the f32 comparisons;
  2. build every kernel from csrc/ with nvcc (into build/), one nvcc per
     source, all started together, timed;
  3. each kernel against its plain version at the main path's shapes (the
     flagship ResNet-50+SE layer1: x [32, 64, 64, 48], 3 blocks, SE and a
     projection in block 0, BN folded from seeded non-trivial statistics;
     bands of 4 whole rows),
     in bf16 and f32, then timed beside the plain version and the library
     call (the unfused cuDNN layer1 of the port's own model) at batch 32 and
     128; both run the wgmma kernel's instances whose products are 64
     channels wide, bf16 and f32 (3xTF32: three TF32 products per
     product; the kernels' line names them, the tiles and the blocks per
     SM).  The built library holds se_gate_kernel and no se_apply kernel
     (the full pass applies the gate in its epilogue), and no CUDA-core
     block kernel.  3b: in a fresh process, every K2 chain this script times
     (phases 3, 9a, 14a, 14b) split from torch.profiler traces (k2_split)
     at its largest batch, bf16 and f32: launches and device ms per call of
     the block kernels' full passes, the SE sums passes and se_gate_kernel,
     from a trace that holds exactly the route's launches and no other
     kernel (a trace that dropped one is taken again, at most 3);
  4. the main path: PoseEvaluator(ResNet-50-DConv+SE, 256x192, bf16,
     fused_layer1, flip-test) on 4 synthetic batches of 32 with the launch
     counters zeroed just before and read just after; fused vs unfused
     heatmaps; the f32 card path vs the CPU plain path on 2 crops; COCO
     stats against a synthetic GT; crops/s at batch 128;
  5. the training crop's kernels at the training path's shapes (batch 128
     of 640^2 seeded uint8 canvases, box affines rotated within +-40 deg and
     scaled 0.7-1.3, 256x192 crops, the 328^2 stage-1 intermediate):
     a. the stage-2 kernel K1 (rotate_resample_kernel) against its plain
        version on the bf16 intermediate that stage 1 (cuBLAS) makes: f32 out
        bit for bit (asserted to 1e-3), bf16 out equal to the f32 out
        rounded; timed in bf16 and f32 out beside the plain version and one
        grid_sample on the same intermediate;
     b. the whole-crop kernel (rotate_resample_crop_kernel, what the
        training step runs) on the uint8 canvases, against
        affine_crop_two_stage_reference and against the two-launch card path
        it replaced (stage 1 on cuBLAS, then K1): f32 out bit for bit with
        both, bf16 out equal to the f32 out rounded and to K1's bf16 out;
        timed in bf16 and f32 out beside the plain version, that two-launch
        path, and one grid_sample of the canvas (bf16 or f32 NCHW, made
        outside the timed region) with the composite dst->src grid;
  6. the training path: init_train_state + make_train_step with
     configs/fast_pose.yaml's model and optimizer (ResNet-50-DConv+SE,
     256x192, Adam, multistep, EMA, bf16 autocast, unbiased targets) at batch
     128 on the phase-5 canvases, 3 warm-up and 20 timed steps with the
     launch counters zeroed just before and read just after (23 launches of
     the whole-crop kernel, none of K1); train crops/s and peak memory; then
     one f32 step on 2 crops on the card (the whole-crop kernel, TF32 off)
     against the same step on the CPU (the plain versions) from the same
     state;
  7. the solver, the port's training entry point: synthetic COCO keypoints
     JSON (256 train and 64 val images of 640x480, 1-4 people each, ~2.3 on
     average, 17 joints inside each box) whose images come from a seeded
     numpy painter installed in place of data/pipeline._imread_rgb, the
     native loader off (phase 8 reads real JPEGs); PoseSolver(TRAIN_CFG + those paths,
     2 epochs, validation every epoch).run(), then a fresh PoseSolver with 3
     epochs .run(resume=True).  With the launch counters zeroed just before
     and read just after: the whole-crop kernel launched once per solver
     train step, K1 never; the step count continues across the resume; the
     restored tensors equal the saved ones exactly, Adam's step counts on
     the CPU as before the save; every loss finite; val AP
     in [0, 1]; the _last and _best .pth files, the _best one loading into
     PoseEvaluator with no missing and no unexpected keys.  Solver crops/s
     per epoch, host-only batches/s, epoch and validate seconds beside the
     phase-6 bare-step rate.  Then one bf16 step at batch 128 from one
     state with model.remat off and on: loss and every BN running statistic
     to 1e-3 relative, peak memory of each;
  8. real JPEGs (tests/data_torch_jpeg, scripts/make_torch_jpeg_fixtures.py):
     a. the machine's JPEG loader built with g++ into build/, timed:
        native/canvas_loader.cc where jpeglib.h is found, else the port's
        csrc/jpeg_canvas.cc (libjpeg's arithmetic, no libjpeg); the
        toolchain and what the library links;
     b. the committed fixture (48 JPEGs) decoded against its per-image
        CRC32s (libjpeg-turbo's decode), heights and widths, exactly, and
        a FileNotFoundError for a missing file;
     c. host batches/s of PosePipeline(use_native=True) at the solver's
        batch shape (64 canvas slots of 640^2, 128 crops, the training
        augmentation, the fixture's 32 images cycled 8 times) with 8
        decode threads and with 1, beside phase 7's painter rate;
     d. predicts_by_detections at full width on the fixture's detections
        (ResNet-50-DConv+SE, 256x192, bf16, fused_layer1, flip-test, batch
        128, 64 canvas slots, canvas 640) with data/pipeline._imread_rgb
        replaced by a function that raises: K2 launched twice per batch,
        the loader at least once per batch, the crop kernel never; AP in
        [0, 1]; rescore_and_filter again on the saved raw predictions gives
        the same stats; then crops/s from JPEG files over 4 passes after a
        warm one;
     e. decoder='dark_original' on one batch of d: finite keypoints, conf
        equal to gauss_taylor's;
  9. the other two pose families, at full width:
     a. K2 at HRNet-W32's layer1 (4 Bottleneck blocks, no SE, a projection
        in block 0, BN folded from seeded statistics) against its plain
        version as in phase 3, timed at batch 32 and 128 beside the plain
        version and the port's own cuDNN layer1; ResNet-50-DUC's 3-block
        no-SE layer1 likewise at batch 32;
     b. phase 4's checks and rates for HRNet-W32, HRNet-W48 and
        configs/fast_pose_duc.yaml's ResNet-50-DUC (K2 twice per batch, the
        crop kernels never);
     c. phase 6's training path with configs/hrnet_w32.yaml's model and
        optimizer (3 warm-up and 10 timed steps at batch 128, the crop kernel
        once per step), then its f32 step card vs CPU;
     d. PoseSolver with HRNet-W32 on phase 7's synthetic COCO: one epoch,
        validation on, every loss finite, the _best checkpoint into
        PoseEvaluator(pose_hrnet) with no missing and no unexpected keys.
     Each of its numbers is printed on a line of its own with the card.
 10. the person detector and the detect -> pose programs at full width:
     seeded YOLOv5-l and YOLOv4-l, a 640^2 letterbox from 1280^2 BGR
     canvases (the native loader, flipped, with the replicated border; the
     cv2 path made to raise), conf 0.001 (seeded scores sit at the prior),
     the fixture's 32 JPEGs, ResNet-50-DConv+SE 256x192 for pose:
     a. each detector in f32 on the card against the CPU on the same
        weights and letterboxed batch of 2 (boxes 1e-2 px, scores 1e-5),
        then bf16 against f32 within the JAX package's amp bound;
     b. NMS on the card against the CPU on the same pred (the fused
        program's max_det 16 and gen-dets' 300, merge): equal keep masks,
        dets 1e-5 px + 1e-6 relative; its time alone at batch 8;
     c. gen_detections (eval gen-dets) at batch 8: images/s of a timed
        pass after a warm one, boxes written;
     d. detect_then_pose (eval e2e) with fused_layer1 and flip-test, the
        launch counters zeroed just before and read just after: K2 twice
        per pose batch; then crops/s of a second run;
     e. fused_eval (eval fused) at batch 8 x max_people 16 for YOLOv5-l and
        YOLOv4-l: images/s, crops/s, the valid boxes per image, peak
        memory, CUDA-event ms of the letterbox, detector, NMS, multi-crop,
        pose forward and decode on one batch; for YOLOv5-l the f32 pose
        stage on the card against the CPU on the same boxes;
     f. fused_eval with rect=True (the fixture's 640x480 run in a 640x512
        bucket): images/s beside e.
 11. W8A8 and the serving export (models/quant.py, evalkit/export.py):
     a. one quantized forward of a seeded ResNet-50+SE (bf16, 2 crops) and
        of YOLOv5-l (bf16, one 640^2 image): every conv's int32 product on
        the card's route (torch._int_mm over the patches) equal to the plain
        version (float64, cuDNN off), counted; at the serving batch 128 the
        stem, layer2.1.conv2 (3x3) and layer4.1.conv1 (1x1) timed: the
        route, torch._int_mm alone, the whole quantized conv, cuDNN's bf16
        conv, the plain version, and the bound at 1979 TOP/s int8;
     b. PoseEvaluator(quant='w8a8', bf16, fused_layer1, flip-test) at batch
        128 with the launch counters zeroed just before and read just after
        (K2 twice, the int8 route on every other conv, twice), every int8
        product of that run held against the plain version; crops/s in
        turns with bf16, dynamic then after calibrate() on two batches; the
        quantized vs bf16 heatmaps' cosine (> 0.99); f32 card vs CPU on the
        same static scales for two seeds of 2 crops: the first conv whose
        x8 differs, its flips and the inputs' difference up to it, the
        heatmaps' error beside the card's bf16 vs f32 control;
     c. gen-dets and fused (YOLOv5-l) with quant='w8a8', quant_calib=2 on
        the fixture (the fused run at batch 8 with every int8 product held
        against the plain version), then 3 timed passes each on the
        written scales, beside phase 10's float medians;
     d. the flagship (bf16, fused_layer1) and its w8a8 version on 11b's
        scales exported at batch 64 on a 640 canvas, saved, loaded in a
        fresh process that imports torch and the op registrations only:
        its outputs against the live evaluator's, artifact bytes, export
        and load seconds, crops/s loaded and live, the launches of K2 and
        of the int8 route there; then the f32 w8a8 evaluator traced on the
        CPU and moved to the card in that process (the int8 route and K2
        run there) against the live f32 one on the card.
 12. progressive JPEGs, the fused export and the demos:
     a. the committed progressive fixture (tests/data_torch_jpeg/progressive:
        4:4:4, 4:2:0, 4:2:2, gray, a restart interval, 121x99) through the
        port's decoder against its CRC32s; host images/s of one 640x480
        scene decoded 64 at a time as baseline and as progressive, with 8
        threads and with 1;
     b. export_fused of FusedDetectPose (YOLOv5-l + ResNet-50-DConv+SE, det
        640, canvas 1280, batch 8, max_people 16, conf 0.001) in bf16 and in
        w8a8 on scales calibrated on two fixture batches: saved, loaded in a
        fresh process that imports torch and the int8 op only, held against
        the live program on the fixture's first 8 JPEGs (det_valid equal,
        boxes and keypoints within FUSED_EXPORT_TOL, cuDNN deterministic in
        both), the int8 route's launches there; bytes, export and load
        seconds, images/s loaded and live (live before and after); the
        artifacts deleted; then the NMS's while_loop against the old
        host-tested fixed point and the sequential loop on the bf16 pred
        (scripts/time_torch_nms.py), with the round count;
     c. python -m simple_pose_torch.demo_image's main on the card (the
        flagship, a seeded YOLOv5-l with one planted confident anchor) from
        the baseline and the progressive scene, with --box and with the
        detector: each PNG read back (zlib) at 640x480; demo_video's
        run_frames over 16 synthetic frames at batch 4 (ms per frame); then
        serve_artifact --out on a fused_layer1 artifact of eval export, with
        the launch counters zeroed just before and read just after (K2
        once).
 13. the decoder's new coverage and DDP in place of the JAX mesh:
     a. the committed decoder-coverage fixture (tests/data_torch_jpeg/
        decoder: baseline and progressive files cut short, block-smoothed
        progressive files, SOF9/SOF10 arithmetic coding, multi-scan
        sequential files, warned progressions) through the port's decoder
        against its CRC32s (libjpeg's decode);
     b. two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
        card), meeting through a file (no port chosen before they start;
        c too), each on 64 of a global batch of 128 (phase 5's canvas
        shapes), the flagship at full width: DDP_F32_STEPS f32 DDP train
        steps (cuDNN deterministic) from a state F32_STEP_WARMUP
        one-process steps in, with the launch counters zeroed just before
        and read just after (the crop kernel once per rank per step): the
        ranks' tensors identical and within phase 6's card-vs-CPU step
        tolerances of one process's steps at batch 128 on the two halves
        concatenated (the first step's gradients and BN buffers held,
        Adam's parameters after the steps reported);
        then bf16 steps timed as
        "2 ranks sharing one card" beside phase 6's one-process rate (not a
        multi-GPU rate); then PoseSolver for one short epoch on phase 7's
        synthetic COCO and validate: every rank the same AP, within
        DDP_AP_TOL of one process's validate of the checkpoint, rank 0's
        gathered predictions within DDP_PRED_TOL of that validate's (the
        same image ids and count), and rank 0 alone writing the results
        file and the checkpoint;
     c. init_multihost over NCCL at world size 1, DDP around the flagship,
        3 bf16 steps, the NCCL version;
     d. python -m simple_pose_torch.eval gt on the fixture (seeded
        ResNet-50-DConv+SE, f32, decoder basic) in one process and through
        torchrun --standalone (its agent binds the store on port 0) as two
        ranks on cuda:0 with --multihost: the stats and the predictions
        equal.
 14. K2 on every layer1 the JAX kernel takes (Bottleneck width 128, maps
     wider than a band of whole rows):
     a. K2 at wide_resnet50_2+SE's seeded layer1 (width 128: 64 -> 128 ->
        256 channels, 3 blocks, SE and a projection in block 0) against its
        plain version as in phase 3, bf16 and f32 at batch 32, timed at
        batch 32 and 128 beside the plain version and its cuDNN layer1;
        both run the wgmma kernel's instances whose products are 128
        channels wide (bf16: bands of 4 whole rows; f32, 3xTF32: 8 x 16
        tiles; one block of threads per SM); the kernels' line names both,
        the tiles and the blocks per SM; its per-call split in phase 3b;
     b. K2 at ResNet-50+SE's layer1 on 64x97 and 64x128 maps (2-D tiles)
        against its plain version, bf16 and f32, at batch 8, timed there;
     c. phase 4's checks and rates for wide_resnet50_2 (256x192, bf16,
        fused_layer1, flip-test; K2 twice per batch), crops/s at batch 128;
     d. eval gt --fused-layer1 --flip-test with it on the fixture's JPEGs
        (K2 twice per pipeline batch, one prediction per person);
     e. eval export --fused-layer1 of it, served by serve_artifact (K2 once).
 15. the discriminative held-out AP gate's path
     (scripts/drive_torch_discrim_ap.py), with every ``import cv2`` made to
     raise:
     a. its color corpus painted (scripts/torch_discrim_corpus.py) as PNGs,
        64 train and 16 val images;
     b. ResNet-18-DConv trained 2 epochs through PoseSolver at the gate's
        width (128x128 crops, batch 32, canvas 224, bf16), the counters
        zeroed just before and read just after: the crop kernel once per
        step, K1 and K2 never;
     c. predicts_by_gt on val in float and each of the gate's variants
        (flip-test, w8a8 dynamic and static, the basic and dark_original
        decoders): the int8 route in the W8A8 ones only, K2 in none;
     d. eval gt in one process and with --mesh-devices 2 on the one card
        (gloo): the same instances, predictions within DDP_PRED_TOL;
     e. HRNet-W32 trained 1 epoch, then fused_layer1: K2 launched, its
        heatmaps within FUSED_HEAT_TOL of the unfused forward's.
 16. the detector-chain gate's path
     (scripts/drive_torch_discrim_detchain.py), with every ``import cv2``
     made to raise:
     a. its crowded flipsym corpus painted as PNGs (256x192, 1-3 people an
        image in train, 3-4 in val), 32 train and 8 val images;
     b. ResNet-18-DConv trained 2 epochs through PoseSolver at the gate's
        width (128x128 crops, batch 32, canvas 288, flip augmentation,
        bf16): the crop kernel once per step, K1 and K2 never;
     c. the synthetic detections (jittered true boxes, duplicates, false
        positives), predicts_by_detections and the AP ladder on its raw
        predictions: every AP in [0, 1], one raw prediction per detection,
        rescoring alone keeps every one, the full chain (OKS-NMS 0.9) no
        more than that; no kernel launched;
     d. ResNet-50-DConv+SE (the flagship family, SE in layer1's block 0)
        trained 1 epoch, then fused_layer1 on one val batch: K2 once (the
        SE route: sums pass, se_gate, full pass), its heatmaps within
        FUSED_HEAT_TOL of the unfused forward's; that batch's layer1 input
        through K2, cuDNN (bf16) and the plain chain against the f32 layer1
        without TF32: K2 within TOL["bf16"] of f32, each error printed;
        then c's chain unfused and fused: K2 once per pose batch in the
        fused pass, never in the other.

The line before the last holds the kernels' JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import simple_pose_torch.data.pipeline as data_pipeline
from simple_pose_torch.data import native
from simple_pose_torch.data.coco import load_coco_keypoints, load_detection_boxes
from simple_pose_torch.detector.nms import non_max_suppression
from simple_pose_torch.detector.wrapper import (
    YOLOv5Detector,
    build_detector,
    _geom_to_arrays,
    image_batches,
    letterbox_params,
    read_canvases,
)
from simple_pose_torch.evalkit.export import export_evaluator, export_fused, save_exported
from simple_pose_torch.evalkit.fused import FusedDetectPose, fused_eval
from simple_pose_torch.evalkit.workflows import (
    PoseEvaluator,
    detect_then_pose,
    gen_detections,
    kps_to_dicts,
    predicts_by_detections,
    rescore_and_filter,
)
from simple_pose_torch.metrics.cocoeval import evaluate_map
from simple_pose_torch.models import quant
from simple_pose_torch.models.hrnet import build_hrnet
from simple_pose_torch.models.quant import quantized
from simple_pose_torch.models.registry import build_from_cfg
from simple_pose_torch.models.resnet import build_resnet
from simple_pose_torch.ops import affine as A
from simple_pose_torch.ops.bottleneck_chain import (
    FOLDED_KEYS,
    _lib,
    bottleneck_chain,
    bottleneck_chain_reference,
    fold_bottleneck_blocks,
    k2_launch_kind,
    launch_plan,
    prepare_blocks,
)
from simple_pose_torch.ops import int8_conv as i8
from simple_pose_torch.ops.decode import decode_basic
from simple_pose_torch.ops.int8_conv import int8_conv
from simple_pose_torch.ops.rotate_resample import (
    _rotate_resample_crop_cuda,
    affine_crop_two_stage,
    affine_crop_two_stage_reference,
    crop_scalars,
    rotate_resample,
    rotate_resample_reference,
)
from simple_pose_torch.ops.warp import (
    _src_coords,
    decompose_affine,
    invert_affine_batch,
    stage1_resample,
)
from simple_pose_torch.parallel.distributed import file_rendezvous
from simple_pose_torch.train.solver import PoseSolver, init_train_state, make_train_step
from simple_pose_torch.utils.cuda_build import build_library, launch_counts, zero_launch_counts

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# TF32 tensor cores (dense): K2's f32 products run as three TF32 products
# each (3xTF32), so the least time of its f32 work is 3 flops / this
PEAK_TF32_FLOPS = PEAK_BF16_FLOPS / 2
PEAK_BYTES = 3.35e12

# kernel vs plain, relative to max|plain|.  f32: sum order only.  bf16: a
# 1-ulp bf16 flip (2^-8) of a rounded intermediate (x, m1, m2, the SE mean
# or hidden layer, or the bf16 output itself) where the two sum in another
# order; the mean bounds how many flip.
TOL = {"f32": (1e-4, 1e-6), "bf16": (2e-2, 2e-3)}
# fused (f32 carry between blocks, folded BN) vs unfused (bf16 carry, BN in
# bf16) heatmaps under bf16 autocast, relative to max|unfused|: each of ~50
# layers rounds its bf16 output (2^-9 relative) in different places.
FUSED_HEAT_TOL = (5e-2, 5e-3)
# f32 evaluator on the card (kernel, cuDNN without TF32) vs on the CPU
# (plain chain): sum order through ~60 layers.
F32_HEAT_REL = 1e-3

BATCH, NUM_BATCHES, THROUGHPUT_BATCH, CANVAS = 32, 4, 128, 640
INPUT_SHAPE = (192, 256)  # (w, h)
CFG = {"type": "pose_resnet_dconv", "name": "resnet50", "num_joints": 17, "reduction": True}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
KERNELS = ("bottleneck_chain", "rotate_resample")

# the training path: configs/fast_pose.yaml as a dict (PyYAML is not assumed)
TRAIN_CFG = {
    "model_name": "fast_pose_tpu",
    "data": {"batch_size": 128, "canvas": CANVAS, "input_shape": list(INPUT_SHAPE)},
    "model": {"type": "pose_resnet_dconv", "name": "resnet50", "num_joints": 17,
              "reduction": True},
    "optim": {"optimizer": "adam", "lr": 0.001, "amp": True, "milestones": [120, 160],
              "epochs": 180, "gamma": 0.1, "schedule": "multistep", "ema": True},
    "seed": 1024,
}
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED = 128, 3, 20
CROP_HW, HEAT_HW = (INPUT_SHAPE[1], INPUT_SHAPE[0]), (INPUT_SHAPE[1] // 4, INPUT_SHAPE[0] // 4)
INTER = int(math.ceil(math.hypot(*CROP_HW))) + 8  # 328, as make_train_step sizes it
# f32 train step, card (kernel, cuDNN without TF32) vs CPU (plain versions),
# from a state 8 CPU steps in (Adam moments set: from zero moments Adam's
# first step, lr*g/(|g|+eps), turns a near-zero gradient's sign, which the
# two sum orders may disagree on, into a full +-lr step)
F32_STEP_LOSS_REL, F32_STEP_TREE_REL, F32_STEP_WARMUP = 1e-4, 1e-2, 8
# phase 7: synthetic COCO for the solver; people per image 1-4 with these
# odds (mean 2.3, COCO's instances per image)
SOLVER_TRAIN_IMAGES, SOLVER_VAL_IMAGES, SOLVER_IMG_WH = 256, 64, (640, 480)
PEOPLE_ODDS = (0.3, 0.3, 0.2, 0.2)
# remat on vs off, one bf16 step from one state: the recompute repeats the
# forward's ops on the same inputs, so the loss and BN statistics (taken in
# the forward) agree to far less; a second BN update would move the
# statistics by ~10% (momentum 0.1)
REMAT_REL = 1e-3
# phase 8: the committed JPEG fixture; the host-rate pipeline cycles its 32
# images HOST_COPIES times under distinct names (COCO's ~2.3 people per
# image, so dedup packs as on COCO)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data_torch_jpeg")
DET_DIR = os.path.join(FIXTURE, "det")
DET_IMAGES, DET_JSON = os.path.join(DET_DIR, "images"), os.path.join(DET_DIR, "detections.json")
DET_GT = os.path.join(DET_DIR, "person_keypoints.json")
DET_BATCH, DET_SLOTS, DET_PASSES = 128, 64, 4
HOST_COPIES, HOST_EPOCHS = 8, 3
# phase 9: the other two pose families.  Serving: HRNet-W32, HRNet-W48 and
# configs/fast_pose_duc.yaml's ResNet-50-DUC (no SE); training:
# configs/hrnet_w32.yaml as a dict
HRNET_CFG = {"type": "pose_hrnet", "name": "w32", "num_joints": 17}
FAMILY_CFGS = {
    "hrnet_w32": HRNET_CFG,
    "hrnet_w48": {"type": "pose_hrnet", "name": "w48", "num_joints": 17},
    "resnet50_duc": {"type": "pose_resnet_duc", "name": "resnet50", "num_joints": 17,
                     "reduction": False},
}
HRNET_TRAIN_CFG = {
    "model_name": "hrnet_w32_tpu",
    "data": {"batch_size": 128, "canvas": CANVAS, "input_shape": list(INPUT_SHAPE)},
    "model": {**HRNET_CFG, "pretrained": ""},
    "optim": {"optimizer": "adam", "lr": 0.001, "amp": True, "milestones": [120, 160],
              "epochs": 180, "gamma": 0.1, "schedule": "multistep", "ema": True},
    "seed": 1024,
}
HRNET_TRAIN_TIMED = 10
# phase 10: the person detector and the detect -> pose programs at full
# width: YOLOv5-l / YOLOv4-l, 640^2 letterbox from 1280^2 canvases, seeded
# init, on the phase-8 fixture.  The seeded head scores at its prior
# (obj ~1.2e-3 at stride 8, ~2e-2 at stride 32), so everything runs at conf
# 0.001: at 0.25 a seeded detector finds no one.
DET_CANVAS, DET_SIZE, DET_CONF, DET_IOU = 1280, 640, 0.001, 0.5
FUSED_BATCH, MAX_PEOPLE, DET_PARITY_BATCH = 8, 16, 2
DET_FAMILIES = ("yolov5", "yolov4")
# f32 detector card (cuDNN, TF32 off) vs CPU: boxes in input px, scores
DET_F32_TOL = (1e-2, 1e-5)
# bf16 vs f32: the JAX package's own amp bound (tests/test_detector.py:
# 358-375): median box px, mean score
DET_AMP_TOL = (1.0, 5e-3)
# NMS card vs CPU on one pred: dets in px plus a relative part (merged
# boxes are weighted means whose sums add in other orders)
NMS_TOL = (1e-5, 1e-6)
# timed passes over the fixture per workflow (each after a warm batch); the
# fused runs take turns within each round
TIMED_PASSES, E2E_PASSES = 5, 3
FUSED_RUNS = {"yolov5": ("yolov5", False), "yolov5_rect": ("yolov5", True),
              "yolov4": ("yolov4", False)}
# decode_basic's keypoints on two heatmaps of one crop agree to rounding
# where neither the peak nor its neighbour differences are tied (untied())
KPS_UNTIED_TOL = 1e-3
# phase 11: the quantized vs the float heatmaps (JAX's bar,
# tests/test_quant.py::test_w8a8_model_fidelity).  f32 card vs CPU on the
# same static scales, two seeds of 2 crops: every conv input up to the
# first x8 that rounds the other way agrees within QUANT_UPSTREAM_REL
# (f32 sum order; NVIDIA H100 80GB HBM3 at 700 W measured 2.0e-7 with the
# first flip at the stem, 1 of 294912 elements, and 6.5e-7 with it at
# layer2_0/conv1, 8 of 1572864); after it the flips spread to 96-100 of
# the 100 convs, and the heatmaps part by max 5.4e-2-5.8e-2 and mean
# 7.9e-3-8.3e-3 relative to max|CPU| (5.5e-2 / 7.8e-3 on a third input),
# the size the card's own bf16 program sits from its f32 one on the same
# crops (6.3e-2-7.0e-2 / 8.4e-3-9.4e-3, printed beside).  The bound is
# 1.4x the largest of those readings.  The artifact loaded in a fresh
# process against the live evaluator: keypoints px, confidences
QUANT_COS = 0.99
QUANT_CARD_CPU_REL = (8e-2, 1.2e-2)
QUANT_CARD_CPU_SEEDS = (2, 3)
QUANT_UPSTREAM_REL = 1e-5
EXPORT_TOL = (1e-3, 1e-5)
# the f32 program traced on the CPU, moved to the card, against the live
# evaluator on the card: heatmaps, relative to their max, with cuDNN's
# deterministic algorithms in both (the f32 deconv head's default one is
# not: two live runs differed by 8.3e-9 on maps of max 4.7e-6; with them
# the two programs measured bitwise equal on an NVIDIA H100 at 700 W)
EXPORT_HEAT_REL = 1e-6


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def busy_us(events) -> float:
    """Union of the device events' [start, end) intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: the layer1 chain kernel against its plain version
# ---------------------------------------------------------------------------


def seeded_layer1(model, seed=0):
    """``model``'s layer1 modules with seeded non-trivial BN statistics and
    affines (numpy RNG, ``seed``), on the card, in eval mode."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.layer1.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(1, 4, c).astype(np.float32)))
                m.weight.copy_(torch.from_numpy(rng.normal(1, 0.2, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
    return model.layer1.cuda().eval()


def chain_work(blocks, batch, h, w, act_bytes):
    """(flops, bytes) the chain must do and move: each input read once,
    each output written once."""
    flops, wbytes = 0, 0
    cin0, cout = blocks[0]["w1"].shape[0], blocks[-1]["w3"].shape[1]
    # the folded tensors only: prepare_blocks' f32 packs are the kernel's
    # copies of them
    blocks = [{k: v for k, v in blk.items() if k in FOLDED_KEYS} for blk in blocks]
    for blk in blocks:
        cin, width = blk["w1"].shape
        co = blk["w3"].shape[1]
        macs = h * w * (cin * width + 9 * width * width + width * co
                        + (cin * co if "wd" in blk else 0))
        if "sf1" in blk:
            macs += blk["sf1"].numel() + blk["sf2"].numel()
        flops += 2 * batch * macs
        wbytes += sum(t.numel() * t.element_size() for t in blk.values())
    return flops, wbytes + batch * (cin0 + cout) * h * w * act_bytes


def device_kernels(events):
    """The device work of a torch.profiler trace: its CUDA events but the
    step annotations that a profiler schedule adds (``ProfilerStep#``)."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep")]


def k2_split(x, blocks, dt, calls=3, attempts=3):
    """One call of the chain on ``x`` split by K2's launches, from a
    torch.profiler trace of ``calls`` calls, each its own step between
    pauses, after a warm-up step (a trace can lose its first launches):
    per kind (``k2_launch_kind``: the block kernels' full passes, the SE
    sums passes, se_gate_kernel) the launches and device ms a call, their
    sum, the full passes' ms per block, and the traces taken.  The route
    makes a full pass per block and a sums pass and a gate per SE block.
    Fails on a trace that holds more launches of a kind or another kernel
    (an se_apply pass among them).  The card's profiler drops launches now
    and then but adds none, so a trace that holds fewer is taken again, up
    to ``attempts`` traces, and the split comes from the first that holds
    exactly the route's launches; it fails if none does.  Late in a long
    process the profiler loses far more, so callers run this in a fresh
    one (run_k2_splits, scripts/profile_torch_k2.py)."""
    n_se = sum("sf1" in blk for blk in blocks)
    want = {"block": len(blocks), "sums": n_se, "se_gate": n_se}
    need = {k: calls * n for k, n in want.items()}
    for _ in range(3):
        bottleneck_chain(x, blocks, dt)
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        traced = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(wait=0, warmup=1, active=calls),
                     on_trace_ready=lambda p: traced.extend(p.events())) as prof:
            for _ in range(1 + calls):
                time.sleep(0.05)
                bottleneck_chain(x, blocks, dt)
                torch.cuda.synchronize()
                time.sleep(0.05)
                prof.step()
        us = {kind: [] for kind in want}
        for e in sorted(device_kernels(traced), key=lambda e: e.time_range.start):
            kind = k2_launch_kind(e.name)
            assert kind is not None, f"device work in a chain call that is not K2's route: {e.name}"
            us[kind].append(e.time_range.end - e.time_range.start)
        got = {k: len(v) for k, v in us.items()}
        assert all(got[k] <= need[k] for k in want), \
            f"{calls} chain calls traced {got} launches; the route makes {want} a call"
        if got == need:
            break
        log(f"k2_split: trace {attempt} held {got} of the route's {need} launches")
    assert got == need, f"no trace of {attempts} held the route's {need} launches (last: {got})"
    split = {k: {"launches": len(v) // calls, "ms": sum(v) / calls / 1e3} for k, v in us.items()}
    split["all_ms"] = sum(split[k]["ms"] for k in want)
    split["block_ms_by_block"] = [sum(us["block"][i::len(blocks)]) / calls / 1e3
                                  for i in range(len(blocks))]
    split["traces"] = attempt
    return split


def k2_splits():
    """k2_split of every K2 chain this script times (phase 3's flagship,
    9a's HRNet-W32 and ResNet-50-DUC, 14a's wide_resnet50_2, 14b's 64x97
    and 64x128 maps), in bf16 and f32 at the largest batch each is timed
    at: {chain: {"b<batch>_<dtype>": split}}."""
    flagship = lambda: build_resnet("resnet50", se=True)  # noqa: E731
    chains = {
        "resnet50": (flagship, 64, 48, THROUGHPUT_BATCH),
        "hrnet_w32": (lambda: build_hrnet("w32"), 64, 48, THROUGHPUT_BATCH),
        "resnet50_duc": (lambda: build_resnet("resnet50", head="duc"), 64, 48, BATCH),
        "wide_resnet50_2": (lambda: build_resnet("wide_resnet50_2", se=True), 64, 48,
                            THROUGHPUT_BATCH),
        **{f"resnet50 at 64x{w}": (flagship, 64, w, WIDE_MAP_BATCH) for w in WIDE_MAP_WIDTHS},
    }
    rng = np.random.default_rng(1)
    out = {}
    for label, (build, h, w, batch) in chains.items():
        folded = fold_bottleneck_blocks(list(seeded_layer1(build())))
        x32 = torch.from_numpy(np.abs(rng.normal(0, 1, (batch, 64, h, w))).astype(np.float32))
        out[label] = {f"b{batch}_{name}": k2_split(x32.cuda().to(dt), prepare_blocks(folded, dt),
                                                   dt) for name, dt in DTYPES.items()}
        torch.cuda.empty_cache()
    return out


def run_k2_splits():
    """k2_splits in a fresh process: there the card's profiler drops a
    launch now and then, while in this one, after phases 4-13, it lost
    launches and then whole traces (PERF.md, the SE route's findings).  The
    child's k2_split notes are logged."""
    proc = subprocess.run([sys.executable, "-c",
                           "import json, chip_smoke as C; print(json.dumps(C.k2_splits()))"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the K2 split process failed:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-6000:]}")
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    return json.loads(lines[-1])


def check_route_kernels(lib_path):
    """The route of the built K2 library, read from its kernels' names: the
    sums pass's flag and se_gate_kernel, no se_apply pass (the full pass
    applies the gate), and no CUDA-core block kernel (f32 runs the wgmma
    kernel's float instances), so none can run."""
    with open(lib_path, "rb") as f:
        image = f.read()
    assert b"se_gate_kernel" in image and b"bottleneck_block_wgmma_kernel" in image, lib_path
    assert b"se_apply" not in image, f"{lib_path} holds an se_apply kernel"
    assert b"bottleneck_block_kernel" not in image, f"{lib_path} holds a CUDA-core block kernel"
    return {"se_gate_kernel": True, "se_apply": False, "cuda_core_block_kernel": False}


def errors(got, want):
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    return d.max().item(), d.max().item() / scale, d.mean().item() / scale


def check_chain_kernel(layer1, label="layer1 chain", batches=(BATCH, THROUGHPUT_BATCH),
                       chw=(64, 64, 48), check_batch=BATCH):
    """``layer1``'s folded chain through the kernel against its plain version
    on x [check_batch, *chw] (bf16 and f32), then timed at ``batches``
    beside the plain version and ``layer1`` itself (cuDNN)."""
    folded = fold_bottleneck_blocks(list(layer1))
    cout, (_, h, w) = folded[-1]["w3"].shape[1], chw
    rng = np.random.default_rng(1)
    x32 = torch.from_numpy(np.abs(rng.normal(0, 1, (check_batch, *chw))).astype(np.float32))
    x32 = x32.cuda()
    report = {}
    for name, dt in DTYPES.items():
        blocks = prepare_blocks(folded, dt)
        x = x32.to(dt)
        want = bottleneck_chain_reference(x, blocks, dt)
        got = bottleneck_chain(x, blocks, dt)
        torch.cuda.synchronize()
        assert got.shape == (check_batch, cout, h, w) and got.dtype == dt
        assert torch.isfinite(got.float()).all()
        max_abs, max_rel, mean_rel = errors(got, want)
        tol_max, tol_mean = TOL[name]
        log(f"{label} {name}: max|d| {max_abs:.3e}  max rel {max_rel:.3e} (< {tol_max})"
            f"  mean rel {mean_rel:.3e} (< {tol_mean})")
        assert max_rel < tol_max and mean_rel < tol_mean, f"chain kernel disagrees ({name})"
        report[name] = {"max_abs_err": max_abs, "max_rel_err": max_rel, "mean_rel_err": mean_rel}

    timing = {}
    for batch in batches:
        xb = torch.from_numpy(np.abs(rng.normal(0, 1, (batch, *chw))).astype(np.float32))
        xb = xb.cuda()
        for name, dt in DTYPES.items():
            blocks = prepare_blocks(folded, dt)
            x = xb.to(dt)
            flops, nbytes = chain_work(blocks, batch, h, w, x.element_size())
            # the least time: bf16 products on its tensor cores; f32 as 3
            # TF32 products each (below the CUDA cores' flops / 67e12,
            # reported beside it)
            peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_TF32_FLOPS / 3
            bound_ms = max(flops / peak, nbytes / PEAK_BYTES) * 1e3
            amp = torch.autocast("cuda", dtype=torch.bfloat16, enabled=dt == torch.bfloat16)

            def library():
                with torch.no_grad(), amp:
                    return layer1(x)

            row = {
                "kernel_ms": cuda_ms(lambda: bottleneck_chain(x, blocks, dt)),
                "plain_ms": cuda_ms(lambda: bottleneck_chain_reference(x, blocks, dt), iters=5),
                "library_ms": cuda_ms(library),
                "bound_ms": bound_ms,
                "bound_by": "operations" if flops / peak > nbytes / PEAK_BYTES else "bytes",
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            }
            if dt == torch.float32:
                row["bound_cuda_core_ms"] = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
            timing[f"b{batch}_{name}"] = row
            log(f"{label} b{batch} {name}: " + json.dumps(row))
    return report, timing


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------


def synthetic_batch(rng, n, first_id):
    """n crops of seeded boxes on n noise canvases, with a GT person each."""
    canvases = rng.integers(0, 256, (n, CANVAS, CANVAS, 3), dtype=np.uint8)
    trans = np.zeros((n, 2, 3), np.float32)
    trans_inv = np.zeros((n, 2, 3), np.float32)
    images, anns = [], []
    out_wh = (INPUT_SHAPE[0] // 4, INPUT_SHAPE[1] // 4)
    for i in range(n):
        bw, bh = rng.uniform(80, 400), rng.uniform(120, 560)
        x1, y1 = rng.uniform(0, CANVAS - bw), rng.uniform(0, CANVAS - bh)
        center, scale = A.box_to_center_scale(x1, y1, bw, bh, INPUT_SHAPE[0] / INPUT_SHAPE[1])
        t, _ = A.get_affine_transform(center, scale, 0.0, INPUT_SHAPE)
        _, ti = A.get_affine_transform(center, scale, 0.0, out_wh)
        trans[i], trans_inv[i] = t, ti
        kp = np.zeros((17, 3))
        kp[:, 0] = rng.uniform(x1, x1 + bw, 17)
        kp[:, 1] = rng.uniform(y1, y1 + bh, 17)
        kp[:, 2] = 2
        img_id = first_id + i
        images.append({"id": img_id, "width": CANVAS, "height": CANVAS,
                       "file_name": f"{img_id:012d}.jpg"})
        anns.append({"id": img_id, "image_id": img_id, "category_id": 1, "iscrowd": 0,
                     "keypoints": kp.reshape(-1).tolist(), "num_keypoints": 17,
                     "area": float(bw * bh), "bbox": [float(x1), float(y1), float(bw), float(bh)]})
    batch = {"canvas": canvases, "trans": trans, "trans_inv": trans_inv,
             "img_id": np.arange(first_id, first_id + n)}
    return batch, images, anns


def run_main_path(workdir, cfg=CFG, label="main path"):
    """Phase 4 (and 9b for the other families): the serving path of ``cfg``."""
    rng = np.random.default_rng(2)
    ev = PoseEvaluator(cfg, None, INPUT_SHAPE, amp="auto", fused_layer1=True, flip_test=True)
    assert ev.dtype == torch.bfloat16
    batches, images, anns = [], [], []
    for bi in range(NUM_BATCHES):
        b, im, an = synthetic_batch(rng, BATCH, 1 + bi * BATCH)
        batches.append(b)
        images += im
        anns += an

    zero_launch_counts()
    t0 = time.perf_counter()
    outs = [{k: v.cpu().numpy() for k, v in ev(b).items()} for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    log(f"{label}: {NUM_BATCHES} batches of {BATCH} in {seconds:.3f} s (first call "
        f"included); launches {launches}")
    # one chain call per forward; flip-test forwards twice; no crop kernel
    expected = {"bottleneck_chain": NUM_BATCHES * 2, "rotate_resample": 0,
                "rotate_resample_crop": 0, "int8_conv": 0}
    assert launches == expected, (launches, expected)
    results = []
    for b, out in zip(batches, outs):
        assert out["kps"].shape == (BATCH, 17, 2) and out["conf"].shape == (BATCH, 17, 1)
        assert np.isfinite(out["kps"]).all() and np.isfinite(out["conf"]).all()
        kps_to_dicts(out["kps"], out["conf"], out["scores"], b["img_id"], results)

    gt_path = os.path.join(workdir, "gt.json")
    res_path = os.path.join(workdir, "res.json")
    with open(gt_path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    with open(res_path, "w") as f:
        json.dump(results, f)
    stats = {k: float(v) for k, v in evaluate_map(res_path, gt_path).items()}
    assert len(results) == NUM_BATCHES * BATCH and all(np.isfinite(list(stats.values())))
    assert 0.0 <= stats["AP"] <= 1.0
    log(f"{label} COCO stats (seeded random weights, synthetic GT): " + json.dumps(stats))

    # fused vs unfused heatmaps on the same crops, bf16
    unfused = PoseEvaluator(cfg, None, INPUT_SHAPE, amp="auto", fused_layer1=False,
                            flip_test=True)
    hf, hu = ev.heatmaps(batches[0]), unfused.heatmaps(batches[0])
    assert hf.shape == (BATCH, 17, *HEAT_HW) and torch.isfinite(hf).all()
    _, max_rel, mean_rel = errors(hf, hu)
    log(f"{label} fused vs unfused heatmaps (bf16): max rel {max_rel:.3e} "
        f"(< {FUSED_HEAT_TOL[0]})  mean rel {mean_rel:.3e} (< {FUSED_HEAT_TOL[1]})")
    # where the gap comes from: each bf16 path against the unfused f32 one
    h32 = PoseEvaluator(cfg, None, INPUT_SHAPE, amp=False, flip_test=True).heatmaps(batches[0])
    log(f"{label} against f32 heatmaps (max rel, mean rel): fused {errors(hf, h32)[1:]}, "
        f"unfused {errors(hu, h32)[1:]}")
    assert max_rel < FUSED_HEAT_TOL[0] and mean_rel < FUSED_HEAT_TOL[1]
    del unfused, hf, hu, h32

    # f32 on the card (the kernel's float instances) vs the CPU plain path,
    # 2 crops; its K2 launches counted (one a forward, flip-test: two)
    small = {k: v[:2] for k, v in batches[0].items()}
    kw = dict(amp=False, fused_layer1=True, flip_test=True)
    ev32 = PoseEvaluator(cfg, None, INPUT_SHAPE, **kw)
    zero_launch_counts()
    h_gpu = ev32.heatmaps(small).cpu()
    launches["bottleneck_chain_f32_serving"] = launch_counts()["bottleneck_chain"]
    assert launches["bottleneck_chain_f32_serving"] == 2, launches
    del ev32
    h_cpu = PoseEvaluator(cfg, None, INPUT_SHAPE, device="cpu", **kw).heatmaps(small)
    _, max_rel, _ = errors(h_gpu, h_cpu)
    log(f"{label} f32 card vs CPU heatmaps: max rel {max_rel:.3e} (< {F32_HEAT_REL})")
    assert max_rel < F32_HEAT_REL

    # serving throughput at batch 128 (4 x 32 canvases in one batch)
    big = {k: np.concatenate([b[k] for b in batches]) for k in ("canvas", "trans", "trans_inv")}
    staged = {k: torch.from_numpy(v).cuda() for k, v in big.items()}

    def serve(batch):
        return {k: v.cpu() for k, v in ev(batch).items()}

    serve(staged)
    rates = {}
    for name, batch in (("device_staged", staged), ("from_host", big)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            serve(batch)
        torch.cuda.synchronize()
        rates[name] = reps * THROUGHPUT_BATCH / (time.perf_counter() - t0)
    return launches, stats, rates


# ---------------------------------------------------------------------------
# phase 5: the rotation-resample kernel against its plain version
# ---------------------------------------------------------------------------


def train_inputs(rng, n):
    """n seeded 640^2 uint8 canvases, box affines onto the 256x192 crop
    rotated within +-40 deg and scaled 0.7-1.3 (train/config.py aug_rot,
    aug_scale), and joints in heatmap coordinates, 80% visible."""
    canvases = rng.integers(0, 256, (n, CANVAS, CANVAS, 3), dtype=np.uint8)
    trans = np.zeros((n, 2, 3), np.float32)
    for i in range(n):
        bw, bh = rng.uniform(80, 400), rng.uniform(120, 560)
        x1, y1 = rng.uniform(0, CANVAS - bw), rng.uniform(0, CANVAS - bh)
        center, scale = A.box_to_center_scale(x1, y1, bw, bh, INPUT_SHAPE[0] / INPUT_SHAPE[1])
        trans[i], _ = A.get_affine_transform(center, scale * rng.uniform(0.7, 1.3),
                                             rng.uniform(-40.0, 40.0), INPUT_SHAPE)
    joints = np.zeros((n, 17, 3), np.float32)
    joints[..., 0] = rng.uniform(0, HEAT_HW[1], (n, 17))
    joints[..., 1] = rng.uniform(0, HEAT_HW[0], (n, 17))
    joints[..., 2] = rng.uniform(0, 1, (n, 17)) < 0.8
    return {"canvas": canvases, "trans": trans, "joints": joints}


def sample_coords(r_mat, u0):
    """(ux, uy) [B, 256, 192]: where each crop pixel samples the
    intermediate (to within an ulp of the kernel's rounding)."""
    oh, ow = CROP_HW
    xs = torch.arange(ow, device=r_mat.device, dtype=torch.float32)[None, None, :]
    ys = torch.arange(oh, device=r_mat.device, dtype=torch.float32)[None, :, None]
    ux = r_mat[:, 0, 0, None, None] * xs + r_mat[:, 0, 1, None, None] * ys + u0[:, 0, None, None]
    uy = r_mat[:, 1, 0, None, None] * xs + r_mat[:, 1, 1, None, None] * ys + u0[:, 1, None, None]
    return ux, uy


def rotate_work(inter_img, r_mat, u0, out_dtype):
    """(flops, bytes, bytes of the whole intermediate) of one stage-2 call
    on these inputs.  Bytes: each intermediate pixel that an output tap
    reads, read once (this run's rotated footprint), each output written
    once, the scalars.  Flops: per pixel u (6) and the 4 hat weights (12),
    per channel 6 products and 3 sums."""
    b, c, h, w = inter_img.shape
    oh, ow = CROP_HW
    dev = inter_img.device
    ux, uy = sample_coords(r_mat, u0)
    x0, y0 = torch.floor(ux).long(), torch.floor(uy).long()
    base = torch.arange(b, device=dev)[:, None, None] * (h * w)
    touched = torch.zeros(b * h * w, dtype=torch.bool, device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            touched[(base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))[ok]] = True
    read = int(touched.sum().item()) * c * inter_img.element_size()
    out = b * oh * ow * c * torch.empty((), dtype=out_dtype).element_size()
    flops = b * oh * ow * (18 + 9 * c)
    return flops, read + out + b * 6 * 4, b * c * h * w * inter_img.element_size() + out


def grid_sample_args(inter_img, r_mat, u0, dtype):
    """grid_sample's normalized grid (align_corners=True) for the same taps:
    the port never calls it; it is the library yardstick."""
    h, w = inter_img.shape[-2:]
    ux, uy = sample_coords(r_mat, u0)
    grid = torch.stack([ux * (2.0 / (w - 1)) - 1.0, uy * (2.0 / (h - 1)) - 1.0], dim=-1)
    return inter_img.to(dtype), grid.to(dtype)


def check_rotate_kernel(data):
    """K1 against its plain version on the main path's stage-1 intermediate,
    then timed.  Returns (errors, timing, device inputs)."""
    canvas = torch.from_numpy(data["canvas"]).cuda()
    trans = torch.from_numpy(data["trans"]).cuda()
    d0, d1, r_mat, u0, t1x, t1y = decompose_affine(trans, CROP_HW, INTER)
    inter_img = stage1_resample(canvas, d0, d1, t1x, t1y, INTER)
    inter_img = inter_img.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
    args = (inter_img, r_mat, u0, CROP_HW)

    want = rotate_resample_reference(*args, torch.float32)
    got32 = rotate_resample(*args, out_dtype=torch.float32)
    got16 = rotate_resample(*args, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert got32.shape == (TRAIN_BATCH, *CROP_HW, 3) and got16.dtype == torch.bfloat16
    assert torch.isfinite(got32).all()
    d32 = (got32 - want).abs()
    identical = (got32 == want).float().mean().item()
    bf16_equal = bool(torch.equal(got16, got32.to(torch.bfloat16)))
    bf16_vs_plain = (got16.float() - want.to(torch.bfloat16).float()).abs().max().item()
    log(f"rotate_resample f32: max|d| {d32.max().item():.3e} (<= 1e-3), {identical:.6%} of "
        f"outputs bit-identical to the plain version; bf16 == f32 rounded: {bf16_equal}, "
        f"bf16 vs plain rounded max|d| {bf16_vs_plain:.3e}")
    assert d32.max().item() <= 1e-3, "rotate_resample kernel disagrees (f32)"
    assert bf16_equal, "rotate_resample kernel disagrees (bf16 out is not the f32 out rounded)"
    report = {"f32": {"max_abs_err": d32.max().item(), "bit_identical_share": identical},
              "bf16": {"max_abs_err": bf16_vs_plain, "equals_f32_rounded": bf16_equal}}
    del want, got32, got16

    timing = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        flops, nbytes, whole_bytes = rotate_work(inter_img, r_mat, u0, dt)
        gs_in, gs_grid = grid_sample_args(inter_img, r_mat, u0, dt)

        def library():
            return torch.nn.functional.grid_sample(gs_in, gs_grid, mode="bilinear",
                                                   padding_mode="zeros", align_corners=True)

        t_bytes, t_flops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
        row = {
            "kernel_ms": cuda_ms(lambda: rotate_resample(*args, out_dtype=dt), iters=50),
            "plain_ms": cuda_ms(lambda: rotate_resample_reference(*args, dt), iters=10),
            "library_ms": cuda_ms(library, iters=50),
            "bound_ms": max(t_bytes, t_flops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "mbytes": nbytes / 1e6, "mbytes_whole_intermediate": whole_bytes / 1e6,
            "bound_ms_whole_intermediate": whole_bytes / PEAK_BYTES * 1e3,
            "gflop": flops / 1e9,
        }
        timing[f"b{TRAIN_BATCH}_{name}"] = row
        log(f"rotate_resample b{TRAIN_BATCH} {name} out: " + json.dumps(row))
    return report, timing, {"canvas": canvas, "trans": trans}


def two_stage_k1(canvas, trans, out_dtype):
    """The training crop as the card ran it before the whole-crop kernel:
    stage 1 on cuBLAS, the bf16 intermediate, then K1."""
    d0, d1, r_mat, u0, t1x, t1y = decompose_affine(trans, CROP_HW, INTER)
    inter_img = stage1_resample(canvas, d0, d1, t1x, t1y, INTER)
    inter_img = inter_img.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
    return rotate_resample(inter_img, r_mat, u0, CROP_HW, out_dtype=out_dtype)


def crop_work(canvas, trans, out_dtype):
    """(flops, bytes) of one whole-crop call on these inputs.  Bytes: each
    canvas pixel that a stage-1 tap of a read intermediate pixel touches,
    read once (uint8), each output written once, the scalars.  Flops: per
    intermediate pixel read, its 4 weights (10) and per channel 6 products
    and 3 sums; per output pixel as rotate_work counts it."""
    b, h, w, c = canvas.shape
    oh, ow = CROP_HW
    dev = canvas.device
    d0, d1, r_mat, u0, t1x, t1y = decompose_affine(trans, CROP_HW, INTER)
    ux, uy = sample_coords(r_mat, u0)
    x0, y0 = torch.floor(ux).long(), torch.floor(uy).long()
    read = torch.zeros((b, INTER, INTER), dtype=torch.bool, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None].expand(b, oh, ow)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < INTER) & (yi >= 0) & (yi < INTER)
            read[bi[ok], yi[ok], xi[ok]] = True
    n_read = int(read.sum().item())
    o = torch.arange(INTER, dtype=torch.float32, device=dev)[None, :]
    py0 = torch.floor(t1y[:, None] + o * d1[:, None]).long()  # [B, inter] stage-1 row taps
    px0 = torch.floor(t1x[:, None] + o * d0[:, None]).long()
    sb, siy, six = read.nonzero(as_tuple=True)
    touched = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = py0[sb, siy] + dy, px0[sb, six] + dx
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            touched[sb[ok], yi[ok], xi[ok]] = True
    out = b * oh * ow * c * torch.empty((), dtype=out_dtype).element_size()
    flops = n_read * (10 + 9 * c) + b * oh * ow * (18 + 9 * c)
    return flops, int(touched.sum().item()) * c + out + b * 10 * 4


def canvas_grid_sample_args(canvas, trans, dtype):
    """grid_sample's input (the canvas as NCHW) and normalized grid
    (align_corners=True) for the composite dst->src affine: the library
    yardstick of the whole crop; the port never calls it."""
    h, w = canvas.shape[1:3]
    sx, sy = _src_coords(invert_affine_batch(trans.to(torch.float32)), CROP_HW)
    grid = torch.stack([sx * (2.0 / (w - 1)) - 1.0, sy * (2.0 / (h - 1)) - 1.0], dim=-1)
    return canvas.permute(0, 3, 1, 2).to(dtype).contiguous(), grid.to(dtype)


def check_crop_kernel(canvas, trans):
    """The whole-crop kernel against its plain version and against the
    two-launch path it replaced, then timed.  Returns (errors, timing)."""
    want = affine_crop_two_stage_reference(canvas, trans, CROP_HW, INTER, torch.float32)
    k1_32 = two_stage_k1(canvas, trans, torch.float32)
    k1_16 = two_stage_k1(canvas, trans, torch.bfloat16)
    got32 = affine_crop_two_stage(canvas, trans, CROP_HW, inter=INTER, out_dtype=torch.float32)
    got16 = affine_crop_two_stage(canvas, trans, CROP_HW, inter=INTER, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert got32.shape == (TRAIN_BATCH, *CROP_HW, 3) and got16.dtype == torch.bfloat16
    assert torch.isfinite(got32).all()
    d_plain = (got32 - want).abs().max().item()
    d_k1 = (got32 - k1_32).abs().max().item()
    identical = (got32 == want).float().mean().item()
    bf16_rounded = bool(torch.equal(got16, got32.to(torch.bfloat16)))
    bf16_k1 = bool(torch.equal(got16, k1_16))
    log(f"whole-crop kernel f32: max|d| {d_plain:.3e} vs the plain version ({identical:.6%} "
        f"bit-identical), {d_k1:.3e} vs stage 1 + K1; bf16 == f32 rounded: {bf16_rounded}, "
        f"bf16 == stage 1 + K1 bf16: {bf16_k1}")
    assert d_plain == 0 and d_k1 == 0, "whole-crop kernel disagrees (f32)"
    assert bf16_rounded and bf16_k1, "whole-crop kernel disagrees (bf16)"
    report = {"f32": {"max_abs_err": d_plain, "max_abs_err_vs_stage1_k1": d_k1,
                      "bit_identical_share": identical},
              "bf16": {"max_abs_err": (got16.float() - want.to(torch.bfloat16).float())
                       .abs().max().item(), "equals_f32_rounded": bf16_rounded,
                       "equals_stage1_k1": bf16_k1}}
    del want, k1_32, k1_16, got32, got16

    d0, d1, _, _, t1x, t1y = decompose_affine(trans, CROP_HW, INTER)
    timing = {"stage1_ms": cuda_ms(lambda: stage1_resample(canvas, d0, d1, t1x, t1y, INTER),
                                   iters=10)}
    scalars = crop_scalars(trans, CROP_HW, INTER)
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        flops, nbytes = crop_work(canvas, trans, dt)
        gs_in, gs_grid = canvas_grid_sample_args(canvas, trans, dt)

        def library():
            return torch.nn.functional.grid_sample(gs_in, gs_grid, mode="bilinear",
                                                   padding_mode="zeros", align_corners=True)

        t_bytes, t_flops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
        row = {  # kernel_ms: the launch alone; wrapper_ms: with decompose_affine's ~30 ops
            "kernel_ms": cuda_ms(lambda: _rotate_resample_crop_cuda(
                canvas, scalars, CROP_HW, INTER, dt), iters=50),
            "wrapper_ms": cuda_ms(lambda: affine_crop_two_stage(
                canvas, trans, CROP_HW, inter=INTER, out_dtype=dt), iters=50),
            "plain_ms": cuda_ms(lambda: affine_crop_two_stage_reference(
                canvas, trans, CROP_HW, INTER, dt), iters=10),
            "two_stage_ms": cuda_ms(lambda: two_stage_k1(canvas, trans, dt), iters=10),
            "library_ms": cuda_ms(library, iters=50),
            "bound_ms": max(t_bytes, t_flops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "mbytes": nbytes / 1e6, "gflop": flops / 1e9,
        }
        del gs_in, gs_grid
        timing[f"b{TRAIN_BATCH}_{name}"] = row
        log(f"whole-crop kernel b{TRAIN_BATCH} {name} out: " + json.dumps(row))
    return report, timing


# ---------------------------------------------------------------------------
# phase 6: the training path
# ---------------------------------------------------------------------------


def _state_to(state, device):
    """A copy of a TrainState on ``device``, optimizer moments included."""
    state = copy.deepcopy(state)
    state.model.to(device)
    state.optimizer.load_state_dict(state.optimizer.state_dict())  # moves the moments
    state.ema_params = {k: v.to(device) for k, v in state.ema_params.items()}
    state.ema_buffers = {k: v.to(device) for k, v in state.ema_buffers.items()}
    return state


def _trees(state):
    """Copies (on the CPU, f32) of the params, BN statistics and EMA."""
    def snap(v):
        return v.detach().to("cpu", torch.float32, copy=True)

    tree = {k: snap(v) for k, v in state.model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    tree.update({f"ema.{k}": snap(v)
                 for k, v in {**state.ema_params, **state.ema_buffers}.items()})
    return tree


def check_f32_step(data, train_cfg=TRAIN_CFG):
    """One f32 step on 2 crops on the card (the whole-crop kernel, cuDNN with
    TF32 off) against the same step on the CPU (the plain versions), from the
    same state."""
    cfg = copy.deepcopy(train_cfg)
    cfg["optim"]["amp"] = False
    step = make_train_step(HEAT_HW, CROP_HW, amp=False, crop_impl="kernel")
    cpu = init_train_state(cfg, device="cpu")
    rng = np.random.default_rng(6)
    for _ in range(F32_STEP_WARMUP):
        cpu, _ = step(cpu, train_inputs(rng, 2))
    gpu = _state_to(cpu, "cuda")
    before = _trees(cpu)
    small = {k: v[:2] for k, v in data.items()}
    cpu, m_cpu = step(cpu, small)
    gpu, m_gpu = step(gpu, small)
    torch.cuda.synchronize()
    loss_cpu, loss_gpu = m_cpu["loss"].item(), m_gpu["loss"].item()
    loss_rel = abs(loss_gpu / loss_cpu - 1)
    want, got = _trees(cpu), _trees(gpu)
    ratios = {}
    for k, w in want.items():
        update = (w - before[k]).norm().item()
        diff = (got[k] - w).norm().item()
        ratios[k] = diff / update if update > 0 else (0.0 if diff == 0 else float("inf"))
    worst = max(ratios, key=ratios.get)
    log(f"f32 step card vs CPU (2 crops, {F32_STEP_WARMUP} CPU steps in): loss {loss_gpu:.9g} vs "
        f"{loss_cpu:.9g}, rel {loss_rel:.3e} (<= {F32_STEP_LOSS_REL}); worst |d|/|update| "
        f"{ratios[worst]:.3e} at {worst} (<= {F32_STEP_TREE_REL}) over {len(ratios)} tensors")
    assert loss_rel <= F32_STEP_LOSS_REL and ratios[worst] <= F32_STEP_TREE_REL
    return {"loss_rel": loss_rel, "worst_tree_ratio": ratios[worst], "worst_tensor": worst}


def run_train_path(data_dev, data, train_cfg=TRAIN_CFG, timed=TRAIN_TIMED):
    """Phase 6 (and 9c): TRAIN_WARMUP + ``timed`` bf16 steps of ``train_cfg``
    at batch 128."""
    state = init_train_state(train_cfg)
    assert state.model.dtype == torch.bfloat16
    step = make_train_step(HEAT_HW, CROP_HW, amp=True, crop_impl="kernel", ema=True,
                           encoding="unbiased")
    batch = {**data_dev, "joints": torch.from_numpy(data["joints"]).cuda()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launch_counts()
    losses, accs = [], []
    for _ in range(TRAIN_WARMUP):
        state, m = step(state, batch)
        losses.append(m["loss"])
        accs.append(m["acc"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, m = step(state, batch)
        losses.append(m["loss"])
        accs.append(m["acc"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().cpu().numpy()
    accs = torch.stack(accs).float().cpu().numpy()
    log(f"train path: launches {launches}; loss per step {[float(x) for x in losses]}; "
        f"acc per step {[float(x) for x in accs]}")
    assert launches["rotate_resample_crop"] == TRAIN_WARMUP + timed, launches
    assert launches["rotate_resample"] == 0 and launches["bottleneck_chain"] == 0, launches
    assert np.isfinite(losses).all() and np.isfinite(accs).all()
    assert state.step == TRAIN_WARMUP + timed
    rate = timed * TRAIN_BATCH / seconds
    return launches, {"crops_per_s": rate, "ms_per_step": seconds / timed * 1e3,
                      "max_memory_allocated_gib": peak / 2**30,
                      "losses": [float(x) for x in losses]}


# ---------------------------------------------------------------------------
# phase 7: the solver
# ---------------------------------------------------------------------------


def write_synth_coco(path, n_images, first_id, rng):
    """A COCO person-keypoints JSON: n_images of SOLVER_IMG_WH, 1-4 people
    each (PEOPLE_ODDS), 17 visible joints uniform inside each box."""
    w, h = SOLVER_IMG_WH
    images, anns = [], []
    for img_id in range(first_id, first_id + n_images):
        images.append({"id": img_id, "width": w, "height": h, "file_name": f"{img_id:012d}.jpg"})
        for _ in range(1 + int(rng.choice(4, p=PEOPLE_ODDS))):
            bw, bh = rng.uniform(60, 300), rng.uniform(100, 400)
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            kp = np.zeros((17, 3))
            kp[:, 0] = rng.uniform(x1, x1 + bw, 17)
            kp[:, 1] = rng.uniform(y1, y1 + bh, 17)
            kp[:, 2] = 2
            anns.append({"id": len(anns) + first_id * 10, "image_id": img_id, "category_id": 1,
                         "iscrowd": 0, "keypoints": kp.reshape(-1).tolist(), "num_keypoints": 17,
                         "area": float(bw * bh),
                         "bbox": [float(x1), float(y1), float(bw), float(bh)]})
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return len(anns)


def painted_rgb(path):
    """A seeded uint8 noise image for an image path (keyed by its file name)."""
    rng = np.random.default_rng(zlib.crc32(os.path.basename(path).encode()))
    w, h = SOLVER_IMG_WH
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@contextlib.contextmanager
def painter_installed():
    """The pipelines read every image through the painter: no native loader
    (its files do not exist), _imread_rgb painted."""
    orig, orig_loader = data_pipeline._imread_rgb, data_pipeline._native_loader
    data_pipeline._imread_rgb = painted_rgb
    data_pipeline._native_loader = lambda use_native, num_threads: None
    log("phase 7: a seeded numpy painter stands in for simple_pose_torch.data.pipeline."
        "_imread_rgb (noise images keyed by file name; real JPEGs are phase 8's)")
    try:
        yield
    finally:
        data_pipeline._imread_rgb, data_pipeline._native_loader = orig, orig_loader


def state_tensors(state):
    """CPU copies of every tensor of a TrainState: the model, the EMA copies
    and the optimizer's moments."""
    out = {f"model.{k}": v.detach().to("cpu", copy=True)
           for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v.to("cpu", copy=True)
                for k, v in {**state.ema_params, **state.ema_buffers}.items()})
    names = {id(p): k for k, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for key, v in st.items():
            out[f"opt.{names[id(p)]}.{key}"] = torch.as_tensor(v).to("cpu", copy=True)
    return out


def instrument(solver, record):
    """Time each train_epoch and validate of ``solver`` and keep each step's
    loss (device tensors, read after the run)."""
    solver._compile()
    step, train_epoch, validate = solver._train_step, solver.train_epoch, solver.validate

    def timed_step(state, batch):
        state, metrics = step(state, batch)
        record["losses"].append(metrics["loss"])
        return state, metrics

    def timed_epoch(epoch, log_every=50):
        torch.cuda.synchronize()
        t0, s0 = time.perf_counter(), solver.state.step
        out = train_epoch(epoch, log_every)
        torch.cuda.synchronize()
        dt, steps = time.perf_counter() - t0, solver.state.step - s0
        record["epochs"].append({"epoch": epoch, "steps": steps, "seconds": dt,
                                 "crops_per_s": steps * solver.cfg.data.batch_size / dt,
                                 "loss": out["loss"]})
        return out

    def timed_validate(epoch, results_path="temp_test.json"):
        t0 = time.perf_counter()
        stats = validate(epoch, results_path)
        record["val"].append({"epoch": epoch, "seconds": time.perf_counter() - t0,
                              "AP": float(stats["AP"])})
        return stats

    solver._train_step, solver.train_epoch, solver.validate = timed_step, timed_epoch, timed_validate


def remat_step(remat, batch):
    """One bf16 step at TRAIN_CFG's width from the seeded init: (loss, BN
    running statistics on the CPU, peak device bytes of the step)."""
    cfg = copy.deepcopy(TRAIN_CFG)
    cfg["model"]["remat"] = remat
    state = init_train_state(cfg)
    step = make_train_step(HEAT_HW, CROP_HW, amp=True, crop_impl="kernel")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stats = {k: v.to("cpu", torch.float32, copy=True)
             for k, v in state.model.state_dict().items() if "running_" in k}
    loss = m["loss"].item()
    del state, m
    torch.cuda.empty_cache()
    return loss, stats, peak


def check_remat(batch):
    loss_off, stats_off, peak_off = remat_step(False, batch)
    loss_on, stats_on, peak_on = remat_step(True, batch)
    loss_rel = abs(loss_on / loss_off - 1)
    stat_rel = {k: ((stats_on[k] - v).abs().max() / v.abs().max().clamp_min(1e-12)).item()
                for k, v in stats_off.items()}
    worst = max(stat_rel, key=stat_rel.get)
    out = {"loss_off": loss_off, "loss_on": loss_on, "loss_rel": loss_rel,
           "worst_bn_stat_rel": stat_rel[worst], "worst_bn_stat": worst,
           "bn_stats": len(stat_rel), "peak_gib_off": peak_off / 2**30,
           "peak_gib_on": peak_on / 2**30}
    log("remat on vs off (one bf16 step, batch 128): " + json.dumps(out))
    assert loss_rel <= REMAT_REL and stat_rel[worst] <= REMAT_REL, out
    return out


def solver_cfg(workdir, train_cfg, epochs):
    """``train_cfg`` on synthetic COCO written to ``workdir`` (the painter
    stands in for its images), ``epochs`` epochs, validation every epoch."""
    rng = np.random.default_rng(7)
    img_root = os.path.join(workdir, "images")  # never read: the painter stands in
    train_ann, val_ann = os.path.join(workdir, "train.json"), os.path.join(workdir, "val.json")
    n_train = write_synth_coco(train_ann, SOLVER_TRAIN_IMAGES, 1, rng)
    n_val = write_synth_coco(val_ann, SOLVER_VAL_IMAGES, 100001, rng)
    cfg = copy.deepcopy(train_cfg)
    cfg["data"].update(train_ann_path=train_ann, val_ann_path=val_ann, train_img_root=img_root,
                       val_img_root=img_root, num_workers=8)
    cfg["optim"]["epochs"] = epochs
    cfg["val"] = {"interval": 1, "weight_path": os.path.join(workdir, "weights")}
    log(f"solver data: {n_train} train instances on {SOLVER_TRAIN_IMAGES} images, {n_val} val "
        f"instances on {SOLVER_VAL_IMAGES} images")
    return cfg


def check_best_loads(solver, model_cfg, device):
    """The solver's _best checkpoint loads into PoseEvaluator with no missing
    and no unexpected keys."""
    best = solver.checkpoint_path(f"{model_cfg['type']}_best")
    assert os.path.exists(solver.checkpoint_path()) and os.path.exists(best), best
    ema = torch.load(best, map_location="cpu")["ema"]
    ev = PoseEvaluator(model_cfg, best, INPUT_SHAPE, amp="auto", device=device)
    want = set(ev.model.state_dict())
    missing, unexpected = len(want - set(ema)), len(set(ema) - want)
    log(f"PoseEvaluator(weights={os.path.basename(best)}): {missing} missing, "
        f"{unexpected} unexpected keys")
    assert missing == 0 and unexpected == 0


def run_solver_path(workdir, card, step_rate, device=None):
    """Phase 7.  ``step_rate``: phase 6's bare-step crops/s, printed beside."""
    cfg = solver_cfg(workdir, TRAIN_CFG, 2)

    record = {"losses": [], "epochs": [], "val": []}
    solver = PoseSolver(cfg, device=device)
    instrument(solver, record)
    # seeded random weights score AP 0 on this data; the first validation
    # writes _best all the same, so that the file exists to be loaded
    solver.best_ap = -1.0
    t0 = time.perf_counter()
    host_batches = sum(1 for _ in solver.train_pipe.epoch(0))  # the device untouched
    host_rate = host_batches / (time.perf_counter() - t0)

    zero_launch_counts()
    solver.run()
    steps_first = solver.state.step
    saved = state_tensors(solver.state)
    del solver

    cfg["optim"]["epochs"] = 3
    resumed = PoseSolver(cfg, device=device)
    assert resumed.restore_checkpoint() == 2
    restored = state_tensors(resumed.state)
    assert set(restored) == set(saved)
    unequal = [k for k in saved if not torch.equal(restored[k], saved[k])]
    assert not unequal, unequal[:5]
    # Adam keeps its step counts on the CPU; restored onto the card, each
    # update would sync with the device once per parameter
    step_devices = {str(s["step"].device) for s in resumed.state.optimizer.state.values()}
    assert step_devices == {"cpu"}, step_devices
    instrument(resumed, record)
    resumed.run(resume=True)
    launches = launch_counts()
    steps = resumed.state.step
    steps_epoch3 = record["epochs"][-1]["steps"]
    losses = torch.stack(record["losses"]).float().cpu().numpy()
    log(f"solver: launches {launches}; steps {steps_first} + {steps_epoch3} = {steps}; "
        f"{len(saved)} tensors restored exactly; loss per step {[float(x) for x in losses]}; "
        f"val {json.dumps(record['val'])}")
    assert launches["rotate_resample_crop"] == steps == len(losses), (launches, steps)
    assert launches["rotate_resample"] == 0 and launches["bottleneck_chain"] == 0, launches
    assert steps == steps_first + steps_epoch3 and len(record["epochs"]) == 3
    assert np.isfinite(losses).all()
    assert len(record["val"]) == 3 and all(0.0 <= v["AP"] <= 1.0 for v in record["val"])

    check_best_loads(resumed, CFG, device)
    del resumed

    rates = {"card": card, "solver_epochs": record["epochs"],
             "validate": record["val"],
             "host_only_batches_per_s": host_rate, "host_only_batches": host_batches,
             "host_only_crops_per_s": host_rate * TRAIN_BATCH,
             "bare_step_crops_per_s_phase6": step_rate}
    log("solver (pipeline + H2D + step, per epoch) beside the bare step: " + json.dumps(rates))
    return launches, rates


# ---------------------------------------------------------------------------
# phase 8: real JPEGs through the native loader
# ---------------------------------------------------------------------------


def build_native_loader():
    """Phase 8a: build this machine's JPEG loader (data/native.py: libjpeg's
    native/canvas_loader.cc where jpeglib.h is found, else the port's
    csrc/jpeg_canvas.cc) and report the toolchain and what it links."""
    decoder = native.decoder_name()
    path, seconds = native.build_loader(decoder)
    gxx = subprocess.run([native.CXX, "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    macros = subprocess.run([native.CXX, "-E", "-dM", "-x", "c++", "-"], capture_output=True,
                            text=True, input="#include <cstdio>\n#include <jpeglib.h>\n").stdout
    version = re.search(r"#define JPEG_LIB_VERSION (\d+)", macros)
    turbo = re.search(r"#define LIBJPEG_TURBO_VERSION (\S+)", macros)
    ldd = subprocess.run(["ldd", path], capture_output=True, text=True, check=True).stdout
    facts = {"decoder": decoder, "source": os.path.relpath(native.SOURCES[decoder][0]),
             "library": os.path.relpath(path), "build_s": seconds, "toolchain": gxx,
             "jpeglib_h": bool(version),
             "JPEG_LIB_VERSION": int(version.group(1)) if version else None,
             "LIBJPEG_TURBO_VERSION": turbo.group(1) if turbo else None,
             "linked": [ln.split("(")[0].strip() for ln in ldd.splitlines() if "=>" in ln]}
    log("phase 8a, native loader: " + json.dumps(facts))
    assert decoder == "baseline" or any("libjpeg" in ln for ln in facts["linked"])
    # The committed CRC32s are libjpeg-turbo's decode, which the port's
    # decoder repeats; another libjpeg may round its IDCT otherwise.
    return facts, decoder == "baseline" or turbo is not None or (
        version is not None and int(version.group(1)) == 62)


def check_fixture_decode(exact_expected):
    """Phase 8b: the 48 committed JPEGs against their CRC32s; a missing file
    raises FileNotFoundError."""
    with open(os.path.join(FIXTURE, "decoded_crc32.json")) as f:
        want = json.load(f)
    rels = sorted(want)
    loader = native.NativeCanvasLoader(8)
    t0 = time.perf_counter()
    canvases, hs, ws = loader.load_batch([os.path.join(FIXTURE, r) for r in rels], CANVAS)
    seconds = time.perf_counter() - t0
    dims = [r for r, h, w in zip(rels, hs, ws) if (h, w) != (want[r]["height"], want[r]["width"])]
    crc = [r for r, c, h, w in zip(rels, canvases, hs, ws)
           if zlib.crc32(np.ascontiguousarray(c[:h, :w]).tobytes()) != want[r]["crc32"]]
    try:
        loader.load_batch([os.path.join(FIXTURE, rels[0]), os.path.join(FIXTURE, "missing.jpg")],
                          CANVAS)
        missing = "no error"
    except FileNotFoundError as e:
        missing = f"FileNotFoundError: {e}"
    out = {"decoder": loader.decoder, "images": len(rels), "crc32_equal": len(rels) - len(crc),
           "dims_equal": len(rels) - len(dims), "decode_s": seconds, "missing_file": missing}
    log("phase 8b, fixture decode: " + json.dumps(out))
    assert not dims, dims
    assert missing.startswith("FileNotFoundError"), missing
    assert exact_expected, "this libjpeg is neither libjpeg-turbo nor 6b: no reference for it"
    assert not crc, f"decoded pixels differ from the committed CRC32s: {crc}"
    return out


def cycled_fixture(workdir):
    """The fixture's keypoints set cycled HOST_COPIES times: symlinks under
    new names and ids, so that each copy is an image of its own."""
    with open(DET_GT) as f:
        gt = json.load(f)
    img_root = os.path.join(workdir, "cycled")
    os.makedirs(img_root)
    images, anns = [], []
    for k in range(HOST_COPIES):
        for im in gt["images"]:
            name = f"{k * 1000 + im['id']:012d}.jpg"
            os.symlink(os.path.join(DET_IMAGES, im["file_name"]), os.path.join(img_root, name))
            images.append({**im, "id": k * 1000 + im["id"], "file_name": name})
        anns += [{**a, "id": k * 1000 + a["id"], "image_id": k * 1000 + a["image_id"]}
                 for a in gt["annotations"]]
    ann_path = os.path.join(workdir, "cycled.json")
    with open(ann_path, "w") as f:
        json.dump({**gt, "images": images, "annotations": anns}, f)
    return load_coco_keypoints(img_root, ann_path)


def native_host_rates(workdir, painter_rate):
    """Phase 8c: host-only batches/s of the training pipeline on JPEGs."""
    records = cycled_fixture(workdir)
    rates = {"records": len(records), "painter_batches_per_s_phase7": painter_rate}
    for threads in (8, 1):
        pipe = data_pipeline.PosePipeline(records, TRAIN_BATCH, input_shape=INPUT_SHAPE,
                                          output_shape=HEAT_HW[::-1], canvas=CANVAS,
                                          num_threads=threads, use_native=True,
                                          dedup_canvases=DET_SLOTS, seed=1024)
        calls = native.NativeCanvasLoader.load_batch.calls
        t0 = time.perf_counter()
        n = sum(1 for epoch in range(HOST_EPOCHS) for _ in pipe.epoch(epoch))
        dt = time.perf_counter() - t0
        decoded = native.NativeCanvasLoader.load_batch.calls - calls
        assert decoded == n, f"{decoded} of {n} batches decoded natively"
        rates[f"native_{threads}_threads_batches_per_s"] = n / dt
        rates[f"native_{threads}_threads_batches"] = n
    return rates


def _no_cv2(path):
    raise RuntimeError(f"data/pipeline._imread_rgb called for {path}: the cv2 path was taken")


def run_detections_path(workdir):
    """Phase 8d and 8e.  Returns (launches, stats, rates, dark)."""
    raw, filtered = os.path.join(workdir, "raw.json"), os.path.join(workdir, "filtered.json")
    records = load_detection_boxes(DET_IMAGES, DET_JSON)
    plan = data_pipeline.DetBoxPipeline(records, DET_BATCH, canvas=CANVAS, use_native=False,
                                        dedup_canvases=DET_SLOTS)._pack_epoch(0)
    batches = len(plan)
    orig, data_pipeline._imread_rgb = data_pipeline._imread_rgb, _no_cv2
    try:
        zero_launch_counts()
        native.NativeCanvasLoader.load_batch.calls = 0
        stats = predicts_by_detections(
            DET_IMAGES, DET_JSON, DET_GT, CFG, None, batch_size=DET_BATCH,
            input_shape=INPUT_SHAPE, flip_test=True, out_path=raw, canvas=CANVAS, amp="auto",
            fused_layer1=True, filtered_out_path=filtered)
        launches = {**launch_counts(),
                    "load_batch_calls": native.NativeCanvasLoader.load_batch.calls,
                    "batches": batches}
        stats = {k: float(v) for k, v in stats.items()}
        with open(raw) as f, open(filtered) as g:
            n_raw, n_filtered = len(json.load(f)), len(json.load(g))
        log(f"phase 8d, detections: launches {launches}; {n_raw} raw predictions, "
            f"{n_filtered} after OKS-NMS; stats (seeded random weights) {json.dumps(stats)}")
        assert launches["bottleneck_chain"] == 2 * batches, launches
        assert launches["load_batch_calls"] >= batches, launches
        assert launches["rotate_resample_crop"] == 0 and launches["rotate_resample"] == 0
        assert n_raw == len(records) and n_filtered <= n_raw
        assert all(np.isfinite(list(stats.values()))) and 0.0 <= stats["AP"] <= 1.0
        again = rescore_and_filter(raw, DET_GT, out_path=os.path.join(workdir, "again.json"))
        assert {k: float(v) for k, v in again.items()} == stats, (again, stats)

        pipe = data_pipeline.DetBoxPipeline(records, DET_BATCH, input_shape=INPUT_SHAPE,
                                            output_shape=HEAT_HW[::-1], canvas=CANVAS,
                                            dedup_canvases=DET_SLOTS, use_native=True)
        ev = PoseEvaluator(CFG, None, INPUT_SHAPE, amp="auto", fused_layer1=True,
                           flip_test=True)

        def one_pass():
            crops = 0
            for batch in pipe.epoch(0):
                host = {k: v.cpu().numpy() for k, v in ev(batch).items()}
                assert host["kps"].shape == (DET_BATCH, 17, 2)
                crops += int((batch["valid"] > 0.5).sum())
            return crops

        one_pass()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crops = sum(one_pass() for _ in range(DET_PASSES))
        dt = time.perf_counter() - t0
        rates = {"crops_per_s_from_jpeg_files": crops / dt, "crops": crops, "seconds": dt,
                 "passes": DET_PASSES, "batches_per_pass": batches,
                 "timed": "DetBoxPipeline epochs (native decode of 32 JPEGs per pass, "
                          "packing, affines) + per batch: H2D of 64 canvases, crop, 2 "
                          "forwards (K2), gauss_taylor decode, D2H; not rescoring or COCO eval"}

        batch = next(iter(pipe.epoch(0)))
        dark_ev = PoseEvaluator(CFG, None, INPUT_SHAPE, decoder="dark_original", amp="auto",
                                fused_layer1=True, flip_test=True)
        want = {k: v.cpu().numpy() for k, v in ev(batch).items()}
        got = {k: v.cpu().numpy() for k, v in dark_ev(batch).items()}
        valid = batch["valid"] > 0.5
        d = np.abs(got["kps"] - want["kps"]).max(-1)[valid]
        dark = {"finite": bool(np.isfinite(got["kps"]).all()),
                "conf_equal": bool(np.array_equal(got["conf"], want["conf"])),
                "kps_vs_gauss_taylor_median_px": float(np.median(d)),
                "kps_vs_gauss_taylor_max_px": float(d.max())}
        log("phase 8e, dark_original: " + json.dumps(dark))
        assert dark["finite"] and dark["conf_equal"], dark
    finally:
        data_pipeline._imread_rgb = orig
    return launches, stats, rates, dark


def run_jpeg_path(card, painter_rate):
    """Phase 8."""
    loader, exact_expected = build_native_loader()
    decode = check_fixture_decode(exact_expected)
    with tempfile.TemporaryDirectory() as workdir:
        host = native_host_rates(workdir, painter_rate)
        log(f"phase 8c, host batches/s of PosePipeline on JPEGs (native loader, batch "
            f"{TRAIN_BATCH}, {DET_SLOTS} canvas slots of {CANVAS}^2, training augmentation) "
            f"on {card}: " + json.dumps(host))
        launches, stats, rates, dark = run_detections_path(workdir)
    log(f"phase 8d, detections crops/s from JPEG files (bf16, fused_layer1, flip-test, batch "
        f"{DET_BATCH}) on {card}: " + json.dumps(rates))
    return {"card": card, "loader": loader, "decode": decode, "host": host,
            "launches": launches, "stats": stats, "rates": rates, "dark_original": dark}


# ---------------------------------------------------------------------------
# phase 9: the other pose families (HRNet-W32/W48, ResNet-50-DUC)
# ---------------------------------------------------------------------------


def report_numbers(card, prefix, values):
    """Each number of the flat dict ``values`` on a line of its own, with the
    card's name and power limit."""
    for k, v in values.items():
        log(f"{prefix} {k}: {v} ({card})")


def run_hrnet_solver(workdir, device=None):
    """Phase 9d: PoseSolver with configs/hrnet_w32.yaml's model on phase 7's
    synthetic COCO, one epoch, validation on."""
    cfg = solver_cfg(workdir, HRNET_TRAIN_CFG, 1)
    record = {"losses": [], "epochs": [], "val": []}
    solver = PoseSolver(cfg, device=device)
    instrument(solver, record)
    solver.best_ap = -1.0  # seeded weights score AP 0: the first validation writes _best
    zero_launch_counts()
    solver.run()
    launches = launch_counts()
    losses = torch.stack(record["losses"]).float().cpu().numpy()
    log(f"phase 9d, solver (HRNet-W32): launches {launches}; loss per step "
        f"{[float(x) for x in losses]}; val {json.dumps(record['val'])}")
    steps = solver.state.step
    assert launches == {"bottleneck_chain": 0, "rotate_resample": 0,
                        "rotate_resample_crop": steps, "int8_conv": 0}, launches
    assert steps == len(losses) > 0 and np.isfinite(losses).all()
    assert len(record["val"]) == 1 and 0.0 <= record["val"][0]["AP"] <= 1.0
    check_best_loads(solver, HRNET_CFG, device)
    return launches, {"epoch": record["epochs"][0], "validate": record["val"][0]}


def run_other_families(card, data, data_dev):
    """Phase 9.  Returns {family: (K2 errors, K2 timing, serving launches)}
    for the kernels' JSON line."""
    # a. K2 at HRNet's 4-block layer1 and ResNet-50-DUC's 3-block one: no SE,
    # a projection in block 0
    t0 = time.perf_counter()
    chains = {
        "hrnet_w32": check_chain_kernel(seeded_layer1(build_hrnet("w32")),
                                        "phase 9a, hrnet_w32 layer1 chain"),
        "resnet50_duc": check_chain_kernel(seeded_layer1(build_resnet("resnet50", head="duc")),
                                           "phase 9a, resnet50_duc layer1 chain",
                                           batches=(BATCH,)),
    }
    for fam, (_, timing) in chains.items():
        for key, row in timing.items():
            report_numbers(card, f"phase 9a, {fam} layer1 chain {key}",
                           {k: row[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                                "bound_ms")})
    log(f"phase 9a: {time.perf_counter() - t0:.1f} s")

    # b. serving each family, fused_layer1 and flip-test, as phase 4
    t0 = time.perf_counter()
    serving = {}
    with tempfile.TemporaryDirectory() as workdir:
        for fam, cfg in FAMILY_CFGS.items():
            launches, stats, rates = run_main_path(workdir, cfg, f"phase 9b, {fam}")
            serving[fam] = launches
            report_numbers(card, f"phase 9b, {fam} serving crops/s at batch {THROUGHPUT_BATCH}",
                           rates)
            report_numbers(card, f"phase 9b, {fam} COCO", {"AP": stats["AP"]})
            torch.cuda.empty_cache()
    log(f"phase 9b: {time.perf_counter() - t0:.1f} s")

    # c. training HRNet-W32 at batch 128, then one f32 step card vs CPU
    t0 = time.perf_counter()
    _, train = run_train_path(data_dev, data, HRNET_TRAIN_CFG, HRNET_TRAIN_TIMED)
    report_numbers(card, f"phase 9c, hrnet_w32 train at batch {TRAIN_BATCH}",
                   {k: train[k] for k in ("crops_per_s", "ms_per_step",
                                          "max_memory_allocated_gib")})
    f32_step = check_f32_step(data, HRNET_TRAIN_CFG)
    report_numbers(card, "phase 9c, hrnet_w32 f32 step card vs CPU",
                   {k: f32_step[k] for k in ("loss_rel", "worst_tree_ratio")})
    torch.cuda.empty_cache()
    log(f"phase 9c: {time.perf_counter() - t0:.1f} s")

    # d. the entry point: one PoseSolver epoch of HRNet-W32
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir, painter_installed():
        cwd = os.getcwd()
        os.chdir(workdir)  # validate writes its results JSON to the working directory
        try:
            _, solver = run_hrnet_solver(workdir)
        finally:
            os.chdir(cwd)
    report_numbers(card, "phase 9d, hrnet_w32 solver epoch",
                   {"crops_per_s": solver["epoch"]["crops_per_s"],
                    "seconds": solver["epoch"]["seconds"],
                    "validate_seconds": solver["validate"]["seconds"]})
    log(f"phase 9d: {time.perf_counter() - t0:.1f} s")
    return {fam: (*chains[fam], serving[fam]["bottleneck_chain"],
                  serving[fam]["bottleneck_chain_f32_serving"]) for fam in chains}


# ---------------------------------------------------------------------------
# phase 10: the person detector and the detect -> pose programs
# ---------------------------------------------------------------------------


def fixture_canvases(n):
    """The fixture's first ``n`` JPEGs as the detector reads them: BGR
    canvases with the replicated border, through the native loader."""
    names = sorted(f for f in os.listdir(DET_IMAGES) if f.endswith(".jpg"))[:n]
    return read_canvases([os.path.join(DET_IMAGES, f) for f in names], DET_CANVAS,
                         native.NativeCanvasLoader(8))


def detector_kw(family, **kw):
    return dict(scale_name="l", scale_size=(DET_SIZE, DET_SIZE), conf_thresh=DET_CONF,
                iou_thresh=DET_IOU, canvas=DET_CANVAS, model_family=family, **kw)


@torch.no_grad()
def check_detector(family, canvases, shapes):
    """10a: the f32 detector on the card against the CPU on the same seeded
    weights and letterboxed batch, then bf16 against f32 on the card."""
    geom = [letterbox_params(h, w, (DET_SIZE, DET_SIZE)) for h, w in shapes]
    trans, region = _geom_to_arrays(geom)
    args = [torch.from_numpy(a) for a in (canvases, trans, region)]
    preds = {}
    for name, kw in (("cpu_f32", dict(amp=False, device="cpu")), ("f32", dict(amp=False)),
                     ("bf16", dict(amp="auto"))):
        det = YOLOv5Detector(**detector_kw(family, **kw))
        preds[name] = det.forward(*(a.to(det.device) for a in args), DET_SIZE, DET_SIZE).cpu()
        del det
    ref, p32, p16 = preds["cpu_f32"], preds["f32"], preds["bf16"]
    out = {"box_err_f32_vs_cpu_px": (p32[..., :4] - ref[..., :4]).abs().max().item(),
           "score_err_f32_vs_cpu": (p32[..., 4:] - ref[..., 4:]).abs().max().item(),
           "box_median_bf16_vs_f32_px": (p16[..., :4] - p32[..., :4]).abs().median().item(),
           "score_mean_bf16_vs_f32": (p16[..., 4:] - p32[..., 4:]).abs().mean().item(),
           "pred_shape": list(p16.shape), "finite": bool(torch.isfinite(p16).all())}
    assert out["finite"] and out["box_err_f32_vs_cpu_px"] <= DET_F32_TOL[0], out
    assert out["score_err_f32_vs_cpu"] <= DET_F32_TOL[1], out
    assert out["box_median_bf16_vs_f32_px"] < DET_AMP_TOL[0], out
    assert out["score_mean_bf16_vs_f32"] < DET_AMP_TOL[1], out
    return out


def check_nms(pred):
    """10b: NMS on the card against the CPU on the same pred (the fused
    program's settings and gen-dets'), and its time alone."""
    out = {}
    for name, kw in (("fused", dict(max_det=MAX_PEOPLE)), ("gen_dets", dict(max_det=300))):
        kw = dict(conf_thresh=DET_CONF, iou_thresh=DET_IOU, multi_label=True, merge=True, **kw)
        gd, gv = non_max_suppression(pred, **kw)
        cd, cv = non_max_suppression(pred.cpu(), **kw)
        gd, gv = gd.cpu(), gv.cpu()
        err = ((gd - cd).abs() - NMS_TOL[1] * cd.abs()).max().item()
        out[name] = {"keep_equal": bool(torch.equal(gv, cv)),
                     "dets_max_abs_err_px": (gd - cd).abs().max().item(),
                     "valid_per_image": gv.sum(-1).tolist(),
                     "ms": cuda_ms(lambda: non_max_suppression(pred, **kw), iters=10, warmup=2)}
        assert out[name]["keep_equal"] and err <= NMS_TOL[0], (name, out[name])
    return out


def pass_rates(seconds, units):
    """``units`` per second in each timed pass, and their median, min, max."""
    rates = [units / s for s in seconds]
    return {"median": float(np.median(rates)), "min": min(rates), "max": max(rates),
            "per_pass": rates}


def timed_passes(fn, passes):
    """Host seconds of each of ``passes`` calls of ``fn``, each from a
    synchronised card; the last call's result."""
    seconds = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        seconds.append(time.perf_counter() - t0)
    return seconds, result


def run_gen_dets(workdir, family="yolov5"):
    """10c: gen_detections over the fixture, a warm batch then
    TIMED_PASSES timed passes."""
    det = YOLOv5Detector(**detector_kw(family))
    out_path = os.path.join(workdir, "person_detections.json")
    kw = dict(detector=det, out_path=out_path, batch_size=FUSED_BATCH, canvas=DET_CANVAS,
              use_native=True)
    gen_detections(DET_IMAGES, DET_GT, debug=FUSED_BATCH, **kw)
    seconds, results = timed_passes(lambda: gen_detections(DET_IMAGES, DET_GT, **kw),
                                    TIMED_PASSES)
    with open(DET_GT) as f:
        n_images = len(json.load(f)["images"])
    per_image = np.bincount([r["image_id"] for r in results])[1:]
    assert len(per_image) == n_images and per_image.min() > 0
    return {"images_per_s": pass_rates(seconds, n_images), "seconds": seconds,
            "images": n_images, "boxes_written": len(results),
            "boxes_per_image_min": int(per_image.min()),
            "boxes_per_image_max": int(per_image.max()),
            "timed": "native decode + BGR flip and border, H2D, letterbox, YOLOv5-l bf16, "
                     "NMS (max_det 300, merge), D2H, unletterbox, JSON"}


def run_e2e(workdir):
    """10d: detect_then_pose (eval e2e) with fused_layer1 and flip-test: the
    counted run, then E2E_PASSES timed ones."""
    kw = dict(scale_name="l", det_conf=DET_CONF, det_iou=DET_IOU, batch_size=DET_BATCH,
              input_shape=INPUT_SHAPE, flip_test=True, work_dir=workdir, fused_layer1=True,
              use_native=True)
    zero_launch_counts()
    stats = detect_then_pose(DET_IMAGES, DET_GT, CFG, None, None, **kw)
    launches = launch_counts()
    det_json = os.path.join(workdir, "person_detections.json")
    records = load_detection_boxes(DET_IMAGES, det_json)
    batches = len(data_pipeline.DetBoxPipeline(
        records, DET_BATCH, canvas=CANVAS, use_native=False,
        dedup_canvases=DET_BATCH // 2)._pack_epoch(0))
    stats = {k: float(v) for k, v in stats.items()}
    log(f"phase 10d, e2e: launches {launches}; {len(records)} detections in {batches} pose "
        f"batches; stats (seeded random weights) {json.dumps(stats)}")
    assert launches["bottleneck_chain"] == 2 * batches, (launches, batches)
    assert launches["rotate_resample_crop"] == 0 and launches["rotate_resample"] == 0
    assert all(np.isfinite(list(stats.values()))) and 0.0 <= stats["AP"] <= 1.0
    seconds, _ = timed_passes(lambda: detect_then_pose(DET_IMAGES, DET_GT, CFG, None, None, **kw),
                              E2E_PASSES)
    return launches, batches, stats, {
        "crops_per_s": pass_rates(seconds, len(records)), "crops": len(records),
        "seconds": seconds,
        "timed": "gen-dets (YOLOv5-l bf16) + predicts_by_detections (ResNet-50-DConv+SE "
                 f"bf16, fused_layer1, flip-test, batch {DET_BATCH}) + rescoring + COCO eval"}


@torch.no_grad()
def stage_times(fused, canvases, shapes):
    """CUDA-event ms of each step of the two stages on one batch."""
    args = fused.prepare(canvases, shapes)
    th, tw = args[-2:]
    x = fused.letterbox(*args[:3], th, tw)
    pred = fused.detector.model(x)
    det = fused.detect(*args)
    xp, trans_inv = fused.crops(args[0], det["boxes"])
    heat = fused.pose_forward(xp)
    ms = {"letterbox": cuda_ms(lambda: fused.letterbox(*args[:3], th, tw)),
          "detector_forward": cuda_ms(lambda: fused.detector.model(x)),
          "nms": cuda_ms(lambda: fused.nms(pred), iters=10, warmup=2),
          "multi_crop": cuda_ms(lambda: fused.crops(args[0], det["boxes"])),
          "pose_forward": cuda_ms(lambda: fused.pose_forward(xp)),
          "decode": cuda_ms(lambda: fused._decode(heat, trans_inv))}
    ms["whole_batch"] = cuda_ms(lambda: fused(canvases, shapes), iters=5, warmup=1)
    return ms, pred, det


def untied(heat, err):
    """[N, J] bool: the maps whose decode_basic keypoint no per-pixel change
    of at most ``err`` can move: the peak clear of the second-highest pixel,
    and (where decode_basic shifts) both neighbour differences clear of
    zero, by more than 2 * err."""
    n, j, h, w = heat.shape
    flat = heat.float().reshape(n, j, h * w)
    top2 = flat.topk(2, dim=-1).values
    idx = flat.argmax(-1)
    y, x = idx // w, idx % w
    xc, yc = x.clamp(1, w - 2), y.clamp(1, h - 2)
    v = torch.gather(flat, -1, torch.stack([yc * w + xc + 1, yc * w + xc - 1,
                                            (yc + 1) * w + xc, (yc - 1) * w + xc], -1))
    shifts = (x > 1) & (x < w - 1) & (y > 1) & (y < h - 1)
    margin = torch.minimum((v[..., 0] - v[..., 1]).abs(), (v[..., 2] - v[..., 3]).abs())
    return (top2[..., 0] - top2[..., 1] > 2 * err) & (~shifts | (margin > 2 * err))


def compare_pose(got, want):
    """Heatmaps and confidences relative to max|want|; decode_basic's
    keypoints on the untied maps, and the program's own (gauss_taylor)
    keypoints on all of them."""
    (xg, hg, kg, bg, cg), (xw, hw, kw, bw, cw) = got, want
    err, heat_max_rel, heat_mean_rel = errors(hg, hw)
    keep = untied(hw, err)
    d = (kg - kw).abs().amax(-1)
    db = (bg - bw).abs().amax(-1)[keep]
    return {"crop_max_abs_err": (xg.float() - xw.float()).abs().max().item(),
            "heat_max_rel": heat_max_rel, "heat_mean_rel": heat_mean_rel,
            "conf_max_rel": errors(cg, cw)[1], "conf_mean_rel": errors(cg, cw)[2],
            "untied_share": keep.float().mean().item(),
            "basic_kps_untied_max_px": db.max().item() if db.numel() else None,
            "kps_median_px": d.median().item(), "kps_max_px": d.max().item(),
            "kps_share_within_1px": (d < 1.0).float().mean().item()}


@torch.no_grad()
def check_pose_stage(canvases, shapes, boxes):
    """10e: the pose stage on the same boxes (the first two images): f32 on
    the card against the CPU, and the card's bf16 program (the one users
    run: crops written in bf16 before the flip, /255 and the mean, as JAX
    writes them) against its f32 one.  Crops, heatmaps, confidences,
    keypoints."""
    n = 2
    kw = dict(scale_name="l", det_size=(DET_SIZE, DET_SIZE), input_shape=INPUT_SHAPE,
              max_people=MAX_PEOPLE, det_conf=DET_CONF, det_iou=DET_IOU, canvas=DET_CANVAS)
    outs = {}
    for name, prog_kw in (("card_f32", dict(amp=False)), ("card_bf16", dict(amp="auto")),
                          ("cpu_f32", dict(amp=False, device="cpu"))):
        fused = FusedDetectPose(CFG, None, None, **prog_kw, **kw)
        c = torch.from_numpy(canvases[:n]).to(fused.device)
        x, trans_inv = fused.crops(c, boxes[:n].to(fused.device))
        heat = fused.pose_forward(x)
        kps, conf = fused._decode(heat, trans_inv)
        basic, _ = decode_basic(heat, trans_inv)
        outs[name] = [t.cpu() for t in (x, heat, kps, basic, conf)]
        del fused
    out = {"f32_card_vs_cpu": compare_pose(outs["card_f32"], outs["cpu_f32"]),
           "bf16_vs_f32_card": compare_pose(outs["card_bf16"], outs["card_f32"])}
    f32, bf16 = out["f32_card_vs_cpu"], out["bf16_vs_f32_card"]
    assert f32["heat_max_rel"] < F32_HEAT_REL and f32["conf_max_rel"] < F32_HEAT_REL, out
    for key, (tol_max, tol_mean) in (("heat", FUSED_HEAT_TOL), ("conf", FUSED_HEAT_TOL)):
        assert bf16[f"{key}_max_rel"] < tol_max and bf16[f"{key}_mean_rel"] < tol_mean, out
    for r in out.values():
        assert r["untied_share"] > 0 and r["basic_kps_untied_max_px"] <= KPS_UNTIED_TOL, out
    return out


@torch.no_grad()
def profile_fused_pass(kw):
    """One fused_eval pass under torch.profiler: the device's busy time
    (the union of its kernels and copies) over the pass's host window."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fused_eval(DET_IMAGES, DET_GT, CFG, **kw)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = busy_us(events) / 1e3
    return {"window_ms": window_ms, "device_busy_ms": busy_ms, "device_events": len(events),
            "device_idle_share": 1.0 - busy_ms / window_ms if events else None}


def host_parts_ms(raw_path, filtered_path):
    """Host-only parts of one fused_eval pass, each alone: decoding the
    fixture into batches of canvases, and the rescoring with COCO eval."""
    with open(DET_GT) as f:
        images = json.load(f)["images"]
    loader = native.NativeCanvasLoader(8)
    t0 = time.perf_counter()
    for _ in image_batches(DET_IMAGES, images, FUSED_BATCH, DET_CANVAS, loader):
        pass
    t1 = time.perf_counter()
    rescore_and_filter(raw_path, DET_GT, 0.2, 0.9, filtered_path)
    return {"decode_and_pack": (t1 - t0) * 1e3, "rescore_and_coco_eval":
            (time.perf_counter() - t1) * 1e3}


def run_fused(workdir):
    """10e/10f: fused_eval over the fixture for each of FUSED_RUNS: a warm
    batch each, then TIMED_PASSES rounds that run each once (the order
    turned each round) with each pass's peak memory; one profiled pass and
    the host-only parts of YOLOv5-l's; then each run's checks and stage
    times on one batch."""
    programs = {name: FusedDetectPose(
        CFG, None, None, scale_name="l", det_size=(DET_SIZE, DET_SIZE),
        input_shape=INPUT_SHAPE, max_people=MAX_PEOPLE, det_conf=DET_CONF, det_iou=DET_IOU,
        canvas=DET_CANVAS, detector_family=family, rect=rect)
        for name, (family, rect) in FUSED_RUNS.items()}
    kws = {name: dict(fused=fused, batch_size=FUSED_BATCH, input_shape=INPUT_SHAPE,
                      max_people=MAX_PEOPLE, canvas=DET_CANVAS, use_native=True,
                      out_path=os.path.join(workdir, f"fused_{name}.json"),
                      filtered_out_path=os.path.join(workdir, f"fused_{name}_filtered.json"))
           for name, fused in programs.items()}
    for kw in kws.values():
        fused_eval(DET_IMAGES, DET_GT, CFG, debug=FUSED_BATCH, **kw)
    names = list(kws)
    seconds = {name: [] for name in names}
    peak = {name: [0.0, 0.0] for name in names}  # GiB: peak, peak above the resident
    stats = {}
    for r in range(TIMED_PASSES):
        for name in names[r % len(names):] + names[:r % len(names)]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            stats[name] = fused_eval(DET_IMAGES, DET_GT, CFG, **kws[name])
            seconds[name].append(time.perf_counter() - t0)
            top = torch.cuda.max_memory_allocated()
            peak[name] = [max(peak[name][0], top / 2**30),
                          max(peak[name][1], (top - resident) / 2**30)]
    profiled = profile_fused_pass(kws["yolov5"])
    profiled["host_parts_ms"] = host_parts_ms(kws["yolov5"]["out_path"],
                                              kws["yolov5"]["filtered_out_path"])
    canvases, shapes = fixture_canvases(FUSED_BATCH)
    out, first = {}, {}
    for name, fused in programs.items():
        with open(kws[name]["out_path"]) as f:
            preds = json.load(f)
        per_image = np.bincount([p["img_id"] for p in preds])[1:]
        s = {k: float(v) for k, v in stats[name].items()}
        assert all(np.isfinite(list(s.values()))) and 0.0 <= s["AP"] <= 1.0
        assert all(np.isfinite(p["kps"]).all() for p in preds)
        ms, pred, det = stage_times(fused, canvases, shapes)
        if name == "yolov5":
            first = {"pred": pred, "det": det}
        out[name] = {
            "images_per_s": pass_rates(seconds[name], len(per_image)),
            "crops_per_s": pass_rates(seconds[name], len(preds)), "seconds": seconds[name],
            "images": len(per_image), "crops": len(preds),
            "valid_boxes_per_image": per_image.tolist(),
            "max_memory_allocated_gib": peak[name][0],
            "max_memory_above_resident_gib": peak[name][1], "stage_ms": ms, "stats": s,
            "bucket": list(fused._pick_bucket(shapes)) if fused.rect else [DET_SIZE, DET_SIZE],
            "timed": "fused_eval: native decode + BGR flip and border, H2D, detect stage, "
                     "pose stage, D2H, rescoring, COCO eval"}
    out["yolov5"]["profiled_pass"] = profiled
    del programs, kws
    return out, first["pred"], first["det"], canvases, shapes


def run_detector_path(card):
    """Phase 10.  Returns the summary for the log and K2's e2e launches."""
    t_phase = time.perf_counter()
    orig, data_pipeline._imread_rgb = data_pipeline._imread_rgb, _no_cv2
    summary = {"card": card}
    try:
        canvases, shapes = fixture_canvases(DET_PARITY_BATCH)
        for family in DET_FAMILIES:
            t0 = time.perf_counter()
            summary[f"10a_{family}"] = check_detector(family, canvases, shapes)
            report_numbers(card, f"phase 10a, {family}-l detector", summary[f"10a_{family}"])
            log(f"phase 10a, {family}: {time.perf_counter() - t0:.1f} s")
        with tempfile.TemporaryDirectory() as workdir:
            t0 = time.perf_counter()
            summary["10c_gen_dets"] = run_gen_dets(workdir)
            report_numbers(card, "phase 10c, gen-dets (YOLOv5-l bf16, batch "
                           f"{FUSED_BATCH}, conf {DET_CONF})", summary["10c_gen_dets"])
            log(f"phase 10c: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            launches, batches, stats, rates = run_e2e(workdir)
            summary["10d_e2e"] = {"launches": launches, "pose_batches": batches,
                                  "stats": stats, **rates}
            report_numbers(card, "phase 10d, e2e (fused_layer1, flip-test)", rates)
            log(f"phase 10d: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            fused_runs, pred, det, b_canvases, b_shapes = run_fused(workdir)
            summary["10b_nms"] = check_nms(pred)
            report_numbers(card, f"phase 10b, NMS card vs CPU at batch {FUSED_BATCH}",
                           summary["10b_nms"])
            fused_runs["yolov5"]["pose_stage"] = check_pose_stage(b_canvases, b_shapes,
                                                                  det["boxes"])
            del pred, det
            torch.cuda.empty_cache()
            for name, out in fused_runs.items():
                key = "10f_fused_rect" if name == "yolov5_rect" else f"10e_fused_{name}"
                summary[key] = out
                report_numbers(card, f"phase {key[:3]}, fused {name} at batch {FUSED_BATCH} x "
                               f"{MAX_PEOPLE}", out)
            log(f"phase 10e/10f: {time.perf_counter() - t0:.1f} s")
    finally:
        data_pipeline._imread_rgb = orig
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return summary, summary["10d_e2e"]["launches"]["bottleneck_chain"]


# ---------------------------------------------------------------------------
# phase 11: W8A8 and the serving export
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def int8_checked(record):
    """Every int8 product on the card's route inside is held against the
    plain version on the same tensors (``record`` gets one bool per conv
    call); the counter stays on ``int8_conv``."""
    route = i8._int8_conv_cuda

    def checked(x8, w8, stride, padding, dilation, groups):
        y = route(x8, w8, stride, padding, dilation, groups)
        record.append(bool(torch.equal(
            y, i8.int8_conv_reference(x8, w8, stride, padding, dilation, groups))))
        return y

    i8._int8_conv_cuda = checked
    try:
        yield
    finally:
        i8._int8_conv_cuda = route


@torch.no_grad()
def check_int8_convs(model, x, label):
    """11a: one quantized forward of ``model`` with every conv's int32
    product held against the plain version."""
    record = []
    int8_conv.launches = 0
    with int8_checked(record), quantized(model, "w8a8"):
        y = model(x)
    n = len(quant.quantized_convs(model))
    out = {"convs_checked": len(record), "quantized_convs": n, "all_equal": all(record),
           "route_calls": int8_conv.launches,
           "finite": bool(torch.isfinite(y.float()).all())}
    log(f"phase 11a, {label}: " + json.dumps(out))
    assert out["all_equal"] and out["finite"] and len(record) == n == out["route_calls"], out
    return out


# 11a's timed convs of the flagship at the serving batch: (module, input NCHW)
INT8_TIMED = {"stem conv1": ("conv1", (THROUGHPUT_BATCH, 3) + CROP_HW),
              "layer2.1.conv2 (3x3)": ("layer2.1.conv2", (THROUGHPUT_BATCH, 128, 32, 24)),
              "layer4.1.conv1 (1x1)": ("layer4.1.conv1", (THROUGHPUT_BATCH, 2048, 8, 6))}
PEAK_INT8_OPS = 1979e12


@torch.no_grad()
def time_int8_convs(model):
    """11a: the int8 product (route, and torch._int_mm alone) against its
    plain version and cuDNN's bf16 conv at the same shape, with the whole
    quantized conv (quantize, product, dequantize) beside."""
    rows = {}
    gen = torch.Generator().manual_seed(11)
    for label, (name, shape) in INT8_TIMED.items():
        conv = model.get_submodule(name)
        x = torch.randn(shape, generator=gen).cuda().relu_()
        w8, s_w = quant.quantize_weight(conv.weight)
        x8, _ = quant.quantize_input(x)
        args = (conv.stride, conv.padding, conv.dilation, conv.groups)
        y = int8_conv(x8, w8, *args)
        equal = bool(torch.equal(y, i8.int8_conv_reference(x8, w8, *args)))
        cols, _, _ = i8._patches(x8, *conv.kernel_size, *args[:3])
        m, k = cols.shape
        n = w8.shape[0]
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        a = torch.nn.functional.pad(cols, (0, kp - k))
        wmat = w8.permute(0, 2, 3, 1).reshape(n, k)
        wt = torch.nn.functional.pad(wmat, (0, kp - k, 0, np_ - n)).t()
        xb, wb = x.to(torch.bfloat16), conv.weight.to(torch.bfloat16)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            w8a8_ms = cuda_ms(lambda: quant.w8a8_conv2d(conv, x, w8, s_w))
        ops = 2.0 * m * n * k
        nbytes = x8.numel() + w8.numel() + 4 * y.numel()
        bound = max(nbytes / PEAK_BYTES, ops / PEAK_INT8_OPS) * 1e3
        rows[label] = {
            "x": list(shape), "w": list(w8.shape), "gemm_mnk": [m, n, k], "equal": equal,
            "route_ms": cuda_ms(lambda: int8_conv(x8, w8, *args)),
            "int_mm_ms": cuda_ms(lambda: torch._int_mm(a, wt)),
            "w8a8_conv_ms": w8a8_ms,
            "cudnn_bf16_ms": cuda_ms(lambda: torch.nn.functional.conv2d(
                xb, wb, None, *args)),
            "plain_ms": cuda_ms(lambda: i8.int8_conv_reference(x8, w8, *args), iters=2,
                                warmup=1),
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / PEAK_BYTES > ops / PEAK_INT8_OPS else "operations"}
        assert equal, (label, rows[label])
    return rows


def staged_serving_batch(n, seed):
    batch, _, _ = synthetic_batch(np.random.default_rng(seed), n, 1)
    return {k: torch.from_numpy(batch[k]).cuda() for k in ("canvas", "trans", "trans_inv")}


def serve_rates(evaluators, batch, reps=5, rounds=2):
    """Crops/s of each evaluator on one device-staged batch, in turns."""
    seconds = {name: 0.0 for name in evaluators}
    for ev in evaluators.values():
        ev(batch)
    for r in range(rounds):
        for name, ev in (evaluators.items() if r % 2 == 0 else reversed(evaluators.items())):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                {k: v.cpu() for k, v in ev(batch).items()}
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t0
    n = batch["trans"].shape[0]
    return {name: rounds * reps * n / t for name, t in seconds.items()}


@contextlib.contextmanager
def conv_inputs(record):
    """Record each quantized conv's input (f32, on the host) with its key
    and static scale, in call order."""
    forward = quant.W8A8._forward

    def recording(self, key, conv, x):
        s_x = self._static.get(key)
        record.append((key, x.detach().float().cpu(), None if s_x is None else float(s_x)))
        return forward(self, key, conv, x)

    quant.W8A8._forward = recording
    try:
        yield
    finally:
        quant.W8A8._forward = forward


def first_divergence(card, cpu):
    """Where the card's and the CPU's quantized forwards part: per conv in
    call order, the x8 elements that round the other way and the relative
    difference of the float inputs.  Returns the first conv with a flip,
    its flips, and the largest input difference up to and including it."""
    rows = []
    for (key, xg, s_x), (key_c, xc, s_c) in zip(card, cpu):
        assert key == key_c and s_x == s_c, (key, key_c, s_x, s_c)
        flips = int((quant.quantize_input(xg, s_x)[0] != quant.quantize_input(xc, s_x)[0]).sum())
        rel = float((xg - xc).abs().max() / xc.abs().max().clamp_min(1e-30))
        rows.append({"conv": key, "flips": flips, "elements": xc.numel(), "input_rel": rel})
    assert len(card) == len(cpu) == len(rows) > 0
    first = next((i for i, r in enumerate(rows) if r["flips"]), len(rows) - 1)
    return {"convs": len(rows), "first_flip_index": first, **rows[first],
            "input_rel_up_to_first_flip": max(r["input_rel"] for r in rows[:first + 1]),
            "convs_with_flips": sum(r["flips"] > 0 for r in rows),
            "flips_total": sum(r["flips"] for r in rows)}


def quant_card_vs_cpu(big, scales, ev_bf16):
    """11b: the f32 quantized forward on the card against the CPU on the
    same static scales and 2 crops, for two seeds: where they first part
    (first_divergence), the heatmaps' max/mean relative error and cosine,
    and, as the lower-precision control, the card's bf16 quantized
    heatmaps against its f32 ones on the same crops."""
    f32 = dict(amp=False, fused_layer1=True, flip_test=True, quant="w8a8", quant_scales=scales)
    ev_gpu = PoseEvaluator(CFG, None, INPUT_SHAPE, **f32)
    ev_cpu = PoseEvaluator(CFG, None, INPUT_SHAPE, device="cpu", **f32)
    out = {}
    for seed in QUANT_CARD_CPU_SEEDS:
        two = {k: v[:2].cpu() for k, v in staged_serving_batch(2, seed).items()}
        rec_gpu, rec_cpu = [], []
        with conv_inputs(rec_gpu):
            h_gpu = ev_gpu.heatmaps(two).cpu()
        with conv_inputs(rec_cpu):
            h_cpu = ev_cpu.heatmaps(two)
        h_bf16 = ev_bf16.heatmaps(two).float().cpu()
        _, mx, mean = errors(h_gpu, h_cpu)
        _, ctl_mx, ctl_mean = errors(h_bf16, h_gpu)
        out[f"seed {seed}"] = {
            "first_divergence": first_divergence(rec_gpu, rec_cpu),
            "max_rel": mx, "mean_rel": mean,
            "cos": float(torch.nn.functional.cosine_similarity(h_gpu.flatten(),
                                                               h_cpu.flatten(), dim=0)),
            "control_bf16_vs_f32_card_max_rel": ctl_mx,
            "control_bf16_vs_f32_card_mean_rel": ctl_mean}
    return out


@torch.no_grad()
def run_quant_serving():
    """11b: PoseEvaluator(quant='w8a8') at the serving batch, dynamic then
    calibrated, beside bf16; its counted run, every int8 product held
    against the plain version; the quantized vs float heatmaps; f32 card
    vs CPU on the same static scales."""
    kw = dict(amp="auto", fused_layer1=True, flip_test=True)
    ev_f = PoseEvaluator(CFG, None, INPUT_SHAPE, **kw)
    ev_q = PoseEvaluator(CFG, None, INPUT_SHAPE, quant="w8a8", **kw)
    big = staged_serving_batch(THROUGHPUT_BATCH, 2)
    layer1 = sum(type(m) is torch.nn.Conv2d for m in ev_q.model.layer1.modules())
    n_quantized = len(quant.quantized_convs(ev_q.model)) - layer1  # layer1 runs K2
    record = []
    zero_launch_counts()
    with int8_checked(record):
        out = {k: v.cpu() for k, v in ev_q(big).items()}
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"phase 11b, quantized serving at batch {THROUGHPUT_BATCH}: launches {launches}; "
        f"{len(record)} int8 products held against the plain version, all equal: "
        f"{all(record)}")
    assert launches["bottleneck_chain"] == 2 and launches["int8_conv"] == 2 * n_quantized, \
        (launches, n_quantized)
    assert len(record) == launches["int8_conv"] and all(record), record
    assert torch.isfinite(out["kps"]).all() and torch.isfinite(out["conf"]).all()
    small = {k: v[:BATCH] for k, v in big.items()}
    hq, hf = ev_q.heatmaps(small), ev_f.heatmaps(small)
    cos = float(torch.nn.functional.cosine_similarity(hq.flatten(), hf.flatten(), dim=0))
    dynamic = serve_rates({"bf16": ev_f, "w8a8_dynamic": ev_q}, big)
    calib = [staged_serving_batch(BATCH, seed=20 + i) for i in range(2)]
    scales = ev_q.calibrate(iter(calib), 2)
    hs = ev_q.heatmaps(small)
    cos_static = float(torch.nn.functional.cosine_similarity(hs.flatten(), hf.flatten(), dim=0))
    static = serve_rates({"bf16": ev_f, "w8a8_static": ev_q}, big)
    card_cpu = quant_card_vs_cpu(big, scales, ev_q)
    res = {"launches": launches, "int8_products_checked": len(record),
           "cos_w8a8_dynamic_vs_bf16": cos, "cos_w8a8_static_vs_bf16": cos_static,
           "crops_per_s_dynamic": dynamic, "crops_per_s_static": static, "scales": len(scales),
           "f32_card_vs_cpu": card_cpu}
    log("phase 11b: " + json.dumps(res))
    assert cos > QUANT_COS and cos_static > QUANT_COS, res
    for row in card_cpu.values():
        assert row["first_divergence"]["input_rel_up_to_first_flip"] < QUANT_UPSTREAM_REL, row
        assert row["max_rel"] < QUANT_CARD_CPU_REL[0] and \
            row["mean_rel"] < QUANT_CARD_CPU_REL[1], row
        assert row["cos"] > QUANT_COS, row
    return res, scales


def run_quant_detector(workdir, float_rates):
    """11c: gen-dets and fused with --quant w8a8 --quant-calib 2 on the
    fixture, then timed passes on the saved scales (as --scales), beside
    phase 10's float medians of the same call."""
    det_scales = os.path.join(workdir, "det_scales.json")
    int8_conv.launches = 0
    det = YOLOv5Detector(**detector_kw("yolov5", quant="w8a8"))
    kw = dict(out_path=os.path.join(workdir, "q_dets.json"), batch_size=FUSED_BATCH,
              canvas=DET_CANVAS, use_native=True)
    gen_detections(DET_IMAGES, DET_GT, detector=det, quant_calib=2,
                   quant_scales_out=det_scales, **kw)
    calls = int8_conv.launches
    det = YOLOv5Detector(**detector_kw("yolov5", quant="w8a8",
                                       quant_scales=quant.load_scales(det_scales)))
    seconds, results = timed_passes(lambda: gen_detections(DET_IMAGES, DET_GT, detector=det,
                                                           **kw), 3)
    fused_scales = os.path.join(workdir, "fused_scales.json")
    fkw = dict(scale_name="l", det_size=(DET_SIZE, DET_SIZE), input_shape=INPUT_SHAPE,
               max_people=MAX_PEOPLE, det_conf=DET_CONF, det_iou=DET_IOU, canvas=DET_CANVAS,
               quant="w8a8")
    ekw = dict(batch_size=FUSED_BATCH, input_shape=INPUT_SHAPE, max_people=MAX_PEOPLE,
               canvas=DET_CANVAS, use_native=True, out_path=os.path.join(workdir, "q_f.json"),
               filtered_out_path=os.path.join(workdir, "q_ff.json"))
    # the calibrating run at the fused batch: every int8 product of both
    # nets held against the plain version
    record = []
    int8_conv.launches = 0
    with int8_checked(record):
        fused_eval(DET_IMAGES, DET_GT, CFG, fused=FusedDetectPose(CFG, **fkw), quant_calib=2,
                   quant_scales_out=fused_scales, **ekw)
    fused_calls = int8_conv.launches
    assert len(record) == fused_calls > 0 and all(record), (len(record), fused_calls)
    nets = quant.load_scales(fused_scales)
    fused = FusedDetectPose(CFG, quant_scales=nets, **fkw)
    fseconds, stats = timed_passes(lambda: fused_eval(DET_IMAGES, DET_GT, CFG, fused=fused,
                                                      **ekw), 3)
    with open(ekw["out_path"]) as f:
        preds = json.load(f)
    n_images = len(np.unique([p["img_id"] for p in preds]))
    stats = {k: float(v) for k, v in stats.items()}
    with open(DET_GT) as f:
        n_fixture = len(json.load(f)["images"])
    res = {"gen_dets_images_per_s": pass_rates(seconds, n_fixture),
           "gen_dets_float_images_per_s_phase10": float_rates["gen_dets"],
           "gen_dets_boxes": len(results), "gen_dets_calib_route_calls": calls,
           "fused_calib_int8_products_checked": len(record),
           "fused_images_per_s": pass_rates(fseconds, n_images),
           "fused_float_images_per_s_phase10": float_rates["fused"],
           "fused_crops": len(preds), "fused_stats": stats,
           "scales": {"detector": len(quant.load_scales(det_scales)),
                      "fused": {k: len(v) for k, v in nets.items()}}}
    log("phase 11c: " + json.dumps(res))
    assert calls > 0 and len(results) > 0 and set(nets) == {"detector", "pose"}
    assert all(np.isfinite(p["kps"]).all() for p in preds) and 0.0 <= stats["AP"] <= 1.0
    return res


# 11d: the loaded artifact runs in a fresh process that imports torch and
# the op registrations only; an artifact traced on the CPU is moved to the
# card there (move_to_device_pass, what load_exported(device=) does)
SERVE_CHILD = r"""
import json, sys, time
import torch
import simple_pose_torch.ops.bottleneck_chain as k2
import simple_pose_torch.ops.int8_conv as i8
path, inputs, outputs, reps, move = sys.argv[1:6]
reps = int(reps)
torch.backends.cudnn.allow_tf32 = False  # as in the parent: f32 stays f32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = move == "cuda"  # as the parent's copy
sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
t0 = time.perf_counter()
ep = torch.export.load(path)
if move == "cuda":
    from torch.export.passes import move_to_device_pass
    ep = move_to_device_pass(ep, torch.device("cuda"))
fn = ep.module()
load_s = time.perf_counter() - t0
args = torch.load(inputs)
k2.bottleneck_chain.launches = i8.int8_conv.launches = 0
with torch.no_grad():
    out = fn(*args)
    sync()
    launches = {"bottleneck_chain": k2.bottleneck_chain.launches,
                "int8_conv": i8.int8_conv.launches}
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    sync()
    seconds = time.perf_counter() - t0
torch.save({k: v.cpu() for k, v in out.items()}, outputs)
mods = sorted(m for m in sys.modules if m.startswith("simple_pose"))
print(json.dumps({"load_s": load_s, "crops_per_s": reps * args[0].shape[0] / seconds,
                  "launches_first_call": launches, "modules": mods}))
"""
EXPORT_BATCH, EXPORT_REPS = 64, 10


@torch.no_grad()
def run_export(workdir, scales):
    """11d: the flagship (bf16, fused_layer1) and its w8a8 version on the
    calibrated scales, exported at batch 64 on a 640 canvas, saved, loaded
    in a fresh process: its outputs against the live evaluator's; then the
    f32 w8a8 evaluator traced on the CPU, moved to the card in the fresh
    process, against the live f32 one on the card."""
    batch = staged_serving_batch(EXPORT_BATCH, seed=31)
    args = (batch["canvas"], batch["trans"], batch["trans_inv"])
    inputs = os.path.join(workdir, "export_inputs.pt")
    torch.save(args, inputs)
    q = dict(quant="w8a8", quant_scales=scales)
    # the CPU-traced program returns heatmaps (dark_original): gauss_taylor's
    # 11-tap kernel is a constant computed where the trace runs, and one ulp
    # of it moves keypoints on a seeded net's near-singular Hessians by
    # thousands of pixels (phase 10; heatmaps are what the trace decides)
    runs = (("bf16_fused_layer1", dict(amp="auto"), None),
            ("w8a8_static_fused_layer1", dict(amp="auto", **q), None),
            ("w8a8_static_fused_layer1_f32_cpu_traced",
             dict(amp=False, decoder="dark_original", **q), "cpu"))
    res = {}
    for name, kw, trace_device in runs:
        ev = PoseEvaluator(CFG, None, INPUT_SHAPE, fused_layer1=True, **kw)
        traced = ev if trace_device is None else PoseEvaluator(
            CFG, None, INPUT_SHAPE, fused_layer1=True, device=trace_device, **kw)
        layer1 = sum(type(m) is torch.nn.Conv2d for m in ev.model.layer1.modules())
        t0 = time.perf_counter()
        exported = export_evaluator(traced, EXPORT_BATCH, (CANVAS, CANVAS))
        export_s = time.perf_counter() - t0
        path = os.path.join(workdir, f"{name}.pt2")
        nbytes = save_exported(exported, path)
        del exported, traced
        live = {k: v.cpu() for k, v in ev.step(*args).items()}
        # the same program twice, cuDNN free to pick a nondeterministic
        # algorithm; then the copy held to the loaded one, with cuDNN's
        # deterministic algorithms (which the fresh process uses too)
        again = {k: v.cpu() for k, v in ev.step(*args).items()}
        live_repeat = {k: (again[k].float() - live[k].float()).abs().max().item() for k in live}
        if trace_device is not None:
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                            allow_tf32=False):
                live = {k: v.cpu() for k, v in ev.step(*args).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXPORT_REPS):
            ev.step(*args)
        torch.cuda.synchronize()
        live_rate = EXPORT_REPS * EXPORT_BATCH / (time.perf_counter() - t0)
        outputs = os.path.join(workdir, f"{name}_out.pt")
        proc = subprocess.run(
            [sys.executable, "-c", SERVE_CHILD, path, inputs, outputs, str(EXPORT_REPS),
             "cuda" if trace_device else "none"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600, env={**os.environ, "PYTHONPATH": os.path.dirname(
                os.path.abspath(__file__))})
        assert proc.returncode == 0, proc.stderr[-4000:]
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        got = torch.load(outputs)
        diff = {k: (got[k].float() - live[k].float()).abs().max().item() for k in live}
        res[name] = {"bytes": nbytes, "export_s": export_s, "live_crops_per_s": live_rate,
                     "bitwise_equal": all(torch.equal(got[k], live[k]) for k in live),
                     "max_abs_diff": diff, "live_repeat_max_abs_diff": live_repeat,
                     "live_max_abs": {k: live[k].float().abs().max().item() for k in live},
                     **child}
        log(f"phase 11d, {name}: " + json.dumps(res[name]))
        n_int8 = len(quant.quantized_convs(ev.model)) - layer1 if "quant" in kw else 0
        assert set(got) == set(live) and child["launches_first_call"] == {
            "bottleneck_chain": 1, "int8_conv": n_int8}, (res[name], n_int8)
        assert not [m for m in child["modules"] if not m.startswith(
            ("simple_pose_torch.ops", "simple_pose_torch.utils"))
            and m != "simple_pose_torch"], child["modules"]
        if "heat" in live:
            assert diff["heat"] <= EXPORT_HEAT_REL * live["heat"].abs().max().item(), res[name]
        else:
            assert diff["kps"] <= EXPORT_TOL[0] and diff["conf"] <= EXPORT_TOL[1], res[name]
        del ev
        torch.cuda.empty_cache()
    return res


def run_quant_path(card, float_rates):
    """Phase 11.  Returns the summary and K2's launches in 11b and 11d."""
    t_phase = time.perf_counter()
    summary = {"card": card}
    t0 = time.perf_counter()
    r50 = build_resnet("resnet50", se=True, dtype=torch.bfloat16).cuda()
    x = torch.rand((2, 3) + CROP_HW, generator=torch.Generator().manual_seed(4)).cuda() - 0.45
    summary["11a_resnet50_se"] = check_int8_convs(r50, x, "ResNet-50+SE bf16, 2 crops")
    summary["11a_timing"] = time_int8_convs(r50)
    del r50
    yolo = build_detector("yolov5", 1, "l", dtype=torch.bfloat16).cuda()
    x = torch.rand((1, 3, DET_SIZE, DET_SIZE), generator=torch.Generator().manual_seed(5)).cuda()
    summary["11a_yolov5l"] = check_int8_convs(yolo, x, f"YOLOv5-l bf16, 1 image {DET_SIZE}^2")
    del yolo
    torch.cuda.empty_cache()
    for label, row in summary["11a_timing"].items():
        report_numbers(card, f"phase 11a, int8 product {label} at batch {THROUGHPUT_BATCH}",
                       {k: row[k] for k in ("route_ms", "int_mm_ms", "w8a8_conv_ms",
                                            "cudnn_bf16_ms", "plain_ms", "bound_ms")})
    log(f"phase 11a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serving, scales = run_quant_serving()
    summary["11b_serving"] = serving
    report_numbers(card, f"phase 11b, serving crops/s at batch {THROUGHPUT_BATCH} (fused_layer1, "
                   "flip-test)", {**{f"dynamic {k}": v for k, v in
                                     serving["crops_per_s_dynamic"].items()},
                                  **{f"static {k}": v for k, v in
                                     serving["crops_per_s_static"].items()}})
    log(f"phase 11b: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        orig, data_pipeline._imread_rgb = data_pipeline._imread_rgb, _no_cv2
        try:
            summary["11c_detector"] = run_quant_detector(workdir, float_rates)
        finally:
            data_pipeline._imread_rgb = orig
        c = summary["11c_detector"]
        report_numbers(card, "phase 11c, images/s median (w8a8 static / float phase 10)",
                       {"gen-dets": f"{c['gen_dets_images_per_s']['median']} / "
                                    f"{c['gen_dets_float_images_per_s_phase10']}",
                        "fused": f"{c['fused_images_per_s']['median']} / "
                                 f"{c['fused_float_images_per_s_phase10']}"})
        log(f"phase 11c: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        summary["11d_export"] = run_export(workdir, scales)
        for name, row in summary["11d_export"].items():
            report_numbers(card, f"phase 11d, {name} artifact at batch {EXPORT_BATCH}",
                           {k: row[k] for k in ("bytes", "export_s", "load_s", "crops_per_s",
                                                "live_crops_per_s")})
        log(f"phase 11d: {time.perf_counter() - t0:.1f} s")
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    artifact = {name: row["launches_first_call"]["bottleneck_chain"]
                for name, row in summary["11d_export"].items()}
    return summary, serving["launches"]["bottleneck_chain"], artifact


# ---------------------------------------------------------------------------
# phase 12: progressive JPEGs, the fused export and the demos
# ---------------------------------------------------------------------------
PROGRESSIVE_DIR = os.path.join(FIXTURE, "progressive")
# 12a: one scene as baseline (det image 1) and as progressive (its
# progressive 4:4:4 re-encoding), each decoded DECODE_COPIES at once
DECODE_SCENE = {"baseline": os.path.join(DET_IMAGES, "000000000001.jpg"),
                "progressive": os.path.join(PROGRESSIVE_DIR, "p444.jpg")}
DECODE_COPIES, DECODE_REPS = 64, 3
# 12b: live and loaded calls timed per turn
FUSED_EXPORT_REPS = 5
# 12b: the loaded fused program against the live one, both with cuDNN's
# deterministic algorithms: boxes and keypoints in px (the same ops on the
# same inputs; any larger difference would be a different program)
FUSED_EXPORT_TOL = (1e-3, 1e-3)
# 12c: the demos; the GT box of the fixture's first person
DEMO_BOX = "63.75,14.53,244.54,271.06"
DEMO_FRAMES, DEMO_BATCH = 16, 4

# 12b: the loaded fused artifact runs in a fresh process that imports torch
# and the int8 product's op registration only
FUSED_CHILD = r"""
import json, sys, time
import torch
import simple_pose_torch.ops.int8_conv as i8
path, inputs, outputs, reps = sys.argv[1:5]
reps = int(reps)
torch.backends.cudnn.deterministic = True  # as the parent's live program
t0 = time.perf_counter()
fn = torch.export.load(path).module()
load_s = time.perf_counter() - t0
args = [a.cuda() for a in torch.load(inputs)]
i8.int8_conv.launches = 0
with torch.no_grad():
    out = fn(*args)
    torch.cuda.synchronize()
    launches = i8.int8_conv.launches
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
torch.save({k: v.cpu() for k, v in out.items()}, outputs)
mods = sorted(m for m in sys.modules if m.startswith("simple_pose"))
print(json.dumps({"load_s": load_s, "images_per_s": reps * args[0].shape[0] / seconds,
                  "int8_conv_launches_first_call": launches, "modules": mods}))
"""


def load_script(name):
    """A module of scripts/ (not a package) by file name."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_progressive_decode():
    """12a: the committed progressive fixture against its CRC32s through
    the port's decoder, then host images/s of one scene as baseline and as
    progressive with 8 decode threads and with 1."""
    with open(os.path.join(PROGRESSIVE_DIR, "decoded_crc32.json")) as f:
        want = json.load(f)
    rels = sorted(want)
    loader = native.NativeCanvasLoader(8)
    canvases, hs, ws = loader.load_batch([os.path.join(FIXTURE, r) for r in rels], CANVAS)
    crc = [r for r, c, h, w in zip(rels, canvases, hs, ws)
           if (h, w) != (want[r]["height"], want[r]["width"])
           or zlib.crc32(np.ascontiguousarray(c[:h, :w]).tobytes()) != want[r]["crc32"]]
    out = {"decoder": loader.decoder, "images": len(rels), "crc32_equal": len(rels) - len(crc)}
    for threads in (8, 1):
        pool = native.NativeCanvasLoader(threads)
        for kind, path in DECODE_SCENE.items():
            paths = [path] * DECODE_COPIES
            pool.load_batch(paths, CANVAS)
            seconds = []
            for _ in range(DECODE_REPS):
                t0 = time.perf_counter()
                pool.load_batch(paths, CANVAS)
                seconds.append(time.perf_counter() - t0)
            out[f"{kind}_{threads}_threads_images_per_s"] = pass_rates(seconds, DECODE_COPIES)
        pool.close()
    log("phase 12a, progressive decode: " + json.dumps(out))
    assert loader.decoder == "baseline", "12a holds the port's decoder; this machine has libjpeg"
    assert not crc, f"progressive pixels differ from the committed CRC32s: {crc}"
    return out


def fused_calib_batches():
    """The fixture's images 9-24 as two (canvases, shapes) batches."""
    canvases, shapes = fixture_canvases(3 * FUSED_BATCH)
    return [(canvases[i:i + FUSED_BATCH], shapes[i:i + FUSED_BATCH])
            for i in (FUSED_BATCH, 2 * FUSED_BATCH)]


@torch.no_grad()
def run_fused_export(workdir, canvases, shapes):
    """12b: export_fused of the fused program (YOLOv5-l + ResNet-50-DConv+SE)
    in bf16 and in w8a8 on calibrated scales, saved, loaded in a fresh
    process, against the live program on the same batch; then the NMS
    loop against the old fixed point on the live program's pred."""
    fkw = dict(scale_name="l", det_size=(DET_SIZE, DET_SIZE), input_shape=INPUT_SHAPE,
               max_people=MAX_PEOPLE, det_conf=DET_CONF, det_iou=DET_IOU, canvas=DET_CANVAS)
    res, pred = {}, None
    for name, kw in (("bf16", {}), ("w8a8_static", {"quant": "w8a8"})):
        fused = FusedDetectPose(CFG, **fkw, **kw)
        if fused.quant:
            fused.calibrate(fused_calib_batches(), 2)
        args = fused.prepare(canvases, shapes)[:5]
        t0 = time.perf_counter()
        exported = export_fused(fused, FUSED_BATCH, DET_CANVAS)
        export_s = time.perf_counter() - t0
        path = os.path.join(workdir, f"fused_{name}.pt2")
        nbytes = save_exported(exported, path)
        del exported
        inputs = os.path.join(workdir, "fused_inputs.pt")
        torch.save([a.cpu() for a in args], inputs)

        def live_rate():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FUSED_EXPORT_REPS):
                fused.program(*args)
            torch.cuda.synchronize()
            return FUSED_EXPORT_REPS * FUSED_BATCH / (time.perf_counter() - t0)

        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            live = {k: v.cpu() for k, v in fused.program(*args).items()}
            rates = [live_rate()]
            outputs = os.path.join(workdir, f"fused_{name}_out.pt")
            proc = subprocess.run(
                [sys.executable, "-c", FUSED_CHILD, path, inputs, outputs,
                 str(FUSED_EXPORT_REPS)],
                cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                timeout=600, env={**os.environ, "PYTHONPATH": os.path.dirname(
                    os.path.abspath(__file__))})
            assert proc.returncode == 0, proc.stderr[-4000:]
            rates.append(live_rate())
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        got = torch.load(outputs)
        valid = live["det_valid"]
        diff = {k: (got[k].float() - live[k].float()).abs().max().item() for k in live}
        n_int8 = (len(quant.quantized_convs(fused.detector.model))
                  + len(quant.quantized_convs(fused.pose_model))) if fused.quant else 0
        res[name] = {"bytes": nbytes, "export_s": export_s, "load_s": child["load_s"],
                     "loaded_images_per_s": child["images_per_s"],
                     "live_images_per_s_before_after": rates,
                     "int8_conv_launches_loaded": child["int8_conv_launches_first_call"],
                     "int8_convs": n_int8, "det_valid_equal": torch.equal(got["det_valid"], valid),
                     "valid_boxes": int(valid.sum()),
                     "bitwise_equal": all(torch.equal(got[k], live[k]) for k in live),
                     "max_abs_diff": diff, "modules": child["modules"]}
        for f in (path, outputs):
            os.remove(f)
        log(f"phase 12b, fused {name}: " + json.dumps(res[name]))
        assert set(got) == set(live) and res[name]["det_valid_equal"], res[name]
        assert diff["boxes"] <= FUSED_EXPORT_TOL[0] and diff["kps"] <= FUSED_EXPORT_TOL[1], \
            res[name]
        assert child["int8_conv_launches_first_call"] == n_int8, res[name]
        assert not [m for m in child["modules"] if not m.startswith(
            ("simple_pose_torch.ops", "simple_pose_torch.utils"))
            and m != "simple_pose_torch"], child["modules"]
        if pred is None:
            x = fused.letterbox(*args[:3], DET_SIZE, DET_SIZE)
            with fused._contexts["detector"]:
                pred = fused.detector.model(x)
        del fused, live, got
        torch.cuda.empty_cache()
    res["nms_loops"] = load_script("time_torch_nms").time_loops(pred, timer=cuda_ms)
    log("phase 12b, NMS loop: " + json.dumps(res["nms_loops"]))
    return res


def planted_detector(path):
    """A seeded YOLOv5-l 80-class checkpoint with its stride-32 anchor 2
    made sure of a person (objectness and person logits' biases 6), so that
    the demos' conf 0.25 keeps boxes: a seeded detector scores at its
    prior (the 80-class person prior is ~0.01)."""
    from simple_pose_torch.detector.yolov5 import YOLOv5

    state = YOLOv5(num_cls=80, scale_name="l").state_dict()
    state["head.heads.2.bias"].view(3, 85)[2, 4:6] = 6.0
    torch.save({"ema": state}, path)
    return path


def run_demos(workdir, canvases):
    """12c: demo_image (its main, on the card) from a baseline and a
    progressive JPEG, with --box and with the detector, each PNG read back;
    then demo_video's frame loop over synthetic frames; then serve_artifact
    --out on a fused_layer1 artifact of eval export (K2 once per call)."""
    from simple_pose_torch import demo_image, demo_video, serve_artifact
    from simple_pose_torch import eval as teval
    from simple_pose_torch.utils.viz import read_png

    det_path = planted_detector(os.path.join(workdir, "yolov5l_planted.pth"))
    res = {}
    for image in (DECODE_SCENE["baseline"], DECODE_SCENE["progressive"]):
        for mode in ("box", "detector"):
            name = f"{os.path.basename(image)}_{mode}"
            out = os.path.join(workdir, f"{name}.png")
            argv = ["--image", image, "--reduction", "--out", out]
            argv += ["--box", DEMO_BOX] if mode == "box" else ["--det-weights", det_path]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                demo_image.main(argv)
            seconds = time.perf_counter() - t0
            people = json.loads(buf.getvalue().strip().splitlines()[-1])["people"]
            png = read_png(out)
            res[name] = {"seconds": seconds, "people": len(people), "png_shape": list(png.shape),
                         "finite": bool(np.isfinite([p["keypoints"] for p in people]).all())}
            assert png.shape == (480, 640, 3) and people and res[name]["finite"], res[name]
    # demo_video's loop: 16 frames, the fixture's first image shifted 4 px a frame
    fused = FusedDetectPose(CFG, None, det_path, scale_name="l", max_people=MAX_PEOPLE,
                            det_conf=0.25, canvas=demo_video.canvas_edge(480, 640))
    base = np.ascontiguousarray(canvases[0, :480, :640])
    frames = [np.roll(base, 4 * i, axis=1) for i in range(DEMO_FRAMES)]
    sink = []
    demo_video.run_frames(fused, frames[:DEMO_BATCH], sink.append, DEMO_BATCH)  # warm
    sink.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = demo_video.run_frames(fused, iter(frames), sink.append, DEMO_BATCH)
    ms = (time.perf_counter() - t0) * 1e3 / DEMO_FRAMES
    drawn = sum(int((f != g).any()) for f, g in zip(sink, frames))
    res["demo_video"] = {"frames_in": DEMO_FRAMES, "frames_out": written, "sunk": len(sink),
                         "frames_drawn_on": drawn, "ms_per_frame": ms, "batch": DEMO_BATCH}
    assert written == len(sink) == DEMO_FRAMES and drawn == DEMO_FRAMES, res["demo_video"]
    del fused
    # serve_artifact --out on a fused_layer1 artifact: K2 launches once
    artifact = os.path.join(workdir, "pose_l1.pt2")
    with contextlib.redirect_stdout(io.StringIO()):
        teval.main(["export", "--model-name", "resnet50", "--reduction", "--fused-layer1",
                    "--batch-size", "2", "--canvas", str(CANVAS), "--out", artifact])
    out = os.path.join(workdir, "served.png")
    zero_launch_counts()
    box = tuple(float(v) for v in DEMO_BOX.split(","))
    served = serve_artifact.serve(artifact, DECODE_SCENE["progressive"], [box], out=out)
    torch.cuda.synchronize()
    launches = launch_counts()
    res["serve_artifact_out"] = {"launches": launches, "people": len(served["people"]),
                                 "png_shape": list(read_png(out).shape)}
    assert launches["bottleneck_chain"] == 1, res["serve_artifact_out"]
    assert res["serve_artifact_out"]["png_shape"] == [480, 640, 3]
    log("phase 12c, demos: " + json.dumps(res))
    return res


def run_port_apps(card):
    """Phase 12.  Returns the summary and K2's launches in 12c."""
    t_phase = time.perf_counter()
    summary = {"card": card}
    t0 = time.perf_counter()
    summary["12a_progressive"] = check_progressive_decode()
    report_numbers(card, "phase 12a, host images/s median of one 640x480 scene",
                   {k: v["median"] for k, v in summary["12a_progressive"].items()
                    if k.endswith("images_per_s")})
    log(f"phase 12a: {time.perf_counter() - t0:.1f} s")
    orig, data_pipeline._imread_rgb = data_pipeline._imread_rgb, _no_cv2
    try:
        canvases, shapes = fixture_canvases(FUSED_BATCH)
        with tempfile.TemporaryDirectory() as workdir:
            t0 = time.perf_counter()
            summary["12b_export_fused"] = run_fused_export(workdir, canvases, shapes)
            for name in ("bf16", "w8a8_static"):
                row = summary["12b_export_fused"][name]
                report_numbers(card, f"phase 12b, fused {name} artifact at batch {FUSED_BATCH}",
                               {k: row[k] for k in ("bytes", "export_s", "load_s",
                                                    "loaded_images_per_s",
                                                    "live_images_per_s_before_after")})
            for md, row in summary["12b_export_fused"]["nms_loops"].items():
                report_numbers(card, f"phase 12b, NMS {md} ms (loop, host, while_loop)",
                               {"ms": row["ms"], "rounds": row["rounds"]})
            log(f"phase 12b: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            summary["12c_demos"] = run_demos(workdir, canvases)
            report_numbers(card, "phase 12c, demo_video", {
                k: summary["12c_demos"]["demo_video"][k] for k in ("ms_per_frame", "batch")})
            log(f"phase 12c: {time.perf_counter() - t0:.1f} s")
    finally:
        data_pipeline._imread_rgb = orig
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return summary, summary["12c_demos"]["serve_artifact_out"]["launches"]["bottleneck_chain"]


# ---------------------------------------------------------------------------
# phase 13: the decoder's new coverage, and DDP in place of the JAX mesh
# ---------------------------------------------------------------------------

DECODER_DIR = os.path.join(FIXTURE, "decoder")
# 13b: two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
# card), each on half of a global batch of 128, against one process (a child
# too) on the whole of it; the f32 steps start from a state F32_STEP_WARMUP
# one-process steps in, and all of them run with cuDNN off, so that each run
# and context computes the same thing: cuDNN's algorithms change with the
# batch size (64 against 128) and with the memory free, and moved the
# gradients by up to 6.6e-3 where one process repeats itself within 4.2e-5.  What DDP and the global BatchNorm compute is held, to
# DDP_GRAD_REL: the first step's gradients (over all tensors together) and
# BN buffers (per tensor, against their update).  Adam's
# parameters after the steps are reported: Adam turns a near-zero
# gradient's rounding into a full step (2.10e-2-3.14e-2 of their update
# with cuDNN on)
DDP_RANKS, DDP_RANK_BATCH, DDP_F32_STEPS, DDP_GRAD_REL = 2, 64, 2, 1e-3
DDP_BF16_WARMUP, DDP_BF16_TIMED = 3, 10
DDP_TRAIN_IMAGES, DDP_VAL_IMAGES = 64, 32
# the ranks' AP against one process's validate of the same checkpoint: bf16
# forwards of other batch compositions
DDP_AP_TOL = 5e-3
CHILD_TIMEOUT = 300
DDP_DEVICE = "cuda:0"
# predictions in one process and gathered over two ranks, canvas px and
# confidences: 13b's validate (bf16) and 13d's eval gt (f32, TF32 on in a
# fresh process); the same batch size per process, other images in each batch
DDP_PRED_TOL = 1e-2

DDP_CHILD = r"""
import builtins, json, os, sys, time
import numpy as np, torch
sys.path.insert(0, os.getcwd())
import chip_smoke as C
from simple_pose_torch.parallel import distributed as D
from simple_pose_torch.train.solver import PoseSolver, init_train_state, make_train_step

mode, rank, world, init, workdir = sys.argv[1], *map(int, sys.argv[2:4]), *sys.argv[4:6]
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
with open(os.path.join(workdir, "spec.json")) as f:
    spec = json.load(f)
dev, heat, crop = spec["device"], tuple(spec["heat"]), tuple(spec["crop"])
def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
written, real_open, real_save = [], builtins.open, torch.save
def recording_open(file, mode_="r", *a, **k):
    if isinstance(file, (str, os.PathLike)) and any(c in mode_ for c in "wax"):
        written.append(os.path.relpath(os.path.abspath(str(file)), workdir))
    return real_open(file, mode_, *a, **k)
def recording_save(obj, f, *a, **k):
    if isinstance(f, (str, os.PathLike)):
        written.append(os.path.relpath(os.path.abspath(str(f)), workdir))
    return real_save(obj, f, *a, **k)
builtins.open, torch.save = recording_open, recording_save
def f32_steps(batch, cudnn=False):
    # spec["f32_steps"] f32 steps from the carried state, with cuDNN off
    # (PyTorch's own conv and BatchNorm kernels, whose algorithm does not
    # change with the batch size) unless asked: the losses, the first step's
    # gradients (DDP's mean under a group), the trees after the first step
    # and after the last
    state = init_train_state(spec["f32_cfg"], device=dev)
    carried = torch.load(os.path.join(workdir, "state.pt"), map_location=dev)
    state.model.load_state_dict(carried["model"])
    state.optimizer.load_state_dict(carried["optimizer"])
    with torch.no_grad():
        for k, t in {**state.ema_params, **state.ema_buffers}.items():
            t.copy_(carried["ema"][k])
    state.step = carried["step"]
    step = make_train_step(heat, crop, amp=False, crop_impl="kernel")
    C.zero_launch_counts()
    rec = {"losses": []}
    torch.backends.cudnn.enabled = cudnn
    torch.backends.cudnn.deterministic = True
    for i in range(spec["f32_steps"]):
        state, m = step(state, batch)
        rec["losses"].append(m["loss"].item())
        if i == 0:
            rec["grads"] = {k: p.grad.detach().to("cpu", torch.float32, copy=True)
                            for k, p in state.model.named_parameters()}
            rec["trees_first"] = C._trees(state)
    torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = True, False
    rec["trees_last"], rec["launches"] = C._trees(state), C.launch_counts()
    del state, step
    sync()
    return rec
data = np.load(os.path.join(workdir, "batch.npz"))
out = {}
if mode == "one":  # the reference: one process on the global batch; the
    # same steps through cuDNN show how far its algorithms move the gradients
    whole = {k: torch.from_numpy(data[k]).to(dev) for k in data.files}
    real_save(f32_steps(whole), os.path.join(workdir, "f32_one.pt"))
    real_save(f32_steps(whole, cudnn=True), os.path.join(workdir, "f32_cudnn.pt"))
    real_save(out, os.path.join(workdir, f"{mode}_rank{rank}.pt"))
    sys.exit(0)
if mode == "ddp":
    info = D.init_multihost(init, world, rank, device=dev)
else:
    info = D.init_multihost(init, world, rank)
out["info"] = info
b = spec["rank_batch"]
batch = {k: torch.from_numpy(data[k][rank * b:(rank + 1) * b]).to(dev) for k in data.files}
if mode == "ddp":
    real_save(f32_steps(batch), os.path.join(workdir, f"f32_ddp{rank}.pt"))
    state = init_train_state(spec["bf16_cfg"], device=dev)
    step = make_train_step(heat, crop, amp=True, crop_impl="kernel")
    for _ in range(spec["bf16_warmup"]):
        state, m = step(state, batch)
    sync()
    D.barrier()
    t0 = time.perf_counter()
    for _ in range(spec["bf16_timed"]):
        state, m = step(state, batch)
    sync()
    D.barrier()
    seconds = time.perf_counter() - t0
    out["bf16"] = {"seconds": seconds, "loss": m["loss"].item(),
                   "global_crops_per_s": spec["bf16_timed"] * b * world / seconds}
    del state, step
    sync()
    with C.painter_installed():
        solver = PoseSolver(spec["solver_cfg"], device=dev)
        solver.init_state()
        C.zero_launch_counts()
        train = solver.train_epoch(0, log_every=0)
        out["solver_launches"] = C.launch_counts()
        out["solver_steps"] = solver.state.step
        stats = solver.validate(0, results_path=os.path.join(workdir, "val_results.json"))
        solver.save_checkpoint(0, stats["AP"])
    out["solver"] = {"train": train, "stats": stats}
else:  # nccl: one rank, the backend multi-GPU users run, DDP around the model
    state = init_train_state(spec["bf16_cfg"])
    state.ddp = torch.nn.parallel.DistributedDataParallel(state.model, device_ids=[0])
    step = make_train_step(heat, crop, amp=True, crop_impl="kernel")
    out["losses"] = []
    for _ in range(3):
        state, m = step(state, batch)
        out["losses"].append(m["loss"].item())
    out["backend"] = torch.distributed.get_backend()
    out["nccl_version"] = ".".join(map(str, torch.cuda.nccl.version()))
D.barrier()
D.shutdown()
out["written"] = sorted(set(written))
real_save(out, os.path.join(workdir, f"{mode}_rank{rank}.pt"))
"""


def check_decoder_fixture():
    """13a: the committed decoder-coverage files (cut baseline and
    progressive files, arithmetic coding, multi-scan sequential, warned
    progressions, sequential files without DHT segments, a damaged DHT)
    through the port's decoder against their CRC32s."""
    with open(os.path.join(DECODER_DIR, "decoded_crc32.json")) as f:
        want = json.load(f)
    rels = sorted(want)
    loader = native.NativeCanvasLoader(8)
    canvases, hs, ws = loader.load_batch([os.path.join(FIXTURE, r) for r in rels], CANVAS)
    bad = [r for r, c, h, w in zip(rels, canvases, hs, ws)
           if (h, w) != (want[r]["height"], want[r]["width"])
           or zlib.crc32(np.ascontiguousarray(c[:h, :w]).tobytes()) != want[r]["crc32"]]
    out = {"decoder": loader.decoder, "images": len(rels), "crc32_equal": len(rels) - len(bad),
           "kinds": sorted({os.path.basename(r).split("_")[0] for r in rels})}
    loader.close()
    log("phase 13a, decoder coverage: " + json.dumps(out))
    assert loader.decoder == "baseline", "13a holds the port's decoder; this machine has libjpeg"
    assert not bad, f"pixels differ from the committed CRC32s: {bad}"
    return out


def run_children(mode, world, workdir):
    """DDP_CHILD as ``world`` ranks of ``mode``, meeting through a file in
    ``workdir``; each rank's saved result."""
    init = file_rendezvous(workdir, f"rendezvous_{mode}")
    env = {**os.environ, "PYTHONPATH": os.getcwd()}
    procs = [subprocess.Popen([sys.executable, "-c", DDP_CHILD, mode, str(r), str(world), init,
                               workdir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{mode} rank {r} failed:\n{out[-4000:]}\n{err[-4000:]}"
    return [torch.load(os.path.join(workdir, f"{mode}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def tree_ratio(before, want, got):
    """The worst |got - want| / |want - before| over the tensors."""
    ratios = {}
    for k, w in want.items():
        update = (w - before[k]).norm().item()
        diff = (got[k] - w).norm().item()
        ratios[k] = diff / update if update > 0 else (0.0 if diff == 0 else float("inf"))
    worst = max(ratios, key=ratios.get)
    return ratios[worst], worst


def ddp_spec(workdir, rng):
    """The configs, the global batch and the state F32_STEP_WARMUP
    one-process steps in, written for the children; returns the spec and
    that state's trees."""
    f32_cfg = copy.deepcopy(TRAIN_CFG)
    f32_cfg["optim"]["amp"] = False
    f32_cfg["data"]["batch_size"] = DDP_RANK_BATCH
    bf16_cfg = copy.deepcopy(TRAIN_CFG)
    bf16_cfg["data"]["batch_size"] = DDP_RANK_BATCH
    glob = train_inputs(rng, DDP_RANKS * DDP_RANK_BATCH)
    np.savez(os.path.join(workdir, "batch.npz"), **glob)
    state = init_train_state(f32_cfg, device=DDP_DEVICE)
    step = make_train_step(HEAT_HW, CROP_HW, amp=False, crop_impl="kernel")
    torch.backends.cudnn.enabled = False  # the same warmed state in every run and context
    for _ in range(F32_STEP_WARMUP):
        warm = train_inputs(rng, DDP_RANKS * DDP_RANK_BATCH)
        state, _ = step(state, {k: torch.from_numpy(v).to(DDP_DEVICE) for k, v in warm.items()})
    torch.backends.cudnn.enabled = True
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "ema": {**state.ema_params, **state.ema_buffers}, "step": state.step},
               os.path.join(workdir, "state.pt"))
    before = _trees(state)
    del state, step

    solver_dir = os.path.join(workdir, "solver")
    os.makedirs(solver_dir)
    img_root = os.path.join(solver_dir, "images")  # never read: the painter stands in
    train_ann, val_ann = (os.path.join(solver_dir, n) for n in ("train.json", "val.json"))
    write_synth_coco(train_ann, DDP_TRAIN_IMAGES, 1, rng)
    write_synth_coco(val_ann, DDP_VAL_IMAGES, 100001, rng)
    solver = copy.deepcopy(bf16_cfg)
    solver["data"].update(train_ann_path=train_ann, val_ann_path=val_ann,
                          train_img_root=img_root, val_img_root=img_root, num_workers=8)
    solver["optim"]["epochs"] = 1
    solver["val"] = {"interval": 1, "weight_path": os.path.join(workdir, "weights")}
    solver["mesh"] = {"data": DDP_RANKS}
    spec = {"device": DDP_DEVICE, "heat": HEAT_HW, "crop": CROP_HW,
            "rank_batch": DDP_RANK_BATCH, "f32_cfg": f32_cfg, "bf16_cfg": bf16_cfg,
            "f32_steps": DDP_F32_STEPS, "bf16_warmup": DDP_BF16_WARMUP,
            "bf16_timed": DDP_BF16_TIMED, "solver_cfg": solver}
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec, f)
    return spec, before


def sorted_predictions(path):
    """A COCO results file as rows of keypoints, score and image id, sorted
    by (image id, keypoints)."""
    with open(path) as f:
        rows = sorted(json.load(f), key=lambda r: (r["image_id"], r["keypoints"]))
    return np.array([r["keypoints"] + [r["score"], r["image_id"]] for r in rows])


def prediction_diff(want, got):
    """The largest |got - want| over two sorted_predictions arrays; inf
    where their shapes or image ids differ."""
    if want.shape != got.shape or not np.array_equal(want[:, -1], got[:, -1]):
        return float("inf")
    return float(np.abs(want - got).max())


def rel_errors(want, got):
    """|got - want| / |want| over all tensors together; per tensor, the
    worst (a near-zero gradient, as a BatchNorm bias's before another
    BatchNorm, makes it large) and the median."""
    rel = {k: ((got[k] - w).norm() / w.norm().clamp_min(1e-30)).item() for k, w in want.items()}
    diff = sum(float((got[k] - w).norm()) ** 2 for k, w in want.items()) ** 0.5
    total = sum(float(w.norm()) ** 2 for w in want.values()) ** 0.5
    worst = max(rel, key=rel.get)
    return diff / total, rel[worst], worst, float(np.median(list(rel.values())))


def run_ddp_two_ranks(workdir, step_rate):
    """13b.  ``step_rate``: phase 6's one-process bf16 crops/s."""
    spec, before = ddp_spec(workdir, np.random.default_rng(13))
    t0 = time.perf_counter()
    run_children("one", 1, workdir)
    ranks = run_children("ddp", DDP_RANKS, workdir)
    ranks_s = time.perf_counter() - t0
    one = torch.load(os.path.join(workdir, "f32_one.pt"))
    spread = rel_errors(one["grads"], torch.load(os.path.join(workdir, "f32_cudnn.pt"))["grads"])[0]
    f32 = [torch.load(os.path.join(workdir, f"f32_ddp{r}.pt")) for r in range(DDP_RANKS)]
    unequal = [k for key in ("grads", "trees_last") for k in f32[0][key]
               if not torch.equal(f32[0][key][k], f32[1][key][k])]
    grad_rel, grad_worst, grad_worst_name, grad_median = rel_errors(one["grads"], f32[0]["grads"])
    buffers = [k for k in one["trees_first"]
               if k.endswith(("running_mean", "running_var")) and not k.startswith("ema.")]
    buf_ratio, buf_worst = tree_ratio({k: before[k] for k in buffers},
                                      {k: one["trees_first"][k] for k in buffers},
                                      f32[0]["trees_first"])
    adam_ratio, adam_worst = tree_ratio(before, one["trees_last"], f32[0]["trees_last"])
    loss_rel = max(abs(g / w - 1) for r in f32 for g, w in zip(r["losses"], one["losses"]))
    f32_steps = [len(r["losses"]) for r in f32]
    crop_launches = [r["launches"]["rotate_resample_crop"] for r in f32]
    solver_launches = [r["solver_launches"]["rotate_resample_crop"] for r in ranks]
    stats = [r["solver"]["stats"] for r in ranks]
    with painter_installed():
        solo = PoseSolver({**spec["solver_cfg"], "mesh": {"data": -1}}, device=DDP_DEVICE)
        solo.restore_checkpoint()
        one_stats = solo.validate(0, results_path=os.path.join(workdir, "one_results.json"))
    del solo
    # the seeded flagship scores AP 0 after one short epoch, so rank 0's
    # gathered predictions are held against one process's themselves
    gathered, solo_preds = (sorted_predictions(os.path.join(workdir, n))
                            for n in ("val_results.json", "one_results.json"))
    val_diff = prediction_diff(solo_preds, gathered)
    b = {
        "ranks": [r["info"] for r in ranks],
        "f32_loss_rel": loss_rel,
        "f32_grad_rel": grad_rel, "f32_grad_worst_tensor_rel": grad_worst,
        "f32_grad_worst_tensor": grad_worst_name, "f32_grad_median_tensor_rel": grad_median,
        "f32_grad_rel_cudnn_against_no_cudnn_one_process": spread,
        "f32_bn_buffer_ratio": buf_ratio, "f32_bn_buffer_worst": buf_worst,
        "f32_adam_param_ratio_after_steps": adam_ratio, "f32_adam_param_worst": adam_worst,
        "f32_rank_tensors_unequal": len(unequal),
        "crop_launches_per_rank": crop_launches, "f32_steps_per_rank": f32_steps,
        "bf16_global_crops_per_s_2_ranks_sharing_one_card":
            ranks[0]["bf16"]["global_crops_per_s"],
        "bf16_one_process_crops_per_s_phase6": step_rate,
        "solver_steps_per_rank": [r["solver_steps"] for r in ranks],
        "solver_crop_launches_per_rank": solver_launches,
        "solver_ap_per_rank": [s["AP"] for s in stats], "one_process_ap": one_stats["AP"],
        "val_predictions": [len(gathered), len(solo_preds)],
        "val_max_prediction_diff": val_diff,
        "written_rank0": ranks[0]["written"], "written_rank1": ranks[1]["written"],
        "children_s": ranks_s,
    }
    log("phase 13b, two ranks sharing one card (gloo): " + json.dumps(b))
    assert all(r["info"]["backend"] == "gloo" for r in ranks), b["ranks"]
    assert not unequal, unequal[:5]
    assert loss_rel <= F32_STEP_LOSS_REL, loss_rel
    assert grad_rel <= DDP_GRAD_REL and buf_ratio <= DDP_GRAD_REL, b
    assert f32_steps == [DDP_F32_STEPS] * DDP_RANKS and crop_launches == f32_steps, b
    assert solver_launches == b["solver_steps_per_rank"] and min(solver_launches) > 0
    assert stats[0] == stats[1]
    assert abs(stats[0]["AP"] - one_stats["AP"]) <= DDP_AP_TOL, (stats[0]["AP"], one_stats["AP"])
    assert len(solo_preds) > 0 and val_diff <= DDP_PRED_TOL, b
    assert "val_results.json" in ranks[0]["written"] and not ranks[1]["written"]
    assert any(w.startswith("weights") for w in ranks[0]["written"])
    return b


def run_nccl(workdir):
    """13c: one rank over NCCL with DDP around the model, 3 bf16 steps."""
    t0 = time.perf_counter()
    (nccl,) = run_children("nccl", 1, workdir)
    c = {"info": nccl["info"], "backend": nccl["backend"], "nccl_version": nccl["nccl_version"],
         "losses": nccl["losses"], "seconds": time.perf_counter() - t0}
    log("phase 13c, NCCL world size 1: " + json.dumps(c))
    assert c["backend"] == "nccl" and np.isfinite(c["losses"]).all()
    return c


def run_eval_multihost(workdir):
    """13d: ``eval gt`` on the fixture (seeded ResNet-50-DConv+SE, f32)
    in one process and through torchrun as two ranks on cuda:0 (gloo)."""
    weights = os.path.join(workdir, "pose.pth")
    torch.save(build_from_cfg(CFG, seed=0).state_dict(), weights)
    args = ["-m", "simple_pose_torch.eval", "gt", "--img-root", DET_IMAGES, "--ann", DET_GT,
            "--reduction", "--weights", weights, "--batch-size", "32", "--no-amp",
            "--decoder", "basic", "--device", DDP_DEVICE]
    env = {**os.environ, "PYTHONPATH": os.getcwd()}
    runs = {}
    for name, cmd in (("one", [sys.executable] + args),
                      ("two", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", "2"] + args + ["--multihost"])):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + ["--out", os.path.join(workdir, f"{name}.json")], env=env,
                              capture_output=True, text=True, timeout=CHILD_TIMEOUT)
        assert proc.returncode == 0, (
            f"eval gt ({name}):\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith('{"AP"')]
        assert len(lines) == 1, proc.stdout[-2000:]
        runs[name] = {"stats": lines[0], "seconds": time.perf_counter() - t0}
    diff = max(abs(runs["two"]["stats"][k] - runs["one"]["stats"][k]) for k in runs["one"]["stats"])
    # the seeded net scores AP 0 here, so the predictions themselves are compared
    preds = {name: sorted_predictions(os.path.join(workdir, f"{name}.json")) for name in runs}
    pred_diff = prediction_diff(preds["one"], preds["two"])
    d = {"one_process": runs["one"], "two_ranks": runs["two"], "max_stat_diff": diff,
         "predictions": [len(preds["one"]), len(preds["two"])], "max_prediction_diff": pred_diff}
    log("phase 13d, eval gt --multihost: " + json.dumps(d))
    assert diff <= DDP_AP_TOL and len(preds["one"]) > 0, d
    assert pred_diff <= DDP_PRED_TOL, d
    return d


def run_ddp_phase(card, step_rate):
    """Phase 13.  Returns the summary, the crop kernel's launches per rank
    in 13b's DDP steps and the steps each rank took."""
    t_phase = time.perf_counter()
    summary = {"card": card}
    t0 = time.perf_counter()
    summary["13a_decoder"] = check_decoder_fixture()
    log(f"phase 13a: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        summary["13b_ddp_two_ranks_one_card"] = run_ddp_two_ranks(workdir, step_rate)
        torch.cuda.empty_cache()
        summary["13c_nccl"] = run_nccl(workdir)
        report_numbers(card, "phase 13b, bf16 global crops/s, 2 ranks sharing one card, "
                       f"{DDP_RANK_BATCH} per rank (not a multi-GPU rate)", {
                           "crops_per_s": summary["13b_ddp_two_ranks_one_card"][
                               "bf16_global_crops_per_s_2_ranks_sharing_one_card"],
                           "one_process_batch128": step_rate})
        log(f"phase 13b-c: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        summary["13d_eval_multihost"] = run_eval_multihost(workdir)
        log(f"phase 13d: {time.perf_counter() - t0:.1f} s")
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    b = summary["13b_ddp_two_ranks_one_card"]
    return summary, b["crop_launches_per_rank"], b["f32_steps_per_rank"]


# ---------------------------------------------------------------------------
# phase 14: K2 at the wide ResNets' layer1 and on maps wider than 96 columns
# ---------------------------------------------------------------------------

WIDE_CFG = {"type": "pose_resnet_dconv", "name": "wide_resnet50_2", "num_joints": 17,
            "reduction": True}
# ResNet-50+SE's layer1 on 2-D tiles: layer1 at 64 x W, an input of 4W
# columns (no config has one; the JAX kernel takes any)
WIDE_MAP_WIDTHS, WIDE_MAP_BATCH = (97, 128), 8


def run_wide_entry_points(workdir):
    """14d-e: ``eval gt --fused-layer1 --flip-test`` with wide_resnet50_2 on
    the fixture (K2 twice per pipeline batch), then ``eval export
    --fused-layer1`` of it served by serve_artifact (K2 once)."""
    from simple_pose_torch import eval as teval
    from simple_pose_torch import serve_artifact

    res = {}
    out = os.path.join(workdir, "wide_gt.json")
    with open(DET_GT) as f:
        people = len(json.load(f)["annotations"])
    batches = []  # the evaluator's calls: one per pipeline batch
    evaluate = PoseEvaluator.__call__
    PoseEvaluator.__call__ = lambda ev, batch: batches.append(1) or evaluate(ev, batch)
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            teval.main(["gt", "--img-root", DET_IMAGES, "--ann", DET_GT, "--model-name",
                        "wide_resnet50_2", "--reduction", "--fused-layer1", "--flip-test",
                        "--batch-size", str(BATCH), "--input-w", str(INPUT_SHAPE[0]),
                        "--input-h", str(INPUT_SHAPE[1]), "--out", out])
    finally:
        PoseEvaluator.__call__ = evaluate
    launches = launch_counts()
    stats = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith('{"AP"')][-1]
    with open(out) as f:
        preds = json.load(f)
    res["eval_gt"] = {"launches": launches, "batches": len(batches), "predictions": len(preds),
                      "seconds": time.perf_counter() - t0, "AP": stats["AP"]}
    assert launches == {"bottleneck_chain": 2 * len(batches), "rotate_resample": 0,
                        "rotate_resample_crop": 0, "int8_conv": 0}, res["eval_gt"]
    assert len(preds) == people and 0.0 <= stats["AP"] <= 1.0, res["eval_gt"]
    assert np.isfinite([p["keypoints"] for p in preds]).all()

    artifact = os.path.join(workdir, "wide_l1.pt2")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        teval.main(["export", "--model-name", "wide_resnet50_2", "--reduction",
                    "--fused-layer1", "--batch-size", "2", "--canvas", str(CANVAS),
                    "--input-w", str(INPUT_SHAPE[0]), "--input-h", str(INPUT_SHAPE[1]),
                    "--out", artifact])
    export_s = time.perf_counter() - t0
    box = tuple(float(v) for v in DEMO_BOX.split(","))
    zero_launch_counts()
    served = serve_artifact.serve(artifact, DECODE_SCENE["baseline"], [box])
    torch.cuda.synchronize()
    launches = launch_counts()
    kps = [p["keypoints"] for p in served["people"]]
    res["serve_artifact"] = {"launches": launches, "export_s": export_s,
                             "bytes": os.path.getsize(artifact), "people": len(kps)}
    assert launches["bottleneck_chain"] == 1 and len(kps) == 1, res["serve_artifact"]
    assert np.isfinite(kps).all()
    return res


def run_wide_layer1(card):
    """Phase 14.  Returns {row name: K2's errors, timing, main-path launches,
    main path and other launch counts} for the kernels' JSON line, and the
    summary."""
    t_phase = time.perf_counter()
    rows, summary = {}, {"card": card}
    t0 = time.perf_counter()
    report, timing = check_chain_kernel(seeded_layer1(build_resnet("wide_resnet50_2", se=True)),
                                        "phase 14a, wide_resnet50_2 layer1 chain")
    for key, row in timing.items():
        report_numbers(card, f"phase 14a, wide_resnet50_2 layer1 chain {key}",
                       {k: row[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")})
    log(f"phase 14a: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    r50 = seeded_layer1(build_resnet("resnet50", se=True))
    for w in WIDE_MAP_WIDTHS:
        r_report, r_timing = check_chain_kernel(
            r50, f"phase 14b, resnet50 layer1 chain at 64x{w}", batches=(WIDE_MAP_BATCH,),
            chw=(64, 64, w), check_batch=WIDE_MAP_BATCH)
        rows[f"resnet50 layer1 at 64x{w}"] = {
            "report": r_report, "timing": r_timing, "launches": 0, "extra": {},
            "main_path": f"none: no config's input is {4 * w} columns wide (the JAX kernel "
                         "takes it)"}
    del r50
    log(f"phase 14b: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        launches, stats, rates = run_main_path(workdir, WIDE_CFG, "phase 14c, wide_resnet50_2")
        report_numbers(card, "phase 14c, wide_resnet50_2 serving crops/s at batch "
                       f"{THROUGHPUT_BATCH} (bf16, fused_layer1, flip-test)", rates)
        summary["14c_serving"] = {"launches": launches, "AP": stats["AP"], "crops_per_s": rates}
        torch.cuda.empty_cache()
        log(f"phase 14c: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        summary.update(run_wide_entry_points(workdir))
        log("phase 14d-e: " + json.dumps(summary) + f" ({time.perf_counter() - t0:.1f} s)")
    rows["wide_resnet50_2 layer1"] = {
        "report": report, "timing": timing, "launches": launches["bottleneck_chain"],
        "main_path": "phase 14c: PoseEvaluator(wide_resnet50_2, fused_layer1, flip-test)",
        "extra": {"launches_eval_gt": summary["eval_gt"]["launches"]["bottleneck_chain"],
                  "launches_f32_serving": launches["bottleneck_chain_f32_serving"],
                  "launches_loaded_artifact":
                      summary["serve_artifact"]["launches"]["bottleneck_chain"],
                  "width_128_kernels": {
                      "bf16": "hopper::bottleneck_block_wgmma_kernel<128, __nv_bfloat16> (TMA "
                              "ring of 3 x 32 KB weight chunks, wgmma m64n128k16)",
                      "f32": "hopper::bottleneck_block_wgmma_kernel<128, float> (3xTF32: TMA "
                             "ring of 3 x 32 KB hi/lo weight chunks, 3 x wgmma m64n128k8 .tf32 "
                             "per k8 step, 2 consumer warpgroups)"},
                  "bf16_tile": tile_info(128, True), "f32_tile": tile_info(128, False)}}
    torch.cuda.empty_cache()
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return rows, summary


# how an SE block runs on the card (the kernels' line names it)
SE_ROUTE = ("sums pass (the block kernel with kSums: m2's per-tile channel sums) -> "
            "se_gate_kernel (their mean through w3 and b3, the fcs, the sigmoid) -> full pass "
            "(relu(o * g + identity) in its epilogue); no se_apply pass")


# ---------------------------------------------------------------------------
# phase 15: the discriminative held-out AP gate's path
# ---------------------------------------------------------------------------

# scripts/drive_torch_discrim_ap.py at its width (ResNet-18-DConv, 128x128
# crops, batch 32, canvas 224, bf16) on its color corpus cut to 64 train and
# 16 val images, 2 epochs; HRNet-W32 1 epoch for the fused layer1
DISCRIM_ARGS = ["--train-images", "64", "--val-images", "16", "--epochs", "2",
                "--val-every", "2"]
DISCRIM_HRNET_ARGS = ["--model", "pose_hrnet:w32", "--epochs", "1", "--val-every", "1"]


@contextlib.contextmanager
def cv2_blocked():
    """Every ``import cv2`` raises inside: _imread_rgb's cv2 branch fails."""
    had, saved = "cv2" in sys.modules, sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if had:
            sys.modules["cv2"] = saved
        else:
            del sys.modules["cv2"]


def train_discrim(gate, args, corpus):
    """PoseSolver.run on the gate's configuration, the launch counters zeroed
    just before and read just after.  Returns (checkpoint, launches, steps,
    seconds)."""
    solver = PoseSolver(gate.train_config(args, corpus, amp=True), device=args.device)
    cwd = os.getcwd()
    os.chdir(args.dir)  # validate writes its results JSON to the working directory
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        solver.run()
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    launches = launch_counts()
    return solver.checkpoint_path(), launches, solver.state.step, time.perf_counter() - t0


def discrim_variants(gate, args, ckpt, va_root, va_ann):
    """Float and the gate's variants once on val through the gate's own
    evaluation, every kernel's launches counted per run.  Returns {name:
    {"AP", "launches"}}."""
    # ResNet-18's trunk has no Bottleneck layer1; HRNet runs the fused one only
    runs = [("float", {})] + [(n, x) for n, x in gate.VARIANTS
                              if (n == "fused_layer1") == (args.mtype == "pose_hrnet")]
    res = gate.evaluate(args, ckpt, va_root, va_ann, runs)
    for name, r in res.items():
        lc = r["launches"]
        assert 0.0 <= r["AP"] <= 1.0, (name, r)
        assert lc["rotate_resample"] == lc["rotate_resample_crop"] == 0, (name, lc)
        assert (lc["int8_conv"] > 0) == name.startswith("w8a8"), (name, lc)
        assert (lc["bottleneck_chain"] > 0) == (name == "fused_layer1"), (name, lc)
    return res


def first_val_batch(args, va_root, va_ann, canvas):
    """The first batch of the gate's val records at its crop size."""
    shape = (args.input, args.input)
    pipe = data_pipeline.PosePipeline(load_coco_keypoints(va_root, va_ann), args.batch_size,
                                      input_shape=shape, output_shape=(shape[0] // 4,
                                                                       shape[1] // 4),
                                      canvas=canvas, augment=False, shuffle=False,
                                      drop_last=False)
    return next(iter(pipe.epoch(0)))


def fused_heatmaps(gate, ckpt, args, va_root, va_ann, canvas=224):
    """K2 on a trained layer1 (``gate.model_cfg(args)``): heatmaps of one val
    batch with fused_layer1 against the unfused forward (bf16), K2's
    launches counted."""
    model_cfg = gate.model_cfg(args)
    shape = (args.input, args.input)
    batch = first_val_batch(args, va_root, va_ann, canvas)
    fused = PoseEvaluator(model_cfg, ckpt, shape, fused_layer1=True, device=args.device)
    unfused = PoseEvaluator(model_cfg, ckpt, shape, device=args.device)
    zero_launch_counts()
    hf = fused.heatmaps(batch)
    torch.cuda.synchronize()
    launches = launch_counts()["bottleneck_chain"]
    hu = unfused.heatmaps(batch)
    assert hf.shape == hu.shape and torch.isfinite(hf).all(), hf.shape
    _, max_rel, mean_rel = errors(hf, hu)
    res = {"k2_launches": launches, "max_rel": max_rel, "mean_rel": mean_rel,
           "max_abs_unfused": hu.float().abs().max().item(), "tol": list(FUSED_HEAT_TOL)}
    assert launches == 1, res
    assert max_rel < FUSED_HEAT_TOL[0] and mean_rel < FUSED_HEAT_TOL[1], res
    return res


def layer1_vs_f32(chain, ckpt, args, va_root, va_ann):
    """16d: layer1 of a trained ResNet on one val batch, its input taken
    from the unfused bf16 forward, through K2 (bf16), cuDNN (bf16 autocast)
    and the plain chain, each against the f32 layer1 without TF32 on the
    same input (max and mean relative to max|f32|).  K2 must lie within
    TOL["bf16"] of f32.  Its launch here compares and is not counted."""
    batch = first_val_batch(args, va_root, va_ann, chain.CANVAS)
    evs = chain.evaluators(args, ckpt)
    with torch.no_grad(), chain.layer1_taps(evs["unfused"].model) as taps:
        evs["unfused"].heatmaps(batch)
        ys = chain.layer1_outputs(evs, taps["x"][0])
    torch.cuda.synchronize()
    res = {name: dict(zip(("max_rel", "mean_rel"), errors(ys[name], ys["f32"])[1:]))
           for name in ("k2", "cudnn", "plain")}
    res.update(shape=list(taps["x"][0].shape), dtype=str(taps["x"][0].dtype),
               tol=list(TOL["bf16"]),
               k2_mean_at_or_below_cudnn=res["k2"]["mean_rel"] <= res["cudnn"]["mean_rel"])
    assert res["k2"]["max_rel"] < TOL["bf16"][0] and res["k2"]["mean_rel"] < TOL["bf16"][1], res
    return res


def discrim_two_ranks(gate, args, ckpt, va_root, va_ann):
    """The gate's ``eval gt`` on val in one process and as two ranks sharing
    one card (``--mesh-devices 2``, gloo), bf16, gauss_taylor: the
    predictions instance for instance."""
    runs = {}
    for name, ranks in (("one", 1), ("two", 2)):
        out = os.path.join(args.dir, f"two_ranks_{name}.json")
        t0 = time.perf_counter()
        ap = gate.eval_gt(args, ckpt, va_root, va_ann, out, mesh_devices=ranks)
        runs[name] = {"AP": ap, "seconds": time.perf_counter() - t0,
                      "predictions": sorted_predictions(out)}
    pred_diff = prediction_diff(runs["one"]["predictions"], runs["two"]["predictions"])
    res = {name: {k: v for k, v in r.items() if k != "predictions"} for name, r in runs.items()}
    res.update(instances=[len(r["predictions"]) for r in runs.values()],
               max_prediction_diff=pred_diff)
    assert res["instances"][0] == res["instances"][1] > 0, res
    assert pred_diff <= DDP_PRED_TOL and abs(runs["one"]["AP"] - runs["two"]["AP"]) <= DDP_AP_TOL, res
    return res


def run_discrim_phase(card):
    """Phase 15.  Returns the summary and the launch counts for the kernels'
    line."""
    t_phase = time.perf_counter()
    gate = load_script("drive_torch_discrim_ap")
    summary = {"card": card}
    with tempfile.TemporaryDirectory() as workdir, cv2_blocked():
        args = gate.parse_args(DISCRIM_ARGS + ["--dir", os.path.join(workdir, "r18")])
        t0 = time.perf_counter()
        corpus = gate.paint_corpora(args)
        tr_root, _, va_root, va_ann = corpus
        summary["15a_paint_s"] = time.perf_counter() - t0
        assert all(f.endswith(".png") for f in os.listdir(tr_root)), os.listdir(tr_root)[:4]

        ckpt, launches, steps, seconds = train_discrim(gate, args, corpus)
        summary["15b_train"] = {"launches": launches, "steps": steps, "seconds": seconds}
        log("phase 15b, ResNet-18-DConv through PoseSolver on the painted PNGs: "
            + json.dumps(summary["15b_train"]))
        assert launches["rotate_resample_crop"] == steps > 0, summary["15b_train"]
        assert launches["rotate_resample"] == launches["bottleneck_chain"] == 0, launches

        t0 = time.perf_counter()
        variants = discrim_variants(gate, args, ckpt, va_root, va_ann)
        summary["15c_variants"] = variants
        summary["15c_seconds"] = time.perf_counter() - t0
        log("phase 15c, the gate's variants once on val: " + json.dumps(variants))

        t0 = time.perf_counter()
        summary["15d_two_ranks"] = discrim_two_ranks(gate, args, ckpt, va_root, va_ann)
        summary["15d_seconds"] = time.perf_counter() - t0
        log("phase 15d, eval gt one process vs two ranks on one card: "
            + json.dumps(summary["15d_two_ranks"]))

        t0 = time.perf_counter()
        hargs = gate.parse_args(DISCRIM_ARGS + DISCRIM_HRNET_ARGS
                                + ["--dir", os.path.join(workdir, "hrnet")])
        hcorpus = gate.paint_corpora(hargs)
        hckpt, hlaunches, hsteps, _ = train_discrim(gate, hargs, hcorpus)
        assert hlaunches["rotate_resample_crop"] == hsteps > 0, hlaunches
        hvariants = discrim_variants(gate, hargs, hckpt, hcorpus[2], hcorpus[3])
        heat = fused_heatmaps(gate, hckpt, hargs, hcorpus[2], hcorpus[3])
        summary["15e_hrnet_fused_layer1"] = {"train_launches": hlaunches, "steps": hsteps,
                                             "variants": hvariants, "heatmaps": heat,
                                             "seconds": time.perf_counter() - t0}
        log("phase 15e, K2 on HRNet-W32's trained layer1: "
            + json.dumps(summary["15e_hrnet_fused_layer1"]))
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15: {summary['seconds']:.1f} s")
    counts = {"crop_launches": launches["rotate_resample_crop"] + hlaunches["rotate_resample_crop"],
              "steps": steps + hsteps,
              "k2_fused_layer1": hvariants["fused_layer1"]["launches"]["bottleneck_chain"]
              + heat["k2_launches"]}
    return summary, counts


# scripts/drive_torch_discrim_detchain.py at its width (ResNet-18-DConv,
# 128x128 crops, batch 32, canvas 288, bf16) on its crowded corpus cut to 32
# train and 8 val images, 2 epochs; ResNet-50-DConv+SE 1 epoch for K2's SE
# route on trained weights
DETCHAIN_ARGS = ["--train-images", "32", "--val-images", "8", "--epochs", "2",
                 "--val-every", "2"]
DETCHAIN_R50_ARGS = ["--model", "pose_resnet_dconv:resnet50", "--se", "--epochs", "1",
                     "--val-every", "1"]


@contextlib.contextmanager
def pose_batches_counted():
    """Yields a record whose ``"batches"`` grows by one a
    ``PoseEvaluator.__call__``: a pose batch of predicts_by_detections."""
    record = {"batches": 0}
    call = PoseEvaluator.__call__

    def counted(self, batch):
        record["batches"] += 1
        return call(self, batch)

    PoseEvaluator.__call__ = counted
    try:
        yield record
    finally:
        PoseEvaluator.__call__ = call


def detchain_pass(chain, args, ckpt, va_root, va_ann, det_json, n_dets, fused=False):
    """One predicts_by_detections pass at the gate's settings and the AP
    ladder on its raw predictions (in ``<dir>/<name>/``), with the phase's
    checks.  Returns the ladder, the kept counts, the launches, the pose
    batches and the seconds."""
    name = "fused_layer1" if fused else "unfused"
    t0 = time.perf_counter()
    with pose_batches_counted() as record:
        stats, launches, raw = chain.run_chain(args, ckpt, va_root, det_json, va_ann, name,
                                               fused_layer1=fused)
    out_dir = os.path.join(args.dir, name)
    os.makedirs(out_dir, exist_ok=True)
    aps = chain.ap_ladder(raw, va_ann, out_dir)

    def count(path):
        with open(path) as f:
            return len(json.load(f))

    kept = {"raw": count(raw), **{rung: count(os.path.join(out_dir, f"ladder_{rung}.json"))
                                  for rung in ("rescore_only", "full_chain")}}
    res = {"ap": aps, "kept": kept, "launches": launches, "pose_batches": record["batches"],
           "seconds": time.perf_counter() - t0}
    assert all(0.0 <= v <= 1.0 for v in aps.values()), res
    assert aps["full_chain"] == stats["AP"], (stats, res)
    assert kept["raw"] == n_dets and kept["rescore_only"] == kept["raw"], res
    assert 0 < kept["full_chain"] <= kept["rescore_only"], res
    assert launches["rotate_resample"] == launches["rotate_resample_crop"] == 0, res
    assert record["batches"] > 0, res
    assert launches["bottleneck_chain"] == (record["batches"] if fused else 0), res
    return res


def run_detchain_phase(card):
    """Phase 16.  Returns the summary and the launch counts for the kernels'
    line."""
    t_phase = time.perf_counter()
    chain = load_script("drive_torch_discrim_detchain")
    summary = {"card": card}
    with tempfile.TemporaryDirectory() as workdir, cv2_blocked():
        args = chain.parse_args(DETCHAIN_ARGS + ["--dir", os.path.join(workdir, "r18")])
        t0 = time.perf_counter()
        *corpus, va_gt = chain.paint_corpora(args)
        tr_root, _, va_root, va_ann = corpus
        summary["16a_paint_s"] = time.perf_counter() - t0
        assert all(f.endswith(".png") for f in os.listdir(tr_root)), os.listdir(tr_root)[:4]
        people = np.bincount([a["image_id"] for a in va_gt["annotations"]])[1:]
        assert people.min() >= 3 and people.max() <= 4, people

        ckpt, launches, steps, seconds = train_discrim(chain, args, corpus)
        summary["16b_train"] = {"launches": launches, "steps": steps, "seconds": seconds}
        log("phase 16b, ResNet-18-DConv through PoseSolver on the crowded PNGs: "
            + json.dumps(summary["16b_train"]))
        assert launches["rotate_resample_crop"] == steps > 0, summary["16b_train"]
        assert launches["rotate_resample"] == launches["bottleneck_chain"] == 0, launches

        det_json, det_stats = chain.write_detections(args, va_gt)
        assert det_stats["true"] == len(va_gt["annotations"]), det_stats
        summary["16c_detections"] = det_stats
        summary["16c_chain"] = detchain_pass(chain, args, ckpt, va_root, va_ann, det_json,
                                             det_stats["total"])
        log("phase 16c, predicts_by_detections and the AP ladder: "
            + json.dumps(summary["16c_chain"]))

        t0 = time.perf_counter()
        rargs = chain.parse_args(DETCHAIN_ARGS + DETCHAIN_R50_ARGS
                                 + ["--dir", os.path.join(workdir, "r50se")])
        os.makedirs(rargs.dir)
        rckpt, rlaunches, rsteps, _ = train_discrim(chain, rargs, corpus)
        assert rlaunches["rotate_resample_crop"] == rsteps > 0, rlaunches
        assert rlaunches["rotate_resample"] == rlaunches["bottleneck_chain"] == 0, rlaunches
        heat = fused_heatmaps(chain, rckpt, rargs, va_root, va_ann, canvas=chain.CANVAS)
        layer1 = layer1_vs_f32(chain, rckpt, rargs, va_root, va_ann)
        passes = {fused: detchain_pass(chain, rargs, rckpt, va_root, va_ann, det_json,
                                       det_stats["total"], fused=fused)
                  for fused in (False, True)}
        summary["16d_r50_se"] = {"train_launches": rlaunches, "steps": rsteps,
                                 "heatmaps": heat, "layer1_vs_f32": layer1,
                                 "unfused": passes[False],
                                 "fused_layer1": passes[True],
                                 "full_chain_delta": passes[True]["ap"]["full_chain"]
                                 - passes[False]["ap"]["full_chain"],
                                 "seconds": time.perf_counter() - t0}
        log("phase 16d, K2's SE route on ResNet-50-DConv+SE's trained layer1, the chain "
            "unfused and fused: " + json.dumps(summary["16d_r50_se"]))
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16: {summary['seconds']:.1f} s")
    counts = {"crop_launches": launches["rotate_resample_crop"]
              + rlaunches["rotate_resample_crop"],
              "steps": steps + rsteps,
              "k2_fused_layer1": passes[True]["launches"]["bottleneck_chain"]
              + heat["k2_launches"]}
    return summary, counts


def tile_info(width, bf16, h=64, w=48):
    """The tile, shared memory and blocks of threads per SM of K2's launch
    at Bottleneck width ``width`` on an h x w map (the library's
    occupancy)."""
    plan = launch_plan(h, w, width, bf16)
    return {"th": plan.th, "tw": plan.tw, "smem_bytes": plan.smem_bytes,
            "blocks_per_sm": _lib().bottleneck_blocks_per_sm(plan.th, plan.tw, width, int(bf16),
                                                             int(plan.tw == w))}


def k2_row(name, launches, report, timing, splits):
    """A K2 row of the kernels' JSON line, its times at the smallest batch
    timed, with its chain's splits (k2_splits)."""
    batch = min(int(k[1:].split("_")[0]) for k in timing)
    row = timing[f"b{batch}_bf16"]
    return {
        "name": name,
        "route": "cuda",
        "source": "simple_pose_torch/csrc/bottleneck_chain.cu",
        "replaces": "simple_pose_tpu/ops/pallas_bottleneck.py:88",
        "launches": launches,
        "max_abs_err": report["bf16"]["max_abs_err"],
        "ms": row["kernel_ms"],
        "kernel_ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "errors": report,
        "f32": {k: timing[f"b{batch}_f32"][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_cuda_core_ms", "library_ms")},
        "se_route": SE_ROUTE if any(v["sums"]["launches"] for v in splits.values())
        else "no SE block",
        "split_per_call": splits,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, together
        builds = dict(zip(KERNELS, pool.map(build_library, KERNELS)))
    log("build: " + ", ".join(f"{k} nvcc {v[1]:.1f} s" for k, v in builds.items())
        + f" (phase {time.perf_counter() - t0:.1f} s)")
    log("K2's SE route in its library: " + json.dumps(check_route_kernels(builds[KERNELS[0]][0])))

    report, timing = check_chain_kernel(seeded_layer1(build_resnet("resnet50", se=True)))
    t0 = time.perf_counter()
    splits = run_k2_splits()
    log("phase 3b, K2's per-call split of every chain (block kernels' full passes, SE sums "
        f"passes, se_gate; no other kernel) on {card}: " + json.dumps(splits)
        + f" ({time.perf_counter() - t0:.1f} s)")
    with tempfile.TemporaryDirectory() as workdir:
        launches, stats, rates = run_main_path(workdir)
    log(f"serving crops/s at batch {THROUGHPUT_BATCH} (bf16, fused_layer1, flip-test) "
        f"on {card}: " + json.dumps(rates))
    log("layer1 timing: " + json.dumps({"card": card, **timing}))

    data = train_inputs(np.random.default_rng(5), TRAIN_BATCH)
    rot_report, rot_timing, data_dev = check_rotate_kernel(data)
    log("rotate_resample timing: " + json.dumps({"card": card, **rot_timing}))
    crop_report, crop_timing = check_crop_kernel(data_dev["canvas"], data_dev["trans"])
    log("whole-crop kernel timing: " + json.dumps({"card": card, **crop_timing}))
    train_launches, train = run_train_path(data_dev, data)
    log(f"train crops/s at batch {TRAIN_BATCH} (ResNet-50-DConv+SE 256x192, bf16, Adam, EMA) "
        f"on {card}: {train['crops_per_s']:.2f} ({train['ms_per_step']:.2f} ms/step); "
        f"torch.cuda.max_memory_allocated {train['max_memory_allocated_gib']:.2f} GiB")
    f32_step = check_f32_step(data)
    log("train path: " + json.dumps({"card": card, **train, "f32_step": f32_step}))

    with tempfile.TemporaryDirectory() as workdir, painter_installed():
        cwd = os.getcwd()
        os.chdir(workdir)  # validate writes its results JSON to the working directory
        try:
            solver_launches, solver = run_solver_path(workdir, card, train["crops_per_s"])
        finally:
            os.chdir(cwd)
    remat = check_remat({**data_dev, "joints": torch.from_numpy(data["joints"]).cuda()})
    log("remat: " + json.dumps({"card": card, **remat}))
    jpeg = run_jpeg_path(card, solver["host_only_batches_per_s"])
    log("phase 8: " + json.dumps(jpeg))
    families = run_other_families(card, data, data_dev)
    detector, e2e_launches = run_detector_path(card)
    log("phase 10: " + json.dumps(detector))
    quantized_run, quant_launches, artifact_launches = run_quant_path(card, {
        "gen_dets": detector["10c_gen_dets"]["images_per_s"]["median"],
        "fused": detector["10e_fused_yolov5"]["images_per_s"]["median"]})
    log("phase 11: " + json.dumps(quantized_run))
    apps, serve_launches = run_port_apps(card)
    log("phase 12: " + json.dumps(apps))
    ddp, ddp_launches, ddp_steps = run_ddp_phase(card, train["crops_per_s"])
    log("phase 13: " + json.dumps(ddp))
    wide_rows, wide = run_wide_layer1(card)
    log("phase 14: " + json.dumps(wide))
    discrim, discrim_counts = run_discrim_phase(card)
    log("phase 15: " + json.dumps(discrim))
    detchain, detchain_counts = run_detchain_phase(card)
    log("phase 16: " + json.dumps(detchain))

    kernels = [{**k2_row("bottleneck_chain", launches["bottleneck_chain"], report, timing,
                         splits["resnet50"]),
                "width_64_kernels": {
                    "bf16": "hopper::bottleneck_block_wgmma_kernel<64, __nv_bfloat16> (TMA ring "
                            "of 4 x 8 KB weight chunks, wgmma m64n64k16)",
                    "f32": "hopper::bottleneck_block_wgmma_kernel<64, float> (3xTF32: TMA ring "
                           "of 4 x 16 KB hi/lo weight chunks, 3 x wgmma m64n64k8 .tf32 per k8 "
                           "step)"},
                "bf16_tile": tile_info(64, True), "f32_tile": tile_info(64, False),
                "launches_f32_serving": launches["bottleneck_chain_f32_serving"],
                "launches_detections": jpeg["launches"]["bottleneck_chain"],
                "launches_e2e": e2e_launches,
                "launches_w8a8_serving": quant_launches,
                "launches_loaded_artifact": artifact_launches,
                "launches_serve_artifact_out": serve_launches,
                "launches_detchain_fused_layer1": detchain_counts["k2_fused_layer1"]}]
    for fam, (fam_report, fam_timing, fam_launches, fam_f32) in families.items():
        kernels.append({**k2_row(f"bottleneck_chain ({fam} layer1)", fam_launches, fam_report,
                                 fam_timing, splits[fam]),
                        "main_path": f"phase 9b: PoseEvaluator({fam}, fused_layer1, flip-test)",
                        "launches_f32_serving": fam_f32, "timing": fam_timing})
        if fam == "hrnet_w32":
            kernels[-1]["launches_discrim_fused_layer1"] = discrim_counts["k2_fused_layer1"]
    for name, r in wide_rows.items():
        kernels.append({**k2_row(f"bottleneck_chain ({name})", r["launches"], r["report"],
                                 r["timing"], splits[name.replace(" layer1", "")]),
                        "main_path": r["main_path"], "timing": r["timing"], **r["extra"]})
    rot_row = rot_timing[f"b{TRAIN_BATCH}_bf16"]
    kernels.append({
        "name": "rotate_resample",
        "route": "cuda",
        "source": "simple_pose_torch/csrc/rotate_resample.cu",
        "replaces": "simple_pose_tpu/ops/pallas_warp.py:45",
        "launches": train_launches["rotate_resample"],
        "max_abs_err": max(rot_report["f32"]["max_abs_err"], rot_report["bf16"]["max_abs_err"]),
        "ms": rot_row["kernel_ms"],
        "kernel_ms": rot_row["kernel_ms"],
        "plain_ms": rot_row["plain_ms"],
        "bound_ms": rot_row["bound_ms"],
        "bound_by": rot_row["bound_by"],
        "library_ms": rot_row["library_ms"],
        "errors": rot_report,
        "main_path": "none: the training step runs rotate_resample_crop",
    })
    crop_row = crop_timing[f"b{TRAIN_BATCH}_bf16"]
    kernels.append({
        "name": "rotate_resample_crop",
        "route": "cuda",
        "source": "simple_pose_torch/csrc/rotate_resample.cu",
        "replaces": "simple_pose_tpu/ops/pallas_warp.py:45",
        "replaces_path": "simple_pose_tpu/ops/pallas_warp.py:170 (affine_crop_pallas)",
        "launches": train_launches["rotate_resample_crop"],
        "launches_solver": solver_launches["rotate_resample_crop"],
        "launches_ddp_per_rank": ddp_launches,
        "ddp_steps_per_rank": ddp_steps,
        "launches_discrim_gate": discrim_counts["crop_launches"],
        "discrim_gate_steps": discrim_counts["steps"],
        "launches_detchain": detchain_counts["crop_launches"],
        "detchain_steps": detchain_counts["steps"],
        "max_abs_err": max(crop_report["f32"]["max_abs_err"], crop_report["bf16"]["max_abs_err"]),
        "ms": crop_row["kernel_ms"],
        "kernel_ms": crop_row["kernel_ms"],
        "wrapper_ms": crop_row["wrapper_ms"],
        "plain_ms": crop_row["plain_ms"],
        "two_stage_ms": crop_row["two_stage_ms"],
        "bound_ms": crop_row["bound_ms"],
        "bound_by": crop_row["bound_by"],
        "library_ms": crop_row["library_ms"],
        "errors": crop_report,
    })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
