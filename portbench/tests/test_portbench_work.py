"""The operation and byte counters against figures worked out by hand and
against the bounds PERF.md's table of kernels gives (PR 17's K2 rows, PR
5's crop row)."""

import math

import numpy as np
import pytest
import torch

from portbench.gen import box_to_center_scale, get_affine_transform
from portbench.work.counts import chain_least_s, chain_work, crop_work, forward_flops, peaks

FLAGSHIP = {"type": "pose_resnet_dconv", "name": "resnet50", "num_joints": 17, "reduction": True}
HRNET = {"type": "pose_hrnet", "name": "w32", "num_joints": 17}


def test_chain_bounds_are_the_kernel_tables():
    # flagship layer1 at b128: 3 blocks on 64x48, SE and projection in block 0
    per_pixel = (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256) + 2 * (256 * 64 + 9 * 64 * 64
                                                                      + 64 * 256)
    flops = 2 * 128 * (64 * 48 * per_pixel + 2 * 256 * 256)
    assert chain_work(FLAGSHIP, (256, 192), 128)[0] == flops
    assert chain_least_s(FLAGSHIP, (256, 192), 128) * 1e3 == pytest.approx(0.16940, abs=5e-6)
    assert chain_least_s(HRNET, (256, 192), 128) * 1e3 == pytest.approx(0.22474, abs=5e-6)


def test_forward_flops_count_every_conv():
    # ResNet-50 trunk at 256x192 plus the head: 3 deconvs of 256 (4 taps an
    # output pixel at stride 2) and the 1x1 to 17 joints, 2 FLOPs a MAC
    head = 2 * (2048 * 256 * 4 * 16 * 12 + 256 * 256 * 4 * 32 * 24 + 256 * 256 * 4 * 64 * 48
                + 256 * 17 * 64 * 48)
    total = forward_flops(FLAGSHIP, (256, 192))
    assert 0 < total - head and (total - head) / 2 == pytest.approx(4.0e9, rel=0.05)
    assert forward_flops(HRNET, (256, 192)) > total


def test_crop_bytes_of_a_translation_by_hand():
    # scale 1, no rotation: stage 2 reads a 257 x 193 block of the
    # intermediate (its taps at floor and floor + 1), whose stage-1 taps
    # touch a 258 x 194 block of the canvas
    trans = torch.tensor([[[1.0, 0.0, -100.0], [0.0, 1.0, -50.0]]])
    flops, nbytes = crop_work((640, 640), 3, trans)
    assert nbytes == 258 * 194 * 3 + 256 * 192 * 3 * 2 + 40
    assert flops == 257 * 193 * 37 + 256 * 192 * 45


def test_crop_bound_is_the_kernel_tables():
    # chip_smoke.train_inputs(np.random.default_rng(5), 128): the batch whose
    # bound PERF.md's table gives as 0.026709 ms (bf16 out)
    rng = np.random.default_rng(5)
    rng.integers(0, 256, (128, 640, 640, 3), dtype=np.uint8)
    trans = np.zeros((128, 2, 3), np.float32)
    for i in range(128):
        bw, bh = rng.uniform(80, 400), rng.uniform(120, 560)
        x1, y1 = rng.uniform(0, 640 - bw), rng.uniform(0, 640 - bh)
        center, scale = box_to_center_scale(x1, y1, bw, bh, 192 / 256)
        trans[i], _ = get_affine_transform(center, scale * rng.uniform(0.7, 1.3),
                                           rng.uniform(-40.0, 40.0), (192, 256))
    _, nbytes = crop_work((640, 640), 3, torch.from_numpy(trans))
    assert nbytes / peaks()["hbm_bytes_per_s"] * 1e3 == pytest.approx(0.026709, abs=5e-6)
    assert math.isclose(peaks()["bf16_flops_per_s"], 989e12)
