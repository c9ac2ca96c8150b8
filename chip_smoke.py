"""Chip smoke test of the PyTorch + CUDA port: drives the serving path and the
training step on one CUDA card and holds every kernel against its plain
PyTorch version.

    python3 chip_smoke.py

Imports torch, numpy and simple_pose_torch only.  Phases (any failure
raises, and the script exits non-zero without a result line):

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     TF32 off for the f32 comparisons;
  2. build every kernel from csrc/ with nvcc (into build/), one nvcc per
     source, all started together, timed;
  3. each kernel against its plain version at the main path's shapes (the
     flagship ResNet-50+SE layer1: x [32, 64, 64, 48], 3 blocks, SE and a
     projection in block 0, BN folded from seeded non-trivial statistics),
     in bf16 and f32, then timed beside the plain version and the library
     call (the unfused cuDNN layer1 of the port's own model) at batch 32 and
     128;
  4. the main path: PoseEvaluator(ResNet-50-DConv+SE, 256x192, bf16,
     fused_layer1, flip-test) on 4 synthetic batches of 32 with the launch
     counters zeroed just before and read just after; fused vs unfused
     heatmaps; the f32 card path vs the CPU plain path on 2 crops; COCO
     stats against a synthetic GT; crops/s at batch 128;
  5. the rotation-resample kernel K1 against its plain version at the
     training path's shapes (batch 128 of 640^2 seeded uint8 canvases, box
     affines rotated within +-40 deg and scaled 0.7-1.3, the 328^2 bf16
     stage-1 intermediate, 256x192 crops): f32 out bit for bit (asserted to
     1e-3), bf16 out equal to the f32 out rounded; then timed in bf16 and f32
     out beside the plain version and one grid_sample on the same
     intermediate;
  6. the training path: init_train_state + make_train_step with
     configs/fast_pose.yaml's model and optimizer (ResNet-50-DConv+SE,
     256x192, Adam, multistep, EMA, bf16 autocast, unbiased targets) at batch
     128 on the phase-5 canvases, 3 warm-up and 20 timed steps with the
     launch counters zeroed just before and read just after; train crops/s
     and peak memory; then one f32 step on 2 crops on the card (the kernel,
     TF32 off) against the same step on the CPU (the plain versions) from the
     same state.

The line before the last holds the kernels' JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from simple_pose_torch.evalkit.workflows import PoseEvaluator, kps_to_dicts
from simple_pose_torch.metrics.cocoeval import evaluate_map
from simple_pose_torch.models.resnet import build_resnet
from simple_pose_torch.ops import affine as A
from simple_pose_torch.ops.bottleneck_chain import (
    bottleneck_chain,
    bottleneck_chain_reference,
    fold_bottleneck_blocks,
    prepare_blocks,
)
from simple_pose_torch.ops.rotate_resample import (
    affine_crop_two_stage,
    rotate_resample,
    rotate_resample_reference,
)
from simple_pose_torch.ops.warp import decompose_affine, stage1_resample
from simple_pose_torch.train.solver import init_train_state, make_train_step
from simple_pose_torch.utils.cuda_build import build_library

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
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


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: the layer1 chain kernel against its plain version
# ---------------------------------------------------------------------------


def flagship_layer1():
    """The flagship model's layer1 modules with seeded non-trivial BN
    statistics and affines (numpy RNG), on the card."""
    model = build_resnet("resnet50", se=True)
    rng = np.random.default_rng(0)
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


def errors(got, want):
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    return d.max().item(), d.max().item() / scale, d.mean().item() / scale


def check_chain_kernel(layer1):
    folded = fold_bottleneck_blocks(list(layer1))
    rng = np.random.default_rng(1)
    x32 = torch.from_numpy(np.abs(rng.normal(0, 1, (BATCH, 64, 64, 48))).astype(np.float32)).cuda()
    report = {}
    for name, dt in DTYPES.items():
        blocks = prepare_blocks(folded, dt)
        x = x32.to(dt)
        want = bottleneck_chain_reference(x, blocks, dt)
        got = bottleneck_chain(x, blocks, dt)
        torch.cuda.synchronize()
        assert got.shape == (BATCH, 256, 64, 48) and got.dtype == dt
        assert torch.isfinite(got.float()).all()
        max_abs, max_rel, mean_rel = errors(got, want)
        tol_max, tol_mean = TOL[name]
        log(f"layer1 chain {name}: max|d| {max_abs:.3e}  max rel {max_rel:.3e} (< {tol_max})"
            f"  mean rel {mean_rel:.3e} (< {tol_mean})")
        assert max_rel < tol_max and mean_rel < tol_mean, f"chain kernel disagrees ({name})"
        report[name] = {"max_abs_err": max_abs, "max_rel_err": max_rel, "mean_rel_err": mean_rel}

    timing = {}
    for batch in (BATCH, THROUGHPUT_BATCH):
        xb = torch.from_numpy(np.abs(rng.normal(0, 1, (batch, 64, 64, 48))).astype(np.float32))
        xb = xb.cuda()
        for name, dt in DTYPES.items():
            blocks = prepare_blocks(folded, dt)
            x = xb.to(dt)
            flops, nbytes = chain_work(blocks, batch, 64, 48, x.element_size())
            peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
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
            timing[f"b{batch}_{name}"] = row
            log(f"layer1 chain b{batch} {name}: " + json.dumps(row))
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


def run_main_path(workdir):
    rng = np.random.default_rng(2)
    ev = PoseEvaluator(CFG, None, INPUT_SHAPE, amp="auto", fused_layer1=True, flip_test=True)
    assert ev.dtype == torch.bfloat16
    batches, images, anns = [], [], []
    for bi in range(NUM_BATCHES):
        b, im, an = synthetic_batch(rng, BATCH, 1 + bi * BATCH)
        batches.append(b)
        images += im
        anns += an

    bottleneck_chain.launches = 0
    t0 = time.perf_counter()
    outs = [{k: v.cpu().numpy() for k, v in ev(b).items()} for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"bottleneck_chain": bottleneck_chain.launches}
    log(f"main path: {NUM_BATCHES} batches of {BATCH} in {seconds:.3f} s (first call "
        f"included); launches {launches}")
    expected = NUM_BATCHES * 2  # one chain call per forward; flip-test forwards twice
    assert launches["bottleneck_chain"] == expected, (launches, expected)
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
    log("COCO stats (seeded random weights, synthetic GT): " + json.dumps(stats))

    # fused vs unfused heatmaps on the same crops, bf16
    unfused = PoseEvaluator(CFG, None, INPUT_SHAPE, amp="auto", fused_layer1=False,
                            flip_test=True)
    hf, hu = ev.heatmaps(batches[0]), unfused.heatmaps(batches[0])
    assert hf.shape == (BATCH, 17, 64, 48) and torch.isfinite(hf).all()
    _, max_rel, mean_rel = errors(hf, hu)
    log(f"fused vs unfused heatmaps (bf16): max rel {max_rel:.3e} (< {FUSED_HEAT_TOL[0]})"
        f"  mean rel {mean_rel:.3e} (< {FUSED_HEAT_TOL[1]})")
    assert max_rel < FUSED_HEAT_TOL[0] and mean_rel < FUSED_HEAT_TOL[1]

    # f32 on the card (the kernel) vs the CPU plain path, 2 crops
    small = {k: v[:2] for k, v in batches[0].items()}
    kw = dict(amp=False, fused_layer1=True, flip_test=True)
    h_gpu = PoseEvaluator(CFG, None, INPUT_SHAPE, **kw).heatmaps(small).cpu()
    h_cpu = PoseEvaluator(CFG, None, INPUT_SHAPE, device="cpu", **kw).heatmaps(small)
    _, max_rel, _ = errors(h_gpu, h_cpu)
    log(f"f32 card vs CPU heatmaps: max rel {max_rel:.3e} (< {F32_HEAT_REL})")
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
    # the whole training crop, and its stage 1 (f32 cuBLAS), for their share
    # of the step
    timing["crop_ms"] = {
        "stage1": cuda_ms(lambda: stage1_resample(canvas, d0, d1, t1x, t1y, INTER), iters=10),
        "two_stage_bf16": cuda_ms(lambda: affine_crop_two_stage(
            canvas, trans, CROP_HW, inter=INTER, out_dtype=torch.bfloat16), iters=10),
    }
    log(f"training crop b{TRAIN_BATCH} ms: " + json.dumps(timing["crop_ms"]))
    return report, timing, {"canvas": canvas, "trans": trans}


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


def check_f32_step(data):
    """One f32 step on 2 crops on the card (K1, cuDNN with TF32 off) against
    the same step on the CPU (the plain versions), from the same state."""
    cfg = copy.deepcopy(TRAIN_CFG)
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


def run_train_path(data_dev, data):
    state = init_train_state(TRAIN_CFG)
    assert state.model.dtype == torch.bfloat16
    step = make_train_step(HEAT_HW, CROP_HW, amp=True, crop_impl="kernel", ema=True,
                           encoding="unbiased")
    batch = {**data_dev, "joints": torch.from_numpy(data["joints"]).cuda()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for fn in (bottleneck_chain, rotate_resample):
        fn.launches = 0
    losses, accs = [], []
    for _ in range(TRAIN_WARMUP):
        state, m = step(state, batch)
        losses.append(m["loss"])
        accs.append(m["acc"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        state, m = step(state, batch)
        losses.append(m["loss"])
        accs.append(m["acc"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"bottleneck_chain": bottleneck_chain.launches,
                "rotate_resample": rotate_resample.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().cpu().numpy()
    accs = torch.stack(accs).float().cpu().numpy()
    log(f"train path: launches {launches}; loss per step {[float(x) for x in losses]}; "
        f"acc per step {[float(x) for x in accs]}")
    assert launches["rotate_resample"] == TRAIN_WARMUP + TRAIN_TIMED, launches
    assert np.isfinite(losses).all() and np.isfinite(accs).all()
    assert state.step == TRAIN_WARMUP + TRAIN_TIMED
    rate = TRAIN_TIMED * TRAIN_BATCH / seconds
    return launches, {"crops_per_s": rate, "ms_per_step": seconds / TRAIN_TIMED * 1e3,
                      "max_memory_allocated_gib": peak / 2**30,
                      "losses": [float(x) for x in losses]}


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

    report, timing = check_chain_kernel(flagship_layer1())
    with tempfile.TemporaryDirectory() as workdir:
        launches, stats, rates = run_main_path(workdir)
    log(f"serving crops/s at batch {THROUGHPUT_BATCH} (bf16, fused_layer1, flip-test) "
        f"on {card}: " + json.dumps(rates))
    log("layer1 timing: " + json.dumps({"card": card, **timing}))

    data = train_inputs(np.random.default_rng(5), TRAIN_BATCH)
    rot_report, rot_timing, data_dev = check_rotate_kernel(data)
    log("rotate_resample timing: " + json.dumps({"card": card, **rot_timing}))
    train_launches, train = run_train_path(data_dev, data)
    log(f"train crops/s at batch {TRAIN_BATCH} (ResNet-50-DConv+SE 256x192, bf16, Adam, EMA) "
        f"on {card}: {train['crops_per_s']:.2f} ({train['ms_per_step']:.2f} ms/step); "
        f"torch.cuda.max_memory_allocated {train['max_memory_allocated_gib']:.2f} GiB")
    f32_step = check_f32_step(data)
    log("train path: " + json.dumps({"card": card, **train, "f32_step": f32_step}))

    main_row = timing[f"b{BATCH}_bf16"]
    kernels = [{
        "name": "bottleneck_chain",
        "route": "cuda",
        "source": "simple_pose_torch/csrc/bottleneck_chain.cu",
        "replaces": "simple_pose_tpu/ops/pallas_bottleneck.py:88",
        "launches": launches["bottleneck_chain"],
        "max_abs_err": report["bf16"]["max_abs_err"],
        "ms": main_row["kernel_ms"],
        "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "errors": report,
    }]
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
    })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
