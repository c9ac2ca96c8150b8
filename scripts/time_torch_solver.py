"""Solver crops/s on one CUDA card, with the host's image source and the
batches' staging varied.

    python scripts/time_torch_solver.py [--images 1024] [--rounds 2]

Builds chip_smoke.py's phase-7 solver (configs/fast_pose.yaml at full width:
batch 128, dedup 64 canvas slots, 8 pipeline threads, augmentation on) on
synthetic COCO keypoints of ``--images`` 640x480 train images, and times
``PoseSolver.train_epoch`` on the host clock, ending in a synchronise, in
five settings taken in turns, ``--rounds`` times:

  painter          each image painted from a seed when it is read (phase 7's
                   stand-in for a JPEG decoder), 8 pipeline threads;
  painter_1_thread the same with 1 pipeline thread;
  cached           the painted images kept in memory after a first pass, so
                   the host does only the canvas copies, the affines and the
                   joints, 8 threads;
  cached_1_thread  the same with 1 thread;
  cached_sync      as cached, but each batch copied to the card from pageable
                   memory on the compute stream: the staging that
                   parallel/prefetch.device_prefetch exists to avoid.

Also the host pipeline alone (batches/s, the device untouched) for painter
and cached, cached with 1 thread as well, and the bare step on one staged
batch of this data (the ceiling).  Prints one JSON line per measurement,
then a summary line, each with the card's name and power limit.  Needs a
card.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
import simple_pose_torch.data.pipeline as data_pipeline  # noqa: E402
import simple_pose_torch.train.solver as solver_mod  # noqa: E402


def staged_sync(batches, device, depth=2, device_keys=None):
    """Each batch's device keys copied from pageable memory on the compute
    stream, when the consumer asks for the batch."""
    for b in batches:
        yield {**b, **{k: torch.as_tensor(b[k]).to(device, non_blocking=True)
                       for k in device_keys if k in b}}


def host_rate(solver, epoch):
    t0 = time.perf_counter()
    n = sum(1 for _ in solver.train_pipe.epoch(epoch))
    return n / (time.perf_counter() - t0)


def timed_epoch(solver, epoch):
    crop = cs.affine_crop_two_stage
    crop.launches = 0
    torch.cuda.synchronize()
    t0, s0 = time.perf_counter(), solver.state.step
    solver.train_epoch(epoch, log_every=0)
    torch.cuda.synchronize()
    seconds, steps = time.perf_counter() - t0, solver.state.step - s0
    assert crop.launches == steps, (crop.launches, steps)
    return {"steps": steps, "seconds": seconds,
            "crops_per_s": steps * solver.cfg.data.batch_size / seconds}


def bare_step(solver, epoch, steps=20):
    """The step alone, on one batch of this data already on the card.  The
    whole epoch is drained first, so that no pipeline thread runs (and
    takes the interpreter lock) while the step is timed."""
    batch = list(solver.train_pipe.epoch(epoch))[0]
    dev = {k: torch.as_tensor(batch[k]).cuda() for k in solver._TRAIN_DEVICE_KEYS if k in batch}
    for _ in range(3):
        solver._train_step(solver.state, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        solver._train_step(solver.state, dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"steps": steps, "ms_per_step": seconds / steps * 1e3,
            "crops_per_s": steps * solver.cfg.data.batch_size / seconds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_solver: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    imread, prefetch = data_pipeline._imread_rgb, solver_mod.device_prefetch
    cached = functools.lru_cache(maxsize=None)(cs.painted_rgb)
    threads = 8  # configs/fast_pose.yaml's num_workers
    settings = {  # name: (image source, staging, pipeline threads)
        "painter": (cs.painted_rgb, prefetch, threads),
        "painter_1_thread": (cs.painted_rgb, prefetch, 1),
        "cached": (cached, prefetch, threads),
        "cached_1_thread": (cached, prefetch, 1),
        "cached_sync": (cached, staged_sync, threads),
    }
    results = {name: [] for name in settings}
    with tempfile.TemporaryDirectory() as workdir:
        ann = os.path.join(workdir, "train.json")
        n_inst = cs.write_synth_coco(ann, args.images, 1, np.random.default_rng(7))
        cfg = copy.deepcopy(cs.TRAIN_CFG)
        cfg["data"].update(train_ann_path=ann, train_img_root=workdir, num_workers=threads)
        solver = solver_mod.PoseSolver(cfg)
        solver.init_state()
        epoch = 0
        try:
            data_pipeline._imread_rgb = cs.painted_rgb
            rates = {"painter": host_rate(solver, epoch)}
            data_pipeline._imread_rgb = cached
            host_rate(solver, epoch)  # fills the cache
            rates["cached"] = host_rate(solver, epoch)
            solver.train_pipe.num_threads = 1
            rates["cached_1_thread"] = host_rate(solver, epoch)
            solver.train_pipe.num_threads = threads
            print(json.dumps({"card": card, "host_only_batches_per_s": rates}), flush=True)
            timed_epoch(solver, epoch)  # warm-up: cuDNN plans, allocator
            for _ in range(args.rounds):
                for name, (source, staging, n_threads) in settings.items():
                    data_pipeline._imread_rgb, solver_mod.device_prefetch = source, staging
                    solver.train_pipe.num_threads = n_threads
                    epoch += 1
                    row = timed_epoch(solver, epoch)
                    results[name].append(row)
                    print(json.dumps({"card": card, "setting": name, "epoch": epoch, **row}),
                          flush=True)
            solver.train_pipe.num_threads = threads
            bare = bare_step(solver, epoch)
        finally:
            data_pipeline._imread_rgb, solver_mod.device_prefetch = imread, prefetch
    print(json.dumps({
        "card": card, "train_images": args.images, "train_instances": n_inst,
        "host_only_batches_per_s": rates, "bare_step": bare,
        "solver_crops_per_s": {k: [r["crops_per_s"] for r in v] for k, v in results.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
