"""Learning-rate schedules: pure functions of the global step.

Port of simple_pose_tpu/train/schedules.py:

  * multistep_schedule: what the reference solvers actually use
    (torch MultiStepLR, dp_pose_resnet_solver.py:66-70): lr * gamma^k after
    each epoch milestone.
  * warmup_cosine_multistep_schedule: the reference's
    IterWarmUpCosineDecayMultiStepLRAdjust (commons/optims_utils.py:35-87):
    per-iter linear warmup, then per-milestone-segment cosine decay scaled
    by alpha^k, with the last segment flat.
  * epoch_warmup_cosine_schedule: EpochWarmUpCosineDecayLRAdjust
    (commons/optims_utils.py:90-129).

Each takes a global step count and a steps_per_epoch and returns a callable
step -> lr (a Python float); the train step sets each optimizer group's lr
from it before every update.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "multistep_schedule",
    "warmup_cosine_multistep_schedule",
    "epoch_warmup_cosine_schedule",
]


def multistep_schedule(init_lr, milestones_epochs, gamma, steps_per_epoch):
    boundaries = [m * steps_per_epoch for m in sorted(milestones_epochs)]

    def schedule(step):
        k = sum(step >= b for b in boundaries)
        return init_lr * gamma**k

    return schedule


def _cosine(current, total, gamma, alpha):
    return ((1 + math.cos(current * math.pi / total)) / 2) ** gamma * (1 - alpha) + alpha


def _warmup(step, warm_up_iter, warmup_start, init_lr):
    return float(np.interp(float(step), [0.0, float(max(warm_up_iter, 1))],
                           [warmup_start, init_lr]))


def warmup_cosine_multistep_schedule(init_lr, epochs, milestones, steps_per_epoch,
                                     warm_up_epoch=1, gamma=1.0, alpha=0.1,
                                     warmup_start=0.0):
    """warmup_start: warmup ramps from this ABSOLUTE lr to init_lr.  The
    reference warms the bias param group from 0.1 and everything else from 0
    (optims_utils.py:68-72: ``np.interp(it, [0, warm_up_iter], [0.1, lr])``);
    pass warmup_start=0.1 for the bias-group variant."""
    milestones = sorted(milestones or [])
    last_epoch = epochs + 1 if milestones and milestones[-1] == epochs else epochs
    flags = [int(f) for f in np.unique(np.asarray([warm_up_epoch] + milestones + [last_epoch],
                                                  dtype=np.int64))]
    warm_up_iter = warm_up_epoch * steps_per_epoch

    def schedule(step):
        epoch, ite = divmod(step, steps_per_epoch)
        if epoch < warm_up_epoch:
            return _warmup(step, warm_up_iter, warmup_start, init_lr)
        num_pow = sum(f <= epoch for f in flags) - 1
        num_pow_c = min(max(num_pow, 0), len(flags) - 2)
        seg_start = flags[num_pow_c]
        seg_end = flags[min(num_pow_c + 1, len(flags) - 1)]
        multi_step_w = alpha**num_pow_c
        if num_pow == len(flags) - 2:  # the last segment is flat
            return multi_step_w * init_lr
        cosine_ite = (epoch - seg_start) * steps_per_epoch + ite
        cosine_all = max((seg_end - seg_start) * steps_per_epoch, 1)
        return multi_step_w * _cosine(cosine_ite, cosine_all, gamma, alpha) * init_lr

    return schedule


def epoch_warmup_cosine_schedule(init_lr, epochs, steps_per_epoch, warm_up_epoch=1, gamma=1.0,
                                 alpha=0.1, warmup_start=0.0):
    """warmup_start: see warmup_cosine_multistep_schedule (0.1 for the
    reference's bias group, optims_utils.py:113-117)."""
    warm_up_iter = warm_up_epoch * steps_per_epoch

    def schedule(step):
        epoch = step // steps_per_epoch
        if epoch < warm_up_epoch:
            return _warmup(step, warm_up_iter, warmup_start, init_lr)
        cosine_all = float(max(epochs - warm_up_epoch, 1))
        return _cosine(epoch - warm_up_epoch + 1, cosine_all, gamma, alpha) * init_lr

    return schedule
