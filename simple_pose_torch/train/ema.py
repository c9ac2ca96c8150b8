"""Exponential moving average of the model's parameters and BN statistics.

Port of simple_pose_tpu/train/ema.py (reference ModelEMA,
commons/model_utils.py:49-83): ramped decay
d = base_decay * (1 - exp(-updates / 2000)), computed in f32 at the
post-increment update count; ema <- d * ema + (1 - d) * new, applied to the
parameters AND the BatchNorm running mean and variance (not to
``num_batches_tracked``, which has no flax counterpart).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["ema_decay", "ema_update"]


def ema_decay(updates, base_decay=0.9999) -> float:
    """The decay at ``updates`` (the post-increment count), in f32."""
    n = np.float32(updates)
    return float(np.float32(base_decay) * (np.float32(1.0) - np.exp(-n / np.float32(2000.0))))


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], new: Sequence[torch.Tensor], updates,
               base_decay=0.9999):
    """In place: ema[i] <- d * ema[i] + (1 - d) * new[i] for every i, as two
    multi-tensor ops (a handful of launches for the whole model)."""
    d = ema_decay(updates, base_decay)
    torch._foreach_mul_(list(ema), d)
    torch._foreach_add_(list(ema), [t.to(e.dtype) for e, t in zip(ema, new)], alpha=1.0 - d)
