"""Small training utilities (commons/model_utils.py equivalents).

Port of simple_pose_tpu/utils/misc.py:20-27 (``rand_seed``), which also
seeds torch here: the port's model init draws from its own seeded
torch.Generator, but anything that uses torch's global generator is seeded.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

__all__ = ["rand_seed"]


def rand_seed(seed: int = 888):
    """Seed python, numpy and torch (all devices) RNGs
    (commons/model_utils.py:9-17)."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
