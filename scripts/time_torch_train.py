"""Train crops/s of the port's flagship training step on one CUDA card.

    python scripts/time_torch_train.py [--steps 60]

Runs chip_smoke.py's phase 6 (configs/fast_pose.yaml's ResNet-50-DConv+SE,
256x192, batch 128, bf16 autocast, Adam, EMA, on the phase-5 canvases) with
``--steps`` timed steps after 3 warm-up steps, and prints one JSON line: the
card, the launch counts, crops/s, ms per step and peak device memory.  It
imports chip_smoke from the current directory, so it runs unchanged in an
older checkout: to compare two checkouts on one card, copy it into both and
run them in turns (old, new, new, old).  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_train: no CUDA device", file=sys.stderr)
        return 2
    cs.TRAIN_TIMED = args.steps
    data = cs.train_inputs(np.random.default_rng(5), cs.TRAIN_BATCH)
    dev = {k: torch.from_numpy(data[k]).cuda() for k in ("canvas", "trans")}
    launches, train = cs.run_train_path(dev, data)
    print(json.dumps({"card": cs.card_line(), "cwd": os.getcwd(), "launches": launches,
                      "steps": args.steps, "crops_per_s": train["crops_per_s"],
                      "ms_per_step": train["ms_per_step"],
                      "max_memory_allocated_gib": train["max_memory_allocated_gib"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
