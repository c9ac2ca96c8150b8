"""Training entry point of the port (the counterpart of the root main.py).

    python -m simple_pose_torch.main --cfg configs/fast_pose.yaml [--resume] [--device cpu]

Trains on one CUDA device unless ``--device cpu`` is given; the config's
``mesh`` is not used (one device until DDP is ported, ROADMAP.md).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="simple_pose_torch trainer")
    ap.add_argument("--cfg", default="configs/fast_pose.yaml")
    ap.add_argument("--resume", action="store_true", help="resume from <weight_path>/<type>_last.pth")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from simple_pose_torch.train.solver import PoseSolver
    from simple_pose_torch.utils.misc import rand_seed

    rand_seed(1024)
    PoseSolver(args.cfg, device=args.device).run(resume=args.resume)


if __name__ == "__main__":
    main()
