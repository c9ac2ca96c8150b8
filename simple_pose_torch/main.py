"""Training entry point of the port (the counterpart of the root main.py).

    python -m simple_pose_torch.main --cfg configs/fast_pose.yaml [--resume] [--device cpu]
    torchrun --standalone --nproc_per_node=N -m simple_pose_torch.main --cfg ... --multihost
    python -m simple_pose_torch.main --cfg ... --mesh-devices N

Trains on one CUDA device unless ``--device cpu`` is given.  ``--multihost``
joins the process group torchrun starts (one process per card, NCCL);
``--mesh-devices N`` starts N ranks itself, one per local card.  Under a
group each rank trains on ``data.batch_size`` crops, so N ranks train on N
x batch_size (train/solver.py); the config's ``mesh.data`` must be -1 or N.
"""

from __future__ import annotations

import argparse

from simple_pose_torch.parallel.distributed import add_launch_args, launch


def _train(args):
    from simple_pose_torch.train.solver import PoseSolver
    from simple_pose_torch.utils.misc import rand_seed

    rand_seed(1024)
    PoseSolver(args.cfg, device=args.device).run(resume=args.resume)


def main(argv=None):
    ap = argparse.ArgumentParser(description="simple_pose_torch trainer")
    ap.add_argument("--cfg", default="configs/fast_pose.yaml")
    ap.add_argument("--resume", action="store_true", help="resume from <weight_path>/<type>_last.pth")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    add_launch_args(ap)
    launch(_train, ap.parse_args(argv))


if __name__ == "__main__":
    main()
