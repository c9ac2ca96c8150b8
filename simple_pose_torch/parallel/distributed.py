"""Multi-process setup and the collectives of the port (DDP in place of the
JAX mesh).

Port of simple_pose_tpu/parallel/distributed.py (``init_multihost``,
``host_info``) and of the multi-host parts of parallel/mesh.py and
evalkit/workflows.py (``process_allgather(..., tiled=True)``).  One process
per card: a rank is what JAX calls a process, and ``data.batch_size`` is
the batch of one rank.  The semantics of the JAX SPMD program are kept:
gradients, losses and BatchNorm statistics are means over the global batch
(DDP and models/layers.BatchNorm2d), each rank feeds its stride of the
records (data/pipeline.py), and evaluation gathers the results so that
every rank holds the full list.

Without an initialised process group every helper here is the
single-process identity, so the same code runs on one device.
"""

from __future__ import annotations

import json
import os
import tempfile
from datetime import timedelta
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_multihost", "host_info", "rank_world", "is_main", "barrier",
           "allgather_tiled", "allreduce_sum", "allreduce_mean", "allreduce_max",
           "shard_kwargs", "write_once", "shutdown", "file_rendezvous", "spawn_ranks",
           "add_launch_args", "launch"]


# a collective that waits longer than this fails the ranks (a hang ends)
_TIMEOUT = timedelta(minutes=10)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None, process_id: Optional[int] = None,
                   backend: Optional[str] = None, device=None) -> dict:
    """Join the process group and pin this rank's device.

    With no arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
    ``coordinator_address`` with ``num_processes`` and ``process_id`` sets
    up a group by hand: "host:port", where rank 0 binds the group's store,
    or an init URL such as "file:///dir/rendezvous", a file no earlier
    group used, through which the ranks meet without a port.

    :param backend: None picks it: NCCL where each rank has a card of its
        own, gloo on the CPU and where several local ranks are pinned to one
        ``device`` (NCCL refuses two ranks on one card; gloo takes CUDA
        tensors)
    :param device: this rank's device; None means ``cuda:LOCAL_RANK``
        (raises where that card is absent), "cpu" runs on the CPU, and a
        device given pins every local rank to it
    :returns: :func:`host_info`
    """
    if coordinator_address is None:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        rank, world, local_rank = int(process_id), int(num_processes), int(process_id)
        local_world = world
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    dev = torch.device(f"cuda:{local_rank}" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or (dev.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: {dev} is not available "
                               f"({torch.cuda.device_count()} CUDA devices)")
        torch.cuda.set_device(dev)
    if backend is None:
        shared_card = device is not None and local_world > 1
        backend = "nccl" if dev.type == "cuda" and not shared_card else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=_TIMEOUT)
    return {**host_info(), "device": str(dev), "backend": backend}


def host_info() -> dict:
    """The keys of the JAX package's ``host_info``: one card per process."""
    rank, world = rank_world()
    return {"process_index": rank, "process_count": world, "local_devices": 1,
            "global_devices": world}


def rank_world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without an initialised group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main() -> bool:
    return rank_world()[0] == 0


def barrier() -> None:
    if rank_world()[1] > 1:
        dist.barrier()


def _collective_device() -> torch.device:
    """Where host data goes for a collective: the pinned card under NCCL,
    the CPU under gloo (whose all-gather takes CPU tensors only)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_tiled(tree: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every rank's arrays concatenated along axis 0 in rank order (JAX's
    ``process_allgather(..., tiled=True)``).  Each rank passes the same keys
    with the same shapes and dtypes (the pipelines equalize batch counts)."""
    world = rank_world()[1]
    if world == 1:
        return {k: np.asarray(v) for k, v in tree.items()}
    dev = _collective_device()
    out = {}
    for k in sorted(tree):
        local = torch.from_numpy(np.ascontiguousarray(tree[k])).to(dev)
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local)
        out[k] = torch.cat(parts).cpu().numpy()
    return out


def allreduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; ``t`` itself where
    there is one rank)."""
    if rank_world()[1] == 1:
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t


def allreduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks."""
    return allreduce_sum(t) / rank_world()[1]


def allreduce_max(values) -> np.ndarray:
    """Element-wise max of a small int/float vector over the ranks."""
    arr = np.asarray(values)
    if rank_world()[1] == 1:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float64)).to(_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.cpu().numpy().astype(arr.dtype)


def shard_kwargs() -> dict:
    """Pipeline kwargs taking this rank's stride of the records (JAX
    workflows._process_shard_kwargs); none on one rank."""
    rank, world = rank_world()
    return {"process_index": rank, "process_count": world} if world > 1 else {}


def write_once(path: str, write) -> None:
    """``write(path)`` on rank 0 alone, then a barrier, so that no rank
    reads ``path`` before it is complete and no two ranks write it."""
    if is_main():
        write(path)
    barrier()


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def file_rendezvous(directory, name: str = "rendezvous") -> str:
    """An init URL for :func:`init_multihost`'s ``coordinator_address``:
    the file ``<directory>/<name>``, removed first where an earlier group
    left it (a file store must not hold another group's keys).  The ranks
    meet through the file, so no port is chosen before they start."""
    path = os.path.join(os.path.abspath(str(directory)), name)
    if os.path.exists(path):
        os.remove(path)
    return "file://" + path


def _spawned_rank(rank, world, init_method, device, target, args):
    init_multihost(init_method, world, rank, device=device)
    try:
        target(*args)
    finally:
        shutdown()


def spawn_ranks(target, world: int, device=None, args=()):
    """``target(*args)`` in ``world`` new processes, one rank each, joined
    as a group on localhost.  Rank r runs on ``cuda:r`` (device None: an
    error where fewer cards exist) or every rank on ``device``.  The ranks
    meet through :func:`file_rendezvous` in a directory removed after they
    end.  Raises if a rank fails."""
    if device is None and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} CUDA devices; "
                           f"{torch.cuda.device_count()} are present")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        torch.multiprocessing.spawn(_spawned_rank, nprocs=world, join=True,
                                    args=(world, file_rendezvous(tmp), device, target, args))


def add_launch_args(parser) -> None:
    """The CLIs' multi-process options (the JAX CLIs' --multihost and
    --mesh-devices)."""
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group that torchrun describes (RANK, "
                             "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) first: "
                             "one process per card")
    parser.add_argument("--mesh-devices", type=int, default=0,
                        help="run N ranks on N local cards (cuda:0..N-1, or all on --device); "
                             "0 or 1: one process")


def launch(target, args) -> None:
    """``target(args)`` in this process (after joining torchrun's group with
    ``--multihost``), or on ``--mesh-devices`` new ranks."""
    if args.multihost and args.mesh_devices > 1:
        raise ValueError("--multihost and --mesh-devices exclude each other")
    if args.multihost:
        info = init_multihost(device=args.device)
        if is_main():
            print(json.dumps(info))
        try:
            target(args)
        finally:
            shutdown()
    elif args.mesh_devices > 1:
        spawn_ranks(target, args.mesh_devices, device=args.device, args=(args,))
    else:
        target(args)
