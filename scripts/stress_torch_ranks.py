"""Repeat the port's multi-process tests on the CPU and count their failures.

    python scripts/stress_torch_ranks.py bn --runs 100 --jobs 4
    python scripts/stress_torch_ranks.py pytest --runs 20
    python scripts/stress_torch_ranks.py bn --tree archive_check/parent   # another checkout
    python scripts/stress_torch_ranks.py bare --runs 200 --jobs 8 [--import-nn]

* ``bn``: ``tests/torch_ddp_worker.run_ranks("bn")`` (two gloo ranks, the
  data of ``test_batchnorm_global_batch_over_two_ranks``), ``--runs`` times,
  ``--jobs`` at once, each in a directory of its own.
* ``pytest``: ``tests/test_torch_ddp.py`` beside ``tests/test_multihost.py``
  and ``tests/test_torch_ddp_eval.py`` under ``-p xdist -n 6 --dist
  loadfile``, as tier-1 runs them, ``--runs`` times in turn.
* ``bare``: two gloo ranks that join, all-reduce, leave and exit, with
  ``--import-nn`` after importing ``torch.distributed.nn`` (what
  ``BatchNorm2d``'s all-reduce imported until it had a Function of its
  own), ``--runs`` times, ``--jobs`` at once.

Prints one JSON: the runs, the failures (pytest: the failed test ids of each
run) and the end of each failing rank's or run's output.  Run it with
``JAX_PLATFORMS=cpu`` for ``pytest``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIO = ["tests/test_torch_ddp.py", "tests/test_multihost.py", "tests/test_torch_ddp_eval.py"]


def bn_once(run_ranks):
    """One run of the BN case's two ranks; None, or what the failing rank
    printed last."""
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(0)  # test_batchnorm_global_batch_over_two_ranks's draws
        x = rng.normal(0.5, 2.0, (8, 4, 5, 6)).astype(np.float32)
        np.savez(os.path.join(d, "bn.npz"), x=x, g=rng.normal(0, 1, x.shape).astype(np.float32),
                 weight=rng.uniform(0.5, 1.5, 4).astype(np.float32),
                 bias=rng.normal(0, 0.5, 4).astype(np.float32))
        try:
            run_ranks("bn", d)
        except AssertionError as e:
            return str(e)[-1200:]
    return None


def stress_bn(tree, runs, jobs):
    sys.path.insert(0, tree)
    from tests.torch_ddp_worker import run_ranks

    with cf.ThreadPoolExecutor(jobs) as ex:
        fails = [f for f in ex.map(lambda _: bn_once(run_ranks), range(runs)) if f]
    return {"case": "bn", "tree": tree, "runs": runs, "jobs": jobs, "failures": len(fails),
            "output": fails}


BARE_RANK = r"""
import sys, torch
torch.set_num_threads(1)
import torch.distributed as dist
dist.init_process_group("gloo", init_method=sys.argv[2], world_size=2, rank=int(sys.argv[1]))
if sys.argv[3] == "1":  # imported under a group, as BatchNorm2d's forward did
    import torch.distributed.nn  # noqa: F401
t = torch.ones(5)
dist.all_reduce(t)
dist.barrier()
dist.destroy_process_group()
"""


def bare_once(import_nn):
    """Two bare ranks; each failing rank's exit code and stderr's end."""
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "rendezvous")
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen([sys.executable, "-c", BARE_RANK, str(r), init,
                                   str(int(import_nn))], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(2)]
        outs = [p.communicate(timeout=120) for p in procs]
    return [f"rank {r}: exit {p.returncode}: {err[-300:]}"
            for r, (p, (_, err)) in enumerate(zip(procs, outs)) if p.returncode]


def stress_bare(runs, jobs, import_nn):
    with cf.ThreadPoolExecutor(jobs) as ex:
        fails = [f for fs in ex.map(lambda _: bare_once(import_nn), range(runs)) for f in fs]
    return {"case": "bare", "import_nn": import_nn, "runs": runs, "jobs": jobs,
            "failed_ranks": len(fails), "output": fails}


def stress_pytest(tree, runs, timeout):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "ALLOW_MULTIPLE_LIBTPU_LOAD": "1"}
    cmd = [sys.executable, "-m", "pytest", *TRIO, "-q", "-rf", "-m", "not slow",
           "-p", "no:cacheprovider", "-p", "xdist", "-n", "6", "--dist", "loadfile",
           "-p", "no:randomly"]
    per_run, output = [], []
    for _ in range(runs):
        proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True,
                              timeout=timeout)
        failed = sorted(set(re.findall(r"^FAILED (\S+)", proc.stdout, re.M)))
        per_run.append({"rc": proc.returncode, "failed": failed,
                        "summary": proc.stdout.strip().splitlines()[-1:]})
        if proc.returncode:
            output.append(proc.stdout[-3000:])
    return {"case": "pytest", "tree": tree, "runs": runs, "files": TRIO,
            "failed_runs": sum(r["rc"] != 0 for r in per_run), "per_run": per_run,
            "output": output}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["bn", "pytest", "bare"])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--jobs", type=int, default=4, help="bn, bare: runs at once")
    ap.add_argument("--import-nn", action="store_true",
                    help="bare: the ranks import torch.distributed.nn first")
    ap.add_argument("--tree", default=REPO, help="the checkout whose tests run")
    ap.add_argument("--timeout", type=float, default=900.0, help="pytest: seconds a run")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    if args.what == "bn":
        out = stress_bn(tree, args.runs, args.jobs)
    elif args.what == "bare":
        out = stress_bare(args.runs, args.jobs, args.import_nn)
    else:
        out = stress_pytest(tree, args.runs, args.timeout)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
