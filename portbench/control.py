"""Readings that a cell's limits are set from: the compared numbers of sound
runs of the program over many seeds, of its control (one precision below
the configuration's) and of planted faults, at the cell's own size, in one
process.

    python3 portbench/control.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--faults half_batch,answer_altered] [--out chiprun_out/x.jsonl]

Serving reads each pool batch of the mix once through the evaluator (the
program's, or the control's: the program with its W8A8 route on), as many
batches as a run compares.  Training reads the program's first three steps
against the reference's; the control is the reference with its convs in
float8 (reference/train.py) in the program's place.  Each reading is one
JSON line: {"workload", "seed", "variant", numbers...}.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import faults  # noqa: E402
from portbench.run import load_cell  # noqa: E402


def serve_reading(cell, seed, device, variant="program", fault=None):
    from portbench.drivers import serve as S

    pool, weights, ev = S.setup(cell, seed, device, variant, fault and faults.SERVE[fault])
    served = {i: {k: v.cpu() for k, v in ev({k: b[k] for k in S.CALL_KEYS}).items()}
              for i, b in enumerate(pool)}
    del ev
    return S.compare(cell["config"], weights, pool, served, device)


def train_reading(cell, seed, device, variant="program", fault=None):
    from portbench import check
    from portbench.drivers import train as T

    if variant == "control":
        pool, weights = T.inputs(cell, seed, device)
        got = T.reference(cell["config"], weights, pool, device, fp8=True)
    else:
        pool, weights, state, step_fn, feed, got = T.first_steps(
            cell, seed, device, fault and faults.TRAIN[fault])
        del state, step_fn, feed
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return check.train_numbers(got, T.reference(cell["config"], weights, pool, device))


def readings(cell, seeds, variant, fault, device, out):
    reader = serve_reading if cell["traffic"]["driver"] == "serve" else train_reading
    for seed in seeds:
        t = time.perf_counter()
        numbers = reader(cell, seed, device, variant, fault)
        line = {"workload": cell["name"], "seed": seed,
                "variant": fault or variant, **numbers, "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--first-seed", type=int, default=3_000_000_019)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    base = args.first_seed
    readings(cell, range(base, base + args.seeds), "program", None, "cuda", args.out)
    ctrl = range(base + 1000, base + 1000 + args.control_seeds)
    readings(cell, ctrl, "control", None, "cuda", args.out)
    for fault in filter(None, args.faults.split(",")):
        readings(cell, ctrl, "program", fault, "cuda", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
