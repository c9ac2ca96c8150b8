"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
mix are found by name from ``BENCHMARK.json``; the mix names its driver
(``drivers/<driver>.py``); each per-layer metric is the reader
``metrics/<metric name>.py``.  The last line of standard output is the
result as one JSON object; the numbers that decided ``correct`` are the last
lines of standard error and the last key of that object.

The run exits with code 2, printing no result, where there is no CUDA
device or fewer than the cell asks for, and with code 3 where a module of
JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# every compile cache of the run at a fixed place inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "simple_pose_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The workload ``name`` with its configuration, traffic mix, metrics and
    limits, as BENCHMARK.json and the files it names give them."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; choose from {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def listed(metric):
        return name in metric.get("workloads", [name])

    return {"name": name, "chips": w["chips"],
            "config": load_json(os.path.join(root, conf["file"])),
            "traffic": load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
            "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
            "per_layer": [m for m in bench["per_layer"] if listed(m)]}


def metric_reader(name: str):
    """The module ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer_values(cell: dict, result: dict) -> dict:
    """{metric: value} of the cell's per-layer metrics that found something
    to read."""
    ctx = {"cell": cell, **result["layer"]}
    out = {}
    for m in cell["per_layer"]:
        reader = metric_reader(m["name"])
        if (reader.UNIT, reader.LAYER, reader.MOVES) != (m["unit"], m["layer"], m["moves"]):
            raise SystemExit(f"metrics/{m['name']}.py declares {reader.UNIT!r}, "
                             f"{reader.LAYER!r}, {reader.MOVES!r}; BENCHMARK.json says "
                             f"{m['unit']!r}, {m['layer']!r}, {m['moves']!r}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell, args, device="cuda", variant="program", fault=None, limits=None):
    """Drive the cell once; returns (the result object, the check rows
    [[number, value, limit], ...], the driver's own result)."""
    from portbench import check

    driver = importlib.import_module(f"portbench.drivers.{cell['traffic']['driver']}")
    result = driver.run(cell, args, T_START, device=device, variant=variant, fault=fault)
    limits = check.load_limits(HERE, cell["name"]) if limits is None else limits
    correct, rows = check.judge(result["numbers"], limits)
    if args.trace:
        metrics = per_layer_values(cell, result)
    else:
        values = {**result["e2e"], "setup_s": result["setup_s"]}
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    is_cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(result["memory_peak"])}
    out = {"correct": bool(correct), "attempted": int(result["attempted"]),
           "failed": int(result["failed"]), "metrics": metrics, "device": dev}
    tr = result["layer"].get("trace")
    if args.trace and tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    out["checks"].update({k: v for k, v in result["numbers"].items()
                          if k not in limits and isinstance(v, (int, float))})
    return out, rows, result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, rows, result = run_cell(cell, args)
    if "launches" in result["layer"]:
        per = result["layer"]["trace"].iterations + 1
        print("launches in the traced slice (" + str(per) + " iterations): "
              + json.dumps(result["layer"]["launches"]), flush=True)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, value, limit in rows:
        ok = math.isfinite(value) and value <= limit
        print(f"check {name} {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
