"""Serving: a closed loop with one batch in flight through the port's
``PoseEvaluator.__call__``, as ``predicts_by_gt`` drives it.

Set-up draws the host pool (``gen.make_pool``) and the weights from the
seed, builds the evaluator with the mix's options on that state dict, and
calls it once on every pool batch (the first run in a checkout builds the
kernels here).  The window hands pool batches in turn to the evaluator and
brings each batch's ``kps``, ``conf`` and ``scores`` to host memory before
the next; a batch's latency runs from the call to its outputs on the host.

After the window: the memory peak is read, the evaluator is freed, and the
plain reference recomputes, for one served occurrence of each pool batch
(drawn from the seed), the float32 heatmaps of every crop and its flip,
which ``check.serve_numbers`` holds the served outputs to.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check
from portbench.gen import get_affine_transform, make_pool
from portbench.reference import ops as R
from portbench.trace import Spans, profile_slice
from portbench.weights import plain_model, seeded_state_dict

__all__ = ["run", "setup", "evaluator", "reference_outputs", "compare"]

# the keys PoseEvaluator.__call__ reads
CALL_KEYS = ("canvas", "trans", "trans_inv", "canvas_idx")


def evaluator(cfg, mix, weights, device, variant="program"):
    """The program's evaluator for the mix; ``variant="control"`` switches
    on its int8 route (W8A8, dynamic scales), the nearest precision below
    the configuration's bf16."""
    from simple_pose_torch.evalkit.workflows import PoseEvaluator

    return PoseEvaluator(cfg["model"], weights=weights, input_shape=tuple(cfg["input_wh"]),
                         decoder=mix["decoder"], flip_test=mix["flip_test"], amp=cfg["amp"],
                         fused_layer1=mix["fused_layer1"], device=device,
                         quant="w8a8" if variant == "control" else None)


@torch.no_grad()
@R.exact_f32()
def reference_outputs(cfg, weights, batch, device, rows=32):
    """The plain float32 reference's flip-merged heatmaps of a pool batch's
    crops, and its decode, computed ``rows`` crops at a time."""
    model = plain_model(cfg["model"], device)
    model.load_state_dict(weights)
    model.eval()
    in_w, in_h = cfg["input_wh"]
    canvas = torch.as_tensor(batch["canvas"], device=device)
    idx = torch.as_tensor(batch["canvas_idx"], device=device).long()
    heats = []
    for lo in range(0, idx.shape[0], rows):
        sl = slice(lo, lo + rows)
        trans = torch.as_tensor(batch["trans"][sl], device=device)
        x = R.normalize(R.crop(canvas[idx[sl]], trans, (in_h, in_w)))
        heats.append(R.flip_merge(model(x), model(x.flip(3))))
    heat = torch.cat(heats)
    return (heat, *R.decode(heat))


def heat_affines(batch, heat_wh):
    """image -> heatmap affines, rebuilt from each crop's centre and scale."""
    return np.stack([get_affine_transform(c, s, r, heat_wh)[0]
                     for c, s, r in zip(batch["center"], batch["scale"], batch["rot"])])


def compare(cfg, weights, pool, served, device):
    """check.serve_numbers over the served outputs of the pool batches
    (``served``: {pool index: host outputs})."""
    in_w, in_h = cfg["input_wh"]
    parts = []
    for i, out in served.items():
        ref = reference_outputs(cfg, weights, pool[i], device)
        parts.append((ref, {k: v.to(device) for k, v in out.items()},
                      torch.as_tensor(heat_affines(pool[i], (in_w // 4, in_h // 4)),
                                      device=device)))
    ref = [torch.cat([p[0][k] for p in parts]) for k in range(len(parts[0][0]))]
    out = {k: torch.cat([p[1][k] for p in parts]) for k in parts[0][1]}
    return check.serve_numbers(ref, out, torch.cat([p[2] for p in parts]))


def setup(cell, seed, device, variant="program", fault=None):
    """A run's host pool, weights and evaluator (with ``fault`` planted)."""
    cfg, mix = cell["config"], cell["traffic"]
    gen_mix = {**mix, "input_wh": cfg["input_wh"], "num_joints": cfg["model"]["num_joints"]}
    pool = make_pool(gen_mix, seed)
    weights = seeded_state_dict(cfg["model"], seed, device,
                                input_hw=(cfg["input_wh"][1], cfg["input_wh"][0]))
    ev = evaluator(cfg, mix, weights, device, variant)
    if fault is not None:
        fault(ev)
    return pool, weights, ev


def run(cell, args, t_start, device="cuda", variant="program", fault=None):
    cfg, mix = cell["config"], cell["traffic"]
    pool, weights, ev = setup(cell, args.seed, device, variant, fault)
    weights = {k: v.cpu() for k, v in weights.items()}  # off the device through the window
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    calls = [{k: b[k] for k in CALL_KEYS} for b in pool]
    for c in calls:
        {k: v.cpu() for k, v in ev(c).items()}
    sync()
    spans = Spans()
    outs, latency = [], []
    state = {"n": 0}

    def one():
        c = calls[state["n"] % len(calls)]
        t = time.perf_counter()
        with spans.span("call"):
            out = ev(c)
        with spans.span("fetch"):
            host = {k: v.cpu() for k, v in out.items()}
        latency.append(time.perf_counter() - t)
        state["n"] += 1
        return host

    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    while not outs or time.perf_counter() - t0 < args.seconds:
        outs.append(one())
    window_s = time.perf_counter() - t0
    n = len(outs)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    crops = n * mix["batch"]
    layer = {"spans": {k: list(v) for k, v in spans.seconds.items()}, "window_s": window_s, "crops": crops,
             "batches": n, "trace": None}
    if args.trace:
        from simple_pose_torch.utils.cuda_build import launch_counts, zero_launch_counts

        zero_launch_counts()
        layer["trace"] = profile_slice(one, mix["trace_batches"], spans)
        layer["launches"] = launch_counts()
    del ev
    if cuda:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(args.seed)
    served = {}
    for i in range(len(pool)):
        seen = list(range(i, n, len(pool)))
        if seen:
            served[i] = outs[int(rng.choice(seen))]
    numbers = compare(cfg, weights, pool, served, device)
    p95 = float(np.percentile(np.asarray(latency[:n]) * 1e3, 95))
    return {"attempted": crops, "failed": 0, "setup_s": setup_s, "memory_peak": memory_peak,
            "e2e": {"serve_crops_per_s": crops / window_s, "serve_p95_ms": p95},
            "layer": layer, "numbers": numbers}
