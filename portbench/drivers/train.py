"""Training: back-to-back steps of the port's ``make_train_step`` fed by its
``device_prefetch``, as ``PoseSolver.train_epoch`` runs them.

Set-up draws the host pool and the weights from the seed, builds the
training state with ``init_train_state`` and loads the weights into it
(the model, and the EMA copies, as a ``model.pretrained`` checkpoint would
be loaded before they are made), and takes the first steps through the
window's own feed and call: steps 1-3 are the ones the reference follows
(each on a different pool batch), then ``warm_steps`` more.  The window
runs steps until ``--seconds`` have passed, fetching loss and accuracy to
the host every ``drain_every`` steps, and ends on a synchronize.

The comparison (``check.train_numbers``) holds the program's losses of
steps 1-3, the gradient of step 1 as Adam received it (its first moment
over 1 - beta1), and the change of every parameter and EMA tensor over the
three steps (read before step 4) against the float32 reference's, which
runs after the window on the same weights and batches.
"""

from __future__ import annotations

import itertools
import time

import torch

from portbench import check
from portbench.gen import make_pool
from portbench.reference import ops as R
from portbench.reference.train import norms, run_reference
from portbench.trace import Spans, profile_slice
from portbench.weights import plain_model, seeded_state_dict

__all__ = ["run", "inputs", "first_steps", "reference"]

FEED_KEYS = ("canvas", "canvas_idx", "trans", "joints")
REF_STEPS = 3


def _hw(cfg):
    in_w, in_h = cfg["input_wh"]
    return (in_h, in_w)


def program_state(cfg, weights, device):
    """The port's training state with ``weights`` in the model and its EMA,
    and its step function."""
    from simple_pose_torch.train.solver import init_train_state, make_train_step

    crop_hw = _hw(cfg)
    state = init_train_state({"model": cfg["model"], "optim": cfg["optim"],
                              "data": {"input_shape": list(cfg["input_wh"])}},
                             device=device, steps_per_epoch=cfg["steps_per_epoch"])
    state.model.load_state_dict(weights)
    with torch.no_grad():
        for k, t in {**state.ema_params, **state.ema_buffers}.items():
            t.copy_(weights[k])
    step = make_train_step(out_shape=(crop_hw[0] // 4, crop_hw[1] // 4), crop_shape=crop_hw,
                           amp=cfg["optim"]["amp"], ema=cfg["optim"]["ema"],
                           encoding="unbiased")
    return state, step


def readings(state, weights, losses, grad):
    """The program's side of check.train_numbers, read after step 3."""
    params = dict(state.model.named_parameters())
    return {"loss": losses, "grad": grad,
            "change": norms({k: p.detach() - weights[k] for k, p in params.items()}),
            "ema": norms({k: t - weights[k]
                          for k, t in {**state.ema_params, **state.ema_buffers}.items()})}


def first_grad(state):
    """Each parameter's first gradient as Adam received it: its first moment
    after one step over 1 - beta1 (0 where Adam holds no moment)."""
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    opt = state.optimizer.state
    return norms({k: opt[p]["exp_avg"] / (1 - beta1) if "exp_avg" in opt.get(p, {})
                  else torch.zeros_like(p) for k, p in state.model.named_parameters()})


@R.exact_f32()
def reference(cfg, weights, pool, device, fp8=False):
    model = plain_model(cfg["model"], device)
    model.load_state_dict(weights)
    canvases = [torch.as_tensor(b["canvas"], device=device) for b in pool[:REF_STEPS]]
    return run_reference(model, cfg["optim"], cfg["steps_per_epoch"], pool[:REF_STEPS],
                         canvases, _hw(cfg), fp8=fp8, steps=REF_STEPS)


def inputs(cell, seed, device):
    """A run's host pool and weights, drawn from ``seed``."""
    cfg, mix = cell["config"], cell["traffic"]
    pool = make_pool({**mix, "input_wh": cfg["input_wh"],
                      "num_joints": cfg["model"]["num_joints"]}, seed)
    return pool, seeded_state_dict(cfg["model"], seed, device, input_hw=_hw(cfg))


def first_steps(cell, seed, device, fault=None):
    """A run's set-up up to its first ``REF_STEPS`` steps, which go through the
    window's own feed and call: (pool, weights, state, step function, feed,
    the program's side of check.train_numbers)."""
    from simple_pose_torch.parallel.prefetch import device_prefetch

    cfg, mix = cell["config"], cell["traffic"]
    pool, weights = inputs(cell, seed, device)
    state, step_fn = program_state(cfg, weights, device)
    if fault is not None:
        step_fn = fault(step_fn)
    host = ({k: b[k] for k in FEED_KEYS} for b in itertools.cycle(pool))
    feed = device_prefetch(host, device, depth=mix["prefetch_depth"], device_keys=FEED_KEYS)
    losses, grad = [], None
    for i in range(REF_STEPS):
        state, m = step_fn(state, next(feed))
        losses.append(float(m["loss"]))
        if i == 0:
            grad = first_grad(state)
    return pool, weights, state, step_fn, feed, readings(state, weights, losses, grad)


def run(cell, args, t_start, device="cuda", variant="program", fault=None):
    if variant != "program":
        raise ValueError("the training control is the reference in the program's place; "
                         "control.py reads it, a run does not")

    cfg, mix = cell["config"], cell["traffic"]
    pool, weights, state, step_fn, feed, prog = first_steps(cell, args.seed, device, fault)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    weights = {k: v.cpu() for k, v in weights.items()}  # off the device through the window
    for _ in range(mix["warm_steps"]):
        state, m = step_fn(state, next(feed))
    float(m["loss"])
    sync()

    spans = Spans()
    pending, drained = [], []
    count = {"steps": 0}

    def drain():
        with spans.span("drain"):
            if pending:
                drained.append(torch.stack(pending).cpu())
                pending.clear()

    def one():
        nonlocal state
        with spans.span("stage"):
            batch = next(feed)
        with spans.span("call"):
            state, m = step_fn(state, batch)
        pending.append(torch.stack([m["loss"], m["acc"]]))
        count["steps"] += 1
        if count["steps"] % mix["drain_every"] == 0:
            drain()

    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    while not count["steps"] or time.perf_counter() - t0 < args.seconds:
        one()
    drain()
    sync()
    window_s = time.perf_counter() - t0
    steps = count["steps"]
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    crops = steps * mix["batch"]
    layer = {"spans": {k: list(v) for k, v in spans.seconds.items()}, "window_s": window_s, "crops": crops,
             "steps": steps, "trace": None}
    if args.trace:
        from simple_pose_torch.utils.cuda_build import launch_counts, zero_launch_counts

        zero_launch_counts()
        traced = []

        def traced_step():
            nonlocal state
            with spans.span("stage"):
                batch = next(feed)
            traced.append(batch["trans"])
            with spans.span("call"):
                state, _ = step_fn(state, batch)

        layer["trace"] = profile_slice(traced_step, mix["trace_steps"], spans)
        layer["launches"] = launch_counts()
        layer["crop_trans"] = [t.detach().cpu() for t in traced[1:]]
        layer["canvas_hw"] = (mix["canvas"], mix["canvas"])
    del state, step_fn, feed
    if cuda:
        torch.cuda.empty_cache()
    ref = reference(cfg, weights, pool, device)
    numbers = check.train_numbers(prog, ref)
    return {"attempted": crops, "failed": 0, "setup_s": setup_s, "memory_peak": memory_peak,
            "e2e": {"train_crops_per_s": crops / window_s,
                    "train_peak_gib": memory_peak / 2 ** 30},
            "layer": layer, "numbers": numbers}
