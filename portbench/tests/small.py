"""A cell of the benchmark cut to a size that a CPU test run holds: the
cell's own configuration (full depth, published widths) at a small input
and batch, and its mix at a small canvas."""

from __future__ import annotations

import argparse
import copy

from portbench.run import load_cell


def small_cell(name: str, batch=4, input_wh=(64, 64)) -> dict:
    cell = copy.deepcopy(load_cell(name))
    cfg, mix = cell["config"], cell["traffic"]
    cfg["input_wh"] = list(input_wh)
    cfg["amp"] = cfg["optim"]["amp"] = False
    mix.update(batch=batch, canvas_slots=max(1, batch // 2), canvas=96, image_wh=[96, 72],
               box_w=[20, 60], box_h=[30, 70], pool_batches=3)
    for key in ("trace_batches", "trace_steps"):
        if key in mix:
            mix[key] = 1
    return cell


def args(seed=2 ** 31 + 7, seconds=0.0, trace=0):
    return argparse.Namespace(seed=seed, seconds=seconds, trace=trace)
