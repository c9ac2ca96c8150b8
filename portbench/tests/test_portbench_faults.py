"""``correct`` comes out false when the timed path is broken underneath:
each fault a cell can have (faults.py), and each cell's control (one
precision below the configuration's), through the rest of a run at a small
size on the CPU, held to the cell's own limits."""

import pytest
import torch

from portbench import faults
from portbench.run import run_cell
from portbench.tests.small import args, small_cell

CASES = [("resnet50_dconv_se.serve_b128", f) for f in faults.SERVE]
CASES += [(w, f) for w in ("resnet50_dconv_se.train_b128", "hrnet_w32.train_b128")
          for f in faults.TRAIN]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_planted_fault_is_not_correct(workload, fault):
    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    cell = small_cell(workload)
    table = faults.SERVE if cell["traffic"]["driver"] == "serve" else faults.TRAIN
    out, rows, _ = run_cell(cell, args(), device="cpu", fault=table[fault])
    assert not out["correct"], rows


@pytest.mark.parametrize("workload", ["resnet50_dconv_se.serve_b128"])
def test_the_serving_control_is_not_correct(workload):
    """The program with its W8A8 route on, in bf16 as the cell states."""
    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    cell = small_cell(workload, batch=8)
    cell["config"]["amp"] = True
    out, rows, _ = run_cell(cell, args(), device="cpu", variant="control")
    assert not out["correct"], rows


@pytest.mark.parametrize("workload", ["resnet50_dconv_se.train_b128", "hrnet_w32.train_b128"])
def test_the_training_control_is_not_correct(workload):
    """The float32 reference with its convs in float8, in the program's place."""
    from portbench import check
    from portbench.drivers import train as T
    from portbench.gen import make_pool
    from portbench.run import HERE
    from portbench.weights import seeded_state_dict

    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    cell = small_cell(workload, batch=8)
    cfg, mix = cell["config"], cell["traffic"]
    pool = make_pool({**mix, "input_wh": cfg["input_wh"], "num_joints": 17}, 77)
    weights = seeded_state_dict(cfg["model"], 77, "cpu", input_hw=T._hw(cfg))
    got = T.reference(cfg, weights, pool, "cpu", fp8=True)
    numbers = check.train_numbers(got, T.reference(cfg, weights, pool, "cpu"))
    correct, rows = check.judge(numbers, check.load_limits(HERE, workload))
    assert not correct, rows
