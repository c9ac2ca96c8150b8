"""The plain reference against the port, at small sizes on the CPU: the
two model families on one state dict, the crops, the decode, the targets,
and the benchmark's whole comparison on sound float32 runs of each cell."""

import numpy as np
import pytest
import torch

from portbench.reference import ops as R
from portbench.reference.models import build
from portbench.weights import seeded_state_dict
from portbench.tests.small import args, small_cell

FAMILIES = [{"type": "pose_resnet_dconv", "name": "resnet50", "num_joints": 17,
             "reduction": True},
            {"type": "pose_hrnet", "name": "w32", "num_joints": 17}]


@pytest.mark.parametrize("cfg", FAMILIES, ids=["resnet50_dconv_se", "hrnet_w32"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_plain_models_match_the_port(cfg, train):
    from simple_pose_torch.models.registry import build_from_cfg

    sd = seeded_state_dict(cfg, 2 ** 35 + 11, "cpu", input_hw=(64, 64), calib_images=2)
    prog, ref = build_from_cfg(cfg), build(cfg)
    assert set(prog.state_dict()) == set(sd) == set(ref.state_dict())
    prog.load_state_dict(sd)
    ref.load_state_dict(sd)
    prog.train(train)
    ref.train(train)
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(3)) - 0.45
    with torch.set_grad_enabled(train):
        a, b = prog(x), ref(x)
    assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    if train:
        buf_p, buf_r = dict(prog.named_buffers()), dict(ref.named_buffers())
        for k in buf_r:
            if k.endswith("running_var"):
                assert torch.allclose(buf_p[k], buf_r[k], rtol=1e-4, atol=1e-6), k


def test_crops_match_the_port():
    from simple_pose_torch.ops.rotate_resample import affine_crop_two_stage_reference
    from simple_pose_torch.ops.warp import affine_crop

    g = torch.Generator().manual_seed(0)
    canvas = torch.randint(0, 256, (3, 96, 96, 3), generator=g, dtype=torch.uint8)
    trans = torch.tensor([[[0.8, 0.2, -3.0], [-0.2, 0.8, 5.0]],
                          [[1.3, 0.0, -20.0], [0.0, 1.3, -10.0]],
                          [[0.5, -0.5, 30.0], [0.5, 0.5, -10.0]]])
    # the reference inverts the affine in float64, the port in float32
    exact = affine_crop(canvas, trans, (64, 48))
    assert (R.crop(canvas, trans, (64, 48)) - exact).abs().max() < 1e-2
    # the port rounds stage 1's operands and product to bf16: a level or two
    two = R.crop_two_stage(canvas, trans, (64, 48))
    port = affine_crop_two_stage_reference(canvas, trans, (64, 48), inter=int(np.ceil(
        np.hypot(64, 48))) + 8)
    assert (two - port).abs().max() < 2.5 and (two - port).abs().mean() < 0.5


def test_decode_and_targets_match_the_port():
    from simple_pose_torch.ops.decode import decode_gauss_taylor
    from simple_pose_torch.ops.heatmap import encode_unbiased

    g = torch.Generator().manual_seed(1)
    ys, xs = torch.meshgrid(torch.arange(16.0), torch.arange(12.0), indexing="ij")
    centres = torch.rand((4, 17, 2), generator=g) * torch.tensor([11.0, 15.0])
    heat = torch.exp(-((xs - centres[..., 0, None, None]) ** 2
                       + (ys - centres[..., 1, None, None]) ** 2) / 8)
    heat = heat + 0.01 * torch.rand(heat.shape, generator=g)
    coords, peak, _ = R.decode(heat)
    kps, conf = decode_gauss_taylor(heat, torch.eye(2, 3).expand(4, 2, 3))
    assert torch.allclose(coords, kps, atol=1e-4) and torch.equal(peak, conf[..., 0])
    joints = torch.cat([centres, (torch.rand((4, 17, 1), generator=g) > 0.3).float()], -1)
    joints[0, 0, 0] = 40.0  # wholly outside the map
    t, w = R.targets(joints, (16, 12))
    tp, wp = encode_unbiased(joints, (16, 12))
    assert torch.equal(w, wp) and (t - tp).abs().max() < 1e-6


@pytest.mark.parametrize("workload", ["resnet50_dconv_se.serve_b128",
                                      "resnet50_dconv_se.train_b128", "hrnet_w32.train_b128"])
def test_sound_float32_runs_come_out_correct(workload):
    from portbench.run import run_cell

    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    # batch 8: at 4 crops a BatchNorm's statistics, and with them the
    # gradients, move far with the program crop's bf16 intermediate
    out, rows, _ = run_cell(small_cell(workload, batch=8), args(seconds=0.0), device="cpu")
    assert out["correct"], rows
