"""The port's serving export (simple_pose_torch/evalkit/export.py, ``eval
export``, simple_pose_torch/serve_artifact.py) against the live
PoseEvaluator it was exported from, on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simple_pose_torch.data.native import NativeCanvasLoader, native_available
from simple_pose_torch.evalkit.export import (
    export_evaluator,
    load_exported,
    save_exported,
    serving_fn,
)
from simple_pose_torch.evalkit.workflows import PoseEvaluator
from simple_pose_torch.models.quant import quantized_convs, save_scales
from simple_pose_torch.models.registry import build_model
from simple_pose_torch.ops.bottleneck_chain import bottleneck_chain
from simple_pose_torch.ops.int8_conv import int8_conv

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG = os.path.join(REPO, "tests", "data_torch_jpeg", "det", "images", "000000000001.jpg")
R18 = {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17, "reduction": True}
R50 = {"type": "pose_resnet_dconv", "name": "resnet50", "num_joints": 17, "reduction": True}
INPUT = (48, 64)  # (w, h)
CANVAS = 96
# the exported graph runs the live evaluator's ops in its order: equal
EXACT = dict(rtol=0, atol=0)
# external weights: the same ops on functional_call's weights; 1e-5 leaves
# room for another summation order
EXTERNAL_ATOL = 1e-5


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    s = CANVAS / 64.0
    t = np.array([[1 / s, 0, 2], [0, 1 / s, 2]], np.float32) * rng.uniform(0.9, 1.1)
    return {
        "canvas": rng.integers(0, 255, (b, CANVAS, CANVAS, 3), dtype=np.uint8),
        "trans": np.tile(t, (b, 1, 1)).astype(np.float32),
        "trans_inv": np.tile(np.array([[4 * s, 0, 0], [0, 4 * s, 0]], np.float32), (b, 1, 1)),
    }


def _args(batch):
    return tuple(torch.from_numpy(batch[k]) for k in ("canvas", "trans", "trans_inv"))


def _assert_same(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **(tol or EXACT))


@pytest.fixture(scope="module")
def evaluator():
    return PoseEvaluator(R18, None, INPUT, device="cpu", flip_test=True)


@pytest.mark.parametrize("batch_size", [3, "b"], ids=["static", "polymorphic"])
def test_export_equals_live(evaluator, batch_size, tmp_path):
    """Static and torch.export.Dim batches: the loaded program gives the
    live evaluator's outputs; a polymorphic one at two batch sizes."""
    exported = export_evaluator(evaluator, batch_size, (CANVAS, CANVAS))
    path = str(tmp_path / "p.pt2")
    assert save_exported(exported, path) == os.path.getsize(path) > 0
    fn = serving_fn(path)
    for b in ([3] if batch_size == 3 else [3, 5]):
        batch = _batch(b, seed=b)
        _assert_same(fn(*_args(batch)), evaluator(batch))


def test_external_weights(evaluator):
    """bake_weights=False: the state dict is the leading input, so one
    program serves another checkpoint of the topology."""
    exported = export_evaluator(evaluator, 2, (CANVAS, CANVAS), bake_weights=False)
    other = dict(build_model(R18["type"], "resnet18", reduction=True, seed=3).state_dict())
    batch = _batch(2)
    got = load_exported(exported_bytes(exported)).module()(other, *_args(batch))
    live = PoseEvaluator(R18, other, INPUT, device="cpu", flip_test=True)(batch)
    _assert_same(got, live, rtol=0, atol=EXTERNAL_ATOL)
    own = exported.module()(dict(evaluator.model.state_dict()), *_args(batch))
    _assert_same(own, evaluator(batch), rtol=0, atol=EXTERNAL_ATOL)


def exported_bytes(exported):
    import io

    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def test_dark_original_exports_heatmaps():
    ev = PoseEvaluator(R18, None, INPUT, device="cpu", decoder="dark_original")
    batch = _batch(2)
    out = export_evaluator(ev, 2, (CANVAS, CANVAS)).module()(*_args(batch))
    assert set(out) == {"heat"}
    torch.testing.assert_close(out["heat"], ev.heatmaps(batch), **EXACT)


def test_fused_layer1_refuses_external_weights_and_exports_k2(tmp_path):
    """fused_layer1 bakes the folded layer1, so external weights are refused
    (JAX export.py:85-90); baked, the graph holds K2 as its registered op
    and the loaded program equals the live evaluator."""
    ev = PoseEvaluator(R50, None, INPUT, device="cpu", fused_layer1=True)
    with pytest.raises(ValueError, match="fused_layer1"):
        export_evaluator(ev, 2, (CANVAS, CANVAS), bake_weights=False)
    exported = export_evaluator(ev, 2, (CANVAS, CANVAS))
    assert "simple_pose.bottleneck_chain.default" in _targets(exported)
    batch = _batch(2)
    _assert_same(serving_fn(exported_bytes(exported))(*_args(batch)), ev(batch))


def _targets(exported):
    return [str(n.target) for m in exported.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes]


def test_quantized_export_round_trip(tmp_path):
    """A calibrated (static-scale) w8a8 evaluator through a file: equal to
    the live one.  The graph holds one registered int8 product per
    quantized conv in place of its float convolution (the CPU's plain
    version, a float64 convolution, is not baked in), so the route is
    chosen when the program runs, not fixed by the CPU trace."""
    ev = PoseEvaluator(R18, None, INPUT, device="cpu", quant="w8a8")
    ev.calibrate(iter([_batch(4, seed=9)]), 1)
    exported = export_evaluator(ev, 2, (CANVAS, CANVAS))
    targets = _targets(exported)
    assert targets.count("simple_pose.int8_conv.default") == len(quantized_convs(ev.model))
    convs = lambda ex: sum(t in ("aten.conv2d.default", "aten.convolution.default")  # noqa: E731
                           for t in _targets(ex))
    float_program = export_evaluator(PoseEvaluator(R18, None, INPUT, device="cpu"), 2,
                                     (CANVAS, CANVAS))
    assert convs(float_program) - convs(exported) == len(quantized_convs(ev.model))
    path = str(tmp_path / "q.pt2")
    save_exported(exported, path)
    batch = _batch(2, seed=4)
    _assert_same(serving_fn(path, device="cpu")(*_args(batch)), ev(batch))


# the JAX CLI's sidecar keys (eval.py:255-268)
SIDECAR_KEYS = {"out", "bytes", "platforms", "batch", "canvas", "input_shape", "model",
                "decoder", "flip_test", "quant", "static_scales", "amp", "weights",
                "external_weights"}


def test_eval_export_cli_and_serve_artifact(tmp_path):
    """``eval export --quant w8a8 --scales --fused-layer1`` writes the
    artifact and JAX's sidecar keys plus "custom_ops"; serve_artifact
    (a fresh process that imports no model code) decodes a fixture JPEG
    through the native loader and prints the live evaluator's people."""
    scales = str(tmp_path / "s.json")
    ev = PoseEvaluator(R50, None, INPUT, device="cpu", quant="w8a8")
    save_scales(ev.calibrate(iter([_batch(2, seed=5)]), 1), scales)
    out = str(tmp_path / "pose.pt2")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "simple_pose_torch.eval", "export", "--model-name", "resnet50",
         "--reduction", "--fused-layer1", "--quant", "w8a8", "--scales", scales,
         "--device", "cpu", "--batch-size", "2", "--canvas", "640", "--input-w", "48",
         "--input-h", "64", "--out", out],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr
    info = json.load(open(out + ".json"))
    assert set(info) == SIDECAR_KEYS | {"custom_ops"}
    assert info["custom_ops"] == ["simple_pose_torch.ops.bottleneck_chain",
                                  "simple_pose_torch.ops.int8_conv"]
    assert info["bytes"] == os.path.getsize(out) and info["static_scales"] and info["batch"] == 2
    if not native_available():
        pytest.skip("the native JPEG loader does not build here")
    boxes = [(10.0, 20.0, 200.0, 300.0), (50.0, 40.0, 150.0, 260.0)]
    code = ("import json, sys\n"
            "from simple_pose_torch.serve_artifact import serve\n"
            f"print(json.dumps(serve({out!r}, {JPEG!r}, {boxes!r}, 'cpu')))\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.startswith('simple_pose'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr
    people, modules = (json.loads(line) for line in proc.stdout.strip().splitlines()[-2:])
    assert not [m for m in modules if m.startswith(("simple_pose_torch.models",
                                                     "simple_pose_torch.evalkit.workflows",
                                                     "simple_pose_tpu"))], modules
    # the live evaluator on the same canvas and boxes
    live = PoseEvaluator(R50, None, INPUT, device="cpu", quant="w8a8", fused_layer1=True,
                         quant_scales=json.load(open(scales)))
    loader = NativeCanvasLoader(1)
    canvases, heights, widths = loader.load_batch([JPEG], 640)
    loader.close()
    from simple_pose_torch.serve_artifact import boxes_to_batch

    canvas, trans, trans_inv = boxes_to_batch(canvases[0], (int(heights[0]), int(widths[0])),
                                              boxes, info)
    want = live({"canvas": canvas, "trans": trans, "trans_inv": trans_inv})
    for i, person in enumerate(people["people"]):
        kp = np.reshape(person["keypoints"], (17, 3))
        np.testing.assert_allclose(kp[:, :2], want["kps"][i].numpy(), atol=0.006)
        assert abs(person["score"] - float(want["scores"][i])) < 1e-6


@pytest.mark.cuda
def test_loaded_program_launches_k2_on_the_card(tmp_path):
    """On the card: the loaded fused_layer1 artifact launches K2 (the
    registered op's CUDA path counts) and equals the live evaluator."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ev = PoseEvaluator(R50, None, INPUT, fused_layer1=True)
    path = str(tmp_path / "k2.pt2")
    save_exported(export_evaluator(ev, 4, (CANVAS, CANVAS)), path)
    fn = serving_fn(path, device="cuda")
    batch = _batch(4)
    bottleneck_chain.launches = 0
    got = fn(*(t.cuda() for t in _args(batch)))
    torch.cuda.synchronize()
    assert bottleneck_chain.launches == 1
    _assert_same(got, ev(batch))


@pytest.mark.cuda
def test_cpu_traced_quantized_artifact_runs_the_int8_route_on_the_card(tmp_path):
    """A w8a8 fused_layer1 artifact traced on the CPU and moved to the card
    (load_exported(device='cuda')) runs every quantized conv's product on
    the card's int8 route and K2 (both counters grow), and its heatmaps
    equal the live f32 evaluator's on the card on the same scales, to 1e-6
    of their max (the same ops on the card, cuDNN deterministic;
    dark_original, since gauss_taylor's kernel is a constant computed
    where the trace runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(quant="w8a8", fused_layer1=True, amp=False, decoder="dark_original")
    ev_cpu = PoseEvaluator(R50, None, INPUT, device="cpu", **kw)
    scales = ev_cpu.calibrate(iter([_batch(2, seed=5)]), 1)
    path = str(tmp_path / "q.pt2")
    save_exported(export_evaluator(ev_cpu, 4, (CANVAS, CANVAS)), path)
    fn = serving_fn(path, device="cuda")
    batch = _batch(4)
    live_ev = PoseEvaluator(R50, None, INPUT, quant_scales=scales, **kw)
    # cuDNN's default f32 deconv algorithm is not deterministic
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        int8_conv.launches = bottleneck_chain.launches = 0
        got = fn(*(t.cuda() for t in _args(batch)))
        torch.cuda.synchronize()
        n_layer1 = sum(type(m) is torch.nn.Conv2d for m in ev_cpu.model.layer1.modules())
        assert int8_conv.launches == len(quantized_convs(ev_cpu.model)) - n_layer1
        assert bottleneck_chain.launches == 1
        live = live_ev.heatmaps(batch).cpu()
    assert set(got) == {"heat"}
    torch.testing.assert_close(got["heat"].cpu(), live, rtol=0,
                               atol=1e-6 * live.abs().max().item())
