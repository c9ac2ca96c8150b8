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


# ------------------------------------------------------ export_fused
# JAX's tests/test_export.py::test_export_fused_program, on shared seeded
# weights: ResNet-18, YOLOv5-s, det 256, 64x64 crops, 4 people, canvas 256
FUSED_KW = dict(scale_name="s", det_size=(256, 256), input_shape=(64, 64), max_people=4,
                det_conf=0.001, canvas=256, amp=False)
FUSED_R18 = {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17}
FUSED_SHAPES = [(200, 256), (256, 256)]


@pytest.fixture(scope="module")
def fused_weights(tmp_path_factory):
    """A YOLOv5-s 80-class checkpoint (the head's objectness prior) and a
    ResNet-18 pose checkpoint in the reference's layout, from numpy-seeded
    flax variables (as tests/test_torch_fused.py makes them)."""
    from simple_pose_torch.convert.from_jax import (
        detector_flax_to_torch_state,
        flax_to_torch_state,
    )
    from simple_pose_torch.detector.yolov5 import YOLOv5
    from simple_pose_tpu.detector.yolov5 import YOLOv5 as JYOLOv5
    from simple_pose_tpu.models.registry import build_from_cfg
    from tests.torch_jax_vars import seeded_variables

    d = tmp_path_factory.mktemp("fused_w")
    rng = np.random.default_rng(11)
    det_vars = seeded_variables(JYOLOv5(num_cls=80, scale_name="s"),
                                np.zeros((1, 256, 256, 3), np.float32), rng)
    for i, stride in enumerate((8, 16, 32)):
        b = np.zeros((3, 85), np.float32)
        b[:, 4] = np.log(8.0 / (640.0 / stride) ** 2)
        det_vars["params"]["head"][f"heads_{i}"]["bias"] = b.reshape(-1)
    det_path = str(d / "yolov5s.pth")
    torch.save({"ema": detector_flax_to_torch_state(det_vars, YOLOv5(80, "s"))}, det_path)
    pose_vars = seeded_variables(build_from_cfg(FUSED_R18), np.zeros((1, 64, 64, 3), np.float32),
                                 rng)
    pose_path = str(d / "r18.pth")
    torch.save({"ema": flax_to_torch_state(pose_vars)}, pose_path)
    return det_path, pose_path


def _fused_inputs():
    """JAX's test inputs: noise canvases of two image sizes."""
    rng = np.random.default_rng(7)
    return rng.integers(0, 255, size=(2, 256, 256, 3), dtype=np.uint8), FUSED_SHAPES


def _fused_args(fused):
    canvases, shapes = _fused_inputs()
    return (torch.from_numpy(canvases), *(torch.from_numpy(a) for a in fused.host_prep(shapes)))


@pytest.fixture(scope="module")
def fused_export(fused_weights, tmp_path_factory):
    """The port's FusedDetectPose, its live output, and the output of its
    export_fused program saved to a file and loaded back."""
    from simple_pose_torch.evalkit.export import export_fused
    from simple_pose_torch.evalkit.fused import FusedDetectPose

    det_path, pose_path = fused_weights
    fused = FusedDetectPose(FUSED_R18, pose_path, det_path, device="cpu", **FUSED_KW)
    live = fused(*_fused_inputs())
    path = str(tmp_path_factory.mktemp("fused") / "fused.pt2")
    exported = export_fused(fused, 2, 256)
    assert save_exported(exported, path) == os.path.getsize(path)
    out = serving_fn(path, device="cpu")(*_fused_args(fused))
    return fused, live, exported, {k: v.numpy() for k, v in out.items()}


def test_export_fused_equals_live(fused_export):
    """The exported fused program (through a file) equals the live
    FusedDetectPose exactly: the same module traced, the NMS's while_loop
    a node of the graph and no host read in it."""
    _, live, exported, out = fused_export
    assert set(out) == set(live) == {"boxes", "det_scores", "det_valid", "kps", "kp_conf",
                                     "pose_scores"}
    for k in live:
        assert out[k].dtype == live[k].dtype and out[k].shape == live[k].shape, k
        np.testing.assert_array_equal(out[k], live[k], err_msg=k)
    assert live["det_valid"].all()
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert sum("while_loop" in t for t in targets) == 1
    assert not set(_targets(exported)) & {"aten._local_scalar_dense.default", "aten.equal.default",
                               "aten.item.default"}


def test_export_fused_matches_jax_where_clear(fused_weights, fused_export):
    """The port's exported program against JAX's live FusedDetectPose on the
    same weights and inputs, under tests/test_torch_fused.py's pairing rule:
    each JAX detection whose score clears every other candidate's by more
    than 4x the measured pred difference is found with that score, its box
    within 1e-2 px and its keypoint confidences within 1e-4 relative."""
    import jax.numpy as jnp

    from simple_pose_tpu.detector import wrapper as jwrap
    from simple_pose_tpu.evalkit import fused as jfused
    from tests.torch_jax_vars import abstract_flax_init, is_clear

    fused, _, _, out = fused_export
    det_path, pose_path = fused_weights
    with abstract_flax_init():
        jf = jfused.FusedDetectPose(FUSED_R18, pose_path, det_path, **FUSED_KW)
    canvases, shapes = _fused_inputs()
    jout = jf(canvases, shapes)
    geom = jf.host_prep(shapes)
    jx = jwrap._letterbox_input(jnp.asarray(canvases), *(jnp.asarray(a) for a in geom[:2]),
                                256, 256, jnp.float32)
    jpred = np.asarray(jf.detector.model.apply(jf.detector.variables, jx))
    args = fused.prepare(canvases, shapes)
    with torch.no_grad():
        tpred = fused.detector.model(fused.letterbox(*args[:3], 256, 256)).numpy()
    tol = 4 * np.abs(tpred[..., 4:] - jpred[..., 4:]).max()
    assert set(out) == set(jout)
    np.testing.assert_array_equal(out["det_valid"], np.asarray(jout["det_valid"]))
    compared = 0
    for b in range(2):
        for p in range(4):
            s = jout["det_scores"][b, p]
            if not is_clear(jpred[b], s, tol):
                continue
            q = int(np.argmin(np.abs(out["det_scores"][b] - s)))
            assert abs(out["det_scores"][b, q] - s) <= tol, (b, p)
            np.testing.assert_allclose(out["boxes"][b, q], jout["boxes"][b, p], atol=1e-2)
            np.testing.assert_allclose(out["kp_conf"][b, q], jout["kp_conf"][b, p],
                                       rtol=1e-4, atol=1e-7)
            compared += 1
    assert compared >= 4, compared  # 8 of 8 measured


def test_export_fused_w8a8_round_trip(fused_weights, tmp_path):
    """A calibrated w8a8 fused program through a file equals the live one;
    its graph holds one registered int8 product per quantized conv of both
    networks."""
    from simple_pose_torch.evalkit.export import export_fused
    from simple_pose_torch.evalkit.fused import FusedDetectPose

    det_path, pose_path = fused_weights
    fused = FusedDetectPose(FUSED_R18, pose_path, det_path, device="cpu", quant="w8a8",
                            **FUSED_KW)
    fused.calibrate(iter([_fused_inputs()]), 1)
    live = fused(*_fused_inputs())
    exported = export_fused(fused, 2, 256)
    n_convs = len(quantized_convs(fused.detector.model)) + len(quantized_convs(fused.pose_model))
    assert _targets(exported).count("simple_pose.int8_conv.default") == n_convs
    path = str(tmp_path / "fq.pt2")
    save_exported(exported, path)
    out = serving_fn(path, device="cpu")(*_fused_args(fused))
    for k in live:
        np.testing.assert_array_equal(out[k].numpy(), live[k], err_msg=k)


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
    png = str(tmp_path / "overlay.png")
    code = ("import json, sys\n"
            "from simple_pose_torch.serve_artifact import serve\n"
            f"print(json.dumps(serve({out!r}, {JPEG!r}, {boxes!r}, 'cpu', {png!r}, 0.0)))\n"
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
    # --out: the image's size; the last box's corner in its colour ((255, 0,
    # 0) drawn in BGR), and each person's joints (all drawn at kp_thresh 0)
    # in their colours within a circle's radius of where they are
    from simple_pose_torch.utils.viz import JOINT_COLORS, read_png

    overlay = read_png(png)
    assert overlay.shape == (480, 640, 3)
    x1, y1 = (int(v) for v in boxes[-1][:2])
    assert tuple(overlay[y1, x1]) == (0, 0, 255)
    for person in people["people"]:
        kp = np.reshape(person["keypoints"], (17, 3))
        found = 0
        for j, (x, y, _) in enumerate(kp):
            patch = overlay[max(int(y) - 2, 0):int(y) + 3, max(int(x) - 2, 0):int(x) + 3]
            found += bool((patch == JOINT_COLORS[j][::-1]).all(-1).any())
        assert found >= 8, found


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


@pytest.fixture(scope="module")
def port_fused_weights(tmp_path_factory):
    """Seeded YOLOv5-s (80 classes) and ResNet-18 checkpoints made by the
    port alone (the card's machine has no JAX)."""
    from simple_pose_torch.detector.yolov5 import YOLOv5

    d = tmp_path_factory.mktemp("port_w")
    torch.manual_seed(0)
    det_path, pose_path = str(d / "yolov5s.pth"), str(d / "r18.pth")
    torch.save({"ema": YOLOv5(80, "s").state_dict()}, det_path)
    torch.save({"ema": build_model(FUSED_R18["type"], "resnet18", seed=3).state_dict()},
               pose_path)
    return det_path, pose_path


@pytest.mark.cuda
@pytest.mark.parametrize("decoder", ["basic", "gauss_taylor"])
def test_cpu_traced_fused_artifact_runs_on_the_card(port_fused_weights, decoder, tmp_path):
    """An f32 fused program traced on the CPU and moved to the card
    (load_exported(device='cuda')) runs there: the constants made during
    the trace (the NMS limit, gauss_taylor's kernel) move with it.  Against
    the live program on the card, cuDNN deterministic: det_valid equal,
    boxes within 1e-3 px; decoder='basic' keypoints within 1e-3 px
    (gauss_taylor's Newton step on a seeded net's near-singular maps is not
    held, only finite)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from simple_pose_torch.evalkit.export import export_fused
    from simple_pose_torch.evalkit.fused import FusedDetectPose

    det_path, pose_path = port_fused_weights
    kw = {**FUSED_KW, "decoder": decoder}
    path = str(tmp_path / "f.pt2")
    save_exported(export_fused(FusedDetectPose(FUSED_R18, pose_path, det_path, device="cpu",
                                               **kw), 2, 256), path)
    card = FusedDetectPose(FUSED_R18, pose_path, det_path, **kw)
    fn = serving_fn(path, device="cuda")
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        got = {k: v.cpu().numpy() for k, v in fn(*(a.cuda() for a in _fused_args(card))).items()}
        live = card(*_fused_inputs())
    np.testing.assert_array_equal(got["det_valid"], live["det_valid"])
    np.testing.assert_allclose(got["boxes"], live["boxes"], rtol=0, atol=1e-3)
    assert np.isfinite(got["kps"]).all()
    if decoder == "basic":
        np.testing.assert_allclose(got["kps"], live["kps"], rtol=0, atol=1e-3)
