"""W8A8 quantization in the port (simple_pose_torch/models/quant.py) against
the JAX package's (simple_pose_tpu/models/quant.py) on numpy-seeded inputs
and the same weights (convert/from_jax): one conv, the int8 product's two
routes, the scale keys of every family, scales files across the packages,
each family's quantized forward on shared static scales, and
PoseEvaluator(quant='w8a8') with calibrate."""

import json
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simple_pose_torch.convert.from_jax import detector_flax_to_torch_state, flax_to_torch_state
from simple_pose_torch.detector.wrapper import build_detector
from simple_pose_torch.evalkit.workflows import PoseEvaluator
from simple_pose_torch.models import quant as tq
from simple_pose_torch.models.registry import build_model
from simple_pose_torch.ops import int8_conv as i8
from simple_pose_torch.ops.decode import decode_basic
from simple_pose_tpu.detector.yolov4 import YOLOv4 as JYOLOv4
from simple_pose_tpu.detector.yolov5 import YOLOv5 as JYOLOv5
from simple_pose_tpu.evalkit import workflows as jwf
from simple_pose_tpu.models.hrnet import PoseHRNet as FlaxPoseHRNet
from simple_pose_tpu.models import quant as jq
from simple_pose_tpu.models.registry import build_model as jax_build_model
from tests.test_torch_hrnet import NARROW_CFG
from tests.torch_jax_vars import seeded_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one conv against the JAX interceptor: JAX's own bound on its formula
# (tests/test_quant.py::test_w8a8_conv_matches_formula)
CONV_RTOL, CONV_ATOL = 1e-5, 1e-6


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


# --------------------------------------------------------------- one conv
# (name, x NHWC shape, out channels, kernel, stride, padding, dilation, groups, bias)
CONVS = {
    "3x3": ((2, 9, 9, 4), 6, 3, 1, 1, 1, 1, False),
    "3x3_stride2_bias": ((2, 9, 9, 4), 6, 3, 2, 1, 1, 1, True),
    "groups2": ((2, 8, 8, 4), 6, 3, 1, 1, 1, 2, False),
    "depthwise": ((2, 8, 8, 6), 6, 3, 1, 1, 1, 6, False),
    "dilation2": ((2, 11, 11, 4), 5, 3, 1, 2, 2, 1, False),
    "stem_7x7": ((2, 24, 20, 3), 64, 7, 2, 3, 1, 1, False),
    "1x1": ((2, 6, 5, 32), 17, 1, 1, 0, 1, 1, True),
    "se_fc": ((3, 1, 1, 24), 24, 1, 1, 0, 1, 1, True),
}


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_w8a8_conv_matches_jax(name, static):
    """The port's quantized conv equals JAX's ``quantized('w8a8')`` nn.Conv
    within rtol 1e-5, atol 1e-6, with a dynamic and a static s_x."""
    shape, cout, k, s, p, d, g, bias = CONVS[name]
    rng = np.random.default_rng(sorted(CONVS).index(name))
    x = rng.normal(0, 1, shape).astype(np.float32)
    conv = fnn.Conv(cout, (k, k), strides=(s, s), padding=[(p, p), (p, p)],
                    kernel_dilation=(d, d), feature_group_count=g, use_bias=bias)
    v = jax.tree.map(np.asarray, conv.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    if bias:
        v["params"]["bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
    s_x = float(np.abs(x).max() / 127.0 * 0.8) if static else None  # a clipping static scale
    with jq.quantized("w8a8", {"": s_x} if static else None):
        want = np.asarray(conv.apply(v, jnp.asarray(x))).transpose(0, 3, 1, 2)
    tconv = torch.nn.Conv2d(shape[-1], cout, k, s, p, d, g, bias)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(np.array(v["params"]["kernel"])).permute(3, 2, 0, 1))
        if bias:
            tconv.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        got = tq.w8a8_conv2d(tconv, _nchw(x), *tq.quantize_weight(tconv.weight), s_x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=CONV_RTOL, atol=CONV_ATOL)


def test_w8a8_output_follows_autocast():
    """Under the models' bf16 autocast the quantized conv returns bf16, as
    the float conv would; the f32 stem input is quantized as it arrives."""
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    w8, s_w = tq.quantize_weight(conv.weight)
    with torch.no_grad():
        plain = tq.w8a8_conv2d(conv, x, w8, s_w)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert conv(x).dtype == torch.bfloat16
            amp = tq.w8a8_conv2d(conv, x, w8, s_w)
    assert amp.dtype == torch.bfloat16
    torch.testing.assert_close(amp, plain.to(torch.bfloat16), rtol=0, atol=0)


# ----------------------------------------------------- the int8 product
# (x NCHW shape, out channels, kernel, stride, padding, dilation, groups):
# m <= 16, k and n not multiples of 8, strides, groups, depthwise, dilation
ROUTE_SHAPES = [
    ((2, 3, 23, 17), 64, 7, 2, 3, 1, 1),    # the stem: k = 147
    ((1, 64, 4, 4), 17, 1, 1, 0, 1, 1),     # m = 16, n = 17
    ((1, 40, 1, 1), 40, 1, 1, 0, 1, 1),     # an SE fc at batch 1: m = 1
    ((3, 13, 9, 7), 21, 3, 2, 1, 1, 1),     # k = 117, n = 21
    ((2, 8, 9, 9), 6, 3, 1, 1, 1, 2),       # groups 2: k = 36, n = 3 per group
    ((2, 12, 9, 9), 12, 3, 2, 1, 1, 12),    # depthwise
    ((2, 8, 11, 11), 8, 3, 1, 2, 2, 1),     # dilation 2
    ((2, 16, 8, 6), 32, 1, 2, 0, 1, 1),     # a strided projection
]


@pytest.mark.parametrize("shape,cout,k,s,p,d,g", ROUTE_SHAPES)
def test_card_route_equals_plain_version(shape, cout, k, s, p, d, g):
    """The card's route (patches, zero padding, torch._int_mm, which runs
    on the CPU too) gives exactly the float64 plain version's int32."""
    rng = np.random.default_rng(k * 100 + cout)
    x8 = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    w8 = torch.from_numpy(rng.integers(-127, 128, (cout, shape[1] // g, k, k)).astype(np.int8))
    args = ((s, s), (p, p), (d, d), g)
    got = i8._int8_conv_cuda(x8, w8, *args)
    want = i8.int8_conv_reference(x8, w8, *args)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)


def test_int8_conv_routes_by_device():
    """The registered op picks its route when it runs: CPU tensors take the
    plain version, which does not count; the trace (meta) gets the fake's
    int32 channels-last shape, and does not count either."""
    x8 = torch.ones(1, 8, 4, 4, dtype=torch.int8)
    w8 = torch.ones(8, 8, 1, 1, dtype=torch.int8)
    before = tq.int8_conv.launches
    y = tq.int8_conv(x8, w8)
    assert torch.equal(y, torch.full((1, 8, 4, 4), 8, dtype=torch.int32))
    assert y.is_contiguous(memory_format=torch.channels_last)
    fake = tq.int8_conv(x8.to("meta"), torch.ones(6, 4, 3, 3, dtype=torch.int8, device="meta"),
                        (2, 2), (1, 1), (1, 1), 2)
    assert fake.shape == (1, 6, 2, 2) and fake.dtype == torch.int32
    assert tq.int8_conv.launches == before


def test_int8_conv2d_wraps_and_the_port_does_not_use_it(monkeypatch):
    """F.conv2d on int8 tensors returns int8: the sum wraps.  The port's
    quantized forward never calls it on int8 (it runs a whole model here)."""
    x = torch.full((1, 4, 1, 1), 100, dtype=torch.int8)
    y = F.conv2d(x, x.view(1, 4, 1, 1))
    assert y.dtype == torch.int8 and int(y) != 40000
    assert int(tq.int8_conv(x, x.view(1, 4, 1, 1))) == 40000

    orig = F.conv2d

    def checked(inp, *args, **kwargs):
        assert inp.dtype not in (torch.int8, torch.int32), inp.dtype
        return orig(inp, *args, **kwargs)

    monkeypatch.setattr(F, "conv2d", checked)
    model = build_model("pose_resnet_dconv", "resnet18", reduction=True)
    x = torch.randn(1, 3, 64, 48, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), tq.quantized(model, "w8a8"):
        assert torch.isfinite(model(x)).all()


def test_quantized_rejects_unknown_mode():
    model = build_model("pose_resnet_dconv", "resnet18")
    with pytest.raises(ValueError, match="w8a8"):
        tq.quantized(model, "int4")
    with tq.quantized(model, None):
        pass


# ------------------------------------------------------------ the families
def _pose(name):
    if name == "hrnet":
        return FlaxPoseHRNet(cfg=NARROW_CFG), build_model("pose_hrnet", NARROW_CFG)
    kind, arch = {"dconv_se": ("pose_resnet_dconv", "resnet50"),
                  "duc": ("pose_resnet_duc", "resnet18")}[name]
    se = name == "dconv_se"
    return (jax_build_model(kind, arch, reduction=se),
            build_model(kind, arch, reduction=se))


def _detector(family):
    j = {"yolov5": JYOLOv5, "yolov4": JYOLOv4}[family](num_cls=1, scale_name="s")
    return j, build_detector(family, 1, "s")


FAMILIES = {"dconv_se": _pose, "duc": _pose, "hrnet": _pose,
            "yolov5": _detector, "yolov4": _detector}
# input NHWC per family: pose 64x48 crops (HRNet's narrow topology too),
# detectors a 128^2 letterbox
INPUTS = {"dconv_se": (2, 64, 48, 3), "duc": (2, 64, 48, 3), "hrnet": (2, 64, 48, 3),
          "yolov5": (1, 128, 128, 3), "yolov4": (1, 128, 128, 3)}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, flax module, its seeded variables, the port's model on the
    same weights, input NHWC, JAX's calibrated scales on it)."""
    name = request.param
    jm, tm = FAMILIES[name](name)
    rng = np.random.default_rng(sorted(FAMILIES).index(name))
    x = rng.uniform(-1, 1, INPUTS[name]).astype(np.float32)
    v = seeded_variables(jm, x, rng)
    convert = flax_to_torch_state if name in ("dconv_se", "duc", "hrnet") else \
        lambda vv: detector_flax_to_torch_state(vv, tm)
    tm.load_state_dict(convert(v))
    scales = jq.calibrate_w8a8(lambda a: jm.apply(v, a), [jnp.asarray(x)])
    return name, jm, v, tm.eval(), x, scales


def test_scale_keys_match_jax(family):
    """JAX's recorder keys map one to one onto the port's quantized convs."""
    _, _, _, tm, _, scales = family
    convs = tq.quantized_convs(tm)
    assert set(convs) == set(scales)
    assert len(convs) == sum(type(m) is torch.nn.Conv2d for m in tm.modules())
    assert not any(isinstance(m, torch.nn.ConvTranspose2d) for m in convs.values())


def test_port_calibration_matches_jax(family, tmp_path):
    """Scales files both ways: the port records the same maxima as JAX on
    the same float forward (rtol 1e-5: f32 sum order through the net); a
    JAX-written file loads in the port and a port-written one in JAX."""
    _, _, _, tm, x, scales = family
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    jq.save_scales(scales, jpath)
    assert tq.load_scales(jpath) == scales
    with torch.no_grad():
        ours = tq.calibrate_w8a8(tm, tm, [_nchw(x)])
    tq.save_scales(ours, tpath)
    back = jq.load_scales(tpath)
    assert set(back) == set(scales)
    for k in scales:
        np.testing.assert_allclose(back[k], scales[k], rtol=1e-5, err_msg=k)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _untied(heat, err):
    """[N, J] bool: the maps whose decode_basic keypoint no per-pixel change
    of at most ``err`` can move: the peak clear of the runner-up and (where
    decode_basic shifts) both neighbour differences clear of zero, by more
    than 2 * err."""
    n, j, h, w = heat.shape
    flat = heat.reshape(n, j, h * w)
    top2 = np.sort(flat, -1)[..., -2:]
    idx = flat.argmax(-1)
    y, x = idx // w, idx % w
    xc, yc = np.clip(x, 1, w - 2), np.clip(y, 1, h - 2)
    taps = np.stack([yc * w + xc + 1, yc * w + xc - 1, (yc + 1) * w + xc, (yc - 1) * w + xc], -1)
    v = np.take_along_axis(flat, taps, -1)
    shifts = (x > 1) & (x < w - 1) & (y > 1) & (y < h - 1)
    margin = np.minimum(np.abs(v[..., 0] - v[..., 1]), np.abs(v[..., 2] - v[..., 3]))
    return (top2[..., 1] - top2[..., 0] > 2 * err) & (~shifts | (margin > 2 * err))


# quantized forward on shared static scales, port vs JAX, relative to
# max|JAX|.  The conv inputs agree to ~2e-7 (f32 sum order) until the first
# x8 that rounds the other way on such a difference (ResNet-50+SE: 2e-5 of
# layer2_3/conv1's elements); that moves its conv's output by s_x * s_w *
# |w8|, and each later conv re-quantizes the moved activations, so the
# flips spread (the seeded nets amplify them).  Measured here: max 2.4e-2
# and mean 3.1e-3 (ResNet-50-DUC / ResNet-50+SE), 8.2e-3 / 1.2e-4 for the
# detectors, 6.7e-8 for the narrow HRNet (no flip).
SHARED_SCALES_REL, SHARED_SCALES_MEAN_REL = 5e-2, 1e-2
# the unquantized forward on the same weights agrees far closer
FLOAT_REL = 1e-4


def test_quantized_models_match_jax_on_shared_scales(family):
    """Each family quantized on JAX's calibrated scales, loaded into both:
    heatmaps (pose) or preds (detectors) within SHARED_SCALES_REL (max)
    and SHARED_SCALES_MEAN_REL (mean) of JAX's; for pose, decode_basic's
    keypoints equal on every map that no error of the measured size can
    move (_untied; over a fifth of them)."""
    name, jm, v, tm, x, scales = family
    with jq.quantized("w8a8", scales):
        want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad(), tq.quantized(tm, "w8a8", scales):
        got = tm(_nchw(x)).numpy()
    if name.startswith("yolo"):  # pred [B, N, 6]: boxes and scores apart
        rel = max(_rel(got[..., :4], want[..., :4]), _rel(got[..., 4:], want[..., 4:]))
    else:
        want = want.transpose(0, 3, 1, 2)
        rel = _rel(got, want)
        keep = _untied(want, np.abs(got - want).max())
        assert keep.mean() > 0.2, keep.mean()
        eye = torch.eye(2, 3).expand(want.shape[0], 2, 3)
        kg, _ = decode_basic(torch.from_numpy(got), eye)
        kw, _ = decode_basic(torch.from_numpy(np.ascontiguousarray(want)), eye)
        np.testing.assert_array_equal(kg.numpy()[keep], kw.numpy()[keep])
    mean_rel = float(np.abs(got - want).mean() / np.abs(want).max())
    assert rel < SHARED_SCALES_REL, rel
    assert mean_rel < SHARED_SCALES_MEAN_REL, mean_rel
    with torch.no_grad():
        fgot = tm(_nchw(x)).numpy()
    fwant = np.asarray(jm.apply(v, jnp.asarray(x)))
    if fwant.ndim == 4:
        fwant = fwant.transpose(0, 3, 1, 2)
    assert _rel(fgot, fwant) < FLOAT_REL


# --------------------------------------------------------- the evaluator
R50SE = {"type": "pose_resnet_dconv", "name": "resnet50", "num_joints": 17, "reduction": True}


def _batch(rng, b=4, canvas=96, out=64):
    s = canvas / out
    return {
        "canvas": rng.integers(0, 255, (b, canvas, canvas, 3), dtype=np.uint8),
        "trans": np.tile(np.array([[1 / s, 0, 2], [0, 1 / s, 2]], np.float32), (b, 1, 1)),
        "trans_inv": np.tile(np.array([[4 * s, 0, 0], [0, 4 * s, 0]], np.float32), (b, 1, 1)),
    }


@pytest.fixture(scope="module")
def evaluators():
    """JAX's and the port's PoseEvaluator(quant='w8a8', flip-test) on one
    seeded ResNet-50+SE (unit-variance kernels: distinct peaks), f32; the
    'dark_original' decoder, whose device program ends at the heatmaps."""
    jm = jax_build_model("pose_resnet_dconv", "resnet50", reduction=True)
    v = seeded_variables(jm, np.zeros((1, 64, 64, 3), np.float32), np.random.default_rng(7))
    kw = dict(input_shape=(64, 64), amp=False, quant="w8a8", flip_test=True,
              decoder="dark_original")
    jev = jwf.PoseEvaluator(R50SE, None, **kw)
    jev.variables = jax.tree.map(jnp.asarray, v)
    tev = PoseEvaluator(R50SE, flax_to_torch_state(v), device="cpu", **kw)
    return jev, tev


def _heat_pair(jev, tev, batch):
    dev = {k: batch[k] for k in ("canvas", "trans", "trans_inv")}
    want = np.asarray(jev._step(jev.variables, None, dev)["heat"])
    return tev.heatmaps(batch).numpy(), want


def _assert_heat_close(got, want):
    """The bounds of test_quantized_models_match_jax_on_shared_scales."""
    assert _rel(got, want) < SHARED_SCALES_REL, _rel(got, want)
    assert np.abs(got - want).mean() / np.abs(want).max() < SHARED_SCALES_MEAN_REL


def test_evaluator_quant_matches_jax(evaluators):
    """Dynamic scales, then calibrate on two batches (flip-test records the
    flipped forward too): the same scales as JAX's calibrate (rtol 1e-5),
    and both times the flip-tested heatmaps within the shared-scales
    bounds of JAX's."""
    jev, tev = evaluators
    rng = np.random.default_rng(3)
    batches = [_batch(rng) for _ in range(3)]
    _assert_heat_close(*_heat_pair(jev, tev, batches[0]))
    jscales = jev.calibrate(iter(batches[:2]), 2)
    tscales = tev.calibrate(iter(batches), 2)
    assert set(tscales) == set(jscales) and tev.quant_scales is tscales
    for k in jscales:
        np.testing.assert_allclose(tscales[k], jscales[k], rtol=1e-5, err_msg=k)
    _assert_heat_close(*_heat_pair(jev, tev, batches[2]))
    out = tev(batches[2])
    assert out["kps"].shape == (4, 17, 2) and np.isfinite(out["kps"].numpy()).all()


def test_calibrate_needs_a_quant_mode_and_batches():
    ev = PoseEvaluator({"type": "pose_resnet_dconv", "name": "resnet18"}, None, (48, 64),
                       device="cpu")
    with pytest.raises(ValueError, match="quant mode"):
        ev.calibrate(iter([]), 1)
    with pytest.raises(ValueError, match="quant"):
        PoseEvaluator({"type": "pose_resnet_dconv", "name": "resnet18"}, None, (48, 64),
                      device="cpu", quant="int4")
    qev = PoseEvaluator({"type": "pose_resnet_dconv", "name": "resnet18"}, None, (48, 64),
                        device="cpu", quant="w8a8")
    with pytest.raises(ValueError, match="empty"):
        qev.calibrate(iter([]), 1)


def test_fused_layer1_stays_in_the_compute_dtype():
    """quant='w8a8' with fused_layer1: layer1 runs the chain (its convs
    never see the quantized forward), every other conv is quantized."""
    ev = PoseEvaluator(R50SE, None, (48, 64), device="cpu", quant="w8a8", fused_layer1=True)
    seen = []
    for key, conv in tq.quantized_convs(ev.model).items():
        conv.register_forward_pre_hook(lambda m, a, key=key: seen.append(key))
    ev(_batch(np.random.default_rng(0), b=2))
    layer1 = [k for k in tq.quantized_convs(ev.model) if k.startswith("layer1_")]
    assert len(layer1) == 12  # 3 blocks x 3, the projection, SE's 2 fcs
    assert set(seen) == set(tq.quantized_convs(ev.model)) - set(layer1)


def test_allreduce_scales_max_over_two_processes():
    """A no-op without a process group; MAX over two gloo ranks."""
    assert tq.allreduce_scales_max({"a": 1.0}) == {"a": 1.0}
    code = (
        "import os, sys, torch.distributed as dist\n"
        "from simple_pose_torch.models.quant import allreduce_scales_max\n"
        "r = int(sys.argv[1])\n"
        "dist.init_process_group('gloo', init_method='tcp://localhost:' + sys.argv[2],"
        " rank=r, world_size=2)\n"
        "out = allreduce_scales_max({'a': 1.0 + r, 'b': 5.0 - r})\n"
        "print(out['a'], out['b'])\n"
        "dist.destroy_process_group()\n")
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["2.0", "5.0"]


def test_scales_file_format_is_jax_s(tmp_path):
    """save_scales writes flat JSON {flax path: float}, as JAX's does."""
    path = tmp_path / "s.json"
    tq.save_scales({"layer1_0/conv1": np.float32(0.5)}, str(path))
    assert json.loads(path.read_text()) == {"layer1_0/conv1": 0.5}
