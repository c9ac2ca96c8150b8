"""The port's person detector (simple_pose_torch/detector: the blocks,
YOLOv5/YOLOv4, NMS and the letterbox front end; convert/from_jax.
detector_flax_to_torch_state) against the JAX package on the same
numpy-seeded inputs and the same weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple_pose_torch.convert.from_jax import detector_flax_to_torch_state
from simple_pose_torch.detector import blocks as tb
from simple_pose_torch.detector import nms as tnms
from simple_pose_torch.detector import wrapper as twrap
from simple_pose_torch.detector.nms import non_max_suppression
from simple_pose_torch.detector.yolov4 import YOLOv4
from simple_pose_torch.detector.yolov5 import YOLOv5
from simple_pose_tpu.convert.torch2flax import convert_torch_state_generic
from simple_pose_tpu.detector import blocks as jb
from simple_pose_tpu.detector import wrapper as jwrap
from simple_pose_tpu.detector.nms import non_max_suppression_jit
from simple_pose_tpu.detector.yolov4 import YOLOv4 as JYOLOv4
from simple_pose_tpu.detector.yolov5 import YOLOv5 as JYOLOv5
from tests.torch_jax_vars import abstract_flax_init, clear_pairs, seeded_variables, unfreeze

torch.set_num_threads(1)

FAMILIES = {"yolov5": (JYOLOv5, YOLOv5), "yolov4": (JYOLOv4, YOLOv4)}
DET_HW = 128
# pred: boxes in input pixels, the sigmoid fields (obj, cls) absolute
BOX_TOL, SCORE_TOL = 1e-3, 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


BLOCKS = {
    # name: (flax module, torch module, input NHWC shape)
    "cbr": (lambda: jb.CBR(16, 3, 2), lambda: tb.CBR(8, 16, 3, 2), (2, 9, 9, 8)),
    "focus": (lambda: jb.Focus(16, 3), lambda: tb.Focus(3, 16, 3), (2, 16, 12, 3)),
    "bottleneck_mish": (lambda: jb.BottleNeck(16, act=jb.mish),
                        lambda: tb.BottleNeck(16, 16, act=tb.mish), (2, 8, 8, 16)),
    "csp": (lambda: jb.BottleNeckCSP(16, blocks=2),
            lambda: tb.BottleNeckCSP(8, 16, 2), (2, 8, 8, 8)),
    "csp2": (lambda: jb.BottleNeckCSP2(8, blocks=2, act=jb.mish, expansion=1.0),
             lambda: tb.BottleNeckCSP2(12, 8, 2, act=tb.mish, expansion=1.0), (2, 8, 8, 12)),
    "spp": (lambda: jb.SPP(16), lambda: tb.SPP(16, 16), (2, 16, 16, 16)),
    "sppcsp": (lambda: jb.SPPCSP(8, act=jb.mish),
               lambda: tb.SPPCSP(16, 8, act=tb.mish), (2, 16, 16, 16)),
    "frelu": (lambda: jb.FReLU(8), lambda: tb.FReLU(8), (2, 8, 8, 8)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    make_j, make_t, shape = BLOCKS[name]
    rng = np.random.default_rng(sorted(BLOCKS).index(name))
    x = rng.normal(size=shape).astype(np.float32)
    fm = make_j()
    variables = seeded_variables(fm, x, rng)
    want = np.asarray(fm.apply(variables, jnp.asarray(x)))
    tm = make_t().eval()
    tm.load_state_dict(detector_flax_to_torch_state(variables, tm))
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["mish", "hardswish", "swish"])
def test_activation_matches_jax(act):
    x = np.linspace(-8, 8, 1601).astype(np.float32)
    want = np.asarray(getattr(jb, act)(jnp.asarray(x)))
    got = getattr(tb, act)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """JAX variables of an 80-class ``scale_name='s'`` model, its pred on a
    seeded batch of 2, and the port's model on the converted weights."""
    jcls, tcls = FAMILIES[request.param]
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, DET_HW, DET_HW, 3)).astype(np.float32)
    jm = jcls(num_cls=80, scale_name="s")
    variables = seeded_variables(jm, x, rng)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = tcls(num_cls=80, scale_name="s").eval()
    state = detector_flax_to_torch_state(variables, tm)
    tm.load_state_dict(state)
    return {"name": request.param, "variables": variables, "x": x, "pred": want,
            "model": tm, "state": state}


def test_pred_matches_jax(family):
    with torch.no_grad():
        got = family["model"](_nchw(family["x"])).numpy()
    want = family["pred"]
    n = 3 * sum((DET_HW // s) ** 2 for s in (8, 16, 32))
    assert got.shape == want.shape == (2, n, 85)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=0, atol=SCORE_TOL)


def test_raw_head_layout(family):
    """decode=False: per-level [B, apg, ny, nx, 85] maps whose decode is the
    pred (anchor-major, then y, then x)."""
    tm = family["model"]
    tm.head.decode = False
    try:
        with torch.no_grad():
            raw, anchors = tm(_nchw(family["x"]))
    finally:
        tm.head.decode = True
    assert [tuple(r.shape) for r in raw] == [(2, 3, DET_HW // s, DET_HW // s, 85)
                                             for s in (8, 16, 32)]
    assert anchors.shape == (3, 3, 2)
    s = torch.sigmoid(raw[2][0, 1, 2, 3])  # level 2, anchor 1, y 2, x 3
    flat = 3 * ((DET_HW // 8) ** 2 + (DET_HW // 16) ** 2) + (1 * 4 + 2) * 4 + 3
    want = family["pred"][0, flat]
    np.testing.assert_allclose(s[4:].numpy(), want[4:], atol=SCORE_TOL)
    np.testing.assert_allclose(((s[0] * 2 - 0.5 + 3) * 32).item(), want[0], atol=BOX_TOL)


def test_converter_round_trip_through_jax_converter(family, tmp_path):
    """flax -> the port's state dict -> a reference-layout checkpoint
    (['ema'], DataParallel's module. prefix) -> the JAX generic converter
    gives back every leaf exactly."""
    path = str(tmp_path / "det.pth")
    torch.save({"ema": {f"module.{k}": v for k, v in family["state"].items()}}, path)
    raw = torch.load(path, map_location="cpu", weights_only=False)["ema"]
    back, skipped = convert_torch_state_generic(raw)
    assert not skipped
    want = dict(jax.tree_util.tree_flatten_with_path(family["variables"])[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    loaded = twrap.load_detector_state(path, slice_idx=-1)
    assert set(loaded) == set(family["state"])
    assert all(torch.equal(loaded[k], family["state"][k]) for k in loaded)


def test_slice_person_head(family, tmp_path):
    """The 1-class detector loaded from the 80-class checkpoint gives the
    person columns of the 80-class pred, and its head equals JAX's slice."""
    path = str(tmp_path / "det80.pth")
    torch.save({"ema": family["state"]}, path)
    one = twrap.build_detector(family["name"], 1, "s", weights=path)
    with torch.no_grad():
        got = one(_nchw(family["x"])).numpy()
        full = family["model"](_nchw(family["x"])).numpy()
    assert got.shape[-1] == 6
    np.testing.assert_allclose(got, full[..., :6], rtol=0, atol=1e-6)
    jsliced = jwrap.slice_person_head(family["variables"], num_cls=80, slice_idx=0)
    want = detector_flax_to_torch_state(unfreeze(jsliced), one)
    for k, v in one.state_dict().items():
        if k.startswith("head."):
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)


def test_bf16_within_amp_bound(family):
    """bf16 autocast against f32 on the same weights, within the JAX
    package's own amp bound (tests/test_detector.py:358-375)."""
    one = twrap.build_detector(family["name"], 1, "s", weights=family["state"])
    one16 = twrap.build_detector(family["name"], 1, "s", weights=family["state"],
                                 dtype=torch.bfloat16)
    x = _nchw(family["x"])
    with torch.no_grad():
        y32, y16 = one(x).numpy(), one16(x).numpy()
    assert y16.dtype == np.float32
    assert np.median(np.abs(y32[..., :4] - y16[..., :4])) < 1.0
    assert np.abs(y32[..., 4:] - y16[..., 4:]).mean() < 5e-3


# --------------------------------------------------------------------- NMS
def _nms_pred(seed, nc):
    """[2, 300, 5 + nc] with planted ties: scores from a few levels, exact
    duplicate rows, and boxes in clusters so that suppression and merging
    both act."""
    rng = np.random.default_rng(seed)
    b, n = 2, 300
    centers = rng.uniform(40, 200, (b, 12, 2))
    pick = rng.integers(0, 12, (b, n))
    xy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 6, (b, n, 2))
    wh = rng.choice([20.0, 32.0, 48.0], (b, n, 2)) + rng.normal(0, 3, (b, n, 2))
    obj = rng.choice([0.05, 0.3, 0.5, 0.7, 0.9], (b, n))
    cls = rng.choice([0.2, 0.6, 1.0], (b, n, nc))
    pred = np.concatenate([xy, wh, obj[..., None], cls], -1).astype(np.float32)
    pred[:, 1::7] = pred[:, ::7][:, :pred[:, 1::7].shape[1]]  # exact duplicates
    return pred


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("multi_label", [False, True])
@pytest.mark.parametrize("agnostic", [False, True])
def test_nms_matches_jax(merge, multi_label, agnostic):
    pred = _nms_pred(int(merge) + 2 * int(multi_label) + 4 * int(agnostic), nc=3)
    # the second case pads: pre_nms < max_det
    pre_nms, max_det = (64, 80) if agnostic else (128, 30)
    kw = dict(conf_thresh=0.1, iou_thresh=0.5, max_det=max_det, pre_nms=pre_nms,
              multi_label=multi_label, agnostic=agnostic, merge=merge)
    jd, jv = (np.asarray(a) for a in non_max_suppression_jit(jnp.asarray(pred), **kw))
    td, tv = non_max_suppression(torch.from_numpy(pred), **kw)
    assert td.shape == (2, max_det, 6) and tv.dtype == torch.bool
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv.sum(-1).min() > 0
    # merged boxes are weighted means whose sums XLA's dot and torch.bmm add
    # in different orders: a few f32 ulps of the coordinate (2 ulps = 3e-5
    # px at 150 px measured), so 1e-5 px plus 1e-6 relative
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6, atol=1e-5)


def _chain_pred(n):
    """A chain of boxes, each overlapping the next above the threshold and
    the one after below it, with falling scores: greedy keeps every other
    box, the longest dependency the suppression can have."""
    pred = np.zeros((2, n, 6), np.float32)
    pred[:, :, 0] = 100.0 + 8.0 * np.arange(n)
    pred[:, :, 1] = 100.0
    pred[:, :, 2:4] = 40.0
    pred[:, :, 4] = np.linspace(0.9, 0.2, n)
    pred[:, :, 5] = 1.0
    pred[1] = pred[1, ::-1]  # the same chain, found in the other order
    return pred


def test_nms_suppression_chain_matches_jax():
    n = 200
    pred = _chain_pred(n)
    kw = dict(conf_thresh=0.1, iou_thresh=0.5, max_det=150, pre_nms=n)
    jd, jv = (np.asarray(a) for a in non_max_suppression_jit(jnp.asarray(pred), **kw))
    td, tv = non_max_suppression(torch.from_numpy(pred), **kw)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert (jv.sum(-1) == n // 2).all()
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6, atol=1e-5)


def _sequential_keep(valid, sup):
    """Greedy suppression one candidate at a time (the JAX package's loop)."""
    keep = valid.clone()
    for i in range(valid.shape[-1]):
        keep &= ~((sup[:, i] > 0) & keep[:, i:i + 1])
    return keep


def _host_fixed_point(valid, sup):
    """The port's fixed point as it was before the while_loop: a host test
    (torch.equal) ends each round."""
    keep = valid
    while True:
        new = valid & ~(torch.bmm(keep.to(sup.dtype)[:, None, :], sup)[:, 0] > 0.0)
        if torch.equal(new, keep):
            return keep
        keep = new


class _NMS(torch.nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.kw = kw

    def forward(self, pred):
        return non_max_suppression(pred, **self.kw)


@pytest.mark.parametrize("exported", [False, True])
@pytest.mark.parametrize("n", [200, 512])
def test_greedy_keep_exact_on_chains(n, exported, monkeypatch):
    """The while_loop fixed point equals the sequential greedy loop and the
    host-tested fixed point on chains n deep (512 = pre_nms: every round
    but the last changes the keep mask), eagerly and in an exported program
    whose graph holds the loop as one node and reads nothing back to the
    host; with merge, whose redundancy rule can drop boxes after the loop."""
    pred = torch.from_numpy(_chain_pred(n))
    kw = dict(conf_thresh=0.1, iou_thresh=0.5, max_det=n // 2, pre_nms=n, merge=True)
    want = {}
    for name, fn in (("sequential", _sequential_keep), ("host", _host_fixed_point)):
        monkeypatch.setattr(tnms, "_greedy_keep", fn)
        want[name] = non_max_suppression(pred, **kw)
    monkeypatch.undo()
    if exported:
        ep = torch.export.export(_NMS(**kw), (pred,))
        targets = [str(node.target) for node in ep.graph.nodes if node.op == "call_function"]
        assert sum("while_loop" in t for t in targets) == 1, targets
        assert not set(targets) & {"aten._local_scalar_dense.default", "aten.equal.default",
                                   "aten.item.default", "aten.is_nonzero.default"}, targets
        got = ep.module()(pred)
    else:
        got = non_max_suppression(pred, **kw)
    for name, (wd, wv) in want.items():
        assert torch.equal(got[1], wv), name
        assert torch.equal(got[0], wd), name
    assert got[1].sum(-1).tolist() == [n // 2] * 2


# ------------------------------------------------------------ front end
SHAPES = [(480, 640), (640, 480), (1000, 500), (300, 300), (150, 400), (97, 641), (720, 1280)]


@pytest.mark.parametrize("target", [(640, 640), (256, 256), (128, 192)])
def test_letterbox_params_match_jax(target):
    for h, w in SHAPES:
        assert twrap.letterbox_params(h, w, target) == jwrap.letterbox_params(h, w, target)
        assert (twrap.rect_letterbox_params(h, w, target)
                == jwrap.rect_letterbox_params(h, w, target))
        assert (twrap.letterbox_params(h, w, target, scale_up=False)
                == jwrap.letterbox_params(h, w, target, scale_up=False))


@pytest.mark.parametrize("hw", [(300, 400), (512, 200), (600, 700), (512, 512)])
def test_paste_with_border_matches_jax(hw):
    img = np.random.default_rng(hw[0]).integers(0, 255, hw + (3,), dtype=np.uint8)
    want, got = np.zeros((512, 512, 3), np.uint8), np.zeros((512, 512, 3), np.uint8)
    assert twrap.paste_with_border(got, img) == jwrap.paste_with_border(want, img)
    np.testing.assert_array_equal(got, want)


def test_read_canvases_equal_cv2_with_border():
    """The native loader's RGB canvases, flipped to BGR with the border,
    equal cv2.imread + the JAX package's paste_with_border."""
    cv = pytest.importorskip("cv2")
    import os

    from simple_pose_torch.data.native import NativeCanvasLoader

    root = os.path.join(os.path.dirname(__file__), "data_torch_jpeg", "det", "images")
    paths = [os.path.join(root, f) for f in sorted(os.listdir(root))[:3]]
    for canvas in (640, 400):
        got, shapes = twrap.read_canvases(paths, canvas, NativeCanvasLoader(2))
        via_cv2, shapes_cv2 = twrap.read_canvases(paths, canvas)
        for i, p in enumerate(paths):
            want = np.zeros((canvas, canvas, 3), np.uint8)
            img = cv.imread(p)
            jwrap.paste_with_border(want, img)
            assert shapes[i] == shapes_cv2[i] == img.shape[:2]
            np.testing.assert_array_equal(got[i], want)
            np.testing.assert_array_equal(via_cv2[i], want)


def test_letterbox_input_matches_jax():
    rng = np.random.default_rng(4)
    canvases = rng.integers(0, 255, (2, 320, 320, 3), dtype=np.uint8)
    geom = [jwrap.letterbox_params(h, w, (128, 128)) for h, w in [(240, 320), (320, 200)]]
    trans, region = jwrap._geom_to_arrays(geom)
    want = np.asarray(jwrap._letterbox_input(jnp.asarray(canvases), jnp.asarray(trans),
                                             jnp.asarray(region), 128, 128, jnp.float32))
    got = twrap.letterbox_input(torch.from_numpy(canvases), torch.from_numpy(trans),
                                torch.from_numpy(region), 128, 128)
    assert got.shape == (2, 3, 128, 128)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


def test_predict_batch_rect_square_and_single_predict():
    """A square image's rect bucket is the full square: rect mode gives the
    default boxes exactly; a wide image runs in a smaller bucket with boxes
    in its own pixels; single_predict equals predict_batch on the same
    canvas, and a tensor batch equals the numpy one."""
    cfg = dict(scale_name="s", scale_size=(128, 128), conf_thresh=0.001, canvas=256,
               device="cpu")
    det, det_rect = twrap.YOLOv5Detector(**cfg), twrap.YOLOv5Detector(**cfg, rect=True)
    rng = np.random.default_rng(11)
    sq = rng.integers(0, 255, (200, 200, 3), dtype=np.uint8)
    wide = rng.integers(0, 255, (90, 250, 3), dtype=np.uint8)
    canvases = np.zeros((2, 256, 256, 3), np.uint8)
    twrap.paste_with_border(canvases[0], sq)
    twrap.paste_with_border(canvases[1], wide)
    shapes = [(200, 200), (90, 250)]
    b_def = det.predict_batch(canvases, shapes)
    b_rect = det_rect.predict_batch(canvases, shapes)
    np.testing.assert_array_equal(b_rect[0], b_def[0])
    assert len(b_rect[0]) and len(b_rect[1]) and b_rect[1].shape[1] == 6
    assert twrap.rect_letterbox_params(90, 250, (128, 128))[0] == (128, 64)
    np.testing.assert_array_equal(det.single_predict(sq), b_def[0])
    for a, b in zip(det_rect.predict_batch(torch.from_numpy(canvases), shapes), b_rect):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rect", [False, True])
def test_predict_batch_matches_jax(rect, tmp_path):
    """predict_batch's boxes (NMS, clipped to the letterbox or its rect
    bucket, mapped back to the image) against the JAX detector's on the
    same weights.  Each JAX box whose score is clear of its image's other
    candidates (tests/torch_jax_vars.is_clear) has the port's box of that
    image with the same score and class and coordinates within 1e-2 px."""
    rng = np.random.default_rng(12)
    variables = seeded_variables(JYOLOv5(num_cls=80, scale_name="s"),
                                 np.zeros((1, DET_HW, DET_HW, 3), np.float32), rng)
    path = str(tmp_path / "yolov5s.pth")
    torch.save({"ema": detector_flax_to_torch_state(variables, YOLOv5(80, "s"))}, path)
    cfg = dict(weights_path=path, scale_name="s", scale_size=(DET_HW, DET_HW), conf_thresh=0.001,
               canvas=256, amp=False, rect=rect)
    with abstract_flax_init():
        jdet = jwrap.YOLOv5Detector(**cfg)
    tdet = twrap.YOLOv5Detector(**cfg, device="cpu")
    shapes = [(200, 200), (90, 250), (250, 120)]
    canvases = np.zeros((len(shapes), 256, 256, 3), np.uint8)
    for c, hw in zip(canvases, shapes):
        twrap.paste_with_border(c, rng.integers(0, 255, hw + (3,), dtype=np.uint8))
    want, got = jdet.predict_batch(canvases, shapes), tdet.predict_batch(canvases, shapes)
    # each group's pred, as predict_batch runs it: one square group, or one
    # bucket per image (128x128, 128x64 and 64x128)
    if rect:
        buckets = [twrap.rect_letterbox_params(h, w, (DET_HW, DET_HW)) for h, w in shapes]
        groups = [([i], b[0], [b[1:]]) for i, b in enumerate(buckets)]
        assert len({b[0] for b in buckets}) == len(shapes)
    else:
        groups = [(list(range(len(shapes))), (DET_HW, DET_HW),
                   [twrap.letterbox_params(h, w, (DET_HW, DET_HW)) for h, w in shapes])]
    preds, tol = {}, 0.0
    for idx, (tw, th), geom in groups:
        args = (canvases[idx], *twrap._geom_to_arrays(geom))
        jp = np.asarray(jdet._forward_for(th, tw)(jdet.variables, *map(jnp.asarray, args)))
        tp = tdet.forward(*map(torch.from_numpy, args), th, tw).numpy()
        tol = max(tol, 4 * np.abs(tp[..., 4:] - jp[..., 4:]).max())
        preds.update(zip(idx, jp))
    for i in range(len(shapes)):
        assert abs(len(got[i]) - len(want[i])) <= 1, (i, len(got[i]), len(want[i]))
    entries = lambda boxes: [(i, d[4], d) for i, b in enumerate(boxes) for d in b]  # noqa: E731
    pairs = clear_pairs(preds, entries(want), entries(got), tol)
    assert len(pairs) >= 30, len(pairs)
    for (i, _, w), (_, _, g) in pairs:
        assert g[5] == w[5]
        np.testing.assert_allclose(g[:4], w[:4], rtol=0, atol=1e-2, err_msg=str(i))
