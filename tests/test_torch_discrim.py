"""The discriminative held-out AP gate of the port against the JAX repo's:
scripts/torch_discrim_corpus.py paints the arrays tests/util_synth hands to
cv2.imwrite, exactly; the port reads its PNGs without cv2 to cv2's pixels;
PosePipeline and predicts_by_gt on that corpus match the JAX package's;
both packages' decoders agree on the heatmaps of a net the gate trained on
the card; and scripts/drive_torch_discrim_ap.py rehearses on the CPU into
the JAX gate's schema, which scripts/aggregate_discrim_seeds.py reads.

    JAX_PLATFORMS=cpu python -m tests.test_torch_discrim

prints the decoder replay's numbers (decoder_replay) as one JSON line."""

import importlib.util
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import tests.util_synth as us
from simple_pose_torch.convert.from_jax import flax_to_torch_state
from simple_pose_torch.data import coco as tcoco
from simple_pose_torch.data import pipeline as tpipe
from simple_pose_torch.evalkit.workflows import predicts_by_gt
from simple_pose_torch.utils.viz import write_png
from simple_pose_tpu.data import coco as jcoco
from simple_pose_tpu.data import pipeline as jpipe
from simple_pose_tpu.evalkit import workflows as jwf

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R18 = {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17}
# the gate's corpus parameters (scripts/drive_discrim_ap.py:76-85)
BASE = dict(people_per_image=1, blob_sigma=2.5, img_w=160, img_h=128)
COLOR = {**BASE, "joint_sep": 7.0}
# (seed, scale range, occluder fraction): the gate's train and val draws
DRAWS = {"train": (100, (10.0, 16.0), 0.0), "val": (777, (8.0, 18.0), 0.12)}


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


corpus = _script("torch_discrim_corpus")


def _hsv_palette(n):
    return [tuple(int(v) for v in cv2.cvtColor(
        np.uint8([[[int(j * 180 / n), 255, 255]]]), cv2.COLOR_HSV2BGR)[0, 0]) for j in range(n)]


def test_palettes_are_cv2s():
    assert corpus.HUES_17 == _hsv_palette(17)
    assert corpus.HUES_9 == _hsv_palette(9)


def _crowded(draw, n=12):
    """The detector-chain gate's crowded flipsym draws
    (scripts/drive_discrim_detchain.py:118-140) at ``n`` images each: the
    people counts from default_rng(7), val's first."""
    rng = np.random.default_rng(7)
    counts = {"detchain_val": rng.integers(3, 5, n), "detchain_train": rng.integers(1, 4, n)}
    seed, scale_range, sep = {"detchain_val": (777, (9.0, 13.0), 1.7),
                              "detchain_train": (100, (10.0, 15.0), 2.4)}[draw]
    return dict(num_images=n, seed=seed, img_w=256, img_h=192, scale_range=scale_range,
                people_per_image=[int(p) for p in counts[draw]], min_center_sep=sep,
                blob_sigma=2.5, occlude_frac=0.0)


@pytest.mark.parametrize("kind, draw", [
    pytest.param(kind, draw, id=f"{kind}-{draw}")
    for kind, draw in [("color", "train"), ("color", "val"), ("flipsym", "train"),
                       ("flipsym", "val"), ("flipsym", "detchain_train"),
                       ("flipsym", "detchain_val")]])
def test_painted_corpus_equals_jax_arrays(tmp_path, monkeypatch, kind, draw):
    """12 images: the PNG read back as BGR equals, exactly, the uint8 array
    the JAX generator hands to cv2.imwrite (before its JPEG encode); the
    annotations are equal apart from the file suffix.  The detchain draws
    are the detector-chain gate's crowded 256x192 corpora (1-4 people an
    image, ``min_center_sep``)."""
    handed = {}

    def imwrite(path, img, *params):
        handed[os.path.basename(path)] = img.copy()
        return True

    monkeypatch.setattr(cv2, "imwrite", imwrite)
    make, paint, kw = ((us.make_discriminative_coco, corpus.paint_discriminative, COLOR)
                       if kind == "color" else (us.make_flipsym_coco, corpus.paint_flipsym, BASE))
    if draw.startswith("detchain"):
        common = _crowded(draw)
        occlude = 0.0
    else:
        seed, scale_range, occlude = DRAWS[draw]
        common = dict(num_images=12, seed=seed, scale_range=scale_range, occlude_frac=occlude,
                      **kw)
    _, _, want_gt = make(str(tmp_path / "jax"), **common)
    img_root, ann_path, got_gt = paint(str(tmp_path / "torch"), **common)
    assert json.dumps(got_gt) == json.dumps(want_gt).replace(".jpg", ".png")
    with open(ann_path) as f:
        assert json.load(f) == got_gt
    occluded = 0
    for im in got_gt["images"]:
        got = cv2.imread(os.path.join(img_root, im["file_name"]))
        want = handed[im["file_name"].replace(".png", ".jpg")]
        np.testing.assert_array_equal(got, want, err_msg=im["file_name"])
        occluded += int((got == 96).all(-1).sum() > 24)
    assert len(handed) == 12
    # the val draw paints occluders (uniform 96 patches), the train draw none
    assert (occluded > 0) == (occlude > 0), occluded
    if draw.startswith("detchain"):  # several people an image, as drawn
        people = np.bincount([a["image_id"] for a in got_gt["annotations"]])[1:]
        assert people.tolist() == common["people_per_image"]


def test_imread_rgb_reads_png_as_cv2(tmp_path, monkeypatch):
    """RGB and grayscale PNGs of write_png read to cv2.imread's BGR flipped
    to RGB, with cv2 unimportable; a PNG that read_png refuses goes to cv2
    (here present), and raises where cv2 cannot be imported."""
    rng = np.random.default_rng(0)
    rgb, gray = rng.integers(0, 256, (37, 53, 3), np.uint8), rng.integers(0, 256, (9, 11), np.uint8)
    write_png(str(tmp_path / "rgb.png"), rgb)
    write_png(str(tmp_path / "gray.png"), gray)
    cv2.imwrite(str(tmp_path / "cv2.png"), rgb[..., ::-1])  # cv2 filters its rows
    want = {name: cv2.imread(str(tmp_path / name))[..., ::-1]
            for name in ("rgb.png", "gray.png", "cv2.png")}
    np.testing.assert_array_equal(tpipe._imread_rgb(str(tmp_path / "cv2.png")), want["cv2.png"])
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name in ("rgb.png", "gray.png"):
        got = tpipe._imread_rgb(str(tmp_path / name))
        assert got.dtype == np.uint8 and got.shape == want[name].shape
        np.testing.assert_array_equal(got, want[name])
    np.testing.assert_array_equal(want["rgb.png"], rgb)
    with pytest.raises(ImportError):
        tpipe._imread_rgb(str(tmp_path / "cv2.png"))


@pytest.fixture(scope="module")
def png_corpus(tmp_path_factory):
    """The gate's val draw, 8 images, as the port paints it."""
    root = tmp_path_factory.mktemp("discrim")
    seed, scale_range, occlude = DRAWS["val"]
    img_root, ann_path, _ = corpus.paint_discriminative(
        str(root / "val"), num_images=8, seed=seed, scale_range=scale_range,
        occlude_frac=occlude, **COLOR)
    return img_root, ann_path


@pytest.mark.parametrize("case", ["train", "eval"])
def test_pipeline_batches_equal_jax_on_pngs(png_corpus, case):
    """PosePipeline over the PNGs (read_png) against the JAX pipeline (cv2),
    key for key, with the gate's augmentation for training and its eval
    layout (dedup, no shuffle, the last batch kept)."""
    img_root, ann_path = png_corpus
    kw = dict(batch_size=4, input_shape=(64, 64), output_shape=(16, 16), canvas=224, seed=11,
              num_threads=2, dedup_canvases=2)
    kw.update(dict(aug_scale=(0.9, 1.1), aug_rot=(-12.0, 12.0), aug_flip=False)
              if case == "train" else dict(augment=False, shuffle=False, drop_last=False))
    jp = jpipe.PosePipeline(jcoco.load_coco_keypoints(img_root, ann_path), use_native=False,
                            **kw)
    tp = tpipe.PosePipeline(tcoco.load_coco_keypoints(img_root, ann_path), **kw)
    want, got = list(jp.epoch(0)), list(tp.epoch(0))
    assert len(got) == len(want) > 0
    for bw, bt in zip(want, got):
        assert set(bt) == set(bw)
        for k in bw:
            assert bt[k].dtype == bw[k].dtype and bt[k].shape == bw[k].shape, k
            np.testing.assert_array_equal(bt[k], bw[k], err_msg=f"{case} {k}")
    assert got[0]["canvas"].any()


@pytest.fixture(scope="module")
def r18_pth(tmp_path_factory):
    """One seeded JAX ResNet-18 state as a reference-layout .pth (['ema'])."""
    _, variables = jwf.load_model_variables(R18, None, (64, 64))
    pth = str(tmp_path_factory.mktemp("r18") / "r18.pth")
    torch.save({"ema": flax_to_torch_state(variables)}, pth)
    return pth


@pytest.mark.parametrize("decoder", ["gauss_taylor", "basic", "dark_original"])
def test_predicts_by_gt_matches_jax_on_pngs(png_corpus, r18_pth, tmp_path, decoder):
    """predicts_by_gt on the 8 val PNGs at the gate's canvas: every COCO
    stat within 0.005 of the JAX workflow's (which reads them through
    cv2), and the keypoints of both within 0.15 px on >= 95% of joints (the
    seeded heatmaps are nearly flat, so a few argmaxes flip between peaks
    tied to f32 sum order)."""
    img_root, ann_path = png_corpus
    kw = dict(weights=r18_pth, batch_size=4, input_shape=(64, 64), canvas=224, amp=False,
              decoder=decoder)
    want = jwf.predicts_by_gt(img_root, ann_path, R18, out_path=str(tmp_path / "j.json"), **kw)
    got = predicts_by_gt(img_root, ann_path, R18, out_path=str(tmp_path / "t.json"),
                         device="cpu", **kw)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 0.005, (k, got[k], want[k])
    rows = [sorted(json.load(open(tmp_path / f)), key=lambda r: r["image_id"])
            for f in ("j.json", "t.json")]
    assert len(rows[0]) == len(rows[1]) == 8
    kj, kt = (np.array([r["keypoints"] for r in rr]).reshape(8, 17, 3) for rr in rows)
    assert np.isfinite(kt).all()
    close = np.abs(kt[..., :2] - kj[..., :2]).max(-1) < 0.15
    assert close.mean() >= 0.95, close.mean()


# float's val heatmaps of the gate's ResNet-18-DConv trained on the card on
# the flipsym corpus at seed 11 (drive_torch_discrim_ap.py writes them to
# <dir>/val_heatmaps.npz), with the APs that run measured there
TRAINED_HEATMAPS = os.path.join(REPO, "tests", "data_torch_discrim",
                                "flipsym_s11_val_heatmaps.npz")


def _shift(a, b):
    d = np.linalg.norm(a - b, axis=-1)
    return {"mean_px": float(d.mean()), "max_px": float(d.max()),
            "share_within_0.01px": float((d < 0.01).mean())}


DECODERS = ("gauss_taylor", "basic", "dark_original")


def decoder_replay(tmp, path=TRAINED_HEATMAPS):
    """Each package's three decoders on the trained heatmaps in ``path``,
    on the CPU: each package's AP on the gate's val corpus (painted anew in
    ``tmp``); within each package, the AP delta and keypoint shift of basic
    and dark_original from gauss_taylor; and how far the port's keypoints
    lie from JAX's for each decoder."""
    import jax.numpy as jnp

    from simple_pose_torch.metrics.cocoeval import evaluate_map as t_map
    from simple_pose_torch.ops import decode as tdec
    from simple_pose_tpu.metrics.cocoeval import evaluate_map as j_map
    from simple_pose_tpu.ops import decode as jdec

    gate = _script("drive_torch_discrim_ap")
    args = gate.parse_args(["--corpus", "flipsym", "--train-images", "1", "--dir", str(tmp)])
    *_, ann = gate.paint_corpora(args)
    saved = np.load(path)
    heat, trans_inv, img_id = saved["heat"], saved["trans_inv"], saved["img_id"]
    kps, ap = {}, {}
    for pkg, dec, evaluate_map, arr in (("jax", jdec, j_map, jnp.asarray),
                                        ("torch", tdec, t_map, torch.from_numpy)):
        for name in DECODERS:
            host = name == "dark_original"  # numpy in, numpy out
            k, c = getattr(dec, f"decode_{name}")(*(x if host else arr(x)
                                                    for x in (heat, trans_inv)))
            k, c = np.asarray(k, np.float32), np.asarray(c, np.float32)
            rows = []
            jwf.kps_to_dicts(k, c, c[..., 0].mean(-1) + c[..., 0].max(-1), img_id, rows)
            out = os.path.join(str(tmp), f"res_{pkg}_{name}.json")
            with open(out, "w") as f:
                json.dump(rows, f)
            kps[pkg, name], ap[pkg, name] = k, float(evaluate_map(out, ann)["AP"])
    return {
        "card_ap": {"gauss_taylor": float(saved["ap_float"]),
                    "basic": float(saved["ap_decoder_basic"])},
        "ap": {pkg: {name: ap[pkg, name] for name in DECODERS} for pkg in ("jax", "torch")},
        "vs_gauss_taylor": {
            pkg: {name: {"ap_delta": ap[pkg, name] - ap[pkg, "gauss_taylor"],
                         **_shift(kps[pkg, name], kps[pkg, "gauss_taylor"])}
                  for name in DECODERS[1:]}
            for pkg in ("jax", "torch")},
        "torch_vs_jax": {name: {"ap_delta": ap["torch", name] - ap["jax", name],
                                **_shift(kps["torch", name], kps["jax", name])}
                         for name in DECODERS},
    }


def test_decoders_agree_on_trained_heatmaps(tmp_path):
    """On the val heatmaps of a net the gate trained on the card, each of
    the port's decoders gives JAX's keypoints (within 0.01 px on >= 99% of
    joints) and JAX's AP within 0.005, and gauss_taylor and basic replay
    the card's APs within 0.005: what basic or dark_original costs against
    gauss_taylor there is the decoder's, the same in both packages."""
    got = decoder_replay(tmp_path)
    for name, d in got["torch_vs_jax"].items():
        assert abs(d["ap_delta"]) <= 0.005 and d["share_within_0.01px"] >= 0.99, (name, got)
    for name, card_ap in got["card_ap"].items():
        assert abs(got["ap"]["torch"][name] - card_ap) <= 0.005, (name, got)
    for name in DECODERS[1:]:
        deltas = [got["vs_gauss_taylor"][pkg][name]["ap_delta"] for pkg in ("jax", "torch")]
        assert abs(deltas[0] - deltas[1]) <= 0.005, (name, got)


SCHEMA = {"backend", "model", "corpus", "seed", "epochs_run", "ap_by_epoch", "train_ap",
          "float_ap", "discriminative", "variants", "wall_s", "card", "torch", "launches",
          "gate"}
CPU_VARIANTS = {"flip_test", "w8a8_dynamic", "w8a8_static", "decoder_basic",
                "decoder_dark_original"}


def test_gate_rehearses_on_cpu_and_aggregates(tmp_path):
    """drive_torch_discrim_ap.py --device cpu at 8 train / 4 val images, one
    epoch, 64x64: one JSON in the JAX gate's schema with every variant the
    CPU runs (not fused_layer1: ResNet-18 has no Bottleneck layer1; not
    two_ranks: the card's), its training steps counted; then
    aggregate_discrim_seeds.py reads it beside a second seed's copy."""
    out = tmp_path / "gate.json"
    cmd = [sys.executable, os.path.join(REPO, "scripts", "drive_torch_discrim_ap.py"),
           "--device", "cpu", "--epochs", "1", "--train-images", "8", "--val-images", "4",
           "--input", "64", "--dir", str(tmp_path / "run"),
           "--out", str(out)]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=240)
    # float AP of a one-epoch net is ~0: the gate fails (exit 1) but writes
    assert proc.returncode == 1, proc.stdout[-3000:] + proc.stderr[-3000:]
    run = json.loads(out.read_text())
    assert SCHEMA <= set(run), SCHEMA - set(run)
    assert run["backend"] == "cpu" and run["model"] == "pose_resnet_dconv:resnet18"
    assert run["corpus"] == "color" and run["seed"] == 11 and run["epochs_run"] == 1
    assert set(run["variants"]) == CPU_VARIANTS
    for v in run["variants"].values():
        assert set(v) == {"ap", "delta_vs_float", "kp_shift_px_mean", "kp_shift_px_max"}
        assert 0.0 <= v["ap"] <= 1.0 and 0.0 <= v["kp_shift_px_mean"] <= v["kp_shift_px_max"]
    # flip-test and the decoders move keypoints; the float-only rows do not exist
    assert run["variants"]["decoder_basic"]["kp_shift_px_max"] > 0
    assert list(run["ap_by_epoch"]) == ["1"]
    assert run["launches"]["train"]["steps"] > 0
    assert run["gate"]["not_gated"] == {"flip_test": run["gate"]["not_gated"]["flip_test"]}
    assert run["gate"]["float_ap_in_range"] is False and run["gate"]["passed"] is False
    assert sorted(os.listdir(tmp_path / "run" / "train" / "imgs"))[0] == "000000000001.png"
    heat = np.load(tmp_path / "run" / "val_heatmaps.npz")
    assert heat["heat"].shape == (4, 17, 16, 16) and heat["trans_inv"].shape == (4, 2, 3)
    assert sorted(heat["img_id"]) == [1, 2, 3, 4]
    assert abs(float(heat["ap_float"]) - run["float_ap"]) < 1e-4

    second = tmp_path / "gate_s12.json"
    second.write_text(json.dumps({**run, "seed": 12}))
    seeds = tmp_path / "seeds.json"
    agg = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                       "aggregate_discrim_seeds.py"),
                          str(out), str(second)],
                         env={**os.environ, "DISCRIM_SEEDS_OUT": str(seeds)},
                         capture_output=True, text=True, timeout=60)
    assert agg.returncode == 0, agg.stderr
    group = json.loads(seeds.read_text())["pose_resnet_dconv:resnet18|color"]
    assert group["seeds"] == [11, 12] and group["float_ap_sd"] == 0.0
    assert set(group["variants"]) == CPU_VARIANTS


def _verdict(gate, corpus, float_ap=0.7, deltas=None, train=(10, 10, 0), eval_counts=None):
    args = gate.parse_args(["--model", "pose_hrnet:w32", "--corpus", corpus, "--epochs", "10",
                            "--val-every", "5", "--dir", "unused"])
    deltas = {"flip_test": -0.6, "w8a8_dynamic": -0.01, "w8a8_static": 0.0,
              "fused_layer1": 0.001, "two_ranks": 0.0, **(deltas or {})}
    variants = {n: {"delta": d, "delta_vs_float": round(d, 4)} for n, d in deltas.items()}
    counts = {"float": {"bottleneck_chain": 0, "int8_conv": 0},
              "w8a8_dynamic": {"bottleneck_chain": 0, "int8_conv": 63},
              "w8a8_static": {"bottleneck_chain": 0, "int8_conv": 63},
              "fused_layer1": {"bottleneck_chain": 3, "int8_conv": 0}, **(eval_counts or {})}
    steps, crops, k1 = train
    launches = {"train": {"steps": steps, "rotate_resample_crop": crops, "rotate_resample": k1},
                "eval": counts}  # two_ranks counts in its own processes: no entry
    return gate.gate(args, float_ap, variants, launches, on_cuda=True)


def test_gate_rules():
    """The gate: float AP inside (0.2, 0.98); |delta| <= 0.015 for every
    variant but flip-test on the color corpus (gated on flipsym); on CUDA
    the crop kernel once a step, K1 never, K2 in fused_layer1 and the int8
    route in each W8A8 run."""
    gate = _script("drive_torch_discrim_ap")
    ok = _verdict(gate, "color")
    assert ok["passed"] and ok["not_gated"].keys() == {"flip_test"} and not ok["misses"]
    assert set(ok["launch_checks"]) == {"crop_kernel_once_per_step", "k1_never",
                                        "k2_in_fused_layer1", "int8_conv_in_w8a8_dynamic",
                                        "int8_conv_in_w8a8_static"}
    assert _verdict(gate, "flipsym")["misses"] == {"flip_test": -0.6}
    assert _verdict(gate, "flipsym", deltas={"flip_test": 0.004})["passed"]
    for kw, missed in (({"float_ap": 0.99}, None), ({"float_ap": 0.2}, None),
                       ({"deltas": {"w8a8_static": -0.0151}}, "w8a8_static"),
                       ({"deltas": {"two_ranks": 0.016}}, "two_ranks")):
        verdict = _verdict(gate, "color", **kw)
        assert not verdict["passed"], kw
        assert list(verdict["misses"]) == ([missed] if missed else []), verdict
    for kw, check in (({"train": (10, 9, 0)}, "crop_kernel_once_per_step"),
                      ({"train": (0, 0, 0)}, "crop_kernel_once_per_step"),
                      ({"train": (10, 10, 1)}, "k1_never"),
                      ({"eval_counts": {"fused_layer1": {"bottleneck_chain": 0, "int8_conv": 0}}},
                       "k2_in_fused_layer1"),
                      ({"eval_counts": {"w8a8_static": {"bottleneck_chain": 0, "int8_conv": 0}}},
                       "int8_conv_in_w8a8_static")):
        verdict = _verdict(gate, "color", **kw)
        assert not verdict["passed"] and not verdict["launch_checks"][check], (kw, verdict)
    with pytest.raises(SystemExit):
        gate.parse_args(["--epochs", "600", "--val-every", "7"])


_NO_CV2 = r"""
import importlib.util, os, sys
for name in ("jax", "jaxlib", "flax", "simple_pose_tpu", "cv2", "tests", "tests.util_synth"):
    sys.modules[name] = None  # any import of these now raises ImportError
mods = {}
for name in ("torch_discrim_corpus", "drive_torch_discrim_ap"):
    spec = importlib.util.spec_from_file_location(name, os.path.join("scripts", name + ".py"))
    mods[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mods[name])
gate = mods["drive_torch_discrim_ap"]
args = gate.parse_args(["--train-images", "4", "--val-images", "2", "--epochs", "1",
                        "--dir", sys.argv[1]])
tr_root, tr_ann, va_root, va_ann = gate.paint_corpora(args)
from simple_pose_torch.data.coco import load_coco_keypoints
from simple_pose_torch.data.pipeline import PosePipeline
pipe = PosePipeline(load_coco_keypoints(tr_root, tr_ann), 4, input_shape=(64, 64),
                    output_shape=(16, 16), canvas=224, dedup_canvases=2)
batch = next(iter(pipe.epoch(0)))
assert batch["canvas"].any() and batch["valid"].sum() == 2
print(len(os.listdir(tr_root)), len(os.listdir(va_root)))
"""


def test_gate_scripts_import_no_jax_nor_cv2(tmp_path):
    """scripts/torch_discrim_corpus.py and scripts/drive_torch_discrim_ap.py
    import nothing of jax, the JAX package, cv2 or tests/util_synth: with
    those unimportable they paint a corpus that PosePipeline decodes."""
    proc = subprocess.run([sys.executable, "-c", _NO_CV2, str(tmp_path / "run")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["4", "2"]


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        print(json.dumps(decoder_replay(d)))
