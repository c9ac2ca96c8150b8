"""The detector-chain AP gate of the port against the JAX repo's
(scripts/drive_discrim_detchain.py): scripts/drive_torch_discrim_detchain.py
makes the same synthetic detections from the same crowded corpus, its AP
ladder (the raw dump, rescoring, OKS-NMS at 0.9 / 0.5 / 0.99, maxDets 2)
gives JAX's numbers on the same raw predictions, it rehearses on the CPU
into the JAX script's schema, its gate is the JAX script's rule, it imports
nothing of JAX nor cv2, and chip_smoke.py's phase 16 runs on the CPU."""

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

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chain = _script("drive_torch_discrim_detchain")
jax_chain = _script("drive_discrim_detchain")  # imports jax inside main() only


def _jax_val_gt(tmp_path, monkeypatch, n):
    """The JAX script's crowded val corpus (drive_discrim_detchain.py:118-124)
    at ``n`` images, its JPEG writes skipped."""
    monkeypatch.setattr(cv2, "imwrite", lambda *a, **k: True)
    rng = np.random.default_rng(7)
    _, _, gt = us.make_flipsym_coco(
        str(tmp_path / "jax_val"), num_images=n, seed=777, img_w=256, img_h=192,
        people_per_image=[int(p) for p in rng.integers(3, 5, n)], scale_range=(9.0, 13.0),
        min_center_sep=1.7, blob_sigma=2.5)
    return gt


def test_synth_detections_equal_jax(tmp_path, monkeypatch):
    """At the gate's full val size (48 images): the port's painted GT is the
    JAX generator's but for the file suffix, and the detections made from it
    equal, exactly, the JAX script's from its GT: 171 true, 249 duplicate
    and 96 false boxes, the counts of DISCRIM_DETCHAIN_TRAINED.json."""
    args = chain.parse_args(["--ckpt", "unused.pth", "--dir", str(tmp_path / "run")])
    tr_root, tr_ann, va_root, va_ann, va_gt = chain.paint_corpora(args)
    assert tr_root is None and tr_ann is None  # --ckpt: no training corpus
    assert len(os.listdir(va_root)) == 48
    want_gt = _jax_val_gt(tmp_path, monkeypatch, 48)
    assert json.dumps(va_gt) == json.dumps(want_gt).replace(".jpg", ".png")
    got, got_stats = chain.synth_detections(va_gt, seed=2025)
    want, want_stats = jax_chain.synth_detections(want_gt, seed=2025)
    assert got == want and got_stats == want_stats
    with open(os.path.join(REPO, "DISCRIM_DETCHAIN_TRAINED.json")) as f:
        assert json.load(f)["detections"] == {**got_stats, "total": len(got)}
    path, stats = chain.write_detections(args, va_gt)
    with open(path) as f:
        assert json.load(f) == got
    assert stats == {"true": 171, "dup": 249, "fp": 96, "total": 516}
    # another seed, other boxes
    assert chain.synth_detections(va_gt, seed=7)[0] == jax_chain.synth_detections(want_gt,
                                                                                   seed=7)[0]


def _raw_predictions(gt, dets, seed=3):
    """Raw predictions as predicts_by_detections writes them, one per
    detection: the keypoints of the person whose box centre lies nearest,
    less confident the farther the box sits from it, and scattered where it
    sits off every person, so that rescoring and OKS-NMS both change the
    AP."""
    rng = np.random.default_rng(seed)
    people = {}
    for a in gt["annotations"]:
        people.setdefault(a["image_id"], []).append(a)
    preds = []
    for d in dets:
        x, y, w, h = d["bbox"]
        centre = np.array([x + w / 2, y + h / 2])

        def off(a):
            bx, by, bw, bh = a["bbox"]
            return float(np.hypot(*(np.array([bx + bw / 2, by + bh / 2]) - centre)))

        a = min(people[d["image_id"]], key=off)
        rel = off(a) / max(w, h)
        kp = np.asarray(a["keypoints"], np.float64).reshape(17, 3)[:, :2]
        # a box on a person predicts that person (a duplicate nearly the
        # true box's keypoints), a box off every person scatters
        xy = kp + rng.normal(0.0, 0.3 if rel < 0.5 else 15.0, (17, 2))
        conf = np.clip(rng.normal(0.9 - 2.0 * rel, 0.15, 17), 0.0, 1.0)
        preds.append({"kps": np.concatenate([xy, conf[:, None]], -1).reshape(-1).tolist(),
                      "area": float(w * h), "score": float(d["score"]),
                      "img_id": int(d["image_id"])})
    return preds


RUNGS = ("rescore_only", "full_chain", "oks_thre_0.5", "oks_thre_0.99")
OKS = {"rescore_only": 1.01, "full_chain": 0.9, "oks_thre_0.5": 0.5, "oks_thre_0.99": 0.99}


def _jax_ladder(raw_path, ann, out_dir):
    """drive_discrim_detchain.py:173-200 through the JAX package."""
    from simple_pose_tpu.evalkit.workflows import rescore_and_filter
    from simple_pose_tpu.metrics.cocoeval import CocoKeypointsGT, KeypointEval, evaluate_map

    with open(raw_path) as f:
        raw_preds = json.load(f)
    raw_results = [{"image_id": int(p["img_id"]), "category_id": 1, "keypoints": p["kps"],
                    "score": float(p["score"])} for p in raw_preds]
    aps = {"raw_dump": evaluate_map(raw_results, ann)["AP"]}
    for rung in RUNGS:
        aps[rung] = rescore_and_filter(raw_path, ann, 0.2, OKS[rung],
                                       out_path=os.path.join(out_dir, f"jax_{rung}.json"))["AP"]
    with open(os.path.join(out_dir, "jax_full_chain.json")) as f:
        full = json.load(f)
    ev = KeypointEval(CocoKeypointsGT(ann), full, max_dets=2)
    ev.evaluate()
    ev.accumulate()
    aps["maxdets_2"] = ev.summarize()["AP"]
    return aps


def test_ap_ladder_equals_jax(tmp_path):
    """On one file of raw predictions over a crowded 12-image corpus: each
    rung of the port's ladder within 1e-9 of JAX's, each rung's kept
    results equal to JAX's, and the fixture gives both stages work."""
    args = chain.parse_args(["--ckpt", "unused.pth", "--val-images", "12", "--dir",
                             str(tmp_path / "run")])
    *_, va_ann, va_gt = chain.paint_corpora(args)
    dets, _ = chain.synth_detections(va_gt)
    raw = tmp_path / "raw.json"
    raw.write_text(json.dumps(_raw_predictions(va_gt, dets)))
    got = chain.ap_ladder(str(raw), va_ann, str(tmp_path))
    want = _jax_ladder(str(raw), va_ann, str(tmp_path))
    assert set(got) == set(want)
    for rung in want:
        assert abs(got[rung] - want[rung]) <= 1e-9, (rung, got, want)
    for rung in RUNGS:
        with open(tmp_path / f"ladder_{rung}.json") as f, \
                open(tmp_path / f"jax_{rung}.json") as g:
            assert json.load(f) == json.load(g), rung
    with open(tmp_path / "ladder_rescore_only.json") as f:
        assert len(json.load(f)) == len(dets)  # OKS 1.01 suppresses nothing
    # rescoring reorders, OKS-NMS suppresses, maxDets 2 truncates
    assert got["raw_dump"] < got["rescore_only"] < got["full_chain"], got
    assert got["maxdets_2"] < got["full_chain"], got


SCHEMA = {"backend", "model", "se", "checkpoint", "corpus", "detections", "raw_predictions",
          "ap_raw_dump", "ap_rescore_only", "ap_full_chain", "chain_improves",
          "perturbations", "variants", "seed", "epochs_run", "ap_by_epoch", "wall_s",
          "train_s", "eval_s", "card", "device", "torch", "config", "launches", "gate"}


def test_gate_rehearses_on_cpu(tmp_path):
    """drive_torch_discrim_detchain.py --device cpu at 8 train / 4 val
    images, one epoch, 64x64: one JSON in the JAX script's schema (plus the
    card, torch, the launches and the gate), one raw prediction per
    detection, the exit code the gate's."""
    out = tmp_path / "chain.json"
    cmd = [sys.executable, os.path.join(REPO, "scripts", "drive_torch_discrim_detchain.py"),
           "--device", "cpu", "--epochs", "1", "--train-images", "8", "--val-images", "4",
           "--input", "64", "--dir", str(tmp_path / "run"), "--out", str(out)]
    proc = subprocess.run(cmd, cwd=str(tmp_path), env={**os.environ, "OMP_NUM_THREADS": "2"},
                          capture_output=True, text=True, timeout=240)
    run = json.loads(out.read_text())
    assert proc.returncode == (0 if run["gate"]["passed"] else 1), proc.stderr[-3000:]
    assert SCHEMA <= set(run), SCHEMA - set(run)
    assert run["backend"] == "cpu" and run["model"] == "pose_resnet_dconv:resnet18"
    assert run["se"] is False and run["epochs_run"] == 1 and list(run["ap_by_epoch"]) == ["1"]
    assert run["corpus"]["images"] == 4 and 12 <= run["corpus"]["annotations"] <= 16
    det = run["detections"]
    assert det["true"] == run["corpus"]["annotations"] and det["fp"] == 8
    assert det["total"] == det["true"] + det["dup"] + det["fp"] == run["raw_predictions"]
    for k in ("ap_raw_dump", "ap_rescore_only", "ap_full_chain"):
        assert 0.0 <= run[k] <= 1.0, (k, run[k])
    assert set(run["perturbations"]) == {"oks_thre_0.5", "oks_thre_0.99", "maxdets_2"}
    assert run["chain_improves"] == (run["ap_raw_dump"] < run["ap_full_chain"])
    assert run["variants"] == {}  # ResNet-18's layer1 is no Bottleneck chain
    assert run["config"]["canvas"] == 288 and run["config"]["batch_size"] == 8
    assert run["launches"]["train"]["steps"] > 0 and run["launches"]["checks"] is None
    assert set(run["launches"]["chain"]) == {"unfused"}
    with open(tmp_path / "run" / "cfg.json") as f:
        data = json.load(f)["data"]
    assert data["canvas"] == 288 and data["aug_flip"] is True
    assert sorted(os.listdir(tmp_path / "run" / "val" / "imgs"))[0] == "000000000001.png"


def test_gate_rules():
    """The JAX script's rule, ap_raw < ap_full, and where the K2 variant ran
    its |delta| <= 0.015; the launch checks on made-up counters."""
    assert chain.gate(0.6676, 0.9956, None) == {
        "rule": "ap_raw_dump < ap_full_chain", "chain_improves": True, "passed": True}
    assert not chain.gate(0.9, 0.9, None)["passed"]
    assert not chain.gate(0.95, 0.9, None)["passed"]
    for delta, passed in ((0.0, True), (0.015, True), (-0.015, True), (-0.0151, False),
                          (0.02, False)):
        verdict = chain.gate(0.6, 0.9, {"delta": delta})
        assert verdict["passed"] is passed and verdict["fused_layer1_within_bound"] is passed
        assert verdict["delta_bound"] == 0.015
    assert not chain.gate(0.9, 0.8, {"delta": 0.0})["passed"]
    counts = {"unfused": {"bottleneck_chain": 0, "rotate_resample": 0},
              "fused_layer1": {"bottleneck_chain": 2, "rotate_resample": 0}}
    train = {"steps": 12, "rotate_resample_crop": 12, "rotate_resample": 0}
    assert all(chain.launch_checks(train, counts).values())
    assert set(chain.launch_checks(None, {"unfused": counts["unfused"]})) == {
        "k1_never_in_eval", "k2_not_in_unfused"}
    for t, c, check in (({**train, "rotate_resample_crop": 11}, counts,
                         "crop_kernel_once_per_step"),
                        ({**train, "rotate_resample": 1}, counts, "k1_never_in_training"),
                        (train, {**counts, "unfused": {"bottleneck_chain": 1,
                                                       "rotate_resample": 0}},
                         "k2_not_in_unfused"),
                        (train, {**counts, "fused_layer1": {"bottleneck_chain": 0,
                                                            "rotate_resample": 0}},
                         "k2_in_fused_layer1")):
        assert not chain.launch_checks(t, c)[check], check


def test_bottleneck_layer1_decides_the_k2_variant():
    """The K2 variant runs where layer1 folds into K2's chain."""
    for argv, want in ((["--model", "pose_resnet_dconv:resnet18"], False),
                       (["--model", "pose_resnet_dconv:resnet50", "--se"], True)):
        args = chain.parse_args(argv + ["--dir", "unused"])
        assert chain.has_bottleneck_layer1(args) is want, argv
    args = chain.parse_args(["--model", "pose_resnet_dconv:resnet50", "--se", "--dir", "x"])
    assert chain.model_cfg(args) == {"type": "pose_resnet_dconv", "name": "resnet50",
                                     "num_joints": 17, "reduction": True}
    assert args.dir.endswith(os.path.join("x")) and args.out.endswith(
        "DISCRIM_TORCH_DETCHAIN.json")
    with pytest.raises(SystemExit):
        chain.parse_args(["--model", "pose_hrnet:w32"])
    with pytest.raises(SystemExit):
        chain.parse_args(["--epochs", "300", "--val-every", "7"])


_NO_JAX = r"""
import importlib.util, json, os, sys
for name in ("jax", "jaxlib", "flax", "simple_pose_tpu", "cv2", "tests", "tests.util_synth"):
    sys.modules[name] = None  # any import of these now raises ImportError
spec = importlib.util.spec_from_file_location(
    "drive_torch_discrim_detchain", os.path.join("scripts", "drive_torch_discrim_detchain.py"))
chain = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chain)
args = chain.parse_args(["--train-images", "4", "--val-images", "2", "--epochs", "1",
                         "--dir", sys.argv[1]])
tr_root, tr_ann, va_root, va_ann, va_gt = chain.paint_corpora(args)
path, stats = chain.write_detections(args, va_gt)
from simple_pose_torch.data.coco import load_detection_boxes
from simple_pose_torch.data.pipeline import DetBoxPipeline
recs = load_detection_boxes(va_root, path, img_ext=".png")
batch = next(iter(DetBoxPipeline(recs, 4, input_shape=(64, 64), output_shape=(16, 16),
                                 canvas=288, use_native=False).epoch(0)))
assert batch["canvas"].any() and batch["valid"].sum() == 4
import chip_smoke
assert callable(chip_smoke.run_detchain_phase)
print(len(os.listdir(tr_root)), len(os.listdir(va_root)), stats["total"])
"""


def test_detchain_script_imports_no_jax_nor_cv2(tmp_path):
    """scripts/drive_torch_discrim_detchain.py (and chip_smoke.py with its
    phase 16) import nothing of jax, the JAX package, cv2 or
    tests/util_synth: with those unimportable it paints its corpus and
    makes detections whose PNG boxes DetBoxPipeline decodes."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path / "run")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_train, n_val, n_dets = map(int, proc.stdout.split())
    assert (n_train, n_val) == (4, 2) and n_dets >= 2 * (3 + 1 + 2)


def test_chip_smoke_phase16_rehearses_on_cpu(monkeypatch):
    """chip_smoke.run_detchain_phase on the CPU under phase 15's rehearsal
    patches (torch.cuda.synchronize a no-op, --input 64 --device cpu, the
    solver's crop and the model's K2 wrapped to bump their counters, which
    the plain versions do not), at 16 train and 4 val images: its asserts
    hold and it returns the kernels' line's counts."""
    import chip_smoke
    from simple_pose_torch.models import resnet
    from simple_pose_torch.ops import bottleneck_chain as k2
    from simple_pose_torch.ops import rotate_resample as rr
    from simple_pose_torch.train import solver

    crop, fold = solver.affine_crop_two_stage, resnet.bottleneck_chain

    def counted_crop(*a, **k):
        rr.affine_crop_two_stage.launches += 1
        return crop(*a, **k)

    def counted_chain(*a, **k):
        k2.bottleneck_chain.launches += 1
        return fold(*a, **k)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(solver, "affine_crop_two_stage", counted_crop)
    monkeypatch.setattr(resnet, "bottleneck_chain", counted_chain)
    monkeypatch.setattr(chip_smoke, "DETCHAIN_ARGS",
                        ["--train-images", "16", "--val-images", "4", "--epochs", "2",
                         "--val-every", "2", "--input", "64", "--device", "cpu"])
    summary, counts = chip_smoke.run_detchain_phase("cpu")
    r50 = summary["16d_r50_se"]
    assert counts["steps"] == summary["16b_train"]["steps"] + r50["steps"]
    assert counts["crop_launches"] == counts["steps"] > 0
    batches = r50["fused_layer1"]["pose_batches"]
    assert batches == r50["unfused"]["pose_batches"] > 0
    assert counts["k2_fused_layer1"] == batches + 1  # + the heatmap check's batch
    assert r50["heatmaps"]["k2_launches"] == 1
    assert {"k2", "cudnn", "plain"} <= set(r50["layer1_vs_f32"]), r50["layer1_vs_f32"]
    assert summary["16c_chain"]["kept"]["raw"] == summary["16c_detections"]["total"]
