"""The port's multi-process evaluation on the CPU: predicts_by_gt,
predicts_by_detections and fused_eval over two gloo ranks against one
process, the refusals (gen_detections, fused_layer1), w8a8 calibration
max-reduced over the ranks, and the ``main`` and ``eval`` CLIs with
``--mesh-devices`` and ``--multihost`` (through torchrun).  Each
multi-process run has its own timeout and its own working directory."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simple_pose_torch.evalkit import workflows as W
from simple_pose_torch.evalkit.fused import fused_eval
from simple_pose_torch.models.registry import build_from_cfg
from tests.torch_ddp_worker import run_ranks
from tests.util_synth import make_synth_coco

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEOPLE = [1, 3, 1, 4, 2, 1, 1]  # 13 records on 7 images: strides of unequal length
MODEL = {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17, "reduction": False}
TIMEOUT = 120


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Synthetic COCO, a seeded resnet18 .pth and a detection-results JSON
    (each ground-truth box jittered, with a score)."""
    root = tmp_path_factory.mktemp("coco")
    img_root, ann_path, _ = make_synth_coco(str(root), num_images=len(PEOPLE),
                                            people_per_image=PEOPLE, seed=4)
    weights = str(root / "w.pth")
    torch.save(build_from_cfg(MODEL, seed=3).state_dict(), weights)
    rng = np.random.default_rng(0)
    with open(ann_path) as f:
        anns = json.load(f)["annotations"]
    dets = [{"image_id": a["image_id"], "category_id": 1,
             "bbox": [float(v) for v in np.asarray(a["bbox"]) * rng.uniform(0.95, 1.05, 4)],
             "score": float(rng.uniform(0.5, 1.0))} for a in anns]
    dets_path = str(root / "dets.json")
    with open(dets_path, "w") as f:
        json.dump(dets, f)
    return {"img_root": img_root, "ann": ann_path, "weights": weights, "dets": dets_path,
            "model_cfg": MODEL}


def _sorted(path):
    with open(path) as f:
        rows = json.load(f)
    return sorted(rows, key=lambda r: json.dumps(r, sort_keys=True))


def test_workflows_over_two_ranks_equal_one_process(data, tmp_path):
    """Every rank gets the full prediction list and the stats one process
    gets, and rank 0 alone writes each file; gen_detections and
    fused_layer1 refuse two ranks, as JAX refuses a multi-host mesh; w8a8
    calibration gives every rank the max over the ranks' scales."""
    work = tmp_path / "ranks"
    work.mkdir()
    (work / "workflows.json").write_text(json.dumps(data))
    ranks = run_ranks("workflows", work, timeout=TIMEOUT)

    one = tmp_path / "one"
    one.mkdir()
    kw = dict(weights=data["weights"], batch_size=4, input_shape=(64, 64), decoder="basic",
              canvas=192, device="cpu", amp=False)
    want = {
        "gt": W.predicts_by_gt(data["img_root"], data["ann"], MODEL,
                               out_path=str(one / "gt.json"), **kw),
        "det": W.predicts_by_detections(data["img_root"], data["dets"], data["ann"], MODEL,
                                        out_path=str(one / "det.json"),
                                        filtered_out_path=str(one / "det_filtered.json"), **kw),
        "fused": fused_eval(data["img_root"], data["ann"], MODEL, pose_weights=data["weights"],
                            scale_name="s", det_conf=0.001, batch_size=2, input_shape=(64, 64),
                            max_people=4, canvas=192, det_size=(128, 128), decoder="basic",
                            amp=False, device="cpu", out_path=str(one / "fused.json"),
                            filtered_out_path=str(one / "fused_filtered.json")),
    }
    files = ["gt.json", "det.json", "det_filtered.json", "fused.json", "fused_filtered.json"]
    for name in files:
        got, ref = _sorted(work / name), _sorted(one / name)
        assert len(got) == len(ref) > 0, name
        for a, b in zip(got, ref):
            assert {k for k in a} == {k for k in b}
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-4, err_msg=name)
    for key, stats in want.items():
        for r in ranks:
            assert set(r[key]) == set(stats)
            for k in stats:
                assert r[key][k] == pytest.approx(stats[k], abs=1e-6), (key, k)
    assert sorted(ranks[0]["written"]) == sorted(files)
    assert ranks[1]["written"] == []
    for r in ranks:
        assert "one rank" in r["refusals"]["gen_detections"]
        assert "one rank" in r["refusals"]["fused_layer1"]
        assert r["scales"] == ranks[0]["scales"]
        assert set(r["scales"]) == set(r["local_scales"])
    for k, v in ranks[0]["scales"].items():
        assert v == pytest.approx(max(r["local_scales"][k] for r in ranks), rel=1e-6), k
        assert min(r["local_scales"][k] for r in ranks) <= v


def _train_cfg(data, work, mesh_data=-1):
    cfg = {
        "model_name": "test",
        "data": {"train_ann_path": data["ann"], "val_ann_path": data["ann"],
                 "train_img_root": data["img_root"], "val_img_root": data["img_root"],
                 "batch_size": 2, "num_workers": 1, "canvas": 192, "input_shape": [64, 64]},
        "model": MODEL,
        "optim": {"lr": 1e-3, "milestones": [1], "epochs": 1, "amp": False},
        "val": {"interval": 1, "weight_path": str(work / "weights")},
        "mesh": {"data": mesh_data},
        "seed": 11,
    }
    path = work / f"cfg_{mesh_data}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _run(args, cwd, torchrun=False):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    # --standalone: the agent binds its store on port 0 and keeps it
    cmd = [sys.executable] + (["-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", "2"] if torchrun else []) + args
    return subprocess.run(cmd, cwd=str(cwd), env=env, capture_output=True, text=True,
                          timeout=TIMEOUT)


def test_train_cli_mesh_devices_on_the_cpu(data, tmp_path):
    """``main --mesh-devices 2 --device cpu`` trains one epoch on two ranks
    and writes the checkpoint once; a config whose mesh.data is not the
    rank count fails, and so do two ranks on cards that are not there."""
    proc = _run(["-m", "simple_pose_torch.main", "--cfg", _train_cfg(data, tmp_path),
                 "--device", "cpu", "--mesh-devices", "2"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.path.exists(tmp_path / "weights" / "pose_resnet_dconv_last.pth")
    assert proc.stdout.count("eval epoch:1|") == 1  # rank 0 logs
    proc = _run(["-m", "simple_pose_torch.main", "--cfg", _train_cfg(data, tmp_path, 3),
                 "--device", "cpu", "--mesh-devices", "2"], tmp_path)
    assert proc.returncode != 0 and "mesh.data is 3" in proc.stderr
    if torch.cuda.device_count() < 2:
        proc = _run(["-m", "simple_pose_torch.main", "--cfg", _train_cfg(data, tmp_path),
                     "--mesh-devices", "2"], tmp_path)
        assert proc.returncode != 0 and "2 ranks need 2 CUDA devices" in proc.stderr


def test_eval_cli_gt_multihost_through_torchrun(data, tmp_path):
    """``torchrun --nproc_per_node=2 -m simple_pose_torch.eval gt
    --multihost --device cpu`` prints the stats once, equal to one
    process's, and writes the results file once."""
    args = ["-m", "simple_pose_torch.eval", "gt", "--img-root", data["img_root"],
            "--ann", data["ann"], "--model-name", "resnet18", "--weights", data["weights"],
            "--batch-size", "4", "--input-w", "64", "--input-h", "64", "--decoder", "basic",
            "--no-amp", "--device", "cpu"]
    one = _run(args + ["--out", str(tmp_path / "one.json")], tmp_path)
    assert one.returncode == 0, one.stderr[-3000:]
    two = _run(args + ["--out", str(tmp_path / "two.json"), "--multihost"], tmp_path,
               torchrun=True)
    assert two.returncode == 0, two.stderr[-3000:]
    stats = [json.loads(line) for line in two.stdout.splitlines() if line.startswith('{"AP"')]
    assert len(stats) == 1
    assert stats[0] == pytest.approx(json.loads(one.stdout.splitlines()[-1]), abs=1e-6)
    assert len(_sorted(tmp_path / "two.json")) == len(_sorted(tmp_path / "one.json"))
