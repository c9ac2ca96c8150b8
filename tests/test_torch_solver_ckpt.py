"""The port's PoseSolver on its own (no JAX): torch checkpoints and resume,
model.remat with the BatchNorm double-update trap, device_prefetch and the
training CLI (simple_pose_torch/train/solver.py, models/resnet.py,
parallel/prefetch.py, main.py).  resnet18 at 64x64, batch 8, f32, on
synthetic COCO."""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import simple_pose_torch.models.resnet as R
from simple_pose_torch.evalkit.workflows import PoseEvaluator
from simple_pose_torch.ops import affine as A
from simple_pose_torch.parallel.prefetch import device_prefetch
from simple_pose_torch.train.solver import PoseSolver, init_train_state, make_train_step
from tests.util_synth import make_synth_coco

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEOPLE = [1, 3, 1, 4, 2, 1, 1, 3, 2, 1, 2, 2]  # 23 records: 2 plain, 3 dedup batches of 8
R18 = {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17}


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    img_root, ann_path, _ = make_synth_coco(str(root), num_images=len(PEOPLE),
                                            people_per_image=PEOPLE, seed=1)
    return img_root, ann_path


def _cfg(coco, weight_path, epochs=2, **model):
    img_root, ann_path = coco
    return {
        "model_name": "test",
        "data": {"train_ann_path": ann_path, "val_ann_path": ann_path,
                 "train_img_root": img_root, "val_img_root": img_root,
                 "batch_size": 8, "num_workers": 2, "canvas": 192, "input_shape": [64, 64]},
        "model": {**R18, **model},
        "optim": {"lr": 1e-3, "milestones": [1], "epochs": epochs, "amp": False},
        "val": {"interval": 1, "weight_path": str(weight_path)},
        "seed": 11,
    }


def _tensors(solver):
    """Every tensor of the state: the model, the EMA copies and the
    optimizer's moments, as CPU copies."""
    st = solver.state
    out = {f"model.{k}": v.detach().clone() for k, v in st.model.state_dict().items()}
    out.update({f"ema.{k}": v.clone() for k, v in {**st.ema_params, **st.ema_buffers}.items()})
    names = {id(p): k for k, p in st.model.named_parameters()}
    for p, s in st.optimizer.state.items():
        for key, v in s.items():
            out[f"opt.{names[id(p)]}.{key}"] = torch.as_tensor(v).clone()
    return out


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_checkpoint_roundtrip_and_next_step(coco, tmp_path, capsys):
    solver = PoseSolver(_cfg(coco, tmp_path / "w"), device="cpu")
    solver.init_state()
    solver.train_epoch(0, log_every=0)
    steps = solver.state.step
    assert steps == 3 and solver._steps_per_epoch == 2  # dedup packs 3, the schedule counts 2
    solver.save_checkpoint(0, 0.25)
    solver.save_checkpoint(0, 0.125)  # no better: _best keeps the 0.25 save
    assert solver.best_ap == 0.25
    last = solver.checkpoint_path()
    best = solver.checkpoint_path("pose_resnet_dconv_best")
    assert os.path.basename(last) == "pose_resnet_dconv_last.pth" and os.path.exists(best)
    assert torch.load(best)["val_ap"] == 0.25 and torch.load(last)["val_ap"] == 0.125
    saved = _tensors(solver)

    fresh = PoseSolver(_cfg(coco, tmp_path / "w"), device="cpu")
    assert fresh.restore_checkpoint() == 1
    assert fresh.state.step == steps and fresh.best_ap == 0.125
    _assert_equal(_tensors(fresh), saved)

    # the next step from the restored solver is the original's, bit for bit
    batch = next(iter(solver.train_pipe.epoch(1)))
    for s in (solver, fresh):
        s._compile()
    _, m_orig = solver._train_step(solver.state, batch)
    _, m_rest = fresh._train_step(fresh.state, batch)
    assert torch.equal(m_rest["loss"], m_orig["loss"])
    _assert_equal(_tensors(fresh), _tensors(solver))

    # the _best file is a reference-layout checkpoint: PoseEvaluator loads
    # its ['ema'] with no missing and no unexpected keys
    capsys.readouterr()
    ev = PoseEvaluator(R18, best, (64, 64), amp=False, device="cpu")
    assert "missing" not in capsys.readouterr().out
    ema = torch.load(best)["ema"]
    assert set(ema) == set(ev.model.state_dict())
    for k, v in ev.model.state_dict().items():
        assert torch.equal(v, ema[k]), k


def test_run_resume_continues_and_missing_file_starts_at_zero(coco, tmp_path, capsys):
    first = PoseSolver(_cfg(coco, tmp_path / "w", epochs=1), device="cpu")
    first.best_ap = -1.0  # AP is 0 at this size; write _best all the same
    first.run()
    per_epoch = first.state.step
    assert os.path.exists(first.checkpoint_path("pose_resnet_dconv_best"))
    capsys.readouterr()

    again = PoseSolver(_cfg(coco, tmp_path / "w", epochs=2), device="cpu")
    again.run(resume=True)
    out = capsys.readouterr().out
    assert "resumed at epoch 1" in out and "train epoch:  1" not in out
    assert "eval epoch:2|" in out and "eval epoch:1|" not in out
    assert again.state.step == per_epoch + len(again.train_pipe._pack_epoch(1))

    empty = PoseSolver(_cfg(coco, tmp_path / "none", epochs=1), device="cpu")
    empty.run(resume=True)
    assert "resumed" not in capsys.readouterr().out and empty.state.step == per_epoch


# -- model.remat -------------------------------------------------------------


def _batch(seed, n=4, canvas=96, crop=64, out=16):
    rng = np.random.default_rng(seed)
    trans = np.stack([A.get_affine_transform(rng.uniform(30, 60, 2), np.array([60.0, 60.0]),
                                             rng.uniform(-40, 40), (crop, crop))[0]
                      for _ in range(n)]).astype(np.float32)
    joints = np.zeros((n, 17, 3), np.float32)
    joints[..., :2] = rng.uniform(0, out, (n, 17, 2))
    joints[..., 2] = rng.uniform(0, 1, (n, 17)) < 0.8
    return {"canvas": rng.integers(0, 256, (n, canvas, canvas, 3), dtype=np.uint8),
            "trans": trans, "joints": joints}


def _remat_step(remat):
    cfg = {"model": {**R18, "remat": remat}, "optim": {"amp": False},
           "data": {"input_shape": [64, 64]}}
    state = init_train_state(cfg, device="cpu")
    step = make_train_step((16, 16), (64, 64))
    state, _ = step(state, _batch(1))  # Adam moments set
    state, m = step(state, _batch(2))
    return m["loss"].item(), state.model.state_dict()


def _stats(sd):
    return {k: v for k, v in sd.items() if "running_" in k or "num_batches" in k}


# Sum-order tolerance for the remat comparison: the recompute runs the same
# f32 ops on the same inputs, so only a reordered reduction could move a
# value (measured: bit-identical on the CPU).
REMAT_REL = 1e-6


def test_remat_matches_no_remat():
    loss_off, sd_off = _remat_step(False)
    loss_on, sd_on = _remat_step(True)
    assert abs(loss_on / loss_off - 1) <= REMAT_REL
    for k, v in sd_off.items():
        if k in _stats(sd_off):
            assert torch.equal(sd_on[k], v), k  # BN statistics move once, as without remat
        else:
            scale = v.abs().max().clamp_min(1e-12)
            assert ((sd_on[k] - v).abs().max() / scale).item() <= REMAT_REL, k


def test_remat_without_frozen_recompute_updates_bn_twice(monkeypatch):
    """The trap the recompute context guards against: without it, backward's
    recompute moves every rematerialized BatchNorm's statistics again."""
    _, sd_off = _remat_step(False)
    monkeypatch.setattr(R, "_recompute_contexts",
                        lambda block: (contextlib.nullcontext(), contextlib.nullcontext()))
    _, sd_twice = _remat_step(True)
    moved = [k for k in _stats(sd_off) if not torch.equal(sd_twice[k], sd_off[k])]
    assert any(k.startswith("layer1.0.bn1.") for k in moved)
    assert not any(k.startswith(("bn1.", "deconv_layers.")) for k in moved)  # not checkpointed
    assert sd_twice["layer1.0.bn1.num_batches_tracked"] == 2 * sd_off[
        "layer1.0.bn1.num_batches_tracked"]


def test_remat_checkpoints_only_in_training(monkeypatch):
    """In eval mode and under no_grad no block is checkpointed."""
    model = R.build_resnet("resnet18", remat=True).train()
    calls = []
    orig = R.checkpoint

    def counted(fn, x, **kw):
        calls.append(fn)
        return orig(fn, x, **kw)

    monkeypatch.setattr(R, "checkpoint", counted)
    with torch.no_grad():
        model(torch.zeros(1, 3, 64, 64))
    model.eval()(torch.zeros(1, 3, 64, 64))
    assert not calls
    model.train()(torch.zeros(2, 3, 64, 64))
    assert len(calls) == 8  # resnet18: 4 stages x 2 blocks


# -- device_prefetch -----------------------------------------------------------


def test_device_prefetch_order_and_flight_depth():
    """Every batch in order, at most ``depth`` staged ahead of the consumer,
    device keys as tensors sharing the host memory, others passed through."""
    staged = []
    host = []

    def batches():
        for i in range(5):
            staged.append(i)
            b = {"x": np.full((8, 2), i, np.float32), "meta": np.array([i])}
            host.append(b)
            yield b

    out = []
    for i, b in enumerate(device_prefetch(batches(), "cpu", depth=2, device_keys=("x",))):
        assert isinstance(b["x"], torch.Tensor) and int(b["x"][0, 0]) == i
        assert isinstance(b["meta"], np.ndarray) and b["meta"] is host[i]["meta"]
        assert np.shares_memory(b["x"].numpy(), host[i]["x"])
        # the producer may run at most `depth` ahead of what was consumed
        assert len(staged) <= i + 2 + 1
        out.append(i)
    assert out == list(range(5))
    assert [int(b["x"][0, 0]) for b in device_prefetch(iter(host), "cpu", depth=3)] == out


# -- the CLI -------------------------------------------------------------------


def test_train_cli_one_epoch(coco, tmp_path):
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(json.dumps(_cfg(coco, tmp_path / "w", epochs=1)))  # JSON is YAML
    proc = subprocess.run(
        [sys.executable, "-m", "simple_pose_torch.main", "--cfg", str(cfg_path),
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert "eval epoch:1|" in proc.stdout
    ckpt = torch.load(tmp_path / "w" / "pose_resnet_dconv_last.pth")
    assert ckpt["epoch"] == 0 and ckpt["step"] == 3


_JSON_CFG = r"""
import sys
sys.modules["yaml"] = None  # the card's machine has no PyYAML
from simple_pose_torch.train.config import load_config
cfg = load_config(sys.argv[1])
print(cfg.data.batch_size, cfg.model.name, cfg.seed)
"""


def test_load_config_reads_json_without_yaml(coco, tmp_path):
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(_cfg(coco, tmp_path / "w")))
    proc = subprocess.run([sys.executable, "-c", _JSON_CFG, str(cfg_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["8", "resnet18", "11"]
