"""The port's tracer (simple_pose_torch/utils/tracing.py) and its spans in the
serving call, the training step and the prefetcher, on the CPU; one case
pins pageable arrays on the card (``pytest --noconftest -m cuda``: this file
imports no JAX)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from simple_pose_torch.evalkit.workflows import PoseEvaluator
from simple_pose_torch.parallel.prefetch import device_prefetch
from simple_pose_torch.train.solver import init_train_state, make_train_step
from simple_pose_torch.utils import tracing

torch.set_num_threads(1)

R18 = {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17}
INPUT = (48, 64)  # (w, h)
CANVAS = 96


@pytest.fixture(autouse=True)
def _empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _serve_batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    s = CANVAS / 64.0
    return {
        "canvas": rng.integers(0, 255, (b, CANVAS, CANVAS, 3), dtype=np.uint8),
        "trans": np.tile(np.array([[1 / s, 0, 2], [0, 1 / s, 2]], np.float32), (b, 1, 1)),
        "trans_inv": np.tile(np.array([[4 * s, 0, 0], [0, 4 * s, 0]], np.float32), (b, 1, 1)),
    }


def _train_batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    joints = np.zeros((b, 17, 3), np.float32)
    joints[..., :2] = rng.uniform(0, 16, (b, 17, 2))
    joints[..., 2] = 1
    return {"canvas": rng.integers(0, 256, (b, CANVAS, CANVAS, 3), dtype=np.uint8),
            "trans": np.tile(np.array([[0.6, 0.05, 2], [-0.05, 0.6, 3]], np.float32), (b, 1, 1)),
            "joints": joints}


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def _check_tree(recs, root, children):
    """Each ``root`` span holds one of each of ``children``, in order, inside
    its interval, with its id and its seq as their parent."""
    names = _by_name(recs)
    for top in names[root]:
        assert top.parent is None and top.start_ns <= top.end_ns
        kids = sorted((r for r in recs if r.parent == top.seq), key=lambda r: r.start_ns)
        assert [k.name for k in kids] == children
        for k in kids:
            assert k.id == top.id
            assert top.start_ns <= k.start_ns <= k.end_ns <= top.end_ns
    return names


def test_nothing_is_recorded_without_a_profile():
    ev = PoseEvaluator(R18, None, INPUT, amp=False, flip_test=True, device="cpu")
    ev(_serve_batch())
    with tracing.span("outer"):
        tracing.add("n", 1)
    assert tracing.records() == []
    assert tracing.span("a") is tracing.span("b")  # one shared null context
    assert not tracing.enabled()


def test_serving_call_spans_under_the_profiler():
    """Flip-test serving on the CPU: serve.call (the call's number) holds
    serve.h2d, then serve.device; nothing on the CPU counts as pageable, and
    the profiler shows every span as an sp.* range."""
    ev = PoseEvaluator(R18, None, INPUT, amp=False, flip_test=True, device="cpu")
    batch = _serve_batch()
    ev(batch)  # call 1, untraced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = ev(batch)
        ev(batch)
    assert out["kps"].shape == (2, 17, 2)
    names = _check_tree(tracing.records(), "serve.call", ["serve.h2d", "serve.device"])
    assert [r.id for r in names["serve.call"]] == [2, 3]
    assert all(r.counters == {} for r in tracing.records())
    ranges = [e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    assert sorted(set(ranges)) == ["sp.serve.call", "sp.serve.device", "sp.serve.h2d"]
    assert ranges.count("sp.serve.call") == 2


def test_train_step_spans_under_the_profiler():
    """train.step (id: state.step on entry) holds forward, backward and
    update, in that order."""
    cfg = {"data": {"batch_size": 2, "input_shape": [64, 64]}, "model": R18,
           "optim": {"lr": 1e-3, "milestones": [5], "epochs": 8, "amp": False}}
    state = init_train_state(cfg, device="cpu", steps_per_epoch=1)
    step = make_train_step(out_shape=(16, 16), crop_shape=(64, 64))
    state, _ = step(state, _train_batch(seed=1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, m = step(state, _train_batch(seed=2))
        state, _ = step(state, _train_batch(seed=3))
    assert torch.isfinite(m["loss"]) and state.step == 3
    names = _check_tree(tracing.records(), "train.step",
                        ["train.forward", "train.backward", "train.update"])
    assert [r.id for r in names["train.step"]] == [1, 2]
    ranges = {e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)}
    assert ranges == {"sp.train.step", "sp.train.forward", "sp.train.backward",
                      "sp.train.update"}


def test_prefetch_on_the_cpu_stages_without_pinning():
    """Each staged batch is a prefetch.stage root with the batch's number;
    the CPU pins nothing, so no prefetch.pin and no pinned_bytes."""
    host = [{"x": np.full((4, 2), i, np.float32)} for i in range(3)]
    with tracing.recording():
        got = [int(b["x"][0, 0]) for b in device_prefetch(iter(host), "cpu", depth=2)]
    assert got == [0, 1, 2]
    recs = tracing.records()
    assert [(r.name, r.id, r.parent) for r in recs] == [("prefetch.stage", i, None)
                                                        for i in range(3)]
    assert all(r.counters.get("pinned_bytes", 0) == 0 for r in recs)


def test_recording_records_without_a_profiler():
    """recording() turns the tracer on alone: nested spans take their
    parent's id and seq, add() counts into the innermost, and nothing
    becomes a profiler range."""
    with tracing.recording():
        assert tracing.enabled()
        with tracing.span("outer", id=7):
            tracing.add("bytes", 3)
            with tracing.span("inner"):
                tracing.add("bytes", 2)
                tracing.add("bytes", 5)
            with tracing.span("other", id=9):
                pass
    assert not tracing.enabled()
    inner, other, outer = tracing.records()
    assert (outer.name, outer.id, outer.parent, outer.counters) == ("outer", 7, None,
                                                                    {"bytes": 3})
    assert (inner.name, inner.id, inner.parent, inner.counters) == ("inner", 7, outer.seq,
                                                                    {"bytes": 7})
    assert (other.id, other.parent) == (9, outer.seq)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= other.start_ns <= outer.end_ns


def test_the_buffer_stays_bounded():
    with tracing.recording():
        for i in range(tracing.MAX_SPANS + 10):
            with tracing.span("s", id=i):
                pass
    recs = tracing.records()
    assert len(recs) == tracing.MAX_SPANS
    assert recs[0].id == 10 and recs[-1].id == tracing.MAX_SPANS + 9
    tracing.clear()
    assert tracing.records() == []


@pytest.mark.cuda
def test_prefetch_pins_pageable_arrays_on_the_card():
    """On the card each staging of pageable arrays holds one prefetch.pin
    counting their bytes; arrays already pinned are not counted."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: pinning host memory needs the card")
    pageable = {"a": np.zeros((64, 64), np.float32), "b": np.zeros(10, np.int32)}
    pinned = {"a": torch.zeros(64, 64).pin_memory(), "b": torch.zeros(10, dtype=torch.int32)}
    with tracing.recording():
        out = list(device_prefetch(iter([pageable, pinned]), "cuda", depth=2))
    torch.cuda.synchronize()
    assert out[0]["a"].is_cuda and out[1]["b"].is_cuda
    names = _by_name(tracing.records())
    assert [r.id for r in names["prefetch.stage"]] == [0, 1]
    pins = names["prefetch.pin"]
    assert [p.counters["pinned_bytes"] for p in pins] == [64 * 64 * 4 + 40, 40]
    stages = {s.seq: s.id for s in names["prefetch.stage"]}
    assert [stages[p.parent] for p in pins] == [0, 1]
