"""Faults planted underneath the timed path, to show that ``correct`` comes
out false when the program goes wrong.  Each is a function that a driver
applies to what it drives: the serving evaluator (changed in place) or the
training step function (wrapped).

Serving:
  * ``answer_altered``: every served keypoint moved one heatmap pixel
    along x where the decode produces it;
  * ``half_batch``: the second half of each batch's outputs replaced by the
    first half's (half of the batch left out);
  * ``scores_one_pass``: the joint confidences and instance scores taken
    from the unflipped forward alone, the keypoints still from the merged
    maps (the flip-test merge left out of the scores).

Training:
  * ``state_unchanged``: the step computes its loss and leaves the model,
    Adam's moments and the EMA as they were;
  * ``half_batch``: the step sees the first half of the batch's crops only,
    its mean taken over those;
  * ``answer_altered``: the final layer's update doubled where the step
    produces it.
"""

from __future__ import annotations

import copy

import torch

__all__ = ["SERVE", "TRAIN"]


def _serve_answer_altered(ev):
    step = ev.step

    def altered(canvas, trans, trans_inv, canvas_idx=None, params=None):
        out = step(canvas, trans, trans_inv, canvas_idx, params)
        out["kps"] = out["kps"] + trans_inv[:, None, :, 0].float()
        return out

    ev.step = altered


def _serve_half_batch(ev):
    step = ev.step

    def half(canvas, trans, trans_inv, canvas_idx=None, params=None):
        out = step(canvas, trans, trans_inv, canvas_idx, params)
        n = out["kps"].shape[0] // 2
        return {k: torch.cat([v[:n], v[:n], v[2 * n:]]) for k, v in out.items()}

    ev.step = half


def _serve_scores_one_pass(ev):
    step = ev.step

    def one_pass(canvas, trans, trans_inv, canvas_idx=None, params=None):
        out = step(canvas, trans, trans_inv, canvas_idx, params)
        ev.flip_test = False
        try:
            single = step(canvas, trans, trans_inv, canvas_idx, params)
        finally:
            ev.flip_test = True
        return {**out, "conf": single["conf"], "scores": single["scores"]}

    ev.step = one_pass


def _train_state_unchanged(step_fn):
    def unchanged(state, batch):
        kept = (copy.deepcopy(state.model.state_dict()),
                copy.deepcopy(state.optimizer.state_dict()),
                {k: t.clone() for k, t in {**state.ema_params, **state.ema_buffers}.items()},
                state.step)
        state, metrics = step_fn(state, batch)
        state.model.load_state_dict(kept[0])
        state.optimizer.load_state_dict(kept[1])
        with torch.no_grad():
            for k, t in {**state.ema_params, **state.ema_buffers}.items():
                t.copy_(kept[2][k])
        state.step = kept[3]
        return state, metrics

    return unchanged


def _train_half_batch(step_fn):
    def half(state, batch):
        n = batch["trans"].shape[0] // 2
        cut = {k: (v[:n] if k != "canvas" else v) for k, v in batch.items()}
        return step_fn(state, cut)

    return half


def _train_answer_altered(step_fn):
    def altered(state, batch):
        w = state.model.final_layer.weight
        before = w.detach().clone()
        state, metrics = step_fn(state, batch)
        with torch.no_grad():
            w.add_(w - before)
        return state, metrics

    return altered


SERVE = {"answer_altered": _serve_answer_altered, "half_batch": _serve_half_batch,
         "scores_one_pass": _serve_scores_one_pass}
TRAIN = {"state_unchanged": _train_state_unchanged, "half_batch": _train_half_batch,
         "answer_altered": _train_answer_altered}
