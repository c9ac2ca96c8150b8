"""The comparisons that decide ``correct``: numbers that the program's
outputs give against the plain reference's, each held to a limit of its own.

A cell's limits are ``limits/<workload>.json``: {number: limit}, each set
between the largest reading of sound runs of the program over many seeds
and the smallest of its control (PERF.md gives both readings).  A limited
number that is not finite, or exceeds its limit, makes the run not
correct.  The other numbers are reported beside them.

Serving: what ``PoseEvaluator.__call__`` returned for one served batch of
each pool batch, against the reference's float32 heatmaps of the same crops,
flip-test merged, and their Gauss-Taylor decode.  A served keypoint is
taken back into heatmap pixels through its crop's heatmap affine and
judged where the reference's map has a clear peak and a well-posed Newton
step: the peak exceeds every value more than 2 pixels (Chebyshev) from it
by ``PEAK_MARGIN`` of the sample's median peak, and the reference's Newton
step is at most ``MAX_STEP_PX``.  Elsewhere the decode is not a function of
the heatmap that two precisions agree on: on drawn weights the maps are
noise-like, two peaks can lie within rounding of each other (a bf16 pass
moved one by 42.8 px on trained weights), and a Newton step from a raw
argmax far from the blurred map's maximum divides by a near-singular
Hessian.  The rule reads the reference alone.

  * ``kp_p95_px``, ``kp_p90_px``: that quantile of the judged keypoints'
    distances from the reference's, in heatmap pixels;
  * ``kp_far_share``: the share of judged keypoints more than a pixel off;
  * ``conf_gap`` / ``conf_rms``: the widest / root-mean-square gap between
    a served joint confidence (the peak of its merged map) and the
    reference's peak, over the larger of that peak and the median peak;
  * ``score_gap`` / ``score_rms``: the same for each crop's instance score.

Training: three steps of the program from the benchmark's weights against
three float32 reference steps from the same weights on the same batches.
Each number is a gap between two norms (not the norm of a difference) over
the larger of the reference's norm of that leaf and of the median leaf:

  * ``grad_gap`` / ``grad_median_gap``: the worst / the median parameter's
    gap of the first step's gradient as Adam received it (its first moment
    after one step over 1 - beta1);
  * ``change_gap`` / ``change_median_gap``: the same for each parameter's
    change over the three steps, read before step 4;
  * ``change_kernel_gap``: the widest of those gaps over the conv kernels
    (parameters of two or more dimensions) alone.  Adam moves every
    element by about the learning rate whatever its gradient, so in a
    BatchNorm vector of 32-64 channels the few whose first gradient lies
    under its own bf16 error can move the vector's norm by a tenth or more;
  * ``ema_gap`` / ``ema_median_gap``: the same for each EMA tensor's change
    (the parameters' and BatchNorm's running statistics');
  * ``loss_gap``: the widest relative gap of a step's loss; ``loss1_gap``
    the first step's.

A parameter whose reference gradient norm is under ``NOUGHT`` of the median
leaf's is left out of the gradient and change numbers: its gradient is
nought but for rounding (a bias under a BatchNorm), and Adam turns
rounding into steps of the learning rate.
"""

from __future__ import annotations

import json
import math
import os

import torch

__all__ = ["serve_numbers", "train_numbers", "load_limits", "judge", "PEAK_MARGIN",
           "MAX_STEP_PX", "NOUGHT"]

PEAK_MARGIN = 0.05
MAX_STEP_PX = 1.0
NOUGHT = 1e-3


def _rel_gap(got, want, floor):
    return (got - want).abs() / torch.maximum(want.abs(), torch.as_tensor(floor))


def _second_peak(heat, coords, radius=2):
    b, j, h, w = heat.shape
    ys = torch.arange(h, device=heat.device)[:, None]
    xs = torch.arange(w, device=heat.device)[None, :]
    far = ((xs - coords[..., 0, None, None]).abs() > radius) | (
        (ys - coords[..., 1, None, None]).abs() > radius)
    return torch.where(far, heat, torch.full_like(heat, -math.inf)).reshape(b, j, -1).amax(-1)


def _quantile(t, q):
    return float(torch.quantile(t.double(), q)) if t.numel() else math.inf


def serve_numbers(ref, served, heat_affine) -> dict:
    """ref: the reference's merged heatmaps [N, J, h, w] and their decode
    (reference/ops.decode: coords, peak, step); served: {kps [N, J, 2],
    conf [N, J, 1], scores [N]} from the program; heat_affine [N, 2, 3]:
    image -> heatmap."""
    ref_heat, ref_coords, ref_peak, ref_step = ref
    peak_scale = ref_peak.abs().median()
    conf_err = _rel_gap(served["conf"][..., 0].float(), ref_peak, peak_scale)
    ref_scores = ref_peak.mean(-1) + ref_peak.amax(-1)
    score_err = _rel_gap(served["scores"].float(), ref_scores, ref_scores.abs().median())
    kps = served["kps"].float()
    xyz = torch.cat([kps, torch.ones_like(kps[..., :1])], -1)
    u = torch.einsum("njd,nad->nja", xyz, heat_affine.float())
    clear = (ref_peak - _second_peak(ref_heat, ref_coords)) > PEAK_MARGIN * peak_scale
    posed = ref_step.norm(dim=-1) <= MAX_STEP_PX
    judged = clear & posed & (ref_peak > 0)
    dist = (u - ref_coords).norm(dim=-1)[judged]
    return {"kp_p95_px": _quantile(dist, 0.95), "kp_p90_px": _quantile(dist, 0.9),
            "kp_far_share": float((dist > 1.0).double().mean()) if dist.numel() else math.inf,
            "kp_judged": int(judged.sum()),
            "conf_gap": float(conf_err.max()), "conf_rms": float(conf_err.pow(2).mean().sqrt()),
            "score_gap": float(score_err.max()),
            "score_rms": float(score_err.pow(2).mean().sqrt())}


def _leaf_gaps(got: dict, want: dict, keys):
    """|got - want| / max(want, median of want) for each of ``keys``."""
    keys = list(keys)
    w = torch.tensor([want[k] for k in keys], dtype=torch.float64)
    g = torch.tensor([got[k] for k in keys], dtype=torch.float64)
    return (g - w).abs() / torch.maximum(w, w.median())


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"loss": [3 floats], "grad": {param: norm}, "change":
    {param: norm}, "ema": {ema tensor: norm}}, and ref["kernels"]: the
    parameters of two or more dimensions.  ``<name>_worst`` names the
    leaf of each widest gap."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    med = float(torch.tensor(list(ref["grad"].values()), dtype=torch.float64).median())
    counted = [k for k, v in ref["grad"].items() if v >= NOUGHT * med]
    ema_keys = [k for k in ref["ema"] if k not in ref["grad"] or k in counted]
    out = {"loss_gap": max(losses), "loss1_gap": losses[0]}
    for name, keys in (("grad", counted), ("change", counted), ("ema", ema_keys)):
        gaps = _leaf_gaps(prog[name], ref[name], keys)
        out[f"{name}_gap"] = float(gaps.max())
        out[f"{name}_median_gap"] = float(gaps.median())
        out[f"{name}_worst"] = keys[int(gaps.argmax())]
    kernels = [i for i, k in enumerate(counted) if k in set(ref["kernels"])]
    gaps = _leaf_gaps(prog["change"], ref["change"], counted)[kernels]
    out["change_kernel_gap"] = float(gaps.max())
    out["change_kernel_worst"] = counted[kernels[int(gaps.argmax())]]
    out.update(leaves_counted=len(counted), leaves=len(ref["grad"]))
    return out


def load_limits(root: str, workload: str) -> dict:
    path = os.path.join(root, "limits", f"{workload}.json")
    with open(path) as f:
        return json.load(f)["limits"]


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [[name, number, limit], ...]) over the limited numbers."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        rows.append([name, value, limit])
        ok = ok and math.isfinite(value) and value <= limit
    return ok, rows
