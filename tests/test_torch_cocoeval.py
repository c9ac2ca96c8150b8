"""The port's COCO keypoint evaluator (simple_pose_torch/metrics/cocoeval.py)
against the JAX package's on every corner-case scenario of
tests/cocoeval_scenarios.py (crowd absorption, ignore areas, zero-visible
ground truth, duplicates, ties, more detections than maxDets): the 10
stats to 1e-12, at the reference's maxDets 20 and at 2, which the
detector-chain gate's perturbation uses."""

import numpy as np
import pytest

from simple_pose_torch.metrics import cocoeval as tce
from simple_pose_tpu.metrics import cocoeval as jce
from tests.cocoeval_scenarios import build_scenarios

SCENARIOS = build_scenarios()
STATS = ("AP", "Ap .5", "AP .75", "AP (M)", "AP (L)", "AR", "AR .5", "AR .75", "AR (M)",
         "AR (L)")


def _stats(mod, case, max_dets):
    ev = mod.KeypointEval(mod.CocoKeypointsGT(case["gt"]), case["results"], max_dets=max_dets)
    ev.evaluate()
    ev.accumulate()
    return ev.summarize()


@pytest.mark.parametrize("max_dets", [20, 2])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_cocoeval_equals_jax_on_scenario(name, max_dets):
    case = SCENARIOS[name]
    want = _stats(jce, case, max_dets)
    got = _stats(tce, case, max_dets)
    assert set(got) == set(want) == set(STATS)
    for k in STATS:
        assert abs(got[k] - want[k]) <= 1e-12, (name, k, got[k], want[k])
    assert any(v > 0.0 for v in got.values()), got  # something matched


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_evaluate_map_equals_jax_on_scenario(name, tmp_path):
    """evaluate_map from a results file and a GT file, as the AP ladder
    calls it."""
    import json

    case = SCENARIOS[name]
    ann, res = tmp_path / "gt.json", tmp_path / "res.json"
    ann.write_text(json.dumps(case["gt"]))
    res.write_text(json.dumps(case["results"]))
    want = jce.evaluate_map(str(res), str(ann))
    got = tce.evaluate_map(str(res), str(ann))
    assert set(got) == set(want)
    np.testing.assert_allclose([got[k] for k in STATS], [want[k] for k in STATS], rtol=0,
                               atol=1e-12)
