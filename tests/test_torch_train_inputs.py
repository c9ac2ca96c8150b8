"""One train step of the port against the JAX package on the inputs the
three-step test (tests/test_torch_train.py) does not cover: the biased
target encoding, and a dedup'd batch whose crops gather their canvases by
``canvas_idx``.  Same limits: loss to 1e-4 relative, trees to
|port - jax| / |jax update| <= 1e-2 per tensor."""

import pytest
import torch

from tests import torch_train_pair as P

torch.set_num_threads(1)


@pytest.mark.parametrize("inputs", ["biased_encoding", "canvas_idx"])
def test_one_step_matches_jax(monkeypatch, inputs):
    P.jax_crops_as_tested(monkeypatch)
    if inputs == "biased_encoding":
        run = P.run_steps(P.config(), 1, encoding="biased")
    else:  # 2 crops from 1 canvas
        run = P.run_steps(P.config(), 1, canvases=1)
    metrics, before, model_pair, ema_pair, _ = run
    P.check_metrics(metrics)
    P.check_trees(before, model_pair, ema_pair)
