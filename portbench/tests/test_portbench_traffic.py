"""The general traffic generator: one seed, one pool; another seed, other
content and geometry, but the same work."""

import numpy as np
import pytest

from portbench.gen import make_pool
from portbench.run import load_cell


def mix(workload, pool_batches=2):
    cell = load_cell(workload)
    return {**cell["traffic"], "input_wh": cell["config"]["input_wh"], "num_joints": 17,
            "pool_batches": pool_batches}


@pytest.mark.parametrize("workload", ["resnet50_dconv_se.serve_b128",
                                      "resnet50_dconv_se.train_b128"])
def test_a_seed_repeats_and_another_differs(workload):
    m = mix(workload)
    a, b, c = make_pool(m, 2 ** 33 + 1), make_pool(m, 2 ** 33 + 1), make_pool(m, 2 ** 33 + 2)
    for x, y, z in zip(a, b, c):
        assert set(x) == set(y) == set(z)
        for k in x:
            assert np.array_equal(x[k], y[k]), k
            assert x[k].shape == z[k].shape and x[k].dtype == z[k].dtype, k
        for k in ("canvas", "trans", "joints", "canvas_idx"):
            assert not np.array_equal(x[k], z[k]), k


@pytest.mark.parametrize("workload", ["resnet50_dconv_se.serve_b128",
                                      "resnet50_dconv_se.train_b128"])
def test_every_batch_holds_the_same_work(workload):
    m = mix(workload, pool_batches=3)
    for seed in (5, 2 ** 40 + 3):
        for batch in make_pool(m, seed):
            assert batch["canvas"].shape == (m["canvas_slots"], 640, 640, 3)
            assert batch["trans"].shape == (m["batch"], 2, 3)
            used = np.unique(batch["canvas_idx"])
            assert used[0] == 0 and np.array_equal(used, np.arange(len(used)))
            assert len(used) <= m["canvas_slots"]
            assert (batch["canvas"][len(used):] == 0).all()
            people = np.bincount(batch["canvas_idx"])
            assert people.max() <= len(m["people_odds"])


def test_serving_geometry_is_unrotated_and_training_is_augmented():
    serve = make_pool(mix("resnet50_dconv_se.serve_b128"), 9)[0]
    train = make_pool(mix("resnet50_dconv_se.train_b128"), 9)[0]
    assert np.all(serve["rot"] == 0) and np.allclose(serve["trans"][:, 0, 1], 0, atol=1e-6)
    assert np.abs(train["rot"]).max() > 10 and np.abs(train["rot"]).max() <= 40
