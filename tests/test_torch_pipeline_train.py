"""The port's PosePipeline (simple_pose_torch/data/pipeline.py) against the JAX
package's, built with use_native=False, on synthetic COCO JPEGs with a skewed
instance count per image.  Both are numpy on the host, so every batch must
be equal exactly, key for key, in epochs 0 and 1."""

import dataclasses

import numpy as np
import pytest

from simple_pose_torch.data import coco as tcoco
from simple_pose_torch.data import pipeline as tpipe
from simple_pose_tpu.data import coco as jcoco
from simple_pose_tpu.data import pipeline as jpipe
from tests.util_synth import make_synth_coco

PEOPLE = [1, 3, 1, 4, 2, 1, 1, 3, 2, 1]  # 19 records on 10 images


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    img_root, ann_path, _ = make_synth_coco(str(root), num_images=len(PEOPLE),
                                            people_per_image=PEOPLE, seed=3)
    return (jcoco.load_coco_keypoints(img_root, ann_path),
            tcoco.load_coco_keypoints(img_root, ann_path))


CASES = {
    "augment": dict(),
    "plain_keep_last": dict(augment=False, drop_last=False),
    "dedup": dict(dedup_canvases=2),
    "dedup_2_buckets_keep_last": dict(dedup_canvases=4, dedup_buckets=2, drop_last=False),
    "eval_layout": dict(augment=False, shuffle=False, drop_last=False, dedup_canvases=2),
    "process_0_of_2_dedup": dict(process_count=2, process_index=0, dedup_canvases=2),
    "process_1_of_2_dedup": dict(process_count=2, process_index=1, dedup_canvases=2),
    "process_1_of_2_keep_last": dict(process_count=2, process_index=1, drop_last=False),
    "narrow_aug_no_flip": dict(aug_scale=(0.9, 1.1), aug_rot=(-12, 12), aug_flip=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_jax(records, case):
    jrecs, trecs = records
    kw = dict(batch_size=4, input_shape=(64, 64), output_shape=(16, 16), canvas=192, seed=7,
              num_threads=2, **CASES[case])
    jp = jpipe.PosePipeline(jrecs, use_native=False, **kw)
    tp = tpipe.PosePipeline(trecs, **kw)
    assert tp.batches_per_epoch() == jp.batches_per_epoch()
    for epoch in (0, 1):
        if kw.get("dedup_canvases"):
            assert tp.dedup_batches_per_epoch(epoch) == jp.dedup_batches_per_epoch(epoch)
        want, got = list(jp.epoch(epoch)), list(tp.epoch(epoch))
        assert len(got) == len(want) > 0, (len(got), len(want))
        for bw, bt in zip(want, got):
            assert set(bt) == set(bw)
            for k in bw:
                assert bt[k].dtype == bw[k].dtype and bt[k].shape == bw[k].shape, k
                np.testing.assert_array_equal(bt[k], bw[k], err_msg=f"{case} {epoch} {k}")
    # the epochs differ: the order and the augmentation draws move with the epoch
    if kw.get("augment", True):
        e0, e1 = next(iter(tp.epoch(0))), next(iter(tp.epoch(1)))
        assert not np.array_equal(e0["trans"], e1["trans"])


def test_sample_transform_bit_for_bit(records):
    """200 seeded (record, rng) pairs through both _SampleTransforms, flips
    included."""
    jrecs, trecs = records
    jt = jpipe._SampleTransform(input_shape=(192, 256), output_shape=(48, 64))
    tt = tpipe._SampleTransform(input_shape=(192, 256), output_shape=(48, 64))
    flips = 0
    for i in range(200):
        r = i % len(trecs)
        assert dataclasses.astuple(trecs[r])[:4] == dataclasses.astuple(jrecs[r])[:4]
        want = jt(jrecs[r], np.random.default_rng((5, i)), True)
        got = tt(trecs[r], np.random.default_rng((5, i)), True)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        flips += int(got[0][0, 0] < 0)  # a flip folded in negates the x column
    assert 60 < flips < 140, flips
    plain = tt(trecs[0], np.random.default_rng(0), False)
    for w, g in zip(jt(jrecs[0], np.random.default_rng(0), False), plain):
        np.testing.assert_array_equal(g, w)
