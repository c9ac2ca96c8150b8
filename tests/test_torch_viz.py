"""The port's cv2-free drawing and PNG writer (simple_pose_torch/utils/viz.py)
against the JAX package's utils/viz.py (cv2) and cv2 itself.  Every case
is held pixel for pixel: shapes inside the image, and shapes that leave it
(cv2 clips a thick line to the image grown by 2 px before drawing, and the
port does the same)."""

import cv2 as cv
import numpy as np
import pytest

from simple_pose_torch.utils import viz as tviz
from simple_pose_tpu.utils import viz as jviz

H, W = 120, 160


def _joints(rng, spread, vis_p=0.8):
    """[17, 3] seeded joints around the image centre: x, y with a fraction,
    visibility 0 or a confidence."""
    xy = rng.normal((W / 2, H / 2), spread, (17, 2))
    vis = np.where(rng.uniform(size=17) < vis_p, rng.uniform(0.05, 1.0, 17), 0.0)
    return np.concatenate([xy, vis[:, None]], -1)


# name: (joint spread in px, with a box); "leaving" puts joints and box
# corners well outside the 160x120 image
POSES = {"inside": (18.0, False), "inside_box": (18.0, True), "leaving": (120.0, True)}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("pose", sorted(POSES))
def test_draw_pose_matches_jax(pose, seed):
    spread, with_box = POSES[pose]
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    for _ in range(2):  # two people
        joints = _joints(rng, spread)
        box = None
        if with_box:
            box = tuple(np.sort(rng.normal((W / 2, H / 2), spread * 1.5, (2, 2)), 0).T.ravel()
                        [[0, 2, 1, 3]])
        got, want = tviz.draw_pose(img, joints, box=box), jviz.draw_pose(img, joints, box=box)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, want)
        assert (got != img).any() or pose == "leaving"
        img = got


@pytest.mark.parametrize("shape", ["circle", "line", "rectangle"])
def test_shapes_match_cv2(shape):
    """cv2's circle(r=2, filled), line(thickness 2) and rectangle(thickness 2),
    LINE_8, on random integer points from 2 px to 300 px outside the image."""
    rng = np.random.default_rng({"circle": 0, "line": 1, "rectangle": 2}[shape])
    for _ in range(300):
        p = tuple(int(v) for v in rng.integers(-300, 400, 2))
        q = tuple(int(v) for v in rng.integers(-40, 200, 2))
        want, got = np.zeros((60, 80, 3), np.uint8), np.zeros((60, 80, 3), np.uint8)
        color = tuple(int(v) for v in rng.integers(1, 256, 3))
        if shape == "circle":
            cv.circle(want, q, 2, color, -1)
            tviz._circle(got, *q, 2, color)
        elif shape == "line":
            cv.line(want, p, q, color, 2)
            tviz._thick_line(got, p, q, color, caps=3)
        else:
            cv.rectangle(want, p, q, color, 2)
            corners = [p, (q[0], p[1]), q, (p[0], q[1])]
            for k in range(4):
                tviz._thick_line(got, corners[k - 1], corners[k], color, caps=2)
        np.testing.assert_array_equal(got, want, err_msg=f"{shape} {p} {q}")


def test_draw_heat_map_matches_jax():
    rng = np.random.default_rng(0)
    heat = rng.normal(0.4, 0.4, (17, 16, 12)).astype(np.float32)
    mask = (rng.uniform(size=17) > 0.3).astype(np.float32)
    for m in (None, mask):
        got, want = tviz.draw_heat_map(heat, m), jviz.draw_heat_map(heat, m)
        assert got.shape == want.shape == (16, 12, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 1])
def test_write_png_round_trip(tmp_path, channels):
    """write_png -> cv2.imread gives the image back (cv2 in BGR), and so does
    read_png; other PNGs and other arrays are refused."""
    rng = np.random.default_rng(channels)
    shape = (37, 53, 3) if channels == 3 else (37, 53)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    assert tviz.write_png(path, img) == len(open(path, "rb").read())
    back = cv.imread(path, cv.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, img[..., ::-1] if channels == 3 else img)
    np.testing.assert_array_equal(tviz.read_png(path), img)
    with pytest.raises(ValueError, match="uint8"):
        tviz.write_png(path, img.astype(np.float32))
    other = str(tmp_path / "b.png")
    cv.imwrite(other, np.tile(np.arange(53, dtype=np.uint8), (37, 1)))  # cv2 filters rows
    with pytest.raises(ValueError):
        tviz.read_png(other)
