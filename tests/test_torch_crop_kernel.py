"""The training crop's whole-crop kernel and its wrapper
(simple_pose_torch/ops/rotate_resample.py ``affine_crop_two_stage``).

On the CPU: the wrapper (its plain version) against the JAX package's
two-stage crop, ops/warp.py ``stage1_resample`` then ops/pallas_warp.py
``rotate_resample_pallas`` in interpret mode, on the same numpy-made canvases
and affines; and the kernel's shared-memory box (``crop_box_edge``) against
every stage-2 tap of every output tile.  On a card: the kernel against its
plain version, bit for bit.

JAX is imported inside the fixture that uses it, so the CUDA-marked tests also
run where only torch is installed (``pytest --noconftest -m cuda``).
"""

import math

import numpy as np
import pytest
import torch

from simple_pose_torch.ops import affine as A
from simple_pose_torch.ops import warp as TW
from simple_pose_torch.ops.rotate_resample import (
    CROP_TILE,
    affine_crop_two_stage,
    affine_crop_two_stage_reference,
    crop_box_edge,
    rotate_resample,
)

torch.set_num_threads(1)

OUT_HW = (64, 48)
INTER = int(np.ceil(np.hypot(*OUT_HW))) + 8  # as make_train_step sizes it


@pytest.fixture()
def jx(monkeypatch):
    """The JAX package's warp modules, Pallas in interpret mode (as
    tests/test_pallas_warp.py runs it)."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    import simple_pose_tpu.ops.pallas_warp as PW
    import simple_pose_tpu.ops.warp as JW

    orig = pl.pallas_call
    monkeypatch.setattr(PW.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    return jnp, JW, PW


def _affines(rng, rots, out_hw, size, centers=None, scales=None):
    """Box affines onto an out_hw crop, rotated by ``rots`` degrees, about
    ``centers`` (default: inside the canvas), with ``scales`` source pixels
    per crop pixel (default 0.3-0.8 of the canvas over the crop)."""
    oh, ow = out_hw
    out = []
    for i, rot in enumerate(rots):
        c = rng.uniform(0.35 * size, 0.65 * size, 2) if centers is None else np.asarray(centers[i])
        s = rng.uniform(0.3, 0.8) * size / ow if scales is None else scales[i]
        t, _ = A.get_affine_transform(c.astype(np.float64), np.array([ow, oh]) * s, rot, (ow, oh))
        out.append(t)
    return np.stack(out).astype(np.float32)


CROP_CASES = {
    "rot_random": dict(rots=(-33.0, 12.5, 27.0)),
    "rot_edges_and_zero": dict(rots=(-40.99, 40.99, 0.0)),
    "rot_any": dict(rots=(90.0, 180.0, -135.0)),
    "off_canvas": dict(rots=(15.0, -25.0, 0.0), centers=((5.0, 3.0), (130.0, 118.0), (-10.0, 60.0))),
}


@pytest.mark.parametrize("case", list(CROP_CASES), ids=list(CROP_CASES))
def test_crop_matches_jax_two_stage(jx, case):
    """The CPU crop against JAX stage 1 -> bf16 -> Pallas stage 2 on the same
    canvases: bit for bit (asserted to 1e-3 on the 0-255 scale, share of
    identical pixels printed)."""
    jnp, JW, PW = jx
    rng = np.random.default_rng(10)
    canvases = rng.integers(0, 256, (3, 120, 136, 3), dtype=np.uint8)
    trans = _affines(rng, out_hw=OUT_HW, size=120, **CROP_CASES[case])
    d0, d1, r_mat, u0, t1x, t1y = JW.decompose_affine(jnp.asarray(trans), OUT_HW, INTER)
    inter = JW.stage1_resample(jnp.asarray(canvases), d0, d1, t1x, t1y, INTER)
    inter = inter.transpose(0, 3, 1, 2).astype(jnp.bfloat16)
    want = np.asarray(PW.rotate_resample_pallas(inter, r_mat, u0, OUT_HW, band=INTER, row_block=8))
    before = affine_crop_two_stage.launches
    got = affine_crop_two_stage(torch.from_numpy(canvases), torch.from_numpy(trans), OUT_HW,
                                inter=INTER).numpy()
    assert affine_crop_two_stage.launches == before  # the plain version is no launch
    assert got.shape == want.shape == (3, 64, 48, 3)
    identical = float(np.mean(got == want))
    print(f"affine_crop_two_stage vs JAX stage 1 + Pallas ({case}): {identical:.2%} of pixels "
          f"bit-identical, max |d| {np.abs(got - want).max():.3g}")
    assert np.abs(got - want).max() <= 1e-3


def _f32_fma_u(r_a, r_b, u0, xs, ys):
    """The kernels' fma(r_a, x, r_b * y) + u0 in f32 (numpy, per sample)."""
    f32 = np.float32
    rb_y = (r_b[:, None, None] * ys).astype(f32)
    fma = (r_a[:, None, None].astype(np.float64) * xs + rb_y.astype(np.float64)).astype(f32)
    return (fma + u0[:, None, None]).astype(f32)


def _random_affines(rng, n, out_hw, kind):
    """Seeded affines onto an out_hw crop: similarities at any rotation,
    among them 0, 90, 180 and -90 degrees, with 0.5-3.3 canvas pixels per
    crop pixel; or general affines with shear and unequal scales."""
    oh, ow = out_hw
    if kind == "similarity":
        rots = np.concatenate([[0.0, 90.0, 180.0, -90.0], rng.uniform(-180, 180, n - 4)])
        return _affines(rng, rots, out_hw, size=640, centers=rng.uniform(-50, 690, (n, 2)),
                        scales=rng.uniform(0.5, 3.3, n))
    inv = np.zeros((n, 2, 3), np.float64)
    inv[:, :, :2] = rng.uniform(-3.3, 3.3, (n, 2, 2))
    inv[:, :, 2] = rng.uniform(-50, 690, (n, 2))
    trans = np.zeros_like(inv)
    for i in range(n):
        a = np.linalg.inv(inv[i, :, :2])
        trans[i, :, :2], trans[i, :, 2] = a, -a @ inv[i, :, 2]
    return trans.astype(np.float32)


@pytest.mark.parametrize("out_hw", [(256, 192), (37, 29)], ids=["256x192", "37x29"])
@pytest.mark.parametrize("kind", ["similarity", "sheared"])
def test_crop_box_covers_every_tap(out_hw, kind):
    """The crop kernel's box rule: per output tile, the taps of the tile's
    four corners and one tap of padding on each side.  Every stage-2 tap of
    every tile pixel lies in that box (the kernel reads the box without
    bounds checks), and the box fits crop_box_edge()."""
    rng = np.random.default_rng(11)
    oh, ow = out_hw
    inter = math.ceil(math.hypot(oh, ow)) + 8
    th, tw = CROP_TILE
    edge = crop_box_edge(th, tw)
    trans = torch.from_numpy(_random_affines(rng, 24, out_hw, kind))
    d0, _, r_mat, u0, _, _ = (v.numpy() for v in TW.decompose_affine(trans, out_hw, inter))
    if kind == "similarity":
        assert d0.min() < 0.6 and d0.max() > 3.0
    xs = np.arange(ow, dtype=np.float32)[None, None, :]
    ys = np.arange(oh, dtype=np.float32)[None, :, None]
    taps = [np.floor(_f32_fma_u(r_mat[:, k, 0], r_mat[:, k, 1], u0[:, k], xs, ys)).astype(np.int64)
            for k in (0, 1)]  # floor(ux), floor(uy): [B, oh, ow]
    widest = 0
    for y0 in range(0, oh, th):
        for x0 in range(0, ow, tw):
            for t in taps:
                tile = t[:, y0:y0 + th, x0:x0 + tw]
                corners = tile[:, [0, 0, -1, -1], [0, -1, 0, -1]]
                lo = (corners.min(axis=1) - 1)[:, None, None]
                hi = (corners.max(axis=1) + 2)[:, None, None]
                widest = max(widest, int((hi - lo + 1).max()))
                assert ((tile >= lo) & (tile + 1 <= hi)).all(), (y0, x0)
    print(f"widest box {widest} of edge {edge} ({kind}, {out_hw})")
    assert widest <= edge


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_crop_is_the_plain_version(out_dtype):
    """On CPU tensors the wrapper is the plain composition, counts no launch,
    and its bf16 output is the f32 output rounded."""
    rng = np.random.default_rng(12)
    canvases = torch.from_numpy(rng.integers(0, 256, (2, 97, 131, 3), dtype=np.uint8))
    trans = torch.from_numpy(_affines(rng, (41.0, 180.0), (37, 29), size=97))
    inter = math.ceil(math.hypot(37, 29)) + 8
    before = affine_crop_two_stage.launches
    got = affine_crop_two_stage(canvases, trans, (37, 29), inter=inter, out_dtype=out_dtype)
    assert affine_crop_two_stage.launches == before
    want = affine_crop_two_stage_reference(canvases, trans, (37, 29), inter, torch.float32)
    assert got.shape == (2, 37, 29, 3) and got.dtype == out_dtype
    torch.testing.assert_close(got, want.to(out_dtype), rtol=0, atol=0)


def test_crop_refuses_other_devices():
    images = torch.empty((1, 64, 64, 3), dtype=torch.uint8, device="meta")
    trans = torch.zeros((1, 2, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        affine_crop_two_stage(images, trans, OUT_HW, inter=INTER)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


ODD_HW = (37, 29)
ODD_INTER = math.ceil(math.hypot(*ODD_HW)) + 8


def _odd_inputs(device, channels):
    """97x131 canvases, a 37x29 crop rotated by +-41, 0 and 180 degrees,
    one box far off the canvas edge."""
    rng = np.random.default_rng(13)
    canvases = rng.integers(0, 256, (4, 97, 131, channels), dtype=np.uint8)
    trans = _affines(rng, (41.0, -41.0, 0.0, 180.0), ODD_HW, size=97,
                     centers=((50.0, 40.0), (120.0, 5.0), (60.0, 50.0), (-20.0, 90.0)))
    return torch.from_numpy(canvases).to(device), torch.from_numpy(trans).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [3, 1], ids=["c3", "c1"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_crop_kernel_matches_reference_cuda(cuda_device, out_dtype, channels):
    """The whole-crop kernel against its plain version on the card at odd
    shapes: bit for bit in f32, and the bf16 output is the f32 output rounded."""
    canvases, trans = _odd_inputs(cuda_device, channels)
    before = affine_crop_two_stage.launches
    got = affine_crop_two_stage(canvases, trans, ODD_HW, inter=ODD_INTER, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert affine_crop_two_stage.launches == before + 1
    want = affine_crop_two_stage_reference(canvases, trans, ODD_HW, ODD_INTER, torch.float32)
    assert got.shape == (4, *ODD_HW, channels) and got.dtype == out_dtype
    torch.testing.assert_close(got, want.to(out_dtype), rtol=0, atol=0)


@pytest.mark.cuda
def test_crop_kernel_matches_stage1_and_k1_cuda(cuda_device):
    """The whole-crop kernel against the two-launch card path it replaces
    (stage 1 on cuBLAS, then the stage-2 kernel) at the training shapes:
    640^2 canvases, 256x192 crops, the 328^2 intermediate, f32 bit for bit."""
    rng = np.random.default_rng(14)
    canvases = torch.from_numpy(rng.integers(0, 256, (4, 640, 640, 3), dtype=np.uint8))
    trans = torch.from_numpy(_affines(rng, (-40.0, 33.0, 0.0, 175.0), (256, 192), size=640))
    canvases, trans = canvases.to(cuda_device), trans.to(cuda_device)
    d0, d1, r_mat, u0, t1x, t1y = TW.decompose_affine(trans, (256, 192), 328)
    inter = TW.stage1_resample(canvases, d0, d1, t1x, t1y, 328)
    inter = inter.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
    want = rotate_resample(inter, r_mat, u0, (256, 192), out_dtype=torch.float32)
    got = affine_crop_two_stage(canvases, trans, (256, 192), inter=328)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
