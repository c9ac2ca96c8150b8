"""Training crop, port (simple_pose_torch/ops/warp.py, ops/rotate_resample.py)
against the JAX package (ops/warp.py, ops/pallas_warp.py with the Pallas
kernel in interpret mode), on the same numpy-made canvases and affines.

JAX is imported inside the fixtures that use it, so the CUDA-marked kernel
test also runs where only torch is installed (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from simple_pose_torch.ops import affine as A
from simple_pose_torch.ops import warp as TW
from simple_pose_torch.ops.rotate_resample import (
    affine_crop_two_stage,
    rotate_resample,
    rotate_resample_reference,
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


def _smooth_canvases(rng, n, size=128):
    """Blocky canvases (8x8 cells): two composed bilinear resamples stay
    within interpolation tolerance of one (test_pallas_warp.py's images)."""
    cells = size // 8
    return np.stack([np.kron(rng.uniform(0, 255, (cells, cells, 3)), np.ones((8, 8, 1)))
                     .astype(np.uint8) for _ in range(n)])


def _affines(rng, rots, size=128):
    """Box affines onto the 48x64 crop, rotated by ``rots`` degrees, scale
    0.7-1.3 about a box that fits the canvas."""
    out = []
    for rot in rots:
        c = rng.uniform(0.35 * size, 0.65 * size, 2)
        w = rng.uniform(0.2, 0.45) * size * rng.uniform(0.7, 1.3)
        t, _ = A.get_affine_transform(c, np.array([w, w * 64 / 48]) * 1.25, rot, (48, 64))
        out.append(t)
    return np.stack(out).astype(np.float32)


def _intermediate(jx, canvases, trans):
    """The JAX-made stage-1 intermediate (channel-major bf16) and R, u0."""
    jnp, JW, _ = jx
    d0, d1, r_mat, u0, t1x, t1y = JW.decompose_affine(jnp.asarray(trans), OUT_HW, INTER)
    inter = JW.stage1_resample(jnp.asarray(canvases), d0, d1, t1x, t1y, INTER)
    return inter.transpose(0, 3, 1, 2).astype(jnp.bfloat16), r_mat, u0


def _to_torch_bf16(jx, a):
    jnp = jx[0]
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


def test_decompose_affine_matches_jax(jx):
    jnp, JW, _ = jx
    rng = np.random.default_rng(0)
    trans = _affines(rng, rng.uniform(-40, 40, 6))
    want = JW.decompose_affine(jnp.asarray(trans), OUT_HW, INTER)
    got = TW.decompose_affine(torch.from_numpy(trans), OUT_HW, INTER)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_stage1_resample_matches_jax(jx):
    """Each output of both products is a sum of two exact bf16 x bf16
    products, so the two agree bit for bit (a bf16 flip of the rounded first
    product from another f32 sum order could move an output by at most one
    bf16 ulp of that product times an interpolation weight <= 1)."""
    jnp, JW, _ = jx
    rng = np.random.default_rng(1)
    canvases = rng.integers(0, 256, (3, 128, 160, 3), dtype=np.uint8)
    trans = _affines(rng, rng.uniform(-40, 40, 3))
    d = JW.decompose_affine(jnp.asarray(trans), OUT_HW, INTER)
    want = np.asarray(JW.stage1_resample(jnp.asarray(canvases), d[0], d[1], d[4], d[5], INTER))
    td = [torch.from_numpy(np.array(v)) for v in d]
    got = TW.stage1_resample(torch.from_numpy(canvases), td[0], td[1], td[4], td[5], INTER)
    assert got.shape == want.shape == (3, INTER, INTER, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rots", [(-33.0, 12.5, 27.0), (-40.99, 40.99, 0.0)],
                         ids=["rot_random", "rot_edges_and_zero"])
def test_rotate_resample_reference_matches_pallas(jx, rots):
    """Same JAX-made intermediate through both stage 2s: f32 bit for bit
    (asserted to 1e-3 on the 0-255 scale, share of identical pixels printed)."""
    _, _, PW = jx
    rng = np.random.default_rng(2)
    canvases = rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)
    inter, r_mat, u0 = _intermediate(jx, canvases, _affines(rng, rots))
    want = np.asarray(PW.rotate_resample_pallas(inter, r_mat, u0, OUT_HW, band=INTER,
                                                row_block=8))
    got = rotate_resample_reference(_to_torch_bf16(jx, inter), torch.from_numpy(np.asarray(r_mat)),
                                    torch.from_numpy(np.asarray(u0)), OUT_HW).numpy()
    assert got.shape == want.shape == (3, 64, 48, 3)
    identical = float(np.mean(got == want))
    print(f"rotate_resample_reference vs Pallas: {identical:.2%} of pixels bit-identical, "
          f"max |d| {np.abs(got - want).max():.3g}")
    assert np.abs(got - want).max() <= 1e-3


def test_zero_rotation_is_integer_passthrough(jx):
    """At 0 degrees R is the identity and u0 an integer: stage 2 copies
    intermediate pixels exactly."""
    rng = np.random.default_rng(3)
    canvases = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    inter, r_mat, u0 = _intermediate(jx, canvases, _affines(rng, (0.0, 0.0)))
    it = _to_torch_bf16(jx, inter)
    u0t = torch.from_numpy(np.asarray(u0))
    got = rotate_resample_reference(it, torch.from_numpy(np.asarray(r_mat)), u0t, OUT_HW)
    for b in range(2):
        ux, uy = int(u0t[b, 0]), int(u0t[b, 1])
        want = it[b, :, uy:uy + 64, ux:ux + 48].float().permute(1, 2, 0)
        torch.testing.assert_close(got[b], want, rtol=0, atol=0)


def test_bf16_output_is_rounded_f32(jx):
    rng = np.random.default_rng(4)
    canvases = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    inter, r_mat, u0 = _intermediate(jx, canvases, _affines(rng, (25.0, -17.0)))
    args = (_to_torch_bf16(jx, inter), torch.from_numpy(np.asarray(r_mat)),
            torch.from_numpy(np.asarray(u0)), OUT_HW)
    f32 = rotate_resample(*args, out_dtype=torch.float32)
    bf16 = rotate_resample(*args, out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, f32.to(torch.bfloat16), rtol=0, atol=0)


def test_two_stage_crop_matches_affine_crop_pallas(jx):
    """The whole crop.  Tighter than the MXU path's mean 0.2 / max 3.0
    (test_pallas_warp.py): the kernel does not round P to bf16."""
    jnp, _, PW = jx
    rng = np.random.default_rng(5)
    canvases = _smooth_canvases(rng, 4)
    trans = _affines(rng, rng.uniform(-40, 40, 4))
    want = np.asarray(PW.affine_crop_pallas(jnp.asarray(canvases), jnp.asarray(trans), OUT_HW,
                                            inter=INTER))
    got = affine_crop_two_stage(torch.from_numpy(canvases), torch.from_numpy(trans), OUT_HW,
                                inter=INTER).numpy()
    d = np.abs(got - want)
    assert d.mean() < 0.05 and d.max() < 2.0, (d.mean(), d.max())


def test_gather_crop_matches_jax(jx):
    jnp, JW, _ = jx
    rng = np.random.default_rng(6)
    canvases = rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)
    trans = _affines(rng, rng.uniform(-40, 40, 3))
    want = np.asarray(JW.affine_crop(jnp.asarray(canvases), jnp.asarray(trans), OUT_HW))
    got = TW.affine_crop(torch.from_numpy(canvases), torch.from_numpy(trans), OUT_HW).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_two_stage_crop_tracks_gather_crop():
    """Two composed resamples against the exact single resample on a smooth
    canvas: the bound of tests/test_warp.py's rotated MXU check (mean < 2.5
    intensity levels, pixel smoothing only)."""
    rng = np.random.default_rng(7)
    coarse = torch.from_numpy(rng.uniform(0, 255, (3, 3, 20, 20)).astype(np.float32))
    canvases = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear")
    canvases = canvases.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    trans = torch.from_numpy(_affines(rng, (-30.0, 5.0, 38.0), size=160))
    two = affine_crop_two_stage(canvases, trans, OUT_HW, inter=INTER)
    one = TW.affine_crop(canvases, trans, OUT_HW)
    assert (two - one).abs().mean().item() < 2.5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_reference_cuda(cuda_device, out_dtype):
    """K1 against its plain version on the card: bit for bit in f32, and the
    bf16 output is the f32 output rounded; odd shapes and taps off the edge
    of the intermediate (an offset u0) included."""
    rng = np.random.default_rng(8)
    inter = torch.from_numpy(rng.uniform(0, 255, (3, 3, 40, 52)).astype(np.float32))
    inter = inter.to(cuda_device, torch.bfloat16)
    ang = np.radians(rng.uniform(-41, 41, 3))
    r_mat = torch.from_numpy(np.stack([[[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
                                       for a in ang]).astype(np.float32)).to(cuda_device)
    u0 = torch.tensor([[10.0, 3.0], [-2.0, 8.0], [30.0, 30.0]], device=cuda_device)
    before = rotate_resample.launches
    got = rotate_resample(inter, r_mat, u0, (37, 29), out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert rotate_resample.launches == before + 1
    want = rotate_resample_reference(inter, r_mat, u0, (37, 29), torch.float32)
    assert got.shape == (3, 37, 29, 3) and got.dtype == out_dtype
    torch.testing.assert_close(got, want.to(out_dtype), rtol=0, atol=0)
