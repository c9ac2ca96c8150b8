"""Fused layer1 Bottleneck chain, port (simple_pose_torch/ops/bottleneck_chain)
against the JAX package (ops/pallas_bottleneck, Pallas in interpret mode).

JAX is imported inside the tests that use it, so the CUDA-marked kernel test
also runs where only torch is installed (``pytest --noconftest -m cuda``)."""

import numpy as np
import pytest
import torch

from simple_pose_torch.ops.bottleneck_chain import (
    bottleneck_chain,
    bottleneck_chain_reference,
    fold_bottleneck_blocks,
)

torch.set_num_threads(1)

# bf16 tolerance, relative to max|ref|: a 1-ulp bf16 flip (2^-8) of a rounded
# intermediate (x, m1, m2, the SE mean or hidden layer), where the two
# implementations sum in another order, propagates through one or two
# downstream products; f32 differs by sum order only.
BF16_MAX_REL, BF16_MEAN_REL = 1e-2, 1e-3
F32_ATOL = 1e-5


def _rand_block(rng, cin, width, cout, downsample, se, hidden=None):
    hidden = cout if hidden is None else hidden
    blk = {
        "w1": rng.normal(0, 0.2, (cin, width)),
        "b1": rng.normal(0, 0.1, width),
        "w2": rng.normal(0, 0.1, (3, 3, width, width)),
        "b2": rng.normal(0, 0.1, width),
        "w3": rng.normal(0, 0.2, (width, cout)),
        "b3": rng.normal(0, 0.1, cout),
    }
    if downsample:
        blk["wd"] = rng.normal(0, 0.2, (cin, cout))
        blk["bd"] = rng.normal(0, 0.1, cout)
    if se:
        blk["sf1"] = rng.normal(0, 0.2, (cout, hidden))
        blk["sb1"] = rng.normal(0, 0.1, hidden)
        blk["sf2"] = rng.normal(0, 0.2, (hidden, cout))
        blk["sb2"] = rng.normal(0, 0.1, cout)
    return {k: v.astype(np.float32) for k, v in blk.items()}


def _chain_np(seed=0, batch=3, h=16, w=12, cin=16, width=8, cout=32):
    """A downsample+SE block then an identity block (the layer1 pattern)."""
    rng = np.random.default_rng(seed)
    blocks = [_rand_block(rng, cin, width, cout, True, True),
              _rand_block(rng, cout, width, cout, False, False)]
    x = rng.normal(0, 1, (batch, h, w, cin)).astype(np.float32)  # NHWC
    return x, blocks


def _no_se_chain_np(rng, n_blocks, cin, width, cout):
    """HRNet's and ResNet-50-DUC's layer1 pattern: a projection block without
    SE, then identity blocks, none with SE; weights fan-in scaled, so every
    block keeps its size."""
    blocks = [_rand_block(rng, cin, width, cout, True, False)]
    blocks += [_rand_block(rng, cout, width, cout, False, False) for _ in range(n_blocks - 1)]
    for blk in blocks:
        for k in ("w1", "w3", "wd"):
            if k in blk:
                blk[k] *= 4.0 / np.sqrt(blk[k].shape[0])
        blk["w2"] *= 10.0 / np.sqrt(9 * blk["w2"].shape[2])
    return blocks


def _torch_blocks(blocks, device="cpu"):
    return [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in blocks]


def _nchw(x_nhwc, device="cpu", dtype=torch.float32):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous().to(device, dtype)


def _pallas(x, blocks, dtype):
    import jax.numpy as jnp

    from simple_pose_tpu.ops.pallas_bottleneck import bottleneck_chain_pallas

    jblocks = [{**{k: jnp.asarray(v) for k, v in b.items()}, "wd": (
        jnp.asarray(b["wd"]) if "wd" in b else None)} for b in blocks]
    cd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    out = bottleneck_chain_pallas(jnp.asarray(x), jblocks, compute_dtype=cd, interpret=True)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reference_matches_pallas(dtype):
    x, blocks = _chain_np()
    want = _pallas(x, blocks, dtype)
    cd = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    got = bottleneck_chain(_nchw(x), _torch_blocks(blocks), compute_dtype=cd)
    got = got.permute(0, 2, 3, 1).numpy()
    err = np.abs(got - want)
    if dtype == "f32":
        assert err.max() < F32_ATOL, err.max()
    else:
        scale = np.abs(want).max()
        assert err.max() < BF16_MAX_REL * scale and err.mean() < BF16_MEAN_REL * scale, (
            err.max(), err.mean(), scale)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_blocks", [3, 4])
def test_reference_matches_pallas_no_se_chain(dtype, n_blocks):
    """3 and 4 blocks, a projection without SE in block 0 (ResNet-50-DUC's and
    HRNet's layer1 pattern, at narrow widths)."""
    rng = np.random.default_rng(20 + n_blocks)
    blocks = _no_se_chain_np(rng, n_blocks, 16, 8, 32)
    x = rng.normal(0, 1, (2, 12, 10, 16)).astype(np.float32)
    want = _pallas(x, blocks, dtype)
    cd = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    got = bottleneck_chain(_nchw(x), _torch_blocks(blocks), compute_dtype=cd)
    err = np.abs(got.permute(0, 2, 3, 1).numpy() - want)
    scale = np.abs(want).max()
    if dtype == "f32":
        assert err.max() < 1e-5 * scale, (err.max(), scale)
    else:
        assert err.max() < BF16_MAX_REL * scale and err.mean() < BF16_MEAN_REL * scale, (
            err.max(), err.mean(), scale)


def test_zero_pad_after_relu():
    """x = 0 makes m1 = relu(b1) a constant inside the image; with the pad
    after the ReLU, border pixels of the 3x3 see zeros, not relu(b1)."""
    rng = np.random.default_rng(3)
    blk = _rand_block(rng, 8, 8, 8, False, False)
    blk["b1"] = np.abs(blk["b1"]) + 0.5  # relu(b1) > 0 everywhere
    h, w = 5, 4
    x = torch.zeros((1, 8, h, w))
    got = bottleneck_chain(x, _torch_blocks([blk])).numpy()[0]

    m1 = np.maximum(blk["b1"], 0.0)
    want = np.zeros((8, h, w), np.float32)
    for r in range(h):
        for c in range(w):
            acc = blk["b2"].astype(np.float64).copy()
            for dy in range(3):
                for dx in range(3):
                    if 0 <= r + dy - 1 < h and 0 <= c + dx - 1 < w:
                        acc += m1 @ blk["w2"][dy, dx]
            m2 = np.maximum(acc, 0.0)
            want[:, r, c] = np.maximum(m2 @ blk["w3"] + blk["b3"], 0.0)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got[:, 0, 0] - got[:, 2, 2]).max() > 1e-3  # borders differ


def test_f32_carry_between_blocks():
    """The chain carries f32 between blocks: with a bf16 input and bf16
    compute it equals the blocks run one at a time on an f32 intermediate,
    and differs from a bf16 intermediate.  JAX agrees with the f32 carry."""
    x, blocks = _chain_np(seed=5)
    tb = _torch_blocks(blocks)
    xb = _nchw(x, dtype=torch.bfloat16)
    bf = torch.bfloat16
    chained = bottleneck_chain(xb, tb, bf)
    y1 = bottleneck_chain(xb.float(), tb[:1], bf)  # f32 out: the carry
    f32_carry = bottleneck_chain(y1, tb[1:], bf).to(bf)
    bf16_carry = bottleneck_chain(bottleneck_chain(xb, tb[:1], bf), tb[1:], bf)
    assert torch.equal(chained, f32_carry)
    assert not torch.equal(chained, bf16_carry)

    import jax.numpy as jnp

    from simple_pose_tpu.ops.pallas_bottleneck import bottleneck_chain_pallas

    jblocks = [{**{k: jnp.asarray(v) for k, v in b.items()},
                "wd": jnp.asarray(b["wd"]) if "wd" in b else None} for b in blocks]
    xj = jnp.asarray(xb.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16)
    want = np.asarray(bottleneck_chain_pallas(xj, jblocks, compute_dtype=jnp.bfloat16,
                                              interpret=True), np.float32)
    got = chained.float().permute(0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < BF16_MAX_REL * scale


def test_fold_matches_jax_fold():
    """fold_bottleneck_blocks from the torch modules' BN buffers equals the
    JAX fold of the same weights (carried by the JAX package's converter)."""
    import jax

    from simple_pose_tpu.convert.torch2flax import convert_torch_state
    from simple_pose_tpu.ops.pallas_bottleneck import fold_bottleneck_blocks as jax_fold
    from simple_pose_torch.models.resnet import PoseResNet

    model = PoseResNet(block="bottleneck", layers=(2, 1, 1, 1), se=True).eval()
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.3)
                m.running_var.copy_(torch.rand(c, generator=gen) * 3 + 1)
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.2 * torch.randn(c, generator=gen))
    got = fold_bottleneck_blocks(list(model.layer1))
    variables, _ = convert_torch_state(model.state_dict(), "resnet")
    want = jax_fold(variables["params"], variables["batch_stats"], ["layer1_0", "layer1_1"])
    for g, w in zip(got, want):
        assert set(g) == {k for k, v in w.items() if v is not None}
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(jax.device_get(w[k])),
                                       rtol=1e-6, atol=1e-7)


def test_cpu_wrapper_leaves_launch_counter():
    x, blocks = _chain_np(batch=1)
    before = bottleneck_chain.launches
    ref = bottleneck_chain_reference(_nchw(x), _torch_blocks(blocks))
    got = bottleneck_chain(_nchw(x), _torch_blocks(blocks))
    assert bottleneck_chain.launches == before == 0
    assert torch.equal(got, ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_cuda_chain(device, x, blocks, x_dtype, cd):
    """One kernel call against the plain version on the card: one launch,
    the input's dtype and shape, f32 to 1e-4 relative, bf16 to
    BF16_MAX_REL / BF16_MEAN_REL."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    xt = _nchw(x, device, dt[x_dtype])
    tb = _torch_blocks(blocks, device)
    want = bottleneck_chain_reference(xt, tb, dt[cd]).float()
    before = bottleneck_chain.launches
    got = bottleneck_chain(xt, tb, dt[cd])
    torch.cuda.synchronize()
    assert bottleneck_chain.launches == before + 1
    assert got.dtype == xt.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want).abs()
    scale = want.abs().max().item()
    if cd == "f32":
        assert err.max().item() < 1e-4 * scale
    else:
        assert err.max().item() < BF16_MAX_REL * scale
        assert err.mean().item() < BF16_MEAN_REL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,cd", [("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16")])
@pytest.mark.parametrize("shape", [(3, 16, 12), (2, 7, 48), (1, 5, 70)])
def test_kernel_matches_reference_cuda(cuda_device, x_dtype, cd, shape):
    """Kernel vs plain version on the card at odd shapes: a ragged last band
    (7 rows of 48), a band of 2 rows (W=70), narrow widths."""
    batch, h, w = shape
    x, blocks = _chain_np(seed=11, batch=batch, h=h, w=w)
    _check_cuda_chain(cuda_device, x, blocks, x_dtype, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,cd", [("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16")])
def test_kernel_ragged_channels_cuda(cuda_device, x_dtype, cd):
    """cin 40 and width 24 (not multiples of the k16 tile), cout 48: the
    tensor-core kernel pads K with zeros and steps N by 8."""
    rng = np.random.default_rng(12)
    blocks = [_rand_block(rng, 40, 24, 48, True, True, hidden=12),
              _rand_block(rng, 48, 24, 48, False, True, hidden=12)]
    x = rng.normal(0, 1, (2, 9, 20, 40)).astype(np.float32)
    _check_cuda_chain(cuda_device, x, blocks, x_dtype, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,cd", [("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16")])
def test_kernel_layer1_widths_cuda(cuda_device, x_dtype, cd):
    """layer1's own widths: 64 -> 64 -> 256, three SE blocks (hidden 16),
    the first with a projection, batch 2 at 64x48."""
    rng = np.random.default_rng(13)
    blocks = [_rand_block(rng, 64, 64, 256, True, True, hidden=16)]
    blocks += [_rand_block(rng, 256, 64, 256, False, True, hidden=16) for _ in range(2)]
    for blk in blocks:  # fan-in scaled, so the three blocks keep their size
        for k in ("w1", "w3", "wd", "sf1", "sf2"):
            if k in blk:
                blk[k] *= 4.0 / np.sqrt(blk[k].shape[0])
        blk["w2"] *= 10.0 / np.sqrt(9 * blk["w2"].shape[2])
    x = rng.normal(0, 1, (2, 64, 48, 64)).astype(np.float32)
    _check_cuda_chain(cuda_device, x, blocks, x_dtype, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,cd", [("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16")])
@pytest.mark.parametrize("n_blocks", [3, 4])
def test_kernel_no_se_layer1_cuda(cuda_device, x_dtype, cd, n_blocks):
    """HRNet's 4-block and ResNet-50-DUC's 3-block layer1 at their widths
    (64 -> 64 -> 256, no SE, a projection in block 0), batch 2 at 64x48:
    the projection's direct write and the f32 carry over 3 launches."""
    rng = np.random.default_rng(14 + n_blocks)
    blocks = _no_se_chain_np(rng, n_blocks, 64, 64, 256)
    x = rng.normal(0, 1, (2, 64, 48, 64)).astype(np.float32)
    _check_cuda_chain(cuda_device, x, blocks, x_dtype, cd)
