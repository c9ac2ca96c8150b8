"""Fused layer1 Bottleneck chain, port (simple_pose_torch/ops/bottleneck_chain)
against the JAX package (ops/pallas_bottleneck, Pallas in interpret mode).

JAX is imported inside the tests that use it, so the CUDA-marked kernel test
also runs where only torch is installed (``pytest --noconftest -m cuda``)."""

import numpy as np
import pytest
import torch

from simple_pose_torch.ops import bottleneck_chain as k2
from simple_pose_torch.ops.bottleneck_chain import (
    F32_WIDE_BAND,
    F32_WIDE_STORE,
    MAX_WIDTH,
    SMEM_LIMIT,
    WGMMA_BAND,
    WGMMA_STORE,
    _m2_reference,
    _mm,
    _rnd,
    _se_logits,
    _tma_weights,
    bottleneck_chain,
    bottleneck_chain_reference,
    fold_bottleneck_blocks,
    k2_launch_kind,
    launch_plan,
    pack_tf32,
    prepare_blocks,
    se_gate_from_sums_reference,
    se_mean_from_sums_reference,
    tf32_round,
    tf32_split,
)

torch.set_num_threads(1)

# bf16 tolerance, relative to max|ref|: a 1-ulp bf16 flip (2^-8) of a rounded
# intermediate (x, m1, m2, the SE mean or hidden layer), where the two
# implementations sum in another order, propagates through one or two
# downstream products; f32 differs by sum order only.
BF16_MAX_REL, BF16_MEAN_REL = 1e-2, 1e-3
F32_ATOL = 1e-5
# f32 on the card (3xTF32 products) against the plain version, relative to
# max|plain|, max and mean: chip_smoke.py's TOL["f32"]
F32_MAX_REL, F32_MEAN_REL = 1e-4, 1e-6


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


def _fan_in_scaled(blocks):
    """Weights scaled by their fan-in, so every block keeps its size."""
    for blk in blocks:
        for k in ("w1", "w3", "wd", "sf1", "sf2"):
            if k in blk:
                blk[k] *= 4.0 / np.sqrt(blk[k].shape[0])
        blk["w2"] *= 10.0 / np.sqrt(9 * blk["w2"].shape[2])
    return blocks


# the shapes beyond a band of whole rows at width 64: the wide ResNets'
# width 128 (SE and a projection, then an identity block) on a small map,
# and maps wider than 96 columns at narrow channels
_WIDE_CASES = {
    "width128": ((2, 6, 5), 32, 128, 64),
    "w97": ((1, 3, 97), 16, 8, 32),
    "w130": ((1, 3, 130), 16, 8, 32),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_WIDE_CASES))
def test_reference_matches_pallas_wide(dtype, case):
    """The plain version against the JAX kernel where the card's kernel
    takes 2-D tiles or the width-128 shape (tolerances as above)."""
    (batch, h, w), cin, width, cout = _WIDE_CASES[case]
    rng = np.random.default_rng(30)
    blocks = _fan_in_scaled([_rand_block(rng, cin, width, cout, True, True, hidden=16),
                             _rand_block(rng, cout, width, cout, False, False)])
    x = rng.normal(0, 1, (batch, h, w, cin)).astype(np.float32)
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


def _se_chain_np(rng, se_blocks, n_blocks=3, cin=16, width=8, cout=32):
    """A projection block then identity blocks, SE (hidden 8) on the blocks
    in ``se_blocks``; weights fan-in scaled."""
    blocks = [_rand_block(rng, cin if i == 0 else cout, width, cout, i == 0, i in se_blocks,
                          hidden=8) for i in range(n_blocks)]
    return _fan_in_scaled(blocks)


# SE on every block (consecutive SE blocks), or on the last block only
_SE_LAYOUTS = {"every": (0, 1, 2), "last": (2,)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(_SE_LAYOUTS))
def test_reference_matches_pallas_se_layouts(dtype, layout):
    """The plain chain against the JAX kernel with SE on every block and
    with SE in the last block only (tolerances as above)."""
    rng = np.random.default_rng(70)
    blocks = _se_chain_np(rng, _SE_LAYOUTS[layout])
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


def _tile_sums(m2, plan, cd):
    """What the kernel's SE sums pass writes: per tile of ``plan`` (in the
    kernel's tile order), the channel sums of m2 rounded to the compute
    dtype, [B, tiles, width] f32."""
    m2 = _rnd(m2, cd)
    return torch.stack([m2[:, :, ty * plan.th:(ty + 1) * plan.th,
                           tx * plan.tw:(tx + 1) * plan.tw].sum(dim=(2, 3))
                        for ty in range(plan.tiles_h) for tx in range(plan.tiles_w)], dim=1)


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hw", [(24, 12), (3, 97)], ids=["rows", "tiles2d"])
def test_se_gate_from_sums_matches_the_chain(dtype, hw):
    """The SE gate from the sums pass's per-tile m2 sums (the kernel's route:
    mean of m2, then w3 and b3) against the plain chain's gate from the mean
    of o over the same m2, on bands of whole rows and on 2-D tiles: v =
    mean_hw(o) within 1e-6 of max|v| in f32 and within one bf16 ulp in
    bf16 (only the order of f32 sums differs); the pre-sigmoid gate within
    1e-6 of its max in f32, and in bf16 within 1e-2 (a v rounded one ulp
    apart moves it through the two fcs)."""
    rng = np.random.default_rng(71)
    blk = _torch_blocks(_se_chain_np(rng, (0,), n_blocks=1))[0]
    h, w = hw
    x = _nchw(rng.normal(0, 1, (3, h, w, 16)).astype(np.float32))
    cd = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    m2 = _m2_reference(x, blk, cd)
    plan = launch_plan(h, w, blk["w1"].shape[1], cd == torch.bfloat16)
    assert plan.tiles > 1
    partial = _tile_sums(m2, plan, cd)
    v_plain = (_mm(m2, blk["w3"], cd) + blk["b3"][:, None, None]).mean(dim=(2, 3))
    v_sums = se_mean_from_sums_reference(partial, h * w, blk, cd)
    logits_plain, logits_sums = _se_logits(v_plain, blk, cd), _se_logits(v_sums, blk, cd)
    gate = se_gate_from_sums_reference(partial, h * w, blk, cd)
    assert gate.shape == (3, 32) and gate.dtype == torch.float32
    assert torch.equal(gate, torch.sigmoid(logits_sums))
    logit_err = (logits_sums - logits_plain).abs().max().item()
    logit_scale = logits_plain.abs().max().item()
    if dtype == "f32":
        assert (v_sums - v_plain).abs().max().item() < 1e-6 * v_plain.abs().max().item()
        assert logit_err < 1e-6 * logit_scale, (logit_err, logit_scale)
    else:
        assert ((v_sums - v_plain).abs() <= _bf16_ulp(v_plain)).all()
        assert logit_err < 1e-2 * logit_scale, (logit_err, logit_scale)


def test_k2_launch_kind_reads_profiler_names():
    """The kernel names a profiler trace gives K2's launches, demangled and
    mangled: the sums pass is the block kernel with its last flag set, in
    both compute types."""
    full = ("void (anonymous namespace)::hopper::bottleneck_block_wgmma_kernel<64, "
            "__nv_bfloat16, true, __nv_bfloat16, float, false>((anonymous namespace)::BlockArgs, "
            "CUtensorMap_st)")
    assert k2_launch_kind(full) == "block"
    assert k2_launch_kind(full.replace("float, false>", "float, true>")) == "sums"
    f32 = ("void (anonymous namespace)::hopper::bottleneck_block_wgmma_kernel<128, float, false, "
           "float, float, true>((anonymous namespace)::BlockArgs, CUtensorMap_st)")
    assert k2_launch_kind(f32) == "sums"
    assert k2_launch_kind(f32.replace("float, true>", "float, false>")) == "block"
    mangled = "_ZN12_GLOBAL__N_16hopper29bottleneck_block_wgmma_kernelILi64EfLb1EffLb{}EEEv"
    assert k2_launch_kind(mangled.format(0)) == "block"
    assert k2_launch_kind(mangled.format(1)) == "sums"
    assert k2_launch_kind("void (anonymous namespace)::se_gate_kernel<float>(...)") == "se_gate"
    assert k2_launch_kind("se_apply_kernel") is None
    assert k2_launch_kind("ampere_sgemm_128x64_nn") is None


def _layer1_widths(name):
    """Bottleneck widths of a trunk's layer1 blocks, or None where the
    fused layer1 does not take the trunk (built on the meta device)."""
    from simple_pose_torch.models.hrnet import HRNET_W32_CFG, HRNET_W48_CFG, PoseHRNet
    from simple_pose_torch.models.resnet import RESNET_SPECS, PoseResNet

    with torch.device("meta"):
        if name.startswith("hrnet"):
            model = PoseHRNet({"hrnet_w32": HRNET_W32_CFG, "hrnet_w48": HRNET_W48_CFG}[name])
        else:
            block, layers, extra = RESNET_SPECS[name]
            model = PoseResNet(block=block, layers=layers, **extra)
    names = model.layer1_block_names()
    return None if names is None else {model.get_submodule(n).conv2.weight.shape[0]
                                       for n in names}


# the trunks whose layer1 the fused path folds (layer1_block_names)
_FOLDABLE = ("hrnet_w32", "hrnet_w48", "resnet101", "resnet152", "resnet50", "wide_resnet101_2",
             "wide_resnet50_2")


def test_foldable_trunks():
    from simple_pose_torch.models.resnet import RESNET_SPECS

    trunks = sorted(RESNET_SPECS) + ["hrnet_w32", "hrnet_w48"]
    assert tuple(t for t in sorted(trunks) if _layer1_widths(t) is not None) == _FOLDABLE


@pytest.mark.parametrize("trunk", _FOLDABLE)
def test_launch_plan_covers_every_trunk(trunk):
    """For every trunk the fused layer1 takes, at the configs' input sizes
    and at input widths up to 1024 (layer1 at a quarter of the input): the
    kernel's tiles cover the map once, stay within its tile limits, and
    their shared memory fits one block of threads (227 KB).  The kernel
    takes up to three 64-row wgmma tiles with m1 and its ring in
    WGMMA_STORE pixels (f32 at widths 65-128: two, in F32_WIDE_STORE), and
    at widths 65-128 a multiple of 64 pixels on every map of at least 6 rows
    and 32 columns."""
    import glob

    from simple_pose_torch.train.config import load_config

    widths = _layer1_widths(trunk)
    assert widths <= {64, 128} and max(widths) <= MAX_WIDTH
    repo = __file__.rsplit("/tests/", 1)[0]
    sizes = {tuple(load_config(p).data.input_shape) for p in glob.glob(f"{repo}/configs/*.yaml")}
    assert (192, 256) in sizes
    maps = {(ih // 4, iw // 4) for iw, ih in sizes}
    maps |= {(h, iw // 4) for h in (1, 7, 64, 96) for iw in range(4, 1025, 4)}
    for width in widths:
        for h, w in sorted(maps):
            for bf16 in (False, True):
                plan = launch_plan(h, w, width, bf16)
                assert plan.wmax == (64 if width <= 64 else 128)
                assert 1 <= plan.th <= h and 1 <= plan.tw <= w, (h, w, plan)
                band, store = ((F32_WIDE_BAND, F32_WIDE_STORE) if width > 64 and not bf16
                               else (WGMMA_BAND, WGMMA_STORE))
                assert plan.th * plan.tw <= band, plan
                assert (plan.th + 2) * (plan.tw + 2) <= store, plan
                if width > 64 and h >= 6 and w >= 32:
                    assert plan.th * plan.tw % 64 == 0, (h, w, plan)
                rows = np.zeros(h, int)
                cols = np.zeros(w, int)
                for t in range(plan.tiles_h):
                    rows[t * plan.th:(t + 1) * plan.th] += 1
                for t in range(plan.tiles_w):
                    cols[t * plan.tw:(t + 1) * plan.tw] += 1
                assert (rows == 1).all() and (cols == 1).all(), (h, w, plan)
                assert 0 < plan.smem_bytes <= SMEM_LIMIT, (h, w, width, bf16, plan)
                if w <= 96 and width <= 64:  # a band of whole rows, as before 2-D tiles
                    assert plan.tw == w
    # the flagship's layer1 keeps its bands of 4 whole rows in both compute
    # types; the wide ResNets' takes bands of 4 whole rows too (192 pixels)
    # in bf16, and 8 x 16 tiles (128 pixels, m1 in 180) in f32
    assert launch_plan(64, 48, 64, True)[:4] == (4, 48, 16, 1)
    assert launch_plan(64, 48, 64, False)[:4] == (4, 48, 16, 1)
    assert launch_plan(64, 48, 128, True)[:4] == (4, 48, 16, 1)
    assert launch_plan(64, 48, 128, False)[:4] == (8, 16, 8, 3)


def test_launch_plan_refuses_beyond_the_kernel():
    with pytest.raises(ValueError, match="widths 1..128"):
        launch_plan(64, 48, 256, True)
    with pytest.raises(ValueError, match="empty map"):
        launch_plan(0, 48, 64, True)
    # the wgmma kernel's tensor maps take Cout in multiples of 8
    rng = np.random.default_rng(2)
    with pytest.raises(ValueError, match="Cout 260"):
        _tma_weights(_torch_blocks([_rand_block(rng, 64, 72, 260, True, False)])[0])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [20, 70, 100])
def test_wide_weights_pad_and_align(dtype, width):
    """What the wgmma kernel reads: the width zero-padded to a multiple of 8
    (slicing the padded weights gives the folded ones back exactly, and the
    plain version of the padded chain equals the unpadded one), and every
    matrix 16-byte aligned, a misaligned view copied."""
    rng = np.random.default_rng(40 + width)
    blocks = _torch_blocks(_fan_in_scaled([_rand_block(rng, 32, width, 64, True, True, hidden=8),
                                           _rand_block(rng, 64, width, 64, False, False)]))
    padded = [_tma_weights(blk) for blk in blocks]
    wp = -(-width // 8) * 8
    cut = {"w1": (slice(None), slice(width)), "b1": slice(width), "b2": slice(width),
           "w2": (Ellipsis, slice(width), slice(width)), "w3": slice(width)}
    for blk, pad in zip(blocks, padded):
        assert pad["w1"].shape[1] == pad["w2"].shape[3] == pad["w3"].shape[0] == wp
        for k, v in blk.items():
            assert torch.equal(pad[k][cut[k]] if k in cut else pad[k], v), k
        assert not pad["w2"][:, :, width:].any() and not pad["w2"][..., width:].any()
        assert not pad["w1"][:, width:].any() and not pad["w3"][width:].any()
    x = _nchw(rng.normal(0, 1, (2, 6, 5, 32)).astype(np.float32))
    cd = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    want = bottleneck_chain_reference(x, blocks, cd)
    got = bottleneck_chain_reference(x, padded, cd)
    err = (got - want).abs()
    scale = want.abs().max().item()
    if dtype == "f32":
        assert err.max().item() < 1e-5 * scale
    else:
        assert err.max().item() < BF16_MAX_REL * scale and err.mean().item() < BF16_MEAN_REL * scale

    storage = torch.zeros(1 + 64 * 256)
    view = storage[1:].view(64, 256)  # 4 bytes past an aligned start
    assert view.data_ptr() % 16 != 0
    blk = {**blocks[0], "w3": torch.zeros(width, 256), "wd": view}
    out = _tma_weights(blk)
    assert all(t.data_ptr() % 16 == 0 for t in out.values())
    assert torch.equal(out["wd"], view)


def _unpack_tf32(packed, k):
    """pack_tf32's [planes, N, K8] back to its hi and lo [taps, K, N] and the
    K padding [taps, 2, N, K8 - K]."""
    order = k2._TF32_K_ORDER
    k8 = packed.shape[-1]
    idx = torch.tensor([8 * g + order[p] for g in range(k8 // 8) for p in range(8)])
    natural = torch.empty_like(packed)
    natural[..., idx] = packed
    natural = natural.reshape(-1, 2, *packed.shape[1:])  # [taps, 2, N, K8]
    return natural[:, 0, :, :k].transpose(1, 2), natural[:, 1, :, :k].transpose(1, 2), \
        natural[..., k:]


def test_tf32_split_and_pack():
    """The host split and pack of the f32 products' weights: hi and lo are
    TF32 values (their low 13 bits zero), |w - hi - lo| <= 2^-21 |w|, hi is
    w rounded to nearest with ties away from zero (cvt.rna); the packs of
    w1, w2, w3 and wd map back to the folded weights (hi and lo planes per
    tap, each k8 group in the kernel's order), the K padding of a width or
    Cin not a multiple of 8 zero."""
    rng = np.random.default_rng(90)
    vals = torch.from_numpy(np.concatenate([
        rng.normal(0, 1, 4000), rng.normal(0, 1e-3, 4000), rng.normal(0, 1e4, 4000),
        [0.0, 1.0, -1.0, 3.0000002, 1e-30, -5e20]]).astype(np.float32))
    hi, lo = tf32_split(vals)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    assert ((vals - hi - lo).abs() <= 2.0 ** -21 * vals.abs()).all()
    assert ((vals - hi).abs() <= 2.0 ** -11 * vals.abs()).all()
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11])
    assert torch.equal(tf32_round(tie), torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                                      1 + 2 * 2.0 ** -10]))

    blk = _torch_blocks([_rand_block(rng, 40, 20, 48, True, False)])[0]
    for key, (taps, k, n) in {"w1": (1, 40, 20), "w2": (9, 20, 20), "w3": (1, 20, 48),
                              "wd": (1, 40, 48)}.items():
        w = blk[key]
        packed = pack_tf32(w)
        assert packed.shape == (2 * taps, n, -(-k // 8) * 8) and packed.is_contiguous(), key
        got_hi, got_lo, pad = _unpack_tf32(packed, k)
        want_hi, want_lo = tf32_split(w.reshape(taps, k, n))
        assert torch.equal(got_hi, want_hi) and torch.equal(got_lo, want_lo), key
        assert not pad.any(), key


def test_prepare_blocks_packs_once():
    """prepare_blocks in f32 packs each product's weight (w1p, w2p, w3p,
    and wdp where the block has a projection) in the shapes the kernel's
    wrapper checks, and is idempotent: a prepared chain prepared again
    keeps its very tensors (no second pack, so a chain on the card
    launches only its route's kernels); bf16 preparing drops the packs."""
    rng = np.random.default_rng(91)
    blocks = _torch_blocks(_se_chain_np(rng, (0,), n_blocks=2, width=20))
    once = prepare_blocks(blocks, torch.float32)
    assert {"w1p", "w2p", "w3p", "wdp"} <= set(once[0]) and "wdp" not in once[1]
    twice = prepare_blocks(once, torch.float32)
    for a, b in zip(once, twice):
        assert a.keys() == b.keys() and all(a[key] is b[key] for key in a)
    cin = 16
    for blk in once:
        cin = k2._check_block(blk, cin, torch.float32, torch.device("cpu"))[1]
    for blk in prepare_blocks(once, torch.bfloat16):
        assert not {"w1p", "w2p", "w3p", "wdp"} & set(blk)
    x = _nchw(rng.normal(0, 1, (1, 5, 4, 16)).astype(np.float32))
    assert torch.equal(bottleneck_chain(x, once), bottleneck_chain_reference(x, blocks))


def test_prepare_blocks_repacks_a_changed_weight(monkeypatch):
    """A pack is tied to the weight it was made from: a prepared block
    whose w3 is replaced by another tensor, or whose w1 changes in place,
    gets those packs anew from prepare_blocks and keeps the others; the
    registered op hands the kernel's route the very pack tensors (with
    their record), so a prepared chain is not packed again inside a call."""
    rng = np.random.default_rng(93)
    once = prepare_blocks(_torch_blocks(_se_chain_np(rng, (0,), n_blocks=1, width=20)),
                          torch.float32)[0]
    new_w3 = torch.from_numpy(rng.normal(0, 1, tuple(once["w3"].shape)).astype(np.float32))
    swapped = prepare_blocks([{**once, "w3": new_w3}], torch.float32)[0]
    assert swapped["w3p"] is not once["w3p"] and torch.equal(swapped["w3p"], pack_tf32(new_w3))
    assert all(swapped[k] is once[k] for k in ("w1p", "w2p", "wdp"))
    once["w1"].mul_(2.0)
    again = prepare_blocks([once], torch.float32)[0]
    assert again["w1p"] is not once["w1p"] and torch.equal(again["w1p"], pack_tf32(once["w1"]))
    assert all(again[k] is once[k] for k in ("w2p", "w3p", "wdp"))
    seen = []
    reference = k2.bottleneck_chain_reference
    monkeypatch.setattr(k2, "bottleneck_chain_reference",
                        lambda x, blocks, cd: seen.append(blocks) or reference(x, blocks, cd))
    bottleneck_chain(_nchw(rng.normal(0, 1, (1, 5, 4, 16)).astype(np.float32)), [again])
    assert all(seen[0][0][k] is again[k] for k in ("w1p", "w2p", "w3p", "wdp"))
    assert prepare_blocks(seen[0], torch.float32)[0]["w1p"] is again["w1p"]


def test_card_route_refuses_bf16_x_with_f32_compute():
    """The kernel's f32 instances take f32 x (an f32 model feeds f32): the
    card's route refuses bf16 x with f32 compute before it builds or
    launches anything."""
    x, blocks = _chain_np(batch=1)
    with pytest.raises(ValueError, match="f32 compute"):
        k2._bottleneck_chain_cuda(_nchw(x, dtype=torch.bfloat16), _torch_blocks(blocks),
                                  torch.float32)


@pytest.mark.parametrize("products", ["3xtf32", "1xtf32"])
def test_tf32_products_emulated(monkeypatch, products):
    """The card's f32 products emulated in plain torch on the flagship
    layer1's channels (64 -> 64 -> 256, 3 blocks, SE and a projection in
    block 0, fan-in scaled weights) on relu'd inputs on a 2 x 8 x 6 map:
    each operand split into TF32 hi and lo and summed as a_lo . b_hi +
    a_hi . b_lo + a_hi . b_hi (products exact in f32, as on the tensor
    cores; only the order of sums differs) lands within F32_MAX_REL /
    F32_MEAN_REL of the true f32 chain; one TF32 product per product
    (a_hi . b_hi) lands outside them, so the bound tells the two apart."""
    rng = np.random.default_rng(92)
    blocks = [_rand_block(rng, 64, 64, 256, True, True, hidden=16)]
    blocks += [_rand_block(rng, 256, 64, 256, False, False) for _ in range(2)]
    blocks = _torch_blocks(_fan_in_scaled(blocks))
    x = _nchw(np.abs(rng.normal(0, 1, (2, 8, 6, 64))).astype(np.float32))
    want = bottleneck_chain_reference(x, blocks)

    def tf32_mm(y, w, cd):
        (ah, al), (bh, bl) = tf32_split(y), tf32_split(w)
        terms = ((al, bh), (ah, bl), (ah, bh)) if products == "3xtf32" else ((ah, bh),)
        return sum(torch.einsum("bchw,cn->bnhw", a, b) for a, b in terms)

    monkeypatch.setattr(k2, "_mm", tf32_mm)
    got = bottleneck_chain_reference(x, blocks)
    err = (got - want).abs()
    scale = want.abs().max().item()
    max_rel, mean_rel = err.max().item() / scale, err.mean().item() / scale
    within = max_rel < F32_MAX_REL and mean_rel < F32_MEAN_REL
    assert within == (products == "3xtf32"), (max_rel, mean_rel)


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
    the input's dtype and shape, f32 to F32_MAX_REL / F32_MEAN_REL, bf16 to
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
        assert err.max().item() < F32_MAX_REL * scale, (err.max().item(), scale)
        assert err.mean().item() < F32_MEAN_REL * scale, (err.mean().item(), scale)
    else:
        assert err.max().item() < BF16_MAX_REL * scale
        assert err.mean().item() < BF16_MEAN_REL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,cd", [("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16")])
@pytest.mark.parametrize("shape", [(3, 16, 12), (2, 7, 48), (1, 5, 70), (2, 9, 97), (1, 6, 128),
                                   (1, 5, 200)])
def test_kernel_matches_reference_cuda(cuda_device, x_dtype, cd, shape):
    """Kernel vs plain version on the card at odd shapes: a ragged last band
    (7 rows of 48), a band of 2 rows (W=70), 2-D tiles with ragged right and
    bottom edges (W = 97, 128, 200), narrow widths."""
    batch, h, w = shape
    x, blocks = _chain_np(seed=11, batch=batch, h=h, w=w)
    _check_cuda_chain(cuda_device, x, blocks, x_dtype, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,cd", [("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16")])
def test_kernel_ragged_channels_cuda(cuda_device, x_dtype, cd):
    """cin 40 and width 24 (not multiples of the k16 tile), cout 48: the
    wgmma kernel reads zeros past them (its tensor maps' out-of-range fill,
    the x tile's zero pad) and stores only channels below cout."""
    rng = np.random.default_rng(12)
    blocks = [_rand_block(rng, 40, 24, 48, True, True, hidden=12),
              _rand_block(rng, 48, 24, 48, False, True, hidden=12)]
    x = rng.normal(0, 1, (2, 9, 20, 40)).astype(np.float32)
    _check_cuda_chain(cuda_device, x, blocks, x_dtype, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,cd", [("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16")])
@pytest.mark.parametrize("width", [64, 72, 128])
def test_kernel_layer1_widths_cuda(cuda_device, x_dtype, cd, width):
    """layer1's own widths: 64 -> width -> 256 (64: ResNet-50, HRNet; 128:
    the wide ResNets; 72: ragged in the width-128 kernel), three SE blocks
    (hidden 16), the first with a projection, batch 2 at 64x48."""
    rng = np.random.default_rng(13)
    blocks = [_rand_block(rng, 64, width, 256, True, True, hidden=16)]
    blocks += [_rand_block(rng, 256, width, 256, False, True, hidden=16) for _ in range(2)]
    x = rng.normal(0, 1, (2, 64, 48, 64)).astype(np.float32)
    _check_cuda_chain(cuda_device, x, _fan_in_scaled(blocks), x_dtype, cd)


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


@pytest.mark.cuda
def test_kernel_checks_the_launch_plan_cuda(cuda_device):
    """The library's shared memory for each plan equals launch_plan's, and
    it refuses tiles beyond its limits."""
    from simple_pose_torch.ops.bottleneck_chain import _lib

    lib = _lib()
    for width in (8, 64, 72, 128):
        for h, w in ((64, 48), (64, 97), (7, 200), (1, 1024)):
            for bf16 in (False, True):
                plan = launch_plan(h, w, width, bf16)
                assert lib.bottleneck_smem_bytes(plan.th, plan.tw, width, int(bf16)) == \
                    plan.smem_bytes
    assert lib.bottleneck_smem_bytes(4, 48, 129, 1) == 0
    assert lib.bottleneck_smem_bytes(5, 48, 64, 1) == 0  # 240 pixels > 192
    assert lib.bottleneck_smem_bytes(3, 48, 128, 0) == 0  # f32: 144 pixels > 128
    assert lib.bottleneck_smem_bytes(2, 48, 128, 0) == 0  # f32: 4 x 50 > 180 of m1
    assert lib.bottleneck_smem_bytes(8, 16, 128, 0) > 0   # f32: 128 pixels, 10 x 18 of m1
    assert lib.bottleneck_smem_bytes(5, 48, 64, 0) == 0   # f32: 240 pixels > 192
    assert lib.bottleneck_smem_bytes(5, 48, 128, 1) == 0  # wgmma: 240 pixels > 192
    assert lib.bottleneck_smem_bytes(2, 104, 128, 1) == 0  # wgmma: 4 x 106 > 320 of m1
    assert lib.bottleneck_smem_bytes(2, 104, 64, 1) == 0  # the same at width 64
    # one block of threads per SM in both compute types at both widths
    # (also on 2-D tiles)
    assert lib.bottleneck_blocks_per_sm(4, 48, 128, 1, 1) == 1
    assert lib.bottleneck_blocks_per_sm(4, 48, 64, 1, 1) == 1
    assert lib.bottleneck_blocks_per_sm(6, 32, 64, 1, 0) == 1
    assert lib.bottleneck_blocks_per_sm(4, 48, 64, 0, 1) == 1
    assert lib.bottleneck_blocks_per_sm(8, 16, 128, 0, 0) == 1


def _wide_chain(rng, cin, width, cout, n_blocks, se, projection=True):
    """A chain for the wgmma kernel: a projection block (or an identity one), then
    identity blocks; SE (hidden 16) on every block or on none; weights
    fan-in scaled."""
    blocks = [_rand_block(rng, cin, width, cout, projection, se, hidden=16)]
    blocks += [_rand_block(rng, cout, width, cout, False, se, hidden=16)
               for _ in range(n_blocks - 1)]
    return _fan_in_scaled(blocks)


# (batch, h, w), cin, width, cout, blocks, SE, projection in block 0
_WGMMA_CASES = {
    "layer1_b1": ((1, 64, 48), 64, 128, 256, 3, True, True),
    "layer1_b3": ((3, 64, 48), 64, 128, 256, 3, True, True),
    "layer1_b128": ((128, 64, 48), 64, 128, 256, 3, True, True),
    "tiles_64x97": ((1, 64, 97), 64, 128, 256, 3, True, True),
    "tiles_64x128": ((1, 64, 128), 64, 128, 256, 3, True, True),
    "tiles_64x200": ((1, 64, 200), 64, 128, 256, 3, True, True),
    "ragged_channels": ((2, 9, 20), 40, 100, 48, 2, True, True),
    "no_se_chain": ((2, 64, 48), 64, 128, 256, 3, False, True),
    "identity_block": ((2, 64, 48), 256, 128, 256, 1, False, False),
    # products 64 channels wide: the flagship's layer1 shape (64 -> 64 ->
    # 256) at batch 128 (a ragged last wave of tiles), a partial last band (7 rows in bands of 4), 2-D tiles, ragged
    # channels (cin 40, width 24, cout 48), HRNet's 4-block chain without SE
    "w64_layer1_b128": ((128, 64, 48), 64, 64, 256, 3, True, True),
    "w64_partial_band": ((2, 7, 48), 64, 64, 256, 3, True, True),
    "w64_tiles_64x97": ((1, 64, 97), 64, 64, 256, 3, True, True),
    "w64_tiles_64x128": ((1, 64, 128), 64, 64, 256, 3, True, True),
    "w64_ragged_channels": ((2, 9, 20), 40, 24, 48, 2, True, True),
    "w64_no_se_chain": ((2, 64, 48), 64, 64, 256, 4, False, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,cd", [("f32", "bf16"), ("bf16", "bf16"), ("f32", "f32")])
@pytest.mark.parametrize("case", sorted(_WGMMA_CASES))
def test_wgmma_kernel_matches_reference_cuda(cuda_device, x_dtype, case, cd):
    """The wgmma kernel (bf16, and f32 in 3xTF32) against the plain version: wide_resnet50_2's
    layer1 shape (64 -> 128 -> 256, SE, a projection) at batch 1, 3 and 128
    (a ragged last wave of tiles), on 2-D tiles of 64x97 / 64x128 / 64x200
    maps, with ragged channel counts (cin 40, width 100 padded to 104, cout
    48), without SE, and a lone identity block; the w64 cases at widths up
    to 64 (products 64 channels wide); f32 also to F32_MEAN_REL."""
    (batch, h, w), cin, width, cout, n_blocks, se, projection = _WGMMA_CASES[case]
    rng = np.random.default_rng(50)
    blocks = _wide_chain(rng, cin, width, cout, n_blocks, se, projection)
    x = rng.normal(0, 1, (batch, h, w, cin)).astype(np.float32)
    _check_cuda_chain(cuda_device, x, blocks, x_dtype, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16", "f32"])
@pytest.mark.parametrize("width", [64, 128])
def test_wgmma_kernel_is_deterministic_cuda(cuda_device, width, cd):
    """Two launches of the wgmma kernel on the same inputs are bitwise
    equal, in both compute types: the SE sums of a tile are taken in a
    fixed order (no atomics); batch 8, 128 or 192 blocks of threads at
    once."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[cd]
    rng = np.random.default_rng(60 + width)
    blocks = prepare_blocks(_torch_blocks(_wide_chain(rng, 64, width, 256, 3, True), cuda_device),
                            dt)
    x = _nchw(rng.normal(0, 1, (8, 64, 48, 64)).astype(np.float32), cuda_device, dt)
    first = bottleneck_chain(x, blocks, dt)
    second = bottleneck_chain(x, blocks, dt)
    torch.cuda.synchronize()
    assert torch.isfinite(first.float()).all()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_se_route_launches_cuda(cuda_device, cd):
    """One flagship-shape chain call (64 -> 64 -> 256, 3 blocks, SE and a
    projection in block 0, batch 2 at 64x48) under torch.profiler: 3 block
    kernels' full passes, 1 sums pass, 1 se_gate and no other kernel (no
    se_apply pass); its output against the plain version as above."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from simple_pose_torch.ops.bottleneck_chain import prepare_blocks

    rng = np.random.default_rng(80)
    blocks = [_rand_block(rng, 64, 64, 256, True, True, hidden=16)]
    blocks += [_rand_block(rng, 256, 64, 256, False, False) for _ in range(2)]
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[cd]
    tb = prepare_blocks(_torch_blocks(_fan_in_scaled(blocks), cuda_device), dt)
    x = _nchw(rng.normal(0, 1, (2, 64, 48, 64)).astype(np.float32), cuda_device, dt)
    traced = []  # one warm-up step, then the call (a trace can lose its first launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.extend(p.events())) as prof:
        for _ in range(2):
            got = bottleneck_chain(x, tb, dt)
            torch.cuda.synchronize()
            prof.step()
    names = [e.name for e in traced if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith("ProfilerStep")]  # the schedule's step annotation
    kinds = collections.Counter(k2_launch_kind(n) for n in names)
    assert kinds == {"block": 3, "sums": 1, "se_gate": 1}, names
    assert not any("se_apply" in n for n in names)
    want = bottleneck_chain_reference(x, tb, dt).float()
    err = (got.float() - want).abs()
    scale = want.abs().max().item()
    if cd == "f32":
        assert err.max().item() < 1e-4 * scale
    else:
        assert err.max().item() < BF16_MAX_REL * scale and err.mean().item() < BF16_MEAN_REL * scale


# one SE block with a projection: (batch, h, w), cin, width, cout
_SUMS_CASES = {
    "w64": ((2, 64, 48), 64, 64, 256),
    "w128": ((2, 64, 48), 64, 128, 256),
    "tiles_64x97": ((1, 64, 97), 64, 64, 256),
    "ragged_channels": ((2, 9, 20), 40, 20, 48),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_SUMS_CASES))
def test_sums_pass_matches_plain_sums_cuda(cuda_device, cd, case):
    """An SE block's launches on the card: the sums pass's per-tile channel
    sums of m2 against the plain m2's (f32 to 1e-4 of their max; bf16, where
    a few m2 values round one ulp apart, to BF16_MAX_REL / BF16_MEAN_REL),
    and zero past the width where the bf16 kernel pads it (20 to 24); the
    gate against se_gate_from_sums_reference
    on those same sums (f32 1e-5; bf16 5e-3, where a v rounded one ulp apart
    moves it through the two fcs); the block's output against the plain
    version."""
    from simple_pose_torch.ops.bottleneck_chain import _launch_block, _lib, prepare_blocks

    (batch, h, w), cin, width, cout = _SUMS_CASES[case]
    rng = np.random.default_rng(81)
    blk = _fan_in_scaled([_rand_block(rng, cin, width, cout, True, True, hidden=16)])
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[cd]
    tb = prepare_blocks(_torch_blocks(blk, cuda_device), dt)[0]
    x = _nchw(rng.normal(0, 1, (batch, h, w, cin)).astype(np.float32), cuda_device, dt)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    out, partial, gate = _launch_block(_lib(), x, tb, dt, torch.float32, stream)
    torch.cuda.synchronize()
    plan = launch_plan(h, w, partial.shape[2], dt == torch.bfloat16)
    assert partial.shape == (batch, plan.tiles, -(-width // 8) * 8 if cd == "bf16" else width)
    assert not partial[..., width:].any()
    want = _tile_sums(_m2_reference(x, tb, dt), plan, dt)
    err = (partial[..., :width] - want).abs()
    scale = want.abs().max().item()
    if cd == "f32":
        assert err.max().item() < 1e-4 * scale, (err.max().item(), scale)
    else:
        assert err.max().item() < BF16_MAX_REL * scale, (err.max().item(), scale)
        assert err.mean().item() < BF16_MEAN_REL * scale, (err.mean().item(), scale)
    gate_err = (gate - se_gate_from_sums_reference(partial, h * w, tb, dt)).abs().max().item()
    assert gate_err < (1e-5 if cd == "f32" else 5e-3), gate_err
    want_out = bottleneck_chain_reference(x.float(), [tb], dt)  # f32 out, as the block's
    out_err = (out - want_out).abs()
    out_scale = want_out.abs().max().item()
    if cd == "f32":
        assert out_err.max().item() < 1e-4 * out_scale
    else:
        assert out_err.max().item() < BF16_MAX_REL * out_scale
        assert out_err.mean().item() < BF16_MEAN_REL * out_scale


def test_ablation_anchors_match_the_kernel_source():
    """scripts/ablate_k2.py edits copies of the kernel source at fixed text
    anchors (its ablations and its per-phase timers of the wgmma kernel);
    each anchor must still be found exactly once."""
    import importlib.util
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("ablate_k2", repo / "scripts" / "ablate_k2.py")
    ablate_k2 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablate_k2)
    src = (repo / ablate_k2.SRC).read_text()
    for edits in ablate_k2.VARIANTS.values():
        assert ablate_k2.ablate(edits)(src) != src
    assert ablate_k2.add_timers(src).count("K2_TICK(") == len(ablate_k2.TIMER_EDITS) + len(
        ablate_k2.TIMER_BEFORE)
