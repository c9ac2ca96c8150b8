"""K2's SE route on trained weights, held on the CPU against the JAX package
and against f32.

The witness (``tests/data_torch_detchain/r50se_witness.npz``) comes from a
run of the detector-chain AP gate on an H100::

    python scripts/drive_torch_discrim_detchain.py --model pose_resnet_dconv:resnet50 --se \\
        --witness tests/data_torch_detchain/r50se_witness.npz

It holds the crop whose keypoint the ``fused_layer1`` pass moved furthest
from the unfused pass's (ResNet-50-DConv+SE trained 300 epochs, 128x128
crops, bf16): layer1's input for the crop and its flip, the folded blocks
as K2 took them, layer1's output four ways on the card (K2, the plain
chain, cuDNN bf16, f32 without TF32), the crop's three heatmaps (fused
bf16, unfused bf16, unfused f32) and the passes' keypoints.

``JAX_PLATFORMS=cpu python -m tests.test_torch_detchain_witness`` prints
every number the tests hold."""

import json
import os

import numpy as np
import pytest
import torch

from simple_pose_torch.ops.bottleneck_chain import bottleneck_chain_reference, prepare_blocks
from simple_pose_torch.ops.decode import decode_gauss_taylor

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WITNESS = os.path.join(REPO, "tests", "data_torch_detchain", "r50se_witness.npz")
# a bf16 chain against another on the same input, relative to max|plain|,
# max and mean: chip_smoke.py's TOL["bf16"] (a 1-ulp flip of a rounded
# intermediate where two implementations sum in another order propagates
# through the products downstream)
BF16_MAX_REL, BF16_MEAN_REL = 2e-2, 2e-3
# a decoder on the CPU against the card's on the same f32 heatmap, px in the
# image: the blur and the Taylor step sum in another order
KP_TOL_PX = 0.01
# the witness's y_bf16 stacks these layer1 outputs
# (scripts/drive_torch_discrim_detchain.Y_BF16)
Y_BF16 = ("k2", "plain", "cudnn")


def _tensor(a):
    """bf16 from raw uint16 bits, else the array as it is."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def load_witness(path=WITNESS):
    """(arrays as tensors, y_bf16 split into y_k2, y_plain and y_cudnn;
    meta; the blocks as the chain took them)."""
    with np.load(path) as d:
        arrays = {k: _tensor(d[k]) for k in d.files if k != "meta"}
        meta = json.loads(str(d["meta"]))
    arrays.update({f"y_{k}": y for k, y in zip(Y_BF16, arrays.pop("y_bf16"))})
    blocks = []
    while f"block{len(blocks)}_w1" in arrays:
        prefix = f"block{len(blocks)}_"
        blocks.append({k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)})
    return arrays, meta, blocks


def rel_errors(got, want):
    """(max, mean) of |got - want| relative to max|want|."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    return d.max().item() / scale, d.mean().item() / scale


def jax_chain(x, blocks, interpret=True):
    """The JAX package's Pallas chain (interpret mode) in the witness's
    compute dtype on NCHW ``x``; NCHW f32 out.  Blocks go to JAX as in
    tests/test_torch_bottleneck._pallas: NHWC x, the same weight layout,
    ``wd`` None where absent."""
    import jax.numpy as jnp

    from simple_pose_tpu.ops.pallas_bottleneck import bottleneck_chain_pallas

    cd = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    jblocks = [{**{k: jnp.asarray(v.float().numpy()) for k, v in b.items()},
                "wd": jnp.asarray(b["wd"].float().numpy()) if "wd" in b else None}
               for b in blocks]
    xj = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy())
    out = bottleneck_chain_pallas(xj, jblocks, compute_dtype=cd, interpret=interpret)
    return torch.from_numpy(np.array(out, np.float32)).permute(0, 3, 1, 2)


def decode(pkg, heat, trans_inv):
    """Gauss-Taylor keypoints [J, 2] of one crop's heatmaps [J, h, w] by the
    port's decoder ("torch") or the JAX package's ("jax")."""
    if pkg == "torch":
        kps, _ = decode_gauss_taylor(heat[None].float(), trans_inv[None].float())
        return kps[0].numpy()
    import jax.numpy as jnp

    from simple_pose_tpu.ops import decode as jdecode

    kps, _ = jdecode.decode_gauss_taylor(jnp.asarray(heat[None].float().numpy()),
                                         jnp.asarray(trans_inv[None].float().numpy()))
    return np.asarray(kps)[0]


def local_maxima(m):
    """A map's local maxima (>= their 8 neighbours), highest first, as
    (value, (x, y))."""
    h, w = m.shape
    p = np.pad(m, 1, constant_values=-np.inf)
    around = np.max([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx], axis=0)
    ys, xs = np.nonzero(m >= around)
    order = np.argsort(-m[ys, xs], kind="stable")
    return [(float(m[ys[i], xs[i]]), (int(xs[i]), int(ys[i]))) for i in order]


def peak_analysis(arrays, joint):
    """The witness joint's maps: the f32 heatmap's two highest local maxima
    and their gap, the bf16 passes' largest error against f32 on that map,
    and where each pass's argmax lies."""
    maps = {n: arrays[f"heat_{n}"][joint].float().numpy() for n in ("fused", "unfused", "f32")}
    (m1, p1), (m2, p2) = local_maxima(maps["f32"])[:2]
    err = {n: float(np.abs(maps[n] - maps["f32"]).max()) for n in ("fused", "unfused")}
    argmax = {n: [int(v) for v in np.unravel_index(int(np.argmax(m)), m.shape)[::-1]]
              for n, m in maps.items()}
    return {"f32_maxima": [[m1, list(p1)], [m2, list(p2)]], "gap": m1 - m2,
            "bf16_heat_err": err, "argmax": argmax,
            "near_tie": bool(m1 - m2 < max(err.values()))}


@pytest.fixture(scope="module")
def witness():
    return load_witness()


@pytest.fixture(scope="module")
def jax_out(witness):
    arrays, _, blocks = witness
    return jax_chain(arrays["x"], blocks)


def test_witness_is_the_cards_largest_shift(witness):
    """The file is the card's: a bf16 pass's replay on the H100 that gave the
    passes' keypoints again, at the detection and joint of the largest
    shift, which the passes' keypoints show; bf16 tensors as raw bits."""
    arrays, meta, blocks = witness
    assert meta["device"].startswith("cuda") and "H100" in meta["card"], meta
    assert arrays["x"].dtype == arrays["y_k2"].dtype == torch.bfloat16
    assert arrays["y_f32"].dtype == torch.float32
    assert tuple(arrays["x"].shape) == (2, 64, 32, 32), arrays["x"].shape
    assert len(blocks) == 3 and "sf1" in blocks[0] and "wd" in blocks[0]
    assert meta["replay_kp_px"] == {"fused": 0.0, "unfused": 0.0}, meta
    j = meta["joint"]
    shift = np.linalg.norm(arrays["kps_fused"][j, :2] - arrays["kps_unfused"][j, :2]).item()
    assert shift == pytest.approx(meta["kp_shift_px_max"], rel=1e-5), (shift, meta)


def test_jax_chain_matches_card_k2(witness, jax_out):
    """(a) The JAX package's Pallas chain in bf16 on the saved input and
    blocks against K2's output on the card, within TOL["bf16"]."""
    arrays, _, _ = witness
    err = rel_errors(arrays["y_k2"], jax_out)
    assert err[0] < BF16_MAX_REL and err[1] < BF16_MEAN_REL, err


@pytest.mark.parametrize("card", ["y_plain", "y_k2"])
def test_plain_chain_on_cpu_matches_card(witness, card):
    """(b) The port's plain chain on the CPU against the card's plain chain
    and against K2, within TOL["bf16"]."""
    arrays, _, blocks = witness
    want = bottleneck_chain_reference(arrays["x"], prepare_blocks(blocks, torch.bfloat16),
                                      compute_dtype=torch.bfloat16)
    err = rel_errors(arrays[card], want)
    assert err[0] < BF16_MAX_REL and err[1] < BF16_MEAN_REL, err


def test_k2_within_bf16_of_f32_on_card(witness):
    """K2's output on the card against the f32 layer1 (TF32 off) on the
    same input, within TOL["bf16"], as phase 16d asserts on a batch."""
    arrays, _, _ = witness
    err = rel_errors(arrays["y_k2"], arrays["y_f32"])
    assert err[0] < BF16_MAX_REL and err[1] < BF16_MEAN_REL, err


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_decoders_reproduce_card_keypoints(witness, pkg):
    """(c) Each package's gauss_taylor decoder on the three saved heatmaps
    gives the card's keypoints (fused and unfused: the passes'; f32: the
    replay's), the witness joint within 0.01 px."""
    arrays, meta, _ = witness
    j = meta["joint"]
    for name in ("fused", "unfused", "f32"):
        got = decode(pkg, arrays[f"heat_{name}"], arrays["trans_inv"])
        want = arrays[f"kps_{name}"][:, :2].numpy()
        assert np.abs(got[j] - want[j]).max() < KP_TOL_PX, (name, got[j], want[j])


def test_the_jump_is_a_near_tie(witness):
    """(c) The verdict: the f32 heatmap's two highest local maxima of the
    witness joint differ by less than the bf16 passes' error on that map,
    and the fused and unfused passes' argmaxes sit on those two maxima,
    one each, so the jump is bf16 rounding choosing between near-equal
    peaks, not a K2 fault (which (a) and (b) would show)."""
    arrays, meta, _ = witness
    got = peak_analysis(arrays, meta["joint"])
    maxima = {tuple(p) for _, p in got["f32_maxima"]}
    assert got["near_tie"], got
    assert {tuple(got["argmax"]["fused"]), tuple(got["argmax"]["unfused"])} == maxima, got


def report(path=WITNESS):
    """Every number the tests hold, as one dict."""
    arrays, meta, blocks = load_witness(path)
    jax_y = jax_chain(arrays["x"], blocks)
    plain_cpu = bottleneck_chain_reference(arrays["x"], prepare_blocks(blocks, torch.bfloat16),
                                           compute_dtype=torch.bfloat16)
    j = meta["joint"]
    out = {"meta": meta,
           "k2_vs_jax": rel_errors(arrays["y_k2"], jax_y),
           "card_plain_vs_cpu_plain": rel_errors(arrays["y_plain"], plain_cpu),
           "k2_vs_cpu_plain": rel_errors(arrays["y_k2"], plain_cpu),
           "jax_vs_f32": rel_errors(jax_y, arrays["y_f32"]),
           "k2_vs_f32": rel_errors(arrays["y_k2"], arrays["y_f32"]),
           "cudnn_vs_f32": rel_errors(arrays["y_cudnn"], arrays["y_f32"]),
           "heat_fused_vs_f32": rel_errors(arrays["heat_fused"], arrays["heat_f32"]),
           "heat_unfused_vs_f32": rel_errors(arrays["heat_unfused"], arrays["heat_f32"]),
           "keypoints": {}, "peaks": peak_analysis(arrays, j)}
    for name in ("fused", "unfused", "f32"):
        want = arrays[f"kps_{name}"][j, :2].numpy()
        out["keypoints"][name] = {"card": want.tolist(), **{
            pkg: decode(pkg, arrays[f"heat_{name}"], arrays["trans_inv"])[j].tolist()
            for pkg in ("torch", "jax")}}
    return out


if __name__ == "__main__":
    print(json.dumps(report()))
