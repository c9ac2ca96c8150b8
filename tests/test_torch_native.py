"""The port's native JPEG loader (simple_pose_torch/data/native.py) against the
JAX package's binding and cv2, the port's PosePipeline(use_native=True)
against the JAX pipeline's, and the committed JPEG fixture
(tests/data_torch_jpeg, scripts/make_torch_jpeg_fixtures.py)."""

import importlib.util
import json
import os
import subprocess
import sys
import zlib

import cv2 as cv
import numpy as np
import pytest

from simple_pose_torch.data import coco as tcoco
from simple_pose_torch.data import native
from simple_pose_torch.data import pipeline as tpipe
from simple_pose_tpu.data import coco as jcoco
from simple_pose_tpu.data import native as jnative
from simple_pose_tpu.data import pipeline as jpipe
from tests.util_synth import make_synth_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data_torch_jpeg")
SAMPLING = {"420": cv.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "444": cv.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def _smooth(rng, h, w, c):
    small = rng.uniform(0, 255, (max(2, h // 8), max(2, w // 8), c)).astype(np.float32)
    img = cv.resize(small, (w, h), interpolation=cv.INTER_CUBIC)
    return np.clip(img + rng.normal(0, 8, img.shape if img.ndim == 3 else (h, w)), 0, 255
                   ).astype(np.uint8)


# (height, width, colour, sampling) of each JPEG, decoded into a 128 canvas
JPEGS = {
    "420": (96, 120, True, "420"),
    "444": (100, 90, True, "444"),
    "gray": (80, 110, False, None),
    "larger_than_canvas": (150, 200, True, "444"),
}


def _write_jpeg(path, case, seed):
    h, w, colour, sampling = JPEGS[case]
    img = _smooth(np.random.default_rng(seed), h, w, 3 if colour else 1)
    params = [cv.IMWRITE_JPEG_QUALITY, 90]
    if sampling:
        params += [cv.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    assert cv.imwrite(path, img, params)


@pytest.mark.parametrize("case", sorted(JPEGS))
def test_loader_matches_jax_and_cv2(tmp_path, case):
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{case}_{i}.jpg"))
        _write_jpeg(paths[-1], case, seed=i)
    got, hs, ws = native.NativeCanvasLoader(2).load_batch(paths, 128)
    want, jhs, jws = jnative.NativeCanvasLoader(2).load_batch(paths, 128)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hs, jhs)
    np.testing.assert_array_equal(ws, jws)
    h, w = JPEGS[case][:2]
    assert got.shape == (3, 128, 128, 3) and got.dtype == np.uint8
    assert (hs == h).all() and (ws == w).all()
    for i, p in enumerate(paths):
        ref = cv.imread(p, cv.IMREAD_COLOR)[..., ::-1]  # grayscale promoted to RGB
        ch, cw = min(h, 128), min(w, 128)
        np.testing.assert_array_equal(got[i, :ch, :cw], ref[:ch, :cw])
        assert not got[i, ch:].any() and not got[i, :, cw:].any()


def test_loader_missing_file_and_calls(tmp_path):
    path = str(tmp_path / "a.jpg")
    _write_jpeg(path, "444", seed=0)
    loader = native.NativeCanvasLoader(2)
    before = native.NativeCanvasLoader.load_batch.calls
    loader.load_batch([path], 64)
    with pytest.raises(FileNotFoundError, match="nope.jpg"):
        loader.load_batch([path, str(tmp_path / "nope.jpg")], 64)
    assert native.NativeCanvasLoader.load_batch.calls == before + 2


def test_use_native_raises_when_the_build_fails(tmp_path, monkeypatch, capsys):
    """use_native=True raises with the compiler's command; None takes cv2 and
    says so once; nothing is written in place of the library."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX", "false")
    monkeypatch.setattr(tpipe, "_decoder_reported", tpipe.threading.Event())
    assert not native.native_available()
    rec = tcoco.PoseRecord("x.jpg", 10, 10, [0, 0, 5, 5], np.zeros((17, 3), np.float32), 1)
    with pytest.raises(RuntimeError, match="building the native JPEG loader failed.*false"):
        tpipe.PosePipeline([rec], 1, use_native=True)
    for _ in range(2):
        assert tpipe.PosePipeline([rec], 1, use_native=None)._native is None
    assert capsys.readouterr().err.count("decoding with cv2") == 1
    assert tpipe.PosePipeline([rec], 1, use_native=False)._native is None
    assert [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")] == []


# (sampling, height, width, quality, restart interval, optimized Huffman)
BASELINE_CASES = [("444", 37, 53, 90, 0, 0), ("420", 121, 99, 75, 3, 0),
                  ("420", 17, 2, 100, 0, 1), ("422", 64, 64, 40, 0, 1),
                  ("440", 33, 47, 95, 2, 0), ("411", 29, 70, 85, 0, 0),
                  ("gray", 41, 30, 90, 1, 0), ("420", 3, 5, 60, 0, 0)]
BASELINE_SAMPLING = {**SAMPLING, "422": cv.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                     "440": cv.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                     "411": cv.IMWRITE_JPEG_SAMPLING_FACTOR_411}


@pytest.fixture
def baseline_loader(monkeypatch):
    """The loader of a machine without libjpeg (csrc/jpeg_canvas.cc)."""
    monkeypatch.setattr(native, "decoder_name", lambda: "baseline")
    loader = native.NativeCanvasLoader(2)
    assert loader.decoder == "baseline"
    return loader


@pytest.mark.parametrize("case", range(len(BASELINE_CASES)))
def test_baseline_decoder_matches_libjpeg(tmp_path, baseline_loader, case):
    """Bit for bit with libjpeg: smooth and noise images, every sampling
    layout, odd sizes, restart intervals, optimized tables, a canvas smaller
    than the image."""
    sampling, h, w, quality, restart, optimize = BASELINE_CASES[case]
    rng = np.random.default_rng(case)
    paths = []
    for i, noise in enumerate((False, True)):
        c = 1 if sampling == "gray" else 3
        img = (rng.integers(0, 256, (h, w, c), dtype=np.uint8) if noise
               else _smooth(rng, h, w, c))
        params = [cv.IMWRITE_JPEG_QUALITY, quality, cv.IMWRITE_JPEG_RST_INTERVAL, restart,
                  cv.IMWRITE_JPEG_OPTIMIZE, optimize]
        if sampling != "gray":
            params += [cv.IMWRITE_JPEG_SAMPLING_FACTOR, BASELINE_SAMPLING[sampling]]
        paths.append(str(tmp_path / f"{i}.jpg"))
        assert cv.imwrite(paths[-1], img[..., 0] if c == 1 else img, params)
    for canvas in (128, 32):
        got = baseline_loader.load_batch(paths, canvas)
        want = native.NativeCanvasLoader(2).load_batch(paths, canvas)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g, wnt)


# (sampling, height, width, quality, restart interval): cv2's default
# progression script (DC first and refine, AC first with EOB runs, AC refine)
PROGRESSIVE_CASES = [("420", 121, 99, 75, 0), ("422", 64, 64, 40, 0), ("444", 37, 53, 90, 0),
                     ("440", 33, 47, 95, 0), ("411", 29, 70, 85, 0), ("gray", 41, 30, 90, 0),
                     ("420", 96, 120, 90, 3), ("gray", 17, 2, 100, 1), ("420", 3, 5, 60, 0),
                     ("444", 150, 200, 80, 2)]


@pytest.mark.parametrize("case", range(len(PROGRESSIVE_CASES)))
def test_baseline_decoder_matches_libjpeg_progressive(tmp_path, baseline_loader, case):
    """Progressive files bit for bit with libjpeg: smooth and noise images,
    every sampling layout (non-interleaved AC scans over each component's
    own blocks), odd sizes, restart intervals, a canvas smaller than the
    image."""
    sampling, h, w, quality, restart = PROGRESSIVE_CASES[case]
    rng = np.random.default_rng(100 + case)
    paths = []
    for i, noise in enumerate((False, True)):
        c = 1 if sampling == "gray" else 3
        img = (rng.integers(0, 256, (h, w, c), dtype=np.uint8) if noise
               else _smooth(rng, h, w, c))
        params = [cv.IMWRITE_JPEG_PROGRESSIVE, 1, cv.IMWRITE_JPEG_QUALITY, quality,
                  cv.IMWRITE_JPEG_RST_INTERVAL, restart]
        if sampling != "gray":
            params += [cv.IMWRITE_JPEG_SAMPLING_FACTOR, BASELINE_SAMPLING[sampling]]
        paths.append(str(tmp_path / f"{i}.jpg"))
        assert cv.imwrite(paths[-1], img[..., 0] if c == 1 else img, params)
        with open(paths[-1], "rb") as f:
            data = f.read()
        assert b"\xff\xc2" in data and (b"\xff\xdd" in data) == bool(restart)
    for canvas in (128, 32):
        got = baseline_loader.load_batch(paths, canvas)
        want = native.NativeCanvasLoader(2).load_batch(paths, canvas)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g, wnt)


def _check_crc32(loader, name):
    with open(os.path.join(FIXTURE, name)) as f:
        want = json.load(f)
    rels = sorted(want)
    canvases, hs, ws = loader.load_batch([os.path.join(FIXTURE, r) for r in rels], 640)
    for rel, canvas, h, w in zip(rels, canvases, hs, ws):
        assert (h, w) == (want[rel]["height"], want[rel]["width"]), rel
        assert zlib.crc32(np.ascontiguousarray(canvas[:h, :w]).tobytes()) == want[rel]["crc32"], rel
    return rels


def test_baseline_decoder_fixture_and_limits(tmp_path, baseline_loader, libjpeg_encoder):
    """The committed fixtures to their CRC32s; a progressive file decodes as
    libjpeg does; a progressive file cut before its last scan (libjpeg
    smooths its blocks) and a real arithmetic-coded file decode as libjpeg
    does; a lossless frame and a missing file raise FileNotFoundError."""
    _check_crc32(baseline_loader, "decoded_crc32.json")
    assert len(_check_crc32(baseline_loader, os.path.join("progressive",
                                                          "decoded_crc32.json"))) == 6
    assert len(_check_crc32(baseline_loader, os.path.join("decoder", "decoded_crc32.json"))) == 15
    progressive = str(tmp_path / "p.jpg")
    img = _smooth(np.random.default_rng(0), 40, 40, 3)
    cv.imwrite(progressive, img, [cv.IMWRITE_JPEG_PROGRESSIVE, 1])
    with open(progressive, "rb") as f:
        data = f.read()
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    (tmp_path / "cut.jpg").write_bytes(data[:sos[-1]] + b"\xff\xd9")
    _load_script().encode(libjpeg_encoder, str(tmp_path / "arithmetic.jpg"), img, arith=1,
                          progressive=1)
    with open(tmp_path / "arithmetic.jpg", "rb") as f:
        assert b"\xff\xca" in f.read()
    paths = [progressive, str(tmp_path / "cut.jpg"), str(tmp_path / "arithmetic.jpg")]
    want = jnative.NativeCanvasLoader(1).load_batch(paths, 64)
    for g, w in zip(baseline_loader.load_batch(paths, 64), want):
        np.testing.assert_array_equal(g, w)
    (tmp_path / "lossless.jpg").write_bytes(data.replace(b"\xff\xc2", b"\xff\xc3", 1))
    for name in ("lossless.jpg", "nope.jpg"):
        with pytest.raises(FileNotFoundError, match=name):
            baseline_loader.load_batch([str(tmp_path / name)], 64)


@pytest.fixture(scope="module")
def libjpeg_encoder(tmp_path_factory):
    """The fixture script's encoder (arithmetic coding, scan scripts, DAC),
    built against this machine's libjpeg."""
    return _load_script().build_encoder(str(tmp_path_factory.mktemp("encoder")))


def _same_as_libjpeg(loader, paths, canvas=128):
    """Each file decodes in the port exactly as the JAX package's loader
    (libjpeg) decodes it, or both raise (a cut inside a marker segment can
    leave libjpeg a table it refuses).  Returns the paths that decoded."""
    jloader = jnative.NativeCanvasLoader(1)
    decoded = []
    for path in paths:
        try:
            want = jloader.load_batch([path], canvas)
        except FileNotFoundError:
            with pytest.raises(FileNotFoundError):
                loader.load_batch([path], canvas)
            continue
        got = loader.load_batch([path], canvas)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=path)
        decoded.append(path)
    return decoded


def _cuts(tmp_path, name, data, points):
    """The file cut at each point, with and without a trailing EOI."""
    paths = []
    for i, cut in enumerate(points):
        assert cut < len(data)
        for eoi in (False, True):
            paths.append(str(tmp_path / f"{name}_{i}_{int(eoi)}.jpg"))
            with open(paths[-1], "wb") as f:
                f.write(data[:cut] + (b"\xff\xd9" if eoi else b""))
    return paths


# (sampling, height, width, progressive, restart interval) of the files cut
CUT_CASES = [("420", 64, 64, 0, 0), ("444", 37, 53, 0, 2), ("422", 121, 99, 0, 1),
             ("420", 64, 64, 1, 0), ("420", 33, 47, 1, 1), ("420", 17, 90, 1, 0),
             ("444", 96, 120, 1, 3), ("gray", 41, 30, 1, 0)]


@pytest.mark.parametrize("case", range(len(CUT_CASES)))
def test_baseline_decoder_matches_libjpeg_cut(tmp_path, baseline_loader, case):
    """Files cut short decode as libjpeg decodes them: a Huffman scan that
    runs out of data leaves the rest of its restart interval at the
    coefficients so far (mid-gray in a sequential file), with and without
    EOI, across restart markers; a progressive file cut after each scan or
    inside one is block-smoothed as libjpeg smooths it.  Cut points inside
    the entropy data decode to wild coefficients too, which libjpeg-turbo's
    SIMD IDCT wraps and saturates."""
    sampling, h, w, progressive, restart = CUT_CASES[case]
    rng = np.random.default_rng(200 + case)
    c = 1 if sampling == "gray" else 3
    img = _smooth(rng, h, w, c)  # (h, w) for grayscale
    params = [cv.IMWRITE_JPEG_PROGRESSIVE, progressive, cv.IMWRITE_JPEG_RST_INTERVAL, restart]
    if c == 3:
        params += [cv.IMWRITE_JPEG_SAMPLING_FACTOR, BASELINE_SAMPLING[sampling]]
    path = str(tmp_path / "full.jpg")
    assert cv.imwrite(path, img, params)
    with open(path, "rb") as f:
        data = f.read()
    sos = _load_script().scan_starts(data)
    body = len(data) - sos[0]  # every cut point lies past the first scan's header
    at_scans = _cuts(tmp_path, "scan", data, sos[1:])
    inside = _cuts(tmp_path, "cut", data,
                   [sos[0] + body * k // 10 for k in range(1, 10)] + [s + 24 for s in sos])
    decoded = _same_as_libjpeg(baseline_loader, at_scans + inside)
    assert set(at_scans) <= set(decoded) and len(decoded) > len(at_scans) + len(inside) // 2


# (arith, progressive, sampling, restart interval, DAC conditioning)
ARITH_CASES = [(0, "22,11,11", 0, 0), (0, "11,11,11", 3, 1), (0, "21,11,11", 0, 1),
               (0, "41,11,11", 2, 0), (1, "22,11,11", 0, 0), (1, "12,11,11", 3, 1),
               (1, "22,21,12", 1, 0), (1, "11", 2, 1)]


@pytest.mark.parametrize("case", range(len(ARITH_CASES)))
def test_baseline_decoder_matches_libjpeg_arithmetic(tmp_path, baseline_loader, libjpeg_encoder,
                                                     case):
    """SOF9 and SOF10 files from libjpeg's encoder (every sampling layout,
    restart intervals, DAC conditioning, grayscale), smooth and noise, whole
    and cut short, decode as libjpeg decodes them."""
    progressive, sampling, restart, dac = ARITH_CASES[case]
    rng = np.random.default_rng(300 + case)
    paths, inside = [], []  # whole and cut at a scan; cut inside the data
    for i, noise in enumerate((False, True)):
        h, w = [(40, 48), (33, 71)][i]
        c = 1 if sampling == "11" else 3
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8) if noise else _smooth(rng, h, w, c)
        paths.append(str(tmp_path / f"{i}.jpg"))
        _load_script().encode(libjpeg_encoder, paths[-1], img.reshape(h, w, c),
                              quality=[90, 60][i], arith=1, progressive=progressive,
                              restart=restart, sampling=sampling, dac=dac)
        with open(paths[-1], "rb") as f:
            data = f.read()
        assert (b"\xff\xca" if progressive else b"\xff\xc9") in data
        assert (b"\xff\xcc" in data) and (b"\xff\xdd" in data) == bool(restart)
        sos = _load_script().scan_starts(data)
        paths += _cuts(tmp_path, f"cut{i}", data, sos[1:3])
        inside += _cuts(tmp_path, f"inside{i}", data, [(sos[0] + len(data)) // 2])
    decoded = _same_as_libjpeg(baseline_loader, paths + inside)
    assert decoded[:len(paths)] == paths and len(decoded) > len(paths)


@pytest.mark.parametrize("script", ["y_then_cbcr", "each"])
@pytest.mark.parametrize("arith", [0, 1])
def test_baseline_decoder_matches_libjpeg_multiscan(tmp_path, baseline_loader, libjpeg_encoder,
                                                    script, arith):
    """Sequential files of several scans (a scan of fewer components decodes
    into the whole-image coefficient buffer), Huffman and arithmetic, with
    and without restart intervals, whole and cut short."""
    rng = np.random.default_rng(400 + arith)
    paths = []
    for i, (sampling, restart) in enumerate([("22,11,11", 0), ("21,11,11", 2), ("11,11,11", 1)]):
        paths.append(str(tmp_path / f"{i}.jpg"))
        _load_script().encode(libjpeg_encoder, paths[-1], _smooth(rng, 50, 61, 3), arith=arith,
                              sampling=sampling, restart=restart, script=script)
        with open(paths[-1], "rb") as f:
            data = f.read()
        assert len(_load_script().scan_starts(data)) == (2 if script == "y_then_cbcr" else 3)
        sos = _load_script().scan_starts(data)
        paths += _cuts(tmp_path, f"cut{i}", data, [(sos[-1] + len(data)) // 2])
    assert _same_as_libjpeg(baseline_loader, paths) == paths


@pytest.mark.parametrize("arith", [0, 1])
def test_baseline_decoder_matches_libjpeg_bogus_progression(tmp_path, baseline_loader,
                                                            libjpeg_encoder, arith):
    """Progressive files whose scans libjpeg only warns about decode as it
    decodes them: an AC scan before the DC scan, refinements before the
    first scans, the last refinement early, and scans left out."""
    rng = np.random.default_rng(500 + arith)
    script = _load_script()
    paths = []
    for k, noise in enumerate((False, True)):
        img = (rng.integers(0, 256, (40, 56, 3), dtype=np.uint8) if noise
               else _smooth(rng, 40, 56, 3))
        path = str(tmp_path / f"src{k}.jpg")
        if arith:
            script.encode(libjpeg_encoder, path, img, arith=1, progressive=1)
        else:
            assert cv.imwrite(path, img, [cv.IMWRITE_JPEG_PROGRESSIVE, 1])
        with open(path, "rb") as f:
            head, units, tail = script.scan_units(f.read())
        n = len(units)
        orders = [list(range(1, n)) + [0], [0] + list(range(n - 1, 0, -1)),
                  [0, n - 1] + list(range(1, n - 1)), [0] + [i for i in range(1, n) if i % 3]]
        for o, order in enumerate(orders):
            paths.append(str(tmp_path / f"{k}_{o}.jpg"))
            with open(paths[-1], "wb") as f:
                f.write(head + b"".join(units[i] for i in order) + tail)
    assert _same_as_libjpeg(baseline_loader, paths) == paths


def _check_only_file(tmp_path, encoder, kind):
    img = _smooth(np.random.default_rng(600), 40, 48, 3)
    path = str(tmp_path / f"{kind}.jpg")
    if kind == "cmyk":
        _load_script().encode(encoder, path, np.concatenate([img, img[..., :1]], -1),
                              sampling="11,11,11,11")
        return path
    assert cv.imwrite(path, img, [cv.IMWRITE_JPEG_SAMPLING_FACTOR,
                                  cv.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    with open(path, "rb") as f:
        data = bytearray(f.read())
    sof = data.index(b"\xff\xc0")
    if kind == "12bit":
        data[sof + 4] = 12
    elif kind == "lossless":
        data[sof + 1] = 0xC3
    else:  # fractional sampling: Y 3x1, Cb 2x1, Cr 1x1
        data[sof + 11], data[sof + 14] = 0x31, 0x21
    with open(path, "wb") as f:
        f.write(bytes(data))
    return path


@pytest.mark.parametrize("kind", ["cmyk", "12bit", "lossless", "fractional"])
def test_check_only_formats_fail_in_both_loaders(tmp_path, baseline_loader, libjpeg_encoder, kind):
    """CMYK (no CMYK -> RGB conversion in libjpeg), 12-bit and lossless
    frames (an 8-bit libjpeg-turbo 2.1 refuses them) and sampling factors
    that do not divide the largest one: the JAX package's loader raises,
    and so does the port's."""
    path = _check_only_file(tmp_path, libjpeg_encoder, kind)
    with pytest.raises(FileNotFoundError):
        jnative.NativeCanvasLoader(1).load_batch([path], 64)
    with pytest.raises(FileNotFoundError):
        baseline_loader.load_batch([path], 64)


_BUILD = r"""
import sys
from simple_pose_torch.data import native
native.BUILD_DIR = sys.argv[1]
path, seconds = native.build_loader()
native.NativeCanvasLoader(1)
print(path)
"""


def test_concurrent_builds_share_one_library(tmp_path):
    """Four processes start the build at once: one compiles under the file
    lock, the others wait and load its library."""
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert len({o[0].strip() for o in outs}) == 1
    assert [f for f in os.listdir(tmp_path) if f.endswith(".so")] == [
        os.path.basename(outs[0][0].strip())]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


PEOPLE = [1, 3, 1, 4, 2, 1, 1, 3, 2, 1]  # 19 records on 10 images

MODES = {
    "eval_plain": dict(augment=False, shuffle=False, drop_last=False),
    "train_augment": dict(),
    "train_dedup": dict(dedup_canvases=2),
}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    img_root, ann_path, _ = make_synth_coco(str(root), num_images=len(PEOPLE),
                                            people_per_image=PEOPLE, seed=3)
    return (jcoco.load_coco_keypoints(img_root, ann_path),
            tcoco.load_coco_keypoints(img_root, ann_path))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_native_pipeline_matches_jax(records, mode, monkeypatch):
    """use_native=True in both packages: every batch equal key for key, and
    the port decodes through the loader alone (cv2's reader raises)."""
    jrecs, trecs = records

    def no_cv2(path):
        raise AssertionError(f"cv2 path taken for {path}")

    monkeypatch.setattr(tpipe, "_imread_rgb", no_cv2)
    kw = dict(batch_size=4, input_shape=(64, 64), output_shape=(16, 16), canvas=192, seed=7,
              num_threads=2, use_native=True, **MODES[mode])
    jp, tp = jpipe.PosePipeline(jrecs, **kw), tpipe.PosePipeline(trecs, **kw)
    before = native.NativeCanvasLoader.load_batch.calls
    for epoch in (0, 1):
        want, got = list(jp.epoch(epoch)), list(tp.epoch(epoch))
        assert len(got) == len(want) > 0
        for bw, bt in zip(want, got):
            assert set(bt) == set(bw)
            for k in bw:
                assert bt[k].dtype == bw[k].dtype and bt[k].shape == bw[k].shape, k
                np.testing.assert_array_equal(bt[k], bw[k], err_msg=f"{mode} {epoch} {k}")
    assert native.NativeCanvasLoader.load_batch.calls - before >= 2 * len(got)


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_jpeg_fixtures", os.path.join(REPO, "scripts", "make_torch_jpeg_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_decodes_to_committed_crc32():
    loader = native.NativeCanvasLoader(4)
    assert len(_check_crc32(loader, "decoded_crc32.json")) == 48
    assert len(_check_crc32(loader, os.path.join("progressive", "decoded_crc32.json"))) == 6
    assert len(_check_crc32(loader, os.path.join("decoder", "decoded_crc32.json"))) == 15
    for rel in sorted(os.listdir(os.path.join(FIXTURE, "progressive"))):
        if rel.endswith(".jpg"):  # every committed file is progressive
            with open(os.path.join(FIXTURE, "progressive", rel), "rb") as f:
                assert b"\xff\xc2" in f.read(), rel


def test_fixture_json_regenerates(tmp_path):
    """The committed JSON files are what the script makes from its seeds."""
    script = _load_script()
    gt, dets, _ = script.detection_set()
    with open(os.path.join(FIXTURE, "det", "person_keypoints.json")) as f:
        assert json.load(f) == json.loads(json.dumps(gt))
    with open(os.path.join(FIXTURE, "det", "detections.json")) as f:
        assert json.load(f) == json.loads(json.dumps(dets))
    _, ann_path, _ = make_synth_coco(str(tmp_path), num_images=script.OVERFIT_IMAGES,
                                     seed=script.OVERFIT_SEED, paint_markers=True)
    with open(os.path.join(FIXTURE, "overfit", "ann.json")) as f, open(ann_path) as g:
        assert json.load(f) == json.load(g)
    n_person = sum(d["category_id"] == 1 for d in dets)
    assert 32 == len(gt["images"]) and 150 <= n_person <= 250
