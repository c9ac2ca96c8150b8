"""Write the JPEG fixture of the PyTorch port's tests and chip smoke run.

    python scripts/make_torch_jpeg_fixtures.py [--out tests/data_torch_jpeg]
                                               [--progressive-only | --decoder-only]

Needs cv2 (to paint and encode), and gcc with libjpeg's jpeglib.h for the
encoder of decoder/ (ENCODER_SOURCE: arithmetic coding, scan scripts and DAC
conditioning, which cv2 cannot ask for); everything else is numpy from fixed
seeds.  It writes:

  det/images/{id:012d}.jpg    32 painted 640x480 images, 4:4:4 quality 90,
                              1-4 skeleton-like people each
  det/person_keypoints.json   their COCO person-keypoints ground truth
  det/detections.json         a COCO detection-results list: 1-3 jittered
                              boxes per person with scores, a few false
                              positives and a few non-person entries, so
                              that OKS-NMS has work (176 person boxes)
  overfit/imgs/*.jpg,         the painted-marker overfit set (16 images of
  overfit/ann.json            tests/util_synth.make_synth_coco, seed 0)
  decoded_crc32.json          per JPEG: height, width and the CRC32 of its
                              decoded RGB pixels, decoded by the port's
                              native loader (this machine's libjpeg)
  progressive/*.jpg,          6 progressive JPEGs (cv2's default progression
  progressive/                script): 4:4:4 (det image 1's scene), 4:2:0,
    decoded_crc32.json        4:2:2, grayscale, 4:2:0 with a restart
                              interval, and an odd 121x99 4:2:0; their
                              CRC32s as above, each checked against cv2's
                              decode (--progressive-only writes these alone)
  decoder/*.jpg,              15 files of the kinds csrc/jpeg_canvas.cc
  decoder/decoded_crc32.json  decodes as libjpeg does since it repeats
                              libjpeg's handling of them (DECODER): baseline
                              and progressive files cut short (with and
                              without EOI, with restart markers, after the DC
                              scan, after scan 3, inside scan 5: block
                              smoothing), arithmetic-coded sequential and
                              progressive files (restart intervals, DAC
                              conditioning, cut short), multi-scan
                              sequential files, and progressive files whose
                              scans libjpeg only warns about (AC before DC,
                              refinements first); their CRC32s as above
                              (--decoder-only writes these alone)

The JSON files are a function of the seeds alone (tests regenerate and
compare them); the JPEG bytes depend on the encoder's libjpeg.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET_SEED, OVERFIT_SEED = 2024, 0
DET_IMAGES, DET_WH, OVERFIT_IMAGES = 32, (640, 480), 16
PEOPLE_ODDS = (0.3, 0.3, 0.2, 0.2)  # 1-4 people per image, mean 2.3
JPEG_QUALITY = 90

# a front-facing skeleton in units of the person's spread s: COCO joint
# order (nose, then left/right pairs), x to the person's left
_LAYOUT = [(0.0, -2.4), (0.45, -2.6), (-0.45, -2.6), (1.0, -2.3), (-1.0, -2.3),
           (1.1, -1.2), (-1.1, -1.2), (1.7, -0.2), (-1.7, -0.2), (1.9, 0.8), (-1.9, 0.8),
           (0.6, 0.6), (-0.6, 0.6), (0.7, 1.7), (-0.7, 1.7), (0.8, 2.8), (-0.8, 2.8)]
_LIMBS = [(5, 7), (7, 9), (6, 8), (8, 10), (11, 13), (13, 15), (12, 14), (14, 16),
          (5, 6), (11, 12), (5, 11), (6, 12), (0, 5), (0, 6)]


def _r2(x) -> float:
    return round(float(x), 2)


def detection_set(seed: int = DET_SEED):
    """(gt, dets, scenes): the ground truth, the detection results and what
    to paint per image, all drawn from one numpy generator."""
    rng = np.random.default_rng(seed)
    w, h = DET_WH
    images, anns, dets, scenes = [], [], [], []
    for img_id in range(1, DET_IMAGES + 1):
        images.append({"id": img_id, "width": w, "height": h,
                       "file_name": f"{img_id:012d}.jpg"})
        scene = {"bg": rng.integers(30, 200, (2, 3)).tolist(), "people": []}
        for _ in range(1 + int(rng.choice(4, p=PEOPLE_ODDS))):
            s = rng.uniform(12.0, 40.0)
            cx, cy = rng.uniform(2.2 * s, w - 2.2 * s), rng.uniform(3.0 * s, h - 3.0 * s)
            jit = rng.normal(0.0, 0.1, (17, 2)).clip(-0.25, 0.25)
            kp = np.zeros((17, 3))
            kp[:, 0] = np.clip(cx + (np.array([p[0] for p in _LAYOUT]) + jit[:, 0]) * s, 1, w - 2)
            kp[:, 1] = np.clip(cy + (np.array([p[1] for p in _LAYOUT]) + jit[:, 1]) * s, 1, h - 2)
            kp[:, 2] = 2
            kp[:, :2] = np.round(kp[:, :2], 2)
            x0, y0 = max(0.0, kp[:, 0].min() - 0.4 * s), max(0.0, kp[:, 1].min() - 0.4 * s)
            x1, y1 = min(w - 1.0, kp[:, 0].max() + 0.4 * s), min(h - 1.0, kp[:, 1].max() + 0.4 * s)
            box = [_r2(x0), _r2(y0), _r2(x1 - x0), _r2(y1 - y0)]
            anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": 1,
                         "iscrowd": 0, "keypoints": kp.reshape(-1).tolist(),
                         "num_keypoints": 17, "area": _r2(box[2] * box[3]), "bbox": box})
            scene["people"].append({"kp": kp[:, :2].tolist(), "s": _r2(s),
                                    "color": rng.integers(60, 256, 3).tolist()})
            for k in range(1 + int(rng.integers(0, 3))):  # 1-3 detections
                sigma = 0.04 if k == 0 else 0.15
                dx0, dy0, dx1, dy1 = rng.normal(0.0, sigma, 4) * np.array([box[2], box[3]] * 2)
                bx0, by0 = max(0.0, x0 + dx0), max(0.0, y0 + dy0)
                bx1, by1 = min(w - 1.0, x1 + dx1), min(h - 1.0, y1 + dy1)
                score = rng.uniform(0.75, 0.99) if k == 0 else rng.uniform(0.2, 0.8)
                dets.append({"image_id": img_id, "category_id": 1, "score": _r2(score),
                             "bbox": [_r2(bx0), _r2(by0), _r2(bx1 - bx0), _r2(by1 - by0)]})
        for _ in range(int(rng.integers(0, 3))):  # false positives
            bw, bh = rng.uniform(30, 200), rng.uniform(60, 300)
            bx, by = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            dets.append({"image_id": img_id, "category_id": 1, "score": _r2(rng.uniform(0.05, 0.5)),
                         "bbox": [_r2(bx), _r2(by), _r2(bw), _r2(bh)]})
        if img_id % 8 == 0:  # a non-person detection, which the loader skips
            dets.append({"image_id": img_id, "category_id": 3, "score": 0.9,
                         "bbox": [10.0, 10.0, 50.0, 40.0]})
        scenes.append(scene)
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": 1, "name": "person"}]}
    return gt, dets, scenes


def paint(scene, wh=DET_WH):
    """One scene as a BGR uint8 image: a vertical gradient background, then
    each person's limbs in its colour and its joints as discs."""
    import cv2 as cv

    w, h = wh
    top, bottom = np.array(scene["bg"], np.float32)
    t = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    img = np.ascontiguousarray(np.broadcast_to(top + (bottom - top) * t, (h, w, 3)))
    img = img.astype(np.uint8)
    for p in scene["people"]:
        pts = [(int(round(x)), int(round(y))) for x, y in p["kp"]]
        thick = max(2, int(p["s"] / 6))
        for a, b in _LIMBS:
            cv.line(img, pts[a], pts[b], tuple(p["color"]), thick)
        for j, pt in enumerate(pts):
            hue = np.uint8([[[int(j * 180 / 17), 255, 255]]])
            color = tuple(int(v) for v in cv.cvtColor(hue, cv.COLOR_HSV2BGR)[0, 0])
            cv.circle(img, pt, max(2, int(p["s"] / 5)), color, -1)
    return img


# name -> (det scene, (w, h), sampling, quality, restart interval); the
# scene is painted at 640x480 and resized with INTER_AREA
PROGRESSIVE = {
    "p444.jpg": (0, (640, 480), "444", 90, 0),
    "p420.jpg": (1, (640, 480), "420", 90, 0),
    "p422.jpg": (2, (320, 240), "422", 85, 0),
    "gray.jpg": (3, (320, 240), "gray", 90, 0),
    "p420_rst.jpg": (4, (400, 300), "420", 80, 5),
    "odd_121x99.jpg": (5, (121, 99), "420", 95, 0),
}


def write_progressive(out_dir, scenes):
    """The progressive fixture: [(relative path, path)]."""
    import cv2 as cv

    sampling = {"444": cv.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "420": cv.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                "422": cv.IMWRITE_JPEG_SAMPLING_FACTOR_422}
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, (scene, wh, samp, quality, restart) in PROGRESSIVE.items():
        img = paint(scenes[scene])
        if wh != DET_WH:
            img = cv.resize(img, wh, interpolation=cv.INTER_AREA)
        params = [cv.IMWRITE_JPEG_PROGRESSIVE, 1, cv.IMWRITE_JPEG_QUALITY, quality,
                  cv.IMWRITE_JPEG_RST_INTERVAL, restart]
        if samp == "gray":
            img = cv.cvtColor(img, cv.COLOR_BGR2GRAY)
        else:
            params += [cv.IMWRITE_JPEG_SAMPLING_FACTOR, sampling[samp]]
        path = os.path.join(out_dir, name)
        assert cv.imwrite(path, img, params), path
        paths.append((f"progressive/{name}", path))
    return paths


# A JPEG encoder over this machine's libjpeg, for what cv2 cannot set:
#   encoder in.raw out.jpg width height components quality arith progressive
#           restart sampling script dac
# sampling is "hv,hv,hv" per component; script "none" (libjpeg's default),
# "y_then_cbcr" (sequential: Y, then Cb and Cr interleaved) or "each"
# (sequential: one scan per component, Cr first); dac 1 sets DC conditioning
# L=1 U=3 and AC K=2 in place of the defaults 0, 1 and 5.
ENCODER_SOURCE = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc != 13) return 2;
  const int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  if (!in || !out) return 1;
  unsigned char* pix = malloc((size_t)w * h * nc);
  if (fread(pix, 1, (size_t)w * h * nc, in) != (size_t)w * h * nc) return 1;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, atoi(argv[6]), TRUE);
  c.arith_code = atoi(argv[7]);
  c.restart_interval = atoi(argv[9]);
  const char* samp = argv[10];
  for (int i = 0; i < nc && samp[3 * i] && samp[3 * i + 1]; ++i) {
    c.comp_info[i].h_samp_factor = samp[3 * i] - '0';
    c.comp_info[i].v_samp_factor = samp[3 * i + 1] - '0';
  }
  if (atoi(argv[12])) {
    for (int t = 0; t < 2; ++t) {
      c.arith_dc_L[t] = 1;
      c.arith_dc_U[t] = 3;
      c.arith_ac_K[t] = 2;
    }
  }
  static jpeg_scan_info scans[3];
  if (atoi(argv[8])) {
    jpeg_simple_progression(&c);
  } else if (strcmp(argv[11], "y_then_cbcr") == 0 && nc == 3) {
    scans[0] = (jpeg_scan_info){1, {0}, 0, 63, 0, 0};
    scans[1] = (jpeg_scan_info){2, {1, 2}, 0, 63, 0, 0};
    c.scan_info = scans;
    c.num_scans = 2;
  } else if (strcmp(argv[11], "each") == 0 && nc == 3) {
    for (int i = 0; i < 3; ++i) scans[i] = (jpeg_scan_info){1, {2 - i}, 0, 63, 0, 0};
    c.scan_info = scans;
    c.num_scans = 3;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = pix + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  fclose(in);
  free(pix);
  return 0;
}
"""


def build_encoder(build_dir):
    """Compiles ENCODER_SOURCE against libjpeg into build_dir; its path."""
    os.makedirs(build_dir, exist_ok=True)
    src, exe = os.path.join(build_dir, "encoder.c"), os.path.join(build_dir, "encoder")
    with open(src, "w") as f:
        f.write(ENCODER_SOURCE)
    subprocess.run(["gcc", "-O2", src, "-o", exe, "-ljpeg"], check=True, capture_output=True)
    return exe


def encode(encoder, path, img, quality=90, arith=0, progressive=0, restart=0,
           sampling="22,11,11", script="none", dac=0):
    """img (h, w) or (h, w, c) uint8 RGB/gray/CMYK written through the encoder."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    raw = path + ".raw"
    np.ascontiguousarray(img, np.uint8).tofile(raw)
    try:
        subprocess.run([encoder, raw, path, str(w), str(h), str(c), str(quality), str(arith),
                        str(progressive), str(restart), sampling, script, str(dac)],
                       check=True, capture_output=True)
    finally:
        os.remove(raw)


def scan_starts(data):
    """The offsets of a file's SOS markers."""
    return [m.start() for m in re.finditer(b"\xff\xda", data)]


def scan_units(data):
    """(head, units, tail) of a multi-scan file: each unit is one scan with
    the table segments written just before it, so that units can be
    reordered or dropped."""
    marks = [m.start() for m in re.finditer(b"\xff[^\x00\xd0-\xd7\xff]", data)]
    sos = [m for m in marks if data[m + 1] == 0xDA]
    starts = []
    for i, s in enumerate(sos):
        start = s
        for m in reversed([m for m in marks if m < s and (i == 0 or m > sos[i - 1])]):
            if data[m + 1] not in (0xC4, 0xDB, 0xDD, 0xCC):
                break
            start = m
        starts.append(start)
    eoi = data.rindex(b"\xff\xd9")
    units = [data[a:b] for a, b in zip(starts, starts[1:] + [eoi])]
    return data[:starts[0]], units, data[eoi:]


# name -> (det scene, (w, h), how): each scene painted at 640x480 and resized
# with INTER_AREA, then written as DECODER_KINDS says
DECODER = {
    "cut_baseline.jpg": (6, (64, 64), "cut_baseline"),
    "cut_baseline_eoi.jpg": (6, (64, 64), "cut_baseline_eoi"),
    "cut_baseline_rst.jpg": (7, (120, 96), "cut_baseline_rst"),
    "cut_progressive_dc.jpg": (8, (120, 96), "cut_progressive_dc"),
    "cut_progressive_scan3.jpg": (9, (120, 96), "cut_progressive_scan3"),
    "cut_progressive_mid5.jpg": (10, (121, 99), "cut_progressive_mid5"),
    "arith_seq.jpg": (11, (120, 96), "arith_seq"),
    "arith_seq_rst_dac.jpg": (12, (96, 72), "arith_seq_rst_dac"),
    "arith_prog.jpg": (13, (120, 96), "arith_prog"),
    "arith_prog_rst_gray.jpg": (14, (96, 72), "arith_prog_rst_gray"),
    "arith_prog_cut.jpg": (15, (120, 96), "arith_prog_cut"),
    "multiscan_seq.jpg": (16, (120, 96), "multiscan_seq"),
    "multiscan_each_arith.jpg": (17, (96, 72), "multiscan_each_arith"),
    "bogus_ac_before_dc.jpg": (18, (96, 72), "bogus_ac_before_dc"),
    "bogus_refine_first.jpg": (19, (96, 72), "bogus_refine_first"),
}


def decoder_file(encoder, path, img, how):
    """Writes one file of DECODER."""
    import cv2 as cv

    bgr = img[..., ::-1]
    if how.startswith("cut_baseline"):
        params = [cv.IMWRITE_JPEG_RST_INTERVAL, 2] if how.endswith("rst") else []
        assert cv.imwrite(path, bgr, params)
        with open(path, "rb") as f:
            data = f.read()
        data = data[:len(data) * 2 // 3] + (b"" if how == "cut_baseline" else b"\xff\xd9")
    elif how.startswith("cut_progressive"):
        assert cv.imwrite(path, bgr, [cv.IMWRITE_JPEG_PROGRESSIVE, 1])
        with open(path, "rb") as f:
            data = f.read()
        sos = scan_starts(data)
        cut = {"dc": sos[1], "scan3": sos[3], "mid5": (sos[4] + sos[5]) // 2}[how.split("_")[-1]]
        data = data[:cut] + b"\xff\xd9"
    elif how.startswith("bogus"):
        assert cv.imwrite(path, bgr, [cv.IMWRITE_JPEG_PROGRESSIVE, 1])
        with open(path, "rb") as f:
            head, units, tail = scan_units(f.read())
        n = len(units)
        order = (list(range(1, n)) + [0] if how == "bogus_ac_before_dc"
                 else [0] + list(range(n - 1, 0, -1)))
        data = head + b"".join(units[i] for i in order) + tail
    else:
        kw = {"arith_seq": dict(arith=1),
              "arith_seq_rst_dac": dict(arith=1, restart=3, dac=1, sampling="11,11,11"),
              "arith_prog": dict(arith=1, progressive=1),
              "arith_prog_rst_gray": dict(arith=1, progressive=1, restart=2),
              "arith_prog_cut": dict(arith=1, progressive=1),
              "multiscan_seq": dict(script="y_then_cbcr"),
              "multiscan_each_arith": dict(arith=1, script="each", sampling="21,11,11"),
              }[how]
        encode(encoder, path, img[..., 0] if how.endswith("gray") else img, **kw)
        with open(path, "rb") as f:
            data = f.read()
        if how == "arith_prog_cut":
            data = data[:scan_starts(data)[4]] + b"\xff\xd9"
    with open(path, "wb") as f:
        f.write(data)


def write_decoder(out_dir, scenes, build_dir):
    """The decoder fixture: [(relative path, path)]."""
    import cv2 as cv

    encoder = build_encoder(build_dir)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, (scene, wh, how) in DECODER.items():
        img = cv.resize(paint(scenes[scene]), wh, interpolation=cv.INTER_AREA)[..., ::-1]
        path = os.path.join(out_dir, name)
        decoder_file(encoder, path, np.ascontiguousarray(img), how)
        paths.append((f"decoder/{name}", path))
    return paths


def write_crc32(path, decoded):
    with open(path, "w") as f:
        json.dump({rel: {"height": v[0], "width": v[1], "crc32": v[2]}
                   for rel, v in decoded.items()}, f, indent=0, sort_keys=True)


def decode_records(paths):
    """{relative path: (height, width, crc32 of the RGB pixels)} decoded by
    the port's native loader."""
    from simple_pose_torch.data.native import NativeCanvasLoader

    loader = NativeCanvasLoader(4)
    out = {}
    for rel, path in paths:
        canvas, hh, ww = loader.load_batch([path], 640)
        pix = np.ascontiguousarray(canvas[0, :hh[0], :ww[0]])
        out[rel] = (int(hh[0]), int(ww[0]), zlib.crc32(pix.tobytes()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data_torch_jpeg"))
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--progressive-only", action="store_true",
                      help="write the progressive files and their CRC32s alone")
    only.add_argument("--decoder-only", action="store_true",
                      help="write the decoder/ files and their CRC32s alone")
    args = ap.parse_args(argv)
    import cv2 as cv

    sys.path.insert(0, REPO)
    from tests.util_synth import make_synth_coco

    gt, dets, scenes = detection_set()
    import tempfile

    with tempfile.TemporaryDirectory() as build_dir:
        decoder = write_decoder(os.path.join(args.out, "decoder"), scenes, build_dir)
    write_crc32(os.path.join(args.out, "decoder", "decoded_crc32.json"), decode_records(decoder))
    print(f"{len(decoder)} decoder-coverage JPEGs under {args.out}/decoder")
    if args.decoder_only:
        return
    progressive = write_progressive(os.path.join(args.out, "progressive"), scenes)
    decoded = decode_records(progressive)
    for rel, path in progressive:
        rgb = np.ascontiguousarray(cv.imread(path, cv.IMREAD_COLOR)[..., ::-1])
        assert zlib.crc32(rgb.tobytes()) == decoded[rel][2], f"{rel}: libjpeg and cv2 differ"
    write_crc32(os.path.join(args.out, "progressive", "decoded_crc32.json"), decoded)
    print(f"{len(progressive)} progressive JPEGs under {args.out}/progressive")
    if args.progressive_only:
        return

    det = os.path.join(args.out, "det")
    os.makedirs(os.path.join(det, "images"), exist_ok=True)
    params = [cv.IMWRITE_JPEG_QUALITY, JPEG_QUALITY,
              cv.IMWRITE_JPEG_SAMPLING_FACTOR, cv.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    paths = []
    for im, scene in zip(gt["images"], scenes):
        path = os.path.join(det, "images", im["file_name"])
        cv.imwrite(path, paint(scene), params)
        paths.append((f"det/images/{im['file_name']}", path))
    with open(os.path.join(det, "person_keypoints.json"), "w") as f:
        json.dump(gt, f)
    with open(os.path.join(det, "detections.json"), "w") as f:
        json.dump(dets, f)

    img_root, _, _ = make_synth_coco(os.path.join(args.out, "overfit"),
                                     num_images=OVERFIT_IMAGES, seed=OVERFIT_SEED,
                                     paint_markers=True)
    for name in sorted(os.listdir(img_root)):
        paths.append((f"overfit/imgs/{name}", os.path.join(img_root, name)))

    write_crc32(os.path.join(args.out, "decoded_crc32.json"), decode_records(paths))
    n_person = sum(d["category_id"] == 1 for d in dets)
    print(f"{len(paths)} JPEGs, {len(gt['annotations'])} people, {n_person} person boxes "
          f"({len(dets)} detections) under {args.out}")


if __name__ == "__main__":
    main()
