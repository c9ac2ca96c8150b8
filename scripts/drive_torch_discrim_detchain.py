"""Detector-chain AP gate of the PyTorch port: the reference's
benchmark-producing chain (a detections JSON -> ``predicts_by_detections``
-> rescoring by box score x mean(conf > 0.2) -> greedy OKS-NMS -> COCOeval)
on a crowded held-out corpus, where both decision stages have work to do.
The counterpart of scripts/drive_discrim_detchain.py.

    python scripts/drive_torch_discrim_detchain.py                    # ResNet-18-DConv
    python scripts/drive_torch_discrim_detchain.py --model pose_resnet_dconv:resnet50 --se \\
        --out DISCRIM_TORCH_DETCHAIN_R50.json                         # + the K2 variant
    python scripts/drive_torch_discrim_detchain.py --model pose_resnet_dconv:resnet50 --se \\
        --witness tests/data_torch_detchain/r50se_witness.npz         # + its witness
    python scripts/drive_torch_discrim_detchain.py --ckpt <dir>/weights/pose_resnet_dconv_last.pth
    python scripts/drive_torch_discrim_detchain.py --device cpu --epochs 1 --train-images 8 \\
        --val-images 4 --input 64                                     # rehearsal on the CPU

Runs on CUDA unless ``--device cpu`` is given; without a card it exits 2.

* **Corpus** (scripts/torch_discrim_corpus.paint_flipsym, lossless PNGs in
  ``--dir``): the people counts drawn from ``default_rng(7)``, val first.
  Val: seed 777, 256x192, 3-4 people an image, scale 9-13,
  ``min_center_sep`` 1.7; train: seed 100, 1-3 people, scale 10-15,
  ``min_center_sep`` 2.4; blob sigma 2.5, limbs in a gray per person.
* **Training** through ``python -m simple_pose_torch.main`` in a subprocess
  (drive_torch_discrim_ap.train, which also reads the kernels' launch
  counters): batch 32 (``--train-images`` where fewer), canvas 288,
  ``--input`` square crops, augmentation scale 0.9-1.1, +-12 degrees and
  flip, Adam 1e-3 with x0.1 at ``epochs - 100``, bf16 autocast on CUDA,
  validation every ``--val-every`` epochs.  ``--ckpt`` skips it.
* **Detections** (:func:`synth_detections`, seed 2025): per person one
  jittered true box and 1-2 duplicates, two person-sized false positives an
  image whose box scores often outrank true boxes.
* **One model pass**: ``predicts_by_detections`` at batch 32, canvas 288,
  ``in_vis_thre`` 0.2, OKS 0.9; then the AP ladder in numpy on its raw
  predictions (:func:`ap_ladder`): the raw dump (box score, no
  suppression), rescoring alone (OKS 1.01), the full chain (OKS 0.9), and
  OKS 0.5, OKS 0.99 and maxDets 2 as perturbations.
* **The K2 variant**, where layer1 is a Bottleneck chain (ResNet-50): the
  same pass with ``fused_layer1``; its full-chain AP, its delta and how far
  it moved the keypoints, K2's launches.
* **The witness** (``--witness``, :func:`witness`): the detection whose
  keypoint the K2 variant moved furthest, replayed through the fused, the
  unfused and an f32 evaluator: its folded layer1 blocks, layer1 four ways
  on the crop and its flip (K2, the plain chain, cuDNN bf16, f32 without
  TF32) and the three heatmaps, in one ``.npz`` that
  tests/test_torch_detchain_witness.py holds against JAX.

Writes one JSON (``--out``: the JAX script's schema plus the card, torch's
version, the launch counts and the gate) and exits 1 when the gate fails:
``ap_raw_dump < ap_full_chain`` and, where the K2 variant ran, its
``|delta| <= 0.015``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import time

import numpy as np

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(SCRIPTS)
sys.path[:0] = [REPO, SCRIPTS]

import drive_torch_discrim_ap as ap_gate  # noqa: E402

MODELS = ("pose_resnet_dconv:resnet18", "pose_resnet_dconv:resnet50")
DELTA_BOUND = ap_gate.DELTA_BOUND
CANVAS = 288
IN_VIS_THRE = 0.2
OKS_THRE = 0.9
BATCH = 32
DET_SEED = 2025
# (seed, scale range, min_center_sep) of the two corpora
VAL_DRAW = (777, (9.0, 13.0), 1.7)
TRAIN_DRAW = (100, (10.0, 15.0), 2.4)


def synth_detections(gt, seed=2025, dup_lo=1, dup_hi=2, fp_per_image=2):
    """Detector output over a GT dict: per annotation one jittered true box
    and ``dup_lo``..``dup_hi`` duplicates, plus ``fp_per_image`` person-sized
    background boxes an image.  The scores of the three overlap, so the raw
    box-score order is wrong where rescoring can repair it (false positives
    draw up to 0.90, true boxes 0.60-0.85).

    :returns: (detections in the COCO detection-results schema,
        {"true", "dup", "fp"} counts)"""
    rng = np.random.default_rng(seed)
    anns_by_img = {}
    for a in gt["annotations"]:
        anns_by_img.setdefault(a["image_id"], []).append(a)
    mean_w = float(np.mean([a["bbox"][2] for a in gt["annotations"]]))
    mean_h = float(np.mean([a["bbox"][3] for a in gt["annotations"]]))
    dets, n_true, n_dup, n_fp = [], 0, 0, 0
    for img in gt["images"]:
        img_id, iw, ih = img["id"], img["width"], img["height"]
        for a in anns_by_img.get(img_id, []):
            x, y, w, h = a["bbox"]

            def jbox(mag):
                dx = float(rng.normal(0.0, mag * w))
                dy = float(rng.normal(0.0, mag * h))
                sw = float(rng.uniform(1.0 - mag, 1.0 + mag))
                sh = float(rng.uniform(1.0 - mag, 1.0 + mag))
                return [x + dx, y + dy, w * sw, h * sh]

            dets.append({"image_id": img_id, "category_id": 1, "bbox": jbox(0.05),
                         "score": float(rng.uniform(0.60, 0.85))})
            n_true += 1
            for _ in range(int(rng.integers(dup_lo, dup_hi + 1))):
                dets.append({"image_id": img_id, "category_id": 1, "bbox": jbox(0.14),
                             "score": float(rng.uniform(0.40, 0.75))})
                n_dup += 1
        for _ in range(fp_per_image):
            fw = mean_w * float(rng.uniform(0.7, 1.3))
            fh = mean_h * float(rng.uniform(0.7, 1.3))
            dets.append({"image_id": img_id, "category_id": 1,
                         "bbox": [float(rng.uniform(0, max(1.0, iw - fw))),
                                  float(rng.uniform(0, max(1.0, ih - fh))), fw, fh],
                         "score": float(rng.uniform(0.50, 0.90))})
            n_fp += 1
    return dets, {"true": n_true, "dup": n_dup, "fp": n_fp}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=MODELS[0], choices=MODELS)
    ap.add_argument("--se", action="store_true", help="SE blocks (reduction: true)")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--val-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=11, help="the trainer's seed (init, data order)")
    ap.add_argument("--train-images", type=int, default=192)
    ap.add_argument("--val-images", type=int, default=48)
    ap.add_argument("--input", type=int, default=128, help="square crop edge")
    ap.add_argument("--ckpt", default=None,
                    help="evaluate this _last.pth and train nothing")
    ap.add_argument("--device", default=None, choices=[None, "cuda", "cpu"],
                    help="default: cuda; cpu only to rehearse")
    ap.add_argument("--dir", default=None,
                    help="run directory: corpus, checkpoints, results (default "
                         ".discrim_torch/detchain_<type>_<name>[_se]_s<seed>)")
    ap.add_argument("--out", default=None,
                    help="result JSON (default DISCRIM_TORCH_DETCHAIN.json at the repo root)")
    ap.add_argument("--witness", default=None,
                    help="write the K2 variant's largest keypoint shift's witness to this .npz")
    args = ap.parse_args(argv)
    args.val_every = min(args.val_every, args.epochs)
    if args.epochs % args.val_every:
        ap.error(f"--epochs {args.epochs} must be a multiple of --val-every "
                 f"{args.val_every}: the trainer saves _last.pth when it validates")
    args.mtype, args.mname = args.model.split(":")
    args.batch_size = min(BATCH, args.train_images)
    se = "_se" if args.se else ""
    args.dir = os.path.abspath(args.dir or os.path.join(
        REPO, ".discrim_torch", f"detchain_{args.mtype}_{args.mname}{se}_s{args.seed}"))
    args.out = os.path.abspath(args.out or os.path.join(REPO, "DISCRIM_TORCH_DETCHAIN.json"))
    if args.ckpt:
        args.ckpt = os.path.abspath(args.ckpt)
    if args.witness:
        args.witness = os.path.abspath(args.witness)
    return args


model_cfg = ap_gate.model_cfg


def train_config(args, corpus, amp):
    """The JAX script's recipe: drive_torch_discrim_ap's with canvas 288 and
    flip augmentation."""
    return ap_gate.train_config(args, corpus, amp, canvas=CANVAS, aug_flip=True)


def paint_corpora(args):
    """Paint val and, unless ``--ckpt`` is given, train into ``args.dir``
    (earlier images are removed first; the checkpoints stay).

    :returns: (tr_root, tr_ann, va_root, va_ann, va_gt); the train entries
        None with ``--ckpt``"""
    from torch_discrim_corpus import paint_flipsym

    for sub in ("train", "val"):
        shutil.rmtree(os.path.join(args.dir, sub), ignore_errors=True)
    rng = np.random.default_rng(7)
    seed, scale_range, sep = VAL_DRAW
    va_root, va_ann, va_gt = paint_flipsym(
        os.path.join(args.dir, "val"), num_images=args.val_images, seed=seed, img_w=256,
        img_h=192, people_per_image=[int(p) for p in rng.integers(3, 5, args.val_images)],
        scale_range=scale_range, min_center_sep=sep, blob_sigma=2.5)
    if args.ckpt:
        return None, None, va_root, va_ann, va_gt
    seed, scale_range, sep = TRAIN_DRAW
    tr_root, tr_ann, _ = paint_flipsym(
        os.path.join(args.dir, "train"), num_images=args.train_images, seed=seed, img_w=256,
        img_h=192, people_per_image=[int(p) for p in rng.integers(1, 4, args.train_images)],
        scale_range=scale_range, min_center_sep=sep, blob_sigma=2.5)
    return tr_root, tr_ann, va_root, va_ann, va_gt


def write_detections(args, va_gt):
    """The synthetic detections of ``va_gt`` as ``<dir>/synth_detections.json``.

    :returns: (path, {"true", "dup", "fp", "total"})"""
    dets, stats = synth_detections(va_gt, seed=DET_SEED)
    path = os.path.join(args.dir, "synth_detections.json")
    with open(path, "w") as f:
        json.dump(dets, f)
    return path, {**stats, "total": len(dets)}


def run_chain(args, ckpt, va_root, det_json, va_ann, name, fused_layer1=False):
    """One ``predicts_by_detections`` pass at the gate's settings, every
    kernel's counter zeroed just before and read just after; the raw
    predictions in ``<dir>/raw_<name>.json``, the rescored and filtered ones
    in ``<dir>/filtered_<name>.json``.

    :returns: (stats of the full chain, launch counts, raw predictions' path)"""
    from simple_pose_torch.evalkit.workflows import predicts_by_detections
    from simple_pose_torch.utils.cuda_build import launch_counts, zero_launch_counts

    raw = os.path.join(args.dir, f"raw_{name}.json")
    zero_launch_counts()
    stats = predicts_by_detections(
        va_root, det_json, va_ann, model_cfg(args), weights=ckpt, batch_size=args.batch_size,
        input_shape=(args.input, args.input), canvas=CANVAS, out_path=raw,
        in_vis_thre=IN_VIS_THRE, oks_thre=OKS_THRE, fused_layer1=fused_layer1,
        device=args.device, filtered_out_path=os.path.join(args.dir, f"filtered_{name}.json"),
        use_native=False, img_ext=".png")
    return stats, launch_counts(), raw


def ap_ladder(raw_path, va_ann, out_dir):
    """The AP ladder on one file of raw predictions, in numpy through the
    port's ``rescore_and_filter`` and COCOeval: {"raw_dump" (each
    detection scored by its box score, nothing suppressed), "rescore_only"
    (OKS 1.01: OKS <= 1, so nothing is suppressed), "full_chain" (OKS 0.9),
    "oks_thre_0.5", "oks_thre_0.99", "maxdets_2" (the full chain's output
    evaluated with maxDets 2, the reference's being 20)}: AP.  Each rung
    writes ``<out_dir>/ladder_<rung>.json``."""
    from simple_pose_torch.evalkit.workflows import rescore_and_filter
    from simple_pose_torch.metrics.cocoeval import CocoKeypointsGT, KeypointEval, evaluate_map

    with open(raw_path) as f:
        raw_preds = json.load(f)
    raw_results = [{"image_id": int(p["img_id"]), "category_id": 1, "keypoints": p["kps"],
                    "score": float(p["score"])} for p in raw_preds]
    aps = {"raw_dump": float(evaluate_map(raw_results, va_ann)["AP"])}
    for rung, oks in (("rescore_only", 1.01), ("full_chain", OKS_THRE),
                      ("oks_thre_0.5", 0.5), ("oks_thre_0.99", 0.99)):
        aps[rung] = float(rescore_and_filter(
            raw_path, va_ann, IN_VIS_THRE, oks,
            out_path=os.path.join(out_dir, f"ladder_{rung}.json"))["AP"])
    with open(os.path.join(out_dir, "ladder_full_chain.json")) as f:
        full = json.load(f)
    ev = KeypointEval(CocoKeypointsGT(va_ann), full, max_dets=2)
    ev.evaluate()
    ev.accumulate()
    aps["maxdets_2"] = float(ev.summarize()["AP"])
    return aps


def has_bottleneck_layer1(args) -> bool:
    """Whether the model's layer1 folds into K2's chain."""
    from simple_pose_torch.models.registry import build_from_cfg

    return bool(build_from_cfg(model_cfg(args)).layer1_block_names())


def kp_shift(raw_want, raw_got):
    """How far one pass's keypoints lie from another's on the same
    detections: the mean and the largest distance in image px, and the
    [detection, joint] of the largest."""
    with open(raw_want) as f:
        want = json.load(f)
    with open(raw_got) as f:
        got = json.load(f)
    if [(p["img_id"], p["score"]) for p in want] != [(p["img_id"], p["score"]) for p in got]:
        raise RuntimeError("the two passes predicted other detections")
    kw, kg = (np.asarray([p["kps"] for p in ps]).reshape(len(ps), -1, 3)[..., :2]
              for ps in (want, got))
    d = np.linalg.norm(kg - kw, axis=-1)
    det, joint = np.unravel_index(int(np.argmax(d)), d.shape)
    return {"kp_shift_px_mean": float(d.mean()), "kp_shift_px_max": float(d.max()),
            "kp_shift_argmax": [int(det), int(joint)]}


@contextlib.contextmanager
def layer1_taps(model):
    """Records, on each forward of a ResNet pose ``model``, what its layer1
    takes (the stem's max-pool output) and gives (layer2's input) under
    ``"x"`` and ``"y"``: the same taps whether layer1 runs as modules or
    as the folded chain."""
    seen = {"x": [], "y": []}
    hooks = [model.maxpool.register_forward_hook(lambda m, i, o: seen["x"].append(o.detach())),
             model.layer2.register_forward_pre_hook(lambda m, i: seen["y"].append(i[0].detach()))]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def no_tf32():
    """f32 convs and matmuls in full f32 (cuDNN's TF32 is on by default)."""
    import torch

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def evaluators(args, ckpt):
    """{"fused", "unfused", "f32"}: the K2 variant's and the chain's
    evaluators (amp as the passes run them) and an f32 one."""
    from simple_pose_torch.evalkit.workflows import PoseEvaluator

    shape = (args.input, args.input)
    return {name: PoseEvaluator(model_cfg(args), ckpt, shape, fused_layer1=name == "fused",
                                amp=False if name == "f32" else "auto", device=args.device)
            for name in ("fused", "unfused", "f32")}


def layer1_outputs(evs, x):
    """layer1 on ``x`` (its input, [B, C, h, w] in the passes' dtype) four
    ways: {"k2": the fused evaluator's folded chain (the kernel on a card),
    "plain": bottleneck_chain_reference on the same folded blocks,
    "cudnn": the unfused evaluator's modules under its autocast, "f32": the
    f32 evaluator's modules on x in f32, without TF32}."""
    import torch

    from simple_pose_torch.ops.bottleneck_chain import bottleneck_chain, bottleneck_chain_reference

    fused, unfused = evs["fused"], evs["unfused"]
    cd = fused.dtype or torch.float32
    out = {"k2": bottleneck_chain(x, fused._layer1_folded, compute_dtype=cd),
           "plain": bottleneck_chain_reference(x, fused._layer1_folded, compute_dtype=cd)}
    with torch.autocast(x.device.type, dtype=unfused.dtype or torch.float32,
                        enabled=unfused.dtype is not None):
        out["cudnn"] = unfused.model.layer1(x)
    with no_tf32():
        out["f32"] = evs["f32"].model.layer1(x.float())
    return out


def rel_errors(got, want):
    """(max, mean) of |got - want| relative to max|want|."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    return d.max().item() / scale, d.mean().item() / scale


def _bits(t):
    """A tensor as numpy for the witness: bf16 as its raw uint16 bits, else
    float32."""
    import torch

    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.float().numpy()


# the witness's bf16 layer1 outputs, in the order of its ``y_bf16``
Y_BF16 = ("k2", "plain", "cudnn")


def witness(args, ckpt, va_root, det_json, raw_unfused, raw_fused, shift, path):
    """Replay the pose batch that holds detection ``shift["kp_shift_argmax"]``
    (the K2 variant's largest keypoint shift) through the three
    :func:`evaluators`, and save what its layer1 saw to ``path`` (.npz):
    ``x`` (layer1's input of the crop, as the fused pass took it, and of its
    flip), ``block<i>_<key>`` (the folded blocks as the chain takes them:
    matrices in the compute dtype, biases f32), ``y_bf16`` (K2's, the plain
    chain's and cuDNN's :func:`layer1_outputs` of x stacked in
    :data:`Y_BF16`'s order) and ``y_f32``, ``heat_fused``, ``heat_unfused``,
    ``heat_f32`` (the crop's heatmaps in the replayed batch), ``trans_inv``,
    ``kps_fused`` / ``kps_unfused`` (the passes' keypoints of the
    detection, x, y, conf) and ``kps_f32``, and ``meta`` (JSON: where the
    crop lies, the replay's agreement with the passes, the errors on the
    device).  bf16 tensors are kept as raw uint16 bits (:func:`save_npz_lzma`).

    :returns: meta"""
    import torch

    from simple_pose_torch.data.coco import load_detection_boxes
    from simple_pose_torch.data.pipeline import DetBoxPipeline
    from simple_pose_torch.evalkit.workflows import _dedup_plan
    from simple_pose_torch.ops.bottleneck_chain import FOLDED_KEYS

    det, joint = shift["kp_shift_argmax"]
    shape = (args.input, args.input)
    pipe = DetBoxPipeline(load_detection_boxes(va_root, det_json, img_ext=".png"),
                          args.batch_size, input_shape=shape,
                          output_shape=(shape[0] // 4, shape[1] // 4), canvas=CANVAS,
                          use_native=False, **_dedup_plan(args.batch_size, True))
    seen = 0
    for index, batch in enumerate(pipe.epoch(0)):  # the passes keep the valid rows in order
        valid = np.flatnonzero(np.asarray(batch["valid"]) > 0.5)
        if det < seen + len(valid):
            row = int(valid[det - seen])
            break
        seen += len(valid)
    else:
        raise RuntimeError(f"detection {det} is past the pass's {seen} predictions")
    evs = evaluators(args, ckpt)
    got = {}
    with torch.no_grad():
        for name, ev in evs.items():
            with layer1_taps(ev.model) as taps, (no_tf32() if name == "f32"
                                                 else contextlib.nullcontext()):
                out = ev(batch)
                heat = ev.heatmaps(batch)
            got[name] = {"kps": out["kps"][row].cpu().numpy(), "heat": heat[row],
                         "x": taps["x"][0][row:row + 1], "y": taps["y"][0][row:row + 1]}
        fused = evs["fused"]
        crop = fused._inputs(*fused._batch_tensors(batch))[row:row + 1]
        with layer1_taps(fused.model) as taps:
            fused._forward(crop.flip(3))
        x = torch.cat([got["fused"]["x"], taps["x"][0]])
        ys = layer1_outputs(evs, x)
    card = {}
    for name, raw in (("fused", raw_fused), ("unfused", raw_unfused)):
        with open(raw) as f:
            card[name] = np.asarray(json.load(f)[det]["kps"], np.float32).reshape(-1, 3)
    errs = {f"{a}_vs_{b}": rel_errors(ys[a], ys[b])
            for a, b in (("k2", "plain"), ("k2", "f32"), ("cudnn", "f32"), ("plain", "f32"),
                         ("k2", "cudnn"))}
    meta = {
        "detection": int(det), "joint": int(joint), "batch": index, "row": row,
        "img_id": int(np.asarray(batch["img_id"])[row]),
        "kp_shift_px_max": shift["kp_shift_px_max"],
        "dtype": str(x.dtype), "device": str(x.device),
        "card": ap_gate.card_line() if x.device.type == "cuda" else None,
        # the replay against the passes: keypoints (px) and layer1 (max abs)
        "replay_kp_px": {n: float(np.abs(got[n]["kps"] - card[n][:, :2]).max())
                         for n in ("fused", "unfused")},
        "x_fused_vs_unfused": (got["fused"]["x"].float() - got["unfused"]["x"].float())
        .abs().max().item(),
        "k2_batch_vs_pair": (got["fused"]["y"].float() - ys["k2"][:1].float()).abs().max().item(),
        "cudnn_batch_vs_pair": (got["unfused"]["y"].float() - ys["cudnn"][:1].float())
        .abs().max().item(),
        "rel_errors": errs,
    }
    arrays = {"x": _bits(x), "trans_inv": np.asarray(batch["trans_inv"], np.float32)[row],
              "y_bf16": np.stack([_bits(ys[k]) for k in Y_BF16]), "y_f32": _bits(ys["f32"]),
              "kps_f32": got["f32"]["kps"], "meta": np.asarray(json.dumps(meta))}
    arrays.update({f"heat_{n}": _bits(got[n]["heat"]) for n in evs})
    arrays.update({f"kps_{n}": card[n] for n in card})
    for i, blk in enumerate(fused._layer1_folded):
        arrays.update({f"block{i}_{k}": _bits(v) for k, v in blk.items() if k in FOLDED_KEYS})
    save_npz_lzma(path, arrays)
    return meta


def save_npz_lzma(path, arrays):
    """``np.savez`` with each member LZMA-compressed (``np.load`` reads it):
    its window spans a whole member, so near-equal tensors stacked in one
    cost little more than one."""
    import zipfile

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_LZMA) as zf:
        for name, arr in arrays.items():
            with zf.open(f"{name}.npy", "w") as f:
                np.lib.format.write_array(f, np.asarray(arr), allow_pickle=False)


def gate(ap_raw, ap_full, fused):
    """The JAX script's rule, ``ap_raw < ap_full``, and where the K2 variant
    ran (``fused``: its entry) its ``|delta| <= DELTA_BOUND``."""
    out = {"rule": "ap_raw_dump < ap_full_chain", "chain_improves": bool(ap_raw < ap_full)}
    passed = out["chain_improves"]
    if fused is not None:
        out["delta_bound"] = DELTA_BOUND
        out["fused_layer1_within_bound"] = bool(abs(fused["delta"]) <= DELTA_BOUND)
        passed = passed and out["fused_layer1_within_bound"]
    out["passed"] = bool(passed)
    return out


def launch_checks(train, chain):
    """What the counters show on CUDA (reported beside the gate): the
    whole-crop kernel once per training step, K1 never, K2 only in the
    fused pass."""
    checks = {}
    if train is not None:
        checks["crop_kernel_once_per_step"] = train["rotate_resample_crop"] == train["steps"] > 0
        checks["k1_never_in_training"] = train["rotate_resample"] == 0
    checks["k1_never_in_eval"] = all(c["rotate_resample"] == 0 for c in chain.values())
    checks["k2_not_in_unfused"] = chain["unfused"]["bottleneck_chain"] == 0
    if "fused_layer1" in chain:
        checks["k2_in_fused_layer1"] = chain["fused_layer1"]["bottleneck_chain"] > 0
    return checks


def _r4(x):
    return round(float(x), 4)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    on_cuda = args.device != "cpu"
    if on_cuda and not torch.cuda.is_available():
        print("drive_torch_discrim_detchain: no CUDA device (pass --device cpu to rehearse)",
              file=sys.stderr)
        return 2
    card = ap_gate.card_line() if on_cuda else None
    if card:
        print(card, flush=True)
    t_start = time.perf_counter()
    os.makedirs(args.dir, exist_ok=True)
    *corpus, va_gt = paint_corpora(args)
    _, _, va_root, va_ann = corpus
    progress, train_s, train_launches = {"ap_by_epoch": {}, "segments": []}, 0.0, None
    ckpt = args.ckpt
    if not ckpt:
        progress = ap_gate._load_progress(args)
        t0 = time.perf_counter()
        ap_gate.train(args, train_config(args, corpus, amp=on_cuda), progress)
        train_s = time.perf_counter() - t0
        ckpt = os.path.join(args.dir, "weights", f"{args.mtype}_last.pth")
        segs = progress["segments"]
        train_launches = {k: sum(s[k] for s in segs)
                          for k in ("steps", "rotate_resample_crop", "rotate_resample")}
        train_launches["segments"] = segs

    t0 = time.perf_counter()
    det_json, det_stats = write_detections(args, va_gt)
    print(json.dumps({"detections": det_stats}), flush=True)
    full, chain_launches, raw = run_chain(args, ckpt, va_root, det_json, va_ann, "unfused")
    chain_launches = {"unfused": chain_launches}
    aps = ap_ladder(raw, va_ann, args.dir)
    ap_full = float(full["AP"])
    if aps["full_chain"] != ap_full:
        raise RuntimeError(f"the ladder's full chain {aps['full_chain']} is not the pass's "
                           f"{ap_full}")
    print(json.dumps({"ladder": aps}), flush=True)
    variants, fused = {}, None
    if has_bottleneck_layer1(args):
        got, chain_launches["fused_layer1"], raw_fused = run_chain(
            args, ckpt, va_root, det_json, va_ann, "fused_layer1", fused_layer1=True)
        fused = {"ap_full_chain": _r4(got["AP"]), "delta_vs_unfused": _r4(got["AP"] - ap_full),
                 "delta": got["AP"] - ap_full, **kp_shift(raw, raw_fused),
                 "k2_launches": chain_launches["fused_layer1"]["bottleneck_chain"]}
        print(json.dumps({"fused_layer1": fused}), flush=True)
        if args.witness:
            fused["witness"] = witness(args, ckpt, va_root, det_json, raw, raw_fused, fused,
                                       args.witness)
            print(json.dumps({"witness": fused["witness"]}), flush=True)
    verdict = gate(aps["raw_dump"], ap_full, fused)
    if fused is not None:
        del fused["delta"]
        variants["fused_layer1"] = fused
    eval_s = time.perf_counter() - t0

    with open(raw) as f:
        n_raw = len(json.load(f))
    out = {
        "backend": "cuda" if on_cuda else "cpu",
        "model": args.model,
        "se": args.se,
        "checkpoint": ckpt,
        "corpus": {"images": args.val_images, "people": "3-4/img, min_center_sep=1.7",
                   "annotations": len(va_gt["annotations"]), "format": "png"},
        "detections": det_stats,
        "raw_predictions": n_raw,
        "ap_raw_dump": _r4(aps["raw_dump"]),
        "ap_rescore_only": _r4(aps["rescore_only"]),
        "ap_full_chain": _r4(ap_full),
        "chain_improves": verdict["chain_improves"],
        "perturbations": {rung: {"ap": _r4(aps[rung]), "delta_vs_full": _r4(aps[rung] - ap_full)}
                          for rung in ("oks_thre_0.5", "oks_thre_0.99", "maxdets_2")},
        "variants": variants,
        "seed": args.seed,
        "epochs_run": 0 if args.ckpt else args.epochs,
        "ap_by_epoch": progress["ap_by_epoch"],
        "wall_s": round(time.perf_counter() - t_start, 1),
        "train_s": round(train_s, 1),
        "eval_s": round(eval_s, 1),
        "card": card,
        "device": torch.cuda.get_device_name(0) if on_cuda else "cpu",
        "torch": f"{torch.__version__} (CUDA {torch.version.cuda})",
        "config": {"batch_size": args.batch_size, "input": args.input, "canvas": CANVAS,
                   "train_images": args.train_images, "val_images": args.val_images,
                   "val_every": args.val_every, "det_seed": DET_SEED,
                   "in_vis_thre": IN_VIS_THRE, "oks_thre": OKS_THRE},
        "launches": {"train": train_launches, "chain": chain_launches,
                     "checks": launch_checks(train_launches, chain_launches)
                     if on_cuda else None},
        "gate": verdict,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0 if verdict["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
