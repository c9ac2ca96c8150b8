"""Discriminative held-out AP gate of the PyTorch port: train on a painted
marker corpus through ``python -m simple_pose_torch.main``, then evaluate
``predicts_by_gt`` on a held-out, harder corpus where the float model lands
strictly below AP 1.0, so a variant that costs tenths of AP shows.  The
counterpart of scripts/drive_discrim_ap.py, drive_discrim_fusedl1.py and
drive_discrim_mesh.py.

    python scripts/drive_torch_discrim_ap.py --epochs 600 --val-every 100
    python scripts/drive_torch_discrim_ap.py --model pose_resnet_duc:resnet18 --epochs 600 \\
        --val-every 100 --out DISCRIM_TORCH_DUC.json
    python scripts/drive_torch_discrim_ap.py --model pose_hrnet:w32 --epochs 600 \\
        --val-every 50 --out DISCRIM_TORCH_HRNET.json
    python scripts/drive_torch_discrim_ap.py --corpus flipsym --epochs 300 --val-every 50
    python scripts/drive_torch_discrim_ap.py --device cpu --epochs 1 --train-images 8 \\
        --val-images 4 --input 64                         # rehearsal on the CPU

Runs on CUDA unless ``--device cpu`` is given; without a card it exits 2.

* **Corpus** (scripts/torch_discrim_corpus.py, painted into ``--dir``):
  ``color`` (17 hues encode the joints; flip augmentation off, so
  flip-test is the negative control) or ``flipsym`` (left/right pairs share
  a hue, identity from the layout; flip augmentation on, flip-test gated).
  Train seed 100, scale 10-16; val seed 777, ``--val-scale``,
  ``--val-occlude``.
* **Training**, the JAX gate's configuration: batch 32 (``--train-images``
  where that is fewer; the evaluations take the same batch), canvas 224,
  ``--input`` square crops, augmentation scale 0.9-1.1 and +-12 degrees,
  Adam 1e-3 with x0.1 at ``epochs - 100``, bf16 autocast on CUDA,
  validation every ``--val-every`` epochs.  A subprocess runs the
  trainer's module as ``python -m`` does and prints the kernels' launch
  counters at its end.  Where ``<dir>/weights/<type>_last.pth`` exists it
  continues with ``--resume``.
* **Evaluation** of ``_last.pth`` on train and val, then on val: flip-test,
  W8A8 with dynamic and with calibrated static scales, the basic and
  dark_original decoders, the fused layer1 (HRNet, whose layer1 is a
  Bottleneck chain) and, on CUDA, ``eval gt --mesh-devices 2`` with both
  ranks on the one card over gloo (the CLI's canvas, 640).
  Each variant also reports how far it moved the keypoints from float's
  (mean and largest px): an AP step function can hide a small shift.
  Float's val heatmaps, their inverse affines and the APs of float and
  ``decoder_basic`` go to ``<dir>/val_heatmaps.npz``, so the decoders can be
  replayed on those maps elsewhere.
* **Gate**: float AP in (0.2, 0.98) and every variant's |delta| <= 0.015,
  apart from flip-test on the color corpus (reported, not gated).  On
  CUDA also: the whole-crop kernel once per training step, K1 never, K2 in
  ``fused_layer1`` and the int8 route in each W8A8 variant.

Writes one JSON (``--out``; the JAX gate's schema plus the card, torch's
version, the launch counts and the gate) and exits 1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(SCRIPTS)
sys.path[:0] = [REPO, SCRIPTS]

FLOAT_AP_RANGE = (0.2, 0.98)
DELTA_BOUND = 0.015
MODELS = ("pose_resnet_dconv:resnet18", "pose_resnet_duc:resnet18", "pose_hrnet:w32")
_VAL = re.compile(r"eval epoch:\s*(\d+)\|.*\|val_ap:\s*([0-9.]+)")
_LAUNCHES = "DISCRIM_LAUNCHES "

# the trainer's module run as `python -m simple_pose_torch.main` runs it,
# then the launch counters of this process
_TRAIN = r"""
import json, runpy, sys
from simple_pose_torch.utils.cuda_build import launch_counts
try:
    runpy.run_module("simple_pose_torch.main", run_name="__main__", alter_sys=True)
finally:
    print("%s" + json.dumps(launch_counts()), flush=True)
""" % _LAUNCHES

# (name, predicts_by_gt keywords) on the val corpus
VARIANTS = (
    ("flip_test", {"flip_test": True}),
    ("w8a8_dynamic", {"quant": "w8a8"}),
    ("w8a8_static", {"quant": "w8a8", "quant_calib": 1}),
    ("decoder_basic", {"decoder": "basic"}),
    ("decoder_dark_original", {"decoder": "dark_original"}),
    ("fused_layer1", {"fused_layer1": True}),
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=MODELS[0], choices=MODELS)
    ap.add_argument("--corpus", default="color", choices=["color", "flipsym"])
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--val-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=11, help="the trainer's seed (init, data order)")
    ap.add_argument("--train-images", type=int, default=256)
    ap.add_argument("--val-images", type=int, default=48)
    ap.add_argument("--val-scale", type=float, nargs=2, default=(8.0, 18.0))
    ap.add_argument("--val-occlude", type=float, default=0.12)
    ap.add_argument("--input", type=int, default=128, help="square crop edge")
    ap.add_argument("--device", default=None, choices=[None, "cuda", "cpu"],
                    help="default: cuda; cpu only to rehearse")
    ap.add_argument("--dir", default=None,
                    help="run directory: corpus, checkpoints, results (default "
                         ".discrim_torch/<type>_<name>_<corpus>_s<seed>)")
    ap.add_argument("--out", default=None,
                    help="result JSON (default DISCRIM_TORCH_AP.json, flipsym "
                         "DISCRIM_TORCH_FLIP.json, at the repo root)")
    args = ap.parse_args(argv)
    args.val_every = min(args.val_every, args.epochs)
    if args.epochs % args.val_every:
        ap.error(f"--epochs {args.epochs} must be a multiple of --val-every "
                 f"{args.val_every}: the trainer saves _last.pth when it validates")
    args.batch_size = min(32, args.train_images)
    args.mtype, args.mname = args.model.split(":")
    args.dir = os.path.abspath(args.dir or os.path.join(
        REPO, ".discrim_torch", f"{args.mtype}_{args.mname}_{args.corpus}_s{args.seed}"))
    default_out = "DISCRIM_TORCH_FLIP.json" if args.corpus == "flipsym" else "DISCRIM_TORCH_AP.json"
    args.out = os.path.abspath(args.out or os.path.join(REPO, default_out))
    return args


def paint_corpora(args):
    """Paint train and val into ``args.dir`` (earlier images are removed
    first; the checkpoints stay).  Returns (tr_root, tr_ann, va_root, va_ann)."""
    from torch_discrim_corpus import paint_discriminative, paint_flipsym

    base = dict(people_per_image=1, blob_sigma=2.5, img_w=160, img_h=128)
    if args.corpus == "flipsym":
        paint = paint_flipsym
    else:
        paint, base = paint_discriminative, {**base, "joint_sep": 7.0}
    for sub in ("train", "val"):
        shutil.rmtree(os.path.join(args.dir, sub), ignore_errors=True)
    tr_root, tr_ann, _ = paint(os.path.join(args.dir, "train"), num_images=args.train_images,
                               seed=100, scale_range=(10.0, 16.0), occlude_frac=0.0, **base)
    va_root, va_ann, _ = paint(os.path.join(args.dir, "val"), num_images=args.val_images,
                               seed=777, scale_range=tuple(args.val_scale),
                               occlude_frac=args.val_occlude, **base)
    return tr_root, tr_ann, va_root, va_ann


def train_config(args, corpus, amp, canvas=224, aug_flip=None):
    """The trainer's configuration; ``aug_flip`` None: on for the flipsym
    corpus only."""
    tr_root, tr_ann, va_root, va_ann = corpus
    if aug_flip is None:
        # color: mirroring swaps the labels of a left/right pair but not its
        # hues, 50% label noise; flipsym: in distribution
        aug_flip = args.corpus == "flipsym"
    return {
        "model_name": "torch_discrim_drive",
        "data": {"train_ann_path": tr_ann, "val_ann_path": va_ann, "train_img_root": tr_root,
                 "val_img_root": va_root, "batch_size": args.batch_size, "num_workers": 2,
                 "canvas": canvas, "input_shape": [args.input, args.input], "augment": True,
                 "aug_scale": [0.9, 1.1], "aug_rot": [-12.0, 12.0], "aug_flip": aug_flip},
        "model": model_cfg(args),
        "optim": {"lr": 1e-3, "milestones": [max(2, args.epochs - 100)],
                  "epochs": args.epochs, "gamma": 0.1, "amp": amp},
        "val": {"interval": args.val_every, "weight_path": os.path.join(args.dir, "weights")},
        "seed": args.seed,
    }


def _ckpt_step(path):
    import torch

    if not os.path.exists(path):
        return 0
    return int(torch.load(path, map_location="cpu", weights_only=True)["step"])


def train(args, cfg, progress):
    """One run of the trainer (resumed where ``_last.pth`` exists); adds a
    segment to ``progress`` and its validations to ``progress["ap_by_epoch"]``
    (written to ``<dir>/progress.json`` as they come)."""
    ckpt = os.path.join(args.dir, "weights", f"{args.mtype}_last.pth")
    resumed = os.path.exists(ckpt)
    step0 = _ckpt_step(ckpt)
    cfg_path = os.path.join(args.dir, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    cmd = [sys.executable, "-c", _TRAIN, "--cfg", cfg_path]
    if resumed:
        cmd.append("--resume")
    if args.device == "cpu":
        cmd += ["--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": REPO, "PYTHONUNBUFFERED": "1"}
    t0 = time.perf_counter()
    launches, tail = None, []
    with subprocess.Popen(cmd, cwd=args.dir, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc:
        for line in proc.stdout:
            tail = (tail + [line.rstrip()])[-40:]
            m = _VAL.search(line)
            if m:
                progress["ap_by_epoch"][m.group(1)] = round(float(m.group(2)), 4)
                _save_progress(args, progress)
                print(json.dumps({"epoch": int(m.group(1)), "val_AP": float(m.group(2)),
                                  "train_s": time.perf_counter() - t0}), flush=True)
            elif line.startswith(_LAUNCHES):
                launches = json.loads(line[len(_LAUNCHES):])
            elif line.startswith("resumed at epoch"):
                print(line.rstrip(), flush=True)
        rc = proc.wait()
    if rc != 0 or launches is None:
        raise RuntimeError(f"training exited {rc}:\n" + "\n".join(tail))
    segment = {"resumed": resumed, "steps": _ckpt_step(ckpt) - step0,
               "seconds": time.perf_counter() - t0, **launches}
    progress["segments"].append(segment)
    _save_progress(args, progress)
    return segment


def _save_progress(args, progress):
    with open(os.path.join(args.dir, "progress.json"), "w") as f:
        json.dump(progress, f)


def _load_progress(args):
    path = os.path.join(args.dir, "progress.json")
    if os.path.exists(path) and os.path.exists(
            os.path.join(args.dir, "weights", f"{args.mtype}_last.pth")):
        with open(path) as f:
            return json.load(f)
    return {"ap_by_epoch": {}, "segments": []}


def model_cfg(args):
    """The model's configuration; ``args.se`` (where set) adds SE blocks."""
    cfg = {"type": args.mtype, "name": args.mname, "num_joints": 17}
    if getattr(args, "se", False):
        cfg["reduction"] = True
    return cfg


def evaluate(args, ckpt, img_root, ann, runs):
    """``predicts_by_gt`` of ``ckpt`` on one corpus at the gate's settings,
    once for each (name, keywords) of ``runs``, its results in
    ``<dir>/res_<name>.json`` and every kernel's counter zeroed just before
    and read just after: {name: {"AP", "launches"}}."""
    from simple_pose_torch.evalkit.workflows import predicts_by_gt
    from simple_pose_torch.utils.cuda_build import launch_counts, zero_launch_counts

    res = {}
    for name, extra in runs:
        zero_launch_counts()
        stats = predicts_by_gt(img_root, ann, model_cfg(args), weights=ckpt,
                               batch_size=args.batch_size, input_shape=(args.input, args.input),
                               canvas=224, out_path=os.path.join(args.dir, f"res_{name}.json"),
                               device=args.device, **extra)
        res[name] = {"AP": float(stats["AP"]), "launches": launch_counts()}
    return res


def eval_gt(args, ckpt, img_root, ann, out, mesh_devices=1):
    """``python -m simple_pose_torch.eval gt`` on cuda:0 (the CPU under
    ``--device cpu``) at the gate's settings, as ``mesh_devices`` ranks
    sharing the device (gloo) where more than one: the AP rank 0 prints;
    its results go to ``out``."""
    cmd = [sys.executable, "-m", "simple_pose_torch.eval", "gt", "--img-root", img_root,
           "--ann", ann, "--model-type", args.mtype, "--model-name", args.mname,
           "--weights", ckpt, "--batch-size", str(args.batch_size), "--input-w",
           str(args.input), "--input-h", str(args.input), "--mesh-devices", str(mesh_devices),
           "--device", args.device or "cuda:0", "--out", out]
    proc = subprocess.run(cmd, cwd=args.dir, env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=900)
    stats = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith('{"AP"')]
    if proc.returncode != 0 or len(stats) != 1:
        raise RuntimeError(f"eval gt --mesh-devices {mesh_devices} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return stats[0]["AP"]


def save_val_heatmaps(args, ckpt, va_root, va_ann, aps):
    """Float's val heatmaps [N, 17, h, w] (f32, as the decoders get them),
    with their inverse affines, image ids and ``aps`` ({name: AP} of this
    run), to ``<dir>/val_heatmaps.npz``."""
    from simple_pose_torch.data.coco import load_coco_keypoints
    from simple_pose_torch.data.pipeline import PosePipeline
    from simple_pose_torch.evalkit.workflows import PoseEvaluator

    shape = (args.input, args.input)
    pipe = PosePipeline(load_coco_keypoints(va_root, va_ann), args.batch_size,
                        input_shape=shape, output_shape=(shape[0] // 4, shape[1] // 4),
                        canvas=224, augment=False, shuffle=False, drop_last=False)
    ev = PoseEvaluator(model_cfg(args), ckpt, shape, device=args.device)
    parts = {"heat": [], "trans_inv": [], "img_id": []}
    for batch in pipe.epoch(0):
        keep = np.asarray(batch["valid"]) > 0.5
        parts["heat"].append(ev.heatmaps(batch).cpu().numpy()[keep])
        parts["trans_inv"].append(np.asarray(batch["trans_inv"])[keep])
        parts["img_id"].append(np.asarray(batch["img_id"])[keep])
    path = os.path.join(args.dir, "val_heatmaps.npz")
    np.savez_compressed(path, **{k: np.concatenate(v) for k, v in parts.items()},
                        **{f"ap_{k}": np.float64(v) for k, v in aps.items()})
    return path


def _keypoints(path):
    """{image_id: [J, 2] keypoints} of a results file (the gate's corpora
    hold one person per image)."""
    with open(path) as f:
        return {r["image_id"]: np.asarray(r["keypoints"]).reshape(-1, 3)[:, :2]
                for r in json.load(f)}


def kp_shift(args, name):
    """How far a variant moved the keypoints: the mean and the largest
    distance, in image px, from float's keypoint to the variant's."""
    want = _keypoints(os.path.join(args.dir, "res_float.json"))
    got = _keypoints(os.path.join(args.dir, f"res_{name}.json"))
    if got.keys() != want.keys():
        raise RuntimeError(f"{name}: predictions for other images than float's")
    d = np.concatenate([np.linalg.norm(got[i] - want[i], axis=-1) for i in want])
    return {"kp_shift_px_mean": float(d.mean()), "kp_shift_px_max": float(d.max())}


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def gate(args, float_ap, variants, launches, on_cuda):
    """The gate block: float AP in range, every gated delta within the bound
    and, on CUDA, each kernel launched where its path runs."""
    not_gated = {"flip_test": "negative control: the color corpus encodes left/right "
                              "in hues, so mirrored predictions swap them"} \
        if args.corpus == "color" else {}
    misses = {name: v["delta_vs_float"] for name, v in variants.items()
              if name not in not_gated and abs(v["delta"]) > DELTA_BOUND}
    checks = {}
    if on_cuda:
        tr = launches["train"]
        checks["crop_kernel_once_per_step"] = tr["rotate_resample_crop"] == tr["steps"] > 0
        checks["k1_never"] = tr["rotate_resample"] == 0
        for name, ev in launches["eval"].items():  # two_ranks counts in its own processes
            if name == "fused_layer1":
                checks["k2_in_fused_layer1"] = ev["bottleneck_chain"] > 0
            if name.startswith("w8a8"):
                checks[f"int8_conv_in_{name}"] = ev["int8_conv"] > 0
    in_range = FLOAT_AP_RANGE[0] < float_ap < FLOAT_AP_RANGE[1]
    return {"float_ap_range": list(FLOAT_AP_RANGE), "float_ap_in_range": in_range,
            "delta_bound": DELTA_BOUND, "gated": [n for n in variants if n not in not_gated],
            "not_gated": not_gated, "misses": misses, "launch_checks": checks,
            "passed": in_range and not misses and all(checks.values())}


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    on_cuda = args.device != "cpu"
    if on_cuda and not torch.cuda.is_available():
        print("drive_torch_discrim_ap: no CUDA device (pass --device cpu to rehearse)",
              file=sys.stderr)
        return 2
    card = card_line() if on_cuda else None
    if card:
        print(card, flush=True)
    t_start = time.perf_counter()
    os.makedirs(args.dir, exist_ok=True)
    corpus = paint_corpora(args)
    tr_root, tr_ann, va_root, va_ann = corpus
    progress = _load_progress(args)
    t0 = time.perf_counter()
    train(args, train_config(args, corpus, amp=on_cuda), progress)
    train_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    ckpt = os.path.join(args.dir, "weights", f"{args.mtype}_last.pth")
    train_ap = evaluate(args, ckpt, tr_root, tr_ann, [("train", {})])["train"]["AP"]
    runs = [("float", {})] + [(n, x) for n, x in VARIANTS
                              if n != "fused_layer1" or args.mtype == "pose_hrnet"]
    evals = evaluate(args, ckpt, va_root, va_ann, runs)
    float_ap = evals["float"]["AP"]
    print(json.dumps({"train_ap": train_ap, "float_ap": float_ap}), flush=True)
    variants = {name: {"ap": round(r["AP"], 4), "delta_vs_float": round(r["AP"] - float_ap, 4),
                       "delta": r["AP"] - float_ap, **kp_shift(args, name)}
                for name, r in evals.items() if name != "float"}
    if on_cuda:
        got = eval_gt(args, ckpt, va_root, va_ann, os.path.join(args.dir, "res_two_ranks.json"),
                      mesh_devices=2)
        variants["two_ranks"] = {"ap": round(got, 4), "delta_vs_float": round(got - float_ap, 4),
                                 "delta": got - float_ap, "canvas": 640,
                                 **kp_shift(args, "two_ranks")}
    for name, v in variants.items():
        print(json.dumps({name: v}), flush=True)
    save_val_heatmaps(args, ckpt, va_root, va_ann,
                      {"float": float_ap, "decoder_basic": evals["decoder_basic"]["AP"]})
    eval_s = time.perf_counter() - t0

    segs = progress["segments"]
    launches = {"train": {"steps": sum(s["steps"] for s in segs),
                          "rotate_resample_crop": sum(s["rotate_resample_crop"] for s in segs),
                          "rotate_resample": sum(s["rotate_resample"] for s in segs),
                          "segments": segs},
                "eval": {name: r["launches"] for name, r in evals.items()}}
    verdict = gate(args, float_ap, variants, launches, on_cuda)
    for v in variants.values():
        del v["delta"]
    out = {
        "backend": "cuda" if on_cuda else "cpu",
        "model": args.model,
        "corpus": args.corpus,
        "seed": args.seed,
        "epochs_run": args.epochs,
        "ap_by_epoch": progress["ap_by_epoch"],
        "train_ap": round(train_ap, 4),
        "float_ap": round(float_ap, 4),
        "discriminative": verdict["float_ap_in_range"],
        "variants": variants,
        "wall_s": round(time.perf_counter() - t_start, 1),
        "train_s": round(train_s, 1),
        "eval_s": round(eval_s, 1),
        "card": card,
        "device": torch.cuda.get_device_name(0) if on_cuda else "cpu",
        "torch": f"{torch.__version__} (CUDA {torch.version.cuda})",
        "config": {"batch_size": args.batch_size, "input": args.input, "canvas": 224,
                   "train_images": args.train_images, "val_images": args.val_images,
                   "val_scale": list(args.val_scale), "val_occlude": args.val_occlude,
                   "val_every": args.val_every},
        "launches": launches,
        "gate": verdict,
    }
    if args.corpus == "flipsym":
        try:  # the color corpus's flip-test row beside, as the JAX gate keeps it
            with open(os.path.join(REPO, "DISCRIM_TORCH_AP.json")) as f:
                neg = json.load(f)
            out["negative_control"] = {
                "corpus": "color (joint identity encoded in colors; flip = label noise)",
                "flip_test_delta": neg["variants"]["flip_test"]["delta_vs_float"],
                "source": "DISCRIM_TORCH_AP.json"}
        except (OSError, KeyError):
            pass
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0 if verdict["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
