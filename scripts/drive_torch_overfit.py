"""Convergence gate of the PyTorch port: train through
``python -m simple_pose_torch.main`` on the committed painted-marker overfit
set (tests/data_torch_jpeg/overfit, 16 JPEGs of 160x128, one person each)
until validation AP reaches the gate.  The counterpart of
scripts/drive_overfit.py.

    python scripts/drive_torch_overfit.py [--epochs 400] [--val-every 100] [--device cpu]
        [--quant w8a8]

Configuration: pose_resnet_dconv resnet18, 64x64 crops, batch 16, canvas
192, no augmentation, Adam lr 1e-3 (x0.1 for the last 100 epochs), seed
11, bf16 autocast on CUDA, validation every ``--val-every`` epochs on the
training set.  The images decode through the native loader (the
pipeline's use_native=None, as the solver builds it) and, on CUDA, every
training step crops with the whole-crop kernel.

With ``--quant w8a8`` the trained ``_best.pth`` is then evaluated through
``predicts_by_gt`` on the same images in float, in w8a8 with dynamic
activation scales and in w8a8 calibrated on the first batch (the deployed
static program): the counterpart of scripts/drive_overfit.py's OVERFIT_QUANT=1, and
the port's accuracy evidence for W8A8 with trained weights.

Prints one JSON line: val AP per validation, steps, wall seconds and
whether AP >= 0.99 was reached (and ``quant_eval``); exits 1 when it was
not.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERFIT = os.path.join(REPO, "tests", "data_torch_jpeg", "overfit")
GATE_AP = 0.99
_VAL = re.compile(r"eval epoch:\s*(\d+)\|.*\|val_ap:\s*([0-9.]+)")


def config(tmp: str, epochs: int, val_every: int, amp: bool) -> dict:
    ann = os.path.join(OVERFIT, "ann.json")
    img_root = os.path.join(OVERFIT, "imgs")
    return {
        "model_name": "torch_overfit_drive",
        "data": {"train_ann_path": ann, "val_ann_path": ann, "train_img_root": img_root,
                 "val_img_root": img_root, "batch_size": 16, "num_workers": 2, "canvas": 192,
                 "input_shape": [64, 64], "augment": False},
        "model": {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17},
        "optim": {"lr": 1e-3, "milestones": [max(2, epochs - 100)], "epochs": epochs,
                  "gamma": 0.1, "amp": amp},
        "val": {"interval": val_every, "weight_path": os.path.join(tmp, "weights")},
        "seed": 11,
    }


def quant_aps(tmp: str, device) -> dict:
    """COCO AP of the trained ``_best.pth`` (``_last.pth`` where no
    validation beat AP 0) through predicts_by_gt: float, w8a8 with dynamic
    scales, w8a8 calibrated on the first batch."""
    sys.path.insert(0, REPO)
    from simple_pose_torch.evalkit.workflows import predicts_by_gt

    ann = os.path.join(OVERFIT, "ann.json")
    ckpt = os.path.join(tmp, "weights", "pose_resnet_dconv_best.pth")
    if not os.path.exists(ckpt):
        ckpt = os.path.join(tmp, "weights", "pose_resnet_dconv_last.pth")
    kw = dict(weights=ckpt,
              batch_size=16, input_shape=(64, 64), canvas=192, device=device,
              out_path=os.path.join(tmp, "quant_eval.json"))
    cfg = {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17}
    img_root = os.path.join(OVERFIT, "imgs")
    aps = {name: predicts_by_gt(img_root, ann, cfg, **kw, **extra)["AP"]
           for name, extra in (("float_ap", {}), ("w8a8_ap", {"quant": "w8a8"}),
                               ("w8a8_static_ap", {"quant": "w8a8", "quant_calib": 1}))}
    return {"checkpoint": os.path.basename(ckpt), **{k: float(v) for k, v in aps.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--val-every", type=int, default=100)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--quant", default=None, choices=["w8a8"],
                    help="also evaluate the trained checkpoint quantized")
    args = ap.parse_args(argv)

    import torch

    on_cuda = args.device in (None, "cuda")
    card = None
    if on_cuda:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
    with tempfile.TemporaryDirectory(prefix="torch_overfit_") as tmp:
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(config(tmp, args.epochs, args.val_every, amp=on_cuda), f)
        cmd = [sys.executable, "-m", "simple_pose_torch.main", "--cfg", cfg_path]
        if args.device:
            cmd += ["--device", args.device]
        t0 = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": REPO, "PYTHONUNBUFFERED": "1"}
        proc = subprocess.Popen(cmd, cwd=tmp, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        ap_by_epoch, log = {}, []
        for line in proc.stdout:
            log.append(line.rstrip())
            m = _VAL.search(line)
            if m:
                ap_by_epoch[int(m.group(1))] = float(m.group(2))
                print(json.dumps({"epoch": int(m.group(1)), "AP": float(m.group(2)),
                                  "wall_s": time.perf_counter() - t0}), flush=True)
        rc = proc.wait()
        wall = time.perf_counter() - t0
        if rc != 0:
            print("\n".join(log[-40:]), file=sys.stderr)
            return rc
        ckpt = torch.load(os.path.join(tmp, "weights", "pose_resnet_dconv_last.pth"),
                          map_location="cpu", weights_only=True)
        quant_eval = quant_aps(tmp, args.device) if args.quant else None
    first = min((e for e, a in ap_by_epoch.items() if a >= GATE_AP), default=None)
    out = {
        "device": torch.cuda.get_device_name(0) if on_cuda else "cpu", "card": card,
        "model": "pose_resnet_dconv:resnet18", "epochs": args.epochs,
        "steps": int(ckpt["step"]), "steps_per_epoch": int(ckpt["step"]) // args.epochs,
        "ap_by_epoch": ap_by_epoch, "first_epoch_at_gate": first,
        "wall_s": wall, "decoder": [ln for ln in log if "PosePipeline:" in ln],
        "gate": {"ap": GATE_AP, "within_epochs": args.epochs, "passed": first is not None},
    }
    if quant_eval is not None:
        out["quant_eval"] = quant_eval
    print(json.dumps(out), flush=True)
    return 0 if first is not None else 1


if __name__ == "__main__":
    sys.exit(main())
