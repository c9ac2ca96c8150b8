"""Evaluation CLI of the port (the ``gt``, ``detections``, ``rescore``,
``gen-dets``, ``e2e`` and ``fused`` workflows of the repo's eval.py).

    python -m simple_pose_torch.eval gt --img-root data/val2017 \
        --ann data/annotations/person_keypoints_val2017.json \
        --model-name resnet50 --reduction --weights fast_pose.pth \
        [--fused-layer1] [--flip-test] [--no-amp] [--device cpu]
    python -m simple_pose_torch.eval gt ... --model-type pose_hrnet --model-name w32
    python -m simple_pose_torch.eval gt ... --model-type pose_resnet_duc --model-name resnet50
    python -m simple_pose_torch.eval detections --img-root data/val2017 \
        --ann data/annotations/person_keypoints_val2017.json \
        --dets COCO_val2017_detections_AP_H_56_person.json --weights fast_pose.pth \
        [--decoder dark_original] [--out predicts_kps_temp.json]
    python -m simple_pose_torch.eval rescore --preds predicts_kps_temp.json \
        --ann data/annotations/person_keypoints_val2017.json

The person detector and the detect -> pose programs (YOLOv5 or YOLOv4;
``--det-weights`` is a reference checkpoint, none means the seeded init):

    python -m simple_pose_torch.eval gen-dets --img-root data/val2017 \
        --ann data/annotations/person_keypoints_val2017.json \
        --det-weights coco_yolov5l_best_map.pth [--rect] [--conf 0.25] \
        [--out person_detections.json]
    python -m simple_pose_torch.eval e2e --img-root ... --ann ... \
        --det-weights coco_yolov5l_best_map.pth --weights fast_pose.pth \
        --reduction [--fused-layer1] [--flip-test]
    python -m simple_pose_torch.eval fused --img-root ... --ann ... \
        --det-weights coco_yolov5l_best_map.pth --weights fast_pose.pth \
        --reduction --batch-size 8 [--max-people 16] [--rect] \
        [--out fused_kps_temp.json]

W8A8 (models/quant.py) on every eval subcommand: ``--quant w8a8`` runs
the convs in int8 with dynamic activation scales; ``--quant-calib N``
calibrates static ones on the first N batches (``--save-scales`` writes
them); ``--scales`` loads a scales file, either package's (``fused`` takes
the per-net ``{"detector": ..., "pose": ...}`` file it writes):

    python -m simple_pose_torch.eval gt ... --quant w8a8 --quant-calib 4 \
        --save-scales pose_scales.json [--fused-layer1]
    python -m simple_pose_torch.eval fused ... --quant w8a8 --quant-calib 2

``export`` writes the evaluator's device program as a ``torch.export``
artifact (evalkit/export.py) and its input contract beside it as
``<out>.json``; simple_pose_torch/serve_artifact.py serves it:

    python -m simple_pose_torch.eval export --weights fast_pose.pth --reduction \
        [--quant w8a8 --scales pose_scales.json] [--fused-layer1] \
        [--batch-size 64 | --batch-size b] [--canvas 640] --out pose_eval.pt2

Several ranks (the JAX CLI's ``--multihost`` and ``--mesh-devices``) on
``gt``, ``detections`` and ``fused``: each rank takes its stride of the
images and every rank gathers the full prediction list; rank 0 writes the
output files and prints the stats, which equal one process's.  ``gen-dets``
and ``e2e`` run on one rank, and ``--fused-layer1`` too, as in JAX:

    torchrun --standalone --nproc_per_node=N -m simple_pose_torch.eval gt ... --multihost
    python -m simple_pose_torch.eval gt ... --mesh-devices N
    python -m simple_pose_torch.eval gt ... --mesh-devices 2 --device cpu

``e2e`` runs gen-dets into ./person_detections.json, then the
``detections`` workflow on it; ``fused`` runs evalkit/fused.py's
FusedDetectPose per image batch (no flip-test, no dark_original).

JPEGs decode through the native loader (data/native.py, built with g++ at
first use: libjpeg's, or the port's own decoder where libjpeg is absent);
other image files need cv2.  ``detections``, ``e2e`` and
``rescore`` write the rescored predictions to ./filter_kps_predicts.json,
``fused`` to ./fused_filter_kps_predicts.json.
"""

from __future__ import annotations

import argparse
import json

from simple_pose_torch.models.quant import load_scales
from simple_pose_torch.parallel import distributed as D


def _model_cfg(args):
    return {"type": args.model_type, "name": args.model_name,
            "num_joints": args.num_joints, "reduction": args.reduction}


def _scales(args):
    """--scales: one net's scales file, or fused's per-net file."""
    return load_scales(args.scales) if getattr(args, "scales", None) else None


def _quant_kwargs(args) -> dict:
    if not args.quant:
        return {"quant": None}
    return {"quant": args.quant, "quant_calib": args.quant_calib,
            "quant_scales": _scales(args), "quant_scales_out": args.save_scales}


def _export(args, ap):
    from simple_pose_torch.evalkit.export import export_evaluator, save_exported
    from simple_pose_torch.evalkit.workflows import PoseEvaluator

    try:
        batch = int(args.batch_size)
        if batch <= 0:
            ap.error(f"--batch-size must be > 0, got {batch}")
    except ValueError:  # a name: a torch.export.Dim batch
        batch = args.batch_size
    evaluator = PoseEvaluator(
        _model_cfg(args), args.weights, input_shape=(args.input_w, args.input_h),
        decoder=args.decoder, flip_test=args.flip_test, amp=False if args.no_amp else "auto",
        fused_layer1=args.fused_layer1, device=args.device, quant=args.quant,
        quant_scales=_scales(args))
    exported = export_evaluator(evaluator, batch, (args.canvas, args.canvas),
                                bake_weights=not args.external_weights)
    n = save_exported(exported, args.out)
    info = {
        "out": args.out, "bytes": n, "platforms": [evaluator.device.type],
        "batch": batch, "canvas": args.canvas, "input_shape": [args.input_w, args.input_h],
        "model": _model_cfg(args), "decoder": args.decoder, "flip_test": args.flip_test,
        "quant": args.quant, "static_scales": bool(args.scales), "amp": not args.no_amp,
        "weights": args.weights, "external_weights": args.external_weights,
    }
    # the registered ops the graph holds: K2 and the int8 product
    custom_ops = ((["simple_pose_torch.ops.bottleneck_chain"] if args.fused_layer1 else [])
                  + (["simple_pose_torch.ops.int8_conv"] if args.quant else []))
    if custom_ops:
        info["custom_ops"] = custom_ops
    # sidecar: the artifact's input contract for serving consumers
    with open(args.out + ".json", "w") as wf:
        json.dump(info, wf, indent=1)
    print(json.dumps(info))


def main(argv=None):
    ap = argparse.ArgumentParser(description="simple_pose_torch evaluation")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, model=True):
        p.add_argument("--img-root", required=True)
        p.add_argument("--ann", required=True, help="person_keypoints_val2017.json")
        p.add_argument("--batch-size", type=int, default=32)
        p.add_argument("--debug", type=int, default=0)
        p.add_argument("--no-amp", action="store_true",
                       help="force float32 compute (default: bf16 on CUDA)")
        p.add_argument("--device", default=None, help="default: cuda")
        D.add_launch_args(p)
        quant(p)
        if model:
            model_args(p)
            p.add_argument("--decoder", default="gauss_taylor",
                           choices=["basic", "gauss_taylor", "dark_original"])
            p.add_argument("--flip-test", action="store_true")
            p.add_argument("--fused-layer1", action="store_true",
                           help="run layer1 as the folded Bottleneck-chain kernel")

    def quant(p, calib=True):
        p.add_argument("--quant", default=None, choices=["w8a8"],
                       help="int8 quantized conv forward (models/quant.py)")
        p.add_argument("--scales", default=None, help="load calibrated w8a8 scales json")
        if calib:
            p.add_argument("--quant-calib", type=int, default=0, metavar="N",
                           help="calibrate static w8a8 activation scales on the first N "
                                "batches")
            p.add_argument("--save-scales", default=None,
                           help="write calibrated w8a8 scales json (with --quant-calib)")

    def model_args(p):
        p.add_argument("--model-type", default="pose_resnet_dconv")
        p.add_argument("--model-name", default="resnet50")
        p.add_argument("--num-joints", type=int, default=17)
        p.add_argument("--reduction", action="store_true")
        p.add_argument("--weights", default=None, help="reference .pth checkpoint")
        p.add_argument("--input-w", type=int, default=192)
        p.add_argument("--input-h", type=int, default=256)

    def detector(p, thresholds=True):
        p.add_argument("--det-weights", default=None, help="reference detector checkpoint")
        p.add_argument("--scale-name", default="l")
        p.add_argument("--detector-family", default="yolov5", choices=["yolov5", "yolov4"])
        if thresholds:
            p.add_argument("--conf", type=float, default=0.25)
            p.add_argument("--iou", type=float, default=0.5)

    p = sub.add_parser("gt", help="GT-box eval")
    common(p)
    p.add_argument("--out", default="test_gt_kpt.json")

    p = sub.add_parser("detections", help="eval on a detection json + OKS-NMS rescoring")
    common(p)
    p.add_argument("--dets", required=True)
    p.add_argument("--out", default="predicts_kps_temp.json")

    p = sub.add_parser("gen-dets", help="run the person detector over the val set")
    common(p, model=False)
    detector(p)
    p.add_argument("--rect", action="store_true",
                   help="minimum-rectangle letterbox in mod-64 buckets")
    p.add_argument("--canvas", type=int, default=1280)
    p.add_argument("--out", default="person_detections.json")

    p = sub.add_parser("fused", help="detect -> pose per image batch on one device "
                       "(evalkit/fused.py)")
    common(p)
    detector(p)
    p.add_argument("--max-people", type=int, default=16)
    p.add_argument("--canvas", type=int, default=1280)
    p.add_argument("--det-size", type=int, default=640, help="square detector letterbox size")
    p.add_argument("--rect", action="store_true",
                   help="minimum-rectangle letterbox in mod-64 buckets")
    p.add_argument("--out", default="fused_kps_temp.json")

    p = sub.add_parser("e2e", help="detect -> crop -> pose end to end")
    common(p)
    detector(p, thresholds=False)

    p = sub.add_parser("export", help="the eval program as a torch.export artifact "
                       "(evalkit/export.py; no model code needed to load)")
    model_args(p)
    quant(p, calib=False)
    p.add_argument("--decoder", default="gauss_taylor",
                   choices=["basic", "gauss_taylor", "dark_original"])
    p.add_argument("--flip-test", action="store_true")
    p.add_argument("--fused-layer1", action="store_true",
                   help="layer1 as K2 (the artifact then needs its op registered)")
    p.add_argument("--no-amp", action="store_true")
    p.add_argument("--device", default=None, help="device to trace on (default: cuda)")
    p.add_argument("--batch-size", default="64",
                   help="static crop batch, or a name (e.g. 'b') for a batch of any size")
    p.add_argument("--canvas", type=int, default=640)
    p.add_argument("--external-weights", action="store_true",
                   help="take the state dict as the leading input instead of baking it")
    p.add_argument("--out", default="pose_eval.pt2")

    p = sub.add_parser("rescore", help="OKS-NMS rescoring of raw predictions")
    p.add_argument("--preds", required=True)
    p.add_argument("--ann", required=True)
    p.add_argument("--in-vis-thre", type=float, default=0.2)
    p.add_argument("--oks-thre", type=float, default=0.9)
    args = ap.parse_args(argv)

    if args.cmd == "export":
        _export(args, ap)
        return
    if args.cmd == "rescore":
        from simple_pose_torch.evalkit import workflows

        stats = workflows.rescore_and_filter(args.preds, args.ann, args.in_vis_thre,
                                             args.oks_thre)
        print(json.dumps({k: float(v) for k, v in stats.items()}))
        return
    if args.cmd == "fused":
        if args.flip_test:
            ap.error("fused runs one forward per crop; flip-test needs the "
                     "two-stage path (eval e2e --flip-test)")
        if args.decoder == "dark_original":
            ap.error("fused decodes on the device (basic/gauss_taylor); "
                     "dark_original's host decode needs the two-stage path")
        if args.fused_layer1:
            ap.error("fused has no fused_layer1; it needs the two-stage path (eval e2e)")
    D.launch(_run, args)


def _run(args):
    """One rank's (or the one process's) run of an eval subcommand."""
    from simple_pose_torch.evalkit import workflows

    amp = False if getattr(args, "no_amp", False) else "auto"
    if args.cmd == "gen-dets":
        from simple_pose_torch.detector.wrapper import YOLOv5Detector

        det = YOLOv5Detector(weights_path=args.det_weights, scale_name=args.scale_name,
                             conf_thresh=args.conf, iou_thresh=args.iou, canvas=args.canvas,
                             model_family=args.detector_family, amp=amp, rect=args.rect,
                             device=args.device, quant=args.quant, quant_scales=_scales(args))
        results = workflows.gen_detections(args.img_root, args.ann, detector=det,
                                           out_path=args.out, batch_size=args.batch_size,
                                           debug=args.debug, canvas=args.canvas,
                                           quant_calib=args.quant_calib,
                                           quant_scales_out=args.save_scales)
        print(f"wrote {args.out}")
        print(json.dumps({"detections": len(results)}))
        return
    elif args.cmd == "fused":
        from simple_pose_torch.evalkit.fused import fused_eval

        stats = fused_eval(
            args.img_root, args.ann, _model_cfg(args), pose_weights=args.weights,
            detector_weights=args.det_weights, scale_name=args.scale_name,
            det_conf=args.conf, det_iou=args.iou, batch_size=args.batch_size,
            input_shape=(args.input_w, args.input_h), det_size=(args.det_size, args.det_size),
            max_people=args.max_people, canvas=args.canvas, decoder=args.decoder,
            detector_family=args.detector_family, amp=amp, rect=args.rect, debug=args.debug,
            out_path=args.out, device=args.device, **_quant_kwargs(args))
    elif args.cmd == "e2e":
        stats = workflows.detect_then_pose(
            args.img_root, args.ann, _model_cfg(args), pose_weights=args.weights,
            detector_weights=args.det_weights, scale_name=args.scale_name,
            batch_size=args.batch_size, input_shape=(args.input_w, args.input_h),
            flip_test=args.flip_test,
            debug=args.debug, detector_family=args.detector_family, amp=amp,
            fused_layer1=args.fused_layer1, decoder=args.decoder, device=args.device,
            **_quant_kwargs(args))
    else:
        kw = dict(weights=args.weights, batch_size=args.batch_size,
                  input_shape=(args.input_w, args.input_h), decoder=args.decoder,
                  flip_test=args.flip_test, out_path=args.out, debug=args.debug,
                  amp=amp, fused_layer1=args.fused_layer1,
                  device=args.device, **_quant_kwargs(args))
        if args.cmd == "gt":
            stats = workflows.predicts_by_gt(args.img_root, args.ann, _model_cfg(args), **kw)
        else:
            stats = workflows.predicts_by_detections(args.img_root, args.dets, args.ann,
                                                     _model_cfg(args), **kw)
    if D.is_main():
        print(json.dumps({k: float(v) for k, v in stats.items()}))


if __name__ == "__main__":
    main()
