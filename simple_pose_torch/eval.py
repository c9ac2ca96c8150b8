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


def _model_cfg(args):
    return {"type": args.model_type, "name": args.model_name,
            "num_joints": args.num_joints, "reduction": args.reduction}


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
        if not model:
            return
        p.add_argument("--model-type", default="pose_resnet_dconv")
        p.add_argument("--model-name", default="resnet50")
        p.add_argument("--num-joints", type=int, default=17)
        p.add_argument("--reduction", action="store_true")
        p.add_argument("--weights", default=None, help="reference .pth checkpoint")
        p.add_argument("--input-w", type=int, default=192)
        p.add_argument("--input-h", type=int, default=256)
        p.add_argument("--decoder", default="gauss_taylor",
                       choices=["basic", "gauss_taylor", "dark_original"])
        p.add_argument("--flip-test", action="store_true")
        p.add_argument("--fused-layer1", action="store_true",
                       help="run layer1 as the folded Bottleneck-chain kernel")

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

    p = sub.add_parser("rescore", help="OKS-NMS rescoring of raw predictions")
    p.add_argument("--preds", required=True)
    p.add_argument("--ann", required=True)
    p.add_argument("--in-vis-thre", type=float, default=0.2)
    p.add_argument("--oks-thre", type=float, default=0.9)
    args = ap.parse_args(argv)

    from simple_pose_torch.evalkit import workflows

    amp = False if getattr(args, "no_amp", False) else "auto"
    if args.cmd == "rescore":
        stats = workflows.rescore_and_filter(args.preds, args.ann, args.in_vis_thre,
                                             args.oks_thre)
    elif args.cmd == "gen-dets":
        from simple_pose_torch.detector.wrapper import YOLOv5Detector

        det = YOLOv5Detector(weights_path=args.det_weights, scale_name=args.scale_name,
                             conf_thresh=args.conf, iou_thresh=args.iou, canvas=args.canvas,
                             model_family=args.detector_family, amp=amp, rect=args.rect,
                             device=args.device)
        results = workflows.gen_detections(args.img_root, args.ann, detector=det,
                                           out_path=args.out, batch_size=args.batch_size,
                                           debug=args.debug, canvas=args.canvas)
        print(f"wrote {args.out}")
        print(json.dumps({"detections": len(results)}))
        return
    elif args.cmd == "fused":
        from simple_pose_torch.evalkit.fused import fused_eval

        if args.flip_test:
            ap.error("fused runs one forward per crop; flip-test needs the "
                     "two-stage path (eval e2e --flip-test)")
        if args.decoder == "dark_original":
            ap.error("fused decodes on the device (basic/gauss_taylor); "
                     "dark_original's host decode needs the two-stage path")
        if args.fused_layer1:
            ap.error("fused has no fused_layer1; it needs the two-stage path (eval e2e)")
        stats = fused_eval(
            args.img_root, args.ann, _model_cfg(args), pose_weights=args.weights,
            detector_weights=args.det_weights, scale_name=args.scale_name,
            det_conf=args.conf, det_iou=args.iou, batch_size=args.batch_size,
            input_shape=(args.input_w, args.input_h), det_size=(args.det_size, args.det_size),
            max_people=args.max_people, canvas=args.canvas, decoder=args.decoder,
            detector_family=args.detector_family, amp=amp, rect=args.rect, debug=args.debug,
            out_path=args.out, device=args.device)
    elif args.cmd == "e2e":
        stats = workflows.detect_then_pose(
            args.img_root, args.ann, _model_cfg(args), pose_weights=args.weights,
            detector_weights=args.det_weights, scale_name=args.scale_name,
            batch_size=args.batch_size, input_shape=(args.input_w, args.input_h),
            flip_test=args.flip_test,
            debug=args.debug, detector_family=args.detector_family, amp=amp,
            fused_layer1=args.fused_layer1, decoder=args.decoder, device=args.device)
    else:
        kw = dict(weights=args.weights, batch_size=args.batch_size,
                  input_shape=(args.input_w, args.input_h), decoder=args.decoder,
                  flip_test=args.flip_test, out_path=args.out, debug=args.debug,
                  amp=amp, fused_layer1=args.fused_layer1,
                  device=args.device)
        if args.cmd == "gt":
            stats = workflows.predicts_by_gt(args.img_root, args.ann, _model_cfg(args), **kw)
        else:
            stats = workflows.predicts_by_detections(args.img_root, args.dets, args.ann,
                                                     _model_cfg(args), **kw)
    print(json.dumps({k: float(v) for k, v in stats.items()}))


if __name__ == "__main__":
    main()
