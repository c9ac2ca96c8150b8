"""Evaluation CLI of the port (the ``gt``, ``detections`` and ``rescore``
workflows of the repo's eval.py).

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

JPEGs decode through the native loader (data/native.py, built with g++ at
first use: libjpeg's, or the port's own decoder where libjpeg is absent);
other image files need cv2.  ``detections`` and
``rescore`` write the rescored predictions to ./filter_kps_predicts.json.
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

    def common(p):
        p.add_argument("--img-root", required=True)
        p.add_argument("--ann", required=True, help="person_keypoints_val2017.json")
        p.add_argument("--batch-size", type=int, default=32)
        p.add_argument("--debug", type=int, default=0)
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
        p.add_argument("--no-amp", action="store_true",
                       help="force float32 compute (default: bf16 on CUDA)")
        p.add_argument("--fused-layer1", action="store_true",
                       help="run layer1 as the folded Bottleneck-chain kernel")
        p.add_argument("--device", default=None, help="default: cuda")

    p = sub.add_parser("gt", help="GT-box eval")
    common(p)
    p.add_argument("--out", default="test_gt_kpt.json")

    p = sub.add_parser("detections", help="eval on a detection json + OKS-NMS rescoring")
    common(p)
    p.add_argument("--dets", required=True)
    p.add_argument("--out", default="predicts_kps_temp.json")

    p = sub.add_parser("rescore", help="OKS-NMS rescoring of raw predictions")
    p.add_argument("--preds", required=True)
    p.add_argument("--ann", required=True)
    p.add_argument("--in-vis-thre", type=float, default=0.2)
    p.add_argument("--oks-thre", type=float, default=0.9)
    args = ap.parse_args(argv)

    from simple_pose_torch.evalkit import workflows

    if args.cmd == "rescore":
        stats = workflows.rescore_and_filter(args.preds, args.ann, args.in_vis_thre,
                                             args.oks_thre)
    else:
        kw = dict(weights=args.weights, batch_size=args.batch_size,
                  input_shape=(args.input_w, args.input_h), decoder=args.decoder,
                  flip_test=args.flip_test, out_path=args.out, debug=args.debug,
                  amp=False if args.no_amp else "auto", fused_layer1=args.fused_layer1,
                  device=args.device)
        if args.cmd == "gt":
            stats = workflows.predicts_by_gt(args.img_root, args.ann, _model_cfg(args), **kw)
        else:
            stats = workflows.predicts_by_detections(args.img_root, args.dets, args.ann,
                                                     _model_cfg(args), **kw)
    print(json.dumps({k: float(v) for k, v in stats.items()}))


if __name__ == "__main__":
    main()
