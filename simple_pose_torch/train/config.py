"""Typed training configuration + YAML loader.

Port of simple_pose_tpu/train/config.py, field for field, so one YAML file
configures both packages.  Schema mirrors the reference configs
(configs/dp_fast_pose.yaml:1-30): data / model / optim / val sections plus
model_name.  ``mesh`` (the JAX package's device mesh) is carried for schema
parity; the port trains on one device until DDP is ported (ROADMAP.md).
``yaml`` is imported only for a path that does not end in ``.json``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Tuple

__all__ = ["DataConfig", "ModelConfig", "OptimConfig", "ValConfig", "TrainConfig", "load_config"]


@dataclass
class DataConfig:
    train_ann_path: str = ""
    val_ann_path: str = ""
    train_img_root: str = ""
    val_img_root: str = ""
    batch_size: int = 128
    num_workers: int = 8
    debug: int = 0
    canvas: int = 640
    input_shape: Tuple[int, int] = (192, 256)  # (w, h) like the reference
    # drop records whose keypoint centroid is inconsistent with the box
    # center (datasets/coco.py:96-122; the reference also defaults this off)
    check_center: bool = False
    # heatmap target encoding: 'unbiased' (RefineSimpleTransform,
    # commons/transforms.py:167-191) or 'biased' (BasicSimpleTransform,
    # commons/transforms.py:80-116)
    encoding: str = "unbiased"
    # training-time augmentation (flip/rotation/scale jitter/DPG); the
    # reference always augments -- False is for overfit drives / fine-tunes
    augment: bool = True
    # aug ranges: ctor params of the reference transforms
    # (BasicSimpleTransform(scale=, ratio=), commons/transforms.py:64-78);
    # the reference solvers use the defaults, but the knobs are part of the
    # transform API surface
    aug_scale: Tuple[float, float] = (0.7, 1.3)
    aug_rot: Tuple[float, float] = (-40.0, 40.0)
    # horizontal flip (transforms.py:206-210; joint_pairs=None disables in
    # the reference).  Off is also the right setting for corpora whose
    # keypoint identity is appearance-coded asymmetrically (synthetic
    # color markers: flip swaps the left/right LABELS but not the colors,
    # which is 50% label noise on every paired joint)
    aug_flip: bool = True
    # canvas dedup: ship one canvas per source IMAGE instead of per crop
    # (COCO averages ~2.3 instances/image -> ~2x less host decode + H2D).
    # dedup_ratio = canvas slots / crops per batch; 0 disables.
    dedup: bool = True
    dedup_ratio: float = 0.5


@dataclass
class ModelConfig:
    type: str = "pose_resnet_dconv"
    name: str = "resnet50"
    num_joints: int = 17
    pretrained: str = ""  # path to a converted/torch checkpoint, or empty
    reduction: bool = False
    # rematerialize each residual block in training (the JAX package's
    # nn.remat; torch.utils.checkpoint here, models/resnet.py)
    remat: bool = False


@dataclass
class OptimConfig:
    optimizer: str = "adam"
    lr: float = 1e-3
    milestones: List[int] = field(default_factory=lambda: [120, 160])
    epochs: int = 180
    gamma: float = 0.1
    weight_decay: float = 0.0
    momentum: float = 0.9
    schedule: str = "multistep"  # multistep | warmup_cosine_multistep | epoch_warmup_cosine
    warm_up_epoch: int = 1
    ema: bool = True
    amp: bool = True  # bf16 autocast compute, f32 params (no GradScaler needed)
    # 3-group optimizer (decayed kernels / biases / norm scales) with the
    # reference's bias warmup ramp 0.1 -> lr (commons/optims_utils.py:8-32,
    # 68-72); the reference wires this but ships with it commented out
    # (dp_pose_resnet_solver.py:71-77), hence default False
    split_groups: bool = False


@dataclass
class ValConfig:
    interval: int = 1
    weight_path: str = "weights"
    # '' = model-type default (gauss_taylor for pose_hrnet, basic otherwise,
    # matching dp_pose_hrnet_solver.py:91 vs dp_pose_resnet_solver.py:92);
    # explicit: 'basic' | 'gauss_taylor'
    decoder: str = ""


@dataclass
class TrainConfig:
    model_name: str = "fast_pose_tpu"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    val: ValConfig = field(default_factory=ValConfig)
    mesh: dict = field(default_factory=lambda: {"data": -1})  # -1: all devices
    seed: int = 1024


def _merge(dc, d: dict):
    for k, v in (d or {}).items():
        if hasattr(dc, k):
            cur = getattr(dc, k)
            if isinstance(v, list) and isinstance(cur, tuple):
                v = tuple(v)
            setattr(dc, k, v)
    return dc


def load_config(path_or_dict) -> TrainConfig:
    if isinstance(path_or_dict, str):
        with open(path_or_dict) as rf:
            if path_or_dict.endswith(".json"):  # no PyYAML needed
                raw = json.load(rf)
            else:
                import yaml

                raw = yaml.safe_load(rf)
    else:
        raw = dict(path_or_dict)
    cfg = TrainConfig()
    cfg.model_name = raw.get("model_name", cfg.model_name)
    cfg.seed = raw.get("seed", cfg.seed)
    cfg.mesh = raw.get("mesh", cfg.mesh)
    _merge(cfg.data, raw.get("data"))
    _merge(cfg.model, raw.get("model"))
    _merge(cfg.optim, raw.get("optim"))
    _merge(cfg.val, raw.get("val"))
    return cfg
