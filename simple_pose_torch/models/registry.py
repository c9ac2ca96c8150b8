"""Model registry: config dict -> nn.Module.

Port of simple_pose_tpu/models/registry.py.  Config schema mirrors the
reference YAML ``model`` section:
  type: pose_resnet_dconv | pose_resnet_duc | pose_hrnet
  name: resnet18..resnet152 / resnext / wide_resnet (resnet types)
        w32 | w48 (hrnet)
  num_joints: 17
  reduction: bool (SE attention, resnet types only)
  remat: bool (recompute each residual block in backward)
"""

from __future__ import annotations

import torch

from simple_pose_torch.models.hrnet import build_hrnet
from simple_pose_torch.models.resnet import RESNET_SPECS, build_resnet

__all__ = ["build_model", "build_from_cfg", "MODEL_TYPES", "resolve_amp_dtype"]

MODEL_TYPES = ("pose_resnet_dconv", "pose_resnet_duc", "pose_hrnet")
_RESNET_HEADS = {"pose_resnet_dconv": "dconv", "pose_resnet_duc": "duc"}


def resolve_amp_dtype(amp, device) -> "torch.dtype | None":
    """'auto' -> bf16 compute on CUDA, f32 elsewhere; True/False force it.

    Parameters always stay f32; the returned dtype is the model's compute
    dtype (None = f32)."""
    if amp == "auto":
        amp = torch.device(device).type == "cuda"
    return torch.bfloat16 if amp else None


def build_model(model_type: str, name: str = "resnet50", num_joints: int = 17,
                reduction: bool = False, train: bool = False, dtype=None, seed: int = 0,
                remat: bool = False):
    """dtype: compute dtype (torch.bfloat16 or None); weights from
    ``torch.Generator().manual_seed(seed)``, on the CPU, in training mode
    (BatchNorm on batch statistics) when ``train`` and in eval mode
    otherwise.  remat: checkpoint each residual block in training (memory
    for FLOPs)."""
    if model_type in _RESNET_HEADS:
        model = build_resnet(name, num_joints=num_joints, se=reduction, dtype=dtype, seed=seed,
                             remat=remat, head=_RESNET_HEADS[model_type])
        return model.train(train)
    if model_type == "pose_hrnet":
        model = build_hrnet(name, num_joints=num_joints, dtype=dtype, seed=seed, remat=remat)
        return model.train(train)
    raise KeyError(f"unknown model type {model_type!r}; choose from {MODEL_TYPES} "
                   f"(resnet names: {sorted(RESNET_SPECS)})")


def build_from_cfg(model_cfg: dict, train: bool = False, dtype=None, seed: int = 0):
    return build_model(
        model_cfg["type"],
        name=model_cfg.get("name", "resnet50"),
        num_joints=model_cfg.get("num_joints", 17),
        reduction=model_cfg.get("reduction", False),
        train=train,
        dtype=dtype,
        seed=seed,
        remat=model_cfg.get("remat", False),
    )
