"""Training and validation steps on one device.

Port of simple_pose_tpu/train/solver.py:51-167 (the steps), 257-301 (schedule
and optimizer) and 533-552 (weight-decay mask and param groups).  The step
runs the whole per-batch pipeline on the device:

  uint8 canvases -> affine crop (ops/rotate_resample.py, the K1 kernel, or
  ops/warp.affine_crop) -> normalize (mean-subtract only,
  datasets/coco.py:134-136) -> model forward with training BatchNorm ->
  heatmap targets (ops/heatmap.py) -> masked MSE 0.5*mean((pred*m - tgt*m)^2)
  (dp_pose_resnet_solver.py:107) -> backward -> Adam/SGD -> EMA.

PyTorch is stateful where JAX is functional: :class:`TrainState` holds the
model (its parameters and BN buffers), the optimizer (its moments) and the
EMA copies, and the step updates them in place and returns the same state.
``PoseSolver`` (data pipelines, the epoch loop, validation, checkpoints) is
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

from simple_pose_torch.data.pipeline import RGB_MEAN
from simple_pose_torch.metrics.acc import heatmap_accuracy
from simple_pose_torch.models.registry import build_from_cfg
from simple_pose_torch.ops.decode import decode_basic, decode_gauss_taylor, instance_scores
from simple_pose_torch.ops.heatmap import encode_biased, encode_unbiased
from simple_pose_torch.ops.rotate_resample import affine_crop_two_stage
from simple_pose_torch.ops.warp import affine_crop, affine_crop_separable
from simple_pose_torch.train import schedules as S
from simple_pose_torch.train.config import OptimConfig, TrainConfig, load_config
from simple_pose_torch.train.ema import ema_update
from simple_pose_torch.utils.device import resolve_device

__all__ = ["TrainState", "init_train_state", "build_schedule", "build_optimizer",
           "make_train_step", "make_val_step"]


@dataclass
class TrainState:
    """:param schedules: one step -> lr function per optimizer param group
    :param ema_params: name -> EMA of the parameter (reference key names)
    :param ema_buffers: name -> EMA of a BN running mean or variance
    :param step: updates taken so far"""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedules: List[Callable[[int], float]]
    ema_params: Dict[str, torch.Tensor]
    ema_buffers: Dict[str, torch.Tensor]
    step: int = 0

    def ema_pairs(self):
        """(EMA tensors, the live tensors they follow), in the same order."""
        params = dict(self.model.named_parameters())
        buffers = dict(self.model.named_buffers())
        ema = list(self.ema_params.values()) + list(self.ema_buffers.values())
        live = ([params[k].detach() for k in self.ema_params]
                + [buffers[k] for k in self.ema_buffers])
        return ema, live


def _ema_buffer_names(model):
    """BN running statistics; ``num_batches_tracked`` has no flax counterpart."""
    return [k for k, _ in model.named_buffers() if not k.endswith("num_batches_tracked")]


def build_schedule(optim_cfg: OptimConfig, steps_per_epoch: int, warmup_start=0.0):
    o = optim_cfg
    if o.schedule == "multistep":
        return S.multistep_schedule(o.lr, o.milestones, o.gamma, steps_per_epoch)
    if o.schedule == "warmup_cosine_multistep":
        return S.warmup_cosine_multistep_schedule(
            o.lr, o.epochs, o.milestones, steps_per_epoch, o.warm_up_epoch, alpha=o.gamma,
            warmup_start=warmup_start)
    if o.schedule == "epoch_warmup_cosine":
        return S.epoch_warmup_cosine_schedule(
            o.lr, o.epochs, steps_per_epoch, o.warm_up_epoch, warmup_start=warmup_start)
    raise KeyError(o.schedule)


def _group_label(name: str, param: torch.Tensor) -> str:
    """split_params grouping (commons/optims_utils.py:8-18): biases (conv and
    BN), weight-decayed kernels (conv and deconv weights, the flax
    ``kernel``s), everything else (BN weights, the flax ``scale``s)."""
    if name.endswith("bias"):
        return "bias"
    return "decay" if param.dim() > 1 else "other"


def build_optimizer(optim_cfg: OptimConfig, named_params, steps_per_epoch: int):
    """The optimizer over up to three param groups, and one lr schedule per
    group.  Weight decay (L2 added to the gradient, optax.add_decayed_weights)
    applies to kernels only.  With ``split_groups`` the bias group warms up
    from an absolute lr of 0.1 (optims_utils.py:68-72).

    :returns: (optimizer, [schedule per param group])"""
    o = optim_cfg
    groups = {"decay": [], "bias": [], "other": []}
    for name, p in named_params:
        groups[_group_label(name, p)].append(p)
    base = build_schedule(o, steps_per_epoch)
    bias = build_schedule(o, steps_per_epoch, warmup_start=0.1) if o.split_groups else base
    specs = [("decay", o.weight_decay, base), ("bias", 0.0, bias), ("other", 0.0, base)]
    param_groups, schedules = [], []
    for key, wd, sched in specs:
        if groups[key]:
            param_groups.append({"params": groups[key], "weight_decay": wd, "lr": sched(0)})
            schedules.append(sched)
    kind = o.optimizer.lower()
    if kind == "adam":  # optax.adam: b1 0.9, b2 0.999, eps 1e-8
        opt = torch.optim.Adam(param_groups, lr=o.lr, betas=(0.9, 0.999), eps=1e-8)
    elif kind == "sgd":  # optax.sgd: trace without dampening or nesterov
        opt = torch.optim.SGD(param_groups, lr=o.lr, momentum=o.momentum)
    else:
        raise KeyError(o.optimizer)
    return opt, schedules


def init_train_state(cfg, device=None, steps_per_epoch: int = 1000) -> TrainState:
    """Model (seeded init, training mode), optimizer and EMA copies.

    :param cfg: a TrainConfig, a dict or a YAML path (train/config.py)
    :param device: None means CUDA (raises where no GPU is present); pass
        "cpu" explicitly to run on the CPU
    :param steps_per_epoch: converts the schedule's epochs to steps (the JAX
        solver's default without a data pipeline is 1000)"""
    cfg = cfg if isinstance(cfg, TrainConfig) else load_config(cfg)
    if cfg.model.pretrained or cfg.model.remat:
        raise NotImplementedError("model.pretrained and model.remat are not ported yet "
                                  "(ROADMAP.md, 'Modules still to port')")
    dev = resolve_device(device)
    amp_dtype = torch.bfloat16 if cfg.optim.amp else None
    model = build_from_cfg(vars(cfg.model), train=True, dtype=amp_dtype, seed=cfg.seed).to(dev)
    opt, schedules = build_optimizer(cfg.optim, model.named_parameters(), steps_per_epoch)
    buffers = dict(model.named_buffers())
    return TrainState(
        model=model, optimizer=opt, schedules=schedules,
        ema_params={k: p.detach().clone() for k, p in model.named_parameters()},
        ema_buffers={k: buffers[k].clone() for k in _ema_buffer_names(model)},
        step=0)


def _normalize(crops):
    """RGB [0,255] -> reference normalization (mean only, no std), in the
    crops' dtype: bf16 crops normalize in bf16."""
    return crops / 255.0 - torch.as_tensor(RGB_MEAN, dtype=crops.dtype, device=crops.device)


def _to(v, device):
    return torch.as_tensor(v).to(device, non_blocking=True)


def _crops(crop_fn, batch, device):
    canvas = _to(batch["canvas"], device)
    if "canvas_idx" in batch:  # dedup'd batch: one canvas per image
        canvas = canvas[_to(batch["canvas_idx"], device).long()]
    return crop_fn(canvas, _to(batch["trans"], device))


def make_train_step(out_shape=(64, 48), crop_shape=(256, 192), amp=False, crop_impl="kernel",
                    ema: bool = True, encoding: str = "unbiased"):
    """The train step: (state, batch) -> (state, metrics), the state updated
    in place.

    batch: {canvas u8 [U,S,S,3], trans f32 [B,2,3], joints f32 [B,K,3] in
    heatmap coordinates, optional canvas_idx [B]} as numpy arrays or tensors.
    metrics: {loss, acc} as 0-d tensors on the device.

    crop_impl: 'kernel' (the two-stage crop with the K1 kernel; under amp it
    writes bf16 crops) or 'gather' (the exact 4-tap crop, f32).
    amp: normalize in bf16; the model's own ``dtype`` sets its autocast.
    ema=False: the EMA slots track the raw weights (solver.py:84-88).
    encoding: 'unbiased' (RefineSimpleTransform) or 'biased'
    (BasicSimpleTransform, with stride 1: joints are in heatmap coordinates).
    """
    inter = int(math.ceil(np.hypot(*crop_shape))) + 8
    if crop_impl == "kernel":
        crop_dtype = torch.bfloat16 if amp else torch.float32
        crop_fn = lambda c, t: affine_crop_two_stage(c, t, crop_shape, inter=inter,
                                                     out_dtype=crop_dtype)
    elif crop_impl == "gather":
        crop_fn = lambda c, t: affine_crop(c, t, crop_shape)
    else:
        raise KeyError(crop_impl)
    if encoding == "unbiased":
        encode_fn = lambda j: encode_unbiased(j, out_shape)
    elif encoding == "biased":
        encode_fn = lambda j: encode_biased(j, out_shape, stride=1)
    else:
        raise KeyError(encoding)

    def train_step(state: TrainState, batch):
        model, opt = state.model, state.optimizer
        device = next(model.parameters()).device
        with torch.no_grad():
            crops = _crops(crop_fn, batch, device)
            x = _normalize(crops.to(torch.bfloat16) if amp else crops)
            x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
            targets, weights = encode_fn(_to(batch["joints"], device))
            mask = weights[..., None, None]
        model.train()
        preds = model(x).float()
        loss = 0.5 * torch.mean((preds * mask - targets * mask) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        # optax evaluates the schedule at the count of previous updates
        for group, schedule in zip(opt.param_groups, state.schedules):
            group["lr"] = schedule(state.step)
        opt.step()
        state.step += 1
        with torch.no_grad():
            ema_tensors, live = state.ema_pairs()
            if ema:
                ema_update(ema_tensors, live, state.step)
            else:
                torch._foreach_copy_(ema_tensors, live)
            acc = heatmap_accuracy(preds.detach() * mask, targets * mask)
        return state, {"loss": loss.detach(), "acc": acc}

    return train_step


def make_val_step(decoder="basic", out_shape=(64, 48), crop_shape=(256, 192), use_ema=False):
    """Validation step: forward in eval mode (the live weights or the EMA
    copies) + decode + loss/acc.  decoder: 'basic' (resnet solvers,
    dp_pose_resnet_solver.py:92) or 'gauss_taylor'."""
    decode = decode_basic if decoder == "basic" else decode_gauss_taylor

    @torch.no_grad()
    def val_step(state: TrainState, batch):
        model = state.model
        device = next(model.parameters()).device
        crops = _crops(lambda c, t: affine_crop_separable(c, t, crop_shape), batch, device)
        x = _normalize(crops).permute(0, 3, 1, 2).contiguous()
        model.eval()
        if use_ema:
            preds = torch.func.functional_call(
                model, {**state.ema_params, **state.ema_buffers}, (x,))
        else:
            preds = model(x)
        preds = preds.float()
        targets, weights = encode_unbiased(_to(batch["joints"], device), out_shape)
        mask = weights[..., None, None]
        loss = 0.5 * torch.mean((preds * mask - targets * mask) ** 2)
        acc = heatmap_accuracy(preds * mask, targets * mask)
        kps, maxvals = decode(preds, _to(batch["trans_inv"], device))
        return {"loss": loss, "acc": acc, "kps": kps, "kp_conf": maxvals,
                "scores": instance_scores(maxvals)}

    return val_step
