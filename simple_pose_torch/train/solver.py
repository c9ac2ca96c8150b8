"""Training and validation: the steps and the solver, on one device or
one rank per device under DistributedDataParallel.

Port of simple_pose_tpu/train/solver.py: 51-192 (the steps), 195-531
(``PoseSolver``, with its ``mesh=``: 198-246 and the multihost validate
397-431), 257-301 (schedule and optimizer) and 533-552 (weight-decay mask
and param groups).  The step runs the whole per-batch pipeline on the
device:

  uint8 canvases -> affine crop (ops/rotate_resample.py, the K1 kernel, or
  ops/warp.affine_crop) -> normalize (mean-subtract only,
  datasets/coco.py:134-136) -> model forward with training BatchNorm ->
  heatmap targets (ops/heatmap.py) -> masked MSE 0.5*mean((pred*m - tgt*m)^2)
  (dp_pose_resnet_solver.py:107) -> backward -> Adam/SGD -> EMA.

PyTorch is stateful where JAX is functional: :class:`TrainState` holds the
model (its parameters and BN buffers), the optimizer (its moments) and the
EMA copies, and the step updates them in place and returns the same state.

``PoseSolver`` builds the training and val pipelines (data/pipeline.py) from
the config, runs epochs of train steps with the batches staged by
parallel/prefetch.device_prefetch, validates to COCO AP and keeps torch
checkpoints (``<type>_last.pth`` and ``<type>_best.pth``, with the optimizer
state and step, in place of the JAX package's Orbax directories) for
``run(resume=True)``.

Under an initialised torch.distributed group of more than one rank
(parallel/distributed.py) the JAX SPMD program's semantics hold: the model
runs inside ``DistributedDataParallel`` (its initial state broadcast from
rank 0), so gradients are means over the global batch; BatchNorm's batch
statistics are the global batch's (models/layers.BatchNorm2d); the step's
loss and accuracy are the global batch's; each rank feeds its stride of the
records with its own dedup bucket (``data.batch_size`` is per rank);
``validate`` gathers every rank's predictions, so every rank gets the same
AP; checkpoints and the results file are written by rank 0 alone.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from simple_pose_torch.data.coco import load_coco_keypoints
from simple_pose_torch.data.pipeline import RGB_MEAN, PosePipeline
from simple_pose_torch.metrics.acc import (
    accuracy_from_counts,
    heatmap_accuracy,
    heatmap_accuracy_counts,
)
from simple_pose_torch.metrics.cocoeval import evaluate_map
from simple_pose_torch.models.registry import build_from_cfg
from simple_pose_torch.ops.decode import decode_basic, decode_gauss_taylor, instance_scores
from simple_pose_torch.ops.heatmap import encode_biased, encode_unbiased
from simple_pose_torch.ops.rotate_resample import affine_crop_two_stage
from simple_pose_torch.ops.warp import affine_crop, affine_crop_separable
from simple_pose_torch.parallel import distributed as D
from simple_pose_torch.parallel.prefetch import device_prefetch
from simple_pose_torch.train import schedules as S
from simple_pose_torch.train.config import OptimConfig, TrainConfig, load_config
from simple_pose_torch.train.ema import ema_update
from simple_pose_torch.utils import tracing
from simple_pose_torch.utils.device import resolve_device

__all__ = ["TrainState", "PoseSolver", "init_train_state", "load_pretrained",
           "build_schedule", "build_optimizer", "make_train_step", "make_val_step"]


@dataclass
class TrainState:
    """:param schedules: one step -> lr function per optimizer param group
    :param ema_params: name -> EMA of the parameter (reference key names)
    :param ema_buffers: name -> EMA of a BN running mean or variance
    :param step: updates taken so far
    :param ddp: the ``DistributedDataParallel`` wrapper of ``model`` that the
        train step runs under a group of more than one rank; ``model``
        stays the plain module (its key names, its EMA)"""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedules: List[Callable[[int], float]]
    ema_params: Dict[str, torch.Tensor]
    ema_buffers: Dict[str, torch.Tensor]
    step: int = 0
    ddp: Optional[nn.Module] = None

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


def load_pretrained(model: nn.Module, path: str):
    """Partial load of a torch ``.pth`` into ``model`` (JAX solver.py:322-340):
    the ``['ema']`` entry where present (the reference checkpoint layout), a
    ``module.`` prefix stripped, ``num_batches_tracked`` and keys the model
    lacks (an ImageNet ``fc.*``) skipped.

    :returns: (missing keys, unexpected keys)"""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "ema" in raw:
        raw = raw["ema"]
    own = model.state_dict()
    state, unexpected = {}, []
    for k, v in raw.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k.endswith("num_batches_tracked"):
            continue
        if k in own:
            state[k] = v
        else:
            unexpected.append(k)
    missing = [k for k in own if k not in state and not k.endswith("num_batches_tracked")]
    model.load_state_dict(state, strict=False)
    if missing:
        print(f"pretrained: {len(missing)} missing keys (kept init)")
    if unexpected:
        print(f"pretrained: {len(unexpected)} unexpected keys (skipped)")
    return missing, unexpected


def init_train_state(cfg, device=None, steps_per_epoch: int = 1000) -> TrainState:
    """Model (seeded init, then ``model.pretrained`` if set; training mode),
    optimizer and EMA copies of the loaded weights.

    :param cfg: a TrainConfig, a dict or a YAML path (train/config.py)
    :param device: None means CUDA (raises where no GPU is present); pass
        "cpu" explicitly to run on the CPU
    :param steps_per_epoch: converts the schedule's epochs to steps (the JAX
        solver's default without a data pipeline is 1000)"""
    cfg = cfg if isinstance(cfg, TrainConfig) else load_config(cfg)
    dev = resolve_device(device)
    amp_dtype = torch.bfloat16 if cfg.optim.amp else None
    model = build_from_cfg(vars(cfg.model), train=True, dtype=amp_dtype, seed=cfg.seed)
    if cfg.model.pretrained:
        load_pretrained(model, cfg.model.pretrained)
    model.to(dev)
    ddp = None
    if D.rank_world()[1] > 1:
        # the constructor broadcasts rank 0's parameters and buffers; the
        # buffers need no broadcast after that: the global-batch BatchNorm
        # moves them identically on every rank
        ids = None
        if dev.type == "cuda":
            ids = [dev.index if dev.index is not None else torch.cuda.current_device()]
        ddp = nn.parallel.DistributedDataParallel(model, device_ids=ids, broadcast_buffers=False)
    opt, schedules = build_optimizer(cfg.optim, model.named_parameters(), steps_per_epoch)
    buffers = dict(model.named_buffers())
    return TrainState(
        model=model, optimizer=opt, schedules=schedules,
        ema_params={k: p.detach().clone() for k, p in model.named_parameters()},
        ema_buffers={k: buffers[k].clone() for k in _ema_buffer_names(model)},
        step=0, ddp=ddp)


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
    Under ``state.ddp`` (a group of more than one rank) the batch is this
    rank's and the metrics are the global batch's.
    amp: normalize in bf16; the model's own ``dtype`` sets its autocast.
    ema=False: the EMA slots track the raw weights (solver.py:84-88).
    encoding: 'unbiased' (RefineSimpleTransform) or 'biased'
    (BasicSimpleTransform, with stride 1: joints are in heatmap coordinates).

    Traced (utils/tracing): ``train.step`` (id: ``state.step`` on entry)
    holds ``train.forward`` (the model and the loss), ``train.backward``
    (zero_grad and the backward) and ``train.update`` (the schedule, the
    optimizer and EMA); the crop, the targets and the accuracy are the
    step's own.
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
        with tracing.span("train.step", id=state.step):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch):
        model, opt = state.model, state.optimizer
        device = next(model.parameters()).device
        with torch.no_grad():
            crops = _crops(crop_fn, batch, device)
            x = _normalize(crops.to(torch.bfloat16) if amp else crops)
            x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
            targets, weights = encode_fn(_to(batch["joints"], device))
            mask = weights[..., None, None]
        model.train()
        with tracing.span("train.forward"):
            preds = (state.ddp or model)(x).float()
            loss = 0.5 * torch.mean((preds * mask - targets * mask) ** 2)
        # zero_grad before the backward keeps the step's order of memory use;
        # its time counts as the backward's
        with tracing.span("train.backward"):
            opt.zero_grad(set_to_none=True)
            loss.backward()
        with tracing.span("train.update"):
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
        with torch.no_grad():
            # summed over the ranks (their own values on one rank)
            correct, valid = heatmap_accuracy_counts(preds.detach() * mask, targets * mask)
            c = correct.shape[0]
            sums = D.allreduce_sum(torch.cat([correct, valid, loss.detach()[None]]))
        return state, {"loss": sums[2 * c] / D.rank_world()[1],
                       "acc": accuracy_from_counts(sums[:c], sums[c:2 * c])}

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


class PoseSolver:
    """End-to-end trainer (the DP and DDP Processor equivalent): one device,
    or one rank of an initialised torch.distributed group.

    :param cfg: a TrainConfig, a dict or a YAML path (train/config.py); its
        ``mesh.data`` must be -1 or the number of ranks
    :param device: None means CUDA (the rank's pinned card; raises where no
        GPU is present); pass "cpu" explicitly to run on the CPU"""

    _TRAIN_DEVICE_KEYS = ("canvas", "canvas_idx", "trans", "joints")
    _VAL_DEVICE_KEYS = ("canvas", "canvas_idx", "trans", "trans_inv", "joints")

    def __init__(self, cfg, device=None):
        self.cfg: TrainConfig = cfg if isinstance(cfg, TrainConfig) else load_config(cfg)
        cfgd = self.cfg
        self.device = resolve_device(device)
        rank, world = D.rank_world()
        n_data = int((cfgd.mesh or {}).get("data", -1))
        if n_data not in (-1, world):
            raise ValueError(f"mesh.data is {n_data}, but {world} rank(s) run: give -1 "
                             f"or {world}")
        shard = D.shard_kwargs()
        in_w, in_h = cfgd.data.input_shape
        self.crop_shape = (in_h, in_w)
        self.out_shape = (in_h // 4, in_w // 4)
        common = dict(input_shape=cfgd.data.input_shape, output_shape=(in_w // 4, in_h // 4),
                      canvas=cfgd.data.canvas, seed=cfgd.seed,
                      num_threads=cfgd.data.num_workers)

        self.train_pipe = self.val_pipe = None
        if cfgd.data.train_ann_path:
            recs = load_coco_keypoints(cfgd.data.train_img_root, cfgd.data.train_ann_path,
                                       cfgd.data.debug, check_center=cfgd.data.check_center)
            # one device per rank: one bucket per rank (JAX solver.py:217-223)
            dedup_canvases = 0
            if cfgd.data.dedup and cfgd.data.dedup_ratio > 0:
                dedup_canvases = max(1, int(round(cfgd.data.batch_size * cfgd.data.dedup_ratio)))
            self.train_pipe = PosePipeline(
                recs, cfgd.data.batch_size, augment=cfgd.data.augment,
                aug_scale=cfgd.data.aug_scale, aug_rot=cfgd.data.aug_rot,
                aug_flip=cfgd.data.aug_flip, dedup_canvases=dedup_canvases, **shard, **common)
        if cfgd.data.val_ann_path:
            recs = load_coco_keypoints(cfgd.data.val_img_root, cfgd.data.val_ann_path,
                                       cfgd.data.debug, check_center=cfgd.data.check_center)
            self.val_pipe = PosePipeline(recs, cfgd.data.batch_size, augment=False,
                                         shuffle=False, drop_last=False, **shard, **common)

        # The schedule counts plain batches per epoch even where dedup
        # packing yields another number of batches, as the JAX solver does
        # (solver.py:247).
        self._steps_per_epoch = self.train_pipe.batches_per_epoch() if self.train_pipe else 1000
        self.state: Optional[TrainState] = None
        self.best_ap = 0.0
        self._train_step = None
        self._val_step = None

    def init_state(self) -> TrainState:
        self.state = init_train_state(self.cfg, self.device, self._steps_per_epoch)
        return self.state

    def _compile(self):
        if self._train_step is None:
            self._train_step = make_train_step(self.out_shape, self.crop_shape,
                                               amp=self.cfg.optim.amp, ema=self.cfg.optim.ema,
                                               encoding=self.cfg.data.encoding)
        if self._val_step is None:
            decoder = self.cfg.val.decoder or (
                "gauss_taylor" if self.cfg.model.type == "pose_hrnet" else "basic")
            self._val_step = make_val_step(decoder, self.out_shape, self.crop_shape)

    # -- loops -------------------------------------------------------------

    def train_epoch(self, epoch: int, log_every: int = 50):
        self._compile()
        t0 = time.time()
        # Metrics stay on the device between log points: a per-step .item()
        # would make the host wait for step i before it queues step i+1
        # (the reference pays that via loss.item(),
        # dp_pose_resnet_solver.py:120).  They are fetched at log_every and
        # at the end of the epoch.
        pending = []
        loss_sum, acc_sum, n = 0.0, 0.0, 0

        def drain():
            nonlocal loss_sum, acc_sum, n
            if pending:
                vals = torch.stack(pending).cpu().numpy().astype(np.float64)
                loss_sum += float(vals[:, 0].sum())
                acc_sum += float(vals[:, 1].sum())
                n += len(pending)
                pending.clear()

        batches = device_prefetch(self.train_pipe.epoch(epoch), self.device,
                                  device_keys=self._TRAIN_DEVICE_KEYS)
        global_batch = self.cfg.data.batch_size * D.rank_world()[1]
        for i, batch in enumerate(batches):
            self.state, metrics = self._train_step(self.state, batch)
            pending.append(torch.stack([metrics["loss"], metrics["acc"]]))
            if log_every and (i + 1) % log_every == 0:
                drain()
                dt = time.time() - t0
                if D.is_main():
                    print(
                        f"train epoch:{epoch + 1:3d}|iter:{i + 1:4d}|loss:{loss_sum / n:8.6f}"
                        f"|acc:{acc_sum / n * 100:6.4f}|{global_batch * n / dt:7.1f} crops/s")
        drain()
        return {"loss": loss_sum / max(n, 1), "acc": acc_sum / max(n, 1)}

    def validate(self, epoch: int, results_path: str = "temp_test.json"):
        """COCO AP of the live weights on the val set.  Under a group every
        rank evaluates its stride of the records and gathers every rank's
        predictions per batch (JAX solver.py:397-431), rank 0 writes
        ``results_path``, and every rank scores it: the same stats on each."""
        self._compile()
        results = []
        loss_sum, acc_sum, n = 0.0, 0.0, 0

        # One-step software pipeline: the val step for batch i+1 is queued
        # before batch i's outputs are fetched, so the host's fetch and
        # result building overlap the device's work.
        def process(out, valid, img_ids):
            nonlocal loss_sum, acc_sum, n
            loss_sum += float(D.allreduce_mean(out["loss"]))
            acc_sum += float(D.allreduce_mean(out["acc"]))
            n += 1
            host = D.allgather_tiled({
                "kps": out["kps"].cpu().numpy(), "kp_conf": out["kp_conf"].cpu().numpy(),
                "scores": out["scores"].cpu().numpy(), "valid": np.asarray(valid),
                "img_id": np.asarray(img_ids)})
            valid, img_ids = host["valid"], host["img_id"]
            kps, conf, scores = host["kps"], host["kp_conf"], host["scores"]
            for b in range(kps.shape[0]):
                if valid[b] < 0.5:
                    continue
                results.append({
                    "image_id": int(img_ids[b]),
                    "category_id": 1,
                    "keypoints": np.concatenate([kps[b], conf[b]], -1).reshape(-1).tolist(),
                    "score": float(scores[b]),
                })

        pending = None
        for batch in device_prefetch(self.val_pipe.epoch(0), self.device,
                                     device_keys=self._VAL_DEVICE_KEYS):
            out = self._val_step(
                self.state, {k: batch[k] for k in self._VAL_DEVICE_KEYS if k in batch})
            if pending is not None:
                process(*pending)
            pending = (out, batch["valid"], batch["img_id"])
        if pending is not None:
            process(*pending)

        def write(path):
            with open(path, "w") as wf:
                json.dump(results, wf)

        D.write_once(results_path, write)
        stats = evaluate_map(results_path, self.cfg.data.val_ann_path)
        if D.is_main():
            print(
                f"eval epoch:{epoch + 1:d}|mean_loss:{loss_sum / max(n, 1):8.6f}"
                f"|mean_acc:{acc_sum / max(n, 1) * 100:6.4f}|val_ap:{stats['AP']:6.4f}"
            )
        return stats

    # -- checkpoints ---------------------------------------------------------

    def checkpoint_path(self, name: Optional[str] = None) -> str:
        """``<weight_path>/<model.type>_last.pth`` (or ``<name>.pth``)."""
        name = name or f"{self.cfg.model.type}_last"
        return os.path.join(os.path.abspath(self.cfg.val.weight_path), f"{name}.pth")

    def save_checkpoint(self, epoch: int, val_ap: float):
        """Write ``_last.pth``, and ``_best.pth`` when ``val_ap`` beats the
        best so far; under a group rank 0 writes, and every rank waits for
        it.  The file holds ``model`` (the state_dict), ``ema`` (the
        EMA weights and BN statistics as a state_dict under the reference's
        key names, so the file loads as a reference checkpoint:
        ``PoseEvaluator(weights=)`` or ``model.pretrained``), ``optimizer``,
        ``step``, ``epoch`` and ``val_ap``."""
        st = self.state
        model_sd = st.model.state_dict()
        counters = {k: v for k, v in model_sd.items() if k.endswith("num_batches_tracked")}
        ckpt = {
            "model": model_sd,
            "ema": {**st.ema_params, **st.ema_buffers, **counters},
            "optimizer": st.optimizer.state_dict(),
            "step": st.step,
            "epoch": epoch,
            "val_ap": float(val_ap),
        }
        best = val_ap > self.best_ap
        if best:
            self.best_ap = val_ap

        def write(last):
            os.makedirs(os.path.dirname(last), exist_ok=True)
            tmp = f"{last}.{os.getpid()}.tmp"
            torch.save(ckpt, tmp)
            os.replace(tmp, last)  # a cut-off save never leaves a torn _last
            if best:
                path = self.checkpoint_path(f"{self.cfg.model.type}_best")
                shutil.copyfile(last, f"{path}.tmp")
                os.replace(f"{path}.tmp", path)

        D.write_once(self.checkpoint_path(), write)

    def restore_checkpoint(self, name: Optional[str] = None) -> int:
        """Load a checkpoint of :meth:`save_checkpoint` into the state (resume,
        which the reference lacks).  Sets ``best_ap`` to its ``val_ap``.

        :returns: the epoch to continue from
        :raises FileNotFoundError: when there is no such checkpoint"""
        if self.state is None:
            self.init_state()
        # Loaded on the CPU: the optimizer moves each moment to its
        # parameter's device but leaves Adam's per-parameter step where it
        # finds it, and a step on the card costs a device sync per parameter
        # in every update (optimizer.step reads it with .item()).
        ckpt = torch.load(self.checkpoint_path(name), map_location="cpu", weights_only=True)
        st = self.state
        st.model.load_state_dict(ckpt["model"])
        st.optimizer.load_state_dict(ckpt["optimizer"])
        with torch.no_grad():
            for k, t in {**st.ema_params, **st.ema_buffers}.items():
                t.copy_(ckpt["ema"][k])
        st.step = int(ckpt["step"])
        self.best_ap = float(ckpt["val_ap"])
        return int(ckpt["epoch"]) + 1

    def run(self, resume: bool = False):
        start_epoch = 0
        if self.state is None:
            self.init_state()
        if resume:
            try:
                start_epoch = self.restore_checkpoint()
                print(f"resumed at epoch {start_epoch}")
            except FileNotFoundError:
                pass
        for epoch in range(start_epoch, self.cfg.optim.epochs):
            self.train_epoch(epoch)
            if (epoch + 1) % self.cfg.val.interval == 0:
                stats = self.validate(epoch)
                self.save_checkpoint(epoch, stats["AP"])
