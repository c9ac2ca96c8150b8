"""The plain float32 training step: the two-stage crop, targets, forward with batch
statistics, masked MSE, backward, Adam with its schedule, EMA.

Written from the configurations' trainer (liangheming/simple_pose
``dp_pose_resnet_solver.py``, ``commons/model_utils.py`` ModelEMA;
optax's ``adam``, ``add_decayed_weights`` and the multistep schedule),
with no fused optimizer, no autocast and TF32 off (the caller sets it).

  * Adam: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, p -= lr (m /
    (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps); b1 0.9, b2 0.999, eps 1e-8;
    weight decay added to the gradients of the kernels (tensors of two or
    more dimensions) only;
  * the learning rate at step t (counting from 0) is lr * gamma^k, k the
    milestones (in epochs of ``steps_per_epoch`` steps) at or below t;
  * EMA after update n (counting from 1): d = 0.9999 (1 - exp(-n / 2000)),
    in float32; ema = d ema + (1 - d) live, for every parameter and every
    BatchNorm running mean and variance.

``fp8=True`` gives every conv and transposed conv float8 operands: input
and weight in e4m3 in the forward and the products of the backward, the
output's gradient in e5m2, each tensor scaled by its largest magnitude:
the benchmark's control, one precision below the configurations' bf16
(whose autocast runs the convs' forward and backward products in bf16).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import ops as R

__all__ = ["Trainer"]


def _round(t, dtype):
    amax = t.abs().amax().clamp(min=1e-30)
    top = torch.finfo(dtype).max
    return (t * (top / amax)).to(dtype).float() * (amax / top)


class _Fp8Conv(torch.autograd.Function):
    """A conv (or transposed conv) whose products take float8 operands:
    input and weight in e4m3 forward, the output's gradient in e5m2 (the
    usual float8 training recipe), each scaled by its largest magnitude;
    sums in float32."""

    @staticmethod
    def forward(ctx, x, w, fn):
        qx, qw = _round(x, torch.float8_e4m3fn), _round(w, torch.float8_e4m3fn)
        ctx.save_for_backward(qx, qw)
        ctx.fn = fn
        return fn(qx, qw)

    @staticmethod
    def backward(ctx, gy):
        qx, qw = ctx.saved_tensors
        with torch.enable_grad():
            x = qx.detach().requires_grad_()
            w = qw.detach().requires_grad_()
            y = ctx.fn(x, w)
        gx, gw = torch.autograd.grad(y, (x, w), _round(gy, torch.float8_e5m2))
        return gx, gw, None


@contextlib.contextmanager
def _fp8_convs(model):
    convs = [m for m in model.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]

    def forward(mod):
        if isinstance(mod, nn.ConvTranspose2d):
            fn = lambda x, w: F.conv_transpose2d(x, w, None, mod.stride, mod.padding,  # noqa: E731
                                                 mod.output_padding, mod.groups, mod.dilation)
        else:
            fn = lambda x, w: F.conv2d(x, w, None, mod.stride, mod.padding,  # noqa: E731
                                       mod.dilation, mod.groups)

        def run(x):
            y = _Fp8Conv.apply(x, mod.weight, fn)
            return y if mod.bias is None else y + mod.bias.reshape(1, -1, 1, 1)
        return run

    for m in convs:
        m.forward = forward(m)
    try:
        yield
    finally:
        for m in convs:
            del m.forward


class Trainer:
    """The model, Adam's moments and the EMA copies of one training run."""

    def __init__(self, model: nn.Module, optim: dict, steps_per_epoch: int, fp8=False):
        self.model = model.train()
        self.o = optim
        self.steps_per_epoch = steps_per_epoch
        self.fp8 = fp8
        self.params = dict(model.named_parameters())
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.ema = {k: t.detach().clone() for k, t in self._ema_live().items()}
        self.step_count = 0

    def _ema_live(self):
        live = {k: p.detach() for k, p in self.params.items()}
        live.update({k: b for k, b in self.model.named_buffers()
                     if not k.endswith("num_batches_tracked")})
        return live

    def lr(self, step):
        passed = sum(step >= m * self.steps_per_epoch for m in self.o["milestones"])
        return self.o["lr"] * self.o["gamma"] ** passed

    def loss(self, canvas, batch, crop_hw):
        """The masked MSE of a batch {canvas_idx, trans, joints} on
        ``canvas`` (device uint8 [slots, S, S, 3])."""
        dev = canvas.device
        idx = torch.as_tensor(batch["canvas_idx"], device=dev).long()
        crops = R.crop_two_stage(canvas[idx], torch.as_tensor(batch["trans"], device=dev), crop_hw)
        x = R.normalize(crops)
        ctx = _fp8_convs(self.model) if self.fp8 else contextlib.nullcontext()
        with ctx:
            pred = self.model(x)
        tgt, weight = R.targets(torch.as_tensor(batch["joints"], device=dev),
                                (crop_hw[0] // 4, crop_hw[1] // 4))
        return R.masked_mse(pred, tgt, weight)

    def step(self, canvas, batch, crop_hw):
        """One update; returns (loss, {param: gradient as Adam receives it})."""
        for p in self.params.values():
            p.grad = None
        loss = self.loss(canvas, batch, crop_hw)
        loss.backward()
        lr = self.lr(self.step_count)
        self.step_count += 1
        t = self.step_count
        b1, b2, eps, wd = 0.9, 0.999, 1e-8, self.o.get("weight_decay", 0.0)
        grads = {}
        with torch.no_grad():
            for k, p in self.params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if wd and p.dim() > 1:
                    g = g + wd * p
                grads[k] = g
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k] / (1 - b2 ** t)).sqrt() + eps
                p.sub_(lr * (self.m[k] / (1 - b1 ** t)) / denom)
            n = np.float32(t)
            d = float(np.float32(0.9999) * (np.float32(1.0) - np.exp(-n / np.float32(2000.0))))
            for k, live in self._ema_live().items():
                self.ema[k].mul_(d).add_(live, alpha=1 - d)
        return float(loss.detach()), grads


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in tensors.items()}


def run_reference(model, optim, steps_per_epoch, batches, canvases, crop_hw, fp8=False,
                  steps=3) -> dict:
    """``steps`` reference steps from ``model``'s weights: {loss: [...],
    grad: first step's gradient norms, change: parameter change norms,
    ema: EMA change norms, kernels: the parameters of two or more dimensions}."""
    tr = Trainer(model, optim, steps_per_epoch, fp8=fp8)
    start = {k: p.detach().clone() for k, p in tr.params.items()}
    ema0 = {k: t.clone() for k, t in tr.ema.items()}
    losses, grad = [], None
    for i in range(steps):
        loss, g = tr.step(canvases[i], batches[i], crop_hw)
        losses.append(loss)
        if i == 0:
            grad = norms(g)
    change = norms({k: p.detach() - start[k] for k, p in tr.params.items()})
    ema = norms({k: t - ema0[k] for k, t in tr.ema.items()})
    if not all(math.isfinite(x) for x in losses):
        raise FloatingPointError(f"reference losses {losses}")
    return {"loss": losses, "grad": grad, "change": change, "ema": ema,
            "kernels": [k for k, p in tr.params.items() if p.dim() > 1]}
