"""A configuration's weights, drawn from the run's seed on the device.

The benchmark makes the weights itself and hands the same state dict to
the program and to the plain reference.  The key names and shapes come from
the plain model built on the meta device; the values come from two draws on
``device`` (one normal, one uniform) with a ``torch.Generator`` seeded by
the run's seed, sliced into the entries, in float32, the type the program
keeps its parameters in.

The draws keep activations of order one through the whole depth, in eval
and in training mode, and put BatchNorm's running statistics and affines
away from 0 and 1, so that folding BatchNorm into layer1 (the program's
fused layer1) has real work to do:

  * conv kernels: He normal on the fan-in (sqrt(2 / fan_in)); a transposed
    conv of stride 2 and kernel 4 counts 4 taps an output; the last conv of
    the squeeze-excitation gate and the final 1x1 conv, which no ReLU
    follows, sqrt(1 / fan_in);
  * conv biases: normal(0, 0.1);
  * BatchNorm: weight log-uniform over (0.3, 3), as trained nets spread
    their channels' gains over a decade (which also gives per-tensor int8
    activations the outlier channels they meet in trained nets), and over
    (0.1, 0.3) where the BatchNorm closes a residual branch (a trained
    ResNet's last gains are small; with gains of order one the error of
    each rounding grows by ~3x a stage and a bf16 forward ends ~40% from
    float32); bias normal(0, 0.2).

Running statistics drawn apart from the activations they normalize make
the eval-mode forward grow without bound through the depth (HRNet-W32's
heatmaps reach 1e9).  So the running statistics are set as a trained net's
would be: one float32 training-mode forward of the plain model over a small
batch of uniform noise images (drawn from the same generator) gives each
BatchNorm's batch mean m per channel and variance v, the mean over its
channels (per channel, a channel that is all but dead would be scaled up
to unit variance, and its rounding noise with it); the entry gets running
mean m + 0.1 sqrt(v) n, n normal, and running variance v u, u uniform(0.8,
1.25).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from portbench.reference.models import BasicBlock, BatchNorm, Bottleneck, build

__all__ = ["seeded_state_dict", "plain_model"]

# the BatchNorm that closes a residual branch, before the identity is added
RESIDUAL_LAST = {Bottleneck: "bn3", BasicBlock: "bn2"}


def plain_model(model_cfg: dict, device="meta") -> nn.Module:
    with torch.device(device):
        return build(model_cfg)


def _specs(model: nn.Module):
    """(key, shape, draw, scale, shift) for every state dict entry, in order;
    draw is "normal", "uniform", "loguniform" (between scale and shift) or
    "zero"."""
    specs = []
    last = {f"{name}.{RESIDUAL_LAST[type(mod)]}" for name, mod in model.named_modules()
            if type(mod) in RESIDUAL_LAST}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, BatchNorm):
            c = mod.weight.shape
            specs += [(pre + "weight", c, "loguniform", *((0.1, 0.3) if name in last else (0.3, 3.0))),
                      (pre + "bias", c, "normal", 0.2, 0.0),
                      (pre + "running_mean", c, "normal", 1.0, 0.0),
                      (pre + "running_var", c, "uniform", 0.45, 0.8),
                      (pre + "num_batches_tracked", (), "zero", 0.0, 0.0)]
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight.shape
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = w[0] * w[2] * w[3] // (mod.stride[0] * mod.stride[1])
            else:
                fan_in = w[1] * w[2] * w[3]
            linear = name == "final_layer" or name.endswith("fc.2")
            specs.append((pre + "weight", w, "normal",
                          math.sqrt((1.0 if linear else 2.0) / fan_in), 0.0))
            if mod.bias is not None:
                specs.append((pre + "bias", mod.bias.shape, "normal", 0.1, 0.0))
    return specs


@torch.no_grad()
def _batch_statistics(model_cfg, state, images):
    """{BatchNorm path: (batch mean, biased batch variance)} of a float32
    training-mode forward of the plain model with ``state`` on ``images``."""
    model = plain_model(model_cfg, images.device)
    model.load_state_dict(state)
    model.train()
    stats = {}

    def hook(name):
        def record(_, args):
            x = args[0]
            stats[name] = (x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False))
        return record

    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            mod.register_forward_pre_hook(hook(name))
    model(images)
    return stats


def seeded_state_dict(model_cfg: dict, seed: int, device, input_hw=(256, 192),
                      calib_images: int = 8) -> dict:
    """{key: float32 tensor on ``device``} (``num_batches_tracked``: int64
    zeros) for the plain model of ``model_cfg``, from ``seed``; the running
    statistics follow a forward over ``calib_images`` noise images of
    ``input_hw``."""
    specs = _specs(plain_model(model_cfg))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = {d: sum(math.prod(s) for _, s, dd, _, _ in specs if dd == d)
             for d in ("normal", "uniform", "loguniform")}
    flat = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
            "uniform": torch.rand(sizes["uniform"] + sizes["loguniform"], generator=gen,
                                  device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for key, shape, draw, scale, shift in specs:
        if draw == "zero":
            out[key] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        n = math.prod(shape)
        if draw == "loguniform":  # between scale and shift, uniform in the log
            u = flat["uniform"][at["uniform"]:at["uniform"] + n].reshape(shape)
            out[key] = scale * (shift / scale) ** u
            at["uniform"] += n
            continue
        out[key] = flat[draw][at[draw]:at[draw] + n].reshape(shape) * scale + shift
        at[draw] += n
    images = torch.rand((calib_images, 3, *input_hw), generator=gen, device=device) - 0.45
    for name, (mean, var) in _batch_statistics(model_cfg, out, images).items():
        var = var.mean()
        out[f"{name}.running_mean"] = mean + out[f"{name}.running_mean"] * 0.1 * var.sqrt()
        out[f"{name}.running_var"] = var * out[f"{name}.running_var"]
    return out
