"""Building blocks matched to the reference's torch modules (NCHW).

Port of simple_pose_tpu/models/layers.py.  The JAX package re-creates each
torch op in flax; here they are the torch ops themselves:

  * conv / conv3x3 / conv1x1  -> nn.Conv2d, bias-free unless asked
  * batch_norm                -> BatchNorm2d (eps 1e-5, momentum 0.1; flax
                                 momentum 0.9 is torch momentum 0.1), which
                                 trains like flax's nn.BatchNorm (below)
  * deconv                    -> nn.ConvTranspose2d(k4, s2, p1, bias=False)
  * max pool                  -> nn.MaxPool2d(3, 2, 1)
  * SELayer                   -> nets/commons.py:4-18: mean -> 1x1 conv ->
                                 ReLU -> 1x1 conv -> sigmoid, both convs with
                                 bias, reduction 1; module path ``se.fc.{0,2}``
  * DUC                       -> nets/commons.py:21-43: 3x3 conv -> BN ->
                                 ReLU -> nn.PixelShuffle (the JAX
                                 ``pixel_shuffle`` keeps torch's channel
                                 order); module paths ``conv`` and ``bn``

Init (``init_weights``): head layers normal(0.001) (HEAD_INIT), body convs He
fan-out normal (BODY_INIT), conv biases 0, BN weight 1 and bias 0 -- the
distributions of the JAX package's initializers, drawn from a seeded
torch.Generator.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = ["conv", "conv3x3", "conv1x1", "batch_norm", "BatchNorm2d", "SELayer", "DUC",
           "BODY_INIT", "HEAD_INIT", "init_weights"]


def HEAD_INIT(shape, generator):
    """normal(0, 0.001): the deconvs and the final 1x1 (pose_resnet_dconv.py:
    180-189)."""
    return torch.randn(shape, generator=generator) * 0.001


def BODY_INIT(shape, generator):
    """He fan-out normal for an OIHW kernel, fan_out = O x kH x kW (torch's
    kaiming_normal_(mode='fan_out'), flax's variance_scaling(2, fan_out))."""
    fan_out = shape[0] * math.prod(shape[2:])
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_out)


def conv(cin, cout, kernel, stride=1, padding=0, groups=1, bias=False):
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, groups=groups,
                     bias=bias)


def conv3x3(cin, cout, stride=1, groups=1):
    return conv(cin, cout, 3, stride, 1, groups=groups)


def conv1x1(cin, cout, stride=1):
    return conv(cin, cout, 1, stride, 0)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training update is flax's nn.BatchNorm
    (layers.py:68-77 of the JAX package).

    Both normalize with the biased batch variance, computed in f32.  Torch
    moves ``running_var`` toward the *unbiased* variance, flax toward the
    biased one: they differ by n/(n-1), up to 14% at n = 8.  Here
    F.batch_norm (PyTorch's own kernels, as for nn.BatchNorm2d) normalizes
    and updates copies of the buffers; the copy's move gives back the batch
    variance, and the buffer gets the biased update.  Per-channel arithmetic only: no second pass
    over the activations.

    ``update_stats = False`` normalizes with the batch statistics as usual
    but leaves the buffers alone: the recompute of a rematerialized block
    (models/resnet.py) sets it, since that block's forward already moved
    them once.

    Under an initialised torch.distributed group of more than one rank the
    batch statistics are the global batch's, as in the JAX package's SPMD
    step (train/solver.py:1-10): the per-channel count, sum and sum of
    squares (f32) are all-reduced, in one call, through the autograd-aware
    ``torch.distributed.nn.functional.all_reduce``, so the backward is
    global too; the variance is flax's one-pass E[x^2] - E[x]^2 (biased,
    clamped at 0).  A recompute makes the same collectives, so every rank
    makes them in the same order.  ``nn.SyncBatchNorm`` is not used: it
    refuses CPU tensors."""

    update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            return self._global_batch_forward(x)
        n = x.numel() // x.shape[1]
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        if not self.update_stats:
            return y
        with torch.no_grad():
            # var = (1-m) rv + m v_unbiased, so rv + m v_biased = var - m v_unbiased / n
            moved = var - (1.0 - self.momentum) * self.running_var
            self.running_var.copy_(var - moved / n)
            self.running_mean.copy_(mean)
            self.num_batches_tracked.add_(1)
        return y

    def _global_batch_forward(self, x):
        from torch.distributed.nn.functional import all_reduce

        c, shape = x.shape[1], (1, x.shape[1], 1, 1)
        xf = x.float()
        count = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
        stats = all_reduce(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]))
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean.reshape(shape)) * scale.reshape(shape) + self.bias.float().reshape(shape)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
                self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def batch_norm(channels):
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class SELayer(nn.Module):
    """Squeeze-excitation gate, reduction ratio 1 (nets/commons.py:4-18)."""

    def __init__(self, channel: int, reduction: int = 1):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Conv2d(channel, channel // reduction, 1, bias=True),
            nn.ReLU(inplace=True),
            nn.Conv2d(channel // reduction, channel, 1, bias=True),
            nn.Sigmoid(),
        )

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3), keepdim=True))


class DUC(nn.Module):
    """Dense upsampling conv: 3x3 conv -> BN -> ReLU -> PixelShuffle
    (nets/commons.py:21-43): [B, Cin, H, W] -> [B, planes / r^2, rH, rW]."""

    def __init__(self, inplanes: int, planes: int, upscale: int = 2):
        super().__init__()
        self.conv = conv3x3(inplanes, planes)
        self.bn = batch_norm(planes)
        self.relu = nn.ReLU(inplace=True)
        self.pixel_shuffle = nn.PixelShuffle(upscale)

    def forward(self, x):
        return self.pixel_shuffle(self.relu(self.bn(self.conv(x))))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator, head_modules=()):
    """Initialize ``model`` in place from ``generator`` (a CPU generator; move
    the model afterwards).  Every ConvTranspose2d and the modules in
    ``head_modules`` get HEAD_INIT, other convs BODY_INIT."""
    head = {id(m) for m in head_modules}
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            is_head = id(m) in head or isinstance(m, nn.ConvTranspose2d)
            m.weight.copy_((HEAD_INIT if is_head else BODY_INIT)(m.weight.shape, generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
