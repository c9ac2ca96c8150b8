"""Plain float32 PyTorch copies of the two pose families the benchmark runs.

Frozen copies, written against the published models and kept apart from
the program: no kernel, no autocast, no rematerialization, no collective.
They import torch alone.

  * ``PoseResNet``: a torchvision-style ResNet trunk of Bottleneck blocks,
    squeeze-excitation (reduction 1) in each stage's first block where that
    block projects (liangheming/simple_pose ``reduction: true``), then the
    Simple Baselines head: 3 x [ConvTranspose k4 s2 -> BN -> ReLU] to 256
    channels and a 1x1 conv to the joints (Xiao et al., arXiv:1804.06208).
  * ``PoseHRNet``: the HRNet-W32 topology (Sun et al., arXiv:1902.09212;
    leoxiaobin/deep-high-resolution-net.pytorch ``pose_hrnet.py``): a stem of
    two stride-2 3x3 convs, a Bottleneck layer1, stages 2-4 of basic-block
    branches with all-to-all fusion (1x1 conv + BN + nearest upsample from a
    coarser branch, chains of stride-2 3x3 conv + BN from a finer one), the
    1x1 final conv on the highest-resolution branch.

Module paths are the reference checkpoints' state_dict keys, so one state
dict loads into both this copy and the program.

BatchNorm in training normalizes with the biased batch variance and moves
its running variance toward that biased variance (momentum 0.1), as the
configurations' trainer (flax's BatchNorm) does; in eval it uses the running
statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "PoseResNet", "PoseHRNet", "build"]


class BatchNorm(nn.Module):
    """BatchNorm2d, eps 1e-5, momentum 0.1, spelled out in float32."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.eps, self.momentum = 1e-5, 0.1

    def forward(self, x):
        shape = (1, -1, 1, 1)
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean.reshape(shape)) ** 2).mean(dim=(0, 2, 3))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight / torch.sqrt(var + self.eps)
        return (x - mean.reshape(shape)) * scale.reshape(shape) + self.bias.reshape(shape)


def _conv(cin, cout, k, stride=1, padding=0, bias=False):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


class SE(nn.Module):
    """x * sigmoid(fc2(relu(fc1(mean(x))))), both 1x1 convs with bias."""

    def __init__(self, c):
        super().__init__()
        self.fc = nn.Sequential(_conv(c, c, 1, bias=True), nn.ReLU(),
                                _conv(c, c, 1, bias=True), nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3), keepdim=True))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, project=False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 3, padding=1), BatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, padding=1), BatchNorm(planes)
        self.downsample = (nn.Sequential(_conv(cin, planes, 1), BatchNorm(planes))
                           if project else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idn)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, project=False, se=False):
        super().__init__()
        out = planes * 4
        self.conv1, self.bn1 = _conv(cin, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride, 1), BatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1), BatchNorm(out)
        self.se = SE(out) if se else None
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride), BatchNorm(out))
                           if project else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.se is not None:
            out = self.se(out)
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idn)


class PoseResNet(nn.Module):
    """Bottleneck ResNet trunk (``layers`` blocks a stage) + deconv head."""

    def __init__(self, layers=(3, 4, 6, 3), se=True, num_joints=17, deconv=(256, 256, 256)):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 7, 2, 3), BatchNorm(64)
        cin = 64
        for s, (planes, n, stride) in enumerate(zip((64, 128, 256, 512), layers, (1, 2, 2, 2)), 1):
            blocks = []
            for i in range(n):
                project = i == 0 and (stride != 1 or cin != planes * 4)
                blocks.append(Bottleneck(cin, planes, stride if i == 0 else 1, project,
                                         se=se and project))
                cin = planes * 4
            setattr(self, f"layer{s}", nn.Sequential(*blocks))
        head = []
        for c in deconv:
            head += [nn.ConvTranspose2d(cin, c, 4, stride=2, padding=1, bias=False),
                     BatchNorm(c), nn.ReLU()]
            cin = c
        self.deconv_layers = nn.Sequential(*head)
        self.final_layer = _conv(cin, num_joints, 1, bias=True)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for s in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = s(x)
        return self.final_layer(self.deconv_layers(x))


def _conv_bn(cin, cout, stride, relu):
    mods = [_conv(cin, cout, 3, stride, 1), BatchNorm(cout)]
    return nn.Sequential(*mods, nn.ReLU()) if relu else nn.Sequential(*mods)


def _branch(block, cin, planes, n):
    out = []
    for _ in range(n):
        out.append(block(cin, planes, project=cin != planes * block.expansion))
        cin = planes * block.expansion
    return nn.Sequential(*out)


class _Upsample(nn.Module):
    def __init__(self, factor):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return x.repeat_interleave(self.factor, 2).repeat_interleave(self.factor, 3)


class HRModule(nn.Module):
    """Branches of basic blocks, then each output the sum over all branches
    brought to its resolution, ReLU'd."""

    def __init__(self, channels, num_blocks, multi_scale):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(_branch(BasicBlock, c, c, num_blocks) for c in channels)
        rows = []
        for i in range(n if multi_scale else 1):
            row = []
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(_conv(channels[j], channels[i], 1),
                                             BatchNorm(channels[i]), _Upsample(2 ** (j - i))))
                elif j < i:
                    row.append(nn.Sequential(*(
                        _conv_bn(channels[j], channels[i] if k == i - j - 1 else channels[j], 2,
                                 relu=k != i - j - 1) for k in range(i - j))))
                else:
                    row.append(None)
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        xs = [b(x) for b, x in zip(self.branches, xs)]
        outs = []
        for row in self.fuse_layers:
            y = None
            for j, layer in enumerate(row):
                t = xs[j] if layer is None else layer(xs[j])
                y = t if y is None else y + t
            outs.append(F.relu(y))
        return outs


class PoseHRNet(nn.Module):
    """HRNet with ``width`` channels in its highest-resolution branch:
    stage s has s branches of width * 2^b channels, with 1, 4 and 3 modules
    in stages 2, 3 and 4 and 4 basic blocks a branch."""

    def __init__(self, width=32, num_joints=17, modules=(1, 4, 3), num_blocks=4):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 3, 2, 1), BatchNorm(64)
        self.conv2, self.bn2 = _conv(64, 64, 3, 2, 1), BatchNorm(64)
        self.layer1 = _branch(Bottleneck, 64, 64, 4)
        prev = [256]
        for s, n_mod in zip((2, 3, 4), modules):
            cur = [width * 2 ** b for b in range(s)]
            trans = []
            for i, c in enumerate(cur):
                if i < len(prev):
                    trans.append(_conv_bn(prev[-1], c, 1, True) if c != prev[i] else None)
                else:
                    new = i - len(prev)
                    trans.append(nn.Sequential(*(
                        _conv_bn(prev[-1], c if k == new else prev[-1], 2, True)
                        for k in range(new + 1))))
            setattr(self, f"transition{s - 1}", nn.ModuleList(trans))
            setattr(self, f"stage{s}", nn.Sequential(*(
                HRModule(cur, num_blocks, multi_scale=not (s == 4 and m == n_mod - 1))
                for m in range(n_mod))))
            prev = cur
        self.final_layer = _conv(width, num_joints, 1, bias=True)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        ys = [self.layer1(x)]
        for s in (2, 3, 4):
            trans = getattr(self, f"transition{s - 1}")
            xs = [ys[i] if t is None else t(ys[-1]) for i, t in enumerate(trans)]
            ys = getattr(self, f"stage{s}")(xs)
        return self.final_layer(ys[0])


def build(cfg: dict) -> nn.Module:
    """The plain model of a configuration file's ``model`` entry."""
    kind = cfg["type"]
    if kind == "pose_resnet_dconv":
        layers = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                  "resnet152": (3, 8, 36, 3)}[cfg["name"]]
        return PoseResNet(layers, se=bool(cfg.get("reduction", False)),
                          num_joints=cfg.get("num_joints", 17))
    if kind == "pose_hrnet":
        return PoseHRNet({"w32": 32, "w48": 48}[cfg["name"]], cfg.get("num_joints", 17))
    raise KeyError(f"no plain model of type {kind!r}")
