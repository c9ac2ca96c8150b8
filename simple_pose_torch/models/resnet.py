"""Pose ResNet with the SimpleBaselines deconv head or the DUC head (NCHW
nn.Module).

Port of simple_pose_tpu/models/resnet.py: a torchvision-style ResNet trunk
(BasicBlock/Bottleneck, groups/width, optional SE), then a head:

  * 'dconv': 3 x [ConvTranspose k4 s2 -> BN -> ReLU] to 256 channels, then a
    1x1 conv to num_joints (pose_resnet_dconv.py:230-249, 173-178);
  * 'duc': PixelShuffle(2), DUC(1024), DUC(512) (each a 3x3 conv, BN, ReLU
    and PixelShuffle(2)), then a 3x3 conv to num_joints (the JAX
    resnet.py:182-188).

Module paths are the reference's state_dict keys (``layer1.0.conv1``,
``layer1.0.downsample.0``, ``layer1.0.se.fc.0``, ``deconv_layers.N``,
``duc_layers.{1,2}.{conv,bn}``, ``final_layer``), so a reference checkpoint
loads with ``load_state_dict``.

Parity quirk preserved: SE goes only into a stage's first block, and only
when that block carries a downsample projection (pose_resnet_dconv.py:
212-221).

``dtype`` is the compute dtype, as in the flax model: parameters stay f32
and, when it is set, the forward runs under autocast to it.  Input NCHW
[B, 3, 256, 192]; output heatmaps [B, J, 64, 48].

``remat`` rematerializes each residual block in training (the JAX package's
``nn.remat``, models/resnet.py:120,138-139): torch.utils.checkpoint keeps
only the block's input and recomputes its activations in backward.  flax's
batch_stats update is functional, so its recompute moves nothing; here the
recompute runs BatchNorm's forward a second time, and it would move the
running statistics twice.  The recompute therefore runs with the block's
BatchNorm updates off (``_stats_frozen``).  :func:`checkpointed` is that
rule for any chain of blocks; models/hrnet.py uses it too.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from simple_pose_torch.models.layers import (
    DUC,
    BatchNorm2d,
    SELayer,
    batch_norm,
    conv,
    conv1x1,
    conv3x3,
    init_weights,
)
from simple_pose_torch.ops.bottleneck_chain import bottleneck_chain

__all__ = ["PoseResNet", "BasicBlock", "Bottleneck", "RESNET_SPECS", "build_resnet",
           "checkpointed"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, use_downsample=False, se=False):
        super().__init__()
        self.conv1 = conv3x3(inplanes, planes, stride)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = batch_norm(planes)
        self.relu = nn.ReLU(inplace=True)
        self.se = SELayer(planes) if se else None
        self.downsample = nn.Sequential(conv1x1(inplanes, planes, stride),
                                        batch_norm(planes)) if use_downsample else None

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.se is not None:
            out = self.se(out)
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, use_downsample=False, se=False,
                 groups=1, base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * self.expansion
        self.conv1 = conv1x1(inplanes, width)
        self.bn1 = batch_norm(width)
        self.conv2 = conv3x3(width, width, stride, groups=groups)
        self.bn2 = batch_norm(width)
        self.conv3 = conv1x1(width, out_ch)
        self.bn3 = batch_norm(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.se = SELayer(out_ch) if se else None
        self.downsample = nn.Sequential(conv1x1(inplanes, out_ch, stride),
                                        batch_norm(out_ch)) if use_downsample else None

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.se is not None:
            out = self.se(out)
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class PoseResNet(nn.Module):
    """:param block: 'basic' | 'bottleneck'
    :param layers: blocks per stage, e.g. (3, 4, 6, 3) for resnet50
    :param head: 'dconv' | 'duc'
    :param se: SE attention in stage-leading blocks (the reference
        ``reduction`` flag)
    :param dtype: compute dtype (None = f32, or torch.bfloat16)
    :param remat: recompute each residual block's activations in backward
        (training only)"""

    def __init__(self, block: str = "bottleneck", layers: Sequence[int] = (3, 4, 6, 3),
                 head: str = "dconv", num_joints: int = 17, groups: int = 1,
                 width_per_group: int = 64, se: bool = False,
                 dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        if head not in ("dconv", "duc"):
            raise ValueError(f"unknown head {head!r}")
        self.head = head
        self.block = block
        self.layers = tuple(layers)
        self.groups = groups
        self.dtype = dtype
        self.remat = remat
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.conv1 = conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
        inplanes = 64
        for stage_idx, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), self.layers, (1, 2, 2, 2)), start=1):
            stage = []
            for i in range(blocks):
                s = stride if i == 0 else 1
                use_ds = i == 0 and (s != 1 or inplanes != planes * block_cls.expansion)
                kwargs = dict(stride=s, use_downsample=use_ds, se=se and use_ds)
                if block_cls is Bottleneck:
                    kwargs.update(groups=groups, base_width=width_per_group)
                stage.append(block_cls(inplanes, planes, **kwargs))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{stage_idx}", nn.Sequential(*stage))
        if head == "dconv":
            deconv = []
            for _ in range(3):
                deconv += [nn.ConvTranspose2d(inplanes, 256, 4, stride=2, padding=1, bias=False),
                           batch_norm(256), nn.ReLU(inplace=True)]
                inplanes = 256
            self.deconv_layers = nn.Sequential(*deconv)
            self.final_layer = conv(256, num_joints, 1, bias=True)
        else:
            # duc_layers.0 is the parameterless PixelShuffle (torch2flax.py:74-77)
            self.duc_layers = nn.Sequential(nn.PixelShuffle(2), DUC(inplanes // 4, 1024),
                                            DUC(1024 // 4, 512))
            self.final_layer = conv(512 // 4, num_joints, 3, padding=1, bias=True)

    def layer1_block_names(self):
        """Module paths of layer1's blocks for ops/bottleneck_chain's fold;
        None when this trunk does not qualify (BasicBlock math differs;
        grouped convs do not fold to dense matmuls)."""
        if self.block != "bottleneck" or self.groups != 1:
            return None
        return [f"layer1.{i}" for i in range(len(self.layer1))]

    def forward(self, x, layer1_folded=None):
        """layer1_folded: pre-folded layer1 Bottleneck-chain weights
        (ops/bottleneck_chain.fold_bottleneck_blocks) -- the fused eval path;
        layer1's modules are then unused."""
        amp = (torch.autocast(device_type=x.device.type, dtype=self.dtype)
               if self.dtype is not None else contextlib.nullcontext())
        with amp:
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            if layer1_folded is not None:
                x = bottleneck_chain(x.contiguous(), layer1_folded,
                                     compute_dtype=self.dtype or torch.float32)
            else:
                x = self._stage(self.layer1, x)
            for stage in (self.layer2, self.layer3, self.layer4):
                x = self._stage(stage, x)
            head = self.deconv_layers if self.head == "dconv" else self.duc_layers
            return self.final_layer(head(x))

    def _stage(self, stage, x):
        return checkpointed(stage, x) if self.remat and self.training else stage(x)


def checkpointed(blocks, x):
    """``blocks`` (an iterable of modules) applied in turn, each one
    rematerialized in backward when gradients are on, with its BatchNorm
    updates off in the recompute."""
    if not torch.is_grad_enabled():
        for block in blocks:
            x = block(x)
        return x
    for block in blocks:
        # The non-reentrant checkpoint recomputes under the autocast
        # state of the forward (it records and re-enters it), so the
        # recompute runs in the same dtypes.  Blocks draw no random
        # numbers, so no RNG state is kept.
        x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False,
                       context_fn=functools.partial(_recompute_contexts, block))
    return x


@contextlib.contextmanager
def _stats_frozen(module):
    """The BatchNorm layers of ``module`` leave their running statistics
    alone while inside."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def _recompute_contexts(block):
    """checkpoint's context_fn: (forward context, recompute context)."""
    return contextlib.nullcontext(), _stats_frozen(block)


# name -> (block, layers, extra kwargs); mirrors the reference factories
# (pose_resnet_dconv.py:282-403)
RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2), {}),
    "resnet34": ("basic", (3, 4, 6, 3), {}),
    "resnet50": ("bottleneck", (3, 4, 6, 3), {}),
    "resnet101": ("bottleneck", (3, 4, 23, 3), {}),
    "resnet152": ("bottleneck", (3, 8, 36, 3), {}),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), {"groups": 32, "width_per_group": 4}),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3), {"groups": 32, "width_per_group": 8}),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6, 3), {"width_per_group": 128}),
    "wide_resnet101_2": ("bottleneck", (3, 4, 23, 3), {"width_per_group": 128}),
}


def build_resnet(name: str, num_joints: int = 17, se: bool = False, dtype=None,
                 seed: int = 0, remat: bool = False, head: str = "dconv") -> PoseResNet:
    """A PoseResNet with weights drawn from ``torch.Generator().manual_seed(seed)``
    (on the CPU; move it to a device afterwards)."""
    block, layers, extra = RESNET_SPECS[name]
    model = PoseResNet(block=block, layers=layers, head=head, num_joints=num_joints, se=se,
                       dtype=dtype, remat=remat, **extra)
    init_weights(model, torch.Generator().manual_seed(seed), head_modules=[model.final_layer])
    return model.eval()
