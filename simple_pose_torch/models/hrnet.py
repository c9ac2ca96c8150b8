"""Pose HRNet (W32/W48): multi-resolution branches with all-to-all fusion
(NCHW nn.Module).

Port of simple_pose_tpu/models/hrnet.py, driven by the same topology schema
(the reference's nets/hrnet_w32.yaml / hrnet_w48.yaml ``MODEL.EXTRA``): a
stem of two stride-2 3x3 convs, a Bottleneck layer1, then stages 2-4 of
high-resolution modules.  Fusion for target branch i and source j:
j > i is a 1x1 conv + BN + nearest 2^(j-i) upsample, j < i chains (i - j)
stride-2 3x3 conv + BN (ReLU on all but the last), j == i is the identity;
the fused maps are summed, then ReLU'd.  The final conv reads the
highest-resolution branch only (the last module of the last stage keeps one
output).

Module paths are the reference's state_dict keys (pose_hrnet.py), the ones
the JAX package's converter reads (convert/torch2flax.py::_hrnet_module):
``conv1``, ``bn1``, ``conv2``, ``bn2``, ``layer1.{i}``,
``transition{t}.{i}.{0,1}`` (a retargeted branch) and
``transition{t}.{i}.{j}.{0,1}`` (a new branch's stride-2 chain),
``stage{s}.{m}.branches.{b}.{k}``, ``stage{s}.{m}.fuse_layers.{i}.{j}.{0,1}``
for j > i and ``...{i}.{j}.{k}.{0,1}`` for j < i, ``final_layer``.

Parity points kept from the JAX model:
  * a transition reads the previous stage's LAST branch whenever it exists
    (pose_hrnet.py:430-447);
  * only the last module of the last stage in the config keeps one output;
  * ``LAYER1_NUM_BLOCKS`` (default 4) and ``FINAL_CONV_KERNEL`` are read;
  * nearest upsampling is exact (``nn.Upsample(mode='nearest')`` by an
    integer factor), so the sum order is the only difference from the JAX
    model's coarse-to-fine accumulation.

``dtype`` is the compute dtype: parameters stay f32 and, when it is set, the
forward runs under autocast to it.  ``remat`` rematerializes each residual
block of layer1 and of the branches in training (the JAX ``nn.remat`` on the
block class), with models/resnet.checkpointed.
"""

from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, Optional

import torch
from torch import nn

from simple_pose_torch.models.layers import batch_norm, conv, conv1x1, conv3x3, init_weights
from simple_pose_torch.models.resnet import BasicBlock, Bottleneck, checkpointed
from simple_pose_torch.ops.bottleneck_chain import bottleneck_chain

__all__ = ["PoseHRNet", "build_hrnet", "HRNET_W32_CFG", "HRNET_W48_CFG"]


def _hrnet_cfg(width: int) -> Dict[str, Any]:
    """Topology equivalent to nets/hrnet_w{32,48}.yaml."""
    c = width
    return {
        "FINAL_CONV_KERNEL": 1,
        "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC",
                   "NUM_BLOCKS": [4, 4], "NUM_CHANNELS": [c, 2 * c], "FUSE_METHOD": "SUM"},
        "STAGE3": {"NUM_MODULES": 4, "NUM_BRANCHES": 3, "BLOCK": "BASIC",
                   "NUM_BLOCKS": [4, 4, 4], "NUM_CHANNELS": [c, 2 * c, 4 * c], "FUSE_METHOD": "SUM"},
        "STAGE4": {"NUM_MODULES": 3, "NUM_BRANCHES": 4, "BLOCK": "BASIC",
                   "NUM_BLOCKS": [4, 4, 4, 4], "NUM_CHANNELS": [c, 2 * c, 4 * c, 8 * c],
                   "FUSE_METHOD": "SUM"},
    }


HRNET_W32_CFG = _hrnet_cfg(32)
HRNET_W48_CFG = _hrnet_cfg(48)

_BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _conv_bn(cin, cout, stride, relu):
    layers = [conv3x3(cin, cout, stride), batch_norm(cout)]
    return nn.Sequential(*layers, nn.ReLU(inplace=True)) if relu else nn.Sequential(*layers)


def _blocks(block_cls, inplanes, planes, num_blocks):
    """A branch: ``num_blocks`` blocks, a projection in the first when the
    channels change (pose_hrnet.py:141-172)."""
    out = []
    for _ in range(num_blocks):
        out.append(block_cls(inplanes, planes,
                             use_downsample=inplanes != planes * block_cls.expansion))
        inplanes = planes * block_cls.expansion
    return nn.Sequential(*out)


class HighResolutionModule(nn.Module):
    """Parallel branches, then all-to-all fusion (pose_hrnet.py:181-259).

    :param channels: each branch's block output channels (``NUM_CHANNELS``
        times the block's expansion), which are also its input channels
    :param multi_scale: keep every branch's fused output (False: the
        highest-resolution one only)
    :param remat: checkpoint each block of the branches in training"""

    def __init__(self, block_cls, num_blocks, planes, channels, multi_scale: bool,
                 remat: bool = False):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            _blocks(block_cls, channels[b], planes[b], num_blocks[b]) for b in range(n))
        fuse = []
        for i in range(n if multi_scale else 1):
            row = []
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(
                        conv1x1(channels[j], channels[i]), batch_norm(channels[i]),
                        nn.Upsample(scale_factor=2 ** (j - i), mode="nearest")))
                elif j < i:
                    row.append(nn.Sequential(*(
                        _conv_bn(channels[j], channels[i] if k == i - j - 1 else channels[j], 2,
                                 relu=k != i - j - 1)
                        for k in range(i - j))))
                else:
                    row.append(None)
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)
        self.relu = nn.ReLU()
        self.remat = remat

    def forward(self, xs):
        run = checkpointed if self.remat and self.training else (lambda seq, x: seq(x))
        xs = [run(branch, x) for branch, x in zip(self.branches, xs)]
        outs = []
        for row in self.fuse_layers:
            y = None
            for j, layer in enumerate(row):
                t = xs[j] if layer is None else layer(xs[j])
                y = t if y is None else y + t
            outs.append(self.relu(y))
        return outs


class PoseHRNet(nn.Module):
    """:param cfg: topology dict (the ``EXTRA`` schema); None means W32
    :param dtype: compute dtype (None = f32, or torch.bfloat16)
    :param remat: recompute each residual block's activations in backward
        (training only)"""

    def __init__(self, cfg: Optional[Dict[str, Any]] = None, num_joints: int = 17,
                 dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        cfg = cfg if cfg is not None else HRNET_W32_CFG
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.conv1 = conv(3, 64, 3, stride=2, padding=1)
        self.bn1 = batch_norm(64)
        self.conv2 = conv(64, 64, 3, stride=2, padding=1)
        self.bn2 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        self.layer1 = _blocks(Bottleneck, 64, 64, cfg.get("LAYER1_NUM_BLOCKS", 4))

        prev = [64 * Bottleneck.expansion]
        self.stages = [s for s in (2, 3, 4) if f"STAGE{s}" in cfg]
        for s in self.stages:
            scfg = cfg[f"STAGE{s}"]
            block_cls = _BLOCKS[scfg["BLOCK"]]
            cur = [c * block_cls.expansion for c in scfg["NUM_CHANNELS"]]
            setattr(self, f"transition{s - 1}", self._transition(prev, cur))
            modules = []
            for m in range(scfg["NUM_MODULES"]):
                multi_scale = not (s == self.stages[-1] and m == scfg["NUM_MODULES"] - 1)
                modules.append(HighResolutionModule(block_cls, scfg["NUM_BLOCKS"],
                                                    scfg["NUM_CHANNELS"], cur, multi_scale,
                                                    remat))
            setattr(self, f"stage{s}", nn.Sequential(*modules))
            prev = cur
        k = cfg.get("FINAL_CONV_KERNEL", 1)
        self.final_layer = conv(prev[0], num_joints, k, padding=1 if k == 3 else 0, bias=True)

    @staticmethod
    def _transition(prev, cur):
        """Retarget or grow the branches (pose_hrnet.py:327-366).  Both kinds
        read the previous stage's last branch, whose channels are prev[-1]."""
        layers = []
        for i in range(len(cur)):
            if i < len(prev):
                layers.append(_conv_bn(prev[-1], cur[i], 1, relu=True)
                              if cur[i] != prev[i] else None)
            else:
                new = i - len(prev)
                layers.append(nn.Sequential(*(
                    _conv_bn(prev[-1], cur[i] if j == new else prev[-1], 2, relu=True)
                    for j in range(new + 1))))
        return nn.ModuleList(layers)

    def layer1_block_names(self):
        """Module paths of layer1's blocks for ops/bottleneck_chain's fold:
        HRNet's layer1 is always a stride-1 Bottleneck chain."""
        return [f"layer1.{i}" for i in range(len(self.layer1))]

    def forward(self, x, layer1_folded=None):
        """layer1_folded: pre-folded layer1 Bottleneck-chain weights
        (ops/bottleneck_chain.fold_bottleneck_blocks) -- the fused eval path;
        layer1's modules are then unused."""
        amp = (torch.autocast(device_type=x.device.type, dtype=self.dtype)
               if self.dtype is not None else contextlib.nullcontext())
        with amp:
            x = self.relu(self.bn1(self.conv1(x)))
            x = self.relu(self.bn2(self.conv2(x)))
            if layer1_folded is not None:
                x = bottleneck_chain(x.contiguous(), layer1_folded,
                                     compute_dtype=self.dtype or torch.float32)
            elif self.remat and self.training:
                x = checkpointed(self.layer1, x)
            else:
                x = self.layer1(x)
            ys = [x]
            for s in self.stages:
                transition = getattr(self, f"transition{s - 1}")
                xs = [ys[i] if layer is None else layer(ys[-1])
                      for i, layer in enumerate(transition)]
                ys = getattr(self, f"stage{s}")(xs)
            return self.final_layer(ys[0])


def build_hrnet(cfg="w32", num_joints: int = 17, dtype=None, seed: int = 0,
                remat: bool = False) -> PoseHRNet:
    """A PoseHRNet with weights drawn from ``torch.Generator().manual_seed(seed)``
    (on the CPU; move it to a device afterwards).

    :param cfg: 'w32' | 'w48' | a dict (the ``EXTRA`` schema) | a path to a
        config with ``MODEL.EXTRA`` (the reference's nets/hrnet_w32.yaml
        layout): a ``.json`` path reads with json, any other with PyYAML"""
    if cfg == "w32":
        cfg = HRNET_W32_CFG
    elif cfg == "w48":
        cfg = HRNET_W48_CFG
    elif isinstance(cfg, str):
        with open(cfg) as rf:
            if cfg.endswith(".json"):
                raw = json.load(rf)
            else:
                import yaml

                raw = yaml.safe_load(rf)
        cfg = raw["MODEL"]["EXTRA"] if "MODEL" in raw else raw
    model = PoseHRNet(cfg=cfg, num_joints=num_joints, dtype=dtype, remat=remat)
    init_weights(model, torch.Generator().manual_seed(seed), head_modules=[model.final_layer])
    return model.eval()
