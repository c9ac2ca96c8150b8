"""W8A8 post-training quantization for eval and serving (int8 convs).

Port of simple_pose_tpu/models/quant.py.  Every ``nn.Conv2d`` of a model
(exactly the modules that are ``type(m) is nn.Conv`` in the JAX package:
SE's 1x1 fcs and the detector's depthwise convs included, never a
``ConvTranspose2d`` nor K2's folded layer1) runs a quantized forward while
the stored float parameters stay untouched:

    s_w[o] = max(max|W[o]| / 127, 1e-8)    per output channel, over (I, H, W)
    W8     = round(W / s_w)                int8, half to even
    s_x    = max(max|x| / 127, 1e-8)       per tensor: dynamic, or a static
                                           scale from calibration
    x8     = clip(round(x / s_x), -127, 127)
    y      = conv(x8, W8) [int32] * (s_x * s_w)  (+ bias, f32)

then cast to the dtype the float conv would give (bf16 under the models'
autocast).  ``s_x`` and ``x8`` come from the tensor that reaches the conv,
in the dtype it arrives in; BatchNorm, activations, the deconv head and the
decoders stay in the surrounding float dtype.

The int32 product is ops/int8_conv.int8_conv, a registered op that picks
its exact route when it runs: the float64 plain version on CPU tensors,
int8 tensor cores (``torch._int_mm`` over the conv's patches) on CUDA
tensors, never the float conv.  The JAX package computes this product in
XLA, not in a Pallas kernel.

Scales are keyed by the JAX package's flax module paths
(convert/from_jax.conv_scale_keys), so a scales file written by either
package loads in the other.  Use through ``PoseEvaluator(quant='w8a8')``,
the detector and the fused program, or directly:

    with quantized(model, "w8a8", act_scales):
        y = model(x)
"""

from __future__ import annotations

import contextlib
import functools
import json

import torch
from torch import nn

from simple_pose_torch.convert.from_jax import conv_scale_keys
from simple_pose_torch.ops.int8_conv import int8_conv, int8_conv_reference

__all__ = ["QUANT_MODES", "quantize_weight", "quantize_input", "int8_conv",
           "int8_conv_reference", "w8a8_conv2d", "quantized", "W8A8", "ScaleRecorder",
           "calibrate_w8a8", "allreduce_scales_max", "save_scales", "load_scales",
           "quantized_convs"]

QUANT_MODES = (None, "w8a8")


def quantized_convs(model: nn.Module) -> dict:
    """{flax module path: module} of every conv the w8a8 mode quantizes."""
    convs = {n: m for n, m in model.named_modules() if type(m) is nn.Conv2d}
    keys = conv_scale_keys(model, list(convs))
    return {keys[n]: m for n, m in convs.items()}


def _div127(t):
    """t / 127 as a true f32 division (see :func:`quantize_input`)."""
    return t / torch.full((), 127.0, dtype=torch.float32, device=t.device)


def quantize_weight(w: torch.Tensor):
    """OIHW float weight -> (int8 OIHW, f32 per-output-channel scale [O])."""
    w = w.detach().float()
    s_w = torch.clamp_min(_div127(w.abs().amax(dim=(1, 2, 3))), 1e-8)
    return torch.round(w / s_w[:, None, None, None]).to(torch.int8), s_w


def quantize_input(x: torch.Tensor, s_x=None):
    """-> (int8 x8, f32 0-d s_x on x's device).  ``s_x`` None means the
    dynamic per-tensor scale; a static one is a float or a 0-d f32 tensor
    on x's device.  The division is a true f32 division by a device tensor,
    as in XLA (a CPU scalar divisor would run as a multiply by its
    reciprocal on CUDA)."""
    xf = x.float()
    if s_x is None:
        s_x = torch.clamp_min(_div127(xf.abs().amax()), 1e-8)
    elif not torch.is_tensor(s_x):
        s_x = torch.tensor(s_x, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8), s_x


def _out_dtype(x):
    """The dtype a float conv of ``x`` gives here (autocast's, where on)."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


def w8a8_conv2d(conv: nn.Conv2d, x, w8, s_w, s_x=None):
    """The quantized forward of ``conv`` on ``x`` with its int8 weight ``w8``
    and scale ``s_w`` (:func:`quantize_weight`); ``s_x`` a static scale or
    None (dynamic)."""
    if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
        raise ValueError(f"w8a8 supports explicit zero padding, got {conv.padding!r} "
                         f"{conv.padding_mode!r}")
    out_dtype = _out_dtype(x)
    x8, s_x = quantize_input(x, s_x)
    y = int8_conv(x8, w8, conv.stride, conv.padding, conv.dilation, conv.groups)
    out = y.float() * (s_x * s_w)[None, :, None, None]
    if conv.bias is not None:
        out = out + conv.bias.float()[None, :, None, None]
    return out.to(out_dtype)


class W8A8:
    """The w8a8 forward for every quantized conv of one model, entered as a
    context (:func:`quantized`).  Each conv's int8 weight is made once, here
    (so a model whose weights change needs a new one), and a traced program
    (evalkit/export.py) holds them as constants; a weight that is not the
    module's own parameter (``torch.func.functional_call``, the
    external-weights export) is quantized in the graph instead."""

    def __init__(self, model: nn.Module, act_scales=None):
        self.convs = quantized_convs(model)
        self.act_scales = dict(act_scales or {})
        with torch.no_grad():
            self._weights = {k: quantize_weight(conv.weight) for k, conv in self.convs.items()}
        # static scales as device tensors, made once: a float made into a
        # CUDA tensor at each call is a synchronous copy from the host
        self._static = {k: torch.tensor(float(self.act_scales[k]), dtype=torch.float32,
                                        device=conv.weight.device)
                        for k, conv in self.convs.items() if k in self.act_scales}

    def weight(self, key, conv):
        if isinstance(conv.weight, nn.Parameter):
            return self._weights[key]
        return quantize_weight(conv.weight)

    def _forward(self, key, conv, x):
        w8, s_w = self.weight(key, conv)
        s_x = self._static.get(key)
        if s_x is not None and s_x.device != x.device:
            s_x = s_x.to(x.device)
        return w8a8_conv2d(conv, x, w8, s_w, s_x)

    def __enter__(self):
        for key, conv in self.convs.items():
            conv.forward = functools.partial(self._forward, key, conv)
        return self

    def __exit__(self, *exc):
        for conv in self.convs.values():
            conv.__dict__.pop("forward", None)


def quantized(model: nn.Module, mode, act_scales=None):
    """Context in which ``model``'s convs run quantized: mode None is a no-op
    (so call sites pass the config value through); 'w8a8' as in the module
    docstring.  act_scales: {flax module path: s_x} from calibration; convs
    without an entry stay dynamic.  A caller that enters it often keeps one
    :class:`W8A8` instead (its int8 weights are cached)."""
    if mode is None:
        return contextlib.nullcontext()
    if mode == "w8a8":
        return W8A8(model, act_scales)
    raise ValueError(f"unknown quant mode {mode!r}; expected one of {QUANT_MODES}")


class ScaleRecorder:
    """Activation-max recorder for w8a8 calibration over float forwards.

    A context around forwards of one or more models (forward pre-hooks on
    their quantized convs); it records max|x| per flax module path into the
    same instance, so it can span several forwards (the flipped one, every
    calibration batch).  ``scales()`` gives the {path: s_x} dict
    :func:`quantized` consumes."""

    def __init__(self, *models: nn.Module):
        self.models = models
        self.maxes: dict = {}
        self._handles = []

    def _hook(self, key, _module, args):
        amax = float(args[0].detach().abs().amax())
        self.maxes[key] = max(self.maxes.get(key, 0.0), amax)

    def __enter__(self):
        for model in self.models:
            for key, conv in quantized_convs(model).items():
                self._handles.append(
                    conv.register_forward_pre_hook(functools.partial(self._hook, key)))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []

    def scales(self) -> dict:
        if not self.maxes:
            raise ValueError("ScaleRecorder saw no conv activations; was the "
                             "forward run inside the recorder context?")
        return {k: max(v / 127.0, 1e-8) for k, v in self.maxes.items()}


@torch.no_grad()
def calibrate_w8a8(model: nn.Module, apply_fn, inputs) -> dict:
    """Record per-conv activation scales: ``apply_fn(x)`` (a float forward
    of ``model``) for each x in ``inputs``.  Returns {path: s_x}."""
    rec = ScaleRecorder(model)
    with rec:
        for x in inputs:
            apply_fn(x)
    return rec.scales()


def allreduce_scales_max(scales: dict) -> dict:
    """Max-reduce calibrated scales across the processes of an initialised
    ``torch.distributed`` group, so every rank runs the same static
    program.  A no-op otherwise."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return scales
    keys = sorted(scales)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([scales[k] for k in keys], dtype=torch.float32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return {k: float(v) for k, v in zip(keys, t.cpu().tolist())}


def _floats(scales: dict) -> dict:
    return {k: _floats(v) if isinstance(v, dict) else float(v) for k, v in scales.items()}


def save_scales(scales: dict, path: str) -> None:
    """Write {flax module path: s_x} as JSON, the JAX package's format, or
    the fused program's per-net {"detector": {...}, "pose": {...}}."""
    with open(path, "w") as f:
        json.dump(_floats(scales), f, indent=1)


def load_scales(path: str) -> dict:
    """Read scales written by :func:`save_scales` (either package's, one
    net's or per net)."""
    with open(path) as f:
        return _floats(json.load(f))
