"""Serving export: the PoseEvaluator's device program, or the whole fused
detect -> pose program, as a ``torch.export`` artifact.

Port of simple_pose_tpu/evalkit/export.py (``export_evaluator``,
``export_fused``, ``save_exported``, ``load_exported``, ``serving_fn``).  ``torch.export``
traces the whole device step -- crop -> forward (quantized when the
evaluator is) -> optional flip-test -> decode -- to one ATen graph; a server
needs torch and the ``.pt2`` file, no model code, no checkpoint plumbing
(simple_pose_torch/serve_artifact.py is such a server).

* ``bake_weights=True`` (default) keeps the parameters, and the tensors the
  evaluator derived from them (the folded layer1, int8 weights), in the
  artifact.
* ``bake_weights=False`` makes the model's state dict, as a plain dict
  (``dict(model.state_dict())``), the leading input
  (``torch.func.functional_call``), so one program serves many checkpoints
  of one topology; refused for a ``fused_layer1`` evaluator, whose folded
  layer1 would ignore the swapped-in weights.

Exported signature (the evaluator's device contract):

    (canvas u8[B,H,W,3], trans f32[B,2,3], trans_inv f32[B,2,3]) -> dict

with the outputs of ``PoseEvaluator.__call__`` (``kps``, ``conf``,
``scores``), or ``{"heat"}`` for ``decoder='dark_original'``, whose decode
runs on the host (ops/decode.decode_dark_original).

With ``fused_layer1`` the graph holds K2 as the registered op
``simple_pose::bottleneck_chain``, and a quantized evaluator's graph holds
each conv's int32 product as ``simple_pose::int8_conv``: import
simple_pose_torch.ops.bottleneck_chain and simple_pose_torch.ops.int8_conv
before loading (the ``eval export`` sidecar lists them under "custom_ops").
Both ops pick their route when they run, from their inputs' device (the
kernel or the int8 tensor cores on the card, the plain version on the CPU),
so the device the program was traced on does not fix it.

``export_fused(fused, batch_size, canvas)`` exports a FusedDetectPose's
program (evalkit/fused.FusedProgram: letterbox -> detector -> NMS -> crops
-> pose -> decode) with both networks' weights baked in, quantized where
the program is:

    (canvases u8[B,canvas,canvas,3], lb_trans f32[B,2,3],
     lb_region f32[B,4], lb_inv_scale f32[B], lb_offset f32[B,2]) -> dict

with the live keys ``boxes``, ``det_scores``, ``det_valid``, ``kps``,
``kp_conf`` and ``pose_scores``.  The caller supplies the letterbox
geometry from ``FusedDetectPose.host_prep(shapes)`` (numpy; a server may
copy its ~15 lines), as it owns the image decode.  The program runs at
``det_size``; a rect bucket is another static shape, and so another
artifact.  The NMS's data-dependent round count is a ``while_loop`` node
(detector/nms.py), so the program reads nothing back to the host.

JAX's ``platforms=`` (lowering for several backends) has no ``torch.export``
counterpart: the program is traced on the evaluator's device, and
``load_exported(..., device=)`` moves a loaded program to another one
(``torch.export.passes.move_to_device_pass``).
"""

from __future__ import annotations

import io
import os

import torch

__all__ = ["export_evaluator", "export_fused", "save_exported", "load_exported", "serving_fn"]


class _ServingStep(torch.nn.Module):
    """The evaluator's step as a module: its model is a submodule, so its
    parameters and buffers become the program's (baked weights)."""

    def __init__(self, evaluator):
        super().__init__()
        self.model = evaluator.model
        self._step = evaluator.step

    def forward(self, canvas, trans, trans_inv):
        return self._step(canvas, trans, trans_inv)


class _ExternalWeightsStep(torch.nn.Module):
    """The step with the model's state dict as the leading input."""

    def __init__(self, evaluator):
        super().__init__()
        self._step = evaluator.step

    def forward(self, params, canvas, trans, trans_inv):
        return self._step(canvas, trans, trans_inv, params=params)


def export_evaluator(evaluator, batch_size, canvas_hw, *, bake_weights: bool = True):
    """``torch.export.export`` of a PoseEvaluator's device step.

    :param batch_size: the static crop batch of the program, or a name
        (a Python identifier, e.g. ``"b"``) for a ``torch.export.Dim`` batch
        that serves every size from one file
    :param canvas_hw: static (height, width) of the input canvases
    :param bake_weights: keep the weights in the program (default) or take
        the model's state dict as the leading input
    :returns: a ``torch.export.ExportedProgram``"""
    if evaluator._layer1_folded is not None and not bake_weights:
        raise ValueError(
            "fused_layer1 folds weights at evaluator build time, so an "
            "external-weights export would silently ignore swapped-in layer1 "
            "weights; use bake_weights=True or fused_layer1=False")
    if isinstance(batch_size, str):
        if not batch_size.isidentifier():
            raise ValueError(f"a symbolic batch is a Python identifier, got {batch_size!r}")
        dim, b = torch.export.Dim(batch_size), 2
    else:
        dim, b = None, int(batch_size)
    h, w = canvas_hw
    dev = evaluator.device
    canvas = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=dev)
    trans = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=dev).expand(b, 2, 3)
    batch_args = (canvas, trans.contiguous(), trans.contiguous())
    batch_dims = tuple({0: dim} for _ in batch_args) if dim is not None else None
    if bake_weights:
        module, args, dims = _ServingStep(evaluator), batch_args, batch_dims
    else:
        params = dict(evaluator.model.state_dict())
        module, args = _ExternalWeightsStep(evaluator), (params,) + batch_args
        dims = None if batch_dims is None else (None,) + batch_dims
    return torch.export.export(module, args, dynamic_shapes=dims)


def export_fused(fused, batch_size: int, canvas: int):
    """``torch.export.export`` of a FusedDetectPose's program at its
    ``det_size`` (the module docstring has the signature).

    :param batch_size: the static image batch
    :param canvas: the static canvas edge
    :returns: a ``torch.export.ExportedProgram``"""
    b, dev = int(batch_size), fused.device
    tw, th = fused.det_size
    canvases = torch.zeros((b, canvas, canvas, 3), dtype=torch.uint8, device=dev)
    lb_trans, lb_region, lb_inv_scale, lb_offset = (
        torch.from_numpy(a).to(dev) for a in fused.host_prep([(th, tw)] * b))
    exported = torch.export.export(fused.program,
                                   (canvases, lb_trans, lb_region, lb_inv_scale, lb_offset))
    # the traced program keeps each autocast region as a node that enters
    # autocast again when it runs, under dtypes recorded before autocast
    # chose them (YOLOv5's nearest upsample runs in f32 under CUDA
    # autocast, so the bf16 its trace recorded fails the graph's own dtype
    # check before a quantized conv); retracing applies autocast once
    exported = exported.run_decompositions({})
    # the retraced graph has no grad mode of its own: parameters that need no
    # gradient keep a serving call from building an autograd graph
    for name, p in exported.state_dict.items():
        if isinstance(p, torch.nn.Parameter):
            exported.state_dict[name] = torch.nn.Parameter(p.detach(), requires_grad=False)
    return exported


def save_exported(exported, path: str) -> int:
    """Write an ExportedProgram to ``path``; returns the byte count."""
    torch.export.save(exported, path)
    return os.path.getsize(path)


def load_exported(path_or_bytes, device=None):
    """An ExportedProgram from a file path or raw bytes, moved to
    ``device`` where given (the counterpart of JAX's ``platforms``)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(bytes(path_or_bytes))
    else:
        path_or_bytes = os.fspath(path_or_bytes)
    exported = torch.export.load(path_or_bytes)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, torch.device(device))
    return exported


def serving_fn(path_or_bytes, device=None):
    """Load an artifact and return its callable: ``(canvas, trans,
    trans_inv)``, after the state dict for an external-weights artifact,
    -> the evaluator's output dict; for an ``export_fused`` artifact,
    ``(canvases, *fused.host_prep(shapes))`` -> the fused program's dict."""
    return load_exported(path_or_bytes, device).module()
