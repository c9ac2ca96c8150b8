"""JAX-package variables -> torch state_dict (the inverse of
simple_pose_tpu/convert/torch2flax.py for the ResNet and HRNet families),
and a JAX TrainState -> the port's TrainState (``load_jax_train_state``).

``flax_to_torch_state`` turns a numpy pytree ``{'params': ...,
'batch_stats': ...}`` of a flax PoseResNet (dconv or DUC head) or PoseHRNet
into a state_dict under the reference's key names (torch2flax.py:45-117),
so the same weights run in both packages:

  * conv kernel          HWIO -> OIHW   (transpose 3, 2, 0, 1)
  * conv-transpose       HWIO' -> IOHW  (transpose 2, 3, 0, 1)
  * batchnorm            scale/bias -> weight/bias, mean/var ->
                         running_mean/running_var, plus num_batches_tracked 0
  * ResNet names         layer{s}_{i} -> layer{s}.{i}, deconv_{i} ->
                         deconv_layers.{3i}, deconv_bn_{i} ->
                         deconv_layers.{3i+1}, duc_{i}/{conv,bn} ->
                         duc_layers.{i}.{conv,bn}
  * HRNet names          layer1_m0_b0_{i} -> layer1.{i},
                         stage{s}_m{m}_b{b}_{i} -> stage{s}.{m}.branches.{b}.{i},
                         transition{t}_{i}[_{j}][_bn] ->
                         transition{t}.{i}[.{j}].{0|1},
                         stage{s}_m{m}_fuse_{i}_{j}[_{k}][_bn] ->
                         stage{s}.{m}.fuse_layers.{i}.{j}[.{k}].{0|1}
  * inside a block       downsample_conv/_bn -> downsample.0/.1,
                         se/fc1|fc2 -> se.fc.0|.2

The two families' flax names are disjoint apart from ``conv1``, ``bn1`` and
``final_layer``, which map alike, so no family argument is needed.

``detector_flax_to_torch_state`` does the same for the YOLOv5/YOLOv4
detectors, the inverse of the JAX generic converter
(torch2flax.py:218-271): the flax scopes there are the torch module paths
with each Sequential or ModuleList index folded into its parent's name
(``layer1.0`` -> ``layer1_0``, ``conv1_s.0`` -> ``conv1_s_0``,
``heads.0`` -> ``heads_0``).  That fold cannot be undone from a name alone
(``conv1_0`` is an attribute of BottleNeckCSP but ``conv1.0`` of
BottleNeckCSP2), so the torch model's own keys are folded the same way and
looked up.

``conv_scale_keys`` names each quantized conv of a port model by its flax
module path, the key of a W8A8 scales file (models/quant.py): the inverse
of ``_module_key`` for the pose families (checked against it), the
detector fold for YOLOv5/YOLOv4.
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["flax_to_torch_state", "detector_flax_to_torch_state", "load_jax_train_state",
           "conv_scale_keys"]

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_FLAX_BN_LEAF = {v: k for k, v in _BN_LEAF.items()}

# flax residual-block name -> torch module path of the block
_BLOCK_NAMES = (
    (re.compile(r"layer1_m0_b0_(\d+)"), "layer1.{0}"),
    (re.compile(r"stage(\d+)_m(\d+)_b(\d+)_(\d+)"), "stage{0}.{1}.branches.{2}.{3}"),
    (re.compile(r"layer(\d+)_(\d+)"), "layer{0}.{1}"),
)
# flax conv or BN name -> torch Sequential path; the ``_bn`` suffix is index 1
_SEQ_NAMES = (
    (re.compile(r"transition(\d+)_(\d+)(?:_(\d+))?"), "transition{0}.{1}"),
    (re.compile(r"stage(\d+)_m(\d+)_fuse_(\d+)_(\d+)(?:_(\d+))?"),
     "stage{0}.{1}.fuse_layers.{2}.{3}"),
)


def _block_sub(blk, path):
    """A module inside a residual block -> (torch path, kind)."""
    sub = path[1]
    if sub in ("conv1", "conv2", "conv3"):
        return f"{blk}.{sub}", "conv"
    if sub in ("bn1", "bn2", "bn3"):
        return f"{blk}.{sub}", "bn"
    if sub == "downsample_conv":
        return f"{blk}.downsample.0", "conv"
    if sub == "downsample_bn":
        return f"{blk}.downsample.1", "bn"
    if sub == "se":
        return f"{blk}.se.fc.{0 if path[2] == 'fc1' else 2}", "conv"
    raise KeyError(f"no torch counterpart for flax module {'/'.join(path)}")


def _module_key(path) -> tuple:
    """flax module path -> (torch module path, kind in conv|deconv|bn)."""
    head = path[0]
    for pattern, fmt in _BLOCK_NAMES:
        m = pattern.fullmatch(head)
        if m:
            return _block_sub(fmt.format(*m.groups()), path)
    bn = head.endswith("_bn")
    base = head[:-3] if bn else head
    for pattern, fmt in _SEQ_NAMES:
        m = pattern.fullmatch(base)
        if m:
            chain = m.groups()[-1]
            seq = fmt.format(*m.groups()) + ("" if chain is None else f".{chain}")
            return f"{seq}.{1 if bn else 0}", "bn" if bn else "conv"
    if head in ("conv1", "conv2", "final_layer"):
        return head, "conv"
    if head in ("bn1", "bn2"):
        return head, "bn"
    m = re.fullmatch(r"deconv_(bn_)?(\d+)", head)
    if m:
        idx = 3 * int(m.group(2)) + (1 if m.group(1) else 0)
        return f"deconv_layers.{idx}", "bn" if m.group(1) else "deconv"
    m = re.fullmatch(r"duc_(\d+)", head)
    if m and path[1] in ("conv", "bn"):
        return f"duc_layers.{m.group(1)}.{path[1]}", path[1]
    raise KeyError(f"no torch counterpart for flax module {'/'.join(path)}")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_torch_state(variables) -> dict:
    """:param variables: flax PoseResNet or PoseHRNet variables (numpy or jax
        arrays)
    :returns: {reference key: torch f32 tensor}"""
    state = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(coll, {})):
            module, kind = _module_key(path[:-1])
            leaf = path[-1]
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
            if kind == "bn":
                state[f"{module}.{_BN_LEAF[leaf]}"] = t
                state.setdefault(f"{module}.num_batches_tracked",
                                 torch.zeros((), dtype=torch.long))
            elif leaf == "kernel":
                perm = (2, 3, 0, 1) if kind == "deconv" else (3, 2, 0, 1)
                state[f"{module}.weight"] = t.permute(*perm).contiguous()
            else:
                state[f"{module}.bias"] = t
    return state


def _fold_digits(parts):
    """['backbones', 'layer1', '0', 'conv'] -> ['backbones', 'layer1_0',
    'conv'] (the JAX converter's _merge_digit_components)."""
    out = []
    for p in parts:
        if p.isdigit() and out:
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return out


def detector_flax_to_torch_state(variables, model: torch.nn.Module) -> dict:
    """:param variables: flax YOLOv5 or YOLOv4 variables (numpy or jax arrays)
    :param model: the port's detector of the same configuration, whose
        state_dict keys name the result
    :returns: {reference key: torch f32 tensor}
    :raises KeyError: where a key of ``model`` has no flax leaf, or a flax
        leaf no key"""
    flat = {(coll,) + path: arr for coll in ("params", "batch_stats")
            for path, arr in _leaves(variables.get(coll, {}))}
    keys = list(model.state_dict())
    bn = {k.rsplit(".", 1)[0] for k in keys if k.endswith("running_mean")}
    state, used = {}, set()
    for key in keys:
        prefix, leaf = key.rsplit(".", 1)
        path = tuple(_fold_digits(prefix.split(".")))
        if prefix in bn:
            if leaf == "num_batches_tracked":
                state[key] = torch.zeros((), dtype=torch.long)
                continue
            name = _FLAX_BN_LEAF[leaf]
            coll = "params" if leaf in ("weight", "bias") else "batch_stats"
        else:
            coll, name = "params", "kernel" if leaf == "weight" else "bias"
        src = (coll,) + path + (name,)
        if src not in flat:
            raise KeyError(f"no flax leaf {'/'.join(src)} for {key}")
        used.add(src)
        t = torch.from_numpy(np.array(flat[src], dtype=np.float32))
        state[key] = t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t
    left = set(flat) - used
    if left:
        raise KeyError(f"flax leaves with no torch key: {sorted('/'.join(p) for p in left)[:4]}")
    return state


# torch module path of a pose conv -> its flax module path (the inverse of
# _module_key, for conv modules only)
_TORCH_CONV_NAMES = (
    (re.compile(r"layer1\.(\d+)\.(.+)"), "layer1_m0_b0_{0}", True),  # HRNet's layer1
    (re.compile(r"stage(\d+)\.(\d+)\.branches\.(\d+)\.(\d+)\.(.+)"),
     "stage{0}_m{1}_b{2}_{3}", None),
    (re.compile(r"layer(\d+)\.(\d+)\.(.+)"), "layer{0}_{1}", False),
)
_TORCH_BLOCK_CONVS = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
                      "downsample.0": "downsample_conv", "se.fc.0": "se/fc1",
                      "se.fc.2": "se/fc2"}


def _pose_conv_path(name: str, hrnet: bool) -> str:
    for pattern, fmt, family in _TORCH_CONV_NAMES:
        m = pattern.fullmatch(name)
        if m and family in (None, hrnet):
            *idx, sub = m.groups()
            return f"{fmt.format(*idx)}/{_TORCH_BLOCK_CONVS[sub]}"
    m = re.fullmatch(r"transition(\d+)\.(\d+)\.(?:(\d+)\.)?0", name)
    if m:
        return "_".join(["transition" + m.group(1)] + [g for g in m.groups()[1:] if g])
    m = re.fullmatch(r"stage(\d+)\.(\d+)\.fuse_layers\.(\d+)\.(\d+)\.(?:(\d+)\.)?0", name)
    if m:
        s, mod, i, j, k = m.groups()
        return f"stage{s}_m{mod}_fuse_{i}_{j}" + (f"_{k}" if k else "")
    m = re.fullmatch(r"duc_layers\.(\d+)\.conv", name)
    if m:
        return f"duc_{m.group(1)}/conv"
    return name  # conv1, conv2, final_layer


def conv_scale_keys(model: torch.nn.Module, names) -> dict:
    """{torch module path: flax module path} for the conv modules ``names``
    of ``model``: a PoseResNet or PoseHRNet (checked against the converter's
    own ``_module_key``), or a YOLOv5/YOLOv4 detector (the JAX generic
    converter's digit fold)."""
    from simple_pose_torch.detector.yolov5 import _Detector
    from simple_pose_torch.models.hrnet import PoseHRNet

    if isinstance(model, _Detector):
        return {n: "/".join(_fold_digits(n.split("."))) for n in names}
    hrnet = isinstance(model, PoseHRNet)
    out = {}
    for n in names:
        path = _pose_conv_path(n, hrnet)
        if _module_key(path.split("/")) != (n, "conv"):
            raise KeyError(f"no flax conv path for {n} (tried {path})")
        out[n] = path
    return out


def _optax_states(tree):
    """The NamedTuple states inside an optax state: chains are tuples, and
    optax.multi_transform keeps one masked state per group in a dict."""
    if hasattr(tree, "_fields"):
        yield tree
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            yield from _optax_states(sub)
    elif isinstance(tree, dict):
        for sub in tree.values():
            yield from _optax_states(sub)


def _unmasked(tree):
    """A group's moment tree without optax.multi_transform's MaskedNode
    placeholders for the other groups' parameters."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {k: _unmasked(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None}
    return None if type(tree).__name__ == "MaskedNode" else tree


def _moments(states, field):
    """{torch name: tensor} of ``field`` merged over the groups' states."""
    out = {}
    for st in states:
        out.update({k: v for k, v in flax_to_torch_state(
            {"params": _unmasked(getattr(st, field))}).items()
            if not k.endswith("num_batches_tracked")})
    return out


@torch.no_grad()
def _load_optimizer_state(optimizer, model, opt_state):
    """optax.adam's (count, mu, nu) -> torch Adam's (step, exp_avg,
    exp_avg_sq), or optax.sgd's trace -> SGD's momentum_buffer, over one
    param group or optax.multi_transform's groups."""
    states = list(_optax_states(opt_state))
    adam = [s for s in states if {"count", "mu", "nu"} <= set(s._fields)]
    trace = [s for s in states if "trace" in s._fields]
    params = dict(model.named_parameters())
    if adam:
        count = float(np.asarray(adam[0].count))
        mu, nu = _moments(adam, "mu"), _moments(adam, "nu")
        for name, p in params.items():
            optimizer.state[p] = {"step": torch.tensor(count),
                                  "exp_avg": mu[name].to(p.device),
                                  "exp_avg_sq": nu[name].to(p.device)}
    elif trace:
        buf = _moments(trace, "trace")
        for name, p in params.items():
            optimizer.state[p] = {"momentum_buffer": buf[name].to(p.device)}
    else:
        raise NotImplementedError("no optax.adam or optax.sgd state to carry")


@torch.no_grad()
def load_jax_train_state(state, jax_state):
    """Copy a JAX-package TrainState (numpy or jax arrays; a mapping or an
    object with its fields) into the port's TrainState (train/solver.py):
    ``params`` and ``batch_stats`` into the model, ``ema_params`` and
    ``ema_batch_stats`` into the EMA copies, ``step``, and the optimizer's
    moments from ``opt_state`` once it has taken a step (optax.adam or
    optax.sgd, with or without split groups)."""
    def get(key):
        return jax_state[key] if hasattr(jax_state, "keys") else getattr(jax_state, key)

    state.model.load_state_dict(
        flax_to_torch_state({"params": get("params"), "batch_stats": get("batch_stats")}))
    ema = flax_to_torch_state({"params": get("ema_params"),
                               "batch_stats": get("ema_batch_stats")})
    for name, t in {**state.ema_params, **state.ema_buffers}.items():
        t.copy_(ema[name])
    state.step = int(np.asarray(get("step")))
    if state.step:
        _load_optimizer_state(state.optimizer, state.model, get("opt_state"))
    return state
