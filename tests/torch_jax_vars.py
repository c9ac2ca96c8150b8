"""Helpers of the port's detector parity tests (tests/test_torch_detector.py,
tests/test_torch_fused.py): seeded flax variables made in numpy from a
generator instead of by compiling a module's ``init``, an abstract flax
``init`` for the JAX workflows that load every leaf from a checkpoint, and
the rule that pairs the two packages' detections where NMS's choice is
not decided by a near-tie."""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np


def unfreeze(tree):
    """Nested dicts of a (possibly frozen) flax variable tree."""
    return {k: unfreeze(v) for k, v in tree.items()} if hasattr(tree, "items") else tree


def randomize_bn(variables, rng):
    """Non-trivial BN statistics and affine parameters, in place: every
    params dict with a ``scale`` is a BatchNorm."""
    def walk(params, stats):
        for k, v in params.items():
            if isinstance(v, dict):
                walk(v, stats.get(k, {}) if stats else {})
        if "scale" in params:
            params["scale"] = rng.normal(1.0, 0.1, params["scale"].shape).astype(np.float32)
            params["bias"] = rng.normal(0.0, 0.1, params["bias"].shape).astype(np.float32)
            stats["mean"] = rng.normal(0.0, 0.3, stats["mean"].shape).astype(np.float32)
            stats["var"] = rng.uniform(0.5, 1.5, stats["var"].shape).astype(np.float32)
    walk(variables["params"], variables.get("batch_stats", {}))
    return variables


def seeded_variables(module, x, rng):
    """Variables of the flax ``module`` for input ``x``: kernels normal with
    variance 1/fan_in, biases 0, BN scale 1 and var 1, then
    :func:`randomize_bn`."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)

    return randomize_bn(unfreeze(jax.tree_util.tree_map_with_path(leaf, shapes)), rng)


@contextlib.contextmanager
def abstract_flax_init():
    """flax's ``init`` as shapes filled with zeros: the JAX workflows init
    a model and then overwrite every leaf from the checkpoint, and an eager
    init of YOLOv5 costs seconds per module on the CPU."""
    orig = fnn.Module.init

    def init(self, *args, **kwargs):
        shapes = jax.eval_shape(lambda: orig(self, *args, **kwargs))
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    fnn.Module.init = init
    try:
        yield
    finally:
        fnn.Module.init = orig


def is_clear(pred, score, tol):
    """Whether ``score`` is farther than ``tol`` from every other candidate
    score (obj * cls) of one image's ``pred`` [N, 6]: NMS keeps the same
    box in both packages only where no other candidate is that close."""
    conf = pred[:, 4] * pred[:, 5]
    d = np.sort(np.abs(conf - score))
    return d[1] > tol


def clear_pairs(preds, want, got, tol):
    """Pair each JAX detection ``want`` = (image index, score, ...) whose
    score is clear in ``preds[image index]`` with the port's detection
    of that image nearest in score, and check that the two scores are
    within ``tol``.  Returns the (JAX, port) pairs."""
    by_image = {}
    for g in got:
        by_image.setdefault(g[0], []).append(g)
    pairs = []
    for w in want:
        if not is_clear(preds[w[0]], w[1], tol):
            continue
        g = min(by_image.get(w[0], []), key=lambda g: abs(g[1] - w[1]))
        assert abs(g[1] - w[1]) <= tol, (w, g, tol)
        pairs.append((w, g))
    return pairs
