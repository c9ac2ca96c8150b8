"""Helpers for the train-step parity tests (tests/test_torch_train*.py): one
model, optimizer and batch set up identically in the JAX package and in the
port, the weights carried over with convert/from_jax, both steps run side by
side, and the trees compared per tensor as |port - jax| / |jax update|.

JAX's Pallas crop kernel runs in interpret mode (as tests/test_pallas_warp.py
runs it)."""

import jax
import jax.numpy as jnp
import numpy as np

from simple_pose_torch.convert.from_jax import flax_to_torch_state, load_jax_train_state
from simple_pose_torch.ops import affine as A
from simple_pose_torch.train.solver import init_train_state, make_train_step
from simple_pose_tpu.parallel.mesh import make_mesh
from simple_pose_tpu.train.solver import PoseSolver
from simple_pose_tpu.train.solver import TrainState as JaxTrainState
from simple_pose_tpu.train.solver import make_train_step as jax_make_train_step

CROP = (64, 64)  # (h, w)
OUT = (16, 16)
LOSS_REL = 1e-4
TREE_REL = 1e-2
WARMUP = 4
JAX_CROP_IMPL = {"kernel": "pallas", "gather": "gather"}


def _eager(fn):
    """``fn`` computed op by op on the host from inside a jitted program."""
    def wrapped(canvas, trans, *args, **kwargs):
        out = jax.eval_shape(lambda c, t: fn(c, t, *args, **kwargs), canvas, trans)
        return jax.pure_callback(
            lambda c, t: np.asarray(fn(jnp.asarray(c), jnp.asarray(t), *args, **kwargs)),
            out, canvas, trans)
    return wrapped


def jax_crops_as_tested(monkeypatch):
    """Pallas in interpret mode, and the JAX step's crop computed eagerly.

    Inside the jitted step XLA fuses the crop's coordinate arithmetic into
    other multiply-adds than the eagerly run crop uses (tests/
    test_torch_warp_train.py holds the port to the latter bit for bit).  One
    ulp of a coordinate can flip the bf16 rounding of an interpolation
    weight or of the bf16 intermediate, moving a pixel by up to one
    intensity level, and the BN-parameter gradients of a net at its seeded
    init are ill-conditioned enough to turn ~1% of such pixels into a 5%
    gradient difference.  So the step is compared on the same crop."""
    from jax.experimental import pallas as pl

    import simple_pose_tpu.ops.pallas_warp as PW
    import simple_pose_tpu.train.solver as JS

    orig = pl.pallas_call
    monkeypatch.setattr(PW.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(PW, "affine_crop_pallas", _eager(PW.affine_crop_pallas))
    monkeypatch.setattr(JS, "affine_crop", _eager(JS.affine_crop))


def config(name="resnet18", se=False, **optim):
    return {
        "data": {"batch_size": 2, "input_shape": [CROP[1], CROP[0]]},
        "model": {"type": "pose_resnet_dconv", "name": name, "num_joints": 17,
                  "reduction": se},
        "optim": {"lr": 1e-3, "milestones": [WARMUP + 1], "epochs": 8, "amp": False, **optim},
        "mesh": {"data": 1},
    }


def make_states(cfg, jstep_of=None, steps_per_epoch=1, warmup=0, canvases=None):
    """(JAX solver, JAX TrainState, port TrainState): JAX inits and takes
    ``warmup`` steps alone (batches seeded 100, 101, ...), then its whole
    state, optimizer moments included, is carried into the port.

    Why warm up: at the seeded init the BN-parameter gradients are sums that
    nearly cancel, so two correct f32 implementations (or one ulp of the
    input) differ in them by ~0.5% (measured).  Adam's first step,
    lr*g/(|g|+eps), turns a near-zero gradient of either sign into a full
    +-lr step, and one such element of a 64-channel BN moves its tensor by
    a quarter of its update.  From a state with Adam moments the step is a
    smooth function of the gradient."""
    solver = PoseSolver(cfg, mesh=make_mesh({"data": 1}))
    solver._steps_per_epoch = steps_per_epoch
    solver.schedule = solver._build_schedule(steps_per_epoch)
    solver.tx = solver._build_optimizer()
    variables = jax.jit(solver.train_model.init)(jax.random.PRNGKey(0),
                                                 jnp.zeros((1,) + CROP + (3,), jnp.float32))
    params, stats = variables["params"], variables["batch_stats"]
    jstate = JaxTrainState(
        params=params, batch_stats=stats, opt_state=solver.tx.init(params),
        ema_params=jax.tree.map(jnp.copy, params), ema_batch_stats=jax.tree.map(jnp.copy, stats),
        step=jnp.zeros((), jnp.int32))
    jstep = jstep_of(solver) if jstep_of else jax.jit(
        jax_make_train_step(solver.train_model, solver.tx, OUT, CROP))
    for i in range(warmup):
        jstate, _ = jstep(jstate, make_batch(100 + i, canvases=canvases))
    tstate = init_train_state(cfg, device="cpu", steps_per_epoch=steps_per_epoch)
    load_jax_train_state(tstate, jax.device_get(jstate))
    return solver, jstate, tstate


def make_batch(seed, batch=2, canvas=128, canvases=None):
    """Noise uint8 canvases, box affines rotated within +-40 deg and scaled
    0.7-1.3, joints in heatmap coordinates (some out of bounds, some
    invisible).  ``canvases``: fewer canvases than crops, with canvas_idx."""
    rng = np.random.default_rng(seed)
    n_canvas = canvases or batch
    canvas_arr = rng.integers(0, 256, (n_canvas, canvas, canvas, 3), dtype=np.uint8)
    trans = []
    for _ in range(batch):
        c = rng.uniform(0.4 * canvas, 0.6 * canvas, 2)
        w = rng.uniform(0.3, 0.5) * canvas * rng.uniform(0.7, 1.3)
        t, _ = A.get_affine_transform(c, np.array([w, w * CROP[0] / CROP[1]]) * 1.25,
                                      rng.uniform(-40, 40), (CROP[1], CROP[0]))
        trans.append(t)
    joints = np.zeros((batch, 17, 3), np.float32)
    joints[..., 0] = rng.uniform(-2, OUT[1] + 2, (batch, 17))
    joints[..., 1] = rng.uniform(-2, OUT[0] + 2, (batch, 17))
    joints[..., 2] = rng.uniform(0, 1, (batch, 17)) > 0.2
    out = {"canvas": canvas_arr, "trans": np.stack(trans).astype(np.float32), "joints": joints}
    if canvases:
        out["canvas_idx"] = rng.integers(0, n_canvas, batch).astype(np.int32)
    return out


def torch_trees(jstate):
    """A JAX TrainState's model and EMA trees under the port's key names."""
    s = jax.device_get(jstate)
    model = flax_to_torch_state({"params": s.params, "batch_stats": s.batch_stats})
    ema = flax_to_torch_state({"params": s.ema_params, "batch_stats": s.ema_batch_stats})
    return model, ema


def run_steps(cfg, steps, crop_impl="kernel", encoding="unbiased", warmup=WARMUP,
              canvases=None, batch=2):
    """Run ``steps`` steps of both from the carried state; returns the
    per-step metrics and the trees (before, JAX after, port after) for
    :func:`tree_ratios`."""
    steps_of = {}

    def jstep_of(solver):
        steps_of["jax"] = jax.jit(jax_make_train_step(
            solver.train_model, solver.tx, OUT, CROP, crop_impl=JAX_CROP_IMPL[crop_impl],
            encoding=encoding))
        return steps_of["jax"]

    solver, jstate, tstate = make_states(cfg, jstep_of, warmup=warmup, canvases=canvases)
    jstep = steps_of["jax"]
    before, _ = torch_trees(jstate)
    tstep = make_train_step(OUT, CROP, crop_impl=crop_impl, encoding=encoding)
    metrics = []
    for i in range(steps):
        data = make_batch(i, batch=batch, canvases=canvases)
        jstate, jm = jstep(jstate, data)
        tstate, tm = tstep(tstate, data)
        metrics.append({"jax_loss": float(jm["loss"]), "loss": tm["loss"].item(),
                        "jax_acc": float(jm["acc"]), "acc": tm["acc"].item()})
    jmodel, jema = torch_trees(jstate)
    tmodel = tstate.model.state_dict()
    tema = {**tstate.ema_params, **tstate.ema_buffers}
    assert tstate.step == int(jstate.step) == warmup + steps
    return metrics, before, (jmodel, tmodel), (jema, tema), (solver, jstate, tstate)


def check_metrics(metrics):
    for i, m in enumerate(metrics):
        assert np.isfinite(m["loss"]) and m["loss"] > 0
        assert abs(m["loss"] / m["jax_loss"] - 1) <= LOSS_REL, (i, m)
        assert abs(m["acc"] - m["jax_acc"]) <= 1e-6, (i, m)


def tree_ratios(before, want, got):
    """name -> |got - want| / |want - before| per tensor (num_batches_tracked
    has no flax counterpart)."""
    out = {}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        update = (w - before[k]).norm().item()
        diff = (got[k].detach().float() - w).norm().item()
        out[k] = diff / update if update > 0 else (0.0 if diff == 0 else float("inf"))
    return out


def check_trees(before, model_pair, ema_pair):
    for name, (want, got) in (("model", model_pair), ("ema", ema_pair)):
        ratios = tree_ratios(before, want, got)
        worst = max(ratios, key=ratios.get)
        assert ratios[worst] <= TREE_REL, (name, worst, ratios[worst])
