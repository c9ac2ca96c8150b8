"""One rank of the port's multi-process tests (tests/test_torch_ddp*.py).

    python -m tests.torch_ddp_worker <case> <rank> <world> <init URL> <workdir>

Joins a gloo group with parallel/distributed.init_multihost (on the CPU)
through the init URL (a file in ``workdir``: no port), runs ``case`` on
this rank's share of what the test wrote to ``workdir`` and saves what it
got to ``workdir/<case>_rank<rank>.pt``.  It imports the port alone (no
JAX): the tests hold the results against JAX and against one process.
Every file a rank opens for writing under ``workdir`` is recorded in its
result as ``written``."""

import builtins
import json
import os
import subprocess
import sys

import numpy as np
import torch

from simple_pose_torch.parallel.distributed import file_rendezvous

torch.set_num_threads(1)


def _record_writes(workdir):
    written = []
    real_open = builtins.open

    def recording_open(file, mode="r", *args, **kwargs):
        path = os.path.abspath(str(file)) if isinstance(file, (str, os.PathLike)) else None
        if path and path.startswith(os.path.abspath(workdir)) and any(c in mode for c in "wax"):
            written.append(os.path.relpath(path, workdir))
        return real_open(file, mode, *args, **kwargs)

    real_save = torch.save

    def recording_save(obj, f, *args, **kwargs):  # torch.save writes paths without open
        if isinstance(f, (str, os.PathLike)):
            written.append(os.path.relpath(os.path.abspath(str(f)), workdir))
        return real_save(obj, f, *args, **kwargs)

    builtins.open = recording_open
    torch.save = recording_save
    return written


def case_bn(rank, world, workdir):
    """Global-batch BatchNorm2d: this rank's half of x through the module,
    a backward of sum(y * g), then a recompute-style forward
    (update_stats=False)."""
    from simple_pose_torch.models.layers import BatchNorm2d

    d = np.load(os.path.join(workdir, "bn.npz"))
    half = d["x"].shape[0] // world
    sl = slice(rank * half, (rank + 1) * half)
    bn = BatchNorm2d(d["x"].shape[1], eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(d["weight"]))
        bn.bias.copy_(torch.from_numpy(d["bias"]))
    bn.train()
    x = torch.from_numpy(d["x"][sl]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(d["g"][sl])).sum().backward()
    stats = (bn.running_mean.clone(), bn.running_var.clone())
    bn.update_stats = False
    y2 = bn(x.detach())
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": stats[0], "running_var": stats[1], "y_recompute": y2.detach(),
            "after_recompute": (bn.running_mean.clone(), bn.running_var.clone())}


def _rank_batch(batch, rank, world):
    """This rank's crops of a global batch; with canvas_idx, the canvases
    those crops use, re-indexed (the rank's own dedup bucket)."""
    n = batch["trans"].shape[0] // world
    sl = slice(rank * n, (rank + 1) * n)
    out = {"trans": batch["trans"][sl], "joints": batch["joints"][sl]}
    if "canvas_idx" not in batch:
        out["canvas"] = batch["canvas"][sl]
        return out
    idx = batch["canvas_idx"][sl]
    used = np.unique(idx)
    out["canvas"] = batch["canvas"][used]
    out["canvas_idx"] = np.searchsorted(used, idx).astype(np.int32)
    return out


def case_train(rank, world, workdir):
    """Two DDP train steps from the carried state on this rank's half of
    each global batch."""
    from simple_pose_torch.train.solver import init_train_state, make_train_step

    with open(os.path.join(workdir, "train.json")) as f:
        spec = json.load(f)
    state = init_train_state(spec["cfg"], device="cpu", steps_per_epoch=1)
    assert state.ddp is not None
    carried = torch.load(os.path.join(workdir, "state.pt"), weights_only=False)
    state.model.load_state_dict(carried["model"])
    state.optimizer.load_state_dict(carried["optimizer"])
    with torch.no_grad():
        for k, t in {**state.ema_params, **state.ema_buffers}.items():
            t.copy_(carried["ema"][k])
    state.step = carried["step"]
    step = make_train_step(tuple(spec["out"]), tuple(spec["crop"]), crop_impl="kernel")
    batches = np.load(os.path.join(workdir, "batches.npz"))
    metrics = []
    for i in range(spec["steps"]):
        batch = {k[len(f"{i}_"):]: batches[k] for k in batches.files if k.startswith(f"{i}_")}
        state, m = step(state, _rank_batch(batch, rank, world))
        metrics.append({"loss": m["loss"].item(), "acc": m["acc"].item()})
    return {"model": state.model.state_dict(),
            "ema": {**state.ema_params, **state.ema_buffers}, "metrics": metrics,
            "step": state.step}


def case_solver(rank, world, workdir):
    """PoseSolver: one epoch, validate and a checkpoint; then a second solver
    resumes from that checkpoint and runs to the end."""
    from simple_pose_torch.train.solver import PoseSolver

    with open(os.path.join(workdir, "solver.json")) as f:
        cfg = json.load(f)
    solver = PoseSolver(cfg, device="cpu")
    solver.init_state()
    train = solver.train_epoch(0, log_every=0)
    stats = solver.validate(0, results_path=os.path.join(workdir, "val.json"))
    solver.save_checkpoint(0, stats["AP"])
    resumed = PoseSolver(cfg, device="cpu")
    start = resumed.restore_checkpoint()
    resumed.run(resume=True)
    return {"train": train, "stats": stats, "start": start, "step": resumed.state.step,
            "model": resumed.state.model.state_dict()}


def case_workflows(rank, world, workdir):
    """predicts_by_gt, predicts_by_detections and fused_eval over the ranks;
    the refusals of gen_detections and fused_layer1; w8a8 calibration."""
    from simple_pose_torch.evalkit import workflows as W
    from simple_pose_torch.evalkit.fused import fused_eval
    from simple_pose_torch.models.quant import calibrate_w8a8

    with open(os.path.join(workdir, "workflows.json")) as f:
        spec = json.load(f)
    out = {}
    kw = dict(weights=spec["weights"], batch_size=4, input_shape=(64, 64), decoder="basic",
              canvas=192, device="cpu", amp=False)
    out["gt"] = W.predicts_by_gt(spec["img_root"], spec["ann"], spec["model_cfg"],
                                 out_path=os.path.join(workdir, "gt.json"), **kw)
    out["det"] = W.predicts_by_detections(
        spec["img_root"], spec["dets"], spec["ann"], spec["model_cfg"],
        out_path=os.path.join(workdir, "det.json"),
        filtered_out_path=os.path.join(workdir, "det_filtered.json"), **kw)
    out["fused"] = fused_eval(
        spec["img_root"], spec["ann"], spec["model_cfg"], pose_weights=spec["weights"],
        scale_name="s", det_conf=0.001, batch_size=2, input_shape=(64, 64), max_people=4,
        canvas=192, det_size=(128, 128), decoder="basic", amp=False, device="cpu",
        out_path=os.path.join(workdir, "fused.json"),
        filtered_out_path=os.path.join(workdir, "fused_filtered.json"))
    refusals = {}
    try:
        W.gen_detections(spec["img_root"], spec["ann"], out_path=os.path.join(workdir, "x.json"),
                         device="cpu")
    except NotImplementedError as e:
        refusals["gen_detections"] = str(e)
    try:
        W.PoseEvaluator(spec["model_cfg"], spec["weights"], (64, 64), fused_layer1=True,
                        device="cpu")
    except ValueError as e:
        refusals["fused_layer1"] = str(e)
    out["refusals"] = refusals
    ev = W.PoseEvaluator(spec["model_cfg"], spec["weights"], (64, 64), decoder="basic",
                         device="cpu", amp=False, quant="w8a8")
    from simple_pose_torch.data.coco import load_coco_keypoints
    from simple_pose_torch.data.pipeline import PosePipeline

    recs = load_coco_keypoints(spec["img_root"], spec["ann"])
    pipe = PosePipeline(recs, 4, input_shape=(64, 64), output_shape=(16, 16), canvas=192,
                        augment=False, shuffle=False, drop_last=False, process_index=rank,
                        process_count=world)
    xs = [ev._inputs(*ev._batch_tensors(b)) for b in list(pipe.epoch(0))[:2]]
    out["local_scales"] = calibrate_w8a8(ev.model, ev.model, xs)
    out["scales"] = ev.calibrate(pipe.epoch(0), 2)
    return out


def global_batchnorm(workdir):
    """A target of parallel/distributed.spawn_ranks: a global-batch
    BatchNorm2d forward and backward on this rank's half of a batch; saves
    the world size, the batch mean the statistics saw, and the
    ``torch.distributed.nn`` modules this rank has imported to
    ``workdir/bn_rank<rank>.pt``."""
    from simple_pose_torch.models.layers import BatchNorm2d
    from simple_pose_torch.parallel import distributed as D

    rank, world = D.rank_world()
    x = torch.full((2, 3, 4, 5), float(rank), requires_grad=True)
    bn = BatchNorm2d(3, momentum=1.0)
    bn(x).square().sum().backward()
    torch.save({"world": world, "mean": bn.running_mean.clone(),
                "modules": sorted(m for m in sys.modules if m.startswith("torch.distributed.nn"))},
               os.path.join(workdir, f"bn_rank{rank}.pt"))


CASES = {"bn": case_bn, "train": case_train, "solver": case_solver,
         "workflows": case_workflows}


def run_ranks(case, workdir, world=2, timeout=120):
    """Runs ``case`` on ``world`` ranks (one process each, cwd ``workdir``,
    meeting through a file there); returns each rank's result.
    A rank that fails or hangs past ``timeout`` seconds fails the test."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"}
    init = file_rendezvous(workdir, f"rendezvous_{case}")
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_ddp_worker", case, str(r),
                               str(world), init, str(workdir)], cwd=str(workdir), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {case}:\n{out[-3000:]}\n{err[-3000:]}"
    return [torch.load(os.path.join(workdir, f"{case}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main():
    case, rank, world, init, workdir = sys.argv[1], *map(int, sys.argv[2:4]), *sys.argv[4:6]
    from simple_pose_torch.parallel import distributed as D

    written = _record_writes(workdir)
    info = D.init_multihost(init, world, rank, device="cpu")
    assert info["process_index"] == rank and info["backend"] == "gloo", info
    try:
        result = CASES[case](rank, world, workdir)
        D.barrier()
    finally:
        D.shutdown()
    result["written"] = sorted(set(written))
    torch.save(result, os.path.join(workdir, f"{case}_rank{rank}.pt"))


if __name__ == "__main__":
    main()
