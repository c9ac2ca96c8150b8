"""The training crop kernel (``ops/rotate_resample``,
``rotate_resample_crop_kernel``): its least time a call, by the bytes its
taps touch and its output (work/counts.crop_least_s, from the traced
batches' affines), over its mean device time a launch in the traced slice."""

from portbench.work.counts import crop_least_s

UNIT, LAYER, MOVES = "%", "ops/rotate_resample (rotate_resample_crop_kernel)", "train_crops_per_s"
READS = ("trace kernel rotate_resample_crop_kernel", "traced batches' affines")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    times = tr.kernels(lambda name: "rotate_resample_crop_kernel" in name)
    if not times or not ctx.get("crop_trans"):
        return None
    in_w, in_h = ctx["cell"]["config"]["input_wh"]
    least = [crop_least_s(ctx["canvas_hw"], 3, t, (in_h, in_w)) for t in ctx["crop_trans"]]
    return 100.0 * (sum(least) / len(least)) / (sum(times) / len(times))
