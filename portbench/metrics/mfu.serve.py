"""The whole serving step's share of the bf16 peak: model FLOPs of the crops
served in the window (two forwards a crop under flip-test, each counted on
the plain model, work/counts.forward_flops) over the window and the peak."""

from portbench.work.counts import forward_flops, peaks

UNIT, LAYER, MOVES = "%", "models/ (resnet, hrnet, layers) under bf16", "serve_crops_per_s"
READS = ("counter crops", "window")


def read(ctx):
    cfg = ctx["cell"]["config"]
    if not ctx["crops"]:
        return None
    in_w, in_h = cfg["input_wh"]
    forwards = 2 if ctx["cell"]["traffic"]["flip_test"] else 1
    flops = ctx["crops"] * forwards * forward_flops(cfg["model"], (in_h, in_w))
    return 100.0 * flops / (ctx["window_s"] * peaks()["bf16_flops_per_s"])
