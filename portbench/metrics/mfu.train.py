"""The whole training step's share of the bf16 peak: three times the model
FLOPs of a crop's forward (forward, and the backward's two products) for
every crop of the window's steps, over the window and the peak."""

from portbench.work.counts import forward_flops, peaks

UNIT, LAYER, MOVES = "%", "models/ (resnet, hrnet, layers) under bf16", "train_crops_per_s"
READS = ("counter crops", "window")


def read(ctx):
    cfg = ctx["cell"]["config"]
    if not ctx["crops"]:
        return None
    in_w, in_h = cfg["input_wh"]
    flops = ctx["crops"] * 3 * forward_flops(cfg["model"], (in_h, in_w))
    return 100.0 * flops / (ctx["window_s"] * peaks()["bf16_flops_per_s"])
