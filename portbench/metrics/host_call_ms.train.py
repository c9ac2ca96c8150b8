"""Mean host time of the benchmark's span around each call of the step that
``make_train_step`` returns, over the window."""

UNIT, LAYER, MOVES = "ms", "train/solver.make_train_step", "train_crops_per_s"
READS = ("span call",)


def read(ctx):
    calls = ctx["spans"].get("call")
    return 1e3 * sum(calls) / len(calls) if calls else None
