"""Share of the traced slice of serving batches in which no operation ran
on the device (the union of the trace's kernel, copy and set intervals)."""

UNIT, LAYER, MOVES = "%", "the device", "serve_crops_per_s"
READS = ("trace device operations", "trace window")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
