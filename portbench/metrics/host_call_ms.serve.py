"""Mean host time of the benchmark's span around each ``PoseEvaluator.__call__``
of the window: the synchronous copy of the batch to the device and the
launches of the crop, the two forwards, the merge and the decode."""

UNIT, LAYER, MOVES = "ms", "evalkit/workflows.PoseEvaluator", "serve_p95_ms"
READS = ("span call",)


def read(ctx):
    calls = ctx["spans"].get("call")
    return 1e3 * sum(calls) / len(calls) if calls else None
