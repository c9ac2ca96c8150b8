"""Share of the traced slice of serving batches in which no operation runs
on the device while the host is inside the program's ``serve.device``
span, launching the device program."""

from portbench.program_spans import SERVE, aligned, idle_share

UNIT, LAYER, MOVES = "%", "evalkit/workflows.PoseEvaluator", "serve_crops_per_s"
READS = ("program span serve.device", "trace device operations, ranges call", "trace window")


def read(ctx):
    spans = aligned(ctx, SERVE)
    return None if spans is None else idle_share(ctx, spans, {"serve.device"})
