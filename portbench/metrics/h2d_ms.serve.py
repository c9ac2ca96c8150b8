"""Mean host time a serving call spends in the program's ``serve.h2d`` span:
the copies of the batch's canvases, affines and indices to the device (a
copy from pageable host memory returns only when done)."""

from portbench.program_spans import SERVE, aligned, per_root_ms

UNIT, LAYER, MOVES = "ms", "evalkit/workflows.PoseEvaluator", "serve_p95_ms"
READS = ("program spans serve.call, serve.h2d", "trace ranges call")


def read(ctx):
    spans = aligned(ctx, SERVE)
    return None if spans is None else per_root_ms(spans, "serve.h2d", "serve.call")
