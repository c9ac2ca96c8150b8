"""Megabytes a serving call copies to the device from host memory that is
not pinned (the program's ``pageable_bytes`` counter in ``serve.h2d``)."""

from portbench.program_spans import SERVE, aligned, per_root_mb

UNIT, LAYER, MOVES = "MB", "evalkit/workflows.PoseEvaluator", "serve_p95_ms"
READS = ("program counter pageable_bytes", "program span serve.call", "trace ranges call")


def read(ctx):
    spans = aligned(ctx, SERVE)
    return None if spans is None else per_root_mb(spans, "pageable_bytes", "serve.call")
