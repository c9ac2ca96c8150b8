"""Mean host time a serving call spends in the program's ``serve.device``
span: the launches of the crop, the forwards, the flip merge and the
decode."""

from portbench.program_spans import SERVE, aligned, per_root_ms

UNIT, LAYER, MOVES = "ms", "evalkit/workflows.PoseEvaluator", "serve_crops_per_s"
READS = ("program spans serve.call, serve.device", "trace ranges call")


def read(ctx):
    spans = aligned(ctx, SERVE)
    return None if spans is None else per_root_ms(spans, "serve.device", "serve.call")
