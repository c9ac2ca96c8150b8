"""Host time ``device_prefetch`` spends pinning host arrays (the program's
``prefetch.pin`` spans) per training step; 0 where nothing is pinned."""

from portbench.program_spans import TRAIN, aligned, per_root_ms

UNIT, LAYER, MOVES = "ms", "parallel/prefetch.device_prefetch", "train_crops_per_s"
READS = ("program spans prefetch.pin, train.step", "trace ranges call, stage")


def read(ctx):
    spans = aligned(ctx, TRAIN)
    return None if spans is None else per_root_ms(spans, "prefetch.pin", "train.step")
