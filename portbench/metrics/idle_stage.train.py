"""Share of the traced slice of training steps in which no operation runs
on the device while the host is inside ``device_prefetch``'s staging (the
program's ``prefetch.stage`` span and the ``prefetch.pin`` in it)."""

from portbench.program_spans import TRAIN, aligned, idle_share

UNIT, LAYER, MOVES = "%", "parallel/prefetch.device_prefetch", "train_crops_per_s"
READS = ("program span prefetch.stage", "trace device operations, ranges call, stage",
         "trace window")


def read(ctx):
    spans = aligned(ctx, TRAIN)
    return None if spans is None else idle_share(ctx, spans, {"prefetch.stage"})
