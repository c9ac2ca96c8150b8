"""Share of the traced slice of training steps in which no operation runs
on the device while the host is inside the program's training step (the
``train.step`` span and the forward, backward and update spans in it)."""

from portbench.program_spans import TRAIN, aligned, idle_share

UNIT, LAYER, MOVES = "%", "train/solver.make_train_step", "train_crops_per_s"
READS = ("program span train.step", "trace device operations, ranges call, stage",
         "trace window")


def read(ctx):
    spans = aligned(ctx, TRAIN)
    return None if spans is None else idle_share(ctx, spans, {"train.step"})
