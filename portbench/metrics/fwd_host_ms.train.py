"""Mean host time a training step spends in the program's ``train.forward``
span: the model's forward (Python module calls and their launches) and the
loss."""

from portbench.program_spans import TRAIN, aligned, per_root_ms

UNIT, LAYER, MOVES = "ms", "train/solver.make_train_step", "train_crops_per_s"
READS = ("program spans train.forward, train.step", "trace ranges call, stage")


def read(ctx):
    spans = aligned(ctx, TRAIN)
    return None if spans is None else per_root_ms(spans, "train.forward", "train.step")
