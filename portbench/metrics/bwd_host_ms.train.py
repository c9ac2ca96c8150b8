"""Mean host time a training step spends in the program's ``train.backward``
span: zero_grad and the autograd engine's backward."""

from portbench.program_spans import TRAIN, aligned, per_root_ms

UNIT, LAYER, MOVES = "ms", "train/solver.make_train_step", "train_crops_per_s"
READS = ("program spans train.backward, train.step", "trace ranges call, stage")


def read(ctx):
    spans = aligned(ctx, TRAIN)
    return None if spans is None else per_root_ms(spans, "train.backward", "train.step")
