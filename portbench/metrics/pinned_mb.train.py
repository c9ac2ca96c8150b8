"""Megabytes ``device_prefetch`` pins per training step (the program's
``pinned_bytes`` counter in ``prefetch.pin``); 0 where nothing is pinned."""

from portbench.program_spans import TRAIN, aligned, per_root_mb

UNIT, LAYER, MOVES = "MB", "parallel/prefetch.device_prefetch", "train_crops_per_s"
READS = ("program counter pinned_bytes", "program span train.step", "trace ranges call, stage")


def read(ctx):
    spans = aligned(ctx, TRAIN)
    return None if spans is None else per_root_mb(spans, "pinned_bytes", "train.step")
