"""The readers of the program's own spans (``program_spans.py`` and the
metrics that use it): alignment, hand-worked idle attribution and per-root
means on a hand-built trace, and a traced CPU run of each cell, in which
every span and counter metric reads a number and the idle shares, like
``device_idle.*``, find no device operation to read."""

import pytest

from portbench import program_spans as P
from portbench.run import metric_reader, per_layer_values, run_cell
from portbench.tests.small import args, small_cell
from portbench.trace import DeviceTrace
from simple_pose_torch.utils.tracing import Span

UNIX_US = 1_792_000_000_000_000  # the program's clock at the trace's 0, in us
SPAN_METRICS = {"h2d_ms.serve", "pageable_mb.serve", "launch_ms.serve", "pin_ms.train",
                "pinned_mb.train", "fwd_host_ms.train", "bwd_host_ms.train",
                "update_host_ms.train"}
IDLE_METRICS = {"idle_h2d.serve", "idle_launch.serve", "idle_stage.train", "idle_launch.train"}


def trace(ops, ranges, window_us):
    tr = DeviceTrace([], window_us * 1e-6, len(ranges))
    tr.ops = [("kernel", s, e) for s, e in ops]
    tr.spans = list(ranges)
    return tr


def spans(rows, shift_us=0.0):
    """Span records from (name, id, seq, parent, start us, end us, counters)
    rows on the trace's timeline, moved to the program's clock."""
    def ns(t):
        return UNIX_US * 1000 + round((t + shift_us) * 1000)

    return [Span(n, i, q, p, ns(s), ns(e), c or {}) for n, i, q, p, s, e, c in rows]


MB = 78_643_200
# three calls: the third's root starts 30 us into its range, so the median
# offset is the other two's, exact; an older root from before the slice
SERVE_ROWS = [
    ("serve.call", 1, 0, None, -90_000, -80_000, None),
    ("serve.h2d", 2, 1, 2, 0, 1000, {"pageable_bytes": MB}),
    ("serve.device", 2, 3, 2, 1030, 3980, None),
    ("serve.call", 2, 2, None, 0, 3990, None),
    ("serve.h2d", 3, 5, 4, 5000, 6000, {"pageable_bytes": MB}),
    ("serve.device", 3, 6, 4, 6040, 8980, None),
    ("serve.call", 3, 4, None, 5000, 8990, None),
    ("serve.h2d", 4, 8, 7, 9140, 9240, {"pageable_bytes": MB}),
    ("serve.device", 4, 9, 7, 9250, 9880, None),
    ("serve.call", 4, 7, None, 9130, 9890, None),
]
SERVE_RANGES = [("call", 0, 4000), ("fetch", 4000, 4500), ("call", 5000, 9000),
                ("call", 9100, 9900)]
SERVE_OPS = [(1000, 2000), (2500, 3985), (6000, 9000)]

TRAIN_ROWS = [
    ("prefetch.pin", 7, 1, 0, 100, 900, {"pinned_bytes": MB}),
    ("prefetch.stage", 7, 0, None, 0, 1000, None),
    ("train.forward", 40, 3, 2, 1010, 2000, None),
    ("train.backward", 40, 4, 2, 2000, 3500, None),
    ("train.update", 40, 5, 2, 3500, 4900, None),
    ("train.step", 40, 2, None, 1000, 4990, None),
]
TRAIN_RANGES = [("stage", 0, 1000), ("call", 1000, 5000)]
TRAIN_OPS = [(500, 600), (1500, 4000)]


def read_all(monkeypatch, names, tr, records, cell):
    monkeypatch.setattr(P, "program_records", lambda: records)
    ctx = {"trace": tr, "cell": cell}
    return {n: metric_reader(n).read(ctx) for n in names}


def test_serving_readers_by_hand(monkeypatch):
    tr = trace(SERVE_OPS, SERVE_RANGES, 10_000)
    placed = P.aligned({"trace": tr}, P.SERVE, spans(SERVE_ROWS, shift_us=123_456.75))
    roots = sorted(p.start for p in placed if p.name == "serve.call")
    assert roots == pytest.approx([0, 5000, 9130], abs=1e-3)  # the offset, recovered
    assert len(placed) == 9  # the older call is left out
    got = read_all(monkeypatch, ["h2d_ms.serve", "pageable_mb.serve", "launch_ms.serve",
                                 "idle_h2d.serve", "idle_launch.serve"],
                   tr, spans(SERVE_ROWS), None)
    assert got["h2d_ms.serve"] == pytest.approx((1000 + 1000 + 100) / 3e3)
    assert got["pageable_mb.serve"] == pytest.approx(MB / 1e6)
    assert got["launch_ms.serve"] == pytest.approx((2950 + 2940 + 630) / 3e3)
    # idle under serve.h2d: 1000 + 1000 + 100 us; under serve.device: 500 + 0 + 630
    assert got["idle_h2d.serve"] == pytest.approx(100 * 2100 / 10_000)
    assert got["idle_launch.serve"] == pytest.approx(100 * 1130 / 10_000)


def test_training_readers_by_hand(monkeypatch):
    tr = trace(TRAIN_OPS, TRAIN_RANGES, 5000)
    names = ["pin_ms.train", "pinned_mb.train", "fwd_host_ms.train", "bwd_host_ms.train",
             "update_host_ms.train", "idle_stage.train", "idle_launch.train",
             "device_idle.train"]
    got = read_all(monkeypatch, names, tr, spans(TRAIN_ROWS), None)
    assert got["pin_ms.train"] == pytest.approx(0.8)
    assert got["pinned_mb.train"] == pytest.approx(MB / 1e6)
    assert (got["fwd_host_ms.train"], got["bwd_host_ms.train"],
            got["update_host_ms.train"]) == pytest.approx((0.99, 1.5, 1.4))
    # stage [0, 1000] less [500, 600]; step [1000, 4990] less [1500, 4000]
    assert got["idle_stage.train"] == pytest.approx(100 * 900 / 5000)
    assert got["idle_launch.train"] == pytest.approx(100 * 1490 / 5000)
    assert got["idle_stage.train"] + got["idle_launch.train"] <= got["device_idle.train"]
    # a prefetcher that pins nothing reads 0, not None
    unpinned = [r for r in TRAIN_ROWS if r[0] != "prefetch.pin"]
    got = read_all(monkeypatch, ["pin_ms.train", "pinned_mb.train"], tr, spans(unpinned), None)
    assert got == {"pin_ms.train": 0.0, "pinned_mb.train": 0.0}


@pytest.mark.parametrize("case", ["no records", "a root outside its range",
                                  "fewer roots than ranges", "no trace"])
def test_alignment_fails_to_none(monkeypatch, case):
    rows, tr = list(SERVE_ROWS), trace(SERVE_OPS, SERVE_RANGES, 10_000)
    if case == "no records":
        rows = []
    elif case == "a root outside its range":  # 60 us past its range's end
        rows[-1] = ("serve.call", 4, 7, None, 9130, 9960, None)
    elif case == "fewer roots than ranges":
        rows = rows[1:4]
    else:
        tr = None
    assert P.aligned({"trace": tr}, P.SERVE, spans(rows)) is None
    got = read_all(monkeypatch, sorted(n for n in SPAN_METRICS | IDLE_METRICS
                                       if n.endswith(".serve")), tr, spans(rows), None)
    assert set(got.values()) == {None}


@pytest.mark.parametrize("workload", ["resnet50_dconv_se.serve_b128",
                                      "resnet50_dconv_se.train_b128", "hrnet_w32.train_b128"])
def test_a_traced_cpu_run_reads_every_span_and_counter_metric(workload):
    cell = small_cell(workload, batch=2)
    out, _, result = run_cell(cell, args(trace=1), device="cpu")
    names = {m["name"] for m in cell["per_layer"]}
    mine = names & (SPAN_METRICS | IDLE_METRICS)
    assert len(mine) == (5 if workload.endswith("serve_b128") else 7)
    assert mine & SPAN_METRICS <= set(out["metrics"])
    assert not mine & IDLE_METRICS & set(out["metrics"])  # no device operations on the CPU
    assert "device_idle." + ("serve" if "serve" in workload else "train") not in out["metrics"]
    values = per_layer_values(cell, result)
    assert all(values[n]["value"] >= 0 for n in mine & SPAN_METRICS)
