"""K2, the fused layer1 chain (``ops/bottleneck_chain`` + ``csrc/
bottleneck_chain.cu``): its least time a call at the batch
(work/counts.chain_least_s, from layer1's shapes) over its device time a
call in the traced slice.

A call launches the block kernel's full pass once per Bottleneck, and for
each squeeze-excitation block a sums pass (the same kernel with its last
template flag set) and ``se_gate_kernel``.  The card's profiler drops a
launch now and then, so the time a call is the mean traced time of each
kind of launch times the launches of that kind a call; a kind the trace
lacks leaves the metric unread."""

import re

from portbench.reference.models import Bottleneck
from portbench.weights import plain_model
from portbench.work.counts import chain_least_s

UNIT, LAYER, MOVES = "%", "ops/bottleneck_chain + csrc/bottleneck_chain.cu (K2)", "serve_crops_per_s"
READS = ("trace kernels bottleneck_block*, se_gate_kernel",)


def kind(name):
    """"full", "sums" or "gate" for a K2 kernel name, else None."""
    if "se_gate_kernel" in name:
        return "gate"
    if "bottleneck_block" not in name:
        return None
    m = re.search(r"bottleneck_block\w*<([^<>]*)>", name)
    if m:
        flags = [a.strip() == "true" for a in m.group(1).split(",")
                 if a.strip() in ("true", "false")]
    else:
        flags = [f == "1" for f in re.findall(r"Lb([01])E", name)]
    return "sums" if flags and flags[-1] else "full"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    cfg = ctx["cell"]["config"]
    blocks = [b for b in plain_model(cfg["model"]).layer1 if isinstance(b, Bottleneck)]
    se = sum(b.se is not None for b in blocks)
    per_call = {"full": len(blocks), "sums": se, "gate": se}
    seconds = 0.0
    for k, n in per_call.items():
        if not n:
            continue
        times = tr.kernels(lambda name, k=k: kind(name) == k)
        if not times:
            return None
        seconds += n * sum(times) / len(times)
    in_w, in_h = cfg["input_wh"]
    least = chain_least_s(cfg["model"], (in_h, in_w), ctx["cell"]["traffic"]["batch"])
    return 100.0 * least / seconds
