"""Double-buffered host-to-device staging of input batches.

Port of simple_pose_tpu/parallel/mesh.py:111-134 (``device_prefetch``) for
one CUDA device: ``depth`` batches are in flight, so the copy of batch i+1
overlaps the step that consumes batch i.

The copy overlaps only if three things hold, and the code does all three:

  * the host memory is pinned: a "non_blocking" copy from pageable memory
    is staged through a bounce buffer by the host and returns only when done;
  * it runs on a side stream: on the compute stream it would queue
    behind the step already running there;
  * the compute stream waits on an event recorded after that batch's copies
    (not on the whole side stream, which may hold the next batch's copies),
    and each copied tensor is marked with ``record_stream`` so the caching
    allocator does not hand its memory to the side stream while the step
    still reads it.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Optional, Sequence

import torch

__all__ = ["device_prefetch"]


def device_prefetch(batches: Iterable[dict], device, depth: int = 2,
                    device_keys: Optional[Sequence[str]] = None) -> Iterator[dict]:
    """Yield each batch with its ``device_keys`` (all keys if None) as tensors
    on ``device``, staging up to ``depth`` batches ahead of the consumer; the
    other keys pass through as they are.  On the CPU the values become
    tensors that share the numpy arrays' memory."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def stage(batch):
        """(batch with its keys staged, the copied tensors, their event)."""
        keys = list(batch) if device_keys is None else [k for k in device_keys if k in batch]
        staged = dict(batch)
        if not cuda:
            staged.update({k: torch.as_tensor(batch[k]) for k in keys})
            return staged, [], None
        with torch.cuda.stream(stream):
            for k in keys:
                host = torch.as_tensor(batch[k])
                if not host.is_pinned():
                    host = host.pin_memory()
                staged[k] = host.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        return staged, [staged[k] for k in keys], ready

    def release(entry):
        staged, copied, ready = entry
        if ready is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(ready)
            for t in copied:
                t.record_stream(compute)
        return staged

    buf = deque()
    for b in batches:
        buf.append(stage(b))
        if len(buf) >= depth:
            yield release(buf.popleft())
    while buf:
        yield release(buf.popleft())
