"""Device timing on the CUDA stream: the syncs the synced telemetry spans
take and a CUDA-event stopwatch.

PyTorch returns from a launch before the device has run it, so a host
clock around device work measures the enqueue.  :func:`device_sync`
waits for the work queued on the devices a tensor (or a list of them, a
pager's pages) lives on; :func:`event_ms` times a call between two CUDA
events on the current stream.
"""

from __future__ import annotations

from typing import Callable

import torch


def device_sync(tensors) -> None:
    """``torch.cuda.synchronize`` on each CUDA device that `tensors` (a
    tensor or a sequence of tensors) live on; nothing for CPU tensors,
    whose work is done when the call that made them returns."""
    if isinstance(tensors, torch.Tensor):
        tensors = (tensors,)
    seen = set()
    for t in tensors:
        dev = t.device
        if dev.type == "cuda" and dev not in seen:
            seen.add(dev)
            torch.cuda.synchronize(dev)


def event_ms(fn: Callable[[], object], device=None) -> float:
    """Milliseconds of fn() between two CUDA events on the current stream
    of `device` (default the current one), after a synchronise; fn ends
    with its work queued on that stream.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("event_ms times on a CUDA device, and there is "
                           "none")
    with torch.cuda.device(device):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)
