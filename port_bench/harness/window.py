"""The measured window: a closed loop over the entry's calls for a fixed
time, a CUDA event recorded on the stream at each call boundary.

The events are read after the window, so timing adds no synchronisation.
Under data parallelism every rank must make the same number of calls
(the step holds collectives): ``agree(stop)`` makes rank 0's decision to
stop everyone's, through a one-element all-reduce on the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch


@dataclasses.dataclass
class Window:
    calls: int
    seconds: float
    call_ms: List[float]


def measure(call: Callable[[int], None], seconds: float, first: int = 0,
            agree: Optional[Callable[[bool], bool]] = None) -> Window:
    """Call ``call(first + i)`` until ``seconds`` have passed on the host
    clock, then wait for the device: the window is all the work and all
    the time up to its end."""
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)]
    t0 = time.perf_counter()
    marks[0].record()
    i = 0
    while True:
        call(first + i)
        i += 1
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        stop = time.perf_counter() - t0 >= seconds
        if agree is not None:
            stop = agree(stop)
        if stop:
            break
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    return Window(i, t1 - t0, [marks[k].elapsed_time(marks[k + 1])
                               for k in range(i)])
