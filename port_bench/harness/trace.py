"""The traced window and what the benchmark reads from it.

``traced(call, calls, first, device_index, before)`` runs ``warmup`` calls
under ``torch.profiler``'s warm-up (its start-up, buffer requests
included, falls there and is not read), then ``calls`` traced calls, each
inside the benchmark's own span ``bench.call``; the device is drained
before the first traced call and after the last, so the traced calls
hold all of their own device work and nothing else. ``before``, when
given, runs before each call outside its span (on several cards: drain
the card and meet the other ranks, so that no rank's NCCL kernel waits
for a peer that started late). The trace of this process's device
reduces to a ``Trace``: the traced window (each call from its span's
start to the later of the span's end and the end of the last device
activity that began before the next span; the union of these), the
device's busy time in it (kernels, copies and sets, unioned), the host's
kernel-launch calls inside the spans, the device time of each kernel
name, the NCCL all-reduce time in the window that no other kernel covers,
and the breakdown (top device operations, longest idle gaps by the host
operation running when each began). A trace with no device time raises:
every number read from it would be missing.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

SPAN = "bench.call"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals: List[List[float]], lo: float, hi: float) -> float:
    """Length of [lo, hi] that the sorted disjoint ``intervals`` cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in intervals)


@dataclasses.dataclass
class Trace:
    calls: int
    window_s: float
    busy_s: float
    launches: int
    kernel_s: Dict[str, float]
    allreduce_exposed_s: float
    device_ops: List[List]
    idle_gaps: List[List]

    def seconds_of(self, names: Sequence[str]) -> float:
        """Device seconds of the kernels whose names contain any of
        ``names`` (and not ``_grad``)."""
        return sum(v for k, v in self.kernel_s.items()
                   if "_grad" not in k and any(n in k for n in names))


def reduce_events(events, calls: int, device_index: int) -> Trace:
    """``events``: the profiler's FunctionEvents."""
    dev, host, spans, launch_at = [], [], [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith("Optimizer.") or e.name == SPAN:
                continue
            if getattr(e, "device_index", device_index) != device_index:
                continue
            dev.append(e)
        elif e.name == SPAN:
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name in LAUNCHES:
            launch_at.append(e.time_range.start)
        else:
            host.append(e)
    if not dev or not spans:
        raise RuntimeError("the profiler recorded no device activity in "
                           "the traced window")
    spans.sort()
    window = union(_call_intervals(spans, [
        (e.time_range.start, e.time_range.end) for e in dev]))
    busy = union([(e.time_range.start, e.time_range.end) for e in dev])
    kernel_s: Dict[str, float] = defaultdict(float)
    for e in dev:
        kernel_s[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    compute = union([(e.time_range.start, e.time_range.end) for e in dev
                     if "nccl" not in e.name.lower()])
    exposed = 0.0
    for e in dev:
        if "nccl" in e.name.lower() and "allreduce" in e.name.lower():
            for lo, hi in window:
                s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
                if t > s:
                    exposed += (t - s) - covered(compute, s, t)
    return Trace(
        calls=calls, window_s=sum(hi - lo for lo, hi in window) / 1e6,
        busy_s=sum(covered(busy, lo, hi) for lo, hi in window) / 1e6,
        launches=_inside(launch_at, spans),
        kernel_s=dict(kernel_s), allreduce_exposed_s=exposed / 1e6,
        device_ops=[[k[:120], v] for k, v in sorted(
            kernel_s.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=_idle_gaps(busy, window, host))


def _inside(times, spans) -> int:
    """How many of ``times`` fall inside the sorted disjoint ``spans``."""
    starts = [s for s, _ in spans]
    n = 0
    for t in times:
        k = bisect.bisect_right(starts, t) - 1
        n += k >= 0 and t <= spans[k][1]
    return n


def _call_intervals(spans, dev) -> List[Tuple[float, float]]:
    """Each traced call from its span's start to the later of the span's
    end and the end of the last device activity that began before the
    next span (the device work a closed loop queued runs on into the next
    call's span; a drained device ends with the call's own)."""
    dev = sorted(dev)
    starts = [s for s, _ in dev]
    ends, m = [], float("-inf")
    for _, e in dev:
        m = max(m, e)
        ends.append(m)
    out = []
    for i, (s, e) in enumerate(spans):
        nxt = spans[i + 1][0] if i + 1 < len(spans) else float("inf")
        k = bisect.bisect_left(starts, nxt)
        out.append((s, max(e, ends[k - 1]) if k else e))
    return out


def _idle_gaps(busy, window, host) -> List[List]:
    """Idle device time in the window by the innermost host operation
    that was running when each gap began ("host: none" when no operation
    was)."""
    gaps = []
    for lo, hi in window:
        prev = lo
        for s, e in busy:
            if e <= lo or s >= hi:
                continue
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in host)
    starts = [o[0] for o in ops]
    by_name: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        name = "host: none"
        for k in range(bisect.bisect_right(starts, g0) - 1, -1, -1):
            s, e, n = ops[k]
            if e >= g0:
                name = n
                break
            if g0 - s > 5e6:          # no op spans more than 5 s here
                break
        by_name[name[:120]] += (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:10]]


def traced(call: Callable[[int], None], calls: int, first: int,
           device_index: int, before: Optional[Callable[[], None]] = None,
           warmup: int = 2) -> Trace:
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=calls,
                                   repeat=1)) as prof:
        for i in range(warmup + calls):
            if before is not None:
                before()
            with record_function(SPAN):
                call(first + i)
            if i in (warmup - 1, warmup + calls - 1):
                torch.cuda.synchronize()
            prof.step()
    return reduce_events(prof.events(), calls, device_index)
